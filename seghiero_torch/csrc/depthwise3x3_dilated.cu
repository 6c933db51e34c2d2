// Dilated 3×3 depthwise convolution, stride 1, dilation d, "same" zero
// padding d, NHWC — the forward alone (#9), for the ASPP's separable
// branches at dilations 12 / 24 / 36 where no gradient is asked of it.
//
// Replaces no pallas_call: the JAX package sends every dilated depthwise
// convolution to XLA's grouped convolution
// (seghiero_tpu/models/heads.py:101-111), and the port sent it to cuDNN's
// `conv2d_grouped_direct_kernel`, the largest device op of batched
// inference (PERF.md §5).
//
// What bounds it on an H100: memory bandwidth. The centre tap reads every
// input element, so the least traffic is one read of x and one write of
// the output: at the ASPP input of 1024² inference, [4,128,128,2048]
// bf16, 537 MB, 0.160 ms at 3.35 TB/s, against 2.4 G f32 operations
// (0.036 ms at 67 TFLOP/s). Instruction throughput comes next, as for
// #1: 18 separate f32 multiplies and adds an output and a conversion per
// x element and row.
//
// Design: a dilation-d correlation is a dilation-1 correlation on each of
// the d × d polyphase subgrids (h ≡ a, w ≡ b mod d), with padding 1 in the
// subgrid. Rows and columns are renumbered phase-major: compact index
// i ↔ image coordinate p + q·d, phase p ascending, q ascending within it
// (phases p < n mod d hold ⌈n/d⌉ entries, the rest ⌊n/d⌋), so the
// renumbering is a permutation and compact neighbours within a phase are
// image neighbours at distance d. On the compact grid the kernel is #1
// (csrc/depthwise3x3.cu): a block owns a tile of th compact rows × tw
// compact columns × one 128-byte channel chunk, walks down its band one
// input row at a time through a cp.async ring of kStages shared-memory
// rows (16-byte copies, channel fastest), keeps the 9 taps in registers and
// three rolling accumulators (input row i feeds dy = 0 of output row
// i + 1, dy = 1 of row i, dy = 2 of row i − 1). Device memory sees x about
// once: a band's halo row and a tile's halo columns are the compact
// neighbours, read again from L2 only where they lie in the same phase.
// Where a neighbour lies in another phase the tap row or column is in the
// padding: it is neither copied nor multiplied, but skipped — per row for
// the whole block (from a table of the band's rows built at its start),
// per thread for the columns. At d = 36 on a 128-row map, 72 of 128 output
// rows lose a whole tap row.
//
// Numerics: every output receives its terms in (dy, dx) row-major order,
// summed in f32 from +0 with __fmul_rn / __fadd_rn (no FMA contraction),
// rounded once to the input dtype: #1's arithmetic. A skipped padding term
// is a ±0 product, which changes no bits of an f32 sum started at +0, so
// the kernel equals the plain version in seghiero_torch/ops/depthwise.py
// (which multiplies the zero padding) bit for bit for finite taps.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kThreads = 128;     // threads per block, at most
constexpr int kMinBlocks = 4;     // resident blocks per SM asked of ptxas
constexpr int kChunkBytes = 128;  // bytes of each pixel per channel chunk
constexpr int kRows = 32;         // compact output rows per band
constexpr int kStages = 4;        // ring slots: input rows in flight + 1
static_assert(kStages >= 2, "the ring needs a slot to compute from and one to fill");

// row-table flags: the compact neighbour above / below lies in the same phase
constexpr int kUp = 1, kDown = 2;

struct Tile {
  int cvb, nchunks, tw, ntw, th, nbands;
};

Tile make_tile(int H, int W, int CV, int vec_bytes) {
  Tile t;
  const int cap = kChunkBytes / vec_bytes;
  t.nchunks = (CV + cap - 1) / cap;
  t.cvb = (CV + t.nchunks - 1) / t.nchunks;
  const int tw_cap = kThreads / t.cvb > 0 ? kThreads / t.cvb : 1;
  t.ntw = (W + tw_cap - 1) / tw_cap;
  t.tw = (W + t.ntw - 1) / t.ntw;
  t.nbands = (H + kRows - 1) / kRows;
  t.th = (H + t.nbands - 1) / t.nbands;
  return t;
}

// Compact index i (0 ≤ i < n) of a dimension of size n at dilation d → its
// image coordinate p + q·d, with q and the count of its phase.
__device__ __forceinline__ int to_image(int i, int n, int d, int& q, int& count) {
  const int m = n / d, r = n - m * d;  // phases p < r hold m + 1 entries, the rest m
  const int big = r * (m + 1);
  int p;
  if (i < big) {
    p = i / (m + 1);
    q = i - p * (m + 1);
    count = m + 1;
  } else {  // m ≥ 1 here: with m = 0, big = n > i
    const int t = i - big;
    p = r + t / m;
    q = t - (p - r) * m;
    count = m;
  }
  return p + q * d;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dw3x3_dilated_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ k9, T* __restrict__ out, int H, int W,
    int C, int d, Tile tl) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);
  // input row i of the band: its image row · 4 + kUp / kDown, or −1 where
  // the row is outside the image or a halo row of another phase (not read)
  __shared__ int rows_tab[kRows + 2];

  // grid: x walks (chunk, column tile) chunk fastest, y the bands, z the images
  const int CV = C / V;
  const int cv0 = (blockIdx.x % tl.nchunks) * tl.cvb;
  const int w0 = (blockIdx.x / tl.nchunks) * tl.tw;  // compact column of slot 1
  const int h0 = blockIdx.y * tl.th;                 // compact row of output row 0
  const int rows = min(tl.th, H - h0);
  const int n_in = rows + 2;  // compact input rows h0 − 1 … h0 + rows
  const int row_vecs = (tl.tw + 2) * tl.cvb;
  const long long img = static_cast<long long>(blockIdx.z) * H * W * C;

  const int tid = threadIdx.x;
  const int my_cv = tid % tl.cvb, my_col = tid / tl.cvb;
  const int cv = cv0 + my_cv;

  for (int t = tid; t < n_in; t += blockDim.x) {
    const int v = h0 - 1 + t;
    int e = -1;
    if (v >= 0 && v < H) {
      int q, count;
      const int hh = to_image(v, H, d, q, count);
      const bool up = q > 0, down = q + 1 < count;
      // the halo rows are read only as a neighbour within their phase
      if ((t > 0 || down) && (t < n_in - 1 || up))
        e = hh * 4 + (up ? kUp : 0) + (down ? kDown : 0);
    }
    rows_tab[t] = e;
  }

  // this thread's output column, and the slots it copies: slot j holds
  // compact column w0 − 1 + j; a thread copies slot my_col, and the first
  // two columns' threads also slot tw + my_col (the right halo; tw ≥ 2
  // unless W = 1, which has no halo). A slot is copied where some output
  // of the tile reads it.
  int q = 0, count = 0;
  const int w = w0 + my_col < W ? to_image(w0 + my_col, W, d, q, count) : -1;
  const bool active = cv < CV && w >= 0;
  const bool left = w >= 0 && q > 0, right = w >= 0 && q + 1 < count;
  int src_col[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = my_col + s * tl.tw;
    const int c = w0 - 1 + j;
    src_col[s] = -1;
    if (j < tl.tw + 2 && c >= 0 && c < W) {
      int qc, nc;
      const int ww = to_image(c, W, d, qc, nc);
      const bool inner = j >= 1 && j <= tl.tw;
      // slot 0 is read by slot 1's left tap, slot tw + 1 by slot tw's
      // right tap, each only within its phase
      const bool needed = inner || (j == 0 ? qc + 1 < nc : qc > 0);
      if (needed) src_col[s] = ww;
    }
  }
  __syncthreads();  // the row table

  auto stage = [&](int i) {
    if (i < n_in) {
      const int e = rows_tab[i];
      if (e >= 0 && cv < CV) {
        const long long row = img + static_cast<long long>(e >> 2) * W * C + cv * V;
        P* dst = ring + (i % kStages) * row_vecs + my_cv;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (src_col[s] >= 0)
            copy_async_or_zero<sizeof(P)>(dst + (my_col + s * tl.tw) * tl.cvb,
                                          x + row + static_cast<long long>(src_col[s]) * C,
                                          true);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  float k[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    P kv;
    if (cv < CV) kv = *reinterpret_cast<const P*>(k9 + t * C + cv * V);
#pragma unroll
    for (int v = 0; v < V; ++v) k[t][v] = cv < CV ? to_f32(kv.v[v]) : 0.f;
  }

  // input row i: `fresh` starts output row i (compact h0 + i: dy = 0),
  // `mid` is row i − 1 (dy = 1), `done` row i − 2 (dy = 2, then stored)
  auto step = [&](int i, float (&fresh)[V], float (&mid)[V], float (&done)[V]) {
    cp_async_wait<kStages - 2>();  // this thread's copies of row i landed
    __syncthreads();               // everyone's did, and row i − 1's slot is free
    stage(i + kStages - 1);
    const int e = rows_tab[i];
    const bool f = i < rows, d_out = i >= 2;
    const bool f_add = f && e >= 0 && (e & kDown);
    const bool m_add = i >= 1 && i <= rows;  // an inner row: always in the image
    const bool d_add = d_out && e >= 0 && (e & kUp);
    if (f) {
#pragma unroll
      for (int v = 0; v < V; ++v) fresh[v] = 0.f;
    }
    if (f_add || m_add || d_add) {
      const P* row = ring + (i % kStages) * row_vecs + my_col * tl.cvb + my_cv;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if ((dx == 0 && !left) || (dx == 2 && !right)) continue;  // tap column in the padding
        const P xv = row[dx * tl.cvb];
        float xf[V];
#pragma unroll
        for (int v = 0; v < V; ++v) xf[v] = to_f32(xv.v[v]);
        if (f_add) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            fresh[v] = __fadd_rn(fresh[v], __fmul_rn(xf[v], k[dx][v]));
        }
        if (m_add) {
#pragma unroll
          for (int v = 0; v < V; ++v) mid[v] = __fadd_rn(mid[v], __fmul_rn(xf[v], k[3 + dx][v]));
        }
        if (d_add) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            done[v] = __fadd_rn(done[v], __fmul_rn(xf[v], k[6 + dx][v]));
        }
      }
    }
    if (d_out && active) {
      const int hh = rows_tab[i - 1] >> 2;  // output row i − 2 is input row i − 1
      P o;
#pragma unroll
      for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(done[v]);
      *reinterpret_cast<P*>(out + img + (static_cast<long long>(hh) * W + w) * C + cv * V) = o;
    }
  };

  float a0[V], a1[V], a2[V];
  for (int i = 0; i < n_in; i += 3) {  // unrolled by 3 so the roles rotate without copies
    step(i, a0, a1, a2);
    if (i + 1 < n_in) step(i + 1, a2, a0, a1);
    if (i + 2 < n_in) step(i + 2, a1, a2, a0);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* k9, void* out, int B, int H, int W, int C,
                   int d, cudaStream_t stream) {
  const Tile tl = make_tile(H, W, C / V, V * static_cast<int>(sizeof(T)));
  if (tl.nbands > 65535) return cudaErrorInvalidValue;  // grid y limit
  const dim3 grid(tl.nchunks * tl.ntw, tl.nbands, B);
  const size_t smem = static_cast<size_t>(kStages) * (tl.tw + 2) * tl.cvb * V * sizeof(T);
  dw3x3_dilated_fwd_kernel<T, V><<<grid, tl.tw * tl.cvb, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k9), static_cast<T*>(out), H, W, C, d,
      tl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(int vec, const void* x, const void* k9, void* out, int B, int H,
                         int W, int C, int d, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(x, k9, out, B, H, W, C, d, s);
    case 2: return launch<T, 2>(x, k9, out, B, H, W, C, d, s);
    case 4: return launch<T, 4>(x, k9, out, B, H, W, C, d, s);
    case 8:
      if constexpr (sizeof(T) * 8 <= 16) return launch<T, 8>(x, k9, out, B, H, W, C, d, s);
      return cudaErrorInvalidValue;  // 16-byte vectors at most
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace seghiero

// x, out: [B, H, W, C] contiguous; k9: [9, C] contiguous, taps in (dy, dx)
// row-major order; all three of `dtype`; dilation ≥ 1. `vec` channels per
// thread must divide C and the wrapper guarantees the vec·itemsize
// alignment of every pointer. Returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype, vec or dilation, or a
// shape past the grid's limits).
extern "C" int seghiero_dw3x3_dil_fwd(const void* x, const void* k9, void* out, int B, int H,
                                      int W, int C, int dilation, int dtype, int vec,
                                      int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0 || W == 0 || C == 0) return cudaSuccess;
  if (B > 65535 || vec <= 0 || C % vec || dilation < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_vec<float>(vec, x, k9, out, B, H, W, C, dilation, s);
  if (dtype == kBFloat16)
    return dispatch_vec<__nv_bfloat16>(vec, x, k9, out, B, H, W, C, dilation, s);
  return cudaErrorInvalidValue;
}
