// 3×3 depthwise convolution, stride 1, dilation 1, "same" zero padding,
// NHWC — the forward (#1), and with the taps reversed the input gradient
// (#1b).
//
// Replaces: seghiero_tpu/ops/pallas/depthwise.py, `_dw_raw` (the
// pl.pallas_call at :221, kernel body `_fwd_kernel` :145-154), reached
// through `depthwise3x3` :265-286 from the head's separable bottlenecks
// (models/heads.py:101-104), and the same call with `k9[::-1]` in the
// backward `_dw_bwd` (:292).
//
// What bounds it on an H100: memory bandwidth first. Each output element
// costs 9 multiply-adds on 9 input elements that neighbouring outputs
// share, so the least traffic is one read of x and one write of the
// output: at the train and serve shapes [8,128,128,560] + [8,128,128,512]
// bf16, 562 MB, 0.168 ms at 3.35 TB/s. Instruction issue comes close
// behind: the 18 f32 operations per element are kept as separate
// multiplies and adds (below), with a conversion per x element and tap
// use, ~25 instructions an output, ~0.1 ms of issue at that size. The
// kernel overlaps the two; it cannot drop either.
//
// Design: a block owns a tile of th output rows × tw columns × one channel
// chunk (128 bytes of each pixel: 64 bf16 or 32 f32 channels; fewer where
// C is smaller or the last chunk is ragged). It walks down its band one
// input row at a time: the (tw + 2)-column row with its halo is copied
// into a ring of kStages shared-memory slots with cp.async (16-byte
// copies on the main path), kStages − 1 rows ahead of the row being
// computed, so device memory sees each x element about once (the halo
// rows and columns mostly hit L2) and every thread has rows of loads in
// flight. Halo pixels outside the image are zero-filled by the copy itself
// (src-size 0). Each thread owns one column and one channel vector (16
// bytes on the main path): it keeps the 9 taps in registers, loaded once,
// and three rolling accumulators, because input row i feeds dy = 0 of
// output row i + 1, dy = 1 of row i and dy = 2 of row i − 1; the third is
// then complete and is stored. Threads are numbered channel fastest, so
// shared-memory reads are contiguous 128-byte runs (no bank conflicts) and
// the global stores are coalesced. Blocks of 128 threads (16 columns)
// with 127 registers keep 4 blocks, 16 warps, on an SM; one barrier per
// row then stalls 4 warps, not 8.
//
// Numerics: every output receives its 9 terms in (dy, dx) row-major order,
// summed in f32 from +0 with __fmul_rn / __fadd_rn so nvcc cannot contract
// them into FMAs, and is rounded once to the input dtype. Zero-filled halo
// terms are added as the plain version adds its zero padding (+0 plus ±0
// is +0, and an f32 sum started at +0 never becomes −0, so they change no
// bits). That is the arithmetic of the TPU kernel and of the plain PyTorch
// version in seghiero_torch/ops/depthwise.py: the kernel equals the plain
// version bit for bit, for #1 and for #1b.
//
// The tile sizes below are the fastest of the variants timed against each
// other at the head's shapes on an H100 (PERF.md, PR 5).

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kThreads = 128;     // threads per block, at most
constexpr int kMinBlocks = 4;     // resident blocks per SM asked of ptxas
constexpr int kChunkBytes = 128;  // bytes of each pixel per channel chunk
constexpr int kRows = 32;         // output rows per band (balanced over the image)
constexpr int kStages = 4;        // ring slots: input rows in flight + 1
static_assert(kStages >= 2, "the ring needs a slot to compute from and one to fill");

// launch geometry: channel chunks of cvb vectors, column tiles of tw,
// row bands of th (each balanced so the last is not a sliver)
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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dw3x3_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ k9, T* __restrict__ out, int H, int W,
    int C, Tile tl) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);

  // grid: x walks (chunk, column tile) chunk fastest, y the bands, z the images
  const int CV = C / V;
  const int cv0 = (blockIdx.x % tl.nchunks) * tl.cvb;
  const int w0 = (blockIdx.x / tl.nchunks) * tl.tw;
  const int h0 = blockIdx.y * tl.th;
  const int rows = min(tl.th, H - h0);  // output rows of this band
  const int n_in = rows + 2;            // input rows h0 − 1 … h0 + rows
  const int row_vecs = (tl.tw + 2) * tl.cvb;
  const long long img = static_cast<long long>(blockIdx.z) * H * W * C;

  const int tid = threadIdx.x;
  const int my_cv = tid % tl.cvb, my_col = tid / tl.cvb;
  const int cv = cv0 + my_cv, w = w0 + my_col;
  const bool active = cv < CV && w < W;

  // input row i (image row h0 − 1 + i) into slot i % kStages, zeros outside
  // the image and past the last channel vector; one commit group per call.
  // The block has tw · cvb threads, so a thread copies its own channel
  // vector of slot column my_col, and the first two columns' threads also
  // that of column tw + my_col (the right halo).
  auto stage = [&](int i) {
    if (i < n_in) {
      const int hh = h0 - 1 + i;
      const bool row_ok = hh >= 0 && hh < H && cv < CV;
      P* dst = ring + (i % kStages) * row_vecs + my_cv;
      for (int j = my_col; j < tl.tw + 2; j += tl.tw) {
        const int ww = w0 - 1 + j;
        const bool ok = row_ok && ww >= 0 && ww < W;
        const T* src = ok ? x + img + (static_cast<long long>(hh) * W + ww) * C + cv * V : x;
        copy_async_or_zero<sizeof(P)>(dst + j * tl.cvb, src, ok);
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

  // input row i: `fresh` starts output row h0 + i (dy = 0), `mid` is row
  // h0 + i − 1 (dy = 1), `done` row h0 + i − 2 (dy = 2, then stored)
  auto step = [&](int i, float (&fresh)[V], float (&mid)[V], float (&done)[V]) {
    cp_async_wait<kStages - 2>();  // this thread's copies of row i landed
    __syncthreads();               // everyone's did, and row i − 1's slot is free
    stage(i + kStages - 1);
    const P* row = ring + (i % kStages) * row_vecs + my_col * tl.cvb + my_cv;
    const bool f = i < rows, m = i >= 1 && i <= rows, d = i >= 2;
    if (f) {
#pragma unroll
      for (int v = 0; v < V; ++v) fresh[v] = 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const P xv = row[dx * tl.cvb];
      float xf[V];
#pragma unroll
      for (int v = 0; v < V; ++v) xf[v] = to_f32(xv.v[v]);
      if (f) {
#pragma unroll
        for (int v = 0; v < V; ++v) fresh[v] = __fadd_rn(fresh[v], __fmul_rn(xf[v], k[dx][v]));
      }
      if (m) {
#pragma unroll
        for (int v = 0; v < V; ++v) mid[v] = __fadd_rn(mid[v], __fmul_rn(xf[v], k[3 + dx][v]));
      }
      if (d) {
#pragma unroll
        for (int v = 0; v < V; ++v) done[v] = __fadd_rn(done[v], __fmul_rn(xf[v], k[6 + dx][v]));
      }
    }
    if (d && active) {
      P o;
#pragma unroll
      for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(done[v]);
      *reinterpret_cast<P*>(out + img + (static_cast<long long>(h0 + i - 2) * W + w) * C +
                            cv * V) = o;
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
                   cudaStream_t stream) {
  const Tile tl = make_tile(H, W, C / V, V * static_cast<int>(sizeof(T)));
  if (tl.nbands > 65535) return cudaErrorInvalidValue;  // grid y limit
  const dim3 grid(tl.nchunks * tl.ntw, tl.nbands, B);
  const size_t smem = static_cast<size_t>(kStages) * (tl.tw + 2) * tl.cvb * V * sizeof(T);
  dw3x3_fwd_kernel<T, V><<<grid, tl.tw * tl.cvb, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k9), static_cast<T*>(out), H, W, C,
      tl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(int vec, const void* x, const void* k9, void* out, int B, int H,
                         int W, int C, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(x, k9, out, B, H, W, C, s);
    case 2: return launch<T, 2>(x, k9, out, B, H, W, C, s);
    case 4: return launch<T, 4>(x, k9, out, B, H, W, C, s);
    case 8:
      if constexpr (sizeof(T) * 8 <= 16) return launch<T, 8>(x, k9, out, B, H, W, C, s);
      return cudaErrorInvalidValue;  // 16-byte vectors at most
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace seghiero

// x, out: [B, H, W, C] contiguous; k9: [9, C] contiguous, taps in (dy, dx)
// row-major order; all three of `dtype`. `vec` channels per thread must
// divide C and the wrapper guarantees the vec·itemsize alignment of every
// pointer. Returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported dtype or vec, or a shape past the grid's limits).
extern "C" int seghiero_dw3x3_fwd(const void* x, const void* k9, void* out, int B, int H,
                                  int W, int C, int dtype, int vec, int device,
                                  void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0 || W == 0 || C == 0) return cudaSuccess;
  if (B > 65535 || vec <= 0 || C % vec) return cudaErrorInvalidValue;  // grid z limit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_vec<float>(vec, x, k9, out, B, H, W, C, s);
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(vec, x, k9, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
