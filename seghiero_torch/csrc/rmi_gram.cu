// The three Gram kernels of the RMI loss (radius 3), on maps la (one-hot)
// and pr (probabilities), both [BC, H, W] f32 contiguous. View
// k = (dy, dx) ∈ {0,1,2}², k = 3·dy + dx, reads map[r+dy, c+dx] for output
// pixels r < nh = H − 2, c < nw = W − 2 (not centred); z is the 18 views
// [9 of la | 9 of pr]. All sums are raw (unnormalized) f32 FMA sums:
//
//  * seghiero_rmi_gram18    (#6) G18[bc] = Σ_px z·zᵀ                 [BC, 18, 18]
//  * seghiero_rmi_residual  (#7) A[bc]   = Σ_px y·yᵀ, y = z_la − Wᵀ·z_pr  [BC, 9, 9]
//  * seghiero_rmi_grad_maps (#8) dpr[bc, r', c'] = Σ_k u_k(r'−dy, c'−dx) over
//                                the k whose output pixel is valid, u = P·z
//                                (P [BC, 9, 18])                  [BC, H, W]
//
// Each entry takes `bf16`: 0 runs the f32 kernels (#6, #7, #8,
// `rmi_precision: parity`), 1 their bf16-view variants (#6f, #7f, #8f,
// `rmi_precision: fast`), which round to bf16 (nearest even) exactly where
// the TPU kernel stores or casts to bf16 and keep every product and sum in
// f32: each loaded map value (the bf16 z scratch), W once when it is
// staged, the residual y per pixel before its 45 products, and P when it
// is staged in shared memory. A product of two bf16 values is exact in
// f32, so these are the TPU kernel's single-pass bf16 dots with f32
// accumulation. The maps stay f32 in memory, as the TPU kernel reads f32
// maps and rounds only in VMEM.
//
// Replaces: seghiero_tpu/ops/pallas/rmi_gram.py, `_gram18` (the
// pl.pallas_call at :257, body `_gram18_kernel` :153-170), `_residual_gram`
// (:274, `_residual_kernel` :173-195) and `_grad_maps` (:297,
// `_grad_kernel` :198-227), reached from `_half_logdet` (:355-394) — the
// RMI term of the 3-level loss, forward (#6, #7) and backward (#8); the
// bf16 variants are the same pallas_calls with `zdt = bfloat16`
// (`rmi_logdet_pallas_cmajor(precision="fast")`, :416-443).
//
// What bounds them on an H100, at config 3 (BC = 60 maps of 512²,
// 62.9 MB each in f32). The 18 views are shifts of two maps, so the least
// work is smaller than what these kernels do:
//  * #6 reads both maps once (125.9 MB, 0.038 ms at 3.35 TB/s). Each G18
//    entry is a correlation of two maps at one offset in {−2..2}² (13 la·la,
//    13 pr·pr, 25 la·pr, up to the 2-pixel frame): 51 FMAs per output pixel
//    (0.024 ms at 67 TFLOP/s f32). Bound by bytes; it does 171 FMAs.
//  * #7 reads the same bytes and needs the residual y per pixel: 81 + 45
//    FMAs (0.061 ms). Bound by operations.
//  * #8 reads both maps and writes dpr (188.8 MB, 0.056 ms). Inside the
//    frame dpr is a 5×5 correlation of each map with taps folded from P:
//    50 FMAs per pixel (0.023 ms). Bound by bytes; it does 162 FMAs.
// The bf16 variants at config 4 (BC = 30 maps of 769², 71.0 MB each) read
// and write the same f32 bytes (141.9, 141.9, 212.9 MB: 0.042, 0.042,
// 0.064 ms); their products, on bf16 operands, count at the tensor cores'
// bf16 rate, so all three are bound by bytes. These variants still run
// them as f32 FMAs on rounded values: one rounding per loaded value (two
// instructions) is all they add to the f32 kernels.
//
// Design. No tensor cores, no TF32: the logdet downstream needs f32 Grams
// (the TPU kernels pin precision=HIGHEST), so every product is an f32 FMA.
// A thread owns one column of a band of kRows rows and walks down it,
// keeping the 3×3 (for #8: 5×5) windows of both maps in registers: per row
// it loads one new window row, coalesced across the warp (neighbouring
// threads own neighbouring columns), one row ahead of its use.
//  * #6 keeps all 171 unique entries of the 18×18 Gram as register sums
//    (171 FMAs per 18 values loaded); #7 keeps W (81 values) and the 45
//    entries of the 9×9 Gram. A block then adds its threads' sums in a
//    fixed order (a warp shuffle tree, then the warps in order) and writes
//    one partial row; a second kernel adds a map's partials in order and
//    writes both triangles. No float atomics: two runs give the same bits.
//  * #8 is a gather: each input pixel recomputes the u_k of the up to 9
//    output pixels that read it (9 × 18 FMAs, the count of forming u once)
//    with P in shared memory, and writes its dpr value once.
// The TPU kernels' 128-lane padding, 8-row halo blocks, lane rolls and
// tile-row picker are Mosaic's; here each thread masks the ragged edge.
//
// Numerics: f32 sums in an order set by the launch geometry, not the plain
// versions' (seghiero_torch/ops/rmi_gram.py), so they are compared within
// 1e-5 · Σ|z_i·z_j| per Gram entry and 1e-5 · Σ|P|·|z| per dpr pixel; the
// bf16 variant of #7 also rounds y from its own f32 sum, which can land on
// the other side of a bf16 rounding boundary than the plain version's.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kCols = 128;  // columns per block (blockDim.x)
constexpr int kRows = 32;   // rows per block
constexpr int kWarps = kCols / 32;
constexpr int kG18 = 18 * 19 / 2;  // unique entries of the 18×18 Gram
constexpr int kRes = 9 * 10 / 2;   // unique entries of the 9×9 Gram

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // j <= i

// A map, W or P value as the kernel multiplies it: itself, or (kBf16)
// rounded to the nearest bf16, as the TPU kernel's bf16 z scratch holds it.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return to_f32(from_f32<__nv_bfloat16>(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's per-thread sums acc[E], added in a fixed order (a shuffle tree
// within each warp, then the warps in order), stored to out[E].
template <int E>
__device__ __forceinline__ void block_sum_store(const float (&acc)[E], float* __restrict__ out) {
  __shared__ float red[kWarps][E];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float s = warp_sum(acc[e]);
    if (lane == 0) red[warp][e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kCols) {
    float s = red[0][e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][e];
    out[e] = s;
  }
}

// Loads row `row` of the 3 views dx = 0..2 at column c of both maps.
template <bool kBf16>
__device__ __forceinline__ void load_row3(const float* __restrict__ a, const float* __restrict__ p,
                                          int row, int c, int W, float (&na)[3], float (&np)[3]) {
  const long long o = static_cast<long long>(row) * W + c;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    na[dx] = operand<kBf16>(a[o + dx]);
    np[dx] = operand<kBf16>(p[o + dx]);
  }
}

// The walk shared by #6 and #7: for each output row r of the block's band
// at column c (< nw), z holds the 18 views there; `body(z)` accumulates.
template <bool kBf16, typename Body>
__device__ __forceinline__ void walk_band(const float* __restrict__ a, const float* __restrict__ p,
                                          int r0, int r1, int c, int W, Body body) {
  float z[18];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    float na[3], np[3];
    load_row3<kBf16>(a, p, r0 + dy, c, W, na, np);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      z[dy * 3 + dx] = na[dx];
      z[9 + dy * 3 + dx] = np[dx];
    }
  }
  float na[3], np[3];
  load_row3<kBf16>(a, p, r0 + 2, c, W, na, np);
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      z[6 + dx] = na[dx];
      z[15 + dx] = np[dx];
    }
    if (r + 1 < r1) load_row3<kBf16>(a, p, r + 3, c, W, na, np);  // one row ahead
    body(z);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      z[k] = z[k + 3];
      z[9 + k] = z[12 + k];
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kCols) gram18_partial_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, float* __restrict__ partial,
    int H, int W, int nh, int nw) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, nh);
  const long long map = static_cast<long long>(blockIdx.z) * H * W;
  float acc[kG18];
#pragma unroll
  for (int e = 0; e < kG18; ++e) acc[e] = 0.f;
  if (c < nw) {
    walk_band<kBf16>(la + map, pr + map, r0, r1, c, W, [&](const float (&z)[18]) {
#pragma unroll
      for (int i = 0; i < 18; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[tri(i, j)] = fmaf(z[i], z[j], acc[tri(i, j)]);
    });
  }
  const long long blk =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  block_sum_store<kG18>(acc, partial + blk * kG18);
}

template <bool kBf16>
__global__ void __launch_bounds__(kCols) residual_partial_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, const float* __restrict__ w,
    float* __restrict__ partial, int H, int W, int nh, int nw) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, nh);
  const long long map = static_cast<long long>(blockIdx.z) * H * W;
  float acc[kRes];
#pragma unroll
  for (int e = 0; e < kRes; ++e) acc[e] = 0.f;
  if (c < nw) {
    float wt[81];  // W[j][i], row-major
    const float* wb = w + static_cast<long long>(blockIdx.z) * 81;
#pragma unroll
    for (int q = 0; q < 81; ++q) wt[q] = operand<kBf16>(wb[q]);
    walk_band<kBf16>(la + map, pr + map, r0, r1, c, W, [&](const float (&z)[18]) {
      float y[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {  // y_i = z_la,i − Σ_j W[j][i]·z_pr,j
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 9; ++j) s = fmaf(wt[j * 9 + i], z[9 + j], s);
        y[i] = operand<kBf16>(z[i] - s);  // the TPU kernel's bf16 y
      }
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[tri(i, j)] = fmaf(y[i], y[j], acc[tri(i, j)]);
    });
  }
  const long long blk =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  block_sum_store<kRes>(acc, partial + blk * kRes);
}

// out[bc][i][j] for both triangles of a D×D Gram: map bc's nblk partial
// rows of E = D(D+1)/2 entries, added in block order.
template <int D>
__global__ void __launch_bounds__(256) gram_finish_kernel(const float* __restrict__ partial,
                                                          float* __restrict__ out, int BC,
                                                          int nblk) {
  constexpr int E = D * (D + 1) / 2;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(BC) * D * D) return;
  const int bc = static_cast<int>(t / (D * D));
  const int ij = static_cast<int>(t % (D * D));
  const int i = ij / D, j = ij % D;
  const int e = i >= j ? tri(i, j) : tri(j, i);
  const float* src = partial + static_cast<long long>(bc) * nblk * E + e;
  float s = src[0];
  for (int b = 1; b < nblk; ++b) s += src[static_cast<long long>(b) * E];
  out[t] = s;
}

template <bool kBf16>
__device__ __forceinline__ float load_or_zero(const float* __restrict__ m, int r, int c, int H,
                                              int W) {
  return (r >= 0 && r < H && c >= 0 && c < W)
             ? operand<kBf16>(m[static_cast<long long>(r) * W + c])
             : 0.f;
}

template <bool kBf16>
__global__ void __launch_bounds__(kCols) grad_maps_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, const float* __restrict__ P,
    float* __restrict__ dpr, int H, int W, int nh, int nw) {
  __shared__ float ps[9 * 18];
  const float* pb = P + static_cast<long long>(blockIdx.z) * (9 * 18);
  for (int q = threadIdx.x; q < 9 * 18; q += kCols) ps[q] = operand<kBf16>(pb[q]);
  __syncthreads();
  const int c = blockIdx.x * kCols + threadIdx.x;  // input column
  if (c >= W) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, H);
  const long long map = static_cast<long long>(blockIdx.z) * H * W;
  const float* a = la + map;
  const float* p = pr + map;
  float* out = dpr + map;
  // wa[i][j] = la[r − 2 + i][c − 2 + j] for the current input row r (zero
  // outside the map; such entries are only read for output pixels that
  // are not valid)
  float wa[5][5], wp[5][5];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      wa[i][j] = load_or_zero<kBf16>(a, r0 - 2 + i, c - 2 + j, H, W);
      wp[i][j] = load_or_zero<kBf16>(p, r0 - 2 + i, c - 2 + j, H, W);
    }
  float na[5], np[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    na[j] = load_or_zero<kBf16>(a, r0 + 2, c - 2 + j, H, W);
    np[j] = load_or_zero<kBf16>(p, r0 + 2, c - 2 + j, H, W);
  }
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      wa[4][j] = na[j];
      wp[4][j] = np[j];
    }
    if (r + 1 < r1) {  // one row ahead
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        na[j] = load_or_zero<kBf16>(a, r + 3, c - 2 + j, H, W);
        np[j] = load_or_zero<kBf16>(p, r + 3, c - 2 + j, H, W);
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const bool row_ok = r - dy >= 0 && r - dy < nh;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // u_k at output pixel (r − dy, c − dx): its view m = (ey, ex)
        // reads window entry (2 − dy + ey, 2 − dx + ex)
        const int k = dy * 3 + dx;
        float u = 0.f;
#pragma unroll
        for (int ey = 0; ey < 3; ++ey)
#pragma unroll
          for (int ex = 0; ex < 3; ++ex)
            u = fmaf(ps[k * 18 + ey * 3 + ex], wa[2 - dy + ey][2 - dx + ex], u);
#pragma unroll
        for (int ey = 0; ey < 3; ++ey)
#pragma unroll
          for (int ex = 0; ex < 3; ++ex)
            u = fmaf(ps[k * 18 + 9 + ey * 3 + ex], wp[2 - dy + ey][2 - dx + ex], u);
        if (row_ok && c - dx >= 0 && c - dx < nw) acc += u;
      }
    }
    out[static_cast<long long>(r) * W + c] = acc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        wa[i][j] = wa[i + 1][j];
        wp[i][j] = wp[i + 1][j];
      }
  }
}

// Blocks of the partial kernels per map (must equal the wrapper's count).
inline int partial_blocks(int H, int W) {
  return ((W - 2 + kCols - 1) / kCols) * ((H - 2 + kRows - 1) / kRows);
}

inline bool shape_ok(int BC, int H, int W) {
  return BC >= 0 && BC <= 65535 && H >= 3 && W >= 3 && (H + kRows - 1) / kRows <= 65535;
}

template <int D, typename Launch>
cudaError_t two_pass(int BC, int H, int W, int nblk, void* partial, void* out, cudaStream_t s,
                     Launch launch_partial) {
  if (!shape_ok(BC, H, W) || nblk != partial_blocks(H, W)) return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  const dim3 grid((W - 2 + kCols - 1) / kCols, (H - 2 + kRows - 1) / kRows, BC);
  launch_partial(grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(BC) * D * D;
  gram_finish_kernel<D><<<blocks_for(n, 256), 256, 0, s>>>(static_cast<const float*>(partial),
                                                          static_cast<float*>(out), BC, nblk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace seghiero

// la, pr: [BC, H, W] f32 contiguous; partial: [BC, nblk, 171] f32 scratch
// with nblk = ceil((W−2)/128)·ceil((H−2)/32) (the wrapper allocates it);
// g18: [BC, 18, 18] f32; bf16: 0 for #6, 1 for #6f (bf16 views). Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the kernels do not
// take, an nblk that does not match or a bf16 flag other than 0 or 1).
extern "C" int seghiero_rmi_gram18(const void* la, const void* pr, void* partial, void* g18,
                                   int BC, int H, int W, int nblk, int bf16, int device,
                                   void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return two_pass<18>(BC, H, W, nblk, partial, g18, s, [&](dim3 grid, cudaStream_t st) {
    auto* kernel = bf16 ? gram18_partial_kernel<true> : gram18_partial_kernel<false>;
    kernel<<<grid, kCols, 0, st>>>(static_cast<const float*>(la), static_cast<const float*>(pr),
                                   static_cast<float*>(partial), H, W, H - 2, W - 2);
  });
}

// As seghiero_rmi_gram18, with w: [BC, 9, 9] f32 (the regression W, so
// y = z_la − Wᵀ·z_pr), partial: [BC, nblk, 45] and a: [BC, 9, 9]; bf16: 0
// for #7, 1 for #7f.
extern "C" int seghiero_rmi_residual(const void* la, const void* pr, const void* w,
                                     void* partial, void* a, int BC, int H, int W, int nblk,
                                     int bf16, int device, void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return two_pass<9>(BC, H, W, nblk, partial, a, s, [&](dim3 grid, cudaStream_t st) {
    auto* kernel = bf16 ? residual_partial_kernel<true> : residual_partial_kernel<false>;
    kernel<<<grid, kCols, 0, st>>>(static_cast<const float*>(la), static_cast<const float*>(pr),
                                   static_cast<const float*>(w), static_cast<float*>(partial),
                                   H, W, H - 2, W - 2);
  });
}

// la, pr: [BC, H, W] f32 contiguous; p: [BC, 9, 18] f32; dpr: [BC, H, W]
// f32, every pixel written once; bf16: 0 for #8, 1 for #8f.
extern "C" int seghiero_rmi_grad_maps(const void* la, const void* pr, const void* p, void* dpr,
                                      int BC, int H, int W, int bf16, int device, void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(BC, H, W)) return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, BC);
  auto* kernel = bf16 ? grad_maps_kernel<true> : grad_maps_kernel<false>;
  kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(pr),
      static_cast<const float*>(p), static_cast<float*>(dpr), H, W, H - 2, W - 2);
  return cudaGetLastError();
}
