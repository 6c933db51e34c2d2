// Weight gradient of the 3×3 depthwise convolution (stride 1, dilation 1,
// "same" zero padding), NHWC:  dk[dy·3+dx, c] = Σ_{b,h,w} x[b, h+dy−1,
// w+dx−1, c] · g[b, h, w, c]  in f32 (#2).
//
// Replaces: seghiero_tpu/ops/pallas/depthwise.py, `_dw_wgrad` (the
// pl.pallas_call at :245, kernel body `_wgrad_kernel` :157-173), reached
// from `_dw_bwd` :289-302 — the backward of the head's separable
// bottlenecks in training.
//
// What bounds it on an H100: memory bandwidth. The least traffic is one
// read of x and of g and a write of 9·C floats: at the train shapes
// [8,128,128,560] + [8,128,128,512] bf16, 562 MB, 0.168 ms at 3.35 TB/s.
// The 9 multiply-adds per element are 1.3 G FMAs, ~0.04 ms of f32 issue;
// with the conversions and shared-memory reads ~13 instructions an
// element, ~0.06 ms.
//
// Design: a reduction over B·H·W pixels per (tap, channel), in two passes
// and without float atomics, so two runs give the same bits.
//  * Pass 1: a block owns one channel chunk (128 bytes of each pixel: 64
//    bf16 or 32 f32 channels), a band of th rows of one image and a tile
//    of tw ≤ kTileCols columns. It walks down the band one row at a time:
//    x row h0 − 1 + i (tw + 2 columns with the halo) and g row h0 + i − 2
//    are copied into a ring of kStages shared-memory slots with cp.async
//    (16-byte copies where C and the pointers allow), kStages − 1 rows
//    ahead of the row in use; pixels outside the image, x columns past the
//    tile's halo and g outside the block's own tile read zero, so no pixel
//    is counted twice. A lane owns V channels (a bf16 pair or one f32: 4
//    bytes, so a warp's shared-memory reads are contiguous 128-byte runs)
//    and a warp kWarpCols columns; the lane keeps the three x rows that g
//    row h0 + i − 2 needs (rows i − 2 … i) in registers, reading each x
//    row from shared memory once, and adds x · g to its 9·V f32 sums
//    (18 for bf16). The block then adds its warps' sums in order through
//    shared memory and writes one partial [9, chunk] row: partial [P, 9, C]
//    f32 with P = B · bands · column tiles.
//  * Pass 2: a block adds the P partials of 32 consecutive (tap, channel)
//    entries in 8 contiguous segments, then the 8 segment sums in order.
// The TPU kernel's channel-outermost grid and resident [9, CB] output block
// (Pallas accumulates only across consecutive grid steps) have no
// counterpart: blocks run in parallel and meet in the second pass.
//
// Numerics: f32 multiply-adds in an order set by the launch geometry (not
// the plain version's), so the plain version in
// seghiero_torch/ops/depthwise.py is compared within 1e-5 · Σ|x·g| per
// entry, not bit for bit; the order is fixed, so two runs agree bit for bit.
//
// The tile sizes below are the fastest of the variants timed against each
// other at the head's shapes on an H100 that need no opt-in to more than
// 48 KB of shared memory (PERF.md, PR 5). The partition is known only
// here: the wrapper asks seghiero_dw3x3_wgrad_partials for the scratch
// rows it must allocate.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kChunkBytes = 128;  // bytes of each pixel per channel chunk (32 lanes × 4)
constexpr int kRows = 32;      // rows per band (balanced over the image)
constexpr int kWarpCols = 4;   // columns per warp
constexpr int kMaxWarps = 8;
constexpr int kTileCols = kMaxWarps * kWarpCols;
constexpr int kStages = 4;     // ring slots: rows in flight + 1
constexpr int kMinBlocks = 2;  // asked of ptxas (its 79 registers still fit 3)
static_assert(kStages >= 2, "the ring needs a slot to compute from and one to fill");
constexpr int kFinishCols = 32, kFinishSegs = 8;  // pass 2: entries × segments per block

struct Tile {
  int ntw, tw, warps, nbands, th, nchunks;
};

// pass 1's blocks per channel chunk, one per (image, row band, column
// tile): the rows of the partial-sum scratch (H, W > 0)
long long partials(int B, int H, int W) {
  return static_cast<long long>(B) * ((H + kRows - 1) / kRows) *
         ((W + kTileCols - 1) / kTileCols);
}

Tile make_tile(int H, int W, int C, int itemsize) {
  Tile t;
  t.ntw = (W + kTileCols - 1) / kTileCols;
  t.tw = (W + t.ntw - 1) / t.ntw;
  t.warps = (t.tw + kWarpCols - 1) / kWarpCols;
  t.nbands = (H + kRows - 1) / kRows;
  t.th = (H + t.nbands - 1) / t.nbands;
  const int ce = kChunkBytes / itemsize;  // channels per chunk
  t.nchunks = (C + ce - 1) / ce;
  return t;
}

// ring slot bytes: x row (cols + 2 columns) and g row (cols columns), 128 B each
__host__ __device__ constexpr int slot_bytes(int cols) { return (2 * cols + 2) * kChunkBytes; }

// G: bytes per copy (16 where C·itemsize and the pointers allow)
template <typename T, int G>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    dw3x3_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               float* __restrict__ partial, int H, int W, int C, Tile tl) {
  constexpr int V = 4 / sizeof(T);                // channels per lane
  constexpr int kCE = kChunkBytes / sizeof(T);    // channels per chunk
  constexpr int kPieces = kChunkBytes / G;        // copies per pixel chunk
  constexpr int kPieceElems = G / sizeof(T);
  using Lane = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int chunk = blockIdx.x % tl.nchunks, tile = blockIdx.x / tl.nchunks;
  const int c0 = chunk * kCE;
  const int w0 = tile * tl.tw, h0 = blockIdx.y * tl.th;
  const int rows = min(tl.th, H - h0);
  const int n_in = rows + 2;  // steps: x rows h0 − 1 … h0 + rows
  const int cols = tl.warps * kWarpCols;  // staged columns (≥ tw; the rest read zero)
  const int slot = slot_bytes(cols);
  const long long img = static_cast<long long>(blockIdx.z) * H * W * C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // step i's slot: x row h0 − 1 + i in columns w0 − 1 …, then g row h0 + i − 2
  auto stage = [&](int i) {
    if (i < n_in) {
      unsigned char* dst = smem + (i % kStages) * slot;
      const int hx = h0 - 1 + i, hg = h0 + i - 2;
      const bool x_ok = hx >= 0 && hx < H, g_ok = i >= 2 && i - 2 < rows;
      const int n = (2 * cols + 2) * kPieces;
      for (int idx = tid; idx < n; idx += blockDim.x) {
        const int col = idx / kPieces, c = c0 + (idx % kPieces) * kPieceElems;
        const T* src = x;
        bool ok;
        if (col < cols + 2) {
          const int ww = w0 - 1 + col;
          ok = x_ok && ww >= 0 && ww < W && c < C;
          if (ok) src = x + img + (static_cast<long long>(hx) * W + ww) * C + c;
        } else {
          const int j = col - (cols + 2), ww = w0 + j;
          ok = g_ok && j < tl.tw && ww < W && c < C;
          if (ok) src = g + img + (static_cast<long long>(hg) * W + ww) * C + c;
        }
        copy_async_or_zero<G>(dst + idx * G, src, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  // step i: `now` takes x row i of the band's walk; `prev` holds row i − 1
  // and `old` row i − 2, the three rows around g row h0 + i − 2
  auto step = [&](int i, float (&now)[kWarpCols + 2][V], float (&prev)[kWarpCols + 2][V],
                  float (&old)[kWarpCols + 2][V]) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage(i + kStages - 1);
    const unsigned char* s = smem + (i % kStages) * slot;
    const Lane* xs = reinterpret_cast<const Lane*>(s) + warp * kWarpCols * 32 + lane;
#pragma unroll
    for (int j = 0; j < kWarpCols + 2; ++j) {
      const Lane xv = xs[j * 32];
#pragma unroll
      for (int v = 0; v < V; ++v) now[j][v] = to_f32(xv.v[v]);
    }
    if (i < 2) return;
    const Lane* gs = reinterpret_cast<const Lane*>(s) + (cols + 2 + warp * kWarpCols) * 32 + lane;
#pragma unroll
    for (int j = 0; j < kWarpCols; ++j) {
      const Lane gv = gs[j * 32];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gf = to_f32(gv.v[v]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          acc[dx][v] += old[j + dx][v] * gf;
          acc[3 + dx][v] += prev[j + dx][v] * gf;
          acc[6 + dx][v] += now[j + dx][v] * gf;
        }
      }
    }
  };

  float r0[kWarpCols + 2][V], r1[kWarpCols + 2][V], r2[kWarpCols + 2][V];
  for (int i = 0; i < n_in; i += 3) {  // unrolled by 3 so the rows rotate without copies
    step(i, r0, r2, r1);
    if (i + 1 < n_in) step(i + 1, r1, r0, r2);
    if (i + 2 < n_in) step(i + 2, r2, r1, r0);
  }

  // add the warps' sums in order, one (tap, channel) entry per thread
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warps][9][kCE]
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) red[(warp * 9 + t) * kCE + lane * V + v] = acc[t][v];
  __syncthreads();
  const long long p =
      (static_cast<long long>(blockIdx.z) * tl.nbands + blockIdx.y) * tl.ntw + tile;
  for (int e = tid; e < 9 * kCE; e += blockDim.x) {
    const int t = e / kCE, ch = e % kCE;
    if (c0 + ch >= C) continue;
    float s = red[t * kCE + ch];
    for (int wp = 1; wp < tl.warps; ++wp) s += red[(wp * 9 + t) * kCE + ch];
    partial[(p * 9 + t) * C + c0 + ch] = s;
  }
}

__global__ void __launch_bounds__(kFinishCols * kFinishSegs) dw3x3_wgrad_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ dk, int P, int n) {
  __shared__ float seg_sum[kFinishSegs][kFinishCols];
  const int col = threadIdx.x % kFinishCols, seg = threadIdx.x / kFinishCols;
  const int i = blockIdx.x * kFinishCols + col;
  const int per = (P + kFinishSegs - 1) / kFinishSegs;
  const int p1 = min(P, (seg + 1) * per);
  float s = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int p = seg * per; p < p1; ++p) s += partial[static_cast<long long>(p) * n + i];
  }
  seg_sum[seg][col] = s;
  __syncthreads();
  if (seg == 0 && i < n) {
#pragma unroll
    for (int q = 1; q < kFinishSegs; ++q) s += seg_sum[q][col];
    dk[i] = s;
  }
}

template <typename T, int G>
cudaError_t launch(const void* x, const void* g, void* partial, void* dk, int B, int H,
                   int W, int C, const Tile& tl, int P, cudaStream_t stream) {
  const int ce = kChunkBytes / sizeof(T);
  const size_t ring = static_cast<size_t>(kStages) * slot_bytes(tl.warps * kWarpCols);
  const size_t red = static_cast<size_t>(tl.warps) * 9 * ce * sizeof(float);
  const size_t smem = ring > red ? ring : red;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(dw3x3_wgrad_partial_kernel<T, G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tl.nchunks * tl.ntw, tl.nbands, B);
  dw3x3_wgrad_partial_kernel<T, G><<<grid, tl.warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(partial), H, W,
      C, tl);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * C;
  dw3x3_wgrad_finish_kernel<<<blocks_for(n, kFinishCols), kFinishCols * kFinishSegs, 0,
                              stream>>>(static_cast<const float*>(partial),
                                        static_cast<float*>(dk), P, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_copy(int vec, const void* x, const void* g, void* partial, void* dk,
                          int B, int H, int W, int C, const Tile& tl, int P, cudaStream_t s) {
  switch (vec * static_cast<int>(sizeof(T))) {
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, 2>(x, g, partial, dk, B, H, W, C, tl, P, s);
      return cudaErrorInvalidValue;
    case 4: return launch<T, 4>(x, g, partial, dk, B, H, W, C, tl, P, s);
    case 8: return launch<T, 8>(x, g, partial, dk, B, H, W, C, tl, P, s);
    case 16: return launch<T, 16>(x, g, partial, dk, B, H, W, C, tl, P, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace seghiero

// Rows P of the partial-sum scratch that seghiero_dw3x3_wgrad needs for x of
// shape [B, H, W, ·]: 0 when there are no pixels, −1 past an int.
extern "C" int seghiero_dw3x3_wgrad_partials(int B, int H, int W) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const long long P = seghiero::partials(B, H, W);
  return P > 0x7fffffff ? -1 : static_cast<int>(P);
}

// x, g: [B, H, W, C] contiguous, both of `dtype`; partial: [P, 9, C] f32
// scratch with P = seghiero_dw3x3_wgrad_partials(B, H, W) (the wrapper
// allocates it); dk: [9, C] f32, taps in (dy, dx) row-major
// order. Each copy moves `vec` elements: vec must divide C and the wrapper
// guarantees the vec·itemsize alignment of x and g. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or
// vec, a P that does not match the shape, or a shape past the grid's
// limits).
extern "C" int seghiero_dw3x3_wgrad(const void* x, const void* g, void* partial, void* dk,
                                    int B, int H, int W, int C, int dtype, int vec, int P,
                                    int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C == 0) return cudaSuccess;
  if (vec <= 0 || C % vec || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || W == 0)  // no pixels: dk is 0 and there is no scratch
    return P == 0 ? cudaMemsetAsync(dk, 0, sizeof(float) * 9 * C, s) : cudaErrorInvalidValue;
  const Tile tl = make_tile(H, W, C, dtype == kBFloat16 ? 2 : 4);
  if (static_cast<long long>(P) != partials(B, H, W) || tl.nbands > 65535)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_copy<float>(vec, x, g, partial, dk, B, H, W, C, tl, P, s);
  if (dtype == kBFloat16)
    return dispatch_copy<__nv_bfloat16>(vec, x, g, partial, dk, B, H, W, C, tl, P, s);
  return cudaErrorInvalidValue;
}
