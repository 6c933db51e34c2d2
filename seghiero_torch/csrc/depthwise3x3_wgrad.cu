// Weight gradient of the 3×3 depthwise convolution (stride 1, dilation 1,
// "same" zero padding), NHWC:  dk[dy·3+dx, c] = Σ_{b,h,w} x[b, h+dy−1,
// w+dx−1, c] · g[b, h, w, c]  in f32.
//
// Replaces: seghiero_tpu/ops/pallas/depthwise.py, `_dw_wgrad` (the
// pl.pallas_call at :245, kernel body `_wgrad_kernel` :157-173), reached
// from `_dw_bwd` :289-302 — the backward of the head's separable
// bottlenecks in training.
//
// What bounds it on an H100: memory bandwidth. Every element of x and g is
// read once (the 9 taps reuse the x rows a thread already holds); the
// output is 9·C floats. At the train shapes [8,128,128,560] and
// [8,128,128,512] bf16 that is 562 MB, 0.168 ms at 3.35 TB/s; the 18 flop
// per element are 2.4 Gflop, 0.04 ms on the non-tensor f32 units.
//
// Design: a reduction over B·H·W pixels per (tap, channel), in two passes
// and without float atomics, so two runs give the same bits.
//  * Pass 1: a block is (cvb channel vectors) × (8 row slots); each thread
//    owns V adjacent channels (one 16-byte vector where C and the pointers
//    allow) and walks kSeg columns of kItems (image row, column segment)
//    items. It keeps a 3×3 window of x vectors in registers and slides it
//    one column per step (3 new x loads and 1 g load per pixel), adding
//    x·g to its 9×V f32 sums. The block then adds its 8 row slots in order
//    through shared memory and writes one partial [9, C] row per block:
//    partial [P, 9, C] f32. Taps outside the image read zero, as the
//    forward's padding does.
//  * Pass 2: one thread per (tap, channel) adds the P partials in order.
// The TPU kernel's channel-outermost grid and resident [9, CB] output block
// (Pallas accumulates only across consecutive grid steps) have no
// counterpart: blocks run in parallel and meet in the second pass.
//
// Numerics: f32 sums in an order set by the launch geometry (not the plain
// version's), so the plain version in seghiero_torch/ops/depthwise.py is
// compared within 1e-5 · Σ|x·g| per entry, not bit for bit.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kSeg = 32;    // columns per item
constexpr int kSlots = 8;   // row slots per block (blockDim.y)
constexpr int kItems = 2;   // items per thread

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_or_zero(const T* __restrict__ x, int b, int hh,
                                                   int ww, int H, int W, int C, int c0) {
  Pack<T, V> p;
  if (hh < 0 || hh >= H || ww < 0 || ww >= W) {
#pragma unroll
    for (int v = 0; v < V; ++v) p.v[v] = from_f32<T>(0.f);
    return p;
  }
  return *reinterpret_cast<const Pack<T, V>*>(
      x + ((static_cast<long long>(b) * H + hh) * W + ww) * C + c0);
}

template <typename T, int V>
__global__ void __launch_bounds__(256) dw3x3_wgrad_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial, int B,
    int H, int W, int C, int cvb) {
  const int CV = C / V;
  const int cv = blockIdx.x * cvb + threadIdx.x;
  const bool active = threadIdx.x < cvb && cv < CV;
  const int c0 = cv * V;
  const int nseg = (W + kSeg - 1) / kSeg;
  const long long n_items = static_cast<long long>(B) * H * nseg;

  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  if (active) {
    for (int k = 0; k < kItems; ++k) {
      const long long item =
          (static_cast<long long>(blockIdx.y) * kItems + k) * kSlots + threadIdx.y;
      if (item >= n_items) break;
      const int seg = static_cast<int>(item % nseg);
      const long long row = item / nseg;  // b·H + h
      const int h = static_cast<int>(row % H);
      const int b = static_cast<int>(row / H);
      const int w0 = seg * kSeg;
      const int w1 = min(w0 + kSeg, W);
      // win[r][j]: x at row h+r−1, column w+j−1 of the current w
      Pack<T, V> win[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        win[r][1] = load_or_zero<T, V>(x, b, h + r - 1, w0 - 1, H, W, C, c0);
        win[r][2] = load_or_zero<T, V>(x, b, h + r - 1, w0, H, W, C, c0);
      }
      for (int w = w0; w < w1; ++w) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          win[r][0] = win[r][1];
          win[r][1] = win[r][2];
          win[r][2] = load_or_zero<T, V>(x, b, h + r - 1, w + 1, H, W, C, c0);
        }
        const Pack<T, V> gv = *reinterpret_cast<const Pack<T, V>*>(
            g + ((static_cast<long long>(b) * H + h) * W + w) * C + c0);
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[r * 3 + j][v] += to_f32(win[r][j].v[v]) * to_f32(gv.v[v]);
      }
    }
  }

  // add the kSlots row slots in order, one tap at a time
  __shared__ float red[kSlots][32 * 8];
  const int ty = threadIdx.y, tx = threadIdx.x;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[ty][tx * V + v] = acc[t][v];
    __syncthreads();
    if (ty == 0 && active) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = red[0][tx * V + v];
        for (int y = 1; y < kSlots; ++y) s += red[y][tx * V + v];
        partial[(static_cast<long long>(blockIdx.y) * 9 + t) * C + c0 + v] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256) dw3x3_wgrad_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ dk, int P, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) s += partial[static_cast<long long>(p) * n + i];
  dk[i] = s;
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* g, void* partial, void* dk, int B, int H,
                   int W, int C, int P, cudaStream_t stream) {
  const int CV = C / V;
  const int groups = (CV + 31) / 32;
  const int cvb = (CV + groups - 1) / groups;  // ≤ 32 channel vectors per block
  const dim3 block(cvb, kSlots);
  const dim3 grid(groups, P);
  dw3x3_wgrad_partial_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(partial), B,
      H, W, C, cvb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * C;
  dw3x3_wgrad_finish_kernel<<<blocks_for(n, 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dk), P, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(int vec, const void* x, const void* g, void* partial, void* dk,
                         int B, int H, int W, int C, int P, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(x, g, partial, dk, B, H, W, C, P, s);
    case 2: return launch<T, 2>(x, g, partial, dk, B, H, W, C, P, s);
    case 4: return launch<T, 4>(x, g, partial, dk, B, H, W, C, P, s);
    case 8:
      if constexpr (sizeof(T) * 8 <= 16) return launch<T, 8>(x, g, partial, dk, B, H, W, C, P, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace seghiero

// x, g: [B, H, W, C] contiguous, both of `dtype`; partial: [P, 9, C] f32
// scratch with P = ceil(B·H·ceil(W/32) / 16) (the wrapper allocates it);
// dk: [9, C] f32, taps in (dy, dx) row-major order. `vec` channels per
// thread must divide C and the wrapper guarantees the vec·itemsize
// alignment of x and g. Returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported dtype or vec, or a P that does not match the shape).
extern "C" int seghiero_dw3x3_wgrad(const void* x, const void* g, void* partial, void* dk,
                                    int B, int H, int W, int C, int dtype, int vec, int P,
                                    int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C == 0) return cudaSuccess;
  const long long items = static_cast<long long>(B) * H * ((W + kSeg - 1) / kSeg);
  if (P != (items + kSlots * kItems - 1) / (kSlots * kItems) || P > 65535)
    return cudaErrorInvalidValue;
  if (P == 0) return cudaMemsetAsync(dk, 0, sizeof(float) * 9 * C, static_cast<cudaStream_t>(stream));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_vec<float>(vec, x, g, partial, dk, B, H, W, C, P, s);
  if (dtype == kBFloat16)
    return dispatch_vec<__nv_bfloat16>(vec, x, g, partial, dk, B, H, W, C, P, s);
  return cudaErrorInvalidValue;
}
