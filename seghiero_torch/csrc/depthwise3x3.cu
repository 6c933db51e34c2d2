// 3×3 depthwise convolution, stride 1, dilation 1, "same" zero padding,
// NHWC — forward only.
//
// Replaces: seghiero_tpu/ops/pallas/depthwise.py, `_dw_raw` (the
// pl.pallas_call at :221, kernel body `_fwd_kernel` :145-154), reached
// through `depthwise3x3` :265-286 from the head's separable bottlenecks
// (models/heads.py:101-104).
//
// What bounds it on an H100: memory bandwidth. Each output element costs
// 9 multiply-adds on 9 input elements that neighbouring outputs share, so
// the least traffic is one read of x and one write of the output. At the
// serving shape [8,128,128,560] bf16 that is 293.6 MB, 87.6 µs at
// 3.35 TB/s; 18 flop per element is 1.3 Gflop, 20 µs even on the
// non-tensor f32 units.
//
// Design: one thread per (b, h, 4 adjacent w) and V adjacent channels
// (V = 8 for bf16, 4 for f32, i.e. one 16-byte vector; smaller when C or an
// address is not a multiple of it). Threads are numbered channel-vector
// fastest, so a warp reads contiguous C and every load is coalesced. For
// each of its 3 input rows a thread loads the 6 columns its 4 outputs
// need once and keeps them in registers: 18 vector loads of x and 9 of the
// taps per 4 outputs instead of 36 and 36, and the rows shared with the
// threads above and below come from L1/L2, not device memory. The TPU
// kernel's row tiles, halo blocks and lane rolls have no counterpart: a
// thread computes its own offsets and skips the taps that fall outside the
// image (adding a zero tap leaves the f32 sum unchanged).
//
// Numerics: the 9 taps are summed in f32 in (dy, dx) row-major order from
// 0, with __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs;
// the result is rounded once to the input dtype. That is the arithmetic
// of the TPU kernel and of the plain PyTorch version in
// seghiero_torch/ops/depthwise.py, so the kernel equals the plain version
// bit for bit.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kStrip = 4;  // outputs along W per thread

template <typename T, int V>
__global__ void __launch_bounds__(256) dw3x3_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ k9, T* __restrict__ out,
    int B, int H, int W, int C) {
  // grid: x walks the (strip, channel vector) pairs of one image row,
  // y the rows, z the images — no 64-bit index division per thread
  const int CV = C / V;
  const int WS = (W + kStrip - 1) / kStrip;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= WS * CV) return;
  const int c0 = (t % CV) * V;
  const int w0 = (t / CV) * kStrip;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  float acc[kStrip][V];
#pragma unroll
  for (int r = 0; r < kStrip; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hh = h + dy - 1;
    if (hh < 0 || hh >= H) continue;
    // input columns w0−1 … w0+kStrip of row hh (the ones outside the image
    // are never read: their taps are skipped below)
    Pack<T, V> cols[kStrip + 2];
    const T* row = x + ((static_cast<long long>(b) * H + hh) * W) * C + c0;
#pragma unroll
    for (int j = 0; j < kStrip + 2; ++j) {
      const int ww = w0 - 1 + j;
      if (ww >= 0 && ww < W)
        cols[j] = *reinterpret_cast<const Pack<T, V>*>(row + static_cast<long long>(ww) * C);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const Pack<T, V> kv =
          *reinterpret_cast<const Pack<T, V>*>(k9 + (dy * 3 + dx) * C + c0);
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const int ww = w0 + r + dx - 1;  // column r + dx of cols
        if (ww < 0 || ww >= W) continue;
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] = __fadd_rn(acc[r][v],
                                __fmul_rn(to_f32(cols[r + dx].v[v]), to_f32(kv.v[v])));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kStrip; ++r) {
    if (w0 + r >= W) break;
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(acc[r][v]);
    *reinterpret_cast<Pack<T, V>*>(
        out + ((static_cast<long long>(b) * H + h) * W + w0 + r) * C + c0) = o;
  }
}

template <typename T, int V>
void launch(const void* x, const void* k9, void* out, int B, int H, int W, int C,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid(blocks_for(static_cast<long long>((W + kStrip - 1) / kStrip) * (C / V), kThreads),
                  H, B);
  dw3x3_fwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k9), static_cast<T*>(out), B, H,
      W, C);
}

template <typename T>
bool dispatch_vec(int vec, const void* x, const void* k9, void* out, int B, int H, int W,
                  int C, cudaStream_t stream) {
  switch (vec) {
    case 1: launch<T, 1>(x, k9, out, B, H, W, C, stream); return true;
    case 2: launch<T, 2>(x, k9, out, B, H, W, C, stream); return true;
    case 4: launch<T, 4>(x, k9, out, B, H, W, C, stream); return true;
    case 8:
      if constexpr (sizeof(T) * 8 <= 16) {  // 16-byte vectors at most
        launch<T, 8>(x, k9, out, B, H, W, C, stream);
        return true;
      }
      return false;
    default: return false;
  }
}

}  // namespace
}  // namespace seghiero

// x, out: [B, H, W, C] contiguous; k9: [9, C] contiguous, taps in (dy, dx)
// row-major order; all three of `dtype`. `vec` channels per thread must
// divide C and the wrapper guarantees the vec·itemsize alignment of every
// pointer. Returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported dtype or vec).
extern "C" int seghiero_dw3x3_fwd(const void* x, const void* k9, void* out, int B, int H,
                                  int W, int C, int dtype, int vec, int device,
                                  void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0 || W == 0 || C == 0) return cudaSuccess;
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;  // grid y/z limits
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kFloat32)
    ok = dispatch_vec<float>(vec, x, k9, out, B, H, W, C, s);
  else if (dtype == kBFloat16)
    ok = dispatch_vec<__nv_bfloat16>(vec, x, k9, out, B, H, W, C, s);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
