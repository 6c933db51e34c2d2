// Fused exact-4× bilinear upsample + per-level channel argmax (the
// inference "hierarchy decode").
//
// Replaces: seghiero_tpu/ops/pallas/upsample_argmax.py,
// `fused_upsample_argmax` (the pl.pallas_call at :153, kernel body
// `_kernel` :68-93), called from the predictor's masks-only path
// (seghiero_tpu/infer/predictor.py:107-125).
//
// What bounds it on an H100: memory bandwidth. It reads the low-res logits
// once and writes one int32 mask per level; the upsampled logits never
// exist in memory. At the serving shape [8,13,128,128] f32 → 2 levels of
// [8,512,512] that is 6.8 MB in and 16.8 MB out, 7.0 µs at 3.35 TB/s;
// 9 flop per channel and output pixel is 0.25 Gflop, 3.7 µs on the
// non-tensor f32 units.
//
// Design: one thread per output pixel (b, y, x) on a 3-D grid (x along an
// output row, y the rows, z the images: no thread divides to find its
// pixel), x fastest, so the int32 mask stores are coalesced. Half-pixel 4× upsampling with an edge clamp
// puts output row y in phase py = y & 3 of low-res row i = y >> 2: its two
// taps are rows i−1+ro and i+ro, clamped to [0, h−1], blended with the
// weights (a, b) of the phase table below (the `_PHASE` of
// seghiero_tpu/ops/pallas/hiera2_fused.py:63-68); columns likewise. A
// thread reads its 4 taps per channel straight from the C-major logits
// (neighbouring threads share taps, which L1 serves), blends each channel
// of a level's slice in f32 and keeps the first strict maximum, so ties go
// to the lowest channel as in jnp.argmax. The TPU kernel's nine shifted
// views, 16 phase-split outputs and final transpose have no counterpart:
// the thread clamps its own indices and writes the final layout.
//
// Numerics: the blend is ay·(ax·t00 + bx·t01) + by·(ax·t10 + bx·t11) in
// exactly that order with __fmul_rn / __fadd_rn (no FMA contraction), bf16
// taps upcast first — the arithmetic of the TPU kernel and of the plain
// PyTorch version in seghiero_torch/ops/upsample_argmax.py, so the masks
// equal the plain version's bit for bit.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kMaxLevels = 3;

struct Levels {
  int n;
  int lo[kMaxLevels];
  int hi[kMaxLevels];
  int* out[kMaxLevels];
};

// phase → (row offset of the low tap, weight of the low tap, weight of the high tap)
__device__ __forceinline__ void phase(int p, int& ro, float& a, float& b) {
  switch (p) {
    case 0: ro = 0; a = 0.375f; b = 0.625f; break;
    case 1: ro = 0; a = 0.125f; b = 0.875f; break;
    case 2: ro = 1; a = 0.875f; b = 0.125f; break;
    default: ro = 1; a = 0.625f; b = 0.375f; break;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) upsample_argmax_kernel(
    const T* __restrict__ logits, int B, int C, int h, int w, Levels lv) {
  // grid: x walks an output row, y the rows, z the images
  const int H = 4 * h, W = 4 * w;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const long long i = (static_cast<long long>(b) * H + y) * W + x;

  int ro, co;
  float ay, by, ax, bx;
  phase(y & 3, ro, ay, by);
  phase(x & 3, co, ax, bx);
  const int r0 = min(max((y >> 2) + ro - 1, 0), h - 1);
  const int r1 = min(max((y >> 2) + ro, 0), h - 1);
  const int c0 = min(max((x >> 2) + co - 1, 0), w - 1);
  const int c1 = min(max((x >> 2) + co, 0), w - 1);
  const int o00 = r0 * w + c0, o01 = r0 * w + c1, o10 = r1 * w + c0, o11 = r1 * w + c1;
  const long long plane = static_cast<long long>(h) * w;
  const T* base = logits + static_cast<long long>(b) * C * plane;

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.n) break;
    float best = 0.f;
    int idx = 0;
    for (int c = lv.lo[l]; c < lv.hi[l]; ++c) {
      const T* p = base + c * plane;
      const float u = __fadd_rn(__fmul_rn(ax, to_f32(p[o00])), __fmul_rn(bx, to_f32(p[o01])));
      const float v = __fadd_rn(__fmul_rn(ax, to_f32(p[o10])), __fmul_rn(bx, to_f32(p[o11])));
      const float val = __fadd_rn(__fmul_rn(ay, u), __fmul_rn(by, v));
      if (c == lv.lo[l]) {
        best = val;
      } else if (val > best) {  // strict: the first maximum wins
        best = val;
        idx = c - lv.lo[l];
      }
    }
    lv.out[l][i] = idx;
  }
}

}  // namespace
}  // namespace seghiero

// logits: [B, C, h, w] contiguous, `dtype`; level l covers channels
// [lo_l, hi_l) and writes int32 [B, 4h, 4w] to out_l (n_levels ≤ 3; the
// unused out pointers may be null). Returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype or level count).
extern "C" int seghiero_upsample_argmax(const void* logits, int B, int C, int h, int w,
                                        int dtype, int n_levels, int lo0, int hi0, int lo1,
                                        int hi1, int lo2, int hi2, void* out0, void* out1,
                                        void* out2, int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (B == 0 || h == 0 || w == 0) return cudaSuccess;
  Levels lv{n_levels,
            {lo0, lo1, lo2},
            {hi0, hi1, hi2},
            {static_cast<int*>(out0), static_cast<int*>(out1), static_cast<int*>(out2)}};
  if (B > 65535 || 4 * h > 65535) return cudaErrorInvalidValue;  // grid y/z limits
  constexpr int kThreads = 256;
  const dim3 grid(blocks_for(4LL * w, kThreads), 4 * h, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    upsample_argmax_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), B, C, h, w, lv);
  else if (dtype == kBFloat16)
    upsample_argmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), B, C, h, w, lv);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
