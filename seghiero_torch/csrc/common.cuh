// Helpers shared by the port's CUDA kernels.
//
// Every exported function has a plain C interface (loaded with ctypes by
// seghiero_torch/ops/_build.py): pointers and the stream arrive as void*,
// sizes as int, and the function returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace seghiero {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// V elements of T loaded or stored as one aligned vector access
// (16 bytes for 8 bf16 or 4 f32).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Half-pixel 4× bilinear upsampling with an edge clamp puts output row y in
// phase p = y & 3 of low-res row i = y >> 2; its two taps are rows
// i − 1 + ro and i + ro (clamped to [0, h − 1]), blended with weights
// (a, b). The table is the `_PHASE` of
// seghiero_tpu/ops/pallas/hiera2_fused.py:63-68; columns likewise.
__device__ __forceinline__ void upsample4_phase(int p, int& ro, float& a, float& b) {
  switch (p) {
    case 0: ro = 0; a = 0.375f; b = 0.625f; break;
    case 1: ro = 0; a = 0.125f; b = 0.875f; break;
    case 2: ro = 1; a = 0.875f; b = 0.125f; break;
    default: ro = 1; a = 0.625f; b = 0.375f; break;
  }
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace seghiero
