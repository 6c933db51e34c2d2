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

// Asynchronous copies (sm_80+): `Bytes` from global to shared memory, or
// `Bytes` zeros when `valid` is false (src-size 0 reads nothing; the
// address then only has to be a mapped one). 16-byte copies bypass L1.
// A 2-byte element has no cp.async form and is copied synchronously.
template <int Bytes>
__device__ __forceinline__ void copy_async_or_zero(void* smem, const void* gmem, bool valid) {
  static_assert(Bytes == 2 || Bytes == 4 || Bytes == 8 || Bytes == 16, "copy size");
  if constexpr (Bytes == 2) {
    *static_cast<unsigned short*>(smem) =
        valid ? *static_cast<const unsigned short*>(gmem) : static_cast<unsigned short>(0);
  } else {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int src_size = valid ? Bytes : 0;
    if constexpr (Bytes == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                   "r"(src_size));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                   "n"(Bytes), "r"(src_size));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace seghiero
