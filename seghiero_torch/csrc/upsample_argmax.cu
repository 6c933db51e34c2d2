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
// [8,512,512] that is 6.8 MB in and 16.8 MB out, 7.0 µs at 3.35 TB/s
// (in bf16, the dtype the serving model's logits have, 3.4 MB in: 6.0 µs);
// 9 flop per channel and output pixel is 0.25 Gflop, 3.7 µs on the
// non-tensor f32 units. Writing the masks is most of it.
//
// Design: one thread per low-res pixel (b, i, j) on a 3-D grid (j along a
// low-res row, i the rows, b the images: no thread divides to find its
// pixel), owning its 4×4 output pixels (rows 4i … 4i+3, columns 4j …
// 4j+3). Half-pixel 4× upsampling with an edge clamp puts output row 4i+py
// in phase py, with taps rows i−1+ro and i+ro (ro = 0 for py < 2, else 1)
// clamped to [0, h−1], blended with the weights (a, b) of
// `upsample4_phase` in common.cuh; columns likewise. So the 16 outputs
// read only the clamped 3×3 neighbourhood of (i, j): per channel the
// thread loads those 9 taps once (neighbouring threads share them, which
// L1 serves), forms the 12 horizontal blends ax·t[r][c] + bx·t[r][c+1] of
// its 3 tap rows at the 4 column phases once, then the 16 vertical blends
// of two of them, and keeps 16 running (best, index) pairs per level: the
// first strict maximum, so ties go to the lowest channel as in jnp.argmax.
// Each output row's 4 int32 are one 16-byte store (a warp writes 512
// contiguous bytes a row). 9 loads and 84 f32 operations per channel and
// 16 outputs, against 4 loads and 9 operations per channel and output one
// output a thread. The TPU kernel's nine shifted views, 16 phase-split
// outputs and final transpose have no counterpart: the thread clamps its
// own indices and writes the final layout.
//
// Numerics: each output is ay·(ax·t00 + bx·t01) + by·(ax·t10 + bx·t11) in
// exactly that order with __fmul_rn / __fadd_rn (no FMA contraction), bf16
// taps upcast first — the arithmetic of the TPU kernel and of the plain
// PyTorch version in seghiero_torch/ops/upsample_argmax.py; a horizontal
// blend shared by two output rows is the same expression on the same taps,
// so the masks equal the plain version's bit for bit.

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

constexpr int kThreads = 128;  // low-res pixels of one row a block

template <typename T>
__global__ void __launch_bounds__(kThreads) upsample_argmax_kernel(
    const T* __restrict__ logits, int C, int h, int w, Levels lv) {
  // grid: x walks a low-res row, y the rows, z the images
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= w) return;
  const int i = blockIdx.y, b = blockIdx.z;
  const int H = 4 * h, W = 4 * w;
  // the clamped tap rows i − 1, i, i + 1 (as offsets) and columns j − 1, j, j + 1
  const int row[3] = {max(i - 1, 0) * w, i * w, min(i + 1, h - 1) * w};
  const int col[3] = {max(j - 1, 0), j, min(j + 1, w - 1)};
  const long long plane = static_cast<long long>(h) * w;
  const T* base = logits + static_cast<long long>(b) * C * plane;

  // the 16 outputs of channel c: v[py][px]
  auto blend = [&](int c, float (&v)[4][4]) {
    const T* p = base + c * plane;
    float t[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) t[r][q] = to_f32(p[row[r] + col[q]]);
    float hb[3][4];  // tap row r blended at column phase px
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      int co;
      float ax, bx;
      upsample4_phase(px, co, ax, bx);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        hb[r][px] = __fadd_rn(__fmul_rn(ax, t[r][co]), __fmul_rn(bx, t[r][co + 1]));
    }
#pragma unroll
    for (int py = 0; py < 4; ++py) {
      int ro;
      float ay, by;
      upsample4_phase(py, ro, ay, by);
#pragma unroll
      for (int px = 0; px < 4; ++px)
        v[py][px] = __fadd_rn(__fmul_rn(ay, hb[ro][px]), __fmul_rn(by, hb[ro + 1][px]));
    }
  };

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.n) break;
    float best[4][4];
    int idx[4][4];
    blend(lv.lo[l], best);
#pragma unroll
    for (int py = 0; py < 4; ++py)
#pragma unroll
      for (int px = 0; px < 4; ++px) idx[py][px] = 0;
    for (int c = lv.lo[l] + 1; c < lv.hi[l]; ++c) {
      float v[4][4];
      blend(c, v);
#pragma unroll
      for (int py = 0; py < 4; ++py)
#pragma unroll
        for (int px = 0; px < 4; ++px)
          if (v[py][px] > best[py][px]) {  // strict: the first maximum wins
            best[py][px] = v[py][px];
            idx[py][px] = c - lv.lo[l];
          }
    }
#pragma unroll
    for (int py = 0; py < 4; ++py) {
      const long long o = (static_cast<long long>(b) * H + 4 * i + py) * W + 4 * j;
      *reinterpret_cast<int4*>(lv.out[l] + o) =
          make_int4(idx[py][0], idx[py][1], idx[py][2], idx[py][3]);
    }
  }
}

}  // namespace
}  // namespace seghiero

// logits: [B, C, h, w] contiguous, `dtype`; level l covers channels
// [lo_l, hi_l) and writes int32 [B, 4h, 4w] to out_l (16-byte aligned;
// n_levels ≤ 3; the unused out pointers may be null). Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or
// level count, or more than 65535 images or low-res rows).
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
  if (B > 65535 || h > 65535) return cudaErrorInvalidValue;  // grid y/z limits
  const dim3 grid(blocks_for(w, kThreads), h, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    upsample_argmax_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(logits),
                                                            C, h, w, lv);
  else if (dtype == kBFloat16)
    upsample_argmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), C, h, w, lv);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
