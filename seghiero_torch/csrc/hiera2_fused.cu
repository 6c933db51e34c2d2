// Fused 4× bilinear upsample + 2-level hierarchy BCE + per-level CE:
// forward (six loss sums) and backward (gradient onto the low-res logits).
//
// Replaces: seghiero_tpu/ops/pallas/hiera2_fused.py — the forward
// `_core_fwd_impl` (the pl.pallas_call at :322, kernel body `_fwd_kernel`
// :105-169) and the backward `_core_bwd_rule` (the pl.pallas_call at :348,
// kernel body `_bwd_kernel` :177-271), reached from
// `FastHieraTripletLoss` (seghiero_tpu/losses/fast.py:462-479) with
// `training.pallas_fused_loss: true`.
//
// Inputs: C-major f32 logits lo [B, C, h, w] (C = nf fine + nc coarse),
// int32 labels t_fine and t_coarse [B, 4h, 4w] (255 = ignore), and the
// fine→coarse table f2c [nf] on the device. The upsampled logits of a
// high-res pixel are rebuilt in registers from its 4 low-res taps (edge
// clamp in the index arithmetic, phase weights of `upsample4_phase`, the
// multiply-add order of upsample_argmax.cu), so nothing full-resolution but
// the labels is ever read or written. The TPU kernel's nine shifted views
// and phase-split labels exist for Mosaic's block-local access and have no
// counterpart here.
//
// Forward, per valid pixel (exactly the terms of `_fwd_kernel`; where the
// TPU kernel evaluates both sides of a `where`, this kernel evaluates the
// side it keeps):
//   s_f  += Σ_f [f = t_f] −log(σ(min(l_f, l_coarse(f))) + ε) + [f ≠ t_f] −log(1 − σ(l_f) + ε)
//   s_c  += Σ_c [c = t_c] −log(σ(l_c) + ε) + [c ≠ t_c] −log(1 − σ(max(l_c, l_f∈c)) + ε)
//   nv_f, nv_c += 1;  ce_f, ce_c += logsumexp − l[label]
// with the logit-space forms log(σ(m) + ε) = logaddexp(−softplus(−m), log ε)
// (ε = 1e-8). One thread per high-res pixel; each block adds its 256
// pixels' six sums in a fixed shuffle tree and writes one partial row; a
// second one-block pass adds the partials in a fixed order (in double).
// No float atomics: two runs give the same bits.
//
// Backward: the cotangents of sums 0, 1, 4 and 5 (the counts carry none).
// Per pixel the gradient routes ties as the TPU kernel does: the fine
// positive goes wholly to the fine channel when l_f <= l_coarse, the
// coarse negative to the first maximum of (own channel, then its fine
// children in id order), CE is softmax − one-hot. Design: one thread per
// low-res pixel (b, i, j) gathers from the ≤ 8×8 high-res pixels
// (rows 4i−2 … 4i+5, columns likewise) whose taps reach it, recomputing
// their per-pixel gradients, weighted by (tap weights that land on i) ×
// (those that land on j). Deterministic and scratch-free; the price is that
// each high-res pixel's gradient is computed 4 times. The alternative, a
// full-res f32 gradient scratch (109 MB at [8,13,128,128]) and a gather
// pass, moves 218 MB more; which is faster is left to measurement.
//
// What bounds them on an H100: operations (transcendentals), not bytes.
// The forward reads 6.8 MB of logits and 16.8 MB of labels at
// [8,13,128,128] (7 µs at 3.35 TB/s) but evaluates 5·(nf+nc)+2 = 67
// exp/log per valid pixel (2.1 M pixels, 16 per clock per SM on 132 SMs:
// ≈ 35 µs at 1.98 GHz); the backward needs 7·(nf+nc) = 91 per pixel.
//
// Numerics: the upsampled logits equal the plain version's bit for bit (same
// f32 operations in the same order, no FMA contraction); the transcendental
// library calls and the summation order differ, so sums are compared within
// 1e-5 relative and the gradient within rtol 2e-4, atol 1e-7.

#include "common.cuh"

namespace seghiero {
namespace {

constexpr float kLogEps = -18.420680743952367f;  // log(1e-8)
constexpr int kIgnore = 255;
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}
__device__ __forceinline__ float softplus(float x) { return logaddexp(x, 0.f); }
__device__ __forceinline__ float log_sig_eps(float m) { return logaddexp(-softplus(-m), kLogEps); }
__device__ __forceinline__ float log1m_sig_eps(float m) { return logaddexp(-softplus(m), kLogEps); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// d/dm log(σ(m) + ε) = wu·σ(−m) with wu = σ(m)/(σ(m)+ε), in the TPU
// kernel's form
__device__ __forceinline__ float dlog_sig_eps(float m) {
  const float u = -softplus(-m);
  return expf(u - logaddexp(u, kLogEps)) * sigmoid(-m);
}
// d/dm −log(1 − σ(m) + ε) = wu2·σ(m) with wu2 = σ(−m)/(σ(−m)+ε)
__device__ __forceinline__ float dneg_log1m_sig_eps(float m) {
  const float u = -softplus(m);
  return expf(u - logaddexp(u, kLogEps)) * sigmoid(m);
}

// The 4 taps and weights of high-res pixel (y, x) on a [h, w] grid.
struct Taps {
  int o00, o01, o10, o11;
  float ay, by, ax, bx;
  int r0, r1, c0, c1;
};

__device__ __forceinline__ Taps taps_of(int y, int x, int h, int w) {
  Taps t;
  int ro, co;
  upsample4_phase(y & 3, ro, t.ay, t.by);
  upsample4_phase(x & 3, co, t.ax, t.bx);
  t.r0 = min(max((y >> 2) + ro - 1, 0), h - 1);
  t.r1 = min(max((y >> 2) + ro, 0), h - 1);
  t.c0 = min(max((x >> 2) + co - 1, 0), w - 1);
  t.c1 = min(max((x >> 2) + co, 0), w - 1);
  t.o00 = t.r0 * w + t.c0;
  t.o01 = t.r0 * w + t.c1;
  t.o10 = t.r1 * w + t.c0;
  t.o11 = t.r1 * w + t.c1;
  return t;
}

__device__ __forceinline__ float blend(const float* __restrict__ p, const Taps& t) {
  const float u = __fadd_rn(__fmul_rn(t.ax, p[t.o00]), __fmul_rn(t.bx, p[t.o01]));
  const float v = __fadd_rn(__fmul_rn(t.ax, p[t.o10]), __fmul_rn(t.bx, p[t.o11]));
  return __fadd_rn(__fmul_rn(t.ay, u), __fmul_rn(t.by, v));
}

// Upsampled logits of one pixel: fine channels lf[0, nf), coarse lc[0, nc).
// CF / CC bound nf / nc at compile time so the arrays stay in registers.
template <int CF, int CC>
__device__ __forceinline__ void pixel_logits(const float* __restrict__ lo_b, long long plane,
                                             const Taps& t, int nf, int nc, float (&lf)[CF],
                                             float (&lc)[CC]) {
#pragma unroll
  for (int f = 0; f < CF; ++f) lf[f] = f < nf ? blend(lo_b + f * plane, t) : 0.f;
#pragma unroll
  for (int c = 0; c < CC; ++c) lc[c] = c < nc ? blend(lo_b + (nf + c) * plane, t) : 0.f;
}

// coarse logit of the parent of fine label `tf` (0 when tf is out of range)
template <int CF, int CC>
__device__ __forceinline__ float parent_logit(const float (&lc)[CC], const int (&pf)[CF],
                                              int tf, int& parent) {
  parent = -1;
#pragma unroll
  for (int f = 0; f < CF; ++f)
    if (f == tf) parent = pf[f];
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c == parent) v = lc[c];
  return v;
}

// The six per-pixel terms (s_f, s_c, nv_f, nv_c, ce_f, ce_c).
template <int CF, int CC>
__device__ __forceinline__ void pixel_sums(const float (&lf)[CF], const float (&lc)[CC],
                                           const int (&pf)[CF], int nf, int nc, int tf, int tc,
                                           float (&out)[6]) {
  if (tf != kIgnore) {
    int parent;
    const float lpar = parent_logit<CF, CC>(lc, pf, tf, parent);
    float acc = 0.f, mx = lf[0];
#pragma unroll
    for (int f = 0; f < CF; ++f) {
      if (f >= nf) break;
      acc += f == tf ? -log_sig_eps(fminf(lf[f], lpar)) : -log1m_sig_eps(lf[f]);
      mx = fmaxf(mx, lf[f]);
    }
    float se = 0.f, picked = 0.f;
#pragma unroll
    for (int f = 0; f < CF; ++f) {
      if (f >= nf) break;
      se += expf(lf[f] - mx);
      if (f == tf) picked = lf[f];
    }
    out[0] = acc;
    out[2] = 1.f;
    out[4] = logf(se) + mx - picked;
  }
  if (tc != kIgnore) {
    float acc = 0.f, mx = lc[0];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      if (c >= nc) break;
      if (c == tc) {
        acc += -log_sig_eps(lc[c]);
      } else {
        float bmax = lc[c];
#pragma unroll
        for (int f = 0; f < CF; ++f)
          if (f < nf && pf[f] == c) bmax = fmaxf(bmax, lf[f]);
        acc += -log1m_sig_eps(bmax);
      }
      mx = fmaxf(mx, lc[c]);
    }
    float se = 0.f, picked = 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      if (c >= nc) break;
      se += expf(lc[c] - mx);
      if (c == tc) picked = lc[c];
    }
    out[1] = acc;
    out[3] = 1.f;
    out[5] = logf(se) + mx - picked;
  }
}

// Per-pixel gradient of g_sf·s_f + g_sc·s_c + g_cef·ce_f + g_cec·ce_c with
// respect to the upsampled logits, accumulated as w·dl into (af, ac).
template <int CF, int CC>
__device__ __forceinline__ void pixel_grad_acc(const float (&lf)[CF], const float (&lc)[CC],
                                               const int (&pf)[CF], int nf, int nc, int tf,
                                               int tc, float g_sf, float g_sc, float g_cef,
                                               float g_cec, float wgt, float (&af)[CF],
                                               float (&ac)[CC]) {
  float dlf[CF], dlc[CC];
#pragma unroll
  for (int f = 0; f < CF; ++f) dlf[f] = 0.f;
#pragma unroll
  for (int c = 0; c < CC; ++c) dlc[c] = 0.f;

  if (tf != kIgnore) {
    int parent;
    const float lpar = parent_logit<CF, CC>(lc, pf, tf, parent);
    // fine BCE: the positive through min(l_f, l_parent), ties to the fine
    // channel; the negatives at every other fine channel
#pragma unroll
    for (int f = 0; f < CF; ++f) {
      if (f >= nf) break;
      if (f == tf) {
        const float m = fminf(lf[f], lpar);
        const float gpos = -dlog_sig_eps(m) * g_sf;
        if (lf[f] <= lpar) {
          dlf[f] += gpos;
        } else {
#pragma unroll
          for (int c = 0; c < CC; ++c)
            if (c == parent) dlc[c] += gpos;
        }
      } else {
        dlf[f] += dneg_log1m_sig_eps(lf[f]) * g_sf;
      }
    }
  }
  if (tc != kIgnore) {
    // coarse BCE: the positive at the own channel; the negative through the
    // bucket max, routed to the first maximum of (own, children in id order)
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      if (c >= nc) break;
      if (c == tc) {
        dlc[c] += -dlog_sig_eps(lc[c]) * g_sc;
      } else {
        float bmax = lc[c];
        int winner = -1;
#pragma unroll
        for (int f = 0; f < CF; ++f) {
          if (f < nf && pf[f] == c && lf[f] > bmax) {
            bmax = lf[f];
            winner = f;
          }
        }
        const float rem = dneg_log1m_sig_eps(bmax) * g_sc;
        if (winner < 0) dlc[c] += rem;
#pragma unroll
        for (int f = 0; f < CF; ++f)
          if (f == winner) dlf[f] += rem;
      }
    }
  }
  if (tf != kIgnore) {  // fine CE: softmax − one-hot
    float mx = lf[0], e[CF], se = 0.f;
#pragma unroll
    for (int f = 0; f < CF; ++f)
      if (f < nf) mx = fmaxf(mx, lf[f]);
#pragma unroll
    for (int f = 0; f < CF; ++f) {
      e[f] = f < nf ? expf(lf[f] - mx) : 0.f;
      se += e[f];
    }
#pragma unroll
    for (int f = 0; f < CF; ++f)
      if (f < nf) dlf[f] += (e[f] / se - (f == tf ? 1.f : 0.f)) * g_cef;
  }
  if (tc != kIgnore) {  // coarse CE
    float mx = lc[0], e[CC], se = 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c < nc) mx = fmaxf(mx, lc[c]);
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      e[c] = c < nc ? expf(lc[c] - mx) : 0.f;
      se += e[c];
    }
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c < nc) dlc[c] += (e[c] / se - (c == tc ? 1.f : 0.f)) * g_cec;
  }
#pragma unroll
  for (int f = 0; f < CF; ++f) af[f] += wgt * dlf[f];
#pragma unroll
  for (int c = 0; c < CC; ++c) ac[c] += wgt * dlc[c];
}

template <int CF>
__device__ __forceinline__ void load_parents(const int* __restrict__ f2c, int nf, int (&pf)[CF]) {
#pragma unroll
  for (int f = 0; f < CF; ++f) pf[f] = f < nf ? f2c[f] : -1;
}

template <int CF, int CC>
__global__ void __launch_bounds__(kFwdThreads) hiera2_fwd_kernel(
    const float* __restrict__ lo, const int* __restrict__ t_fine,
    const int* __restrict__ t_coarse, const int* __restrict__ f2c,
    float* __restrict__ partial, int B, int C, int h, int w, int nf, int nc) {
  // grid: x walks an output row, y the rows, z the images
  const int H = 4 * h, W = 4 * w;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (x < W) {
    const long long i = (static_cast<long long>(b) * H + y) * W + x;
    const int tf = t_fine[i], tc = t_coarse[i];
    if (tf != kIgnore || tc != kIgnore) {
      int pf[CF];
      load_parents<CF>(f2c, nf, pf);
      float lf[CF], lc[CC];
      const long long plane = static_cast<long long>(h) * w;
      pixel_logits<CF, CC>(lo + static_cast<long long>(b) * C * plane, plane,
                           taps_of(y, x, h, w), nf, nc, lf, lc);
      pixel_sums<CF, CC>(lf, lc, pf, nf, nc, tf, tc, s);
    }
  }
  // fixed-order block sum: shuffle tree inside each warp, then warps in order
  __shared__ float warp_sums[kFwdThreads / 32][6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 6; ++k) warp_sums[warp][k] = s[k];
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.f;
    for (int q = 0; q < kFwdThreads / 32; ++q) v += warp_sums[q][threadIdx.x];
    const long long blk =
        (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[blk * 6 + threadIdx.x] = v;
  }
}

// one block: sums[k] = Σ_p partial[p, k], in double, fixed order
__global__ void __launch_bounds__(256) hiera2_finish_kernel(const float* __restrict__ partial,
                                                            float* __restrict__ sums,
                                                            long long P) {
  __shared__ double red[256][6];
  double s[6] = {0, 0, 0, 0, 0, 0};
  for (long long p = threadIdx.x; p < P; p += blockDim.x)
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] += partial[p * 6 + k];
#pragma unroll
  for (int k = 0; k < 6; ++k) red[threadIdx.x][k] = s[k];
  __syncthreads();
  for (int stride = 128; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
#pragma unroll
      for (int k = 0; k < 6; ++k) red[threadIdx.x][k] += red[threadIdx.x + stride][k];
    __syncthreads();
  }
  if (threadIdx.x < 6) sums[threadIdx.x] = static_cast<float>(red[0][threadIdx.x]);
}

template <int CF, int CC>
__global__ void __launch_bounds__(kBwdThreads) hiera2_bwd_kernel(
    const float* __restrict__ lo, const int* __restrict__ t_fine,
    const int* __restrict__ t_coarse, const int* __restrict__ f2c,
    const float* __restrict__ gsum, float* __restrict__ dlo, int B, int C, int h, int w,
    int nf, int nc) {
  // grid: x walks a low-res row, y the low-res rows, z the images
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= w) return;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int H = 4 * h, W = 4 * w;
  const float g_sf = gsum[0], g_sc = gsum[1], g_cef = gsum[4], g_cec = gsum[5];
  int pf[CF];
  load_parents<CF>(f2c, nf, pf);
  const long long plane = static_cast<long long>(h) * w;
  const float* lo_b = lo + static_cast<long long>(b) * C * plane;
  float af[CF], ac[CC];
#pragma unroll
  for (int f = 0; f < CF; ++f) af[f] = 0.f;
#pragma unroll
  for (int c = 0; c < CC; ++c) ac[c] = 0.f;

  const int y_lo = max(4 * i - 2, 0), y_hi = min(4 * i + 5, H - 1);
  const int x_lo = max(4 * j - 2, 0), x_hi = min(4 * j + 5, W - 1);
  for (int y = y_lo; y <= y_hi; ++y) {
    for (int x = x_lo; x <= x_hi; ++x) {
      const Taps t = taps_of(y, x, h, w);
      const float wy = (t.r0 == i ? t.ay : 0.f) + (t.r1 == i ? t.by : 0.f);
      const float wx = (t.c0 == j ? t.ax : 0.f) + (t.c1 == j ? t.bx : 0.f);
      if (wy == 0.f || wx == 0.f) continue;
      const long long p = (static_cast<long long>(b) * H + y) * W + x;
      const int tf = t_fine[p], tc = t_coarse[p];
      if (tf == kIgnore && tc == kIgnore) continue;
      float lf[CF], lc[CC];
      pixel_logits<CF, CC>(lo_b, plane, t, nf, nc, lf, lc);
      pixel_grad_acc<CF, CC>(lf, lc, pf, nf, nc, tf, tc, g_sf, g_sc, g_cef, g_cec, wy * wx,
                             af, ac);
    }
  }
  float* d_b = dlo + static_cast<long long>(b) * C * plane + static_cast<long long>(i) * w + j;
#pragma unroll
  for (int f = 0; f < CF; ++f)
    if (f < nf) d_b[f * plane] = af[f];
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c < nc) d_b[(nf + c) * plane] = ac[c];
}

template <int CF, int CC>
cudaError_t launch_fwd(const float* lo, const int* tf, const int* tc, const int* f2c,
                       float* partial, float* sums, int B, int C, int h, int w, int nf, int nc,
                       cudaStream_t s) {
  const dim3 grid(blocks_for(4LL * w, kFwdThreads), 4 * h, B);
  hiera2_fwd_kernel<CF, CC><<<grid, kFwdThreads, 0, s>>>(lo, tf, tc, f2c, partial, B, C, h, w,
                                                         nf, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long P = static_cast<long long>(grid.x) * grid.y * grid.z;
  hiera2_finish_kernel<<<1, 256, 0, s>>>(partial, sums, P);
  return cudaGetLastError();
}

template <int CF, int CC>
cudaError_t launch_bwd(const float* lo, const int* tf, const int* tc, const int* f2c,
                       const float* gsum, float* dlo, int B, int C, int h, int w, int nf, int nc,
                       cudaStream_t s) {
  const dim3 grid(blocks_for(w, kBwdThreads), h, B);
  hiera2_bwd_kernel<CF, CC><<<grid, kBwdThreads, 0, s>>>(lo, tf, tc, f2c, gsum, dlo, B, C, h,
                                                         w, nf, nc);
  return cudaGetLastError();
}

// compile-time class bounds, which cover the repo's 2-level configs
// (ops/hiera2_fused.py MAX_FINE, MAX_COARSE)
constexpr int kMaxFine = 16;
constexpr int kMaxCoarse = 8;
bool classes_ok(int nf, int nc, int C) {
  return nf >= 1 && nc >= 1 && nf <= kMaxFine && nc <= kMaxCoarse && nf + nc == C;
}

}  // namespace
}  // namespace seghiero

// lo: [B, C, h, w] f32 contiguous; t_fine, t_coarse: [B, 4h, 4w] int32
// contiguous; f2c: [nf] int32 (coarse id of each fine id); partial: f32
// scratch of B·4h·ceil(4w/256)·6 floats; sums: f32 [6] (s_f, s_c, nv_f,
// nv_c, ce_f, ce_c). Returns cudaGetLastError() (cudaErrorInvalidValue for
// class counts the kernel does not take).
extern "C" int seghiero_hiera2_fwd(const void* lo, const void* t_fine, const void* t_coarse,
                                   const void* f2c, void* partial, void* sums, int B, int C,
                                   int h, int w, int nf, int nc, int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!classes_ok(nf, nc, C)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || h == 0 || w == 0) return cudaMemsetAsync(sums, 0, 6 * sizeof(float), s);
  if (B > 65535 || 4 * h > 65535) return cudaErrorInvalidValue;  // grid y/z limits
  const auto* l = static_cast<const float*>(lo);
  const auto* tf = static_cast<const int*>(t_fine);
  const auto* tc = static_cast<const int*>(t_coarse);
  const auto* fc = static_cast<const int*>(f2c);
  auto* pp = static_cast<float*>(partial);
  auto* out = static_cast<float*>(sums);
  return launch_fwd<kMaxFine, kMaxCoarse>(l, tf, tc, fc, pp, out, B, C, h, w, nf, nc, s);
}

// lo, t_fine, t_coarse, f2c as above; gsum: f32 [6] cotangents of the six
// sums (entries 2 and 3 are not read); dlo: [B, C, h, w] f32, every entry
// written.
extern "C" int seghiero_hiera2_bwd(const void* lo, const void* t_fine, const void* t_coarse,
                                   const void* f2c, const void* gsum, void* dlo, int B, int C,
                                   int h, int w, int nf, int nc, int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!classes_ok(nf, nc, C)) return cudaErrorInvalidValue;
  if (B == 0 || h == 0 || w == 0) return cudaSuccess;
  if (B > 65535 || h > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lo);
  const auto* tf = static_cast<const int*>(t_fine);
  const auto* tc = static_cast<const int*>(t_coarse);
  const auto* fc = static_cast<const int*>(f2c);
  const auto* g = static_cast<const float*>(gsum);
  auto* d = static_cast<float*>(dlo);
  return launch_bwd<kMaxFine, kMaxCoarse>(l, tf, tc, fc, g, d, B, C, h, w, nf, nc, s);
}
