// Fused 4× bilinear upsample + 2-level hierarchy BCE + per-level CE:
// forward (six loss sums, #4) and backward (gradient onto the low-res
// logits, #5), for any 2-level hierarchy.
//
// Replaces: seghiero_tpu/ops/pallas/hiera2_fused.py — the forward
// `_core_fwd_impl` (the pl.pallas_call at :322, kernel body `_fwd_kernel`
// :105-169) and the backward `_core_bwd_rule` (the pl.pallas_call at :348,
// kernel body `_bwd_kernel` :177-271), reached from
// `FastHieraTripletLoss` (seghiero_tpu/losses/fast.py:462-479) with
// `training.pallas_fused_loss: true`. The TPU kernel is specialised on the
// hierarchy and has no class bound; neither have these.
//
// Inputs: C-major f32 logits lo [B, C, h, w] (C = nf fine + nc coarse),
// int32 labels t_fine and t_coarse [B, 4h, 4w] (255 = ignore), and a table
// of the hierarchy built by the wrapper (ops/hiera2_fused.py
// `hierarchy_table`):
//   goff[nc + 1]  start of coarse group g in the walk order;
//   walk[C]       the channels by group: coarse channel nf + g, then its
//                 fine children in id order (groups need not be contiguous);
//   bsched[2C]    each group's walk entries twice (the backward's passes).
// Per valid pixel (exactly the terms of `_fwd_kernel`):
//   s_f  += Σ_f [f = t_f] −log(σ(min(l_f, l_coarse(f))) + ε) + [f ≠ t_f] −log(1 − σ(l_f) + ε)
//   s_c  += Σ_c [c = t_c] −log(σ(l_c) + ε) + [c ≠ t_c] −log(1 − σ(max(l_c, l_f∈c)) + ε)
//   nv_f, nv_c += 1;  ce_f, ce_c += logsumexp − l[label]
// (ε = 1e-8; the TPU kernel evaluates the logs in logit space, these
// kernels in the closed forms below).
//
// Design: the per-pixel state is O(1) whatever the hierarchy, because a
// block walks the channels group by group. Every term splits by group but
// the two log-sum-exps: the fine positive min(l_t_f, l_parent) has both
// channels in t_f's group, the coarse negative is the group's maximum, the
// CE numerators are per channel. A block stages one channel at a time of
// its low-res tile (with a one-pixel halo, edge-clamped) in a 4-slot
// cp.async ring, three channels ahead, and every high-res pixel is rebuilt
// from its 4 taps in shared memory (the multiply-add order of
// upsample_argmax.cu, no FMA contraction: the plain version's bits).
//
// #4, forward: a block owns 2 low-res rows × 32 columns, one thread per
// high-res column and low-res row (4 pixels each, state in registers:
// running max and sum of each level's exponentials, the group's running
// maximum and its own coarse logit). Each block adds its six sums in a
// fixed shuffle tree and writes one partial row (seghiero_hiera2_fwd_partials
// sizes the scratch); a second one-block pass adds the partials in a fixed
// order in double. No float atomics: two runs give the same bits.
//
// #5, backward: a block owns 4 × 32 low-res outputs. It computes the
// gradient of every high-res pixel whose taps reach them — 20 × 132
// pixels, 1.29× the tile, each once — in three sweeps over the channels:
// (1) the two log-sum-exps; then per group (2) its maximum, the first
// channel holding it (own, then children in id order) and the logits of
// the own channel and of t_f; (3) per channel the pixels' gradients into a
// shared plane, a barrier, and each pair of threads gathers one output's
// 8 × 8 weighted terms from the plane in a fixed order. Per-pixel state
// (6 words with the plane, 65 KB a block: three blocks an SM) lives in
// shared memory. Deterministic, no atomics, no
// full-resolution scratch. Tie routing is the TPU kernel's: the fine
// positive goes wholly to the fine channel when l_f <= l_parent, the coarse
// negative to the group's first maximum; CE is softmax − one-hot, with the
// softmax as exp(l − logsumexp).
//
// What bounds them on an H100: transcendentals (MUFU), not bytes. Per valid
// pixel and level of n classes the forward evaluates 3·n + 1 + k (an exp
// and a log per BCE term and a second log for the k terms at x < 0; n exps
// and a log for the log-sum-exp) and the backward 5·n + 1 (n exps and a log
// for the log-sum-exp, an exp and two reciprocals per BCE derivative, an
// exp per softmax entry). Forms used: only the MUFU-direct __expf, __logf
// and __fdividef (ex2, lg2, rcp); the closed forms below keep each factor
// within 2e-6 relative of the library's expf / log1pf forms of PR 2's
// kernels.
//
// Numerics: the upsampled logits equal the plain version's bit for bit;
// the transcendental forms and the summation orders differ, so sums are
// compared within 1e-5 relative and the gradient within rtol 2e-4, atol
// 1e-7.

#include <math.h>

#include "common.cuh"

namespace seghiero {
namespace {

constexpr float kEps = 1e-8f;
constexpr int kIgnore = 255;
constexpr int kCols = 32;     // low-res columns a block owns (both kernels)
constexpr int kTileW = kCols + 2;
constexpr int kRing = 4;      // staged channels; loads run kRing − 1 ahead
// forward: 2 low-res rows a block, one thread per high-res column and row
constexpr int kFwdRows = 2;
constexpr int kFwdThreads = 4 * kCols * kFwdRows;
constexpr int kFwdTile = (kFwdRows + 2) * kTileW;
// backward: 4 × 32 low-res outputs a block, the 20 × 132 high-res pixels
// whose taps reach them
constexpr int kBwdRows = 4;
constexpr int kBwdThreads = 256;
constexpr int kBwdTile = (kBwdRows + 2) * kTileW;
constexpr int kRegH = 4 * kBwdRows + 4, kRegW = 4 * kCols + 4;
constexpr int kRegPx = kRegH * kRegW;
constexpr int kBwdStateWords = 6;  // per pixel, see hiera2_bwd_kernel
constexpr size_t kBwdSmem =
    sizeof(float) * (static_cast<size_t>(kBwdStateWords) * kRegPx + kRing * kBwdTile);
static_assert(kFwdThreads % 32 == 0 && kBwdThreads == 2 * kBwdRows * kCols, "geometry");

// The forward's BCE term −log(σ(x) + ε) from one exp and one or two logs
// (−log(1 − σ(m) + ε) is the term at x = −m): with e = exp(−|x|),
//   x ≥ 0:  log1p(e) − log1p(ε·(1 + e)) = log1p(e) − ε·(1 + e)
//   x < 0:  log1p(e) − log(e + ε·(1 + e))
// (ε·(1 + e) ≤ 2e-8, where log1p is the identity in f32), with log1p(e)
// as __logf(1 + e). Each term is within 5e-7 absolute or 2e-6 relative of
// the library forms, and every term is positive: the sums move by far less
// than their 1e-5.
__device__ __forceinline__ float neg_log_sig_eps(float x) {
  const float e = __expf(-fabsf(x));
  const float c = kEps * (1.f + e);
  return __logf(1.f + e) - (x >= 0.f ? c : __logf(e + c));
}
// The backward's derivatives from one exp and two reciprocals (MUFU ex2
// and rcp through __expf and __fdividef), no logarithm: with e = exp(−|m|)
// and r = 1/(1 + e), σ(m) and σ(−m) are r and e·r (in the order of m's
// sign), and
//   d/dm log(σ(m) + ε)      = σ(m)·σ(−m) / (σ(m) + ε)
//   d/dm −log(1 − σ(m) + ε) = σ(m)·σ(−m) / (σ(−m) + ε)
// (the TPU kernel's wu·σ(−m) and wu2·σ(m), in closed form).
__device__ __forceinline__ void sig_pair(float m, float& sp, float& sn) {
  const float e = __expf(-fabsf(m));
  const float r = __fdividef(1.f, 1.f + e);
  sp = m >= 0.f ? r : e * r;
  sn = m >= 0.f ? e * r : r;
}
__device__ __forceinline__ float dlog_sig_eps(float m) {
  float sp, sn;
  sig_pair(m, sp, sn);
  return __fdividef(sp * sn, sp + kEps);
}
__device__ __forceinline__ float dneg_log1m_sig_eps(float m) {
  float sp, sn;
  sig_pair(m, sp, sn);
  return __fdividef(sp * sn, sn + kEps);
}

// running log-sum-exp: max m and Σ exp(x − m), one exp per element
__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  const float d = x - m;
  const float e = __expf(-fabsf(d));
  if (d > 0.f) {
    s = s * e + 1.f;
    m = x;
  } else {
    s += e;
  }
}

__device__ __forceinline__ float lerp2(float a, float b, float t0, float t1) {
  return __fadd_rn(__fmul_rn(a, t0), __fmul_rn(b, t1));
}

// Stage channel `ch` of the (rows + 2) × kTileW low-res tile whose top-left
// is (i0 − 1, j0 − 1), edge-clamped, into `slot`; every thread commits one
// cp.async group per call (empty past the schedule's end).
template <int TileElems, int Threads>
__device__ __forceinline__ void stage(float* slot, const float* __restrict__ lo_b, int ch,
                                      bool live, int i0, int j0, int h, int w) {
  if (live) {
    const float* plane = lo_b + static_cast<long long>(ch) * h * w;
    for (int e = threadIdx.x; e < TileElems; e += Threads) {
      const int r = min(max(i0 - 1 + e / kTileW, 0), h - 1);
      const int c = min(max(j0 - 1 + e % kTileW, 0), w - 1);
      copy_async_or_zero<4>(slot + e, plane + static_cast<long long>(r) * w + c, true);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kFwdThreads) hiera2_fwd_kernel(
    const float* __restrict__ lo, const int* __restrict__ t_fine,
    const int* __restrict__ t_coarse, const int* __restrict__ tab,
    float* __restrict__ partial, int C, int h, int w, int nf, int nc) {
  __shared__ __align__(16) float ring[kRing][kFwdTile];
  __shared__ float warp_sums[kFwdThreads / 32][6];
  const int* walk = tab + nc + 1;
  const int j0 = blockIdx.x * kCols, i0 = blockIdx.y * kFwdRows, b = blockIdx.z;
  const int H = 4 * h, W = 4 * w;
  const int xl = threadIdx.x % (4 * kCols), li = threadIdx.x / (4 * kCols);
  const int x = 4 * j0 + xl, i = i0 + li;
  const bool active = x < W && i < h;
  const float* lo_b = lo + static_cast<long long>(b) * C * h * w;

  // column taps (tile columns ct, ct + 1) and the four rows' phases
  int co;
  float ax, bx;
  upsample4_phase(x & 3, co, ax, bx);
  const int ct = (xl >> 2) + co;
  int tf[4], tc[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    tf[p] = tc[p] = kIgnore;
    if (active) {
      const long long q = (static_cast<long long>(b) * H + 4 * i + p) * W + x;
      tf[p] = t_fine[q];
      tc[p] = t_coarse[q];
    }
  }
  float mf[4], sf[4], mc[4], sc[4], gm[4], lown[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    mf[p] = mc[p] = -INFINITY;
    sf[p] = sc[p] = 0.f;
    gm[p] = lown[p] = 0.f;
  }
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // the coarse terms of group g, once its maximum is known
  auto close_group = [&](int grp) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (tc[p] == kIgnore) continue;
      s[1] += neg_log_sig_eps(tc[p] == grp ? lown[p] : -gm[p]);
    }
  };

  for (int k = 0; k < kRing - 1; ++k)
    stage<kFwdTile, kFwdThreads>(ring[k], lo_b, k < C ? walk[k] : 0, k < C, i0, j0, h, w);
  int g = -1;
  for (int q = 0; q < C; ++q) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const int nxt = q + kRing - 1;
    stage<kFwdTile, kFwdThreads>(ring[nxt % kRing], lo_b, nxt < C ? walk[nxt] : 0, nxt < C, i0,
                                 j0, h, w);
    const int ch = walk[q];
    const bool coarse = ch >= nf;
    if (coarse) {
      if (g >= 0 && active) close_group(g);
      g = ch - nf;
    }
    if (!active) continue;
    const float* T = ring[q % kRing];
    float u[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* row = T + (li + r) * kTileW + ct;
      u[r] = lerp2(row[0], row[1], ax, bx);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      int ro;
      float ay, by;
      upsample4_phase(p, ro, ay, by);
      const float l = lerp2(u[ro], u[ro + 1], ay, by);
      if (coarse) {
        gm[p] = l;
        lown[p] = l;
        if (tc[p] != kIgnore) {
          lse_add(mc[p], sc[p], l);
          if (tc[p] == g) s[5] -= l;
        }
      } else {
        if (tf[p] != kIgnore) {
          s[0] += neg_log_sig_eps(ch == tf[p] ? fminf(l, lown[p]) : -l);
          lse_add(mf[p], sf[p], l);
          if (ch == tf[p]) s[4] -= l;
        }
        gm[p] = fmaxf(gm[p], l);
      }
    }
  }
  cp_async_wait<0>();
  if (active) {
    close_group(g);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (tf[p] != kIgnore) {
        s[2] += 1.f;
        s[4] += __logf(sf[p]) + mf[p];
      }
      if (tc[p] != kIgnore) {
        s[3] += 1.f;
        s[5] += __logf(sc[p]) + mc[p];
      }
    }
  }

  // fixed-order block sum: shuffle tree inside each warp, then warps in order
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

// upsample4_phase's weight of the first tap, by selects (a switch on a
// phase known only at run time compiles to branches); the second is 1 − a,
// exactly
__device__ __forceinline__ float phase_a(int p) {
  const float odd = (p & 2) ? 0.625f : 0.125f;
  const float even = (p & 2) ? 0.875f : 0.375f;
  return (p & 1) ? odd : even;
}

// A region pixel's blend: tile offset of its top-left tap (bits 0-7) and
// its row and column phases (bits 8-9, 10-11).
constexpr unsigned kBlendBits = 0xfff, kTfUp = 1u << 12;
constexpr unsigned kBothIgnored = kIgnore | kIgnore << 16;
static_assert((kBwdRows + 2) * kTileW <= 256, "tile offsets take 8 bits");
__device__ __forceinline__ float blend_px(const float* T, unsigned desc) {
  const int o = desc & 0xff;
  const float ay = phase_a((desc >> 8) & 3), ax = phase_a((desc >> 10) & 3);
  const float by = 1.f - ay, bx = 1.f - ax;
  return lerp2(lerp2(T[o], T[o + 1], ax, bx), lerp2(T[o + kTileW], T[o + kTileW + 1], ax, bx),
               ay, by);
}

// weight of high-res row (or column) y on low-res row i (edge clamp of the
// taps included; 0 for a y outside the image)
__device__ __forceinline__ float tap_weight(int y, int i, int h) {
  if (y < 0 || y >= 4 * h) return 0.f;
  const int ro = (y & 3) >> 1;
  const float a = phase_a(y & 3);
  const int r0 = min(max((y >> 2) + ro - 1, 0), h - 1);
  const int r1 = min(max((y >> 2) + ro, 0), h - 1);
  return (r0 == i ? a : 0.f) + (r1 == i ? 1.f - a : 0.f);
}

__global__ void __launch_bounds__(kBwdThreads, 3) hiera2_bwd_kernel(
    const float* __restrict__ lo, const int* __restrict__ t_fine,
    const int* __restrict__ t_coarse, const int* __restrict__ tab,
    const float* __restrict__ gsum, float* __restrict__ dlo, int C, int h, int w, int nf,
    int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [kRing][kBwdTile]
  // per region pixel (kRegPx each):
  //   plane   this channel's gradient; during sweep 1 the coarse running
  //           sum, during a group's pass (2) its own coarse logit
  //   s_lsef, s_lsec  the log-sum-exps (during sweep 1: running maxima)
  //   s_gm    the group's running maximum (during sweep 1: the fine sum)
  //   s_lab   t_fine | t_coarse << 16
  //   s_px    blend descriptor (bits 0-11, see blend_px), kTfUp (bit 12:
  //           l_{t_f} > the own coarse logit, t_f in this group) and the
  //           group's first maximum + 1 (bits 16-31; 0: the own channel)
  float* plane = ring + kRing * kBwdTile;
  float* s_lsef = plane + kRegPx;
  float* s_lsec = s_lsef + kRegPx;
  float* s_gm = s_lsec + kRegPx;
  unsigned* s_lab = reinterpret_cast<unsigned*>(s_gm + kRegPx);
  unsigned* s_px = s_lab + kRegPx;

  const int* goff = tab;
  const int* walk = tab + nc + 1;
  const int* bsched = walk + C;
  const int j0 = blockIdx.x * kCols, i0 = blockIdx.y * kBwdRows, b = blockIdx.z;
  const int H = 4 * h, W = 4 * w;
  const float* lo_b = lo + static_cast<long long>(b) * C * h * w;
  const float g_sf = gsum[0], g_sc = gsum[1], g_cef = gsum[4], g_cec = gsum[5];

  // region pixel p = yl·kRegW + xl is high-res (4·i0 − 2 + yl, 4·j0 − 2 + xl)
  for (int p = threadIdx.x; p < kRegPx; p += kBwdThreads) {
    const int yl = p / kRegW, xl = p % kRegW;
    const int y = 4 * i0 - 2 + yl, x = 4 * j0 - 2 + xl;
    int tf = kIgnore, tc = kIgnore;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const long long q = (static_cast<long long>(b) * H + y) * W + x;
      tf = t_fine[q];
      tc = t_coarse[q];
    }
    const int py = (yl + 2) & 3, px = (xl + 2) & 3;
    const int rt = ((yl + 2) >> 2) - 1 + (py >= 2), cl = ((xl + 2) >> 2) - 1 + (px >= 2);
    s_px[p] = (rt * kTileW + cl) | (py << 8) | (px << 10);
    s_lab[p] = static_cast<unsigned>(tf) | static_cast<unsigned>(tc) << 16;
    s_lsef[p] = s_lsec[p] = -INFINITY;
    s_gm[p] = plane[p] = 0.f;
  }
  // this thread's output (i0 + oi, j0 + oj), rows 4·half … 4·half + 3 of
  // its 8 × 8 terms
  const int oi = (threadIdx.x >> 1) / kCols, oj = (threadIdx.x >> 1) % kCols;
  const int half = threadIdx.x & 1;
  float wy[4], wx[8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    wy[r] = tap_weight(4 * (i0 + oi) - 2 + 4 * half + r, i0 + oi, h);
#pragma unroll
  for (int c = 0; c < 8; ++c) wx[c] = tap_weight(4 * (j0 + oj) - 2 + c, j0 + oj, w);
  const bool writes = half == 0 && i0 + oi < h && j0 + oj < w;
  const int obase = (4 * oi + 4 * half) * kRegW + 4 * oj;

  // the channel schedule: sweep 1 over walk, then each group twice
  const int steps = 3 * C;
  auto chan = [&](int k) { return k < C ? walk[k] : bsched[k - C]; };
  for (int k = 0; k < kRing - 1; ++k)
    stage<kBwdTile, kBwdThreads>(ring + k * kBwdTile, lo_b, k < steps ? chan(k) : 0, k < steps,
                                 i0, j0, h, w);
  int k = 0;
  auto next = [&]() -> const float* {  // wait for step k's channel, stage k + 3
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const int n = k + kRing - 1;
    stage<kBwdTile, kBwdThreads>(ring + (n % kRing) * kBwdTile, lo_b, n < steps ? chan(n) : 0,
                                 n < steps, i0, j0, h, w);
    return ring + (k++ % kRing) * kBwdTile;
  };

  // (1) the log-sum-exp of each level
  for (int q = 0; q < C; ++q) {
    const float* T = next();
    const bool coarse = walk[q] >= nf;
    for (int p = threadIdx.x; p < kRegPx; p += kBwdThreads) {
      const unsigned lab = s_lab[p];
      if ((coarse ? lab >> 16 : lab & 0xffff) == kIgnore) continue;
      const float l = blend_px(T, s_px[p]);
      if (coarse) lse_add(s_lsec[p], plane[p], l);
      else lse_add(s_lsef[p], s_gm[p], l);
    }
  }
  for (int p = threadIdx.x; p < kRegPx; p += kBwdThreads) {
    const unsigned lab = s_lab[p];
    if ((lab & 0xffff) != kIgnore) s_lsef[p] += __logf(s_gm[p]);
    if ((lab >> 16) != kIgnore) s_lsec[p] += __logf(plane[p]);
  }

  float* d_b = dlo + static_cast<long long>(b) * C * h * w;
  for (int g = 0; g < nc; ++g) {
    const int q0 = goff[g], q1 = goff[g + 1];
    // (2) the group's maximum, the first channel holding it, and whether
    // the fine positive min(l_{t_f}, l_own) is the own channel's
    for (int q = q0; q < q1; ++q) {
      const float* T = next();
      const int ch = walk[q];
      for (int p = threadIdx.x; p < kRegPx; p += kBwdThreads) {
        const unsigned lab = s_lab[p];
        if (lab == kBothIgnored) continue;
        const unsigned pd = s_px[p];
        const float l = blend_px(T, pd);
        if (q == q0) {
          s_gm[p] = l;
          plane[p] = l;
          s_px[p] = pd & kBlendBits;
        } else {
          unsigned nd = pd;
          if (l > s_gm[p]) {
            s_gm[p] = l;
            nd = (nd & 0xffff) | static_cast<unsigned>(ch + 1) << 16;
          }
          if (ch == static_cast<int>(lab & 0xffff) && l > plane[p]) nd |= kTfUp;
          if (nd != pd) s_px[p] = nd;
        }
      }
    }
    // (3) each channel's gradient: the pixels once, then the gather
    for (int q = q0; q < q1; ++q) {
      const float* T = next();
      const int ch = walk[q];
      for (int p = threadIdx.x; p < kRegPx; p += kBwdThreads) {
        const unsigned lab = s_lab[p];
        const int tf = lab & 0xffff, tc = lab >> 16;
        float d = 0.f;
        if (lab != kBothIgnored) {
          const unsigned pd = s_px[p];
          const float l = blend_px(T, pd);
          const int win = static_cast<int>(pd >> 16) - 1;  // −1: the own channel
          if (q == q0) {  // the own coarse channel
            if (tc != kIgnore) {
              if (tc == g) d += -dlog_sig_eps(l) * g_sc;
              else if (win < 0) d += dneg_log1m_sig_eps(s_gm[p]) * g_sc;
              d += (__expf(l - s_lsec[p]) - (tc == g ? 1.f : 0.f)) * g_cec;
            }
            // the fine positive min(l_t_f, l) taken by the parent
            if (tf != kIgnore && (pd & kTfUp)) d += -dlog_sig_eps(l) * g_sf;
          } else {
            if (tf != kIgnore) {
              if (ch != tf) d += dneg_log1m_sig_eps(l) * g_sf;
              else if (!(pd & kTfUp)) d += -dlog_sig_eps(l) * g_sf;
              d += (__expf(l - s_lsef[p]) - (ch == tf ? 1.f : 0.f)) * g_cef;
            }
            if (tc != kIgnore && tc != g && win == ch) d += dneg_log1m_sig_eps(s_gm[p]) * g_sc;
          }
        }
        plane[p] = d;
      }
      __syncthreads();
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* row = plane + obase + r * kRegW;
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) v += wx[c] * row[c];
        acc += wy[r] * v;
      }
      const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
      if (writes)
        d_b[(static_cast<long long>(ch) * h + i0 + oi) * w + j0 + oj] = acc + other;
    }
  }
  cp_async_wait<0>();
}

long long fwd_partials(int B, int h, int w) {
  return static_cast<long long>(B) * ((h + kFwdRows - 1) / kFwdRows) * ((w + kCols - 1) / kCols);
}

// the backward packs a channel id + 1 and the labels into 16 bits
constexpr int kMaxChannels = 0xffff;
bool classes_ok(int nf, int nc, int C) {
  return nf >= 1 && nc >= 1 && nf + nc == C && C <= kMaxChannels;
}

}  // namespace
}  // namespace seghiero

// Rows of seghiero_hiera2_fwd's partial-sum scratch ([P, 6] f32) for
// logits of B × h × w; −1 past the int range.
extern "C" int seghiero_hiera2_fwd_partials(int B, int h, int w) {
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  const long long P = seghiero::fwd_partials(B, h, w);
  return P > 0x7fffffff ? -1 : static_cast<int>(P);
}

// lo: [B, C, h, w] f32 contiguous; t_fine, t_coarse: [B, 4h, 4w] int32
// contiguous; tab: the hierarchy table of the header (int32, on the card);
// partial: [P, 6] f32 scratch, P = seghiero_hiera2_fwd_partials(B, h, w);
// sums: f32 [6] (s_f, s_c, nv_f, nv_c, ce_f, ce_c). Returns
// cudaGetLastError() (cudaErrorInvalidValue for class counts that do not
// add up to C, a P that does not match the shape, or a shape past the
// grid's limits).
extern "C" int seghiero_hiera2_fwd(const void* lo, const void* t_fine, const void* t_coarse,
                                   const void* tab, void* partial, void* sums, int B, int C,
                                   int h, int w, int nf, int nc, int P, int device,
                                   void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!classes_ok(nf, nc, C)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || h == 0 || w == 0) return cudaMemsetAsync(sums, 0, 6 * sizeof(float), s);
  if (static_cast<long long>(P) != fwd_partials(B, h, w) || B > 65535 ||
      (h + kFwdRows - 1) / kFwdRows > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((w + kCols - 1) / kCols, (h + kFwdRows - 1) / kFwdRows, B);
  hiera2_fwd_kernel<<<grid, kFwdThreads, 0, s>>>(
      static_cast<const float*>(lo), static_cast<const int*>(t_fine),
      static_cast<const int*>(t_coarse), static_cast<const int*>(tab),
      static_cast<float*>(partial), C, h, w, nf, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hiera2_finish_kernel<<<1, 256, 0, s>>>(static_cast<const float*>(partial),
                                         static_cast<float*>(sums), P);
  return cudaGetLastError();
}

// lo, t_fine, t_coarse, tab as above; gsum: f32 [6] cotangents of the six
// sums (entries 2 and 3 are not read); dlo: [B, C, h, w] f32, every entry
// written.
extern "C" int seghiero_hiera2_bwd(const void* lo, const void* t_fine, const void* t_coarse,
                                   const void* tab, const void* gsum, void* dlo, int B, int C,
                                   int h, int w, int nf, int nc, int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!classes_ok(nf, nc, C)) return cudaErrorInvalidValue;
  if (B == 0 || h == 0 || w == 0) return cudaSuccess;
  if (B > 65535 || (h + kBwdRows - 1) / kBwdRows > 65535) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(hiera2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kCols - 1) / kCols, (h + kBwdRows - 1) / kBwdRows, B);
  hiera2_bwd_kernel<<<grid, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const int*>(t_fine),
      static_cast<const int*>(t_coarse), static_cast<const int*>(tab),
      static_cast<const float*>(gsum), static_cast<float*>(dlo), C, h, w, nf, nc);
  return cudaGetLastError();
}
