// Spatial-reduction attention of MiT's blocks (kernels #10 and #10b):
// softmax(q·kᵀ/√d)·v for bf16 q [B, h, N, d] against the spatially reduced
// k, v [B, h, M, d], d ∈ {32, 64}, forward and backward.
//
// It replaces no pallas_call: the JAX package's EfficientAttention
// (seghiero_tpu/models/mit.py) is two einsums and a softmax that XLA fuses.
// The port's library route, SDPA's flash kernels, runs its backward as one
// block per 128 keys per head: MiT has M = 1 024 keys at every stage of a
// 1024² image and B·h = 1, 2, 5, 8, so that backward fills 8–64 of the
// card's 132 SMs and walks up to 512 query tiles in series.
//
// Bound: the tensor cores (2·N·M·d flops a product, 2 products forward, 4
// backward, at 989 TFLOP/s), far above the bytes (each operand read once).
// Design, flash-attention style on Hopper's warpgroup products (wgmma: a
// block's 4 warps multiply 64 rows held in registers by a tile read from
// shared memory, f32 sums), bf16 operands, tiles of 64 rows of d in
// swizzled shared memory, filled by cp.async double buffering:
//
//  * forward, one block per 64 queries and b·h, or per 128 (two
//    warpgroups sharing each k and v tile) where that leaves the busiest SM
//    no more work (ops/attention.py forward_rows): streams k and v in
//    blocks of 64 keys with the softmax's running max and sum in f32 (base
//    2), rounds P to bf16 for P·v, and writes o (bf16) and the row
//    log-sum-exp L = ln Σ exp(s·scale) (f32, [B·h, N]);
//  * backward, three launches on the stream, no atomics, same bits every run:
//    - dq: one block per 64 queries and b·h: it first takes D = rowsum(dO ∘
//      o) of its rows (written for the next launch), then streams k and v,
//      recomputing P = exp(s·scale − L), dP = dO·vᵀ, dS = P ∘ (dP − D),
//      and sums dS·k in registers;
//    - dk/dv: one block per 64 keys, b·h and query split: the grid is
//      (M/64) × B·h × splits, the splits chosen from the shape
//      (ops/attention.py backward_splits) so that it fills the card; each
//      block keeps its keys' dK and dV in f32 registers over its range of
//      query tiles (recomputing Pᵀ, dPᵀ, dSᵀ) and writes them to a
//      workspace [2, splits, B·h, M, d];
//    - sum: adds the splits in order from split 0, casts dk and dv to bf16.
//  The dq launch recomputes the scores and dP that the dk/dv launch also
//  computes (7 products in all, against flash's 5) in exchange for no dq
//  atomics and no shared-memory round trip of dS.
//
// Every kernel's name holds "flash_fwd" or "flash_bwd": the benchmark's
// attention roofline sums their device time under those names.

#include <cmath>

#include "common.cuh"

namespace seghiero {
namespace {

using bf16 = __nv_bfloat16;

// rows of a warpgroup (4 warps of 16), and of a streamed tile
constexpr int kTile = 64;
constexpr float kLog2e = 1.4426950408889634f;

// one bf16 operand [B, h, rows, d]: element strides of batch, head and row
// (the last dimension is contiguous)
struct View {
  bf16* p;
  long long sb, sh, sn;
  __device__ __forceinline__ bf16* at(int b, int h) const { return p + b * sb + h * sh; }
};

struct Params {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;    // [B·h, N]
  float* delta;  // [B·h, N]
  float* ws;     // [2, splits, B·h, M, d]
  int heads, N, M, splits;
  float scale, scale_log2;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Hopper's warpgroup product: the 4 warps of a block (128 threads) together
// multiply a 64-row A, 16 rows a warp held in registers in mma.sync's A
// layout, by B read from shared memory through a descriptor, into f32 sums
// in mma.sync's C layout (warp w: rows 16·w + g and 16·w + g + 8, columns
// 8·j + 2·t, + 1 of column tile j). B tiles are rows of D bf16 (128 or 64
// bytes) with the 128- or 64-byte swizzle: 16-byte chunk c of row r lives at
// chunk c ^ swizzle_row(r). K-major B (TRANS_B = 0): the rows are B's
// columns (S = q·kᵀ); MN-major (TRANS_B = 1): the rows are B's rows (P·v).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&c)[8][4], const unsigned (&a)[4],
                                          unsigned long long desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&c)[4][4], const unsigned (&a)[4],
                                          unsigned long long desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// the products in flight done and their sums in registers; the empty asm on
// each sum keeps the compiler from reading it before the wait
template <int N>
__device__ __forceinline__ void wgmma_done(float (&c)[N][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}

// the swizzle of a tile of D-element rows: 128 bytes (d = 64) or 64 (d = 32)
template <int D>
__device__ __forceinline__ int swizzle_row(int r) {
  return D == 64 ? (r & 7) : ((r >> 1) & 3);
}

// the descriptor of a swizzled tile of D-element rows at p: 8-row groups
// 8·2·D bytes apart, the 128-byte (d = 64) or 64-byte (d = 32) swizzle
template <int D>
__device__ __forceinline__ unsigned long long tile_desc(const bf16* p) {
  const unsigned long long addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  constexpr unsigned long long kGroup = 8 * 2 * D / 16, kLayout = D == 64 ? 1 : 2;
  return ((addr >> 4) & 0x3FFF) | (1ull << 16) | (kGroup << 32) | (kLayout << 62);
}

// A fragments (m16n8k16, row-major) of rows [r0, r0 + 16) of a bf16 operand,
// straight from global memory; rows at or past `rows` read as zero
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4], const bf16* base, long long sn,
                                       int r0, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool v0 = r0 + g < rows, v1 = r0 + g + 8 < rows;
  const bf16* p0 = base + static_cast<long long>(r0 + g) * sn + 2 * t;
  const bf16* p1 = p0 + 8 * sn;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = v0 ? *reinterpret_cast<const unsigned*>(p0 + 16 * kk) : 0u;
    a[kk][1] = v1 ? *reinterpret_cast<const unsigned*>(p1 + 16 * kk) : 0u;
    a[kk][2] = v0 ? *reinterpret_cast<const unsigned*>(p0 + 16 * kk + 8) : 0u;
    a[kk][3] = v1 ? *reinterpret_cast<const unsigned*>(p1 + 16 * kk + 8) : 0u;
  }
}

// rows [r0, r0 + 64) of a bf16 operand into a swizzled shared-memory tile,
// 16 bytes a cp.async; rows at or past `rows` are zeros
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base, long long sn, int r0,
                                          int rows, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kTile * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < rows;
    const bf16* src = valid ? base + static_cast<long long>(r0 + r) * sn + c * 8 : base;
    copy_async_or_zero<16>(s + r * D + (c ^ swizzle_row<D>(r)) * 8, src, valid);
  }
}

// the landed cp.async tiles, visible to the block's warpgroup products
__device__ __forceinline__ void tiles_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// c[64 × 64] += a[64 × D] · sᵀ, s a tile of 64 rows of D (S = q·kᵀ,
// dP = dO·vᵀ, Sᵀ = k·qᵀ, dPᵀ = v·dOᵀ): D/16 products, B K-major, waited for
template <int D>
__device__ __forceinline__ void times_rows_t(float (&c)[8][4], const unsigned (&a)[D / 16][4],
                                             const bf16* s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_n64<0>(c, a[kk], tile_desc<D>(s + 16 * kk));
  wgmma_done(c);
}

// c[64 × D] += p[64 × 64] · s, s a tile of 64 rows of D (o += P·v,
// dq += dS·k, dv += Pᵀ·dO, dk += dSᵀ·q): 4 products of 16 rows, B MN-major,
// waited for
template <int D>
__device__ __forceinline__ void times_rows(float (&c)[D / 8][4], const unsigned (&p)[4][4],
                                           const bf16* s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      wgmma_n64<1>(c, p[kk], tile_desc<D>(s + 16 * kk * D));
    else
      wgmma_n32<1>(c, p[kk], tile_desc<D>(s + 16 * kk * D));
  }
  wgmma_done(c);
}

// a 16 × 64 block of f32 sums (C fragments) as bf16 A fragments
__device__ __forceinline__ void to_a(unsigned (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// rows r0 + g and r0 + g + 8 of a 16 × D block of sums, row g times mul[0]
// and row g + 8 times mul[1], as bf16
template <int D>
__device__ __forceinline__ void store_rows(const View& out, int b, int h, int r0, int rows,
                                           const float (&c)[D / 8][4], const float (&mul)[2],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  bf16* base = out.at(b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= rows) continue;
    bf16* row = base + static_cast<long long>(r) * out.sn + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<unsigned*>(row + dt * 8) =
          pack_bf16(c[dt][2 * half] * mul[half], c[dt][2 * half + 1] * mul[half]);
  }
}

// one row tile's online softmax over the key block at kbase: keys past M
// masked; the running max m (units of log2: score · scale · log2 e) and the
// thread's partial row sums l updated, acc rescaled, s turned into P
template <int D>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[D / 8][4],
                                               float (&m)[2], float (&l)[2], int kbase, int M,
                                               float scale_log2, int t) {
  if (kbase + kTile > M) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kbase + nt * 8 + 2 * t + (e & 1) >= M) s[nt][e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]) * scale_log2);
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]) * scale_log2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float corr = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][2 * r] *= corr;
      acc[dt][2 * r + 1] *= corr;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = fast_exp2(fmaf(s[nt][e], scale_log2, -m[e >> 1]));
      l[e >> 1] += s[nt][e];
    }
  }
}

// one block per 64·WG queries and b·h, WG warpgroups; warp w takes rows
// 16·w … 16·w + 15, and the warpgroups share the streamed k and v tiles
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG) seghiero_sr_flash_fwd_kernel(Params a) {
  __shared__ __align__(1024) bf16 sk[2][kTile * D];
  __shared__ __align__(1024) bf16 sv[2][kTile * D];
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kTile * WG + (tid >> 5) * 16;
  const bf16* kb = a.k.at(b, h);
  const bf16* vb = a.v.at(b, h);
  const int nkb = (a.M + kTile - 1) / kTile;

  load_tile<D, 128 * WG>(sk[0], kb, a.k.sn, 0, a.M, tid);
  load_tile<D, 128 * WG>(sv[0], vb, a.v.sn, 0, a.M, tid);
  cp_async_commit();
  unsigned qa[D / 16][4];
  load_a<D>(qa, a.q.at(b, h), a.q.sn, q0, a.N, lane);
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // block j's k and v live in sk[j & 1] and sv[j & 1]; block j + 1's load
  // while block j is computed
  for (int j = 0; j < nkb; ++j) {
    if (j + 1 < nkb) {
      load_tile<D, 128 * WG>(sk[(j + 1) & 1], kb, a.k.sn, (j + 1) * kTile, a.M, tid);
      load_tile<D, 128 * WG>(sv[(j + 1) & 1], vb, a.v.sn, (j + 1) * kTile, a.M, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tiles_ready();
    float s[8][4] = {};
    times_rows_t<D>(s, qa, sk[j & 1]);
    online_softmax<D>(s, acc, m, l, j * kTile, a.M, a.scale_log2, t);
    unsigned pa[4][4];
    to_a(pa, s);
    times_rows<D>(acc, pa, sv[j & 1]);
    __syncthreads();  // block j's slots are free for block j + 2
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = q0 + g + 8 * r;
    if (t == 0 && row < a.N)
      a.lse[static_cast<long long>(bh) * a.N + row] = (m[r] + log2f(l[r])) / kLog2e;
  }
  store_rows<D>(a.o, b, h, q0, a.N, acc, inv, lane);
}

// dS = P ∘ (dP − D) of one 16 × 64 block, P = exp(s·scale − L), keys past M
// zero; lr: the rows' L in units of log2, dr: their D
__device__ __forceinline__ void scores_to_ds(float (&s)[8][4], const float (&dp)[8][4],
                                             const float (&lr)[2], const float (&dr)[2],
                                             int kbase, int M, float scale_log2, int t) {
  const bool ragged = kbase + kTile > M;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(s[nt][e], scale_log2, -lr[e >> 1]));
      if (ragged && kbase + nt * 8 + 2 * t + (e & 1) >= M) p = 0.f;
      s[nt][e] = p * (dp[nt][e] - dr[e >> 1]);
    }
  }
}

// one block per 64 queries and b·h, warp w taking rows 16·w … 16·w + 15
template <int D>
__global__ void __launch_bounds__(128) seghiero_sr_flash_bwd_dq_kernel(Params a) {
  __shared__ __align__(1024) bf16 sk[2][kTile * D];
  __shared__ __align__(1024) bf16 sv[2][kTile * D];
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kTile + (tid >> 5) * 16;
  const bf16* kb = a.k.at(b, h);
  const bf16* vb = a.v.at(b, h);
  const int nkb = (a.M + kTile - 1) / kTile;

  load_tile<D, 128>(sk[0], kb, a.k.sn, 0, a.M, tid);
  load_tile<D, 128>(sv[0], vb, a.v.sn, 0, a.M, tid);
  cp_async_commit();
  unsigned qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, a.q.at(b, h), a.q.sn, q0, a.N, lane);
  load_a<D>(da, a.dout.at(b, h), a.dout.sn, q0, a.N, lane);

  // D = rowsum(dO ∘ o) of the warp's 16 rows: two lanes a row, d/2 each
  float dr[2], lr[2];
  {
    const int r = q0 + (lane >> 1);
    float d = 0.f;
    if (r < a.N) {
      const bf16* po = a.o.at(b, h) + static_cast<long long>(r) * a.o.sn + (lane & 1) * (D / 2);
      const bf16* pd =
          a.dout.at(b, h) + static_cast<long long>(r) * a.dout.sn + (lane & 1) * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const Pack<bf16, 8> x = *reinterpret_cast<const Pack<bf16, 8>*>(po + 8 * i);
        const Pack<bf16, 8> y = *reinterpret_cast<const Pack<bf16, 8>*>(pd + 8 * i);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(to_f32(x.v[e]), to_f32(y.v[e]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((lane & 1) == 0 && r < a.N) a.delta[static_cast<long long>(bh) * a.N + r] = d;
    dr[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    dr[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + g + 8 * i;
      lr[i] = row < a.N ? a.lse[static_cast<long long>(bh) * a.N + row] * kLog2e : 0.f;
    }
  }

  float dq[D / 8][4] = {};
  for (int j = 0; j < nkb; ++j) {
    if (j + 1 < nkb) {
      load_tile<D, 128>(sk[(j + 1) & 1], kb, a.k.sn, (j + 1) * kTile, a.M, tid);
      load_tile<D, 128>(sv[(j + 1) & 1], vb, a.v.sn, (j + 1) * kTile, a.M, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tiles_ready();
    float s[8][4] = {}, dp[8][4] = {};
    times_rows_t<D>(s, qa, sk[j & 1]);
    times_rows_t<D>(dp, da, sv[j & 1]);
    scores_to_ds(s, dp, lr, dr, j * kTile, a.M, a.scale_log2, t);
    unsigned dsa[4][4];
    to_a(dsa, s);
    times_rows<D>(dq, dsa, sk[j & 1]);
    __syncthreads();
  }
  const float mul[2] = {a.scale, a.scale};
  store_rows<D>(a.dq, b, h, q0, a.N, dq, mul, lane);
}

// the query tiles [lo, hi) of split `split` of `splits`
__device__ __forceinline__ void split_range(int tiles, int split, int splits, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(split) * tiles / splits);
  hi = static_cast<int>(static_cast<long long>(split + 1) * tiles / splits);
}

template <int D>
__device__ __forceinline__ void load_query_tile(const Params& a, bf16* sq, bf16* sdo, float* sl,
                                                float* sd, int b, int h, int bh, int tile,
                                                int tid) {
  const int r0 = tile * kTile;
  load_tile<D, 128>(sq, a.q.at(b, h), a.q.sn, r0, a.N, tid);
  load_tile<D, 128>(sdo, a.dout.at(b, h), a.dout.sn, r0, a.N, tid);
  // L and D of the tile's rows (threads 0–63 and 64–127), zeros past N
  // (there q and dO are zeros, so P = 1 and dS = 0: nothing reaches dk or dv)
  const int r = tid & (kTile - 1);
  const bool valid = r0 + r < a.N;
  const float* src = (tid < kTile ? a.lse : a.delta) + static_cast<long long>(bh) * a.N +
                     (valid ? r0 + r : 0);
  copy_async_or_zero<4>((tid < kTile ? sl : sd) + r, src, valid);
}

// one block per 64 keys, b·h and query split, warp w taking keys
// 16·w … 16·w + 15
template <int D>
__global__ void __launch_bounds__(128) seghiero_sr_flash_bwd_dkdv_kernel(Params a) {
  __shared__ __align__(1024) bf16 sq[2][kTile * D];
  __shared__ __align__(1024) bf16 sdo[2][kTile * D];
  __shared__ float sl[2][kTile], sd[2][kTile];
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads, split = blockIdx.z;
  const int k0 = blockIdx.x * kTile + (tid >> 5) * 16;
  int lo, hi;
  split_range((a.N + kTile - 1) / kTile, split, a.splits, lo, hi);

  if (lo < hi) load_query_tile<D>(a, sq[0], sdo[0], sl[0], sd[0], b, h, bh, lo, tid);
  cp_async_commit();
  unsigned ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, a.k.at(b, h), a.k.sn, k0, a.M, lane);
  load_a<D>(va, a.v.at(b, h), a.v.sn, k0, a.M, lane);

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int it = lo; it < hi; ++it) {
    const int buf = (it - lo) & 1;
    if (it + 1 < hi) {
      load_query_tile<D>(a, sq[buf ^ 1], sdo[buf ^ 1], sl[buf ^ 1], sd[buf ^ 1], b, h, bh,
                         it + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tiles_ready();
    // rows: the warp's 16 keys; columns: the tile's 64 queries
    float s[8][4] = {}, dp[8][4] = {};
    times_rows_t<D>(s, ka, sq[buf]);
    times_rows_t<D>(dp, va, sdo[buf]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float p = fast_exp2(fmaf(s[nt][e], a.scale_log2, -sl[buf][c] * kLog2e));
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sd[buf][c]);
      }
    }
    unsigned pa[4][4];
    to_a(pa, s);
    times_rows<D>(dv, pa, sdo[buf]);
    to_a(pa, dp);
    times_rows<D>(dk, pa, sq[buf]);
    __syncthreads();
  }
  // this split's dk (times the scale) and dv rows to the workspace
  const long long plane = static_cast<long long>(gridDim.y) * a.M * D;  // one split's
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float* base = a.ws + (static_cast<long long>(which) * a.splits + split) * plane +
                  static_cast<long long>(bh) * a.M * D;
    const float mul = which == 0 ? a.scale : 1.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + g + 8 * half;
      if (key >= a.M) continue;
      float* row = base + static_cast<long long>(key) * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float x = which == 0 ? dk[dt][2 * half] : dv[dt][2 * half];
        const float y = which == 0 ? dk[dt][2 * half + 1] : dv[dt][2 * half + 1];
        *reinterpret_cast<float2*>(row + dt * 8) = make_float2(x * mul, y * mul);
      }
    }
  }
}

// dk and dv: the workspace's splits summed in order from split 0, as bf16
template <int D>
__global__ void __launch_bounds__(256) seghiero_sr_flash_bwd_sum_kernel(Params a, int bhs) {
  const long long per = static_cast<long long>(a.M) * D;  // elements a head
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= bhs * per) return;
  const int bh = static_cast<int>(i / per), b = bh / a.heads, h = bh % a.heads;
  const long long rem = i % per;
  const int key = static_cast<int>(rem / D), col = static_cast<int>(rem % D);
  const long long plane = bhs * per;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(
          a.ws + (static_cast<long long>(which) * a.splits + s) * plane + i);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    bf16* dst_row = which == 0 ? a.dk.at(b, h) + static_cast<long long>(key) * a.dk.sn
                               : a.dv.at(b, h) + static_cast<long long>(key) * a.dv.sn;
    unsigned* dst = reinterpret_cast<unsigned*>(dst_row + col);
    dst[0] = pack_bf16(sum.x, sum.y);
    dst[1] = pack_bf16(sum.z, sum.w);
  }
}

Params make_params(void* const* ptrs, const long long* strides, int heads, int N, int M, int d) {
  Params p{};
  View* views[8] = {&p.q, &p.k, &p.v, &p.o, &p.dout, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 8; ++i)
    *views[i] = View{static_cast<bf16*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                     strides[3 * i + 2]};
  p.heads = heads;
  p.N = N;
  p.M = M;
  p.splits = 1;
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
  p.scale_log2 = p.scale * kLog2e;
  return p;
}

// rows a block: 64 (one warpgroup) or 128 (two, sharing the streamed tiles)
template <int D>
void launch_fwd(const Params& p, int bhs, int q_rows, cudaStream_t s) {
  const dim3 grid((p.N + q_rows - 1) / q_rows, bhs);
  if (q_rows == 128)
    seghiero_sr_flash_fwd_kernel<D, 2><<<grid, 256, 0, s>>>(p);
  else
    seghiero_sr_flash_fwd_kernel<D, 1><<<grid, 128, 0, s>>>(p);
}

template <int D>
cudaError_t launch_bwd(const Params& p, int bhs, cudaStream_t s) {
  seghiero_sr_flash_bwd_dq_kernel<D><<<dim3((p.N + kTile - 1) / kTile, bhs), 128, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seghiero_sr_flash_bwd_dkdv_kernel<D>
      <<<dim3((p.M + kTile - 1) / kTile, bhs, p.splits), 128, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = static_cast<long long>(bhs) * p.M * D / 4;
  seghiero_sr_flash_bwd_sum_kernel<D><<<blocks_for(quads, 256), 256, 0, s>>>(p, bhs);
  return cudaGetLastError();
}

bool shape_ok(int B, int heads, int N, int M, int d) {
  const long long bhs = static_cast<long long>(B) * heads;
  return (d == 32 || d == 64) && B > 0 && heads > 0 && N > 0 && M > 0 && bhs <= 65535;
}

}  // namespace
}  // namespace seghiero

// q, k, v, o: bf16 [B, h, rows, d] with element strides (batch, head, row)
// in `strides` (q, k, v, o: 12 values; the last dimension contiguous, rows
// 16-byte aligned); lse: f32 [B·h, N]; q_rows: queries a block, 64 or 128
extern "C" int seghiero_sr_attention_fwd(void* q, void* k, void* v, void* o, void* lse,
                                         const long long* strides, int B, int heads, int N,
                                         int M, int d, int q_rows, int device, void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(B, heads, N, M, d) || (q_rows != 64 && q_rows != 128))
    return cudaErrorInvalidValue;
  long long all[24] = {};
  for (int i = 0; i < 12; ++i) all[i] = strides[i];
  void* ptrs[8] = {q, k, v, o, nullptr, nullptr, nullptr, nullptr};
  Params p = make_params(ptrs, all, heads, N, M, d);
  p.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    launch_fwd<64>(p, B * heads, q_rows, s);
  else
    launch_fwd<32>(p, B * heads, q_rows, s);
  return cudaGetLastError();
}

// q, k, v, o, dout, dq, dk, dv: bf16 [B, h, rows, d], strides as above (24
// values, in that order); lse (from the forward) and delta (written here):
// f32 [B·h, N]; ws: f32 [2, splits, B·h, M, d]
extern "C" int seghiero_sr_attention_bwd(void* q, void* k, void* v, void* o, void* dout,
                                         void* dq, void* dk, void* dv, void* lse, void* delta,
                                         void* ws, const long long* strides, int B, int heads,
                                         int N, int M, int d, int splits, int device,
                                         void* stream) {
  using namespace seghiero;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(B, heads, N, M, d) || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  Params p = make_params(ptrs, strides, heads, N, M, d);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.ws = static_cast<float*>(ws);
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_bwd<64>(p, B * heads, s) : launch_bwd<32>(p, B * heads, s);
}
