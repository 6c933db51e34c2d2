// The three Gram kernels of the RMI loss (radius 3), on maps la (one-hot)
// and pr (probabilities), both [BC, H, W] f32 contiguous. View
// k = (dy, dx) ∈ {0,1,2}², k = 3·dy + dx, reads map[r+dy, c+dx] for output
// pixels r < nh = H − 2, c < nw = W − 2 (not centred); z is the 18 views
// [9 of la | 9 of pr]. All sums are raw (unnormalized) f32 sums:
//
//  * seghiero_rmi_gram18    (#6) G18[bc] = Σ_px z·zᵀ                 [BC, 18, 18]
//                                Each entry is a lag sum: anchored at the
//                                input pixel x = p + s_a of its anchor view
//                                a, G18[a][b] = Σ_x map_a(x)·map_b(x + l),
//                                l = s_b − s_a, over the x whose x − s_a is
//                                a valid output pixel. Inside the 2-pixel
//                                frame every x counts for every view, so
//                                the 171 entries share 51 lag sums there.
//  * seghiero_rmi_residual  (#7) A[bc]   = Σ_px y·yᵀ, y = z_la − Wᵀ·z_pr  [BC, 9, 9]
//                                #7 in f32 FMAs, #7f on bf16 tensor cores
//  * seghiero_rmi_grad_maps (#8) dpr[bc, r', c'] = Σ_k u_k(r'−dy, c'−dx) over
//                                the k whose output pixel is valid, u = P·z
//                                (P [BC, 9, 18])                  [BC, H, W]
//                                Inside the 2-pixel frame every k is valid,
//                                and dpr is a 5×5 correlation of each map
//                                with taps folded from P:
//                                T_m[2+ey−dy][2+ex−dx] += P[3dy+dx, 9m+3ey+ex]
//
// Each entry takes `bf16`: 0 runs the f32 kernels (#6, #7, #8,
// `rmi_precision: parity`), 1 their bf16-view variants (#6f, #7f, #8f,
// `rmi_precision: fast`), which round to bf16 (nearest even) exactly where
// the TPU kernel stores or casts to bf16 and keep every sum in f32: each
// loaded map value (the bf16 z scratch), W once a block, the residual y per
// pixel before its 45 products, and P when it is staged in shared memory.
// A product of two bf16 values is exact in f32, so these are the TPU
// kernel's single-pass bf16 dots with f32 accumulation. The maps stay f32
// in memory, as the TPU kernel reads f32 maps and rounds only in VMEM.
//
// Replaces: seghiero_tpu/ops/pallas/rmi_gram.py, `_gram18` (the
// pl.pallas_call at :257, body `_gram18_kernel` :153-170), `_residual_gram`
// (:274, `_residual_kernel` :173-195) and `_grad_maps` (:297,
// `_grad_kernel` :198-227), reached from `_half_logdet` (:355-394) — the
// RMI term of the 3-level loss, forward (#6, #7) and backward (#8); the
// bf16 variants are the same pallas_calls with `zdt = bfloat16`
// (`rmi_logdet_pallas_cmajor(precision="fast")`, :416-443).
//
// What bounds them on an H100, at config 3 (BC = 60 maps of 512²,
// 62.9 MB each in f32). The 18 views are shifts of two maps, so the least
// work is smaller than what a per-pixel z·zᵀ does:
//  * #6 reads both maps once (125.9 MB, 0.038 ms at 3.35 TB/s). Each G18
//    entry is a correlation of two maps at one lag in {−2..2}² (13 la·la,
//    13 pr·pr, 25 la·pr, up to the 2-pixel frame): 51 FMAs per output pixel
//    (0.024 ms at 67 TFLOP/s f32). Bound by bytes; it does those 51 inside
//    the frame (171 per anchor on the frame, 1.6 % of the pixels).
//  * #7 reads the same bytes and needs the residual y per pixel: 81 + 45
//    FMAs, the 9 subtractions folded into the first 81 (−y summed from
//    −z_la): 3.93 G flop, 0.059 ms at the f32 rate.
//    Bound by operations: an FFMA takes an issue slot of its own, so the
//    kernel's time is its instructions per pixel. Measured on an H100
//    (PERF.md §6), its loop (1512 FFMAs in 1847 instructions) issues in
//    ~73 % of the cycles with nothing staged, while its 16-byte ring alone
//    streams the maps at ~2.4 TB/s: the loop, not the ring, holds it.
//  * #8 reads both maps and writes dpr (188.8 MB, 0.056 ms). Inside the
//    frame, 50 FMAs per pixel on the folded taps (0.023 ms). Bound by
//    bytes; it does those 50 (up to 162 on the frame).
// The bf16 variants at config 4 (BC = 30 maps of 769², 71.0 MB each) read
// and write the same f32 bytes (141.9, 141.9, 212.9 MB: 0.042, 0.042,
// 0.064 ms); their products, on bf16 operands, count at the tensor cores'
// bf16 rate, so all three are bound by bytes. #6f and #8f run them as f32
// FMAs on rounded values (one rounding per loaded value is all they add to
// #6 and #8); #7f runs them on the tensor cores, since as FMAs its 2.2 G
// products alone would take 0.066 ms, more than its byte bound.
//
// Design. #6, #7 and #8 use no tensor cores and no TF32: the logdet
// downstream needs f32 Grams and the TPU pins precision=HIGHEST for f32
// operands, so every product is an f32 FMA. #7f's operands are bf16 (the
// TPU's single-pass bf16 MXU dots), which is what mma.sync computes.
//  * #7: #7f's tiles (below) and 4-slot cp.async ring, with 16-byte
//    copies. A staged row is the 16-byte chunks of a map row from the one
//    holding the tile's first column (the address rounded down: rows of 769
//    are not 16-byte aligned) through the one holding its last halo column;
//    a read adds the row's offset in its first chunk (vector reads where it
//    is 0). A chunk holding no column of the row is zero-filled, not read.
//    Each of 64 threads owns 4 adjacent output columns and keeps W (81
//    values), the 45 sums and a 3-row window of 6 columns of both maps in
//    registers; per input row it reads its 6 + 6 new values once, and the
//    row loop is unrolled by 3, so the window rotates by renaming. Per
//    pixel it does 81 + 45 FFMAs and nothing else: each y_i sums from
//    −z_la,i (giving −y, whose y·yᵀ is the same), so the 9 subtractions
//    fold into the FMAs. The block adds its threads' sums in a fixed order
//    (a shuffle tree, then its 2 warps in order) into one partial row; the
//    finish adds a map's partials in order and writes both triangles.
//  * #7f: tiles of 32 output rows × 256 output columns (510 = 256 + 254,
//    767 = 256 + 256 + 255), every output pixel with all 18 views, no
//    frame. A block of 4 warps stages the tile's input rows of both maps
//    through a 4-slot cp.async ring (f32), and packs each row once into
//    pair words (bf16 of staged columns j and j + 1, for every j: each
//    value rounded once per word it is in) in a 4-slot ring whose slots
//    start 8 banks apart, so every gather below is conflict-free. Each
//    warp owns 64 columns of each row: 4 segments of 16 pixels, each 4
//    mma.sync.m16n8k16 (bf16 operands, f32 sums):
//    - product 1, twice (8 pixels each): Y = A·B + C with A = −bf16(W)ᵀ,
//      its rows in kRowView's order and its K slots in kSlotView's (16 ×
//      16, zero outside the 9 × 9 entries, loaded once), B pr's pair words
//      kWordRow / kWordCol at the 8 pixels (slots 2q, 2q + 1 are word q,
//      two horizontally adjacent views), C la's views (zero rows zero). D
//      is Y, rows the views, columns the pixels; a ragged segment zeroes
//      the columns of pixels at or past nw here (at column nw the dx = 0
//      view still reads the map). The two D tiles round to bf16 and pack
//      (cvt.rn.bf16x2) into the A fragment of product 2: {rows g, g + 8} ×
//      {pixels 2t, 2t + 8} (g = lane / 4, t = lane % 4).
//    - product 2, twice: Y·Yᵀ over the 16 pixels (K), its B fragments the
//      same registers: columns 0 … 7 {reg0, reg2}, 8 … 15 {reg1, reg3}.
//    A row's 4 segments chain in the tensor core from zero (its own sums
//    truncate); the row's 16 × 16 tile is then added to the warp's f32
//    register sums, row by row. The block adds its warps' lower triangles
//    (one entry per pair of views) in warp order into one partial row; the
//    finish writes both triangles, so A is exactly symmetric.
//  * #6 and #8 share one geometry (TileGrid): interior tiles of 32 rows ×
//    256 columns of the core (input rows and columns 2 … H−3, W−3: 765 =
//    3 × 255 at 769, 508 = 2 × 254 at 512, so no tile column is nearly
//    empty), and frame blocks ahead of them in the same launch. A tile
//    block stages its input rows (the tile's plus the 2-pixel halos) of
//    both maps into a 4-slot ring in shared memory with cp.async, and each
//    of its 64 threads owns 4 adjacent columns: per input row it reads 2 ×
//    8 values from shared memory (under bf16 each is rounded as it enters
//    the registers, so a value is rounded by the 1 or 2 threads that read
//    it, not per product).
//  * #6 keeps the 51 lag sums of the core as register sums shared by the
//    thread's 4 columns: la·la and pr·pr at the 13 lags of the half-plane
//    {ly > 0} ∪ {ly = 0, lx ≥ 0} (anchored at the earlier view), la·pr at
//    all 25 (anchored at la). Per input row t it forms the products of
//    row t with rows t − 2 … t of both maps (a 3-row register window):
//    the 51 lags × 4 columns, 204 FMAs on register operands, each counted
//    when its anchor's row lies in the tile (the first and last two input
//    rows are peeled, so the steady loop has no predicate); an anchor
//    column past the core contributes zeros. The block adds its threads'
//    51 sums (a shuffle tree, then its 2 warps in order) into one row.
//    An entry takes the lag sum of its lag, and on the frame the general
//    form: each frame block gathers 256 frame anchors, 64 at a time, into
//    shared memory (per anchor its 18 views' values, zeroed where x − s_a
//    is not a valid output pixel, and its 38 partners at the lags of the
//    half-plane for la and all 25 for pr) and each thread adds, for its 3
//    of the 171 entries, one product per anchor in anchor order: one row
//    of 171 sums per frame block. A finish kernel, one block per map,
//    writes both triangles. Below 5 × 5 there is no core and every anchor
//    is frame.
//  * #8 folds P into the 50 taps once per block (162 adds; each tap the
//    sum of its 1 to 9 P entries in k order), and each thread keeps them in
//    registers; per input row it adds its 2 × 8 values with the 5 tap rows
//    into the 5 output rows that row feeds (5 rolling accumulators per
//    column, 200 FMAs with register operands); the oldest is then complete
//    and stored. The frame pixels (the 2 rows and columns at each edge, or
//    the whole map below 5 × 5) go to frame blocks, 2 pixels a thread, in
//    the general form: the valid u_k from P in shared memory. Each dpr
//    pixel is written once, by one thread.
// The TPU kernels' 128-lane padding, 8-row halo blocks, lane rolls and
// tile-row picker are Mosaic's; here each thread masks the ragged edge.
// No float atomics anywhere: two runs give the same bits.
//
// Numerics: f32 sums in an order set by the launch geometry, not the plain
// versions' (seghiero_torch/ops/rmi_gram.py), so they are compared within
// 1e-5 · Σ|z_i·z_j| per Gram entry and 1e-5 · Σ|P|·|z| per dpr pixel.
// #7f is compared within 2e-5: it rounds y from the tensor core's sum of
// la and 9 exact products, which can land on the other side of a bf16
// rounding boundary than the plain version's, and the tensor core adds its
// products in its own order and truncates, so a row's sum is chained in it
// over 64 pixels only. #7f adds an entry as (its tiles' rows, in tile
// order); a tile's row is its 4 warps' sums in warp order, each warp's its
// output rows' sums in row order, each row's its 4 segments chained in the
// tensor core.
// #7 adds an entry as (its tiles' rows, in tile order); a tile's row is its
// threads' sums in a shuffle tree and then warp order, each thread's its 4
// columns' products output row by output row (column order within a row),
// each −y_i the FMAs of Σ_j W[j][i]·z_pr,j in j order onto −z_la,i.
// #6 adds an entry as (its lag's tile rows, in tile order) + (its frame
// rows, in frame block order); a tile's row is its threads' sums in a
// shuffle tree and then warp order, each thread's the products of its 4
// columns input row by input row (column order within a row); a frame
// row is its anchors' products in frame order. #8's interior adds each
// pixel's 50 products input row by input row (tap rows 0 … 4; in each,
// la's 5 then pr's 5) onto taps that are themselves f32 sums of P:
// folding reorders the f32 sums and changes nothing else.

#include <type_traits>

#include "common.cuh"

namespace seghiero {
namespace {

constexpr int kG18 = 18 * 19 / 2;  // unique entries of the 18×18 Gram
constexpr int kRes = 9 * 10 / 2;   // unique entries of the 9×9 Gram

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // j <= i

// A map, W or P value as the kernel multiplies it: itself, or (kBf16)
// rounded to the nearest bf16, as the TPU kernel's bf16 z scratch holds it.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return to_f32(from_f32<__nv_bfloat16>(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The per-thread sums acc[E] of a block of kThreads threads, added in a
// fixed order (a shuffle tree within each warp, then the warps in order),
// stored to out[E].
template <int E, int kThreads>
__device__ __forceinline__ void block_sum_store(const float (&acc)[E], float* __restrict__ out) {
  constexpr int kW = kThreads / 32;
  __shared__ float red[kW][E];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float s = warp_sum(acc[e]);
    if (lane == 0) red[warp][e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float s = red[0][e];
#pragma unroll
    for (int w = 1; w < kW; ++w) s += red[w][e];
    out[e] = s;
  }
}

// out[bc][i][j] for both triangles of a D×D Gram: map bc's nblk partial
// rows of E = D(D+1)/2 entries, added in block order.
template <int D>
__global__ void __launch_bounds__(256) gram_finish_kernel(const float* __restrict__ partial,
                                                          float* __restrict__ out, int BC,
                                                          int nblk) {
  constexpr int E = D * (D + 1) / 2;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(BC) * D * D) return;
  const int bc = static_cast<int>(t / (D * D));
  const int ij = static_cast<int>(t % (D * D));
  const int i = ij / D, j = ij % D;
  const int e = i >= j ? tri(i, j) : tri(j, i);
  const float* src = partial + static_cast<long long>(bc) * nblk * E + e;
  float s = src[0];
  for (int b = 1; b < nblk; ++b) s += src[static_cast<long long>(b) * E];
  out[t] = s;
}

// The geometry of #6 and #8, one 1-D block index per map: the frame blocks
// first (so their serial work does not end the launch), then the interior
// tiles (row-major). An interior block's kGradThreads threads each own
// kGradCols adjacent columns of a tile of kGradTileH interior rows ×
// kGradTileW interior columns and walk down its rows. A frame block of #8
// takes kGradThreads · kFramePix frame pixels, one of #6 kGramFrame frame
// anchors. ptxas is asked for kGradMinBlocks blocks an SM (at most 128
// registers a thread). These are the fastest of the variants timed
// against each other on an H100, for #8 and for #6 (PERF.md, §6).
constexpr int kGradThreads = 64;
constexpr int kGradMinBlocks = 8;
constexpr int kGradCols = 4;
constexpr int kGradTileW = kGradThreads * kGradCols;  // 256: 508 = 2·254, 765 = 3·255
constexpr int kGradTileH = 32;
constexpr int kGradRowW = kGradTileW + 4;  // a staged row: the tile and its 2-column halos
constexpr int kGradStages = 4;             // ring slots: input rows in flight + 1
constexpr int kFramePix = 2;
static_assert(kGradCols % 4 == 0 && kGradRowW % 4 == 0, "float4 reads of the staged rows");

struct TileGrid {
  int ntc;     // column tiles of the interior
  int tiles;   // interior tiles (0 when H or W is below 5)
  int frame;   // frame pixels
  int blocks;  // frame blocks + tiles
};

// the grid of a map whose frame blocks take `per_block` frame pixels each
inline TileGrid tile_grid(int H, int W, int per_block) {
  const int nir = H > 4 ? H - 4 : 0, nic = W > 4 ? W - 4 : 0;
  TileGrid g;
  g.ntc = (nic + kGradTileW - 1) / kGradTileW;
  g.tiles = g.ntc * ((nir + kGradTileH - 1) / kGradTileH);
  g.frame = g.tiles ? 4 * W + 4 * nir : H * W;
  g.blocks = g.tiles + (g.frame + per_block - 1) / per_block;
  return g;
}

// Frame pixel f of a map: rows 0, 1, then rows H − 2, H − 1, then columns
// 0, 1, W − 2, W − 1 of rows 2 … H − 3; every pixel when there is no interior.
__device__ __forceinline__ void frame_pixel(int f, int H, int W, bool all, int& r, int& c) {
  if (all || f < 2 * W) {
    r = f / W;
    c = f - r * W;
  } else if (f < 4 * W) {
    f -= 2 * W;
    r = H - 2 + f / W;
    c = f % W;
  } else {
    f -= 4 * W;
    r = 2 + (f >> 2);
    c = (f & 3) < 2 ? (f & 3) : W - 4 + (f & 3);
  }
}

// Map row `row` of both maps, columns c0 … c0 + kGradRowW − 1, into dst
// (la) and dst + kGradRowW (pr) with cp.async by a block of kThreads
// threads, zeros past the last column.
template <int kThreads>
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ a,
                                          const float* __restrict__ p, int row, int c0, int W) {
  const long long o0 = static_cast<long long>(row) * W;
  for (int j = threadIdx.x; j < kGradRowW; j += kThreads) {
    const bool ok = c0 + j < W;
    const long long o = o0 + (ok ? c0 + j : 0);
    copy_async_or_zero<4>(dst + j, a + o, ok);
    copy_async_or_zero<4>(dst + kGradRowW + j, p + o, ok);
  }
}

// N consecutive floats of a staged row (16-byte aligned), as 16-byte reads.
template <int N>
__device__ __forceinline__ void read_staged(const float* src, float (&x)[N]) {
  static_assert(N % 4 == 0, "float4 reads");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
  }
}

// dpr at a frame pixel in the general form: the u_k of the valid output
// pixels (r − dy, c − dx), added in k order, with P from shared memory.
template <bool kBf16>
__device__ __forceinline__ float frame_value(const float* __restrict__ a,
                                             const float* __restrict__ p, const float* ps,
                                             int r, int c, int W, int nh, int nw) {
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ro = r - dy, co = c - dx;
      if (ro < 0 || ro >= nh || co < 0 || co >= nw) continue;
      const float* pk = ps + (dy * 3 + dx) * 18;
      const long long o = static_cast<long long>(ro) * W + co;
      float u = 0.f;
#pragma unroll
      for (int ey = 0; ey < 3; ++ey)
#pragma unroll
        for (int ex = 0; ex < 3; ++ex)
          u = fmaf(pk[ey * 3 + ex], operand<kBf16>(a[o + ey * W + ex]), u);
#pragma unroll
      for (int ey = 0; ey < 3; ++ey)
#pragma unroll
        for (int ex = 0; ex < 3; ++ex)
          u = fmaf(pk[9 + ey * 3 + ex], operand<kBf16>(p[o + ey * W + ex]), u);
      acc += u;
    }
  return acc;
}

template <bool kBf16>
__global__ void __launch_bounds__(kGradThreads, kGradMinBlocks) grad_maps_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, const float* __restrict__ P,
    float* __restrict__ dpr, int H, int W, TileGrid g) {
  __shared__ float ps[9 * 18];
  __shared__ float taps[50];
  __shared__ __align__(16) float ring[kGradStages][2][kGradRowW];
  const float* pb = P + static_cast<long long>(blockIdx.y) * (9 * 18);
  for (int q = threadIdx.x; q < 9 * 18; q += kGradThreads) ps[q] = operand<kBf16>(pb[q]);
  __syncthreads();
  const long long map = static_cast<long long>(blockIdx.y) * H * W;
  const float* a = la + map;
  const float* p = pr + map;
  float* out = dpr + map;

  const int frame_blocks = g.blocks - g.tiles;
  if (static_cast<int>(blockIdx.x) < frame_blocks) {
    const int f0 = blockIdx.x * (kGradThreads * kFramePix) + threadIdx.x;
    for (int s = 0; s < kFramePix; ++s) {
      const int f = f0 + s * kGradThreads;
      if (f >= g.frame) break;
      int r, c;
      frame_pixel(f, H, W, g.tiles == 0, r, c);
      out[static_cast<long long>(r) * W + c] =
          frame_value<kBf16>(a, p, ps, r, c, W, H - 2, W - 2);
    }
    return;
  }

  // taps[25·m + 5·i + j]: the sum, in k order, of the P[k, 9·m + 3·ey + ex]
  // with i = 2 + ey − dy and j = 2 + ex − dx (m = 0: la, 1: pr)
  if (threadIdx.x < 50) {
    const int m = threadIdx.x / 25, i = threadIdx.x % 25 / 5, j = threadIdx.x % 5;
    float t = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ey = i - 2 + dy, ex = j - 2 + dx;
        if (ey >= 0 && ey < 3 && ex >= 0 && ex < 3)
          t += ps[(dy * 3 + dx) * 18 + 9 * m + ey * 3 + ex];
      }
    taps[threadIdx.x] = t;
  }

  const int tile = blockIdx.x - frame_blocks;
  const int tr = tile / g.ntc;
  const int c0 = (tile - tr * g.ntc) * kGradTileW;  // first staged column
  const int r0 = 2 + tr * kGradTileH;                      // first output row
  const int n_in = min(r0 + kGradTileH, H - 2) - r0 + 4;   // input rows r0 − 2, …

  // input row s (map row r0 − 2 + s) of both maps into slot s % kGradStages,
  // zeros past the last column; one commit group per call
  auto stage = [&](int s) {
    if (s < n_in) stage_row<kGradThreads>(ring[s % kGradStages][0], a, p, r0 - 2 + s, c0, W);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) stage(s);
  __syncthreads();  // the taps are folded
  float ta[25], tp[25];
#pragma unroll
  for (int q = 0; q < 25; ++q) {
    ta[q] = taps[q];
    tp[q] = taps[25 + q];
  }

  const int cl = threadIdx.x * kGradCols;  // the thread's first column in the tile
  const int c = c0 + 2 + cl;               // ... in the map
  // acc[q]: output row r0 − 4 + s + q while input row s is added (its tap row 4 − q)
  float acc[5][kGradCols];
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int v = 0; v < kGradCols; ++v) acc[q][v] = 0.f;
  for (int s = 0; s < n_in; ++s) {
    cp_async_wait<kGradStages - 2>();  // this thread's copies of row s landed
    __syncthreads();                   // everyone's did, and row s − 1's slot is free
    stage(s + kGradStages - 1);
    const float* ra = ring[s % kGradStages][0] + cl;
    const float* rp = ring[s % kGradStages][1] + cl;
    float xa[kGradCols + 4], xp[kGradCols + 4];
    read_staged(ra, xa);
    read_staged(rp, xp);
#pragma unroll
    for (int q = 0; q < kGradCols + 4; ++q) {  // once per value this thread reads
      xa[q] = operand<kBf16>(xa[q]);
      xp[q] = operand<kBf16>(xp[q]);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q)
#pragma unroll
      for (int v = 0; v < kGradCols; ++v) {
        float t = acc[q][v];
#pragma unroll
        for (int j = 0; j < 5; ++j) t = fmaf(ta[(4 - q) * 5 + j], xa[v + j], t);
#pragma unroll
        for (int j = 0; j < 5; ++j) t = fmaf(tp[(4 - q) * 5 + j], xp[v + j], t);
        acc[q][v] = t;
      }
    if (s >= 4) {  // output row r0 + s − 4 has all five tap rows
      float* o = out + static_cast<long long>(r0 + s - 4) * W + c;
#pragma unroll
      for (int v = 0; v < kGradCols; ++v)
        if (c + v < W - 2) o[v] = acc[0][v];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < kGradCols; ++v) acc[q][v] = acc[q + 1][v];
#pragma unroll
    for (int v = 0; v < kGradCols; ++v) acc[4][v] = 0.f;
  }
}

// #7f on bf16 tensor cores (the header's Design). A tile is kResTileH
// output rows × kResTileW output columns; each of its kResWarps warps owns
// kResSegs segments of 16 pixels of every row.
constexpr int kResThreads = 128;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResTileH = 32;
constexpr int kResTileW = 256;
constexpr int kResSegs = kResTileW / kResWarps / 16;
// Pair words of a staged row x: word j = bf16(x[j]) | bf16(x[j + 1]) << 16,
// j = 0 … 4·kPairJobs − 1 (the gathers read 0 … kResTileW), packed 4 a job
// from two aligned float4 reads of x. A staged row holds kResRowW columns;
// pair slot k starts at word k·kPairStride, 8 banks after slot k − 1, so
// the 3 slots an output row reads start 8 banks apart, in any rotation,
// and each gather's 8-word runs of its rows meet no bank twice.
constexpr int kPairJobs = (kResTileW + 1 + 3) / 4;
constexpr int kResRowW = 4 * kPairJobs + 4;
constexpr int kPairSlots = 4;
constexpr int kPairStride = 264;
static_assert(kPairStride % 32 == 32 / kPairSlots && kPairStride >= 4 * kPairJobs,
              "slots 8 banks apart, not overlapping");
static_assert(kResRowW % 4 == 0 && kPairStride % 4 == 0, "float4 and uint4 rows");

// Product 1's K slots: slots 2q, 2q + 1 hold pr's pair word q, input row
// kWordRow[q] at staged columns p + kWordCol[q] and p + kWordCol[q] + 1 for
// pixel p; words 3 and 7 repeat 0 and 4 (lanes t = 3 read what lanes t = 0
// read). kSlotView[s] is the view k = 3·dy + dx in slot s, −1 where A's
// column is zero (a view an earlier slot holds, or a repeat). kRowView[r]
// is the view in row r of Y (product 1's A and C rows, product 2's rows
// and columns), −1 for a zero row: C's rows g < 8 hold la's views dx = 0,
// 1 (word 2t + dx of their row dy at pixels 2t, 2t + 1), rows g + 8 the
// views dx = 2, so each row dy's words are 8 adjacent ones in every gather.
__constant__ int kWordRow[8] = {0, 1, 2, 0, 0, 1, 2, 0};
__constant__ int kWordCol[8] = {0, 0, 0, 0, 1, 1, 1, 1};
__constant__ int kSlotView[16] = {0, 1, 3, 4, 6, 7, -1, -1, -1, 2, -1, 5, -1, 8, -1, -1};
__constant__ int kRowView[16] = {0, 1, 3, 4, 6, 7, -1, -1, 2, 5, 8, -1, -1, -1, -1, -1};

// bf16(lo) in the low half, bf16(hi) in the high half (nearest even)
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// a bf16 half of a pair word as f32, picked by a byte_perm selector
// (kLoHalf, kHiHalf; kZero gives 0)
constexpr unsigned kLoHalf = 0x1044, kHiHalf = 0x3244, kZero = 0x4444;
__device__ __forceinline__ float half_f32(unsigned word, unsigned sel) {
  return __uint_as_float(__byte_perm(word, 0u, sel));
}

// d = a·b + c, m16n8k16, bf16 operands, f32 sums (PTX fragment layouts)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// #7f's first pass: one partial row of the 45 lower-triangle sums per tile
// (blockIdx.x, row-major over ntc column tiles) of map blockIdx.y.
__global__ void __launch_bounds__(kResThreads) residual_mma_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, const float* __restrict__ w,
    float* __restrict__ partial, int H, int W, int ntc) {
  __shared__ __align__(16) float ring[kGradStages][2][kResRowW];
  __shared__ __align__(16) unsigned pairs[2][kPairSlots * kPairStride];
  __shared__ float red[kResWarps][kRes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = W - 2;
  const int tr = blockIdx.x / ntc;
  const int c0 = (blockIdx.x - tr * ntc) * kResTileW;  // first output (and staged) column
  const int r0 = tr * kResTileH;                        // first output row
  const int n_in = min(kResTileH, H - 2 - r0) + 2;      // input rows r0, …
  const long long map = static_cast<long long>(blockIdx.y) * H * W;
  // the maps' bases as values the compiler cannot split again, so a copy's
  // address is one 32-bit multiply-add onto them
  const float* a = la + map;
  const float* p = pr + map;
  asm("" : "+l"(a), "+l"(p));

  // input row s (map row r0 + s) into ring slot s % kGradStages, zeros past
  // the map's last column; one commit group per call. The thread copies
  // staged columns j = tid + kResThreads·k, the same ones every row.
  static_assert(2 * kResThreads <= kResRowW && kResRowW <= 3 * kResThreads, "3 copies a thread");
  int col[3];
  bool in_map[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    in_map[k] = c0 + tid + k * kResThreads < W;
    col[k] = in_map[k] ? c0 + tid + k * kResThreads : 0;
  }
  const bool third = tid + 2 * kResThreads < kResRowW;
  auto stage = [&](int s) {
    if (s < n_in) {
      const int o = (r0 + s) * W;  // within the map (shape_ok: H·W < 2^31)
      float* dst = ring[s & (kGradStages - 1)][0] + tid;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (k < 2 || third) {
          copy_async_or_zero<4>(dst + k * kResThreads, a + (o + col[k]), in_map[k]);
          copy_async_or_zero<4>(dst + kResRowW + k * kResThreads, p + (o + col[k]), in_map[k]);
        }
      }
    }
    cp_async_commit();
  };
  static_assert((kGradStages & (kGradStages - 1)) == 0 && (kPairSlots & (kPairSlots - 1)) == 0,
                "ring slots by masking");
#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) stage(s);

  // product 1's A = −bf16(W)ᵀ: row r (view kRowView[r]), K slot s
  const float* wb = w + static_cast<long long>(blockIdx.y) * 81;
  auto neg_wt = [&](int r, int s) {
    const int i = kRowView[r], j = kSlotView[s];
    return i >= 0 && j >= 0 ? -wb[j * 9 + i] : 0.f;
  };
  const unsigned fa[4] = {pack_bf16x2(neg_wt(g, 2 * t), neg_wt(g, 2 * t + 1)),
                          pack_bf16x2(neg_wt(g + 8, 2 * t), neg_wt(g + 8, 2 * t + 1)),
                          pack_bf16x2(neg_wt(g, 2 * t + 8), neg_wt(g, 2 * t + 9)),
                          pack_bf16x2(neg_wt(g + 8, 2 * t + 8), neg_wt(g + 8, 2 * t + 9))};
  // the lane's gathers at the warp's first pixel, as (input row, word): B's
  // words t and t + 4 at pixel g (the same row); C's rows g and g + 8 at
  // pixels 2t, 2t + 1 (a zero row reads row g − 6's word, or row 8's)
  const int px = warp * (kResTileW / kResWarps);
  const int b_row = kWordRow[t], b0_col = px + g + kWordCol[t];
  const int b1_col = px + g + kWordCol[t + 4];
  const int vc = kRowView[g], v8 = kRowView[g + 8];
  const int c_row = vc >= 0 ? vc / 3 : (g - 6) / 2, c_col = px + 2 * t + (vc >= 0 ? vc % 3 : g % 2);
  const int c8_row = v8 >= 0 ? v8 / 3 : 0, c8_col = px + 2 * t + 2;
  const unsigned c_lo = vc >= 0 ? kLoHalf : kZero, c_hi = vc >= 0 ? kHiHalf : kZero;
  const unsigned c8_lo = v8 >= 0 ? kLoHalf : kZero, c8_hi = v8 >= 0 ? kHiHalf : kZero;

  // staged row s → pair slot s % kPairSlots, both maps, 4 words a job:
  // job kResThreads − 1 − tid, and on the last warp (whose staging took no
  // third column) one more
  static_assert(kResThreads < 2 * kPairJobs && 2 * kPairJobs <= 2 * kResThreads, "2 jobs at most");
  int job_src[2], job_dst[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int job = kResThreads - 1 - tid + k * kResThreads;
    const int m = job >= kPairJobs, q = job - m * kPairJobs;
    job_src[k] = m * (kResRowW / 4) + q;  // float4 of the ring slot
    job_dst[k] = m * (kPairSlots * kPairStride / 4) + q;  // uint4 of pairs
  }
  const bool second = 2 * kResThreads - 1 - tid < 2 * kPairJobs;
  auto pack = [&](int s) {
    uint4* dst = reinterpret_cast<uint4*>(&pairs[0][(s & (kPairSlots - 1)) * kPairStride]);
    const float4* src = reinterpret_cast<const float4*>(ring[s & (kGradStages - 1)][0]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !second) break;
      const float4 x = src[job_src[k]], y = src[job_src[k] + 1];
      dst[job_dst[k]] = make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.y, x.z),
                                   pack_bf16x2(x.z, x.w), pack_bf16x2(x.w, y.x));
    }
  };

  float acc_a[4] = {0.f, 0.f, 0.f, 0.f}, acc_b[4] = {0.f, 0.f, 0.f, 0.f};
  // output row o from pair slots o, o + 1, o + 2; kRagged: the warp's
  // columns reach past nw (masks, and segments to skip)
  auto row = [&](int o, auto ragged) {
    constexpr bool kRagged = decltype(ragged)::value;
    auto at = [&](int dy) { return ((o + dy) & (kPairSlots - 1)) * kPairStride; };
    const unsigned* pb = &pairs[1][at(b_row)];
    const unsigned* lc = &pairs[0][at(c_row) + c_col];
    const unsigned* lc8 = &pairs[0][at(c8_row) + c8_col];
    float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};  // the row's tile
#pragma unroll
    for (int q = 0; q < kResSegs; ++q) {
      const int col = c0 + px + 16 * q;  // the segment's first output column
      if (kRagged && col >= nw) break;
      unsigned ya[4];  // Y as product 2's A: rows g, g + 8 × pixels 2t, 2t + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o8 = 16 * q + 8 * h;
        const unsigned wc = lc[o8], w8 = lc8[o8];
        const float c[4] = {half_f32(wc, c_lo), half_f32(wc, c_hi), half_f32(w8, c8_lo),
                            half_f32(w8, c8_hi)};
        float d[4];
        mma_bf16(d, fa, pb[b0_col + o8], pb[b1_col + o8], c);
        if (kRagged && col + 16 > nw) {  // y = 0 past the last output column
          const int cd = col + 8 * h + 2 * t;
          if (cd >= nw) d[0] = d[2] = 0.f;
          if (cd + 1 >= nw) d[1] = d[3] = 0.f;
        }
        ya[2 * h] = pack_bf16x2(d[0], d[1]);
        ya[2 * h + 1] = pack_bf16x2(d[2], d[3]);
      }
      mma_bf16(ra, ya, ya[0], ya[2], ra);  // columns 0 … 7
      mma_bf16(rb, ya, ya[1], ya[3], rb);  // columns 8 … 15
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_a[e] += ra[e];
      acc_b[e] += rb[e];
    }
  };
  // step s: row s lands, is packed, and output row s − 3 is added (its
  // rows were packed at earlier steps; slot s is none of theirs). A warp
  // runs one of two loops with the same count of barriers: barrier.sync
  // without .aligned, which warps may reach at different instructions.
  auto rows = [&](auto ragged) {
    for (int s = 0; s <= n_in; ++s) {
      cp_async_wait<kGradStages - 2>();  // this thread's copies of row s landed
      // everyone's did, row s − 1 is packed and its ring slot free
      asm volatile("barrier.sync 0;\n" ::: "memory");
      if (s < n_in) {
        stage(s + kGradStages - 1);
        pack(s);
      }
      if (s >= 3) row(s - 3, ragged);
    }
  };
  if (c0 + px + kResTileW / kResWarps > nw)
    rows(std::true_type{});
  else
    rows(std::false_type{});

  // the warps' lower triangles in Y's rows: lane (g, t) holds (g, 2t + e),
  // (g + 8, 2t + e) of columns 0 … 7 in acc_a and of columns 8 … 15 in
  // acc_b (e = 0, 1); entry (r, c), c ≤ r, of two views is A's entry of
  // those views, each pair of views once
  auto put = [&](int r, int c, float v) {
    const int i = kRowView[r], j = kRowView[c];
    if (c <= r && i >= 0 && j >= 0) red[warp][i >= j ? tri(i, j) : tri(j, i)] = v;
  };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    put(g, 2 * t + e, acc_a[e]);
    put(g + 8, 2 * t + e, acc_a[2 + e]);
    put(g, 8 + 2 * t + e, acc_b[e]);
    put(g + 8, 8 + 2 * t + e, acc_b[2 + e]);
  }
  __syncthreads();
  if (tid < kRes) {
    float sum = red[0][tid];
#pragma unroll
    for (int k = 1; k < kResWarps; ++k) sum += red[k][tid];
    partial[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kRes + tid] = sum;
  }
}

// #7 in f32 FMAs (the header's Design), on #7f's tiles: each of
// kF32Threads threads owns kF32Cols adjacent output columns of every row. A
// staged row holds kF32Chunks 16-byte chunks of each map from the one
// holding the tile's first column: the tile's columns and their 2-column
// halo at any offset of that column in its chunk. ptxas is asked for
// kF32MinBlocks blocks an SM (at most 204 registers a thread).
constexpr int kF32Cols = 4;
constexpr int kF32Threads = kResTileW / kF32Cols;
constexpr int kF32MinBlocks = 5;
constexpr int kF32Chunks = (3 + kResTileW + 2 + 3) / 4;
constexpr int kF32RowW = 4 * kF32Chunks;
static_assert(kF32Cols == 4, "a thread's 6 staged columns are one float4 and one float2");
static_assert(kF32Chunks >= kF32Threads && 2 * (kF32Chunks - kF32Threads) <= kF32Threads,
              "a chunk of each map a thread, and the rest on the first threads");

// The offset (0 … 3 floats) of element e of the map at m in its 16-byte chunk.
__device__ __forceinline__ int chunk_offset(const float* m, int e) {
  return static_cast<int>(((reinterpret_cast<unsigned long long>(m) >> 2) + e) & 3);
}

// 6 consecutive floats `off` floats past src (16-byte aligned): one float4
// and one float2 when off is 0, else 6 scalar reads.
__device__ __forceinline__ void read6(const float* src, int off, float (&x)[6]) {
  if (off == 0) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float2 v = *reinterpret_cast<const float2*>(src + 4);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w, x[4] = v.x, x[5] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = src[off + j];
  }
}

// #7's first pass: one partial row of the 45 lower-triangle sums per tile
// (blockIdx.x, row-major over ntc column tiles) of map blockIdx.y.
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks) residual_f32_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, const float* __restrict__ w,
    float* __restrict__ partial, int H, int W, int ntc) {
  __shared__ __align__(16) float ring[kGradStages][2][kF32RowW];
  const int tid = threadIdx.x;
  const int tr = blockIdx.x / ntc;
  const int c0 = (blockIdx.x - tr * ntc) * kResTileW;  // first output (and staged) column
  const int r0 = tr * kResTileH;                        // first output row
  const int n_out = min(kResTileH, H - 2 - r0);
  const long long map = static_cast<long long>(blockIdx.y) * H * W;
  const float* a = la + map;
  const float* p = pr + map;
  asm("" : "+l"(a), "+l"(p));  // as in #7f: a copy's address is one add onto them
  const int need = min(kResTileW + 2, W - c0);  // the map columns a staged row holds

  // input row s (map row r0 + s) into ring slot s % kGradStages: chunk q of
  // each map from the chunk holding column c0 on, zeros for a chunk that
  // holds no needed column (it may lie past the map's end); one commit group
  // per call. Thread t copies chunk t of both maps, and the first threads
  // the kF32Chunks − kF32Threads chunks past those, la's and then pr's.
  constexpr int kExtra = kF32Chunks - kF32Threads;
  const bool extra = tid < 2 * kExtra, extra_pr = tid >= kExtra;
  const int extra_q = kF32Threads + (extra_pr ? tid - kExtra : tid);
  auto stage = [&](int s) {
    if (s < n_out + 2) {
      const int e = (r0 + s) * W + c0;  // within the map (shape_ok: H·W < 2^31)
      const int off_a = chunk_offset(a, e), off_p = chunk_offset(p, e);
      const float* fa = a + (e - off_a);  // chunk 0: holds column c0
      const float* fp = p + (e - off_p);
      float* dst = ring[s & (kGradStages - 1)][0];
      const int q = 4 * tid;
      copy_async_or_zero<16>(dst + q, q < off_a + need ? fa + q : fa, q < off_a + need);
      copy_async_or_zero<16>(dst + kF32RowW + q, q < off_p + need ? fp + q : fp,
                             q < off_p + need);
      if (extra) {
        const int off = extra_pr ? off_p : off_a, qe = 4 * extra_q;
        const float* first = extra_pr ? fp : fa;
        copy_async_or_zero<16>(dst + (extra_pr ? kF32RowW : 0) + qe,
                               qe < off + need ? first + qe : first, qe < off + need);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) stage(s);

  const float* wb = w + static_cast<long long>(blockIdx.y) * 81;
  float wt[81];  // W[j][i], row-major
#pragma unroll
  for (int q = 0; q < 81; ++q) wt[q] = wb[q];
  float acc[kRes];
#pragma unroll
  for (int e = 0; e < kRes; ++e) acc[e] = 0.f;
  // the thread's output columns in the map: c0 + 4·tid + v for v < nvalid
  const int nvalid = min(max(W - 2 - (c0 + kF32Cols * tid), 0), kF32Cols);

  // the window: input row s of la and pr in xa[s % 3], xp[s % 3], columns
  // 4·tid … 4·tid + 5 of the tile
  float xa[3][kF32Cols + 2], xp[3][kF32Cols + 2];
  // step s: row s lands and is read into window slot k (= s % 3)
  auto step = [&](int s, auto slot) {
    constexpr int k = decltype(slot)::value;
    cp_async_wait<kGradStages - 2>();  // this thread's copies of row s landed
    __syncthreads();                   // everyone's did, and row s − 1's slot is free
    stage(s + kGradStages - 1);
    const int e = (r0 + s) * W + c0;
    read6(&ring[s & (kGradStages - 1)][0][kF32Cols * tid], chunk_offset(a, e), xa[k]);
    read6(&ring[s & (kGradStages - 1)][1][kF32Cols * tid], chunk_offset(p, e), xp[k]);
  };
  // an output row whose input rows are in window slots k, k + 1, k + 2 (mod 3)
  auto pixels = [&](auto first) {
    constexpr int k = decltype(first)::value;
#pragma unroll
    for (int v = 0; v < kF32Cols; ++v) {
      if (v < nvalid) {
        float y[9];  // −y_i = Σ_j W[j][i]·z_pr,j − z_la,i
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          float t = -xa[(k + i / 3) % 3][v + i % 3];
#pragma unroll
          for (int j = 0; j < 9; ++j) t = fmaf(wt[j * 9 + i], xp[(k + j / 3) % 3][v + j % 3], t);
          y[i] = t;
        }
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[tri(i, j)] = fmaf(y[i], y[j], acc[tri(i, j)]);
      }
    }
  };
  using S0 = std::integral_constant<int, 0>;
  using S1 = std::integral_constant<int, 1>;
  using S2 = std::integral_constant<int, 2>;
  step(0, S0{});
  step(1, S1{});
  for (int o = 0; o < n_out; o += 3) {  // output rows o, o + 1, o + 2
    step(o + 2, S2{});
    pixels(S0{});
    if (o + 1 == n_out) break;
    step(o + 3, S0{});
    pixels(S1{});
    if (o + 2 == n_out) break;
    step(o + 4, S1{});
    pixels(S2{});
  }
  block_sum_store<kRes, kF32Threads>(
      acc, partial + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kRes);
}

// #6: the lag sums. Index of the lag (ly, lx) of a same-map pair m (0: la·la,
// 1: pr·pr; lags of the half-plane {ly > 0} ∪ {ly = 0, lx ≥ 0}) and of a
// la·pr pair (all 25 lags, anchored at la) among the 51.
constexpr int kLags = 51;
__host__ __device__ constexpr int lag_same(int m, int ly, int lx) {
  return 13 * m + (ly == 0 ? lx : 3 + (ly - 1) * 5 + lx + 2);
}
__host__ __device__ constexpr int lag_cross(int ly, int lx) { return 26 + (ly + 2) * 5 + lx + 2; }

// Entry (i, j) of G18 as a lag sum: its anchor view a (0 … 17), its lag
// (ly, lx) from the anchor to the other view, and that lag's index.
__device__ __forceinline__ void entry_lag(int i, int j, int& a, int& ly, int& lx, int& lag) {
  if (i < j) {
    const int t = i;
    i = j;
    j = t;
  }
  const int mi = i / 9, mj = j / 9, ki = i % 9, kj = j % 9;
  ly = ki / 3 - kj / 3;  // s_ki − s_kj
  lx = ki % 3 - kj % 3;
  if (mi != mj) {  // i ≥ j: i is a pr view, j the la anchor
    a = kj;
    lag = lag_cross(ly, lx);
    return;
  }
  a = 9 * mi + kj;
  if (ly < 0 || (ly == 0 && lx < 0)) {  // anchor at the other view
    ly = -ly;
    lx = -lx;
    a = 9 * mi + ki;
  }
  lag = lag_same(mi, ly, lx);
}

// #6's frame blocks: kGramFrame anchors a block, gathered kGradThreads at a
// time into kGramSlots rows of shared memory (anchor-minor): the 18 views'
// values at the anchor, each zero where x − s_k is not a valid output
// pixel; la at the 13 half-plane lags; pr at all 25 lags (zero off the map).
constexpr int kGramFrame = 256;
constexpr int kGramSlots = 18 + 13 + 25;
constexpr int kGramStride = kGradThreads + 4;  // float4 reads of 8 rows hit 32 banks
constexpr int kGramEntries = (kG18 + kGradThreads - 1) / kGradThreads;  // a thread's entries
constexpr int kGramSmem = kGramSlots * kGramStride > kGradStages * 2 * kGradRowW
                              ? kGramSlots * kGramStride
                              : kGradStages * 2 * kGradRowW;
static_assert(kGramFrame % kGradThreads == 0, "whole chunks of frame anchors");

__device__ __forceinline__ void same_lag(int h, int& ly, int& lx) {  // h: a half-plane lag
  ly = h < 3 ? 0 : 1 + (h - 3) / 5;
  lx = h < 3 ? h : (h - 3) % 5 - 2;
}

// One frame block: out[e] for the 171 entries, each the sum over the block's
// anchors, in frame order, of map_a(x)·map_b(x + l) where x − s_a is valid.
template <bool kBf16>
__device__ __forceinline__ void gram18_frame(const float* __restrict__ a,
                                             const float* __restrict__ p,
                                             float* __restrict__ out, float* smem, int H, int W,
                                             const TileGrid& g) {
  float(*ns)[kGramStride] = reinterpret_cast<float(*)[kGramStride]>(smem);
  const int nh = H - 2, nw = W - 2;
  int sa[kGramEntries], sb[kGramEntries];  // the factors' rows of the thread's entries
#pragma unroll
  for (int q = 0; q < kGramEntries; ++q) {
    const int e = threadIdx.x + q * kGradThreads;
    sa[q] = sb[q] = 0;
    if (e >= kG18) continue;
    int i = 0;  // e = tri(i, j), j ≤ i
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    int av, ly, lx, lag;
    entry_lag(i, e - i * (i + 1) / 2, av, ly, lx, lag);
    sa[q] = av;
    sb[q] = av < 9 && lag < 13 ? 18 + lag : 31 + (ly + 2) * 5 + lx + 2;
  }
  float s[kGramEntries];
#pragma unroll
  for (int q = 0; q < kGramEntries; ++q) s[q] = 0.f;
  auto at = [&](const float* m, int r, int c) {
    return r >= 0 && r < H && c >= 0 && c < W ? operand<kBf16>(m[static_cast<long long>(r) * W + c])
                                              : 0.f;
  };
  const int f0 = blockIdx.x * kGramFrame;
  for (int ch = 0; ch < kGramFrame && f0 + ch < g.frame; ch += kGradThreads) {
    if (ch) __syncthreads();  // the previous anchors are read
    const int f = f0 + ch + threadIdx.x;
    float* col = &ns[0][threadIdx.x];
    if (f < g.frame) {
      int r, c;
      frame_pixel(f, H, W, g.tiles == 0, r, c);
      const float xa = at(a, r, c), xp = at(p, r, c);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int ro = r - k / 3, co = c - k % 3;
        const bool ok = ro >= 0 && ro < nh && co >= 0 && co < nw;
        col[k * kGramStride] = ok ? xa : 0.f;
        col[(9 + k) * kGramStride] = ok ? xp : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 13; ++h) {
        int ly, lx;
        same_lag(h, ly, lx);
        col[(18 + h) * kGramStride] = at(a, r + ly, c + lx);
      }
#pragma unroll
      for (int q = 0; q < 25; ++q)
        col[(31 + q) * kGramStride] = at(p, r + q / 5 - 2, c + q % 5 - 2);
    } else {
#pragma unroll
      for (int q = 0; q < kGramSlots; ++q) col[q * kGramStride] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGramEntries; ++q) {
      if (threadIdx.x + q * kGradThreads >= kG18) break;
      const float4* x = reinterpret_cast<const float4*>(ns[sa[q]]);
      const float4* y = reinterpret_cast<const float4*>(ns[sb[q]]);
      float t = s[q];
#pragma unroll 4
      for (int v = 0; v < kGradThreads / 4; ++v) {
        const float4 u = x[v], w = y[v];
        t = fmaf(u.x, w.x, t);
        t = fmaf(u.y, w.y, t);
        t = fmaf(u.z, w.z, t);
        t = fmaf(u.w, w.w, t);
      }
      s[q] = t;
    }
  }
#pragma unroll
  for (int q = 0; q < kGramEntries; ++q) {
    const int e = threadIdx.x + q * kGradThreads;
    if (e < kG18) out[e] = s[q];
  }
}

// One interior tile: out[51], the tile's lag sums over its anchors.
template <bool kBf16>
__device__ __forceinline__ void gram18_tile(const float* __restrict__ a,
                                            const float* __restrict__ p,
                                            float* __restrict__ out, float* smem, int H, int W,
                                            const TileGrid& g, int tile) {
  constexpr int V = kGradCols;
  float(*ring)[2][kGradRowW] = reinterpret_cast<float(*)[2][kGradRowW]>(smem);
  const int tr = tile / g.ntc;
  const int c0 = (tile - tr * g.ntc) * kGradTileW;  // first staged column
  const int r0 = 2 + tr * kGradTileH;               // first anchor row
  const int n = min(r0 + kGradTileH, H - 2) - r0;   // anchor rows (≥ 1)
  const int n_in = n + 4;                           // input rows r0 − 2, …

  // input row s (map row r0 − 2 + s) into slot s % kGradStages; one commit
  // group per call
  auto stage = [&](int s) {
    if (s < n_in) stage_row<kGradThreads>(ring[s % kGradStages][0], a, p, r0 - 2 + s, c0, W);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) stage(s);

  const int cl = threadIdx.x * V;  // the thread's first column in the tile
  const int c = c0 + 2 + cl;       // ... in the map: its anchor columns c … c + V − 1
  bool in_core[V];
#pragma unroll
  for (int v = 0; v < V; ++v) in_core[v] = c + v < W - 2;
  float acc[kLags];
#pragma unroll
  for (int q = 0; q < kLags; ++q) acc[q] = 0.f;
  // the window: rows t − 1 (index 0) and t − 2 (1); la and pr at the anchor
  // columns (zero past the core), pr at the anchor columns ± 2
  float wa[2][V], wp[2][V], wq[2][V + 4];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
#pragma unroll
    for (int v = 0; v < V; ++v) wa[d][v] = wp[d][v] = 0.f;
#pragma unroll
    for (int j = 0; j < V + 4; ++j) wq[d][j] = 0.f;
  }

  // input row s: the products of row t = r0 − 2 + s with rows t − 2 … t whose
  // anchor row lies in the tile (all of them when kAll)
  auto row = [&](int s, auto all) {
    constexpr bool kAll = decltype(all)::value;
    cp_async_wait<kGradStages - 2>();  // this thread's copies of row s landed
    __syncthreads();                   // everyone's did, and row s − 1's slot is free
    stage(s + kGradStages - 1);
    float xa[V + 4], xp[V + 4];  // row t at columns c − 2 … c + V + 1
    read_staged(ring[s % kGradStages][0] + cl, xa);
    read_staged(ring[s % kGradStages][1] + cl, xp);
    float ta[V], tp[V];  // row t's anchors
#pragma unroll
    for (int q = 0; q < V + 4; ++q) {  // once per value this thread reads
      xa[q] = operand<kBf16>(xa[q]);
      xp[q] = operand<kBf16>(xp[q]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ta[v] = in_core[v] ? xa[v + 2] : 0.f;
      tp[v] = in_core[v] ? xp[v + 2] : 0.f;
    }
    const int u = s - 2;  // row t − r0
    if (kAll || (u >= 0 && u < n)) {  // anchors in row t
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int lx = 0; lx < 3; ++lx) {
          acc[lag_same(0, 0, lx)] = fmaf(ta[v], xa[v + 2 + lx], acc[lag_same(0, 0, lx)]);
          acc[lag_same(1, 0, lx)] = fmaf(tp[v], xp[v + 2 + lx], acc[lag_same(1, 0, lx)]);
        }
#pragma unroll
        for (int lx = -2; lx <= 2; ++lx) {
          acc[lag_cross(0, lx)] = fmaf(ta[v], xp[v + 2 + lx], acc[lag_cross(0, lx)]);
          acc[lag_cross(-1, lx)] = fmaf(ta[v], wq[0][v + 2 + lx], acc[lag_cross(-1, lx)]);
          acc[lag_cross(-2, lx)] = fmaf(ta[v], wq[1][v + 2 + lx], acc[lag_cross(-2, lx)]);
        }
      }
    }
#pragma unroll
    for (int d = 1; d <= 2; ++d) {
      if (kAll || (u >= d && u < n + d)) {  // anchors in row t − d
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int lx = -2; lx <= 2; ++lx) {
            acc[lag_same(0, d, lx)] =
                fmaf(wa[d - 1][v], xa[v + 2 + lx], acc[lag_same(0, d, lx)]);
            acc[lag_same(1, d, lx)] =
                fmaf(wp[d - 1][v], xp[v + 2 + lx], acc[lag_same(1, d, lx)]);
            acc[lag_cross(d, lx)] = fmaf(wa[d - 1][v], xp[v + 2 + lx], acc[lag_cross(d, lx)]);
          }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      wa[1][v] = wa[0][v], wa[0][v] = ta[v];
      wp[1][v] = wp[0][v], wp[0][v] = tp[v];
    }
#pragma unroll
    for (int j = 0; j < V + 4; ++j) wq[1][j] = wq[0][j], wq[0][j] = xp[j];
  };
  int s = 0;
  for (; s < 4; ++s) row(s, std::false_type{});  // the halo rows and the first two
  for (; s < n + 2; ++s) row(s, std::true_type{});
  for (; s < n_in; ++s) row(s, std::false_type{});  // the last two and the halo rows
  block_sum_store<kLags, kGradThreads>(acc, out);
}

// #6's first pass: per map, one row of 171 sums per frame block, then one
// row of the 51 lag sums per interior tile (the scratch layout of
// gram18_scratch).
template <bool kBf16>
__global__ void __launch_bounds__(kGradThreads, kGradMinBlocks) gram18_kernel(
    const float* __restrict__ la, const float* __restrict__ pr, float* __restrict__ partial,
    int H, int W, TileGrid g, int scratch) {
  __shared__ __align__(16) float smem[kGramSmem];
  const long long map = static_cast<long long>(blockIdx.y) * H * W;
  float* part = partial + static_cast<long long>(blockIdx.y) * scratch;
  const int frame_blocks = g.blocks - g.tiles;
  if (static_cast<int>(blockIdx.x) < frame_blocks) {
    gram18_frame<kBf16>(la + map, pr + map, part + blockIdx.x * kG18, smem, H, W, g);
  } else {
    const int tile = blockIdx.x - frame_blocks;
    gram18_tile<kBf16>(la + map, pr + map, part + frame_blocks * kG18 + tile * kLags, smem, H, W,
                       g, tile);
  }
}

// #6's finish, one block per map: each lag's tile rows added in tile order,
// each entry's frame rows in frame block order, then both triangles of
// G18 as (lag sum) + (frame sum).
__global__ void __launch_bounds__(256) gram18_finish_kernel(const float* __restrict__ partial,
                                                            float* __restrict__ out, TileGrid g,
                                                            int scratch) {
  __shared__ float lag_sum[kLags], frame_sum[kG18];
  const float* base = partial + static_cast<long long>(blockIdx.x) * scratch;
  const int frame_blocks = g.blocks - g.tiles;
  const int t = threadIdx.x;
  if (t < kLags) {
    const float* src = base + frame_blocks * kG18 + t;
    float s = 0.f;
    for (int b = 0; b < g.tiles; ++b) s += src[b * kLags];
    lag_sum[t] = s;
  } else if (t < kLags + kG18) {
    const float* src = base + (t - kLags);
    float s = 0.f;
    for (int b = 0; b < frame_blocks; ++b) s += src[b * kG18];
    frame_sum[t - kLags] = s;
  }
  __syncthreads();
  for (int ij = t; ij < 18 * 18; ij += blockDim.x) {
    const int i = ij / 18, j = ij % 18;
    int av, ly, lx, lag;
    entry_lag(i, j, av, ly, lx, lag);
    out[static_cast<long long>(blockIdx.x) * 18 * 18 + ij] =
        lag_sum[lag] + frame_sum[i >= j ? tri(i, j) : tri(j, i)];
  }
}

// Floats of #6's partial sums per map (must equal the wrapper's count).
inline int gram18_scratch(const TileGrid& g) {
  return (g.blocks - g.tiles) * kG18 + g.tiles * kLags;
}

// Tiles of #7 and #7f per map, one partial row each (must equal the
// wrapper's count).
inline int residual_tiles(int H, int W) {
  return ((W - 2 + kResTileW - 1) / kResTileW) * ((H - 2 + kResTileH - 1) / kResTileH);
}

// The shapes every entry takes (ops/rmi_gram.py `kernel_shape_ok` holds the
// same limits): at most 65535 maps (gridDim.y) and maps of fewer than 2^31
// floats (32-bit offsets within a map), which also bounds every grid's x.
inline bool shape_ok(int BC, int H, int W) {
  return BC >= 0 && BC <= 65535 && H >= 3 && W >= 3 &&
         static_cast<long long>(H) * W < (1LL << 31);
}

}  // namespace
}  // namespace seghiero

// la, pr: [BC, H, W] f32 contiguous; partial: [BC, scratch] f32 with
// scratch = gram18_scratch (the wrapper allocates it: 171 floats per frame
// block of 256 frame anchors, 51 per interior tile of 32 × 256); g18:
// [BC, 18, 18] f32; bf16: 0 for #6, 1 for #6f (bf16 views). Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the kernels do not
// take, a scratch size that does not match or a bf16 flag other than 0 or 1).
extern "C" int seghiero_rmi_gram18(const void* la, const void* pr, void* partial, void* g18,
                                   int BC, int H, int W, int scratch, int bf16, int device,
                                   void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(BC, H, W)) return cudaErrorInvalidValue;
  const TileGrid g = tile_grid(H, W, kGramFrame);
  if (scratch != gram18_scratch(g)) return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = bf16 ? gram18_kernel<true> : gram18_kernel<false>;
  kernel<<<dim3(g.blocks, BC), kGradThreads, 0, s>>>(static_cast<const float*>(la),
                                                      static_cast<const float*>(pr),
                                                      static_cast<float*>(partial), H, W, g,
                                                      scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram18_finish_kernel<<<BC, 256, 0, s>>>(static_cast<const float*>(partial),
                                          static_cast<float*>(g18), g, scratch);
  return cudaGetLastError();
}

// la, pr: [BC, H, W] f32 contiguous; w: [BC, 9, 9] f32 (the regression W,
// so y = z_la − Wᵀ·z_pr); partial: [BC, nblk, 45] f32 scratch (the wrapper
// allocates it) with nblk = residual_tiles (ceil((W−2)/256)·ceil((H−2)/32));
// a: [BC, 9, 9] f32; bf16: 0 for #7, 1 for #7f. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape the kernels do not take, an nblk that
// does not match or a bf16 flag other than 0 or 1).
extern "C" int seghiero_rmi_residual(const void* la, const void* pr, const void* w,
                                     void* partial, void* a, int BC, int H, int W, int nblk,
                                     int bf16, int device, void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(BC, H, W) || nblk != residual_tiles(H, W)) return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* la_f = static_cast<const float*>(la);
  const auto* pr_f = static_cast<const float*>(pr);
  const auto* w_f = static_cast<const float*>(w);
  auto* part = static_cast<float*>(partial);
  const int ntc = (W - 2 + kResTileW - 1) / kResTileW;
  if (bf16)
    residual_mma_kernel<<<dim3(nblk, BC), kResThreads, 0, s>>>(la_f, pr_f, w_f, part, H, W, ntc);
  else
    residual_f32_kernel<<<dim3(nblk, BC), kF32Threads, 0, s>>>(la_f, pr_f, w_f, part, H, W, ntc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_finish_kernel<9><<<blocks_for(static_cast<long long>(BC) * 81, 256), 256, 0, s>>>(
      part, static_cast<float*>(a), BC, nblk);
  return cudaGetLastError();
}

// la, pr: [BC, H, W] f32 contiguous; p: [BC, 9, 18] f32; dpr: [BC, H, W]
// f32, every pixel written once; bf16: 0 for #8, 1 for #8f.
extern "C" int seghiero_rmi_grad_maps(const void* la, const void* pr, const void* p, void* dpr,
                                      int BC, int H, int W, int bf16, int device, void* stream) {
  using namespace seghiero;
  if (bf16 != 0 && bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!shape_ok(BC, H, W)) return cudaErrorInvalidValue;
  if (BC == 0) return cudaSuccess;
  const TileGrid g = tile_grid(H, W, kGradThreads * kFramePix);
  auto* kernel = bf16 ? grad_maps_kernel<true> : grad_maps_kernel<false>;
  kernel<<<dim3(g.blocks, BC), kGradThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(pr),
      static_cast<const float*>(p), static_cast<float*>(dpr), H, W, g);
  return cudaGetLastError();
}
