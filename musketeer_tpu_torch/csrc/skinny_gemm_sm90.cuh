// The weight-streaming tensor-core product of K7 and K2: a few activation
// rows (the beam rows of a decode step) against a large bf16 weight, on
// Hopper's wgmma fed by TMA.
//
// Y^T = W . X^T ("swap AB"): W [dout, din] bf16, whose rows are already the
// K-major A operand, takes wgmma's M place (64 output columns per m64 tile);
// X [rows, din] bf16, the K-major B operand, takes the N place. N is the row
// tile, one of 16, 32, 48 and 80 (TMA zero-fills the rows past the end; more
// rows than 80 loop over row tiles), so the accumulator is N / 2 fp32
// registers a thread per m64 tile.
//
// A CTA is one consumer warpgroup and one producer warp. The producer
// streams 64 x 64 W tiles (8 KB; K2: 128 x 64) by TMA, 128-byte swizzled,
// through a ring of STAGES stages with a "full" and an "empty" mbarrier
// each, and copies the CTA's X slice once, by TMA in the same swizzled
// layout (16-byte unit u of row r at unit u ^ (r % 8)), behind its own
// mbarrier.
//
// gemm_kernel (K7's six products) fills the card with split-K: grid (m64
// tiles, splits, row tiles), each split a run of 64-deep chunks (the last
// may be shorter). With more than one split, each CTA writes its fp32
// partial in the accumulator's own layout (one float4 per thread and four
// registers, coalesced), and the last CTA of a tile to arrive (a per-tile
// counter, reset by that CTA) adds the partials in split order: one fp32 sum
// per element, the same whichever CTA arrives last; no atomics on values.
// The epilogue is a template parameter: it loads each output element's other
// inputs (all first, so the loads overlap), then takes the fp32 sum and
// returns the value it stores.
//
// LayerNorm. A product with a LayerNorm before it normalises its X slice in
// shared memory after the copy (fp32, eps 1e-5, rounded to bf16). The row
// statistics come from the product that wrote X: its epilogue leaves, per
// 64-column tile and row, the sum and the sum of squares of the values it
// stored (stats_out); the LayerNorm adds the tiles in order, mean = S / K,
// var = S2 / K - mean^2. So no CTA reads whole rows of X.
//
// Launch. The producer issues its first weight copies before the kernel
// waits on the previous one (programmatic dependent launch, grid_wait):
// weights depend on nothing the previous kernel writes; X, the statistics,
// the partials and the counters are touched only after the wait.
//
// K2's persistent kernels (topk_projection.cu) are built from the same
// pieces: the ring, the X copy and mma_chunk at two m64 tiles a stage; K2-q8
// streams int8 W stages (128 rows x 128 deep, 16 KB) through the same ring
// and widens them in registers into wgmma's A fragments (mma_stage_i8), with
// X rearranged once to match (permute_x_i8).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace mk {
namespace skinny {

using bf16 = __nv_bfloat16;


constexpr int BM = 64;                    // W rows (output columns) of one m64 tile
constexpr int BKC = 64;                   // depth of a chunk: one 128-byte swizzled row
constexpr int STAGES = 4;                 // ring depth
constexpr int NC = 128;                   // consumer threads: one warpgroup (K2's kernel)
constexpr int NT = NC + 32;               // + the producer warp
constexpr int GWGS = 2;                   // gemm_kernel's consumer warpgroups, N / 2 rows each
constexpr int GNC = GWGS * NC;            // its consumer threads
constexpr int GNT = GNC + 32;             // + the producer warp
constexpr uint32_t WTILE = BM * BKC * 2;  // bytes of one 64 x 64 bf16 W tile
constexpr int MAX_CPS = 16;               // chunks of one split

// shared-memory bytes of an N-row X tile of one 64-deep chunk
template <int N>
__host__ __device__ constexpr uint32_t x_chunk_bytes() {
  return N * 128;
}

// acc += W tile (64 rows at wt) . X chunk (N rows at xc)^T: four k-steps of 16
template <int N>
__device__ __forceinline__ void mma_chunk(float (&acc)[N / 2], uint32_t wt, uint32_t xc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::Wgmma<N>::ss(acc, sm90::sw128_desc(wt + 32 * kk), sm90::sw128_desc(xc + 32 * kk), 1);
}

// ---- int8 W: A fragments from registers ----------------------------------
//
// An int8 W tile cannot be wgmma's shared-memory A operand (an int8 product
// would need X in int8). The consumers load it, widen it exactly to bf16 in
// registers (sm90::widen_i8x4) and issue wgmma with A from registers; the
// products and their fp32 sums are those of the bf16 route.
//
// Lane (g, t) of warp w holds, for A rows 16 w + g and + 8 of an m64 half,
// the k-slots 2t, 2t+1 and 2t+8, 2t+9 of each 16-deep k-step j. Taking them
// from the row's bytes 32 t + 4 j .. + 3 (one word; two 16-byte loads a row
// a stage) permutes the depth inside each 128-deep group: k-slot 16 j + s is
// depth 32 t + 4 j + e with t = (s % 8) / 2, e = s % 2 + 2 (s / 8). The same
// permutation applied to X, once, leaves every product unchanged. As 32-bit
// words (bf16 pairs): word 8 j + 4 hh + t of a group is X's word
// 16 t + 2 j + hh.

constexpr int BKQ = 128;  // depth of an int8 stage: one 128-byte swizzled row

// Rearranges the staged X (at x, generic; chunk tiles of N rows x 64 deep) for
// int8 stages, in place: nst groups of two chunks a row, chunks from nx on (past
// the depth, never copied) set to zeros. The caller fences and synchronises.
template <int N, int THREADS>
__device__ __forceinline__ void permute_x_i8(uint8_t* x, int nst, int nx, int tid) {
  for (int u = tid; u < N * nst; u += THREADS) {
    const int r = u / nst, c = u % nst;
    uint8_t* row = x + (r / 8) * 1024 + (r % 8) * 128;
    uint32_t w[64], o[64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ch = 2 * c + h;
        const uint4 v = ch < nx ? *reinterpret_cast<const uint4*>(
                                      row + ch * x_chunk_bytes<N>() + ((q ^ (r % 8)) * 16))
                                : make_uint4(0u, 0u, 0u, 0u);
        w[32 * h + 4 * q] = v.x;
        w[32 * h + 4 * q + 1] = v.y;
        w[32 * h + 4 * q + 2] = v.z;
        w[32 * h + 4 * q + 3] = v.w;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int t = 0; t < 4; ++t) o[8 * j + 4 * hh + t] = w[16 * t + 2 * j + hh];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<uint4*>(row + (2 * c + h) * x_chunk_bytes<N>() +
                                  ((q ^ (r % 8)) * 16)) =
            make_uint4(o[32 * h + 4 * q], o[32 * h + 4 * q + 1], o[32 * h + 4 * q + 2],
                       o[32 * h + 4 * q + 3]);
  }
}

// acc[hf] += W rows 64 hf .. 64 hf + 63 of the int8 stage at wt (128 rows x 128
// deep, 128-byte swizzled) . the X group at xc (two permuted chunks of N rows)^T.
// Loads the stage, arrives on empty_bar, then per half waits for the group
// that last read its fragments (the previous stage's same half: at most one
// group left running), widens into them and issues and commits its eight
// wgmma. So each half's widening overlaps the other half's products, across
// stages too; a (the fragments) lives across the caller's stages, and the
// caller waits for every group before reading acc. kRelease false: no
// arrival on empty_bar, for a stage whose X group the products still read
// (the caller waits for them and then releases the stage).
template <int N, bool kRelease = true>
__device__ __forceinline__ void mma_stage_i8(float (&acc)[2][N / 2], uint32_t (&a)[2][8][4],
                                             const uint8_t* wt, uint32_t xc, uint32_t empty_bar,
                                             int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  uint4 v[2][2][2];  // [half][row R, R + 8][16-byte unit 2t, 2t + 1]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint8_t* row = wt + (64 * hf + 16 * warp + g) * 128;  // R % 8 == g
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        v[hf][rr][k] =
            *reinterpret_cast<const uint4*>(row + rr * 1024 + (((2 * t + k) ^ g) * 16));
  }
  if constexpr (kRelease) sm90::mbar_arrive(empty_bar);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sm90::wgmma_wait_n<1>();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4& p = v[hf][0][j / 4];
      const uint4& q = v[hf][1][j / 4];
      const uint32_t w0 = j % 4 == 0 ? p.x : j % 4 == 1 ? p.y : j % 4 == 2 ? p.z : p.w;
      const uint32_t w1 = j % 4 == 0 ? q.x : j % 4 == 1 ? q.y : j % 4 == 2 ? q.z : q.w;
      sm90::widen_i8x4(w0, a[hf][j][0], a[hf][j][2]);
      sm90::widen_i8x4(w1, a[hf][j][1], a[hf][j][3]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sm90::Wgmma<N>::rs(acc[hf], a[hf][j][0], a[hf][j][1], a[hf][j][2], a[hf][j][3],
                         sm90::sw128_desc(xc + (j / 4) * x_chunk_bytes<N>() + 32 * (j % 4)));
    sm90::wgmma_commit();
  }
}

// Accumulator position i of this thread: output column (within the m64
// tile) and row (within the row tile).
__device__ __forceinline__ int acc_col(int i, int tid) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_row(int i, int tid) {
  return 8 * (i / 4) + 2 * (tid % 4) + (i % 2);
}

// Copies X rows [r0, r0 + N) x depth [k0, k0 + 64 n) as n chunk tiles of
// N x 128 bytes at xs, announcing them on bar (one thread).
template <int N>
__device__ __forceinline__ void load_x(uint32_t xs, const CUtensorMap* xmap, uint32_t bar, int r0,
                                       int k0, int n) {
  sm90::mbar_expect_tx(bar, n * x_chunk_bytes<N>());
  for (int c = 0; c < n; ++c)
    sm90::tma_load3(xs + c * x_chunk_bytes<N>(), xmap, bar, k0 + c * BKC, r0, 0);
}

// The LayerNorm of the staged X slice (at x, generic), in place: rows below
// `live`, chunk tiles of n, g and b the slice's scale and bias in shared memory.
template <int N, int THREADS>
__device__ __forceinline__ void ln_in_place(uint8_t* x, int n, int live, const float* mu,
                                            const float* rstd, const float* g, const float* b,
                                            int tid) {
#pragma unroll 2
  for (int u = tid; u < N * 8 * n; u += THREADS) {
    const int r = u / (8 * n), ku = u % (8 * n), c = ku / 8, q = ku % 8;
    if (r >= live) continue;
    uint4* p = reinterpret_cast<uint4*>(x + c * x_chunk_bytes<N>() + (r / 8) * 1024 +
                                        (r % 8) * 128 + ((q ^ (r % 8)) * 16));
    const uint4 v = *p;
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float m = mu[r], rs = rstd[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * ku + 2 * i;
      const float lo = (__uint_as_float(w[i] << 16) - m) * rs * g[k] + b[k];
      const float hi = (__uint_as_float(w[i] & 0xffff0000u) - m) * rs * g[k + 1] + b[k + 1];
      w[i] = sm90::pack_bf16(lo, hi);
    }
    *p = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct LnArgs {
  const float* g;      // [K] fp32 scale, or nullptr: no LayerNorm
  const float* b;      // [K] fp32 bias
  const float* stats;  // [tiles][rows][2]: each 64-column tile's sum and sum of squares
  int tiles;
};

// Y = epi(LN?(X) . W[layer]^T) for the rows of X; see the top of the file.
// Two consumer warpgroups, each wgmma N = N / 2 of the rows (so that the
// epilogue, latency-bound at one warp a scheduler, has twice the warps).
// wmap: W as a [L, dout, din] map with 64 x 64 boxes; xmap: X as a
// [1, rows, din] map with 64 x N boxes. part: fp32 split-K partials;
// counters: one int per (row tile, m64 tile), zero on entry and on exit.
// stats_out (or nullptr): [m64 tiles][rows][2] of the stored values.
// Epi: `Pre load(int row, int col) const` (the element's other inputs) and
// `float operator()(int row, int col, float sum, Pre) const` (stores the
// element, returns the stored value).
template <int N, class Epi>
__global__ void __launch_bounds__(GNT) gemm_kernel(const __grid_constant__ CUtensorMap wmap,
                                                   const __grid_constant__ CUtensorMap xmap,
                                                   int layer, LnArgs ln, int rows, int dout,
                                                   int K, int cps, int nch,
                                                   float* __restrict__ part,
                                                   int* __restrict__ counters,
                                                   float* __restrict__ stats_out, Epi epi) {
  constexpr int NW = N / GWGS;  // rows of a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base, xs = base + STAGES * WTILE;
  const uint32_t bars = xs + cps * x_chunk_bytes<N>();
  float* mu = reinterpret_cast<float*>(smem_raw + (bars + 8 * (2 * STAGES + 2) - raw));
  float* rstd = mu + N;
  float* gs = rstd + N;         // [cps * 64] the slice's LayerNorm scale
  float* bs = gs + cps * BKC;   // [cps * 64] and bias
  float* red = bs + cps * BKC;  // [GWGS * 4 warps][NW][2] per-warp row sums
  int* last = reinterpret_cast<int*>(red + 8 * N);
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  const uint32_t xbar = bars + 8u * (2 * STAGES);

  const int mt = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * N;
  const int c0 = split * cps, n = min(cps, nch - c0);  // this split's chunks
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), GNC);
    }
    sm90::mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  sm90::launch_dependents();

  if (tid >= GNC) {  // the producer warp
    if (tid == GNC) {
      const int pre = min(n, STAGES);
      for (int c = 0; c < pre; ++c) {  // weights: before the wait
        sm90::mbar_expect_tx(full(c), WTILE);
        sm90::tma_load3(ring + c * WTILE, &wmap, full(c), (c0 + c) * BKC, mt * BM, layer);
      }
      sm90::grid_wait();  // X is the previous kernels'
      load_x<N>(xs, &xmap, xbar, r0, c0 * BKC, n);
      for (int c = pre; c < n; ++c) {
        const int st = c % STAGES;
        sm90::mbar_wait(empty(st), (c / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(st), WTILE);
        sm90::tma_load3(ring + st * WTILE, &wmap, full(st), (c0 + c) * BKC, mt * BM, layer);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int wg = tid / NC, wt = tid % NC;  // warpgroup, thread within it
  const int rw = r0 + wg * NW;             // the warpgroup's first row
  if (ln.g != nullptr) {  // the slice's scale and bias (constants: before the wait)
    const int k0 = c0 * BKC, live = min(n * BKC, K - k0);
    sm90::copy_f32(gs, ln.g + k0, live, n * BKC, tid, GNC);
    sm90::copy_f32(bs, ln.b + k0, live, n * BKC, tid, GNC);
  }
  sm90::grid_wait();  // part, counters and the statistics are the previous kernels'
  // the epilogue's other inputs (bias, residual) for every element, loaded
  // now so that their latency hides under the copies and the products
  typename Epi::Pre pre[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int col = mt * BM + acc_col(i, wt), row = rw + acc_row(i, wt);
    if (row < rows && col < dout) pre[i] = epi.load(row, col);
  }
  if (ln.g != nullptr) {
    if (tid < N) {  // row tid: the tiles' sums in order
      const int row = r0 + tid;
      float s = 0.f, s2 = 0.f;
      if (row < rows)
        for (int t0 = 0; t0 < ln.tiles; t0 += 8) {  // 8 loads in flight, then the sums in order
          float2 v[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (t0 + t < ln.tiles)
              v[t] = *reinterpret_cast<const float2*>(ln.stats +
                                                      2 * ((long long)(t0 + t) * rows + row));
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (t0 + t < ln.tiles) {
              s += v[t].x;
              s2 += v[t].y;
            }
        }
      const float mean = s / K;
      mu[tid] = mean;
      rstd[tid] = rsqrtf(fmaxf(s2 / K - mean * mean, 0.f) + 1e-5f);
    }
    sm90::named_sync(1, GNC);
    sm90::mbar_wait(xbar, 0);
    ln_in_place<N, GNC>(smem_raw + (xs - raw), n, rows - r0, mu, rstd, gs, bs, tid);
    sm90::fence_async_smem();
    sm90::named_sync(1, GNC);
  } else {
    sm90::mbar_wait(xbar, 0);
  }

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < n; ++c) {
    const int st = c % STAGES;
    sm90::mbar_wait(full(st), (c / STAGES) & 1);
    sm90::wgmma_fence();
    mma_chunk<NW>(acc, ring + st * WTILE, xs + c * x_chunk_bytes<N>() + wg * x_chunk_bytes<NW>());
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(empty(st));
  }

  const long long tile = (long long)blockIdx.z * gridDim.x + mt;
  if (gridDim.y > 1) {  // split-K: the last CTA of the tile sums the partials in order
    // a split's partial: N x 64 floats, the warpgroups' halves one after the other,
    // each one float4 per thread and four accumulator registers
    auto at = [&](int sp, int g) {
      return (((tile * gridDim.y + sp) * GWGS + wg) * (NW / 8) + g) * NC + wt;
    };
    float4* p4 = reinterpret_cast<float4*>(part);
#pragma unroll
    for (int g = 0; g < NW / 8; ++g)
      p4[at(split, g)] = make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
    __threadfence();
    sm90::named_sync(1, GNC);
    if (tid == 0) *last = atomicAdd(&counters[tile], 1) == (int)gridDim.y - 1;
    sm90::named_sync(1, GNC);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; sp += 2) {  // two splits' loads in flight, then
      float4 t[2][NW / 8];                              // their sums in split order
      const bool two = sp + 1 < (int)gridDim.y;
#pragma unroll
      for (int g = 0; g < NW / 8; ++g) {
        t[0][g] = __ldcg(p4 + at(sp, g));
        if (two) t[1][g] = __ldcg(p4 + at(sp + 1, g));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < NW / 8; ++g)
          if (h == 0 || two) {
            acc[4 * g] += t[h][g].x;
            acc[4 * g + 1] += t[h][g].y;
            acc[4 * g + 2] += t[h][g].z;
            acc[4 * g + 3] += t[h][g].w;
          }
    }
    if (tid == 0) counters[tile] = 0;
  }
  // the epilogue; with stats_out, each row's sum and sum of squares over the tile
  const int warp = wt / 32, lane = wt % 32;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh + e;
        const int col = mt * BM + acc_col(i, wt), row = rw + acc_row(i, wt);
        if (row < rows && col < dout) {
          const float v = epi(row, col, acc[i], pre[i]);
          s += v;
          s2 += v * v;
        }
      }
      if (stats_out != nullptr) {
#pragma unroll
        for (int o = 4; o < 32; o *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane < 4) {
          const int r = acc_row(4 * j + e, wt);
          red[2 * ((wg * 4 + warp) * NW + r)] = s;
          red[2 * ((wg * 4 + warp) * NW + r) + 1] = s2;
        }
      }
    }
  if (stats_out != nullptr) {
    sm90::named_sync(1, GNC);
    if (tid < N && r0 + tid < rows) {  // row tid: its warpgroup's 4 warps in order
      const float* q = red + 2 * ((tid / NW) * 4 * NW + tid % NW);
      float2 v;
      v.x = (q[0] + q[2 * NW]) + (q[4 * NW] + q[6 * NW]);
      v.y = (q[1] + q[2 * NW + 1]) + (q[4 * NW + 1] + q[6 * NW + 1]);
      *reinterpret_cast<float2*>(stats_out + 2 * ((long long)mt * rows + r0 + tid)) = v;
    }
  }
}

template <int N>
constexpr size_t gemm_smem(int cps) {
  return 1024 + STAGES * WTILE + (size_t)cps * x_chunk_bytes<N>() + 8 * (2 * STAGES + 2) +
         sizeof(float) * (2 * N + 2 * cps * BKC + 8 * N) + 16;
}

// Calls f(std::integral_constant<int, N>) for a row tile N of 16, 32, 48 or
// 80; any other N is cudaErrorInvalidValue.
template <class F>
int with_row_tile(int n, F&& f) {
  switch (n) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 80: return f(std::integral_constant<int, 80>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// W [L, dout, din] bf16 as a map of 64-deep boxes of `box_rows` rows.
inline int weight_map(CUtensorMap* map, const void* w, int L, int dout, int din, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)din, (cuuint64_t)dout, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)din * 2, (cuuint64_t)dout * din * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BKC, (cuuint32_t)box_rows, 1};
  return sm90::bf16_map(map, w, 3, dims, strides, box);
}

// W [L, dout, din] int8 as a map of 128-deep boxes (one 128-byte swizzled row)
// of `box_rows` rows.
inline int weight_map_i8(CUtensorMap* map, const void* w, int L, int dout, int din,
                         int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)din, (cuuint64_t)dout, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)din, (cuuint64_t)dout * din};
  const cuuint32_t box[3] = {(cuuint32_t)BKQ, (cuuint32_t)box_rows, 1};
  return sm90::tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launches gemm_kernel<N, Epi> with programmatic stream serialization (pdl)
// on `stream`: row tile N, `cps` chunks per split. Returns a cudaError_t code.
template <int N, class Epi>
int launch_gemm(const CUtensorMap& wmap, const CUtensorMap& xmap, int layer, const LnArgs& ln,
                int rows, int dout, int K, int cps, float* part, int* counters, float* stats_out,
                const Epi& epi, int pdl, cudaStream_t stream) {
  const int nch = (K + BKC - 1) / BKC;
  if (cps < 1 || cps > MAX_CPS || K % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((dout + BM - 1) / BM, (nch + cps - 1) / cps, (rows + N - 1) / N);
  const size_t smem = gemm_smem<N>(cps);
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)gemm_kernel<N, Epi>, smem)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_kernel<N, Epi>, wmap, xmap, layer, ln,
                                             rows, dout, K, cps, nch, part, counters, stats_out,
                                             epi);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace skinny
}  // namespace mk

