// K7's beam-shared cross-attention in bf16 on Hopper: the sample's [S, D] K
// and V rows streamed by TMA, the products on the tensor cores (mma.sync
// m16n8k16). The tile width DP is a template parameter, compiled at 32, 64,
// 80, 128, 192 and 256; a head dim D runs on the smallest DP >= D
// (common.cuh::with_head_dim), D itself an argument.
// K6's cross-attention over the int8 cache (decode_cross_attn.cu) takes
// this layout and the primitives it shares from sm90.cuh.
//
// For the Kb beams j of sample b and head h, over the sample's S keys, with
// the TPU kernel's numerics (musketeer_tpu/ops/decode_stack.py::_kernel's
// cross block; the pads folded into the bias as -1e9):
//   w[j, s] = q[j] . k[s] + bias[s]            fp32 sums of bf16 products
//   p[j, s] = round_bf16(exp(w - max_s w) / sum_s exp(w - max_s w))
//   out[j]  = round_bf16(sum_s p[j, s] v[s])   fp32 sums
// as cross_attn.cuh computes it, exact two-pass softmax included.
//
// Design. One CTA per (h, b, beam tile): a tile is 16 beams (a sample's
// beams past 16 take more tiles, each reading the sample's K/V again, mostly
// from L2). A producer warp streams the S / 64 key tiles
// and then the S / 64 value tiles (64 x DP bf16 in sm90.cuh::HeadTile's
// boxes: 8 KB at DP 64, 16 KB at 128, 32 KB at 256; zeros past S and past
// the cache's row width) through a ring of stages<DP>() stages (8 up to DP
// 128, 8 x 128 / DP past it: 5 at 192, 4 at 256, so the ring stays 128 KB);
// one consumer warpgroup.
//   - Scores: q (the Kb beam rows, padded to 16 with zeros, its columns past
//     D zeros) is the A operand, held in registers for the whole walk (DP / 16
//     k-steps); each of the 8
//     warps takes 8 keys of a tile (one n8 block), the B fragments read as
//     4-byte pairs straight from the swizzled rows (conflict-free). Scores +
//     the bias row (staged in shared memory) go to shared memory, fp32
//     [Kb][S].
//   - Softmax: one warp per beam over the row in shared memory; p rounded
//     to bf16 into [Kb][S'] (zeros from S to the tile end).
//   - P.v: A = p (its rows from shared memory), B = the value tile read by
//     ldmatrix.trans (key-major rows are B's k); warp w owns the n8 column
//     blocks w + 8 n < DP / 8 (at DP 64 one block each, at 128 two, at 256
//     four; at 80 warps 0 and 1 also own columns 64..79, at 32 warps 0..3
//     one block, at 192 three each),
//     accumulating in fp32 registers across all tiles; the columns past D
//     are stored nowhere. The cache's rows are D wide, or D rounded up to a
//     multiple of 8 (zeros; a wrapper's padded copy); q and the output keep
//     the model's head stride D, read and written in bf16 pairs where
//     aligned, else element by element.
// The score-chunked route (kChunked), where the whole row's scores do not
// fit in shared memory (16 beams at S ~1600 and more, 5 at ~4800): a first
// pass over the K tiles keeps each row's max and sum of exp (a key at a time
// in the lane, rescaled as the max moves, then the lanes of a quad and the
// 8 warps, common.cuh::softmax_merge); a second pass streams K and V tiles in
// turn, computes each tile's scores again (the same products, the same
// values), p = exp(w - m) / l rounded to bf16 into one of two 16 x 64 P
// tiles, and adds P.v as the whole-row route does. The bias row is read
// from global memory a tile at a time. The same formula, the sum l taken in
// another order; K is read twice.
// Eight warps rather than four: the softmax and the per-tile work are
// latency-bound chains, and one warp a scheduler leaves them exposed.
// The value tiles arrive while the softmax runs. Launched with programmatic
// stream serialization: the K/V copies (the cache, written before the step)
// start before the kernel waits for the cross-q product.
//
// Past DP 256 (the deep route, DP == DEEP: any D a multiple of 8): 64 x 128
// tiles on the instance 128's ring of 8; a key tile's scores sum its
// ceil(D / 128) chunk tiles' products in order, q's fragments of each chunk
// loaded as it comes, and a CTA owns one 128-column block of the output
// (grid z = beam tiles x blocks), reading the sample's K tiles again for
// each block (mostly from L2). ptxas (CUDA 12.8): 64 registers, 92 chunked,
// no spills.
//
// Bound: the cross K/V, 2 x S x D x 2 bytes per (b, h), 268 MB a step at
// the caption decode shape (rows 80, L6, H12, S908, D64), 80 us at 3.35
// TB/s; 893 MB at ofa_huge's (L12, H16, D80), 267 us. ptxas (CUDA 12.8): no
// spills up to DP 192 (88 registers whole-row, 131 / 156 chunked at 192); at
// 256 96 and 146 / 168, with 8 and 68 bytes of spill where D == DP
// (chip_smoke.py's build phase prints each one's registers). Where D == DP
// the compiler knows D (kExact): with D and the
// tile addressing left to run time, this kernel ran 1.6x longer at DP 80.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace mk {
namespace decode_attn {

using bf16 = __nv_bfloat16;

constexpr int BKT = 64;                 // keys per tile
constexpr int NC = 256;                 // consumer threads: two warpgroups, 8 warps
constexpr int NT = NC + 32;             // + the producer warp
constexpr int MAX_KB = 16;              // beams of a tile: one m16 A tile
constexpr int PT = BKT + 8;             // a chunked P tile's row stride (bf16)
constexpr size_t MAX_SMEM = 232448;     // a block's shared memory on sm_90

// a tile's columns: the instance's, or on the deep route (DP == DEEP) a chunk's
template <int DP>
__host__ __device__ constexpr int tile_width() {
  return DP == DEEP ? DEEP_CHUNK : DP;
}

template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes() {  // one 64 x DP bf16 tile: every box
  return sm90::HeadTile<tile_width<DP>()>::BYTES;
}

// the ring's depth: 8 (the value tiles arrive during the softmax) up to DP
// 128 (and on the deep route), then as many as 8 tiles of 128 columns take
template <int DP>
__host__ __device__ constexpr int stages() {
  return DP <= 128 ? 8 : 8 * 128 / DP;
}

struct Args {
  const bf16* q;      // [B * Kb, H * D]: row b * Kb + j, columns h * D ..
  const float* bias;  // [B, H, S]
  bf16* out;          // in q's layout
  int B, H, Kb, S, layer, D;
};

// the whole-row route at Kb beams of a tile: the ring, the mbarriers, the
// fp32 scores and bias row, the bf16 probabilities
template <int DP>
inline size_t smem_bytes(int Kb, int S) {
  const int sp = (S + BKT - 1) / BKT * BKT;
  return 1024 + stages<DP>() * tile_bytes<DP>() + 16 * stages<DP>() +
         sizeof(float) * ((size_t)Kb * sp + sp) + 2 * (size_t)Kb * (sp + 8);
}

// the score-chunked route, at any S: the ring, the mbarriers, two bf16 P
// tiles [16][PT], the warps' row maxes and sums [8][16][2] fp32
template <int DP>
constexpr size_t smem_bytes_chunked() {
  return 1024 + stages<DP>() * tile_bytes<DP>() + 16 * stages<DP>() + 2 * 2 * MAX_KB * PT +
         sizeof(float) * 2 * (NC / 32) * MAX_KB;
}

// The layer-stacked cross cache's tensor maps: k and v's 64-column boxes, and
// their 16-column ones (sm90.cuh::head_maps).
struct CacheMaps {
  CUtensorMap k, v, k_hi, v_hi;
};

using sm90::lds32;
using sm90::mma16816;

// two adjacent bf16 of a row of n elements from column c (zeros past n), one
// 4-byte load where aligned
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int c, int n) {
  if (c + 1 < n && (reinterpret_cast<uintptr_t>(p + c) & 3u) == 0)
    return *reinterpret_cast<const uint32_t*>(p + c);
  const uint32_t lo = c < n ? __bfloat16_as_ushort(p[c]) : 0u;
  const uint32_t hi = c + 1 < n ? __bfloat16_as_ushort(p[c + 1]) : 0u;
  return lo | (hi << 16);
}

// x and y rounded to bf16 at columns c and c + 1 of a row of n elements
// (none past n), one 4-byte store where aligned
__device__ __forceinline__ void st_pair(bf16* p, int c, int n, float x, float y) {
  if (c + 1 < n && (reinterpret_cast<uintptr_t>(p + c) & 3u) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + c) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (c < n) p[c] = __float2bfloat16_rn(x);
  if (c + 1 < n) p[c + 1] = __float2bfloat16_rn(y);
}

// rows row .. row + 63 of head bh of a stacked cache (maps lo, hi) into the
// tile at dst, every box of HeadTile<DP>, completing on bar
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* lo,
                                          const CUtensorMap* hi, uint32_t bar, int row, int bh) {
  using HT = sm90::HeadTile<DP>;
#pragma unroll
  for (int b = 0; b < HT::NLO; ++b) sm90::tma_load3(dst + b * HT::LO_BOX, lo, bar, 64 * b, row, bh);
#pragma unroll
  for (int c = 0; c < HT::NHI; ++c)
    sm90::tma_load3(dst + HT::NLO * HT::LO_BOX + c * HT::HI_BOX, hi, bar, 64 * HT::NLO + 16 * c,
                    row, bh);
}

// maps: the layer-stacked cache [L * B * H, S, Dc] (Dc: D, or D rounded up
// to a multiple of 8, <= DP) in boxes of 64 rows. kExact: D == DP, known to
// the compiler (every load and store of q and the output a whole pair).
// kChunked: the score-chunked route (see the top of the file). Block z is
// the beam tile: beams 16 z .. 16 z + 15 of the sample. The deep route (DP
// == DEEP, D past 256): 64 x 128 tiles (the instance 128's layout); each key
// tile's scores the sum of its nk = D / 128 chunk tiles' products in order, q's
// fragments of each chunk loaded as it comes; the CTA owns one 128-column
// block of v and the output (block z = beam tile x nk + block) and streams
// that block's value tiles alone.
template <int DP, bool kExact, bool kChunked>
__global__ void __launch_bounds__(NT) kernel(const __grid_constant__ CacheMaps maps, Args a) {
  constexpr bool kDeep = DP == DEEP;
  constexpr int W = tile_width<DP>();  // a tile's columns
  using HT = sm90::HeadTile<W>;
  constexpr uint32_t TILE = tile_bytes<DP>();
  constexpr int STAGES = stages<DP>();
  constexpr int NB = (W / 8 + 7) / 8;  // n8 column blocks a warp owns in P.v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * TILE;
  const int nk = kDeep ? deep_chunks(a.D) : 1;  // the deep route's chunks (and blocks)
  const int h = blockIdx.x, b = blockIdx.y, j0 = MAX_KB * (blockIdx.z / nk), S = a.S;
  const int cb = blockIdx.z % nk, c0 = W * cb;  // the deep route's block of v and the output
  const int Kb = min(MAX_KB, a.Kb - j0);  // this tile's beams
  const int ntiles = (S + BKT - 1) / BKT, sp = ntiles * BKT;
  const int pst = kChunked ? PT : sp + 8;  // a probability row's stride
  // the whole-row route: fp32 scores [Kb][sp], the bias row [sp], bf16 P
  // [Kb][pst]; the chunked route: two bf16 P tiles [16][PT], then each
  // warp's row maxes and sums [8][16][2] fp32
  float* sc = reinterpret_cast<float*>(smem_raw + (bars + 16 * STAGES - raw));
  float* bias = sc + (size_t)Kb * sp;
  bf16* P = kChunked ? reinterpret_cast<bf16*>(sc) : reinterpret_cast<bf16*>(bias + sp);
  float* part = reinterpret_cast<float*>(P + 2 * MAX_KB * PT);
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + TILE * st; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  sm90::launch_dependents();

  const int bh = (a.layer * a.B + b) * a.H + h;
  if (tid >= NC) {  // the producer warp: K tiles, then V tiles (chunked: K, then K V K V ..)
    if (kDeep && tid == NC) {  // each K tile as nk chunks; V: the block's columns
      int seq = 0;
      auto put = [&](const CUtensorMap* map, int col, int row) {
        const int st = seq % STAGES;
        if (seq >= STAGES) sm90::mbar_wait(empty(st), (seq / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(st), TILE);
        sm90::tma_load3(stage(st), map, full(st), col, row, bh);
        sm90::tma_load3(stage(st) + HT::LO_BOX, map, full(st), col + 64, row, bh);
        ++seq;
      };
      for (int it = 0; it < ntiles; ++it)
        for (int c = 0; c < nk; ++c) put(&maps.k, W * c, it * BKT);
      for (int it = 0; it < ntiles; ++it) {
        if (kChunked)
          for (int c = 0; c < nk; ++c) put(&maps.k, W * c, it * BKT);
        put(&maps.v, c0, it * BKT);
      }
    } else if (tid == NC) {
      const int total = (kChunked ? 3 : 2) * ntiles;
      for (int it = 0; it < total; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(empty(st), (it / STAGES - 1) & 1);
        const bool value = !kChunked ? it >= ntiles : it >= ntiles && (it - ntiles) % 2 == 1;
        const int row = (!kChunked || it < ntiles ? it % ntiles : (it - ntiles) / 2) * BKT;
        sm90::mbar_expect_tx(full(st), TILE);
        if (value)
          load_rows<W>(stage(st), &maps.v, &maps.v_hi, full(st), row, bh);
        else
          load_rows<W>(stage(st), &maps.k, &maps.k_hi, full(st), row, bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  const float* bias_row = a.bias + ((long long)b * a.H + h) * S;
  // the bias row into shared memory (a constant of the step: before the wait)
  if constexpr (!kChunked) sm90::copy_f32(bias, bias_row, S, S, tid, NC);
  sm90::grid_wait();  // q is the cross-q product's
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int D = kExact ? W : a.D, d = a.H * D;
  const long long row0 = (long long)b * a.Kb + j0;  // the tile's first row of q and out
  // q's A fragments for the W / 16 16-deep k-steps: rows g and g + 8 (beams),
  // dims e0 + .. (the deep route: chunk e0 / 128's)
  uint32_t qa[W / 16][4];
  auto load_qa = [&](int e0) {
    const bf16* q = a.q + row0 * d + h * D;
    auto pair = [&](int j, int c) -> uint32_t {
      if (j >= Kb) return 0u;
      if constexpr (kExact) return *reinterpret_cast<const uint32_t*>(q + (long long)j * d + c);
      return ld_pair(q + (long long)j * d, e0 + c, D);
    };
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      qa[kk][0] = pair(g, 16 * kk + 2 * t);
      qa[kk][1] = pair(g + 8, 16 * kk + 2 * t);
      qa[kk][2] = pair(g, 16 * kk + 8 + 2 * t);
      qa[kk][3] = pair(g + 8, 16 * kk + 8 + 2 * t);
    }
  };
  if constexpr (!kDeep) load_qa(0);
  sm90::named_sync(1, NC);  // the bias row

  // the scores of keys 8 warp .. + 7 of the K tile in stage st (no bias);
  // with acc, added to c
  auto scores = [&](int st, float (&c)[4], bool acc = false) {
    const int key = 8 * warp + g;  // this lane's B column
    if (!acc) c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      const uint32_t b0 = lds32(HT::unit(stage(st), key, 2 * kk) + 4 * t);
      const uint32_t b1 = lds32(HT::unit(stage(st), key, 2 * kk + 1) + 4 * t);
      mma16816(c, qa[kk], b0, b1);
    }
  };
  // the deep route's ring, as the consumers walk it: the next tile's stage,
  // and its release behind a proxy fence (the generic reads of a stage
  // ordered before the next TMA copy into it; K6's deep route read other
  // chunks' bytes without it)
  auto release = [&](int st) {
    sm90::fence_async_smem();
    sm90::mbar_arrive(empty(st));
  };
  int seq = 0;
  auto take = [&]() {
    const int st = seq % STAGES;
    sm90::mbar_wait(full(st), (seq / STAGES) & 1);
    ++seq;
    return st;
  };
  // the deep route's scores of a key tile: its nk chunks in order, each
  // stage released once read
  auto scores_deep = [&](float (&c)[4]) {
    for (int ch = 0; ch < nk; ++ch) {
      const int st = take();
      load_qa(W * ch);
      scores(st, c, ch > 0);
      release(st);
    }
  };
  // acc += P (rows g, g + 8; columns k0 .. k0 + 63 of P's rows) . the V tile in stage st
  float o[NB][4] = {};
  auto pv = [&](int st, const bf16* Pt, int k0) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kc = k0 + 16 * ks + 2 * t;  // this lane's A columns kc, kc + 1 (and + 8)
      uint32_t pa[4];
      pa[0] = g < Kb ? *reinterpret_cast<const uint32_t*>(Pt + (size_t)g * pst + kc) : 0u;
      pa[1] = g + 8 < Kb ? *reinterpret_cast<const uint32_t*>(Pt + (size_t)(g + 8) * pst + kc)
                         : 0u;
      pa[2] = g < Kb ? *reinterpret_cast<const uint32_t*>(Pt + (size_t)g * pst + kc + 8) : 0u;
      pa[3] = g + 8 < Kb ? *reinterpret_cast<const uint32_t*>(Pt + (size_t)(g + 8) * pst + kc + 8)
                         : 0u;
      // two 8 x 8 value blocks: keys +0 / +8 of this k-step, a block's 8 columns
      const int key = 16 * ks + (lane % 8) + 8 * ((lane / 8) & 1);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (warp + 8 * n >= W / 8) continue;
        const uint32_t addr = HT::unit(stage(st), key, warp + 8 * n);
        uint32_t r0, r1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(r0), "=r"(r1)
                     : "r"(addr)
                     : "memory");
        mma16816(o[n], pa, r0, r1);
      }
    }
  };

  if constexpr (!kChunked) {
    // scores: warp w, keys 8 w .. 8 w + 7 of each tile
    for (int it = 0; it < ntiles; ++it) {
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
        sm90::mbar_arrive(empty(st));
      }
      const int s = it * BKT + 8 * warp + 2 * t;  // columns s, s + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e >= S) continue;
        if (g < Kb) sc[(size_t)g * sp + s + e] = c[e] + bias[s + e];
        if (g + 8 < Kb) sc[(size_t)(g + 8) * sp + s + e] = c[2 + e] + bias[s + e];
      }
    }
    sm90::named_sync(1, NC);

    // softmax, one warp per beam row; p rounded to bf16, zeros past S
    for (int j = warp; j < Kb; j += NC / 32) {
      const float* row = sc + (size_t)j * sp;
      float m = -CUDART_INF_F;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
      m = warp_max(m);
      float l = 0.f;
      for (int s = lane; s < S; s += 32) l += expf(row[s] - m);
      l = warp_sum(l);
      bf16* pr = P + (size_t)j * pst;
      for (int s = lane; s < sp; s += 32)
        pr[s] = __float2bfloat16_rn(s < S ? expf(row[s] - m) / l : 0.f);
    }
    sm90::named_sync(1, NC);

    // P.v: warp w owns the n8 column blocks w + 8 n < W / 8
    for (int it = ntiles; it < 2 * ntiles; ++it) {
      int st;
      if constexpr (kDeep) {
        st = take();
      } else {
        st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
      }
      pv(st, P, (it - ntiles) * BKT);
      if constexpr (kDeep)
        release(st);
      else
        sm90::mbar_arrive(empty(st));
    }
  } else {
    // pass 1: each row's max and sum of exp over the K tiles, a key at a time
    // in the lane, then the lanes of a quad (xor 1, 2), then the 8 warps in order
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // rows g, g + 8
    for (int it = 0; it < ntiles; ++it) {
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
        sm90::mbar_arrive(empty(st));
      }
      const int s = it * BKT + 8 * warp + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e >= S) continue;
        const float bi = __ldg(bias_row + s + e);
        softmax_merge(m[0], l[0], c[e] + bi, 1.f);
        softmax_merge(m[1], l[1], c[2 + e] + bi, 1.f);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off *= 2)
        softmax_merge(m[r], l[r], __shfl_xor_sync(0xffffffffu, m[r], off),
                      __shfl_xor_sync(0xffffffffu, l[r], off));
      if (t == 0) {
        part[2 * (warp * MAX_KB + g + 8 * r)] = m[r];
        part[2 * (warp * MAX_KB + g + 8 * r) + 1] = l[r];
      }
    }
    sm90::named_sync(1, NC);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -CUDART_INF_F;
      l[r] = 0.f;
      for (int w = 0; w < NC / 32; ++w)
        softmax_merge(m[r], l[r], part[2 * (w * MAX_KB + g + 8 * r)],
                      part[2 * (w * MAX_KB + g + 8 * r) + 1]);
    }
    // pass 2: per tile, the scores again, p = exp(w - m) / l rounded to bf16
    // into a P tile (two, alternating: one barrier a tile), then P.v
    for (int i = 0; i < ntiles; ++i) {
      const int it = ntiles + 2 * i;
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
        sm90::mbar_arrive(empty(st));
      }
      bf16* Pt = P + (i & 1) * MAX_KB * PT;
      const int col = 8 * warp + 2 * t, s = i * BKT + col;
      float p[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = s + e < S;
        const float bi = live ? __ldg(bias_row + s + e) : 0.f;
        p[0][e] = live && g < Kb ? expf(c[e] + bi - m[0]) / l[0] : 0.f;
        p[1][e] = live && g + 8 < Kb ? expf(c[2 + e] + bi - m[1]) / l[1] : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(Pt + g * PT + col) =
          __floats2bfloat162_rn(p[0][0], p[0][1]);
      *reinterpret_cast<__nv_bfloat162*>(Pt + (g + 8) * PT + col) =
          __floats2bfloat162_rn(p[1][0], p[1][1]);
      sm90::named_sync(1, NC);
      int sv;
      if constexpr (kDeep) {
        sv = take();
      } else {
        sv = (it + 1) % STAGES;
        sm90::mbar_wait(full(sv), ((it + 1) / STAGES) & 1);
      }
      pv(sv, Pt, 0);
      if constexpr (kDeep)
        release(sv);
      else
        sm90::mbar_arrive(empty(sv));
    }
  }

  bf16* out = a.out + row0 * d + h * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (warp + 8 * n >= W / 8) continue;
    const int c = c0 + 8 * (warp + 8 * n) + 2 * t;
    const float (&r)[4] = o[n];
    if constexpr (kExact) {
      if (g < Kb)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)g * d + c) =
            __floats2bfloat162_rn(r[0], r[1]);
      if (g + 8 < Kb)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(g + 8) * d + c) =
            __floats2bfloat162_rn(r[2], r[3]);
    } else {
      if (g < Kb) st_pair(out + (long long)g * d, c, D, r[0], r[1]);
      if (g + 8 < Kb) st_pair(out + (long long)(g + 8) * d, c, D, r[2], r[3]);
    }
  }
}

// The layer-stacked cross caches [L, B, H, S, Dc] bf16 as [L * B * H, S, Dc]
// in boxes of 64 rows (sm90::head_maps).
template <int DP>
inline int cache_maps(CacheMaps* m, const void* k, const void* v, long long lbh, int S, int Dc) {
  constexpr int W = tile_width<DP>();
  if (const int err = sm90::head_maps(&m->k, &m->k_hi, k, Dc, W, S, lbh, BKT)) return err;
  return sm90::head_maps(&m->v, &m->v_hi, v, Dc, W, S, lbh, BKT);
}

template <int DP, bool kExact, bool kChunked>
inline int launch_one(const CacheMaps& maps, const Args& a, size_t smem, int pdl,
                      cudaStream_t stream) {
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)kernel<DP, kExact, kChunked>, smem)) return err;
  cudaLaunchConfig_t cfg = {};
  const int nk = DP == DEEP ? deep_chunks(a.D) : 1;  // the deep route's column blocks
  cfg.gridDim = dim3(a.H, a.B, (a.Kb + MAX_KB - 1) / MAX_KB * nk);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel<DP, kExact, kChunked>, maps, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// grid (H, B, beam tiles), with programmatic stream serialization (pdl);
// chunked: the score-chunked route, else the whole-row route, which must fit.
// A cudaError_t code.
template <int DP>
inline int launch(const CacheMaps& maps, const Args& a, int chunked, int pdl,
                  cudaStream_t stream) {
  if (a.Kb < 1 || (DP != DEEP && a.D > DP)) return (int)cudaErrorInvalidValue;
  const int kb = a.Kb < MAX_KB ? a.Kb : MAX_KB;  // the beams of a tile
  const size_t smem = chunked ? smem_bytes_chunked<DP>() : smem_bytes<DP>(kb, a.S);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if constexpr (DP == DEEP) {  // D is never the instance's
    return chunked ? launch_one<DP, false, true>(maps, a, smem, pdl, stream)
                   : launch_one<DP, false, false>(maps, a, smem, pdl, stream);
  } else {
    const bool exact = a.D == DP;
    if (chunked)
      return exact ? launch_one<DP, true, true>(maps, a, smem, pdl, stream)
                   : launch_one<DP, false, true>(maps, a, smem, pdl, stream);
    return exact ? launch_one<DP, true, false>(maps, a, smem, pdl, stream)
                 : launch_one<DP, false, false>(maps, a, smem, pdl, stream);
  }
}

// launch<dp>, for an instance dp of common.cuh::with_head_dim: defined in
// decode_attn.cu, the one source that compiles these kernels (K7's
// decode_stack.cu calls it), so that the two build in parallel.
int launch_instance(int dp, const CacheMaps& maps, const Args& a, int chunked, int pdl,
                    cudaStream_t stream);

}  // namespace decode_attn
}  // namespace mk
