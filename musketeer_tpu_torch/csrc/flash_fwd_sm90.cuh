// The bf16 attention core of K1, K3 and K5 on Hopper's tensor cores: wgmma
// products fed by TMA through a ring of shared-memory stages. Its pieces (the
// rel loads and masks, the score and P.v products) and the Hopper primitives
// of sm90.cuh (mbarriers, TMA, wgmma) also build K4's backward
// (flash_bwd_sm90.cuh).
//
// Replaces, for bf16 streams, the Pallas kernels
//   musketeer_tpu/ops/flash_attention_infer.py::flash_attention_inference
//     (K1, _kernel; pallas_call at :143),
//   musketeer_tpu/ops/flash_attention_bwd.py::_fwd (K3, _fwd_kernel;
//     pallas_call at :265): K1's walk plus each row's logsumexp in fp32,
//     lse = m + log(l) (log(max(l, 1e-38)) under skip_max), and
//   musketeer_tpu/ops/flash_attention.py::flash_attention_bias and
//     ::flash_cross_attention (K5; pallas_calls at :186 and :134).
// Their fp32 launches stay on the FMA core of flash_fwd.cuh: on tensor cores
// fp32 would mean TF32, and the fp32 checks hold full fp32. The dtype alone
// picks the core, never the shape.
//
// Per (b, h), with the TPU kernels' numerics:
//   w   = q.k^T + pos_q.pos_k^T (+ rel[h]) in fp32; causal and pad masks -1e9,
//         -inf past S
//   K1: online max and sum in fp32 (the sum over the unrounded e), e rounded
//       to bf16 for P.v, the accumulator rescaled, out = acc / l; skip_max
//       drops the max and floors l at 1e-38
//   K5: pass 1 gives each row's m and l online, plus (Sp - S) exp(-1e9 - m)
//       for the JAX wrapper's padded keys; pass 2 recomputes w and forms
//       p = round_bf16(exp(w - m) / l) before P.v; out = acc
//
// Design. A CTA owns one (b, h, 64-row query tile), as the FMA core does (15
// tiles x 192 heads = 2880 CTAs at the encoder shape), with one consumer
// warpgroup (128 threads) and one producer warp. The tile width DP is a
// template parameter, compiled at 32, 64, 80, 128, 192 and 256; a head dim D
// runs on the smallest DP >= D (common.cuh::with_head_dim), D itself an
// argument.
//   - Operands. The producer loads the q and pos_q tiles once, then streams
//     64-key tiles of k, pos_k and v (6 KB x DP / 16 a stage: 24 KB at DP
//     64, 48 KB at DP 128; K5's first pass only k and pos_k) through a ring
//     of 3 stages, each by TMA into the swizzled layout wgmma reads,
//     with one mbarrier for "full" and one for "empty" per stage, so the next
//     tile's copies overlap this tile's products. The tensor maps are 3-D
//     over [B*H, rows, D] at the true D: rows past the end and columns past
//     D are zero-filled and no box reaches into the next head. A tile is
//     sm90.cuh::HeadTile's boxes: 64 columns under the 128-byte swizzle (one
//     at DP 64 and 80, two at 128), then 16 columns under the 32-byte
//     swizzle (one at 80, two at 32), each with its own wgmma descriptor.
//   - Scores: wgmma m64n64k16, DP / 16 k-steps over q.k then as many over
//     pos_q.pos_k, into one fp32 accumulator of 32 registers a thread.
//   - rel does not fit a tensor map (a bf16 row of 908 is 1816 bytes, not a
//     multiple of 16), so each thread reads its own accumulator positions:
//     two adjacent columns, one 4-byte (bf16) or 8-byte (fp32) load where the
//     rows' alignment allows, else two scalar loads. Those loads and the pad
//     bits (one ballot per 32 keys) are issued while the products run. They
//     are the largest cost left: without rel K1 runs in ~60 % of the time.
//   - Softmax: each row lives in a quad of threads; its max and sum are two
//     shuffles.
//   - P.v: wgmma m64n64k16 x 4 with A = the bf16 probabilities straight from
//     registers (the fp32 m64n64 accumulator layout, packed in pairs, is the
//     A-fragment layout) and B = v read MN-major from the stage (the
//     transpose bit) on each 64-column box, m64n16k16 x 4 on each 16-column
//     one, so the output accumulator is DP / 2 fp32 registers a thread
//     (16 to 64); the columns past D are stored nowhere.
//   - K5 keeps its two passes in one CTA: repeating the score products costs
//     little on tensor cores, where keeping a row block's fp32 scores in
//     shared memory (64 x S x 4 bytes) would fit 227 KB only up to S ~ 880.
//   - Past DP 128 (the instances 192 and 256) a whole-width output would be
//     DP / 2 fp32 registers a thread (128 at 256), and q, pos_q and 3 stages
//     of k, pos_k and v would not fit (271 KB at 192, 362 KB at 256). So the
//     output's columns split over the grid (Layout::NCH column halves): a CTA
//     owns one (b, h, 64-row q tile, 128-column half of v and out), computes
//     the full-width scores (the same DP / 16 k-steps) and keeps the 64
//     accumulator registers of DP 128; its stage holds k, pos_k and its
//     half of v (one or two 64-column boxes), 2 stages deep (176 KB at 192,
//     225 KB at 256). Each output element's sums are the DP 128 instance's,
//     in the same order; the score products are repeated per half, as K5's
//     second pass repeats them. K3's logsumexp is written by the first half.
//   - Past DP 256 (the deep route, DP == DEEP: any head dim D, a multiple
//     of 8; fwd_deep) nothing whole-width fits: q and pos_q alone would take
//     96 KB at D 384, and beyond 512 more than a block's shared memory. So
//     nothing is resident and the head dim streams through the score
//     products in chunks of 128 columns (the pairs (q, k) of chunk 0 ..
//     nk - 1, then (pos_q, pos_k), each pair's 8 k-steps in a fresh
//     accumulator added in fp32: deep_products). The output splits into nch
//     = ceil(D / 128) column blocks of 128; a CTA owns up to DW = 3 of them,
//     one consumer warpgroup each (a 64 x 128 fp32 accumulator, 64 registers
//     a thread: about 384 columns is what an SM's registers hold), and a
//     builder warpgroup builds each key tile's scores and P once for them,
//     passing P through shared memory as wgmma's A operand. The scores are
//     built ceil(nch / 3) times per (q tile, key tile): once at D 384, twice
//     at 768 (one block a CTA would build them nch times and stream the
//     score chunks as often, and that traffic sets the pace). setmaxnreg
//     moves the producer warpgroup's registers to the builder. At D <= 384 q
//     and pos_q stay resident and only the key side streams. ptxas (CUDA
//     12.8): 96 registers at launch in every instance; no spills in K1/K3
//     (4 bytes with q resident), 6-10 bytes in K5 with bf16 rel, 348-496
//     with fp32 rel (the builder's 32 fp32 rel values a tile).
//
// Bound. At the encoder shape (B16 H12 T=S=908 D64) the function is
// ~60.8 GFLOP against ~150 MB: 0.0615 ms at 989 TFLOP/s bf16, set by the
// operations; K3 at the encoder train shape (B4 H12 T=S=980) 0.0179 ms, set
// by the operations too. At ofa_huge's (H16, D80) K1 is ~101 GFLOP, 0.102
// ms, and K3 ~29.5 GFLOP, 0.030 ms. ptxas (CUDA 12.8), registers of K1/K3,
// K5, K5 with fp32 rel: 119, 123, 137 at DP 32; 135, 137, 149 at 64; 141,
// 143, 156 at 80; 185, 188, 203 at 128; no spills. Two CTAs fit an SM below
// 128 (shared memory 46,136 bytes a CTA at DP 32, 91,192 at 64, 113,720 at
// 80); at 128 one (181,304 bytes), so no second CTA bounds its registers.
// Past 128, one CTA an SM too (181,288 bytes at 192, 230,440 at 256):
// K1/K3, K5, K5 with fp32 rel 203, 207, 221 registers at 192 and 219, 217,
// 225 at 256, no spills. chip_smoke.py's build phase prints the report of
// each build.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma, encode_tiled

namespace mk {
namespace sm90 {

constexpr int BQ = 64;                // query rows per CTA (one wgmma M)
constexpr int BK = 64;                // keys per tile
constexpr int NC = 128;               // consumer threads: one warpgroup
constexpr int NT = NC + 32;           // + the producer warp
constexpr float NEG = -1e9f;

// The shared-memory layout at instance width DP: 64-row tiles of HeadTile<DP>
// (q, pos_q, k, pos_k) and of HeadTile<VW> (a CTA's columns of v).
template <int DP>
struct Layout {
  static constexpr int STAGES = DP <= 128 ? 3 : 2;  // ring depth
  static constexpr int VW = DP <= 128 ? DP : 128;   // columns of v and out a CTA owns
  static constexpr int NCH = (DP + VW - 1) / VW;    // column halves: 1, or 2 past DP 128
  static constexpr uint32_t TILE = HeadTile<DP>::BYTES;   // bytes of one 64-row bf16 tile
  static constexpr uint32_t VTILE = HeadTile<VW>::BYTES;  // bytes of a CTA's v tile
  static constexpr uint32_t OFF_KV = 2 * TILE;  // the ring, after q and pos_q
  static constexpr uint32_t STAGE = 2 * TILE + VTILE;  // k, pos_k, v's columns
  static constexpr uint32_t OFF_BAR = OFF_KV + STAGES * STAGE;
  // + 1 KB of slack: the base is aligned to 1024 bytes, the 128-byte swizzle's period
  static constexpr size_t SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;
  // the 64-column boxes of column half c (past DP 128; DP 192's second: one)
  static __host__ __device__ constexpr int vboxes(int c) {
    return DP <= 128 ? 0 : (DP / 64 - 2 * c < 2 ? DP / 64 - 2 * c : 2);
  }
  // bytes of column half c's v tile
  static __host__ __device__ constexpr uint32_t vbytes(int c) {
    return DP <= 128 ? TILE : vboxes(c) * HeadTile<DP>::LO_BOX;
  }
};

// The tensor maps of N streams: lo[i] the 64-column boxes of stream i, hi[i]
// the 16-column ones (sm90.cuh::head_maps).
template <int DP, int N>
struct Maps {
  CUtensorMap lo[HeadTile<DP>::NLO ? N : 1];
  CUtensorMap hi[HeadTile<DP>::NHI ? N : 1];
};

// rows row .. row + 63 of stream i of head bh into the tile at dst, every
// box, completing on bar
template <int DP, int N>
__device__ __forceinline__ void load_tile(uint32_t dst, const Maps<DP, N>& m, int i,
                                          uint32_t bar, int row, int bh) {
  using HT = HeadTile<DP>;
#pragma unroll
  for (int b = 0; b < HT::NLO; ++b) tma_load3(dst + b * HT::LO_BOX, &m.lo[i], bar, 64 * b, row, bh);
#pragma unroll
  for (int c = 0; c < HT::NHI; ++c)
    tma_load3(dst + HT::NLO * HT::LO_BOX + c * HT::HI_BOX, &m.hi[i], bar, 64 * HT::NLO + 16 * c,
              row, bh);
}

// column half c of stream i's rows row .. row + 63 (Layout::vbytes(c)): the
// whole tile at DP <= 128, else its 64-column boxes 2 c and 2 c + 1 that exist
template <int DP, int N>
__device__ __forceinline__ void load_cols(uint32_t dst, const Maps<DP, N>& m, int i,
                                          uint32_t bar, int row, int bh, int c) {
  if constexpr (DP <= 128) {
    load_tile(dst, m, i, bar, row, bh);
  } else {
    for (int b = 0; b < Layout<DP>::vboxes(c); ++b)
      tma_load3(dst + b * HeadTile<DP>::LO_BOX, &m.lo[i], bar, 128 * c + 64 * b, row, bh);
  }
}


// the deep route's chunk c (columns 128 c .. 128 c + 127, zeros past D) of
// stream i's rows row .. row + 63 into the HeadTile<128> tile at dst
template <int N>
__device__ __forceinline__ void load_chunk(uint32_t dst, const Maps<DEEP_CHUNK, N>& m, int i,
                                           uint32_t bar, int c, int row, int bh) {
  tma_load3(dst, &m.lo[i], bar, DEEP_CHUNK * c, row, bh);
  tma_load3(dst + HeadTile<DEEP_CHUNK>::LO_BOX, &m.lo[i], bar, DEEP_CHUNK * c + 64, row, bh);
}

// ---- rel: two adjacent columns of a row, in rel's dtype ------------------

template <typename TR> struct RelPair;
template <> struct RelPair<__nv_bfloat16> { using type = uint32_t; };  // raw bf16 pair
template <> struct RelPair<float> { using type = float2; };

__device__ __forceinline__ typename RelPair<__nv_bfloat16>::type load_pair(
    const __nv_bfloat16* p, bool vec, bool second) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  return second ? lo | (static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16) : lo;
}
__device__ __forceinline__ typename RelPair<float>::type load_pair(const float* p, bool vec,
                                                                   bool second) {
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(p[0], second ? p[1] : 0.f);
}
__device__ __forceinline__ float pair_at(uint32_t r, int e) {
  return __uint_as_float(e ? r & 0xffff0000u : r << 16);
}
__device__ __forceinline__ float pair_at(float2 r, int e) { return e ? r.y : r.x; }

// ---- one key tile ---------------------------------------------------------

// What the masks of one key tile need from device memory, loaded while the
// tile's score products run: this thread's rel pairs (two adjacent columns in
// the accumulator layout, one 4-byte bf16 or 8-byte fp32 load where rel's
// base, rows and heads keep it aligned, else two scalar loads) and this lane's
// two pad flags (keys k0 + lane, + 32). Loaded any earlier, during the
// previous tile's softmax, they compete with it and the kernel ran slower.
template <typename TR> struct TileBias {
  typename RelPair<TR>::type rv[2][8];
  bool pad0, pad1;
};

template <typename TR>
__device__ __forceinline__ void load_bias(TileBias<TR>& a, const TR* relh, long long rel_rs,
                                          bool rel_vec, const uint8_t* kp, int k0, int S, int t0,
                                          int Tq, int lane, int cq) {
  const int lim = S - k0;  // keys of the tile that exist
  a.pad0 = lane < lim && kp[k0 + lane];
  a.pad1 = lane + 32 < lim && kp[k0 + 32 + lane];
  if (!relh) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    const TR* row = relh + (long long)t * rel_rs + k0 + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + cq;
      a.rv[hh][j] = {};
      if (t < Tq && c < lim) a.rv[hh][j] = load_pair(row + 8 * j, rel_vec, c + 1 < lim);
    }
  }
}

// sc (+)= a . b^T over the DP / 16 k-steps of two K-major tiles; acc = 0
// overwrites sc at the first
template <int DP>
__device__ __forceinline__ void issue_kmajor(float (&sc)[32], uint32_t a, uint32_t b, int acc) {
  using HT = HeadTile<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(sc, HT::kdesc(a, kk), HT::kdesc(b, kk), acc || kk);
}

// sc = [q|pos_q] . [k|pos_k]^T of the stage at sk (k, then pos_k): 2 DP / 16
// wgmma k-steps into one fp32 accumulator, issued and committed, not waited.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t sq, uint32_t sk) {
  constexpr uint32_t TILE = Layout<DP>::TILE;
  wgmma_fence();
  issue_kmajor<DP>(sc, sq, sk, 0);                 // q . k
  issue_kmajor<DP>(sc, sq + TILE, sk + TILE, 1);   // + pos_q . pos_k
  wgmma_commit();
  fence_operand(sc);
}

// The finished scores of key tile k0, bias added and masked as flash_fwd.cuh
// does: rel in fp32, then causal and pad masks at -1e9, -inf past S.
// Accumulator position i = 4 j + 2 hh + e holds row r0 + 8 hh, key
// k0 + 8 j + cq + e. kEdge: the tile is causal or holds the end of S.
template <bool kEdge, typename TR>
__device__ __forceinline__ void mask_tile(float (&sc)[32], const TileBias<TR>& a, bool rel,
                                          unsigned pad_lo, unsigned pad_hi, int lim, int k0,
                                          int t0, int Tq, int causal, int lane) {
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    const bool add_rel = rel && t < Tq;
    const int cmax = causal ? t - k0 : BK;  // keys of the tile past cmax are in the future
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e, c = 8 * j + cq + e;
        float w = sc[i];
        if (add_rel) w += pair_at(a.rv[hh][j], e);
        bool neg = ((j < 4 ? pad_lo : pad_hi) >> (8 * (j & 3) + e)) & 1u;
        if (kEdge) neg = neg || c > cmax;
        w = neg ? NEG : w;
        sc[i] = !kEdge || c < lim ? w : -CUDART_INF_F;  // past the end: no part of the softmax
      }
  }
}

template <typename TR>
__device__ __forceinline__ void mask_scores(float (&sc)[32], const TileBias<TR>& a, bool rel,
                                            int k0, int S, int t0, int Tq, int causal, int lane) {
  const int lim = S - k0, cq = 2 * (lane & 3);
  // the tile's pad bits, shifted so that this thread's columns sit at 8 j' + e
  const unsigned pad_lo = __ballot_sync(0xffffffffu, a.pad0) >> cq;
  const unsigned pad_hi = __ballot_sync(0xffffffffu, a.pad1) >> cq;
  if (causal || lim < BK)
    mask_tile<true, TR>(sc, a, rel, pad_lo, pad_hi, lim, k0, t0, Tq, causal, lane);
  else
    mask_tile<false, TR>(sc, a, rel, pad_lo, pad_hi, lim, k0, t0, Tq, causal, lane);
}

// acc += P . v over the tile's 64 keys, P (bf16 pairs in the A layout) from
// registers, v from the stage, each box of the tile one N block: issued, not
// committed or waited (issue_pv commits). acc holds DP / 2 fp32 a thread:
// position i = 4 j + 2 hh + e is column 8 j + cq + e (the 64-column boxes'
// m64n64 products first, then the 16-column boxes' m64n16 ones).
template <int DP>
__device__ __forceinline__ void issue_pv_products(float (&acc)[DP / 2], const uint32_t (&pa)[16],
                                                  uint32_t sv) {
  using HT = HeadTile<DP>;
#pragma unroll
  for (int b = 0; b < HT::NLO; ++b) {
    float(&lo)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys = 16 rows of 128 bytes per k-step
      wgmma_rs(lo, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               sw128_desc(sv + b * HT::LO_BOX + 2048 * kk));
  }
#pragma unroll
  for (int c = 0; c < HT::NHI; ++c) {
    float(&hi)[8] = *reinterpret_cast<float(*)[8]>(&acc[32 * HT::NLO + 8 * c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys = 16 rows of 32 bytes per k-step
      Wgmma<16>::rs_t(hi, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      sw32_desc(sv + HT::NLO * HT::LO_BOX + c * HT::HI_BOX + 512 * kk));
  }
}

// issue_pv_products over a CTA's columns of a tile at sv: the whole tile at
// DP <= 128; past it nbox 64-column boxes from sv (two, or DP 192's last
// half: one, into the first 32 registers of acc).
template <int DP>
__device__ __forceinline__ void issue_pv_cols(float (&acc)[Layout<DP>::VW / 2],
                                              const uint32_t (&pa)[16], uint32_t sv, int nbox) {
  if constexpr (DP <= 128) {
    issue_pv_products<DP>(acc, pa, sv);
  } else if (nbox == 2) {
    issue_pv_products<128>(acc, pa, sv);
  } else {
    issue_pv_products<64>(*reinterpret_cast<float(*)[32]>(&acc[0]), pa, sv);
  }
}

// issue_pv_cols, committed, not waited.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[Layout<DP>::VW / 2],
                                         const uint32_t (&pa)[16], uint32_t sv, int nbox = 2) {
  wgmma_fence();
  issue_pv_cols<DP>(acc, pa, sv, nbox);
  wgmma_commit();
  fence_regs(acc);
}

// ---- the deep route (head dims past 256, common.cuh::DEEP) ----------------

constexpr uint32_t CHUNK = HeadTile<DEEP_CHUNK>::BYTES;  // a 64 x 128 bf16 chunk: 16 KB
constexpr uint32_t PTILE = BQ * BK * 2;  // a 64 x 64 bf16 tile of P (or dW): 8 KB
constexpr int DW = 3;  // column blocks a deep CTA owns: one block warpgroup each
// a deep CTA: a producer warpgroup, the builder warpgroup, DW block warpgroups
constexpr int DEEP_THREADS = NC * (2 + DW);
// registers a thread at launch (__launch_bounds__(640, 1): 65536 / 640 rounded
// down to 8), then the producer's and the builder's after setmaxnreg; the
// block warpgroups keep the launch's: 32 + 160 + 3 x 96 = 5 x 96 (24 + 168 made
// ptxas spill more in K5 with fp32 rel)
constexpr int DEEP_LAUNCH_REGS = 96, DEEP_PRODUCER_REGS = 32, DEEP_BUILDER_REGS = 160;
static_assert(DEEP_PRODUCER_REGS + DEEP_BUILDER_REGS + DW * DEEP_LAUNCH_REGS ==
                  (2 + DW) * DEEP_LAUNCH_REGS,
              "setmaxnreg moves registers between warpgroups, within the launch's pool");

// A ring of STAGES slots of SLOT bytes as its threads walk it: item seq sits
// in slot seq % STAGES, in the slot's (seq / STAGES)-th phase; the producer
// and the consumers count the same items in the same order. Its mbarriers:
// full[STAGES], then empty[STAGES].
template <int STAGES, uint32_t SLOT>
struct Ring {
  uint32_t base, bars;
  int seq = 0;
  __device__ __forceinline__ uint32_t slot(int st) const { return base + SLOT * st; }
  __device__ __forceinline__ uint32_t full(int st) const { return bars + 8u * st; }
  __device__ __forceinline__ uint32_t empty(int st) const { return bars + 8u * (STAGES + st); }
  // consumers: the next item, once its copies have landed -> its slot
  __device__ __forceinline__ int take() {
    const int st = seq % STAGES;
    mbar_wait(full(st), (seq / STAGES) & 1);
    ++seq;
    return st;
  }
  __device__ __forceinline__ void release(int st) const { mbar_arrive(empty(st)); }
  // the producer: the next item's slot, once its readers have released it,
  // expecting `bytes` of copies
  __device__ __forceinline__ int put(uint32_t bytes) {
    const int st = seq % STAGES;
    if (seq >= STAGES) mbar_wait(empty(st), (seq / STAGES - 1) & 1);
    mbar_expect_tx(full(st), bytes);
    ++seq;
    return st;
  }
  // mbarrier counts: one arrival (the copies' expect_tx) fills a slot,
  // `readers` threads empty it
  __device__ __forceinline__ void init(int readers) const {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), readers);
    }
  }
};

// The score ring of a deep CTA: slots of two chunks, one of a query-side
// stream and the same chunk of a key-side stream, for one score product.
using ScoreRing = Ring<3, 2 * CHUNK>;
// The forward's chunks of q (and as many of pos_q) that stay resident where
// the head dim has at most this many (D <= 384: 96 KB); its score ring then
// streams the key-side chunk alone, and its block ring is one slot deep.
constexpr int DEEP_RESIDENT_NK = 3;
using KeyRing = Ring<4, CHUNK>;
// The operand ring: slots of the DW blocks of 128 columns a CTA's block
// warpgroups multiply P by (v; K4: dO, q, pos_q, k or pos_k), one per tile.
using BlockRing = Ring<2, DW * CHUNK>;

// acc = the sum over the ring's next n items of A . B^T, each item a pair of
// K-major 64 x 128 chunks (A the slot's first tile, B its second): each
// item's 8 wgmma k-steps into a fresh fp32 accumulator, then added to acc
// with fp32 adds, item by item in the ring's order. The tensor cores' own
// accumulation drops bits at each k-step, so one accumulator carried over the
// 2 D / 16 k-steps of a deep score drifts with D: at D 1280 it put bf16 K4's
// drel 1.3e-4 of max|drel| from plain on an H100, past phase 28's 1e-4; a
// fresh accumulator an item bounds that drift at one chunk's 8 k-steps. Each
// item is released once its products are done. (Two accumulators taking
// turns, item c + 1 issued before item c is added, made ptxas serialise every
// wgmma of the kernel (C7518) and spill: K1 2.7x slower at D 384.) With
// kResident, A is the resident chunk c at res + c CHUNK and B the slot.
template <bool kResident = false, class R>
__device__ __forceinline__ void deep_products(float (&acc)[32], R& r, int n, uint32_t res = 0) {
  float part[32];
  for (int c = 0; c < n; ++c) {
    const int st = r.take();
    const uint32_t a = kResident ? res + c * CHUNK : r.slot(st);
    wgmma_fence();
    issue_kmajor<DEEP_CHUNK>(part, a, kResident ? r.slot(st) : r.slot(st) + CHUNK, 0);
    wgmma_commit();
    fence_operand(part);
    wgmma_wait();
    fence_operand(part);
    r.release(st);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = c ? acc[i] + part[i] : part[i];
  }
}

// x (a 64 x 64 fp32 accumulator of the builder warpgroup: rows r0 and r0 + 8,
// columns 8 j + cq and + 1) rounded to bf16 into the K-major tile at dst, as
// TMA's 128-byte swizzle lays a 64-column box (16-byte unit j of row r at
// r * 128 + (j ^ (r % 8)) * 16): wgmma's A operand from shared memory. With
// `residual`, the bf16 rounding of what that rounding leaves of x instead
// (dW's low part, as to_a_residual).
__device__ __forceinline__ void store_a_tile(uint32_t dst, const float (&x)[32], int r0, int cq,
                                             bool residual = false) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = x[4 * j + 2 * hh], c = x[4 * j + 2 * hh + 1];
      if (residual) {
        const uint32_t hi = pack_bf16(a, c);
        a -= __uint_as_float(hi << 16);
        c -= __uint_as_float(hi & 0xffff0000u);
      }
      sts32(dst + r * 128 + ((j ^ (r & 7)) << 4) + 2 * cq, pack_bf16(a, c));
    }
  }
}

// acc += the sum over NP K-major 64 x 64 bf16 tiles A_p at pa + p PTILE of
// A_p . B, B the 64 x 128 chunk at sb read MN-major (its 64-column boxes one
// N block each): a block warpgroup's product, issued, committed and waited.
template <int NP>
__device__ __forceinline__ void block_products(float (&acc)[DEEP_CHUNK / 2], uint32_t pa,
                                               uint32_t sb) {
  using HT = HeadTile<DEEP_CHUNK>;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < HT::NLO; ++b) {
      float(&lo)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * b]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys: 32 bytes of A's rows, 16 rows of B's box
        wgmma_ss_t(lo, sw128_desc(pa + p * PTILE + 32 * kk),
                   sw128_desc(sb + b * HT::LO_BOX + 2048 * kk));
    }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
}

// The score accumulator, as probabilities, into P.v's A fragments: positions
// 8 kk + 2 m and + 1 are register m of k-step kk.
__device__ __forceinline__ void to_a_fragments(const float (&p)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
}

// max and sum over the quad of threads that holds a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp(x) as one ex2 of x log2(e): within a few fp32 ulps of expf for the
// arguments here (|x| up to ~100, or -inf and -1e9-sized ones that give 0),
// far below the bf16 rounding that follows
__device__ __forceinline__ float fexp(float x) { return exp2f(x * 1.4426950408889634f); }

// ---- the kernel ------------------------------------------------------------

// kNorm: K5 (two passes, p normalised before P.v, Sp - S padded keys);
// else K1. TR: rel's dtype.
//
// The consumer walks tiles it = 0 .. n - 1 (K5: 2 ntiles, both passes): the
// scores' products, their masks, the softmax, P.v, each waited for before
// the next. Keeping the next tile's score products in flight during this
// tile's softmax made ptxas serialise every wgmma of the kernel (C7514) and
// ran slower; the overlap comes from the second CTA on the SM instead.
// maps: q, pos_q, k, pos_k, v; D: the head dim (a multiple of 8, <= DP).
// Block x is (q tile, column half): q tile x / NCH, half x % NCH.
template <int DP, bool kNorm, typename TR>
__global__ void __launch_bounds__(NT, DP < 128 ? 2 : 1) kernel(
    const __grid_constant__ Maps<DP, 5> maps, const TR* __restrict__ rel,
    const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int rel_vec, int causal,
    int skip_max, int D) {
  using Lay = Layout<DP>;
  constexpr int STAGES = Lay::STAGES, VW = Lay::VW;
  constexpr uint32_t TILE = Lay::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;  // q, then pos_q at + TILE
  const uint32_t bars = base + Lay::OFF_BAR;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + Lay::OFF_KV + Lay::STAGE * st; };  // k, pos_k, v

  const int nch = Lay::NCH;  // column halves
  const int q0 = blockIdx.x / nch * BQ, h = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % nch, c0 = VW * half;  // this CTA's columns of v and out
  const int bh = b * H + h;
  const int ntiles = (S + BK - 1) / BK;
  const int n = kNorm ? 2 * ntiles : ntiles;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NC);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      mbar_expect_tx(qbar, 2 * TILE);
      load_tile(sq, maps, 0, qbar, q0, bh);
      load_tile(sq + TILE, maps, 1, qbar, q0, bh);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
        const int k0 = (it % ntiles) * BK;
        const bool with_v = !kNorm || it >= ntiles;  // K5's first pass needs no v
        mbar_expect_tx(full(st), 2 * TILE + (with_v ? Lay::vbytes(half) : 0));
        load_tile(stage(st), maps, 2, full(st), k0, bh);
        load_tile(stage(st) + TILE, maps, 3, full(st), k0, bh);
        if (with_v) load_cols(stage(st) + 2 * TILE, maps, 4, full(st), k0, bh, half);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                          // columns 8 j + cq and + 1
  const int t0 = q0 + r0;
  const uint8_t* kp = kpad + (long long)b * S;
  const TR* relh = rel ? rel + h * rel_hs : nullptr;

  float m[2], l[2], rl[2], acc[VW / 2], sc[32];
  uint32_t pa[16];
  TileBias<TR> bias;
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = (!kNorm && skip_max) ? 0.f : -CUDART_INF_F;
    l[hh] = 0.f;
    rl[hh] = 0.f;
  }

  // the finished, masked scores of tile it into sc
  auto scores = [&](int it) {
    const int st = it % STAGES, k0 = (it % ntiles) * BK;
    mbar_wait(full(st), (it / STAGES) & 1);
    issue_scores<DP>(sc, sq, stage(st));
    load_bias(bias, relh, rel_rs, rel_vec, kp, k0, S, t0, Tq, lane, cq);  // while they run
    wgmma_wait();
    fence_operand(sc);
    mask_scores(sc, bias, relh != nullptr, k0, S, t0, Tq, causal, lane);
  };
  mbar_wait(qbar, 0);
  scores(0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const bool pv = !kNorm || it >= ntiles;
    if (!kNorm) {  // K1: the running max; acc and l rescaled to it
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        const float mnew = skip_max ? 0.f : fmaxf(m[hh], quad_max(tmax));
        const float scale = skip_max ? 1.f : fexp(m[hh] - mnew);
        l[hh] *= scale;
        m[hh] = mnew;
#pragma unroll
        for (int j = 0; j < VW / 8; ++j) {
          acc[4 * j + 2 * hh] *= scale;
          acc[4 * j + 2 * hh + 1] *= scale;
        }
      }
      // e = exp(w - m), rounded to bf16 for P.v below
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            sc[i] = fexp(sc[i] - m[hh]);
            rs += sc[i];  // the denominator sums the unrounded e, as the TPU kernel does
          }
        l[hh] += quad_sum(rs);
      }
    } else if (!pv) {  // K5 pass 1: each row's max and denominator
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        const float mnew = fmaxf(m[hh], quad_max(tmax));
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) rs += fexp(sc[4 * j + 2 * hh + e] - mnew);
        l[hh] = l[hh] * fexp(m[hh] - mnew) + quad_sum(rs);
        m[hh] = mnew;
      }
      if (it == ntiles - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (Sp > S) {  // the wrapper's Sp - S padded keys: score -1e9, v zero
            const float mnew = fmaxf(m[hh], NEG);
            l[hh] = l[hh] * fexp(m[hh] - mnew) + (float)(Sp - S) * fexp(NEG - mnew);
            m[hh] = mnew;
          }
          rl[hh] = 1.f / l[hh];
        }
      }
    } else {  // K5 pass 2: p = exp(w - m) / l, by a reciprocal and one correction
              // step (correctly rounded but in rare cases, an fp32 ulp off there)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float e = fexp(sc[i] - m[hh]);
        const float p = e * rl[hh];
        sc[i] = fmaf(fmaf(-p, l[hh], e), rl[hh], p);
      }
    }
    if (pv) {
      to_a_fragments(sc, pa);  // rounded to bf16
      issue_pv<DP>(acc, pa, stage(st) + 2 * TILE, Lay::vboxes(half));
      wgmma_wait();
      fence_regs(acc);
    }
    if (it + 1 < n) scores(it + 1);  // before this stage is released: measured faster
    mbar_arrive(empty(st));  // the products have read the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    if (t >= Tq) continue;
    const float denom = kNorm ? 1.f : (skip_max ? fmaxf(l[hh], 1e-38f) : l[hh]);
    __nv_bfloat16* o = out + ((long long)bh * Tq + t) * D + c0 + cq;
#pragma unroll
    for (int j = 0; j < VW / 8; ++j) {
      if (c0 + 8 * j >= D) break;  // the zero-filled columns past D
      const float a = acc[4 * j + 2 * hh], c = acc[4 * j + 2 * hh + 1];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          kNorm ? __floats2bfloat162_rn(a, c) : __floats2bfloat162_rn(a / denom, c / denom);
    }
    // K3: the row's logsumexp, from one thread of the quad that holds it
    if (!kNorm && lse && half == 0 && (lane & 3) == 0)
      lse[(long long)bh * Tq + t] = skip_max ? logf(denom) : m[hh] + logf(denom);
  }
}

// ---- the deep route's kernel ------------------------------------------------

// The shared memory of fwd_deep: with kResident the chunks of q and pos_q;
// the score ring (ScoreRing; kResident: KeyRing), the operand ring (the DW
// blocks of v: 2 slots, kResident 1), two buffers of P, the rows' scales
// (two buffers) and denominators, the mbarriers (score ring, block ring, P
// full and empty x 2; kResident also q's) and 1 KB of slack for the
// 1024-byte alignment: 214,896 bytes whatever D, kResident 231,288.
template <bool kResident>
struct DeepFwd {
  using SRing = std::conditional_t<kResident, KeyRing, ScoreRing>;
  using VRing = std::conditional_t<kResident, Ring<1, DW * CHUNK>, BlockRing>;
  static constexpr int SSTAGES = kResident ? 4 : 3, VSTAGES = kResident ? 1 : 2;
  static constexpr uint32_t OFF_S = kResident ? 2 * DEEP_RESIDENT_NK * CHUNK : 0;
  static constexpr uint32_t OFF_V = OFF_S + SSTAGES * (kResident ? 1 : 2) * CHUNK;
  static constexpr uint32_t OFF_P = OFF_V + VSTAGES * DW * CHUNK;
  static constexpr uint32_t OFF_ROWS = OFF_P + 2 * PTILE;  // scale[2][64], l[64] fp32
  static constexpr uint32_t OFF_BAR = OFF_ROWS + 3 * BQ * 4;
  static constexpr int NBARS = 2 * SSTAGES + 2 * VSTAGES + 4 + kResident;
  static constexpr size_t SMEM = OFF_BAR + 8 * NBARS + 1024;
};

// The deep route (DP == DEEP: any head dim D past 256, a multiple of 8) of
// K1, K3 (lse not null) and K5 (kNorm), for one (b, h, 64-row q tile, group
// of up to DW column blocks of 128): block x is q tile x / groups, group
// x % groups, groups = ceil(nch / DW), nch = ceil(D / 128). Nothing is
// resident; D streams through the score products in chunks of 128.
//   - The producer warpgroup (setmaxnreg down to 32): warp 0 streams, for
//     each key tile, the chunk pairs (q, k) of every chunk, then (pos_q,
//     pos_k), into the score ring; warp 1 the group's blocks of v of each key
//     tile (K5: of its second pass) into the block ring.
//   - The builder warpgroup (setmaxnreg up to 160) builds each key tile's
//     scores once for the whole group: the pairs' products in that order,
//     each in a fresh accumulator (deep_products), then rel, the masks and
//     the softmax as kernel<DP> does; it writes P, rounded to bf16, into one
//     of two shared-memory buffers as wgmma's A operand, K1's per-row rescale
//     factor beside it, behind fence.proxy.async (generic stores, then the
//     async proxy reads them) and the buffer's "full" mbarrier; it waits for
//     the buffer's "empty" mbarrier before writing it again, so it runs up to
//     a tile ahead of the block warpgroups.
//   - Block warpgroup w (of DW, 96 registers) owns column block DW group + w
//     (none past nch: it then only keeps the barriers' counts): its 64 x 128
//     fp32 accumulator, rescaled by K1's factors, += P . v from shared memory.
// Every block of a query tile sees the same scores, m, l and P, bit for bit:
// one builder computes them for a CTA's blocks, and the CTAs of one query
// tile run the same instructions on the same chunks. Scores are built
// ceil(nch / DW) times per (q tile, key tile): once at D 384, twice at 768.
template <bool kNorm, typename TR, bool kResident>
__global__ void __launch_bounds__(DEEP_THREADS, 1) fwd_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 5> maps, const TR* __restrict__ rel,
    const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int rel_vec, int causal,
    int skip_max, int D) {
  using L = DeepFwd<kResident>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const rows = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::OFF_ROWS);
  const uint32_t bars = base + L::OFF_BAR;
  const uint32_t vbars = bars + 16 * L::SSTAGES, pbars = vbars + 16 * L::VSTAGES;
  const uint32_t qbar = pbars + 32;  // kResident: q and pos_q landed
  const uint32_t pbuf = base + L::OFF_P;
  const int nk = deep_chunks(D), groups = (nk + DW - 1) / DW;
  const int q0 = blockIdx.x / groups * BQ, grp = blockIdx.x % groups;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int blk0 = DW * grp, nb = min(DW, nk - blk0);  // this CTA's column blocks
  const int ntiles = (S + BK - 1) / BK;
  const int n = kNorm ? 2 * ntiles : ntiles;
  const int wg = threadIdx.x / NC, tid = threadIdx.x % NC;
  typename L::SRing sring{base + L::OFF_S, bars};
  typename L::VRing vring{base + L::OFF_V, vbars};

  if (threadIdx.x == 0) {
    sring.init(NC);
    vring.init(DW * NC);
    for (int i = 0; i < 2; ++i) {
      mbar_init(pbars + 8u * i, NC);             // full: the builder's threads
      mbar_init(pbars + 8u * (2 + i), DW * NC);  // empty: the block warpgroups'
    }
    if (kResident) mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup: one thread of warp 0 and one of warp 1
    regs_dec<DEEP_PRODUCER_REGS>();
    if (tid == 0) {
      if (kResident) {  // q's chunks, then pos_q's, once
        mbar_expect_tx(qbar, 2 * nk * CHUNK);
        for (int c = 0; c < 2 * nk; ++c) load_chunk(base + c * CHUNK, maps, c / nk, qbar, c % nk, q0, bh);
      }
      for (int it = 0; it < n; ++it) {
        const int k0 = (it % ntiles) * BK;
        for (int c = 0; c < 2 * nk; ++c) {  // q . k chunk by chunk, then pos_q . pos_k
          const int i = c < nk ? 0 : 1;
          if (kResident) {
            const int st = sring.put(CHUNK);
            load_chunk(sring.slot(st), maps, i + 2, sring.full(st), c % nk, k0, bh);
          } else {
            const int st = sring.put(2 * CHUNK);
            load_chunk(sring.slot(st), maps, i, sring.full(st), c % nk, q0, bh);
            load_chunk(sring.slot(st) + CHUNK, maps, i + 2, sring.full(st), c % nk, k0, bh);
          }
        }
      }
    } else if (tid == 32) {
      for (int it = kNorm ? ntiles : 0; it < n; ++it) {  // the group's blocks of v
        const int st = vring.put(nb * CHUNK), k0 = (it % ntiles) * BK;
        for (int w = 0; w < nb; ++w)
          load_chunk(vring.slot(st) + w * CHUNK, maps, 4, vring.full(st), blk0 + w, k0, bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                  // columns 8 j + cq and + 1
  const int t0 = q0 + r0;
  auto pfull = [=](int i) { return pbars + 8u * i; };
  auto pempty = [=](int i) { return pbars + 8u * (2 + i); };

  if (wg == 1) {  // the builder
    regs_inc<DEEP_BUILDER_REGS>();
    const uint8_t* kp = kpad + (long long)b * S;
    const TR* relh = rel ? rel + h * rel_hs : nullptr;
    float m[2], l[2], rl[2], sc[32];
    TileBias<TR> bias;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = (!kNorm && skip_max) ? 0.f : -CUDART_INF_F;
      l[hh] = 0.f;
      rl[hh] = 0.f;
    }
    int np = 0;  // P tiles written
    if (kResident) mbar_wait(qbar, 0);
    for (int it = 0; it < n; ++it) {
      const int k0 = (it % ntiles) * BK;
      const bool pv = !kNorm || it >= ntiles;
      load_bias(bias, relh, rel_rs, rel_vec, kp, k0, S, t0, Tq, lane, cq);  // while they run
      deep_products<kResident>(sc, sring, 2 * nk, base);
      mask_scores(sc, bias, relh != nullptr, k0, S, t0, Tq, causal, lane);
      float scale[2] = {1.f, 1.f};
      if (!kNorm) {  // K1: the running max; l rescaled to it (acc by the block warpgroups)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tmax = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
          const float mnew = skip_max ? 0.f : fmaxf(m[hh], quad_max(tmax));
          scale[hh] = skip_max ? 1.f : fexp(m[hh] - mnew);
          l[hh] *= scale[hh];
          m[hh] = mnew;
        }
        // e = exp(w - m), rounded to bf16 for P.v
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              sc[i] = fexp(sc[i] - m[hh]);
              rs += sc[i];  // the denominator sums the unrounded e, as the TPU kernel does
            }
          l[hh] += quad_sum(rs);
        }
      } else if (!pv) {  // K5 pass 1: each row's max and denominator
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tmax = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
          const float mnew = fmaxf(m[hh], quad_max(tmax));
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) rs += fexp(sc[4 * j + 2 * hh + e] - mnew);
          l[hh] = l[hh] * fexp(m[hh] - mnew) + quad_sum(rs);
          m[hh] = mnew;
        }
        if (it == ntiles - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (Sp > S) {  // the wrapper's Sp - S padded keys: score -1e9, v zero
              const float mnew = fmaxf(m[hh], NEG);
              l[hh] = l[hh] * fexp(m[hh] - mnew) + (float)(Sp - S) * fexp(NEG - mnew);
              m[hh] = mnew;
            }
            rl[hh] = 1.f / l[hh];
          }
        }
      } else {  // K5 pass 2: p = exp(w - m) / l, by a reciprocal and one correction step
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          const float e = fexp(sc[i] - m[hh]);
          const float p = e * rl[hh];
          sc[i] = fmaf(fmaf(-p, l[hh], e), rl[hh], p);
        }
      }
      if (pv) {  // P (and K1's rescale) for the block warpgroups
        const int i = np & 1;
        if (np >= 2) mbar_wait(pempty(i), ((np >> 1) - 1) & 1);
        store_a_tile(pbuf + i * PTILE, sc, r0, cq);  // rounded to bf16
        if (!kNorm && (lane & 3) == 0) {
          rows[BQ * i + r0] = scale[0];
          rows[BQ * i + r0 + 8] = scale[1];
        }
        fence_async_smem();  // the generic stores, then wgmma's reads
        mbar_arrive(pfull(i));
        ++np;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + 8 * hh;
      const float denom = kNorm ? 1.f : (skip_max ? fmaxf(l[hh], 1e-38f) : l[hh]);
      if ((lane & 3) == 0) rows[2 * BQ + r0 + 8 * hh] = denom;
      // K3: the row's logsumexp, by the first group's builder
      if (!kNorm && lse && grp == 0 && (lane & 3) == 0 && t < Tq)
        lse[(long long)bh * Tq + t] = skip_max ? logf(denom) : m[hh] + logf(denom);
    }
    named_sync(2, (1 + DW) * NC);  // the denominators, to the block warpgroups
    return;
  }

  // a block warpgroup: column block blk0 + w, if it exists
  const int w = wg - 2;
  const bool has = w < nb;
  const int c0 = DEEP_CHUNK * (blk0 + w);  // its columns of v and out
  float acc[DEEP_CHUNK / 2];
#pragma unroll
  for (int i = 0; i < DEEP_CHUNK / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < ntiles; ++it) {  // the key tiles with P.v (K5: the second pass)
    const int i = it & 1;
    mbar_wait(pfull(i), (it >> 1) & 1);
    if (!kNorm) {  // K1: acc rescaled to the row's new max
      const float s0 = rows[BQ * i + r0], s1 = rows[BQ * i + r0 + 8];
#pragma unroll
      for (int j = 0; j < DEEP_CHUNK / 8; ++j) {
        acc[4 * j] *= s0;
        acc[4 * j + 1] *= s0;
        acc[4 * j + 2] *= s1;
        acc[4 * j + 3] *= s1;
      }
    }
    const int vs = vring.take();
    if (has) block_products<1>(acc, pbuf + i * PTILE, vring.slot(vs) + w * CHUNK);
    vring.release(vs);
    mbar_arrive(pempty(i));
  }
  named_sync(2, (1 + DW) * NC);
  if (!has) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    if (t >= Tq) continue;
    const float denom = rows[2 * BQ + r0 + 8 * hh];
    __nv_bfloat16* o = out + ((long long)bh * Tq + t) * D + c0 + cq;
#pragma unroll
    for (int j = 0; j < DEEP_CHUNK / 8; ++j) {
      if (c0 + 8 * j >= D) break;  // the zero-filled columns past D
      const float a = acc[4 * j + 2 * hh], c = acc[4 * j + 2 * hh + 1];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          kNorm ? __floats2bfloat162_rn(a, c) : __floats2bfloat162_rn(a / denom, c / denom);
    }
  }
}

// ---- host side -------------------------------------------------------------

// The tensor maps of N bf16 streams [B*H, rows[i], D] in 64-row boxes of HeadTile<DP>.
template <int DP, int N>
inline int stream_maps(Maps<DP, N>& maps, const void* const (&ptrs)[N], const int (&rows)[N],
                       long long bh, int D) {
  for (int i = 0; i < N; ++i)
    if (const int err = head_maps(&maps.lo[HeadTile<DP>::NLO ? i : 0],
                                  &maps.hi[HeadTile<DP>::NHI ? i : 0], ptrs[i], D, DP, rows[i],
                                  bh, BK))
      return err;
  return 0;
}

// 0 where a deep kernel has the registers at launch that its setmaxnreg
// budget assumes (DEEP_LAUNCH_REGS: the builder's increase waits for
// registers that the producer's decrease frees, so any other count could
// hang it), else cudaErrorInvalidConfiguration: the launch is refused.
inline int deep_regs_ok(const void* fn) {
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, fn)) return (int)err;
  return attr.numRegs == DEEP_LAUNCH_REGS ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Launches the deep route (fwd_deep; q and pos_q resident where D has at
// most DEEP_RESIDENT_NK chunks) on `stream`, the arguments as launch's.
template <bool kNorm, typename TR, bool kResident>
int launch_deep_as(const void* q, const void* pq, const void* k, const void* pk, const void* v,
                const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq,
                int S, int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
                cudaStream_t stream) {
  Maps<DEEP_CHUNK, 5> maps;
  if (const int err = stream_maps<DEEP_CHUNK, 5>(maps, {q, pq, k, pk, v}, {Tq, Tq, S, S, S},
                                                 (long long)B * H, D))
    return err;
  const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % (2 * sizeof(TR)) == 0 &&
                      rel_rs % 2 == 0 && rel_hs % 2 == 0 && S % 2 == 0;
  const void* fn = (const void*)fwd_deep<kNorm, TR, kResident>;
  constexpr size_t smem = DeepFwd<kResident>::SMEM;
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure(fn, smem)) return err;
  if (const int err = deep_regs_ok(fn)) return err;
  const int groups = (deep_chunks(D) + DW - 1) / DW;
  const dim3 grid((Tq + BQ - 1) / BQ * groups, H, B);
  fwd_deep<kNorm, TR, kResident><<<grid, DEEP_THREADS, smem, stream>>>(
      maps, static_cast<const TR*>(rel), static_cast<const uint8_t*>(kpad),
      static_cast<__nv_bfloat16*>(out), lse, H, Tq, S, Sp, rel_hs, rel_rs, rel_vec, causal,
      skip_max, D);
  return (int)cudaGetLastError();
}

template <bool kNorm, typename TR>
int launch_deep(const void* q, const void* pq, const void* k, const void* pk, const void* v,
                const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq,
                int S, int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
                cudaStream_t stream) {
  if (deep_chunks(D) <= DEEP_RESIDENT_NK)
    return launch_deep_as<kNorm, TR, true>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq, S,
                                           Sp, rel_hs, rel_rs, causal, skip_max, D, stream);
  return launch_deep_as<kNorm, TR, false>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq, S, Sp,
                                          rel_hs, rel_rs, causal, skip_max, D, stream);
}

// Launches the core on `stream` for bf16 streams [B, H, Tq or S, D] (16-byte
// aligned, D <= DP a multiple of 8; the deep route past 256: launch_deep) and
// rel of type TR (or null); K1's walk also writes the fp32 logsumexp
// [B, H, Tq] where lse is not null (K3). Returns a cudaError_t code.
template <int DP, bool kNorm, typename TR>
int launch(const void* q, const void* pq, const void* k, const void* pk, const void* v,
           const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq, int S,
           int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
           cudaStream_t stream) {
  if constexpr (DP == DEEP) {
    return launch_deep<kNorm, TR>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq, S, Sp, rel_hs,
                                  rel_rs, causal, skip_max, D, stream);
  } else {
    Maps<DP, 5> maps;
    if (const int err = stream_maps<DP, 5>(maps, {q, pq, k, pk, v}, {Tq, Tq, S, S, S},
                                           (long long)B * H, D))
      return err;
    // a pair of rel columns is one load where base, rows, heads and S keep it aligned
    const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % (2 * sizeof(TR)) == 0 &&
                        rel_rs % 2 == 0 && rel_hs % 2 == 0 && S % 2 == 0;
    constexpr size_t smem = Layout<DP>::SMEM_BYTES;
    static SmemOptIn opt_in;
    if (const int err = opt_in.ensure((const void*)kernel<DP, kNorm, TR>, smem)) return err;
    const dim3 grid((Tq + BQ - 1) / BQ * Layout<DP>::NCH, H, B);
    kernel<DP, kNorm, TR><<<grid, NT, smem, stream>>>(
        maps, static_cast<const TR*>(rel),
        static_cast<const uint8_t*>(kpad), static_cast<__nv_bfloat16*>(out), lse, H, Tq, S, Sp,
        rel_hs, rel_rs, rel_vec, causal, skip_max, D);
    return (int)cudaGetLastError();
  }
}

}  // namespace sm90
}  // namespace mk
