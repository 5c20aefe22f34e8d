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
// template parameter, compiled at 32, 64, 80 and 128; a head dim D runs on
// the smallest DP >= D (common.cuh::with_head_dim), D itself an argument.
// The instances 192 and 256 (D 129 to 256) and the deep route run on
// fwd_deep's CTAs (below).
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
//   - Past DP 128 whole-width outputs do not fit a CTA: DP / 2 fp32
//     accumulator registers a thread (128 at 256), and q, pos_q and 3 stages
//     of k, pos_k and v would take 271 KB at 192 and 362 KB at 256. So past
//     128 the head dim streams through the score products in chunks of 128
//     columns (the pairs (q, k) of chunk 0 .. nk - 1, then (pos_q, pos_k),
//     each pair's k-steps in a fresh accumulator added in fp32:
//     deep_products), and the output splits into nch = ceil(D / 128) column
//     blocks of 128, each owned by one consumer warpgroup of a CTA (a 64 x
//     128 fp32 accumulator, 64 registers a thread). A builder warpgroup
//     builds each key tile's scores and P once for the CTA's blocks and
//     passes P through shared memory as wgmma's A operand; setmaxnreg moves
//     the producer warpgroup's registers to the builder (fwd_deep).
//       - The pair route (head dims 129 to 256, the instances 192 and 256,
//         nch = 2): a CTA owns both blocks, PW = 2 block warpgroups, so each
//         score tile is built once for the whole output; q and pos_q stay
//         resident and the key side streams through a ring of 5 chunks.
//         Where the last chunk holds at most 64 columns (D <= 192) it is one
//         64-column box: its score products are 4 k-steps, its block's P.v
//         one N block, and its copies half a chunk. Its builder (224
//         registers) runs the tile's score k-steps back to back into one
//         accumulator (chained_products) and issues rel's and the pads'
//         loads so that nothing waits for them before the masks
//         (TileBias<TR, true>): ~775 cycles a tile for those loads against
//         ~1,760 for the guarded ones in the deep route's builder
//         (clock64 counters in a copy of the builder, H100).
//       - The deep route (past 256, DP == DEEP: any head dim D, a multiple
//         of 8): q and pos_q alone would take 96 KB at D 384, and beyond 512
//         more than a block's shared memory. A CTA owns up to DW = 3 blocks
//         (about 384 columns is what an SM's registers hold), so the scores
//         are built ceil(nch / 3) times per (q tile, key tile): once at D
//         384, twice at 768 (one block a CTA would build them nch times and
//         stream the score chunks as often, and that traffic sets the pace).
//         At D <= 384 q and pos_q stay resident and only the key side
//         streams; past it nothing is resident.
//     ptxas (CUDA 12.8), deep route: 96 registers at launch in every
//     instance; no spills in K1/K3 (4 bytes with q resident), 6-10 bytes in
//     K5 with bf16 rel, 348-496 with fp32 rel (the builder's 32 fp32 rel
//     values a tile). The pair route: 128 at launch (the builder up to
//     224), no spills in any instance.
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
// chip_smoke.py's build phase prints the report of each build.
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

// The shared-memory layout at instance width DP (32 to 128): 64-row tiles of
// HeadTile<DP> (q, pos_q, k, pos_k, v).
template <int DP>
struct Layout {
  static_assert(DP <= 128, "past 128: the pair route (fwd_deep with PW blocks)");
  static constexpr int STAGES = 3;  // ring depth
  static constexpr uint32_t TILE = HeadTile<DP>::BYTES;  // bytes of one 64-row bf16 tile
  static constexpr uint32_t OFF_KV = 2 * TILE;  // the ring, after q and pos_q
  static constexpr uint32_t STAGE = 3 * TILE;   // k, pos_k, v
  static constexpr uint32_t OFF_BAR = OFF_KV + STAGES * STAGE;
  // + 1 KB of slack: the base is aligned to 1024 bytes, the 128-byte swizzle's period
  static constexpr size_t SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;
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

// chunk c (columns 128 c .. 128 c + 127, zeros past D) of stream i's rows
// row .. row + 63 into the HeadTile<128> tile at dst: its nbox 64-column
// boxes (1: the first alone, the pair route's short last chunk)
template <int N>
__device__ __forceinline__ void load_chunk(uint32_t dst, const Maps<DEEP_CHUNK, N>& m, int i,
                                           uint32_t bar, int c, int row, int bh, int nbox = 2) {
  tma_load3(dst, &m.lo[i], bar, DEEP_CHUNK * c, row, bh);
  if (nbox == 2)
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
// kLate (the pair route's builders): every load unconditional, at an index
// clamped into the tensors, and the pad bytes kept as loaded, so that no
// instruction waits for a load before mask_scores; the masks drop what lies
// past S or Tq (mask_scores tests lane < lim for the pads). The guarded
// loads, whose zero fill waits for them, take ~1,760 cycles a tile in the
// deep route's builder, the unguarded ones ~775 in the pair route's
// (clock64 counters in a copy of the builders, H100).
template <typename TR, bool kLate = false> struct TileBias {
  typename RelPair<TR>::type rv[2][8];
  std::conditional_t<kLate, uint8_t, bool> pad0, pad1;
};

template <typename TR, bool kLate>
__device__ __forceinline__ void load_bias(TileBias<TR, kLate>& a, const TR* relh, long long rel_rs,
                                          bool rel_vec, const uint8_t* kp, int k0, int S, int t0,
                                          int Tq, int lane, int cq) {
  const int lim = S - k0;  // keys of the tile that exist
  if constexpr (kLate) {
    a.pad0 = kp[k0 + min(lane, lim - 1)];
    a.pad1 = kp[k0 + min(lane + 32, lim - 1)];
  } else {
    a.pad0 = lane < lim && kp[k0 + lane];
    a.pad1 = lane + 32 < lim && kp[k0 + 32 + lane];
  }
  if (!relh) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    if (kLate && rel_vec) {  // S even: a pair at c <= lim - 2 lies inside the row
      const TR* row = relh + (long long)min(t, Tq - 1) * rel_rs + k0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        a.rv[hh][j] = load_pair(row + min(8 * j + cq, lim - 2), true, true);
      continue;
    }
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
template <bool kEdge, typename TR, bool kLate>
__device__ __forceinline__ void mask_tile(float (&sc)[32], const TileBias<TR, kLate>& a, bool rel,
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

template <typename TR, bool kLate>
__device__ __forceinline__ void mask_scores(float (&sc)[32], const TileBias<TR, kLate>& a, bool rel,
                                            int k0, int S, int t0, int Tq, int causal, int lane) {
  const int lim = S - k0, cq = 2 * (lane & 3);
  // the tile's pad bits, shifted so that this thread's columns sit at 8 j' + e
  const unsigned pad_lo = __ballot_sync(0xffffffffu, a.pad0 && (!kLate || lane < lim)) >> cq;
  const unsigned pad_hi = __ballot_sync(0xffffffffu, a.pad1 && (!kLate || lane + 32 < lim)) >> cq;
  if (causal || lim < BK)
    mask_tile<true>(sc, a, rel, pad_lo, pad_hi, lim, k0, t0, Tq, causal, lane);
  else
    mask_tile<false>(sc, a, rel, pad_lo, pad_hi, lim, k0, t0, Tq, causal, lane);
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

// issue_pv_products, committed, not waited.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&pa)[16],
                                         uint32_t sv) {
  wgmma_fence();
  issue_pv_products<DP>(acc, pa, sv);
  wgmma_commit();
  fence_regs(acc);
}

// ---- past head dim 128: the pair route (129 to 256) and the deep route ----

constexpr uint32_t CHUNK = HeadTile<DEEP_CHUNK>::BYTES;  // a 64 x 128 bf16 chunk: 16 KB
constexpr uint32_t PTILE = BQ * BK * 2;  // a 64 x 64 bf16 tile of P (or dW): 8 KB
constexpr int DW = 3;  // column blocks a deep CTA owns: one block warpgroup each
constexpr int PW = 2;  // column blocks a CTA of the pair route owns: the whole output
// registers a thread at launch (__launch_bounds__(640, 1): 65536 / 640 rounded
// down to 8), then the producer's and the builder's after setmaxnreg; the
// block warpgroups keep the launch's: 32 + 160 + 3 x 96 = 5 x 96 (24 + 168 made
// ptxas spill more in K5 with fp32 rel)
constexpr int DEEP_LAUNCH_REGS = 96, DEEP_PRODUCER_REGS = 32, DEEP_BUILDER_REGS = 160;
static_assert(DEEP_PRODUCER_REGS + DEEP_BUILDER_REGS + DW * DEEP_LAUNCH_REGS ==
                  (2 + DW) * DEEP_LAUNCH_REGS,
              "setmaxnreg moves registers between warpgroups, within the launch's pool");
// the pair route's (__launch_bounds__(512, 1)): 32 + 224 + 2 x 128 = 4 x 128
constexpr int PAIR_LAUNCH_REGS = 128, PAIR_PRODUCER_REGS = 32, PAIR_BUILDER_REGS = 224;
static_assert(PAIR_PRODUCER_REGS + PAIR_BUILDER_REGS + PW * PAIR_LAUNCH_REGS ==
                  (2 + PW) * PAIR_LAUNCH_REGS,
              "setmaxnreg moves registers between warpgroups, within the launch's pool");

// A ring of STAGES slots of SLOT bytes as its threads walk it: item seq sits
// in slot seq % STAGES, in the slot's (seq / STAGES)-th phase; the producer
// and the consumers count the same items in the same order. Its mbarriers:
// full[STAGES], then empty[STAGES].
template <int STAGES, uint32_t SLOT>
struct Ring {
  static constexpr int DEPTH = STAGES;
  static constexpr uint32_t BYTES = STAGES * SLOT;  // its slots' shared memory
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

// The pair route's rings (head dims 129 to 256: nk = 2 chunks, both blocks a
// CTA): the forward keeps q's and pos_q's 2 chunks each resident and streams
// the key side through PairKeyRing, its blocks of v through PairBlockRing;
// K4 streams its score pairs through PairScoreRing.
using PairScoreRing = Ring<4, 2 * CHUNK>;
using PairKeyRing = Ring<5, CHUNK>;
using PairBlockRing = Ring<2, PW * CHUNK>;

// A CTA of W block warpgroups (DW: the deep route, PW: the pair route): its
// threads, rings and register budget.
template <int W> struct Cta;
template <> struct Cta<DW> {
  using SRing = ScoreRing;
  using KRing = KeyRing;
  using BRing = BlockRing;
  using ResBRing = Ring<1, DW * CHUNK>;  // the block ring beside resident q
  static constexpr int RESIDENT_NK = DEEP_RESIDENT_NK;
  static constexpr int LAUNCH_REGS = DEEP_LAUNCH_REGS, PRODUCER_REGS = DEEP_PRODUCER_REGS,
                       BUILDER_REGS = DEEP_BUILDER_REGS;
};
template <> struct Cta<PW> {
  using SRing = PairScoreRing;
  using KRing = PairKeyRing;
  using BRing = PairBlockRing;
  using ResBRing = PairBlockRing;
  static constexpr int RESIDENT_NK = 2;
  static constexpr int LAUNCH_REGS = PAIR_LAUNCH_REGS, PRODUCER_REGS = PAIR_PRODUCER_REGS,
                       BUILDER_REGS = PAIR_BUILDER_REGS;
};
// a CTA of W blocks: a producer warpgroup, the builder warpgroup, W block warpgroups
template <int W>
constexpr int cta_threads() { return NC * (2 + W); }

// The 64-column boxes of the last chunk of head dim D on a CTA of W blocks:
// 1 where the pair route's last chunk holds at most 64 columns (D <= 192),
// else 2 (a constant 2 on the deep route, whose code it leaves as it was).
template <int W>
__device__ __forceinline__ int last_boxes(int D) {
  return W == PW && D - DEEP_CHUNK * (deep_chunks(D) - 1) <= 64 ? 1 : 2;
}
// the boxes of chunk c of nk, the last holding lb
__device__ __forceinline__ int chunk_boxes(int c, int nk, int lb) { return c == nk - 1 ? lb : 2; }
// the bytes of chunk c's copies on a CTA of W blocks (the deep route: CHUNK)
template <int W>
__device__ __forceinline__ uint32_t chunk_bytes(int c, int nk, int lb) {
  if constexpr (W == PW)
    return chunk_boxes(c, nk, lb) * HeadTile<DEEP_CHUNK>::LO_BOX;
  else
    return CHUNK;
}
// the bytes of the column blocks blk0 .. blk0 + nb - 1's copies
template <int W>
__device__ __forceinline__ uint32_t blocks_bytes(int blk0, int nb, int nk, int lb) {
  if constexpr (W == PW) {
    uint32_t bytes = 0;
    for (int w = 0; w < nb; ++w) bytes += chunk_bytes<W>(blk0 + w, nk, lb);
    return bytes;
  } else {
    return nb * CHUNK;
  }
}

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

// The pair route's products (nk = 2 chunks): acc = the sum over the ring's
// next n items of A . B^T as deep_products takes them, but in one fp32
// accumulator over all their k-steps (2 D / 16 <= 32 of them for the scores:
// the order of one whole-width product, as at the instances up to 128), each
// item's k-steps committed as one group and left running while the next
// item's are issued; an item's slot is released once the group after it has
// been committed and its own has completed. Item c is chunk c % nk of its
// streams; where lb is 1 the last chunk is one 64-column box, 4 k-steps. So
// the tensor cores see the tile's k-steps back to back, with no wait and no
// fp32 adds between items.
template <bool kResident = false, class R>
__device__ __forceinline__ void chained_products(float (&acc)[32], R& r, int n, uint32_t res,
                                                 int nk, int lb) {
  int held = -1;
  for (int c = 0; c < n; ++c) {
    const int st = r.take();
    const uint32_t a = kResident ? res + c * CHUNK : r.slot(st);
    const uint32_t b = kResident ? r.slot(st) : r.slot(st) + CHUNK;
    wgmma_fence();
    if (chunk_boxes(c % nk, nk, lb) == 2)
      issue_kmajor<DEEP_CHUNK>(acc, a, b, c);
    else
      issue_kmajor<64>(acc, a, b, c);
    wgmma_commit();
    wgmma_wait_n<1>();
    if (held >= 0) r.release(held);
    held = st;
  }
  wgmma_wait();
  fence_operand(acc);
  r.release(held);
}

// The score (or dP) products of a CTA of W blocks: chained on the pair route,
// a fresh accumulator an item on the deep route.
template <int W, bool kResident = false, class R>
__device__ __forceinline__ void score_products(float (&acc)[32], R& r, int n, uint32_t res,
                                               int nk, int lb) {
  if constexpr (W == PW)
    chained_products<kResident>(acc, r, n, res, nk, lb);
  else
    deep_products<kResident>(acc, r, n, res);
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
// A_p . B, B the 64 x 128 chunk at sb read MN-major (its first NBOX
// 64-column boxes one N block each; the columns of a box not read stay as
// they were): a block warpgroup's product, issued, committed and waited.
template <int NP, int NBOX>
__device__ __forceinline__ void block_products_of(float (&acc)[DEEP_CHUNK / 2], uint32_t pa,
                                                  uint32_t sb) {
  using HT = HeadTile<DEEP_CHUNK>;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
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

// block_products_of with nbox (1 or 2) boxes of B
template <int NP>
__device__ __forceinline__ void block_products(float (&acc)[DEEP_CHUNK / 2], uint32_t pa,
                                               uint32_t sb, int nbox = 2) {
  if (nbox == 2)
    block_products_of<NP, 2>(acc, pa, sb);
  else
    block_products_of<NP, 1>(acc, pa, sb);
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
// Block x is the q tile.
template <int DP, bool kNorm, typename TR>
__global__ void __launch_bounds__(NT, DP < 128 ? 2 : 1) kernel(
    const __grid_constant__ Maps<DP, 5> maps, const TR* __restrict__ rel,
    const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int rel_vec, int causal,
    int skip_max, int D) {
  using Lay = Layout<DP>;
  constexpr int STAGES = Lay::STAGES;
  constexpr uint32_t TILE = Lay::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;  // q, then pos_q at + TILE
  const uint32_t bars = base + Lay::OFF_BAR;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + Lay::OFF_KV + Lay::STAGE * st; };  // k, pos_k, v

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
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
        mbar_expect_tx(full(st), (with_v ? 3 : 2) * TILE);
        load_tile(stage(st), maps, 2, full(st), k0, bh);
        load_tile(stage(st) + TILE, maps, 3, full(st), k0, bh);
        if (with_v) load_tile(stage(st) + 2 * TILE, maps, 4, full(st), k0, bh);
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

  float m[2], l[2], rl[2], acc[DP / 2], sc[32];
  uint32_t pa[16];
  TileBias<TR> bias;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
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
        for (int j = 0; j < DP / 8; ++j) {
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
      issue_pv<DP>(acc, pa, stage(st) + 2 * TILE);
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
    __nv_bfloat16* o = out + ((long long)bh * Tq + t) * D + cq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= D) break;  // the zero-filled columns past D
      const float a = acc[4 * j + 2 * hh], c = acc[4 * j + 2 * hh + 1];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          kNorm ? __floats2bfloat162_rn(a, c) : __floats2bfloat162_rn(a / denom, c / denom);
    }
    // K3: the row's logsumexp, from one thread of the quad that holds it
    if (!kNorm && lse && (lane & 3) == 0)
      lse[(long long)bh * Tq + t] = skip_max ? logf(denom) : m[hh] + logf(denom);
  }
}

// ---- the deep route's kernel ------------------------------------------------

// The shared memory of fwd_deep on a CTA of W blocks (Cta<W>): with
// kResident the chunks of q and pos_q; the score ring (SRing; kResident:
// KRing), the operand ring (the W blocks of v: BRing, kResident ResBRing),
// two buffers of P, the rows' scales (two buffers) and denominators, the
// mbarriers (score ring, block ring, P full and empty x 2; kResident also
// q's) and 1 KB of slack for the 1024-byte alignment. The deep route:
// 214,896 bytes whatever D, kResident 231,288; the pair route (always
// kResident) 231,320.
template <int W, bool kResident>
struct DeepFwd {
  using C = Cta<W>;
  using SRing = std::conditional_t<kResident, typename C::KRing, typename C::SRing>;
  using VRing = std::conditional_t<kResident, typename C::ResBRing, typename C::BRing>;
  static constexpr int SSTAGES = SRing::DEPTH, VSTAGES = VRing::DEPTH;
  static constexpr uint32_t OFF_S = kResident ? 2 * C::RESIDENT_NK * CHUNK : 0;
  static constexpr uint32_t OFF_V = OFF_S + SRing::BYTES;
  static constexpr uint32_t OFF_P = OFF_V + VRing::BYTES;
  static constexpr uint32_t OFF_ROWS = OFF_P + 2 * PTILE;  // scale[2][64], l[64] fp32
  static constexpr uint32_t OFF_BAR = OFF_ROWS + 3 * BQ * 4;
  static constexpr int NBARS = 2 * SSTAGES + 2 * VSTAGES + 4 + kResident;
  static constexpr size_t SMEM = OFF_BAR + 8 * NBARS + 1024;
};

// The routes past head dim 128 (a multiple of 8) of K1, K3 (lse not null)
// and K5 (kNorm): the deep route (W = DW, D past 256) and the pair route (W =
// PW, D 129 to 256), for one (b, h, 64-row q tile, group of up to W column
// blocks of 128): block x is q tile x / groups, group x % groups, groups =
// ceil(nch / W), nch = ceil(D / 128) (the pair route: one group). D streams
// through the score products in chunks of 128 (kResident: q's and pos_q's
// stay in shared memory, the key side streams).
//   - The producer warpgroup (setmaxnreg down to 32): warp 0 streams, for
//     each key tile, the chunk pairs (q, k) of every chunk, then (pos_q,
//     pos_k), into the score ring; warp 1 the group's blocks of v of each key
//     tile (K5: of its second pass) into the block ring.
//   - The builder warpgroup (setmaxnreg up to Cta<W>::BUILDER_REGS) builds
//     each key tile's scores once for the whole group: the pairs' products
//     in that order (score_products: on the deep route each in a fresh
//     accumulator, on the pair route chained), then rel, the masks and
//     the softmax as kernel<DP> does; it writes P, rounded to bf16, into one
//     of two shared-memory buffers as wgmma's A operand, K1's per-row rescale
//     factor beside it, behind fence.proxy.async (generic stores, then the
//     async proxy reads them) and the buffer's "full" mbarrier; it waits for
//     the buffer's "empty" mbarrier before writing it again, so it runs up to
//     a tile ahead of the block warpgroups.
//   - Block warpgroup w (of W, the launch's registers) owns column block
//     W group + w (none past nch: it then only keeps the barriers' counts): its 64 x 128
//     fp32 accumulator, rescaled by K1's factors, += P . v from shared memory.
// Every block of a query tile sees the same scores, m, l and P, bit for bit:
// one builder computes them for a CTA's blocks, and the CTAs of one query
// tile run the same instructions on the same chunks. Scores are built
// ceil(nch / W) times per (q tile, key tile): once at D 129 to 384, twice at
// 768. Where the pair route's last chunk is one 64-column box (last_boxes),
// its copies, score products and block are that box alone.
template <bool kNorm, typename TR, bool kResident, int W>
__global__ void __launch_bounds__(NC * (2 + W), 1) fwd_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 5> maps, const TR* __restrict__ rel,
    const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int rel_vec, int causal,
    int skip_max, int D) {
  using L = DeepFwd<W, kResident>;
  using C = Cta<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const rows = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::OFF_ROWS);
  const uint32_t bars = base + L::OFF_BAR;
  const uint32_t vbars = bars + 16 * L::SSTAGES, pbars = vbars + 16 * L::VSTAGES;
  const uint32_t qbar = pbars + 32;  // kResident: q and pos_q landed
  const uint32_t pbuf = base + L::OFF_P;
  const int nk = deep_chunks(D), groups = (nk + W - 1) / W, lb = last_boxes<W>(D);
  const int q0 = blockIdx.x / groups * BQ, grp = blockIdx.x % groups;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int blk0 = W * grp, nb = min(W, nk - blk0);  // this CTA's column blocks
  const int ntiles = (S + BK - 1) / BK;
  const int n = kNorm ? 2 * ntiles : ntiles;
  const int wg = threadIdx.x / NC, tid = threadIdx.x % NC;
  typename L::SRing sring{base + L::OFF_S, bars};
  typename L::VRing vring{base + L::OFF_V, vbars};

  if (threadIdx.x == 0) {
    sring.init(NC);
    vring.init(W * NC);
    for (int i = 0; i < 2; ++i) {
      mbar_init(pbars + 8u * i, NC);            // full: the builder's threads
      mbar_init(pbars + 8u * (2 + i), W * NC);  // empty: the block warpgroups'
    }
    if (kResident) mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup: one thread of warp 0 and one of warp 1
    regs_dec<C::PRODUCER_REGS>();
    if (tid == 0) {
      if (kResident) {  // q's chunks, then pos_q's, once
        mbar_expect_tx(qbar, W == PW ? 2 * ((nk - 1) * CHUNK + chunk_bytes<W>(nk - 1, nk, lb))
                                     : 2 * nk * CHUNK);
        for (int c = 0; c < 2 * nk; ++c)
          load_chunk(base + c * CHUNK, maps, c / nk, qbar, c % nk, q0, bh,
                     chunk_boxes(c % nk, nk, lb));
      }
      for (int it = 0; it < n; ++it) {
        const int k0 = (it % ntiles) * BK;
        for (int c = 0; c < 2 * nk; ++c) {  // q . k chunk by chunk, then pos_q . pos_k
          const int i = c < nk ? 0 : 1, nbox = chunk_boxes(c % nk, nk, lb);
          if (kResident) {
            const int st = sring.put(chunk_bytes<W>(c % nk, nk, lb));
            load_chunk(sring.slot(st), maps, i + 2, sring.full(st), c % nk, k0, bh, nbox);
          } else {
            const int st = sring.put(2 * chunk_bytes<W>(c % nk, nk, lb));
            load_chunk(sring.slot(st), maps, i, sring.full(st), c % nk, q0, bh, nbox);
            load_chunk(sring.slot(st) + CHUNK, maps, i + 2, sring.full(st), c % nk, k0, bh, nbox);
          }
        }
      }
    } else if (tid == 32) {
      for (int it = kNorm ? ntiles : 0; it < n; ++it) {  // the group's blocks of v
        const int st = vring.put(blocks_bytes<W>(blk0, nb, nk, lb)), k0 = (it % ntiles) * BK;
        for (int w = 0; w < nb; ++w)
          load_chunk(vring.slot(st) + w * CHUNK, maps, 4, vring.full(st), blk0 + w, k0, bh,
                     chunk_boxes(blk0 + w, nk, lb));
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
    regs_inc<C::BUILDER_REGS>();
    const uint8_t* kp = kpad + (long long)b * S;
    const TR* relh = rel ? rel + h * rel_hs : nullptr;
    float m[2], l[2], rl[2], sc[32];
    TileBias<TR, W == PW> bias;
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
      score_products<W, kResident>(sc, sring, 2 * nk, base, nk, lb);
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
    named_sync(2, (1 + W) * NC);  // the denominators, to the block warpgroups
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
    if (has)
      block_products<1>(acc, pbuf + i * PTILE, vring.slot(vs) + w * CHUNK,
                        chunk_boxes(blk0 + w, nk, lb));
    vring.release(vs);
    mbar_arrive(pempty(i));
  }
  named_sync(2, (1 + W) * NC);
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

// 0 where a kernel of a CTA of W blocks has the registers at launch that its
// setmaxnreg budget assumes (Cta<W>::LAUNCH_REGS: the builder's increase
// waits for registers that the producer's decrease frees, so any other count
// could hang it), else cudaErrorInvalidConfiguration: the launch is refused.
template <int W>
int deep_regs_ok(const void* fn) {
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, fn)) return (int)err;
  return attr.numRegs == Cta<W>::LAUNCH_REGS ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Launches fwd_deep on a CTA of W blocks (q and pos_q resident with
// kResident) on `stream`, the arguments as launch's.
template <bool kNorm, typename TR, bool kResident, int W>
int launch_deep_as(const void* q, const void* pq, const void* k, const void* pk, const void* v,
                   const void* rel, const void* kpad, void* out, float* lse, int B, int H,
                   int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int causal,
                   int skip_max, int D, cudaStream_t stream) {
  Maps<DEEP_CHUNK, 5> maps;
  if (const int err = stream_maps<DEEP_CHUNK, 5>(maps, {q, pq, k, pk, v}, {Tq, Tq, S, S, S},
                                                 (long long)B * H, D))
    return err;
  const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % (2 * sizeof(TR)) == 0 &&
                      rel_rs % 2 == 0 && rel_hs % 2 == 0 && S % 2 == 0;
  const void* fn = (const void*)fwd_deep<kNorm, TR, kResident, W>;
  constexpr size_t smem = DeepFwd<W, kResident>::SMEM;
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure(fn, smem)) return err;
  if (const int err = deep_regs_ok<W>(fn)) return err;
  const int groups = (deep_chunks(D) + W - 1) / W;
  const dim3 grid((Tq + BQ - 1) / BQ * groups, H, B);
  fwd_deep<kNorm, TR, kResident, W><<<grid, cta_threads<W>(), smem, stream>>>(
      maps, static_cast<const TR*>(rel), static_cast<const uint8_t*>(kpad),
      static_cast<__nv_bfloat16*>(out), lse, H, Tq, S, Sp, rel_hs, rel_rs, rel_vec, causal,
      skip_max, D);
  return (int)cudaGetLastError();
}

// Launches the core on `stream` for bf16 streams [B, H, Tq or S, D] (16-byte
// aligned, D <= DP a multiple of 8; past 256, DP == DEEP) and rel of type TR
// (or null); K1's walk also writes the fp32 logsumexp [B, H, Tq] where lse is
// not null (K3): kernel<DP> up to 128, the pair route (fwd_deep on PW blocks,
// q and pos_q resident) at 192 and 256, the deep route (DW blocks; q and
// pos_q resident where D has at most DEEP_RESIDENT_NK chunks) past 256.
// Returns a cudaError_t code.
template <int DP, bool kNorm, typename TR>
int launch(const void* q, const void* pq, const void* k, const void* pk, const void* v,
           const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq, int S,
           int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
           cudaStream_t stream) {
  if constexpr (DP == DEEP) {
    if (deep_chunks(D) > DEEP_RESIDENT_NK)
      return launch_deep_as<kNorm, TR, false, DW>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq,
                                                  S, Sp, rel_hs, rel_rs, causal, skip_max, D,
                                                  stream);
    return launch_deep_as<kNorm, TR, true, DW>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq, S,
                                               Sp, rel_hs, rel_rs, causal, skip_max, D, stream);
  } else if constexpr (DP > 128) {
    return launch_deep_as<kNorm, TR, true, PW>(q, pq, k, pk, v, rel, kpad, out, lse, B, H, Tq, S,
                                               Sp, rel_hs, rel_rs, causal, skip_max, D, stream);
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
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    kernel<DP, kNorm, TR><<<grid, NT, smem, stream>>>(
        maps, static_cast<const TR*>(rel),
        static_cast<const uint8_t*>(kpad), static_cast<__nv_bfloat16*>(out), lse, H, Tq, S, Sp,
        rel_hs, rel_rs, rel_vec, causal, skip_max, D);
    return (int)cudaGetLastError();
  }
}

}  // namespace sm90
}  // namespace mk
