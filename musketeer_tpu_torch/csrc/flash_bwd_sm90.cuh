// K4 in bf16 on Hopper's tensor cores: the attention backward, built from the
// primitives of flash_fwd_sm90.cuh (TMA ring, mbarriers, wgmma, the rel loads
// and masks of K1's walk).
//
// Replaces, for bf16 streams, musketeer_tpu/ops/flash_attention_bwd.py::_bwd
// (_bwd_kernel_fused; pallas_call at :388). With P rebuilt from K3's lse,
//   P  = exp(w - lse),   w = [q|pos_q].[k|pos_k]^T + rel + masks
//   dW = P o (dP - dsum),   dP = dO.v^T,   dsum = rowsum(dO o O)
//   [dq|dpos_q] = dW.[k|pos_k]      [dk|dpos_k] = dW^T.[q|pos_q]
//   dv = P^T.dO                      drel = sum_b dW
// fp32 launches stay on the FMA kernels of flash_attention_bwd.cu.
//
// Numerics. Scores, bias, masks, P and dW are fp32, as in the TPU kernel. dP
// comes from the bf16 dO and v with fp32 sums. Tensor cores take bf16
// operands where the TPU kernel widens its operands to fp32: P and dW are
// rounded to bf16 once as the A operands of the dv and dk|dpos_k products;
// dq|dpos_q take dW split into a bf16 high part and the bf16 rounding of
// what is left, two products into one fp32 accumulator, so dW enters them
// to about 16 bits (one rounding of dW to bf16 there put dq 1.78 bf16 steps
// from the fp32 function on a causal training input, plain PyTorch 0.49).
// The accumulators are fp32 and each gradient is rounded once to bf16. drel
// sums the unrounded fp32 dW over the batch, in order.
//
// Design. After flash_attention_bwd.cu's dsum pre-pass, the key-major and
// the query-major launches, each writing every element of its outputs once
// (deterministic, no atomics, nothing carried between CTAs), then drel's
// in-order sum; each launch rebuilds P and dW, 3 of the 13 [T, S] x 64
// products at DP 64. Each CTA has one
// consumer warpgroup and a producer warp, as K1's.
//   - Key-major, one CTA per (b, h, 64-key tile). k, pos_k and v are resident
//     (one TMA load); the q, pos_q and dO tiles of each 64-row q tile stream
//     through a ring of STAGES stages (as K1's: 24 KB at DP 64), beside the tile's
//     64 lse and 64 dsum values, which the producer warp's 32 lanes copy in
//     and release with their own mbarrier arrivals. The scores come out
//     transposed, S^T = [k|pos_k].[q|pos_q]^T and dP^T = v.dO^T (12 wgmma
//     k-steps, all operands K-major as in K1's scores), so that P^T and dW^T
//     sit in the accumulator layout, which packed to bf16 pairs is the A
//     fragment layout: dv += P^T.dO, dk += dW^T.q and dpos_k += dW^T.pos_q
//     (12 k-steps, B read MN-major from the stage as K1 reads v).
//     Registers: at DP 64 the three 64x64 fp32 accumulators are 96 a thread
//     and S^T and dP^T 64 more while P and dW form; those 64 then pack into
//     the 32 registers of the two A operands. Wider, three accumulators
//     would not fit 255 registers beside the rest, so the key-major work is
//     several launches of the same kernel, each rebuilding P (and dW where
//     it needs it): at DP 80 dv and dk (80 registers of accumulators), then
//     dpos_k (40); at DP 128 dv (without dP), dk, dpos_k (64 each).
//     rel is read transposed here: each accumulator pair spans two query rows
//     of rel[h]. Loaded directly in the accumulator layout that is 32
//     two-byte loads a thread a tile, each warp load touching 4 rows; instead
//     the consumer warpgroup stages the tile (64 rows of 128 bytes, whole
//     rows per warp load, pairs where aligned) in shared memory while the
//     score products run, behind one named barrier, and each thread reads its
//     transposed values from there (row stride 72 bf16: no bank conflicts).
//     On the card that ran faster than the direct loads.
//   - Query-major, one CTA per (b, h, 64-row q tile). q, pos_q and dO are
//     resident, k, pos_k and v stream as in K1; S and dP in K1's orientation,
//     rel and the masks by K1's load_bias and mask_scores (rel staged as
//     above ran slower here, as it did in K1); dq += dW.k and dpos_q +=
//     dW.pos_k, each on dW's high and low bf16 parts; at DP 128 two launches
//     (dq, then dpos_q: 64 registers of accumulators each), each rebuilding
//     dW. drel: the (first) launch's CTAs write their batch row's unrounded
//     fp32 dW into
//     a [B, H, Tq, S] scratch, and drel_sum adds the B rows in order into the
//     first. Looping over the batch in one CTA per (h, q tile) with a
//     read-modify-write, as the FMA kernel does, leaves 192 CTAs at the
//     encoder train shape (1.45 waves of 132 SMs at the one CTA per SM these
//     registers allow) and exposes the loads; it ran slower than the
//     partials and their sum.
//
// Edges. TMA zero-fills rows past S and past Tq, where a zero score against
// a zero lse would give P = exp(0) = 1: P and dW are forced to 0 for keys
// >= S and query rows >= Tq. The causal and pad masks stay at -1e9, so a
// fully masked row, whose lse rounds to -1e9, gets P = 1 on its S real keys,
// as in the TPU kernel and the FMA kernels; causally masked tiles are not
// skipped for the same reason.
//
// The tile width DP is a template parameter, compiled at 32, 64, 80, 128,
// 192 and 256 (its tiles as flash_fwd_sm90.cuh lays them out,
// sm90.cuh::HeadTile); the head dim D <= DP is an argument: the tiles'
// columns past D are zeros, which change no product, and no gradient column
// past D is stored.
//
// Past DP 128 (K4 tiled over D). A whole-width gradient would be DP / 2 fp32
// registers a thread, and the resident and streamed tiles at 3 stages would
// not fit (316 KB at 192, 414 KB at 256). Each gradient's columns split into
// halves of 128 (Layout::NCH, a grid dimension, as K1's output): a CTA owns
// one (b, h, 64-key or 64-row tile, column half), rebuilds P and dW from the
// full-width score and dP products, as the DP 128 launches already do per
// gradient, and accumulates its half (64 registers) against the half's
// 64-column boxes of the stage's tile. The key-major launches stay dv, dk,
// dpos_k and the query-major ones dq, dpos_q, as at 128. The resident and
// streamed tiles keep their width, in one stage (BwdLayout::STAGES; 166 KB
// at 192, 217 KB at 256): each element's sums are the DP 128 instance's, in
// the same order. Only the first half's CTAs write drel's partial.
//
// Bound. At the encoder train shape (B4 H12 T=S=980 D64) the function is 8
// [T, S] x 64 products (the two score products, dP, dv, dq, dk, dpos_q,
// dpos_k), 47.2 GFLOP against ~0.1 GB of streams and drel: 0.0477 ms at 989
// TFLOP/s bf16, set by the operations; these launches do 13 such products
// (dq and dpos_q two each), 16 at DP 80, 21 at DP 128 (a 64-deep product
// there 128 deep).
// At ofa_huge's train shape (B4 H16 T=S=980 D80) 8 products are 78.7 GFLOP:
// 0.080 ms. ptxas (CUDA 12.8) registers, key-major / query-major: 170 / 191
// at DP 32; 212 / 219 at 64; 196 (dv and dk), 153 (dpos_k) / 229 at 80; 145
// (dv), 178 (dk), 178 (dpos_k) / 219, 219 at 128; 153, 174, 174 / 212, 212
// at 192; 148, 172, 172 / 214, 214 at 256 (shared memory 167,448 and
// 216,600 bytes); no spills, so one CTA of 160 threads per SM;
// chip_smoke.py's build phase prints the report of each build.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace mk {
namespace sm90 {

constexpr uint32_t ROWS = 2 * BQ * sizeof(float);    // a stage's lse and dsum (key-major)
constexpr int REL_STRIDE = BK + 8;                   // bf16 row stride of a staged rel tile
constexpr uint32_t REL_TILE = BQ * REL_STRIDE * 2;   // bytes; two, one per tile parity

template <int DP>
struct BwdLayout {
  static constexpr int STAGES = DP <= 128 ? 3 : 1;  // ring depth
  static constexpr int VW = Layout<DP>::VW, NCH = Layout<DP>::NCH;  // a CTA's gradient columns
  static constexpr uint32_t TILE = Layout<DP>::TILE, STAGE = 3 * TILE;
  static constexpr uint32_t OFF_RING = 3 * TILE;  // after the 3 resident tiles
  static constexpr uint32_t OFF_ROWS = OFF_RING + STAGES * STAGE;
  static constexpr uint32_t OFF_REL = OFF_ROWS + STAGES * ROWS;
  static constexpr uint32_t OFF_BAR = OFF_REL + 2 * REL_TILE;
  static constexpr size_t SMEM = OFF_BAR + 8 * (2 * STAGES + 1) + 1024;
};

// which gradients a key-major launch writes (a bit set), and a query-major one
enum KvOut { KV_DV = 1, KV_DK = 2, KV_DPK = 4, KV_ALL = 7 };
enum QOut { Q_DQ = 1, Q_DPQ = 2, Q_ALL = 3 };

// a barrier among the consumer warpgroup alone (id 0 is __syncthreads')
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// rel[h] rows q0 .. q0 + 63, columns k0 .. k0 + 63 into buf [64][REL_STRIDE]
// (zeros past Tq and S), by the consumer warpgroup: each warp load reads one
// whole 128-byte row piece, a bf16 pair a lane (a 4-byte load where rel's
// base, rows and S keep pairs aligned).
__device__ __forceinline__ void stage_rel(__nv_bfloat16* buf, const __nv_bfloat16* relh,
                                          long long rel_rs, bool vec, int q0, int k0, int Tq,
                                          int S) {
  const int c = 2 * (threadIdx.x & 31), w = threadIdx.x >> 5, s = k0 + c;
  uint32_t v[BQ / 4];
#pragma unroll
  for (int i = 0; i < BQ / 4; ++i) {
    const int t = q0 + w + 4 * i;
    v[i] = 0;
    if (t < Tq && s < S) {
      const __nv_bfloat16* p = relh + (long long)t * rel_rs + s;
      if (vec)
        v[i] = __ldg(reinterpret_cast<const unsigned int*>(p));
      else
        v[i] = __bfloat16_as_ushort(p[0]) |
               (s + 1 < S ? static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16 : 0u);
    }
  }
#pragma unroll
  for (int i = 0; i < BQ / 4; ++i)
    *reinterpret_cast<uint32_t*>(buf + (w + 4 * i) * REL_STRIDE + c) = v[i];
}

// sc = [a|pos_a].[b|pos_b]^T and, with kDp, dp = c.d^T, with a, pos_a, c the
// resident tiles at sa and b, pos_b, d the stage at sb: 3 DP / 16 (2 DP / 16)
// wgmma k-steps into fp32 accumulators, issued and committed, not waited.
template <int DP, bool kDp = true>
__device__ __forceinline__ void issue_s_dp(float (&sc)[32], float (&dp)[32], uint32_t sa,
                                           uint32_t sb) {
  constexpr uint32_t TILE = Layout<DP>::TILE;
  issue_scores<DP>(sc, sa, sb);
  if constexpr (kDp) {
    wgmma_fence();
    issue_kmajor<DP>(dp, sa + 2 * TILE, sb + 2 * TILE, 0);
    wgmma_commit();
    fence_operand(dp);
  }
}

// The bf16 rounding of what the A fragments `hi` (x rounded to bf16 pairs,
// to_a_fragments) leave of x: x - hi is exact in fp32, so hi + lo holds x to
// about 16 bits.
__device__ __forceinline__ void to_a_residual(const float (&x)[32], const uint32_t (&hi)[16],
                                              uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    lo[i] = pack_bf16(x[2 * i] - __uint_as_float(hi[i] << 16),
                      x[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
}

// This thread's two rows (accumulator halves hh = 0, 1) of a 64 x DP fp32
// accumulator, its first D columns rounded to bf16, at out + off[hh] (rows
// with off < 0 skipped). A column half passes out + its first column and D
// less that column.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], __nv_bfloat16* out,
                                           const long long (&off)[2], int cq, int D) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (off[hh] < 0) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(out + off[hh] + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// The gradients of kOut's bits among dv, dk and dpos_k for one (b, h,
// 64-key tile, column half): block x is key tile x / NCH, half x % NCH.
// maps: q, pos_q, dO, k, pos_k, v.
template <int DP, int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_kv(
    const __grid_constant__ Maps<DP, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad,
    const float* __restrict__ lse, const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dpk, __nv_bfloat16* __restrict__ dv, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using Lay = BwdLayout<DP>;
  constexpr int STAGES = Lay::STAGES, VW = Lay::VW;
  constexpr uint32_t TILE = Lay::TILE;
  constexpr bool kDv = kOut & KV_DV, kDk = kOut & KV_DK, kDpk = kOut & KV_DPK;
  constexpr bool kW = kDk || kDpk;  // dW needed (else P alone, no dP product)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // k, pos_k, v
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  float* const rows_base = reinterpret_cast<float*>(smem + Lay::OFF_ROWS);
  __nv_bfloat16* const rel_base = reinterpret_cast<__nv_bfloat16*>(smem + Lay::OFF_REL);
  const uint32_t bars = base + Lay::OFF_BAR;
  const uint32_t res_full = bars + 16 * STAGES;
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + Lay::OFF_RING + Lay::STAGE * st; };  // q, pos_q, dO
  auto rows = [=](int st) { return rows_base + 2 * BQ * st; };  // lse[64], dsum[64]

  const int k0 = blockIdx.x / Lay::NCH * BK, h = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % Lay::NCH, c0 = VW * half;  // this CTA's gradient columns
  const uint32_t cols = DP <= 128 ? 0u : 2u * half * HeadTile<DP>::LO_BOX;  // their boxes
  const int nbox = Layout<DP>::vboxes(half);
  const int bh = b * H + h;
  const int n = (Tq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1 + 32);  // the copies' arrival, then one per producer lane
      mbar_init(empty(st), NC);
    }
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp: lane 0 issues the copies, all lanes the rows
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(res_full, 3 * TILE);
      load_tile(base, maps, 3, res_full, k0, bh);
      load_tile(base + TILE, maps, 4, res_full, k0, bh);
      load_tile(base + 2 * TILE, maps, 5, res_full, k0, bh);
    }
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, q0 = it * BQ;
      if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(st), 3 * TILE);
        load_tile(stage(st), maps, 0, full(st), q0, bh);
        load_tile(stage(st) + TILE, maps, 1, full(st), q0, bh);
        load_tile(stage(st) + 2 * TILE, maps, 2, full(st), q0, bh);
      }
      float* r = rows(st);
      for (int i = lane; i < BQ; i += 32) {
        const int t = q0 + i;
        r[i] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
        r[BQ + i] = t < Tq ? dsum[(long long)bh * Tq + t] : 0.f;
      }
      mbar_arrive(full(st));  // releases this lane's stores to the consumers
    }
    return;  // no block-wide barrier follows
  }

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // key rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                          // query columns 8 j + cq and + 1
  const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
  int s_of[2];
  bool key_ok[2], key_pad[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s_of[hh] = k0 + r0 + 8 * hh;
    key_ok[hh] = s_of[hh] < S;
    key_pad[hh] = key_ok[hh] && kpad[(long long)b * S + s_of[hh]];
  }

  float adv[kDv ? VW / 2 : 1], adk[kDk ? VW / 2 : 1], adpk[kDpk ? VW / 2 : 1], sc[32], dp[32];
  uint32_t pa[16], wa[16];
  if constexpr (kDv) zero(adv);
  if constexpr (kDk) zero(adk);
  if constexpr (kDpk) zero(adpk);
  mbar_wait(res_full, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, q0 = it * BQ;
    mbar_wait(full(st), (it / STAGES) & 1);
    issue_s_dp<DP, kW>(sc, dp, base, stage(st));
    // rel's tile while the products run, staged in its own layout and read
    // transposed below (each accumulator pair spans two query rows)
    __nv_bfloat16* rt = nullptr;
    if (relh) {
      rt = rel_base + (it & 1) * (BQ * REL_STRIDE);  // the other parity is still being read
      stage_rel(rt, relh, rel_rs, rel_vec != 0, q0, k0, Tq, S);
      consumer_sync();
    }
    wgmma_wait();
    fence_operand(sc);
    if constexpr (kW) fence_operand(dp);

    // P^T and dW^T in fp32, 0 past S and past Tq; each rounded once to bf16 below
    const float* r = rows(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(r + 8 * j + cq);
      const float2 ds = *reinterpret_cast<const float2*>(r + BQ + 8 * j + cq);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e, t = q0 + 8 * j + cq + e;
          float w = sc[i];
          if (rt) w += __bfloat162float(rt[(8 * j + cq + e) * REL_STRIDE + r0 + 8 * hh]);
          const bool neg = key_pad[hh] || (causal && s_of[hh] > t);
          w = neg ? NEG : w;
          const float p = key_ok[hh] && t < Tq ? fexp(w - (e ? ls.y : ls.x)) : 0.f;
          sc[i] = p;
          if constexpr (kW) dp[i] = p * (dp[i] - (e ? ds.y : ds.x));
        }
    }
    if constexpr (kDv) to_a_fragments(sc, pa);
    if constexpr (kW) to_a_fragments(dp, wa);
    if constexpr (kDv) issue_pv<DP>(adv, pa, stage(st) + 2 * TILE + cols, nbox);  // dv += P^T.dO
    if constexpr (kDk) issue_pv<DP>(adk, wa, stage(st) + cols, nbox);            // dk += dW^T.q
    if constexpr (kDpk)  // dpos_k += dW^T . pos_q
      issue_pv<DP>(adpk, wa, stage(st) + TILE + cols, nbox);
    wgmma_wait();
    if constexpr (kDv) fence_regs(adv);
    if constexpr (kDk) fence_regs(adk);
    if constexpr (kDpk) fence_regs(adpk);
    mbar_arrive(empty(st));  // the products have read the stage
  }

  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) off[hh] = key_ok[hh] ? ((long long)bh * S + s_of[hh]) * D : -1;
  if constexpr (kDk) store_rows<VW>(adk, dk + c0, off, cq, D - c0);
  if constexpr (kDpk) store_rows<VW>(adpk, dpk + c0, off, cq, D - c0);
  if constexpr (kDv) store_rows<VW>(adv, dv + c0, off, cq, D - c0);
}

// The gradients of kOut's bits among dq and dpos_q, and this batch row's dW
// (drel's partial, where drel_part is not null: the first half's CTAs), for
// one (b, h, 64-row q tile, column half): block x is q tile x / NCH, half
// x % NCH. maps: q, pos_q, dO, k, pos_k, v.
template <int DP, int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_q(
    const __grid_constant__ Maps<DP, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad,
    const float* __restrict__ lse, const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dpq, float* __restrict__ drel_part, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using Lay = BwdLayout<DP>;
  constexpr int STAGES = Lay::STAGES, VW = Lay::VW;
  constexpr bool kDq = kOut & Q_DQ, kDpq = kOut & Q_DPQ;
  constexpr uint32_t TILE = Lay::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // q, pos_q, dO
  const uint32_t bars = base + Lay::OFF_BAR;
  const uint32_t res_full = bars + 16 * STAGES;
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + Lay::OFF_RING + Lay::STAGE * st; };  // k, pos_k, v

  const int q0 = blockIdx.x / Lay::NCH * BQ, h = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % Lay::NCH, c0 = VW * half;  // this CTA's gradient columns
  const uint32_t cols = DP <= 128 ? 0u : 2u * half * HeadTile<DP>::LO_BOX;  // their boxes
  const int nbox = Layout<DP>::vboxes(half);
  const int bh = b * H + h;
  const int n = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NC);
    }
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      mbar_expect_tx(res_full, 3 * TILE);
      load_tile(base, maps, 0, res_full, q0, bh);
      load_tile(base + TILE, maps, 1, res_full, q0, bh);
      load_tile(base + 2 * TILE, maps, 2, res_full, q0, bh);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
        mbar_expect_tx(full(st), 3 * TILE);
        load_tile(stage(st), maps, 3, full(st), it * BK, bh);
        load_tile(stage(st) + TILE, maps, 4, full(st), it * BK, bh);
        load_tile(stage(st) + 2 * TILE, maps, 5, full(st), it * BK, bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // query rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                          // key columns 8 j + cq and + 1
  const int t0 = q0 + r0;
  const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
  const uint8_t* kp = kpad + (long long)b * S;
  // this row's dW partial of drel: [H, Tq, S] fp32 of batch row b
  float* const part = drel_part && half == 0 ? drel_part + (long long)b * H * Tq * S : nullptr;
  const bool part_vec = S % 2 == 0;  // then a column pair is one aligned float2
  float ls[2], ds[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    ls[hh] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    ds[hh] = t < Tq ? dsum[(long long)bh * Tq + t] : 0.f;
  }

  float adq[kDq ? VW / 2 : 1], adpq[kDpq ? VW / 2 : 1], sc[32], dp[32];
  uint32_t wa[16], wl[16];
  TileBias<__nv_bfloat16> bias;
  if constexpr (kDq) zero(adq);
  if constexpr (kDpq) zero(adpq);
  mbar_wait(res_full, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, k0 = it * BK, lim = S - k0;
    mbar_wait(full(st), (it / STAGES) & 1);
    issue_s_dp<DP>(sc, dp, base, stage(st));
    load_bias(bias, relh, rel_rs, rel_vec != 0, kp, k0, S, t0, Tq, lane, cq);  // while they run
    wgmma_wait();
    fence_operand(sc);
    fence_operand(dp);
    mask_scores(sc, bias, relh != nullptr, k0, S, t0, Tq, causal, lane);
    // dW in fp32 (P = 0 past S, where the scores are -inf, and past Tq)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const float p = t0 + 8 * hh < Tq ? fexp(sc[i] - ls[hh]) : 0.f;
      dp[i] = p * (dp[i] - ds[hh]);
    }
    if (part) {  // the unrounded dW; this CTA alone writes these elements
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 8 * hh;
        if (t >= Tq) continue;
        float* d = part + ((long long)h * Tq + t) * S + k0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + cq;
          const float2 x = make_float2(dp[4 * j + 2 * hh], dp[4 * j + 2 * hh + 1]);
          if (c >= lim) continue;
          if (part_vec) {
            *reinterpret_cast<float2*>(d + 8 * j) = x;
          } else {
            d[8 * j] = x.x;
            if (c + 1 < lim) d[8 * j + 1] = x.y;
          }
        }
      }
    }
    to_a_fragments(dp, wa);     // dW's high part,
    to_a_residual(dp, wa, wl);  // then its low part
    wgmma_fence();
    if constexpr (kDq) {  // dq += dW . k
      issue_pv_cols<DP>(adq, wa, stage(st) + cols, nbox);
      issue_pv_cols<DP>(adq, wl, stage(st) + cols, nbox);
    }
    if constexpr (kDpq) {  // dpos_q += dW . pos_k
      issue_pv_cols<DP>(adpq, wa, stage(st) + TILE + cols, nbox);
      issue_pv_cols<DP>(adpq, wl, stage(st) + TILE + cols, nbox);
    }
    wgmma_commit();
    wgmma_wait();
    if constexpr (kDq) fence_regs(adq);
    if constexpr (kDpq) fence_regs(adpq);
    mbar_arrive(empty(st));  // the products have read the stage
  }

  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    off[hh] = t < Tq ? ((long long)bh * Tq + t) * D : -1;
  }
  if constexpr (kDq) store_rows<VW>(adq, dq + c0, off, cq, D - c0);
  if constexpr (kDpq) store_rows<VW>(adpq, dpq + c0, off, cq, D - c0);
}

// ---- the deep route (head dims past 256, common.cuh::DEEP) ----------------
//
// Nothing is resident. Each CTA owns one 128-column block of one gradient
// (block x = tile x nch + block), as past DP 128, and per tile of its walk
// takes from the ring of Layout<DEEP> (flash_fwd_sm90.cuh::DeepRing) the
// chunk pairs of the scores ((k, q) chunk by chunk, then (pos_k, pos_q);
// query-major (q, k), (pos_q, pos_k)), those of dP ((v, dO); query-major
// (dO, v)), then the block of its gradient's operand (dO, q or pos_q;
// query-major k or pos_k). The scores and dP sum the chunks' products in
// that order, each chunk's in a fresh accumulator (deep_products). lse and dsum come
// from device memory. drel's partial is written by block 0 of the dq launch.
// Shared memory 216,160 bytes (the ring, two rel tiles), whatever D; ptxas
// (CUDA 12.8): key-major dv 152, dk and dpos_k 180, query-major 224
// registers, no spills. Each of the five launches rebuilds the scores in
// every block and four of them dP: ~(28 nch + 12) T S D operations against
// the function's 16 (8 products of [T, S] x D), 11x at D 768.
struct BwdDeep {
  static constexpr uint32_t OFF_REL = Layout<DEEP>::OFF_BAR;  // after the ring
  static constexpr uint32_t OFF_BAR = OFF_REL + 2 * REL_TILE;
  static constexpr size_t SMEM = OFF_BAR + 8 * 2 * Layout<DEEP>::STAGES + 1024;
};

// The block of one of dv, dk, dpos_k (kOut, a single bit) for one (b, h,
// 64-key tile, column block). maps: q, pos_q, dO, k, pos_k, v.
template <int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_kv_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dpk, __nv_bfloat16* __restrict__ dv, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  constexpr uint32_t TILE = Layout<DEEP>::TILE;
  constexpr bool kDv = kOut == KV_DV, kW = !kDv;  // dW needed (else P alone, no dP product)
  constexpr int kOperand = kDv ? 2 : (kOut == KV_DK ? 0 : 1);  // dO, q or pos_q
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  __nv_bfloat16* const rel_base = reinterpret_cast<__nv_bfloat16*>(smem + BwdDeep::OFF_REL);
  const uint32_t bars = base + BwdDeep::OFF_BAR;
  const int nch = deep_chunks(D), nk = nch;
  const int k0 = blockIdx.x / nch * BK, h = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % nch, c0 = DEEP_CHUNK * half;  // this CTA's gradient columns
  const int bh = b * H + h;
  const int n = (Tq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DeepRing::STAGES; ++st) {
      mbar_init(bars + 8u * st, 1);
      mbar_init(bars + 8u * (DeepRing::STAGES + st), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  DeepRing ring{base, bars};

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      for (int it = 0; it < n; ++it) {
        const int q0 = it * BQ;
        for (int c = 0; c < 2 * nk; ++c) {  // k . q chunk by chunk, then pos_k . pos_q
          const int st = ring.put(2 * TILE), i = c < nk ? 0 : 1;
          load_chunk(ring.slot(st), maps, 3 + i, ring.full(st), c % nk, k0, bh);
          load_chunk(ring.slot(st) + TILE, maps, i, ring.full(st), c % nk, q0, bh);
        }
        for (int c = 0; kW && c < nk; ++c) {  // v . dO
          const int st = ring.put(2 * TILE);
          load_chunk(ring.slot(st), maps, 5, ring.full(st), c, k0, bh);
          load_chunk(ring.slot(st) + TILE, maps, 2, ring.full(st), c, q0, bh);
        }
        const int st = ring.put(TILE);  // the operand's block
        load_chunk(ring.slot(st), maps, kOperand, ring.full(st), half, q0, bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // key rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                          // query columns 8 j + cq and + 1
  const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
  int s_of[2];
  bool key_ok[2], key_pad[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s_of[hh] = k0 + r0 + 8 * hh;
    key_ok[hh] = s_of[hh] < S;
    key_pad[hh] = key_ok[hh] && kpad[(long long)b * S + s_of[hh]];
  }

  float acc[DEEP_CHUNK / 2], sc[32], dp[32];
  uint32_t pa[16];
  zero(acc);
  for (int it = 0; it < n; ++it) {
    const int q0 = it * BQ;
    // rel's tile, staged in its own layout and read transposed below
    __nv_bfloat16* rt = nullptr;
    if (relh) {
      rt = rel_base + (it & 1) * (BQ * REL_STRIDE);  // the other parity is still being read
      stage_rel(rt, relh, rel_rs, rel_vec != 0, q0, k0, Tq, S);
      consumer_sync();
    }
    deep_products(sc, ring, 2 * nk, false);
    if constexpr (kW) deep_products(dp, ring, nk, false);

    // P^T (or dW^T) in fp32, 0 past S and past Tq; rounded once to bf16 below
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = q0 + 8 * j + cq + e;
        const float ls = t < Tq ? __ldg(lse + (long long)bh * Tq + t) : 0.f;
        const float ds = kW && t < Tq ? __ldg(dsum + (long long)bh * Tq + t) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          float w = sc[i];
          if (rt) w += __bfloat162float(rt[(8 * j + cq + e) * REL_STRIDE + r0 + 8 * hh]);
          const bool neg = key_pad[hh] || (causal && s_of[hh] > t);
          w = neg ? NEG : w;
          const float p = key_ok[hh] && t < Tq ? fexp(w - ls) : 0.f;
          sc[i] = kW ? p * (dp[i] - ds) : p;
        }
      }
    }
    to_a_fragments(sc, pa);
    const int gs = ring.take();  // dv += P^T.dO, dk += dW^T.q, dpos_k += dW^T.pos_q
    issue_pv<DEEP_CHUNK>(acc, pa, ring.slot(gs));
    wgmma_wait();
    fence_regs(acc);
    ring.release(gs);
  }

  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) off[hh] = key_ok[hh] ? ((long long)bh * S + s_of[hh]) * D : -1;
  __nv_bfloat16* out = kOut == KV_DV ? dv : (kOut == KV_DK ? dk : dpk);
  store_rows<DEEP_CHUNK>(acc, out + c0, off, cq, D - c0);
}

// The block of dq or dpos_q (kOut, a single bit) for one (b, h, 64-row q
// tile, column block), and with drel_part this batch row's dW (drel's
// partial; block 0 writes it). maps: q, pos_q, dO, k, pos_k, v.
template <int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_q_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dpq, float* __restrict__ drel_part, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  constexpr uint32_t TILE = Layout<DEEP>::TILE;
  constexpr int kOperand = kOut == Q_DQ ? 3 : 4;  // k or pos_k
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + BwdDeep::OFF_BAR;
  const int nch = deep_chunks(D), nk = nch;
  const int q0 = blockIdx.x / nch * BQ, h = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % nch, c0 = DEEP_CHUNK * half;  // this CTA's gradient columns
  const int bh = b * H + h;
  const int n = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < DeepRing::STAGES; ++st) {
      mbar_init(bars + 8u * st, 1);
      mbar_init(bars + 8u * (DeepRing::STAGES + st), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  DeepRing ring{base, bars};

  if (threadIdx.x >= NC) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == NC) {
      for (int it = 0; it < n; ++it) {
        const int k0 = it * BK;
        for (int c = 0; c < 2 * nk; ++c) {  // q . k chunk by chunk, then pos_q . pos_k
          const int st = ring.put(2 * TILE), i = c < nk ? 0 : 1;
          load_chunk(ring.slot(st), maps, i, ring.full(st), c % nk, q0, bh);
          load_chunk(ring.slot(st) + TILE, maps, 3 + i, ring.full(st), c % nk, k0, bh);
        }
        for (int c = 0; c < nk; ++c) {  // dO . v
          const int st = ring.put(2 * TILE);
          load_chunk(ring.slot(st), maps, 2, ring.full(st), c, q0, bh);
          load_chunk(ring.slot(st) + TILE, maps, 5, ring.full(st), c, k0, bh);
        }
        const int st = ring.put(TILE);  // the operand's block
        load_chunk(ring.slot(st), maps, kOperand, ring.full(st), half, k0, bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);  // query rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                          // key columns 8 j + cq and + 1
  const int t0 = q0 + r0;
  const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
  const uint8_t* kp = kpad + (long long)b * S;
  float* const part = drel_part && half == 0 ? drel_part + (long long)b * H * Tq * S : nullptr;
  const bool part_vec = S % 2 == 0;  // then a column pair is one aligned float2
  float ls[2], ds[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    ls[hh] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    ds[hh] = t < Tq ? dsum[(long long)bh * Tq + t] : 0.f;
  }

  float acc[DEEP_CHUNK / 2], sc[32], dp[32];
  uint32_t wa[16], wl[16];
  TileBias<__nv_bfloat16> bias;
  zero(acc);
  for (int it = 0; it < n; ++it) {
    const int k0 = it * BK, lim = S - k0;
    load_bias(bias, relh, rel_rs, rel_vec != 0, kp, k0, S, t0, Tq, lane, cq);  // while they run
    deep_products(sc, ring, 2 * nk, false);
    deep_products(dp, ring, nk, false);
    mask_scores(sc, bias, relh != nullptr, k0, S, t0, Tq, causal, lane);
    // dW in fp32 (P = 0 past S, where the scores are -inf, and past Tq)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const float p = t0 + 8 * hh < Tq ? fexp(sc[i] - ls[hh]) : 0.f;
      dp[i] = p * (dp[i] - ds[hh]);
    }
    if (part) {  // the unrounded dW; this CTA alone writes these elements
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 8 * hh;
        if (t >= Tq) continue;
        float* d = part + ((long long)h * Tq + t) * S + k0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + cq;
          const float2 x = make_float2(dp[4 * j + 2 * hh], dp[4 * j + 2 * hh + 1]);
          if (c >= lim) continue;
          if (part_vec) {
            *reinterpret_cast<float2*>(d + 8 * j) = x;
          } else {
            d[8 * j] = x.x;
            if (c + 1 < lim) d[8 * j + 1] = x.y;
          }
        }
      }
    }
    to_a_fragments(dp, wa);     // dW's high part,
    to_a_residual(dp, wa, wl);  // then its low part
    const int gs = ring.take();  // dq += dW . k, dpos_q += dW . pos_k
    wgmma_fence();
    issue_pv_cols<DEEP_CHUNK>(acc, wa, ring.slot(gs), 2);
    issue_pv_cols<DEEP_CHUNK>(acc, wl, ring.slot(gs), 2);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    ring.release(gs);
  }

  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    off[hh] = t < Tq ? ((long long)bh * Tq + t) * D : -1;
  }
  store_rows<DEEP_CHUNK>(acc, (kOut == Q_DQ ? dq : dpq) + c0, off, cq, D - c0);
}

// drel = the sum over the batch, in order, of the B partials [B, n], into
// partial 0; four elements a thread where n keeps float4s aligned. Static:
// each source that includes this header has its own (one launches it).
static __global__ void __launch_bounds__(256) drel_sum(float* __restrict__ part, long long n, int B) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    float4* p = reinterpret_cast<float4*>(part);
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      float4 a = p[i];
      for (int b = 1; b < B; ++b) {
        const float4 x = p[b * n4 + i];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      p[i] = a;
    }
    return;
  }
  for (long long i = i0; i < n; i += stride) {
    float a = part[i];
    for (int b = 1; b < B; ++b) a += part[b * n + i];
    part[i] = a;
  }
}

// Launches the key-major launches (one at DP 32 and 64, two at 80, three at
// 128 and past it), the query-major ones (one, two from 128; past 128 each
// over two column halves) and drel's sum on `stream`
// for bf16 streams [B, H, Tq or S, D] (16-byte aligned, D <= DP a multiple
// of 8), bf16 rel (or null), K3's lse and the pre-pass's dsum (fp32
// [B, H, Tq]); drel_part is fp32 [B, H, Tq, S] scratch whose first
// [H, Tq, S] receives drel, or null. Returns a cudaError_t code.
template <int DP>
int launch_bwd(const void* q, const void* pq, const void* k, const void* pk, const void* v,
               const void* rel, const void* kpad, const void* dout, const float* lse,
               const float* dsum, void* dq, void* dpq, void* dk, void* dpk, void* dv,
               float* drel_part, int B, int H, int Tq, int S, long long rel_hs, long long rel_rs,
               int causal, int D, cudaStream_t stream) {
  Maps<DP, 6> maps;
  if (const int err = stream_maps<DP, 6>(maps, {q, pq, dout, k, pk, v}, {Tq, Tq, Tq, S, S, S},
                                         (long long)B * H, D))
    return err;
  const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % 4 == 0 && rel_rs % 2 == 0 &&
                      rel_hs % 2 == 0 && S % 2 == 0;
  constexpr size_t smem = BwdLayout<DP>::SMEM;
  const auto* relt = static_cast<const __nv_bfloat16*>(rel);
  const auto* kp = static_cast<const uint8_t*>(kpad);
  auto kv = [&](auto out) -> cudaError_t {  // one key-major launch writing `out`
    constexpr int kOut = decltype(out)::value;
    static SmemOptIn opt_in;
    if (const int e = opt_in.ensure((const void*)bwd_kv<DP, kOut>, smem)) return (cudaError_t)e;
    bwd_kv<DP, kOut><<<dim3((S + BK - 1) / BK * Layout<DP>::NCH, H, B), NT, smem, stream>>>(
        maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dpk), static_cast<__nv_bfloat16*>(dv), H, Tq, S, rel_hs,
        rel_rs, rel_vec, causal, D);
    return cudaGetLastError();
  };
  auto qm = [&](auto out, float* part) -> cudaError_t {  // one query-major launch
    constexpr int kOut = decltype(out)::value;
    static SmemOptIn opt_in;
    if (const int e = opt_in.ensure((const void*)bwd_q<DP, kOut>, smem)) return (cudaError_t)e;
    bwd_q<DP, kOut><<<dim3((Tq + BQ - 1) / BQ * Layout<DP>::NCH, H, B), NT, smem, stream>>>(
        maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dpq), part, H, Tq, S, rel_hs, rel_rs, rel_vec, causal, D);
    return cudaGetLastError();
  };
  using Kv = std::integral_constant<int, KV_ALL>;
  cudaError_t err;
  if constexpr (DP <= 64) {
    err = kv(Kv{});
  } else if constexpr (DP <= 80) {
    err = kv(std::integral_constant<int, KV_DV | KV_DK>{});
    if (err == cudaSuccess) err = kv(std::integral_constant<int, KV_DPK>{});
  } else {
    err = kv(std::integral_constant<int, KV_DV>{});
    if (err == cudaSuccess) err = kv(std::integral_constant<int, KV_DK>{});
    if (err == cudaSuccess) err = kv(std::integral_constant<int, KV_DPK>{});
  }
  if (err != cudaSuccess) return (int)err;
  if constexpr (DP <= 80) {
    err = qm(std::integral_constant<int, Q_ALL>{}, drel_part);
  } else {
    err = qm(std::integral_constant<int, Q_DQ>{}, drel_part);
    if (err == cudaSuccess) err = qm(std::integral_constant<int, Q_DPQ>{}, nullptr);
  }
  if (err != cudaSuccess || !drel_part || B == 1) return (int)err;
  const long long n = (long long)H * Tq * S, threads = n % 4 == 0 ? n / 4 : n;
  drel_sum<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(drel_part, n, B);
  return (int)cudaGetLastError();
}

// The deep route's launches on `stream`, the arguments as launch_bwd's (D
// past 256, a multiple of 8): dv, dk and dpos_k key-major, dq (with drel's
// partials) and dpos_q query-major, each over nch(D) column blocks, then
// drel's sum. Returns a cudaError_t code.
inline int launch_bwd_deep(const void* q, const void* pq, const void* k, const void* pk,
                           const void* v, const void* rel, const void* kpad, const void* dout,
                           const float* lse, const float* dsum, void* dq, void* dpq, void* dk,
                           void* dpk, void* dv, float* drel_part, int B, int H, int Tq, int S,
                           long long rel_hs, long long rel_rs, int causal, int D,
                           cudaStream_t stream) {
  Maps<DEEP_CHUNK, 6> maps;
  if (const int err = stream_maps<DEEP_CHUNK, 6>(maps, {q, pq, dout, k, pk, v},
                                                 {Tq, Tq, Tq, S, S, S}, (long long)B * H, D))
    return err;
  const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % 4 == 0 && rel_rs % 2 == 0 &&
                      rel_hs % 2 == 0 && S % 2 == 0;
  constexpr size_t smem = BwdDeep::SMEM;
  const int nch = deep_chunks(D);
  const auto* relt = static_cast<const __nv_bfloat16*>(rel);
  const auto* kp = static_cast<const uint8_t*>(kpad);
  auto kv = [&](auto out) -> cudaError_t {  // one key-major launch writing `out`
    constexpr int kOut = decltype(out)::value;
    static SmemOptIn opt_in;
    if (const int e = opt_in.ensure((const void*)bwd_kv_deep<kOut>, smem)) return (cudaError_t)e;
    bwd_kv_deep<kOut><<<dim3((S + BK - 1) / BK * nch, H, B), NT, smem, stream>>>(
        maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dpk), static_cast<__nv_bfloat16*>(dv), H, Tq, S, rel_hs,
        rel_rs, rel_vec, causal, D);
    return cudaGetLastError();
  };
  auto qm = [&](auto out, float* part) -> cudaError_t {  // one query-major launch
    constexpr int kOut = decltype(out)::value;
    static SmemOptIn opt_in;
    if (const int e = opt_in.ensure((const void*)bwd_q_deep<kOut>, smem)) return (cudaError_t)e;
    bwd_q_deep<kOut><<<dim3((Tq + BQ - 1) / BQ * nch, H, B), NT, smem, stream>>>(
        maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dpq), part, H, Tq, S, rel_hs, rel_rs, rel_vec, causal, D);
    return cudaGetLastError();
  };
  cudaError_t err = kv(std::integral_constant<int, KV_DV>{});
  if (err == cudaSuccess) err = kv(std::integral_constant<int, KV_DK>{});
  if (err == cudaSuccess) err = kv(std::integral_constant<int, KV_DPK>{});
  if (err == cudaSuccess) err = qm(std::integral_constant<int, Q_DQ>{}, drel_part);
  if (err == cudaSuccess) err = qm(std::integral_constant<int, Q_DPQ>{}, nullptr);
  if (err != cudaSuccess || !drel_part || B == 1) return (int)err;
  const long long n = (long long)H * Tq * S, threads = n % 4 == 0 ? n / 4 : n;
  drel_sum<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(drel_part, n, B);
  return (int)cudaGetLastError();
}

// launch_bwd<dp>, for an instance dp of common.cuh::with_head_dim (DEEP:
// launch_bwd_deep): defined in
// flash_attention_bwd_sm90.cu, the one source that compiles these kernels
// (flash_attention_bwd.cu's K4 entry calls it), so that the tensor-core and
// the FMA kernels of K4 build in parallel.
int launch_bwd_instance(int dp, const void* q, const void* pq, const void* k, const void* pk,
                        const void* v, const void* rel, const void* kpad, const void* dout,
                        const float* lse, const float* dsum, void* dq, void* dpq, void* dk,
                        void* dpk, void* dv, float* drel_part, int B, int H, int Tq, int S,
                        long long rel_hs, long long rel_rs, int causal, int D,
                        cudaStream_t stream);

}  // namespace sm90
}  // namespace mk
