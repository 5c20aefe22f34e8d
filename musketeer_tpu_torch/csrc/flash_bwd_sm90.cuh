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
// The tile width DP is a template parameter, compiled at 32, 64, 80 and 128
// (its tiles as flash_fwd_sm90.cuh lays them out,
// sm90.cuh::HeadTile); the head dim D <= DP is an argument: the tiles'
// columns past D are zeros, which change no product, and no gradient column
// past D is stored.
//
// Past DP 128 a whole-width gradient would be DP / 2 fp32 registers a thread,
// and the resident and streamed tiles at 3 stages would not fit (316 KB at
// 192, 414 KB at 256). So past 128 K4 runs on the CTAs of the deep section
// below: the head dim streams through the S and dP products in chunks of
// 128, and each gradient's columns split into blocks of 128, each owned by a
// block warpgroup, while a builder warpgroup builds S and dP once for the
// CTA's blocks. At head dims 129 to 256 (the pair route, the instances 192
// and 256) a CTA owns both blocks of its gradient (PW), so S and dP are built
// once per gradient: S 5 times and dP 4 times per (key tile, q tile), two
// launches and drel's sum; where the last chunk holds at most 64 columns (D
// <= 192) it is one 64-column box. There the key-major builder loads its
// tile's lse, dsum and rel into registers before the products and stages rel
// after them, and the query-major one loads rel and the pads as the pair
// route's forward does (TileBias<TR, true>), so that no load's latency stands
// between the products and P (clock64 counters in a copy of the builders,
// H100: forming P^T takes ~4,800 cycles a tile on the pair route, against
// ~8,300 in the deep route's builder, which loads lse and dsum where it uses
// them; the products take ~4,100 and ~3,100).
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
// (dv), 178 (dk), 178 (dpos_k) / 219, 219 at 128; no spills, so one CTA of 160
// threads per SM; chip_smoke.py's build phase prints the report of each build.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace mk {
namespace sm90 {

constexpr uint32_t ROWS = 2 * BQ * sizeof(float);    // a stage's lse and dsum (key-major)
constexpr int REL_STRIDE = BK + 8;                   // bf16 row stride of a staged rel tile
constexpr uint32_t REL_TILE = BQ * REL_STRIDE * 2;   // bytes; two, one per tile parity

template <int DP>
struct BwdLayout {
  static constexpr int STAGES = 3;  // ring depth
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

// rel[h] rows q0 .. q0 + 63, columns k0 .. k0 + 63 of this thread (tid its
// index in a warpgroup): each warp load reads one whole 128-byte row piece, a
// bf16 pair a lane (a 4-byte load where rel's base, rows and S keep pairs
// aligned), zeros past Tq and S; stage_rel stores them into buf.
__device__ __forceinline__ void load_rel(uint32_t (&v)[BQ / 4], const __nv_bfloat16* relh,
                                         long long rel_rs, bool vec, int q0, int k0, int Tq, int S,
                                         int tid) {
  const int c = 2 * (tid & 31), w = tid >> 5, s = k0 + c;
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
}

// load_rel's values into buf [64][REL_STRIDE]
__device__ __forceinline__ void store_rel(__nv_bfloat16* buf, const uint32_t (&v)[BQ / 4],
                                          int tid) {
  const int c = 2 * (tid & 31), w = tid >> 5;
#pragma unroll
  for (int i = 0; i < BQ / 4; ++i)
    *reinterpret_cast<uint32_t*>(buf + (w + 4 * i) * REL_STRIDE + c) = v[i];
}

// rel[h] rows q0 .. q0 + 63, columns k0 .. k0 + 63 into buf [64][REL_STRIDE]
// (zeros past Tq and S), by a warpgroup
__device__ __forceinline__ void stage_rel(__nv_bfloat16* buf, const __nv_bfloat16* relh,
                                          long long rel_rs, bool vec, int q0, int k0, int Tq,
                                          int S, int tid) {
  uint32_t v[BQ / 4];
  load_rel(v, relh, rel_rs, vec, q0, k0, Tq, S, tid);
  store_rel(buf, v, tid);
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
// with off < 0 skipped). A column block passes out + its first column and D
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
// 64-key tile): block x is the key tile. maps: q, pos_q, dO, k, pos_k, v.
template <int DP, int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_kv(
    const __grid_constant__ Maps<DP, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad,
    const float* __restrict__ lse, const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dpk, __nv_bfloat16* __restrict__ dv, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using Lay = BwdLayout<DP>;
  constexpr int STAGES = Lay::STAGES;
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

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
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

  float adv[kDv ? DP / 2 : 1], adk[kDk ? DP / 2 : 1], adpk[kDpk ? DP / 2 : 1], sc[32], dp[32];
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
      stage_rel(rt, relh, rel_rs, rel_vec != 0, q0, k0, Tq, S, threadIdx.x);
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
    if constexpr (kDv) issue_pv<DP>(adv, pa, stage(st) + 2 * TILE);  // dv += P^T.dO
    if constexpr (kDk) issue_pv<DP>(adk, wa, stage(st));             // dk += dW^T.q
    if constexpr (kDpk) issue_pv<DP>(adpk, wa, stage(st) + TILE);    // dpos_k += dW^T . pos_q
    wgmma_wait();
    if constexpr (kDv) fence_regs(adv);
    if constexpr (kDk) fence_regs(adk);
    if constexpr (kDpk) fence_regs(adpk);
    mbar_arrive(empty(st));  // the products have read the stage
  }

  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) off[hh] = key_ok[hh] ? ((long long)bh * S + s_of[hh]) * D : -1;
  if constexpr (kDk) store_rows<DP>(adk, dk, off, cq, D);
  if constexpr (kDpk) store_rows<DP>(adpk, dpk, off, cq, D);
  if constexpr (kDv) store_rows<DP>(adv, dv, off, cq, D);
}

// The gradients of kOut's bits among dq and dpos_q, and this batch row's dW
// (drel's partial, where drel_part is not null), for one (b, h, 64-row q
// tile): block x is the q tile. maps: q, pos_q, dO, k, pos_k, v.
template <int DP, int kOut>
__global__ void __launch_bounds__(NT, 1) bwd_q(
    const __grid_constant__ Maps<DP, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad,
    const float* __restrict__ lse, const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dpq, float* __restrict__ drel_part, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using Lay = BwdLayout<DP>;
  constexpr int STAGES = Lay::STAGES;
  constexpr bool kDq = kOut & Q_DQ, kDpq = kOut & Q_DPQ;
  constexpr uint32_t TILE = Lay::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // q, pos_q, dO
  const uint32_t bars = base + Lay::OFF_BAR;
  const uint32_t res_full = bars + 16 * STAGES;
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return base + Lay::OFF_RING + Lay::STAGE * st; };  // k, pos_k, v

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
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
  float* const part = drel_part ? drel_part + (long long)b * H * Tq * S : nullptr;
  const bool part_vec = S % 2 == 0;  // then a column pair is one aligned float2
  float ls[2], ds[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    ls[hh] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    ds[hh] = t < Tq ? dsum[(long long)bh * Tq + t] : 0.f;
  }

  float adq[kDq ? DP / 2 : 1], adpq[kDpq ? DP / 2 : 1], sc[32], dp[32];
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
      issue_pv_products<DP>(adq, wa, stage(st));
      issue_pv_products<DP>(adq, wl, stage(st));
    }
    if constexpr (kDpq) {  // dpos_q += dW . pos_k
      issue_pv_products<DP>(adpq, wa, stage(st) + TILE);
      issue_pv_products<DP>(adpq, wl, stage(st) + TILE);
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
  if constexpr (kDq) store_rows<DP>(adq, dq, off, cq, D);
  if constexpr (kDpq) store_rows<DP>(adpq, dpq, off, cq, D);
}

// ---- past head dim 128: the pair route (129 to 256) and the deep route ----
//
// Nothing is resident. Two launches, each of fwd_deep's shape (a producer
// warpgroup, the builder warpgroup, W block warpgroups: DW on the deep route,
// PW on the pair route; flash_fwd_sm90.cuh):
//   - key-major (bwd_kv_deep): a CTA per (b, h, 64-key tile, gradient g of
//     dv, dk, dpos_k, group of up to W column blocks of 128); block x =
//     (key tile x 3 + g) x groups + group. For each q tile the builder builds
//     S^T from the chunk pairs (k, q) chunk by chunk, then (pos_k, pos_q),
//     and, for dk and dpos_k, dP^T from (v, dO), each pair's products in a
//     fresh accumulator (deep_products), stages rel's tile in shared memory
//     as bwd_kv does, and writes P^T (dv) or dW^T, rounded to bf16, into one
//     of two A buffers; block warpgroup w accumulates its block of the
//     gradient from the buffer times its block of dO, q or pos_q.
//   - query-major (bwd_q_deep): a CTA per (b, h, 64-row q tile, gradient of
//     dq, dpos_q, group); block x = (q tile x 2 + g) x groups + group. The
//     builder builds S from (q, k), then (pos_q, pos_k), and dP from (dO, v),
//     writes dW's high and low bf16 parts into the buffer (two tiles), and
//     drel's partial where g = dq and group = 0; the block warpgroups
//     accumulate dq or dpos_q from both parts times their blocks of k or
//     pos_k, the high part first.
// S and dP are built ceil(nch / W) times per (key tile, q tile) for each
// gradient: S for five gradients, dP for four (dv needs none), against nch
// times each on one block a CTA. lse and dsum come from device memory. Where
// the pair route's last chunk is one 64-column box (D <= 192), its copies,
// products and blocks are that box alone.
// Shared memory (DeepBwd): the score ring, the block ring, the two A buffers
// (one tile each key-major, two query-major), key-major one rel tile: the
// deep route 223,344 and 230,512 bytes, the pair route (a score ring of 4
// slots, a block ring of 2 slots of two chunks) 223,360 and 230,528. ptxas
// (CUDA 12.8): the deep route 96 registers at launch (the builder up to
// 160), the pair route 128 (the builder up to 224), no spills.
template <int W, bool kQ>
struct DeepBwd {
  using SRing = typename Cta<W>::SRing;
  using BRing = typename Cta<W>::BRing;
  static constexpr uint32_t OFF_S = 0;
  static constexpr uint32_t OFF_O = OFF_S + SRing::BYTES;
  static constexpr uint32_t OFF_P = OFF_O + BRing::BYTES;
  static constexpr uint32_t PBUF = (kQ ? 2 : 1) * PTILE;     // an A buffer
  static constexpr uint32_t OFF_REL = OFF_P + 2 * PBUF;
  static constexpr uint32_t OFF_BAR = OFF_REL + (kQ ? 0 : REL_TILE);  // one rel tile
  static constexpr int NBARS = 2 * SRing::DEPTH + 2 * BRing::DEPTH + 4;
  static constexpr size_t SMEM = OFF_BAR + 8 * NBARS + 1024;
};

// What both backward kernels of a CTA of W blocks share: the barriers' setup,
// the rings, the A buffers' mbarriers (full[2], then empty[2]).
template <int W>
struct DeepBwdCta {
  using SRing = typename Cta<W>::SRing;
  using BRing = typename Cta<W>::BRing;
  uint32_t base, pbars;
  SRing sring;
  BRing oring;
  __device__ __forceinline__ DeepBwdCta(uint32_t base_, uint32_t bars)
      : base(base_), pbars(bars + 16 * SRing::DEPTH + 16 * BRing::DEPTH), sring{base_, bars},
        oring{base_ + SRing::BYTES, bars + 16 * SRing::DEPTH} {}
  __device__ __forceinline__ uint32_t pfull(int i) const { return pbars + 8u * i; }
  __device__ __forceinline__ uint32_t pempty(int i) const { return pbars + 8u * (2 + i); }
  __device__ __forceinline__ void init() const {
    sring.init(NC);
    oring.init(W * NC);
    for (int i = 0; i < 2; ++i) {
      mbar_init(pfull(i), NC);
      mbar_init(pempty(i), W * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the builder: A buffer i of its np-th tile, once the block warpgroups have
  // released its use two tiles before
  __device__ __forceinline__ void wait_empty(int np) const {
    if (np >= 2) mbar_wait(pempty(np & 1), ((np >> 1) - 1) & 1);
  }
  // the builder: buffer np & 1 written (generic stores, then wgmma's reads)
  __device__ __forceinline__ void publish(int np) const {
    fence_async_smem();
    mbar_arrive(pfull(np & 1));
  }
  // a block warpgroup, tile it: acc += the A buffer's NP tiles . its block
  // (w < nb; nbox 64-column boxes) of the operand ring's slot, then both
  // released
  template <int NP>
  __device__ __forceinline__ void block_step(float (&acc)[DEEP_CHUNK / 2], int it, int w, int nb,
                                             uint32_t pa, int nbox) {
    mbar_wait(pfull(it & 1), (it >> 1) & 1);
    const int os = oring.take();
    if (w < nb)
      block_products<NP>(acc, pa + (it & 1) * NP * PTILE, oring.slot(os) + w * CHUNK, nbox);
    oring.release(os);
    mbar_arrive(pempty(it & 1));
  }
};

// The key-major gradients of one (b, h, 64-key tile, gradient, group) on a
// CTA of W blocks: maps q, pos_q, dO, k, pos_k, v.
template <int W>
__global__ void __launch_bounds__(NC * (2 + W), 1) bwd_kv_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dpk, __nv_bfloat16* __restrict__ dv, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using L = DeepBwd<W, false>;
  using C = Cta<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  __nv_bfloat16* const rel_buf = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_REL);
  DeepBwdCta<W> cta(base, base + L::OFF_BAR);
  const uint32_t pbuf = base + L::OFF_P;
  const int nk = deep_chunks(D), groups = (nk + W - 1) / W, lb = last_boxes<W>(D);
  const int grp = blockIdx.x % groups, g = blockIdx.x / groups % 3;  // g: dv, dk, dpos_k
  const int k0 = blockIdx.x / groups / 3 * BK, h = blockIdx.y, b = blockIdx.z;
  const int blk0 = W * grp, nb = min(W, nk - blk0), bh = b * H + h;
  const bool kW = g != 0;  // dW needed (else P alone, no dP product)
  const int n = (Tq + BQ - 1) / BQ;
  const int wg = threadIdx.x / NC, tid = threadIdx.x % NC;

  if (threadIdx.x == 0) cta.init();
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup
    regs_dec<C::PRODUCER_REGS>();
    if (tid == 0) {
      for (int it = 0; it < n; ++it) {
        const int q0 = it * BQ;
        for (int c = 0; c < 2 * nk; ++c) {  // k . q chunk by chunk, then pos_k . pos_q
          const int i = c < nk ? 0 : 1, nbox = chunk_boxes(c % nk, nk, lb);
          const int st = cta.sring.put(2 * chunk_bytes<W>(c % nk, nk, lb));
          load_chunk(cta.sring.slot(st), maps, 3 + i, cta.sring.full(st), c % nk, k0, bh, nbox);
          load_chunk(cta.sring.slot(st) + CHUNK, maps, i, cta.sring.full(st), c % nk, q0, bh,
                     nbox);
        }
        for (int c = 0; kW && c < nk; ++c) {  // v . dO
          const int nbox = chunk_boxes(c, nk, lb);
          const int st = cta.sring.put(2 * chunk_bytes<W>(c, nk, lb));
          load_chunk(cta.sring.slot(st), maps, 5, cta.sring.full(st), c, k0, bh, nbox);
          load_chunk(cta.sring.slot(st) + CHUNK, maps, 2, cta.sring.full(st), c, q0, bh, nbox);
        }
      }
    } else if (tid == 32) {
      const int op = g == 0 ? 2 : g - 1;  // dO, q or pos_q
      for (int it = 0; it < n; ++it) {
        const int st = cta.oring.put(blocks_bytes<W>(blk0, nb, nk, lb));
        for (int w = 0; w < nb; ++w)
          load_chunk(cta.oring.slot(st) + w * CHUNK, maps, op, cta.oring.full(st), blk0 + w,
                     it * BQ, bh, chunk_boxes(blk0 + w, nk, lb));
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // key rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                  // query columns 8 j + cq and + 1
  int s_of[2];
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s_of[hh] = k0 + r0 + 8 * hh;
    key_ok[hh] = s_of[hh] < S;
  }

  if (wg == 1) {  // the builder
    regs_inc<C::BUILDER_REGS>();
    const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
    bool key_pad[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) key_pad[hh] = key_ok[hh] && kpad[(long long)b * S + s_of[hh]];
    float sc[32], dp[32];
    for (int it = 0; it < n; ++it) {
      const int q0 = it * BQ;
      // rel's tile, staged in its own layout and read transposed below (the
      // pair route loads it while the products run, and stores it after them)
      uint32_t relv[BQ / 4];
      if (relh && W == PW) load_rel(relv, relh, rel_rs, rel_vec != 0, q0, k0, Tq, S, tid);
      if (relh && W != PW) {
        if (it) named_sync(3, NC);  // the previous tile's reads are done
        stage_rel(rel_buf, relh, rel_rs, rel_vec != 0, q0, k0, Tq, S, tid);
        named_sync(3, NC);
      }
      // the pair route loads this tile's lse and dsum (the 16 query columns of
      // this thread) into registers while the products run (see the header)
      float lsv[W == PW ? 16 : 1], dsv[W == PW ? 16 : 1];
      if constexpr (W == PW) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int t = q0 + 8 * (u >> 1) + cq + (u & 1);
          lsv[u] = t < Tq ? __ldg(lse + (long long)bh * Tq + t) : 0.f;
          dsv[u] = kW && t < Tq ? __ldg(dsum + (long long)bh * Tq + t) : 0.f;
        }
      }
      score_products<W>(sc, cta.sring, 2 * nk, 0, nk, lb);
      if (kW) score_products<W>(dp, cta.sring, nk, 0, nk, lb);
      if (relh && W == PW) {
        if (it) named_sync(3, NC);  // the previous tile's reads are done
        store_rel(rel_buf, relv, tid);
        named_sync(3, NC);
      }
      // P^T (or dW^T) in fp32, 0 past S and past Tq; rounded once to bf16 below
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = q0 + 8 * j + cq + e;
          float ls, ds;
          if constexpr (W == PW) {
            ls = lsv[2 * j + e];
            ds = dsv[2 * j + e];
          } else {
            ls = t < Tq ? __ldg(lse + (long long)bh * Tq + t) : 0.f;
            ds = kW && t < Tq ? __ldg(dsum + (long long)bh * Tq + t) : 0.f;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh + e;
            float w = sc[i];
            if (relh) w += __bfloat162float(rel_buf[(8 * j + cq + e) * REL_STRIDE + r0 + 8 * hh]);
            const bool neg = key_pad[hh] || (causal && s_of[hh] > t);
            w = neg ? NEG : w;
            const float p = key_ok[hh] && t < Tq ? fexp(w - ls) : 0.f;
            sc[i] = kW ? p * (dp[i] - ds) : p;
          }
        }
      }
      cta.wait_empty(it);
      store_a_tile(pbuf + (it & 1) * PTILE, sc, r0, cq);
      cta.publish(it);
    }
    return;
  }

  // a block warpgroup: column block blk0 + w of gradient g, if it exists
  const int w = wg - 2, c0 = DEEP_CHUNK * (blk0 + w);
  float acc[DEEP_CHUNK / 2];
  zero(acc);
  const int nbox = chunk_boxes(blk0 + w, nk, lb);
  for (int it = 0; it < n; ++it) cta.template block_step<1>(acc, it, w, nb, pbuf, nbox);
  if (w >= nb) return;
  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) off[hh] = key_ok[hh] ? ((long long)bh * S + s_of[hh]) * D : -1;
  store_rows<DEEP_CHUNK>(acc, (g == 0 ? dv : (g == 1 ? dk : dpk)) + c0, off, cq, D - c0);
}

// The query-major gradients of one (b, h, 64-row q tile, gradient, group),
// and with drel_part this batch row's dW (drel's partial; the dq CTAs of
// group 0 write it), on a CTA of W blocks. maps: q, pos_q, dO, k, pos_k, v.
template <int W>
__global__ void __launch_bounds__(NC * (2 + W), 1) bwd_q_deep(
    const __grid_constant__ Maps<DEEP_CHUNK, 6> maps, const __nv_bfloat16* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dpq, float* __restrict__ drel_part, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int rel_vec, int causal, int D) {
  using L = DeepBwd<W, true>;
  using C = Cta<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  DeepBwdCta<W> cta(base, base + L::OFF_BAR);
  const uint32_t pbuf = base + L::OFF_P;
  const int nk = deep_chunks(D), groups = (nk + W - 1) / W, lb = last_boxes<W>(D);
  const int grp = blockIdx.x % groups, g = blockIdx.x / groups % 2;  // g: dq, dpos_q
  const int q0 = blockIdx.x / groups / 2 * BQ, h = blockIdx.y, b = blockIdx.z;
  const int blk0 = W * grp, nb = min(W, nk - blk0), bh = b * H + h;
  const int n = (S + BK - 1) / BK;
  const int wg = threadIdx.x / NC, tid = threadIdx.x % NC;

  if (threadIdx.x == 0) cta.init();
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup
    regs_dec<C::PRODUCER_REGS>();
    if (tid == 0) {
      for (int it = 0; it < n; ++it) {
        const int k0 = it * BK;
        for (int c = 0; c < 2 * nk; ++c) {  // q . k chunk by chunk, then pos_q . pos_k
          const int i = c < nk ? 0 : 1, nbox = chunk_boxes(c % nk, nk, lb);
          const int st = cta.sring.put(2 * chunk_bytes<W>(c % nk, nk, lb));
          load_chunk(cta.sring.slot(st), maps, i, cta.sring.full(st), c % nk, q0, bh, nbox);
          load_chunk(cta.sring.slot(st) + CHUNK, maps, 3 + i, cta.sring.full(st), c % nk, k0, bh,
                     nbox);
        }
        for (int c = 0; c < nk; ++c) {  // dO . v
          const int nbox = chunk_boxes(c, nk, lb);
          const int st = cta.sring.put(2 * chunk_bytes<W>(c, nk, lb));
          load_chunk(cta.sring.slot(st), maps, 2, cta.sring.full(st), c, q0, bh, nbox);
          load_chunk(cta.sring.slot(st) + CHUNK, maps, 5, cta.sring.full(st), c, k0, bh, nbox);
        }
      }
    } else if (tid == 32) {
      for (int it = 0; it < n; ++it) {  // k or pos_k
        const int st = cta.oring.put(blocks_bytes<W>(blk0, nb, nk, lb));
        for (int w = 0; w < nb; ++w)
          load_chunk(cta.oring.slot(st) + w * CHUNK, maps, 3 + g, cta.oring.full(st), blk0 + w,
                     it * BK, bh, chunk_boxes(blk0 + w, nk, lb));
      }
    }
    return;  // no block-wide barrier follows
  }

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // query rows r0 and r0 + 8 of the tile
  const int cq = 2 * (lane & 3);                  // key columns 8 j + cq and + 1
  const int t0 = q0 + r0;

  if (wg == 1) {  // the builder
    regs_inc<C::BUILDER_REGS>();
    const __nv_bfloat16* relh = rel ? rel + h * rel_hs : nullptr;
    const uint8_t* kp = kpad + (long long)b * S;
    float* const part =
        drel_part && g == 0 && grp == 0 ? drel_part + (long long)b * H * Tq * S : nullptr;
    const bool part_vec = S % 2 == 0;  // then a column pair is one aligned float2
    float ls[2], ds[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + 8 * hh;
      ls[hh] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
      ds[hh] = t < Tq ? dsum[(long long)bh * Tq + t] : 0.f;
    }
    float sc[32], dp[32];
    TileBias<__nv_bfloat16, W == PW> bias;
    for (int it = 0; it < n; ++it) {
      const int k0 = it * BK, lim = S - k0;
      load_bias(bias, relh, rel_rs, rel_vec != 0, kp, k0, S, t0, Tq, lane, cq);  // while they run
      score_products<W>(sc, cta.sring, 2 * nk, 0, nk, lb);
      score_products<W>(dp, cta.sring, nk, 0, nk, lb);
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
      cta.wait_empty(it);
      const uint32_t pa = pbuf + (it & 1) * 2 * PTILE;
      store_a_tile(pa, dp, r0, cq);                 // dW's high part,
      store_a_tile(pa + PTILE, dp, r0, cq, true);   // then its low part
      cta.publish(it);
    }
    return;
  }

  // a block warpgroup: column block blk0 + w of dq or dpos_q, if it exists
  const int w = wg - 2, c0 = DEEP_CHUNK * (blk0 + w);
  float acc[DEEP_CHUNK / 2];
  zero(acc);
  const int nbox = chunk_boxes(blk0 + w, nk, lb);
  for (int it = 0; it < n; ++it) cta.template block_step<2>(acc, it, w, nb, pbuf, nbox);
  if (w >= nb) return;
  long long off[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 8 * hh;
    off[hh] = t < Tq ? ((long long)bh * Tq + t) * D : -1;
  }
  store_rows<DEEP_CHUNK>(acc, (g == 0 ? dq : dpq) + c0, off, cq, D - c0);
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

// The launches past head dim 128 on a CTA of W blocks (DW: the deep route,
// PW: the pair route) on `stream`, the arguments as launch_bwd's (D a
// multiple of 8): the key-major launch (dv, dk, dpos_k), the query-major one
// (dq with drel's partials, dpos_q), then drel's sum. Returns a cudaError_t
// code.
template <int W>
int launch_bwd_deep(const void* q, const void* pq, const void* k, const void* pk, const void* v,
                    const void* rel, const void* kpad, const void* dout, const float* lse,
                    const float* dsum, void* dq, void* dpq, void* dk, void* dpk, void* dv,
                    float* drel_part, int B, int H, int Tq, int S, long long rel_hs,
                    long long rel_rs, int causal, int D, cudaStream_t stream) {
  Maps<DEEP_CHUNK, 6> maps;
  if (const int err = stream_maps<DEEP_CHUNK, 6>(maps, {q, pq, dout, k, pk, v},
                                                 {Tq, Tq, Tq, S, S, S}, (long long)B * H, D))
    return err;
  const int rel_vec = rel && reinterpret_cast<uintptr_t>(rel) % 4 == 0 && rel_rs % 2 == 0 &&
                      rel_hs % 2 == 0 && S % 2 == 0;
  const int groups = (deep_chunks(D) + W - 1) / W;
  const auto* relt = static_cast<const __nv_bfloat16*>(rel);
  const auto* kp = static_cast<const uint8_t*>(kpad);
  constexpr size_t kv_smem = DeepBwd<W, false>::SMEM, q_smem = DeepBwd<W, true>::SMEM;
  static SmemOptIn kv_opt_in, q_opt_in;
  const void* kv = (const void*)bwd_kv_deep<W>;
  const void* qm = (const void*)bwd_q_deep<W>;
  if (const int e = kv_opt_in.ensure(kv, kv_smem)) return e;
  if (const int e = q_opt_in.ensure(qm, q_smem)) return e;
  if (const int e = deep_regs_ok<W>(kv)) return e;
  if (const int e = deep_regs_ok<W>(qm)) return e;
  bwd_kv_deep<W><<<dim3((S + BK - 1) / BK * 3 * groups, H, B), cta_threads<W>(), kv_smem,
                   stream>>>(maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dk),
                             static_cast<__nv_bfloat16*>(dpk), static_cast<__nv_bfloat16*>(dv),
                             H, Tq, S, rel_hs, rel_rs, rel_vec, causal, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_q_deep<W><<<dim3((Tq + BQ - 1) / BQ * 2 * groups, H, B), cta_threads<W>(), q_smem,
                  stream>>>(maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dq),
                            static_cast<__nv_bfloat16*>(dpq), drel_part, H, Tq, S, rel_hs, rel_rs,
                            rel_vec, causal, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || !drel_part || B == 1) return (int)err;
  const long long n = (long long)H * Tq * S, threads = n % 4 == 0 ? n / 4 : n;
  drel_sum<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(drel_part, n, B);
  return (int)cudaGetLastError();
}

// Launches the key-major launches (one at DP 32 and 64, two at 80, three at
// 128), the query-major ones (one, two at 128) and drel's sum on `stream`
// for bf16 streams [B, H, Tq or S, D] (16-byte aligned, D <= DP a multiple
// of 8), bf16 rel (or null), K3's lse and the pre-pass's dsum (fp32
// [B, H, Tq]); drel_part is fp32 [B, H, Tq, S] scratch whose first
// [H, Tq, S] receives drel, or null. At DP 192 and 256 the pair route
// (launch_bwd_deep<PW>).
// Returns a cudaError_t code.
template <int DP>
int launch_bwd(const void* q, const void* pq, const void* k, const void* pk, const void* v,
               const void* rel, const void* kpad, const void* dout, const float* lse,
               const float* dsum, void* dq, void* dpq, void* dk, void* dpk, void* dv,
               float* drel_part, int B, int H, int Tq, int S, long long rel_hs, long long rel_rs,
               int causal, int D, cudaStream_t stream) {
  if constexpr (DP > 128) {
    return launch_bwd_deep<PW>(q, pq, k, pk, v, rel, kpad, dout, lse, dsum, dq, dpq, dk, dpk, dv,
                               drel_part, B, H, Tq, S, rel_hs, rel_rs, causal, D, stream);
  } else {
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
      bwd_kv<DP, kOut><<<dim3((S + BK - 1) / BK, H, B), NT, smem, stream>>>(
          maps, relt, kp, lse, dsum, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dpk), static_cast<__nv_bfloat16*>(dv), H, Tq, S, rel_hs,
          rel_rs, rel_vec, causal, D);
      return cudaGetLastError();
    };
    auto qm = [&](auto out, float* part) -> cudaError_t {  // one query-major launch
      constexpr int kOut = decltype(out)::value;
      static SmemOptIn opt_in;
      if (const int e = opt_in.ensure((const void*)bwd_q<DP, kOut>, smem)) return (cudaError_t)e;
      bwd_q<DP, kOut><<<dim3((Tq + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
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
}

// launch_bwd<dp>, for an instance dp of common.cuh::with_head_dim (DEEP:
// launch_bwd_deep<DW>): defined in
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
