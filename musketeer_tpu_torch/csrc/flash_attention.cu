// K5: the JAX package's first-generation attention entry points, for sm_90a.
//
// Replaces the Pallas kernels of musketeer_tpu/ops/flash_attention.py:
// flash_attention_bias (_attn_kernel, _causal_attn_kernel; pallas_call at
// :186) and flash_cross_attention (_attn_kernel_norel; pallas_call at :134).
// Per (b, h):
//   w   = q.k^T + pos_q.pos_k^T (+ rel[h]) in fp32, causal and pad masks -1e9
//   p   = round_T(exp(w - m) / l)      m, l over S real and Sp - S padded keys
//   out = p . v                         fp32 sums, rounded to T
// Three things set it apart from K1 (flash_fwd.cuh):
//   - p is normalised in fp32 and then rounded, before P.v; K1 rounds e and
//     divides after P.v. An online softmax cannot normalise before P.v, so a
//     block makes two passes over the keys: the first finds each row's max m
//     and denominator l (online, as K3's lse), the second recomputes the
//     scores, forms p and accumulates P.v.
//   - The JAX wrappers pad the keys to Sp (a multiple of block_q, or of 128
//     for cross attention): masked, with zero v. They are not materialised
//     here: they add (Sp - S) exp(-1e9 - m) to l, which is exactly 0 unless
//     every real key of the row is masked, where it gives sum(v[:S]) / Sp.
//   - rel is read in its own dtype, TR: T or fp32.
//
// Two cores, chosen by the streams' dtype. bf16 runs the tensor-core core of
// flash_fwd_sm90.cuh (wgmma fed by TMA; both passes in one CTA), which also
// serves K1. fp32 (rel fp32 too) runs the kernel below: one block owns one
// (b, h, 64-row q tile) and streams 64-key tiles through shared memory
// twice, with the FMA staging and the 128-deep score dot over
// [q|pos_q].[k|pos_k] of flash_fwd.cuh; on tensor cores fp32 would mean TF32.
//
// Bound. At the ofa_base encoder shape (B16 H12 S908 D64, bf16) the function
// is ~30 G multiply-adds against ~130 MB of streams and rel: compute bound
// on the card (0.0615 ms at 989 TFLOP/s). The second pass repeats the score
// products, 1.67x the function's work.
#include "flash_deep.cuh"
#include "flash_fwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

namespace ff = mk::flash_fwd;

constexpr int NT = ff::NT;
constexpr float NEG = ff::NEG;

// The fp32 kernel. Scores of key tile k0 for this thread's RI x CJ (row, key)
// pairs: bias added, masks at -1e9, -inf past S (no part of the softmax).
template <int DP>
__device__ __forceinline__ void scores(const float* qs, const float* ks, int tx, int ty, int q0,
                                       int k0, int Tq, int S, const float* relh,
                                       long long rel_rs, const uint8_t* kp, int causal,
                                       float (&sc)[ff::Dims<DP>::RI][ff::Dims<DP>::CJ]) {
  ff::score_tile<DP>(qs, ks, tx, ty, sc);
#pragma unroll
  for (int i = 0; i < ff::Dims<DP>::RI; ++i) {
    const int t = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < ff::Dims<DP>::CJ; ++j) {
      const int s = k0 + tx + 16 * j;
      float w = -CUDART_INF_F;
      if (s < S) {
        w = sc[i][j];
        if (relh && t < Tq) w += relh[t * rel_rs + s];
        if (causal && s > t) w = NEG;
        if (kp[s]) w = NEG;
      }
      sc[i][j] = w;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT) kernel(
    const float* __restrict__ q, const float* __restrict__ pq, const float* __restrict__ k,
    const float* __restrict__ pk, const float* __restrict__ v, const float* __restrict__ rel,
    const uint8_t* __restrict__ kpad, float* __restrict__ out, int H, int Tq, int S, int Sp,
    long long rel_hs, long long rel_rs, int causal, int D) {
  using Dm = ff::Dims<DP>;
  constexpr int QS = Dm::QS, VS = Dm::VS, PS = Dm::PS, BQ = Dm::BQ, BK = Dm::BK;
  constexpr int RI = Dm::RI, CJ = Dm::CJ;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][QS]  q | pos_q
  float* ks = qs + BQ * QS;    // [BK][QS]  k | pos_k
  float* vs = ks + BK * QS;    // [BK][VS]
  float* ps = vs + BK * VS;    // [BQ][PS]  normalised probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, columns tx + 16 j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* kb = k + bh * S * D;
  const float* pkb = pk + bh * S * D;
  const float* vb = v + bh * S * D;
  const uint8_t* kp = kpad + (long long)b * S;
  const float* relh = rel ? rel + h * rel_hs : nullptr;

  ff::stage_q<DP>(qs, q + bh * Tq * D, pq + bh * Tq * D, q0, Tq, D);

  // pass 1: each row's max and denominator over the real keys
  float m[RI], l[RI], sc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's ks reads are done
    ff::stage_kv<DP, float, false>(ks, nullptr, kb, pkb, nullptr, k0, S, D);
    __syncthreads();
    scores<DP>(qs, ks, tx, ty, q0, k0, Tq, S, relh, rel_rs, kp, causal, sc);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CJ; ++j) tmax = fmaxf(tmax, sc[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[i], tmax);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) rs += expf(sc[i][j] - mnew);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - mnew) + rs;
      m[i] = mnew;
    }
  }
  // the wrapper's Sp - S padded keys: score -1e9, v zero
  if (Sp > S) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float mnew = fmaxf(m[i], NEG);
      l[i] = l[i] * expf(m[i] - mnew) + (float)(Sp - S) * expf(NEG - mnew);
      m[i] = mnew;
    }
  }

  // pass 2: p = exp(w - m) / l, accumulated against v
  float acc[RI][DP / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    ff::stage_kv<DP, float, true>(ks, vs, kb, pkb, vb, k0, S, D);
    __syncthreads();
    scores<DP>(qs, ks, tx, ty, q0, k0, Tq, S, relh, rel_rs, kp, causal, sc);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        ps[(ty + 16 * i) * PS + tx + 16 * j] = expf(sc[i][j] - m[i]) / l[i];
    __syncthreads();  // ps complete
    ff::pv_tile<DP>(ps, vs, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      if (tx + 16 * j < D) out[(bh * Tq + t) * D + tx + 16 * j] = acc[i][j];
  }
}

template <int DP>
int launch(const void* q, const void* pq, const void* k, const void* pk, const void* v,
           const void* rel, const void* kpad, void* out, int B, int H, int Tq, int S, int Sp,
           long long rel_hs, long long rel_rs, int causal, int D, cudaStream_t stream) {
  constexpr size_t smem = ff::Dims<DP>::SMEM_BYTES;
  static mk::SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)kernel<DP>, smem)) return err;
  const dim3 grid((Tq + ff::Dims<DP>::BQ - 1) / ff::Dims<DP>::BQ, H, B);
  kernel<DP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pq), static_cast<const float*>(k),
      static_cast<const float*>(pk), static_cast<const float*>(v), static_cast<const float*>(rel),
      static_cast<const uint8_t*>(kpad), static_cast<float*>(out), H, Tq, S, Sp, rel_hs, rel_rs,
      causal, D);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 streams (q, k, v, pos_q, pos_k, out), else
// float; rel_f32 != 0 reads rel as float, else in the streams' type. rel may
// be null (cross attention); kpad is bool [B, S]; Sp >= S counts the padded
// keys of the JAX wrapper; head_dim is a multiple of 8 (common.cuh::
// with_head_dim; past 256 the fp32 streams run on flash_deep.cuh's deep
// route). Returns cudaGetLastError().
extern "C" int mk_flash_attention_k5(int bf16, int rel_f32, const void* q, const void* pos_q,
                                     const void* k, const void* pos_k, const void* v,
                                     const void* rel, const void* kpad, void* out, int B, int H,
                                     int Tq, int S, int Sp, long long rel_head_stride,
                                     long long rel_row_stride, int causal, int head_dim,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int D = head_dim;
  return mk::with_head_dim(head_dim, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    if (!bf16) {
      if constexpr (DP == mk::DEEP)
        return mk::flash_deep::launch_fwd<mk::flash_deep::K5>(
            q, pos_q, k, pos_k, v, rel, kpad, out, nullptr, B, H, Tq, S, Sp, rel_head_stride,
            rel_row_stride, causal, 0, D, st);
      else
        return launch<DP>(q, pos_q, k, pos_k, v, rel, kpad, out, B, H, Tq, S, Sp,
                          rel_head_stride, rel_row_stride, causal, D, st);
    }
    if (rel_f32)
      return mk::sm90::launch<DP, true, float>(q, pos_q, k, pos_k, v, rel, kpad, out, nullptr, B,
                                               H, Tq, S, Sp, rel_head_stride, rel_row_stride,
                                               causal, 0, D, st);
    return mk::sm90::launch<DP, true, __nv_bfloat16>(q, pos_q, k, pos_k, v, rel, kpad, out,
                                                     nullptr, B, H, Tq, S, Sp, rel_head_stride,
                                                     rel_row_stride, causal, 0, D, st);
  });
}
