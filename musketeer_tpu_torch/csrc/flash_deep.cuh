// The deep route of the fp32 FMA attention kernels: K1, K3, K5 and K4's fp32
// launches at head dims past 256 (common.cuh::DEEP), where the whole-width
// tiles of flash_fwd.cuh and flash_attention_bwd.cu would not fit a block's
// shared memory (their 32-row fp32 tiles of [q|pos_q], [k|pos_k] and v take
// 24 x D bytes a row: 206 KB at 256, 310 KB at 384) nor its registers (a
// thread's output columns are D / 16).
//
// Design. The head dim streams through every product in chunks of
// DEEP_CHUNK (128) columns, and each output's columns split into blocks of
// 128 over the grid (block x = tile x nch + block, nch = ceil(D / 128)), so a
// block's shared memory (59 KB forward, 97 KB backward) and registers are
// those of one chunk, whatever D. A score tile [32 queries x 32 keys] sums
// the chunk dots of [q|pos_q] . [k|pos_k] in order in fp64 (each product of
// two fp32 values exact there), then rounds it once to fp32; dP = dO . v^T
// likewise. The 512-deep dots past DP 128 needed four interleaved fp32
// chains to stay within 1e-5 of max|ref| of the plain version (cuBLAS); at
// D 384, 768-deep scores with four chains a chunk put K4's fp32 dpos_k 1.05e-5
// of max|dpos_k| from plain on an H100, so the deep route's sums carry no
// fp32 rounding at all, and what is left is the plain version's. Every
// block recomputes the scores (and K4's dP) of its rows for its column
// block: nch times the score work of one whole-width block. 256 threads, 16
// x 16, each a 2 x 2 tile of scores and 2 rows x 8 columns of each output
// block; rel, the masks and the softmax are flash_fwd.cuh's.
//
// Replaces, for fp32 streams at these head dims, the Pallas kernels of
// musketeer_tpu/ops/flash_attention_infer.py (K1, :143),
// musketeer_tpu/ops/flash_attention_bwd.py (K3 :265, K4 :388) and
// musketeer_tpu/ops/flash_attention.py (K5, :134 and :186), which take any D.
// Bound: as flash_fwd.cuh's and flash_attention_bwd.cu's, the fp32 FMA rate
// (~67 TFLOP/s), times the recomputed scores.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mk {
namespace flash_deep {

constexpr int NT = 256;          // threads: 16 x 16
constexpr int BQ = 32, BK = 32;  // query rows of a block, keys of a tile
constexpr int R = 2;             // a thread's rows ty + 16 i and keys tx + 16 j
constexpr int CW = DEEP_CHUNK;   // columns of a chunk and of an output block
constexpr int CS = CW + 1;       // a staged chunk's row stride, +1 word against bank conflicts
constexpr int NB = CW / 16;      // a thread's columns tx + 16 c of an output block
constexpr int PS = BK + 1;
constexpr float NEG = -1e9f;

// the forward's shared memory: two chunk tiles for the scores, v's block,
// the probabilities
constexpr size_t FWD_SMEM = sizeof(float) * (3 * BQ * CS + BQ * PS);
// the backward's: three chunk tiles (the score and dP chunks, then the
// operands' blocks), P and dW
constexpr size_t BWD_SMEM = sizeof(float) * (3 * BQ * CS + 2 * BQ * PS);

// Rows r0 .. r0 + 31 of chunk c (columns CW c ..) of a [rows, D] stream into
// dst [32][CS]; zeros past `rows` and past D.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* __restrict__ x, int r0,
                                            int rows, int c, int D) {
  for (int i = threadIdx.x; i < BQ * CW; i += NT) {
    const int r = i / CW, col = CW * c + i % CW, t = r0 + r;
    dst[r * CS + i % CW] = t < rows && col < D ? to_f(x[(long long)t * D + col]) : 0.f;
  }
}

template <int A, int B>
__device__ __forceinline__ void zero(float (&x)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) x[i][j] = 0.f;
}

// acc[i][j] = the sum over the n chunks of a's rows ty + 16 i . b's rows
// tx + 16 j, chunk c of a from xa[c < na ? 0 : 1] (rows ra0 .. of ra), of b
// from xb likewise, in fp64 (every product exact), rounded once to fp32. sa,
// sb: two staging tiles; the block's threads all call it.
template <typename T>
__device__ __forceinline__ void chunk_dots(float* sa, float* sb, const T* xa0, const T* xa1,
                                           const T* xb0, const T* xb1, int ra0, int ra,
                                           int rb0, int rb, int na, int n, int D,
                                           float (&acc)[R][R]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  double sum[R][R] = {};
  for (int c = 0; c < n; ++c) {
    __syncthreads();  // the previous readers of sa and sb are done
    stage_chunk(sa, c < na ? xa0 : xa1, ra0, ra, c % na, D);
    stage_chunk(sb, c < na ? xb0 : xb1, rb0, rb, c % na, D);
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < CW; ++d) {
      double x[R], y[R];
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = sa[(ty + 16 * i) * CS + d];
#pragma unroll
      for (int j = 0; j < R; ++j) y[j] = sb[(tx + 16 * j) * CS + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) sum[i][j] = fma(x[i], y[j], sum[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = static_cast<float>(sum[i][j]);
}

// The scores of query rows q0 + ty + 16 i against keys k0 + tx + 16 j: rel,
// causal and pad masks at -1e9, -inf past S (no part of the softmax).
__device__ __forceinline__ void mask(float (&sc)[R][R], const float* relh, long long rel_rs,
                                     const uint8_t* kp, int q0, int k0, int Tq, int S,
                                     int causal) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
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

__device__ __forceinline__ float row_max(float x) {  // over the 16 threads of a row
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][c] += sum_s ps[ty + 16 i][s] vs[s][tx + 16 c] over a tile's BK keys
__device__ __forceinline__ void pv(const float* ps, const float* vs, float (&acc)[R][NB]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int s = 0; s < BK; ++s) {
    float p[R], w[NB];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = ps[(ty + 16 * i) * PS + s];
#pragma unroll
    for (int c = 0; c < NB; ++c) w[c] = vs[s * CS + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < NB; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
  }
}

enum FwdMode { K1 = 0, K3 = 1, K5 = 2 };

// The forward of one (b, h, 32-row q tile, column block). K1: the online
// softmax, probabilities normalised after P.v; K3: K1 and each row's lse
// (written by block 0); K5: two passes, p = exp(w - m) / l before P.v with
// the Sp - S padded keys of the JAX wrapper in l (flash_attention.cu). fp32
// streams [B, H, rows, D], rel fp32 or null.
template <int kMode>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ pq, const float* __restrict__ k,
    const float* __restrict__ pk, const float* __restrict__ v, const float* __restrict__ rel,
    const uint8_t* __restrict__ kpad, float* __restrict__ out, float* __restrict__ lse, int H,
    int Tq, int S, int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D) {
  extern __shared__ float smem[];
  float* sa = smem;          // [BQ][CS] a chunk of q or pos_q
  float* sb = sa + BQ * CS;  // [BK][CS] a chunk of k or pos_k
  float* vs = sb + BK * CS;  // [BK][CS] the block's columns of v
  float* ps = vs + BK * CS;  // [BQ][PS] probabilities
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nch = deep_chunks(D), nk = nch;
  const int q0 = blockIdx.x / nch * BQ, cb = blockIdx.x % nch, c0 = CW * cb;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float *qb = q + bh * Tq * D, *pqb = pq + bh * Tq * D;
  const float *kb = k + bh * S * D, *pkb = pk + bh * S * D, *vb = v + bh * S * D;
  const uint8_t* kp = kpad + (long long)b * S;
  const float* relh = rel ? rel + h * rel_hs : nullptr;
  constexpr bool kNorm = kMode == K5;

  auto scores = [&](int k0, float (&sc)[R][R]) {
    chunk_dots(sa, sb, qb, pqb, kb, pkb, q0, Tq, k0, S, nk, 2 * nk, D, sc);
    mask(sc, relh, rel_rs, kp, q0, k0, Tq, S, causal);
  };
  // ps complete for this tile: v's block staged beside it, then P.v
  auto values = [&](int k0, float (&acc)[R][NB]) {
    stage_chunk(vs, vb, k0, S, cb, D);
    __syncthreads();
    pv(ps, vs, acc);
  };

  float m[R], l[R], acc[R][NB], sc[R][R];
  zero(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = !kNorm && skip_max ? 0.f : -CUDART_INF_F;
    l[i] = 0.f;
  }
  if constexpr (kNorm) {  // pass 1: each row's max and denominator over the real keys
    for (int k0 = 0; k0 < S; k0 += BK) {
      scores(k0, sc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float mnew = fmaxf(m[i], row_max(fmaxf(sc[i][0], sc[i][1])));
        const float rs = row_sum(expf(sc[i][0] - mnew) + expf(sc[i][1] - mnew));
        l[i] = l[i] * expf(m[i] - mnew) + rs;
        m[i] = mnew;
      }
    }
    if (Sp > S) {  // the wrapper's Sp - S padded keys: score -1e9, v zero
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float mnew = fmaxf(m[i], NEG);
        l[i] = l[i] * expf(m[i] - mnew) + (float)(Sp - S) * expf(NEG - mnew);
        m[i] = mnew;
      }
    }
  }
  for (int k0 = 0; k0 < S; k0 += BK) {
    scores(k0, sc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      if constexpr (kNorm) {  // pass 2: p = exp(w - m) / l
#pragma unroll
        for (int j = 0; j < R; ++j) ps[r * PS + tx + 16 * j] = expf(sc[i][j] - m[i]) / l[i];
      } else {  // the running max; acc and l rescaled to it
        const float mnew = skip_max ? 0.f : fmaxf(m[i], row_max(fmaxf(sc[i][0], sc[i][1])));
        const float scale = skip_max ? 1.f : expf(m[i] - mnew);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float e = expf(sc[i][j] - mnew);
          rs += e;
          ps[r * PS + tx + 16 * j] = e;
        }
        l[i] = l[i] * scale + row_sum(rs);
        m[i] = mnew;
#pragma unroll
        for (int c = 0; c < NB; ++c) acc[i][c] *= scale;
      }
    }
    values(k0, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = kNorm ? 1.f : (skip_max ? fmaxf(l[i], 1e-38f) : l[i]);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c0 + tx + 16 * c < D) out[(bh * Tq + t) * D + c0 + tx + 16 * c] = acc[i][c] / denom;
    if (kMode == K3 && cb == 0 && tx == 0)
      lse[bh * Tq + t] = skip_max ? logf(denom) : m[i] + logf(denom);
  }
}

// Launches the forward on `stream` (fp32 streams [B, H, Tq or S, D], D past
// 256 a multiple of 8); returns cudaGetLastError().
template <int kMode>
int launch_fwd(const void* q, const void* pq, const void* k, const void* pk, const void* v,
               const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq,
               int S, int Sp, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
               cudaStream_t stream) {
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)fwd_kernel<kMode>, FWD_SMEM)) return err;
  const dim3 grid((Tq + BQ - 1) / BQ * deep_chunks(D), H, B);
  fwd_kernel<kMode><<<grid, NT, FWD_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pq), static_cast<const float*>(k),
      static_cast<const float*>(pk), static_cast<const float*>(v), static_cast<const float*>(rel),
      static_cast<const uint8_t*>(kpad), static_cast<float*>(out), lse, H, Tq, S, Sp, rel_hs,
      rel_rs, causal, skip_max, D);
  return (int)cudaGetLastError();
}

// ---- K4 ---------------------------------------------------------------------

// P = exp(w - lse) and dW = P (dP - dsum) for query rows q0 + ty + 16 i and
// keys k0 + tx + 16 j of (b, h): the scores and dP by chunks, P = 0 past Tq
// and S. qb .. vb point at the (b, h) streams.
__device__ __forceinline__ void probs_and_dw(
    float* sa, float* sb, const float* qb, const float* pqb, const float* kb, const float* pkb,
    const float* dob, const float* vb, const float* lse_bh, const float* dsum_bh,
    const float* relh, long long rel_rs, const uint8_t* kp, int q0, int k0, int Tq, int S,
    int causal, int D, float (&p)[R][R], float (&dw)[R][R]) {
  const int nk = deep_chunks(D), ty = threadIdx.x >> 4;
  float sc[R][R], dp[R][R];
  chunk_dots(sa, sb, qb, pqb, kb, pkb, q0, Tq, k0, S, nk, 2 * nk, D, sc);
  chunk_dots(sa, sb, dob, dob, vb, vb, q0, Tq, k0, S, nk, nk, D, dp);
  mask(sc, relh, rel_rs, kp, q0, k0, Tq, S, causal);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    const float ls = t < Tq ? lse_bh[t] : 0.f, ds = t < Tq ? dsum_bh[t] : 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // past S the score is -inf: P = 0
      p[i][j] = t < Tq ? expf(sc[i][j] - ls) : 0.f;
      dw[i][j] = p[i][j] * (dp[i][j] - ds);
    }
  }
}

// dv, dk and dpos_k's column block for one (b, h, 32-key tile, block).
// Static, as the next: each source that includes this header has its own.
static __global__ void __launch_bounds__(NT) bwd_kv_kernel(
    const float* __restrict__ q, const float* __restrict__ pq, const float* __restrict__ k,
    const float* __restrict__ pk, const float* __restrict__ v, const float* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dpk, float* __restrict__ dv, int H, int Tq, int S, long long rel_hs,
    long long rel_rs, int causal, int D) {
  extern __shared__ float smem[];
  float* sa = smem;          // [BQ][CS] score and dP chunks, then dO's block
  float* sb = sa + BQ * CS;  // [BK][CS] score and dP chunks, then q's block
  float* sc3 = sb + BK * CS;  // [BQ][CS] pos_q's block
  float* ps = sc3 + BQ * CS;  // [BQ][PS] P
  float* ws = ps + BQ * PS;   // [BQ][PS] dW
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nch = deep_chunks(D);
  const int k0 = blockIdx.x / nch * BK, cb = blockIdx.x % nch, c0 = CW * cb;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float *qb = q + bh * Tq * D, *pqb = pq + bh * Tq * D, *dob = dout + bh * Tq * D;
  const float *kb = k + bh * S * D, *pkb = pk + bh * S * D, *vb = v + bh * S * D;
  const float* relh = rel ? rel + h * rel_hs : nullptr;
  const uint8_t* kp = kpad + (long long)b * S;

  float adv[R][NB], adk[R][NB], adpk[R][NB];  // key rows ty + 16 i; columns c0 + tx + 16 c
  zero(adv);
  zero(adk);
  zero(adpk);
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    float p[R][R], dw[R][R];
    probs_and_dw(sa, sb, qb, pqb, kb, pkb, dob, vb, lse + bh * Tq, delta + bh * Tq, relh, rel_rs,
                 kp, q0, k0, Tq, S, causal, D, p, dw);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
        ws[(ty + 16 * i) * PS + tx + 16 * j] = dw[i][j];
      }
    __syncthreads();  // P, dW complete; the chunk tiles' readers done
    stage_chunk(sa, dob, q0, Tq, cb, D);
    stage_chunk(sb, qb, q0, Tq, cb, D);
    stage_chunk(sc3, pqb, q0, Tq, cb, D);
    __syncthreads();
    // dv[key] += sum_r P[r][key] dO[r];  dk, dpos_k [key] += sum_r dW[r][key] q, pos_q [r]
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pa[R], wa[R], g[NB], x[NB], y[NB];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pa[i] = ps[r * PS + ty + 16 * i];
        wa[i] = ws[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        g[c] = sa[r * CS + tx + 16 * c];
        x[c] = sb[r * CS + tx + 16 * c];
        y[c] = sc3[r * CS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          adv[i][c] = fmaf(pa[i], g[c], adv[i][c]);
          adk[i][c] = fmaf(wa[i], x[c], adk[i][c]);
          adpk[i][c] = fmaf(wa[i], y[c], adpk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = (bh * S + s) * D + c0;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c0 + tx + 16 * c >= D) continue;
      dk[row + tx + 16 * c] = adk[i][c];
      dpk[row + tx + 16 * c] = adpk[i][c];
      dv[row + tx + 16 * c] = adv[i][c];
    }
  }
}

// dq and dpos_q's column block for one (h, 32-row q tile, block) over batch
// rows [b0, b1) (all of them where drel is wanted, else blockIdx.z alone),
// and block 0 the drel tile summed over the batch in order.
static __global__ void __launch_bounds__(NT) bwd_q_kernel(
    const float* __restrict__ q, const float* __restrict__ pq, const float* __restrict__ k,
    const float* __restrict__ pk, const float* __restrict__ v, const float* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    float* __restrict__ dpq, float* __restrict__ drel, int B, int H, int Tq, int S,
    long long rel_hs, long long rel_rs, int causal, int D) {
  extern __shared__ float smem[];
  float* sa = smem;           // [BQ][CS] score and dP chunks, then k's block
  float* sb = sa + BQ * CS;   // [BK][CS] score and dP chunks, then pos_k's block
  float* ws = sb + BK * CS;  // [BQ][PS] dW
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nch = deep_chunks(D);
  const int q0 = blockIdx.x / nch * BQ, cb = blockIdx.x % nch, c0 = CW * cb;
  const int h = blockIdx.y;
  const int b0 = drel ? 0 : blockIdx.z, b1 = drel ? B : b0 + 1;
  const float* relh = rel ? rel + h * rel_hs : nullptr;
  float* const drel_tile = cb == 0 ? drel : nullptr;  // block 0 owns drel's rows

  for (int b = b0; b < b1; ++b) {
    const long long bh = (long long)b * H + h;
    const float *qb = q + bh * Tq * D, *pqb = pq + bh * Tq * D, *dob = dout + bh * Tq * D;
    const float *kb = k + bh * S * D, *pkb = pk + bh * S * D, *vb = v + bh * S * D;
    const uint8_t* kp = kpad + (long long)b * S;
    float adq[R][NB], adpq[R][NB];  // query rows ty + 16 i; columns c0 + tx + 16 c
    zero(adq);
    zero(adpq);
    for (int k0 = 0; k0 < S; k0 += BK) {
      float p[R][R], dw[R][R];
      probs_and_dw(sa, sb, qb, pqb, kb, pkb, dob, vb, lse + bh * Tq, delta + bh * Tq, relh,
                   rel_rs, kp, q0, k0, Tq, S, causal, D, p, dw);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int s = k0 + tx + 16 * j;
          ws[(ty + 16 * i) * PS + tx + 16 * j] = dw[i][j];
          // this block alone owns drel[h, q tile, :]: batch rows add in order
          if (drel_tile && t < Tq && s < S) drel_tile[((long long)h * Tq + t) * S + s] += dw[i][j];
        }
      }
      __syncthreads();  // dW complete; the chunk tiles' readers done
      stage_chunk(sa, kb, k0, S, cb, D);
      stage_chunk(sb, pkb, k0, S, cb, D);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < BK; ++j) {
        float wa[R], x[NB], y[NB];
#pragma unroll
        for (int i = 0; i < R; ++i) wa[i] = ws[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          x[c] = sa[j * CS + tx + 16 * c];
          y[c] = sb[j * CS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            adq[i][c] = fmaf(wa[i], x[c], adq[i][c]);
            adpq[i][c] = fmaf(wa[i], y[c], adpq[i][c]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= Tq) continue;
      const long long row = (bh * Tq + t) * D + c0;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c0 + tx + 16 * c >= D) continue;
        dq[row + tx + 16 * c] = adq[i][c];
        dpq[row + tx + 16 * c] = adpq[i][c];
      }
    }
    __syncthreads();  // the next batch row's chunk tiles overwrite k's block
  }
}

// The key-major and query-major launches on `stream` after the dsum pre-pass
// (fp32 streams, D past 256 a multiple of 8; drel a zeroed [H, Tq, S] buffer
// or null); returns cudaGetLastError().
inline int launch_bwd(const void* q, const void* pq, const void* k, const void* pk,
                      const void* v, const void* rel, const void* kpad, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dpq, void* dk,
                      void* dpk, void* dv, float* drel, int B, int H, int Tq, int S,
                      long long rel_hs, long long rel_rs, int causal, int D,
                      cudaStream_t stream) {
  static SmemOptIn kv_opt_in, q_opt_in;
  if (const int err = kv_opt_in.ensure((const void*)bwd_kv_kernel, BWD_SMEM)) return err;
  if (const int err = q_opt_in.ensure((const void*)bwd_q_kernel, BWD_SMEM)) return err;
  const int nch = deep_chunks(D);
  const auto* qt = static_cast<const float*>(q);
  const auto* pqt = static_cast<const float*>(pq);
  const auto* kt = static_cast<const float*>(k);
  const auto* pkt = static_cast<const float*>(pk);
  const auto* vt = static_cast<const float*>(v);
  const auto* relt = static_cast<const float*>(rel);
  const auto* dot = static_cast<const float*>(dout);
  const auto* kp = static_cast<const uint8_t*>(kpad);
  bwd_kv_kernel<<<dim3((S + BK - 1) / BK * nch, H, B), NT, BWD_SMEM, stream>>>(
      qt, pqt, kt, pkt, vt, relt, kp, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dpk), static_cast<float*>(dv), H, Tq, S, rel_hs, rel_rs, causal, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_q_kernel<<<dim3((Tq + BQ - 1) / BQ * nch, H, drel ? 1 : B), NT, BWD_SMEM, stream>>>(
      qt, pqt, kt, pkt, vt, relt, kp, dot, lse, delta, static_cast<float*>(dq),
      static_cast<float*>(dpq), drel, B, H, Tq, S, rel_hs, rel_rs, causal, D);
  return (int)cudaGetLastError();
}

}  // namespace flash_deep
}  // namespace mk
