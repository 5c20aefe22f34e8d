// The online-softmax attention forward on fp32 FMAs: the fp32 launches of K1
// and K3 (training forward, which also writes the per-row logsumexp). Its
// tile staging, score dot and P.v steps are device functions that K5's fp32
// kernel (flash_attention.cu) reuses, and K4's fp32 kernels
// (flash_attention_bwd.cu) take their tile sizes from here. The bf16 launches
// of K1, K3 and K5 run on the tensor-core core of flash_fwd_sm90.cuh instead.
//
// Per (b, h):
//   out = softmax(q.k^T + pos_q.pos_k^T + rel[h] + causal/pad masks) . v
// with the TPU kernels' numerics: fp32 scores, masks as the finite -1e9 (a
// fully masked row gives the mean of v), probabilities rounded to v's dtype
// before P.v, normalisation after it; skip_max drops the running max and
// floors the denominator at 1e-38. With kLse the kernel also writes
//   lse = m + log(l)            (or log(max(l, 1e-38)) under skip_max)
// in fp32 for each query row, which the backward (K4) uses to rebuild P.
//
// Translation. The TPU grid walks (batch chunk, head, 128-row q tile) in
// order and holds all S keys of a head in VMEM. Here one block owns one
// (b, h, 64-row q tile) and loops over 64-key tiles with an online softmax
// (running max and sum in fp32, accumulator rescaled), so nothing depends on
// block order and shared memory holds one key tile at a time. The two
// 64-deep score dots are one 128-deep dot over [q|pos_q].[k|pos_k] staged in
// shared memory. rel is read in place through its own head and row strides,
// so a rel wider than S (as the JAX encoder composes it) needs no copy.
//
// Bound. At the caption encoder shape (B16 H12 T=S=908 D64, bf16) a call
// reads ~112 MB of q/k/v/pos streams plus a 20 MB rel and does ~30 G
// multiply-adds (10.1 G each for q.k^T, pos_q.pos_k^T and P.v): ~400 flop
// per byte, above the H100's ridge, so the call is compute bound. This core
// does the products as fp32 FMAs on the CUDA cores (no wgmma):
// each thread owns a 4x4 tile of scores and of outputs, which gives 16 FMAs
// per 8 shared-memory loads; row strides padded by one word keep the column
// reads free of bank conflicts. Its floor is the fp32 FMA rate (~67 TFLOP/s),
// about 1 ms a call; flash_fwd_sm90.cuh is the tensor-core version. The
// tile width DP is a template parameter, compiled at 32, 64, 80, 128, 192 and
// 256 (a head dim D runs on the smallest DP >= D, common.cuh::with_head_dim):
// a thread owns DP / 16 output columns of each of its rows; the staged
// columns past D are zeros and the stores skip them. Past DP 128 the tiles
// are 32 rows and 32 keys (Dims::BQ, BK; a thread then owns a 2 x 2 score
// tile): 64-row fp32 tiles of [q|pos_q], [k|pos_k] and v would not fit a
// block's shared memory (345 KB at 256; 168 KB at 32 rows). ptxas (CUDA
// 12.8): 64 to 80 registers there, 32 bytes of spill in K3's instance at 256.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mk {
namespace flash_fwd {

constexpr int NT = 256;        // threads: 16 x 16, each an RI x CJ score tile
constexpr float NEG = -1e9f;

// The tiles and the shared-memory layout at tile width DP.
template <int DP>
struct Dims {
  static_assert(DP % 16 == 0, "a thread owns DP / 16 columns");
  static constexpr int BQ = DP <= 128 ? 64 : 32;  // query rows per block
  static constexpr int BK = BQ;                    // keys per tile
  static constexpr int RI = BQ / 16, CJ = BK / 16;  // a thread's rows ty + 16 i, keys tx + 16 j
  static constexpr int PS = BK + 1;  // shared row strides, +1 word against bank conflicts
  static constexpr int D2 = 2 * DP;  // depth of [q|pos_q]
  static constexpr int QS = D2 + 1;
  static constexpr int VS = DP + 1;
  static constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS + BQ * PS;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
};

// Rows [q0, q0 + BQ) of q | pos_q [*, D], widened to fp32, into qs [BQ][QS];
// zeros past Tq and in the columns D .. DP - 1. qb and pqb point at the
// (b, h) stream.
template <int DP, typename T>
__device__ __forceinline__ void stage_q(float* qs, const T* __restrict__ qb,
                                        const T* __restrict__ pqb, int q0, int Tq, int D) {
  constexpr int QS = Dims<DP>::QS;
  for (int i = threadIdx.x; i < Dims<DP>::BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP, t = q0 + r;
    float a = 0.f, p = 0.f;
    if (t < Tq && c < D) {
      a = to_f(qb[(long long)t * D + c]);
      p = to_f(pqb[(long long)t * D + c]);
    }
    qs[r * QS + c] = a;
    qs[r * QS + DP + c] = p;
  }
}

// Keys [k0, k0 + BK) of k | pos_k into ks [BK][QS] and, with kV, of v into
// vs [BK][VS]; zeros past S and in the columns D .. DP - 1.
template <int DP, typename T, bool kV>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* __restrict__ kb,
                                         const T* __restrict__ pkb, const T* __restrict__ vb,
                                         int k0, int S, int D) {
  constexpr int QS = Dims<DP>::QS, VS = Dims<DP>::VS;
  for (int i = threadIdx.x; i < Dims<DP>::BK * DP; i += NT) {
    const int r = i / DP, c = i % DP, s = k0 + r;
    float a = 0.f, p = 0.f, w = 0.f;
    if (s < S && c < D) {
      a = to_f(kb[(long long)s * D + c]);
      p = to_f(pkb[(long long)s * D + c]);
      if (kV) w = to_f(vb[(long long)s * D + c]);
    }
    ks[r * QS + c] = a;
    ks[r * QS + DP + c] = p;
    if (kV) vs[r * VS + c] = w;
  }
}

// acc[i][j] = sum over d < N of a[(ty + 16 i) * AS + d] * b[(tx + 16 j) * BS + d]
// in fp32: one sequential chain of FMAs, or with kSplit (past DP 128, N of 256
// and more) four interleaved chains (d % 4) added pairwise at the end, which
// keep a deep dot's rounding nearer cuBLAS's blocked sums (one 512-deep chain
// put K4's fp32 dv 1.2e-5 of max|dv| from plain on an H100).
template <int R, int C, int N, int AS, int BS, bool kSplit>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int tx, int ty,
                                         float (&acc)[R][C]) {
  constexpr int P = kSplit ? 4 : 1;
  static_assert(N % P == 0, "whole groups of the interleaved chains");
  float part[P][R][C];
#pragma unroll
  for (int u = 0; u < P; ++u)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) part[u][i][j] = 0.f;
#pragma unroll (4 / P)
  for (int d0 = 0; d0 < N; d0 += P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int d = d0 + u;
      float x[R], y[C];
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = a[(ty + 16 * i) * AS + d];
#pragma unroll
      for (int j = 0; j < C; ++j) y[j] = b[(tx + 16 * j) * BS + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) part[u][i][j] = fmaf(x[i], y[j], part[u][i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      acc[i][j] = kSplit ? (part[0][i][j] + part[1 % P][i][j]) +
                               (part[2 % P][i][j] + part[3 % P][i][j])
                         : part[0][i][j];
}

// sc[i][j] = [q|pos_q][ty + 16 i] . [k|pos_k][tx + 16 j], one 2 DP-deep fp32 dot.
template <int DP>
__device__ __forceinline__ void score_tile(const float* qs, const float* ks, int tx, int ty,
                                           float (&sc)[Dims<DP>::RI][Dims<DP>::CJ]) {
  constexpr int QS = Dims<DP>::QS;
  tile_dot<Dims<DP>::RI, Dims<DP>::CJ, Dims<DP>::D2, QS, QS, (DP > 128)>(qs, ks, tx, ty, sc);
}

// acc[i][j] += sum_c ps[ty + 16 i][c] . vs[c][tx + 16 j] over the BK keys of a tile.
template <int DP>
__device__ __forceinline__ void pv_tile(const float* ps, const float* vs, int tx, int ty,
                                        float (&acc)[Dims<DP>::RI][DP / 16]) {
  constexpr int VS = Dims<DP>::VS, PS = Dims<DP>::PS, RI = Dims<DP>::RI;
#pragma unroll 4
  for (int c = 0; c < Dims<DP>::BK; ++c) {
    float p[RI], w[DP / 16];
#pragma unroll
    for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) w[j] = vs[c * VS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
  }
}

template <int DP, typename T, bool kLse>
__global__ void __launch_bounds__(NT) kernel(
    const T* __restrict__ q, const T* __restrict__ pq, const T* __restrict__ k,
    const T* __restrict__ pk, const T* __restrict__ v, const T* __restrict__ rel,
    const uint8_t* __restrict__ kpad, T* __restrict__ out, float* __restrict__ lse, int H,
    int Tq, int S, long long rel_hs, long long rel_rs, int causal, int skip_max, int D) {
  using Dm = Dims<DP>;
  constexpr int QS = Dm::QS, VS = Dm::VS, PS = Dm::PS, BQ = Dm::BQ, BK = Dm::BK;
  constexpr int RI = Dm::RI, CJ = Dm::CJ;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][QS]  q | pos_q
  float* ks = qs + BQ * QS;    // [BK][QS]  k | pos_k
  float* vs = ks + BK * QS;    // [BK][VS]
  float* ps = vs + BK * VS;    // [BQ][PS]  probabilities, rounded to T

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, columns tx + 16 j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * Tq * D;
  const T* pqb = pq + bh * Tq * D;
  const T* kb = k + bh * S * D;
  const T* pkb = pk + bh * S * D;
  const T* vb = v + bh * S * D;
  const uint8_t* kp = kpad + (long long)b * S;
  const T* relh = rel ? rel + h * rel_hs : nullptr;

  stage_q<DP>(qs, qb, pqb, q0, Tq, D);

  float m[RI], l[RI], acc[RI][DP / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = skip_max ? 0.f : -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    stage_kv<DP, T, true>(ks, vs, kb, pkb, vb, k0, S, D);
    __syncthreads();

    float sc[RI][CJ];
    score_tile<DP>(qs, ks, tx, ty, sc);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, t = q0 + r;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int s = k0 + tx + 16 * j;
        float w = -CUDART_INF_F;  // past the end: no part of the softmax
        if (s < S) {
          w = sc[i][j];
          if (relh && t < Tq) w += to_f(relh[t * rel_rs + s]);
          if (causal && s > t) w = NEG;
          if (kp[s]) w = NEG;
        }
        sc[i][j] = w;
        tmax = fmaxf(tmax, w);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = skip_max ? 0.f : fmaxf(m[i], tmax);
      const float scale = skip_max ? 1.f : expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float e = expf(sc[i][j] - mnew);
        rs += e;  // the denominator sums the unrounded e, as the TPU kernel does
        ps[r * PS + tx + 16 * j] = round_to<T>(e);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * scale + rs;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] *= scale;
    }
    __syncthreads();  // ps complete

    pv_tile<DP>(ps, vs, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = skip_max ? fmaxf(l[i], 1e-38f) : l[i];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      if (tx + 16 * j < D) out[(bh * Tq + t) * D + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
    if (kLse && tx == 0) lse[bh * Tq + t] = skip_max ? logf(denom) : m[i] + logf(denom);
  }
}

// Launches the kernel on `stream`; returns cudaGetLastError().
template <int DP, typename T, bool kLse>
int launch(const void* q, const void* pq, const void* k, const void* pk, const void* v,
           const void* rel, const void* kpad, void* out, float* lse, int B, int H, int Tq,
           int S, long long rel_hs, long long rel_rs, int causal, int skip_max, int D,
           cudaStream_t stream) {
  constexpr size_t smem = Dims<DP>::SMEM_BYTES;
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)kernel<DP, T, kLse>, smem)) return err;
  const dim3 grid((Tq + Dims<DP>::BQ - 1) / Dims<DP>::BQ, H, B);
  kernel<DP, T, kLse><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pq), static_cast<const T*>(k),
      static_cast<const T*>(pk), static_cast<const T*>(v), static_cast<const T*>(rel),
      static_cast<const uint8_t*>(kpad), static_cast<T*>(out), lse, H, Tq, S, rel_hs, rel_rs,
      causal, skip_max, D);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd
}  // namespace mk
