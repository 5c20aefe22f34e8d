// K3 and K4: the training forward (with logsumexp) and the fused backward of
// attention with decomposed positional bias, for sm_90a. The dtype alone
// picks the core: bf16 runs on Hopper's tensor cores (K3 on the core of
// flash_fwd_sm90.cuh, K4 on flash_bwd_sm90.cuh's two launches), fp32 on the
// FMA kernels below and in flash_fwd.cuh, which keep full fp32 products.
// K3's entry point, mk_flash_attention_fwd, is in flash_attention_infer.cu
// beside K1's, whose kernels it launches (one compile of each instance).
//
// K3 replaces musketeer_tpu/ops/flash_attention_bwd.py::_fwd (_fwd_kernel;
// pallas_call at :265). It is K1's kernel with the per-row
//   lse = m + log(l)      (log(max(l, 1e-38)) under skip_max)
// written in fp32 beside the output.
//
// K4 replaces musketeer_tpu/ops/flash_attention_bwd.py::_bwd
// (_bwd_kernel_fused; pallas_call at :388). With P rebuilt from lse,
//   P  = exp(w - lse),   w = [q|pos_q].[k|pos_k]^T + rel + masks
//   dW = P o (dO.v^T - rowsum(dO o O))
//   [dq|dpos_q] = dW.[k|pos_k]      [dk|dpos_k] = dW^T.[q|pos_q]
//   dv = P^T.dO                      drel = sum_b dW
// The fp32 kernels below do everything in fp32 (P is not rounded, as on the
// TPU) and round each output once; drel comes out in fp32. The bf16 launches
// round P and dW to bf16 as the products' operands (flash_bwd_sm90.cuh).
//
// Translation. On the TPU one kernel carries dk/dv/dpos_k across its
// sequential q-tile grid axis and sums drel over an in-cell batch loop. An
// H100 runs blocks in no order and carries nothing between them, so the
// backward is three launches, each of which writes every output element
// exactly once (deterministic, no atomics):
//   1. dsum: rowsum(dO o O) per query row (one warp a row);
//   2. key-major: one block per (b, h, 64-key tile) loops over the q tiles
//      and writes dk, dpos_k and dv;
//   3. query-major: one block per (h, 64-row q tile) loops over the batch
//      and the key tiles and writes dq, dpos_q per batch row and the drel
//      tile summed over the batch in order; without drel (cross attention)
//      the batch is a grid axis.
// P and dW are recomputed in both 2 and 3: that costs a second 128-deep score
// dot and a 64-deep dO.v^T dot over every tile, in return for no carried
// state and no atomics. Causally masked tiles are not skipped: on a row whose
// every key is masked the saved lse rounds to -1e9 in fp32, so P = 1 on all
// of its columns, as in the TPU kernel, and those columns carry gradient.
//
// Bound. At the encoder train shape (B4 H12 T=S=980 D64) the key-major
// launch does 17.7 G fp32 multiply-adds (384-deep per score: 128 + 64 to
// rebuild P and dW, 64 for dv, 128 for [dk|dpos_k]) and the query-major one
// 14.8 G (320-deep), against ~50 MB of streams, the 23 MB rel and a 46 MB
// fp32 drel read-modify-write per batch row: ~0.4 GB in all, so the fp32
// call is bound by the CUDA cores' fp32 FMA rate (~67 TFLOP/s).
// Each thread owns a 4x4 tile of P/dW and a 4 x (2 D / 16) (or 4 x D / 16)
// tile of its gradient accumulators; shared row strides are padded by one
// word against bank conflicts. The tile width DP is a template parameter,
// compiled at 32, 64, 80, 128, 192 and 256 on either core (a head dim D runs
// on the smallest DP >= D, common.cuh::with_head_dim): the staged columns
// past D are zeros and no gradient column past D is stored. Past DP 128 the
// tiles are 32 queries and 32 keys, as flash_fwd.cuh's (a thread's tiles
// 2 x 2 and 2 x (2 D / 16)): the 64-row layout would need 428 KB at 256, the
// 32-row one 206 KB (117 / 119 registers at 192, 170 / 180 at 256, no spills).
#include "flash_bwd_sm90.cuh"
#include "flash_deep.cuh"
#include "flash_fwd.cuh"

namespace {

using mk::to_f;

constexpr int NT = mk::flash_fwd::NT;  // 16 x 16 threads
constexpr float NEG = mk::flash_fwd::NEG;

// The fp32 kernels' tiles and shared-memory layout at tile width DP (231,424
// bytes at 128; 205,824 at 256).
template <int DP>
struct Bwd {
  static constexpr int BQ = mk::flash_fwd::Dims<DP>::BQ;  // query rows per tile
  static constexpr int BK = mk::flash_fwd::Dims<DP>::BK;  // keys per tile
  static constexpr int R = BQ / 16;  // a thread's rows (and keys) ty + 16 i, tx + 16 j
  static constexpr int PS = BK + 1;
  static constexpr int D2 = 2 * DP, QS = D2 + 1, VS = DP + 1;
  static constexpr int KV_SMEM_FLOATS =
      BK * QS + BK * VS + BQ * QS + BQ * VS + 2 * BQ * PS + 2 * BQ;
  static constexpr int Q_SMEM_FLOATS = BQ * QS + BQ * VS + BK * QS + BK * VS + BQ * PS + 2 * BQ;
};

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32; one warp per row, the
// columns lane, lane + 32, ... of each row a lane.
template <typename T>
__global__ void __launch_bounds__(256) dsum_kernel(const T* __restrict__ o,
                                                   const T* __restrict__ dout,
                                                   float* __restrict__ delta, long long rows,
                                                   int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const T* op = o + row * D;
  const T* gp = dout + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(gp[c]) * to_f(op[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Rows [r0, r0 + BQ) of a [rows, D] stream pair (x | y) into a shared
// [BQ][QS] tile, zeros past `rows` and in the columns D .. DP - 1.
template <int DP, typename T>
__device__ __forceinline__ void load_pair(float* dst, const T* x, const T* y, int r0, int rows,
                                          int D) {
  constexpr int QS = Bwd<DP>::QS;
  for (int i = threadIdx.x; i < Bwd<DP>::BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP, t = r0 + r;
    float a = 0.f, p = 0.f;
    if (t < rows && c < D) {
      a = to_f(x[(long long)t * D + c]);
      p = to_f(y[(long long)t * D + c]);
    }
    dst[r * QS + c] = a;
    dst[r * QS + DP + c] = p;
  }
}

// Rows [r0, r0 + BQ) of a [rows, D] stream into a shared [BQ][VS] tile.
template <int DP, typename T>
__device__ __forceinline__ void load_one(float* dst, const T* x, int r0, int rows, int D) {
  constexpr int VS = Bwd<DP>::VS;
  for (int i = threadIdx.x; i < Bwd<DP>::BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP, t = r0 + r;
    dst[r * VS + c] = t < rows && c < D ? to_f(x[(long long)t * D + c]) : 0.f;
  }
}

// For the thread's R x R entries (query row q0 + ty + 16i, key k0 + tx + 16j)
// of one (q tile, key tile) pair: P = exp(w - lse) and dW = P (dP - delta),
// with P = 0 past the ends of the query rows and the keys.
template <int DP, typename T>
__device__ __forceinline__ void probs_and_dw(
    const float* qs, const float* ks, const float* dos, const float* vs, const float* lse_s,
    const float* dl_s, const T* relh, long long rel_rs, const uint8_t* kp, int q0, int k0,
    int Tq, int S, int causal, float (&p)[Bwd<DP>::R][Bwd<DP>::R],
    float (&dw)[Bwd<DP>::R][Bwd<DP>::R]) {
  constexpr int D2 = Bwd<DP>::D2, QS = Bwd<DP>::QS, VS = Bwd<DP>::VS, R = Bwd<DP>::R;
  constexpr bool kSplit = DP > 128;  // interleaved partial chains (flash_fwd.cuh::tile_dot)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[R][R], dp[R][R];
  mk::flash_fwd::tile_dot<R, R, D2, QS, QS, kSplit>(qs, ks, tx, ty, sc);
  mk::flash_fwd::tile_dot<R, R, DP, VS, VS, kSplit>(dos, vs, tx, ty, dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = k0 + tx + 16 * j;
      float pv = 0.f;
      if (t < Tq && s < S) {
        float w = sc[i][j];
        if (relh) w += to_f(relh[t * rel_rs + s]);
        if (causal && s > t) w = NEG;
        if (kp[s]) w = NEG;
        pv = expf(w - lse_s[r]);
      }
      p[i][j] = pv;
      dw[i][j] = pv * (dp[i][j] - dl_s[r]);
    }
  }
}

// dk, dpos_k, dv for one (b, h, BK-key tile).
template <int DP, typename T>
__global__ void __launch_bounds__(NT) bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ pq, const T* __restrict__ k,
    const T* __restrict__ pk, const T* __restrict__ v, const T* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dpk,
    T* __restrict__ dv, int H, int Tq, int S, long long rel_hs, long long rel_rs, int causal,
    int D) {
  constexpr int QS = Bwd<DP>::QS, VS = Bwd<DP>::VS, NC = DP / 16;  // NC: columns a thread owns
  constexpr int BQ = Bwd<DP>::BQ, BK = Bwd<DP>::BK, R = Bwd<DP>::R, PS = Bwd<DP>::PS;
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][QS]  k | pos_k of this block's keys
  float* vs = ks + BK * QS;     // [BK][VS]
  float* qs = vs + BK * VS;     // [BQ][QS]  q | pos_q of the current q tile
  float* dos = qs + BQ * QS;    // [BQ][VS]  dO
  float* ps = dos + BQ * VS;    // [BQ][PS]  P
  float* ws = ps + BQ * PS;     // [BQ][PS]  dW
  float* lse_s = ws + BQ * PS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const T* relh = rel ? rel + h * rel_hs : nullptr;
  const uint8_t* kp = kpad + (long long)b * S;
  load_pair<DP>(ks, k + bh * S * D, pk + bh * S * D, k0, S, D);
  load_one<DP>(vs, v + bh * S * D, k0, S, D);

  float adk[R][2 * NC], adv[R][NC];  // key rows ty + 16i; columns tx + 16c
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) adk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) adv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous q tile's shared reads are done
    load_pair<DP>(qs, q + bh * Tq * D, pq + bh * Tq * D, q0, Tq, D);
    load_one<DP>(dos, dout + bh * Tq * D, q0, Tq, D);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int t = q0 + i;
      lse_s[i] = t < Tq ? lse[bh * Tq + t] : 0.f;
      dl_s[i] = t < Tq ? delta[bh * Tq + t] : 0.f;
    }
    __syncthreads();

    float p[R][R], dw[R][R];
    probs_and_dw<DP>(qs, ks, dos, vs, lse_s, dl_s, relh, rel_rs, kp, q0, k0, Tq, S, causal, p, dw);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
        ws[(ty + 16 * i) * PS + tx + 16 * j] = dw[i][j];
      }
    __syncthreads();

    // dv[key] += sum_r P[r][key] dO[r];  [dk|dpos_k][key] += sum_r dW[r][key] [q|pos_q][r]
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pa[R], wa[R], g[NC], x[2 * NC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pa[i] = ps[r * PS + ty + 16 * i];
        wa[i] = ws[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) g[c] = dos[r * VS + tx + 16 * c];
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) x[c] = qs[r * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) adv[i][c] = fmaf(pa[i], g[c], adv[i][c]);
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) adk[i][c] = fmaf(wa[i], x[c], adk[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = (bh * S + s) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (tx + 16 * c >= D) continue;
      dk[row + tx + 16 * c] = mk::from_f<T>(adk[i][c]);
      dpk[row + tx + 16 * c] = mk::from_f<T>(adk[i][c + NC]);
      dv[row + tx + 16 * c] = mk::from_f<T>(adv[i][c]);
    }
  }
}

// dq, dpos_q (and the drel tile) for one (h, BQ-row q tile) over batch rows
// [b0, b1): all of them when drel is wanted, else blockIdx.z alone.
template <int DP, typename T>
__global__ void __launch_bounds__(NT) bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ pq, const T* __restrict__ k,
    const T* __restrict__ pk, const T* __restrict__ v, const T* __restrict__ rel,
    const uint8_t* __restrict__ kpad, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dpq,
    float* __restrict__ drel, int B, int H, int Tq, int S, long long rel_hs, long long rel_rs,
    int causal, int D) {
  constexpr int QS = Bwd<DP>::QS, VS = Bwd<DP>::VS, NC = DP / 16;  // NC: columns a thread owns
  constexpr int BQ = Bwd<DP>::BQ, BK = Bwd<DP>::BK, R = Bwd<DP>::R, PS = Bwd<DP>::PS;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][QS]  q | pos_q of this block's rows
  float* dos = qs + BQ * QS;    // [BQ][VS]
  float* ks = dos + BQ * VS;    // [BK][QS]  k | pos_k of the current key tile
  float* vs = ks + BK * QS;     // [BK][VS]
  float* ws = vs + BK * VS;     // [BQ][PS]  dW
  float* lse_s = ws + BQ * PS;  // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b0 = drel ? 0 : blockIdx.z, b1 = drel ? B : b0 + 1;
  const T* relh = rel ? rel + h * rel_hs : nullptr;

  for (int b = b0; b < b1; ++b) {
    const long long bh = (long long)b * H + h;
    const uint8_t* kp = kpad + (long long)b * S;
    __syncthreads();  // the previous batch row's shared reads are done
    load_pair<DP>(qs, q + bh * Tq * D, pq + bh * Tq * D, q0, Tq, D);
    load_one<DP>(dos, dout + bh * Tq * D, q0, Tq, D);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int t = q0 + i;
      lse_s[i] = t < Tq ? lse[bh * Tq + t] : 0.f;
      dl_s[i] = t < Tq ? delta[bh * Tq + t] : 0.f;
    }

    float adq[R][2 * NC];  // query rows ty + 16i; [dq|dpos_q] columns tx + 16c
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) adq[i][c] = 0.f;

    for (int k0 = 0; k0 < S; k0 += BK) {
      __syncthreads();  // the previous key tile's shared reads are done
      load_pair<DP>(ks, k + bh * S * D, pk + bh * S * D, k0, S, D);
      load_one<DP>(vs, v + bh * S * D, k0, S, D);
      __syncthreads();

      float p[R][R], dw[R][R];
      probs_and_dw<DP>(qs, ks, dos, vs, lse_s, dl_s, relh, rel_rs, kp, q0, k0, Tq, S, causal, p,
                   dw);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int s = k0 + tx + 16 * j;
          ws[(ty + 16 * i) * PS + tx + 16 * j] = dw[i][j];
          // this block alone owns drel[h, q tile, :]: batch rows add in order
          if (drel && t < Tq && s < S) drel[((long long)h * Tq + t) * S + s] += dw[i][j];
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int j = 0; j < BK; ++j) {
        float wa[R], x[2 * NC];
#pragma unroll
        for (int i = 0; i < R; ++i) wa[i] = ws[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) x[c] = ks[j * QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < 2 * NC; ++c) adq[i][c] = fmaf(wa[i], x[c], adq[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= Tq) continue;
      const long long row = (bh * Tq + t) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (tx + 16 * c >= D) continue;
        dq[row + tx + 16 * c] = mk::from_f<T>(adq[i][c]);
        dpq[row + tx + 16 * c] = mk::from_f<T>(adq[i][c + NC]);
      }
    }
  }
}

// The dsum pre-pass of either core.
template <typename T>
int launch_dsum(const void* o, const void* dout, float* delta, int B, int H, int Tq, int D,
                cudaStream_t stream) {
  const long long rows = (long long)B * H * Tq;
  dsum_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return (int)cudaGetLastError();
}

// The fp32 launches: dsum, key-major, query-major.
template <int DP, typename T>
int launch_bwd(const void* q, const void* pq, const void* k, const void* pk, const void* v,
               const void* rel, const void* kpad, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dpq, void* dk, void* dpk,
               void* dv, float* drel, int B, int H, int Tq, int S, long long rel_hs,
               long long rel_rs, int causal, int D, cudaStream_t stream) {
  const size_t kv_smem = Bwd<DP>::KV_SMEM_FLOATS * sizeof(float);
  const size_t q_smem = Bwd<DP>::Q_SMEM_FLOATS * sizeof(float);
  static mk::SmemOptIn kv_opt_in, q_opt_in;
  if (const int err = kv_opt_in.ensure((const void*)bwd_kv_kernel<DP, T>, kv_smem)) return err;
  if (const int err = q_opt_in.ensure((const void*)bwd_q_kernel<DP, T>, q_smem)) return err;
  if (const int err = launch_dsum<T>(o, dout, delta, B, H, Tq, D, stream)) return err;

  const T* qt = static_cast<const T*>(q);
  const T* pqt = static_cast<const T*>(pq);
  const T* kt = static_cast<const T*>(k);
  const T* pkt = static_cast<const T*>(pk);
  const T* vt = static_cast<const T*>(v);
  const T* relt = static_cast<const T*>(rel);
  const T* dot = static_cast<const T*>(dout);
  const uint8_t* kp = static_cast<const uint8_t*>(kpad);
  constexpr int BQ = Bwd<DP>::BQ, BK = Bwd<DP>::BK;
  bwd_kv_kernel<DP, T><<<dim3((S + BK - 1) / BK, H, B), NT, kv_smem, stream>>>(
      qt, pqt, kt, pkt, vt, relt, kp, dot, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dpk), static_cast<T*>(dv), H, Tq, S, rel_hs, rel_rs, causal, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  bwd_q_kernel<DP, T><<<dim3((Tq + BQ - 1) / BQ, H, drel ? 1 : B), NT, q_smem, stream>>>(
      qt, pqt, kt, pkt, vt, relt, kp, dot, lse, delta, static_cast<T*>(dq),
      static_cast<T*>(dpq), drel, B, H, Tq, S, rel_hs, rel_rs, causal, D);
  return (int)cudaGetLastError();
}

}  // namespace

// K4. Streams as K3's plus the forward output o, its cotangent dout and K3's
// lse; delta is fp32 scratch [B, H, Tq]. drel receives sum_b dW in fp32, or
// is null when rel needs no gradient: with fp32 streams a zeroed [H, Tq, S]
// buffer; with bf16 streams [B, H, Tq, S] scratch for the batch rows' dW,
// whose first [H, Tq, S] receives the sum. head_dim as K3's; past 256 the
// fp32 streams run on flash_deep.cuh's deep route, bf16 on
// flash_bwd_sm90.cuh's.
extern "C" int mk_flash_attention_bwd(int bf16, const void* q, const void* pos_q,
                                      const void* k, const void* pos_k, const void* v,
                                      const void* rel, const void* kpad, const void* o,
                                      const void* dout, const void* lse, void* delta, void* dq,
                                      void* dpos_q, void* dk, void* dpos_k, void* dv,
                                      void* drel, int B, int H, int Tq, int S,
                                      long long rel_head_stride, long long rel_row_stride,
                                      int causal, int head_dim, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  auto dr = static_cast<float*>(drel);
  const int D = head_dim;
  return mk::with_head_dim(head_dim, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    if (bf16) {
      if (const int err = launch_dsum<__nv_bfloat16>(o, dout, dl, B, H, Tq, D, st)) return err;
      return mk::sm90::launch_bwd_instance(DP, q, pos_q, k, pos_k, v, rel, kpad, dout, l, dl,
                                           dq, dpos_q, dk, dpos_k, dv, dr, B, H, Tq, S,
                                           rel_head_stride, rel_row_stride, causal, D, st);
    }
    if constexpr (DP == mk::DEEP) {
      if (const int err = launch_dsum<float>(o, dout, dl, B, H, Tq, D, st)) return err;
      return mk::flash_deep::launch_bwd(q, pos_q, k, pos_k, v, rel, kpad, dout, l, dl, dq,
                                        dpos_q, dk, dpos_k, dv, dr, B, H, Tq, S, rel_head_stride,
                                        rel_row_stride, causal, D, st);
    } else {
      return launch_bwd<DP, float>(q, pos_q, k, pos_k, v, rel, kpad, o, dout, l, dl, dq, dpos_q,
                                   dk, dpos_k, dv, dr, B, H, Tq, S, rel_head_stride,
                                   rel_row_stride, causal, D, st);
    }
  });
}
