// K7: all L decoder layers of one incremental decode step, for sm_90a.
//
// Replaces the Pallas kernel musketeer_tpu/ops/decode_stack.py::
// decode_stack_step (_kernel; pallas_call at :467). Per layer, on the step's
// hidden state x [rows, d] (rows = B samples x Kb beams):
//   self:  LN, x . [Wq|Wk|Wv] + b -> q, k_new, v_new; scores of q against
//          the cached prefix with position idx replaced by k_new (+ the fp32
//          bias row, later positions masked), softmax, . V (v_new at idx),
//          out-proj + bias + residual;
//   cross: LN, (x . Wq + b) * scaling; per sample its Kb beams against its
//          [S, D] K/V per head with the bias row (pads folded to -1e9),
//          softmax, . V, out-proj + bias + residual;
//   FFN:   LN, fc1 + bias, erf-gelu, fc2 + bias + residual.
// k_new and v_new of every layer are outputs; the caller writes them into
// the cache at idx. Numerics are the TPU kernel's: each product sums in fp32
// and is rounded to the compute dtype T before its bias and again after it;
// LayerNorm, softmax and the attention sums in fp32, the LayerNorm's output
// rounded to T before its product; probabilities rounded to T before each
// value product; gelu = round(round(h * 0.5) * round(erfc(round(-h *
// round(1/sqrt 2))))) with CUDA's erfcf in place of the TPU kernel's
// restated XLA expansion.
//
// Translation. The TPU kernel walks L as a sequential grid with x in VMEM
// scratch and streams each sample's cross K/V with manual DMAs from a
// transposed, S-padded copy of the cache. An H100 runs the blocks of one
// launch in no order, so the C entry points run, on one stream, a fixed
// sequence of 8 launches per layer, x living in the output buffer:
//   1 LN + q|k|v product   2 self-attention      3 out-proj + residual
//   4 LN + cross-q product 5 cross-attention     6 out-proj + residual
//   7 LN + fc1 + gelu      8 fc2 + residual
// Layer 0 reads x0 where later layers read x. The cross K/V are read in the
// cache's own [L, B, H, S, Dc] layout. The attention kernels' tile width DP
// is a template parameter, compiled at 32, 64, 80, 128, 192 and 256; a head
// dim D runs on the smallest DP >= D (common.cuh::with_head_dim). The hidden
// state keeps the model's head stride D (d = H D, a multiple of 8); the
// self and cross caches have rows of Dc, D rounded up to a multiple of 8
// (the wrapper's zero-padded copies where D is not one). Where d is not a
// multiple of 64, each product's last 64-deep chunk is zero-filled by TMA
// (the maps span the true d), its last 64-row tile is masked on store, and
// the LayerNorm's row statistics add ceil(d / 64) tiles. The
// self-attention keeps SA_CHUNK positions' scores a warp in shared memory
// (any Tmax); the cross-attention runs a sample's beams in tiles of 16 and,
// past the whole row's fit, its scores in chunks.
//
// bf16 (mk_decode_stack_step_sm90): the six products run on the
// weight-streaming tensor-core core (skinny_gemm_sm90.cuh: W tiles by TMA,
// wgmma with the beam rows as N, the LayerNorm applied to the staged X with
// one-pass row statistics that the product writing X hands on, split-K with
// the partials summed in split order by the last CTA of each tile; a split-K
// sum is still one fp32 sum rounded once), the
// cross-attention on decode_attn_sm90.cuh (K/V tiles by TMA, mma.sync), the
// self-attention on CUDA cores (self_attn_bf16: a lane per cached position;
// where D is not a multiple of 8, whose rows are then not 16-byte pieces,
// self_attn_kernel's element-wise walk).
// Every launch but the self-attention's uses programmatic stream
// serialization, so each product streams its first weight tiles while the
// previous launch finishes.
//
// fp32 (mk_decode_stack_step): the FMA route of the first port, kept for
// the exact fp32 checks (tensor cores would mean TF32). Its products are one
// small-M kernel: a block computes 32 rows x 64 columns of x . W^T, staging
// 32-deep chunks of both in shared memory, fp32 FMAs on the CUDA cores, 8
// rows per thread, the LayerNorm applied while its input is staged; the
// cross-attention is the device function K6's fp32 route uses
// (csrc/cross_attn.cuh).
//
// Bound. At the caption decode shape (rows 80 = 16 x 5, L 6, d 768, f 3072,
// Tmax 17, S 908, bf16) a step must read 99 MB of weights, 268 MB of cross
// K/V and up to 25 MB of self cache: 392 MB, 117 us at 3.35 TB/s; its 4.0 G
// multiply-adds in the products are ~8 us on the tensor cores. On an H100 the
// FMA route takes ~4.2 ms a step, the bf16 route ~0.8 ms: its 48 launches
// each spend ~12 us on fixed latency (PERF.md). At ofa_huge's shape (L12,
// d1280, f5120, H16, D80) a step must read ~553 MB of weights and ~893 MB of
// cross K/V: ~0.43 ms at 3.35 TB/s.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "cross_attn.cuh"
#include "decode_attn_sm90.cuh"
#include "skinny_gemm_sm90.cuh"

namespace {

using mk::from_f;
using mk::round_to;
using mk::to_f;
using bf16 = __nv_bfloat16;

constexpr int MT = 32;    // product rows per block
constexpr int NTL = 64;   // product columns per block
constexpr int KC = 32;    // depth chunk staged in shared memory
constexpr int GT = 256;   // threads: column tid % 64, rows 8 * (tid / 64) + 0..7
constexpr int RPT = 8;    // rows per thread
constexpr int SA_WARPS = 4;  // self-attention: (row, head) tasks per block
constexpr int SA_CHUNK = 2048;  // cached positions a warp's scores hold in shared memory
constexpr float NEG = -1e9f;

template <typename T>
__device__ __forceinline__ float gelu_exact(float h) {
  const float y = round_to<T>((-h) * round_to<T>(0.7071067811865476f));
  const float e = round_to<T>(erfcf(y));
  return round_to<T>(round_to<T>(h * 0.5f) * e);
}

// the epilogue of a product, per element (m, n), after the fp32 sum:
// v = round(sum); v = round(v + bias[n]); v = round(v * scale); v = gelu(v);
// v = round(residual[m, n] + v); out[n / seg][m, n % seg] = v
template <typename T>
struct Epi {
  const T* bias;      // [N] or nullptr
  float scale;        // 0: none (else already a value of T)
  int gelu;
  const T* residual;  // [M, seg] or nullptr (only with one segment); may be out[0]
  T* out[3];          // up to three column segments, each [M, seg]
  int seg;

  struct Pre {
    float bias, residual;
  };
  __device__ __forceinline__ Pre load(int m, int n) const {
    return {bias != nullptr ? to_f(bias[n]) : 0.f,
            residual != nullptr ? to_f(residual[(long long)m * seg + n]) : 0.f};
  }
  __device__ __forceinline__ float operator()(int m, int n, float acc, Pre p) const {
    float v = round_to<T>(acc);
    if (bias != nullptr) v = round_to<T>(v + p.bias);
    if (scale != 0.f) v = round_to<T>(v * scale);
    if (gelu) v = gelu_exact<T>(v);
    if (residual != nullptr) v = round_to<T>(p.residual + v);
    // the segment by comparison: an index into out[] would move the struct to local memory
    const int s = n < seg ? 0 : (n < 2 * seg ? 1 : 2);
    T* o = s == 0 ? out[0] : (s == 1 ? out[1] : out[2]);
    o[(long long)m * seg + n - s * seg] = from_f<T>(v);
    return v;
  }
  __device__ __forceinline__ float operator()(int m, int n, float acc) const {
    return (*this)(m, n, acc, load(m, n));
  }
};

template <typename T>
__global__ void __launch_bounds__(GT) gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
                                                  const float* __restrict__ ln_g,
                                                  const float* __restrict__ ln_b, Epi<T> epi, int M,
                                                  int N, int K) {
  __shared__ __align__(16) float as[MT][KC];
  __shared__ float ws[KC][NTL + 1];  // +1 word: conflict-free transposed stores
  __shared__ float mu[MT], rstd[MT];
  const int tid = threadIdx.x;
  const int c = tid % NTL, rg = tid / NTL;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * NTL;

  if (ln_g != nullptr) {  // fp32 LayerNorm statistics of this block's rows, eps 1e-5
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < MT; r += GT / 32) {
      const int m = m0 + r;
      float mean = 0.f, var = 0.f;
      if (m < M) {
        const T* x = A + (long long)m * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_f(x[k]);
        mean = mk::warp_sum(s) / K;
        float s2 = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float t = to_f(x[k]) - mean;
          s2 += t * t;
        }
        var = mk::warp_sum(s2) / K;
      }
      if (lane == 0) {
        mu[r] = mean;
        rstd[r] = rsqrtf(var + 1e-5f);
      }
    }
    __syncthreads();
  }

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < MT * KC; i += GT) {
      const int r = i / KC, kk = i % KC, m = m0 + r, k = k0 + kk;
      float a = 0.f;
      if (m < M && k < K) {
        a = to_f(A[(long long)m * K + k]);
        if (ln_g != nullptr) a = round_to<T>((a - mu[r]) * rstd[r] * ln_g[k] + ln_b[k]);
      }
      as[r][kk] = a;
    }
    for (int i = tid; i < NTL * KC; i += GT) {
      const int r = i / KC, kk = i % KC, n = n0 + r, k = k0 + kk;
      ws[kk][r] = (n < N && k < K) ? to_f(W[(long long)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      const float w0 = ws[kk][c], w1 = ws[kk + 1][c], w2 = ws[kk + 2][c], w3 = ws[kk + 3][c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(&as[rg * RPT + r][kk]);
        acc[r] = fmaf(av.x, w0, acc[r]);
        acc[r] = fmaf(av.y, w1, acc[r]);
        acc[r] = fmaf(av.z, w2, acc[r]);
        acc[r] = fmaf(av.w, w3, acc[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + c;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + rg * RPT + r;
    if (m >= M) break;
    epi(m, n, acc[r]);
  }
}

// Self-attention of one step: one warp per (row, head), the dims
// lane + 32 i < D per lane, element by element (any D, any alignment); the
// fp32 route's, and the bf16 route's where D is not a multiple of 8. The
// cache's rows are Dc apart. Only positions t <= idx are read: later ones
// are masked to -1e9 in the TPU kernel, whose exp is exactly 0 after the max
// subtraction. The first ch positions' scores stay in shared memory; those
// of later positions (idx >= ch) are computed again where they are needed.
template <int DP, typename T>
__global__ void __launch_bounds__(SA_WARPS * 32) self_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    const T* __restrict__ cache_k, const T* __restrict__ cache_v, const float* __restrict__ sbias,
    T* __restrict__ out, int rows, int H, int Tmax, int idx, float scaling, int D, int Dc,
    int ch) {
  constexpr int NE = (DP + 31) / 32;  // dims a lane may hold
  extern __shared__ float sa_scores[];  // [SA_WARPS][ch]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int task = blockIdx.x * SA_WARPS + warp;
  if (task >= rows * H) return;
  const int row = task / H, h = task % H, d = H * D;
  float* w = sa_scores + warp * ch;
  const long long qo = (long long)row * d + h * D;  // (row, head) in [rows, d]
  int c[NE];  // this lane's dims, or -1
  float qs[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    c[i] = lane + 32 * i < D ? lane + 32 * i : -1;
    qs[i] = c[i] < 0 ? 0.f : round_to<T>(to_f(q[qo + c[i]]) * scaling);
  }
  const long long co = ((long long)row * H + h) * Tmax;  // (row, head) in the cache
  const float* sb = sbias + co;
  auto score = [&](int t) {  // the warp's score of position t, in every lane
    const T* kt = t == idx ? k_new + qo : cache_k + (co + t) * Dc;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NE; ++i)
      if (c[i] >= 0) part += qs[i] * to_f(kt[c[i]]);
    return mk::warp_sum(part) + sb[t];
  };

  float m = -CUDART_INF_F;
  for (int t = 0; t <= idx; ++t) {
    const float s = score(t);
    if (lane == 0 && t < ch) w[t] = s;
    m = fmaxf(m, s);
  }
  __syncwarp();
  float l = 0.f;
  for (int t = 0; t <= idx; ++t) l += expf((t < ch ? w[t] : score(t)) - m);
  float a[NE] = {};
  for (int t = 0; t <= idx; ++t) {
    const float p = round_to<T>(expf((t < ch ? w[t] : score(t)) - m) / l);
    const T* vt = t == idx ? v_new + qo : cache_v + (co + t) * Dc;
#pragma unroll
    for (int i = 0; i < NE; ++i)
      if (c[i] >= 0) a[i] = fmaf(p, to_f(vt[c[i]]), a[i]);
  }
#pragma unroll
  for (int i = 0; i < NE; ++i)
    if (c[i] >= 0) out[qo + c[i]] = from_f<T>(a[i]);
}

// The bf16 route's self-attention of one step: one warp per (row, head),
// lane t on positions t, t + 32, ... <= idx (the full D-deep dot of q with
// that position's key, 16-byte loads), the softmax by warp reductions, then
// lane l on the value dim pairs 2 (l + 32 i) < D, summing the positions in
// order. Every lane's loads are independent of the others', so a warp waits
// on memory a few times, not once per position; numerics as
// self_attn_kernel's, the sums in another fp32 order. D (head_dim) a
// multiple of 8, the cache's rows D apart; kExact: D == DP, known to the
// compiler, which then loads a cached row unpredicated. The warp's shared
// memory holds ch positions: the scores of the first ch, then the
// probabilities of ch positions at a time; where idx >= ch the later
// positions' scores are computed again, in the sum's pass and in their chunk.
// Past DP 128 a lane's whole q and key row would be 1.5 DP registers: q
// (scaled and rounded, fp32) sits in the warp's shared memory after the
// scores (read as broadcasts), and the key row is taken 64 dims at a time
// into the same running sum, in the same order (ptxas: 48 to 52 registers,
// 4 to 12 bytes of spill at 256).
template <int DP, bool kExact>
__global__ void __launch_bounds__(SA_WARPS * 32) self_attn_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    const bf16* __restrict__ cache_k, const bf16* __restrict__ cache_v,
    const float* __restrict__ sbias, bf16* __restrict__ out, int rows, int H, int Tmax, int idx,
    float scaling, int head_dim, int ch) {
  const int D = kExact ? DP : head_dim;
  extern __shared__ float sa_scores[];  // [SA_WARPS][ch], then past DP 128 [SA_WARPS][DP] q
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int task = blockIdx.x * SA_WARPS + warp;
  if (task >= rows * H) return;
  const int row = task / H, h = task % H, d = H * D;
  float* w = sa_scores + warp * ch;
  const long long qo = (long long)row * d + h * D;  // (row, head) in [rows, d]
  const long long co = ((long long)row * H + h) * Tmax;  // (row, head) in the cache
  constexpr bool kWide = DP > 128;  // q in shared memory, the key row 64 dims at a time
  constexpr int KC = 64;               // past DP 128: the dims of a key row's chunk
  float qf[kWide ? 1 : DP];
  float* const qsh = sa_scores + SA_WARPS * ch + warp * DP;  // the warp's q past DP 128
  // q's 8 dims 8 i .. 8 i + 7, scaled and rounded, into qf or the warp's shared row
#pragma unroll
  for (int i = 0; i < (kWide ? 1 : DP / 8); ++i) {
    const int u8 = kWide ? lane : i;  // past DP 128 lane l stages unit l (DP / 8 <= 32)
    const uint4 v = u8 < DP / 8 && 8 * u8 < D ? *reinterpret_cast<const uint4*>(q + qo + 8 * u8)
                                               : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = round_to<bf16>(__uint_as_float(u[j] << 16) * scaling);
      const float hi = round_to<bf16>(__uint_as_float(u[j] & 0xffff0000u) * scaling);
      if constexpr (kWide) {
        if (u8 < DP / 8) {
          qsh[8 * u8 + 2 * j] = lo;
          qsh[8 * u8 + 2 * j + 1] = hi;
        }
      } else {
        qf[8 * i + 2 * j] = lo;
        qf[8 * i + 2 * j + 1] = hi;
      }
    }
  }
  if constexpr (kWide) __syncwarp();
  auto score = [&](int t) {  // this lane's score of position t
    const bf16* kt = t == idx ? k_new + qo : cache_k + (co + t) * D;
    float s = 0.f;
    if constexpr (!kWide) {
      uint4 kv[DP / 8];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
        kv[i] = 8 * i < D ? *reinterpret_cast<const uint4*>(kt + 8 * i)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const uint32_t u[4] = {kv[i].x, kv[i].y, kv[i].z, kv[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s = fmaf(qf[8 * i + 2 * j], __uint_as_float(u[j] << 16), s);
          s = fmaf(qf[8 * i + 2 * j + 1], __uint_as_float(u[j] & 0xffff0000u), s);
        }
      }
    } else {
#pragma unroll 1
      for (int c0 = 0; c0 < DP; c0 += KC) {
        uint4 kv[KC / 8];
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
          kv[i] = c0 + 8 * i < D ? *reinterpret_cast<const uint4*>(kt + c0 + 8 * i)
                                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < KC / 8; ++i) {
          const uint32_t u[4] = {kv[i].x, kv[i].y, kv[i].z, kv[i].w};
          const float4* qv = reinterpret_cast<const float4*>(qsh + c0 + 8 * i);
          const float4 qa = qv[0], qb = qv[1];
          const float qq[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s = fmaf(qq[2 * j], __uint_as_float(u[j] << 16), s);
            s = fmaf(qq[2 * j + 1], __uint_as_float(u[j] & 0xffff0000u), s);
          }
        }
      }
    }
    return s + sbias[co + t];
  };
  float m = -CUDART_INF_F;
  for (int t = lane; t <= idx; t += 32) {
    const float s = score(t);
    if (t < ch) w[t] = s;
    m = fmaxf(m, s);
  }
  m = mk::warp_max(m);
  float l = 0.f;
  for (int t = lane; t <= idx; t += 32) l += expf((t < ch ? w[t] : score(t)) - m);
  l = mk::warp_sum(l);
  constexpr int NP = (DP / 2 + 31) / 32;  // dim pairs a lane may hold
  float a0[NP] = {}, a1[NP] = {};
  for (int c0 = 0; c0 <= idx; c0 += ch) {  // positions c0 .. c1 - 1
    const int c1 = min(idx + 1, c0 + ch);
    __syncwarp();
    for (int t = c0 + lane; t < c1; t += 32)
      w[t - c0] = round_to<bf16>(expf((c0 == 0 ? w[t] : score(t)) - m) / l);
    __syncwarp();
#pragma unroll 4
    for (int t = c0; t < c1; ++t) {
      const bf16* vt = t == idx ? v_new + qo : cache_v + (co + t) * D;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int c = 2 * (lane + 32 * i);
        if (c >= D) continue;
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(vt + c);
        a0[i] = fmaf(w[t - c0], __low2float(v), a0[i]);
        a1[i] = fmaf(w[t - c0], __high2float(v), a1[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = 2 * (lane + 32 * i);
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(out + qo + c) = __floats2bfloat162_rn(a0[i], a1[i]);
  }
}

template <typename T>
int gemm(const T* A, const T* W, const float* ln_g, const float* ln_b, Epi<T> epi, int M, int N,
         int K, cudaStream_t st) {
  const dim3 grid((M + MT - 1) / MT, (N + NTL - 1) / NTL);
  gemm_kernel<T><<<grid, GT, 0, st>>>(A, W, ln_g, ln_b, epi, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
Epi<T> epi_of(const T* bias, T* out, int seg, const T* residual = nullptr, float scale = 0.f,
              int gelu = 0) {
  Epi<T> e;
  e.bias = bias;
  e.scale = scale;
  e.gelu = gelu;
  e.residual = residual;
  e.out[0] = out;
  e.out[1] = e.out[2] = nullptr;
  e.seg = seg;
  return e;
}

struct Pack {
  const void *w_self3, *b_self3, *w_so, *w_cq, *w_co, *w_fc1, *b_fc1, *w_fc2, *b_misc;
  const float* ln;
};

#define MK_TRY(call)                 \
  do {                               \
    const int err_ = (call);         \
    if (err_ != 0) return err_;      \
  } while (0)

template <int DP, typename T>
int step(const Pack& pk, const T* x0, const float* sbias, const float* cbias, const T* self_k,
         const T* self_v, const T* cross_k, const T* cross_v, T* x, T* k_new, T* v_new,
         T* scratch, int L, int B, int Kb, int H, int S, int Tmax, int f, int idx, float scaling,
         int D, int cross_chunk, cudaStream_t st) {
  namespace ca = mk::cross_attn;
  const int d = H * D, rows = B * Kb, Dc = (D + 7) / 8 * 8;
  const int ch = Tmax < SA_CHUNK ? Tmax : SA_CHUNK;  // the self-attention's positions a chunk
  const size_t sa_smem = sizeof(float) * SA_WARPS * ch;
  T* qbuf = scratch;         // [rows, d] self q (unscaled)
  T* attn = qbuf + rows * d;  // [rows, d] attention output, head-major columns
  T* q2 = attn + rows * d;    // [rows, d] cross q (scaled)
  T* g = q2 + rows * d;       // [rows, f] gelu(fc1)
  MK_TRY((int)cudaMemcpyAsync(x, x0, sizeof(T) * rows * d, cudaMemcpyDeviceToDevice, st));
  for (int l = 0; l < L; ++l) {
    const float* ln = pk.ln + (long long)l * 6 * d;
    const T* bm = static_cast<const T*>(pk.b_misc) + (long long)l * 4 * d;
    const T* w_dd = nullptr;
    T* kn = k_new + (long long)l * rows * d;
    T* vn = v_new + (long long)l * rows * d;
    // 1. LN + q|k|v: columns [0, d) -> qbuf, [d, 2d) -> k_new[l], [2d, 3d) -> v_new[l]
    Epi<T> e = epi_of<T>(static_cast<const T*>(pk.b_self3) + (long long)l * 3 * d, qbuf, d);
    e.out[1] = kn;
    e.out[2] = vn;
    MK_TRY(gemm<T>(x, static_cast<const T*>(pk.w_self3) + (long long)l * 3 * d * d, ln, ln + d, e,
                   rows, 3 * d, d, st));
    // 2. self-attention over the cache
    const long long cl = (long long)l * rows * H * Tmax;
    self_attn_kernel<DP, T><<<(rows * H + SA_WARPS - 1) / SA_WARPS, SA_WARPS * 32, sa_smem, st>>>(
        qbuf, kn, vn, self_k + cl * Dc, self_v + cl * Dc, sbias + cl, attn, rows, H, Tmax, idx,
        scaling, D, Dc, ch);
    MK_TRY((int)cudaGetLastError());
    // 3. out-proj + bias + residual
    w_dd = static_cast<const T*>(pk.w_so) + (long long)l * d * d;
    MK_TRY(gemm<T>(attn, w_dd, nullptr, nullptr, epi_of<T>(bm, x, d, x), rows, d, d, st));
    // 4. LN + cross q, scaled
    w_dd = static_cast<const T*>(pk.w_cq) + (long long)l * d * d;
    MK_TRY(gemm<T>(x, w_dd, ln + 2 * d, ln + 3 * d, epi_of<T>(bm + d, q2, d, nullptr, scaling),
                   rows, d, d, st));
    // 5. beam-shared cross-attention over this layer's [B, H, S, D] K/V
    ca::Args a;
    a.q = q2;
    a.k = cross_k + (long long)l * B * H * S * Dc;
    a.v = cross_v + (long long)l * B * H * S * Dc;
    a.k_scale = a.v_scale = nullptr;
    a.bias = cbias;
    a.pad = nullptr;
    a.out = attn;
    a.H = H;
    a.Kb = Kb;
    a.S = S;
    a.D = D;
    a.kv_rs = Dc;
    a.chunk = cross_chunk;
    a.q_bs = (long long)Kb * d;  // row b * Kb + j, column h * D + dd
    a.q_hs = D;
    a.q_js = d;
    a.bias_bs = (long long)H * S;
    a.bias_hs = S;
    MK_TRY((ca::launch<DP, T, T, false>(a, B, st)));
    // 6. out-proj + bias + residual
    w_dd = static_cast<const T*>(pk.w_co) + (long long)l * d * d;
    MK_TRY(gemm<T>(attn, w_dd, nullptr, nullptr, epi_of<T>(bm + 2 * d, x, d, x), rows, d, d, st));
    // 7. LN + fc1 + bias + gelu
    MK_TRY(gemm<T>(x, static_cast<const T*>(pk.w_fc1) + (long long)l * f * d, ln + 4 * d,
                   ln + 5 * d,
                   epi_of<T>(static_cast<const T*>(pk.b_fc1) + (long long)l * f, g, f, nullptr,
                             0.f, 1),
                   rows, f, d, st));
    // 8. fc2 + bias + residual
    MK_TRY(gemm<T>(g, static_cast<const T*>(pk.w_fc2) + (long long)l * d * f, nullptr, nullptr,
                   epi_of<T>(bm + 3 * d, x, d, x), rows, d, f, st));
  }
  return 0;
}

// Each 64-column tile's sum and sum of squares of every row of x [rows, K]
// bf16, in the layout gemm_kernel's stats_out writes: [K / 64][rows][2]. One
// warp per (row, tile), two columns a lane: for the first LayerNorm of a
// step, whose input no product of the step wrote.
__global__ void __launch_bounds__(128) row_tile_stats(const bf16* __restrict__ x, int rows, int K,
                                                      float* __restrict__ stats) {
  mk::sm90::launch_dependents();
  const int tiles = (K + mk::skinny::BM - 1) / mk::skinny::BM;
  const int task = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (task >= rows * tiles) return;
  const int row = task / tiles, t = task % tiles, k = t * mk::skinny::BM + 2 * lane;
  float s = 0.f, s2 = 0.f;
  if (k < K) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * K + k);
    const float a = __low2float(v), b = __high2float(v);
    s = a + b;
    s2 = a * a + b * b;
  }
  s = mk::warp_sum(s);
  s2 = mk::warp_sum(s2);
  if (lane == 0)
    *reinterpret_cast<float2*>(stats + 2 * ((long long)t * rows + row)) = make_float2(s, s2);
}

// The bf16 route: the products on the weight-streaming core, the
// cross-attention on decode_attn_sm90.cuh. part: fp32 split-K partials;
// counters: one int per (row tile, m64 tile) of the widest product, zero on
// entry (each product leaves them zero); stats: [ceil(d / 64)][rows][2]
// fp32, the row statistics of x handed from each residual product to the
// next LayerNorm. n_tile: the row tile (16, 32, 48, 80); cps: chunks of 64
// per split of the q|k|v, d x d, fc1 and fc2 products; cross_chunked: the
// cross-attention's score-chunked route (decode_attn_sm90.cuh).
template <int DP>
int step_sm90(const Pack& pk, const bf16* x0, const float* sbias, const float* cbias,
              const bf16* self_k, const bf16* self_v, const bf16* cross_k, const bf16* cross_v,
              bf16* x, bf16* k_new, bf16* v_new, bf16* scratch, float* part, int* counters,
              float* stats, int L, int B, int Kb, int H, int S, int Tmax, int f, int idx,
              float scaling, int n_tile, const int* cps, int pdl, int D, int cross_chunked,
              cudaStream_t st) {
  namespace sk = mk::skinny;
  const int d = H * D, rows = B * Kb, Dc = (D + 7) / 8 * 8;
  const int ch = Tmax < SA_CHUNK ? Tmax : SA_CHUNK;  // the self-attention's positions a chunk
  const int tiles = (d + sk::BM - 1) / sk::BM;  // 64-column tiles of x (the last may be short)
  // the warps' scores, and past DP 128 their q rows (self_attn_bf16)
  const size_t sa_smem = sizeof(float) * SA_WARPS * (ch + (DP > 128 ? DP : 0));
  if (d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  bf16* qbuf = scratch;          // [rows, d] self q (unscaled)
  bf16* attn = qbuf + rows * d;  // [rows, d] attention output, head-major columns
  bf16* q2 = attn + rows * d;    // [rows, d] cross q (scaled)
  bf16* g = q2 + rows * d;       // [rows, f] gelu(fc1)
  CUtensorMap m_self3, m_so, m_cq, m_co, m_fc1, m_fc2;
  mk::decode_attn::CacheMaps m_kv;
  MK_TRY(sk::weight_map(&m_self3, pk.w_self3, L, 3 * d, d, sk::BM));
  MK_TRY(sk::weight_map(&m_so, pk.w_so, L, d, d, sk::BM));
  MK_TRY(sk::weight_map(&m_cq, pk.w_cq, L, d, d, sk::BM));
  MK_TRY(sk::weight_map(&m_co, pk.w_co, L, d, d, sk::BM));
  MK_TRY(sk::weight_map(&m_fc1, pk.w_fc1, L, f, d, sk::BM));
  MK_TRY(sk::weight_map(&m_fc2, pk.w_fc2, L, d, f, sk::BM));
  MK_TRY(mk::decode_attn::cache_maps<DP>(&m_kv, cross_k, cross_v, (long long)L * B * H, S, Dc));
  // the first LayerNorm's statistics: x0's, by tile
  row_tile_stats<<<(rows * tiles + 3) / 4, 128, 0, st>>>(x0, rows, d, stats);
  MK_TRY((int)cudaGetLastError());
  return sk::with_row_tile(n_tile, [&](auto nt) -> int {
    constexpr int N = decltype(nt)::value;
    CUtensorMap m_x0, m_x, m_attn, m_g;  // the products' X, in boxes of N rows
    MK_TRY(sk::weight_map(&m_x0, x0, 1, rows, d, N));
    MK_TRY(sk::weight_map(&m_x, x, 1, rows, d, N));
    MK_TRY(sk::weight_map(&m_attn, attn, 1, rows, d, N));
    MK_TRY(sk::weight_map(&m_g, g, 1, rows, f, N));
    auto ln_of = [&](const float* ln_gb) { return sk::LnArgs{ln_gb, ln_gb + d, stats, tiles}; };
    const sk::LnArgs none{nullptr, nullptr, nullptr, 0};
    auto product = [&](const CUtensorMap& w, const CUtensorMap& xm, int l, const sk::LnArgs& ln,
                       int dout, int K, int c, float* stats_out, const Epi<bf16>& e) {
      return sk::launch_gemm<N>(w, xm, l, ln, rows, dout, K, c, part, counters, stats_out, e, pdl,
                                st);
    };
    for (int l = 0; l < L; ++l) {
      const float* ln = pk.ln + (long long)l * 6 * d;
      const bf16* bm = static_cast<const bf16*>(pk.b_misc) + (long long)l * 4 * d;
      const bf16* xin = l == 0 ? x0 : x;
      const CUtensorMap& m_xin = l == 0 ? m_x0 : m_x;
      bf16* kn = k_new + (long long)l * rows * d;
      bf16* vn = v_new + (long long)l * rows * d;
      // 1. LN + q|k|v: columns [0, d) -> qbuf, [d, 2d) -> k_new[l], [2d, 3d) -> v_new[l]
      Epi<bf16> e = epi_of<bf16>(static_cast<const bf16*>(pk.b_self3) + (long long)l * 3 * d,
                                 qbuf, d);
      e.out[1] = kn;
      e.out[2] = vn;
      MK_TRY(product(m_self3, m_xin, l, ln_of(ln), 3 * d, d, cps[0], nullptr, e));
      // 2. self-attention over the cache
      const long long cl = (long long)l * rows * H * Tmax;
      const dim3 sa_grid((rows * H + SA_WARPS - 1) / SA_WARPS);
      if (D == DP)
        self_attn_bf16<DP, true><<<sa_grid, SA_WARPS * 32, sa_smem, st>>>(
            qbuf, kn, vn, self_k + cl * Dc, self_v + cl * Dc, sbias + cl, attn, rows, H, Tmax, idx,
            scaling, D, ch);
      else if (D % 8 == 0)
        self_attn_bf16<DP, false><<<sa_grid, SA_WARPS * 32, sa_smem, st>>>(
            qbuf, kn, vn, self_k + cl * Dc, self_v + cl * Dc, sbias + cl, attn, rows, H, Tmax, idx,
            scaling, D, ch);
      else
        self_attn_kernel<DP, bf16><<<sa_grid, SA_WARPS * 32, sa_smem, st>>>(
            qbuf, kn, vn, self_k + cl * Dc, self_v + cl * Dc, sbias + cl, attn, rows, H, Tmax, idx,
            scaling, D, Dc, ch);
      MK_TRY((int)cudaGetLastError());
      // 3. out-proj + bias + residual; x's statistics for step 4
      MK_TRY(product(m_so, m_attn, l, none, d, d, cps[1], stats, epi_of<bf16>(bm, x, d, xin)));
      // 4. LN + cross q, scaled
      MK_TRY(product(m_cq, m_x, l, ln_of(ln + 2 * d), d, d, cps[1], nullptr,
                     epi_of<bf16>(bm + d, q2, d, nullptr, scaling)));
      // 5. beam-shared cross-attention over this layer's [B, H, S, D] K/V
      mk::decode_attn::Args a{q2, cbias, attn, B, H, Kb, S, l, D};
      MK_TRY(mk::decode_attn::launch_instance(DP, m_kv, a, cross_chunked, pdl, st));
      // 6. out-proj + bias + residual; x's statistics for step 7
      MK_TRY(product(m_co, m_attn, l, none, d, d, cps[1], stats,
                     epi_of<bf16>(bm + 2 * d, x, d, x)));
      // 7. LN + fc1 + bias + gelu
      MK_TRY(product(m_fc1, m_x, l, ln_of(ln + 4 * d), f, d, cps[2], nullptr,
                     epi_of<bf16>(static_cast<const bf16*>(pk.b_fc1) + (long long)l * f, g, f,
                                  nullptr, 0.f, 1)));
      // 8. fc2 + bias + residual; x's statistics for the next layer's step 1
      MK_TRY(product(m_fc2, m_g, l, none, d, f, cps[3], stats, epi_of<bf16>(bm + 3 * d, x, d, x)));
    }
    return 0;
  });
}

}  // namespace

// The fp32 route (FMA kernels). Shapes: the pack as ops/decode_stack.py
// builds it; x0 [rows, d]; sbias [L, rows, H, Tmax]; cbias [B, H, S]; self_k/
// self_v [L, rows, H, Tmax, hc]; cross_k/cross_v [L, B, H, S, hc]; outputs
// x_out [rows, d], k_new/v_new [L, rows, d]; scratch rows * (3 d + f)
// elements. rows = B * Kb, d = hd H, hd = head_dim (up to 256), hc = hd
// rounded up to a multiple of 8 (the caches' columns past hd zeros);
// cross_chunk: the keys of the cross-attention's score chunks (S: the whole
// row; cross_attn.cuh). Returns a CUDA error code.
extern "C" int mk_decode_stack_step(const void* w_self3, const void* b_self3, const void* w_so,
                                    const void* w_cq, const void* w_co, const void* w_fc1,
                                    const void* b_fc1, const void* w_fc2, const void* b_misc,
                                    const void* ln, const void* x0, const void* sbias,
                                    const void* cbias, const void* self_k, const void* self_v,
                                    const void* cross_k, const void* cross_v, void* x_out,
                                    void* k_new, void* v_new, void* scratch, int L, int B, int Kb,
                                    int H, int S, int Tmax, int f, int idx, float scaling,
                                    int head_dim, int cross_chunk, void* stream) {
  const Pack pk{w_self3, b_self3, w_so, w_cq, w_co, w_fc1, b_fc1, w_fc2, b_misc,
                static_cast<const float*>(ln)};
  using T = float;
  return mk::with_head_dim((head_dim + 7) / 8 * 8, [&](auto d) {
    return step<decltype(d)::value, T>(
        pk, static_cast<const T*>(x0), static_cast<const float*>(sbias),
        static_cast<const float*>(cbias), static_cast<const T*>(self_k),
        static_cast<const T*>(self_v), static_cast<const T*>(cross_k),
        static_cast<const T*>(cross_v), static_cast<T*>(x_out), static_cast<T*>(k_new),
        static_cast<T*>(v_new), static_cast<T*>(scratch), L, B, Kb, H, S, Tmax, f, idx, scaling,
        head_dim, cross_chunk, static_cast<cudaStream_t>(stream));
  });
}

// The bf16 route (tensor cores): the fp32 route's arguments in bf16 (sbias,
// cbias and ln fp32; head_dim as there), every bf16 tensor on a 16-byte
// boundary; part and stats fp32, counters int32, as step_sm90 describes
// them; cps four ints; pdl != 0 launches with programmatic stream
// serialization; cross_chunked != 0 runs the cross-attention's
// score-chunked route. Returns a CUDA error code.
extern "C" int mk_decode_stack_step_sm90(
    const void* w_self3, const void* b_self3, const void* w_so, const void* w_cq,
    const void* w_co, const void* w_fc1, const void* b_fc1, const void* w_fc2, const void* b_misc,
    const void* ln, const void* x0, const void* sbias, const void* cbias, const void* self_k,
    const void* self_v, const void* cross_k, const void* cross_v, void* x_out, void* k_new,
    void* v_new, void* scratch, void* part, void* counters, void* stats, int L, int B, int Kb,
    int H, int S,
    int Tmax, int f, int idx, float scaling, int n_tile, int cps_qkv, int cps_dd, int cps_fc1,
    int cps_fc2, int pdl, int head_dim, int cross_chunked, void* stream) {
  const Pack pk{w_self3, b_self3, w_so, w_cq, w_co, w_fc1, b_fc1, w_fc2, b_misc,
                static_cast<const float*>(ln)};
  const int cps[4] = {cps_qkv, cps_dd, cps_fc1, cps_fc2};
  using T = __nv_bfloat16;
  return mk::with_head_dim((head_dim + 7) / 8 * 8, [&](auto d) {
    return step_sm90<decltype(d)::value>(
        pk, static_cast<const T*>(x0), static_cast<const float*>(sbias),
        static_cast<const float*>(cbias), static_cast<const T*>(self_k),
        static_cast<const T*>(self_v), static_cast<const T*>(cross_k),
        static_cast<const T*>(cross_v), static_cast<T*>(x_out), static_cast<T*>(k_new),
        static_cast<T*>(v_new), static_cast<T*>(scratch), static_cast<float*>(part),
        static_cast<int*>(counters), static_cast<float*>(stats), L, B, Kb, H, S, Tmax, f, idx,
        scaling, n_tile, cps, pdl, head_dim, cross_chunked, static_cast<cudaStream_t>(stream));
  });
}
