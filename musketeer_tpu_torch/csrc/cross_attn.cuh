// Beam-shared cross-attention of one decode step, for one (head, sample), on
// fp32 FMAs: the device function of K6's and K7's fp32 routes (int8 K/V with
// per-position scales, and fp32 K/V). Their bf16 routes run on the tensor
// cores (decode_cross_attn.cu, decode_attn_sm90.cuh).
//
// For the Kb beams j of sample b and head h, over the sample's S keys:
//   w[j, s] = q[j] . k[s]            (int8: times k_scale[s]) + bias[s]
//   int8:   pads -> -1e9, m = max(max_s w, -1e8), l = max(sum_s e, 1e-38),
//           p = e / l * v_scale[s]   (a fully padded sample gives zeros)
//   else:   m = max_s w, l = sum_s e, p = e / l   (pads folded into bias)
//   out[j]  = sum_s round_T(p[j, s]) * v[s]      (fp32 sums, rounded to T)
// with e = exp(w - m): the normalised probabilities are rounded to the
// compute dtype T before the value product, as both TPU kernels do.
//
// Design. One block of 256 threads per (h, b, beam tile of up to 16 beams)
// reads the (b, h) K and V once for the tile's beams. Scores: one key row per
// thread, loaded with 16-byte vector loads and widened in registers, dotted
// with the tile's query rows held in shared memory; where the tile's whole
// rows fit (Args::chunk == S), all its scores stay in shared memory for an
// exact (two-pass) softmax, one warp per beam row. Else the keys run in
// chunks of Args::chunk: a first pass over the chunks keeps each row's max
// and sum of exp (rescaled as the max moves; int8: the max from -1e8, the
// clamp), a second computes each chunk's scores again, its probabilities
// and its values. Values: thread (d, part) sums the keys of
// its part for all Kb beams in registers; the NT / DP parts (8 at DP 32, 4
// at 64, 3 at 80 with 16 threads idle, 2 at 128, 1 at 192 with 64 threads
// idle and at 256) are added in order. Past DP 128 a thread takes its key
// row 64 dims at a time (a whole row would be DP registers), all the tile's
// beams' dots carried across the chunks: the same fp32 sums in the same
// order. The tile width DP is a template parameter, compiled at 32, 64, 80,
// 128, 192 and 256 (a head dim D runs on the smallest DP >= D,
// common.cuh::with_head_dim): q's
// staged columns past D are zeros, a key row is read to its stride (the
// cache's rows, padded with zeros to a multiple of 8 or 16 elements), and
// the threads of the columns past D sum nothing.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mk {
namespace cross_attn {

constexpr int NT = 256;        // threads per block
constexpr int MAX_KB = 16;     // beams (query rows) of one tile
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr float NEG = -1e9f;

struct Args {
  const void* q;         // T: element (b, h, j, d) at b * q_bs + h * q_hs + j * q_js + d
  const void* k;         // KV [B, H, S, kv_rs]: rows of D, zeros to kv_rs
  const void* v;         // KV [B, H, S, kv_rs]
  const float* k_scale;  // [B, H, S] (int8 K/V only)
  const float* v_scale;  // [B, H, S] (int8 K/V only)
  const float* bias;     // element (b, h, s) at b * bias_bs + h * bias_hs + s
  const uint8_t* pad;    // [B, S] bool (int8 only: K7 folds pads into the bias)
  void* out;             // T, in q's layout
  int H, Kb, S;
  int D, kv_rs;          // the head dim; the cache's row stride (elements; D <= kv_rs <= DP)
  int chunk;             // keys of a score chunk: S (the whole row) or fewer
  long long q_bs, q_hs, q_js, bias_bs, bias_hs;
};

template <int DP>
__host__ __device__ constexpr int parts() {  // key partitions of the value product
  return NT / DP;
}

// Kb beams of a tile, score chunks of `chunk` keys: q, the chunk's scores,
// the value partials, the rows' running max and sum
template <int DP>
inline size_t smem_bytes(int Kb, int chunk) {
  return sizeof(float) *
         ((size_t)Kb * DP + (size_t)Kb * chunk + (size_t)parts<DP>() * Kb * DP + 2 * (size_t)Kb);
}

// a row's first n (a multiple of 4 or 16) of DP elements, 16 bytes at a
// time, widened to fp32; zeros past n
template <int DP>
__device__ __forceinline__ void load_row(const float* p, float* r, int n) {
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const float4 v = 4 * i < n ? reinterpret_cast<const float4*>(p)[i] : make_float4(0, 0, 0, 0);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

template <int DP>
__device__ __forceinline__ void load_row(const int8_t* p, float* r, int n) {
#pragma unroll
  for (int i = 0; i < DP / 16; ++i) {
    const uint4 v = 16 * i < n ? reinterpret_cast<const uint4*>(p)[i] : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      r[16 * i + j] = static_cast<float>(static_cast<int8_t>((w[j / 4] >> (8 * (j % 4))) & 0xffu));
  }
}

template <int DP, typename T, typename KV, bool kInt8>
__device__ void block(const Args& a, int h, int b, int j0) {
  constexpr int PARTS = parts<DP>();
  extern __shared__ __align__(16) float smem[];
  const int Kb = min(MAX_KB, a.Kb - j0);  // this tile's beams
  const int S = a.S, cs = a.chunk, D = a.D, rs = a.kv_rs, tid = threadIdx.x;
  float* qs = smem;                   // [Kb][DP], zeros past D
  float* sc = qs + Kb * DP;           // [Kb][cs] a chunk's scores, then probabilities
  float* red = sc + (size_t)Kb * cs;  // [PARTS][Kb][DP]
  float* ml = red + PARTS * Kb * DP;  // [Kb][2] each row's running max and sum (chunked)
  const long long bh = (long long)b * a.H + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_bs + h * a.q_hs + j0 * a.q_js;
  const KV* kp = static_cast<const KV*>(a.k) + bh * S * rs;
  const KV* vp = static_cast<const KV*>(a.v) + bh * S * rs;
  const float* bias = a.bias + b * a.bias_bs + h * a.bias_hs;

  for (int i = tid; i < Kb * DP; i += NT)
    qs[i] = i % DP < D ? to_f(q[(i / DP) * a.q_js + i % DP]) : 0.f;
  __syncthreads();

  // the scores of keys c0 .. c0 + n - 1 into sc: one key row per thread
  // the score of key s from its dot with beam j's q
  auto score = [&](float acc, int s) {
    if (kInt8) return a.pad[(long long)b * S + s] ? NEG : acc * a.k_scale[bh * S + s] + bias[s];
    return acc + bias[s];
  };
  auto scores = [&](int c0, int n) {
    for (int i = tid; i < n; i += NT) {
      const int s = c0 + i;
      if constexpr (DP <= 128) {
        float kr[DP];
        load_row<DP>(kp + (long long)s * rs, kr, rs);
        for (int j = 0; j < Kb; ++j) {
          const float4* qj = reinterpret_cast<const float4*>(qs + j * DP);
          float acc = 0.f;
#pragma unroll
          for (int i4 = 0; i4 < DP / 4; ++i4) {
            const float4 qv = qj[i4];
            acc = fmaf(qv.x, kr[4 * i4], acc);
            acc = fmaf(qv.y, kr[4 * i4 + 1], acc);
            acc = fmaf(qv.z, kr[4 * i4 + 2], acc);
            acc = fmaf(qv.w, kr[4 * i4 + 3], acc);
          }
          sc[j * cs + i] = score(acc, s);
        }
      } else {  // 64 dims of the key row at a time, every beam's dot carried across
        float acc[MAX_KB];
#pragma unroll
        for (int j = 0; j < MAX_KB; ++j) acc[j] = 0.f;
        for (int c = 0; c < DP / 64; ++c) {
          float kr[64];
          load_row<64>(kp + (long long)s * rs + 64 * c, kr, rs - 64 * c);
#pragma unroll
          for (int j = 0; j < MAX_KB; ++j) {
            if (j >= Kb) break;
            const float4* qj = reinterpret_cast<const float4*>(qs + j * DP + 64 * c);
#pragma unroll
            for (int i4 = 0; i4 < 16; ++i4) {
              const float4 qv = qj[i4];
              acc[j] = fmaf(qv.x, kr[4 * i4], acc[j]);
              acc[j] = fmaf(qv.y, kr[4 * i4 + 1], acc[j]);
              acc[j] = fmaf(qv.z, kr[4 * i4 + 2], acc[j]);
              acc[j] = fmaf(qv.w, kr[4 * i4 + 3], acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_KB; ++j)
          if (j < Kb) sc[j * cs + i] = score(acc[j], s);
      }
    }
  };
  // each row's probabilities of keys c0 .. c0 + n - 1, in place: p = e / l
  // (int8: times v_scale), rounded to T
  const int warp = tid / 32, lane = tid % 32;
  auto probs = [&](int c0, int n, int j, float m, float l) {
    float* row = sc + (size_t)j * cs;
    for (int i = lane; i < n; i += 32) {
      float p = expf(row[i] - m) / l;
      if (kInt8) p *= a.v_scale[bh * S + c0 + i];
      row[i] = round_to<T>(p);
    }
  };
  // values: thread (d, part) over the keys c0 + i, i = part (mod PARTS), all
  // beams; threads past PARTS * DP have no part, those of columns d >= D sum nothing
  const int d = tid % DP, part = tid / DP;
  float acc[MAX_KB];
#pragma unroll
  for (int j = 0; j < MAX_KB; ++j) acc[j] = 0.f;
  auto values = [&](int c0, int n) {
    if (part >= PARTS) return;
    for (int i = part; i < n && d < D; i += PARTS) {
      const float v = to_f(vp[(long long)(c0 + i) * rs + d]);
#pragma unroll
      for (int j = 0; j < MAX_KB; ++j)
        if (j < Kb) acc[j] = fmaf(sc[(size_t)j * cs + i], v, acc[j]);
    }
  };

  if (S <= cs) {  // the whole row at once: an exact two-pass softmax, one warp per beam row
    scores(0, S);
    __syncthreads();
    for (int j = warp; j < Kb; j += NT / 32) {
      const float* row = sc + (size_t)j * cs;
      float m = -CUDART_INF_F;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
      m = warp_max(m);
      if (kInt8) m = fmaxf(m, -1e8f);
      float l = 0.f;
      for (int s = lane; s < S; s += 32) l += expf(row[s] - m);
      l = warp_sum(l);
      if (kInt8) l = fmaxf(l, 1e-38f);  // subnormal: the build does not flush it
      probs(0, S, j, m, l);
    }
    __syncthreads();
    values(0, S);
  } else {  // score chunks of cs keys: pass 1 the rows' max and sum, pass 2 p and the values
    for (int j = warp; j < Kb; j += NT / 32)
      if (lane == 0) {
        ml[2 * j] = kInt8 ? -1e8f : -CUDART_INF_F;  // int8: the max clamped at -1e8
        ml[2 * j + 1] = 0.f;
      }
    for (int c0 = 0; c0 < S; c0 += cs) {
      const int n = min(cs, S - c0);
      scores(c0, n);
      __syncthreads();
      for (int j = warp; j < Kb; j += NT / 32) {
        const float* row = sc + (size_t)j * cs;
        float cm = -CUDART_INF_F;
        for (int i = lane; i < n; i += 32) cm = fmaxf(cm, row[i]);
        const float m = ml[2 * j], mn = fmaxf(m, warp_max(cm));
        float e = 0.f;
        for (int i = lane; i < n; i += 32) e += expf(row[i] - mn);
        const float l = ml[2 * j + 1] * expf(m - mn) + warp_sum(e);
        __syncwarp();
        if (lane == 0) {
          ml[2 * j] = mn;
          ml[2 * j + 1] = l;
        }
      }
      __syncthreads();
    }
    for (int c0 = 0; c0 < S; c0 += cs) {
      const int n = min(cs, S - c0);
      scores(c0, n);
      __syncthreads();
      for (int j = warp; j < Kb; j += NT / 32)
        probs(c0, n, j, ml[2 * j], kInt8 ? fmaxf(ml[2 * j + 1], 1e-38f) : ml[2 * j + 1]);
      __syncthreads();
      values(c0, n);
      __syncthreads();
    }
  }
  if (part < PARTS)
#pragma unroll
    for (int j = 0; j < MAX_KB; ++j)
      if (j < Kb) red[(part * Kb + j) * DP + d] = acc[j];
  __syncthreads();
  T* out = static_cast<T*>(a.out) + b * a.q_bs + h * a.q_hs + j0 * a.q_js;
  for (int i = tid; i < Kb * DP; i += NT) {
    const int j = i / DP, dd = i % DP;
    if (dd >= D) continue;
    float o = 0.f;
    for (int p = 0; p < PARTS; ++p) o += red[(p * Kb + j) * DP + dd];
    out[j * a.q_js + dd] = from_f<T>(o);
  }
}

template <int DP, typename T, typename KV, bool kInt8>
__global__ void __launch_bounds__(NT) kernel(Args a) {
  block<DP, T, KV, kInt8>(a, blockIdx.x, blockIdx.y, MAX_KB * blockIdx.z);
}

// grid (H, B, beam tiles); returns a CUDA error code (cudaErrorInvalidValue
// when a chunk of the scores does not fit)
template <int DP, typename T, typename KV, bool kInt8>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>(a.Kb < MAX_KB ? a.Kb : MAX_KB, a.chunk);
  if (a.Kb < 1 || a.chunk < 1 || smem > MAX_SMEM || a.D > a.kv_rs || a.kv_rs > DP)
    return (int)cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  if (smem > 48 * 1024)
    if (const int err = opt_in.ensure((const void*)kernel<DP, T, KV, kInt8>, smem)) return err;
  kernel<DP, T, KV, kInt8><<<dim3(a.H, B, (a.Kb + MAX_KB - 1) / MAX_KB), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cross_attn
}  // namespace mk
