// K2: tied output projection fused with its softmax statistics, for sm_90a.
//
// Replaces the Pallas kernel musketeer_tpu/ops/topk_projection.py::
// project_with_stats (_proj_kernel + _proj_body; pallas_call at :156). In one
// pass over the [Vp, D] embedding it writes, per row of h:
//   logits [N, Vp] in h's dtype, columns >= vocab_size set to -1e9;
//   bmax   [N, Vp/128] fp32, the max of each 128-token block;
//   bsum   [N, Vp/128] fp32, sum over the block of exp(logit - bmax).
// Both statistics come from the fp32 logits before the cast. The exact
// logsumexp is combined from (bmax, bsum) outside, as the JAX wrapper does.
//
// Translation. The TPU version walks 3968-wide vocab tiles in order and
// writes [ntiles, N, ...] layouts that Mosaic's (8, 128) block rule forced,
// with rows padded to 8. Here one block owns one 128-token vocab block and a
// 16-row chunk of h: the per-block max is then the block max itself, written
// straight into [N, Vp/128], and rows need no padding (the chunk is masked).
// Chunks of the same vocab block are neighbours in the grid, so the blocks
// that read one weight tile run together and share it through L2.
//
// Bound. At the decode shape (N=80 beam rows, Vp=59520, D=768, bf16) a call
// must read the 91 MB weight once (27 us at 3.35 TB/s) and does 3.7 G
// multiply-adds (~4 us on the tensor cores): it is bound by the weight read.
// This first version multiplies on the CUDA cores in fp32 (no wgmma yet):
// 256 threads, each one vocab column by 8 rows, reading h as float4 from
// shared memory (8 vector loads and 4 scalar loads per 32 FMAs); the fp32
// FMA rate (~0.1 ms for 3.7 G) rather than the weight read limits it.
//
// K2-q8 (mk_project_with_stats_q8) replaces _proj_kernel_q8 (:71), the same
// function over the int8 serving projection: w int8 [Vp, D] with fp32 row
// scales. The kernel is the same template with the weight type int8_t: it
// reads the int8 rows straight from device memory (half K2's weight bytes:
// 46 MB at the decode shape, 14 us at 3.35 TB/s), widens them in registers
// (exact), and multiplies each column's fp32 dot by its row scale before the
// mask and the statistics, as the TPU kernel does. Its bound is K2's: the
// fp32 FMA rate of this first version, not the halved weight read.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BLK = 128;  // vocab block = columns per CUDA block
constexpr int RB = 16;    // rows of h per CUDA block
constexpr int KC = 32;    // depth chunk staged in shared memory
constexpr int NT = 256;   // threads: column tid % 128, rows 8 * (tid / 128) + 0..7
constexpr int RPT = 8;    // rows per thread
constexpr float NEG = -1e9f;

// W is T (K2) or int8_t (K2-q8, with fp32 row scales `scale`; else nullptr)
template <typename T, typename W>
__global__ void __launch_bounds__(NT) proj_stats_kernel(
    const T* __restrict__ h, const W* __restrict__ w, const float* __restrict__ scale,
    T* __restrict__ logits, float* __restrict__ bmax, float* __restrict__ bsum, int N, int D,
    int Vp, int vocab_size) {
  __shared__ __align__(16) float hs[RB][KC];
  __shared__ float ws[KC][BLK + 1];  // +1 word: conflict-free transposed stores
  __shared__ float red[NT / 32][RPT];

  const int tid = threadIdx.x;
  const int c = tid % BLK, rg = tid / BLK;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * RB;
  const int vb = blockIdx.y;
  const long long col = (long long)vb * BLK + c;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int d0 = 0; d0 < D; d0 += KC) {
    for (int i = tid; i < RB * KC; i += NT) {
      const int r = i / KC, kk = i % KC, n = r0 + r, d = d0 + kk;
      hs[r][kk] = (n < N && d < D) ? mk::to_f(h[(long long)n * D + d]) : 0.f;
    }
    for (int i = tid; i < BLK * KC; i += NT) {
      const int r = i / KC, kk = i % KC, d = d0 + kk;
      ws[kk][r] = d < D ? mk::to_f(w[((long long)vb * BLK + r) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      const float w0 = ws[kk][c], w1 = ws[kk + 1][c], w2 = ws[kk + 2][c], w3 = ws[kk + 3][c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[rg * RPT + r][kk]);
        acc[r] = fmaf(hv.x, w0, acc[r]);
        acc[r] = fmaf(hv.y, w1, acc[r]);
        acc[r] = fmaf(hv.z, w2, acc[r]);
        acc[r] = fmaf(hv.w, w3, acc[r]);
      }
    }
    __syncthreads();
  }

  // int8 rows: the fp32 dot times the row scale, before the mask and the stats
  if (scale != nullptr) {
    const float s = scale[col];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] *= s;
  }

  // mask the padded vocab, store the logits
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int n = r0 + rg * RPT + r;
    if (col >= vocab_size) acc[r] = NEG;
    if (n < N) logits[(long long)n * Vp + col] = mk::from_f<T>(acc[r]);
  }

  // block max: the 4 warps of this row group (warps 4 rg .. 4 rg + 3)
  float mx[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float x = mk::warp_max(acc[r]);
    if (lane == 0) red[warp][r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    mx[r] = fmaxf(fmaxf(red[4 * rg][r], red[4 * rg + 1][r]),
                  fmaxf(red[4 * rg + 2][r], red[4 * rg + 3][r]));
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float x = mk::warp_sum(expf(acc[r] - mx[r]));
    if (lane == 0) red[warp][r] = x;
  }
  __syncthreads();
  if (c < RPT) {
    const int r = c, n = r0 + rg * RPT + r;
    if (n < N) {
      const int nblk = Vp / BLK;
      bmax[(long long)n * nblk + vb] = mx[r];
      bsum[(long long)n * nblk + vb] =
          (red[4 * rg][r] + red[4 * rg + 1][r]) + (red[4 * rg + 2][r] + red[4 * rg + 3][r]);
    }
  }
}

template <typename T, typename W>
int launch(const void* h, const void* w, const void* scale, void* logits, void* bmax, void* bsum,
           int N, int D, int Vp, int vocab_size, cudaStream_t stream) {
  const dim3 grid((N + RB - 1) / RB, Vp / BLK);
  proj_stats_kernel<T, W><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const W*>(w), static_cast<const float*>(scale),
      static_cast<T*>(logits), static_cast<float*>(bmax), static_cast<float*>(bsum), N, D, Vp,
      vocab_size);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 h, w and logits, else float. Vp % 128 == 0.
// Returns cudaGetLastError().
extern "C" int mk_project_with_stats(int bf16, const void* h, const void* w, void* logits,
                                     void* bmax, void* bsum, int N, int D, int Vp,
                                     int vocab_size, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(h, w, nullptr, logits, bmax, bsum, N, D, Vp,
                                                vocab_size, st);
  return launch<float, float>(h, w, nullptr, logits, bmax, bsum, N, D, Vp, vocab_size, st);
}

// K2-q8: w int8 [Vp, D], scale fp32 [Vp]; h and logits as for K2.
extern "C" int mk_project_with_stats_q8(int bf16, const void* h, const void* w,
                                        const void* scale, void* logits, void* bmax, void* bsum,
                                        int N, int D, int Vp, int vocab_size, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, int8_t>(h, w, scale, logits, bmax, bsum, N, D, Vp, vocab_size,
                                         st);
  return launch<float, int8_t>(h, w, scale, logits, bmax, bsum, N, D, Vp, vocab_size, st);
}
