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
// with rows padded to 8. Here a CTA owns whole 128-token vocab blocks, so
// the per-block max is the block max itself, written straight into
// [N, Vp/128].
//
// Bound. At the decode shape (N=80 beam rows, Vp=59520, D=768, bf16) a call
// must read the 91 MB weight once (27 us at 3.35 TB/s) and does 3.7 G
// multiply-adds (~7 us on the tensor cores): it is bound by the weight read.
//
// bf16 (mk_project_with_stats_sm90) runs on the weight-streaming tensor-core
// core of skinny_gemm_sm90.cuh: a persistent grid of one CTA per SM keeps its
// h rows (80 x 768 bf16, 123 KB, copied once by TMA) in shared memory and walks vocab blocks
// vb = blockIdx.x, + gridDim.x, ...; the producer warp streams each block's
// W as 128 x 64 tiles by TMA through a 4-stage ring without a break between
// blocks; the consumer warpgroup multiplies each tile as two m64 halves
// against the N rows (wgmma m64nNk16, swap AB). The epilogue reduces each
// row's max and then its sum of exp over the block's 128 positions: in the
// thread (both halves, both accumulator rows), across the 8 lanes of a quad
// column (xor 4, 8, 16), then across the 4 warps through shared memory,
// (w0 + w1) + (w2 + w3); it stores the logits through a shared-memory
// transpose as 256-byte rows (coalesced) and bmax, bsum straight into
// [N, Vp/128].
//
// K2-q8 (_proj_kernel_q8, :71) is the same function over the int8 serving
// projection: w int8 [Vp, D] with fp32 row scales; logits = (h . w) * scale[v]
// in fp32, before the mask and the statistics. Its weight read is half K2's
// (46 MB at the decode shape, 14 us at 3.35 TB/s), which bounds it. In bf16
// (mk_project_with_stats_q8_sm90, proj_q8_sm90_kernel) it runs the same
// persistent kernel: each stage is 128 vocab rows x 128 deep of int8 (16 KB,
// the same bytes in flight), which the consumers widen exactly to bf16 in
// registers and feed to wgmma as its A operand from registers, with h's
// depth permuted once in shared memory to match the fragments
// (skinny_gemm_sm90.cuh: mma_stage_i8, permute_x_i8); each thread's four row
// scales multiply its accumulators before the epilogue, which is K2's.
// The widening (~2.75 instructions a weight, on the one consumer warpgroup)
// overlaps the other half's products; a second consumer warpgroup would
// double its issue rate.
//
// Where no row tile's h fits in shared memory (bf16 D past 4992), h is
// streamed instead (kStream): each ring stage carries, beside its W tile,
// h's chunks of the same depth (N x 64 bf16: 10 KB at 80 rows; int8 stages
// two, which the consumers permute in place and release only after their
// products), re-read from L2 for every vocab block; the sums over D keep
// their order, so the logits and statistics are the whole-h route's.
//
// fp32 (mk_project_with_stats, mk_project_with_stats_q8) stays on the FMA
// kernel below: 256 threads, each one vocab column by 8 rows of a 16-row
// chunk, 32-deep chunks of both operands staged in shared memory; fp32 FMAs
// bound it.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "skinny_gemm_sm90.cuh"

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


// ---- bf16: the weight-streaming tensor-core core ---------------------------

namespace sk = mk::skinny;
using bf16 = __nv_bfloat16;

constexpr uint32_t WT2 = 2 * sk::WTILE;  // a stage: 128 vocab rows x 64 deep (int8: x 128)
constexpr int LGS = BLK + 8;              // row stride of the logits transpose (bf16)

// nch: the h chunks of 64 deep staged (int8 W: two per 128-deep stage);
// stream: h's chunks streamed beside each W stage (nch: those of one stage)
template <int N>
constexpr size_t proj_smem(int nch, bool stream) {
  const size_t h_bytes = (stream ? sk::STAGES : 1) * (size_t)nch * sk::x_chunk_bytes<N>();
  return 1024 + sk::STAGES * WT2 + h_bytes +
         2 * (size_t)N * LGS + sizeof(float) * 5 * N + 8 * (2 * sk::STAGES + 1);
}

// The persistent kernel's body; Q8: W int8 with fp32 row scales `scale`.
// wmap: w as a [1, Vp, D] map with 128-row boxes, 64 deep (bf16) or 128 deep
// (int8); hmap: h as a [1, rows, D] map with 64 x N boxes. kStream: h is not
// kept whole; each stage of the ring carries its W tile and the h chunks of
// the same depth (one, or two for an int8 stage, which the consumers permute
// in place before the product; such a stage is released only after its
// products end). The sums over D run in the same order either way.
template <int N, bool Q8, bool kStream>
__device__ __forceinline__ void proj_body(const CUtensorMap* wmap, const CUtensorMap* hmap,
                                          const float* __restrict__ scale,
                                          bf16* __restrict__ logits, float* __restrict__ bmax,
                                          float* __restrict__ bsum, int rows, int D, int Vp,
                                          int vocab_size) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mk::sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr int SK = Q8 ? sk::BKQ : sk::BKC;  // depth of a stage
  const int nst = (D + SK - 1) / SK, nblk = Vp / BLK;  // stages a block
  const int nx = (D + sk::BKC - 1) / sk::BKC;          // h chunks copied
  const int nch = Q8 ? 2 * nst : nx;                   // h chunks staged
  constexpr uint32_t XST = (Q8 ? 2 : 1) * sk::x_chunk_bytes<N>();  // h of one stage
  const uint32_t ring = base, xs = base + sk::STAGES * WT2;
  const uint32_t lg_s = xs + (kStream ? sk::STAGES * XST : nch * sk::x_chunk_bytes<N>());
  bf16* lg = reinterpret_cast<bf16*>(smem_raw + (lg_s - raw));  // [N][LGS] logits tile
  float* red = reinterpret_cast<float*>(lg + N * LGS);           // [4][N] per-warp partials
  float* fin = red + 4 * N;                                      // [N] block max
  const uint32_t bars = mk::sm90::smem_u32(fin + N);
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (sk::STAGES + st); };
  const uint32_t xbar = bars + 8u * (2 * sk::STAGES);
  const int tid = threadIdx.x, r0 = blockIdx.y * N;
  if (tid == 0) {
    for (int st = 0; st < sk::STAGES; ++st) {
      mk::sm90::mbar_init(full(st), 1);
      mk::sm90::mbar_init(empty(st), sk::NC);
    }
    mk::sm90::mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= sk::NC) {  // the producer warp: h once, then every block's W stages, back to back
    if (tid == sk::NC) {
      if constexpr (!kStream) sk::load_x<N>(xs, hmap, xbar, r0, 0, nx);
      int it = 0;
      for (int vb = blockIdx.x; vb < nblk; vb += gridDim.x)
        for (int c = 0; c < nst; ++c, ++it) {
          const int st = it % sk::STAGES;
          if (it >= sk::STAGES) mk::sm90::mbar_wait(empty(st), (it / sk::STAGES - 1) & 1);
          if constexpr (kStream) {  // the stage's h chunks (those within D) beside its W tile
            const int n = min(SK / sk::BKC, nx - c * (SK / sk::BKC));
            mk::sm90::mbar_expect_tx(full(st), WT2 + n * sk::x_chunk_bytes<N>());
            for (int k = 0; k < n; ++k)
              mk::sm90::tma_load3(xs + st * XST + k * sk::x_chunk_bytes<N>(), hmap, full(st),
                                  c * SK + k * sk::BKC, r0, 0);
          } else {
            mk::sm90::mbar_expect_tx(full(st), WT2);
          }
          mk::sm90::tma_load3(ring + st * WT2, wmap, full(st), c * SK, vb * BLK, 0);
        }
    }
    return;  // no block-wide barrier follows
  }

  if constexpr (!kStream) mk::sm90::mbar_wait(xbar, 0);
  if constexpr (Q8 && !kStream) {  // h's depth permuted to match the widened int8 fragments
    sk::permute_x_i8<N, sk::NC>(smem_raw + (xs - raw), nst, nx, tid);
    mk::sm90::fence_async_smem();
    mk::sm90::named_sync(1, sk::NC);
  }
  const int warp = tid / 32, lane = tid % 32;
  int it = 0;
  for (int vb = blockIdx.x; vb < nblk; vb += gridDim.x) {
    float rs[2][2];  // int8: the row scales of this thread's columns (half, 8-row group)
    if constexpr (Q8)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          rs[hf][hh] = __ldg(scale + vb * BLK + 64 * hf + sk::acc_col(2 * hh, tid));
    float acc[2][N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
    if constexpr (Q8 && kStream) {
      uint32_t a[2][8][4];  // the widened fragments
      for (int c = 0; c < nst; ++c, ++it) {
        const int st = it % sk::STAGES;
        mk::sm90::mbar_wait(full(st), (it / sk::STAGES) & 1);
        // the stage's h group permuted in place; the stage is released after its products
        sk::permute_x_i8<N, sk::NC>(smem_raw + (xs + st * XST - raw), 1,
                                    min(2, nx - 2 * c), tid);
        mk::sm90::fence_async_smem();
        mk::sm90::named_sync(1, sk::NC);
        sk::mma_stage_i8<N, false>(acc, a, smem_raw + (ring + st * WT2 - raw), xs + st * XST,
                                   empty(st), tid);
        mk::sm90::wgmma_wait();
        mk::sm90::fence_regs(acc[0]);
        mk::sm90::fence_regs(acc[1]);
        mk::sm90::mbar_arrive(empty(st));
      }
    } else if constexpr (Q8) {
      uint32_t a[2][8][4];  // the widened fragments, in flight across stages
      for (int c = 0; c < nst; ++c, ++it) {
        const int st = it % sk::STAGES;
        mk::sm90::mbar_wait(full(st), (it / sk::STAGES) & 1);
        sk::mma_stage_i8<N>(acc, a, smem_raw + (ring + st * WT2 - raw),
                            xs + 2 * c * sk::x_chunk_bytes<N>(), empty(st), tid);
      }
      mk::sm90::wgmma_wait();
      mk::sm90::fence_regs(acc[0]);
      mk::sm90::fence_regs(acc[1]);
    } else {
      for (int c = 0; c < nst; ++c, ++it) {
        const int st = it % sk::STAGES;
        const uint32_t xc = kStream ? xs + st * XST : xs + c * sk::x_chunk_bytes<N>();
        mk::sm90::mbar_wait(full(st), (it / sk::STAGES) & 1);
        mk::sm90::wgmma_fence();
        sk::mma_chunk<N>(acc[0], ring + st * WT2, xc);
        sk::mma_chunk<N>(acc[1], ring + st * WT2 + sk::WTILE, xc);
        mk::sm90::wgmma_commit();
        mk::sm90::wgmma_wait();
        mk::sm90::fence_regs(acc[0]);
        mk::sm90::fence_regs(acc[1]);
        mk::sm90::mbar_arrive(empty(st));
      }
    }
    // int8: the fp32 dot times the row scale, before the mask and the statistics
    if constexpr (Q8)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[hf][i] *= rs[hf][(i / 2) % 2];
    // mask the padded vocab; the logits, rounded, into the transpose tile
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int col = 64 * hf + sk::acc_col(i, tid);
        if (vb * BLK + col >= vocab_size) acc[hf][i] = NEG;
        lg[sk::acc_row(i, tid) * LGS + col] = __float2bfloat16_rn(acc[hf][i]);
      }
    // row max: the thread's four values of a row, the 8 lanes of its quad
    // column, then the 4 warps
#pragma unroll
    for (int i = 0; i < N / 2; i += 4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = fmaxf(fmaxf(acc[0][i + e], acc[0][i + 2 + e]),
                        fmaxf(acc[1][i + e], acc[1][i + 2 + e]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (lane < 4) red[warp * N + sk::acc_row(i + e, tid)] = m;
      }
    mk::sm90::named_sync(1, sk::NC);
    if (tid < N)
      fin[tid] = fmaxf(fmaxf(red[tid], red[N + tid]), fmaxf(red[2 * N + tid], red[3 * N + tid]));
    mk::sm90::named_sync(1, sk::NC);
    // sum of exp(x - max), reduced in the same order
#pragma unroll
    for (int i = 0; i < N / 2; i += 4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m = fin[sk::acc_row(i + e, tid)];
        float s = ((expf(acc[0][i + e] - m) + expf(acc[0][i + 2 + e] - m)) +
                   expf(acc[1][i + e] - m)) + expf(acc[1][i + 2 + e] - m);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[warp * N + sk::acc_row(i + e, tid)] = s;
      }
    mk::sm90::named_sync(1, sk::NC);
    if (tid < N && r0 + tid < rows) {
      const long long o = (long long)(r0 + tid) * nblk + vb;
      bmax[o] = fin[tid];
      bsum[o] = (red[tid] + red[N + tid]) + (red[2 * N + tid] + red[3 * N + tid]);
    }
    // the logits tile as 256-byte rows
    for (int u = tid; u < N * (BLK / 8); u += sk::NC) {
      const int r = u / (BLK / 8), q = u % (BLK / 8);
      if (r0 + r < rows)
        *reinterpret_cast<uint4*>(logits + (long long)(r0 + r) * Vp + vb * BLK + 8 * q) =
            *reinterpret_cast<const uint4*>(lg + r * LGS + 8 * q);
    }
    mk::sm90::named_sync(1, sk::NC);  // lg, red and fin are rewritten by the next block
  }
}

// grid (CTAs, row tiles)
template <int N, bool kStream>
__global__ void __launch_bounds__(sk::NT) proj_sm90_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
    bf16* __restrict__ logits, float* __restrict__ bmax, float* __restrict__ bsum, int rows,
    int D, int Vp, int vocab_size) {
  proj_body<N, false, kStream>(&wmap, &hmap, nullptr, logits, bmax, bsum, rows, D, Vp,
                               vocab_size);
}

template <int N, bool kStream>
__global__ void __launch_bounds__(sk::NT) proj_q8_sm90_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap hmap,
    const float* __restrict__ scale, bf16* __restrict__ logits, float* __restrict__ bmax,
    float* __restrict__ bsum, int rows, int D, int Vp, int vocab_size) {
  proj_body<N, true, kStream>(&wmap, &hmap, scale, logits, bmax, bsum, rows, D, Vp, vocab_size);
}

// scale == nullptr: bf16 w (proj_sm90_kernel); else int8 w (proj_q8_sm90_kernel)
template <int N, bool kStream>
int launch_kernel(const CUtensorMap& wmap, const CUtensorMap& hmap, const void* scale,
                  void* logits, void* bmax, void* bsum, int rows, int D, int Vp, int vocab_size,
                  int ctas, size_t smem, cudaStream_t stream) {
  const dim3 grid(ctas, (rows + N - 1) / N);
  auto* out = static_cast<bf16*>(logits);
  auto* mx = static_cast<float*>(bmax);
  auto* sm = static_cast<float*>(bsum);
  if (scale != nullptr) {
    static mk::SmemOptIn opt_in;
    if (const int err = opt_in.ensure((const void*)proj_q8_sm90_kernel<N, kStream>, smem))
      return err;
    proj_q8_sm90_kernel<N, kStream><<<grid, sk::NT, smem, stream>>>(
        wmap, hmap, static_cast<const float*>(scale), out, mx, sm, rows, D, Vp, vocab_size);
  } else {
    static mk::SmemOptIn opt_in;
    if (const int err = opt_in.ensure((const void*)proj_sm90_kernel<N, kStream>, smem))
      return err;
    proj_sm90_kernel<N, kStream><<<grid, sk::NT, smem, stream>>>(wmap, hmap, out, mx, sm, rows, D,
                                                                 Vp, vocab_size);
  }
  return (int)cudaGetLastError();
}

// stream: h streamed beside the W stages (else staged whole, which must fit)
template <int N>
int launch_sm90(const void* h, const void* w, const void* scale, void* logits, void* bmax,
                void* bsum, int rows, int D, int Vp, int vocab_size, int ctas, int stream_h,
                cudaStream_t stream) {
  const bool q8 = scale != nullptr;
  CUtensorMap wmap, hmap;
  if (const int err = q8 ? sk::weight_map_i8(&wmap, w, 1, Vp, D, BLK)
                         : sk::weight_map(&wmap, w, 1, Vp, D, BLK))
    return err;
  if (const int err = sk::weight_map(&hmap, h, 1, rows, D, N)) return err;
  const int nch = stream_h ? (q8 ? 2 : 1)  // a stage's chunks, else all of h's
                           : (q8 ? 2 * ((D + sk::BKQ - 1) / sk::BKQ) : (D + sk::BKC - 1) / sk::BKC);
  const size_t smem = proj_smem<N>(nch, stream_h != 0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return stream_h ? launch_kernel<N, true>(wmap, hmap, scale, logits, bmax, bsum, rows, D, Vp,
                                           vocab_size, ctas, smem, stream)
                  : launch_kernel<N, false>(wmap, hmap, scale, logits, bmax, bsum, rows, D, Vp,
                                            vocab_size, ctas, smem, stream);
}

}  // namespace

// fp32 h, w and logits (the FMA kernel). Vp % 128 == 0. Returns
// cudaGetLastError().
extern "C" int mk_project_with_stats(const void* h, const void* w, void* logits, void* bmax,
                                     void* bsum, int N, int D, int Vp, int vocab_size,
                                     void* stream) {
  return launch<float, float>(h, w, nullptr, logits, bmax, bsum, N, D, Vp, vocab_size,
                              static_cast<cudaStream_t>(stream));
}

// bf16 h, w and logits (the tensor-core core), every tensor on a 16-byte
// boundary, D % 8 == 0, Vp % 128 == 0; n_tile the row tile (16, 32, 48 or
// 80), ctas the persistent grid; stream_h != 0 streams h's chunks beside the
// W stages (else h is staged whole). Returns a CUDA error code.
extern "C" int mk_project_with_stats_sm90(const void* h, const void* w, void* logits, void* bmax,
                                          void* bsum, int N, int D, int Vp, int vocab_size,
                                          int n_tile, int ctas, int stream_h, void* stream) {
  if (D % 8 || Vp % BLK || ctas < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return sk::with_row_tile(n_tile, [&](auto nt) -> int {
    return launch_sm90<decltype(nt)::value>(h, w, nullptr, logits, bmax, bsum, N, D, Vp,
                                            vocab_size, ctas, stream_h, st);
  });
}

// K2-q8, fp32 h and logits (the FMA kernel): w int8 [Vp, D], scale fp32 [Vp].
extern "C" int mk_project_with_stats_q8(const void* h, const void* w, const void* scale,
                                        void* logits, void* bmax, void* bsum, int N, int D,
                                        int Vp, int vocab_size, void* stream) {
  return launch<float, int8_t>(h, w, scale, logits, bmax, bsum, N, D, Vp, vocab_size,
                               static_cast<cudaStream_t>(stream));
}

// K2-q8, bf16 h and logits (the tensor-core core): w int8 [Vp, D], scale fp32
// [Vp]; h, w and logits on 16-byte boundaries, D % 16 == 0, Vp % 128 == 0;
// n_tile, ctas and stream_h as for mk_project_with_stats_sm90. Returns a CUDA
// error code.
extern "C" int mk_project_with_stats_q8_sm90(const void* h, const void* w, const void* scale,
                                             void* logits, void* bmax, void* bsum, int N, int D,
                                             int Vp, int vocab_size, int n_tile, int ctas,
                                             int stream_h, void* stream) {
  if (D % 16 || Vp % BLK || ctas < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return sk::with_row_tile(n_tile, [&](auto nt) -> int {
    return launch_sm90<decltype(nt)::value>(h, w, scale, logits, bmax, bsum, N, D, Vp,
                                            vocab_size, ctas, stream_h, st);
  });
}
