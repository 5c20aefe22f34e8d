// K8's bf16 route on Hopper's tensor cores: the fused ResNet bottleneck
// block (frozen BN, stride 1, no downsample) as one implicit-GEMM kernel on
// wgmma, fed by TMA, with h1 and h2 kept in shared memory.
//
// Replaces, for bf16, the Pallas kernel musketeer_tpu/ops/bottleneck.py::
// _kernel (pallas_call at :162, reached by fused_bottleneck at :191), whose
// first port (bottleneck.cu's FMA kernel, which keeps fp32) ran every product
// on fp32 FMAs. It computes, for x [B, H, W, C] NHWC and width Wd,
//   h1  = bf16(relu(bf16(x . w1) g1 + b1)), 0 off the image       1x1, C -> Wd
//   h2  = bf16(relu(bf16(sum of 9 taps h1[+tap] . w2[tap]) g2 + b2))       3x3
//   y   = bf16(bf16(h2 . w3) g3 + b3)                             1x1, Wd -> C
//   out = relu(bf16(x + y))
// with every product summed in fp32 (the nine taps into one accumulator, so
// one rounding follows all nine) and the affines in fp32, unfused, as the
// TPU kernel rounds.
//
// Bound. Each block is 2 B H W (2 C Wd + 9 Wd^2) flop, 32.1 G at every
// ResNet-101 stage at B16 480^2: 0.0325 ms on the tensor cores, above the
// bytes (x read, out written: 0.035-0.070 ms at layer2 and layer1). The FMA
// kernel's floor was ~0.48 ms a block (67 TFLOP/s), so the design's first aim
// is to put the products on wgmma; the second is to keep the traffic that
// would then bind it (h1, h2, the weights) on chip or in L2.
//
// Design. A CTA owns 16 x 8 output pixels (128 rows: two m64 tiles) and their
// 18 x 10 halo (180 pixels), so conv1 is recomputed 1.41x for the halo, and
// each weight byte read serves 128 output pixels. One producer warp streams
// the tiles by TMA through a ring of 16 KB stages, as many as shared memory
// holds up to 8 (full and empty mbarriers; one arrival a consumer warp);
// two consumer warpgroups run the products and the epilogues. Each stage's
// wgmma group is left running while the next stage's is issued, so a
// warpgroup waits on the tensor cores only at the end of a product.
//   1. conv1. Each stage holds a 64-channel chunk of x's halo, copied from a
//      4-D tensor map over [B, H, W, C] with a (64 x 10 x 18 x 1) box (TMA
//      zero-fills the pixels off the image, so the edge needs no branch), and
//      the chunk of w1 [Wd, C] for up to 128 of h1's columns. The x chunks
//      (two slots) share their space with h2, which is written only after
//      conv1. The 180 (padded to 192) x 128-column product is six m64 x n64
//      units, three a warpgroup (n32 units where Wd is 64, so that both
//      warpgroups have three); Wd = 256 takes two passes over x (from L2).
//      The epilogue runs in registers: round, affine, relu, 0 off the image,
//      round, and writes h1 into shared memory.
//   2. conv2. h1 is laid out without swizzle as [Wd / 8][180 halo pixels][8]:
//      a core matrix (8 rows x 16 bytes) is then 8 neighbouring pixels of one
//      halo row. Each warpgroup's A operand (8 output rows of 8 pixels) at
//      tap (dy, dx) is one descriptor whose start moves by 16 (dy 10 + dx)
//      bytes, with the 8-row groups 160 bytes apart (SBO) and the channel
//      groups 180 x 16 bytes apart (LBO): the shifted views cost no copies
//      and no per-lane addresses, so the taps are plain wgmma from shared
//      memory (the alternative, ldmatrix + mma.sync with a row address a
//      lane, would leave the products on the older, slower path). All nine
//      taps accumulate into one fp32 accumulator per 128-column pass of w2.
//      h2 goes to shared memory in the same unswizzled layout, 128 rows.
//   3. conv3. A is the warpgroup's 64 rows of h2, B the w3 [C, Wd] chunks,
//      128 output channels a pass (64 at Wd 64). Each pass's output tile (32 KB, 128-byte
//      swizzled, in h1's dead space) first receives the pass's residual x by
//      TMA, a pass ahead where two tiles fit; the epilogue rounds, applies
//      the affine, rounds, adds the residual in bf16 and applies relu in
//      place, and TMA stores the tile. TMA zero-fills and drops the pixels and
//      channels off the image.
// Only x (conv1 and the residual), the weights and out cross device memory.
// The folded BN affines are copied into shared memory (g3 and b3 a pass's
// slice at a time), and each epilogue loads them, and the residual, for a few
// column groups before any of their stores: read from device memory between
// the stores (which the compiler may not reorder past), they made the
// epilogues several times longer than the products.
// Shared memory at Wd = 256: h1 92160 + h2 65536 + 4 ring stages of 16 KB +
// the affines 6 KB = 230 KB (8 stages at Wd 64 and 128); Wd <= 256. Widths
// are padded to 64 inside (TMA zero-fills w1 and w2's rows and x's channels
// past the end; h1 and h2's padded columns are written as zeros), so C and Wd
// need only be multiples of 8 (16-byte rows for TMA).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace mk {
namespace bneck {

using bf16 = __nv_bfloat16;

constexpr int TH = 16, TW = 8;              // output pixels of a CTA
constexpr int HWP = TW + 2;                 // halo tile width
constexpr int NH = (TH + 2) * HWP;          // 180 halo pixels
constexpr int NP = TH * TW;                 // 128 output pixels
constexpr int KC = 64;                      // depth of a chunk: one 128-byte swizzled row
constexpr int N3_MAX = 128;                 // conv3's output channels per pass (64 at Wd 64)
constexpr int NCW = 256;                    // consumer threads: two warpgroups
constexpr int NT = NCW + 32;                // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int NBARS = 2 * MAX_STAGES + 6;   // full, empty; x slots' empty; residual tiles' full
constexpr int NWARPS = NCW / 32;            // the empty barriers' arrivals: a consumer warp each
constexpr uint32_t WSTAGE = 128 * KC * 2;   // a ring stage: 128 weight rows x 64 deep
constexpr uint32_t XSLOT = 192 * KC * 2;    // an x chunk slot: 180 halo rows, padded to 192
constexpr uint32_t XBYTES = NH * KC * 2;    // what TMA writes of it

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// bytes of h1 ([Wdp / 8][NH][8]) and of the region h2 ([Wdp / 8][NP][8])
// shares with conv1's two x slots, each rounded to 1 KB
__host__ __device__ constexpr uint32_t h1_bytes(int Wdp) { return round_up(NH * Wdp * 2, 1024); }
__host__ __device__ constexpr uint32_t region_bytes(int Wdp) {
  return round_up(NP * Wdp * 2 > 2 * (int)XSLOT ? NP * Wdp * 2 : 2 * (int)XSLOT, 1024);
}
// the affines in shared memory: g1, b1, g2, b2 [Wdp] fp32, then each
// warpgroup's g3, b3 slice [N3_MAX] of the conv3 pass
__host__ __device__ constexpr uint32_t aff_bytes(int Wdp) { return 16 * Wdp + 2 * 2 * N3_MAX * 4; }
// conv3's output channels per pass of the kernel whose conv2 pass is nb wide
__host__ __device__ constexpr int n3_of(int nb) { return nb == 64 ? 64 : N3_MAX; }
// the whole dynamic shared memory (ops/bottleneck.py::sm90_smem restates it)
__host__ __device__ constexpr uint32_t smem_bytes(int Wdp, int stages) {
  return 1024 + h1_bytes(Wdp) + region_bytes(Wdp) + stages * WSTAGE + aff_bytes(Wdp) + 8 * NBARS;
}

// The folded frozen BN on a product rounded to bf16: fp32 y g + b, unfused.
__device__ __forceinline__ float bn(float acc, float g, float b) {
  return __fadd_rn(__fmul_rn(round_to<bf16>(acc), g), b);
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// xmap: x as [B, H, W, C] with (64, 10, 18, 1) boxes; w1map: w1 [Wd, C] as
// [1, Wd, C] with (64, 128) boxes; w2map: w2 [9, Wd, Wd] (tap, out, in) with
// (64, NB) boxes; w3map: w3 [C, Wd] as [1, C, Wd] with (64, n3_of(NB))
// boxes; rmap, omap: x and out [B, H, W, C] with (64, 8, 8, 1) boxes (a
// warpgroup's half of the tile: the residual in, the output out); all
// 128-byte swizzled. aff: fp32 g1, g2 (Wd each), g3 (C), then b1, b2, b3.
// NB: the columns of a conv2 pass, 128, or 64 where Wd <= 64; conv1's units
// are then n32 (six units cover Wd = 64, three a warpgroup), else n64, and
// two CTAs share an SM (at most 96 registers a thread: 18 warps leave a
// scheduler 5, of 16384 registers; two ring stages each), so that one's TMA
// waits and epilogues overlap the other's products: a Wd = 64 CTA does a
// tenth of a Wd = 256 one's products in phases as long.
template <int NB>
__global__ void __launch_bounds__(NT, NB == 64 ? 2 : 1) kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
    const __grid_constant__ CUtensorMap w2map, const __grid_constant__ CUtensorMap w3map,
    const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap omap,
    const float* __restrict__ aff, int H, int W, int C, int Wd, int stages) {
  constexpr int U1 = NB == 64 ? 32 : 64;  // columns of a conv1 unit
  constexpr int EG = NB == 64 ? 2 : 4;    // column groups an epilogue step loads, then stores
  constexpr int N3 = n3_of(NB), HALVES = N3 / 64;  // conv3's pass: its 64-channel halves
  extern __shared__ uint8_t smem_raw[];
  const int Wdp = round_up(Wd, KC);
  const int nbu = Wdp / U1;               // conv1's unit column blocks
  const int p1 = (nbu + 1) / 2;           // conv1's passes over x, two blocks each
  const int kc1 = (C + KC - 1) / KC;      // conv1's chunks (x's channels)
  const int kc2 = Wdp / KC;               // conv2's and conv3's chunks
  const int p2 = (Wdp + NB - 1) / NB;     // conv2's passes
  const int p3 = (C + N3 - 1) / N3;       // conv3's passes
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH, bi = blockIdx.z;

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);  // generic pointer of `base`
  const uint32_t h1 = base, reg = h1 + h1_bytes(Wdp), ring = reg + region_bytes(Wdp);
  const uint32_t affs = ring + stages * WSTAGE, bars = affs + aff_bytes(Wdp);
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (MAX_STAGES + st); };
  auto xempty = [=](int s) { return bars + 8u * (2 * MAX_STAGES + s); };
  // a warpgroup's residual tile in output buffer b
  auto rfull = [=](int w, int b) { return bars + 8u * (2 * MAX_STAGES + 2 + 2 * w + b); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), NWARPS);
    }
    sm90::mbar_init(xempty(0), NWARPS);
    sm90::mbar_init(xempty(1), NWARPS);
    for (int w = 0; w < 2; ++w)
      for (int b = 0; b < 2; ++b) sm90::mbar_init(rfull(w, b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCW) {  // the producer warp: every tile of the three products, in order
    if (tid == NCW) {
      int c = 0;
      auto acquire = [&]() {
        const int st = c % stages;
        if (c >= stages) sm90::mbar_wait(empty(st), ((c / stages) - 1) & 1);
        return st;
      };
      int cx = 0;
      for (int p = 0; p < p1; ++p)
        for (int k = 0; k < kc1; ++k, ++c, ++cx) {
          const int st = acquire(), xs = cx & 1;
          if (cx >= 2) sm90::mbar_wait(xempty(xs), ((cx >> 1) - 1) & 1);
          sm90::mbar_expect_tx(full(st), WSTAGE + XBYTES);
          sm90::tma_load3(ring + st * WSTAGE, &w1map, full(st), k * KC, p * 2 * U1, 0);
          sm90::tma_load4(reg + xs * XSLOT, &xmap, full(st), k * KC, tx0 - 1, ty0 - 1, bi);
        }
      for (int q = 0; q < p2; ++q)
        for (int t = 0; t < 9; ++t)
          for (int k = 0; k < kc2; ++k, ++c) {
            const int st = acquire();
            sm90::mbar_expect_tx(full(st), NB * KC * 2);
            sm90::tma_load3(ring + st * WSTAGE, &w2map, full(st), k * KC, q * NB, t);
          }
      for (int q = 0; q < p3; ++q)
        for (int k = 0; k < kc2; ++k, ++c) {
          const int st = acquire();
          sm90::mbar_expect_tx(full(st), N3 * KC * 2);
          sm90::tma_load3(ring + st * WSTAGE, &w3map, full(st), k * KC, q * N3, 0);
        }
    }
    return;  // no block-wide barrier follows
  }

  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = wt % 32;
  const int arow = 16 * warp + lane / 4;  // accumulator row (+ 8 hh) in the m64 tile
  const int acol = 2 * (lane % 4);        // accumulator column (+ 8 j + e)
  // The affines: g1, b1, g2, b2 copied once into shared memory (zero past
  // Wd), g3 and b3 a pass slice at a time (below). Each epilogue loads them,
  // and the residual, for EG column groups before any of their stores: a
  // load after a store through a generic pointer would wait for it.
  float* sa = reinterpret_cast<float*>(gen + (affs - base));
  for (int i = tid; i < 4 * Wdp; i += NCW) {
    const int v = i / Wdp, n = i % Wdp;  // v: g1, b1, g2, b2
    sa[i] = n < Wd ? __ldg(aff + (v % 2) * (2 * Wd + C) + (v / 2) * Wd + n) : 0.f;
  }
  float* s3 = sa + 4 * Wdp + wg * 2 * N3_MAX;  // this warpgroup's g3, b3 slice
  const float* g3 = aff + 2 * Wd;
  const float* b3 = g3 + C + 2 * Wd;
  sm90::named_sync(1, NCW);
  // The stages in the order the producer fills them. Each stage's products
  // are committed as one group and left running while the next stage's are
  // issued (wgmma_wait_n<1>): a stage is released once the group after it
  // has been committed, and the last one of a product after wgmma_wait().
  int c = 0, held = -1;
  auto wait_full = [&]() {
    const int st = c % stages;
    sm90::mbar_wait(full(st), (c / stages) & 1);
    return st;
  };
  auto release_held = [&]() {  // after the warp's wgmma wait: one arrival a warp
    if (held >= 0 && lane == 0) sm90::mbar_arrive(empty(held));
    held = -1;
  };

  // 1. conv1 + bn1 + relu over the halo into h1. Pass p covers the unit
  //    column blocks 2p, 2p + 1 of h1: units u = 6p + wg + 2s (m64 tile
  //    u % 3, block u / 3). A unit past the last (Wd = 192 leaves three) is
  //    computed on unit 0's operands and not stored, so that every stage
  //    issues the same wgmma with no branch between them.
  {
    int cx = 0;
    for (int p = 0; p < p1; ++p) {
      float acc[3][U1 / 2];
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int i = 0; i < U1 / 2; ++i) acc[s][i] = 0.f;
      uint32_t aoff[3], boff[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int u = 6 * p + wg + 2 * s;
        const bool live = u < 3 * nbu;
        aoff[s] = live ? (u % 3) * 64 * 128 : 0;
        boff[s] = live ? (u / 3 - 2 * p) * U1 * 128 : 0;
      }
      int held_x = -1;
      for (int k = 0; k < kc1; ++k, ++c, ++cx) {
        const int st = wait_full();
        const uint32_t xa = reg + (cx & 1) * XSLOT, wb = ring + st * WSTAGE;
        sm90::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::Wgmma<U1>::ss(acc[s], sm90::sw128_desc(xa + aoff[s] + 32 * kk),
                                sm90::sw128_desc(wb + boff[s] + 32 * kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait_n<1>();
        release_held();
        if (held_x >= 0 && lane == 0) sm90::mbar_arrive(xempty(held_x));
        held = st;
        held_x = cx & 1;
      }
      sm90::wgmma_wait();
#pragma unroll
      for (int s = 0; s < 3; ++s) sm90::fence_regs(acc[s]);
      release_held();
      if (lane == 0) sm90::mbar_arrive(xempty(held_x));
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int u = 6 * p + wg + 2 * s;
        if (u >= 3 * nbu) continue;
        const int m = u % 3, n = u / 3;
        float2 g[U1 / 8], bb[U1 / 8];
#pragma unroll
        for (int j = 0; j < U1 / 8; ++j) {
          const int col = U1 * n + 8 * j + acol;
          g[j] = *reinterpret_cast<const float2*>(sa + col);
          bb[j] = *reinterpret_cast<const float2*>(sa + Wdp + col);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 64 * m + arow + 8 * hh;  // halo pixel
          if (r >= NH) continue;
          const int iy = ty0 - 1 + r / HWP, ix = tx0 - 1 + r % HWP;
          const bool on_image = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
          for (int j = 0; j < U1 / 8; ++j) {
            const int col = U1 * n + 8 * j + acol;
            float v0 = 0.f, v1 = 0.f;
            if (on_image && col < Wd) {
              v0 = fmaxf(bn(acc[s][4 * j + 2 * hh], g[j].x, bb[j].x), 0.f);
              v1 = fmaxf(bn(acc[s][4 * j + 2 * hh + 1], g[j].y, bb[j].y), 0.f);
            }
            *reinterpret_cast<uint32_t*>(gen + ((col / 8) * NH + r) * 16 + (col % 8) * 2) =
                sm90::pack_bf16(v0, v1);
          }
        }
      }
    }
  }
  sm90::fence_async_smem();
  sm90::named_sync(1, NCW);  // h1 complete; conv1's x slots free for h2

  // 2. conv2 (3 x 3) + bn2 + relu into h2: nine taps, each a shifted
  //    descriptor over h1, into one accumulator per pass of NB columns
  for (int q = 0; q < p2; ++q) {
    float acc[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < 9; ++t) {
      const uint32_t a0 = h1 + 16u * ((8 * wg + t / 3) * HWP + t % 3);
      for (int k = 0; k < kc2; ++k, ++c) {
        const int st = wait_full();
        const uint32_t wb = ring + st * WSTAGE;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::Wgmma<NB>::ss(acc, sm90::interleave_desc(a0 + (8 * k + 2 * kk) * NH * 16,
                                                         NH * 16, HWP * 16),
                              sm90::sw128_desc(wb + 32 * kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait_n<1>();
        release_held();
        held = st;
      }
    }
    sm90::wgmma_wait();
    sm90::fence_regs(acc);
    release_held();
#pragma unroll
    for (int j0 = 0; j0 < NB / 8; j0 += EG) {
      float2 g[EG], bb[EG];
#pragma unroll
      for (int j = 0; j < EG; ++j) {
        const int col = min(q * NB + 8 * (j0 + j) + acol, Wdp - 2);
        g[j] = *reinterpret_cast<const float2*>(sa + 2 * Wdp + col);
        bb[j] = *reinterpret_cast<const float2*>(sa + 3 * Wdp + col);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pix = 64 * wg + arow + 8 * hh;
#pragma unroll
        for (int j = 0; j < EG; ++j) {
          const int col = q * NB + 8 * (j0 + j) + acol;
          if (col >= Wdp) continue;
          float v0 = 0.f, v1 = 0.f;
          if (col < Wd) {
            v0 = fmaxf(bn(acc[4 * (j0 + j) + 2 * hh], g[j].x, bb[j].x), 0.f);
            v1 = fmaxf(bn(acc[4 * (j0 + j) + 2 * hh + 1], g[j].y, bb[j].y), 0.f);
          }
          *reinterpret_cast<uint32_t*>(gen + (reg - base) +
                                       ((col / 8) * NP + pix) * 16 + (col % 8) * 2) =
              sm90::pack_bf16(v0, v1);
        }
      }
    }
  }
  sm90::fence_async_smem();
  sm90::named_sync(1, NCW);  // h2 complete; h1 free for conv3's output tiles

  // 3. conv3 + bn3, the residual and relu, N3 output channels a pass. Each
  //    pass's output tile (two 64-channel halves of [128 pixels][128 bytes],
  //    128-byte swizzled: conflict-free from the accumulators) first receives
  //    the pass's residual x by TMA, issued a pass ahead where two tiles fit
  //    (Wd >= 192), else as the previous pass's stores have read the tile;
  //    the epilogue turns it into the output in place and TMA stores it, one
  //    box a warpgroup and half. TMA zero-fills and drops the pixels and
  //    channels off the tensor. The tiles take h1's space (dead after conv2),
  //    or the region past h2 where h1 is smaller (Wd 64).
  const uint32_t a3 = reg + 64u * wg * 16;
  constexpr uint32_t OTILE = 2 * NP * 128;  // an output tile: 32 KB
  const uint32_t stg = Wdp == 64 ? reg + NP * 64 * 2 : h1;
  const int nbuf = Wdp >= 192 ? 2 : 1;
  const bool issuer = wt == 0;  // the thread that owns the warpgroup's bulk copies
  auto load_resid = [&](int q) {  // by the issuer, once the tile's last stores have read it
    const int b = q % nbuf;
    const uint32_t t = stg + b * OTILE + wg * (64 * 128);
    sm90::mbar_expect_tx(rfull(wg, b), HALVES * 64 * 128);
    for (int half = 0; half < HALVES; ++half)
      sm90::tma_load4(t + half * (NP * 128), &rmap, rfull(wg, b), q * N3 + 64 * half, tx0,
                      ty0 + 8 * wg, bi);
  };
  if (issuer) load_resid(0);
  for (int q = 0; q < p3; ++q) {
    const int c3 = q * N3 + wt;  // this thread's column of the pass's g3, b3 slice
    const float g3c = c3 < C ? __ldg(g3 + c3) : 0.f, b3c = c3 < C ? __ldg(b3 + c3) : 0.f;
    float acc[N3 / 2];
#pragma unroll
    for (int i = 0; i < N3 / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < kc2; ++k, ++c) {
      const int st = wait_full();
      const uint32_t wb = ring + st * WSTAGE;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<N3>::ss(acc, sm90::interleave_desc(a3 + (8 * k + 2 * kk) * NP * 16, NP * 16,
                                                       128),
                            sm90::sw128_desc(wb + 32 * kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_n<1>();
      release_held();
      held = st;
    }
    sm90::wgmma_wait();
    sm90::fence_regs(acc);
    release_held();
    if (nbuf == 2 && issuer && q + 1 < p3) {
      sm90::bulk_wait_read<0>();  // pass q - 1's stores have read the other tile
      load_resid(q + 1);
    }
    if (wt < N3) {  // the previous pass's epilogue has read the slice (barrier below)
      s3[wt] = g3c;
      s3[N3 + wt] = b3c;
    }
    const int b = q % nbuf;
    sm90::mbar_wait(rfull(wg, b), (q / nbuf) & 1);
    sm90::named_sync(2 + wg, 128);
    uint8_t* tile = gen + (stg - base) + b * OTILE;
    // tile row (pixel) 64 wg + arow + 8 hh, whose row % 8 is lane / 4; column
    // group jj: 16-byte unit jj % 8 of the 64-channel half jj / 8
    auto at = [&](int hh, int jj) {
      return reinterpret_cast<uint32_t*>(tile + (jj / 8) * (NP * 128) +
                                         (64 * wg + arow + 8 * hh) * 128 +
                                         (((jj % 8) ^ (lane / 4)) * 16) + 2 * acol);
    };
#pragma unroll
    for (int j0 = 0; j0 < N3 / 8; j0 += EG) {
      float2 g[EG], bb[EG];
      uint32_t xr[2][EG];
#pragma unroll
      for (int j = 0; j < EG; ++j) {
        g[j] = *reinterpret_cast<const float2*>(s3 + 8 * (j0 + j) + acol);
        bb[j] = *reinterpret_cast<const float2*>(s3 + N3 + 8 * (j0 + j) + acol);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) xr[hh][j] = *at(hh, j0 + j);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < EG; ++j) {
          const int i = 4 * (j0 + j) + 2 * hh;
          const float y0 = round_to<bf16>(bn(acc[i], g[j].x, bb[j].x));
          const float y1 = round_to<bf16>(bn(acc[i + 1], g[j].y, bb[j].y));
          *at(hh, j0 + j) = sm90::pack_bf16(fmaxf(round_to<bf16>(lo_f(xr[hh][j]) + y0), 0.f),
                                            fmaxf(round_to<bf16>(hi_f(xr[hh][j]) + y1), 0.f));
        }
    }
    sm90::fence_async_smem();
    sm90::named_sync(2 + wg, 128);
    if (issuer) {
      const uint32_t t = stg + b * OTILE + wg * (64 * 128);
#pragma unroll
      for (int half = 0; half < HALVES; ++half)
        if (q * N3 + 64 * half < C)
          sm90::tma_store4(&omap, t + half * (NP * 128), q * N3 + 64 * half, tx0, ty0 + 8 * wg,
                           bi);
      sm90::bulk_commit();
      if (nbuf == 1 && q + 1 < p3) {
        sm90::bulk_wait_read<0>();  // this pass's stores have read the tile
        load_resid(q + 1);
      }
    }
  }
  if (issuer) sm90::bulk_wait();
}

template <int NB>
int launch(const void* x, const void* w1, const void* w2, const void* w3, const float* aff,
           void* out, int B, int H, int W, int C, int Wd, int stages, cudaStream_t stream) {
  if (C % 8 || Wd % 8 || stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(round_up(Wd, KC), stages);
  CUtensorMap xm, m1, m2, m3, rm, om;
  const cuuint64_t ce = 2;  // bytes of a bf16
  {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {C * ce, (cuuint64_t)W * C * ce, (cuuint64_t)H * W * C * ce};
    const cuuint32_t box[4] = {KC, HWP, TH + 2, 1};
    if (const int err = sm90::bf16_map(&xm, x, 4, dims, strides, box)) return err;
    const cuuint32_t obox[4] = {KC, TW, TH / 2, 1};
    if (const int err = sm90::bf16_map(&rm, x, 4, dims, strides, obox)) return err;
    if (const int err = sm90::bf16_map(&om, out, 4, dims, strides, obox)) return err;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)Wd, 1};
    const cuuint64_t strides[2] = {C * ce, (cuuint64_t)Wd * C * ce};
    const cuuint32_t box[3] = {KC, 128, 1};
    if (const int err = sm90::bf16_map(&m1, w1, 3, dims, strides, box)) return err;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Wd, (cuuint64_t)Wd, 9};
    const cuuint64_t strides[2] = {Wd * ce, (cuuint64_t)Wd * Wd * ce};
    const cuuint32_t box[3] = {KC, NB, 1};
    if (const int err = sm90::bf16_map(&m2, w2, 3, dims, strides, box)) return err;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Wd, (cuuint64_t)C, 1};
    const cuuint64_t strides[2] = {Wd * ce, (cuuint64_t)C * Wd * ce};
    const cuuint32_t box[3] = {KC, n3_of(NB), 1};
    if (const int err = sm90::bf16_map(&m3, w3, 3, dims, strides, box)) return err;
  }
  static SmemOptIn opt_in;
  if (const int err = opt_in.ensure((const void*)kernel<NB>, smem)) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<NB><<<grid, NT, smem, stream>>>(xm, m1, m2, m3, rm, om, aff, H, W, C, Wd, stages);
  return (int)cudaGetLastError();
}

}  // namespace bneck
}  // namespace mk
