// K8: the fused ResNet bottleneck block (frozen BN, stride 1, no downsample),
// for sm_90a. fp32 runs the FMA kernel of this file; bf16 runs the
// tensor-core kernel of bottleneck_sm90.cuh (wgmma fed by TMA, h1 and h2 in
// shared memory), which has its own note.
//
// Replaces the Pallas kernel musketeer_tpu/ops/bottleneck.py::_kernel
// (pallas_call at :162 in _fused_forward, reached by fused_bottleneck). For an
// NHWC image x [B, H, W, C], width Wd, compute type T:
//   h1  = round_T(relu(round_T(x . w1) g1 + b1))                  1x1, C -> Wd
//   h2  = round_T(relu(round_T(sum_taps h1[+tap] . w2[tap]) g2 + b2))   3x3
//   y   = round_T(round_T(h2 . w3) g3 + b3)                       1x1, Wd -> C
//   out = relu(round_T(x + y))
// with the products summed in fp32 and frozen BN folded to fp32 affines
// (g, b), as the TPU kernel rounds. conv2's zero padding applies to h1 after
// bn1 and relu: halo pixels off the image hold h1 = 0, not relu(b1).
//
// The FMA kernel (fp32). The TPU kernel views the image as a flat pixel
// list, takes th whole image rows per grid cell plus one-row halo blocks, and
// forms conv2 as nine row-shifted dots with column-wrap masks (which Mosaic's
// sublane rule refused at W = 60 and 30). Here one block of 256 threads owns
// an 8 x 8 tile of output pixels of one image and its 10 x 10 halo, so any H
// and W work:
//   1. conv1 over the 100 halo pixels, streaming x through shared memory 32
//      channels at a time, 64 output channels per pass; h1 stays in shared
//      memory;
//   2. conv2 as nine taps that read h1 in place at the shifted pixel, with
//      w2 streamed; h2 stays in shared memory;
//   3. conv3 streams its output over C, 64 channels at a time, and adds the
//      residual read from x.
// Only x is read from and the output written to device memory (the halo
// and the Wd/64 passes of conv1 re-read x, mostly from L2), and the weights.
// Each product is a 64 x 64 tile per pass, a 4 x 4 block of it per thread,
// on fp32 FMAs; widths pad to 64 with zeros, so any C and Wd work as long as
// h1 and h2 fit in shared memory (Wd <= 320).
//
// Bound. At B16 every ofa_base stage block is ~32 G flop (2 B H W (2 C Wd +
// 9 Wd^2)); layer1 (120 x 120, C 256) must also move 236 MB of x and output.
// On fp32 FMAs (~67 TFLOP/s peak), repeating 56 % of conv1 for the halo
// (100 of 64 pixels, padded to 128 rows), its floor is about 1 ms a block.
#include <stdint.h>

#include "bottleneck_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 8;      // output pixels of a block
constexpr int HW = TW + 2;         // halo tile width
constexpr int NH = (TH + 2) * HW;  // 100 halo pixels
constexpr int NP = TH * TW;        // 64 output pixels
constexpr int MT = 64;             // product rows per pass
constexpr int NC = 64;             // product columns per pass
constexpr int KC = 32;             // depth staged per step
constexpr int NT = 256;            // 16 x 16 threads, each a 4 x 4 block
constexpr int AS = KC + 1;         // staged x row stride (floats)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t smem_bytes(int Wdp) {
  return ((size_t)(NH + NP) * Wdp + MT * AS + KC * NC) * sizeof(float);
}

// Rows [k0, k0 + KC) and columns [n0, n0 + NC) of the row-major [K, N]
// matrix w into bs [KC][NC]; zeros past K and N.
__device__ __forceinline__ void stage_w(float* bs, const float* __restrict__ w, int k0, int n0,
                                        int K, int N) {
  for (int i = threadIdx.x; i < KC * NC; i += NT) {
    const int r = i / NC, c = i % NC, kk = k0 + r, n = n0 + c;
    bs[i] = (kk < K && n < N) ? w[(long long)kk * N + n] : 0.f;
  }
}

// The FMA step of one staged depth: acc[i][j] += a(ty + 16 i, k) bs[k][tx + 16 j].
template <typename A>
__device__ __forceinline__ void fma_tile(A a_at, const float* bs, int tx, float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_at(i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = bs[k * NC + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The folded frozen BN: fp32 y g + b, unfused as the TPU kernel and the
// plain version compute it.
__device__ __forceinline__ float bn(float acc, float g, float b) {
  return __fadd_rn(__fmul_rn(acc, g), b);
}

__global__ void __launch_bounds__(NT) kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w3, const float* __restrict__ aff, float* __restrict__ out, int H,
    int W, int C, int Wd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wdp = round_up(Wd, NC);
  float* h1s = reinterpret_cast<float*>(smem_raw);  // [NH][Wdp] halo pixels
  float* h2s = h1s + NH * Wdp;                       // [NP][Wdp] output pixels
  float* as = h2s + NP * Wdp;                        // [MT][AS]  staged x
  float* bs = as + MT * AS;                          // [KC][NC]  staged weights

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, columns tx + 16 j
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const long long img = (long long)blockIdx.z * H * W * C;
  const float* xb = x + img;
  float* ob = out + img;
  const float* g1 = aff;
  const float* g2 = aff + Wd;
  const float* g3 = aff + 2 * Wd;
  const float* b1 = g3 + C;
  const float* b2 = b1 + Wd;
  const float* b3 = b1 + 2 * Wd;
  float acc[4][4];

  // 1. conv1 + bn1 + relu over the halo pixels (image row y0 - 1 + hp / HW,
  //    column x0 - 1 + hp % HW); zero off the image and past Wd
  for (int m0 = 0; m0 < NH; m0 += MT) {
    for (int n0 = 0; n0 < Wdp; n0 += NC) {
      zero(acc);
      for (int k0 = 0; k0 < C; k0 += KC) {
        __syncthreads();  // the previous step's as/bs reads are done
        for (int i = tid; i < MT * KC; i += NT) {
          const int r = i / KC, c = i % KC, hp = m0 + r, kk = k0 + c;
          const int iy = y0 - 1 + hp / HW, ix = x0 - 1 + hp % HW;
          float a = 0.f;
          if (hp < NH && iy >= 0 && iy < H && ix >= 0 && ix < W && kk < C)
            a = xb[((long long)iy * W + ix) * C + kk];
          as[r * AS + c] = a;
        }
        stage_w(bs, w1, k0, n0, C, Wd);
        __syncthreads();
        fma_tile([=](int i, int k) { return as[(ty + 16 * i) * AS + k]; }, bs, tx, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hp = m0 + ty + 16 * i;
        if (hp >= NH) continue;
        const int iy = y0 - 1 + hp / HW, ix = x0 - 1 + hp % HW;
        const bool on_image = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          h1s[hp * Wdp + n] = on_image && n < Wd ? fmaxf(bn(acc[i][j], g1[n], b1[n]), 0.f) : 0.f;
        }
      }
    }
  }

  // 2. conv2 (3 x 3) + bn2 + relu: the nine taps sum in fp32 before one rounding
  int hrow[4];  // halo pixel of output pixel ty + 16 i at tap (0, 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    hrow[i] = (p / TW) * HW + p % TW;
  }
  for (int n0 = 0; n0 < Wdp; n0 += NC) {
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HW + tap % 3;
      const float* w2t = w2 + (long long)tap * Wd * Wd;
      for (int k0 = 0; k0 < Wdp; k0 += KC) {
        __syncthreads();  // h1s complete; the previous step's bs reads are done
        stage_w(bs, w2t, k0, n0, Wd, Wd);
        __syncthreads();
        fma_tile([=](int i, int k) { return h1s[(hrow[i] + shift) * Wdp + k0 + k]; }, bs, tx,
                 acc);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        h2s[(ty + 16 * i) * Wdp + n] = n < Wd ? fmaxf(bn(acc[i][j], g2[n], b2[n]), 0.f) : 0.f;
      }
  }

  // 3. conv3 + bn3, the residual and relu, 64 output channels per pass
  for (int n0 = 0; n0 < C; n0 += NC) {
    zero(acc);
    for (int k0 = 0; k0 < Wdp; k0 += KC) {
      __syncthreads();  // h2s complete; the previous step's bs reads are done
      stage_w(bs, w3, k0, n0, Wd, C);
      __syncthreads();
      fma_tile([=](int i, int k) { return h2s[(ty + 16 * i) * Wdp + k0 + k]; }, bs, tx, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i, iy = y0 + p / TW, ix = x0 + p % TW;
      if (iy >= H || ix >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= C) continue;
        const long long o = ((long long)iy * W + ix) * C + n;
        ob[o] = fmaxf(xb[o] + bn(acc[i][j], g3[n], b3[n]), 0.f);
      }
    }
  }
}

int launch(const void* x, const void* w1, const void* w2, const void* w3, const float* aff,
           void* out, int B, int H, int W, int C, int Wd, cudaStream_t stream) {
  const size_t smem = smem_bytes(round_up(Wd, NC));
  static mk::SmemOptIn opt_in;  // raised to the largest size launched so far
  if (const int err = opt_in.ensure((const void*)kernel, smem)) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(w3), aff, static_cast<float*>(out), H, W, C, Wd);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// The folded frozen BNs of a block, bn [scale | var | bias | mean] (each n =
// 2 Wd + C: bn1, bn2, bn3) -> aff [g | b], g = scale rsqrt(var + eps) and
// b = bias - mean g in fp32, unfused: ops/bottleneck.py::fold_bn's
// arithmetic, which torch runs as separate launches (rsqrt is rsqrtf there
// too; chip_smoke.py holds the two equal bit for bit).
__global__ void fold_bn_kernel(const float* __restrict__ bn, float* __restrict__ aff, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float g = __fmul_rn(bn[i], rsqrtf(__fadd_rn(bn[n + i], 1e-5f)));
  aff[i] = g;
  aff[n + i] = __fsub_rn(bn[2 * n + i], __fmul_rn(bn[3 * n + i], g));
}

}  // namespace

// bn [scale | var | bias | mean] fp32, each n long -> aff [g | b] (the
// affines both K8 kernels read). Returns a CUDA error code.
extern "C" int mk_fold_bn(const void* bn, void* aff, int n, void* stream) {
  fold_bn_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bn), static_cast<float*>(aff), n);
  return (int)cudaGetLastError();
}

// bf16 != 0: the tensor-core kernel (bottleneck_sm90.cuh) on __nv_bfloat16 x,
// weights and out, w1 [Wd, C], w2 [3, 3, Wd, Wd] (tap, out, in), w3 [C, Wd]
// (each K-major: wgmma's B operand), nb (64 or 128) columns a conv2 / conv3
// pass and `stages` ring stages (ops/bottleneck.py::sm90_plan). Else the FMA
// kernel on float, w1 [C, Wd], w2 [3, 3, Wd, Wd] (HWIO), w3 [Wd, C]; nb and
// stages unused. x and out [B, H, W, C] (NHWC); aff fp32 g1, g2 (Wd each), g3
// (C), then b1, b2, b3 alike. Returns a CUDA error code.
extern "C" int mk_fused_bottleneck(int bf16, const void* x, const void* w1, const void* w2,
                                   const void* w3, const void* aff, void* out, int B, int H,
                                   int W, int C, int Wd, int nb, int stages, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(aff);
  if (!bf16) return launch(x, w1, w2, w3, a, out, B, H, W, C, Wd, st);
  if (nb == 128)
    return mk::bneck::launch<128>(x, w1, w2, w3, a, out, B, H, W, C, Wd, stages, st);
  if (nb == 64) return mk::bneck::launch<64>(x, w1, w2, w3, a, out, B, H, W, C, Wd, stages, st);
  return (int)cudaErrorInvalidValue;
}
