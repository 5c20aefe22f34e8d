// K8: the fused ResNet bottleneck block (frozen BN, stride 1, no downsample),
// for sm_90a.
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
// Translation. The TPU kernel views the image as a flat pixel list, takes th
// whole image rows per grid cell plus one-row halo blocks, and forms conv2 as
// nine row-shifted dots with column-wrap masks (which Mosaic's sublane rule
// refused at W = 60 and 30). Here one block of 256 threads owns an 8 x 8 tile
// of output pixels of one image and its 10 x 10 halo, so any H and W work:
//   1. conv1 over the 100 halo pixels, streaming x through shared memory 32
//      channels at a time, 64 output channels per pass; h1 stays in shared
//      memory in T, which loses nothing (the TPU kernel rounds it to T);
//   2. conv2 as nine taps that read h1 in place at the shifted pixel, with
//      w2 streamed; h2 stays in shared memory in T;
//   3. conv3 streams its output over C, 64 channels at a time, and adds the
//      residual read from x.
// Only x is read from and the output written to device memory (the halo
// and the Wd/64 passes of conv1 re-read x, mostly from L2), and the weights.
// Each product is a 64 x 64 tile per pass, a 4 x 4 block of it per thread,
// on fp32 FMAs; widths pad to 64 with zeros, so any C and Wd work as long as
// h1 and h2 fit in shared memory (Wd <= 256 in fp32, <= 512 in bf16).
//
// Bound. At B16 every ofa_base stage block is ~32 G flop (2 B H W (2 C Wd +
// 9 Wd^2)); layer1 (120 x 120, C 256) must also move 236 MB of x and output.
// On the card's tensor cores that is ~0.03-0.07 ms a block; this first
// version runs the products on fp32 FMAs (~67 TFLOP/s peak), and repeats
// 56 % of conv1 for the halo (100 of 64 pixels, padded to 128 rows), so
// its floor is about 1 ms a block.
#include <stdint.h>

#include "common.cuh"

namespace {

using mk::from_f;
using mk::round_to;
using mk::to_f;

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

template <typename T>
size_t smem_bytes(int Wdp) {
  return (size_t)(NH + NP) * Wdp * sizeof(T) + (size_t)(MT * AS + KC * NC) * sizeof(float);
}

// Rows [k0, k0 + KC) and columns [n0, n0 + NC) of the row-major [K, N]
// matrix w, widened to fp32, into bs [KC][NC]; zeros past K and N.
template <typename T>
__device__ __forceinline__ void stage_w(float* bs, const T* __restrict__ w, int k0, int n0,
                                        int K, int N) {
  for (int i = threadIdx.x; i < KC * NC; i += NT) {
    const int r = i / NC, c = i % NC, kk = k0 + r, n = n0 + c;
    bs[i] = (kk < K && n < N) ? to_f(w[(long long)kk * N + n]) : 0.f;
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

// The folded frozen BN on a product rounded to T: fp32 y g + b, unfused as
// the TPU kernel and the plain version compute it.
template <typename T>
__device__ __forceinline__ float bn(float acc, float g, float b) {
  return __fadd_rn(__fmul_rn(round_to<T>(acc), g), b);
}

template <typename T>
__global__ void __launch_bounds__(NT) kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, const float* __restrict__ aff, T* __restrict__ out, int H, int W,
    int C, int Wd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wdp = round_up(Wd, NC);
  T* h1s = reinterpret_cast<T*>(smem_raw);                // [NH][Wdp] halo pixels
  T* h2s = h1s + NH * Wdp;                                // [NP][Wdp] output pixels
  float* as = reinterpret_cast<float*>(h2s + NP * Wdp);  // [MT][AS]  staged x
  float* bs = as + MT * AS;                               // [KC][NC]  staged weights

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, columns tx + 16 j
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const long long img = (long long)blockIdx.z * H * W * C;
  const T* xb = x + img;
  T* ob = out + img;
  const float* g1 = aff;
  const float* b1 = aff + Wd;
  const float* g2 = aff + 2 * Wd;
  const float* b2 = aff + 3 * Wd;
  const float* g3 = aff + 4 * Wd;
  const float* b3 = g3 + C;
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
            a = to_f(xb[((long long)iy * W + ix) * C + kk]);
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
          const float h = on_image && n < Wd ? fmaxf(bn<T>(acc[i][j], g1[n], b1[n]), 0.f) : 0.f;
          h1s[hp * Wdp + n] = from_f<T>(h);
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
      const T* w2t = w2 + (long long)tap * Wd * Wd;
      for (int k0 = 0; k0 < Wdp; k0 += KC) {
        __syncthreads();  // h1s complete; the previous step's bs reads are done
        stage_w(bs, w2t, k0, n0, Wd, Wd);
        __syncthreads();
        fma_tile([=](int i, int k) { return to_f(h1s[(hrow[i] + shift) * Wdp + k0 + k]); }, bs,
                 tx, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        const float h = n < Wd ? fmaxf(bn<T>(acc[i][j], g2[n], b2[n]), 0.f) : 0.f;
        h2s[(ty + 16 * i) * Wdp + n] = from_f<T>(h);
      }
  }

  // 3. conv3 + bn3, the residual and relu, 64 output channels per pass
  for (int n0 = 0; n0 < C; n0 += NC) {
    zero(acc);
    for (int k0 = 0; k0 < Wdp; k0 += KC) {
      __syncthreads();  // h2s complete; the previous step's bs reads are done
      stage_w(bs, w3, k0, n0, Wd, C);
      __syncthreads();
      fma_tile([=](int i, int k) { return to_f(h2s[(ty + 16 * i) * Wdp + k0 + k]); }, bs, tx,
               acc);
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
        const float y = round_to<T>(bn<T>(acc[i][j], g3[n], b3[n]));
        ob[o] = from_f<T>(fmaxf(round_to<T>(to_f(xb[o]) + y), 0.f));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, const void* w3, const float* aff,
           void* out, int B, int H, int W, int C, int Wd, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(round_up(Wd, NC));
  static mk::SmemOptIn opt_in;  // raised to the largest size launched so far
  if (const int err = opt_in.ensure((const void*)kernel<T>, smem)) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), aff, static_cast<T*>(out), H, W, C, Wd);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 x, weights and out, else float. x and out
// [B, H, W, C] (NHWC); w1 [C, Wd], w2 [3, 3, Wd, Wd] (HWIO), w3 [Wd, C]; aff
// fp32 g1, b1, g2, b2 (Wd each), g3, b3 (C each). Returns a CUDA error code.
extern "C" int mk_fused_bottleneck(int bf16, const void* x, const void* w1, const void* w2,
                                   const void* w3, const void* aff, void* out, int B, int H,
                                   int W, int C, int Wd, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(aff);
  if (bf16) return launch<__nv_bfloat16>(x, w1, w2, w3, a, out, B, H, W, C, Wd, st);
  return launch<float>(x, w1, w2, w3, a, out, B, H, W, C, Wd, st);
}
