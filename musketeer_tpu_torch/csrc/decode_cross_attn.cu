// K6: one decode step of beam-shared cross-attention over the int8 K/V
// cache, for sm_90a.
//
// Replaces the Pallas kernel musketeer_tpu/ops/decode_cross_attn.py::
// decode_cross_attention_int8 (_kernel; pallas_call at :94). For each
// (sample, head) and the sample's Kb beams:
//   w = (q . k_i8^T) * k_scale + bias, pads -> -1e9, max clamped at -1e8,
//   p = e / max(sum e, 1e-38) * v_scale, out = round(p) . v_i8   (q's dtype)
// so a fully padded sample gives exact zeros. The 1e-38 floor is subnormal:
// the library is built without --use_fast_math, so it is not flushed.
//
// Translation. The TPU kernel runs one grid cell per sample with all H
// heads of its [H, S, D] int8 K/V in VMEM and one batched dot. Here one
// block of 256 threads owns one (head, sample): it reads that head's int8 K
// and V once for all Kb beams and widens them in registers; scores, the
// clamped softmax and the value sums are fp32 (csrc/cross_attn.cuh, shared
// with K7's cross-attention).
//
// Bound. At the caption decode shape (B16 H12 Kb5 S908 D64) a call must
// read 2 x 11.2 MB of int8 K/V plus 2 x 0.7 MB of scales and the bias row:
// ~24 MB, 7 us at 3.35 TB/s; its 2 x 0.45 G multiply-adds are ~1 us on the
// fp32 CUDA cores. It is bound by the bytes; 192 blocks fill the 132 SMs
// about 1.5 times, each streaming its 116 KB of K/V with 16-byte loads.
#include <stdint.h>

#include "common.cuh"
#include "cross_attn.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, const void* pad, void* out, int B, int H, int Kb, int S,
           long long bias_bs, long long bias_hs, cudaStream_t stream) {
  namespace ca = mk::cross_attn;
  ca::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(ks);
  a.v_scale = static_cast<const float*>(vs);
  a.bias = static_cast<const float*>(bias);
  a.pad = static_cast<const uint8_t*>(pad);
  a.out = out;
  a.H = H;
  a.Kb = Kb;
  a.S = S;
  a.q_bs = (long long)H * Kb * ca::D;  // q and out: [B, H, Kb, D]
  a.q_hs = (long long)Kb * ca::D;
  a.q_js = ca::D;
  a.bias_bs = bias_bs;
  a.bias_hs = bias_hs;
  return ca::launch<T, int8_t, true>(a, B, stream);
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 q and out, else float. k, v int8
// [B, H, S, 64]; scales fp32 [B, H, S]; bias fp32 with strides (bias_bs,
// bias_hs, 1); pad bool [B, S]. Returns a CUDA error code.
extern "C" int mk_decode_cross_attn_int8(int bf16, const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* bias, const void* pad, void* out, int B,
                                         int H, int Kb, int S, long long bias_bs,
                                         long long bias_hs, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, bias, pad, out, B, H, Kb, S, bias_bs,
                                 bias_hs, st);
  return launch<float>(q, k, v, k_scale, v_scale, bias, pad, out, B, H, Kb, S, bias_bs, bias_hs,
                       st);
}
