// K1: forward-only attention with decomposed positional bias, and K3, the
// training forward, for sm_90a.
//
// Replaces the Pallas kernels musketeer_tpu/ops/flash_attention_infer.py::
// flash_attention_inference (_kernel; pallas_call at :143) and
// musketeer_tpu/ops/flash_attention_bwd.py::_fwd (_fwd_kernel; pallas_call
// at :265). bf16 streams run on the tensor-core core of flash_fwd_sm90.cuh
// (wgmma fed by TMA); fp32 streams on the FMA core of flash_fwd.cuh (K3 also
// writes the per-row logsumexp); past head dim 256 fp32 runs on the deep
// route of flash_deep.cuh. The files describe the numerics, the translation
// from the TPU and what bounds the call. K4 is in flash_attention_bwd.cu.
#include "flash_deep.cuh"
#include "flash_fwd.cuh"
#include "flash_fwd_sm90.cuh"

// bf16 != 0 selects __nv_bfloat16 streams, else float. rel may be null
// (cross attention); kpad is bool [B, S]; head_dim is a multiple of 8
// (common.cuh::with_head_dim). Returns cudaGetLastError().
extern "C" int mk_flash_attention_infer(int bf16, const void* q, const void* pos_q,
                                        const void* k, const void* pos_k, const void* v,
                                        const void* rel, const void* kpad, void* out, int B,
                                        int H, int Tq, int S, long long rel_head_stride,
                                        long long rel_row_stride, int causal, int skip_max,
                                        int head_dim, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return mk::with_head_dim(head_dim, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    if (bf16)
      return mk::sm90::launch<DP, false, __nv_bfloat16>(q, pos_q, k, pos_k, v, rel, kpad, out,
                                                        nullptr, B, H, Tq, S, S, rel_head_stride,
                                                        rel_row_stride, causal, skip_max,
                                                        head_dim, st);
    if constexpr (DP == mk::DEEP)
      return mk::flash_deep::launch_fwd<mk::flash_deep::K1>(
          q, pos_q, k, pos_k, v, rel, kpad, out, nullptr, B, H, Tq, S, S, rel_head_stride,
          rel_row_stride, causal, skip_max, head_dim, st);
    else
      return mk::flash_fwd::launch<DP, float, false>(q, pos_q, k, pos_k, v, rel, kpad, out,
                                                     nullptr, B, H, Tq, S, rel_head_stride,
                                                     rel_row_stride, causal, skip_max, head_dim,
                                                     st);
  });
}

// K3 (flash_attention_bwd.py's ``_fwd``): K1's walk plus each row's fp32
// logsumexp in lse [B, H, Tq], on the same cores, so that its bf16 kernels
// are K1's instances, compiled once. bf16 != 0 selects __nv_bfloat16
// streams, else float. rel may be null (cross attention); kpad is bool
// [B, S]; head_dim is a multiple of 8 (common.cuh::with_head_dim).
extern "C" int mk_flash_attention_fwd(int bf16, const void* q, const void* pos_q,
                                      const void* k, const void* pos_k, const void* v,
                                      const void* rel, const void* kpad, void* out, void* lse,
                                      int B, int H, int Tq, int S, long long rel_head_stride,
                                      long long rel_row_stride, int causal, int skip_max,
                                      int head_dim, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  const int D = head_dim;
  return mk::with_head_dim(head_dim, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    if (bf16)
      return mk::sm90::launch<DP, false, __nv_bfloat16>(q, pos_q, k, pos_k, v, rel, kpad, out, l,
                                                        B, H, Tq, S, S, rel_head_stride,
                                                        rel_row_stride, causal, skip_max, D, st);
    if constexpr (DP == mk::DEEP)
      return mk::flash_deep::launch_fwd<mk::flash_deep::K3>(q, pos_q, k, pos_k, v, rel, kpad,
                                                            out, l, B, H, Tq, S, S,
                                                            rel_head_stride, rel_row_stride,
                                                            causal, skip_max, D, st);
    else
      return mk::flash_fwd::launch<DP, float, true>(q, pos_q, k, pos_k, v, rel, kpad, out, l, B,
                                                    H, Tq, S, rel_head_stride, rel_row_stride,
                                                    causal, skip_max, D, st);
  });
}
