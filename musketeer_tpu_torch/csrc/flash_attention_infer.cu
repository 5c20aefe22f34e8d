// K1: forward-only attention with decomposed positional bias, for sm_90a.
//
// Replaces the Pallas kernel musketeer_tpu/ops/flash_attention_infer.py::
// flash_attention_inference (_kernel; pallas_call at :143). The kernel, its
// numerics, its translation from the TPU and what bounds it are described in
// flash_fwd.cuh, which K3 shares (K3 also writes the per-row logsumexp).
#include "flash_fwd.cuh"

// bf16 != 0 selects __nv_bfloat16 streams, else float. rel may be null
// (cross attention); kpad is bool [B, S]. Returns cudaGetLastError().
extern "C" int mk_flash_attention_infer(int bf16, const void* q, const void* pos_q,
                                        const void* k, const void* pos_k, const void* v,
                                        const void* rel, const void* kpad, void* out, int B,
                                        int H, int Tq, int S, long long rel_head_stride,
                                        long long rel_row_stride, int causal, int skip_max,
                                        void* stream) {
  using mk::flash_fwd::launch;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false>(q, pos_q, k, pos_k, v, rel, kpad, out, nullptr, B, H,
                                        Tq, S, rel_head_stride, rel_row_stride, causal,
                                        skip_max, st);
  return launch<float, false>(q, pos_q, k, pos_k, v, rel, kpad, out, nullptr, B, H, Tq, S,
                              rel_head_stride, rel_row_stride, causal, skip_max, st);
}
