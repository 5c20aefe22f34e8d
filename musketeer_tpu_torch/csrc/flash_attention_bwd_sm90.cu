// K4's tensor-core launches (flash_bwd_sm90.cuh), compiled in a source of
// their own so that nvcc builds them beside flash_attention_bwd.cu (K4's
// entry point and FMA kernels), which launches them through
// launch_bwd_instance.
#include "flash_bwd_sm90.cuh"

namespace mk {
namespace sm90 {

int launch_bwd_instance(int dp, const void* q, const void* pq, const void* k, const void* pk,
                        const void* v, const void* rel, const void* kpad, const void* dout,
                        const float* lse, const float* dsum, void* dq, void* dpq, void* dk,
                        void* dpk, void* dv, float* drel_part, int B, int H, int Tq, int S,
                        long long rel_hs, long long rel_rs, int causal, int D,
                        cudaStream_t stream) {
  if (dp == DEEP)
    return launch_bwd_deep(q, pq, k, pk, v, rel, kpad, dout, lse, dsum, dq, dpq, dk, dpk, dv,
                           drel_part, B, H, Tq, S, rel_hs, rel_rs, causal, D, stream);
  return with_head_dim(dp, [&](auto d) -> int {
    constexpr int DP = decltype(d)::value;
    if constexpr (DP == DEEP) {
      return (int)cudaErrorInvalidValue;  // dp must be an instance
    } else {
      if (DP != dp) return (int)cudaErrorInvalidValue;  // dp must be an instance
      return launch_bwd<DP>(q, pq, k, pk, v, rel, kpad, dout, lse, dsum, dq, dpq, dk, dpk, dv,
                            drel_part, B, H, Tq, S, rel_hs, rel_rs, causal, D, stream);
    }
  });
}

}  // namespace sm90
}  // namespace mk
