// K7's cross-attention kernels (decode_attn_sm90.cuh), compiled in a source
// of their own so that nvcc builds them beside decode_stack.cu, which
// launches them through launch_instance.
#include "decode_attn_sm90.cuh"

namespace mk {
namespace decode_attn {

int launch_instance(int dp, const CacheMaps& maps, const Args& a, int chunked, int pdl,
                    cudaStream_t stream) {
  return with_head_dim(dp, [&](auto d) -> int {
    constexpr int DP = decltype(d)::value;
    if (DP != dp) return (int)cudaErrorInvalidValue;  // dp must be an instance
    return launch<DP>(maps, a, chunked, pdl, stream);
  });
}

}  // namespace decode_attn
}  // namespace mk
