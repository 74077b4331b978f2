// K3-bwd-bf16: the bf16-operand entry point of the radiance backward
// kernel (radiance_bwd.cuh), which replaces
// factored_neus_tpu/ops/pallas_radiance.py's _make_radiance.run_bwd with
// bf16=True (body _build_bwd_kernel on _mm_fns(True)).
#include "radiance_bwd.cuh"

// Arguments: launch_radiance_bwd's; the pack pack_weights_bf16's.
extern "C" int radiance_bwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  (void)scale;
  return launch_radiance_bwd<true>(ia, p, stream);
}
