// K3-bwd: the 3xTF32 entry point of the radiance backward kernel
// (radiance_bwd.cuh), which replaces
// factored_neus_tpu/ops/pallas_radiance.py's _make_radiance.run_bwd (body
// _build_bwd_kernel).
#include "radiance_bwd.cuh"

// Arguments: launch_radiance_bwd's; the pack pack_weights'.
extern "C" int radiance_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  (void)scale;
  return launch_radiance_bwd<false>(ia, p, stream);
}
