// K1-bwd-stash-bf16 and K1-bwd-split-bf16: the bf16-operand entry points
// of the K1 backward kernel (geometry_bwd.cuh) on mma.sync, which replace
// factored_neus_tpu/ops/pallas_geometry.py's _make_geom.run_bwd_stash and
// the stacked=False call with bf16=True (the bodies
// _build_bwd_kernel_from_stash and _build_bwd_kernel on
// _mm_fns(bf16=True)).  K1-bwd-bf16, the stacked call, is
// geometry_bwd_bf16_wg.cu on wgmma.
#include "geometry_bwd.cuh"

extern "C" int geometry_bwd_stash_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return launch_bwd<BWD_STASH>(ia, p, scale, stream);
}

extern "C" int geometry_bwd_split_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return launch_bwd<BWD_SPLIT>(ia, p, scale, stream);
}
