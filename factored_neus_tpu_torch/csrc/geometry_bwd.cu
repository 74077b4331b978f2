// K1-bwd-stash and K1-bwd-split: the f32 (3xTF32, mma.sync) entry points
// of the K1 backward kernel, whose body and notes are geometry_bwd.cuh.
// K1-bwd, the stacked call, is geometry_bwd_wg.cu on wgmma.
#include "geometry_bwd.cuh"

// Integer arguments: tc_dims_from_args'.  Pointers: [x, ct_out, ct_grad,
// ct_x, scratch, partials, grads, bf16 stash [n][sum of outs[0..L-2]],
// pack]; grads receives, per layer, dW as [in][out] followed by db [out];
// the scratch holds only the tangent pre-activations.  Returns a
// cudaError_t value.
extern "C" int geometry_bwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_bwd<BWD_STASH, false>(ia, p, scale, stream);
}

// Integer arguments as geometry_bwd_stash.  Pointers: [x, ct_out, ct_grad,
// ct_x, scratch, partials, grads, pack, b[L]]: K1-bwd's function, the two
// chains as separate 32-row products.
extern "C" int geometry_bwd_split(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_bwd<BWD_SPLIT, false>(ia, p, scale, stream);
}
