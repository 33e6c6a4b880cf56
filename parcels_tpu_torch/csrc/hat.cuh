// Device helpers of the multilinear hat sampler K1.
//
// Every product and sum goes through the round-to-nearest intrinsics so the
// compiler cannot contract them into FMAs: the kernel then reproduces its
// plain PyTorch version (which rounds every operation) bit for bit, and a
// disagreement on the card is a fault, never a rounding difference.
#pragma once

#include <cuda_runtime.h>

namespace parcels {

// max(0, 1 - |c - p|); a NaN position propagates (as torch.clamp_min does)
__device__ __forceinline__ float hat(float c, float p) {
    float h = __fsub_rn(1.0f, fabsf(__fsub_rn(c, p)));
    return h < 0.0f ? 0.0f : h;
}

// Lower corner of a position's 2-point stencil, as a float that is safe to
// convert: NaN maps to 0 (its weights stay NaN), far-out positions are
// clamped to just outside [0, dim) so both corners read as invalid.
__device__ __forceinline__ float lower_corner(float p, int dim) {
    float f = floorf(p);
    if (isnan(f)) return 0.0f;
    return fminf(fmaxf(f, -2.0f), (float)dim);
}

}  // namespace parcels
