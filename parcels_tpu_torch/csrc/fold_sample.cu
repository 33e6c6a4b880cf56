// K1: direct multilinear (t, z, y, x) sample of a small field, one thread per lane.
//
// Replaces the JAX package's fold sampler
// parcels_tpu/ops/interp_kernels.py:_sample_kernel (launched by
// _pallas_sample), which contracts hat weights max(0, 1 - |i - p|) against a
// time window folded to (rows, X) on the TPU's matrix unit, because gathers
// are slow there. Here every lane reads its 16 stencil corners directly.
//
// Bound on the card: bytes. Each lane reads four f32 positions and writes one
// f32 (20 B); the field is at most 4 MB (the fold budget the dispatcher keeps,
// ops/interp_kernels.fits_fast_path) and stays resident in the 50 MB L2, so
// the corner reads hit L2 after the first touch. The design does no more than
// that: one coalesced pass over the positions, corner loads through the
// read-only path, no shared memory and no matrix unit.
//
// Semantics equal the hat contraction: a corner outside [0, dim) contributes
// nothing, so positions outside the field sample 0.
#include "hat.cuh"

namespace {

__global__ void __launch_bounds__(256) fold_sample_kernel(
    const float* __restrict__ data, int T, int Z, int Y, int X,
    const float* __restrict__ pt, const float* __restrict__ pz,
    const float* __restrict__ py, const float* __restrict__ px,
    float* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float p[4] = {pt[i], pz[i], py[i], px[i]};
    const int dims[4] = {T, Z, Y, X};
    int c0[4];
    float w[4][2];
    bool ok[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        float f = parcels::lower_corner(p[a], dims[a]);
        c0[a] = (int)f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            int c = c0[a] + k;
            w[a][k] = parcels::hat((float)c, p[a]);
            ok[a][k] = c >= 0 && c < dims[a];
        }
    }
    float acc = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
        for (int kz = 0; kz < 2; ++kz) {
#pragma unroll
            for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
                for (int kx = 0; kx < 2; ++kx) {
                    if (!(ok[0][kt] && ok[1][kz] && ok[2][ky] && ok[3][kx])) continue;
                    long long idx =
                        (((long long)(c0[0] + kt) * Z + (c0[1] + kz)) * Y + (c0[2] + ky)) * X +
                        (c0[3] + kx);
                    float wt = __fmul_rn(__fmul_rn(__fmul_rn(w[0][kt], w[1][kz]), w[2][ky]),
                                         w[3][kx]);
                    acc = __fadd_rn(acc, __fmul_rn(wt, __ldg(data + idx)));
                }
            }
        }
    }
    out[i] = acc;
}

}  // namespace

extern "C" int fold_sample_launch(const float* data, int T, int Z, int Y, int X,
                                  const float* pt, const float* pz, const float* py,
                                  const float* px, float* out, long long n, void* stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    fold_sample_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        data, T, Z, Y, X, pt, pz, py, px, out, n);
    return (int)cudaGetLastError();
}
