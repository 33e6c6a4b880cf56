// K2: binned slab sampler, one CTA per chunk of 1024 engine-sorted lanes.
//
// Replaces the JAX package's parcels_tpu/ops/binned_sample.py:_slab_kernel
// (launched by _run_kernel), which DMAs two bin slabs of an HBM-scale field
// into VMEM per chunk and contracts hat weights against them on the TPU's
// matrix unit in a bf16 hi/lo split.
//
// Bound on the card: bytes. Per lane the kernel reads four f32 positions and
// writes one f32; per chunk it stages field windows. Random 16-corner gathers
// over a field larger than the 50 MB L2 would fetch a 32 B sector per corner;
// sorted lanes instead share windows, so the design stages each sub-block's
// (WT, WZ, SY, SX) window into shared memory with coalesced (16-byte where
// the layout allows) loads, and every lane samples its 16 corners from there
// in f32. A sub-block whose window equals the previous one's reuses it. The
// planner (ops/binned_sample.py) keeps the window under the block's shared
// memory and aligns x origins to 4 floats.
//
// Plan inputs (per chunk g, per 128-lane sub-block s): t0[g]; slab origins
// (z1, y1, x1) and (z2, y2, x2)[g]; shalf[g*NS+s] picks the slab half;
// z0w[g*NS+s] offsets the z window inside it; live[g] == 0 marks a chunk with
// no live lane, which writes 0. Positions are relative to each lane's own
// slab origin. Lanes outside their sub-block's window keep the partial sum of
// the corners inside it; the plan flags them as overflow and the caller
// repairs them with a plain gather.
#include "hat.cuh"

namespace {

constexpr int LANE = 128;

__global__ void __launch_bounds__(LANE) slab_sample_kernel(
    const float* __restrict__ data, int T, int Z, int Y, int X,
    const int* __restrict__ t0, const int* __restrict__ z1, const int* __restrict__ y1,
    const int* __restrict__ x1, const int* __restrict__ z2, const int* __restrict__ y2,
    const int* __restrict__ x2, const int* __restrict__ shalf, const int* __restrict__ z0w,
    const int* __restrict__ live, const float* __restrict__ pt, const float* __restrict__ pz,
    const float* __restrict__ py, const float* __restrict__ px, float* __restrict__ out,
    int WT, int WZ, int SY, int SX, int NS, int vec4) {
    extern __shared__ float4 win4[];
    float* win = reinterpret_cast<float*>(win4);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const long long base = (long long)g * NS * LANE;

    if (live[g] == 0) {
        for (int s = 0; s < NS; ++s) out[base + s * LANE + tid] = 0.0f;
        return;
    }

    const int tt0 = t0[g];
    const int rows = WT * WZ * SY;
    int prev_h = -1, prev_zw = -1;
    for (int s = 0; s < NS; ++s) {
        const int h = shalf[g * NS + s];
        const int zw = z0w[g * NS + s];
        if (h != prev_h || zw != prev_zw) {
            __syncthreads();  // every lane is done with the previous window
            const int zo = (h ? z2[g] : z1[g]) + zw;
            const int yo = h ? y2[g] : y1[g];
            const int xo = h ? x2[g] : x1[g];
            if (vec4) {
                const int sx4 = SX >> 2;
                const int total = rows * sx4;
                for (int k = tid; k < total; k += LANE) {
                    const int r = k / sx4, c = k - r * sx4;
                    const int t = r / (WZ * SY), z = (r / SY) % WZ, y = r % SY;
                    const long long src =
                        (((long long)(tt0 + t) * Z + (zo + z)) * Y + (yo + y)) * X + xo;
                    win4[k] = __ldg(reinterpret_cast<const float4*>(data + src) + c);
                }
            } else {
                const int total = rows * SX;
                for (int k = tid; k < total; k += LANE) {
                    const int r = k / SX, c = k - r * SX;
                    const int t = r / (WZ * SY), z = (r / SY) % WZ, y = r % SY;
                    const long long src =
                        (((long long)(tt0 + t) * Z + (zo + z)) * Y + (yo + y)) * X + xo + c;
                    win[k] = __ldg(data + src);
                }
            }
            __syncthreads();
            prev_h = h;
            prev_zw = zw;
        }

        const long long i = base + s * LANE + tid;
        const float p[4] = {pt[i], __fsub_rn(pz[i], (float)zw), py[i], px[i]};
        const int ext[4] = {WT, WZ, SY, SX};
        int c0[4];
        float w[4][2];
        bool ok[4][2];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            float f = parcels::lower_corner(p[a], ext[a]);
            c0[a] = (int)f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                int c = c0[a] + k;
                w[a][k] = parcels::hat((float)c, p[a]);
                ok[a][k] = c >= 0 && c < ext[a];
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
                        const int r = ((c0[0] + kt) * WZ + (c0[1] + kz)) * SY + (c0[2] + ky);
                        float wt = __fmul_rn(
                            __fmul_rn(__fmul_rn(w[0][kt], w[1][kz]), w[2][ky]), w[3][kx]);
                        acc = __fadd_rn(acc, __fmul_rn(wt, win[r * SX + c0[3] + kx]));
                    }
                }
            }
        }
        out[i] = acc;
    }
}

}  // namespace

extern "C" int slab_sample_launch(const float* data, int T, int Z, int Y, int X, const int* t0,
                                  const int* z1, const int* y1, const int* x1, const int* z2,
                                  const int* y2, const int* x2, const int* shalf, const int* z0w,
                                  const int* live, const float* pt, const float* pz,
                                  const float* py, const float* px, float* out, int G, int WT,
                                  int WZ, int SY, int SX, int NS, int vec4, void* stream) {
    const size_t smem = (size_t)WT * WZ * SY * SX * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        slab_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    slab_sample_kernel<<<G, LANE, smem, (cudaStream_t)stream>>>(
        data, T, Z, Y, X, t0, z1, y1, x1, z2, y2, x2, shalf, z0w, live, pt, pz, py, px, out, WT,
        WZ, SY, SX, NS, vec4);
    return (int)cudaGetLastError();
}
