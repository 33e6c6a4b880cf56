// K1: direct multilinear (t, z, y, x) sample of a small field.
//
// Replaces the JAX package's fold sampler
// parcels_tpu/ops/interp_kernels.py:_sample_kernel (launched by
// _pallas_sample), which contracts hat weights max(0, 1 - |i - p|) against a
// time window folded to (rows, X) on the TPU's matrix unit, because gathers
// are slow there. Here every lane reads its stencil corners directly.
//
// What bounds it on the card: the field is at most 4 MB per time window (the
// fold budget the dispatcher keeps, ops/interp_kernels.fits_fast_path), and
// at the K1 path's shape (24, 1, 256, 1000) all 24.6 MB of it stay in the
// 50 MB L2, so after the first touch the bytes are cheap. What costs is the
// scatter of a warp's corner loads: lanes at random cells make every load
// instruction ask L2 for up to 32 sectors, and the same lanes sorted by cell
// sample in half the time (chip_smoke.py phase 2, H100 80GB HBM3 at 700 W).
// The design cuts the load instructions and requests a lane issues:
//
// - each (t, z, y) row pair (x0, x0 + 1) is one 16-byte load of the aligned
//   float4 that holds x0, plus a 4-byte load of x0 + 1 only when x0 % 4 == 3
//   (and plain 4-byte loads at a row end, or where the field's base is not
//   16-byte aligned); a row is addressed through the flat element index, so
//   X % 4 != 0 needs no special case;
// - degenerate axes (T == 1, Z == 1) are template parameters, so a surface
//   field issues 4 row loads a lane instead of 8 predicated ones;
// - offsets are 32-bit when the field has fewer than 2^31 elements;
// - one lane a thread: running 2 or 4 lanes a thread, all their loads
//   issued before the sums, was slower on the H100 at 700 W (PERF.md), since
//   it raised the registers a thread holds more than the loads in flight.
//
// Semantics equal the hat contraction: a corner outside [0, dim) contributes
// nothing, so positions outside the field sample 0. The sum keeps hat.cuh's
// order (t, z, y, x corners, each weight ((wt * wz) * wy) * wx), so the
// kernel equals its plain version (ops/interp_kernels.fold_sample_plain) bit
// for bit.
#include "hat.cuh"

namespace {

constexpr int THREADS = 256;

// Stencil of one axis: lower corner, two weights, two validity flags. A
// degenerate axis (extent 1) has one candidate corner, 0: it is valid when
// either stencil corner is 0, with weight hat(0, p).
template <bool DEGENERATE>
__device__ __forceinline__ void stencil(float p, int dim, int& c0, float (&w)[2], bool (&ok)[2]) {
    const float f = parcels::lower_corner(p, dim);
    c0 = (int)f;
    if (DEGENERATE) {
        w[0] = parcels::hat(0.0f, p);
        ok[0] = c0 == 0 || c0 == -1;
        c0 = 0;
        return;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int c = c0 + k;
        w[k] = parcels::hat((float)c, p);
        ok[k] = c >= 0 && c < dim;
    }
}

__device__ __forceinline__ float pick(const float4& q, int r) {
    return r == 0 ? q.x : r == 1 ? q.y : r == 2 ? q.z : q.w;
}

// Elements e (if ok0) and e + 1 (if ok1) of the flat field; 0 where not read.
template <bool VEC, typename Idx>
__device__ __forceinline__ float2 load_pair(const float* __restrict__ data, Idx e, bool ok0,
                                            bool ok1, Idx nelem) {
    float2 v = make_float2(0.0f, 0.0f);
    if (VEC && ok0 && ok1) {
        const Idx b = e & ~Idx(3);
        if (b + 4 <= nelem) {
            const int r = (int)(e - b);
            const float4 q = __ldg(reinterpret_cast<const float4*>(data + b));
            v.x = pick(q, r);
            v.y = r == 3 ? __ldg(data + e + 1) : pick(q, r + 1);
            return v;
        }
    }
    if (ok0) v.x = __ldg(data + e);
    if (ok1) v.y = __ldg(data + e + 1);
    return v;
}

template <bool T1, bool Z1, bool VEC, typename Idx>
__global__ void __launch_bounds__(THREADS) fold_sample_kernel(
    const float* __restrict__ data, int T, int Z, int Y, int X,
    const float* __restrict__ pt, const float* __restrict__ pz,
    const float* __restrict__ py, const float* __restrict__ px,
    float* __restrict__ out, long long n) {
    constexpr int NT = T1 ? 1 : 2, NZ = Z1 ? 1 : 2;
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Idx nelem = (Idx)T * Z * Y * X;

    int c0[4];
    float w[4][2];
    bool ok[4][2];
    stencil<T1>(pt[i], T, c0[0], w[0], ok[0]);
    stencil<Z1>(pz[i], Z, c0[1], w[1], ok[1]);
    stencil<false>(py[i], Y, c0[2], w[2], ok[2]);
    stencil<false>(px[i], X, c0[3], w[3], ok[3]);
    // every row pair's loads are issued before the sum
    float2 v[NT][NZ][2];
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
        for (int kz = 0; kz < NZ; ++kz) {
#pragma unroll
            for (int ky = 0; ky < 2; ++ky) {
                const bool row = ok[0][kt] && ok[1][kz] && ok[2][ky];
                const Idx e = row ? (((Idx)(c0[0] + kt) * Z + (c0[1] + kz)) * Y + (c0[2] + ky)) *
                                            X + c0[3]
                                  : Idx(0);
                v[kt][kz][ky] = load_pair<VEC, Idx>(data, e, row && ok[3][0], row && ok[3][1],
                                                    nelem);
            }
        }
    }
    float acc = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
        for (int kz = 0; kz < NZ; ++kz) {
#pragma unroll
            for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
                for (int kx = 0; kx < 2; ++kx) {
                    if (!(ok[0][kt] && ok[1][kz] && ok[2][ky] && ok[3][kx])) continue;
                    const float wt =
                        __fmul_rn(__fmul_rn(__fmul_rn(w[0][kt], w[1][kz]), w[2][ky]), w[3][kx]);
                    const float2 vv = v[kt][kz][ky];
                    acc = __fadd_rn(acc, __fmul_rn(wt, kx ? vv.y : vv.x));
                }
            }
        }
    }
    out[i] = acc;
}

template <bool T1, bool Z1, bool VEC, typename Idx>
void launch(const float* data, int T, int Z, int Y, int X, const float* pt, const float* pz,
            const float* py, const float* px, float* out, long long n, cudaStream_t s) {
    const unsigned int blocks = (unsigned int)((n + THREADS - 1) / THREADS);
    fold_sample_kernel<T1, Z1, VEC, Idx>
        <<<blocks, THREADS, 0, s>>>(data, T, Z, Y, X, pt, pz, py, px, out, n);
}

template <bool T1, bool Z1>
void launch_layout(bool vec, bool wide, const float* data, int T, int Z, int Y, int X,
                   const float* pt, const float* pz, const float* py, const float* px,
                   float* out, long long n, cudaStream_t s) {
    if (wide) {
        if (vec) launch<T1, Z1, true, long long>(data, T, Z, Y, X, pt, pz, py, px, out, n, s);
        else launch<T1, Z1, false, long long>(data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    } else {
        if (vec) launch<T1, Z1, true, int>(data, T, Z, Y, X, pt, pz, py, px, out, n, s);
        else launch<T1, Z1, false, int>(data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    }
}

}  // namespace

extern "C" int fold_sample_launch(const float* data, int T, int Z, int Y, int X,
                                  const float* pt, const float* pz, const float* py,
                                  const float* px, float* out, long long n,
                                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = ((unsigned long long)data & 15ull) == 0;
    // 32-bit offsets need every flat index, plus the 4-float load slack, below 2^31
    const bool wide = (long long)T * Z * Y * X > (1ll << 31) - 8;
    if (T == 1 && Z == 1)
        launch_layout<true, true>(vec, wide, data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    else if (T == 1)
        launch_layout<true, false>(vec, wide, data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    else if (Z == 1)
        launch_layout<false, true>(vec, wide, data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    else
        launch_layout<false, false>(vec, wide, data, T, Z, Y, X, pt, pz, py, px, out, n, s);
    return (int)cudaGetLastError();
}
