// K4: one fused flat-mesh RK4 cache-hit step from per-lane cell operands.
//
// Replaces the JAX package's Pallas micro-benchmark kernel
// scripts/micro_pallas_rk4.py:_kernel (pallas_call in run_pallas). Each lane
// carries the cached cell's tangent-frame point-in-cell row (origin in planes
// 0-1, frame in 3-4 and 6-7, projected corners p1, p2, p3 in 9-14), its C-grid
// geometry (16-23), its 4 U and 4 V face values and its state [x, y, t, dt].
// All four RK stages run in registers: the bilinear inverse (the root of the
// quadratic nearer 0.5, denominators picked by magnitude), the face-flux blend
// with edge lengths, the time blend at tau = t * 0 and the Jacobian. The step
// writes [dx, dy, 0, 0, 0, 0, 0, 0]: the TPU kernel's output is 8 planes with
// rows 2-7 zero. There is no in-cell test and no miss flag.
//
// Bound on the card: bytes. A lane reads the 20 row planes the stages use, 8
// uv planes and 4 state planes and writes 8 planes: 160 B, against about 125
// f32 operations a stage (6 divisions and 5 square roots among them), which the FP32
// peak runs in a fraction of the time the bytes take at the memory rate. The
// TPU kernel kept a 2048-lane block in VMEM; here one thread owns one lane,
// reads plane[c * n + i] (a warp's loads are coalesced 128 B lines), keeps
// every intermediate in registers and uses no shared memory: nothing is shared
// between lanes. The 12 row planes no stage reads are not loaded.
//
// Numerics: IEEE division and square root, and every product and sum through
// the round-to-nearest intrinsics in the plain version's order
// (ops/flat_rk4.flat_rk4_step_plain), so the compiler cannot contract them
// into FMAs and the kernel equals its plain version bit for bit. tau = t * 0
// stays a product: a NaN or infinite t gives a NaN step.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// max that propagates NaN, as torch.clamp_min does
__device__ __forceinline__ float nanmax(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

// micro_pallas_rk4._bilinear_inverse with p0 = 0 in the projected frame
__device__ __forceinline__ void bilinear_inverse(float p1u, float p1v, float p2u, float p2v,
                                                 float p3u, float p3v, float xq, float yq,
                                                 float& xsi, float& eta) {
    float a1 = p1u, a2 = p3u, a3 = sub(add(-p1u, p2u), p3u);
    float b1 = p1v, b2 = p3v, b3 = sub(sub(p2v, p1v), p3v);
    float aa = sub(mul(a3, b2), mul(a2, b3));
    float bb = sub(add(sub(mul(a1, b2), mul(a2, b1)), mul(xq, b3)), mul(yq, a3));
    float cc = sub(mul(xq, b1), mul(yq, a1));
    float det2 = sub(mul(bb, bb), mul(mul(4.0f, aa), cc));
    float det = __fsqrt_rn(nanmax(det2, 0.0f));
    float sign_bb = bb >= 0.0f ? 1.0f : -1.0f;
    float q = mul(-0.5f, add(bb, mul(sign_bb, det)));
    float r1 = dvd(q, aa == 0.0f ? 1.0f : aa);
    float r2 = dvd(cc, q == 0.0f ? 1.0f : q);
    r1 = aa == 0.0f ? r2 : r1;
    r2 = q == 0.0f ? 0.0f : r2;
    bool pick1 = fabsf(sub(r1, 0.5f)) <= fabsf(sub(r2, 0.5f));
    eta = pick1 ? r1 : r2;
    float denx = add(a1, mul(a3, eta));
    float deny = add(b1, mul(b3, eta));
    bool use_x = fabsf(denx) >= fabsf(deny);
    float xs_x = dvd(sub(xq, mul(a2, eta)), denx == 0.0f ? 1.0f : denx);
    float xs_y = dvd(sub(yq, mul(b2, eta)), deny == 0.0f ? 1.0f : deny);
    xsi = use_x ? xs_x : xs_y;
}

struct Row {
    float r[24];  // planes 2, 5, 8 and 15 are not loaded and not read
};

// One RK stage from the cached operands: (u, v) at (x, y, tau).
__device__ __forceinline__ void stage(const Row& R, const float* uv, float x, float y,
                                      float tau, float& uo, float& vo) {
    const float* r = R.r;
    float dx = sub(x, r[0]);
    float dy = sub(y, r[1]);
    float qu = add(mul(dx, r[3]), mul(dy, r[4]));
    float qv = add(mul(dx, r[6]), mul(dy, r[7]));
    float xsi, eta;
    bilinear_inverse(r[9], r[10], r[11], r[12], r[13], r[14], qu, qv, xsi, eta);
    float dlon10 = r[16], dlon23 = r[17], dlon30 = r[18], dlon21 = r[19];
    float dlat10 = r[20], dlat23 = r[21], dlat30 = r[22], dlat21 = r[23];
    float c1 = __fsqrt_rn(add(mul(dlon10, dlon10), mul(dlat10, dlat10)));
    float c2 = __fsqrt_rn(add(mul(dlon21, dlon21), mul(dlat21, dlat21)));
    float c3 = __fsqrt_rn(add(mul(dlon23, dlon23), mul(dlat23, dlat23)));
    float c4 = __fsqrt_rn(add(mul(dlon30, dlon30), mul(dlat30, dlat30)));
    float omt = sub(1.0f, tau);
    float u_w = add(mul(uv[0], omt), mul(uv[1], tau));
    float u_e = add(mul(uv[2], omt), mul(uv[3], tau));
    float v_s = add(mul(uv[4], omt), mul(uv[5], tau));
    float v_n = add(mul(uv[6], omt), mul(uv[7], tau));
    float omx = sub(1.0f, xsi);
    float ome = sub(1.0f, eta);
    float Uvel = add(mul(mul(omx, c4), u_w), mul(mul(xsi, c2), u_e));
    float Vvel = add(mul(mul(ome, c1), v_s), mul(mul(eta, c3), v_n));
    float dxdxsi = add(mul(ome, dlon10), mul(eta, dlon23));
    float dxdeta = add(mul(omx, dlon30), mul(xsi, dlon21));
    float dydxsi = add(mul(ome, dlat10), mul(eta, dlat23));
    float dydeta = add(mul(omx, dlat30), mul(xsi, dlat21));
    float jac = sub(mul(dxdxsi, dydeta), mul(dxdeta, dydxsi));
    jac = jac == 0.0f ? 1.0f : jac;
    uo = dvd(add(mul(Uvel, dxdxsi), mul(Vvel, dxdeta)), jac);
    vo = dvd(add(mul(Uvel, dydxsi), mul(Vvel, dydeta)), jac);
}

__global__ void __launch_bounds__(256) flat_rk4_kernel(
    const float* __restrict__ rows, const float* __restrict__ uvp,
    const float* __restrict__ scal, float* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Row R;
#pragma unroll
    for (int c = 0; c < 24; ++c) {
        bool used = c != 2 && c != 5 && c != 8 && c != 15;
        R.r[c] = used ? __ldg(rows + c * n + i) : 0.0f;
    }
    float uv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) uv[c] = __ldg(uvp + c * n + i);
    float x = __ldg(scal + i), y = __ldg(scal + n + i), t = __ldg(scal + 2 * n + i);
    float dt = __ldg(scal + 3 * n + i);
    float tau0 = mul(t, 0.0f);  // single-bracket synthetic case
    float hdt = mul(0.5f, dt);
    float u1, v1, u2, v2, u3, v3, u4, v4;
    stage(R, uv, x, y, tau0, u1, v1);
    stage(R, uv, add(x, mul(hdt, u1)), add(y, mul(hdt, v1)), tau0, u2, v2);
    stage(R, uv, add(x, mul(hdt, u2)), add(y, mul(hdt, v2)), tau0, u3, v3);
    stage(R, uv, add(x, mul(dt, u3)), add(y, mul(dt, v3)), tau0, u4, v4);
    float su = add(add(add(u1, mul(2.0f, u2)), mul(2.0f, u3)), u4);
    float sv = add(add(add(v1, mul(2.0f, v2)), mul(2.0f, v3)), v4);
    out[i] = mul(dvd(su, 6.0f), dt);
    out[n + i] = mul(dvd(sv, 6.0f), dt);
#pragma unroll
    for (int c = 2; c < 8; ++c) out[c * n + i] = 0.0f;
}

}  // namespace

extern "C" int flat_rk4_launch(const float* rows, const float* uv, const float* scal,
                               float* out, long long n, void* stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    flat_rk4_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        rows, uv, scal, out, n);
    return (int)cudaGetLastError();
}
