// The C-grid stage's prologue and epilogue: the two calls around K5.
//
// A stage of the curvilinear C-grid stage cache (ops/stagecache.py
// cgrid_cached_eval) is three calls on the card: the prologue, K5
// (csrc/cgrid_repair.cu) and the epilogue. The two kernels here replace the
// eager operations around K5, about 200 launches a stage, each one pass over
// the lanes:
//
//   stage_prologue_kernel, one thread a lane: the time and depth brackets
//     as stagecache.stage_brackets gives them (index_search.search_time and
//     search_1d: a uniform axis by its closed form, any other bisected in
//     shared memory), the escalation code they imply, the depth's
//     out-of-bounds flag and the query coordinates K5 reads
//     (index_search.query_xyz);
//   stage_epilogue_kernel, one thread a lane: the C-grid blend
//     (stagecache._blend: edge lengths, the face-flux blend, the Jacobian,
//     W's time and depth blend) from the lane's cached row and face values,
//     the particle state's escalations (the stage's codes, then
//     ErrorInterpolation where a velocity is NaN), the warm-start ei column
//     under the lane mask, and the zeroing of out-of-bounds samples. It
//     writes new state and ei tensors: the particle SoA is never updated
//     in place.
//
// What bounds them: bytes, each lane's inputs read and its outputs written
// once (about 60 B a lane for the prologue, 130-160 B for the epilogue);
// their arithmetic is a few dozen operations and three to six cosines a lane.
//
// Numerics: every product, sum, quotient and root through the round-to-
// nearest intrinsics in the eager order, so the compiler cannot contract
// them into FMAs where torch's separate kernels round twice; the accurate
// cosf/sinf and IEEE division and square root, as torch's CUDA kernels use;
// a product with a Python float takes it rounded to f32, as torch does on the
// card; clamps keep NaN as torch.clamp does (fminf(fmaxf()) otherwise); the
// bisection is ATen's searchsorted upper bound (a NaN position lies past
// every node), and on an axis of at most 128 nodes a NaN counts 0 nodes, as
// search_1d's broadcast compare counts it. The kernels then equal the eager
// stage on the card, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // one lane a thread
constexpr int LEFT_OUT_OF_BOUNDS = -2;
constexpr int RIGHT_OUT_OF_BOUNDS = -1;
constexpr int BROADCAST_NODES = 128;  // search_1d counts nodes <= x up to this length
constexpr int AXIS_SMEM = 2048;       // a longer axis is bisected in device memory
constexpr int GEOM_OFF = 16;          // the cached row's geometry columns (stagecache.GEOM_OFF)
constexpr int ROW_COLS = 25;
// torch.deg2rad's factor, rounded to f32 as torch multiplies by it
constexpr float kDeg2Rad = (float)0.017453292519943295769236907684886127134428718885417;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp on a float: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One bracketed axis; ops/cgrid_stage.py mirrors both structs in ctypes.
struct StageAxis {
    const float* nodes;  // (n,) f32; null: no search (index 0, bcoord 0)
    int n;
    int uniform;  // the closed form of a uniform axis
    float origin, inv, lo, hi;  // its f32 constants: origin, 1 / step, the bounds
};

struct PrologueArgs {
    long long n;
    const float* t;
    const float* z;
    const float* y;
    const float* x;
    StageAxis time;  // nodes null where the field has no time axis (or one frame)
    StageAxis depth;
    int T, Z;            // frames and levels of U: t1i and zc clamp to them
    int has_w;           // wzi = clamp(zi_raw + off_z, 0, wz_hi), else 0
    int off_z, wz_hi;
    int spherical;
    int esc_oob, esc_surface, esc_time;  // StatusCode values
    int* ti;
    int* t1i;
    float* tau;
    int* zi_raw;
    int* zc;
    float* zeta;
    int* wzi;
    int* esc;
    unsigned char* z_oob;
    float* qx;
    float* qy;
    float* qz;
};

struct EpilogueArgs {
    long long n;
    const float* row;  // (n, 25) cached rows, the geometry at columns 16-24
    const float* xsi;
    const float* eta;
    const float* tau;
    const float* zeta;
    const float* y;
    const float* u4;  // (n, 4) each
    const float* v4;
    const float* w4;  // null: w = 0
    int zeta_blend;   // W has more than one level: W blends in depth
    int spherical;
    float deg2m, rad;  // f32 of spec.deg2m and of math.pi / 180
    const int* esc_zt;
    const int* c_esc;
    const unsigned char* c_oob;
    const unsigned char* z_oob;
    const int* zc;
    const int* yi;
    const int* xi;
    int ydim, xdim;  // cells: ei = (zc * ydim + yi) * xdim + xi
    // the particles; state null: a host-side eval, no state or ei written
    const unsigned char* mask;
    const int* state;
    const int* ei;  // (n, ngrids)
    int ngrids, igrid;
    int esc_interp;
    float* u;
    float* v;
    float* w;  // null: not written (a 2-D view)
    int* new_state;
    int* new_ei;
};

namespace {

// ATen's searchsorted(right=True) upper bound: the first node greater than x
__device__ __forceinline__ int upper_bound(const float* nodes, int n, float x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(nodes[mid] > x)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// index_search.search_1d: the left bracket (or an out-of-bounds sentinel) and
// the barycentric coordinate of x on an axis of n >= 2 nodes
__device__ __forceinline__ void search_1d(const StageAxis& ax, const float* nodes, float x,
                                          int& idx, float& bc) {
    float lo, hi;
    if (ax.uniform) {
        const float s = mul(sub(x, ax.origin), ax.inv);
        const float f = clampf(floorf(s), 0.0f, (float)(ax.n - 2));
        idx = isnan(f) ? 0 : (int)f;
        bc = sub(s, f);
        lo = ax.lo;
        hi = ax.hi;
    } else {
        int ins = upper_bound(nodes, ax.n, x);
        if (ax.n <= BROADCAST_NODES && isnan(x)) ins = 0;
        idx = clampi(ins - 1, 0, ax.n - 2);
        bc = dvd(sub(x, nodes[idx]), sub(nodes[idx + 1], nodes[idx]));
        lo = nodes[0];
        hi = nodes[ax.n - 1];
    }
    idx = x < lo ? LEFT_OUT_OF_BOUNDS : idx;
    idx = x > hi ? RIGHT_OUT_OF_BOUNDS : idx;
}

__host__ __device__ __forceinline__ bool staged(const StageAxis& ax) {
    return ax.nodes && !ax.uniform && ax.n <= AXIS_SMEM;
}

__global__ void __launch_bounds__(THREADS) stage_prologue_kernel(const PrologueArgs a) {
    extern __shared__ float s_nodes[];
    // a searched axis of a few hundred nodes is bisected in shared memory
    const float* tn = a.time.nodes;
    const float* zn = a.depth.nodes;
    int off = 0;
    if (staged(a.time)) {
        for (int j = threadIdx.x; j < a.time.n; j += THREADS) s_nodes[j] = a.time.nodes[j];
        tn = s_nodes;
        off = a.time.n;
    }
    if (staged(a.depth)) {
        for (int j = threadIdx.x; j < a.depth.n; j += THREADS) s_nodes[off + j] = a.depth.nodes[j];
        zn = s_nodes + off;
    }
    __syncthreads();
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.n) return;

    // search_time: the bracket clamped to the frames, out-of-interval apart
    int ti = 0;
    float tau = 0.0f;
    bool t_oob = false;
    if (a.time.nodes) {
        const float t = a.t[i];
        t_oob = (t < __ldg(a.time.nodes)) | (t > __ldg(a.time.nodes + a.time.n - 1));
        search_1d(a.time, tn, t, ti, tau);
        ti = clampi(ti, 0, a.time.n - 2);
        tau = clampf(tau, 0.0f, 1.0f);
    }
    int zi = 0;
    float zeta = 0.0f;
    if (a.depth.nodes) search_1d(a.depth, zn, a.z[i], zi, zeta);

    int esc = 0;
    if (zi == RIGHT_OUT_OF_BOUNDS) esc = max(esc, a.esc_oob);
    if (zi == LEFT_OUT_OF_BOUNDS) esc = max(esc, a.esc_surface);
    if (t_oob) esc = max(esc, a.esc_time);

    a.ti[i] = ti;
    a.t1i[i] = clampi(ti + 1, 0, a.T - 1);
    a.tau[i] = tau;
    a.zi_raw[i] = zi;
    a.zc[i] = clampi(zi, 0, a.Z - 1);
    a.zeta[i] = zeta;
    a.wzi[i] = a.has_w ? clampi(zi + a.off_z, 0, a.wz_hi) : 0;
    a.esc[i] = esc;
    a.z_oob[i] = zi < 0;

    const float y = a.y[i], x = a.x[i];
    if (a.spherical) {  // index_search._latlon_to_xyz
        const float lat = mul(y, kDeg2Rad);
        const float lon = mul(x, kDeg2Rad);
        const float cl = cosf(lat);
        a.qx[i] = mul(cosf(lon), cl);
        a.qy[i] = mul(sinf(lon), cl);
        a.qz[i] = sinf(lat);
    } else {
        a.qx[i] = x;
        a.qy[i] = y;
        a.qz[i] = 0.0f;
    }
}

// xinterp.cgrid_edge_lengths' edge_len
__device__ __forceinline__ float edge_len(const EpilogueArgs& a, float dlon, float dlat,
                                          float lat_edge) {
    if (a.spherical) {
        const float p = mul(mul(dlon, a.deg2m), cosf(mul(lat_edge, a.rad)));
        const float q = mul(dlat, a.deg2m);
        return __fsqrt_rn(add(mul(p, p), mul(q, q)));
    }
    return __fsqrt_rn(add(mul(dlon, dlon), mul(dlat, dlat)));
}

__device__ __forceinline__ float4 load4(const float* base, long long i) {
    const float* p = base + 4 * i;
    if (aligned16(base)) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// a time blend: f0 * (1 - tau) + f1 * tau
__device__ __forceinline__ float tblend(float f0, float f1, float omt, float tau) {
    return add(mul(f0, omt), mul(f1, tau));
}

__global__ void __launch_bounds__(THREADS) stage_epilogue_kernel(const EpilogueArgs a) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.n) return;
    const float* g = a.row + i * ROW_COLS + GEOM_OFF;
    const float dlon10 = __ldg(g), dlon23 = __ldg(g + 1), dlon30 = __ldg(g + 2);
    const float dlon21 = __ldg(g + 3), dlat10 = __ldg(g + 4), dlat23 = __ldg(g + 5);
    const float dlat30 = __ldg(g + 6), dlat21 = __ldg(g + 7), py0 = __ldg(g + 8);
    const float xsi = a.xsi[i], eta = a.eta[i], tau = a.tau[i];

    // stagecache._blend
    const float c1 = edge_len(a, dlon10, dlat10, add(py0, mul(xsi, dlat10)));
    const float c2 = edge_len(a, dlon21, dlat21, add(add(py0, dlat10), mul(eta, dlat21)));
    const float c3 = edge_len(a, dlon23, dlat23, add(add(py0, dlat30), mul(xsi, dlat23)));
    const float c4 = edge_len(a, dlon30, dlat30, add(py0, mul(eta, dlat30)));
    const float omt = sub(1.0f, tau);
    const float4 u4 = load4(a.u4, i);
    const float4 v4 = load4(a.v4, i);
    const float u_w = tblend(u4.x, u4.y, omt, tau);
    const float u_e = tblend(u4.z, u4.w, omt, tau);
    const float v_s = tblend(v4.x, v4.y, omt, tau);
    const float v_n = tblend(v4.z, v4.w, omt, tau);
    const float omx = sub(1.0f, xsi), ome = sub(1.0f, eta);
    const float uvel = add(mul(mul(omx, c4), u_w), mul(mul(xsi, c2), u_e));
    const float vvel = add(mul(mul(ome, c1), v_s), mul(mul(eta, c3), v_n));

    // xinterp.cgrid_velocity_from_fluxes
    const float dxdxsi = add(mul(ome, dlon10), mul(eta, dlon23));
    const float dxdeta = add(mul(omx, dlon30), mul(xsi, dlon21));
    const float dydxsi = add(mul(ome, dlat10), mul(eta, dlat23));
    const float dydeta = add(mul(omx, dlat30), mul(xsi, dlat21));
    float jac = sub(mul(dxdxsi, dydeta), mul(dxdeta, dydxsi));
    if (a.spherical) jac = mul(jac, a.deg2m);
    float u = dvd(add(mul(uvel, dxdxsi), mul(vvel, dxdeta)), jac);
    float v = dvd(add(mul(uvel, dydxsi), mul(vvel, dydeta)), jac);
    if (a.spherical) {
        const float conversion = mul(cosf(mul(a.y[i], kDeg2Rad)), a.deg2m);
        u = dvd(u, conversion);
        v = dvd(v, conversion);
    }
    float w = 0.0f;
    if (a.w4) {
        const float zb = a.zeta_blend ? clampf(a.zeta[i], 0.0f, 1.0f) : 0.0f;
        const float4 w4 = load4(a.w4, i);
        const float w_lo = tblend(w4.x, w4.y, omt, tau);
        const float w_hi = tblend(w4.z, w4.w, omt, tau);
        w = add(mul(w_lo, sub(1.0f, zb)), mul(w_hi, zb));
    }

    if (a.state) {
        // the masked max-merges of the stage's codes, then ErrorInterpolation
        // where a velocity is NaN, and the masked ei refresh
        const bool live = a.mask[i] != 0;
        const int s0 = a.state[i];
        int s = max(s0, max(a.esc_zt[i], a.c_esc[i]));
        if (isnan(u) || isnan(v) || isnan(w)) s = max(s, a.esc_interp);
        a.new_state[i] = live ? s : s0;
        const unsigned cell =
            ((unsigned)a.zc[i] * (unsigned)a.ydim + (unsigned)a.yi[i]) * (unsigned)a.xdim +
            (unsigned)a.xi[i];
        const int* e = a.ei + i * a.ngrids;
        int* out = a.new_ei + i * a.ngrids;
        for (int k = 0; k < a.ngrids; ++k) out[k] = (live && k == a.igrid) ? (int)cell : e[k];
    }

    // out-of-bounds samples return 0
    const bool zero = a.c_oob[i] || a.z_oob[i];
    a.u[i] = zero ? 0.0f : u;
    a.v[i] = zero ? 0.0f : v;
    if (a.w) a.w[i] = zero ? 0.0f : w;
}

}  // namespace

// ---- launcher: kind 0 the prologue, 1 the epilogue, on ``stream`` ----
extern "C" int cgrid_stage_launch(int kind, const void* args, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == 0) {
        const PrologueArgs& a = *static_cast<const PrologueArgs*>(args);
        if (a.n <= 0) return 0;
        const long long blocks = (a.n + THREADS - 1) / THREADS;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        const size_t smem =
            sizeof(float) * ((staged(a.time) ? a.time.n : 0) + (staged(a.depth) ? a.depth.n : 0));
        stage_prologue_kernel<<<(unsigned)blocks, THREADS, smem, st>>>(a);
    } else if (kind == 1) {
        const EpilogueArgs& a = *static_cast<const EpilogueArgs*>(args);
        if (a.n <= 0) return 0;
        const long long blocks = (a.n + THREADS - 1) / THREADS;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        stage_epilogue_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(a);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
