// K5: the C-grid stage cache's search and gather for a set of lanes, walk included.
//
// Replaces two XLA loops of the JAX package that stay on its device: the
// stage cache's miss repair (parcels_tpu/ops/stagecache.py:805-840, a
// while_loop over rounds of K compacted lanes) and the curvilinear walk inside
// it (parcels_tpu/_core/index_search.py:397-548, an early-exit while_loop).
// PyTorch has no loop that stays on the card, so the port drove both from
// Python with a host read per round and per walk iteration. Here one thread
// takes one lane through the whole of ops/stagecache._full:
//
//   1. point-in-cell at the warm cell (yi, xi) from the fused cell table
//      (cells, 64) f32, whose columns 0-14 are the tangent-frame pic row;
//   2. a miss re-seeds from the coarse lookup raster;
//   3. the directed walk, at most n_walk iterations, tracking the least-
//      outside cell seen; then the rescue within 1 % of a cell;
//   4. the escalation code, the cell, the 25-column fused row, the U/V face
//      quads and the W quad, written at the lane's own index.
//
// The walk's iteration count is coupled across the lanes of a round: the
// plain loop runs while any lane of the batch is neither found nor hopeless,
// so a lane that is hopeless from the start (outside a flat grid's raster,
// or not finite) walks as long as the slowest lane of its round. Found and
// stalled lanes are fixed points of the walk, so that count is the only
// coupling. Two launches reproduce it:
//
//   pass 1: the lanes that start non-hopeless walk until found, stalled or
//           n_walk; each atomicMaxes the iterations it ran into its round's
//           slot nwalk[r];
//   pass 2: the lanes that start hopeless walk at most nwalk[r] iterations.
//
// Which lanes run, and in which round, comes from `slot` (-1: not searched),
// which the wrapper derives on the card from the miss mask by a cumsum
// (ops/cgrid_repair.repair_plan): nothing is read back to the host.
//
// Numerics: every product, sum, quotient and root through the round-to-
// nearest intrinsics in the plain version's order (index_search.pic_from_rows
// and _bilinear_inverse), so the compiler cannot contract them into FMAs;
// max and clamp propagate NaN as torch.maximum and torch.clamp do, and NaN
// maps to index 0 as index_search._to_index does. The raster index
// multiplies by the reciprocal of the step, as torch does on the card for a
// division by a Python float. The kernel then equals its plain version on
// the card bit for bit. K3's and K4's bilinear inverses are not reused: they
// fold the zero corner p0 into their terms and sum bb in another order, so
// they round otherwise. Gather offsets are 64-bit.
//
// One thread a lane, no shared memory: a lane's walk reads rows of a table
// of millions of cells that no other lane of its block shares.
#include <cuda_runtime.h>

namespace {

constexpr float kTol = 2e-4f;
constexpr float kTolHi = (float)(1.0 + 2e-4);
constexpr float kRescue = 0.01f;
constexpr int THREADS = 256;  // one lane a thread

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// max that propagates NaN, as torch.maximum and torch.clamp_min do
__device__ __forceinline__ float nanmax(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float dist01(float v) {
    return nanmax(nanmax(-v, sub(v, 1.0f)), 0.0f);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
// index_search._to_index: NaN -> 0, clamp to [lo, hi], int32
__device__ __forceinline__ int to_index(float f, int lo, int hi) {
    if (isnan(f)) f = 0.0f;
    f = fminf(fmaxf(f, (float)lo), (float)hi);
    return (int)f;
}

}  // namespace

// Launch arguments; ops/cgrid_repair.py mirrors this layout in ctypes.
struct K5Args {
    long long n;
    const int* slot;  // per-lane round, -1 not searched; null: every lane in round 0
    int* nwalk;       // per-round walk iterations, zeroed by the caller
    const float* y;
    const float* x;
    const float* qx;  // index_search.query_xyz(y, x), computed once a stage
    const float* qy;
    const float* qz;
    const int* ti;
    const int* t1i;
    const int* zc;
    const int* wzi;
    const int* yi_w;  // warm cell; may alias oyi / oxi (read before the lane writes)
    const int* xi_w;
    const float* table;  // fused cell table (cells, table_cols)
    long long table_rows;
    int table_cols;
    int ny, nx;  // node counts of the lon/lat arrays: the walk clamps to [0, ny-2] x [0, nx-2]
    int cy, cx;  // the grid's cell counts (cache cell = yi * cx + xi)
    int has_lookup;
    int outside_test;  // flat mesh with a raster: lanes outside it are hopeless
    const int* lk_y;
    const int* lk_x;
    int lny, lnx;
    float ly0, lx0, inv_lys, inv_lxs;
    float lo_y, hi_y, lo_x, hi_x;  // raster bounds, f32 as torch compares them
    int n_walk;
    const float* U;
    const float* V;
    const float* W;  // null: no W quad
    int uT, uZ, uY, uX;
    int vT, vZ, vY, vX;
    int wT, wZ, wY, wX;
    int off_x, off_y;
    int esc_oob, esc_search;  // StatusCode.ErrorOutOfBounds, ErrorGridSearching
    int* cell;
    int* oyi;
    int* oxi;
    int* esc;
    unsigned char* oob;
    float* row;  // (n, 25)
    float* u4;   // (n, 4)
    float* v4;
    float* w4;   // null without W
    int* oti;    // null: the caller keeps its ti / zi / wzi columns
    int* ozi;
    int* owzi;
    unsigned long long* iters;  // null, or [pic evaluations, raster re-seeds] of the lanes
};

namespace {

constexpr int ROW_COLS = 25;
constexpr int GRID_SEARCH_ERROR = -3;
constexpr int RIGHT_OUT_OF_BOUNDS = -1;

// index_search._bilinear_inverse, term by term (corner 0 is the frame origin)
__device__ __forceinline__ void bilinear_inverse(float px0, float px1, float px2, float px3,
                                                 float py0, float py1, float py2, float py3,
                                                 float xq, float yq, float& xsi, float& eta) {
    const float a0 = px0;
    const float a1 = add(-px0, px1);
    const float a2 = add(-px0, px3);
    const float a3 = sub(add(sub(px0, px1), px2), px3);
    const float b0 = py0;
    const float b1 = add(-py0, py1);
    const float b2 = add(-py0, py3);
    const float b3 = sub(add(sub(py0, py1), py2), py3);

    const float aa = sub(mul(a3, b2), mul(a2, b3));
    const float bb = sub(add(sub(add(sub(mul(a3, b0), mul(a0, b3)), mul(a1, b2)), mul(a2, b1)),
                             mul(xq, b3)),
                         mul(yq, a3));
    const float cc = sub(add(sub(mul(a1, b0), mul(a0, b1)), mul(xq, b1)), mul(yq, a1));
    const float det2 = sub(mul(bb, bb), mul(mul(4.0f, aa), cc));
    const float det = __fsqrt_rn(nanmax(det2, 0.0f));

    const float sign_bb = bb >= 0.0f ? 1.0f : -1.0f;
    const float q = mul(-0.5f, add(bb, mul(sign_bb, det)));
    float r1 = dvd(q, aa == 0.0f ? 1.0f : aa);
    float r2 = dvd(cc, q == 0.0f ? 1.0f : q);
    r1 = aa == 0.0f ? r2 : r1;
    r2 = q == 0.0f ? 0.0f : r2;
    float e = dist01(r2) <= dist01(r1) ? r2 : r1;
    e = det2 < 0.0f ? -1.0f : e;

    const float denom = add(a1, mul(a3, e));
    const float fallback =
        mul(add(dvd(sub(yq, py0), py1 == py0 ? 1.0f : sub(py1, py0)),
                dvd(sub(yq, py3), py2 == py3 ? 1.0f : sub(py2, py3))),
            0.5f);
    const bool degenerate = fabsf(denom) < 1e-12f;
    const float xs = dvd(sub(sub(xq, a0), mul(a2, e)), degenerate ? 1.0f : denom);
    xsi = degenerate ? fallback : xs;
    eta = e;
}

// index_search.pic_from_rows at cell (yi, xi): in_cell and (xsi, eta)
__device__ __forceinline__ bool pic(const K5Args& a, int yi, int xi, float qx, float qy,
                                    float qz, float& xsi, float& eta) {
    const float* r = a.table + ((long long)yi * (a.nx - 1) + xi) * a.table_cols;
    const float dx = sub(qx, __ldg(r + 0));
    const float dy = sub(qy, __ldg(r + 1));
    const float dz = sub(qz, __ldg(r + 2));
    const float qu = add(add(mul(dx, __ldg(r + 3)), mul(dy, __ldg(r + 4))), mul(dz, __ldg(r + 5)));
    const float qv = add(add(mul(dx, __ldg(r + 6)), mul(dy, __ldg(r + 7))), mul(dz, __ldg(r + 8)));
    bilinear_inverse(0.0f, __ldg(r + 9), __ldg(r + 11), __ldg(r + 13), 0.0f, __ldg(r + 10),
                     __ldg(r + 12), __ldg(r + 14), qu, qv, xsi, eta);
    return (xsi >= -kTol) & (xsi <= kTolHi) & (eta >= -kTol) & (eta <= kTolHi);
}

// interpolators/xinterp._flat_gather: data[t, z, y, x] at the clamped flat index
__device__ __forceinline__ float gather(const float* d, int T, int Z, int Y, int X, int t, int z,
                                        int y, int x) {
    long long idx = (((long long)t * Z + z) * Y + y) * X + x;
    const long long last = (long long)T * Z * Y * X - 1;
    idx = idx < 0 ? 0 : (idx > last ? last : idx);
    return __ldg(d + idx);
}

// One lane through stagecache._full. kPass2: the lanes that start hopeless.
template <bool kPass2>
__device__ __forceinline__ void lane(const K5Args& a, long long i) {
    const int s = a.slot ? a.slot[i] : 0;
    if (s < 0) return;
    const float y = a.y[i], x = a.x[i];
    const bool outside = a.outside_test &&
                         ((y < a.lo_y) | (y > a.hi_y) | (x < a.lo_x) | (x > a.hi_x));
    const bool hopeless = outside || !(isfinite(y) && isfinite(x));
    if (hopeless != kPass2) return;
    const float qx = a.qx[i], qy = a.qy[i], qz = a.qz[i];
    const int ti = a.ti[i], t1i = a.t1i[i], zc = a.zc[i], wzi = a.wzi[i];

    // 1. point-in-cell at the warm cell
    int yi = clampi(a.yi_w[i], 0, a.ny - 2);
    int xi = clampi(a.xi_w[i], 0, a.nx - 2);
    float xsi, eta;
    bool found = pic(a, yi, xi, qx, qy, qz, xsi, eta);
    unsigned evals = 1;

    // 2. re-seed a miss from the raster
    const bool reseed = a.has_lookup && !found;
    if (reseed) {
        const int ry = to_index(floorf(mul(sub(y, a.ly0), a.inv_lys)), 0, a.lny - 1);
        const int rx = to_index(floorf(mul(sub(x, a.lx0), a.inv_lxs)), 0, a.lnx - 1);
        const long long k = (long long)ry * a.lnx + rx;
        yi = clampi(a.lk_y[k], 0, a.ny - 2);
        xi = clampi(a.lk_x[k], 0, a.nx - 2);
    }

    // 3. the walk; a found or stalled lane is a fixed point and stops
    const int limit = kPass2 ? a.nwalk[s] : a.n_walk;
    float best = INFINITY;
    int by = 0, bx = 0;
    int it = 0;
    bool stalled = false;
    while (it < limit && !found && !stalled) {
        const bool ok = pic(a, yi, xi, qx, qy, qz, xsi, eta);
        ++evals;
        const float d = nanmax(dist01(xsi), dist01(eta));
        if (d < best) {
            best = d;
            by = yi;
            bx = xi;
        }
        const int dx = ok ? 0 : to_index(floorf(xsi), -2, 2);
        const int dy = ok ? 0 : to_index(floorf(eta), -2, 2);
        const int yn = clampi(yi + dy, 0, a.ny - 2);
        const int xn = clampi(xi + dx, 0, a.nx - 2);
        stalled = !ok && yn == yi && xn == xi;
        yi = yn;
        xi = xn;
        found = ok;
        ++it;
    }
    if (!kPass2 && it > 0) atomicMax(a.nwalk + s, it);
    if (a.iters) {
        atomicAdd(a.iters, (unsigned long long)evals);
        if (reseed) atomicAdd(a.iters + 1, 1ULL);
    }

    if (!outside && !found && best < kRescue) {
        yi = by;
        xi = bx;
        found = true;
    }
    int ys = found ? yi : GRID_SEARCH_ERROR;
    int xs = found ? xi : GRID_SEARCH_ERROR;
    if (outside && !found) ys = xs = RIGHT_OUT_OF_BOUNDS;

    // 4. what the cache keeps of the lane
    const bool oob_lane = ys == RIGHT_OUT_OF_BOUNDS || xs == RIGHT_OUT_OF_BOUNDS;
    const bool err_lane = ys == GRID_SEARCH_ERROR || xs == GRID_SEARCH_ERROR;
    const int e_oob = oob_lane ? a.esc_oob : 0, e_err = err_lane ? a.esc_search : 0;
    const int yi_cl = clampi(ys, 0, a.cy - 1);
    const int xi_cl = clampi(xs, 0, a.cx - 1);
    const int cell = yi_cl * a.cx + xi_cl;
    const bool valid = ys >= 0 && xs >= 0;

    const float* src = a.table + (long long)clampi(cell, 0, (int)(a.table_rows - 1)) * a.table_cols;
    float* dst = a.row + i * ROW_COLS;
#pragma unroll
    for (int c = 0; c < ROW_COLS; ++c) dst[c] = __ldg(src + c);

    const int yi_o = clampi(ys + a.off_y, 0, a.uY - 1);
    const int xw = clampi(xs, 0, a.uX - 2 > 0 ? a.uX - 2 : 0);
    float* u4 = a.u4 + i * 4;
    u4[0] = gather(a.U, a.uT, a.uZ, a.uY, a.uX, ti, zc, yi_o, xw);
    u4[1] = gather(a.U, a.uT, a.uZ, a.uY, a.uX, t1i, zc, yi_o, xw);
    u4[2] = gather(a.U, a.uT, a.uZ, a.uY, a.uX, ti, zc, yi_o, xw + 1);
    u4[3] = gather(a.U, a.uT, a.uZ, a.uY, a.uX, t1i, zc, yi_o, xw + 1);
    const int xi_o = clampi(xs + a.off_x, 0, a.uX - 1);
    const int yv = clampi(ys, 0, a.uY - 2 > 0 ? a.uY - 2 : 0);
    float* v4 = a.v4 + i * 4;
    v4[0] = gather(a.V, a.vT, a.vZ, a.vY, a.vX, ti, zc, yv, xi_o);
    v4[1] = gather(a.V, a.vT, a.vZ, a.vY, a.vX, t1i, zc, yv, xi_o);
    v4[2] = gather(a.V, a.vT, a.vZ, a.vY, a.vX, ti, zc, yv + 1, xi_o);
    v4[3] = gather(a.V, a.vT, a.vZ, a.vY, a.vX, t1i, zc, yv + 1, xi_o);
    if (a.W) {
        const int z1 = clampi(wzi + 1, 0, a.wZ - 1);
        float* w4 = a.w4 + i * 4;
        w4[0] = gather(a.W, a.wT, a.wZ, a.wY, a.wX, ti, wzi, yi_o, xi_o);
        w4[1] = gather(a.W, a.wT, a.wZ, a.wY, a.wX, t1i, wzi, yi_o, xi_o);
        w4[2] = gather(a.W, a.wT, a.wZ, a.wY, a.wX, ti, z1, yi_o, xi_o);
        w4[3] = gather(a.W, a.wT, a.wZ, a.wY, a.wX, t1i, z1, yi_o, xi_o);
    }

    a.cell[i] = valid ? cell : -1;
    a.oyi[i] = yi_cl;
    a.oxi[i] = xi_cl;
    a.esc[i] = e_oob > e_err ? e_oob : e_err;
    a.oob[i] = valid ? 0 : 1;
    if (a.oti) {
        a.oti[i] = ti;
        a.ozi[i] = zc;
        a.owzi[i] = wzi;
    }
}

template <bool kPass2>
__global__ void __launch_bounds__(THREADS) cgrid_repair_kernel(const K5Args a) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) lane<kPass2>(a, i);
}

}  // namespace

// ---- launcher ----
extern "C" int cgrid_repair_launch(const K5Args* args, void* stream) {
    const K5Args a = *args;
    if (a.n <= 0) return 0;
    const long long blocks = (a.n + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cgrid_repair_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(a);
    cgrid_repair_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}
