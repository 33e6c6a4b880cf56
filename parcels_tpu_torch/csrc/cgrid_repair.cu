// K5: the C-grid stage cache's hit check, miss compaction, search and gather,
// walk included, for the lanes of one stage.
//
// Replaces two XLA loops of the JAX package that stay on its device: the
// stage cache's miss repair (parcels_tpu/ops/stagecache.py:805-840, a
// while_loop over rounds of K compacted lanes) and the curvilinear walk inside
// it (parcels_tpu/_core/index_search.py:397-548, an early-exit while_loop),
// with the hit check and the (xsi, eta) of every lane around them
// (stagecache.py's cgrid_cached_eval). PyTorch has no loop that stays on the
// card, so one call runs a stage here, with no read back to the host:
//
//   (a) check and plan, one block a tile of 256 lanes: each lane's cached
//       25-column row is staged through shared memory in 16-byte vectors, its
//       pic columns give (xsi, eta) and the in-cell test, its keys (ti, zi,
//       wzi, cell) the hit; a miss takes its rank in lane order in a work list
//       (warp ballot, block scan, single-pass decoupled look-back across the
//       tiles, which take their tile in the order they start). Its round is
//       place // K. The last tile appends lane n - 1, the plain loop's pad of
//       a short last round, when that lane is no miss itself;
//   (b) pass 1 and (c) pass 2, a fixed grid of a few blocks an SM striding
//       over the work list, whose length they read from device memory. Each
//       searched lane runs ops/stagecache._full:
//         1. point-in-cell at the warm cell (yi, xi) from the fused cell table
//            (cells, 64) f32, whose columns 0-14 are the tangent-frame pic row
//            (four aligned float4s), its raster entry loaded beside it;
//         2. a miss re-seeds from the coarse lookup raster;
//         3. the directed walk, at most n_walk iterations, tracking the
//            least-outside cell seen; then the rescue within 1 % of a cell;
//         4. the escalation code, the cell, the 25-column fused row (seven
//            float4s), (xsi, eta) from that row, the U/V face quads and the W
//            quad, each quad one float4 store, at the lane's own index.
//
// A full eval (every lane in one round, warm-started from given cells) runs
// (b) and (c) over the lanes themselves; there a tile's rows are staged
// through shared memory too and leave as contiguous 16-byte stores.
//
// The walk's iteration count is coupled across the lanes of a round: the
// plain loop runs while any lane of the batch is neither found nor hopeless,
// so a lane that is hopeless from the start (outside a flat grid's raster,
// or not finite) walks as long as the slowest lane of its round. Found and
// stalled lanes are fixed points of the walk, so that count is the only
// coupling: pass 1 walks the lanes that start non-hopeless and takes the
// round's largest count into nwalk[r] (one atomicMax a warp and round);
// pass 2 walks the hopeless lanes nwalk[r] iterations.
//
// What bounds it: the scattered reads. A searched lane reads about 2.7 pic
// rows of a table of millions of cells (a 64-byte row head each) and its
// field values; the check reads 121 bytes a lane over all n lanes. The design
// moves those bytes in 16-byte vectors, keeps every lane-ordered access
// contiguous across a warp, reads only the work list's lanes in (b) and (c),
// and makes no host read.
//
// Numerics: every product, sum, quotient and root through the round-to-
// nearest intrinsics in the plain version's order (index_search.pic_from_rows
// and _bilinear_inverse), so the compiler cannot contract them into FMAs;
// max and clamp propagate NaN as torch.maximum and torch.clamp do, and NaN
// maps to index 0 as index_search._to_index does. The raster index
// multiplies by the step's reciprocal taken in double and rounded to f32,
// as torch does on the card for a division by a Python float (the f32
// reciprocal of the f32 step differs from it in the last bit for some
// steps). The kernel then equals its plain version on
// the card bit for bit. K3's and K4's bilinear inverses are not reused: they
// fold the zero corner p0 into their terms and sum bb in another order, so
// they round otherwise. Gather offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTol = 2e-4f;
constexpr float kTolHi = (float)(1.0 + 2e-4);
constexpr float kRescue = 0.01f;
constexpr int THREADS = 256;  // one lane a thread; a tile is a block's lanes
// search-pass blocks an SM (launch bounds): the passes use 56-64 registers,
// which 5 blocks (at most 48 a thread) would spill
constexpr int MIN_BLOCKS = 4;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_COLS = 25;
constexpr int PLAN_HEAD = 4;  // plan[0..3]: cnt, rounds, list length, tile ticket
constexpr unsigned long long FLAG_AGG = 1ULL << 62;     // a tile's own count is published
constexpr unsigned long long FLAG_PREFIX = 2ULL << 62;  // its inclusive prefix is published
constexpr unsigned long long VALUE_MASK = (1ULL << 62) - 1;

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
__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launch arguments; ops/cgrid_repair.py mirrors this layout in ctypes.
struct K5Args {
    long long n;
    // a stage's check and plan; work == null: a full eval, every lane in round 0
    long long* plan;  // [cnt, rounds, length, ticket, tile status..., nwalk (int32)...]; zeroed here
    int* work;        // (n + 1,) the work list
    int k;            // round capacity
    int nslots;       // nwalk entries (rounds a stage can have)
    const float* c_row;  // (n, 25) cached rows, the keys and the lane mask (null: every lane)
    const int* c_ti;
    const int* c_zi;
    const int* c_wzi;
    const int* c_cell;
    const unsigned char* mask;
    // the lanes
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
    // the view
    const float* table;  // fused cell table (cells, table_cols), 16-byte aligned rows
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
    // what the cache keeps of a lane
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
    float* xsi;  // (n,) from each lane's row, every lane
    float* eta;
    unsigned long long* iters;  // null, or [pic evaluations, raster re-seeds] of the searched lanes
    int* nwalk;  // set by the launcher, inside plan
};

namespace {

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

// index_search.pic_from_rows on one row's columns 0-14: in_cell and (xsi, eta)
__device__ __forceinline__ bool pic_cols(const float* r, float qx, float qy, float qz,
                                         float& xsi, float& eta) {
    const float dx = sub(qx, r[0]);
    const float dy = sub(qy, r[1]);
    const float dz = sub(qz, r[2]);
    const float qu = add(add(mul(dx, r[3]), mul(dy, r[4])), mul(dz, r[5]));
    const float qv = add(add(mul(dx, r[6]), mul(dy, r[7])), mul(dz, r[8]));
    bilinear_inverse(0.0f, r[9], r[11], r[13], 0.0f, r[10], r[12], r[14], qu, qv, xsi, eta);
    return (xsi >= -kTol) & (xsi <= kTolHi) & (eta >= -kTol) & (eta <= kTolHi);
}

// ``kVecs`` aligned float4s of a table row into registers
template <int kVecs>
__device__ __forceinline__ void load_row(const K5Args& a, long long cell, float (&r)[4 * kVecs]) {
    const float4* p = reinterpret_cast<const float4*>(a.table + cell * a.table_cols);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
        const float4 f = __ldg(p + v);
        r[4 * v] = f.x;
        r[4 * v + 1] = f.y;
        r[4 * v + 2] = f.z;
        r[4 * v + 3] = f.w;
    }
}

// point-in-cell at cell (yi, xi) of the table
__device__ __forceinline__ bool pic(const K5Args& a, int yi, int xi, float qx, float qy,
                                    float qz, float& xsi, float& eta) {
    float r[16];
    load_row<4>(a, (long long)yi * (a.nx - 1) + xi, r);
    return pic_cols(r, qx, qy, qz, xsi, eta);
}

// interpolators/xinterp._flat_gather: data[t, z, y, x] at the clamped flat index
__device__ __forceinline__ float gather(const float* d, int T, int Z, int Y, int X, int t, int z,
                                        int y, int x) {
    long long idx = (((long long)t * Z + z) * Y + y) * X + x;
    const long long last = (long long)T * Z * Y * X - 1;
    idx = idx < 0 ? 0 : (idx > last ? last : idx);
    return __ldg(d + idx);
}

__device__ __forceinline__ void store4(float* p, float a0, float a1, float a2, float a3) {
    if (aligned16(p)) {
        *reinterpret_cast<float4*>(p) = make_float4(a0, a1, a2, a3);
    } else {
        p[0] = a0;
        p[1] = a1;
        p[2] = a2;
        p[3] = a3;
    }
}

__device__ __forceinline__ bool hopeless_lane(const K5Args& a, float y, float x, bool& outside) {
    outside = a.outside_test && ((y < a.lo_y) | (y > a.hi_y) | (x < a.lo_x) | (x > a.hi_x));
    return outside || !(isfinite(y) && isfinite(x));
}

// stagecache._full for lane i of round s, whose row goes to ``rowout`` (25
// floats: shared memory in a full eval, the lane's own row in a repair).
// Returns the pic evaluations and sets the re-seed flag and walk length.
template <bool kPass2>
__device__ __forceinline__ void search_lane(const K5Args& a, long long i, int s, bool outside,
                                            float* rowout, unsigned& evals, bool& reseed,
                                            int& it) {
    const float y = a.y[i], x = a.x[i];
    const float qx = a.qx[i], qy = a.qy[i], qz = a.qz[i];
    const int ti = a.ti[i], t1i = a.t1i[i], zc = a.zc[i], wzi = a.wzi[i];

    // 1. point-in-cell at the warm cell, the raster entry loaded beside it
    int yi = clampi(a.yi_w[i], 0, a.ny - 2);
    int xi = clampi(a.xi_w[i], 0, a.nx - 2);
    int ly = 0, lx = 0;
    if (a.has_lookup) {
        const int ry = to_index(floorf(mul(sub(y, a.ly0), a.inv_lys)), 0, a.lny - 1);
        const int rx = to_index(floorf(mul(sub(x, a.lx0), a.inv_lxs)), 0, a.lnx - 1);
        const long long k = (long long)ry * a.lnx + rx;
        ly = __ldg(a.lk_y + k);
        lx = __ldg(a.lk_x + k);
    }
    float xsi, eta;
    bool found = pic(a, yi, xi, qx, qy, qz, xsi, eta);
    evals = 1;

    // 2. re-seed a miss from the raster
    reseed = a.has_lookup && !found;
    if (reseed) {
        yi = clampi(ly, 0, a.ny - 2);
        xi = clampi(lx, 0, a.nx - 2);
    }

    // 3. the walk; a found or stalled lane is a fixed point and stops
    const int limit = kPass2 ? a.nwalk[s] : a.n_walk;
    float best = INFINITY;
    int by = 0, bx = 0;
    it = 0;
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

    float r[28];
    load_row<7>(a, clampi(cell, 0, (int)(a.table_rows - 1)), r);
#pragma unroll
    for (int c = 0; c < ROW_COLS; ++c) rowout[c] = r[c];
    float fx, fe;
    pic_cols(r, qx, qy, qz, fx, fe);
    a.xsi[i] = fx;
    a.eta[i] = fe;

    const int yi_o = clampi(ys + a.off_y, 0, a.uY - 1);
    const int xw = clampi(xs, 0, a.uX - 2 > 0 ? a.uX - 2 : 0);
    store4(a.u4 + i * 4, gather(a.U, a.uT, a.uZ, a.uY, a.uX, ti, zc, yi_o, xw),
           gather(a.U, a.uT, a.uZ, a.uY, a.uX, t1i, zc, yi_o, xw),
           gather(a.U, a.uT, a.uZ, a.uY, a.uX, ti, zc, yi_o, xw + 1),
           gather(a.U, a.uT, a.uZ, a.uY, a.uX, t1i, zc, yi_o, xw + 1));
    const int xi_o = clampi(xs + a.off_x, 0, a.uX - 1);
    const int yv = clampi(ys, 0, a.uY - 2 > 0 ? a.uY - 2 : 0);
    store4(a.v4 + i * 4, gather(a.V, a.vT, a.vZ, a.vY, a.vX, ti, zc, yv, xi_o),
           gather(a.V, a.vT, a.vZ, a.vY, a.vX, t1i, zc, yv, xi_o),
           gather(a.V, a.vT, a.vZ, a.vY, a.vX, ti, zc, yv + 1, xi_o),
           gather(a.V, a.vT, a.vZ, a.vY, a.vX, t1i, zc, yv + 1, xi_o));
    if (a.W) {
        const int z1 = clampi(wzi + 1, 0, a.wZ - 1);
        store4(a.w4 + i * 4, gather(a.W, a.wT, a.wZ, a.wY, a.wX, ti, wzi, yi_o, xi_o),
               gather(a.W, a.wT, a.wZ, a.wY, a.wX, t1i, wzi, yi_o, xi_o),
               gather(a.W, a.wT, a.wZ, a.wY, a.wX, ti, z1, yi_o, xi_o),
               gather(a.W, a.wT, a.wZ, a.wY, a.wX, t1i, z1, yi_o, xi_o));
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

// ---- (a) check and plan ----

__device__ __forceinline__ unsigned long long load_status(const long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void store_status(long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Warp 0 of tile ``tile``: publish the tile's miss count, then sum the counts
// of the tiles before it, back to the nearest one whose inclusive prefix is
// published, 32 tiles a step. Returns the misses before the tile.
__device__ __forceinline__ long long look_back(long long* status, long long tile, long long total, int lane) {
    if (tile == 0) {
        if (lane == 0) store_status(status, FLAG_PREFIX | (unsigned long long)total);
        return 0;
    }
    if (lane == 0) store_status(status + tile, FLAG_AGG | (unsigned long long)total);
    long long before = 0;
    for (long long j = tile - 1;; j -= 32) {
        const long long idx = j - lane;  // lane 0 the nearest tile
        unsigned long long s = idx >= 0 ? load_status(status + idx) : FLAG_PREFIX;
        while (__any_sync(FULL, (s >> 62) == 0)) {
            if ((s >> 62) == 0) s = load_status(status + idx);
        }
        const unsigned pre = __ballot_sync(FULL, (s >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        unsigned long long v = lane <= stop ? (s & VALUE_MASK) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
        before += (long long)__shfl_sync(FULL, v, 0);
        if (pre) break;
    }
    if (lane == 0) store_status(status + tile, FLAG_PREFIX | (unsigned long long)(before + total));
    return before;
}

__global__ void __launch_bounds__(THREADS) check_kernel(const K5Args a) {
    __shared__ float s_row[THREADS * ROW_COLS];
    __shared__ int s_warp[WARPS];
    __shared__ long long s_tile, s_before, s_total;
    __shared__ int s_last_miss;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    long long* status = a.plan + PLAN_HEAD;
    if (t == 0) s_tile = (long long)atomicAdd(reinterpret_cast<unsigned long long*>(a.plan + 3), 1ULL);
    __syncthreads();
    const long long tile = s_tile;
    const long long i0 = tile * THREADS;
    const int m = (int)(a.n - i0 < THREADS ? a.n - i0 : THREADS);

    // the tile's cached rows, 16 bytes a thread (i0 * 100 bytes is 16-aligned)
    const float* src = a.c_row + i0 * ROW_COLS;
    const int nf = m * ROW_COLS;
    int j0 = 0;
    if (aligned16(a.c_row)) {
        const int nv = nf >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(s_row);
        for (int j = t; j < nv; j += THREADS) d4[j] = __ldg(s4 + j);
        j0 = nv << 2;
    }
    for (int j = j0 + t; j < nf; j += THREADS) s_row[j] = __ldg(src + j);
    __syncthreads();

    // stagecache's hit check; every lane's (xsi, eta) from its cached row
    bool miss = false;
    const long long i = i0 + t;
    if (t < m) {
        float xs, et;
        const bool ok = pic_cols(s_row + t * ROW_COLS, a.qx[i], a.qy[i], a.qz[i], xs, et);
        const bool hit = ok & (a.ti[i] == a.c_ti[i]) & (a.zc[i] == a.c_zi[i]) &
                         (a.wzi[i] == a.c_wzi[i]) & (a.c_cell[i] >= 0);
        const float y = a.y[i], x = a.x[i];
        miss = !hit && isfinite(y) && isfinite(x) && (a.mask == nullptr || a.mask[i]);
        a.xsi[i] = xs;
        a.eta[i] = et;
        if (!miss) a.esc[i] = 0;
        if (i == a.n - 1) s_last_miss = miss;
    }

    // each miss's rank in lane order
    const unsigned ballot = __ballot_sync(FULL, miss);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
        const int own = lane < WARPS ? s_warp[lane] : 0;
        int v = own;
#pragma unroll
        for (int o = 1; o < WARPS; o <<= 1) {
            const int u = __shfl_up_sync(FULL, v, o);
            if (lane >= o) v += u;
        }
        const int total = __shfl_sync(FULL, v, WARPS - 1);
        __syncwarp();
        if (lane < WARPS) s_warp[lane] = v - own;
        const long long before = look_back(status, tile, total, lane);
        if (lane == 0) {
            s_before = before;
            s_total = total;
        }
    }
    __syncthreads();
    if (miss) {
        const long long place = s_before + s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
        a.work[place] = (int)i;
    }

    // the last tile closes the plan: counts, rounds, and the pad of a short last round
    if (t == 0 && tile == (a.n + THREADS - 1) / THREADS - 1) {
        const long long cnt = s_before + s_total;
        const bool pad = (cnt % a.k) != 0 && !s_last_miss;
        if (pad) a.work[cnt] = (int)(a.n - 1);
        a.plan[0] = cnt;
        a.plan[1] = (cnt + a.k - 1) / a.k;
        a.plan[2] = cnt + (pad ? 1 : 0);
    }
}

// ---- (b), (c): the search passes over the work list ----

// kList: lanes from the work list (a stage), else every lane (a full eval),
// whose rows a tile stages through shared memory. kPass2: the lanes that
// start hopeless, walking their round's count.
template <bool kPass2, bool kList>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) search_kernel(const K5Args a) {
    __shared__ float s_row[kList ? 1 : THREADS * ROW_COLS];
    __shared__ unsigned char s_wrote[kList ? 1 : THREADS];
    const int t = threadIdx.x, lane = t & 31;
    const long long len = kList ? a.plan[2] : a.n;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long base = (long long)blockIdx.x * THREADS; base < len; base += stride) {
        const long long p = base + t;
        long long i = p;
        int s = 0;
        bool active = p < len;
        bool outside = false;
        if (active) {
            if constexpr (kList) {
                i = a.work[p];
                s = (int)(p / a.k);
            }
            active = hopeless_lane(a, a.y[i], a.x[i], outside) == kPass2;
        }
        unsigned evals = 0;
        bool reseed = false;
        int it = 0;
        float* rowout = kList ? a.row + i * ROW_COLS : s_row + t * ROW_COLS;
        if (active) search_lane<kPass2>(a, i, s, outside, rowout, evals, reseed, it);

        if constexpr (!kPass2) {  // the round's walk length, one atomic a warp and round
            const bool walked = active && it > 0;
            const unsigned wm = __ballot_sync(FULL, walked);
            if (walked) {
                const unsigned grp = __match_any_sync(wm, s);
                const int most = __reduce_max_sync(grp, it);
                if (lane == __ffs(grp) - 1) atomicMax(a.nwalk + s, most);
            }
        }
        if (a.iters) {
            const unsigned e = __reduce_add_sync(FULL, evals);
            const unsigned r = __reduce_add_sync(FULL, reseed ? 1u : 0u);
            if (lane == 0 && e) atomicAdd(a.iters, (unsigned long long)e);
            if (lane == 0 && r) atomicAdd(a.iters + 1, (unsigned long long)r);
        }

        if constexpr (!kList) {  // the tile's rows leave in 16-byte stores
            s_wrote[t] = active;
            if (!__syncthreads_or(active)) continue;
            const long long mrem = len - base;
            const int m = (int)(mrem < THREADS ? mrem : THREADS);
            const int nf = m * ROW_COLS;
            float* dst = a.row + base * ROW_COLS;
            const bool vec = aligned16(a.row);
            for (int j = 4 * t; j < nf; j += 4 * THREADS) {
                const int l0 = j / ROW_COLS, l1 = (j + 3) / ROW_COLS;
                if (vec && j + 3 < nf && s_wrote[l0] && s_wrote[l1]) {
                    *reinterpret_cast<float4*>(dst + j) =
                        *reinterpret_cast<const float4*>(s_row + j);
                } else {
                    for (int f = j; f < j + 4 && f < nf; ++f) {
                        if (s_wrote[f / ROW_COLS]) dst[f] = s_row[f];
                    }
                }
            }
            __syncthreads();
        }
    }
}

// the blocks of a search pass that fit on the card at once
int pass_grid(const void* kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// ---- launcher ----
// A stage (work != null): one memset of the plan, (a), then (b) and (c) on a
// fixed grid. A full eval: one memset of nwalk, (b) and (c) over the lanes.
extern "C" int cgrid_repair_launch(const K5Args* args, void* stream) {
    K5Args a = *args;
    if (a.n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool stage = a.work != nullptr;
    const long long tiles = stage ? (a.n + THREADS - 1) / THREADS : 0;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    a.nwalk = reinterpret_cast<int*>(a.plan + PLAN_HEAD + tiles);
    cudaError_t err = cudaMemsetAsync(
        a.plan, 0, (size_t)(PLAN_HEAD + tiles) * 8 + (size_t)a.nslots * 4, st);
    if (err != cudaSuccess) return (int)err;
    static int grid[2] = {0, 0};  // the passes' grids (stage, full eval), once a process: one card each
    if (stage) {
        check_kernel<<<(unsigned)tiles, THREADS, 0, st>>>(a);
        if (!grid[0]) grid[0] = pass_grid((const void*)search_kernel<false, true>);
        search_kernel<false, true><<<grid[0], THREADS, 0, st>>>(a);
        search_kernel<true, true><<<grid[0], THREADS, 0, st>>>(a);
    } else {
        if (!grid[1]) grid[1] = pass_grid((const void*)search_kernel<false, false>);
        const long long need = (a.n + THREADS - 1) / THREADS;
        const int g = (int)(need < grid[1] ? need : grid[1]);
        search_kernel<false, false><<<g, THREADS, 0, st>>>(a);
        search_kernel<true, false><<<g, THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}
