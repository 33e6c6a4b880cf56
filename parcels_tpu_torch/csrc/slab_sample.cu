// K2: binned slab sampler over engine-sorted lanes, staging field windows in
// a ring of z-planes in shared memory.
//
// Replaces the JAX package's parcels_tpu/ops/binned_sample.py:_slab_kernel
// (launched by _run_kernel), which DMAs two bin slabs of an HBM-scale field
// into VMEM per chunk and contracts hat weights against them on the TPU's
// matrix unit in a bf16 hi/lo split.
//
// What bounds it on the card: bytes and latency. Per lane it reads its four
// int32 cell indices and four f32 bcoords and writes one f32; per 128-lane
// sub-block it needs a (WT, WZ, SY, SX) window of a field larger than the
// 50 MB L2. Staging a whole window at every window change stages 4.5 times
// the field at path (b)'s shape, and a block that stages and samples one
// sub-block at a time spends most of its time waiting on loads. The design:
//
// - a ring of RZ >= WZ z-planes (x WT x SY x SX floats) in shared memory;
//   field plane z lives in slot z % RZ;
// - a block of GROUP x 128 threads samples a group of up to GROUP = 4
//   consecutive sub-blocks at once: sub-blocks of one (t0, y, x) origin whose z windows
//   together span at most RZ planes. A group loads only the planes of its
//   span that the previous group (of the same origin) did not hold, so a
//   window that moves by d < WZ planes costs d planes; a change of origin
//   or a jump of WZ or more restages in full;
// - the grid is a fixed number of blocks (two per SM, ops/binned_sample.k2_grid),
//   each walking an equal share of consecutive chunks (the engine's sort
//   puts about three chunks in a bin), keeping its ring from one chunk to
//   the next and skipping dead chunks;
// - the planes are copied asynchronously, one cp.async.bulk per window row
//   where rows and origins are 16-byte aligned (X % 4 == 0, x origins on 4
//   floats), else one 4-byte cp.async per element, and complete on an
//   mbarrier; the group's lanes load their positions meanwhile.
//
// Given a counter, the kernel adds to it the bytes of every copy it issues;
// ops/binned_sample.staged_bytes counts the same on the host from the plan.
// It adds to `overflow` the lanes it reads partly from device memory, the
// lanes that ops/binned_sample._overflow_lanes flags: each thread counts its
// own, and at the end a warp sums them into a shared count and the block
// adds that with one atomic (a ballot and a shared atomic at each sample
// spilled a register and took 4 % longer; PERF.md has the readings).
// PERF.md (PR 5) has the readings behind GROUP, the ring's spare planes and
// the grid.
//
// Plan inputs (per chunk g, per sub-block s): t0[g]; slab origins
// (z1, y1, x1) and (z2, y2, x2)[g]; shalf[g*NS+s] picks the slab half;
// z0w[g*NS+s] offsets the z window inside it; live[g] == 0 marks a chunk with
// no live lane, which writes 0. Per lane: its (t, z, y, x) cell index and
// bcoord, as the search gave them.
//
// A lane takes the plain gather's stencil (ops/binned_sample._gather16):
// corners clamp(index + k, 0, dim - 1), weights 1 - bcoord and bcoord (one
// corner of weight 1 on an axis of one point), each corner's value times
// the t, z, y and x weights in that order, summed in corner order from the
// first term. A corner inside the lane's window reads the window's copy in
// shared memory; a corner outside it (overflow lanes: chunks straddling
// three bins, sub-blocks straddling a z transition, stale or unsorted
// lanes) reads the field in device memory through the read-only path. So
// every lane of a live chunk gets the gather's bits, whichever chunk serves
// it, and no lane needs a second pass. Every product and sum is
// rounded on its own (no FMA), so the kernel equals its plain version
// (ops/binned_sample.slab_sample_plain) bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;
// sub-blocks a block samples at once, at most (its threads: that many LANEs)
constexpr int GROUP = 4;
constexpr int THREADS = GROUP * LANE;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}

// one row of the window: global -> shared, counted on the mbarrier's bytes
__device__ __forceinline__ void bulk_row(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void copy_f32(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

// arrives on the mbarrier once this thread's earlier cp.async copies landed
__device__ __forceinline__ void arrive_after_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
                 : "memory");
}

struct Window {
    int t0, z, y, x;  // field origin: time level, z plane, row, column; t0 < 0 marks a dead chunk
};

struct Geometry {
    int T, Z, Y, X, WT, WZ, RZ, SY, SX;
};

__device__ __forceinline__ bool same_origin(const Window& a, const Window& b) {
    return a.t0 == b.t0 && a.y == b.y && a.x == b.x;
}

// Start the copies of field planes [a0, b0) and [a1, b1) at window origin w
// into their ring slots (plane z in slot z % RZ); the mbarrier completes
// when all have landed. Every thread of the block calls it; thread 0 adds
// the bytes to *staged when it is given.
template <bool VEC>
__device__ void stage(const float* __restrict__ data, float* ring, const Window& w, int a0,
                      int b0, int a1, int b1, const Geometry& g, uint64_t* bar,
                      unsigned long long* staged) {
    const int n0 = b0 - a0;
    const int rows = (n0 + b1 - a1) * g.WT * g.SY;
    if (staged != nullptr && threadIdx.x == 0)
        atomicAdd(staged, (unsigned long long)rows * g.SX * sizeof(float));
    auto row_of = [&](int r, int& z, int& t, int& y) {
        const int k = r / (g.WT * g.SY);
        const int rr = r - k * (g.WT * g.SY);
        z = k < n0 ? a0 + k : a1 + (k - n0);
        t = rr / g.SY;
        y = rr - t * g.SY;
    };
    if (VEC) {
        const uint32_t row_bytes = (uint32_t)g.SX * 4u;
        if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, row_bytes * rows);
        // the slots were last read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int r = threadIdx.x; r < rows; r += THREADS) {
            int z, t, y;
            row_of(r, z, t, y);
            const float* src =
                data + (((long long)(w.t0 + t) * g.Z + z) * g.Y + (w.y + y)) * g.X + w.x;
            bulk_row(ring + ((t * g.RZ + z % g.RZ) * g.SY + y) * g.SX, src, row_bytes, bar);
        }
    } else {
        for (int e = threadIdx.x; e < rows * g.SX; e += THREADS) {
            const int r = e / g.SX, c = e - r * g.SX;
            int z, t, y;
            row_of(r, z, t, y);
            const float* src =
                data + (((long long)(w.t0 + t) * g.Z + z) * g.Y + (w.y + y)) * g.X + w.x + c;
            copy_f32(ring + ((t * g.RZ + z % g.RZ) * g.SY + y) * g.SX + c, src);
        }
        arrive_after_copies(bar);
    }
}

// Block b walks the sub-blocks of chunks [b G / B, (b + 1) G / B), GROUP
// at a time: a group is up to GROUP consecutive live sub-blocks of one
// (t0, y, x) origin whose z windows together span at most RZ planes. The
// group loads the planes of its span that the previous group's span (of
// the same origin) did not hold, its lanes load their positions meanwhile,
// and each thread samples one lane once the planes have landed.
// Two blocks an SM (ops/binned_sample.k2_grid), so at most 64 registers a thread.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) slab_sample_kernel(
    const float* __restrict__ data, Geometry g, const int* __restrict__ t0,
    const int* __restrict__ z1, const int* __restrict__ y1, const int* __restrict__ x1,
    const int* __restrict__ z2, const int* __restrict__ y2, const int* __restrict__ x2,
    const int* __restrict__ shalf, const int* __restrict__ z0w, const int* __restrict__ live,
    const int* __restrict__ it, const int* __restrict__ iz, const int* __restrict__ iy,
    const int* __restrict__ ix, const float* __restrict__ bt, const float* __restrict__ bz,
    const float* __restrict__ by, const float* __restrict__ bx, float* __restrict__ out, int n,
    int G, int NS, int ring_offset, unsigned long long* staged, unsigned long long* overflow) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    __shared__ unsigned int far_lanes;  // this block's overflow lanes
    Window* wins = reinterpret_cast<Window*>(smem + 16);
    float* ring = reinterpret_cast<float*>(smem + ring_offset);
    const int tid = threadIdx.x;
    const int g_begin = (int)((long long)blockIdx.x * G / gridDim.x);
    const int g_end = (int)((long long)(blockIdx.x + 1) * G / gridDim.x);
    const int nsub = (g_end - g_begin) * NS;
    const long long q0 = (long long)g_begin * NS;

    for (int k = tid; k < nsub; k += THREADS) {
        const int gg = g_begin + k / NS;
        Window w{-1, 0, 0, 0};
        if (live[gg] != 0) {
            const bool h = shalf[q0 + k] != 0;
            w = Window{t0[gg], (h ? z2[gg] : z1[gg]) + z0w[q0 + k], h ? y2[gg] : y1[gg],
                       h ? x2[gg] : x1[gg]};
        }
        wins[k] = w;
    }
    for (int gg = g_begin; gg < g_end; ++gg) {
        if (live[gg] == 0) {
            for (int e = tid; e < NS * LANE; e += THREADS) {
                const long long i = (long long)gg * NS * LANE + e;
                if (i < n) out[i] = 0.0f;
            }
        }
    }
    if (tid == 0) {
        far_lanes = 0;
        mbar_init(bar, VEC ? 1 : THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    auto next_live = [&](int k) {
        while (k < nsub && wins[k].t0 < 0) ++k;
        return k;
    };
    const int j = tid / LANE;  // this thread's sub-block within a group
    Window prev{-1, 0, 0, 0};
    int plo = 0, phi = 0;  // the previous group's span of planes
    uint32_t phase = 0;
    unsigned my_far = 0;  // lanes this thread read partly from device memory
    int k = next_live(0);
    while (k < nsub) {
        const Window first = wins[k];
        int lo = first.z, hi = first.z + g.WZ, cnt = 1;
        while (cnt < GROUP && k + cnt < nsub) {
            const Window w = wins[k + cnt];
            const int nlo = min(lo, w.z), nhi = max(hi, w.z + g.WZ);
            if (w.t0 < 0 || !same_origin(first, w) || nhi - nlo > g.RZ) break;
            lo = nlo;
            hi = nhi;
            ++cnt;
        }
        // the planes of [lo, hi) outside the previous span, which stays resident
        int a0 = lo, b0 = hi, a1 = hi, b1 = hi;
        if (prev.t0 >= 0 && same_origin(prev, first)) {
            b0 = max(lo, min(hi, plo));
            a1 = min(hi, max(lo, phi));
        }
        const bool load = b0 > a0 || b1 > a1;
        if (load) stage<VEC>(data, ring, first, a0, b0, a1, b1, g, bar, staged);

        const long long q = q0 + k + j;
        const long long i = q * LANE + (tid - j * LANE);
        const bool mine = j < cnt && i < n;
        int idx[4] = {0, 0, 0, 0};
        float bc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        Window w = first;
        if (mine) {
            idx[0] = it[i];
            idx[1] = iz[i];
            idx[2] = iy[i];
            idx[3] = ix[i];
            bc[0] = bt[i];
            bc[1] = bz[i];
            bc[2] = by[i];
            bc[3] = bx[i];
            w = wins[k + j];
        }
        if (load) {
            mbar_wait(bar, phase);
            phase ^= 1u;
        }
        if (mine) {
            const int dim[4] = {g.T, g.Z, g.Y, g.X};
            const int org[4] = {w.t0, w.z, w.y, w.x};
            const int ext[4] = {g.WT, g.WZ, g.SY, g.SX};
            int c[4][2];  // the field's corners
            float wgt[4][2];
            bool ok[4][2];  // the corner lies in the window
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int top = dim[a] - 1;
                c[a][0] = min(max(idx[a], 0), top);
                // clamp(index + 1, 0, top) without overflowing index + 1
                c[a][1] = idx[a] >= top ? top : max(idx[a] + 1, 0);
                wgt[a][0] = top > 0 ? __fsub_rn(1.0f, bc[a]) : 1.0f;
                wgt[a][1] = bc[a];
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
                    ok[a][kk] = (unsigned)(c[a][kk] - org[a]) < (unsigned)ext[a];
            }
            const int nt = g.T > 1 ? 2 : 1, nz = g.Z > 1 ? 2 : 1;
            // the corners outside the window, read from the field first, all
            // at once, where any lane of the warp has one
            float far[2][2][2][2];
            const bool inside = ok[0][0] && ok[0][1] && ok[1][0] && ok[1][1] && ok[2][0] &&
                                ok[2][1] && ok[3][0] && ok[3][1];
            const bool warp_inside = __all_sync(__activemask(), inside);
            my_far += inside ? 0u : 1u;
#pragma unroll
            for (int kt = 0; kt < 2; ++kt)
#pragma unroll
                for (int kz = 0; kz < 2; ++kz)
#pragma unroll
                    for (int ky = 0; ky < 2; ++ky)
#pragma unroll
                        for (int kx = 0; kx < 2; ++kx) {
                            far[kt][kz][ky][kx] = 0.0f;
                            if (!warp_inside && kt < nt && kz < nz &&
                                !(ok[0][kt] && ok[1][kz] && ok[2][ky] && ok[3][kx]))
                                far[kt][kz][ky][kx] =
                                    __ldg(data + (((long long)c[0][kt] * g.Z + c[1][kz]) * g.Y +
                                                  c[2][ky]) * g.X + c[3][kx]);
                        }
            const int slot0 = w.z % g.RZ;
            float acc = 0.0f;
#pragma unroll
            for (int kt = 0; kt < 2; ++kt) {
                if (kt >= nt) continue;
#pragma unroll
                for (int kz = 0; kz < 2; ++kz) {
                    if (kz >= nz) continue;
#pragma unroll
                    for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
                        for (int kx = 0; kx < 2; ++kx) {
                            float v = far[kt][kz][ky][kx];
                            if (ok[0][kt] && ok[1][kz] && ok[2][ky] && ok[3][kx]) {
                                int slot = slot0 + (c[1][kz] - w.z);
                                if (slot >= g.RZ) slot -= g.RZ;
                                const int r = ((c[0][kt] - w.t0) * g.RZ + slot) * g.SY +
                                              (c[2][ky] - w.y);
                                v = ring[r * g.SX + (c[3][kx] - w.x)];
                            }
                            v = __fmul_rn(v, wgt[0][kt]);
                            v = __fmul_rn(v, wgt[1][kz]);
                            v = __fmul_rn(v, wgt[2][ky]);
                            v = __fmul_rn(v, wgt[3][kx]);
                            // the sum starts from the first corner's term, as the gather's
                            acc = (kt | kz | ky | kx) == 0 ? v : __fadd_rn(acc, v);
                        }
                    }
                }
            }
            out[i] = acc;
        }
        __syncthreads();  // every lane is done with this group's slots
        prev = first;
        plo = lo;
        phi = hi;
        k = next_live(k + cnt);
    }
    // every warp's count into the block's, then one atomic a block
    my_far = __reduce_add_sync(0xffffffffu, my_far);
    if ((tid & 31) == 0 && my_far != 0) atomicAdd(&far_lanes, my_far);
    __syncthreads();
    if (tid == 0 && far_lanes != 0) atomicAdd(overflow, (unsigned long long)far_lanes);
}

}  // namespace

extern "C" int slab_sample_launch(const float* data, int T, int Z, int Y, int X, const int* t0,
                                  const int* z1, const int* y1, const int* x1, const int* z2,
                                  const int* y2, const int* x2, const int* shalf, const int* z0w,
                                  const int* live, const int* it, const int* iz, const int* iy,
                                  const int* ix, const float* bt, const float* bz,
                                  const float* by, const float* bx, float* out, int n, int G,
                                  int WT, int WZ, int RZ, int SY, int SX, int NS, int blocks,
                                  int vec4, unsigned long long* staged,
                                  unsigned long long* overflow, void* stream) {
    if (RZ < WZ) return (int)cudaErrorInvalidValue;
    const Geometry g{T, Z, Y, X, WT, WZ, RZ, SY, SX};
    if (blocks < 1 || blocks > G) return (int)cudaErrorInvalidValue;
    const int per_block = (G + blocks - 1) / blocks;  // chunks a block walks, at most
    const int head = 16 + per_block * NS * (int)sizeof(Window);
    const int ring_offset = (head + 127) / 128 * 128;
    const size_t smem = ring_offset + (size_t)WT * RZ * SY * SX * sizeof(float);
    auto kernel = vec4 ? &slab_sample_kernel<true> : &slab_sample_kernel<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        data, g, t0, z1, y1, x1, z2, y2, x2, shalf, z0w, live, it, iz, iy, ix, bt, bz, by, bx,
        out, n, G, NS, ring_offset, staged, overflow);
    return (int)cudaGetLastError();
}
