// K2: binned slab sampler over engine-sorted lanes, staging field windows in
// a ring of z-planes in shared memory.
//
// Replaces the JAX package's parcels_tpu/ops/binned_sample.py:_slab_kernel
// (launched by _run_kernel), which DMAs two bin slabs of an HBM-scale field
// into VMEM per chunk and contracts hat weights against them on the TPU's
// matrix unit in a bf16 hi/lo split.
//
// What bounds it on the card: bytes and latency. Per lane it reads four f32
// positions and writes one f32; per 128-lane sub-block it needs a
// (WT, WZ, SY, SX) window of a field larger than the 50 MB L2. Staging a
// whole window at every window change stages 4.5 times the field at path
// (b)'s shape, and a block that stages and samples one sub-block at a time
// spends most of its time waiting on loads. The design:
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
// PERF.md (PR 5) has the readings behind GROUP, the ring's spare planes and
// the grid.
//
// Plan inputs (per chunk g, per sub-block s): t0[g]; slab origins
// (z1, y1, x1) and (z2, y2, x2)[g]; shalf[g*NS+s] picks the slab half;
// z0w[g*NS+s] offsets the z window inside it; live[g] == 0 marks a chunk with
// no live lane, which writes 0. Positions are relative to each lane's own
// slab origin. Lanes outside their sub-block's window keep the partial sum of
// the corners inside it; the plan flags them as overflow and the caller
// repairs them with a plain gather. The sum keeps hat.cuh's order, so the
// kernel equals its plain version (ops/binned_sample.slab_sample_plain) bit
// for bit.
#include <cstdint>

#include "hat.cuh"

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
template <bool VEC>
__global__ void __launch_bounds__(THREADS) slab_sample_kernel(
    const float* __restrict__ data, Geometry g, const int* __restrict__ t0,
    const int* __restrict__ z1, const int* __restrict__ y1, const int* __restrict__ x1,
    const int* __restrict__ z2, const int* __restrict__ y2, const int* __restrict__ x2,
    const int* __restrict__ shalf, const int* __restrict__ z0w, const int* __restrict__ live,
    const float* __restrict__ pt, const float* __restrict__ pz, const float* __restrict__ py,
    const float* __restrict__ px, float* __restrict__ out, int G, int NS, int ring_offset,
    unsigned long long* staged) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
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
            for (int e = tid; e < NS * LANE; e += THREADS) out[(long long)gg * NS * LANE + e] = 0.0f;
        }
    }
    if (tid == 0) {
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

        const bool mine = j < cnt;
        const long long q = q0 + k + j;
        const long long i = q * LANE + (tid - j * LANE);
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int zw = 0;
        Window w = first;
        if (mine) {
            p[0] = pt[i];
            p[1] = pz[i];
            p[2] = py[i];
            p[3] = px[i];
            zw = z0w[q];
            w = wins[k + j];
        }
        if (load) {
            mbar_wait(bar, phase);
            phase ^= 1u;
        }
        if (mine) {
            const float pr[4] = {p[0], __fsub_rn(p[1], (float)zw), p[2], p[3]};
            const int ext[4] = {g.WT, g.WZ, g.SY, g.SX};
            int c0[4];
            float wt4[4][2];
            bool ok[4][2];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float f = parcels::lower_corner(pr[a], ext[a]);
                c0[a] = (int)f;
#pragma unroll
                for (int kk = 0; kk < 2; ++kk) {
                    const int c = c0[a] + kk;
                    wt4[a][kk] = parcels::hat((float)c, pr[a]);
                    ok[a][kk] = c >= 0 && c < ext[a];
                }
            }
            const int slot0 = w.z % g.RZ;
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
                            int slot = slot0 + c0[1] + kz;
                            if (slot >= g.RZ) slot -= g.RZ;
                            const int r = ((c0[0] + kt) * g.RZ + slot) * g.SY + (c0[2] + ky);
                            const float wt = __fmul_rn(
                                __fmul_rn(__fmul_rn(wt4[0][kt], wt4[1][kz]), wt4[2][ky]),
                                wt4[3][kx]);
                            acc = __fadd_rn(acc, __fmul_rn(wt, ring[r * g.SX + c0[3] + kx]));
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
}

}  // namespace

extern "C" int slab_sample_launch(const float* data, int T, int Z, int Y, int X, const int* t0,
                                  const int* z1, const int* y1, const int* x1, const int* z2,
                                  const int* y2, const int* x2, const int* shalf, const int* z0w,
                                  const int* live, const float* pt, const float* pz,
                                  const float* py, const float* px, float* out, int G, int WT,
                                  int WZ, int RZ, int SY, int SX, int NS, int blocks, int vec4,
                                  unsigned long long* staged, void* stream) {
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
        data, g, t0, z1, y1, x1, z2, y2, x2, shalf, z0w, live, pt, pz, py, px, out, G, NS,
        ring_offset, staged);
    return (int)cudaGetLastError();
}
