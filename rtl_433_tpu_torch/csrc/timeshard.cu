// Time-shard verification chain and candidate gather: two kernels behind
// two C launchers.
//
// Replaces: the collectives of rtl_433_tpu/parallel/timeshard.py::
// timeshard_process_block (:110): the all_gather of the boundary registers
// and the replicated verification chain (:189-243), the per-device hedge
// candidate select (:245-258), the generation rebase (:260-265), the
// counter psum (:267-281) and the block-outgoing registers (:272-281). No
// Pallas kernel existed for them; on the TPU they are XLA collectives over
// the "sp" mesh axis. On one card the D time segments, and their three
// low_est hedge candidates, are lanes of one front-end and one detector
// launch (parallel/timeshard.py), so the registers and logs these
// collectives exchange already sit in one tensor each.
//
// Lane layout (written by parallel/timeshard.py, read here):
//   start [NROW, D*C]: segment d's start registers for channel c at lane
//     d*C + c (segment 0: the block-incoming seed);
//   fin [NROW, 3*D*C]: the final registers of hedge candidate k (low_est
//     offset k - 1) at lane (k*D + d)*C + c;
//   rows: ops/detector.py REG_KEYS, then ops/frontend.py STATE_KEYS.
//   rowinfo[row]: bits 0-7 the verification key's index + 1 (0: not
//     compared; keys 0 and 1, low_est and high_est, are compared by the
//     hedge rule), bit 8 set for a package-scoped key (compared only while
//     the predecessor has a package open), bit 9 set for a write-only
//     counter (re-based, never compared).
//
// timeshard_chain_kernel, one block of 256 threads per group of up to G =
// 32 channels (fewer where D is so large that the tables below pass 227
// KB; ops/timeshard.py chain_plan), replaces JAX's chain (:194-243). Every
// quantity a link compares (dlow = final low_est - start low_est, the
// selected candidate's high_est, the open gate, each key's mismatch) is a
// function of the predecessor's candidate k (0-2) and the link d alone;
// only the choice of k is sequential. So:
//   phase 1, over (d, k, row chunk, channel), reads coalesced over the
//     channels: per link and predecessor candidate the mask of failed keys
//     (bit 31: the predecessor is open), the candidate the link selects,
//     sel = clip(dlow + 1, 0, 2), and that candidate's generation increment
//     final gen - start gen, into shared memory;
//   phase 2, one lane per channel in warp 0: sel_0 = 1, then for d = 1..D-1
//     the entry of link d for the predecessor's selection: one dependent
//     shared load per link, the running t_gen (delta = t_gen - start gen)
//     beside it; the masks OR-ed over the channels (__reduce_or_sync, one
//     store per link with one block, one atomicOr per warp and link with
//     several, into flags the wrapper then zeroes);
//   phase 3, over (row, channel) and (d, channel): the outgoing registers
//     (the last segment's selected final; a counter is seed + the sum over
//     d of its selected final - start, :267-281), sel and delta, with sel
//     read from shared memory, never from what the kernel wrote.
//
// timeshard_gather_kernel gathers each segment's selected candidate's logs
// into the block's [C*R, D*G] record planes and [C, D*G*E, 9] EOP log,
// adding delta << KEY_IDX_BITS to valid keys and delta to the M_GEN field
// of valid EOPs. All arithmetic wraps as JAX's int32 does (unsigned in C).
// What it moves are contiguous runs: per (channel, ring row, segment) the
// G ints of each record plane, per (channel, segment) the G*E*9 ints of
// the EOP log. So a warp, which is a whole CTA, takes a unit: a record run,
// or a chunk of 32 items of an EOP run (grid-stride over units beyond the
// grid's cap). One warp a CTA puts the units on as many SMs as there are
// units: at C=1, D=8 the eight EOP runs (74 KB) in one 256-thread CTA took
// 6 us on its one SM. The unit's offsets come from 32-bit arithmetic over
// its index, sel and delta are loaded once per unit, and the copy goes 16
// bytes a lane where the runs and their pointers are 16-byte aligned
// (scalar otherwise). An EOP is rebased from its own M_TYPE word in the
// lane's registers: an item is four whole records (nine int4) or, where
// the runs are not aligned, one record, and nothing is loaded twice.
//
// The gather runs behind the chain with no host round trip between them:
// it is launched with programmatic stream serialization (PDL), the chain
// releases it at its start (its blocks are then all resident, and at C=1
// one block leaves 131 SMs free), and the gather's blocks take their
// first unit's offsets before cudaGridDependencySynchronize() (as PTX:
// griddepcontrol.wait), which waits for the chain's results; then bad,
// sel and delta load in one round. With skip_if_bad a set bad flag makes
// every block return without writing: the host reads bad once, after both
// launches, and discards the logs of a block that failed. The candidate
// logs are not read before the wait: the kernel right before the gather
// need not be the chain, and one that wrote them would not yet have made
// its writes visible.
//
// What bounds them. The chain's bytes (NROW ints per lane, 10.7 KB at
// C=1, D=32) would take nanoseconds; a one-block launch takes
// microseconds, so its floor is the launch and the latency of a few
// dependent rounds of loads, not bytes. The design keeps those rounds few:
// every register load of all links is issued in phase 1 at once (no load
// waits on a selection), the walk touches only shared memory, and phase 3
// is one more round. The gather moves every log int once each way (344 KB
// at C=1, D=8, N=131072: about 0.1 us of bytes), so it too is bound by
// latency: its launch, hidden behind the chain by PDL, its wake-up when
// the chain's writes are visible, then two dependent rounds (the chain's
// results, then the units) and the stores. Alone, as a plain launch, it
// measured no faster on an H100 (700 W) than the thread-per-int loop it
// replaced (2.9 us, about 1 us over a launch): what the step gains is
// the PDL launch and the missing host round trip, not the run table.

#include <cstdint>
#include <cuda_runtime.h>

#include "detector_step.cuh"

namespace {

using namespace rtl433;

constexpr int kOpen = 1 << 8;
constexpr int kCounter = 1 << 9;
constexpr int kThreads = 256;
constexpr int M_TYPE = 0, M_GEN = 8, PKG_NONE = 0;

__device__ __forceinline__ int wadd(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// |v| as jnp.abs on int32: INT_MIN stays INT_MIN
__device__ __forceinline__ int wabs(int v) {
    return v < 0 ? static_cast<int>(0u - static_cast<unsigned>(v)) : v;
}

// programmatic dependent launch (sm_90): the PTX of the runtime's
// cudaTriggerProgrammaticLaunchCompletion() and
// cudaGridDependencySynchronize()
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" :::);
}

__device__ __forceinline__ void grid_dependency_sync() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct Rows {
    int low, high, ook_state, min_high, gen;
};

// Shared memory of a chain block of G channels (ops/timeshard.py
// chain_plan sizes it with CHAIN_BYTES_PER_LINK): rowinfo [NROW], then
// per (link d, predecessor candidate k, channel) the failed-key mask with
// the predecessor's open flag in bit 31, the generation increment of the
// candidate it selects, and that candidate; per (d, channel) the running
// t_gen before link d and the selected candidate.
struct ChainSmem {
    int* info;            // [NROW]
    unsigned* msk;        // [D][3][G]
    int* inc;             // [D][3][G]
    int* tg;              // [D][G]
    uint8_t* nxt;         // [D][3][G]
    uint8_t* sel;         // [D][G]
};

__device__ __forceinline__ ChainSmem chain_smem(unsigned char* base, int NROW,
                                               int D, int G) {
    ChainSmem m;
    m.info = reinterpret_cast<int*>(base);
    m.msk = reinterpret_cast<unsigned*>(m.info + NROW);
    m.inc = reinterpret_cast<int*>(m.msk + 3 * D * G);
    m.tg = m.inc + 3 * D * G;
    m.nxt = reinterpret_cast<uint8_t*>(m.tg + D * G);
    m.sel = m.nxt + 3 * D * G;
    return m;
}

constexpr unsigned kOpenFlag = 1u << 31;   // no key index reaches bit 31
constexpr int kRowChunk = 8;               // rows per phase-1b item

__global__ void __launch_bounds__(kThreads)
timeshard_chain_kernel(const int* __restrict__ start,
                       const int* __restrict__ fin,
                       const int* __restrict__ rowinfo, int NROW, int D,
                       int C, int G, int ratio, Rows rw,
                       int* __restrict__ sel_out, int* __restrict__ delta_out,
                       int* __restrict__ out, int* __restrict__ by_key,
                       int* __restrict__ bad) {
    // every block of the chain is resident once each has started: a
    // gather launched behind it with PDL may take the free SMs now (it
    // waits for the chain's results in grid_dependency_sync)
    launch_dependents();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const ChainSmem sm = chain_smem(smem_raw, NROW, D, G);
    const int c0 = blockIdx.x * G;
    const int g = min(G, C - c0);                     // channels of this block
    const size_t L = static_cast<size_t>(D) * C;      // lanes of start
    const size_t L3 = 3 * L;                          // lanes of fin
    // segment d's start, and candidate k's final of segment d, channel c0+c
    auto S = [&](int row, int d, int c) {
        return start[row * L + static_cast<size_t>(d) * C + c0 + c];
    };
    auto F = [&](int row, int k, int d, int c) {
        return fin[row * L3 + (static_cast<size_t>(k) * D + d) * C + c0 + c];
    };
    const int tid = threadIdx.x, nth = blockDim.x;

    // ---- phase 1a, over (d, k, c): the hedge compares of link d against
    // predecessor candidate k, the candidate it selects and that one's
    // generation increment; at d = 0 the running t_gen after segment 0
    for (int i = tid; i < NROW; i += nth) sm.info[i] = rowinfo[i];
    for (int i = tid; i < 3 * D * g; i += nth) {
        const int c = i % g, j = i / g, k = j % 3, d = j / 3;
        const int o = (d * 3 + k) * G + c;
        if (d == 0) {
            // t_gen = gen0 + (final gen - start gen) = the final's gen
            if (k == 1) sm.tg[c] = F(rw.gen, 1, 0, c);
            continue;
        }
        const int st_low = S(rw.low, d, c);
        const int dlow = wsub(F(rw.low, k, d - 1, c), st_low);
        const int s = min(max(wadd(dlow, 1), 0), 2);
        int cand_high = S(rw.high, d, c);
        if (S(rw.ook_state, d, c) == ST_IDLE) {
            const int h = static_cast<int>(static_cast<unsigned>(ratio) *
                                           static_cast<unsigned>(wadd(st_low, dlow)));
            cand_high = max(h, S(rw.min_high, d, c));
        }
        unsigned m = 0u;
        if (wabs(dlow) > 1) m |= 1u;
        if (F(rw.high, k, d - 1, c) != cand_high) m |= 2u;
        if (F(rw.ook_state, k, d - 1, c) != ST_IDLE) m |= kOpenFlag;
        sm.msk[o] = m;
        sm.nxt[o] = static_cast<uint8_t>(s);
        sm.inc[o] = wsub(F(rw.gen, s, d, c), S(rw.gen, d, c));
    }
    __syncthreads();

    // ---- phase 1b, over (d, k, row chunk, c): every other key's compare,
    // OR-ed into the mask (open keys only where the predecessor is open)
    const int nch = (NROW + kRowChunk - 1) / kRowChunk;
    for (int i = tid; i < 3 * (D - 1) * nch * g; i += nth) {
        const int c = i % g;
        int j = i / g;
        const int ch = j % nch;
        j /= nch;
        const int k = j % 3, d = 1 + j / 3;
        const int o = (d * 3 + k) * G + c;
        const bool open = (sm.msk[o] & kOpenFlag) != 0u;
        unsigned m = 0u;
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) {
            const int row = ch * kRowChunk + r;
            if (row >= NROW) break;
            const int info = sm.info[row];
            const int key = (info & 0xff) - 1;
            if (key < 2 || ((info & kOpen) && !open)) continue;
            if (F(row, k, d - 1, c) != S(row, d, c)) m |= 1u << key;
        }
        if (m) atomicOr(&sm.msk[o], m);
    }
    __syncthreads();

    // ---- phase 2, one lane per channel in warp 0: the walk. sel_0 = 1;
    // link d takes the mask, the next candidate and its increment that
    // phase 1 left for the predecessor's candidate: one shared load on the
    // dependent path per link. The masks are OR-ed over the channels.
    if (tid < 32) {
        const unsigned am = g >= 32 ? 0xffffffffu : ((1u << g) - 1u);
        const bool single = gridDim.x == 1;
        if (tid < g) {
            int s = 1;
            int tgen = sm.tg[tid];
            unsigned any = 0u;
            sm.sel[tid] = 1;
            for (int d = 1; d < D; ++d) {
                const int o = (d * 3 + s) * G + tid;
                const unsigned m = sm.msk[o] & ~kOpenFlag;
                sm.tg[d * G + tid] = tgen;
                tgen = wadd(tgen, sm.inc[o]);
                s = sm.nxt[o];
                sm.sel[d * G + tid] = static_cast<uint8_t>(s);
                const unsigned wk = __reduce_or_sync(am, m);
                if (tid == 0) {
                    if (single) by_key[d - 1] = static_cast<int>(wk);
                    else if (wk) atomicOr(&by_key[d - 1], static_cast<int>(wk));
                }
                any |= wk;
            }
            if (tid == 0) {
                if (single) *bad = any ? 1 : 0;
                else if (any) atomicOr(bad, 1);
            }
        }
    }
    __syncthreads();

    // ---- phase 3, over (row, c) and (d, c): the outgoing registers (the
    // last segment's selected final; a counter is the seed plus each
    // segment's selected increment), then sel and delta
    const int nout = NROW * g;
    for (int i = tid; i < nout + D * g; i += nth) {
        if (i < nout) {
            const int c = i % g, row = i / g;
            int v;
            if (sm.info[row] & kCounter) {
                v = S(row, 0, c);                             // the seed
#pragma unroll 4
                for (int d = 0; d < D; ++d)
                    v = wadd(v, wsub(F(row, sm.sel[d * G + c], d, c),
                                     S(row, d, c)));
            } else {
                v = F(row, sm.sel[(D - 1) * G + c], D - 1, c);
            }
            out[static_cast<size_t>(row) * C + c0 + c] = v;
        } else {
            const int j = i - nout, c = j % g, d = j / g;
            const size_t dc = static_cast<size_t>(d) * C + c0 + c;
            sel_out[dc] = sm.sel[d * G + c];
            delta_out[dc] = d == 0 ? 0 : wsub(sm.tg[d * G + c], S(rw.gen, d, c));
        }
    }
}

// A unit of the gather, one warp's work: its source offset at candidate 0,
// in ints (the candidate adds sel times the candidate stride), its
// destination offset, d*C + c (the index of its sel and delta), and for an
// EOP unit the items it holds. Record units are whole runs, numbered
// (c*R + r)*D + d, so that consecutive warps write consecutive columns.
// EOP units follow: run c*D + d cut into chunks of 32 items, an item being
// four records (VEC) or one record, one item a lane.
struct Unit {
    unsigned src, dst, dc, items;
    bool eop;
};

struct Shape {
    unsigned D, C, R, G, GE;
    unsigned n_rec;        // record units: C*R*D
    unsigned eitems;       // items of an EOP run: GE/4 (VEC) or GE
    unsigned echunks;      // chunks of an EOP run: ceil(eitems / 32)
    unsigned item_ints;    // ints of an item: 36 (VEC) or 9
};

__device__ __forceinline__ Unit unit_of(unsigned i, const Shape& sh) {
    Unit u;
    u.eop = i >= sh.n_rec;
    if (!u.eop) {
        const unsigned row = i / sh.D, d = i - row * sh.D;  // row = c*R + r
        const unsigned c = row / sh.R, r = row - c * sh.R;
        u.dc = d * sh.C + c;
        u.src = (u.dc * sh.R + r) * sh.G;
        u.dst = i * sh.G;
        u.items = 0;
    } else {
        const unsigned j = i - sh.n_rec, run = j / sh.echunks;
        const unsigned k = j - run * sh.echunks;        // the chunk
        const unsigned c = run / sh.D, d = run - c * sh.D;
        const unsigned first = k * 32;                  // its first item
        u.dc = d * sh.C + c;
        u.src = u.dc * sh.GE * META_FIELDS + first * sh.item_ints;
        u.dst = run * sh.GE * META_FIELDS + first * sh.item_ints;
        u.items = min(32u, sh.eitems - first);
    }
    return u;
}

__device__ __forceinline__ int rebase_key(int k, unsigned dk) {
    return k < KEY_INVALID
               ? static_cast<int>(static_cast<unsigned>(k) + dk) : k;
}

__device__ __forceinline__ int4 rebase_keys(int4 k, unsigned dk) {
    return make_int4(rebase_key(k.x, dk), rebase_key(k.y, dk),
                     rebase_key(k.z, dk), rebase_key(k.w, dk));
}

// four EOP records (36 ints, nine int4) in registers, each rebased from
// its own M_TYPE word
__device__ __forceinline__ void copy_eop4(const int4* __restrict__ s,
                                          int4* __restrict__ o, int dl) {
    int v[4 * META_FIELDS];
#pragma unroll
    for (int q = 0; q < META_FIELDS; ++q) {
        const int4 t = __ldg(s + q);
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
        if (v[e * META_FIELDS + M_TYPE] != PKG_NONE)
            v[e * META_FIELDS + M_GEN] = wadd(v[e * META_FIELDS + M_GEN], dl);
#pragma unroll
    for (int q = 0; q < META_FIELDS; ++q)
        o[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// one EOP record (nine ints) in registers, rebased from its M_TYPE word
__device__ __forceinline__ void copy_eop1(const int* __restrict__ s,
                                          int* __restrict__ o, int dl) {
    int v[META_FIELDS];
#pragma unroll
    for (int f = 0; f < META_FIELDS; ++f) v[f] = __ldg(s + f);
    if (v[M_TYPE] != PKG_NONE) v[M_GEN] = wadd(v[M_GEN], dl);
#pragma unroll
    for (int f = 0; f < META_FIELDS; ++f) o[f] = v[f];
}

// one warp's unit, of the candidate s, rebased by dl
__device__ __forceinline__ void copy_unit(
    const Unit& u, unsigned s, int dl, unsigned lane, const Shape& sh,
    unsigned rec_stride, unsigned eop_stride, bool vec_rec, bool vec_eop,
    const int* __restrict__ key3, const int* __restrict__ p3,
    const int* __restrict__ g3, const int* __restrict__ eop3,
    int* __restrict__ key, int* __restrict__ p, int* __restrict__ g,
    int* __restrict__ eop) {
    if (u.eop) {
        if (lane >= u.items) return;
        const unsigned off = lane * sh.item_ints;
        const int* es = eop3 + u.src + s * eop_stride + off;
        int* eo = eop + u.dst + off;
        if (vec_eop)
            copy_eop4(reinterpret_cast<const int4*>(es),
                      reinterpret_cast<int4*>(eo), dl);
        else
            copy_eop1(es, eo, dl);
        return;
    }
    const unsigned src = u.src + s * rec_stride;
    const unsigned dk = static_cast<unsigned>(dl) << KEY_IDX_BITS;
    if (vec_rec) {
        const int4* ks = reinterpret_cast<const int4*>(key3 + src);
        const int4* ps = reinterpret_cast<const int4*>(p3 + src);
        const int4* gs = reinterpret_cast<const int4*>(g3 + src);
        int4* ko = reinterpret_cast<int4*>(key + u.dst);
        int4* po = reinterpret_cast<int4*>(p + u.dst);
        int4* go = reinterpret_cast<int4*>(g + u.dst);
        for (unsigned j = lane; j < sh.G / 4; j += 32) {
            const int4 kv = __ldg(ks + j), pv = __ldg(ps + j),
                       gv = __ldg(gs + j);
            ko[j] = rebase_keys(kv, dk);
            po[j] = pv;
            go[j] = gv;
        }
    } else {
        for (unsigned j = lane; j < sh.G; j += 32) {
            const int kv = __ldg(key3 + src + j), pv = __ldg(p3 + src + j),
                      gv = __ldg(g3 + src + j);
            key[u.dst + j] = rebase_key(kv, dk);
            p[u.dst + j] = pv;
            g[u.dst + j] = gv;
        }
    }
}

// one warp a CTA: the units land on as many SMs as there are units (up to
// the grid's cap), so that no SM carries more than a few KB of the copy
__global__ void __launch_bounds__(32)
timeshard_gather_kernel(const int* __restrict__ key3,
                        const int* __restrict__ p3,
                        const int* __restrict__ g3,
                        const int* __restrict__ eop3, const int* sel,
                        const int* delta, const int* bad, int skip_if_bad,
                        Shape sh, unsigned n_units, unsigned rec_stride,
                        unsigned eop_stride, int vec_rec, int vec_eop,
                        int* __restrict__ key, int* __restrict__ p,
                        int* __restrict__ g, int* __restrict__ eop) {
    const unsigned lane = threadIdx.x;
    // the first unit's offsets need nothing of the chain's
    const Unit u0 = unit_of(blockIdx.x, sh);
    // sel, delta and bad are the chain's: wait for it to complete and its
    // writes to be visible (behind a kernel that does not release its
    // dependents early, the block starts after it and this returns at
    // once); then load the three in one round
    grid_dependency_sync();
    const int b = skip_if_bad ? __ldcg(bad) : 0;
    const unsigned s0 = static_cast<unsigned>(__ldcg(sel + u0.dc));
    const int dl0 = __ldcg(delta + u0.dc);
    if (b != 0) return;
    copy_unit(u0, s0, dl0, lane, sh, rec_stride, eop_stride, vec_rec,
              vec_eop, key3, p3, g3, eop3, key, p, g, eop);
    for (unsigned i = blockIdx.x + gridDim.x; i < n_units; i += gridDim.x) {
        const Unit u = unit_of(i, sh);
        copy_unit(u, static_cast<unsigned>(__ldcg(sel + u.dc)),
                  __ldcg(delta + u.dc), lane, sh, rec_stride, eop_stride,
                  vec_rec, vec_eop, key3, p3, g3, eop3, key, p, g, eop);
    }
}

}  // namespace

// start int32 [NROW, D*C]; fin int32 [NROW, 3*D*C]; rowinfo int32 [NROW]
// (layouts above); G channels per block and smem bytes of shared memory
// per block, from ops/timeshard.py chain_plan; ratio: the OOK high/low
// ratio; low..gen: the rows of those registers. Writes sel, delta int32
// [D, C]; out int32 [NROW, C]; by_key int32 [D-1] and bad int32 [1]: with
// one block they are written, with more the caller zeroes them and the
// blocks OR into them. Returns cudaGetLastError() after the launch.
extern "C" int rtl433_timeshard_chain(const void* start, const void* fin,
                                      const void* rowinfo, int NROW, int D,
                                      int C, int G, int smem, int ratio,
                                      int low, int high, int ook_state,
                                      int min_high, int gen, void* sel,
                                      void* delta, void* out, void* by_key,
                                      void* bad, void* stream) {
    const size_t need = 4 * static_cast<size_t>(NROW) +
                        static_cast<size_t>(D) * G * (7 * 4 + 4);
    if (D < 1 || C < 1 || NROW < 1 || G < 1 || G > 32 ||
        static_cast<size_t>(smem) < need)
        return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            timeshard_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const Rows rw{low, high, ook_state, min_high, gen};
    const int blocks = (C + G - 1) / G;
    timeshard_chain_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(start), static_cast<const int*>(fin),
        static_cast<const int*>(rowinfo), NROW, D, C, G, ratio, rw,
        static_cast<int*>(sel), static_cast<int*>(delta), static_cast<int*>(out),
        static_cast<int*>(by_key), static_cast<int*>(bad));
    return static_cast<int>(cudaGetLastError());
}

// key3/p3/g3 int32 [3*D*C*R, G]; eop3 int32 [3*D*C, GE, 9] (GE = G*E);
// sel, delta int32 [D, C] and bad int32 [1] from the chain. Writes key/p/g
// int32 [C*R, D*G] and eop int32 [C, D*GE, 9], unless skip_if_bad is set
// and so is bad: then nothing. With pdl set, launched with programmatic
// stream serialization, so that it may start while the kernel before it
// (the chain) runs; with pdl 0 as a plain launch, which starts after the
// kernel before it has ended (to time the kernel alone). A launch the card
// refuses returns its error. The offsets
// are 32-bit: every tensor must hold fewer than 2^31 ints. Returns
// cudaGetLastError() after the launch.
extern "C" int rtl433_timeshard_gather(const void* key3, const void* p3,
                                       const void* g3, const void* eop3,
                                       const void* sel, const void* delta,
                                       const void* bad, int skip_if_bad,
                                       int pdl, int D, int C, int R, int G,
                                       int GE, void* key, void* p, void* g,
                                       void* eop, void* stream) {
    if (D < 1 || C < 1 || R < 1 || G < 1 || GE < 1 ||
        (skip_if_bad && bad == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t rec = 3ull * D * C * R * G, eops = 3ull * D * C * GE * 9;
    if (rec >= (1ull << 31) || eops >= (1ull << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    auto a16 = [](const void* q) {
        return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
    };
    const int vec_rec = G % 4 == 0 && a16(key3) && a16(p3) && a16(g3) &&
                        a16(key) && a16(p) && a16(g);
    const int vec_eop = GE % 4 == 0 && a16(eop3) && a16(eop);
    Shape sh;
    sh.D = D;
    sh.C = C;
    sh.R = R;
    sh.G = G;
    sh.GE = GE;
    sh.n_rec = static_cast<unsigned>(C * R * D);
    sh.eitems = vec_eop ? GE / 4 : GE;
    sh.echunks = (sh.eitems + 31) / 32;
    sh.item_ints = vec_eop ? 4 * META_FIELDS : META_FIELDS;
    const unsigned n_units = sh.n_rec + static_cast<unsigned>(C * D) *
                                            sh.echunks;
    // a warp a CTA, grid-stride beyond 32 CTAs an SM
    const unsigned blocks = n_units < 132 * 32 ? n_units : 132 * 32;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, timeshard_gather_kernel, static_cast<const int*>(key3),
        static_cast<const int*>(p3), static_cast<const int*>(g3),
        static_cast<const int*>(eop3), static_cast<const int*>(sel),
        static_cast<const int*>(delta), static_cast<const int*>(bad),
        skip_if_bad, sh, n_units, static_cast<unsigned>(D * C * R * G),
        static_cast<unsigned>(D * C * GE * META_FIELDS), vec_rec, vec_eop,
        static_cast<int*>(key), static_cast<int*>(p), static_cast<int*>(g),
        static_cast<int*>(eop));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
