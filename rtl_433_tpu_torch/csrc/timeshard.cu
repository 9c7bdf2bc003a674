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
// timeshard_gather_kernel, one thread per output element, gathers each segment's
// selected candidate's logs into the block's [C*R, D*G] record planes and
// [C, D*G*E, 9] EOP log, adding delta << KEY_IDX_BITS to valid keys and
// delta to the M_GEN field of valid EOPs. All arithmetic wraps as JAX's
// int32 does (unsigned in C).
//
// What bounds them. The chain's bytes (NROW ints per lane, 10.7 KB at
// C=1, D=32) would take nanoseconds; a one-block launch takes
// microseconds, so its floor is the launch and the latency of a few
// dependent rounds of loads, not bytes. The design keeps those rounds few:
// every register load of all links is issued in phase 1 at once (no load
// waits on a selection), the walk touches only shared memory, and phase 3
// is one more round. The gather moves every log int once each way: bytes,
// coalesced on both sides (consecutive threads take consecutive chunk
// columns of one row).

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

__global__ void __launch_bounds__(kThreads)
timeshard_gather_kernel(const int* __restrict__ key3,
                        const int* __restrict__ p3,
                        const int* __restrict__ g3,
                        const int* __restrict__ eop3,
                        const int* __restrict__ sel,
                        const int* __restrict__ delta, int D, int C, int R,
                        int G, int EM, int* __restrict__ key,
                        int* __restrict__ p, int* __restrict__ g,
                        int* __restrict__ eop) {
    const size_t DG = static_cast<size_t>(D) * G;
    const size_t n1 = static_cast<size_t>(C) * R * DG;
    const size_t n2 = static_cast<size_t>(C) * DG * EM;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n1 + n2; i += stride) {
        if (i < n1) {
            const size_t row = i / DG, col = i - row * DG;   // row = c*R + r
            const int d = static_cast<int>(col / G);
            const int gg = static_cast<int>(col - static_cast<size_t>(d) * G);
            const int c = static_cast<int>(row / R), r = static_cast<int>(row % R);
            const int dc = d * C + c;
            const size_t lane = (static_cast<size_t>(sel[dc]) * D + d) * C + c;
            const size_t src = (lane * R + r) * G + gg;
            int k = key3[src];
            if (k < KEY_INVALID)
                k = static_cast<int>(static_cast<unsigned>(k) +
                                     (static_cast<unsigned>(delta[dc]) << KEY_IDX_BITS));
            key[i] = k;
            p[i] = p3[src];
            g[i] = g3[src];
        } else {
            const size_t j = i - n1;
            const size_t per_c = DG * EM;
            const int c = static_cast<int>(j / per_c);
            const size_t rem = j - static_cast<size_t>(c) * per_c;
            const int d = static_cast<int>(rem / (static_cast<size_t>(G) * EM));
            const size_t q = rem - static_cast<size_t>(d) * G * EM;
            const int m = static_cast<int>(q % META_FIELDS);
            const int dc = d * C + c;
            const size_t src =
                ((static_cast<size_t>(sel[dc]) * D + d) * C + c) * G * EM + q;
            int v = eop3[src];
            if (m == M_GEN && eop3[src - M_GEN + M_TYPE] != PKG_NONE)
                v = wadd(v, delta[dc]);
            eop[j] = v;
        }
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

// key3/p3/g3 int32 [3*D*C*R, G]; eop3 int32 [3*D*C, G*E, 9] (EM = E*9);
// sel, delta int32 [D, C]. Writes key/p/g int32 [C*R, D*G] and eop int32
// [C, D*G*E, 9]. Returns cudaGetLastError() after the launch.
extern "C" int rtl433_timeshard_gather(const void* key3, const void* p3,
                                       const void* g3, const void* eop3,
                                       const void* sel, const void* delta,
                                       int D, int C, int R, int G, int EM,
                                       void* key, void* p, void* g, void* eop,
                                       void* stream) {
    if (D < 1 || C < 1 || R < 1 || G < 1 || EM < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t n = static_cast<size_t>(C) * D * G * (R + EM);
    size_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    timeshard_gather_kernel<<<static_cast<int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(key3), static_cast<const int*>(p3),
        static_cast<const int*>(g3), static_cast<const int*>(eop3),
        static_cast<const int*>(sel), static_cast<const int*>(delta), D, C, R,
        G, EM, static_cast<int*>(key), static_cast<int*>(p), static_cast<int*>(g),
        static_cast<int*>(eop));
    return static_cast<int>(cudaGetLastError());
}
