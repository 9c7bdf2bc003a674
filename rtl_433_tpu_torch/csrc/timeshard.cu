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
// timeshard_chain_kernel, one thread per channel, walks the links d = 1..D-1 as
// JAX's chain (:195-223) does: the predecessor's selected final against
// segment d's start, the hedge selection sel = clip(dlow + 1, 0, 2), the
// generation offset delta = t_gen - start_gen and the running t_gen. It
// writes sel and delta [D, C], the outgoing registers [NROW, C] (the last
// segment's selected final; counters seed + sum over d of final - start),
// one bit mask of failed keys per link [D-1] and a flag, both OR-reduced
// over the channels (a warp reduction, then one atomicOr per warp).
//
// timeshard_gather_kernel, one thread per output element, gathers each segment's
// selected candidate's logs into the block's [C*R, D*G] record planes and
// [C, D*G*E, 9] EOP log, adding delta << KEY_IDX_BITS to valid keys and
// delta to the M_GEN field of valid EOPs. All arithmetic wraps as JAX's
// int32 does (unsigned in C).
//
// What bounds them. The chain reads 2 * NROW ints per channel per link and
// is a few dependent compares, at C=1 one thread's latency (microseconds).
// The gather moves every log int once each way: bytes, coalesced on both
// sides (consecutive threads take consecutive chunk columns of one row).

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

__global__ void __launch_bounds__(kThreads)
timeshard_chain_kernel(const int* __restrict__ start,
                       const int* __restrict__ fin,
                       const int* __restrict__ rowinfo, int NROW, int D,
                       int C, int ratio, Rows rw, int* __restrict__ sel_out,
                       int* __restrict__ delta_out, int* __restrict__ out,
                       int* __restrict__ by_key, int* __restrict__ bad) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool act = c < C;
    const size_t L = static_cast<size_t>(D) * C;      // lanes of start
    const size_t L3 = 3 * L;                           // lanes of fin
    auto S = [&](int row, size_t lane) { return start[row * L + lane]; };
    auto F = [&](int row, size_t lane) { return fin[row * L3 + lane]; };

    size_t prev = L + c;                 // candidate 1 of segment 0
    int tgen = 0;
    if (act) {
        const int gen0 = S(rw.gen, c);
        tgen = wadd(gen0, wsub(F(rw.gen, prev), S(rw.gen, c)));
        sel_out[c] = 1;
        delta_out[c] = 0;
    }
    unsigned any_bad = 0u;
    for (int d = 1; d < D; ++d) {
        unsigned bk = 0u;
        if (act) {
            const size_t st = static_cast<size_t>(d) * C + c;
            const int st_low = S(rw.low, st);
            const int dlow = wsub(F(rw.low, prev), st_low);
            const int s = min(max(wadd(dlow, 1), 0), 2);
            const bool open = F(rw.ook_state, prev) != ST_IDLE;
            int cand_high = S(rw.high, st);
            if (S(rw.ook_state, st) == ST_IDLE) {
                const int h = static_cast<int>(static_cast<unsigned>(ratio) *
                                               static_cast<unsigned>(wadd(st_low, dlow)));
                cand_high = max(h, S(rw.min_high, st));
            }
            if (wabs(dlow) > 1) bk |= 1u;
            if (F(rw.high, prev) != cand_high) bk |= 2u;
            for (int row = 0; row < NROW; ++row) {
                const int info = rowinfo[row];
                const int k = (info & 0xff) - 1;
                if (k < 2) continue;
                if ((info & kOpen) && !open) continue;
                if (F(row, prev) != S(row, st)) bk |= 1u << k;
            }
            const int st_gen = S(rw.gen, st);
            delta_out[st] = wsub(tgen, st_gen);
            sel_out[st] = s;
            prev = static_cast<size_t>(s) * L + st;
            tgen = wadd(tgen, wsub(F(rw.gen, prev), st_gen));
        }
        const unsigned wk = __reduce_or_sync(0xffffffffu, bk);
        if ((threadIdx.x & 31) == 0 && wk) atomicOr(&by_key[d - 1], static_cast<int>(wk));
        any_bad |= wk;
    }
    if ((threadIdx.x & 31) == 0 && any_bad) atomicOr(bad, 1);
    if (!act) return;
    for (int row = 0; row < NROW; ++row) {
        int v = F(row, prev);
        if (rowinfo[row] & kCounter) {
            v = S(row, c);                                  // the seed
            for (int d = 0; d < D; ++d) {
                const size_t st = static_cast<size_t>(d) * C + c;
                const size_t sl = static_cast<size_t>(sel_out[st]) * L + st;
                v = wadd(v, wsub(F(row, sl), S(row, st)));
            }
        }
        out[static_cast<size_t>(row) * C + c] = v;
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
// (layouts above); ratio: the OOK high/low ratio; low..gen: the rows of
// those registers. Writes sel, delta int32 [D, C]; out int32 [NROW, C];
// by_key int32 [D-1] and bad int32 [1], both zeroed by the caller and
// OR-ed into. Returns cudaGetLastError() after the launch.
extern "C" int rtl433_timeshard_chain(const void* start, const void* fin,
                                      const void* rowinfo, int NROW, int D,
                                      int C, int ratio, int low, int high,
                                      int ook_state, int min_high, int gen,
                                      void* sel, void* delta, void* out,
                                      void* by_key, void* bad, void* stream) {
    if (D < 1 || C < 1 || NROW < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Rows rw{low, high, ook_state, min_high, gen};
    const int blocks = (C + kThreads - 1) / kThreads;
    timeshard_chain_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(start), static_cast<const int*>(fin),
        static_cast<const int*>(rowinfo), NROW, D, C, ratio, rw,
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
