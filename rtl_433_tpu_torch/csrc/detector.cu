// Per-sample pulse-detector scan: one block per group of up to 32
// channels, one FSM warp (lane i owns channel i of the group) and three
// helper warps.
//
// Replaces: the XLA scan of rtl_433_tpu/dsp/engine.py::_block_scan
// (fsm_scan with _step, _fsk_classic and _fsk_minmax, quiet_chunk, plus
// emit_ring). No Pallas kernel existed for it; on the GPU a loop of
// framework ops over a 131072-sample block would cost one launch per op per
// sample.
//
// Output: the record logs in exactly the layout and key encoding of the
// JAX engine's _block_scan (_ring_keys):
//   log_key/log_p/log_g [C*R, G]: row c*R + slot, column = chunk;
//   eop_log [C, G*E, 9]: row g*E + slot.
// Slots past a chunk's write count get KEY_INVALID and keep the ring's
// stale pulse/gap values, as the JAX ring does. Samples at or past n_valid
// (block frame, t = t0 + local index) change nothing; the EOP-sample
// reprocessing quirk is in fsm_step. quiet [C] counts the chunks at whose
// start the channel's own quiet_chunk_ok held (a diagnostic; the plain
// version counts the same; the warp skips a chunk when all its lanes hold).
// A per-channel origin vector lane_t0 (non-null) gives channel c its own
// t0 = lane_t0[c]: the time-shard segments and hedge candidates of
// parallel/timeshard.py run as the channels of one launch, each over its
// own region of the block (the JAX engine's per-device t0, _block_scan
// :969-971); a null lane_t0 takes the LANES=false instantiation, the scalar
// path's code unchanged.
//
// What bounds it. Each channel is one serial chain of N FSM steps with
// branchy state, so at C=1 the time is the chain's latency: a full
// fsm_step is some tens of dependent operations and branches, while the
// recurrences most samples really need (the low_est EWMA in IDLE, the
// high_est EWMA in a pulse, the plen count in a gap) are a few operations
// each. At C=4096 (128 blocks, one per SM) it is the same chains in 32
// lanes at once, and lanes in different FSM states take their paths one
// after the other. The bytes (am/fm in, the logs out) are far below the
// card's rate either way.
//
// Design.
//   - The FSM warp reads am/fm from shared memory only, the next sample
//     loaded one step ahead. Helper warps stage S chunks of all lanes' am
//     and fm per stage with cp.async (16-byte pieces when rows are aligned,
//     plain loads otherwise), triple-buffered: stage j+2 is in flight while
//     the FSM warp walks stage j and the helpers reduce stage j+1.
//     Completion is published by cp.async.wait_all, a helpers-only named
//     barrier, and the block barrier that ends each stage. Named barriers
//     and not mbarriers: the FSM warp crosses one barrier per S chunks (a
//     few thousand serial steps), so a barrier costs nothing next to the
//     chain and the schedule stays one easy-to-check loop.
//   - Quiet chunks. The helpers compute each chunk's per-lane am max/min;
//     at every chunk start the FSM warp evaluates quiet_chunk_ok per lane
//     (the JAX engine's conservative proof that the chunk stays IDLE and
//     below threshold) and, when every lane of the warp passes (the JAX
//     engine's jnp.all over channels, warp-uniform here so lanes never
//     diverge), runs only the low_est EWMA over the chunk. A chunk not
//     wholly below n_valid takes the full path.
//   - The full path is fsm_step unchanged, except that stretches on which
//     it would take one plain branch and emit nothing (IDLE EWMA, GAP and
//     GAP_START counts, PULSE level tracking, with the classic FSK tracker's
//     steady-tone EWMA inside a package's first pulse) go through
//     the runs of detector_step.cuh: the same updates in batches of eight
//     samples with one exit test per batch, so the chain is the
//     recurrence itself and not a branch per sample. Records and EOPs go
//     to per-chunk slots in shared memory (no local-memory ring); the
//     helpers write the logs from there one stage later, rebuilding the
//     stale pulse/gap slots from their own last-written copy, so the FSM
//     warp never stores to global memory inside the loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "detector_step.cuh"

namespace {

using namespace rtl433;

constexpr int kHelperWarps = 3;
constexpr int kNH = 32 * kHelperWarps;          // helper threads
constexpr int kThreads = 32 + kNH;
constexpr int kLanes = 32;
constexpr int kMaxStage = 16;                   // chunks per stage
constexpr int kSmemPlan = 200 * 1024;           // shared-memory budget of plan()
constexpr int kSlack = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
    int lanes;    // channels per block
    int S;        // chunks per stage
    int Lm;       // layout width, min(lanes, C)
};

// Per chunk and layout lane: 3 staged am+fm copies, 2 output buffers
// (counts, R records of 3 ints, E EOPs of 9), 2 max/min buffers; fixed:
// the helpers' stale pulse/gap copy.
inline bool plan(int chunk, int fe, int R, int E, int C, int G, Plan* p) {
    for (int lanes = kLanes; lanes >= 1; lanes >>= 1) {
        const long Lm = C < lanes ? C : lanes;
        const long per = Lm * (3L * chunk * (2 + fe) + 2L * 4 * (2 + 3 * R + 9 * E) +
                               2L * 4 * 2);
        const long fixed = Lm * 2L * R * 4 + kSlack;
        const long S = (kSmemPlan - fixed) / per;
        if (S >= 1) {
            p->lanes = lanes;
            p->Lm = static_cast<int>(Lm);
            long st = S < kMaxStage ? S : kMaxStage;
            st = st < G ? st : G;
            p->S = static_cast<int>(st < 1 ? 1 : st);
            return true;
        }
    }
    return false;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void helper_bar() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kNH) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Helper thread h copies `rows` time rows of Lc channels (source row stride
// C elements) into dst rows of Lm elements.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int Lc, int Lm,
                           int C, int h) {
    constexpr int kPer = 16 / sizeof(T);
    if (Lc == C) {                       // one group: both sides contiguous
        const int n = rows * C;
        if (aligned16(src) && aligned16(dst) && n % kPer == 0) {
            for (int q = h; q < n / kPer; q += kNH)
                cp_async16(dst + q * kPer, src + (size_t)q * kPer);
        } else {
            for (int q = h; q < n; q += kNH) dst[q] = src[q];
        }
    } else if (Lc == Lm && Lm % kPer == 0 && C % kPer == 0 && aligned16(src) &&
               aligned16(dst)) {
        const int per = Lm / kPer;
        for (int q = h; q < rows * per; q += kNH) {
            const int r = q / per, k = q - r * per;
            cp_async16(dst + r * Lm + k * kPer, src + (size_t)r * C + k * kPer);
        }
    } else {
        for (int q = h; q < rows * Lc; q += kNH) {
            const int r = q / Lc, l = q - r * Lc;
            dst[r * Lm + l] = src[(size_t)r * C + l];
        }
    }
}

template <bool MINMAX, bool LANES, typename FmT>
__global__ void __launch_bounds__(kThreads, 1)
detector_kernel(const int16_t* __restrict__ am, const FmT* __restrict__ fm,
                int N, int C, int* __restrict__ regs,
                const int* __restrict__ gen0, int* __restrict__ log_key,
                int* __restrict__ log_p, int* __restrict__ log_g,
                int* __restrict__ eop_log, int* __restrict__ quiet,
                int n_valid, int t0, const int* __restrict__ lane_t0,
                int chunk, int R, int E, Plan pl, Params prm) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = pl.S, Lm = pl.Lm;
    const int cbase = blockIdx.x * pl.lanes;
    const int Lc = min(pl.lanes, C - cbase);
    const int G = N / chunk;
    const int ntiles = (G + S - 1) / S;

    // shared layout; every buffer starts 16-byte aligned
    const int rows = S * chunk;
    const int fm_stride = (rows * Lm + 7) / 8 * 8;            // elements
    const int am_stride = fm_stride;
    FmT* in_fm = reinterpret_cast<FmT*>(smem);
    int16_t* in_am = reinterpret_cast<int16_t*>(in_fm + 3 * fm_stride);
    int* ip = reinterpret_cast<int*>(in_am + 3 * am_stride);
    const int SL = S * Lm;
    int* mx = ip;            ip += 2 * SL;     // [2][S][Lm]
    int* mn = ip;            ip += 2 * SL;
    int* wcnt = ip;          ip += 2 * SL;
    int* ecnt = ip;          ip += 2 * SL;
    int* rkey = ip;          ip += 2 * SL * R; // [2][S][R][Lm]
    int* rp = ip;            ip += 2 * SL * R;
    int* rg = ip;            ip += 2 * SL * R;
    int* eop = ip;           ip += 2 * SL * E * META_FIELDS;  // [2][S][E][9][Lm]
    int* last_p = ip;        ip += R * Lm;     // [R][Lm], helper-owned
    int* last_g = ip;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int16_t* am_g = am + cbase;
    const FmT* fm_g = fm + cbase;

    auto stage = [&](int j) {          // helpers: stage j into buffer j % 3
        const int gb = j * S, Sj = min(S, G - gb);
        const size_t row0 = (size_t)gb * chunk;
        stage_rows(in_am + (j % 3) * am_stride, am_g + row0 * C, Sj * chunk,
                   Lc, Lm, C, tid - 32);
        stage_rows(in_fm + (j % 3) * fm_stride, fm_g + row0 * C, Sj * chunk,
                   Lc, Lm, C, tid - 32);
        cp_async_commit();
    };
    auto minmax = [&](int j) {         // helpers: per-chunk am max/min of stage j
        const int gb = j * S, Sj = min(S, G - gb);
        const int16_t* A = in_am + (j % 3) * am_stride;
        int* bx = mx + (j & 1) * SL;
        int* bn = mn + (j & 1) * SL;
        for (int q = tid - 32; q < Sj * Lc; q += kNH) {
            const int s = q / Lc, l = q - s * Lc;
            const int16_t* a = A + s * chunk * Lm + l;
            int hi = -32768, lo = 32767;
            for (int k = 0; k < chunk; ++k) {
                const int v = a[k * Lm];
                hi = max(hi, v);
                lo = min(lo, v);
            }
            bx[s * Lm + l] = hi;
            bn[s * Lm + l] = lo;
        }
    };
    auto writeout = [&](int j) {       // helpers: logs of stage j
        const int gb = j * S, Sj = min(S, G - gb);
        const int b = j & 1;
        const int* wc = wcnt + b * SL;
        const int* ec = ecnt + b * SL;
        for (int q = tid - 32; q < R * Lc; q += kNH) {
            const int i = q / Lc, l = q - i * Lc;
            int lp = last_p[i * Lm + l], lg = last_g[i * Lm + l];
            const size_t o = ((size_t)(cbase + l) * R + i) * G + gb;
            for (int s = 0; s < Sj; ++s) {
                int key = KEY_INVALID;
                if (i < min(wc[s * Lm + l], R)) {
                    const int r = ((b * S + s) * R + i) * Lm + l;
                    key = rkey[r];
                    lp = rp[r];
                    lg = rg[r];
                }
                log_key[o + s] = key;
                log_p[o + s] = lp;
                log_g[o + s] = lg;
            }
            last_p[i * Lm + l] = lp;
            last_g[i * Lm + l] = lg;
        }
        const int EM = E * META_FIELDS;
        for (int l = 0; l < Lc; ++l) {
            int* dst = eop_log + ((size_t)(cbase + l) * G + gb) * EM;
            for (int q = tid - 32; q < Sj * EM; q += kNH) {
                const int s = q / EM, rem = q - s * EM;
                const int slot = rem / META_FIELDS;
                int v = 0;
                if (slot < min(ec[s * Lm + l], E))
                    v = eop[((b * S + s) * EM + rem) * Lm + l];
                dst[q] = v;
            }
        }
    };

    // FSM warp: lane -> channel registers and region
    const bool act = warp == 0 && lane < Lc;
    const int c = cbase + lane;
    const int t0l = LANES && act ? lane_t0[c] : t0;
    const int n_act = min(max(n_valid - t0l, 0), N);
    Regs r;
    int g0 = 0, nq = 0;
    if (act) {
        r.ook_state = regs[R_OOK_STATE * C + c];
        r.plen = regs[R_PLEN * C + c];
        r.max_pulse = regs[R_MAX_PULSE * C + c];
        r.lead_in = regs[R_LEAD_IN * C + c];
        r.low_est = regs[R_LOW_EST * C + c];
        r.high_est = regs[R_HIGH_EST * C + c];
        r.min_high = regs[R_MIN_HIGH * C + c];
        r.num = regs[R_NUM * C + c];
        r.cur_pulse = regs[R_CUR_PULSE * C + c];
        r.ook_f1 = regs[R_OOK_F1 * C + c];
        r.pkg_start = regs[R_PKG_START * C + c];
        r.eop_spur = regs[R_EOP_SPUR * C + c];
        r.gen = regs[R_GEN * C + c];
        r.fsk_state = regs[R_FSK_STATE * C + c];
        r.flen = regs[R_FLEN * C + c];
        r.f1 = regs[R_F1 * C + c];
        r.f2 = regs[R_F2 * C + c];
        r.vmax = regs[R_VMAX * C + c];
        r.vmin = regs[R_VMIN * C + c];
        r.skip = regs[R_SKIP * C + c];
        r.fsk_num = regs[R_FSK_NUM * C + c];
        r.fsk_cur_pulse = regs[R_FSK_CUR_PULSE * C + c];
        r.n_ring_ovf = regs[R_N_RING_OVF * C + c];
        r.n_pkg_drop = regs[R_N_PKG_DROP * C + c];
        r.n_fsk_ovf = regs[R_N_FSK_OVF * C + c];
#pragma unroll
        for (int i = 0; i < HIST; ++i) {
            r.hp[i] = regs[(R_HIST_P0 + i) * C + c];
            r.hg[i] = regs[(R_HIST_G0 + i) * C + c];
        }
        g0 = gen0[c];
    }

    if (warp > 0) {                    // prologue: stages 0 and 1 in flight
        for (int q = tid - 32; q < R * Lm; q += kNH) { last_p[q] = 0; last_g[q] = 0; }
        stage(0);
        if (ntiles > 1) stage(1);
        if (ntiles > 1) {
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            cp_async_wait_all();
        }
        helper_bar();
        minmax(0);
    }
    __syncthreads();

    for (int j = 0; j < ntiles; ++j) {
        if (warp == 0) {
            const int gb = j * S, Sj = min(S, G - gb);
            const int16_t* A = in_am + (j % 3) * am_stride;
            const FmT* F = in_fm + (j % 3) * fm_stride;
            const int b = j & 1;
            for (int s = 0; s < Sj; ++s) {
                const int g = gb + s;
                const int lo = g * chunk, hi = min(lo + chunk, n_act);
                bool ok = true;
                if (act)
                    ok = quiet_chunk_ok(r, prm, mx[b * SL + s * Lm + lane],
                                        mn[b * SL + s * Lm + lane],
                                        hi - lo == chunk);
                nq += act && ok;
                int wpos = 0, epos = 0;
                const int16_t* As = A + s * chunk * Lm + lane;
                if (__all_sync(kFull, ok)) {
                    if (act) {
                        int low = r.low_est;
#pragma unroll 8
                        for (int k = 0; k < chunk; ++k) low = idle_low(low, As[k * Lm]);
                        quiet_chunk_finish(r, prm, low, chunk);
                    }
                } else if (act && hi > lo) {
                    const FmT* Fs = F + s * chunk * Lm + lane;
                    const int n = hi - lo;
                    Emit e;
                    int k = 0;
                    while (k < n) {
                        // a stretch of one plain branch, then full steps
                        // (next sample loaded one ahead) until one applies
                        if (r.ook_state == ST_IDLE)
                            k = idle_run(r, prm, As, Lm, k, n);
                        else if (r.ook_state == ST_GAP && r.eop_spur == 0)
                            k = gap_run(r, prm, As, Lm, k, n);
                        else if (r.ook_state == ST_GAP_START && r.num > 0)
                            k = gap_start_run(r, prm, As, Lm, k, n);
                        else if (r.ook_state == ST_PULSE && r.num > 0)
                            k = pulse_run(r, prm, As, Fs, Lm, k, n);
                        else if (run_applies<MINMAX>(r))   // classic FSK, FH/FL
                            k = fsk_run(r, prm, As, Fs, Lm, k, n);
                        if (k >= n) break;
                        int an = As[k * Lm], fn = static_cast<int>(Fs[k * Lm]);
                        do {
                            const int a = an, f = fn;
                            const int kn = k + 1 < n ? k + 1 : k;
                            an = As[kn * Lm];
                            fn = static_cast<int>(Fs[kn * Lm]);
                            fsm_step<MINMAX>(r, prm, a, f, t0l + lo + k, e);
                            if (e.rec) {
                                if (wpos >= R) {
                                    r.n_ring_ovf += 1;
                                } else {
                                    const unsigned kk =
                                        static_cast<unsigned>((e.tag >> 1) & 1) * KEY_FSK_SHIFT +
                                        static_cast<unsigned>((e.tag >> 2) - g0) * (1u << KEY_IDX_BITS) +
                                        static_cast<unsigned>(e.idx);
                                    const int o = ((b * S + s) * R + wpos) * Lm + lane;
                                    rkey[o] = static_cast<int>(kk);
                                    rp[o] = e.p;
                                    rg[o] = e.g;
                                }
                                ++wpos;
                            }
                            if (e.eop) {
                                if (epos >= E) {
                                    r.n_pkg_drop += 1;
                                } else {
                                    int* row = eop + ((b * S + s) * E + epos) * META_FIELDS * Lm + lane;
#pragma unroll
                                    for (int m = 0; m < META_FIELDS; ++m) row[m * Lm] = e.meta[m];
                                }
                                ++epos;
                            }
                            ++k;
                        } while (k < n && !run_applies<MINMAX>(r));
                    }
                }
                if (act) {
                    wcnt[b * SL + s * Lm + lane] = wpos;
                    ecnt[b * SL + s * Lm + lane] = epos;
                }
            }
        } else {
            cp_async_wait_all();       // stage j+1 has landed
            helper_bar();
            if (j + 1 < ntiles) minmax(j + 1);
            if (j + 2 < ntiles) stage(j + 2);
            if (j >= 1) writeout(j - 1);
        }
        __syncthreads();
    }

    if (warp > 0) {
        writeout(ntiles - 1);
    } else if (act) {
        regs[R_OOK_STATE * C + c] = r.ook_state;
        regs[R_PLEN * C + c] = r.plen;
        regs[R_MAX_PULSE * C + c] = r.max_pulse;
        regs[R_LEAD_IN * C + c] = r.lead_in;
        regs[R_LOW_EST * C + c] = r.low_est;
        regs[R_HIGH_EST * C + c] = r.high_est;
        regs[R_MIN_HIGH * C + c] = r.min_high;
        regs[R_NUM * C + c] = r.num;
        regs[R_CUR_PULSE * C + c] = r.cur_pulse;
        regs[R_OOK_F1 * C + c] = r.ook_f1;
        regs[R_PKG_START * C + c] = r.pkg_start;
        regs[R_EOP_SPUR * C + c] = r.eop_spur;
        regs[R_GEN * C + c] = r.gen;
        regs[R_FSK_STATE * C + c] = r.fsk_state;
        regs[R_FLEN * C + c] = r.flen;
        regs[R_F1 * C + c] = r.f1;
        regs[R_F2 * C + c] = r.f2;
        regs[R_VMAX * C + c] = r.vmax;
        regs[R_VMIN * C + c] = r.vmin;
        regs[R_SKIP * C + c] = r.skip;
        regs[R_FSK_NUM * C + c] = r.fsk_num;
        regs[R_FSK_CUR_PULSE * C + c] = r.fsk_cur_pulse;
        regs[R_N_RING_OVF * C + c] = r.n_ring_ovf;
        regs[R_N_PKG_DROP * C + c] = r.n_pkg_drop;
        regs[R_N_FSK_OVF * C + c] = r.n_fsk_ovf;
#pragma unroll
        for (int i = 0; i < HIST; ++i) {
            regs[(R_HIST_P0 + i) * C + c] = r.hp[i];
            regs[(R_HIST_G0 + i) * C + c] = r.hg[i];
        }
        quiet[c] = nq;
    }
}

template <bool MINMAX, typename FmT>
int launch(const void* am, const void* fm, int N, int C, void* regs,
           const void* gen0, void* log_key, void* log_p, void* log_g,
           void* eop_log, void* quiet, int n_valid, int t0,
           const int* lane_t0, int chunk, int R, int E, Params prm,
           cudaStream_t stream) {
    const int G = N / chunk;
    Plan pl;
    if (!plan(chunk, sizeof(FmT), R, E, C, G, &pl))
        return static_cast<int>(cudaErrorInvalidValue);
    const int rows = pl.S * chunk;
    const size_t stride = (size_t)(rows * pl.Lm + 7) / 8 * 8;
    const size_t smem = 3 * stride * (sizeof(FmT) + 2) +
                        4 * (size_t)pl.S * pl.Lm *
                            (2 * (4 + 3 * R + E * META_FIELDS)) +
                        4 * (size_t)2 * R * pl.Lm;
    auto kern = lane_t0 ? detector_kernel<MINMAX, true, FmT>
                        : detector_kernel<MINMAX, false, FmT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (C + pl.lanes - 1) / pl.lanes;
    kern<<<blocks, kThreads, smem, stream>>>(
        static_cast<const int16_t*>(am), static_cast<const FmT*>(fm), N, C,
        static_cast<int*>(regs), static_cast<const int*>(gen0),
        static_cast<int*>(log_key), static_cast<int*>(log_p),
        static_cast<int*>(log_g), static_cast<int*>(eop_log),
        static_cast<int*>(quiet), n_valid, t0, lane_t0, chunk, R, E, pl, prm);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// am: int16 [N, C]; fm: int16 [N, C] (int32 when fm_i32: FM off);
// regs: int32 [NREG, C], updated in place; gen0: int32 [C];
// log_key/log_p/log_g: int32 [C*R, G]; eop_log: int32 [C, G*E, 9];
// quiet: int32 [C], the chunks at whose start each channel's quiet test held;
// lane_t0: null (every channel at t0), or int32 [C], each channel's t0.
// Returns cudaGetLastError() after the launch (or an invalid-value code for
// a ring, EOP count or chunk the kernel cannot hold).
extern "C" int rtl433_detector_scan(const void* am, const void* fm, int fm_i32,
                                    int N, int C, void* regs, const void* gen0,
                                    void* log_key, void* log_p, void* log_g,
                                    void* eop_log, void* quiet, int n_valid,
                                    int t0, const void* lane_t0, int chunk,
                                    int R, int E, int spm, int fixed,
                                    int ratio, int maxp, int minmax,
                                    void* stream) {
    if (R < 1 || R > RING_MAX || E < 1 || E > EOPS_MAX || chunk < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Params prm{spm, fixed, ratio, maxp};
    const int* t0v = static_cast<const int*>(lane_t0);
    if (minmax && fm_i32)
        return launch<true, int32_t>(am, fm, N, C, regs, gen0, log_key, log_p,
                                     log_g, eop_log, quiet, n_valid, t0, t0v,
                                     chunk, R, E, prm, s);
    if (minmax)
        return launch<true, int16_t>(am, fm, N, C, regs, gen0, log_key, log_p,
                                     log_g, eop_log, quiet, n_valid, t0, t0v,
                                     chunk, R, E, prm, s);
    if (fm_i32)
        return launch<false, int32_t>(am, fm, N, C, regs, gen0, log_key, log_p,
                                      log_g, eop_log, quiet, n_valid, t0, t0v,
                                      chunk, R, E, prm, s);
    return launch<false, int16_t>(am, fm, N, C, regs, gen0, log_key, log_p,
                                  log_g, eop_log, quiet, n_valid, t0, t0v,
                                  chunk, R, E, prm, s);
}
