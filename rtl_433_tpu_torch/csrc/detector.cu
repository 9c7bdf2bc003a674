// Per-sample pulse-detector scan, one thread per channel.
//
// Replaces: the XLA scan of rtl_433_tpu/dsp/engine.py::_block_scan
// (fsm_scan with _step, _fsk_classic and _fsk_minmax, plus emit_ring). No
// Pallas kernel existed for it; on the GPU a loop of framework ops over a
// 131072-sample block would cost one launch per op per sample.
//
// Each thread keeps every FSM register of its channel in registers (OOK
// state, level estimators, FSK tracker, the 4-deep rewind history) and
// walks the N samples in order. Records committed within a 128-sample
// chunk go to a small ring in local memory; at each chunk end the ring and
// the chunk's EOP metadata are written into the log tensors in exactly the
// layout and key encoding of the JAX engine's _block_scan (_ring_keys):
//   log_key/log_p/log_g [C*R, G]: row c*R + slot, column = chunk;
//   eop_log [C, G*E, 9]: row g*E + slot.
// Slots past a chunk's write count get KEY_INVALID and keep the ring's
// stale pulse/gap values, as the JAX ring does. Samples at or past n_valid
// (block frame, t = t0 + local index) change nothing; the EOP-sample
// reprocessing quirk is in fsm_step.
//
// The JAX engine's all-idle quiet_chunk shortcut is not ported: it is
// bit-exact by proof and only skips vector work for whole idle chunks,
// which a one-thread-per-channel kernel has no need of.
//
// Bound on an H100: bytes moved are the am/fm streams (4 or 6 bytes per
// sample) plus the logs (3*R*4 + E*9*4 bytes per chunk and channel); at
// C=1 the time is set instead by the serial chain of N dependent FSM
// steps, which this kernel does nothing to shorten yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "detector_step.cuh"

namespace {

using namespace rtl433;

template <bool MINMAX, typename FmT>
__global__ void detector_kernel(const int16_t* __restrict__ am,
                                const FmT* __restrict__ fm, int N, int C,
                                int* __restrict__ regs,
                                const int* __restrict__ gen0,
                                int* __restrict__ log_key,
                                int* __restrict__ log_p,
                                int* __restrict__ log_g,
                                int* __restrict__ eop_log, int n_valid, int t0,
                                int chunk, int R, int E, Params prm) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    Regs r;
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
    const int g0 = gen0[c];
    const int G = N / chunk;
    int ring_idx[RING_MAX], ring_p[RING_MAX], ring_g[RING_MAX], ring_tag[RING_MAX];
    for (int i = 0; i < R; ++i) { ring_idx[i] = 0; ring_p[i] = 0; ring_g[i] = 0; ring_tag[i] = 0; }
    int n_act = n_valid - t0;
    n_act = n_act < 0 ? 0 : (n_act > N ? N : n_act);
    int* eop_c = eop_log + (size_t)c * G * E * META_FIELDS;
    Emit e;
    for (int g = 0; g < G; ++g) {
        int wpos = 0, epos = 0;
        const int k_end = min(g * chunk + chunk, n_act);
        for (int k = g * chunk; k < k_end; ++k) {
            const int a = am[(size_t)k * C + c];
            const int f = static_cast<int>(fm[(size_t)k * C + c]);
            fsm_step<MINMAX>(r, prm, a, f, t0 + k, e);
            if (e.rec) {
                if (wpos >= R) {
                    r.n_ring_ovf += 1;
                } else {
                    ring_idx[wpos] = e.idx; ring_p[wpos] = e.p;
                    ring_g[wpos] = e.g; ring_tag[wpos] = e.tag;
                }
                ++wpos;
            }
            if (e.eop) {
                if (epos >= E) {
                    r.n_pkg_drop += 1;
                } else {
                    int* row = eop_c + (size_t)(g * E + epos) * META_FIELDS;
#pragma unroll
                    for (int m = 0; m < META_FIELDS; ++m) row[m] = e.meta[m];
                }
                ++epos;
            }
        }
        // emit this chunk's ring and clear its unused EOP slots
        for (int i = 0; i < R; ++i) {
            const size_t o = (size_t)(c * R + i) * G + g;
            int key = KEY_INVALID;
            if (i < wpos) {
                const int tag = ring_tag[i];
                const unsigned kk = static_cast<unsigned>((tag >> 1) & 1) * KEY_FSK_SHIFT +
                                    static_cast<unsigned>((tag >> 2) - g0) * (1u << KEY_IDX_BITS) +
                                    static_cast<unsigned>(ring_idx[i]);
                key = static_cast<int>(kk);
            }
            log_key[o] = key;
            log_p[o] = ring_p[i];
            log_g[o] = ring_g[i];
        }
        for (int s = min(epos, E); s < E; ++s) {
            int* row = eop_c + (size_t)(g * E + s) * META_FIELDS;
#pragma unroll
            for (int m = 0; m < META_FIELDS; ++m) row[m] = 0;
        }
    }
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
}

template <bool MINMAX, typename FmT>
void launch(const void* am, const void* fm, int N, int C, void* regs,
            const void* gen0, void* log_key, void* log_p, void* log_g,
            void* eop_log, int n_valid, int t0, int chunk, int R, int E,
            Params prm, cudaStream_t stream) {
    const int threads = 32;
    const int blocks = (C + threads - 1) / threads;
    detector_kernel<MINMAX, FmT><<<blocks, threads, 0, stream>>>(
        static_cast<const int16_t*>(am), static_cast<const FmT*>(fm), N, C,
        static_cast<int*>(regs), static_cast<const int*>(gen0),
        static_cast<int*>(log_key), static_cast<int*>(log_p),
        static_cast<int*>(log_g), static_cast<int*>(eop_log), n_valid, t0,
        chunk, R, E, prm);
}

}  // namespace

// am: int16 [N, C]; fm: int16 [N, C] (int32 when fm_i32: FM off);
// regs: int32 [NREG, C], updated in place; gen0: int32 [C];
// log_key/log_p/log_g: int32 [C*R, G]; eop_log: int32 [C, G*E, 9].
// Returns cudaGetLastError() after the launch (or an invalid-value code for
// a ring or EOP count the kernel cannot hold).
extern "C" int rtl433_detector_scan(const void* am, const void* fm, int fm_i32,
                                    int N, int C, void* regs, const void* gen0,
                                    void* log_key, void* log_p, void* log_g,
                                    void* eop_log, int n_valid, int t0,
                                    int chunk, int R, int E, int spm,
                                    int fixed, int ratio, int maxp,
                                    int minmax, void* stream) {
    if (R < 1 || R > RING_MAX || E < 1 || E > EOPS_MAX || chunk < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Params prm{spm, fixed, ratio, maxp};
    if (minmax && fm_i32)
        launch<true, int32_t>(am, fm, N, C, regs, gen0, log_key, log_p, log_g,
                              eop_log, n_valid, t0, chunk, R, E, prm, s);
    else if (minmax)
        launch<true, int16_t>(am, fm, N, C, regs, gen0, log_key, log_p, log_g,
                              eop_log, n_valid, t0, chunk, R, E, prm, s);
    else if (fm_i32)
        launch<false, int32_t>(am, fm, N, C, regs, gen0, log_key, log_p, log_g,
                               eop_log, n_valid, t0, chunk, R, E, prm, s);
    else
        launch<false, int16_t>(am, fm, N, C, regs, gen0, log_key, log_p, log_g,
                               eop_log, n_valid, t0, chunk, R, E, prm, s);
    return static_cast<int>(cudaGetLastError());
}
