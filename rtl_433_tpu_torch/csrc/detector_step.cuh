// One sample of the pulse detector for one channel: the 4-state OOK
// hysteresis machine (ref src/pulse_detect.c:199-483) and the classic or
// min/max FSK tracker (ref src/pulse_detect_fsk.c), with C integer
// semantics. Line for line the same order as the plain version,
// rtl_433_tpu_torch/ops/detector.py::_scan_channel.
#pragma once

#include <cstdint>

namespace rtl433 {

constexpr int OOK_MAX_HIGH_LEVEL = 16384;
constexpr int OOK_EST_HIGH_RATIO = 64;
constexpr int OOK_EST_LOW_RATIO = 1024;
constexpr int PD_MAX_PULSES = 1200;
constexpr int PD_MIN_PULSES = 16;
constexpr int PD_MIN_PULSE_SAMPLES = 10;
constexpr int PD_MIN_GAP_MS = 10;
constexpr int PD_MAX_GAP_MS = 100;
constexpr int PD_MAX_GAP_RATIO = 10;
constexpr int FSK_DEFAULT_FM_DELTA = 6000;
constexpr int FSK_EST_SLOW = 64;
constexpr int FSK_EST_FAST = 16;

constexpr int ST_IDLE = 0, ST_PULSE = 1, ST_GAP_START = 2, ST_GAP = 3;
constexpr int FSK_INIT = 0, FSK_FH = 1, FSK_FL = 2;
constexpr int PKG_OOK = 1, PKG_FSK = 2;
constexpr int META_FIELDS = 9;
constexpr int KEY_IDX_BITS = 12;
constexpr int KEY_FSK_SHIFT = 1 << 29;
constexpr int KEY_INVALID = 1 << 30;
constexpr int RING_MAX = 64;
constexpr int EOPS_MAX = 8;
constexpr int HIST = 4;

// Register rows of the packed [NREG, C] state, in the order of
// ops/detector.py::REG_KEYS (a CPU test checks that the two agree).
enum Reg {
    R_OOK_STATE, R_PLEN, R_MAX_PULSE, R_LEAD_IN, R_LOW_EST, R_HIGH_EST,
    R_MIN_HIGH, R_NUM, R_CUR_PULSE, R_OOK_F1, R_PKG_START, R_EOP_SPUR, R_GEN,
    R_FSK_STATE, R_FLEN, R_F1, R_F2, R_VMAX, R_VMIN, R_SKIP, R_FSK_NUM,
    R_FSK_CUR_PULSE, R_N_RING_OVF, R_N_PKG_DROP, R_N_FSK_OVF,
    R_HIST_P0, R_HIST_G0 = R_HIST_P0 + HIST, NREG = R_HIST_G0 + HIST
};

struct Regs {
    int ook_state, plen, max_pulse, lead_in, low_est, high_est, min_high;
    int num, cur_pulse, ook_f1, pkg_start, eop_spur, gen;
    int fsk_state, flen, f1, f2, vmax, vmin, skip, fsk_num, fsk_cur_pulse;
    int n_ring_ovf, n_pkg_drop, n_fsk_ovf;
    int hp[HIST], hg[HIST];
};

struct Params {
    int spm;          // samples per ms
    int fixed;        // fixed high level, 0 = adaptive
    int ratio;        // high/low ratio
    int maxp;         // max pulses per package
};

// What one step emits: at most one pulse/gap record and one EOP.
struct Emit {
    bool rec;
    int idx, p, g, tag;
    bool eop;
    int meta[META_FIELDS];
};

// C truncating division by a positive constant (the compiler's `/`).
__device__ __forceinline__ int tdiv(int a, int b) { return a / b; }

__device__ __forceinline__ void hist_push(Regs& r, int p, int g) {
#pragma unroll
    for (int i = HIST - 1; i > 0; --i) { r.hp[i] = r.hp[i - 1]; r.hg[i] = r.hg[i - 1]; }
    r.hp[0] = p; r.hg[0] = g;
}

__device__ __forceinline__ void hist_pop(Regs& r) {
#pragma unroll
    for (int i = 0; i < HIST - 1; ++i) { r.hp[i] = r.hp[i + 1]; r.hg[i] = r.hg[i + 1]; }
}

// Classic dual-EWMA tracker (ref src/pulse_detect_fsk.c:34-141); sets
// e.idx/p/g and returns true on a committed record.
__device__ __forceinline__ bool fsk_classic(Regs& r, int fm, Emit& e) {
    const int f1 = r.f1, f2 = r.f2;
    const int f1d = abs(fm - f1), f2d = abs(fm - f2);
    const int flen1 = r.flen + 1;
    bool rec = false;
    r.flen = flen1;
    if (r.fsk_state == FSK_INIT) {
        if (flen1 < PD_MIN_PULSE_SAMPLES) {
            r.f1 = tdiv(f1, 2) + tdiv(fm, 2);
        } else if (f1d > FSK_DEFAULT_FM_DELTA / 2) {
            if (fm > f1) {             // gap first
                r.fsk_state = FSK_FH; r.f2 = f1; r.f1 = fm;
                e.idx = 0; e.p = 0; e.g = flen1; rec = true;
                r.fsk_num = 1; r.flen = 0;
                hist_push(r, 0, flen1);
            } else {                   // pulse first
                r.fsk_state = FSK_FL; r.f2 = fm; r.fsk_cur_pulse = flen1; r.flen = 0;
            }
        } else {
            r.f1 = f1 + tdiv(fm, FSK_EST_FAST) - tdiv(f1, FSK_EST_FAST);
        }
    } else if (r.fsk_state == FSK_FH) {
        if (f1d > f2d) {
            r.fsk_state = FSK_FL;
            if (flen1 >= PD_MIN_PULSE_SAMPLES) {
                r.fsk_cur_pulse = flen1; r.flen = 0;
            } else {                   // rewind: restore the last pair
                r.flen = flen1 + r.hg[0];
                r.fsk_num -= 1;
                r.fsk_cur_pulse = r.hp[0];
                if (r.fsk_num == 0 && r.hp[0] == 0) { r.f1 = f2; r.fsk_state = FSK_INIT; }
                hist_pop(r);
            }
        } else if (fm > f1) {
            r.f1 = f1 + tdiv(fm, FSK_EST_FAST) - tdiv(f1, FSK_EST_FAST);
        } else {
            r.f1 = f1 + tdiv(fm, FSK_EST_SLOW) - tdiv(f1, FSK_EST_SLOW);
        }
    } else if (r.fsk_state == FSK_FL) {
        if (f2d > f1d) {
            r.fsk_state = FSK_FH;
            if (flen1 >= PD_MIN_PULSE_SAMPLES) {
                e.idx = r.fsk_num; e.p = r.fsk_cur_pulse; e.g = flen1; rec = true;
                hist_push(r, r.fsk_cur_pulse, flen1);
                r.fsk_num += 1; r.flen = 0;
                if (r.fsk_num >= PD_MAX_PULSES) { r.fsk_num = PD_MAX_PULSES - 1; r.n_fsk_ovf += 1; }
            } else {                   // rewind
                r.flen = flen1 + r.fsk_cur_pulse;
                if (r.fsk_num == 0) r.fsk_state = FSK_INIT;
            }
        } else if (fm < f2) {
            r.f2 = f2 + tdiv(fm, FSK_EST_FAST) - tdiv(f2, FSK_EST_FAST);
        } else {
            r.f2 = f2 + tdiv(fm, FSK_EST_SLOW) - tdiv(f2, FSK_EST_SLOW);
        }
    }
    return rec;
}

// Min/max tracker (ref src/pulse_detect_fsk.c:158-221).
__device__ __forceinline__ bool fsk_minmax(Regs& r, int fm, Emit& e) {
    if (r.skip > 0) { r.skip -= 1; return false; }
    if (fm > r.vmax) r.vmax = fm;
    if (fm < r.vmin) r.vmin = fm;
    const int mid = tdiv(r.vmax + r.vmin, 2);
    if (fm > mid) r.vmax -= 10;
    if (fm < mid) r.vmin += 10;
    r.flen += 1;
    bool rec = false;
    if (r.fsk_state == FSK_INIT) {
        r.fsk_state = fm > mid ? FSK_FH : FSK_FL;
    } else if (r.fsk_state == FSK_FH) {
        if (fm < mid) { r.fsk_state = FSK_FL; r.fsk_cur_pulse = r.flen; r.flen = 0; }
        r.f2 = r.f2 + tdiv(fm, FSK_EST_SLOW) - tdiv(r.f2, FSK_EST_SLOW);
    } else if (r.fsk_state == FSK_FL) {
        if (fm > mid) {
            r.fsk_state = FSK_FH;
            e.idx = r.fsk_num; e.p = r.fsk_cur_pulse; e.g = r.flen; rec = true;
            r.fsk_num += 1; r.flen = 0;
            if (r.fsk_num >= PD_MAX_PULSES) { r.fsk_num = PD_MAX_PULSES - 1; r.n_fsk_ovf += 1; }
        }
        r.f1 = r.f1 + tdiv(fm, FSK_EST_SLOW) - tdiv(r.f1, FSK_EST_SLOW);
    }
    return rec;
}

// The IDLE noise EWMA of low_est (ref src/pulse_detect.c:326-333).
__device__ __forceinline__ int idle_low(int low, int a) {
    const int d = a - low;
    return low + tdiv(d, OOK_EST_LOW_RATIO) + (d > 0 ? 1 : -1);
}

// Whether a chunk of `len` samples may skip the FSM: the channel is IDLE
// and no sample can cross a conservative lower bound of the hysteresis
// threshold, so every sample takes the IDLE EWMA branch and nothing else
// (the JAX engine's quiet_chunk test, rtl_433_tpu/dsp/engine.py:1110-1125,
// with high_est also bounding high_lb: never looser). low_est stays at or
// above min(low_est, am_min) - 1 over such a chunk, and idle high_est at
// or above min_high. Mirrors ops/detector.py::quiet_chunk_ok.
__device__ __forceinline__ bool quiet_chunk_ok(const Regs& r, const Params& prm,
                                               int am_max, int am_min,
                                               bool whole) {
    if (!whole || r.ook_state != ST_IDLE) return false;
    const int low_lb = min(r.low_est, am_min) - 2;
    const int high_lb = min(min(r.high_est, r.min_high), OOK_MAX_HIGH_LEVEL);
    const int thr_lb = prm.fixed ? prm.fixed - 1 : tdiv(low_lb + high_lb, 2) - 1;
    return thr_lb >= 0 && am_max <= thr_lb;
}

// What a quiet chunk does to the registers, given its final low_est.
__device__ __forceinline__ void quiet_chunk_finish(Regs& r, const Params& prm,
                                                   int low, int len) {
    r.low_est = low;
    r.high_est = max(prm.ratio * low, r.min_high);
    r.lead_in += min(max(OOK_EST_LOW_RATIO + 1 - r.lead_in, 0), len);
}

// One valid sample at block-frame position t. Fills e (records/EOPs are
// written to the ring by the caller) and updates r.
template <bool MINMAX>
__device__ __forceinline__ void fsm_step(Regs& r, const Params& prm, int a,
                                         int f, int t, Emit& e) {
    e.rec = false;
    e.eop = false;
    const int s = r.low_est + min(r.high_est, OOK_MAX_HIGH_LEVEL);
    const int thr = prm.fixed ? prm.fixed : tdiv(s, 2);
    const int hyst = tdiv(thr, 8);
    const bool above = a > thr + hyst;
    const int st = r.ook_state;
    bool idle_mask = false, start_mask = false;
    if (st == ST_IDLE) {
        if (above && r.lead_in > OOK_EST_LOW_RATIO) start_mask = true;
        else idle_mask = true;
    } else {
        const bool below = a < thr - hyst;
        bool fsk_publish = false, ook_eop = false, gate = false;
        int new_st = st, ook_final_num = 0;
        if (st == ST_PULSE) {                                 // ref :336-375
            const int p_len = r.plen + 1;
            if (below) {
                if (p_len < PD_MIN_PULSE_SAMPLES) {
                    r.plen = p_len;
                    if (r.num <= 1) {
                        new_st = ST_IDLE;
                    } else {
                        r.eop_spur = 1;
                        new_st = ST_GAP;
                    }
                } else {
                    r.cur_pulse = p_len;
                    r.max_pulse = max(p_len, r.max_pulse);
                    r.plen = 0;
                    new_st = ST_GAP_START;
                }
            } else {
                const int h = r.high_est + tdiv(a, OOK_EST_HIGH_RATIO) -
                              tdiv(r.high_est, OOK_EST_HIGH_RATIO);
                r.high_est = max(h, r.min_high);
                r.ook_f1 = r.ook_f1 + tdiv(f, OOK_EST_HIGH_RATIO) -
                           tdiv(r.ook_f1, OOK_EST_HIGH_RATIO);
                r.plen = p_len;
            }
            gate = r.num == 0;
        } else if (st == ST_GAP_START) {                      // ref :376-421
            r.plen += 1;
            if (above) {
                r.plen += r.cur_pulse;
                new_st = ST_PULSE;
            } else if (r.plen >= PD_MIN_PULSE_SAMPLES) {
                new_st = ST_GAP;
                if (r.fsk_num > PD_MIN_PULSES) {
                    fsk_publish = true;
                    new_st = ST_IDLE;
                }
            }
            gate = !fsk_publish && r.num == 0;
        } else {                                              // ref :422-469
            r.plen += 1;
            bool g_maxp = false, g_eop_gap = false;
            if (above) {
                e.rec = true; e.idx = r.num; e.p = r.cur_pulse; e.g = r.plen; e.tag = 1;
                r.num += 1;
                if (r.num >= prm.maxp) {
                    g_maxp = true;
                } else {
                    r.plen = 0; r.cur_pulse = 0;
                    new_st = ST_PULSE;
                }
            }
            if (!g_maxp && (r.eop_spur > 0 ||
                            (r.plen > PD_MAX_GAP_RATIO * r.max_pulse &&
                             r.plen > PD_MIN_GAP_MS * prm.spm) ||
                            r.plen > PD_MAX_GAP_MS * prm.spm)) {
                g_eop_gap = true;
                if (!e.rec) {
                    e.rec = true; e.idx = r.num; e.p = r.cur_pulse; e.g = r.plen; e.tag = 1;
                }
            }
            if (g_maxp || g_eop_gap) {
                ook_eop = true;
                ook_final_num = g_eop_gap ? r.num + 1 : r.num;
                new_st = ST_IDLE;
                r.eop_spur = 0;
            }
        }
        if (gate) {
            const bool fr = MINMAX ? fsk_minmax(r, f, e) : fsk_classic(r, f, e);
            if (fr) { e.rec = true; e.tag = 3; }
        }
        int fsk_final_num = r.fsk_num;
        if (fsk_publish && !MINMAX && r.fsk_num < prm.maxp) {  // wrap_up
            const int wlen = r.flen + 1;
            e.rec = true; e.idx = r.fsk_num; e.tag = 3;
            if (r.fsk_state == FSK_FH) { e.p = wlen; e.g = 0; }
            else { e.p = r.fsk_cur_pulse; e.g = wlen; }
            fsk_final_num = r.fsk_num + 1;
        }
        r.ook_state = new_st;
        if (e.rec) e.tag += r.gen << 2;     // 1 + fsk*2 + (gen << 2)
        if (ook_eop || fsk_publish) {
            e.eop = true;
            e.meta[0] = fsk_publish ? PKG_FSK : PKG_OOK;
            e.meta[1] = fsk_publish ? fsk_final_num : ook_final_num;
            e.meta[2] = r.low_est;
            e.meta[3] = r.high_est;
            e.meta[4] = fsk_publish ? r.f1 : r.ook_f1;
            e.meta[5] = fsk_publish ? r.f2 : 0;
            e.meta[6] = r.pkg_start;
            e.meta[7] = t;
            e.meta[8] = r.gen;
            // the publish sample is processed again in IDLE (ref
            // src/pulse_detect.c:293-476 returns before data_counter++)
            if (above && r.lead_in > OOK_EST_LOW_RATIO) start_mask = true;
            else idle_mask = true;
        }
    }
    if (idle_mask) {                                          // ref :326-333
        r.low_est = idle_low(r.low_est, a);
        r.high_est = max(prm.ratio * r.low_est, r.min_high);
        if (r.lead_in <= OOK_EST_LOW_RATIO) r.lead_in += 1;
    } else if (start_mask) {                                  // ref :312-323
        r.plen = 0; r.max_pulse = 0; r.num = 0; r.cur_pulse = 0; r.ook_f1 = 0;
        r.pkg_start = t;
        r.gen += 1;
        r.fsk_state = FSK_INIT; r.flen = 0; r.f1 = 0; r.f2 = 0;
        r.vmax = -32768; r.vmin = 32767; r.skip = 40;
        r.fsk_num = 0; r.fsk_cur_pulse = 0;
        r.ook_state = ST_PULSE;
    }
}

// ---- Runs: stretches of samples on which fsm_step would take one plain
// branch (IDLE EWMA, GAP and GAP_START counts, PULSE level tracking, with
// or without the classic FSK tracker's steady-tone EWMA) and emit
// nothing. Each run applies exactly that branch's updates, in fsm_step's
// order, and returns the local index of the first sample that leaves the
// branch, which the caller hands to fsm_step. Except in GAP_START (at most
// nine samples), samples go in batches of RUN_U computed without branches
// and kept only if none of them leaves (one test per batch instead of one
// branch per sample), then one at a time up to the leaving sample.
constexpr int RUN_U = 8;

// Whether the next sample starts a run (idle_run, gap_run, gap_start_run,
// pulse_run, or fsk_run for the classic tracker).
template <bool MINMAX>
__device__ __forceinline__ bool run_applies(const Regs& r) {
    return r.ook_state == ST_IDLE || (r.ook_state == ST_GAP && r.eop_spur == 0) ||
           (r.ook_state == ST_GAP_START && r.num > 0) ||
           (r.ook_state == ST_PULSE &&
            (r.num > 0 || (!MINMAX && (r.fsk_state == FSK_FH || r.fsk_state == FSK_FL))));
}

// fsm_step's threshold and hysteresis from the level estimators
__device__ __forceinline__ void thr_hyst(int low, int high, const Params& prm,
                                         int& thr, int& hyst) {
    const int h = tdiv(low + min(high, OOK_MAX_HIGH_LEVEL), 2);
    thr = h + ((prm.fixed - h) & -static_cast<int>(prm.fixed != 0));  // no branch
    hyst = tdiv(thr, 8);
}

// IDLE: every sample up to the one that starts a pulse.
__device__ __forceinline__ int idle_run(Regs& r, const Params& prm,
                                        const int16_t* A, int Lm, int k, int n) {
    int low = r.low_est, high = r.high_est, lead = r.lead_in;
    const int mh = r.min_high;
    while (k + RUN_U <= n) {
        int l2 = low, h2 = high, d2 = lead;
        bool hit = false;
#pragma unroll
        for (int u = 0; u < RUN_U; ++u) {
            const int a = A[(k + u) * Lm];
            int thr, hyst;
            thr_hyst(l2, h2, prm, thr, hyst);
            hit |= a > thr + hyst && d2 > OOK_EST_LOW_RATIO;
            l2 = idle_low(l2, a);
            h2 = max(prm.ratio * l2, mh);
            d2 += d2 <= OOK_EST_LOW_RATIO ? 1 : 0;
        }
        if (hit) break;
        low = l2; high = h2; lead = d2;
        k += RUN_U;
    }
    for (; k < n; ++k) {
        const int a = A[k * Lm];
        int thr, hyst;
        thr_hyst(low, high, prm, thr, hyst);
        if (a > thr + hyst && lead > OOK_EST_LOW_RATIO) break;
        low = idle_low(low, a);
        high = max(prm.ratio * low, mh);
        lead += lead <= OOK_EST_LOW_RATIO ? 1 : 0;
    }
    r.low_est = low; r.high_est = high; r.lead_in = lead;
    return k;
}

// GAP with no pending spurious-pulse EOP: plen counts up to the first
// sample above threshold or past the end-of-package gap.
__device__ __forceinline__ int gap_run(Regs& r, const Params& prm,
                                       const int16_t* A, int Lm, int k, int n) {
    int thr, hyst;
    thr_hyst(r.low_est, r.high_est, prm, thr, hyst);
    const int th = thr + hyst;
    // (p > 10*max_pulse && p > 10 ms) || p > 100 ms  <=>  p > lim
    const int lim = min(max(PD_MAX_GAP_RATIO * r.max_pulse, PD_MIN_GAP_MS * prm.spm),
                        PD_MAX_GAP_MS * prm.spm);
    int plen = r.plen;
    while (k + RUN_U <= n && plen + RUN_U <= lim) {
        bool hit = false;
#pragma unroll
        for (int u = 0; u < RUN_U; ++u) hit |= A[(k + u) * Lm] > th;
        if (hit) break;
        plen += RUN_U;
        k += RUN_U;
    }
    for (; k < n; ++k) {
        if (A[k * Lm] > th || plen + 1 > lim) break;
        ++plen;
    }
    r.plen = plen;
    return k;
}

// GAP_START past the package's first pulse (no FSK gate): plen counts up
// to the first sample above threshold or to the shortest gap.
__device__ __forceinline__ int gap_start_run(Regs& r, const Params& prm,
                                             const int16_t* A, int Lm, int k,
                                             int n) {
    int thr, hyst;
    thr_hyst(r.low_est, r.high_est, prm, thr, hyst);
    const int th = thr + hyst;
    int plen = r.plen;
    for (; k < n; ++k) {
        if (A[k * Lm] > th || plen + 1 >= PD_MIN_PULSE_SAMPLES) break;
        ++plen;
    }
    r.plen = plen;
    return k;
}

// PULSE past the package's first pulse (no FSK gate): the high level and
// ook_f1 track the pulse up to the first sample below threshold.
template <typename FmT>
__device__ __forceinline__ int pulse_run(Regs& r, const Params& prm,
                                         const int16_t* A, const FmT* F, int Lm,
                                         int k, int n) {
    const int low = r.low_est, mh = r.min_high;
    int high = r.high_est, f1 = r.ook_f1, plen = r.plen;
    while (k + RUN_U <= n) {
        int h2 = high, g2 = f1;
        bool hit = false;
#pragma unroll
        for (int u = 0; u < RUN_U; ++u) {
            const int a = A[(k + u) * Lm];
            const int f = static_cast<int>(F[(k + u) * Lm]);
            int thr, hyst;
            thr_hyst(low, h2, prm, thr, hyst);
            hit |= a < thr - hyst;
            h2 = max(h2 + tdiv(a, OOK_EST_HIGH_RATIO) - tdiv(h2, OOK_EST_HIGH_RATIO), mh);
            g2 = g2 + tdiv(f, OOK_EST_HIGH_RATIO) - tdiv(g2, OOK_EST_HIGH_RATIO);
        }
        if (hit) break;
        high = h2; f1 = g2; plen += RUN_U;
        k += RUN_U;
    }
    for (; k < n; ++k) {
        const int a = A[k * Lm];
        int thr, hyst;
        thr_hyst(low, high, prm, thr, hyst);
        if (a < thr - hyst) break;
        const int f = static_cast<int>(F[k * Lm]);
        high = max(high + tdiv(a, OOK_EST_HIGH_RATIO) - tdiv(high, OOK_EST_HIGH_RATIO), mh);
        f1 = f1 + tdiv(f, OOK_EST_HIGH_RATIO) - tdiv(f1, OOK_EST_HIGH_RATIO);
        ++plen;
    }
    r.high_est = high; r.ook_f1 = f1; r.plen = plen;
    return k;
}

// PULSE of a package's first pulse with the classic FSK tracker in FH or
// FL (an FSK burst on a steady carrier): pulse_run's level tracking plus
// the tracker's frequency EWMA, up to the first sample below threshold or
// that switches tone.
template <typename FmT>
__device__ __forceinline__ int fsk_run(Regs& r, const Params& prm,
                                       const int16_t* A, const FmT* F, int Lm,
                                       int k, int n) {
    const int low = r.low_est, mh = r.min_high;
    const bool fh = r.fsk_state == FSK_FH;
    int high = r.high_est, of1 = r.ook_f1, f1 = r.f1, f2 = r.f2;
    int m = 0;                          // samples taken
    while (k + RUN_U <= n) {
        int h2 = high, g2 = of1, p1 = f1, p2 = f2;
        bool hit = false;
#pragma unroll
        for (int u = 0; u < RUN_U; ++u) {
            const int a = A[(k + u) * Lm];
            const int f = static_cast<int>(F[(k + u) * Lm]);
            int thr, hyst;
            thr_hyst(low, h2, prm, thr, hyst);
            hit |= a < thr - hyst;
            h2 = max(h2 + tdiv(a, OOK_EST_HIGH_RATIO) - tdiv(h2, OOK_EST_HIGH_RATIO), mh);
            g2 = g2 + tdiv(f, OOK_EST_HIGH_RATIO) - tdiv(g2, OOK_EST_HIGH_RATIO);
            const int d1 = abs(f - p1), d2 = abs(f - p2);
            // the tone's EWMA, fast toward the tone's edge, slow back:
            // both forms computed and one kept by a mask, not a branch
            hit |= fh ? d1 > d2 : d2 > d1;
            const int q = fh ? p1 : p2;
            const int fast = q + tdiv(f, FSK_EST_FAST) - tdiv(q, FSK_EST_FAST);
            const int slow = q + tdiv(f, FSK_EST_SLOW) - tdiv(q, FSK_EST_SLOW);
            const int nq = slow + ((fast - slow) & -static_cast<int>(fh ? f > q : f < q));
            p1 = fh ? nq : p1;
            p2 = fh ? p2 : nq;
        }
        if (hit) break;
        high = h2; of1 = g2; f1 = p1; f2 = p2; m += RUN_U;
        k += RUN_U;
    }
    for (; k < n; ++k) {
        const int a = A[k * Lm];
        const int f = static_cast<int>(F[k * Lm]);
        int thr, hyst;
        thr_hyst(low, high, prm, thr, hyst);
        if (a < thr - hyst) break;
        const int d1 = abs(f - f1), d2 = abs(f - f2);
        if (fh ? d1 > d2 : d2 > d1) break;
        high = max(high + tdiv(a, OOK_EST_HIGH_RATIO) - tdiv(high, OOK_EST_HIGH_RATIO), mh);
        of1 = of1 + tdiv(f, OOK_EST_HIGH_RATIO) - tdiv(of1, OOK_EST_HIGH_RATIO);
        if (fh)
            f1 = f > f1 ? f1 + tdiv(f, FSK_EST_FAST) - tdiv(f1, FSK_EST_FAST)
                        : f1 + tdiv(f, FSK_EST_SLOW) - tdiv(f1, FSK_EST_SLOW);
        else
            f2 = f < f2 ? f2 + tdiv(f, FSK_EST_FAST) - tdiv(f2, FSK_EST_FAST)
                        : f2 + tdiv(f, FSK_EST_SLOW) - tdiv(f2, FSK_EST_SLOW);
        ++m;
    }
    r.high_est = high; r.ook_f1 = of1; r.f1 = f1; r.f2 = f2;
    r.plen += m; r.flen += m;
    return k;
}

}  // namespace rtl433
