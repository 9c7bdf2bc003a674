// Device slicing: each (train, spec) lane runs one reference slicer over its
// train and writes the lane's bitbuffers; two families (PCM, NRZS) walk
// the lane's state machine on one thread, the other seven (PPM, MC, PWM,
// DMC, PIWM-DC, RZI, OSV1) split it over a thread group.
//
// Replaces the nine lax.scan slicers of the JAX package's ops/slice.py
// (slice_ppm, slice_pwm, slice_pcm with _pcm_rates, slice_mc, slice_dmc,
// slice_piwm_dc, slice_nrzs, slice_rzi, slice_osv1) and their scatter-add
// assembly (_assemble, _assemble_runs, PCM's delta-scatter and cumsum).
// The wrappers and the plain torch versions are in ops/slice.py; the
// contract is theirs, to the integer:
//   bytes        uint8 [B, S, E, R, BY]   packed rows, MSB first
//   bits_per_row int32 [B, S, E, R]
//   syncs        int32 [B, S, E, R]
//   num_rows     int32 [B, S, E]
//   n_events     int32 [B, S], ovf uint8 [B, S]
// The kernel writes every element of them once (the wrapper allocates
// them uninitialized). A write outside the caps (event >= E, row >= R,
// bit >= 8 * BY) is dropped, as the JAX scatters drop it.
//
// The walk (PCM, NRZS). A CTA covers one
// train (blockIdx.y) and `lanes` specs of one family (blockIdx.x; 64, or
// 32 where S <= 32 or 64 would not fit); it
// stages the train's n_pulses[b] pulse and gap values into shared memory
// once, and every thread then walks only that many steps, reading the
// same shared word as all its neighbours (a broadcast). The spec's bounds
// sit in registers. One
// template takes a per-family step function (two instantiations); the
// writer is shared (struct Lane, warp_put). Every family writes only its
// current event, whose index only grows, so a lane stages its events in
// shared memory: runs of ones are 32-bit word ors (the JAX cumulative sum
// of +1/-1 deltas), PCM's erases word stores. The warp
// writes a lane's events to device memory together, consecutive threads
// on consecutive 16-byte chunks of that lane's contiguous range (bytes
// where the caps do not allow 16), and writes zeros for the events the
// lane never reached; so the planes are written once, coalesced, and
// nothing is read back from device memory. Two staging modes, chosen by
// ops/slice.py launch_plan:
//   every event staged (kAll), where the grid then fits on the card at
//     once: nothing leaves before the lane ends, so the walk never stops
//     for a write-out (such a call is bound by its slowest lane);
//   one event staged otherwise (784 bytes at PCM's caps 16 x 40, four
//     blocks of 64 lanes per SM): at the top of each step, where the lanes
//     of a block meet (they walk the same train), the warp writes out the
//     lanes whose family moved past their staged event (warp_moved).
//
// The groups (PPM, MC, PWM, DMC, PIWM-DC, RZI, OSV1; slice_groups). A
// group of G threads (32, or 8 or 16 where the train is short) runs one
// lane over tiles of G steps, a step per thread: a pulse and its gap for
// PPM, MC, PWM, RZI and OSV1, symbols of the interleaved pulse/gap axis
// for DMC and PIWM-DC (kSymbols; 2n of them). A CTA holds one train and
// up to four warps of lanes. Most of the seven step functions is not
// serial: what a gap, pulse or symbol is (PPM's four classes, PWM's five;
// MC's out, its resync 1, the flush; DMC's and PIWM-DC's classes and
// reset test; RZI's ones, whether a pulse opens a message) and whether it
// may end an event or a row depends on no state, and the cursors only
// count or reset since the last reset. OSV1's phase machine has a closed
// form (its phases are fixed pulses until the flush). So a tile is
//   1. classified, a predicate per thread; OSV1: its preamble and sync
//      resolved from ballots, a phase carried across tiles;
//   2. MC: walked for its time since the last bit (tsl), the one value
//      that carries across pulses, one walk per piece between resets that
//      need no state (out, flush, and where every width of the train is
//      tame, a pulse or gap over 1.5 short widths), in registers; the walk
//      emits a mid-bit 1 and 0 flag per pulse. DMC: its pending flag, the
//      parity of the run of in_short symbols before each, from one
//      ballot; OSV1: its Manchester bit, a parity from one ballot;
//   3. given its cursors by ballots: popcounts of the emissions since the
//      last reset give each emission its (event, row, bit), each flush its
//      rows and the lane its overflow, judged on the pre-flush cursors as
//      the step functions judge it; RZI, whose step adds a run of bits,
//      by a segmented add-scan since the last flush candidate
//      (Group::seg_scan); a tile hands its cursors to the next through
//      its last thread;
//   4. written to the group's stage (every event, struct Stage): a row's
//      bit count by the thread of its last bit in the tile, its bytes by
//      word ORs (the positions of a tile never decrease with the thread,
//      so a segmented OR-scan gives each word one store; RZI's runs, which
//      span words and share their edge words, by atomic ORs), syncs by
//      shared adds; OSV1 ORs the ones below the row's last bit, counts
//      those the JAX scatter-add clips to it and adds the count to the
//      row's last byte once at the end (GroupFamily::end).
// OSV1 stops a CTA's tiles once none of its lanes can write (kStops: a
// CTA-wide vote a tile). At the end the group writes its stage out with
// warp_put's writer.
//
// Float32 in PCM: the JAX scan and the plain version round each product
// and sum separately, so every float operation here is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __int2float_rn), which nvcc never contracts into an FMA; jnp.round is
// round-half-even (rintf). Built without --use_fast_math.
//
// Bound: the bytes of the output planes (each written once) against
// integer work over B * S * n steps (a few tens of int32 ops per step;
// 2n symbols for DMC and PIWM-DC).
// At a drain of the 4096-channel workload the planes are tens of MB, so
// the bytes bound it on paper; on the card a call of up to a few
// thousand lanes is one wave, bound by the latency of its slowest lane's
// serial walk (one thread, about a microsecond a pulse at PCM), and the
// large call by that walk plus the planes' write-out. The walk's design
// takes the write-out off the walk (coalesced, by the warp, never per bit)
// and, where it fits, out of the walk altogether; it does not shorten the
// walk itself. The groups shorten it for all but PCM and NRZS: a tile of
// G steps costs a fixed few hundred cycles of ballots, shuffles and stage
// stores, and MC's remaining serial walk is as long as its longest piece
// (a pulse or two on Manchester data).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NCOLS = 12;     // ops/slice.py NCOLS

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// The output planes and caps of a launch, and the layout of a lane's
// stage: ES staged events (E with every event staged, else 1), each as
// rows [R, BYP] (BY rounded up to 4 bytes), then bits_per_row [ES, R],
// syncs [ES, R] and num_rows [ES], each part rounded up to 16 bytes
// (ops/slice.py stage_bytes).
struct Planes {
  uint8_t* bytes;   // [B, S, E, R, BY]
  int* bpr;         // [B, S, E, R]
  int* syncs;       // [B, S, E, R]
  int* nrows;       // [B, S, E]
  int E, R, BY, ES;
  int BYP;          // bytes of a staged row
  int ob, os, on;   // stage offsets: bits_per_row, syncs, num_rows
  bool v16;         // rows in 16-byte stores: BY % 4 == 0, R * BY % 16 == 0
  bool r4;          // counts in 16-byte stores: R % 4 == 0
  __device__ Planes(uint8_t* b, int* p, int* s, int* n, int E_, int R_,
                    int BY_, int ES_)
      : bytes(b), bpr(p), syncs(s), nrows(n), E(E_), R(R_), BY(BY_),
        ES(ES_), BYP((BY_ + 3) & ~3),
        ob(round16(ES_ * R_ * ((BY_ + 3) & ~3))),
        os(round16(ES_ * R_ * ((BY_ + 3) & ~3)) + 4 * ES_ * R_),
        on(round16(ES_ * R_ * ((BY_ + 3) & ~3)) + round16(8 * ES_ * R_)),
        v16(BY_ % 4 == 0 && (R_ * BY_) % 16 == 0), r4(R_ % 4 == 0) {}
  __device__ int stage_words() const { return (on + round16(4 * ES)) / 4; }
};

// bits [lo, hi) of word k of a staged row (clipped to the word: lo and hi
// count from its first bit): a row is BYP / 4 words whose bytes hold the
// row's bits MSB first, so a word takes the big-endian mask of its 32
// bits, byte-swapped
__device__ __forceinline__ uint32_t run_word(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  const uint32_t m = (0xffffffffu >> lo) &
                     (hi >= 32 ? 0xffffffffu : ~(0xffffffffu >> hi));
  return __byte_perm(m, 0, 0x0123);
}

// One lane's stage in shared memory. Every family writes only its
// current event, whose index only grows. With every event staged (kAll),
// event e is stage slot e and nothing leaves before the lane ends. With
// one, the slot holds event sev; once the family has moved past it, the
// warp writes it out at the top of the next step (warp_moved) and the
// slot takes the next event. Writes outside the caps are dropped.
template <bool kAll>
struct Lane {
  const Planes& pl;
  uint8_t* st;      // the stage
  int E, R, BY, BYP;
  int sev = 0;      // one event staged: that event (E: none left)

  __device__ Lane(const Planes& p, uint8_t* stage)
      : pl(p), st(stage), E(p.E), R(p.R), BY(p.BY), BYP(p.BYP) {
    uint4* s4 = reinterpret_cast<uint4*>(stage);
    for (int i = 0; i < p.stage_words() / 4; ++i)
      s4[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ int slot(int ev) const { return kAll ? ev : 0; }
  __device__ uint8_t* row(int ev, int r) const {
    return st + (slot(ev) * R + r) * BYP;
  }
  __device__ int& nbits(int ev, int r) const {
    return reinterpret_cast<int*>(st + pl.ob)[slot(ev) * R + r];
  }
  __device__ int& nrow(int ev) const {
    return reinterpret_cast<int*>(st + pl.on)[slot(ev)];
  }

  __device__ bool in(int ev, int row) const {
    return ev >= 0 && ev < E && row >= 0 && row < R;
  }
  // one event staged: the slot now holds event ev (<= E)
  __device__ void moved_to(int ev) { sev = ev; }
  // ev's slot can take a write; false where ev lies outside the caps. A
  // write past the one staged event inside a step breaks the contract
  // above (the lane's stage would be lost): the launch fails.
  __device__ bool at(int ev) {
    if (kAll) return ev >= 0 && ev < E;
    if (ev < sev || ev >= E) return false;
    if (ev != sev) __trap();
    return true;
  }

  __device__ void count(int ev, int r, int n) {
    if (in(ev, r) && at(ev)) nbits(ev, r) += n;
  }
  __device__ void rows(int ev, int n) {
    if (at(ev)) nrow(ev) += n;
  }
  // bits [start, start + len) of a row set to one, clipped at 8 * BY
  __device__ void run(int ev, int r, int start, int len) {
    if (len <= 0 || !in(ev, r) || !at(ev)) return;
    const int a = max(start, 0), b = min(start + len, 8 * BY);
    uint32_t* w = reinterpret_cast<uint32_t*>(row(ev, r));
    for (int k = a >> 5; a < b && k <= (b - 1) >> 5; ++k)
      w[k] |= run_word(a - 32 * k, b - 32 * k);
  }
  // rows [0, last] of an event back to zero (bytes and bit counts)
  __device__ void erase(int ev, int last) {
    if (last < 0 || !at(ev)) return;
    const int n = min(last, R - 1) + 1;
    uint32_t* w = reinterpret_cast<uint32_t*>(row(ev, 0));
    for (int i = 0; i < n * BYP / 4; ++i) w[i] = 0u;
    for (int r = 0; r < n; ++r) nbits(ev, r) = 0;
  }
};

// Threads t = 0..nt-1 write one lane's events [ev, ev + nev) from its
// stage `st` (its slots 0..nev-1; nothing where ev >= E) and zeros for the
// events after them up to `to`; with `clear` they also clear the stage for
// the lane's next event. Consecutive threads take consecutive 16-byte
// chunks of the lane's contiguous event range (bytes where the caps do not
// allow 16). Each calls it with the same values, after a __syncwarp that
// makes the lane's stage visible; with `clear` (the lanes 0..nt-1 of a
// warp, `alive`), the lane reads its stage again only after another.
__device__ void put_events(const Planes& p, size_t lane, uint8_t* st, int ev,
                           int nev, int to, bool clear, int t, int nt,
                           unsigned alive) {
  const int E = p.E, R = p.R;
  const int EV = R * p.BY;                         // bytes of one event
  uint8_t* gb = p.bytes + lane * E * EV;
  int* gp = p.bpr + lane * E * R;
  int* gs = p.syncs + lane * E * R;
  int* gn = p.nrows + lane * E;
  int* sp = reinterpret_cast<int*>(st + p.ob);
  int* ss = reinterpret_cast<int*>(st + p.os);
  int* sn = reinterpret_cast<int*>(st + p.on);
  int from = ev;
  if (ev < E) {
    nev = min(nev, E - ev);
    if (p.v16) {
      uint4* d = reinterpret_cast<uint4*>(gb + ev * EV);
      uint4* s4 = reinterpret_cast<uint4*>(st);
      for (int i = t; i < nev * EV / 16; i += nt) {
        d[i] = s4[i];
        if (clear) s4[i] = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = t; i < nev * EV; i += nt)
        gb[ev * EV + i] = st[(i / p.BY) * p.BYP + i % p.BY];
      if (clear) {
        __syncwarp(alive);
        uint32_t* w = reinterpret_cast<uint32_t*>(st);
        for (int i = t; i < nev * R * p.BYP / 4; i += nt) w[i] = 0u;
      }
    }
    if (p.r4) {
      int4* dp = reinterpret_cast<int4*>(gp + ev * R);
      int4* ds = reinterpret_cast<int4*>(gs + ev * R);
      int4* sp4 = reinterpret_cast<int4*>(sp);
      int4* ss4 = reinterpret_cast<int4*>(ss);
      for (int i = t; i < nev * R / 4; i += nt) {
        dp[i] = sp4[i];
        ds[i] = ss4[i];
        if (clear) sp4[i] = ss4[i] = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int i = t; i < nev * R; i += nt) {
        gp[ev * R + i] = sp[i];
        gs[ev * R + i] = ss[i];
        if (clear) sp[i] = ss[i] = 0;
      }
    }
    for (int i = t; i < nev; i += nt) {
      gn[ev + i] = sn[i];
      if (clear) sn[i] = 0;
    }
    from = ev + nev;
  }
  to = min(to, E);
  if (from < to) {
    if (p.v16) {
      uint4* d = reinterpret_cast<uint4*>(gb);
      for (int i = from * EV / 16 + t; i < to * EV / 16; i += nt)
        d[i] = make_uint4(0, 0, 0, 0);
    } else {
      for (int i = from * EV + t; i < to * EV; i += nt) gb[i] = 0;
    }
    if (p.r4) {
      int4* dp = reinterpret_cast<int4*>(gp);
      int4* ds = reinterpret_cast<int4*>(gs);
      for (int i = from * R / 4 + t; i < to * R / 4; i += nt) {
        dp[i] = make_int4(0, 0, 0, 0);
        ds[i] = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int i = from * R + t; i < to * R; i += nt) gp[i] = gs[i] = 0;
    }
    for (int e = from + t; e < to; e += nt) gn[e] = 0;
  }
}

// put_events by the lanes `alive` of a warp
__device__ void warp_put(const Planes& p, size_t lane, uint8_t* st, int ev,
                         int nev, int to, bool clear, unsigned alive) {
  put_events(p, lane, st, ev, nev, to, clear, threadIdx.x & 31,
             __popc(alive), alive);
}

// float helpers: explicit round-to-nearest, never contracted
__device__ __forceinline__ float i2f(int v) { return __int2float_rn(v); }

// a float32 bound column carried as its bits
__device__ __forceinline__ float bits_to_float(int v) {
  float f;
  memcpy(&f, &v, sizeof f);
  return f;
}

// int(v + 0.5) truncated toward zero, and whether x lies within the
// float32-vs-float64 uncertainty of a rounding boundary (JAX _trunc05)
__device__ __forceinline__ int trunc05(float v, bool& near) {
  float x = __fadd_rn(v, 0.5f);
  float eps = __fadd_rn(1e-6f, __fmul_rn(fabsf(x), 2e-6f));
  near = fabsf(__fsub_rn(x, rintf(x))) < eps;
  return __float2int_rz(x);
}

// ---- the walk's families: state, step, end -----------------------------
//
// Each step is the JAX step of its family for one lane: the same
// comparisons in the same order, its emissions written where the JAX
// assembly scatters them. Each family also carries ev (events so far) and
// ovf.

struct Pcm {
  int sh, lo, rst, gpl, tol, mz, mc0;
  bool is_rz;
  float fs, fl;
  int ev = 0, row = 0, bir = 0, frb = 0;
  int dirty = -1;   // last row written in the current segment of ev
  bool ovf = false;
  __device__ explicit Pcm(const int* c)
      : sh(c[0]), lo(c[1]), rst(c[2]), gpl(c[3]), tol(c[4]), mz(c[5]),
        mc0(c[6]), is_rz(c[7] != 0), fs(bits_to_float(c[8])),
        fl(bits_to_float(c[9])) {}

  // JAX _pcm_rates: the preamble run estimator (its condition reads the
  // running estimate), then the order-free fallback sums
  __device__ void pre(const int* P, const int* G, int n) {
    int cnt = 0, sw = 0, lw = 0, mc = mc0, plen = 0;
    bool prev_c = false, flag = false;
    auto eval_run = [&]() {
      if (cnt < mc) return;
      float cntf = i2f(cnt);
      float fs_rz = sw > 0 ? __fdiv_rn(cntf, i2f(sw)) : fs;
      float fl_rz = lw > 0 ? __fdiv_rn(cntf, i2f(lw)) : fl;
      float f_nrz = sw > 0 ? __fdiv_rn(cntf, i2f(sw)) : fs;
      fs = is_rz ? fs_rz : f_nrz;
      fl = is_rz ? fl_rz : f_nrz;
      mc = cnt;
      plen = cnt;
    };
    for (int i = 0; i < n; ++i) {
      int p = P[i], g = G[i];
      bool c_rz = p >= sh - tol && p <= sh + tol && p + g >= lo - tol &&
                  p + g <= lo + tol;
      bool near_p, near_g;
      int hp = trunc05(__fmul_rn(i2f(p), fs), near_p);
      int hg = trunc05(__fmul_rn(i2f(g), fl), near_g);
      bool c = is_rz ? c_rz : (hp == 1 && hg == 1);
      flag = flag || (!is_rz && ((near_p && hp <= 2) || (near_g && hg <= 2)));
      if (prev_c && !c) eval_run();
      if (c) {
        cnt += is_rz ? 1 : 2;
        sw += is_rz ? p : p + g;
        lw += p + g;
      } else {
        cnt = sw = lw = 0;
      }
      prev_c = c;
    }
    if (cnt > 0) eval_run();
    // fallbacks over the whole train
    int rzc = 0, rzs = 0, rzl = 0, nw = 0, nc = 0;
    for (int i = 0; i < n; ++i) {
      int p = P[i], g = G[i];
      if (p >= sh - tol && p <= sh + tol && p + g >= lo - tol &&
          p + g <= lo + tol) {
        rzc += 1; rzs += p; rzl += p + g;
      }
      if (p >= sh - tol && p <= sh + tol) { nw += p; nc += 1; }
      if (p >= 2 * sh - tol && p <= 2 * sh + tol) { nw += p; nc += 2; }
      if (g >= lo - tol && g <= lo + tol) { nw += g; nc += 1; }
      if (g >= 2 * lo - tol && g <= 2 * lo + tol) { nw += g; nc += 2; }
    }
    if (is_rz && plen == 0 && rzc > 8) {
      fs = __fdiv_rn(i2f(rzc), i2f(max(rzs, 1)));
      fl = __fdiv_rn(i2f(rzc), i2f(max(rzl, 1)));
    }
    if (!is_rz && plen == 0 && nc > 20) {
      fs = fl = __fdiv_rn(i2f(nc), i2f(max(nw, 1)));
    }
    ovf = flag;
  }

  template <class L>
  __device__ void step(int p, int g, bool last, L& o) {
    bool near_h, near_l;
    int h = trunc05(__fmul_rn(i2f(p), fs), near_h);
    int l0 = trunc05(__fmul_rn(i2f(g + sh - lo), fl), near_l);
    near_l = near_l && l0 <= mz + 1;
    h = max(h, 0);
    int l = min(max(l0, 0), mz);
    bool ovf2 = ovf || near_h || near_l;
    // a run of h ones then l zeros at the cursor
    if (h + l > 0 && o.in(ev, row)) {
      o.count(ev, row, h + l);
      o.run(ev, row, bir, h);
      dirty = max(dirty, row);
    }
    int bir2 = bir + h + l;
    int frb2 = row == 0 ? frb + h + l : frb;
    bool do_clear = is_rz && abs(p - sh) > tol;
    bool do_break = !do_clear && g > gpl && g <= rst;
    // a clear starts a new segment: what this event wrote so far (this
    // step's run too) is not kept
    if (do_clear) { o.erase(ev, dirty); dirty = -1; }
    int row2 = do_clear ? 0 : (do_break ? row + 1 : row);
    int bir3 = (do_clear || do_break) ? 0 : bir2;
    int frb3 = do_clear ? 0 : frb2;
    bool flush = (g > rst || last) && (frb3 > 0 || row2 > 0);
    if (flush) { o.rows(ev, row2 + 1); dirty = -1; }
    int ev2 = flush ? ev + 1 : ev;
    ovf = ovf2 || ev2 >= o.E || max(row2, row) >= o.R || bir2 >= o.BY * 8;
    ev = ev2;
    row = flush ? 0 : row2;
    bir = flush ? 0 : bir3;
    frb = flush ? 0 : frb3;
  }
  // the event left open at the end never flushed: none of it is kept
  template <class L>
  __device__ void end(L& o) { o.erase(ev, dirty); }
};

struct Nrzs {
  int sh, rst;
  int ev = 0, bir = 0;
  bool ovf = false;
  __device__ explicit Nrzs(const int* c) : sh(c[0]), rst(c[1]) {}
  __device__ void pre(const int*, const int*, int) {}
  template <class L>
  __device__ void step(int p, int g, bool last, L& o) {
    int h = p > sh ? p / max(sh, 1) : 0;
    int z = p != sh ? 1 : 0;
    o.run(ev, 0, bir, h);
    if (h + z > 0) o.count(ev, 0, h + z);
    int bir2 = bir + h + z;
    bool flush = g >= rst || last;
    if (flush) o.rows(ev, bir2 > 0 ? 1 : 0);
    int ev2 = flush ? ev + 1 : ev;
    ovf = ovf || bir2 > o.BY * 8 || (flush && ev2 >= o.E);
    ev = ev2;
    bir = flush ? 0 : bir2;
  }
  template <class L>
  __device__ void end(L&) {}
};

// One event staged: lanes whose family moved past their staged event (a
// flush in the step before) are written out by the warp, then each stages
// its new event. Every thread of `alive` calls it at the same step.
template <class F>
__device__ __forceinline__ void warp_moved(const F& f, Lane<false>& o,
                                           bool ok, unsigned alive,
                                           const Planes& pl, size_t lane0,
                                           uint8_t* stage0, int SB) {
  const bool moved = ok && f.ev > o.sev && o.sev < o.E;
  unsigned m = __ballot_sync(alive, moved);
  if (!m) return;
  __syncwarp(alive);
  for (; m; m &= m - 1) {
    const int L = __ffs(m) - 1;
    warp_put(pl, lane0 + L, stage0 + (size_t)L * SB,
             __shfl_sync(alive, o.sev, L), 1, __shfl_sync(alive, f.ev, L),
             true, alive);
  }
  __syncwarp(alive);
  if (moved) o.moved_to(min(f.ev, o.E));
}

template <class F, bool kAll>
__global__ void slice_lanes(const int* __restrict__ pulse,
                            const int* __restrict__ gap,
                            const int* __restrict__ n_pulses, int N,
                            const int* __restrict__ bounds, int S, int E,
                            int R, int BY, int SB, uint8_t* bytes, int* bpr,
                            int* syncs, int* nrows, int* n_events,
                            uint8_t* ovf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sp = reinterpret_cast<int*>(smem);
  int* sg = sp + N;
  const int b = blockIdx.y;
  const int n = min(max(n_pulses[b], 0), N);
  const int* pb = pulse + (size_t)b * N;
  const int* gb = gap + (size_t)b * N;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sp[i] = pb[i];
    sg[i] = gb[i];
  }
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  // the warp's lanes inside S: lanes 0..k-1, as s grows with the lane
  const unsigned alive = __ballot_sync(0xffffffffu, s < S);
  if (s >= S) return;
  const int t = threadIdx.x & 31;
  const size_t lane = (size_t)b * S + s;
  uint8_t* stage = smem + round16(8 * N) + (size_t)threadIdx.x * SB;
  const Planes pl(bytes, bpr, syncs, nrows, E, R, BY, kAll ? E : 1);
  const int* c = bounds + (size_t)s * NCOLS;
  const bool ok = c[NCOLS - 1] != 0;
  Lane<kAll> o(pl, stage);
  F f(c);
  f.pre(sp, sg, n);      // PCM's rates run on every lane, as in JAX
  // every lane of the block walks the same train, so the warp meets at
  // the top of each step
  const size_t lane0 = lane - t;
  uint8_t* stage0 = stage - (size_t)t * SB;
  for (int i = 0; i < n; ++i) {
    if constexpr (!kAll)
      warp_moved(f, o, ok, alive, pl, lane0, stage0, SB);
    if (ok) f.step(sp[i], sg[i], i == n - 1, o);
  }
  if (ok) f.end(o);
  if constexpr (!kAll) warp_moved(f, o, ok, alive, pl, lane0, stage0, SB);
  // each lane's staged events and zeros for the events after them
  __syncwarp(alive);
  for (unsigned m = alive; m; m &= m - 1) {
    const int L = __ffs(m) - 1;
    warp_put(pl, lane0 + L, stage0 + (size_t)L * SB,
             kAll ? 0 : __shfl_sync(alive, o.sev, L), kAll ? E : 1, E,
             false, alive);
  }
  n_events[lane] = f.ev;
  ovf[lane] = f.ovf ? 1 : 0;
}

// the launch plan comes from ops/slice.py launch_plan: `lanes` specs of one
// train per block (a multiple of 32), every event staged or one, a stage
// of SB bytes per lane after the train's pulses and gaps, smem bytes in
// all
template <class F>
cudaError_t launch(const int* pulse, const int* gap, const int* n_pulses,
                   int B, int N, const int* bounds, int S, int E, int R,
                   int BY, int lanes, int every, int SB, int smem,
                   uint8_t* bytes, int* bpr, int* syncs, int* nrows,
                   int* n_events, uint8_t* ovf, cudaStream_t st) {
  const int es = every ? E : 1, byp = (BY + 3) & ~3;
  if (lanes < 32 || lanes > 1024 || lanes % 32 || SB % 16 ||
      SB < round16(es * R * byp) + round16(8 * es * R) + round16(4 * es) ||
      (long)smem < round16(8 * N) + (long)min(S, lanes) * SB)
    return cudaErrorInvalidValue;
  auto kern = every ? slice_lanes<F, true> : slice_lanes<F, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + lanes - 1) / lanes, B);
  kern<<<grid, lanes, smem, st>>>(pulse, gap, n_pulses, N, bounds, S, E, R,
                                  BY, SB, bytes, bpr, syncs, nrows, n_events,
                                  ovf);
  return cudaGetLastError();
}

// ---- the groups: a thread group per lane -------------------------------

constexpr unsigned kFull = 0xffffffffu;
// MC's pieces also end at a pulse or gap over 1.5 short widths where every
// width of the train is below kTame and the short width below kShortMax:
// tsl then never goes negative and its sums stay far from int32 overflow
constexpr unsigned kTame = 1u << 28;
constexpr int kShortMax = 1 << 26;

// the highest set bit of m != 0
__device__ __forceinline__ int hibit(unsigned m) { return 31 - __clz(m); }
// the bits above bit a, a in [-1, 31]
__device__ __forceinline__ unsigned above(int a) {
  return a >= 31 ? 0u : ~0u << (a + 1);
}
// bit `pos` of a staged row as a bit of its 32-bit word: bytes hold the
// row's bits MSB first, a word holds four bytes little-endian
__device__ __forceinline__ unsigned pos_bit(int pos) {
  return 1u << (((pos >> 3) & 3) * 8 + 7 - (pos & 7));
}
// a cursor from a tile's ballots: the count of x's bits after the highest
// bit of r (the last reset), or `carry` plus all of x's bits where r is 0
// (r and x are already cut to the steps before the thread, or up to it)
__device__ __forceinline__ int since(unsigned r, unsigned x, int carry) {
  return r ? __popc(x & above(hibit(r))) : carry + __popc(x);
}
// whether the bit at the thread (le: its steps up to it) is the last of
// its row in the tile: no bit follows, or `starts` marks a step in
// (thread, next bit] from which on bits fall in a new row
__device__ __forceinline__ bool row_ends(unsigned bits, unsigned starts,
                                         unsigned le) {
  const unsigned nxt = bits & ~le;
  return !nxt || (starts & ~le & ((2u << (__ffs(nxt) - 1)) - 1));
}

// G threads of a warp that run one lane: thread t takes step base + t of
// each tile (a pulse, or for DMC and PIWM-DC a symbol). Every thread of
// the warp calls the collectives together (the groups of a CTA walk the
// same train, so their tiles line up).
template <int G>
struct Group {
  const int t;     // the thread in its group
  const int off;   // the group's first thread in its warp
  __device__ Group()
      : t(threadIdx.x & (G - 1)), off((threadIdx.x & 31) & ~(G - 1)) {}
  // the group's votes, bit k from thread k
  __device__ unsigned ballot(bool x) const {
    const unsigned v = __ballot_sync(kFull, x);
    return G == 32 ? v : (v >> off) & ((1u << G) - 1);
  }
  __device__ int from(int v, int k) const {
    return __shfl_sync(kFull, v, k, G);
  }
  __device__ unsigned from(unsigned v, int k) const {
    return __shfl_sync(kFull, v, k, G);
  }
  __device__ unsigned lt() const { return (1u << t) - 1; }
  __device__ unsigned le() const { return lt() | (1u << t); }
  // thread t ORs m into stage word `key` (< 0: none). The keys of a tile
  // never decrease with t, so equal keys are neighbours: a segmented
  // OR-scan gathers each word's bits into its last thread, which stores
  // them, one store per word
  __device__ void or_words(uint32_t* w, int key, uint32_t m) const {
    for (int d = 1; d < G; d <<= 1) {
      const uint32_t om = __shfl_up_sync(kFull, m, d, G);
      const int ok = __shfl_up_sync(kFull, key, d, G);
      if (t >= d && ok == key) m |= om;
    }
    const int nk = __shfl_down_sync(kFull, key, 1, G);
    if (key >= 0 && m && (t == G - 1 || nk != key)) w[key] |= m;
  }
  // the inclusive sum of v over threads [h, t], h the last thread up to t
  // whose `head` is set (0 where none is): shuffle-up rounds that stop
  // adding at a head
  __device__ int seg_scan(int v, bool head) const {
    for (int d = 1; d < G; d <<= 1) {
      const int ov = __shfl_up_sync(kFull, v, d, G);
      const bool oh = __shfl_up_sync(kFull, (int)head, d, G) != 0;
      if (t >= d) {
        if (!head) v += ov;
        head = head || oh;
      }
    }
    return v;
  }
};

// A group's stage: every event of its lane, laid out as Planes says.
struct Stage {
  const Planes& pl;
  uint8_t* st;
  int E, R, BITS, WPR;
  __device__ Stage(const Planes& p, uint8_t* s)
      : pl(p), st(s), E(p.E), R(p.R), BITS(8 * p.BY), WPR(p.BYP / 4) {}
  __device__ void clear(int t, int nt) {
    uint4* s4 = reinterpret_cast<uint4*>(st);
    for (int i = t; i < pl.stage_words() / 4; i += nt)
      s4[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ uint32_t* words() const {
    return reinterpret_cast<uint32_t*>(st);
  }
  __device__ int& nbits(int ev, int r) const {
    return reinterpret_cast<int*>(st + pl.ob)[ev * R + r];
  }
  __device__ int& nsync(int ev, int r) const {
    return reinterpret_cast<int*>(st + pl.os)[ev * R + r];
  }
  __device__ int& nrow(int ev) const {
    return reinterpret_cast<int*>(st + pl.on)[ev];
  }
  __device__ bool in(int ev, int r) const {
    return ev >= 0 && ev < E && r >= 0 && r < R;
  }
  // the word of bit `pos` of row r of event ev; -1 outside the caps
  __device__ int word(int ev, int r, int pos) const {
    return in(ev, r) && pos >= 0 && pos < BITS
               ? (ev * R + r) * WPR + (pos >> 5) : -1;
  }
  // bits [start, start + len) of row r of event ev set, clipped at BITS
  // (ev, r inside the caps): an atomic OR per word, as the runs of the
  // neighbouring threads may share a run's first and last word
  __device__ void or_run(int ev, int r, int start, int len) {
    const int a = max(start, 0), b = min(start + len, BITS);
    uint32_t* w = words() + (ev * R + r) * WPR;
    for (int k = a >> 5; a < b && k <= (b - 1) >> 5; ++k)
      atomicOr(&w[k], run_word(a - 32 * k, b - 32 * k));
  }
};

// What a group family leaves out unless it says otherwise: it steps over
// pulses, does nothing at a lane's start and end, and runs every tile.
// A family with kStops runs a tile only while running() holds for a lane
// of its CTA.
struct GroupFamily {
  static constexpr bool kSymbols = false;
  static constexpr bool kStops = false;
  template <int G>
  __device__ void begin(const Group<G>&, Stage&, bool) {}
  template <int G>
  __device__ void end(const Group<G>&, Stage&) {}
  __device__ bool running() const { return true; }
};

// MC (JAX slice_mc): per step a resync 1 (c1_out) or mid-bit 1 (c1_mid) at
// the cursor, a row break with its leading 0 (out), a mid-bit 0 (c3), and
// at a flush the next event's leading 0. Only c1_mid and c3 read state,
// tsl; the cursors count emissions since a reset (bir restarts at 1 after
// out and flush, row at 0 after a flush).
struct McLanes : GroupFamily {
  int sh, rst, tol;
  bool has_tol, vf;
  int ev = 0, row = 0, bir = 1, tsl = 0;
  bool gf = true;   // tsl was reset by the last gap (a piece starts)
  bool ovf = false;
  __device__ McLanes(const int* c, bool tame)
      : sh(c[0]), rst(c[1]), tol(c[2]), has_tol(c[3] != 0),
        vf(tame && c[0] >= 0 && c[0] < kShortMax) {}
  // every buffer starts with a hardcoded 0 bit: event 0's here
  template <int G>
  __device__ void begin(const Group<G>& gr, Stage& s, bool ok) {
    if (ok && gr.t == 0) s.nbits(0, 0) = 1;
  }
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    const unsigned ACT = nact >= 32 ? ~0u : (1u << nact) - 1;
    // 1. what no state decides
    const bool out = act && has_tol && (p < sh - tol || p > 2 * sh + tol ||
                                        g < sh - tol || g > 2 * sh + tol);
    const bool c1o = out && 2 * p > 3 * sh && p <= 2 * sh + tol;
    const bool fl = act && (g > rst || base + t == n - 1);
    const bool pf = out || (vf && 2 * p > 3 * sh);   // tsl 0 after the pulse
    const bool gfo = fl || (vf && 2 * g > 3 * sh);   // and after the gap
    const unsigned OUT = gr.ballot(out), FL = gr.ballot(fl);
    const unsigned GF = gr.ballot(act && gfo);
    const bool start = act && (pf || (t ? ((GF >> (t - 1)) & 1) != 0 : gf));
    // thread 0 walks the piece the last tile left open, if no piece starts
    const unsigned ST = gr.ballot(start) | 1u;
    // 2. tsl, walked over each piece by the thread at its start
    int ts = start ? 0 : tsl;
    unsigned m1 = 0, m3 = 0;
    if (act && ((ST >> t) & 1)) {
      const unsigned nx = ST & ~le & ACT;
      const int e = nx ? __ffs(nx) - 1 : nact;
      for (int j = t; j < e; ++j) {
        const bool oj = (OUT >> j) & 1, fj = (FL >> j) & 1;
        const int a = ts + sp[base + j];
        const bool x1 = !oj && 2 * a > 3 * sh;
        const int b = ((oj || x1) ? 0 : a) + sg[base + j];
        const bool x3 = !fj && 2 * b > 3 * sh;
        ts = (fj || x3) ? 0 : b;
        m1 |= (unsigned)x1 << j;
        m3 |= (unsigned)x3 << j;
      }
    }
    __syncwarp();
    const int src = hibit(ST & le);
    const unsigned M1 = gr.from(m1, src), M3 = gr.from(m3, src);
    const int ts_end = gr.from(ts, hibit(ST & (ACT | 1u)));
    const bool c3 = act && ((M3 >> t) & 1);
    const bool c1 = c1o || (act && ((M1 >> t) & 1));
    // 3. the cursors before this step: since the last flush (row), the
    // last out or flush (bir; a c3 at an out counts after it)
    const unsigned C1 = gr.ballot(c1), C3 = gr.ballot(c3);
    const unsigned fb = FL & lt, rb = (OUT | FL) & lt;
    const int e_ = ev + __popc(fb);
    const int r_ = fb ? __popc(OUT & lt & above(hibit(fb)))
                      : row + __popc(OUT & lt);
    int b_;
    if (rb) {
      const int r0 = hibit(rb);
      b_ = 1 + __popc(C1 & lt & above(r0)) +
           __popc(C3 & lt & ~((1u << r0) - 1));
    } else {
      b_ = bir + __popc(C1 & lt) + __popc(C3 & lt);
    }
    const int row2 = r_ + out, bir2 = b_ + c1, bir3 = out ? 1 : bir2;
    const int bir4 = bir3 + c3;
    const unsigned o = gr.ballot(act && (row2 >= s.R || bir4 > s.BITS ||
                                         bir2 > s.BITS ||
                                         (fl && e_ + 1 >= s.E)));
    ovf = ovf || o;
    // 4. the stage: a row's count is its last position + 1, written by
    // the step that closes it (an out, a flush) or ends the tile; the
    // leading 0 of the next event first, as a later step may count on
    if (fl && e_ + 1 < s.E) s.nbits(e_ + 1, 0) = 1;
    __syncwarp();
    if (out && s.in(e_, r_)) s.nbits(e_, r_) = bir2;
    if (act && (fl || t == nact - 1) && s.in(e_, row2))
      s.nbits(e_, row2) = bir4;
    if (fl && e_ < s.E) s.nrow(e_) = row2 + 1;
    gr.or_words(s.words(), act ? s.word(e_, r_, b_) : -1,
                c1 ? pos_bit(b_) : 0u);
    // the cursors after the tile's last step
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fl, k), nr = gr.from(fl ? 0 : row2, k);
    const int nb = gr.from(fl ? 1 : bir4, k);
    if (nact) {
      ev = ne; row = nr; bir = nb; tsl = ts_end;
      gf = (GF >> k) & 1;
    }
  }
};

// PWM (JAX slice_pwm): a pulse is a 1, a 0, a sync, spurious or a row
// break (isrb) by its width alone; a gap over the reset limit (or the last
// pulse) is a flush candidate, one over the gap limit a break candidate.
// A candidate flushes where the event was touched since the previous
// candidate (a candidate leaves the event untouched either way); bir
// restarts at 0 after every candidate, sync and isrb (where no flush or
// break happens there, it is 0 already), row at 0 after a flush.
struct PwmLanes : GroupFamily {
  int ol, ou, zl, zu, syl, syu, gp, rst;
  int ev = 0, row = 0, bir = 0;
  bool tch = false, ovf = false;
  __device__ PwmLanes(const int* c, bool)
      : ol(c[0]), ou(c[1]), zl(c[2]), zu(c[3]), syl(c[4]), syu(c[5]),
        gp(c[6]), rst(c[7]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    // 1. what no state decides
    const bool is1 = act && ol < p && p < ou;
    const bool is0 = act && !is1 && zl < p && p < zu;
    const bool issy = act && !is1 && !is0 && syl < p && p < syu;
    const bool isrb = act && !is1 && !is0 && !issy && p > ol;
    const bool isbit = is1 || is0;
    const bool cf = act && (g > rst || base + t == n - 1);
    const bool cb = act && gp > 0 && g > gp;
    // 3. the cursors before this step
    const unsigned TM = gr.ballot(isbit || issy || isrb), CF = gr.ballot(cf);
    const unsigned pc = CF & lt;
    const bool touched = pc ? (TM & le & above(hibit(pc))) != 0
                            : tch || (TM & le) != 0;
    const bool fl = cf && touched;
    const unsigned FL = gr.ballot(fl), BIT = gr.ballot(isbit);
    const unsigned RS = gr.ballot(issy || isrb || cf || cb);
    const unsigned fb = FL & lt, rr = RS & lt;
    const int e_ = ev + __popc(fb);
    const int birb = rr ? __popc(BIT & lt & above(hibit(rr)))
                        : bir + __popc(BIT & lt);
    const int bir2 = (issy || isrb) ? 0 : birb;
    const int bir3 = bir2 + isbit;
    const bool up = (issy && birb > 0) || isrb;   // a new row before the bit
    const bool brk = cb && !fl && bir3 > 0;       // and after it
    const unsigned UP = gr.ballot(up), BRK = gr.ballot(brk);
    const unsigned win = fb ? lt & above(hibit(fb)) : lt;
    const int row2 = (fb ? 0 : row) + __popc(UP & win) + __popc(BRK & win) +
                     up;
    const unsigned o = gr.ballot(act && (e_ + fl >= s.E ||
                                         row2 + brk >= s.R ||
                                         bir3 >= s.BITS));
    ovf = ovf || o;
    // 4. the stage: a row's count written by its last bit in the tile (the
    // next bit lies past a flush, break or new row, or there is none)
    if (fl && e_ < s.E) s.nrow(e_) = row2 + 1;
    if (issy && s.in(e_, row2)) atomicAdd(&s.nsync(e_, row2), 1);
    if (isbit && s.in(e_, row2)) {
      const unsigned nxt = BIT & ~le;
      const unsigned ch = (((FL | BRK) << 1) | UP) & ~le;
      if (!nxt || (ch & ((2u << (__ffs(nxt) - 1)) - 1)))
        s.nbits(e_, row2) = bir3;
    }
    gr.or_words(s.words(), act ? s.word(e_, row2, bir2) : -1,
                is1 ? pos_bit(bir2) : 0u);
    // the cursors after the tile's last step
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fl, k);
    const int nr = gr.from(fl ? 0 : row2 + brk, k);
    const int nb = gr.from((cf || cb) ? 0 : bir3, k);
    const int nt = gr.from((int)(!cf && touched), k);
    if (nact) {
      ev = ne; row = nr; bir = nb;
      tch = nt != 0;
    }
  }
};

// PPM (JAX slice_ppm), a gap per thread: a gap is a 0, a 1, a sync or a
// row break (below the reset limit, in no window) by its width alone, and
// a flush candidate at or over the reset limit or at the last pulse. A
// candidate flushes where the event was touched (a bit or a row break)
// since the previous candidate, this gap included; one that does not
// flush finds every cursor at zero, as a flush leaves them, so row counts
// the new rows since the last candidate (a row break; a sync after a bit)
// and bir the bits since the last sync, row break or candidate. Within a
// gap JAX's order holds: the sync or row break, then the bit, then the
// flush; a sync at bir 0 counts on the current row.
struct PpmLanes : GroupFamily {
  int zl, zu, ol, ou, syl, syu, rst;
  int ev = 0, row = 0, bir = 0;
  bool tch = false, ovf = false;
  __device__ PpmLanes(const int* c, bool)
      : zl(c[0]), zu(c[1]), ol(c[2]), ou(c[3]), syl(c[4]), syu(c[5]),
        rst(c[6]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int*,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    // 1. what no state decides
    const bool is0 = act && zl < g && g < zu;
    const bool is1 = act && !is0 && ol < g && g < ou;
    const bool issy = act && !is0 && !is1 && syl < g && g < syu;
    const bool isrb = act && !is0 && !is1 && !issy && g < rst;
    const bool isbit = is0 || is1;
    const bool cf = act && (g >= rst || base + t == n - 1);
    // 3. the cursors before this gap (touched up to and with it)
    const unsigned BIT = gr.ballot(isbit), CF = gr.ballot(cf) & lt;
    const bool touched = since(CF, gr.ballot(isbit || isrb) & le, tch) > 0;
    const bool fl = cf && touched;
    const int birb = since(gr.ballot(issy || isrb || cf) & lt, BIT & lt, bir);
    const bool up = (issy && birb > 0) || isrb;   // a new row before the bit
    const unsigned UP = gr.ballot(up), FL = gr.ballot(fl);
    const int e_ = ev + __popc(FL & lt);
    const int row2 = since(CF, UP & lt, row) + up;
    const int bir2 = (issy || isrb) ? 0 : birb, bir3 = bir2 + isbit;
    const unsigned o = gr.ballot(act && (e_ + fl >= s.E || row2 >= s.R ||
                                         bir3 >= s.BITS));
    ovf = ovf || o;
    // 4. the stage: a row's count written by its last bit in the tile (the
    // next bit lies past a flush or a new row, or there is none)
    if (fl && e_ < s.E) s.nrow(e_) = row2 + 1;
    if (issy && s.in(e_, row2)) atomicAdd(&s.nsync(e_, row2), 1);
    if (isbit && s.in(e_, row2) && row_ends(BIT, (FL << 1) | UP, le))
      s.nbits(e_, row2) = bir3;
    gr.or_words(s.words(), act ? s.word(e_, row2, bir2) : -1,
                is1 ? pos_bit(bir2) : 0u);
    // the cursors after the tile's last gap
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fl, k), nr = gr.from(cf ? 0 : row2, k);
    const int nb = gr.from(cf ? 0 : bir3, k);
    const int nt = gr.from((int)(!cf && touched), k);
    if (nact) {
      ev = ne; row = nr; bir = nb;
      tch = nt != 0;
    }
  }
};

// a symbol of the interleaved pulse/gap axis: 2k is pulse k, 2k + 1 gap k
__device__ __forceinline__ int symbol(const int* sp, const int* sg, int i) {
  return (i & 1) ? sg[i >> 1] : sp[i >> 1];
}

// DMC (JAX slice_dmc) over the symbol axis, a symbol per thread. The
// pending flag is the one value that carries across symbols, and it has a
// closed form: a pending symbol that falls through (mistimed, at a reset)
// is never in_short, so every resolution but a 1 clears the flag and
// pend' = in_short & !pend; pend is the parity of the run of in_short
// symbols that ends just before the symbol, XORed with the carried flag
// where the run reaches the tile's start. What pend decides: a 1 (in_short
// and not pending), a 0, a flush candidate (a normal symbol in neither
// class, at a reset), a break candidate (a pending mistimed symbol below
// the reset). Bits and candidates are distinct symbols. A flush candidate
// flushes where a bit fell since the previous one (has); a break candidate
// breaks where a bit fell since the previous candidate of either kind
// (bir > 0). So bir restarts at 0 after every candidate (one that neither
// flushes nor breaks finds it 0 already), row after a flush.
struct DmcLanes : GroupFamily {
  static constexpr bool kSymbols = true;
  int sh, lo, rst, tol;
  int ev = 0, row = 0, bir = 0;
  bool pend = false, has = false, ovf = false;
  __device__ DmcLanes(const int* c, bool)
      : sh(c[0]), lo(c[1]), rst(c[2]), tol(c[3]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int) {
    const int t = gr.t;
    const bool act = t < nact;
    const int y = act ? symbol(sp, sg, base + t) : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    // 1. what no state decides
    const int d_short = abs(y - sh);
    const bool in_short = act && d_short < tol;
    const bool in_long = act && abs(y - lo) < tol;
    const bool is_rst = y >= rst - tol;
    const bool mist = d_short > tol;
    // 2. the pending flag, from the run of in_short symbols before t
    const unsigned nis = ~gr.ballot(in_short) & lt;
    const bool pd = nis ? ((t - 1 - hibit(nis)) & 1) != 0
                        : ((t & 1) != 0) != pend;
    // 3. what it decides, and the cursors before this symbol
    const bool norm = act && (!pd || (mist && is_rst));
    const bool one = in_short && !pd;
    const bool isbit = one || (norm && !in_short && in_long);
    const bool fc = norm && !in_short && !in_long && is_rst;
    const bool bc = act && pd && mist && !is_rst;
    const unsigned BIT = gr.ballot(isbit), FC = gr.ballot(fc);
    const bool hs = since(FC & lt, BIT & lt, has) > 0;
    const bool fl = fc && hs;
    const int birb = since((FC | gr.ballot(bc)) & lt, BIT & lt, bir);
    const bool brk = bc && birb > 0;
    const unsigned FL = gr.ballot(fl), BRK = gr.ballot(brk);
    const int e_ = ev + __popc(FL & lt);
    const int r_ = since(FL & lt, BRK & lt, row);
    const int bir2 = birb + isbit;
    const unsigned o = gr.ballot(act && (r_ + brk >= s.R || bir2 > s.BITS ||
                                         (fl && e_ + 1 >= s.E)));
    ovf = ovf || o;
    // 4. the stage: a row's count written by its last bit in the tile (the
    // next bit lies past a flush or a break, or there is none)
    if (fl && e_ < s.E) s.nrow(e_) = r_ + 1;
    if (isbit && s.in(e_, r_) && row_ends(BIT, FL | BRK, le))
      s.nbits(e_, r_) = bir2;
    gr.or_words(s.words(), act ? s.word(e_, r_, birb) : -1,
                one ? pos_bit(birb) : 0u);
    // the cursors and the flags after the tile's last symbol
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fl, k), nr = gr.from(fl ? 0 : r_ + brk, k);
    const int nb = gr.from((fc || bc) ? 0 : bir2, k);
    const int nh = gr.from((int)(!fc && (hs || isbit)), k);
    const int np = gr.from((int)one, k);
    if (nact) {
      ev = ne; row = nr; bir = nb;
      has = nh != 0;
      pend = np != 0;
    }
  }
};

// PIWM-DC (JAX slice_piwm_dc) over the symbol axis, a symbol per thread: a
// symbol in the short class is a 1, in the long class a 0; a flush
// candidate (over the reset limit, or the last symbol) flushes where a bit
// fell since the previous one, this symbol's included (touched); a non-bit
// symbol below the reset limit is a break candidate and breaks where a bit
// fell since the previous candidate of either kind (bir > 0; bir > 0
// implies touched). Within one symbol JAX's order holds: the bit, the
// break, then the flush, whose event keeps the row the break opened.
struct PiwmDcLanes : GroupFamily {
  static constexpr bool kSymbols = true;
  int sh, lo, rst, tol;
  int ev = 0, row = 0, bir = 0;
  bool tch = false, ovf = false;
  __device__ PiwmDcLanes(const int* c, bool)
      : sh(c[0]), lo(c[1]), rst(c[2]), tol(c[3]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int y = act ? symbol(sp, sg, base + t) : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    // 1. what no state decides
    const bool in1 = act && abs(y - sh) < tol;
    const bool isbit = in1 || (act && abs(y - lo) < tol);
    const bool rbc = act && !isbit && y < rst;
    const bool cf = act && (y > rst || base + t == n - 1);
    // 3. the cursors before this symbol (touched up to and with it)
    const unsigned BIT = gr.ballot(isbit), CF = gr.ballot(cf);
    const bool touched = since(CF & lt, BIT & le, tch) > 0;
    const bool fl = cf && touched;
    const int birb = since((CF | gr.ballot(rbc)) & lt, BIT & lt, bir);
    const bool brk = rbc && birb > 0;
    const unsigned FL = gr.ballot(fl), BRK = gr.ballot(brk);
    const int e_ = ev + __popc(FL & lt);
    const int r_ = since(FL & lt, BRK & lt, row);
    const int row2 = r_ + brk, bir2 = birb + isbit;
    const unsigned o = gr.ballot(act && (row2 >= s.R || bir2 > s.BITS ||
                                         (fl && e_ + 1 >= s.E)));
    ovf = ovf || o;
    // 4. the stage: a row's count written by its last bit in the tile (the
    // next bit lies past a flush, this symbol's included, or a break)
    if (fl && e_ < s.E) s.nrow(e_) = row2 + 1;
    if (isbit && s.in(e_, r_) && row_ends(BIT, (FL << 1) | BRK, le))
      s.nbits(e_, r_) = bir2;
    gr.or_words(s.words(), act ? s.word(e_, r_, birb) : -1,
                in1 ? pos_bit(birb) : 0u);
    // the cursors after the tile's last symbol
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fl, k), nr = gr.from(fl ? 0 : row2, k);
    const int nb = gr.from((cf || rbc) ? 0 : bir2, k);
    const int nt = gr.from((int)(!cf && touched), k);
    if (nact) {
      ev = ne; row = nr; bir = nb;
      tch = nt != 0;
    }
  }
};

// RZI (JAX slice_rzi), a pulse per thread: each pulse emits its ones (a
// division of its width by the long width, with the base offset where the
// pulse does not open a message: where the pulse before was no flush
// candidate), then a 0 unless its gap is a flush candidate (over the reset
// limit, or the last pulse). A candidate flushes where the event holds a
// bit; one that does not finds the cursor at 0, as a flush leaves it. So
// nothing but the cursor carries, and a step adds ones + 0 bits to it:
// the cursor before a pulse is a segmented scan of those counts since the
// last candidate (the carried cursor where none falls before it in the
// tile). Each event has one row.
struct RziLanes : GroupFamily {
  int lo, rst, off;   // off: the base offset
  int ev = 0, bir = 0;
  bool at_start = true, ovf = false;
  __device__ RziLanes(const int* c, bool) : lo(c[0]), rst(c[1]), off(c[2]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt();
    // 1. what no state decides
    const bool fc = act && (g > rst || base + t == n - 1);
    const unsigned FC = gr.ballot(fc);
    const bool opens = t ? ((FC >> (t - 1)) & 1) != 0 : at_start;
    const int num = opens ? p + lo / 2 : p - off + lo / 2;
    // floor and truncation agree once the result is clamped at 0
    const int ones = act ? max(num / max(lo, 1), 0) : 0;
    const int d = ones + (act && !fc);
    // 3. the cursor before this pulse, and the flush
    const int b_ = gr.seg_scan(d, t && opens) - d + ((FC & lt) ? 0 : bir);
    const bool emitted = fc && b_ + ones > 0;
    const int e_ = ev + __popc(gr.ballot(emitted) & lt);
    const int bir2 = b_ + d;
    const unsigned o = gr.ballot(act && (bir2 > s.BITS ||
                                         (emitted && e_ + 1 >= s.E)));
    ovf = ovf || o;
    // 4. the stage: the run of ones, the event's bit count by its last
    // pulse in the tile (0 at a candidate that does not flush, as is
    // everything it counted), its row at the flush
    if (ones > 0 && e_ < s.E) s.or_run(e_, 0, b_, ones);
    if (act && e_ < s.E && (emitted || t == nact - 1)) s.nbits(e_, 0) = bir2;
    if (emitted && e_ < s.E) s.nrow(e_) = 1;
    // the cursors after the tile's last pulse
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + emitted, k), nb = gr.from(fc ? 0 : bir2, k);
    if (nact) {
      ev = ne; bir = nb;
      at_start = (FC >> k) & 1;
    }
  }
};

// OSV1's preamble: pulses 0 to kPreamble - 1, the sync the next
constexpr int kPreamble = 12;

// OSV1 (JAX slice_osv1), a pulse per thread. Its phase machine has a
// closed form: phase 0 leads to phase 1 only where pulses 0-10 pass with
// a gap of at most hmax and pulse 11 passes with a longer one, so phase 1
// is pulse 12, the sync, which passes into phase 2 (with a 0 and the
// Manchester bit 1 where its gap is the longer) or ends the lane. Phase 2
// runs from pulse 13 up to and with the first flush candidate (the event
// is always touched there). The Manchester bit before a phase-2 pulse is
// its start value XOR the parity of the earlier phase-2 pulses whose pulse
// and gap disagree on being over hmax, from one ballot. The cursor only
// grows; every 1 lands in row 0 of event 0, the JAX scatter-add clipping
// its position to the row's last bit: the ones below that bit are ORed,
// the rest counted and added to the row's last byte once, modulo 256. A
// CTA stops once every lane of it has left phases 0-2.
struct Osv1Lanes : GroupFamily {
  static constexpr bool kStops = true;
  int rst, hmin, hmax, sync_min;
  // the phase before the tile: 0, 2 or 3 (done); phase 1 is pulse 12
  // alone, in the tile of pulse 11 (12 is no multiple of G), or past the
  // train's end
  int ph = 0;
  int m = 0, bir = 0, clip = 0, ev = 0;
  bool ovf = false;
  // the JAX floor divisions: sh // 2, sh * 3 // 2
  __device__ Osv1Lanes(const int* c, bool)
      : rst(c[1]), hmin(c[0] >> 1), hmax((3 * c[0]) >> 1),
        sync_min(2 * hmax) {}
  template <int G>
  __device__ void begin(const Group<G>&, Stage&, bool ok) {
    if (!ok) ph = 3;
  }
  __device__ bool running() const { return ph < 3; }
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt();
    const unsigned ACT = nact >= 32 ? ~0u : (1u << nact) - 1;
    // 1. the preamble (phase 0 lasts at most to pulse 11, so base <= 11)
    const bool pass0 = act && p > hmin && g > hmin;
    const unsigned ON = gr.ballot(pass0 && g <= hmax);
    const unsigned BRK = gr.ballot(pass0 && g > hmax);
    int sy = -1;   // the sync's thread in this tile
    if (ph == 0) {
      const int k = kPreamble - 1 - base;   // pulse 11's thread
      if (k < nact) {
        const unsigned need = (1u << k) - 1;
        ph = (ON & need) == need && ((BRK >> k) & 1) ? 1 : 3;
        if (ph == 1 && k + 1 < nact) sy = k + 1;
      } else if ((ON & ACT) != ACT) {
        ph = 3;
      }
    }
    // 2. the sync
    const int ps = gr.from(p, max(sy, 0)), gs = gr.from(g, max(sy, 0));
    int s2 = ph == 2 ? 0 : G;   // phase 2's first thread in this tile
    if (sy >= 0) {
      if (ps >= sync_min && gs >= sync_min) {
        ph = 2;
        m = bir = gs > ps;
        s2 = sy + 1;
      } else {
        ph = 3;
      }
    }
    // 3. phase 2 up to and with its first flush candidate: the Manchester
    // bit, the bits and the cursor before this pulse
    const unsigned P2a = ph == 2 && s2 < G ? ACT & ~((1u << s2) - 1) : 0u;
    const bool fc = act && (g > rst || base + t == n - 1);
    const unsigned FC = gr.ballot(fc) & P2a;
    const unsigned P2 = FC ? P2a & ((2u << (__ffs(FC) - 1)) - 1) : P2a;
    const bool in2 = (P2 >> t) & 1;
    const bool fl = in2 && fc;
    const bool phit = p > hmax, ghit = g > hmax;
    const unsigned X = gr.ballot(in2 && phit != ghit);
    const int mt = m ^ (__popc(X & lt) & 1);
    const bool c1 = in2 && (phit || mt == 0);
    const int mp = phit ? mt : 1 - mt;
    const bool c0 = in2 && !fl && (ghit || mp == 0);
    const unsigned C1 = gr.ballot(c1), C0 = gr.ballot(c0);
    const int pos = bir + __popc(C1 & lt) + __popc(C0 & lt);
    // 4. the stage: a 1 below the row's last bit ORed, the others counted
    gr.or_words(s.words(), in2 && pos < s.BITS - 1 ? pos >> 5 : -1,
                c1 ? pos_bit(pos) : 0u);
    clip += __popc(gr.ballot(c1 && pos >= s.BITS - 1));
    bir += __popc(C1) + __popc(C0);
    m ^= __popc(X) & 1;
    if (FC) {
      ph = 3;
      ev = 1;
    }
    ovf = bir > s.BITS;
  }
  // after the group's last tile (the stage's ORs visible): row 0 of event
  // 0, its bit count, num_rows, and the clipped ones added to its last byte
  template <int G>
  __device__ void end(const Group<G>& gr, Stage& s) {
    if (gr.t) return;
    s.nbits(0, 0) = bir;
    s.nrow(0) = ev;
    s.st[s.pl.BY - 1] += (uint8_t)clip;
  }
};

template <class F, int G>
__global__ void __launch_bounds__(128)
slice_groups(const int* __restrict__ pulse, const int* __restrict__ gap,
             const int* __restrict__ n_pulses, int N,
             const int* __restrict__ bounds, int S, int E, int R, int BY,
             int SB, uint8_t* bytes, int* bpr, int* syncs, int* nrows,
             int* n_events, uint8_t* ovf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sp = reinterpret_cast<int*>(smem);
  int* sg = sp + N;
  const int b = blockIdx.y;
  const int n = min(max(n_pulses[b], 0), N);
  const int* pb = pulse + (size_t)b * N;
  const int* gb = gap + (size_t)b * N;
  bool tame = true;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = pb[i], g = gb[i];
    sp[i] = p;
    sg[i] = g;
    tame = tame && (unsigned)p < kTame && (unsigned)g < kTame;
  }
  tame = __syncthreads_and(tame) != 0;
  const Group<G> gr;
  const int s = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = s < S;
  const Planes pl(bytes, bpr, syncs, nrows, E, R, BY, E);
  Stage st(pl, smem + round16(8 * N) + (size_t)(threadIdx.x / G) * SB);
  st.clear(gr.t, G);
  const int* c = bounds + (size_t)(live ? s : 0) * NCOLS;
  const bool ok = live && c[NCOLS - 1] != 0;
  F f(c, tame);
  __syncwarp();
  f.begin(gr, st, ok);
  __syncwarp();
  // every group of the CTA runs the same tiles: the collectives line up;
  // a family that stops leaves once no lane of the CTA runs (one vote a
  // tile)
  const int steps = F::kSymbols ? 2 * n : n;
  for (int base = 0; base < steps; base += G) {
    if constexpr (F::kStops) {
      if (!__syncthreads_or(f.running())) break;
    }
    f.tile(gr, st, sp, sg, base, ok ? min(G, steps - base) : 0, steps);
    __syncwarp();
  }
  f.end(gr, st);
  __syncwarp();
  if (!live) return;
  const size_t lane = (size_t)b * S + s;
  put_events(pl, lane, st.st, 0, E, E, false, gr.t, G, 0u);
  if (gr.t == 0) {
    n_events[lane] = f.ev;
    ovf[lane] = f.ovf ? 1 : 0;
  }
}

// the groups' launch from ops/slice.py launch_plan: `lanes` specs of one
// train per block, G threads each (lanes * G a multiple of 32, at most
// 128), a stage of SB bytes per lane (every event) after the train's
// pulses and gaps, smem bytes in all
template <class F>
cudaError_t launch_groups(const int* pulse, const int* gap,
                          const int* n_pulses, int B, int N,
                          const int* bounds, int S, int E, int R, int BY,
                          int lanes, int G, int SB, int smem, uint8_t* bytes,
                          int* bpr, int* syncs, int* nrows, int* n_events,
                          uint8_t* ovf, cudaStream_t st) {
  const int byp = (BY + 3) & ~3, threads = lanes * G;
  if ((G != 8 && G != 16 && G != 32) || lanes < 1 || threads % 32 ||
      threads > 128 || SB % 16 ||
      SB < round16(E * R * byp) + round16(8 * E * R) + round16(4 * E) ||
      (long)smem < round16(8 * N) + (long)lanes * SB)
    return cudaErrorInvalidValue;
  auto kern = G == 8    ? slice_groups<F, 8>
              : G == 16 ? slice_groups<F, 16>
                        : slice_groups<F, 32>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + lanes - 1) / lanes, B);
  kern<<<grid, threads, smem, st>>>(pulse, gap, n_pulses, N, bounds, S, E, R,
                                    BY, SB, bytes, bpr, syncs, nrows,
                                    n_events, ovf);
  return cudaGetLastError();
}

}  // namespace

// bounds is the family's int32 [S, NCOLS] table (ops/slice.py
// bound_table): its columns from 0 in the family's order, ok in the last.
// lanes, mode, SB and smem: ops/slice.py launch_plan; mode is whether
// every event is staged for the walk (PCM, NRZS), the threads per lane (8,
// 16 or 32) for the groups (the other seven). Every element of the six
// outputs is written.
extern "C" int rtl433_slice(int family, const void* pulse, const void* gap,
                            const void* n_pulses, int B, int N,
                            const void* bounds, int S, int E, int R, int BY,
                            int lanes, int mode, int SB, int smem,
                            void* bytes, void* bpr, void* syncs, void* nrows,
                            void* n_events, void* ovf, void* stream) {
  auto P = (const int*)pulse;
  auto G = (const int*)gap;
  auto NP = (const int*)n_pulses;
  auto BD = (const int*)bounds;
  auto BYT = (uint8_t*)bytes;
  auto BPR = (int*)bpr;
  auto SY = (int*)syncs;
  auto NR = (int*)nrows;
  auto NE = (int*)n_events;
  auto OV = (uint8_t*)ovf;
  auto st = (cudaStream_t)stream;
#define RTL433_SLICE(L, F)                                                   \
  return (int)L<F>(P, G, NP, B, N, BD, S, E, R, BY, lanes, mode, SB, smem, \
                   BYT, BPR, SY, NR, NE, OV, st)
  switch (family) {
    case 0: RTL433_SLICE(launch_groups, PpmLanes);
    case 1: RTL433_SLICE(launch_groups, PwmLanes);
    case 2: RTL433_SLICE(launch, Pcm);
    case 3: RTL433_SLICE(launch_groups, McLanes);
    case 4: RTL433_SLICE(launch_groups, DmcLanes);
    case 5: RTL433_SLICE(launch_groups, PiwmDcLanes);
    case 6: RTL433_SLICE(launch, Nrzs);
    case 7: RTL433_SLICE(launch_groups, RziLanes);
    case 8: RTL433_SLICE(launch_groups, Osv1Lanes);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTL433_SLICE
}
