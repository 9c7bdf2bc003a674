// Device slicing: one thread per (train, spec) lane runs one reference
// slicer's state machine over its train and writes the lane's bitbuffers.
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
// All outputs arrive zeroed. A write outside the caps (event >= E,
// row >= R, bit >= 8 * BY) is dropped, as the JAX scatters drop it.
//
// Design. A CTA covers one train (blockIdx.y) and up to blockDim.x specs
// of one family (blockIdx.x); it stages the train's n_pulses[b] pulse and
// gap values into shared memory once, and every thread then walks only
// that many steps (2 * n_pulses[b] symbols for DMC and PIWM-DC), reading
// the same shared word as all its neighbours (a broadcast). The spec's
// bounds sit in registers. A thread owns its lane's outputs and adds each
// bit straight into its own [E, R, BY] bytes, so nothing is scattered or
// reduced: single bits are added (the JAX scatter-add, equal to an or for
// distinct bits), runs of ones are or-ed (the JAX cumulative sum of +1/-1
// deltas). One template takes a per-family step function (nine
// instantiations); the bit writer, the row and event cursors and the
// overflow flag are shared (struct Lane).
//
// Float32 in PCM: the JAX scan and the plain version round each product
// and sum separately, so every float operation here is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __int2float_rn), which nvcc never contracts into an FMA; jnp.round is
// round-half-even (rintf). Built without --use_fast_math.
//
// Bound: integer work over B * S * n steps (a few tens of int32 ops per
// step) against the bytes of the output planes, of which the kernel writes
// only the bits it emits (the planes are zeroed by the wrapper). At a
// drain of the 4096-channel workload the planes are tens of MB and the
// steps a few hundred per lane, so the bytes bound it; this first version
// is one simple thread per lane, with byte-wide read-modify-writes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NCOLS = 12;     // ops/slice.py NCOLS

struct Lane {
  uint8_t* bytes;   // [E, R, BY] of this lane
  int* bpr;         // [E, R]
  int* syncs;       // [E, R]
  int* nrows;       // [E]
  int E, R, BY;

  __device__ bool in(int ev, int row) const {
    return ev >= 0 && ev < E && row >= 0 && row < R;
  }
  // one emitted bit: counted on its row, its value added to its byte
  __device__ void bit(int ev, int row, int bir, int val) {
    if (!in(ev, row)) return;
    bpr[ev * R + row] += 1;
    if (val && bir >= 0 && bir < 8 * BY)
      bytes[(ev * R + row) * BY + (bir >> 3)] +=
          (uint8_t)(0x80u >> (bir & 7));
  }
  __device__ void count(int ev, int row, int n) {
    if (in(ev, row)) bpr[ev * R + row] += n;
  }
  __device__ void sync(int ev, int row) {
    if (in(ev, row)) syncs[ev * R + row] += 1;
  }
  __device__ void rows(int ev, int n) {
    if (ev >= 0 && ev < E) nrows[ev] += n;
  }
  // bits [start, start + len) of a row set to one, clipped at 8 * BY
  __device__ void run(int ev, int row, int start, int len) {
    if (len <= 0 || !in(ev, row)) return;
    int end = min(start + len, 8 * BY);
    uint8_t* r = bytes + (ev * R + row) * BY;
    for (int k = max(start, 0); k < end; ++k)
      r[k >> 3] |= (uint8_t)(0x80u >> (k & 7));
  }
  // rows [0, last] of an event back to zero (bytes and bit counts)
  __device__ void erase(int ev, int last) {
    if (ev < 0 || ev >= E) return;
    for (int row = 0; row <= min(last, R - 1); ++row) {
      bpr[ev * R + row] = 0;
      uint8_t* r = bytes + (ev * R + row) * BY;
      for (int k = 0; k < BY; ++k) r[k] = 0;
    }
  }
};

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

// ---- the families: state, step, end ------------------------------------
//
// Each step is the JAX step of its family for one lane: the same
// comparisons in the same order, its emissions written where the JAX
// assembly scatters them. Each family also carries ev (events so far) and
// ovf.

struct Ppm {
  static constexpr bool kSymbols = false;
  int zl, zu, ol, ou, syl, syu, rst;
  int ev = 0, row = 0, bir = 0, frb = 0;
  bool ovf = false;
  __device__ explicit Ppm(const int* c)
      : zl(c[0]), zu(c[1]), ol(c[2]), ou(c[3]), syl(c[4]), syu(c[5]),
        rst(c[6]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int, int g, bool last, Lane& o) {
    bool is0 = zl < g && g < zu;
    bool is1 = !is0 && ol < g && g < ou;
    bool issy = !is0 && !is1 && syl < g && g < syu;
    bool isrb = !is0 && !is1 && !issy && g < rst;
    bool isbit = is0 || is1;
    int sy_row = bir > 0 ? row + 1 : row;
    int row2 = issy ? sy_row : row;
    int bir2 = (issy && bir > 0) ? 0 : bir;
    if (isrb) { row2 += 1; bir2 = 0; }
    if (isbit) o.bit(ev, row2, bir2, is1);
    if (issy) o.sync(ev, sy_row);
    int bir3 = isbit ? bir2 + 1 : bir2;
    int frb2 = (isbit && row2 == 0) ? frb + 1 : frb;
    bool flush = (g >= rst || last) && (frb2 > 0 || row2 > 0);
    if (flush) o.rows(ev, row2 + 1);
    int ev2 = flush ? ev + 1 : ev;
    ovf = ovf || ev2 >= o.E || row2 >= o.R || bir3 >= o.BY * 8;
    ev = ev2;
    row = flush ? 0 : row2;
    bir = flush ? 0 : bir3;
    frb = flush ? 0 : frb2;
  }
  __device__ void end(Lane&) {}
};

struct Pwm {
  static constexpr bool kSymbols = false;
  int ol, ou, zl, zu, syl, syu, gp, rst;
  int ev = 0, row = 0, bir = 0;
  bool touched = false, ovf = false;
  __device__ explicit Pwm(const int* c)
      : ol(c[0]), ou(c[1]), zl(c[2]), zu(c[3]), syl(c[4]), syu(c[5]),
        gp(c[6]), rst(c[7]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int p, int g, bool last, Lane& o) {
    bool is1 = ol < p && p < ou;
    bool is0 = !is1 && zl < p && p < zu;
    bool issy = !is1 && !is0 && syl < p && p < syu;
    bool isspur = !is1 && !is0 && !issy && p <= ol;
    bool isrb = !is1 && !is0 && !issy && !isspur;
    bool isbit = is1 || is0;
    int sy_row = bir > 0 ? row + 1 : row;
    int row2 = issy ? sy_row : row;
    int bir2 = (issy && bir > 0) ? 0 : bir;
    if (isrb) { row2 += 1; bir2 = 0; }
    if (isbit) o.bit(ev, row2, bir2, is1);
    if (issy) o.sync(ev, sy_row);
    int bir3 = isbit ? bir2 + 1 : bir2;
    bool touched2 = touched || isbit || issy || isrb;
    bool flush = (g > rst || last) && touched2;
    if (flush) o.rows(ev, row2 + 1);
    bool brk = !flush && gp > 0 && g > gp && touched2 && bir3 > 0;
    int ev2 = flush ? ev + 1 : ev;
    int row3 = flush ? 0 : (brk ? row2 + 1 : row2);
    ovf = ovf || ev2 >= o.E || max(row2, row3) >= o.R || bir3 >= o.BY * 8;
    ev = ev2;
    row = row3;
    bir = (flush || brk) ? 0 : bir3;
    touched = flush ? false : touched2;
  }
  __device__ void end(Lane&) {}
};

struct Pcm {
  static constexpr bool kSymbols = false;
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

  __device__ void begin(Lane&) {}

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

  __device__ void step(int p, int g, bool last, Lane& o) {
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
  __device__ void end(Lane& o) { o.erase(ev, dirty); }
};

struct Mc {
  static constexpr bool kSymbols = false;
  int sh, rst, tol;
  bool has_tol;
  int ev = 0, row = 0, bir = 1, tsl = 0;
  bool ovf = false;
  __device__ explicit Mc(const int* c)
      : sh(c[0]), rst(c[1]), tol(c[2]), has_tol(c[3] != 0) {}
  __device__ void pre(const int*, const int*, int) {}
  // every buffer starts with a hardcoded 0 bit (event 0 here, the next
  // event's at each flush)
  __device__ void begin(Lane& o) { o.count(0, 0, 1); }
  __device__ void step(int p, int g, bool last, Lane& o) {
    bool out = has_tol && (p < sh - tol || p > 2 * sh + tol ||
                           g < sh - tol || g > 2 * sh + tol);
    bool c1_out = out && 2 * p > 3 * sh && p <= 2 * sh + tol;
    bool c1_mid = !out && 2 * (p + tsl) > 3 * sh;
    bool c1 = c1_out || c1_mid;
    if (c1) o.bit(ev, row, bir, 1);
    int bir2 = c1 ? bir + 1 : bir;
    int row2 = out ? row + 1 : row;
    if (out) o.count(ev, row2, 1);         // the new row's leading 0
    int bir3 = out ? 1 : bir2;
    int tsl2 = (out || c1_mid) ? 0 : tsl + p;
    bool flush = g > rst || last;
    bool c3 = !flush && 2 * (g + tsl2) > 3 * sh;
    if (c3) o.count(ev, row2, 1);          // a mid-bit 0
    int bir4 = c3 ? bir3 + 1 : bir3;
    int ev2 = flush ? ev + 1 : ev;
    if (flush) {
      o.rows(ev, row2 + 1);
      o.count(ev2, 0, 1);                  // the next event's leading 0
    }
    ovf = ovf || row2 >= o.R || bir4 > o.BY * 8 || max(bir2, 1) > o.BY * 8 ||
          (flush && ev2 >= o.E);
    tsl = (flush || c3) ? 0 : tsl2 + g;
    ev = ev2;
    row = flush ? 0 : row2;
    bir = flush ? 1 : bir4;
  }
  __device__ void end(Lane&) {}
};

struct Dmc {
  static constexpr bool kSymbols = true;
  int sh, lo, rst, tol;
  int ev = 0, row = 0, bir = 0;
  bool pend = false, has = false, ovf = false;
  __device__ explicit Dmc(const int* c)
      : sh(c[0]), lo(c[1]), rst(c[2]), tol(c[3]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int sym, int, bool, Lane& o) {
    int d_short = abs(sym - sh);
    bool in_short = d_short < tol;
    bool in_long = abs(sym - lo) < tol;
    bool is_rst = sym >= rst - tol;
    bool row_has = bir > 0;
    bool mist = d_short > tol;
    bool p_consume = pend && !mist;
    bool p_fall = pend && mist && is_rst;
    bool p_break = pend && mist && !is_rst && row_has;
    bool p_done = pend && mist && !is_rst && !row_has;
    bool norm = !pend || p_fall;
    bool n_one = norm && in_short;
    bool n_zero = norm && !in_short && in_long;
    bool n_flush = norm && !in_short && !in_long && is_rst && has;
    bool isbit = n_one || n_zero;
    if (isbit) o.bit(ev, row, bir, n_one);
    int bir2 = isbit ? bir + 1 : bir;
    bool has2 = has || isbit;
    int row2 = p_break ? row + 1 : row;
    int bir3 = p_break ? 0 : bir2;
    if (n_flush) o.rows(ev, row2 + 1);
    int ev2 = n_flush ? ev + 1 : ev;
    ovf = ovf || row2 >= o.R || bir2 > o.BY * 8 || (n_flush && ev2 >= o.E);
    pend = n_one && !(p_consume || p_break || p_done);
    ev = ev2;
    row = n_flush ? 0 : row2;
    bir = n_flush ? 0 : bir3;
    has = n_flush ? false : has2;
  }
  __device__ void end(Lane&) {}
};

struct PiwmDc {
  static constexpr bool kSymbols = true;
  int sh, lo, rst, tol;
  int ev = 0, row = 0, bir = 0;
  bool touched = false, ovf = false;
  __device__ explicit PiwmDc(const int* c)
      : sh(c[0]), lo(c[1]), rst(c[2]), tol(c[3]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int sym, int, bool last, Lane& o) {
    bool in1 = abs(sym - sh) < tol;
    bool in0 = !in1 && abs(sym - lo) < tol;
    bool isrb = !in1 && !in0 && sym < rst && touched && bir > 0;
    bool isbit = in1 || in0;
    if (isbit) o.bit(ev, row, bir, in1);
    int bir2 = isbit ? bir + 1 : bir;
    bool touched2 = touched || isbit;
    int row2 = isrb ? row + 1 : row;
    int bir3 = isrb ? 0 : bir2;
    bool flush = (sym > rst || last) && touched2;
    if (flush) o.rows(ev, row2 + 1);
    int ev2 = flush ? ev + 1 : ev;
    ovf = ovf || row2 >= o.R || bir2 > o.BY * 8 || (flush && ev2 >= o.E);
    ev = ev2;
    row = flush ? 0 : row2;
    bir = flush ? 0 : bir3;
    touched = flush ? false : touched2;
  }
  __device__ void end(Lane&) {}
};

struct Nrzs {
  static constexpr bool kSymbols = false;
  int sh, rst;
  int ev = 0, bir = 0;
  bool ovf = false;
  __device__ explicit Nrzs(const int* c) : sh(c[0]), rst(c[1]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int p, int g, bool last, Lane& o) {
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
  __device__ void end(Lane&) {}
};

struct Rzi {
  static constexpr bool kSymbols = false;
  int lo, rst, base;
  int ev = 0, bir = 0;
  bool at_start = true, ovf = false;
  __device__ explicit Rzi(const int* c) : lo(c[0]), rst(c[1]), base(c[2]) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int p, int g, bool last, Lane& o) {
    int num = at_start ? p + lo / 2 : p - base + lo / 2;
    // floor and truncation agree once the result is clamped at 0
    int ones = max(num / max(lo, 1), 0);
    o.run(ev, 0, bir, ones);
    int bir2 = bir + ones;
    bool flush = g > rst || last;
    bool emitted = flush && bir2 > 0;
    int zz = flush ? 0 : 1;
    if (ones + zz > 0) o.count(ev, 0, ones + zz);
    if (emitted) o.rows(ev, 1);
    int ev2 = emitted ? ev + 1 : ev;
    ovf = ovf || bir2 + zz > o.BY * 8 || (emitted && ev2 >= o.E);
    ev = ev2;
    bir = flush ? 0 : bir2 + zz;
    at_start = flush;
  }
  __device__ void end(Lane&) {}
};

struct Osv1 {
  static constexpr bool kSymbols = false;
  int rst, hmin, hmax, sync_min;
  int phase = 0, cnt = 0, manbit = 0, bir = 0, ev = 0, nbits = 0;
  bool touched = false, ovf = false;
  __device__ explicit Osv1(const int* c)
      : rst(c[1]), hmin(c[0] / 2), hmax(c[0] * 3 / 2),
        sync_min(2 * (c[0] * 3 / 2)) {}
  __device__ void pre(const int*, const int*, int) {}
  __device__ void begin(Lane&) {}
  __device__ void step(int p, int g, bool last, Lane& o) {
    bool ph0 = phase == 0, ph1 = phase == 1, ph2 = phase == 2;
    bool pass0 = p > hmin && g > hmin;
    int cnt2 = (ph0 && pass0) ? cnt + 1 : cnt;
    bool brk = ph0 && pass0 && g > hmax;
    int ph_a = (ph0 && !pass0) ? 3 : phase;
    if (brk) ph_a = cnt2 == 12 ? 1 : 3;
    bool pass1 = p >= sync_min && g >= sync_min;
    int ph_b = ph1 ? (pass1 ? 2 : 3) : ph_a;
    bool sync0 = ph1 && pass1 && g > p;
    int m = sync0 ? 1 : manbit;
    bool phit = p > hmax;
    bool c1 = ph2 && (phit || m == 0);
    int mp = phit ? m : 1 - m;
    if (c1) {
      // every 1 lands in event 0, row 0; a position past the row is
      // clipped to its last bit and added, as the JAX scatter-add does
      int bp = min(max(bir, 0), 8 * o.BY - 1);
      o.bytes[bp >> 3] += (uint8_t)(0x80u >> (bp & 7));
    }
    int bir2 = bir + (c1 ? 1 : 0);
    bool touched2 = touched || c1 || sync0;
    bool flush = ph2 && (last || g > rst) && touched2;
    bool ghit = g > hmax;
    bool c0 = (ph2 && !flush && (ghit || mp == 0)) || sync0;
    int bir3 = bir2 + (c0 ? 1 : 0);
    nbits += (c1 ? 1 : 0) + (c0 ? 1 : 0);
    manbit = (ph2 && !flush) ? (ghit ? mp : 1 - mp) : (flush ? mp : m);
    touched = touched2 || c0;
    phase = flush ? 3 : ph_b;
    ev += flush ? 1 : 0;
    ovf = ovf || bir3 > 8 * o.BY;
    cnt = cnt2;
    bir = bir3;
  }
  __device__ void end(Lane& o) {
    o.bpr[0] = nbits;
    o.nrows[0] = ev > 0 ? 1 : 0;
  }
};

template <class F>
__global__ void slice_lanes(const int* __restrict__ pulse,
                            const int* __restrict__ gap,
                            const int* __restrict__ n_pulses, int N,
                            const int* __restrict__ bounds, int S, int E,
                            int R, int BY, uint8_t* bytes, int* bpr,
                            int* syncs, int* nrows, int* n_events,
                            uint8_t* ovf) {
  extern __shared__ int smem[];
  int* sp = smem;
  int* sg = smem + N;
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
  if (s >= S) return;
  const size_t lane = (size_t)b * S + s;
  const int* c = bounds + (size_t)s * NCOLS;
  const bool ok = c[NCOLS - 1] != 0;
  Lane o{bytes + lane * E * R * BY, bpr + lane * E * R,
         syncs + lane * E * R, nrows + lane * E, E, R, BY};
  F f(c);
  f.pre(sp, sg, n);      // PCM's rates run on every lane, as in JAX
  if (ok) {
    f.begin(o);
    if (F::kSymbols) {
      for (int i = 0; i < 2 * n; ++i)
        f.step((i & 1) ? sg[i >> 1] : sp[i >> 1], 0, i == 2 * n - 1, o);
    } else {
      for (int i = 0; i < n; ++i) f.step(sp[i], sg[i], i == n - 1, o);
    }
    f.end(o);
  }
  n_events[lane] = f.ev;
  ovf[lane] = f.ovf ? 1 : 0;
}

// the ok flag is the last column of every family's row
template <class F>
cudaError_t launch(const int* pulse, const int* gap, const int* n_pulses,
                   int B, int N, const int* bounds, int S, int E, int R,
                   int BY, uint8_t* bytes, int* bpr, int* syncs, int* nrows,
                   int* n_events, uint8_t* ovf, cudaStream_t st) {
  const int threads = S >= 128 ? 128 : ((S + 31) / 32) * 32;
  dim3 grid((S + threads - 1) / threads, B);
  size_t shm = (size_t)2 * N * sizeof(int);
  if (shm > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        slice_lanes<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return e;
  }
  slice_lanes<F><<<grid, threads, shm, st>>>(
      pulse, gap, n_pulses, N, bounds, S, E, R, BY, bytes, bpr, syncs,
      nrows, n_events, ovf);
  return cudaGetLastError();
}

}  // namespace

// bounds is the family's int32 [S, NCOLS] table (ops/slice.py
// bound_table): its columns from 0 in the family's order, ok in the last.
extern "C" int rtl433_slice(int family, const void* pulse, const void* gap,
                            const void* n_pulses, int B, int N,
                            const void* bounds, int S, int E, int R, int BY,
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
#define RTL433_SLICE(F)                                                     \
  return (int)launch<F>(P, G, NP, B, N, BD, S, E, R, BY, BYT, BPR, SY, NR, \
                        NE, OV, st)
  switch (family) {
    case 0: RTL433_SLICE(Ppm);
    case 1: RTL433_SLICE(Pwm);
    case 2: RTL433_SLICE(Pcm);
    case 3: RTL433_SLICE(Mc);
    case 4: RTL433_SLICE(Dmc);
    case 5: RTL433_SLICE(PiwmDc);
    case 6: RTL433_SLICE(Nrzs);
    case 7: RTL433_SLICE(Rzi);
    case 8: RTL433_SLICE(Osv1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTL433_SLICE
}
