// Device slicing: each (train, spec) lane runs one reference slicer over its
// train and writes the lane's bitbuffers; a thread group runs each lane.
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
// The groups (slice_groups). A group of G threads (32, or 8 or 16 where
// the train is short) runs one lane over tiles of G steps, a step per
// thread: a pulse and its gap for PPM, MC, PWM, PCM, NRZS, RZI and OSV1,
// symbols of the interleaved pulse/gap axis for DMC and PIWM-DC
// (kSymbols; 2n of them). A CTA holds one train, staged once into shared
// memory, and up to four warps of lanes. Most of the nine step functions
// is not serial: what a gap, pulse or symbol is (PPM's four classes,
// PWM's five; MC's out, its resync 1, the flush; DMC's and PIWM-DC's
// classes and reset test; PCM's ones, zeros, clear and row break once its
// rates are fixed; NRZS's and RZI's ones, whether an RZI pulse opens a
// message) and whether it may end an event or a row depends on no state,
// and the cursors only count or reset since the last reset. OSV1's phase
// machine has a closed form (its phases are fixed pulses until the
// flush). So a tile is
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
//      the step functions judge it; PCM, NRZS and RZI, whose steps add a
//      run of bits, by a segmented add-scan since the last reset
//      (Group::seg_scan); a tile hands its cursors to the next through
//      its last thread;
//   4. written to the group's stage (every event, struct Stage): a row's
//      bit count by the thread of its last bit in the tile, its bytes by
//      word ORs (the positions of a tile never decrease with the thread,
//      so a segmented OR-scan gives each word one store; the runs of PCM,
//      NRZS and RZI, which span words and share their edge words, by
//      atomic ORs), syncs by shared adds; OSV1 ORs the ones below the
//      row's last bit, counts those the JAX scatter-add clips to it and
//      adds the count to the row's last byte once at the end
//      (GroupFamily::end); PCM's bitbuffer_clear erases the rows its open
//      event staged in earlier tiles.
// PCM first runs its rate pass (GroupFamily::begin: JAX _pcm_rates) over
// the whole train in tiles of its own: the runs of its preamble estimator
// from ballots and segmented sums, RZ's acceptances in closed form (a
// running max), NRZ's, whose run test reads the running estimate, in
// rounds of speculation (PcmLanes). OSV1 stops a CTA's tiles once none of
// its lanes can write (kStops: a CTA-wide vote a tile). At the end the
// group writes its stage out (put_events): consecutive threads on
// consecutive 16-byte chunks of the lane's contiguous event range (bytes
// where the caps do not allow 16), zeros for the events it never reached;
// so the planes are written once, coalesced, and nothing is read back.
//
// Float32 in PCM: the JAX scan and the plain version round each product
// and sum separately, so every float operation here is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __int2float_rn), which nvcc never contracts into an FMA; jnp.round is
// round-half-even (rintf). Built without --use_fast_math.
//
// Bound: the bytes of the output planes (each written once) against
// integer work over B * S * n steps (a few tens of int32 ops per step;
// 2n symbols for DMC and PIWM-DC, two passes for PCM). At a drain of the
// 4096-channel workload the planes are tens of MB, so the bytes bound it
// on paper; on the card a call of up to a few thousand lanes is one wave,
// bound by the latency of its longest lane: a tile of G steps costs a
// fixed few hundred cycles of ballots, shuffles and stage stores, MC's
// remaining serial walk is as long as its longest piece (a pulse or two
// on Manchester data), and PCM's NRZ rate pass takes one round a tile
// more for each run it accepts there.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NCOLS = 12;     // ops/slice.py NCOLS

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// The output planes and caps of a launch, and the layout of a lane's
// stage: its E events, each as rows [R, BYP] (BY rounded up to 4 bytes),
// then bits_per_row [E, R], syncs [E, R] and num_rows [E], each part
// rounded up to 16 bytes (ops/slice.py stage_bytes).
struct Planes {
  uint8_t* bytes;   // [B, S, E, R, BY]
  int* bpr;         // [B, S, E, R]
  int* syncs;       // [B, S, E, R]
  int* nrows;       // [B, S, E]
  int E, R, BY;
  int BYP;          // bytes of a staged row
  int ob, os, on;   // stage offsets: bits_per_row, syncs, num_rows
  bool v16;         // rows in 16-byte stores: BY % 4 == 0, R * BY % 16 == 0
  bool r4;          // counts in 16-byte stores: R % 4 == 0
  __device__ Planes(uint8_t* b, int* p, int* s, int* n, int E_, int R_,
                    int BY_)
      : bytes(b), bpr(p), syncs(s), nrows(n), E(E_), R(R_), BY(BY_),
        BYP((BY_ + 3) & ~3),
        ob(round16(E_ * R_ * ((BY_ + 3) & ~3))),
        os(round16(E_ * R_ * ((BY_ + 3) & ~3)) + 4 * E_ * R_),
        on(round16(E_ * R_ * ((BY_ + 3) & ~3)) + round16(8 * E_ * R_)),
        v16(BY_ % 4 == 0 && (R_ * BY_) % 16 == 0), r4(R_ % 4 == 0) {}
  __device__ int stage_words() const { return (on + round16(4 * E)) / 4; }
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

// Threads t = 0..nt-1 write one lane's events from its stage `st` (every
// event of the lane). Consecutive threads take consecutive 16-byte chunks
// of the lane's contiguous event range (bytes where the caps do not allow
// 16). Each calls it after a __syncwarp that makes the stage visible.
__device__ void put_events(const Planes& p, size_t lane, const uint8_t* st,
                           int t, int nt) {
  const int E = p.E, R = p.R;
  const int EV = R * p.BY;                         // bytes of one event
  uint8_t* gb = p.bytes + lane * E * EV;
  int* gp = p.bpr + lane * E * R;
  int* gs = p.syncs + lane * E * R;
  int* gn = p.nrows + lane * E;
  const int* sp = reinterpret_cast<const int*>(st + p.ob);
  const int* ss = reinterpret_cast<const int*>(st + p.os);
  const int* sn = reinterpret_cast<const int*>(st + p.on);
  if (p.v16) {
    uint4* d = reinterpret_cast<uint4*>(gb);
    const uint4* s4 = reinterpret_cast<const uint4*>(st);
    for (int i = t; i < E * EV / 16; i += nt) d[i] = s4[i];
  } else {
    for (int i = t; i < E * EV; i += nt)
      gb[i] = st[(i / p.BY) * p.BYP + i % p.BY];
  }
  if (p.r4) {
    int4* dp = reinterpret_cast<int4*>(gp);
    int4* ds = reinterpret_cast<int4*>(gs);
    const int4* sp4 = reinterpret_cast<const int4*>(sp);
    const int4* ss4 = reinterpret_cast<const int4*>(ss);
    for (int i = t; i < E * R / 4; i += nt) {
      dp[i] = sp4[i];
      ds[i] = ss4[i];
    }
  } else {
    for (int i = t; i < E * R; i += nt) {
      gp[i] = sp[i];
      gs[i] = ss[i];
    }
  }
  for (int i = t; i < E; i += nt) gn[i] = sn[i];
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
  __device__ float from(float v, int k) const {
    return __shfl_sync(kFull, v, k, G);
  }
  // v of thread t - 1 (thread 0 gets its own)
  __device__ int prev(int v) const { return __shfl_up_sync(kFull, v, 1, G); }
  // the sum of v over the group, at every thread (unsigned: it wraps as
  // int32 does, alike in any order)
  __device__ unsigned sum(unsigned v) const {
    for (int d = G / 2; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d, G);
    return v;
  }
  // the max of v over threads [0, t]
  __device__ int max_scan(int v) const {
    for (int d = 1; d < G; d <<= 1) {
      const int o = __shfl_up_sync(kFull, v, d, G);
      if (t >= d) v = max(v, o);
    }
    return v;
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
// pulses, does nothing at a lane's start and end, makes no pass over the
// train before its tiles (pre: PCM's rate pass, given the train's pulses
// and gaps and whether the lane is one of the call's), and runs every
// tile. A family with kStops runs a tile only while running() holds for a
// lane of its CTA.
struct GroupFamily {
  static constexpr bool kSymbols = false;
  static constexpr bool kStops = false;
  template <int G>
  __device__ void begin(const Group<G>&, Stage&, bool) {}
  template <int G>
  __device__ void pre(const Group<G>&, bool, const int*, const int*, int) {}
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

// PCM (JAX slice_pcm, its rates JAX _pcm_rates), a pulse per thread, in
// two passes over the train.
//
// The rate pass (pre) re-estimates the bit rates fs and fl from the
// preamble runs, then from the order-free fallback sums. A run is a
// stretch of pulses in the run class; where it ends (a pulse out of the
// class after one in it, or the train's end) it is accepted where its
// count reaches mc, which only an acceptance moves, to that run's count:
// so a run is accepted where its count reaches mc0 and every earlier
// run's. A run's count, width sums and end come from a ballot of the class
// and segmented sums (cursors since the last pulse out of the class). RZ's
// class reads no state: every acceptance of a tile at once, from a running
// max; fs and fl from the last accepted run whose width sum is positive.
// NRZ's class (a pulse and gap of one bit each) reads the running fs and
// fl, which only an acceptance moves, and every run ends outside the
// class, where the run state is zero: so a tile is classified with the
// rates in force, its first acceptance found, every pulse up to it final,
// and the pulses after it classified again with the new rates, in rounds
// until a round accepts no run. The float-boundary flag of a pulse counts
// in the round that makes its class final. The fallbacks are group sums.
//
// The step pass (tile): with the rates fixed, a pulse's ones (h) and
// zeros (l), its clear (an RZ pulse out of the short class) and row break
// read no state. Clears and flush candidates reset the cursors: a
// candidate flushes where the event was touched (bits, or a row break)
// since the last reset, this pulse included, and one that does not finds
// every cursor at zero, as a flush leaves them. So row counts the breaks
// and bir (a segmented add-scan) the bits since the last reset (bir also
// since the last break). bitbuffer_clear keeps a pulse's run only where
// the first reset at or after it is a flush; the train's last pulse is a
// candidate, so every pulse is decided by then. A tile writes the runs it
// keeps and those no reset of the tile decides, and where its first reset
// is a clear it first erases the rows the open event staged in earlier
// tiles (all of them undecided until that clear).
struct PcmLanes : GroupFamily {
  int sh, lo, rst, gpl, tol, mz, mc0;
  bool is_rz;
  float fs, fl;
  int ev = 0, row = 0, bir = 0;
  bool tch = false, ovf = false;
  __device__ PcmLanes(const int* c, bool)
      : sh(c[0]), lo(c[1]), rst(c[2]), gpl(c[3]), tol(c[4]), mz(c[5]),
        mc0(c[6]), is_rz(c[7] != 0), fs(bits_to_float(c[8])),
        fl(bits_to_float(c[9])) {}

  // the rate pass, on every lane of the call (`live`), as in JAX
  template <int G>
  __device__ void pre(const Group<G>& gr, bool live, const int* sp,
                      const int* sg, int n) {
    const int t = gr.t, dc = is_rz ? 1 : 2;
    const unsigned lt = gr.lt(), le = gr.le();
    int cnt = 0, sw = 0, lw = 0, mc = mc0, plen = 0;
    bool prev = false, flag = false;
    unsigned rzc = 0, rzs = 0, rzl = 0, nw = 0, nc = 0;
    // NRZ's two width sums are one (p + g), and only RZ reads the running
    // max: a warp with no RZ lane skips RZ's scans (a warp-wide vote, so
    // every thread of the warp takes the same branch)
    const bool any_rz = __any_sync(kFull, is_rz);
    for (int base = 0; base < n; base += G) {
      const int nact = live ? min(G, n - base) : 0;
      const bool act = t < nact;
      const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
      const bool wp = p >= sh - tol && p <= sh + tol;
      const bool crz = act && wp && p + g >= lo - tol && p + g <= lo + tol;
      if (crz) {
        rzc += 1;
        rzs += p;
        rzl += p + g;
      }
      if (act) {
        if (wp) { nw += p; nc += 1; }
        if (p >= 2 * sh - tol && p <= 2 * sh + tol) { nw += p; nc += 2; }
        if (g >= lo - tol && g <= lo + tol) { nw += g; nc += 1; }
        if (g >= 2 * lo - tol && g <= 2 * lo + tol) { nw += g; nc += 2; }
      }
      const int vs = is_rz ? p : p + g;
      // rounds: every group of the warp runs one while any of them needs
      // it (the collectives take the whole warp); a group whose tile is
      // final keeps its classes and applies nothing
      bool c = false, ff = false, run = nact > 0;
      int start = 0;   // the first pulse whose class is not final
      unsigned C = 0;
      int cb = 0, swi = 0, lwi = 0;
      for (;;) {
        if (run && t >= start) {
          bool np, ng;
          const int hp = trunc05(__fmul_rn(i2f(p), fs), np);
          const int hg = trunc05(__fmul_rn(i2f(g), fl), ng);
          c = act && (is_rz ? crz : hp == 1 && hg == 1);
          ff = act && !is_rz && ((np && hp <= 2) || (ng && hg <= 2));
        }
        // the run that ends before this pulse: its count and width sums
        // (after a round's acceptance the pulse there is out of the class,
        // so a later pulse's run never reaches back past it)
        C = gr.ballot(c);
        const bool ended = act && !c && (t ? ((C >> (t - 1)) & 1) : prev);
        const unsigned z = ~C & lt;
        cb = z ? (t - 1 - hibit(z)) * dc : cnt + t * dc;
        const bool head = (~C & le) != 0;
        swi = gr.seg_scan(c ? vs : 0, !c) + (head ? 0 : sw);
        lwi = any_rz ? gr.seg_scan(c ? p + g : 0, !c) + (head ? 0 : lw) : swi;
        const int swp = gr.prev(swi), lwp = any_rz ? gr.prev(lwi) : swp;
        const int swb = t ? swp : sw, lwb = t ? lwp : lw;
        const int pm =
            any_rz ? gr.prev(gr.max_scan(ended ? cb : INT_MIN)) : INT_MIN;
        const bool acc = ended && t >= start &&
                         cb >= (is_rz ? max(mc, t ? pm : INT_MIN) : mc);
        unsigned A = gr.ballot(acc);
        if (!is_rz) A &= 0u - A;   // NRZ: the first acceptance alone
        const int k = A ? hibit(A) : 0;
        const unsigned SW = A & gr.ballot(swb > 0);
        const unsigned LW = A & gr.ballot(lwb > 0);
        const int ck = gr.from(cb, k);
        const float fsk = gr.from(__fdiv_rn(i2f(cb), i2f(swb)),
                                  SW ? hibit(SW) : 0);
        const float flk = gr.from(__fdiv_rn(i2f(cb), i2f(lwb)),
                                  LW ? hibit(LW) : 0);
        const unsigned fin = (A && !is_rz ? (2u << k) - 1 : ~0u) &
                             above(start - 1);
        const bool fflag = (gr.ballot(ff) & fin) != 0;
        if (run) {
          flag = flag || fflag;
          if (A) {
            mc = plen = ck;
            const float f2 = SW ? fsk : fs;
            fl = is_rz ? (LW ? flk : fl) : f2;
            fs = f2;
          }
          start = k + 1;
          run = !is_rz && A && start < nact;
        }
        if (!__any_sync(kFull, run)) break;
      }
      // the run state after the tile's last pulse
      const int kk = max(nact - 1, 0);
      const int ncnt = gr.from(c ? cb + dc : 0, kk);
      const int nsw = gr.from(swi, kk), nlw = gr.from(lwi, kk);
      if (nact) {
        cnt = ncnt;
        sw = nsw;
        lw = nlw;
        prev = (C >> kk) & 1;
      }
    }
    // a run still open at the train's end
    if (cnt > 0 && cnt >= mc) {
      const float fsn = sw > 0 ? __fdiv_rn(i2f(cnt), i2f(sw)) : fs;
      fl = is_rz ? (lw > 0 ? __fdiv_rn(i2f(cnt), i2f(lw)) : fl) : fsn;
      fs = fsn;
      plen = cnt;
    }
    // the fallbacks, where no run was accepted
    rzc = gr.sum(rzc);
    rzs = gr.sum(rzs);
    rzl = gr.sum(rzl);
    nw = gr.sum(nw);
    nc = gr.sum(nc);
    if (is_rz && plen == 0 && (int)rzc > 8) {
      fs = __fdiv_rn(i2f((int)rzc), i2f(max((int)rzs, 1)));
      fl = __fdiv_rn(i2f((int)rzc), i2f(max((int)rzl, 1)));
    }
    if (!is_rz && plen == 0 && (int)nc > 20)
      fs = fl = __fdiv_rn(i2f((int)nc), i2f(max((int)nw, 1)));
    ovf = flag;
  }

  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt(), le = gr.le();
    // 1. what no state decides, the rates fixed
    bool nh, nl;
    const int h0 = trunc05(__fmul_rn(i2f(p), fs), nh);
    const int l0 = trunc05(__fmul_rn(i2f(g + sh - lo), fl), nl);
    const int h = act ? max(h0, 0) : 0;
    const int d = act ? h + min(max(l0, 0), mz) : 0;
    const bool near = act && (nh || (nl && l0 <= mz + 1));
    const bool clr = act && is_rz && abs(p - sh) > tol;
    const bool brk = act && !clr && g > gpl && g <= rst;
    const bool cand = act && (g > rst || base + t == n - 1);
    // 3. the cursors before this pulse
    const unsigned CL = gr.ballot(clr), RS = CL | gr.ballot(cand);
    const unsigned BK = gr.ballot(brk), EM = gr.ballot(d > 0);
    const bool touched = since(RS & lt, (EM | BK) & le, tch) > 0;
    const bool fl_ = cand && !clr && touched;
    const unsigned FL = gr.ballot(fl_);
    const int e_ = ev + __popc(FL & lt);
    const int r_ = since(RS & lt, BK & lt, row);
    const unsigned BR = RS | BK;   // bir restarts after these
    const int b_ = gr.seg_scan(d, t && ((BR >> (t - 1)) & 1)) - d +
                   ((BR & lt) ? 0 : bir);
    const int bir2 = b_ + d, row2 = clr ? 0 : r_ + brk;
    const unsigned o = gr.ballot(act && (near || e_ + fl_ >= s.E ||
                                         max(row2, r_) >= s.R ||
                                         bir2 >= s.BITS));
    ovf = ovf || o;
    // 4. the stage: the open event's undecided rows erased where the
    // tile's first reset is a clear; then the runs that the first reset at
    // or after them keeps (a flush) or no reset of the tile decides
    if (RS && ((CL >> (__ffs(RS) - 1)) & 1) && ev < s.E) {
      const int nr = min(row, s.R - 1) + 1;
      uint32_t* w = s.words() + ev * s.R * s.WPR;
      for (int i = t; i < nr * s.WPR; i += G) w[i] = 0u;
      for (int r = t; r < nr; r += G) s.nbits(ev, r) = 0;
    }
    __syncwarp();
    const unsigned nx = RS & ~lt;
    const bool keep = !nx || ((FL >> (__ffs(nx) - 1)) & 1);
    if (d > 0 && keep && s.in(e_, r_)) {
      if (h > 0) s.or_run(e_, r_, b_, h);
      if (row_ends(EM, BR << 1, le)) s.nbits(e_, r_) = bir2;
    }
    if (fl_ && e_ < s.E) s.nrow(e_) = row2 + 1;
    // the cursors after the tile's last pulse
    const int k = max(nact - 1, 0);
    const bool rs = clr || cand;
    const int ne = gr.from(e_ + fl_, k), nr = gr.from(rs ? 0 : row2, k);
    const int nb = gr.from((rs || brk) ? 0 : bir2, k);
    const int nt = gr.from((int)(!rs && touched), k);
    if (nact) {
      ev = ne; row = nr; bir = nb;
      tch = nt != 0;
    }
  }
};

// NRZS (JAX slice_nrzs), a pulse per thread: a pulse over the bit limit
// emits its width over the limit in ones, then a 0; one under it a 0; one
// at it nothing. Every flush candidate (a gap at or over the reset limit,
// or the last pulse) flushes, an empty event too. So the cursor is a
// segmented add-scan of the bits since the last candidate; each event has
// one row.
struct NrzsLanes : GroupFamily {
  int sh, rst;
  int ev = 0, bir = 0;
  bool ovf = false;
  __device__ NrzsLanes(const int* c, bool) : sh(c[0]), rst(c[1]) {}
  template <int G>
  __device__ void tile(const Group<G>& gr, Stage& s, const int* sp,
                       const int* sg, int base, int nact, int n) {
    const int t = gr.t;
    const bool act = t < nact;
    const int p = act ? sp[base + t] : 0, g = act ? sg[base + t] : 0;
    const unsigned lt = gr.lt();
    // 1. what no state decides (p > sh >= 1 where h divides: the floor
    // division of JAX truncates alike)
    const int h = act && p > sh ? p / max(sh, 1) : 0;
    const int d = h + (act && p != sh);
    const bool fc = act && (g >= rst || base + t == n - 1);
    // 3. the cursor before this pulse, and its event
    const unsigned FC = gr.ballot(fc);
    const int b_ = gr.seg_scan(d, t && ((FC >> (t - 1)) & 1)) - d +
                   ((FC & lt) ? 0 : bir);
    const int e_ = ev + __popc(FC & lt), bir2 = b_ + d;
    const unsigned o = gr.ballot(act && (bir2 > s.BITS ||
                                         (fc && e_ + 1 >= s.E)));
    ovf = ovf || o;
    // 4. the stage: the run of ones, the event's bit count by its last
    // pulse in the tile, its row at the flush (none where it is empty)
    if (h > 0 && e_ < s.E) s.or_run(e_, 0, b_, h);
    if (act && e_ < s.E && (fc || t == nact - 1)) s.nbits(e_, 0) = bir2;
    if (fc && e_ < s.E) s.nrow(e_) = bir2 > 0 ? 1 : 0;
    // the cursors after the tile's last pulse
    const int k = max(nact - 1, 0);
    const int ne = gr.from(e_ + fc, k), nb = gr.from(fc ? 0 : bir2, k);
    if (nact) {
      ev = ne;
      bir = nb;
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
  const Planes pl(bytes, bpr, syncs, nrows, E, R, BY);
  Stage st(pl, smem + round16(8 * N) + (size_t)(threadIdx.x / G) * SB);
  st.clear(gr.t, G);
  const int* c = bounds + (size_t)(live ? s : 0) * NCOLS;
  const bool ok = live && c[NCOLS - 1] != 0;
  F f(c, tame);
  __syncwarp();
  f.begin(gr, st, ok);
  f.pre(gr, live, sp, sg, n);
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
  put_events(pl, lane, st.st, gr.t, G);
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
// lanes, group (the threads per lane: 8, 16 or 32), SB and smem:
// ops/slice.py launch_plan. Every element of the six outputs is written.
extern "C" int rtl433_slice(int family, const void* pulse, const void* gap,
                            const void* n_pulses, int B, int N,
                            const void* bounds, int S, int E, int R, int BY,
                            int lanes, int group, int SB, int smem,
                            void* bytes, void* bpr, void* syncs, void* nrows,
                            void* n_events, void* ovf, void* stream) {
#define RTL433_SLICE(F)                                                      \
  return (int)launch_groups<F>(                                              \
      (const int*)pulse, (const int*)gap, (const int*)n_pulses, B, N,        \
      (const int*)bounds, S, E, R, BY, lanes, group, SB, smem,               \
      (uint8_t*)bytes, (int*)bpr, (int*)syncs, (int*)nrows, (int*)n_events,  \
      (uint8_t*)ovf, (cudaStream_t)stream)
  switch (family) {
    case 0: RTL433_SLICE(PpmLanes);
    case 1: RTL433_SLICE(PwmLanes);
    case 2: RTL433_SLICE(PcmLanes);
    case 3: RTL433_SLICE(McLanes);
    case 4: RTL433_SLICE(DmcLanes);
    case 5: RTL433_SLICE(PiwmDcLanes);
    case 6: RTL433_SLICE(NrzsLanes);
    case 7: RTL433_SLICE(RziLanes);
    case 8: RTL433_SLICE(Osv1Lanes);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTL433_SLICE
}
