// Batch pulse-slicer bank: one call slices a pulse/gap train against every
// registered decoder timing spec and serializes the resulting bitbuffers
// into a caller-provided arena.
//
// This is the native hot-path companion of rtl_433_tpu/pulse/slicers.py —
// the Python module is the exact-semantics oracle (itself modeled on
// reference src/pulse_slicer.c:68-930 behavior); this file must match it
// bit-for-bit and is differential-fuzzed against it in
// tests/test_native_slicers.py.
//
// Design (TPU framework runtime, not a port of the reference):
//   * the caller (Python) converts µs timings to samples once per spec
//     (keeping the reference's float32 truncation quirks host-side),
//   * slice_batch() loops specs × pulses in tight native loops,
//   * finished bitbuffers append to a byte arena as compact records,
//   * a parallel int32 summary table [spec, offset, rows, max_bits] lets the
//     caller gate decoder calls vectorized before materializing any record.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

constexpr int kRows = 50;    // ref include/bitbuffer.h:25
constexpr int kCols = 128;   // ref include/bitbuffer.h:24
constexpr int kRowBits = kCols * 8;

// Bitbuffer sink mirroring rtl_433_tpu/bits/bitbuffer.py construction
// semantics (MSB-first append, row spilling, add_row overflow quirk).
struct BitSink {
    uint8_t bb[kRows * kCols];
    uint16_t bits_per_row[kRows];
    uint16_t syncs[kRows];
    int32_t num_rows;
    int32_t free_row;

    void clear() {
        std::memset(bb, 0, sizeof(bb));
        std::memset(bits_per_row, 0, sizeof(bits_per_row));
        std::memset(syncs, 0, sizeof(syncs));
        num_rows = 0;
        free_row = 0;
    }

    void add_bit(int bit) {
        if (num_rows == 0) { free_row = num_rows = 1; }
        uint32_t bpr = bits_per_row[num_rows - 1];
        if (bpr == 0xFFFF) return;
        uint32_t col = bpr >> 3;
        uint32_t off = bpr & 7;
        if (bpr > 0 && bpr % kRowBits == 0) {
            if (free_row < kRows) free_row += 1; else return;
        }
        int row = num_rows - 1;
        bb[row * kCols + col] |= (uint8_t)((bit & 1) << (7 - off));
        bits_per_row[row] = (uint16_t)(bpr + 1);
    }

    // Append `count` copies of `bit` — byte-filled between the ragged
    // edges; exact equivalent of calling add_bit(bit) count times.
    void add_run(int bit, int64_t count) {
        if (count <= 0) return;
        if (num_rows == 0) { free_row = num_rows = 1; }
        int row = num_rows - 1;
        while (count > 0) {
            uint32_t bpr = bits_per_row[row];
            if (bpr == 0xFFFF) return;
            if (bpr > 0 && bpr % kRowBits == 0) {
                if (free_row < kRows) free_row += 1; else return;
            }
            // bits available before the next spill/cap boundary
            uint32_t boundary = (bpr % kRowBits == 0 && bpr > 0)
                ? bpr + kRowBits
                : ((bpr / kRowBits) + 1) * kRowBits;
            if (boundary > 0xFFFF) boundary = 0xFFFF;
            int64_t take = boundary - bpr;
            if (take > count) take = count;
            if (take <= 0) { add_bit(bit); count -= 1; continue; }
            uint32_t end = bpr + (uint32_t)take;
            uint8_t* base = bb + row * kCols;
            if (bit & 1) {
                // head partial byte
                uint32_t p = bpr;
                while (p < end && (p & 7)) { base[p >> 3] |= 0x80 >> (p & 7); p++; }
                // full bytes
                while (p + 8 <= end) { base[p >> 3] = 0xFF; p += 8; }
                // tail partial byte
                while (p < end) { base[p >> 3] |= 0x80 >> (p & 7); p++; }
            }
            bits_per_row[row] = (uint16_t)end;
            count -= take;
        }
    }

    void add_row() {
        if (num_rows == 0) { free_row = num_rows = 1; }
        if (free_row < kRows) { free_row += 1; num_rows = free_row; }
        else bits_per_row[num_rows - 1] = 0;
    }

    void add_sync() {
        if (num_rows == 0) { free_row = num_rows = 1; }
        if (bits_per_row[num_rows - 1]) add_row();
        syncs[num_rows - 1] += 1;
    }
};

// Timing spec, pre-converted to samples by the caller.  modulation < 0
// disables the spec (e.g. the µs→samples rounding-to-zero skip).
struct Spec {
    int32_t modulation;
    int32_t s_short, s_long, s_sync, s_gap, s_reset, s_tol;
    double f_short, f_long;
};

enum Modulation {
    MOD_PCM = 0, MOD_PPM = 1, MOD_PWM = 2, MOD_MC_ZEROBIT = 3, MOD_DMC = 4,
    MOD_PIWM_RAW = 5, MOD_PIWM_DC = 6, MOD_NRZS = 7, MOD_OSV1 = 8,
    MOD_RZI = 9,
};

// Content-dedup hash table: repeated bursts make most emitted bitbuffers
// byte-identical; duplicate records reuse the first occurrence's arena
// offset so the host materializes and decode-caches each unique buffer once.
constexpr int kHashBits = 14;
constexpr int kHashSlots = 1 << kHashBits;

struct Arena {
    uint8_t* buf;
    int64_t cap;
    int64_t len;
    int32_t* summary;       // 4 int32 per event
    int64_t summary_cap;    // in events
    int64_t n_events;
    bool overflow;
    int64_t* table;         // kHashSlots entries: arena offset + 1, 0 = empty
    uint64_t* table_hash;

    // word-at-a-time mix (quality is sufficient: every hash hit is
    // confirmed by a full memcmp before dedup)
    static uint64_t fnv1a(const uint8_t* p, size_t n, uint64_t h) {
        while (n >= 8) {
            uint64_t v;
            std::memcpy(&v, p, 8);
            h ^= v;
            h *= 0x9E3779B97F4A7C15ULL;
            h ^= h >> 29;
            p += 8;
            n -= 8;
        }
        while (n--) { h ^= *p++; h *= 1099511628211ULL; }
        return h;
    }

    // Serialize one finished bitbuffer; record layout (4-byte aligned):
    //   int32 num_rows, int32 free_row,
    //   uint16 bits_per_row[num_rows], uint16 syncs[num_rows] (padded to 4),
    //   uint8 bb[free_row * 128]
    void emit(int spec_idx, const BitSink& s) {
        int nr = s.num_rows;
        int fr = s.free_row > nr ? s.free_row : nr;
        if (fr > kRows) fr = kRows;
        int64_t head = 8 + ((4 * nr + 3) & ~3);
        int64_t body = (int64_t)fr * kCols;
        if (n_events >= summary_cap) { overflow = true; return; }

        int32_t max_bits = 0;
        for (int i = 0; i < nr; i++)
            if (s.bits_per_row[i] > max_bits) max_bits = s.bits_per_row[i];

        uint64_t h = 1469598103934665603ULL;
        h = fnv1a((const uint8_t*)&nr, 4, h);
        h = fnv1a((const uint8_t*)s.bits_per_row, 2 * nr, h);
        h = fnv1a((const uint8_t*)s.syncs, 2 * nr, h);
        h = fnv1a(s.bb, body, h);

        // probe for an identical earlier record
        uint64_t slot = h & (kHashSlots - 1);
        for (int probe = 0; probe < 64; probe++) {
            int64_t ent = table[slot];
            if (ent == 0) break;
            if (table_hash[slot] == h) {
                int64_t off = ent - 1;
                const uint8_t* q = buf + off;
                int qnr = *(const int32_t*)q;
                int qfr = *(const int32_t*)(q + 4);
                if (qnr == nr && qfr == fr
                    && std::memcmp(q + 8, s.bits_per_row, 2 * nr) == 0
                    && std::memcmp(q + 8 + 2 * nr, s.syncs, 2 * nr) == 0
                    && std::memcmp(q + head, s.bb, body) == 0) {
                    int32_t* sm = summary + 4 * n_events;
                    sm[0] = spec_idx;
                    sm[1] = (int32_t)off;
                    sm[2] = nr;
                    sm[3] = max_bits;
                    n_events += 1;
                    return;
                }
            }
            slot = (slot + probe + 1) & (kHashSlots - 1);
        }

        if (len + head + body > cap) { overflow = true; return; }
        uint8_t* p = buf + len;
        *(int32_t*)p = nr;
        *(int32_t*)(p + 4) = fr;
        uint16_t* bits16 = (uint16_t*)(p + 8);
        for (int i = 0; i < nr; i++) {
            bits16[i] = s.bits_per_row[i];
            bits16[nr + i] = s.syncs[i];
        }
        if ((4 * nr) & 3) bits16[2 * nr] = 0;  // pad
        std::memcpy(p + head, s.bb, (size_t)body);
        if (table[slot] == 0) {  // record for future dedup (best effort)
            table[slot] = len + 1;
            table_hash[slot] = h;
        }
        int32_t* sm = summary + 4 * n_events;
        sm[0] = spec_idx;
        sm[1] = (int32_t)len;
        sm[2] = nr;
        sm[3] = max_bits;
        len += head + body;
        n_events += 1;
    }
};

// Round-half-up like Python's int(v + 0.5); clamped to int64 range so huge
// products (Python bigints) stay defined. Bit emission saturates at the
// bitbuffer's 0xFFFF row cap anyway, so clamping cannot change output.
inline int64_t iround64(double v) {
    v += 0.5;
    if (v > 9e18) v = 9e18;
    if (v < -9e18) v = -9e18;
    return (int64_t)v;
}

// ---- slicers (semantics: rtl_433_tpu/pulse/slicers.py, cited per fn) ----

void slice_pcm(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
               Arena& a, int idx, BitSink& bits) {
    // slicers.py:50-158 (ref src/pulse_slicer.c:68-259)
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_tol = sp.s_tol;
    double f_short = sp.f_short, f_long = sp.f_long;
    int32_t gap_limit = sp.s_gap ? sp.s_gap : s_reset;
    int32_t max_zeros = s_long ? gap_limit / s_long : 0;
    if (s_tol <= 0) s_tol = s_long / 4;

    bits.clear();
    int min_count = (s_short == s_long) ? 12 : 4;
    int preamble_len = 0;
    if (s_short != s_long) {
        // RZ preamble bit-period re-estimation
        for (int n = 0; n < n_p; ) {
            int64_t swidth = 0, lwidth = 0;
            int count = 0;
            while (n < n_p
                   && P[n] >= s_short - s_tol && P[n] <= s_short + s_tol
                   && (int64_t)P[n] + G[n] >= s_long - s_tol
                   && (int64_t)P[n] + G[n] <= s_long + s_tol) {
                swidth += P[n];
                lwidth += P[n] + G[n];
                count += 1;
                n += 1;
            }
            if (count >= min_count) {
                f_long = (double)count / (double)lwidth;
                f_short = (double)count / (double)swidth;
                min_count = count;
                preamble_len = count;
            }
            n += 1;
        }
        if (preamble_len == 0) {
            // RZ anywhere-in-stream fallback
            int64_t rzs = 0, rzl = 0;
            int rzc = 0;
            for (int n = 0; n < n_p; n++) {
                if (P[n] >= s_short - s_tol && P[n] <= s_short + s_tol
                    && (int64_t)P[n] + G[n] >= s_long - s_tol
                    && (int64_t)P[n] + G[n] <= s_long + s_tol) {
                    rzs += P[n];
                    rzl += P[n] + G[n];
                    rzc += 1;
                }
            }
            if (rzc > 8) {
                f_long = (double)rzc / (double)rzl;
                f_short = (double)rzc / (double)rzs;
            }
        }
    } else {
        // NRZ preamble
        for (int n = 0; n < n_p; ) {
            int64_t width = 0;
            int count = 0;
            while (n < n_p && iround64(P[n] * f_short) == 1
                   && iround64(G[n] * f_long) == 1) {
                width += P[n] + G[n];
                count += 2;
                n += 1;
            }
            if (count >= min_count) {
                f_short = f_long = (double)count / (double)width;
                min_count = count;
                preamble_len = count;
            }
            n += 1;
        }
        if (preamble_len == 0) {
            // NRZ anywhere fallback
            int64_t nw = 0;
            int nc = 0;
            for (int n = 0; n < n_p; n++) {
                if (P[n] >= s_short - s_tol && P[n] <= s_short + s_tol) {
                    nw += P[n]; nc += 1;
                }
                if (P[n] >= 2 * s_short - s_tol && P[n] <= 2 * s_short + s_tol) {
                    nw += P[n]; nc += 2;
                }
                if (G[n] >= s_long - s_tol && G[n] <= s_long + s_tol) {
                    nw += G[n]; nc += 1;
                }
                if (G[n] >= 2 * s_long - s_tol && G[n] <= 2 * s_long + s_tol) {
                    nw += G[n]; nc += 2;
                }
            }
            if (nc > 20) f_short = f_long = (double)nc / (double)nw;
        }
    }

    // Bit counts saturate at the 0xFFFF+spill row cap, so iterating more
    // than ~70k times is a no-op in the Python oracle too — clamp the loop.
    constexpr int64_t kBitCap = 70000;
    for (int n = 0; n < n_p; n++) {
        int64_t highs = iround64(P[n] * f_short);
        int64_t lows = iround64(((double)G[n] + s_short - s_long) * f_long);
        if (highs > kBitCap) highs = kBitCap;
        bits.add_run(1, highs);
        if (lows > max_zeros) lows = max_zeros;
        bits.add_run(0, lows);

        if (s_short != s_long
            && (P[n] - s_short > s_tol || s_short - P[n] > s_tol)) {
            bits.clear();
        } else if (G[n] > gap_limit && G[n] <= s_reset) {
            bits.add_row();
        }
        if ((n == n_p - 1 || G[n] > s_reset)
            && (bits.bits_per_row[0] > 0 || bits.num_rows > 1)) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_ppm(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
               Arena& a, int idx, BitSink& bits) {
    // slicers.py:161-198 (ref src/pulse_slicer.c:261-337)
    (void)P;
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_gap = sp.s_gap, s_sync = sp.s_sync, s_tol = sp.s_tol;
    int32_t zero_l, zero_u, one_l, one_u, sync_l = 0, sync_u = 0;
    if (s_tol > 0) {
        zero_l = s_short - s_tol; zero_u = s_short + s_tol;
        one_l = s_long - s_tol; one_u = s_long + s_tol;
        if (s_sync > 0) { sync_l = s_sync - s_tol; sync_u = s_sync + s_tol; }
    } else {
        zero_l = 0;
        zero_u = (s_short + s_long) / 2 + 1;
        one_l = zero_u - 1;
        one_u = s_gap ? s_gap : s_reset;
    }
    bits.clear();
    for (int n = 0; n < n_p; n++) {
        if (G[n] > zero_l && G[n] < zero_u) bits.add_bit(0);
        else if (G[n] > one_l && G[n] < one_u) bits.add_bit(1);
        else if (G[n] > sync_l && G[n] < sync_u) bits.add_sync();
        else if (G[n] < s_reset) bits.add_row();
        if ((n == n_p - 1 || G[n] >= s_reset)
            && (bits.bits_per_row[0] > 0 || bits.num_rows > 1)) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_pwm(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
               Arena& a, int idx, BitSink& bits) {
    // slicers.py:201-253 (ref src/pulse_slicer.c:339-449)
    constexpr int32_t kIntMax = 0x7FFFFFFF;
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_gap = sp.s_gap, s_sync = sp.s_sync, s_tol = sp.s_tol;
    int32_t one_l, one_u, zero_l, zero_u, sync_l = 0, sync_u = 0;
    if (s_tol > 0) {
        one_l = s_short - s_tol; one_u = s_short + s_tol;
        zero_l = s_long - s_tol; zero_u = s_long + s_tol;
        if (s_sync > 0) { sync_l = s_sync - s_tol; sync_u = s_sync + s_tol; }
    } else if (s_sync <= 0) {
        one_l = 0; one_u = (s_short + s_long) / 2 + 1;
        zero_l = one_u - 1; zero_u = kIntMax;
    } else if (s_sync < s_short) {
        sync_l = 0; sync_u = (s_sync + s_short) / 2 + 1;
        one_l = sync_u - 1; one_u = (s_short + s_long) / 2 + 1;
        zero_l = one_u - 1; zero_u = kIntMax;
    } else if (s_sync < s_long) {
        one_l = 0; one_u = (s_short + s_sync) / 2 + 1;
        sync_l = one_u - 1; sync_u = (s_sync + s_long) / 2 + 1;
        zero_l = sync_u - 1; zero_u = kIntMax;
    } else {
        one_l = 0; one_u = (s_short + s_long) / 2 + 1;
        zero_l = one_u - 1; zero_u = (s_long + s_sync) / 2 + 1;
        sync_l = zero_u - 1; sync_u = kIntMax;
    }
    bits.clear();
    for (int n = 0; n < n_p; n++) {
        if (P[n] > one_l && P[n] < one_u) bits.add_bit(1);
        else if (P[n] > zero_l && P[n] < zero_u) bits.add_bit(0);
        else if (P[n] > sync_l && P[n] < sync_u) bits.add_sync();
        else if (P[n] <= one_l) { /* spurious short pulse */ }
        else bits.add_row();

        if ((n == n_p - 1 || G[n] > s_reset) && bits.num_rows > 0) {
            a.emit(idx, bits);
            bits.clear();
        } else if (s_gap > 0 && G[n] > s_gap && bits.num_rows > 0
                   && bits.bits_per_row[bits.num_rows - 1] > 0) {
            bits.add_row();
        }
    }
}

void slice_mc_zerobit(const int32_t* P, const int32_t* G, int n_p,
                      const Spec& sp, Arena& a, int idx, BitSink& bits) {
    // slicers.py:256-297 (ref src/pulse_slicer.c:451-527)
    int32_t s_short = sp.s_short, s_reset = sp.s_reset, s_tol = sp.s_tol;
    double mid = s_short * 1.5;
    int64_t time_since_last = 0;
    bits.clear();
    bits.add_bit(0);
    for (int n = 0; n < n_p; n++) {
        if (s_tol > 0
            && (P[n] < s_short - s_tol || P[n] > s_short * 2 + s_tol
                || G[n] < s_short - s_tol || G[n] > s_short * 2 + s_tol)) {
            if (P[n] > mid && P[n] <= s_short * 2 + s_tol) bits.add_bit(1);
            bits.add_row();
            bits.add_bit(0);
            time_since_last = 0;
        } else if (P[n] + time_since_last > mid) {
            bits.add_bit(1);
            time_since_last = 0;
        } else {
            time_since_last += P[n];
        }
        if ((n == n_p - 1 || G[n] > s_reset) && bits.num_rows > 0) {
            a.emit(idx, bits);
            bits.clear();
            bits.add_bit(0);
            time_since_last = 0;
        } else if (G[n] + time_since_last > mid) {
            bits.add_bit(0);
            time_since_last = 0;
        } else {
            time_since_last += G[n];
        }
    }
}

inline int32_t symbol_at(const int32_t* P, const int32_t* G, int n) {
    return (n % 2 == 0) ? P[n / 2] : G[n / 2];
}

void slice_dmc(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
               Arena& a, int idx, BitSink& bits) {
    // slicers.py:305-337 (ref src/pulse_slicer.c:537-595)
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_tol = sp.s_tol;
    bits.clear();
    int n2 = n_p * 2;
    for (int n = 0; n < n2; n++) {
        int32_t symbol = symbol_at(P, G, n);
        if (std::abs(symbol - s_short) < s_tol) {
            bits.add_bit(1);
            if (n + 1 < n2) { n += 1; symbol = symbol_at(P, G, n); }
            else symbol = 0;
            if (std::abs(symbol - s_short) > s_tol) {
                if (symbol >= s_reset - s_tol) n -= 1;
                else if (bits.num_rows > 0
                         && bits.bits_per_row[bits.num_rows - 1] > 0)
                    bits.add_row();
            }
        } else if (std::abs(symbol - s_long) < s_tol) {
            bits.add_bit(0);
        } else if (symbol >= s_reset - s_tol && bits.num_rows > 0) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_piwm_raw(const int32_t* P, const int32_t* G, int n_p,
                    const Spec& sp, Arena& a, int idx, BitSink& bits) {
    // slicers.py:340-368 (ref src/pulse_slicer.c:597-657)
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_tol = sp.s_tol;
    double f_short = sp.f_short;
    bits.clear();
    int n2 = n_p * 2;
    for (int n = 0; n < n2; n++) {
        int32_t symbol = symbol_at(P, G, n);
        int64_t w = iround64(symbol * f_short);
        __int128 dev = (__int128)symbol - (__int128)w * s_short;
        if (dev < 0) dev = -dev;
        if (symbol > s_long) {
            bits.add_row();
        } else if (dev < s_tol) {
            // bit emission saturates at the row cap; clamp the loop only
            int64_t cnt = w > 70000 ? 70000 : w;
            bits.add_run(1 - (n % 2), cnt);
        } else if (symbol < s_reset && bits.num_rows > 0
                   && bits.bits_per_row[bits.num_rows - 1] > 0) {
            bits.add_row();
        }
        if ((n == n2 - 1 || symbol > s_reset) && bits.num_rows > 0) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_piwm_dc(const int32_t* P, const int32_t* G, int n_p,
                   const Spec& sp, Arena& a, int idx, BitSink& bits) {
    // slicers.py:371-394 (ref src/pulse_slicer.c:659-713)
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_tol = sp.s_tol;
    bits.clear();
    int n2 = n_p * 2;
    for (int n = 0; n < n2; n++) {
        int32_t symbol = symbol_at(P, G, n);
        if (std::abs(symbol - s_short) < s_tol) bits.add_bit(1);
        else if (std::abs(symbol - s_long) < s_tol) bits.add_bit(0);
        else if (symbol < s_reset && bits.num_rows > 0
                 && bits.bits_per_row[bits.num_rows - 1] > 0)
            bits.add_row();
        if ((n == n2 - 1 || symbol > s_reset) && bits.num_rows > 0) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_nrzs(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
                Arena& a, int idx, BitSink& bits) {
    // slicers.py:397-419 (ref src/pulse_slicer.c:715-759)
    int32_t limit = sp.s_short, s_reset = sp.s_reset;
    bits.clear();
    for (int n = 0; n < n_p; n++) {
        if (P[n] > limit) {
            bits.add_run(1, P[n] / limit);
            bits.add_bit(0);
        } else if (P[n] < limit) {
            bits.add_bit(0);
        }
        if (n == n_p - 1 || G[n] >= s_reset) {
            a.emit(idx, bits);
            bits.clear();
        }
    }
}

void slice_osv1(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
                Arena& a, int idx, BitSink& bits) {
    // slicers.py:422-480 (ref src/pulse_slicer.c:775-864)
    int32_t s_short = sp.s_short, s_reset = sp.s_reset;
    int32_t halfbit_min = s_short / 2;
    int32_t halfbit_max = s_short * 3 / 2;
    int32_t sync_min = 2 * halfbit_max;
    bits.clear();
    int manbit = 0;
    int preamble = 0;
    int n = 0;
    for (; n < n_p; n++) {
        if (P[n] > halfbit_min && G[n] > halfbit_min) {
            preamble += 1;
            if (G[n] > halfbit_max) break;
        } else {
            return;
        }
    }
    if (preamble != 12) return;
    n += 1;
    if (n >= n_p || P[n] < sync_min || G[n] < sync_min) return;
    if (G[n] > P[n]) {
        manbit ^= 1;
        if (manbit) bits.add_bit(0);
    }
    n += 1;
    for (; n < n_p; n++) {
        manbit ^= 1;
        if (manbit) bits.add_bit(1);
        if (P[n] > halfbit_max) {
            manbit ^= 1;
            if (manbit) bits.add_bit(1);
        }
        if ((n == n_p - 1 || G[n] > s_reset) && bits.num_rows > 0) {
            a.emit(idx, bits);
            return;
        }
        manbit ^= 1;
        if (manbit) bits.add_bit(0);
        if (G[n] > halfbit_max) {
            manbit ^= 1;
            if (manbit) bits.add_bit(0);
        }
    }
}

void slice_rzi(const int32_t* P, const int32_t* G, int n_p, const Spec& sp,
               Arena& a, int idx, BitSink& bits) {
    // slicers.py:483-517 (ref src/pulse_slicer.c:866-918)
    int32_t s_short = sp.s_short, s_long = sp.s_long, s_reset = sp.s_reset;
    int32_t s_base = s_long - s_short;
    bits.clear();
    int at_start = 1;
    for (int n = 0; n < n_p; n++) {
        int32_t high = P[n];
        // Python floor-division: both branches clamp to >= 0 after, and the
        // numerator is only negative when the result is clamped anyway.
        int64_t num = at_start ? (int64_t)high + s_long / 2
                               : (int64_t)high - s_base + s_long / 2;
        int32_t ones = s_long ? (int32_t)(num >= 0 ? num / s_long : -1) : 0;
        at_start = 0;
        if (ones < 0) ones = 0;
        for (int k = 0; k < ones; k++) bits.add_bit(1);
        if (G[n] > s_reset || n == n_p - 1) {
            if (bits.bits_per_row[0] > 0) a.emit(idx, bits);
            bits.clear();
            at_start = 1;
            continue;
        }
        bits.add_bit(0);
    }
}

}  // namespace

extern "C" {

// Returns the number of events written, or -(events so far)-1 when the
// arena or summary table overflowed (caller should retry with more space or
// fall back to the host slicers).
int64_t tpu433_slice_batch(const int32_t* pulse, const int32_t* gap,
                           int32_t n_pulses, const Spec* specs,
                           int32_t n_specs, uint8_t* arena, int64_t arena_cap,
                           int32_t* summary, int64_t summary_cap_events) {
    static thread_local int64_t table[kHashSlots];
    static thread_local uint64_t table_hash[kHashSlots];
    std::memset(table, 0, sizeof(table));
    Arena a{arena, arena_cap, 0, summary, summary_cap_events, 0, false,
            table, table_hash};
    static thread_local BitSink sink;
    for (int i = 0; i < n_specs; i++) {
        const Spec& sp = specs[i];
        switch (sp.modulation) {
        case MOD_PCM: slice_pcm(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_PPM: slice_ppm(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_PWM: slice_pwm(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_MC_ZEROBIT:
            slice_mc_zerobit(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_DMC: slice_dmc(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_PIWM_RAW:
            slice_piwm_raw(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_PIWM_DC:
            slice_piwm_dc(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_NRZS: slice_nrzs(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_OSV1: slice_osv1(pulse, gap, n_pulses, sp, a, i, sink); break;
        case MOD_RZI: slice_rzi(pulse, gap, n_pulses, sp, a, i, sink); break;
        default: break;  // disabled spec
        }
        if (a.overflow) return -a.n_events - 1;
    }
    return a.n_events;
}

}  // extern "C"
