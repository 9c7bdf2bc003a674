"""Pulse analyzer (`-A`): tolerance-clustered histograms, modulation guess,
flex-spec hint and demod attempt (ref src/pulse_analyzer.c)."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List

MAX_HIST_BINS = 16
TOLERANCE = 0.2


@dataclass
class Bin:
    count: int = 0
    sum: int = 0
    mean: int = 0
    min: int = 0
    max: int = 0


@dataclass
class Histogram:
    """Tolerance-clustered histogram (ref src/pulse_analyzer.c:23-66)."""
    bins: List[Bin] = field(default_factory=list)

    def add(self, data, tolerance=TOLERANCE):
        for v in data:
            v = int(v)
            for b in self.bins:
                if abs(v - b.mean) < tolerance * max(v, b.mean):
                    b.count += 1
                    b.sum += v
                    b.mean = b.sum // b.count if b.count else 0
                    b.min = min(v, b.min)
                    b.max = max(v, b.max)
                    break
            else:
                if len(self.bins) < MAX_HIST_BINS:
                    self.bins.append(Bin(1, v, v, v, v))

    def fuse(self, tolerance=TOLERANCE):
        """ref :130-154."""
        n = 0
        while n < len(self.bins) - 1:
            m = n + 1
            while m < len(self.bins):
                bn, bm = self.bins[n], self.bins[m]
                if abs(bn.mean - bm.mean) < tolerance * max(bn.mean, bm.mean):
                    bn.count += bm.count
                    bn.sum += bm.sum
                    bn.mean = bn.sum // bn.count
                    bn.min = min(bn.min, bm.min)
                    bn.max = max(bn.max, bm.max)
                    del self.bins[m]
                else:
                    m += 1
            n += 1

    def sort_mean(self):
        self.bins.sort(key=lambda b: b.mean)

    def sort_count(self):
        self.bins.sort(key=lambda b: b.count)

    def find_bin_index(self, width):
        for i, b in enumerate(self.bins):
            if b.min <= width <= b.max:
                return i
        return -1

    def print(self, samp_rate, out):
        for n, b in enumerate(self.bins):
            print(" [%2u] count: %4u,  width: %4.0f us [%.0f;%.0f]\t(%4i S)"
                  % (n, b.count, b.mean * 1e6 / samp_rate,
                     b.min * 1e6 / samp_rate, b.max * 1e6 / samp_rate,
                     b.mean), file=out)


def _histograms(pd):
    num = len(pd.pulse)
    periods_pg = [pd.pulse[n] + pd.gap[n] for n in range(num)]
    periods_gp = [pd.pulse[0]] + [pd.pulse[n] + pd.gap[n - 1]
                                  for n in range(1, num)]
    h_pulses, h_gaps = Histogram(), Histogram()
    h_pg, h_gp, h_timings = Histogram(), Histogram(), Histogram()
    h_pulses.add(pd.pulse)
    h_gaps.add(pd.gap[:num - 1])
    h_pg.add(periods_pg[:num - 1])
    h_gp.add(periods_gp)
    h_timings.add(pd.pulse)
    h_timings.add(pd.gap)
    h_pulses.fuse()
    h_gaps.fuse()
    h_pg.fuse()
    h_timings.fuse()
    return h_pulses, h_gaps, h_pg, h_gp, h_timings


def analyzer_check(pd) -> bool:
    """pulse_analyzer_check equivalent (ref src/pulse_analyzer.c:213-273):
    True when the frame looks like real data."""
    if not len(pd.pulse):
        return False
    h_pulses, h_gaps, _, _, _ = _histograms(pd)
    h_pulses.sort_mean()
    h_gaps.sort_mean()
    if h_pulses.bins and h_pulses.bins[0].mean == 0:
        del h_pulses.bins[0]
    if len(pd.pulse) == 1:
        return False
    if len(h_pulses.bins) == 1 and len(h_gaps.bins) == 1:
        return False
    return True


def _rfraw_hint(pd, h_timings, h_gaps, to_us, out):
    """RfRaw B1/B0 hint output (ref src/pulse_analyzer.c:441-519)."""
    if len(h_timings.bins) > 8:
        return
    num = len(pd.pulse)
    if len(h_gaps.bins) <= 2:
        parts = ["AA", "B1", "%02X" % len(h_timings.bins)]
        for b in h_timings.bins:
            w = max(0, int(b.mean * to_us))
            parts.append("%04X" % min(w, 0xFFFF))
        ok = True
        for i in range(num):
            p = h_timings.find_bin_index(pd.pulse[i])
            g = h_timings.find_bin_index(pd.gap[i])
            if p < 0 or g < 0:
                ok = False
                break
            parts.append("%02X" % (0x80 | (p << 4) | g))
        parts.append("55")
        if ok:
            print("view at https://triq.org/pdv/#" +
                  "".join(parts).replace(" ", ""), file=out)
    else:
        limit_bin = min(3, len(h_gaps.bins) - 1)
        limit = h_gaps.bins[limit_bin].min
        groups = []
        i = 0
        while i < num and len(groups) < 32:
            body = []
            while i < num:
                p = h_timings.find_bin_index(pd.pulse[i])
                g = h_timings.find_bin_index(pd.gap[i])
                if p < 0 or g < 0:
                    return
                body.append(0x80 | (p << 4) | g)
                if pd.gap[i] >= limit:
                    i += 1
                    break
                i += 1
            if groups and groups[-1][0] == body:
                groups[-1][1] += 1
            else:
                groups.append([body, 1])
        bins_hex = "".join("%04X" % min(max(0, int(b.mean * to_us)), 0xFFFF)
                           for b in h_timings.bins)
        strs = []
        for body, repeats in groups:
            length = 1 + 2 * len(h_timings.bins) + len(body) + 1
            s = "AAB0%02X%02X%02X" % (length & 0xFF, len(h_timings.bins),
                                      repeats)
            s += bins_hex + "".join("%02X" % x for x in body) + "55"
            strs.append(s)
        print("view at https://triq.org/pdv/#" + "+".join(strs), file=out)


def analyze_pulses(pd, package_type, registry=None, event_cb=None,
                   out=None):
    """pulse_analyzer equivalent (ref src/pulse_analyzer.c:276-560):
    prints distributions, guesses a modulation + timings, emits a flex
    hint, and attempts a demod with the synthesized device."""
    from ..decoders.base import RDevice
    from . import slicers

    out = out or sys.stderr
    num = len(pd.pulse)
    if num == 0:
        print("No pulses detected.", file=out)
        return

    to_ms = 1e3 / pd.sample_rate
    to_us = 1e6 / pd.sample_rate
    total = sum(pd.pulse) + sum(pd.gap) - pd.gap[num - 1]
    h_pulses, h_gaps, h_pg, h_gp, h_timings = _histograms(pd)

    print("Analyzing pulses...", file=out)
    print("Total count: %4u,  width: %4.2f ms\t\t(%5i S)"
          % (num, total * to_ms, total), file=out)
    print("Pulse width distribution:", file=out)
    h_pulses.print(pd.sample_rate, out)
    print("Gap width distribution:", file=out)
    h_gaps.print(pd.sample_rate, out)
    print("Pulse+gap period distribution:", file=out)
    h_pg.print(pd.sample_rate, out)
    print("Gap+pulse period distribution:", file=out)
    h_gp.print(pd.sample_rate, out)
    print("Timing distribution:", file=out)
    h_timings.print(pd.sample_rate, out)
    print("Level estimates [high, low]: %6i, %6i"
          % (pd.ook_high_estimate, pd.ook_low_estimate), file=out)
    print("RSSI: %.1f dB SNR: %.1f dB Noise: %.1f dB"
          % (pd.rssi_db, pd.snr_db, pd.noise_db), file=out)
    print("Frequency offsets [F1, F2]:  %6i, %6i\t(%+.1f kHz, %+.1f kHz)"
          % (pd.fsk_f1_est, pd.fsk_f2_est,
             pd.fsk_f1_est / 32767 * (pd.sample_rate / 2.0 / 1000.0),
             pd.fsk_f2_est / 32767 * (pd.sample_rate / 2.0 / 1000.0)),
          file=out)

    print("Guessing modulation: ", file=out, end="")
    dev = RDevice(name="Analyzer Device", verbose=2)
    is_fsk = package_type == 2
    h_pulses.sort_mean()
    h_gaps.sort_mean()
    if h_pulses.bins and h_pulses.bins[0].mean == 0:
        del h_pulses.bins[0]

    np_, ng = len(h_pulses.bins), len(h_gaps.bins)
    if num == 1:
        print("Single pulse detected. Probably Frequency Shift Keying "
              "or just noise...", file=out)
    elif np_ == 1 and ng == 1:
        print("Un-modulated signal. Maybe a preamble...", file=out)
    elif np_ == 1 and ng > 1:
        print("Pulse Position Modulation with fixed pulse width", file=out)
        dev.modulation = "OOK_PULSE_PPM"
        dev.short_width = to_us * h_gaps.bins[0].mean
        dev.long_width = to_us * h_gaps.bins[1].mean
        dev.gap_limit = to_us * (h_gaps.bins[1].max + 1)
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    elif np_ == 2 and ng == 1:
        print("Pulse Width Modulation with fixed gap", file=out)
        dev.modulation = "FSK_PULSE_PWM" if is_fsk else "OOK_PULSE_PWM"
        dev.short_width = to_us * h_pulses.bins[0].mean
        dev.long_width = to_us * h_pulses.bins[1].mean
        dev.tolerance = (dev.long_width - dev.short_width) * 0.4
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    elif np_ == 2 and ng == 2 and len(h_pg.bins) == 1:
        print("Pulse Width Modulation with fixed period", file=out)
        dev.modulation = "FSK_PULSE_PWM" if is_fsk else "OOK_PULSE_PWM"
        dev.short_width = to_us * h_pulses.bins[0].mean
        dev.long_width = to_us * h_pulses.bins[1].mean
        dev.tolerance = (dev.long_width - dev.short_width) * 0.4
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    elif np_ == 2 and ng == 2 and len(h_pg.bins) == 3:
        print("Manchester coding", file=out)
        dev.modulation = "FSK_PULSE_MANCHESTER_ZEROBIT" if is_fsk \
            else "OOK_PULSE_MANCHESTER_ZEROBIT"
        dev.short_width = to_us * min(h_pulses.bins[0].mean,
                                      h_pulses.bins[1].mean)
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    elif np_ == 2 and ng >= 3:
        print("Pulse Width Modulation with multiple packets", file=out)
        dev.modulation = "FSK_PULSE_PWM" if is_fsk else "OOK_PULSE_PWM"
        dev.short_width = to_us * h_pulses.bins[0].mean
        dev.long_width = to_us * h_pulses.bins[1].mean
        dev.gap_limit = to_us * (h_gaps.bins[1].max + 1)
        dev.tolerance = (dev.long_width - dev.short_width) * 0.4
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    elif (np_ >= 3 and ng >= 3
            and abs(h_pulses.bins[1].mean - 2 * h_pulses.bins[0].mean)
            <= h_pulses.bins[0].mean // 8
            and abs(h_pulses.bins[2].mean - 3 * h_pulses.bins[0].mean)
            <= h_pulses.bins[0].mean // 8
            and abs(h_gaps.bins[0].mean - h_pulses.bins[0].mean)
            <= h_pulses.bins[0].mean // 8
            and abs(h_gaps.bins[1].mean - 2 * h_pulses.bins[0].mean)
            <= h_pulses.bins[0].mean // 8
            and abs(h_gaps.bins[2].mean - 3 * h_pulses.bins[0].mean)
            <= h_pulses.bins[0].mean // 8):
        print("Non Return to Zero coding (Pulse Code)", file=out)
        dev.modulation = "FSK_PULSE_PCM" if is_fsk else "OOK_PULSE_PCM"
        dev.short_width = to_us * h_pulses.bins[0].mean
        dev.long_width = to_us * h_pulses.bins[0].mean
        dev.reset_limit = to_us * h_pulses.bins[0].mean * 1024
    elif np_ == 3:
        print("Pulse Width Modulation with sync/delimiter", file=out)
        h_pulses.sort_count()
        p1 = h_pulses.bins[1].mean
        p2 = h_pulses.bins[2].mean
        dev.modulation = "FSK_PULSE_PWM" if is_fsk else "OOK_PULSE_PWM"
        dev.short_width = to_us * min(p1, p2)
        dev.long_width = to_us * max(p1, p2)
        dev.sync_width = to_us * h_pulses.bins[0].mean
        dev.reset_limit = to_us * (h_gaps.bins[-1].max + 1)
    else:
        print("No clue...", file=out)

    _rfraw_hint(pd, h_timings, h_gaps, to_us, out)

    if dev.modulation:
        print("Attempting demodulation... short_width: %.0f, "
              "long_width: %.0f, reset_limit: %.0f, sync_width: %.0f"
              % (dev.short_width, dev.long_width, dev.reset_limit,
                 dev.sync_width), file=out)
        flex_mod = dev.modulation.replace("OOK_PULSE_", "OOK_") \
            .replace("FSK_PULSE_", "FSK_") \
            .replace("MANCHESTER_ZEROBIT", "MC_ZEROBIT")
        if dev.modulation.endswith("PCM"):
            print("Use a flex decoder with -X 'n=name,m=%s,s=%.0f,l=%.0f,"
                  "r=%.0f'" % (flex_mod, dev.short_width, dev.long_width,
                               dev.reset_limit), file=out)
        elif dev.modulation.endswith("PPM"):
            print("Use a flex decoder with -X 'n=name,m=%s,s=%.0f,l=%.0f,"
                  "g=%.0f,r=%.0f'" % (flex_mod, dev.short_width,
                                      dev.long_width, dev.gap_limit,
                                      dev.reset_limit), file=out)
            pd.gap[num - 1] = int(dev.reset_limit / to_us + 1)
        elif dev.modulation.endswith("PWM"):
            print("Use a flex decoder with -X 'n=name,m=%s,s=%.0f,l=%.0f,"
                  "r=%.0f,g=%.0f,t=%.0f,y=%.0f'"
                  % (flex_mod, dev.short_width, dev.long_width,
                     dev.reset_limit, dev.gap_limit, dev.tolerance,
                     dev.sync_width), file=out)
            pd.gap[num - 1] = int(dev.reset_limit / to_us + 1)
        elif dev.modulation.endswith("ZEROBIT"):
            print("Use a flex decoder with -X 'n=name,m=%s,s=%.0f,l=%.0f,"
                  "r=%.0f'" % (flex_mod, dev.short_width, dev.long_width,
                               dev.reset_limit), file=out)
            pd.gap[num - 1] = int(dev.reset_limit / to_us + 1)
        # attempt a demod with the synthesized device
        for bits in slicers.slice_pulses(pd, dev):
            print("bitbuffer: " + repr(bits), file=out)
    print("", file=out)
