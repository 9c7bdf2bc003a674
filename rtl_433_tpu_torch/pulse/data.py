"""Pulse-train data model.

Mirrors pulse_data_t (ref include/pulse_data.h:30-50), the RSSI/SNR
estimate of a detected package (ref src/r_flow.c:35-64), the OOK text
format of ``.ook`` files (``dump``/``load_all``, ref
src/pulse_data.c:123-226), the RfRaw codec of ``-y`` (ref src/rfraw.c) and
the ``-w`` dumps of a package: U8 logic spans and VCD transitions (ref
src/pulse_data.c:58-122).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

PD_MAX_PULSES = 1200


@dataclass
class PulseData:
    pulse: List[int] = field(default_factory=list)  # widths in samples
    gap: List[int] = field(default_factory=list)
    sample_rate: int = 250_000
    offset: int = 0          # absolute sample index of first pulse
    start_ago: int = 0
    end_ago: int = 0
    depth_bits: int = 8
    ook_low_estimate: int = 0
    ook_high_estimate: int = 0
    fsk_f1_est: int = 0
    fsk_f2_est: int = 0
    freq1_hz: float = 0.0
    freq2_hz: float = 0.0
    centerfreq_hz: float = 0.0
    range_db: float = 0.0
    rssi_db: float = 0.0
    snr_db: float = 0.0
    noise_db: float = 0.0

    @property
    def num_pulses(self) -> int:
        return len(self.pulse)

    @property
    def is_fsk(self) -> bool:
        return self.fsk_f2_est != 0

    def calc_rssi_snr(self, samp_rate, center_frequency, sample_size=2,
                      use_mag_est=False):
        """Ref src/r_flow.c:35-64."""
        high = self.ook_high_estimate if self.ook_high_estimate > 0 else 1
        low = self.ook_low_estimate if self.ook_low_estimate > 0 else 1
        ook_max = min(high, 16384)
        asnr = ook_max / low
        foffs1 = self.fsk_f1_est / 32767 * samp_rate / 2.0
        foffs2 = self.fsk_f2_est / 32767 * samp_rate / 2.0
        self.freq1_hz = foffs1 + center_frequency
        self.freq2_hz = foffs2 + center_frequency
        self.centerfreq_hz = center_frequency
        self.depth_bits = sample_size * 4
        if sample_size == 2 and not use_mag_est:
            self.range_db = 42.1442
            self.rssi_db = 10.0 * math.log10(high) - 42.1442
            self.noise_db = 10.0 * math.log10(low) - 42.1442
            self.snr_db = 10.0 * math.log10(asnr)
        else:
            self.range_db = 84.2884
            self.rssi_db = 20.0 * math.log10(high) - 84.2884
            self.noise_db = 20.0 * math.log10(low) - 84.2884
            self.snr_db = 20.0 * math.log10(asnr)

    # ---- OOK text format (ref src/pulse_data.c:123-226) -------------------

    def dump(self) -> str:
        lines = []
        if self.fsk_f2_est:
            lines.append(f";fsk {self.num_pulses} pulses")
            lines.append(f";freq1 {self.freq1_hz:.0f}")
            lines.append(f";freq2 {self.freq2_hz:.0f}")
        else:
            lines.append(f";ook {self.num_pulses} pulses")
            lines.append(f";freq1 {self.freq1_hz:.0f}")
        lines.append(f";centerfreq {self.centerfreq_hz:.0f} Hz")
        lines.append(f";samplerate {self.sample_rate} Hz")
        lines.append(f";sampledepth {self.depth_bits} bits")
        lines.append(f";range {self.range_db:.1f} dB")
        lines.append(f";rssi {self.rssi_db:.1f} dB")
        lines.append(f";snr {self.snr_db:.1f} dB")
        lines.append(f";noise {self.noise_db:.1f} dB")
        to_us = 1e6 / self.sample_rate
        for p, g in zip(self.pulse, self.gap):
            lines.append(f"{p * to_us:.0f} {g * to_us:.0f}")
        lines.append(";end")
        return "\n".join(lines) + "\n"

    @classmethod
    def load_all(cls, text: str, sample_rate: int = 250_000):
        """Parse an OOK text file (possibly multiple packages)."""
        out = []
        cur = None
        to_sample = sample_rate / 1e6
        freq1 = freq2 = 0.0
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith(";"):
                if line.startswith(";freq1"):
                    freq1 = float(line[6:].split()[0])
                elif line.startswith(";freq2"):
                    freq2 = float(line[6:].split()[0])
                elif line.startswith(";end") and cur is not None:
                    cur.freq1_hz, cur.freq2_hz = freq1, freq2
                    if freq2:
                        cur.fsk_f2_est = 1  # marks FSK
                    out.append(cur)
                    cur = None
                    freq1 = freq2 = 0.0
                continue
            if rfraw_check(line):
                pd = rfraw_parse(line, sample_rate)
                if pd:
                    out.append(pd)
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                mark, space = int(float(parts[0])), int(float(parts[1]))
            except ValueError:
                continue
            if mark < 0 or space < 0:
                continue
            if cur is None:
                cur = cls(sample_rate=sample_rate)
            cur.pulse.append(int(to_sample * mark))
            cur.gap.append(int(to_sample * space))
        if cur is not None and cur.pulse:
            out.append(cur)
        return out


# ---------------------------------------------------------------------------
# RfRaw (Tasmota/Portisch "AA B1 ..." strings, ref src/rfraw.c)

def _hexstr_get_byte(s, pos):
    try:
        return int(s[pos[0]:pos[0] + 2], 16)
    except ValueError:
        return None


def rfraw_check(line: str) -> bool:
    """Ref src/rfraw.c rfraw_check: 'AA B1' or 'AA B0' prefix."""
    t = line.replace(" ", "").upper()
    return t.startswith("AAB1") or t.startswith("AAB0")


def rfraw_parse(line: str, sample_rate: int = 250_000):
    """Parse a B1/B0 RfRaw hex string into a PulseData (ref src/rfraw.c).

    Format B1: AA B1 <nbuckets> <bucket0_hi bucket0_lo>... <data nibbles> 55
    Data nibbles: high nibble 8|bucket = pulse, low nibble = gap bucket;
    repeated nibbles alternate pulse/gap by position (bit3 set = pulse).
    """
    t = line.replace(" ", "").upper()
    if not rfraw_check(t):
        return None
    pos = 4
    repeats = 1
    if t.startswith("AAB0"):
        # AA B0 <len> <nbuckets> <repeats> ...
        pos = 6  # skip length byte
        try:
            nbuck = int(t[pos:pos + 2], 16)
            repeats = int(t[pos + 2:pos + 4], 16)
        except ValueError:
            return None
        pos += 4
    else:
        try:
            nbuck = int(t[pos:pos + 2], 16)
        except ValueError:
            return None
        pos += 2
    if nbuck > 8:
        return None
    buckets = []
    for _ in range(nbuck):
        try:
            buckets.append(int(t[pos:pos + 4], 16))
        except ValueError:
            return None
        pos += 4
    to_samples = sample_rate / 1e6
    pd = PulseData(sample_rate=sample_rate)
    pulse_w = gap_w = 0
    expect_pulse = True
    while pos < len(t) - 1:
        nib = t[pos]
        pos += 1
        if nib == "5" and t[pos:pos + 1] == "5":
            break
        try:
            v = int(nib, 16)
        except ValueError:
            break
        width = buckets[v & 7] if (v & 7) < len(buckets) else 0
        w = int(width * to_samples)
        if v & 8:  # pulse (mark)
            if not expect_pulse:
                # two marks in a row: close previous pair with zero gap
                pd.pulse.append(pulse_w)
                pd.gap.append(0)
            pulse_w = w
            expect_pulse = False
        else:      # gap (space)
            if expect_pulse:
                pulse_w = 0
            gap_w = w
            pd.pulse.append(pulse_w)
            pd.gap.append(gap_w)
            expect_pulse = True
    if not expect_pulse:
        pd.pulse.append(pulse_w)
        pd.gap.append(0)
    if repeats > 1:
        base_p, base_g = list(pd.pulse), list(pd.gap)
        for _ in range(repeats - 1):
            pd.pulse.extend(base_p)
            pd.gap.extend(base_g)
    return pd if pd.pulse else None


def pulse_data_dump_raw(buf, buf_offset: int, pd: "PulseData",
                        bits: int) -> None:
    """Mark pulse/gap spans into a per-block U8 logic buffer
    (ref src/pulse_data.c:58-67): ``0x01|bits`` over pulses, ``0x01``
    over gaps, clipped to the buffer bounds. ``bits``: 0x02 OOK, 0x04 FSK.
    """
    n = len(buf)
    pos = int(pd.offset) - int(buf_offset)
    for p, g in zip(pd.pulse, pd.gap):
        lo = max(pos, 0)
        hi = min(pos + int(p), n)
        if hi > lo:
            buf[lo:hi] = 0x01 | bits
        pos += int(p)
        lo = max(pos, 0)
        hi = min(pos + int(g), n)
        if hi > lo:
            buf[lo:hi] = 0x01
        pos += int(g)


def pulse_data_print_vcd_header(file, sample_rate: int) -> None:
    """VCD header (ref src/pulse_data.c:77-101). Channel ids: '/' FRAME,
    ``'`` AM (OOK), ``"`` FM (FSK)."""
    import time as _t
    timescale = "1 us" if sample_rate <= 500000 else "100 ns"
    stamp = _t.strftime("%Y-%m-%d %H:%M:%S", _t.localtime())
    file.write("$date %s $end\n" % stamp)
    file.write("$version rtl_433 0.1.0 $end\n")
    # nice_freq formatting (ref src/r_util.c:290-305)
    if sample_rate >= 1e9:
        nice = "%.3fGHz" % (sample_rate / 1e9)
    elif sample_rate >= 1e6:
        nice = "%.3fMHz" % (sample_rate / 1e6)
    elif sample_rate >= 1e3:
        nice = "%.3fkHz" % (sample_rate / 1e3)
    else:
        nice = "%.0f" % sample_rate
    file.write("$comment Acquisition at %s Hz $end\n" % nice)
    file.write("$timescale %s $end\n" % timescale)
    file.write("$scope module rtl_433 $end\n")
    file.write("$var wire 1 / FRAME $end\n")
    file.write("$var wire 1 ' AM $end\n")
    file.write("$var wire 1 \" FM $end\n")
    file.write("$upscope $end\n")
    file.write("$enddefinitions $end\n")
    file.write("#0 0/ 0' 0\"\n")


def pulse_data_print_vcd(file, pd: "PulseData", ch_id: str) -> None:
    """One package as VCD transitions (ref src/pulse_data.c:103-122)."""
    rate = pd.sample_rate or 250_000
    scale = (1000000 / rate) if rate <= 500000 else (10000000 / rate)
    pos = int(pd.offset)
    for n, (p, g) in enumerate(zip(pd.pulse, pd.gap)):
        if n == 0:
            file.write("#%.f 1/ 1%s\n" % (pos * scale, ch_id))
        else:
            file.write("#%.f 1%s\n" % (pos * scale, ch_id))
        pos += int(p)
        file.write("#%.f 0%s\n" % (pos * scale, ch_id))
        pos += int(g)
    if len(pd.pulse):
        file.write("#%.f 0/\n" % (pos * scale))
