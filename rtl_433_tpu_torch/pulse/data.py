"""Pulse-train data model.

Mirrors pulse_data_t (ref include/pulse_data.h:30-50) and the RSSI/SNR
estimate of a detected package (ref src/r_flow.c:35-64). The OOK text and
RfRaw codecs are not ported yet.
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
