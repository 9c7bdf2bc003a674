"""Library API: config lifecycle, the block flow, event fan-out.

The Python equivalent of r_api.c / r_flow.c: owns the detector params and
state, the protocol registry and the output sinks; drives IQ blocks through
the engine on ``device`` and routes published packages through slicers +
decoders to events (ref src/r_flow.c:104-372, src/r_api.c:632-839).

This slice carries file replay (``-r``) and ``[C, N, 2]`` multi-channel
blocks through ``push_block``, the ``-y`` test-string entry point
(``decode_test_string``), the noise floor (squelch, ``-M noise`` reports and
autolevel, from channel 0's block level), and the body of the ``-M stats``
report (``stats_report``, ``flush_report_data``) over the frame and
per-decoder counters. Live input, dumpers, raw taps, the sample grabber
(``-S``), the pulse analyzer (``-A``) and SigMF are not ported yet and raise
when asked for; the stats report's interval trigger and CLI flag are not
ported yet.
"""

from __future__ import annotations

import functools
import os
import time as _time
from typing import List, Optional

import numpy as np
import torch

from .decoders import Registry
from .dsp import baseband
from .dsp.engine import (DetectorParams, PKG_FSK, detector_init,
                         process_block, take_packages)
from .io import load_iq, parse_filename
from .ops._cuda import resolve_device
from .output.data_model import Event, convert_units
from .output.logger import LOG_ERROR, LOG_NOTICE, LOG_WARNING, print_logf
from .pulse import slicers as _slicers
from .pulse.data import PulseData, rfraw_check, rfraw_parse

DEFAULT_BUF_SAMPLES = 131072   # 256 KiB cu8 (ref include/sdr.h:17)
FSK_PULSE_DETECTOR_LIMIT = 800_000_000  # ref include/rtl_433.h:18


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class RtlTpu:
    """One receiver flow (single- or multi-channel) on one device."""

    def __init__(self, sample_rate: int = 250_000,
                 center_frequency: float = 433_920_000.0,
                 fsk_mode: str = "auto",          # auto|classic|minmax
                 use_mag_est: bool = False,
                 convert: str = "native",         # native|si|customary
                 report_meta: bool = False,
                 report_protocol: bool = False,
                 report_time: str = "off",        # off|samples|iso
                 channels: int = 1,
                 analyze: bool = False,
                 register_all: bool = True,
                 report_time_hires: bool = False,
                 report_time_utc: bool = False,
                 report_time_tz: bool = False,
                 fixed_level_db: float = 0.0,
                 min_level_db: float = -12.1442,
                 min_snr_db: float = 9.0,
                 squelch: bool = False,
                 report_noise: int = 0,
                 auto_level: int = 0,
                 verbosity: int = 0,
                 device_slice: bool = False,
                 fm_filter: float = 0.0,
                 gain_db: Optional[float] = None,
                 ppm_error: int = 0,
                 verbose_bits: bool = False,
                 device="cuda"):
        if analyze:
            _not_ported("the pulse analyzer (-A)")
        if report_time not in ("off", "samples", "iso"):
            _not_ported(f"report_time={report_time!r}")
        # gain_db, ppm_error, verbosity, verbose_bits and report_time_tz are
        # accepted for the JAX package's signature; nothing of file replay
        # reads them yet
        self.device = resolve_device(device)
        self.fm_filter = float(fm_filter)
        self.sample_rate = int(sample_rate)
        self.center_frequency = float(center_frequency)
        self.fsk_mode = fsk_mode
        self.use_mag_est = use_mag_est
        self.convert = convert
        self.report_meta = report_meta
        self.report_protocol = report_protocol
        self.report_time = report_time
        self.report_time_hires = report_time_hires
        self.report_time_utc = report_time_utc
        self.channels = channels
        self.fixed_level_db = fixed_level_db
        self.min_level_db = min_level_db
        self.min_snr_db = min_snr_db

        self.registry = Registry()
        if device_slice or os.environ.get("TPU433_DEVICE_SLICE") == "1":
            # every drain's trains are sliced on this receiver's device
            # (Registry.prewarm_trains), then dispatched from the memo
            self.registry.device_slice = True
            self.registry.slice_device = self.device
        if register_all:
            self.registry.register_all()
        self.events: List[Event] = []
        self.sinks = []
        self._current_file = None
        self._state = None
        self._params = None
        self._stream_pos = 0
        # per-decoder stats live on RDevice (account_event equivalent);
        # the frame counters and their start time feed stats_report
        self.frames_count = 0
        self.frames_events = 0
        # noise tracking / squelch (ref src/r_flow.c:166-194)
        self.squelch = squelch
        self.report_noise = int(report_noise)
        self.auto_level = int(auto_level)
        self.min_level_auto = min_level_db
        self.noise_level = 0.0
        self.total_frames_squelch = 0
        self._last_noise_report = 0
        self._frames_since = _time.time()

    # -- config ---------------------------------------------------------------

    def _invalidate(self):
        self._state = None
        self._params = None

    def _reset_flow(self):
        """reset_sdr_flow equivalent: clear carried DSP/detector state
        between input files (ref src/r_flow.c:79-97)."""
        if self._params is not None:
            self._state = detector_init(self._params, self.channels,
                                        self.device)
            self._ovf_seen = 0
            self._drop_seen = 0
        self._stream_pos = 0

    def _relevel(self):
        """Apply the autolevel-adjusted minimum level (pulse_detect_set_levels
        equivalent, ref src/pulse_detect.c:86-105). The level is the state's
        "min_high" tensor, so a retune is one device write."""
        if self._params is None or self._state is None:
            return
        p = self._params._replace(min_high_level=self.min_level_auto)
        self._params = p
        self._state = dict(
            self._state,
            min_high=torch.full_like(self._state["min_high"],
                                     p.ook_min_high_level))

    @property
    def fsk_minmax(self) -> bool:
        """-Y auto resolves by frequency (ref src/rtl_433.c:1094-1102)."""
        if self.fsk_mode == "minmax":
            return True
        if self.fsk_mode == "classic":
            return False
        return self.center_frequency > FSK_PULSE_DETECTOR_LIMIT

    def _ensure_pipeline(self):
        if self._params is None:
            # FM demod runs only when an FSK decoder is registered
            # (ref src/rtl_433.c:1516-1526)
            enable_fm = any(d.is_fsk for d in self.registry.active)
            self._params = DetectorParams(
                sample_rate=self.sample_rate,
                use_mag_est=self.use_mag_est,
                fsk_minmax=self.fsk_minmax,
                enable_fm=enable_fm,
                fixed_high_level=(-abs(self.fixed_level_db)
                                  if self.fixed_level_db else 0.0),
                min_high_level=self.min_level_auto,
                high_low_ratio=self.min_snr_db,
                fm_low_pass=self.fm_filter,
                chunk=128,
                ring=8,
                eops=2,
                # file replay / few-channel runs can finish more than 8
                # packages per block on one channel (the reference has no
                # such cap); many channels keep the small cap, since the
                # out buffers scale with C * pkg_cap * max_pulses
                pkg_cap=32 if self.channels <= 16 else 8)
            self._state = detector_init(self._params, self.channels,
                                        self.device)
            # loss counters already surfaced (push_block warns on deltas)
            self._ovf_seen = 0
            self._drop_seen = 0
            self._stream_pos = 0

    # -- block flow -------------------------------------------------------------

    def push_block(self, iq: np.ndarray, flush: bool = False):
        """Feed CU8 [N, 2] (single channel) or [C, N, 2] samples."""
        self._ensure_pipeline()
        if iq.ndim == 2:
            iq = iq[None]
        C, N, _ = iq.shape
        # pad to the standard block size (padded samples are masked no-ops,
        # so every block has the one shape of the JAX package's path)
        target = DEFAULT_BUF_SAMPLES if N <= DEFAULT_BUF_SAMPLES else (
            N + (-N) % self._params.chunk)
        pad = target - N
        if pad:
            iq = np.pad(iq, ((0, 0), (0, pad), (0, 0)), constant_values=128)
        # full blocks need no tail masking
        n_valid = None if pad == 0 else N
        x = torch.from_numpy(np.ascontiguousarray(iq)).to(self.device)
        noise = self.squelch or self.report_noise or self.auto_level
        # squelch: skip noise-only frames entirely in live mode; frames are
        # always processed for file replay (ref src/r_flow.c:166-176)
        must_process = bool(self._current_file)
        if noise and not must_process:
            noise_only = self._track_noise(self._block_avg_db(x))
            if self.squelch and noise_only:
                self.total_frames_squelch += 1
                self.frames_count += 1
                self._stream_pos += N
                return 0
        self._state, avg_db = process_block(self._params, self._state, x,
                                            n_valid, flush=flush)
        if noise and must_process:
            self._track_noise(float(avg_db[0]))
        pkgs, self._state = take_packages(self._state)
        # any capacity overflow is loud: records/packages must never
        # vanish silently
        ovf_ring, ovf_fsk, drop = (
            int(v) for v in torch.stack([
                self._state["n_ring_ovf"].sum(),
                self._state["n_fsk_ovf"].sum(),
                self._state["n_pkg_drop"].sum()]).cpu())
        ovf = ovf_ring + ovf_fsk
        if ovf > self._ovf_seen or drop > self._drop_seen:
            print_logf(
                LOG_ERROR, "engine",
                "capacity overflow: %d pulse records and %d packages lost "
                "this block (totals: ring/arena ovf %d, pkg drops %d) — "
                "raise DetectorParams.arena/pkg_cap or narrow the block",
                ovf - self._ovf_seen, drop - self._drop_seen, ovf, drop)
            self._ovf_seen, self._drop_seen = ovf, drop
        events = 0
        self.frames_count += 1
        if self.registry.device_slice and pkgs:
            # one batched kernel pass slices every new train in this drain
            self.registry.prewarm_trains(
                [(pkg["type"] == PKG_FSK, pkg["pulse"], pkg["gap"])
                 for pkg in pkgs], self.sample_rate)
        for pkg in pkgs:
            events += self._handle_package(pkg, N)
        if events:
            self.frames_events += 1
        self._stream_pos += N
        return events

    def _block_avg_db(self, x) -> float:
        """Mean block level in dB for channel 0 (squelch prescreen)."""
        fn = (baseband.magnitude_est_cu8 if self.use_mag_est
              else baseband.envelope_detect_cu8)
        return float(fn(x[:1])[1][0])

    def _track_noise(self, avg_db: float) -> bool:
        """Noise EWMA + periodic -M noise report (ref src/r_flow.c:166-194).

        Returns True when the frame is noise-only.
        """
        if self.noise_level == 0.0:
            self.noise_level = self.min_level_auto - 3.0
        noise_only = avg_db < self.noise_level + 3.0
        if noise_only:
            self.noise_level = (self.noise_level * 7 + avg_db) / 8
            # -Y autolevel: track the noise floor down/up with min level
            # (ref src/r_flow.c:179-186)
            if (self.auto_level > 0
                    and self.noise_level < self.min_level_db - 3.0
                    and abs(self.min_level_auto - self.noise_level - 3.0)
                    > 1.0):
                self.min_level_auto = self.noise_level + 3.0
                print_logf(LOG_WARNING, "Auto Level",
                           "Estimated noise level is %.1f dB, adjusting "
                           "minimum detection level to %.1f dB",
                           self.noise_level, self.min_level_auto)
                self._relevel()
        else:
            self.noise_level = (self.noise_level * 31 + avg_db) / 32
        if self.report_noise:
            now = int(_time.time())
            if (now != self._last_noise_report
                    and now % self.report_noise == 0):
                self._last_noise_report = now
                print_logf(LOG_NOTICE, "Auto Level",
                           "Current %s level %.1f dB, estimated noise "
                           "%.1f dB",
                           "noise" if noise_only else "signal", avg_db,
                           self.noise_level)
        return noise_only

    def _handle_package(self, pkg: dict, block_len: int) -> int:
        pd = PulseData(
            pulse=pkg["pulse"].tolist(),
            gap=pkg["gap"].tolist(),
            sample_rate=self.sample_rate,
            offset=self._stream_pos + pkg["start"],
            ook_low_estimate=pkg["ook_low_estimate"],
            ook_high_estimate=pkg["ook_high_estimate"],
            fsk_f1_est=pkg["fsk_f1_est"],
            fsk_f2_est=pkg["fsk_f2_est"])
        pd.calc_rssi_snr(self.sample_rate, self.center_frequency,
                         sample_size=2, use_mag_est=self.use_mag_est)
        is_fsk = pkg["type"] == PKG_FSK
        cb = functools.partial(self._event_cb, pd=pd, is_fsk=is_fsk)
        if is_fsk:
            return self.registry.run_fsk_demods(pd, cb)
        return self.registry.run_ook_demods(pd, cb)

    def _event_cb(self, dev, ev: Event, pd=None, is_fsk=False):
        """data_acquired_handler equivalent (ref src/r_api.c:632-839)."""
        if self.convert != "native":
            ev = convert_units(ev, self.convert)
        if self.report_protocol and dev.num:
            ev.prepend(("protocol", dev.num, "Protocol"))
        if self.report_meta:
            if is_fsk:
                ev.append(("mod", "FSK", "Modulation"),
                          ("freq1", pd.freq1_hz / 1e6, "Freq1", "%.1f MHz"),
                          ("freq2", pd.freq2_hz / 1e6, "Freq2", "%.1f MHz"),
                          ("rssi", pd.rssi_db, "RSSI", "%.1f dB"),
                          ("snr", pd.snr_db, "SNR", "%.1f dB"),
                          ("noise", pd.noise_db, "Noise", "%.1f dB"))
            else:
                ev.append(("mod", "ASK", "Modulation"),
                          ("freq", pd.freq1_hz / 1e6, "Freq", "%.1f MHz"),
                          ("rssi", pd.rssi_db, "RSSI", "%.1f dB"),
                          ("snr", pd.snr_db, "SNR", "%.1f dB"),
                          ("noise", pd.noise_db, "Noise", "%.1f dB"))
        if self.report_time != "off":
            ev.prepend(("time", self._time_string(
                pd.offset if pd is not None else None)))
        self.events.append(ev)
        for sink in self.sinks:
            sink(ev)

    def _time_string(self, offset_samples=None):
        """time_pos_str equivalent (ref src/r_api.c:306-332): file replay
        stamps the stream position ("@%fs", ref src/r_util.c:153-156)."""
        if self.report_time == "samples":
            pos = self._stream_pos if offset_samples is None \
                else offset_samples
            return f"@{pos / self.sample_rate:f}s"
        now = _time.time()
        tm = (_time.gmtime(now) if self.report_time_utc
              else _time.localtime(now))
        ts = _time.strftime("%Y-%m-%d %H:%M:%S", tm)
        if self.report_time_hires:
            ts += f".{int(now % 1 * 1e6):06d}"
        return ts

    def stats_report(self, level: int = 1) -> Event:
        """-M stats interval report (ref create_report_data,
        src/r_api.c:843-899): per-decoder event/ok/fail counters.
        level >= 2 includes decoders without events."""
        stats = []
        for dev in self.registry.active:
            if dev.decode_events == 0 and level < 2:
                continue
            fails = [(f"abort_{k}" if k.startswith(("length", "early"))
                      else k, v) for k, v in dev.decode_fails.items()]
            stats.append(Event.make(
                ("device", dev.num),
                ("name", dev.name),
                ("events", dev.decode_events),
                ("ok", dev.decode_ok),
                ("messages", dev.decode_messages),
                *[(k, v) for k, v in fails],
            ))
        return Event.make(
            ("time", _time.strftime("%Y-%m-%d %H:%M:%S")),
            ("enabled", len(self.registry.active)),
            ("since", int(_time.time() - self._frames_since)),
            ("frames", Event.make(
                ("count", self.frames_count),
                ("squelched", self.total_frames_squelch),
                ("events", self.frames_events))),
            ("stats", stats),
        )

    def flush_report_data(self):
        """Reset the stats counters after a report
        (ref flush_report_data, src/r_api.c:901-922)."""
        self._frames_since = _time.time()
        self.frames_count = 0
        self.frames_events = 0
        self.total_frames_squelch = 0
        for dev in self.registry.active:
            dev.decode_events = 0
            dev.decode_ok = 0
            dev.decode_messages = 0
            dev.decode_fails = {}

    # -- entry points -------------------------------------------------------

    def decode_file(self, path: str) -> List[Event]:
        """-r equivalent: replay a sample file (ref src/rtl_433.c:1688-1866)."""
        if self.report_time == "iso":
            self.report_time = "samples"  # file mode defaults to @position
        self._current_file = path
        if path.lower().endswith(".sigmf"):
            _not_ported("SigMF input")
        info = parse_filename(path)
        if info.sample_rate and info.sample_rate != self.sample_rate:
            self.sample_rate = info.sample_rate
            self._invalidate()
        if info.center_frequency and \
                info.center_frequency != self.center_frequency:
            self.center_frequency = info.center_frequency
            self._invalidate()
        iq = load_iq(info.path, info.format or "cu8")
        self._reset_flow()
        start = len(self.events)
        n = iq.shape[0]
        for pos in range(0, max(n, 1), DEFAULT_BUF_SAMPLES):
            blk = iq[pos: pos + DEFAULT_BUF_SAMPLES]
            if blk.shape[0] == 0:
                break
            self.push_block(blk, flush=pos + DEFAULT_BUF_SAMPLES >= n)
        return self.events[start:]

    def decode_test_string(self, code: str) -> List[Event]:
        """-y equivalent (ref src/rtl_433.c:1576-1685): RfRaw pulse strings
        run the demods; {n}hex codes feed every decoder directly."""
        start = len(self.events)
        if rfraw_check(code):
            pd = rfraw_parse(code, self.sample_rate)
            if pd:
                cb = functools.partial(self._event_cb, pd=pd,
                                       is_fsk=pd.fsk_f2_est != 0)
                pd.calc_rssi_snr(self.sample_rate, self.center_frequency)
                if pd.fsk_f2_est:
                    self.registry.run_fsk_demods(pd, cb)
                else:
                    self.registry.run_ook_demods(pd, cb)
            return self.events[start:]
        dummy_pd = PulseData(sample_rate=self.sample_rate)
        for dev in self.registry.active:
            for bits in _slicers.slicer_string(code):
                ret = dev.decode_fn(bits, dev) if dev.decode_fn else 0
                for ev in dev.account(ret):
                    self._event_cb(dev, ev, pd=dummy_pd, is_fsk=dev.is_fsk)
        return self.events[start:]

    def run_live(self, *args, **kwargs):
        _not_ported("live input")
