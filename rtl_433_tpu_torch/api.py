"""Library API: config lifecycle, the block flow, event fan-out.

The Python equivalent of r_api.c / r_flow.c: owns the detector params and
state, the protocol registry and the output sinks; drives IQ blocks through
the engine on ``device`` and routes published packages through slicers +
decoders, and the pulse analyzer (``-A``), to events, tagged by the data
taggers (``-K``) (ref src/r_flow.c:104-372, src/r_api.c:632-839).

It carries file replay (``-r``: cu8/cs8/cs16/cf32 samples, SigMF archives,
``.ook`` pulse text, ``-M replay`` pacing), live input over rtl_tcp
(``run_live``: the ingest ring, the watchdog, hopping, ``-E``/``-T``/``-n``,
SIGHUP/SIGUSR1/SIGUSR2, the retune setters) and ``[C, N, 2]`` multi-channel
blocks through ``push_block``, with the IQ taps of the block loop (the raw
taps of ``-F rtltcp``, the ``-S`` grabber, the ``-w`` dumpers, whose am/fm
streams are the front end's own outputs), the ``-y`` test-string entry
point (``decode_test_string``), the noise floor (squelch, ``-M noise``
reports and autolevel, from channel 0's block level), the ``-M stats``
reports (interval and on-demand, ``_maybe_interval_stats``), the ``-M
time`` formats, and the log fan-out through the sinks
(``redirect_logging``) with the decoder and pulse debug dumps of ``-v``.

The block loop, and so every CUDA call, runs on the caller's thread; live
input's producer thread and watchdog timer touch no tensor. A retune from
another thread (the HTTP server's control verbs, through ``retuning``)
waits on ``lock``, which ``push_block`` holds for the whole block: it
applies from the next block, and no block runs under two sets of
parameters.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time as _time
from typing import List, Optional

import numpy as np
import torch

from .decoders import Registry
from .dsp import baseband
from .dsp.engine import (DetectorParams, PKG_FSK, detector_init, preload,
                         process_block, take_packages)
from .io import load_iq, parse_filename
from .ops._cuda import resolve_device
from .output.data_model import Event, convert_units
from .output.logger import (LOG_ERROR, LOG_NOTICE, LOG_TRACE, LOG_WARNING,
                            print_logf)
from .pulse import slicers as _slicers
from .pulse.analyzer import analyze_pulses
from .pulse.data import (PulseData, pulse_data_dump_raw, rfraw_check,
                         rfraw_parse)

DEFAULT_BUF_SAMPLES = 131072   # 256 KiB cu8 (ref include/sdr.h:17)
FSK_PULSE_DETECTOR_LIMIT = 800_000_000  # ref include/rtl_433.h:18


class RtlTpu:
    """One receiver flow (single- or multi-channel) on one device."""

    def __init__(self, sample_rate: int = 250_000,
                 center_frequency: float = 433_920_000.0,
                 fsk_mode: str = "auto",          # auto|classic|minmax
                 use_mag_est: bool = False,
                 convert: str = "native",         # native|si|customary
                 report_meta: bool = False,
                 report_protocol: bool = False,
                 report_time: str = "off",        # off|iso|unix
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
        self.device = resolve_device(device)
        # held by push_block for a whole block and by every setter that
        # writes receiver state (retuning); re-entrant, since a setter may
        # run inside a block on the consumer's thread
        self.lock = threading.RLock()
        # retunes waiting for the lock; a block waits for them before it
        # starts, so that the lock's unfairness cannot let the consumer
        # run a second block ahead of a retune made during the first
        self._turn = threading.Condition()
        self._retunes = 0
        self.fm_filter = float(fm_filter)   # -Y filter= (us/Hz/ratio)
        self.gain_db = gain_db              # -g, applied to rtl_tcp tuner
        self.ppm_error = int(ppm_error)     # -p, applied to rtl_tcp tuner
        self.verbosity = verbosity
        # log verbosity in logger levels: default LOG_WARNING, each -v
        # steps one level up (ref src/r_api.c:127, src/rtl_433.c:509)
        self.log_verbosity = 4 + int(verbosity)
        self.verbose_bits = bool(verbose_bits)   # -M bits
        self.analyze = analyze                   # -A
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
        self.report_time_tz = report_time_tz
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
        # -vv enables decode-success bitbuffer logs, -vvv/-vvvv more
        # (ref src/r_api.c:263 p->verbose derivation)
        self.registry.decoder_verbose = max(0, int(verbosity) - 1)
        self.registry.verbose_bits = bool(verbose_bits)
        if register_all:
            self.registry.register_all()
        self.events: List[Event] = []
        self.sinks = []
        self.dumpers = []       # io.grab.Dumper list (-w)
        self.raw_taps = []      # raw CU8 block callbacks (-F rtltcp,
                                # ref include/raw_output.h)
        self.samp_grab = None   # io.grab.SampGrab (-S)
        self.taggers = []       # output.network.DataTagger list (-K)
        self._logic_buf = None  # the -w U8:LOGIC buffer of the block
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
        # -M stats[:level][:interval] + on-demand reports
        # (ref src/rtl_433.c:785-788, :1155-1164)
        self.report_stats = 0
        self.stats_interval = 600
        self.stats_now = 0
        self._stats_time = None
        self._frames_since = _time.time()
        # -M replay[:N]: realtime (N-times) file replay pacing
        # (ref src/delay_timer.c, src/rtl_433.c:1803-1810)
        self.in_replay = 0

    # -- config ---------------------------------------------------------------

    def set_frequency(self, hz: float):
        """Retune: pipeline params AND the live radio, when one is
        connected (ref set_center_freq, src/r_api.c:82-89)."""
        with self.retuning():
            if float(hz) != self.center_frequency:
                self.center_frequency = float(hz)
                self._invalidate()
            self._tune("set_center_freq", int(self.center_frequency))

    def set_sample_rate(self, rate: int):
        """(ref set_sample_rate, src/r_api.c:91-99)"""
        with self.retuning():
            if int(rate) != self.sample_rate:
                self.sample_rate = int(rate)
                self._invalidate()
            self._tune("set_sample_rate", self.sample_rate)

    def set_gain(self, db):
        """Tuner gain in dB; None/"auto"/"" = tuner AGC. Reaches the live
        rtl_tcp tuner immediately (ref set_gain_str, src/r_api.c:101-115)."""
        with self.retuning():
            self.gain_db = None if db in (None, "", "auto") else float(db)
            if self.gain_db is None:
                self._tune("set_gain_mode", 0)
            else:
                self._tune("set_gain", int(round(self.gain_db * 10)))

    def set_ppm_error(self, ppm):
        """Tuner frequency correction (-p), applied live (ref -p handling
        + sdr_set_freq_correction, src/sdr.c:1224)."""
        with self.retuning():
            self.ppm_error = int(ppm)
            self._tune("set_freq_correction", self.ppm_error)

    def set_hop_interval(self, seconds):
        """Replace the hop cadence used by the live loop (-H equivalent,
        ref src/http_server.c hop_interval verb)."""
        with self.retuning():
            self._hop_times = [max(1, int(seconds))]

    @contextlib.contextmanager
    def retuning(self):
        """Hold ``lock`` to write receiver state: a retune waits for the
        block in flight, and the next block waits for it, so it applies
        from that block on."""
        with self._turn:
            self._retunes += 1
        try:
            with self.lock:
                yield
        finally:
            with self._turn:
                self._retunes -= 1
                self._turn.notify_all()

    def _tune(self, command: str, *args):
        """Send a retune to the connected rtl_tcp server, if any. A stream
        that is ending takes none and raises nothing: its client is
        stopped before its socket closes, and the receiver keeps the value
        for the next connection."""
        live = getattr(self, "_live", None)
        if live is None:
            return
        try:
            getattr(live, command)(*args)
        except OSError:
            if not live._stop.is_set():
                raise

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
        """Feed CU8 [N, 2] (single channel) or [C, N, 2] samples. Holds
        ``lock`` for the whole block, after any retune already waiting."""
        with self._turn:
            self._turn.wait_for(lambda: not self._retunes)
        with self.lock:
            return self._push_block(iq, flush)

    def _push_block(self, iq: np.ndarray, flush: bool):
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
        iq0 = iq[0, :N]
        for tap in self.raw_taps:
            tap(iq0)
        if self.samp_grab is not None:
            self.samp_grab.push(iq0)
        # filtered am/fm streams for -w dumpers (ref src/r_flow.c:439-455):
        # channel 0's front-end outputs, handed back by process_block
        streams = any(d.wants_streams for d in self.dumpers)
        self._logic_buf = (np.zeros(N, np.uint8)
                           if any(d.wants_logic for d in self.dumpers)
                           else None)
        x = torch.from_numpy(np.ascontiguousarray(iq)).to(self.device)
        noise = self.squelch or self.report_noise or self.auto_level
        # squelch: skip noise-only frames entirely in live mode; frames are
        # always processed for file replay, dumpers, the grabber or the
        # analyzer (ref src/r_flow.c:166-176)
        must_process = bool(self._current_file or self.dumpers
                            or self.samp_grab is not None or self.analyze)
        if noise and not must_process:
            noise_only = self._track_noise(self._block_avg_db(x))
            if self.squelch and noise_only:
                self.total_frames_squelch += 1
                self.frames_count += 1
                self._stream_pos += N
                self._maybe_interval_stats()
                return 0
        self._state, avg_db, *am_fm = process_block(
            self._params, self._state, x, n_valid, flush=flush,
            streams=streams)
        am_f, fm_f = am_fm[0] if streams else (None, None)
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
        for dumper in self.dumpers:
            dumper.push(iq0, am=am_f, fm=fm_f, logic=self._logic_buf)
        self._logic_buf = None
        self._stream_pos += N
        self._maybe_interval_stats()
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
        if self._logic_buf is not None:
            pulse_data_dump_raw(self._logic_buf, self._stream_pos, pd,
                                0x04 if is_fsk else 0x02)
        # per-package text dumpers (ref src/r_flow.c:265-276, :308-319)
        for dumper in self.dumpers:
            if dumper.format == "ook":
                dumper.write_pulses(pd)
            elif dumper.format == "vcd":
                dumper.write_vcd(pd, is_fsk)
        if self.verbosity >= 3:
            # verbosity-gated pulse-train dump (ref src/r_flow.c:279-281
            # LOG_TRACE package print, src/pulse_data.c:193 text format)
            kind = "FSK" if is_fsk else "OOK"
            print_logf(LOG_TRACE, "pulse_data",
                       "%s package, %d pulses, rssi %.1f dB snr %.1f dB "
                       "@%d", kind, len(pd.pulse), pd.rssi_db, pd.snr_db,
                       pd.offset)
            if self.verbosity >= 4:
                for i in range(len(pd.pulse)):
                    print_logf(LOG_TRACE, "pulse_data",
                               "[%4d] pulse %5d gap %5d",
                               i, pd.pulse[i], pd.gap[i])
        cb = functools.partial(self._event_cb, pd=pd, is_fsk=is_fsk)
        if is_fsk:
            n = self.registry.run_fsk_demods(pd, cb)
        else:
            n = self.registry.run_ook_demods(pd, cb)
        if self.analyze:
            # after the decoders, as in the JAX package: the analyzer
            # writes the last gap of this package's own PulseData
            analyze_pulses(pd, pkg["type"])
        return n

    def _event_cb(self, dev, ev: Event, pd=None, is_fsk=False):
        """data_acquired_handler equivalent (ref src/r_api.c:632-839)."""
        if self.convert != "native":
            ev = convert_units(ev, self.convert)
        for tagger in self.taggers:
            ev = tagger(ev)
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
        """Format the current time per -M time config (time_pos_str
        equivalent, ref src/r_api.c:306-332)."""
        if self.report_time == "samples":
            # file replay: position-based time (ref src/r_util.c:153-156,
            # src/r_api.c:306-310 "@%fs")
            pos = self._stream_pos if offset_samples is None \
                else offset_samples
            return f"@{pos / self.sample_rate:f}s"
        # -M time:unix|iso[:usec][:utc][:tz] (ref src/r_api.c:306-332)
        now = _time.time()
        tm = (_time.gmtime(now) if self.report_time_utc
              else _time.localtime(now))
        if self.report_time == "unix":
            return (f"{int(now)}.{int(now % 1 * 1e6):06d}"
                    if self.report_time_hires else str(int(now)))
        # "iso8601" = -M time:iso (T separator); the default
        # ("iso" legacy value) is the reference's date format
        fmt = ("%Y-%m-%dT%H:%M:%S" if self.report_time == "iso8601"
               else "%Y-%m-%d %H:%M:%S")
        ts = _time.strftime(fmt, tm)
        if self.report_time_hires:
            ts += f".{int(now % 1 * 1e6):06d}"
        if self.report_time_tz:
            # "+0000" collapses to "Z" (ref src/r_util.c:120-126)
            tzs = "+0000" if self.report_time_utc \
                else _time.strftime("%z", tm)
            ts += "Z" if tzs == "+0000" else tzs
        return ts

    def redirect_logging(self):
        """Fan print_log messages out through the output sinks as
        src/lvl/msg events, gated by the global log verbosity and each
        sink's ``log_level`` (ref log_handler + r_redirect_logging,
        src/r_api.c:554-589; per-sink gate include/data.h:191). Call
        after the sinks are configured; reset with
        ``logger.set_log_handler(None)``."""
        from .output import logger as _logger

        def fan_out(level, ev):
            if self.report_time != "off":
                ev.prepend(("time", self._time_string()))
            for sink in self.sinks:
                if getattr(sink, "log_level", 0) >= level:
                    sink(ev)

        def handler(level, src, msg):
            if self.log_verbosity < level:
                return
            fan_out(level, Event.make(("src", src), ("lvl", level),
                                      ("msg", msg)))

        # structured decoder logs skip the verbosity gate: the decoder's
        # own verbose gate already ran (ref log_device_handler :610-630)
        _logger.set_log_handler(handler, fan_out)
        return handler

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

    def _maybe_interval_stats(self):
        """Interval (-M stats:l:s) and on-demand (``stats_now``; live
        input's SIGUSR2) stats reports, checked once per frame and emitted
        as events through every sink (ref src/rtl_433.c:1155-1164)."""
        if not (self.stats_now or (self.report_stats
                                   and self.stats_interval)):
            return
        now = _time.time()
        if self._stats_time is None:
            self._stats_time = now + self.stats_interval
        due = self.report_stats and now >= self._stats_time
        if not (self.stats_now or due):
            return
        ev = self.stats_report(3 if self.stats_now else self.report_stats)
        for sink in self.sinks:
            sink(ev)
        self.flush_report_data()
        if due:
            self._stats_time += self.stats_interval
        if self.stats_now:
            self.stats_now -= 1

    # -- entry points -------------------------------------------------------

    def decode_file(self, path: str) -> List[Event]:
        """-r equivalent: replay a sample file (ref src/rtl_433.c:1688-1866)."""
        if self.report_time == "iso":
            self.report_time = "samples"  # file mode defaults to @position
        self._current_file = path
        if path.lower().endswith(".sigmf"):
            from .io import sigmf
            info_s = sigmf.read(path)
            if info_s.sample_rate and info_s.sample_rate != self.sample_rate:
                self.sample_rate = info_s.sample_rate
                self._invalidate()
            if info_s.frequency and \
                    float(info_s.frequency) != self.center_frequency:
                self.center_frequency = float(info_s.frequency)
                self._invalidate()
            iq = info_s.data
        else:
            info = parse_filename(path)
            if info.sample_rate and info.sample_rate != self.sample_rate:
                self.sample_rate = info.sample_rate
                self._invalidate()
            if info.center_frequency and \
                    info.center_frequency != self.center_frequency:
                self.center_frequency = info.center_frequency
                self._invalidate()
            fmt = info.format or "cu8"
            if fmt == "ook":
                return self.decode_ook_file(info.path)
            iq = load_iq(info.path, fmt)
        self._reset_flow()
        start = len(self.events)
        n = iq.shape[0]
        # -M replay[:N]: pace blocks against a wall-clock schedule at
        # N-times realtime (ref delay_timer_wait, src/delay_timer.c;
        # src/rtl_433.c:1803-1810)
        deadline = _time.monotonic()
        for pos in range(0, max(n, 1), DEFAULT_BUF_SAMPLES):
            blk = iq[pos: pos + DEFAULT_BUF_SAMPLES]
            if blk.shape[0] == 0:
                break
            if self.in_replay:
                deadline += blk.shape[0] / (self.sample_rate
                                            * self.in_replay)
                wait = deadline - _time.monotonic()
                if wait > 0:
                    _time.sleep(wait)
            self.push_block(blk, flush=pos + DEFAULT_BUF_SAMPLES >= n)
        return self.events[start:]

    def decode_ook_file(self, path: str) -> List[Event]:
        """Replay an OOK text pulse file (ref src/rtl_433.c:1755-1794)."""
        start = len(self.events)
        with open(path) as f:
            text = f.read()
        for pd in PulseData.load_all(text, self.sample_rate):
            cb = functools.partial(self._event_cb, pd=pd, is_fsk=pd.is_fsk)
            if pd.is_fsk:
                self.registry.run_fsk_demods(pd, cb)
            else:
                self.registry.run_ook_demods(pd, cb)
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
                sliced = bits.clone()
                ret = dev.decode_fn(bits, dev) if dev.decode_fn else 0
                events = dev.account(ret)
                for ev in events:
                    self._event_cb(dev, ev, pd=dummy_pd, is_fsk=dev.is_fsk)
                self.registry.maybe_log_bitbuffer(dev, sliced, bool(events))
        return self.events[start:]

    def run_live(self, device: str = "rtl_tcp:localhost:1234",
                 max_blocks: Optional[int] = None,
                 block_samples: int = DEFAULT_BUF_SAMPLES,
                 run_mode: str = "quit", frequencies=None, hop_times=None,
                 after_events: Optional[str] = None,
                 duration: Optional[float] = None,
                 watchdog_interval: float = 1.5) -> int:
        """Live receive loop over rtl_tcp with supervision (the
        analogue of start_sdr + acquire loop + timer_handler,
        ref src/rtl_433.c:1284, :1352-1425, src/sdr.c:1718).

        - ``run_mode`` (-D): quit | restart | pause | manual — action when
          the stream stalls (no frame for a watchdog interval past grace).
        - ``frequencies``/``hop_times`` (-f/-H): hop over the frequency
          list every hop_times[i] seconds (last entry repeats),
          SIGUSR1 hops immediately (ref src/rtl_433.c:1165-1177).
        - ``after_events`` (-E): "quit" or "hop" after a successful event
          (ref src/rtl_433.c:1136-1143).
        - ``duration`` (-T): stop after this many seconds.

        Returns the number of events decoded; ``self.exit_code`` is 3
        after a stall-quit (ref src/rtl_433.c:1412). Blocks are decoded on
        this thread; the client's producer thread fills its ingest ring
        (``io/native.py``) and a timer thread runs the watchdog.
        """
        from .io.rtltcp import RtlTcpClient
        spec = device.split(":")
        if spec[0] != "rtl_tcp":
            raise ValueError(f"unsupported device: {device}")
        host = spec[1] if len(spec) > 1 and spec[1] else "localhost"
        port = int(spec[2]) if len(spec) > 2 else 1234
        freqs = [int(f) for f in (frequencies or [self.center_frequency])]
        # instance state so the HTTP hop_interval verb can retime hopping
        # mid-run (set_hop_interval)
        self._hop_times = list(hop_times or [600])
        start = len(self.events)
        if self.report_time == "off":
            self.report_time = "iso"
        self.exit_code = 0
        self._watchdog = 0
        self._dev_state = "starting"   # starting|grace|started|stopped
        self._hop_now = False
        self._exit_async = False
        freq_index = 0
        hop_start = _time.monotonic()
        t_end = None if duration is None else _time.monotonic() + duration

        self._install_live_signals()
        self._prepare_live()

        def connect():
            cli = RtlTcpClient(host, port, block_samples=block_samples)
            cli.connect()
            cli.set_sample_rate(self.sample_rate)
            cli.set_center_freq(freqs[freq_index])
            if self.gain_db is not None:     # -g (ref src/sdr.c gain set)
                cli.set_gain(int(round(self.gain_db * 10)))
            if self.ppm_error:               # -p
                cli.set_freq_correction(self.ppm_error)
            self._dev_state = "starting"
            self._watchdog = 0
            return cli

        def watchdog_tick():
            """Stall detection state machine (ref src/rtl_433.c:1366-1421)."""
            if getattr(self, "_sig_hup", False):
                self._sig_hup = False
                for d in self.dumpers:
                    try:
                        d.file.flush()
                    except OSError:
                        pass
            if self._watchdog != 0:
                self._dev_state = "started"
                self._watchdog = 0
                return
            if self._dev_state == "starting":
                self._dev_state = "grace"
                return
            # stalled (grace with no first frame, or started and dried up)
            print_logf(LOG_WARNING, "Input device",
                       "stream stalled (%s), %s"
                       % ("no frames" if self._dev_state == "grace"
                          else "ran out of frames", run_mode))
            self._dev_state = "stopped"
            self.exit_code = 3
            if run_mode == "quit":
                self._exit_async = True
            self._live.stop()

        def on_block(iq):
            nonlocal freq_index, hop_start
            self._watchdog += 1
            before = len(self.events)
            self.push_block(iq)
            got = len(self.events) - before
            if after_events and got > 0:
                if after_events == "quit":
                    self._exit_async = True
                    self._live.stop()
                else:
                    self._hop_now = True
            now = _time.monotonic()
            if t_end is not None and now >= t_end:
                self._exit_async = True
                self._live.stop()
            hops = self._hop_times
            hop_index = min(freq_index, len(hops) - 1)
            if len(freqs) > 1 and now - hop_start >= hops[hop_index]:
                self._hop_now = True
            if getattr(self, "_sig_hop", False):
                self._sig_hop = False
                self._hop_now = True
            if self._hop_now and not self._exit_async:
                self._hop_now = False
                hop_start = now
                freq_index = (freq_index + 1) % len(freqs)
                self.center_frequency = float(freqs[freq_index])
                self._live.set_center_freq(freqs[freq_index])

        import threading
        while True:
            try:
                self._live = connect()
            except (OSError, ConnectionError):
                self.exit_code = 3
                break
            stop_timer = threading.Event()

            def timer_loop():
                while not stop_timer.wait(watchdog_interval):
                    watchdog_tick()

            timer = threading.Thread(target=timer_loop, daemon=True)
            timer.start()
            try:
                self._live.run(on_block, max_blocks=max_blocks)
            finally:
                stop_timer.set()
                timer.join(timeout=2 * watchdog_interval)
            if self._exit_async or max_blocks is not None:
                break
            if self._dev_state == "stopped" and run_mode == "restart":
                continue  # reconnect (ref start_sdr restart path)
            break
        self._live = None
        return len(self.events) - start

    def _prepare_live(self):
        """The block loop's one-time loads, before the stream starts: the
        engine's state on the device (and so the CUDA context), the path's
        kernel libraries, the host slicer library and the declarative
        runner. Loaded at the first block instead, they held it up on the
        card for nearly as long as the ring's 15 blocks last at 1.024 MS/s
        (PERF.md §6). Changes no output."""
        self._ensure_pipeline()
        preload(self.device)
        self.registry.preload()

    def _install_live_signals(self):
        """SIGHUP reopen + SIGUSR1 hop (ref src/rtl_433.c:1036-1070);
        no-op off the main thread or on platforms without the signals."""
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            return
        self._sig_hup = False
        self._sig_hop = False
        try:
            signal.signal(signal.SIGHUP,
                          lambda *_: setattr(self, "_sig_hup", True))
            signal.signal(signal.SIGUSR1,
                          lambda *_: setattr(self, "_sig_hop", True))
            # on-demand stats: the reference binds BSD SIGINFO (absent on
            # Linux, ref src/rtl_433.c:1047 "TODO: maybe SIGUSR1");
            # SIGUSR1 already hops, so SIGUSR2 fills that role here
            signal.signal(signal.SIGUSR2,
                          lambda *_: setattr(self, "stats_now",
                                             self.stats_now + 1))
        except (ValueError, AttributeError, OSError):
            pass

    def stop_live(self):
        self._exit_async = True
        if getattr(self, "_live", None):
            self._live.stop()
