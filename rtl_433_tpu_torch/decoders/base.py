"""Protocol decoder framework: RDevice specs, registry, demod dispatch.

Mirrors the reference registry/dispatch semantics (ref src/r_api.c:235-302
register/unregister, :438-550 priority-ordered demod loops) and the
r_device contract (ref include/r_device.h:45-92). Decode functions are
Python callables ``fn(bits: BitBuffer, device: RDevice) -> list[Event] | int``
returning events or a negative DECODE_* code.

The registry numbering (1..384) is the `-R <n>` contract (ref
include/rtl_433_devices.h DEVICES X-macro). Timing/metadata for all 378
protocols comes from registry_data.json, and every one has a decode
function (the decoder modules imported by ``decoders/__init__.py``).
Dispatch is the JAX package's default path: ``_run_fast`` slices a package
against every timing spec in one call of the host slicer library
(pulse/native_slicers.py), gates, deduplicates and caches the decode calls
and runs the declarative decoders as one batch (decoders/declarative.py).
``_run_host`` (slicer, then decoder, per device) is taken only where the
JAX package takes it by design: under decoder debug verbosity, or where a
caller makes ``_use_native`` return False. With ``device_slice`` on,
``prewarm_trains`` slices a drain's trains on ``slice_device`` in batched
kernels (decoders/device_dispatch.py) and fills the train memo before the
packages are dispatched. Under decoder debug verbosity ``_run_host``
logs each sliced bitbuffer (``maybe_log_bitbuffer``), as in the JAX
package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..pulse import slicers

# decode return codes (ref include/r_device.h:45-53)
DECODE_FAIL_OTHER = 0
DECODE_ABORT_LENGTH = -1
DECODE_ABORT_EARLY = -2
DECODE_FAIL_MIC = -3
DECODE_FAIL_SANITY = -4

DECODE_CODE_NAMES = {
    0: "other", -1: "abort_length", -2: "abort_early",
    -3: "fail_mic", -4: "fail_sanity",
}


@dataclass
class RDevice:
    """Decoder spec (ref include/r_device.h:59-92)."""
    num: int = 0
    symbol: str = ""
    name: str = ""
    modulation: str = ""
    short_width: float = 0.0
    long_width: float = 0.0
    sync_width: float = 0.0
    gap_limit: float = 0.0
    reset_limit: float = 0.0
    tolerance: float = 0.0
    priority: int = 0
    disabled: int = 0
    fields: List[str] = field(default_factory=list)
    arg: Optional[str] = None  # -R <num>:<arg> decoder argument
    decode_fn: Optional[Callable] = None
    ref_file: str = ""
    verbose: int = 0
    # stats (ref account_event, src/pulse_slicer.c:34-47)
    decode_events: int = 0
    decode_ok: int = 0
    decode_messages: int = 0
    decode_fails: dict = field(default_factory=dict)

    @property
    def is_fsk(self) -> bool:
        return self.modulation.startswith("FSK_")

    def account(self, ret):
        self.decode_events += 1
        if isinstance(ret, list):
            if ret:
                self.decode_ok += 1
                self.decode_messages += len(ret)
            else:
                self.decode_fails["other"] = self.decode_fails.get("other", 0) + 1
            return ret
        # negative code
        name = DECODE_CODE_NAMES.get(ret, "other")
        self.decode_fails[name] = self.decode_fails.get(name, 0) + 1
        return []


_DECODERS: dict = {}


def decoder(*symbols):
    """Decorator registering a decode function for registry symbol(s)."""
    def wrap(fn):
        for s in symbols:
            _DECODERS[s] = fn
        return fn
    return wrap


def _load_registry_data():
    path = os.path.join(os.path.dirname(__file__), "registry_data.json")
    with open(path) as f:
        return json.load(f)


# Decoders that keep cross-call state on the device (rolling-code caches,
# discovered keys): per-package decode deduplication must not skip their
# calls. ARG_STATEFUL decoders are stateful only when configured with a
# -R <num>:<arg> argument (their context is otherwise empty/pure).
STATEFUL_DECODERS = {"ikea_sparsnas", "blueline", "secplus_v1", "secplus_v2"}
ARG_STATEFUL_DECODERS = {"vivint", "arad_ms_meter"}

_MISS = object()

_decl_syms_cache = None


def _decl_symbols():
    global _decl_syms_cache
    if _decl_syms_cache is None:
        from .declarative import DECL
        _decl_syms_cache = frozenset(DECL)
    return _decl_syms_cache


def _mic_representatives(devs, meta, summary, group_of):
    """The record offsets of a device-sliced train whose bytes
    ``Registry._memo_plans`` reads for its MIC gates: of each content
    group of the live (gate-passing), non-stateful rows, the first row's
    offset, where its spec has a MIC gate. A group holds one spec, so one
    priority: grouping the rows of all priorities at once gives the
    representatives the per-priority grouping of ``_memo_plans`` picks."""
    import numpy as np
    from .mic_gates import MIC_GATES

    spec_col = summary[:, 0]
    gated = ((summary[:, 2] < meta["min_rows"][spec_col])
             | (summary[:, 3] < meta["min_bits"][spec_col])
             | (summary[:, 2] > meta["max_rows"][spec_col]))
    has_mic = np.array([MIC_GATES.get(d.symbol) is not None for d in devs],
                       bool)
    rows = np.flatnonzero(~gated & ~meta["stateful"][spec_col]
                          & has_mic[spec_col])
    _keys, first = np.unique(group_of[rows], return_index=True)
    return summary[rows[first], 1].tolist()


class Registry:
    """Protocol registry with rtl_433 -R semantics."""

    def __init__(self):
        self.slots: List[Optional[RDevice]] = [None]  # 1-based
        for e in _load_registry_data():
            if e.get("placeholder"):
                self.slots.append(None)
                continue
            dev = RDevice(
                num=e["num"], symbol=e["symbol"], name=e["name"],
                modulation=e["modulation"], short_width=e["short_width"],
                long_width=e["long_width"], sync_width=e["sync_width"],
                gap_limit=e["gap_limit"], reset_limit=e["reset_limit"],
                tolerance=e["tolerance"], priority=e["priority"],
                disabled=e["disabled"], fields=list(e["fields"]),
                decode_fn=_DECODERS.get(e["symbol"]), ref_file=e["file"])
            self.slots.append(dev)
        self.active: List[RDevice] = []
        # bumped on every change of the active set
        self._version = 0
        self._banks: dict = {}
        # cross-package decode cache: (dev_idx, record bytes) -> decode
        # result. Sensors repeat identical frames; pure decoders are
        # deterministic, so byte-identical bitbuffers decode identically.
        # Stateful decoders (STATEFUL_DECODERS) never enter this cache.
        self._dec_cache: dict = {}
        self._dec_cache_version = -1
        self.dec_cache_max = 65536
        # train memo: (fsk, rate, pulse bytes, gap bytes) -> slicing summary
        # + gating/dedup dispatch plan (pure content functions; see
        # _build_train_memo)
        self._train_cache: dict = {}
        self.train_cache_max = 4096
        # opt-in device-kernel slicing (decoders/device_dispatch.py):
        # prewarm_trains() batch-slices a drain's packages on
        # ``slice_device`` and pre-fills the train-memo cache. Whoever
        # turns it on sets the device: RtlTpu its own, ShardedEngine its
        # mesh's first device.
        self.device_slice = False
        self.slice_device = "cuda"
        self._device_banks: dict = {}
        # decoder debug verbosity (-vv.. => 1..3): any level takes the
        # per-decoder host path, as in the JAX package, whose bitbuffer
        # dumps (ref account_event src/pulse_slicer.c:58-60) carry the row
        # bit strings under -M bits
        self.decoder_verbose = 0
        self.verbose_bits = False
        # declarative decoder bank (decoders/declarative.py): batched
        # decode for spec'd protocols; Python decode_fns stay the
        # differential oracle and the fallback
        self.decl_decode = True

    def __len__(self):
        return sum(1 for d in self.slots if d is not None)

    def get(self, num: int) -> Optional[RDevice]:
        return self.slots[num] if 0 < num < len(self.slots) else None

    def register_all(self, max_disabled_level: int = 0):
        """register_all_protocols (ref src/r_api.c:294-302): register every
        protocol with disabled <= level (default: only enabled-by-default)."""
        for dev in self.slots:
            if dev is not None and dev.disabled <= max_disabled_level:
                self.active.append(dev)
        self._version += 1

    def register(self, num: int, arg: Optional[str] = None):
        dev = self.get(num)
        if dev is None:
            raise ValueError(f"protocol {num} is not available")
        if arg is not None:
            dev.arg = arg
        self.active.append(dev)
        self._version += 1
        return dev

    def unregister(self, num: int):
        self.active = [d for d in self.active if d.num != num]
        self._version += 1

    def add_device(self, dev: RDevice):
        """Register a dynamically-created decoder (flex)."""
        self.active.append(dev)
        self._version += 1

    def implemented(self):
        return [d for d in self.slots if d is not None and d.decode_fn]

    # -- demod dispatch (ref src/r_api.c:438-550) ---------------------------

    def _run(self, pulses, want_fsk: bool, event_cb):
        """Dispatch a pulse package to every matching decoder.

        Uses the native batch-slicer fast path (one C call slices all
        timing specs, content-deduplicated; decode calls are gated and
        deduplicated). Both paths produce identical events in identical
        order (tests/test_torch_fast_dispatch.py). Device slicing
        (``prewarm_trains``) fills the same fast path's train memo. Unlike
        the JAX package, nothing here catches an error of the fast path: a
        slicer library that does not build raises instead of quietly taking
        the far slower host path.
        """
        if (self._use_native() or self.device_slice) \
                and not self._verbose_decoding():
            return self._run_fast(pulses, want_fsk, event_cb)
        return self._run_host(pulses, want_fsk, event_cb)

    def _verbose_decoding(self) -> bool:
        """Decoder debug logging wants the exact per-decoder host path:
        the fast path gates/dedups/caches decode calls, so per-call
        bitbuffer dumps would be incomplete there."""
        return self.decoder_verbose > 0 or \
            any(d.verbose for d in self.active)

    def _use_native(self) -> bool:
        from ..pulse import native_slicers
        return native_slicers.available()

    def preload(self) -> None:
        """Load the fast path's host slicer library and lower the
        declarative runner's tables ahead of the first package."""
        if self._use_native():
            from .declarative import get_runner
            get_runner()

    def _run_host(self, pulses, want_fsk: bool, event_cb):
        p_events = 0
        priority = 0
        while True:
            next_priority = None
            for dev in self.active:
                if dev.priority > priority:
                    if next_priority is None or dev.priority < next_priority:
                        next_priority = dev.priority
                if dev.priority != priority:
                    continue
                if dev.is_fsk != want_fsk:
                    continue
                for bits in slicers.slice_pulses(pulses, dev):
                    # the decoder may mutate its input (invert, extract);
                    # keep the sliced rows for the debug dump below
                    dv = dev.verbose or self.decoder_verbose
                    sliced = bits.clone() if dv else bits
                    ret = dev.decode_fn(bits, dev) if dev.decode_fn else 0
                    events = dev.account(ret)
                    for ev in events:
                        event_cb(dev, ev)
                    p_events += len(events)
                    self.maybe_log_bitbuffer(dev, sliced, bool(events))
            if p_events or next_priority is None:
                break
            priority = next_priority
        return p_events

    def maybe_log_bitbuffer(self, dev, bits, got_events: bool):
        """Debug printout rules of account_event (ref
        src/pulse_slicer.c:58-60): dump the sliced bitbuffer when the
        decoder is verbose enough for what just happened."""
        dv = dev.verbose or self.decoder_verbose
        max_bits = max(bits.bits_per_row[:bits.num_rows], default=0) \
            if dv else 0
        if (not dev.decode_fn) or (dv and got_events) \
                or (dv > 1 and max_bits > 16) or (dv > 2):
            lvl = 1 if got_events else 2
            if dv >= lvl:
                self._log_bitbuffer(dev, lvl, bits)

    def _log_bitbuffer(self, dev, level, bits):
        """Emit the decoder bitbuffer dump as a structured log event:
        src/lvl/msg/num_rows/codes, plus per-row bit strings under -M bits
        (ref decoder_log_bitbuffer, src/decoder_util.c:160-198)."""
        from ..output.data_model import Event
        from ..output import logger as _logger
        nrows = bits.num_rows
        fields = [("src", dev.modulation), ("lvl", level + 4),
                  ("msg", dev.name), ("num_rows", nrows),
                  ("codes", [bits.row_code(r) for r in range(nrows)])]
        if self.verbose_bits:
            fields.append(("bits",
                           [bits.row_bits_str(r) for r in range(nrows)]))
        _logger.log_data(level + 4, Event.make(*fields))

    def _get_device_bank(self, want_fsk: bool, sample_rate: int):
        from .device_dispatch import DeviceBank
        key = (want_fsk, sample_rate, self._version, str(self.slice_device))
        bank = self._device_banks.get(key)
        if bank is None:
            devs = [d for d in self.active if d.is_fsk == want_fsk]
            bank = DeviceBank(devs, sample_rate, self.slice_device)
            self._device_banks = {k: v for k, v in self._device_banks.items()
                                  if k[2] == self._version}
            self._device_banks[key] = bank
        return bank

    def prewarm_trains(self, trains, sample_rate: int) -> int:
        """Batch device-kernel slicing for a drain's packages (opt-in).

        ``trains`` is an iterable of (want_fsk, pulse, gap). Every train
        not in the memo cache is sliced on ``slice_device`` in one batched
        kernel call per (side, spec family) and its dispatch memo is
        pre-filled, so the per-package _run_fast path does no host slicing.
        The records the plans' MIC gates read are gathered in one launch
        per side before the plans are built; the records the plans keep,
        the declarative candidates' cache keys among them, in one launch
        for the whole drain; and the declarative candidates decode in one
        batch on ``slice_device`` (the decode bank's kernel on the card).
        Returns the number of memos built.
        """
        import numpy as np
        if not self.device_slice:
            return 0
        if self._dec_cache_version != self._version:
            self._dec_cache = {}
            self._train_cache = {}
            self._dec_cache_version = self._version
        miss = {False: {}, True: {}}
        for want_fsk, pulse, gap in trains:
            p = np.asarray(pulse, np.int32)
            g = np.asarray(gap, np.int32)
            tkey = (bool(want_fsk), sample_rate, p.tobytes(), g.tobytes())
            if tkey not in self._train_cache:
                miss[bool(want_fsk)].setdefault(tkey, (p, g))
        built = 0
        decl_syms = _decl_symbols() if self.decl_decode else ()
        decl_cands = []   # (want_fsk, dev_idx, dev, memo, off), drain-wide
        freeze_items = []  # (LazyRecords, needed) — frozen drain-wide
        for want_fsk, items in miss.items():
            if not items:
                continue
            bank = self._get_device_bank(want_fsk, sample_rate)
            meta = self._bank_meta(bank)
            results = bank.batch_slice(list(items.values()))
            # the records the plans' MIC gates read, of every train of this
            # side, in one gather before the per-train plans gate them
            from .device_dispatch import LazyRecords
            LazyRecords.prefetch_many(
                [(records, _mic_representatives(bank.devices, meta, summary,
                                                group_of))
                 for summary, records, group_of in results if len(summary)])
            for tkey, (summary, records, group_of) in zip(items.keys(),
                                                          results):
                if len(summary) == 0:
                    memo = {"records": {}, "mats": {}, "priorities": []}
                else:
                    memo = self._memo_plans(bank.devices, meta, summary,
                                            records, group_of)
                    # the plan fixes which records can ever be touched:
                    # materialize those (batched drain-wide below), drop
                    # the lazy kernel/arena refs
                    needed = set()
                    for plan in memo["priorities"]:
                        needed.update(
                            off for _r, _i, off in plan["stateful"])
                        needed.update(
                            off for _i, off, _n, _rw in plan["uniq"])
                    freeze_items.append((records, needed))
                    # declarative candidates decode ONCE for the whole
                    # drain below (one batched kernel call, not one
                    # per-train call at dispatch time); their cache keys
                    # hold the record bytes, read after the freeze
                    for plan in memo["priorities"]:
                        for i, off, _n, _rw in plan["uniq"]:
                            dev = bank.devices[i]
                            if dev.symbol in decl_syms:
                                decl_cands.append((want_fsk, i, dev, memo,
                                                   off))
                if len(self._train_cache) >= self.train_cache_max:
                    self._train_cache.clear()
                self._train_cache[tkey] = memo
                built += 1
        if freeze_items:
            from .device_dispatch import LazyRecords
            LazyRecords.freeze_many(freeze_items)
        decl_items = []
        decl_devs = []
        for want_fsk, i, dev, memo, off in decl_cands:
            ckey = (want_fsk, i, memo["records"][off])
            if ckey not in self._dec_cache:
                decl_items.append((ckey, memo, off))
                decl_devs.append(dev)
        if decl_items:
            from .declarative import FALLBACK, get_runner
            from ..pulse.native_slicers import materialize_bytes
            runner = get_runner()
            mats = []
            for (ckey, memo, off), dev in zip(decl_items, decl_devs):
                bitsb = memo["mats"].get(off)
                if bitsb is None:
                    bitsb = materialize_bytes(memo["records"][off])
                    memo["mats"][off] = bitsb
                mats.append((dev.symbol, bitsb))
            # the drain's one batch runs on the slicing device (the JAX
            # package runs it on NumPy): the CUDA kernel on the card
            outs = runner.decode_many(mats, device=self.slice_device)
            for (ckey, _memo, _off), ret in zip(decl_items, outs):
                if ret is FALLBACK:
                    continue  # dispatch falls back to the Python decoder
                if len(self._dec_cache) >= self.dec_cache_max:
                    self._dec_cache.clear()
                self._dec_cache[ckey] = ret
        return built

    def _get_bank(self, want_fsk: bool, sample_rate: int):
        from ..pulse import native_slicers
        key = (want_fsk, sample_rate, self._version)
        bank = self._banks.get(key)
        if bank is None:
            devs = [d for d in self.active if d.is_fsk == want_fsk]
            bank = native_slicers.SlicerBank(devs, sample_rate)
            # drop banks from older registry versions
            self._banks = {k: v for k, v in self._banks.items()
                           if k[2] == self._version}
            self._banks[key] = bank
        return bank

    def _bank_meta(self, bank):
        """Per-spec gate/priority arrays (built lazily per bank)."""
        import numpy as np
        from .gates import GATES

        meta = bank.meta
        if meta is None:
            devs = bank.devices
            n = len(devs)
            meta = {
                "min_rows": np.zeros(n, np.int32),
                "min_bits": np.zeros(n, np.int32),
                "max_rows": np.full(n, 10**9, np.int32),
                "priority": np.array([d.priority for d in devs], np.int32),
                "stateful": np.array(
                    [d.symbol in STATEFUL_DECODERS or d.decode_fn is None
                     or (d.symbol in ARG_STATEFUL_DECODERS and d.arg)
                     for d in devs], bool),
            }
            for i, d in enumerate(devs):
                g = GATES.get(d.symbol)
                if g and d.decode_fn is not None:
                    meta["min_rows"][i], meta["min_bits"][i] = g[0], g[1]
                    if len(g) > 2:
                        meta["max_rows"][i] = g[2]
            bank.meta = meta
        return meta

    def _build_train_memo(self, bank, meta, pulse, gap):
        """Slice + gate + dedup one pulse train; everything below is a pure
        function of the train content and the registry version, so a dense
        block's repeated bursts pay it once (the train memo).

        Returns {"records": {off: bytes}, "mats": {off: BitBuffer},
        "priorities": [per-priority dispatch plan]} — the plan holds plain
        Python ints/lists so the replay loop does no numpy scalar work.

        Candidate pairs whose decoder has a MIC gate (decoders/mic_gates.py)
        are checksum-prefiltered here with the batched kernels: provably
        DECODE_FAIL_MIC calls never reach Python decode and are accounted
        as ``fail_mic``.
        """
        import numpy as np

        devs = bank.devices
        summary, _ = bank.slice(pulse, gap)
        if len(summary) == 0:
            return {"records": {}, "mats": {}, "priorities": []}
        records = {}
        for off in np.unique(summary[:, 1]).tolist():
            records[off] = bank.record_bytes(off)
        return self._memo_plans(devs, meta, summary, records)

    def _memo_plans(self, devs, meta, summary, records, group_of=None):
        """Gate + dedup + plan a sliced summary into a train memo.

        ``summary`` rows are [spec, record_off, rows, max_bits] ordered by
        spec then temporal emission (the native bank contract — the device
        kernel bank synthesizes the same shape); ``records`` maps offset to
        the serialized record bytes.
        """
        import numpy as np
        from .mic_gates import MIC_GATES, gate_bits
        from ..pulse.native_slicers import materialize_bytes

        # summary is ordered by spec index (= active-device order within
        # this modulation side) then temporal emission order
        spec_col = summary[:, 0]
        gated = ((summary[:, 2] < meta["min_rows"][spec_col])
                 | (summary[:, 3] < meta["min_bits"][spec_col])
                 | (summary[:, 2] > meta["max_rows"][spec_col]))
        prio_col = meta["priority"][spec_col]

        mats = {}
        plans = []
        for priority in np.unique(meta["priority"]).tolist():
            in_p = prio_col == priority
            g_rows = in_p & gated
            gate_counts = []
            if g_rows.any():
                cnt = np.bincount(spec_col[g_rows], minlength=len(devs))
                gate_counts = [(i, int(cnt[i]))
                               for i in np.flatnonzero(cnt).tolist()]
            live = np.flatnonzero(in_p & ~gated)
            stateful_rows = []
            if live.size and meta["stateful"][spec_col[live]].any():
                stateful_rows = [
                    (int(row), int(spec_col[row]), int(summary[row, 1]))
                    for row in live[meta["stateful"][spec_col[live]]].tolist()]
            uniq_plan = []
            mic_counts = []
            if live.size:
                # unique (spec, record-slot) pairs, first occurrence
                # order. Grouping by arena OFFSET (not content) means NO
                # record bytes materialize for the ~1000s of gate-passing
                # rows — content dedup still happens at decode time via
                # the bytes-keyed decode cache, and only gate/MIC
                # survivors ever serialize (LazyRecords). The native
                # bank's offsets are content-unique per train, so its
                # grouping (and the emission replay counts) is identical
                # to the old content grouping there.
                ns_m = ~meta["stateful"][spec_col[live]]
                ns_rows = live[ns_m]
                ns_spec = spec_col[ns_rows].astype(np.int64)
                ns_off = summary[ns_rows, 1].astype(np.int64)
                if group_of is None:
                    # native arena offsets are content-unique per train
                    keys = (ns_spec << 40) | ns_off
                else:
                    # device banks supply content-group representatives
                    # (computed on device)
                    keys = group_of[ns_rows].astype(np.int64)
                # vectorized grouping in first-occurrence order (the old
                # per-row dict loop dominated drain-scale plan building)
                uq, inv = np.unique(keys, return_inverse=True)
                firsts = np.full(uq.size, 1 << 62, np.int64)
                np.minimum.at(firsts, inv, np.arange(keys.size))
                g_order = np.argsort(firsts, kind="stable")
                sort_idx = np.argsort(firsts[inv], kind="stable")
                counts = np.bincount(inv, minlength=uq.size)
                splits = np.cumsum(counts[g_order])[:-1]
                row_groups = np.split(ns_rows[sort_idx], splits)
                # batch-materialize the MIC-gated representatives (one
                # device gather for the train, not one per record)
                pending = []
                mic_offs = []
                for gi, rows in zip(g_order.tolist(), row_groups):
                    f = int(firsts[gi])
                    i = int(ns_spec[f])
                    off = int(ns_off[f])
                    pending.append((i, off, rows.tolist()))
                    if MIC_GATES.get(devs[i].symbol) is not None \
                            and off not in mats:
                        mic_offs.append(off)
                if mic_offs and hasattr(records, "materialize_many"):
                    records.materialize_many(mic_offs)
                for i, off, rows in pending:
                    n_calls = len(rows)
                    mspec = MIC_GATES.get(devs[i].symbol)
                    if mspec is not None:
                        bits = mats.get(off)
                        if bits is None:
                            bits = materialize_bytes(records[off])
                            mats[off] = bits
                        if not gate_bits(bits, mspec):
                            mic_counts.append((i, n_calls))
                            continue
                    uniq_plan.append((i, off, n_calls, rows))
            plans.append({"gate_counts": gate_counts,
                          "mic_counts": mic_counts,
                          "stateful": stateful_rows,
                          "uniq": uniq_plan})
        return {"records": records, "mats": mats, "priorities": plans}

    def _run_fast(self, pulses, want_fsk: bool, event_cb):
        """Native batch-sliced dispatch, same semantics as _run_host.

        The decoder-call gate (decoders/gates.py) skips Python decode calls
        that provably cannot produce an event; skipped calls are accounted
        as abort_length. Within a package, byte-identical bitbuffers reach
        each pure decoder only once (content dedup): the unique
        (decoder, record) pairs are decoded, then per-emission accounting
        and event delivery are replayed vectorized / in the reference's
        temporal order.

        Two content-addressed caches make a dense block cheap: the *train
        memo* (identical pulse trains share one native slicing pass +
        gating/dedup plan) and the *decode cache* (identical bitbuffers
        share one decode call per decoder). Stateful decoders and all
        accounting/event delivery replay live, so semantics are unchanged.
        """
        import numpy as np
        from ..pulse.native_slicers import materialize_bytes

        bank = self._get_bank(want_fsk, pulses.sample_rate)
        devs = bank.devices
        if not devs:
            return 0
        meta = self._bank_meta(bank)

        if self._dec_cache_version != self._version:
            self._dec_cache = {}
            self._train_cache = {}
            self._dec_cache_version = self._version
        dec_cache = self._dec_cache

        pulse = np.asarray(pulses.pulse, np.int32)
        gap = np.asarray(pulses.gap, np.int32)
        tkey = (want_fsk, pulses.sample_rate,
                pulse.tobytes(), gap.tobytes())
        memo = self._train_cache.get(tkey)
        if memo is None:
            memo = self._build_train_memo(bank, meta, pulse, gap)
            if len(self._train_cache) >= self.train_cache_max:
                self._train_cache.clear()
            self._train_cache[tkey] = memo

        records = memo["records"]
        mats = memo["mats"]

        def _mat(off):
            bits = mats.get(off)
            if bits is None:
                bits = materialize_bytes(records[off])
                mats[off] = bits
            return bits

        p_events = 0
        for plan in memo["priorities"]:
            if p_events:
                break  # higher priorities run only while no event yet

            # accounting of gated (skipped) calls
            for i, c in plan["gate_counts"]:
                dev = devs[i]
                dev.decode_events += c
                dev.decode_fails["abort_length"] = \
                    dev.decode_fails.get("abort_length", 0) + c
            for i, c in plan["mic_counts"]:
                dev = devs[i]
                dev.decode_events += c
                dev.decode_fails["fail_mic"] = \
                    dev.decode_fails.get("fail_mic", 0) + c

            emitting = []  # (summary_row, dev, events) for ordered delivery

            # stateful decoders: every occurrence is replayed, in temporal
            # order (cross-call state, e.g. two-part rolling codes)
            for row, i, off in plan["stateful"]:
                dev = devs[i]
                ret = (dev.decode_fn(_mat(off).clone(), dev)
                       if dev.decode_fn else 0)
                events = dev.account(ret)
                if events:
                    emitting.append((row, dev, events))

            def _account(dev, ret, n_calls, rows):
                if isinstance(ret, list) and ret:
                    dev.decode_events += n_calls
                    dev.decode_ok += n_calls
                    dev.decode_messages += len(ret) * n_calls
                    for row in rows:
                        # fresh copies: downstream prepends meta per event
                        evs = [type(e)(list(e.fields)) for e in ret]
                        emitting.append((row, dev, evs))
                else:
                    dev.decode_events += n_calls
                    if isinstance(ret, list):
                        name = "other"
                    else:
                        name = DECODE_CODE_NAMES.get(ret, "other")
                    dev.decode_fails[name] = \
                        dev.decode_fails.get(name, 0) + n_calls

            # declarative decoders: collect this priority's cache misses
            # and decode them in ONE batched kernel call (the device
            # decoder bank, decoders/declarative.py + ops/decode_bank.py).
            # The runner is the ONLY code source for declarative symbols:
            # routing tiny batches to the Python decoders made the
            # failure-code accounting depend on whether the cache was
            # prewarmed (device path) or not (host path), breaking
            # device-vs-host stats parity. The numpy backend skips slots
            # unused by a batch, so a 1-candidate call costs microseconds.
            decl_syms = _decl_symbols() if self.decl_decode else ()
            decl_batch = []
            for i, off, n_calls, rows in plan["uniq"]:
                dev = devs[i]
                ckey = (want_fsk, i, records[off])
                ret = dec_cache.get(ckey, _MISS)
                if ret is _MISS:
                    if dev.symbol in decl_syms:
                        decl_batch.append((i, off, n_calls, rows, ckey))
                        continue
                    ret = dev.decode_fn(_mat(off).clone(), dev)
                    if len(dec_cache) >= self.dec_cache_max:
                        dec_cache.clear()
                    dec_cache[ckey] = ret
                _account(dev, ret, n_calls, rows)
            if decl_batch:
                from .declarative import FALLBACK, get_runner
                runner = get_runner()
                outs = runner.decode_many(
                    [(devs[i].symbol, _mat(off))
                     for i, off, _n, _r, _k in decl_batch])
                for (i, off, n_calls, rows, ckey), ret in \
                        zip(decl_batch, outs):
                    dev = devs[i]
                    if ret is FALLBACK:  # row exceeds the bank input width
                        ret = dev.decode_fn(_mat(off).clone(), dev)
                    if len(dec_cache) >= self.dec_cache_max:
                        dec_cache.clear()
                    dec_cache[ckey] = ret
                    _account(dev, ret, n_calls, rows)

            # deliver in the reference's order: by decoder, then temporal
            emitting.sort(key=lambda t: t[0])
            for _, dev, events in emitting:
                for ev in events:
                    event_cb(dev, ev)
                p_events += len(events)
        return p_events

    def run_ook_demods(self, pulses, event_cb):
        return self._run(pulses, want_fsk=False, event_cb=event_cb)

    def run_fsk_demods(self, pulses, event_cb):
        return self._run(pulses, want_fsk=True, event_cb=event_cb)
