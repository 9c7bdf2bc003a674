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
Dispatch is the per-decoder host path (slicer, then decoder); the batched
native/device fast paths and decoder debug logging are not ported yet.
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
                    ret = dev.decode_fn(bits, dev) if dev.decode_fn else 0
                    events = dev.account(ret)
                    for ev in events:
                        event_cb(dev, ev)
                    p_events += len(events)
            if p_events or next_priority is None:
                break
            priority = next_priority
        return p_events

    def run_ook_demods(self, pulses, event_cb):
        return self._run_host(pulses, want_fsk=False, event_cb=event_cb)

    def run_fsk_demods(self, pulses, event_cb):
        return self._run_host(pulses, want_fsk=True, event_cb=event_cb)
