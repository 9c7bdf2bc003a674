"""Every oracle vector of tests/test_decoder_oracle.py through ``-y`` in
both packages.

Each of the 409 vectors (``{n}hex`` rows, RfRaw pulse strings, the
``n:arg`` decoder-argument form and the ``|``-separated stateful pairs)
goes through ``decode_test_string`` of a fresh JAX ``RtlTpu`` and a fresh
port ``RtlTpu(device="cpu")``; the normalized events must be equal and
non-empty. Seeded single-bit mutations of each vector compare the failure
paths too: a flipped data bit of a ``{n}hex`` group (``_mutate`` of the
oracle test), or of an RfRaw data nibble.
"""

import json
import random
import re

import pytest

from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json
from test_decoder_oracle import VECTORS, _mutate

N_MUTATIONS = 6
IDS = [f"{i}-p{v[0]}" for i, v in enumerate(VECTORS)]


def _normalize(ev):
    ev = dict(ev)
    ev.pop("time", None)
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in ev.items()}


def _events(rx, to_json, num, code):
    arg = None
    if isinstance(num, str):
        n, _, arg = num.partition(":")
        num = int(n)
    rx.registry.register(num, arg)
    evs = []
    for part in code.split("|"):
        evs += rx.decode_test_string(part)
    return [_normalize(json.loads(to_json(e))) for e in evs]


def _both(num, code):
    jax = _events(JaxRtlTpu(register_all=False, report_time="off"),
                  jax_event_to_json, num, code)
    port = _events(RtlTpu(register_all=False, report_time="off",
                          device="cpu"), event_to_json, num, code)
    return jax, port


def _mutate_rfraw(code: str, rng) -> str:
    """Flip one bit of one data nibble of an RfRaw string (after the
    bucket table, before the closing 55)."""
    t = code.replace(" ", "").upper()
    head = 6 if t.startswith("AAB1") else 10
    nbuck = int(t[head - 2:head], 16) if t.startswith("AAB1") else \
        int(t[6:8], 16)
    start = head + 4 * nbuck
    end = t.rfind("55")
    pos = rng.randrange(start, end if end > start else len(t))
    v = int(t[pos], 16) ^ (1 << rng.randrange(4))
    return t[:pos] + format(v, "X") + t[pos + 1:]


@pytest.mark.parametrize("num,code,min_events", VECTORS, ids=IDS)
def test_vector_matches_jax(num, code, min_events):
    jax, port = _both(num, code)
    assert len(jax) >= min_events
    assert port == jax


@pytest.mark.parametrize("num,code,min_events", VECTORS, ids=IDS)
def test_mutations_match_jax(num, code, min_events):
    numkey = int(str(num).split(":")[0])
    rng = random.Random(numkey * 1000 + len(code))
    rfraw = not code.lstrip().startswith("{")
    if not rfraw:
        total_bits = sum(int(p[1:p.index("}")])
                         for p in re.split(r"[ |]", code)
                         if p.startswith("{"))
    for _ in range(N_MUTATIONS):
        mut = _mutate_rfraw(code, rng) if rfraw else \
            _mutate(code, rng.randrange(total_bits))
        jax, port = _both(num, mut)
        assert port == jax, f"mutated code {mut}"
