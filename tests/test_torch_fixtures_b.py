"""Fixture replay through the port on the CPU, half b of the corpus.

Every other capture of tests/fixtures/ (those at even positions of the
sorted list in half a, odd in half b, so that the 250k, 1024k and 4096k
captures spread over both files) decodes through
``RtlTpu(device="cpu")`` with ``-R <n>`` to its committed .json.
"""

import json
import os

import pytest

from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json
from torch_fixture_cases import cases, expected, normalize

CASES = cases()[1::2]


def test_half_is_not_empty():
    assert len(CASES) == 53


@pytest.mark.parametrize("name,nums,cu8", CASES, ids=[c[0] for c in CASES])
def test_fixture_replay(name, nums, cu8):
    rx = RtlTpu(register_all=False, report_time="off", device="cpu")
    for n in nums:
        rx.registry.register(n)
    got = [normalize(json.loads(event_to_json(e)))
           for e in rx.decode_file(cu8)]
    assert got == expected(cu8), os.path.basename(cu8)
