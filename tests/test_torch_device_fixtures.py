"""Device slicing end to end on the CPU: one fixture per slicer family.

For each of the nine kernel families, the first capture of
``tests/fixtures/`` whose protocol slices with it is decoded under
``-R <n>`` with ``RtlTpu(device_slice=True, device="cpu")``: its events
equal the committed ``.json``, the port's default path and the JAX
package's device-slicing path, and the registry's train memo was filled
by the prewarm on the CPU device.
"""

import json

import pytest

from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
import rtl_433_tpu_torch.decoders.device_dispatch as tdd
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.output.data_model import event_to_json

from torch_fixture_cases import cases as fixture_cases
from torch_fixture_cases import expected, normalize


def _family_fixtures():
    """The first fixture whose protocol slices with each kernel family."""
    slots = Registry().slots
    picked = {}
    for name, nums, cu8 in fixture_cases():
        for fam, mods in tdd._FAM_MODS.items():
            if fam not in picked and any(
                    slots[n] is not None and slots[n].modulation in mods
                    for n in nums):
                picked[fam] = (name, nums, cu8)
    return [picked[f] for f in tdd._FAM_MODS if f in picked]


FAMILY_FIXTURES = _family_fixtures()


def _decode(nums, cu8, device_slice):
    rx = RtlTpu(register_all=False, report_time="off", device="cpu",
                device_slice=device_slice)
    for n in nums:
        rx.registry.register(n)
    return rx, [normalize(json.loads(event_to_json(e)))
                for e in rx.decode_file(cu8)]


def _jax_decode(nums, cu8):
    rx = JaxRtlTpu(register_all=False, report_time="off", device_slice=True)
    for n in nums:
        rx.registry.register(n)
    return [normalize(json.loads(jax_event_to_json(e)))
            for e in rx.decode_file(cu8)]


@pytest.mark.parametrize("name,nums,cu8", FAMILY_FIXTURES,
                         ids=[f[0] for f in FAMILY_FIXTURES])
def test_fixture_with_device_slicing(name, nums, cu8):
    rx, got = _decode(nums, cu8, True)
    assert got == expected(cu8) and got
    assert rx.registry.device_slice and rx.registry._train_cache
    assert str(rx.registry.slice_device) == "cpu"
    assert got == _decode(nums, cu8, False)[1]
    assert got == _jax_decode(nums, cu8)


def test_family_fixtures_cover_every_family():
    assert len(FAMILY_FIXTURES) == len(tdd._FAM_MODS)
