"""The port's MIC digests (rtl_433_tpu_torch/ops/mic.py) against the JAX
package's ops/mic.py and the port's host library, on the CPU.

Every case list of tests/test_mic_kernels.py (CRC-8/16 polynomials and
inits, LFSR generators and keys, the reductions at several lengths, a
batch of leading shape [6, 4]) goes through the JAX function, the port's
plain version (uint8 input, and int32 input with garbage above the low
byte, which the digests mask off) and the port's entry point on the CPU;
all equal each other and ``bits/util.py``. Leading shapes ``[]``, ``[0]``
and ``[2, 0]`` keep their shape. The entry points refuse a CUDA device
where there is none, and bad inputs. The CUDA kernel
(``csrc/mic.cu``) is held to the plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from rtl_433_tpu.ops import mic as jmic
from rtl_433_tpu_torch.bits import util
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.ops import mic
from test_mic_kernels import CRC16_CASES, CRC_CASES, LFSR_CASES

LFSR16_CASES = [(5, 0x8810, 0xABF9), (9, 0x8810, 0x5412), (11, 0x8810, 0x0ACC)]

# (digest, nbytes, its two parameters): every case of tests/test_mic_kernels.py
CASES = ([("crc8", *c) for c in CRC_CASES]
         + [("crc8le", *c) for c in CRC_CASES]
         + [("crc16", *c) for c in CRC16_CASES]
         + [("crc16lsb", *c) for c in CRC16_CASES]
         + [(f, *c) for f in ("lfsr_digest8", "lfsr_digest8_reverse",
                              "lfsr_digest8_reflect") for c in LFSR_CASES]
         + [("lfsr_digest16", *c) for c in LFSR16_CASES]
         + [(f, n) for f in ("xor_bytes", "add_bytes", "add_nibbles",
                             "parity_bytes") for n in (0, 1, 7, 13)])


def _msgs(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _host(name, msgs, nbytes, params):
    fn = getattr(util, name)
    return [fn(bytes(m), nbytes, *params) for m in msgs.reshape(
        -1, msgs.shape[-1])]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_digest_matches_jax_and_host(case):
    name, nbytes, *params = case
    msgs = _msgs(nbytes, (64, max(nbytes, 1) + 2))
    want = np.asarray(getattr(jmic, name)(msgs, nbytes, *params))
    assert want.dtype == np.int32
    assert want.tolist() == _host(name, msgs, nbytes, params)
    fn, plain = mic.DIGESTS[name]
    # int32 rows with garbage above the low byte
    high = msgs.astype(np.int32) + (np.random.default_rng(1).integers(
        -4, 4, msgs.shape) << 8).astype(np.int32)
    assert np.array_equal(np.asarray(getattr(jmic, name)(high, nbytes,
                                                         *params)), want)
    launches = dict(_cuda.LAUNCHES)
    for got in (plain(torch.from_numpy(msgs), nbytes, *params),
                plain(torch.from_numpy(high), nbytes, *params),
                fn(torch.from_numpy(msgs), nbytes, *params),
                fn(msgs, nbytes, *params, device="cpu"),
                fn(high, nbytes, *params, device="cpu")):
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    assert _cuda.LAUNCHES == launches      # the CPU runs no kernel


@pytest.mark.parametrize("shape", [(6, 4, 8), (8,), (0, 8), (2, 0, 8)])
@pytest.mark.parametrize("name", ["crc8", "lfsr_digest8_reflect",
                                  "add_nibbles"])
def test_leading_shapes(name, shape):
    params = {"crc8": (0x31, 0x00), "lfsr_digest8_reflect": (0x31, 0xF4),
              "add_nibbles": ()}[name]
    msgs = _msgs(3, shape)
    want = np.asarray(getattr(jmic, name)(msgs, 7, *params))
    got = mic.DIGESTS[name][0](torch.from_numpy(msgs), 7, *params)
    assert tuple(got.shape) == shape[:-1] == want.shape
    assert np.array_equal(got.numpy(), want)
    assert got.numpy().reshape(-1).tolist() == _host(name, msgs, 7, params)


def test_lfsr_key_layout_matches_jax_schedule():
    """The keys the kernel reads per message bit are JAX's schedule in its
    MSB-first layout: a one-bit message digests to its key."""
    for name in ("lfsr_digest8", "lfsr_digest8_reverse",
                 "lfsr_digest8_reflect", "lfsr_digest16"):
        gen, key = (0x8810, 0xABF9) if name == "lfsr_digest16" \
            else (0x98, 0xF1)
        keys = mic.lfsr_key_layout(name, 5, gen, key)
        unit = np.zeros((40, 5), np.uint8)
        for i in range(40):
            unit[i, i // 8] = 0x80 >> (i % 8)
        want = np.asarray(getattr(jmic, name)(unit, 5, gen, key))
        assert np.array_equal(keys, want)
        assert np.array_equal(np.asarray(jmic._lfsr_keys(
            40, gen, key, 0xFFFF if name == "lfsr_digest16" else 0xFF,
            name == "lfsr_digest8_reflect")),
            mic._lfsr_keys(40, gen, key,
                           0xFFFF if name == "lfsr_digest16" else 0xFF,
                           name == "lfsr_digest8_reflect"))


def test_xor_reduce_any_length():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 31, 64, 376):
        x = rng.integers(0, 1 << 32, (4, n), dtype=np.int64)
        want = np.bitwise_xor.reduce(x, axis=1) if n else np.zeros(4)
        assert mic.xor_reduce(torch.from_numpy(x)).tolist() == want.tolist()


def test_cuda_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for machines without")
    msgs = _msgs(4, (4, 8))
    for call in (lambda: mic.crc8(msgs, 7, 0x31, 0),
                 lambda: mic.xor_bytes(msgs, 7, device="cuda"),
                 lambda: mic.lfsr_digest16(torch.from_numpy(msgs), 7, 0x8810,
                                           0xABF9, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_tensor_runs_on_its_own_device():
    msgs = torch.from_numpy(_msgs(7, (4, 8)))
    want = mic.crc8(msgs, 7, 0x31, 0)
    assert torch.equal(mic.crc8(msgs, 7, 0x31, 0, device="cpu"), want)
    with pytest.raises(ValueError, match="not moved"):
        mic.crc8(msgs, 7, 0x31, 0, device="meta")


def test_bad_inputs_raise():
    msgs = torch.from_numpy(_msgs(6, (4, 8)))
    with pytest.raises(ValueError, match="B >= nbytes"):
        mic.crc8(msgs, 9, 0x31, 0)
    with pytest.raises(ValueError, match="uint8 or int32"):
        mic.add_bytes(msgs.to(torch.float32), 4)
    with pytest.raises(ValueError, match="B >= nbytes"):
        mic.xor_bytes(torch.tensor(3, dtype=torch.uint8), 0)


def _table_digest(name, msgs, nbytes, params):
    """The kernel's byte steps over the host-built tables, in NumPy: a
    CRC's byte table (csrc/mic.cu Crc), or the LFSR nibble tables taken
    MIC_CHUNK positions at a time as the kernel loads them (Lfsr)."""
    b = msgs.astype(np.int64) & 0xFF
    if name.startswith("crc"):
        poly, init = params
        t = mic.crc_table(name, poly).astype(np.int64)
        assert t.shape == (256,)
        v = np.full(len(b), {"crc8": init & 0xFF, "crc8le": util.reverse8(init),
                             "crc16": init & 0xFFFF,
                             "crc16lsb": init & 0xFFFF}[name], np.int64)
        for k in range(nbytes):
            if name in ("crc8", "crc8le"):
                v = t[v ^ b[:, k]]
            elif name == "crc16":
                v = ((v << 8) & 0xFFFF) ^ t[(v >> 8) ^ b[:, k]]
            else:
                v = (v >> 8) ^ t[(v ^ b[:, k]) & 0xFF]
        return v
    tabs = mic.lfsr_tables(name, nbytes, *params)
    assert tabs.shape == (nbytes, 32) and tabs.dtype == np.int32
    v = np.zeros(len(b), np.int64)
    for k0 in range(0, nbytes, mic.MIC_CHUNK):
        chunk = tabs[k0:k0 + mic.MIC_CHUNK]
        for k in range(k0, min(k0 + mic.MIC_CHUNK, nbytes)):
            p = chunk[k - k0]
            v ^= p[b[:, k] >> 4] ^ p[16 + (b[:, k] & 15)]
    return v & mic._LFSR[name][0]


TABLE_CASES = [c for c in CASES if c[0].startswith(("crc", "lfsr"))]


@pytest.mark.parametrize("case", TABLE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_host_tables_reproduce_plain_and_jax(case):
    """Every table the kernel reads, stepped as the kernel steps it, gives
    the plain version's and the JAX function's digest: on random rows of
    every case of tests/test_mic_kernels.py, and on all 256 one-byte rows
    (the whole byte table of a CRC, every nibble pair of an LFSR
    position)."""
    name, nbytes, *params = case
    rows = _msgs(100 + nbytes, (64, nbytes + 2))
    one = np.arange(256, dtype=np.uint8)[:, None]
    plain = mic.DIGESTS[name][1]
    for m, n in ((rows, nbytes), (one, 1)):
        want = np.asarray(getattr(jmic, name)(m, n, *params))
        got = _table_digest(name, m, n, params)
        assert np.array_equal(got, want)
        assert np.array_equal(plain(torch.from_numpy(m), n, *params).numpy(),
                              want)


@pytest.mark.parametrize("name", ["lfsr_digest8", "lfsr_digest8_reverse",
                                  "lfsr_digest8_reflect", "lfsr_digest16",
                                  "crc16"])
def test_host_tables_past_one_chunk(name):
    """At nbytes past MIC_CHUNK (the LFSR positions a CTA holds at once)
    the chunked table walk still gives the JAX function's and the host
    library's digest."""
    params = (0x8005, 0xFFFF) if name == "crc16" else \
        (0x8810, 0x5412) if name == "lfsr_digest16" else (0x98, 0xF1)
    nbytes = mic.MIC_CHUNK + 37
    assert mic.MIC_CHUNK % 16 == 0        # the kernel's chunk granularity
    msgs = _msgs(11, (16, nbytes + 3))
    want = np.asarray(getattr(jmic, name)(msgs, nbytes, *params))
    assert want.tolist() == _host(name, msgs, nbytes, params)
    assert np.array_equal(_table_digest(name, msgs, nbytes, params), want)
