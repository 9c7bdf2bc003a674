"""Batched message-integrity-check (MIC) digests: the CUDA kernel's
wrappers and their plain versions.

The counterpart of the JAX package's ``ops/mic.py``: every digest of the
host library ``bits/util.py`` (ref src/bit_util.c:240-556) over a batch of
byte rows at once. ``msg`` is a ``[..., B]`` uint8 or int32 tensor (int32
is read ``& 0xFF``); the digest covers ``msg[..., :nbytes]`` and the result
is int32 ``[...]`` on the input's device.

A tensor runs on its own device (``device``, if given, must name it); an
array-like goes to ``device``, by default ``"cuda"``, which must exist (no
fallback to the CPU: pass ``device="cpu"``). On a CUDA tensor each function
launches ``csrc/mic.cu`` (a thread per row, the algorithm a template
parameter; launches count as ``mic_<name>``); on a CPU tensor it runs its
plain version, ``<name>_plain``, torch written statement for statement from
the JAX function.

The kernel steps a byte at a time through tables that do not depend on the
data, built here on the host and uploaded once per parameters: a CRC's
256-entry byte table (:func:`crc_table`, eight steps of the bit-serial
recurrence on every byte value), and an LFSR digest's two 16-entry nibble
tables per byte position (:func:`lfsr_tables`, the XOR of the rolling keys
(:func:`_lfsr_keys`, laid out by :func:`lfsr_key_layout` in the message's
MSB-first bit order) under each nibble value), of which a CTA holds
``MIC_CHUNK`` positions at once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from ..bits.util import reverse8

# the kernel's algorithm ids (csrc/mic.cu enum Algo), in _cuda.MIC_ALGOS order
ALGO_ID = {name: i for i, name in enumerate(_cuda.MIC_ALGOS)}

# LFSR byte positions whose nibble tables the kernel holds in shared memory
# at once; longer messages are digested in chunks of positions (a multiple
# of 16, csrc/mic.cu)
MIC_CHUNK = 64

# LFSR digests: (key width mask, key rolls left)
_LFSR = {"lfsr_digest8": (0xFF, False), "lfsr_digest8_reverse": (0xFF, False),
         "lfsr_digest8_reflect": (0xFF, True),
         "lfsr_digest16": (0xFFFF, False)}


def _u8(msg):
    return msg.to(torch.int32) & 0xFF


def xor_reduce(x):
    """XOR of ``x`` over its last axis (an integer tensor; 0 when empty):
    halving passes over the axis padded to a power of two."""
    n = x.shape[-1]
    w = 1 << max(n - 1, 0).bit_length()
    if w != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (w - n,))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


# ---- plain versions (any device), statement for statement from JAX

def crc8_plain(msg, nbytes: int, poly: int, init: int):
    """MSB-first CRC-8 over msg[..., :nbytes]. Ref src/bit_util.c:278."""
    msg = _u8(msg)
    rem = torch.full(msg.shape[:-1], init & 0xFF, dtype=torch.int32,
                     device=msg.device)
    for k in range(nbytes):
        rem = rem ^ msg[..., k]
        for _ in range(8):
            hit = (rem & 0x80) != 0
            rem = torch.where(hit, ((rem << 1) ^ poly) & 0xFF,
                              (rem << 1) & 0xFF)
    return rem


def crc8le_plain(msg, nbytes: int, poly: int, init: int):
    """LSB-first (reflected) CRC-8. Ref src/bit_util.c:296."""
    msg = _u8(msg)
    rem = torch.full(msg.shape[:-1], reverse8(init), dtype=torch.int32,
                     device=msg.device)
    rpoly = reverse8(poly)
    for k in range(nbytes):
        rem = rem ^ msg[..., k]
        for _ in range(8):
            hit = (rem & 1) != 0
            rem = torch.where(hit, (rem >> 1) ^ rpoly, rem >> 1)
    return rem & 0xFF


def crc16_plain(msg, nbytes: int, poly: int, init: int):
    """MSB-first CRC-16. Ref src/bit_util.c:334."""
    msg = _u8(msg)
    rem = torch.full(msg.shape[:-1], init & 0xFFFF, dtype=torch.int32,
                     device=msg.device)
    for k in range(nbytes):
        rem = (rem ^ (msg[..., k] << 8)) & 0xFFFF
        for _ in range(8):
            hit = (rem & 0x8000) != 0
            rem = torch.where(hit, ((rem << 1) ^ poly) & 0xFFFF,
                              (rem << 1) & 0xFFFF)
    return rem


def crc16lsb_plain(msg, nbytes: int, poly: int, init: int):
    """LSB-first CRC-16. Ref src/bit_util.c:315."""
    msg = _u8(msg)
    rem = torch.full(msg.shape[:-1], init & 0xFFFF, dtype=torch.int32,
                     device=msg.device)
    for k in range(nbytes):
        rem = rem ^ msg[..., k]
        for _ in range(8):
            hit = (rem & 1) != 0
            rem = torch.where(hit, ((rem >> 1) ^ poly) & 0xFFFF, rem >> 1)
    return rem


@functools.lru_cache(maxsize=None)
def _lfsr_keys(nbits: int, gen: int, key: int, width_mask: int,
               roll_left: bool):
    """Data-independent rolling-key schedule for the Galois LFSR digests
    (host-precomputed constants; ref src/bit_util.c:353-434)."""
    keys = np.zeros(nbits, np.int32)
    key &= width_mask
    msb = (width_mask + 1) >> 1
    for i in range(nbits):
        keys[i] = key
        if roll_left:
            key = ((key << 1) ^ gen) & width_mask if key & msb \
                else (key << 1) & width_mask
        else:
            key = ((key >> 1) ^ gen) & width_mask if key & 1 else key >> 1
    return keys


def lfsr_key_layout(name: str, nbytes: int, gen: int, key: int):
    """The key each message bit XORs in when set, int32 ``[nbytes * 8]`` in
    the MSB-first bit order of :func:`_bits_msb_first`."""
    mask, left = _LFSR[name]
    keys = np.asarray(_lfsr_keys(nbytes * 8, gen, key, mask, left))
    if name == "lfsr_digest8_reverse":
        # byte k processed at position (nbytes-1-k): flip byte order of keys
        keys = keys.reshape(nbytes, 8)[::-1]
    elif name == "lfsr_digest8_reflect":
        # schedule order: k-th processed bit is (byte nbytes-1-floor(k/8),
        # bit k%8 LSB-first); map onto the MSB-first bit layout
        keys = keys.reshape(nbytes, 8)[::-1, ::-1]
    return np.ascontiguousarray(keys.reshape(-1))


def _bits_msb_first(msg, nbytes: int):
    """[..., nbytes] bytes -> [..., nbytes*8] bits, each byte MSB first."""
    msg = _u8(msg)[..., :nbytes]
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=msg.device)
    return ((msg[..., :, None] >> shifts) & 1).reshape(
        msg.shape[:-1] + (nbytes * 8,))


def _lfsr_plain(name, msg, nbytes, gen, key):
    bits = _bits_msb_first(msg, nbytes)
    keys = _device_keys(name, nbytes, gen, key, msg.device)
    return xor_reduce(torch.where(bits != 0, keys, 0)) & _LFSR[name][0]


def lfsr_digest8_plain(msg, nbytes: int, gen: int, key: int):
    """Ref src/bit_util.c:353: bytes first→last, bits MSB→LSB."""
    return _lfsr_plain("lfsr_digest8", msg, nbytes, gen, key)


def lfsr_digest8_reverse_plain(msg, nbytes: int, gen: int, key: int):
    """Ref src/bit_util.c:380: bytes last→first, bits MSB→LSB."""
    return _lfsr_plain("lfsr_digest8_reverse", msg, nbytes, gen, key)


def lfsr_digest8_reflect_plain(msg, nbytes: int, gen: int, key: int):
    """Ref src/bit_util.c:407: bytes last→first, bits LSB→MSB, key rolls
    left."""
    return _lfsr_plain("lfsr_digest8_reflect", msg, nbytes, gen, key)


def lfsr_digest16_plain(msg, nbytes: int, gen: int, key: int):
    """Ref src/bit_util.c:434."""
    return _lfsr_plain("lfsr_digest16", msg, nbytes, gen, key)


def xor_bytes_plain(msg, nbytes: int):
    return xor_reduce(_u8(msg)[..., :nbytes])


def add_bytes_plain(msg, nbytes: int):
    return _u8(msg)[..., :nbytes].sum(-1, dtype=torch.int32)


def add_nibbles_plain(msg, nbytes: int):
    msg = _u8(msg)[..., :nbytes]
    return ((msg >> 4) + (msg & 0x0F)).sum(-1, dtype=torch.int32)


def parity_bytes_plain(msg, nbytes: int):
    """XOR parity of all bits. Ref src/bit_util.c:542-556."""
    x = xor_bytes_plain(msg, nbytes)
    x = x ^ (x >> 4)
    x = x & 0xF
    return (0x6996 >> x) & 1


# ---- the entry points

def _input(msg, nbytes: int, device):
    """``msg`` as a uint8 or int32 tensor ``[..., B]``: a tensor stays on
    its device (a ``device`` that names another raises), an array-like goes
    to ``device``."""
    if isinstance(msg, torch.Tensor):
        if device is not None:
            dev = _cuda.resolve_device(device)
            if dev.type != msg.device.type or dev.index not in (
                    None, msg.device.index):
                raise ValueError(f"mic: msg is on {msg.device}, not on "
                                 f"{dev} (a tensor is not moved)")
    else:
        a = np.asarray(msg)
        if a.dtype != np.uint8:
            a = a.astype(np.int32)   # the low byte survives the cast
        msg = torch.from_numpy(np.ascontiguousarray(a)).to(
            _cuda.resolve_device("cuda" if device is None else device))
    if msg.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"mic: msg must be uint8 or int32, not {msg.dtype}")
    if msg.dim() < 1 or not 0 <= nbytes <= msg.shape[-1]:
        raise ValueError(f"mic: msg must be [..., B] with B >= nbytes "
                         f"({nbytes}), not {tuple(msg.shape)}")
    return msg


@functools.lru_cache(maxsize=64)
def _device_keys(name: str, nbytes: int, gen: int, key: int, device):
    """:func:`lfsr_key_layout` on ``device``, uploaded once."""
    return torch.from_numpy(lfsr_key_layout(name, nbytes, gen, key)).to(
        device)


@functools.lru_cache(maxsize=None)
def crc_table(name: str, poly: int):
    """The kernel's byte step of CRC ``name``: int32 ``[256]``, eight steps
    of the JAX function's bit-serial recurrence on each byte value (the
    MSB-first CRC-16 on the value shifted into its high byte). The CRC is
    linear, so a byte steps the remainder v to ``T[v ^ b]`` (8-bit),
    ``((v << 8) & 0xFFFF) ^ T[(v >> 8) ^ b]`` (crc16) or
    ``(v >> 8) ^ T[(v ^ b) & 0xFF]`` (crc16lsb)."""
    v = np.arange(256, dtype=np.int64)
    if name == "crc8":
        for _ in range(8):
            v = np.where(v & 0x80, ((v << 1) ^ poly) & 0xFF, (v << 1) & 0xFF)
    elif name == "crc8le":
        rpoly = reverse8(poly)
        for _ in range(8):
            v = np.where(v & 1, (v >> 1) ^ rpoly, v >> 1)
    elif name == "crc16":
        v = v << 8
        for _ in range(8):
            v = np.where(v & 0x8000, ((v << 1) ^ poly) & 0xFFFF,
                         (v << 1) & 0xFFFF)
    else:
        for _ in range(8):
            v = np.where(v & 1, ((v >> 1) ^ poly) & 0xFFFF, v >> 1)
    return v.astype(np.int32)


def lfsr_tables(name: str, nbytes: int, gen: int, key: int):
    """The kernel's byte step of LFSR digest ``name``: int32
    ``[nbytes, 32]``; row k holds, for each high nibble h, the XOR of the
    keys that bits 7..4 of byte k carry where h has them set (``[k, h]``),
    then the same for the low nibble (``[k, 16 + l]``), so that byte b
    XORs in ``T[k, b >> 4] ^ T[k, 16 + (b & 15)]``."""
    keys = lfsr_key_layout(name, nbytes, gen, key).reshape(nbytes, 2, 4)
    nib = np.arange(16)
    bits = (nib[:, None] >> np.arange(3, -1, -1)) & 1        # [16, 4]
    sel = np.where(bits[None, None] != 0, keys[:, :, None, :], 0)
    return np.bitwise_xor.reduce(sel, axis=-1).reshape(
        nbytes, 32).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_table(name: str, nbytes: int, a: int, b: int, device):
    """The kernel's table of digest ``name`` on ``device``, uploaded once:
    :func:`crc_table` (``a`` the polynomial) or :func:`lfsr_tables` (``a``,
    ``b`` the generator and the key)."""
    t = crc_table(name, a) if name.startswith("crc") \
        else lfsr_tables(name, nbytes, a, b)
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def _launch(name: str, msg, nbytes: int, init: int = 0, mask: int = 0,
            table=None):
    """One launch of ``csrc/mic.cu`` for algorithm ``name`` over the rows of
    a CUDA ``msg`` (``table``: the digest's table on its device); int32
    ``[...]``."""
    m = msg.contiguous()
    out = torch.empty(m.shape[:-1], dtype=torch.int32, device=m.device)
    if out.numel():
        fn = _cuda.launcher("mic")
        _cuda.LAUNCHES[f"mic_{name}"] += 1
        err = fn(ALGO_ID[name], int(m.dtype == torch.int32), m.data_ptr(),
                 out.numel(), m.shape[-1], nbytes, init, mask,
                 None if table is None else table.data_ptr(), MIC_CHUNK,
                 out.data_ptr(), _cuda.stream_of(m))
        _cuda.check(err, f"mic_{name}")
    return out


def _crc(name, plain, msg, nbytes, poly, init, device):
    msg = _input(msg, nbytes, device)
    if not msg.is_cuda:
        return plain(msg, nbytes, poly, init)
    if name == "crc8le":
        init = reverse8(init)
    return _launch(name, msg, nbytes, init,
                   table=_device_table(name, 0, poly, 0, msg.device))


def _lfsr(name, plain, msg, nbytes, gen, key, device):
    msg = _input(msg, nbytes, device)
    if not msg.is_cuda:
        return plain(msg, nbytes, gen, key)
    table = _device_table(name, nbytes, gen, key, msg.device) if nbytes \
        else None
    return _launch(name, msg, nbytes, mask=_LFSR[name][0], table=table)


def _reduction(name, plain, msg, nbytes, device):
    msg = _input(msg, nbytes, device)
    if not msg.is_cuda:
        return plain(msg, nbytes)
    return _launch(name, msg, nbytes)


def crc8(msg, nbytes: int, poly: int, init: int, device=None):
    """MSB-first CRC-8 over msg[..., :nbytes]. Ref src/bit_util.c:278."""
    return _crc("crc8", crc8_plain, msg, nbytes, poly, init, device)


def crc8le(msg, nbytes: int, poly: int, init: int, device=None):
    """LSB-first (reflected) CRC-8. Ref src/bit_util.c:296."""
    return _crc("crc8le", crc8le_plain, msg, nbytes, poly, init, device)


def crc16(msg, nbytes: int, poly: int, init: int, device=None):
    """MSB-first CRC-16. Ref src/bit_util.c:334."""
    return _crc("crc16", crc16_plain, msg, nbytes, poly, init, device)


def crc16lsb(msg, nbytes: int, poly: int, init: int, device=None):
    """LSB-first CRC-16. Ref src/bit_util.c:315."""
    return _crc("crc16lsb", crc16lsb_plain, msg, nbytes, poly, init, device)


def lfsr_digest8(msg, nbytes: int, gen: int, key: int, device=None):
    """Ref src/bit_util.c:353: bytes first→last, bits MSB→LSB."""
    return _lfsr("lfsr_digest8", lfsr_digest8_plain, msg, nbytes, gen, key,
                 device)


def lfsr_digest8_reverse(msg, nbytes: int, gen: int, key: int, device=None):
    """Ref src/bit_util.c:380: bytes last→first, bits MSB→LSB."""
    return _lfsr("lfsr_digest8_reverse", lfsr_digest8_reverse_plain, msg,
                 nbytes, gen, key, device)


def lfsr_digest8_reflect(msg, nbytes: int, gen: int, key: int, device=None):
    """Ref src/bit_util.c:407: bytes last→first, bits LSB→MSB, key rolls
    left."""
    return _lfsr("lfsr_digest8_reflect", lfsr_digest8_reflect_plain, msg,
                 nbytes, gen, key, device)


def lfsr_digest16(msg, nbytes: int, gen: int, key: int, device=None):
    """Ref src/bit_util.c:434."""
    return _lfsr("lfsr_digest16", lfsr_digest16_plain, msg, nbytes, gen, key,
                 device)


def xor_bytes(msg, nbytes: int, device=None):
    return _reduction("xor_bytes", xor_bytes_plain, msg, nbytes, device)


def add_bytes(msg, nbytes: int, device=None):
    return _reduction("add_bytes", add_bytes_plain, msg, nbytes, device)


def add_nibbles(msg, nbytes: int, device=None):
    return _reduction("add_nibbles", add_nibbles_plain, msg, nbytes, device)


def parity_bytes(msg, nbytes: int, device=None):
    """XOR parity of all bits. Ref src/bit_util.c:542-556."""
    return _reduction("parity_bytes", parity_bytes_plain, msg, nbytes,
                      device)


# name -> (entry point, plain version), in _cuda.MIC_ALGOS order
DIGESTS = {name: (globals()[name], globals()[f"{name}_plain"])
           for name in _cuda.MIC_ALGOS}
