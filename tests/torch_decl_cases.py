"""Candidate batches for the declarative decode bank, made from a seed
with numpy.

Shared by the CPU tests (the port's plain bank against the JAX package's
``run(xp=jnp)``), ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the
CUDA kernel against the plain version). Imports only the port: the oracle
vectors of ``tests/test_decoder_oracle.py`` are read from its source, not
imported (that module imports the JAX package).

:func:`fuzz_batch` reaches every stage of the bank: the oracle vectors'
candidates (which decode: both check kinds pass, invert and Manchester
specs included), the same with bit flips (checks fail), with random stale
bits stored past the row length, and inverted; rows with each spec's
pattern planted at a random offset, Manchester-encoded after it where the
spec is Manchester, with a stop pair at a random place; and random rows
with ``n`` from 0 to IN, every spec, stale bits up to a random ``n_store``.
"""

from __future__ import annotations

import ast
import os

import numpy as np

from rtl_433_tpu_torch.bits.bitbuffer import BitBuffer
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.decoders.declarative import DECL, get_runner
from rtl_433_tpu_torch.ops import decode_bank as dbk

HERE = os.path.dirname(os.path.abspath(__file__))


def oracle_vectors():
    """``VECTORS`` of tests/test_decoder_oracle.py: (num, code, min)."""
    with open(os.path.join(HERE, "test_decoder_oracle.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VECTORS")
    scope = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "VECTORS",
                 "exec"), scope)
    return scope["VECTORS"]


def oracle_items():
    """(symbol, code) of every oracle vector of a declarative decoder."""
    sym = {d.num: d.symbol for d in Registry().slots
           if d is not None and d.symbol in DECL}
    return [(sym[num], code) for num, code, _m in oracle_vectors()
            if isinstance(num, int) and num in sym]


def candidates(items):
    """The bank's candidate arrays (bits, n_bits, sid, n_store) that the
    runner builds for ``items`` [(symbol, BitBuffer)]."""
    got = []
    real = dbk.run

    def capture(bank, bits, n_bits, sid, xp=np, n_store=None):
        got.append((bits, n_bits, sid, n_store))
        return real(bank, bits, n_bits, sid, xp=xp, n_store=n_store)

    dbk.run = capture
    try:
        get_runner().decode_many(items)
    finally:
        dbk.run = real
    return tuple(np.concatenate(a) for a in zip(*got))


def oracle_candidates():
    return candidates([(s, BitBuffer.parse(c)) for s, c in oracle_items()])


def _planted(bank, s, rng):
    """A row of spec ``s`` with its pattern at a random offset (Manchester
    pairs after it for a Manchester spec) and its n, n_store."""
    IN, plen = bank.in_bits, int(bank.plen[s])
    bits = rng.integers(0, 2, IN).astype(np.uint8)
    lo = max(int(bank.min_bits[s]), plen + 8)
    n = int(rng.integers(min(lo, IN), IN + 1))
    t = int(bank.pre_start[s])
    if plen and n - plen >= t:
        t = int(rng.integers(t, n - plen + 1))
        care = bank.pmask[s, :plen] != 0
        bits[t:t + plen] = np.where(care, bank.pat[s, :plen],
                                    bits[t:t + plen])
    if bank.transform[s] == dbk.TF_MANCHESTER:
        start = max(0, t + plen + int(bank.align_off[s]))
        pairs = int(rng.integers(0, (IN - start) // 2 + 1))
        data = rng.integers(0, 2, pairs).astype(np.uint8)
        enc = np.stack([1 - data, data], 1).reshape(-1)
        bits[start:start + enc.size] = enc
        if pairs:
            k = start + 2 * int(rng.integers(0, pairs))
            bits[k + 1] = bits[k]                  # a stop pair
    ns = int(rng.integers(n, IN + 1))
    return bits, n, ns


def fuzz_batch(seed, B, oracle=None):
    """``B`` candidates (bits uint8 [B, IN], n_bits, sid, n_store int32
    [B]) over the process-wide bank. ``oracle``: the oracle candidates
    (default :func:`oracle_candidates`); they, their mutations, stale and
    inverted variants take about half the batch."""
    bank = get_runner().bank
    IN, S = bank.in_bits, bank.n_specs
    rng = np.random.default_rng(seed)
    ob, on, osid, ons = oracle_candidates() if oracle is None else oracle
    rows, ns_, sids, nss = [], [], [], []

    def add(b, n, s, ns):
        rows.append(b)
        ns_.append(n)
        sids.append(s)
        nss.append(ns)

    half = B // 2
    for i in range(half):
        k = i % len(on)
        b, n, s, ns = ob[k].copy(), int(on[k]), int(osid[k]), int(ons[k])
        mode = (i // len(on)) % 4
        if mode == 1 and n:                        # bit flips below n
            for j in rng.integers(0, n, int(rng.integers(1, 4))):
                b[j] ^= 1
        elif mode == 2:                            # stale stored bits
            ns = int(rng.integers(n, IN + 1))
            b[n:ns] = rng.integers(0, 2, ns - n)
            if n and rng.integers(2):
                n = int(rng.integers(max(n - 8, 0), n))   # truncated row
        elif mode == 3:                            # inverted row
            b[:n] ^= 1
        add(b, n, s, ns)
    i = 0
    while len(rows) < B:
        s = i % S
        if i % 3 < 2:                              # planted
            b, n, ns = _planted(bank, s, rng)
        else:                                      # random, stale bits
            n = {2: 0, 5: IN}.get(i, int(rng.integers(0, IN + 1)))
            ns = int(rng.integers(n, IN + 1))
            b = rng.integers(0, 2, IN).astype(np.uint8)
            b[ns:] = 0
        add(b, n, s, ns)
        i += 1
    return (np.stack(rows), np.asarray(ns_, np.int32),
            np.asarray(sids, np.int32), np.asarray(nss, np.int32))
