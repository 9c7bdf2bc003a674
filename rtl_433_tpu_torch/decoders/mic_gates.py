"""MIC (checksum) decode-call gates: batched checksum prefilter.

``MIC_GATES[symbol] = (row, invert, checks)`` states a NECESSARY condition
for the decoder to emit an event: some candidate row's byte prefix must
pass every listed digest check (the decoder would otherwise return
DECODE_FAIL_MIC).  ``row`` is -1 for "any row" or a fixed row index;
``invert`` applies BitBuffer.invert() to the candidate rows first; each
check is ``(algo, nbytes, p1, p2, xor_out, mask, cmp, cmp_const)`` where
``cmp >= 0`` compares against ``row[cmp]`` (16-bit algos against
``(row[cmp]<<8)|row[cmp+1]``) and ``cmp == -1`` against ``cmp_const``.

The digests are the scalar bits/util ones, run per candidate row on the
host (the batched digest kernels are ops/mic.py).  The fast dispatch
(decoders/base.py) skips the Python decode call for (package, decoder)
pairs whose gate fails and accounts them as ``mic`` failures — event
output is exactly unchanged (the decoder could only have failed), only
the failure-counter *name* is approximated for multi-check decoders whose
first failing check differs.

Auto-derived from decoder source (AST analysis of leading fail guards;
only provably-necessary patterns are emitted) and validated by the
decoder-oracle suite: every oracle vector that decodes must pass its
decoder's MIC gate (tests/test_decoder_oracle.py) plus the gated-dispatch
differential fuzz (tests/test_native_slicers.py); the table here equals
that one (tests/test_torch_fast_dispatch.py).
"""

import numpy as np

_DIGESTS16 = {"crc16", "crc16lsb", "lfsr_digest16"}

# (row, invert, ((algo, nbytes, p1, p2, xor_out, mask, cmp, cmp_const
#                 [, bit_off, reflect]), ...)) — the optional pair applies
# a byte view (extract_bytes offset / reverse8) before the digest
MIC_GATES = {
    'acurite_606': (-1, False, (('lfsr_digest8', 3, 152, 241, 0, None, 3, None),)),
    'bm5': (0, True, (('add_bytes', 10, 0, 0, 0, 255, 10, None),)),
    'burnhardbbq': (-1, True, (('lfsr_digest8_reflect', 9, 49, 244, 0, None, 9, None),)),
    'companion_wtr001': (-1, False, (('parity_bytes', 2, 0, 0, 0, None, -1, 1),)),
    'fineoffset_wh5rb': (0, False, (('crc8', 4, 49, 0, 0, None, 4, None, 7, False),)),
    'gasmate_ba1008': (0, False, (('add_nibbles', 4, 0, 0, 0, 15, -1, 12),)),
    'govee_h5054': (-1, True, (('crc16', 6, 4129, 7439, 0, None, -1, 0),)),
    'omni': (-1, False, (('crc8', 9, 151, 170, 0, None, 9, None),)),
    'revolt_nc5462': (0, True, (('add_bytes', 11, 0, 0, 0, 255, 11, None),)),
    'rubicson_pool_48942': (-1, True, (('crc8', 4, 49, 0, 0, None, 4, None),)),
    'schrader_EG53MA4': (0, False, (('add_bytes', 9, 0, 0, 0, 255, 9, None, 40, False),)),
    'schraeder': (0, False, (('crc8', 7, 7, 240, 0, None, 7, None, 4, False),)),
    'tfa_30_3221': (-1, True, (('lfsr_digest8_reflect', 4, 49, 244, 0, None, 4, None),)),
    'tfa_drop_303233': (-1, True, (('lfsr_digest8_reflect', 7, 49, 244, 0, None, 7, None),)),
    'thermopro_tp11': (-1, False, (('lfsr_digest8_reflect', 3, 81, 4, 0, None, 3, None),)),
    'wt1024': (1, False, (('xor_bytes', 4, 0, 0, 0, None, 4, None),)),
}


_SUMS = ("add_bytes", "xor_bytes", "add_nibbles", "parity_bytes")


def _digest(algo, rows, nbytes, p1, p2):
    """Digest per candidate row. Host dispatch evaluates a handful of
    tiny rows per (train, decoder) pair, where the scalar bits/util
    digests are far cheaper than launching a batched kernel."""
    from ..bits import util
    fn = getattr(util, algo)
    if algo in _SUMS:
        return np.asarray([fn(bytes(bytearray(r[:nbytes])), nbytes)
                           for r in rows], np.int64)
    return np.asarray([fn(bytes(bytearray(r[:nbytes])), nbytes, p1, p2)
                       for r in rows], np.int64)


_REFLECT_LUT = np.asarray(
    [int(f"{x:08b}"[::-1], 2) for x in range(256)], np.uint8)


def _view(rows: np.ndarray, bit_off: int, reflect: bool) -> np.ndarray:
    """Byte view of each row starting at ``bit_off`` bits, optionally with
    every byte bit-reversed — mirrors `_ints(bits.extract_bytes(r, OFF, L))`
    (+ `[reverse8(x) for x in b]`) on zero-padded storage."""
    byte_off, sh = divmod(int(bit_off), 8)
    v = rows[:, byte_off:] if byte_off else rows
    if sh:
        hi = (v.astype(np.int32) << sh) & 0xFF
        lo = np.zeros_like(hi)
        lo[:, :-1] = v[:, 1:].astype(np.int32) >> (8 - sh)
        v = (hi | lo).astype(np.uint8)
    if reflect:
        v = _REFLECT_LUT[v]
    return v


def rows_pass(rows: np.ndarray, spec) -> bool:
    """Can ANY candidate row satisfy every check?  ``rows``: the
    bitbuffer's zero-padded row byte storage [num_rows, >=max_nbytes+2]
    (already inverted if the spec demands it).  Checks are 8-tuples, or
    10-tuples adding a per-check byte view (bit_off, reflect)."""
    row_sel, _invert, checks = spec
    if row_sel >= 0:
        if row_sel >= rows.shape[0]:
            return False  # the decoder would abort on length anyway
        rows = rows[row_sel:row_sel + 1]
    if rows.shape[0] == 0:
        return False
    ok = np.ones(rows.shape[0], bool)
    views = {(0, False): rows}
    for check in checks:
        (algo, nbytes, p1, p2, xor_out, mask, cmp, cmp_const) = check[:8]
        key = (check[8], check[9]) if len(check) > 8 else (0, False)
        v = views.get(key)
        if v is None:
            v = views[key] = _view(rows, *key)
        d = _digest(algo, v, nbytes, p1, p2) ^ xor_out
        if mask is not None:
            d = d & mask
        if cmp >= 0:
            if algo in _DIGESTS16 and cmp_const is None:
                exp = (v[:, cmp].astype(np.int64) << 8) \
                    | v[:, cmp + 1]
            else:
                exp = v[:, cmp].astype(np.int64)
        else:
            exp = cmp_const
        ok &= (d == exp)
        if not ok.any():
            return False
    return True


def gate_bits(bits, spec) -> bool:
    """Evaluate a MIC gate on a materialized BitBuffer."""
    row_sel, invert, _checks = spec
    if invert:
        bits = bits.clone()
        bits.invert()
    rows = np.asarray(bits.bb[:bits.num_rows])
    return rows_pass(rows, spec)
