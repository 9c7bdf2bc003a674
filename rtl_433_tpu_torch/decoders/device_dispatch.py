"""Device-kernel slicing bank: batch (package, spec) slicing on the
accelerator, memo-compatible with the host dispatch.

A drain's unique pulse trains are sliced against the nine kernel spec
families in one batched call each (ops/slice.py, ``csrc/slice.cu``);
outputs are serialized into the exact record format the native C++ bank
emits (csrc/slicers.cpp emit(), so decode caches and memo plans are shared
byte-for-byte), merged with the remaining spec families (native bank), and
planned into train memos via Registry._memo_plans. Capacity- or
float-boundary-flagged lanes are sliced again on the host per (train,
spec), so the event stream is bit-identical to the host dispatch
(tests/test_torch_device_dispatch.py).

Beside the slicing, two kernels of ``csrc/dispatch.cu`` run on the slicer
output where it lies: :func:`_content_dup` (which earlier event of a lane
each event repeats, so that the host groups equal records without reading
their bytes) and :func:`_gather_records` (the bytes and syncs of the
records a dispatch plan keeps). Each launches its kernel for CUDA tensors
and runs its plain version for CPU tensors.

The module is the JAX package's ``decoders/device_dispatch.py`` with these
differences: the bank runs on an explicit ``torch.device``; the kernel
outputs it reads on the host are copied there with ``.cpu()``; lazy
records' bytes come through :func:`_gather_many`, every family of a
materialization pass in one launch (``LazyRecords._materialize``, and
``LazyRecords.prefetch_many`` for the MIC gates' representatives of a
drain); and
:func:`_content_dup` returns the first equal event ``e' <= e``, as its
docstring there says, where the JAX mask selects ``e' >= e`` and so always
returns ``e`` (the events are the same either way: the grouping only saves
decode calls).

Reference dispatch semantics: src/r_api.c:438-550; slicer semantics:
src/pulse_slicer.c:68-449.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda

# modulations with a device kernel
_FAM_MODS = {
    "ppm": ("OOK_PULSE_PPM",),
    "pwm": ("OOK_PULSE_PWM", "FSK_PULSE_PWM"),
    "pcm": ("OOK_PULSE_PCM", "OOK_PULSE_RZ", "FSK_PULSE_PCM"),
    "mc": ("OOK_PULSE_MANCHESTER_ZEROBIT",
           "FSK_PULSE_MANCHESTER_ZEROBIT"),
    "dmc": ("OOK_PULSE_DMC",),
    "piwm_dc": ("OOK_PULSE_PIWM_DC",),
    "nrzs": ("OOK_PULSE_NRZS",),
    "rzi": ("OOK_PULSE_RZI",),
    "osv1": ("OOK_PULSE_PWM_OSV1",),
}


def _serialize(nr, fr, bits_per_row, syncs, rows128):
    """Record bytes in the native arena layout (csrc/slicers.cpp:156-166):
    int32 nr, int32 fr, u16 bits[nr], u16 syncs[nr] (padded to 4),
    u8 bb[fr * 128]."""
    head = bytearray()
    head += int(nr).to_bytes(4, "little")
    head += int(fr).to_bytes(4, "little")
    head += np.asarray(bits_per_row[:nr], "<u2").tobytes()
    head += np.asarray(syncs[:nr], "<u2").tobytes()
    if (4 * nr) & 3:
        head += b"\x00\x00"
    return bytes(head) + np.asarray(rows128[:fr], np.uint8).tobytes()


def serialize_bitbuffer(bb) -> bytes:
    nr = bb.num_rows
    fr = min(max(bb.free_row, nr), bb.bb.shape[0])
    return _serialize(nr, fr, np.asarray(bb.bits_per_row, "<u2"),
                      np.asarray(bb.syncs_before_row, "<u2"), bb.bb)


def _bucket(n, lo=64):
    b = lo
    while b < n:
        b *= 2
    return b


def _snap_record(snap, off):
    """record_bytes from an arena snapshot (native_slicers.py layout)."""
    nr = int(snap[off:off + 4].view(np.int32)[0])
    fr = int(snap[off + 4:off + 8].view(np.int32)[0])
    head = 8 + ((4 * nr + 3) & ~3)
    return snap[off: off + head + fr * 128].tobytes()


# ---------------------------------------------------------------------------
# the two kernels of csrc/dispatch.cu, each beside its plain version
# ---------------------------------------------------------------------------

def _planes(out):
    nb, nr = out["bytes"], out["num_rows"]
    bpr, sy = out["bits_per_row"], out["syncs"]
    if nb.dim() != 5 or nr.shape != nb.shape[:3] \
            or bpr.shape != nb.shape[:4] or sy.shape != nb.shape[:4]:
        raise ValueError("content_dup: bytes must be [B, J, E, R, W], "
                         "num_rows [B, J, E], bits_per_row and syncs "
                         "[B, J, E, R]")
    if nb.dtype != torch.uint8 or any(t.dtype != torch.int32
                                      for t in (nr, bpr, sy)):
        raise ValueError("content_dup: bytes must be uint8, the rest int32")
    return nb, nr, bpr, sy


def _content_dup_plain(out):
    """Plain version of the content dedup: a loop over the earlier event
    e', each a vectorized compare of every event with e' (rows at or past
    an event's row count are scratch and left out)."""
    nb, nr, bpr, sy = _planes(out)
    B, J, E, R, W = nb.shape
    rows_ok = torch.arange(R, device=nb.device) < nr[..., None]  # [B,J,E,R]
    dup = torch.arange(E, dtype=torch.int32, device=nb.device)\
        .expand(B, J, E).clone()
    found = torch.zeros((B, J, E), dtype=torch.bool, device=nb.device)
    for e2 in range(E):
        eq = nr == nr[:, :, e2:e2 + 1]
        eq &= ((bpr == bpr[:, :, e2:e2 + 1]) | ~rows_ok).all(-1)
        eq &= ((sy == sy[:, :, e2:e2 + 1]) | ~rows_ok).all(-1)
        eq &= ((nb == nb[:, :, e2:e2 + 1]).all(-1) | ~rows_ok).all(-1)
        hit = eq & ~found & (torch.arange(E, device=nb.device) >= e2)
        dup = torch.where(hit, e2, dup)
        found |= hit
    return dup


def _content_dup(out):
    """Per-(train, spec) content dedup: dup[b, j, e] = the first event
    index e' <= e whose record content (row count, per-row bit counts,
    syncs, row bytes) is identical to e's. Exact compares, no hashing, so
    grouping by the dup representative keeps the byte-level dedup
    semantics without moving any record bytes. ``csrc/dispatch.cu`` for
    CUDA planes (a warp per lane: raises where E > 32),
    :func:`_content_dup_plain` for CPU planes; returns int32 [B, J, E] on
    the planes' device."""
    nb, nr, bpr, sy = _planes(out)
    if not nb.is_cuda:
        return _content_dup_plain(out)
    if not all(t.is_cuda and t.device == nb.device for t in (nr, bpr, sy)):
        raise ValueError("content_dup: the planes must lie on one CUDA "
                         "device")
    nb, nr, bpr, sy = (t.contiguous() for t in (nb, nr, bpr, sy))
    B, J, E, R, W = nb.shape
    if E > 32:
        raise ValueError(f"content_dup: {E} events per lane do not fit a "
                         f"warp (at most 32)")
    dup = torch.empty((B, J, E), dtype=torch.int32, device=nb.device)
    if dup.numel():
        fn = _cuda.launcher("content_dup")
        _cuda.LAUNCHES["content_dup"] += 1
        err = fn(nb.data_ptr(), nr.data_ptr(), bpr.data_ptr(),
                 sy.data_ptr(), B * J, E, R, W, dup.data_ptr(),
                 _cuda.stream_of(nb))
        _cuda.check(err, "content_dup")
    return dup


def _gather_records_plain(bytes_dev, syncs_dev, bs, js, es):
    """Plain version of the record gather (advanced indexing)."""
    return bytes_dev[bs, js, es], syncs_dev[bs, js, es]


# the family table of the batched gather (csrc/dispatch.cu GF_*): per
# family its planes' pointers, J, E, R, W, the offsets of its bytes and
# syncs in the output buffer, its first record
_GF_COLS = 10


def _gather_groups(groups):
    """Check the batched gather's ``groups`` [(bytes [B, J, E, R, W],
    syncs [B, J, E, R], bs, js, es)], the index arrays host ints [P_f];
    returns them with int64 index arrays."""
    out = []
    for bytes_dev, syncs_dev, *idx in groups:
        if bytes_dev.dim() != 5 or bytes_dev.dtype != torch.uint8 \
                or syncs_dev.dtype != torch.int32:
            raise ValueError("gather_records: bytes must be uint8 "
                             "[B, J, E, R, W], syncs int32")
        B, J, E, R, W = bytes_dev.shape
        idx = [np.asarray(a, np.int64) for a in idx]
        for a, n in zip(idx, (B, J, E)):
            if a.size and (a.min() < 0 or a.max() >= n):
                raise ValueError("gather_records: an index is out of range")
        if syncs_dev.shape != (B, J, E, R) or syncs_dev.device \
                != bytes_dev.device:
            raise ValueError("gather_records: syncs must be [B, J, E, R] on "
                             "the bytes' device")
        out.append((bytes_dev, syncs_dev, *idx))
    if len({str(g[0].device) for g in out}) > 1:
        raise ValueError("gather_records: the planes must lie on one device")
    return out


def _gather_plan(groups):
    """The batched gather's device inputs for checked ``groups``: the
    ``meta`` tensor (the int64 family table [F, _GF_COLS], then the
    records (family, b, j, e) as int32 [P, 4]), the flat uint8 output
    buffer, P, and per family (P_f, R, W, bytes offset, syncs offset),
    each region 16-byte aligned."""
    dev = groups[0][0].device
    F = len(groups)
    P = sum(len(g[2]) for g in groups)
    meta = np.zeros(_GF_COLS * F + 2 * P, np.int64)
    table = meta[:_GF_COLS * F].reshape(F, _GF_COLS)
    recs = meta[_GF_COLS * F:].view(np.int32).reshape(P, 4)
    parts, keep, size, first = [], [], 0, 0
    for f, (by, sy, bs, js, es) in enumerate(groups):
        by, sy = by.contiguous(), sy.contiguous()
        keep += [by, sy]
        _B, J, E, R, W = by.shape
        n = len(bs)
        ob = size
        osy = (ob + n * R * W + 15) & ~15
        size = (osy + 4 * n * R + 15) & ~15
        table[f] = (by.data_ptr(), sy.data_ptr(), J, E, R, W, ob, osy,
                    first, 0)
        recs[first:first + n] = np.stack([np.full(n, f), bs, js, es], 1)
        parts.append((n, R, W, ob, osy))
        first += n
    meta_dev = torch.from_numpy(meta).to(dev)
    out = torch.empty(max(size, 16), dtype=torch.uint8, device=dev)
    return meta_dev, out, P, parts, keep


def _gather_many_plain(groups):
    """Plain version of the batched gather: each family by
    :func:`_gather_records_plain`."""
    return [_gather_records_plain(by, sy, *(torch.from_numpy(a).to(by.device)
                                            for a in idx))
            for by, sy, *idx in _gather_groups(groups)]


def _gather_many(groups):
    """The records of several families' slicer outputs: for each of
    ``groups`` [(bytes [B, J, E, R, W], syncs [B, J, E, R], bs, js, es)]
    (host int index arrays [P_f]) its records' bytes [P_f, R, W] and
    syncs [P_f, R] as host NumPy arrays. For CUDA planes one launch of
    ``csrc/dispatch.cu`` gathers every family into one buffer, which one
    copy brings to the host; CPU planes take :func:`_gather_many_plain`."""
    groups = _gather_groups(groups)
    if not groups:
        return []
    if not groups[0][0].is_cuda:
        return [(b.numpy(), s.numpy()) for b, s in _gather_many_plain(groups)]
    meta, out, P, parts, keep = _gather_plan(groups)
    if P:
        fn = _cuda.launcher("gather_records")
        _cuda.LAUNCHES["gather_records"] += 1
        err = fn(meta.data_ptr(), len(groups), P, out.data_ptr(),
                 _cuda.stream_of(out))
        _cuda.check(err, "gather_records")
    host = out.cpu().numpy()
    del keep
    return [(host[ob:ob + n * R * W].reshape(n, R, W),
             host[osy:osy + 4 * n * R].view(np.int32).reshape(n, R))
            for n, R, W, ob, osy in parts]


def _gather_records(bytes_dev, syncs_dev, bs, js, es):
    """The records ``(bs[i], js[i], es[i])`` of the slicer output: their
    bytes [P, R, W] and syncs [P, R], as host NumPy arrays. The index
    arrays are host int32 [P]. A one-family call of :func:`_gather_many`
    (``csrc/dispatch.cu`` for CUDA planes, the plain version for CPU
    planes)."""
    return _gather_many([(bytes_dev, syncs_dev, bs, js, es)])[0]


# LazyRecords source kinds (columns in src_kind)
_SRC_EAGER = -1      # src_a indexes eager_blobs
_SRC_SNAP = -2       # src_a indexes snaps, src_b is the arena offset
# src_kind >= 0      # family index into fam_outs; (src_a, src_b) = (j, e)


class LazyRecords:
    """``{off: record_bytes}`` mapping whose kernel/native records
    serialize on first access.

    Serializing every sliced record up front (thousands per train, of
    which the dispatch gates of decoders/gates.py discard all but a few
    dozen) would dominate a drain. Records therefore stay as (source,
    index) descriptors until a surviving candidate needs its bytes
    (decode-cache key, MIC gate, materialize); :meth:`freeze` then drops
    the bulky kernel-output references once the dispatch plan is built,
    keeping only the bytes the plan can ever touch.
    """

    __slots__ = ("_ready", "_kind", "_a", "_b", "_fams", "_snaps",
                 "_eager", "_train")

    def __init__(self, kind, a, b, fams, snaps, eager, train):
        self._ready = {}
        self._kind = kind
        self._a = a
        self._b = b
        self._fams = fams          # [(out, caps)] kernel outputs
        self._snaps = snaps        # [np.uint8 arena snapshot]
        self._eager = eager        # [bytes]
        self._train = train        # train index b into the kernel outputs

    def __getitem__(self, off):
        blob = self._ready.get(off)
        if blob is None:
            k = int(self._kind[off])
            if k == _SRC_EAGER:
                blob = self._eager[self._a[off]]
            elif k == _SRC_SNAP:
                blob = _snap_record(self._snaps[self._a[off]],
                                    int(self._b[off]))
            else:
                # one record: the gather kernel on a one-entry index
                LazyRecords._materialize([(self, [off])])
                blob = self._ready[off]
            self._ready[off] = blob
        return blob

    def freeze(self, needed):
        """Materialize ``needed`` offsets, drop every source reference."""
        LazyRecords.freeze_many([(self, needed)])

    def materialize_many(self, offs):
        """Batch-materialize offsets without dropping the sources."""
        LazyRecords._materialize([(self, offs)])

    @staticmethod
    def freeze_many(items):
        """Batch-freeze across a whole drain: ONE device gather + ONE
        transfer for every surviving record of every train and family,
        instead of per-record (or even per-train) device round-trips.
        ``items`` is [(LazyRecords, needed_offs)]."""
        LazyRecords._materialize(items)
        for rec, _needed in items:
            rec._kind = rec._a = rec._b = None
            rec._fams = rec._snaps = rec._eager = None

    @staticmethod
    def prefetch_many(items):
        """Batch-materialize across a drain without dropping the sources:
        ONE gather launch and ONE transfer for every record of every
        family that ``items`` [(LazyRecords, offs)] touch (the MIC gates'
        representatives of a drain, read before their per-train gates)."""
        LazyRecords._materialize(items)

    @staticmethod
    def _materialize(items):
        by_fam = {}    # (fams identity, fam idx) -> [(rec, off, b, j, e)]
        fam_of = {}    # the same keys -> (out, caps)
        for rec, needed in items:
            for off in needed:
                if off in rec._ready:
                    continue
                k = int(rec._kind[off])
                if k >= 0:
                    key = (id(rec._fams), k)
                    fam_of[key] = rec._fams[k]
                    by_fam.setdefault(key, []).append(
                        (rec, off, rec._train, int(rec._a[off]),
                         int(rec._b[off])))
                else:
                    rec[off]     # snap/eager: host-side, already cheap
        if not by_fam:
            return
        # every family of every fams list in one gather launch
        groups = []
        for key, entries in by_fam.items():
            out = fam_of[key][0]
            bs, js, es = (np.array([e[c] for e in entries], np.int32)
                          for c in (2, 3, 4))
            groups.append((out["bytes"], out["syncs"], bs, js, es))
        got = _gather_many(groups)
        for (key, entries), (bytes_np, syncs_np) in zip(by_fam.items(), got):
            out, caps = fam_of[key]
            for i, (r, off, b, j, e) in enumerate(entries):
                nr = int(out["num_rows"][b, j, e])
                rows = np.zeros((nr, 128), np.uint8)
                rows[:, :caps.row_bytes] = bytes_np[i, :nr]
                r._ready[off] = _serialize(
                    nr, nr, out["bits_per_row"][b, j, e],
                    syncs_np[i], rows)


class DeviceBank:
    """SlicerBank-compatible bank whose slicing runs as batched device
    kernels for the nine kernel spec families, on ``device``."""

    def __init__(self, devices, sample_rate: int, device,
                 pcm_caps=None, ppm_caps=None):
        from ..ops.slice import (SliceCaps, dmc_bounds, mc_bounds,
                                 nrzs_bounds, osv1_bounds, pcm_bounds,
                                 piwm_dc_bounds, ppm_bounds, pwm_bounds,
                                 rzi_bounds)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device slicing on 'cuda' requested but no "
                               "CUDA GPU is available (use a CPU device)")
        self.devices = list(devices)
        self.sample_rate = sample_rate
        self.meta = None
        self.fams = []
        mod_to_fam = {m: f for f, mods in _FAM_MODS.items() for m in mods}
        fam_idx = {f: [] for f in _FAM_MODS}
        self.rest_idx = []
        for i, d in enumerate(self.devices):
            f = mod_to_fam.get(d.modulation)
            if f is not None and d.decode_fn is not None:
                fam_idx[f].append(i)
            else:
                self.rest_idx.append(i)
        caps_small = ppm_caps or SliceCaps(events=4, rows=16, row_bytes=20)
        caps_pcm = pcm_caps or SliceCaps(events=4, rows=16, row_bytes=40)
        caps_mc = SliceCaps(events=8, rows=24, row_bytes=20)
        for fam, builder, caps in (
                ("ppm", ppm_bounds, caps_small),
                ("pwm", pwm_bounds, caps_small),
                ("pcm", pcm_bounds, caps_pcm),
                ("mc", mc_bounds, caps_mc),
                ("dmc", dmc_bounds, caps_mc),
                ("piwm_dc", piwm_dc_bounds, caps_mc),
                ("nrzs", nrzs_bounds, caps_pcm),
                ("rzi", rzi_bounds, caps_pcm),
                ("osv1", osv1_bounds, caps_pcm)):
            idx = fam_idx[fam]
            if idx:
                bounds = builder([self.devices[i] for i in idx],
                                 sample_rate)
                self.fams.append((fam, np.asarray(idx, np.int32),
                                  bounds, caps))
        # on a CUDA device, each family's bound columns stay there as the
        # kernel's packed table (ops/slice.py bound_table)
        self.tables = {}
        if self.device.type == "cuda":
            from ..ops.slice import bound_table
            self.tables = {fam: torch.from_numpy(bound_table(fam, b)).to(
                self.device) for fam, _idx, b, _caps in self.fams}
        self._restbank = None
        self._ovf_banks = {}

    # -- host-exact slicing of flagged lanes (native bank) ----------------

    def _get_ovf_bank(self, key):
        """Native bank over the flagged spec subset, cached per subset
        (cold drains flag a stable set, so this compiles once)."""
        from ..pulse import native_slicers
        bank = self._ovf_banks.get(key)
        if bank is None:
            if len(self._ovf_banks) >= 16:
                self._ovf_banks.clear()
            bank = native_slicers.SlicerBank(
                [self.devices[i] for i in key], self.sample_rate)
            self._ovf_banks[key] = bank
        return bank

    def _native_piece(self, bank, full_map, pulse, gap, snaps):
        """Slice one train on a native bank; return lazy summary columns.

        The bank's arena is reused across calls, so the used prefix is
        snapshotted; records parse out of the snapshot on demand
        (:class:`LazyRecords`)."""
        summary, arena = bank.slice(pulse, gap)
        k = len(summary)
        if k == 0:
            return None
        offs = summary[:, 1].astype(np.int64)
        last = int(offs.max())
        nr_l = int(arena[last:last + 4].view(np.int32)[0])
        fr_l = int(arena[last + 4:last + 8].view(np.int32)[0])
        used = last + 8 + ((4 * nr_l + 3) & ~3) + fr_l * 128
        snaps.append(arena[:used].copy())
        sid = len(snaps) - 1
        spec_l = summary[:, 0]
        # seq = occurrence index within spec (rows are spec-major temporal)
        starts = np.r_[0, np.flatnonzero(np.diff(spec_l)) + 1]
        runlen = np.diff(np.r_[starts, k])
        seq = np.arange(k, dtype=np.int64) - np.repeat(starts, runlen)
        # the native arena is content-unique per train, so the arena
        # offset doubles as the content-group id
        return (np.asarray(full_map, np.int64)[spec_l], seq,
                summary[:, 2].astype(np.int64),
                summary[:, 3].astype(np.int64),
                np.full(k, _SRC_SNAP, np.int64),
                np.full(k, sid, np.int64), offs, offs)

    def _rest_cols(self, pulse, gap, snaps):
        """Lazy summary columns for the non-kernel spec families."""
        if not self.rest_idx:
            return []
        if self._restbank is None:
            from ..pulse import native_slicers
            self._restbank = native_slicers.SlicerBank(
                [self.devices[i] for i in self.rest_idx], self.sample_rate)
        piece = self._native_piece(self._restbank, self.rest_idx, pulse, gap,
                                   snaps)
        return [piece] if piece is not None else []

    # -- the batched kernel pass ------------------------------------------

    def batch_slice(self, trains):
        """Slice every train against every spec; one kernel call per family.

        ``trains`` is a list of (pulse int32[n], gap int32[n]). Returns a
        list (per train) of (summary int32[k,4], records, group_of) in the
        native bank's layout/order contract, where ``records`` is a
        :class:`LazyRecords` off->bytes mapping: summary rows (the gate
        inputs) are assembled vectorized from the kernel outputs, and
        record BYTES serialize only when a gate-surviving candidate needs
        them (``Registry._memo_plans`` groups live rows by content, so the
        native path's content-dedup semantics are preserved exactly).
        Capacity- or boundary-flagged lanes are sliced again in one
        native-bank pass per train (exact host semantics).
        """
        from ..ops.slice import (slice_dmc, slice_mc, slice_nrzs,
                                 slice_osv1, slice_pcm, slice_piwm_dc,
                                 slice_ppm, slice_pwm, slice_rzi)
        kernels = {"ppm": slice_ppm, "pwm": slice_pwm, "pcm": slice_pcm,
                   "mc": slice_mc, "dmc": slice_dmc,
                   "piwm_dc": slice_piwm_dc, "nrzs": slice_nrzs,
                   "rzi": slice_rzi, "osv1": slice_osv1}

        B = len(trains)
        if B == 0:
            return []
        n_max = max(len(p) for p, _ in trains)
        N = _bucket(max(n_max, 1))
        Bpad = _bucket(B, lo=8)
        pulse = np.zeros((Bpad, N), np.int32)
        gap = np.zeros((Bpad, N), np.int32)
        n_pulses = np.zeros((Bpad,), np.int32)
        for b, (p, g) in enumerate(trains):
            pulse[b, :len(p)] = p
            gap[b, :len(g)] = g
            n_pulses[b] = len(p)
        pulse, gap, n_pulses = (torch.from_numpy(a).to(self.device)
                                for a in (pulse, gap, n_pulses))

        fam_outs = []
        for fam, idx, bounds, caps in self.fams:
            out = kernels[fam](pulse, gap, n_pulses,
                               self.tables.get(fam, bounds), caps)
            # only the small summary planes move to the host eagerly; the
            # record payloads ("bytes", "syncs": the bulk of the kernel
            # output) stay on the device and move per RECORD, and only for
            # candidates that survive the gates (LazyRecords). Content
            # dedup likewise runs on the device (the "dup" plane) so the
            # host can group identical events without touching their bytes.
            out = dict(out)
            out["dup"] = _content_dup(out)
            for k in ("ovf", "n_events", "num_rows", "bits_per_row",
                      "dup"):
                out[k] = out[k].cpu().numpy()
            fam_outs.append((fam, idx, caps, out))
        rec_fams = [(out, caps) for _fam, _idx, caps, out in fam_outs]

        results = []
        for b, (p, g) in enumerate(trains):
            cols = []     # (full, seq, num_rows, max_bits, kind, a, b)
            snaps = []
            eager = []
            fallback = []
            for fi, (fam, idx, caps, out) in enumerate(fam_outs):
                ovf = np.asarray(out["ovf"][b], bool)
                n_ev = out["n_events"][b]
                E = out["num_rows"].shape[2]
                livem = (~ovf)[:, None] & \
                    (np.arange(E)[None, :] < n_ev[:, None])
                js, es = np.nonzero(livem)
                if js.size:
                    nr = out["num_rows"][b][js, es]
                    mb = out["bits_per_row"][b][js, es].max(axis=1)
                    cols.append((idx[js].astype(np.int64),
                                 es.astype(np.int64),
                                 nr.astype(np.int64), mb.astype(np.int64),
                                 np.full(js.size, fi, np.int64),
                                 js.astype(np.int64), es.astype(np.int64),
                                 out["dup"][b][js, es].astype(np.int64)))
                fallback += [int(idx[j]) for j in np.flatnonzero(ovf)]
            if fallback:
                fallback.sort()
                bank = self._get_ovf_bank(tuple(fallback))
                piece = self._native_piece(bank, fallback, p, g, snaps)
                if piece is not None:
                    cols.append(piece)
            cols += self._rest_cols(np.asarray(p, np.int32),
                                    np.asarray(g, np.int32), snaps)
            if not cols:
                empty = np.zeros(0, np.int64)
                results.append((np.zeros((0, 4), np.int32),
                                LazyRecords(empty, empty, empty,
                                            rec_fams, snaps, eager, b),
                                np.zeros(0, np.int32)))
                continue
            full = np.concatenate([c[0] for c in cols])
            seq = np.concatenate([c[1] for c in cols])
            nr = np.concatenate([c[2] for c in cols])
            mb = np.concatenate([c[3] for c in cols])
            kind = np.concatenate([c[4] for c in cols])
            sa = np.concatenate([c[5] for c in cols])
            sb = np.concatenate([c[6] for c in cols])
            gd = np.concatenate([c[7] for c in cols])
            order = np.lexsort((seq, full))
            k = len(order)
            summary = np.stack(
                [full[order], np.arange(k, dtype=np.int64),
                 nr[order], mb[order]], axis=1).astype(np.int32)
            records = LazyRecords(kind[order], sa[order], sb[order],
                                  rec_fams, snaps, eager, b)
            # content-group representative per position: first position
            # sharing (spec, source, content-id) — kernel content ids come
            # from the on-device dup plane, native ones from the
            # content-unique arena offset
            gkeys = np.stack([full[order], kind[order], sa[order],
                              gd[order]], axis=1)
            _uniq, inv = np.unique(gkeys, axis=0, return_inverse=True)
            first = np.full(len(_uniq), k, np.int64)
            np.minimum.at(first, inv, np.arange(k))
            group_of = first[inv].astype(np.int32)
            results.append((summary, records, group_of))
        return results
