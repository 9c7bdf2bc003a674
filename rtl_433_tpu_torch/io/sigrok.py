"""Sigrok / PulseView ``.sr`` session writer (ref src/write_sigrok.c).

A ``.sr`` file is a zip holding a ``version`` tag ("2"), a ``metadata``
ini describing channels, the ``logic-1-1`` U8 logic stream and
``analog-1-<n>-1`` F32 analog streams. The reference produces the streams
via ``-w`` dumpers (U8:LOGIC + F32:I/Q/AM/FM, ref src/r_api.c:1089-1099)
and zips them up at exit with the channel labels FRAME/ASK/FSK + I/Q/AM/FM
(ref src/r_api.c:1159-1169).
"""

from __future__ import annotations

import os
import zipfile

DEFAULT_LABELS = ["FRAME", "ASK", "FSK", "I", "Q", "AM", "FM"]


def write_sigrok(filename: str, samplerate: int, probes: int = 3,
                 analogs: int = 4) -> None:
    """Assemble a PulseView session zip (ref src/write_sigrok.c:29-86).

    Expects ``logic-1-1`` and ``analog-1-<probes+1..probes+analogs>-1``
    stream files in the working directory (as produced by the channel
    dumpers); they are moved into the zip (deleted after, matching the
    reference's ``zip -m`` behavior).
    """
    meta = ["[device 1]",
            "samplerate=%u kHz" % (samplerate // 1000),
            "capturefile=logic-1",
            "unitsize=1",
            "total probes=%u" % probes,
            "total analog=%u" % analogs]
    if (probes, analogs) == (3, 4):
        it = iter(DEFAULT_LABELS)
        for i in range(1, probes + 1):
            meta.append("probe%u=%s" % (i, next(it)))
        for i in range(probes + 1, probes + analogs + 1):
            meta.append("analog%u=%s" % (i, next(it)))
    else:
        for i in range(1, probes + 1):
            meta.append("probe%u=L%u" % (i, i))
        for i in range(probes + 1, probes + analogs + 1):
            meta.append("analog%u=A%u" % (i, i))

    parts = []
    if probes:
        parts.append("logic-1-1")
    for i in range(probes + 1, probes + analogs + 1):
        parts.append("analog-1-%u-1" % i)

    with zipfile.ZipFile(filename, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("version", "2")
        z.writestr("metadata", "\n".join(meta) + "\n")
        for part in parts:
            if os.path.exists(part):
                z.write(part, part)
                os.unlink(part)
