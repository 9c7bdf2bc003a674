"""Config file parsing (-c): long keywords mapped to short options
(ref src/confparse.c, conf_keywords table src/rtl_433.c:402-438).

Search order: CWD, $XDG_CONFIG_HOME/rtl_433, /usr/local/etc/rtl_433
(ref src/rtl_433.c:110-115).
"""

from __future__ import annotations

import os
from typing import List, Optional

# long keyword -> short option (ref src/rtl_433.c:402-438)
CONF_KEYWORDS = {
    "verbose": "-v",
    "version": "-V",
    "config_file": "-c",
    "report_meta": "-M",
    "device": "-d",
    "gain": "-g",
    "frequency": "-f",
    "hop_interval": "-H",
    "ppm_error": "-p",
    "sample_rate": "-s",
    "protocol": "-R",
    "decoder": "-X",
    "register_all": "-G",
    "out_block_size": "-b",
    "level_limit": "-l",
    "minlevel": "-Y",
    "analyze_bits": "-A",
    "analyze": "-a",
    "include_only": "-I",
    "read_file": "-r",
    "write_file": "-w",
    "overwrite_file": "-W",
    "signal_grabber": "-S",
    "override_short": "-z",
    "override_long": "-x",
    "pulse_detect": "-Y",
    "output": "-F",
    "output_tag": "-K",
    "convert": "-C",
    "duration": "-T",
    "test_data": "-y",
    "stop_after_successful_events": "-E",
}

DEFAULT_CONF_PATHS = [
    "rtl_433.conf",
    os.path.join(os.environ.get("XDG_CONFIG_HOME",
                                os.path.expanduser("~/.config")),
                 "rtl_433", "rtl_433.conf"),
    "/usr/local/etc/rtl_433/rtl_433.conf",
    "/etc/rtl_433/rtl_433.conf",
]


def find_default_conf() -> Optional[str]:
    for p in DEFAULT_CONF_PATHS:
        if os.path.isfile(p):
            return p
    return None


def parse_conf_entries(text: str) -> List[tuple]:
    """Tokenize conf-file text into (keyword, value) pairs.

    Mirrors the reference tokenizer (ref src/confparse.c:89-166 getconf):
    ``keyword arg`` to end of line, ``#`` comments, and brace-quoted args —
    an arg opening with ``{`` runs (newlines included) until a ``}`` that
    is the last non-space token on its line, so multi-line ``decoder {``
    blocks from stock conf files parse identically.
    """
    entries: List[tuple] = []
    p, n = 0, len(text)
    while True:
        # skip whitespace and comments between entries
        while p < n and text[p] in " \t\r\n#":
            if text[p] == "#":
                while p < n and text[p] not in "\r\n":
                    p += 1
            else:
                p += 1
        if p >= n:
            break
        # keyword: run of non-whitespace
        kw_start = p
        while p < n and text[p] not in " \t\r\n":
            p += 1
        kw = text[kw_start:p]
        while p < n and text[p] in " \t":
            p += 1
        # arg: brace-quoted (multi-line) or to end-of-line/comment
        if p < n and text[p] == "{":
            p += 1
            arg_start = p
            arg_end = None
            while p < n:
                while p < n and text[p] != "}":
                    p += 1
                e = p  # candidate end-quote
                if p < n:
                    p += 1
                while p < n and text[p] in " \t":
                    p += 1
                if p >= n or text[p] in "\r\n#":
                    arg_end = e
                    break
            val = text[arg_start:arg_end if arg_end is not None else n]
        else:
            arg_start = p
            while p < n and text[p] not in "\r\n#":
                p += 1
            val = text[arg_start:p]
            if p < n and text[p] == "#":
                while p < n and text[p] not in "\r\n":
                    p += 1
        entries.append((kw, val.strip()))
    return entries


def parse_conf_text(text: str) -> List[str]:
    """Turn conf-file text into an argv list (see parse_conf_entries)."""
    argv: List[str] = []
    for kw, val in parse_conf_entries(text):
        opt = CONF_KEYWORDS.get(kw)
        if opt is None:
            raise ValueError(f"unknown conf keyword: {kw}")
        argv.append(opt)
        if val:
            argv.append(val)
    return argv


def parse_conf_file(path: str) -> List[str]:
    with open(path) as f:
        return parse_conf_text(f.read())
