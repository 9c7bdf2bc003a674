"""Logging facade with a pluggable handler (ref src/logger.c, include/logger.h).

Mirrors the reference's two-stage design: every module logs through
:func:`print_log` / :func:`print_logf`; a handler installed with
:func:`set_log_handler` routes messages — the CLI installs a fan-out
handler (api.RtlTpu.redirect_logging) that re-emits each message as a
``src``/``lvl``/``msg`` event through every output sink whose
``log_level`` admits it (ref src/r_api.c:554-589), so logs appear as
JSON lines / MQTT messages / syslog datagrams next to the decoded events.
Without a handler, messages go to stderr (ref src/logger.c:20-24).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

# Log levels, compatible with SoapySDR (ref include/logger.h:23-33)
LOG_FATAL = 1
LOG_CRITICAL = 2
LOG_ERROR = 3
LOG_WARNING = 4
LOG_NOTICE = 5
LOG_INFO = 6
LOG_DEBUG = 7
LOG_TRACE = 8

LEVEL_NAMES = {
    LOG_FATAL: "FATAL", LOG_CRITICAL: "CRITICAL", LOG_ERROR: "ERROR",
    LOG_WARNING: "WARNING", LOG_NOTICE: "NOTICE", LOG_INFO: "INFO",
    LOG_DEBUG: "DEBUG", LOG_TRACE: "TRACE",
}

_handler: Optional[Callable[[int, str, str], None]] = None
_data_handler = None


def set_log_handler(handler: Optional[Callable[[int, str, str], None]],
                    data_handler=None):
    """Install (or, with None, remove) the global log handlers
    (ref r_logger_set_log_handler, src/logger.c:26-30). ``data_handler``
    takes structured log events ``(level, Event)`` — the decoder bitbuffer
    dumps (ref log_device_handler, src/r_api.c:610-630)."""
    global _handler, _data_handler
    _handler = handler
    _data_handler = data_handler


def log_data(level: int, ev):
    """Log a structured src/lvl/msg/... event (decoder bitbuffer dumps);
    falls back to 'src: msg' on stderr without a handler."""
    if _data_handler is not None:
        _data_handler(level, ev)
    else:
        sys.stderr.write(f"{ev.get('src')}: {ev.get('msg')}\n")


def print_log(level: int, src: str, msg: str):
    """Log a message string (ref print_log, src/logger.c:32-40)."""
    if _handler is not None:
        _handler(level, src, msg)
    else:
        sys.stderr.write(f"{src}: {msg}\n")


def print_logf(level: int, src: str, fmt: str, *args):
    """Log a %-format message (ref print_logf, src/logger.c:42-49)."""
    print_log(level, src, (fmt % args) if args else fmt)
