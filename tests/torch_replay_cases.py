"""Shared cases of the replay CLI, for the port's CPU tests and
chip_smoke.py's ``replay_cli`` phase.

``run_cli`` runs a package's ``cli.main`` in this process with stdout and
stderr captured and the API module's clock pinned (``PinnedClock``), so
that two runs of one argv print the same bytes: ``-M time:...`` stamps,
``-M stats`` reports, ``-M noise`` cadence and ``-M replay`` pacing all
read the clock through ``api._time``. ``flex_spec`` writes a ``-X`` spec
from a registered device's modulation and timings. Imports neither torch
nor jax.
"""

import contextlib
import io
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf")

# (fixture directory, protocol): an OOK_PPM, an OOK_PWM and an FSK_PCM
# capture, each replayed through a flex decoder made from its protocol
FLEX_FIXTURES = (("nexus", 19), ("lacrosse_tx141x", 73),
                 ("lacrosse_tx35", 75))

# (conf file, fixture directory, protocol): conf files whose flex decoders
# register, replayed on a capture beside -R <protocol>. The first two
# decode their device's capture beside the protocol (same priority); the
# third's decoder stays silent there. (A conf decoder of priority 0 on a
# protocol of priority 10, as nexus_th.conf beside -R 19, takes the package
# first and the protocol's decoder is not run, as in the reference.)
CONF_RUNS = (("lacrosse_tx141.conf", "lacrosse_tx141x", 73),
             ("rubicson_temp.conf", "rubicson", 2),
             ("generic_ev1527.conf", "nexus", 19))

# options of the replay CLI, one run each on the nexus capture (-R 19)
OPTION_RUNS = (["-F", "csv"], ["-F", "log"], ["-F", "jsons"],
               ["-F", "null"],
               ["-F", "json", "-M", "level", "-M", "protocol", "-M",
                "time:unix:usec:utc"],
               ["-F", "json", "-M", "stats:1"], ["-F", "kv", "-C", "si"],
               ["-v"], ["-vvv"])


class PinnedClock:
    """A stand-in for the ``time`` module inside an API module: the wall
    clock and the monotonic clock stand still, ``sleep`` moves both."""

    def __init__(self, now=1760000000.25):
        self.now = now
        self.mono = 1000.0

    def time(self):
        return self.now

    def monotonic(self):
        return self.mono

    def sleep(self, s):
        self.now += s
        self.mono += s

    def gmtime(self, t=None):
        return time.gmtime(self.now if t is None else t)

    def localtime(self, t=None):
        return time.localtime(self.now if t is None else t)

    def strftime(self, fmt, tm=None):
        return time.strftime(fmt, self.localtime() if tm is None else tm)


def run_cli(main, argv, clock=None):
    """``main(argv)`` with stdout and stderr captured and its package's
    ``api._time`` pinned: (exit code, stdout, stderr). The package's log
    handler is reset afterwards, as the CLI resets it at entry."""
    pkg = main.__module__.rsplit(".", 1)[0]
    api = sys.modules[pkg + ".api"]
    logger = sys.modules[pkg + ".output.logger"]
    real = api._time
    api._time = clock or PinnedClock()
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                rc = main(list(argv))
            except SystemExit as e:
                rc = e.code
    finally:
        api._time = real
        logger.set_log_handler(None)
    return rc, out.getvalue(), err.getvalue()


def flex_spec(dev, modulations, name=None, getters=("@0:{8}:id",)):
    """A ``-X`` spec with ``dev``'s modulation and timings: ``modulations``
    is the flex module's MODULATIONS (flex name -> slicer modulation)."""
    short = {v: k for k, v in modulations.items()}[dev.modulation]
    parts = [f"n={name or dev.symbol}", f"m={short}",
             f"s={dev.short_width:g}", f"l={dev.long_width:g}",
             f"y={dev.sync_width:g}", f"g={dev.gap_limit:g}",
             f"r={dev.reset_limit:g}", f"t={dev.tolerance:g}"]
    return ",".join(parts + [f"get={g}" for g in getters])


def fixture(name):
    """The one capture of a fixture directory."""
    d = os.path.join(REPO, "tests", "fixtures", name)
    return os.path.join(d, next(f for f in sorted(os.listdir(d))
                                if f.endswith(".cu8")))
