"""Run ``chip_smoke.py --timeshard-only`` against a package whose time-shard
step reads the chain's verdict before it launches the gather (the gather
then runs only on a verified block, as a plain launch, and has no ``pdl``
argument). Run from the root of that checkout with this file and the
newer chip_smoke.py copied in:

    python3 parent_compat.py

Each gather launch counts as one that copied, and the step's order timed
as pair_behind is that package's own: pair_host_read.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from rtl_433_tpu_torch.ops import _cuda  # noqa: E402
from rtl_433_tpu_torch.ops import timeshard as ots  # noqa: E402

_cuda.LAUNCHES["timeshard_gather_copied"] = 0
_gather = ots.timeshard_gather_cuda


def gather(*args, pdl=True, **kw):
    _cuda.LAUNCHES["timeshard_gather_copied"] += 1
    return _gather(*args, **kw)


ots.timeshard_gather_cuda = gather
chip_smoke.pair_behind = lambda *a, pdl=True: chip_smoke.pair_host_read(*a)
sys.argv = [chip_smoke.__file__, "--timeshard-only"]
sys.exit(chip_smoke.main())
