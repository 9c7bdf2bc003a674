"""The committed fixture corpus, for the port's replay tests and
chip_smoke.py.

Walks ``tests/fixtures/<device>/gNNN_<freq>M_<rate>k.cu8`` as
tests/test_fixture_replay.py does: each capture's ``protocol`` file holds
its protocol number(s), the ``.json`` beside it the expected events.
Imports neither torch nor jax.
"""

import glob
import json
import os

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def cases():
    """[(name, [protocol numbers], cu8 path)] in sorted path order."""
    out = []
    for cu8 in sorted(glob.glob(os.path.join(FIXTURES, "*", "*.cu8"))):
        ddir = os.path.dirname(cu8)
        with open(os.path.join(ddir, "protocol")) as f:
            nums = [int(x) for x in f.read().split()]
        out.append((os.path.basename(ddir), nums, cu8))
    return out


def expected(cu8):
    """The committed events of a capture."""
    with open(cu8[:-4] + ".json") as f:
        return [json.loads(line) for line in f if line.strip()]


def normalize(ev):
    """tests/test_corpus_parity.py's normalization: time dropped, floats
    rounded to 3 places."""
    ev = dict(ev)
    ev.pop("time", None)
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in ev.items()}


def sample_rate(cu8):
    """The rate token of a fixture name, in S/s ("..._250k.cu8")."""
    return int(os.path.basename(cu8)[:-4].rsplit("_", 1)[1][:-1]) * 1000
