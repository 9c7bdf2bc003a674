"""bench.py's signal-dense workload, built without the JAX package.

The same blocks as ``bench.py::build_blocks``, byte for byte (a CPU test
compares them): [rotations] CU8 blocks of [channels, n, 2]; a quarter of
the channels burst once every ``rotations`` blocks, 80% LaCrosse TX35
FSK-PCM and 20% Silvercrest PWM, each with its own payload. bench.py
imports the JAX package for its CRC; this copy takes the port's, so that
chip_smoke.py can build the workload on a machine without JAX.
"""

import numpy as np

import synth
from rtl_433_tpu_torch.bits import util


def lacrosse_burst(id_, t_bcd, hum, seed):
    """Valid LaCrosse TX35 FSK frame (decodes as TX35 + TX29)."""
    b0 = 0x90 | (id_ >> 2)
    b1 = ((id_ & 3) << 6) | t_bcd[0]
    b2 = (t_bcd[1] << 4) | t_bcd[2]
    b3 = hum
    crc = util.crc8(bytes([b0, b1, b2, b3]), 4, 0x31, 0x00)
    payload = f"{b0:08b}{b1:08b}{b2:08b}{b3:08b}{crc:08b}"[4:]
    bits = "10101010" * 4 + "0010110111010100" + "1001" + payload
    return synth.synth_fsk(synth.fsk_pcm_bits(bits, bit_us=55, preamble=""),
                           rate=250_000, lead_in_us=16_000, tail_us=20_000,
                           seed=seed)


def silvercrest_burst(cmd, seed):
    """Valid Silvercrest PWM remote burst."""
    lut = [2, 3, 0, 1, 4, 5, 7, 6, 0xC, 0xD, 0xF, 0xE, 8, 9, 0xB, 0xA]
    msg = (0x7C << 25) | (0x26 << 17) | (cmd << 9) | (lut[cmd] << 1)
    bits = format(msg, "033b")
    train = []
    for rep in range(3):
        for k, b in enumerate(bits):
            last = k == len(bits) - 1
            gap = 6000 if last else (744 if b == "1" else 264)
            train.append((264 if b == "1" else 744, gap))
    train[-1] = (train[-1][0], 16000)
    return synth.synth_ook(train, rate=250_000, lead_in_us=20_000,
                           tail_us=20_000, seed=seed)


def burst_of(channel, rotations, active_every=4):
    """(rotation, kind) of a channel's burst, or None for a quiet one."""
    if channel % active_every:
        return None
    k = channel // active_every
    return k % rotations, "silvercrest" if k % 5 == 4 else "lacrosse"


def build_blocks(channels, n, rotations, active_every=4):
    """[rotations] CU8 blocks; channel c (c%active_every==0) bursts in
    rotation (c//active_every) % rotations with a per-channel payload.
    Returns (blocks, number of bursts)."""
    rng = np.random.default_rng(0)
    blocks = []
    n_bursts = 0
    for r in range(rotations):
        blk = rng.integers(123, 133, size=(channels, n, 2), dtype=np.uint8)
        for c in range(0, channels, active_every):
            if (c // active_every) % rotations != r:
                continue
            k = c // active_every
            if k % 5 == 4:
                burst = silvercrest_burst((k + r) & 0xF, seed=k)
            else:
                burst = lacrosse_burst((k * 7 + r) & 0x3F,
                                       ((k % 7), (k % 10), (r % 10)),
                                       20 + k % 70, seed=k)
            off = (c * 9973) % max(1, n - burst.shape[0] - 256)
            blk[c, off:off + burst.shape[0]] = burst
            n_bursts += 1
        blocks.append(blk)
    return blocks, n_bursts
