"""Pulse slicers: pulse/gap trains -> bitbuffers.

Exact-semantics host implementations of the reference slicers
(ref src/pulse_slicer.c:68-930): PCM/RZ with preamble bit-rate
re-estimation, PPM, PWM with 4 sync layouts, Manchester-zerobit, DMC,
PIWM raw/DC, NRZS, OSv1, RZI, and the `-y` string path.

Each slicer yields one BitBuffer per message (each `account_event` call in
the reference); the caller runs the decoder on each. Timings convert from
us with C float32 arithmetic to match integer truncation behavior.

These are event-rate functions (<=1200 pulses each); device slicing
runs the batched kernels of ops/slice.py instead.
"""

from __future__ import annotations

import numpy as np

from ..bits.bitbuffer import BitBuffer

INT_MAX = 2**31 - 1


def _s(us, samples_per_us):
    """int s_x = device->x * samples_per_us (float32 mult, C truncation)."""
    return int(np.float32(us) * np.float32(samples_per_us))


def _timings(pulses, device):
    samples_per_us = np.float32(pulses.sample_rate) / np.float32(1.0e6)
    t = {
        "short": _s(device.short_width, samples_per_us),
        "long": _s(device.long_width, samples_per_us),
        "reset": _s(device.reset_limit, samples_per_us),
        "gap": _s(device.gap_limit, samples_per_us),
        "sync": _s(device.sync_width, samples_per_us),
        "tolerance": _s(device.tolerance, samples_per_us),
    }
    # rounding-to-zero check (ref src/pulse_slicer.c:79-87)
    for name, us in (("short", device.short_width), ("long", device.long_width),
                     ("reset", device.reset_limit), ("gap", device.gap_limit),
                     ("sync", device.sync_width), ("tolerance", device.tolerance)):
        if us > 0 and t[name] <= 0:
            from ..output.logger import LOG_WARNING, print_logf
            print_logf(LOG_WARNING, "pulse_slicer",
                       'sample rate too low for protocol %u "%s"',
                       device.num, device.name)
            return None
    return t


def slicer_pcm(pulses, device):
    """Ref src/pulse_slicer.c:68-259."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset = t["short"], t["long"], t["reset"]
    s_gap, s_tolerance = t["gap"], t["tolerance"]
    samples_per_us = np.float32(pulses.sample_rate) / np.float32(1.0e6)

    f_short = 1.0 / float(np.float32(device.short_width) * samples_per_us) \
        if device.short_width > 0 else 0.0
    f_long = 1.0 / float(np.float32(device.long_width) * samples_per_us) \
        if device.long_width > 0 else 0.0

    events = []
    bits = BitBuffer()
    gap_limit = s_gap if s_gap else s_reset
    max_zeros = gap_limit // s_long if s_long else 0
    if s_tolerance <= 0:
        s_tolerance = s_long // 4

    P, G = pulses.pulse, pulses.gap
    n_p = len(P)

    # preamble-based bit period re-estimation (ref :104-132)
    min_count = 12 if s_short == s_long else 4
    preamble_len = 0
    if s_short != s_long:
        n = 0
        while n < n_p:
            swidth = lwidth = count = 0
            while (n < n_p
                    and P[n] >= s_short - s_tolerance
                    and P[n] <= s_short + s_tolerance
                    and P[n] + G[n] >= s_long - s_tolerance
                    and P[n] + G[n] <= s_long + s_tolerance):
                swidth += P[n]
                lwidth += P[n] + G[n]
                count += 1
                n += 1
            if count >= min_count:
                f_long = count / lwidth
                f_short = count / swidth
                min_count = count
                preamble_len = count
            n += 1
    # RZ anywhere-in-stream fallback (ref :137-157)
    if preamble_len == 0 and s_short != s_long:
        rzs = rzl = rzc = 0
        for n in range(n_p):
            if (P[n] >= s_short - s_tolerance and P[n] <= s_short + s_tolerance
                    and P[n] + G[n] >= s_long - s_tolerance
                    and P[n] + G[n] <= s_long + s_tolerance):
                rzs += P[n]
                rzl += P[n] + G[n]
                rzc += 1
        if rzc > 8:
            f_long = rzc / rzl
            f_short = rzc / rzs
    # NRZ preamble (ref :159-180)
    if s_short == s_long:
        n = 0
        while n < n_p:
            width = count = 0
            while (n < n_p
                    and int(P[n] * f_short + 0.5) == 1
                    and int(G[n] * f_long + 0.5) == 1):
                width += P[n] + G[n]
                count += 2
                n += 1
            if count >= min_count:
                f_short = f_long = count / width
                min_count = count
                preamble_len = count
            n += 1
    # NRZ anywhere fallback (ref :184-214)
    if preamble_len == 0 and s_short == s_long:
        nw = nc = 0
        for n in range(n_p):
            if s_short - s_tolerance <= P[n] <= s_short + s_tolerance:
                nw += P[n]; nc += 1
            if 2 * s_short - s_tolerance <= P[n] <= 2 * s_short + s_tolerance:
                nw += P[n]; nc += 2
            if s_long - s_tolerance <= G[n] <= s_long + s_tolerance:
                nw += G[n]; nc += 1
            if 2 * s_long - s_tolerance <= G[n] <= 2 * s_long + s_tolerance:
                nw += G[n]; nc += 2
        if nc > 20:
            f_short = f_long = nc / nw

    # main loop (ref :216-257)
    for n in range(n_p):
        highs = int(P[n] * f_short + 0.5)
        lows = int((G[n] + s_short - s_long) * f_long + 0.5)
        for _ in range(highs):
            bits.add_bit(1)
        lows = min(lows, max_zeros)
        for _ in range(lows):
            bits.add_bit(0)

        if s_short != s_long and abs(P[n] - s_short) > s_tolerance:
            bits.clear()
        elif G[n] > gap_limit and G[n] <= s_reset:
            bits.add_row()
        if ((n == n_p - 1 or G[n] > s_reset)
                and (bits.bits_per_row[0] > 0 or bits.num_rows > 1)):
            events.append(bits)
            bits = BitBuffer()
    return events


def slicer_ppm(pulses, device):
    """Ref src/pulse_slicer.c:261-337."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset = t["short"], t["long"], t["reset"]
    s_gap, s_sync, s_tolerance = t["gap"], t["sync"], t["tolerance"]

    events = []
    bits = BitBuffer()
    sync_l = sync_u = 0
    if s_tolerance > 0:
        zero_l, zero_u = s_short - s_tolerance, s_short + s_tolerance
        one_l, one_u = s_long - s_tolerance, s_long + s_tolerance
        if s_sync > 0:
            sync_l, sync_u = s_sync - s_tolerance, s_sync + s_tolerance
    else:
        zero_l = 0
        zero_u = (s_short + s_long) // 2 + 1
        one_l = zero_u - 1
        one_u = s_gap if s_gap else s_reset

    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    for n in range(n_p):
        if zero_l < G[n] < zero_u:
            bits.add_bit(0)
        elif one_l < G[n] < one_u:
            bits.add_bit(1)
        elif sync_l < G[n] < sync_u:
            bits.add_sync()
        elif G[n] < s_reset:
            bits.add_row()
        if ((n == n_p - 1 or G[n] >= s_reset)
                and (bits.bits_per_row[0] > 0 or bits.num_rows > 1)):
            events.append(bits)
            bits = BitBuffer()
    return events


def slicer_pwm(pulses, device):
    """Ref src/pulse_slicer.c:339-449."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset = t["short"], t["long"], t["reset"]
    s_gap, s_sync, s_tolerance = t["gap"], t["sync"], t["tolerance"]

    events = []
    bits = BitBuffer()
    sync_l = sync_u = 0
    if s_tolerance > 0:
        one_l, one_u = s_short - s_tolerance, s_short + s_tolerance
        zero_l, zero_u = s_long - s_tolerance, s_long + s_tolerance
        if s_sync > 0:
            sync_l, sync_u = s_sync - s_tolerance, s_sync + s_tolerance
    elif s_sync <= 0:
        one_l, one_u = 0, (s_short + s_long) // 2 + 1
        zero_l, zero_u = one_u - 1, INT_MAX
    elif s_sync < s_short:
        sync_l, sync_u = 0, (s_sync + s_short) // 2 + 1
        one_l, one_u = sync_u - 1, (s_short + s_long) // 2 + 1
        zero_l, zero_u = one_u - 1, INT_MAX
    elif s_sync < s_long:
        one_l, one_u = 0, (s_short + s_sync) // 2 + 1
        sync_l, sync_u = one_u - 1, (s_sync + s_long) // 2 + 1
        zero_l, zero_u = sync_u - 1, INT_MAX
    else:
        one_l, one_u = 0, (s_short + s_long) // 2 + 1
        zero_l, zero_u = one_u - 1, (s_long + s_sync) // 2 + 1
        sync_l, sync_u = zero_u - 1, INT_MAX

    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    for n in range(n_p):
        if one_l < P[n] < one_u:
            bits.add_bit(1)
        elif zero_l < P[n] < zero_u:
            bits.add_bit(0)
        elif sync_l < P[n] < sync_u:
            bits.add_sync()
        elif P[n] <= one_l:
            pass  # spurious short pulse
        else:
            bits.add_row()

        if ((n == n_p - 1 or G[n] > s_reset) and bits.num_rows > 0):
            events.append(bits)
            bits = BitBuffer()
        elif (s_gap > 0 and G[n] > s_gap and bits.num_rows > 0
              and bits.bits_per_row[bits.num_rows - 1] > 0):
            bits.add_row()
    return events


def slicer_manchester_zerobit(pulses, device):
    """Ref src/pulse_slicer.c:451-527."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_reset, s_tolerance = t["short"], t["reset"], t["tolerance"]

    events = []
    time_since_last = 0
    bits = BitBuffer()
    bits.add_bit(0)  # hardcoded first zero

    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    for n in range(n_p):
        if (s_tolerance > 0
                and (P[n] < s_short - s_tolerance
                     or P[n] > s_short * 2 + s_tolerance
                     or G[n] < s_short - s_tolerance
                     or G[n] > s_short * 2 + s_tolerance)):
            if (P[n] > s_short * 1.5 and P[n] <= s_short * 2 + s_tolerance):
                bits.add_bit(1)
            bits.add_row()
            bits.add_bit(0)
            time_since_last = 0
        elif P[n] + time_since_last > (s_short * 1.5):
            bits.add_bit(1)
            time_since_last = 0
        else:
            time_since_last += P[n]

        if ((n == n_p - 1 or G[n] > s_reset) and bits.num_rows > 0):
            events.append(bits)
            bits = BitBuffer()
            bits.add_bit(0)
            time_since_last = 0
        elif G[n] + time_since_last > (s_short * 1.5):
            bits.add_bit(0)
            time_since_last = 0
        else:
            time_since_last += G[n]
    return events


def _symbol(pulses, n):
    """Ref src/pulse_slicer.c:529-535."""
    return pulses.pulse[n // 2] if n % 2 == 0 else pulses.gap[n // 2]


def slicer_dmc(pulses, device):
    """Differential Manchester. Ref src/pulse_slicer.c:537-595."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset, s_tolerance = \
        t["short"], t["long"], t["reset"], t["tolerance"]

    bits = BitBuffer()
    events = []
    n2 = pulses.num_pulses * 2
    n = 0
    while n < n2:
        symbol = _symbol(pulses, n)
        if abs(symbol - s_short) < s_tolerance:
            bits.add_bit(1)
            if n + 1 < n2:
                n += 1
                symbol = _symbol(pulses, n)
            else:
                symbol = 0
            if abs(symbol - s_short) > s_tolerance:
                if symbol >= s_reset - s_tolerance:
                    n -= 1
                elif bits.num_rows > 0 and bits.bits_per_row[bits.num_rows - 1] > 0:
                    bits.add_row()
        elif abs(symbol - s_long) < s_tolerance:
            bits.add_bit(0)
        elif symbol >= s_reset - s_tolerance and bits.num_rows > 0:
            events.append(bits)
            bits = BitBuffer()
        n += 1
    return events


def slicer_piwm_raw(pulses, device):
    """Ref src/pulse_slicer.c:597-657."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset, s_tolerance = \
        t["short"], t["long"], t["reset"], t["tolerance"]
    samples_per_us = np.float32(pulses.sample_rate) / np.float32(1.0e6)
    f_short = 1.0 / float(np.float32(device.short_width) * samples_per_us) \
        if device.short_width > 0 else 0.0

    bits = BitBuffer()
    events = []
    n2 = pulses.num_pulses * 2
    for n in range(n2):
        symbol = _symbol(pulses, n)
        w = int(symbol * f_short + 0.5)
        if symbol > s_long:
            bits.add_row()
        elif abs(symbol - w * s_short) < s_tolerance:
            for _ in range(w, 0, -1):
                bits.add_bit(1 - n % 2)
        elif (symbol < s_reset and bits.num_rows > 0
              and bits.bits_per_row[bits.num_rows - 1] > 0):
            bits.add_row()
        if ((n == n2 - 1 or symbol > s_reset) and bits.num_rows > 0):
            events.append(bits)
            bits = BitBuffer()
    return events


def slicer_piwm_dc(pulses, device):
    """Ref src/pulse_slicer.c:659-713."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_long, s_reset, s_tolerance = \
        t["short"], t["long"], t["reset"], t["tolerance"]

    bits = BitBuffer()
    events = []
    n2 = pulses.num_pulses * 2
    for n in range(n2):
        symbol = _symbol(pulses, n)
        if abs(symbol - s_short) < s_tolerance:
            bits.add_bit(1)
        elif abs(symbol - s_long) < s_tolerance:
            bits.add_bit(0)
        elif (symbol < s_reset and bits.num_rows > 0
              and bits.bits_per_row[bits.num_rows - 1] > 0):
            bits.add_row()
        if ((n == n2 - 1 or symbol > s_reset) and bits.num_rows > 0):
            events.append(bits)
            bits = BitBuffer()
    return events


def slicer_nrzs(pulses, device):
    """Ref src/pulse_slicer.c:715-759."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_reset = t["short"], t["reset"]
    limit = s_short

    bits = BitBuffer()
    events = []
    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    for n in range(n_p):
        if P[n] > limit:
            for _ in range(P[n] // limit):
                bits.add_bit(1)
            bits.add_bit(0)
        elif P[n] < limit:
            bits.add_bit(0)
        if n == n_p - 1 or G[n] >= s_reset:
            events.append(bits)
            bits = BitBuffer()
    return events


def slicer_osv1(pulses, device):
    """Oregon Scientific v1. Ref src/pulse_slicer.c:775-864."""
    t = _timings(pulses, device)
    if t is None:
        return []
    s_short, s_reset = t["short"], t["reset"]

    events = []
    manbit = 0
    bits = BitBuffer()
    halfbit_min = s_short // 2
    halfbit_max = s_short * 3 // 2
    sync_min = 2 * halfbit_max

    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    preamble = 0
    n = 0
    while n < n_p:
        if P[n] > halfbit_min and G[n] > halfbit_min:
            preamble += 1
            if G[n] > halfbit_max:
                break
        else:
            return events
        n += 1
    if preamble != 12:
        return events

    n += 1
    if n >= n_p or P[n] < sync_min or G[n] < sync_min:
        return events

    if G[n] > P[n]:
        manbit ^= 1
        if manbit:
            bits.add_bit(0)

    n += 1
    while n < n_p:
        manbit ^= 1
        if manbit:
            bits.add_bit(1)
        if P[n] > halfbit_max:
            manbit ^= 1
            if manbit:
                bits.add_bit(1)
        if (n == n_p - 1 or G[n] > s_reset) and bits.num_rows > 0:
            events.append(bits)
            return events
        manbit ^= 1
        if manbit:
            bits.add_bit(0)
        if G[n] > halfbit_max:
            manbit ^= 1
            if manbit:
                bits.add_bit(0)
        n += 1
    return events


def slicer_rzi(pulses, device):
    """Return-to-Zero-Inverted. Ref src/pulse_slicer.c:866-918."""
    samples_per_us = np.float32(pulses.sample_rate) / np.float32(1.0e6)
    s_short = _s(device.short_width, samples_per_us)
    s_long = _s(device.long_width, samples_per_us)
    s_reset = _s(device.reset_limit, samples_per_us)
    if ((device.short_width > 0 and s_short <= 0)
            or (device.long_width > 0 and s_long <= 0)
            or (device.reset_limit > 0 and s_reset <= 0)):
        return []
    s_base = s_long - s_short

    bits = BitBuffer()
    events = []
    at_start = 1
    P, G = pulses.pulse, pulses.gap
    n_p = len(P)
    for n in range(n_p):
        high = P[n]
        if at_start:
            ones = (high + s_long // 2) // s_long
        else:
            ones = (high - s_base + s_long // 2) // s_long
        at_start = 0
        ones = max(ones, 0)
        for _ in range(ones):
            bits.add_bit(1)
        if G[n] > s_reset or n == n_p - 1:
            if bits.bits_per_row[0] > 0:
                events.append(bits)
            bits = BitBuffer()
            at_start = 1
            continue
        bits.add_bit(0)
    return events


def slicer_string(code: str):
    """-y test-data path (ref src/pulse_slicer.c:920-930)."""
    return [BitBuffer.parse(code)]


# modulation id -> slicer (ref include/r_device.h modulation enum)
# OOK demod numbers 3..16, FSK 16..
MOD_OOK_PCM = 3
MOD_OOK_PPM = 4
MOD_OOK_PWM = 5
MOD_OOK_PIWM_RAW = 6
MOD_OOK_PIWM_DC = 7
MOD_OOK_DMC = 8
MOD_OOK_MC_ZEROBIT = 9
MOD_OOK_OSV1 = 10
MOD_OOK_RZ = 11
MOD_OOK_NRZS = 12
MOD_OOK_RZI = 13
MOD_FSK_MIN = 16
MOD_FSK_PCM = 16
MOD_FSK_PWM = 17
MOD_FSK_MC_ZEROBIT = 18

SLICERS = {
    "OOK_PULSE_PCM": slicer_pcm,
    "OOK_PULSE_RZ": slicer_pcm,
    "OOK_PULSE_PPM": slicer_ppm,
    "OOK_PULSE_PWM": slicer_pwm,
    "OOK_PULSE_MANCHESTER_ZEROBIT": slicer_manchester_zerobit,
    "OOK_PULSE_DMC": slicer_dmc,
    "OOK_PULSE_PIWM_RAW": slicer_piwm_raw,
    "OOK_PULSE_PIWM_DC": slicer_piwm_dc,
    "OOK_PULSE_NRZS": slicer_nrzs,
    "OOK_PULSE_PWM_OSV1": slicer_osv1,
    "OOK_PULSE_RZI": slicer_rzi,
    "FSK_PULSE_PCM": slicer_pcm,
    "FSK_PULSE_PWM": slicer_pwm,
    "FSK_PULSE_MANCHESTER_ZEROBIT": slicer_manchester_zerobit,
}


def is_fsk_modulation(mod: str) -> bool:
    return mod.startswith("FSK_")


def slice_pulses(pulses, device):
    """Dispatch to the device's slicer; returns list of BitBuffers."""
    fn = SLICERS.get(device.modulation)
    if fn is None:
        return []
    return fn(pulses, device)
