"""rtl_433_tpu_torch command line interface (file replay and -y).

Mirrors the rtl_433 flags of the replay path (ref src/rtl_433.c:103-167
usage, :399-1002 parser):

  -r <file>      replay a cu8 sample file (rate/freq parsed from the name,
                 "cu8:250k:path" prefixes override); also positional
  -y <code>      decode a test string: "{n}hex" bit rows ("{24}abcdef
                 {24}abcdef") fed to every registered decoder, or an RfRaw
                 "AA B1 ..." pulse string run through the demods; repeatable
  -R [-]<n>[:<arg>]  enable only / disable protocol n (0 = disable all),
                 with an optional decoder argument; repeatable
  -F json|kv     output format (default: kv)
  -Y <mode>      FSK detector: auto|classic|minmax[,ampest|magest]
                 [,squelch][,autolevel[=<n>]][,deviceslice]: squelch
                 skips noise-only frames of live input; autolevel tracks
                 the minimum level with the noise floor; deviceslice
                 slices each drain's pulse trains in batched kernels on
                 the --device before decoding
  -M noise[:<secs>]  report the block level and the noise floor every
                 <secs> seconds (default 1); no other -M is ported yet
  --device cuda|cpu   where the engine runs (default: cuda; with no GPU
                 the run fails rather than falling back to the CPU)

With no -R, the default protocols are registered (every protocol not
disabled by default). With -y, the exit code is 1 when no code decoded.
"""

from __future__ import annotations

import sys

from .api import RtlTpu
from .output.sinks import JsonSink, KvSink


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    in_files, outputs, reg_actions, test_codes = [], [], [], []
    fsk_mode = "auto"
    use_mag_est = False
    y_opts, noise_parts, report_noise = {}, [], 0
    device = "cuda"
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(argv):
                print(f"option {a} requires a value", file=sys.stderr)
                sys.exit(2)
            return argv[i]

        if a == "-r":
            in_files.append(val())
        elif a == "-y":
            test_codes.append(val())
        elif a == "-R":
            # -R <num>[:<arg>] passes a decoder argument (ref src/r_api.c
            # register_protocol arg handling, e.g. blueline "-R 176:auto")
            num, _, parg = val().partition(":")
            reg_actions.append((int(num), parg or None))
        elif a == "-F":
            outputs.append(val())
        elif a == "-Y":
            for part in val().split(","):
                if part in ("auto", "classic", "minmax"):
                    fsk_mode = part
                elif part == "magest":
                    use_mag_est = True
                elif part == "ampest":
                    use_mag_est = False
                elif part == "squelch":
                    y_opts["squelch"] = True
                elif part.startswith("autolevel"):
                    # autolevel or autolevel=N (ref src/rtl_433.c:944-946)
                    y_opts["auto_level"] = (int(part[10:])
                                            if part[9:10] == "=" else 1)
                elif part == "deviceslice":
                    # batch (package, spec) slicing on the device
                    # (decoders/device_dispatch.py; no reference analogue)
                    y_opts["device_slice"] = True
                else:
                    print(f"-Y {part} is not ported yet", file=sys.stderr)
                    return 2
        elif a == "-M":
            key, *parts = val().split(":")
            if key != "noise":
                print(f"-M {key} is not ported yet", file=sys.stderr)
                return 2
            # repeated -M noise accumulates, like the reference applying
            # each invocation in turn (ref src/rtl_433.c:714-800)
            noise_parts.extend(parts)
            report_noise = int(noise_parts[0]) if noise_parts else 1
        elif a == "--device":
            device = val()
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        elif a.startswith("-"):
            print(f"option {a} is not ported yet", file=sys.stderr)
            return 2
        else:
            in_files.append(a)
        i += 1

    rx = RtlTpu(fsk_mode=fsk_mode, use_mag_est=use_mag_est,
                report_time="iso" if (in_files or test_codes) else "off",
                register_all=False, report_noise=report_noise,
                device=device, **y_opts)
    # any -R suppresses the default registration; a negative -R first
    # registers all defaults; -R 0 clears everything registered so far
    # (ref src/rtl_433.c:820-851)
    no_default = False
    for v, parg in reg_actions:
        if v < 0 and not no_default:
            rx.registry.register_all()
        no_default = True
        if v >= 1:
            rx.registry.register(v, parg)
        elif v <= -1:
            rx.registry.unregister(-v)
        else:
            rx.registry.active = []
    if not no_default:
        rx.registry.register_all()

    for spec in outputs or ["kv"]:
        kind = spec.split(":")[0].split(",")[0]
        if kind == "json":
            rx.sinks.append(JsonSink())
        elif kind == "kv":
            rx.sinks.append(KvSink())
        else:
            print(f"-F {kind} is not ported yet", file=sys.stderr)
            return 2
    n_events = 0
    for code in test_codes:
        n_events += len(rx.decode_test_string(code))
    for path in in_files:
        rx.decode_file(path)
    if test_codes and n_events == 0:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
