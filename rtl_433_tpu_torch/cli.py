"""rtl_433_tpu_torch command line interface (file replay).

Mirrors the rtl_433 flags of the replay path (ref src/rtl_433.c:103-167
usage, :399-1002 parser):

  -r <file>      replay a cu8 sample file (rate/freq parsed from the name,
                 "cu8:250k:path" prefixes override); also positional
  -R [-]<n>      enable only / disable protocol n (0 = disable all);
                 repeatable
  -F json|kv     output format (default: kv)
  -Y <mode>      FSK detector: auto|classic|minmax[,ampest|magest]
  --device cuda|cpu   where the engine runs (default: cuda; with no GPU
                 the run fails rather than falling back to the CPU)

Only the decoders ported so far can be registered.
"""

from __future__ import annotations

import sys

from .api import RtlTpu
from .output.sinks import JsonSink, KvSink


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    in_files, outputs, reg_actions = [], [], []
    fsk_mode = "auto"
    use_mag_est = False
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
        elif a == "-R":
            reg_actions.append(int(val().partition(":")[0]))
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
                else:
                    print(f"-Y {part} is not ported yet", file=sys.stderr)
                    return 2
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
                report_time="iso" if in_files else "off",
                register_all=False, device=device)
    # any -R suppresses the default registration; a negative -R first
    # registers all defaults; -R 0 clears everything registered so far
    # (ref src/rtl_433.c:820-851)
    no_default = False
    for v in reg_actions:
        if v < 0 and not no_default:
            rx.registry.register_all()
        no_default = True
        if v >= 1:
            rx.registry.register(v)
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
    for path in in_files:
        rx.decode_file(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
