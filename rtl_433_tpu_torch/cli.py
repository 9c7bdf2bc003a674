"""rtl_433_tpu_torch command line interface (file replay, live input, -y,
the network outputs and the HTTP control server).

Mirrors the rtl_433 flags (ref src/rtl_433.c:103-167 usage, :399-1002
parser):

  Input
  -r <file>      replay a sample file (cu8/cs8/cs16/cf32/ook/sigmf; rate/freq
                 parsed from the name, "cu8:250k:path" prefixes override);
                 also positional
  -d rtl_tcp[:host[:port]]   live IQ from an rtl_tcp server
  -y <code>      decode test data ({n}hex rows or RfRaw strings)
  -n <n>         stop after n samples (metric suffixes ok; live input only)
  -f <freq>      center frequency; repeat for hop list (metric suffixes ok)
  -H <secs>      hop interval for multiple -f frequencies (live input only)
  -s <rate>      sample rate
  -c <file>      read options from a config file (long keywords, repeatable;
                 rtl_433.conf is auto-loaded from CWD/XDG/etc paths)

  Decoding
  -R [-]<n>[:arg]  enable only / disable protocol n (0 = disable all)
  -X <spec>      add a flex general-purpose decoder (same grammar as rtl_433)
  -Y <mode>      FSK detector: auto|classic|minmax[,ampest|magest]
                 [,level=<dB>][,minlevel=<dB>][,minsnr=<dB>][,squelch]
                 [,autolevel[=N]][,filter=<us|Hz|ratio>][,deviceslice]:
                 deviceslice slices each drain's pulse trains in batched
                 kernels on the --device before decoding
  -g <dB>, -p <ppm>  tuner gain and frequency correction (live input only)
  -A             pulse analyzer hints for detected packages (on stderr)
  -a             (deprecated in the reference; accepted, no-op)

  Output
  -F <fmt>       add an output, repeatable: json | jsons | kv | log | csv
                 | null, each with an optional ",v=<level>" log level;
                 mqtt[s]:host[:port][,user=,pass=,retain=,qos=,base=,
                     events=,devices=,states=,availability=,tls_ca_cert=,
                     tls_cert=,tls_key=,tls_insecure]
                 influx[:url,token=...] | syslog:host[:port]
                 trigger:<file> | http[:host[:port]] (events, /cmd and
                 /jsonrpc control verbs, /ws, /metrics);
                 rtltcp[:host[:port]] re-serves the raw IQ stream
  -M <meta>      time[:rel|unix|iso|usec|tz|utc|local] | protocol | level
                 | noise[:secs] | stats[:level[:interval]] | replay[:N]
                 | bits | newmodel | oldmodel
  -C <mode>      unit conversion: native|si|customary
  -K <tag>       data tag: FILE|PATH|<str>|gpsd[:...]|tcp:host:port
  -w/-W <file>   write samples to file ('-W' overwrites): cu8, cs8, cs16,
                 cf32, am.s16, fm.s16, am.f32, fm.f32, U8:LOGIC:<path>,
                 .ook, .vcd, or a .sr PulseView session
  -S <mode>      signal grabber: all|unknown|known
  -E <mode>, -T <secs>, -D <mode>  hop/quit after outputs, duration,
                 watchdog: quit|restart|pause|manual (live input only)
  -v             increase verbosity (repeatable)
  -V             print this package's name and version
  --device cuda|cpu   where the engine runs (default: cuda; with no GPU
                 the run fails rather than falling back to the CPU)

Exit codes follow the reference: 0 ok, 1 = -y decoded nothing
(ref src/rtl_433.c:1661), 2 = a usage error, an input file or an rtl_tcp
server that cannot be opened, 3 = live input stalled (ref
src/rtl_433.c:1412).
"""

from __future__ import annotations

import sys

from .api import RtlTpu
from .output.data_model import event_to_json, event_to_jsons, event_to_kv


def _metric(v: str) -> float:
    v = v.strip()
    mult = 1.0
    if v and v[-1] in "kKmMgG":
        mult = {"k": 1e3, "m": 1e6, "g": 1e9}[v[-1].lower()]
        v = v[:-1]
    return float(v) * mult


def main(argv=None):
    from .output.logger import set_log_handler
    set_log_handler(None)  # drop any handler left by a prior invocation
    argv = list(sys.argv[1:] if argv is None else argv)
    in_files = []
    test_codes = []
    outputs = []
    # ordered -R/-X registration actions: ("R", num, arg) / ("X", spec, None)
    reg_actions = []
    freq = 433_920_000.0
    rate = None
    fsk_mode = "auto"
    use_mag_est = False
    convert = "native"
    meta = set()
    meta_opts = {}
    y_opts = {}
    verbosity = 0
    analyze = False

    source = None       # -d
    max_samples = None
    run_mode = "quit"
    hop_times = []
    frequencies = []
    after_events = None
    duration = None
    dumper_specs = []
    grab_mode = None
    tag_specs = []
    device = "cuda"     # where the engine runs

    # conf files: explicit -c plus default search (ref src/rtl_433.c:466-490)
    from .confparse import find_default_conf, parse_conf_file
    expanded = []
    default_conf = find_default_conf()
    if default_conf:
        expanded += parse_conf_file(default_conf)
    j = 0
    while j < len(argv):
        if argv[j] == "-c" and j + 1 < len(argv):
            expanded += parse_conf_file(argv[j + 1])
            j += 2
        else:
            expanded.append(argv[j])
            j += 1
    argv = expanded

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

        if a == "-d":
            source = val()
        elif a == "-n":
            max_samples = int(_metric(val()))
        elif a in ("-w", "-W"):
            dumper_specs.append(val())
        elif a == "-S":
            grab_mode = val()
        elif a == "-K":
            tag_specs.append(val())
        elif a == "-D":
            run_mode = val()
            if run_mode not in ("quit", "restart", "pause", "manual"):
                run_mode = "quit"
        elif a == "-H":
            hop_times.append(_metric(val()))
        elif a == "-E":
            after_events = val()
        elif a == "-T":
            duration = _metric(val())
        elif a == "-g":
            # tuner gain in dB ("auto"/empty = leave the server default),
            # applied over rtl_tcp (ref src/sdr.c set_gain)
            v = val()
            try:
                y_opts["gain_db"] = float(v)
            except ValueError:
                if v.strip().lower() not in ("", "auto"):
                    print(f"rtl_433_tpu_torch: ignoring malformed gain {v!r} "
                          "(expected dB value or 'auto')", file=sys.stderr)
        elif a == "-p":
            y_opts["ppm_error"] = int(float(val()))  # tuner ppm correction
        elif a in ("-G", "-b", "-l", "-t",
                   "-I", "-z", "-x", "-a"):
            val()  # accepted for CLI compat; no-op or handled elsewhere
        elif a == "-r":
            in_files.append(val())
        elif a == "-y":
            test_codes.append(val())
        elif a == "-X":
            reg_actions.append(("X", val(), None))
        elif a == "-F":
            outputs.append(val())
        elif a == "-R":
            v = val()
            # -R <num>[:<arg>] passes a decoder argument (ref src/r_api.c
            # register_protocol arg handling, e.g. blueline "-R 176:auto")
            num, _, parg = v.partition(":")
            reg_actions.append(("R", int(num), parg or None))
        elif a == "-f":
            freq = _metric(val())
            frequencies.append(freq)
        elif a == "-s":
            rate = int(_metric(val()))
        elif a == "-Y":
            # -Y auto|classic|minmax,level=,minlevel=,minsnr=,squelch,
            #    ampest|magest (ref src/rtl_433.c usage, src/r_api.c:148-166)
            for part in val().split(","):
                if part in ("auto", "classic", "minmax"):
                    fsk_mode = part
                elif part == "magest":
                    use_mag_est = True
                elif part == "ampest":
                    use_mag_est = False
                elif part.startswith("level="):
                    y_opts["fixed_level_db"] = float(part[6:])
                elif part.startswith("minlevel="):
                    y_opts["min_level_db"] = float(part[9:])
                elif part.startswith("minsnr="):
                    y_opts["min_snr_db"] = float(part[7:])
                elif part == "squelch":
                    y_opts["squelch"] = True
                elif part.startswith("autolevel"):
                    # autolevel or autolevel=N (ref src/rtl_433.c:944-946)
                    y_opts["auto_level"] = (int(part[10:])
                                            if part[9:10] == "=" else 1)
                elif part.startswith("filter="):
                    # FM low-pass cutoff: us (1-9999), Hz (10000+), or
                    # ratio of fs (ref src/rtl_433.c:978, r_flow.c:204)
                    y_opts["fm_filter"] = float(part[7:])
                elif part == "deviceslice":
                    # batch (package, spec) slicing on the accelerator
                    # (decoders/device_dispatch.py; no reference analogue)
                    y_opts["device_slice"] = True
        elif a == "-C":
            convert = val()
        elif a == "-M":
            m = val()
            meta.add(m.split(":")[0])
            # repeated -M for the same key accumulates, like the reference
            # applying each invocation in turn (ref src/rtl_433.c:714-800)
            meta_opts.setdefault(m.split(":")[0], []).extend(m.split(":")[1:])
        elif a == "-A":
            analyze = True
        elif a == "--device":
            device = val()
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("-v"):
            verbosity += a.count("v")
        elif a == "-V":
            from . import __version__
            print(f"rtl_433_tpu_torch version {__version__}")
            return 0
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            in_files.append(a)  # positional = input file
        i += 1

    if rate is None:
        # auto 1 MS/s above 800 MHz (ref src/rtl_433.c:558-562)
        rate = 1_024_000 if freq > 800_000_000 else 250_000

    # -M time:rel|unix|iso|usec|sec|tz|utc|local (ref src/rtl_433.c:687-740);
    # token matching is prefix-based and ordered as in the reference, so
    # "notz" hits the "no" (= off) check first — a faithfully kept quirk
    time_parts = meta_opts.get("time", [])
    report_time = "iso" if ("time" in meta or in_files or test_codes) \
        else "off"
    time_hires = "usec" in time_parts
    time_utc = "utc" in time_parts
    time_tz = False
    for p in time_parts:
        lp = p.lower()
        if lp.startswith(("0", "no", "off")):
            report_time = "off"
        elif lp.startswith(("1", "yes", "on")):
            report_time = "iso"
        elif lp.startswith("rel"):
            report_time = "samples"
        elif lp.startswith("unix"):
            report_time = "unix"
        elif lp.startswith("iso"):
            report_time = "iso8601"
        elif lp.startswith("usec"):
            time_hires = True
        elif lp.startswith("sec"):
            time_hires = False
        elif lp.startswith("tz"):
            time_tz = True
        elif lp.startswith("utc"):
            time_utc = True
        elif lp.startswith("local"):
            time_utc = False
        else:
            print(f"Unknown time format option: {p}", file=sys.stderr)
    noise_parts = meta_opts.get("noise", [])
    if "noise" in meta:
        y_opts["report_noise"] = int(noise_parts[0]) if noise_parts else 1
    # -M replay[:N]: N-times realtime file replay (ref src/rtl_433.c:790)
    replay_parts = meta_opts.get("replay", [])
    in_replay = 0
    if "replay" in meta:
        in_replay = int(replay_parts[0]) if replay_parts and \
            replay_parts[0] else 1
    # -M stats[:level][:interval] (ref src/rtl_433.c:783-788)
    stats_parts = meta_opts.get("stats", [])
    report_stats = 0
    stats_interval = 600
    if "stats" in meta:
        report_stats = int(stats_parts[0]) if stats_parts and \
            stats_parts[0] else 1
        if len(stats_parts) > 1 and stats_parts[1]:
            stats_interval = int(_metric(stats_parts[1]))

    rx = RtlTpu(sample_rate=rate, center_frequency=freq, fsk_mode=fsk_mode,
                use_mag_est=use_mag_est, convert=convert,
                analyze=analyze,
                report_meta="level" in meta,
                report_protocol="protocol" in meta,
                report_time=report_time,
                report_time_hires=time_hires,
                report_time_utc=time_utc,
                report_time_tz=time_tz,
                verbosity=verbosity,
                verbose_bits="bits" in meta,
                **y_opts,
                register_all=False, device=device)
    rx.in_replay = in_replay
    rx.report_stats = report_stats
    rx.stats_interval = stats_interval

    # Ordered -R/-X replay (ref src/rtl_433.c:820-851, defaults at :1511):
    # any -R suppresses the default registration; a negative -R first
    # registers all defaults; -R 0 clears everything registered so far
    # (including earlier -X flex decoders); with no -R at all, defaults
    # register after option parsing, i.e. AFTER any -X decoders, so flex
    # devices dispatch (and print) first.
    from .decoders.flex import flex_create_device
    no_default = False
    for kind, v, parg in reg_actions:
        if kind == "X":
            rx.registry.add_device(flex_create_device(v))
            continue
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

    sr_filename = None
    for spec in dumper_specs:
        from .io.grab import Dumper
        if spec.endswith(".sr"):
            # PulseView session: register the sigrok channel set
            # (ref src/r_api.c:1089-1099, 1177-1181)
            sr_filename = spec
            for ch in ("U8:LOGIC:logic-1-1", "F32:I:analog-1-4-1",
                       "F32:Q:analog-1-5-1", "F32:AM:analog-1-6-1",
                       "F32:FM:analog-1-7-1"):
                rx.dumpers.append(Dumper(ch, rate))
        else:
            rx.dumpers.append(Dumper(spec, rate))
    if grab_mode is not None and grab_mode != "none":
        from .io.grab import SampGrab
        rx.samp_grab = SampGrab(grab_mode or "all")
    for spec in tag_specs:
        from .output.network import DataTagger
        rx.taggers.append(DataTagger(
            spec, current_file_fn=lambda: rx._current_file))

    outputs_explicit = bool(outputs)
    if not outputs:
        # default event output plus a stderr log sink (the reference
        # defaults to kv which doubles as its log output,
        # ref src/rtl_433.c:1500-1506)
        outputs = ["json", "log"]

    # the -K tag clients' threads stop with the outputs
    closers = [t.close for t in rx.taggers]
    for spec in outputs:
        fmt, _, arg = spec.partition(":")
        # "-F json,v=8:path" attaches a per-sink log_level (lvlarg_param,
        # ref src/r_api.c:938-960): log messages with level <= v reach
        # this sink through the fan-out (redirect_logging below)
        fmt, _, lvl_str = fmt.partition(",")
        log_lvl = None
        if lvl_str:
            k, _, v = lvl_str.replace(" ", "").partition("=")
            if k != "v" or not v.isdigit():
                print(f"Unknown output option \"{lvl_str}\"",
                      file=sys.stderr)
                return 2
            log_lvl = int(v)
        if fmt in ("json", "jsons"):
            from .output.sinks import JsonSink
            rx.sinks.append(JsonSink(compact=fmt == "jsons",
                                     log_level=log_lvl or 0))
        elif fmt == "kv":
            def emit_kv(ev):
                print(event_to_kv(ev, color=sys.stdout.isatty()))
                print("", flush=True)
            emit_kv.log_level = 8 if log_lvl is None else log_lvl
            rx.sinks.append(emit_kv)
        elif fmt == "log":
            from .output.sinks import LogSink
            rx.sinks.append(LogSink(log_level=8 if log_lvl is None
                                    else log_lvl))
        elif fmt == "csv":
            from .output.sinks import CsvSink, determine_csv_fields
            rx.sinks.append(CsvSink(
                determine_csv_fields(rx.registry.active,
                                     verbose_bits=rx.verbose_bits),
                log_level=log_lvl or 0))
        elif fmt == "syslog":
            from .output.network import SyslogSink
            host, _, port = arg.partition(":")
            rx.sinks.append(SyslogSink(host or "localhost",
                                       int(port or 514),
                                       log_level=4 if log_lvl is None
                                       else log_lvl))
        elif fmt == "trigger":
            from .output.network import TriggerSink
            rx.sinks.append(TriggerSink(arg or "/dev/stdout"))
        elif fmt in ("mqtt", "mqtts"):
            # -F mqtt[s]:host[:port][,opt=val,...] (ref src/output_mqtt.c
            # help at src/rtl_433.c:264-280; mqtts/tls opts :160-161)
            from .output.network import MqttSink
            head, _, opts_str = arg.partition(",")
            host, _, port = head.partition(":")
            kw = {"tls": fmt == "mqtts"}
            for opt in opts_str.split(","):
                if not opt:
                    continue
                k, _, v = opt.partition("=")
                if k in ("user", "u"):
                    kw["user"] = v
                elif k in ("pass", "p"):
                    kw["password"] = v
                elif k == "retain":
                    kw["retain"] = v != "0"
                elif k == "qos":
                    kw["qos"] = int(v or 0)
                elif k in ("events", "devices", "states", "availability",
                           "base"):
                    kw[k] = v
                elif k == "tls":
                    kw["tls"] = True
                elif k in ("tls_ca_cert", "tls_cert", "tls_key"):
                    kw[k] = v
                elif k == "tls_insecure":
                    kw["tls_insecure"] = True
            sink = MqttSink(host or "localhost",
                            int(port or (8883 if kw["tls"] else 1883)), **kw)
            rx.sinks.append(sink)
            closers.append(sink.close)
        elif fmt == "influx":
            from .output.network import InfluxSink
            rx.sinks.append(InfluxSink(arg) if arg else InfluxSink())
        elif fmt == "http":
            # events and the control verbs (output/http_server.py)
            from .output.http_server import HttpServerSink
            host, _, port = arg.partition(":")
            sink = HttpServerSink(rx, host or "0.0.0.0", int(port or 8433))
            rx.sinks.append(sink)
            closers.append(sink.close)
        elif fmt == "rtltcp":
            # raw IQ passthrough server (ref src/output_rtltcp.c:519)
            from .io.rtltcp import RtlTcpServer
            host, _, port = arg.partition(":")
            srv = RtlTcpServer(host or "0.0.0.0", int(port or 6778))
            rx.raw_taps.append(srv.broadcast)
            closers.append(srv.close)
        elif fmt == "null":
            pass
        else:
            print(f"unknown output format: {fmt}", file=sys.stderr)
            return 2

    if outputs_explicit and \
            not any(getattr(s, "log_level", 0) > 0 for s in rx.sinks):
        print('Use "-F log" if you want any messages, warnings, and '
              'errors in the console.', file=sys.stderr)
    # change the log handler after outputs are set up: messages fan out
    # through every sink whose log_level admits them (ref
    # r_redirect_logging, src/rtl_433.c:1508)
    rx.redirect_logging()

    n_events = 0
    for code in test_codes:
        n_events += len(rx.decode_test_string(code))
    for path in in_files:
        try:
            evs = rx.decode_file(path)
        except FileNotFoundError as e:
            print(f"error: cannot open input file: {e.filename}",
                  file=sys.stderr)
            return 2
        n_events += len(evs)

    if source is not None:
        if not source.startswith("rtl_tcp"):
            print(f"unsupported device: {source} (rtl_tcp:host:port only)",
                  file=sys.stderr)
            return 2
        max_blocks = None
        if max_samples is not None:
            from .api import DEFAULT_BUF_SAMPLES
            max_blocks = max(1, max_samples // DEFAULT_BUF_SAMPLES)
        try:
            rx.run_live(source, max_blocks=max_blocks, run_mode=run_mode,
                        frequencies=frequencies or None,
                        hop_times=hop_times or None,
                        after_events=after_events, duration=duration)
        except (ConnectionError, OSError) as e:
            print(f"error: cannot open SDR: {e}", file=sys.stderr)
            return 2
        finally:
            if report_stats:
                ev = rx.stats_report(report_stats)
                for sink in rx.sinks:
                    sink(ev)
            for close in closers:
                close()
        return getattr(rx, "exit_code", 0)

    if report_stats:
        # final report through every sink (ref src/rtl_433.c:1926-1928)
        ev = rx.stats_report(report_stats)
        for sink in rx.sinks:
            sink(ev)

    for close in closers:
        close()
    for d in rx.dumpers:
        d.close()
    if sr_filename:
        from .io.sigrok import write_sigrok
        write_sigrok(sr_filename, rate, 3, 4)
    if test_codes and n_events == 0:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
