"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<library>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``_build/lib<name>-<hash>.so``) at first use, and
bound with ``ctypes``. The hash covers the sources and the flags, so an
edited kernel rebuilds and an unchanged one loads from ``_build/``.
:func:`build` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else. The nine slicer families
share one launcher (``csrc/slice.cu``) and count one name each
(``slice_<family>``); ``csrc/dispatch.cu`` holds two launchers
(``content_dup``, ``gather_records``), and so does ``csrc/timeshard.cu``
(``timeshard_chain``, ``timeshard_gather``). ``csrc/decl_bank.cu`` is the
declarative decode bank (``decl_bank``); the twelve MIC digests share one
launcher (``csrc/mic.cu``) and count one name each (``mic_<digest>``).

:func:`launch_device` makes the device of a launch's tensors current
around every launch: a C launcher runs on the CUDA runtime's current
device, which need not be the tensors' where a process drives several
GPUs. :func:`check_lane_t0` and :func:`origin_groups` serve the wrappers
whose kernels take a per-lane region origin (the front end and the
detector).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> source file in csrc/ (headers in csrc/ are hashed too)
SOURCES = {"frontend": "frontend.cu", "detector_scan": "detector.cu",
           "compact": "compact.cu", "slice": "slice.cu",
           "dispatch": "dispatch.cu", "timeshard": "timeshard.cu",
           "decl_bank": "decl_bank.cu", "mic": "mic.cu"}

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name -> (its library, its C symbol, its argument types); each
# returns the cudaGetLastError() code after the launch
LAUNCHERS = {
    # iq, C, N, n_valid, lane_t0, use_mag_est, enable_fm, am_a1, am_b,
    # alp1, blp, state, am, fm, env_sum, stream
    "frontend": ("frontend", "rtl433_frontend",
                 [_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                  _P, _P]),
    # am, fm, fm_i32, N, C, regs, gen0, log_key, log_p, log_g, eop_log,
    # quiet, n_valid, t0, lane_t0, chunk, R, E, spm, fixed, ratio, maxp,
    # minmax, stream
    "detector_scan": ("detector_scan", "rtl433_detector_scan",
                      [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # out_n, out_p, out_g, out_meta, C, S, P, F, cap, W, out (rows, count,
    # scratch), stream
    "compact": ("compact", "rtl433_compact",
                [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    # family, pulse, gap, n_pulses, B, N, bounds, S, E, R, BY, lanes,
    # group (threads per lane), SB, smem, bytes, bits_per_row, syncs,
    # num_rows, n_events, ovf, stream
    "slice": ("slice", "rtl433_slice",
              [_I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
               _P, _P, _P, _P, _P, _P, _P]),
    # bytes, num_rows, bits_per_row, syncs, BJ, E, R, W, dup, stream
    "content_dup": ("dispatch", "rtl433_content_dup",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    # meta (family table, then records), F, P, out, stream
    "gather_records": ("dispatch", "rtl433_gather_records",
                       [_P, _I, _I, _P, _P]),
    # start, fin, rowinfo, NROW, D, C, G, smem, ratio, low, high,
    # ook_state, min_high, gen, sel, delta, out, by_key, bad, stream
    "timeshard_chain": ("timeshard", "rtl433_timeshard_chain",
                        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P, _P, _P]),
    # key3, p3, g3, eop3, sel, delta, bad, skip_if_bad, pdl, D, C, R, G,
    # GE, key, p, g, eop, stream
    "timeshard_gather": ("timeshard", "rtl433_timeshard_gather",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _P, _P, _P, _P, _P]),
    # bits, n_bits, n_store, sid, B, IN, spec, K, S, entries, chunk_dir,
    # chunk_start, FB, C, R, PW, code, raws, stream
    "decl_bank": ("decl_bank", "rtl433_decl_bank",
                  [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I,
                   _I, _I, _P, _P, _P]),
    # algo, is_i32, msg, rows, stride, nbytes, init, mask, table, chunk,
    # out, stream
    "mic": ("mic", "rtl433_mic",
            [_I, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P]),
}

# the slicer families of csrc/slice.cu, one launch count each
SLICE_FAMILIES = ("ppm", "pwm", "pcm", "mc", "dmc", "piwm_dc", "nrzs",
                  "rzi", "osv1")
# the digests of csrc/mic.cu (its enum Algo), one launch count each
MIC_ALGOS = ("crc8", "crc8le", "crc16", "crc16lsb", "lfsr_digest8",
             "lfsr_digest8_reverse", "lfsr_digest8_reflect", "lfsr_digest16",
             "xor_bytes", "add_bytes", "add_nibbles", "parity_bytes")
KERNELS = ("frontend", "detector_scan", "compact",
           *(f"slice_{f}" for f in SLICE_FAMILIES), "content_dup",
           "gather_records", "timeshard_chain", "timeshard_gather",
           "decl_bank", *(f"mic_{a}" for a in MIC_ALGOS))
# each kernel's launches, and the time-shard gather's launches that copied
# (the step reads the chain's verdict after the gather's launch, and a
# launch behind a failed chain writes nothing)
LAUNCHES = {name: 0 for name in KERNELS} | {"timeshard_gather_copied": 0}

_libs: dict = {}   # library name -> the loaded library
_fns: dict = {}    # launcher name -> its C function


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == SOURCES[name] or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: seconds}`` for the builds it ran; raises with the compiler's
    output if any build fails. ``nvcc``'s ``-Xptxas -v`` report is kept in
    ``_build/<name>.log``."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def launcher(name: str):
    """The C launcher ``name`` with its argument types declared; its
    library is built on first use."""
    if name not in _fns:
        lib_name, symbol, argtypes = LAUNCHERS[name]
        if lib_name not in _libs:
            build([lib_name])
            _libs[lib_name] = ctypes.CDLL(_lib_path(lib_name))
        fn = getattr(_libs[lib_name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def check(err: int, name: str):
    """Raise on a non-zero ``cudaGetLastError`` from a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def resolve_device(device):
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


# what launch_device returns where the tensors' device is current already
_CURRENT = contextlib.nullcontext()
# the current CUDA device's index (bound at first use: a CPU build of torch
# has no such function)
_current_device = None


def launch_device(t):
    """The context of a launch on ``t``'s CUDA device: that device made
    current (the launcher runs on the runtime's current device, and
    :func:`stream_of` gives it that device's stream); where it is current
    already, it switches nothing. Each wrapper has checked that its other
    inputs lie on ``t``'s device (it makes its outputs there). Raises
    ``ValueError`` for a CPU tensor: a launch never copies."""
    global _current_device
    dev = t.get_device()
    if dev < 0:
        raise ValueError("a kernel launch takes CUDA tensors, got CPU ones")
    if _current_device is None:
        import torch
        _current_device = torch._C._cuda_getDevice
    if _current_device() == dev:
        return _CURRENT
    import torch
    return torch.cuda.device(dev)


def stream_of(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device (read
    without making a Stream object: a few microseconds less per launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_lane_t0(lane_t0, C, device, name):
    """Check a per-lane origin vector for a kernel: None, or int32 [C] on
    ``device`` (returned contiguous)."""
    import torch
    if lane_t0 is None:
        return None
    if lane_t0.shape != (C,) or lane_t0.dtype != torch.int32 \
            or lane_t0.device != device:
        raise ValueError(f"{name}: lane_t0 must be int32 [C] on the "
                         f"input's device")
    return lane_t0.contiguous()


def origin_groups(lane_t0):
    """The lanes of each distinct origin: [(t0, index tensor)] in the order
    of t0, for the plain versions of per-lane-origin calls."""
    import torch
    t0s = lane_t0.cpu().tolist()
    return [(t0, torch.tensor([i for i, v in enumerate(t0s) if v == t0],
                              device=lane_t0.device))
            for t0 in sorted(set(t0s))]
