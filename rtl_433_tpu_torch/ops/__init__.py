"""Hand-written CUDA kernels of the hot path, each wrapper beside its plain
version: ``frontend`` (csrc/frontend.cu), ``detector_scan``
(csrc/detector.cu), ``compact`` (csrc/compact.cu, package compaction) and
``slice`` (csrc/slice.cu, the nine slicer scans of device slicing; its
dedup and record gather, csrc/dispatch.cu, are wrapped in
decoders/device_dispatch.py), ``decode_bank`` (the declarative decode
bank: ``run`` on NumPy for the host dispatch, ``run_torch`` launching
csrc/decl_bank.cu), ``mic`` (the batched MIC digests, csrc/mic.cu) and
``timeshard`` (csrc/timeshard.cu). Host-side: the build of the host slicer
library (``_native``, csrc/slicers.cpp)."""
