"""Hand-written CUDA kernels of the hot path, each wrapper beside its plain
version: ``frontend`` (csrc/frontend.cu), ``detector_scan``
(csrc/detector.cu) and ``compact`` (csrc/compact.cu, package compaction).
Host-side: the declarative decode bank's tensor program (``decode_bank``,
NumPy) and the build of the host slicer library (``_native``,
csrc/slicers.cpp)."""
