"""Hand-written CUDA kernels of the hot path, each wrapper beside its plain
version: ``frontend`` (csrc/frontend.cu) and ``detector_scan``
(csrc/detector.cu)."""
