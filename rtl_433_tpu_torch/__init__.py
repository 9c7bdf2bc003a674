"""rtl_433_tpu_torch -- the ISM-band receiver on PyTorch and CUDA.

The port of ``rtl_433_tpu`` (JAX, TPU) to an NVIDIA H100. The per-sample
hot path runs as hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``; the host layers (slicers,
decoders, outputs) are plain Python.

Layer map:

- ``io``       -- file names and cu8 sample loading.
- ``dsp``      -- baseband ops and the block engine: front end, detector
                  scan and the record-log drain over ``[channels, block]``.
- ``ops``      -- the CUDA kernels' wrappers, each beside its plain version.
- ``pulse``    -- pulse-train data model and slicers (pulse widths -> bits).
- ``bits``     -- 2-D bit buffers and bit/CRC/LFSR utilities.
- ``decoders`` -- protocol registry (the ``-R <n>`` contract) and decoders.
- ``output``   -- events and output sinks.
"""

__version__ = "0.1.0"
