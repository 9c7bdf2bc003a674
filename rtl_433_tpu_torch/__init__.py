"""rtl_433_tpu_torch -- the ISM-band receiver on PyTorch and CUDA.

The port of the JAX/TPU receiver package to an NVIDIA H100. The per-sample
hot path runs as hand-written CUDA kernels (``csrc/*.cu``), built with
``nvcc`` at first use and bound with ``ctypes``. The host layers are plain
Python, apart from the batch slicer bank of the default decode dispatch
(``csrc/slicers.cpp``) and the block ring of live input
(``csrc/ingest.cpp``), both built with the host ``c++`` at first use.

Layer map:

- ``io``       -- file names, sample loading and SigMF archives; live
                  input over rtl_tcp (client, passthrough server, ring);
                  the ``-w`` dumpers, the ``-S`` grabber, ``.sr`` sessions.
- ``dsp``      -- baseband ops and the block engine: front end, detector
                  scan and the record-log drain over ``[channels, block]``.
- ``ops``      -- the CUDA kernels' wrappers, each beside its plain version;
                  the declarative decode bank; the host libraries' build.
- ``pulse``    -- pulse-train data model and slicers (pulse widths -> bits),
                  per decoder and as one native batch.
- ``bits``     -- 2-D bit buffers and bit/CRC/LFSR utilities.
- ``decoders`` -- protocol registry (the ``-R <n>`` contract), decoders and
                  the flex decoder of ``-X``.
- ``output``   -- events, output sinks and the logging facade.
- ``confparse``, ``cli`` -- conf files (``-c``) and the command line.
"""

__version__ = "0.1.0"
