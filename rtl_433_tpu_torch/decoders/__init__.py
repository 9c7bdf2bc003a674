from .base import (
    RDevice,
    Registry,
    decoder,
    DECODE_ABORT_LENGTH,
    DECODE_ABORT_EARLY,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
)
from . import protocols  # noqa: F401  (registers decode functions)
