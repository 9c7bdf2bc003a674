from .bitbuffer import BitBuffer, BITBUF_COLS, BITBUF_ROWS
from . import util
