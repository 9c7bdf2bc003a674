from .data import PulseData
from . import slicers
