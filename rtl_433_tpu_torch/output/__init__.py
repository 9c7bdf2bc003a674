from .data_model import Event, F
from . import sinks
