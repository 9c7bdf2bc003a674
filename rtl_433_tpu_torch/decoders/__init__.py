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
from . import temperature  # noqa: F401
from . import remotes  # noqa: F401
from . import acurite  # noqa: F401
from . import fineoffset  # noqa: F401
from . import lacrosse  # noqa: F401
from . import oregon  # noqa: F401
from . import bresser  # noqa: F401
from . import tpms  # noqa: F401
from . import misc_a  # noqa: F401
from . import misc_b  # noqa: F401
from . import misc_c  # noqa: F401
from . import security  # noqa: F401
from . import garage  # noqa: F401
from . import weather  # noqa: F401
from . import energy  # noqa: F401
from . import fineoffset2  # noqa: F401
from . import tpms2  # noqa: F401
from . import tpms3  # noqa: F401
from . import remotes2  # noqa: F401
from . import home2  # noqa: F401
from . import weather3  # noqa: F401
from . import home3  # noqa: F401
from . import bbq  # noqa: F401
from . import fineoffset3  # noqa: F401
from . import home4  # noqa: F401
from . import utility  # noqa: F401
from . import remotes3  # noqa: F401
from . import remotes4  # noqa: F401
from . import tpms4  # noqa: F401
from . import car_remotes  # noqa: F401
from . import m_bus  # noqa: F401
from . import misc_d  # noqa: F401
from . import govee2  # noqa: F401
from . import lacrosse2  # noqa: F401
from . import weather4  # noqa: F401
from . import misc_e  # noqa: F401
from . import misc_f  # noqa: F401
from . import misc_g  # noqa: F401
from . import keeloq  # noqa: F401
from . import misc_h  # noqa: F401
from . import misc_i  # noqa: F401
from . import misc_j  # noqa: F401
from . import misc_k  # noqa: F401
from . import meters  # noqa: F401
from . import misc_l  # noqa: F401
from . import misc_m  # noqa: F401
from . import misc_n  # noqa: F401
from . import misc_o  # noqa: F401
from . import misc_p  # noqa: F401
from . import misc_q  # noqa: F401
from . import misc_r  # noqa: F401
from . import misc_s  # noqa: F401
