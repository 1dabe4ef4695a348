"""rtl_power_fftw_tpu — an accelerator spectral-estimation framework.

A ground-up JAX/XLA rebuild with the capabilities of
AD-Vega/rtl-power-fftw: 8-bit IQ streams → windowed, averaged power spectral
densities, with wideband frequency-scan stitching, continuous/time-bounded
sessions, graceful interrupts, gnuplot-ready text output and binary matrix
output with metadata sidecars.
"""

__version__ = "0.2.0"

from .exceptions import ReturnValue, RPFexception, TuneError  # noqa: F401
from .config import Params, parse_args, parse_frequency, parse_time  # noqa: F401
from .planning import Plan  # noqa: F401
from .auxdata import AuxData, make_window  # noqa: F401
