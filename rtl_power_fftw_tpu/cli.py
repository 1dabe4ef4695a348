"""Command-line entry point.

The ``main`` equivalent (rtl_power_fftw.cxx:50-233): parse → aux data →
open device → run session → map exceptions to exit codes.  Run as
``python -m rtl_power_fftw_tpu [options]`` or via the ``rtl_power_fftw_tpu``
console script.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .auxdata import AuxData
from .compile_cache import configure_compile_cache
from .config import parse_args
from .exceptions import ReturnValue, RPFexception
from .session import run_session
from .sources.registry import open_device


def _jax_runtime_errors():
    """The device-runtime exception class(es), resolved lazily so the CLI
    never imports jax before the session needs it."""
    try:
        from jax.errors import JaxRuntimeError
        return (JaxRuntimeError,)
    except ImportError:  # pragma: no cover - ancient jax
        return ()


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    configure_compile_cache()
    final_retval = ReturnValue.Success
    source = None
    try:
        params = parse_args(argv)
        aux = AuxData(params)
        source = open_device(params)
        import contextlib
        if params.profile_dir:
            # Tracing hook (the reference's only perf instrument is the
            # queue histogram; this adds full device/host timelines).
            import jax
            profile_cm = jax.profiler.trace(params.profile_dir)
        else:
            profile_cm = contextlib.nullcontext()
        with profile_cm:
            final_retval = run_session(params, source, aux)
    except RPFexception as exception:
        print(str(exception), file=sys.stderr)
        final_retval = exception.return_value
    except _jax_runtime_errors() as exception:
        # A device-side runtime failure (lost device, device OOM)
        # is this framework's analogue of a librtlsdr hardware failure:
        # the reference exits 7 there (exceptions.h:25-34, device.cxx).
        print(f"Device runtime error: {exception}", file=sys.stderr)
        final_retval = ReturnValue.HardwareError
    finally:
        if source is not None:
            source.close()
    return int(final_retval)


if __name__ == "__main__":
    sys.exit(main())
