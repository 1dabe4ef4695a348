"""Full-session byte snapshot: pins the entire formatting + numerics
stack. Timestamps are masked (they vary); every other byte of stdout is
hashed. A change to dequantization, FFT backend selection, accumulation,
normalization, formatting, or separator layout shows up here first.

If this fails after an intentional change, verify the new output against
golden.py and update the hash with the printed value.
"""

import hashlib
import io
import re

import pytest

from rtl_power_fftw_tpu.auxdata import AuxData
from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.session import run_session
from rtl_power_fftw_tpu.sources import SyntheticSource

EXPECTED_SHA256 = "f743f03a462278b20974c3d3fe1c6ac8921a939a97d4a310ab50a33a8d83db9d"
# Hash history: e973fa8f... before the synthetic source's front-end
# band-limit (out-of-band tones used to alias into every hop; now they
# are absent from hops that couldn't physically see them).


def test_session_output_snapshot():
    import jax
    if jax.default_backend() != "cpu":
        # The snapshot freezes CPU-backend bytes; accelerator numerics
        # agree to ~1e-6 but 6-sig-fig formatting can flip last digits.
        # Numerical parity there is covered by the golden tests.
        pytest.skip("byte snapshot is CPU-backend-specific")
    src = SyntheticSource(tones=[(100_300_000, 30.0)], noise=6.0, seed=2024)
    params = parse_args(["-f", "100M:103M", "-n", "25", "-b", "500",
                         "-r", "2048000", "--source", "synthetic:"],
                        stderr=io.StringIO())
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, src, AuxData(params, stderr=io.StringIO()),
                     stdout=out, stderr=err, install_sigint=False)
    assert int(rv) == 0
    text = re.sub(r"# Acquisition (start|end): .*", r"# Acquisition \1: X",
                  out.getvalue())
    digest = hashlib.sha256(text.encode()).hexdigest()
    # Structural sanity independent of the hash:
    assert text.count("# rtl-power-fftw output") == 2  # 3 MHz span → 2 hops
    assert len([l for l in text.split("\n")
                if l and not l.startswith("#")]) == 1000
    assert digest == EXPECTED_SHA256, (
        f"session output bytes changed: sha256 {digest}\n"
        f"first lines:\n" + "\n".join(text.split("\n")[:8]))
