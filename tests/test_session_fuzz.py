"""Numerics property fuzz: random session configurations end-to-end
against the float64 golden pipeline.

The targeted e2e tests pin individual behaviors; this sweeps the
configuration space (N even/odd-factor/power-of-two, repeats, buffer
sizes, windows, linear/dB) with the SAME byte stream fed to both the
session and the golden transcription of datastore.cxx:48-96 +
acquisition.cxx:376-399, so any backend-selection or masking slip at an
untested shape shows up as a numeric mismatch."""

import io

import numpy as np
import pytest

from rtl_power_fftw_tpu.auxdata import AuxData, make_window
from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.session import run_session
from rtl_power_fftw_tpu.sources import SyntheticSource

from golden import golden_accumulate, golden_finalize

# (N, repeats, buf_bytes, window, linear) — N values pick different auto
# backends: 64/500 four-step or XLA (odd factors), 256/1024 four-step,
# 2048 the hybrid rung on the CPU ladder.
CASES = [
    (64, 37, 16384, "", False, []),
    (500, 20, 16384, "", False, []),      # non-power-of-two (doc example)
    (256, 64, 32768, "hann", False, []),
    (1024, 11, 16384, "", True, []),      # linear output, partial batch
    (2048, 9, 49152, "blackman", False, []),
    (130, 33, 16384, "hamming", True, []),   # N = 2·5·13: degenerate split
    (122, 17, 16384, "", False, []),      # N = 2·61: XLA rung
    (320, 25, 16384, "flattop", False, []),  # N = 2^6·5: mixed-radix
    (6144, 5, 49152, "", False, []),      # 3·2^11: mid-band composite
    # Round-4 awkward-point pins (VERDICT r3 #8): the large-prime class
    # on the chirp-Z rung (N = 2·1019, via the explicit backend since
    # auto keeps the platform FFT), and a windowed very-large-N shape.
    (2038, 7, 16384, "hamming", False, ["--fft-backend", "bluestein"]),
    (1 << 19, 2, 1 << 21, "hann", False, []),
]


@pytest.mark.parametrize("N,repeats,buf,window,linear,extra", CASES)
def test_session_matches_golden(N, repeats, buf, window, linear, extra):
    rate = 2_048_000
    seed = 1000 + N
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N),
            "-r", str(rate), "-s", str(buf), "--source", "synthetic:"]
    if window:
        argv += ["--window-function", window]
    if linear:
        argv += ["-l"]
    argv += extra
    params = parse_args(argv, stderr=io.StringIO())
    src = SyntheticSource(tones=[(100_150_000, 28.0)], noise=6.0, seed=seed)
    aux = AuxData(params, stderr=io.StringIO())
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, src, aux, stdout=out, stderr=err,
                     install_sigint=False)
    assert int(rv) == 0, err.getvalue()

    # Regenerate the identical byte stream the session consumed.
    src2 = SyntheticSource(tones=[(100_150_000, 28.0)], noise=6.0, seed=seed)
    src2.set_sample_rate(rate)
    try:
        src2.set_frequency(params.cfreq)   # session's throwaway pre-tune
    except Exception:
        pass
    src2.set_frequency(100_000_000)
    stream, _ = src2.read(2 * N * repeats)
    w = make_window(window, N) if window else None
    pwr, done = golden_accumulate(stream, N, repeats, window=w)
    want = golden_finalize(pwr, done, rate, linear=linear)

    got = np.array([float(l.split()[1]) for l in out.getvalue().split("\n")
                    if l and not l.startswith("#")])
    assert got.shape == want.shape == (N,)
    if linear:
        np.testing.assert_allclose(got, want, rtol=3e-5)
    else:
        # 6-sig-fig text output of dB values.
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
