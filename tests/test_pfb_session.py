"""--pfb-taps: the PFB estimator as a first-class session path."""
import io

import numpy as np
import pytest

from rtl_power_fftw_tpu import AuxData, parse_args
from rtl_power_fftw_tpu.exceptions import RPFexception
from rtl_power_fftw_tpu.models.pfb import PfbSessionStep, pfb_prototype
from rtl_power_fftw_tpu.pipeline.datastore import Datastore


def _direct_pfb_pwr(raw_frames, N, P, window="hann"):
    """Float64 session-semantics PFB: zero prehistory (u8 127), one
    output per input frame."""
    h = pfb_prototype(N, P, window).astype(np.float64).reshape(P, N)
    z = ((raw_frames[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw_frames[:, 1::2].astype(np.float64) - 127.0))
    zpad = np.vstack([np.zeros((P - 1, N), dtype=np.complex128), z])
    pwr = np.zeros(N)
    for j in range(len(z)):
        s = sum(zpad[j + p] * h[p] for p in range(P))
        pwr += np.abs(np.fft.fft(s)) ** 2
    return pwr


def test_pfb_session_step_matches_direct_float64():
    N, P, F = 128, 4, 8
    step = PfbSessionStep(N, F, taps=P)
    assert step.path == "pfb" and not step.takes_u16
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, size=(3 * F + 5, 2 * N), dtype=np.uint8)
    got = np.zeros(N)
    # Feed in uneven chunks incl. a padded partial batch, like the
    # datastore staging does.
    for lo, hi in ((0, F), (F, 2 * F), (2 * F, 3 * F + 5)):
        batch = frames[lo:hi]
        n_valid = len(batch)
        padded = np.zeros((F * ((n_valid + F - 1) // F), 2 * N), np.uint8)
        padded[:n_valid] = batch
        for s in range(0, len(padded), F):
            nv = max(0, min(F, n_valid - s))
            got += np.asarray(step(padded[s:s + F], nv), dtype=np.float64)
    want = _direct_pfb_pwr(frames, N, P)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pfb_session_reset_clears_history():
    N, P, F = 64, 3, 8
    step = PfbSessionStep(N, F, taps=P)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    first = np.asarray(step(frames, F), dtype=np.float64)
    step.reset()
    again = np.asarray(step(frames, F), dtype=np.float64)
    np.testing.assert_allclose(first, again, rtol=1e-6)
    # Without the reset, the tail differs and so must the result.
    third = np.asarray(step(frames, F), dtype=np.float64)
    assert not np.allclose(again, third, rtol=1e-6)


def test_datastore_pfb_end_to_end_and_retune_isolation():
    params = parse_args(["-f", "100M", "-n", "24", "-b", "128",
                         "--pfb-taps", "4", "--frames-per-step", "8",
                         "--source", "synthetic:noise=5,seed=9"])
    data = Datastore(params)
    assert data.transform_path == "pfb"
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, size=(24 * 2 * 128,), dtype=np.uint8)

    def run_acq():
        data.begin_acquisition()
        data.acquire_slot()
        data.push_buffer(raw)
        return data.finish_acquisition()

    r1 = run_acq()
    r2 = run_acq()  # same bytes after a "retune": history must not leak
    assert r1.repeats_done == r2.repeats_done == 24
    np.testing.assert_allclose(r1.pwr, r2.pwr, rtol=1e-6)
    want = _direct_pfb_pwr(raw.reshape(24, 2 * 128), 128, 4)
    np.testing.assert_allclose(r1.pwr, want, rtol=1e-5)


def test_pfb_cli_validation():
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "1"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "4",
                    "--welch-overlap", "50"])
    # --streams composes (sharded PFB); --shard-transform still conflicts.
    p = parse_args(["-f", "100M", "--pfb-taps", "4", "--streams", "4"])
    assert p.pfb_taps == 4 and p.streams == 4
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "-n", "1024", "--pfb-taps", "4",
                    "--streams", "4", "--shard-transform"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "4", "-w", "win.txt"])
    p = parse_args(["-f", "100M", "--pfb-taps", "4",
                    "--window-function", "blackman"])
    assert p.pfb_taps == 4 and p.window_function == "blackman"


def test_pfb_session_e2e_tone_peak(tmp_path):
    from rtl_power_fftw_tpu.session import run_session
    from rtl_power_fftw_tpu.sources.registry import make_source
    params = parse_args(["-f", "100M", "-n", "32", "-b", "256",
                         "--pfb-taps", "4",
                         "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"])
    src = make_source(params.source, params.sample_rate)
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, src, AuxData(params), stdout=out, stderr=err,
                     install_sigint=False)
    assert int(rv) == 0
    rows = [l.split() for l in out.getvalue().splitlines()
            if l.strip() and not l.startswith("#")]
    freqs = np.array([float(r[0]) for r in rows])
    vals = np.array([float(r[1]) for r in rows])
    assert len(rows) == 256
    peak_freq = freqs[np.argmax(vals)]
    assert abs(peak_freq - 100.2e6) < 2 * params.sample_rate / 256


def test_pfb_fourstep_mode_matches_direct():
    """The matmul transform for the polyphase sums ("fourstep" mode —
    all-matmul four-step on the windowed-class planes, never the
    monolithic FFT) is numerically interchangeable with the XLA mode,
    pinned here on CPU where both lower."""
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.models.pfb import _pfb_session_step

    N, P, F, chunk = 64, 3, 8, 8
    step = _pfb_session_step(N, P, F, chunk, "fourstep")
    h = pfb_prototype(N, P).reshape(P, N)
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    x = np.vstack([np.full((P - 1, 2 * N), 127, np.uint8), raw])
    got = np.asarray(step(x.view(np.uint16), jnp.int32(F), jnp.asarray(h)),
                     np.float64)
    want = _direct_pfb_pwr(raw, N, P)
    np.testing.assert_allclose(got, want, rtol=2e-5)
