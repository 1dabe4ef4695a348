"""--multitaper: the Thomson estimator as a first-class session path."""
import io

import numpy as np
import pytest

from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.exceptions import RPFexception
from rtl_power_fftw_tpu.models.multitaper import (MultitaperSessionStep,
                                                  ShardedMultitaperStep,
                                                  _mt_partial_step,
                                                  _session_tapers)
from rtl_power_fftw_tpu.parallel import make_mesh


def _direct_mt_pwr(raw_frames, N, K, NW=4.0):
    """Float64 session-semantics multitaper: per frame, mean over the K
    DPSS eigenspectra (session taper convention: unit energy × √N)."""
    t = _session_tapers(N, NW, K).astype(np.float64)
    z = ((raw_frames[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw_frames[:, 1::2].astype(np.float64) - 127.0))
    pwr = np.zeros(N)
    for f in range(len(z)):
        pwr += np.mean(
            [np.abs(np.fft.fft(z[f] * t[k])) ** 2 for k in range(K)], axis=0)
    return pwr


def test_multitaper_session_step_matches_direct_float64():
    N, K, F = 64, 4, 8
    step = MultitaperSessionStep(N, F, K=K)
    assert step.path == "multitaper" and step.takes_u16
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(2 * F + 3, 2 * N), dtype=np.uint8)
    got = np.zeros(N)
    for lo, hi in ((0, F), (F, 2 * F), (2 * F, 2 * F + 3)):
        batch = frames[lo:hi]
        nv = len(batch)
        padded = np.zeros((F, 2 * N), np.uint8)
        padded[:nv] = batch
        got += np.asarray(step(padded, nv), np.float64)
    want = _direct_mt_pwr(frames, N, K)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_multitaper_fourstep_mode_matches_direct():
    """The matmul transform ("fourstep" mode — all-matmul four-step on
    the tapered batch) is numerically interchangeable with the XLA mode,
    pinned here on CPU where both lower."""
    import jax.numpy as jnp
    N, K, F, chunk = 64, 3, 8, 8
    step = _mt_partial_step(N, F, K, chunk, "fourstep")
    tapers = jnp.asarray(_session_tapers(N, 4.0, K))
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    got = np.asarray(step(raw.view(np.uint16), jnp.int32(F), tapers),
                     np.float64)
    want = _direct_mt_pwr(raw, N, K)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_multitaper_cli_validation():
    err = io.StringIO()
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--multitaper", "33"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "-b", "16", "--multitaper", "17"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--multitaper", "4",
                    "--time-bandwidth", "0.5"])
    for bad in (["--welch-overlap", "50"], ["--pfb-taps", "4"],
                ["--window-function", "hann"], ["-w", "win.txt"],
                ["--shard-transform"]):
        argv = ["-f", "100M", "-n", "8", "--multitaper", "4"] + bad
        if "--shard-transform" in bad:
            argv += ["-b", "1024"]
        with pytest.raises(RPFexception):
            parse_args(argv)
    # Concentration warning for K > 2NW-1; backend/precision ignored note.
    p = parse_args(["-f", "100M", "--multitaper", "8",
                    "--fft-backend", "hybrid"], stderr=err)
    assert p.multitaper == 8
    text = err.getvalue()
    assert "well concentrated" in text
    assert "--fft-backend" in text and "ignored" in text
    # --time-bandwidth without --multitaper warns.
    err2 = io.StringIO()
    parse_args(["-f", "100M", "--time-bandwidth", "3"], stderr=err2)
    assert "no effect" in err2.getvalue()


def test_multitaper_session_e2e_tone_peak():
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    src = SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0, seed=1)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "32", "-b", "128", "--multitaper", "4",
         "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"], src)
    assert int(rv) == 0
    line = [l for l in err.split("\n") if l.startswith("Transform path:")]
    assert line and "multitaper" in line[0] and "backend" not in line[0]
    vals = np.array([float(l.split()[1]) for l in out.split("\n")
                     if l and not l.startswith("#")])
    freqs = np.array([float(l.split()[0]) for l in out.split("\n")
                      if l and not l.startswith("#")])
    assert abs(freqs[vals.argmax()] - 100_200_000) < 2_048_000 / 128


def test_sharded_multitaper_matches_per_stream_session_steps():
    S, N, K, F = 8, 64, 3, 8
    mesh = make_mesh(8)
    step = ShardedMultitaperStep(mesh, N, F, streams=S, K=K)
    assert step.path == "multitaper" and step.takes_u16
    single = MultitaperSessionStep(N, F, K=K)
    rng = np.random.default_rng(7)
    nvals = np.array([F, 3, 0, 5, F, F, 1, 7], np.int32)
    raw = np.zeros((S, F, 2 * N), np.uint8)
    for s in range(S):
        raw[s, :nvals[s]] = rng.integers(
            0, 256, (nvals[s], 2 * N), dtype=np.uint8)
    ps, comb = step(raw, nvals)
    want = np.stack([np.asarray(single(raw[s], int(nvals[s])), np.float64)
                     for s in range(S)])
    np.testing.assert_allclose(np.asarray(ps, np.float64), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(comb, np.float64), want.sum(0),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        ShardedMultitaperStep(mesh, N, F, streams=6, K=K)


def test_multistream_multitaper_session_e2e():
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    src = SyntheticSource(tones=[(100_100_000, 30.0)], noise=5.0, seed=0)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "16", "-b", "64", "--streams", "8",
         "--multitaper", "4",
         "--source", "synthetic:tone=100.1M/30,noise=5,seed=0"], src)
    assert int(rv) == 0
    assert "Parallel streams: 8 (mesh size 8)" in err
    assert "Actual number of averaged spectra: 128" in err  # 8 x 16
    line = [l for l in err.split("\n") if l.startswith("Transform path:")]
    assert line and "multitaper" in line[0]
    vals = np.array([float(l.split()[1]) for l in out.split("\n")
                     if l and not l.startswith("#")])
    freqs = np.array([float(l.split()[0]) for l in out.split("\n")
                      if l and not l.startswith("#")])
    assert abs(freqs[vals.argmax()] - 100_100_000) < 2_048_000 / 64


def test_multitaper_nw_bound_is_typed_error():
    """NW >= N/2 (scipy's DPSS domain) must exit InvalidArgument, not
    crash with a raw ValueError deep in the session."""
    for argv in (["-f", "100M", "-b", "16", "--multitaper", "2",
                  "--time-bandwidth", "10"],
                 ["-f", "100M", "-b", "4", "--multitaper", "2"]):
        with pytest.raises(RPFexception):
            parse_args(argv, stderr=io.StringIO())


def test_multitaper_precision_high_fast_mode(monkeypatch):
    """On the GPU band table the multitaper step takes the platform FFT
    whatever --precision says (the relaxed "fourstep-fast" tier applies
    only to the matmul "fourstep" mode, which auto no longer picks).
    Numerics of both pinned vs f64."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    N, K, F = 64, 3, 8
    fast = MultitaperSessionStep(N, F, K=K, precision="high")
    assert fast._mode == "xla"
    slow = MultitaperSessionStep(N, F, K=K)
    assert slow._mode == "xla"
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    want = _direct_mt_pwr(raw, N, K)
    np.testing.assert_allclose(
        np.asarray(fast(raw, F), np.float64), want, rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(slow(raw, F), np.float64), want, rtol=2e-5)
