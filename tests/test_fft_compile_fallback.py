"""Compile-failure resilience of auto's monolithic-FFT rung.

Auto's "xla" rung delegates to the platform's monolithic FFT — the one
rung whose lowering the framework does not control. A backend that
refuses such a bare FFT jit (UNIMPLEMENTED) would kill a running session
at e.g. -b 509 (N=1018=2·509). The PsdStep falls back to the matmul DFT (plain dot-generals, same u8
convention) and warns instead (ops/spectral.py _fallback_to_matmul).
"""
import numpy as np
import pytest

from rtl_power_fftw_tpu.ops.spectral import PsdStep


def _golden(raw, F, N):
    z = (raw[:F, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:F, 1::2].astype(np.float64) - 127.0)
    return (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)


def _fail_once(exc):
    state = {"fired": False}

    def step(*args):
        if not state["fired"]:
            state["fired"] = True
            raise exc
        raise AssertionError("failing stub called twice")

    return step


def test_unimplemented_fft_falls_back_to_matmul(capsys):
    N = 1018  # 2·509: degenerate split → auto lands on the xla rung
    step = PsdStep(N, 8, backend="auto")
    assert step.path == "xla"
    # Simulate the backend refusing to lower the FFT at first dispatch.
    step._step = _fail_once(RuntimeError(
        "UNIMPLEMENTED: FFT shape not supported by this emitter"))
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, size=(step.F, 2 * N), dtype=np.uint8)
    got = np.asarray(step(raw, 8), dtype=np.float64)
    want = _golden(raw, 8, N)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert step.path == "matmul"
    assert step.backend == "auto"  # the user's request stays introspectable
    assert "falls back to the matmul DFT" in capsys.readouterr().err
    # Subsequent dispatches use the rebuilt step directly.
    got2 = np.asarray(step(raw, 8), dtype=np.float64)
    np.testing.assert_allclose(got2, want, rtol=1e-5)


def test_other_errors_propagate():
    N = 1018
    step = PsdStep(N, 8, backend="auto")
    step._step = _fail_once(ValueError("boom"))
    raw = np.zeros((step.F, 2 * N), dtype=np.uint8)
    with pytest.raises(ValueError, match="boom"):
        step(raw, 8)
    assert step.path == "xla"  # no silent rebuild


def test_no_fallback_on_composite_paths():
    # A measured rung (hybrid/fourstep/...) must never be silently
    # swapped for matmul, even on an UNIMPLEMENTED-class message.
    step = PsdStep(2048, 8, backend="auto")
    assert step.path != "xla"
    step._step = _fail_once(RuntimeError("UNIMPLEMENTED: nope"))
    raw = np.zeros((step.F, 2048), dtype=np.uint16)
    with pytest.raises(RuntimeError, match="UNIMPLEMENTED"):
        step(raw, 8)


@pytest.mark.parametrize("windowed", [False, True])
def test_sharded_step_falls_back_too(windowed):
    import jax
    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.parallel import ShardedPsdStep, make_mesh

    N = 1018
    w = make_window("hann", N) if windowed else None
    mesh = make_mesh(min(8, len(jax.devices())))
    step = ShardedPsdStep(mesh, N, 8, streams=8, window=w, backend="auto")
    assert step.path == "xla"
    # _fail_once asserts the dead step is never dispatched twice (the
    # retry must go through the REBUILT step, not the broken one).
    step._step = _fail_once(RuntimeError("UNIMPLEMENTED: FFT emitter refused"))
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(8, step.F, 2 * N), dtype=np.uint8)
    nv = np.full((8,), 8, dtype=np.int32)
    per_stream, combined = step(raw, nv)
    assert step.path == "matmul"
    assert step.backend == "auto"
    z0 = (raw[0, :8, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[0, :8, 1::2].astype(np.float64) - 127.0)
    if w is not None:
        z0 = z0 * w.astype(np.float64)  # window survives the re-init
    want0 = (np.abs(np.fft.fft(z0, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(np.asarray(per_stream)[0], want0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(per_stream).sum(0),
                               np.asarray(combined), rtol=1e-5)


def test_pfb_session_step_falls_back(capsys):
    """The PFB estimator's "xla" mode has the same fallback; filter
    history survives the rebuild."""
    from rtl_power_fftw_tpu.models.pfb import PfbSessionStep
    from test_pfb_session import _direct_pfb_pwr

    N, P, F = 64, 3, 8
    step = PfbSessionStep(N, F, taps=P)
    assert step._mode == "xla"
    step._step = _fail_once(RuntimeError("UNIMPLEMENTED: FFT refused"))
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    got = np.asarray(step(raw, F), dtype=np.float64)
    want = _direct_pfb_pwr(raw, N, P)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert step._mode == "matmul" and step.path == "pfb"
    assert "PFB step falls back" in capsys.readouterr().err
    # History carried into the next (rebuilt) dispatch as usual.
    raw2 = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    got2 = np.asarray(step(raw2, F), dtype=np.float64)
    want2 = _direct_pfb_pwr(np.vstack([raw, raw2]), N, P) - want
    np.testing.assert_allclose(got2, want2, rtol=1e-4)


def test_sharded_pfb_step_falls_back(capsys):
    import jax
    from rtl_power_fftw_tpu.models.pfb import ShardedPfbStep
    from test_pfb_session import _direct_pfb_pwr

    N, P, F, S = 64, 3, 8, 8
    mesh_size = min(8, len(jax.devices()))
    from rtl_power_fftw_tpu.parallel import make_mesh
    step = ShardedPfbStep(make_mesh(mesh_size), N, F, streams=S, taps=P)
    assert step._mode == "xla"
    step._step = _fail_once(RuntimeError("UNIMPLEMENTED: FFT refused"))
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(S, F, 2 * N), dtype=np.uint8)
    nv = np.full((S,), F, dtype=np.int32)
    per_stream, combined = step(raw, nv)
    assert step._mode == "matmul"
    assert "sharded PFB step falls back" in capsys.readouterr().err
    want0 = _direct_pfb_pwr(raw[0], N, P)
    np.testing.assert_allclose(np.asarray(per_stream)[0], want0, rtol=1e-5)


def test_sk_explicit_backend_honored_windowed():
    """Round-4 advisor finding: an explicit --fft-backend fourstep on a
    WINDOWED SK session must stay the plain four-step (and say so in
    ``path``); auto picks the platform FFT."""
    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.models.kurtosis import SkSessionStep, _sk_mode

    N, F = 1024, 8
    w = make_window("hann", N)
    step = SkSessionStep(N, F, window=w, backend="fourstep")
    assert step.path == "fourstep"
    # Explicit compensated request is honored too (parity with PsdStep).
    step4m = SkSessionStep(N, F, window=w, backend="fourstep4m")
    assert step4m.path == "fourstep4m"
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)) * w
    want1 = (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)
    want2 = ((np.abs(np.fft.fft(z, axis=1)) ** 2) ** 2).sum(0)
    for st in (step, step4m):
        s1, s2 = st(raw.view(np.uint16), F)
        np.testing.assert_allclose(np.asarray(s1, np.float64), want1,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(s2, np.float64), want2,
                                   rtol=1e-4)
    # Auto takes the platform FFT, windowed or not.
    assert _sk_mode(N, True, "auto") == "xla"
    assert _sk_mode(512, True, "auto") == "xla"
    assert _sk_mode(N, False, "fourstep") == "fourstep"
    # Explicit split-pass request honored verbatim too.
    assert _sk_mode(N, True, "fourstep4x") == "fourstep4x"


def test_multitaper_steps_fall_back(capsys):
    import jax
    from rtl_power_fftw_tpu.models.multitaper import (
        MultitaperSessionStep, ShardedMultitaperStep)
    from rtl_power_fftw_tpu.parallel import make_mesh
    from test_multitaper_session import _direct_mt_pwr

    N, K, F, S = 64, 3, 8, 8
    step = MultitaperSessionStep(N, F, K=K)
    assert step._mode == "xla"
    step._step = _fail_once(RuntimeError("UNIMPLEMENTED: FFT refused"))
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    got = np.asarray(step(raw, F), dtype=np.float64)
    np.testing.assert_allclose(got, _direct_mt_pwr(raw, N, K), rtol=1e-5)
    assert step._mode == "matmul"

    sstep = ShardedMultitaperStep(make_mesh(min(8, len(jax.devices()))),
                                  N, F, streams=S, K=K)
    assert sstep._mode == "xla"
    sstep._step = _fail_once(RuntimeError("UNIMPLEMENTED: FFT refused"))
    sraw = rng.integers(0, 256, size=(S, F, 2 * N), dtype=np.uint8)
    ps, comb = sstep(sraw, np.full((S,), F, np.int32))
    assert sstep._mode == "matmul"
    np.testing.assert_allclose(np.asarray(ps)[0],
                               _direct_mt_pwr(sraw[0], N, K), rtol=1e-5)
    errtext = capsys.readouterr().err
    assert "multitaper step falls back" in errtext
