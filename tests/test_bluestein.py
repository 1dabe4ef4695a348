"""The chirp-Z (Bluestein) rung: arbitrary-N transforms owned by the
framework.

The reference plans ANY N through FFTW (datastore.cxx:30-33). The
bluestein rung is the framework's own arbitrary-N transform: one pow-2
circular convolution riding batched short FFTs (ops/dft.py
bluestein_psd_partial), reachable as an explicit backend.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rtl_power_fftw_tpu.ops.dft import (_bluestein_constants,
                                        bluestein_psd_partial, next_pow2)
from rtl_power_fftw_tpu.ops.spectral import (PsdStep,
                                             select_transform_rung)


def _realization(N, F, seed, tone=True):
    rng = np.random.default_rng(seed)
    re = rng.integers(-127, 129, (F, N)).astype(np.float32)
    im = rng.integers(-127, 129, (F, N)).astype(np.float32)
    if tone:
        t = np.arange(N, dtype=np.float64)
        re += (100 * np.cos(2 * np.pi * 0.173 * t)).astype(np.float32)[None]
        im += (100 * np.sin(2 * np.pi * 0.173 * t)).astype(np.float32)[None]
    return re, im


def _want(re, im, fmask):
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    return ((X.real ** 2 + X.imag ** 2)
            * fmask[:, None].astype(np.float64)).sum(0)


def test_next_pow2():
    assert next_pow2(1) == 1
    assert next_pow2(2) == 2
    assert next_pow2(3) == 4
    assert next_pow2(4095) == 4096
    assert next_pow2(4097) == 8192


def test_constants_layout():
    """Bp must hold FFT_M(v) in the four-step (k1, k2) layout."""
    N = 10
    M, M1, M2, a, Bp, tw = _bluestein_constants(N)
    assert M >= 2 * N - 1 and M & (M - 1) == 0 and M1 * M2 == M
    n = np.arange(N)
    af = np.exp(-1j * np.pi * (n * n % (2 * N)) / N)
    np.testing.assert_allclose(a, af.astype(np.complex64), rtol=1e-6)
    v = np.zeros(M, np.complex128)
    v[:N] = np.conj(af)
    v[M - N + 1:] = np.conj(af[1:][::-1])
    B = np.fft.fft(v)
    for k1 in range(0, M1, 7):
        for k2 in range(0, M2, 5):
            np.testing.assert_allclose(Bp[k1, k2], B[k1 + M1 * k2].astype(
                np.complex64), rtol=1e-6)


@pytest.mark.parametrize("N", [6, 500, 998, 1009, 2038, 9998])
def test_partial_parity_vs_f64(N):
    """Chirp-Z partial vs the float64 golden under a 35 dB tone —
    FFTW-class accuracy on any N, masked frames honored."""
    F = 8
    re, im = _realization(N, F, 11)
    fmask = np.ones(F, np.float32)
    fmask[-2:] = 0
    got = np.asarray(bluestein_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask)), np.float64)
    want = _want(re, im, fmask)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() < 1e-5, (N, err.max())


def test_rung_selection():
    """Auto keeps the platform FFT for awkward N (no factor >= 8) — on
    CPU it IS the FFTW class, on the GPU it is cuFFT; explicit requests
    are honored for any N."""
    for N in (998, 9998, 99998, 2 * 100003):
        for windowed in (False, True):
            assert select_transform_rung(N, windowed, "auto")[0] == "xla", N
    # Composite very-large N stays on the two-level FFT four-step.
    assert select_transform_rung(1 << 20, False, "auto")[0] == "fft4"
    assert select_transform_rung(500, False, "bluestein")[0] == "bluestein"


def test_psdstep_explicit_bluestein():
    step = PsdStep(2038, 8, backend="bluestein")
    assert step.path == "bluestein"
    assert step.takes_u16
    re, im = _realization(2038, step.F, 3)
    raw = np.empty((step.F, 2 * 2038), np.uint8)
    raw[:, 0::2] = np.clip(re + 127, 0, 255).astype(np.uint8)
    raw[:, 1::2] = np.clip(im + 127, 0, 255).astype(np.uint8)
    # parity through the step's own dequant convention
    re2 = (raw[:, 0::2].astype(np.float32) - 127)
    im2 = (raw[:, 1::2].astype(np.float32) - 127)
    got = np.asarray(step(raw, step.F), np.float64)
    want = _want(re2, im2, np.ones(step.F, np.float32))
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() < 1e-5


def test_psdstep_windowed_bluestein():
    from rtl_power_fftw_tpu.auxdata import make_window
    N = 998
    w = make_window("hann", N)
    step = PsdStep(N, 8, window=w, backend="bluestein")
    raw = np.random.default_rng(5).integers(
        0, 256, (step.F, 2 * N)).astype(np.uint8)
    re = (raw[:, 0::2].astype(np.float64) - 127) * w
    im = (raw[:, 1::2].astype(np.float64) - 127) * w
    got = np.asarray(step(raw, step.F), np.float64)
    want = _want(re.astype(np.float32), im.astype(np.float32),
                 np.ones(step.F, np.float32))
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() < 1e-5


def test_sharded_bluestein_parity():
    from rtl_power_fftw_tpu.parallel.sharded import ShardedPsdStep
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs an 8-device mesh (CPU harness)")
    mesh = Mesh(np.array(devs[:8]), ("stream",))
    N, F, S = 998, 8, 8
    sh = ShardedPsdStep(mesh, N, F, streams=S, backend="bluestein")
    assert sh.path == "bluestein"
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, (S, sh.F, 2 * N)).astype(np.uint8)
    nv = np.full(S, sh.F, np.int32)
    per_stream, combined = sh(raw, nv)
    want_total = np.zeros(N)
    for s in range(S):
        re = raw[s, :, 0::2].astype(np.float32) - 127
        im = raw[s, :, 1::2].astype(np.float32) - 127
        want = _want(re, im, np.ones(sh.F, np.float32))
        got = np.asarray(per_stream[s], np.float64)
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        assert err.max() < 1e-5, s
        want_total += want
    errc = (np.abs(np.asarray(combined, np.float64) - want_total)
            / np.maximum(np.abs(want_total), 1e-30))
    assert errc.max() < 1e-5


def test_tapered_batch_mode_rules(monkeypatch):
    """The estimator-family transform chooser (multitaper/PFB/SK) takes
    the platform FFT on the GPU band table and on CPU alike — any N,
    composite or awkward."""
    import jax
    from rtl_power_fftw_tpu.ops.spectral import tapered_batch_mode

    for backend in ("gpu", "cpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        for N in (122, 2048, 1 << 17, 99998):
            assert tapered_batch_mode(N) == "xla", (backend, N)


def test_estimator_bluestein_modes_parity():
    """The bluestein estimator modes (multitaper K-loop partial, PFB
    summed-plane partial, SK per-frame power) vs the float64 truth."""
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.models.multitaper import (_mt_core,
                                                      _session_tapers)
    from rtl_power_fftw_tpu.models.pfb import _pfb_core, pfb_prototype
    from rtl_power_fftw_tpu.ops.dft import dft_power_bluestein

    N, F, K, P = 122, 8, 3, 4
    rng = np.random.default_rng(0)
    re = rng.integers(-127, 129, (F + P - 1, N)).astype(np.float32)
    im = rng.integers(-127, 129, (F + P - 1, N)).astype(np.float32)
    fmask = np.ones(F, np.float32)

    tap = _session_tapers(N, 4.0, K)
    got = np.asarray(_mt_core(
        jnp.asarray(re[:F]), jnp.asarray(im[:F]), jnp.asarray(fmask),
        jnp.asarray(tap), N=N, F=F, K=K, chunk=8, mode="bluestein"),
        np.float64)
    z = re[:F].astype(np.float64) + 1j * im[:F].astype(np.float64)
    zt = z[:, None, :] * tap.astype(np.float64)[None]
    X = np.fft.fft(zt, axis=2)
    want = (X.real ** 2 + X.imag ** 2).mean(1).sum(0)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    h64 = pfb_prototype(N, P).astype(np.float64).reshape(P, N)
    h = jnp.asarray(h64.astype(np.float32))
    got = np.asarray(_pfb_core(
        jnp.asarray(re), jnp.asarray(im), h, F, N, P, 8,
        jnp.asarray(fmask), mode="bluestein"), np.float64)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    S = sum(z[p:p + F] * h64[p][None] for p in range(P))
    X = np.fft.fft(S, axis=1)
    want = (X.real ** 2 + X.imag ** 2).sum(0)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    got = np.asarray(dft_power_bluestein(
        jnp.asarray(re[:F]), jnp.asarray(im[:F])), np.float64)
    z = re[:F].astype(np.float64) + 1j * im[:F].astype(np.float64)
    X = np.fft.fft(z, axis=1)
    want = X.real ** 2 + X.imag ** 2
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
