"""Mixed-precision (native-bf16 split) large-N transforms: golden parity
on the CPU harness. No auto band selects them; the platform FFT stays
the accuracy-first default."""

import numpy as np
import pytest

from rtl_power_fftw_tpu.ops.dft import (best_threestep_split,
                                        fourstep_psd_partial_mixed,
                                        threestep_psd_partial_mixed)


def _signal(N, F, tone=True, seed=0):
    rng = np.random.default_rng(seed)
    if tone:
        t = np.arange(F * N)
        sig = 56.2 * np.exp(2j * np.pi * 0.0977 * t)
        z = sig + 6.0 * (rng.standard_normal(F * N)
                         + 1j * rng.standard_normal(F * N))
        re = np.clip(np.round(z.real), -127, 128).reshape(F, N)
        im = np.clip(np.round(z.imag), -127, 128).reshape(F, N)
    else:
        re = rng.integers(-127, 129, (F, N))
        im = rng.integers(-127, 129, (F, N))
    return re.astype(np.float32), im.astype(np.float32)


def _golden(re, im):
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    return (np.abs(np.fft.fft(x, axis=1)) ** 2).sum(0)


def test_best_threestep_split():
    assert best_threestep_split(1 << 20) == (128, 128, 64)
    a, b, c = best_threestep_split(1 << 18)
    assert a * b * c == 1 << 18


@pytest.mark.parametrize("fn", [fourstep_psd_partial_mixed,
                                threestep_psd_partial_mixed])
def test_mixed_matches_golden_noise(fn):
    import jax
    N, F = 4096, 32
    re, im = _signal(N, F, tone=False)
    got = np.asarray(jax.jit(fn)(re, im, np.ones(F, np.float32)),
                     dtype=np.float64)
    want = _golden(re, im)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("fn", [fourstep_psd_partial_mixed,
                                threestep_psd_partial_mixed])
def test_mixed_tone_moderate_dynamic_range(fn):
    """At moderate dynamic range the mixed transforms hold the 1e-5
    budget; at extreme tone concentration they sit at the four-step
    family's f32 cancellation floor (documented in the docstrings)."""
    import jax
    N, F = 2048, 32
    re, im = _signal(N, F, tone=True)
    got = np.asarray(jax.jit(fn)(re, im, np.ones(F, np.float32)),
                     dtype=np.float64)
    want = _golden(re, im)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mixed_masking():
    import jax
    N, F = 2048, 16
    re, im = _signal(N, F, tone=False, seed=3)
    fm = np.zeros(F, np.float32)
    fm[:10] = 1.0
    got = np.asarray(jax.jit(fourstep_psd_partial_mixed)(re, im, fm),
                     dtype=np.float64)
    want = _golden(re[:10], im[:10])
    np.testing.assert_allclose(got, want, rtol=1e-5)
