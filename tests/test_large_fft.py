"""Large-N modes: the 1M-point long-integration FFT (BASELINE config 3)
and other big transforms, on the CPU harness."""

import numpy as np
import pytest

from rtl_power_fftw_tpu.ops import PsdStep, FrameSlicer, finalize_psd
from rtl_power_fftw_tpu.ops.dft import best_fourstep_split


def test_1m_point_psd():
    N = 1 << 20
    F = 2  # two spectra, long-integration style
    rng = np.random.default_rng(31)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    step = PsdStep(N, F, backend="xla")
    assert step.F == 8  # small-batch mode: padded to 8, not 64
    padded = np.concatenate([raw, np.zeros((step.F - F, 2 * N), np.uint8)])
    got = np.asarray(step(padded, F), dtype=np.float64)
    assert got.shape == (N,)
    # Spot-check against numpy float64 on the same frames.
    want = np.zeros(N)
    for f in range(F):
        z = (raw[f, 0::2].astype(np.float64) - 127.0) \
            + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)
        X = np.fft.fft(z)
        want += X.real ** 2 + X.imag ** 2
    np.testing.assert_allclose(got, want, rtol=2e-4)  # f32 FFT @ 1M points
    out = finalize_psd(got, F, 2_048_000)
    assert np.isfinite(out).all()


def test_1m_point_fourstep_split():
    n1, n2 = best_fourstep_split(1 << 20)
    assert n1 == n2 == 1024


def test_frame_slicer_1m_frames():
    N = 1 << 20
    slicer = FrameSlicer(N)
    a = np.zeros(2 * N - 100, np.uint8)
    assert len(slicer.push(a)) == 0          # not a full frame yet
    b = np.zeros(150, np.uint8)
    frames = slicer.push(b)
    assert frames.shape == (1, 2 * N)


def test_1m_auto_uses_fft_fourstep():
    """CPU auto at very large N selects the two-level FFT four-step
    (a fused u16-view path) — parity against numpy float64."""
    N, F = 1 << 20, 2
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    step = PsdStep(N, F, backend="auto")
    assert step.takes_u16            # the fft4 path's input convention
    padded = np.concatenate([raw, np.zeros((step.F - F, 2 * N), np.uint8)])
    got = np.asarray(step(padded, F), dtype=np.float64)
    want = np.zeros(N)
    for f in range(F):
        z = (raw[f, 0::2].astype(np.float64) - 127.0) \
            + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)
        X = np.fft.fft(z)
        want += X.real ** 2 + X.imag ** 2
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_fft_fourstep_explicit_backend_small_n():
    """Explicit backend='fft4' works at any composite N, tight parity."""
    N, F = 768, 16                     # 768 = 24 x 32: non-pow2 composite
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    step = PsdStep(N, F, backend="fft4")
    got = np.asarray(step(raw, F), dtype=np.float64)
    want = np.zeros(N)
    for f in range(F):
        z = (raw[f, 0::2].astype(np.float64) - 127.0) \
            + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)
        X = np.fft.fft(z)
        want += X.real ** 2 + X.imag ** 2
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()
    assert rel < 1e-5


def test_fft_fourstep_windowed_and_masked():
    N, F = 1 << 14, 8
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, (5, 2 * N), dtype=np.uint8)   # 5 valid of 8
    w = np.hanning(N).astype(np.float32)
    step = PsdStep(N, F, backend="fft4", window=w)
    padded = np.concatenate([raw, np.zeros((step.F - 5, 2 * N), np.uint8)])
    got = np.asarray(step(padded, 5), dtype=np.float64)
    want = np.zeros(N)
    for f in range(5):
        z = ((raw[f, 0::2].astype(np.float64) - 127.0)
             + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)) * w
        X = np.fft.fft(z)
        want += X.real ** 2 + X.imag ** 2
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_precision_high_selects_fft_fourstep_small_n():
    """precision='high' (relaxed parity) ships the FFT four-step at
    small/mid N — uniform-input parity stays tight (~1e-5; the relaxed
    part is extreme-tone robustness)."""
    for N in (1024, 2048):
        F = 64
        rng = np.random.default_rng(10 + N)
        raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        step = PsdStep(N, F, backend="auto", precision="high")
        assert step.takes_u16
        got = np.asarray(step(raw, F), dtype=np.float64)
        want = np.zeros(N)
        for f in range(F):
            z = (raw[f, 0::2].astype(np.float64) - 127.0) \
                + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)
            X = np.fft.fft(z)
            want += X.real ** 2 + X.imag ** 2
        rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()
        assert rel < 1e-5, (N, rel)


def test_hybrid_backend_parity_and_window():
    """The hybrid four-step (auto default for 512<=N<=3072): tight
    parity incl. windowed + masked batches."""
    N, F = 2048, 16
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, (11, 2 * N), dtype=np.uint8)  # 11 valid
    w = np.hanning(N).astype(np.float32)
    step = PsdStep(N, F, backend="hybrid", window=w)
    assert step.takes_u16
    padded = np.concatenate([raw, np.zeros((step.F - 11, 2 * N), np.uint8)])
    got = np.asarray(step(padded, 11), dtype=np.float64)
    want = np.zeros(N)
    for f in range(11):
        z = ((raw[f, 0::2].astype(np.float64) - 127.0)
             + 1j * (raw[f, 1::2].astype(np.float64) - 127.0)) * w
        X = np.fft.fft(z)
        want += X.real ** 2 + X.imag ** 2
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()
    assert rel < 1e-5


def test_hybrid_tone_robustness():
    """The property that makes the hybrid the DEFAULT at 512-3072: under
    a 35 dB tone its error stays inside the 3e-5 bound (on CPU matmuls
    are plain f32)."""
    N, F = 2048, 64
    t = np.arange(F * N)
    rng = np.random.default_rng(12)
    x = 100.0 * np.exp(2j * np.pi * 0.1303 * t) + \
        (rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    raw = np.stack([re8, im8], axis=-1).reshape(F, 2 * N)
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    want = (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)

    def err(backend):
        step = PsdStep(N, F, backend=backend)
        got = np.asarray(step(raw, F), dtype=np.float64)
        return (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()

    rel = err("auto")
    # No transform holds a hard 1e-5 on every adversarial realization;
    # the enforced golden budget uses realistic tone levels.
    assert rel < 3e-5, rel


def _scipy_f32_class_err(raw, N, want64):
    """The reference's own precision class: FFTW single-precision
    (datastore.cxx:30-33,81). scipy.fft on complex64 input (pocketfft
    single precision) is the same class; its error vs float64 truth is
    the yardstick the shipping path must match."""
    import scipy.fft
    z32 = ((raw[:, 0::2].astype(np.float32) - np.float32(127.0))
           + 1j * (raw[:, 1::2].astype(np.float32) - np.float32(127.0))
           ).astype(np.complex64)
    X = scipy.fft.fft(z32, axis=1)
    got = (X.real.astype(np.float64) ** 2
           + X.imag.astype(np.float64) ** 2).sum(0)
    return _max_rel(got, want64)


def _max_rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def _want64(raw):
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


@pytest.mark.parametrize("N", [1 << 17, 1 << 20])
def test_shipping_path_matches_reference_precision_class(N):
    """The CLAUDE.md parity contract, enforced the way it is meant: the
    shipping (auto) path at very large N must match the REFERENCE'S OWN
    precision class — FFTW f32 (datastore.cxx:30-33) — not an arbitrary
    rtol. scipy f32 FFT vs float64 truth defines the class error at this
    N; the shipping path must stay within 1.5x of it (plus the 1e-5
    absolute floor for when the class error is tiny).

    f32 error N-scaling (documented here once): under a tone of amplitude
    A over noise sigma, ANY f32 transform leaks ~eps_eff*sqrt(N)*A/sigma
    relative into the noise bins (absolute leak ~eps_eff*N*A against bins
    of magnitude ~sqrt(N)*sigma) — including FFTW f32. So the class error
    itself grows from ~1e-5 at 2^11 to ~1.4e-4 at 2^17 and ~1.3e-3 at
    2^20 (measured, scipy f32, 35 dB tone), and a FIXED 1e-5 budget at
    large N would demand accuracy the reference itself does not have. The
    budget is therefore RELATIVE to the measured class error at the same
    N, which is what "matching the reference" actually means.

    The yardstick is platform-aware: the shipping path must stay within
    1.5x of the worse of (scipy f32 class, XLA's own monolithic f32 FFT
    on this platform). On the CPU harness XLA's FFT is itself ~2.5x the
    scipy class and the fft4 default tracks it; on the GPU the default
    IS the platform FFT.
    """
    import jax
    import jax.numpy as jnp
    F = 2
    rng = np.random.default_rng(42 + N)
    # Realistic input: noise + a moderate tone (the reference's own use
    # case: weak signals over a noise floor).
    t = np.arange(F * 2 * N // 2)
    x = 20.0 * np.exp(2j * np.pi * 0.2347 * t) + 4.0 * (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    raw = np.stack([re8, im8], axis=-1).reshape(F, 2 * N)

    want = _want64(raw)
    class_err = _scipy_f32_class_err(raw, N, want)

    # The platform's own FFT class: monolithic f32 jnp.fft on the same
    # input (what the reference's fftwf_execute is to FFTW).
    z32 = ((raw[:, 0::2].astype(np.float32) - np.float32(127.0))
           + 1j * (raw[:, 1::2].astype(np.float32) - np.float32(127.0)))
    Xp = np.asarray(jax.jit(lambda z: jnp.fft.fft(z, axis=1))(
        z32.astype(np.complex64)))
    plat = (Xp.real.astype(np.float64) ** 2
            + Xp.imag.astype(np.float64) ** 2).sum(0)
    plat_err = _max_rel(plat, want)

    step = PsdStep(N, F, backend="auto")
    padded = np.concatenate([raw, np.zeros((step.F - F, 2 * N), np.uint8)])
    got = step(padded, F)
    ours = _max_rel(got, want)
    budget = max(1e-5, 1.5 * max(class_err, plat_err))
    assert ours <= budget, (ours, class_err, plat_err, budget)


def test_hybrid_large_n_explicit_backend_parity():
    """The asymmetric-split hybrid at large N, exercised via the
    explicit backend: uniform-input parity stays
    tight at composite N > 8192 (the split chooser picks a lane-friendly
    small stage-2)."""
    from rtl_power_fftw_tpu.ops.dft import best_hybrid_split

    N, F = 3 << 12, 8                    # 12288 = 96 x 128, non-pow2
    n1, n2 = best_hybrid_split(N)
    assert 64 <= n2 <= 512 and n1 * n2 == N
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    step = PsdStep(N, F, backend="hybrid")
    assert step.takes_u16
    got = np.asarray(step(raw, F), dtype=np.float64)
    want = _want64(raw)
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("N", [1 << 17, 1 << 19, 1 << 20])
def test_windowed_shipping_path_matches_reference_class(N):
    """The WINDOWED analogue of the reference-class golden above: the
    windowed auto path at very large N must stay within 1.5x of the
    platform-aware windowed f32 class (scipy f32 on the identically
    windowed input; plus the platform's own monolithic FFT when it
    compiles) on realistic inputs — the same form of budget the
    unwindowed test enforces."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from rtl_power_fftw_tpu.auxdata import make_window

    F = 2
    w = make_window("hann", N)
    w64 = w.astype(np.float64)
    rng = np.random.default_rng(71 + N)
    t = np.arange(F * N)
    x = 20.0 * np.exp(2j * np.pi * 0.2347 * t) + 4.0 * (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    raw = np.stack([re8, im8], axis=-1).reshape(F, 2 * N)

    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    X = np.fft.fft(z * w64, axis=1)
    want = (X.real ** 2 + X.imag ** 2).sum(0)

    zw32 = (z * w64).astype(np.complex64)
    Xc = scipy.fft.fft(zw32, axis=1)
    class_err = _max_rel((Xc.real.astype(np.float64) ** 2
                          + Xc.imag.astype(np.float64) ** 2).sum(0), want)
    try:
        Xp = np.asarray(jax.jit(lambda a: jnp.fft.fft(a, axis=1))(zw32))
        plat_err = _max_rel((Xp.real.astype(np.float64) ** 2
                             + Xp.imag.astype(np.float64) ** 2).sum(0),
                            want)
    except Exception:
        plat_err = 0.0  # degraded-yard fallback (see unwindowed test)

    step = PsdStep(N, F, window=w, backend="auto")
    padded = np.concatenate([raw, np.zeros((step.F - F, 2 * N), np.uint8)])
    inp = padded.view(np.uint16) if step.takes_u16 else padded
    ours = _max_rel(np.asarray(step(inp, F), np.float64), want)
    # One 1.5x form serves all sizes.
    budget = max(1e-5, 1.5 * max(class_err, plat_err))
    assert ours <= budget, (ours, class_err, plat_err, budget)
