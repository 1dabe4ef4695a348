"""Golden parity tests: the device spectral core vs a literal float64
transcription of the reference compute path (datastore.cxx:69-87 +
acquisition.cxx:376-399). Tolerance: 1e-5 relative (BASELINE.json)."""

import numpy as np
import pytest

from rtl_power_fftw_tpu.ops import (
    FrameSlicer, PsdStep, bin_frequencies, finalize_psd,
)
from rtl_power_fftw_tpu.auxdata import make_window

from golden import golden_accumulate, golden_finalize


def make_stream(n_bytes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Tone + noise, quantized around 127 like an RTL dongle.
    t = np.arange(n_bytes // 2)
    sig = (127.0
           + 30.0 * np.cos(2 * np.pi * 0.123 * t)
           + 10.0 * rng.standard_normal(n_bytes // 2))
    iq = np.empty(n_bytes)
    iq[0::2] = sig
    iq[1::2] = (127.0 + 30.0 * np.sin(2 * np.pi * 0.123 * t)
                + 10.0 * rng.standard_normal(n_bytes // 2))
    return np.clip(np.rint(iq), 0, 255).astype(np.uint8)


def run_pipeline(stream, N, repeats, window=None, backend="xla", F=None,
                 linear=False, baseline=None, rate=2_048_000):
    """End-to-end: slice → device steps → f64 host accumulate → finalize."""
    step = PsdStep(N, F or max(1, repeats), window=window, backend=backend)
    slicer = FrameSlicer(N)
    pwr = np.zeros(N, dtype=np.float64)
    done = 0
    frames = slicer.push(stream, max_frames=repeats)
    for start in range(0, len(frames), step.F):
        batch = frames[start:start + step.F]
        n_valid = len(batch)
        if n_valid < step.F:
            batch = np.concatenate(
                [batch, np.zeros((step.F - n_valid, 2 * N), np.uint8)])
        pwr += np.asarray(step(batch, n_valid), dtype=np.float64)
        done += n_valid
    out = finalize_psd(pwr, done, rate, linear=linear, baseline=baseline)
    return out, done


@pytest.mark.parametrize("backend", ["xla", "matmul", "fourstep"])
@pytest.mark.parametrize("N", [64, 512, 500])
def test_psd_matches_golden(backend, N):
    repeats = 20
    stream = make_stream(2 * N * repeats, seed=N)
    got, done = run_pipeline(stream, N, repeats, backend=backend)
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000)
    assert done == done_ref == repeats
    # dB-domain comparison: 1e-5 in linear power ≈ 4.3e-6 dB absolute.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_psd_linear_matches_golden(backend):
    N, repeats = 256, 16
    stream = make_stream(2 * N * repeats, seed=7)
    got, done = run_pipeline(stream, N, repeats, backend=backend, linear=True)
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000, linear=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_windowed_psd_matches_golden():
    N, repeats = 512, 12
    window = make_window("hann", N)
    stream = make_stream(2 * N * repeats, seed=3)
    got, _ = run_pipeline(stream, N, repeats, window=window)
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats, window=window)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_baseline_subtraction():
    N, repeats = 128, 8
    stream = make_stream(2 * N * repeats, seed=11)
    baseline = np.linspace(-5, 5, N)
    got, _ = run_pipeline(stream, N, repeats, baseline=baseline)
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000, baseline=baseline)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_repeats_cap_discards_extra_data():
    """The reference stops at `repeats` even if more data remains
    (datastore.cxx:67)."""
    N, repeats = 64, 5
    stream = make_stream(2 * N * (repeats + 7), seed=5)
    got, done = run_pipeline(stream, N, repeats)
    assert done == repeats
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_frame_carry_across_buffers():
    """Frames must carry across buffer boundaries (datastore.cxx:52,66-80)."""
    N = 100  # non-power-of-2, like the doc example -b 500
    repeats = 9
    stream = make_stream(2 * N * repeats, seed=9)
    slicer = FrameSlicer(N)
    # Feed in awkward chunk sizes that never align with 2N.
    chunks = np.array_split(stream, [37, 150, 151, 900, 901])
    frames = [slicer.push(c) for c in chunks]
    all_frames = np.concatenate([f for f in frames if len(f)])
    assert all_frames.shape == (repeats, 2 * N)
    np.testing.assert_array_equal(all_frames.ravel(), stream[:repeats * 2 * N])


def test_frame_slicer_welch_overlap():
    N = 8
    slicer = FrameSlicer(N, hop=N // 2)  # 50% overlap
    data = np.arange(64, dtype=np.uint8)
    frames = slicer.push(data)
    assert frames.shape == (7, 16)
    np.testing.assert_array_equal(frames[0], data[0:16])
    np.testing.assert_array_equal(frames[1], data[8:24])


def test_bin_frequencies_formula():
    """freq_i = tuned + (i − N/2.0)·rate/N (acquisition.cxx:391)."""
    N, rate, tuned = 512, 2_048_000, 1_420_405_752
    f = bin_frequencies(tuned, N, rate)
    assert f[0] == tuned + (0 - N / 2.0) * rate / N
    assert f[N // 2] == tuned
    assert f[-1] == tuned + ((N - 1) - N / 2.0) * rate / N


def test_dc_interpolation():
    N = 16
    pwr = np.zeros(N)
    pwr[0] = 1000.0  # DC lands at bin 0 unshifted → N/2 after shift
    shifted_neighbors = np.fft.fftshift(np.arange(N, dtype=float))
    out = finalize_psd(np.arange(N, dtype=float), 1, 1, linear=True)
    expect_center = (shifted_neighbors[N // 2 - 1] + shifted_neighbors[N // 2 + 1]) / 2
    assert out[N // 2] == expect_center / N


def test_fourstep_split():
    from rtl_power_fftw_tpu.ops import best_fourstep_split
    for n in [64, 500, 2048, 8192, 1 << 20]:
        n1, n2 = best_fourstep_split(n)
        assert n1 * n2 == n
        assert n1 <= n2


def test_large_prime_bins():
    """Arbitrary even N must work (doc example uses -b 500); 2·prime is the
    worst case for FFT decomposition."""
    N = 2 * 241
    repeats = 4
    stream = make_stream(2 * N * repeats, seed=42)
    got, _ = run_pipeline(stream, N, repeats, backend="matmul")
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_auto_backend_8192_matches_golden():
    """Config-2 scale: 8192 bins through the auto (fused four-step) path."""
    N, repeats = 8192, 8
    stream = make_stream(2 * N * repeats, seed=88)
    got, done = run_pipeline(stream, N, repeats, backend="auto")
    pwr_ref, done_ref = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr_ref, done_ref, 2_048_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_auto_backend_ladder():
    """The auto backend's crossovers: the hybrid four-step (FFT stage 1 +
    matmul stage 2) covers 512-3072, pure matmul four-step sits outside
    that band up to 8192, and the FFT four-step serves the huge-N modes
    (two fft ops in the jaxpr)."""
    import jax
    s_small = PsdStep(256, 8, backend="auto")      # matmul four-step
    s_mid = PsdStep(2048, 8, backend="auto")       # hybrid: one fft stage
    # Large non-pow2 composite: the CPU ladder's fft4.
    s_large = PsdStep(3 << 13, 8, backend="auto")
    def n_ffts(s):
        return str(jax.make_jaxpr(s.lowered_fn())(*s.example_args())
                   ).count(" fft[")
    assert n_ffts(s_small) == 0
    assert n_ffts(s_mid) == 1
    assert s_mid.takes_u16
    assert n_ffts(s_large) == 2


def test_precision_knob_api():
    """--precision high plumbs through to the explicit matmul rungs; CPU
    computes full f32 either way, so results match exactly there."""
    N, F = 256, 64
    rng = np.random.default_rng(70)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    hi = PsdStep(N, F, backend="fourstep", precision="highest")
    lo = PsdStep(N, F, backend="fourstep", precision="high")
    import jax
    # CPU computes full f32 either way; on an accelerator 'high'
    # genuinely drops to a bf16x3-class product.
    tol = 1e-6 if jax.default_backend() == "cpu" else 2e-4
    np.testing.assert_allclose(np.asarray(hi(raw, F)), np.asarray(lo(raw, F)),
                               rtol=tol)
    with pytest.raises(ValueError):
        PsdStep(N, F, precision="bf16")


def test_dequant_u16_bit_exact_vs_naive():
    """Guards the u16-bitcast dequantization (the +21% optimization):
    must be bit-identical to the naive (u8->f32, strided split) form."""
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.ops.spectral import dequant_iq
    F, N = 32, 256
    rng = np.random.default_rng(90)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    re, im = dequant_iq(jnp.asarray(raw), F, N)
    x = raw.astype(np.float32) - 127.0
    iq = x.reshape(F, N, 2)
    np.testing.assert_array_equal(np.asarray(re), iq[..., 0])
    np.testing.assert_array_equal(np.asarray(im), iq[..., 1])
    # Windowed variant too.
    w = make_window("hann", N)
    re_w, im_w = dequant_iq(jnp.asarray(raw), F, N, jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(re_w), iq[..., 0] * w)


def test_adversarial_tone_distribution_class_relative():
    """The committed adversarial-tone guarantee (round 3): over random
    35 dB-tone realizations (random frequency/phase, amp 100 over sigma-1
    noise), the shipping path's max error stays within 2x the max of the
    FFTW-f32 class (scipy f32 FFT) on the same realizations — the
    distribution-vs-distribution form of "matches the reference's own
    precision" (per-realization ratios are noisy because the class error
    itself varies ~5x across realizations). Thresholds are the measured
    guarantee plus margin: median <= 1.5x the yardstick median and max
    <= 3x the yardstick max — measured max ratio on CPU 2.4x (the CPU
    BLAS stage-2 accumulates sequentially in f32; an f64-stage-2
    ablation pins the entire tail to stage-2 accumulation). On the GPU
    the auto path is the platform FFT, the yardstick's own class.
    """
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from rtl_power_fftw_tpu.ops.spectral import PsdStep

    def realization(N, F, seed):
        rng = np.random.default_rng(seed)
        f0 = rng.uniform(0.05, 0.45)
        ph = rng.uniform(0, 2 * np.pi)
        t = np.arange(F * N)
        x = 100.0 * np.exp(1j * (2 * np.pi * f0 * t + ph)) + (
            rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
        re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
        im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
        return np.stack([re8, im8], axis=-1).reshape(F, 2 * N)

    def rel(got, want):
        return float((np.abs(np.asarray(got, np.float64) - want)
                      / np.maximum(np.abs(want), 1e-30)).max())

    mono = jax.jit(lambda z: jnp.fft.fft(z, axis=1))
    for N, F in ((2048, 64), (8192, 32)):
        step = PsdStep(N, F, backend="auto")
        ours, yard = [], []
        for seed in range(15):
            raw = realization(N, F, 500 + seed)
            z = (raw[:, 0::2].astype(np.float64) - 127.0) \
                + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
            X = np.fft.fft(z, axis=1)
            want = (X.real ** 2 + X.imag ** 2).sum(0)
            ours.append(rel(np.asarray(step(raw, F), np.float64), want))
            z32 = z.astype(np.complex64)
            Xc = scipy.fft.fft(z32, axis=1)
            cls = rel((Xc.real.astype(np.float64) ** 2
                       + Xc.imag.astype(np.float64) ** 2).sum(0), want)
            Xp = np.asarray(mono(z32))
            plat = rel((Xp.real.astype(np.float64) ** 2
                        + Xp.imag.astype(np.float64) ** 2).sum(0), want)
            yard.append(max(cls, plat))
        assert np.median(ours) <= 1.5 * np.median(yard), \
            (N, np.median(ours), np.median(yard))
        assert max(ours) <= 3.0 * max(yard), (N, max(ours), max(yard))
