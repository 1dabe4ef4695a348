"""Windowed-path numerics and band selection.

The reference applies windows as a per-frame time-domain multiply before
the FFT (datastore.cxx:76-77). Windowing changes the accuracy landscape:
under a strong tone the windowed FFTW-f32 class error is ~2x SMALLER
(relative) than unwindowed, and paths whose stage-1 FFT relied on
exactly-representable integer inputs (the hybrid) lose that anchor. So
windowed auto uses the platform FFT on both ladders: on CPU it IS the
class yardstick (ratio 1.00), on the GPU it is cuFFT. The matmul rungs
(fourstep, fourstep4m, fourstep4x) stay reachable as explicit backends
and are pinned here against the float64 truth.
"""
import numpy as np
import pytest

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.ops.spectral import PsdStep


def _f64_truth(raw, w):
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    X = np.fft.fft(z * w.astype(np.float64), axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


def _rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


class TestWindowedParity:
    @pytest.mark.parametrize("name,N,F,backend", [
        ("hann", 2048, 32, "hybrid"),
        ("hamming", 1024, 32, "fourstep"),
        ("blackman", 2048, 32, "fourstep"),
        ("flattop", 4096, 16, "fft4"),
        ("bartlett", 1024, 32, "fourstep"),
        ("hann", 2048, 32, "auto"),
    ])
    def test_windowed_within_parity(self, name, N, F, backend):
        w = make_window(name, N)
        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        want = _f64_truth(raw, w)
        step = PsdStep(N, F, window=w, backend=backend)
        inp = raw.view(np.uint16) if step.takes_u16 else raw
        assert _rel(step(inp, F), want) <= 1e-5

    def test_windowed_respects_frame_mask(self):
        N, F, valid = 1024, 32, 17
        w = make_window("hann", N)
        rng = np.random.default_rng(12)
        raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        want = _f64_truth(raw[:valid], w)
        step = PsdStep(N, F, window=w, backend="fourstep")
        inp = raw.copy()
        inp[valid:] = 255  # garbage in the padding rows must not leak
        inp = inp.view(np.uint16) if step.takes_u16 else inp
        assert _rel(step(inp, valid), want) <= 1e-5


def test_windowed_cpu_auto_uses_xla_fft():
    """CPU windowed auto must fall through to the XLA FFT — on CPU
    it is the FFTW-class yardstick itself (measured 30-seed windowed
    p50 ratio 1.00 vs the matmul-stage paths' 1.6-2.7)."""
    N, F = 2048, 32
    w = make_window("hann", N)
    auto = PsdStep(N, F, window=w, backend="auto")
    # The XLA fallback path takes plain u8 frames, not the u16 view the
    # fused four-step family uses — that distinguishes the ladders.
    assert not auto.takes_u16
    unwindowed = PsdStep(N, F, backend="auto")
    assert unwindowed.takes_u16  # hybrid band still owns unwindowed 2048


def _tone_realization(N, F, seed):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0.05, 0.45)
    ph = rng.uniform(0, 2 * np.pi)
    t = np.arange(F * N)
    x = 100.0 * np.exp(1j * (2 * np.pi * f0 * t + ph)) + (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re8, im8], axis=-1).reshape(F, 2 * N)


def test_windowed_adversarial_tone_class_relative():
    """The class-relative guarantee must hold WITH a window on the auto
    ladder against the scipy-f32 (FFTW-class) yard on the same
    realizations: median <= 1.5x / max <= 3x."""
    import scipy.fft

    N, F = 2048, 32
    w = make_window("hann", N)
    w64 = w.astype(np.float64)
    step = PsdStep(N, F, window=w, backend="auto")
    ours, yard = [], []
    for seed in range(15):
        raw = _tone_realization(N, F, 700 + seed)
        z = (raw[:, 0::2].astype(np.float64) - 127.0) \
            + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
        X = np.fft.fft(z * w64, axis=1)
        want = (X.real ** 2 + X.imag ** 2).sum(0)
        inp = raw.view(np.uint16) if step.takes_u16 else raw
        ours.append(_rel(step(inp, F), want))
        zw32 = z.astype(np.complex64) * w.astype(np.complex64)
        Xc = scipy.fft.fft(zw32, axis=1)
        yard.append(_rel((Xc.real.astype(np.float64) ** 2
                          + Xc.imag.astype(np.float64) ** 2).sum(0), want))
    assert np.median(ours) <= 1.5 * np.median(yard), \
        (np.median(ours), np.median(yard))
    assert max(ours) <= 3.0 * max(yard), (max(ours), max(yard))


#: (N, windowed) → the auto rung on the GPU, as measured on an H100
#: (PERF.md "Transform bands": per BASELINE size, the faster rung that
#: holds the tone budget best) — the same ladder the CPU runs.
_GPU_BANDS = {
    (2048, False): "hybrid", (2048, True): "xla",
    (4096, False): "xla", (4096, True): "xla",
    (8192, False): "xla", (8192, True): "xla",
    (16384, False): "fft4", (16384, True): "fft4",
    (65536, False): "fft4", (65536, True): "fft4",
    (1 << 20, False): "fft4", (1 << 20, True): "fft4",
}


@pytest.mark.parametrize("N,windowed", sorted(_GPU_BANDS))
def test_gpu_band_table(monkeypatch, N, windowed):
    """The GPU auto band at each BASELINE size and across 4096-65536,
    windowed or not, for the single-stream and the sharded step alike
    (one shared selection). Selection is pure Python, so it is pinned
    here on the CPU harness by answering the platform question; the
    same sizes select the same rungs on CPU."""
    import jax
    from rtl_power_fftw_tpu.ops.spectral import select_transform_rung

    want = _GPU_BANDS[(N, windowed)]
    assert select_transform_rung(N, windowed, "auto")[0] == want
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    w = make_window("hann", N) if windowed else None
    step = PsdStep(N, 8, window=w, backend="auto")
    assert step.path == want
    assert step.takes_u16 == (want != "xla")


def test_gpu_precision_high_is_ignored_with_one_note(monkeypatch, capsys):
    """--precision high is measured on CPU only: on the GPU auto keeps
    HIGHEST and says so once; explicit matmul rungs keep honoring it."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    step = PsdStep(2048, 32, backend="auto", precision="high")
    assert step.path == "hybrid"
    assert step._precision == jax.lax.Precision.HIGHEST
    err = capsys.readouterr().err
    assert err.count("--precision high has no effect on the GPU") == 1
    explicit = PsdStep(2048, 32, backend="hybrid", precision="high")
    assert explicit._precision == jax.lax.Precision.HIGH
    assert "no effect on the GPU" not in capsys.readouterr().err


def test_split_window_exactness_and_parity():
    """split_window: w reconstructs exactly and x*w_hi is bit-exact for
    every dequant value (the 15-bit-mantissa truncation claim); the
    split-window hybrid matches the f64 truth within the f32 budget.
    """
    import jax
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.ops.dft import (
        best_hybrid_split, fourstep_hybrid_windowed_psd_partial,
        split_window)

    N, F = 1024, 8
    w = make_window("hamming", N)
    w_hi, w_lo = split_window(w)
    x = np.arange(-127, 129, dtype=np.float64)
    exact = x[:, None] * w_hi.astype(np.float64)[None, :]
    f32 = (x.astype(np.float32)[:, None] * w_hi[None, :]).astype(np.float64)
    assert np.array_equal(exact, f32)
    np.testing.assert_array_equal(
        w_hi.astype(np.float64) + w_lo.astype(np.float64),
        w.astype(np.float64))

    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    re = raw[:, 0::2].astype(np.float32) - 127
    im = raw[:, 1::2].astype(np.float32) - 127
    n1, n2 = best_hybrid_split(N, min_n1=8)
    got = np.asarray(fourstep_hybrid_windowed_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.ones(F, jnp.float32),
        jnp.asarray(w_hi), jnp.asarray(w_lo), n1, n2), np.float64)
    want = _f64_truth(raw, w)
    assert _rel(got, want) < 1e-5


def test_fourstep4m_parity_and_explicit_backend():
    """The compensated four-step (round-4 budget-truth path for windowed
    2^19): 4-mult stages + hi/lo split twiddle + chunked stage-2 tree
    accumulation — parity vs the f64 truth, explicit-backend PsdStep,
    and the sharded step land on the same partial."""
    from rtl_power_fftw_tpu.ops.dft import fourstep4m_psd_partial
    import jax.numpy as jnp

    N, F = 2048, 8
    w = make_window("hann", N)
    rng = np.random.default_rng(13)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    re = (raw[:, 0::2].astype(np.float32) - 127) * w
    im = (raw[:, 1::2].astype(np.float32) - 127) * w
    fmask = np.ones(F, np.float32)
    fmask[-1] = 0
    got = np.asarray(fourstep4m_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask)), np.float64)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    want = ((X.real ** 2 + X.imag ** 2)
            * fmask[:, None].astype(np.float64)).sum(0)
    assert _rel(got, want) < 1e-5

    # Explicit backend on the session step (any composite N, windowed or
    # not), chunked stage-2 exercised via a large-N2 split.
    step = PsdStep(N, F, window=w, backend="fourstep4m")
    assert step.path == "fourstep4m" and step.takes_u16
    got2 = np.asarray(step(raw.view(np.uint16), F - 1), np.float64)
    assert _rel(got2, want) < 1e-5

    big = np.asarray(fourstep4m_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask),
        2, 1024), np.float64)          # N2=1024 → 4 stage-2 chunks
    assert _rel(big, want) < 1e-5

    import pytest as _pytest
    with _pytest.raises(ValueError, match="composite"):
        from rtl_power_fftw_tpu.ops.spectral import select_transform_rung
        select_transform_rung(1009, False, "fourstep4m")


def test_fourstep4m_odd_chunk_tree():
    """Regression (round-5 advisor HIGH): the stage-2 pairwise tree sum
    crashed with IndexError whenever the chunk count was odd — e.g. the
    auto split at N=393216 gives 512x768 → 768//256 = 3 chunks, so 8408
    in-band windowed sizes (and the fourstep4m estimator paths) crashed
    at trace time. The odd tail must carry through each tree level."""
    import jax
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.ops.dft import (best_fourstep_split,
                                            fourstep4m_psd_partial)

    # Small-N numeric check with a forced 3-chunk stage 2 (N2=768).
    N, F = 3072, 8
    rng = np.random.default_rng(23)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    re = raw[:, 0::2].astype(np.float32) - 127
    im = raw[:, 1::2].astype(np.float32) - 127
    fmask = np.ones(F, np.float32)
    got = np.asarray(fourstep4m_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask),
        4, 768), np.float64)           # N2=768 → s2_chunks=3 (odd)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    want = (X.real ** 2 + X.imag ** 2).sum(0)
    assert _rel(got, want) < 1e-5

    # Trace-only check at the advisor's exact crashing size (the auto
    # split itself lands on the odd chunk count: 512x768).
    Nbig = 393216
    n1, n2 = best_fourstep_split(Nbig)
    assert (n1, n2) == (512, 768) and (n2 // 256) % 2 == 1
    out = jax.eval_shape(
        lambda r, i, m: fourstep4m_psd_partial(r, i, m, n1, n2),
        jax.ShapeDtypeStruct((4, Nbig), jnp.float32),
        jax.ShapeDtypeStruct((4, Nbig), jnp.float32),
        jax.ShapeDtypeStruct((4,), jnp.float32))
    assert out.shape == (Nbig,)


def test_fourstep4x_parity_and_explicit_backend():
    """The split-pass four-step (round-5 windowed session-band
    budget-truth path): explicit native-bf16 stage 1 (4-term input ×
    4-term weight truncation splits, triangular pass set, shallow
    contraction) over the audited fourstep4m tail — parity vs the f64
    truth, explicit-backend PsdStep, frame mask, per-frame sibling,
    and the divisible-by-8 requirement."""
    import jax.numpy as jnp
    import pytest as _pytest
    from rtl_power_fftw_tpu.ops.dft import (best_fourstep4x_split,
                                            dft_power_fourstep4x,
                                            fourstep4x_psd_partial)

    # Split rule: K=16 direct when 16 | N (med 0.73-1.05x across the
    # probed band), K=8 when only 8 | N (strictly shallower).
    assert best_fourstep4x_split(2048) == (16, 128)
    assert best_fourstep4x_split(4096) == (16, 256)
    assert best_fourstep4x_split(1800) == (8, 225)   # 8 | N only
    assert best_fourstep4x_split(1048) == (8, 131)

    N, F = 2048, 8
    w = make_window("hann", N)
    rng = np.random.default_rng(29)
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    re = (raw[:, 0::2].astype(np.float32) - 127) * w
    im = (raw[:, 1::2].astype(np.float32) - 127) * w
    fmask = np.ones(F, np.float32)
    fmask[-1] = 0
    got = np.asarray(fourstep4x_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask)), np.float64)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    pwr = X.real ** 2 + X.imag ** 2
    want = (pwr * fmask[:, None].astype(np.float64)).sum(0)
    assert _rel(got, want) < 1e-5

    # The unchunked K=16 split computes the same transform.
    got16 = np.asarray(fourstep4x_psd_partial(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask),
        16, 128), np.float64)
    assert _rel(got16, want) < 1e-5

    # Explicit backend on the session step.
    step = PsdStep(N, F, window=w, backend="fourstep4x")
    assert step.path == "fourstep4x" and step.takes_u16
    got2 = np.asarray(step(raw.view(np.uint16), F - 1), np.float64)
    assert _rel(got2, want) < 1e-5

    # Per-frame sibling (the windowed SK family's transform).
    pf = np.asarray(dft_power_fourstep4x(
        jnp.asarray(re), jnp.asarray(im)), np.float64)
    assert _rel(pf.sum(0), pwr.sum(0)) < 1e-5

    with _pytest.raises(ValueError, match="divisible by 8"):
        PsdStep(1028, F, backend="fourstep4x")   # 1028 = 4·257


@pytest.mark.parametrize("backend", ["fourstep4m", "fourstep4x"])
def test_fourstep4m_sharded_parity(backend):
    import jax
    from jax.sharding import Mesh
    from rtl_power_fftw_tpu.parallel.sharded import ShardedPsdStep

    devs = jax.devices()
    if len(devs) < 8:
        import pytest as _pytest
        _pytest.skip("needs an 8-device mesh (CPU harness)")
    mesh = Mesh(np.array(devs[:8]), ("stream",))
    N, F, S = 1024, 8, 8
    w = make_window("hann", N)
    sh = ShardedPsdStep(mesh, N, F, streams=S, window=w,
                        backend=backend)
    assert sh.path == backend
    rng = np.random.default_rng(17)
    raw = rng.integers(0, 256, (S, sh.F, 2 * N), dtype=np.uint8)
    per_stream, combined = sh(raw, np.full(S, sh.F, np.int32))
    total = np.zeros(N)
    for s in range(S):
        re = (raw[s, :, 0::2].astype(np.float32) - 127) * w
        im = (raw[s, :, 1::2].astype(np.float32) - 127) * w
        z = re.astype(np.float64) + 1j * im.astype(np.float64)
        X = np.fft.fft(z, axis=1)
        want = (X.real ** 2 + X.imag ** 2).sum(0)
        assert _rel(np.asarray(per_stream[s], np.float64), want) < 1e-5, s
        total += want
    assert _rel(np.asarray(combined, np.float64), total) < 1e-5
