"""The GPU bring-up surface: compile-cache placement, the entry points'
refusals, and chip_smoke.py's own helpers (CPU tests), plus the checks
that only the card can answer (``chip`` tests, skipped elsewhere)."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

from golden import golden_accumulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def restore_cache_dir():
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      before[1])


def test_compile_cache_fixed_dir_when_env_unset(monkeypatch,
                                                restore_cache_dir):
    from rtl_power_fftw_tpu.compile_cache import (CACHE_DIR,
                                                  configure_compile_cache)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert configure_compile_cache() == CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    # Fixed path: a second call (a second run) lands on the same dir.
    assert configure_compile_cache() == CACHE_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path,
                                              restore_cache_dir):
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    jax.config.update("jax_compilation_cache_dir", None)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    # No other directory is set in code, and JAX's settings stand.
    assert jax.config.jax_compilation_cache_dir is None
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0


def test_cli_configures_the_cache_before_parsing(monkeypatch):
    import rtl_power_fftw_tpu.cli as cli
    calls = []
    monkeypatch.setattr(cli, "configure_compile_cache",
                        lambda: calls.append(1))
    assert cli.main(["--bogus-option"]) == 4
    assert calls == [1]


def test_fft_backend_pallas_is_a_parse_error(capsys):
    from rtl_power_fftw_tpu.cli import main
    rc = main(["-f", "100M", "-n", "4", "-b", "256", "--fft-backend",
               "pallas", "--source", "synthetic:"])
    assert rc == 4
    assert "invalid choice: 'pallas'" in capsys.readouterr().err


def test_dryrun_multichip_raises_when_short_of_devices():
    import __graft_entry__
    have = len(jax.devices())
    with pytest.raises(RuntimeError, match=f"needs {have + 1} devices"):
        __graft_entry__.dryrun_multichip(have + 1)
    # Still on the platform it started on: no silent switch.
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", False),
                                         ("rocm", False)])
def test_chip_smoke_device_check(platform, ok):
    devs = [types.SimpleNamespace(platform=platform,
                                  device_kind="NVIDIA H100 80GB HBM3")] * 2
    if ok:
        assert chip_smoke.check_device(devs) == {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 2}
    else:
        with pytest.raises(RuntimeError, match="expected a GPU"):
            chip_smoke.check_device(devs)


def test_chip_smoke_excess_and_print_term():
    assert chip_smoke.print_term(6) == pytest.approx(5e-6)
    want = np.array([1.0, 2.0, 4.0])
    assert chip_smoke.max_excess(want, want, 1e-5) == 0.0
    # 1e-5 relative off: exactly at the budget without the print term,
    # well inside it with.
    got = want * (1 + 1e-5)
    assert chip_smoke.max_excess(got, want, 1e-5) == pytest.approx(1.0)
    assert chip_smoke.max_excess(got, want, 1e-5, digits=6) == \
        pytest.approx(1e-5 / 1.5e-5)
    assert chip_smoke.max_excess(want * (1 + 3e-5), want, 1e-5, 6) > 1.0
    with pytest.raises(ValueError, match="shape"):
        chip_smoke.max_excess(want[:2], want, 1e-5)
    with pytest.raises(ValueError, match="non-finite"):
        chip_smoke.max_excess(np.array([1.0, np.nan, 4.0]), want, 1e-5)


def test_chip_smoke_text_and_welch_frames():
    text = ("# rtl-power-fftw output\n#\n100000000 1.5e-05\n"
            "100000977 2.25e-05\n\n")
    np.testing.assert_array_equal(chip_smoke.read_text_spectrum(text),
                                  [1.5e-05, 2.25e-05])
    N, hop, n = 8, 4, 5
    stream = np.random.default_rng(0).integers(0, 256, 2 * (hop * n + N),
                                               dtype=np.uint8)
    frames = chip_smoke.overlapped_frames(stream, N, hop, n)
    assert frames.shape == (n * 2 * N,)
    np.testing.assert_array_equal(frames[2 * N:4 * N],
                                  stream[2 * hop:2 * (hop + N)])
    pwr, done = golden_accumulate(frames, N, n)
    assert done == n
    # The FFTW-class accumulation of the same frames sits near f32 eps.
    assert 0 < chip_smoke.scipy_f32_class_err(frames, N, pwr) < 1e-5


def test_chip_smoke_golden_compare_catches_a_wrong_spectrum():
    """The comparison chip_smoke runs on every phase: a correct f32
    spectrum of the same frames passes, a one-bin corruption fails."""
    from golden import golden_finalize
    from rtl_power_fftw_tpu.ops.spectral import PsdStep, finalize_psd
    N, reps = 256, 40
    stream = np.random.default_rng(3).integers(0, 256, 2 * N * reps,
                                               dtype=np.uint8)
    pwr, done = golden_accumulate(stream, N, reps)
    want = golden_finalize(pwr, done, 2_000_000, linear=True)
    step = PsdStep(N, reps, backend="auto")
    # The session flips (-1)^n by finalize's fftshift; same convention.
    part = np.asarray(step(stream.reshape(reps, 2 * N), reps), np.float64)
    got = finalize_psd(part, reps, 2_000_000, linear=True)
    assert chip_smoke.max_excess(got, want, 1e-5) <= 1.0
    got[17] *= 1.001
    assert chip_smoke.max_excess(got, want, 1e-5) > 1.0


def test_chip_smoke_fails_without_a_gpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the repository it cannot run the program."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ---- on the card (RPF_TEST_ON_CHIP=1 python -m pytest tests/ -m chip) ----


def _rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def _truth(raw, w=None):
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    if w is not None:
        z = z * w.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


@pytest.mark.chip
@pytest.mark.parametrize("N,window,rung", [(2048, None, "hybrid"),
                                           (8192, "hann", "xla"),
                                           (1 << 20, None, "fft4")])
def test_chip_auto_rungs_hold_parity(N, window, rung):
    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.ops.spectral import PsdStep
    F = 8 if N > 8192 else 64
    w = None if window is None else make_window(window, N)
    step = PsdStep(N, F, window=w, backend="auto")
    assert step.path == rung
    raw = np.random.default_rng(N).integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)
    assert _rel(step(raw, F), _truth(raw, w)) < 1e-5


@pytest.mark.chip
def test_chip_split_rungs_hold_parity():
    """The bf16 truncation splits survive the GPU compiler: fourstep4x
    at 2048 windowed and the mixed four-step at 2048."""
    import jax.numpy as jnp
    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.ops.dft import fourstep_psd_partial_mixed
    from rtl_power_fftw_tpu.ops.spectral import PsdStep, dequant_iq_u16
    N, F = 2048, 64
    w = make_window("hann", N)
    raw = np.random.default_rng(1).integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)
    step = PsdStep(N, F, window=w, backend="fourstep4x")
    assert step.path == "fourstep4x"
    assert _rel(step(raw, F), _truth(raw, w)) < 1e-5
    mixed = jax.jit(lambda r: fourstep_psd_partial_mixed(
        *dequant_iq_u16(r), jnp.ones((F,), jnp.float32)))
    assert _rel(mixed(raw.view(np.uint16)), _truth(raw)) < 1e-5
