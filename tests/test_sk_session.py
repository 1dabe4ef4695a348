"""--sk-file: the spectral-kurtosis sidecar as a session-level path.

The sidecar accumulates the second moment Σ|X|⁴ alongside the ordinary
PSD (Nita & Gary generalized SK) and writes per-bin SK to a separate
file; the averaged spectrum on stdout must be unchanged by it.
"""
import io

import numpy as np
import pytest

from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.exceptions import RPFexception
from rtl_power_fftw_tpu.models.kurtosis import (SkSessionStep, _sk_step,
                                                compute_sk)
from rtl_power_fftw_tpu.ops.spectral import PsdStep


def _direct_moments(raw_frames, N, window=None):
    """Float64 session-semantics moments: per valid frame, |FFT|² and its
    square, summed — the yardstick for both accumulators."""
    z = ((raw_frames[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw_frames[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float64)
    p = np.abs(np.fft.fft(z, axis=-1)) ** 2
    return p.sum(0), (p * p).sum(0)


def test_sk_step_matches_direct_float64():
    N, F = 64, 8
    step = SkSessionStep(N, F)
    assert step.fields == ("s1", "s2") and step.takes_u16
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, size=(2 * F + 5, 2 * N), dtype=np.uint8)
    s1 = np.zeros(N)
    s2 = np.zeros(N)
    for lo, hi in ((0, F), (F, 2 * F), (2 * F, 2 * F + 5)):
        batch = frames[lo:hi]
        nv = len(batch)
        padded = np.zeros((F, 2 * N), np.uint8)
        padded[:nv] = batch
        a, b = step(padded, nv)
        s1 += np.asarray(a, np.float64)
        s2 += np.asarray(b, np.float64)
    w1, w2 = _direct_moments(frames, N)
    np.testing.assert_allclose(s1, w1, rtol=1e-5)
    np.testing.assert_allclose(s2, w2, rtol=1e-5)


def test_sk_step_windowed_matches_direct():
    from rtl_power_fftw_tpu.auxdata import make_window
    N, F = 64, 8
    win = make_window("hann", N)
    step = SkSessionStep(N, F, window=win)
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    a, b = step(raw, F)
    w1, w2 = _direct_moments(raw, N, window=win)
    np.testing.assert_allclose(np.asarray(a, np.float64), w1, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(b, np.float64), w2, rtol=1e-5)


def test_sk_s1_bit_identical_to_plain_psd_step():
    """The sidecar must not change the averaged spectrum: on the same
    transform mode, s1 and the plain PsdStep partial are the SAME
    reduction over the SAME power array — bit-identical, not just
    close."""
    N, F = 64, 8
    sk = SkSessionStep(N, F, backend="xla")
    psd = PsdStep(N, F, backend="xla")
    rng = np.random.default_rng(13)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    s1, _ = sk(raw, 5)
    ref = psd(raw, 5)
    assert np.array_equal(np.asarray(s1), np.asarray(ref))


def test_sk_fourstep_mode_matches_xla_mode():
    """The matmul transform mode ("fourstep") is numerically
    interchangeable with the platform-FFT mode, pinned on CPU where both
    lower."""
    import jax.numpy as jnp
    N, F = 64, 8
    rng = np.random.default_rng(14)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    raw16 = raw.view(np.uint16)  # the steps take the host u16 lane view
    a1, b1 = _sk_step(N, F, False, "fourstep")(raw16, jnp.int32(F))
    a2, b2 = _sk_step(N, F, False, "xla")(raw16, jnp.int32(F))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), rtol=4e-5)


def test_compute_sk_statistics():
    """Gaussian bins → SK ≈ 1; a coherent constant tone → SK → 0;
    impulsive (on/off) power → SK > 1."""
    rng = np.random.default_rng(15)
    M, N = 4096, 8
    p = rng.chisquare(2, size=(M, N)) / 2.0      # unit-mean exponential
    p[:, 3] = 5.0                                 # coherent tone bin
    p[:, 5] = np.where(rng.random(M) < 0.05, 40.0, 1e-3)  # impulsive
    sk = compute_sk(p.sum(0), (p * p).sum(0), M)
    gauss = [i for i in range(N) if i not in (3, 5)]
    assert np.all(np.abs(sk[gauss] - 1.0) < 0.2)
    assert sk[3] < 0.05
    assert sk[5] > 5.0


def test_sk_cli_validation():
    for bad in (["--welch-overlap", "50"], ["--pfb-taps", "4"],
                ["--multitaper", "4"], ["--shard-transform"]):
        argv = ["-f", "100M", "-n", "64", "--sk-file", "sk.txt"] + bad
        with pytest.raises(RPFexception):
            parse_args(argv, stderr=io.StringIO())
    # Fused backends can't expose per-frame spectra: warn, don't fail.
    err = io.StringIO()
    p = parse_args(["-f", "100M", "--sk-file", "sk.txt",
                    "--fft-backend", "hybrid"], stderr=err)
    assert p.sk_file == "sk.txt"
    assert "per-frame" in err.getvalue()
    # A window is fine alongside the sidecar.
    p = parse_args(["-f", "100M", "--sk-file", "sk.txt",
                    "--window-function", "hann"], stderr=io.StringIO())
    assert p.sk_file == "sk.txt" and p.window_function == "hann"


def test_sk_session_e2e(tmp_path):
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "sk.txt"
    N, repeats = 32, 256
    args = ["-f", "100M", "-b", str(N), "-n", str(repeats),
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"]

    def mksrc():
        return SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0,
                               seed=1)

    rv, out, err, params = run(args + ["--sk-file", str(sk_path)], mksrc())
    assert int(rv) == 0
    assert f"Writing spectral kurtosis to {sk_path}" in err

    # 1) The averaged spectrum is unchanged by the sidecar.
    rv2, out2, _, _ = run(args, mksrc())
    assert int(rv2) == 0

    def parse_cols(text):
        rows = [l.split() for l in text.split("\n")
                if l and not l.startswith("#")]
        return (np.array([float(r[0]) for r in rows]),
                np.array([float(r[1]) for r in rows]))

    freqs, vals = parse_cols(out)
    freqs2, vals2 = parse_cols(out2)
    np.testing.assert_array_equal(freqs, freqs2)
    np.testing.assert_allclose(vals, vals2, rtol=1e-4)

    # 2) The sidecar file: same line shape, SK ≈ 1 off-tone, ≪ 1 on-tone.
    sk_text = sk_path.read_text()
    assert sk_text.startswith("# rtl-power-fftw spectral kurtosis\n")
    assert f"# Spectra accumulated: {repeats}\n" in sk_text
    skf, skv = parse_cols(sk_text)
    assert len(skf) == N
    np.testing.assert_array_equal(skf, freqs)
    tone_bin = int(np.argmax(vals))
    assert skv[tone_bin] < 0.5          # coherent tone drives SK → 0
    others = np.delete(skv, tone_bin)
    assert abs(np.median(others) - 1.0) < 0.25
    # Blank-line separators match the main writer (spectrum + set).
    assert sk_text.endswith("\n\n\n") or sk_text.endswith("\n\n")


def test_sk_session_single_spectrum_writes_no_block(tmp_path):
    """SK needs M ≥ 2 (the (M+1)/(M−1) estimator): a 1-spectrum
    acquisition writes no SK block — but the session still succeeds."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "sk1.txt"
    src = SyntheticSource(noise=5.0, seed=2)
    rv, out, err, _ = run(["-f", "100M", "-b", "32", "-n", "1",
                           "--source", "synthetic:noise=5,seed=2",
                           "--sk-file", str(sk_path)], src)
    assert int(rv) == 0
    assert "spectral kurtosis" not in sk_path.read_text()


def test_sk_excise_step_matches_direct():
    """With excise_sigma the step returns (s1, s2, s1_clean, kept);
    the gate reproduces the host-side formula exactly."""
    N, F, sigma = 64, 8, 3.0
    step = SkSessionStep(N, F, excise_sigma=sigma)
    assert step.fields == ("s1", "s2", "s1_clean", "kept")
    rng = np.random.default_rng(31)
    raw = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    s1, s2, s1c, kept = (np.asarray(a, np.float64) for a in step(raw, F))
    w1, w2 = _direct_moments(raw, N)
    np.testing.assert_allclose(s1, w1, rtol=1e-5)
    sk = compute_sk(w1, w2, F)
    keep = np.abs(sk - 1.0) <= sigma * 2.0 / np.sqrt(F)
    np.testing.assert_array_equal(kept, np.where(keep, float(F), 0.0))
    np.testing.assert_allclose(s1c, np.where(keep, w1, 0.0), rtol=1e-5)
    # M < 2 carries no SK information: everything is kept.
    s1b, _, s1cb, keptb = (np.asarray(a, np.float64)
                           for a in step(raw, 1))
    np.testing.assert_array_equal(keptb, np.ones(N))
    np.testing.assert_allclose(s1cb, s1b, rtol=1e-6)


def test_sk_excise_cli_validation():
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--sk-excise", "-1"],
                   stderr=io.StringIO())
    err = io.StringIO()
    p = parse_args(["-f", "100M", "--sk-excise", "3",
                    "--fft-backend", "fft4"], stderr=err)
    assert p.sk_excise == 3.0
    assert "--sk-excise" in err.getvalue()


def test_sk_excise_session_e2e_intermittent_rfi(tmp_path):
    """The headline use case: a strong tone present in ONE of four
    accumulation blocks is excised from the averaged spectrum (the
    excised value recovers the clean noise floor), while the unexcised
    run keeps the contamination. Off-tone bins are untouched."""
    from test_session_e2e import run

    N, F, blocks = 64, 64, 4
    repeats = F * blocks
    rng = np.random.default_rng(41)
    iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
    # Tone burst only inside block 1 (frames F..2F-1): bin 9.
    t = np.arange(N * F)
    burst = 40.0 * np.exp(2j * np.pi * 9 * t / N)
    lo = 2 * N * F
    iq[lo:lo + 2 * N * F:2] += burst.real
    iq[lo + 1:lo + 2 * N * F:2] += burst.imag
    path = tmp_path / "rfi.iq"
    path.write_bytes(np.clip(np.round(iq), 0, 255).astype(np.uint8)
                     .tobytes())

    from rtl_power_fftw_tpu.sources import FileSource
    stats_path = tmp_path / "stats.jsonl"
    base = ["-f", "100M", "-b", str(N), "-n", str(repeats),
            "--frames-per-step", str(F), "--source", f"file:{path}"]
    rv, out, err, _ = run(base + ["--sk-excise", "3",
                                  "--stats-json", str(stats_path)],
                          FileSource(str(path), use_native=False))
    assert int(rv) == 0
    assert "SK excision (3 sigma): kept" in err
    import json
    rec = json.loads(stats_path.read_text().splitlines()[0])
    assert 0.0 < rec["sk_kept_fraction"] < 1.0
    assert rec["sk_bins_fully_flagged"] == 0
    rv2, out2, _, _ = run(base, FileSource(str(path), use_native=False))
    assert int(rv2) == 0

    def vals(text):
        return np.array([float(l.split()[1]) for l in text.split("\n")
                         if l and not l.startswith("#")])
    v_ex, v_raw = vals(out), vals(out2)
    tone_bin = int(np.argmax(v_raw))
    # Unexcised keeps the burst (>> floor); excised recovers the floor.
    floor = np.median(v_raw)
    assert v_raw[tone_bin] > floor + 10.0       # dB
    assert v_ex[tone_bin] < floor + 1.0
    # Bins untouched by the burst agree between the two runs.
    quiet = np.abs(v_raw - floor) < 1.0
    np.testing.assert_allclose(v_ex[quiet], v_raw[quiet], atol=0.2)


def test_sk_excise_persistent_tone_falls_back(tmp_path):
    """A tone present in EVERY block cannot be excised (kept == 0):
    the bin falls back to the unexcised average and the summary says
    so."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    # Block size M=64 puts the tone's SK≈0 well outside the 3-sigma
    # null band (3·2/√64 = 0.75 < 1).
    args = ["-f", "100M", "-b", "32", "-n", "256",
            "--frames-per-step", "64",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=5"]

    def mksrc():
        return SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0,
                               seed=5)

    rv, out, err, _ = run(args + ["--sk-excise", "3"], mksrc())
    rv2, out2, _, _ = run(args, mksrc())
    assert int(rv) == 0 and int(rv2) == 0
    import re
    m = re.search(r"(\d+) of 32 bins fully flagged", err)
    assert m and int(m.group(1)) >= 1

    def vals(text):
        return np.array([float(l.split()[1]) for l in text.split("\n")
                         if l and not l.startswith("#")])
    v_ex, v_raw = vals(out), vals(out2)
    tone_bin = int(np.argmax(v_raw))
    np.testing.assert_allclose(v_ex[tone_bin], v_raw[tone_bin], atol=1e-6)


def test_sk_excise_with_sidecar(tmp_path):
    """--sk-excise and --sk-file together: the sidecar still reports SK
    from the FULL moments while the spectrum is excised."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "both.txt"
    src = SyntheticSource(noise=5.0, seed=6)
    rv, out, err, _ = run(
        ["-f", "100M", "-b", "32", "-n", "64",
         "--source", "synthetic:noise=5,seed=6",
         "--sk-excise", "4", "--sk-file", str(sk_path)], src)
    assert int(rv) == 0
    sk_text = sk_path.read_text()
    assert "# Spectra accumulated: 64\n" in sk_text
    assert "SK excision (4 sigma)" in err


def test_sharded_sk_matches_per_stream_session_steps():
    """--streams + --sk-file: the psum-combined moments equal running
    SkSessionStep per stream and summing (both moments commute with any
    partition of the frames)."""
    from rtl_power_fftw_tpu.models.kurtosis import ShardedSkStep
    from rtl_power_fftw_tpu.parallel import make_mesh

    S, N, F = 8, 64, 8
    mesh = make_mesh(8)
    step = ShardedSkStep(mesh, N, F, streams=S)
    assert step.fields == ("s1", "s2") and step.takes_u16
    single = SkSessionStep(N, F)
    rng = np.random.default_rng(21)
    nvals = np.array([F, 3, 0, 5, F, F, 1, 7], np.int32)
    raw = np.zeros((S, F, 2 * N), np.uint8)
    for s in range(S):
        raw[s, :nvals[s]] = rng.integers(
            0, 256, (nvals[s], 2 * N), dtype=np.uint8)
    ps, comb = step(raw, nvals)
    singles = [single(raw[s], int(nvals[s])) for s in range(S)]
    w1 = np.stack([np.asarray(a, np.float64) for a, _ in singles])
    w2 = np.stack([np.asarray(b, np.float64) for _, b in singles])
    np.testing.assert_allclose(np.asarray(ps, np.float64), w1, rtol=1e-6)
    comb = np.asarray(comb, np.float64)
    assert comb.shape == (2, N)
    np.testing.assert_allclose(comb[0], w1.sum(0), rtol=1e-6)
    np.testing.assert_allclose(comb[1], w2.sum(0), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        ShardedSkStep(mesh, N, F, streams=6)


def test_multistream_sk_session_e2e(tmp_path):
    """--streams 8 --sk-file: one SK block with M = S·repeats, tone bin
    flagged, averaged spectrum still the psum-combined PSD."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "skms.txt"
    src = SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0, seed=0)
    rv, out, err, _ = run(
        ["-f", "100M", "-b", "32", "-n", "32", "--streams", "8",
         "--source", "synthetic:tone=100.2M/35,noise=6,seed=0",
         "--sk-file", str(sk_path)], src)
    assert int(rv) == 0
    assert "Parallel streams: 8 (mesh size 8)" in err
    sk_text = sk_path.read_text()
    assert "# Spectra accumulated: 256\n" in sk_text  # 8 x 32
    rows = [l.split() for l in sk_text.split("\n")
            if l and not l.startswith("#")]
    skv = np.array([float(r[1]) for r in rows])
    vals = np.array([float(l.split()[1]) for l in out.split("\n")
                     if l and not l.startswith("#")])
    tone_bin = int(np.argmax(vals))
    assert skv[tone_bin] < 0.5
    assert abs(np.median(np.delete(skv, tone_bin)) - 1.0) < 0.25


def test_sharded_sk_excise_matches_per_stream_session_steps():
    """--streams + --sk-excise: each stream's block gates itself with
    its own M before the psum — the combined (4, N) stack equals the
    per-stream SkSessionStep(excise) fields summed."""
    from rtl_power_fftw_tpu.models.kurtosis import ShardedSkStep
    from rtl_power_fftw_tpu.parallel import make_mesh

    S, N, F, sigma = 8, 64, 8, 3.0
    mesh = make_mesh(8)
    step = ShardedSkStep(mesh, N, F, streams=S, excise_sigma=sigma)
    assert step.fields == ("s1", "s2", "s1_clean", "kept")
    single = SkSessionStep(N, F, excise_sigma=sigma)
    rng = np.random.default_rng(51)
    nvals = np.array([F, 3, 0, 5, F, F, 1, 7], np.int32)
    raw = np.zeros((S, F, 2 * N), np.uint8)
    for s in range(S):
        raw[s, :nvals[s]] = rng.integers(
            0, 256, (nvals[s], 2 * N), dtype=np.uint8)
    ps, comb = step(raw, nvals)
    comb = np.asarray(comb, np.float64)
    assert comb.shape == (4, N)
    want = np.zeros((4, N))
    for s in range(S):
        for i, a in enumerate(single(raw[s], int(nvals[s]))):
            want[i] += np.asarray(a, np.float64)
    np.testing.assert_allclose(comb[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(comb[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(comb[2], want[2], rtol=1e-6)
    np.testing.assert_array_equal(comb[3], want[3])


def test_multistream_sk_excise_session_e2e(tmp_path):
    """--streams 8 --sk-excise over a recording with a burst: every
    stream replays the same file, each excises its own contaminated
    blocks, and the combined spectrum recovers the clean floor."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import FileSource

    N, F, blocks = 64, 64, 4
    repeats = F * blocks
    rng = np.random.default_rng(61)
    iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
    t = np.arange(N * F)
    burst = 40.0 * np.exp(2j * np.pi * 13 * t / N)
    lo = 2 * N * F * 2  # block 2 only
    iq[lo:lo + 2 * N * F:2] += burst.real
    iq[lo + 1:lo + 2 * N * F:2] += burst.imag
    path = tmp_path / "msrfi.iq"
    path.write_bytes(np.clip(np.round(iq), 0, 255).astype(np.uint8)
                     .tobytes())

    base = ["-f", "100M", "-b", str(N), "-n", str(repeats),
            "--streams", "8", "--frames-per-step", str(F),
            "--source", f"file:{path}"]
    rv, out, err, _ = run(base + ["--sk-excise", "3"],
                          FileSource(str(path), use_native=False))
    assert int(rv) == 0
    assert "Parallel streams: 8 (mesh size 8)" in err
    assert "SK excision (3 sigma): kept" in err
    rv2, out2, _, _ = run(base, FileSource(str(path), use_native=False))
    assert int(rv2) == 0

    def vals(text):
        return np.array([float(l.split()[1]) for l in text.split("\n")
                         if l and not l.startswith("#")])
    v_ex, v_raw = vals(out), vals(out2)
    tone_bin = int(np.argmax(v_raw))
    floor = np.median(v_raw)
    assert v_raw[tone_bin] > floor + 10.0
    assert v_ex[tone_bin] < floor + 1.0


def test_sharded_sk_honors_explicit_backend():
    from rtl_power_fftw_tpu.models.kurtosis import ShardedSkStep
    from rtl_power_fftw_tpu.parallel import make_mesh
    step = ShardedSkStep(make_mesh(8), 64, 8, streams=8, backend="matmul")
    assert step.path == "matmul"


def test_sk_stream_closed_on_setup_failure(tmp_path):
    """--sk-file + a later open failing in session setup must not leak
    the sidecar fd (library callers)."""
    import io
    import os
    from rtl_power_fftw_tpu.auxdata import AuxData
    from rtl_power_fftw_tpu.config import parse_args
    from rtl_power_fftw_tpu.session import run_session
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "leak.sk"
    params = parse_args(
        ["-f", "100M", "-b", "32", "-n", "4",
         "--source", "synthetic:noise=5,seed=7",
         "--sk-file", str(sk_path),
         "--record", str(tmp_path / "no" / "such" / "dir" / "x.bin")],
        stderr=io.StringIO())
    aux = AuxData(params, stderr=io.StringIO())
    fds_before = len(os.listdir("/proc/self/fd"))
    with pytest.raises(RPFexception):
        run_session(params, SyntheticSource(noise=5.0, seed=7), aux,
                    stdout=io.StringIO(), stderr=io.StringIO(),
                    install_sigint=False)
    assert len(os.listdir("/proc/self/fd")) == fds_before
    assert sk_path.exists()  # truncated, but not leaked


def test_sk_session_multi_hop(tmp_path):
    """Frequency scans write one SK block per hop, in hop order."""
    from test_session_e2e import run
    from rtl_power_fftw_tpu.sources import SyntheticSource

    sk_path = tmp_path / "skhop.txt"
    src = SyntheticSource(noise=5.0, seed=3)
    rv, out, err, _ = run(["-f", "100M:104M", "-b", "32", "-n", "16",
                           "--source", "synthetic:noise=5,seed=3",
                           "--sk-file", str(sk_path)], src)
    assert int(rv) == 0
    sk_text = sk_path.read_text()
    n_blocks = sk_text.count("# rtl-power-fftw spectral kurtosis")
    n_main = out.count("# rtl-power-fftw output")
    assert n_blocks == n_main and n_blocks >= 2
