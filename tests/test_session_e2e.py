"""End-to-end session tests: the full pipeline from IQ source to formatted
output, exercising hop lists, fault paths, matrix mode, and interrupts."""

import io
import math
import os

import numpy as np
import pytest

import rtl_power_fftw_tpu.interrupts as interrupts
from rtl_power_fftw_tpu.auxdata import AuxData
from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.exceptions import ReturnValue, RPFexception
from rtl_power_fftw_tpu.output.matrix import read_matrix
from rtl_power_fftw_tpu.session import run_session
from rtl_power_fftw_tpu.sources import SyntheticSource

from golden import golden_accumulate, golden_finalize


@pytest.fixture(autouse=True)
def _reset_interrupts():
    interrupts.reset()
    yield
    interrupts.reset()


def parse(argv):
    return parse_args(argv, stderr=io.StringIO())


def run(argv, source, stdin=None):
    params = parse(argv)
    aux = AuxData(params, stdin=stdin, stderr=io.StringIO())
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, source, aux, stdout=out, stderr=err,
                     install_sigint=False)
    return rv, out.getvalue(), err.getvalue(), params


def test_basic_session_output_structure():
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=1)
    rv, out, err, params = run(["-f", "100M", "-n", "32", "-b", "128",
                                "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    lines = out.split("\n")
    assert lines[0] == "# rtl-power-fftw output"
    data_lines = [l for l in lines if l and not l.startswith("#")]
    assert len(data_lines) == 128
    # Ends with spectrum blank + set blank + final newline split artifact.
    assert out.endswith("\n\n\n") or out.endswith("\n\n")
    assert "Device tuned to: 100000000 Hz" in err
    assert "Buffer queue histogram:" in err


def test_session_matches_golden_numerics():
    """Full session vs golden float64 pipeline on the same byte stream."""
    N, repeats, rate = 256, 50, 2_048_000
    seed = 77
    src = SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0, seed=seed)
    rv, out, err, params = run(
        ["-f", "100M", "-n", str(repeats), "-b", str(N), "-r", str(rate),
         "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success

    # Regenerate the identical stream (deterministic source).
    src2 = SyntheticSource(tones=[(100_200_000, 35.0)], noise=6.0, seed=seed)
    src2.set_sample_rate(rate)
    try:
        src2.set_frequency(params.cfreq)
    except RPFexception:
        pass
    src2.set_frequency(100_000_000)
    stream, _ = src2.read(2 * N * repeats)
    pwr, done = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr, done, rate)

    got = np.array([float(l.split()[1]) for l in out.split("\n")
                    if l and not l.startswith("#")])
    # Text output has 6 significant digits; compare at that precision.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_frequency_scan_hops_and_stitching():
    rate = 2_048_000
    src = SyntheticSource(noise=5.0, seed=2)
    rv, out, err, params = run(
        ["-f", "100M:104M", "-n", "16", "-b", "64", "-r", str(rate),
         "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    spectra = [s for s in out.split("\n\n") if "frequency" in s or
               any(l and not l.startswith("#") for l in s.split("\n"))]
    span = 104_000_000 - 100_000_000
    hops = math.ceil(span / rate)
    headers = out.count("# rtl-power-fftw output")
    assert headers == hops == 2
    # First hop center per the reference formula.
    assert f"Device tuned to: {int(100_000_000 + rate / 2.0)} Hz" in err


def test_tune_error_drops_frequency():
    rate = 2_048_000
    # Kill the second hop's frequency.
    start = 100_000_000
    hop2 = int(start + rate / 2.0) + rate - _overhang(rate, 6_000_000, 3)
    src = SyntheticSource(noise=5.0, seed=3, dead_freqs=[hop2])
    rv, out, err, params = run(
        ["-f", "100M:106M", "-n", "8", "-b", "64", "-r", str(rate),
         "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    assert f"Unable to tune to {hop2}. Dropping from frequency list." in err
    assert out.count("# rtl-power-fftw output") == 2  # 3 hops − 1 dropped


def _overhang(rate, span, hops):
    return (hops * rate - span) // (hops - 1)


def test_all_frequencies_dead_is_acquisition_error():
    rate = 2_048_000
    src = SyntheticSource(noise=5.0, dead_freqs=[100_000_000])
    params = parse(["-f", "100M", "-n", "8", "-b", "64",
                    "--source", "synthetic:"])
    aux = AuxData(params, stderr=io.StringIO())
    with pytest.raises(RPFexception) as e:
        run_session(params, src, aux, stdout=io.StringIO(),
                    stderr=io.StringIO(), install_sigint=False)
    assert e.value.retval == ReturnValue.AcquisitionError


def test_flaky_tune_retries_succeed():
    # 3 transient failures: the session's throwaway pre-tune consumes one
    # (rtl_power_fftw.cxx:84-91), the retry loop eats two and succeeds on
    # its third try.
    src = SyntheticSource(noise=5.0, seed=4, flaky_freqs={100_000_000: 3})
    rv, out, err, params = run(["-f", "100M", "-n", "8", "-b", "64",
                                "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    assert "Tuning to 100000000 Hz (try 3)" in err


def test_dropped_samples_are_retried():
    src = SyntheticSource(noise=5.0, seed=5, drop_every=2)
    # Explicit -s pins the buffer size so the measurement needs 4 reads;
    # every 2nd read reports dropped samples and must be retried.
    rv, out, err, params = run(["-f", "100M", "-n", "512", "-b", "64",
                                "-s", "16384", "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    assert "Error: dropped samples." in err
    assert "Actual number of averaged spectra: 512" in err


def test_matrix_mode_files(tmp_path):
    rate = 2_048_000
    base = str(tmp_path / "scan")
    src = SyntheticSource(tones=[(100_100_000, 30.0)], noise=5.0, seed=6)
    rv, out, err, params = run(
        ["-f", "100M:104M", "-n", "16", "-b", "64", "-r", str(rate),
         "-m", base, "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    data, meta = read_matrix(base + ".bin", base + ".met")
    assert meta["cols"] == "128"  # 2 hops × 64 bins
    assert meta["rows"] == "1"
    assert data.shape == (1, 128)
    assert int(meta["stepFreq"]) == rate // 64
    # startFreq/endFreq per rtl_power_fftw.cxx:155-163.
    first_hop = int(100_000_000 + rate / 2.0)
    assert int(meta["startFreq"]) == int(first_hop + (0 - 32.0) * rate / 64)
    # Text-mode spectra must NOT be on stdout in matrix mode, but the set
    # separator blank line is (rtl_power_fftw.cxx:184-194).
    assert "# rtl-power-fftw output" not in out


def test_quiet_mode_prints_once():
    src = SyntheticSource(noise=5.0, seed=8)
    params = parse(["-f", "100M", "-n", "4", "-b", "64", "-e", "0.001",
                    "-q", "--source", "synthetic:"])
    aux = AuxData(params, stderr=io.StringIO())
    out, err = io.StringIO(), io.StringIO()
    run_session(params, src, aux, stdout=out, stderr=err, install_sigint=False)
    # Session duration path: at least one pass, summaries only once.
    assert err.getvalue().count("Device tuned to:") == 1


def test_integration_time_path():
    rate = 100_000
    src = SyntheticSource(noise=5.0, seed=9)
    rv, out, err, params = run(
        ["-f", "1M", "-t", "0.1", "-b", "100", "-r", str(rate),
         "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    assert params.repeats == math.ceil(rate * 0.1 / 100)
    assert f"Actual number of averaged spectra: {params.repeats}" in err


def test_finish_pass_interrupt_stops_endless():
    src = SyntheticSource(noise=5.0, seed=10)
    params = parse(["-f", "1M", "-n", "4", "-b", "64", "-c",
                    "--source", "synthetic:"])
    aux = AuxData(params, stderr=io.StringIO())
    interrupts.raise_interrupt()  # first SIGINT → finish this pass then stop
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, src, aux, stdout=out, stderr=err,
                     install_sigint=False)
    assert rv == ReturnValue.Success
    assert "Interrupted, will try to finish this pass." in err.getvalue()
    assert out.getvalue().count("# rtl-power-fftw output") == 1


def test_finish_now_interrupt_breaks_hop_loop():
    src = SyntheticSource(noise=5.0, seed=11)
    params = parse(["-f", "100M:110M", "-n", "4", "-b", "64",
                    "--source", "synthetic:"])
    aux = AuxData(params, stderr=io.StringIO())
    interrupts.raise_interrupt()
    interrupts.raise_interrupt()  # second SIGINT → stop ASAP
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, src, aux, stdout=out, stderr=err,
                     install_sigint=False)
    assert rv == ReturnValue.Success
    assert "Interrupted, finishing now." in err.getvalue()
    # Only the first hop got written before the break.
    assert out.getvalue().count("# rtl-power-fftw output") == 1


def test_welch_overlap_extension():
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=12)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "31", "-b", "128", "--welch-overlap", "50",
         "--window-function", "hann", "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    assert "Actual number of averaged spectra: 31" in err


def test_cli_main_no_device_exit_code():
    from rtl_power_fftw_tpu.cli import main
    assert main(["-n", "1"]) == 1  # NoDeviceFound


def test_cli_main_bad_arg_exit_code():
    from rtl_power_fftw_tpu.cli import main
    assert main(["--bogus"]) == 4
    assert main(["-b", "-5"]) == 3


def test_multistream_session():
    """--streams 8: psum-reduced average across parallel synthetic streams."""
    src = SyntheticSource(tones=[(100_100_000, 30.0)], noise=5.0, seed=0)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "16", "-b", "64", "--streams", "8",
         "--source", "synthetic:tone=100.1M/30,noise=5,seed=0"], src)
    assert rv == ReturnValue.Success
    assert "Parallel streams: 8 (mesh size 8)" in err
    assert "Actual number of averaged spectra: 128" in err  # 8 x 16
    # Spectrum is a proper average (tone visible at the same bin as 1-stream).
    vals = np.array([float(l.split()[1]) for l in out.split("\n")
                     if l and not l.startswith("#")])
    freqs = np.array([float(l.split()[0]) for l in out.split("\n")
                      if l and not l.startswith("#")])
    assert abs(freqs[vals.argmax()] - 100_100_000) < 2_048_000 / 64


class _SlowSource(SyntheticSource):
    """Source that takes real time per read — exercises --strict-time."""

    def __init__(self, delay, **kw):
        super().__init__(**kw)
        self.delay = delay

    def read(self, nbytes):
        import time
        time.sleep(self.delay)
        return super().read(nbytes)


def test_strict_time_cuts_acquisition_short():
    """-T ends acquisition at the deadline even with samples missing
    (acquisition.cxx:326-327, doc INTEGRATION TIME)."""
    src = _SlowSource(0.2, noise=5.0, seed=40)
    # 1 s of data at 16384-byte buffers = many reads of 0.2 s each; the
    # 0.5 s strict deadline fires long before the data target.
    rv, out, err, params = run(
        ["-f", "1M", "-t", "0.5", "-T", "-b", "64", "-r", "1000000",
         "-s", "16384", "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    done = int([l for l in err.split("\n")
                if "Actual number of averaged spectra:" in l][0].split()[-1])
    assert 0 < done < params.repeats  # cut short, but wrote what it had
    assert "# rtl-power-fftw output" in out


def test_output_frequency_format_matches_manpage_style():
    """Man-page example format: '1.41940575e+09 -68.7714'
    (doc/rtl_power_fftw.1.md:94-99)."""
    import re
    src = SyntheticSource(noise=5.0, seed=41)
    rv, out, err, params = run(
        ["-f", "1420405752", "-n", "8", "-b", "512", "-r", "2048000",
         "--source", "synthetic:"], src)
    data_lines = [l for l in out.split("\n") if l and not l.startswith("#")]
    # Frequencies near 1.42 GHz at 9 significant digits, scientific form.
    assert re.match(r"^1\.4\d{7}e\+09 -?\d+\.?\d*$", data_lines[0]), data_lines[0]
    # Power column: 6 significant digits max.
    for l in data_lines[:20]:
        pwr = l.split()[1].replace("-", "").replace(".", "").lstrip("0")
        assert len(pwr) <= 6


def test_multistream_matrix_mode(tmp_path):
    """--streams with -m: matrix row is the psum-combined average."""
    base = str(tmp_path / "ms")
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=70)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "8", "-b", "64", "--streams", "8",
         "-m", base, "--source", "synthetic:tone=100.05M/30,noise=5,seed=70"],
        src)
    assert rv == ReturnValue.Success
    from rtl_power_fftw_tpu.output.matrix import read_matrix
    data, meta = read_matrix(base + ".bin", base + ".met")
    assert data.shape == (1, 64)
    assert meta["rows"] == "1" and meta["cols"] == "64"
    # Effective integration time reflects the combined 64 spectra.
    assert float(meta["effIntegrationTime"]) == pytest.approx(
        64.0 * 64 / 2_000_000, rel=1e-6)


def test_all_zero_signal_produces_inf_db_like_cxx():
    """A perfectly zero signal (u8 all 127) gives pwr=0 -> 10*log10(0) =
    -inf; C++ iostreams print '-inf' and so do we (no crash, no NaN)."""
    src = SyntheticSource(noise=0.0, seed=0)  # tones absent, offset 127
    rv, out, err, params = run(["-f", "1M", "-n", "4", "-b", "64",
                                "--source", "synthetic:noise=0"], src)
    assert rv == ReturnValue.Success
    vals = [l.split()[1] for l in out.split("\n")
            if l and not l.startswith("#")]
    assert len(vals) == 64
    assert all(v == "-inf" for v in vals), vals[:5]


def _write_iq_file(path, nbytes, seed=0):
    rng = np.random.default_rng(seed)
    path.write_bytes(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())


def test_eof_finishes_partial_spectrum(tmp_path):
    """A recording shorter than the session's demand ends the session
    gracefully with the partial average written (reference strict-time
    partial semantics, acquisition.cxx:326-331,350-358) — not exit 6."""
    p = tmp_path / "short.iq"
    N, have_frames = 64, 37
    _write_iq_file(p, have_frames * 2 * N + 50, seed=5)
    src = None
    from rtl_power_fftw_tpu.sources import FileSource
    src = FileSource(str(p), use_native=False)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "100", "-b", str(N), "--source", f"file:{p}"],
        src)
    assert rv == ReturnValue.Success
    assert "End of input stream" in err
    assert f"Actual number of averaged spectra: {have_frames}" in err
    data_lines = [l for l in out.split("\n") if l and not l.startswith("#")]
    assert len(data_lines) == N  # one full spectrum was still produced


def test_eof_endless_still_terminates(tmp_path):
    """--endless cannot out-loop a finite recording: the session ends after
    the stream runs dry instead of spinning on empty acquisitions."""
    p = tmp_path / "short.iq"
    _write_iq_file(p, 10 * 2 * 64, seed=6)
    from rtl_power_fftw_tpu.sources import FileSource
    src = FileSource(str(p), use_native=False)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "4", "-b", "64", "-c",
         "--source", f"file:{p}"], src)
    assert rv == ReturnValue.Success
    assert "End of input stream" in err


def test_eof_before_any_spectrum_is_error(tmp_path):
    """A stream too short for even one frame is an input error."""
    p = tmp_path / "tiny.iq"
    p.write_bytes(bytes(10))
    from rtl_power_fftw_tpu.sources import FileSource
    src = FileSource(str(p), use_native=False)
    params = parse(["-f", "100M", "-n", "4", "-b", "64",
                    "--source", f"file:{p}"])
    aux = AuxData(params, stderr=io.StringIO())
    with pytest.raises(RPFexception) as e:
        run_session(params, src, aux, stdout=io.StringIO(),
                    stderr=io.StringIO(), install_sigint=False)
    assert e.value.retval == ReturnValue.AcquisitionError


def test_welch_reads_only_unique_bytes():
    """With --welch-overlap, the producer reads hop-scaled bytes (not
    2*N*repeats) and the summary reports unique-sample integration time."""
    N, repeats, rate = 64, 40, 2_048_000
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=9)
    rv, out, err, params = run(
        ["-f", "100M", "-n", str(repeats), "-b", str(N), "-r", str(rate),
         "--welch-overlap", "50", "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    hop = N // 2
    unique = hop * (repeats - 1) + N
    assert f"Actual number of (complex) samples collected: {unique}" in err
    eff = unique / rate
    assert f"Effective integration time: {eff:g} seconds" in err
    assert f"Actual number of averaged spectra: {repeats}" in err


def test_multistream_summary_counters_truthful(tmp_path):
    """--streams mode reports real readout counters and queue diagnostics
    (they were hardcoded to 0 / always-zero in round 1)."""
    stats = str(tmp_path / "stats.jsonl")
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=70)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "16", "-b", "64", "--streams", "4",
         "--stats-json", stats,
         "--source", "synthetic:tone=100.05M/30,noise=5,seed=70"], src)
    assert rv == ReturnValue.Success
    import json
    rec = json.loads(open(stats).readline())
    assert rec["device_readouts"] > 0
    assert rec["successful_readouts"] > 0
    assert sum(rec["queue_histogram"]) > 0
    assert "Actual number of device readouts: 0" not in err
    m = [l for l in err.split("\n")
         if l.startswith("Actual number of device readouts:")]
    assert m and int(m[0].split(":")[1]) > 0
    # Observability: the sharded step's selected ladder rung is recorded.
    assert rec["transform_path"] in ("hybrid", "fourstep",
                                     "fft4", "xla")


def test_transform_path_surfaced(tmp_path):
    """The selected auto-ladder rung is printed in the verbose banner and
    recorded per scan in --stats-json (observability extension; the
    reference has one fixed FFTW path, datastore.cxx:30-33)."""
    stats = str(tmp_path / "stats.jsonl")
    src = SyntheticSource(tones=[(100_050_000, 30.0)], noise=5.0, seed=7)
    rv, out, err, params = run(
        ["-f", "100M", "-n", "8", "-b", "512", "--stats-json", stats,
         "--source", "synthetic:"], src)
    assert rv == ReturnValue.Success
    line = [l for l in err.split("\n") if l.startswith("Transform path:")]
    assert line, err
    import json
    rec = json.loads(open(stats).readline())
    assert rec["transform_path"] in ("hybrid", "fourstep",
                                     "fft4", "bigfft", "xla")
    assert rec["transform_path"] in line[0]


def test_multistream_welch_overlap_integration_time():
    """--streams with --welch-overlap: per-stream hop pacing, truthful
    unique-sample integration time (hop*(r_s-1)+N summed over streams)."""
    src = SyntheticSource(noise=5.0, seed=71)
    rv, out, err, params = run(
        ["-f", "1M", "-n", "12", "-b", "64", "--streams", "4",
         "--welch-overlap", "50",
         "--source", "synthetic:noise=5,seed=71"], src)
    assert rv == ReturnValue.Success
    done = int([l for l in err.split("\n")
                if "Actual number of averaged spectra:" in l][0].split()[-1])
    assert done == 4 * params.repeats        # every stream met its quota
    samples = int([l for l in err.split("\n")
                   if "samples collected:" in l][0].split()[-1])
    hop = 32                                 # N=64, 50% overlap
    assert samples == 4 * (hop * (params.repeats - 1) + 64)
    eff = float([l for l in err.split("\n")
                 if "Effective integration time:" in l][0].split()[-2])
    assert eff == pytest.approx(samples / 2_000_000, rel=1e-6)


def test_shard_transform_session_matches_default():
    """--shard-transform: the distributed four-step transform (one FFT
    sharded over the 8-device mesh, parallel/bigfft.py) produces the
    same averaged spectrum as the default per-device path."""
    args = ["-f", "1M", "-n", "16", "-b", "1024",
            "--source", "synthetic:tone=1.1M/30,noise=5,seed=80"]
    src1 = SyntheticSource(tones=[(1_100_000, 30.0)], noise=5.0, seed=80)
    rv1, out1, err1, _ = run(args, src1)
    src2 = SyntheticSource(tones=[(1_100_000, 30.0)], noise=5.0, seed=80)
    rv2, out2, err2, _ = run(args + ["--shard-transform"], src2)
    assert rv1 == ReturnValue.Success and rv2 == ReturnValue.Success

    def vals(out):
        return np.array([float(l.split()[1]) for l in out.split("\n")
                         if l and not l.startswith("#")])
    v1, v2 = vals(out1), vals(out2)
    assert v1.shape == v2.shape == (1024,)
    # Same spectrum within the f32-transform budget (different transform
    # algorithms: batched four-step matmuls vs distributed FFT).
    np.testing.assert_allclose(v2, v1, rtol=0, atol=2e-4)  # dB values
    assert int(np.argmax(v1)) == int(np.argmax(v2))


def test_shard_transform_with_streams_grid_session(tmp_path):
    """--streams S --shard-transform selects the 2-D grid composition
    (parallel/grid.py: one mesh row per stream, transforms
    sequence-sharded within rows) and matches the plain --streams
    session's spectrum. Round-3 change: the flags used to be mutually
    exclusive; the composition gave the combination real semantics."""
    stats = str(tmp_path / "grid_stats.jsonl")
    args = ["-f", "1M", "-n", "16", "-b", "256", "--streams", "4",
            "--source", "synthetic:tone=1.05M/30,noise=5,seed=81"]
    src1 = SyntheticSource(tones=[(1_050_000, 30.0)], noise=5.0, seed=81)
    rv1, out1, err1, _ = run(args, src1)
    src2 = SyntheticSource(tones=[(1_050_000, 30.0)], noise=5.0, seed=81)
    rv2, out2, err2, _ = run(args + ["--shard-transform",
                                     "--stats-json", stats], src2)
    assert rv1 == ReturnValue.Success and rv2 == ReturnValue.Success

    def vals(out):
        return np.array([float(l.split()[1]) for l in out.split("\n")
                         if l and not l.startswith("#")])
    v1, v2 = vals(out1), vals(out2)
    assert v1.shape == v2.shape == (256,)
    np.testing.assert_allclose(v2, v1, rtol=0, atol=2e-4)  # dB values
    assert int(np.argmax(v1)) == int(np.argmax(v2))
    import json
    rec = json.loads(open(stats).readline())
    assert rec["transform_path"] == "bigfft-grid"


def test_shard_transform_streams_bad_n_typed_exit():
    """Non-pow-2 bins with the grid combination exits 3 (typed CLI
    error), not a traceback."""
    with pytest.raises(RPFexception) as ei:
        parse_args(["-f", "1M", "-b", "500", "--shard-transform",
                    "--streams", "4"], stderr=io.StringIO())
    assert ei.value.return_value == ReturnValue.InvalidArgument


def test_shard_transform_requires_pow2_bins():
    with pytest.raises(RPFexception):
        parse_args(["-f", "1M", "-b", "500", "--shard-transform"],
                   stderr=io.StringIO())


def test_record_replay_identical(tmp_path):
    """--record captures the consumed raw IQ; replaying the file through
    --source file: reproduces the spectrum byte-for-byte."""
    rec = str(tmp_path / "cap.iq")
    args = ["-f", "2M", "-n", "20", "-b", "128"]
    src = SyntheticSource(tones=[(2_040_000, 25.0)], noise=6.0, seed=90)
    rv1, out1, err1, params = run(
        args + ["--record", rec,
                "--source", "synthetic:tone=2.04M/25,noise=6,seed=90"], src)
    assert rv1 == ReturnValue.Success
    assert os.path.getsize(rec) >= 2 * 128 * params.repeats

    from rtl_power_fftw_tpu.sources import FileSource
    replay = FileSource(rec)
    rv2, out2, err2, _ = run(args + ["--source", f"file:{rec}"], replay)
    assert rv2 == ReturnValue.Success

    def data(out):
        return [l for l in out.split("\n") if l and not l.startswith("#")]
    assert data(out1) == data(out2)


def test_record_multistream_per_stream_files(tmp_path):
    rec = str(tmp_path / "cap.iq")
    src = SyntheticSource(noise=5.0, seed=91)
    rv, out, err, params = run(
        ["-f", "1M", "-n", "8", "-b", "64", "--streams", "2",
         "--record", rec, "--source", "synthetic:noise=5,seed=91"], src)
    assert rv == ReturnValue.Success
    for i in range(2):
        assert os.path.getsize(f"{rec}.s{i}") >= 2 * 64 * params.repeats


def test_shard_transform_with_welch_overlap():
    """--shard-transform composes with --welch-overlap (the slicer hands
    out strided overlapped frame views; prepare() must copy them)."""
    args = ["-f", "1M", "-n", "12", "-b", "1024", "--welch-overlap", "50",
            "--source", "synthetic:tone=1.1M/28,noise=5,seed=82"]
    src1 = SyntheticSource(tones=[(1_100_000, 28.0)], noise=5.0, seed=82)
    rv1, out1, err1, _ = run(args, src1)
    src2 = SyntheticSource(tones=[(1_100_000, 28.0)], noise=5.0, seed=82)
    rv2, out2, err2, _ = run(args + ["--shard-transform"], src2)
    assert rv1 == ReturnValue.Success and rv2 == ReturnValue.Success

    def vals(out):
        return np.array([float(l.split()[1]) for l in out.split("\n")
                         if l and not l.startswith("#")])
    v1, v2 = vals(out1), vals(out2)
    np.testing.assert_allclose(v2, v1, rtol=0, atol=2e-4)


def test_stitch_out_live_file(tmp_path):
    """--stitch-out maintains a merged wideband spectrum refreshed per
    pass; content matches stitching the session's own text output."""
    sf = str(tmp_path / "wide.dat")
    src = SyntheticSource(tones=[(103_700_000, 35.0)], noise=5.0, seed=95)
    rv, out, err, params = run(
        ["-f", "100M:105M", "-n", "12", "-b", "128", "-o", "30",
         "--stitch-out", sf,
         "--source", "synthetic:tone=103.7M/35,noise=5,seed=95"], src)
    assert rv == ReturnValue.Success
    import io as _io
    from rtl_power_fftw_tpu.utils.stitch import merge_spectra, parse_text
    want_f, want_v = merge_spectra(parse_text(_io.StringIO(out))[0])
    lines = [l.split() for l in open(sf) if l.strip()
             and not l.startswith("#")]
    got_f = np.array([float(a) for a, _ in lines])
    got_v = np.array([float(b) for _, b in lines])
    assert len(got_f) == len(want_f)
    # The live file carries exact float64 bin frequencies; the text
    # round trip reconstructs them from 6-7 significant digits (~1e-6).
    np.testing.assert_allclose(got_f, want_f, rtol=1e-6)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)
    # The tone lands at its absolute RF in the merged spectrum.
    assert abs(got_f[np.argmax(got_v)] - 103_700_000) < 2_048_000 / 128 * 1.5


def test_record_excludes_dropped_readouts(tmp_path):
    """Dropped readouts contribute nothing to the average and must not be
    recorded: the capture replays to the same spectrum."""
    rec = str(tmp_path / "cap.iq")
    src = SyntheticSource(noise=5.0, seed=92, drop_every=2)
    rv, out, err, params = run(
        ["-f", "1M", "-n", "512", "-b", "64", "-s", "16384",
         "--record", rec, "--source", "synthetic:noise=5,seed=92"], src)
    assert rv == ReturnValue.Success
    assert "Error: dropped samples." in err
    # Only successful reads are captured: exactly the consumed bytes.
    assert os.path.getsize(rec) == 2 * 64 * 512


def test_record_closed_and_flushed_on_error(tmp_path):
    """--record must flush/close on the error exit path too: a stream too
    short for one spectrum raises AcquisitionError, but the bytes that
    were consumed are on disk afterwards."""
    short = tmp_path / "short.iq"
    short.write_bytes(bytes(100))            # < one 64-bin frame
    rec = str(tmp_path / "cap.iq")
    from rtl_power_fftw_tpu.sources import FileSource
    params = parse(["-f", "1M", "-n", "4", "-b", "64",
                    "--record", rec, "--source", f"file:{short}"])
    src = FileSource(str(short))
    with pytest.raises(RPFexception) as e:
        run_session(params, src, AuxData(params, stderr=io.StringIO()),
                    stdout=io.StringIO(), stderr=io.StringIO(),
                    install_sigint=False)
    assert e.value.retval == ReturnValue.AcquisitionError
    assert os.path.getsize(rec) == 100       # partial captured + flushed


def test_record_bad_path_is_invalid_input():
    src = SyntheticSource(noise=5.0, seed=93)
    params = parse(["-f", "1M", "-n", "4", "-b", "64",
                    "--record", "/nonexistent-dir/x.iq",
                    "--source", "synthetic:"])
    with pytest.raises(RPFexception) as e:
        run_session(params, src, AuxData(params, stderr=io.StringIO()),
                    stdout=io.StringIO(), stderr=io.StringIO(),
                    install_sigint=False)
    assert e.value.retval == ReturnValue.InvalidInput


def test_stitch_out_bad_path_is_invalid_input():
    src = SyntheticSource(noise=5.0, seed=94)
    params = parse(["-f", "1M", "-n", "4", "-b", "64",
                    "--stitch-out", "/nonexistent-dir/x.dat",
                    "--source", "synthetic:"])
    with pytest.raises(RPFexception) as e:
        run_session(params, src, AuxData(params, stderr=io.StringIO()),
                    stdout=io.StringIO(), stderr=io.StringIO(),
                    install_sigint=False)
    assert e.value.retval == ReturnValue.InvalidInput


def test_backend_probe_timeout_and_error():
    """_backend_ready maps a hung or failing backend init to the typed
    hardware-error exit (7) instead of hanging the session forever
    (an unreachable accelerator can hang the first jax call
    indefinitely; the reference fails promptly, device.cxx:30-50)."""
    import time as _time
    from rtl_power_fftw_tpu.session import _backend_ready

    with pytest.raises(RPFexception) as ei:
        _backend_ready(timeout=0.2, _probe=lambda: _time.sleep(5))
    assert ei.value.return_value == ReturnValue.HardwareError
    assert "did not initialize" in str(ei.value)

    def boom():
        raise RuntimeError("Unable to initialize backend 'cuda'")
    with pytest.raises(RPFexception) as ei:
        _backend_ready(timeout=5.0, _probe=boom)
    assert ei.value.return_value == ReturnValue.HardwareError
    # Healthy probe passes.
    _backend_ready(timeout=5.0, _probe=lambda: 1)
