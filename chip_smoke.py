"""Chip smoke run: the CLI session path on an NVIDIA GPU, checked against
the float64 golden.

Drives ``rtl_power_fftw_tpu.cli.main(argv)`` in this one process through
the five BASELINE.json deployments at their published sizes. Every phase
records the IQ bytes it consumed (``--record``) and its output is compared
with the float64 transcription of the reference (``tests/golden.py``) on
exactly those bytes. Any phase that fails, mismatches, or falls back to
the matmul DFT makes the script exit non-zero.

Tolerances (relative, per bin, on linear power — ``-l``):

* realistic input (noise + a moderate tone): 1e-5, the reference parity
  budget, plus half a unit in the last printed digit of the text output
  (6 significant digits); matrix rows are float32 and need no such term;
* N = 2**20: the reference's own class, as tests/test_large_fft.py
  enforces it — max(1e-5, 1.5 × the worse of the scipy-f32 (FFTW-class)
  error and the platform's own monolithic f32 FFT error on the same
  frames), plus the same print term. A float32 transform at 2**20 is
  itself ~1e-5..1e-3 off the float64 truth, growing with the tone.

Usage:
  python chip_smoke.py          one GPU: the five deployments
  python chip_smoke.py --four   four GPUs: the sharded paths only
                                (--streams 16, --shard-transform,
                                --streams 2 --shard-transform, and
                                dryrun_multichip(4))

The last stdout line is ``{"ok": true, "device": {...}}``; nothing is
printed there on failure.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: Scratch directory for records and outputs (removed at the end).
WORK = os.path.join(HERE, ".chip_smoke")
#: Significant digits of the text output's power column.
TEXT_DIGITS = 6
REL_BUDGET = 1e-5
#: Realistic input: a 20-count tone over 8-count noise, u8-quantized.
SOURCE = "synthetic:tone=100.2M/20,noise=8,seed={seed}"


def check_device(devices) -> dict:
    """The device record of the final line; raises RuntimeError unless
    JAX's devices are GPUs."""
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"expected a GPU, JAX found {d.platform} "
                           f"({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def print_term(digits: int = TEXT_DIGITS) -> float:
    """Bound on the relative rounding of a value printed with ``digits``
    significant digits: half a unit in the last digit of 1.00000."""
    return 0.5 * 10.0 ** (1 - digits)


def max_excess(got: np.ndarray, want: np.ndarray, rel: float,
               digits: int | None = None) -> float:
    """Largest per-bin relative error over its allowance (>1 fails):
    allowance = ``rel`` plus, for text output with ``digits`` significant
    digits, the printing's half-unit."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != golden {want.shape}")
    if not np.all(np.isfinite(got)):
        raise ValueError("non-finite output")
    allow = rel + (0.0 if digits is None else print_term(digits))
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return float((err / allow).max())


def read_text_spectrum(text: str) -> np.ndarray:
    """Power column of a text spectrum (``freq power`` lines, ``#``
    comments and blank separators skipped)."""
    vals = [float(line.split()[1]) for line in text.splitlines()
            if line.strip() and not line.startswith("#")]
    return np.asarray(vals, np.float64)


def overlapped_frames(stream: np.ndarray, N: int, hop: int,
                      n: int) -> np.ndarray:
    """The first ``n`` Welch frames (hop ``hop`` samples) of a u8 IQ
    stream, laid end to end so golden_accumulate reads them in turn."""
    stream = np.asarray(stream, np.uint8).ravel()
    return np.concatenate([stream[2 * f * hop:2 * (f * hop + N)]
                           for f in range(n)])


def _flipped_c64(frames: np.ndarray, N: int) -> np.ndarray:
    """Dequantized complex64 frames with the reference's (−1)^n flip."""
    raw = np.asarray(frames, np.uint8).reshape(-1, 2 * N)
    z = ((raw[:, 0::2].astype(np.float32) - np.float32(127.0))
         + 1j * (raw[:, 1::2].astype(np.float32) - np.float32(127.0))
         ).astype(np.complex64)
    z *= np.where(np.arange(N) % 2 == 0, 1, -1).astype(np.complex64)
    return z


def _f32_err(fft, frames, N, want_pwr) -> float:
    """Max relative error of |fft(frame)|² summed in float64 over the
    frames, against the float64 truth ``want_pwr`` (pre-shifted order)."""
    z = _flipped_c64(frames, N)
    got = np.zeros(N)
    for i in range(0, len(z), 8):
        X = np.asarray(fft(z[i:i + 8]))
        got += (X.real.astype(np.float64) ** 2
                + X.imag.astype(np.float64) ** 2).sum(0)
    return float((np.abs(got - want_pwr)
                  / np.maximum(np.abs(want_pwr), 1e-300)).max())


def scipy_f32_class_err(frames: np.ndarray, N: int, want_pwr) -> float:
    """The FFTW class (scipy complex64 FFT) on the same frames."""
    import scipy.fft
    return _f32_err(lambda z: scipy.fft.fft(z, axis=1), frames, N, want_pwr)


def platform_f32_err(frames: np.ndarray, N: int, want_pwr) -> float:
    """The platform's own monolithic complex64 FFT (cuFFT on the GPU) on
    the same frames."""
    import jax
    import jax.numpy as jnp
    fft = jax.jit(lambda z: jnp.fft.fft(z, axis=1))
    return _f32_err(fft, frames, N, want_pwr)


def class_tolerance(frames: np.ndarray, N: int, want_pwr, info) -> float:
    """tests/test_large_fft.py's budget: max(1e-5, 1.5 × the worse of
    the FFTW-class and platform-FFT errors on the same frames)."""
    info["class_err"] = scipy_f32_class_err(frames, N, want_pwr)
    info["platform_err"] = platform_f32_err(frames, N, want_pwr)
    return max(REL_BUDGET, 1.5 * max(info["class_err"],
                                      info["platform_err"]))


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, plus the
    persistent-cache hits and misses, since the last ``reset``."""

    def __init__(self):
        import jax.monitoring as mon
        self.reset()
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)

    def reset(self):
        self.seconds, self.hits, self.misses = 0.0, 0, 0

    def _duration(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.seconds += secs

    def _event(self, name, **_):
        if name == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif name == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def run_cli(argv, clock, dev):
    """cli.main(argv) in-process: (stdout text, stderr text, timings)."""
    from rtl_power_fftw_tpu.cli import main
    out, err = io.StringIO(), io.StringIO()
    clock.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    wall = time.perf_counter() - t0
    stderr = err.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}: {stderr[-2000:]}")
    if "falls back to the matmul DFT" in stderr:
        raise RuntimeError("the platform FFT compile fallback fired")
    path = [ln.split(":", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("Transform path:")]
    spectra = [int(ln.rsplit(":", 1)[1]) for ln in stderr.splitlines()
               if ln.startswith("Actual number of averaged spectra:")]
    mesh = [ln.rsplit("mesh size", 1)[1].strip(" )") for ln in
            stderr.splitlines() if ln.startswith("Parallel streams:")]
    stats = dev.memory_stats() or {}
    info = {"path": path[0] if path else "?", "wall_s": round(wall, 3),
            "compile_s": round(clock.seconds, 3),
            "cache_hits": clock.hits, "cache_misses": clock.misses,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    if mesh:
        info["mesh_devices"] = int(mesh[0])
    return out.getvalue(), stderr, spectra, info


def _load(path):
    return np.fromfile(path, dtype=np.uint8)


def _text_phase(name, N, argv_extra, seed, clock, dev, window=None,
                hop=None, baseline=None, class_relative=False):
    """One text-output phase: run, then compare with the golden."""
    from golden import golden_accumulate, golden_finalize
    rec = os.path.join(WORK, f"{name}.iq")
    argv = ["-f", "100M", "-b", str(N), "-l", "--record", rec,
            "--source", SOURCE.format(seed=seed)] + argv_extra
    out, _, spectra, info = run_cli(argv, clock, dev)
    got = read_text_spectrum(out)
    reps = spectra[-1]
    stream = _load(rec)
    frames = (stream if hop is None
              else overlapped_frames(stream, N, hop, reps))
    pwr, done = golden_accumulate(frames, N, reps, window=window)
    if done != reps:
        raise RuntimeError(f"{name}: record holds {done} frames, "
                           f"session averaged {reps}")
    want = golden_finalize(pwr, done, 2_000_000, linear=True,
                           baseline=baseline)
    rel = REL_BUDGET
    if class_relative:
        rel = class_tolerance(frames[:done * 2 * N], N, pwr, info)
    info["tolerance"] = rel
    info["excess"] = max_excess(got, want, rel, digits=TEXT_DIGITS)
    return info


def one_card_phases(clock, dev):
    from golden import golden_accumulate, golden_finalize
    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.output.matrix import read_matrix

    yield "config1 -b 2048 -n 100", _text_phase(
        "c1", 2048, ["-n", "100"], 1, clock, dev)
    # -s 16 MiB: 4096 frames per device step, the config's full batch.
    yield "config1 -b 2048 -n 20000 (F=4096)", _text_phase(
        "c1big", 2048, ["-n", "20000", "-s", str(16 << 20)], 2, clock, dev)

    N = 8192
    base = os.path.join(WORK, "baseline.txt")
    # Negative baseline values: subtracting them keeps every output bin
    # above the accumulated power, so relative error stays well defined.
    b = -1e-5 * (1.5 + np.sin(np.arange(N)))
    with open(base, "w") as f:
        f.write("".join(f"{float(v)!r}\n" for v in b))
    yield "config2 -b 8192 hann welch50 -B", _text_phase(
        "c2", N, ["-n", "1000", "--window-function", "hann",
                  "--welch-overlap", "50", "-B", base], 3, clock, dev,
        window=make_window("hann", N), hop=N // 2, baseline=b)

    yield "config3 -b 1048576 -n 32", _text_phase(
        "c3", 1 << 20, ["-n", "32"], 4, clock, dev, class_relative=True)

    # config 4: 256 hops x 2048 bins, matrix output. -n 100 makes each
    # hop read exactly one 409600-byte buffer (25 x 16384), so hop h's
    # bytes are record[h*409600 : (h+1)*409600].
    N, reps, hops = 2048, 100, 256
    rec = os.path.join(WORK, "c4.iq")
    mat = os.path.join(WORK, "c4")
    out, _, _, info = run_cli(
        ["-f", "100M:612M", "-b", str(N), "-n", str(reps), "-l", "-m", mat,
         "--record", rec, "--source", SOURCE.format(seed=5)], clock, dev)
    # One matrix row per scan: the hops' spectra side by side.
    rows, _ = read_matrix(mat + ".bin", mat + ".met")
    if rows.shape != (1, hops * N):
        raise RuntimeError(f"config4: matrix {rows.shape}, want "
                           f"{(1, hops * N)}")
    rows = rows.reshape(hops, N)
    stream = _load(rec)
    per_hop = 2 * N * reps
    if len(stream) != hops * per_hop:
        raise RuntimeError(f"config4: record {len(stream)} bytes, want "
                           f"{hops * per_hop}")
    worst = 0.0
    for h in range(hops):
        pwr, done = golden_accumulate(
            stream[h * per_hop:(h + 1) * per_hop], N, reps)
        want = golden_finalize(pwr, done, 2_000_000, linear=True)
        worst = max(worst, max_excess(rows[h], want, REL_BUDGET))
    info["tolerance"], info["excess"] = REL_BUDGET, worst
    yield "config4 256 hops x 2048 -m", info

    yield "config5 --streams 16 -b 2048", streams_phase(
        "c5", 16, 2048, 100, clock, dev)


def streams_phase(name, S, N, reps, clock, dev, extra=(),
                  class_relative=False):
    """--streams S: every stream's record against its golden; the output
    is the finalized sum over streams."""
    from golden import golden_accumulate, golden_finalize
    rec = os.path.join(WORK, f"{name}.iq")
    out, _, spectra, info = run_cli(
        ["-f", "100M", "-b", str(N), "-n", str(reps), "-l",
         "--streams", str(S), "--record", rec,
         "--source", SOURCE.format(seed=6)] + list(extra), clock, dev)
    got = read_text_spectrum(out)
    total = spectra[-1]
    if total != S * reps:
        raise RuntimeError(f"{name}: averaged {total} spectra, "
                           f"want {S * reps}")
    pwr, frames = np.zeros(N), []
    for s in range(S):
        stream = _load(f"{rec}.s{s}")
        p, done = golden_accumulate(stream, N, reps)
        if done != reps:
            raise RuntimeError(f"{name}: stream {s} recorded {done} frames")
        pwr += p
        frames.append(stream[:reps * 2 * N])
    want = golden_finalize(pwr, total, 2_000_000, linear=True)
    rel = (class_tolerance(np.concatenate(frames), N, pwr, info)
           if class_relative else REL_BUDGET)
    info["tolerance"] = rel
    info["excess"] = max_excess(got, want, rel, digits=TEXT_DIGITS)
    return info


def four_card_phases(clock, dev):
    yield "--streams 16 -b 2048 (4-card psum)", streams_phase(
        "f1", 16, 2048, 100, clock, dev)
    yield "--shard-transform -b 1048576 (bigfft)", _text_phase(
        "f2", 1 << 20, ["-n", "32", "--shard-transform"], 7, clock, dev,
        class_relative=True)
    yield "--streams 2 --shard-transform (2x2 grid)", streams_phase(
        "f3", 2, 1 << 20, 16, clock, dev, extra=["--shard-transform"],
        class_relative=True)
    import __graft_entry__
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    yield "dryrun_multichip(4)", {"wall_s": round(time.perf_counter() - t0,
                                                  3), "excess": 0.0}


def main(argv) -> int:
    four = "--four" in argv
    sys.path.insert(0, os.path.join(HERE, "tests"))   # golden.py
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    from rtl_power_fftw_tpu.utils.gpu import card_name_and_power_limit

    cache = configure_compile_cache()
    import jax
    jax.config.update("jax_platforms", "cuda")   # no CPU fallback
    devs = jax.devices()
    device = check_device(devs)
    want = 4 if four else 1
    if len(devs) < want:
        raise RuntimeError(f"needs {want} GPUs, JAX sees {len(devs)}")
    print(f"jax.devices(): {devs}")
    print(f"device_kind: {device['kind']}  count: {device['count']}")
    print(f"card: {card_name_and_power_limit()}")
    print(f"compile cache: {cache}", flush=True)
    clock = CompileClock()

    os.makedirs(WORK, exist_ok=True)
    failed = []
    try:
        phases = four_card_phases if four else one_card_phases
        gen = phases(clock, devs[0])
        while True:
            try:
                name, info = next(gen)
            except StopIteration:
                break
            ok = info.get("excess", 0.0) <= 1.0
            if not ok:
                failed.append(name)
            print(f"{'PASS' if ok else 'FAIL'} {name}: "
                  + json.dumps(info), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    device["count"] = len(devs)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
