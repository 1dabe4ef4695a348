"""Sustained-ingest benchmark: the FULL host pipeline, not just the chip.

bench.py measures the on-chip compute step over device-resident data;
this benchmark answers the reference's defining design question — can the
pipeline ingest CONTINUOUSLY without dropping (README.md:19-20) — by
timing the whole chain on a recorded stream:

    native C++ loader → FrameSlicer → (direct-feed views) → jitted device
    step → float64 host accumulation

Three measurements, one JSON line:

* ``session_gsps``    — end-to-end wall-clock over a real acquisition on
                        the attached GPU.
* ``host_pipeline_gsps`` — the same chain with the device step replaced
                        by a null step: loader, slicing, batching and
                        dispatch overhead with no transport/compute.
* ``transport_gbps``  — raw ``jax.device_put`` throughput of 16 MB u8
                        chunks, i.e. the host→device ceiling the session
                        number is bounded by.

Runs only on an NVIDIA GPU (exit 1 elsewhere). The recording it replays
is written next to this script (``.bench_ingest.iq``, git-ignored) and
removed at the end. Diagnostics to stderr; the single JSON line to
stdout.

Usage: python bench_ingest.py
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np


def _make_recording(path: str, mbytes: int) -> None:
    rng = np.random.default_rng(42)
    chunk = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    with open(path, "wb") as f:
        for _ in range(mbytes):
            f.write(chunk)


def main() -> int:
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    from rtl_power_fftw_tpu.utils.gpu import (card_name_and_power_limit,
                                             require_gpu)

    configure_compile_cache()
    try:
        devs = require_gpu()
    except SystemExit as e:
        print(f"bench_ingest: {e}", file=sys.stderr)
        return 1
    import jax

    from rtl_power_fftw_tpu.auxdata import AuxData
    from rtl_power_fftw_tpu.config import parse_args
    from rtl_power_fftw_tpu.pipeline.datastore import Datastore
    from rtl_power_fftw_tpu.sources import FileSource

    N = 2048
    dev = devs[0]
    print(f"ingest bench device: {dev.device_kind}; card: "
          f"{card_name_and_power_limit()}", file=sys.stderr)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_ingest.iq")
    _make_recording(path, 256)

    # --- transport ceiling -------------------------------------------------
    x = np.random.default_rng(0).integers(0, 256, 16 << 20, dtype=np.uint8)
    jax.device_put(x, dev).block_until_ready()  # warm
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            jax.device_put(x, dev).block_until_ready()
        best = max(best, 4 * 16 / 1024 / (time.perf_counter() - t0))
    transport_gbps = best
    print(f"transport ceiling (device_put): {transport_gbps:.3f} GB/s",
          file=sys.stderr)

    def run_acquisition(repeats: int, datastore=None) -> float:
        """One full acquisition (producer loop + consumer thread) over the
        looped recording; returns wall seconds."""
        argv = ["-f", "100M", "-b", str(N), "-n", str(repeats), "-q",
                "--frames-per-step", "4096",   # 16.8 MB steps: amortize
                "-s", str(4096 * 2 * N),       # per-dispatch cost and keep
                "--source", f"file:{path}:loop"]  # direct-feed aligned
        params = parse_args(argv, stderr=io.StringIO())
        from rtl_power_fftw_tpu.output.stats import SessionStats
        from rtl_power_fftw_tpu.session import Acquisition

        # Auto-sized pool slots == the session's read size: full reads are
        # zero-copy pool-view passthroughs (recycled by refcount).
        src = FileSource(path, loop=True, use_native=True)
        data = datastore if datastore is not None else Datastore(params)
        data.params = params
        acq = Acquisition(params, AuxData(params, stderr=io.StringIO()),
                          src, data, 2_048_000, 100_000_000, SessionStats(),
                          stderr=io.StringIO())
        t0 = time.perf_counter()
        acq.run()
        dt = time.perf_counter() - t0
        assert acq.repeats_done == repeats, (acq.repeats_done, repeats)
        src.close()
        return dt

    # --- end-to-end session on the attached device -------------------------
    # Warm: compile the step once outside the timed run.
    warm_repeats = 4096
    params0 = parse_args(["-b", str(N), "-n", str(warm_repeats),
                          "--frames-per-step", "4096"], stderr=io.StringIO())
    store = Datastore(params0)
    run_acquisition(warm_repeats, datastore=store)
    repeats = 65536              # 268 MB of IQ through the whole chain
    dt = run_acquisition(repeats, datastore=store)
    session_gsps = repeats * N / dt / 1e9
    print(f"session: {repeats} spectra x {N} bins in {dt:.2f} s "
          f"= {session_gsps:.3f} GS/s end-to-end", file=sys.stderr)

    # --- host pipeline only (null device step) -----------------------------
    class NullStep:
        """Device-step stand-in: consumes batches, returns a ready zero."""
        def __init__(self, F):
            self.F = F
            self._z = np.zeros(N, dtype=np.float32)

        def __call__(self, raw, n_valid):
            return self._z

    host_repeats = 1 << 19       # 2.1 GB of IQ through the host chain
    params1 = parse_args(["-b", str(N), "-n", str(host_repeats),
                          "--frames-per-step", "4096"], stderr=io.StringIO())
    store1 = Datastore(params1)
    store1.step = NullStep(store1.step.F)
    dt1 = run_acquisition(host_repeats, datastore=store1)
    host_gsps = host_repeats * N / dt1 / 1e9
    print(f"host pipeline: {host_repeats} spectra in {dt1:.2f} s "
          f"= {host_gsps:.3f} GS/s (loader+slicer+batching, no device)",
          file=sys.stderr)

    os.unlink(path)
    print(json.dumps({
        "metric": "sustained ingest @2048-bin averaged PSD",
        "value": round(session_gsps, 4),
        "unit": "GS/s",
        "host_pipeline_gsps": round(host_gsps, 4),
        "transport_gbps": round(transport_gbps, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
