"""Benchmark: the device step's averaged-spectra throughput at 2048 bins.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "GS/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}}

Metric: equivalent IQ throughput in GS/s of the auto transform step
(dequant → batched FFT → |X|² → masked two-stage frame reduce) at
N = 2048 with F = 4096 frames per step (BASELINE.json north star: 1 GS/s;
``vs_baseline`` is the fraction of it). This is one layer's metric — the
device step alone, not the served CLI path.

Timing: after a warm-up, back-to-back dispatches of the step end in
``block_until_ready``; the value is the median per-step time of several
samples. Runs only on an NVIDIA GPU: any other platform exits 1 and
prints no JSON line. The card's name and power limit go to stderr.

Usage: python bench.py
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np

N = 2048
F = 4096          # frames per step (16 MiB of u8 IQ)


def main() -> int:
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    from rtl_power_fftw_tpu.utils.gpu import (card_name_and_power_limit,
                                             require_gpu, time_per_call)

    configure_compile_cache()
    try:
        devs = require_gpu()
    except SystemExit as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    import jax
    import jax.numpy as jnp

    dev = devs[0]
    print(f"bench device: {dev.device_kind} x{len(devs)}; card: "
          f"{card_name_and_power_limit()}", file=sys.stderr)

    from rtl_power_fftw_tpu.ops.spectral import PsdStep

    step = PsdStep(N, F, backend="auto")
    fn = step.lowered_fn()
    rng = np.random.default_rng(0)
    raw_host = rng.integers(0, 256, size=(F, 2 * N), dtype=np.uint8)
    raw = jax.device_put(
        raw_host.view(np.uint16) if step.takes_u16 else raw_host, dev)
    nv = jnp.int32(F)
    times = time_per_call(lambda: fn(raw, nv))
    per_step = statistics.median(times)
    gsps = F * N / per_step / 1e9
    print(f"auto path: {step.path}; per-step {per_step * 1e6:.1f} us "
          f"(samples {min(times) * 1e6:.1f}-{max(times) * 1e6:.1f} us) "
          f"= {gsps:.3f} GS/s", file=sys.stderr)
    print(json.dumps({
        "metric": "equivalent IQ throughput per chip @2048-bin device step",
        "value": gsps, "unit": "GS/s", "vs_baseline": gsps / 1.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
