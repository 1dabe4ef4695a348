"""Device-step timings of the five BASELINE.json configurations.

Not the one-line benchmark (that's bench.py) — this is the per-config
table: each configuration's auto transform step on the current GPU,
timed with back-to-back dispatches ending in ``block_until_ready`` after
a warm-up (median of several samples, spread printed). Device step only:
the CLI session path is exercised by chip_smoke.py. Runs only on an
NVIDIA GPU; the card's name and power limit go to stderr.

Usage: python bench_configs.py [--only <substr>]
"""

from __future__ import annotations

import statistics
import sys

import numpy as np


def main() -> int:
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    from rtl_power_fftw_tpu.utils.gpu import (card_name_and_power_limit,
                                             require_gpu, time_per_call)

    configure_compile_cache()
    only = ""
    if "--only" in sys.argv:
        idx = sys.argv.index("--only") + 1
        if idx >= len(sys.argv):
            print("usage: bench_configs.py [--only <substr>]",
                  file=sys.stderr)
            return 2
        only = sys.argv[idx]
    try:
        devs = require_gpu()
    except SystemExit as e:
        print(f"bench_configs: {e}", file=sys.stderr)
        return 1
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.ops.spectral import PsdStep
    from rtl_power_fftw_tpu.parallel import ShardedPsdStep, make_mesh

    dev = devs[0]
    print(f"device: {dev.device_kind} x{len(devs)}; card: "
          f"{card_name_and_power_limit()}", file=sys.stderr)
    rng = np.random.default_rng(0)
    rows = []

    def report(name, path, N, spectra_per_step, times):
        per = statistics.median(times)
        rows.append((name, path, N, spectra_per_step, f"{per * 1e6:,.1f}",
                     f"{spectra_per_step * N / per / 1e9:.3f}"))
        print(f"  {name}: {path}, {per * 1e6:,.1f} us/step (samples "
              f"{min(times) * 1e6:,.1f}-{max(times) * 1e6:,.1f})",
              file=sys.stderr)

    def measure(name, N, F, window=None, baseline=None):
        if only and only not in name:
            return
        step = PsdStep(N, F, window=window, backend="auto")
        F = step.F
        fn = step.lowered_fn()
        raw_host = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = jax.device_put(
            raw_host.view(np.uint16) if step.takes_u16 else raw_host, dev)
        nv = jnp.int32(F)
        if baseline is None:
            call = lambda: fn(raw, nv)  # noqa: E731
        else:
            b = jax.device_put(np.asarray(baseline, np.float32), dev)
            sub = jax.jit(lambda r, n, b: fn(r, n) - b)
            call = lambda: sub(raw, nv, b)  # noqa: E731
        report(name, step.path, N, F, time_per_call(call))

    measure("config1: 2048-bin", 2048, 4096)
    measure("config2: 8192-bin hann+baseline", 8192, 1024,
            window=make_window("hann", 8192),
            baseline=np.linspace(-1, 1, 8192))
    measure("config3: 1M-point", 1 << 20, 8)
    # 256 hops x 2048 bins: 8 frames per hop folded into one batch.
    measure("config4: 256 hops x 2048-bin", 2048, 2048)

    name5 = "config5: 16 streams psum"
    if not only or only in name5:
        S, N5, F5 = 16, 2048, 256
        mesh = make_mesh(min(len(devs), S))
        step5 = ShardedPsdStep(mesh, N5, F5, streams=S, backend="auto")
        raw5_host = rng.integers(0, 256, (S, step5.F, 2 * N5),
                                 dtype=np.uint8)
        raw5 = jax.device_put(
            raw5_host.view(np.uint16) if step5.takes_u16 else raw5_host,
            NamedSharding(mesh, P(step5.axis)))
        nv5 = jax.device_put(np.full((S,), step5.F, np.int32),
                             NamedSharding(mesh, P(step5.axis)))
        fn5 = step5._step
        report(f"{name5} (mesh {mesh.devices.size})", step5.path, N5,
               S * step5.F, time_per_call(lambda: fn5(raw5, nv5)[1]))

    print("| config | path | N | spectra/step | us/step | GS/s |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print("| " + " | ".join(str(c) for c in r) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
