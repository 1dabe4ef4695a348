"""Transform-rung timings on the GPU: the evidence behind the GPU auto band.

For each BASELINE size and across the unwindowed 4096-65536 band, every
listed rung is timed as an explicit-backend PsdStep at F = 16 MiB / (2N)
frames per step (the config-1 step size: 4096 frames at N = 2048), and
its partial sum is compared with the float64 truth on the same frames.
Each row prints µs/step, GS/s, and the input-read rate (F·2N bytes per
step) as a share of the card's published device-memory peak — the least
traffic any fused step must move.

Also checks the explicit bf16-split rungs on the card: fourstep4x at
2048 windowed and the truncation-split mixed four-step at 2048.

Usage: python bench_bands.py          (NVIDIA GPU only)
"""

from __future__ import annotations

import statistics
import sys

import numpy as np

STEP_BYTES = 16 << 20

#: (N, window, rungs): the first rung listed is what the CPU ladder's
#: auto picks at that size; "xla" is the platform FFT (cuFFT).
CASES = [
    (2048, None, ["hybrid", "xla", "fourstep"]),
    (8192, "hann", ["xla", "fourstep4x", "fourstep"]),
    (1 << 20, None, ["fft4", "xla", "hybrid"]),
    (4096, None, ["xla", "fourstep"]),
    (8192, None, ["xla", "fourstep"]),
    (16384, None, ["fft4", "xla", "fourstep"]),
    (65536, None, ["fft4", "xla", "fourstep"]),
    (2048, "hann", ["xla", "fourstep4x"]),
]

ACC_FRAMES = 256   # frames compared against the float64 truth


def _truth(raw, w):
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    if w is not None:
        z = z * w.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


def _rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def main() -> int:
    from rtl_power_fftw_tpu.compile_cache import configure_compile_cache
    from rtl_power_fftw_tpu.utils.gpu import (card_name_and_power_limit,
                                             hbm_peak, require_gpu,
                                             time_per_call)

    configure_compile_cache()
    try:
        devs = require_gpu()
    except SystemExit as e:
        print(f"bench_bands: {e}", file=sys.stderr)
        return 1
    import jax
    import jax.numpy as jnp

    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu.ops.dft import fourstep_psd_partial_mixed
    from rtl_power_fftw_tpu.ops.spectral import PsdStep, dequant_iq_u16

    dev = devs[0]
    peak = hbm_peak(dev.device_kind)
    print(f"device: {dev.device_kind}; card: {card_name_and_power_limit()}")
    print("| N | window | F | rung | us/step | GS/s | input GB/s | "
          "share of HBM peak | max rel err vs f64 |")
    print("|---|---|---|---|---|---|---|---|---|")
    rng = np.random.default_rng(0)
    for N, window, rungs in CASES:
        F = max(8, STEP_BYTES // (2 * N))
        w = None if window is None else make_window(window, N)
        raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        nacc = min(F, ACC_FRAMES)
        want = _truth(raw[:nacc], w)
        for rung in rungs:
            step = PsdStep(N, F, window=w, backend=rung)
            fn = step.lowered_fn()
            x = jax.device_put(raw.view(np.uint16) if step.takes_u16
                               else raw, dev)
            nv = jnp.int32(F)
            err = _rel(fn(x, jnp.int32(nacc)), want)
            per = statistics.median(time_per_call(lambda: fn(x, nv)))
            rate = F * 2 * N / per
            print(f"| {N} | {window or '-'} | {F} | {step.path} | "
                  f"{per * 1e6:,.1f} | {F * N / per / 1e9:.2f} | "
                  f"{rate / 1e9:,.0f} | {rate / peak:.1%} | {err:.2e} |",
                  flush=True)

    # The truncation split (_trunc_split3) on the card: the mixed
    # four-step keeps its parity only if XLA does not fold the split.
    N, F = 2048, 64
    raw = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    mixed = jax.jit(lambda r: fourstep_psd_partial_mixed(
        *dequant_iq_u16(r), jnp.ones((F,), jnp.float32)))
    err = _rel(mixed(jax.device_put(raw.view(np.uint16), dev)),
               _truth(raw, None))
    print(f"\nmixed four-step (truncation splits) N={N}: max rel err "
          f"vs f64 {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
