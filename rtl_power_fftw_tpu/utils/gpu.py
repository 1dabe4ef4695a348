"""Device facts and step timing for the benchmarks and the chip smoke run.

Measurements name the card they ran on and refuse to run anywhere else:
a time taken on the CPU backend is never reported as a device time.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List

#: Published peak of one NVIDIA H100 SXM (NVIDIA data sheet): device
#: memory bandwidth in bytes/s, at the card's full 700 W power limit.
#: Keyed by ``device_kind``; a card missing here is an error, not a
#: default.
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, read from a child process that never imports JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (r.stdout or r.stderr).strip()


def require_gpu():
    """Return ``jax.devices()`` when JAX's default backend is a GPU;
    raise SystemExit(1) otherwise — a measurement never falls back to
    the CPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def hbm_peak(device_kind: str) -> float:
    """Published device-memory bandwidth of ``device_kind`` in bytes/s."""
    if device_kind not in HBM_PEAK_BYTES_PER_S:
        raise KeyError(f"no published peak for {device_kind!r}")
    return HBM_PEAK_BYTES_PER_S[device_kind]


def time_per_call(fn: Callable[[], object], calls: int = 20,
                  samples: int = 7, warmup: int = 3) -> List[float]:
    """Seconds per call of ``fn`` (which returns a JAX array): after
    ``warmup`` calls, each sample dispatches ``calls`` back-to-back calls
    and waits for the last with ``block_until_ready``. Returns the
    per-call time of every sample (report the median and the spread)."""
    for _ in range(warmup):
        fn().block_until_ready()
    out = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls - 1):
            fn()
        fn().block_until_ready()
        out.append((time.perf_counter() - t0) / calls)
    return out
