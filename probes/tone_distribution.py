"""Adversarial-tone error DISTRIBUTION for the auto transform at the
BASELINE sizes: random 35 dB-tone realizations per band (60+ for a band
admission), each compared against float64 truth, alongside the FFTW-f32
class error (scipy f32) on the SAME realization — so the guarantee can
be stated class-relative and per-percentile.

Run from the repository root:
    python probes/tone_distribution.py [seeds] [backend ...] [c1|c2|c3 ...]
(defaults: 100 seeds, the auto backend, all three configs — c1 = 2048,
c2 = 8192 hann, c3 = 2**20). Prints per path and backend: p50 / p99 / max
of (ours, class, ours/class ratio).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import scipy.fft

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.ops.spectral import PsdStep, adapt_batch

SEEDS = (int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit()
         else 100)
CONFIGS = {"c1": (2048, 64, None), "c2": (8192, 16, "hann"),
           "c3": (1 << 20, 8, None)}
BACKENDS = [a for a in sys.argv[1:]
            if not a.isdigit() and a not in CONFIGS] or ["auto"]
CHOSEN = [a for a in sys.argv[1:] if a in CONFIGS] or list(CONFIGS)


def realization(N, F, seed):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0.05, 0.45)
    ph = rng.uniform(0, 2 * np.pi)
    t = np.arange(F * N)
    x = 100.0 * np.exp(1j * (2 * np.pi * f0 * t + ph)) + (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re8, im8], axis=-1).reshape(F, 2 * N)


def f64_truth(raw, w=None):
    z = (raw[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (raw[:, 1::2].astype(np.float64) - 127.0)
    if w is not None:
        z = z * w.astype(np.float64)
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


def class_err(raw, want, w=None):
    z32 = ((raw[:, 0::2].astype(np.float32) - np.float32(127.0))
           + 1j * (raw[:, 1::2].astype(np.float32) - np.float32(127.0))
           ).astype(np.complex64)
    if w is not None:
        z32 = z32 * w.astype(np.complex64)
    X = scipy.fft.fft(z32, axis=1)
    got = (X.real.astype(np.float64) ** 2
           + X.imag.astype(np.float64) ** 2).sum(0)
    return rel(got, want)


def rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def pct(a, q):
    return float(np.percentile(np.asarray(a), q))


def run(name, N, F, backend="auto", window=None):
    F, _ = adapt_batch(F)
    w = None if window is None else make_window(window, N)
    step = PsdStep(N, F, window=w, backend=backend)
    ours, cls, ratio = [], [], []
    for seed in range(SEEDS):
        raw = realization(N, F, 1000 + seed)
        want = f64_truth(raw, w)
        e = rel(np.asarray(step(raw, F), np.float64), want)
        c = class_err(raw, want, w)
        ours.append(e)
        cls.append(c)
        ratio.append(e / c)
    print(f"{name:22s} {step.path:6s} N={N:7d} F={F:3d} seeds={SEEDS}  "
          f"ours p50={pct(ours,50):.2e} p99={pct(ours,99):.2e} "
          f"max={max(ours):.2e} | class p50={pct(cls,50):.2e} "
          f"max={max(cls):.2e} | ratio p50={pct(ratio,50):.2f} "
          f"p99={pct(ratio,99):.2f} max={max(ratio):.2f}", flush=True)


if __name__ == "__main__":
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    for backend in BACKENDS:
        for c in CHOSEN:
            N, F, window = CONFIGS[c]
            run(f"{c} ({backend})", N, F, backend, window=window)
