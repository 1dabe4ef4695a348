"""Cyclostationary analysis: spectral correlation over recorded IQ.

PSDs (every other estimator here) discard the phase relations BETWEEN
frequency bins; man-made signals (AM, PSK, OFDM, chirped radar) carry
periodic structure that shows up as correlation between bins separated
by the cyclic frequency α. The spectral correlation function

    S^α(f) = E[ X(f + α) · conj(X(f)) ]

is the standard detector/classifier for such signals (and a sharper RFI
discriminator than energy alone — cf. models/kurtosis.py, which only
sees per-bin amplitude statistics).

Device estimator (frequency-smoothing/FFT-accumulation form): one
batched (F, N) FFT — the same transform batch the PSD pipeline uses —
then, for each of the K requested α lags (multiples of the bin width
rate/N), an elementwise shifted-product accumulation over frames. The
whole (K, N) surface comes from a single jitted step; α=0 recovers the
ordinary averaged PSD exactly.

Returned coherence is normalized: C^α(f) = |S^α(f)| /
sqrt(S⁰(f+α)·S⁰(f)) ∈ [0, 1] — the "spectral coherence", comparable
across signal powers.

The reference has no analogue (SURVEY §2: its only estimator is the
Bartlett average, datastore.cxx:82-85); this is an extension on the
same device pipeline and input conventions.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spectral import FrameSlicer, adapt_batch, dequant_iq, pad_frames


@functools.lru_cache(maxsize=8)
def _scf_step(N: int, F: int, K: int, windowed: bool):
    @jax.jit
    def step(raw, n_valid, *w):
        win = w[0] if w else None
        re, im = dequant_iq(raw, F, N, win)
        X = jnp.fft.fft(jax.lax.complex(re, im), axis=-1)
        mask = (jax.lax.broadcasted_iota(jnp.int32, (F, 1), 0)
                < n_valid).astype(jnp.float32)
        Xm = X * mask
        _, chunk = adapt_batch(F)
        g = F // chunk

        def tree(a):
            return a.reshape(g, chunk, N).sum(1).sum(0)

        # α-lag k: S[k, f] = Σ_m X_m[f+k]·conj(X_m[f]) (circular shift —
        # bins are already periodic in the DFT). k=0 is the plain PSD.
        outs_r = []
        outs_i = []
        for k in range(K):
            Xs = jnp.roll(Xm, -k, axis=-1)
            prod = Xs * jnp.conj(Xm)
            outs_r.append(tree(jnp.real(prod)))
            outs_i.append(tree(jnp.imag(prod)))
        return jnp.stack(outs_r), jnp.stack(outs_i)

    return step


def spectral_correlation(iq: np.ndarray, N: int, sample_rate: int,
                         max_alpha_bins: int = 16,
                         window: Optional[np.ndarray] = None,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spectral correlation surface of a recorded u8 IQ stream.

    iq: raw interleaved u8 bytes. Returns (alphas_hz (K,), scf (K, N)
    complex128 — the frame-averaged S^α, unshifted bins — and coherence
    (K, N) float64 in [0, 1]). Row 0 (α=0) is the ordinary averaged PSD
    (times the frame count normalization of the caller's choosing).

    α granularity is the bin width sample_rate/N; K = max_alpha_bins
    rows are computed (α = 0, Δf, 2Δf, ...).
    """
    if max_alpha_bins < 1 or max_alpha_bins > N:
        raise ValueError("max_alpha_bins must be in [1, N]")
    slicer = FrameSlicer(N)
    frames = slicer.push(np.asarray(iq, dtype=np.uint8).ravel())
    M = len(frames)
    if M == 0:
        raise ValueError("stream shorter than one FFT frame")
    F, _ = adapt_batch(min(M, 512))
    K = int(max_alpha_bins)
    win = None
    if window is not None:
        w = np.asarray(window, dtype=np.float32)
        if w.shape != (N,):
            raise ValueError(f"window must have shape ({N},)")
        win = jnp.asarray(w)
    step = _scf_step(N, F, K, win is not None)

    acc_r = np.zeros((K, N), dtype=np.float64)
    acc_i = np.zeros((K, N), dtype=np.float64)
    for start in range(0, M, F):
        batch = frames[start:start + F]
        nv = len(batch)
        args = (pad_frames(batch, F), jnp.int32(nv))
        r, i = step(*args, *( [win] if win is not None else [] ))
        acc_r += np.asarray(r, dtype=np.float64)
        acc_i += np.asarray(i, dtype=np.float64)

    scf = (acc_r + 1j * acc_i) / M
    psd = scf[0].real                        # S⁰(f) ≥ 0
    denom = np.sqrt(np.maximum(
        np.stack([np.roll(psd, -k) for k in range(K)]) * psd, 1e-300))
    coherence = np.abs(scf) / denom
    alphas = np.arange(K, dtype=np.float64) * sample_rate / N
    return alphas, scf, coherence
