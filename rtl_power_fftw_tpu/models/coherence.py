"""Cross-spectral density and magnitude-squared coherence of two IQ
streams.

The two-antenna companion to the PSD estimators: averaging the complex
cross-spectrum X·conj(Y) over frames reveals signals common to both
streams (interferometry/correlation spectroscopy — the natural next step
for the reference's radio-astronomy use case, which only ever saw one
receiver). Coherence γ² = |Sxy|² / (Sxx·Syy) ∈ [0, 1] measures how
correlated each bin is.

One fused step accumulates Sxx, Syy and the complex Sxy
(as re/im planes) in a single pass over both streams' frame batches —
four (N,)-sized outputs per step, everything else stays on-chip.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spectral import (FrameSlicer, adapt_batch, bin_frequencies,
                            dequant_iq, pad_frames)


@functools.lru_cache(maxsize=8)
def _csd_step(N: int, F: int, windowed: bool):
    @jax.jit
    def step(raw_x, raw_y, n_valid, *w):
        win = w[0] if w else None
        rex, imx = dequant_iq(raw_x, F, N, win)
        rey, imy = dequant_iq(raw_y, F, N, win)
        X = jnp.fft.fft(jax.lax.complex(rex, imx), axis=-1)
        Y = jnp.fft.fft(jax.lax.complex(rey, imy), axis=-1)
        mask = (jax.lax.broadcasted_iota(jnp.int32, (F, 1), 0)
                < n_valid).astype(jnp.float32)
        sxx = (jnp.real(X) ** 2 + jnp.imag(X) ** 2) * mask
        syy = (jnp.real(Y) ** 2 + jnp.imag(Y) ** 2) * mask
        cross = X * jnp.conj(Y)
        sxy_re = jnp.real(cross) * mask
        sxy_im = jnp.imag(cross) * mask
        _, chunk = adapt_batch(F)
        g = F // chunk

        def tree(a):
            return a.reshape(g, chunk, N).sum(1).sum(0)

        return tree(sxx), tree(syy), tree(sxy_re), tree(sxy_im)

    return step


def coherence(iq_x: np.ndarray, iq_y: np.ndarray, N: int, sample_rate: int,
              center_freq: int = 0,
              repeats: Optional[int] = None,
              window: Optional[np.ndarray] = None,
              frames_per_step: int = 512
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Magnitude-squared coherence and complex CSD of two u8 IQ streams.

    Returns (freqs[N], gamma2[N] in [0,1], csd[N] complex128 — the
    averaged cross-spectral density, normalized like the PSD estimators:
    /M/N/rate), all fftshifted to the output bin order.
    """
    sx = FrameSlicer(N)
    sy = FrameSlicer(N)
    fx = sx.push(iq_x, max_frames=repeats)
    fy = sy.push(iq_y, max_frames=repeats)
    M = min(len(fx), len(fy))
    if M < 2:
        raise ValueError("coherence needs at least 2 frames in each stream")
    fx, fy = fx[:M], fy[:M]

    F, _ = adapt_batch(min(frames_per_step, M))
    step = _csd_step(N, F, window is not None)
    w = ((jnp.asarray(np.asarray(window, np.float32)),)
         if window is not None else ())

    sxx = np.zeros(N, np.float64)
    syy = np.zeros(N, np.float64)
    sxy = np.zeros(N, np.complex128)
    for start in range(0, M, F):
        bx = pad_frames(fx[start:start + F], F)
        by = pad_frames(fy[start:start + F], F)
        nv = min(len(fx[start:start + F]), F)
        a, b, cr, ci = step(bx, by, np.int32(nv), *w)
        sxx += np.asarray(a, np.float64)
        syy += np.asarray(b, np.float64)
        sxy += np.asarray(cr, np.float64) + 1j * np.asarray(ci, np.float64)

    shift = np.fft.fftshift
    sxx_s, syy_s, sxy_s = shift(sxx), shift(syy), shift(sxy)
    # DC-bin interpolation, like every PSD output (acquisition.cxx:376-377):
    # the deterministic (u8−127) quantizer offset is common to BOTH
    # streams, so without this the DC bin shows spurious coherence ~1 even
    # for fully independent receivers.
    c = N // 2
    for arr in (sxx_s, syy_s, sxy_s):
        arr[c] = (arr[c - 1] + arr[c + 1]) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        gamma2 = np.abs(sxy_s) ** 2 / np.maximum((sxx_s * syy_s).real, 1e-300)
    csd = sxy_s / M / N / sample_rate
    return bin_frequencies(center_freq, N, sample_rate), gamma2, csd
