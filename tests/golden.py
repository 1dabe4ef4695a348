"""Golden reference: a literal numpy transcription of the reference's
compute path, used to pin numerical semantics.

Transcribes datastore.cxx:48-96 (dequant, (−1)^n phase flip, window, FFT,
|X|² accumulation in float64) and acquisition.cxx:376-399 (DC interpolation,
normalization, dB, baseline), computed in float64 throughout so it serves
as ground truth for both the FFTW-float32 original and the device float32
pipeline (each should match it to ~1e-6·N relative).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def golden_accumulate(stream: np.ndarray, N: int, repeats: int,
                      window: Optional[np.ndarray] = None) -> tuple[np.ndarray, int]:
    """Process a raw u8 byte stream exactly like Datastore::fftThread.

    Returns (pwr[N] float64 — already phase-flip 'pre-shifted' like the
    reference, repeats_done).
    """
    stream = np.asarray(stream, dtype=np.uint8).ravel()
    pwr = np.zeros(N, dtype=np.float64)
    repeats_done = 0
    n_frames = min(len(stream) // (2 * N), repeats)
    for f in range(n_frames):
        chunk = stream[f * 2 * N:(f + 1) * 2 * N].astype(np.float64)
        re = chunk[0::2] - 127.0
        im = chunk[1::2] - 127.0
        z = re + 1j * im
        # (−1)^n phase flip (datastore.cxx:69-75)
        z = z * np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
        if window is not None:
            z = z * np.asarray(window, dtype=np.float64)
        X = np.fft.fft(z)
        pwr += X.real ** 2 + X.imag ** 2
        repeats_done += 1
    return pwr, repeats_done


def golden_finalize(pwr: np.ndarray, repeats_done: int, actual_samplerate: int,
                    linear: bool = False,
                    baseline: Optional[np.ndarray] = None) -> np.ndarray:
    """acquisition.cxx:376-399 in float64. ``pwr`` is the pre-shifted
    accumulator (as the reference stores it)."""
    pwr = np.array(pwr, dtype=np.float64)
    N = len(pwr)
    pwr[N // 2] = (pwr[N // 2 - 1] + pwr[N // 2 + 1]) / 2.0
    out = np.empty(N, dtype=np.float64)
    for i in range(N):
        v = pwr[i] / repeats_done / N / actual_samplerate
        if not linear:
            v = 10.0 * np.log10(v)
        if baseline is not None:
            v -= baseline[i]
        out[i] = v
    return out
