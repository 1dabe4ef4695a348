#!/usr/bin/env python
"""Tour of the library estimators on one synthetic capture.

Generates a short IQ capture (a 30 dB tone over noise) with the same
synthetic source the CLI uses, then runs every estimator in
``rtl_power_fftw_tpu.models`` over it and prints a one-line summary
each. No hardware needed; runs on CPU or GPU alike.

Usage: python examples/estimators_demo.py [seconds]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtl_power_fftw_tpu.models import (   # noqa: E402
    bartlett_psd, welch_psd, multitaper_psd, spectral_kurtosis,
    spectrogram, coherence, spectral_correlation, pfb_psd)
from rtl_power_fftw_tpu.sources.registry import make_source  # noqa: E402

RATE = 2_048_000
N = 1024


def main() -> None:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    src = make_source("synthetic:tone=100.3M/30,noise=6,seed=42", RATE)
    assert src.sample_rate() == RATE  # make_source applies the rate
    src.set_frequency(100_000_000)
    iq, _ = src.read(int(2 * RATE * seconds))
    print(f"capture: {iq.size // 2} samples @ {RATE/1e6:.3f} MS/s")

    freqs, psd = bartlett_psd(iq, N, RATE, center_freq=100_000_000)
    peak = freqs[np.argmax(psd)]
    print(f"bartlett_psd:        peak {psd.max():7.2f} dB @ {peak/1e6:.4f} MHz")

    freqs, psd = welch_psd(iq, N, RATE, center_freq=100_000_000,
                           overlap_percent=50.0)
    print(f"welch_psd (50%):     peak {psd.max():7.2f} dB @ "
          f"{freqs[np.argmax(psd)]/1e6:.4f} MHz")

    freqs, psd = multitaper_psd(iq, N, RATE, center_freq=100_000_000, NW=4.0)
    print(f"multitaper_psd NW=4: peak {psd.max():7.2f} dB @ "
          f"{freqs[np.argmax(psd)]/1e6:.4f} MHz")

    freqs, sk, psd_lin = spectral_kurtosis(iq, N, RATE,
                                           center_freq=100_000_000)
    tone_bin = int(np.argmax(psd_lin))
    print(f"spectral_kurtosis:   SK@tone {sk[tone_bin]:.3f} "
          f"(deterministic tone → SK below the noise's ~1)")

    times, freqs, S = spectrogram(iq, N, RATE, center_freq=100_000_000,
                                  average=4)
    print(f"spectrogram:         {S.shape[0]} rows x {S.shape[1]} bins, "
          f"{times[-1]*1e3:.1f} ms span")

    half = (iq.size // 4) * 2
    freqs, gamma2, _ = coherence(iq[:half], iq[half:2 * half], N, RATE)
    print(f"coherence:           median gamma^2 {np.median(gamma2):.3f} "
          "(independent halves → ~0)")

    freqs, psd = pfb_psd(iq, N, RATE, center_freq=100_000_000, taps=4)
    print(f"pfb_psd (4-tap):     peak {psd.max():7.2f} dB @ "
          f"{freqs[np.argmax(psd)]/1e6:.4f} MHz "
          "(sharper channel isolation than the plain FFT)")

    alphas, scf, coh = spectral_correlation(iq[:2 * 64 * N], N, RATE,
                                            max_alpha_bins=8)
    print(f"spectral_correlation: {len(alphas)} cyclic freqs x {N} bins; "
          f"alpha=0 row is the PSD (max |S^0| {np.abs(scf[0]).max():.3e})")


if __name__ == "__main__":
    main()
