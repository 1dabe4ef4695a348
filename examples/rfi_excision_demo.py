#!/usr/bin/env python
"""Real-time SK RFI excision end-to-end: bursty interference is removed
from the average while the clean-time spectrum survives.

Builds a recording of Gaussian noise with a strong tone burst present in
2 of 8 accumulation blocks, then runs the session pipeline twice — plain
and with ``--sk-excise 3`` — and prints the contaminated bin before and
after, plus the per-bin spectral-kurtosis sidecar values around it.

No hardware needed; runs on CPU or GPU alike.

Usage: python examples/rfi_excision_demo.py
"""
import io
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtl_power_fftw_tpu.auxdata import AuxData            # noqa: E402
from rtl_power_fftw_tpu.config import parse_args          # noqa: E402
from rtl_power_fftw_tpu.session import run_session        # noqa: E402
from rtl_power_fftw_tpu.sources import FileSource         # noqa: E402

N, F, BLOCKS = 256, 256, 8          # 256 bins, 256-spectra SK blocks
RATE = 2_048_000


def make_recording(path: str) -> None:
    repeats = F * BLOCKS
    rng = np.random.default_rng(7)
    iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
    t = np.arange(N * F)
    burst = 45.0 * np.exp(2j * np.pi * 40 * t / N)   # bin 40, unshifted
    for b in (2, 5):                                  # bursts in 2/8 blocks
        lo = 2 * N * F * b
        iq[lo:lo + 2 * N * F:2] += burst.real
        iq[lo + 1:lo + 2 * N * F:2] += burst.imag
    with open(path, "wb") as f:
        f.write(np.clip(np.round(iq), 0, 255).astype(np.uint8).tobytes())


def run(path: str, extra):
    argv = ["-f", "100M", "-b", str(N), "-n", str(F * BLOCKS),
            "--frames-per-step", str(F), "--source", f"file:{path}"] + extra
    params = parse_args(argv, stderr=io.StringIO())
    out, err = io.StringIO(), io.StringIO()
    rv = run_session(params, FileSource(path, use_native=False),
                     AuxData(params, stderr=io.StringIO()),
                     stdout=out, stderr=err, install_sigint=False)
    assert int(rv) == 0, err.getvalue()
    rows = [l.split() for l in out.getvalue().split("\n")
            if l and not l.startswith("#")]
    return (np.array([float(r[0]) for r in rows]),
            np.array([float(r[1]) for r in rows]), err.getvalue())


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        rec = os.path.join(d, "bursty.iq")
        sk_path = os.path.join(d, "sk.dat")
        make_recording(rec)

        freqs, raw, _ = run(rec, [])
        _, clean, err = run(rec, ["--sk-excise", "3", "--sk-file", sk_path])

        bin_i = int(np.argmax(raw))
        floor = float(np.median(raw))
        print(f"burst bin @ {freqs[bin_i]/1e6:.4f} MHz "
              f"(noise floor {floor:.1f} dB):")
        print(f"  plain average : {raw[bin_i]:7.2f} dB   "
              f"(+{raw[bin_i]-floor:.1f} dB of burst contamination)")
        print(f"  --sk-excise 3 : {clean[bin_i]:7.2f} dB   "
              "(clean-time average recovered)")
        summary = [l for l in err.split("\n") if "SK excision" in l]
        if summary:
            print(f"  {summary[0].strip()}")

        sk_rows = [l.split() for l in open(sk_path)
                   if l.strip() and not l.startswith("#")]
        skv = np.array([float(r[1]) for r in sk_rows])
        print(f"  sidecar SK    : burst bin {skv[bin_i]:.3f} "
              "(intermittent power drives SK >> 1; a steady tone "
              "would read << 1), off-tone median "
              f"{np.median(np.delete(skv, bin_i)):.3f} (Gaussian ~ 1)")


if __name__ == "__main__":
    main()
