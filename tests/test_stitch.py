"""Hop-overlap stitching (utils/stitch.py): merging math, text-format
round trip, the scan estimator's merge mode, and the CLI entry."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from rtl_power_fftw_tpu.models.scan import plan_hop_freqs, scan_psd
from rtl_power_fftw_tpu.utils.stitch import main, merge_spectra, parse_text


def test_merge_disjoint_concatenates():
    f1 = np.arange(0.0, 10.0)
    f2 = np.arange(20.0, 30.0)
    got_f, got_v = merge_spectra([(f1, np.zeros(10)), (f2, np.ones(10) * 10)])
    np.testing.assert_array_equal(got_f, np.concatenate([f1, f2]))
    np.testing.assert_allclose(got_v[:10], 0.0, atol=1e-12)
    np.testing.assert_allclose(got_v[10:], 10.0, atol=1e-12)


def test_merge_overlap_averages_linear_power():
    # Overlap region: 0 dB and 10 dB average to ~7.40 dB (linear mean of
    # 1 and 10 is 5.5), NOT 5 dB — the dB-domain mean would be biased.
    f1 = np.arange(0.0, 10.0)
    f2 = np.arange(5.0, 15.0)
    got_f, got_v = merge_spectra([(f1, np.zeros(10)), (f2, np.full(10, 10.0))])
    assert len(got_f) == 15
    expect = 10.0 * np.log10(5.5)
    np.testing.assert_allclose(got_v[5:10], expect, atol=1e-9)


def test_merge_linear_domain():
    f = np.arange(0.0, 4.0)
    got_f, got_v = merge_spectra([(f, np.full(4, 2.0)), (f, np.full(4, 4.0))],
                                 db=False)
    np.testing.assert_allclose(got_v, 3.0)


def test_merge_snaps_offgrid_centers():
    # Second hop offset by 0.25 of a bin: snaps onto the common grid.
    f1 = np.arange(0.0, 8.0)
    f2 = np.arange(4.25, 12.25)
    got_f, got_v = merge_spectra([(f1, np.zeros(8)), (f2, np.zeros(8))])
    np.testing.assert_array_equal(got_f, np.arange(0.0, 12.0))


def test_parse_text_sets_and_spectra():
    text = (
        "# rtl-power-fftw output\n"
        "# Acquisition start: x\n"
        "100 1.5\n101 2.5\n"
        "\n"
        "# second hop\n"
        "102 3.5\n103 4.5\n"
        "\n\n"
        "# next measurement set\n"
        "100 9\n101 9\n"
        "\n\n")
    sets = parse_text(io.StringIO(text))
    assert len(sets) == 2
    assert len(sets[0]) == 2
    np.testing.assert_array_equal(sets[0][1][0], [102.0, 103.0])
    np.testing.assert_array_equal(sets[1][0][1], [9.0, 9.0])


def test_scan_merge_mode_places_tone_once():
    """End-to-end: overlapping synthetic hop captures -> scan_psd merge
    mode -> single wideband spectrum with the tone at its absolute RF."""
    N, rate = 256, 2_048_000
    hops = plan_hop_freqs(100_000_000, 104_000_000, rate, min_overlap=20.0)
    assert len(hops) >= 2
    tone_rf = 101_500_000.0
    frames = 16
    rng = np.random.default_rng(0)
    caps = []
    for hf in hops:
        t = np.arange(frames * N)
        x = 2.0 * (rng.standard_normal(frames * N)
                   + 1j * rng.standard_normal(frames * N))
        if abs(tone_rf - hf) < rate / 2:   # in-band only (a real front end
            x = x + 50.0 * np.exp(          # filters out-of-band signals)
                2j * np.pi * ((tone_rf - hf) / rate) * t)
        re = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
        im = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
        caps.append(np.stack([re, im], axis=-1).reshape(-1))
    freqs, psd = scan_psd(np.stack(caps), hops, N, rate, stitch="merge")
    assert np.all(np.diff(freqs) > 0)          # one sorted wideband axis
    peak = freqs[int(np.argmax(psd))]
    assert abs(peak - tone_rf) < rate / N + 1  # within one bin


def test_cli_stitches_file(tmp_path):
    text = ("# header\n100 0\n101 0\n\n# hop 2\n101 10\n102 10\n\n\n")
    p = tmp_path / "scan.dat"
    p.write_text(text)
    out = io.StringIO()
    rc = main([str(p)], stdout=out)
    assert rc == 0
    lines = [l for l in out.getvalue().splitlines()
             if l and not l.startswith("#")]
    assert len(lines) == 3                      # bins 100, 101, 102
    v101 = float(lines[1].split()[1])
    np.testing.assert_allclose(v101, 10.0 * np.log10(5.5), atol=1e-4)


def test_cli_module_entry(tmp_path):
    p = tmp_path / "scan.dat"
    p.write_text("100 1\n101 1\n\n")
    r = subprocess.run(
        [sys.executable, "-m", "rtl_power_fftw_tpu.stitch", str(p)],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "stitched spectrum" in r.stdout


def test_cli_empty_input_errors():
    err = io.StringIO()
    rc = main(["/dev/null"], stderr=err)
    assert rc == 1


def test_cli_linear_mode(tmp_path):
    p = tmp_path / "scan.dat"
    p.write_text("100 2\n101 2\n\n101 4\n102 4\n\n\n")
    out = io.StringIO()
    rc = main([str(p), "--linear"], stdout=out)
    assert rc == 0
    lines = [l.split() for l in out.getvalue().splitlines()
             if l and not l.startswith("#")]
    # overlap bin 101: plain mean of 2 and 4 (no delog in --linear mode)
    np.testing.assert_allclose(float(lines[1][1]), 3.0)
