"""CLI surface tests: help/version exits, module invocation, exit codes."""

import subprocess
import sys

import pytest

from rtl_power_fftw_tpu.cli import main


def run_cli(args):
    """Invoke in-process; argparse help/version raise SystemExit."""
    try:
        return main(args)
    except SystemExit as e:
        return e.code if e.code is not None else 0


def test_help_exits_zero(capsys):
    assert run_cli(["--help"]) == 0
    out = capsys.readouterr().out
    for opt in ("--bins", "--freq", "--repeats", "--time", "--baseline",
                "--window", "--matrix", "--overlap", "--strict-time",
                "--source", "--streams"):
        assert opt in out


def test_version_exits_zero(capsys):
    assert run_cli(["--version"]) == 0
    assert "rtl_power_fftw_tpu" in capsys.readouterr().out


def test_exit_code_table():
    # (argv, expected exit code) — the reference's ReturnValue contract.
    cases = [
        (["-n", "1"], 1),                        # NoDeviceFound
        (["-d", "2", "--source", "synthetic:", "-n", "1", "-b", "64"], 2),
        (["-b", "-5"], 3),                       # InvalidArgument
        (["--bogus-flag"], 4),                   # CLI parse error
        (["-w", "/does/not/exist", "-n", "1"], 5),  # InvalidInput
    ]
    for argv, expect in cases:
        assert run_cli(argv) == expect, argv


def test_window_via_stdin_subprocess(tmp_path):
    """The real `-w -` stdin path through the module entry point."""
    import os
    import subprocess
    N = 64
    window_text = "".join("1.0\n" for _ in range(N))
    env = {k: v for k, v in os.environ.items()}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "rtl_power_fftw_tpu", "-f", "1M", "-n", "8",
         "-b", str(N), "-w", "-", "--source", "synthetic:noise=5"],
        input=window_text, capture_output=True, text=True, timeout=120,
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-500:]
    assert "Succesfully read 64 window function points." in proc.stderr
    data_lines = [l for l in proc.stdout.splitlines()
                  if l and not l.startswith("#")]
    assert len(data_lines) == N


def test_device_runtime_error_maps_to_hardware_exit(monkeypatch, capsys):
    """A device-side runtime failure (lost device, device OOM) exits 7 with
    a clean message — the reference's hardware-error semantics
    (exceptions.h:25-34) — instead of a traceback."""
    import jax.errors

    import rtl_power_fftw_tpu.cli as cli

    def boom(*a, **k):
        raise jax.errors.JaxRuntimeError("DEVICE_LOST: device dropped")

    monkeypatch.setattr(cli, "run_session", boom)
    rc = cli.main(["-f", "1M", "-n", "4", "-b", "64",
                   "--source", "synthetic:"])
    assert rc == 7
    assert "Device runtime error" in capsys.readouterr().err
