"""Benchmark scripts refuse to measure anywhere but an NVIDIA GPU.

A time taken on the CPU backend must never be reported as a device time:
off the GPU each script exits non-zero, prints nothing on stdout, and
says why on stderr. (The measurement itself runs on the card.)
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.mark.parametrize("script", ["bench.py", "bench_configs.py",
                                    "bench_bands.py"])
def test_benchmark_exits_nonzero_off_the_gpu(script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 1, (r.returncode, r.stderr[-2000:])
    assert r.stdout.strip() == ""
    assert "needs an NVIDIA GPU; JAX found cpu" in r.stderr
