"""Multi-host (2-process) distributed accumulation test: spawns two real
processes that form one 8-device global mesh over a local coordinator
and psum-reduce their streams' spectra across process boundaries —
the DCN path, exercised for real (no mocks)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from golden import golden_accumulate

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("N,backend", [(64, "auto"), (256, "hybrid")])
def test_two_process_psum_matches_golden(tmp_path, N, backend):
    """backend='hybrid' additionally exercises a fused rung's host-side
    u16 view through the global multihost Array assembly."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"p{i}.npy") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), coordinator, outs[i],
         str(N), backend],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    a = np.load(outs[0])
    b = np.load(outs[1])
    np.testing.assert_allclose(a, b, rtol=0)  # replicated result identical

    # Golden: sum over all 8 streams' float64 accumulations.
    F = 16
    want = np.zeros(N)
    for s in range(8):
        frames = np.random.default_rng(1000 + s).integers(
            0, 256, (F, 2 * N), dtype=np.uint8)
        pwr, _ = golden_accumulate(frames.ravel(), N, F)
        want += np.fft.ifftshift(pwr)
    np.testing.assert_allclose(a, want, rtol=1e-5)


def test_two_process_bigfft_all_to_all(tmp_path):
    """Sequence parallelism over DCN: one 4096-point transform sharded
    across the 2-process 8-device mesh — the all_to_all transpose
    crosses the process boundary for real. Both processes must see the
    identical replicated spectrum, matching the float64 numpy golden."""
    N = 4096
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"p{i}.npy") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), coordinator, outs[i],
         str(N), "bigfft"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost bigfft worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    a = np.load(outs[0])
    b = np.load(outs[1])
    np.testing.assert_allclose(a, b, rtol=0)

    F = 4
    frames = np.random.default_rng(2000).integers(
        0, 256, (F, 2 * N), dtype=np.uint8)
    z = (frames[:, 0::2].astype(np.float64) - 127.0) \
        + 1j * (frames[:, 1::2].astype(np.float64) - 127.0)
    want = (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(a, want, rtol=1e-5)
