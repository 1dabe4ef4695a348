"""Sharded long integration: one stream's frames spread over the mesh.

The 1M-point long-integration mode (BASELINE config 3) accumulates few,
enormous spectra. Power accumulation commutes with any partition of the
frame axis, so a single stream's frame batch can be sharded across
devices exactly like independent streams — each device transforms its
frame subset and one psum yields the total. This is the "sequence
parallelism" of this workload: the long axis is integration time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.spectral import pad_frames
from .mesh import make_mesh
from .sharded import ShardedPsdStep

# Step cache: jax.jit caches per function OBJECT, so rebuilding the
# ShardedPsdStep every call would retrace + recompile identical shapes
# (seconds per shape). Windowed steps key on the window
# BYTES so a different window array correctly rebuilds.
_step_cache: dict = {}


def _cached_step(mesh, N: int, per_dev: int, window, backend: str):
    wkey = None if window is None else np.asarray(window).tobytes()
    key = (id(mesh), N, per_dev, wkey, backend)
    step = _step_cache.get(key)
    if step is None:
        step = ShardedPsdStep(mesh, N, per_dev, streams=mesh.devices.size,
                              window=window, backend=backend)
        _step_cache.clear()  # keep at most one live step's constants
        _step_cache[key] = step
    return step


def sharded_accumulate(frames: np.ndarray, N: int,
                       window: Optional[np.ndarray] = None,
                       mesh=None, backend: str = "auto",
                       ) -> Tuple[np.ndarray, int]:
    """Accumulate |FFT|² over all frames, frame axis sharded on the mesh.

    frames: (M, 2N) u8. Returns (pwr (N,) float64 unshifted, M).
    Numerically identical to a single-device accumulation (the per-device
    partials use the same two-stage f32 sums; the psum adds D partials).
    """
    if mesh is None:
        mesh = make_mesh()
    D = mesh.devices.size
    M = len(frames)
    if M == 0:
        raise ValueError("no frames to accumulate")
    # Rows per device, padded so the (D, F, 2N) batch is rectangular.
    per_dev = -(-M // D)
    step = _cached_step(mesh, N, per_dev, window, backend)
    batch = np.zeros((D, step.F, 2 * N), dtype=np.uint8)
    n_valid = np.zeros(D, dtype=np.int32)
    for d in range(D):
        part = frames[d * per_dev:(d + 1) * per_dev]
        n_valid[d] = len(part)
        if len(part):
            batch[d] = pad_frames(part, step.F)
    _, combined = step(batch, n_valid)
    return np.asarray(combined, dtype=np.float64), M
