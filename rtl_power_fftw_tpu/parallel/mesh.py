"""Device-mesh helpers.

The reference's only concurrency is a 2-thread producer/consumer pipe on
one CPU (SURVEY §2 parallelism block).  The device-mesh scaling axes are:

* ``stream`` — independent IQ streams (data parallelism): each device owns
  a subset of streams and accumulates its own spectra; averaging across
  streams is one ``psum`` (BASELINE.json config 5);
* ``bin`` — for huge transforms (the 1M-point mode), the frame axis can
  also be sharded so each device FFTs a slice of the frame batch and the
  accumulated |X|² is psum-reduced — numerically identical because power
  accumulation commutes with any partition of the frames.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("stream",)) -> Mesh:
    """Build a 1-D (default) mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available")
    dev = np.array(devices[:n_devices])
    if len(axis_names) == 1:
        return Mesh(dev, axis_names)
    raise ValueError("only 1-D meshes are used in this framework")
