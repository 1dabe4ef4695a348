"""Multi-host (DCN) stream ingestion: each host feeds its local IQ
streams; the averaged spectrum reduces over all hosts with one psum.

The reference is strictly single-process; this is the framework's
scale-out story (SURVEY §5 "DCN only if multi-host streams are in
scope"): a global 1-D ``stream`` mesh spans every device of every
process, each process builds the global batch from its *local* shards
(no host ever sees another host's samples), and the combined (N,)
spectrum comes back replicated everywhere. Collectives ride the intra-host links
within a host and DCN across hosts — chosen by XLA, not by this code.

Tested for real with two CPU processes × 4 virtual devices
(tests/test_multihost.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the distributed runtime (idempotent per process)."""
    import jax
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def global_stream_mesh():
    """1-D ``stream`` mesh over ALL devices of ALL processes."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), ("stream",))


class MultiHostPsdStep:
    """Per-process wrapper over ShardedPsdStep for a global stream mesh.

    Each process calls it with its LOCAL streams' frame batches
    (streams_local = streams_global / num_processes, one stream per local
    device by default); the return value is the globally psum-combined
    (N,) partial power sum, replicated on every process.
    """

    def __init__(self, N: int, frames_per_step: int,
                 window: Optional[np.ndarray] = None,
                 backend: str = "auto",
                 streams_per_device: int = 1):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .sharded import ShardedPsdStep

        self.mesh = global_stream_mesh()
        n_global = self.mesh.devices.size
        self.streams_global = n_global * streams_per_device
        self.streams_local = len(jax.local_devices()) * streams_per_device
        self.step = ShardedPsdStep(self.mesh, N, frames_per_step,
                                   streams=self.streams_global,
                                   window=window, backend=backend)
        self.N = N
        self.F = self.step.F
        self._sharding = NamedSharding(self.mesh, P("stream"))

    def _globalize(self, local: np.ndarray, global_shape) -> "object":
        """Assemble a global Array from this process's local shard."""
        import jax
        locals_ = jax.local_devices()
        per_dev = local.shape[0] // len(locals_)
        shards = [jax.device_put(local[i * per_dev:(i + 1) * per_dev], d)
                  for i, d in enumerate(locals_)]
        return jax.make_array_from_single_device_arrays(
            global_shape, self._sharding, shards)

    def __call__(self, local_raw: np.ndarray,
                 local_n_valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """local_raw: (S_local, F, 2N) u8; local_n_valid: (S_local,) i32.
        Returns (per_stream_local (S_local, N) f64, combined (N,) f64)."""
        import jax
        # Real validation, not assert: under `python -O` a wrong stream
        # count would silently truncate rows inside _globalize's
        # per-device split, producing a wrong combined spectrum.
        if local_raw.shape != (self.streams_local, self.F, 2 * self.N):
            raise ValueError(
                f"local_raw shape {local_raw.shape} != expected "
                f"({self.streams_local}, {self.F}, {2 * self.N})")
        if np.asarray(local_n_valid).shape != (self.streams_local,):
            raise ValueError(
                f"local_n_valid must have shape ({self.streams_local},)")
        local8 = np.ascontiguousarray(local_raw, dtype=np.uint8)
        if self.step.takes_u16:
            # The fused-kernel path takes the IQ pairs as u16 lanes; the
            # view must happen host-side, BEFORE assembling the global
            # Array (a device-side bitcast is a real relayout pass).
            raw = self._globalize(
                local8.view(np.uint16),
                (self.streams_global, self.F, self.N))
        else:
            raw = self._globalize(
                local8, (self.streams_global, self.F, 2 * self.N))
        nv = self._globalize(
            np.asarray(local_n_valid, dtype=np.int32),
            (self.streams_global,))
        per_stream, combined = self.step(raw, nv)
        local_ps = np.concatenate(
            [np.asarray(s.data) for s in per_stream.addressable_shards])
        return (local_ps.astype(np.float64),
                np.asarray(combined.addressable_data(0), dtype=np.float64))
