"""2-D mesh composition: parallel streams × sequence-sharded transforms.

The 1-D parallel modes each scale ONE axis: `sharded.py` spreads
independent streams (data parallelism — BASELINE config 5), `bigfft.py`
spreads a single huge transform (sequence parallelism — the 1M-point
mode). A pod running many streams of very large spectra wants BOTH at
once: a (streams, seq) 2-D `jax.sharding.Mesh` where

  * each stream group lives on one row of the mesh (its frames never
    leave the row),
  * within a row, every transform is the distributed four-step of
    bigfft.py — stage-1 FFT, column twiddle, `all_to_all` over the
    `seq` axis (the distributed transpose stays within the row),
    stage-2 FFT,
  * the per-row power partials are combined by ONE `psum` over the
    `stream` axis at the end (power accumulation commutes with any
    partition of the stream/frame axes).

The reference's analogue is "average many spectra" on one core
(datastore.cxx:81-87 + the outer repeats loop); the composition itself
has no analogue — it lays the heavy all_to_all on one mesh axis and the
cheap once-per-accumulation psum on the other.

Validated on the forced-CPU multi-device harness with 2×4 / 4×2 meshes
(tests/test_sharding.py) and exercised by ``__graft_entry__``'s
multi-chip dry run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
try:                                    # jax >= 0.8
    from jax import shard_map
except ImportError:                     # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .bigfft import _split, fourstep_local_core, u16_frames


def make_grid_mesh(streams_axis: int, seq_axis: int,
                   devices=None) -> Mesh:
    """A (streams, seq) 2-D mesh over ``streams_axis · seq_axis``
    devices (defaults to all visible)."""
    devs = np.asarray(devices if devices is not None
                      else jax.devices()[:streams_axis * seq_axis])
    if devs.size != streams_axis * seq_axis:
        raise ValueError(
            f"need {streams_axis * seq_axis} devices, have {devs.size}")
    return Mesh(devs.reshape(streams_axis, seq_axis), ("stream", "seq"))


class GridPsdStep:
    """Streams × sequence PSD accumulator on a 2-D mesh.

    Input: (S, F, 2N) u8 IQ frames — S stream groups, F frames each —
    with per-stream valid counts. Each group is assigned to one
    ``stream``-axis row; its transforms are sequence-sharded over the
    row's ``seq`` devices. Returns the ShardedPsdStep pair: per-stream
    (S, N) float32 partials (sharded) and the psum-combined (N,)
    replicated partial, both in the session's standard unshifted bin
    layout — so MultiStreamAcquisition can drive either step type.
    """

    def __init__(self, mesh: Mesh, N: int, F: int,
                 window: Optional[np.ndarray] = None):
        if set(mesh.axis_names) != {"stream", "seq"}:
            raise ValueError(
                f"GridPsdStep needs a ('stream', 'seq') mesh, got "
                f"{mesh.axis_names}")
        if N & (N - 1):
            raise ValueError(f"N={N} must be a power of two")
        Ds = mesh.shape["stream"]
        Dq = mesh.shape["seq"]
        N1, N2 = _split(N)
        if N1 % Dq or N2 % Dq:
            raise ValueError(
                f"seq axis {Dq} must divide both N1={N1} and N2={N2}")
        self.mesh = mesh
        self.N, self.N1, self.N2, self.F = N, N1, N2, F
        self.S, self.Dq = Ds, Dq
        #: PsdStep.path introspection contract (session banner/stats).
        self.path = "bigfft-grid"

        if window is not None:
            if len(window) != N:
                raise ValueError("window length != N")
            w2d = np.asarray(window, np.float32).reshape(N1, N2)
        else:
            w2d = None

        def local_step(x_u16, n_valid, *wargs):
            # x_u16: (1, F, N1, N2/Dq) — this device's columns of its
            # row's stream group; n_valid: (1,) i32. The transform
            # pipeline is the shared distributed four-step core; naming
            # only the seq axis keeps each row's all_to_all within the
            # row, untouched by other rows.
            part = fourstep_local_core(x_u16[0], n_valid[0], axis="seq",
                                       N=N, N1=N1, N2=N2, D=Dq, F=F,
                                       wargs=wargs)       # (N1/Dq, N2)
            # Combine the stream groups: one psum over the other axis.
            return part[None], jax.lax.psum(part, "stream")

        in_specs = [P("stream", None, None, "seq"), P("stream")]
        wextra = []
        if w2d is not None:
            in_specs.append(P())
            wextra = [jnp.asarray(w2d)]
        self._window_dev = wextra

        sharded = shard_map(local_step, mesh=mesh,
                            in_specs=tuple(in_specs),
                            out_specs=(P("stream", "seq", None),
                                       P("seq", None)))

        def flat_fn(x_u16, n_valid, *wargs):
            ps, comb = sharded(x_u16, n_valid, *wargs)
            # Flat bin k = k1 + N1·k2, the framework's standard
            # unshifted layout (fftshift once at finalization).
            ps_flat = jnp.swapaxes(ps, 1, 2).reshape(Ds, N)
            flat = jnp.swapaxes(comb, 0, 1).reshape(N)
            return ps_flat, jax.lax.with_sharding_constraint(
                flat, NamedSharding(mesh, P()))

        self._fn = jax.jit(flat_fn)
        self._x_sharding = NamedSharding(mesh, P("stream", None, None, "seq"))

    def prepare(self, frames_u8: np.ndarray):
        """(S, F', 2N) u8 → sharded (S, F, N1, N2) u16 device input
        (free u16 view, zero-padded to F frames per stream)."""
        S, Fp = frames_u8.shape[:2]
        if S != self.S or Fp > self.F:
            raise ValueError(
                f"batch {frames_u8.shape[:2]} vs step (S={self.S}, "
                f"F<={self.F})")
        x = u16_frames(frames_u8, self.F, self.N) \
            .reshape(S, self.F, self.N1, self.N2)
        return jax.device_put(x, self._x_sharding)

    def __call__(self, frames_u8: np.ndarray, n_valid):
        """One device step — the ShardedPsdStep calling convention:
        ``(S, F', 2N) u8`` frames + per-stream valid counts →
        ``((S, N) per-stream, (N,) combined)`` float32 device arrays
        (async; ``np.asarray`` forces completion)."""
        x = self.prepare(frames_u8)
        nv = np.asarray(n_valid, np.int32).reshape(self.S)
        return self._fn(x, jnp.asarray(nv), *self._window_dev)

    def accumulate(self, frames_u8: np.ndarray,
                   n_valid) -> Tuple[np.ndarray, int]:
        """Synchronous convenience: ((N,) float64 unshifted power sum
        over every stream's valid frames, total frames)."""
        _, comb = self(frames_u8, n_valid)
        total = int(np.asarray(n_valid, np.int64).sum())
        return np.asarray(comb, dtype=np.float64), total
