"""Sequence-sharded large-N PSD: ONE transform spread across the mesh.

The other parallel modes shard independent work (streams, or whole
frames — longint.py); this module shards a SINGLE huge transform, the
true sequence parallelism of the 1M-point long-integration mode
(BASELINE config 3, SURVEY §5 "long-context" row): each device holds a
1/D slice of every frame, so N can exceed one device's working set and
the per-spectrum latency scales down with the mesh.

Algorithm — the classic distributed four-step (transpose) FFT, mapped
to device-mesh collectives:

    frame x[n], n = n1·N2 + n2, viewed as (N1, N2), sharded on n2
    1. local FFT over n1 (length N1) for the device's n2 columns
    2. local twiddle by W_N^(n2·k1) (n2 offset from the mesh position)
    3. lax.all_to_all over the mesh: (k1 full, n2 block) →
       (k1 block, n2 full) — the distributed transpose
    4. local FFT over n2 (length N2)
    5. masked |X|² frame reduction → per-device (N1/D, N2) partial bins

Output bins come out unshifted in the k = k1 + N1·k2 convention shared
with the fused kernel and ops.spectral (fftshift once at finalization —
same math as the reference's (−1)^n input flip, datastore.cxx:69-75).

The reference has no analogue (FFTW on one core, datastore.cxx:81);
this is what "scale the sequence axis over the mesh" means.
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

from ..ops.spectral import dequant_iq_u16
from .mesh import make_mesh


def _split(N: int) -> Tuple[int, int]:
    """Balanced power-of-two N = N1·N2 (N1 ≤ N2)."""
    n1 = 1 << (int(N).bit_length() - 1 >> 1)
    return n1, N // n1


def column_twiddle(N: int, N1: int, cols: int, d):
    """W_N^(k1·n2) for this device's ``cols`` n2-columns starting at
    ``d·cols`` — the distributed four-step's twiddle block, shared by the
    1-D (ShardedLargeFFTPsd) and 2-D (parallel/grid.py) meshes.

    k1·n2 < N1·N2 = N < 2^31 is exact in int32. Past N = 2^24 the f32
    cast of kn rounds; that term is bounded (eps·|ang|, the f32 trig
    floor class — it never grows with N) but removable: split
    kn = q·2^12 + r (q < 2^19, r < 2^12, both f32-exact) and multiply
    the two partial twiddles. Measured max twiddle error vs f64 at
    N = 2^26/2^28/2^30: 6.2e-7 single-angle → 4.5e-7 split
    (tests/test_bigfft.py)."""
    k1 = jnp.arange(N1, dtype=jnp.int32)[:, None]
    n2 = (d * cols + jnp.arange(cols, dtype=jnp.int32))[None, :]
    kn = k1 * n2                                  # (N1, cols) i32
    w = -2.0 * np.pi / N                          # python float64
    if N <= (1 << 24):                            # kn f32-exact
        ang = np.float32(w) * kn.astype(jnp.float32)
        return jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    ang_q = np.float32(w * 4096.0) * (kn >> 12).astype(jnp.float32)
    ang_r = np.float32(w) * (kn & 0xFFF).astype(jnp.float32)
    return (jax.lax.complex(jnp.cos(ang_q), jnp.sin(ang_q))
            * jax.lax.complex(jnp.cos(ang_r), jnp.sin(ang_r)))


def tree_sum_frames(pwr):
    """Two-stage f32 tree sum over the frame axis (axis 0) — the
    framework's accumulation invariant (CLAUDE.md: error ≈ √chunk·ε
    instead of F·ε), applied to the distributed steps too rather than
    relying on whatever order the backend's plain reduce emitter picks.
    Chunk = the largest power-of-two divisor of F up to 64
    (ops.spectral._SUM_CHUNK)."""
    F = pwr.shape[0]
    chunk = 1
    while chunk * 2 <= min(F, 64) and F % (chunk * 2) == 0:
        chunk *= 2
    return pwr.reshape(F // chunk, chunk, *pwr.shape[1:]).sum(1).sum(0)


def u16_frames(frames_u8: np.ndarray, F: int, N: int) -> np.ndarray:
    """View (..., F', 2N) u8 host frames as (..., F, N) u16 IQ pairs,
    zero-padded to F frames — the ONE host-assembly used by every
    distributed-transform entry point. Welch-overlap slicers can hand
    out strided frame views; the u16 view needs contiguous rows
    (ascontiguousarray is a no-op copy otherwise)."""
    a = np.ascontiguousarray(frames_u8)
    lead, Fp = a.shape[:-2], a.shape[-2]
    u16 = a.reshape(*lead, Fp, -1).view(np.uint16)
    if Fp < F:
        u16 = np.concatenate(
            [u16, np.zeros((*lead, F - Fp, N), np.uint16)], axis=-2)
    return u16


def fourstep_local_core(x_u16, n_valid, *, axis: str, N: int, N1: int,
                        N2: int, D: int, F: int, wargs=()):
    """The per-device body of the distributed four-step FFT PSD — local
    length-N1 FFT, split-angle column twiddle, all_to_all transpose over
    ``axis``, local length-N2 FFT, frame masking, two-stage frame sum.
    Shared by the 1-D mesh (ShardedLargeFFTPsd) and the per-row 2-D mesh
    (parallel/grid.py) so the transform pipeline exists once.

    x_u16: (F, N1, N2/D) — this device's n2-columns; returns the
    (N1/D, N2) masked power partial."""
    d = jax.lax.axis_index(axis)
    cols = N2 // D
    re, im = dequant_iq_u16(x_u16)
    x = jax.lax.complex(re, im)
    if wargs:
        wloc = jax.lax.dynamic_slice(wargs[0], (0, d * cols), (N1, cols))
        x = x * wloc[None]
    y = jnp.fft.fft(x, axis=1)                    # over n1 → k1
    z = y * column_twiddle(N, N1, cols, d)[None]
    # Distributed transpose: split k1 into D blocks, gather n2.
    z = jax.lax.all_to_all(z, axis, split_axis=1, concat_axis=2,
                           tiled=True)            # (F, N1/D, N2)
    X = jnp.fft.fft(z, axis=2)                    # over n2 → k2
    pwr = X.real * X.real + X.imag * X.imag
    fidx = jax.lax.broadcasted_iota(jnp.int32, (F, 1, 1), 0)
    pwr = jnp.where(fidx < n_valid, pwr, 0.0)
    return tree_sum_frames(pwr)                   # (N1/D, N2)


class ShardedLargeFFTPsd:
    """PSD accumulator whose FFT is sharded WITHIN each transform.

    fn(raw_u16 (F, N1, N2) sharded on the last axis, n_valid) returns the
    (N,)-flattened unshifted power partial sum (float32); use
    ``prepare()`` to view/shard host IQ bytes and ``__call__`` for the
    whole round trip.
    """

    def __init__(self, mesh: Optional[Mesh], N: int, F: int,
                 window: Optional[np.ndarray] = None):
        if mesh is None:
            mesh = make_mesh()
        D = mesh.devices.size
        if N & (N - 1):
            raise ValueError(f"N={N} must be a power of two")
        N1, N2 = _split(N)
        if N1 % D or N2 % D:
            raise ValueError(
                f"mesh size {D} must divide both N1={N1} and N2={N2}")
        self.mesh = mesh
        self.N, self.N1, self.N2, self.F, self.D = N, N1, N2, F, D
        axis = mesh.axis_names[0]

        if window is not None:
            if len(window) != N:
                raise ValueError("window length != N")
            w2d = np.asarray(window, np.float32).reshape(N1, N2)
        else:
            w2d = None

        def local_step(x_u16, n_valid, *wargs):
            # x_u16: (F, N1, N2/D) local columns; u16 lane = (re, im) bytes.
            return fourstep_local_core(x_u16, n_valid, axis=axis, N=N,
                                       N1=N1, N2=N2, D=D, F=F, wargs=wargs)

        in_specs = [P(None, None, axis), P()]
        wextra = []
        if w2d is not None:
            in_specs.append(P())
            wextra = [jnp.asarray(w2d)]
        self._window_dev = wextra

        sharded = shard_map(local_step, mesh=mesh, in_specs=tuple(in_specs),
                            out_specs=P(axis, None))

        def flat_fn(x_u16, n_valid, *wargs):
            out = sharded(x_u16, n_valid, *wargs)        # (N1, N2) [k1, k2]
            # Flat bin k = k1 + N1·k2 → row-major (N2, N1) == transpose,
            # done on device so callers get the framework's standard (N,)
            # unshifted power layout. Replicated so every process of a
            # multi-host mesh can read it locally (a no-op on one host —
            # the (N,) f32 gather happens at fetch time anyway).
            flat = jnp.swapaxes(out, 0, 1).reshape(N)
            return jax.lax.with_sharding_constraint(
                flat, NamedSharding(mesh, P()))

        self._fn = jax.jit(flat_fn)
        self._x_sharding = NamedSharding(mesh, P(None, None, axis))

    def prepare(self, frames_u8: np.ndarray):
        """View host IQ bytes (F', 2N) u8 (F' ≤ F) as the sharded device
        input: free u16 view + (F, N1, N2) reshape, padded to F frames,
        device_put with the column sharding."""
        Fp = len(frames_u8)
        if Fp > self.F:
            raise ValueError(f"got {Fp} frames, step built for {self.F}")
        x = u16_frames(frames_u8, self.F, self.N) \
            .reshape(self.F, self.N1, self.N2)
        return jax.device_put(x, self._x_sharding), Fp

    def device_step(self, frames_u8: np.ndarray, n_valid: int):
        """Datastore-compatible step: (F', 2N) u8 frames → (N,) float32
        device array (async; np.asarray forces completion). ``n_valid``
        masks trailing padding frames."""
        x, _ = self.prepare(frames_u8)
        return self._fn(x, jnp.int32(n_valid), *self._window_dev)

    def __call__(self, frames_u8: np.ndarray) -> Tuple[np.ndarray, int]:
        """Accumulate |FFT|² over the frames; returns ((N,) float64
        unshifted power sum, frames_used)."""
        out = self.device_step(frames_u8, len(frames_u8))
        return np.asarray(out, dtype=np.float64), len(frames_u8)

    # --- multi-host (DCN) path ------------------------------------------

    def prepare_global(self, frames_u8: np.ndarray):
        """Multi-host input assembly: every process passes the SAME full
        frames; each device_puts only its own column shards, and the
        global Array is assembled from single-device pieces (the same
        shape as MultiHostPsdStep._globalize). The all_to_all between the
        transform stages then rides the intra-host links and DCN across."""
        Fp = len(frames_u8)
        if Fp > self.F:
            raise ValueError(f"got {Fp} frames, step built for {self.F}")
        x = u16_frames(frames_u8, self.F, self.N) \
            .reshape(self.F, self.N1, self.N2)
        dev_list = list(self.mesh.devices.flat)
        cols = self.N2 // len(dev_list)
        # Iterate the MESH's devices, not jax.local_devices(): a subset
        # mesh (make_mesh(n) < all devices) must only shard onto its own
        # members — this process supplies the shards for the mesh devices
        # it can address.
        local = set(jax.local_devices())
        shards = []
        for gi, d in enumerate(dev_list):
            if d not in local:
                continue
            shards.append(jax.device_put(
                np.ascontiguousarray(x[:, :, gi * cols:(gi + 1) * cols]), d))
        arr = jax.make_array_from_single_device_arrays(
            (self.F, self.N1, self.N2), self._x_sharding, shards)
        return arr, Fp

    def call_global(self, frames_u8: np.ndarray) -> Tuple[np.ndarray, int]:
        """Multi-host __call__: returns the replicated (N,) float64 power
        sum readable on every process."""
        x, n_valid = self.prepare_global(frames_u8)
        out = self._fn(x, jnp.int32(n_valid), *self._window_dev)
        return (np.asarray(out.addressable_data(0), dtype=np.float64),
                n_valid)
