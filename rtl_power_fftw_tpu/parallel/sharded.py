"""Multi-stream sharded PSD accumulation over a device mesh.

Device-mesh replacement for "average many spectra" at scale
(BASELINE.json config 5: 16 parallel IQ streams sharded across a device
mesh with psum-reduced averaged spectra).  Streams are laid out on a 1-D
``stream`` mesh axis with ``shard_map``; each device runs the same fused
dequant→window→FFT→|X|² step on its local streams, and the cross-stream
average is ONE ``psum`` of the (N,)-shaped partial sums — the
collective-equivalent of the reference's serial accumulation loop
(datastore.cxx:82-87).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # stable API (jax >= 0.4.35)
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops.spectral import (_power_backend, adapt_batch, dequant_iq,
                            dequant_iq_u16)


class ShardedPsdStep:
    """Jitted multi-device step: (S, F, 2N) u8 → per-stream (S, N) partials
    plus a psum-combined (N,) partial, with streams sharded on the mesh.

    ``n_valid`` is (S,) — per-stream valid-frame counts, so streams may
    progress unevenly (e.g. different drop rates) without reshape.
    """

    def __init__(self, mesh: Mesh, N: int, frames_per_step: int,
                 streams: int, window: Optional[np.ndarray] = None,
                 backend: str = "auto"):
        if N % 2 != 0:
            raise ValueError("N must be even")
        if window is not None and len(np.asarray(window)) != N:
            # Same early validation as PsdStep — a wrong-length window
            # would otherwise broadcast silently (length 1) or fail with
            # an opaque jit error on the first call.
            raise ValueError("window must have shape (N,)")
        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        if streams % n_dev != 0:
            raise ValueError(
                f"streams ({streams}) must be divisible by mesh size ({n_dev})")
        self.mesh = mesh
        self.axis = axis
        self.N = N
        self.S = streams
        self.F, self._chunk = adapt_batch(frames_per_step)
        #: the REQUESTED backend (same public contract as PsdStep.backend;
        #: ``path`` below is what the ladder actually selected).
        self.backend = backend
        window_arr = None
        if window is not None:
            window_arr = jnp.asarray(np.asarray(window, dtype=np.float32))
        power_fn = _power_backend(backend, N)
        N_, F_, chunk = self.N, self.F, self._chunk

        # Band selection is the SHARED chooser (ops.spectral.
        # select_transform_rung) — the sharded and single-stream ladders
        # cannot diverge; this builder only constructs the streams
        # variants of the chosen rung (vmapped partials + one psum).
        #: selected rung ("hybrid" | "fourstep" | "fourstep4m" |
        #: "fourstep4x" | "fft4" | "bluestein" | "xla" | "matmul" — the
        #: last via explicit request or compile fallback) — same
        #: introspection contract as PsdStep.path.
        from ..ops.spectral import select_transform_rung
        self.path, split = select_transform_rung(
            N, window_arr is not None, backend)
        fused = None
        if self.path == "hybrid":
            from ..ops.dft import fourstep_hybrid_psd_partial
            fused = (fourstep_hybrid_psd_partial, *split)
        elif self.path == "fourstep":
            from ..ops.dft import fourstep_psd_partial
            fused = (fourstep_psd_partial, *split)
        elif self.path == "fourstep4m":
            from ..ops.dft import fourstep4m_psd_partial
            fused = (fourstep4m_psd_partial, *split)
        elif self.path == "fourstep4x":
            from ..ops.dft import fourstep4x_psd_partial
            fused = (fourstep4x_psd_partial, *split)
        elif self.path == "fft4":
            # Very-large-N (e.g. the frame-sharded 1M mode, longint.py).
            from ..ops.dft import fourstep_fft_psd_partial
            fused = (fourstep_fft_psd_partial, *split)
        elif self.path == "bluestein":
            from ..ops.dft import bluestein_psd_partial
            fused = (bluestein_psd_partial, None, None)

        # Fused rungs take the free host-side u16 view of the IQ pairs.
        self._u16_in = fused is not None
        u16_in = self._u16_in

        def local_step(raw, n_valid, *w):
            # raw: (S_local, F, 2N) u8 — or (S_local, F, N) u16 when the
            # step takes the free host-side view; n_valid: (S_local,) i32.
            S_local = raw.shape[0]
            if u16_in:
                re, im = dequant_iq_u16(raw.reshape(S_local * F_, N_),
                                        w[0] if w else None)
            else:
                re, im = dequant_iq(raw.reshape(S_local * F_, 2 * N_),
                                    S_local * F_, N_, w[0] if w else None)
            fmask = (jax.lax.broadcasted_iota(
                jnp.int32, (S_local, F_), 1)
                < n_valid[:, None]).astype(jnp.float32)
            if fused is not None:
                fn, n1, n2 = fused
                per_stream = jax.vmap(
                    lambda r, i, m: fn(r, i, m, n1, n2, chunk=chunk))(
                    re.reshape(S_local, F_, N_),
                    im.reshape(S_local, F_, N_), fmask)
            else:
                pwr = power_fn(re, im).reshape(S_local, F_, N_)
                pwr = pwr * fmask[:, :, None]
                g = F_ // chunk
                per_stream = pwr.reshape(S_local, g, chunk, N_).sum(2).sum(1)
            # Cross-stream reduction: local sum then one psum over the mesh.
            combined = jax.lax.psum(per_stream.sum(axis=0), axis)
            return per_stream, combined

        in_specs = (P(axis), P(axis)) + ((P(),) if window_arr is not None else ())
        out_specs = (P(axis), P())
        sharded = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs)
        self._window = window_arr
        self._step = jax.jit(sharded)
        self._raw_sharding = NamedSharding(mesh, P(axis))

    @property
    def takes_u16(self) -> bool:
        return self._u16_in

    def __call__(self, raw, n_valid) -> Tuple[jax.Array, jax.Array]:
        """raw: (S, F, 2N) u8, n_valid: (S,) int32 — numpy hosts arrays or
        already-placed jax Arrays (e.g. multi-host global Arrays).
        Returns (per_stream (S,N) f32 — sharded, combined (N,) f32 — replicated)."""
        if isinstance(raw, np.ndarray):
            if self._u16_in and raw.dtype == np.uint8:
                # Free host-side reinterpretation of the interleaved IQ
                # pairs as u16 lanes (the fused rungs' input convention).
                raw = raw.view(np.uint16)
            # Explicit host→device placement along the stream sharding, so
            # each device receives only its stream shard.
            raw = jax.device_put(raw, self._raw_sharding)
        if not isinstance(n_valid, jax.Array):
            n_valid = np.asarray(n_valid, dtype=np.int32)
        try:
            if self._window is not None:
                return self._step(raw, n_valid, self._window)
            return self._step(raw, n_valid)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            if self._window is not None:
                return self._step(raw, n_valid, self._window)
            return self._step(raw, n_valid)

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as PsdStep._fallback_to_matmul
        (see ops/spectral.py): auto's monolithic-FFT rung (prime/2·prime
        N) is the only one whose lowering the framework doesn't control;
        if the backend refuses it, rebuild on the matmul DFT locally
        (dot-generals always lower; same u8 convention) and retry."""
        from ..ops.spectral import warn_fft_compile_fallback
        if not (self.backend == "auto" and self.path == "xla"):
            return False
        if not warn_fft_compile_fallback(self.N, e, "the sharded step",
                                         " on each shard"):
            return False
        window_np = (None if self._window is None
                     else np.asarray(self._window))
        self.__init__(self.mesh, self.N, self.F, streams=self.S,
                      window=window_np, backend="matmul")
        self.backend = "auto"  # the user's request stays introspectable
        self.path = "matmul"
        return True

    def example_args(self):
        if self._u16_in:
            raw = np.zeros((self.S, self.F, self.N), dtype=np.uint16)
        else:
            raw = np.zeros((self.S, self.F, 2 * self.N), dtype=np.uint8)
        nv = np.zeros((self.S,), dtype=np.int32)
        return (raw, nv) + ((np.asarray(self._window),)
                            if self._window is not None else ())
