"""Spectral kurtosis: per-bin RFI detection alongside the averaged PSD.

An extension in the reference's home domain (radio astronomy — the
default center frequency is the hydrogen line, params.h:36): the
generalized spectral-kurtosis estimator of Nita & Gary (2010),

    SK = (M+1)/(M−1) · (M·S2/S1² − 1),   S1 = Σ|X|², S2 = Σ|X|⁴

over M accumulated spectra. For Gaussian noise E[SK] = 1; tones and
time-variable interference push SK away from 1, so thresholding SK flags
contaminated bins without touching the averaged spectrum.

The device step accumulates BOTH moments in one fused pass —
the |X|⁴ accumulation rides the same transform outputs, so the marginal
cost over a plain PSD is one elementwise square and one reduction.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spectral import (FrameSlicer, _power_backend,
                            adapt_batch, bin_frequencies, dequant_iq_u16,
                            pad_frames)


def _sk_keep(s1, s2, M, sigma: float):
    """The Nita-Gary excision gate — ONE definition for the session and
    sharded steps (the documented invariant that the sharded result
    equals per-stream SkSessionStep summed depends on it): keep (1.0)
    iff the block's |SK−1| is within sigma·2/√M of the Gaussian null,
    or M < 2 (no SK information). ``M`` is a float scalar or an (S, 1)
    per-stream column; s1/s2 broadcast accordingly."""
    sk = ((M + 1.0) / jnp.maximum(M - 1.0, 1.0)
          * (M * s2 / jnp.maximum(s1 * s1, 1e-30) - 1.0))
    return ((jnp.abs(sk - 1.0) <= sigma * 2.0 / jnp.sqrt(
        jnp.maximum(M, 1.0))) | (M < 2.0)).astype(jnp.float32)


@functools.lru_cache(maxsize=8)
def _sk_step(N: int, F: int, windowed: bool, backend: str,
             sigma: float = 0.0):
    """One fused device step accumulating both spectral moments over the
    valid frames of an (F, 2N) batch; with ``sigma > 0`` it additionally
    gates THIS BLOCK's contribution per bin on the block's own SK
    (real-time SK excision: the block is the M-spectra estimation window
    of Nita & Gary 2010, and a bin whose |SK−1| exceeds
    ``sigma·2/√M`` — the Gaussian null's standard deviation to leading
    order — is dropped from the clean accumulator for this block
    only)."""
    if backend == "fourstep4m":
        # The COMPENSATED four-step — the windowed AUTO mode (see
        # _sk_mode): s1 doubles as the session's PSD accumulator, so
        # the windowed SK session carries the same accuracy the
        # windowed PSD band ships (round-4 audit: plain fourstep med
        # 1.8-3.4x the strict class at 512-4096; fourstep4m halves it).
        from ..ops.dft import dft_power_fourstep4m
        power_fn = dft_power_fourstep4m
    elif backend == "fourstep4x":
        # The SPLIT-PASS four-step — the windowed session-size AUTO
        # mode (round 5): same rationale, the strict-yard budget-truth
        # path at windowed 1024-16384.
        from ..ops.dft import dft_power_fourstep4x
        power_fn = dft_power_fourstep4x
    else:
        power_fn = _power_backend(backend, N)

    @jax.jit
    def step(raw, n_valid, *w):
        # raw: (F, N) uint16 — the free host-side lane view of the
        # interleaved u8 IQ pairs (same convention as the fused PsdStep
        # family; skips the on-device bitcast relayout).
        re, im = dequant_iq_u16(raw, w[0] if w else None)
        p = power_fn(re, im)  # (F, N)
        mask = (jax.lax.broadcasted_iota(jnp.int32, (F, 1), 0)
                < n_valid).astype(jnp.float32)
        p = p * mask
        _, chunk = adapt_batch(F)
        g = F // chunk
        s1 = p.reshape(g, chunk, N).sum(1).sum(0)
        s2 = (p * p).reshape(g, chunk, N).sum(1).sum(0)
        if sigma == 0.0:
            return s1, s2
        M = n_valid.astype(jnp.float32)
        keep = _sk_keep(s1, s2, M, sigma)
        return s1, s2, s1 * keep, M * keep

    return step


def _sk_mode(N: int, windowed: bool, backend: str) -> str:
    """Resolve the SK family's per-frame transform mode, honoring
    EXPLICIT backend requests verbatim (an explicit --fft-backend
    fourstep on a windowed SK session stays the plain four-step, and
    ``path`` says so); auto follows tapered_batch_mode."""
    from ..ops.spectral import tapered_batch_mode
    if backend in ("matmul", "fourstep", "fourstep4m", "fourstep4x",
                   "xla", "bluestein"):
        return backend
    return tapered_batch_mode(N)


def compute_sk(s1: np.ndarray, s2: np.ndarray, M: int) -> np.ndarray:
    """Generalized SK from accumulated moments (Nita & Gary 2010):
    SK = (M+1)/(M−1)·(M·S2/S1² − 1), float64, unshifted bin order."""
    s1 = np.asarray(s1, dtype=np.float64)
    s2 = np.asarray(s2, dtype=np.float64)
    return (M + 1.0) / (M - 1.0) * (
        M * s2 / np.maximum(s1 * s1, 1e-300) - 1.0)


class SkSessionStep:
    """PsdStep-compatible session step that accumulates BOTH spectral
    moments (``--sk-file``): same contract as ops.spectral.PsdStep except
    the tuple-of-named-``fields`` output — ``__call__`` returns the pair
    ``(s1, s2)`` of (N,)
    f32 async partials (Σ|X|², Σ|X|⁴ over valid frames), which
    pipeline.Datastore accumulates separately. ``s1`` is bit-identical in
    role to the plain PSD accumulator, so the averaged spectrum written
    to stdout is unchanged by the sidecar; the marginal device cost is
    one elementwise square and one extra reduction.

    The second moment needs PER-FRAME spectra, so the fused
    (pre-accumulated) kernel paths don't apply; the transform follows
    ops.spectral.tapered_batch_mode's choice (the platform FFT; an
    explicit backend or the compile fallback selects another).

    With ``excise_sigma > 0`` (``--sk-excise``) the step ALSO gates each
    block's per-bin contribution on the block's own SK, returning the
    four fields ``(s1, s2, s1_clean, kept)``: the clean accumulator sums
    only blocks whose |SK−1| stayed within sigma·2/√M, and ``kept``
    counts the spectra that survived per bin (the per-bin divisor for
    the excised average). ``s1`` stays the FULL accumulator, so the
    unexcised spectrum, ``.met`` semantics, and the sidecar are
    unchanged."""

    def __init__(self, N: int, frames_per_step: int,
                 window: Optional[np.ndarray] = None,
                 backend: str = "auto", excise_sigma: float = 0.0):
        self.N = N
        self.F, _ = adapt_batch(frames_per_step)
        self._mode = _sk_mode(N, window is not None, backend)
        self.backend = backend
        self.path = self._mode
        self._sigma = float(excise_sigma)
        self.fields = (("s1", "s2", "s1_clean", "kept")
                       if self._sigma > 0.0 else ("s1", "s2"))
        self._w = ()
        if window is not None:
            import jax.numpy as _jnp
            self._w = (_jnp.asarray(np.asarray(window, np.float32)),)
        self._windowed = window is not None
        self._step = _sk_step(N, self.F, self._windowed, self._mode,
                              self._sigma)

    @property
    def takes_u16(self) -> bool:
        return True

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as PsdStep: only the "xla"
        mode touches the monolithic-FFT lowering."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the SK step"):
            return False
        self._mode = "matmul"
        self.path = "matmul"
        self._step = _sk_step(self.N, self.F, self._windowed, "matmul",
                              self._sigma)
        return True

    def __call__(self, raw: np.ndarray, n_valid: int):
        import jax.numpy as _jnp
        if raw.dtype == np.uint8:
            raw = raw.view(np.uint16)  # free reinterpretation on the host
        try:
            return self._step(raw, _jnp.int32(n_valid), *self._w)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            return self._step(raw, _jnp.int32(n_valid), *self._w)


class ShardedSkStep:
    """The spectral-kurtosis sidecar over the stream mesh (``--streams``
    + ``--sk-file``): same call contract as parallel.sharded.
    ShardedPsdStep — (S, F, 2N) u8 + (S,) n_valid — but with the
    named-``fields`` combined output: a (2, N) stack of the psum-reduced
    moments
    (Σ|X|², Σ|X|⁴ over all streams), while ``per_stream`` stays the
    (S, N) first-moment partials so the per-stream diagnostics and the
    averaged spectrum are unchanged. Stateless: both moment sums commute
    with any partition of the frames, so the combined result equals
    running SkSessionStep per stream and summing — with M = S·repeats
    in the SK estimator (streams are same-distribution acquisitions of
    the same dwell, exactly the reference's accumulation semantics
    scaled out, datastore.cxx:82-87).

    With ``excise_sigma > 0`` (``--sk-excise`` + ``--streams``) each
    STREAM's local block gates its own contribution on its own SK with
    its own M = n_valid[s] — excision happens before the psum, so one
    stream's burst never contaminates the others — and the combined
    output grows to the (4, N) stack (s1, s2, s1_clean, kept)."""

    def __init__(self, mesh, N: int, frames_per_step: int, streams: int,
                 window: Optional[np.ndarray] = None,
                 excise_sigma: float = 0.0, backend: str = "auto"):
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
        self._sigma = float(excise_sigma)
        self.fields = (("s1", "s2", "s1_clean", "kept")
                       if self._sigma > 0.0 else ("s1", "s2"))
        self._w = ()
        if window is not None:
            self._w = (jnp.asarray(np.asarray(window, np.float32)),)
        # Honor an explicit per-frame backend request like SkSessionStep
        # (fused backends were already warned about at parse time).
        self._mode = _sk_mode(N, window is not None, backend)
        self.backend = backend
        self.path = self._mode
        self._build(self._mode)

    def _build(self, mode: str) -> None:
        from jax.sharding import PartitionSpec as Pspec
        try:  # stable API (jax >= 0.4.35)
            from jax import shard_map
        except ImportError:  # pragma: no cover
            from jax.experimental.shard_map import shard_map

        axis = self.axis
        N_, F_, chunk = self.N, self.F, self._chunk
        sigma = self._sigma
        if mode == "fourstep4m":
            # The compensated four-step (the windowed AUTO mode resolved
            # by _sk_mode, matching _sk_step — the two paths' s1 must
            # stay the same estimator; sharded-vs-session parity tests
            # pin it).
            from ..ops.dft import dft_power_fourstep4m
            power_fn = dft_power_fourstep4m
        elif mode == "fourstep4x":
            # The split-pass four-step (windowed session band, round 5)
            # — same sharded-vs-session s1 identity contract.
            from ..ops.dft import dft_power_fourstep4x
            power_fn = dft_power_fourstep4x
        else:
            power_fn = _power_backend(mode, N_)

        def local_step(raw, n_valid, *w):
            # raw: (S_local, F, N) u16 host lane view; n_valid: (S_local,).
            S_l = raw.shape[0]
            re, im = dequant_iq_u16(raw.reshape(S_l * F_, N_),
                                    w[0] if w else None)
            p = power_fn(re, im)  # (S_l·F, N)
            fmask = (jax.lax.broadcasted_iota(jnp.int32, (S_l, F_), 1)
                     < n_valid[:, None]).astype(jnp.float32)
            p = p * fmask.reshape(S_l * F_, 1)
            g = F_ // chunk
            s1 = p.reshape(S_l, g, chunk, N_).sum(2).sum(1)       # (S_l, N)
            s2 = (p * p).reshape(S_l, g, chunk, N_).sum(2).sum(1)
            if sigma == 0.0:
                combined = jax.lax.psum(
                    jnp.stack([s1.sum(0), s2.sum(0)]), axis)      # (2, N)
                return s1, combined
            # Per-stream-block SK gate (each stream judges its own block
            # with its own M) BEFORE the cross-stream reduction.
            M = n_valid.astype(jnp.float32)[:, None]              # (S_l, 1)
            keep = _sk_keep(s1, s2, M, sigma)
            combined = jax.lax.psum(
                jnp.stack([s1.sum(0), s2.sum(0),
                           (s1 * keep).sum(0), (M * keep).sum(0)]),
                axis)                                             # (4, N)
            return s1, combined

        w_specs = (Pspec(),) * len(self._w)
        sharded = shard_map(local_step, mesh=self.mesh,
                            in_specs=(Pspec(axis), Pspec(axis)) + w_specs,
                            out_specs=(Pspec(axis), Pspec()),
                            check_vma=False)
        self._step = jax.jit(sharded)

    @property
    def takes_u16(self) -> bool:
        return True

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as ShardedPsdStep: only the
        "xla" mode touches the monolithic-FFT lowering."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the sharded SK step", " on each shard"):
            return False
        self._mode = "matmul"
        self.path = "matmul"
        self._build("matmul")
        return True

    def __call__(self, raw: np.ndarray, n_valid: np.ndarray):
        if raw.dtype == np.uint8:
            raw = raw.view(np.uint16)  # free reinterpretation on the host
        nv = jnp.asarray(np.asarray(n_valid, np.int32))
        try:
            return self._step(raw, nv, *self._w)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            return self._step(raw, nv, *self._w)


def spectral_kurtosis(iq_u8: np.ndarray, N: int, sample_rate: int,
                      center_freq: int = 0,
                      repeats: Optional[int] = None,
                      window: Optional[np.ndarray] = None,
                      backend: str = "auto",
                      frames_per_step: int = 1024
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute (freqs, SK, psd_linear) over a raw u8 IQ array.

    SK ≈ 1 for well-behaved Gaussian bins; SK ≫ 1 flags impulsive RFI,
    SK ≪ 1 flags coherent tones. ``psd_linear`` is the ordinary averaged
    PSD in linear units (same normalization as ``bartlett_psd(...,
    linear=True)`` but without DC interpolation, so flagging sees the
    true DC bin).
    """
    slicer = FrameSlicer(N)
    frames = slicer.push(iq_u8, max_frames=repeats)
    M = len(frames)
    if M < 2:
        raise ValueError("spectral kurtosis needs at least 2 spectra")
    F, _ = adapt_batch(min(frames_per_step, M))
    step = _sk_step(N, F, window is not None, backend)
    w = (jnp.asarray(np.asarray(window, np.float32)),) if window is not None else ()

    s1 = np.zeros(N, dtype=np.float64)
    s2 = np.zeros(N, dtype=np.float64)
    for start in range(0, M, F):
        batch = frames[start:start + F]
        nv = len(batch)
        a, b = step(pad_frames(batch, F).view(np.uint16), np.int32(nv), *w)
        s1 += np.asarray(a, dtype=np.float64)
        s2 += np.asarray(b, dtype=np.float64)

    sk = (M + 1.0) / (M - 1.0) * (M * s2 / np.maximum(s1 * s1, 1e-300) - 1.0)
    psd = s1 / M / N / sample_rate
    shift = np.fft.fftshift
    return bin_frequencies(center_freq, N, sample_rate), shift(sk), shift(psd)
