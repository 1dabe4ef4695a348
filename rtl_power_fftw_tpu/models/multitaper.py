"""Multitaper (Thomson) PSD estimate.

The lowest-variance estimator family for a fixed data length: each frame
is windowed by K orthogonal DPSS (Slepian) tapers and the K eigenspectra
are averaged. On the device the taper axis is just another batch dimension —
frames × tapers fold into one big batched transform, so the K× extra
FLOPs ride the same fused pipeline that does plain Bartlett averaging.

DPSS tapers come from scipy when available (gated import; everything
else in this module is jax/numpy only).
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


def dpss_tapers(N: int, NW: float, K: int) -> np.ndarray:
    """(K, N) float32 unit-energy DPSS tapers (needs scipy)."""
    try:
        from scipy.signal.windows import dpss
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "multitaper_psd requires scipy for DPSS tapers") from e
    t = dpss(N, NW, Kmax=K)
    return np.asarray(t, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _mt_step(N: int, F: int, K: int, backend: str):
    power_fn = _power_backend(backend, N)

    @jax.jit
    def step(raw, n_valid, tapers):
        # raw: (F, N) u16 host lane view of the IQ pairs; tapers: (K, N).
        re, im = dequant_iq_u16(raw)
        # Taper axis → batch axis: (F, K, N) → (F·K, N).
        re_t = (re[:, None, :] * tapers[None]).reshape(F * K, N)
        im_t = (im[:, None, :] * tapers[None]).reshape(F * K, N)
        p = power_fn(re_t, im_t).reshape(F, K, N)
        mask = (jax.lax.broadcasted_iota(jnp.int32, (F, 1, 1), 0)
                < n_valid).astype(jnp.float32)
        p = (p * mask).mean(axis=1)  # average eigenspectra per frame
        _, chunk = adapt_batch(F)
        g = F // chunk
        return p.reshape(g, chunk, N).sum(1).sum(0)

    return step


def _mt_core(re, im, fmask, tapers, *, N: int, F: int, K: int,
             chunk: int, mode: str):
    """The multitaper estimator body — ONE definition shared by the
    session step and the sharded per-stream step (the parity tests pin
    the two paths against each other; keeping the math in one place is
    what makes that invariant structural): per frame, the mean over the
    K DPSS eigenspectra, summed over valid frames.

    re/im: (F, N) dequantized planes; fmask: (F,) validity; tapers:
    (K, N). mode selects the transform: "fourstep" — a K-LOOPED
    COMPENSATED four-step (one fourstep4m partial per taper via
    lax.scan); "xla" — the platform FFT over the (F·K, N) tapered
    batch (the class yardstick, and what tapered_batch_mode picks);
    "bluestein" — a K-looped chirp-Z partial; "matmul" — direct DFT
    (compile fallback, same role as PsdStep's).

    The round-4 "fourstep" redesign (probes/multitaper_fast2.py,
    BENCHMARKS.md "Estimator-family device steps — round-4 multitaper
    update"): the round-3 body materialized (F·K, N) tapered planes
    into ONE big four-step batch, which ran at ~half the four-step's
    normal rate (working-set spill) and carried the plain fourstep's
    uncompensated twiddle error — 1,637 µs/step at 5.9×/8.4× the
    scipy-f32 eigenspectra class at N=2048/F=1024/K=4. Scanning the
    taper axis keeps the working set at (F, N) (640 µs at identical
    accuracy), and using the compensated fourstep4m partial per taper
    (split twiddle + 4-mult stages) lands 823 µs at 3.8×/3.7× class —
    2× the round-3 speed AND ~1.5× (median) / 2.3× (max) its accuracy.
    The faster-still hybrid body (681 µs) stays rejected: its tapered
    (non-integer) stage-1 FFT leaks 15.8× class — the stage-1-internal
    platform-FFT error the round-4 attribution proved uncompensable."""
    from ..ops.dft import (best_fourstep_split, bluestein_psd_partial,
                           fourstep4m_psd_partial, fourstep_psd_partial)
    from ..ops.spectral import dft_power_matmul

    if mode == "bluestein":
        # Awkward N (2·prime class): the K-looped chirp-Z partial.
        def body_b(acc, t):
            p = bluestein_psd_partial(re * t, im * t, fmask, chunk=chunk)
            return acc + p, ()

        total, _ = jax.lax.scan(body_b, jnp.zeros(N, jnp.float32), tapers)
        return total / np.float32(K)
    if mode in ("fourstep", "fourstep-fast"):
        n1, n2 = best_fourstep_split(N)
        # "fourstep-fast" (--precision high): the PLAIN Karatsuba
        # four-step per taper — measured 640 vs 823 µs at the round-3
        # step's accuracy class (5.9×/8.4× vs the compensated 3.8×/3.7×
        # — probes/multitaper_fast2.py); opt-in, same contract as the
        # relaxed tier everywhere else.
        partial = (fourstep_psd_partial if mode == "fourstep-fast"
                   else fourstep4m_psd_partial)

        def body(acc, t):
            p = partial(re * t, im * t, fmask, n1, n2, chunk=chunk)
            return acc + p, ()

        total, _ = jax.lax.scan(body, jnp.zeros(N, jnp.float32), tapers)
        return total / np.float32(K)
    re_t = (re[:, None, :] * tapers[None]).reshape(F * K, N)
    im_t = (im[:, None, :] * tapers[None]).reshape(F * K, N)
    fmask_t = jnp.repeat(fmask, K)
    if mode == "matmul":
        p = dft_power_matmul(re_t, im_t)
    else:
        X = jnp.fft.fft(jax.lax.complex(re_t, im_t), axis=1)
        p = jnp.real(X) ** 2 + jnp.imag(X) ** 2
    p = p * fmask_t[:, None]
    g = (F * K) // chunk
    total = p.reshape(g, chunk, N).sum(1).sum(0)
    return total / np.float32(K)


@functools.lru_cache(maxsize=8)
def _mt_partial_step(N: int, F: int, K: int, chunk: int, mode: str):
    """Session device step: (F, 2N) u8 + scalar n_valid + (K, N) tapers →
    (N,) f32 partial (Σ_frames mean_tapers |FFT|²), unshifted bins."""

    @jax.jit
    def step(raw, n_valid, tapers):
        # raw: (F, N) u16 host lane view (same convention as PsdStep's
        # fused family — skips the on-device bitcast relayout).
        re, im = dequant_iq_u16(raw)
        fmask = (jax.lax.broadcasted_iota(jnp.int32, (F,), 0)
                 < n_valid).astype(jnp.float32)
        return _mt_core(re, im, fmask, tapers, N=N, F=F, K=K,
                        chunk=chunk, mode=mode)

    return step


def _mt_mode(N: int) -> str:
    """Transform choice for the tapered batch (see _mt_partial_step)."""
    from ..ops.spectral import tapered_batch_mode
    return tapered_batch_mode(N)


def _session_tapers(N: int, NW: float, K: int):
    """(K, N) DPSS tapers in the session's output-unit convention:
    unit-energy Slepians rescaled by √N so a flat spectrum matches the
    boxcar/reference normalization (same convention as multitaper_psd)."""
    from ..exceptions import ReturnValue, RPFexception
    try:
        t = dpss_tapers(N, NW, K)
    except (RuntimeError, ValueError) as e:
        # scipy raises ValueError for parameter-domain problems (e.g.
        # NW >= N/2); both map to the typed InvalidArgument exit.
        raise RPFexception(f"{e}. Exiting.",
                           ReturnValue.InvalidArgument) from e
    return t * np.sqrt(np.float32(N))


class MultitaperSessionStep:
    """PsdStep-compatible session step for the Thomson multitaper
    estimator (``--multitaper K``): same contract as ops.spectral.PsdStep
    (``.F``, ``.path``, ``__call__(frames (F, 2N) u8, n_valid) -> (N,)
    f32 async partial``), stateless, so pipeline.Datastore drives it
    unchanged. Each frame still consumes exactly N new samples —
    ``repeats`` accounting, timing, and `.met` semantics match the
    reference's spectra; only the per-frame estimator changes
    (K eigenspectra averaged instead of one boxcar periodogram,
    datastore.cxx:66-88)."""

    def __init__(self, N: int, frames_per_step: int, K: int,
                 NW: float = 4.0, precision: str = "highest"):
        from ..ops.spectral import adapt_batch
        self.N = N
        self.K = K
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = "multitaper"
        self._tapers = jnp.asarray(_session_tapers(N, NW, K))
        self._mode = _mt_mode(N)
        if precision == "high" and self._mode == "fourstep":
            self._mode = "fourstep-fast"   # opt-in relaxed tier
        self._step = _mt_partial_step(N, self.F, K, self._chunk, self._mode)

    @property
    def takes_u16(self) -> bool:
        return True

    def __call__(self, raw: np.ndarray, n_valid: int) -> jax.Array:
        if raw.dtype == np.uint8:
            raw = raw.view(np.uint16)  # free reinterpretation on the host
        try:
            return self._step(raw, jnp.int32(n_valid), self._tapers)
        except Exception as e:  # noqa: BLE001 - filtered below
            if not self._fallback_to_matmul(e):
                raise
            return self._step(raw, jnp.int32(n_valid), self._tapers)

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as PsdStep (ops/spectral.py):
        only the "xla" mode touches the platform's monolithic FFT
        lowering; if the backend refuses it, rebuild on the direct
        matmul DFT and retry."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the multitaper step"):
            return False
        self._mode = "matmul"
        self._step = _mt_partial_step(self.N, self.F, self.K, self._chunk,
                                      "matmul")
        return True


class ShardedMultitaperStep:
    """The multitaper estimator over the stream mesh (``--streams`` +
    ``--multitaper``): same call contract as parallel.sharded.
    ShardedPsdStep — (S, F, 2N) u8 + (S,) n_valid → (per_stream (S, N)
    sharded, combined (N,) replicated via one psum). Stateless
    (no reset needed): eigenspectrum averaging commutes with any
    partition of the frames, so the combined result equals running
    MultitaperSessionStep per stream and summing."""

    def __init__(self, mesh, N: int, frames_per_step: int, streams: int,
                 K: int, NW: float = 4.0, precision: str = "highest"):
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        from ..ops.spectral import adapt_batch

        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        if streams % n_dev != 0:
            raise ValueError(
                f"streams ({streams}) must be divisible by mesh size ({n_dev})")
        self.mesh = mesh
        self.axis = axis
        self.N = N
        self.S = streams
        self.K = K
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = "multitaper"
        self._tapers = jnp.asarray(_session_tapers(N, NW, K))
        self._raw_sharding = NamedSharding(mesh, Pspec(axis))
        self._mode = _mt_mode(N)
        if precision == "high" and self._mode == "fourstep":
            self._mode = "fourstep-fast"   # opt-in relaxed tier
        self._build(self._mode)

    def _build(self, mode: str) -> None:
        from jax.sharding import PartitionSpec as Pspec
        try:  # stable API (jax >= 0.4.35)
            from jax import shard_map
        except ImportError:  # pragma: no cover
            from jax.experimental.shard_map import shard_map
        axis = self.axis
        N_, F_, K_, chunk = self.N, self.F, self.K, self._chunk

        def one_stream(re, im, fmask, tapers):
            # The estimator body is the SHARED _mt_core — the sharded
            # and single-stream paths cannot drift apart.
            return _mt_core(re, im, fmask, tapers, N=N_, F=F_, K=K_,
                            chunk=chunk, mode=mode)

        def local_step(raw, n_valid, tapers):
            # raw: (S_local, F, N) u16 host lane view; n_valid: (S_local,).
            S_l = raw.shape[0]
            re, im = dequant_iq_u16(raw.reshape(S_l * F_, N_))
            fmask = (jax.lax.broadcasted_iota(jnp.int32, (S_l, F_), 1)
                     < n_valid[:, None]).astype(jnp.float32)
            per_stream = jax.vmap(
                lambda r, i, m: one_stream(r, i, m, tapers))(
                re.reshape(S_l, F_, N_), im.reshape(S_l, F_, N_), fmask)
            combined = jax.lax.psum(per_stream.sum(axis=0), axis)
            return per_stream, combined

        sharded = shard_map(local_step, mesh=self.mesh,
                            in_specs=(Pspec(axis), Pspec(axis), Pspec()),
                            out_specs=(Pspec(axis), Pspec()),
                            check_vma=False)
        self._step = jax.jit(sharded)

    @property
    def takes_u16(self) -> bool:
        return True

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as ShardedPsdStep: only the
        "xla" mode touches the monolithic-FFT lowering; on refusal
        rebuild each shard's transform on the direct matmul DFT."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the sharded multitaper step", " on each shard"):
            return False
        self._mode = "matmul"
        self._build("matmul")
        return True

    def __call__(self, raw, n_valid) -> Tuple[jax.Array, jax.Array]:
        if isinstance(raw, np.ndarray):
            if raw.dtype == np.uint8:
                raw = raw.view(np.uint16)  # free host reinterpretation
            raw = jax.device_put(raw, self._raw_sharding)
        nv = np.asarray(n_valid, dtype=np.int32)
        try:
            return self._step(raw, nv, self._tapers)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            return self._step(raw, nv, self._tapers)

    def example_args(self):
        raw = np.zeros((self.S, self.F, 2 * self.N), dtype=np.uint8)
        nv = np.zeros((self.S,), dtype=np.int32)
        return (raw, nv)


def multitaper_psd(iq_u8: np.ndarray, N: int, sample_rate: int,
                   center_freq: int = 0,
                   NW: float = 4.0, K: Optional[int] = None,
                   repeats: Optional[int] = None,
                   linear: bool = False,
                   backend: str = "auto",
                   frames_per_step: int = 256
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Thomson multitaper PSD over a raw u8 IQ array.

    NW: time-bandwidth product; K: number of tapers (default 2·NW−1).
    Normalization matches the framework's other estimators
    (power/N/rate, fftshifted, dB unless ``linear``); taper energy is
    unit so the eigenspectrum average is directly comparable to a
    boxcar Bartlett PSD of the same data.
    """
    K = int(2 * NW - 1) if K is None else int(K)
    tapers = dpss_tapers(N, NW, K)
    # The reference convention: file windows are applied as-is; DPSS
    # tapers from scipy are unit-energy (Σw² = 1). Rescale so a flat
    # spectrum matches the boxcar normalization (Σw² = N).
    tapers = tapers * np.sqrt(np.float32(N))

    slicer = FrameSlicer(N)
    frames = slicer.push(iq_u8, max_frames=repeats)
    M = len(frames)
    if M == 0:
        raise ValueError("not enough samples for a single FFT frame")
    F, _ = adapt_batch(min(frames_per_step, M))
    step = _mt_step(N, F, K, backend)
    tp = jnp.asarray(tapers)

    acc = np.zeros(N, dtype=np.float64)
    for start in range(0, M, F):
        batch = frames[start:start + F]
        nv = len(batch)
        acc += np.asarray(step(pad_frames(batch, F).view(np.uint16),
                               np.int32(nv), tp),
                          dtype=np.float64)

    psd = np.fft.fftshift(acc) / M / N / sample_rate
    if not linear:
        with np.errstate(divide="ignore"):
            psd = 10.0 * np.log10(psd)
    return bin_frequencies(center_freq, N, sample_rate), psd
