"""Polyphase filterbank (PFB) channelized PSD.

The critically-sampled PFB — P-tap windowed-sinc prototype folded over
M branches, then an M-point FFT per output frame — is the standard
radio-astronomy upgrade over the plain FFT periodogram the reference
computes (datastore.cxx:66-88): far sharper channel isolation (tone
leakage drops by the prototype's stopband) at the cost of P× the
input history per frame. Device formulation: the P branch
multiplies are an unrolled weighted sum of shifted (T, M) planes
(static P, fused by XLA) feeding one batched M-point FFT — no gather,
no dynamic shapes — with the house two-stage f32 tree sum and float64
host accumulation (same accuracy strategy as ops/spectral.py).

``pfb_psd(prototype=np.ones(M), taps=1)`` degenerates to exactly the
Bartlett estimator (models/bartlett.py), which the tests pin.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..auxdata import make_window
from ..ops.spectral import bin_frequencies, finalize_psd


def pfb_prototype(M: int, taps: int = 4,
                  window: str = "hann") -> np.ndarray:
    """Windowed-sinc prototype filter, shape (taps·M,) float32.

    sinc cutoff at one channel width (1/M), windowed over the full
    taps·M span. The absolute PSD level scales with the prototype's
    coherent gain, exactly like a window does in the reference (no
    gain compensation there either — acquisition.cxx applies the
    window and normalizes by repeats·N only)."""
    L = taps * M
    n = np.arange(L, dtype=np.float64)
    h = np.sinc((n - (L - 1) / 2.0) / M)
    if window != "boxcar":
        h *= make_window(window, L).astype(np.float64)
    return h.astype(np.float32)


def _pfb_core(xr: jax.Array, xi: jax.Array, h: jax.Array,
              T: int, M: int, P: int, chunk: int,
              fmask: Optional[jax.Array] = None,
              mode: str = "xla") -> jax.Array:
    """Shared PFB kernel body: S[t] = Σ_p x[t+p]·h[p] (P is static and
    small, so the loop unrolls into P fused multiply-adds over (T, M)
    planes), one batched M-point transform, |X|², optional output-frame
    mask, then the house two-stage f32 tree sum.

    The polyphase sums are windowed-class planes, so ``mode`` follows
    ops.spectral.tapered_batch_mode: "xla" — the platform FFT (the
    class yardstick); "fourstep" — the all-matmul four-step partial;
    "bluestein" — the chirp-Z partial; "matmul" — direct DFT (compile
    fallback, same role as PsdStep's)."""
    sr = jnp.zeros((T, M), jnp.float32)
    si = jnp.zeros((T, M), jnp.float32)
    for p in range(P):
        sr = sr + xr[p:p + T] * h[p][None, :]
        si = si + xi[p:p + T] * h[p][None, :]
    if mode == "fourstep":
        from ..ops.dft import best_fourstep_split, fourstep_psd_partial
        n1, n2 = best_fourstep_split(M)
        m = fmask if fmask is not None else jnp.ones((T,), jnp.float32)
        return fourstep_psd_partial(sr, si, m, n1, n2, chunk=chunk)
    if mode == "bluestein":
        # Awkward M (same any-N rationale as the PSD chirp-Z rung).
        from ..ops.dft import bluestein_psd_partial
        m = fmask if fmask is not None else jnp.ones((T,), jnp.float32)
        return bluestein_psd_partial(sr, si, m, chunk=chunk)
    if mode == "matmul":
        from ..ops.dft import dft_power_matmul
        pwr = dft_power_matmul(sr, si)
    else:
        X = jnp.fft.fft(jax.lax.complex(sr, si), axis=1)
        pwr = jnp.real(X) * jnp.real(X) + jnp.imag(X) * jnp.imag(X)
    if fmask is not None:
        pwr = pwr * fmask[:, None]
    g = T // chunk
    return pwr.reshape(g, chunk, M).sum(axis=1).sum(axis=0)


@functools.lru_cache(maxsize=8)
def _pfb_step(M: int, P: int, T: int, chunk: int, mode: str = "xla"):
    @jax.jit
    def step(xr: jax.Array, xi: jax.Array, h: jax.Array) -> jax.Array:
        # xr, xi: (T + P - 1, M) f32 block planes; h: (P, M) f32.
        return _pfb_core(xr, xi, h, T, M, P, chunk, mode=mode)
    return step


def _chunk_for(T: int) -> int:
    c = 64
    while T % c != 0:
        c //= 2
    return max(c, 1)


def pfb_psd(iq_u8: np.ndarray, M: int, sample_rate: int,
            center_freq: int = 0,
            taps: int = 4,
            repeats: Optional[int] = None,
            prototype: Optional[np.ndarray] = None,
            window: str = "hann",
            linear: bool = False,
            baseline: Optional[np.ndarray] = None,
            frames_per_step: int = 1024
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Channelized PSD of a raw interleaved-u8 IQ array via an M-channel,
    ``taps``-tap polyphase filterbank.

    prototype: optional (taps·M,) filter overriding the windowed-sinc
    default. Returns (freqs[M] Hz, psd[M]) with the reference's output
    semantics (finalize_psd: /frames/M/rate, dB unless ``linear``).
    """
    iq = np.asarray(iq_u8, dtype=np.uint8).ravel()
    if M < 2:
        raise ValueError("M must be >= 2")
    if taps < 1:
        raise ValueError("taps must be >= 1")
    P = taps
    if prototype is None:
        h = pfb_prototype(M, taps, window)
    else:
        h = np.asarray(prototype, dtype=np.float32).ravel()
        if h.size != P * M:
            raise ValueError(f"prototype must have taps*M={P * M} "
                             f"coefficients, got {h.size}")
    blocks = iq.size // (2 * M)
    T_total = blocks - P + 1
    if repeats is not None:
        T_total = min(T_total, repeats)
    if T_total <= 0:
        raise ValueError("not enough samples for one PFB output frame "
                         f"(need {(P) * M} complex samples)")

    # Host dequant once (datastore.cxx:75 semantics), blocked (blocks, M).
    used = (T_total + P - 1) * 2 * M
    re = (iq[:used:2].astype(np.float32) - np.float32(127.0)).reshape(-1, M)
    im = (iq[1:used:2].astype(np.float32) - np.float32(127.0)).reshape(-1, M)
    h_dev = jnp.asarray(h.reshape(P, M))

    from ..ops.spectral import tapered_batch_mode
    mode = tapered_batch_mode(M)
    pwr = np.zeros(M, dtype=np.float64)
    start = 0
    while start < T_total:
        T = min(frames_per_step, T_total - start)
        step = _pfb_step(M, P, T, _chunk_for(T), mode)
        # Batches share P-1 rows of input history at the seam.
        xr = re[start:start + T + P - 1]
        xi = im[start:start + T + P - 1]
        pwr += np.asarray(step(jnp.asarray(xr), jnp.asarray(xi), h_dev),
                          dtype=np.float64)
        start += T

    with np.errstate(divide="ignore"):
        psd = finalize_psd(pwr, T_total, sample_rate, linear=linear,
                           baseline=baseline)
    return bin_frequencies(center_freq, M, sample_rate), psd


@functools.lru_cache(maxsize=8)
def _pfb_session_step(N: int, P: int, F: int, chunk: int,
                      mode: str = "xla"):
    from ..ops.spectral import dequant_iq_u16

    @jax.jit
    def step(x_u16: jax.Array, n_valid: jax.Array, h: jax.Array) -> jax.Array:
        # x_u16: (F + P - 1, N) u16 host lane view of the interleaved u8
        # IQ pairs — (P-1) history blocks then F new frames; h: (P, N).
        # Output j (0..F-1) spans x rows j..j+P-1, i.e. it ENDS at new
        # frame j and never reads rows past j — so zero-padded staging
        # rows >= n_valid only feed outputs that the fmask below removes.
        re, im = dequant_iq_u16(x_u16)
        fmask = (jax.lax.broadcasted_iota(jnp.int32, (F,), 0)
                 < n_valid).astype(jnp.float32)
        return _pfb_core(re, im, h, F, N, P, chunk, fmask=fmask, mode=mode)
    return step


class PfbSessionStep:
    """PsdStep-compatible session step running the PFB estimator.

    Same contract as ops.spectral.PsdStep (``.F``, ``.path``,
    ``__call__(frames (F, 2N) u8, n_valid) -> (N,) f32 async partial``)
    so pipeline.Datastore can drive it unchanged, plus ``reset()`` which
    the datastore calls per acquisition so filter history never leaks
    across retunes. Stateful on purpose: the PFB needs the previous
    P-1 blocks, which the step carries across batches as a u8 tail
    (value 127 == zero signal, datastore.cxx:75). The first P-1 outputs
    of each acquisition therefore see zero prehistory (standard PFB
    warm-up) — this keeps the ``repeats`` accounting exact: every output
    frame consumes exactly N new samples, like the reference's spectra.
    """

    def __init__(self, N: int, frames_per_step: int, taps: int = 4,
                 window: str = "hann"):
        from ..ops.spectral import adapt_batch, tapered_batch_mode
        if taps < 2:
            raise ValueError("pfb taps must be >= 2")
        self.N = N
        self.P = taps
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = "pfb"
        h = pfb_prototype(N, taps, window)
        self._h = jnp.asarray(h.reshape(taps, N))
        self._mode = tapered_batch_mode(N)
        self._step = _pfb_session_step(N, taps, self.F, self._chunk,
                                       self._mode)
        self.reset()

    @property
    def takes_u16(self) -> bool:
        return False

    def reset(self) -> None:
        """Clear filter history (new acquisition / retune)."""
        self._tail = np.full((self.P - 1, 2 * self.N), 127, dtype=np.uint8)

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as PsdStep (ops/spectral.py):
        only the "xla" mode touches the platform's monolithic-FFT
        lowering; on refusal rebuild the jitted step on the direct
        matmul DFT (filter history is untouched) and retry."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the PFB step"):
            return False
        self._mode = "matmul"
        self._step = _pfb_session_step(self.N, self.P, self.F, self._chunk,
                                       "matmul")
        return True

    def __call__(self, raw: np.ndarray, n_valid: int) -> jax.Array:
        # raw stays u8 (the host-side history seam below slices it); only
        # the assembled device input takes the free u16 lane view.
        x = np.concatenate([self._tail, raw], axis=0).view(np.uint16)
        try:
            out = self._step(x, jnp.int32(n_valid), self._h)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            out = self._step(x, jnp.int32(n_valid), self._h)
        # History update from VALID rows only (staging pads with zeros).
        if n_valid >= self.P - 1:
            self._tail = np.array(raw[n_valid - self.P + 1:n_valid])
        else:
            self._tail = np.concatenate(
                [self._tail, raw[:n_valid]], axis=0)[-(self.P - 1):].copy()
        return out


class ShardedPfbStep:
    """PFB estimator over the stream mesh (``--streams`` + ``--pfb-taps``).

    Same call contract as parallel.sharded.ShardedPsdStep — ``(S, F, 2N)``
    u8 frames + ``(S,)`` n_valid → ``(per_stream (S, N) f32`` sharded on the
    stream axis, ``combined (N,) f32`` replicated via ONE psum) —
    so MultiStreamAcquisition's consumer loop drives it unchanged. The
    PfbSessionStep's stateful u8 filter history is carried HOST-side per
    stream as an ``(S, P−1, 2N)`` tail (127-fill == zero signal,
    datastore.cxx:75) and cleared by ``reset()`` per acquisition, so
    history never leaks across retunes and never crosses streams. Each
    device runs the PFB on its local stream shard only; the cross-stream
    combine is the reference's serial accumulation (datastore.cxx:82-87)
    as a collective.

    Output accounting matches PfbSessionStep exactly: every output frame
    consumes N NEW samples of its own stream; the first P−1 outputs of
    each acquisition see zero prehistory (standard PFB warm-up), so the
    combined result equals running PfbSessionStep per stream and summing.
    """

    def __init__(self, mesh, N: int, frames_per_step: int, streams: int,
                 taps: int = 4, window: str = "hann"):
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        from ..ops.spectral import adapt_batch, tapered_batch_mode

        if taps < 2:
            raise ValueError("pfb taps must be >= 2")
        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        if streams % n_dev != 0:
            raise ValueError(
                f"streams ({streams}) must be divisible by mesh size ({n_dev})")
        self.mesh = mesh
        self.axis = axis
        self.N = N
        self.S = streams
        self.P = taps
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = "pfb"
        h = pfb_prototype(N, taps, window)
        self._h = jnp.asarray(h.reshape(taps, N))
        self._raw_sharding = NamedSharding(mesh, Pspec(axis))
        self._mode = tapered_batch_mode(N)
        self._build(self._mode)
        self.reset()

    def _build(self, mode: str) -> None:
        from jax.sharding import PartitionSpec as Pspec
        try:  # stable API (jax >= 0.4.35)
            from jax import shard_map
        except ImportError:  # pragma: no cover
            from jax.experimental.shard_map import shard_map
        from ..ops.spectral import dequant_iq_u16

        axis = self.axis
        N_, F_, P_, chunk = self.N, self.F, self.P, self._chunk

        def local_step(x_u16: jax.Array, n_valid: jax.Array,
                       h: jax.Array):
            # x_u16: (S_local, F + P − 1, N) u16 host lane view — per
            # stream, (P−1) history rows then F new frames; n_valid:
            # (S_local,) i32. Output j of stream s spans its x rows
            # j..j+P−1, ENDING at new frame j (see _pfb_session_step), so
            # zero-padded staging rows ≥ n_valid only feed outputs the
            # fmask removes.
            S_l = x_u16.shape[0]
            R = F_ + P_ - 1
            re, im = dequant_iq_u16(x_u16.reshape(S_l * R, N_))
            re = re.reshape(S_l, R, N_)
            im = im.reshape(S_l, R, N_)
            fmask = (jax.lax.broadcasted_iota(jnp.int32, (S_l, F_), 1)
                     < n_valid[:, None]).astype(jnp.float32)
            per_stream = jax.vmap(
                lambda r, i, m: _pfb_core(r, i, h, F_, N_, P_, chunk,
                                          fmask=m, mode=mode))(re, im, fmask)
            combined = jax.lax.psum(per_stream.sum(axis=0), axis)
            return per_stream, combined

        sharded = shard_map(local_step, mesh=self.mesh,
                            in_specs=(Pspec(axis), Pspec(axis), Pspec()),
                            out_specs=(Pspec(axis), Pspec()),
                            check_vma=False)
        self._step = jax.jit(sharded)

    @property
    def takes_u16(self) -> bool:
        return False

    def reset(self) -> None:
        """Clear every stream's filter history (new acquisition/retune)."""
        self._tails = np.full((self.S, self.P - 1, 2 * self.N), 127,
                              dtype=np.uint8)

    def __call__(self, raw, n_valid) -> Tuple[jax.Array, jax.Array]:
        """raw: (S, F, 2N) u8, n_valid: (S,) int — host numpy arrays (the
        history seam is host state, so fully-addressable input only)."""
        raw_np = raw if isinstance(raw, np.ndarray) else np.asarray(raw)
        nv = np.asarray(n_valid, dtype=np.int32)
        # raw stays u8 (the per-stream history seams below slice it);
        # only the assembled device input takes the free u16 lane view.
        x = np.concatenate([self._tails, raw_np], axis=1).view(np.uint16)
        x_dev = jax.device_put(x, self._raw_sharding)
        try:
            out = self._step(x_dev, nv, self._h)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            out = self._step(x_dev, nv, self._h)
        # History update from VALID rows only (staging pads with zeros;
        # a zero-valid round — e.g. a straggler miss — keeps the tail).
        for s in range(self.S):
            v = int(nv[s])
            if v >= self.P - 1:
                self._tails[s] = raw_np[s, v - self.P + 1:v]
            elif v > 0:
                self._tails[s] = np.concatenate(
                    [self._tails[s], raw_np[s, :v]], axis=0)[-(self.P - 1):]
        return out

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Same compile-failure resilience as ShardedPsdStep: only the
        "xla" mode touches the monolithic-FFT lowering; on refusal
        rebuild each shard's transform on the direct matmul DFT (filter
        history is untouched) and retry."""
        from ..ops.spectral import warn_fft_compile_fallback
        if self._mode != "xla" or not warn_fft_compile_fallback(
                self.N, e, "the sharded PFB step", " on each shard"):
            return False
        self._mode = "matmul"
        self._build("matmul")
        return True

    def example_args(self):
        raw = np.zeros((self.S, self.F, 2 * self.N), dtype=np.uint8)
        nv = np.zeros((self.S,), dtype=np.int32)
        return (raw, nv)


def pfb_channelize(iq_u8: np.ndarray, M: int,
                   taps: int = 4,
                   prototype: Optional[np.ndarray] = None,
                   window: str = "hann") -> np.ndarray:
    """The complex channelized series itself: (T, M) complex64 — frame t,
    channel k (unshifted FFT bin order). For downstream detection /
    dedispersion-style pipelines that need the voltages, not the PSD."""
    iq = np.asarray(iq_u8, dtype=np.uint8).ravel()
    P = taps
    h = (pfb_prototype(M, taps, window) if prototype is None
         else np.asarray(prototype, dtype=np.float32).ravel())
    if h.size != P * M:
        raise ValueError(f"prototype must have taps*M={P * M} coefficients")
    blocks = iq.size // (2 * M)
    T = blocks - P + 1
    if T <= 0:
        raise ValueError("not enough samples for one PFB output frame")
    used = (T + P - 1) * 2 * M
    re = (iq[:used:2].astype(np.float32) - np.float32(127.0)).reshape(-1, M)
    im = (iq[1:used:2].astype(np.float32) - np.float32(127.0)).reshape(-1, M)
    hj = jnp.asarray(h.reshape(P, M))
    sr = jnp.zeros((T, M), jnp.float32)
    si = jnp.zeros((T, M), jnp.float32)
    for p in range(P):
        sr = sr + jnp.asarray(re[p:p + T]) * hj[p][None, :]
        si = si + jnp.asarray(im[p:p + T]) * hj[p][None, :]
    return np.asarray(jnp.fft.fft(jax.lax.complex(sr, si), axis=1),
                      dtype=np.complex64)
