"""The spectral core: fused dequant → window → FFT → |X|² accumulation.

Device-first re-design of the reference's FFT worker (datastore.cxx:48-96).
Instead of one N-point FFT at a time in a mutex-guarded thread, the whole
buffer is processed as ONE jitted device step over a fixed-shape batch of
frames, so XLA fuses the u8 dequantization and window multiply into the
transform and the batch axis keeps the device busy.

Semantics preserved from the reference:

* dequantization is ``(u8 − 127)`` (datastore.cxx:75);
* the reference multiplies samples by (−1)^n so spectra come out
  pre-shifted (datastore.cxx:69-75).  FFT(x·(−1)^n) = fftshift(FFT(x)) for
  even N, and fftshift commutes with |·|² and accumulation — so we
  accumulate *unshifted* power and apply one fftshift at finalization.
  Bit-for-bit the same result, one whole multiply pass cheaper;
* the window multiplies the dequantized samples (order is irrelevant since
  multiplication commutes) (datastore.cxx:76-77);
* accumulation in the reference is float64 (datastore.h:53).  Accelerators
  have no fast f64, so each device step reduces its frames with a two-stage f32
  tree sum (error ≈ √(chunk)·ε instead of F·ε) and the HOST accumulates
  the per-step partial sums in float64.  Relative error stays ≪1e-5 over
  arbitrarily many averaged spectra;
* frames carry across buffer boundaries (datastore.cxx:52,66-80):
  ``FrameSlicer`` keeps the remainder bytes between buffers;
* processing stops at exactly ``repeats`` frames even if more data was
  read (datastore.cxx:67): the caller clamps ``n_valid``.

Finalization (DC-bin interpolation, normalization, dB, baseline) follows
acquisition.cxx:376-399 in float64 on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dft import dft_power_fourstep, dft_power_matmul

# Frames are reduced in chunks of this size before the cross-chunk sum;
# two-stage summation keeps f32 rounding error at ~(CHUNK + F/CHUNK)·ε.
_SUM_CHUNK = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def adapt_batch(frames_per_step: int) -> Tuple[int, int]:
    """Shared frame-batch sizing: (F, chunk) with F rounded to a multiple
    of 8 and chunk the largest power-of-two divisor ≤ _SUM_CHUNK — the
    two-stage-tree-sum invariant every device step relies on."""
    F = _round_up(max(int(frames_per_step), 1), 8)
    chunk = _SUM_CHUNK
    while F % chunk != 0:
        chunk //= 2
    return F, chunk


def dequant_iq(raw: jax.Array, F: int, N: int,
               window: Optional[jax.Array] = None):
    """THE dequantization convention, in one place: interleaved u8 IQ →
    (re, im) float32 planes, ``(u8 − 127)`` per datastore.cxx:75, with an
    optional window multiply. Used by every device step in the framework.

    Implementation: the interleaved (re, im) byte pair is read as ONE
    little-endian u16 lane and split with integer mask/shift — pure
    elementwise work instead of a strided (F, N, 2) gather (which costs
    a real data-movement pass). Bit-exact with the naive formulation.
    """
    v = jax.lax.bitcast_convert_type(raw.reshape(F, N, 2), jnp.uint16)
    return dequant_iq_u16(v, window)


def dequant_iq_u16(raw16: jax.Array,
                   window: Optional[jax.Array] = None):
    """``dequant_iq`` for inputs already holding the u16 lane view (the
    free HOST-side reinterpretation of the interleaved u8 pairs — every
    fused path takes it to skip the on-device bitcast relayout). Same
    convention, single-sourced: low byte = re, high byte = im, −127.
    """
    v = raw16.astype(jnp.int32)
    re = ((v & 0xFF) - 127).astype(jnp.float32)
    im = ((v >> 8) - 127).astype(jnp.float32)
    if window is not None:
        re = re * window
        im = im * window
    return re, im


def pad_frames(batch: np.ndarray, F: int) -> np.ndarray:
    """Zero-pad a (n, 2N) frame batch up to the step's fixed (F, 2N)."""
    n = len(batch)
    if n >= F:
        return batch
    return np.concatenate(
        [batch, np.zeros((F - n, batch.shape[1]), np.uint8)])


def _power_backend(backend: str, N: int) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Return fn(re, im) -> |FFT|² for (F, N) float32 inputs."""
    if backend == "matmul":
        return dft_power_matmul
    if backend == "fourstep":
        return dft_power_fourstep
    if backend == "bluestein":
        # Per-frame chirp-Z power — estimator steps that need (F, N)
        # spectra (the SK family) at awkward N where the monolithic
        # platform FFT is slow/compile-refused. (The PSD steps never
        # consume this: their bluestein rung is the fused partial.)
        from .dft import dft_power_bluestein
        return dft_power_bluestein
    if backend in ("xla", "auto", "fft4", "hybrid",
                   "fourstep4m", "fourstep4x"):
        # The fused rungs route power computation to their partials at
        # the PsdStep level; the plain backends (and the fallbacks for
        # ineligible shapes, e.g. prime N) land here.
        def xla_fft_power(re, im):
            x = jax.lax.complex(re, im)
            X = jnp.fft.fft(x, axis=-1)
            return jnp.real(X) * jnp.real(X) + jnp.imag(X) * jnp.imag(X)
        return xla_fft_power
    raise ValueError(f"unknown fft backend: {backend}")


def is_fft_compile_refusal(e: Exception) -> bool:
    """True when an exception looks like the backend REFUSING TO LOWER a
    program (compile-time UNIMPLEMENTED/unsupported), as opposed to a
    runtime/user error. Shared by the PsdStep and ShardedPsdStep
    monolithic-FFT fallbacks so the two classifiers cannot diverge."""
    msg = f"{type(e).__name__}: {e}"
    return any(s in msg for s in ("UNIMPLEMENTED", "Unimplemented",
                                  "NotImplemented", "unsupported",
                                  "Unsupported"))


# The matmul-DFT fallback materializes 2·(N, N) f32 weight tables; cap the
# rebuild at 0.5 GiB of weights (N = 8192) — prime/2·prime bin counts in
# practice are far smaller.
FFT_FALLBACK_MAX_N = 8192


def warn_fft_compile_fallback(N: int, e: Exception, what: str,
                              suffix: str = "") -> bool:
    """The shared guard for every step's last-resort monolithic-FFT
    compile fallback: True iff ``e`` is a backend compile REFUSAL (not a
    runtime/user error) at a size the matmul-DFT rebuild can absorb, in
    which case the standard warning naming ``what`` is printed and the
    caller rebuilds its step on the matmul DFT and retries. Callers gate
    on their own mode bookkeeping first (only the "xla" mode touches the
    monolithic lowering); keeping the refusal classifier, the size cap,
    and the message in ONE place keeps the fallback sites from
    diverging."""
    if N > FFT_FALLBACK_MAX_N or not is_fft_compile_refusal(e):
        return False
    import sys
    print(f"Warning: the platform FFT failed to compile for N={N} "
          f"({type(e).__name__}); {what} falls back to the matmul DFT "
          f"path{suffix}.", file=sys.stderr)
    return True


def on_gpu() -> bool:
    """True when JAX's default backend is an NVIDIA GPU."""
    return jax.default_backend() == "gpu"


def select_transform_rung(N: int, windowed: bool, backend: str):
    """The transform-rung selection — ONE definition shared by PsdStep
    and ShardedPsdStep. Returns ``(path, split)`` with path in
    {"hybrid", "fourstep", "fourstep4m", "fourstep4x", "fft4",
    "bluestein", "xla", "matmul"} and split the (n1, n2) factorization
    for the four-step family (None otherwise). Raises ValueError for
    explicit requests that cannot be satisfied.

    ``auto`` is one ladder on every platform:

    * fourstep — the transpose-free all-matmul partial, unwindowed
      composite N < 512;
    * hybrid — FFT stage 1 + split twiddle + HIGHEST-matmul stage 2 with
      the near-square split, unwindowed 512–3072;
    * fft4 — the two-level FFT four-step for composite N > 8192;
    * xla — the platform FFT everywhere else.

    The bands come from CPU BLAS accumulation facts (on CPU the XLA FFT
    IS the FFTW accuracy class). On an H100 each BASELINE size was
    re-measured against the platform FFT (cuFFT) and the ladder kept
    (PERF.md "Transform bands"): at 2048 cuFFT is 3.1× faster than the
    hybrid but 3.2× the FFTW-f32 class median under a 35 dB tone where
    the hybrid sits at 1.3×; at 2**20 cuFFT and fft4 are equally
    tone-accurate and fft4 keeps the band; windowed 8192 is cuFFT
    either way.

    Explicit requests reach every rung on any platform: fourstep4m (the
    compensated four-step), fourstep4x (the split-pass bf16 four-step),
    bluestein (chirp-Z for awkward N), matmul (the exact DFT).
    """
    from .dft import (best_fourstep4x_split, best_fourstep_split,
                      best_hybrid_split)
    if backend == "auto":
        n1, n2 = best_fourstep_split(N)
        if n1 >= 8 and not windowed and N < 512:
            return "fourstep", (n1, n2)
        if n1 >= 8 and not windowed and 512 <= N <= 3072:
            return "hybrid", (n1, n2)
        if n1 >= 8 and N > 8192:
            return "fft4", (n1, n2)
        return "xla", None
    if backend in ("matmul", "bluestein", "xla"):
        return backend, None
    if backend == "fourstep4x":
        n1x, n2x = best_fourstep4x_split(N)
        if n1x not in (8, 16, 32):
            raise ValueError(
                f"backend='fourstep4x' needs N divisible by 8 "
                f"(N={N}); use backend='auto'")
        return "fourstep4x", (n1x, n2x)
    if backend == "hybrid":
        n1, n2 = best_hybrid_split(N, min_n1=8)
    else:
        n1, n2 = best_fourstep_split(N)
    if n1 > 1:
        return backend, (n1, n2)
    if backend in ("fourstep4m", "fft4"):
        raise ValueError(
            f"backend='{backend}' needs composite N (N={N} is prime); "
            "use backend='auto'")
    # hybrid/fourstep at prime N: the platform FFT serves the request.
    return "xla", None


def tapered_batch_mode(N: int) -> str:
    """Transform choice for estimator steps whose input planes are
    already windowed-class (multitaper's tapered batch, the PFB's
    polyphase sums) or that need per-frame spectra (the SK family): the
    platform FFT on every platform (on CPU it IS the FFTW class
    yardstick; on the GPU, cuFFT)."""
    del N
    return "xla"


class PsdStep:
    """A jitted device step: (F, 2N) u8 frames → (N,) f32 partial power sum.

    One instance owns one compiled executable per (N, F, windowed) signature.
    ``n_valid`` masks out padding rows so the step shape never changes
    (static shapes: one compilation, no retraces).
    """

    def __init__(self, N: int, frames_per_step: int,
                 window: Optional[np.ndarray] = None,
                 backend: str = "auto",
                 precision: str = "highest"):
        """``precision``: 'highest' (default; the 1e-5 parity budget) or
        'high' (bf16x3-class matmuls in the matmul stages, opt-in for
        parity-relaxed deployments). Its error and speed were measured
        on CPU only, so on the GPU auto ignores it with one note."""
        if N % 2 != 0:
            raise ValueError("N must be even")
        if precision not in ("highest", "high"):
            raise ValueError("precision must be 'highest' or 'high'")
        if precision == "high" and backend == "auto" and on_gpu():
            import sys as _sys
            print("Note: --precision high has no effect on the GPU (its "
                  "error and speed there are not measured); auto uses "
                  "highest.", file=_sys.stderr)
            precision = "highest"
        self._precision = (jax.lax.Precision.HIGHEST if precision == "highest"
                           else jax.lax.Precision.HIGH)
        self.N = N
        # Small batches (e.g. the 1M-point long-integration mode) keep a
        # small F; the two-stage sum chunk adapts to the largest
        # power-of-two divisor so padding waste stays bounded.
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.backend = backend
        self.window = None
        if window is not None:
            w = np.asarray(window, dtype=np.float32)
            if w.shape != (N,):
                raise ValueError(f"window must have shape ({N},), got {w.shape}")
            self.window = w
        self._power = _power_backend(backend, N)
        self._nv_full = None
        self._u16_in = False   # set by _make_step for the fused rungs
        #: which rung _make_step selected for this (N, F, window,
        #: backend, platform) signature: "hybrid" | "fourstep" |
        #: "fourstep4m" | "fourstep4x" | "fft4" | "bluestein" | "xla"
        #: (plus "matmul" — explicit request or compile fallback) —
        #: introspection for band tests and users (auto resolves per
        #: platform).
        self.path = "matmul" if backend == "matmul" else "xla"
        self._step = jax.jit(self._make_step())

    def _make_step(self):
        N, F = self.N, self.F
        window = None if self.window is None else jnp.asarray(self.window)
        power_fn = self._power

        if (self.backend == "auto"
                and self._precision != jax.lax.Precision.HIGHEST):
            # precision='high' (relaxed parity) on the CPU ladder: the
            # FFT four-step at small composite N. Its error is
            # f32-XLA-FFT class: ~2e-7 on uniform input but up to ~9e-5
            # under a 35 dB tone at 2048 — hence opt-in.
            from .dft import best_fourstep_split, fourstep_fft_psd_partial
            n1_, _ = best_fourstep_split(N)
            if n1_ >= 8 and N <= 1024:
                self._u16_in = True
                self.path = "fft4"
                chunk = self._chunk
                windowed_arr = window

                def fast_step(raw16: jax.Array, n_valid: jax.Array) -> jax.Array:
                    re, im = dequant_iq_u16(raw16, windowed_arr)
                    fmask = (jax.lax.broadcasted_iota(jnp.int32, (F,), 0)
                             < n_valid).astype(jnp.float32)
                    return fourstep_fft_psd_partial(re, im, fmask,
                                                    chunk=chunk)

                return fast_step

        # Band selection lives ONCE in select_transform_rung (shared
        # with ShardedPsdStep); this builder only constructs the chosen
        # rung's step closure.
        path, split = select_transform_rung(N, window is not None,
                                            self.backend)
        self.path = path
        fused_partial = None
        precision_cfg = self._precision
        if path == "hybrid":
            from .dft import fourstep_hybrid_psd_partial
            fused_partial = (fourstep_hybrid_psd_partial, *split)
        elif path == "fourstep":
            from .dft import fourstep_psd_partial
            fused_partial = (fourstep_psd_partial, *split)
        elif path == "fft4":
            from .dft import fourstep_fft_psd_partial
            precision_cfg = None  # FFT stages have no matmul knob
            fused_partial = (fourstep_fft_psd_partial, *split)
        elif path == "fourstep4m":
            from .dft import fourstep4m_psd_partial
            fused_partial = (fourstep4m_psd_partial, *split)
        elif path == "fourstep4x":
            from .dft import fourstep4x_psd_partial
            fused_partial = (fourstep4x_psd_partial, *split)
        elif path == "bluestein":
            from .dft import bluestein_psd_partial
            precision_cfg = None  # chirp-Z has no matmul knob
            fused_partial = (bluestein_psd_partial, None, None)
        # The fused rungs take the interleaved (re, im) u8 pairs as one
        # little-endian u16 lane: free on the host (ndarray.view), a real
        # relayout pass when done on device.
        self._u16_in = fused_partial is not None
        if self._precision != jax.lax.Precision.HIGHEST:
            fp_name = fused_partial[0].__name__ if fused_partial else None
            if fused_partial is None:
                import sys as _sys
                print("Warning: --precision high affects the FFT "
                      "four-step fast path (composite N <= 1024) and the "
                      "hybrid/matmul four-step stage-2 matmuls (composite "
                      f"N); this step (backend={self.backend}, N={N}) "
                      "ignores it.", file=_sys.stderr)
            elif fp_name in ("fourstep_fft_psd_partial",
                             "bluestein_psd_partial"):
                import sys as _sys
                print("Note: --precision high is a no-op on the "
                      f"{'chirp-Z' if 'blue' in fp_name else 'FFT four-step'} "
                      f"path selected here (backend={self.backend}, "
                      f"N={N}): its FFT stages have no matmul precision "
                      "knob.", file=_sys.stderr)
        chunk = self._chunk
        u16_in = self._u16_in

        def step(raw: jax.Array, n_valid: jax.Array) -> jax.Array:
            # raw: (F, 2N) uint8 interleaved IQ — or (F, N) uint16 when
            # the step takes the host-side u16 view; n_valid: scalar i32.
            if u16_in:
                re, im = dequant_iq_u16(raw, window)
            else:
                re, im = dequant_iq(raw, F, N, window)
            fmask = (jax.lax.broadcasted_iota(jnp.int32, (F,), 0)
                     < n_valid).astype(jnp.float32)
            if fused_partial is not None:
                fn, n1, n2 = fused_partial
                return fn(re, im, fmask, n1, n2, chunk=chunk,
                          precision=precision_cfg)
            pwr = power_fn(re, im)  # (F, N) f32, unshifted bins
            pwr = pwr * fmask[:, None]
            # Two-stage tree sum for f32 accuracy.
            g = F // chunk
            partial = pwr.reshape(g, chunk, N).sum(axis=1).sum(axis=0)
            return partial

        return step

    def __call__(self, raw: np.ndarray, n_valid: int) -> jax.Array:
        """Dispatch one step. ``raw`` is (F, 2N) u8 (padded), ``n_valid``
        the number of real frames. Returns the device array (async).

        The all-frames-valid scalar is cached device-side, so a full
        step uploads no host scalar.
        """
        if self._u16_in and raw.dtype == np.uint8:
            raw = raw.view(np.uint16)  # free reinterpretation on the host
        if n_valid == self.F:
            if self._nv_full is None:
                self._nv_full = jnp.int32(self.F)
            nv = self._nv_full
        else:
            nv = jnp.int32(n_valid)
        try:
            return self._step(raw, nv)
        except Exception as e:  # noqa: BLE001 - filtered in the handler
            if not self._fallback_to_matmul(e):
                raise
            return self._step(raw, nv)

    def _fallback_to_matmul(self, e: Exception) -> bool:
        """Last-resort compile resilience for auto's final ladder rung.

        Every rung above the monolithic platform FFT is measured and
        shape-gated, but the "xla" rung delegates lowering entirely to
        the backend — and a backend FFT emitter CAN refuse a shape. The
        matmul DFT always lowers — it is plain dot-generals — and shares
        the xla rung's u8 input convention, so
        the session degrades seamlessly instead of dying mid-acquisition
        (the reference never aborts on a plannable size either: FFTW
        plans ANY N, datastore.cxx:30-33). Returns True if the step was
        rebuilt and the dispatch should be retried."""
        if not (self.backend == "auto" and self.path == "xla"):
            return False
        if not warn_fft_compile_fallback(self.N, e, "the step"):
            return False  # runtime/user errors propagate untouched
        self._power = _power_backend("matmul", self.N)
        self.backend = "matmul"
        try:
            self._step = jax.jit(self._make_step())
        finally:
            self.backend = "auto"  # keep the user's request introspectable
        self.path = "matmul"
        return True

    def lowered_fn(self):
        """The raw jitted function, for entry-point/compile checks.

        NOTE: when a fused rung is the selected path (``self.takes_u16``),
        the function takes (F, N) uint16 — the u8 buffer viewed as
        little-endian IQ pairs — instead of (F, 2N) u8."""
        return self._step

    @property
    def takes_u16(self) -> bool:
        return self._u16_in

    def example_args(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._u16_in:
            return np.zeros((self.F, self.N), dtype=np.uint16), np.int32(0)
        raw = np.zeros((self.F, 2 * self.N), dtype=np.uint8)
        return raw, np.int32(0)


class FrameSlicer:
    """Splits an arbitrary byte stream into (F, 2N) u8 frame batches.

    Host-side replacement for the reference's carry of ``fft_pointer``
    across buffers (datastore.cxx:52,66-80): remainder bytes from one
    buffer prepend the next. Optionally frames overlap (Welch mode,
    an extension): ``hop_bytes`` < frame_bytes keeps a tail overlap.
    """

    def __init__(self, N: int, hop: Optional[int] = None):
        self.frame_bytes = 2 * N
        hop = N if hop is None else int(hop)
        if not (0 < hop):
            raise ValueError("hop must be positive")
        self.hop_bytes = 2 * hop
        self._carry = np.zeros(0, dtype=np.uint8)

    def reset(self) -> None:
        self._carry = np.zeros(0, dtype=np.uint8)

    def push(self, data: np.ndarray, max_frames: Optional[int] = None) -> np.ndarray:
        """Append bytes; return all complete frames as (n, 2N) u8.

        ``max_frames`` caps the frames produced (reference stops filling
        FFTs once ``repeats`` is reached, datastore.cxx:67 — remaining
        bytes are discarded by the caller simply by not pushing more).

        CONTRACT: on the aligned fast path the returned frames are a
        zero-copy VIEW of ``data`` — consume or copy them before reusing
        or mutating the input buffer. The internal carry is always an
        owned copy, never an alias of caller memory.
        """
        fb, hb = self.frame_bytes, self.hop_bytes
        if max_frames is not None and int(max_frames) <= 0:
            # The acquisition already has all the frames it will ever take
            # (datastore.cxx:67 stops at ``repeats``): discard instead of
            # growing the carry — an over-reading producer would otherwise
            # cause quadratic re-concatenation and unbounded host memory.
            self._carry = np.zeros(0, dtype=np.uint8)
            return np.zeros((0, fb), dtype=np.uint8)
        data = np.asarray(data, dtype=np.uint8).ravel()
        if len(self._carry):
            buf = np.concatenate([self._carry, data])
        else:
            buf = data  # aligned fast path: no copy of the whole buffer
        if len(buf) < fb:
            self._carry = np.array(buf, copy=True)
            return np.zeros((0, fb), dtype=np.uint8)
        n = 1 + (len(buf) - fb) // hb
        if max_frames is not None:
            n = min(n, int(max_frames))
        if hb == fb:
            flat = buf[:n * fb]
            frames = flat.reshape(n, fb)  # view, no copy
        else:
            idx = (np.arange(n)[:, None] * hb) + np.arange(fb)[None, :]
            frames = buf[idx]
        # Detach the (small) carry so it doesn't pin the whole buffer.
        self._carry = np.array(buf[n * hb:], copy=True)
        return frames


def bin_frequencies(tuned_freq: int, N: int, actual_samplerate: int) -> np.ndarray:
    """Per-bin frequency axis (acquisition.cxx:391):
    freq_i = tuned_freq + (i − N/2.0)·actual_samplerate/N, in float64."""
    i = np.arange(N, dtype=np.float64)
    return tuned_freq + (i - N / 2.0) * actual_samplerate / N


def finalize_psd(pwr: np.ndarray, repeats_done: int, actual_samplerate: int,
                 linear: bool = False,
                 baseline: Optional[np.ndarray] = None,
                 already_shifted: bool = False) -> np.ndarray:
    """Turn an accumulated (unshifted) power vector into output PSD values.

    Mirrors acquisition.cxx:376-399 in float64:
      fftshift → DC-bin interpolation → /repeats/N/rate → 10·log10 (unless
      linear) → baseline subtraction (baseline is in *output* units, i.e.
      subtracted after the dB conversion).
    Returns the per-bin values; the caller formats/writes them.
    """
    pwr = np.asarray(pwr, dtype=np.float64)
    N = pwr.shape[-1]
    shifted = pwr.copy() if already_shifted else np.fft.fftshift(pwr, axes=-1)
    # Interpolate the central point to cancel DC bias (acquisition.cxx:376-377).
    shifted[..., N // 2] = (shifted[..., N // 2 - 1] + shifted[..., N // 2 + 1]) / 2.0
    psd = shifted / repeats_done / N / actual_samplerate
    if not linear:
        with np.errstate(divide="ignore"):
            psd = 10.0 * np.log10(psd)
    if baseline is not None:
        psd = psd - np.asarray(baseline, dtype=np.float64)
    return psd
