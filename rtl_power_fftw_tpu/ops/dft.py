"""DFT-as-matmul transform rungs.

The matmul rungs express the DFT as dense matrix products, the other
transform family beside the platform FFT.  For batched power spectra
there are three basic designs, all provided here or in :mod:`spectral`:

1. ``xla``     — ``jnp.fft.fft``: XLA's decomposition. Baseline.
2. ``matmul``  — direct DFT as four real (F,N)x(N,N) matmuls. O(N²) FLOPs
                 per frame but runs entirely as matmuls; wins for small N
                 where FFT overhead dominates.
3. ``fourstep``— Bailey/Cooley-Tukey split N = N1·N2: two skinny matmul
                 passes + a twiddle multiply. O(N·(N1+N2)) FLOPs;
                 the scalable path for large N (including the 1M-point mode).

The reference's equivalent is FFTW's plan (datastore.cxx:30-33); these are
not translations of it but matmul formulations.

All f32 matmuls pass ``precision=HIGHEST`` explicitly — the
averaged-spectrum parity budget is 1e-5 relative, and a bare f32 dot may
run at reduced precision (bf16 passes, or TF32 on a GPU). HIGH (bf16x3
class) is a deliberate headroom knob for deployments that can accept
~1e-4.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=32)
def _dft_matrices(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix W[n,k] = exp(-2πi·n·k/N).

    Built in float64 and rounded once to float32 (cached), so every call
    sees identical constants.
    """
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(N, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((n * k) % N) / N
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft_power_matmul(re: jax.Array, im: jax.Array) -> jax.Array:
    """|DFT(re + i·im)|² via four real matmuls.

    re, im: (..., N) float32.  Returns (..., N) float32 power.
    """
    N = re.shape[-1]
    wr, wi = _dft_matrices(N)
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    xre = jnp.matmul(re, wr, precision=_HI) - jnp.matmul(im, wi, precision=_HI)
    xim = jnp.matmul(re, wi, precision=_HI) + jnp.matmul(im, wr, precision=_HI)
    return xre * xre + xim * xim


def best_fourstep_split(N: int) -> Tuple[int, int]:
    """Pick N = N1·N2 with N1, N2 as close as possible (minimises FLOPs
    ∝ N1+N2)."""
    best = (1, N)
    for n1 in range(int(math.isqrt(N)), 0, -1):
        if N % n1 == 0:
            best = (n1, N // n1)
            break
    return best


@functools.lru_cache(maxsize=32)
def _fourstep_constants(N: int, N1: int, N2: int):
    """DFT matrices for the two stages plus the twiddle factors.

    Twiddle T[k1, n2] = exp(-2πi·k1·n2/N).
    """
    c1, s1 = _dft_matrices(N1)
    c2, s2 = _dft_matrices(N2)
    k1 = np.arange(N1, dtype=np.float64)[:, None]
    n2 = np.arange(N2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((k1 * n2) % N) / N
    return (c1, s1, c2, s2,
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=32)
def _fourstep2_constants(N: int, N1: int, N2: int):
    """Constants for the transpose-free four-step: the twiddle is stored
    pre-transposed as T[n2, k1] so it multiplies the stage-1 output layout
    (F, n2, k1) directly — no intermediate transposes touch HBM. The
    (cos+sin) sums feed the Karatsuba 3-multiplication complex matmul."""
    c1, s1 = _dft_matrices(N1)
    c2, s2 = _dft_matrices(N2)
    n2 = np.arange(N2, dtype=np.float64)[:, None]
    k1 = np.arange(N1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((n2 * k1) % N) / N
    return (c1, s1, (c1 + s1).astype(np.float32),
            c2, s2, (c2 + s2).astype(np.float32),
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def fourstep_psd_partial(re: jax.Array, im: jax.Array, fmask: jax.Array,
                         N1: int | None = None, N2: int | None = None,
                         chunk: int = 64,
                         precision: jax.lax.Precision | None = None) -> jax.Array:
    """Masked partial PSD sum via a transpose-free four-step DFT.

    Computes Σ_f fmask[f]·|DFT(re[f] + i·im[f])|² in one matmul chain with
    no layout transposes on (F, N)-sized data: stage-1's natural
    dot_general output layout (F, n2, k1) is kept, the twiddle is stored
    pre-transposed, stage 2 contracts the n2 axis in place, and the frame
    reduction happens BEFORE the bin-order fixup so only an (N1, N2) tile
    is ever reordered. This halves device-memory traffic vs the naive
    formulation.

    re, im: (F, N) float32; fmask: (F,) float32 validity mask.
    Returns (N,) float32, unshifted bins.
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    c1, s1, cs1, c2, s2, cs2, tc, ts = (
        jnp.asarray(a) for a in _fourstep2_constants(N, N1, N2))
    while F % chunk != 0:
        chunk //= 2
    prec = _HI if precision is None else precision

    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)
    dn = (((1,), (0,)), ((), ()))  # contract axis 1 with weight axis 0

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, precision=prec)

    def cmatmul(ar, ai, br, bi, bsum):
        # Karatsuba 3-multiplication complex matmul: re = t1 − t2,
        # im = (ar+ai)@(br+bi) − t1 − t2 — 3 matmul passes instead of 4
        # (measured +14% end-to-end at equal ~3e-7 accuracy).
        t1 = dot(ar, br)
        t2 = dot(ai, bi)
        t3 = dot(ar + ai, bsum)
        return t1 - t2, t3 - t1 - t2

    # Stage 1 (contract n1): natural output layout (F, n2, k1).
    yr, yi = cmatmul(xr, xi, c1, s1, cs1)
    # Twiddle in the same layout (T pre-transposed to (n2, k1)).
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc
    # Stage 2 (contract n2, now axis 1): output (F, k1, k2).
    xr2, xi2 = cmatmul(zr, zi, c2, s2, cs2)

    p = (xr2 * xr2 + xi2 * xi2) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)  # (k1, k2)
    # Bin k = k1 + N1·k2 → row-major (k2, k1); only this small tile moves.
    return jnp.swapaxes(s, 0, 1).reshape(N)


@functools.lru_cache(maxsize=16)
def _fourstep4m_constants(N: int, N1: int, N2: int):
    """Constants for the COMPENSATED four-step (4-mult stages + split
    twiddle): plain stage DFT matrices (no Karatsuba sums — its
    Xi = t3−t1−t2 cancellation fattens adversarial tails, measured in
    probes/hybrid_s2_dist.py and again at windowed 2^17 in
    probes/windowed_comp.py) and the hi+lo split of the (n2, k1)
    pre-transposed twiddle (the shipping fourstep's single-f32 twiddle
    representation error is its dominant compensable term —
    probes/windowed_attrib.py measured its f64-finished stage 1 at
    0.34x class at windowed 2^19 vs 1.80x all-device)."""
    c1, s1 = _dft_matrices(N1)
    c2, s2 = _dft_matrices(N2)
    n2 = np.arange(N2, dtype=np.int64)[:, None]
    k1 = np.arange(N1, dtype=np.int64)[None, :]
    ang = -2.0 * np.pi * ((n2 * k1) % N).astype(np.float64) / N
    tr, ti = np.cos(ang), np.sin(ang)
    thr = tr.astype(np.float32)
    thi = ti.astype(np.float32)
    return (c1, s1, c2, s2, thr, thi,
            (tr - thr).astype(np.float32), (ti - thi).astype(np.float32))


def _fourstep4m_tail(yr: jax.Array, yi: jax.Array, consts, N2: int,
                     prec):
    """The compensated four-step's post-stage-1 path, shared by every
    stage-1 variant: hi+lo split twiddle (in the (F, n2, k1) layout) +
    chunked stage-2 tree accumulation. Returns (Xr, Xi) in the
    (F, k1, k2) layout (bin k = k1 + N1·k2)."""
    F, _, N1 = yr.shape
    c1, s1, c2, s2, thr, thi, tlr, tli = consts
    s2_chunks = max(1, N2 // 256)
    while N2 % s2_chunks != 0:
        s2_chunks -= 1
    dn = (((1,), (0,)), ((), ()))  # contract axis 1 with weight axis 0

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, precision=prec)

    # Split twiddle in the stage-1 output layout.
    zr = (yr * thr - yi * thi) + (yr * tlr - yi * tli)
    zi = (yr * thi + yi * thr) + (yr * tli + yi * tlr)
    # Stage 2 (contract n2, axis 1), chunked tree accumulation.
    if s2_chunks == 1:
        Xr = dot(zr, c2) - dot(zi, s2)         # (F, k1, k2)
        Xi = dot(zr, s2) + dot(zi, c2)
    else:
        g2, cs = s2_chunks, N2 // s2_chunks
        zr4 = zr.reshape(F, g2, cs, N1)
        zi4 = zi.reshape(F, g2, cs, N1)
        c2r = c2.reshape(g2, cs, N2)
        s2r = s2.reshape(g2, cs, N2)
        pr, pi = [], []
        for j in range(g2):
            a, b = zr4[:, j], zi4[:, j]
            pr.append(dot(a, c2r[j]) - dot(b, s2r[j]))
            pi.append(dot(a, s2r[j]) + dot(b, c2r[j]))
        while len(pr) > 1:                     # pairwise tree (odd tail
            # carries through each level: 3 chunks → [0+1, 2] → [0+1+2])
            pr = [pr[i] + pr[i + 1] if i + 1 < len(pr) else pr[i]
                  for i in range(0, len(pr), 2)]
            pi = [pi[i] + pi[i + 1] if i + 1 < len(pi) else pi[i]
                  for i in range(0, len(pi), 2)]
        Xr, Xi = pr[0], pi[0]
    return Xr, Xi


def _fourstep4m_transform(re: jax.Array, im: jax.Array, N: int,
                          N1: int, N2: int, precision=None):
    """The compensated four-step's shared transform core: 4-mult stages,
    hi+lo split twiddle, chunked stage-2 tree accumulation. Returns
    (Xr, Xi) in the (F, k1, k2) layout (bin k = k1 + N1·k2); used by
    both the masked-partial and the per-frame-power wrappers."""
    F = re.shape[0]
    consts = tuple(jnp.asarray(a)
                   for a in _fourstep4m_constants(N, N1, N2))
    c1, s1 = consts[0], consts[1]
    prec = _HI if precision is None else precision
    dn = (((1,), (0,)), ((), ()))  # contract axis 1 with weight axis 0

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, precision=prec)

    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)
    # Stage 1 (contract n1), natural output layout (F, n2, k1).
    yr = dot(xr, c1) - dot(xi, s1)
    yi = dot(xr, s1) + dot(xi, c1)
    return _fourstep4m_tail(yr, yi, consts, N2, prec)


def _fourstep4m_splitw_transform(re: jax.Array, im: jax.Array,
                                 w_hi: jax.Array, w_lo: jax.Array,
                                 N: int, N1: int, N2: int,
                                 precision=None, lo_precision=None):
    """Compensated four-step with a SPLIT-WINDOW stage 1 (round-5
    windowed session-size attack — VERDICT ask #1 variant (a)).

    The shipped windowed fourstep4m sees x·w rounded once at f32 ε per
    sample before stage 1 ever runs; the round-4 attribution
    (probes/windowed_attrib.py) measured the stage-1 HIGHEST matmul on
    that non-integer input at 1.57× the windowed scipy-f32 class with
    everything after it in f64 — i.e. stage 1 is where the windowed
    session-size excess lives. Here the window is split w = w_hi
    (15-bit mantissa) + w_lo (f32 residual) so the dominant per-sample
    product x·w_hi is EXACT in f32 (8-bit integers × 15-bit window ≤ 23
    significand bits — the same trick the hybrid's split-window stage 1
    shipped in fourstep_hybrid_windowed_psd_partial), and stage 1 runs
    on each plane separately; matmul linearity makes
    S1(x·w) = S1(x·w_hi) + S1(x·w_lo) exact in representation. The lo
    plane carries ≤2⁻¹⁴ of the signal, so its stage-1 matmul may ride a
    cheaper precision (``lo_precision``, default DEFAULT ≈ one native
    bf16 pass per product: bf16's ~2⁻⁸ error on a 2⁻¹⁴-scale term is
    ~2⁻²² relative to the total — below f32 ε). Twiddle and stage 2 are
    the audited fourstep4m tail unchanged.

    NOTE the hybrid-side measurement does NOT transfer: for the FFT
    stage 1 the split-window variant measured IDENTICAL to plain
    windowed (BENCHMARKS "the split-window hypothesis is dead") because
    the FFT's internal arithmetic dominates; the matmul stage 1 at
    Precision.HIGHEST has no internal rounding beyond the f32
    accumulation, so removing the input-representation rounding is the
    open lever probes/windowed_s1.py measures.

    re, im: (F, N) float32 UNWINDOWED dequantized integers.
    """
    F = re.shape[0]
    consts = tuple(jnp.asarray(a)
                   for a in _fourstep4m_constants(N, N1, N2))
    c1, s1 = consts[0], consts[1]
    prec = _HI if precision is None else precision
    lo_prec = (jax.lax.Precision.DEFAULT if lo_precision is None
               else lo_precision)
    dn = (((1,), (0,)), ((), ()))

    def dot(a, b, p):
        return jax.lax.dot_general(a, b, dn, precision=p)

    wh = w_hi.reshape(N1, N2)[None]
    wl = w_lo.reshape(N1, N2)[None]
    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)
    xrh, xih = xr * wh, xi * wh            # exact f32 products
    xrl, xil = xr * wl, xi * wl            # ~2^-38-relative rounding
    # Stage 1 per plane (contract n1), natural layout (F, n2, k1).
    yr = ((dot(xrh, c1, prec) - dot(xih, s1, prec))
          + (dot(xrl, c1, lo_prec) - dot(xil, s1, lo_prec)))
    yi = ((dot(xrh, s1, prec) + dot(xih, c1, prec))
          + (dot(xrl, s1, lo_prec) + dot(xil, c1, lo_prec)))
    return _fourstep4m_tail(yr, yi, consts, N2, prec)


def fourstep4m_splitw_psd_partial(re: jax.Array, im: jax.Array,
                                  fmask: jax.Array,
                                  w_hi: jax.Array, w_lo: jax.Array,
                                  N1: int | None = None,
                                  N2: int | None = None,
                                  chunk: int = 64, precision=None,
                                  lo_precision=None) -> jax.Array:
    """Masked partial PSD via the split-window compensated four-step
    (see :func:`_fourstep4m_splitw_transform`). re, im are UNWINDOWED
    (F, N) float32 dequantized integers; w_hi/w_lo from
    :func:`split_window`. Returns (N,) float32, unshifted bins."""
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    while F % chunk != 0:
        chunk //= 2
    Xr, Xi = _fourstep4m_splitw_transform(re, im, w_hi, w_lo, N, N1, N2,
                                          precision, lo_precision)
    p = (Xr * Xr + Xi * Xi) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def fourstep4m_psd_partial(re: jax.Array, im: jax.Array, fmask: jax.Array,
                           N1: int | None = None, N2: int | None = None,
                           chunk: int = 64, precision=None,
                           s2_chunks: int | None = None) -> jax.Array:
    """Masked partial PSD via the COMPENSATED transpose-free four-step:
    4-mult complex stages (no Karatsuba), hi+lo SPLIT twiddle, and the
    stage-2 contraction split into <=256-deep chunks tree-summed in f32.

    The windowed very-large-N budget-truth path (round-4 ask #1). The
    attribution probe (probes/windowed_attrib.py, BENCHMARKS.md
    "Windowed error ATTRIBUTION") showed the plain fourstep's windowed
    excess is almost entirely twiddle representation + stage-2
    arithmetic (its stage-1 output finished in f64 reads 0.34x class at
    2^19), and probes/windowed_comp.py measured this compensated form
    at windowed 2^17 p50 1.19x class (vs 1.50x plain fourstep, 2.90x
    hybrid) — the accuracy recovery costs ~4/3 matmul passes (4-mult vs
    Karatsuba's 3) plus the split-twiddle elementwise term.

    re, im: (F, N) float32; fmask: (F,) float32. Returns (N,) float32,
    unshifted bins (same k = k1 + N1·k2 flattening as the family).
    ``precision`` applies to the stage matmuls (default HIGHEST).
    ``s2_chunks`` is accepted for signature compatibility and ignored
    (the shared core always chunks the stage-2 contraction <= 256 deep
    — the shipped, audited form).
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    while F % chunk != 0:
        chunk //= 2
    Xr, Xi = _fourstep4m_transform(re, im, N, N1, N2, precision)
    p = (Xr * Xr + Xi * Xi) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def dft_power_fourstep4m(re: jax.Array, im: jax.Array,
                         N1: int | None = None,
                         N2: int | None = None) -> jax.Array:
    """|DFT|² per frame via the COMPENSATED four-step (4-mult stages +
    split twiddle + chunked stage-2) — the per-frame-spectra sibling of
    :func:`fourstep4m_psd_partial` for estimator steps that need (F, N)
    power planes on windowed-class input (the windowed SK family: its
    s1 accumulator doubles as the session's PSD, so it should carry the
    same compensated accuracy the windowed session band ships).
    Same signature contract as dft_power_fourstep."""
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    Xr, Xi = _fourstep4m_transform(re, im, N, N1, N2)
    p = Xr * Xr + Xi * Xi                      # (F, k1, k2)
    return jnp.transpose(p, (0, 2, 1)).reshape(F, N)


def best_fourstep4x_split(N: int) -> Tuple[int, int]:
    """Stage-1 split for the split-pass four-step (fourstep4x).

    The round-5 stage-1 attribution chain (probes/windowed_s1.py →
    probes/s1_diag.py → probes/windowed_s1x.py) located the windowed
    session-size excess in the stage-1 contraction DEPTH: with every
    product term exact (4-term bf16 input × 4-term bf16 weight splits,
    triangular pass set), the remaining error is the f32 accumulation
    of K = N1 sequential adds, and the measured budget boundary is
    K = 16 unchunked / K = 32 with a depth-16 chunked tree — both hold
    the windowed scipy-f32 class at med ≤ 1.5× where the near-square
    split fails (e.g. 4096: 64×64 reads 1.95×, 16×256 reads 0.99×).
    Prefers K = 16 direct: across the probed band (1024–16384, runs
    4–6) it reads med 0.73–1.05× with per-seed p99 ≤ 2.3, while the
    K = 32 chunk-16 tree sits at 1.33–1.46× at 1024–3072 — too close
    to the 1.5× admission line for a 60-seed pool (the round-4
    lesson). K = 8 (for N divisible by 8 only) is strictly shallower,
    hence admissible by the same depth argument; callers gate on a
    viable split existing.
    """
    for n1 in (16, 8):
        if N % n1 == 0:
            return n1, N // n1
    return best_fourstep_split(N)


@functools.lru_cache(maxsize=16)
def _s1x_weight_terms(N1: int, n_terms: int, chunk_k: int):
    """``n_terms``-term bf16 truncation splits of the stage-1 DFT
    matrices for the split-pass four-step, pre-reshaped to
    (G, N1/G, N1) when the contraction rides the chunk-``chunk_k``
    tree (0 = unchunked)."""
    import ml_dtypes

    def terms(m):
        out, r = [], np.asarray(m, np.float64)
        for _ in range(n_terms):
            t = r.astype(ml_dtypes.bfloat16)
            out.append(t)
            r = r - t.astype(np.float64)
        if chunk_k:
            g = N1 // chunk_k
            out = [t.reshape(g, chunk_k, N1) for t in out]
        return tuple(out)

    c1, s1 = (m.astype(np.float64) for m in _dft_matrices(N1))
    return terms(c1), terms(s1)


@functools.lru_cache(maxsize=16)
def _s1x_stacked_weights(N1: int):
    """K-STACKED split-pass stage-1 weights: the triangular pass set
    AND the complex combination folded into the contraction axis of
    two (2·passes·N1, N1) bf16 stacks — one fat matmul in place of
    the narrow 40-dot form. lhs blocks are [xr_i per pass] +
    [xi_i per pass]; yr = lhs @ WR, yi = lhs @ WI. Accumulating all
    passes in one f32 chain is budget-safe: 9 of the 10 blocks carry
    terms ≤ 2⁻⁸..2⁻²⁴ of the dominant one, so their accumulation-error
    contributions scale down proportionally (24-seed screens med
    0.67–1.10×, 60-seed admission in BENCHMARKS)."""
    import ml_dtypes
    passes = [(i, j) for i, mj in enumerate(_S1X_MAX_J)
              for j in range(mj + 1)]
    c64, s64 = ([t.astype(np.float64) for t in ts]
                for ts in _s1x_weight_terms(N1, len(_S1X_MAX_J), 0))
    WR = np.vstack([c64[j] for _, j in passes]
                   + [-s64[j] for _, j in passes])
    WI = np.vstack([s64[j] for _, j in passes]
                   + [c64[j] for _, j in passes])
    return (WR.astype(ml_dtypes.bfloat16), WI.astype(ml_dtypes.bfloat16),
            tuple(i for i, _ in passes))


#: Triangular pass set for the split-pass stage 1: input term i is
#: multiplied by weight terms j ≤ MAX_J[i], i.e. pass (i, j) ships iff
#: i + j ≤ 3 — every product with relative magnitude ≥ ~2⁻³² (each bf16
#: term carries ~8 bits). Run-2/run-4 probes measured the full 16-pass
#: set identical to this 10-pass set to the printed digit.
_S1X_MAX_J = (3, 2, 1, 0)


def _fourstep4x_transform(re: jax.Array, im: jax.Array, N: int,
                          N1: int, N2: int, precision=None):
    """Compensated four-step with an EXPLICIT SPLIT-PASS stage 1 —
    the windowed session-size budget-truth path (round-5 ask #1).

    The reference computes windowed spectra through FFTW-f32
    (/root/reference/src/datastore.cxx:76-81); that class is the
    accuracy yardstick. The round-4/5 attribution chain proved the
    shipped fourstep4m's windowed 1024–16384 excess (med 1.9–2.4×
    class) lives entirely in stage 1's Precision.HIGHEST matmul on
    non-integer input: XLA's bf16x6 emulation drops the cross products
    of its operand splits — zero on exact integer input (why the
    unwindowed bands hold class), a correlated ~2⁻²⁴ error once the
    window multiplies the input. This transform replaces the emulated
    stage 1 with native-bf16 passes whose products are ALL exact:

    * 4-term bf16 truncation split of the windowed input (exact: 4×8
      significand bits ≥ f32's 24), via fold-proof bit masking;
    * 4-term bf16 truncation split of the stage-1 DFT matrices
      (host-side, cached);
    * the triangular 10-pass set (i + j ≤ 3) — drops only products
      below ~2⁻³² relative;
    * a SHALLOW f32 contraction: K = N1 ≤ 16 directly, or K = 32
      through a depth-16 chunked pairwise tree — the measured budget
      boundary (the near-square split's K = 64+ accumulation is the
      1.95× failure at 4096, probes/windowed_s1x.py runs 1–6).

    Twiddle and stage 2 are the audited fourstep4m tail unchanged.
    Measured (24-seed strict scipy-only yard, hann, 35 dB tones):
    med 0.84–1.46× class at windowed 1024–4096 where fourstep4m reads
    1.90–2.42× — see BENCHMARKS.md "Windowed session-size stage-1
    fix". Returns (Xr, Xi) in the (F, k1, k2) layout.
    """
    F = re.shape[0]
    consts = tuple(jnp.asarray(a)
                   for a in _fourstep4m_constants(N, N1, N2))
    prec = _HI if precision is None else precision
    n_terms = len(_S1X_MAX_J)
    chunk_k = 16 if N1 > 16 else 0
    G = N1 // chunk_k if chunk_k else 1
    c1t, s1t = ([jnp.asarray(t) for t in ts]
                for ts in _s1x_weight_terms(N1, n_terms, chunk_k))
    f32 = jnp.float32
    if G > 1:
        # lhs (F, N2, G, K/G) × rhs (G, K/G, N1): contract the split
        # K axis per chunk, batch over chunks → (G, F, N2, k1).
        dn = (((3,), (1,)), ((2,), (0,)))
    else:
        # lhs (F, N1, N2) × rhs (N1, N1): contract n1 → (F, N2, k1),
        # the family's natural transpose-free stage-1 layout.
        dn = (((1,), (0,)), ((), ()))

    def trunc_terms(z):
        # Fold-proof truncation split (see _trunc_split3): bit masking
        # cannot be constant-folded away under excess-precision rules.
        def trunc(v):
            u = jax.lax.bitcast_convert_type(v, jnp.uint32)
            return jax.lax.bitcast_convert_type(
                u & np.uint32(0xFFFF0000), jnp.float32)
        out, r = [], z
        for _ in range(n_terms):
            t = trunc(r)
            out.append(t.astype(jnp.bfloat16))
            r = r - t
        return out

    def stage1(x):
        """x (F, N1, N2) → (x @ c1, x @ s1), each (F, n2, k1)."""
        if G > 1:
            x = jnp.swapaxes(x, 1, 2).reshape(F, N2, G, chunk_k)
        zs = trunc_terms(x)

        def contract(wts):
            acc = None
            for i, mj in enumerate(_S1X_MAX_J):
                for j in range(mj + 1):
                    t = jax.lax.dot_general(zs[i], wts[j], dn,
                                            preferred_element_type=f32)
                    acc = t if acc is None else acc + t
            if G > 1:
                parts = [acc[g] for g in range(G)]
                while len(parts) > 1:   # pairwise tree, odd tail carries
                    parts = [parts[k] + parts[k + 1]
                             if k + 1 < len(parts) else parts[k]
                             for k in range(0, len(parts), 2)]
                return parts[0]
            return acc

        return contract(c1t), contract(s1t)

    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)
    if N2 >= 512:
        # K-stacked stage 1 (two fat dots; see _s1x_stacked_weights):
        # measured 1.5-1.9x the narrow 40-dot form at N >= 8192 where
        # stage-1 dispatch overhead dominates; at smaller N the narrow
        # form pipelines as well or better (probes/windowed_s1x_speed).
        WRnp, WInp, block_i = _s1x_stacked_weights(N1)
        WR, WI = jnp.asarray(WRnp), jnp.asarray(WInp)
        zr = trunc_terms(xr)
        zi = trunc_terms(xi)
        lhs = jnp.concatenate([zr[i] for i in block_i]
                              + [zi[i] for i in block_i], axis=1)
        dns = (((1,), (0,)), ((), ()))   # contract the stacked K axis
        yr = jax.lax.dot_general(lhs, WR, dns,
                                 preferred_element_type=f32)
        yi = jax.lax.dot_general(lhs, WI, dns,
                                 preferred_element_type=f32)
    else:
        rc, rs = stage1(xr)
        ic, is_ = stage1(xi)
        yr = rc - is_
        yi = rs + ic
    t3 = _fourstep4x_tail3_split(N2)
    if t3 is not None:
        # Large-N2 rectangular splits: the direct (N2×N2) stage-2
        # matmul is quadratic in N2 — compute the stage-2 DFT as its
        # own four-step. Output layout (F, k1, k_p, k_q); callers
        # recover the split via _fourstep4x_tail3_split.
        return _fourstep4x_tail3(yr, yi, N, N1, N2, t3[0], t3[1], prec)
    return _fourstep4m_tail(yr, yi, consts, N2, prec)


@functools.lru_cache(maxsize=16)
def _fourstep4x_tail3_constants(N: int, N1: int, N2: int,
                                P: int, Q: int):
    """Constants for the THREE-STAGE split-pass four-step tail: the
    outer hi+lo split twiddle (n2, k1) plus an inner four-step over the
    length-N2 stage-2 DFT (N2 = P·Q, its own hi+lo split twiddle) —
    the direct (N2×N2) stage-2 matmul is quadratic in N2 and falls off
    a cliff once the rectangular stage-1 split pushes N2 past ~256."""
    n2 = np.arange(N2, dtype=np.int64)[:, None]
    k1 = np.arange(N1, dtype=np.int64)[None, :]
    ang = -2.0 * np.pi * ((n2 * k1) % N).astype(np.float64) / N
    tr, ti = np.cos(ang), np.sin(ang)
    thr, thi = tr.astype(np.float32), ti.astype(np.float32)
    cP, sP = _dft_matrices(P)
    cQ, sQ = _dft_matrices(Q)
    q = np.arange(Q, dtype=np.int64)[:, None]
    kp = np.arange(P, dtype=np.int64)[None, :]
    ang2 = -2.0 * np.pi * ((q * kp) % N2).astype(np.float64) / N2
    t2r, t2i = np.cos(ang2), np.sin(ang2)
    t2hr, t2hi = t2r.astype(np.float32), t2i.astype(np.float32)
    return (thr, thi, (tr - thr).astype(np.float32),
            (ti - thi).astype(np.float32),
            cP, sP, cQ, sQ, t2hr, t2hi,
            (t2r - t2hr).astype(np.float32),
            (t2i - t2hi).astype(np.float32))


def _fourstep4x_tail3(yr: jax.Array, yi: jax.Array, N: int, N1: int,
                      N2: int, P: int, Q: int, prec):
    """Three-stage tail: outer split twiddle, then the length-N2
    stage-2 DFT computed as a four-step over N2 = P·Q (4-mult HIGHEST
    stages, inner hi+lo split twiddle — the audited fourstep4m
    ingredients at O(P+Q) instead of O(N2) MACs/sample). Input
    (F, n2, k1); returns (Xr, Xi) in the (F, k1, k_p, k_q) layout with
    bin k = k1 + N1·(k_p + P·k_q)."""
    F = yr.shape[0]
    (thr, thi, tlr, tli, cP, sP, cQ, sQ,
     t2hr, t2hi, t2lr, t2li) = (
        jnp.asarray(a) for a in _fourstep4x_tail3_constants(
            N, N1, N2, P, Q))
    dn = (((1,), (0,)), ((), ()))  # contract axis 1 with weight axis 0

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, precision=prec)

    # Outer split twiddle in the stage-1 output layout (F, n2, k1).
    zr = (yr * thr - yi * thi) + (yr * tlr - yi * tli)
    zi = (yr * thi + yi * thr) + (yr * tli + yi * tlr)
    # Inner four-step over n2 = Q·p + q: contract p → (F, Q, N1, k_p).
    zr4 = zr.reshape(F, P, Q, N1)
    zi4 = zi.reshape(F, P, Q, N1)
    ar = dot(zr4, cP) - dot(zi4, sP)
    ai = dot(zr4, sP) + dot(zi4, cP)
    # Inner split twiddle W_{N2}^{q·k_p}, layout (Q, k_p).
    t2h_r = t2hr[None, :, None, :]
    t2h_i = t2hi[None, :, None, :]
    t2l_r = t2lr[None, :, None, :]
    t2l_i = t2li[None, :, None, :]
    br = (ar * t2h_r - ai * t2h_i) + (ar * t2l_r - ai * t2l_i)
    bi = (ar * t2h_i + ai * t2h_r) + (ar * t2l_i + ai * t2l_r)
    # Contract q → (F, N1, k_p, k_q).
    Xr = dot(br, cQ) - dot(bi, sQ)
    Xi = dot(br, sQ) + dot(bi, cQ)
    return Xr, Xi


def _fourstep4x_tail3_split(N2: int):
    """(P, Q) for the three-stage tail, or None when the direct
    chunked stage-2 matmul should stay (N2 <= 256, or no viable
    factor). Both factors >= 8 keep the contraction depth sane."""
    if N2 <= 256:
        return None
    P, Q = best_fourstep_split(N2)
    return (P, Q) if P >= 8 else None


def fourstep4x_psd_partial(re: jax.Array, im: jax.Array, fmask: jax.Array,
                           N1: int | None = None, N2: int | None = None,
                           chunk: int = 64, precision=None) -> jax.Array:
    """Masked partial PSD via the split-pass four-step (see
    :func:`_fourstep4x_transform`). re, im: (F, N) float32 (windowed
    upstream on the windowed band); fmask: (F,) float32. Returns (N,)
    float32, unshifted bins (family k = k1 + N1·k2 flattening).
    ``precision`` applies to the stage-2/twiddle tail (stage 1 is the
    explicit native-bf16 split-pass scheme — it has no precision knob).
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep4x_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    while F % chunk != 0:
        chunk //= 2
    Xr, Xi = _fourstep4x_transform(re, im, N, N1, N2, precision)
    t3 = _fourstep4x_tail3_split(N2)
    g = F // chunk
    if t3 is not None:
        P, Q = t3
        p = (Xr * Xr + Xi * Xi) * fmask[:, None, None, None]
        s = p.reshape(g, chunk, N1, P, Q).sum(axis=1).sum(axis=0)
        # Bin k = k1 + N1·(k_p + P·k_q): flatten (k_q, k_p, k1) —
        # only the small (N1, P, Q) tile is reordered.
        return jnp.transpose(s, (2, 1, 0)).reshape(N)
    p = (Xr * Xr + Xi * Xi) * fmask[:, None, None]
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def dft_power_fourstep4x(re: jax.Array, im: jax.Array,
                         N1: int | None = None,
                         N2: int | None = None) -> jax.Array:
    """|DFT|² per frame via the split-pass four-step — the per-frame
    sibling of :func:`fourstep4x_psd_partial` for estimator steps that
    need (F, N) power planes at windowed-session-class accuracy (the
    windowed SK family rides the same transform the session band
    ships). Same signature contract as dft_power_fourstep4m."""
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep4x_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    Xr, Xi = _fourstep4x_transform(re, im, N, N1, N2)
    t3 = _fourstep4x_tail3_split(N2)
    if t3 is not None:
        p = Xr * Xr + Xi * Xi                  # (F, k1, k_p, k_q)
        return jnp.transpose(p, (0, 3, 2, 1)).reshape(F, N)
    p = Xr * Xr + Xi * Xi                      # (F, k1, k2)
    return jnp.transpose(p, (0, 2, 1)).reshape(F, N)


@functools.lru_cache(maxsize=8)
def _fft_fourstep_twiddle(N: int, N1: int, N2: int) -> np.ndarray:
    """Twiddle W_N^(k1·n2) as one complex64 (N1, N2) table."""
    k1 = np.arange(N1, dtype=np.float64)[:, None]
    n2 = np.arange(N2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((k1 * n2) % N) / N
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)


def fourstep_fft_psd_partial(re: jax.Array, im: jax.Array, fmask: jax.Array,
                             N1: int | None = None, N2: int | None = None,
                             chunk: int = 64,
                             precision=None) -> jax.Array:
    """Masked partial PSD via a TWO-LEVEL FFT four-step: both stages are
    jnp.fft over a factor axis (N = N1·N2), twiddle in between.

    The CPU ladder's very-large-N rung: the same transform computed as
    fft(axis=n1) → twiddle → fft(axis=n2) over batched short FFTs, bound
    by the memory traffic of the (F, N) complex64 intermediates. Matmul
    stages (fourstep_psd_partial*) cannot match it at huge N because
    each stage contracts K = √N ≈ 1024.

    Same math as parallel/bigfft.py's distributed transform on one
    device (that module shards the n2/k1 axes over a mesh; this is the
    single-device XLA formulation for the auto path).

    re, im: (F, N) float32; fmask: (F,) float32. Returns (N,) float32,
    unshifted bins (k = k1 + N1·k2 flattened like every other backend).
    ``precision`` is accepted for signature parity with the matmul
    four-step and ignored (FFT stages have no matmul precision knob).
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    tw = jnp.asarray(_fft_fourstep_twiddle(N, N1, N2))
    while F % chunk != 0:
        chunk //= 2

    x = jax.lax.complex(re, im).reshape(F, N1, N2)
    y = jnp.fft.fft(x, axis=1)            # over n1 → k1
    z = y * tw[None]
    X = jnp.fft.fft(z, axis=2)            # over n2 → k2; (F, k1, k2)
    p = (jnp.real(X) * jnp.real(X) + jnp.imag(X) * jnp.imag(X)) \
        * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def best_hybrid_split(N: int, lo: int = 64, hi: int = 512,
                      target: int = 128, min_n1: int = 1) -> Tuple[int, int]:
    """Split for the hybrid four-step: stage 2 (the f32-faithful HIGHEST
    matmul, the tone-robustness anchor) gets a lane-friendly length N2
    near ``target`` — a 128-wide stage-2 contraction is one fat
    aligned pass — while stage 1 (a batched FFT over the bf16-exact
    integer inputs) takes N1 = N/N2. The tone leak lives in stage 2's
    *precision*, not its length, so shrinking N2 costs no accuracy (see
    fourstep_hybrid_psd_partial). The CPU ladder uses the near-square
    split instead (CPU BLAS accumulation tail).

    ``min_n1`` keeps the stage-1 FFT length sensible (the auto ladder
    uses 8). Returns (N1, N2); falls back to best_fourstep_split when N
    has no divisor in [lo, hi] compatible with ``min_n1``.
    """
    best = None
    for n2 in range(lo, hi + 1):
        if N % n2 == 0 and N // n2 >= min_n1:
            score = (abs(n2 - target), n2)
            if best is None or score < best[0]:
                best = (score, n2)
    if best is None:
        n1, n2 = best_fourstep_split(N)
        return n1, n2
    n2 = best[1]
    return N // n2, n2


@functools.lru_cache(maxsize=16)
def _hybrid_constants(N: int, N1: int, N2: int):
    """Split twiddle (hi + f32-residual lo, so the table is effectively
    f64-accurate) + stage-2 DFT matrix for the hybrid four-step. The
    shipping stage 2 stays 4-mult — the Karatsuba weight lives in
    ``_karatsuba_weight`` for the restructuring probes only
    (probes/hybrid_fold.py keeps the measured record)."""
    k1 = np.arange(N1, dtype=np.float64)[:, None]
    n2 = np.arange(N2, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((k1 * n2) % N) / N
    tr, ti = np.cos(ang), np.sin(ang)
    thr = tr.astype(np.float32)
    thi = ti.astype(np.float32)
    tlr = (tr - thr).astype(np.float32)
    tli = (ti - thi).astype(np.float32)
    c2, s2 = _dft_matrices(N2)
    return thr, thi, tlr, tli, c2, s2


def _karatsuba_weight(N2: int) -> np.ndarray:
    """(cos+sin) stage-2 weight for the 3-mult Karatsuba form — summed
    in float64, rounded once. Probe-only (probes/hybrid_fold.py,
    probes/hybrid_s2_dist.py): the form was measured +7-11% faster but
    with a fatter adversarial tail, and declined."""
    n = np.arange(N2, dtype=np.float64)[:, None]
    k = np.arange(N2, dtype=np.float64)[None, :]
    ang2 = -2.0 * np.pi * ((n * k) % N2) / N2
    return (np.cos(ang2) + np.sin(ang2)).astype(np.float32)


def fourstep_hybrid_psd_partial(re: jax.Array, im: jax.Array,
                                fmask: jax.Array,
                                N1: int | None = None, N2: int | None = None,
                                chunk: int = 64,
                                precision=None) -> jax.Array:
    """Masked partial PSD via the HYBRID four-step: stage 1 is a batched
    factor-length FFT, stage 2 a Precision.HIGHEST matmul, with a SPLIT
    twiddle (hi + residual) between them.

    The design comes from a measured error decomposition at N=2048 under
    a 35 dB tone (probes/fftfourstep_sweep.py narrative in
    BENCHMARKS.md): XLA's FFT stages are ~6× less tone-accurate than
    FFTW class, but the leak is almost entirely STAGE 2 — its inputs
    carry the tone coherently amplified by stage 1 (gain ~N1), so
    absolute stage-2 errors swamp small bins. Keeping the cheap fast
    stage 1 as an FFT (inputs are small dequantized integers), doing
    stage 2 as an f32-faithful matmul, and splitting the twiddle lands
    at ≤8e-6 under the same tone.

    re, im: (F, N) float32; fmask: (F,) float32. Returns (N,) float32,
    unshifted bins. ``precision`` applies to the stage-2 matmuls
    (default HIGHEST).
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    thr, thi, tlr, tli, c2, s2 = (
        jnp.asarray(a) for a in _hybrid_constants(N, N1, N2))
    while F % chunk != 0:
        chunk //= 2
    prec = _HI if precision is None else precision

    x = jax.lax.complex(re, im).reshape(F, N1, N2)
    y = jnp.fft.fft(x, axis=1)                    # over n1 → (F, k1, n2)
    yr, yi = jnp.real(y), jnp.imag(y)
    zr = (yr * thr[None] - yi * thi[None]) + (yr * tlr[None] - yi * tli[None])
    zi = (yr * thi[None] + yi * thr[None]) + (yr * tli[None] + yi * tlr[None])
    Xr = (jnp.matmul(zr, c2, precision=prec)
          - jnp.matmul(zi, s2, precision=prec))   # over n2 → (F, k1, k2)
    Xi = (jnp.matmul(zr, s2, precision=prec)
          + jnp.matmul(zi, c2, precision=prec))
    p = (Xr * Xr + Xi * Xi) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


@functools.lru_cache(maxsize=8)
def _split_window(key):
    """Split a float64 window into (w_hi, w_lo) f32 terms with
    w_hi's mantissa truncated to 15 bits.

    Dequantized IQ samples are 8-bit integers (x ∈ [-127, 128],
    datastore.cxx:75), so x·w_hi needs ≤ 23 significand bits — EXACT in
    f32 — while x·w_lo still rounds at f32 ε; since |w_lo| ≤ 2⁻¹⁴|w|
    (9 truncated fraction bits + the f64→f32 rounding of w), that
    rounding is ~2⁻³⁸ RELATIVE TO x·w. The windowed input is therefore
    represented as two f32 planes whose sum carries only the tiny w_lo
    rounding — which is what lets the hybrid keep (almost all of) its
    integer-anchor accuracy under a window (see
    fourstep_hybrid_windowed_psd_partial)."""
    w64 = np.frombuffer(key, dtype=np.float64)
    w_hi = np.asarray(w64, np.float32)
    w_hi = (w_hi.view(np.uint32) & np.uint32(0xFFFFFE00)).view(np.float32)
    w_lo = (w64 - w_hi).astype(np.float32)
    return w_hi, w_lo


def split_window(window) -> "tuple[np.ndarray, np.ndarray]":
    """Public wrapper: (w_hi 15-bit-mantissa f32, w_lo f32 residual)."""
    w64 = np.asarray(window, np.float64)
    return _split_window(w64.tobytes())


def fourstep_hybrid_windowed_psd_partial(
        re: jax.Array, im: jax.Array, fmask: jax.Array,
        w_hi: jax.Array, w_lo: jax.Array,
        N1: int | None = None, N2: int | None = None,
        chunk: int = 64, precision=None) -> jax.Array:
    """Windowed hybrid four-step with a SPLIT-WINDOW stage 1.

    The plain windowed hybrid loses its accuracy anchor: stage 1's FFT
    no longer sees exactly-representable integers once the f32 window
    multiply rounds each sample (~2⁻²⁴ relative), and the two-stage
    structure amplifies that input rounding ~N1-coherently under a
    tone — measured 2.8-3.1× the windowed scipy-f32 class at 2048-4096
    and up to 4.5× per-realization at 2²⁰ (probes/windowed_fold.py,
    probes/windowed_pow2_direct.py), which is why the windowed auto
    ladder routed around the hybrid.

    Fix: split the window into w_hi (15-bit mantissa) + w_lo so that
    the DOMINANT per-sample product x·w_hi is an exact f32 number
    (inputs are 8-bit integers) and the residual product x·w_lo, which
    does round at f32 ε, is ≤ 2⁻¹⁴ of the total (so its rounding is
    ~2⁻³⁸ relative to x·w — see _split_window); push each plane through
    its own stage-1 FFT — linearity makes
    FFT(x·w) = FFT(x·w_hi) + FFT(x·w_lo) with the remaining rounding at
    the final add (~ε relative, magnitude-dominated by the hi term). Stage 2 and the split twiddle are unchanged. Costs one
    extra stage-1 FFT. NOTE: this removes the input-REPRESENTATION
    rounding exactly (verified: x·w_hi is bit-exact for all dequant
    values); whether the windowed-hybrid excess error is that component
    or the transform's internal arithmetic on non-integer values is
    decided by measurement — probes/windowed_large_dist.py carries the
    verdict and the ladder only adopts this variant where it wins.

    re, im: (F, N) float32 UNWINDOWED dequantized integers.
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    thr, thi, tlr, tli, c2, s2 = (
        jnp.asarray(a) for a in _hybrid_constants(N, N1, N2))
    while F % chunk != 0:
        chunk //= 2
    prec = _HI if precision is None else precision

    x = jax.lax.complex(re, im).reshape(F, N1, N2)
    wh = w_hi.reshape(N1, N2)[None]
    wl = w_lo.reshape(N1, N2)[None]
    y = (jnp.fft.fft(x * wh, axis=1)
         + jnp.fft.fft(x * wl, axis=1))           # over n1 → (F, k1, n2)
    yr, yi = jnp.real(y), jnp.imag(y)
    zr = (yr * thr[None] - yi * thi[None]) + (yr * tlr[None] - yi * tli[None])
    zi = (yr * thi[None] + yi * thr[None]) + (yr * tli[None] + yi * tlr[None])
    Xr = (jnp.matmul(zr, c2, precision=prec)
          - jnp.matmul(zi, s2, precision=prec))   # over n2 → (F, k1, k2)
    Xi = (jnp.matmul(zr, s2, precision=prec)
          + jnp.matmul(zi, c2, precision=prec))
    p = (Xr * Xr + Xi * Xi) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)   # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def _bluestein_constants(N: int):
    """Chirp-Z (Bluestein) tables for an N-point DFT computed as ONE
    pow-2 circular convolution of length M = next_pow2(2N-1).

    The reference plans ANY N through FFTW (datastore.cxx:30-33); this
    is the framework-owned equivalent for awkward N (2·prime-class
    factorizations) where neither the matmul-DFT (O(N²), capped at
    N=8192) nor the four-step family (needs a factor >= 8) applies and
    the platform's monolithic FFT both lowers poorly at large N and
    REFUSES to compile at 2^16..2^20 on the current toolchain (see
    ops.spectral.warn_fft_compile_fallback). Both pow-2 length-M FFTs
    ride the framework's own two-level four-step (batched short FFT
    stages only), so the monolithic lowering is never touched.

    All tables are built in float64 with exact integer angle reduction
    (n² mod 2N stays exact in int64 for any session-sized N) and
    rounded once to complex64.

    Returns (M, M1, M2,
             a  (N,)      c64  chirp e^{-iπn²/N},
             Bp (M1, M2)  c64  FFT_M(v) in the four-step (k1, k2) layout,
             tw (M1, M2)  c64  forward twiddle W_M^{-k1·n2}).
    """
    M = next_pow2(2 * N - 1)
    M1, M2 = best_fourstep_split(M)
    n = np.arange(N, dtype=np.int64)
    ang = -np.pi * ((n * n) % (2 * N)).astype(np.float64) / N
    a = np.cos(ang) + 1j * np.sin(ang)              # e^{-iπn²/N}
    v = np.zeros(M, np.complex128)                  # v[m] = e^{+iπm²/N}
    v[:N] = np.conj(a)                              # m = 0..N-1
    v[M - N + 1:] = np.conj(a[1:][::-1])            # m = -(N-1)..-1
    B = np.fft.fft(v)
    # Four-step freq layout: bin k = k1 + M1·k2 → Bp[k1, k2].
    Bp = np.ascontiguousarray(B.reshape(M2, M1).T)
    k1 = np.arange(M1, dtype=np.int64)[:, None]
    n2 = np.arange(M2, dtype=np.int64)[None, :]
    angt = -2.0 * np.pi * ((k1 * n2) % M).astype(np.float64) / M
    tw = np.cos(angt) + 1j * np.sin(angt)
    return (M, M1, M2, a.astype(np.complex64),
            Bp.astype(np.complex64), tw.astype(np.complex64))


def _bluestein_power(re: jax.Array, im: jax.Array) -> jax.Array:
    """(..., N) float32 planes → (..., N) |DFT|² via the chirp-Z
    transform (the shared core of :func:`bluestein_psd_partial` and
    :func:`dft_power_bluestein` — see the partial's docstring for the
    algorithm and accuracy notes)."""
    N = re.shape[-1]
    lead = re.shape[:-1]
    M, M1, M2, a, Bp, tw = _bluestein_constants(N)
    a_j = jnp.asarray(a)
    Bp_j = jnp.asarray(Bp)
    tw_j = jnp.asarray(tw)
    x = jax.lax.complex(re, im).reshape(-1, N)
    u = x * a_j[None]
    u = jnp.pad(u, ((0, 0), (0, M - N))).reshape(-1, M1, M2)
    U = jnp.fft.fft(jnp.fft.fft(u, axis=1) * tw_j[None], axis=2)
    W = U * Bp_j[None]
    y = jnp.fft.ifft(jnp.fft.ifft(W, axis=2) * jnp.conj(tw_j)[None],
                     axis=1)
    X = y.reshape(-1, M)[:, :N] * a_j[None]
    p = jnp.real(X) * jnp.real(X) + jnp.imag(X) * jnp.imag(X)
    return p.reshape(*lead, N)


def dft_power_bluestein(re: jax.Array, im: jax.Array) -> jax.Array:
    """|DFT(re + i·im)|² per frame via the chirp-Z transform — the
    per-frame-spectra sibling of :func:`bluestein_psd_partial` for
    estimator steps that need (F, N) power planes (the SK family's
    second moment) at N where the monolithic platform FFT is slow or
    compile-refused. Same signature contract as dft_power_matmul."""
    return _bluestein_power(re, im)


def bluestein_psd_partial(re: jax.Array, im: jax.Array, fmask: jax.Array,
                          N1: int | None = None, N2: int | None = None,
                          chunk: int = 64, precision=None) -> jax.Array:
    """Masked partial PSD for ARBITRARY N via the chirp-Z transform.

    X[k] = a[k] · IFFT_M(FFT_M(x·a) · FFT_M(v))[k] with a the length-N
    chirp and v its conjugate arranged circularly — one pow-2 circular
    convolution. Each length-M transform is the two-level four-step
    (fft over a factor axis → twiddle → fft over the other; the inverse
    runs the same factorization backwards with conjugate twiddle), so
    only batched short FFTs ever reach the backend. Bins come out in
    NATURAL (unshifted) order directly — no reorder pass.

    Accuracy is FFTW-f32 class: two f32 pow-2 FFTs + elementwise c64
    constants (tables rounded once from exact-angle float64); measured
    ≪1e-5 relative on realistic inputs (tests/test_bluestein.py) — the
    ≤1e-5 golden budget holds like the xla rung's.

    re, im: (F, N) float32 (any N >= 2); fmask: (F,) float32.
    Returns (N,) float32. ``N1``/``N2``/``precision`` are accepted for
    signature parity with the four-step family and ignored (the M-split
    is chosen internally; there is no matmul precision knob).
    """
    F, N = re.shape
    while F % chunk != 0:
        chunk //= 2
    # Forward four-step (F, n1, n2) → (F, k1, k2) with k = k1 + M1·k2,
    # product with FFT_M(v) in that layout, then the inverse of the
    # SAME factorization (ifft over k2 → n2, conjugate twiddle, ifft
    # over k1 → n1; the 1/M1·1/M2 scalings compose to the 1/M the
    # convolution theorem needs) — all inside _bluestein_power.
    p = _bluestein_power(re, im) * fmask[:, None]
    g = F // chunk
    return p.reshape(g, chunk, N).sum(axis=1).sum(axis=0)


def dft_power_fourstep(re: jax.Array, im: jax.Array,
                       N1: int | None = None, N2: int | None = None) -> jax.Array:
    """|DFT(re + i·im)|² via the four-step (Bailey) algorithm as matmuls.

    Index map: n = N2·n1 + n2, k = k1 + N1·k2.
      Y[k1,n2]  = Σ_{n1} x[n1,n2]·W_{N1}^{n1·k1}          (stage-1 matmul)
      Z[k1,n2]  = Y[k1,n2]·W_N^{k1·n2}                      (twiddle)
      X[k1,k2]  = Σ_{n2} Z[k1,n2]·W_{N2}^{n2·k2}           (stage-2 matmul)
    and the output is laid out so bin k = k1 + N1·k2.

    re, im: (F, N) float32. Returns (F, N) float32 power.
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    c1, s1, c2, s2, tc, ts = (jnp.asarray(a) for a in _fourstep_constants(N, N1, N2))

    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)

    # Stage 1: contract over n1 (axis 1). Y[f,k1,n2] = Σ_n1 x[f,n1,n2]·W1[n1,k1].
    def stage1(ar, ai):
        yr = (jnp.einsum("fnm,nk->fkm", ar, c1, precision=_HI)
              - jnp.einsum("fnm,nk->fkm", ai, s1, precision=_HI))
        yi = (jnp.einsum("fnm,nk->fkm", ar, s1, precision=_HI)
              + jnp.einsum("fnm,nk->fkm", ai, c1, precision=_HI))
        return yr, yi

    yr, yi = stage1(xr, xi)

    # Twiddle (elementwise).
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc

    # Stage 2: contract over n2 (axis 2). X[f,k1,k2] = Σ_n2 Z[f,k1,n2]·W2[n2,k2].
    xre = (jnp.einsum("fkm,ml->fkl", zr, c2, precision=_HI)
           - jnp.einsum("fkm,ml->fkl", zi, s2, precision=_HI))
    xim = (jnp.einsum("fkm,ml->fkl", zr, s2, precision=_HI)
           + jnp.einsum("fkm,ml->fkl", zi, c2, precision=_HI))

    pwr = xre * xre + xim * xim  # (F, N1, N2), bin k = k1 + N1·k2
    return jnp.transpose(pwr, (0, 2, 1)).reshape(F, N)


def _trunc_split3(z: jax.Array):
    """Fold-proof 3-term bf16 split of f32 ``z`` (z ≈ z0+z1+z2, residual
    ~2⁻²⁴·|z|).

    Uses mantissa TRUNCATION via integer bit-masking instead of a
    bf16→f32 round trip: XLA under ``--xla_allow_excess_precision`` (on
    by default) may legally fold ``z - f32(bf16(z))`` to zero, silently
    destroying round-trip-style splits. Bit arithmetic cannot be
    folded. Truncation loses ~1 bit per term vs
    round-to-nearest; the third term absorbs it.
    """
    def trunc(v):
        u = jax.lax.bitcast_convert_type(v, jnp.uint32)
        return jax.lax.bitcast_convert_type(
            u & np.uint32(0xFFFF0000), jnp.float32)
    z0 = trunc(z)
    r1 = z - z0
    z1 = trunc(r1)
    r2 = r1 - z1
    z2 = trunc(r2)
    return (z0.astype(jnp.bfloat16), z1.astype(jnp.bfloat16),
            z2.astype(jnp.bfloat16))


@functools.lru_cache(maxsize=8)
def _mixed_constants(N: int, N1: int, N2: int):
    """bf16 3-term weight splits + f32 twiddles for the mixed-precision
    four-step."""
    import ml_dtypes

    def terms3(w):
        out, r = [], np.asarray(w, np.float64)
        for _ in range(3):
            t = r.astype(ml_dtypes.bfloat16)
            out.append(t)
            r = r - t.astype(np.float64)
        return np.stack(out)

    c1, s1 = (m.astype(np.float64) for m in _dft_matrices(N1))
    c2, s2 = (m.astype(np.float64) for m in _dft_matrices(N2))
    n2 = np.arange(N2, dtype=np.float64)[:, None]
    k1 = np.arange(N1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((n2 * k1) % N) / N
    return (terms3(c1), terms3(s1), terms3(c1 + s1),
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            terms3(c2), terms3(s2), terms3(c2 + s2))


def fourstep_psd_partial_mixed(re: jax.Array, im: jax.Array,
                               fmask: jax.Array,
                               N1: int | None = None, N2: int | None = None,
                               chunk: int = 64) -> jax.Array:
    """Masked partial PSD sum via a MIXED-PRECISION four-step DFT.

    Same transpose-free structure as :func:`fourstep_psd_partial`, but
    every matmul runs as native bf16 passes with manual splits:

    * stage 1: dequantized integer inputs are bf16-exact, so a 3-term
      weight-only split gives f32-grade accuracy in 3 native passes per
      Karatsuba product (vs 6 emulated passes at Precision.HIGHEST);
    * stage 2: 3-term truncation input split × 3-term weight split with
      (i+j ≥ 3) cross terms dropped — robust to tone-dominated dynamic
      range (a 2-term input split leaks ~2e-5 relative into small bins).

    No auto band selects it. Requires the dequantized integer inputs convention
    (|re|, |im| ≤ 256, exact in bf16).

    re, im: (F, N) float32; fmask: (F,) float32. Returns (N,) float32.
    """
    F, N = re.shape
    if N1 is None or N2 is None:
        N1, N2 = best_fourstep_split(N)
    assert N1 * N2 == N, (N1, N2, N)
    c1r, c1i, c1s, tc, ts, c2r, c2i, c2s = (
        jnp.asarray(a) for a in _mixed_constants(N, N1, N2))
    while F % chunk != 0:
        chunk //= 2
    bf16, f32 = jnp.bfloat16, jnp.float32

    dn = (((1,), (0,)), ((), ()))  # contract axis 1 with weight axis 0

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, preferred_element_type=f32)

    def wdot3(a, w3):
        return dot(a, w3[0]) + dot(a, w3[1]) + dot(a, w3[2])

    xr = re.reshape(F, N1, N2)
    xi = im.reshape(F, N1, N2)
    xrb = xr.astype(bf16)          # exact: dequantized integers
    xib = xi.astype(bf16)
    xsb = (xr + xi).astype(bf16)   # |sum| ≤ 256: still exact

    # Stage 1 (contract n1): Karatsuba, weight-only splits. (F, n2, k1).
    t1 = wdot3(xrb, c1r)
    t2 = wdot3(xib, c1i)
    t3 = wdot3(xsb, c1s)
    yr = t1 - t2
    yi = t3 - t1 - t2

    # Twiddle (pre-transposed (n2, k1) layout), f32 elementwise.
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc

    # Stage 2 (contract n2, axis 1): 3×3-drop split scheme.
    def s2(z, w3):
        z0, z1, z2 = _trunc_split3(z)
        return (dot(z0, w3[0]) + dot(z0, w3[1]) + dot(z0, w3[2])
                + dot(z1, w3[0]) + dot(z1, w3[1]) + dot(z2, w3[0]))

    u1 = s2(zr, c2r)
    u2 = s2(zi, c2i)
    u3 = s2(zr + zi, c2s)
    xr2 = u1 - u2                  # (F, k1, k2)
    xi2 = u3 - u1 - u2

    p = (xr2 * xr2 + xi2 * xi2) * fmask[:, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, N1, N2).sum(axis=1).sum(axis=0)  # (k1, k2)
    return jnp.swapaxes(s, 0, 1).reshape(N)


def _mixed_cmatmul(zr, zi, w3r, w3i, w3s, exact: bool, dn):
    """Karatsuba complex matmul with native-bf16 split passes.

    ``exact``: inputs are bf16-exact integers (weight-only 3-term split,
    3 passes/product); otherwise a fold-proof 3-term truncation input
    split with (i+j ≥ 3) cross terms dropped (6 passes/product).
    """
    f32, bf16 = jnp.float32, jnp.bfloat16

    def dot(a, b):
        return jax.lax.dot_general(a, b, dn, preferred_element_type=f32)

    if exact:
        def prod(z, w3):
            zb = z.astype(bf16)
            return dot(zb, w3[0]) + dot(zb, w3[1]) + dot(zb, w3[2])
    else:
        def prod(z, w3):
            z0, z1, z2 = _trunc_split3(z)
            return (dot(z0, w3[0]) + dot(z0, w3[1]) + dot(z0, w3[2])
                    + dot(z1, w3[0]) + dot(z1, w3[1]) + dot(z2, w3[0]))

    t1 = prod(zr, w3r)
    t2 = prod(zi, w3i)
    t3 = prod(zr + zi, w3s)
    return t1 - t2, t3 - t1 - t2


def best_threestep_split(N: int) -> Tuple[int, int, int]:
    """N = A·B·C with factors as close to 128 as possible (fat
    contractions, FLOPs ∝ A+B+C). Only useful for large N."""
    best = None
    a = 1
    while a * a * a <= N:
        if N % a == 0:
            rest = N // a
            b = a
            bb = int(math.isqrt(rest))
            for b in range(bb, a - 1, -1):
                if rest % b == 0:
                    c = rest // b
                    cost = a + b + c
                    if best is None or cost < best[0]:
                        best = (cost, c, b, a)  # largest factor first
                    break
        a += 1
    if best is None:
        return (N, 1, 1)
    return best[1], best[2], best[3]


@functools.lru_cache(maxsize=4)
def _threestep_constants(N: int, A: int, B: int, C: int):
    """bf16 3-term weight splits for the three stage DFTs + f32 twiddles.

    Decomposition n = a·BC + b·C + c, k = k1 + A·k2 + A·B·k3:
      y1[b,c,k1] = Σ_a x[a,b,c]·W_A^{a·k1}; twiddle W_N^{k1·(b·C+c)}
      y2[c,k1,k2] = Σ_b ·W_B^{b·k2};        twiddle W_{BC}^{k2·c}
      X[k1,k2,k3] = Σ_c ·W_C^{c·k3}
    """
    import ml_dtypes

    def terms3(w):
        out, r = [], np.asarray(w, np.float64)
        for _ in range(3):
            t = r.astype(ml_dtypes.bfloat16)
            out.append(t)
            r = r - t.astype(np.float64)
        return np.stack(out)

    def dftm(n):
        i = np.arange(n, dtype=np.float64)
        ang = -2.0 * np.pi * ((np.outer(i, i)) % n) / n
        return np.cos(ang), np.sin(ang)

    wa_c, wa_s = dftm(A)
    wb_c, wb_s = dftm(B)
    wc_c, wc_s = dftm(C)
    b = np.arange(B, dtype=np.float64)[:, None, None]
    c = np.arange(C, dtype=np.float64)[None, :, None]
    k1 = np.arange(A, dtype=np.float64)[None, None, :]
    ang1 = -2.0 * np.pi * (((b * C + c) * k1) % N) / N     # (B, C, A)
    c2 = np.arange(C, dtype=np.float64)[:, None]
    k2 = np.arange(B, dtype=np.float64)[None, :]
    ang2 = -2.0 * np.pi * ((c2 * k2) % (B * C)) / (B * C)  # (C, B)
    return (terms3(wa_c), terms3(wa_s), terms3(wa_c + wa_s),
            np.cos(ang1).astype(np.float32), np.sin(ang1).astype(np.float32),
            terms3(wb_c), terms3(wb_s), terms3(wb_c + wb_s),
            np.cos(ang2).astype(np.float32), np.sin(ang2).astype(np.float32),
            terms3(wc_c), terms3(wc_s), terms3(wc_c + wc_s))


def threestep_psd_partial_mixed(re: jax.Array, im: jax.Array,
                                fmask: jax.Array,
                                split: Tuple[int, int, int] | None = None,
                                chunk: int = 8) -> jax.Array:
    """Masked partial PSD via a THREE-level mixed-precision Cooley-Tukey
    factorization N = A·B·C — the very-large-N transform.

    A two-level split of N = 2²⁰ contracts K = 1024 per stage (≈2048
    MACs/sample); three levels with A,B,C ≈ 128 need only ≈A+B+C
    MACs/sample per pass-set — ~6× fewer FLOPs, with every contraction
    still fat. Same precision scheme as
    :func:`fourstep_psd_partial_mixed` (exact integer stage 1, 3-term
    truncation splits after; accuracy sits at the four-step family's f32
    cancellation floor — see that function's docstring).

    re, im: (F, N) float32 dequantized integers. Returns (N,) float32,
    unshifted bins.
    """
    F, N = re.shape
    if split is None:
        split = best_threestep_split(N)
    A, B, C = split
    assert A * B * C == N, (A, B, C, N)
    (wa_r, wa_i, wa_s, t1c, t1s, wb_r, wb_i, wb_s, t2c, t2s,
     wc_r, wc_i, wc_s) = (jnp.asarray(x) for x in
                          _threestep_constants(N, A, B, C))
    while F % chunk != 0:
        chunk //= 2

    dn = (((1,), (0,)), ((), ()))  # contract axis 1 of a 4D operand

    xr = re.reshape(F, A, B * C)
    xi = im.reshape(F, A, B * C)
    # Stage A (exact integers): (F, A, BC) → (F, BC, k1).
    yr, yi = _mixed_cmatmul(xr, xi, wa_r, wa_i, wa_s, True, dn)
    yr = yr.reshape(F, B, C, A)
    yi = yi.reshape(F, B, C, A)
    zr = yr * t1c - yi * t1s
    zi = yr * t1s + yi * t1c

    # Stage B: contract b (axis 1): (F, B, C·A-view) → (F, C, A, k2).
    zr = zr.reshape(F, B, C * A)
    zi = zi.reshape(F, B, C * A)
    yr, yi = _mixed_cmatmul(zr, zi, wb_r, wb_i, wb_s, False, dn)
    yr = yr.reshape(F, C, A, B)
    yi = yi.reshape(F, C, A, B)
    tw2c = t2c[None, :, None, :]
    tw2s = t2s[None, :, None, :]
    zr = yr * tw2c - yi * tw2s
    zi = yr * tw2s + yi * tw2c

    # Stage C: contract c (axis 1): (F, C, A·B-view) → (F, A, B, k3).
    zr = zr.reshape(F, C, A * B)
    zi = zi.reshape(F, C, A * B)
    xr2, xi2 = _mixed_cmatmul(zr, zi, wc_r, wc_i, wc_s, False, dn)
    xr2 = xr2.reshape(F, A, B, C)   # (f, k1, k2, k3)
    xi2 = xi2.reshape(F, A, B, C)

    p = (xr2 * xr2 + xi2 * xi2) * fmask[:, None, None, None]
    g = F // chunk
    s = p.reshape(g, chunk, A, B, C).sum(axis=1).sum(axis=0)  # (k1, k2, k3)
    # Bin k = k1 + A·k2 + A·B·k3 → row-major (k3, k2, k1).
    return jnp.transpose(s, (2, 1, 0)).reshape(N)
