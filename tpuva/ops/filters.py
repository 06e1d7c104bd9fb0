"""Batched image filters with OpenCV-matching semantics (SURVEY.md §2.2, §8).

All ops take ``(..., H, W)`` arrays (any leading batch dims) and are pure,
jit-able, vmap-able. They replace the per-frame cv2 C++ calls of the
reference's hot loop (reference: video/filters.py — FilterBlur etc.) with
whole-batch XLA programs.

Pinned semantics, locked by golden tests against local cv2 5.0.0:
- Gaussian: separable; sigma<=0 selects OpenCV's hardcoded binomial kernels
  for ksize<=7 and the 0.3*((k-1)*0.5-1)+0.8 formula above; border
  REFLECT_101 (numpy/jnp pad mode 'reflect'); row (W) pass first, then
  column (H), as cv2.sepFilter2D does. gaussian_blur is cv2's FLOAT
  path; gaussian_blur_u8 is cv2's UINT8 fixed-point path, BIT-EXACT
  (error-diffusion tap quantization + single half-away rounding) — the
  pipeline uses the latter, as the reference hands cv2 uint8 frames.
- Median: exact k x k selection, border REPLICATE ('edge').
- Morphology: min/max over the structuring element; border acts as the
  identity element (+inf for erode, -inf for dilate) so border pixels never
  shrink the image; MORPH_RECT via lax.reduce_window, MORPH_ELLIPSE via
  shifted-stack reduction over cv2's exact ellipse rasterization.
- threshold: strict ``src > thresh`` (cv2 THRESH_BINARY).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# OpenCV's fixed kernels used when sigma <= 0 (verified locally against cv2
# 5.0.0, SURVEY.md §8 + this session): binomial tab for ksize <= 7, plus the
# bit-exact 8-bit fixed-point table {4,13,30,51,60}/256 for ksize == 9.
# ksize >= 11 falls through to the 0.3*((k-1)*0.5-1)+0.8 sigma formula.
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [x / 256 for x in (4.0, 13.0, 30.0, 51.0, 60.0, 51.0, 30.0, 13.0, 4.0)],
}


def _gaussian_kernel_1d_f64(ksize: int, sigma: float) -> np.ndarray:
    """float64 kernel (the quantizer below needs full precision)."""
    assert ksize % 2 == 1 and ksize >= 1
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Matches cv2.getGaussianKernel(ksize, sigma) for odd ksize."""
    return _gaussian_kernel_1d_f64(ksize, sigma).astype(np.float32)


def u8_gaussian_taps(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2's 8-bit fixed-point Gaussian taps (integers summing to 256).

    OpenCV's bit-exact uint8 GaussianBlur quantizes the float kernel to
    8 fractional bits by ERROR DIFFUSION from the outermost tap inward
    (each rounding error carries into the next tap's rounding), with the
    center tap absorbing the final remainder so the taps sum to exactly
    256. Recovered empirically against local cv2 5.0.0: this (and only
    this — plain round/largest-remainder both fail) reproduces
    cv2.GaussianBlur on uint8 bit-exactly over a 1045-case sweep of
    ksize in [3, 31] x sigma in [0, 10] (SURVEY.md §8 methodology).
    For the sigma<=0 fixed tables (ksize <= 9) the scaled taps are
    already integers and diffusion is a no-op.
    """
    kern = _gaussian_kernel_1d_f64(ksize, sigma)
    r = ksize // 2
    ki = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(r):
        want = kern[i] * 256.0 + err
        q = int(np.floor(want + 0.5))
        err = want - q
        ki[i] = ki[ksize - 1 - i] = q
    ki[r] = 256 - 2 * int(ki[:r].sum())
    return ki


def _conv_axis(x: jnp.ndarray, kernel: np.ndarray, axis: int) -> jnp.ndarray:
    """1-D correlation along `axis` with REFLECT_101 padding.

    Symmetric-pair summation order mirrors cv2's symmetric-kernel row filter
    (sum of k[i]*(left+right) then + k0*center) to keep float results as
    close to cv2 as float associativity allows.
    """
    r = len(kernel) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = jnp.pad(x, pad, mode="reflect")

    def sl(off):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(off, off + x.shape[axis])
        return xp[tuple(idx)]

    out = sl(r) * kernel[r]
    for i in range(1, r + 1):
        out = out + kernel[r - i] * (sl(r - i) + sl(r + i))
    return out


def is_binomial_blur(ksize: int, sigma: float) -> bool:
    """True when cv2's kernel for (ksize, sigma) is a pure binomial row —
    the box-cascade fast path below applies. ksize 3 ([1,2,1]/4) and 5
    ([1,4,6,4,1]/16) only: cv2's ksize==7 table {2,7,14,18}/64 and
    ksize==9 table {4,13,30,51,60}/256 are NOT binomial (those would be
    {1,6,15,20}/64 and {1,8,28,56,70}/256)."""
    return sigma <= 0 and ksize in (3, 5)


def _box_cascade_axis(x: jnp.ndarray, ksize: int, axis: int) -> jnp.ndarray:
    """UNNORMALIZED binomial correlation along `axis` with REFLECT_101
    padding: a (ksize-1)-fold cascade of adjacent-pair sums (pad by r,
    shrink by 1 per pass — centered by construction). For integer-valued
    inputs (the pipeline blurs u8-cast frames) every partial sum is an
    integer <= 255 * 2^(k-1) < 2^24, so the result is EXACT — no float
    rounding anywhere — and therefore independent of summation order.
    Pure adds, no per-tap multiplies."""
    r = ksize // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    y = jnp.pad(x, pad, mode="reflect")
    for _ in range(2 * r):
        L = y.shape[axis]
        i0 = [slice(None)] * y.ndim
        i1 = [slice(None)] * y.ndim
        i0[axis] = slice(0, L - 1)
        i1[axis] = slice(1, L)
        y = y[tuple(i0)] + y[tuple(i1)]
    return y


def gaussian_blur(x: jnp.ndarray, ksize: int, sigma: float = 0.0) -> jnp.ndarray:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma) on float32 input.

    x: (..., H, W) float32. Row (W) pass first, then column (H).
    Binomial kernels (sigma<=0, ksize in {3, 5} — exactly what
    is_binomial_blur gates; cv2's k=7 table {2,7,14,18}/64 is NOT
    binomial) run as an exact box cascade (_box_cascade_axis); others as
    the cv2-ordered weighted correlation. The cascade is bit-exact only
    for INTEGER-valued inputs
    (u8-cast frames); for non-integer float inputs (e.g. chained after a
    float-producing filter) it differs from the cv2-ordered weighted
    correlation by ulps — within the pinned float-associativity contract.
    """
    if ksize == 1:
        return x
    if is_binomial_blur(ksize, sigma):
        x = _box_cascade_axis(x, ksize, axis=x.ndim - 1)
        x = _box_cascade_axis(x, ksize, axis=x.ndim - 2)
        # one exact power-of-two normalization for both axes
        return x * np.float32(2.0 ** (-2 * (ksize - 1)))
    k = gaussian_kernel_1d(ksize, sigma)
    x = _conv_axis(x, k, axis=x.ndim - 1)
    x = _conv_axis(x, k, axis=x.ndim - 2)
    return x


def gaussian_blur_u8(x: jnp.ndarray, ksize: int, sigma: float = 0.0) -> jnp.ndarray:
    """cv2.GaussianBlur on a UINT8 image, bit-exact, as integer-valued f32.

    x: (..., H, W) float32 holding u8-cast integer values in [0, 255];
    the result holds the exact uint8 values cv2's fixed-point path
    produces (cv2 rounds once, half away from zero, after both passes:
    ``(acc + 2^15) >> 16``). Two exact regimes, both pure f32 on device:

    - binomial kernels (is_binomial_blur): the float cascade is already
      the exact rational result, so ``floor(y + 0.5)`` IS the fixed-point
      rounding (also exact, and used, for the sigma<=0 fixed tables
      k in {7, 9}: their taps are /64 and /256 integer tables, so every
      partial sum is an exact multiple of 1/4096 resp. 1/65536 < 2^24);
    - everything else: the u8_gaussian_taps integer correlation. Row
      sums <= 255*256, column sums <= 255*65536 < 2^24 — every partial
      sum is exact in f32, so the result equals the int64 reference
      computation bit-for-bit regardless of summation order.

    The pipeline uses this op (not the float gaussian_blur) because the
    reference hands cv2 uint8 frames: the blur output is re-quantized to
    uint8 before the background update ever sees it (refimpl.pipeline
    does the same via cv2), which is what makes blur-enabled configs
    mask-bit-equal end-to-end instead of merely 1px-close.
    """
    if ksize == 1:
        return x
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return jnp.floor(gaussian_blur(x, ksize, sigma) + 0.5)
    taps = u8_gaussian_taps(ksize, sigma).astype(np.float32)
    y = _conv_axis(x, taps, axis=x.ndim - 1)
    y = _conv_axis(y, taps, axis=x.ndim - 2)
    return jnp.floor(y * np.float32(2.0**-16) + 0.5)


def median_blur(x: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """cv2.medianBlur semantics: k x k median, BORDER_REPLICATE.

    Exact selection — bit-identical to cv2 on identical inputs for any
    dtype. k=3 uses a 9-element sorting network (min/max ops only, VPU
    friendly); larger k sorts a stacked window axis.
    """
    assert ksize % 2 == 1 and ksize >= 1
    if ksize == 1:
        return x
    r = ksize // 2
    pad = [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)]
    xp = jnp.pad(x, pad, mode="edge")
    H, W = x.shape[-2], x.shape[-1]

    def window(dy, dx):
        idx = [slice(None)] * (x.ndim - 2) + [
            slice(dy, dy + H),
            slice(dx, dx + W),
        ]
        return xp[tuple(idx)]

    if ksize == 3:
        p = [window(dy, dx) for dy in range(3) for dx in range(3)]
        return _median9(p)
    stack = jnp.stack(
        [window(dy, dx) for dy in range(ksize) for dx in range(ksize)], axis=0
    )
    return jnp.sort(stack, axis=0)[(ksize * ksize) // 2]


def _median9(p):
    """Classic 19-op median-of-9 exchange network (Paeth)."""

    def mn(a, b):
        return jnp.minimum(a, b)

    def mx(a, b):
        return jnp.maximum(a, b)

    def srt(i, j):
        a, b = p[i], p[j]
        p[i], p[j] = mn(a, b), mx(a, b)

    for i, j in [
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        srt(i, j)
    return p[4]


def threshold(x: jnp.ndarray, thresh: float, maxval: float = 255.0) -> jnp.ndarray:
    """cv2.THRESH_BINARY: maxval where x > thresh (strict), else 0.

    Returns uint8."""
    return jnp.where(x > thresh, jnp.uint8(int(maxval)), jnp.uint8(0))


def histogram_u8(x: jnp.ndarray, max_onehot_elems: int = 1 << 24) -> jnp.ndarray:
    """256-bin histogram of a uint8 image batch as a matrix product.

    The value is split v = 16*hi + lo and the histogram becomes ONE
    matmul per image: hist2d[hi, lo] = Σ_p 1[x>>4 = hi]·1[x&15 = lo]
    = onehot_hi(P, 16)ᵀ @ onehot_lo(P, 16). The one-hot compares are 32
    per pixel (vs 256 for a direct compare-reduce). Exact on any device:
    the bf16 operands are 0/1 and the f32 accumulation holds counts
    exactly for any image < 2^24 px.

    The (..., P, 16) one-hot operands may be materialized by XLA, so the
    pixel axis is chunked with a lax.scan once batch×pixels exceeds
    ~16.7M elements (~0.5 GB/operand in bf16): without this, Otsu at
    production scale (batch 256 @ 1080p = 531M px) would build two ~17 GB
    intermediates. Counts stay exact: chunk partial sums are
    integer-valued f32 (< 2^24 per bin) and zero-padding is subtracted
    from bin 0.

    x: (..., H, W) uint8 → (..., 256) float32 counts, bin v = pixel value.
    """

    def hist16(flat):
        hi = (flat >> 4)[..., None] == jnp.arange(16, dtype=jnp.int32)
        lo = (flat & 15)[..., None] == jnp.arange(16, dtype=jnp.int32)
        h2 = jnp.einsum(
            "...ph,...pl->...hl",
            hi.astype(jnp.bfloat16),
            lo.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        return h2.reshape(flat.shape[:-1] + (256,))

    flat = x.reshape(x.shape[:-2] + (-1,)).astype(jnp.int32)
    P = flat.shape[-1]
    lead = int(np.prod(flat.shape[:-1], dtype=np.int64)) if flat.ndim > 1 else 1
    chunk = max(1, int(max_onehot_elems) // max(lead, 1))
    if P <= chunk:
        return hist16(flat)
    n = -(-P // chunk)
    pad = n * chunk - P
    flat = jnp.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad)])
    chunks = jnp.moveaxis(
        flat.reshape(flat.shape[:-1] + (n, chunk)), -2, 0
    )
    acc0 = jnp.zeros(flat.shape[:-1] + (256,), jnp.float32)
    hist, _ = lax.scan(lambda a, c: (a + hist16(c), None), acc0, chunks)
    if pad:
        hist = hist.at[..., 0].add(-np.float32(pad))
    return hist


def otsu_from_histogram(hist: jnp.ndarray) -> jnp.ndarray:
    """Otsu threshold from a 256-bin histogram (cv2.THRESH_OTSU
    semantics: maximize inter-class variance; ties take the lowest
    threshold). hist: (..., 256) float32 counts → (...) float32 threshold.

    Split out from otsu_threshold so distributed callers can psum
    per-shard histograms (exact f32-integer counts) into the global one
    before the argmax — e.g. the spatial-TP front-end's per-band
    histograms over the ('space',) mesh."""
    nbins = 256
    total = hist.sum(-1, keepdims=True)
    bins = jnp.arange(nbins, dtype=jnp.float32)
    w0 = jnp.cumsum(hist, -1)
    sum0 = jnp.cumsum(hist * bins, -1)
    sum_all = sum0[..., -1:]
    w1 = total - w0
    mu0 = sum0 / jnp.maximum(w0, 1.0)
    mu1 = (sum_all - sum0) / jnp.maximum(w1, 1.0)
    var_between = w0 * w1 * (mu0 - mu1) ** 2
    valid = (w0 > 0) & (w1 > 0)
    var_between = jnp.where(valid, var_between, -1.0)
    return jnp.argmax(var_between, axis=-1).astype(jnp.float32)


def otsu_threshold(x: jnp.ndarray) -> jnp.ndarray:
    """Otsu threshold of a uint8 image (cv2.THRESH_OTSU semantics).
    Returns the scalar threshold (float32).

    x: (..., H, W) uint8; leading dims are reduced per-image via vmap by the
    caller if desired — this function reduces over the trailing two dims.
    """
    return otsu_from_histogram(histogram_u8(x))


# ----------------------------------------------------------------- morphology
@functools.lru_cache(maxsize=64)
def structuring_element(shape: str, ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_RECT/MORPH_ELLIPSE, (k, k)) as bool.

    The ellipse uses OpenCV's exact rasterization (verified §8: (5,5) has
    its middle 3 rows full, not a naive circle): row half-width from the
    ellipse equation evaluated at the row's integer dy with inv_r2 rounding.
    """
    if shape == "rect":
        return np.ones((ksize, ksize), bool)
    if shape != "ellipse":
        raise ValueError(f"unknown SE shape {shape!r}")
    # OpenCV ellipse rasterization (modules/imgproc/src/morph.cpp style)
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    se = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        j1, j2 = 0, 0
        dy = i - r
        if abs(dy) <= r:
            if r == 0:
                dx = c
            else:
                dx = int(round(c * np.sqrt(max(0.0, (r * r - dy * dy)) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, ksize)
            se[i, j1:j2] = True
    return se


def _morph(x: jnp.ndarray, se: np.ndarray, is_erode: bool) -> jnp.ndarray:
    kh, kw = se.shape
    rh, rw = kh // 2, kw // 2
    dtype = x.dtype
    if jnp.issubdtype(dtype, jnp.integer):
        ident = jnp.iinfo(dtype).max if is_erode else jnp.iinfo(dtype).min
    else:
        ident = jnp.inf if is_erode else -jnp.inf
    if se.all():  # MORPH_RECT: reduce_window is the fast path
        ndim = x.ndim
        wdims = (1,) * (ndim - 2) + (kh, kw)
        strides = (1,) * ndim
        padcfg = [(0, 0)] * (ndim - 2) + [(rh, rh), (rw, rw)]
        op = lax.min if is_erode else lax.max
        return lax.reduce_window(
            x, jnp.array(ident, dtype), op, wdims, strides, padcfg
        )
    # arbitrary SE: reduction over shifted views
    pad = [(0, 0)] * (x.ndim - 2) + [(rh, rh), (rw, rw)]
    xp = jnp.pad(x, pad, mode="constant", constant_values=ident)
    H, W = x.shape[-2], x.shape[-1]
    out = None
    red = jnp.minimum if is_erode else jnp.maximum
    for dy in range(kh):
        for dx in range(kw):
            if not se[dy, dx]:
                continue
            idx = [slice(None)] * (x.ndim - 2) + [
                slice(dy, dy + H),
                slice(dx, dx + W),
            ]
            v = xp[tuple(idx)]
            out = v if out is None else red(out, v)
    return out


def erode(x: jnp.ndarray, se: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    for _ in range(iterations):
        x = _morph(x, se, is_erode=True)
    return x


def dilate(x: jnp.ndarray, se: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    """cv2.dilate reflects the SE about the anchor; all SEs produced by
    structuring_element are symmetric so the reflection is a no-op."""
    for _ in range(iterations):
        x = _morph(x, se, is_erode=False)
    return x


def morph_open(x: jnp.ndarray, se: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    """cv2.morphologyEx(..., MORPH_OPEN): erode x iterations, then dilate."""
    return dilate(erode(x, se, iterations), se, iterations)


def morph_close(x: jnp.ndarray, se: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    return erode(dilate(x, se, iterations), se, iterations)
