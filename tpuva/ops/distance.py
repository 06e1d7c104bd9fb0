"""Exact Euclidean distance transform (SURVEY.md §2.2 "scipy.ndimage
bits" row — the last as-needed kernel; reference semantics are
`scipy.ndimage.distance_transform_edt` / cv2 DIST_L2+DIST_MASK_PRECISE:
for every nonzero pixel, the distance to the nearest zero pixel).

Design: the squared EDT is separable — a 1D squared-distance
transform down the columns followed by a min-plus convolution with the
parabola d^2 along the rows (Felzenszwalb & Huttenlocher 2004). Both 1D
stages are computed here as ITERATED 3-POINT PARABOLIC EROSIONS: pass k
updates D <- min(D, shift(D, +1) + (2k-1), shift(D, -1) + (2k-1)).
Because sum_{k=1..d} (2k-1) = d^2, a pixel at distance d from its best
seed accumulates exactly d^2 after d passes, and extra passes never
lower a converged value (min algebra) — so running each axis to a fixed
point yields the EXACT squared EDT. Each pass is two shifts + two adds +
two mins on the whole batch — pure VPU work on static shapes inside a
`lax.while_loop`, the same compiler-friendly shape as the CCL sweeps
(no scatter/gather, no data-dependent Python control flow).

Pass count per axis is the largest per-axis seed distance in the batch
(bounded by the axis extent). For blob-analysis masks that is tens of
passes; the transform is an analysis utility, not on the metric path
(SURVEY.md §2.2 disposition).

All arithmetic is exact: squared distances are integers < 2^24 for any
image up to 4096 px on a side, held exactly in float32 (INF for "no
seed" stays a clean +inf through min/add).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_INF = float("inf")  # a Python float: a jnp constant would start a backend


def _edt_pass_axis(d: jnp.ndarray, axis: int):
    """Run one axis's parabolic erosion to its fixed point.

    d: (..., H, W) f32 squared distances (0 at seeds, +inf if unseeded).
    """

    def shift(x, s: int):
        # shift by one pixel along `axis`, +inf flowing in at the border
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, 0) if s > 0 else (0, 1)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(None, -1) if s > 0 else slice(1, None)
        return jnp.pad(x, pad, constant_values=_INF)[tuple(sl)]

    def body(state):
        d, k, _ = state
        w = 2.0 * k - 1.0
        nd = jnp.minimum(d, jnp.minimum(shift(d, 1) + w, shift(d, -1) + w))
        return nd, k + 1.0, jnp.any(nd != d)

    d, _, _ = lax.while_loop(
        lambda s: s[2], body, (d, jnp.float32(1.0), jnp.bool_(True))
    )
    return d


@jax.jit
def distance_transform_edt(mask: jnp.ndarray) -> jnp.ndarray:
    """Exact Euclidean distance to the nearest ZERO pixel, for every
    nonzero pixel (scipy.ndimage.distance_transform_edt semantics).

    mask: (..., H, W) — any dtype; nonzero = foreground. Returns float32
    distances (0 on background). An all-foreground image (no zero pixel
    anywhere) returns +inf, matching the "no seed" limit.
    """
    m = mask != 0
    d = jnp.where(m, _INF, jnp.float32(0.0))
    d = _edt_pass_axis(d, mask.ndim - 2)  # columns: 1D squared DT
    d = _edt_pass_axis(d, mask.ndim - 1)  # rows: parabolic min-plus
    return jnp.sqrt(d)


@jax.jit
def distance_transform_edt_sq(mask: jnp.ndarray) -> jnp.ndarray:
    """Squared exact EDT (exact integers in f32 — no sqrt rounding)."""
    m = mask != 0
    d = jnp.where(m, _INF, jnp.float32(0.0))
    d = _edt_pass_axis(d, mask.ndim - 2)
    d = _edt_pass_axis(d, mask.ndim - 1)
    return d
