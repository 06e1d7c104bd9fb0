"""Affine warping (SURVEY.md §2.2: "cv2.resize / cv2.warpAffine
(crop/rotate path) → jax.image.resize / gather-based affine sample").

cv2.warpAffine semantics reproduced:
- M is the FORWARD 2x3 map src→dst (cv2 inverts it internally unless
  WARP_INVERSE_MAP; `inverse=True` mirrors that flag);
- INTER_LINEAR bilinear sampling at the pixel-center convention;
- BORDER_CONSTANT (out-of-bounds *neighbors* of a sample contribute the
  border value — matched by per-corner masking) and BORDER_REPLICATE.

Note: an arbitrary-angle warp is irreducibly a gather (4 per output
pixel, batched over frames). That is on the repo's avoid-list for METRIC
path ops, but warping is a geometry/annotation filter (reference used it
for crop/rotate preprocessing), runs once per frame outside the
segmentation hot loop, and XLA lowers the clipped flat-index take
acceptably. Exactness vs cv2: cv2's 8U path uses 5-bit fixed-point
weights — float32 math here lands within 1-2 LSB (golden-tested).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def invert_affine(M) -> np.ndarray:
    """Invert a 2x3 affine matrix (host-side, float64 like cv2's
    invertAffineTransform)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    a, b, c = M[0]
    d, e, f = M[1]
    det = a * e - b * d
    if det == 0:
        raise ValueError("singular affine matrix")
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    return np.array(
        [[ia, ib, -(ia * c + ib * f)], [id_, ie, -(id_ * c + ie * f)]],
        np.float64,
    )


def rotation_matrix(center, angle_deg: float, scale: float = 1.0):
    """cv2.getRotationMatrix2D: counterclockwise rotation about `center`
    ((cx, cy) in pixel coords) with isotropic scaling."""
    cx, cy = float(center[0]), float(center[1])
    a = np.deg2rad(angle_deg)
    al = scale * np.cos(a)
    be = scale * np.sin(a)
    return np.array(
        [
            [al, be, (1.0 - al) * cx - be * cy],
            [-be, al, be * cx + (1.0 - al) * cy],
        ],
        np.float64,
    )


def warp_affine(
    img: jnp.ndarray,
    M,
    out_size=None,
    inverse: bool = False,
    border: str = "constant",
    border_value: float = 0.0,
):
    """Batched cv2.warpAffine (INTER_LINEAR).

    img: (N, H, W), (H, W), or (..., H, W, 3) — the last two (or two
    before a channel dim of 3) axes are spatial. M: CONCRETE 2x3 forward
    src→dst affine (numpy; the matrix is folded into the trace as
    constants — pass it as a closure value, not a traced arg, when
    jitting). out_size: (w, h), defaults to the input size. Returns the
    same dtype as the input (uint8 is rounded like cv2's float path;
    within 1-2 LSB of cv2's fixed-point 8U kernel). Trace-compatible in
    `img`; jit it via the caller (the filter chain does).
    """
    if border not in ("constant", "replicate"):
        raise ValueError(border)
    chan = img.shape[-1] == 3 and img.ndim >= 3
    sp = img.ndim - (3 if chan else 2)  # index of H axis
    H, W = img.shape[sp], img.shape[sp + 1]
    w_out, h_out = out_size if out_size is not None else (W, H)

    Mi = np.asarray(M, np.float64).reshape(2, 3)
    if not inverse:
        Mi = invert_affine(Mi)
    ia, ib, ic = (float(v) for v in Mi[0])
    id_, ie, if_ = (float(v) for v in Mi[1])

    xs = jnp.arange(w_out, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h_out, dtype=jnp.float32)[:, None]
    sx = ia * xs + ib * ys + ic  # (h_out, w_out)
    sy = id_ * xs + ie * ys + if_
    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = (sx - x0).astype(jnp.float32)
    fy = (sy - y0).astype(jnp.float32)
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    fimg = img.astype(jnp.float32)
    # channel axis (if any) joins the leading batch dims so the last two
    # axes are purely spatial for the flat gather
    if chan:
        fimg = jnp.moveaxis(fimg, -1, 0)
    lead = fimg.shape[:-2]
    flat = fimg.reshape(lead + (H * W,))
    bv = jnp.float32(border_value)

    def corner(xi, yi):
        xc = jnp.clip(xi, 0, W - 1)
        yc = jnp.clip(yi, 0, H - 1)
        idx = (yc * W + xc).reshape(-1)
        g = jnp.take(flat, idx, axis=-1).reshape(lead + (h_out, w_out))
        if border == "constant":
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            g = jnp.where(ok, g, bv)
        return g

    g00 = corner(x0, y0)
    g01 = corner(x0 + 1, y0)
    g10 = corner(x0, y0 + 1)
    g11 = corner(x0 + 1, y0 + 1)
    top = g00 + fx * (g01 - g00)
    bot = g10 + fx * (g11 - g10)
    out = top + fy * (bot - top)
    if chan:
        out = jnp.moveaxis(out, 0, -1)
    if img.dtype == jnp.uint8:
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    return out.astype(img.dtype)
