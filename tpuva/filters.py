"""Lazy filter chain (L2, reference: video/filters.py).

Filters compose by nesting, exactly like the reference:

    FilterBlur(FilterMonochrome(FilterCrop(video, rect)), 3)

and every filter IS a video (VideoBase), so anything that consumes a video
consumes a filter chain (BASELINE.json:5 "same filter/segmenter
composition").

Batched execution model (T2, SURVEY.md §1.2): each filter declares a
pure jax `batch_transform(batch, carry) -> (batch, carry)` over
(N, H, W[, 3]) stacks. Iteration and `iter_batches` run the whole nested
chain as ONE jitted device program per batch — the reference's
one-C++-round-trip-per-filter-per-frame loop (SURVEY.md §3.1) collapses
into a single fused XLA program. Per-frame `get_frame` access still works
(a batch of 1) for API parity.

Stateful filters (background model, time difference) thread their state
through the carry, so chains are resumable across batch boundaries.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from tpuva.io.base import VideoBase
from tpuva.ops import gaussian_blur, gaussian_blur_u8, median_blur
from tpuva.ops.background import background_scan

# BGR -> gray weights (OpenCV convention: x is BGR channel order)
_BGR_WEIGHTS = np.array([0.114, 0.587, 0.299], np.float32)


def _round_u8(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8)


class FilterBase(VideoBase):
    """A video wrapping a source video with a pure batch transform."""

    def __init__(
        self,
        source: VideoBase,
        frame_count: Optional[int] = None,
        size: Optional[Tuple[int, int]] = None,
        fps: Optional[float] = None,
        is_color: Optional[bool] = None,
    ):
        super().__init__(
            source.frame_count if frame_count is None else frame_count,
            source.size if size is None else size,
            source.fps if fps is None else fps,
            source.is_color if is_color is None else is_color,
        )
        self.source = source

    # ------------------------------------------------------- transform spec
    def init_carry(self):
        """Initial carry for stateful filters (None = stateless)."""
        return None

    def batch_transform(self, batch: jnp.ndarray, carry):
        """Pure jax function: (N, H, W[, 3]) batch -> output batch."""
        raise NotImplementedError

    # --------------------------------------------------------- chain fusion
    def _chain(self):
        """The nested filters root-first, plus the root source."""
        filters = []
        node = self
        while isinstance(node, FilterBase):
            filters.append(node)
            node = node.source
        return node, filters[::-1]

    @cached_property
    def _jitted_chain(self):
        root, filters = self._chain()

        @jax.jit
        def run(batch, carries):
            new_carries = []
            for f, c in zip(filters, carries):
                batch, c = f._apply(batch, c)
                new_carries.append(c)
            return batch, tuple(new_carries)

        return root, filters, run

    def _apply(self, batch, carry):
        """Uniform (batch, carry) -> (batch, carry) wrapper."""
        out = self.batch_transform(batch, carry)
        if isinstance(out, tuple):
            return out
        return out, carry

    # ------------------------------------------------------------ execution
    def iter_batches(self, batch: int, pad_last: bool = False):
        root, filters, run = self._jitted_chain
        carries = tuple(f.init_carry() for f in filters)
        first = True
        for n, stack in root.iter_batches(batch, pad_last=pad_last):
            out, carries = run(jnp.asarray(stack), carries)
            out = np.asarray(out)
            if first:
                # frame-count-reducing filters (e.g. time difference) emit
                # fewer valid rows on the stream's first batch
                n -= sum(f.first_batch_drop for f in filters)
                first = False
            yield max(0, min(n, out.shape[0])), out

    @cached_property
    def _jitted_single(self):
        @jax.jit
        def run1(frame, carry):
            out, _ = self._apply(frame, carry)
            return out

        return run1

    def get_frame(self, index: int) -> np.ndarray:
        """Random access: apply THIS filter to source.get_frame(index).

        Recursive per filter — NOT the fused chain program — so a filter
        with its own random-access semantics (FilterTimeDifference reads
        two source frames) dispatches its override even when it sits
        inside a chain. (The fused-chain version silently returned the
        raw frame for Normalize(TimeDifference(v)).get_frame — caught by
        tests/test_config_fuzz.py::test_filter_chain_fuzz_*.)"""
        if self.sequential_only:
            raise NotImplementedError(
                f"{type(self).__name__} is sequential-only; iterate instead"
            )
        frame = self.source.get_frame(index)
        out = self._jitted_single(
            jnp.asarray(frame)[None], self.init_carry()
        )
        return np.asarray(out[0])

    sequential_only = False  # stateful filters set True
    first_batch_drop = 0  # valid rows lost from the stream's first batch

    def close(self):
        self.source.close()


# ------------------------------------------------------------------ filters
class FilterFunction(FilterBase):
    """Arbitrary per-batch function (reference: FilterFunction applied an
    arbitrary per-frame fn). `fn` must be jax-traceable over a batch; wrap
    per-frame numpy functions with jax.pure_callback upstream if needed."""

    def __init__(self, source, fn: Callable, **shape_overrides):
        super().__init__(source, **shape_overrides)
        self._fn = fn

    def batch_transform(self, batch, carry):
        return jax.vmap(self._fn)(batch)


QUADRANTS = {
    "upper left": (0.0, 0.0, 0.5, 0.5),
    "upper right": (0.5, 0.0, 0.5, 0.5),
    "lower left": (0.0, 0.5, 0.5, 0.5),
    "lower right": (0.5, 0.5, 0.5, 0.5),
    "left": (0.0, 0.0, 0.5, 1.0),
    "right": (0.5, 0.0, 0.5, 1.0),
    "upper": (0.0, 0.0, 1.0, 0.5),
    "lower": (0.0, 0.5, 1.0, 0.5),
}


class FilterCrop(FilterBase):
    """Crop to rect=(x, y, w, h) in pixels, or a quadrant string like
    'upper left' (reference: FilterCrop supported both)."""

    def __init__(self, source, rect):
        if isinstance(rect, str):
            fx, fy, fw, fh = QUADRANTS[rect.lower()]
            W, H = source.size
            rect = (
                int(fx * W), int(fy * H), int(fw * W), int(fh * H)
            )
        x, y, w, h = (int(v) for v in rect)
        W, H = source.size
        if not (0 <= x and 0 <= y and x + w <= W and y + h <= H and w > 0 and h > 0):
            raise ValueError(f"crop rect {rect} outside {source.size}")
        self.rect = (x, y, w, h)
        super().__init__(source, size=(w, h))

    def batch_transform(self, batch, carry):
        x, y, w, h = self.rect
        return batch[:, y : y + h, x : x + w]


class FilterMonochrome(FilterBase):
    """BGR -> grayscale (reference: FilterMonochrome). Float weighted sum
    with the OpenCV BGR coefficients, rounded to uint8 (within 1 LSB of
    cv2's fixed-point path)."""

    def __init__(self, source):
        super().__init__(source, is_color=False)

    def batch_transform(self, batch, carry):
        if batch.ndim == 3:
            return batch
        w = jnp.asarray(_BGR_WEIGHTS)
        gray = jnp.tensordot(batch.astype(jnp.float32), w, axes=([-1], [0]))
        if batch.dtype == jnp.uint8:
            return _round_u8(gray)
        return gray


class FilterResize(FilterBase):
    """Bilinear resize to (width, height) (reference: FilterResize;
    cv2.resize INTER_LINEAR pixel-center convention).

    uint8 exactness: cv2's uint8 INTER_LINEAR path is fixed-point
    (11-bit coefficients); this float32 resample + round-half-away is
    within <=1 LSB of it across up/down/fractional scales (pinned by
    tests/test_io_filters.py::test_filter_resize_uint8_golden)."""

    def __init__(self, source, size):
        self.target = (int(size[0]), int(size[1]))
        super().__init__(source, size=self.target)

    def batch_transform(self, batch, carry):
        w, h = self.target
        shape = (batch.shape[0], h, w) + batch.shape[3:]
        out = jax.image.resize(
            batch.astype(jnp.float32), shape, method="linear", antialias=False
        )
        if batch.dtype == jnp.uint8:
            return _round_u8(out)
        return out


class FilterBlur(FilterBase):
    """Gaussian blur (reference: FilterBlur; cv2.GaussianBlur semantics,
    SURVEY.md §2.2/§8)."""

    def __init__(self, source, sigma: float = 0.0, ksize: Optional[int] = None):
        if ksize is None:
            # cv2 auto kernel size for sigma: ksize = 2*ceil(3*sigma)+1
            ksize = max(1, 2 * int(np.ceil(3.0 * max(sigma, 0.8))) + 1)
        self.ksize, self.sigma = int(ksize), float(sigma)
        super().__init__(source)

    def batch_transform(self, batch, carry):
        # uint8 input: cv2's fixed-point u8 path, bit-exact
        # (ops.gaussian_blur_u8); float input: cv2's float path.
        blur = gaussian_blur_u8 if batch.dtype == jnp.uint8 else gaussian_blur
        x = batch.astype(jnp.float32)
        if x.ndim == 4:  # color: blur per channel
            x = jnp.moveaxis(x, -1, 1)
            x = blur(x, self.ksize, self.sigma)
            x = jnp.moveaxis(x, 1, -1)
        else:
            x = blur(x, self.ksize, self.sigma)
        if batch.dtype == jnp.uint8:
            return x.astype(jnp.uint8)  # already exact integers in [0,255]
        return x


class FilterMedian(FilterBase):
    """Median filter (cv2.medianBlur semantics, exact selection)."""

    def __init__(self, source, ksize: int = 3):
        self.ksize = int(ksize)
        super().__init__(source)

    def batch_transform(self, batch, carry):
        if batch.ndim == 4:
            x = jnp.moveaxis(batch, -1, 1)
            x = median_blur(x, self.ksize)
            return jnp.moveaxis(x, 1, -1)
        return median_blur(batch, self.ksize)


class FilterNormalize(FilterBase):
    """Map [vmin, vmax] -> [0, 1] float32 (reference: FilterNormalize)."""

    def __init__(self, source, vmin: float = 0.0, vmax: float = 255.0):
        self.vmin, self.vmax = float(vmin), float(vmax)
        super().__init__(source)

    def batch_transform(self, batch, carry):
        x = (batch.astype(jnp.float32) - self.vmin) / (self.vmax - self.vmin)
        return jnp.clip(x, 0.0, 1.0)


class FilterTimeDifference(FilterBase):
    """Signed frame-to-frame difference as int16 (reference:
    FilterTimeDifference): out[t] = frame[t+1] - frame[t]; frame_count is
    one less than the source's."""

    first_batch_drop = 1

    def __init__(self, source):
        super().__init__(source, frame_count=source.frame_count - 1)

    def init_carry(self):
        # (prev_frame, valid) — valid False until the first batch seeds it
        h, w = self.source.height, self.source.width
        shape = (h, w, 3) if self.source.is_color else (h, w)
        return (jnp.zeros(shape, jnp.int16), jnp.bool_(False))

    def batch_transform(self, batch, carry):
        prev, valid = carry
        x = batch.astype(jnp.int16)
        shifted = jnp.concatenate([prev[None], x[:-1]], axis=0)
        diff = x - shifted
        # first frame of the stream has no predecessor: drop it by shifting
        # one left when carry was invalid
        out = jnp.where(valid, diff, jnp.roll(diff, -1, axis=0))
        return out, (x[-1], jnp.bool_(True))

    def get_frame(self, index: int) -> np.ndarray:
        a = self.source.get_frame(index).astype(np.int16)
        b = self.source.get_frame(index + 1).astype(np.int16)
        return b - a


class FilterRotate(FilterBase):
    """Rotation filter (reference: rotation filter).

    turns: a multiple of 90 degrees counterclockwise — exact axis
    permutation, no resampling. angle: arbitrary degrees counterclockwise
    about the frame center (cv2.getRotationMatrix2D convention) via the
    gather-based bilinear affine sampler (tpuva.ops.warp; SURVEY §2.2
    warpAffine row), same output size, constant border."""

    def __init__(self, source, turns: int | None = None,
                 angle: float | None = None, border: str = "constant"):
        if (turns is None) == (angle is None):
            raise ValueError("give exactly one of turns= or angle=")
        self.turns = int(turns) % 4 if turns is not None else None
        self.angle = float(angle) if angle is not None else None
        self.border = border
        w, h = source.size
        if self.turns is not None:
            size = (w, h) if self.turns % 2 == 0 else (h, w)
        else:
            size = (w, h)
        super().__init__(source, size=size)

    def batch_transform(self, batch, carry):
        if self.turns is not None:
            return jnp.rot90(batch, k=self.turns, axes=(1, 2))
        from tpuva.ops.warp import rotation_matrix, warp_affine

        w, h = self.source.size
        M = rotation_matrix(((w - 1) / 2.0, (h - 1) / 2.0), self.angle)
        return warp_affine(batch, M, border=self.border)


class FilterWarpAffine(FilterBase):
    """Arbitrary affine transform (reference crop/rotate path:
    cv2.warpAffine; SURVEY §2.2). M is the forward 2x3 src→dst matrix;
    out_size (w, h) defaults to the source size."""

    def __init__(self, source, M, out_size=None, border: str = "constant",
                 border_value: float = 0.0):
        import numpy as _np

        self.M = _np.asarray(M, _np.float64).reshape(2, 3)
        self.border = border
        self.border_value = float(border_value)
        self.out_size = (
            (int(out_size[0]), int(out_size[1]))
            if out_size is not None
            else source.size
        )
        super().__init__(source, size=self.out_size)

    def batch_transform(self, batch, carry):
        from tpuva.ops.warp import warp_affine

        return warp_affine(
            batch, self.M, out_size=self.out_size, border=self.border,
            border_value=self.border_value,
        )


class FilterFlip(FilterBase):
    """Horizontal/vertical mirror (reference: flip filter)."""

    def __init__(self, source, horizontal: bool = True):
        self.horizontal = bool(horizontal)
        super().__init__(source)

    def batch_transform(self, batch, carry):
        axis = 2 if self.horizontal else 1
        return jnp.flip(batch, axis=axis)


class FilterBackground(FilterBase):
    """Running-average background subtraction as a filter (reference:
    background filter with running-average model, SURVEY.md §2.1): yields
    |frame - B| uint8 and updates B <- (1-alpha) B + alpha frame. The model
    seeds from the first frame seen. Sequential-only (the output at t
    depends on the whole history)."""

    sequential_only = True

    def __init__(self, source, alpha: float = 0.02):
        if source.is_color:
            raise ValueError("FilterBackground expects a grayscale source")
        self.alpha = float(alpha)
        super().__init__(source)

    def init_carry(self):
        h, w = self.source.height, self.source.width
        return (jnp.zeros((h, w), jnp.float32), jnp.bool_(False))

    def batch_transform(self, batch, carry):
        bg, valid = carry
        f = batch.astype(jnp.float32)
        bg0 = jnp.where(valid, bg, f[0])
        bgs = background_scan(bg0, f, self.alpha)
        return _round_u8(jnp.abs(f - bgs)), (bgs[-1], jnp.bool_(True))
