"""Batched pipeline compiler + scan driver (T2-T4, SURVEY.md §1.2).

The reference's universal execution model is a per-frame Python loop over
cv2 calls (SURVEY.md §3.1-3.3). Here the whole segmentation+tracking pass
over an N-frame batch is ONE jitted XLA program:

- blur/median run batch-parallel over all N frames,
- the background model — the only sequential dependency in segmentation —
  is a cheap elementwise `lax.scan` over the frame axis (or an
  O(log N)-depth `associative_scan` in `parallel_bg` mode, exploiting the
  linearity of B_t = (1-a) B_{t-1} + a F_t),
- diff/threshold/morphology/CCL/stats run batch-parallel again,
- only the tiny tracker-table update scans per frame.

Carry (background, tracker table, frame counter) stays on device across
batches — the rolling state of BASELINE.json:10.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpuva.graph.config import PipelineConfig
from tpuva.ops import (
    background_scan,
    connected_components_with_stats,
    gaussian_blur_u8,
    median_blur,
    morph_close,
    morph_open,
    structuring_element,
    threshold,
)
from tpuva.ops.label import extract_detections
from tpuva.track import TrackState, init_track_state, track_update


class PipelineCarry(NamedTuple):
    bg: jnp.ndarray  # (H, W) float32 background model
    bg_valid: jnp.ndarray  # () bool — False until seeded from first frame
    track: TrackState
    frame_idx: jnp.ndarray  # () int32 — global index of next frame


def init_carry(
    cfg: PipelineConfig, H: int, W: int, background0: Optional[np.ndarray] = None
) -> PipelineCarry:
    if background0 is not None:
        bg = jnp.asarray(background0, jnp.float32)
        valid = jnp.bool_(True)
    else:
        bg = jnp.zeros((H, W), jnp.float32)
        valid = jnp.bool_(False)
    return PipelineCarry(
        bg=bg,
        bg_valid=valid,
        track=init_track_state(cfg.track.max_tracks),
        frame_idx=jnp.int32(0),
    )


def filter_batch(cfg: PipelineConfig, frames: jnp.ndarray) -> jnp.ndarray:
    """The stateless filter prefix (blur, median) on a float32 batch.

    Blur runs as gaussian_blur_u8: the reference feeds cv2 uint8 frames,
    so the blur output re-quantizes to u8 (bit-exact fixed-point
    emulation) before the background model / diff / threshold see it —
    this is what makes blur-enabled configs mask-bit-equal to refimpl.
    Median of integer-valued floats then selects the same values cv2's
    u8 median does, so no further quantization is needed."""
    f = frames
    if cfg.blur is not None:
        f = gaussian_blur_u8(f, cfg.blur.ksize, cfg.blur.sigma)
    if cfg.median is not None:
        f = median_blur(f, cfg.median.ksize)
    return f


def background_trajectory(
    bg0: jnp.ndarray, frames: jnp.ndarray, alpha: float, parallel: bool = False
) -> jnp.ndarray:
    """All post-update backgrounds B_1..B_N for a batch.

    sequential: exact refimpl float ordering. parallel: associative scan
    over affine maps (s, o) with B_t = s_t * B_0 + o_t — O(log N) depth.
    """
    if not parallel:
        return background_scan(bg0, frames, alpha)
    a = jnp.float32(alpha)
    s = jnp.full((frames.shape[0], 1, 1), 1 - a, jnp.float32)
    o = a * frames

    def combine(p, q):
        s1, o1 = p
        s2, o2 = q
        return s1 * s2, s2 * o1 + o2

    S, O = lax.associative_scan(combine, (s, o), axis=0)
    return S * bg0[None] + O


def _finish_batch(cfg, carry, stats, mask, bg_last, return_masks):
    dets, n_det, det_valid, det_sums = extract_detections(
        stats, cfg.segment.min_area, cfg.segment.max_blobs
    )

    def step(ts: TrackState, inp):
        d, dv, fi = inp
        ts, rows, rv = track_update(
            ts,
            d,
            dv,
            fi,
            max_dist=cfg.track.max_dist,
            death_patience=cfg.track.death_patience,
            assigner=cfg.track.assigner,
        )
        return ts, (rows, rv)

    N = mask.shape[0]
    fidx = carry.frame_idx + jnp.arange(N, dtype=jnp.int32)
    # unroll: 8 tracker steps per loop iteration amortize the scan's
    # per-step sequencing with an identical trace per step (no semantic
    # change); the factor is untuned on the GPU
    tstate, (rows, row_valid) = lax.scan(
        step, carry.track, (dets, det_valid, fidx),
        unroll=8 if N % 8 == 0 else 1,
    )
    new_carry = PipelineCarry(
        bg=bg_last,
        bg_valid=jnp.bool_(True),
        track=tstate,
        frame_idx=carry.frame_idx + N,
    )
    out = {
        "rows": rows,
        "row_valid": row_valid,
        "n_det": n_det,
        "row_sums": det_sums,
        # end-of-batch active-track count (SURVEY §5.5 observability) —
        # computed on device, rides the same drain transfer as the rows
        "active_tracks": jnp.sum(tstate.active, dtype=jnp.int32),
    }
    if return_masks:
        out["masks"] = mask
    return new_carry, out


@partial(
    jax.jit,
    static_argnames=("cfg", "parallel_bg", "return_masks", "max_components"),
)
def process_batch(
    cfg: PipelineConfig,
    carry: PipelineCarry,
    frames: jnp.ndarray,  # (N, H, W) uint8 grayscale
    parallel_bg: bool = False,
    return_masks: bool = False,
    max_components: int = 64,
):
    """One fused device program over an N-frame batch.

    Returns (new_carry, out) with out:
      rows      (N, max_blobs, 5) float32 — (track_id, frame, x, y, area)
      row_valid (N, max_blobs) bool
      n_det     (N,) int32
      masks     (N, H, W) uint8, only if return_masks
    """
    f = filter_batch(cfg, frames.astype(jnp.float32))
    bg0 = jnp.where(carry.bg_valid, carry.bg, f[0])
    bgs = background_trajectory(bg0, f, cfg.background.alpha, parallel_bg)
    bg_last = bgs[-1]
    diff = jnp.abs(f - bgs)
    if cfg.segment.threshold == "otsu":
        from tpuva.ops.filters import otsu_threshold

        du8 = jnp.clip(jnp.rint(diff), 0, 255).astype(jnp.uint8)
        thr = otsu_threshold(du8)  # (N,) per-frame
        mask = jnp.where(
            du8.astype(jnp.int32) > thr.astype(jnp.int32)[:, None, None],
            jnp.uint8(255),
            jnp.uint8(0),
        )
    else:
        mask = threshold(diff, cfg.segment.threshold)
    if cfg.morph_open is not None:
        se = structuring_element(cfg.morph_open.shape, cfg.morph_open.ksize)
        mask = morph_open(mask, se, cfg.morph_open.iterations)
    if cfg.morph_close is not None:
        se = structuring_element(cfg.morph_close.shape, cfg.morph_close.ksize)
        mask = morph_close(mask, se, cfg.morph_close.iterations)
    stats = connected_components_with_stats(
        mask,
        max_components=max_components,
        compute_bbox=False,
        compute_labels=False,
    )
    return _finish_batch(cfg, carry, stats, mask, bg_last, return_masks)


def collect_rows_array(rows: np.ndarray, row_valid: np.ndarray,
                       max_frame=None,
                       row_sums: np.ndarray | None = None) -> np.ndarray:
    """Host-side: flatten (N, D, 5) device rows into a (k, 5) float64
    array of (track_id, frame, x, y, area), in (frame, slot) order —
    vectorized numpy (the per-row Python loop cost ~35% of streamed
    driver time at 100k-frame scale).

    When row_sums (N, D, 2 int32 of sx, sy) is given, centroids are
    recomputed as float64 sx/area — bit-identical to
    cv2.connectedComponentsWithStats (float32→float64 widening of the
    stored columns is exact, so this matches the scalar path bit for
    bit)."""
    rows = np.asarray(rows)
    row_valid = np.asarray(row_valid)
    D = rows.shape[-1]
    r2 = rows.reshape(-1, D)
    sel = row_valid.reshape(-1)
    if max_frame is not None:
        sel = sel & (r2[:, 1] < max_frame)
    out = r2[sel].astype(np.float64)
    if row_sums is not None:
        s2 = np.asarray(row_sums).reshape(-1, 2)[sel].astype(np.float64)
        area = out[:, 4]
        out[:, 2] = s2[:, 0] / area
        out[:, 3] = s2[:, 1] / area
    return out


def collect_rows(rows: np.ndarray, row_valid: np.ndarray, max_frame=None,
                 row_sums: np.ndarray | None = None):
    """collect_rows_array, as the legacy list of python tuples
    ((int, int, float, float, float) per row)."""
    arr = collect_rows_array(rows, row_valid, max_frame, row_sums)
    return [
        (int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4]))
        for r in arr
    ]


def process_clip(
    clip: np.ndarray,
    cfg: PipelineConfig,
    background0: Optional[np.ndarray] = None,
    parallel_bg: bool = False,
    return_masks: bool = False,
    max_components: int = 64,
):
    """Host convenience driver: run a whole (T, H, W) uint8 clip through
    batched device processing. Returns (rows, final_carry, masks-or-None).

    The final partial batch is padded by repeating the last frame; padded
    frames' rows are dropped (tracker/background perturbation past the clip
    end is discarded with the final carry).
    """
    T, H, W = clip.shape
    N = cfg.batch
    carry = init_carry(cfg, H, W, background0)
    all_rows = []
    masks = [] if return_masks else None
    for start in range(0, T, N):
        chunk = clip[start : start + N]
        n = chunk.shape[0]
        if n < N:
            pad = np.repeat(chunk[-1:], N - n, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        carry, out = process_batch(
            cfg,
            carry,
            jnp.asarray(chunk),
            parallel_bg=parallel_bg,
            return_masks=return_masks,
            max_components=max_components,
        )
        all_rows.extend(
            collect_rows(
                out["rows"], out["row_valid"], max_frame=T,
                row_sums=out["row_sums"],
            )
        )
        if return_masks:
            masks.append(np.asarray(out["masks"])[:n])
    if return_masks:
        masks = np.concatenate(masks, axis=0)
    return all_rows, carry, masks
