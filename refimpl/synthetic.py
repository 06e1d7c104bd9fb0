"""Synthetic clip generators with analytic ground truth.

Mirrors the fixture style the reference's research workflow implies
(SURVEY.md §4): in-memory uint8 clips with known centroid tracks.
BASELINE.json:7's first eval config *is* such a clip (640x480, 300 frames,
one moving blob).
"""

from __future__ import annotations

import numpy as np


def render_disk(h: int, w: int, cx: float, cy: float, radius: float,
                fg: int = 255, frame: np.ndarray | None = None) -> np.ndarray:
    """Render a hard-edged filled disk at float center (cx, cy).

    x = column, y = row (OpenCV convention, SURVEY.md §8: centroid x is the
    column coordinate). Pixel (r, c) is inside when its center is within
    ``radius`` of (cx, cy).
    """
    if frame is None:
        frame = np.zeros((h, w), np.uint8)
    yy, xx = np.ogrid[:h, :w]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius ** 2
    frame[mask] = fg
    return frame


def moving_disk_clip(
    h: int = 480,
    w: int = 640,
    frames: int = 300,
    radius: float = 12.0,
    bg_level: int = 20,
    fg_level: int = 200,
    noise_sigma: float = 0.0,
    seed: int = 0,
):
    """One disk on a Lissajous path over a flat background.

    Returns (clip uint8 (T,H,W), truth float64 (T,2) of (x, y) centers,
    clean_plate uint8 (H,W)).
    """
    rng = np.random.default_rng(seed)
    clip = np.empty((frames, h, w), np.uint8)
    truth = np.empty((frames, 2), np.float64)
    margin = radius + 4
    plate = np.full((h, w), bg_level, np.uint8)
    for t in range(frames):
        ph = 2 * np.pi * t / frames
        cx = w / 2 + (w / 2 - margin) * np.sin(2 * ph)
        cy = h / 2 + (h / 2 - margin) * np.sin(3 * ph + 0.7)
        f = plate.copy()
        render_disk(h, w, cx, cy, radius, fg_level, f)
        if noise_sigma > 0:
            f = np.clip(
                f.astype(np.float32) + rng.normal(0, noise_sigma, (h, w)),
                0, 255,
            ).astype(np.uint8)
        clip[t] = f
        truth[t] = (cx, cy)
    return clip, truth, plate


def multi_blob_clip(
    h: int = 1080,
    w: int = 1920,
    frames: int = 120,
    n_blobs: int = 4,
    radius: float = 16.0,
    bg_level: int = 20,
    fg_level: int = 220,
    births_deaths: bool = True,
    noise_sigma: float = 0.0,
    seed: int = 1,
):
    """Several disks on straight bouncing paths, with optional scripted
    births/deaths (each blob i is alive on [start_i, end_i)).

    Returns (clip (T,H,W) uint8, alive (T,B) bool, truth (T,B,2) float64
    (x,y; NaN while dead), clean_plate (H,W) uint8).
    """
    rng = np.random.default_rng(seed)
    margin = radius + 4
    pos = np.stack(
        [rng.uniform(margin, w - margin, n_blobs),
         rng.uniform(margin, h - margin, n_blobs)], axis=1)
    vel = rng.uniform(-6, 6, (n_blobs, 2))
    if births_deaths:
        start = rng.integers(0, frames // 3, n_blobs)
        start[0] = 0  # at least one blob alive from the first frame
        end = rng.integers(2 * frames // 3, frames + 1, n_blobs)
    else:
        start = np.zeros(n_blobs, int)
        end = np.full(n_blobs, frames, int)

    plate = np.full((h, w), bg_level, np.uint8)
    alive = np.zeros((frames, n_blobs), bool)
    truth = np.full((frames, n_blobs, 2), np.nan)
    centers = np.empty((frames, n_blobs, 2))
    for t in range(frames):
        centers[t] = pos
        for i in range(n_blobs):
            if start[i] <= t < end[i]:
                alive[t, i] = True
                truth[t, i] = pos[i]
        # advance + bounce
        pos += vel
        for d, lim in ((0, w), (1, h)):
            low = pos[:, d] < margin
            high = pos[:, d] > lim - margin
            vel[low | high, d] *= -1
            pos[:, d] = np.clip(pos[:, d], margin, lim - margin)

    clip = np.empty((frames, h, w), np.uint8)
    clip[:] = plate
    for t in range(frames):
        for i in np.flatnonzero(alive[t]):
            _render_disk_box(clip[t], centers[t, i, 0], centers[t, i, 1],
                             radius, fg_level)
    if noise_sigma > 0:
        # one (chunk, h, w) draw consumes the generator exactly like
        # `chunk` successive (h, w) draws, so the frames do not depend on
        # the chunk size
        chunk = max(1, (1 << 24) // (h * w))
        for t0 in range(0, frames, chunk):
            part = clip[t0:t0 + chunk]
            noise = rng.normal(0, noise_sigma, part.shape)
            noise += part.astype(np.float32)
            np.clip(noise, 0, 255, out=noise)
            part[:] = noise.astype(np.uint8)
    return clip, alive, truth, plate


def _render_disk_box(frame: np.ndarray, cx: float, cy: float, radius: float,
                     fg: int) -> None:
    """render_disk restricted to the disk's bounding box: the same
    per-pixel test, evaluated only where it can be true."""
    h, w = frame.shape
    r0, r1 = max(0, int(cy - radius) - 1), min(h, int(cy + radius) + 2)
    c0, c1 = max(0, int(cx - radius) - 1), min(w, int(cx + radius) + 2)
    yy, xx = np.ogrid[r0:r1, c0:c1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius ** 2
    frame[r0:r1, c0:c1][mask] = fg


def random_mask(h: int, w: int, density: float = 0.3, seed: int = 0,
                blocky: bool = False) -> np.ndarray:
    """Random binary uint8 mask (0/255) for CCL/morphology golden tests."""
    rng = np.random.default_rng(seed)
    if blocky:
        sh, sw = max(1, h // 8), max(1, w // 8)
        small = rng.random((sh, sw)) < density
        m = np.kron(small, np.ones((h // sh + 1, w // sw + 1), bool))[:h, :w]
    else:
        m = rng.random((h, w)) < density
    return (m * 255).astype(np.uint8)
