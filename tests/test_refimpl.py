"""Sanity tests for the refimpl oracle itself: on synthetic clips with
analytic ground truth, the reference-equivalent CPU pipeline must recover the
scripted centroids (this validates the oracle before it is used as the golden
target for the device path)."""

import numpy as np
import pytest

from refimpl.pipeline import run_pipeline
from refimpl.synthetic import moving_disk_clip, multi_blob_clip
from tpuva.graph.config import (
    BackgroundConfig,
    MorphConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)


def test_single_disk_track():
    clip, truth, plate = moving_disk_clip(h=120, w=160, frames=60, radius=8)
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.0),  # static background
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5),
    )
    res = run_pipeline(clip, cfg, background0=plate)
    rows = np.array(res.rows)
    # exactly one track, present every frame
    assert rows.shape[0] == clip.shape[0]
    assert set(rows[:, 0]) == {1}
    # centroid error <= 1 px vs analytic truth (BASELINE.json:5 tolerance)
    order = np.argsort(rows[:, 1])
    err = np.hypot(
        rows[order, 2] - truth[:, 0], rows[order, 3] - truth[:, 1]
    )
    assert err.max() < 1.0


def test_multi_blob_birth_death():
    clip, alive, truth, plate = multi_blob_clip(
        h=160, w=240, frames=50, n_blobs=3, radius=9, births_deaths=True
    )
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.0),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=8),
        track=TrackConfig(max_dist=40.0, death_patience=3, assigner="hungarian"),
    )
    res = run_pipeline(clip, cfg, background0=plate)
    rows = np.array(res.rows)
    assert rows.size > 0
    n_tracks = len(set(rows[:, 0]))
    # at least as many tracks as blobs (crossings may split tracks)
    assert n_tracks >= 3
    # every detection-bearing frame contributed rows
    frames_with_rows = set(rows[:, 1].astype(int))
    frames_with_blobs = set(np.nonzero(alive.any(axis=1))[0].tolist())
    assert frames_with_blobs <= frames_with_rows


def test_export_roundtrip(tmp_path):
    from tpuva.export import (
        read_tracks_csv,
        read_tracks_hdf5,
        write_tracks_csv,
        write_tracks_hdf5,
    )

    rows = [(1, 0, 10.5, 20.25, 30), (1, 1, 11.0, 21.0, 31), (2, 1, 5.0, 6.0, 7)]
    p = tmp_path / "t.csv"
    write_tracks_csv(p, rows)
    back = read_tracks_csv(p)
    assert back.shape == (3, 5)
    np.testing.assert_allclose(back[:, 2], [10.5, 11.0, 5.0])
    h = tmp_path / "t.h5"
    write_tracks_hdf5(h, rows)
    tab = read_tracks_hdf5(h)
    assert tab.shape == (3, 5)
    np.testing.assert_allclose(tab[:, 0], [1, 1, 2])


def _multi_blob_clip_per_frame(h, w, frames, n_blobs, radius, bg_level=20,
                               fg_level=220, births_deaths=True,
                               noise_sigma=0.0, seed=1):
    """The straightforward generator multi_blob_clip must reproduce: render
    every frame whole, then add that frame's noise draw."""
    from refimpl.synthetic import render_disk

    rng = np.random.default_rng(seed)
    margin = radius + 4
    pos = np.stack([rng.uniform(margin, w - margin, n_blobs),
                    rng.uniform(margin, h - margin, n_blobs)], axis=1)
    vel = rng.uniform(-6, 6, (n_blobs, 2))
    if births_deaths:
        start = rng.integers(0, frames // 3, n_blobs)
        start[0] = 0
        end = rng.integers(2 * frames // 3, frames + 1, n_blobs)
    else:
        start = np.zeros(n_blobs, int)
        end = np.full(n_blobs, frames, int)
    plate = np.full((h, w), bg_level, np.uint8)
    clip = np.empty((frames, h, w), np.uint8)
    alive = np.zeros((frames, n_blobs), bool)
    truth = np.full((frames, n_blobs, 2), np.nan)
    for t in range(frames):
        f = plate.copy()
        for i in range(n_blobs):
            if start[i] <= t < end[i]:
                alive[t, i] = True
                truth[t, i] = pos[i]
                render_disk(h, w, pos[i, 0], pos[i, 1], radius, fg_level, f)
        if noise_sigma > 0:
            f = np.clip(f.astype(np.float32)
                        + rng.normal(0, noise_sigma, (h, w)),
                        0, 255).astype(np.uint8)
        clip[t] = f
        pos += vel
        for d, lim in ((0, w), (1, h)):
            low = pos[:, d] < margin
            high = pos[:, d] > lim - margin
            vel[low | high, d] *= -1
            pos[:, d] = np.clip(pos[:, d], margin, lim - margin)
    return clip, alive, truth, plate


@pytest.mark.parametrize(
    "kw",
    [
        dict(h=96, w=128, frames=40, n_blobs=5, radius=9, noise_sigma=3.0),
        dict(h=64, w=80, frames=30, n_blobs=3, radius=20.5,
             births_deaths=False),
        dict(h=120, w=160, frames=25, n_blobs=6, radius=16,
             births_deaths=False, noise_sigma=2.0, seed=4),
    ],
)
def test_multi_blob_clip_matches_per_frame_rendering(kw):
    """multi_blob_clip renders disks in their bounding boxes and draws
    noise for many frames at once; its frames, truth and plate stay
    identical to the per-frame generator's."""
    got = multi_blob_clip(**kw)
    want = _multi_blob_clip_per_frame(**kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
