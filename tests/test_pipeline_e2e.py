"""End-to-end equivalence: the batched device pipeline vs the refimpl CPU
oracle on the BASELINE.json config shapes (scaled down for CI) — masks bit-equal, track
rows id-exact, centroids well within the 1px tolerance (BASELINE.json:5)."""

import numpy as np
import pytest

from refimpl.pipeline import run_pipeline
from refimpl.synthetic import moving_disk_clip, multi_blob_clip
from tpuva.graph.config import (
    BackgroundConfig,
    BlurConfig,
    MedianConfig,
    MorphConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)
from tpuva.graph.pipeline import process_clip


def assert_rows_match(ref_rows, got_rows, pos_tol=1e-2, area_tol=0):
    assert len(ref_rows) == len(got_rows), (
        f"row count {len(got_rows)} != ref {len(ref_rows)}"
    )
    key = lambda r: (r[0], r[1])
    for r, t in zip(sorted(ref_rows, key=key), sorted(got_rows, key=key)):
        assert int(r[0]) == int(t[0]), f"track id {t} vs {r}"
        assert int(r[1]) == int(t[1]), f"frame {t} vs {r}"
        assert abs(r[2] - t[2]) < pos_tol and abs(r[3] - t[3]) < pos_tol, (
            f"centroid {t} vs {r}"
        )
        assert abs(int(round(r[4])) - int(round(t[4]))) <= area_tol, (
            f"area {t} vs {r}"
        )


def test_config1_shape_single_blob():
    """Config 1 (BASELINE.json:7): grayscale clip, one moving blob,
    running-mean bg + threshold + centroid track. No blur/morph."""
    clip, truth, plate = moving_disk_clip(h=120, w=160, frames=64, radius=8)
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.02),
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=16,
    )
    ref = run_pipeline(clip, cfg, background0=plate, record=True)
    rows, carry, masks = process_clip(
        clip, cfg, background0=plate, return_masks=True
    )
    np.testing.assert_array_equal(masks, np.stack(ref.masks))
    assert_rows_match(ref.rows, rows)
    # and truth accuracy
    arr = np.array(rows)
    order = np.argsort(arr[:, 1])
    fr = arr[order, 1].astype(int)
    err = np.hypot(arr[order, 2] - truth[fr, 0], arr[order, 3] - truth[fr, 1])
    assert err.max() < 1.0


def test_config2_shape_full_filter_stack():
    """Config 2 (BASELINE.json:8): bg model + Gaussian blur + morphology +
    connected components, one tracked object."""
    clip, truth, plate = moving_disk_clip(
        h=144, w=192, frames=48, radius=9, noise_sigma=4.0, seed=2
    )
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.05),
        blur=BlurConfig(ksize=5, sigma=0.0),
        median=MedianConfig(ksize=3),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        morph_close=MorphConfig(ksize=3, shape="ellipse"),
        segment=SegmentConfig(threshold=35.0, min_area=25, max_blobs=4),
        track=TrackConfig(max_dist=50.0, death_patience=5, max_tracks=8),
        batch=16,
    )
    ref = run_pipeline(clip, cfg, background0=plate, record=True)
    rows, carry, masks = process_clip(
        clip, cfg, background0=plate, return_masks=True
    )
    # noisy clip: blur float assoc. can flip knife-edge threshold pixels
    mism = (masks != np.stack(ref.masks)).mean()
    assert mism < 1e-4, f"mask pixel mismatch rate {mism}"
    assert_rows_match(ref.rows, rows, pos_tol=0.05, area_tol=2)


@pytest.mark.parametrize("assigner", ["greedy", "hungarian"])
def test_config3_shape_multi_object(assigner):
    """Config 3 (BASELINE.json:9): multi-object, greedy/Hungarian
    association, birth/death handling."""
    clip, alive, truth, plate = multi_blob_clip(
        h=160, w=240, frames=60, n_blobs=4, radius=9, births_deaths=True
    )
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.0),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=8),
        track=TrackConfig(
            max_dist=40.0, death_patience=3, max_tracks=16, assigner=assigner
        ),
        batch=16,
    )
    ref = run_pipeline(clip, cfg, background0=plate)
    rows, _, _ = process_clip(clip, cfg, background0=plate)
    assert_rows_match(ref.rows, rows)


def test_first_frame_bg_init():
    """background init='first' (no explicit plate) matches refimpl."""
    clip, _, _ = moving_disk_clip(h=96, w=128, frames=40, radius=8, seed=5)
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.1),
        segment=SegmentConfig(threshold=30.0, min_area=15, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=3, max_tracks=8),
        batch=16,
    )
    ref = run_pipeline(clip, cfg, record=True)
    rows, _, masks = process_clip(clip, cfg, return_masks=True)
    np.testing.assert_array_equal(masks, np.stack(ref.masks))
    assert_rows_match(ref.rows, rows)


def test_batch_boundary_invariance():
    """Results must not depend on the batch size (carry correctness)."""
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=50, radius=8, seed=7)
    base = dict(
        background=BackgroundConfig(alpha=0.03),
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    )
    r1, _, _ = process_clip(clip, PipelineConfig(batch=8, **base), background0=plate)
    r2, _, _ = process_clip(clip, PipelineConfig(batch=32, **base), background0=plate)
    assert_rows_match(r1, r2, pos_tol=1e-5)


def test_parallel_bg_matches_sequential():
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=48, radius=8, seed=9)
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.05),
        segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=16,
    )
    r_seq, _, m_seq = process_clip(clip, cfg, background0=plate, return_masks=True)
    r_par, _, m_par = process_clip(
        clip, cfg, background0=plate, parallel_bg=True, return_masks=True
    )
    mism = (m_seq != m_par).mean()
    assert mism < 1e-4
    assert_rows_match(r_seq, r_par, pos_tol=0.05, area_tol=2)


def test_otsu_threshold_end_to_end():
    """SegmentConfig(threshold='otsu') matches refimpl's cv2.THRESH_OTSU
    path end-to-end (SURVEY.md §2.2 threshold row)."""
    clip, _, plate = moving_disk_clip(
        h=120, w=160, frames=48, radius=9, noise_sigma=3.0, seed=13
    )
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.05),
        blur=BlurConfig(ksize=5, sigma=0.0),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        segment=SegmentConfig(threshold="otsu", min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=16,
    )
    ref = run_pipeline(clip, cfg, background0=plate, record=True)
    rows, _, masks = process_clip(
        clip, cfg, background0=plate, return_masks=True
    )
    mism = (masks != np.stack(ref.masks)).mean()
    assert mism < 1e-4, f"otsu mask mismatch rate {mism}"
    assert_rows_match(ref.rows, rows, pos_tol=0.05, area_tol=2)


def _scene(kind, h=96, w=144, frames=40, seed=1, noise=3.0):
    if kind == "disk":
        clip, _, plate = moving_disk_clip(
            h=h, w=w, frames=frames, radius=8, noise_sigma=noise, seed=seed
        )
    elif kind == "blobs":
        clip, _, _, plate = multi_blob_clip(
            h=h, w=w, frames=frames, n_blobs=4, radius=8, noise_sigma=noise,
            seed=seed,
        )
    else:  # the clean plate alone: nothing moves
        clip = np.full((frames, h, w), 20, np.uint8)
        plate = clip[0]
    return clip, plate


_TRACK = TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8)
_CASES = {
    "blur5_open_close": (
        ("disk",), dict(background=BackgroundConfig(alpha=0.05),
                        blur=BlurConfig(5, 0.0), morph_open=MorphConfig(3),
                        morph_close=MorphConfig(3, "ellipse"),
                        segment=SegmentConfig(35.0, 20, 4))),
    "blur7": (("disk",), dict(background=BackgroundConfig(alpha=0.05),
                              blur=BlurConfig(7, 0.0),
                              morph_open=MorphConfig(3),
                              segment=SegmentConfig(35.0, 20, 4))),
    "blur5_sigma": (("disk",), dict(background=BackgroundConfig(alpha=0.05),
                                    blur=BlurConfig(5, 1.5),
                                    morph_open=MorphConfig(3),
                                    segment=SegmentConfig(35.0, 20, 4))),
    "first_frame_bg": (("disk", 96, 144, 40, 4), dict(
        background=BackgroundConfig(alpha=0.1), blur=BlurConfig(3, 0.0),
        segment=SegmentConfig(30.0, 10, 4))),
    "no_filters": (("blobs", 96, 144, 40, 2, 0.0), dict(
        background=BackgroundConfig(alpha=0.0),
        segment=SegmentConfig(40.0, 15, 8),
        track=TrackConfig(max_dist=40.0, death_patience=3, max_tracks=16))),
    "median3": (("disk", 96, 144, 40, 3), dict(
        background=BackgroundConfig(alpha=0.05), blur=BlurConfig(3, 0.0),
        median=MedianConfig(3), morph_open=MorphConfig(3),
        segment=SegmentConfig(30.0, 15, 4))),
    "births_deaths": (("blobs", 128, 192, 48, 5), dict(
        background=BackgroundConfig(alpha=0.06), blur=BlurConfig(5, 0.0),
        morph_open=MorphConfig(3), morph_close=MorphConfig(3, "ellipse"),
        segment=SegmentConfig(32.0, 15, 4),
        track=TrackConfig(max_dist=80.0, death_patience=4, max_tracks=8))),
    "unaligned": (("disk", 97, 145, 40, 6), dict(
        background=BackgroundConfig(alpha=0.05), blur=BlurConfig(5, 0.0),
        morph_open=MorphConfig(3), morph_close=MorphConfig(3, "ellipse"),
        segment=SegmentConfig(35.0, 20, 4))),
    "empty_scene": (("plate",), dict(
        background=BackgroundConfig(alpha=0.05), blur=BlurConfig(5, 0.0),
        morph_open=MorphConfig(3), segment=SegmentConfig(35.0, 20, 4))),
    "iterations": (("disk", 96, 144, 40, 8), dict(
        background=BackgroundConfig(alpha=0.05), blur=BlurConfig(5, 0.0),
        morph_open=MorphConfig(3, "rect", iterations=2),
        morph_close=MorphConfig(5, "ellipse"),
        segment=SegmentConfig(35.0, 20, 4))),
    "greedy": (("blobs", 128, 192, 48, 9), dict(
        background=BackgroundConfig(alpha=0.02), blur=BlurConfig(5, 0.0),
        morph_close=MorphConfig(3, "ellipse"),
        segment=SegmentConfig(35.0, 20, 8),
        track=TrackConfig(max_dist=40.0, death_patience=3, max_tracks=16,
                          assigner="greedy"))),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_process_batch_bit_equal_to_refimpl(name):
    """process_batch (through process_clip, batch 16) against the OpenCV
    oracle: masks and rows bit-equal, for each front-end configuration
    the pipeline supports."""
    scene, cfg_kw = _CASES[name]
    clip, plate = _scene(*scene)
    cfg = PipelineConfig(batch=16, **{"track": _TRACK, **cfg_kw})
    bg0 = None if name == "first_frame_bg" else plate
    ref = run_pipeline(clip, cfg, background0=bg0, record=True)
    rows, _, masks = process_clip(clip, cfg, background0=bg0,
                                  return_masks=True)
    np.testing.assert_array_equal(masks, np.stack(ref.masks))
    key = lambda r: (int(r[1]), int(r[0]))
    got = np.asarray(sorted(rows, key=key), np.float64).reshape(-1, 5)
    want = np.asarray(sorted(ref.rows, key=key), np.float64).reshape(-1, 5)
    np.testing.assert_array_equal(got, want)
    if name == "empty_scene":
        assert len(rows) == 0
    else:
        assert len(rows) > 0
