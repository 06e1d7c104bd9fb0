"""Config-space fuzz: randomized pipeline configs run through BOTH the
refimpl CPU oracle and the batched device path on the same synthetic
scene (SURVEY.md §4.2 property-test strategy, generalizing the
hand-picked e2e configs).

Two families, both now fully bit-exact vs the refimpl/cv2 oracle:

- blur=None: every op on the path (median, threshold incl. Otsu,
  morphology, CCL+stats, tracker) is bit-reproducible vs cv2 — masks
  bit-equal, rows id-exact.
- blur on: the device path runs ops.gaussian_blur_u8, a bit-exact
  emulation of cv2's uint8 fixed-point GaussianBlur (error-diffusion
  quantized taps, single half-away rounding), and re-quantizes to u8
  before the background model like refimpl does — so masks are
  bit-equal and rows id-exact here too (upgraded from the former
  <=1 px rounding-band contract).

Seeded, so failures reproduce; keep the config count small — every
distinct config is a fresh XLA compile on the CI box.
"""

import numpy as np
import pytest

from refimpl.pipeline import run_pipeline
from refimpl.synthetic import multi_blob_clip
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

from tests.test_pipeline_e2e import assert_rows_match


def random_config(rng: np.random.Generator, with_blur: bool,
                  allow_otsu: bool = False) -> PipelineConfig:
    # ksize 9 exercises the u8_gaussian_taps error-diffusion path (non-
    # binomial taps); 3/5/7 the exact binomial cascade
    blur = int(rng.choice([3, 5, 7, 9])) if with_blur else 0
    median = rng.choice([0, 3])
    mo = rng.choice([0, 3, 5])
    mc = rng.choice([0, 3])
    thr_pool = [25.0, 40.0] + (["otsu"] if allow_otsu else [])
    thr = thr_pool[int(rng.integers(len(thr_pool)))]
    return PipelineConfig(
        background=BackgroundConfig(alpha=float(rng.choice([0.0, 0.02, 0.1]))),
        blur=BlurConfig(ksize=blur) if blur else None,
        median=MedianConfig(ksize=int(median)) if median else None,
        morph_open=(
            MorphConfig(ksize=int(mo),
                        shape=str(rng.choice(["rect", "ellipse"])))
            if mo else None
        ),
        morph_close=(
            MorphConfig(ksize=int(mc),
                        shape=str(rng.choice(["rect", "ellipse"])))
            if mc else None
        ),
        segment=SegmentConfig(
            threshold=thr,
            min_area=int(rng.choice([10, 30])),
            max_blobs=6,
        ),
        track=TrackConfig(
            max_dist=float(rng.choice([40.0, 80.0])),
            death_patience=int(rng.choice([2, 5])),
            max_tracks=12,
            assigner=str(rng.choice(["greedy", "hungarian"])),
        ),
        batch=int(rng.choice([4, 8, 16])),
    )


def fuzz_scene(seed):
    return multi_blob_clip(
        h=96, w=128, frames=24, n_blobs=3, radius=7,
        births_deaths=bool(seed % 2), noise_sigma=2.0, seed=seed,
    )


@pytest.mark.parametrize("seed", range(4))
def test_random_config_bit_exact_without_blur(seed):
    """Everything except Gaussian blur is bit-reproducible: random
    configs of the other knobs must match refimpl exactly."""
    rng = np.random.default_rng(1000 + seed)
    cfg = random_config(rng, with_blur=False)
    clip, _, _, plate = fuzz_scene(seed)
    ref = run_pipeline(clip, cfg, background0=plate, record=True)
    rows, _, masks = process_clip(
        clip, cfg, background0=plate, return_masks=True
    )
    np.testing.assert_array_equal(masks, np.stack(ref.masks))
    assert_rows_match(ref.rows, rows)


def test_filter_chain_fuzz_batch_equals_frame_path():
    """T2 filter-chain fuzz: random compositions (crop, blur, median,
    time-difference, normalize) must produce identical results through
    the compiled batch path (iter_batches, carries across batch
    boundaries) and the per-frame random-access path — incl. the
    stateful FilterTimeDifference carry at every batch size."""
    from tpuva.filters import (
        FilterBlur,
        FilterCrop,
        FilterMedian,
        FilterMonochrome,
        FilterNormalize,
        FilterTimeDifference,
    )
    from tpuva.io import VideoMemory

    base = np.random.default_rng(5).integers(
        0, 256, (13, 40, 56, 3), np.uint8
    )
    for seed in range(6):
        r = np.random.default_rng(100 + seed)
        v = FilterMonochrome(VideoMemory(base))
        if r.random() < 0.5:
            v = FilterCrop(v, (4, 2, 48, 32))
        if r.random() < 0.5:
            v = FilterBlur(v, ksize=int(r.choice([3, 5])))
        if r.random() < 0.4:
            v = FilterMedian(v, 3)
        if r.random() < 0.7:
            v = FilterTimeDifference(v)
        if r.random() < 0.5:
            v = FilterNormalize(v, 0, 255)
        ref = np.stack([v.get_frame(i) for i in range(v.frame_count)])
        for B in (3, 4, 8):
            outs = [s[:n] for n, s in v.iter_batches(B)]
            got = np.concatenate(outs)
            np.testing.assert_array_equal(got, ref, err_msg=f"{seed}/{B}")


@pytest.mark.parametrize("seed", range(4))
def test_random_config_with_blur_bit_exact(seed):
    """With blur too, the device path is now bit-exact: gaussian_blur_u8
    reproduces cv2's uint8 fixed-point blur (error-diffusion quantized
    taps + single half-away rounding) exactly, so masks are bit-equal
    and rows id-exact — the former <=1 px rounding band is retired."""
    rng = np.random.default_rng(2000 + seed)
    cfg = random_config(rng, with_blur=True)
    clip, _, _, plate = fuzz_scene(seed)
    ref = run_pipeline(clip, cfg, background0=plate, record=True)
    rows, _, masks = process_clip(
        clip, cfg, background0=plate, return_masks=True
    )
    np.testing.assert_array_equal(masks, np.stack(ref.masks))
    assert_rows_match(ref.rows, rows)
