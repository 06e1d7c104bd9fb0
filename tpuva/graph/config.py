"""Typed pipeline configuration tree.

The reference keeps its parameters in a big nested dict with per-video
overrides (SURVEY.md §5.6, companion-project style).  The rebuild uses one
typed dataclass tree serializable to JSON so that "same filter/segmenter
composition" (BASELINE.json:5) is expressible as data.

This module is deliberately import-light (no jax/cv2): it is shared between
the device pipeline (tpuva.graph.pipeline) and the NumPy/OpenCV oracle
(refimpl.pipeline), which must agree on semantics knob-for-knob.

Canonical pipeline order (pinned; both implementations follow it exactly):

  1. input frame (grayscale uint8) -> float32
  2. optional Gaussian blur          (BlurConfig) — cv2's UINT8 path:
     the output re-quantizes to u8 values before anything downstream
     sees it (refimpl: cv2.GaussianBlur on the u8 frame; device:
     ops.gaussian_blur_u8, a bit-exact fixed-point emulation)
  3. optional median filter          (MedianConfig)
  4. background update  B <- (1-alpha)*B + alpha*F   [before diff, as the
     reference's pass-1 loop does: SURVEY.md §3.2]
  5. diff = |F - B|
  6. mask = diff > threshold         (strict >, OpenCV THRESH_BINARY)
  7. optional morphological open     (MorphConfig)
  8. optional morphological close    (MorphConfig)
  9. connected components (8-connectivity, raster-scan label order)
 10. detections = components with area >= min_area, by label order,
     capped at max_blobs
 11. tracker update (assignment + birth/death)
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class BlurConfig:
    """Gaussian blur; semantics of cv2.GaussianBlur (SURVEY.md §2.2, §8).

    ``sigma <= 0`` selects OpenCV's hardcoded binomial kernels for
    ksize <= 7 and the 0.3*((k-1)*0.5-1)+0.8 formula above that.
    Border mode is REFLECT_101.
    """

    ksize: int = 5
    sigma: float = 0.0


@dataclass(frozen=True)
class MedianConfig:
    """Median filter; semantics of cv2.medianBlur (BORDER_REPLICATE)."""

    ksize: int = 3


@dataclass(frozen=True)
class MorphConfig:
    """Morphological open/close; cv2.morphologyEx semantics.

    shape: 'rect' or 'ellipse' (cv2.getStructuringElement).
    Border: constant +inf/-inf so border pixels never shrink the image.
    """

    ksize: int = 3
    shape: str = "rect"
    iterations: int = 1


@dataclass(frozen=True)
class BackgroundConfig:
    """Running-average background model (cv2.accumulateWeighted semantics):
    ``B <- (1-alpha)*B + alpha*F`` with a float32 accumulator.

    init: 'first' initializes B from the first frame of the stream; an
    explicit array can be supplied to the pipeline at run time instead.
    """

    alpha: float = 0.02
    init: str = "first"


@dataclass(frozen=True)
class SegmentConfig:
    """threshold: a float applies strict ``diff > threshold`` on the
    float32 diff; the string ``"otsu"`` rounds the diff to uint8
    (np.rint, clipped) and picks the per-frame Otsu threshold from its
    256-bin histogram (cv2.THRESH_OTSU semantics, SURVEY.md §2.2)."""

    threshold: float | str = 25.0
    min_area: int = 10
    max_blobs: int = 8  # static detection capacity (BASELINE.json:9: 2-8)


@dataclass(frozen=True)
class TrackConfig:
    max_dist: float = 50.0
    death_patience: int = 5
    max_tracks: int = 16  # static track-table capacity
    assigner: str = "greedy"  # 'greedy' | 'hungarian'


@dataclass(frozen=True)
class PipelineConfig:
    background: BackgroundConfig = field(default_factory=BackgroundConfig)
    blur: Optional[BlurConfig] = None
    median: Optional[MedianConfig] = None
    morph_open: Optional[MorphConfig] = None
    morph_close: Optional[MorphConfig] = None
    segment: SegmentConfig = field(default_factory=SegmentConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    batch: int = 16  # frames per device batch (the lax.scan chunk)

    # ------------------------------------------------------------------ json
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        d = json.loads(s)

        def opt(cls, key):
            return cls(**d[key]) if d.get(key) is not None else None

        return PipelineConfig(
            background=BackgroundConfig(**d["background"]),
            blur=opt(BlurConfig, "blur"),
            median=opt(MedianConfig, "median"),
            morph_open=opt(MorphConfig, "morph_open"),
            morph_close=opt(MorphConfig, "morph_close"),
            segment=SegmentConfig(**d["segment"]),
            track=TrackConfig(**d["track"]),
            batch=d.get("batch", 16),
        )
