"""tpuva — a batched, accelerator-resident video-analysis framework.

A ground-up rebuild of the capabilities of the reference research tool
(david-zwicker/video-analysis, see SURVEY.md): lazy video-iterator IO,
composable filters, background-subtraction segmentation, blob tracking and
trajectory export — re-architected for JAX/XLA on an accelerator:

- per-frame Python loops become batched ``(N, H, W)`` XLA programs,
- sequential state (background model, tracker) rides ``lax.scan`` carries,
- multi-stream parallelism is a ``shard_map`` over a ``('stream',)`` mesh,
- host decode is pipelined with device compute via double-buffered staging.

Layer map (SURVEY.md §1.2):
  T0  tpuva.ops        — XLA ops on frame batches
  T1  tpuva.io         — host decode + staging (reference: video/io/)
  T2  tpuva.filters    — filter-graph API (reference: video/filters.py)
  T3  tpuva.ops.label  — segmentation + per-blob stats
  T4  tpuva.track      — scan-based tracker (reference: companion project)
  T5  tpuva.export     — CSV/HDF5 writers, tpuva.compose — debug movies
  T6  tpuva.dist       — multi-stream shard_map pipelines
"""

__version__ = "0.1.0"

from tpuva.graph.config import (  # noqa: F401
    BackgroundConfig,
    BlurConfig,
    MedianConfig,
    MorphConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)
from tpuva.utils import apply_debug_flags as _apply_debug_flags

_apply_debug_flags()  # TPUVA_DEBUG_NANS=1 dev guard (SURVEY.md §5.2)
