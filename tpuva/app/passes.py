"""Multi-pass tracking application (reference: the companion project's
pass drivers, SURVEY.md §2.1/§3.2/§5.4).

Each pass persists its full result to disk and later passes restart from
the previous pass's file — the reference's de-facto recovery story, kept
as the application-level contract on top of the batch-granular checkpoints
of StreamingPipeline:

  pass 1  segmentation + raw tracking  -> pass1_tracks.h5
  pass 2  stitching + interpolation + smoothing -> pass2_tracks.h5
  pass 3  per-track statistics report  -> report.json / report.csv
  pass 4  annotated debug movie        -> debug.avi (optional)
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from tpuva.app.params import Parameters
from tpuva.app.tracks import TrackCollection
from tpuva.export import read_tracks_hdf5, write_tracks_csv, write_tracks_hdf5
from tpuva.graph.config import PipelineConfig
from tpuva.graph.streaming import StreamingPipeline
from tpuva.io.base import VideoBase
from tpuva.utils import ensure_directory_exists

DEFAULTS = Parameters(
    {
        "pass2": {"max_gap": 10, "max_dist": 40.0, "min_length": 3,
                  "smooth_window": 0, "interpolate": True},
        "pass4": {"enabled": False, "trail": 25},
        "pipeline": {"checkpoint_every": 50},
    }
)


class TrackingProject:
    """Drive the full multi-pass analysis of one video into `out_dir`."""

    def __init__(
        self,
        out_dir: str,
        cfg: PipelineConfig,
        params: Optional[Parameters] = None,
        overrides: Optional[dict] = None,
    ):
        self.out_dir = ensure_directory_exists(out_dir)
        self.cfg = cfg
        p = params or DEFAULTS
        if overrides:
            p = p.with_overrides(overrides)
        self.params = p

    # --------------------------------------------------------------- helpers
    def path(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def _done(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    # ---------------------------------------------------------------- passes
    def pass1(self, video: VideoBase, background0=None, resume=True):
        """Segmentation + raw tracking (SURVEY.md §3.2), streamed."""
        out = self.path("pass1_tracks.h5")
        if resume and self._done("pass1_tracks.h5"):
            return TrackCollection.from_rows(
                [tuple(r) for r in read_tracks_hdf5(out)]
            )
        sp = StreamingPipeline(
            self.cfg,
            checkpoint_path=self.path("pass1_state.npz"),
            checkpoint_every=self.params["pipeline.checkpoint_every"],
        )
        rows = sp.run(video, background0=background0, resume=resume)
        write_tracks_hdf5(out, rows)
        return TrackCollection.from_rows(rows)

    def pass2(self, tracks: Optional[TrackCollection] = None):
        """Track stitching / interpolation / smoothing."""
        out = self.path("pass2_tracks.h5")
        if tracks is None:
            tracks = TrackCollection.from_rows(
                [tuple(r) for r in read_tracks_hdf5(self.path("pass1_tracks.h5"))]
            )
        p = self.params
        tracks = tracks.stitch(
            max_gap=p["pass2.max_gap"], max_dist=p["pass2.max_dist"]
        )
        tracks = tracks.filter_short(p["pass2.min_length"])
        if p["pass2.interpolate"]:
            tracks = TrackCollection([t.interpolated() for t in tracks])
        if p.get("pass2.smooth_window", 0):
            tracks = TrackCollection(
                [t.smoothed(p["pass2.smooth_window"]) for t in tracks]
            )
        write_tracks_hdf5(out, tracks.to_rows())
        return tracks

    def pass3(self, tracks: Optional[TrackCollection] = None) -> dict:
        """Statistics report (JSON + CSV)."""
        if tracks is None:
            tracks = TrackCollection.from_rows(
                [tuple(r) for r in read_tracks_hdf5(self.path("pass2_tracks.h5"))]
            )
        summary = tracks.summary()
        report = {
            "n_tracks": len(tracks),
            "total_points": int(sum(len(t) for t in tracks)),
            "tracks": summary,
        }
        with open(self.path("report.json"), "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        write_tracks_csv(self.path("pass2_tracks.csv"), tracks.to_rows())
        return report

    def pass4(self, video: VideoBase, tracks: Optional[TrackCollection] = None):
        """Annotated debug movie (reference L4 observability)."""
        if not self.params["pass4.enabled"]:
            return None
        from tpuva.compose import VideoComposer
        from tpuva.compose.composer import annotate_tracks

        if tracks is None:
            tracks = TrackCollection.from_rows(
                [tuple(r) for r in read_tracks_hdf5(self.path("pass2_tracks.h5"))]
            )
        out = self.path("debug.avi")
        clip = video.to_array()
        annotate_tracks(
            VideoComposer(out, fps=video.fps),
            clip,
            tracks.to_rows(),
            trail=self.params["pass4.trail"],
        )
        return out

    # ------------------------------------------------------------ full drive
    def run(self, video: VideoBase, background0=None, resume=True) -> dict:
        t1 = self.pass1(video, background0=background0, resume=resume)
        t2 = self.pass2(t1)
        report = self.pass3(t2)
        self.pass4(video, t2)
        return report
