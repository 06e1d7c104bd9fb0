"""Installed command-line entry point (SURVEY.md §1.1 L5: the layer
"above: user/CLI"). Mirrors the reference workflow — open video -> filter
chain -> multi-pass tracking -> HDF5/CSV/report/debug movie — with the
compute on JAX's default device.

Usage (installed script `tpuva` or `python -m tpuva`):

    tpuva input.mp4 out_dir/
    tpuva --demo out_dir/          # synthetic demo clip
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpuva",
        description="Batched video analysis: segment + track + export",
    )
    ap.add_argument("video", nargs="?", help="video file / glob / image dir")
    ap.add_argument("out_dir")
    ap.add_argument("--demo", action="store_true", help="use a synthetic clip")
    ap.add_argument("--threshold", type=float, default=30.0)
    ap.add_argument("--min-area", type=int, default=50)
    ap.add_argument("--alpha", type=float, default=0.02)
    ap.add_argument("--movie", action="store_true",
                    help="write an annotated debug movie")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # imports deferred: `tpuva --help` must not initialize a JAX backend
    from tpuva.app import TrackingProject
    from tpuva.graph.config import (
        BackgroundConfig,
        BlurConfig,
        MorphConfig,
        PipelineConfig,
        SegmentConfig,
        TrackConfig,
    )
    from tpuva.io import VideoMemory, load_any_video

    if args.demo:
        from refimpl.synthetic import multi_blob_clip

        clip, _, _, _ = multi_blob_clip(
            h=480, w=640, frames=200, n_blobs=4, radius=12
        )
        video = VideoMemory(clip, fps=25.0)
    elif args.video:
        video = load_any_video(args.video, gray=True)
    else:
        build_parser().error("give a video path or --demo")

    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=args.alpha),
        blur=BlurConfig(ksize=5),
        morph_open=MorphConfig(ksize=3),
        segment=SegmentConfig(
            threshold=args.threshold, min_area=args.min_area, max_blobs=8
        ),
        track=TrackConfig(max_dist=80.0, death_patience=5,
                          assigner="hungarian"),
        batch=32,
    )
    proj = TrackingProject(
        args.out_dir,
        cfg,
        overrides={
            "pass4": {"enabled": args.movie},
        },
    )
    report = proj.run(video)
    print(json.dumps(
        {"n_tracks": report["n_tracks"],
         "total_points": report["total_points"],
         "out_dir": args.out_dir},
        indent=2,
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
