#!/usr/bin/env python
"""Config-5 example: track S concurrent camera streams in lock-step on a
('stream',) device mesh, with per-stream state and merged export.

    python examples/multistream.py out_dir/                   # 4 demo streams
    python examples/multistream.py out_dir/ --streams 8
    python examples/multistream.py out_dir/ cam0.mp4 cam1.mp4 ...

With >= S visible devices each stream's pipeline (background model,
segmentation, tracker) lives on its own device and batches stage directly
to it; with one device the same driver runs the tested-equivalent vmap
processor on it (between the two it refuses rather than leave devices
idle). To try the mesh path without accelerators:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/multistream.py out_dir/ --streams 8

(SURVEY.md section 2.3-K / BASELINE.json config 5.)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("videos", nargs="*", help="one video per stream")
    ap.add_argument("--streams", type=int, default=4,
                    help="demo stream count when no videos are given")
    ap.add_argument("--frames", type=int, default=96,
                    help="demo clip length")
    ap.add_argument("--threshold", type=float, default=40.0)
    ap.add_argument("--alpha", type=float, default=0.02)
    args = ap.parse_args()

    from tpuva.dist.pipeline import MultiStreamPipeline
    from tpuva.graph.config import (
        BackgroundConfig,
        BlurConfig,
        MorphConfig,
        PipelineConfig,
        SegmentConfig,
        TrackConfig,
    )
    from tpuva.io import VideoMemory, load_any_video

    if args.videos:
        # gray=True: the pipeline consumes (N, H, W); color files read
        # back as (N, H, W, 3) and would fail the (S, N, H, W) assembly
        videos = [load_any_video(v, gray=True) for v in args.videos]
    else:
        from refimpl.synthetic import multi_blob_clip

        videos = []
        for s in range(args.streams):
            clip = multi_blob_clip(
                h=240, w=320, frames=args.frames, n_blobs=3, seed=100 + s
            )[0]
            videos.append(VideoMemory(clip))

    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=args.alpha),
        blur=BlurConfig(ksize=5),
        morph_open=MorphConfig(ksize=3),
        segment=SegmentConfig(threshold=args.threshold, min_area=20,
                              max_blobs=8),
        track=TrackConfig(max_dist=60.0, death_patience=5,
                          assigner="hungarian"),
        batch=32,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    pipe = MultiStreamPipeline(
        cfg,
        n_streams=len(videos),
        checkpoint_path=os.path.join(args.out_dir, "state.npz"),
    )
    rows_by_stream, merged = pipe.run(videos, export_dir=args.out_dir)

    report = {
        "streams": len(videos),
        "mesh": pipe.mesh is not None,
        "rows_per_stream": [len(r) for r in rows_by_stream],
        "merged_rows": len(merged),
        "out_dir": args.out_dir,
    }
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
