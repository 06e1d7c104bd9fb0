#!/usr/bin/env python
"""Full-pipeline throughput of BASELINE config 3 on one GPU (a single
cell until the benchmark grows its workloads).

Times `process_batch` — blur -> rolling background -> threshold ->
morphology -> CCL + stats -> Hungarian tracking — over a seeded 1080p
clip with six blobs, batch 256, with compilation outside the timed window
and every pass ending in `block_until_ready`. The rows of the timed run
itself are compared with the `refimpl` NumPy/OpenCV oracle on its first
frames, which also gives the CPU baseline.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": frames_per_s, "unit": "frames/sec/device",
   "device": {...}, "max_centroid_err_px": ..., "rows_match_reference": ...}

Exits non-zero without a GPU: this is a measurement of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time


def build_config():
    from tpuva.graph.config import (
        BackgroundConfig,
        BlurConfig,
        MorphConfig,
        PipelineConfig,
        SegmentConfig,
        TrackConfig,
    )

    return PipelineConfig(
        background=BackgroundConfig(alpha=0.02),
        blur=BlurConfig(ksize=5, sigma=0.0),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        morph_close=MorphConfig(ksize=3, shape="ellipse"),
        segment=SegmentConfig(threshold=35.0, min_area=50, max_blobs=8),
        # exact Hungarian association (BASELINE.json:9)
        track=TrackConfig(
            max_dist=80.0, death_patience=5, max_tracks=16,
            assigner="hungarian",
        ),
        batch=256,
    )


# 4x headroom over the scene's ~7 components
MAX_COMPONENTS = 32
N_BLOBS, RADIUS, NOISE = 6, 16.0, 2.0


def make_clip(h: int, w: int, frames: int, seed: int = 1):
    """(clip, alive, truth, plate) of the bench scene, from a seed."""
    from refimpl.synthetic import multi_blob_clip

    return multi_blob_clip(
        h=h, w=w, frames=frames, n_blobs=N_BLOBS, radius=RADIUS,
        births_deaths=False, noise_sigma=NOISE, seed=seed,
    )


def nvidia_smi(index: int) -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bench_device(clip, plate, cfg, passes: int = 3):
    """Best-of-passes frames/s of process_batch over the whole clip, each
    pass from a fresh carry; returns (fps, rows of the last pass)."""
    import jax

    from tpuva.graph.pipeline import collect_rows, init_carry, process_batch

    T, H, W = clip.shape
    N = cfg.batch
    batches = [jax.device_put(clip[i : i + N]) for i in range(0, T, N)]

    def one_pass():
        carry = init_carry(cfg, H, W, plate)
        outs = []
        for b in batches:
            carry, out = process_batch(
                cfg, carry, b, max_components=MAX_COMPONENTS
            )
            outs.append(out)
        jax.block_until_ready(outs)
        return outs

    one_pass()  # compile + warm
    best, outs = 0.0, None
    for _ in range(passes):
        t0 = time.perf_counter()
        outs = one_pass()
        best = max(best, T / (time.perf_counter() - t0))
    rows = []
    for out in outs:
        rows.extend(collect_rows(
            out["rows"], out["row_valid"], row_sums=out["row_sums"]
        ))
    return best, rows


def accuracy_vs_reference(rows, clip, plate, cfg, frames: int):
    """Max centroid error (px; contract <= 1, BASELINE.json:5) and whether
    every row of the first `frames` frames pairs up by (track id, frame)
    with the refimpl oracle's; also the oracle's frames/s."""
    from refimpl.pipeline import run_pipeline

    sub = clip[:frames]
    t0 = time.perf_counter()
    ref = run_pipeline(sub, dataclasses.replace(cfg, batch=frames),
                       background0=plate)
    fps_cpu = frames / (time.perf_counter() - t0)
    key = lambda r: (int(r[1]), int(r[0]))
    got = sorted((r for r in rows if r[1] < frames), key=key)
    want = sorted(ref.rows, key=key)
    if len(got) != len(want):
        return float("inf"), False, fps_cpu
    match = all(key(r) == key(g) for r, g in zip(want, got))
    err = max((max(abs(r[2] - g[2]), abs(r[3] - g[3]))
               for r, g in zip(want, got)), default=0.0)
    return err, match, fps_cpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="3 batches instead of 4")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--check-frames", type=int, default=48)
    args = ap.parse_args()

    import jax

    from tpuva.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (found {dev.platform})", file=sys.stderr)
        return 2
    card = nvidia_smi(dev.local_hardware_id)
    print(f"card: {card}", flush=True)
    enable_compilation_cache()

    cfg = build_config()
    frames = cfg.batch * (3 if args.quick else 4)
    clip, _, _, plate = make_clip(args.height, args.width, frames)
    fps, rows = bench_device(clip, plate, cfg)
    err, match, fps_cpu = accuracy_vs_reference(
        rows, clip, plate, cfg, args.check_frames
    )
    print(json.dumps({
        "metric": f"full-pipeline throughput @{args.height}p",
        "value": round(fps, 2),
        "unit": "frames/sec/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "vs_baseline": round(fps / fps_cpu, 2),
        "baseline_cpu_fps": round(fps_cpu, 2),
        "max_centroid_err_px": round(err, 6),
        "rows_match_reference": bool(match),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
