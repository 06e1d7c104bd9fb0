#!/usr/bin/env python
"""Host-decode throughput probe (SURVEY §7.3: "cv2's bundled libav may
itself bottleneck at 1080p; consider a decode worker pool").

Writes a synthetic 1080p MJPG clip, then measures frames/sec for:
  - sequential VideoFile decode (the single-threaded baseline),
  - ParallelVideoReader at 1/2/4 workers (seek-sharded pool).

cv2's decode releases the GIL, so pool scaling tracks HOST CORES: on a
one-core host the pool result quantifies the pool's *overhead*, and the
output reports cores-available so the numbers say what was measurable.
A host with many cores runs N workers at up to ~N x the baseline until
the container's demuxer serializes.

Prints one JSON line; safe to re-run (work dir under the temp dir).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def write_clip(path: str, frames: int, h: int, w: int) -> None:
    from tpuva.io.file import VideoFileWriter

    rng = np.random.default_rng(0)
    plate = rng.integers(30, 90, (h, w), np.uint8)
    with VideoFileWriter(path, fps=25.0) as wr:
        for t in range(frames):
            f = plate.copy()
            y = 100 + 3 * t
            x = 200 + 5 * t
            f[y : y + 40, x : x + 40] = 200
            wr.write_frame(f)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "tpuva_decode"))
    args = ap.parse_args()

    from tpuva.io.file import VideoFile
    from tpuva.io.parallel_decode import ParallelVideoReader

    os.makedirs(args.workdir, exist_ok=True)
    path = os.path.join(args.workdir, "probe.avi")
    if not os.path.exists(path):
        write_clip(path, args.frames, args.height, args.width)

    def consume(video) -> float:
        t0 = time.perf_counter()
        n = 0
        for _n, _stack in video.iter_batches(32, pad_last=False):
            n += _n
        dt = time.perf_counter() - t0
        video.close()
        return n / dt

    seq_fps = consume(VideoFile(path, gray=True))
    pool = {}
    for workers in (1, 2, 4):
        fps = consume(
            ParallelVideoReader(path, workers=workers, chunk=32, gray=True)
        )
        pool[str(workers)] = round(fps, 1)

    result = {
        "metric": "host decode fps @%dx%d MJPG" % (args.height, args.width),
        "sequential_fps": round(seq_fps, 1),
        "pool_fps_by_workers": pool,
        "host_cores": os.cpu_count(),
        "note": (
            "decode releases the GIL; pool scaling tracks host cores "
            "(1 on this dev box - pool numbers here measure overhead, "
            "not headroom)"
        ),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
