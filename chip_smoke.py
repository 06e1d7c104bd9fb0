#!/usr/bin/env python
"""Bring-up check of the tracking pipeline on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: the served path at 1080p
    python chip_smoke.py --four-cards  # four GPUs: multi-stream and spatial

The one-GPU run drives BASELINE config 3's shape (1920x1080, six blobs,
blur 5, open 3 rect, close 3 ellipse, Hungarian tracking, batch 256, 32
component slots) through the entry points a user calls and checks what
comes out:

1. device   -- the default backend is a GPU; prints jax's version, the
               device kind and each card's name and power limit;
2. compile  -- lowers and compiles process_batch at (256, 1080, 1920) and
               prints the compile time and memory_analysis();
3. served   -- StreamingPipeline.warmup + run over a seeded 768-frame
               VideoMemory clip; prints rows, wall time, frames/s and
               peak device memory (information, not a benchmark);
4. correct  -- the GPU rows of the first 64 frames against (a) process_clip
               on the CPU backend in this process (bit-equal), (b) the
               synthetic truth (every judged row within 1 px) and
               (c) refimpl.run_pipeline when cv2 imports (paired by track
               id and frame, within 1 px);
5. stages   -- device times of the XLA front end and of
               connected_components_with_stats at the phase-2 shape.

--four-cards runs only the multi-device paths and what they are compared
with: MultiStreamPipeline over a 4-card ('stream',) mesh against each
stream run alone on one card, and SpatialStreamPipeline over 4 row bands
against the one-card rows.

Any failure exits non-zero and prints no result. On success the last line
is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

import bench
from bench import MAX_COMPONENTS, RADIUS, build_config, nvidia_smi

H, W = 1080, 1920
SERVED_FRAMES = 768  # three batches of 256
CHECK_FRAMES = 64


def make_clip(frames: int, seed: int = 1):
    return bench.make_clip(H, W, frames, seed)


def rows_array(rows) -> np.ndarray:
    return np.asarray(rows, np.float64).reshape(-1, 5)


def compare_rows(got, want) -> str | None:
    """None when the two row sets are bit-equal in the same order, else a
    description of the first difference."""
    a, b = rows_array(got), rows_array(want)
    if a.shape != b.shape:
        return f"row counts differ: {len(a)} vs {len(b)}"
    diff = np.flatnonzero(np.any(a != b, axis=1))
    if diff.size:
        i = int(diff[0])
        return (f"{diff.size} rows differ; first at {i}: "
                f"{a[i].tolist()} vs {b[i].tolist()}")
    return None


TRAIL_COS = -0.8  # a trail row lies behind its blob's last step
TRAIL_SHARE = 0.2  # at most this share of rows may be trails or merges


def truth_error(rows, truth, alive, radius: float) -> dict:
    """Match each row to the nearest live blob of its frame and sort it:

    - judged: within 1 px of the blob;
    - merged: the blob touches another (their disks join into one
      component), so the row is the pair's centroid;
    - trail: the blob is isolated and the row lies behind it along its
      last step (cosine <= TRAIL_COS). A blob that moves slowly leaves a
      trail in the running background: pixels it covered for many frames
      stay above the threshold after it leaves, join its component or
      split off behind it, and pull the centroid back along the path;
    - unexplained: anything else, which fails the check.

    Returns a dict of the counts, the judged rows' max error, the trail
    rows' max error, largest cosine and area range (as a fraction of a
    lone disk: the median area of frame 0, when the background model is
    still the clean plate), and the indices of unexplained rows."""
    a = rows_array(rows)
    disk = float(np.median(a[a[:, 1] == a[0, 1], 4])) if len(a) else 1.0
    out = {"n": len(a), "judged": 0, "err": 0.0, "merged": 0, "trail": 0,
           "trail_err": 0.0, "trail_cos": -1.0, "trail_area": (np.inf, 0.0),
           "unexplained": []}
    for k, r in enumerate(a):
        t = int(r[1])
        blobs = np.flatnonzero(alive[t])
        live = truth[t, blobs]
        d = np.hypot(live[:, 0] - r[2], live[:, 1] - r[3])
        i = int(d.argmin())
        if d[i] <= 1.0:
            out["judged"] += 1
            out["err"] = max(out["err"], float(d[i]))
            continue
        gap = np.hypot(*(live[:, None, :] - live[None, :, :]).T)
        np.fill_diagonal(gap, np.inf)
        if gap[i].min() <= 2 * radius + 8:  # blur + close reach
            out["merged"] += 1
            continue
        t0 = max(t - 1, 0)
        step = truth[t0 + 1, blobs[i]] - truth[t0, blobs[i]]
        e = r[2:4] - live[i]
        cos = float(e @ step / (np.hypot(*e) * np.hypot(*step) + 1e-12))
        if cos <= TRAIL_COS:
            out["trail"] += 1
            out["trail_err"] = max(out["trail_err"], float(d[i]))
            out["trail_cos"] = max(out["trail_cos"], cos)
            lo, hi = out["trail_area"]
            out["trail_area"] = (min(lo, r[4] / disk), max(hi, r[4] / disk))
        else:
            out["unexplained"].append(k)
    return out


def truth_failure(res: dict) -> str | None:
    """None when the truth check passes, else why not."""
    if res["unexplained"]:
        return f"{len(res['unexplained'])} rows match no blob, merge or trail"
    if res["merged"] + res["trail"] > TRAIL_SHARE * res["n"]:
        return (f"{res['merged'] + res['trail']} of {res['n']} rows are "
                f"merges or trails, over {TRAIL_SHARE:.0%}")
    return None


def describe_truth(res: dict) -> str:
    lo, hi = res["trail_area"]
    trail = (f"{res['trail']} trail rows (max error {res['trail_err']:.6f} "
             f"px, cosine to the last step <= {res['trail_cos']:.3f}, area "
             f"{lo:.3f}-{hi:.3f} of a lone disk)" if res["trail"]
             else "0 trail rows")
    return (f"{res['judged']} of {res['n']} rows within 1 px (max error "
            f"{res['err']:.6f} px), {res['merged']} merged, {trail}, "
            f"{len(res['unexplained'])} unexplained")


def mask_difference(got, want) -> str | None:
    """None when two (T, H, W) mask stacks are equal, else the first frame
    that differs and by how many pixels."""
    bad = np.flatnonzero(np.any(got != want, axis=(1, 2)))
    if not bad.size:
        return None
    t = int(bad[0])
    return (f"{bad.size} frames differ; first at frame {t} "
            f"({int((got[t] != want[t]).sum())} pixels)")


def front_end(cfg):
    """The jitted mask stage of process_batch: blur, background,
    threshold, morphology, from (N, H, W) uint8 frames and a float32
    background."""
    import jax
    import jax.numpy as jnp

    from tpuva.graph.pipeline import background_trajectory, filter_batch
    from tpuva.ops import (
        morph_close, morph_open, structuring_element, threshold,
    )

    se_o = structuring_element(cfg.morph_open.shape, cfg.morph_open.ksize)
    se_c = structuring_element(cfg.morph_close.shape, cfg.morph_close.ksize)

    @jax.jit
    def front(frames, bg0):
        f = filter_batch(cfg, frames.astype(jnp.float32))
        bgs = background_trajectory(bg0, f, cfg.background.alpha)
        mask = threshold(jnp.abs(f - bgs), cfg.segment.threshold)
        return morph_close(morph_open(mask, se_o), se_c)

    return front


def timed(fn, *args, reps: int = 5):
    """Median wall seconds of fn(*args) after one warm call, each call
    ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


class Smoke:
    def __init__(self, n_cards: int):
        self.n_cards = n_cards
        self.card = ""

    def phase(self, name: str, fn):
        t0 = time.perf_counter()
        print(f"[{name}] start", flush=True)
        out = fn()
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s "
              f"({self.card})", flush=True)
        return out

    # ---------------------------------------------------------- phase 1
    def device(self):
        import jax

        devs = jax.devices()
        platform = devs[0].platform
        print(f"jax {jax.__version__}, platform {platform}, "
              f"{len(devs)} device(s)", flush=True)
        if platform != "gpu":
            raise SystemExit(f"no GPU: the default devices are {platform!r}")
        if len(devs) < self.n_cards:
            raise SystemExit(
                f"need {self.n_cards} GPUs, jax sees {len(devs)}"
            )
        for d in devs[: self.n_cards]:
            smi = nvidia_smi(d.local_hardware_id)
            print(f"card {d.id}: {d.device_kind} | nvidia-smi: {smi}",
                  flush=True)
        self.card = nvidia_smi(devs[0].local_hardware_id)
        return devs

    # ---------------------------------------------------------- phase 2
    def compile(self, cfg):
        import jax
        import jax.numpy as jnp

        from tpuva.graph.pipeline import init_carry, process_batch

        carry = init_carry(cfg, H, W)
        spec = jax.ShapeDtypeStruct((cfg.batch, H, W), jnp.uint8)
        t0 = time.perf_counter()
        compiled = process_batch.lower(
            cfg, carry, spec, max_components=MAX_COMPONENTS
        ).compile()
        secs = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        print(
            f"process_batch{(cfg.batch, H, W)} compile {secs:.1f} s; "
            f"argument {ma.argument_size_in_bytes} B, "
            f"output {ma.output_size_in_bytes} B, "
            f"temp {ma.temp_size_in_bytes} B",
            flush=True,
        )

    # ---------------------------------------------------------- phase 3
    def served(self, cfg, clip, plate):
        import jax

        from tpuva.graph.streaming import StreamingPipeline
        from tpuva.io import VideoMemory

        sp = StreamingPipeline(cfg, max_components=MAX_COMPONENTS)
        sp.warmup(H, W)
        t0 = time.perf_counter()
        rows = sp.run(VideoMemory(clip), background0=plate)
        wall = time.perf_counter() - t0
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        print(
            f"served {len(clip)} frames -> {len(rows)} rows in "
            f"{wall:.3f} s ({len(clip) / wall:.1f} frames/s, host clock, "
            f"clip in host RAM); peak_bytes_in_use {peak}",
            flush=True,
        )
        if not rows:
            raise RuntimeError("the served path produced no rows")
        return rows

    # ---------------------------------------------------------- phase 4
    def correct(self, cfg, clip, plate, truth, alive, served_rows):
        import jax

        from tpuva.graph.pipeline import process_clip

        K = CHECK_FRAMES
        served = [r for r in served_rows if r[1] < K]
        sub = clip[:K]
        cfg_k = dataclasses.replace(cfg, batch=K)

        def run_clip():
            return process_clip(sub, cfg_k, background0=plate,
                                return_masks=True,
                                max_components=MAX_COMPONENTS)

        gpu_rows, gpu_carry, gpu_masks = run_clip()
        if jax.devices()[0] not in gpu_carry.bg.devices():
            raise RuntimeError("process_clip did not run on the GPU")
        with jax.default_device(jax.devices("cpu")[0]):
            cpu_rows, _, cpu_masks = run_clip()
        ran = []
        for label, a, b in (
            ("(a) process_clip on the GPU vs the served rows", gpu_rows,
             served),
            ("(a) process_clip, GPU vs CPU backend", gpu_rows, cpu_rows),
        ):
            bad = compare_rows(a, b)
            print(f"{label}, {K} frames, {len(a)} rows: "
                  f"{'bit-equal' if bad is None else bad}", flush=True)
            if bad is not None:
                print(mask_difference(gpu_masks, cpu_masks), flush=True)
                raise RuntimeError(f"{label}: rows differ")
        ran.append("gpu-process_clip vs served, cpu-backend")
        bad = mask_difference(gpu_masks, cpu_masks)
        print(f"(a) masks, GPU vs CPU backend: {bad or 'bit-equal'}",
              flush=True)
        if bad:
            raise RuntimeError("GPU masks differ from the CPU backend")

        res = truth_error(served, truth, alive, RADIUS)
        ran.append("truth")
        print(f"(b) truth: {describe_truth(res)}", flush=True)
        why = truth_failure(res)
        if why:
            raise RuntimeError(f"rows disagree with the synthetic truth: {why}")

        try:
            import cv2  # noqa: F401
        except ImportError:
            print("(c) refimpl: skipped, cv2 does not import", flush=True)
        else:
            from refimpl.pipeline import run_pipeline

            ref = run_pipeline(sub, cfg_k, background0=plate).rows
            ran.append("refimpl")
            key = {(int(r[0]), int(r[1])): r for r in ref}
            paired = [(r, key.get((int(r[0]), int(r[1])))) for r in served]
            missing = sum(p is None for _, p in paired)
            if missing or len(ref) != len(served):
                raise RuntimeError(
                    f"refimpl rows do not pair: {len(served)} vs {len(ref)}, "
                    f"{missing} unpaired"
                )
            e = max((max(abs(r[2] - p[2]), abs(r[3] - p[3]))
                     for r, p in paired), default=0.0)
            by_key = lambda rows: sorted(rows, key=lambda r: (r[1], r[0]))
            exact = compare_rows(by_key(served), by_key(ref)) is None
            print(f"(c) refimpl: {len(ref)} rows paired, max centroid "
                  f"error {e:.6f} px, bit-equal {exact}", flush=True)
            print("(c) refimpl against the truth: "
                  f"{describe_truth(truth_error(by_key(ref), truth, alive, RADIUS))}",
                  flush=True)
            if e > 1.0:
                raise RuntimeError("refimpl centroids differ by > 1 px")
        print(f"comparisons run: {', '.join(ran)}", flush=True)

    # ---------------------------------------------------------- phase 5
    def stages(self, cfg, clip, plate):
        import jax
        import jax.numpy as jnp

        from tpuva.graph.pipeline import (
            background_trajectory, filter_batch, init_carry, process_batch,
        )
        from tpuva.ops import connected_components_with_stats
        from tpuva.ops.label import _stats_from_root, label_components

        front = front_end(cfg)
        frames = jax.device_put(clip[: cfg.batch])
        bg0 = jax.device_put(plate.astype(np.float32))
        f32 = jax.jit(lambda x: filter_batch(cfg, x.astype(jnp.float32)))(
            frames)
        mask = front(frames, bg0)
        root = label_components(mask)
        carry = init_carry(cfg, H, W, plate)
        C = MAX_COMPONENTS
        n = cfg.batch
        for name, fn, args in (
            ("front end (blur, background, threshold, morphology)", front,
             (frames, bg0)),
            ("- filter_batch (blur)", jax.jit(
                lambda x: filter_batch(cfg, x.astype(jnp.float32))),
             (frames,)),
            ("- background_trajectory", jax.jit(
                lambda b, f: background_trajectory(b, f,
                                                   cfg.background.alpha)),
             (bg0, f32)),
            ("connected_components_with_stats", jax.jit(
                lambda m: connected_components_with_stats(
                    m, max_components=C, compute_bbox=False,
                    compute_labels=False)),
             (mask,)),
            ("- label_components", label_components, (mask,)),
            ("- _stats_from_root (root table + segment sums)", jax.jit(
                lambda r: _stats_from_root(r, max_components=C,
                                           compute_bbox=False,
                                           compute_labels=False)),
             (root,)),
            ("process_batch", jax.jit(
                lambda c, f: process_batch(cfg, c, f, max_components=C)),
             (carry, frames)),
        ):
            s = timed(fn, *args)
            print(f"stage {name}: {s * 1e3:.3f} ms per {n}-frame batch "
                  f"({n / s:.1f} frames/s, median of 5)", flush=True)

    # ------------------------------------------------------- four cards
    def multistream(self, cfg, devs):
        import jax

        from tpuva.dist.multistream import (
            init_multistream_carry, make_stream_mesh,
        )
        from tpuva.dist.pipeline import MultiStreamPipeline
        from tpuva.graph.streaming import StreamingPipeline
        from tpuva.io import VideoMemory

        S = self.n_cards
        frames = 2 * cfg.batch
        clips = _clips_threaded(frames, seeds=range(1, S + 1))
        videos = [VideoMemory(c[0]) for c in clips]
        plates = np.stack([c[3] for c in clips])
        mesh = make_stream_mesh(S, devs)
        msp = MultiStreamPipeline(cfg, S, mesh=mesh,
                                  max_components=MAX_COMPONENTS)
        t0 = time.perf_counter()
        rows_by_stream, _ = msp.run(videos, background0=plates)
        wall = time.perf_counter() - t0
        print(f"multi-stream: {S} x {frames} frames in {wall:.3f} s, "
              "compilation included", flush=True)
        carry = msp._place_carry(
            init_multistream_carry(cfg, H, W, S, background0=plates)
        )
        batch = msp._assemble([
            jax.device_put(v.data[: cfg.batch], d)
            for v, d in zip(videos, mesh.devices.reshape(-1))
        ])
        _, out = msp._fn(carry, batch)
        for sh in out["rows"].addressable_shards:
            print(f"rows shard {sh.index[0]} on {sh.device}", flush=True)
        for s in range(S):
            single = StreamingPipeline(cfg, max_components=MAX_COMPONENTS)
            want = single.run(videos[s], background0=plates[s])
            bad = compare_rows(rows_by_stream[s], want)
            print(f"stream {s}: {len(want)} rows, "
                  f"{'equal to one card' if bad is None else bad}",
                  flush=True)
            if bad is not None:
                raise RuntimeError(f"stream {s} differs from one card")

    def spatial(self, cfg):
        from tpuva.dist.pipeline import SpatialStreamPipeline
        from tpuva.graph.streaming import StreamingPipeline
        from tpuva.io import VideoMemory

        clip, _, _, plate = make_clip(2 * cfg.batch, seed=11)
        sp = SpatialStreamPipeline(cfg, self.n_cards,
                                   max_components=MAX_COMPONENTS)
        t0 = time.perf_counter()
        got = sp.run(VideoMemory(clip), background0=plate)
        wall = time.perf_counter() - t0
        want = StreamingPipeline(cfg, max_components=MAX_COMPONENTS).run(
            VideoMemory(clip), background0=plate
        )
        bad = compare_rows(got, want)
        print(f"spatial: {self.n_cards} row bands of {H // self.n_cards} at "
              f"{H}x{W}, {len(clip)} frames in {wall:.3f} s (compilation "
              f"included); {len(got)} rows, "
              f"{'equal to one card' if bad is None else bad}", flush=True)
        if bad is not None:
            raise RuntimeError("spatial rows differ from one card")


def _clips_threaded(frames: int, seeds):
    """One seeded clip per stream, generated on threads (numpy's
    generators release the interpreter lock for bulk draws)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(make_clip, frames, s) for s in seeds]
        return [f.result() for f in futs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths on four GPUs")
    args = ap.parse_args(argv)
    try:
        import jax

        from tpuva.utils import enable_compilation_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the pipeline: {e}",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    smoke = Smoke(n_cards)
    try:
        devs = smoke.phase("1 device", smoke.device)
    except SystemExit as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    cfg = build_config()
    if args.four_cards:
        smoke.phase("config 5 multi-stream",
                    lambda: smoke.multistream(cfg, devs))
        smoke.phase("spatial row bands", lambda: smoke.spatial(cfg))
    else:
        smoke.phase("2 compile", lambda: smoke.compile(cfg))
        clip, alive, truth, plate = smoke.phase(
            "clip", lambda: make_clip(SERVED_FRAMES)
        )
        rows = smoke.phase("3 served",
                           lambda: smoke.served(cfg, clip, plate))
        smoke.phase("4 correct", lambda: smoke.correct(
            cfg, clip, plate, truth, alive, rows))
        smoke.phase("5 stages", lambda: smoke.stages(cfg, clip, plate))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": n_cards,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
