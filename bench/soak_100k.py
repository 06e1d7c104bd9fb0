#!/usr/bin/env python
"""Config-4 scale proof (BASELINE.json:10): a 100k+ frame 1080p streamed
run with rolling background model, HDF5 output, checkpoint/kill/resume,
bounded host memory, and a float64 background-drift oracle.

Frames are generated ON DEVICE by a deterministic integer-math renderer,
so the soak measures the pipeline, not host decode and host->device
copies (StreamingPipeline's BatchStager feeds the same step from host
frames). The SAME renderer is evaluated in NumPy for the drift oracle, so
the float32 on-device background recurrence is compared against an exact
float64 recurrence over the full 100k updates on an interior crop.

Outputs one JSON line + writes soak artifacts (HDF5, checkpoint, the
JSON result) into --workdir.

Checks:
  1. bounded memory: current RSS sampled every 256 batches; the second
     half of the run must not grow more than --rss-slack MB.
  2. kill+resume: the run is aborted mid-stream (exception after half the
     batches), resumed from the periodic checkpoint, and the final HDF5
     must be BYTE-identical to the uninterrupted run's.
  3. background drift: max |f32_bg - f64_bg| over a 64x64 interior crop
     after all updates (quantifies BASELINE's rolling-model stability).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


# ----------------------------------------------------------- deterministic
# integer-math scene: plate texture + bouncing disks. Identical in jax and
# numpy (int32 ops only), so the host oracle sees the exact same frames.
N_BLOBS = 6
AMP = 120
RADIUS = 16


def _blob_params(H, W, i):
    x0 = 37 + 211 * i
    y0 = 53 + 173 * i
    vx = 2 + (i % 3)
    vy = 1 + (i % 4)
    return x0, y0, vx, vy


def _tri(v, M):
    """Triangle wave of period 2M on integer v (numpy or jax)."""
    m = v % (2 * M)
    return np.minimum(m, 2 * M - m) if isinstance(v, np.ndarray) else None


def render_frames_np(H, W, t0, n, region=None):
    """(n, h, w) uint8, frames t0..t0+n-1 — the host-side oracle twin.

    region=(ys, xs, h, w) renders only that window (blob positions are
    global, the per-pixel math restricts to the window) — the drift
    oracle would otherwise rasterize 100k full 1080p frames in NumPy."""
    ys, xs, h, w = region if region else (0, 0, H, W)
    y = (np.arange(h, dtype=np.int64) + ys)[None, :, None]
    x = (np.arange(w, dtype=np.int64) + xs)[None, None, :]
    plate = ((x * 7 + y * 13) % 23 + 40).astype(np.int64)
    t = np.arange(t0, t0 + n, dtype=np.int64)[:, None, None]
    acc = np.broadcast_to(plate, (n, h, w)).copy()
    Mx, My = W - 2 * RADIUS, H - 2 * RADIUS
    for i in range(N_BLOBS):
        x0, y0, vx, vy = _blob_params(H, W, i)
        mx = (x0 + vx * t) % (2 * Mx)
        cx = np.minimum(mx, 2 * Mx - mx) + RADIUS
        my = (y0 + vy * t) % (2 * My)
        cy = np.minimum(my, 2 * My - my) + RADIUS
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        acc = np.where(d2 <= RADIUS * RADIUS, plate + AMP, acc)
    return np.clip(acc, 0, 255).astype(np.uint8)


def make_render_jax(H, W, n):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def render(t0):
        y = jnp.arange(H, dtype=jnp.int32)[None, :, None]
        x = jnp.arange(W, dtype=jnp.int32)[None, None, :]
        plate = ((x * 7 + y * 13) % 23 + 40)
        t = (t0 + jnp.arange(n, dtype=jnp.int32))[:, None, None]
        acc = jnp.broadcast_to(plate, (n, H, W))
        Mx, My = W - 2 * RADIUS, H - 2 * RADIUS
        for i in range(N_BLOBS):
            x0, y0, vx, vy = _blob_params(H, W, i)
            mx = (x0 + vx * t) % (2 * Mx)
            cx = jnp.minimum(mx, 2 * Mx - mx) + RADIUS
            my = (y0 + vy * t) % (2 * My)
            cy = jnp.minimum(my, 2 * My - my) + RADIUS
            d2 = (x - cx) ** 2 + (y - cy) ** 2
            acc = jnp.where(d2 <= RADIUS * RADIUS, plate + AMP, acc)
        return jnp.clip(acc, 0, 255).astype(jnp.uint8)

    return render


def rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def build_cfg(batch):
    from tpuva.graph.config import (
        BackgroundConfig, BlurConfig, MorphConfig, PipelineConfig,
        SegmentConfig, TrackConfig,
    )

    return PipelineConfig(
        background=BackgroundConfig(alpha=0.02),
        blur=BlurConfig(ksize=5, sigma=0.0),
        morph_open=MorphConfig(ksize=3, shape="rect"),
        segment=SegmentConfig(threshold=60.0, min_area=50, max_blobs=8),
        track=TrackConfig(max_dist=80.0, death_patience=5, max_tracks=16,
                          assigner="hungarian"),
        batch=batch,
    )


class Abort(Exception):
    pass


def run_soak(cfg, H, W, total_frames, ckpt_path, rowlog_path,
             abort_at_batch=None, resume=False, ckpt_every=256,
             rss_samples=None, timings=None):
    """Device-fed streamed run with periodic append-only checkpoints
    (RowLog + O(carry) snapshots). Returns (rowlog, carry).

    Row collection rides an AsyncRowDrainer (one packed transfer per
    group, fetched off-thread), so the dispatch loop only ever blocks on
    drainer backpressure and on checkpoint flushes.

    timings (dict) records host time blocked in checkpoint flushes and
    snapshot writes; the renderer/device-step split is calibrated
    post-run (calibrate_stage_split)."""
    import jax
    import jax.numpy as jnp

    from tpuva.graph.pipeline import collect_rows_array, init_carry
    from tpuva.graph.pipeline import process_batch
    from tpuva.graph.streaming import AsyncRowDrainer, RowLog, \
        load_checkpoint, save_checkpoint

    N = cfg.batch
    render = make_render_jax(H, W, N)
    carry = init_carry(cfg, H, W)
    rlog = RowLog(rowlog_path)
    start = 0
    if resume and os.path.exists(ckpt_path):
        carry, saved = load_checkpoint(ckpt_path, cfg)
        rlog.truncate(int(saved))
        start = int(carry.frame_idx)
    else:
        rlog.truncate(0)

    batches = (total_frames - start) // N
    tm = timings if timings is not None else {}
    tm.setdefault("flush_s", 0.0)
    tm.setdefault("ckpt_s", 0.0)
    tm.setdefault("active_tracks", 0)

    def consume(rec, n):
        ov = rec.get("stats_overflow")
        assert ov is None or int(ov.max()) == 0, "stats overflow in soak"
        rlog.append(collect_rows_array(
            rec["rows"], rec["row_valid"], row_sums=rec["row_sums"],
        ))

    # ~2048 frames (not batches) per drain group, as StreamingPipeline:
    # few fetch round trips, and the 1-group-in-flight bound still caps
    # the dispatch queue before the allocator thrashes
    drainer = AsyncRowDrainer(
        consume, group=max(2, 2048 // N), max_groups_in_flight=1,
    )
    tm.setdefault("dispatch_s", 0.0)
    try:
        for b in range(batches):
            td = time.perf_counter()
            t0 = start + b * N
            frames = render(jnp.int32(t0))
            carry, out = process_batch(cfg, carry, frames)
            dd = time.perf_counter() - td
            tm["dispatch_s"] += dd
            if b == 0:
                tm["first_batch_dispatch_s"] = round(dd, 2)
            drainer.submit(out)
            done = b + 1
            if done % ckpt_every == 0:
                tf = time.perf_counter()
                drainer.flush()
                tm["flush_s"] += time.perf_counter() - tf
                tc = time.perf_counter()
                jax.block_until_ready(carry.bg)
                rlog.flush()
                save_checkpoint(ckpt_path, carry, rlog.count(), cfg)
                tm["ckpt_s"] += time.perf_counter() - tc
                if rss_samples is not None:
                    rss_samples.append((t0 + N, rss_mb()))
            if abort_at_batch is not None and done >= abort_at_batch:
                raise Abort()
        drainer.close()
    except BaseException:
        drainer.kill()  # a real kill takes the thread down with the
        raise           # process; don't let it race the resumed run
    finally:
        tm["active_tracks"] = drainer.active_tracks
        tm["drainer"] = {k: round(v, 2) if isinstance(v, float) else v
                         for k, v in drainer.stats.items()}
    return rlog, carry


def warmup(cfg, H, W):
    """Compile/load every device program used by the soak loop and sync.

    Program trace + compile-cache load is one-time cost, not streaming
    throughput, so the timed region must start warm. Uses a throwaway
    carry; the real run's numerics are untouched."""
    import jax
    import jax.numpy as jnp

    from tpuva.graph.pipeline import init_carry, process_batch

    N = cfg.batch
    render = make_render_jax(H, W, N)
    carry = init_carry(cfg, H, W)
    f = render(jnp.int32(0))
    carry, out = process_batch(cfg, carry, f)
    jax.block_until_ready(out["rows"])


def centroid_oracle_err(flat_rows, H, W, sample=4096, seed=0):
    """Median distance from sampled trajectory rows to the NEAREST
    analytic blob center at that frame. The renderer's centers are exact
    integer math, and a rasterized disk's centroid sits within ~0.5 px of
    its center, so a healthy run medians well under 1 px. Guards the whole
    row path end-to-end (stats sums -> packed drain -> RowLog -> HDF5):
    a transport bug that zeroes or misaligns centroids (e.g. int32 sums
    bitcast to f32 and flushed as denormals) blows this up to O(image
    size). Median, not max: transient blob overlaps merge
    components whose joint centroid is legitimately far from either
    center."""
    flat = np.asarray(flat_rows, np.float64).reshape(-1, 5)
    if not len(flat):
        return float("nan")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(flat), size=min(sample, len(flat)), replace=False)
    t = flat[pick, 1].astype(np.int64)[:, None]  # frame
    xy = flat[pick, 2:4]
    Mx, My = W - 2 * RADIUS, H - 2 * RADIUS
    cx = np.empty((len(pick), N_BLOBS)); cy = np.empty_like(cx)
    for i in range(N_BLOBS):
        x0, y0, vx, vy = _blob_params(H, W, i)
        mx = (x0 + vx * t[:, 0]) % (2 * Mx)
        cx[:, i] = np.minimum(mx, 2 * Mx - mx) + RADIUS
        my = (y0 + vy * t[:, 0]) % (2 * My)
        cy[:, i] = np.minimum(my, 2 * My - my) + RADIUS
    d = np.sqrt((xy[:, 0:1] - cx) ** 2 + (xy[:, 1:2] - cy) ** 2).min(axis=1)
    return float(np.median(d))


def calibrate_stage_split(cfg, H, W, iters=8):
    """Sync'd medians of the renderer and the device pipeline step, run
    AFTER a soak (programs compiled). In-loop sampling is unsound — any
    sync inside the pipelined loop flushes the whole async backlog and
    measures queue drainage, not the batch's cost."""
    import jax
    import jax.numpy as jnp

    from tpuva.graph.pipeline import init_carry, process_batch

    N = cfg.batch
    render = make_render_jax(H, W, N)
    carry = init_carry(cfg, H, W)
    sync = jax.block_until_ready

    frames = render(jnp.int32(0))
    sync(frames)
    rts, sts = [], []
    for i in range(iters):
        t0 = time.perf_counter()
        f = render(jnp.int32(i * N))
        sync(f)
        rts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        carry, out = process_batch(cfg, carry, f)
        sync(out["rows"])
        sts.append(time.perf_counter() - t0)
    med = lambda v: float(np.median(v))
    return {
        "render_ms_per_batch": round(med(rts) * 1e3, 1),
        "device_step_ms_per_batch": round(med(sts) * 1e3, 1),
        "note": "sync'd medians; the streamed loop overlaps both",
    }


def main():
    from tpuva.utils import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100_352)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    # 256 matches bench.py's device-pipeline batch
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "tpuva_soak"))
    ap.add_argument("--rss-slack", type=float, default=512.0,
                    help="max allowed RSS growth (MB) over the 2nd half")
    args = ap.parse_args()

    from tpuva.export.hdf5io import write_tracks_hdf5

    os.makedirs(args.workdir, exist_ok=True)
    cfg = build_cfg(args.batch)
    H, W = args.height, args.width
    T = (args.frames // args.batch) * args.batch

    # ---------------- run A: uninterrupted
    ckpt_a = os.path.join(args.workdir, "a.npz")
    rlog_a = os.path.join(args.workdir, "a.rows")
    for p in (ckpt_a, rlog_a):
        if os.path.exists(p):
            os.unlink(p)
    rss = []
    tm: dict = {}
    tw = time.perf_counter()
    warmup(cfg, H, W)
    warm_s = time.perf_counter() - tw
    t0 = time.perf_counter()
    log_a, carry_a = run_soak(cfg, H, W, T, ckpt_a, rlog_a,
                              rss_samples=rss, timings=tm)
    dt = time.perf_counter() - t0
    fps = T / dt
    flat_a = log_a.read()
    h5_a = os.path.join(args.workdir, "a.h5")
    write_tracks_hdf5(h5_a, [tuple(r) for r in flat_a])

    # bounded RSS: second-half growth
    half = len(rss) // 2
    rss_growth = rss[-1][1] - rss[half][1] if len(rss) >= 2 else 0.0
    assert rss_growth < args.rss_slack, (rss_growth, rss)

    # ---------------- run B: kill at half, resume, finish
    ckpt_b = os.path.join(args.workdir, "b.npz")
    rlog_b = os.path.join(args.workdir, "b.rows")
    for p in (ckpt_b, rlog_b):
        if os.path.exists(p):
            os.unlink(p)
    nbatches = T // args.batch
    try:
        run_soak(cfg, H, W, T, ckpt_b, rlog_b,
                 abort_at_batch=nbatches // 2, ckpt_every=64)
    except Abort:
        pass
    log_b, carry_b = run_soak(cfg, H, W, T, ckpt_b, rlog_b, resume=True,
                              ckpt_every=64)
    flat_b = log_b.read()
    h5_b = os.path.join(args.workdir, "b.h5")
    write_tracks_hdf5(h5_b, [tuple(r) for r in flat_b])
    with open(h5_a, "rb") as fa, open(h5_b, "rb") as fb:
        identical = fa.read() == fb.read()
    assert identical, "resumed HDF5 differs from uninterrupted run"

    # ---------------- float64 background-drift oracle on an interior crop
    import cv2

    y0, x0, CS, M = H // 3, W // 3, 64, 4  # crop + blur margin
    bg64 = None
    ksz = (cfg.blur.ksize, cfg.blur.ksize)
    a = np.float64(cfg.background.alpha)
    CHUNK = 512
    for t in range(0, T, CHUNK):
        crop = render_frames_np(
            H, W, t, min(CHUNK, T - t),
            region=(y0 - M, x0 - M, CS + 2 * M, CS + 2 * M),
        )
        for i in range(crop.shape[0]):
            # cv2's u8 fixed-point blur: the SAME quantized frames the
            # device recurrence sees (ops.gaussian_blur_u8 is bit-exact
            # to it), so this measures pure f32-vs-f64 accumulation drift
            blurred = cv2.GaussianBlur(crop[i], ksz, cfg.blur.sigma)[
                M:-M, M:-M
            ].astype(np.float64)
            if bg64 is None:
                bg64 = blurred.copy()
            else:
                bg64 = (1.0 - a) * bg64 + a * blurred
    bg32 = np.asarray(carry_a.bg)[y0:y0 + CS, x0:x0 + CS].astype(np.float64)
    drift = float(np.abs(bg32 - bg64).max())

    cent_err = centroid_oracle_err(flat_a, H, W)
    assert cent_err < 1.0, f"centroid oracle median {cent_err} px"

    split = calibrate_stage_split(cfg, H, W)
    split["ckpt_flush_s_total"] = round(tm.get("flush_s", 0.0), 1)
    split["ckpt_s_total"] = round(tm.get("ckpt_s", 0.0), 1)
    split["dispatch_s_total"] = round(tm.get("dispatch_s", 0.0), 1)
    split["compile_warm_s"] = round(warm_s, 1)
    split["drainer"] = tm.get("drainer", {})
    result = {
        "metric": "config-4 soak",
        "frames": T,
        "resolution": f"{H}x{W}",
        "batch": args.batch,
        "fps": round(fps, 1),
        "rows": int(len(flat_a)),
        "rss_mb_final": round(rss[-1][1], 1) if rss else None,
        "rss_growth_2nd_half_mb": round(rss_growth, 1),
        "resume_hdf5_byte_identical": bool(identical),
        "centroid_oracle_median_err_px": round(cent_err, 4),
        "bg_drift_f32_vs_f64_max_abs": drift,
        "active_tracks_final": int(tm.get("active_tracks", 0)),
        "stage_split": split,
    }
    print(json.dumps(result))
    with open(os.path.join(args.workdir, "soak.json"), "w") as fh:
        json.dump(result, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
