"""Config 4 shape (BASELINE.json:10): streamed processing with rolling
background, checkpoint/resume at batch granularity, decode-error
tolerance, and HDF5 output equality."""

import numpy as np
import pytest

from refimpl.synthetic import moving_disk_clip
from tpuva.export import write_tracks_hdf5
from tpuva.graph.config import (
    BackgroundConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)
from tpuva.graph.pipeline import process_clip
from tpuva.graph.streaming import (
    StreamingPipeline,
    load_checkpoint,
    save_checkpoint,
)
from tpuva.io import RobustVideo, VideoMemory

CFG = PipelineConfig(
    background=BackgroundConfig(alpha=0.03),
    segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
    track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    batch=8,
)


def clip_and_plate(frames=64):
    clip, _, plate = moving_disk_clip(h=96, w=128, frames=frames, radius=8,
                                      seed=11)
    return clip, plate


def rows_equal(a, b):
    fa = [(int(r[0]), int(r[1]), round(r[2], 3), round(r[3], 3), int(r[4]))
          for r in a]
    fb = [(int(r[0]), int(r[1]), round(r[2], 3), round(r[3], 3), int(r[4]))
          for r in b]
    return sorted(fa) == sorted(fb)


def test_streaming_matches_process_clip():
    clip, plate = clip_and_plate()
    ref_rows, _, _ = process_clip(clip, CFG, background0=plate)
    sp = StreamingPipeline(CFG, parallel_bg=False)
    rows = sp.run(VideoMemory(clip), background0=plate)
    assert rows_equal(rows, ref_rows)


def test_checkpoint_resume_equivalence(tmp_path):
    """Interrupt mid-stream; resume must produce the identical trajectory
    set as one uninterrupted run."""
    clip, plate = clip_and_plate(frames=64)
    ckpt = str(tmp_path / "state.npz")

    full = StreamingPipeline(CFG, parallel_bg=False).run(
        VideoMemory(clip), background0=plate
    )

    # phase 1: process only the first half (as if the job died after it)
    sp = StreamingPipeline(
        CFG, checkpoint_path=ckpt, checkpoint_every=10**9, parallel_bg=False
    )
    sp.run(VideoMemory(clip[:32]), background0=plate)
    carry, rows_half = load_checkpoint(ckpt, CFG)
    assert int(carry.frame_idx) == 32

    # phase 2: resume against the full video
    sp2 = StreamingPipeline(
        CFG, checkpoint_path=ckpt, checkpoint_every=10**9, parallel_bg=False
    )
    rows = sp2.run(VideoMemory(clip), background0=plate, resume=True)
    assert rows_equal(rows, full)


def test_row_log_mode_resume_equivalence(tmp_path):
    """Append-only RowLog mode: checkpoints store only the row count,
    rows stream to disk, resume truncates the log — final rows identical
    to the in-RAM run AND to an interrupted+resumed run."""
    clip, plate = clip_and_plate(frames=64)
    full = StreamingPipeline(CFG, parallel_bg=False).run(
        VideoMemory(clip), background0=plate
    )

    ckpt = str(tmp_path / "state.npz")
    rlogp = str(tmp_path / "rows.bin")
    sp = StreamingPipeline(
        CFG, checkpoint_path=ckpt, checkpoint_every=2, parallel_bg=False,
        row_log_path=rlogp,
    )
    arr = sp.run(VideoMemory(clip), background0=plate)
    assert isinstance(arr, np.ndarray) and arr.shape[1] == 5
    assert rows_equal([tuple(r) for r in arr], full)

    # interrupted run: first half only, then resume over the full clip
    # (the log holds rows past the last checkpoint; resume must truncate)
    ckpt2 = str(tmp_path / "state2.npz")
    rlogp2 = str(tmp_path / "rows2.bin")
    sp1 = StreamingPipeline(
        CFG, checkpoint_path=ckpt2, checkpoint_every=3, parallel_bg=False,
        row_log_path=rlogp2,
    )
    sp1.run(VideoMemory(clip[:32]), background0=plate)
    sp2 = StreamingPipeline(
        CFG, checkpoint_path=ckpt2, checkpoint_every=3, parallel_bg=False,
        row_log_path=rlogp2,
    )
    arr2 = sp2.run(VideoMemory(clip), background0=plate, resume=True)
    assert rows_equal([tuple(r) for r in arr2], full)


def test_checkpoint_config_mismatch_rejected(tmp_path):
    clip, plate = clip_and_plate(frames=16)
    ckpt = str(tmp_path / "state.npz")
    sp = StreamingPipeline(CFG, checkpoint_path=ckpt, parallel_bg=False)
    sp.run(VideoMemory(clip), background0=plate)
    import dataclasses

    other = dataclasses.replace(
        CFG, segment=SegmentConfig(threshold=50.0, min_area=20, max_blobs=4)
    )
    with pytest.raises(ValueError):
        load_checkpoint(ckpt, other)


def test_robust_video_repeats_on_decode_error():
    clip, plate = clip_and_plate(frames=16)

    class Flaky(VideoMemory):
        def get_frame(self, index):
            if index == 5:
                raise IOError("synthetic decode error")
            return super().get_frame(index)

    v = RobustVideo(Flaky(clip))
    frames = v.to_array()
    assert len(v.errors) == 1 and v.errors[0][0] == 5
    np.testing.assert_array_equal(frames[5], clip[4])  # repeated last good
    np.testing.assert_array_equal(frames[6], clip[6])


def test_hdf5_output_matches_refimpl(tmp_path):
    from refimpl.pipeline import run_pipeline
    from tpuva.export import read_tracks_hdf5

    clip, plate = clip_and_plate(frames=40)
    ref = run_pipeline(clip, CFG, background0=plate)
    rows = StreamingPipeline(CFG, parallel_bg=False).run(
        VideoMemory(clip), background0=plate
    )
    p1, p2 = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    write_tracks_hdf5(p1, ref.rows)
    write_tracks_hdf5(p2, rows)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_encoded_video_streamed_e2e_byte_identical(tmp_path):
    """The full encoded-file seam in one CI test (VERDICT r3 weak item 4):
    render -> MJPG/AVI encode -> VideoFile decode (gray conversion,
    frame_count trust, fps metadata) -> filter chain -> StreamingPipeline
    -> HDF5, byte-identical to refimpl run on the SAME decoded frames.
    MJPG is lossy, so both sides must consume the decoder's output, not
    the pre-encode clip."""
    import cv2

    from refimpl.pipeline import run_pipeline
    from refimpl.synthetic import moving_disk_clip
    from tpuva.filters import FilterCrop
    from tpuva.io import VideoFile, VideoFileWriter

    clip, _, plate = moving_disk_clip(h=96, w=128, frames=48, radius=9,
                                      seed=11)
    path = str(tmp_path / "clip.avi")
    with VideoFileWriter(path, fps=25.0) as w:
        for f in clip:
            w.write_frame(f)

    # metadata seam: frame count from the container header, fps round-trip
    v = VideoFile(path, gray=True)
    assert v.frame_count == 48
    assert abs(v.fps - 25.0) < 1e-6
    assert v.size == (128, 96) and not v.is_color

    decoded = np.stack(list(v))
    assert decoded.shape == clip.shape and decoded.dtype == np.uint8
    # sanity: encode was genuinely lossy but close (MJPG)
    assert not np.array_equal(decoded, clip)
    assert np.abs(decoded.astype(int) - clip.astype(int)).max() < 32

    rect = (8, 4, 112, 88)  # x, y, w, h
    ref = run_pipeline(
        np.ascontiguousarray(decoded[:, 4:92, 8:120]), CFG,
        background0=plate[4:92, 8:120],
    )
    chain = FilterCrop(VideoFile(path, gray=True), rect)
    rows = StreamingPipeline(CFG, parallel_bg=False).run(
        chain, background0=plate[4:92, 8:120]
    )
    p1, p2 = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    write_tracks_hdf5(p1, ref.rows)
    write_tracks_hdf5(p2, rows)
    assert len(rows) > 20
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_encoded_video_with_blur_centroid_band(tmp_path):
    """Same encoded-file seam with the blur stage enabled: blur is exempt
    from the byte contract (float associativity) but trajectories must
    agree with refimpl-on-decoded-frames within the 1 px band."""
    from refimpl.pipeline import run_pipeline
    from refimpl.synthetic import moving_disk_clip
    from tpuva.graph.config import BlurConfig
    from tpuva.io import VideoFile, VideoFileWriter
    import dataclasses

    clip, _, plate = moving_disk_clip(h=96, w=128, frames=32, radius=9,
                                      seed=5)
    path = str(tmp_path / "clip.avi")
    with VideoFileWriter(path, fps=25.0) as w:
        for f in clip:
            w.write_frame(f)
    cfg = dataclasses.replace(CFG, blur=BlurConfig(ksize=5, sigma=0.0))
    decoded = np.stack(list(VideoFile(path, gray=True)))
    ref = run_pipeline(decoded, cfg, background0=plate)
    rows = StreamingPipeline(cfg, parallel_bg=False).run(
        VideoFile(path, gray=True), background0=plate
    )
    ref_by_key = {(int(r[0]), int(r[1])): (r[2], r[3]) for r in ref.rows}
    got_by_key = {(int(r[0]), int(r[1])): (r[2], r[3]) for r in rows}
    assert set(ref_by_key) == set(got_by_key) and len(got_by_key) > 20
    for k, (x, y) in got_by_key.items():
        rx, ry = ref_by_key[k]
        assert max(abs(x - rx), abs(y - ry)) <= 1.0


def test_padded_tail_checkpoint_skipped(tmp_path):
    """The final checkpoint is not written from a pad-perturbed carry;
    the last periodic checkpoint stays authoritative (resume against a
    grown video must not skip real frames)."""
    from tpuva.graph.streaming import load_checkpoint
    from tpuva.io.memory import VideoMemory

    clip, _, plate = moving_disk_clip(h=64, w=96, frames=44, radius=6, seed=3)
    ckpt = str(tmp_path / "tail.npz")
    # 44 frames, batch 8 -> 5 full batches + padded tail of 4
    sp = StreamingPipeline(CFG, checkpoint_path=ckpt, checkpoint_every=5)
    sp.run(VideoMemory(clip), background0=plate)
    carry, _rows = load_checkpoint(ckpt, CFG)
    # checkpoint frame_idx must be the last FULL-batch boundary (40), not
    # the padded 48
    assert int(carry.frame_idx) == 40


def test_async_drainer_exact_sums_and_tpu_safe_packing():
    """AsyncRowDrainer must round-trip int32 row_sums EXACTLY and its
    packed f32 buffer must never encode them as raw bit patterns: bitcast
    ints are f32 denormals and NaNs (73000, -5), which a device may flush
    to zero or canonicalize in any op that touches them. The packed
    representation must therefore contain only safe f32 values (finite,
    zero-or-normal) for adversarial sums."""
    import jax.numpy as jnp

    from tpuva.graph.streaming import AsyncRowDrainer

    N, K = 3, 4
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(N, K, 5)).astype(np.float32)
    valid = rng.random((N, K)) < 0.7
    # sums whose int32 bit patterns are f32 denormals / NaNs / infs
    sums = np.array(
        [1, 73000, -5, -1, 2**31 - 1, -(2**31), 0x7F800001 - 2**32,
         0x00400000] * 3,
    ).astype(np.int64).astype(np.int32).reshape(N, K, 2)
    out = {
        "rows": jnp.asarray(rows),
        "row_valid": jnp.asarray(valid),
        "row_sums": jnp.asarray(sums),
        "stats_overflow": jnp.zeros((N,), jnp.int32),
        "active_tracks": jnp.int32(5),
    }
    got = []
    dr = AsyncRowDrainer(lambda rec, n: got.append((rec, n)), group=1)
    try:
        dr.submit(out, n=2)
        dr.flush()
    finally:
        dr.close()
    (rec, n), = got
    assert n == 2
    assert np.array_equal(rec["row_sums"], sums)
    assert np.array_equal(rec["row_valid"], valid)
    assert np.array_equal(rec["rows"], rows)
    assert rec["active_tracks"] == 5 and "ccl_converged" not in rec
    assert np.array_equal(rec["stats_overflow"], np.zeros(N, np.int32))

    # the packed buffer itself must be transport-safe
    packed = np.asarray(dr._pack(out))
    assert np.isfinite(packed).all()
    tiny = np.finfo(np.float32).tiny
    assert ((packed == 0) | (np.abs(packed) >= tiny)).all(), \
        "packed buffer contains denormal f32 (unsafe through device ops)"


def test_streaming_warmup_compiles_without_state(tmp_path):
    """warmup() compiles the step for (H, W) without touching checkpoint
    or row state; a subsequent run() produces the same rows as an
    un-warmed pipeline."""
    clip, _truth, plate = moving_disk_clip(
        h=48, w=64, frames=32, radius=6, noise_sigma=2.0
    )
    sp_cold = StreamingPipeline(CFG)
    rows_cold = sp_cold.run(VideoMemory(clip), background0=plate)

    sp_warm = StreamingPipeline(CFG)
    sp_warm.warmup(48, 64)
    rows_warm = sp_warm.run(VideoMemory(clip), background0=plate)
    assert [tuple(r) for r in rows_warm] == [tuple(r) for r in rows_cold]


def test_streaming_otsu_resume_equivalence(tmp_path):
    """The staged Otsu route (fused |F-B| emit -> per-frame histogram
    threshold -> morphology) under StreamingPipeline: streamed rows match
    process_clip, and an interrupted+resumed run is identical — the
    per-frame Otsu threshold is recomputed from data, so it must survive
    a checkpoint boundary without drift."""
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.03),
        segment=SegmentConfig(threshold="otsu", min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )
    clip, plate = clip_and_plate(frames=48)
    ref_rows, _, _ = process_clip(clip, cfg, background0=plate)

    full = StreamingPipeline(cfg, parallel_bg=False).run(
        VideoMemory(clip), background0=plate
    )
    assert rows_equal(full, ref_rows)

    ckpt = str(tmp_path / "otsu_state.npz")
    sp1 = StreamingPipeline(
        cfg, checkpoint_path=ckpt, checkpoint_every=10**9, parallel_bg=False
    )
    sp1.run(VideoMemory(clip[:24]), background0=plate)
    sp2 = StreamingPipeline(
        cfg, checkpoint_path=ckpt, checkpoint_every=10**9, parallel_bg=False
    )
    rows = sp2.run(VideoMemory(clip), background0=plate, resume=True)
    assert rows_equal(rows, full)


def test_row_log_fresh_run_discards_stale_rows(tmp_path):
    """A fresh (non-resume) run must truncate an existing RowLog: rows
    left by a previous run (e.g. one that crashed before its first
    checkpoint) would otherwise silently duplicate into the results."""
    clip, plate = clip_and_plate(frames=32)
    rlogp = str(tmp_path / "rows.bin")

    sp0 = StreamingPipeline(CFG, parallel_bg=False, row_log_path=rlogp)
    first = sp0.run(VideoMemory(clip), background0=plate)
    assert len(first) > 0

    # second fresh run against the SAME log file (no checkpoint at all)
    sp1 = StreamingPipeline(CFG, parallel_bg=False, row_log_path=rlogp)
    again = sp1.run(VideoMemory(clip), background0=plate)
    assert len(again) == len(first), "stale rows leaked into a fresh run"
    assert rows_equal([tuple(r) for r in again], [tuple(r) for r in first])

    # resume=False with a checkpoint present must also start clean
    ckpt = str(tmp_path / "state.npz")
    sp2 = StreamingPipeline(
        CFG, checkpoint_path=ckpt, checkpoint_every=2, parallel_bg=False,
        row_log_path=rlogp,
    )
    sp2.run(VideoMemory(clip), background0=plate, resume=False)
    sp3 = StreamingPipeline(
        CFG, checkpoint_path=ckpt, checkpoint_every=2, parallel_bg=False,
        row_log_path=rlogp,
    )
    final = sp3.run(VideoMemory(clip), background0=plate, resume=False)
    assert len(final) == len(first)
