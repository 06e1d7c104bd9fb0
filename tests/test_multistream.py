"""Config 5 (BASELINE.json:11): multi-stream data parallelism on the
simulated 8-device CPU mesh (SURVEY.md §4.2), plus vmap/shard_map
equivalence and merge determinism."""

import numpy as np
import jax
import jax.numpy as jnp

from refimpl.synthetic import moving_disk_clip
from tpuva.graph.config import (
    BackgroundConfig,
    PipelineConfig,
    SegmentConfig,
    TrackConfig,
)
from tpuva.graph.pipeline import collect_rows, process_clip
from tpuva.dist import (
    init_multistream_carry,
    make_multistream_processor,
    make_stream_mesh,
    merge_stream_rows,
)

CFG = PipelineConfig(
    background=BackgroundConfig(alpha=0.02),
    segment=SegmentConfig(threshold=40.0, min_area=20, max_blobs=4),
    track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
    batch=8,
)


def make_streams(S=8, T=16, h=64, w=96):
    clips, plates = [], []
    for s in range(S):
        clip, _, plate = moving_disk_clip(h=h, w=w, frames=T, radius=6, seed=s)
        clips.append(clip)
        plates.append(plate)
    return np.stack(clips), np.stack(plates)


def run_multistream(fn, cfg, clips, plates):
    S, T, H, W = clips.shape
    carry = init_multistream_carry(cfg, H, W, S, background0=plates)
    rows_by_stream = [[] for _ in range(S)]
    N = cfg.batch
    for start in range(0, T, N):
        chunk = jnp.asarray(clips[:, start : start + N])
        carry, out = fn(carry, chunk)
        for s in range(S):
            rows_by_stream[s].extend(
                collect_rows(
                    out["rows"][s], out["row_valid"][s],
                    row_sums=out["row_sums"][s],
                )
            )
    return rows_by_stream


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8, jax.devices()


def test_auto_mesh_refuses_fewer_devices_than_streams():
    """mesh='auto' must not quietly run every stream on one device when
    several are visible but fewer than the streams: it raises, naming
    both counts. One device, or enough for one stream each, still works."""
    import pytest

    from tpuva.dist import MultiStreamPipeline

    n_dev = len(jax.devices())
    with pytest.raises(ValueError, match=f"{n_dev + 1} streams on {n_dev}"):
        MultiStreamPipeline(CFG, n_dev + 1)
    assert MultiStreamPipeline(CFG, n_dev).mesh is not None
    one = MultiStreamPipeline(CFG, n_dev + 1, mesh=None)
    assert one.mesh is None


def test_shard_map_matches_vmap_and_single_stream():
    clips, plates = make_streams()
    S, T, H, W = clips.shape
    mesh = make_stream_mesh(S)
    fn_mesh = make_multistream_processor(CFG, S, mesh=mesh)
    fn_vmap = make_multistream_processor(CFG, S, mesh=None)
    rows_mesh = run_multistream(fn_mesh, CFG, clips, plates)
    rows_vmap = run_multistream(fn_vmap, CFG, clips, plates)
    assert rows_mesh == rows_vmap
    # per-stream result equals running that stream through the single-chip
    # pipeline driver
    for s in range(S):
        solo, _, _ = process_clip(clips[s], CFG, background0=plates[s])
        assert rows_mesh[s] == solo, f"stream {s}"


def test_merge_deterministic_and_unique_ids():
    clips, plates = make_streams(S=4)
    mesh = make_stream_mesh(4)
    fn = make_multistream_processor(CFG, 4, mesh=mesh)
    rows_by_stream = run_multistream(fn, CFG, clips, plates)
    merged = merge_stream_rows(rows_by_stream)
    merged2 = merge_stream_rows(rows_by_stream)
    assert merged == merged2
    # ids unique across streams: each (tid) maps to rows of exactly one
    # stream's trajectory
    total = sum(len(r) for r in rows_by_stream)
    assert len(merged) == total


def test_multistream_pipeline_end_to_end(tmp_path):
    """Config-5 driver: one call processes 8 streams on the CPU mesh and
    writes merged + per-stream outputs; per-stream rows equal the
    single-stream pipeline on the same clips (VERDICT r1 missing #1)."""
    from tpuva.dist import MultiStreamPipeline
    from tpuva.export.hdf5io import read_multistream_hdf5, read_tracks_hdf5
    from tpuva.io.memory import VideoMemory

    S, T = 8, 20
    clips, plates = make_streams(S=S, T=T)
    videos = [VideoMemory(clips[s]) for s in range(S)]
    exp = str(tmp_path / "out")
    msp = MultiStreamPipeline(CFG, S)
    assert msp.mesh is not None, "expected the 8-device CPU mesh"
    rows_by_stream, merged = msp.run(
        videos, background0=plates, export_dir=exp
    )
    # per-stream rows == single-stream pipeline on the same clip
    for s in range(S):
        ref_rows, _, _ = process_clip(clips[s], CFG, background0=plates[s])
        assert sorted(rows_by_stream[s]) == sorted(ref_rows), f"stream {s}"
    # provenance present and consistent
    assert all(len(r) == 6 for r in merged)
    streams = {int(r[0]) for r in merged}
    assert streams == set(range(S))
    # exports round-trip
    mtab = read_multistream_hdf5(str(tmp_path / "out" / "merged.h5"))
    assert mtab.shape[1] == 6 and len(mtab) == len(merged)
    s0 = read_tracks_hdf5(str(tmp_path / "out" / "stream_0.h5"))
    sel = mtab[mtab[:, 0] == 0]
    # merged per-stream slice value-identical to the per-stream file
    # modulo the global id offset (stream 0 offset is 0)
    np.testing.assert_array_equal(sel[:, 1:], s0)


def test_multistream_pipeline_resume(tmp_path):
    """Mid-run kill + resume from the stacked checkpoint reproduces the
    uninterrupted run exactly."""
    from tpuva.dist import MultiStreamPipeline
    from tpuva.io.memory import VideoMemory

    S, T = 4, 32
    clips, plates = make_streams(S=S, T=T)
    videos = lambda: [VideoMemory(clips[s]) for s in range(S)]
    full_rows, full_merged = MultiStreamPipeline(CFG, S).run(
        videos(), background0=plates
    )

    ckpt = str(tmp_path / "ms.npz")
    # run 1: checkpoint after every step, abort after 2 steps (16 frames)
    msp = MultiStreamPipeline(CFG, S, checkpoint_path=ckpt, checkpoint_every=1)

    class Abort(Exception):
        pass

    orig = MultiStreamPipeline._save_checkpoint
    calls = {"n": 0}

    def bomb(self, carry, rows_by_stream, cfg):
        calls["n"] += 1
        if calls["n"] > 2:
            raise Abort()
        return orig(self, carry, rows_by_stream, cfg)

    msp._save_checkpoint = bomb.__get__(msp)
    try:
        msp.run(videos(), background0=plates)
    except Abort:
        pass
    assert np.load(ckpt)["frame_idx"].max() > 0

    # run 2: resume, finish
    msp2 = MultiStreamPipeline(
        CFG, S, checkpoint_path=ckpt, checkpoint_every=10**9
    )
    rows2, merged2 = msp2.run(videos(), background0=plates)
    for s in range(S):
        assert sorted(rows2[s]) == sorted(full_rows[s]), f"stream {s}"
    assert sorted(merged2) == sorted(full_merged)


def test_multistream_row_log_mode_and_resume(tmp_path):
    """row_log_dir mode: rows stream to per-stream RowLogs, checkpoints
    store only durable counts, and a mid-run kill + resume reproduces the
    in-RAM mode's rows exactly."""
    from tpuva.dist import MultiStreamPipeline
    from tpuva.io.memory import VideoMemory

    S, T = 4, 32
    clips, plates = make_streams(S=S, T=T)
    videos = lambda: [VideoMemory(clips[s]) for s in range(S)]
    full_rows, full_merged = MultiStreamPipeline(CFG, S).run(
        videos(), background0=plates
    )

    # uninterrupted log-mode run matches the in-RAM mode numerically
    logdir = str(tmp_path / "logs_a")
    rows_a, merged_a = MultiStreamPipeline(
        CFG, S, row_log_dir=logdir
    ).run(videos(), background0=plates)
    for s in range(S):
        np.testing.assert_array_equal(
            np.asarray(sorted(rows_a[s]), np.float64),
            np.asarray(sorted(full_rows[s]), np.float64),
        )
    np.testing.assert_array_equal(
        np.asarray(sorted(merged_a), np.float64),
        np.asarray(sorted(full_merged), np.float64),
    )

    # kill after 2 checkpoints, resume from durable counts
    ckpt = str(tmp_path / "ms.npz")
    logdir_b = str(tmp_path / "logs_b")
    msp = MultiStreamPipeline(
        CFG, S, checkpoint_path=ckpt, checkpoint_every=1,
        row_log_dir=logdir_b,
    )

    class Abort(Exception):
        pass

    orig = MultiStreamPipeline._save_checkpoint
    calls = {"n": 0}

    def bomb(self, carry, rows_state, cfg):
        calls["n"] += 1
        if calls["n"] > 2:
            raise Abort()
        return orig(self, carry, rows_state, cfg)

    msp._save_checkpoint = bomb.__get__(msp)
    try:
        msp.run(videos(), background0=plates)
    except Abort:
        pass
    z = np.load(ckpt)
    assert "row_counts" in z and z["frame_idx"].max() > 0

    rows_b, merged_b = MultiStreamPipeline(
        CFG, S, checkpoint_path=ckpt, checkpoint_every=10**9,
        row_log_dir=logdir_b,
    ).run(videos(), background0=plates)
    np.testing.assert_array_equal(
        np.asarray(sorted(merged_b), np.float64),
        np.asarray(sorted(full_merged), np.float64),
    )

    # mode mismatch surfaces instead of silently mixing row stores
    import pytest as _pytest
    with _pytest.raises(ValueError, match="row_log_dir"):
        MultiStreamPipeline(
            CFG, S, checkpoint_path=ckpt, checkpoint_every=10**9
        ).run(videos(), background0=plates)


def test_multistream_otsu_matches_single_stream():
    """The staged Otsu route under the multi-stream processor: each
    stream's rows must equal the single-stream process_clip result with
    the identical Otsu config (per-frame data-dependent thresholds must
    not leak across streams)."""
    cfg = PipelineConfig(
        background=BackgroundConfig(alpha=0.02),
        segment=SegmentConfig(threshold="otsu", min_area=20, max_blobs=4),
        track=TrackConfig(max_dist=60.0, death_patience=5, max_tracks=8),
        batch=8,
    )
    clips, plates = make_streams(S=3, T=16)
    fn = make_multistream_processor(cfg, 3)
    rows_by_stream = run_multistream(fn, cfg, clips, plates)
    for s in range(3):
        ref_rows, _, _ = process_clip(clips[s], cfg, background0=plates[s])
        got = [(int(r[0]), int(r[1]), round(r[2], 3), round(r[3], 3), int(r[4]))
               for r in rows_by_stream[s]]
        ref = [(int(r[0]), int(r[1]), round(r[2], 3), round(r[3], 3), int(r[4]))
               for r in ref_rows]
        assert sorted(got) == sorted(ref), f"stream {s} diverged"


def test_multistream_row_log_fresh_run_discards_stale_rows(tmp_path):
    """Re-running MultiStreamPipeline fresh against an existing
    row_log_dir must truncate every stream's log (stale rows from a
    prior run would duplicate into the merged export), and log-mode rows
    must carry the same (int, int, float, float, float) types as the
    in-RAM mode."""
    from tpuva.dist import MultiStreamPipeline
    from tpuva.io.memory import VideoMemory

    S, T = 3, 16
    clips, plates = make_streams(S=S, T=T)
    videos = lambda: [VideoMemory(clips[s]) for s in range(S)]
    logdir = str(tmp_path / "logs")

    rows1, merged1 = MultiStreamPipeline(CFG, S, row_log_dir=logdir).run(
        videos(), background0=plates
    )
    rows2, merged2 = MultiStreamPipeline(CFG, S, row_log_dir=logdir).run(
        videos(), background0=plates
    )
    assert [len(r) for r in rows2] == [len(r) for r in rows1], (
        "stale rows leaked into a fresh run"
    )
    assert sorted(merged2) == sorted(merged1)
    ram_rows, _ = MultiStreamPipeline(CFG, S).run(
        videos(), background0=plates
    )
    for s in range(S):
        got, ram = sorted(rows2[s]), sorted(ram_rows[s])
        assert got == ram
        for g, r in zip(got, ram):
            assert [type(v) for v in g] == [type(v) for v in r], (
                "log-mode row types diverge from in-RAM mode"
            )
