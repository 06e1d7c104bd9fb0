"""Config-5 end-to-end host driver: 8 concurrent camera streams on a
('stream',) mesh with per-stream state and merged results
(BASELINE.json:11; SURVEY.md §2.3-K, §2.4-DP).

The device function (make_multistream_processor) existed since round 1;
this is the missing host orchestration — the multi-stream analog of
tpuva.graph.streaming.StreamingPipeline:

    S videos -> S decode threads (BatchStager, one per stream, staging
    each stream's batch directly onto its chip) -> one global (S, N, H, W)
    array assembled WITHOUT host copies (make_array_from_single_device_
    arrays over the stream sharding) -> one mesh step -> per-stream row
    collection -> periodic stacked-carry checkpoints -> merged export
    with stream provenance.

On a host with one device the same driver runs the vmap (single-device)
processor; the mesh path is exercised on the simulated 8-device CPU mesh
(SURVEY.md §4.2).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuva.dist.multistream import (
    init_multistream_carry,
    make_multistream_processor,
    make_stream_mesh,
    merge_stream_rows,
)
from tpuva.dist.spatial import make_space_mesh, make_spatial_processor
from tpuva.graph.config import PipelineConfig
from tpuva.graph.pipeline import PipelineCarry, collect_rows, \
    collect_rows_array
from tpuva.graph.streaming import AsyncRowDrainer, RowLog, StreamingPipeline
from tpuva.io.base import VideoBase
from tpuva.io.staging import BatchStager
from tpuva.track.table import TrackState
from tpuva.utils import BatchLogger, hot_loop_transfer_guard


class SpatialStreamPipeline(StreamingPipeline):
    """Config-4 streamed driver on the ('space',) mesh (SURVEY.md §2.4 TP
    row + §5.4): ONE long video, its rows banded across n_chips.

    Inherits the full StreamingPipeline host machinery — BatchStager
    decode overlap, AsyncRowDrainer grouped off-thread row collection,
    periodic atomic checkpoints, RowLog append-only mode, resume
    byte-identity, transfer-guard discipline — and only overrides the
    placement hooks:

    - frames are staged directly with the row-band sharding
      P(None, 'space', None) (device_put against a NamedSharding inside
      the stager thread, still one explicit async transfer);
    - the carry is placed explicitly (bg row-banded, tracker replicated)
      so the first mesh step does not reshard it implicitly inside the
      transfer-guarded hot loop;
    - the step is make_spatial_processor's shard_map program, built
      lazily for the video's (H, W) — bit-identical to the single-chip
      pipeline (tests/test_spatial_tp.py), so checkpoints interoperate:
      a single-chip checkpoint resumes on the mesh and vice versa (the
      snapshot holds the gathered full-frame carry either way).

    H must divide by n_chips and the filter halo must fit one band
    (make_spatial_processor validates).

    A band holding more component pieces than its contraction table
    (max_components columns) raises when strict=True (default) and warns
    and counts (.overflow_frames) otherwise.
    """

    def __init__(self, cfg: PipelineConfig, n_chips: int, mesh=None,
                 strict: bool = True, **kw):
        super().__init__(cfg, **kw)
        self.n_chips = n_chips
        self.strict = strict
        self.overflow_frames = 0
        self.mesh = mesh if mesh is not None else make_space_mesh(n_chips)
        self._band = NamedSharding(self.mesh, P(None, "space", None))
        self._rows_sh = NamedSharding(self.mesh, P("space", None))
        self._rep = NamedSharding(self.mesh, P())
        self._fns = {}  # (H, W) -> compiled mesh step
        self._warm = set()  # shapes whose first execution already ran

    # ---------------------------------------------------- placement hooks
    def _place_carry(self, carry: PipelineCarry) -> PipelineCarry:
        return PipelineCarry(
            bg=jax.device_put(carry.bg, self._rows_sh),
            bg_valid=jax.device_put(carry.bg_valid, self._rep),
            track=jax.tree.map(
                lambda x: jax.device_put(x, self._rep), carry.track
            ),
            frame_idx=jax.device_put(carry.frame_idx, self._rep),
        )

    def _place_frames(self, frames):
        return jax.device_put(frames, self._band)

    def _make_stager(self, source):
        # The FIRST execution of the shard_map program transfers its
        # closure constants host->device — an implicit transfer the hot
        # loop's transfer guard (rightly) rejects. run() builds the
        # stager before entering the guard, so warm the program here
        # with a throwaway carry; jit caches the executable.
        W, H = source.size
        if (H, W) not in self._warm:
            self.warmup(H, W)
            self._warm.add((H, W))
        return BatchStager(
            source, self.cfg.batch, queue_depth=self.queue_depth,
            sharding=self._band,
        )

    def _step(self, cfg, carry, dev_batch):
        key = (int(dev_batch.shape[1]), int(dev_batch.shape[2]))
        fn = self._fns.get(key)
        if fn is None:
            fn = make_spatial_processor(
                cfg, key[0], key[1], self.n_chips, mesh=self.mesh,
                max_components=self.max_components,
            )
            self._fns[key] = fn
        return fn(carry, dev_batch)

    def _check_capacity(self, out: dict, n: int) -> None:
        """stats_overflow means a band held more component PIECES than the
        per-band contraction table (max_components columns): their limb
        sums were dropped, so areas/centroids are inexact for those
        frames."""
        import warnings

        if "stats_overflow" not in out:
            return
        ov = np.asarray(out["stats_overflow"][:n])
        bad = int((ov > 0).sum())
        if bad:
            self.overflow_frames += bad
            msg = (
                f"spatial-TP band piece-table overflow on {bad} frame(s) "
                f"(max {int(ov.max())} pieces dropped): raise "
                f"max_components (={self.max_components}) for this workload"
            )
            if self.strict:
                raise RuntimeError(msg)
            warnings.warn(msg)


def save_multistream_checkpoint(path: str, carry: PipelineCarry,
                                rows_state, cfg: PipelineConfig) -> None:
    """Atomic snapshot of the stacked per-stream carry + rows (npz).

    rows_state is either rows_by_stream (list of per-stream row lists,
    embedded in the snapshot) or a 1-D int array of per-stream durable
    RowLog counts (row-log mode: O(carry) snapshots, rows live in the
    append-only logs)."""
    if isinstance(rows_state, np.ndarray) and rows_state.ndim == 1:
        flat = None
        counts = rows_state.astype(np.int64)
    else:
        counts = None
        flat = []
        for s, rows in enumerate(rows_state):
            for r in rows:
                flat.append((s,) + tuple(r))
    # EXPLICIT device_get: checkpointing is a designated host<->device
    # boundary and must stay legal inside hot_loop_transfer_guard scopes
    # (also gathers the mesh-sharded carry in one fetch per field)
    payload = {
        "bg": np.asarray(jax.device_get(carry.bg)),
        "bg_valid": np.asarray(jax.device_get(carry.bg_valid)),
        "frame_idx": np.asarray(jax.device_get(carry.frame_idx)),
        "track_pos": np.asarray(jax.device_get(carry.track.pos)),
        "track_tid": np.asarray(jax.device_get(carry.track.tid)),
        "track_missed": np.asarray(jax.device_get(carry.track.missed)),
        "track_active": np.asarray(jax.device_get(carry.track.active)),
        "track_next_id": np.asarray(jax.device_get(carry.track.next_id)),
        "config_json": np.frombuffer(cfg.to_json().encode(), dtype=np.uint8),
    }
    if flat is not None:
        payload["rows"] = np.asarray(flat, np.float64).reshape(-1, 6)
    else:
        payload["row_counts"] = counts
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_multistream_checkpoint(path: str, cfg: PipelineConfig,
                                n_streams: int):
    """Returns (carry, rows_by_stream) — or (carry, per-stream RowLog
    counts) for row-log-mode checkpoints — or raises (config must
    match)."""
    z = np.load(path)
    saved_cfg = bytes(z["config_json"]).decode()
    if PipelineConfig.from_json(saved_cfg) != cfg:
        raise ValueError(
            "checkpoint was produced with a different PipelineConfig"
        )
    if z["bg"].shape[0] != n_streams:
        raise ValueError("checkpoint has a different stream count")
    carry = PipelineCarry(
        bg=jnp.asarray(z["bg"]),
        bg_valid=jnp.asarray(z["bg_valid"]),
        track=TrackState(
            pos=jnp.asarray(z["track_pos"]),
            tid=jnp.asarray(z["track_tid"]),
            missed=jnp.asarray(z["track_missed"]),
            active=jnp.asarray(z["track_active"]),
            next_id=jnp.asarray(z["track_next_id"]),
        ),
        frame_idx=jnp.asarray(z["frame_idx"]),
    )
    if "row_counts" in z:
        return carry, z["row_counts"].astype(np.int64)
    rows_by_stream = [[] for _ in range(n_streams)]
    for r in z["rows"]:
        rows_by_stream[int(r[0])].append(tuple(r[1:]))
    return carry, rows_by_stream


class MultiStreamPipeline:
    """Drive S equal-length videos through the data-parallel mesh pipeline.

    mesh="auto" builds a ('stream',) mesh when >= n_streams devices are
    visible and runs the single-device vmap processor (same math, tested
    equivalent) when one device is; between the two it raises rather than
    leave devices idle. Each stream's batches are decoded by its own
    thread and staged directly onto its chip; the global (S, N, H, W)
    batch is assembled from the per-chip shards with zero host copies.

    row_log_dir enables the unbounded-stream mode (the multi-stream
    analog of StreamingPipeline's row_log_path): drained rows stream to
    one append-only RowLog per stream instead of host RAM, and
    checkpoints store only the per-stream durable row counts (O(carry)
    snapshots instead of re-embedding the full row history).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        n_streams: int,
        mesh="auto",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,  # mesh steps
        parallel_bg: bool = False,
        max_components: int = 64,
        queue_depth: int = 3,
        log: bool = False,
        row_log_dir: Optional[str] = None,
    ):
        self.cfg = cfg
        self.n_streams = n_streams
        self.row_log_dir = row_log_dir
        if mesh == "auto":
            n_dev = len(jax.devices())
            if n_dev >= n_streams:
                mesh = make_stream_mesh(n_streams)
            elif n_dev == 1:
                mesh = None
            else:
                raise ValueError(
                    f"mesh='auto' with {n_streams} streams on {n_dev} "
                    "devices: a one-stream-per-device mesh needs "
                    f"{n_streams} devices; pass mesh=None to run every "
                    "stream on one device"
                )
        self.mesh = mesh
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.queue_depth = queue_depth
        self.logger = BatchLogger(enabled=log)
        self._fn = make_multistream_processor(
            cfg,
            n_streams,
            mesh=mesh,
            parallel_bg=parallel_bg,
            max_components=max_components,
        )

    # ------------------------------------------------------------- assembly
    def _stagers(self, videos: Sequence[VideoBase]):
        devs = (
            list(self.mesh.devices.reshape(-1))
            if self.mesh is not None
            else [None] * self.n_streams
        )
        return [
            BatchStager(
                v, self.cfg.batch, queue_depth=self.queue_depth, device=d
            )
            for v, d in zip(videos, devs)
        ]

    def _assemble(self, batches):
        """Per-stream (N, H, W) device batches -> global (S, N, H, W)."""
        if self.mesh is None:
            return jnp.stack(batches)
        shards = [b[None] for b in batches]  # (1, N, H, W) on its chip
        S = self.n_streams
        shape = (S,) + tuple(shards[0].shape[1:])
        return jax.make_array_from_single_device_arrays(
            shape, NamedSharding(self.mesh, P("stream")), shards
        )

    def _place_carry(self, carry):
        """EXPLICITLY place the stacked carry onto the ('stream',) mesh.

        Without this, the first mesh step reshards it implicitly — a
        hidden device-to-device transfer inside the hot loop (flagged by
        hot_loop_transfer_guard, which is how it was found)."""
        if self.mesh is None:
            return carry
        sh = NamedSharding(self.mesh, P("stream"))
        return jax.tree.map(lambda x: jax.device_put(x, sh), carry)

    # ------------------------------------------------------------------ run
    def run(
        self,
        videos: Sequence[VideoBase],
        background0: Optional[np.ndarray] = None,  # (S, H, W)
        resume: bool = True,
        export_dir: Optional[str] = None,
    ):
        """Process all streams in lock-step. Returns (rows_by_stream,
        merged) where merged rows carry stream provenance:
        (stream, track_id_global, frame, x, y, area).

        With export_dir set, writes stream_<s>.h5 per stream plus
        merged.h5 (6-column trajectories with a stream column)."""
        cfg = self.cfg
        S = self.n_streams
        if len(videos) != S:
            raise ValueError(f"expected {S} videos, got {len(videos)}")
        counts = {v.frame_count for v in videos}
        if len(counts) != 1:
            raise ValueError(
                f"streams must be equal length (lock-step), got {counts}"
            )
        total = counts.pop()
        W, H = videos[0].size

        use_log = self.row_log_dir is not None
        if use_log:
            os.makedirs(self.row_log_dir, exist_ok=True)
        rlogs = None  # opened only after checkpoint-mode validation

        def _open_logs():
            return [
                RowLog(os.path.join(self.row_log_dir, f"stream_{s}.rows"))
                for s in range(S)
            ]

        rows_by_stream = [[] for _ in range(S)]

        def finish():
            # read logs back into the common list-of-tuples shape — same
            # (int, int, float, float, float) rows as collect_rows — so
            # both modes return (and merge/export) identically
            if use_log:
                out = []
                for rl in rlogs:
                    out.append([
                        (int(r[0]), int(r[1]), float(r[2]), float(r[3]),
                         float(r[4]))
                        for r in rl.read()
                    ])
                    rl.close()
                return out
            return rows_by_stream

        def rows_state():
            if use_log:
                return np.asarray([rl.count() for rl in rlogs], np.int64)
            return rows_by_stream

        carry = init_multistream_carry(cfg, H, W, S, background0=background0)
        carry = self._place_carry(carry)
        start_frame = 0
        if (
            resume
            and self.checkpoint_path
            and os.path.exists(self.checkpoint_path)
        ):
            carry, saved = load_multistream_checkpoint(
                self.checkpoint_path, cfg, S
            )
            carry = self._place_carry(carry)
            if isinstance(saved, np.ndarray) and saved.ndim == 1:
                if not use_log:
                    raise ValueError(
                        "checkpoint stores RowLog counts but no "
                        "row_log_dir was given"
                    )
                rlogs = _open_logs()
                for rl, cnt in zip(rlogs, saved):
                    rl.truncate(int(cnt))
            else:
                if use_log:
                    raise ValueError(
                        "checkpoint embeds rows but row_log_dir is set"
                    )
                rows_by_stream = saved
            fidx = np.asarray(carry.frame_idx)
            assert (fidx == fidx[0]).all(), "streams out of lock-step"
            start_frame = int(fidx[0])
        if use_log and rlogs is None:
            # fresh (non-resume) run: rows left in the logs by a previous
            # run would silently duplicate into the merged export — start
            # every stream's log clean.
            rlogs = _open_logs()
            for rl in rlogs:
                rl.truncate(0)

        if start_frame >= total:
            rows_by_stream = finish()
            return rows_by_stream, merge_stream_rows(
                rows_by_stream, with_stream=True
            )
        sources = [
            v[start_frame:] if start_frame else v for v in videos
        ]
        stagers = self._stagers(sources)
        iters = [iter(st) for st in stagers]

        def consume(rec, n):
            # drainer thread: per-stream row collection in step order
            rows, valid = rec["rows"], rec["row_valid"]
            sums = rec["row_sums"]
            for s in range(rows.shape[0]):
                if use_log:
                    rlogs[s].append(collect_rows_array(
                        rows[s, :n], valid[s, :n], row_sums=sums[s, :n],
                    ))
                else:
                    rows_by_stream[s].extend(
                        collect_rows(
                            rows[s, :n], valid[s, :n], row_sums=sums[s, :n],
                        )
                    )

        # grouped async collection off-thread (AsyncRowDrainer): ~1 device
        # round trip per group of steps, overlapped with mesh dispatch;
        # 2048-frame groups as in StreamingPipeline.run
        drainer = AsyncRowDrainer(
            consume, group=max(2, 2048 // cfg.batch),
            max_groups_in_flight=1,
        )
        steps = 0
        last_n = cfg.batch
        try:
            # transfer_guard discipline (SURVEY.md §5.8): see
            # StreamingPipeline.run — all intended crossings are explicit
            with hot_loop_transfer_guard():
                while True:
                    items = []
                    done = 0
                    for it in iters:
                        try:
                            items.append(next(it))
                        except StopIteration:
                            done += 1
                    if done:
                        assert done == S, "streams finished out of lock-step"
                        break
                    ns = {n for n, _ in items}
                    assert len(ns) == 1, f"unequal tail batches: {ns}"
                    n = ns.pop()
                    frames = self._assemble([b for _, b in items])
                    carry, out = self._fn(carry, frames)
                    drainer.submit(out, n)
                    last_n = n
                    steps += 1
                    self.logger.log(
                        n * S, queue=max(st.depth for st in stagers)
                    )
                    if (
                        self.checkpoint_path
                        and steps % self.checkpoint_every == 0
                    ):
                        drainer.flush()
                        jax.block_until_ready(carry.bg)
                        if use_log:
                            for rl in rlogs:
                                rl.flush()
                        self._save_checkpoint(carry, rows_state(), cfg)
            drainer.close()
            # same padded-tail rule as StreamingPipeline: never persist a
            # carry perturbed by pad frames
            if self.checkpoint_path and last_n == cfg.batch:
                jax.block_until_ready(carry.bg)
                if use_log:
                    for rl in rlogs:
                        rl.flush()
                self._save_checkpoint(carry, rows_state(), cfg)
        except BaseException:
            drainer.kill()  # see StreamingPipeline.run: never leave the
            if use_log:     # thread racing a resumed run's row state
                for rl in rlogs:
                    rl.close()
            raise
        finally:
            for st in stagers:
                st.close()

        rows_by_stream = finish()
        merged = merge_stream_rows(rows_by_stream, with_stream=True)
        if export_dir:
            from tpuva.export.hdf5io import (
                write_multistream_hdf5,
                write_tracks_hdf5,
            )

            os.makedirs(export_dir, exist_ok=True)
            for s, rows in enumerate(rows_by_stream):
                write_tracks_hdf5(
                    os.path.join(export_dir, f"stream_{s}.h5"), rows
                )
            write_multistream_hdf5(
                os.path.join(export_dir, "merged.h5"), merged
            )
        return rows_by_stream, merged

    def _save_checkpoint(self, carry, rows_state, cfg):
        """Seam for fault-injection tests; checkpoints the stacked carry
        plus the rows drained so far (embedded lists, or per-stream
        durable RowLog counts in row-log mode)."""
        save_multistream_checkpoint(
            self.checkpoint_path, carry, rows_state, cfg
        )
