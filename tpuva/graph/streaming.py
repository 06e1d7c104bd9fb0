"""Streamed long-video processing with checkpoint/resume (component J +
SURVEY.md §5.3/§5.4; config 4, BASELINE.json:10).

The reference's recovery story was pass-level: each pass wrote its full
HDF5 result and a crashed job was rerun from the last pass boundary. The
rebuild checkpoints the scan carry (background model, track table, frame
index — all the sequential state there is) every K batches, so a 100k+
frame job resumes at batch granularity: restore the carry, seek the video,
continue. Decode is overlapped with device compute via BatchStager;
host memory stays bounded by the stager queue.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpuva.graph.config import PipelineConfig
from tpuva.graph.pipeline import (
    PipelineCarry,
    collect_rows_array,
    init_carry,
    process_batch,
)
from tpuva.io.base import VideoBase
from tpuva.io.staging import BatchStager
from tpuva.track.table import TrackState
from tpuva.utils import BatchLogger, hot_loop_transfer_guard


class RowLog:
    """Append-only binary trajectory-row store: float64 (k, 5) records of
    (track_id, frame, x, y, area).

    For unbounded streams (SURVEY §5.4): checkpointing previously
    re-serialized the FULL row history into every snapshot — O(rows²)
    cumulative IO over a long run, plus unbounded host RAM. With a
    RowLog, drained rows are appended once and the checkpoint stores only
    the durable row COUNT; resume truncates the log back to that count
    (discarding rows written after the snapshot), keeping checkpoint IO
    O(new rows) and host memory O(batch)."""

    RECORD = 5 * 8  # five float64 columns

    def __init__(self, path: str):
        self.path = path
        # create if missing, keep existing contents (resume truncates)
        self._fh = open(path, "ab")

    def append(self, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(np.asarray(arr, np.float64).reshape(-1, 5))
        self._fh.write(a.tobytes())

    def flush(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def count(self) -> int:
        self._fh.flush()
        return os.path.getsize(self.path) // self.RECORD

    def truncate(self, n_rows: int) -> None:
        self._fh.flush()
        self._fh.truncate(n_rows * self.RECORD)

    def read(self) -> np.ndarray:
        self._fh.flush()
        data = np.fromfile(self.path, dtype=np.float64)
        return data.reshape(-1, 5)

    def close(self) -> None:
        self._fh.close()


class AsyncRowDrainer:
    """Overlapped device-output collection: pack each batch's trajectory
    outputs into ONE flat f32 device buffer, fetch groups of them on a
    consumer thread, and hand the decoded per-batch records to a
    `consume` callback in submission order.

    Why: a naive drain fetches rows / row_valid / row_sums /
    stats_overflow / active_tracks as separate transfers and blocks the
    dispatch loop while doing it, once per batch. Packing makes a group
    one transfer; the thread makes it overlap device compute.

    Works for any leading batch shape: single-stream outputs are
    (N, K, ...) and multi-stream outputs are (S, N, K, ...); the shape is
    taken from the first submit and records are decoded back to it.

    Layout per batch, with B = prod(batch_shape) (batch_shape =
    rows.shape[:-1]) and F = prod(batch_shape[:-1]) frames:
      [B*5 rows f32] [B row_valid 0/1] [B*2 row_sums hi16]
      [B*2 row_sums lo16] [F stats_overflow] [1 active_tracks]
    row_sums are int32 split into two 16-bit halves, each carried as an
    exact small-integer f32 VALUE (0..65535 < 2^24). Raw int32 bit
    patterns bitcast into f32 would be denormals and NaNs, which a device
    may flush or canonicalize in any op that touches them. The halves
    round-trip exactly, so the exact-integer-centroid contract
    (collect_rows_array, byte-identical exports) is preserved.

    `consume(rec, n)` receives a dict of decoded NUMPY arrays — "rows"
    (*batch_shape, 5) f32, "row_valid" batch_shape bool, "row_sums"
    (*batch_shape, 2) int32, "active_tracks" int, plus "stats_overflow"
    batch_shape[:-1] int32 when the producer emitted it — and the batch's valid frame count n along the frame
    axis (a padded tail batch has n < N; the consumer slices). It runs
    on the drainer thread.

    The bounded group queue doubles as dispatch-depth backpressure:
    submit() blocks while `maxsize` groups are already in flight, so the
    producer can run at most (maxsize+1) groups of batches ahead of
    device execution (a deep dispatch queue pins every queued batch's
    input frames on device and thrashes the allocator).

    Consumer-thread exceptions (e.g. a strict-mode overflow error raised
    by `consume`) are re-raised at the next submit()/flush()/close() —
    i.e. a strict error surfaces within about one group of batches of
    the offending frame.
    """

    def __init__(self, consume, group: int = 4,
                 max_groups_in_flight: int = 1):
        import queue as _queue
        import threading

        self._consume = consume
        self._group = max(1, int(group))
        self._q: "_queue.Queue" = _queue.Queue(
            maxsize=max(1, int(max_groups_in_flight))
        )
        self._cur: list = []  # list of (n, packed device vec)
        self._dead = False
        self._exc: Optional[BaseException] = None
        self._pack = None
        self._meta = None  # (bshape, has_overflow)
        self.active_tracks = 0
        # blocking/latency telemetry (seconds; producer-side block in
        # submit/flush, consumer-side device fetch and host decode)
        self.stats = {"submit_block_s": 0.0, "flush_block_s": 0.0,
                      "fetch_s": 0.0, "decode_s": 0.0, "groups": 0}
        self._thread = threading.Thread(
            target=self._run, name="tpuva-row-drainer", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ producer
    def submit(self, out: dict, n: Optional[int] = None) -> None:
        """Queue one batch's output dict (device arrays; only the small
        trajectory fields are touched — masks etc. are ignored). n is the
        batch's valid frame count (None = all)."""
        self._raise_pending()
        if self._pack is None:
            bshape = tuple(out["rows"].shape[:-1])
            self._meta = (bshape, "stats_overflow" in out)
            self._pack = self._make_pack(*self._meta)
        if n is None:
            n = self._meta[0][-2]  # frame axis extent
        self._cur.append((int(n), self._pack(out)))
        if len(self._cur) >= self._group:
            t0 = time.perf_counter()
            self._q.put(self._cur)
            self.stats["submit_block_s"] += time.perf_counter() - t0
            self._cur = []

    def flush(self) -> None:
        """Block until every submitted batch has been decoded and written
        to the sink (call before checkpointing on the sink's state)."""
        t0 = time.perf_counter()
        if self._cur:
            self._q.put(self._cur)
            self._cur = []
        self._q.join()
        self.stats["flush_block_s"] += time.perf_counter() - t0
        self._raise_pending()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def kill(self) -> None:
        """Abandon all queued work WITHOUT writing it to the sink and stop
        the thread — for simulated-crash paths that reopen the same sink
        (a real kill takes the thread down with the process; an in-process
        abort must not leave it racing the resumed run's log writes)."""
        self._dead = True
        self._cur = []
        self._q.put(None)  # consumer drops groups when dead, unblocks fast
        self._thread.join()

    # ------------------------------------------------------------ consumer
    def _run(self) -> None:
        while True:
            grp = self._q.get()
            if grp is None:
                self._q.task_done()
                return
            try:
                if self._exc is None and not self._dead:
                    self._decode(grp)
            except BaseException as e:  # surfaced at next producer call
                self._exc = e
            finally:
                self._q.task_done()

    def _decode(self, grp: list) -> None:
        bshape, has_ov = self._meta
        B = int(np.prod(bshape))
        F = int(np.prod(bshape[:-1]))
        ns = [n for n, _ in grp]
        t0 = time.perf_counter()
        # ONE round trip, via EXPLICIT device_get (transfer_guard-clean)
        buf = np.asarray(jax.device_get(jnp.stack([p for _, p in grp])))
        t1 = time.perf_counter()
        self.stats["fetch_s"] += t1 - t0
        self.stats["groups"] += 1
        P = buf.shape[0]
        c0 = B * 5
        c1 = c0 + B
        ch = c1 + B * 2
        c2 = ch + B * 2
        rows = buf[:, :c0].reshape((P,) + bshape + (5,))
        valid = buf[:, c0:c1].reshape((P,) + bshape) != 0.0
        hi = buf[:, c1:ch].astype(np.uint32)
        lo = buf[:, ch:c2].astype(np.uint32)
        sums = ((hi << 16) | lo).astype(np.uint32).view(np.int32)
        sums = sums.reshape((P,) + bshape + (2,))
        if has_ov:
            overflow = buf[:, c2:c2 + F].astype(np.int32)
            overflow = overflow.reshape((P,) + bshape[:-1])
        else:
            overflow = None
        for i in range(P):
            rec = {
                "rows": rows[i],
                "row_valid": valid[i],
                "row_sums": sums[i],
                "active_tracks": int(buf[i, -1]),
            }
            if has_ov:
                rec["stats_overflow"] = overflow[i]
            self.active_tracks = rec["active_tracks"]
            self._consume(rec, ns[i])
        self.stats["decode_s"] += time.perf_counter() - t1

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    @staticmethod
    def _make_pack(bshape: tuple, has_overflow: bool):
        F = int(np.prod(bshape[:-1]))

        @jax.jit
        def pack(out):
            r = out["rows"].astype(jnp.float32).reshape(-1)
            v = out["row_valid"].reshape(-1).astype(jnp.float32)
            # int32 -> (hi16, lo16) exact f32 values; see class docstring
            # for why a raw bitcast is unsafe
            u = out["row_sums"].astype(jnp.int32).astype(jnp.uint32)
            hi = (u >> 16).astype(jnp.float32).reshape(-1)
            lo = (u & jnp.uint32(0xFFFF)).astype(jnp.float32).reshape(-1)
            parts = [r, v, hi, lo]
            if has_overflow:
                parts.append(
                    out["stats_overflow"].astype(jnp.float32).reshape(-1)
                )
            else:
                parts.append(jnp.zeros((F,), jnp.float32))
            # per-stream counts sum to one scalar (multistream emits
            # shape-(S,) active_tracks; single-stream a scalar)
            parts.append(
                jnp.sum(
                    out.get("active_tracks", jnp.int32(0))
                ).astype(jnp.float32).reshape(1)
            )
            return jnp.concatenate(parts)

        def run(out):
            small = {
                k: out[k]
                for k in (
                    "rows", "row_valid", "row_sums", "stats_overflow",
                    "active_tracks",
                )
                if k in out
            }
            return pack(small)

        return run


def save_checkpoint(path: str, carry: PipelineCarry, rows,
                    cfg: PipelineConfig) -> None:
    """Atomic snapshot of the scan carry + rows so far (npz).

    rows: list of tuples or (k, 5) ndarray — embedded in the snapshot;
    or an int — the durable row COUNT of an external RowLog (the
    append-only mode; the snapshot then stays O(carry))."""
    # EXPLICIT device_get: checkpointing is a designated host<->device
    # boundary and must stay legal inside hot_loop_transfer_guard scopes
    payload = {
        "bg": np.asarray(jax.device_get(carry.bg)),
        "bg_valid": np.asarray(jax.device_get(carry.bg_valid)),
        "frame_idx": np.asarray(jax.device_get(carry.frame_idx)),
        "track_pos": np.asarray(jax.device_get(carry.track.pos)),
        "track_tid": np.asarray(jax.device_get(carry.track.tid)),
        "track_missed": np.asarray(jax.device_get(carry.track.missed)),
        "track_active": np.asarray(jax.device_get(carry.track.active)),
        "track_next_id": np.asarray(jax.device_get(carry.track.next_id)),
        "config_json": np.frombuffer(
            cfg.to_json().encode(), dtype=np.uint8
        ),
    }
    if isinstance(rows, (int, np.integer)):
        payload["row_count"] = np.int64(rows)
    else:
        payload["rows"] = np.asarray(rows, np.float64).reshape(-1, 5)
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


def load_checkpoint(path: str, cfg: PipelineConfig):
    """Returns (carry, rows) or raises. Validates the config matches.

    rows is a list of tuples (embedded-rows snapshots) or an int row
    count (append-only RowLog snapshots — truncate the log to it)."""
    z = np.load(path)
    saved_cfg = bytes(z["config_json"]).decode()
    if PipelineConfig.from_json(saved_cfg) != cfg:
        raise ValueError(
            "checkpoint was produced with a different PipelineConfig"
        )
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
    if "row_count" in z:
        return carry, int(z["row_count"])
    rows = [tuple(r) for r in z["rows"]]
    return carry, rows


def _as_tuples(chunks: list) -> list:
    """(k, 5) float64 arrays -> legacy (int, int, float, float, float)
    row tuples."""
    return [
        (int(r[0]), int(r[1]), float(r[2]), float(r[3]), float(r[4]))
        for arr in chunks
        for r in arr
    ]


class StreamingPipeline:
    """Drive a video of any length through the batched device pipeline.

    - decode -> staging -> device compute 3-stage overlap (SURVEY.md §2.4 PP)
    - carry stays on device between batches
    - optional periodic checkpointing + resume
    - structured per-batch progress logging (fps, queue depth, SURVEY §5.5)

    parallel_bg defaults to False: the associative-scan background reorders
    float accumulation and is NOT bit-identical to the sequential/refimpl
    ordering — the byte-identical-export invariant holds only on the
    default path. Opt in for throughput when exact replay isn't required.

    row_log_path enables the append-only unbounded-stream mode: drained
    rows stream to a RowLog file instead of host RAM, checkpoints store
    only the durable row count (O(carry) snapshots instead of rewriting
    the full history), and run() returns the (k, 5) float64 row array
    read back from the log.
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,  # batches
        parallel_bg: bool = False,
        max_components: int = 64,
        queue_depth: int = 3,
        log: bool = False,
        row_log_path: Optional[str] = None,
    ):
        self.cfg = cfg
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.parallel_bg = parallel_bg
        self.max_components = max_components
        self.queue_depth = queue_depth
        self.row_log_path = row_log_path
        self.active_tracks = 0  # last drained end-of-batch count
        self.logger = BatchLogger(enabled=log)

    # --- mesh-placement hooks (identity on the single-chip path).
    # SpatialStreamPipeline (tpuva.dist.pipeline) overrides these to run
    # the SAME driver — checkpoints, resume, RowLog, AsyncRowDrainer,
    # transfer-guard discipline — over a ('space',) row-band mesh.
    def _place_carry(self, carry):
        return carry

    def _place_frames(self, frames):
        return frames

    def _make_stager(self, source):
        return BatchStager(
            source, self.cfg.batch, queue_depth=self.queue_depth
        )

    def _step(self, cfg, carry, dev_batch):
        return process_batch(
            cfg,
            carry,
            dev_batch,
            parallel_bg=self.parallel_bg,
            max_components=self.max_components,
        )

    def warmup(self, H: int, W: int) -> None:
        """Compile (or load from the persistent cache) every device
        program run() will dispatch for (H, W) frames, and block until
        ready. Uses a throwaway carry and zero frames — no pipeline state
        is touched. Call before latency-sensitive streaming: program
        trace + compile-cache load can cost tens of seconds and would
        otherwise stall the first batch mid-stream."""
        cfg = self.cfg
        carry = self._place_carry(init_carry(cfg, H, W))
        frames = self._place_frames(jnp.zeros((cfg.batch, H, W), jnp.uint8))
        _carry, out = self._step(cfg, carry, frames)
        jax.block_until_ready(out["rows"])

    def run(
        self,
        video: VideoBase,
        background0: Optional[np.ndarray] = None,
        resume: bool = True,
    ):
        """Process the whole video; returns trajectory rows — a list of
        (tid, frame, x, y, area) tuples, or a (k, 5) float64 array in
        row_log mode. If a checkpoint exists (and resume=True), continues
        from it."""
        cfg = self.cfg
        W, H = video.size
        chunks: list = []  # list of (k, 5) float64 arrays
        rlog: Optional[RowLog] = None  # opened only after mode validation
        carry = self._place_carry(init_carry(cfg, H, W, background0))
        start_frame = 0
        if (
            resume
            and self.checkpoint_path
            and os.path.exists(self.checkpoint_path)
        ):
            carry, saved = load_checkpoint(self.checkpoint_path, cfg)
            carry = self._place_carry(carry)
            if isinstance(saved, int):
                if not self.row_log_path:
                    raise ValueError(
                        "checkpoint stores a RowLog count but no "
                        "row_log_path was given"
                    )
                rlog = RowLog(self.row_log_path)
                rlog.truncate(saved)
            else:
                if self.row_log_path:
                    raise ValueError(
                        "checkpoint embeds rows but row_log_path is set"
                    )
                chunks = [np.asarray(saved, np.float64).reshape(-1, 5)]
            start_frame = int(carry.frame_idx)
        if self.row_log_path and rlog is None:
            # fresh (non-resume) run: rows left in the log from a previous
            # run would silently duplicate into this run's results —
            # start the log clean.
            rlog = RowLog(self.row_log_path)
            rlog.truncate(0)

        def rows_state():
            return rlog.count() if rlog is not None else np.concatenate(
                chunks, axis=0
            ) if chunks else np.zeros((0, 5))

        total = video.frame_count
        if start_frame >= total:
            if rlog is not None:
                out = rlog.read()
                rlog.close()
                return out
            return _as_tuples(chunks)
        source = video[start_frame:] if start_frame else video
        stager = self._make_stager(source)

        def consume(rec, n):
            # runs on the drainer thread, in submission order
            self._check_capacity(rec, n)
            self.active_tracks = int(rec["active_tracks"])
            arr = collect_rows_array(
                rec["rows"][:n], rec["row_valid"][:n],
                row_sums=rec["row_sums"][:n],
            )
            if rlog is not None:
                rlog.append(arr)
            else:
                chunks.append(arr)

        # grouped async collection off-thread: ~1 device round trip per
        # `group` batches, overlapped with dispatch (AsyncRowDrainer).
        # ~2048 frames per group; the size is untuned on the GPU.
        drainer = AsyncRowDrainer(
            consume, group=max(2, 2048 // cfg.batch),
            max_groups_in_flight=1,
        )
        batches_done = 0
        last_n = cfg.batch
        try:
            # transfer_guard discipline (SURVEY.md §5.8): inside the hot
            # loop every host<->device crossing is explicit (device_put in
            # the stager, device_get in the drainer and checkpoints); an
            # accidental implicit transfer raises instead of silently
            # stalling dispatch.
            with hot_loop_transfer_guard():
                for n, dev_batch in stager:
                    carry, out = self._step(cfg, carry, dev_batch)
                    drainer.submit(out, n)
                    last_n = n
                    batches_done += 1
                    self.logger.log(
                        n, queue=stager.depth,
                        tracks=self.active_tracks,
                    )
                    if (
                        self.checkpoint_path
                        and batches_done % self.checkpoint_every == 0
                    ):
                        drainer.flush()
                        jax.block_until_ready(carry.bg)
                        if rlog is not None:
                            rlog.flush()
                        save_checkpoint(
                            self.checkpoint_path, carry, rows_state(), cfg
                        )
            drainer.close()
            # a padded tail batch perturbs the carry past the stream end
            # (repeated pad frames enter the background model / tracker):
            # persisting it would poison a resume against a later-appended
            # video, so the final checkpoint is skipped in that case and
            # the last periodic checkpoint remains authoritative.
            if self.checkpoint_path and last_n == cfg.batch:
                jax.block_until_ready(carry.bg)
                if rlog is not None:
                    rlog.flush()
                save_checkpoint(
                    self.checkpoint_path, carry, rows_state(), cfg
                )
        except BaseException:
            drainer.kill()  # don't leave the thread racing the sink (a
            if rlog is not None:  # resumed run may reopen the same RowLog
                rlog.close()
            raise
        finally:
            stager.close()
        if rlog is not None:
            out = rlog.read()
            rlog.close()
            return out
        return _as_tuples(chunks)

    def _check_capacity(self, out: dict, n: int) -> None:
        """Hook for drivers whose device step reports capacity overflow
        (SpatialStreamPipeline); the single-device step has none."""
