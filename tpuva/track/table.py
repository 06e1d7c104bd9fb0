"""Fixed-capacity track table as `lax.scan` carry (components G/H/I,
SURVEY.md §2.3, §3.3).

The reference keeps a Python list of Track objects updated per frame on the
host; here the tracker is a static-shape pytree living on device, updated
inside the scan over the frame axis so tracker state never leaves the chip
(BASELINE.json:5 "tracker state stays on-device").

Layout invariant (perf): the table mirrors the reference's LIST directly —
active tracks occupy exactly slots [0, n_active) in ascending-id
(= insertion) order; free slots hold pos=0, tid=0, missed=0. Deaths
compact the survivors down and births append at the end, so the
per-frame rank/sort/permute that an arbitrary-slot table would need to
recover the reference's cost-row order disappears from the hot scan body.
The compaction runs UNCONDITIONALLY (straightline=True default): it is
the bit-exact identity on no-death frames under the invariant, and the
lax.cond that used to skip it costs more per-step control sequencing
than the masked sums it saves (measured both ways, bench/track_exp.py:
5.34 vs 5.99 ms/batch-256 on the bench-like sequence, neutral on a
death-churn sequence; straightline=False restores the cond).
init_track_state establishes the invariant; track_update preserves it.
(The TrackState slot layout is internal: checkpoints store it wholesale
and restore it wholesale, so the invariant survives kill+resume, but
checkpoints from builds predating it are not interchangeable.)

Semantics replicate refimpl.tracker.Tracker exactly, including:
- cost rows ordered by track insertion order (track ids are monotonically
  increasing, and the layout invariant keeps slots in id order — this
  matters for greedy tie-breaks);
- deaths (missed >= death_patience after aging) free their slots *before*
  births are placed, matching the reference's list compaction;
- births take detections in detection order while capacity remains;
- a trajectory row is emitted per matched or birthed detection:
  (track_id, frame, x, y, area).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tpuva.track.assign import BIG, greedy_assign, hungarian_assign


class TrackState(NamedTuple):
    pos: jnp.ndarray  # (MAX_TRACKS, 2) float32 — last known (x, y)
    tid: jnp.ndarray  # (MAX_TRACKS,) int32 — track id, 0 if slot free
    missed: jnp.ndarray  # (MAX_TRACKS,) int32 — consecutive unmatched frames
    active: jnp.ndarray  # (MAX_TRACKS,) bool
    next_id: jnp.ndarray  # () int32 — next id to assign (ids start at 1)


def init_track_state(max_tracks: int) -> TrackState:
    return TrackState(
        pos=jnp.zeros((max_tracks, 2), jnp.float32),
        tid=jnp.zeros((max_tracks,), jnp.int32),
        missed=jnp.zeros((max_tracks,), jnp.int32),
        active=jnp.zeros((max_tracks,), bool),
        next_id=jnp.int32(1),
    )


def track_update(
    state: TrackState,
    dets: jnp.ndarray,  # (D, 3) float32 (x, y, area)
    det_valid: jnp.ndarray,  # (D,) bool
    frame_idx,  # int32 scalar
    max_dist: float,
    death_patience: int,
    assigner: str = "greedy",
    straightline: bool = True,
):
    """One tracker step. Returns (new_state, rows (D, 5) float32,
    row_valid (D,) bool). Row = (track_id, frame, x, y, area).

    Exact-export note: rows carry the float32 centroid; the pipeline
    additionally forwards the detections' integer coordinate sums
    (extract_detections det_sums) so hosts can redo the centroid division
    in float64, bit-identical to cv2.

    Perf note: this step runs once per frame inside the device scan, so
    its op count dominates tracker cost. Everything is expressed as
    iota-compare selects, tiny reductions, and one-hot f32 matmuls — no
    sort, no scatter, no searchsorted (each ~10x the cost of a fused
    elementwise op at this size). Frames with zero detections take a
    cheap age-and-reap branch via lax.cond."""
    T = state.pos.shape[0]
    D = dets.shape[0]
    ti = jnp.arange(T, dtype=jnp.int32)

    def compact(still, pos, tid, missed):
        """Permute survivors down to slots [0, n_still) preserving order
        (the reference's list compaction). Masked one-term sums — each
        output row sums exactly one selected source (0 + x == x in f32),
        so positions move bit-exactly; freed slots come out as
        pos=0/tid=0/missed=0, which re-establishes the free-slot part of
        the layout invariant. NOT a f32 matmul: a default-precision
        f32 matmul may round its operands (TF32 on a GPU keeps 10
        mantissa bits; CLAUDE.md invariant), positions are not exact in
        fewer bits, and this path only runs on death frames, which few
        scenes exercise — a silent association hazard the masked sum
        removes."""
        s32 = still.astype(jnp.int32)
        srank = jnp.cumsum(s32) - s32  # (T,) 0-based target of survivors
        om = still[None, :] & (srank[None, :] == ti[:, None])  # (new, old)
        pos_c = jnp.sum(
            jnp.where(om[:, :, None], pos[None, :, :], 0.0), axis=1
        )
        tid_c = jnp.sum(jnp.where(om, tid[None, :], 0), axis=1)
        missed_c = jnp.sum(jnp.where(om, missed[None, :], 0), axis=1)
        return pos_c, tid_c.astype(jnp.int32), missed_c.astype(jnp.int32)

    def update_with_dets(state: TrackState):
        # layout invariant (module docstring): active slots are exactly
        # [0, n_active) in id order, so the cost rows ARE the reference's
        # list order — no rank/sort/permute in the common frame.
        n_active = jnp.sum(state.active.astype(jnp.int32))

        # ---- cost matrix (slot order == reference list order)
        dx = state.pos[:, 0:1] - dets[None, :, 0].reshape(1, D)
        dy = state.pos[:, 1:2] - dets[None, :, 1].reshape(1, D)
        cost = jnp.sqrt(dx * dx + dy * dy).reshape(T, D)
        pairable = state.active[:, None] & det_valid[None, :]
        cost = jnp.where(pairable, cost, BIG)
        assign = hungarian_assign if assigner == "hungarian" else greedy_assign
        slot_for_det = assign(cost, max_dist)  # (D,) slot == list index
        det_matched = slot_for_det >= 0

        # ---- matched updates (eq2[t, j] == slot t matched detection j)
        eq2 = (slot_for_det[None, :] == ti[:, None]) & det_matched[None, :]
        slot_matched = jnp.any(eq2, axis=1)
        # one-term masked sum, NOT a f32 matmul: a default-precision f32
        # matmul may round detection coordinates (TF32, CLAUDE.md
        # invariant) — the carried prediction must be the exact detection
        # position
        matched_pos = jnp.sum(
            jnp.where(eq2[:, :, None], dets[None, :, :2], 0.0), axis=1
        )
        pos = jnp.where(slot_matched[:, None], matched_pos, state.pos)
        missed = jnp.where(
            slot_matched,
            0,
            jnp.where(state.active, state.missed + 1, state.missed),
        )

        # ---- trajectory rows for matches: a matched slot always
        # survives (missed just reset to 0), so its tid is final here
        row_tid_matched = jnp.sum(
            jnp.where(eq2, state.tid[:, None], 0), axis=0
        )

        # ---- deaths compact the survivors down (free slots before
        # births, like the reference's list compaction); no-death frames
        # skip the permutation entirely
        still = state.active & (missed < death_patience)
        n_still = jnp.sum(still.astype(jnp.int32))
        if straightline:
            # compact is the identity on no-death frames under the
            # layout invariant (srank == slot for every survivor and
            # free slots are already zeroed), so running it
            # unconditionally is bit-equal — the cond's per-step control
            # sequencing is what it saves (measured: bench/track_exp.py)
            pos, tid, missed = compact(still, pos, state.tid, missed)
        else:
            pos, tid, missed = lax.cond(
                n_still < n_active,
                lambda a: compact(still, *a),
                lambda a: a,
                (pos, state.tid, missed),
            )

        # ---- births: the r-th birthable detection appends at slot
        # n_still + r - 1 (ids are monotone, so appending preserves the
        # id-sorted invariant)
        birth_det = det_valid & ~det_matched
        birth_rank = jnp.cumsum(birth_det.astype(jnp.int32))  # (D,) 1-based
        can_birth = birth_det & (n_still + birth_rank <= T)
        slot_for_birth = n_still + birth_rank - 1
        new_tid_for_det = jnp.where(
            can_birth, state.next_id - 1 + birth_rank, 0
        ).astype(jnp.int32)

        bo = (slot_for_birth[None, :] == ti[:, None]) & can_birth[None, :]
        has_b = jnp.any(bo, axis=1)
        birth_pos = jnp.sum(
            jnp.where(bo[:, :, None], dets[None, :, :2], 0.0), axis=1
        )  # masked sum, not f32 matmul (see matched_pos)
        pos = jnp.where(has_b[:, None], birth_pos, pos)
        tid = jnp.where(
            has_b,
            jnp.sum(jnp.where(bo, new_tid_for_det[None, :], 0), axis=1),
            tid,
        )
        # births land past n_still, where compaction (or the standing
        # invariant) already zeroed missed
        n_births = jnp.sum(can_birth.astype(jnp.int32))
        active = ti < n_still + n_births
        next_id = state.next_id + n_births

        new_state = TrackState(
            pos=pos, tid=tid, missed=missed, active=active, next_id=next_id
        )

        # ---- trajectory rows, one per matched-or-birthed detection
        row_tid = jnp.where(det_matched, row_tid_matched, new_tid_for_det)
        row_valid = det_matched | can_birth
        return new_state, row_tid, row_valid

    def update_no_dets(state: TrackState):
        # age active tracks, reap deaths (compacting, same as above);
        # no assignment, no births
        missed = jnp.where(state.active, state.missed + 1, state.missed)
        still = state.active & (missed < death_patience)
        n_active = jnp.sum(state.active.astype(jnp.int32))
        n_still = jnp.sum(still.astype(jnp.int32))
        if straightline:
            pos, tid, missed = compact(still, state.pos, state.tid, missed)
        else:
            pos, tid, missed = lax.cond(
                n_still < n_active,
                lambda a: compact(still, *a),
                lambda a: a,
                (state.pos, state.tid, missed),
            )
        # free slots already hold missed=0: compaction zeroes them in the
        # death branch, the standing invariant covers the no-death branch
        new_state = TrackState(
            pos=pos,
            tid=tid,
            missed=missed,
            active=ti < n_still,
            next_id=state.next_id,
        )
        return new_state, jnp.zeros((D,), jnp.int32), jnp.zeros((D,), bool)

    if straightline:
        # an all-invalid frame degenerates update_with_dets to exactly
        # update_no_dets's transition (cost all-BIG takes the assigner's
        # trivial fast path, no matches, no births, rows invalid), so
        # the empty-frame cond is also pure control overhead
        new_state, row_tid, row_valid = update_with_dets(state)
    else:
        new_state, row_tid, row_valid = jax.lax.cond(
            jnp.any(det_valid), update_with_dets, update_no_dets, state
        )
    rows = jnp.stack(
        [
            row_tid.astype(jnp.float32),
            jnp.full((D,), 0, jnp.float32) + jnp.float32(frame_idx),
            dets[:, 0],
            dets[:, 1],
            dets[:, 2],
        ],
        axis=-1,
    )
    return new_state, rows, row_valid


def track_update_straightline(state, dets, det_valid, frame_idx,
                              max_dist, death_patience,
                              assigner: str = "greedy"):
    """track_update with the death-compaction cond replaced by an
    unconditional (bit-equal) compact — see the straightline flag."""
    return track_update(
        state, dets, det_valid, frame_idx, max_dist, death_patience,
        assigner=assigner, straightline=True,
    )
