"""Reference-equivalent blob tracker (components G/H, SURVEY.md §2.3).

Semantics pinned here are the contract the device scan tracker
(tpuva.track) must reproduce exactly:

- detections arrive per frame as (x, y, area) tuples in CCL label order
  (raster-scan first-appearance, SURVEY.md §8), already area-filtered and
  capped at max_blobs;
- cost = Euclidean distance between a track's last known position and a
  detection (no velocity model);
- assignment: 'greedy' repeatedly takes the globally cheapest remaining
  (track, det) pair with cost <= max_dist, ties broken by lowest
  (track_index, det_index); 'hungarian' solves min-cost assignment
  (scipy.optimize.linear_sum_assignment, SURVEY.md §3.3) then voids pairs
  with cost > max_dist;
- matched track: position <- detection, missed <- 0, emit a trajectory row;
- unmatched detection (in det order): new track with the next id (ids start
  at 1), emits its first row;
- unmatched track: missed += 1; when missed >= death_patience the track is
  closed (no row emitted for missed frames).
"""

from __future__ import annotations

import numpy as np

from tpuva.graph.config import TrackConfig


class Track:
    __slots__ = ("id", "x", "y", "missed", "birth")

    def __init__(self, tid, x, y, frame):
        self.id = tid
        self.x = x
        self.y = y
        self.missed = 0
        self.birth = frame


def greedy_assign(cost: np.ndarray, max_dist: float):
    """Returns list of (track_idx, det_idx) matches."""
    n_t, n_d = cost.shape
    cost = cost.copy()
    matches = []
    BIG = np.inf
    while True:
        flat = np.argmin(cost) if cost.size else 0
        if cost.size == 0:
            break
        i, j = divmod(int(flat), n_d)
        if not np.isfinite(cost[i, j]) or cost[i, j] > max_dist:
            break
        matches.append((i, j))
        cost[i, :] = BIG
        cost[:, j] = BIG
    return matches


def hungarian_assign(cost: np.ndarray, max_dist: float):
    from scipy.optimize import linear_sum_assignment

    if cost.size == 0:
        return []
    rows, cols = linear_sum_assignment(cost)
    return [(int(i), int(j)) for i, j in zip(rows, cols) if cost[i, j] <= max_dist]


class Tracker:
    def __init__(self, cfg: TrackConfig):
        self.cfg = cfg
        self.active: list[Track] = []
        self.next_id = 1
        self.rows: list[tuple] = []  # (track_id, frame, x, y, area)

    def update(self, frame: int, dets):
        """dets: sequence of (x, y, area)."""
        cfg = self.cfg
        n_t, n_d = len(self.active), len(dets)
        cost = np.full((n_t, n_d), np.inf)
        for i, tr in enumerate(self.active):
            for j, (x, y, _a) in enumerate(dets):
                cost[i, j] = np.hypot(tr.x - x, tr.y - y)
        if cfg.assigner == "hungarian":
            matches = hungarian_assign(cost, cfg.max_dist)
        else:
            matches = greedy_assign(cost, cfg.max_dist)

        matched_t = {i for i, _ in matches}
        matched_d = {j for _, j in matches}
        for i, j in matches:
            tr = self.active[i]
            x, y, a = dets[j]
            tr.x, tr.y, tr.missed = x, y, 0
            self.rows.append((tr.id, frame, x, y, a))
        # deaths: only pre-existing unmatched tracks age
        survivors = []
        for i, tr in enumerate(self.active):
            if i not in matched_t:
                tr.missed += 1
            if tr.missed < cfg.death_patience:
                survivors.append(tr)
        self.active = survivors
        # births, in detection order (after deaths free their table slots)
        for j, (x, y, a) in enumerate(dets):
            if j in matched_d:
                continue
            if len(self.active) >= cfg.max_tracks:
                continue  # table full: detection dropped (static capacity)
            tr = Track(self.next_id, x, y, frame)
            self.next_id += 1
            self.active.append(tr)
            self.rows.append((tr.id, frame, x, y, a))
