"""Trajectory HDF5 export (component I, SURVEY.md §2.3; BASELINE.json:10).

Layout (deterministic; same writer used by refimpl and the device pipeline):
  /trajectories : (N, 5) float64, rows sorted by (track_id, frame),
                  columns attr = ['track_id','frame','x','y','area']
  /tracks       : (K, 4) float64 summary, one row per track:
                  (track_id, first_frame, last_frame, n_points)
Matches the reference's pass-output style: each pass persists its full
result to HDF5 for the next pass (SURVEY.md §5.4).
"""

from __future__ import annotations

import numpy as np

COLUMNS = ["track_id", "frame", "x", "y", "area"]


def _as_table(rows) -> np.ndarray:
    rows = sorted(rows, key=lambda r: (int(r[0]), int(r[1])))
    if not rows:
        return np.zeros((0, 5), np.float64)
    tab = np.array(
        [
            (int(t), int(f), float(x), float(y), float(int(round(a))))
            for t, f, x, y, a in rows
        ],
        np.float64,
    )
    # quantize x/y the same way the CSV writer does so the two export paths
    # stay value-identical
    tab[:, 2:4] = np.round(tab[:, 2:4], 3)
    return tab


def write_tracks_hdf5(path, rows) -> None:
    import h5py

    tab = _as_table(rows)
    ids = np.unique(tab[:, 0]) if len(tab) else np.zeros(0)
    summary = np.zeros((len(ids), 4), np.float64)
    for k, tid in enumerate(ids):
        sel = tab[tab[:, 0] == tid]
        summary[k] = (tid, sel[:, 1].min(), sel[:, 1].max(), len(sel))
    with h5py.File(path, "w", track_order=False) as f:
        d = f.create_dataset("trajectories", data=tab)
        d.attrs["columns"] = COLUMNS
        f.create_dataset("tracks", data=summary)


def read_tracks_hdf5(path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f["trajectories"][...]


MS_COLUMNS = ["stream", "track_id", "frame", "x", "y", "area"]


def write_multistream_hdf5(path, merged_rows) -> None:
    """Config-5 merged export (BASELINE.json:11): 6-column trajectories
    with stream provenance, rows ordered (stream, track_id, frame) —
    stream-major, then the single-stream exporters' (track_id, frame)
    order, so per-stream slices are value-identical to the per-stream
    files."""
    import h5py

    rows = sorted(merged_rows, key=lambda r: (int(r[0]), int(r[1]), int(r[2])))
    if rows:
        tab = np.array(
            [
                (int(s), int(t), int(f), float(x), float(y),
                 float(int(round(a))))
                for s, t, f, x, y, a in rows
            ],
            np.float64,
        )
        tab[:, 3:5] = np.round(tab[:, 3:5], 3)
    else:
        tab = np.zeros((0, 6), np.float64)
    with h5py.File(path, "w", track_order=False) as f:
        d = f.create_dataset("trajectories", data=tab)
        d.attrs["columns"] = MS_COLUMNS


def read_multistream_hdf5(path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f["trajectories"][...]
