"""The CPU-testable parts of chip_smoke.py: it refuses to run without a
GPU or outside the repository, and its row comparison and truth check
catch what they exist to catch."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_refuses_without_gpu(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


ROWS = [(1, 0, 10.5, 20.25, 100.0), (2, 0, 40.0, 8.0, 96.0),
        (1, 1, 11.0, 20.5, 101.0)]


@pytest.mark.parametrize(
    "change",
    ["none", "drop_row", "one_ulp_x", "swap_order", "track_id"],
)
def test_compare_rows_catches_mismatch(change):
    got = [list(r) for r in ROWS]
    if change == "drop_row":
        got = got[:-1]
    elif change == "one_ulp_x":
        got[1][2] = float(np.nextafter(got[1][2], np.inf))
    elif change == "swap_order":
        got[0], got[1] = got[1], got[0]
    elif change == "track_id":
        got[2][0] = 3
    msg = chip_smoke.compare_rows(got, ROWS)
    if change == "none":
        assert msg is None
    else:
        assert msg is not None


TRUTH = np.array([[[100.0, 100.0], [300.0, 100.0], [400.0, 400.0],
                   [420.0, 400.0]], [[102.0, 100.0], [300.0, 100.0],
                                     [400.0, 400.0], [420.0, 400.0]]])
ALIVE = np.ones((2, 4), bool)


def test_truth_error_judges_lone_disks_only():
    """Rows within 1 px are judged with their exact error; a row of two
    touching blobs counts as merged, not as an error."""
    rows = [
        (1, 0, 100.5, 100.0, 800.0),   # lone disk, 0.5 px off
        (2, 0, 300.0, 100.25, 805.0),  # lone disk, 0.25 px off
        (3, 0, 410.0, 400.0, 1600.0),  # two touching disks merged
    ]
    res = chip_smoke.truth_error(rows, TRUTH, ALIVE, 16.0)
    assert (res["err"], res["judged"], res["merged"], res["n"]) == (
        0.5, 2, 1, 3)
    assert res["trail"] == 0 and res["unexplained"] == []


@pytest.mark.parametrize(
    "row, kind",
    [
        ((1, 1, 98.0, 100.0, 1100.0), "trail"),       # 4 px behind its step
        ((1, 1, 70.0, 100.5, 200.0), "trail"),        # split-off trail
        ((1, 1, 102.0, 104.0, 900.0), "unexplained"),  # 4 px sideways
        ((1, 1, 106.0, 100.0, 900.0), "unexplained"),  # 4 px ahead
    ],
)
def test_truth_error_sorts_trails_from_errors(row, kind):
    """Blob 0 steps +2 px in x from frame 0 to 1: a row behind it on that
    line is its background trail; any other row more than 1 px off is an
    error."""
    rows = [(2, 1, 300.0, 100.0, 800.0), row]
    res = chip_smoke.truth_error(rows, TRUTH, ALIVE, 16.0)
    if kind == "trail":
        assert res["trail"] == 1 and res["unexplained"] == []
        assert res["trail_cos"] <= chip_smoke.TRAIL_COS
        assert chip_smoke.truth_failure(res) is not None  # 1 of 2 rows
    else:
        assert res["unexplained"] == [1]
        assert "no blob" in chip_smoke.truth_failure(res)


@pytest.mark.parametrize("n_trail, fails", [(2, False), (3, True)])
def test_truth_failure_caps_merges_and_trails(n_trail, fails):
    """At most TRAIL_SHARE of the rows may go unjudged."""
    rows = [(2, t, 300.0, 100.0, 800.0) for t in (0, 1)] * 4
    rows += [(1, 1, 98.0, 100.0, 1100.0)] * n_trail
    res = chip_smoke.truth_error(rows, TRUTH, ALIVE, 16.0)
    assert res["trail"] == n_trail
    assert (chip_smoke.truth_failure(res) is not None) == fails


def test_mask_difference_names_the_first_frame():
    a = np.zeros((3, 4, 5), bool)
    assert chip_smoke.mask_difference(a, a.copy()) is None
    b = a.copy()
    b[1, 2, 3] = b[2, 0, 0] = True
    assert chip_smoke.mask_difference(a, b) == (
        "2 frames differ; first at frame 1 (1 pixels)")
