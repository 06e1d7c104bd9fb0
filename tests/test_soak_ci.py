"""CI-scale version of the config-4 soak (bench/soak_100k.py): the same
kill/resume byte-identity and drift-oracle machinery at toy size on the
CPU backend (the full 100k-frame 1080p run executes on the GPU)."""

import importlib.util
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def soak():
    spec = importlib.util.spec_from_file_location(
        "soak_100k",
        os.path.join(os.path.dirname(__file__), "..", "bench",
                     "soak_100k.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_renderers_agree(soak):
    import jax.numpy as jnp

    H, W = 96, 160
    render = soak.make_render_jax(H, W, 8)
    dev = np.asarray(render(jnp.int32(1234)))
    host = soak.render_frames_np(H, W, 1234, 8)
    np.testing.assert_array_equal(dev, host)
    # region rendering slices the same scene
    win = soak.render_frames_np(H, W, 1234, 8, region=(10, 20, 32, 48))
    np.testing.assert_array_equal(win, host[:, 10:42, 20:68])


def test_soak_kill_resume_byte_identical(soak, tmp_path):
    from tpuva.export.hdf5io import write_tracks_hdf5

    cfg = soak.build_cfg(batch=8)
    H, W, T = 96, 160, 256

    ckpt_a = str(tmp_path / "a.npz")
    rlog_a = str(tmp_path / "a.rows")
    log_a, carry_a = soak.run_soak(cfg, H, W, T, ckpt_a, rlog_a,
                                   ckpt_every=8)
    flat_a = log_a.read()
    assert len(flat_a) > 0

    ckpt_b = str(tmp_path / "b.npz")
    rlog_b = str(tmp_path / "b.rows")
    with pytest.raises(soak.Abort):
        soak.run_soak(cfg, H, W, T, ckpt_b, rlog_b, abort_at_batch=16,
                      ckpt_every=8)
    log_b, carry_b = soak.run_soak(cfg, H, W, T, ckpt_b, rlog_b,
                                   resume=True, ckpt_every=8)
    flat_b = log_b.read()

    h5_a, h5_b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    write_tracks_hdf5(h5_a, [tuple(r) for r in flat_a])
    write_tracks_hdf5(h5_b, [tuple(r) for r in flat_b])
    assert open(h5_a, "rb").read() == open(h5_b, "rb").read()
    np.testing.assert_array_equal(
        np.asarray(carry_a.bg), np.asarray(carry_b.bg)
    )
    # centroid oracle: rows carry real positions end-to-end (guards the
    # packed async drain against transport bugs that zero/misalign sums,
    # which push the median to O(image size) — zeroed sums measure ~50 px
    # here). The bound is loose at this toy scale: 6 radius-16 blobs in
    # 96x160 revisit pixels so often that the rolling background absorbs
    # them and detections are crescents ~12 px off center; the tight
    # < 1 px assertion runs at real scale in bench/soak_100k.py main().
    err = soak.centroid_oracle_err(flat_a, H, W)
    assert 0 <= err < 20.0, err


def test_soak_drift_oracle_small(soak):
    """f32 device recurrence vs f64 host recurrence on the same frames —
    drift stays tiny at CI scale (the 100k number lands in SOAK_100K.json)."""
    import cv2
    import jax.numpy as jnp

    from tpuva.graph.pipeline import init_carry, process_batch

    cfg = soak.build_cfg(batch=8)
    H, W, T = 96, 160, 128
    render = soak.make_render_jax(H, W, 8)
    carry = init_carry(cfg, H, W)
    for t in range(0, T, 8):
        carry, _ = process_batch(cfg, carry, render(jnp.int32(t)))

    y0, x0, CS, M = 32, 48, 32, 4
    ksz = (cfg.blur.ksize, cfg.blur.ksize)
    a = np.float64(cfg.background.alpha)
    bg64 = None
    fr = soak.render_frames_np(
        H, W, 0, T, region=(y0 - M, x0 - M, CS + 2 * M, CS + 2 * M)
    )
    for i in range(T):
        # cv2's u8 fixed-point blur — the same quantized frames the device
        # recurrence sees (gaussian_blur_u8 is bit-exact to it), so the
        # residual is pure f32-vs-f64 accumulation drift
        blurred = cv2.GaussianBlur(fr[i], ksz, cfg.blur.sigma)[
            M:-M, M:-M
        ].astype(np.float64)
        bg64 = blurred if bg64 is None else (1 - a) * bg64 + a * blurred
    bg32 = np.asarray(carry.bg)[y0:y0 + CS, x0:x0 + CS].astype(np.float64)
    assert np.abs(bg32 - bg64).max() < 1e-2
