"""Golden tests: tpuva.ops vs the local OpenCV 5.0.0 oracle (SURVEY.md §4.2).

These pin the bit-compatibility contract: masks/labels/morphology/median are
exact, float convolutions agree to float32 associativity, centroids well
inside the 1px tolerance (BASELINE.json:5).
"""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp

from refimpl.synthetic import moving_disk_clip, random_mask
from tpuva import ops


def rand_u8(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


# --------------------------------------------------------------- gaussian
@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 15])
@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.5, 3.0])
def test_gaussian_kernel_matches_cv2(ksize, sigma):
    ours = ops.gaussian_kernel_1d(ksize, sigma)
    ref = cv2.getGaussianKernel(ksize, sigma).ravel()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (5, 1.2), (9, 2.0)])
def test_gaussian_blur_float32(ksize, sigma):
    img = rand_u8(57, 83).astype(np.float32)
    ref = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    out = np.asarray(ops.gaussian_blur(jnp.asarray(img), ksize, sigma))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize(
    "ksize,sigma",
    [
        (3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (11, 0.0), (13, 0.0),
        (3, 0.8), (5, 1.0), (5, 1.5), (7, 2.0), (9, 2.5), (13, 3.0),
        (21, 4.0),
    ],
)
def test_gaussian_blur_u8_bit_exact(ksize, sigma):
    """gaussian_blur_u8 == cv2.GaussianBlur on uint8, BIT-EXACT: cv2's
    fixed-point path is error-diffusion tap quantization + one half-away
    rounding, both reproduced exactly in f32 (ops.u8_gaussian_taps)."""
    img = rand_u8(97, 131, seed=ksize * 100 + int(sigma * 10))
    ref = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    out = np.asarray(
        ops.gaussian_blur_u8(jnp.asarray(img, jnp.float32), ksize, sigma)
    )
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.astype(np.uint8), ref)
    # values are exact integers in [0, 255]
    assert float(np.abs(out - np.rint(out)).max()) == 0.0


def test_u8_gaussian_taps_sum_and_symmetry():
    for ksize, sigma in [(5, 1.0), (7, 2.0), (9, 2.5), (15, 0.0)]:
        taps = ops.filters.u8_gaussian_taps(ksize, sigma)
        assert taps.sum() == 256
        np.testing.assert_array_equal(taps, taps[::-1])


def test_gaussian_blur_batched_matches_single():
    clip = np.stack([rand_u8(40, 56, s) for s in range(4)]).astype(np.float32)
    out = np.asarray(ops.gaussian_blur(jnp.asarray(clip), 5, 0.0))
    for i in range(4):
        ref = cv2.GaussianBlur(clip[i], (5, 5), 0)
        np.testing.assert_allclose(out[i], ref, rtol=2e-5, atol=2e-3)


# ----------------------------------------------------------------- median
@pytest.mark.parametrize("ksize", [3, 5])
def test_median_uint8_exact(ksize):
    img = rand_u8(45, 61, seed=3)
    ref = cv2.medianBlur(img, ksize)
    out = np.asarray(ops.median_blur(jnp.asarray(img), ksize))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_float32_exact(ksize):
    img = rand_u8(33, 47, seed=4).astype(np.float32)
    ref = cv2.medianBlur(img, ksize)
    out = np.asarray(ops.median_blur(jnp.asarray(img), ksize))
    np.testing.assert_array_equal(out, ref)


# -------------------------------------------------------------- threshold
def test_threshold_strict():
    img = rand_u8(31, 33, seed=5).astype(np.float32)
    _, ref = cv2.threshold(img, 100.0, 255, cv2.THRESH_BINARY)
    out = np.asarray(ops.threshold(jnp.asarray(img), 100.0))
    np.testing.assert_array_equal(out, ref.astype(np.uint8))
    # boundary: value == thresh -> 0
    img2 = np.full((8, 8), 100.0, np.float32)
    assert np.all(np.asarray(ops.threshold(jnp.asarray(img2), 100.0)) == 0)


def test_otsu_matches_cv2():
    img, _, _ = moving_disk_clip(h=64, w=64, frames=1, radius=10, noise_sigma=8.0)
    img = img[0]
    t_ref, _ = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    t_ours = float(np.asarray(ops.otsu_threshold(jnp.asarray(img))))
    assert abs(t_ours - t_ref) <= 1.0


def test_histogram_u8_chunked_exact():
    """histogram_u8's pixel-axis chunking (the OOM guard for
    production-scale Otsu: batch 256 @ 1080p would otherwise build two
    ~17 GB one-hot operands) must stay bit-exact: chunked == unchunked ==
    np.bincount, for batched and unbatched inputs, including a pixel
    count that does not divide the chunk (zero-pad correction on bin 0).
    """
    from tpuva.ops.filters import histogram_u8

    rng = np.random.default_rng(5)
    for shape in [(64, 96), (4, 33, 47)]:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        flat = x.reshape(-1, shape[-2] * shape[-1])
        ref = np.stack(
            [np.bincount(r, minlength=256) for r in flat]
        ).astype(np.float32).reshape(shape[:-2] + (256,))
        full = np.asarray(histogram_u8(jnp.asarray(x)))
        chunked = np.asarray(
            histogram_u8(jnp.asarray(x), max_onehot_elems=999)
        )
        np.testing.assert_array_equal(full, ref)
        np.testing.assert_array_equal(chunked, ref)


# ------------------------------------------------------------- morphology
@pytest.mark.parametrize("shape", ["rect", "ellipse"])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_structuring_element(shape, ksize):
    cvshape = cv2.MORPH_RECT if shape == "rect" else cv2.MORPH_ELLIPSE
    ref = cv2.getStructuringElement(cvshape, (ksize, ksize)).astype(bool)
    np.testing.assert_array_equal(ops.structuring_element(shape, ksize), ref)


@pytest.mark.parametrize("shape", ["rect", "ellipse"])
@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("op", ["erode", "dilate", "open", "close"])
def test_morphology_exact(shape, ksize, op):
    mask = random_mask(47, 59, density=0.4, seed=7)
    se_cv = cv2.getStructuringElement(
        cv2.MORPH_RECT if shape == "rect" else cv2.MORPH_ELLIPSE, (ksize, ksize)
    )
    se = ops.structuring_element(shape, ksize)
    x = jnp.asarray(mask)
    if op == "erode":
        ref, out = cv2.erode(mask, se_cv), ops.erode(x, se)
    elif op == "dilate":
        ref, out = cv2.dilate(mask, se_cv), ops.dilate(x, se)
    elif op == "open":
        ref = cv2.morphologyEx(mask, cv2.MORPH_OPEN, se_cv)
        out = ops.morph_open(x, se)
    else:
        ref = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, se_cv)
        out = ops.morph_close(x, se)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_morphology_grayscale_and_iterations():
    img = rand_u8(40, 52, seed=9)
    se = ops.structuring_element("rect", 3)
    se_cv = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
    np.testing.assert_array_equal(
        np.asarray(ops.erode(jnp.asarray(img), se, iterations=2)),
        cv2.erode(img, se_cv, iterations=2),
    )
    np.testing.assert_array_equal(
        np.asarray(ops.morph_open(jnp.asarray(img), se, iterations=2)),
        cv2.morphologyEx(img, cv2.MORPH_OPEN, se_cv, iterations=2),
    )


# -------------------------------------------------------------------- CCL
def _cv_ccl(mask, connectivity=8):
    return cv2.connectedComponentsWithStats(mask, connectivity=connectivity)


@pytest.mark.parametrize("density", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("connectivity", [8, 4])
def test_ccl_labels_bit_equal(density, connectivity):
    mask = random_mask(64, 80, density=density, seed=11)
    n_ref, lab_ref, stats_ref, cent_ref = _cv_ccl(mask, connectivity)
    out = ops.connected_components_with_stats(
        jnp.asarray(mask), max_components=2048, connectivity=connectivity
    )
    assert int(out["count"]) == n_ref - 1
    np.testing.assert_array_equal(np.asarray(out["labels"]), lab_ref)


def test_ccl_stats_match_cv2():
    mask = random_mask(60, 72, density=0.25, seed=13, blocky=True)
    n_ref, lab_ref, stats_ref, cent_ref = _cv_ccl(mask)
    out = ops.connected_components_with_stats(jnp.asarray(mask), max_components=512)
    n = int(out["count"])
    assert n == n_ref - 1
    for i in range(1, n_ref):
        assert int(out["area"][i]) == int(stats_ref[i, cv2.CC_STAT_AREA])
        np.testing.assert_array_equal(
            np.asarray(out["bbox"][i]),
            stats_ref[i, :4],
        )
        np.testing.assert_allclose(
            np.asarray(out["centroid"][i]), cent_ref[i], rtol=0, atol=1e-3
        )


def test_ccl_snake():
    """Long snaky component — stresses propagation convergence."""
    mask = np.zeros((40, 40), np.uint8)
    for r in range(0, 40, 2):
        mask[r, :] = 255
        if (r // 2) % 2 == 0:
            mask[r + 1 if r + 1 < 40 else r, -1] = 255
        else:
            mask[r + 1 if r + 1 < 40 else r, 0] = 255
    n_ref, lab_ref, _, _ = _cv_ccl(mask)
    out = ops.connected_components_with_stats(jnp.asarray(mask), max_components=64)
    assert int(out["count"]) == n_ref - 1
    np.testing.assert_array_equal(np.asarray(out["labels"]), lab_ref)


def test_ccl_batch_matches_per_frame():
    clip, _, _ = moving_disk_clip(h=48, w=64, frames=6, radius=7)
    masks = (clip > 100).astype(np.uint8) * 255
    out = ops.connected_components_with_stats(jnp.asarray(masks), max_components=16)
    for t in range(6):
        n_ref, lab_ref, stats_ref, cent_ref = _cv_ccl(masks[t])
        assert int(out["count"][t]) == n_ref - 1
        np.testing.assert_array_equal(np.asarray(out["labels"][t]), lab_ref)
        for i in range(1, n_ref):
            np.testing.assert_allclose(
                np.asarray(out["centroid"][t, i]), cent_ref[i], atol=1e-3
            )


def test_extract_detections_matches_refimpl():
    from refimpl.pipeline import segment_frame

    clip, _, _ = moving_disk_clip(h=48, w=64, frames=4, radius=6)
    masks = (clip > 100).astype(np.uint8) * 255
    stats = ops.connected_components_with_stats(jnp.asarray(masks), max_components=16)
    dets, n_det, valid, det_sums = ops.label.extract_detections(
        stats, min_area=20, max_blobs=4
    )
    for t in range(4):
        ref_dets, _ = segment_frame(masks[t], 20, 4)
        assert int(n_det[t]) == len(ref_dets)
        for j, (x, y, a) in enumerate(ref_dets):
            np.testing.assert_allclose(
                np.asarray(dets[t, j]), [x, y, a], atol=1e-3
            )


def test_stats_surface_ccl_convergence():
    """The propagation runs to a true fixed point, so there is no
    convergence flag to surface: labels and counts match cv2 for batched
    and squeezed inputs of a diagonal-chain mask (every component is a
    long 8-connected staircase)."""
    mask = (np.arange(64 * 96).reshape(64, 96) % 7 == 0).astype(np.uint8) * 255
    n_ref, lab_ref, _, _ = _cv_ccl(mask)
    out = ops.connected_components_with_stats(
        jnp.asarray(mask), max_components=1024
    )
    assert "ccl_converged" not in out
    assert int(out["count"]) == n_ref - 1
    np.testing.assert_array_equal(np.asarray(out["labels"]), lab_ref)
    outb = ops.connected_components_with_stats(
        jnp.asarray(mask[None]), max_components=1024
    )
    np.testing.assert_array_equal(np.asarray(outb["labels"][0]), lab_ref)


@pytest.mark.parametrize("ksize", [3, 5])
def test_binomial_blur_exact_for_integer_inputs(ksize):
    """The box-cascade binomial path (sigma<=0, k in {3,5}) is EXACT for
    integer-valued inputs: every partial sum is an integer < 2^24 and the
    normalization is a power of two — pin bit-equality against an int64
    ground-truth correlation. This is what makes the blur bit-identical
    on every device, whatever its summation order."""
    img = rand_u8(37, 61).astype(np.float32)
    out = np.asarray(ops.gaussian_blur(jnp.asarray(img), ksize, 0.0))
    k1 = (np.array([1, 2, 1]) if ksize == 3
          else np.array([1, 4, 6, 4, 1])).astype(np.int64)
    r = ksize // 2
    xp = np.pad(img.astype(np.int64), r, mode="reflect")
    rows = sum(k1[j] * xp[:, j:j + img.shape[1]] for j in range(ksize))
    full = sum(k1[j] * rows[j:j + img.shape[0], :] for j in range(ksize))
    want = (full.astype(np.float64) * 2.0 ** (-2 * (ksize - 1))).astype(
        np.float32
    )
    np.testing.assert_array_equal(out, want)


def _scene(name):
    """Masks whose components straddle block and tile boundaries, wind
    through many turns, or fill or empty the frame."""
    if name == "dense_noise":
        return random_mask(97, 131, density=0.5, seed=21)
    if name == "blocky":
        return random_mask(100, 300, density=0.3, seed=22, blocky=True)
    if name == "checker":
        return ((np.indices((33, 47)).sum(axis=0) % 2) * 255).astype(np.uint8)
    if name == "empty":
        return np.zeros((64, 96), np.uint8)
    if name == "full":
        return np.full((64, 96), 255, np.uint8)
    m = np.zeros((192, 768), np.uint8)
    if name == "tile_boundary":  # unaligned height, blobs across col 256
        m = np.zeros((130, 280), np.uint8)
        m[60:70, 250:265] = 255
        m[62:66, 10:30] = 255
        m[126:130, 0:8] = 255
    elif name == "corner_straddle":  # across row 64 / col 256 corners
        m[60:70, 250:262] = 255
        m[126:132, 508:516] = 255
        m[0:3, 765:768] = 255
        m[189:192, 0:2] = 255
    elif name == "serpentine":  # a U across three tile columns and rows
        m[10:14, 20:700] = 255
        m[10:180, 690:700] = 255
        m[170:180, 30:700] = 255
    elif name == "ring_spiral":  # a ring whose only gap is in the top row
        m[0:2, :] = 255
        m[:, 766:768] = 255
        m[190:192, :] = 255
        m[:, 0:2] = 255
        m[0:2, 300:302] = 0
        m[20:172, 20:22] = 255
        m[20:22, 20:740] = 255
    elif name == "stub_bar_arm":  # the minimum key enters from the right
        m[0:9, 280:284] = 255
        m[5:9, 10:301] = 255
        m[5:101, 10:14] = 255
    elif name == "bridge":  # two arms joined only by their bottom row
        m = np.zeros((128, 512), np.uint8)
        m[10, 250:270] = 255
        m[8, 260:262] = 255
        m[9, 255:262] = 255
        m[50:64, 100:103] = 255
        m[50:64, 200:203] = 255
        m[63, 100:203] = 255
    else:
        raise ValueError(name)
    return m


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize(
    "scene",
    ["tile_boundary", "corner_straddle", "serpentine", "ring_spiral",
     "stub_bar_arm", "bridge", "dense_noise", "blocky", "checker", "empty",
     "full"],
)
def test_ccl_scene_matches_cv2(scene, connectivity):
    """labels, areas, bounding boxes and centroids equal cv2's; the
    centroids rebuilt in float64 from the exact integer coordinate sums
    are bit-equal to cv2's (the contract the exported rows rest on)."""
    mask = _scene(scene)
    n_ref, lab_ref, stats_ref, cent_ref = _cv_ccl(mask, connectivity)
    out = ops.connected_components_with_stats(
        jnp.asarray(mask[None]), max_components=1024,
        connectivity=connectivity,
    )
    n = n_ref - 1
    assert int(out["count"][0]) == n
    np.testing.assert_array_equal(np.asarray(out["labels"][0]), lab_ref)
    area = np.asarray(out["area"][0, 1 : n + 1])
    np.testing.assert_array_equal(area, stats_ref[1:, cv2.CC_STAT_AREA])
    np.testing.assert_array_equal(
        np.asarray(out["bbox"][0, 1 : n + 1]), stats_ref[1:, :4]
    )
    csum = np.asarray(out["centroid_sum"][0, 1 : n + 1]).astype(np.float64)
    np.testing.assert_array_equal(csum / area[:, None], cent_ref[1:])


@pytest.mark.parametrize("alpha", [0.02, 0.05, 0.1, 0.3])
def test_background_scan_rounds_like_refimpl(alpha):
    """The running background is bit-equal to refimpl's float32 numpy
    recurrence (each product rounded, then the sum): a compiler that
    contracts the update into a fused multiply-add gives other bits."""
    rng = np.random.default_rng(int(alpha * 100))
    frames = rng.integers(0, 256, (12, 40, 56)).astype(np.float32)
    bg0 = rng.integers(0, 256, (40, 56)).astype(np.float32)
    got = np.asarray(ops.background_scan(bg0, frames, alpha))
    a = np.float32(alpha)
    b, want = bg0, []
    for f in frames:
        b = (np.float32(1) - a) * b + a * f
        want.append(b)
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("cap", [1, 3, 7])
def test_ccl_capacity_keeps_first_components(cap):
    """Components past max_components are background in labels and
    absent from the stats; the first `cap` keep cv2's ids and exact
    stats, and count saturates at the capacity."""
    mask = _scene("blocky")
    n_ref, lab_ref, stats_ref, cent_ref = _cv_ccl(mask)
    assert n_ref - 1 > cap
    out = ops.connected_components_with_stats(
        jnp.asarray(mask), max_components=cap
    )
    assert int(out["count"]) == cap
    np.testing.assert_array_equal(
        np.asarray(out["labels"]), np.where(lab_ref <= cap, lab_ref, 0)
    )
    np.testing.assert_array_equal(
        np.asarray(out["area"][1:]), stats_ref[1 : cap + 1, cv2.CC_STAT_AREA]
    )
    np.testing.assert_array_equal(
        np.asarray(out["bbox"][1:]), stats_ref[1 : cap + 1, :4]
    )


@pytest.mark.parametrize("batched", [False, True])
def test_ccl_output_shapes(batched):
    """The wrapper's static output shapes, squeezed for one frame and
    batched for several, with the stats-only options zeroing labels and
    boxes but not the sums."""
    H, W, C = 30, 44, 5
    mask = _scene("dense_noise")[:H, :W]
    x = jnp.asarray(np.stack([mask, mask[::-1]]) if batched else mask)
    lead = (2,) if batched else ()
    out = ops.connected_components_with_stats(
        x, max_components=C, compute_bbox=False, compute_labels=False
    )
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    assert shapes == {
        "labels": lead + (H, W), "count": lead, "area": lead + (C + 1,),
        "bbox": lead + (C + 1, 4), "centroid": lead + (C + 1, 2),
        "centroid_sum": lead + (C + 1, 2),
    }
    assert not np.asarray(out["labels"]).any()
    assert not np.asarray(out["bbox"]).any()
    full = ops.connected_components_with_stats(x, max_components=C)
    np.testing.assert_array_equal(
        np.asarray(out["centroid_sum"]), np.asarray(full["centroid_sum"])
    )
