"""Connected-component labeling + per-blob stats on device (components E/F,
SURVEY.md §2.3; the "hardest kernel" of §7.3).

Replaces cv2.connectedComponentsWithStats (C++ SAUF/BBDT raster scans) with
an iterative min-label propagation + pointer-jumping scheme that is pure
XLA: static shapes, `lax.while_loop`, `reduce_window`, gathers — vmappable
over the frame-batch axis and shardable over a stream mesh.

cv2 label-id semantics reproduced bit-exactly (pinned empirically against
cv2 5.0.0 in this session; SURVEY.md §8):
- background label 0; labels dense 1..n;
- connectivity=4 (SAUF, pixel-based scan): ids ordered by the component's
  first pixel in PIXEL raster order;
- connectivity=8 (BBDT, 2x2-block-based scan): ids ordered by the
  component's first 2x2 block in BLOCK raster order (any two pixels inside
  one 2x2 block are 8-adjacent, so at most one component touches a block
  and the order is total).

Both orders are realized the same way: propagate the minimum of a
scan-order key K (a bijection pixel -> int; K = linear index for 4-conn,
K = block-major index for 8-conn). The converged per-component minimum IS
the component's first appearance under that scan, and ranking the minima
ascending (a cumsum in K space) reproduces cv2's ids exactly.

Static capacity: components beyond `max_components` (in scan order) are
relabeled to background — capacities are config knobs sized far above the
workload (2-8 blobs + noise specks, BASELINE.json:9).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _neighbor_min_8(label: jnp.ndarray, sent: int) -> jnp.ndarray:
    """Min over the 3x3 neighborhood (self included; out-of-bounds = sent)."""
    nd = label.ndim
    wdims = (1,) * (nd - 2) + (3, 3)
    pad = [(0, 0)] * (nd - 2) + [(1, 1), (1, 1)]
    return lax.reduce_window(
        label, jnp.int32(sent), lax.min, wdims, (1,) * nd, pad
    )


def _neighbor_min_4(label: jnp.ndarray, sent: int) -> jnp.ndarray:
    H, W = label.shape[-2], label.shape[-1]
    pad = [(0, 0)] * (label.ndim - 2) + [(1, 1), (1, 1)]
    lp = jnp.pad(label, pad, constant_values=sent)

    def sh(dy, dx):
        idx = [slice(None)] * (label.ndim - 2) + [
            slice(1 + dy, 1 + dy + H),
            slice(1 + dx, 1 + dx + W),
        ]
        return lp[tuple(idx)]

    out = label
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = jnp.minimum(out, sh(dy, dx))
    return out


@lru_cache(maxsize=32)
def _scan_key(H: int, W: int, connectivity: int):
    """(kmap (H,W) int32, inv (S+1,) int32, S) — K bijection for the cv2
    scan order of the given connectivity, its inverse (K -> linear pixel
    index, with unused/sentinel K slots pointing at the pad slot S), and the
    sentinel value S (= one past the largest K)."""
    if connectivity == 4:
        S = H * W
        kmap = np.arange(S, dtype=np.int32).reshape(H, W)
    else:
        Hb, Wb = (H + 1) // 2, (W + 1) // 2
        r = np.arange(H)[:, None]
        c = np.arange(W)[None, :]
        kmap = (((r // 2) * Wb + (c // 2)) * 4 + (r % 2) * 2 + (c % 2)).astype(
            np.int32
        )
        S = Hb * Wb * 4
    inv = np.full(S + 1, H * W, np.int32)  # default: point at the pad slot
    inv[kmap.reshape(-1)] = np.arange(H * W, dtype=np.int32)
    return kmap, inv, S  # numpy: safe to close over inside any jit trace


def _shifted(x: jnp.ndarray, d: int, axis: int, fill, reverse: bool):
    """x shifted so element i reads x[i-d] (forward) or x[i+d] (reverse),
    with constant fill at the boundary. Contiguous pad+slice only (unlike
    associative_scan's odd/even decimation, which strides the minor
    dimension)."""
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if not reverse:
        pad[axis] = (d, 0)
        idx[axis] = slice(0, x.shape[axis])
    else:
        pad[axis] = (0, d)
        idx[axis] = slice(d, d + x.shape[axis])
    return jnp.pad(x, pad, constant_values=fill)[tuple(idx)]


def _segmented_min_scan(v: jnp.ndarray, mask: jnp.ndarray, axis: int, sent,
                        reverse: bool = False) -> jnp.ndarray:
    """Segmented running minimum along `axis` via prefix doubling: the min
    propagates only within contiguous mask runs (non-mask pixels hold
    `sent` and block propagation). log2(n) steps of shifted elementwise
    min/and — streaming ops only, no gathers.

    Invariant after step k (d = 2^k): v[i] = min over the trailing window
    of its run of length min(2^k, run length ending at i); c[i] = "the d
    predecessors of i are all in my run"."""
    n = v.shape[axis]
    c = mask & _shifted(mask, 1, axis, False, reverse)
    d = 1
    while d < n:
        pulled = _shifted(v, d, axis, sent, reverse)
        v = jnp.where(c, jnp.minimum(v, pulled), v)
        c = c & _shifted(c, d, axis, False, reverse)
        d *= 2
    return v


@partial(jax.jit, static_argnames=("connectivity", "jump_rounds"))
def label_components(mask: jnp.ndarray, connectivity: int = 8, jump_rounds: int = 0):
    """Label connected components of a boolean/uint8 mask batch.

    mask: (N, H, W) (or (H, W)); returns int32 "root key" labels of the same
    shape: each component carries (its minimum scan key K) + 1, background
    is 0. Use `relabel_dense` for cv2-compatible dense ids.

    Algorithm: iterate {3x3 neighbor-min sweep (diagonal
    links), then segmented min-scans along rows and columns (propagating a
    label across an entire horizontal/vertical run in one O(log) sweep)}
    until fixed point. All ops are streaming (reduce_window, associative
    scan) — no per-pixel gathers in the loop. Convex blobs converge in 1-2
    iterations; iteration count scales with the number of "turns" of the
    most serpentine component, not its pixel length. jump_rounds > 0
    additionally applies pointer-jumping rounds (gather-based — only worth
    it for pathological maze masks).
    """
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    m = mask > 0
    N, H, W = m.shape
    kmap, inv, sent = _scan_key(H, W, connectivity)
    label0 = jnp.where(m, kmap[None], jnp.int32(sent))
    nb_min = _neighbor_min_8 if connectivity == 8 else _neighbor_min_4
    flat_m = m.reshape(N, H * W)
    pad_col = jnp.full((N, 1), sent, jnp.int32)

    def jump(flat):
        # label-of-the-pixel-my-label-points-at, in K space:
        # K -> pixel via inv, pixel -> its current label via flat.
        flat_p = jnp.concatenate([flat, pad_col], axis=1)
        label_by_k = flat_p[:, inv]  # (N, S+1); slot S = sent
        return jnp.where(
            flat_m,
            jnp.take_along_axis(label_by_k, flat, axis=1),
            jnp.int32(sent),
        )

    def sweep(label):
        label = jnp.where(m, jnp.minimum(label, nb_min(label, sent)), sent)
        label = _segmented_min_scan(label, m, axis=2, sent=sent)
        label = _segmented_min_scan(label, m, axis=2, sent=sent, reverse=True)
        label = _segmented_min_scan(label, m, axis=1, sent=sent)
        label = _segmented_min_scan(label, m, axis=1, sent=sent, reverse=True)
        return label

    def body(state):
        label, _ = state
        new = sweep(label)
        if jump_rounds:
            flat = new.reshape(N, H * W)
            for _ in range(jump_rounds):
                flat = jump(flat)
            new = flat.reshape(N, H, W)
        return new, jnp.any(new != label)

    label, _ = lax.while_loop(
        lambda s: s[1], body, (label0, jnp.bool_(True))
    )
    label = jnp.where(m, label + 1, 0)  # 1-based root keys, 0 background
    return label[0] if squeeze else label


@partial(jax.jit, static_argnames=("max_components", "connectivity"))
def relabel_dense(
    root_label: jnp.ndarray, max_components: int = 64, connectivity: int = 8
):
    """Convert root-key labels (from label_components) to cv2's dense
    scan-order ids 1..n (0 = background; components past max_components
    -> 0).

    Returns (dense (N,H,W) int32, count (N,) int32 = min(n, max_components)).
    """
    squeeze = root_label.ndim == 2
    if squeeze:
        root_label = root_label[None]
    N, H, W = root_label.shape
    kmap, inv, sent = _scan_key(H, W, connectivity)
    m = root_label > 0
    flat_m = m.reshape(N, H * W)
    flat = root_label.reshape(N, H * W) - 1  # K values for mask pixels
    # is_root in K space: K slot v is a root iff the pixel at K=v is a mask
    # pixel whose label equals v.
    pad_false = jnp.zeros((N, 1), bool)
    m_by_k = jnp.concatenate([flat_m, pad_false], axis=1)[:, inv]  # (N, S+1)
    lab_by_k = jnp.concatenate(
        [flat, jnp.full((N, 1), sent, jnp.int32)], axis=1
    )[:, inv]
    kiota = jnp.arange(lab_by_k.shape[1], dtype=jnp.int32)[None]
    is_root_k = m_by_k & (lab_by_k == kiota)
    rank = jnp.cumsum(is_root_k, axis=1, dtype=jnp.int32)  # (N, S+1)
    n = rank[:, -1]
    dense = jnp.where(
        flat_m, jnp.take_along_axis(rank, jnp.where(flat_m, flat, 0), axis=1), 0
    )
    dense = jnp.where(dense <= max_components, dense, 0).reshape(N, H, W)
    count = jnp.minimum(n, max_components)
    return (dense[0], count[0]) if squeeze else (dense, count)


def _strip_view(x: jnp.ndarray, connectivity: int):
    """(N, H, W) -> (N, Q, 512) contiguous "strips", each covering 512
    consecutive scan-key (K) slots: a 2x256-pixel block-row segment for
    8-conn, 512 pixels of one row for 4-conn. Built with a mid-axis
    transpose only (the minor dim is untouched).

    Strip slot order is SPATIAL ([row0 cols | row1 cols] for 8-conn);
    `perm` is the static permutation mapping K order -> spatial slot.
    Returns (strips, Qc, Q, perm)."""
    N, H, W = x.shape
    if connectivity == 8:
        Hb, Wb = (H + 1) // 2, (W + 1) // 2
        He = 2 * Hb
        Qc = -(-Wb // 128)  # strips per block-row
        Wp = Qc * 256
        xp = jnp.pad(x, ((0, 0), (0, He - H), (0, Wp - W)))
        Q = Hb * Qc
        strips = (
            xp.reshape(N, Hb, 2, Qc, 256)
            .transpose(0, 1, 3, 2, 4)
            .reshape(N, Q, 512)
        )
        perm = _strip_perm(8)  # spatial index producing K slot t
    else:
        Qc = -(-W // 512)
        Wp = Qc * 512
        xp = jnp.pad(x, ((0, 0), (0, 0), (0, Wp - W)))
        Q = H * Qc
        strips = xp.reshape(N, Q, 512)
        perm = _strip_perm(4)
    return strips, Qc, Q, perm


def _strip_perm(connectivity: int) -> np.ndarray:
    """The static 512-slot K-order permutation of _strip_view."""
    if connectivity == 8:
        dr = np.repeat(np.arange(2), 256)
        dc = np.tile(np.arange(256), 2)
        kpos = (dc // 2) * 4 + dr * 2 + (dc % 2)
        perm = np.empty(512, np.int32)
        perm[kpos] = np.arange(512)
    else:
        perm = np.arange(512, dtype=np.int32)
    return perm


@partial(
    jax.jit, static_argnames=("connectivity", "max_components")
)
def _root_table(root: jnp.ndarray, connectivity: int, max_components: int):
    """The first `max_components` root keys in cv2 id order.

    Transpose-free "strip" scheme: a chunk of 512 consecutive K slots is a
    spatially CONTIGUOUS region (a 2x256-pixel strip for 8-conn block
    order; 512 pixels of one row for 4-conn), so

    1. per-chunk root counts come from plain contiguous reductions over the
       padded root-flag image (no minor-dim space-to-depth transpose);
    2. the c-th root's chunk is found by a tiny per-frame searchsorted
       over the chunk-count prefix sums;
    3. only that strip is gathered (C x 512 elements — small), permuted
       into K order by a static 512-permutation, and the (c - offset)-th
       set flag inside it located with a cumsum+argmax.

    Returns (table (N, C) int32 of root-label values (K+1; sentinel where
    absent), n_roots (N,) int32 — the uncapped component count).
    """
    N, H, W = root.shape
    kmap, _inv, sent = _scan_key(H, W, connectivity)
    C = max_components
    is_root = (root > 0) & (root == jnp.asarray(kmap)[None] + 1)
    cs = jnp.arange(C, dtype=jnp.int32)

    strips, Qc, Q, perm = _strip_view(is_root, connectivity)
    Wb = (W + 1) // 2  # block columns (8-conn kval reconstruction)
    counts = strips.sum(axis=2, dtype=jnp.int32)

    cum = jnp.cumsum(counts, axis=1)  # inclusive (N, Q)
    offs = cum - counts  # exclusive
    n_roots = cum[:, -1]
    # first chunk with cum > c, as a compare+sum (batched searchsorted
    # compiles poorly; this is a tiny (N, Q, C) reduction)
    chunk_of_c = jnp.sum(
        cum[:, :, None] <= cs[None, None, :], axis=1, dtype=jnp.int32
    )
    chunk_of_c = jnp.minimum(chunk_of_c, Q - 1)
    r_in_chunk = cs[None, :] - jnp.take_along_axis(offs, chunk_of_c, axis=1)

    # gather each target strip (an axis-1 block gather of full 512-wide
    # minor blocks — lowers efficiently, unlike flat per-element gathers)
    qr = chunk_of_c // Qc
    qc = chunk_of_c % Qc
    strip = jnp.take_along_axis(strips, chunk_of_c[:, :, None], axis=1)
    strip_k = strip[:, :, jnp.asarray(perm)]  # K-slot order
    cumk = jnp.cumsum(strip_k.astype(jnp.int32), axis=2)
    pos = jnp.argmax(cumk > r_in_chunk[:, :, None], axis=2).astype(jnp.int32)

    if connectivity == 8:
        b = pos // 4
        within = pos % 4
        kval = ((qr * Wb + qc * 128 + b) * 4 + within).astype(jnp.int32)
    else:
        kval = (qr * W + qc * 512 + pos).astype(jnp.int32)

    valid = cs[None, :] < n_roots[:, None]
    table = jnp.where(valid, kval + 1, jnp.int32(sent + 2))
    return table, n_roots


@partial(
    jax.jit,
    static_argnames=(
        "max_components", "connectivity", "jump_rounds", "compute_bbox",
        "compute_labels",
    ),
)
def connected_components_with_stats(
    mask: jnp.ndarray,
    max_components: int = 64,
    connectivity: int = 8,
    jump_rounds: int = 0,
    compute_bbox: bool = True,
    compute_labels: bool = True,
):
    """Batched cv2.connectedComponentsWithStats.

    mask: (N, H, W) (or (H, W)) uint8/bool.
    Returns dict with:
      labels   : (N, H, W) int32  — dense cv2-order ids, 0 = background
                 (all-zeros when compute_labels=False — the tracking
                 pipeline only needs stats)
      count    : (N,)      int32  — number of non-background components
      area     : (N, C+1)  int32  — row 0 is background, rows 1..C blobs
      bbox     : (N, C+1, 4) int32 — (x, y, w, h), zeros for absent ids
      centroid : (N, C+1, 2) float32 — (x=col, y=row), (0,0) for absent ids
      centroid_sum : (N, C+1, 2) int32 — exact (sx, sy) coordinate sums
    C = max_components. All shapes static.
    """
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    root = label_components(
        mask, connectivity=connectivity, jump_rounds=jump_rounds
    )
    out = _stats_from_root(
        root,
        max_components=max_components,
        connectivity=connectivity,
        compute_bbox=compute_bbox,
        compute_labels=compute_labels,
    )
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def _assemble_stats(area_c, sx_c, sy_c, n_roots, H: int, W: int, C: int):
    """Shared stats epilogue: background row by subtraction from static
    image totals, centroid division. area_c, sx_c, sy_c: (N, C) int32
    exact per-component sums. Returns (count, area (N,C+1), centroid
    (N,C+1,2), csum (N,C+1,2), present)."""
    count = jnp.minimum(n_roots, C)
    # background row by subtraction from static image totals (float32: the
    # bg coordinate sums exceed int32 at large resolutions)
    area0 = (H * W - jnp.sum(area_c, axis=1)).astype(jnp.int32)
    sx_tot = float(H) * (W - 1) * W / 2.0
    sy_tot = float(W) * (H - 1) * H / 2.0
    sx0 = sx_tot - jnp.sum(sx_c, axis=1).astype(jnp.float32)
    sy0 = sy_tot - jnp.sum(sy_c, axis=1).astype(jnp.float32)

    area = jnp.concatenate([area0[:, None], area_c], axis=1)
    present = area > 0
    safe_area = jnp.maximum(area, 1).astype(jnp.float32)
    sx_f = jnp.concatenate(
        [sx0[:, None], sx_c.astype(jnp.float32)], axis=1
    )
    sy_f = jnp.concatenate(
        [sy0[:, None], sy_c.astype(jnp.float32)], axis=1
    )
    cx = jnp.where(present, sx_f / safe_area, 0.0).astype(jnp.float32)
    cy = jnp.where(present, sy_f / safe_area, 0.0).astype(jnp.float32)
    centroid = jnp.stack([cx, cy], axis=-1)
    csum_c = jnp.stack([sx_c, sy_c], axis=-1)
    # row 0 (background) coordinate sums exceed int32 beyond ~1080p (4K:
    # ~1.6e10) and are float32-rounded above ~2^24 regardless — clamp the
    # cast so it stays defined instead of an out-of-range f32->i32
    # conversion; the bg row is not a blob statistic, and its float
    # centroid above is unaffected. Component rows are exact.
    imax = jnp.float32(2**31 - 128)  # largest f32 below 2^31
    csum0 = jnp.clip(
        jnp.stack([sx0, sy0], axis=-1), -imax, imax
    ).astype(jnp.int32)[:, None]
    csum = jnp.concatenate([csum0, csum_c], axis=1)
    csum = jnp.where(present[:, :, None], csum, 0)
    return count, area, centroid, csum, present


@partial(
    jax.jit,
    static_argnames=(
        "max_components", "connectivity", "compute_bbox", "compute_labels",
    ),
)
def _stats_from_root(
    root: jnp.ndarray,
    max_components: int = 64,
    connectivity: int = 8,
    compute_bbox: bool = True,
    compute_labels: bool = True,
):
    """Stats assembly given precomputed root-key labels (see
    connected_components_with_stats for the output contract).

    Every pixel finds its root's slot in the ascending C-entry root table
    (a compare-count over C that XLA fuses into one reduction, so no
    (N, H*W, C) tensor is built), and the per-component sums are exact
    int32 segment sums (scatter-adds) keyed by frame * C + slot. Pixels
    whose root is not in the table — background, and components past the
    capacity — get an out-of-range key and are dropped by the scatter.
    Component coordinate sums stay exact while they fit int32 (any
    component of a 1080p frame does).
    """
    N, H, W = root.shape
    C = max_components
    table, n_roots = _root_table(root, connectivity, C)
    flat = root.reshape(N, H * W)
    # table is ascending with a sentinel fill above every root value, so
    # a root's slot is the number of entries below it
    slot = jnp.sum(
        table[:, None, :] < flat[:, :, None], axis=2, dtype=jnp.int32
    )
    hit = jnp.take_along_axis(table, jnp.minimum(slot, C - 1), axis=1) == flat
    frame = jnp.arange(N, dtype=jnp.int32)[:, None]
    seg = jnp.where(hit, frame * C + slot, N * C).reshape(-1)
    lin = jnp.arange(H * W, dtype=jnp.int32)
    x = jnp.broadcast_to(lin % W, (N, H * W)).reshape(-1)
    y = jnp.broadcast_to(lin // W, (N, H * W)).reshape(-1)

    def seg_sum(v):
        z = jnp.zeros((N * C,), jnp.int32)
        return z.at[seg].add(v, mode="drop").reshape(N, C)

    area_c = seg_sum(jnp.ones_like(x))
    sx_c = seg_sum(x)
    sy_c = seg_sum(y)
    count, area, centroid, csum, present = _assemble_stats(
        area_c, sx_c, sy_c, n_roots, H, W, C
    )

    if compute_labels:
        dense = jnp.where(hit, slot + 1, 0).reshape(N, H, W)
    else:
        dense = jnp.zeros((N, H, W), jnp.int32)

    if compute_bbox:
        big = jnp.int32(2**30)

        def seg_min(v):
            z = jnp.full((N * C,), big, jnp.int32)
            return z.at[seg].min(v, mode="drop").reshape(N, C)

        xmin, ymin = seg_min(x), seg_min(y)
        xmax, ymax = -seg_min(-x), -seg_min(-y)
        bbox_c = jnp.stack(
            [xmin, ymin, xmax - xmin + 1, ymax - ymin + 1], axis=-1
        )
        # background bbox: bounding box of non-component pixels; the
        # reference workloads always have background at the image borders,
        # so the full-image box matches cv2 in practice.
        bbox0 = jnp.broadcast_to(
            jnp.array([0, 0, W, H], jnp.int32), (N, 4)
        )
        bbox = jnp.concatenate([bbox0[:, None], bbox_c], axis=1)
        bbox = jnp.where(present[:, :, None], bbox, 0).astype(jnp.int32)
    else:
        bbox = jnp.zeros((N, C + 1, 4), jnp.int32)
    return {
        "labels": dense,
        "count": count,
        "area": area,
        "bbox": bbox,
        "centroid": centroid,
        "centroid_sum": csum,
    }



@partial(jax.jit, static_argnames=("max_blobs",))
def extract_detections(stats: dict, min_area: int, max_blobs: int = 8):
    """Area-filter components and pack the first `max_blobs` (in cv2 label
    order) into fixed slots — the variable-length -> static-shape bridge
    (SURVEY.md §7.3).

    stats: batched output of connected_components_with_stats.
    Returns (dets (N, max_blobs, 3) float32 of (x, y, area), n_det (N,)
    int32, valid (N, max_blobs) bool, det_sums (N, max_blobs, 2) int32 of
    exact integer coordinate sums (sx, sy) for host-side float64 centroid
    division — bit-identical to cv2's m10/m00, m01/m00).
    """
    area = stats["area"][:, 1:]  # drop background row
    cent = stats["centroid"][:, 1:]
    csum = stats["centroid_sum"][:, 1:]
    count = stats["count"]
    N, C = area.shape
    comp_idx = jnp.arange(C, dtype=jnp.int32)
    valid = (area >= min_area) & (comp_idx[None, :] < count[:, None])
    rank = jnp.cumsum(valid, axis=1, dtype=jnp.int32)  # 1-based among valid
    slot = jnp.where(valid & (rank <= max_blobs), rank - 1, max_blobs)
    payload = jnp.concatenate(
        [cent, area[..., None].astype(jnp.float32)], axis=-1
    )

    # slot placement as a compare-masked sum, not a scatter: slots are
    # distinct per frame, so summing the one selected payload over C is
    # exact (0 + x == x in both f32 and int32) — the vmapped scatters this
    # replaces cost ~3 ms/batch at bench shapes (see CLAUDE.md avoid-list)
    onehot = (
        slot[:, None, :] == jnp.arange(max_blobs, dtype=jnp.int32)[None, :, None]
    )  # (N, max_blobs, C)
    dets = jnp.sum(
        jnp.where(onehot[..., None], payload[:, None, :, :], 0.0), axis=2
    )
    det_sums = jnp.sum(
        jnp.where(onehot[..., None], csum[:, None, :, :], 0), axis=2,
        dtype=jnp.int32,
    )
    n_det = jnp.minimum(rank[:, -1], max_blobs) if C else jnp.zeros(N, jnp.int32)
    det_valid = jnp.arange(max_blobs)[None, :] < n_det[:, None]
    return dets, n_det, det_valid, det_sums
