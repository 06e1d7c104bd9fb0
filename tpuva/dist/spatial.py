"""Spatial tensor parallelism: one video stream tiled across chips
(SURVEY.md §2.4 "TP": mesh ('space',), filters run on row bands with halo
exchange of kernel-radius rows via ppermute — the image analog of tensor
parallelism; also the honest analog of context parallelism for this
workload, §5.7).

Layout per chip: a horizontal band of every frame plus the band of the
background-model carry. Per batch:

1. band halos (blur radius + morphology reach rows) are exchanged with
   mesh neighbors via `lax.ppermute`; true image borders reconstruct
   their REFLECT_101 halo locally;
2. the full filter -> background -> threshold -> morphology front-end runs
   on the extended band (halo rows recomputed redundantly), with cv2
   border semantics enforced at true image borders only;
3. the tail is band-parallel too (round 2 — gen 1 `all_gather`ed full
   masks and replicated it): each chip labels ITS band with GLOBAL scan
   keys, then a fixed-point reconciliation loop exchanges only the 1-row
   band-edge labels via `ppermute` (labels decrease monotonically toward
   the component min, so cross-band propagation is an edge-min + local
   re-sweep); per-band stats are contracted locally (one-hot limb
   sums against the band's root table) and the tiny (C-entry) tables are
   `all_gather`ed and merged by ascending root key — exactly cv2's id
   order — on every chip. Only the O(max_components) tracker tail is
   replicated. Per-device tail work is ~1/n of the frame; the links carry
   2 rows of labels per reconciliation round + one C-row table gather,
   instead of the full H x W x N mask.

Bit-identical to the single-chip pipeline (tested on the simulated CPU
mesh). The multi-STREAM data-parallel mode (tpuva.dist.multistream) is the
production path (BASELINE.json:11); this mode exists for the
single-stream-multi-chip case.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpuva.graph.config import PipelineConfig
from tpuva.graph.pipeline import (
    PipelineCarry,
    _finish_batch,
    background_trajectory,
    filter_batch,
    init_carry,
)
from tpuva.ops import structuring_element, threshold
from tpuva.ops.filters import _morph
from tpuva.ops.label import (
    _assemble_stats,
    _neighbor_min_8,
    _scan_key,
    _segmented_min_scan,
)


def make_space_mesh(n_chips: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if len(devices) < n_chips:
        raise ValueError(f"need {n_chips} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_chips]), ("space",))


def _halo_rows(cfg: PipelineConfig) -> int:
    rb = cfg.blur.ksize // 2 if cfg.blur else 0
    rm = cfg.median.ksize // 2 if cfg.median else 0
    ro = (
        (cfg.morph_open.ksize // 2) * cfg.morph_open.iterations * 2
        if cfg.morph_open
        else 0
    )
    rc = (
        (cfg.morph_close.ksize // 2) * cfg.morph_close.iterations * 2
        if cfg.morph_close
        else 0
    )
    return max(1, rb + rm + ro + rc)


def make_spatial_processor(
    cfg: PipelineConfig,
    H: int,
    W: int,
    n_chips: int,
    mesh: Optional[Mesh] = None,
    max_components: int = 64,
):
    """Returns fn(carry, frames (N, H, W) uint8) -> (carry, out) with the
    same semantics as process_batch, executed band-parallel over the
    ('space',) mesh. carry.bg is sharded by rows; tracker state is
    replicated. H must divide evenly by n_chips."""
    if H % n_chips:
        raise ValueError(f"H={H} not divisible by n_chips={n_chips}")
    mesh = mesh or make_space_mesh(n_chips)
    halo = _halo_rows(cfg)
    Hb = H // n_chips
    if halo > Hb:
        raise ValueError("halo larger than band; use fewer chips")
    if Hb < 2:
        raise ValueError("band must be at least 2 rows")

    fwd = [(i, i + 1) for i in range(n_chips - 1)]  # send down
    bwd = [(i + 1, i) for i in range(n_chips - 1)]  # send up

    def exchange(x, axis_rows):
        """Extend a per-shard (N, Hb, W) array by `halo` rows on each side:
        interior halos via ppermute; true borders via local REFLECT_101."""
        idx = lax.axis_index("space")
        top_own = x[:, :halo]
        bot_own = x[:, -halo:]
        from_above = lax.ppermute(bot_own, "space", fwd)  # my top halo
        from_below = lax.ppermute(top_own, "space", bwd)  # my bottom halo
        # REFLECT_101 at the true image borders (row 0 reflects to row 1..)
        reflect_top = x[:, 1 : halo + 1][:, ::-1]
        reflect_bot = x[:, -halo - 1 : -1][:, ::-1]
        top = jnp.where(idx == 0, reflect_top, from_above)
        bot = jnp.where(idx == n_chips - 1, reflect_bot, from_below)
        return jnp.concatenate([top, x, bot], axis=1)

    def band_morph(mask, in_img, mcfg, is_open):
        se = structuring_element(mcfg.shape, mcfg.ksize)
        first, second = (True, False) if is_open else (False, True)
        m = mask
        for erode_phase in (first, second):
            for _ in range(mcfg.iterations):
                ident = jnp.uint8(255) if erode_phase else jnp.uint8(0)
                m = jnp.where(in_img, m, ident)
                m = _morph(m, se, is_erode=erode_phase)
        return m

    def shard_fn(carry, frames):
        # per-shard shapes: carry.bg (Hb, W); frames (N, Hb, W)
        idx = lax.axis_index("space")
        f = exchange(frames.astype(jnp.float32), halo)
        f = filter_batch(cfg, f)
        bg_prev = exchange(carry.bg[None], halo)[0]
        bg0 = jnp.where(carry.bg_valid, bg_prev, f[0])
        bgs = background_trajectory(bg0, f, cfg.background.alpha, False)
        diff = jnp.abs(f - bgs)
        if cfg.segment.threshold == "otsu":
            # Per-frame Otsu needs the GLOBAL 256-bin histogram. Each band
            # histograms its interior rows only (halos duplicate neighbor
            # interiors / reflect rows and would double-count) and a psum
            # over ('space',) assembles the exact global counts — f32
            # integer counts stay exact under the collective. Same rint
            # quantize + strict int compare as process_batch's jnp path,
            # so bands agree bit-identically with the single-chip mask.
            from tpuva.ops.filters import histogram_u8, otsu_from_histogram

            du8 = jnp.clip(jnp.rint(diff), 0, 255).astype(jnp.uint8)
            hist = lax.psum(histogram_u8(du8[:, halo : halo + Hb]), "space")
            thr = otsu_from_histogram(hist)
            mask = jnp.where(
                du8.astype(jnp.int32) > thr.astype(jnp.int32)[:, None, None],
                jnp.uint8(255),
                jnp.uint8(0),
            )
        else:
            mask = threshold(diff, cfg.segment.threshold)
        # morphology with cv2 constant-border semantics at TRUE borders
        rows = jnp.arange(-halo, Hb + halo)[None, :, None]
        gr = rows + idx * Hb
        in_img = (gr >= 0) & (gr < H)
        if cfg.morph_open is not None:
            mask = band_morph(mask, in_img, cfg.morph_open, True)
        if cfg.morph_close is not None:
            mask = band_morph(mask, in_img, cfg.morph_close, False)
        mask_band = mask[:, halo : halo + Hb]
        bg_band = bgs[-1][halo : halo + Hb]

        # ---- band-parallel CCL with GLOBAL scan keys (8-conn, block
        # raster — the cv2 id order the whole framework pins)
        N = frames.shape[0]
        _km, _inv, sent = _scan_key(H, W, 8)
        Wb2 = (W + 1) // 2
        rr = jnp.arange(Hb, dtype=jnp.int32)[:, None] + idx * Hb
        cc = jnp.arange(W, dtype=jnp.int32)[None, :]
        kv = ((rr >> 1) * Wb2 + (cc >> 1)) * 4 + (rr & 1) * 2 + (cc & 1)
        m = mask_band > 0
        lab0 = jnp.where(m, kv[None], jnp.int32(sent))

        def band_sweep(l, precheck=False):
            def sweep(label):
                label = jnp.where(
                    m, jnp.minimum(label, _neighbor_min_8(label, sent)), sent
                )
                label = _segmented_min_scan(label, m, 2, sent)
                label = _segmented_min_scan(label, m, 2, sent, reverse=True)
                label = _segmented_min_scan(label, m, 1, sent)
                label = _segmented_min_scan(label, m, 1, sent, reverse=True)
                return label

            def body(s):
                cur, _ = s
                new = sweep(cur)
                return new, jnp.any(new != cur)

            # precheck: a fixed point of the 8-neighbor min is a fixed
            # point of the directional run scans too (each scan is an
            # iterated neighbor-min along one axis), so one cheap
            # neighbor-min compare can skip the full sweep chain — this
            # makes reconciliation confirm rounds (edge exchange changed
            # nothing) cost one compare instead of a band sweep.
            if precheck:
                nb = jnp.where(
                    m, jnp.minimum(l, _neighbor_min_8(l, sent)), sent
                )
                ch0 = jnp.any(nb != l)
            else:
                ch0 = jnp.bool_(True)
            l, _ = lax.while_loop(lambda s: s[1], body, (l, ch0))
            return l

        lab_local = band_sweep(lab0)

        # ---- cross-band reconciliation: labels only DECREASE toward the
        # component min, so exchanging 1-row edge labels + re-sweeping the
        # band is a sound fixed-point loop (monotone min algebra); the
        # while condition is pmax-reduced so every chip agrees.
        def recon_body(s):
            l, _, rounds = s
            top = l[:, 0]
            bot = l[:, -1]
            from_above = lax.ppermute(bot, "space", fwd)
            from_below = lax.ppermute(top, "space", bwd)
            from_above = jnp.where(idx == 0, jnp.int32(sent), from_above)
            from_below = jnp.where(
                idx == n_chips - 1, jnp.int32(sent), from_below
            )

            def adj(nb):  # 8-conn: straight + diagonal partners
                le = jnp.pad(
                    nb, ((0, 0), (1, 0)), constant_values=sent
                )[:, :-1]
                ri = jnp.pad(
                    nb, ((0, 0), (0, 1)), constant_values=sent
                )[:, 1:]
                return jnp.minimum(nb, jnp.minimum(le, ri))

            new_top = jnp.where(
                m[:, 0], jnp.minimum(top, adj(from_above)), jnp.int32(sent)
            )
            new_bot = jnp.where(
                m[:, -1], jnp.minimum(bot, adj(from_below)), jnp.int32(sent)
            )
            l2 = jnp.concatenate(
                [new_top[:, None], l[:, 1:-1], new_bot[:, None]], axis=1
            )
            changed = lax.pmax(
                jnp.any(l2 != l).astype(jnp.int32), "space"
            )
            return band_sweep(l2, precheck=True), changed > 0, rounds + 1

        # rounds is observability (SURVEY §5.5): each round is one 2-row
        # ppermute exchange + a band re-sweep; interior scenes take
        # exactly 1 (the no-change confirm), band-spanning components
        # take O(bands the component chains through) — surfaced per batch
        # as out["tp_recon_rounds"] so pathological scenes are visible.
        # link traffic bound: per round, 2 rows x W x 4 B per device pair
        # (the edge labels) — ~15 KB/round at 1080p, negligible vs the
        # all_gather of the C-entry tables in the merge.
        lab, _, recon_rounds = lax.while_loop(
            lambda s: s[1], recon_body,
            (lab_local, jnp.bool_(True), jnp.int32(0)),
        )

        # ---- per-band component-value table + exact limb sums (global
        # coordinates). A band may hold pieces of a component whose root
        # pixel lives in ANOTHER band, so the contraction table lists the
        # distinct LABEL VALUES present in the band: one candidate per
        # band-local piece root (pre-reconciliation local minimum, unique
        # per piece), carrying the piece's post-reconciliation global
        # value, then deduplicated (a component may touch a band in
        # several disconnected pieces — double columns would double-count
        # the contraction).
        C = max_components
        root = jnp.where(m, lab + 1, 0)
        is_piece_root = m & (lab_local == kv[None])
        rootv = jnp.where(is_piece_root, lab + 1, 0).reshape(N, Hb * W)
        vals, _idx2 = lax.top_k(rootv, C)  # descending; dupes adjacent
        dup = jnp.concatenate(
            [jnp.zeros((N, 1), bool), vals[:, 1:] == vals[:, :-1]], axis=1
        )
        n_loc = jnp.sum((rootv > 0).astype(jnp.int32), axis=1)
        table = jnp.where((vals > 0) & ~dup, vals, jnp.int32(sent + 2))
        flat = root.reshape(N, Hb * W)
        eq = (flat[:, :, None] == table[:, None, :]).astype(jnp.bfloat16)
        lin = jax.lax.broadcasted_iota(jnp.int32, (Hb * W, 1), 0)[:, 0]
        x = lin % W
        y = lin // W + idx * Hb
        payload = jnp.stack(
            [
                jnp.ones_like(x),
                x & 63, (x >> 6) & 63, x >> 12,
                y & 63, (y >> 6) & 63, y >> 12,
            ],
            axis=-1,
        ).astype(jnp.bfloat16)  # (Hb*W, 7)
        # exact on any device: 0/1 and <= 63 operands are bf16-exact, and
        # f32 accumulation holds the limb sums exactly below 2^24
        sums = jnp.einsum(
            "npc,pk->nck", eq, payload, preferred_element_type=jnp.float32
        )  # (N, C, 7)

        # ---- tiny replicated merge: gather C-entry tables, aggregate
        # split components by key, rank ascending (= cv2 id order).
        # The (SC)^2 equality matrix is deliberate: SC = n_chips *
        # max_components (512 at 8 x 64), so eqm + the agg einsum are
        # ~N*SC*SC*7 flops (<0.5 GFLOP at batch 128), far below one band
        # sweep. Both merge einsums carry limb sums up to 2^24, which a
        # default-precision f32 matmul may round (TF32 keeps 10 mantissa
        # bits), so they run at HIGHEST precision.
        tabs = lax.all_gather(table, "space", axis=0)  # (S, N, C)
        sms = lax.all_gather(sums, "space", axis=0)  # (S, N, C, 7)
        S = n_chips
        K = jnp.moveaxis(tabs, 0, 1).reshape(N, S * C)
        V = jnp.moveaxis(sms, 0, 1).reshape(N, S * C, 7)
        eqm = (K[:, :, None] == K[:, None, :])  # (N, SC, SC)
        sc = jnp.arange(S * C, dtype=jnp.int32)
        first_idx = jnp.argmax(eqm, axis=2).astype(jnp.int32)
        is_first = first_idx == sc[None, :]
        agg = jnp.einsum(
            "nij,nik->njk", eqm.astype(jnp.float32), V,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )  # exact: integer limb sums < 2^24
        valid = is_first & (K <= sent)
        rank = jnp.sum(
            ((K[:, None, :] < K[:, :, None]) & valid[:, None, :]).astype(
                jnp.int32
            ),
            axis=2,
        )  # (N, SC)
        n_roots = jnp.sum(valid.astype(jnp.int32), axis=1)
        cs = jnp.arange(C, dtype=jnp.int32)
        oh = valid[:, None, :] & (rank[:, None, :] == cs[None, :, None])
        out_sums = jnp.einsum(
            "ncj,njk->nck", oh.astype(jnp.float32), agg,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        ).astype(jnp.int32)
        sx = out_sums[..., 1] + (out_sums[..., 2] << 6) + (
            out_sums[..., 3] << 12
        )
        sy = out_sums[..., 4] + (out_sums[..., 5] << 6) + (
            out_sums[..., 6] << 12
        )
        count, area, centroid, csum, _present = _assemble_stats(
            out_sums[..., 0], sx, sy, n_roots, H, W, C
        )
        stats = {
            "count": count,
            "area": area,
            "centroid": centroid,
            "centroid_sum": csum,
        }
        # accuracy-loss flag: a band with more PIECES than table capacity
        # drops their sums (wrong areas). Components beyond C globally are
        # the documented max_components cap (ascending scan-key order,
        # same as single-chip) — not an error.
        overflow = lax.psum(jnp.maximum(n_loc - C, 0), "space")

        rep_carry = PipelineCarry(
            bg=jnp.zeros((1, 1), jnp.float32),  # placeholder, not used
            bg_valid=carry.bg_valid,
            track=carry.track,
            frame_idx=carry.frame_idx,
        )
        new_rep, out = _finish_batch(
            cfg, rep_carry, stats, mask_band, jnp.zeros((1, 1), jnp.float32),
            False,
        )
        out["stats_overflow"] = overflow
        out["tp_recon_rounds"] = recon_rounds  # pmax'd cond => replicated
        new_carry = PipelineCarry(
            bg=bg_band,
            bg_valid=jnp.bool_(True),
            track=new_rep.track,
            frame_idx=new_rep.frame_idx,
        )
        return new_carry, out

    carry_specs = PipelineCarry(
        bg=P("space", None), bg_valid=P(), track=jax.tree.map(
            lambda _: P(), init_carry(cfg, H, W).track
        ), frame_idx=P(),
    )
    out_specs = {
        "rows": P(), "row_valid": P(), "n_det": P(), "row_sums": P(),
        "stats_overflow": P(), "active_tracks": P(),
        "tp_recon_rounds": P(),
    }
    specs = dict(
        mesh=mesh,
        in_specs=(carry_specs, P(None, "space", None)),
        out_specs=(carry_specs, out_specs),
    )
    return jax.jit(shard_map(shard_fn, check_vma=False, **specs))
