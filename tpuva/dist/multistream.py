"""Multi-stream data-parallel pipeline over a ('stream',) device mesh
(component K, SURVEY.md §2.3; config 5, BASELINE.json:11).

The reference's only concurrency was a decode/process split over local
processes plus per-file cluster jobs (SURVEY.md §2.4). Here each camera
stream's FULL pipeline state (background model + track table) lives on its
own chip; `shard_map` over a ('stream',) mesh runs the identical jitted
batch program per shard with zero cross-chip traffic in steady state
(SURVEY.md §5.8) — results are merged on host per flush.

Without real devices, the same code runs on a simulated CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8, SURVEY.md §4.2) and,
on one device, as a vmap over the stream axis
(`make_multistream_processor(..., mesh=None)`); equivalence between the
two is tested.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from tpuva.graph.config import PipelineConfig
from tpuva.graph.pipeline import PipelineCarry, init_carry, process_batch


def make_stream_mesh(n_streams: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if len(devices) < n_streams:
        raise ValueError(
            f"need {n_streams} devices for a ('stream',) mesh, "
            f"have {len(devices)}"
        )
    return Mesh(np.array(devices[:n_streams]), ("stream",))


def init_multistream_carry(
    cfg: PipelineConfig, H: int, W: int, n_streams: int, background0=None
) -> PipelineCarry:
    """Stacked per-stream carries with leading (n_streams,) axis.

    background0: optional (n_streams, H, W) per-stream clean plates."""
    def one(s):
        bg0 = None if background0 is None else background0[s]
        return init_carry(cfg, H, W, bg0)

    carries = [one(s) for s in range(n_streams)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *carries)


def make_multistream_processor(
    cfg: PipelineConfig,
    n_streams: int,
    mesh: Optional[Mesh] = None,
    parallel_bg: bool = False,
    max_components: int = 64,
):
    """Returns fn(carry_stacked, frames (S, N, H, W) uint8) ->
    (carry_stacked, out_stacked).

    mesh=None: single-device vmap over streams (same math, one device).
    mesh given: shard_map over ('stream',) — one stream per device."""

    def per_stream(carry: PipelineCarry, frames: jnp.ndarray):
        return process_batch(
            cfg,
            carry,
            frames,
            parallel_bg=parallel_bg,
            return_masks=False,
            max_components=max_components,
        )

    if mesh is None:
        return jax.jit(jax.vmap(per_stream))

    def shard_fn(carry, frames):
        # each shard sees leading stream dim of size 1
        carry1 = jax.tree.map(lambda x: x[0], carry)
        newc, out = per_stream(carry1, frames[0])
        return (
            jax.tree.map(lambda x: x[None], newc),
            jax.tree.map(lambda x: x[None], out),
        )

    specs = dict(
        mesh=mesh,
        in_specs=(P("stream"), P("stream")),
        out_specs=(P("stream"), P("stream")),
    )
    # the varying-manual-axes check trips on the scalar loop carries
    return jax.jit(shard_map(shard_fn, check_vma=False, **specs))


def merge_stream_rows(rows_by_stream, with_stream: bool = False):
    """Deterministically merge per-stream trajectory rows: track ids are
    remapped to (stream-major) globally unique ids, rows sorted by
    (stream, track_id, frame) — the same (track_id, frame) order the
    single-stream exporters use, applied stream-major.

    with_stream=True prepends the source stream index to every row
    (provenance for config-5 consumers): (stream, track_id_global, frame,
    x, y, area). rows_by_stream: list of row lists."""
    merged = []
    offset = 0
    for s, rows in enumerate(rows_by_stream):
        max_tid = 0
        for tid, frame, x, y, area in sorted(rows, key=lambda r: (r[0], r[1])):
            row = (tid + offset, frame, x, y, area)
            merged.append(((s,) + row) if with_stream else row)
            max_tid = max(max_tid, tid)
        offset += max_tid
    return merged
