#!/usr/bin/env python
"""Two stage forms on one GPU, each against the form the library keeps,
at BASELINE config 3's batch (256 x 1080p, 32 component slots):

- stats: the library's exact int32 segment sums (`_stats_from_root`)
  against a bf16 one-hot contraction of shape (N, H*W, C) with a 6-bit
  limb payload, exact in f32 accumulation;
- background: the library's `background_trajectory` (products kept in
  separate arrays) against the one-expression scan ``(1-a)*B + a*F``.

For each form it prints the median device time of five runs after a warm
one (each ending in block_until_ready), the compiled temp bytes, and
whether its outputs are bit-equal: the stats forms to each other, the
background forms to NumPy's float32 ``(1-a)*B + a*F`` (refimpl's line).

    python bench/forms_probe.py

Exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from chip_smoke import H, W, front_end, timed  # noqa: E402

BG_CHECK_FRAMES = 16


def onehot_sums(root, max_components: int):
    """(area, sx, sy) per root-table slot through a bf16 one-hot matmul."""
    import jax
    import jax.numpy as jnp

    from tpuva.ops.label import _root_table

    N = root.shape[0]
    table, _ = _root_table(root, 8, max_components)
    flat = root.reshape(N, H * W)
    eq = (flat[:, :, None] == table[:, None, :]).astype(jnp.bfloat16)
    lin = jax.lax.broadcasted_iota(jnp.int32, (H * W,), 0)
    x, y = lin % W, lin // W
    # 6-bit limbs: bf16 holds integers to 256 exactly, and each pixel
    # matches at most one slot, so every f32 sum is exact below 2^24
    payload = jnp.stack(
        [jnp.ones_like(x), x & 63, (x >> 6) & 63, x >> 12,
         y & 63, (y >> 6) & 63, y >> 12], axis=-1,
    ).astype(jnp.bfloat16)
    s = jnp.einsum("npc,pk->nck", eq, payload,
                   preferred_element_type=jnp.float32).astype(jnp.int32)
    sx = s[..., 1] + (s[..., 2] << 6) + (s[..., 3] << 12)
    sy = s[..., 4] + (s[..., 5] << 6) + (s[..., 6] << 12)
    return s[..., 0], sx, sy


def library_sums(root, max_components: int):
    from tpuva.ops.label import _stats_from_root

    out = _stats_from_root(root, max_components=max_components,
                           compute_bbox=False, compute_labels=False)
    csum = out["centroid_sum"][:, 1:]
    return out["area"][:, 1:], csum[..., 0], csum[..., 1]


def plain_background(bg0, frames, alpha):
    from jax import lax
    import jax.numpy as jnp

    a = jnp.float32(alpha)

    def step(b, f):
        b = (jnp.float32(1) - a) * b + a * f
        return b, b

    return lax.scan(step, bg0, frames)[1]


def numpy_background(bg0, frames, alpha):
    a = np.float32(alpha)
    out, b = [], bg0
    for f in frames:
        b = (np.float32(1) - a) * b + a * f
        out.append(b)
    return np.stack(out)


def temp_bytes(fn, *args) -> int:
    return fn.lower(*args).compile().memory_analysis().temp_size_in_bytes


def probe(cfg, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from tpuva.graph.pipeline import background_trajectory, filter_batch
    from tpuva.ops.label import label_components

    C = bench.MAX_COMPONENTS
    clip, _, _, plate = bench.make_clip(H, W, cfg.batch)
    frames = jax.device_put(clip)
    bg0 = jax.device_put(plate.astype(np.float32))
    root = label_components(front_end(cfg)(frames, bg0))
    f32 = jax.jit(lambda x: filter_batch(cfg, x.astype(jnp.float32)))(frames)
    alpha = cfg.background.alpha

    stats = {
        "segment sums (library)": jax.jit(lambda r: library_sums(r, C)),
        "bf16 one-hot": jax.jit(lambda r: onehot_sums(r, C)),
    }
    outs = {}
    for name, fn in stats.items():
        outs[name] = [np.asarray(v) for v in fn(root)]
        print(f"stats {name}: {timed(fn, root) * 1e3:.3f} ms per "
              f"{cfg.batch}-frame batch, temp {temp_bytes(fn, root)} B "
              f"({card})", flush=True)
    a, b = outs.values()
    print("stats forms bit-equal:",
          all(np.array_equal(x, y) for x, y in zip(a, b)), flush=True)

    want = numpy_background(plate.astype(np.float32),
                            np.asarray(f32[:BG_CHECK_FRAMES]), alpha)
    forms = {
        "products apart (library)": jax.jit(
            lambda b, f: background_trajectory(b, f, alpha)),
        "one expression": jax.jit(lambda b, f: plain_background(b, f, alpha)),
    }
    for name, fn in forms.items():
        got = np.asarray(fn(bg0, f32[:BG_CHECK_FRAMES]))
        print(f"background {name}: {timed(fn, bg0, f32) * 1e3:.3f} ms per "
              f"{cfg.batch}-frame batch, bit-equal to NumPy over "
              f"{BG_CHECK_FRAMES} frames: {np.array_equal(got, want)} "
              f"({int((got != want).sum())} values differ) ({card})",
              flush=True)


def main() -> int:
    import jax

    from tpuva.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"forms_probe: no GPU (found {dev.platform})", file=sys.stderr)
        return 2
    card = bench.nvidia_smi(dev.local_hardware_id)
    print(f"card: {card}", flush=True)
    enable_compilation_cache()
    probe(bench.build_config(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
