"""Running-average background model (component A, SURVEY.md §2.3).

cv2.accumulateWeighted semantics (verified §8): ``B <- (1-alpha)*B +
alpha*F`` with a float32 accumulator. refimpl.pipeline pins the rounding:
each product rounds to float32, then their sum rounds.

The model is carried as `lax.scan` state across frame batches
(BASELINE.json:10 "rolling background model"), never leaving the device.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def background_scan(bg0: jnp.ndarray, frames: jnp.ndarray, alpha) -> jnp.ndarray:
    """All post-update backgrounds B_1..B_N of an (N, H, W) float32 batch,
    rounded as refimpl rounds them.

    The two products live in separate arrays: alpha*F for the whole batch
    before the scan, and (1-alpha)*B carried from each step to the next.
    No addition then sees a multiplication it could contract into a fused
    multiply-add, which rounds once instead of twice and changes the bits
    (XLA's CPU backend contracts ``c*B + a*F`` written in one expression).
    A one-step scan may be inlined by the compiler and lose that
    separation, so exactness is pinned for N >= 2."""
    a = jnp.float32(alpha)
    c = jnp.float32(1) - a

    def step(p, q):
        b = p + q
        return c * b, b

    _, bgs = lax.scan(step, c * bg0, a * frames)
    return bgs
