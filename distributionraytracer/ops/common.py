"""Small batched vector helpers shared by all kernels.

Everything operates on ``(..., 3)`` float32 arrays; the last axis is xyz.
``EPSILON`` matches the reference (macros.h:1).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

EPSILON = 1e-3
# NB: numpy scalar, NOT a jnp array: eager jnp constants created at import
# or inside traced code become device-committed arrays whose values must be
# fetched back from the device during lowering
# (tests/test_tracing_hygiene.py).
FLT_MAX = np.float32(3.402823466e38)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(dot(a, a))


def normalize(a):
    """Plain normalize; NaN/inf on zero vectors like ``Vector::normalize``."""
    return a / length(a)[..., None]


def safe_normalize(a, eps=1e-20):
    """Normalize with a zero-safe denominator (for gradient paths).

    Uses the double-where trick so the backward pass through the zero branch
    produces zeros, not NaNs.
    """
    l2 = dot(a, a)
    safe = jnp.where(l2 > eps, l2, 1.0)
    return jnp.where(l2[..., None] > eps, a / jnp.sqrt(safe)[..., None], 0.0)


def safe_sqrt(x, eps=0.0):
    """sqrt with a zero gradient at 0 instead of inf."""
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, jnp.sqrt(safe), eps)


def safe_div(a, b, eps=1e-20):
    safe = jnp.where(jnp.abs(b) > eps, b, 1.0)
    return jnp.where(jnp.abs(b) > eps, a / safe, 0.0)


def clamp_color(c):
    """``Color::clamp`` to [0,1] (color.h:38-43)."""
    return jnp.clip(c, 0.0, 1.0)


def u8fromfloat(x):
    """float -> byte with the reference's x*255.99 saturate (maths.h:126-130)."""
    v = x * 255.99
    return jnp.where(v >= 255.0, 255, v.astype(jnp.uint8))
