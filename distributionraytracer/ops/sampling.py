"""Counter-based sampling for the distribution effects.

The reference uses ``rand()`` with rejection loops (maths.h:101-116); those
diverge per lane in a batched program.  Here every random quantity comes from ``jax.random``
(threefry) with *analytic* disk/sphere sampling (polar transforms, as in the
GLSL side common.glsl:95-108).  Distributions match the reference's
(uniform disk / uniform ball); sequences of course differ, so tests feed the
same explicit sample arrays to both this renderer and the NumPy oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def unit_disk(key, shape):
    """Uniform on the unit disk, polar method (common.glsl:95-100)."""
    u = jax.random.uniform(key, shape + (2,))
    r = jnp.sqrt(u[..., 0])
    phi = u[..., 1] * (2.0 * jnp.pi)
    return jnp.stack([r * jnp.sin(phi), r * jnp.cos(phi)], axis=-1)


def unit_sphere(key, shape):
    """Uniform inside the unit ball, polar method (common.glsl:102-108)."""
    h = jax.random.uniform(key, shape + (3,))
    cos_theta = h[..., 0] * 2.0 - 1.0
    phi = h[..., 1] * (2.0 * jnp.pi)
    r = jnp.cbrt(h[..., 2])
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    return r[..., None] * jnp.stack(
        [sin_theta * jnp.sin(phi), sin_theta * jnp.cos(phi), cos_theta],
        axis=-1)


def unit_vector(key, shape):
    """Uniform direction (normalize of ball sample, common.glsl:110-113)."""
    v = unit_sphere(key, shape)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def stratified_jitter(key, spp: int, shape):
    """n x n stratified jittered samples in [0,1)^2 (main.cpp:626-633).

    ``spp`` must be a perfect square (the reference computes n = sqrt(spp)
    and only fills n*n samples; we require exactness).  Returns
    ``shape + (spp, 2)``; sample p sits in cell (p % n, p // n).
    """
    n = int(spp ** 0.5)
    if n * n != spp:
        n = max(n, 1)
    eps = jax.random.uniform(key, shape + (spp, 2))
    p = np.arange(spp)
    cell = np.stack([p % n, p // n], axis=-1).astype(np.float32)
    return (cell + eps) / n


def light_jitter_shuffled(key, spp: int, shape):
    """spp jittered light samples, Fisher-Yates shuffled (main.cpp:635-648).

    A fresh permutation per pixel decorrelates pixel and light strata.
    """
    k1, k2 = jax.random.split(key)
    s = jax.random.uniform(k1, shape + (spp, 2))
    # independent permutation per element of `shape`
    noise = jax.random.uniform(k2, shape + (spp,))
    order = jnp.argsort(noise, axis=-1)
    return jnp.take_along_axis(s, order[..., None], axis=-2)


def regular_grid(grid_res: int):
    """gridRes regular light samples for the no-AA quad-light path
    (main.cpp:687-692): u = (s % g + .5)/g, v = (s // g + .5)/g."""
    g = int(grid_res ** 0.5)
    s = np.arange(grid_res)
    u = ((s % g + 0.5) / g).astype(np.float32)
    v = ((s // g + 0.5) / g).astype(np.float32)
    return np.stack([u, v], axis=-1)
