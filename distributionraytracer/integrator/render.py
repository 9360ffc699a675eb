"""Render orchestration: sampling modes, tiling, progressive accumulation.

Mirrors ``renderScene`` (main.cpp:525-738):

- Zone B.1 (AA, spp > 0): n x n stratified jittered pixel samples + shuffled
  jittered light samples (main.cpp:618-671), optional thin-lens DOF
  (main.cpp:655-660), optional per-sample time jitter (main.cpp:612-615).
- Zone B.2 (no AA, spp == 0): center pixel sample; if light 0 is a quad,
  average over its gridRes regular light samples (main.cpp:674-703).
- Zone A (progressive): one jittered sample per pixel per call with a
  running-mean update ``lerp(old, new, 1/frame)`` (main.cpp:536-599).

The *entire* pipeline — sample generation, camera ray gen, the Whitted ray
tree, and the sample average — lives inside one jitted function: one
compile and one dispatch per render call, no host round trip in between.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator.whitted import (
    Intersectors, trace_whitted,
)
from distributionraytracer.ops import sampling
from distributionraytracer.ops.camera import primary_rays, thin_lens_rays
from distributionraytracer.scene.types import SceneData, derive_camera


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SampleSet:
    """Explicit per-pixel-sample random numbers.

    Shapes: ``pixel (H,W,S,2)`` jitter in [0,1)^2 (already stratified for AA
    mode), ``light (H,W,S,2)`` in [0,1)^2, ``lens (H,W,S,2)`` unit-disk
    samples in [-1,1]^2 (scaled by aperture/2 internally, main.cpp:657-660),
    ``time (H,W,S)`` in [0,1).  Tests feed identical arrays to the NumPy
    oracle for bit-tight comparisons.
    """

    pixel: jnp.ndarray
    light: jnp.ndarray
    lens: jnp.ndarray
    time: jnp.ndarray

    def tree_flatten(self):
        return (self.pixel, self.light, self.lens, self.time), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def default_config(scene: SceneData, **overrides) -> RenderConfig:
    """AA iff spp != 0; DOF iff aperture != 0 and AA (main.cpp:1004-1017)."""
    st = scene.static
    spp = st.spp
    cfg = RenderConfig(
        spp=spp,
        dof=(st.aperture_ratio != 0.0 and spp > 0))
    return cfg.replace(**overrides) if overrides else cfg


def _sample_count(scene: SceneData, cfg: RenderConfig) -> int:
    """Samples per pixel actually traced (S)."""
    st = scene.static
    if cfg.spp > 0:
        return cfg.spp
    if st.n_lights and st.light_quad[0]:
        return int(st.light_grid[0])  # regular light grid (main.cpp:684)
    return 1


def make_samples(scene: SceneData, cfg: RenderConfig, key,
                 rows: Optional[int] = None) -> SampleSet:
    """Draw a SampleSet; jit-safe (static shapes from scene/cfg)."""
    st = scene.static
    H = st.res_y if rows is None else rows
    W = st.res_x
    k1, k2, k3, k4 = jax.random.split(key, 4)
    if cfg.spp > 0:
        S = cfg.spp
        pixel = sampling.stratified_jitter(k1, S, (H, W))
        light = sampling.light_jitter_shuffled(k2, S, (H, W))
    else:
        S = _sample_count(scene, cfg)
        pixel = np.full((H, W, S, 2), 0.5, np.float32)
        if st.n_lights and st.light_quad[0]:
            light = np.broadcast_to(sampling.regular_grid(S),
                                    (H, W, S, 2)).copy()
        else:
            light = np.full((H, W, S, 2), 0.5, np.float32)
    lens = (sampling.unit_disk(k3, (H, W, S)) if cfg.dof
            else np.zeros((H, W, S, 2), np.float32))
    time = (jax.random.uniform(k4, (H, W, S)) if cfg.motion_blur
            else np.zeros((H, W, S), np.float32))
    return SampleSet(pixel=pixel, light=light, lens=lens, time=time)


def _rays_from_samples(scene: SceneData, cfg: RenderConfig,
                       samples: SampleSet, row_offset=0):
    """Build the flat primary-ray batch from a SampleSet.

    ``row_offset`` shifts the pixel-grid y coordinates — used when a shard
    renders a horizontal slab of the image (parallel.mesh).
    """
    H, W, S = samples.time.shape
    cam = derive_camera(scene)
    xy = np.stack(
        np.meshgrid(np.arange(W, dtype=np.float32),
                    np.arange(H, dtype=np.float32),
                    indexing="xy"),
        axis=-1)  # (H,W,2) = (x,y)
    # row_offset may be a traced scalar (sharded slabs); keep the base grid
    # a host constant and add the offset as a (possibly traced) op
    xy = xy + np.array([0.0, 1.0], np.float32) * row_offset
    pix = xy[:, :, None, :] + samples.pixel  # viewport coords
    time = samples.time if cfg.motion_blur else np.zeros(
        samples.time.shape, np.float32)
    if cfg.dof:
        lens = samples.lens * (cam.aperture / 2.0)
        o, d, t = thin_lens_rays(cam, lens, pix, time)
    else:
        o, d, t = primary_rays(cam, pix, time)
    n = H * W * S
    ls3 = jnp.concatenate(
        [samples.light, jnp.zeros_like(samples.light[..., :1])], axis=-1)
    return (o.reshape(n, 3), d.reshape(n, 3), t.reshape(n),
            ls3.reshape(n, 3))


def _block_perm(H: int, W: int, S: int, tile: int = 1024) -> np.ndarray:
    """Ray permutation grouping ~``tile`` rays into square pixel blocks.

    The flat (H, W, S) row-major ray order puts 1024 consecutive rays on
    an 8x128-pixel *strip* — a frustum spanning the whole image
    width, whose per-packet BVH/grid node union is enormous.  Square blocks
    (e.g. 32x32 pixels at S = 1) shrink the union by an order of magnitude.
    Host-side constant; the inverse gather restores image order, so output
    values are bit-identical.
    """
    per = max(tile // max(S, 1), 1)
    bw = 1
    while bw * bw < per:
        bw *= 2
    bh = max(per // bw, 1)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    order = np.lexsort((xx.ravel() % bw, yy.ravel() % bh,
                        (xx // bw).ravel(), (yy // bh).ravel()))
    return (order[:, None] * S + np.arange(S)).ravel().astype(np.int32)


def render_from_samples(scene: SceneData, cfg: RenderConfig,
                        samples: SampleSet, row_offset=0,
                        inter: Optional[Intersectors] = None,
                        average: bool = True, return_rays: bool = False):
    """Trace a SampleSet; pure function, safe to jit / shard_map / grad.

    ``return_rays=True`` additionally returns the integrator's exact
    traced-ray count (tree nodes + shadow rays, whitted.py counters) as a
    scalar — the honest denominator for rays/s.  Tile-padding lanes are
    included in the count (0 when the batch divides the tile, < one tile
    otherwise).
    """
    H, W, S = samples.time.shape
    o, d, t, ls = _rays_from_samples(scene, cfg, samples, row_offset)

    perm = None
    if inter is not None:
        # accelerated traversal runs rays in lock-step blocks: group rays
        # into coherent pixel blocks (values unchanged — inverse-gathered
        # below)
        perm = _block_perm(H, W, S)
        o, d, t, ls = o[perm], d[perm], t[perm], ls[perm]

    n = o.shape[0]
    tile = min(cfg.tile_rays if inter is None else cfg.accel_tile_rays, n)
    pad = (-n) % tile
    if pad:
        padf = lambda a: jnp.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        o, d, t, ls = padf(o), padf(d), padf(t), padf(ls)
    nt = (n + pad) // tile

    def trace(args):
        if cfg.soft_silhouette > 0.0 and inter is None:
            from distributionraytracer.integrator.whitted import (
                trace_whitted_soft,
            )
            color, stats = trace_whitted_soft(scene, cfg, *args)
        else:
            color, stats = trace_whitted(scene, cfg, *args, inter=inter)
        return color, stats["rays_traced"] + stats["shadow_rays"]

    if nt == 1:
        colors, nrays = trace((o, d, t, ls))
    else:
        shape2 = lambda a: a.reshape((nt, tile) + a.shape[1:])
        colors, nrays = jax.lax.map(
            trace, (shape2(o), shape2(d), shape2(t), shape2(ls)))
        nrays = jnp.sum(nrays)
    colors = colors.reshape(-1, 3)[:n]
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=np.int32)
        colors = colors[inv]
    colors = colors.reshape(H, W, S, 3)
    img = jnp.mean(colors, axis=2) if average else colors
    return (img, nrays) if return_rays else img


@partial(jax.jit, static_argnums=(1,))
def _render_with_key(scene: SceneData, cfg: RenderConfig, key):
    samples = make_samples(scene, cfg, key)
    return render_from_samples(scene, cfg, samples)


@partial(jax.jit, static_argnums=(1,))
def _render_with_samples(scene: SceneData, cfg: RenderConfig,
                         samples: SampleSet):
    return render_from_samples(scene, cfg, samples)


def render_image(scene: SceneData, cfg: Optional[RenderConfig] = None,
                 key=None, samples: Optional[SampleSet] = None,
                 average: bool = True, row_offset=0,
                 inter: Optional[Intersectors] = None):
    """Render the full image; returns (H, W, 3) float32, y=0 at the bottom
    (viewport convention, main.cpp:604-605).

    One fully-jitted dispatch when using the default intersectors; custom
    intersectors or non-default offsets fall back to an un-jitted wrapper
    (callers in hot paths should jit around render_from_samples themselves).
    """
    if cfg is None:
        cfg = default_config(scene)
    if samples is None and key is None:
        key = jax.random.PRNGKey(0)
    simple = (average and inter is None
              and (isinstance(row_offset, int) and row_offset == 0))
    if simple and samples is None:
        return _render_with_key(scene, cfg, key)
    if simple:
        return _render_with_samples(scene, cfg, samples)
    if samples is None:
        samples = make_samples(scene, cfg, key)
    return render_from_samples(scene, cfg, samples, row_offset, inter,
                               average)


# ----------------------------------------------------------------- progressive
def progressive_init(scene: SceneData):
    st = scene.static
    return (jnp.zeros((st.res_y, st.res_x, 3), jnp.float32),
            jnp.zeros((), jnp.float32))


@partial(jax.jit, static_argnums=(1,))
def progressive_step(scene: SceneData, cfg: RenderConfig, state, key):
    """One progressive frame: 1 jittered spp, running mean (main.cpp:574-586).

    The (mean, count) pair is an in-memory resumable state — the analog of
    the reference's colors[] buffer keyed by FrameCount; checkpoint it to
    pause/resume a long accumulation.
    """
    mean, count = state
    st = scene.static
    H, W = st.res_y, st.res_x
    k1, k2, k3, k4 = jax.random.split(key, 4)
    samples = SampleSet(
        pixel=jax.random.uniform(k1, (H, W, 1, 2)),
        light=jax.random.uniform(k2, (H, W, 1, 2)),
        lens=sampling.unit_disk(k3, (H, W, 1)),
        time=(jax.random.uniform(k4, (H, W, 1)) if cfg.motion_blur
              else jnp.zeros((H, W, 1), jnp.float32)))
    frame = render_from_samples(scene, cfg, samples)
    new_count = jnp.minimum(count + 1.0, float(cfg.max_samples))
    new_mean = mean + (frame - mean) / new_count
    # cap: stop updating once MAX_SAMPLES frames accumulated (main.cpp:537)
    upd = count < float(cfg.max_samples)
    mean = jnp.where(upd, new_mean, mean)
    return (mean, jnp.where(upd, new_count, count))
