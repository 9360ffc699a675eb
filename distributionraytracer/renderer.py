"""High-level renderer facade: the equivalent of init_scene + renderScene.

Builds the scene's acceleration structure host-side once (grid.cpp:30-97 /
bvh.cpp:27-227 equivalents), keeps the tables device-resident, takes its
route from ``routing.select_route`` and exposes fully jitted render entry
points.  Accel tables cross the jit boundary as pytree
*arguments* so they are never embedded as device constants (see
tests/test_tracing_hygiene.py).

Usage:
    r = Renderer(load_p3f("scene.p3f"))
    img = r.render(jax.random.PRNGKey(0))        # batch mode (Zone B)
    state = r.progressive_init()
    state = r.progressive_step(state, key)       # Zone A frames
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from distributionraytracer.accel.bvh import (
    ThreadedBVH, build_bvh, make_threaded_intersectors, thread_bvh,
)
from distributionraytracer.accel.grid import (
    GridArrays, build_grid, make_grid_intersectors,
)
from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator.render import (
    SampleSet, default_config, make_samples, render_from_samples,
)
from distributionraytracer.routing import current_platform, select_route
from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, SceneData,
)


@partial(jax.jit, static_argnums=(1, 3))
def _render_none(scene, cfg, samples, return_rays=False):
    return render_from_samples(scene, cfg, samples, return_rays=return_rays)


@partial(jax.jit, static_argnums=(1, 5, 6))
def _render_grid(scene, cfg, grid: GridArrays, samples, row_offset, unroll,
                 return_rays=False):
    inter = make_grid_intersectors(scene, grid, cfg.motion_blur,
                                   unroll=unroll)
    return render_from_samples(scene, cfg, samples, row_offset=row_offset,
                               inter=inter, return_rays=return_rays)


@partial(jax.jit, static_argnums=(1, 5, 6))
def _render_bvh(scene, cfg, tbvh: ThreadedBVH, samples, row_offset, route,
                return_rays=False):
    if route == "bvh-triton":
        from distributionraytracer.accel.bvh_kernel import (
            make_kernel_intersectors,
        )
        inter = make_kernel_intersectors(scene, tbvh, cfg.motion_blur)
        # the per-ray walk carries no wavefront-wide loop state: the
        # frame's whole wavefront goes in one call
        cfg = cfg.replace(accel_tile_rays=cfg.tile_rays)
    else:
        inter = make_threaded_intersectors(scene, tbvh, cfg.motion_blur)
    return render_from_samples(scene, cfg, samples, row_offset=row_offset,
                               inter=inter, return_rays=return_rays)


class AccelTables(NamedTuple):
    """Host-built accel tables of one scene: GridArrays or ThreadedBVH
    (None for accel NONE) and the grid's static unroll factor (None unless
    GRID)."""

    tables: object
    grid_unroll: Optional[int]


def build_accel(scene: SceneData, verbose: bool = False) -> AccelTables:
    """Build the scene's accel structure host-side (grid.cpp:30-97 /
    bvh.cpp:27-227 equivalents) and device_put the tables once.
  Both the XLA traversals and the Triton BVH kernel read these
    tables, and they thread through jit / shard_map as pytree arguments.
    """
    st = scene.static
    t0 = time.perf_counter()
    tables, unroll = None, None
    if st.accel == ACCEL_GRID:
        from distributionraytracer.accel.grid import _pick_unroll
        grid = build_grid(scene)
        unroll = _pick_unroll(grid.cell_start)
        tables = jax.device_put(grid)
        if verbose:
            n = tables.ncells
            print(f"GRID: total cells = {int(n[0]*n[1]*n[2])}, "
                  f"total objects = {st.n_objects}, ResX = {int(n[0])}, "
                  f"ResY = {int(n[1])}, ResZ = {int(n[2])}")
    elif st.accel == ACCEL_BVH:
        # build + DFS-renumber host-side (all numpy), one device_put
        tables = jax.device_put(thread_bvh(build_bvh(scene)))
        if verbose:
            print(f"BVH: {tables.node_box.shape[0]} nodes over "
                  f"{st.n_objects} objects (threaded)")
    if verbose and st.accel != ACCEL_NONE:
        print(f"accel build: {time.perf_counter() - t0:.2f}s")
    return AccelTables(tables, unroll)


class Renderer:
    def __init__(self, scene: SceneData, cfg: Optional[RenderConfig] = None,
                 verbose: bool = False):
        self.cfg = cfg if cfg is not None else default_config(scene)
        self.scene = scene.device_put()
        self.accel = scene.static.accel
        self.tables, self.grid_unroll = build_accel(scene, verbose=verbose)
        # the route every render of this Renderer takes
        self.route = select_route(scene, self.cfg, current_platform())

    # ------------------------------------------------------------- batch
    def render_with_samples(self, samples: SampleSet, return_rays=False):
        off = jnp.zeros((), jnp.float32)
        if self.accel == ACCEL_NONE:
            return _render_none(self.scene, self.cfg, samples, return_rays)
        if self.accel == ACCEL_GRID:
            return _render_grid(self.scene, self.cfg, self.tables, samples,
                                off, self.grid_unroll, return_rays)
        return _render_bvh(self.scene, self.cfg, self.tables, samples, off,
                           self.route, return_rays)

    def render(self, key=None, return_rays=False):
        """Full Zone-B render (main.cpp:602-737): returns (H, W, 3) f32.

        ``return_rays=True`` also returns the exact traced-ray count
        (primary tree nodes + shadow rays, from the integrator's per-level
        counters) — the denominator for rays/s."""
        if key is None:
            key = jax.random.PRNGKey(0)
        samples = make_samples(self.scene, self.cfg, key)
        return self.render_with_samples(samples, return_rays=return_rays)

    # ------------------------------------------------------ progressive
    def progressive_init(self):
        from distributionraytracer.integrator.render import (
            progressive_init,
        )
        return progressive_init(self.scene)

    def progressive_step(self, state, key):
        """One Zone-A frame (main.cpp:536-599) under the scene's accel."""
        import numpy as np
        from distributionraytracer.ops import sampling
        st = self.scene.static
        H, W = st.res_y, st.res_x
        k1, k2, k3, k4 = jax.random.split(key, 4)
        samples = SampleSet(
            pixel=jax.random.uniform(k1, (H, W, 1, 2)),
            light=jax.random.uniform(k2, (H, W, 1, 2)),
            lens=sampling.unit_disk(k3, (H, W, 1)),
            time=(jax.random.uniform(k4, (H, W, 1))
                  if self.cfg.motion_blur
                  else np.zeros((H, W, 1), np.float32)))
        frame = self.render_with_samples(samples)
        mean, count = state
        new_count = jnp.minimum(count + 1.0, float(self.cfg.max_samples))
        upd = count < float(self.cfg.max_samples)
        mean = jnp.where(upd, mean + (frame - mean) / new_count, mean)
        return (mean, jnp.where(upd, new_count, count))

    # ------------------------------------------------------- checkpoint
    def save_progressive(self, path: str, state):
        """Checkpoint the (mean, count) accumulator — the resumable analog
        of the reference's colors[]/FrameCount buffer (main.cpp:574-586)."""
        import numpy as np
        mean, count = state
        np.savez(path, mean=np.asarray(mean), count=np.asarray(count))

    def load_progressive(self, path: str):
        import numpy as np
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return (jnp.asarray(z["mean"]), jnp.asarray(z["count"]))
