"""Multi-device rendering and training over a jax.sharding.Mesh.

The reference's only parallelism is OpenMP threads over pixels
(main.cpp:538, 603).  The equivalent here is pixel-tile data parallelism:
the image's rows are sharded over a flat ``'devices'`` axis via
``shard_map``, the scene (primitives, materials, BVH/grid tables, cubemaps)
is replicated to every card, and the forward pass is embarrassingly
parallel.  For differentiable rendering the parameter gradients are
``psum``-reduced inside the mapped function (NCCL all-reduce over NVLink
between the cards of a host), so the all-reduce overlaps the per-shard
backward work under XLA's scheduler.  Cards joined all to all need no
mesh shape beyond the flat axis.

Across hosts the same code runs after ``jax.distributed.initialize()``;
the mesh simply spans all processes' devices.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator.render import (
    SampleSet, make_samples, render_from_samples,
)
from distributionraytracer.routing import current_platform, select_route
from distributionraytracer.scene.types import SceneData


def accel_intersectors(scene: SceneData, cfg: RenderConfig, accel,
                       grid_unroll=None, differentiable=False):
    """Intersectors for any accel-table pytree (or None for brute force).

    Dispatches on the pytree's container type, so it works on concrete
    tables and on traced tables inside ``jit``/``shard_map`` alike — the
    reference parallelizes its pixel loop *with* the accel structure
    (main.cpp:603 dispatching to grid.cpp:247 / bvh.cpp:231); the sharded
    paths must too, not silently brute-force.  BVH tables take the route
    ``routing.select_route`` gives (the Triton walk on a GPU).

    ``grid_unroll`` (static int) is required for GridArrays under tracing;
    concrete tables derive it from cell occupancy when omitted.

    ``differentiable=True`` runs the (non-reverse-differentiable)
    ``while_loop`` traversal under stop_gradient to pick winners and
    recomputes the winning hits differentiably — see
    ``integrator.whitted.differentiable_intersectors``.
    """
    if differentiable:
        from distributionraytracer.integrator.whitted import (
            brute_intersectors, differentiable_intersectors,
        )
        sg = lambda tree: jax.tree_util.tree_map(
            lambda x: jax.lax.stop_gradient(x) if hasattr(x, "dtype") else x,
            tree)
        if accel is None:
            # brute force gets the same wrapper as the traversals, which is
            # gradient-equivalent to differentiating its where-selects
            base = brute_intersectors(sg(scene), cfg)
        else:
            base = accel_intersectors(sg(scene), cfg, sg(accel), grid_unroll)
        return differentiable_intersectors(scene, cfg, base)
    if accel is None:
        return None
    from distributionraytracer.accel.bvh import (
        ThreadedBVH, make_threaded_intersectors,
    )
    from distributionraytracer.accel.grid import (
        GridArrays, _pick_unroll, make_grid_intersectors,
    )
    if isinstance(accel, GridArrays):
        if grid_unroll is None:
            grid_unroll = _pick_unroll(accel.cell_start)
        return make_grid_intersectors(scene, accel, cfg.motion_blur,
                                      unroll=grid_unroll)
    if not isinstance(accel, ThreadedBVH):
        raise TypeError(f"unknown accel tables: {type(accel)}")
    if select_route(scene, cfg, current_platform()) == "bvh-triton":
        from distributionraytracer.accel.bvh_kernel import (
            make_kernel_intersectors,
        )
        return make_kernel_intersectors(scene, accel, cfg.motion_blur)
    return make_threaded_intersectors(scene, accel, cfg.motion_blur)


def _static_grid_unroll(accel, grid_unroll):
    """Resolve the static unroll factor host-side, before tracing."""
    from distributionraytracer.accel.grid import GridArrays, _pick_unroll
    if grid_unroll is None and isinstance(accel, GridArrays):
        return _pick_unroll(accel.cell_start)
    return grid_unroll


def maybe_init_distributed(verbose: bool = False) -> bool:
    """Multi-host wiring: call ``jax.distributed.initialize()`` when a
    coordinator is configured, so the same Mesh/shard_map code spans
    several hosts (SURVEY §7 step 10).

    Opt-in via environment: the explicit triple ``DRT_COORDINATOR``
    (``host:port``), ``DRT_NUM_PROCESSES`` and ``DRT_PROCESS_ID``, or
    ``DRT_DISTRIBUTED=1`` where a cluster manager JAX knows (SLURM, or the
    ``JAX_COORDINATOR_ADDRESS`` variables) describes the job.  Returns True
    when initialization ran.  Safe to call twice (second call is a no-op).
    """
    import os
    global _DISTRIBUTED
    if _DISTRIBUTED:
        return True
    coord = os.environ.get("DRT_COORDINATOR")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["DRT_NUM_PROCESSES"]),
            process_id=int(os.environ["DRT_PROCESS_ID"]))
    elif os.environ.get("DRT_DISTRIBUTED") == "1":
        jax.distributed.initialize()  # cluster-manager auto-detection
    else:
        return False
    _DISTRIBUTED = True
    if verbose:
        print(f"jax.distributed: process {jax.process_index()}/"
              f"{jax.process_count()}, {len(jax.devices())} devices")
    return True


_DISTRIBUTED = False


def make_device_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Flat ``'devices'`` mesh over the first ``n_devices`` devices (all by
    default).  Raises when fewer devices exist: there is no silent switch
    to another platform."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)}: {devs}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("devices",))


def _pad_rows(samples: SampleSet, ndev: int):
    H = samples.time.shape[0]
    pad = (-H) % ndev
    if pad == 0:
        return samples, H
    f = lambda a: jnp.concatenate(
        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
    return SampleSet(f(samples.pixel), f(samples.light), f(samples.lens),
                     f(samples.time)), H


@lru_cache(maxsize=32)
def _sharded_render(cfg: RenderConfig, mesh: Mesh, rows_per: int,
                    grid_unroll):
    """The jitted shard_map render for one (config, mesh, slab height,
    unroll): built once and reused, so repeated frames do not retrace and
    recompile.  (The cache holds the mesh alive; it is small and bounded.)"""

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("devices"), P()),
             out_specs=P("devices"), check_vma=False)
    def _shard(scene_rep, samp, accel_rep):
        off = jax.lax.axis_index("devices") * rows_per
        inter = accel_intersectors(scene_rep, cfg, accel_rep, grid_unroll)
        return render_from_samples(scene_rep, cfg, samp, row_offset=off,
                                   inter=inter)

    return _shard


def render_image_sharded(scene: SceneData, cfg: RenderConfig, mesh: Mesh,
                         key=None, samples: Optional[SampleSet] = None,
                         accel=None, grid_unroll=None):
    """Full-image render with rows sharded over the mesh.

    Scene *and accel tables* replicated; per-device slab offset from
    ``axis_index``.  ``accel`` is the table pytree of
    ``renderer.build_accel`` (GridArrays / ThreadedBVH) or None for brute
    force.  Returns (H, W, 3) with the same semantics as render_image.
    """
    if samples is None:
        if key is None:
            key = jax.random.PRNGKey(0)
        samples = make_samples(scene, cfg, key)
    ndev = mesh.devices.size
    samples, H = _pad_rows(samples, ndev)
    rows_per = samples.time.shape[0] // ndev
    grid_unroll = _static_grid_unroll(accel, grid_unroll)
    img = _sharded_render(cfg, mesh, rows_per, grid_unroll)(scene, samples,
                                                             accel)
    return img[:H]


def l2_render_loss(scene: SceneData, cfg: RenderConfig, samples: SampleSet,
                   target, row_offset=0, inter=None):
    img = render_from_samples(scene, cfg, samples, row_offset=row_offset,
                              inter=inter)
    return jnp.mean((img - target) ** 2)


def make_sharded_train_step(cfg: RenderConfig, mesh: Mesh, rows_per: int,
                            lr: float = 1e-2, update_leaves=None,
                            accel=None, grid_unroll=None):
    """Inverse-rendering step: grads of the image L2 loss w.r.t. every float
    scene leaf (materials, lights, camera, geometry, background), psum-ed
    over the mesh, applied with SGD.  ``update_leaves`` optionally names the
    SceneData fields to update (e.g. ("mat_cd", "mat_ks")); None updates all
    float leaves.  Int/bool leaves always pass through untouched.

    ``accel``: XLA accel tables (GridArrays / ThreadedBVH) used as a
    *constant example* — the returned ``step`` takes them as its fourth
    argument so the tables stay pytree inputs, never baked constants.
    Intersectors are rebuilt from the differentiated scene inside the loss,
    so gradients flow through traversal's intersection tests (traversal
    *ordering* is inherently discrete and carries no gradient).
    """

    from distributionraytracer.scene.types import SceneData as _SD
    leaf_names = _SD._LEAF_NAMES
    allowed = set(leaf_names if update_leaves is None else update_leaves)
    # gradients ride the differentiable wrappers: the while-loop traversal
    # runs under stop_gradient and the winning hits are recomputed
    # differentiably.  The XLA traversal is the one under training; the
    # Triton walk is forward-only.
    cfg = cfg.replace(accel_backend="xla")
    grid_unroll = _static_grid_unroll(accel, grid_unroll)

    def _is_float(x):
        return jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("devices"), P("devices"), P()),
             out_specs=(P(), P()), check_vma=False)
    def _step(scene, samp, target, accel_rep):
        off = jax.lax.axis_index("devices") * rows_per

        def loss_fn(s):
            inter = accel_intersectors(s, cfg, accel_rep, grid_unroll,
                                       differentiable=True)
            return l2_render_loss(s, cfg, samp, target, row_offset=off,
                                  inter=inter)

        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(scene)
        # all-reduce over the mesh (mean over shards)
        ndev = jax.lax.axis_size("devices")
        loss = jax.lax.psum(loss, "devices") / ndev
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, "devices") / ndev
            if _is_float(g) else g, grads)
        return loss, grads

    @jax.jit
    def _update(scene: SceneData, samples: SampleSet, target, accel):
        loss, grads = _step(scene, samples, target, accel)
        leaves, aux = scene.tree_flatten()
        gleaves, _ = grads.tree_flatten()
        new_leaves = [
            p - lr * g
            if (name in allowed and _is_float(p) and _is_float(g)) else p
            for name, p, g in zip(leaf_names, leaves, gleaves)]
        return loss, SceneData.tree_unflatten(aux, new_leaves)

    replicated = NamedSharding(mesh, P())

    def step(scene: SceneData, samples: SampleSet, target, accel=accel):
        # the updated scene comes back replicated over the mesh; placing
        # every input scene that way keeps one compiled program for all
        # steps (a first step from a single-device scene would otherwise
        # compile twice)
        return _update(jax.device_put(scene, replicated), samples, target,
                       accel)

    return step
