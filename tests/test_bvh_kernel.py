"""The per-ray Triton BVH walk (interpret mode here) vs the XLA traversal.

Both walk the same threaded tables with the same step and the same
primitive math, so every winner and ``t`` must be identical, lane for
lane.  The
compiled kernel is checked on the card by the ``gpu`` test at the end and
by ``chip_smoke.py``.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributionraytracer.accel.bvh import (
    build_bvh, make_threaded_intersectors, thread_bvh,
)
from distributionraytracer.accel.bvh_kernel import make_kernel_intersectors
from tests.test_accel import random_rays, random_scene


def _pair(scene, motion_blur=False):
    tb = thread_bvh(build_bvh(scene))
    return (make_threaded_intersectors(scene, tb, motion_blur),
            make_kernel_intersectors(scene, tb, motion_blur, interpret=True))


def _assert_same_hits(a, b):
    for f in ("hit", "t", "obj_id", "mat_id"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    # the kernel normalizes the winner's normal once, after its loop; XLA
    # fuses the same formula into the loop and may round it 1 ulp apart
    np.testing.assert_allclose(np.asarray(a.normal), np.asarray(b.normal),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("motion_blur", [False, True])
def test_closest_matches_xla(motion_blur):
    scene = random_scene()
    xla, kern = _pair(scene, motion_blur)
    n = 300  # not a multiple of the block: the wrapper pads
    o, d = random_rays(n)
    rng = np.random.default_rng(0)
    time = jnp.asarray(rng.random(n), jnp.float32)
    valid = rng.random(n) < 0.8
    a = xla.closest(o, d, time, valid=valid)
    b = kern.closest(o, d, time, valid=valid)
    _assert_same_hits(a, b)
    assert np.asarray(b.hit)[valid].mean() > 0.03  # the rays hit something


@pytest.mark.parametrize("motion_blur", [False, True])
def test_any_hit_matches_xla(motion_blur):
    scene = random_scene(seed=4)
    xla, kern = _pair(scene, motion_blur)
    n = 256
    o, d = random_rays(n, seed=5)
    rng = np.random.default_rng(6)
    dist = jnp.asarray(rng.uniform(0.5, 10, n), jnp.float32)
    valid = rng.random(n) < 0.7
    excl = jnp.full((n,), -1, jnp.int32)
    a = np.asarray(xla.shadow(o, d, dist, excl, valid=valid))
    b = np.asarray(kern.shadow(o, d, dist, excl, valid=valid))
    np.testing.assert_array_equal(a, b)
    assert 0 < b[valid].sum() < valid.sum()


def test_dead_lanes_do_nothing():
    """Lanes with valid=False start finished: no hit, no occlusion."""
    scene = random_scene()
    _, kern = _pair(scene)
    n = 128
    o, d = random_rays(n)
    valid = np.zeros(n, bool)
    h = kern.closest(o, d, jnp.zeros(n), valid=valid)
    assert not np.asarray(h.hit).any()
    assert (np.asarray(h.obj_id) == -1).all()
    occ = kern.shadow(o, d, jnp.full((n,), 100.0), jnp.full((n,), -1),
                      valid=valid)
    assert not np.asarray(occ).any()


def test_mesh_100k_primary_and_shadow(scenes_dir):
    """The 100k-triangle glass+metal mesh scene, primary rays of a 16x16
    crop plus their shadow rays: identical to the XLA traversal."""
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.render import (
        _rays_from_samples, make_samples,
    )
    from distributionraytracer.scene import load_p3f
    scene = load_p3f(os.path.join(scenes_dir, "dragon_assignment1.p3f"))
    assert scene.static.n_triangles == 100000
    scene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, res_x=16, res_y=16)).device_put()
    cfg = RenderConfig(spp=0)
    o, d, t, _ = _rays_from_samples(
        scene, cfg, make_samples(scene, cfg, jax.random.PRNGKey(0)))
    xla, kern = _pair(scene)
    a = xla.closest(o, d, t)
    b = kern.closest(o, d, t)
    _assert_same_hits(a, b)
    assert np.asarray(b.hit).mean() > 0.3
    hp = np.asarray(o) + np.asarray(d) * np.asarray(a.t)[:, None]
    L = np.asarray(scene.light_pos)[0] - hp
    dist = np.linalg.norm(L, axis=1)
    L = L / np.maximum(dist, 1e-12)[:, None]
    org = jnp.asarray(hp + np.asarray(a.normal) * 1e-4, jnp.float32)
    excl = jnp.full((o.shape[0],), -1)
    np.testing.assert_array_equal(
        np.asarray(xla.shadow(org, jnp.asarray(L, jnp.float32),
                              jnp.asarray(dist, jnp.float32), excl,
                              valid=a.hit)),
        np.asarray(kern.shadow(org, jnp.asarray(L, jnp.float32),
                               jnp.asarray(dist, jnp.float32), excl,
                               valid=a.hit)))


def test_render_through_kernel_matches_xla(scenes_dir):
    """A whole depth-4 refl+refr render with the kernel as the intersector
    equals the render with the XLA traversal."""
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.render import (
        make_samples, render_from_samples,
    )
    from distributionraytracer.scene import load_p3f
    from distributionraytracer.scene.types import ACCEL_BVH
    scene = load_p3f(os.path.join(scenes_dir, "teste.p3f"))
    scene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, res_x=12, res_y=8, accel=ACCEL_BVH)).device_put()
    cfg = RenderConfig(spp=1)
    samples = make_samples(scene, cfg, jax.random.PRNGKey(1))
    xla, kern = _pair(scene)
    a = render_from_samples(scene, cfg, samples, inter=xla)
    b = render_from_samples(scene, cfg, samples, inter=kern)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(b).std() > 0.01


def test_under_shard_map_on_four_devices():
    """Called per shard inside shard_map (rays split over 4 devices, tables
    replicated), the kernel gives the unsharded results."""
    from distributionraytracer.parallel.mesh import make_device_mesh
    scene = random_scene(seed=2)
    tb = jax.device_put(thread_bvh(build_bvh(scene)))
    mesh = make_device_mesh(4)
    n = 512
    o, d = random_rays(n, seed=3)
    ref = make_kernel_intersectors(scene, tb, interpret=True).closest(
        o, d, jnp.zeros(n))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P("devices"),
                                                 P("devices")),
             out_specs=(P("devices"), P("devices")), check_vma=False)
    def sharded(scene_rep, tb_rep, o, d):
        k = make_kernel_intersectors(scene_rep, tb_rep, interpret=True)
        h = k.closest(o, d, jnp.zeros(o.shape[0]))
        return h.t, h.obj_id

    t, gid = sharded(scene, tb, o, d)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(gid), np.asarray(ref.obj_id))


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The kernel as compiled for the card vs the XLA traversal there."""
    scene = jax.device_put(random_scene(n_spheres=200, n_tris=300), gpu)
    tb = jax.device_put(thread_bvh(build_bvh(scene)), gpu)
    xla = make_threaded_intersectors(scene, tb)
    kern = make_kernel_intersectors(scene, tb)
    o, d = random_rays(4096)
    o, d = jax.device_put(o, gpu), jax.device_put(d, gpu)
    a = xla.closest(o, d, jnp.zeros(4096))
    b = kern.closest(o, d, jnp.zeros(4096))
    np.testing.assert_array_equal(np.asarray(a.obj_id), np.asarray(b.obj_id))
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=1e-5)
