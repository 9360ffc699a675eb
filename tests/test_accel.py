"""Grid/BVH traversal agreement with brute-force intersection."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from distributionraytracer.accel.bvh import (
    build_bvh, make_bvh_intersectors, make_threaded_intersectors, thread_bvh,
)
from distributionraytracer.accel.grid import (
    build_grid, make_grid_intersectors, make_grid_scalar_intersectors,
)
from distributionraytracer.ops.intersect import closest_hit_brute
from distributionraytracer.scene import load_p3f
from distributionraytracer.scene.builder import SceneBuilder


def random_scene(n_spheres=40, n_tris=30, n_boxes=5, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.set_camera([0, 0, 10], [0, 0, 0], [0, 1, 0], 45, 0.01, 16, 16, 0, 1)
    m = b.add_material([0.5, 0.5, 0.5], 1, [1, 1, 1], 0.2, 10, 0, 1)
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.2, 1.0), m)
    for _ in range(n_tris):
        p0 = rng.uniform(-5, 5, 3)
        b.add_triangle(p0, p0 + rng.uniform(-1, 1, 3), p0 + rng.uniform(-1, 1, 3), m)
    for _ in range(n_boxes):
        lo = rng.uniform(-5, 4, 3)
        b.add_box(lo, lo + rng.uniform(0.2, 1.5, 3), m)
    b.add_point_light([0, 8, 0], [1, 1, 1])
    return b.build().device_put()


def random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.fixture(scope="module")
def scene():
    return random_scene()


def _check_closest(inter, scene, n=256):
    o, d = random_rays(n)
    time = jnp.zeros(n)
    ref = closest_hit_brute(scene, o, d, time, motion_blur=False)
    got = inter.closest(o, d, time)
    ref_hit = np.asarray(ref.hit)
    got_hit = np.asarray(got.hit)
    np.testing.assert_array_equal(got_hit, ref_hit)
    np.testing.assert_allclose(np.asarray(got.t)[ref_hit],
                               np.asarray(ref.t)[ref_hit], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.obj_id)[ref_hit],
                                  np.asarray(ref.obj_id)[ref_hit])
    # normals computed via the packed kernel differ from the per-type path
    # only in float op order
    np.testing.assert_allclose(np.asarray(got.normal)[ref_hit],
                               np.asarray(ref.normal)[ref_hit], atol=1e-4)


def test_grid_matches_brute(scene):
    grid = build_grid(scene)
    inter = make_grid_intersectors(scene, grid)
    _check_closest(inter, scene)


def test_grid_batched_matches_scalar(scene):
    """Batched DDA must agree with the reference-shaped vmapped machine,
    including the walks-out-of-grid and Init_Traverse-failure quirks."""
    grid = build_grid(scene)
    a = make_grid_scalar_intersectors(scene, grid)
    b = make_grid_intersectors(scene, grid)
    o, d = random_rays(512, seed=9)
    time = jnp.zeros(512)
    ha = a.closest(o, d, time)
    hb = b.closest(o, d, time)
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit))
    m = np.asarray(ha.hit)
    np.testing.assert_allclose(np.asarray(ha.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ha.obj_id), np.asarray(hb.obj_id))
    rng = np.random.default_rng(10)
    dist = jnp.asarray(rng.uniform(0.5, 10, 512), jnp.float32)
    excl = jnp.full((512,), -1, jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(a.shadow(o, d, dist, excl)),
        np.asarray(b.shadow(o, d, dist, excl)))


def test_bvh_matches_brute(scene):
    bvh = build_bvh(scene)
    inter = make_bvh_intersectors(scene, bvh)
    _check_closest(inter, scene)


def test_threaded_bvh_matches_brute(scene):
    inter = make_threaded_intersectors(scene, thread_bvh(build_bvh(scene)))
    _check_closest(inter, scene)


def test_threaded_bvh_shadow_matches_stack(scene):
    """Threaded any-hit must agree with the reference stack traversal."""
    bvh = build_bvh(scene)
    stack = make_bvh_intersectors(scene, bvh)
    threaded = make_threaded_intersectors(scene, thread_bvh(bvh))
    n = 256
    rng = np.random.default_rng(11)
    o = jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32)
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    d = jnp.asarray(dv, jnp.float32)
    dist = jnp.asarray(rng.uniform(1, 12, n), jnp.float32)
    excl = jnp.full((n,), -1, jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(stack.shadow(o, d, dist, excl)),
        np.asarray(threaded.shadow(o, d, dist, excl)))


def test_threaded_bvh_mesh(scenes_dir):
    """Threaded traversal on the blueDiamond mesh vs the stack traversal."""
    scene = load_p3f(os.path.join(scenes_dir, "blueDiamond.p3f"),
                     load_sky=False).device_put()
    bvh = build_bvh(scene)
    stack = make_bvh_intersectors(scene, bvh)
    threaded = make_threaded_intersectors(scene, thread_bvh(bvh))
    n = 512
    rng = np.random.default_rng(13)
    o = jnp.asarray(rng.uniform(-2, 8, (n, 3)), jnp.float32)
    target = rng.uniform(-1, 4, (n, 3))
    d = target - np.asarray(o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    time = jnp.zeros(n)
    a = stack.closest(o, d, time)
    b = threaded.closest(o, d, time)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    m = np.asarray(a.hit)
    np.testing.assert_allclose(np.asarray(a.t)[m], np.asarray(b.t)[m],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.obj_id)[m],
                                  np.asarray(b.obj_id)[m])


def test_shadow_agreement(scene):
    """Any-hit agreement on in-grid rays with a generous distance."""
    from distributionraytracer.ops.intersect import any_hit_brute
    n = 256
    rng = np.random.default_rng(3)
    # origins inside the grid bbox: rays that miss the grid entirely are
    # "occluded" by the reference's Init_Traverse-failure quirk
    # (grid.cpp:321-324), which brute force can't reproduce
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)), jnp.float32)
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    d = jnp.asarray(dv, jnp.float32)
    dist = jnp.full((n,), 6.0)
    excl = jnp.full((n,), -1, jnp.int32)
    time = jnp.zeros(n)
    brute = np.asarray(any_hit_brute(scene, o, d, time, dist, excl, False))

    grid = build_grid(scene)
    gi = make_grid_intersectors(scene, grid)
    got_g = np.asarray(gi.shadow(o, d, dist, excl))
    np.testing.assert_array_equal(got_g, brute)

    bvh = build_bvh(scene)
    bi = make_bvh_intersectors(scene, bvh)
    got_b = np.asarray(bi.shadow(o, d, dist, excl))
    # BVH any-hit uses t <= dist + EPSILON (bvh.cpp:376): a superset of the
    # strict < matches; only boundary rays may differ
    diff = got_b != brute
    assert diff.mean() < 0.02


def test_bvh_mesh_scene(scenes_dir):
    """BVH on the blueDiamond glass mesh (178 tris) vs brute force."""
    scene = load_p3f(os.path.join(scenes_dir, "blueDiamond.p3f"),
                     load_sky=False).device_put()
    bvh = build_bvh(scene)
    inter = make_bvh_intersectors(scene, bvh)
    n = 256
    rng = np.random.default_rng(7)
    # aim rays at the mesh bbox region
    o = jnp.asarray(rng.uniform(-2, 8, (n, 3)), jnp.float32)
    target = rng.uniform(-1, 4, (n, 3))
    d = target - np.asarray(o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    time = jnp.zeros(n)
    ref = closest_hit_brute(scene, o, d, time, motion_blur=False)
    got = inter.closest(o, d, time)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
