"""Intersection kernels vs analytic expectations and the scalar oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.ops import intersect as I
from distributionraytracer.scene.builder import SceneBuilder


def _mk(o, d):
    return (jnp.asarray(o, jnp.float32).reshape(-1, 3),
            jnp.asarray(d, jnp.float32).reshape(-1, 3))


def test_sphere_basic():
    o, d = _mk([[0, 0, 5]], [[0, 0, -1]])
    t = I.sphere_t(o, d, jnp.zeros(1), jnp.array([[0.0, 0.0, 0.0]]),
                   jnp.array([1.0]), motion_blur=False)
    np.testing.assert_allclose(np.asarray(t), [[4.0]], rtol=1e-6)


def test_sphere_inside_picks_far_root():
    o, d = _mk([[0, 0, 0]], [[0, 0, -1]])
    t = I.sphere_t(o, d, jnp.zeros(1), jnp.array([[0.0, 0.0, 0.0]]),
                   jnp.array([1.0]), motion_blur=False)
    np.testing.assert_allclose(np.asarray(t), [[1.0]], rtol=1e-6)


def test_sphere_motion_blur():
    # center moves by (0,1,0)*time (scene.cpp:158-162)
    o, d = _mk([[0, 1, 5]], [[0, 0, -1]])
    t = I.sphere_t(o, d, jnp.ones(1), jnp.array([[0.0, 0.0, 0.0]]),
                   jnp.array([1.0]), motion_blur=True)
    np.testing.assert_allclose(np.asarray(t), [[4.0]], rtol=1e-6)


def test_triangle_hit_and_miss():
    v0 = jnp.array([[-1.0, -1.0, 0.0]])
    e1 = jnp.array([[2.0, 0.0, 0.0]])  # v1 = (1,-1,0)
    e2 = jnp.array([[0.0, 2.0, 0.0]])  # v2 = (-1,1,0)
    o, d = _mk([[-0.5, -0.5, 3], [0.9, 0.9, 3]], [[0, 0, -1], [0, 0, -1]])
    t = I.triangle_t(o, d, v0, e1, e2)
    assert abs(float(t[0, 0]) - 3.0) < 1e-5
    assert float(t[1, 0]) > 1e30  # outside (u+v > 1)


def test_plane():
    pn = jnp.array([[0.0, 1.0, 0.0]])
    pd = jnp.array([2.0])  # y = -2 plane
    o, d = _mk([[0, 1, 0]], [[0, -1, 0]])
    t = I.plane_t(o, d, pn, pd)
    np.testing.assert_allclose(np.asarray(t), [[3.0]], rtol=1e-6)
    # parallel ray misses
    o2, d2 = _mk([[0, 1, 0]], [[1, 0, 0]])
    t2 = I.plane_t(o2, d2, pn, pd)
    assert float(t2[0, 0]) > 1e30


def test_box_hit_normal_and_inside_miss():
    bmin = jnp.array([[-1.0, -1.0, -1.0]])
    bmax = jnp.array([[1.0, 1.0, 1.0]])
    o, d = _mk([[0, 0, 5]], [[0, 0, -1]])
    t = I.box_t(o, d, bmin, bmax)
    np.testing.assert_allclose(np.asarray(t), [[4.0]], rtol=1e-6)
    n = I.box_normal(o[0], d[0], t[0, 0], bmin[0], bmax[0])
    np.testing.assert_allclose(np.asarray(n), [0, 0, 1], atol=1e-6)
    # ray starting inside reports no hit (scene.cpp:258: tmin > EPSILON)
    o2, d2 = _mk([[0, 0, 0]], [[0, 0, -1]])
    t2 = I.box_t(o2, d2, bmin, bmax)
    assert float(t2[0, 0]) > 1e30


def test_closest_hit_brute_mixed_scene():
    b = SceneBuilder()
    b.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 45, 0.01, 8, 8, 0, 1)
    m0 = b.add_material([1, 0, 0], 1, [0, 0, 0], 0, 10, 0, 1)
    b.add_sphere([0, 0, 0], 1.0, m0)
    b.add_plane_hessian([0, 1, 0], 2.0, m0)  # y = -2
    b.add_box([-3, -1, -1], [-2, 1, 1], m0)
    scene = b.build()

    o = jnp.array([[0, 0, 5], [0, -1.5, 5], [-2.5, 0, 5]], jnp.float32)
    d = jnp.array([[0, 0, -1], [0, 0, -1], [0, 0, -1]], jnp.float32)
    time = jnp.zeros(3)
    hit = I.closest_hit_brute(scene, o, d, time, motion_blur=False)
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 4.0) < 1e-5
    assert not bool(hit.hit[1])  # passes over the plane (parallel), no hit
    assert bool(hit.hit[2]) and abs(float(hit.t[2]) - 4.0) < 1e-5
    assert int(hit.obj_id[0]) == 0 and int(hit.obj_id[2]) == 2


def test_packed_matches_per_type():
    b = SceneBuilder()
    b.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 45, 0.01, 8, 8, 0, 1)
    m0 = b.add_material([1, 0, 0], 1, [0, 0, 0], 0, 10, 0, 1)
    b.add_sphere([0.3, -0.2, 0], 0.7, m0)
    b.add_triangle([-1, -1, 1], [1, -1, 1], [0, 1, 1], m0)
    b.add_box([-2, -2, -2], [-1, 2, 2], m0)
    b.add_plane_hessian([0, 1, 0], 3.0, m0)
    scene = b.build()
    data, types, mats = scene.device_put().packed_objects()

    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.normal(0, 2, (16, 3)), jnp.float32)
    dirs = rng.normal(0, 1, (16, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = jnp.asarray(dirs, jnp.float32)
    time = jnp.zeros(16)

    hit = I.closest_hit_brute(scene, o, d, time, motion_blur=False)
    # packed: evaluate every object for every ray, take min
    best_t = jnp.full((16,), I.FLT_MAX)
    for k in range(data.shape[0]):
        t, _ = I.hit_packed(o, d, time,
                            jnp.broadcast_to(data[k], (16, 12)),
                            jnp.full((16,), types[k]), motion_blur=False)
        best_t = jnp.minimum(best_t, t)
    np.testing.assert_allclose(np.asarray(best_t), np.asarray(hit.t),
                               rtol=1e-5)
