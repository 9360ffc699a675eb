"""Path tracer: GLSL-semantics units + Monte Carlo consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator import pathtracer as PT
from distributionraytracer.scene import pt_scenes as PS


def test_glsl_hash_deterministic():
    s1 = PS.GlslSeed(1.25)
    s2 = PS.GlslSeed(1.25)
    a = s1.hash3()
    b = s2.hash3()
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a <= 1)).all()
    # sequence advances
    c = s1.hash3()
    assert not np.array_equal(a, c)
    h = s1.hash1()
    assert 0.0 <= h <= 1.0


def test_scene0_layout():
    s = PS.scene0()
    # ground quad -> 2 tris; 5 fixed spheres + ~70-100 field spheres
    assert s.tri_v0.shape[0] == 2
    n_s = s.sph_center.shape[0]
    n_m = s.msph_c0.shape[0]
    assert 40 <= n_s + n_m <= 105
    assert n_m > 0  # some moving spheres exist
    # all field spheres sit at y=0.2 radius 0.2
    assert np.allclose(np.asarray(s.sph_radius)[5:], 0.2)


def test_hit_world_quad_and_sphere():
    b = PS._PT()
    m0 = b.diffuse([1, 0, 0])
    b.quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], m0)
    b.sphere([0, 2, 0], 0.5, b.metal([1, 1, 1], 0.0))
    s = b.build().device_put()
    o = jnp.array([[0, 5, 0], [0.9, 5, 0.9], [3, 5, 3]], jnp.float32)
    d = jnp.array([[0, -1, 0]] * 3, jnp.float32)
    h = PT.hit_world(s, o, d, jnp.zeros(3))
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 2.5) < 1e-5  # sphere first
    assert bool(h.hit[1]) and abs(float(h.t[1]) - 5.0) < 1e-5  # quad corner
    assert not bool(h.hit[2])
    assert int(h.mat[0]) == 1 and int(h.mat[1]) == 0


def test_moving_sphere_positions():
    b = PS._PT()
    b.moving_sphere([0, 0, 0], [0, 1, 0], 0.5, b.diffuse([1, 1, 1]))
    s = b.build().device_put()
    o = jnp.array([[0, 0, 5], [0, 1, 5]], jnp.float32)
    d = jnp.array([[0, 0, -1], [0, 0, -1]], jnp.float32)
    # at time 0 center at y=0; at time 1 center at y=1
    h0 = PT.hit_world(s, o, d, jnp.array([0.0, 0.0]))
    assert bool(h0.hit[0]) and not bool(h0.hit[1])
    h1 = PT.hit_world(s, o, d, jnp.array([1.0, 1.0]))
    assert not bool(h1.hit[0]) and bool(h1.hit[1])


def test_ggx_brdf_sane():
    n = jnp.array([[0.0, 1.0, 0.0]])
    v = jnp.array([[0.0, 1.0, 0.0]])
    l = jnp.array([[0.0, 1.0, 0.0]])
    f0 = jnp.array([[0.04, 0.04, 0.04]])
    val = PT.brdf_ggx(n, v, l, f0, jnp.array([0.5]))
    assert np.isfinite(np.asarray(val)).all()
    assert (np.asarray(val) >= 0).all()


def test_srgb_to_linear_matches_reference_points():
    x = jnp.array([0.0, 0.04, 0.5, 1.0])
    y = np.asarray(PT.srgb_to_linear(jnp.stack([x, x, x], -1)))
    assert abs(y[0, 0] - 0.0) < 1e-6
    assert abs(y[1, 0] - 0.04 / 12.92) < 1e-6
    assert abs(y[2, 0] - ((0.5 + 0.055) / 1.055) ** 2.4) < 1e-6
    assert abs(y[3, 0] - 1.0) < 1e-6


def test_scene3_render_statistics():
    """Cornell-like box: emissive ceiling light, red/green side walls."""
    scene = PS.scene3().device_put()
    cfg = RenderConfig(max_bounces=6)
    img = np.asarray(PT.render_pt(
        scene, cfg, 48, 48, key=jax.random.PRNGKey(0),
        eye=jnp.array([0.0, -3.0, -4.0]), at=jnp.array([0.0, -3.0, 10.0]),
        spp=8))
    assert np.isfinite(img).all()
    assert img.mean() > 0.02  # light reaches the camera
    # camera u-axis points -x, so image-left sees the +x (green) wall and
    # image-right the -x (red) wall
    left = img[:, :12]
    right = img[:, -12:]
    assert left[..., 1].mean() > left[..., 0].mean()
    assert right[..., 0].mean() > right[..., 1].mean()


def test_scene0_sky_and_ground():
    scene = PS.scene0().device_put()
    cfg = RenderConfig(max_bounces=4)
    img = np.asarray(PT.render_pt(
        scene, cfg, 32, 32, key=jax.random.PRNGKey(1),
        eye=jnp.array([0.0, 1.5, -8.0]), at=jnp.array([0.0, 1.0, 0.0]),
        spp=4))
    assert np.isfinite(img).all()
    top = img[-8:]  # y-up rows at the top of the image
    assert top[..., 2].mean() > 0.5  # sky is blue-ish/bright
    assert img.std() > 0.05


def test_mc_consistency_two_seeds():
    """Independent seeds converge to the same expectation."""
    scene = PS.scene3().device_put()
    cfg = RenderConfig(max_bounces=5)
    kwargs = dict(eye=jnp.array([0.0, -3.0, -4.0]),
                  at=jnp.array([0.0, -3.0, 10.0]), spp=32)
    a = np.asarray(PT.render_pt(scene, cfg, 16, 16,
                                key=jax.random.PRNGKey(3), **kwargs))
    b = np.asarray(PT.render_pt(scene, cfg, 16, 16,
                                key=jax.random.PRNGKey(4), **kwargs))
    # relative agreement of mean images
    denom = max(a.mean(), 1e-3)
    assert abs(a.mean() - b.mean()) / denom < 0.15
