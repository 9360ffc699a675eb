"""Whitted integrator vs the scalar NumPy oracle (shared sample streams)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator.render import (
    SampleSet, default_config, render_image,
)
from distributionraytracer.oracle import oracle_render
from distributionraytracer.scene import load_p3f
from distributionraytracer.scene.builder import SceneBuilder


def assert_images_close(img, ref, atol=3e-3, outlier_frac=0.005,
                        max_outlier=0.05):
    """allclose with a tiny outlier budget: borderline intersections can
    flip between the f32 renderer and the f64-camera oracle."""
    diff = np.abs(np.asarray(img) - np.asarray(ref))
    bad = diff > atol
    assert bad.mean() <= outlier_frac, (
        f"{bad.mean():.4%} of elements beyond atol={atol} "
        f"(max diff {diff.max():.4f})")
    assert diff.max() <= max_outlier, f"max diff {diff.max():.4f}"


def small_scene(with_quad_light=False, glass=False):
    b = SceneBuilder()
    b.set_camera([0, 1, 5], [0, 0, 0], [0, 1, 0], 45, 0.01, 24, 18, 0, 1)
    floor = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.0,
                           10, 0, 1)
    b.add_plane_hessian([0, 1, 0], 1.0, floor)  # y = -1
    red = b.add_material([0.9, 0.1, 0.1], 0.9, [1, 1, 1], 0.3, 50, 0, 1)
    b.add_sphere([-0.8, 0, 0], 0.8, red)
    if glass:
        g = b.add_material([0.2, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
        b.add_sphere([1.0, 0, 0.5], 0.7, g)
    else:
        metal = b.add_material([0, 0, 0], 0.0, [0.9, 0.8, 0.7], 0.9, 200, 0, 1)
        b.add_sphere([1.0, 0, 0.5], 0.7, metal)
    if with_quad_light:
        b.add_quad_light([2, 4, 2], [1, 1, 1], [3, 4, 2], [2, 4, 3], 16)
    else:
        b.add_point_light([2, 4, 2], [1, 1, 1])
    b.add_point_light([-3, 3, 3], [1, 1, 1])
    b.bg_color = np.array([0.1, 0.2, 0.4], np.float32)
    return b.build()


def fixed_samples(scene, spp, seed=0):
    st = scene.static
    H, W, S = st.res_y, st.res_x, max(spp, 1)
    rng = np.random.default_rng(seed)
    return SampleSet(
        pixel=jnp.asarray(rng.random((H, W, S, 2)), jnp.float32)
        if spp else jnp.full((H, W, 1, 2), 0.5, jnp.float32),
        light=jnp.asarray(rng.random((H, W, S, 2)), jnp.float32),
        lens=jnp.asarray(rng.random((H, W, S, 2)) * 2 - 1, jnp.float32),
        time=jnp.zeros((H, W, S), jnp.float32),
    )


@pytest.mark.parametrize("glass", [False, True])
def test_whitted_matches_oracle_pointlights(glass):
    scene = small_scene(glass=glass)
    samples = fixed_samples(scene, spp=1)
    cfg = RenderConfig(spp=1)
    img = np.asarray(render_image(scene.device_put(), cfg, samples=samples))
    ref = oracle_render(scene, samples)
    np.testing.assert_allclose(img, ref, atol=2e-3)
    assert img.std() > 0.01  # non-degenerate image


def test_whitted_matches_oracle_quadlight():
    scene = small_scene(with_quad_light=True)
    samples = fixed_samples(scene, spp=4)
    cfg = RenderConfig(spp=4)
    img = np.asarray(render_image(scene.device_put(), cfg, samples=samples))
    ref = oracle_render(scene, samples)
    np.testing.assert_allclose(img, ref, atol=2e-3)


def test_oracle_crop_origin_matches_full_frame():
    """oracle_render(origin=...) renders a crop of the frame exactly as the
    full-frame render has it (the check chip_smoke runs on the card)."""
    scene = small_scene()
    samples = fixed_samples(scene, spp=1, seed=4)
    full = oracle_render(scene, samples)
    y0, x0, n = 5, 9, 6
    crop = SampleSet(*(np.asarray(a)[y0:y0 + n, x0:x0 + n] for a in (
        samples.pixel, samples.light, samples.lens, samples.time)))
    part = oracle_render(scene, crop, origin=(x0, y0))
    np.testing.assert_array_equal(part, full[y0:y0 + n, x0:x0 + n])


def test_whitted_p3f_balls_low_crop(scenes_dir):
    """Real P3F scene at reduced res, deterministic center samples."""
    scene = load_p3f(os.path.join(scenes_dir, "balls_low.p3f"))
    # shrink resolution for test speed: rebuild static
    import dataclasses
    st = dataclasses.replace(scene.static, res_x=32, res_y=32, spp=0)
    scene = dataclasses.replace(scene, static=st)
    samples = fixed_samples(scene, spp=0)
    cfg = RenderConfig(spp=0)
    img = np.asarray(render_image(scene.device_put(), cfg, samples=samples))
    ref = oracle_render(scene, samples)
    assert_images_close(img, ref)
    assert img.std() > 0.05


@pytest.mark.parametrize("name", ["balls_low", "teste"])
def test_static_tree_pruning_identical(scenes_dir, name):
    """Pruning statically-dead ray-tree subtrees must not change the image.

    balls_low has no T==1 material (refraction subtree dead); teste has both
    glass and metal (nothing prunable -> exercises the no-op path)."""
    import dataclasses
    scene = load_p3f(os.path.join(scenes_dir, f"{name}.p3f"))
    st = dataclasses.replace(scene.static, res_x=24, res_y=24)
    scene = dataclasses.replace(scene, static=st).device_put()
    samples = fixed_samples(scene, spp=2)
    cfg = RenderConfig(spp=2)
    pruned = np.asarray(render_image(scene, cfg, samples=samples))
    full = np.asarray(render_image(
        scene, cfg.replace(static_prune=False), samples=samples))
    np.testing.assert_allclose(pruned, full, atol=1e-6)


def test_dof_matches_oracle(scenes_dir):
    scene = load_p3f(os.path.join(scenes_dir, "dof.p3f"))
    import dataclasses
    st = dataclasses.replace(scene.static, res_x=24, res_y=18)
    scene = dataclasses.replace(scene, static=st)
    spp = 4
    samples = fixed_samples(scene, spp=spp)
    cfg = RenderConfig(spp=spp, dof=True)
    img = np.asarray(render_image(scene.device_put(), cfg, samples=samples))
    ref = oracle_render(scene, samples, dof=True)
    assert_images_close(img, ref)


def test_motion_blur_matches_oracle(scenes_dir):
    scene = load_p3f(os.path.join(scenes_dir, "motion.p3f"))
    import dataclasses
    st = dataclasses.replace(scene.static, res_x=24, res_y=24)
    scene = dataclasses.replace(scene, static=st)
    spp = 4
    rng = np.random.default_rng(3)
    H, W, S = 24, 24, spp
    samples = SampleSet(
        pixel=jnp.asarray(rng.random((H, W, S, 2)), jnp.float32),
        light=jnp.asarray(rng.random((H, W, S, 2)), jnp.float32),
        lens=jnp.asarray(rng.random((H, W, S, 2)) * 2 - 1, jnp.float32),
        time=jnp.asarray(rng.random((H, W, S)), jnp.float32))
    cfg = RenderConfig(spp=spp, motion_blur=True)
    img = np.asarray(render_image(scene.device_put(), cfg, samples=samples))
    ref = oracle_render(scene, samples, motion_blur=True)
    assert_images_close(img, ref)


def test_live_partition_properties():
    """_live_partition: stable permutation, live-first, exact inverse."""
    import numpy as np
    from distributionraytracer.integrator.whitted import _live_partition

    rng = np.random.default_rng(0)
    for n in (1, 7, 128, 1000):
        valid = rng.random(n) < 0.3
        import jax.numpy as jnp
        perm, pos = _live_partition(jnp.asarray(valid))
        perm = np.asarray(perm)
        pos = np.asarray(pos)
        assert sorted(perm.tolist()) == list(range(n))
        x = np.arange(n)
        assert (x[perm][pos] == x).all()  # sorted[pos[i]] == x[i]
        nlive = valid.sum()
        assert valid[perm[:nlive]].all()
        assert not valid[perm[nlive:]].any()
        # stability: live lanes keep relative order
        assert (np.diff(perm[:nlive]) > 0).all()
        assert (np.diff(perm[nlive:]) > 0).all()


def test_compact_lanes_output_equivalent(scenes_dir):
    """compact_lanes=True must be output-identical on a refl+refr scene
    under an accel traversal (ADVICE r3: the opt-in path had no coverage)."""
    import dataclasses
    import os

    import jax
    import numpy as np
    from distributionraytracer.integrator.render import (
        SampleSet, default_config, make_samples,
    )
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene import load_p3f
    from distributionraytracer.scene.types import ACCEL_BVH

    scene = load_p3f(os.path.join(scenes_dir, "teste.p3f"))
    scene = dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, accel=ACCEL_BVH,
                                          res_x=24, res_y=18, spp=1))
    imgs = {}
    for compact in (False, True):
        cfg = default_config(scene).replace(
            compact_lanes=compact, accel_backend="xla")
        r = Renderer(scene, cfg)
        imgs[compact] = np.asarray(r.render(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(imgs[False], imgs[True])
