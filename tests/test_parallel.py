"""Multi-device sharding on the virtual 8-CPU mesh."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributionraytracer.config import RenderConfig
from distributionraytracer.integrator.render import (
    make_samples, render_image,
)
from distributionraytracer.parallel.mesh import (
    make_device_mesh, make_sharded_train_step, render_image_sharded,
)
from tests.test_whitted import small_scene


def test_eight_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single():
    scene = small_scene().device_put()
    cfg = RenderConfig(spp=2)
    key = jax.random.PRNGKey(5)
    samples = make_samples(scene, cfg, key)
    ref = np.asarray(render_image(scene, cfg, samples=samples))
    mesh = make_device_mesh()
    img = np.asarray(render_image_sharded(scene, cfg, mesh, samples=samples))
    assert img.shape == ref.shape
    np.testing.assert_allclose(img, ref, atol=1e-5)


def _compiles(caplog):
    return [r for r in caplog.records if "Compiling" in r.getMessage()]


def test_sharded_render_reuses_its_compiled_program(caplog):
    """A second frame with the same config and mesh reuses the jitted
    shard_map program: no retrace, no recompile."""
    scene = small_scene().device_put()
    cfg = RenderConfig(spp=1)
    mesh = make_device_mesh()
    render_image_sharded(scene, cfg, mesh, key=jax.random.PRNGKey(0))
    with caplog.at_level(logging.WARNING), jax.log_compiles(True):
        render_image_sharded(scene, cfg, mesh, key=jax.random.PRNGKey(1))
    assert not _compiles(caplog)


@pytest.mark.parametrize("accel_kind", ["grid", "bvh"])
def test_sharded_accel_render_matches_single(scenes_dir, accel_kind):
    """Sharded rendering must use the accel structure, not brute force —
    and match the single-device Renderer bit-for-bit (same XLA traversal,
    same samples)."""
    import dataclasses
    import os

    from distributionraytracer.renderer import Renderer, build_accel
    from distributionraytracer.scene import load_p3f
    from distributionraytracer.scene.types import ACCEL_BVH, ACCEL_GRID

    name = "balls_box" if accel_kind == "grid" else "balls_low"
    want = ACCEL_GRID if accel_kind == "grid" else ACCEL_BVH
    scene = load_p3f(os.path.join(scenes_dir, f"{name}.p3f"))
    st = dataclasses.replace(scene.static, res_x=32, res_y=32, spp=0,
                             accel=want)
    scene = dataclasses.replace(scene, static=st).device_put()
    cfg = RenderConfig(spp=2)
    samples = make_samples(scene, cfg, jax.random.PRNGKey(3))

    ref = np.asarray(Renderer(scene, cfg).render_with_samples(samples))
    ab = build_accel(scene)
    mesh = make_device_mesh()
    img = np.asarray(render_image_sharded(
        scene, cfg, mesh, samples=samples, accel=ab.tables,
        grid_unroll=ab.grid_unroll))
    assert img.shape == ref.shape
    np.testing.assert_allclose(img, ref, atol=1e-5)
    assert img.std() > 0.01


def test_sharded_accel_train_step(scenes_dir):
    """Inverse rendering through the sharded BVH path: loss decreases."""
    import dataclasses

    from distributionraytracer.renderer import build_accel
    from distributionraytracer.scene.types import ACCEL_BVH

    scene = small_scene()
    scene = dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, accel=ACCEL_BVH)
    ).device_put()
    cfg = RenderConfig(spp=1)
    samples = make_samples(scene, cfg, jax.random.PRNGKey(7))
    ab = build_accel(scene)
    mesh = make_device_mesh()

    target_scene = dataclasses.replace(scene, mat_cd=scene.mat_cd * 0.6)
    target = render_image_sharded(target_scene, cfg, mesh, samples=samples,
                                  accel=ab.tables)

    from distributionraytracer.parallel.mesh import _pad_rows
    samples_p, H0 = _pad_rows(samples, 8)
    pad = samples_p.time.shape[0] - H0
    target_p = jnp.concatenate(
        [target, jnp.zeros((pad,) + target.shape[1:])], axis=0)
    rows_per = samples_p.time.shape[0] // 8
    step = make_sharded_train_step(cfg, mesh, rows_per, lr=4.0,
                                   update_leaves=("mat_cd",),
                                   accel=ab.tables)
    losses = []
    s = scene
    for _ in range(4):
        loss, s = step(s, samples_p, target_p)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.95, losses


def test_sharded_train_step_reduces_loss(caplog):
    scene = small_scene().device_put()
    cfg = RenderConfig(spp=1)
    key = jax.random.PRNGKey(9)
    samples = make_samples(scene, cfg, key)
    # target: render with perturbed diffuse color, then recover by SGD
    import dataclasses
    target_scene = dataclasses.replace(
        scene, mat_cd=scene.mat_cd * 0.5)
    target = render_image(target_scene, cfg, samples=samples)

    mesh = make_device_mesh()
    H = samples.time.shape[0]
    assert H % 8 == 0 or True
    # pad rows to the mesh
    from distributionraytracer.parallel.mesh import _pad_rows
    samples_p, H0 = _pad_rows(samples, 8)
    pad = samples_p.time.shape[0] - H0
    target_p = jnp.concatenate(
        [target, jnp.zeros((pad,) + target.shape[1:])], axis=0)
    rows_per = samples_p.time.shape[0] // 8

    step = make_sharded_train_step(cfg, mesh, rows_per, lr=0.5,
                                   update_leaves=("mat_cd",))
    loss, s = step(scene, samples_p, target_p)
    losses = [float(loss)]
    # the updated scene comes back replicated over the mesh; later steps
    # must reuse the first step's program
    with caplog.at_level(logging.WARNING), jax.log_compiles(True):
        for _ in range(7):
            loss, s = step(s, samples_p, target_p)
            losses.append(float(loss))
    assert not _compiles(caplog)
    assert losses[-1] < losses[0] * 0.5, losses
