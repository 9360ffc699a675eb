"""Route selection, matmul precision in the render step, and where the
compile cache goes."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from distributionraytracer import compile_cache_dir
from distributionraytracer.config import RenderConfig
from distributionraytracer.routing import select_route
from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE,
)
from tests.test_whitted import small_scene


def _with_accel(accel):
    scene = small_scene()
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=accel))


@pytest.mark.parametrize("accel,backend,platform,route", [
    (ACCEL_NONE, "auto", "gpu", "brute-xla"),
    (ACCEL_NONE, "auto", "cpu", "brute-xla"),
    (ACCEL_GRID, "auto", "gpu", "grid-xla"),
    (ACCEL_GRID, "auto", "cpu", "grid-xla"),
    (ACCEL_BVH, "auto", "gpu", "bvh-triton"),
    (ACCEL_BVH, "xla", "gpu", "bvh-xla"),
    (ACCEL_BVH, "auto", "cpu", "bvh-xla"),
    (ACCEL_BVH, "xla", "cpu", "bvh-xla"),
])
def test_select_route(accel, backend, platform, route):
    cfg = RenderConfig(accel_backend=backend)
    scene = _with_accel(accel)
    assert select_route(scene, cfg, platform) == route
    assert select_route(scene.static, cfg, platform) == route


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no route for platform"):
        select_route(_with_accel(ACCEL_NONE), RenderConfig(), platform)


@pytest.mark.parametrize("backend", ["pallas", "triton", "on"])
def test_bad_accel_backend_rejected(backend):
    with pytest.raises(ValueError, match="bad accel_backend"):
        RenderConfig(accel_backend=backend)


def _dot_generals(jaxpr):
    """Every dot_general equation of a closed jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_generals(sub)
    return out


def _render_step_jaxprs(scenes_dir):
    from distributionraytracer.integrator.pathtracer import render_pt
    from distributionraytracer.integrator.render import (
        make_samples, render_from_samples,
    )
    from distributionraytracer.parallel.mesh import accel_intersectors
    from distributionraytracer.renderer import build_accel
    from distributionraytracer.scene import load_p3f
    from distributionraytracer.scene.pt_scenes import scene3

    for name in ("balls_low", "balls_box", "teste"):
        scene = load_p3f(os.path.join(scenes_dir, f"{name}.p3f"))
        accel = ACCEL_BVH if name == "teste" else scene.static.accel
        scene = dataclasses.replace(scene, static=dataclasses.replace(
            scene.static, res_x=8, res_y=8, accel=accel)).device_put()
        cfg = RenderConfig(spp=1)
        ab = build_accel(scene)

        def step(scene, key, tables):
            samples = make_samples(scene, cfg, key)
            inter = accel_intersectors(scene, cfg, tables, ab.grid_unroll)
            return render_from_samples(scene, cfg, samples, inter=inter)

        yield name, jax.make_jaxpr(step)(scene, jax.random.PRNGKey(0),
                                         ab.tables).jaxpr
    pt = scene3().device_put()
    yield "pt_scene3", jax.make_jaxpr(
        lambda s, k: render_pt(s, RenderConfig(max_bounces=2), 8, 8, key=k,
                               spp=1))(pt, jax.random.PRNGKey(0)).jaxpr


def test_render_step_has_no_reduced_precision_matmul(scenes_dir):
    """Every dot_general reachable from the render steps asks for HIGHEST
    precision: a float32 matmul left at the default may run in TF32 on a
    GPU (about three decimal digits), which moves hit points."""
    seen = 0
    for name, jaxpr in _render_step_jaxprs(scenes_dir):
        for eqn in _dot_generals(jaxpr):
            seen += 1
            prec = eqn.params["precision"]
            assert prec is not None, (name, eqn)
            assert all(p == jax.lax.Precision.HIGHEST for p in prec), (
                name, prec)
    assert seen >= 1  # the material one-hot fetch is a matmul


def test_compile_cache_dir_choice():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/c"}) is None
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache_dir({}) == os.path.join(repo, ".jax_cache")
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_routes_match_renderer_on_this_platform(scenes_dir):
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.routing import current_platform
    assert current_platform() == "cpu"
    scene = _with_accel(ACCEL_BVH)
    r = Renderer(scene, RenderConfig(spp=1))
    assert r.route == select_route(scene, r.cfg, "cpu") == "bvh-xla"
    img = np.asarray(r.render(jax.random.PRNGKey(0)))
    assert img.shape == (scene.static.res_y, scene.static.res_x, 3)
