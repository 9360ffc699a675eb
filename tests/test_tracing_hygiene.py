"""Guard against eager device-array constants in traced code.

A jnp array created eagerly inside a traced function becomes a
device-committed constant whose value must be fetched back from the device
at lowering time and is baked into the executable.  This test lowers the
main entry points and asserts that almost no device-Array constants get
embedded (NumPy constants use the fast handler).
"""

import contextlib

import jax
import numpy as np
import pytest


@contextlib.contextmanager
def count_array_constants():
    """Counts MLIR constants lowered from committed jax Arrays."""
    from jax._src import array as jarray
    from jax._src.interpreters import mlir

    counter = {"n": 0}
    orig = mlir._constant_handlers.get(jarray.ArrayImpl)

    def wrapper(x, *a, **k):
        counter["n"] += 1
        return orig(x, *a, **k)

    mlir.register_constant_handler(jarray.ArrayImpl, wrapper)
    try:
        yield counter
    finally:
        mlir.register_constant_handler(jarray.ArrayImpl, orig)


def test_whitted_render_has_no_device_constants():
    import dataclasses
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.render import (
        make_samples, render_from_samples,
    )
    from tests.test_whitted import small_scene

    scene = small_scene(glass=True).device_put()
    cfg = RenderConfig(spp=2, tile_rays=512)

    def fn(scene, key):
        samples = make_samples(scene, cfg, key)
        return render_from_samples(scene, cfg, samples)

    with count_array_constants() as c:
        jax.jit(fn).lower(scene, jax.random.PRNGKey(0))
    assert c["n"] <= 2, f"{c['n']} device-array constants embedded"


def test_pathtracer_render_has_no_device_constants():
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.pathtracer import render_pt
    from distributionraytracer.scene.pt_scenes import scene3

    scene = scene3().device_put()
    cfg = RenderConfig(max_bounces=3)
    with count_array_constants() as c:
        render_pt.lower(scene, cfg, 8, 8, key=jax.random.PRNGKey(0),
                        eye=np.array([0, -3, -4], np.float32),
                        at=np.array([0, -3, 10], np.float32), spp=1)
    assert c["n"] <= 2, f"{c['n']} device-array constants embedded"
