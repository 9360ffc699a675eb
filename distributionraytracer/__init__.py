"""Differentiable distribution ray tracer in JAX.

A JAX/XLA framework with the capabilities of the reference C++/GLSL project
``rita-mota/DistributionRayTracer``:

- P3F scene loading (``scene.p3f``), skybox cubemaps (``scene.skybox``),
  and seeded generators for the reference deployments (``scene.generate``)
- Camera ray generation with jittered AA and thin-lens DOF (``ops.camera``)
- Sphere / triangle / plane / axis-aligned-box intersection (``ops.intersect``)
- Uniform-grid and flattened SAH-BVH acceleration (``accel``), with a
  per-ray Pallas/Triton BVH walk on the GPU (``accel.bvh_kernel``)
- Whitted + distribution integrator with soft shadows, reflection, refraction
  with Beer absorption, motion blur (``integrator.whitted``)
- Monte Carlo path tracer with diffuse/metal/dielectric/plastic materials,
  GGX direct lighting and Russian roulette (``integrator.pathtracer``)
- Multi-device pixel-tile sharding over a ``jax.sharding.Mesh`` (``parallel``)

Unlike the reference, the scene lives device-resident in SoA layout, every
kernel is batched/masked (no recursion, no virtual dispatch), and rendering
is differentiable end-to-end w.r.t. materials, lights and camera.
"""

__version__ = "0.1.0"

import os as _os


_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ):
    """Where this package puts JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself and no
    other directory is set in code), else the fixed ``<checkout>/.jax_cache``
    — a fixed path, since the path is part of the cache key."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_CHECKOUT, ".jax_cache")


def _enable_compile_cache():
    """Persistent XLA compilation cache: every compile after the first
    process is warm (the reference renders seconds after launch,
    main.cpp:1074-1078; a cold 100k-triangle render compiles for much
    longer)."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_compile_cache()

from distributionraytracer.config import RenderConfig  # noqa: F401,E402
