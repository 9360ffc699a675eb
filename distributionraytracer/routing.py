"""The one place that decides which implementation renders a scene.

A route is a name for the intersection path one render takes:

- ``brute-xla``: accel NONE — the jnp linear scans of ``ops.intersect``;
- ``grid-xla``: accel GRID — the batched DDA of ``accel.grid``;
- ``bvh-xla``: accel BVH — the batched stackless walk of ``accel.bvh``;
- ``bvh-triton``: accel BVH — the per-ray Pallas/Triton walk of
  ``accel.bvh_kernel`` over the same threaded tables.

``Renderer`` and ``parallel.mesh.accel_intersectors`` read
:func:`select_route`; nothing else probes the backend.  A render on the
CPU never takes a Pallas kernel: interpret mode is an argument only tests
pass to the kernel directly.
"""

from __future__ import annotations

import jax

from distributionraytracer.config import RenderConfig
from distributionraytracer.scene.types import ACCEL_BVH, ACCEL_GRID

PLATFORMS = ("cpu", "gpu")


def current_platform() -> str:
    """The platform of JAX's default device (``"cpu"`` or ``"gpu"``)."""
    return jax.default_backend()


def select_route(scene, cfg: RenderConfig, platform: str) -> str:
    """Route for ``scene`` (SceneData or SceneStatic) under ``cfg`` on
    ``platform``.  Raises ValueError for a platform this renderer was not
    built for."""
    if platform not in PLATFORMS:
        raise ValueError(
            f"no route for platform {platform!r}: this renderer runs on "
            f"{' or '.join(PLATFORMS)}")
    st = getattr(scene, "static", scene)
    if st.accel == ACCEL_GRID:
        return "grid-xla"
    if st.accel != ACCEL_BVH:
        return "brute-xla"
    if cfg.accel_backend == "xla" or platform == "cpu":
        return "bvh-xla"
    return "bvh-triton"
