"""Batched primary-ray generation (pinhole and thin-lens DOF).

Reference: ``Camera::PrimaryRay`` (camera.h:74-101).  Vectorized over a batch
of pixel samples; the camera frame comes from :func:`scene.types.derive_camera`
so eye/at/up stay differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from distributionraytracer.ops.common import normalize
from distributionraytracer.scene.types import CameraParams


def primary_rays(cam: CameraParams, pixel_sample, time=None):
    """Pinhole rays (camera.h:74-83).

    ``pixel_sample``: (..., 2) viewport coordinates in [0,res)x[0,res).
    Returns (origin (...,3), direction (...,3) normalized, time (...,)).
    """
    px = pixel_sample[..., 0] / cam.res_x - 0.5
    py = pixel_sample[..., 1] / cam.res_y - 0.5
    d = (cam.u * (cam.w * px)[..., None]
         + cam.v * (cam.h * py)[..., None]
         - cam.n * cam.plane_dist)
    d = normalize(d)
    o = jnp.broadcast_to(cam.eye, d.shape)
    if time is None:
        time = np.zeros(d.shape[:-1], np.float32)
    return o, d, time


def thin_lens_rays(cam: CameraParams, lens_sample, pixel_sample, time=None):
    """Thin-lens DOF rays (camera.h:86-101).

    ``lens_sample``: (..., 2) point on the lens in camera (u,v) coords,
    already scaled by aperture/2 by the caller (main.cpp:657-660).
    """
    lsx = lens_sample[..., 0]
    lsy = lens_sample[..., 1]
    eye_offset = cam.eye + cam.u * lsx[..., None] + cam.v * lsy[..., None]
    px = (pixel_sample[..., 0] / cam.res_x - 0.5) * cam.w * cam.focal_ratio
    py = (pixel_sample[..., 1] / cam.res_y - 0.5) * cam.h * cam.focal_ratio
    f = cam.plane_dist * cam.focal_ratio
    d = (cam.u * (px - lsx)[..., None]
         + cam.v * (py - lsy)[..., None]
         - cam.n * f)
    d = normalize(d)
    if time is None:
        time = np.zeros(d.shape[:-1], np.float32)
    return eye_offset, d, time
