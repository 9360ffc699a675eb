"""Skybox cubemap lookup, vectorized.

Reproduces ``Scene::GetSkyboxColor`` (scene.cpp:380-458) exactly, including
its quirks:

- dominant-axis selection order: X beats Y, Z beats both only when strictly
  greater (scene.cpp:393-405);
- X >= 0 maps to LEFT and X < 0 to RIGHT (swapped vs OpenGL convention,
  scene.cpp:395);
- nearest-texel fetch at ``xp = int((width-1) * s)`` (scene.cpp:448-451).

Also provides the standard OpenGL cubemap convention used by the GLSL path
tracer's ``texture(iChannel1, dir)`` (P3D_RT.glsl:666-670).
"""

from __future__ import annotations

import jax.numpy as jnp

# CubeMap enum order (scene.h:19)
RIGHT, LEFT, TOP, BOTTOM, FRONT, BACK = 0, 1, 2, 3, 4, 5


def skybox_color(sky_faces, sky_res, direction):
    """Reference-convention lookup for rays (..., 3) -> colors (..., 3)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    xy_face = jnp.where(ax > ay,
                        jnp.where(x >= 0, LEFT, RIGHT),
                        jnp.where(y >= 0, TOP, BOTTOM))
    xy_ma = jnp.where(ax > ay, ax, ay)
    face = jnp.where(az > xy_ma, jnp.where(z >= 0, FRONT, BACK), xy_face)
    ma = jnp.where(az > xy_ma, az, xy_ma)

    # per-face (sc, tc) mapping (scene.cpp:407-438)
    sc = jnp.select(
        [face == RIGHT, face == LEFT, face == TOP, face == BOTTOM,
         face == FRONT],
        [-z, z, -x, -x, -x], x)
    tc = jnp.select(
        [face == RIGHT, face == LEFT, face == TOP, face == BOTTOM,
         face == FRONT],
        [y, y, -z, z, y], y)

    inv_ma = 1.0 / ma
    s = (sc * inv_ma + 1.0) / 2.0
    t = (tc * inv_ma + 1.0) / 2.0

    width, height = _face_res(sky_res, face)
    xp = ((width - 1).astype(jnp.float32) * s).astype(jnp.int32)
    yp = ((height - 1).astype(jnp.float32) * t).astype(jnp.int32)
    xp = jnp.clip(xp, 0, width - 1)
    yp = jnp.clip(yp, 0, height - 1)
    return _fetch(sky_faces, face, yp, xp)


def _face_res(sky_res, face):
    """Per-lane (width, height) via a 6-way select instead of a gather —
    XLA lowers even a 12-element table gather to per-index DMA."""
    width = sky_res[5, 0]
    height = sky_res[5, 1]
    for k in range(5):
        width = jnp.where(face == k, sky_res[k, 0], width)
        height = jnp.where(face == k, sky_res[k, 1], height)
    return width, height


def _fetch(sky_faces, face, yp, xp):
    """One flat single-index row gather from the (6*H*W, 3) face table,
    in place of the 3-index ``sky_faces[face, yp, xp]`` form.  Faces are
    padded to a common (H, W), so the flat index is exact for every
    face."""
    Hp, Wp = sky_faces.shape[1], sky_faces.shape[2]
    idx = (face * (Hp * Wp) + yp * Wp + xp).astype(jnp.int32)
    return sky_faces.reshape(-1, 3)[idx]


def gl_cubemap_color(sky_faces, sky_res, direction):
    """Standard OpenGL cubemap fetch (for the GLSL path tracer's iChannel1).

    Face order is +X,-X,+Y,-Y,+Z,-Z in ``sky_faces``; bilinear is skipped in
    favor of nearest fetch for now (textures are high-res).
    """
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    face = jnp.where(
        is_x, jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)))
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))

    sc = jnp.select([face == 0, face == 1, face == 2, face == 3, face == 4],
                    [-z, z, x, x, x], -x)
    tc = jnp.select([face == 0, face == 1, face == 2, face == 3, face == 4],
                    [-y, -y, z, -z, -y], -y)
    inv_ma = 1.0 / ma
    s = (sc * inv_ma + 1.0) * 0.5
    t = (tc * inv_ma + 1.0) * 0.5
    width, height = _face_res(sky_res, face)
    xp = jnp.clip((width.astype(jnp.float32) * s).astype(jnp.int32), 0, width - 1)
    yp = jnp.clip((height.astype(jnp.float32) * t).astype(jnp.int32), 0, height - 1)
    return _fetch(sky_faces, face, yp, xp)
