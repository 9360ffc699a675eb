"""Skybox cubemap loading.

The reference decodes 6 jpgs (right/left/top/bottom/front/back) with DevIL at
lower-left origin (scene.cpp:329-378).  Here the faces decode into one padded
``(6, H, W, 3)`` float32 array (u8 / 255.99, maths.h:133-136) plus a per-face
``(6, 2)`` (width, height) table so faces of different sizes coexist.

A face is read from ``<name>.png`` when present (the generated skyboxes of
``scene.generate``, decoded by ``utils.image`` with the standard library),
else from the reference's ``<name>.jpg``, which needs Pillow.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from distributionraytracer.utils.image import decode_png

# Face order matches the CubeMap enum (scene.h:19)
FACE_NAMES = ["right", "left", "top", "bottom", "front", "back"]


def _read_face(sky_dir: str, name: str) -> np.ndarray:
    """(H, W, 3) uint8 with row 0 at the top."""
    png = os.path.join(sky_dir, name + ".png")
    if os.path.exists(png):
        with open(png, "rb") as f:
            return decode_png(f.read())
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"skybox face {name}.jpg needs Pillow to decode; install it or "
            f"provide {name}.png") from e
    return np.asarray(Image.open(os.path.join(sky_dir, name + ".jpg"))
                      .convert("RGB"), np.uint8)


def faces_from_u8(imgs) -> Tuple[np.ndarray, np.ndarray]:
    """Six (H, W, 3) uint8 faces, row 0 at the top -> (faces, res)."""
    # DevIL loads with lower-left origin (scene.cpp:345-346): flip rows
    imgs = [a[::-1] for a in imgs]
    H = max(a.shape[0] for a in imgs)
    W = max(a.shape[1] for a in imgs)
    faces = np.zeros((6, H, W, 3), np.float32)
    res = np.zeros((6, 2), np.int32)
    for i, a in enumerate(imgs):
        # u8tofloat: x / 255.99 (maths.h:133-136)
        faces[i, : a.shape[0], : a.shape[1]] = a.astype(np.float32) / 255.99
        res[i] = (a.shape[1], a.shape[0])  # (width, height)
    return faces, res


def load_skybox(sky_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    return faces_from_u8([_read_face(sky_dir, n) for n in FACE_NAMES])
