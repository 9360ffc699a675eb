"""Image IO: PNG write with the reference's u8 conversion.

``saveImgFile`` (main.cpp:251-266) writes img_Data bytes produced by
``u8fromfloat`` (maths.h:126-130): ``x*255.99`` saturated at 255.  The
render buffer is y-up (row 0 = bottom scanline); PNG is y-down, so flip.

PNG is written and read with the standard library (``zlib``): 8-bit RGB,
unfiltered scanlines — what this package writes (images, generated skybox
faces).  Other images are read with Pillow (``scene.skybox``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def to_u8(img: np.ndarray) -> np.ndarray:
    v = np.asarray(img, np.float32) * 255.99
    return np.where(v >= 255.0, 255, v.astype(np.uint8)).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8, row 0 at the top -> PNG bytes."""
    a = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w, _ = a.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * 3)],
                         axis=1)  # filter type 0 on every scanline
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                               0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as ``encode_png`` writes them -> (H, W, 3) uint8, row 0 at
    the top.  Raises ValueError for any other PNG layout."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if (depth, ctype, interlace) != (8, 2, 0) or raw.size != h * (1 + 3 * w):
        raise ValueError("not an 8-bit RGB PNG as encode_png writes")
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("filtered PNG scanlines: decode with Pillow")
    return raw[:, 1:].reshape(h, w, 3).copy()


def write_png(path: str, img: np.ndarray):
    """img: (H, W, 3) float in [0,1], row 0 at the bottom."""
    with open(path, "wb") as f:
        f.write(encode_png(to_u8(np.asarray(img))[::-1]))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        a = decode_png(f.read())
    return a[::-1].astype(np.float32) / 255.99
