"""Seeded scene generators: deterministic per seed, the shapes on record,
and the P3F text reads back as the same scene."""

import os

import numpy as np
import pytest

from distributionraytracer.scene import generate as G
from distributionraytracer.scene import load_p3f
from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE,
)
from distributionraytracer.utils.image import decode_png, encode_png

SMALL = ["balls_low", "balls_box", "dof", "motion", "teste", "blueDiamond"]


def _leaves(scene):
    return [np.asarray(x) for x in scene.tree_flatten()[0]]


def _same(a, b):
    return a.static == b.static and all(
        np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("name", SMALL)
def test_deterministic_per_seed(name):
    a, b = G.generate(name, 3), G.generate(name, 3)
    assert _same(a, b)
    assert not _same(a, G.generate(name, 4))


@pytest.mark.parametrize("name", SMALL)
def test_p3f_round_trip(tmp_path, name):
    path = G.write_p3f(name, 5, str(tmp_path))
    assert _same(load_p3f(path), G.generate(name, 5))


# (name, objects, spheres, triangles, planes, boxes, accel, res, spp, sky)
SHAPES = [
    ("balls_low", 11, 10, 0, 1, 0, ACCEL_NONE, (512, 512), 16, False),
    ("balls_box", 93, 91, 0, 0, 2, ACCEL_GRID, (800, 600), 0, True),
    ("balls_high", 7383, 7381, 2, 0, 0, ACCEL_GRID, (512, 512), 0, True),
    ("dof", 9, 6, 2, 1, 0, ACCEL_NONE, (800, 600), 4, False),
    ("motion", 3, 2, 0, 1, 0, ACCEL_NONE, (512, 512), 32, False),
    ("teste", 7, 4, 1, 1, 1, ACCEL_NONE, (800, 600), 16, False),
    ("blueDiamond", 178, 0, 178, 0, 0, ACCEL_GRID, (800, 600), 0, True),
]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_shapes_on_record(shape):
    name, n, ns, nt, npl, nb, accel, res, spp, sky = shape
    st = G.generate(name, 0).static
    assert (st.n_objects, st.n_spheres, st.n_triangles, st.n_planes,
            st.n_boxes) == (n, ns, nt, npl, nb)
    assert st.accel == accel and (st.res_x, st.res_y) == res
    assert st.spp == spp and st.has_skybox == sky


def test_mesh_scenes():
    """The 100k-triangle deployments: one closed mesh (every edge shared
    by exactly two faces), glass + metal beside it under the BVH."""
    from distributionraytracer.scene.generate import blob_mesh
    verts, faces = blob_mesh(np.random.default_rng(0))
    assert faces.shape == (100000, 3) and verts.shape == (50002, 3)
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()
    s = G.generate("dragon_assignment1", 0)
    st = s.static
    assert st.accel == ACCEL_BVH and st.n_objects == 100005
    assert st.n_triangles == 100000 and st.any_refr and st.any_refl
    ks = np.asarray(s.mat_ks)[np.asarray(s.sph_mat)]
    assert ((ks >= 0.9) & (ks <= 0.95)).all()
    assert G.generate("assignment1", 0).static.accel == ACCEL_GRID
    d = G.generate("dragon", 0).static
    assert d.n_objects == 100000 and not d.any_refr and not d.any_refl


def test_cubemap_and_png_round_trip(tmp_path):
    faces = G.cubemap_faces(0, size=32)
    assert len(faces) == 6 and faces[0].shape == (32, 32, 3)
    assert all(np.array_equal(a, b)
               for a, b in zip(faces, G.cubemap_faces(0, size=32)))
    assert not np.array_equal(faces[0], G.cubemap_faces(1, size=32)[0])
    for f in faces:
        assert np.array_equal(decode_png(encode_png(f)), f)
    from distributionraytracer.utils.image import read_png, write_png
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    back = read_png(p)
    assert back.shape == (5, 7, 3)
    assert np.abs(back - img).max() < 1.0 / 255.0 + 1e-6


def test_unknown_scene_name():
    with pytest.raises(ValueError, match="unknown scene"):
        G.generate("cornell", 0)


def test_written_scene_dir_layout(scenes_dir):
    for name in G.SCENES:
        assert os.path.exists(os.path.join(scenes_dir, name + ".p3f"))
    for face in ("right", "left", "top", "bottom", "front", "back"):
        assert os.path.exists(os.path.join(scenes_dir, "skybox",
                                           face + ".png"))
