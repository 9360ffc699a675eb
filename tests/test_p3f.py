"""P3F parser tests against known properties of the reference scene files."""

import os

import numpy as np
import pytest

from distributionraytracer.scene import load_p3f
from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE,
)


def test_balls_low(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "balls_low.p3f"))
    st = s.static
    assert st.accel == ACCEL_NONE
    assert st.spp == 16
    assert st.res_x == 512 and st.res_y == 512
    assert st.aperture_ratio == 0.0
    assert st.n_lights == 3
    assert np.asarray(s.light_is_quad).tolist() == [True, True, False]
    assert np.asarray(s.light_grid_res)[:2].tolist() == [16, 16]
    # plane floor + 10 spheres
    assert st.n_planes == 1
    assert st.n_spheres == 10
    np.testing.assert_allclose(np.asarray(s.bg_color), [0.078, 0.361, 0.753],
                               atol=1e-6)
    # quad light frame e1 = v1 - pos (scene.h:90)
    np.testing.assert_allclose(np.asarray(s.light_pos)[0], [4, 3, 2])
    np.testing.assert_allclose(np.asarray(s.light_e1)[0],
                               np.array([4, 2, 2]) - np.array([4, 3, 2]))


def test_dof_scene(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "dof.p3f"))
    st = s.static
    assert st.spp == 4
    assert st.aperture_ratio == 12.0
    assert st.focal_ratio == 1.5
    assert st.res_x == 800 and st.res_y == 600
    assert st.n_triangles == 2


def test_mesh_scene(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "blueDiamond.p3f"), load_sky=False)
    st = s.static
    assert st.accel == ACCEL_GRID
    # 91-vertex / 178-face glass mesh
    assert st.n_triangles == 178


def test_bvh_scene(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "dragon_assignment1.p3f"),
                 load_sky=False)
    assert s.static.accel == ACCEL_BVH
    assert s.static.n_triangles >= 100000


def test_plane_from_points(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "balls_low.p3f"))
    # pl 12 12 -0.5  -12 12 -0.5  -12 -12 -0.5 -> normal +z-ish plane z=-0.5
    pn = np.asarray(s.pln_n)[0]
    pd = float(np.asarray(s.pln_d)[0])
    np.testing.assert_allclose(pn, [0, 0, 1], atol=1e-6)
    assert abs(pd - 0.5) < 1e-6


def test_skybox_loading(scenes_dir):
    s = load_p3f(os.path.join(scenes_dir, "balls_high.p3f"))
    assert s.static.has_skybox
    faces = np.asarray(s.sky_faces)
    assert faces.shape[0] == 6 and faces.shape[-1] == 3
    assert faces.max() <= 1.0 and faces.max() > 0.2
