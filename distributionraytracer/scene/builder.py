"""Host-side scene builder: accumulates primitives, emits a SceneData pytree.

Mirrors ``Scene::addObject``/``addLight`` (scene.cpp:296-327) but produces SoA
NumPy arrays instead of heap objects.  Object insertion order is preserved in
``SceneStatic.obj_types/obj_tidx`` because the reference's NONE-accel shadow
test skips the *same object pointer* (main.cpp:433) and accelerator builds
consume objects in this order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from distributionraytracer.scene.types import (
    ACCEL_NONE, OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE,
    SceneData, SceneStatic,
)


class SceneBuilder:
    def __init__(self):
        self.sph_center: List = []
        self.sph_radius: List = []
        self.sph_mat: List = []
        self.tri_v0: List = []
        self.tri_e1: List = []
        self.tri_e2: List = []
        self.tri_mat: List = []
        self.pln_n: List = []
        self.pln_d: List = []
        self.pln_mat: List = []
        self.box_min: List = []
        self.box_max: List = []
        self.box_mat: List = []
        self.materials: List[Tuple] = []  # (cd, kd, cs, ks, shine, T, ior)
        self.lights: List[Tuple] = []  # (pos, color, e1, e2, is_quad, grid_res)
        self.obj_types: List[int] = []
        self.obj_tidx: List[int] = []
        self.camera = None  # dict
        self.bg_color = np.zeros(3, np.float32)
        self.accel = ACCEL_NONE
        self.spp = 0
        self.sky_faces = None  # (6,H,W,3) f32
        self.sky_res = None  # (6,2) i32
        self._cur_mat = -1

    # ---------------------------------------------------------------- mats
    def add_material(self, cd, kd, cs, ks, shine, T, ior) -> int:
        """P3F ``mat cd(3) Kd cs(3) Ks Shine T ior`` (scene.cpp:512-520)."""
        self.materials.append((
            np.asarray(cd, np.float32), float(kd),
            np.asarray(cs, np.float32), float(ks),
            float(shine), float(T), float(ior)))
        self._cur_mat = len(self.materials) - 1
        return self._cur_mat

    def _mat(self, mat: Optional[int]) -> int:
        m = self._cur_mat if mat is None else mat
        if m < 0:
            # reference would leave a dangling Material*; require one instead
            raise ValueError("primitive added before any material")
        return m

    # ---------------------------------------------------------------- prims
    def add_sphere(self, center, radius, mat: Optional[int] = None):
        self.sph_center.append(np.asarray(center, np.float32))
        self.sph_radius.append(float(radius))
        self.sph_mat.append(self._mat(mat))
        self.obj_types.append(OBJ_SPHERE)
        self.obj_tidx.append(len(self.sph_radius) - 1)

    def add_triangle(self, p0, p1, p2, mat: Optional[int] = None):
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        p2 = np.asarray(p2, np.float32)
        self.tri_v0.append(p0)
        self.tri_e1.append(p1 - p0)
        self.tri_e2.append(p2 - p0)
        self.tri_mat.append(self._mat(mat))
        self.obj_types.append(OBJ_TRIANGLE)
        self.obj_tidx.append(len(self.tri_mat) - 1)

    def add_triangles_bulk(self, verts: np.ndarray, faces: np.ndarray,
                           mat: Optional[int] = None):
        """Vectorized mesh insertion (P3F ``mesh``, scene.cpp:565-594)."""
        m = self._mat(mat)
        v0 = verts[faces[:, 0]].astype(np.float32)
        v1 = verts[faces[:, 1]].astype(np.float32)
        v2 = verts[faces[:, 2]].astype(np.float32)
        base = len(self.tri_mat)
        n = len(faces)
        self.tri_v0.extend(v0)
        self.tri_e1.extend(v1 - v0)
        self.tri_e2.extend(v2 - v0)
        self.tri_mat.extend([m] * n)
        self.obj_types.extend([OBJ_TRIANGLE] * n)
        self.obj_tidx.extend(range(base, base + n))

    def add_plane_hessian(self, n, d, mat: Optional[int] = None):
        self.pln_n.append(np.asarray(n, np.float32))
        self.pln_d.append(float(d))
        self.pln_mat.append(self._mat(mat))
        self.obj_types.append(OBJ_PLANE)
        self.obj_tidx.append(len(self.pln_d) - 1)

    def add_plane_points(self, p0, p1, p2, mat: Optional[int] = None):
        """General plane from 3 points (scene.cpp:100-114)."""
        p0 = np.asarray(p0, np.float64)
        pn = np.cross(np.asarray(p1, np.float64) - p0,
                      np.asarray(p2, np.float64) - p0)
        l = np.linalg.norm(pn)
        if l == 0.0:
            raise ValueError("degenerate plane")
        pn = pn / l
        d = -float(pn @ p0)
        self.add_plane_hessian(pn.astype(np.float32), d, mat)

    def add_box(self, minp, maxp, mat: Optional[int] = None):
        self.box_min.append(np.asarray(minp, np.float32))
        self.box_max.append(np.asarray(maxp, np.float32))
        self.box_mat.append(self._mat(mat))
        self.obj_types.append(OBJ_BOX)
        self.obj_tidx.append(len(self.box_mat) - 1)

    # ---------------------------------------------------------------- lights
    def add_point_light(self, pos, color):
        self.lights.append((np.asarray(pos, np.float32),
                            np.asarray(color, np.float32),
                            np.zeros(3, np.float32), np.zeros(3, np.float32),
                            False, 0))

    def add_quad_light(self, pos, color, v1, v2, grid_res: int):
        pos = np.asarray(pos, np.float32)
        # e1 = v1 - pos, e2 = v2 - pos (scene.h:90-91)
        self.lights.append((pos, np.asarray(color, np.float32),
                            np.asarray(v1, np.float32) - pos,
                            np.asarray(v2, np.float32) - pos,
                            True, int(grid_res)))

    # ---------------------------------------------------------------- camera
    def set_camera(self, eye, at, up, fovy, hither, res_x, res_y,
                   aperture_ratio, focal_ratio, yon=None):
        self.camera = dict(
            eye=np.asarray(eye, np.float32), at=np.asarray(at, np.float32),
            up=np.asarray(up, np.float32), fovy=float(fovy),
            hither=float(hither),
            yon=float(yon) if yon is not None else 1000.0 * float(hither),
            res_x=int(res_x), res_y=int(res_y),
            aperture_ratio=float(aperture_ratio),
            focal_ratio=float(focal_ratio))

    # ---------------------------------------------------------------- build
    def build(self) -> SceneData:
        if self.camera is None:
            raise ValueError("scene has no camera")

        def stack(rows, shape, dtype=np.float32):
            if rows:
                return np.stack(rows).astype(dtype)
            return np.zeros(shape, dtype)

        n_s, n_t = len(self.sph_radius), len(self.tri_mat)
        n_p, n_b = len(self.pln_d), len(self.box_mat)
        n_m, n_l = max(len(self.materials), 1), len(self.lights)

        mats = self.materials or [(np.zeros(3, np.float32), 0.0,
                                   np.zeros(3, np.float32), 0.0, 1.0, 0.0, 1.0)]
        mat_cd = np.stack([m[0] for m in mats])
        mat_kd = np.array([m[1] for m in mats], np.float32)
        mat_cs = np.stack([m[2] for m in mats])
        mat_ks = np.array([m[3] for m in mats], np.float32)
        mat_shine = np.array([m[4] for m in mats], np.float32)
        mat_T = np.array([m[5] for m in mats], np.float32)
        mat_ior = np.array([m[6] for m in mats], np.float32)

        lights = self.lights
        lp = stack([l[0] for l in lights], (n_l, 3))
        lc = stack([l[1] for l in lights], (n_l, 3))
        le1 = stack([l[2] for l in lights], (n_l, 3))
        le2 = stack([l[3] for l in lights], (n_l, 3))
        lq = np.array([l[4] for l in lights], bool) if lights else np.zeros(0, bool)
        lg = np.array([l[5] for l in lights], np.int32) if lights else np.zeros(0, np.int32)

        if self.sky_faces is not None:
            sky_faces, sky_res = self.sky_faces, self.sky_res
            has_sky = True
        else:
            sky_faces = np.zeros((6, 1, 1, 3), np.float32)
            sky_res = np.ones((6, 2), np.int32)
            has_sky = False

        cam = self.camera
        static = SceneStatic(
            n_spheres=n_s, n_triangles=n_t, n_planes=n_p, n_boxes=n_b,
            n_objects=len(self.obj_types), n_lights=n_l, n_materials=n_m,
            accel=self.accel, spp=self.spp,
            res_x=cam["res_x"], res_y=cam["res_y"], fovy=cam["fovy"],
            hither=cam["hither"], yon=cam["yon"],
            aperture_ratio=cam["aperture_ratio"],
            focal_ratio=cam["focal_ratio"], has_skybox=has_sky,
            obj_types=tuple(self.obj_types), obj_tidx=tuple(self.obj_tidx),
            light_quad=tuple(bool(l[4]) for l in lights),
            light_grid=tuple(int(l[5]) for l in lights),
            # refraction fires only when T == 1 exactly (main.cpp:465);
            # reflection only when Ks > 0 (main.cpp:504)
            any_refr=bool(np.any(mat_T == 1.0)),
            any_refl=bool(np.any(mat_ks > 0.0)))

        return SceneData(
            sph_center=stack(self.sph_center, (n_s, 3)),
            sph_radius=np.array(self.sph_radius, np.float32),
            sph_mat=np.array(self.sph_mat, np.int32),
            tri_v0=stack(self.tri_v0, (n_t, 3)),
            tri_e1=stack(self.tri_e1, (n_t, 3)),
            tri_e2=stack(self.tri_e2, (n_t, 3)),
            tri_mat=np.array(self.tri_mat, np.int32),
            pln_n=stack(self.pln_n, (n_p, 3)),
            pln_d=np.array(self.pln_d, np.float32),
            pln_mat=np.array(self.pln_mat, np.int32),
            box_min=stack(self.box_min, (n_b, 3)),
            box_max=stack(self.box_max, (n_b, 3)),
            box_mat=np.array(self.box_mat, np.int32),
            mat_cd=mat_cd, mat_kd=mat_kd, mat_cs=mat_cs, mat_ks=mat_ks,
            mat_shine=mat_shine, mat_kr=mat_ks.copy(),  # m_Refl = Ks (scene.h:42)
            mat_T=mat_T, mat_ior=mat_ior,
            light_pos=lp, light_color=lc, light_e1=le1, light_e2=le2,
            light_is_quad=lq, light_grid_res=lg,
            cam_eye=cam["eye"], cam_at=cam["at"], cam_up=cam["up"],
            bg_color=np.asarray(self.bg_color, np.float32),
            sky_faces=sky_faces, sky_res=sky_res,
            static=static)
