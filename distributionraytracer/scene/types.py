"""Scene representation: SoA pytrees of jnp arrays.

The reference stores the scene as a vector of heap objects behind virtual
``Object::hit`` (scene.h:109-180).  Virtual dispatch and pointer chasing
don't vectorize.  Here the scene is a pytree of
structure-of-arrays:

- per-primitive-type arrays (spheres / triangles / planes / aaboxes), padded
  to static sizes so every render compiles once per scene shape;
- a materials table indexed per primitive (``Material``, scene.h:34-66);
- a lights table (``Light``, scene.h:68-107);
- camera parameters (camera.h:12-102) kept as raw eye/at/up leaves with the
  uvn frame derived inside jit so gradients flow into camera pose;
- an optional skybox cubemap as a padded ``(6, H, W, 3)`` float array
  (scene.cpp:329-458).

Differentiable leaves: all float arrays (materials, lights, camera, primitive
geometry, background color, skybox texels).  Static metadata (counts, accel
type, resolution, spp) lives in :class:`SceneStatic`, which is hashable and
becomes pytree aux data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Acceleration structure selector (scene.h:22)
ACCEL_NONE = 0
ACCEL_GRID = 1
ACCEL_BVH = 2

# Unified object type tags, in reference insertion order semantics
OBJ_SPHERE = 0
OBJ_TRIANGLE = 1
OBJ_PLANE = 2
OBJ_BOX = 3

# Light types (scene.h:16)
LIGHT_PUNCTUAL = 0
LIGHT_QUAD = 1


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable, shape-defining metadata for a scene."""

    n_spheres: int
    n_triangles: int
    n_planes: int
    n_boxes: int
    n_objects: int  # total, in reference insertion order
    n_lights: int
    n_materials: int
    accel: int  # ACCEL_NONE | ACCEL_GRID | ACCEL_BVH
    spp: int  # samples-per-pixel from the P3F 'spp' command
    res_x: int
    res_y: int
    # static camera scalars (camera.h:32-61)
    fovy: float
    hither: float
    yon: float
    aperture_ratio: float
    focal_ratio: float
    has_skybox: bool
    # object-id -> (type, per-type index), static tuples for packing
    obj_types: Tuple[int, ...] = ()
    obj_tidx: Tuple[int, ...] = ()
    # per-light static structure (quad-ness and regular-grid resolution are
    # shape-determining, so they live here rather than as traced leaves)
    light_quad: Tuple[bool, ...] = ()
    light_grid: Tuple[int, ...] = ()
    # Static ray-tree pruning facts, derived from the material table at build
    # time.  The reference's recursion (main.cpp:456-518) only spawns a
    # refraction ray when some material has T == 1 and a reflection ray when
    # some material has Ks > 0; when a whole class is impossible the fixed
    # ray tree drops that subtree (integrator.whitted).  Defaults are the
    # conservative "anything possible".  NOTE: stale if materials are
    # *trained* across the T==1 / Ks>0 boundaries — disable via
    # RenderConfig(static_prune=False) for such inverse rendering.
    any_refr: bool = True
    any_refl: bool = True

    @property
    def has_dof(self) -> bool:
        return self.aperture_ratio != 0.0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SceneData:
    """SoA scene arrays (the pytree) + static metadata (aux)."""

    # --- spheres (scene.h:154-166) ---
    sph_center: Any  # (Ns,3) f32
    sph_radius: Any  # (Ns,)  f32
    sph_mat: Any  # (Ns,)  i32
    # --- triangles (scene.h:138-150); SoA of v0 and the two edges ---
    tri_v0: Any  # (Nt,3)
    tri_e1: Any  # (Nt,3)  = v1 - v0
    tri_e2: Any  # (Nt,3)  = v2 - v0
    tri_mat: Any  # (Nt,) i32
    # --- planes (scene.h:125-136), Hessian form PN.P + D = 0 ---
    pln_n: Any  # (Np,3)
    pln_d: Any  # (Np,)
    pln_mat: Any  # (Np,) i32
    # --- axis-aligned boxes (scene.h:168-180) ---
    box_min: Any  # (Nb,3)
    box_max: Any  # (Nb,3)
    box_mat: Any  # (Nb,) i32
    # --- materials (scene.h:34-66); m_Refl = Ks quirk preserved (scene.h:42)
    mat_cd: Any  # (M,3) diffuse color
    mat_kd: Any  # (M,)
    mat_cs: Any  # (M,3) specular color
    mat_ks: Any  # (M,)
    mat_shine: Any  # (M,)
    mat_kr: Any  # (M,)  == Ks at load (scene.h:42)
    mat_T: Any  # (M,)  transmittance
    mat_ior: Any  # (M,)
    # --- lights (scene.h:68-107) ---
    light_pos: Any  # (L,3)
    light_color: Any  # (L,3)
    light_e1: Any  # (L,3)  = v1 - pos (scene.h:90)
    light_e2: Any  # (L,3)  = v2 - pos
    light_is_quad: Any  # (L,) bool
    light_grid_res: Any  # (L,) i32
    # --- camera pose (differentiable; frame derived in jit) ---
    cam_eye: Any  # (3,)
    cam_at: Any  # (3,)
    cam_up: Any  # (3,)
    # --- background / skybox ---
    bg_color: Any  # (3,)
    sky_faces: Any  # (6,H,W,3) f32 or (6,1,1,3) zeros when disabled
    sky_res: Any  # (6,2) i32 per-face (width,height)
    static: SceneStatic = None  # aux

    _LEAF_NAMES = [
        "sph_center", "sph_radius", "sph_mat",
        "tri_v0", "tri_e1", "tri_e2", "tri_mat",
        "pln_n", "pln_d", "pln_mat",
        "box_min", "box_max", "box_mat",
        "mat_cd", "mat_kd", "mat_cs", "mat_ks", "mat_shine", "mat_kr",
        "mat_T", "mat_ior",
        "light_pos", "light_color", "light_e1", "light_e2",
        "light_is_quad", "light_grid_res",
        "cam_eye", "cam_at", "cam_up",
        "bg_color", "sky_faces", "sky_res",
    ]

    def tree_flatten(self):
        return [getattr(self, n) for n in self._LEAF_NAMES], self.static

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, static=aux)

    # ------------------------------------------------------------------
    def device_put(self) -> "SceneData":
        leaves, aux = self.tree_flatten()
        return SceneData.tree_unflatten(aux, [jnp.asarray(l) for l in leaves])

    def packed_objects(self):
        """Unified ``(O, 12)`` primitive table in reference insertion order.

        Built inside jit from the per-type SoA arrays so there is a single
        differentiable source of truth.  Row layout by type:

        - sphere:   ``[cx, cy, cz, r, 0...]``
        - triangle: ``[v0, e1, e2]``
        - plane:    ``[nx, ny, nz, D, 0...]``
        - box:      ``[min, max, 0...]``

        Returns ``(data (O,12) f32, types (O,) i32, mats (O,) i32)``.
        """
        st = self.static
        O = st.n_objects
        data = jnp.zeros((max(O, 1), 12), jnp.float32)
        mats = jnp.zeros((max(O, 1),), jnp.int32)
        types = jnp.asarray(
            np.array(st.obj_types, np.int32).reshape(-1)
            if O else np.zeros((1,), np.int32))

        obj_types = np.array(st.obj_types, np.int64)
        obj_tidx = np.array(st.obj_tidx, np.int64)

        def rows_of(t):
            return np.nonzero(obj_types == t)[0]

        ids = rows_of(OBJ_SPHERE)
        if len(ids):
            sub = obj_tidx[ids]
            row = jnp.concatenate(
                [self.sph_center[sub], self.sph_radius[sub][:, None],
                 jnp.zeros((len(ids), 8), jnp.float32)], axis=1)
            data = data.at[ids].set(row)
            mats = mats.at[ids].set(self.sph_mat[sub])
        ids = rows_of(OBJ_TRIANGLE)
        if len(ids):
            sub = obj_tidx[ids]
            row = jnp.concatenate(
                [self.tri_v0[sub], self.tri_e1[sub], self.tri_e2[sub],
                 jnp.zeros((len(ids), 3), jnp.float32)], axis=1)
            data = data.at[ids].set(row)
            mats = mats.at[ids].set(self.tri_mat[sub])
        ids = rows_of(OBJ_PLANE)
        if len(ids):
            sub = obj_tidx[ids]
            row = jnp.concatenate(
                [self.pln_n[sub], self.pln_d[sub][:, None],
                 jnp.zeros((len(ids), 8), jnp.float32)], axis=1)
            data = data.at[ids].set(row)
            mats = mats.at[ids].set(self.pln_mat[sub])
        ids = rows_of(OBJ_BOX)
        if len(ids):
            sub = obj_tidx[ids]
            row = jnp.concatenate(
                [self.box_min[sub], self.box_max[sub],
                 jnp.zeros((len(ids), 6), jnp.float32)], axis=1)
            data = data.at[ids].set(row)
            mats = mats.at[ids].set(self.box_mat[sub])
        return data, types, mats


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Derived camera frame, computed in-jit (camera.h:44-57).

    ``n = normalize(eye - at)``, ``u = normalize(up x n)``, ``v = n x u``;
    window ``h = 2 * plane_dist * tan(fov/2)``, ``w = aspect * h``;
    lens ``aperture = aperture_ratio * (w / res_x)`` (camera.h:57).
    """

    eye: Any
    u: Any
    v: Any
    n: Any
    w: Any
    h: Any
    plane_dist: Any
    aperture: Any
    focal_ratio: float
    res_x: int
    res_y: int


def derive_camera(scene: SceneData) -> CameraParams:
    st = scene.static
    n = scene.cam_eye - scene.cam_at
    plane_dist = jnp.linalg.norm(n)
    n = n / plane_dist
    u = jnp.cross(scene.cam_up, n)
    u = u / jnp.linalg.norm(u)
    v = jnp.cross(n, u)
    h = 2.0 * plane_dist * jnp.tan((jnp.pi * st.fovy / 180.0) / 2.0)
    w = (st.res_x / st.res_y) * h
    aperture = st.aperture_ratio * (w / st.res_x)
    return CameraParams(
        eye=scene.cam_eye, u=u, v=v, n=n, w=w, h=h, plane_dist=plane_dist,
        aperture=aperture, focal_ratio=st.focal_ratio,
        res_x=st.res_x, res_y=st.res_y)
