"""Seeded generators for the scene deployments this renderer supports.

Each generator rebuilds one of the reference's ``P3D_Scenes`` deployments
at the shapes on record (BASELINE.md, SURVEY.md §4 and the reference's
scene headers): object counts, primitive kinds, accel, resolution, spp,
aperture, lights, skybox.  Geometry, materials and cameras beyond those
shapes are invented, from ``seed``:

==================  =========================================================
balls_low           SPD "balls" sphereflake of depth 1: 1 + 9 spheres on the
                    ``pl`` floor z = -0.5; quad lights at (4, 3, 2) and
                    (1, -4, 4) (1 x 1 quads, gridRes 16) and a point light at
                    (-3, 1, 5); background (0.078, 0.361, 0.753); camera from
                    (2.1, 1.3, 1.7) at (0, 0, 0.115), up +z, fovy 45;
                    512 x 512, spp 16, accel none.
balls_box           sphereflake of depth 2 (91 spheres) + 2 boxes, grid,
                    800 x 600, spp 0, skybox, 3 point lights.
balls_high          sphereflake of depth 4 (7,381 spheres) + a 2-triangle
                    floor quad, grid, 512 x 512, spp 0, skybox, 3 point
                    lights.
dof                 6 spheres, a floor plane and a 2-triangle backdrop quad;
                    800 x 600, spp 4, aperture ratio 12, focal ratio 1.5.
motion              a floor plane and 2 spheres; 512 x 512, spp 32 (render
                    with ``motion_blur=True``: spheres move along +y).
teste               a floor plane, an aaBox, a triangle, 2 glass spheres
                    (T = 1, absorbing cd) and 2 metal spheres; 800 x 600,
                    spp 16.
blueDiamond         a closed 91-vertex / 178-face brilliant-cut glass mesh
                    (30-gon table, crown, girdle, pavilion to a culet; T = 1,
                    ior 2.42), grid, 800 x 600, spp 0, skybox.
dragon_assignment1  one closed 100,000-triangle / 50,002-vertex mesh (a UV
                    sphere, 250 x 200, stretched 2:1:1 and displaced by seeded
                    sinusoids so the BVH is not trivial) of glass (T = 1),
                    with 4 metal spheres (Ks 0.9-0.95) and a floor slab
                    (aaBox) beside it: 100,005 objects, BVH, 512 x 512,
                    spp 0.
assignment1         the same scene under the uniform grid.
dragon              the mesh alone, diffuse only, grid, 800 x 600, spp 0.
==================  =========================================================

Cubemaps are made from the seed at ``SKY_FACE`` x ``SKY_FACE`` texels per
face (assumed 512): a sky-to-horizon gradient with seeded cloud bands above
a ground tint.  Everything else (sphereflake child layout rotation, colors,
light colors = white) is assumed.

``generate(name, seed)`` returns SceneData through ``SceneBuilder``;
``write_p3f(name, seed, directory)`` writes the same scene as P3F text
(plus the skybox as six PNG faces in ``<directory>/skybox``) so that
``load_p3f`` reads back an identical scene.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from distributionraytracer.scene.builder import SceneBuilder
from distributionraytracer.scene.skybox import FACE_NAMES, faces_from_u8
from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, SceneData,
)

SKY_FACE = 512
SKY_DIR = "skybox"
_ACCEL_NAME = {ACCEL_NONE: "none", ACCEL_GRID: "grid", ACCEL_BVH: "bvh"}


def _g(x) -> str:
    """Shortest text that reads back as the same float32."""
    return " ".join(str(v) for v in np.asarray(x, np.float32).reshape(-1))


class _Scene:
    """Records each scene command twice: into a SceneBuilder and as P3F
    text, so both routes build the same scene."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.b = SceneBuilder()
        self.lines: List[str] = []
        self.sky_u8: Optional[list] = None

    def accel(self, a, spp):
        self.b.accel, self.b.spp = a, spp
        self.lines += [f"accel {_ACCEL_NAME[a]}", f"spp {spp}"]

    def camera(self, eye, at, up, fovy, res, aperture=0.0, focal=1.0):
        self.b.set_camera(eye, at, up, fovy, 0.01, res[0], res[1], aperture,
                          focal)
        self.lines.append(
            f"camera eye {_g(eye)} at {_g(at)} up {_g(up)} angle {_g(fovy)}"
            f" hither 0.01 resolution {res[0]} {res[1]} aperture "
            f"{_g(aperture)} focal {_g(focal)}")

    def background(self, rgb):
        self.b.bg_color = np.asarray(rgb, np.float32)
        self.lines.append(f"bclr {_g(rgb)}")

    def skybox(self):
        self.sky_u8 = cubemap_faces(self.seed)
        self.b.sky_faces, self.b.sky_res = faces_from_u8(self.sky_u8)
        self.lines.append(f"env {SKY_DIR}")

    def mat(self, cd, kd, cs, ks, shine, T=0.0, ior=1.0):
        self.b.add_material(cd, kd, cs, ks, shine, T, ior)
        self.lines.append(f"mat {_g(cd)} {_g(kd)} {_g(cs)} {_g(ks)} "
                          f"{_g(shine)} {_g(T)} {_g(ior)}")

    def sphere(self, c, r):
        self.b.add_sphere(c, r)
        self.lines.append(f"s {_g(c)} {_g(r)}")

    def box(self, lo, hi):
        self.b.add_box(lo, hi)
        self.lines.append(f"box {_g(lo)} {_g(hi)}")

    def tri(self, p0, p1, p2):
        self.b.add_triangle(p0, p1, p2)
        self.lines.append(f"p 3 {_g(p0)} {_g(p1)} {_g(p2)}")

    def plane(self, p0, p1, p2):
        self.b.add_plane_points(p0, p1, p2)
        self.lines.append(f"pl {_g(p0)} {_g(p1)} {_g(p2)}")

    def mesh(self, verts, faces):
        verts = np.asarray(verts, np.float32)
        self.b.add_triangles_bulk(verts, faces)
        body = "\n".join(_g(v) for v in verts)
        idx = "\n".join(" ".join(str(i) for i in f) for f in faces + 1)
        self.lines.append(f"mesh {len(verts)} {len(faces)}\n{body}\n{idx}")

    def point_light(self, pos):
        self.b.add_point_light(pos, (1, 1, 1))
        self.lines.append(f"light punctual {_g(pos)} 1 1 1")

    def quad_light(self, pos, e1, e2, grid_res):
        pos = np.asarray(pos, np.float32)
        v1, v2 = pos + np.asarray(e1, np.float32), pos + np.asarray(
            e2, np.float32)
        self.b.add_quad_light(pos, (1, 1, 1), v1, v2, grid_res)
        self.lines.append(f"light quad {_g(pos)} 1 1 1 {_g(v1)} {_g(v2)} "
                          f"{grid_res}")


# ------------------------------------------------------------------ shapes
def cubemap_faces(seed: int, size: int = SKY_FACE) -> list:
    """Six (size, size, 3) uint8 faces (row 0 at the top), in FACE_NAMES
    order: zenith blue to a pale horizon, seeded cloud bands, a brown
    ground below the horizon."""
    rng = np.random.default_rng([seed, 7])
    k = rng.normal(size=(4, 3)) * np.array([3.0, 1.0, 3.0])
    ph = rng.uniform(0, 2 * np.pi, 4)
    s = (np.arange(size) + 0.5) / size * 2 - 1
    a, b = np.meshgrid(s, -s)  # a: right, b: up in the face image
    one = np.ones_like(a)
    dirs = {"right": (one, b, -a), "left": (-one, b, a),
            "top": (a, one, -b), "bottom": (a, -one, b),
            "front": (a, b, one), "back": (-a, b, -one)}
    faces = []
    for name in FACE_NAMES:
        x, y, z = dirs[name]
        n = np.sqrt(x * x + y * y + z * z)
        x, y, z = x / n, y / n, z / n
        up = np.clip(y, 0, 1)[..., None]
        sky = (1 - up) * np.array([0.85, 0.9, 0.95]) + up * np.array(
            [0.2, 0.45, 0.85])
        cloud = sum(np.sin(x * kk[0] + y * kk[1] + z * kk[2] + p)
                    for kk, p in zip(k, ph)) / 4
        sky = sky + np.clip(cloud, 0, 1)[..., None] * up ** 0.5 * 0.35
        ground = np.array([0.35, 0.3, 0.22]) * (0.8 + 0.2 * cloud[..., None])
        rgb = np.where((y >= 0)[..., None], sky, ground)
        faces.append((np.clip(rgb, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    return faces


def _sphereflake(sc: _Scene, depth: int):
    """SPD sphereflake: radius-0.5 sphere at the origin; each sphere has 9
    children of a third its radius, 6 around its equator and 3 above,
    touching it.  The layout is rotated by a seeded angle per level."""
    spin = sc.rng.uniform(0, 2 * np.pi, depth + 1)
    dirs0 = [(np.cos(a), np.sin(a), 0.0) for a in
             np.arange(6) * np.pi / 3]
    dirs0 += [(np.cos(a) * np.cos(np.pi / 4), np.sin(a) * np.cos(np.pi / 4),
               np.sin(np.pi / 4)) for a in np.arange(3) * 2 * np.pi / 3
              + np.pi / 6]
    dirs0 = np.asarray(dirs0)

    def rec(c, r, level):
        sc.sphere(c, r)
        if level == depth:
            return
        a = spin[level]
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]])
        for dv in dirs0 @ rot.T:
            rec(c + dv * (r + r / 3), r / 3, level + 1)

    rec(np.zeros(3), 0.5, 0)


def _balls(sc: _Scene, depth: int):
    jitter = sc.rng.uniform(-0.05, 0.05, 3)
    sc.mat(np.clip(np.array([1.0, 0.75, 0.33]) + jitter, 0, 1), 0.8,
           (1, 1, 1), 0.5, 30)
    _sphereflake(sc, depth)


def _balls_camera(sc, res):
    sc.camera((2.1, 1.3, 1.7), (0, 0, 0.115), (0, 0, 1), 45, res)


def _floor_mat(sc):
    sc.mat((0.75, 0.75, 0.72), 0.8, (0, 0, 0), 0.0, 10)


def balls_low(sc: _Scene):
    sc.accel(ACCEL_NONE, 16)
    _balls_camera(sc, (512, 512))
    sc.background((0.078, 0.361, 0.753))
    sc.quad_light((4, 3, 2), (0, -1, 0), (1, 0, 0), 16)
    sc.quad_light((1, -4, 4), (0, 1, 0), (1, 0, 0), 16)
    sc.point_light((-3, 1, 5))
    _floor_mat(sc)
    sc.plane((12, 12, -0.5), (-12, 12, -0.5), (-12, -12, -0.5))
    _balls(sc, 1)


def _sky_lights(sc):
    for p in ((4, 3, 2), (1, -4, 4), (-3, 1, 5)):
        sc.point_light(p)


def balls_box(sc: _Scene):
    sc.accel(ACCEL_GRID, 0)
    _balls_camera(sc, (800, 600))
    sc.background((0.078, 0.361, 0.753))
    sc.skybox()
    _sky_lights(sc)
    _balls(sc, 2)
    sc.mat((0.3, 0.5, 0.8), 0.7, (1, 1, 1), 0.3, 40)
    sc.box((0.8, -1.2, -0.5), (1.3, -0.7, 0.0))
    sc.box((-1.4, 0.6, -0.5), (-0.9, 1.1, 0.3))


def balls_high(sc: _Scene):
    sc.accel(ACCEL_GRID, 0)
    _balls_camera(sc, (512, 512))
    sc.background((0.078, 0.361, 0.753))
    sc.skybox()
    _sky_lights(sc)
    _balls(sc, 4)
    _floor_mat(sc)
    q = [(12, 12, -0.5), (-12, 12, -0.5), (-12, -12, -0.5), (12, -12, -0.5)]
    sc.tri(q[0], q[1], q[2])
    sc.tri(q[0], q[2], q[3])


def dof(sc: _Scene):
    sc.accel(ACCEL_NONE, 4)
    sc.camera((0, 1.5, 7), (0, 0.5, 0), (0, 1, 0), 40, (800, 600),
              aperture=12.0, focal=1.5)
    sc.background((0.1, 0.1, 0.15))
    sc.point_light((3, 6, 6))
    sc.point_light((-4, 5, 3))
    _floor_mat(sc)
    sc.plane((0, -0.5, 0), (0, -0.5, -1), (1, -0.5, 0))
    for i in range(6):  # a row receding in depth: in and out of focus
        c = sc.rng.uniform(0.2, 1.0, 3)
        sc.mat(c, 0.8, (1, 1, 1), 0.3, 40)
        sc.sphere((-2.5 + i, 0.0, 3.0 - 2.2 * i), 0.5)
    sc.mat((0.6, 0.6, 0.6), 0.9, (0, 0, 0), 0.0, 10)
    q = [(-8, -0.5, -12), (8, -0.5, -12), (8, 6, -12), (-8, 6, -12)]
    sc.tri(q[0], q[1], q[2])
    sc.tri(q[0], q[2], q[3])


def motion(sc: _Scene):
    sc.accel(ACCEL_NONE, 32)
    sc.camera((0, 2, 8), (0, 0.5, 0), (0, 1, 0), 40, (512, 512))
    sc.background((0.2, 0.3, 0.5))
    sc.point_light((4, 8, 6))
    sc.point_light((-5, 6, 2))
    _floor_mat(sc)
    sc.plane((0, -0.5, 0), (0, -0.5, -1), (1, -0.5, 0))
    sc.mat(sc.rng.uniform(0.3, 1.0, 3), 0.9, (1, 1, 1), 0.2, 30)
    sc.sphere((-1.0, 0.5, 0.0), 0.8)
    sc.mat((0, 0, 0), 0.0, (0.9, 0.85, 0.8), 0.9, 200)
    sc.sphere((1.2, 0.3, 0.8), 0.6)


def teste(sc: _Scene):
    sc.accel(ACCEL_NONE, 16)
    sc.camera((0, 2.5, 8), (0, 0.5, 0), (0, 1, 0), 45, (800, 600))
    sc.background((0.15, 0.2, 0.3))
    sc.point_light((3, 7, 5))
    sc.point_light((-4, 5, 6))
    _floor_mat(sc)
    sc.plane((0, -0.5, 0), (0, -0.5, -1), (1, -0.5, 0))
    sc.mat((0.8, 0.3, 0.2), 0.8, (1, 1, 1), 0.2, 20)
    sc.box((-3.2, -0.5, -1.5), (-2.0, 0.7, -0.3))
    sc.mat((0.3, 0.7, 0.3), 0.9, (0, 0, 0), 0.0, 10)
    sc.tri((-4, -0.5, -4), (4, -0.5, -4), (0, 3.5, -4))
    for i, x in enumerate((-0.8, 1.4)):  # absorbing glass (cd != 1)
        g = sc.rng.uniform(0.6, 1.0, 3)
        sc.mat(g, 0.0, (1, 1, 1), 0.6, 80, 1, 1.5)
        sc.sphere((x, 0.4, 0.6 * i), 0.9 - 0.2 * i)
    for x in (2.8, 0.3):
        sc.mat((0, 0, 0), 0.0, sc.rng.uniform(0.7, 1.0, 3), 0.9, 200)
        sc.sphere((x, 0.1, -1.8), 0.6)


def _diamond(rng, center, size):
    """Closed brilliant cut: 30-gon table (28 faces), crown band to the
    upper girdle (60), girdle band (60), pavilion fan to the culet (30):
    91 vertices, 178 faces, outward winding."""
    n = 30
    ang = np.arange(n) * 2 * np.pi / n + rng.uniform(0, 2 * np.pi / n)
    ring = lambda r, y: np.stack([r * np.cos(ang), np.full(n, y),
                                  r * np.sin(ang)], 1)
    verts = np.concatenate([ring(0.55, 0.45), ring(1.0, 0.1),
                            ring(1.0, 0.0), [[0.0, -1.0, 0.0]]])
    verts = verts * size + np.asarray(center)
    t, u, g, c = 0, n, 2 * n, 3 * n
    faces = [(t, t + i + 1, t + i) for i in range(1, n - 1)]  # table, +y
    for a, b in ((t, u), (u, g)):  # bands
        for i in range(n):
            j = (i + 1) % n
            faces += [(a + i, a + j, b + j), (a + i, b + j, b + i)]
    faces += [(g + i, g + (i + 1) % n, c) for i in range(n)]
    return verts, np.asarray(faces, np.int64)


def blueDiamond(sc: _Scene):
    sc.accel(ACCEL_GRID, 0)
    sc.camera((1.5, 4.5, 7.5), (1.5, 1.3, 1.5), (0, 1, 0), 40, (800, 600))
    sc.background((0.1, 0.1, 0.2))
    sc.skybox()
    sc.point_light((5, 8, 6))
    sc.point_light((-3, 6, 4))
    sc.mat((0.45, 0.65, 1.0), 0.0, (1, 1, 1), 0.5, 120, 1, 2.42)
    sc.mesh(*_diamond(sc.rng, (1.5, 1.5, 1.5), 1.6))


def blob_mesh(rng, n_around: int = 250, n_rings: int = 200):
    """Closed UV-sphere mesh: 2 poles + n_rings x n_around vertices,
    2 x n_rings x n_around triangles, stretched 2:1:1 and displaced
    radially by seeded sinusoids."""
    th = (np.arange(n_rings) + 1) * np.pi / (n_rings + 1)  # polar
    ph = np.arange(n_around) * 2 * np.pi / n_around
    T, P = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(T) * np.cos(P), np.cos(T),
                     np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    dirs = np.concatenate([[[0, 1, 0]], dirs, [[0, -1, 0]]])
    k = rng.normal(size=(8, 3)) * 4.0
    phase = rng.uniform(0, 2 * np.pi, 8)
    amp = rng.uniform(0.02, 0.08, 8)
    r = 1.0 + sum(a * np.sin(dirs @ kk + p) for a, kk, p in
                  zip(amp, k, phase))
    verts = dirs * r[:, None] * np.array([2.0, 1.0, 1.0])
    idx = lambda i, j: 1 + i * n_around + (j % n_around)
    faces = []
    j = np.arange(n_around)
    faces.append(np.stack([np.zeros(n_around, np.int64), idx(0, j + 1),
                           idx(0, j)], 1))
    for i in range(n_rings - 1):
        faces.append(np.stack([idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)],
                              1))
        faces.append(np.stack([idx(i, j), idx(i + 1, j + 1), idx(i + 1, j)],
                              1))
    last = len(dirs) - 1
    faces.append(np.stack([idx(n_rings - 1, j), idx(n_rings - 1, j + 1),
                           np.full(n_around, last)], 1))
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int64)


def _mesh_camera(sc, res):
    sc.camera((0, 2.0, 5.5), (0, 0.0, 0), (0, 1, 0), 45, res)


def _glass_metal(sc: _Scene, accel):
    sc.accel(accel, 0)
    _mesh_camera(sc, (512, 512))
    sc.background((0.15, 0.2, 0.3))
    sc.point_light((4, 8, 6))
    sc.point_light((-5, 6, 4))
    sc.mat((0.9, 0.95, 1.0), 0.0, (1, 1, 1), 0.5, 100, 1, 1.5)
    sc.mesh(*blob_mesh(sc.rng))
    for x, z in ((-3.2, 1.0), (3.2, 1.0), (-2.0, -2.2), (2.0, -2.2)):
        sc.mat((0, 0, 0), 0.0, sc.rng.uniform(0.7, 1.0, 3),
               float(sc.rng.uniform(0.9, 0.95)), 200)
        sc.sphere((x, -0.3, z), 0.7)
    _floor_mat(sc)
    sc.box((-12, -1.3, -12), (12, -1.2, 12))  # a slab: BVH-visible floor


def dragon_assignment1(sc: _Scene):
    _glass_metal(sc, ACCEL_BVH)


def assignment1(sc: _Scene):
    _glass_metal(sc, ACCEL_GRID)


def dragon(sc: _Scene):
    sc.accel(ACCEL_GRID, 0)
    _mesh_camera(sc, (800, 600))
    sc.background((0.15, 0.2, 0.3))
    sc.point_light((4, 8, 6))
    sc.point_light((-5, 6, 4))
    sc.mat((0.7, 0.75, 0.5), 0.9, (0, 0, 0), 0.0, 10)
    sc.mesh(*blob_mesh(sc.rng))


SCENES: Dict[str, Callable[[_Scene], None]] = {
    f.__name__: f for f in (balls_low, balls_high, balls_box, dof, motion,
                            teste, blueDiamond, dragon, dragon_assignment1,
                            assignment1)}


def _record(name: str, seed: int) -> _Scene:
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    sc = _Scene(seed)
    SCENES[name](sc)
    return sc


def pt_scene(scene_id: int, seed: int = 0, cubemap_dir: Optional[str] = None):
    """GLSL scene ``scene_id`` (``scene.pt_scenes``).  Scenes 1-4 miss
    into a cubemap: the one in ``cubemap_dir`` when given, else the one
    generated from ``seed``."""
    from distributionraytracer.scene import pt_scenes
    from distributionraytracer.scene.skybox import load_skybox
    builder = pt_scenes.SCENE_BUILDERS[scene_id]
    if scene_id == 0:
        return builder()
    faces, res = (load_skybox(cubemap_dir) if cubemap_dir
                  else faces_from_u8(cubemap_faces(seed)))
    return builder(faces, res)


def scene_from_spec(spec: str, seed: int = 0) -> SceneData:
    """A P3F path, a deployment name from ``SCENES`` (generated from
    ``seed``), or ``random`` (``scene.procedural``)."""
    if spec.endswith(".p3f") or os.path.exists(spec):
        from distributionraytracer.scene.p3f import load_p3f
        return load_p3f(spec)
    if spec == "random":
        from distributionraytracer.scene.procedural import (
            create_random_scene,
        )
        return create_random_scene(seed=seed)
    return generate(spec, seed)


def generate(name: str, seed: int = 0) -> SceneData:
    """SceneData of deployment ``name`` made from ``seed``."""
    return _record(name, seed).b.build()


def p3f_text(name: str, seed: int = 0) -> str:
    return f"# {name}, generated from seed {seed}\n" + "\n".join(
        _record(name, seed).lines) + "\n"


def write_p3f(name: str, seed: int, directory: str) -> str:
    """Write ``<directory>/<name>.p3f`` (and the skybox faces it names, as
    ``<directory>/skybox/*.png``); returns the file's path."""
    from distributionraytracer.utils.image import encode_png
    sc = _record(name, seed)
    os.makedirs(directory, exist_ok=True)
    if sc.sky_u8 is not None:
        sky = os.path.join(directory, SKY_DIR)
        os.makedirs(sky, exist_ok=True)
        for face, img in zip(FACE_NAMES, sc.sky_u8):
            with open(os.path.join(sky, face + ".png"), "wb") as f:
                f.write(encode_png(img))
    path = os.path.join(directory, name + ".p3f")
    with open(path, "w") as f:
        f.write(f"# {name}, generated from seed {seed}\n"
                + "\n".join(sc.lines) + "\n")
    return path
