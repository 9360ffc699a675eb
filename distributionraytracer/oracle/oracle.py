"""Trusted CPU oracle: a scalar NumPy re-implementation of the reference.

This mirrors ``rayTracing`` (main.cpp:294-521) and ``renderScene``
(main.cpp:525-738) with per-pixel recursion — intentionally *structured like
the C++*, not like the batched wavefront code — so the two implementations fail
independently.  Used only in tests on tiny images.

Random quantities are consumed from an explicit SampleSet-like dict so the
JAX renderer and the oracle see identical numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from distributionraytracer.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, SceneData,
)

EPSILON = 1e-3
OFFSET = 1e-4
FLT_MAX = np.float32(3.402823466e38)


def _norm(v):
    return v / np.linalg.norm(v)


class _Obj:
    __slots__ = ("kind", "params", "mat")

    def __init__(self, kind, params, mat):
        self.kind, self.params, self.mat = kind, params, mat

    def hit(self, o, d, time, motion_blur):
        """Returns (hit, t, normal)."""
        k = self.kind
        if k == "sphere":
            c, r = self.params
            if motion_blur:
                c = c + np.array([0.0, 1.0, 0.0], np.float32) * time
            oc = o - c
            a = float(d @ d)
            b = 2.0 * float(oc @ d)
            cq = float(oc @ oc) - r * r
            disc = b * b - 4 * a * cq
            if disc < 0:
                return False, FLT_MAX, None
            s = math.sqrt(disc)
            t1 = (-b - s) / (2 * a)
            t2 = (-b + s) / (2 * a)
            if t1 > EPSILON:
                t = t1
            elif t2 > EPSILON:
                t = t2
            else:
                return False, FLT_MAX, None
            n = _norm(o + d * t - c)
            return True, t, n
        if k == "triangle":
            v0, e1, e2 = self.params
            h = np.cross(d, e2)
            a = float(e1 @ h)
            f = 1.0 / a if a != 0 else math.inf
            s = o - v0
            u = f * float(s @ h)
            if u < 0.0 or u > 1.0:
                return False, FLT_MAX, None
            q = np.cross(s, e1)
            v = f * float(d @ q)
            if v < 0.0 or u + v > 1.0:
                return False, FLT_MAX, None
            t = f * float(e2 @ q)
            if t > EPSILON:
                return True, t, _norm(np.cross(e1, e2))
            return False, FLT_MAX, None
        if k == "plane":
            pn, pd = self.params
            denom = float(pn @ d)
            if abs(denom) < EPSILON:
                return False, FLT_MAX, None
            t = -(float(pn @ o) + pd) / denom
            if t > 0:
                return True, t, pn
            return False, FLT_MAX, None
        if k == "box":
            bmin, bmax = self.params
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / d
                t0 = (bmin - o) * inv
                t1 = (bmax - o) * inv
            tmin = float(np.max(np.minimum(t0, t1)))
            tmax = float(np.min(np.maximum(t0, t1)))
            if tmin > tmax or tmin <= EPSILON:
                return False, FLT_MAX, None
            p = o + d * tmin
            n = np.zeros(3, np.float32)
            for axis, (lo, hi) in enumerate(zip(bmin, bmax)):
                if abs(p[axis] - lo) < EPSILON:
                    n[axis] = -1.0
                    break
                if abs(p[axis] - hi) < EPSILON:
                    n[axis] = 1.0
                    break
            return True, tmin, n
        raise ValueError(k)


class Oracle:
    def __init__(self, scene: SceneData, max_depth=4, motion_blur=False,
                 shadow_mode="reference"):
        self.s = scene
        st = scene.static
        self.st = st
        self.max_depth = max_depth
        self.motion_blur = motion_blur
        self.shadow_mode = shadow_mode
        g = lambda a: np.asarray(a)
        self.objs = []
        for gid, (typ, ti) in enumerate(zip(st.obj_types, st.obj_tidx)):
            if typ == 0:
                self.objs.append(_Obj("sphere",
                                      (g(scene.sph_center)[ti],
                                       float(g(scene.sph_radius)[ti])),
                                      int(g(scene.sph_mat)[ti])))
            elif typ == 1:
                self.objs.append(_Obj("triangle",
                                      (g(scene.tri_v0)[ti], g(scene.tri_e1)[ti],
                                       g(scene.tri_e2)[ti]),
                                      int(g(scene.tri_mat)[ti])))
            elif typ == 2:
                self.objs.append(_Obj("plane",
                                      (g(scene.pln_n)[ti],
                                       float(g(scene.pln_d)[ti])),
                                      int(g(scene.pln_mat)[ti])))
            else:
                self.objs.append(_Obj("box",
                                      (g(scene.box_min)[ti], g(scene.box_max)[ti]),
                                      int(g(scene.box_mat)[ti])))
        self.lights = []
        for j in range(st.n_lights):
            self.lights.append(dict(
                pos=g(scene.light_pos)[j], color=g(scene.light_color)[j],
                e1=g(scene.light_e1)[j], e2=g(scene.light_e2)[j],
                is_quad=bool(g(scene.light_is_quad)[j]),
                grid_res=int(g(scene.light_grid_res)[j])))
        self.bg = g(scene.bg_color)
        self.sky_faces = g(scene.sky_faces)
        self.sky_res = g(scene.sky_res)

        # grid gates (grid.cpp:100-260): world bbox exactly as Grid::Build
        # pads it, for the Init_Traverse-fail and walk-out-drop semantics
        self.grid_box = None
        if st.accel == ACCEL_GRID and st.n_objects:
            from distributionraytracer.accel.grid import object_bboxes
            bb = object_bboxes(scene)
            self.grid_box = (bb[:, 0].min(0) - EPSILON,
                             bb[:, 1].max(0) + EPSILON)

    def _grid_gate(self, o, d):
        """Slab init on the grid bbox: (ok, exit_t) — grid.cpp:104-171.

        ``ok`` False reproduces Init_Traverse failure (closest: miss,
        grid.cpp:258-260; shadow: counts as occluded, grid.cpp:321-324);
        ``exit_t`` gates closest hits (record dropped when the DDA walks
        out of the grid first, grid.cpp:289-304)."""
        lo, hi = self.grid_box
        with np.errstate(divide="ignore", invalid="ignore"):
            a = 1.0 / d
        tmin = np.where(a >= 0, (lo - o) * a, (hi - o) * a)
        tmax = np.where(a >= 0, (hi - o) * a, (lo - o) * a)
        t0 = float(np.max(tmin))
        t1 = float(np.min(tmax))
        return not (t0 > t1 or t1 < 0), t1

    # ---------------------------------------------------------------- camera
    def camera(self):
        st = self.st
        eye = np.asarray(self.s.cam_eye, np.float64)
        at = np.asarray(self.s.cam_at, np.float64)
        up = np.asarray(self.s.cam_up, np.float64)
        n = eye - at
        plane_dist = np.linalg.norm(n)
        n = n / plane_dist
        u = np.cross(up, n)
        u = u / np.linalg.norm(u)
        v = np.cross(n, u)
        h = 2 * plane_dist * math.tan(math.pi * st.fovy / 180.0 / 2.0)
        w = (st.res_x / st.res_y) * h
        aperture = st.aperture_ratio * (w / st.res_x)
        return dict(eye=eye, u=u, v=v, n=n, w=w, h=h,
                    plane_dist=plane_dist, aperture=aperture,
                    focal=st.focal_ratio)

    def primary_ray(self, cam, px, py, lens=None, time=0.0):
        if lens is None:
            d = (cam["u"] * cam["w"] * (px / self.st.res_x - 0.5)
                 + cam["v"] * cam["h"] * (py / self.st.res_y - 0.5)
                 - cam["n"] * cam["plane_dist"])
            return cam["eye"].astype(np.float32), _norm(d).astype(np.float32), time
        lx, ly = lens
        eye = cam["eye"] + cam["u"] * lx + cam["v"] * ly
        fx = (px / self.st.res_x - 0.5) * cam["w"] * cam["focal"]
        fy = (py / self.st.res_y - 0.5) * cam["h"] * cam["focal"]
        f = cam["plane_dist"] * cam["focal"]
        d = cam["u"] * (fx - lx) + cam["v"] * (fy - ly) - cam["n"] * f
        return eye.astype(np.float32), _norm(d).astype(np.float32), time

    # ---------------------------------------------------------------- trace
    def closest_hit(self, o, d, time):
        gate_t1 = None
        if self.grid_box is not None:
            ok, gate_t1 = self._grid_gate(o, d)
            if not ok:  # Init_Traverse failure = miss (grid.cpp:258-260)
                return None, FLT_MAX, None
        best_t, best_obj, best_n = FLT_MAX, None, None
        for i, obj in enumerate(self.objs):
            ok, t, n = obj.hit(o, d, time, self.motion_blur)
            if ok and t < best_t:
                best_t, best_obj, best_n = t, i, n
        if (best_obj is not None and gate_t1 is not None
                and not best_t < gate_t1):
            # DDA walked out before reaching the hit cell (grid.cpp:289-304)
            return None, FLT_MAX, None
        return best_obj, best_t, best_n

    def in_shadow(self, o, d, max_dist, exclude):
        if self.grid_box is not None:
            ok, _ = self._grid_gate(o, d)
            if not ok:  # failed init counts as shadowed (grid.cpp:321-324)
                return True
        for i, obj in enumerate(self.objs):
            if i == exclude:
                continue
            ok, t, _ = obj.hit(o, d, 0.0, self.motion_blur)
            if ok and t > 1e-4 and t < max_dist:
                return True
        return False

    def skybox_color(self, d):
        x, y, z = float(d[0]), float(d[1]), float(d[2])
        ax, ay, az = abs(x), abs(y), abs(z)
        if ax > ay:
            ma, face = ax, (1 if x >= 0 else 0)  # LEFT else RIGHT
        else:
            ma, face = ay, (2 if y >= 0 else 3)
        if az > ma:
            ma, face = az, (4 if z >= 0 else 5)
        sc = [-z, z, -x, -x, -x, x][face]
        tc = [y, y, -z, z, y, y][face]
        s = (sc / ma + 1) / 2
        t = (tc / ma + 1) / 2
        wi, he = int(self.sky_res[face][0]), int(self.sky_res[face][1])
        xp = min(max(int((wi - 1) * s), 0), wi - 1)
        yp = min(max(int((he - 1) * t), 0), he - 1)
        return self.sky_faces[face, yp, xp]

    def ray_tracing(self, o, d, time, depth, ior1, light_sample):
        st = self.st
        sc = self.s
        hit_i, t, n_geo = self.closest_hit(o, d, time)
        if hit_i is None:
            if st.has_skybox:
                return np.clip(self.skybox_color(d), 0.0, 1.0)
            return np.clip(self.bg, 0.0, 1.0)

        hit_p = o + d * t
        N = _norm(n_geo)
        outside = float(d @ N) < 0.0
        if not outside:
            N = -N
        mat = self.objs[hit_i].mat
        g = lambda a: np.asarray(a)
        cd = g(sc.mat_cd)[mat]
        cs = g(sc.mat_cs)[mat]
        kd = float(g(sc.mat_kd)[mat])
        ks = float(g(sc.mat_ks)[mat])
        kr = float(g(sc.mat_kr)[mat])
        shine = float(g(sc.mat_shine)[mat])
        trans = float(g(sc.mat_T)[mat])
        ior2 = float(g(sc.mat_ior)[mat])
        V = -_norm(d)

        acc = np.zeros(3, np.float32)
        light_pos = np.zeros(3, np.float32)
        for l in self.lights:
            if l["is_quad"]:
                light_pos = (l["pos"] + l["e1"] * light_sample[0]
                             + l["e2"] * light_sample[1])
            else:
                light_pos = l["pos"]
            L_un = light_pos - hit_p
            dist = float(np.linalg.norm(L_un))
            L = L_un / dist
            H = _norm(L + V)
            NdotL = max(float(N @ L), 0.0)
            NdotH = max(float(N @ H), 0.0)
            # shadow ray conventions (main.cpp:411-440)
            if self.shadow_mode == "correct":
                sdir, sdist = L, dist
            elif st.accel == ACCEL_BVH:
                sdir, sdist = L, dist + EPSILON
            else:  # NONE and GRID both end up normalized with len 1.0
                sdir, sdist = L, 1.0
            exclude = hit_i if st.accel == ACCEL_NONE else -1
            if not self.in_shadow(hit_p + N * OFFSET, sdir, sdist, exclude):
                acc = acc + cd * kd * NdotL + cs * ks * (NdotH ** shine)

        if depth > self.max_depth:
            return acc

        # refraction (main.cpp:456-498)
        krf = kr
        if not outside:
            ior2 = 1.0
        eta = ior1 / ior2
        Vt = N * float(V @ N) - V
        sin_i = float(np.linalg.norm(Vt))
        sin_t = eta * sin_i
        if trans == 1.0 and sin_t < 1.0:
            cos_t = math.sqrt(max(1.0 - sin_t * sin_t, 0.0))
            if sin_i > 0:
                t_hat = Vt / sin_i
                r_t = _norm(t_hat * sin_t + (-N) * cos_t)
            else:
                r_t = -N
            cos_i = float(N @ V)
            cos_theta = cos_t if ior1 > ior2 else cos_i
            r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
            krf = r0 + (1 - r0) * (1 - cos_theta) ** 5
            child = np.clip(self.ray_tracing(
                hit_p - N * OFFSET, r_t, 0.0, depth + 1, ior2, light_pos),
                0.0, 1.0)
            if not outside:
                child = child * np.exp((1.0 - cd) * (-t))
            acc = acc + child * (1 - krf)
        elif trans > 0.0 and sin_t >= 1.0:
            krf = 1.0

        # reflection (main.cpp:504-518)
        if ks > 0:
            refl = _norm(N * (2.0 * float(V @ N)) - V)
            child = np.clip(self.ray_tracing(
                hit_p + N * OFFSET, refl, 0.0, depth + 1, ior1, light_pos),
                0.0, 1.0)
            if float(refl @ N) > 0:
                acc = acc + child * krf * cs

        return np.clip(acc, 0.0, 1.0)


def oracle_trace(scene: SceneData, o, d, time, light_sample, max_depth=4,
                 motion_blur=False, shadow_mode="reference"):
    """Trace a flat batch of rays; returns (R,3) float32."""
    orc = Oracle(scene, max_depth, motion_blur, shadow_mode)
    out = np.zeros((len(o), 3), np.float32)
    for i in range(len(o)):
        out[i] = orc.ray_tracing(
            np.asarray(o[i], np.float32), np.asarray(d[i], np.float32),
            float(time[i]), 1, 1.0, np.asarray(light_sample[i], np.float32))
    return out


def oracle_render(scene: SceneData, samples, max_depth=4, motion_blur=False,
                  dof=False, shadow_mode="reference", origin=(0, 0)):
    """Render with explicit samples dict: pixel/light/lens/time (H,W,S,*).

    ``origin`` = (x0, y0) renders the samples as the crop of the scene's
    frame whose lower-left pixel is (x0, y0)."""
    orc = Oracle(scene, max_depth, motion_blur, shadow_mode)
    cam = orc.camera()
    st = scene.static
    pixel = np.asarray(samples.pixel)
    light = np.asarray(samples.light)
    lens = np.asarray(samples.lens)
    tim = np.asarray(samples.time)
    H, W, S = tim.shape
    img = np.zeros((H, W, 3), np.float32)
    for y in range(H):
        for x in range(W):
            c = np.zeros(3, np.float32)
            for p in range(S):
                px = origin[0] + x + pixel[y, x, p, 0]
                py = origin[1] + y + pixel[y, x, p, 1]
                tj = float(tim[y, x, p]) if motion_blur else 0.0
                if dof:
                    l = lens[y, x, p] * cam["aperture"] / 2.0
                    o, d, t = orc.primary_ray(cam, px, py, (l[0], l[1]), tj)
                else:
                    o, d, t = orc.primary_ray(cam, px, py, None, tj)
                ls = light[y, x, p]
                c += orc.ray_tracing(o, d, t, 1, 1.0,
                                     np.array([ls[0], ls[1], 0.0], np.float32))
            img[y, x] = c / S
    return img
