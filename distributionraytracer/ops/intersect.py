"""Batched, branchless ray-primitive intersection kernels.

The reference dispatches through virtual ``Object::hit`` per ray per object
(scene.cpp:44-278).  Here each primitive type has a masked, vectorized kernel
returning a ``t`` matrix; misses are encoded as ``+FLT_MAX`` so reductions
and ``argmin`` reproduce the reference's strict ``rec.t < hitRec.t``
first-wins scan (main.cpp:315-326).

Semantics preserved exactly:

- sphere (scene.cpp:152-197): nearest positive root with ``t > EPSILON``;
  motion blur moves the center by ``(0,1,0) * ray.time`` (velocity.y is
  hardwired to 1.0, scene.cpp:159-161).
- triangle (scene.cpp:44-92): Moller-Trumbore, no parallel guard (IEEE inf
  handles ``a == 0``), ``t > EPSILON``.
- plane (scene.cpp:118-149): parallel when ``|PN.D| < EPSILON``; ``t > 0``
  (note: not EPSILON).
- aaBox (scene.cpp:218-278): slab test; hit only when ``tmin > EPSILON`` (a
  ray starting inside the box reports no hit, as in the reference); face
  normal selected by EPSILON-comparing the hit point to each face.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from distributionraytracer.ops.common import (
    EPSILON, FLT_MAX, cross, dot, normalize,
)
from distributionraytracer.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)


class HitResult(NamedTuple):
    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) f32 (+FLT_MAX on miss)
    normal: jnp.ndarray  # (R,3) geometric normal of the winner (unflipped)
    obj_id: jnp.ndarray  # (R,) i32 global insertion-order object id (-1 miss)
    mat_id: jnp.ndarray  # (R,) i32


# ---------------------------------------------------------------- spheres
def sphere_t(o, d, time, center, radius, motion_blur: bool):
    """t-matrix for rays (R,3) x spheres (N,3): returns (R,N) f32.

    Misses are +FLT_MAX.
    """
    if motion_blur:
        # per-ray moved center: (R,1,3) = (N,3) + vel*time
        vel = np.array([0.0, 1.0, 0.0], np.float32)
        c = center[None, :, :] + vel * time[:, None, None]  # (R,N,3)
        oc = o[:, None, :] - c
    else:
        oc = o[:, None, :] - center[None, :, :]  # (R,N,3)
    a = dot(d, d)[:, None]  # (R,1)
    b = 2.0 * dot(oc, d[:, None, :])
    cq = dot(oc, oc) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * cq
    # double-where: sqrt's backward at disc <= 0 is inf; a zero cotangent
    # times inf would poison every upstream gradient with NaN
    pos = disc > 0.0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = jnp.where(t1 > EPSILON, t1, t2)
    ok = (disc >= 0.0) & (t > EPSILON)
    return jnp.where(ok, t, FLT_MAX)


def sphere_normal(o, d, t, time, center, radius, motion_blur: bool):
    """Normal for a single winning sphere per ray (gathered params)."""
    if motion_blur:
        vel = np.array([0.0, 1.0, 0.0], np.float32)
        center = center + vel * time[..., None]
    p = o + d * t[..., None]
    return normalize(p - center)


# ---------------------------------------------------------------- triangles
def triangle_t(o, d, v0, e1, e2):
    """Moller-Trumbore t-matrix (R,N); edges precomputed (scene.cpp:58-77)."""
    h = cross(d[:, None, :], e2[None, :, :])  # (R,N,3)
    a = dot(e1[None, :, :], h)  # (R,N)
    # the C++ lets f = 1/0 = inf and relies on the bound checks to reject
    # (scene.cpp:65); that is forward-equivalent to masking a == 0, but the
    # masked form keeps gradients NaN-free
    nz = a != 0.0
    f = 1.0 / jnp.where(nz, a, 1.0)
    s = o[:, None, :] - v0[None, :, :]
    u = f * dot(s, h)
    q = cross(s, e1[None, :, :])
    v = f * dot(q, d[:, None, :])
    t = f * dot(e2[None, :, :], q)
    ok = (nz & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > EPSILON))
    return jnp.where(ok, t, FLT_MAX)


def triangle_normal(e1, e2):
    return normalize(cross(e1, e2))


# ---------------------------------------------------------------- planes
def plane_t(o, d, pn, pd):
    """Plane t-matrix (R,N) (scene.cpp:118-149)."""
    # elementwise products + sums, not matmuls: a float32 matmul may run
    # at reduced precision (TF32 on a GPU), which moves hit points
    denom = dot(d[:, None, :], pn[None, :, :])  # (R,N)
    nz = jnp.abs(denom) >= EPSILON
    t = -(dot(o[:, None, :], pn[None, :, :]) + pd[None, :]) / jnp.where(
        nz, denom, 1.0)
    ok = nz & (t > 0.0)
    return jnp.where(ok, t, FLT_MAX)


# ---------------------------------------------------------------- aa boxes
def box_t(o, d, bmin, bmax):
    """Axis-aligned box slab-test t-matrix (R,N) (scene.cpp:218-258)."""
    inv = 1.0 / d  # (R,3), +-inf for zero components
    t0 = (bmin[None, :, :] - o[:, None, :]) * inv[:, None, :]  # (R,N,3)
    t1 = (bmax[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tmin3 = jnp.minimum(t0, t1)
    tmax3 = jnp.maximum(t0, t1)
    tmin = jnp.max(tmin3, axis=-1)
    tmax = jnp.min(tmax3, axis=-1)
    ok = (tmin <= tmax) & (tmin > EPSILON)
    return jnp.where(ok, tmin, FLT_MAX)


def box_normal(o, d, t, bmin, bmax):
    """Face normal by EPSILON-compare of hit point (scene.cpp:262-274)."""
    p = o + d * t[..., None]
    n = jnp.zeros_like(p)
    # ordered if/else chain; first match wins, default (0,0,0)
    conds = [
        (jnp.abs(p[..., 0] - bmin[..., 0]) < EPSILON, [-1.0, 0.0, 0.0]),
        (jnp.abs(p[..., 0] - bmax[..., 0]) < EPSILON, [1.0, 0.0, 0.0]),
        (jnp.abs(p[..., 1] - bmin[..., 1]) < EPSILON, [0.0, -1.0, 0.0]),
        (jnp.abs(p[..., 1] - bmax[..., 1]) < EPSILON, [0.0, 1.0, 0.0]),
        (jnp.abs(p[..., 2] - bmin[..., 2]) < EPSILON, [0.0, 0.0, -1.0]),
        (jnp.abs(p[..., 2] - bmax[..., 2]) < EPSILON, [0.0, 0.0, 1.0]),
    ]
    taken = np.zeros(p.shape[:-1], bool)
    for c, vec in conds:
        use = c & ~taken
        n = jnp.where(use[..., None], np.asarray(vec, np.float32), n)
        taken = taken | c
    return n


# ---------------------------------------------------------------- combined
def _per_type_best(tmat, global_ids):
    """Reduce a (R,N) t-matrix to per-ray (t, global_obj_id).

    ``argmin`` picks the first minimum, matching the reference's strict-less
    scan in insertion order (per-type indices are globally ordered).
    """
    if tmat.shape[1] == 0:
        R = tmat.shape[0]
        return np.full((R,), FLT_MAX), np.full((R,), -1, np.int32)
    idx = jnp.argmin(tmat, axis=1)
    t = jnp.take_along_axis(tmat, idx[:, None], axis=1)[:, 0]
    gid = jnp.take(global_ids, idx)
    return t, jnp.where(t < FLT_MAX, gid, -1)


def closest_hit_brute(scene: SceneData, o, d, time, motion_blur: bool,
                      exclude_obj=None) -> HitResult:
    """Linear scan over every object, returning the reference's winner.

    Cross-type ties resolve by smallest global object id, matching the
    insertion-order scan of main.cpp:315-326.

    ``exclude_obj`` (optional (R,) i32): per-ray global object id to skip —
    the counterfactual "scene without this pixel's winner" query that the
    soft-silhouette gradient estimator blends against (whitted.
    trace_whitted_soft); -1 skips nothing.
    """
    st = scene.static
    obj_types = np.array(st.obj_types, np.int64)
    gids = {
        t: np.nonzero(obj_types == t)[0].astype(np.int32)
        for t in (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    }

    def excl(tmat, gid):
        if exclude_obj is None or tmat.shape[1] == 0:
            return tmat
        return jnp.where(gid[None, :] == exclude_obj[:, None], FLT_MAX, tmat)

    cands = []  # (t, gid, type)
    t_s = sphere_t(o, d, time, scene.sph_center, scene.sph_radius, motion_blur)
    cands.append(_per_type_best(excl(t_s, gids[OBJ_SPHERE]),
                                gids[OBJ_SPHERE]) + (OBJ_SPHERE,))
    t_t = triangle_t(o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2)
    cands.append(_per_type_best(excl(t_t, gids[OBJ_TRIANGLE]),
                                gids[OBJ_TRIANGLE]) + (OBJ_TRIANGLE,))
    t_p = plane_t(o, d, scene.pln_n, scene.pln_d)
    cands.append(_per_type_best(excl(t_p, gids[OBJ_PLANE]),
                                gids[OBJ_PLANE]) + (OBJ_PLANE,))
    t_b = box_t(o, d, scene.box_min, scene.box_max)
    cands.append(_per_type_best(excl(t_b, gids[OBJ_BOX]),
                                gids[OBJ_BOX]) + (OBJ_BOX,))

    best_t = np.full(o.shape[:-1], FLT_MAX)
    best_gid = np.full(o.shape[:-1], -1, np.int32)
    best_type = np.full(o.shape[:-1], -1, np.int32)
    for t, gid, typ in cands:
        # lexicographic (t, gid): ties across types pick smaller object id
        better = (t < best_t) | ((t == best_t) & (gid >= 0) & ((gid < best_gid) | (best_gid < 0)))
        best_t = jnp.where(better, t, best_t)
        best_gid = jnp.where(better, gid, best_gid)
        best_type = jnp.where(better, typ, best_type)

    hit = best_t < FLT_MAX
    # safe t for normal math: miss lanes would otherwise push inf/NaN into
    # the backward pass through masked-out normals
    t_n = jnp.where(hit, best_t, 1.0)

    # normal + material for the winner only (gather per type, select)
    tidx_np = np.array(st.obj_tidx, np.int64)
    tidx_arr = (tidx_np if len(tidx_np) else np.zeros(1, np.int64)).astype(
        np.int32)
    sub = jnp.take(tidx_arr, jnp.maximum(best_gid, 0))

    normal = jnp.zeros_like(o)
    mat_id = np.zeros(o.shape[:-1], np.int32)

    if st.n_spheres:
        m = best_type == OBJ_SPHERE
        i = jnp.clip(sub, 0, st.n_spheres - 1)
        n_s = sphere_normal(o, d, t_n, time, scene.sph_center[i],
                            scene.sph_radius[i], motion_blur)
        normal = jnp.where(m[..., None], n_s, normal)
        mat_id = jnp.where(m, scene.sph_mat[i], mat_id)
    if st.n_triangles:
        m = best_type == OBJ_TRIANGLE
        i = jnp.clip(sub, 0, st.n_triangles - 1)
        n_t = triangle_normal(scene.tri_e1[i], scene.tri_e2[i])
        normal = jnp.where(m[..., None], n_t, normal)
        mat_id = jnp.where(m, scene.tri_mat[i], mat_id)
    if st.n_planes:
        m = best_type == OBJ_PLANE
        i = jnp.clip(sub, 0, st.n_planes - 1)
        normal = jnp.where(m[..., None], scene.pln_n[i], normal)
        mat_id = jnp.where(m, scene.pln_mat[i], mat_id)
    if st.n_boxes:
        m = best_type == OBJ_BOX
        i = jnp.clip(sub, 0, st.n_boxes - 1)
        n_b = box_normal(o, d, t_n, scene.box_min[i], scene.box_max[i])
        normal = jnp.where(m[..., None], n_b, normal)
        mat_id = jnp.where(m, scene.box_mat[i], mat_id)

    return HitResult(hit=hit, t=best_t, normal=normal,
                     obj_id=jnp.where(hit, best_gid, -1), mat_id=mat_id)


def any_hit_brute(scene: SceneData, o, d, time, max_dist, exclude_obj,
                  motion_blur: bool):
    """Occlusion test for the NONE-accel shadow path (main.cpp:432-440).

    True where any object other than ``exclude_obj`` hits with
    ``offset < t < max_dist``.  (The per-type kernels already enforce their
    own near thresholds; the reference adds ``t > 1e-4`` which is weaker.)
    """
    st = scene.static
    obj_types = np.array(st.obj_types, np.int64)

    occluded = np.zeros(o.shape[:-1], bool)

    def fold(tmat, type_const):
        nonlocal occluded
        if tmat.shape[1] == 0:
            return
        gid = np.nonzero(obj_types == type_const)[0].astype(np.int32)
        ok = (tmat < max_dist[:, None]) & (tmat > 1e-4)
        ok &= gid[None, :] != exclude_obj[:, None]
        occluded |= jnp.any(ok, axis=1)

    fold(sphere_t(o, d, time, scene.sph_center, scene.sph_radius, motion_blur),
         OBJ_SPHERE)
    fold(triangle_t(o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2),
         OBJ_TRIANGLE)
    fold(plane_t(o, d, scene.pln_n, scene.pln_d), OBJ_PLANE)
    fold(box_t(o, d, scene.box_min, scene.box_max), OBJ_BOX)
    return occluded


def soft_visibility(scene: SceneData, o, d, time, max_dist, exclude_obj,
                    tau: float, motion_blur: bool):
    """Smooth shadow visibility in [0,1] — the discontinuity-aware gradient
    estimator (SURVEY §7 step 9).

    Hard occlusion ``prod_i 1[ray misses i]`` is a step function of the
    occluders' parameters: its *expected* derivative at a shadow edge is a
    boundary term that pointwise autodiff through ``where``-selects never
    produces (the reference's shadow gating, main.cpp:383-451, has the same
    discontinuity — it just never differentiates).  Relaxation: replace
    each occluder's indicator with a sigmoid of a *signed world-space
    margin* that is smooth in all parameters and crosses zero exactly at
    the silhouette — exact in the tau -> 0 limit, and the sigmoid's width
    transfers the shadow boundary's Dirac into a finite ramp autodiff sees:

    - sphere: margin = r − b, with b the ray↔center closest-approach
      distance;
    - triangle: margin = min over the three edges of (barycentric
      coordinate × its triangle height) at the ray↔plane intersection —
      the world distance from the hit point to the nearest edge, negative
      outside;
    - box: margin = (t_exit − t_enter) of the slab test, negative on a
      miss (t-units — proportional to world distance for the near-graze
      directions that matter);
    - plane: no silhouette — kept hard.

    Uses *correct* shadow semantics (normalized direction, true light
    distance) regardless of ``shadow_mode`` — this is a training estimator,
    not a reference-fidelity path.
    """
    import jax

    st = scene.static
    obj_types = np.array(st.obj_types, np.int64)
    R = o.shape[0]
    vis = jnp.ones(R, jnp.float32)

    center, radius = scene.sph_center, scene.sph_radius
    if center.shape[0]:
        if motion_blur:
            vel = np.array([0.0, 1.0, 0.0], np.float32)
            c = center[None, :, :] + vel * time[:, None, None]
            oc = c - o[:, None, :]
        else:
            oc = center[None, :, :] - o[:, None, :]  # (R,N,3)
        proj = dot(oc, d[:, None, :])
        b2 = dot(oc, oc) - proj * proj
        b = jnp.sqrt(jnp.maximum(b2, 1e-12))
        gate = (proj > 1e-4) & (proj < max_dist[:, None])
        gid = np.nonzero(obj_types == OBJ_SPHERE)[0].astype(np.int32)
        gate &= gid[None, :] != exclude_obj[:, None]
        occ = jax.nn.sigmoid((radius[None, :] - b) / tau)
        vis = vis * jnp.prod(1.0 - jnp.where(gate, occ, 0.0), axis=1)

    def fold_soft(margin, tmat, type_const):
        """Fold smooth occlusion sigmoid(margin/tau) gated on the (smooth
        enough) ray-parameter window into ``vis``."""
        nonlocal vis
        gid = np.nonzero(obj_types == type_const)[0].astype(np.int32)
        gate = (tmat < max_dist[:, None]) & (tmat > 1e-4)
        gate &= gid[None, :] != exclude_obj[:, None]
        occ = jax.nn.sigmoid(margin / tau)
        vis = vis * jnp.prod(1.0 - jnp.where(gate, occ, 0.0), axis=1)

    # --- triangles: signed world distance to the nearest edge at the
    # ray/plane intersection (smooth in vertices, origin and direction)
    if scene.tri_v0.shape[0]:
        v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
        n = jnp.cross(e1, e2)  # (T,3), length = 2*area
        denom = dot(d[:, None, :], n[None, :, :])
        safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
        tpl = dot(n[None, :, :], v0[None] - o[:, None, :]) / safe
        p = o[:, None, :] + d[:, None, :] * tpl[..., None]  # (R,T,3)
        rel = p - v0[None]
        # barycentrics from the 2x2 metric (u along e1, v along e2)
        d11 = dot(e1, e1)[None]
        d22 = dot(e2, e2)[None]
        d12 = dot(e1, e2)[None]
        r1 = dot(rel, e1[None, :, :])
        r2 = dot(rel, e2[None, :, :])
        det = jnp.maximum(d11 * d22 - d12 * d12, 1e-20)
        u = (d22 * r1 - d12 * r2) / det
        v = (d11 * r2 - d12 * r1) / det
        w = 1.0 - u - v
        area2 = jnp.linalg.norm(n, axis=-1)[None]  # 2*area
        h_u = area2 / jnp.maximum(jnp.linalg.norm(e2, axis=-1), 1e-12)[None]
        h_v = area2 / jnp.maximum(jnp.linalg.norm(e1, axis=-1), 1e-12)[None]
        h_w = area2 / jnp.maximum(
            jnp.linalg.norm(e2 - e1, axis=-1), 1e-12)[None]
        margin = jnp.minimum(jnp.minimum(u * h_u, v * h_v), w * h_w)
        fold_soft(margin, jnp.where(jnp.abs(denom) > 1e-12, tpl, FLT_MAX),
                  OBJ_TRIANGLE)

    # --- boxes: slab overlap t_exit - t_enter, negative on a miss
    if scene.box_min.shape[0]:
        bmin, bmax = scene.box_min, scene.box_max
        inv = 1.0 / d  # (R,3); +-inf on zeros as in the hard path
        ta = (bmin[None] - o[:, None, :]) * inv[:, None, :]
        tb = (bmax[None] - o[:, None, :]) * inv[:, None, :]
        tmin = jnp.max(jnp.minimum(ta, tb), axis=-1)
        tmax = jnp.min(jnp.maximum(ta, tb), axis=-1)
        fold_soft(tmax - tmin, tmin, OBJ_BOX)

    # --- planes: infinite, no silhouette -> hard occlusion
    tmat = plane_t(o, d, scene.pln_n, scene.pln_d)
    if tmat.shape[1]:
        gid = np.nonzero(obj_types == OBJ_PLANE)[0].astype(np.int32)
        ok = (tmat < max_dist[:, None]) & (tmat > 1e-4)
        ok &= gid[None, :] != exclude_obj[:, None]
        vis = vis * (1.0 - jnp.any(ok, axis=1).astype(jnp.float32))
    return vis


# ------------------------------------------------------- packed-row kernels
def _d3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _x3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _unit3(a, div):
    n = jnp.sqrt(_d3(a, a))
    return (div(a[0], n), div(a[1], n), div(a[2], n))


def hit_packed_cols(o, d, time, cols, typ, motion_blur: bool,
                    types_present=(OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE,
                                   OBJ_BOX),
                    normals: bool = True, div=None):
    """Intersect rays with one packed primitive row, component-wise.

    ``o``/``d`` are 3-tuples of (...,) arrays, ``cols`` the 12 packed
    parameter columns (``SceneData.packed_objects`` layout) and ``typ`` the
    (...,) type tag (unused when one type is present).  Returns ``t``
    (+FLT_MAX on miss) and, when ``normals``, the winner-style normal
    3-tuple (else None).  Written on scalar columns so the same expression
    graph serves the XLA traversals (``hit_packed``) and the Triton BVH
    kernel (``accel.bvh_kernel``), whose blocks hold one ray per lane;
    ``div`` overrides float division there (correctly rounded PTX).
    """
    if div is None:
        div = lambda a, b: a / b
    cand = {}  # type -> (t_masked, normal or None)

    if OBJ_SPHERE in types_present:
        cx, cy, cz, radius = cols[0], cols[1], cols[2], cols[3]
        if motion_blur:
            cy = cy + time  # velocity (0, 1, 0) (scene.cpp:159-161)
        c = (cx, cy, cz)
        oc = (o[0] - cx, o[1] - cy, o[2] - cz)
        a = _d3(d, d)
        b = 2.0 * _d3(oc, d)
        cq = _d3(oc, oc) - radius * radius
        disc = b * b - 4 * a * cq
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t1 = div(-b - sq, 2 * a)
        t2 = div(-b + sq, 2 * a)
        t_s = jnp.where(t1 > EPSILON, t1, t2)
        ok_s = (disc >= 0) & (t_s > EPSILON)
        n_s = None
        if normals:
            n_s = _unit3(tuple(o[k] + d[k] * t_s - c[k] for k in range(3)),
                         div)
        cand[OBJ_SPHERE] = (jnp.where(ok_s, t_s, FLT_MAX), n_s)

    if OBJ_TRIANGLE in types_present:
        v0, e1, e2 = cols[0:3], cols[3:6], cols[6:9]
        h = _x3(d, e2)
        f = div(1.0, _d3(e1, h))
        s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        u = f * _d3(s, h)
        q = _x3(s, e1)
        v = f * _d3(d, q)
        t_t = f * _d3(e2, q)
        ok_t = (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t_t > EPSILON)
        cand[OBJ_TRIANGLE] = (jnp.where(ok_t, t_t, FLT_MAX),
                              _unit3(_x3(e1, e2), div) if normals else None)

    if OBJ_PLANE in types_present:
        pn, pd = cols[0:3], cols[3]
        denom = _d3(d, pn)
        t_p = div(-(_d3(o, pn) + pd), denom)
        ok_p = (jnp.abs(denom) >= EPSILON) & (t_p > 0.0)
        cand[OBJ_PLANE] = (jnp.where(ok_p, t_p, FLT_MAX),
                           tuple(pn) if normals else None)

    if OBJ_BOX in types_present:
        bmin, bmax = cols[0:3], cols[3:6]
        inv = [div(1.0, d[k]) for k in range(3)]
        ta = [(bmin[k] - o[k]) * inv[k] for k in range(3)]
        tb = [(bmax[k] - o[k]) * inv[k] for k in range(3)]
        lo = [jnp.minimum(ta[k], tb[k]) for k in range(3)]
        hi = [jnp.maximum(ta[k], tb[k]) for k in range(3)]
        tmin = jnp.maximum(jnp.maximum(lo[0], lo[1]), lo[2])
        tmax = jnp.minimum(jnp.minimum(hi[0], hi[1]), hi[2])
        ok_b = (tmin <= tmax) & (tmin > EPSILON)
        n_b = None
        if normals:
            p = [o[k] + d[k] * tmin for k in range(3)]
            # ordered if/else chain of box_normal; first match wins
            zero = jnp.zeros_like(tmin)
            n_b = [zero, zero, zero]
            taken = jnp.zeros(tmin.shape, bool)
            for k in range(3):
                for face, sign in ((bmin, -1.0), (bmax, 1.0)):
                    use = (jnp.abs(p[k] - face[k]) < EPSILON) & ~taken
                    n_b[k] = jnp.where(use, sign, n_b[k])
                    taken = taken | use
            n_b = tuple(n_b)
        cand[OBJ_BOX] = (jnp.where(ok_b, tmin, FLT_MAX), n_b)

    tags = [k for k in types_present if k in cand]
    if len(tags) == 1:
        return cand[tags[0]]
    def sel(vals):  # first matching tag wins, as jnp.select
        out = vals[-1]
        for k, v in zip(reversed(tags[:-1]), reversed(vals[:-1])):
            out = jnp.where(typ == k, v, out)
        return out
    t = sel([cand[k][0] for k in tags])
    if not normals:
        return t, None
    n = tuple(sel([cand[k][1][j] for k in tags]) for j in range(3))
    return t, n


def hit_packed(o, d, time, row, typ, motion_blur: bool,
               types_present=(OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)):
    """Intersect each ray with one packed primitive row (for accel leaves).

    ``row``: (..., 12) packed params, ``typ``: (...,) int32 type tag.
    Returns (t, normal) with t=+FLT_MAX on miss.  Computes the candidate
    formulas for every type in ``types_present`` (a static, scene-derived
    set — a mesh scene only pays for triangles + planes) and selects by
    tag (``hit_packed_cols`` on the split components).
    """
    split = lambda a: (a[..., 0], a[..., 1], a[..., 2])
    cols = [row[..., k] for k in range(12)]
    t, n = hit_packed_cols(split(o), split(d), time, cols, typ, motion_blur,
                           types_present)
    return t, jnp.stack(n, axis=-1)


# ---------------------------------------------------------------- AABB slab
def aabb_entry_t(o, d, bmin, bmax):
    """AABB::hit semantics (boundingBox.cpp:64-124).

    Returns (hit, t) with t = largest entry (or exit when origin inside:
    ``t = t1 if t0 < 0``).
    """
    inv = 1.0 / d
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    t0 = jnp.max(jnp.minimum(ta, tb), axis=-1)
    t1 = jnp.min(jnp.maximum(ta, tb), axis=-1)
    t = jnp.where(t0 < 0, t1, t0)
    return (t0 < t1) & (t1 > 0), t


def triangle_edge_margin(o, d, v0, e1, e2):
    """Signed world distance from the ray/plane intersection point to the
    nearest edge of a per-ray triangle (positive inside, negative outside).

    Inputs are (R,3) — one triangle per ray (gathered winner params).
    Smooth in all inputs away from degenerate triangles; the zero crossing
    is exactly the triangle silhouette as seen along the ray.  Returns
    (margin (R,), t (R,)) with ``t`` the ray/plane parameter.
    """
    n = jnp.cross(e1, e2)  # length = 2*area
    denom = dot(d, n)
    safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    t = dot(n, v0 - o) / safe
    p = o + d * t[..., None]
    rel = p - v0
    d11, d22, d12 = dot(e1, e1), dot(e2, e2), dot(e1, e2)
    r1, r2 = dot(rel, e1), dot(rel, e2)
    det = jnp.maximum(d11 * d22 - d12 * d12, 1e-20)
    u = (d22 * r1 - d12 * r2) / det
    v = (d11 * r2 - d12 * r1) / det
    w = 1.0 - u - v
    a2 = jnp.linalg.norm(n, axis=-1)
    h_u = a2 / jnp.maximum(jnp.linalg.norm(e2, axis=-1), 1e-12)
    h_v = a2 / jnp.maximum(jnp.linalg.norm(e1, axis=-1), 1e-12)
    h_w = a2 / jnp.maximum(jnp.linalg.norm(e2 - e1, axis=-1), 1e-12)
    margin = jnp.minimum(jnp.minimum(u * h_u, v * h_v), w * h_w)
    return margin, t
