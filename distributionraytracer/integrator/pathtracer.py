"""Monte Carlo path tracer with P3D_RT.glsl semantics.

``rayColor`` (P3D_RT.glsl:583-676) becomes a ``lax.scan`` over
``MAX_BOUNCES`` (=10) with masked lanes instead of ``break``:

- ``hit_world``: linear scan over the scene tables with first-wins strict-<
  ordering (quads as two triangles, common.glsl:459-464; negative-radius
  normal flip, common.glsl:545; moving spheres with the shader's quadratic
  in d1 = velocity, common.glsl:551-605);
- emissive add when any component != 0 (P3D_RT.glsl:593-597);
- per-scene direct lighting: point lights cast hard shadow rays
  (P3D_RT.glsl:543-548), quad lights sample a jittered point but cast NO
  shadow ray (P3D_RT.glsl:491-494) — both reference quirks preserved, along
  with the quad version passing ``-viewDir = r.d`` as the GGX view vector
  (P3D_RT.glsl:511 vs 564) and the doubled ``max(N.L, 0)`` factor on the
  diffuse term (P3D_RT.glsl:500+519);
- ``scatter`` per material type (common.glsl:300-407): diffuse scatters
  ``N + randomUnitVector`` *unnormalized* with ``atten = albedo * NdotD``;
  metal terminates when the fuzzed reflection dips below the surface;
  dielectric picks reflect/refract by Schlick probability with the
  ``cos_t if ior1 > ior2`` selection and Beer ``exp(-refractColor * t)``
  when exiting; plastic splits specular/diffuse by scalar Fresnel with 1/p
  weighting;
- Russian roulette on the max throughput channel with 1/p boost
  (P3D_RT.glsl:651-656);
- miss: sky gradient (scene 0) or GL cubemap with SRGBToLinear (x1 or x3,
  P3D_RT.glsl:661-671).

GLSL leaves ``atten`` undefined on some non-writing paths (out-param
semantics); those paths use atten = 1 here, documented deviations.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.config import RenderConfig
from distributionraytracer.ops.common import (
    dot, normalize, safe_normalize, safe_sqrt,
)
from distributionraytracer.ops.cubemap import gl_cubemap_color
from distributionraytracer.scene.pt_scenes import (
    MT_DIELECTRIC, MT_DIFFUSE, MT_METAL, MT_PLASTIC, PTScene,
    SKY_CUBEMAP, SKY_CUBEMAP_X3, SKY_GRADIENT,
)

EPS = 1e-3  # common.glsl:7
PI = 3.14159265358979


class PTHit(NamedTuple):
    hit: jnp.ndarray
    t: jnp.ndarray
    pos: jnp.ndarray
    normal: jnp.ndarray
    mat: jnp.ndarray  # material id


# ----------------------------------------------------------------- hit_world
def hit_world(scene: PTScene, o, d, time, tmin=1e-3, tmax=1e4) -> PTHit:
    """Closest hit over the PT scene tables (first-wins on exact ties in
    table order: triangles, spheres, moving spheres — matching the
    sequential if-chain of P3D_RT.glsl:16-481 for the generated layouts).

    Layout: every per-(primitive, ray) intermediate is an (N, R) plane of
    scalars, and 3-vectors are three separate planes — elementwise work
    that XLA fuses into reductions over the short primitive list, with no
    (R, N, 3) temporaries and no matrix products."""
    R = o.shape[0]
    INF = np.float32(3.4e38)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    # tmax can be a traced scalar (shadow queries); multiply into a host
    # constant so concrete calls never create device arrays during trace
    best_t = tmax * np.ones((R,), np.float32)
    best_n = np.zeros((R, 3), np.float32)
    best_m = np.zeros((R,), np.int32)
    found = np.zeros((R,), bool)

    def cols(a):
        """(N,3) table -> three (N,1) columns (broadcast against (R,))."""
        return a[:, 0][:, None], a[:, 1][:, None], a[:, 2][:, None]

    # --- triangles (hit_triangle, common.glsl:418-447; t in (tmin, rec.t))
    if scene.tri_v0.shape[0]:
        v0x, v0y, v0z = cols(scene.tri_v0)
        e1x, e1y, e1z = cols(scene.tri_e1)
        e2x, e2y, e2z = cols(scene.tri_e2)
        hx = dy * e2z - dz * e2y  # (T,R)
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        nz = a != 0.0
        f = 1.0 / jnp.where(nz, a, 1.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (qx * dx + qy * dy + qz * dz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = nz & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > tmin)
        tm = jnp.where(ok, t, INF)
        # sequential strict-< update in table order == argmin first-wins
        idx = jnp.argmin(tm, axis=0)
        tbest = jnp.min(tm, axis=0)
        better = tbest < best_t
        n = normalize(jnp.cross(scene.tri_e1, scene.tri_e2))[idx]
        best_n = jnp.where(better[:, None], n, best_n)
        best_m = jnp.where(better, scene.tri_mat[idx], best_m)
        best_t = jnp.where(better, tbest, best_t)
        found = found | better

    a_dd = dx * dx + dy * dy + dz * dz  # (R,)

    # --- spheres (hit_sphere, common.glsl:513-549)
    if scene.sph_center.shape[0]:
        cx, cy, cz = cols(scene.sph_center)
        rad2 = (scene.sph_radius ** 2)[:, None]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz  # (S,R)
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad2
        disc = b * b - 4 * a_dd * c
        pos_d = disc > 0
        sq = jnp.where(pos_d, jnp.sqrt(jnp.where(pos_d, disc, 1.0)), 0.0)
        t1 = (-b - sq) / (2 * a_dd)
        t2 = (-b + sq) / (2 * a_dd)
        t = jnp.where(t1 > EPS, t1, t2)
        ok = (disc >= 0) & (t > EPS) & (t > tmin)
        tm = jnp.where(ok, t, INF)
        idx = jnp.argmin(tm, axis=0)
        tbest = jnp.min(tm, axis=0)
        better = tbest < best_t
        cen = scene.sph_center[idx]
        rad = scene.sph_radius[idx]
        p = o + d * tbest[:, None]
        n = safe_normalize(p - cen)
        n = jnp.where((rad < 0)[:, None], -n, n)  # common.glsl:545
        best_n = jnp.where(better[:, None], n, best_n)
        best_m = jnp.where(better, scene.sph_mat[idx], best_m)
        best_t = jnp.where(better, tbest, best_t)
        found = found | better

    # --- moving spheres (hit_movingSphere, common.glsl:551-605)
    if scene.msph_c0.shape[0]:
        # center(t) = c0 + (c1-c0) * (time - 0) / (1 - 0); the GLSL path
        # evaluates d1 = center(time+EPS) - center(time) = (c1-c0) * EPS,
        # which is time-independent — a (M,1) column, not a (M,R) plane
        ax_, ay_, az_ = cols(scene.msph_c0)
        bx_ = scene.msph_c1[:, 0][:, None] - ax_
        by_ = scene.msph_c1[:, 1][:, None] - ay_
        bz_ = scene.msph_c1[:, 2][:, None] - az_
        c0x = ax_ + bx_ * time  # (M,R)
        c0y = ay_ + by_ * time
        c0z = az_ + bz_ * time
        d1x, d1y, d1z = bx_ * EPS, by_ * EPS, bz_ * EPS  # (M,1)
        rad2 = (scene.msph_radius ** 2)[:, None]
        ocx, ocy, ocz = ox - c0x, oy - c0y, oz - c0z
        dd1 = dx * d1x + dy * d1y + dz * d1z  # (M,R)
        a = a_dd - dd1 * dd1
        oc_d = ocx * dx + ocy * dy + ocz * dz
        oc_d1 = ocx * d1x + ocy * d1y + ocz * d1z
        b = 2.0 * (oc_d - oc_d1 * dd1)
        c = ocx * ocx + ocy * ocy + ocz * ocz - oc_d1 * oc_d1 - rad2
        disc = b * b - 4 * a * c
        pos_d = disc > 0
        sq = jnp.where(pos_d, jnp.sqrt(jnp.where(pos_d, disc, 1.0)), 0.0)
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
        t = jnp.where(t1 > EPS, t1, t2)
        outside = t1 > EPS
        ok = (disc >= 0) & (t > EPS) & (t > tmin)
        tm = jnp.where(ok, t, INF)
        idx = jnp.argmin(tm, axis=0)
        tbest = jnp.min(tm, axis=0)
        better = tbest < best_t
        p = o + d * tbest[:, None]
        ar = idx[None, :]
        gat = lambda m: jnp.take_along_axis(m, ar, axis=0)[0]  # (M,R)->(R,)
        out_sel = gat(outside)
        ctr = jnp.stack(
            [jnp.where(out_sel, gat(c0x), gat(c0x + d1x)),
             jnp.where(out_sel, gat(c0y), gat(c0y + d1y)),
             jnp.where(out_sel, gat(c0z), gat(c0z + d1z))], axis=-1)
        n = safe_normalize(p - ctr)
        best_n = jnp.where(better[:, None], n, best_n)
        best_m = jnp.where(better, scene.msph_mat[idx], best_m)
        best_t = jnp.where(better, tbest, best_t)
        found = found | better

    pos = o + d * jnp.where(found, best_t, 1.0)[:, None]
    return PTHit(hit=found, t=best_t, pos=pos, normal=best_n, mat=best_m)


def any_hit(scene: PTScene, o, d, time, tmin, tmax):
    """Occlusion-only hit_world (point-light shadows, P3D_RT.glsl:546).

    Same boolean as ``hit_world(...).hit`` — any primitive with a valid
    ``t`` strictly below ``tmax`` — but skips the winner argmin, normal
    math and material gathers, which are ~40% of a closest-hit query.
    Shadow tests are 3 of the 4 scene queries per bounce in scene 0, so
    this is the cheap path they deserve."""
    R = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    occ = np.zeros((R,), bool)

    def cols(a):
        return a[:, 0][:, None], a[:, 1][:, None], a[:, 2][:, None]

    if scene.tri_v0.shape[0]:
        v0x, v0y, v0z = cols(scene.tri_v0)
        e1x, e1y, e1z = cols(scene.tri_e1)
        e2x, e2y, e2z = cols(scene.tri_e2)
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        nz = a != 0.0
        f = 1.0 / jnp.where(nz, a, 1.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (qx * dx + qy * dy + qz * dz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = (nz & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
              & (t > tmin) & (t < tmax))
        occ = occ | jnp.any(ok, axis=0)

    a_dd = dx * dx + dy * dy + dz * dz

    if scene.sph_center.shape[0]:
        cx, cy, cz = cols(scene.sph_center)
        rad2 = (scene.sph_radius ** 2)[:, None]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad2
        disc = b * b - 4 * a_dd * c
        pos_d = disc > 0
        sq = jnp.where(pos_d, jnp.sqrt(jnp.where(pos_d, disc, 1.0)), 0.0)
        t1 = (-b - sq) / (2 * a_dd)
        t2 = (-b + sq) / (2 * a_dd)
        t = jnp.where(t1 > EPS, t1, t2)
        ok = (disc >= 0) & (t > EPS) & (t > tmin) & (t < tmax)
        occ = occ | jnp.any(ok, axis=0)

    if scene.msph_c0.shape[0]:
        ax_, ay_, az_ = cols(scene.msph_c0)
        bx_ = scene.msph_c1[:, 0][:, None] - ax_
        by_ = scene.msph_c1[:, 1][:, None] - ay_
        bz_ = scene.msph_c1[:, 2][:, None] - az_
        c0x = ax_ + bx_ * time
        c0y = ay_ + by_ * time
        c0z = az_ + bz_ * time
        d1x, d1y, d1z = bx_ * EPS, by_ * EPS, bz_ * EPS
        rad2 = (scene.msph_radius ** 2)[:, None]
        ocx, ocy, ocz = ox - c0x, oy - c0y, oz - c0z
        dd1 = dx * d1x + dy * d1y + dz * d1z
        a = a_dd - dd1 * dd1
        oc_d = ocx * dx + ocy * dy + ocz * dz
        oc_d1 = ocx * d1x + ocy * d1y + ocz * d1z
        b = 2.0 * (oc_d - oc_d1 * dd1)
        c = ocx * ocx + ocy * ocy + ocz * ocz - oc_d1 * oc_d1 - rad2
        disc = b * b - 4 * a * c
        pos_d = disc > 0
        sq = jnp.where(pos_d, jnp.sqrt(jnp.where(pos_d, disc, 1.0)), 0.0)
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
        t = jnp.where(t1 > EPS, t1, t2)
        ok = (disc >= 0) & (t > EPS) & (t > tmin) & (t < tmax)
        occ = occ | jnp.any(ok, axis=0)

    return occ


# ------------------------------------------------------------- GGX (common.glsl:243-298)
def fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * jnp.maximum(1.0 - cos_theta, 0.0) ** 5


def d_ggx(noh, rough):
    alpha2 = (rough * rough) ** 2
    b = noh * noh * (alpha2 - 1.0) + 1.0
    return alpha2 / (PI * b * b + EPS)


def g1_schlick(nov, rough):
    r = 0.25 * rough  # Disney remap (common.glsl:267)
    k = r * r / 2.0
    return jnp.maximum(nov, 0.0) / (nov * (1.0 - k) + k + EPS)


def brdf_ggx(n, v, l, f0, rough):
    h = safe_normalize(l + v)
    nov = jnp.maximum(dot(n, v), 0.0)
    nol = jnp.maximum(dot(n, l), 0.0)
    noh = jnp.maximum(dot(n, h), 0.0)
    cos_t = jnp.maximum(dot(v, h), 0.0)
    D = d_ggx(noh, rough)
    G = g1_schlick(nol, rough) * g1_schlick(nov, rough)
    F = fresnel_schlick(cos_t[..., None], f0)
    return (D * G)[..., None] * F / (4.0 * nov * nol + EPS)[..., None]


def srgb_to_linear(rgb):
    """SRGBToLinear (common.glsl:23-32)."""
    rgb = jnp.clip(rgb, 0.0, 1.0)
    lo = rgb / 12.92
    hi = ((rgb + 0.055) / 1.055) ** 2.4
    return jnp.where(rgb < 0.04045, lo, hi)


# ----------------------------------------------------------- direct lighting
def _mat_gather(scene: PTScene, mid, pos):
    alb = scene.mat_albedo[mid]
    stripe = scene.mat_stripe[mid]
    # striped background shade (P3D_RT.glsl:149)
    shade = jnp.floor(jnp.mod(pos[..., 0], 1.0) * 2.0)
    alb = jnp.where(stripe[..., None], shade[..., None], alb)
    return dict(
        typ=scene.mat_type[mid], albedo=alb, spec=scene.mat_spec[mid],
        emissive=scene.mat_emissive[mid], rough=scene.mat_rough[mid],
        refidx=scene.mat_refidx[mid], refract=scene.mat_refract[mid])


def _direct_common(m, N, light_dir, view_for_ggx, diff_view, light_color):
    """Shared tail of both directlighting variants (P3D_RT.glsl:496-520,
    550-575).  ``view_for_ggx`` is the (possibly sign-quirked) GGX V."""
    ndl = jnp.maximum(dot(N, light_dir), 0.0)
    diff = m["albedo"] * ndl[..., None]
    H = safe_normalize(light_dir + diff_view)
    shin = 8.0 / (m["rough"] ** 4 + EPS) - 2.0
    spec = m["spec"] * (jnp.maximum(dot(N, H), 0.0) ** shin)[..., None]
    ggx = brdf_ggx(N, view_for_ggx, light_dir, m["spec"], m["rough"])
    is_gm = (m["typ"] == MT_METAL) | (m["typ"] == MT_PLASTIC)
    spec = jnp.where(is_gm[..., None], ggx, spec)
    ks = fresnel_schlick(jnp.maximum(dot(N, view_for_ggx), 0.0)[..., None],
                         m["spec"])
    kd_diff = (1.0 - ks) * m["albedo"] / PI
    diff = jnp.where((m["typ"] == MT_PLASTIC)[..., None], kd_diff, diff)
    lit = dot(N, light_dir) > 0.0
    out = (diff + spec) * light_color * ndl[..., None]
    return jnp.where(lit[..., None], out, 0.0)


def direct_point(scene: PTScene, lpos, lcolor, r_d, hit: PTHit, m, time):
    """directlighting(pointLight) with hard shadow (P3D_RT.glsl:525-578)."""
    N = safe_normalize(hit.normal)
    ldir_un = lpos - hit.pos
    dist = jnp.linalg.norm(ldir_un, axis=-1)
    ldir = safe_normalize(ldir_un)
    shadowed = any_hit(scene, hit.pos + N * 1e-3, ldir, time, 1e-3,
                       dist - 1e-3)
    # viewDir = normalize(r.d); GGX gets -viewDir; Blinn H uses -viewDir too
    view = -normalize(r_d)
    out = _direct_common(m, N, ldir, view, view, lcolor)
    return jnp.where(shadowed[..., None], 0.0, out)


def direct_quad(scene: PTScene, j, r_d, hit: PTHit, m, u1, u2):
    """directlighting(quadLight): jittered point, NO shadow ray
    (P3D_RT.glsl:483-523)."""
    N = safe_normalize(hit.normal)
    lpos = (scene.qlight_pos[j] + scene.qlight_e1[j] * u1[..., None]
            + scene.qlight_e2[j] * u2[..., None])
    ldir = safe_normalize(lpos - hit.pos)
    # quirk: viewDir = normalize(-r.d) but BRDF_GGX receives -viewDir
    # (= the raw ray direction, P3D_RT.glsl:503+511); Blinn-H uses +viewDir
    view_blinn = -normalize(r_d)
    view_ggx = -view_blinn
    return _direct_common(m, N, ldir, view_ggx, view_blinn,
                          scene.qlight_color[j])


# ------------------------------------------------------------------- scatter
def _rand_unit_sphere(u3):
    """randomInUnitSphere from 3 uniforms (common.glsl:102-108)."""
    h0 = u3[..., 0] * 2.0 - 1.0
    phi = u3[..., 1] * 6.28318530718
    r = jnp.cbrt(u3[..., 2])
    s = safe_sqrt(1.0 - h0 * h0)
    return r[..., None] * jnp.stack(
        [s * jnp.sin(phi), s * jnp.cos(phi), h0], axis=-1)


def scatter(scene: PTScene, r_o, r_d, hit: PTHit, m, u_choice, u3a, u3b):
    """common.glsl:300-407.  Returns (ok, new_o, new_d, atten).

    ``u_choice``: the branch uniform (dielectric reflect prob / plastic
    fresnel prob); ``u3a``/``u3b``: 3-uniform blocks for direction samples.
    """
    V = -normalize(r_d)
    N = safe_normalize(hit.normal)
    outside = dot(r_d, N) < 0.0
    N = jnp.where(outside[..., None], N, -N)
    typ = m["typ"]

    unit_vec = safe_normalize(_rand_unit_sphere(u3a))
    sph_b = _rand_unit_sphere(u3b)

    # ---- DIFFUSE: dir = N + unit vector, unnormalized (common.glsl:310-312)
    d_dif = N + unit_vec
    o_dif = hit.pos + N * EPS
    a_dif = m["albedo"] * jnp.maximum(dot(N, d_dif), 0.0)[..., None]
    ok_dif = np.ones(r_d.shape[:-1], bool)

    # ---- METAL (common.glsl:314-324)
    refl = r_d - 2.0 * dot(r_d, N)[..., None] * N  # GLSL reflect()
    d_met = safe_normalize(refl + sph_b * m["rough"][..., None])
    ok_met = dot(d_met, N) > 0.0
    o_met = hit.pos + N * EPS
    a_met = m["spec"]

    # ---- DIELECTRIC (common.glsl:325-375)
    ior1 = jnp.where(outside, 1.0, m["refidx"])
    ior2 = jnp.where(outside, m["refidx"], 1.0)
    eta = ior1 / ior2
    Vt = N * dot(N, V)[..., None] - V
    sin_i = jnp.linalg.norm(Vt, axis=-1)
    sin_t = eta * sin_i
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    cos_i = dot(V, N)
    cos_sel = jnp.where(ior1 > ior2, cos_t, cos_i)
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    schlick_p = r0 + (1.0 - r0) * jnp.maximum(1.0 - cos_sel, 0.0) ** 5
    refl_prob = jnp.where(sin_t >= 1.0, 1.0, schlick_p)
    take_refl = u_choice < refl_prob
    d_refl = safe_normalize(refl + sph_b * m["rough"][..., None])
    # GLSL refract(normalize(r_d), N, eta)
    I = normalize(r_d)
    ndi = dot(N, I)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = jnp.where(
        (k >= 0.0)[..., None],
        eta[..., None] * I - (eta * ndi + safe_sqrt(k))[..., None] * N, 0.0)
    d_refr = safe_normalize(refr + sph_b * m["rough"][..., None])
    d_die = jnp.where(take_refl[..., None], d_refl, d_refr)
    o_die = jnp.where(take_refl[..., None],
                      hit.pos + N * EPS, hit.pos - N * EPS)
    beer = jnp.exp(-m["refract"] * jnp.where(hit.hit, hit.t, 0.0)[..., None])
    # atten: 1 on reflect (when dir above surface; undefined otherwise -> 1),
    # Beer when refracting from inside, else 1 (common.glsl:359-373)
    a_die = jnp.where(
        (take_refl | outside)[..., None], jnp.ones_like(beer), beer)
    ok_die = np.ones(r_d.shape[:-1], bool)

    # ---- PLASTIC (common.glsl:376-405)
    light_dir = safe_normalize(r_o - hit.pos)
    Hp = safe_normalize(V + light_dir)
    cos_p = dot(V, Hp)
    f_vec = fresnel_schlick(cos_p[..., None], m["spec"])
    prob = jnp.mean(f_vec, axis=-1)
    take_spec = u_choice < prob
    d_spec = safe_normalize(refl + sph_b * m["rough"][..., None])
    gate = dot(d_spec, N) > 0.0
    a_spec = jnp.where(
        gate[..., None],
        m["spec"] / jnp.maximum(prob, 1e-8)[..., None],
        jnp.ones_like(f_vec))  # undefined in GLSL when gate fails -> 1
    d_dplastic = safe_normalize(N + sph_b)
    a_dplastic = ((1.0 - f_vec) * m["albedo"] / PI
                  / jnp.maximum(1.0 - prob, 1e-8)[..., None])
    d_pla = jnp.where(take_spec[..., None], d_spec, d_dplastic)
    a_pla = jnp.where(take_spec[..., None], a_spec, a_dplastic)
    o_pla = hit.pos + N * EPS
    ok_pla = np.ones(r_d.shape[:-1], bool)

    is_t = lambda t: typ == t
    selv = lambda dif, met, die, pla: jnp.select(
        [is_t(MT_DIFFUSE)[..., None], is_t(MT_METAL)[..., None],
         is_t(MT_DIELECTRIC)[..., None]], [dif, met, die], pla)
    sels = lambda dif, met, die, pla: jnp.select(
        [is_t(MT_DIFFUSE), is_t(MT_METAL), is_t(MT_DIELECTRIC)],
        [dif, met, die], pla)

    new_o = selv(o_dif, o_met, o_die, o_pla)
    new_d = selv(d_dif, d_met, d_die, d_pla)
    atten = selv(a_dif, a_met, a_die, a_pla)
    ok = sels(ok_dif, ok_met, ok_die, ok_pla)
    return ok, new_o, new_d, atten


# ------------------------------------------------------------------ rayColor
def ray_color(scene: PTScene, cfg: RenderConfig, o, d, time, key):
    """Trace a batch of camera rays to radiance (P3D_RT.glsl:583-676)."""
    R = o.shape[0]
    n_pl = scene.plight_pos.shape[0]
    n_ql = scene.qlight_pos.shape[0]

    def body(carry, k):
        # scattered rays are built with the 2-arg createRay -> time = 0
        # (common.glsl:43-46, 310/320/362/368): only camera rays see motion
        o, d, col, thr, alive, t_ray = carry
        ks = jax.random.split(k, 4)
        hit = hit_world(scene, o, d, t_ray)
        m = _mat_gather(scene, hit.mat, hit.pos)

        live_hit = alive & hit.hit
        emis_on = jnp.any(m["emissive"] != 0.0, axis=-1)
        col = col + jnp.where((live_hit & emis_on)[..., None],
                              m["emissive"] * thr, 0.0)

        # direct lighting (per-scene static light lists)
        dl = jnp.zeros_like(col)
        zero_t = jnp.zeros_like(t_ray)  # shadow rays: time = 0
        for j in range(n_pl):
            dl = dl + direct_point(scene, scene.plight_pos[j],
                                   scene.plight_color[j], d, hit, m, zero_t)
        uq = jax.random.uniform(ks[0], (R, 2 * max(n_ql, 1)))
        for j in range(n_ql):
            dl = dl + direct_quad(scene, j, d, hit, m,
                                  uq[:, 2 * j], uq[:, 2 * j + 1])
        col = col + jnp.where(live_hit[..., None], dl * thr, 0.0)

        # scatter
        u_choice = jax.random.uniform(ks[1], (R,))
        u3a = jax.random.uniform(ks[2], (R, 3))
        u3b = jax.random.uniform(ks[3], (R, 3))
        ok, new_o, new_d, atten = scatter(scene, o, d, hit, m,
                                          u_choice, u3a, u3b)
        # no-scatter (metal absorbed): col += thr * emissive, stop
        # (P3D_RT.glsl:641-645)
        col = col + jnp.where((live_hit & ~ok)[..., None],
                              thr * m["emissive"], 0.0)
        thr = jnp.where((live_hit & ok)[..., None], thr * atten, thr)

        # Russian roulette (P3D_RT.glsl:651-656)
        if cfg.russian_roulette:
            p = jnp.max(thr, axis=-1)
            u_rr = jax.random.uniform(jax.random.fold_in(k, 7), (R,))
            killed = u_rr > p
            thr = jnp.where((live_hit & ok & ~killed)[..., None],
                            thr / jnp.maximum(p, 1e-12)[..., None], thr)
        else:
            killed = np.zeros((R,), bool)

        # miss: sky (P3D_RT.glsl:659-672)
        tsky = jnp.clip(0.8 * (d[..., 1] + 1.0), 0.0, 1.0)
        if scene.sky_mode == SKY_GRADIENT:
            sky = ((1.0 - tsky[..., None]) * np.ones(3, np.float32)
                   + tsky[..., None] * np.array([0.5, 0.7, 1.0], np.float32))
        else:
            tex = srgb_to_linear(
                gl_cubemap_color(scene.sky_faces, scene.sky_res, d))
            sky = tex * (3.0 if scene.sky_mode == SKY_CUBEMAP_X3 else 1.0)
        miss = alive & ~hit.hit
        col = col + jnp.where(miss[..., None], thr * sky, 0.0)

        alive = alive & hit.hit & ok & ~killed
        o = jnp.where(alive[..., None], new_o, o)
        d = jnp.where(alive[..., None], new_d, d)
        t_ray = jnp.zeros_like(t_ray)
        return (o, d, col, thr, alive, t_ray), None

    col = np.zeros((R, 3), np.float32)
    thr = np.ones((R, 3), np.float32)
    alive = np.ones((R,), bool)
    keys = jax.random.split(key, cfg.max_bounces)
    (o, d, col, thr, alive, _), _ = jax.lax.scan(
        body, (o, d, col, thr, alive, time), keys)
    return col


def ray_color_tiled(scene: PTScene, cfg: RenderConfig, o, d, time, key):
    """``ray_color`` over fixed-size ray tiles via ``lax.map``.

    Caps live device memory at O(tile × primitives) regardless of frame size — the
    same wavefront-tiling scheme as ``integrator.render.render_from_samples``
    (render.py:187-196).  Each tile gets its own fold-in key; the sample
    stream differs from the untiled path but the estimator is identical."""
    R = o.shape[0]
    tile = min(cfg.pt_tile_rays, R) if cfg.pt_tile_rays else R
    if tile >= R:
        return ray_color(scene, cfg, o, d, time, key)
    pad = (-R) % tile
    if pad:
        padf = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        o, d, time = padf(o), padf(d), padf(time)
    nt = (R + pad) // tile
    keys = jax.random.split(key, nt)
    sh = lambda a: a.reshape((nt, tile) + a.shape[1:])
    cols = jax.lax.map(
        lambda args: ray_color(scene, cfg, *args),
        (sh(o), sh(d), sh(time), keys))
    return cols.reshape(-1, 3)[:R]


@partial(jax.jit, static_argnums=(1, 2, 3), static_argnames=("spp", "fovy"))
def render_pt(scene: PTScene, cfg: RenderConfig, res_x: int, res_y: int,
              key=None, eye=None, at=None, fovy=60.0, spp: int = 1):
    """Full-frame path trace: GLSL camera (common.glsl:125-168), jittered
    pixel samples, ``spp`` samples averaged in linear space."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if eye is None:
        # default shader camera: distance 5 on -z looking at +z
        # (P3D_RT.glsl:712-718 with mouse at origin)
        eye = np.array([0.0, 0.0, -5.0], np.float32)
        at = np.array([0.0, 0.0, 1.0], np.float32) + eye
    up = np.array([0.0, 1.0, 0.0], np.float32)

    # camera basis: all-host math when eye/at are numpy (no device consts)
    import math
    w = np.asarray(eye) - np.asarray(at) if isinstance(eye, np.ndarray) else eye - at
    if isinstance(w, np.ndarray):
        plane_dist = np.linalg.norm(w)
        n = w / plane_dist
        u = np.cross(up, n); u = u / np.linalg.norm(u)
        v = np.cross(n, u)
    else:
        plane_dist = jnp.linalg.norm(w)
        n = w / plane_dist
        u = safe_normalize(jnp.cross(up, n))
        v = jnp.cross(n, u)
    height = 2.0 * plane_dist * math.tan(fovy * math.pi / 180.0 * 0.5)
    width = (res_x / res_y) * height

    k_pix, k_time, k_trace = jax.random.split(key, 3)
    xy = np.stack(
        np.meshgrid(np.arange(res_x, dtype=np.float32),
                    np.arange(res_y, dtype=np.float32), indexing="xy"),
        axis=-1)
    jit = jax.random.uniform(k_pix, (res_y, res_x, spp, 2))
    ps = xy[:, :, None, :] + jit
    px = (ps[..., 0] / res_x - 0.5) * width  # focusDist = 1 (aperture 0)
    py = (ps[..., 1] / res_y - 0.5) * height
    d = (u * px[..., None] + v * py[..., None] - n * plane_dist)
    d = normalize(d)
    o = jnp.zeros_like(d) + eye  # stays traced for np or jnp eye
    time = jax.random.uniform(k_time, (res_y, res_x, spp))  # time0=0, time1=1

    R = res_x * res_y * spp
    col = ray_color_tiled(scene, cfg, o.reshape(R, 3), d.reshape(R, 3),
                          time.reshape(R), k_trace)
    return jnp.mean(col.reshape(res_y, res_x, spp, 3), axis=2)


def to_gamma(c):
    return jnp.clip(c, 0.0, None) ** (1.0 / 2.2)
