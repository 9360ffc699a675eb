"""Whitted/distribution integrator as a bounded, branchless ray tree.

The reference's ``rayTracing`` (main.cpp:294-521) is a depth-bounded recursion
that spawns at most two children per hit (a refraction ray when ``T == 1``
and no TIR, main.cpp:465-498; a reflection ray when ``ks > 0``,
main.cpp:504-518) and clamps every child's color at the call site.  Because
the clamp is non-linear, contributions cannot be folded top-down into a
throughput product; instead we evaluate the *complete* fixed binary tree:

- node ``i``'s children are ``2i+1`` (refraction) and ``2i+2`` (reflection);
- a top-down pass expands rays level by level (``max_depth + 1`` levels,
  i.e. 31 nodes for the default depth 4), batched over rays x nodes;
- a bottom-up pass combines colors with the exact clamp placement:
  ``clamp(direct + clamp(c_refr) * beer * (1-F) + clamp(c_refl) * F * cs)``.

Dead nodes are masked lanes; XLA sees a static unrolled program with no
data-dependent control flow.  Subtrees that are *statically* dead — no
material with ``T == 1`` means no refraction child can ever spawn, no
material with ``Ks > 0`` means no reflection child — are pruned at trace
time from facts recorded in ``SceneStatic`` (the reference's recursion gets
this for free by simply not recursing; the fixed tree must prune
explicitly).  A refl-only scene thus traces a 5-node chain instead of the
31-node binary tree.

Shading semantics preserved from main.cpp:360-520, notably:

- normal flip when hit from inside (main.cpp:363-364);
- per-light Blinn-Phong ``kd*cd*NdotL + ks*cs*NdotH^shine`` *ignoring the
  light's color* (main.cpp:446-449) — every P3D light is white;
- shadow-ray distance conventions per accel type, including the dangling-else
  quirk that leaves GRID with a normalized direction (main.cpp:411-420), so
  NONE and GRID compare occluder ``t`` against ~1.0 while BVH uses the real
  distance (set ``cfg.shadow_mode='correct'`` to fix);
- refraction only when ``T == 1`` exactly; Schlick cos selection
  (``cos_t`` if ``ior1 > ior2`` else ``cos_i``, main.cpp:477-482); Beer term
  ``exp((1-cd) * (-t))`` applied when exiting a medium (main.cpp:491-494);
- TIR (``T > 0`` and ``sin_t >= 1``) forcing ``F = 1`` (main.cpp:499-501);
- reflection fuzz with roughness hardwired to 0.0 (main.cpp:507-509);
- children rays carry ``time = 0`` (Ray ctor default) — motion blur only
  affects primary rays;
- recursive calls receive the *world-space* position of the last light as
  their ``lightSample`` (main.cpp:489, 512) — a reference quirk we keep.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.config import RenderConfig
from distributionraytracer.ops.common import (
    EPSILON, clamp_color, dot, normalize, safe_div, safe_normalize,
    safe_sqrt,
)
from distributionraytracer.ops.cubemap import skybox_color
from distributionraytracer.ops.intersect import (
    HitResult, any_hit_brute, closest_hit_brute,
)
from distributionraytracer.scene.types import SceneData

OFFSET = 1e-4  # secondary-ray offset (main.cpp:378)


class Intersectors(NamedTuple):
    """Closest-hit / shadow functions for one accel structure.

    ``closest(o, d, time, valid=None) -> HitResult``
    ``shadow(o, d, dist, exclude_obj, valid=None) -> occluded (R,) bool``
    where ``d`` is the direction with the accel's own convention already
    applied.  ``valid`` (bool (R,), optional) marks lanes whose result is
    consumed: traversal-based implementations terminate dead lanes
    immediately, so masked ray-tree nodes cost nothing but their lockstep
    slot (deep Whitted levels are mostly dead lanes).
    """

    closest: Callable
    shadow: Callable


def brute_intersectors(scene: SceneData, cfg: RenderConfig) -> Intersectors:
    """Accel NONE: linear scans (main.cpp:310-336, 432-440) in jnp — the
    differentiable path; XLA fuses the scan over a scene's dozen objects
    into elementwise work."""

    def closest(o, d, time, valid=None):
        return closest_hit_brute(scene, o, d, time, cfg.motion_blur)

    def shadow(o, d, dist, exclude_obj, valid=None):
        time = np.zeros(o.shape[:-1], np.float32)
        return any_hit_brute(scene, o, d, time, dist, exclude_obj,
                             cfg.motion_blur)

    return Intersectors(closest, shadow)


def differentiable_intersectors(scene: SceneData, cfg: RenderConfig,
                                base: Intersectors) -> Intersectors:
    """Make an accel-traversal Intersectors differentiable.

    The grid/BVH traversals are ``lax.while_loop`` programs — not
    reverse-mode differentiable, and their discrete decisions (visit order,
    early exits) carry no useful gradient anyway.  The design
    (SURVEY §7 step 9): run the traversal entirely under ``stop_gradient``
    to select the *winning primitive id*, then recompute that primitive's
    hit (t, normal) differentiably from its parameters — the same formula
    the traversal evaluated, so the forward value is bit-identical, while
    gradients flow into geometry/camera exactly as for the brute-force path.
    Shadow occlusion stays a hard boolean (see RenderConfig.soft_shadow for
    the relaxed-visibility gradient estimator).

    ``base`` must already be built from stop_gradient'ed scene/accel tables
    (see ``parallel.mesh.accel_intersectors(differentiable=True)``).
    """
    from distributionraytracer.ops.intersect import hit_packed

    sg = jax.lax.stop_gradient
    obj_data, obj_types, _ = scene.packed_objects()
    types_present = tuple(sorted(set(scene.static.obj_types)))

    def closest(o, d, time, valid=None):
        h = base.closest(sg(o), sg(d), sg(time), valid=valid)
        gid = jnp.maximum(h.obj_id, 0)
        t, nrm = hit_packed(o, d, time, obj_data[gid], obj_types[gid],
                            cfg.motion_blur, types_present=types_present)
        from distributionraytracer.ops.common import FLT_MAX
        return HitResult(
            hit=h.hit, t=jnp.where(h.hit, t, FLT_MAX),
            normal=jnp.where(h.hit[..., None], nrm, 0.0),
            obj_id=h.obj_id, mat_id=h.mat_id)

    def shadow(o, d, dist, exclude_obj, valid=None):
        return base.shadow(sg(o), sg(d), sg(dist), exclude_obj, valid=valid)

    return Intersectors(closest, shadow)


def _live_partition(valid):
    """Stable-partition permutation putting live lanes first.

    Returns ``(perm, pos)`` with ``sorted[j] = x[perm[j]]`` and
    ``x[i] = sorted[pos[i]]``.  The partition is stable (cumsum-based), so
    live lanes keep their relative — block-permuted, coherent — order.
    Why: a traversal block runs until its slowest live lane is done, and a
    block with zero live lanes exits at once; deep Whitted tree levels are
    mostly dead lanes scattered across blocks, which makes every block pay
    a full walk.  Partitioning concentrates the dead lanes into all-dead
    blocks whose traversal is free, so traversal work scales with *live*
    lanes instead of tree slots.
    """
    livef = valid.astype(jnp.int32)
    nlive = jnp.sum(livef)
    csum = jnp.cumsum(livef)
    pos = jnp.where(valid, csum - 1,
                    nlive + jnp.cumsum(1 - livef) - 1).astype(jnp.int32)
    R = valid.shape[0]
    perm = jnp.zeros((R,), jnp.int32).at[pos].set(
        jnp.arange(R, dtype=jnp.int32))
    return perm, pos


def compacting_intersectors(inter: Intersectors) -> Intersectors:
    """Wrap an Intersectors so every masked query runs live-lanes-first.

    Output-equivalent to ``inter`` (results are gathered back to the
    original lane order; the traversals are lane-order independent).  Worth
    it only for traversal-style implementations whose all-dead blocks cost
    nothing — the Whitted tree's deep levels then cost O(live rays), not
    O(tree slots) (see ``_live_partition``).
    """

    def _static_full(valid):
        # trace-time constant all-live mask (e.g. the primary level):
        # partition would be the identity — skip its gathers
        return isinstance(valid, np.ndarray) and bool(np.all(valid))

    def closest(o, d, time, valid=None):
        if valid is None or _static_full(valid):
            return inter.closest(o, d, time, valid=valid)
        perm, pos = _live_partition(valid)
        g = lambda a: jnp.asarray(a)[perm]  # inputs may be host numpy
        h = inter.closest(g(o), g(d), g(time), valid=g(valid))
        return HitResult(hit=h.hit[pos], t=h.t[pos], normal=h.normal[pos],
                         obj_id=h.obj_id[pos], mat_id=h.mat_id[pos])

    def shadow(o, d, dist, exclude_obj, valid=None):
        if valid is None or _static_full(valid):
            return inter.shadow(o, d, dist, exclude_obj, valid=valid)
        perm, pos = _live_partition(valid)
        g = lambda a: jnp.asarray(a)[perm]  # inputs may be host numpy
        occ = inter.shadow(g(o), g(d), g(dist), g(exclude_obj),
                           valid=g(valid))
        return occ[pos]

    return Intersectors(closest, shadow)


def _shadow_terms(scene, cfg, accel, hit_p, N, light_pos, inter):
    """One light's occlusion test with the reference's per-accel quirks."""
    from distributionraytracer.ops.common import safe_normalize as _sn
    L_un = light_pos - hit_p
    dist_true = jnp.linalg.norm(L_un, axis=-1)
    L = _sn(L_un)

    if cfg.shadow_mode == "correct":
        return L, dist_true
    # reference mode (main.cpp:411-440): BVH uses the unnormalized direction
    # whose length is the true distance; NONE and GRID end up with a
    # normalized direction so their max-dist degenerates to |L| == 1.0 (the
    # dangling-else bug).  Each Intersectors.shadow applies its own occluder
    # comparison (< dist for NONE/GRID, <= dist + EPSILON for BVH,
    # bvh.cpp:376).
    from distributionraytracer.scene.types import ACCEL_BVH
    if accel == ACCEL_BVH:
        return L, dist_true
    return L, jnp.ones_like(dist_true)


def trace_whitted(scene: SceneData, cfg: RenderConfig, o, d, time,
                  light_sample, inter: Optional[Intersectors] = None):
    """Trace a batch of primary rays; returns (color (R,3), stats dict).

    ``light_sample``: (R,3) per-ray sample for quad lights (only .x/.y used),
    exactly the ``lightSample`` argument of ``rayTracing`` (main.cpp:294).
    ``inter`` defaults to the brute-force scans (accel NONE).
    """
    if inter is None:
        inter = brute_intersectors(scene, cfg)
    elif cfg.compact_lanes:
        inter = compacting_intersectors(inter)
    st = scene.static
    R = o.shape[0]

    # Statically-possible child kinds: the reference recursion only spawns a
    # refraction ray when the hit material has T == 1 (main.cpp:465) and a
    # reflection ray when it has Ks > 0 (main.cpp:504).  When no material in
    # the scene can satisfy a condition, that whole subtree of the fixed ray
    # tree is dead — prune it at trace time (bit-identical output, since the
    # per-lane spawn masks are implied by the same facts).
    kinds = tuple(
        k for k, possible in (("refr", st.any_refr), ("refl", st.any_refl))
        if possible or not cfg.static_prune)
    branching = len(kinds)
    levels = (cfg.max_depth + 1) if branching else 1  # depths 1..max_depth+1

    # ---------------- top-down expansion ----------------
    # per-level lists of per-node arrays, shape (R, n_nodes_at_level, ...)
    lvl = []  # dicts
    node_o = o[:, None, :]
    node_d = d[:, None, :]
    node_t = time[:, None]
    node_ior = np.ones((R, 1), np.float32)
    node_ls = light_sample[:, None, :]
    node_valid = np.ones((R, 1), bool)
    rays_traced = np.float32(0.0)
    shadow_rays = np.float32(0.0)

    for level in range(levels):
        depth = level + 1
        n = node_o.shape[1]
        # node-major flattening: lanes run rays-within-node, not
        # nodes-within-ray, so a traversal block holds *same-tree-path*
        # rays from neighboring pixels (block-permuted) instead of a mix of
        # refraction and reflection chains whose node sets diverge.  Pure
        # relabeling: results are gathered back below, winners are
        # lane-local.
        flat = lambda a: jnp.swapaxes(a, 0, 1).reshape(
            (R * n,) + a.shape[2:]) if n > 1 else a.reshape(
            (R,) + a.shape[2:])
        spawn = depth <= cfg.max_depth and branching > 0
        hit: HitResult = inter.closest(
            flat(node_o), flat(node_d), flat(node_t),
            valid=flat(node_valid))
        res = _shade_node(
            scene, cfg, inter,
            flat(node_o), flat(node_d), flat(node_t), flat(node_ior),
            flat(node_ls), flat(node_valid), hit,
            spawn_children=spawn)
        hit_flags = hit.hit
        unflat = lambda a: jnp.swapaxes(
            a.reshape((n, R) + a.shape[1:]), 0, 1)
        lvl.append({k: unflat(v) for k, v in res.items()})
        rays_traced += jnp.sum(flat(node_valid).astype(jnp.float32))
        shadow_rays += st.n_lights * jnp.sum(
            (flat(node_valid) & hit_flags).astype(jnp.float32))

        if depth <= cfg.max_depth and branching:
            cur = lvl[-1]
            # children: interleave the spawned kinds per node -> b*n nodes
            def interleave(arrs):
                if len(arrs) == 1:
                    return arrs[0]
                stacked = jnp.stack(arrs, axis=2)  # (R, n, b, ...)
                return stacked.reshape((R, branching * n) + arrs[0].shape[2:])
            node_o = interleave([cur[k + "_o"] for k in kinds])
            node_d = interleave([cur[k + "_d"] for k in kinds])
            node_ior = interleave([cur[k + "_ior"] for k in kinds])
            node_ls = interleave([cur["child_ls"]] * branching)
            node_valid = interleave([cur[k + "_valid"] for k in kinds])
            node_t = np.zeros((R, branching * n), np.float32)  # children time=0

    # ---------------- bottom-up combine ----------------
    # leaf level: depth > max_depth would return direct unclamped, but the
    # parent clamps at the call site; miss returns clamp(bg).
    child_color = None
    for level in reversed(range(levels)):
        cur = lvl[level]
        direct = cur["direct"]
        if child_color is None:
            color = direct
        else:
            acc = direct
            for ci, k in enumerate(kinds):
                acc = acc + (clamp_color(child_color[:, ci::branching])
                             * cur[k + "_weight"])
            color = clamp_color(acc)
        color = jnp.where(cur["miss"][..., None], cur["miss_color"], color)
        color = jnp.where(cur["valid"][..., None], color, 0.0)
        child_color = color

    return child_color[:, 0], {"rays_traced": rays_traced,
                               "shadow_rays": shadow_rays}


def _shade_node(scene: SceneData, cfg: RenderConfig, inter: Intersectors,
                o, d, time, ior1, light_sample, valid, hit: HitResult,
                spawn_children: bool):
    """Shade one tree level (flattened rays) and emit child specs."""
    st = scene.static
    accel = st.accel
    Rn = o.shape[0]

    ior1 = ior1.reshape(Rn)
    hit_mask = hit.hit & valid
    # miss lanes carry t = FLT_MAX and a zero normal; use safe values so the
    # backward pass through masked-out lanes stays NaN-free
    t_hit = jnp.where(hit.hit, hit.t, 1.0)
    hit_p = o + d * t_hit[..., None]
    N = safe_normalize(hit.normal)
    outside = dot(d, N) < 0.0
    N = jnp.where(outside[..., None], N, -N)
    V = -normalize(d)

    m = hit.mat_id
    M = st.n_materials
    # gate on the one-hot's actual footprint, not just M: at huge
    # Rn x M the (Rn, M) f32 matrix would OOM material-heavy scenes
    # (ADVICE r3); past the cap fall back to gathers
    if 1 <= M <= 64 and Rn * M * 4 <= 128 * 1024 * 1024:
        # Material fetch as one one-hot matmul instead of 8 row gathers.
        # It is linear in the table, so material gradients flow exactly as
        # through the gathers (transpose = the same scatter-add).  Miss
        # lanes (m == -1) read material 0 — every consumer is already gated
        # by hit_mask.
        tab = jnp.concatenate(
            [scene.mat_cd, scene.mat_cs,
             jnp.stack([scene.mat_kd, scene.mat_ks, scene.mat_kr,
                        scene.mat_shine, scene.mat_T, scene.mat_ior],
                       axis=1)], axis=1)  # (M, 12)
        oh = (jnp.maximum(m, 0)[:, None]
              == np.arange(M, dtype=np.int32)).astype(jnp.float32)
        # HIGHEST precision: a reduced-precision float32 matmul (TF32 on a
        # GPU) would round the exact material values the one-hot selects
        # (each output is a single f32 row, no accumulation)
        vals = jnp.matmul(oh, tab, precision=jax.lax.Precision.HIGHEST)
        cd, cs = vals[:, 0:3], vals[:, 3:6]
        kd, ks, kr = vals[:, 6], vals[:, 7], vals[:, 8]
        shine, trans, mat_ior = vals[:, 9], vals[:, 10], vals[:, 11]
    else:
        cd = scene.mat_cd[m]
        cs = scene.mat_cs[m]
        kd = scene.mat_kd[m]
        ks = scene.mat_ks[m]
        kr = scene.mat_kr[m]
        shine = scene.mat_shine[m]
        trans = scene.mat_T[m]
        mat_ior = scene.mat_ior[m]

    # ---------------- direct lighting (main.cpp:383-451) ----------------
    direct = np.zeros((Rn, 3), np.float32)
    last_light_pos = np.zeros((Rn, 3), np.float32)
    pending = []  # deferred (contrib, sdir, sdist) for the batched query
    for j in range(st.n_lights):
        # quad lights sample pos + e1*sx + e2*sy (scene.h:103-106);
        # punctual lights use pos.  Quad-ness is static per scene.
        if st.light_quad[j]:
            light_pos = (scene.light_pos[j]
                         + scene.light_e1[j] * light_sample[..., 0:1]
                         + scene.light_e2[j] * light_sample[..., 1:2])
        else:
            light_pos = jnp.broadcast_to(scene.light_pos[j], (Rn, 3))
            # (light_pos[j] is a traced leaf, so broadcast_to stays traced)
        last_light_pos = light_pos

        L_un = light_pos - hit_p
        Lb = safe_normalize(L_un)
        H = safe_normalize(Lb + V)
        NdotL = jnp.maximum(dot(N, Lb), 0.0)
        NdotH = jnp.maximum(dot(N, H), 0.0)

        # NdotH floor keeps pow's backward (x^s log x) finite at x = 0
        # without changing the forward value (1e-12^shine underflows to 0)
        spec = jnp.power(jnp.maximum(NdotH, 1e-12), shine)
        contrib = (cd * (kd * NdotL)[..., None]
                   + cs * (ks * spec)[..., None])
        if cfg.soft_shadow > 0.0:
            # relaxed visibility: smooth in occluder geometry so shadow-edge
            # gradients exist (see RenderConfig.soft_shadow); brute scan —
            # a training path, not the accel-traversal fidelity path
            from distributionraytracer.ops.intersect import (
                soft_visibility,
            )
            dist_true = jnp.linalg.norm(L_un, axis=-1)
            vis = soft_visibility(
                scene, hit_p + N * OFFSET, Lb,
                np.zeros((Rn,), np.float32),  # shadow rays carry time = 0
                dist_true, hit.obj_id, cfg.soft_shadow, False)
            vis = vis * hit_mask.astype(jnp.float32)
            direct = direct + contrib * vis[..., None]
        else:
            sdir, sdist = _shadow_terms(scene, cfg, accel, hit_p, N,
                                        light_pos, inter)
            pending.append((contrib, sdir, sdist))

    # all lights' occlusion queries in ONE intersector call: on a
    # traversal each call is its own loop (and kernel launch), so an
    # L-light scene would pay L of them per tree level for the same lanes
    if pending:
        sorg = hit_p + N * OFFSET
        if len(pending) == 1:
            occs = [inter.shadow(sorg, pending[0][1], pending[0][2],
                                 hit.obj_id, valid=hit_mask)]
        else:
            L = len(pending)
            occ_all = inter.shadow(
                jnp.tile(sorg, (L, 1)),
                jnp.concatenate([p[1] for p in pending]),
                jnp.concatenate([p[2] for p in pending]),
                jnp.tile(hit.obj_id, (L,)),
                valid=jnp.tile(hit_mask, (L,)))
            occs = list(occ_all.reshape(L, Rn))
        for (contrib, _, _), occluded in zip(pending, occs):
            lit = hit_mask & ~occluded
            direct = direct + jnp.where(lit[..., None], contrib, 0.0)

    # ---------------- miss color (main.cpp:328-357) ----------------
    if st.has_skybox:
        missc = clamp_color(skybox_color(scene.sky_faces, scene.sky_res, d))
    else:
        missc = jnp.broadcast_to(clamp_color(scene.bg_color), (Rn, 3))
        # (bg_color is traced; broadcast_to stays traced)

    out = {
        "direct": direct,
        "miss": valid & ~hit.hit,
        "miss_color": missc,
        "valid": valid,
    }

    # ---------------- children (main.cpp:456-518) ----------------
    ior2 = jnp.where(outside, mat_ior, 1.0)
    eta = ior1 / ior2
    VdotN = dot(V, N)
    Vt = N * VdotN[..., None] - V
    sin_i = jnp.linalg.norm(Vt, axis=-1)
    t_hat = safe_div(Vt, sin_i[..., None])
    sin_t = eta * sin_i
    no_tir = sin_t < 1.0
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    # limit sin_i -> 0: refraction dir -> -N (reference yields NaN there;
    # measure-zero deviation, keeps gradients finite).  Select *before*
    # normalize so dead lanes don't feed 0-vectors into the backward pass.
    refr_num = jnp.where((sin_i > 0.0)[..., None],
                         t_hat * sin_t[..., None] - N * cos_t[..., None], -N)
    refr_dir = safe_normalize(refr_num)

    cos_i = VdotN
    cos_theta = jnp.where(ior1 > ior2, cos_t, cos_i)
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5

    do_refr = hit_mask & (trans == 1.0) & no_tir
    # kr_fresnel: kr by default; Schlick when refracting; 1 on TIR
    krf = jnp.where(do_refr, fresnel,
                    jnp.where(hit_mask & (trans > 0.0) & ~no_tir, 1.0, kr))

    # Beer term exp((1-cd) * (-t)) when exiting a medium (main.cpp:491-494).
    # Miss lanes carry t = FLT_MAX; zero them before the exp or its backward
    # pass emits 0 * inf = NaN into the material gradients.
    t_beer = jnp.where(hit_mask & ~outside, hit.t, 0.0)
    beer = jnp.where(
        outside[..., None], 1.0,
        jnp.exp((1.0 - cd) * (-t_beer[..., None])))

    refl_dir = normalize(N * (2.0 * VdotN)[..., None] - V)
    refl_gate = dot(refl_dir, N) > 0.0
    do_refl = hit_mask & (ks > 0.0) & refl_gate

    if spawn_children:
        out.update({
            "refr_valid": do_refr,
            "refr_o": hit_p - N * OFFSET,
            "refr_d": refr_dir,
            "refr_ior": ior2,
            "refr_weight": jnp.where(
                do_refr[..., None], beer * (1.0 - krf)[..., None], 0.0),
            "refl_valid": do_refl,
            "refl_o": hit_p + N * OFFSET,
            "refl_d": refl_dir,
            "refl_ior": ior1,
            "refl_weight": jnp.where(
                do_refl[..., None], cs * krf[..., None], 0.0),
            # recursion passes the last light's world pos as the sample
            "child_ls": last_light_pos,
        })
    return out


# -------------------------------------------------- soft primary silhouettes
def primary_coverage(scene: SceneData, o, d, time, hit: HitResult,
                     tau: float, motion_blur: bool):
    """Smooth coverage in [0,1] of each ray's winning primitive.

    The counterpart of ops.intersect.soft_visibility for PRIMARY hits
    (SURVEY §7 step 9's other discontinuity): hit-vs-miss of the closest
    primitive is a step in geometry/camera parameters; its silhouette is
    relaxed to a sigmoid of a signed world margin (sphere: r - closest
    approach; triangle: distance to nearest edge; box: slab overlap).
    Planes are silhouette-free; misses return 1.
    """
    from distributionraytracer.ops.intersect import triangle_edge_margin
    from distributionraytracer.scene.types import (
        OBJ_BOX, OBJ_SPHERE, OBJ_TRIANGLE,
    )
    st = scene.static
    R = o.shape[0]
    tidx_np = np.array(st.obj_tidx, np.int64)
    tarr = (tidx_np if len(tidx_np) else np.zeros(1, np.int64)).astype(
        np.int32)
    sub = jnp.take(tarr, jnp.maximum(hit.obj_id, 0))
    types_np = (np.array(st.obj_types, np.int32) if st.n_objects
                else np.zeros(1, np.int32))
    wtype = jnp.take(types_np, jnp.maximum(hit.obj_id, 0))
    alpha = jnp.ones((R,), jnp.float32)

    if st.n_spheres:
        i = jnp.clip(sub, 0, st.n_spheres - 1)
        c = scene.sph_center[i]
        r = scene.sph_radius[i]
        if motion_blur:
            c = c + np.array([0.0, 1.0, 0.0], np.float32) * time[..., None]
        oc = c - o
        proj = dot(oc, d)
        b = jnp.sqrt(jnp.maximum(dot(oc, oc) - proj * proj, 1e-12))
        a_s = jax.nn.sigmoid((jnp.abs(r) - b) / tau)
        alpha = jnp.where(wtype == OBJ_SPHERE, a_s, alpha)
    if st.n_triangles:
        i = jnp.clip(sub, 0, st.n_triangles - 1)
        m, _t = triangle_edge_margin(o, d, scene.tri_v0[i],
                                     scene.tri_e1[i], scene.tri_e2[i])
        alpha = jnp.where(wtype == OBJ_TRIANGLE,
                          jax.nn.sigmoid(m / tau), alpha)
    if st.n_boxes:
        i = jnp.clip(sub, 0, st.n_boxes - 1)
        inv = 1.0 / d
        ta = (scene.box_min[i] - o) * inv
        tb = (scene.box_max[i] - o) * inv
        tmin = jnp.max(jnp.minimum(ta, tb), axis=-1)
        tmax = jnp.min(jnp.maximum(ta, tb), axis=-1)
        alpha = jnp.where(wtype == OBJ_BOX,
                          jax.nn.sigmoid((tmax - tmin) / tau), alpha)
    return jnp.where(hit.hit, alpha, 1.0)


def _near_sphere(scene: SceneData, o, d, time, motion_blur: bool):
    """Per ray: the sphere with the smallest closest-approach distance
    ``b`` among spheres in front of the origin — the silhouette candidate
    for rays that do not already hit a sphere.  Returns None when the
    scene has no spheres."""
    st = scene.static
    if not st.n_spheres:
        return None
    if motion_blur:
        vel = np.array([0.0, 1.0, 0.0], np.float32)
        c = scene.sph_center[None, :, :] + vel * time[:, None, None]
    else:
        c = jnp.broadcast_to(scene.sph_center[None, :, :],
                             (o.shape[0],) + scene.sph_center.shape)
    oc = c - o[:, None, :]
    proj = dot(oc, d[:, None, :])
    b = jnp.sqrt(jnp.maximum(dot(oc, oc) - proj * proj, 1e-12))
    valid = proj > 1e-3
    bm = jnp.where(valid, b, np.float32(3.4e38))
    j = jnp.argmin(bm, axis=1)
    take = lambda m: jnp.take_along_axis(m, j[:, None], axis=1)[:, 0]
    obj_types = np.array(st.obj_types, np.int64)
    sph_gids = np.nonzero(obj_types == 0)[0].astype(np.int32)
    return dict(
        b=take(b), proj=take(proj), has=take(valid),
        center=jnp.take_along_axis(c, j[:, None, None], axis=1)[:, 0],
        radius=scene.sph_radius[j], gid=jnp.take(sph_gids, j),
        mat=scene.sph_mat[j])


def trace_whitted_soft(scene: SceneData, cfg: RenderConfig, o, d, time,
                       light_sample):
    """Silhouette-aware trace: per ray, pick a silhouette *candidate*
    (the winning primitive, or — when the winner is a plane or a miss —
    the nearest in-front sphere), and blend

        c = alpha * c_with + (1 - alpha) * c_without

    where ``alpha`` is the candidate's smooth coverage (primary_coverage /
    the sphere sigmoid), ``c_with`` forces near-miss rays onto the
    candidate sphere (shaded at the closest-approach point, whose limit at
    the edge is the grazing hit), and ``c_without`` excludes the candidate.
    Two-sided: the sigmoid ramp spans both sides of the silhouette, so
    d(pixel)/d(geometry, camera) matches finite differences at
    sphere hit-vs-miss edges (SURVEY §7 step 9's primary-discontinuity
    half; shadow edges are ops.intersect.soft_visibility's job).  Away
    from edges alpha saturates and c reduces to the hard image.

    Training estimator: brute-force (differentiable) path, ~2x a hard
    forward.  Winner-triangle/box silhouettes get the inside half of the
    ramp only (their outside-forcing needs edge sampling — future work);
    candidate selection and exclusion apply to the PRIMARY batch (child
    rays trace the full scene).
    """
    R = o.shape[0]
    h1 = closest_hit_brute(scene, o, d, time, cfg.motion_blur)
    ns = _near_sphere(scene, o, d, time, cfg.motion_blur)
    from distributionraytracer.scene.types import OBJ_PLANE
    types_np = (np.array(scene.static.obj_types, np.int32)
                if scene.static.n_objects else np.zeros(1, np.int32))
    wtype = jnp.take(types_np, jnp.maximum(h1.obj_id, 0))
    winner_solid = h1.hit & (wtype != OBJ_PLANE)

    # candidate: solid winner, else nearest in-front sphere (closer than
    # the winner, so a sphere behind a wall never bleeds through)
    if ns is not None:
        sph_ok = ns["has"] & (ns["proj"] < h1.t) & ~winner_solid
    else:
        sph_ok = np.zeros((R,), bool)
    cand_gid = jnp.where(winner_solid, h1.obj_id,
                         jnp.where(sph_ok, ns["gid"] if ns else -1, -1))
    excl = jax.lax.stop_gradient(cand_gid)

    # alpha: winner coverage on solid winners; sphere sigmoid on forced
    # candidates; 1 where there is no candidate (c_with == c_without there)
    alpha = primary_coverage(scene, o, d, time, h1,
                             cfg.soft_silhouette, cfg.motion_blur)
    if ns is not None:
        a_f = jax.nn.sigmoid((jnp.abs(ns["radius"]) - ns["b"])
                             / cfg.soft_silhouette)
        alpha = jnp.where(sph_ok, a_f, jnp.where(winner_solid, alpha, 1.0))
    else:
        alpha = jnp.where(winner_solid, alpha, 1.0)

    def closest_with(o2, d2, t2, valid=None):
        h = closest_hit_brute(scene, o2, d2, t2, cfg.motion_blur)
        if o2.shape[0] != R or ns is None:
            return h
        f = sph_ok  # force the candidate sphere as a grazing pseudo-hit
        # nudge the pseudo-hit toward the camera: at the exact closest
        # approach the normal is perpendicular to the ray and the shader's
        # inside/outside test dot(d, N) < 0 becomes a float coin flip that
        # discretely flips the shading; EPSILON earlier along the ray the
        # classification is stably "outside" (matching the grazing-hit
        # limit) and the color stays continuous across the silhouette
        t_f = ns["proj"] - EPSILON
        p = o2 + d2 * t_f[:, None]
        n_f = safe_normalize(p - ns["center"])
        return HitResult(
            hit=h.hit | f, t=jnp.where(f, t_f, h.t),
            normal=jnp.where(f[:, None], n_f, h.normal),
            obj_id=jnp.where(f, ns["gid"], h.obj_id),
            mat_id=jnp.where(f, ns["mat"], h.mat_id))

    def shadow_plain(o2, d2, dist, exclude_obj, valid=None):
        t0 = np.zeros(o2.shape[:-1], np.float32)
        return any_hit_brute(scene, o2, d2, t0, dist, exclude_obj,
                             cfg.motion_blur)

    def closest_without(o2, d2, t2, valid=None):
        ex = excl if o2.shape[0] == R else None
        return closest_hit_brute(scene, o2, d2, t2, cfg.motion_blur,
                                 exclude_obj=ex)

    c1, stats = trace_whitted(scene, cfg, o, d, time, light_sample,
                              inter=Intersectors(closest_with, shadow_plain))
    c2, _ = trace_whitted(scene, cfg, o, d, time, light_sample,
                          inter=Intersectors(closest_without, shadow_plain))
    return alpha[:, None] * c1 + (1.0 - alpha[:, None]) * c2, stats
