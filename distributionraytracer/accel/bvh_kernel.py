"""Per-ray threaded-BVH walk as a Pallas kernel on the Triton route.

The batched XLA traversal (``accel.bvh.make_threaded_intersectors``) is one
``lax.while_loop`` over the whole wavefront: every iteration gathers for
every lane until the slowest lane of the frame is done.  Here one program
owns a block of ``BLOCK`` rays, one lane per ray.  Each lane keeps its
node index, leaf cursor and best hit in registers and walks the same
stackless tables (DFS order with skip links, ``accel.bvh.thread_bvh``):
per step it either tests its node's AABB (descend to ``node + 1`` or jump
to ``skip``) or tests one object of its leaf.  Node and object rows are
fetched with masked gathers, so finished and idle lanes move no bytes.
A block's loop runs until its own slowest lane is done; any-hit lanes stop
at their first occluder.  The tables (a 100k-triangle mesh and its nodes
take about 10 MB) stay in the GPU's L2.

The step is the XLA traversal's step, with the same primitive math
(``ops.intersect.hit_packed_cols``) and the same visit order, so winners
match it exactly; float division uses correctly rounded PTX
(``div.rn.f32``) so both round alike.  ``interpret=True`` runs the kernel
on the CPU; tests pass it, renders never do (``routing``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from distributionraytracer.accel.bvh import ThreadedBVH
from distributionraytracer.ops.common import EPSILON, FLT_MAX
from distributionraytracer.ops.intersect import HitResult, hit_packed_cols
from distributionraytracer.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)

BLOCK = 64  # rays per program, one per lane
NUM_WARPS = 2

# packed parameter columns each primitive type reads (packed_objects layout)
_TYPE_COLS = {OBJ_SPHERE: 4, OBJ_TRIANGLE: 9, OBJ_PLANE: 4, OBJ_BOX: 6}


def _div_rn(a, b):
    """IEEE round-to-nearest f32 division (Triton's own ``/`` is 2 ulp)."""
    a = jnp.broadcast_to(a, b.shape).astype(jnp.float32)
    return plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(b.shape,
                                                          jnp.float32)])[0]


def _walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tm_ref,
                 dist_ref, start_ref, nbox_ref, nmeta_ref, orow_ref,
                 oint_ref, *out_refs, shadow, motion_blur, types_present,
                 n_cols, max_iters, interpret):
    N = nbox_ref.shape[0]
    S = orow_ref.shape[0]
    div = None if interpret else _div_rn
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    tm = tm_ref[...]
    dist = dist_ref[...]
    inv = tuple((1.0 / c) if interpret else _div_rn(1.0, c) for c in d)
    multi = len(types_present) > 1

    def row(ref, idx, cols, mask):
        zero = 0 if jnp.issubdtype(ref.dtype, jnp.integer) else 0.0
        return [plgpu.load(ref.at[idx, c], mask=mask, other=zero)
                for c in cols]

    def obj_t(slot, mask, normals):
        cols = row(orow_ref, slot, range(n_cols), mask)
        cols += [None] * (12 - n_cols)
        typ = row(oint_ref, slot, [0], mask)[0] if multi else None
        return hit_packed_cols(o, d, tm, cols, typ, motion_blur,
                               types_present, normals=normals, div=div)

    def cond(s):
        node, it = s[0], s[-1]
        return (jnp.max(jnp.where(node < N, 1, 0)) > 0) & (it < max_iters)

    def body(s):
        node, objk, best_t, best_slot, occ, it = s
        active = node < N
        nd = jnp.minimum(node, N - 1)
        in_leaf = objk >= 0
        skip, first, nobj, leaf = row(nmeta_ref, nd, range(4), active)

        # leaf-object step (lanes with a cursor)
        lmask = active & in_leaf
        slot = jnp.clip(first + objk, 0, S - 1)
        t, _ = obj_t(slot, lmask, normals=False)
        better = lmask & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_slot = jnp.where(better, slot, best_slot)
        if shadow:
            occ = jnp.where(lmask & (t <= dist + EPSILON), 1, occ)
        k2 = objk + 1
        leaf_done = k2 >= nobj
        node_l = jnp.where(leaf_done, skip, node)
        objk_l = jnp.where(leaf_done, -1, k2)

        # node step (lanes without a cursor): AABB::hit entry-t semantics
        nmask = active & ~in_leaf
        box = row(nbox_ref, nd, range(6), nmask)
        lo, hi = box[0:3], box[3:6]
        tmin = [jnp.where(inv[k] >= 0, (lo[k] - o[k]) * inv[k],
                          (hi[k] - o[k]) * inv[k]) for k in range(3)]
        tmax = [jnp.where(inv[k] >= 0, (hi[k] - o[k]) * inv[k],
                          (lo[k] - o[k]) * inv[k]) for k in range(3)]
        t0 = jnp.maximum(jnp.maximum(tmin[0], tmin[1]), tmin[2])
        t1 = jnp.minimum(jnp.minimum(tmax[0], tmax[1]), tmax[2])
        tent = jnp.where(t0 < 0, t1, t0)
        inside = ((o[0] > lo[0]) & (o[0] < hi[0]) & (o[1] > lo[1])
                  & (o[1] < hi[1]) & (o[2] > lo[2]) & (o[2] < hi[2]))
        tent = jnp.where(inside, 0.0, tent)
        visit = (t0 < t1) & (t1 > 0)
        if not shadow:
            visit = visit & (tent < best_t)  # pruned pops, bvh.cpp:300-308
        is_leaf = leaf != 0
        enter_leaf = visit & is_leaf & (nobj > 0)
        node_n = jnp.where(visit & ~is_leaf, node + 1,
                           jnp.where(enter_leaf, node, skip))
        objk_n = jnp.where(enter_leaf, 0, -1)

        new_node = jnp.where(in_leaf, node_l, node_n)
        new_objk = jnp.where(in_leaf, objk_l, objk_n)
        if shadow:  # stop at the first occluder (bvh.cpp:381-387)
            new_node = jnp.where(occ != 0, N, new_node)
            new_objk = jnp.where(occ != 0, -1, new_objk)
        new_node = jnp.where(active, new_node, node)
        return new_node, new_objk, best_t, best_slot, occ, it + 1

    start = start_ref[...]
    init = (start, jnp.full_like(start, -1),
            jnp.full(start.shape, FLT_MAX, jnp.float32),
            jnp.full_like(start, -1), jnp.zeros_like(start),
            jnp.int32(0))
    _, _, best_t, best_slot, occ, _ = jax.lax.while_loop(cond, body, init)

    if shadow:
        out_refs[0][...] = occ
        return
    t_ref, gid_ref, nx_ref, ny_ref, nz_ref = out_refs
    hit = best_slot >= 0
    win = jnp.maximum(best_slot, 0)
    _, nrm = obj_t(win, hit, normals=True)
    t_ref[...] = jnp.where(hit, best_t, FLT_MAX)
    gid_ref[...] = jnp.where(hit, row(oint_ref, win, [2], hit)[0], -1)
    for ref, n in zip((nx_ref, ny_ref, nz_ref), nrm):
        ref[...] = jnp.where(hit, n, 0.0)


def kernel_tables(scene: SceneData, tb: ThreadedBVH):
    """Device tables the kernel gathers from: node boxes (N, 8) f32, node
    meta (N, 4) i32 [skip, first, n_objs, is_leaf], object parameter rows
    in leaf order (S, 12) f32 and object ints (S, 4) i32 [type, mat, gid]."""
    obj_data, obj_types, obj_mats = scene.packed_objects()
    nbox = jnp.pad(jnp.asarray(tb.node_box, jnp.float32), ((0, 0), (0, 2)))
    order = jnp.asarray(tb.obj_order)
    orow = jnp.asarray(obj_data, jnp.float32)[order]
    oint = jnp.stack([jnp.asarray(obj_types, jnp.int32)[order],
                      jnp.asarray(obj_mats, jnp.int32)[order],
                      order.astype(jnp.int32),
                      jnp.zeros_like(order, jnp.int32)], axis=1)
    return nbox, jnp.asarray(tb.node_meta, jnp.int32), orow, oint


@functools.partial(jax.jit, static_argnames=(
    "shadow", "motion_blur", "types_present", "interpret"))
def bvh_walk(o, d, time, dist, valid, nbox, nmeta, orow, oint, *,
             shadow: bool, motion_blur: bool, types_present: tuple,
             interpret: bool = False):
    """Run the walk for rays ``o``/``d`` (R, 3).

    Closest mode returns ``(t, gid, normal)`` with t = FLT_MAX and gid = -1
    on a miss; shadow mode (``shadow=True``) returns the (R,) bool
    ``t <= dist + EPSILON`` any-hit (bvh.cpp:376).  ``valid`` lanes that
    are False start finished."""
    R = o.shape[0]
    N, S = nbox.shape[0], orow.shape[0]
    pad = (-R) % BLOCK
    start = jnp.where(valid, 0, N).astype(jnp.int32)

    col = lambda a, fill: jnp.pad(a, (0, pad), constant_values=fill)
    f = lambda a: jnp.asarray(a, jnp.float32)
    ins = [col(f(o[:, k]), 0.0) for k in range(3)]
    ins += [col(f(d[:, k]), 1.0) for k in range(3)]
    ins += [col(f(time), 0.0), col(f(dist), 0.0), col(start, N)]
    n_cols = max(_TYPE_COLS[t] for t in types_present)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    tab_spec = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    Rp = R + pad
    f32 = jax.ShapeDtypeStruct((Rp,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((Rp,), jnp.int32)
    outs = [i32] if shadow else [f32, i32, f32, f32, f32]
    kern = functools.partial(
        _walk_kernel, shadow=shadow, motion_blur=motion_blur,
        types_present=types_present, n_cols=n_cols,
        max_iters=N + S + 64, interpret=interpret)
    res = pl.pallas_call(
        kern, out_shape=outs, grid=(Rp // BLOCK,),
        in_specs=[ray_spec] * 9 + [tab_spec(a) for a in
                                   (nbox, nmeta, orow, oint)],
        out_specs=[ray_spec] * len(outs), backend="triton",
        interpret=interpret, name="bvh_any_hit" if shadow else "bvh_closest",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
    )(*ins, nbox, nmeta, orow, oint)
    if shadow:
        return res[0][:R] != 0
    t, gid, nx, ny, nz = (r[:R] for r in res)
    return t, gid, jnp.stack([nx, ny, nz], axis=-1)


def make_kernel_intersectors(scene: SceneData, tb: ThreadedBVH,
                             motion_blur: bool = False,
                             interpret: bool = False):
    """``Intersectors`` over the Triton walk — drop-in for
    ``accel.bvh.make_threaded_intersectors`` (same winners).  Forward
    only: training takes the XLA traversal (``routing``)."""
    from distributionraytracer.integrator.whitted import Intersectors
    tabs = kernel_tables(scene, tb)
    _, _, obj_mats = scene.packed_objects()
    types_present = tuple(sorted(set(scene.static.obj_types)))
    run = functools.partial(bvh_walk, motion_blur=motion_blur,
                            types_present=types_present,
                            interpret=interpret)

    def _valid(o, valid):
        return (np.ones(o.shape[:1], bool) if valid is None
                else jnp.asarray(valid))

    def closest(o, d, time, valid=None):
        o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
        t, gid, nrm = run(o, d, jnp.asarray(time, jnp.float32),
                          jnp.zeros(o.shape[:1], jnp.float32),
                          _valid(o, valid), *tabs, shadow=False)
        hit = gid >= 0
        return HitResult(hit=hit, t=t, normal=nrm, obj_id=gid,
                         mat_id=obj_mats[jnp.maximum(gid, 0)])

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj  # reference BVH shadow has no self-exclusion
        o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
        return run(o, d, jnp.zeros(o.shape[:1], jnp.float32),
                   jnp.asarray(dist, jnp.float32), _valid(o, valid), *tabs,
                   shadow=True)

    return Intersectors(closest, shadow)
