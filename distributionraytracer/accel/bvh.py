"""Flattened SAH BVH as int32/float32 node tables.

Build (host, NumPy) mirrors ``BVH::build_recursive`` (bvh.cpp:62-227):
12-bucket SAH over all three axes with per-axis centroid sort, leaf
threshold 2, fallback-to-leaf when the split is invalid or the best cost is
not below ``n``.  Children are appended contiguously so ``right = left + 1``
(bvh.cpp:206-222) — the flat array layout ports directly to a
device-resident node table.

Two traversals are provided:

- **Threaded (default)**: the tree is renumbered in DFS pre-order and
  given *skip links* (next node after a subtree), making traversal
  stackless: each ray carries only (node id, leaf cursor, best hit), every
  iteration of one *batched* ``lax.while_loop`` does one uniform step — an
  AABB test that either descends (``node + 1``) or skips (``skip[node]``),
  or one leaf-object test — for the whole ray batch with vector gathers.
  No per-lane stack memory, no scatter, no nested loops.  The same tables
  and step drive the per-ray Triton walk (``accel.bvh_kernel``).  t-pruning (``entry_t >= best_t``, the
  threaded equivalent of bvh.cpp:300-308's pruned pops) and the inside-AABB
  ``t := 0`` fix (bvh.cpp:256-257) are preserved; traversal *order* differs
  from the reference's near-child-first, which cannot change the closest
  hit (strict-< winner) — only exact-tie winners, a measure-zero set.

- **Stack (reference-exact)**: a scalar ``lax.while_loop`` with a fixed
  int32 stack ``vmap``-ed over rays, mirroring bvh.cpp:231-391 including
  near-child-first ordering.  Kept for oracle cross-checks; far too slow
  to render with (the per-lane 64-entry stack and nested pop loop defeat
  vectorization).

The shadow variants any-hit with ``t <= dist + EPSILON`` (bvh.cpp:376).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.accel.grid import object_bboxes
from distributionraytracer.ops.common import EPSILON, FLT_MAX
from distributionraytracer.ops.intersect import hit_packed
from distributionraytracer.scene.types import SceneData

STACK_SIZE = 64
LEAF_THRESHOLD = 2
BUCKETS = 12


class BVHArrays(NamedTuple):
    node_min: jnp.ndarray  # (N,3)
    node_max: jnp.ndarray  # (N,3)
    node_leaf: jnp.ndarray  # (N,) bool
    node_index: jnp.ndarray  # (N,) i32: left child, or first-object offset
    node_nobjs: jnp.ndarray  # (N,) i32
    obj_order: jnp.ndarray  # (O,) i32: leaf ranges index this permutation


def _area(lo, hi):
    e = hi - lo
    return 2.0 * (e[0] * e[1] + e[0] * e[2] + e[1] * e[2])


def build_bvh(scene: SceneData, use_native: bool = True,
              bboxes=None) -> BVHArrays:
    """SAH build over the scene's object AABBs (or ``bboxes`` (O,2,3) when
    given — the grid emulation builds over cell-quantized boxes)."""
    st = scene.static
    bb32 = object_bboxes(scene) if bboxes is None else np.asarray(
        bboxes, np.float32)
    if use_native:
        from distributionraytracer import native
        res = native.build_bvh_native(bb32[:, 0], bb32[:, 1])
        if res is not None:
            nmin, nmax, leaf, index, nobjs, order = res
            # numpy on purpose: callers device_put the whole structure
            # once (renderer.build_accel)
            return BVHArrays(
                node_min=np.asarray(nmin, np.float32),
                node_max=np.asarray(nmax, np.float32),
                node_leaf=np.asarray(leaf, bool),
                node_index=np.asarray(index, np.int32),
                node_nobjs=np.asarray(nobjs, np.int32),
                obj_order=np.asarray(order, np.int32))
    bb = bb32.astype(np.float64)  # (O,2,3)
    O = st.n_objects
    centroids = (bb[:, 0] + bb[:, 1]) / 2.0

    order = np.arange(O, dtype=np.int64)  # permutation being sorted in place
    node_min, node_max, node_leaf, node_index, node_nobjs = [], [], [], [], []

    root_min = bb[:, 0].min(0) - EPSILON
    root_max = bb[:, 1].max(0) + EPSILON
    node_min.append(root_min)
    node_max.append(root_max)
    node_leaf.append(False)
    node_index.append(0)
    node_nobjs.append(0)

    def recurse(left, right, node):
        n = right - left
        if n <= LEAF_THRESHOLD:
            node_leaf[node] = True
            node_index[node] = left
            node_nobjs[node] = n
            return
        box_lo, box_hi = node_min[node], node_max[node]
        parent_area = _area(box_lo, box_hi)

        best_cost = np.inf
        best_axis = 0
        best_split = left
        for axis in range(3):
            seg = order[left:right]
            # std::sort by centroid (bvh.cpp:88-92); stable here
            seg_sorted = seg[np.argsort(centroids[seg, axis], kind="stable")]
            order[left:right] = seg_sorted

            lo_b, hi_b = box_lo[axis], box_hi[axis]
            scale = BUCKETS / (hi_b - lo_b) if hi_b - lo_b > 0 else 0.0
            idx = np.minimum(BUCKETS - 1,
                             ((centroids[seg_sorted, axis] - lo_b) * scale)
                             .astype(np.int64))
            counts = np.bincount(idx, minlength=BUCKETS)
            bmin = np.full((BUCKETS, 3), np.inf)
            bmax = np.full((BUCKETS, 3), -np.inf)
            for b in range(BUCKETS):
                sel = seg_sorted[idx == b]
                if len(sel):
                    bmin[b] = bb[sel, 0].min(0)
                    bmax[b] = bb[sel, 1].max(0)
            # empty buckets carry +-inf bounds; 0 * inf = nan costs are never
            # selected (`cost < best_cost` is false), matching the C++'s
            # FLT_MAX arithmetic (bvh.cpp:95-188)
            np_err = np.seterr(invalid="ignore")
            for i in range(1, BUCKETS):
                lc = counts[:i].sum()
                rc = counts[i:].sum()
                lmin = bmin[:i].min(0)
                lmax = bmax[:i].max(0)
                rmin = bmin[i:].min(0)
                rmax = bmax[i:].max(0)
                larea = _area(lmin, lmax)
                rarea = _area(rmin, rmax)
                cost = 1.0 + (lc * larea + rc * rarea) / parent_area
                if cost < best_cost:
                    best_cost = cost
                    best_axis = axis
                    best_split = left + int(lc)
            np.seterr(**np_err)

        if (best_split <= left or best_split >= right
                or best_cost >= float(n)):
            node_leaf[node] = True
            node_index[node] = left
            node_nobjs[node] = n
            return

        # re-sort on best axis (bvh.cpp:198-201)
        seg = order[left:right]
        order[left:right] = seg[np.argsort(centroids[seg, best_axis],
                                           kind="stable")]

        li = len(node_min)
        node_index[node] = li
        node_leaf[node] = False
        lsel = order[left:best_split]
        rsel = order[best_split:right]
        node_min.append(bb[lsel, 0].min(0))
        node_max.append(bb[lsel, 1].max(0))
        node_min.append(bb[rsel, 0].min(0))
        node_max.append(bb[rsel, 1].max(0))
        node_leaf.extend([False, False])
        node_index.extend([0, 0])
        node_nobjs.extend([0, 0])
        recurse(left, best_split, li)
        recurse(best_split, right, li + 1)

    import sys
    old_lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_lim, 100000))
    try:
        recurse(0, O, 0)
    finally:
        sys.setrecursionlimit(old_lim)

    return BVHArrays(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        node_leaf=np.array(node_leaf, bool),
        node_index=np.array(node_index, np.int32),
        node_nobjs=np.array(node_nobjs, np.int32),
        obj_order=order.astype(np.int32))


# ------------------------------------------------------------- threading
class ThreadedBVH(NamedTuple):
    """DFS pre-order node tables with skip links (stackless traversal).

    ``node_box``: (N, 6) f32 [min, max]; ``node_meta``: (N, 4) i32
    [skip, first_or_left, n_objs, is_leaf]; ``obj_order`` as in BVHArrays.
    A node's left child is ``node + 1``; ``skip`` jumps past the subtree.
    Sentinel: ``node == N`` terminates.
    """

    node_box: jnp.ndarray
    node_meta: jnp.ndarray
    obj_order: jnp.ndarray


def thread_bvh(bvh: BVHArrays) -> ThreadedBVH:
    """Renumber a BVHArrays tree in DFS pre-order and add skip links.

    Host-side numpy; returns numpy tables — device_put the result once
    (renderer.build_accel).
    """
    leaf = np.asarray(jax.device_get(bvh.node_leaf))
    index = np.asarray(jax.device_get(bvh.node_index), np.int64)
    nobjs = np.asarray(jax.device_get(bvh.node_nobjs), np.int64)
    nmin = np.asarray(jax.device_get(bvh.node_min), np.float32)
    nmax = np.asarray(jax.device_get(bvh.node_max), np.float32)
    N = leaf.shape[0]

    # subtree sizes: children always have larger ids than their parent
    # (appended after, bvh.cpp:206-222), so one reverse sweep suffices
    size = np.ones(N, np.int64)
    for i in range(N - 1, -1, -1):
        if not leaf[i]:
            l = index[i]
            size[i] = 1 + size[l] + size[l + 1]

    # iterative pre-order: left child pushed last -> popped first -> new
    # id of left child is parent + 1
    order_old = np.empty(N, np.int64)
    stack = [0]
    c = 0
    while stack:
        o = stack.pop()
        order_old[c] = o
        c += 1
        if not leaf[o]:
            l = index[o]
            stack.append(l + 1)
            stack.append(l)
    assert c == N

    box = np.concatenate([nmin[order_old], nmax[order_old]], axis=1)
    meta = np.stack([
        np.arange(N, dtype=np.int64) + size[order_old],  # skip link
        index[order_old],  # first object for leaves (left child unused)
        nobjs[order_old],
        leaf[order_old].astype(np.int64),
    ], axis=1)
    return ThreadedBVH(
        node_box=box.astype(np.float32),
        node_meta=meta.astype(np.int32),
        obj_order=np.asarray(jax.device_get(bvh.obj_order), np.int32))


def make_threaded_intersectors(scene: SceneData, tb: ThreadedBVH,
                               motion_blur: bool = False):
    """Batched stackless traversal — the XLA BVH path.

    One ``lax.while_loop`` over the whole ray batch; per iteration each lane
    either tests its current node's AABB (descend/skip) or tests one object
    of its current leaf.  All memory access is vector gathers from the
    device-resident node/object tables.  ``tb`` must be threaded host-side
    (``thread_bvh``) — its tables then cross jit boundaries as pytree args.
    """
    tb = ThreadedBVH(*(jnp.asarray(a) for a in tb))
    obj_data, obj_types, obj_mats = scene.packed_objects()
    node_box, node_meta, oorder = tb.node_box, tb.node_meta, tb.obj_order
    N = node_box.shape[0]
    n_obj_tab = oorder.shape[0]

    # One fused gather per step: node row = [bmin, bmax, skip, first, nobj,
    # leaf] (N, 10) f32; object rows are pre-permuted into leaf order and
    # carry type/mat/gid, so the leaf step is a single (O, 15) gather.  The
    # int fields ride as exact float *values* (all < 2^24) — NOT bitcasts:
    # small-int bit patterns are f32 denormals, which flush-to-zero
    # arithmetic would corrupt into infinite traversal loops.
    fenc = lambda a: a.astype(jnp.float32)
    node_row = jnp.concatenate([node_box, fenc(node_meta)], axis=1)
    obj_row = jnp.concatenate(
        [obj_data, fenc(obj_types)[:, None], fenc(obj_mats)[:, None]],
        axis=1)[oorder]
    obj_row = jnp.concatenate([obj_row, fenc(oorder)[:, None]], axis=1)
    ibits = lambda a: a.astype(jnp.int32)
    # which primitive types can appear in leaves (static — prunes the
    # formulas hit_packed evaluates)
    types_present = tuple(sorted(set(scene.static.obj_types)))

    def _traverse(o, d, time, shadow_dist=None, valid=None):
        is_shadow = shadow_dist is not None
        R = o.shape[0]

        # carry constants derived from the ray inputs so they share their
        # shard_map varying-axes type (an unvarying jnp.zeros init + a
        # varying body update is a while_loop carry type error under
        # shard_map); XLA folds the xors to a constant, zero runtime cost.
        # Every input is folded in: under sharding, primary-ray *origins*
        # are the replicated camera eye — only the directions vary.
        bz = None  # all-False, varying like the union of the ray inputs
        for _x in (o[:, 0], d[:, 0], time,
                   *(() if shadow_dist is None else (shadow_dist,)),
                   *(() if valid is None else (valid,))):
            _e = _x == _x
            _e = _e ^ _e
            bz = _e if bz is None else bz | _e
        iz = bz.astype(jnp.int32)
        start = iz
        if valid is not None:
            # dead ray-tree lanes start at the sentinel: done immediately
            start = jnp.where(valid, start, N)
        state = dict(
            node=start,
            obj_k=iz - 1,  # >=0: cursor into a leaf
            best_t=bz.astype(jnp.float32) + FLT_MAX,
            best_n=bz.astype(jnp.float32)[:, None]
            + jnp.zeros((1, 3), jnp.float32),
            best_obj=iz - 1,
            occluded=bz,
            it=jnp.zeros((), jnp.int32),
        )

        # a DFS visits each node at most once and each object cursor step
        # consumes one leaf slot; the hard bound ends any walk over a
        # corrupted link instead of hanging the device
        max_iters = np.int32(N + n_obj_tab + 64)

        def cond(s):
            return jnp.any(s["node"] < N) & (s["it"] < max_iters)

        def body(s):
            node = s["node"]
            active = node < N
            row = jnp.take(node_row, jnp.minimum(node, N - 1), axis=0)
            box = row[:, 0:6]
            skip, first, nobj = (ibits(row[:, 6]), ibits(row[:, 7]),
                                 ibits(row[:, 8]))
            is_leaf = ibits(row[:, 9]) != 0
            in_leaf = s["obj_k"] >= 0

            # ---- leaf-object step (lanes with a cursor) ----
            slot = jnp.clip(first + s["obj_k"], 0, n_obj_tab - 1)
            orow = jnp.take(obj_row, slot, axis=0)
            gid = ibits(orow[:, 14])
            t, nrm = hit_packed(o, d, time, orow[:, 0:12],
                                ibits(orow[:, 12]), motion_blur,
                                types_present=types_present)
            if is_shadow:
                occ_now = (t <= shadow_dist + EPSILON)
            else:
                occ_now = jnp.zeros_like(t, jnp.bool_)
            test = active & in_leaf
            better = test & (t < s["best_t"])
            best_t = jnp.where(better, t, s["best_t"])
            best_n = jnp.where(better[:, None], nrm, s["best_n"])
            best_obj = jnp.where(better, gid, s["best_obj"])
            occluded = s["occluded"] | (test & occ_now)

            k2 = s["obj_k"] + 1
            leaf_done = k2 >= nobj
            node_L = jnp.where(leaf_done, skip, node)
            obj_k_L = jnp.where(leaf_done, -1, k2)

            # ---- node step (lanes without a cursor) ----
            ok, tent = _aabb_hit_v(o, d, box[:, 0:3], box[:, 3:6])
            tent = jnp.where(_inside_v(o, box[:, 0:3], box[:, 3:6]),
                             0.0, tent)
            if is_shadow:
                visit = ok
            else:
                # pruned pops of bvh.cpp:300-308: skip when entry >= best_t
                visit = ok & (tent < best_t)
            enter_leaf = visit & is_leaf & (nobj > 0)
            node_N = jnp.where(visit & ~is_leaf, node + 1,
                               jnp.where(enter_leaf, node, skip))
            obj_k_N = jnp.where(enter_leaf, 0, -1)

            new_node = jnp.where(in_leaf, node_L, node_N)
            new_obj_k = jnp.where(in_leaf, obj_k_L, obj_k_N)
            if is_shadow:
                # stop a lane as soon as it is occluded (bvh.cpp:381-387)
                new_node = jnp.where(occluded, N, new_node)
                new_obj_k = jnp.where(occluded, -1, new_obj_k)
            new_node = jnp.where(active, new_node, node)

            return dict(node=new_node, obj_k=new_obj_k, best_t=best_t,
                        best_n=best_n, best_obj=best_obj, occluded=occluded,
                        it=s["it"] + 1)

        s = jax.lax.while_loop(cond, body, state)
        if is_shadow:
            return s["occluded"]
        hit = s["best_obj"] >= 0
        return (hit, jnp.where(hit, s["best_t"], FLT_MAX), s["best_n"],
                s["best_obj"])

    def closest(o, d, time, valid=None):
        from distributionraytracer.ops.intersect import HitResult
        hit, t, nrm, gid = _traverse(o, d, time, valid=valid)
        mat = obj_mats[jnp.maximum(gid, 0)]
        return HitResult(hit=hit, t=t, normal=nrm, obj_id=gid, mat_id=mat)

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj  # reference BVH shadow has no self-exclusion
        return _traverse(o, d, jnp.zeros(o.shape[:-1], jnp.float32),
                         shadow_dist=dist, valid=valid)

    from distributionraytracer.integrator.whitted import Intersectors
    return Intersectors(closest, shadow)


def _aabb_hit_v(o, d, lo, hi):
    """Batched AABB::hit entry-t semantics (boundingBox.cpp:64-124)."""
    a = 1.0 / d
    tmin = jnp.where(a >= 0, (lo - o) * a, (hi - o) * a)
    tmax = jnp.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    t = jnp.where(t0 < 0, t1, t0)
    return (t0 < t1) & (t1 > 0), t


def _inside_v(o, lo, hi):
    return jnp.all((o > lo) & (o < hi), axis=-1)


# --------------------------------------------------------------- traversal
def _aabb_hit(o, d, lo, hi):
    """AABB::hit entry-t semantics (boundingBox.cpp:64-124), scalar ray."""
    a = 1.0 / d
    tmin = jnp.where(a >= 0, (lo - o) * a, (hi - o) * a)
    tmax = jnp.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0 = jnp.max(tmin)
    t1 = jnp.min(tmax)
    t = jnp.where(t0 < 0, t1, t0)
    return (t0 < t1) & (t1 > 0), t


def _inside(o, lo, hi):
    return jnp.all((o > lo) & (o < hi))


def make_bvh_intersectors(scene: SceneData, bvh: BVHArrays,
                          motion_blur: bool = False):
    bvh = BVHArrays(*(jnp.asarray(a) for a in bvh))
    obj_data, obj_types, obj_mats = scene.packed_objects()
    nmin, nmax = bvh.node_min, bvh.node_max
    nleaf, nindex, nnobjs = bvh.node_leaf, bvh.node_index, bvh.node_nobjs
    oorder = bvh.obj_order

    def _traverse_one(o, d, time, shadow_dist=None):
        """shadow_dist None => closest-hit; else any-hit bool."""
        is_shadow = shadow_dist is not None
        root_ok, _ = _aabb_hit(o, d, nmin[0], nmax[0])

        state = dict(
            node=np.int32(0), sp=np.int32(0),
            stack_n=np.zeros(STACK_SIZE, np.int32),
            stack_t=np.zeros(STACK_SIZE, np.float32),
            best_t=np.float32(FLT_MAX), best_n=np.zeros(3, np.float32),
            best_obj=np.int32(-1), occluded=np.False_,
            active=root_ok)

        def cond(s):
            return s["active"]

        def body(s):
            node = s["node"]
            leaf = nleaf[node]

            # ---------------- inner node ----------------
            # (for leaves nindex is an object offset; clamp to a valid node
            # id and gate everything with ``leaf``)
            li = jnp.clip(jnp.where(leaf, 1, nindex[node]), 0,
                          nmin.shape[0] - 2)
            ri = li + 1
            okL, tL = _aabb_hit(o, d, nmin[li], nmax[li])
            okR, tR = _aabb_hit(o, d, nmin[ri], nmax[ri])
            tL = jnp.where(_inside(o, nmin[li], nmax[li]), 0.0, tL)
            tR = jnp.where(_inside(o, nmin[ri], nmax[ri]), 0.0, tR)

            both = okL & okR
            # closest uses strict <, shadow uses <= (bvh.cpp:261 vs 347)
            left_first = (tL < tR) if not is_shadow else (tL <= tR)
            near = jnp.where(both & left_first, li, ri)
            far = jnp.where(both & left_first, ri, li)
            far_t = jnp.where(both & left_first, tR, tL)

            one = okL ^ okR
            next_inner = jnp.where(both, near, jnp.where(okL, li, ri))
            descend = (both | one) & ~leaf

            push = both & ~leaf
            sp2 = jnp.where(push, s["sp"] + 1, s["sp"])
            stack_n = jnp.where(
                push, s["stack_n"].at[s["sp"]].set(far), s["stack_n"])
            stack_t = jnp.where(
                push, s["stack_t"].at[s["sp"]].set(far_t), s["stack_t"])

            # ---------------- leaf node ----------------
            nobj = nnobjs[node]
            first = nindex[node]

            def leaf_body(i, carry):
                bt, bn, bo, occ = carry
                gid = oorder[jnp.clip(first + i, 0, oorder.shape[0] - 1)]
                t, nrm = hit_packed(o, d, time, obj_data[gid],
                                    obj_types[gid], motion_blur)
                if is_shadow:
                    occ = occ | (t <= shadow_dist + EPSILON)
                    return bt, bn, bo, occ
                better = t < bt
                return (jnp.where(better, t, bt),
                        jnp.where(better, nrm, bn),
                        jnp.where(better, gid, bo), occ)

            bt, bn, bo, occ = jax.lax.fori_loop(
                0, jnp.where(leaf, nobj, 0), leaf_body,
                (s["best_t"], s["best_n"], s["best_obj"], s["occluded"]))

            # ---------------- pop / finish ----------------
            # After a leaf (or an inner with no child hit), pop entries,
            # pruning those with stack.t >= best_t in closest mode
            # (bvh.cpp:299-311); shadow mode pops unconditionally
            # (bvh.cpp:381-387) and stops when occluded.
            need_pop = leaf | (~leaf & ~descend)

            def pop_loop(carry):
                sp, node, found = carry
                return (~found) & (sp > 0)

            def pop_body(carry):
                sp, node, found = carry
                sp = sp - 1
                cand = stack_n[sp]
                cand_t = stack_t[sp]
                good = (cand_t < bt) if not is_shadow else np.True_
                return (sp, jnp.where(good, cand, node), good)

            # lanes that descend skip the pop loop (found starts True)
            sp3, popped_node, found = jax.lax.while_loop(
                pop_loop, pop_body, (sp2, s["node"], ~need_pop))

            new_node = jnp.where(need_pop, popped_node,
                                 jnp.where(leaf, s["node"], next_inner))
            new_sp = jnp.where(need_pop, sp3, sp2)
            done = need_pop & ~found
            if is_shadow:
                done = done | occ
            active = s["active"] & ~done

            return dict(node=new_node, sp=new_sp,
                        stack_n=stack_n, stack_t=stack_t,
                        best_t=bt, best_n=bn, best_obj=bo,
                        occluded=occ, active=active)

        s = jax.lax.while_loop(cond, body, state)
        if is_shadow:
            return s["occluded"]
        hit = s["best_obj"] >= 0
        return hit, jnp.where(hit, s["best_t"], FLT_MAX), s["best_n"], s["best_obj"]

    closest_v = jax.vmap(lambda o, d, t: _traverse_one(o, d, t))
    shadow_v = jax.vmap(lambda o, d, dist: _traverse_one(
        o, d, np.float32(0.0), shadow_dist=dist))

    def closest(o, d, time, valid=None):
        del valid  # reference-shaped path ignores lane masking
        from distributionraytracer.ops.intersect import HitResult
        hit, t, nrm, gid = closest_v(o, d, time)
        mat = obj_mats[jnp.maximum(gid, 0)]
        return HitResult(hit=hit, t=t, normal=nrm, obj_id=gid, mat_id=mat)

    def shadow(o, d, dist, exclude_obj, valid=None):
        del valid
        del exclude_obj
        return shadow_v(o, d, dist)

    from distributionraytracer.integrator.whitted import Intersectors
    return Intersectors(closest, shadow)
