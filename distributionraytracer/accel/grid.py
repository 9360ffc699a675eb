"""Uniform-grid accelerator as an array program.

Build (host, NumPy) mirrors ``Grid::Build`` (grid.cpp:30-97): world AABB +
EPSILON pad, cell counts ``n = m * w * (N/V)^(1/3) + 1`` with ``m = 2``
(rayAccelerator.h:30), objects multi-inserted into every overlapped cell.
The cell lists are flattened CSR-style into ``(cell_start, cell_objs)``
int32 arrays — device-resident, static-shaped.

Traversal is the Amanatides & Woo 3D-DDA (grid.cpp:100-306) written as a
scalar ``lax.while_loop`` state machine and ``vmap``-ed over the ray batch.
Each iteration either tests one object of the current cell or advances the
DDA, so all lanes execute uniform work.  Reference semantics preserved:

- ``Init_Traverse`` slab test with IEEE infinity handling for zero direction
  components (grid.cpp:124-152) and per-axis ``t_next``/step/stop setup;
- closest-hit early exit when ``hitRec.t < t_next`` (grid.cpp:277-304);
- walking out of the grid returns *miss* even if a hit was recorded beyond
  the current cell (matters for the fake (-1,1) plane bboxes);
- shadow variant: any object with ``t < dist`` occludes; a failed
  Init_Traverse counts as occluded (grid.cpp:321-324).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from distributionraytracer.ops.common import EPSILON, FLT_MAX
from distributionraytracer.ops.intersect import hit_packed
from distributionraytracer.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)


def object_bboxes(scene: SceneData) -> np.ndarray:
    """Per-object AABBs in reference semantics, host-side.

    - sphere: center +- r (scene.cpp:201-206)
    - triangle: vertex min/max padded EPSILON in the ctor (scene.cpp:14-35)
    - plane: the *default* Object bbox (-1,-1,-1)..(1,1,1) — Plane never
      overrides GetBoundingBox (scene.h:116, 125-136); a reference bug kept
      for fidelity
    - box: min/max (scene.cpp:214-216)
    Returns (O, 2, 3) float32.
    """
    st = scene.static
    g = lambda a: np.asarray(jax.device_get(a), np.float32)
    types = np.array(st.obj_types, np.int64)
    tidx = np.array(st.obj_tidx, np.int64)
    out = np.zeros((st.n_objects, 2, 3), np.float32)

    m = types == OBJ_SPHERE
    if m.any():
        c, r = g(scene.sph_center)[tidx[m]], g(scene.sph_radius)[tidx[m]]
        out[m, 0] = c - r[:, None]
        out[m, 1] = c + r[:, None]
    m = types == OBJ_TRIANGLE
    if m.any():
        i = tidx[m]
        v0 = g(scene.tri_v0)[i]
        pts = np.stack([v0, v0 + g(scene.tri_e1)[i],
                        v0 + g(scene.tri_e2)[i]], axis=1)  # (n,3,3)
        out[m, 0] = pts.min(1) - EPSILON
        out[m, 1] = pts.max(1) + EPSILON
    m = types == OBJ_PLANE
    if m.any():
        out[m, 0] = -1.0
        out[m, 1] = 1.0
    m = types == OBJ_BOX
    if m.any():
        out[m, 0] = g(scene.box_min)[tidx[m]]
        out[m, 1] = g(scene.box_max)[tidx[m]]
    return out


class GridArrays(NamedTuple):
    bbox_min: jnp.ndarray  # (3,)
    bbox_max: jnp.ndarray  # (3,)
    ncells: jnp.ndarray  # (3,) i32 (nx, ny, nz)
    cell_start: jnp.ndarray  # (nx*ny*nz + 1,) i32
    cell_objs: jnp.ndarray  # (total,) i32 global object ids
    cell_dist: jnp.ndarray  # (nx*ny*nz,) i32 chessboard dist to occupied
    # packed primitive table (built per trace from the scene)


_DIST_CAP = 127


def _chebyshev_dist(occupied: np.ndarray, nx: int, ny: int, nz: int,
                    cap: int = _DIST_CAP) -> np.ndarray:
    """Chessboard distance-to-occupied per cell (proximity clouds).

    Native two-pass chamfer when available; NumPy fallback is iterative
    3x3x3 erosion (one chebyshev ring per pass), capped — still exact up to
    the cap, just O(cap) passes.
    """
    from distributionraytracer import native
    res = native.chebyshev_dist_native(occupied, nx, ny, nz, cap)
    if res is not None:
        return res
    occ = occupied.reshape(nz, ny, nx).astype(bool)
    dist = np.where(occ, 0, cap).astype(np.int32)
    frontier = occ
    for k in range(1, cap):
        if frontier.all():
            break
        grown = frontier.copy()
        for ax in range(3):  # separable ±1 dilation = 3³ structuring cube
            g = grown
            grown = g.copy()
            grown[tuple(slice(None, -1) if a == ax else slice(None)
                        for a in range(3))] |= g[tuple(
                            slice(1, None) if a == ax else slice(None)
                            for a in range(3))]
            grown[tuple(slice(1, None) if a == ax else slice(None)
                        for a in range(3))] |= g[tuple(
                            slice(None, -1) if a == ax else slice(None)
                            for a in range(3))]
        ring = grown & ~frontier
        dist[ring] = k
        frontier = grown
    return dist.reshape(-1)


def build_grid(scene: SceneData, m: float = 2.0) -> GridArrays:
    st = scene.static
    bb = object_bboxes(scene)
    if st.n_objects == 0:
        raise ValueError("empty scene")
    gmin = bb[:, 0].min(0) - EPSILON
    gmax = bb[:, 1].max(0) + EPSILON
    w = (gmax - gmin).astype(np.float64)
    s = (st.n_objects / (w[0] * w[1] * w[2])) ** (1.0 / 3.0)
    n = (m * w * s + 1).astype(np.int64)  # int truncation as in grid.cpp:63-65
    nx, ny, nz = int(n[0]), int(n[1]), int(n[2])

    def cell_of(p):
        # clamp((p - min) * n / (max - min), 0, n-1), truncated (grid.cpp:80-85)
        f = (p - gmin) * n / (gmax - gmin)
        return np.clip(f, 0, n - 1).astype(np.int64)

    from distributionraytracer import native
    res = native.grid_insert_native(bb[:, 0], bb[:, 1],
                                    gmin.astype(np.float64),
                                    gmax.astype(np.float64), nx, ny, nz)
    if res is not None:
        cell_ids, obj_ids = res
    else:
        lo = cell_of(bb[:, 0])
        hi = cell_of(bb[:, 1])
        entries_cell = []
        entries_obj = []
        for gid in range(st.n_objects):
            xs = np.arange(lo[gid, 0], hi[gid, 0] + 1)
            ys = np.arange(lo[gid, 1], hi[gid, 1] + 1)
            zs = np.arange(lo[gid, 2], hi[gid, 2] + 1)
            cz, cy, cx = np.meshgrid(zs, ys, xs, indexing="ij")
            cells = (cx + nx * cy + nx * ny * cz).ravel()
            entries_cell.append(cells)
            entries_obj.append(np.full(len(cells), gid, np.int64))
        cell_ids = np.concatenate(entries_cell)
        obj_ids = np.concatenate(entries_obj)
    # CSR by cell, preserving object insertion order within a cell
    order = np.argsort(cell_ids, kind="stable")
    cell_ids = cell_ids[order]
    obj_ids = obj_ids[order]
    counts = np.bincount(cell_ids, minlength=nx * ny * nz)
    start = np.zeros(nx * ny * nz + 1, np.int64)
    np.cumsum(counts, out=start[1:])

    # numpy on purpose: callers device_put the structure once
    # (renderer.build_accel)
    return GridArrays(
        bbox_min=np.asarray(gmin, np.float32),
        bbox_max=np.asarray(gmax, np.float32),
        ncells=np.asarray([nx, ny, nz], np.int32),
        cell_start=start.astype(np.int32),
        cell_objs=obj_ids.astype(np.int32),
        cell_dist=_chebyshev_dist((counts > 0).astype(np.uint8), nx, ny, nz))


# --------------------------------------------------------------- traversal
def _init_traverse_batched(grid: GridArrays, o, d):
    """Init_Traverse (grid.cpp:100-244), batched over rays (R, 3)."""
    a = 1.0 / d  # +-inf on zeros, sign of zero matters (as in C++)
    lo = grid.bbox_min
    hi = grid.bbox_max
    tmin = jnp.where(a >= 0, (lo - o) * a, (hi - o) * a)  # (R,3)
    tmax = jnp.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    ok = ~((t0 > t1) | (t1 < 0))

    n = grid.ncells  # (3,)
    nf = n.astype(jnp.float32)
    inside = jnp.all((o > lo) & (o < hi), axis=-1)
    p = jnp.where(inside[:, None], o, o + d * t0[:, None])
    cell = jnp.clip(((p - lo) * nf / (hi - lo)).astype(jnp.int32), 0, n - 1)

    dt = (tmax - tmin) / nf
    pos = d > 0
    t_next = jnp.where(
        pos, tmin + (cell + 1).astype(jnp.float32) * dt,
        tmin + (n - cell).astype(jnp.float32) * dt)
    t_next = jnp.where(d == 0.0, FLT_MAX, t_next)
    step = jnp.where(pos, 1, -1).astype(jnp.int32)
    stop = jnp.where(pos, n[None, :], -1).astype(jnp.int32)
    return ok, cell, dt, t_next, step, stop, tmin, t1


def _pick_unroll(cell_start) -> int:
    """Objects tested per while-loop iteration, from cell occupancy.

    K ≈ the median *entry-weighted* cell population — the cell size a random
    ray-object test actually sits in.  The plain per-cell percentile is the
    wrong statistic under lockstep: a dense-mesh grid whose median occupied
    cell holds 2 objects can put the median ray-object *test* in a cell of
    ~90 (dragon meshes multi-insert heavily), and the whole batch waits on
    those lanes at K object-tests per iteration.  Host-side, init-time only.
    """
    cs = np.asarray(jax.device_get(cell_start), np.int64)
    counts = np.diff(cs)
    counts = counts[counts > 0]
    if counts.size == 0:
        return 1
    per_entry_median = np.percentile(np.repeat(counts, counts), 50)
    return int(np.clip(per_entry_median, 1, 24))


def make_grid_intersectors(scene: SceneData, grid: GridArrays,
                           motion_blur: bool = False,
                           unroll: int | None = None,
                           adv_unroll: int = 2,
                           leap: bool = True):
    """Batched 3D-DDA — the XLA grid path.

    One ``lax.while_loop`` over the whole ray batch; per iteration each lane
    tests up to K objects of its current cell and, once the cell is
    exhausted, advances the DDA in the *same* iteration — uniform vector
    work, no vmapped per-lane state machines.  Cell ranges and the
    cell-ordered object rows are single fused gathers.  The K-way unroll
    amortizes the DDA bookkeeping and while-loop overhead across K
    primitive tests (dense mesh grids put tens of triangles in a cell, so
    the 1-object-per-iteration form is iteration-bound, not FLOP-bound).
    Reference semantics preserved (see module docstring): within an
    iteration the K candidates resolve by strict ``<`` with first-wins
    ties, identical to the reference's sequential scan order.

    ``leap`` enables proximity-cloud empty-space skipping: each cell stores
    its chessboard distance ``v`` to the nearest occupied cell; a lane that
    steps into a cell with ``v >= 3`` jumps the ray forward by the provably
    safe parametric span ``(v-2)·min(dt)`` (no occupied cell is reachable
    within chebyshev radius ``v-1``) and re-derives (cell, t_next) from the
    landing position.  This collapses the reference's hundreds of per-cell
    DDA steps across empty space (grids are ~95% empty around dense meshes)
    into a handful of jumps — pure strength reduction: cells skipped are
    empty, so no object test is ever skipped and results are bit-identical.
    """
    if unroll is None:
        # under jit the CSR table is a tracer — callers that care (Renderer)
        # compute the occupancy-based K host-side and pass it in
        unroll = (4 if isinstance(grid.cell_start, jax.core.Tracer)
                  else _pick_unroll(grid.cell_start))
    K = int(unroll)
    M = max(1, int(adv_unroll))  # empty cells skipped per iteration
    grid = GridArrays(*(jnp.asarray(a) for a in grid))
    obj_data, obj_types, obj_mats = scene.packed_objects()
    n = grid.ncells
    # (C, 2) [start, end] so one gather yields the cell's object range
    cell_se = jnp.stack([grid.cell_start[:-1], grid.cell_start[1:]], axis=1)
    # object rows pre-permuted into cell order: [12 params, type, mat, gid]
    fenc = lambda a: a.astype(jnp.float32)  # exact for ints < 2^24
    co = grid.cell_objs
    obj_row = jnp.concatenate(
        [obj_data, fenc(obj_types)[:, None], fenc(obj_mats)[:, None]],
        axis=1)[co]
    obj_row = jnp.concatenate([obj_row, fenc(co)[:, None]], axis=1)
    n_obj_tab = co.shape[0]
    types_present = tuple(sorted(set(scene.static.obj_types)))

    def _cell_linear(cell):
        return cell[:, 0] + n[0] * cell[:, 1] + n[0] * n[1] * cell[:, 2]

    def _traverse(o, d, time, shadow_dist=None, valid=None):
        is_shadow = shadow_dist is not None
        R = o.shape[0]
        (ok, cell, dt, t_next, step, stop,
         tmin, t1) = _init_traverse_batched(grid, o, d)
        min_dt = jnp.min(dt, axis=-1)  # (R,) finite unless d == 0 everywhere
        pos_dir = step > 0  # (R,3)
        lo, hi = grid.bbox_min, grid.bbox_max
        nf = n.astype(jnp.float32)
        if valid is not None:
            ok = ok & valid  # dead ray-tree lanes terminate immediately

        se = jnp.take(cell_se, _cell_linear(cell), axis=0)
        # carry constants derived from the ray inputs so they share their
        # shard_map varying-axes type (an unvarying jnp.zeros init + a
        # varying body update is a while_loop carry type error under
        # shard_map); XLA folds the xors to a constant, zero runtime cost
        bz = ok ^ ok  # all-False, varying like the union of the inputs
        for _x in (time, *(() if shadow_dist is None else (shadow_dist,))):
            _e = _x == _x
            bz = bz | (_e ^ _e)
        fz = bz.astype(jnp.float32)
        state = dict(
            cell=cell, t_next=t_next,
            ptr=jnp.where(ok, se[:, 0], 0), end=jnp.where(ok, se[:, 1], 0),
            best_t=fz + FLT_MAX,
            best_n=fz[:, None] + jnp.zeros((1, 3), jnp.float32),
            best_obj=bz.astype(jnp.int32) - 1,
            # Init failure counts as shadowed (grid.cpp:321-324)
            occluded=~ok if is_shadow else bz,
            active=ok, found=bz,
            it=jnp.zeros((), jnp.int32))

        # Hard upper bound on any lane's step count: every DDA advance moves
        # one cell (<= nx+ny+nz cells on a path) and every object step
        # consumes one CSR entry (<= total entries).  Degenerate rays
        # (0 * inf = NaN in the slab test, exactly as in grid.cpp:124-152)
        # could otherwise walk a wrapped int32 cell coordinate ~2^31 steps
        # and hang the device.
        max_iters = jnp.sum(n) + np.int32(n_obj_tab // K + 64)

        def cond(s):
            return jnp.any(s["active"]) & (s["it"] < max_iters)

        def body(s):
            act = s["active"]

            # --- test up to K objects of the current cell ---
            ptrs = s["ptr"][:, None] + jnp.arange(K, dtype=jnp.int32)  # (R,K)
            omask = act[:, None] & (ptrs < s["end"][:, None])
            rows = jnp.take(obj_row, jnp.clip(ptrs, 0, n_obj_tab - 1),
                            axis=0)  # (R,K,15)
            t, nrm = hit_packed(o[:, None, :], d[:, None, :], time[:, None],
                                rows[:, :, 0:12],
                                rows[:, :, 12].astype(jnp.int32), motion_blur,
                                types_present=types_present)
            t = jnp.where(omask, t, FLT_MAX)  # (R,K)
            gid = rows[:, :, 14].astype(jnp.int32)
            if is_shadow:
                occ = jnp.any(t < shadow_dist[:, None], axis=1)
                best_t, best_n, best_obj = (s["best_t"], s["best_n"],
                                            s["best_obj"])
            else:
                occ = jnp.zeros((R,), jnp.bool_)
                # first-min wins ties == the reference's sequential strict-<
                kb = jnp.argmin(t, axis=1)
                tb = jnp.take_along_axis(t, kb[:, None], axis=1)[:, 0]
                better = tb < s["best_t"]
                best_t = jnp.where(better, tb, s["best_t"])
                nb = jnp.take_along_axis(
                    nrm, kb[:, None, None], axis=1)[:, 0]
                best_n = jnp.where(better[:, None], nb, s["best_n"])
                gb = jnp.take_along_axis(gid, kb[:, None], axis=1)[:, 0]
                best_obj = jnp.where(better, gb, s["best_obj"])
            ptr = s["ptr"] + jnp.sum(omask, axis=1).astype(jnp.int32)

            # --- advance the DDA through up to M cells once exhausted ---
            # empty cells are the common case in mesh grids; unrolling the
            # advance amortizes the while-loop round trip across M cell
            # steps (each is cheap vector work + one 2-int gather)
            cell, tn, end = s["cell"], s["t_next"], s["end"]
            found = s["found"]
            occluded = s["occluded"] | occ
            active = act & ~occ
            adv = active & (ptr >= end)
            for _ in range(M):
                axis = jnp.where(
                    (tn[:, 0] < tn[:, 1]) & (tn[:, 0] < tn[:, 2]), 0,
                    jnp.where(tn[:, 1] < tn[:, 2], 1, 2))
                onehot = jax.nn.one_hot(axis, 3, dtype=jnp.float32)
                onehot_i = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
                tn_axis = jnp.sum(tn * onehot, axis=-1)
                if is_shadow:
                    hit_now = jnp.zeros((R,), jnp.bool_)
                else:
                    # closest-hit early exit (grid.cpp:277-304)
                    hit_now = adv & (best_t < tn_axis)
                found = found | hit_now
                stepping0 = adv & ~hit_now
                tn = jnp.where(stepping0[:, None], tn + onehot * dt, tn)
                # clamp into [-1, n]: NaN-born cells must not wrap int32
                cell = jnp.clip(
                    jnp.where(stepping0[:, None],
                              cell + onehot_i * step, cell),
                    -1, n)
                out = stepping0 & (
                    jnp.sum(cell * onehot_i, axis=-1)
                    == jnp.sum(stop * onehot_i, axis=-1))
                stepping = stepping0 & ~out
                se2 = jnp.take(cell_se,
                               _cell_linear(jnp.clip(cell, 0, n - 1)),
                               axis=0)
                ptr = jnp.where(stepping, se2[:, 0], ptr)
                end = jnp.where(stepping, se2[:, 1], end)
                active = active & ~hit_now & ~out
                # keep advancing only lanes whose new cell is empty
                adv = stepping & (ptr >= end)

                if leap:
                    # proximity-cloud jump over provably-empty space
                    dv = jnp.take(grid.cell_dist,
                                  _cell_linear(jnp.clip(cell, 0, n - 1)))
                    lp = adv & (dv >= 3)
                    # entry t of the current (empty) cell is the crossing we
                    # just consumed; (v-2)·min_dt keeps every crossed cell
                    # within the empty chebyshev ball of radius v-1
                    t_new = tn_axis + (dv.astype(jnp.float32) - 2.0) * min_dt
                    lp_out = lp & (t_new >= t1)
                    p = o + d * t_new[:, None]
                    ncell = jnp.clip(
                        ((p - lo) * nf / (hi - lo)).astype(jnp.int32),
                        0, n - 1)
                    tn_leap = jnp.where(
                        pos_dir,
                        tmin + (ncell + 1).astype(jnp.float32) * dt,
                        tmin + (n - ncell).astype(jnp.float32) * dt)
                    tn_leap = jnp.where(d == 0.0, FLT_MAX, tn_leap)
                    se3 = jnp.take(cell_se, _cell_linear(ncell), axis=0)
                    do_leap = lp & ~lp_out
                    cell = jnp.where(do_leap[:, None], ncell, cell)
                    tn = jnp.where(do_leap[:, None], tn_leap, tn)
                    ptr = jnp.where(do_leap, se3[:, 0], ptr)
                    end = jnp.where(do_leap, se3[:, 1], end)
                    if not is_shadow:
                        # a best_t inside the grid must be honoured even if
                        # the jump would exit (cannot normally happen: the
                        # hit cell is occupied hence outside the ball; this
                        # guards float-boundary insertions)
                        found = found | (lp_out & (best_t < t1))
                    active = active & ~lp_out
                    # landing cell is empty by the ball guarantee; gate on
                    # ptr/end anyway so a float-boundary landing on an
                    # occupied cell gets its objects tested, not skipped
                    adv = (adv & ~lp) | (do_leap & (ptr >= end))

            return dict(cell=cell, t_next=tn, ptr=ptr, end=end,
                        best_t=best_t, best_n=best_n, best_obj=best_obj,
                        occluded=occluded, active=active, found=found,
                        it=s["it"] + 1)

        s = jax.lax.while_loop(cond, body, state)
        if is_shadow:
            return s["occluded"]
        hit = s["found"]
        return (hit, jnp.where(hit, s["best_t"], FLT_MAX), s["best_n"],
                jnp.where(hit, s["best_obj"], -1))

    def closest(o, d, time, valid=None):
        from distributionraytracer.ops.intersect import HitResult
        hit, t, nrm, gid = _traverse(o, d, time, valid=valid)
        mat = obj_mats[jnp.maximum(gid, 0)]
        return HitResult(hit=hit, t=t, normal=nrm, obj_id=gid, mat_id=mat)

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj  # grid traversal has no self-exclusion
        return _traverse(o, d, jnp.zeros(o.shape[:-1], jnp.float32),
                         shadow_dist=dist, valid=valid)

    from distributionraytracer.integrator.whitted import Intersectors
    return Intersectors(closest, shadow)


def _init_traverse(grid: GridArrays, o, d):
    """Init_Traverse (grid.cpp:100-244) for one ray. Returns dict of scalars."""
    a = 1.0 / d  # +-inf on zeros, sign of zero matters (as in C++)
    lo = grid.bbox_min
    hi = grid.bbox_max
    tmin = jnp.where(a >= 0, (lo - o) * a, (hi - o) * a)
    tmax = jnp.where(a >= 0, (hi - o) * a, (lo - o) * a)
    t0 = jnp.max(tmin)
    t1 = jnp.min(tmax)
    ok = ~((t0 > t1) | (t1 < 0))

    n = grid.ncells
    nf = n.astype(jnp.float32)
    inside = jnp.all((o > lo) & (o < hi))
    p = jnp.where(inside, o, o + d * t0)
    cell = jnp.clip(((p - lo) * nf / (hi - lo)).astype(jnp.int32), 0, n - 1)

    dt = (tmax - tmin) / nf
    pos = d > 0
    t_next = jnp.where(
        pos, tmin + (cell + 1).astype(jnp.float32) * dt,
        tmin + (n - cell).astype(jnp.float32) * dt)
    t_next = jnp.where(d == 0.0, FLT_MAX, t_next)
    step = jnp.where(pos, 1, -1).astype(jnp.int32)
    stop = jnp.where(pos, n, -1).astype(jnp.int32)
    return ok, cell, dt, t_next, step, stop


def make_grid_scalar_intersectors(scene: SceneData, grid: GridArrays,
                                  motion_blur: bool = False):
    """vmapped per-ray DDA state machine — kept as the reference-shaped
    implementation for cross-checks; prefer make_grid_intersectors."""
    grid = GridArrays(*(jnp.asarray(a) for a in grid))
    obj_data, obj_types, obj_mats = scene.packed_objects()
    cs, co = grid.cell_start, grid.cell_objs
    n = grid.ncells

    def _cell_linear(cell):
        return cell[0] + n[0] * cell[1] + n[0] * n[1] * cell[2]

    def closest_one(o, d, time):
        ok, cell, dt, t_next, step, stop = _init_traverse(grid, o, d)

        cid = _cell_linear(cell)
        state = dict(
            cell=cell, t_next=t_next,
            ptr=jnp.where(ok, cs[cid], 0), end=jnp.where(ok, cs[cid + 1], 0),
            best_t=np.float32(FLT_MAX), best_n=np.zeros(3, np.float32),
            best_obj=np.int32(-1), active=ok, found=np.False_)

        def cond(s):
            return s["active"]

        def body(s):
            has_obj = s["ptr"] < s["end"]

            # --- test one object ---
            gid = co[jnp.clip(s["ptr"], 0, co.shape[0] - 1)]
            t, nrm = hit_packed(o, d, time, obj_data[gid], obj_types[gid],
                                motion_blur)
            better = has_obj & (t < s["best_t"])
            best_t = jnp.where(better, t, s["best_t"])
            best_n = jnp.where(better, nrm, s["best_n"])
            best_obj = jnp.where(better, gid, s["best_obj"])
            ptr = jnp.where(has_obj, s["ptr"] + 1, s["ptr"])

            # --- advance DDA when the cell is exhausted ---
            adv = ~has_obj
            tn = s["t_next"]
            axis = jnp.where(
                (tn[0] < tn[1]) & (tn[0] < tn[2]), 0,
                jnp.where(tn[1] < tn[2], 1, 2))
            hit_now = best_t < tn[axis]
            onehot = jax.nn.one_hot(axis, 3, dtype=jnp.float32)
            onehot_i = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
            t_next2 = jnp.where(adv & ~hit_now, tn + onehot * dt, tn)
            cell2 = jnp.where(adv & ~hit_now, s["cell"] + onehot_i * step,
                              s["cell"])
            out = cell2[axis] == stop[axis]
            stepping = adv & ~hit_now & ~out
            cid2 = _cell_linear(jnp.clip(cell2, 0, n - 1))
            ptr = jnp.where(stepping, cs[cid2], ptr)
            end = jnp.where(stepping, cs[cid2 + 1], s["end"])

            found = s["found"] | (adv & hit_now)
            active = s["active"] & ~(adv & (hit_now | out))
            return dict(cell=cell2, t_next=t_next2, ptr=ptr, end=end,
                        best_t=best_t, best_n=best_n, best_obj=best_obj,
                        active=active, found=found)

        s = jax.lax.while_loop(cond, body, state)
        hit = s["found"]
        return (hit, jnp.where(hit, s["best_t"], FLT_MAX), s["best_n"],
                jnp.where(hit, s["best_obj"], -1))

    def shadow_one(o, d, dist):
        ok, cell, dt, t_next, step, stop = _init_traverse(grid, o, d)

        cid = _cell_linear(cell)
        state = dict(
            cell=cell, t_next=t_next,
            ptr=jnp.where(ok, cs[cid], 0), end=jnp.where(ok, cs[cid + 1], 0),
            occluded=~ok,  # Init failure counts as shadowed (grid.cpp:321-324)
            active=ok)

        def cond(s):
            return s["active"]

        def body(s):
            has_obj = s["ptr"] < s["end"]
            gid = co[jnp.clip(s["ptr"], 0, co.shape[0] - 1)]
            t, _ = hit_packed(o, d, np.float32(0.0), obj_data[gid],
                              obj_types[gid], motion_blur)
            occ = has_obj & (t < dist)
            ptr = jnp.where(has_obj, s["ptr"] + 1, s["ptr"])

            adv = ~has_obj
            tn = s["t_next"]
            axis = jnp.where(
                (tn[0] < tn[1]) & (tn[0] < tn[2]), 0,
                jnp.where(tn[1] < tn[2], 1, 2))
            onehot = jax.nn.one_hot(axis, 3, dtype=jnp.float32)
            onehot_i = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
            t_next2 = jnp.where(adv, tn + onehot * dt, tn)
            cell2 = jnp.where(adv, s["cell"] + onehot_i * step, s["cell"])
            out = cell2[axis] == stop[axis]
            stepping = adv & ~out
            cid2 = _cell_linear(jnp.clip(cell2, 0, n - 1))
            ptr = jnp.where(stepping, cs[cid2], ptr)
            end = jnp.where(stepping, cs[cid2 + 1], s["end"])

            occluded = s["occluded"] | occ
            active = s["active"] & ~occ & ~(adv & out)
            return dict(cell=cell2, t_next=t_next2, ptr=ptr, end=end,
                        occluded=occluded, active=active)

        s = jax.lax.while_loop(cond, body, state)
        return s["occluded"]

    vmapped_closest = jax.vmap(closest_one)
    vmapped_shadow = jax.vmap(shadow_one)

    def closest(o, d, time, valid=None):
        del valid  # reference-shaped path ignores lane masking
        from distributionraytracer.ops.intersect import HitResult
        hit, t, nrm, gid = vmapped_closest(o, d, time)
        mat = obj_mats[jnp.maximum(gid, 0)]
        return HitResult(hit=hit, t=t, normal=nrm, obj_id=gid, mat_id=mat)

    def shadow(o, d, dist, exclude_obj, valid=None):
        del valid
        del exclude_obj  # grid traversal has no self-exclusion
        return vmapped_shadow(o, d, dist)

    from distributionraytracer.integrator.whitted import Intersectors
    return Intersectors(closest, shadow)
