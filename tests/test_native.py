"""Native C++ builders vs the NumPy reference implementations."""

import os
import time

import numpy as np
import pytest

from distributionraytracer import native


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    return True


def test_parse_floats(lib_ok):
    text = b"  1.5 -2 3e2\n4.25\t5 trailing"
    vals, pos = native.parse_floats_native(text, 0, 5)
    np.testing.assert_allclose(vals, [1.5, -2.0, 300.0, 4.25, 5.0])
    assert text[pos:].strip() == b"trailing"


def test_bvh_native_matches_numpy(lib_ok, scenes_dir):
    from distributionraytracer.accel.bvh import build_bvh
    from distributionraytracer.scene import load_p3f
    scene = load_p3f(os.path.join(scenes_dir, "blueDiamond.p3f"),
                     load_sky=False)
    a = build_bvh(scene, use_native=True)
    b = build_bvh(scene, use_native=False)
    assert a.node_min.shape == b.node_min.shape
    np.testing.assert_allclose(np.asarray(a.node_min), np.asarray(b.node_min),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.node_max), np.asarray(b.node_max),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.node_leaf),
                                  np.asarray(b.node_leaf))
    np.testing.assert_array_equal(np.asarray(a.node_index),
                                  np.asarray(b.node_index))
    np.testing.assert_array_equal(np.asarray(a.obj_order),
                                  np.asarray(b.obj_order))


def test_grid_native_matches_numpy(lib_ok):
    from tests.test_accel import random_scene
    from distributionraytracer.accel import grid as G
    scene = random_scene(n_spheres=30, n_tris=20, n_boxes=4, seed=5)
    bb = G.object_bboxes(scene)
    gmin = bb[:, 0].min(0).astype(np.float64) - 1e-3
    gmax = bb[:, 1].max(0).astype(np.float64) + 1e-3
    cells_n, objs_n = native.grid_insert_native(
        bb[:, 0], bb[:, 1], gmin, gmax, 7, 6, 5)
    # numpy reference
    n = np.array([7, 6, 5])
    f = lambda p: np.clip((p - gmin) * n / (gmax - gmin), 0,
                          n - 1).astype(np.int64)
    lo, hi = f(bb[:, 0]), f(bb[:, 1])
    ref_cells, ref_objs = [], []
    for gid in range(len(bb)):
        for z in range(lo[gid, 2], hi[gid, 2] + 1):
            for y in range(lo[gid, 1], hi[gid, 1] + 1):
                for x in range(lo[gid, 0], hi[gid, 0] + 1):
                    ref_cells.append(x + 7 * (y + 6 * z))
                    ref_objs.append(gid)
    np.testing.assert_array_equal(cells_n, ref_cells)
    np.testing.assert_array_equal(objs_n, ref_objs)


def test_bvh_native_dragon_scale(lib_ok, scenes_dir):
    """100k-triangle dragon builds in seconds, not minutes."""
    from distributionraytracer.accel.bvh import build_bvh
    from distributionraytracer.scene import load_p3f
    scene = load_p3f(os.path.join(scenes_dir, "dragon_assignment1.p3f"),
                     load_sky=False)
    assert scene.static.n_triangles >= 100000
    t0 = time.perf_counter()
    bvh = build_bvh(scene, use_native=True)
    dt = time.perf_counter() - t0
    n_nodes = bvh.node_min.shape[0]
    assert n_nodes > 50000
    assert dt < 30.0, f"native BVH build too slow: {dt:.1f}s"
    # sanity: every object appears exactly once in the order permutation
    order = np.asarray(bvh.obj_order)
    assert len(np.unique(order)) == scene.static.n_objects


def test_native_traverse_matches_threaded(scenes_dir):
    """The native CPU traversal (drt_traverse_closest) must find the same
    winners as the XLA threaded path on a real scene — it is the
    independent reference the chip smoke test checks primary winners
    against."""
    import os

    import jax
    import numpy as np

    from distributionraytracer import native
    from distributionraytracer.accel.bvh import (
        build_bvh, make_threaded_intersectors, thread_bvh,
    )
    from distributionraytracer.accel.grid import object_bboxes
    from distributionraytracer.scene import load_p3f

    if not native.available():
        import pytest
        pytest.skip("native toolchain unavailable")
    scene = load_p3f(os.path.join(scenes_dir, "blueDiamond.p3f"))
    bb = object_bboxes(scene)
    nmin, nmax, leaf, index, nobjs, order = native.build_bvh_native(
        bb[:, 0], bb[:, 1])
    obj12, types, _ = scene.packed_objects()
    obj12 = np.asarray(jax.device_get(obj12))
    rng = np.random.default_rng(3)
    n = 512
    ctr = (bb[:, 0].min(0) + bb[:, 1].max(0)) / 2
    ext = float((bb[:, 1].max(0) - bb[:, 0].min(0)).max())
    o = (ctr + rng.standard_normal((n, 3)) * ext).astype(np.float32)
    tgt = ctr + rng.uniform(-0.4, 0.4, (n, 3)) * ext
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_cpu, id_cpu = native.traverse_closest_native(
        (nmin, nmax, leaf, index, nobjs), order, obj12,
        np.asarray(types, np.int32), o, d)
    tb = thread_bvh(build_bvh(scene))
    xla = make_threaded_intersectors(scene.device_put(), tb)
    h = xla.closest(o, d, np.zeros(n, np.float32))
    hit_x = np.asarray(h.hit)
    assert ((id_cpu >= 0) == hit_x).all()
    m = hit_x
    np.testing.assert_allclose(t_cpu[m], np.asarray(h.t)[m], rtol=1e-5)
    assert (id_cpu[m] == np.asarray(h.obj_id)[m]).mean() > 0.995
