"""Smoke test of the renderer's main paths on one NVIDIA GPU.

    python3 chip_smoke.py            # one card: whitted, mesh, pathtrace, grad
    python3 chip_smoke.py --four     # four cards: sharded mesh render and
                                     # sharded train step vs one card

Each phase runs a deployment from ``scene.generate`` at full size through
the entry points users call (``Renderer``, ``render_pt``,
``render_image_sharded``, ``make_sharded_train_step``) and checks it
against an independent reference: the NumPy oracle, the native CPU BVH
traversal, the CPU backend, or the one-card run.  Every phase prints one
line (shape, compile seconds, median frame seconds over 3 frames, the
check's numbers); a failed check raises, and the script exits non-zero
before the last line.  The last line is one JSON object naming the device.
It exits non-zero without a result when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PT_FULL = (800, 600, 64)  # the GLSL harness: width, height, spp
PT_SMALL = (80, 60, 16)  # the CPU-backend comparison


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, frames=3):
    """(first-call seconds incl. compile, median of ``frames`` calls)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def report(phase, **kv):
    fields = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"phase={phase} {fields}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def images_close(img, ref, atol=3e-3, outlier_frac=0.005, max_outlier=0.05):
    """The repo's image tolerance (tests/test_whitted.py): at most 0.5% of
    elements beyond ``atol``, none beyond ``max_outlier``."""
    diff = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    frac = float((diff > atol).mean())
    check(frac <= outlier_frac and diff.max() <= max_outlier,
          f"images differ: {frac:.4%} beyond {atol}, max {diff.max():.4g}")
    return float(diff.max()), frac


def crop(samples, y0, x0, n):
    from distributionraytracer.integrator.render import SampleSet
    c = lambda a: np.asarray(a)[y0:y0 + n, x0:x0 + n]
    return SampleSet(c(samples.pixel), c(samples.light), c(samples.lens),
                     c(samples.time))


# ---------------------------------------------------------------- phases
def phase_whitted(seed):
    """balls_low (512x512, 16 spp, accel none) through Renderer.render; a
    16x16 crop of the same SampleSet against the NumPy oracle."""
    import jax
    from distributionraytracer.integrator.render import make_samples
    from distributionraytracer.oracle import oracle_render
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene.generate import generate

    scene = generate("balls_low", seed)
    r = Renderer(scene)
    samples = make_samples(r.scene, r.cfg, jax.random.PRNGKey(seed))
    img, first, med = timed(lambda: r.render_with_samples(samples))
    img = np.asarray(img)
    H, W = scene.static.res_y, scene.static.res_x
    check(np.isfinite(img).all() and img.shape == (H, W, 3), "whitted")
    y0, x0, n = H // 2 - 8, W // 2 - 8, 16
    ref = oracle_render(scene, crop(samples, y0, x0, n),
                        max_depth=r.cfg.max_depth, origin=(x0, y0))
    diff, frac = images_close(img[y0:y0 + n, x0:x0 + n], ref)
    report("whitted", shape=f"{W}x{H}x{r.cfg.spp}spp", route=r.route,
           compile_s=f"{first:.3f}", median_s=f"{med:.4f}",
           oracle_max_diff=f"{diff:.3g}", oracle_outliers=f"{frac:.4%}")


def _primary(r, samples):
    from distributionraytracer.integrator.render import _rays_from_samples
    return _rays_from_samples(r.scene, r.cfg, samples)[:3]


def phase_mesh(seed):
    """dragon_assignment1 (100k-triangle glass mesh + metal, BVH, 512x512,
    depth 4) through Renderer.render on the Triton route and the XLA
    route: identical primary winners, images within the repo tolerance,
    and primary winners against the native CPU traversal."""
    import jax
    from distributionraytracer import native
    from distributionraytracer.accel.bvh_kernel import (
        make_kernel_intersectors,
    )
    from distributionraytracer.accel.bvh import make_threaded_intersectors
    from distributionraytracer.accel.grid import object_bboxes
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.render import make_samples
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene.generate import generate

    scene = generate("dragon_assignment1", seed)
    t0 = time.perf_counter()
    runs = {}
    for backend in ("auto", "xla"):
        r = Renderer(scene, RenderConfig(accel_backend=backend))
        samples = make_samples(r.scene, r.cfg, jax.random.PRNGKey(seed))
        img, first, med = timed(lambda: r.render_with_samples(samples))
        runs[r.route] = (r, np.asarray(img), first, med)
    build_s = time.perf_counter() - t0
    check(set(runs) == {"bvh-triton", "bvh-xla"}, f"routes {list(runs)}")
    rk, img_k, first_k, med_k = runs["bvh-triton"]
    rx, img_x, first_x, med_x = runs["bvh-xla"]
    check(np.isfinite(img_k).all() and img_k.shape == img_x.shape, "mesh")
    diff, frac = images_close(img_k, img_x)

    # primary winners: kernel vs XLA traversal, identical
    o, d, t = _primary(rx, samples)
    hk = jax.jit(lambda sc, tb, *ray: make_kernel_intersectors(
        sc, tb).closest(*ray))(rk.scene, rk.tables, o, d, t)
    hx = jax.jit(lambda sc, tb, *ray: make_threaded_intersectors(
        sc, tb).closest(*ray))(rx.scene, rx.tables, o, d, t)
    gk, gx = np.asarray(hk.obj_id), np.asarray(hx.obj_id)
    live = gx >= 0
    check((gk == gx).all(), f"{int((gk != gx).sum())} primary winners "
          "differ between the Triton and XLA traversals")
    tk, tx = np.asarray(hk.t)[live], np.asarray(hx.t)[live]
    t_rel = float((np.abs(tk - tx) / np.abs(tx)).max())
    check(t_rel <= 1e-5, f"t differs by {t_rel:.3g} relative")

    # primary winners vs the native CPU traversal of the reference's
    # stack-based BVH (its near-child-first order can pick another of two
    # exactly tied triangles, and host/device rounding can move a grazing
    # ray across an edge: 0.5% of winners, 0.01% of hit flags may differ)
    bb = object_bboxes(scene)
    nodes = native.build_bvh_native(bb[:, 0], bb[:, 1])
    check(nodes is not None, "native library unavailable")
    obj12, types, _ = scene.packed_objects()
    t_cpu, id_cpu = native.traverse_closest_native(
        nodes[:5], nodes[5], np.asarray(obj12), np.asarray(types, np.int32),
        np.asarray(o), np.asarray(d))
    hit_agree = float(((id_cpu >= 0) == live).mean())
    both = (id_cpu >= 0) & live
    id_agree = float((id_cpu[both] == gx[both]).mean())
    same = both & (id_cpu == gx)
    cpu_rel = float((np.abs(t_cpu[same] - np.asarray(hx.t)[same])
                     / np.abs(t_cpu[same])).max())
    check(hit_agree >= 0.9999 and id_agree >= 0.995 and cpu_rel <= 1e-4,
          f"native reference: hit flags {hit_agree:.5f}, winners "
          f"{id_agree:.5f}, t {cpu_rel:.3g}")
    report("mesh", shape=f"{img_x.shape[1]}x{img_x.shape[0]}x1spp "
           f"tris={scene.static.n_triangles} depth={rx.cfg.max_depth}",
           setup_s=f"{build_s:.3f}",
           triton_compile_s=f"{first_k:.3f}", triton_median_s=f"{med_k:.4f}",
           xla_compile_s=f"{first_x:.3f}", xla_median_s=f"{med_x:.4f}",
           image_max_diff=f"{diff:.3g}", image_outliers=f"{frac:.4%}",
           primary_rays=len(gx), hit_rate=f"{live.mean():.3f}",
           winners_equal=True, t_max_rel=f"{t_rel:.3g}",
           native_hit_agree=f"{hit_agree:.5f}",
           native_winner_agree=f"{id_agree:.5f}")


def phase_pathtrace(seed):
    """GLSL scene 0 at 800x600, 64 spp, 10 bounces through render_pt; at
    80x60 and 16 spp with the same key, the image mean against the CPU
    backend's."""
    import jax
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.pathtracer import render_pt
    from distributionraytracer.scene.pt_scenes import scene0

    cfg = RenderConfig(max_bounces=10)
    key = jax.random.PRNGKey(seed)
    sc = jax.device_put(scene0())
    W, H, S = PT_FULL
    img, first, med = timed(lambda: render_pt(sc, cfg, W, H, key=key,
                                              spp=S))
    img = np.asarray(img)
    check(np.isfinite(img).all() and img.shape == (H, W, 3), "pt")
    w, h, s = PT_SMALL
    small = np.asarray(render_pt(sc, cfg, w, h, key=key, spp=s))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = np.asarray(render_pt(jax.device_put(scene0(), cpu), cfg, w, h,
                                   key=jax.device_put(key, cpu), spp=s))
    # same key, same arithmetic: only float rounding may flip a discrete
    # choice (scatter lobe, roulette) on a handful of the 76,800 paths
    dmean = float(np.abs(small.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
                  .max())
    check(dmean <= 5e-3, f"path tracer mean differs from CPU by {dmean:.3g}")
    report("pathtrace", shape=f"{W}x{H}x{S}spp bounces=10",
           compile_s=f"{first:.3f}", median_s=f"{med:.4f}",
           msamples_s=f"{W * H * S / med / 1e6:.2f}",
           cpu_mean_diff=f"{dmean:.3g}")


def _train_setup(seed, n_devices):
    import jax
    import jax.numpy as jnp
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator.render import (
        make_samples, render_from_samples,
    )
    from distributionraytracer.parallel.mesh import (
        make_device_mesh, make_sharded_train_step,
    )
    from distributionraytracer.scene.generate import generate

    scene = generate("balls_low", seed).device_put()
    cfg = RenderConfig(spp=4)
    samples = make_samples(scene, cfg, jax.random.PRNGKey(seed))
    target = jax.jit(lambda s: render_from_samples(s, cfg, samples))(
        dataclasses.replace(scene, mat_cd=scene.mat_cd * 0.7))
    mesh = make_device_mesh(n_devices)
    step = make_sharded_train_step(cfg, mesh,
                                   scene.static.res_y // n_devices, lr=1.0,
                                   update_leaves=("mat_cd",))
    return scene, samples, jnp.asarray(target), step


def _train(scene, samples, target, step, n_steps=3):
    """Run ``n_steps`` steps: (losses, final scene, first-step seconds
    incl. compile, median seconds of the later steps)."""
    import jax
    losses, s, times = [], scene, []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        loss, s = step(s, samples, target)
        losses.append(float(jax.block_until_ready(loss)))
        times.append(time.perf_counter() - t0)
    return losses, s, times[0], statistics.median(times[1:])


def phase_grad(seed):
    """make_sharded_train_step on a one-card mesh, balls_low at 512x512
    and 4 spp: three steps with finite gradients and a falling loss."""
    scene, samples, target, step = _train_setup(seed, 1)
    losses, s, first, med = _train(scene, samples, target, step)
    cd = np.asarray(s.mat_cd)
    check(np.isfinite(cd).all() and np.isfinite(losses).all(), "grad NaN")
    check(not np.array_equal(cd, np.asarray(scene.mat_cd)), "no update")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss not falling: {losses}")
    st = scene.static
    report("grad", shape=f"{st.res_x}x{st.res_y}x4spp mesh=1", steps=3,
           compile_s=f"{first:.3f}", median_step_s=f"{med:.4f}",
           losses=",".join(f"{x:.6g}" for x in losses))


def phase_four(seed):
    """Four cards: render_image_sharded of the mesh scene against the
    one-card Renderer, and the sharded train step against one card."""
    import jax
    from distributionraytracer.integrator.render import make_samples
    from distributionraytracer.parallel.mesh import (
        make_device_mesh, render_image_sharded,
    )
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene.generate import generate

    check(len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}")
    scene = generate("dragon_assignment1", seed)
    r = Renderer(scene)
    samples = make_samples(r.scene, r.cfg, jax.random.PRNGKey(seed))
    one, first1, med1 = timed(lambda: r.render_with_samples(samples))
    mesh = make_device_mesh(4)
    four, first4, med4 = timed(lambda: render_image_sharded(
        r.scene, r.cfg, mesh, samples=samples, accel=r.tables))
    diff, frac = images_close(np.asarray(four), np.asarray(one))
    report("four_render", shape=f"{scene.static.res_x}x"
           f"{scene.static.res_y}x1spp tris={scene.static.n_triangles}",
           route=r.route, one_compile_s=f"{first1:.3f}",
           one_median_s=f"{med1:.4f}", four_compile_s=f"{first4:.3f}",
           four_median_s=f"{med4:.4f}", max_diff=f"{diff:.3g}",
           outliers=f"{frac:.4%}")

    l1, s1, first1, med1 = _train(*_train_setup(seed, 1))
    l4, s4, first4, med4 = _train(*_train_setup(seed, 4))
    cd1, cd4 = np.asarray(s1.mat_cd), np.asarray(s4.mat_cd)
    rel = float(np.abs(np.array(l4) - np.array(l1)).max() / l1[0])
    check(all(b < a for a, b in zip(l4, l4[1:])), f"loss not falling {l4}")
    check(rel <= 1e-4 and np.allclose(cd4, cd1, rtol=1e-4, atol=1e-6),
          f"4-card train step differs from 1 card: loss rel {rel:.3g}, "
          f"mat_cd max diff {np.abs(cd4 - cd1).max():.3g}")
    report("four_grad", shape="balls_low 4spp", steps=3,
           one_compile_s=f"{first1:.3f}", one_median_step_s=f"{med1:.4f}",
           four_compile_s=f"{first4:.3f}", four_median_step_s=f"{med4:.4f}",
           loss_rel_diff=f"{rel:.3g}",
           losses=",".join(f"{x:.6g}" for x in l4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import distributionraytracer  # noqa: F401  (fails outside a checkout)

    name = card()
    print(f"card: {name}", flush=True)
    if args.four:
        phase_four(args.seed)
    else:
        for phase in (phase_whitted, phase_mesh, phase_pathtrace,
                      phase_grad):
            phase(args.seed)
    print(f"card: {name}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
