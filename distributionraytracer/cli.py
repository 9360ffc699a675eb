"""Command-line app shell: the equivalent of main.cpp's batch/console UI.

The reference prompts for a P3F name, renders, writes RT_Output.png and
prints the wall-clock (main.cpp:968-1111).  Here:

    python -m distributionraytracer render balls_low \
        -o RT_Output.png [--spp N] [--motion-blur] [--progressive N]

where the scene is a P3F path, a generated deployment name
(``scene.generate.SCENES``, from ``--seed``) or ``random``.

    python -m distributionraytracer pathtrace --scene 0 -o pt.png \
        --res 800 600 --spp 64 [--bounces 10]
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_render(args):
    import jax
    import numpy as np
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene.generate import scene_from_spec
    from distributionraytracer.utils.image import write_png

    # 'random' is the reference's P3F_scene=false path (main.cpp:996-1001)
    scene = scene_from_spec(args.scene, args.seed)
    if args.res:
        import dataclasses
        scene = dataclasses.replace(
            scene, static=dataclasses.replace(
                scene.static, res_x=args.res[0], res_y=args.res[1]))
    print(f"Resolution {scene.static.res_x}x{scene.static.res_y}, "
          f"spp={scene.static.spp}, accel={scene.static.accel}, "
          f"objects={scene.static.n_objects}, lights={scene.static.n_lights}")
    from distributionraytracer.integrator.render import default_config
    cfg = default_config(scene)
    if args.spp is not None:
        cfg = cfg.replace(spp=args.spp)
    if args.motion_blur:
        cfg = cfg.replace(motion_blur=True)
    key = jax.random.PRNGKey(args.seed)
    if args.sharded:
        # pixel-row DP over every visible device (all hosts' cards when
        # launched under maybe_init_distributed) with the accel tables
        # replicated — the multi-device analog of main.cpp:603's OpenMP loop
        from distributionraytracer.parallel.mesh import (
            make_device_mesh, render_image_sharded,
        )
        from distributionraytracer.renderer import build_accel
        scene = scene.device_put()
        ab = build_accel(scene, verbose=True)
        mesh = make_device_mesh()
        print(f"mesh: {mesh.devices.size} devices")
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cfg, mesh, key=key,
                                   accel=ab.tables,
                                   grid_unroll=ab.grid_unroll)
        jax.block_until_ready(img)
        print(f"sharded render: {time.perf_counter() - t0:.3f}s")
        write_png(args.output, np.asarray(img))
        print(f"Image file created: {args.output}")
        return
    r = Renderer(scene, cfg, verbose=True)

    if args.progressive:
        state = r.progressive_init()
        t0 = time.perf_counter()
        for i in range(args.progressive):
            state = r.progressive_step(state, jax.random.fold_in(key, i))
        img = np.asarray(state[0])
        jax.block_until_ready(state[0])
        dt = time.perf_counter() - t0
        print(f"progressive {args.progressive} frames: {dt:.3f}s")
    else:
        t0 = time.perf_counter()
        img = r.render(key)
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        print(f"Whitted/distribution render: {dt:.3f}s")
        img = np.asarray(img)
    write_png(args.output, img)
    print(f"Image file created: {args.output}")


def _cmd_view(args):
    import dataclasses
    from distributionraytracer.integrator.render import default_config
    from distributionraytracer.scene.generate import scene_from_spec
    from distributionraytracer.viewer import serve, serve_pt

    if args.pt:
        from distributionraytracer.config import RenderConfig
        cfg = RenderConfig(max_bounces=args.bounces)
        serve_pt(args.pt_scene, cfg, port=args.port,
                 res=tuple(args.res) if args.res else (400, 300),
                 cubemap=args.cubemap, chunk_spp=args.spp or 1)
        return
    if args.scene is None:
        raise SystemExit(
            "view: a scene path or name is required unless --pt is given")
    scene = scene_from_spec(args.scene)
    if args.res:
        scene = dataclasses.replace(
            scene, static=dataclasses.replace(
                scene.static, res_x=args.res[0], res_y=args.res[1]))
    cfg = default_config(scene)
    if args.spp is not None:
        cfg = cfg.replace(spp=args.spp)
    serve(scene, cfg, port=args.port)


def _cmd_pathtrace(args):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.integrator import pathtracer as PT
    from distributionraytracer.scene.generate import pt_scene
    from distributionraytracer.utils.image import write_png

    scene = pt_scene(args.scene, args.seed, args.cubemap).device_put()
    cfg = RenderConfig(max_bounces=args.bounces)

    # default orbit camera per scene (P3D_RT.glsl:687-735 defaults)
    if args.scene == 0:
        eye, at = [6.0, 1.6, -6.0], [0.0, 0.5, 0.0]
    elif args.scene == 4:
        eye, at = [0.0, -1.0, -2.0], [0.0, -1.0, 10.0]
    else:
        eye, at = [0.0, -3.0, -6.0], [0.0, -3.0, 10.0]
    if args.eye:
        eye = args.eye
    if args.at:
        at = args.at

    t0 = time.perf_counter()
    img = PT.render_pt(
        scene, cfg, args.res[0], args.res[1],
        key=jax.random.PRNGKey(args.seed),
        eye=np.array(eye, np.float32), at=np.array(at, np.float32),
        spp=args.spp)
    jax.block_until_ready(img)
    print(f"path trace: {time.perf_counter() - t0:.3f}s "
          f"({args.res[0]}x{args.res[1]} @ {args.spp}spp, "
          f"{cfg.max_bounces} bounces)")
    write_png(args.output, np.asarray(PT.to_gamma(img)))
    print(f"Image file created: {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="distributionraytracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="Whitted/distribution render of a P3F "
                       "scene, or of the built-in Shirley scene "
                       "(scene name 'random')")
    r.add_argument("scene", help="path to a .p3f file, a generated "
                   "deployment name (e.g. balls_low, dragon_assignment1), "
                   "or 'random' for the built-in Ray-Tracing-in-One-Weekend "
                   "scene")
    r.add_argument("-o", "--output", default="RT_Output.png")
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--res", type=int, nargs=2, default=None,
                   help="override scene resolution")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--motion-blur", action="store_true")
    r.add_argument("--progressive", type=int, default=0, metavar="FRAMES")
    r.add_argument("--sharded", action="store_true",
                   help="shard pixel rows over all devices (multi-host "
                        "when DRT_COORDINATOR/DRT_DISTRIBUTED is set)")
    r.set_defaults(fn=_cmd_render)

    v = sub.add_parser("view", help="interactive progressive viewer "
                                    "(orbit camera, browser UI)")
    v.add_argument("scene", nargs="?", default=None,
                   help="P3F path or generated scene name (Whitted "
                        "mode); omit with --pt")
    v.add_argument("--port", type=int, default=8765)
    v.add_argument("--res", type=int, nargs=2, default=None)
    v.add_argument("--spp", type=int, default=None,
                   help="Whitted: batch spp; --pt: spp per frame chunk")
    v.add_argument("--pt", action="store_true",
                   help="interactive progressive PATH TRACER "
                        "(P3D_RT.html harness parity)")
    v.add_argument("--pt-scene", type=int, default=0, choices=range(5),
                   help="GLSL scene id for --pt")
    v.add_argument("--bounces", type=int, default=10)
    v.add_argument("--cubemap", default=None)
    v.set_defaults(fn=_cmd_view)

    t = sub.add_parser("pathtrace", help="Monte Carlo path trace (GLSL scenes 0-4)")
    t.add_argument("--scene", type=int, default=0, choices=range(5))
    t.add_argument("-o", "--output", default="PT_Output.png")
    t.add_argument("--res", type=int, nargs=2, default=[800, 600])
    t.add_argument("--spp", type=int, default=16)
    t.add_argument("--bounces", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--cubemap", default=None,
                   help="skybox dir with right/left/top/bottom/front/back "
                        ".png or .jpg (default: generated from --seed)")
    t.add_argument("--eye", type=float, nargs=3, default=None)
    t.add_argument("--at", type=float, nargs=3, default=None)
    t.set_defaults(fn=_cmd_pathtrace)

    args = p.parse_args(argv)
    # multi-host: must run before the first backend query
    from distributionraytracer.parallel.mesh import maybe_init_distributed
    maybe_init_distributed(verbose=True)
    args.fn(args)


if __name__ == "__main__":
    main()
