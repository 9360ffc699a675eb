"""Frame-time benchmark on the GPU; prints one JSON line.

    python bench.py [--scenes balls_low,dragon_assignment1] [--seed 0]
                    [--frames 3]

For each scene (generated from the seed by ``scene.generate`` at its
reference shape) the Renderer is built (set-up seconds), the first frame
is timed with its compilation, and then ``--frames`` frames are timed
(median).  ``rays`` counts every traced ray — primary and secondary
ray-tree nodes plus shadow rays — with the integrator's per-level
counters.  The line names the device; with no GPU the script exits
non-zero and prints no result.  The cell matrix, spread, trace-based
per-layer times and the peaks table belong to the benchmark proper.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

DEFAULT_SCENES = "balls_low,dragon_assignment1"


def measure_scene(name: str, seed: int, frames: int) -> dict:
    import jax
    from distributionraytracer.integrator.render import default_config
    from distributionraytracer.renderer import Renderer
    from distributionraytracer.scene.generate import generate

    scene = generate(name, seed)
    overrides = {"motion_blur": True} if name == "motion" else {}
    cfg = default_config(scene, **overrides)
    t0 = time.perf_counter()
    r = Renderer(scene, cfg)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    jax.block_until_ready(r.render(jax.random.PRNGKey(seed)))
    first_s = time.perf_counter() - t0
    times = []
    for i in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(r.render(jax.random.PRNGKey(seed + i + 1)))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    # the ray count comes from a separately compiled program, outside the
    # timed frames
    _, nrays = r.render(jax.random.PRNGKey(seed), return_rays=True)
    st = scene.static
    return {"scene": name, "route": r.route, "objects": st.n_objects,
            "res": [st.res_x, st.res_y], "spp": st.spp,
            "setup_s": setup_s, "first_frame_s": first_s,
            "frame_s": med, "frame_s_all": times, "rays": float(nrays),
            "mrays_s": float(nrays) / med / 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=DEFAULT_SCENES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()}", file=sys.stderr)
        return 1
    rows = [measure_scene(n, args.seed, args.frames)
            for n in args.scenes.split(",")]
    print(json.dumps({
        "metric": "frame_seconds_median",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "scenes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
