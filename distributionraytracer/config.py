"""Render configuration.

The reference drives these knobs from compile-time flags and the P3F scene
file (main.cpp:29-39, scene.cpp:489-693).  Here they live in one dataclass.
All fields are static (hashable) so the config can be closed over by ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs of a render.

    Mirrors the reference's flag set:

    - ``max_depth``:      ``#define MAX_DEPTH 4`` (main.cpp:34).
    - ``spp``:            samples per pixel; ``0`` selects the no-AA branch
                          (main.cpp:674-703), ``>0`` the stratified-jitter AA
                          branch (main.cpp:618-671).
    - ``dof``:            thin-lens lens sampling (main.cpp:655-660).
    - ``motion_blur``:    per-sample time jitter + moving sphere centers
                          (main.cpp:549-551, scene.cpp:158-162).
    - ``max_samples``:    progressive-mode cap, ``MAX_SAMPLES`` (main.cpp:39).
    - ``shadow_mode``:    'reference' reproduces the reference's per-accel
                          shadow-distance conventions, including the quirk
                          that NONE and GRID compare against a normalized
                          direction (length 1.0, main.cpp:411-440); 'correct'
                          uses the true light distance everywhere.
    - ``tile_rays``:      wavefront tile size (pixel-samples per kernel
                          launch).  Purely a performance knob.
    """

    max_depth: int = 4
    spp: int = 0
    # Drop statically-dead ray-tree subtrees (no T==1 material => no
    # refraction subtree; no Ks>0 material => no reflection subtree).  Bit
    # identical to the full tree because the per-lane spawn masks are implied
    # by the same material facts; disable when *training* materials across
    # the T==1 / Ks>0 boundaries (scene.types.SceneStatic.any_refr).
    static_prune: bool = True
    # BVH traversal route (routing.select_route): 'auto' takes the
    # per-ray Triton walk (accel.bvh_kernel) on a GPU and the batched XLA
    # traversal on the CPU; 'xla' forces the XLA traversal, the
    # differentiable one — training forces it.
    accel_backend: str = "auto"  # 'auto' | 'xla'
    dof: bool = False
    motion_blur: bool = False
    # Discontinuity-aware shadow gradients (SURVEY §7 step 9): 0 keeps the
    # reference's hard boolean shadow gate (main.cpp:383-451); > 0 replaces
    # it with a sigmoid-relaxed visibility of that width (world units) so
    # expected pixel gradients at shadow edges match finite differences
    # (ops.intersect.soft_visibility).  Opt-in, training-time only: the
    # forward image softens within ~tau of shadow boundaries.
    soft_shadow: float = 0.0
    # Primary-silhouette relaxation width (world units): > 0 blends each
    # pixel with its "winner removed" counterfactual by the winner's smooth
    # coverage (integrator.whitted.trace_whitted_soft), so expected
    # gradients at hit-vs-miss silhouette edges match finite differences.
    # Training-time opt-in, ~2x forward cost; brute-force path only.
    soft_silhouette: float = 0.0
    # Live-lane compaction for accel-traversal queries: stable-partition
    # every masked closest/shadow query so live lanes come first and
    # all-dead ray blocks exit their traversal immediately
    # (integrator.whitted.compacting_intersectors).  Output-identical; the
    # partition costs about 14 R-lane gathers per query, so it pays only
    # where deep ray-tree levels are mostly dead.  Off by default.
    compact_lanes: bool = False
    max_samples: int = 10000
    shadow_mode: str = "reference"  # 'reference' | 'correct'
    tile_rays: int = 65536
    # Tile size (lanes per lax.map step) of the batched XLA grid/BVH
    # traversals: bounds the while-loop state each step carries.
    accel_tile_rays: int = 16384
    # Path-tracer knobs (P3D_RT.glsl:581, 739)
    max_bounces: int = 10
    russian_roulette: bool = True
    # Path-tracer wavefront tile (rays per lax.map step inside render_pt).
    # Caps live device memory at O(tile x primitives): untiled, the
    # reference harness shape (800x600 at 64 spp) would hold every
    # (ray, primitive) temporary of the frame at once.  0 = no tiling.
    pt_tile_rays: int = 131072

    def __post_init__(self):
        if self.shadow_mode not in ("reference", "correct"):
            raise ValueError(f"bad shadow_mode: {self.shadow_mode}")
        if self.accel_backend not in ("auto", "xla"):
            raise ValueError(f"bad accel_backend: {self.accel_backend}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
