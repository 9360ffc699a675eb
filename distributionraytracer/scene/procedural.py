"""Built-in procedural scenes.

``create_random_scene`` mirrors ``Scene::create_random_scene``
(scene.cpp:742-815): the "Ray Tracing in One Weekend" final scene — ground
sphere, a 10x10 field of random diffuse/metal/glass spheres, three big
spheres and three white point lights, fixed 800x600 camera.  The reference
seeds ``rand()`` with the wall clock; here an explicit NumPy seed keeps it
reproducible.
"""

from __future__ import annotations

import numpy as np

from distributionraytracer.scene.builder import SceneBuilder
from distributionraytracer.scene.types import ACCEL_NONE, SceneData


def create_random_scene(seed: int = 0, res_x: int = 800,
                        res_y: int = 600) -> SceneData:
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.accel = ACCEL_NONE
    b.spp = 0
    b.bg_color = np.array([0.5, 0.7, 1.0], np.float32)
    b.set_camera(eye=[-5.312192, 4.456562, 11.963158], at=[0, 0, 0],
                 up=[0, 1, 0], fovy=40.0, hither=0.01, res_x=res_x,
                 res_y=res_y, aperture_ratio=0.0, focal_ratio=1.5)
    b.add_point_light([7, 10, -5], [1, 1, 1])
    b.add_point_light([-7, 10, -5], [1, 1, 1])
    b.add_point_light([0, 10, 7], [1, 1, 1])

    ground = b.add_material([0.5, 0.5, 0.5], 1.0, [0, 0, 0], 0.0, 10, 0, 1)
    b.add_sphere([0.0, -1000.0, 0.0], 1000.0, ground)

    for a in range(-5, 5):
        for c in range(-5, 5):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()],
                np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.4:  # diffuse
                m = b.add_material(rng.random(3), 1.0, [0, 0, 0], 0.0, 10, 0, 1)
            elif choose < 0.7:  # metal
                m = b.add_material([0, 0, 0], 0.0, rng.uniform(0.5, 1, 3),
                                   1.0, 220, 0, 1)
            else:  # glass
                m = b.add_material(rng.uniform(0.6, 1, 3), 0.0, [1, 1, 1],
                                   0.7, 20, 1, 1.5)
            b.add_sphere(center, 0.2, m)

    m = b.add_material([1, 1, 1], 0.0, [1, 1, 1], 0.7, 20, 1, 1.5)
    b.add_sphere([0, 1, 0], 1.0, m)
    m = b.add_material([0.4, 0.2, 0.1], 0.9, [1, 1, 1], 0.0, 10, 0, 1.0)
    b.add_sphere([-4, 1, 0], 1.0, m)
    m = b.add_material([0.4, 0.2, 0.1], 0.0, [0.7, 0.6, 0.5], 1.0, 220, 0, 1.0)
    b.add_sphere([4, 1, 0], 1.0, m)
    return b.build()
