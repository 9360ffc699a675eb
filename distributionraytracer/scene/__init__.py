from distributionraytracer.scene.types import (  # noqa: F401
    SceneData,
    SceneStatic,
    CameraParams,
    ACCEL_NONE,
    ACCEL_GRID,
    ACCEL_BVH,
    OBJ_SPHERE,
    OBJ_TRIANGLE,
    OBJ_PLANE,
    OBJ_BOX,
)
from distributionraytracer.scene.p3f import load_p3f  # noqa: F401
from distributionraytracer.scene.builder import SceneBuilder  # noqa: F401
from distributionraytracer.scene.procedural import create_random_scene  # noqa: F401
