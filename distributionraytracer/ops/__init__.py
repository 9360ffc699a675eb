from distributionraytracer.ops.common import EPSILON, dot, normalize, safe_normalize  # noqa: F401
