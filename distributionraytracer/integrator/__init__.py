from distributionraytracer.integrator.whitted import trace_whitted  # noqa: F401
from distributionraytracer.integrator.render import render_image  # noqa: F401
