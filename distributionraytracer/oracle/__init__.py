from distributionraytracer.oracle.oracle import oracle_render, oracle_trace  # noqa: F401
