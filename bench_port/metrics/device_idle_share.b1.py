"""The device's idle share of the stretch, in %: 1 - (the union of its
operations in the profiled stretch) / (the wall time of the unprofiled
stretch of the same units).  The profiler's own host cost lengthens the
profiled stretch, so its wall is not the base."""


def read(rec):
    return 100.0 * (1.0 - rec.trace.busy_s / rec.wall_s)
