"""Share of the profiled slice's wall time in which no device operation
ran (the union of the operations' intervals, ``work.busy_us``), in %."""


def read(s):
    if not s.kernels or s.wall_s <= 0:
        return None
    return 100.0 * (s.wall_s - s.busy_s) / s.wall_s
