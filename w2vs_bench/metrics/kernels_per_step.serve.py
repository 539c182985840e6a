"""Device operations in the profiled slice per serving step."""


def read(s):
    steps = s.work.get("steps")
    return len(s.kernels) / steps if steps and s.kernels else None
