"""K1, the chunk attention over the encoder cache: the least time of every
call in the profiled slice (``work.k1_call`` from the call shapes, over
``work.bound_s``) over the device time of the kernels named
``chunk_attention``, in %.  Silent when no such kernel ran."""

from w2vs_bench import work


def read(s):
    t = s.device_s("chunk_attention")
    calls = s.work.get("k1_calls")
    if t <= 0 or not calls:
        return None
    return 100.0 * sum(work.bound_s(b, f) for b, f in calls) / t
