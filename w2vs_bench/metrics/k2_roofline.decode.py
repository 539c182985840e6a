"""K2, the block-sparse flash attention forward of the one-shot encoder:
the least time of every call in the profiled slice (``work.k2_call``) over
the device time of the kernels named ``flash_fwd`` or
``flash_attention_kernel``, in %.  Silent when no such kernel ran."""

from w2vs_bench import work


def read(s):
    t = s.device_s("flash_fwd", "flash_attention_kernel")
    calls = s.work.get("k2_calls")
    if t <= 0 or not calls:
        return None
    return 100.0 * sum(work.bound_s(b, f) for b, f in calls) / t
