"""Model FLOPs of the streams decoded in the profiled slice
(``served.decode_flops``: ``served.chunk_flops`` summed over each stream's
chunks, as ``mfu.serve`` counts them) over the slice's wall time times the
bf16 peak of one H100, in %."""

from w2vs_bench import work


def read(s):
    flops = s.work.get("model_flops")
    if not flops or not s.kernels:
        return None
    return 100.0 * flops / (s.wall_s * work.PEAK_FLOPS_BF16)
