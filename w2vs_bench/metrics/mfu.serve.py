"""Model FLOPs of the chunks the serving steps of the profiled slice ran
(``served.chunk_flops`` per chunk: front-end, encoder over allowed pairs,
jointer, LM, vocabulary projection; the count ``mfu.decode`` sums over a
stream's chunks) over the slice's wall time times the bf16 peak of one
H100, in %."""

from w2vs_bench import work


def read(s):
    flops = s.work.get("model_flops")
    if not flops or not s.kernels:
        return None
    return 100.0 * flops / (s.wall_s * work.PEAK_FLOPS_BF16)
