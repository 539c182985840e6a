"""Share of the decoders' emission-loop iterations (``max_emit`` a chunk)
whose chunk replayed its loop from a CUDA graph: the program's counters
``decoder.emit_iters_graphed`` over ``decoder.emit_iters``
(``stream/batched.py``, counted while the slices are profiled), in %.
Silent without the first counter (a program that does not count it, or an
untraced run)."""

from w2vs_bench import program_counters

PART = "decoder.emit_iters_graphed"


def read(s):
    if PART not in program_counters.snapshot():
        return None
    return program_counters.share(PART, "decoder.emit_iters")
