"""Share of the decoders' emission-loop iterations (``max_emit`` a chunk,
run with masks) at whose start some stream was still unblocked: the
program's counters ``decoder.emit_iters_live`` over ``decoder.emit_iters``
(``stream/batched.count_emissions``, counted while the slices are
profiled), in %.  Silent without the counters (a program that does not
count them, or an untraced run)."""

from w2vs_bench import program_counters


def read(s):
    return program_counters.share("decoder.emit_iters_live",
                                  "decoder.emit_iters")
