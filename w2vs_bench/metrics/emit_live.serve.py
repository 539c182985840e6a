"""Share of the serving steps' emission-loop iterations (``max_emit`` a
step, run with masks) at whose start some fired slot was still unblocked:
the program's counters ``serving.emit_iters_live`` over
``serving.emit_iters``, in %.  Silent without the counters."""

from w2vs_bench import program_counters


def read(s):
    return program_counters.share("serving.emit_iters_live",
                                  "serving.emit_iters")
