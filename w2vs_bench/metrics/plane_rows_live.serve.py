"""Share of the cache rows the serving steps' attention reads (slots x the
rows of the visibility plane) that are visible to the slot's stream: the
program's counters ``serving.plane_rows_visible`` over
``serving.plane_rows_read``, in %.  Silent without the counters."""

from w2vs_bench import program_counters


def read(s):
    return program_counters.share("serving.plane_rows_visible",
                                  "serving.plane_rows_read")
