"""Share of the cache rows the serving steps' attention reads (slots x the
rows of the visibility plane) that the emission loop's jointer loads: the
program's counters ``serving.jointer_rows_loaded`` (the slots' extents
summed, once a step) over ``serving.plane_rows_read``, in %.  Silent
without the first counter (a program whose jointer reads the whole
plane)."""

from w2vs_bench import program_counters


def read(s):
    if "serving.jointer_rows_loaded" not in program_counters.snapshot():
        return None
    return program_counters.share("serving.jointer_rows_loaded",
                                  "serving.plane_rows_read")
