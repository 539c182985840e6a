"""Run one benchmark cell once and print its result line.

    python3 -m w2vs_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (the program ``wav2vec_s_tpu_torch`` beside
this folder).  See ``README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402

from w2vs_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
