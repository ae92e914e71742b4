"""python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>: one run of one cell of BENCHMARK.json on the card."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
