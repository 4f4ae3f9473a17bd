"""Run one cell of the benchmark once.

    python3 gcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is the result (see ``gcbench/harness.py``)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

if __name__ == "__main__":
    from gcbench import harness

    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
