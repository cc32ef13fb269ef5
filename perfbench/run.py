"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs a CUDA device: without one (or
with fewer than the cell asks for) it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout, not perfbench/
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
