"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``icebergs_tpu_torch``)
on a machine with the cards the cell asks for.  The last line of
standard output is the JSON result; the last lines of standard error are
the numbers compared with the reference, each beside its limit.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this folder: the package and the port
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
