"""Run one cell of the port's serving benchmark on the first card.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``README.md``); the numbers of the check, each beside its limit,
are the last lines of standard error.  Exits 2 without a result when the
host has no card, or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from servebench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
