#!/usr/bin/env python3
"""The benchmark of the port (sniffles_tpu_torch) on one H100: one run of
one cell of BENCHMARK.json (benchmark/harness.py says what a run does).

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
