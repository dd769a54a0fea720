#!/usr/bin/env python3
"""Run one cell of the benchmark of fovvideovdp_tpu_torch once, from the
root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells are those of ``BENCHMARK.json``; see ``fvbench/cli.py`` for the
line it prints.
"""
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)                       # fvbench, reference
sys.path.insert(1, os.path.dirname(_HERE))      # the program under test

if __name__ == "__main__":
    from fvbench import cli
    sys.exit(cli.main())
