#!/usr/bin/env python3
"""One traced run of one cell, as ``run.py --trace 1`` makes it, that also
reduces the program's spans in each process's traced window
(``fvbench/spans.py``): from the root of a checkout,

    python3 benchmark/trace_spans.py --workload <name> --seed <n> --seconds <s>

Standard output is ``run.py``'s; each process (each worker of a cell of
several) adds to standard error one line ``spans <json>``: its rank and the
reduction of its window.
"""
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)                       # fvbench, reference
sys.path.insert(1, os.path.dirname(_HERE))      # the program under test


def main(argv):
    from fvbench import cli, spans, trace
    reduced = []
    harness_events = trace.events

    def events(prof):
        # a cell's run (drivers/*.py) reduces its profile through trace.events:
        # read the profile here too
        reduced.append(spans.reduce(spans.events(prof)))
        return harness_events(prof)

    trace.events = events
    rc = cli.main(argv)
    rank = cli.parse(argv).worker_rank
    for r in reduced:
        print("spans " + json.dumps(dict(r or {}, rank=rank)), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(args if "--trace" in args else args + ["--trace", "1"]))
