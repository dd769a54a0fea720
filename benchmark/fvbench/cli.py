"""One run of one cell:
``run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``.

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with the
reference beside its limit, which also end standard error.  Exits non-zero
and prints no result where the card or the cards the cell needs are not
there, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

# top-level modules that no run may load (compared whole: the port's own
# name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "fovvideovdp_tpu")


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a worker of a cell of several processes (started by the run itself)
    ap.add_argument("--worker-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--worker-port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _number(x: float) -> float:
    """JSON has no infinity: an infinite gap prints as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def end_to_end(readings: Dict[str, float], name: str) -> float:
    """The driver's reading of the end-to-end metric ``name``: under that
    name, or else under its part before the first dot, so that a cell may
    report a driver's reading under a name of its own
    (``pairs_per_s.4proc`` is ``pairs_per_s`` over four processes)."""
    return readings[name] if name in readings else readings[name.split(".")[0]]


def assemble(cell, out: Dict, tracing: bool) -> Dict:
    """The result's line from a driver's readings (see ``cells``)."""
    from fvbench import compare, registry
    correct, failed, compared = compare.judge(out["per_call"], cell.limits)
    metrics = {}
    if tracing:
        ctx = out["per_layer"]
        for m in cell.per_layer:
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(out["end_to_end"], m["name"]),
                                  "unit": m["unit"]}
    device = dict(out["device"])
    res = {"correct": correct, "attempted": out["attempted"], "failed": failed,
           "metrics": metrics, "device": device}
    if tracing:
        s = out["trace"]
        device["busy_s"], device["window_s"] = s.busy_s, s.window_s
        res["breakdown"] = {"device_ops": [list(x) for x in s.device_ops],
                            "idle_gaps": [list(x) for x in s.idle_gaps]}
    res["compared"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                       for k, v in compared.items()}
    return res


def power_limit() -> Optional[float]:
    """The card's power limit in W as nvidia-smi reads it, or None."""
    import subprocess
    # nvidia-smi numbers every card of the machine: name the run's first
    card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0].strip()
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                            "-i", card], capture_output=True, text=True, timeout=30)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    from fvbench import cells, registry
    started = cells.process_start()
    cell = registry.find_cell(args.workload)
    import torch
    need = 1 if args.worker_rank is not None else cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{cell.name} needs {need} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    tracing = bool(args.trace)
    device = cell.traffic.get("device", "cuda:0")
    run = registry.driver(cell.traffic["driver"])
    if args.worker_rank is not None:
        out = run(cell, args.seed, args.seconds, tracing, device, started,
                  args.worker_rank, args.worker_world, args.worker_port)
        found = banned_modules()
        if found:
            print(f"loaded in worker {args.worker_rank}: {found}", file=sys.stderr)
            return 3
        print(json.dumps(cells.worker_readings(out)), flush=True)
        return 0
    if int(cell.traffic.get("processes", 1)) > 1:
        out = cells.run_processes(cell, args.seed, args.seconds, tracing, started,
                                  [sys.executable, os.path.abspath(sys.argv[0])])
    else:
        out = run(cell, args.seed, args.seconds, tracing, device, started)
    found = banned_modules()
    if found:
        print(f"modules that no run may load were loaded: {found}", file=sys.stderr)
        return 3
    res = assemble(cell, out, tracing)
    res["device"]["power_limit_w"] = power_limit()
    print(f"notes {json.dumps(out.get('notes', {}))}", file=sys.stderr)
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
