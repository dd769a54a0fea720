#!/usr/bin/env python3
"""The control of ``correct`` in the cells of the metric as a training loss:
the plain reference with its gradient (``reference/fvvdp_plain_grad.py``)
put in the program's place and computed in bfloat16, against the float32
reference, on the content of a cell at the cell's own size.  Its gaps are
the upper readings the limits of those cells are set below (PERF.md gives
them); ``control.py`` does the same for the cells that score without a
gradient.

    python3 benchmark/control_traced.py --workload traced-4k-clip --seeds <n> [<n> ...]

prints one JSON line per seed: the cell's compared numbers, as
``compare_grad`` computes them for the program, every gradient compared in
full.
"""
import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(1, os.path.dirname(_HERE))

import torch  # noqa: E402

from fvbench import compare_grad, content, registry  # noqa: E402


def readings(cell: registry.Cell, seed: int, device: str, dtype=torch.bfloat16) -> dict:
    """The compared numbers of the reference in ``dtype`` against the
    float32 reference, every clip pair of the cell's content once."""
    from reference.fvvdp_plain_grad import PlainFvvdpGrad
    cfg = cell.config
    dev = torch.device(device)
    ref32, low = PlainFvvdpGrad(cfg, dev), PlainFvvdpGrad(cfg, dev, dtype)
    worst = {"jod_gap": 0.0, "grad_gap": 0.0, "grad_max_gap": 0.0}
    for k in range(int(cfg["pairs"])):
        t, r = content.clip_pair(cfg, k, seed, dev)
        t, r = t.to(torch.float32).div_(255.0), r.to(torch.float32).div_(255.0)
        want = compare_grad.Reference(*ref32.jod_and_grad(t, r, cfg["fps"]))
        jod, grad = low.jod_and_grad(t, r, cfg["fps"])
        got = compare_grad.call_gaps([(k, jod, float(compare_grad.norm(grad)))], {k: want},
                                     {k: grad})[0]
        worst = {name: max(v, got[name]) for name, v in worst.items()}
        del t, r, want, grad
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.find_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "bfloat16",
                          "readings": r, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
