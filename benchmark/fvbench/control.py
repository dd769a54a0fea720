"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the nearest precision below the float32
that the configurations state, held against the float32 reference on the
content of a cell at the cell's own size.  Its gaps are the upper
readings the limits in ``limits/`` are set below (PERF.md gives them).

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line per seed: the cell's compared numbers, as
``compare`` computes them for the program.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from fvbench import cells, compare, content, registry


def readings(cell: registry.Cell, seed: int, device: str, dtype=torch.bfloat16) -> Dict:
    """The compared numbers of the reference in ``dtype`` against the
    float32 reference, on the cell's content for ``seed``: every clip pair
    once, or every pair of the process-0 share of an image set."""
    from reference.fvvdp_plain import PlainFvvdp
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    ref32, low = PlainFvvdp(cfg, dev), PlainFvvdp(cfg, dev, dtype)
    if cfg["kind"] == "clip":
        got, want = [], {}
        for k in range(int(cfg["pairs"])):
            t, r = content.clip_pair(cfg, k, seed, dev)
            g = content.gaze_path(cfg, tr["gaze"], k, seed) if tr.get("gaze") else None
            want[k] = ref32.score_clip(t, r, cfg["fps"], g)
            got.append((k,) + low.score_clip(t, r, cfg["fps"], g))
            del t, r
        per_call = compare.clip_call_gaps(got, want)
    else:
        per = cells.pairs_per_process(cfg, tr)
        refs = content.image_refs(cfg, seed, dev)
        t, r = content.image_pairs(cfg, refs, range(per), seed)
        per_call = compare.batch_call_gaps([low.score_images(t, r)], ref32.score_images(t, r))
    return {k: max(g[k] for g in per_call) for k in per_call[0]}


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
