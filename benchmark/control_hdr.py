#!/usr/bin/env python3
"""The control of ``correct`` in the HDR10 Y'CbCr cells: the plain HDR
reference (``reference/fvvdp_plain_hdr.py``) put in the program's place and
computed in bfloat16, against the float32 reference, on the content of a
cell at the cell's own size.  Its gaps are the upper readings the limits of
those cells are set below (PERF.md gives them); ``control.py`` does the same
for the other cells.

    python3 benchmark/control_hdr.py --workload hdr10-4k-yuv --seeds <n> [<n> ...]

prints one JSON line per seed: the cell's compared numbers, as ``compare``
computes them for the program.
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

from fvbench import compare, hdr_content, registry  # noqa: E402


def readings(cell: registry.Cell, seed: int, device: str, dtype=torch.bfloat16) -> dict:
    """The compared numbers of the HDR reference in ``dtype`` against the
    float32 reference, every clip pair of the cell's content once."""
    from reference.fvvdp_plain_hdr import PlainFvvdpHDR
    cfg = cell.config
    dev = torch.device(device)
    ref32, low = PlainFvvdpHDR(cfg, dev), PlainFvvdpHDR(cfg, dev, dtype)
    got, want = [], {}
    for k in range(int(cfg["pairs"])):
        t, r = hdr_content.clip_pair(cfg, k, seed, dev)
        want[k] = ref32.score_clip(t, r, cfg["fps"])
        got.append((k,) + low.score_clip(t, r, cfg["fps"]))
        del t, r
    per_call = compare.clip_call_gaps(got, want)
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


if __name__ == "__main__":
    sys.exit(main())
