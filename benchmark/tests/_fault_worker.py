"""A worker of the multi-process cell at a test's size on the CPU, with a
fault planted in the program when ``--fault`` names one.  Started by
``test_bench_faults.py`` through ``cells.run_processes``."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from conftest import small_cell, SMALL_SET  # noqa: E402  (sets sys.path too)

from fvbench import cells, cli, registry  # noqa: E402


def cell_of(name, world):
    return small_cell(name, traffic={"processes": world, "pairs": 50 * world}, **SMALL_SET)


def main():
    fault = sys.argv[1]
    args = cli.parse(sys.argv[2:])
    if fault == "exchange":
        from fovvideovdp_tpu_torch.parallel import multihost
        multihost.replicate_to_hosts = lambda x, axis=0: x.detach().cpu().contiguous()
    cell = cell_of(args.workload, args.worker_world)
    out = registry.driver(cell.traffic["driver"])(
        cell, args.seed, args.seconds, False, "cpu", cells.process_start(),
        args.worker_rank, args.worker_world, args.worker_port)
    print(json.dumps(cells.worker_readings(out)), flush=True)


if __name__ == "__main__":
    main()
