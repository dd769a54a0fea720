"""``batch``: ``fvvdp.predict_batch`` of a whole image set, back to back.

Traffic keys read here:

* ``source``: ``"device"`` (the default: the set stays on the card) or
  ``"host"`` (the set in host memory, which ``predict_batch`` uploads a
  chunk at a time);
* ``device``: the metric's device (read by the harness, "cuda:0" by
  default); an unindexed "cuda" sends ``predict_batch`` over every
  visible card;
* ``metric``, ``call``: keyword arguments of ``fvvdp`` and of each call
  besides the display, the device, the pairs and their ``dim_order``;
* ``processes``, ``pairs``: one process per card, each scoring its own
  ``pairs // processes`` of the set, joined through
  ``parallel.init_multihost`` over gloo (``cells.run_processes`` starts
  them; each runs this driver with its ``rank``).

Readings: ``pairs_per_s`` and ``setup_s``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fvbench import cells, compare, content, readers, registry, trace
from fvbench.registry import Cell


def run(cell: Cell, seed: int, seconds: float, tracing: bool, device: str, started: float,
        rank: int = 0, world: int = 1, port: int = 0) -> Dict:
    import fovvideovdp_tpu_torch as fv
    from fovvideovdp_tpu_torch.ops.cuda import _lib
    from reference.fvvdp_plain import PlainFvvdp
    cfg, tr = cell.config, cell.traffic
    on_host = tr.get("source", "device") == "host"
    dev = torch.device(device)
    per = cells.pairs_per_process(cfg, tr)
    group = None
    if world > 1:
        import torch.distributed as dist
        from fovvideovdp_tpu_torch.parallel import multihost
        multihost.init_multihost(f"127.0.0.1:{port}", world, rank)
        group = dist
    notes = {"import_s": cells.now() - started}
    refs = content.image_refs(cfg, seed, dev)
    test, ref = content.image_pairs(cfg, refs, range(rank * per, (rank + 1) * per), seed)
    del refs
    if on_host:
        test, ref = test.cpu(), ref.cpu()
    cells.cuda(dev, "synchronize")
    notes["content_s"] = cells.now() - started
    metric = fv.fvvdp(display_name=cfg["display"]["name"], device=device,
                      **tr.get("metric", {}))
    call_opts = dict(tr.get("call", {}))
    notes["metric_s"] = cells.now() - started

    def call(i):
        jods, stats = metric.predict_batch(test, ref, dim_order=cfg["layout"], **call_opts)
        cells.cuda(dev, "synchronize")
        if stats.get("n_processes", 1) != world:
            raise RuntimeError(f"predict_batch ran over {stats.get('n_processes', 1)} "
                               f"processes, not {world}")
        return jods

    call(0)                                   # warm: the cell's one set of shapes
    notes["warm_s"] = cells.now() - started
    setup_peak = cells.cuda(dev, "max_memory_allocated")
    cells.cuda(dev, "reset_peak_memory_stats")
    base = cells.cuda(dev, "memory_allocated")
    _lib.reset_launch_counts()
    before_each = None
    if group is not None:
        group.barrier()

        def before_each(i, t0):
            # every process makes the same calls: rank 0's clock decides
            flag = torch.tensor([1 if (rank == 0 and cells.now() - t0 < seconds) else 0])
            group.broadcast(flag, src=0)
            return bool(flag.item())
    setup_s = cells.now() - started
    with cells.profiler(tracing) as prof:
        t0, t1, results, walls = cells.window(call, seconds, tracing, before_each)
    launches = _lib.launch_counts()
    window_peak = cells.cuda(dev, "max_memory_allocated")
    peak = max(setup_peak, window_peak)
    del metric, fv
    cells.free_program(dev)

    notes["call_ms_median"] = round(1e3 * float(np.median(walls)), 2) if walls else None
    pairs = len(results) * per
    out = {"attempted": len(results), "device": cells.device_info(dev, peak),
           "done": {"pairs": pairs}, "t0": t0, "t1": t1, "notes": notes}
    if tracing:
        summary = trace.summarise(trace.events(prof))
        del prof
        ctx = readers.Context([summary], registry.stages(), cells.work(cfg, tr),
                              calls=len(results), pairs=pairs, launches=launches,
                              step=tr.get("step"),
                              peak_bytes=window_peak - base if dev.type == "cuda" else None)
        out["per_layer"], out["trace"] = ctx, summary
    else:
        out["end_to_end"] = {"pairs_per_s": pairs / (t1 - t0), "setup_s": setup_s}
    cells.use_reference_precision()
    plain = PlainFvvdp(cfg, dev)
    out["per_call"] = compare.batch_call_gaps(results, plain.score_images(test.to(dev),
                                                                          ref.to(dev)))
    if group is not None:
        group.destroy_process_group()
    return out
