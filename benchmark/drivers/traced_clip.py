"""``traced_clip``: the metric as a training loss, forward and backward of
whole clips back to back, the resident pairs in turn.

Each pair is made on the card by ``content.clip_pair`` and held as
display-encoded float32 in [0, 1] (the uint8 codes over 255): the test clip
a leaf that requires a gradient, as a network's output would be, the
reference clip detached.  A call clears the test clip's gradient, runs
``fvvdp.loss(test, ref, dim_order=<layout>, frames_per_second=<fps>)`` and
its ``backward()``, takes the gradient's norm on the card (the call's
fingerprint, ``compare_grad.norm``) and synchronises.  Traffic keys read
here: ``metric``, keyword arguments of ``fvvdp`` besides the display and
the device (not foveated: the reference scores no gaze).

Readings: ``frames_per_s`` (the frames of each call, forward and backward),
``clip_p95_ms`` (each call's wall time) and ``setup_s``; traced, the
per-layer readers get a ``span_context.SpanContext`` with the program's
spans, and ``vjp_counts``: the backwards and recompute chunks of the
window per kernel wrapper (``ops.cuda._autograd.vjp_counts``), or None where
the program has no such counter.

After the window the reference (``reference/fvvdp_plain_grad.py``) gives
each pair's JOD and gradient, and ``compare_grad`` holds every call to them:
the JOD and the gradient's norm of each call, the whole gradient of each
pair's last call, which the test clip still holds.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fvbench import cells, compare_grad, content, registry, span_context, spans, trace
from fvbench.registry import Cell


def run(cell: Cell, seed: int, seconds: float, tracing: bool, device: str, started: float,
        rank: int = 0, world: int = 1, port: int = 0) -> Dict:
    if world != 1:
        raise ValueError(f"the traced_clip driver runs in one process, not {world}")
    import fovvideovdp_tpu_torch as fv
    from fovvideovdp_tpu_torch.ops.cuda import _autograd
    from reference.fvvdp_plain_grad import PlainFvvdpGrad
    cfg, tr = cell.config, cell.traffic
    opts = dict(tr.get("metric", {}))
    if opts.get("foveated") or tr.get("gaze"):
        raise ValueError("the traced_clip driver scores without foveation")
    dev = torch.device(device)
    n = int(cfg["pairs"])
    notes = {"import_s": cells.now() - started}
    tests, refs = [], []
    for k in range(n):
        t, r = content.clip_pair(cfg, k, seed, dev)
        tests.append(t.to(torch.float32).div_(255.0).requires_grad_(True))
        refs.append(r.to(torch.float32).div_(255.0))
        del t, r
    cells.cuda(dev, "synchronize")
    notes["content_s"] = cells.now() - started
    metric = fv.fvvdp(display_name=cfg["display"]["name"], device=device, **opts)
    notes["metric_s"] = cells.now() - started
    # the program's counter of backwards and recompute chunks, where it has one
    read_counts = getattr(_autograd, "vjp_counts", None)
    reset_counts = getattr(_autograd, "reset_vjp_counts", None)

    def call(i):
        k = i % n
        x = tests[k]
        x.grad = None
        loss = metric.loss(x, refs[k], dim_order=cfg["layout"], frames_per_second=cfg["fps"])
        loss.backward()
        fingerprint = compare_grad.norm(x.grad)
        cells.cuda(dev, "synchronize")
        return k, loss.detach(), fingerprint

    call(0)                                   # warm: the cell's one set of shapes
    notes["warm_s"] = cells.now() - started
    setup_peak = cells.cuda(dev, "max_memory_allocated")
    cells.cuda(dev, "reset_peak_memory_stats")
    base = cells.cuda(dev, "memory_allocated")
    if reset_counts is not None:
        reset_counts()
    setup_s = cells.now() - started
    with cells.profiler(tracing) as prof:
        t0, t1, results, walls = cells.window(call, seconds, tracing)
    vjp_counts = read_counts() if read_counts is not None else None
    window_peak = cells.cuda(dev, "max_memory_allocated")
    peak = max(setup_peak, window_peak)
    del metric, fv
    cells.free_program(dev)

    calls = [(k, 10.0 - float(loss), float(fp)) for k, loss, fp in results]
    frames = len(results) * cfg["frames"]
    notes["call_ms_by_pair"] = [round(1e3 * float(np.median(walls[k::n])), 2)
                                for k in range(n) if walls[k::n]]
    notes["jod_by_pair"] = {k: j for k, j, _ in calls[:n]}
    out = {"attempted": len(results), "device": cells.device_info(dev, peak),
           "done": {"frames": frames}, "t0": t0, "t1": t1, "notes": notes}
    if tracing:
        evs = spans.events(prof)
        summary = trace.summarise(trace.events(prof))
        del prof
        ctx = span_context.SpanContext(
            [summary], registry.stages(), cells.work(cfg, tr), calls=len(results),
            frames=frames, step=tr.get("step"),
            peak_bytes=window_peak - base if dev.type == "cuda" else None,
            spans=[spans.reduce(evs)])
        ctx.vjp_counts = vjp_counts
        del evs
        out["per_layer"], out["trace"] = ctx, summary
    else:
        out["end_to_end"] = {"frames_per_s": frames / (t1 - t0),
                             "clip_p95_ms": 1e3 * float(np.percentile(walls, 95)),
                             "setup_s": setup_s}
    cells.use_reference_precision()
    plain = PlainFvvdpGrad(cfg, dev)
    called = sorted({k for k, _, _ in calls})
    ref = {k: compare_grad.Reference(*plain.jod_and_grad(tests[k], refs[k], cfg["fps"]))
           for k in called}
    out["per_call"] = compare_grad.call_gaps(calls, ref, {k: tests[k].grad for k in called})
    return out
