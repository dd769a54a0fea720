"""``clip``: whole clips scored back to back, the resident pairs in turn.

Traffic keys read here:

* ``source``: ``"device"`` (the default: the clips stay on the card, each
  pair in a ``fvvdp_video_source_array`` built in set-up, each call a
  ``fvvdp.predict_video_source``) or ``"host"`` (the clips as numpy
  arrays in host memory, each call a ``fvvdp.predict``, which uploads
  them);
* ``metric``: keyword arguments of ``fvvdp`` besides the display and the
  device, such as ``foveated`` or ``heatmap``;
* ``call``: keyword arguments of each call besides the clip and the gaze;
* ``gaze``: a gaze path per clip (``content.gaze_path``), or null; a
  foveated metric needs one, as the reference foveates exactly where it
  is given a gaze.

Readings: ``frames_per_s``, ``clip_p95_ms`` (each call's wall time, ending
in a device synchronise) and ``setup_s``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fvbench import cells, compare, content, readers, registry, trace
from fvbench.registry import Cell


def run(cell: Cell, seed: int, seconds: float, tracing: bool, device: str, started: float,
        rank: int = 0, world: int = 1, port: int = 0) -> Dict:
    if world != 1:
        raise ValueError(f"the clip driver runs in one process, not {world}")
    import fovvideovdp_tpu_torch as fv
    from fovvideovdp_tpu_torch.ops.cuda import _lib
    from reference.fvvdp_plain import PlainFvvdp
    cfg, tr = cell.config, cell.traffic
    opts, call_opts = dict(tr.get("metric", {})), dict(tr.get("call", {}))
    on_host = tr.get("source", "device") == "host"
    if bool(opts.get("foveated", False)) != bool(tr.get("gaze")):
        raise ValueError("a foveated metric, and only one, is given a gaze path")
    dev = torch.device(device)
    n = int(cfg["pairs"])
    notes = {"import_s": cells.now() - started}
    pairs = [content.clip_pair(cfg, k, seed, dev) for k in range(n)]
    cells.cuda(dev, "synchronize")
    notes["content_s"] = cells.now() - started
    gaze = [content.gaze_path(cfg, tr["gaze"], k, seed) if tr.get("gaze") else None
            for k in range(n)]
    metric = fv.fvvdp(display_name=cfg["display"]["name"], device=device, **opts)
    if on_host:
        host = [(t.cpu().numpy(), r.cpu().numpy()) for t, r in pairs]
        del pairs

        def score(k):
            return metric.predict(host[k][0], host[k][1], dim_order=cfg["layout"],
                                  frames_per_second=cfg["fps"], fixation_point=gaze[k],
                                  **call_opts)
    else:
        sources = [fv.fvvdp_video_source_array(t, r, cfg["fps"], dim_order=cfg["layout"],
                                               display_photometry=metric.display_photometry,
                                               color_space_name=cfg["color_space"],
                                               device=device)
                   for t, r in pairs]

        def score(k):
            return metric.predict_video_source(sources[k], fixation_point=gaze[k], **call_opts)

    notes["metric_s"] = cells.now() - started

    def call(i):
        k = i % n
        q, stats = score(k)
        cells.cuda(dev, "synchronize")
        return k, q, stats["Q_per_ch"]

    call(0)                                   # warm: the cell's one set of shapes
    notes["warm_s"] = cells.now() - started
    setup_peak = cells.cuda(dev, "max_memory_allocated")
    cells.cuda(dev, "reset_peak_memory_stats")
    base = cells.cuda(dev, "memory_allocated")
    _lib.reset_launch_counts()
    setup_s = cells.now() - started
    with cells.profiler(tracing) as prof:
        t0, t1, results, walls = cells.window(call, seconds, tracing)
    launches = _lib.launch_counts()
    window_peak = cells.cuda(dev, "max_memory_allocated")
    peak = max(setup_peak, window_peak)
    del score, metric, fv
    if not on_host:
        del sources
    cells.free_program(dev)

    frames = len(results) * cfg["frames"]
    notes["call_ms_by_pair"] = [round(1e3 * float(np.median(walls[k::n])), 2) for k in range(n)]
    notes["call_ms_max_by_pair"] = [round(1e3 * float(np.max(walls[k::n])), 2) for k in range(n)]
    out = {"attempted": len(results), "device": cells.device_info(dev, peak),
           "done": {"frames": frames}, "t0": t0, "t1": t1, "notes": notes}
    if tracing:
        summary = trace.summarise(trace.events(prof))
        del prof
        ctx = readers.Context([summary], registry.stages(), cells.work(cfg, tr),
                              calls=len(results), frames=frames, launches=launches,
                              step=tr.get("step"),
                              peak_bytes=window_peak - base if dev.type == "cuda" else None)
        out["per_layer"], out["trace"] = ctx, summary
    else:
        out["end_to_end"] = {"frames_per_s": frames / (t1 - t0),
                             "clip_p95_ms": 1e3 * float(np.percentile(walls, 95)),
                             "setup_s": setup_s}
    cells.use_reference_precision()
    plain = PlainFvvdp(cfg, dev)
    if on_host:
        pairs = [(torch.from_numpy(t).to(dev), torch.from_numpy(r).to(dev)) for t, r in host]
        del host
    ref = {k: plain.score_clip(pairs[k][0], pairs[k][1], cfg["fps"], gaze[k])
           for k in sorted({k for k, _, _ in results})}
    out["per_call"] = compare.clip_call_gaps(results, ref)
    return out
