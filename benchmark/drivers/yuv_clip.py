"""``yuv_clip``: whole raw Y'CbCr clips scored back to back, the resident
pairs in turn.

The clips are HDR10 frames made on the card (``hdr_content``), each pair
in a ``fvvdp_video_source_yuv_array`` built in set-up, each call a
``fvvdp.predict_video_source``; the reference is ``fvvdp_plain_hdr`` on
the same samples.  Traffic keys read here: ``metric``, keyword arguments
of ``fvvdp`` besides the display and the device (not foveated: the
reference scores no gaze).

Readings: ``frames_per_s``, ``clip_p95_ms`` (each call's wall time, ending
in a device synchronise) and ``setup_s``; traced, the per-layer readers get
a ``span_context.SpanContext`` with the program's spans.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fvbench import cells, compare, hdr_content, registry, span_context, spans, trace
from fvbench.registry import Cell

# the source's name of each configuration colour space
_SOURCE_COLOR = {"BT.2020": "2020", "BT.709": "709"}


def work(cfg: Dict) -> Dict:
    """The shapes one call scores, for the roofline's byte counts."""
    from reference.fvvdp_plain import Pyramid, temporal_filters
    from reference.fvvdp_plain_hdr import PQDisplay
    disp = PQDisplay(cfg["display"]["photometry"], cfg["display"]["geometry"])
    p = cfg["metric_parameters"]
    return {"kind": "clip", "H": cfg["height"], "W": cfg["width"], "frames": cfg["frames"],
            "fl": temporal_filters(cfg["fps"], p["sustained_sigma"], p["sustained_beta"]).shape[1],
            "channels": 4, "shapes": Pyramid(cfg["width"], cfg["height"], disp.ppd).shapes}


def run(cell: Cell, seed: int, seconds: float, tracing: bool, device: str, started: float,
        rank: int = 0, world: int = 1, port: int = 0) -> Dict:
    if world != 1:
        raise ValueError(f"the yuv_clip driver runs in one process, not {world}")
    import fovvideovdp_tpu_torch as fv
    yuv_source = fv.fvvdp_video_source_yuv_array
    from fovvideovdp_tpu_torch.ops.cuda import _lib
    from reference.fvvdp_plain_hdr import PlainFvvdpHDR
    cfg, tr = cell.config, cell.traffic
    opts = dict(tr.get("metric", {}))
    if opts.get("foveated") or tr.get("gaze"):
        raise ValueError("the yuv_clip driver scores without foveation")
    dev = torch.device(device)
    n = int(cfg["pairs"])
    notes = {"import_s": cells.now() - started}
    pairs = [hdr_content.clip_pair(cfg, k, seed, dev) for k in range(n)]
    cells.cuda(dev, "synchronize")
    notes["content_s"] = cells.now() - started
    metric = fv.fvvdp(display_name=cfg["display"]["name"], device=device, **opts)
    sources = [yuv_source(t, r, cfg["fps"], cfg["width"], cfg["height"],
                          bit_depth=cfg["bit_depth"], chroma_ss=cfg["chroma_ss"],
                          color_space=_SOURCE_COLOR[cfg["color_space"]],
                          display_photometry=metric.display_photometry,
                          color_space_name=cfg["color_space"], device=device)
               for t, r in pairs]
    notes["metric_s"] = cells.now() - started

    def call(i):
        k = i % n
        q, stats = metric.predict_video_source(sources[k])
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
    del sources, metric, fv
    cells.free_program(dev)

    frames = len(results) * cfg["frames"]
    notes["call_ms_by_pair"] = [round(1e3 * float(np.median(walls[k::n])), 2)
                                for k in range(n) if walls[k::n]]
    notes["jod_by_pair"] = {k: q for k, q, _ in results[:n]}
    out = {"attempted": len(results), "device": cells.device_info(dev, peak),
           "done": {"frames": frames}, "t0": t0, "t1": t1, "notes": notes}
    if tracing:
        evs = spans.events(prof)
        summary = trace.summarise(trace.events(prof))
        del prof
        ctx = span_context.SpanContext(
            [summary], registry.stages(), work(cfg), calls=len(results), frames=frames,
            launches=launches, step=tr.get("step"),
            peak_bytes=window_peak - base if dev.type == "cuda" else None,
            spans=[spans.reduce(evs)])
        del evs
        out["per_layer"], out["trace"] = ctx, summary
    else:
        out["end_to_end"] = {"frames_per_s": frames / (t1 - t0),
                             "clip_p95_ms": 1e3 * float(np.percentile(walls, 95)),
                             "setup_s": setup_s}
    cells.use_reference_precision()
    plain = PlainFvvdpHDR(cfg, dev)
    ref = {k: plain.score_clip(pairs[k][0], pairs[k][1], cfg["fps"])
           for k in sorted({k for k, _, _ in results})}
    out["per_call"] = compare.clip_call_gaps(results, ref)
    return out
