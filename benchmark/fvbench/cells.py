"""What the drivers of a cell's measured window share.

A driver is ``drivers/<name>.py``, named by the traffic's ``driver`` and
found by :func:`registry.driver`.  Its ``run(cell, seed, seconds, tracing,
device, started, rank=0, world=1, port=0)`` makes one run: content made
on the card from the seed, the metric built and one warm call of the
cell's own shapes (set-up, up to the window's start), then ``seconds`` of
back-to-back calls by one caller (a closed loop: a call is sent when the
last returns, and calls are sent while the window's time lasts; the
window closes when the last call returns), then the program's state freed
and the outputs of every call compared with the plain reference.  With
``tracing`` the window runs under ``torch.profiler`` and the per-layer
readers read it.  ``device`` is the traffic's ``device`` ("cuda:0" by
default).  ``rank``, ``world`` and ``port`` place the run in a group of
processes, one per card (:func:`run_processes`).

A driver returns a dict: ``attempted``, ``device`` (:func:`device_info`),
``done`` (what the window scored, such as ``{"frames": n}``), ``t0`` and
``t1`` (the window on :func:`now`'s clock), ``notes``, ``per_call`` (the
compared numbers of each call, ``compare``), and either ``end_to_end``
(the readings, by metric name) or, traced, ``per_layer`` (a
``readers.Context``) and ``trace`` (a ``trace.Summary``).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Dict, List, Mapping

import torch

from fvbench import readers, registry, trace
from fvbench.registry import Cell


def now() -> float:
    """Seconds on a clock that every process of the machine shares."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on :func:`now`'s clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def profiler(on: bool):
    if not on:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def window(call, seconds: float, tracing: bool, before_each=None):
    """Back-to-back calls while ``seconds`` last; returns (t0, t_end, call
    results, each call's wall seconds).  ``call(i)`` ends in a device
    synchronise.  ``before_each(i, t0)`` may end the window early (the
    processes of a group agree on it)."""
    results, walls = [], []
    t0 = now()
    i = 0
    with _span(trace.WINDOW, tracing):
        while True:
            if before_each is not None:
                if not before_each(i, t0):
                    break
            elif now() - t0 >= seconds:
                break
            ts = time.perf_counter()
            with _span(trace.CALL, tracing):
                results.append(call(i))
            walls.append(time.perf_counter() - ts)
            i += 1
    return t0, now(), results, walls


def work(cfg: Dict, traffic: Dict) -> Dict:
    """The shapes one call scores, for the roofline's byte counts."""
    from reference.fvvdp_plain import Display, Pyramid, temporal_filters
    disp = Display(cfg["display"]["photometry"], cfg["display"]["geometry"])
    pyr = Pyramid(cfg["width"], cfg["height"], disp.ppd)
    if cfg["kind"] == "clip":
        fl = temporal_filters(cfg["fps"], 0.5, 0.06).shape[1]
        return {"kind": "clip", "H": cfg["height"], "W": cfg["width"], "frames": cfg["frames"],
                "fl": fl, "channels": 4, "shapes": pyr.shapes}
    return {"kind": "images", "H": cfg["height"], "W": cfg["width"],
            "frames": pairs_per_process(cfg, traffic), "fl": 1, "channels": 2,
            "shapes": pyr.shapes}


def pairs_per_process(cfg: Dict, traffic: Dict) -> int:
    return int(traffic.get("pairs", cfg["pairs"])) // int(traffic.get("processes", 1))


def cards(dev: torch.device) -> List[int]:
    """The cards a run on ``dev`` uses: the one it names, or every visible
    card for an unindexed "cuda" (``predict_batch`` then spreads over them);
    none on the CPU."""
    if dev.type != "cuda":
        return []
    return [dev.index] if dev.index is not None else list(range(torch.cuda.device_count()))


def cuda(dev: torch.device, fn: str, default=0):
    """torch.cuda.<fn>(card) on each of the run's cards, the largest
    reading returned; ``default`` on the CPU."""
    if dev.type != "cuda":
        return default
    got = [getattr(torch.cuda, fn)(i) for i in cards(dev)]
    return None if None in got else max(got)


def device_info(dev: torch.device, peak: int) -> Dict:
    if dev.type != "cuda":                  # the harness's own tests
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards(dev)[0]),
            "count": len(cards(dev)), "memory_peak_bytes": int(peak)}


def free_program(dev: torch.device) -> None:
    """Return the memory of the program's state, just dropped, to the card."""
    if dev.type == "cuda":
        cuda(dev, "synchronize")
        torch.cuda.empty_cache()


def use_reference_precision() -> None:
    """The reference's float32 with TF32 off, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# one process per card
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_cards(world: int, env: Mapping[str, str]) -> List[str]:
    """The card of each of ``world`` workers: the r-th entry of the
    ``CUDA_VISIBLE_DEVICES`` the run was given, or card r where it sets
    none, so that a run never reaches cards outside its own set."""
    given = env.get("CUDA_VISIBLE_DEVICES")
    if given is None:
        return [str(r) for r in range(world)]
    seen = [c.strip() for c in given.split(",") if c.strip()]
    if len(seen) < world:
        raise RuntimeError(f"{world} workers need {world} cards; CUDA_VISIBLE_DEVICES={given!r}")
    return seen[:world]


def run_processes(cell: Cell, seed: int, seconds: float, tracing: bool, started: float,
                  worker_cmd: List[str], timeout: float = 330.0) -> Dict:
    """``traffic["processes"]`` workers, worker r on the r-th card of the
    run's own (:func:`worker_cards`) alone, each ``worker_cmd`` plus its
    rank, the group's size and the port of the group's rendezvous.  A
    worker runs the cell's driver and prints its readings as one JSON
    line; the first to fail ends the others.  Returns the workers'
    readings combined as a driver returns one process's: each rate
    (``<unit>_per_s`` for each key of ``done``) is every worker's work over
    the common window."""
    world = int(cell.traffic["processes"])
    port = free_port()
    procs = []
    for r, card in enumerate(worker_cards(world, os.environ)):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=card)
        procs.append(subprocess.Popen(
            worker_cmd + ["--workload", cell.name, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(int(tracing)), "--worker-rank", str(r),
                          "--worker-world", str(world), "--worker-port", str(port)],
            env=env, stdout=subprocess.PIPE, text=True))
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                raise RuntimeError("a worker failed or the workers ran out of time: exit codes "
                                   f"{[p.poll() for p in procs]}")
            time.sleep(0.05)
        outs = [p.communicate()[0] for p in procs]
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"worker exit codes {[p.returncode for p in procs]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    t0, t1 = min(g["t0"] for g in got), max(g["t1"] for g in got)
    dev = dict(got[0]["device"], count=world,
               memory_peak_bytes=max(g["device"]["memory_peak_bytes"] for g in got))
    out = {"attempted": sum(g["attempted"] for g in got), "device": dev,
           "per_call": [c for g in got for c in g["per_call"]],
           "notes": {"workers": [g["notes"] for g in got],
                     "window_starts_s": [g["t0"] - t0 for g in got]}}
    if tracing:
        sums = [trace.Summary(**g["trace"]) for g in got]
        out["per_layer"] = readers.Context(sums, registry.stages(),
                                           work(cell.config, cell.traffic),
                                           calls=got[0]["attempted"],
                                           step=cell.traffic.get("step"))
        out["trace"] = trace.Summary(
            window_s=sum(s.window_s for s in sums) / world, busy_s=sum(s.busy_s for s in sums) / world,
            device_s_by_symbol={}, calls=sum(s.calls for s in sums),
            device_ops=_merge_top([s.device_ops for s in sums]),
            idle_gaps=sorted((g for s in sums for g in s.idle_gaps), key=lambda g: -g[1])[:10])
    else:
        out["end_to_end"] = {f"{unit}_per_s": sum(g["done"][unit] for g in got) / (t1 - t0)
                             for unit in got[0]["done"]}
        out["end_to_end"]["setup_s"] = t0 - started
    return out


def _merge_top(lists, top: int = 10):
    """The ``top`` names of the largest sums over the lists' (name, value)."""
    acc: Dict[str, float] = {}
    for lst in lists:
        for name, v in lst:
            acc[name] = acc.get(name, 0.0) + v
    return sorted(acc.items(), key=lambda kv: -kv[1])[:top]


def worker_readings(out: Dict) -> Dict:
    """One worker's readings as the JSON its parent reads."""
    got = {k: out[k] for k in ("attempted", "device", "done", "t0", "t1", "per_call", "notes")}
    if "trace" in out:
        got["trace"] = out["trace"]._asdict()
    return got
