"""A run with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have.  The harness's look for a card is
skipped (the drivers run on the CPU at a small size); the rest of a run
is driven as on the card."""
import importlib
import os
import sys

import pytest
import torch

from conftest import SMALL_CLIP, SMALL_SET, small_cell
from fvbench import cells, cli, registry

from fovvideovdp_tpu_torch import core as core_mod
from fovvideovdp_tpu_torch.ops import masking

# the module (the package's name fvvdp is the class)
fvvdp_mod = importlib.import_module("fovvideovdp_tpu_torch.fvvdp")

HERE = os.path.dirname(os.path.abspath(__file__))


def _clip_run(workload="4k-clip", frames=12):
    cell = small_cell(workload, **dict(SMALL_CLIP, frames=frames))
    return cli.assemble(cell, registry.driver("clip")(cell, 2**31 + 9, 0.2, False, "cpu",
                                                      cells.process_start()), False)


def _batch_run():
    cell = small_cell("kadid-batch", **SMALL_SET)
    return cli.assemble(cell, registry.driver("batch")(cell, 2**31 + 9, 0.2, False, "cpu",
                                                       cells.process_start()), False)


def test_sound_runs_are_correct():
    assert _clip_run(frames=40)["correct"]
    assert _clip_run("4k-clip-gaze")["correct"]
    assert _batch_run()["correct"]


@pytest.mark.parametrize("workload,sizes", [("4k-clip", SMALL_CLIP), ("kadid-batch", SMALL_SET)])
def test_host_sources_are_correct(workload, sizes):
    """The traffic's ``source`` "host": the content in host memory through
    the entry that uploads it, judged as the resident runs are."""
    cell = small_cell(workload, traffic={"source": "host"}, **sizes)
    out = registry.driver(cell.traffic["driver"])(cell, 2**31 + 9, 0.2, False, "cpu",
                                                 cells.process_start())
    res = cli.assemble(cell, out, False)
    assert res["correct"] and res["attempted"] >= 1


def test_foveation_needs_a_gaze_path():
    cell = small_cell("4k-clip", traffic={"metric": {"foveated": True}}, **SMALL_CLIP)
    with pytest.raises(ValueError, match="gaze"):
        registry.driver("clip")(cell, 1, 0.2, False, "cpu", cells.process_start())


def test_state_left_unchanged(monkeypatch):
    """The streaming step hands back the carry it was given (40 frames:
    two blocks, so the second block's window reads the carry)."""
    step = core_mod.MetricCore.video_step

    def stale(self, carry_t, carry_r, *a, **k):
        Q, heat, _, _ = step(self, carry_t, carry_r, *a, **k)
        return Q, heat, carry_t, carry_r
    monkeypatch.setattr(core_mod.MetricCore, "video_step", stale)
    res = _clip_run(frames=40)
    assert not res["correct"] and res["compared"]["q_gap"]["value"] > res["compared"]["q_gap"]["limit"]


@pytest.mark.parametrize("workload", ["4k-clip", "4k-clip-gaze"])
def test_clip_answer_altered(monkeypatch, workload):
    pool = masking.pool_to_jod
    monkeypatch.setattr(masking, "pool_to_jod", lambda *a, **k: pool(*a, **k) + 1e-2)
    assert not _clip_run(workload)["correct"]


def test_band_row_altered(monkeypatch):
    q_pair = core_mod.MetricCore._q_pair

    def bad(self, ssum2, bb, temp_ch):
        Q = q_pair(self, ssum2, bb, temp_ch)
        return Q * 1.1 if bb == 1 else Q
    monkeypatch.setattr(core_mod.MetricCore, "_q_pair", bad)
    assert not _clip_run()["correct"]


def test_half_the_batch_left_out(monkeypatch):
    scorer = fvvdp_mod.make_batch_scorer

    def half(core, pairs, chunk, params, *a, **k):
        j = scorer(core, pairs, chunk, params, *a, **k)
        n = j.shape[0] // 2
        return torch.cat([j[:n], j[:n].mean().expand(j.shape[0] - n)])
    monkeypatch.setattr(fvvdp_mod, "make_batch_scorer", half)
    assert not _batch_run()["correct"]


def test_batch_answer_altered(monkeypatch):
    scorer = fvvdp_mod.make_batch_scorer

    def one(*a, **k):
        j = scorer(*a, **k).clone()
        j[7] += 1e-2
        return j
    monkeypatch.setattr(fvvdp_mod, "make_batch_scorer", one)
    res = _batch_run()
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("fault", ["none", "exchange"])
def test_processes(fault):
    """Two processes over gloo: sound, the run is correct; with the
    exchange between processes left out, the workers past the first index
    rows the gather never brought and the run fails without a result."""
    from _fault_worker import cell_of
    cell = cell_of("kadid-batch-4proc", 2)
    cmd = [sys.executable, os.path.join(HERE, "_fault_worker.py"), fault]
    if fault == "none":
        out = cells.run_processes(cell, 2**31 + 21, 1.0, False, cells.process_start(), cmd,
                                  timeout=240)
        res = cli.assemble(cell, out, False)
        assert res["correct"] and res["attempted"] >= 2
        assert res["metrics"]["pairs_per_s.4proc"]["value"] > 0
    else:
        with pytest.raises(RuntimeError, match="worker"):
            cells.run_processes(cell, 2**31 + 21, 1.0, False, cells.process_start(), cmd,
                                timeout=240)
