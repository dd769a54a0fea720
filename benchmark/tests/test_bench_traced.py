"""The cell of the metric as a training loss (``traced-4k-clip``, driver
``traced_clip``) on the CPU at a small size: sound runs are correct, and
``correct`` comes out false for each fault the gradient can have; the
comparison's numbers, the step's least bytes, the readers on a program
without the backward's span and counter, and the reference's imports."""
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, small_cell
from fvbench import cells, cli, compare_grad, readers, registry, roofline, roofline_vjp

import fovvideovdp_tpu_torch as fv
from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.ops.cuda import _autograd

SMALL = dict(width=128, height=96, frames=6, pairs=2)
SEED = 2**31 + 9

torch.set_num_threads(2)


def _run(seconds=2.0, tracing=False):
    cell = small_cell("traced-4k-clip", **SMALL)
    out = registry.driver("traced_clip")(cell, SEED, seconds, tracing, "cpu",
                                         cells.process_start())
    return out, cli.assemble(cell, out, tracing)


def test_sound_runs_are_correct():
    out, res = _run()
    assert res["correct"] and res["attempted"] >= 2
    assert set(res["compared"]) == {"jod_gap", "grad_gap", "grad_max_gap"}
    assert all(set(c) == set(res["compared"]) for c in out["per_call"])
    assert res["metrics"]["frames_per_s"]["value"] > 0


def test_traced_run_counts_the_recompute():
    """On the CPU no device reading is made; the counter is read exactly:
    one chunk per backward at the CPU's budget, a temporal filter's and a
    reduce and a scorer per band, each call."""
    out, res = _run(tracing=True)
    height = fv.fvvdp(display_name="standard_4k", device="cpu")._get_core(
        SMALL["width"], SMALL["height"]).plan.height
    assert res["correct"]
    assert res["metrics"]["vjp_chunks_per_call.traced"]["value"] == 1 + 2 * height
    assert "vjp_ms_per_frame.traced" not in res["metrics"]
    assert out["per_layer"].spans[0]["spans"]["fvvdp.vjp"]["count"] \
        == (1 + 2 * height) * res["attempted"]


def test_a_short_window_scores_what_it_called():
    """One call: the pair never called is neither noted nor compared."""
    out, res = _run(seconds=0.01)
    assert res["attempted"] == 1 and res["correct"]
    assert len(out["notes"]["call_ms_by_pair"]) == 1


def test_a_program_without_the_counter(monkeypatch):
    """The parent of the counter: the run is correct and the counter's
    metric is left out."""
    monkeypatch.delattr(_autograd, "vjp_counts")
    _, res = _run(tracing=True)
    assert res["correct"] and "vjp_chunks_per_call.traced" not in res["metrics"]


def _fault_loss(monkeypatch, make):
    """``fvvdp.loss`` replaced by ``make(the loss)``."""
    loss = fv.fvvdp.loss
    monkeypatch.setattr(fv.fvvdp, "loss", make(loss))


def test_zeroed_gradient(monkeypatch):
    _fault_loss(monkeypatch, lambda loss: lambda self, t, r, **k:
                loss(self, t.detach(), r, **k) + 0.0 * t.sum())
    _, res = _run()
    assert not res["correct"] and res["compared"]["grad_gap"]["value"] >= 0.999
    assert res["compared"]["jod_gap"]["value"] <= res["compared"]["jod_gap"]["limit"]


def test_another_pairs_gradient(monkeypatch):
    """Each call's JOD is its own pair's, its gradient the last call's pair's."""
    last = {}

    def make(loss):
        def swapped(self, t, r, **k):
            own = loss(self, t.detach(), r, **k)
            pt, pr = last.get("pair", (t.detach(), r))
            last["pair"] = (t.detach(), r)
            other = loss(self, t + (pt - t).detach(), pr, **k)
            return own + (other - other.detach())
        return swapped
    _fault_loss(monkeypatch, make)
    _, res = _run()
    assert not res["correct"]
    assert res["compared"]["jod_gap"]["value"] <= res["compared"]["jod_gap"]["limit"]


def test_display_clip_tie_rule_flipped(monkeypatch):
    """torch.clamp's gradient at the bounds 0 and 1 in place of the port's
    (half of it at an exact bound)."""
    monkeypatch.setattr(utils, "clip", lambda V, lo=None, hi=None: torch.clamp(V, lo, hi))
    _, res = _run()
    assert not res["correct"]
    assert res["compared"]["grad_gap"]["value"] > res["compared"]["grad_gap"]["limit"]


def test_gaps_of_a_call_without_its_gradient():
    """A call whose gradient was not kept reads the least gaps its norm
    allows; the last call of the pair is compared in full."""
    g = torch.linspace(-1.0, 2.0, 400)
    ref = compare_grad.Reference(9.5, g)
    bad = g.clone()
    bad[7] += 3.0
    calls = [(0, 9.5, float(compare_grad.norm(bad))), (0, 9.5 + 2e-3, float(ref.norm))]
    got = compare_grad.call_gaps(calls, {0: ref}, {0: bad})
    assert got[1] == {"jod_gap": pytest.approx(2e-3), "grad_gap": pytest.approx(3.0 / ref.norm),
                      "grad_max_gap": pytest.approx(1.5)}
    d = abs(float(compare_grad.norm(bad)) - ref.norm)
    assert got[0]["grad_gap"] == pytest.approx(d / ref.norm)
    assert got[0]["grad_gap"] < got[1]["grad_gap"]
    assert got[0]["grad_max_gap"] == pytest.approx(d / (20.0 * 2.0))
    nan = bad.clone()
    nan[0] = float("nan")
    assert compare_grad.full_gaps(nan, ref)[0] == float("inf")


def test_least_bytes_of_the_step():
    """At the cell's 4K shapes: the forward is the clip stages' with a float
    input, and the backward as counted by hand for the test channels."""
    cell = registry.find_cell("traced-4k-clip")
    w = cells.work(cell.config, cell.traffic)
    s, F, px = w["shapes"], 16, 3840 * 2160
    assert w["frames"] == F and len(s) == 8
    pair = sum(s[l][0] * s[l][1] + s[l + 1][0] * s[l + 1][1] for l in range(7))
    fwd = 2 * F * px * 16 + roofline.temporal(w) + roofline.reduce(w) + roofline.expand_score(w)
    bwd = 4 * F * (7 * 2 + 6 * pair) + 4 * F * 2 * pair + 4 * F * px * 3 + 4 * F * px * 7
    assert roofline_vjp.forward(w) == fwd and roofline_vjp.backward(w) == bwd
    assert roofline_vjp.least_seconds(w, 3) == pytest.approx(3 * (fwd + bwd) / 3.35e12)


def test_step_share_needs_the_entry_span():
    step = registry.reader("step_mfu.traced")
    cell = registry.find_cell("traced-4k-clip")
    summary = type("S", (), {"busy_s": 1.0, "window_s": 2.0})()
    ctx = readers.Context([summary], registry.stages(), cells.work(cell.config, cell.traffic),
                          calls=4, frames=64)
    assert step(ctx) is None
    ctx.spans = [{"spans": {"fvvdp.predict_traced": {"count": 4}}}]
    assert step(ctx) == pytest.approx(
        100 * roofline_vjp.least_seconds(ctx.work, 4) / 2.0)


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {BENCH!r})\n"
            "import reference.fvvdp_plain_grad\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    got = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not got & {"jax", "jaxlib", "flax", "fovvideovdp_tpu", "fovvideovdp_tpu_torch",
                      "fvbench"}
