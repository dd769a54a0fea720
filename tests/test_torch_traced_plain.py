"""The port as a training loss against the benchmark's plain reference with
its gradient (``benchmark/reference/fvvdp_plain_grad.py``), on the CPU: the
JOD of ``fvvdp.loss`` and its gradient with respect to the test clip, the
reference's blocked passes against one graph through the whole clip, the
bfloat16 control against the limits of the cell ``traced-4k-clip``, and the
backward's span and recompute counter.

Content is the benchmark's (``fvbench.content``: a panning textured canvas,
four distortions), as display-encoded floats (the uint8 codes over 255), on
the configuration ``standard_4k_video_loss`` cut to 128x96: its display is
``standard_4k``.

Bars:
* JOD within 2e-6, as the benchmark's clips are held to the plain reference
  (``benchmark/tests/test_bench_reference.py``): the two compute the same
  metric in another order, the port's pooling in float32, the reference's
  in float64;
* the gradient within 1e-5 of the reference's, relative L2 and largest
  element over the largest: the port's backward is its plain versions' VJP
  at the kernels' saved inputs, so it differs from the reference's autograd
  only by the order of float32 sums; 1.2e-6 is the largest gap measured
  here, and 1e-5 leaves eight times that;
* the blocked reference within 1e-7 JOD and 1e-6 relative L2 of one graph:
  the same operations on the same windows, grouped in other blocks, so
  float32 sums over other batches (at most 4.9e-9 JOD and 4.0e-7 measured
  here, over 1, 2 and 8 threads).
"""
import json
import os
import sys

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import control_traced  # noqa: E402
from fvbench import content, registry  # noqa: E402
from reference.fvvdp_plain_grad import PlainFvvdpGrad  # noqa: E402

import fovvideovdp_tpu_torch as fv  # noqa: E402
from fovvideovdp_tpu_torch import memory  # noqa: E402
from fovvideovdp_tpu_torch.ops.cuda import _autograd  # noqa: E402

torch.set_num_threads(2)

W, H, FRAMES = 128, 96, 6
SEEDS = [0, 11, 2**31 + 77]
JOD_BAR = 2e-6
GRAD_BAR = 1e-5


@pytest.fixture(scope="module")
def cfg():
    """The training-loss configuration at the tests' size."""
    bench = registry.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "standard_4k_video_loss")
    with open(os.path.join(registry.ROOT, entry["file"])) as f:
        c = json.load(f)
    c.update(width=W, height=H, frames=FRAMES)
    return c


@pytest.fixture(scope="module")
def metric(cfg):
    return fv.fvvdp(display_name=cfg["display"]["name"], device="cpu")


def _pair(cfg, k, seed, frames=FRAMES):
    """Pair ``k`` as floats: the test a leaf that requires a gradient."""
    t, r = content.clip_pair(dict(cfg, frames=frames), k, seed, torch.device("cpu"))
    return (t.to(torch.float32) / 255.0).requires_grad_(True), r.to(torch.float32) / 255.0


def _gaps(g, g_ref):
    return (float((g - g_ref).norm() / g_ref.norm()),
            float((g - g_ref).abs().max() / g_ref.abs().max()))


@pytest.mark.parametrize("pair", range(4), ids=["noise", "blur", "bits", "mix"])
@pytest.mark.parametrize("frames", [FRAMES, 1], ids=["clip", "image"])
@pytest.mark.parametrize("seed", SEEDS)
def test_loss_and_gradient_against_plain_reference(cfg, metric, seed, frames, pair):
    x, r = _pair(cfg, pair, seed, frames)
    loss = metric.loss(x, r, dim_order="CFHW", frames_per_second=cfg["fps"])
    loss.backward()
    jod, g_ref = PlainFvvdpGrad(cfg, "cpu").jod_and_grad(x, r, cfg["fps"])
    got = 10.0 - float(loss.detach())
    assert got < 9.99                         # the content is visibly distorted
    assert abs(got - jod) <= JOD_BAR
    l2, mx = _gaps(x.grad, g_ref)
    assert l2 <= GRAD_BAR and mx <= GRAD_BAR, (l2, mx)


@pytest.mark.parametrize("block", [1, 2, 4])
def test_blocked_reference_is_one_graph(cfg, block):
    x, r = _pair(cfg, 3, SEEDS[1])
    plain = PlainFvvdpGrad(cfg, "cpu")
    jod, g = plain.jod_and_grad(x, r, cfg["fps"], block=block)
    jod_one, g_one = plain.jod_and_grad(x, r, cfg["fps"], block=None)
    assert abs(jod - jod_one) <= 1e-7
    assert _gaps(g, g_one)[0] <= 1e-6


def test_tie_rule_of_the_display_clip(cfg, monkeypatch):
    """The content holds samples at exactly 0 and 1, where the clip's
    gradient rule shows: the port's (half the gradient at a bound) is the
    reference's, and torch.clamp's (all of it) is far outside the bar."""
    from fovvideovdp_tpu_torch import utils
    x, r = _pair(cfg, 3, SEEDS[0])
    assert bool(((x == 0) | (x == 1)).any())
    g_ref = PlainFvvdpGrad(cfg, "cpu").jod_and_grad(x, r, cfg["fps"])[1]
    monkeypatch.setattr(utils, "clip", lambda V, lo=None, hi=None: torch.clamp(V, lo, hi))
    fv.fvvdp(display_name="standard_4k", device="cpu").loss(
        x, r, dim_order="CFHW", frames_per_second=cfg["fps"]).backward()
    assert _gaps(x.grad, g_ref)[0] > 100 * GRAD_BAR


def test_bfloat16_control_fails_a_limit(cfg):
    cell = registry.find_cell("traced-4k-clip")
    cell = cell._replace(config=dict(cfg, pairs=2))
    got = control_traced.readings(cell, 2**31 + 3, "cpu")
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)


def _kernel_calls(metric):
    """(backwards of the kernels' Functions one loss takes, bands): the
    temporal filter's, and a reduce and a scorer per band."""
    height = metric._get_core(W, H).plan.height
    return 1 + 2 * height, height


def test_vjp_span_once_per_function_backward(cfg, metric):
    from torch.profiler import ProfilerActivity, profile
    x, r = _pair(cfg, 0, SEEDS[0])
    _autograd.reset_vjp_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metric.loss(x, r, dim_order="CFHW", frames_per_second=cfg["fps"]).backward()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    counts = _autograd.vjp_counts()
    calls, height = _kernel_calls(metric)
    assert names.count("fvvdp.vjp") == calls
    assert sum(c["calls"] for c in counts.values()) == calls
    assert counts["expand_score2"]["calls"] == counts["gausspyr_reduce"]["calls"] == height
    assert names.count("fvvdp.predict_traced") == 1 and names.count("fvvdp.luminance") == 2


def test_recompute_counter_is_exact(cfg, metric, monkeypatch):
    """With a recompute budget of one byte every framed op recomputes a
    frame at a time: each reduce and scorer backward takes one chunk a
    frame, the temporal filter's (not separable over frames) one; the
    gradient is the unchunked one."""
    x, r = _pair(cfg, 1, SEEDS[2])
    metric.loss(x, r, dim_order="CFHW", frames_per_second=cfg["fps"]).backward()
    whole, x.grad = x.grad, None
    monkeypatch.setattr(memory, "recompute_budget", lambda device: 1.0)
    _autograd.reset_vjp_counts()
    metric.loss(x, r, dim_order="CFHW", frames_per_second=cfg["fps"]).backward()
    counts = _autograd.vjp_counts()
    calls, height = _kernel_calls(metric)
    assert counts["temporal_pair"] == {"calls": 1, "chunks": 1}
    for op in ("expand_score2", "gausspyr_reduce"):
        assert counts[op] == {"calls": height, "chunks": height * FRAMES}
    _autograd.reset_vjp_counts()
    assert _autograd.vjp_counts() == {}
    assert _gaps(x.grad, whole)[0] <= 1e-6
