"""The differentiable path of fovvideovdp_tpu_torch on the CPU:
``predict_traced``, ``loss``, ``use_checkpoints`` and ``fvvdp_torch_loss``,
against the port's own ``predict`` and against the JAX package.

Bars:
* ``predict_traced`` against ``predict`` on the goldens at the JAX
  package's own bars (tests/test_differentiable.py:10-28): 1e-4 JOD for the
  image, 1e-3 for the video;
* against JAX's ``predict_traced``: 1e-4 JOD;
* the loss's gradient against ``jax.grad`` of JAX's ``fv.loss`` on the
  inputs of tests/test_differentiable.py:31-60 and
  tests/test_torch_interop.py:14-19: rtol 2e-3 and atol 5e-6.  The JAX
  bridge's own bar is rtol 2e-2, atol 1e-5 (test_torch_interop.py:40-41).
  Against the jitted ``jax.grad`` (XLA fuses and reassociates) the port
  measures a largest difference of 5.4e-5 against gradients of up to 2.0,
  which needs atol 6.6e-7 at rtol 2e-3, and 2.6e-6 for the reference's
  gradient (against the eager ``jax.grad``, 4.8e-7 in all); the bar is
  tightened to that with a margin of 2.

Both packages load the same parameters and LUTs: the port's metric takes
the JAX metric's state (``load_state``), as tests/test_torch_metric.py does.
"""
import numpy as np
import pytest
import torch

import jax

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch.ops.cuda import _autograd

torch.set_num_threads(2)

GRAD_BAR = dict(rtol=2e-3, atol=5e-6)
JOD_BAR = 1e-4


def _pair(**kw):
    """(JAX metric, the port's metric on the CPU with the JAX metric's state)."""
    jm = fv_jax.fvvdp(**kw)
    pm = fv_port.fvvdp(device="cpu", **kw)
    params, luts = state.state_from_numpy(
        jm.parameters, [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jm._luts],
        "cpu")
    pm.load_state(params, luts)
    return jm, pm


def _image(seed=0, shape=(32, 48)):
    rng = np.random.RandomState(seed)
    ref = rng.rand(*shape).astype(np.float32)
    tst = np.clip(ref + rng.randn(*shape).astype(np.float32) * 0.05, 0, 1)
    return tst.astype(np.float32), ref


# the inputs of tests/test_differentiable.py:31-60 and test_torch_interop.py:14-19
GRAD_CASES = {
    "image_hw": (dict(display_name="standard_4k"), (0, (32, 48)), dict(dim_order="HW")),
    "video_hwf_checkpoints": (dict(display_name="standard_4k", use_checkpoints=True),
                              (1, (24, 32, 6)),
                              dict(dim_order="HWF", frames_per_second=30)),
    "image_hwc": (dict(display_name="standard_4k"), (5, (40, 56, 3)), dict(dim_order="HWC")),
}


def _port_grad(pm, tst, ref, **kw):
    x = torch.tensor(tst, requires_grad=True)
    loss = pm.loss(x, torch.tensor(ref), **kw)
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


# ---------------------------------------------------------------------------
# against the port's own predict
# ---------------------------------------------------------------------------

def test_traced_matches_streaming(goldens):
    g = goldens("image_path_gray_float")
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    q_stream, _ = fv.predict(g["test"], g["ref"], dim_order="HW")
    q_traced = fv.predict_traced(torch.tensor(g["test"]), torch.tensor(g["ref"]),
                                 dim_order="HW")
    assert q_traced.dim() == 0 and q_traced.device.type == "cpu"
    np.testing.assert_allclose(float(q_traced), q_stream, atol=1e-4)


def test_traced_video_matches_streaming(goldens):
    g = goldens("video_path_replicate")
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    tst = g["test"].astype(np.float32) / 255.0
    ref = g["ref"].astype(np.float32) / 255.0
    q_stream, _ = fv.predict(tst, ref, dim_order="HWCF", frames_per_second=float(g["fps"]))
    q_traced = float(fv.predict_traced(tst, ref, dim_order="HWCF",
                                       frames_per_second=float(g["fps"])))
    np.testing.assert_allclose(q_traced, q_stream, atol=1e-3)


def test_predict_never_enters_an_autograd_function(monkeypatch):
    """predict streams under torch.no_grad: every wrapper takes today's
    path, even for inputs that require grad."""
    def refuse(*args):
        raise AssertionError("predict went through an autograd Function")

    monkeypatch.setattr(_autograd._KernelFunction, "apply", refuse)
    tst, ref = _image()
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    q, _ = fv.predict(torch.tensor(tst, requires_grad=True), torch.tensor(ref), dim_order="HW")
    assert np.isfinite(q)
    with torch.no_grad():
        q_traced = fv.predict_traced(tst, ref, dim_order="HW")
    assert q_traced.grad_fn is None
    np.testing.assert_allclose(float(q_traced), q, atol=1e-4)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["image", "video", "foveated_image", "foveated_video_rows"])
def test_traced_matches_jax_predict_traced(case):
    kw = dict(display_name="standard_4k", foveated=case.startswith("foveated"))
    if case in ("image", "foveated_image"):
        tst, ref = _image(5, (40, 56, 3))
        call = dict(dim_order="HWC")
    else:
        tst, ref = _image(1, (24, 32, 6))
        call = dict(dim_order="HWF", frames_per_second=30)
    if case == "foveated_image":
        call["fixation_point"] = (20, 15)
    if case == "foveated_video_rows":
        call["fixation_point"] = np.stack([np.linspace(3, 28, 6), np.linspace(2, 20, 6)],
                                          axis=1).astype(np.float32)
    jm, pm = _pair(**kw)
    want = float(jax.jit(lambda t, r: jm.predict_traced(t, r, **call))(tst, ref))
    got = float(pm.predict_traced(tst, ref, **call))
    print(f"{case}: port {got} JAX {want}")
    assert abs(got - want) <= JOD_BAR


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_gradient_matches_jax_grad(case):
    kw, (seed, shape), call = GRAD_CASES[case]
    tst, ref = _image(seed, shape)
    jm, pm = _pair(**kw)
    val_j, g_j = jax.jit(jax.value_and_grad(lambda x: jm.loss(x, ref, **call)))(tst)
    val, g = _port_grad(pm, tst, ref, **call)
    g_j = np.asarray(g_j)
    print(f"{case}: loss {val} (JAX {float(val_j)}), max |dg| "
          f"{np.abs(g - g_j).max():.3g} of max |g| {np.abs(g_j).max():.3g}")
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(val, float(val_j), atol=JOD_BAR)
    np.testing.assert_allclose(g, g_j, **GRAD_BAR)


def test_reference_gradient_matches_jax_grad():
    """grad_ref: the reference's gradient reaches L_bkg, where an image's
    zero transient channel must leave no NaN."""
    tst, ref = _image(5, (40, 56, 3))
    jm, pm = _pair(display_name="standard_4k")
    g_j = np.asarray(jax.jit(jax.grad(lambda r: jm.loss(tst, r, dim_order="HWC")))(ref))
    r = torch.tensor(ref, requires_grad=True)
    pm.loss(torch.tensor(tst), r, dim_order="HWC").backward()
    g = r.grad.numpy()
    print(f"reference: max |dg| {np.abs(g - g_j).max():.3g} of max |g| {np.abs(g_j).max():.3g}")
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_j, **GRAD_BAR)


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["image", "video"])
def test_use_checkpoints_gives_the_same_gradient(case):
    if case == "image":
        tst, ref = _image()
        call = dict(dim_order="HW")
    else:
        tst, ref = _image(1, (24, 32, 6))
        call = dict(dim_order="HWF", frames_per_second=30)
    grads = []
    for ckpt in (False, True):
        fv = fv_port.fvvdp(display_name="standard_4k", device="cpu", use_checkpoints=ckpt)
        grads.append(_port_grad(fv, tst, ref, **call))
    assert grads[0][0] == grads[1][0]
    np.testing.assert_array_equal(grads[0][1], grads[1][1])


def test_a_descent_step_lowers_the_loss():
    tst, ref = _image()
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    val, g = _port_grad(fv, tst, ref, dim_order="HW")
    assert np.isfinite(val) and 0 <= val <= 10
    tst2 = np.clip(tst - 0.5 * g / (np.abs(g).max() + 1e-9) * 0.05, 0, 1)
    val2 = float(fv.loss(tst2, ref, dim_order="HW"))
    assert val2 < val


def test_inputs_keep_their_graph_and_their_device():
    tst, ref = _image()
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    x = torch.tensor(tst, dtype=torch.float64, requires_grad=True)
    fv.loss(x, ref, dim_order="HW").backward()
    assert x.grad is not None and x.grad.dtype == torch.float64
    with pytest.raises(RuntimeError, match="metric on cpu"):
        fv.predict_traced(torch.empty((32, 48), device="meta"), ref, dim_order="HW")


@pytest.mark.parametrize("kwargs,message", [
    (dict(dim_order="BHW", shape=(2, 32, 48)), "batch size 1"),
    (dict(dim_order="HWF", shape=(32, 48, 4)), "frames_per_second"),
])
def test_refusals_name_what_is_wrong(kwargs, message):
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    x = np.zeros(kwargs["shape"], np.float32)
    with pytest.raises(RuntimeError, match=message):
        fv.predict_traced(x, x, dim_order=kwargs["dim_order"])


# ---------------------------------------------------------------------------
# fvvdp_torch_loss (the cases of tests/test_torch_interop.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def interop_pair():
    return _image(5, (40, 56, 3))


def test_torch_loss_grad_equals_the_metrics(interop_pair):
    tst, ref = interop_pair
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    loss_fn = fv_port.fvvdp_torch_loss(fv, dim_order="HWC")
    x = torch.tensor(tst, requires_grad=True)
    loss = loss_fn(x, torch.tensor(ref))
    loss.backward()
    val, g = _port_grad(fv, tst, ref, dim_order="HWC")
    assert float(loss.detach()) == val
    np.testing.assert_array_equal(x.grad.numpy(), g)


def test_torch_loss_upstream_grad_scaling_and_ref(interop_pair):
    tst, ref = interop_pair
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    loss_fn = fv_port.fvvdp_torch_loss(fv, dim_order="HWC", grad_ref=True)
    t_t = torch.tensor(tst, requires_grad=True)
    t_r = torch.tensor(ref, requires_grad=True)
    (3.0 * loss_fn(t_t, t_r)).backward()
    assert t_r.grad is not None and float(t_r.grad.abs().sum()) > 0

    t_t2 = torch.tensor(tst, requires_grad=True)
    t_r2 = torch.tensor(ref, requires_grad=True)
    fv_port.fvvdp_torch_loss(fv, dim_order="HWC")(t_t2, t_r2).backward()
    assert t_r2.grad is None                 # the reference is detached
    # the factor enters at the top of the chain and every step rounds anew:
    # measured 7.5e-8 at most, against gradients up to 8.7
    np.testing.assert_allclose(t_t.grad.numpy(), 3.0 * t_t2.grad.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_torch_optimiser_reduces_loss(interop_pair):
    tst, ref = interop_pair
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    loss_fn = fv_port.fvvdp_torch_loss(fv, dim_order="HWC")
    x = torch.tensor(tst, requires_grad=True)
    opt = torch.optim.Adam([x], lr=5e-3)
    losses = []
    for _ in range(6):
        opt.zero_grad()
        loss = loss_fn(x, torch.tensor(ref))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses


def test_eval_path_under_no_grad(interop_pair):
    tst, ref = interop_pair
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu")
    loss_fn = fv_port.fvvdp_torch_loss(fv, dim_order="HWC")
    t_t = torch.tensor(tst, requires_grad=True)
    t_r = torch.tensor(ref)
    with torch.no_grad():
        v_eval = loss_fn(t_t, t_r)
    assert t_t.grad is None and v_eval.grad_fn is None
    v_train = loss_fn(t_t, t_r)
    assert v_train.grad_fn is not None
    assert float(v_eval) == float(v_train.detach())
