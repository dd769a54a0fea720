"""Gradients through the kernel wrappers of fovvideovdp_tpu_torch.

Each of the eight wrappers goes through its ``torch.autograd.Function``
(``ops/cuda/_autograd.py``) when autograd needs a graph.  On the CPU, at
small shapes, made with numpy from a seed:

* the gradient equals ``torch.autograd.grad`` through the plain version, bit
  for bit (the Function's forward is the plain version here, and its
  backward recomputes it);
* it matches the JAX package's own ``custom_vjp`` on the same inputs:
  ``jax.vjp`` of ``_gausspyr_reduce_pallas_vjp``, ``_temporal_pair``,
  ``_temporal``, ``_expand_score2``, ``_expand_contrast_pallas_vjp``,
  ``_band_score``, ``_band_score2``, ``_band_score2_fov`` and
  ``_mov_score``, with the Pallas forward run through the interpreter
  (``pallas_cfg.forced(True, interpret=True)``), as the JAX package's own
  tests run it.  Bar: rtol 1e-4 of the largest gradient (float32 rounding of
  two compositions of the same arithmetic; the JAX rules recompute through
  jnp, the port's through its plain versions);
* non-differentiable arguments (taps, tables, the gaze, the static planes)
  get no gradient;
* the recompute in chunks of frames equals the recompute at once, bit for
  bit.

The ``gpu`` cases (they skip without a card) hold the Function on the card,
whose forward launches the kernel, against the same call on the CPU.  This
file imports JAX only inside the tests that compare with it, so that the
``gpu`` cases run where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_autograd.py``.
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu_torch import memory
from fovvideovdp_tpu_torch.ops import temporal as ptemp
from fovvideovdp_tpu_torch.ops.cuda import _autograd
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import expand_contrast as ec
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
from fovvideovdp_tpu_torch.ops.cuda import reduce as red
from fovvideovdp_tpu_torch.ops.cuda import temporal as tmp

torch.set_num_threads(2)

W, H, F = 256, 64, 3
JAX_RTOL = 1e-4          # of the largest gradient, see the module's docstring
CUDA_RTOL = 1e-4         # card against CPU: the kernel's forward, float32 sums
CASES = ["reduce", "temporal_pair", "temporal", "expand_score2", "expand_contrast",
         "band_score", "band_score2", "band_score2_fov", "mov_score"]
FRAMED = [c for c in CASES if c not in ("temporal_pair", "temporal")]


@pytest.fixture(scope="module")
def cores():
    """The port's own cores on the CPU: the default route's and the
    foveated one's (their tables and scalars are the kernels' inputs)."""
    fv = fvt.fvvdp(display_name="standard_4k", device="cpu")
    fv_fov = fvt.fvvdp(display_name="standard_4k", foveated=True, device="cpu")
    return fv._get_core(W, H), fv_fov._get_core(W, H)


def _pyramid_pair(rng):
    """A fine level of smooth luminance with 2% texture, and its reduce."""
    base = rng.uniform(5.0, 80.0, (F, 4, 1, 1)).astype(np.float32)
    fine = base * (1.0 + 0.02 * rng.standard_normal((F, 4, H, W)).astype(np.float32))
    coarse = red.gausspyr_reduce_plain(torch.from_numpy(fine)).numpy()
    return fine.astype(np.float32), coarse


def _band(rng):
    band = (rng.standard_normal((F, 4, H, W)) * 0.05).astype(np.float32)
    L = (rng.random((F, H, W)) * 80 + 0.5).astype(np.float32)
    return band, L


def _case(name, cores, seed=0):
    """(wrapper, args as numpy or Python values, positions that carry a
    gradient, the JAX rule: (numpy args, numpy cotangents) -> gradients)."""
    core, core_fov = cores
    rng = np.random.default_rng(seed)
    if name == "reduce":
        x, _ = _pyramid_pair(rng)

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops import pyramid as jpyr
            return _jax_vjp(jpyr._gausspyr_reduce_pallas_vjp, [a[0]], cot)
        return red.gausspyr_reduce, [x], (0,), jax_rule
    if name in ("temporal_pair", "temporal"):
        taps = ptemp.temporal_filters(30.0, ptemp.filter_len_for_fps(30.0))
        fl = taps.shape[1]
        n_c = fl - 1 if name == "temporal_pair" else 0
        n_n = 4 if name == "temporal_pair" else 4 + fl - 1
        frames = lambda n: (rng.random((n, 16, 128)) * 80 + 0.5).astype(np.float32)
        ct, nt, cr, nr = frames(n_c), frames(n_n), frames(n_c), frames(n_n)
        taps_t = tuple(tuple(float(v) for v in row) for row in taps)

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops.pallas import temporal as jt
            if name == "temporal_pair":
                return _jax_vjp(lambda *xs: jt._temporal_pair(*xs, taps_t), a[:4], cot)
            g_t, g_r = _jax_vjp(lambda p, q: jt._temporal(p, q, taps_t), [a[1], a[3]], cot)
            return [np.zeros_like(a[0]), g_t, np.zeros_like(a[2]), g_r]
        return tmp.temporal_pair, [ct, nt, cr, nr, taps], (0, 1, 2, 3), jax_rule
    if name in ("expand_score2", "expand_contrast"):
        fine, coarse = _pyramid_pair(rng)
        if name == "expand_contrast":
            def jax_rule(a, cot):
                from fovvideovdp_tpu.ops import pyramid as jpyr
                return _jax_vjp(lambda p, q: jpyr._expand_contrast_pallas_vjp(
                    p, q, (H, W), 1), a[:2], cot)
            return ec.expand_contrast, [fine, coarse, 1], (0, 1), jax_rule
        tables, meta = core._score_tables[0].numpy(), core._meta[0]

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops.pallas import band_pipeline as jbp
            shared = bool(np.ptp(tables[1] - tables[0]) <= 2e-5)
            return _jax_vjp(lambda p, q: jbp._expand_score2(
                p, q, tables, 1, tuple(meta), shared), a[:2], cot)
        return bp.expand_score2, [fine, coarse, tables, meta, 1], (0, 1), jax_rule
    band, L = _band(rng)
    if name == "band_score":
        table, m = core._score_tables[0][0].numpy(), core._meta[0]
        meta9 = (m.y0, m.dy, m.Ymin, m.Ymax, m.p, m.q_s, m.c10, m.corr, m.beta)

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops.pallas import band_score as jbs
            return _jax_vjp(lambda t, r, l: jbs._band_score(t, r, l, table, meta9),
                            a[:3], cot)
        return bs.band_score, [band[:, 0], band[:, 1], L, table, m, m.q_s], (0, 1, 2), jax_rule
    if name == "band_score2":
        tables, meta = core._score_tables[0].numpy(), core._meta[0]

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops.pallas import band_score as jbs
            return _stacked(lambda *xs: jbs._band_score2(*xs, tables, tuple(meta)), a, cot)
        return bs.band_score2, [band, L, tables, meta], (0, 1), jax_rule
    if name == "band_score2_fov":
        n = int((core_fov._fov_lut or core_fov.luts[0])["Y_log"].shape[0])
        tabs_s = rng.uniform(-5, 10, (n, H, W)).astype(np.float32)
        tabs_t = tabs_s + rng.uniform(-1, 1, (n, H, W)).astype(np.float32)
        meta = core_fov._fov_meta[0]

        def jax_rule(a, cot):
            from fovvideovdp_tpu.ops.pallas import band_score as jbs
            return _stacked(lambda *xs: jbs._band_score2_fov(*xs, tabs_s, tabs_t, tuple(meta)),
                            a, cot)
        return bs.band_score2_fov, [band, L, tabs_s, tabs_t, meta], (0, 1), jax_rule
    assert name == "mov_score"
    d = core_fov._moving_band_data(0)
    gaze_px = np.stack([np.linspace(5, W - 5, F), np.linspace(5, H - 5, F)], axis=1)
    gaze_dir = core_fov._gaze_directions(torch.tensor(gaze_px, dtype=torch.float32)).numpy()
    vd = core_fov._band_view_dir[0].numpy()
    V2s = d["V2"].numpy()
    V2t = None if d["V2_5"] is None else d["V2_5"].numpy()
    mm, m = d["meta"], d["meta"].score
    meta17 = (m.y0, m.dy, m.Ymin, m.Ymax, mm.es0, mm.des, mm.emin, mm.emax, mm.off5,
              m.p, m.q_s, m.q_t, m.c10, m.corr, m.beta, mm.ny, mm.nr)

    def jax_rule(a, cot):
        from fovvideovdp_tpu.ops.pallas import mov_score as jms
        statics = (d["t_r"].numpy(), vd[0], vd[1], gaze_dir, V2s,
                   V2s if V2t is None else V2t)
        return _stacked(lambda *xs: jms._mov_score(*xs, *statics, meta17), a, cot)
    return (ms.band_score2_mov, [band, L, vd, d["t_r"].numpy(), gaze_dir, V2s, V2t, d["meta"]],
            (0, 1), jax_rule)


def _jax_vjp(fn, primals, cot):
    """jax.vjp of ``fn`` at ``primals`` for the cotangent(s) ``cot``, the
    Pallas forward through the interpreter."""
    import jax
    import jax.numpy as jnp
    from fovvideovdp_tpu.ops import pallas as pallas_cfg
    with pallas_cfg.forced(True, interpret=True):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, primals))
        cot = tuple(map(jnp.asarray, cot))
        return [np.asarray(g) for g in vjp(cot if len(cot) > 1 else cot[0])]


def _stacked(fn, a, cot):
    """A JAX scorer of the four channels of a band taken apart: its
    gradients with respect to (band, L_bkg)."""
    band, L = a[0], a[1]
    g = _jax_vjp(fn, [band[:, 0], band[:, 1], band[:, 2], band[:, 3], L], cot)
    return [np.stack(g[:4], axis=1), g[4]]


def _torch_args(args, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            if isinstance(a, np.ndarray) else a for a in args]


def _cotangents(out, seed=1):
    rng = np.random.default_rng(seed)
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
                 .to(o.device) for o in outs)


def _grad(fn, args, diff, cot=None):
    """(outputs, cotangents, gradients of the args at ``diff``)."""
    args = [a.detach().requires_grad_(i in diff) if torch.is_tensor(a) else a
            for i, a in enumerate(args)]
    out = fn(*args)
    cot = _cotangents(out) if cot is None else cot
    outs = out if isinstance(out, tuple) else (out,)
    return out, cot, torch.autograd.grad(outs, [args[i] for i in diff], cot)


def _band_views(fn, args):
    """band_score takes channel views of one stack, as the core gives them."""
    if fn is bs.band_score:
        stack = torch.stack([args[0], args[1]], dim=1)
        return [stack[:, 0], stack[:, 1]] + args[2:]
    return args


@pytest.mark.parametrize("name", CASES)
def test_gradient_equals_the_plain_versions_bit_for_bit(cores, name):
    fn, args, diff, _ = _case(name, cores)
    args = _torch_args(args)
    out, cot, got = _grad(fn, args, diff)
    assert (out if torch.is_tensor(out) else out[0]).grad_fn is not None
    _, _, want = _grad(fn.op.plain, args, diff, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", CASES)
def test_gradient_goes_through_the_function(cores, name):
    fn, args, diff, _ = _case(name, cores)
    args = [a.requires_grad_() if i in diff else a
            for i, a in enumerate(_torch_args(args))]
    out = fn(*args)
    first = out if torch.is_tensor(out) else out[0]
    assert type(first.grad_fn).__name__ == "_KernelFunctionBackward"
    with torch.no_grad():
        first = fn(*args)
    first = first if torch.is_tensor(first) else first[0]
    assert first.grad_fn is None and not first.requires_grad


@pytest.mark.parametrize("name", CASES)
def test_gradient_matches_the_jax_custom_vjp(cores, name):
    pytest.importorskip("jax")
    fn, args, diff, jax_rule = _case(name, cores)
    targs = _torch_args(args)
    _, cot, got = _grad(fn, targs, diff)
    want = jax_rule(args, [c.numpy() for c in cot])
    assert len(want) == len(got)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
        err = float(np.abs(g.numpy() - w).max(initial=0.0))
        print(f"{name}: max |dg| {err:.3g} of max |g| {scale:.3g}")
        assert err <= JAX_RTOL * scale


@pytest.mark.parametrize("name", CASES)
def test_non_differentiable_arguments_get_no_gradient(cores, name):
    fn, args, diff, _ = _case(name, cores)
    args = [a.requires_grad_() if torch.is_tensor(a) else a for a in _torch_args(args)]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, _cotangents(out))
    for i, a in enumerate(args):
        if torch.is_tensor(a):
            assert (a.grad is not None) == (i in diff), (name, i)


@pytest.mark.parametrize("name", FRAMED)
def test_chunked_recompute_equals_recompute_at_once(cores, name):
    fn, args, diff, _ = _case(name, cores)
    args = _torch_args(args)
    out = fn(*args)
    cot = _cotangents(out)
    at_once = _autograd.vjp(fn.op, args, diff, cot)
    for frames in (1, 2):
        chunked = _autograd.vjp(fn.op, args, diff, cot, frames=frames)
        for g, w in zip(chunked, at_once):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", FRAMED)
def test_backward_recomputes_a_frame_at_a_time_on_a_small_budget(cores, name, monkeypatch):
    fn, args, diff, _ = _case(name, cores)
    args = _torch_args(args)
    _, cot, want = _grad(fn, args, diff)
    monkeypatch.setattr(memory, "CPU_RECOMPUTE_BYTES", 1)
    assert _autograd.recompute_frames(fn.op, args) == 1
    _, _, got = _grad(fn, args, diff, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_recompute_frames_follows_the_budget(cores):
    fn, args, _, _ = _case("mov_score", cores)
    args = _torch_args(args)
    per_frame = 5 * H * W * 4 + 2 * 4          # band, L_bkg and the gaze row
    frames = _autograd.recompute_frames(fn.op, args)
    assert frames == int(memory.CPU_RECOMPUTE_BYTES // (ms.GRAPH_BYTES * per_frame))
    assert _autograd.recompute_frames(tmp.temporal_pair.op, [args[1]] * 4) is None
    # a single (h, w) plane has no frame axis to cut
    x = torch.ones((H, W))
    assert _autograd.recompute_frames(red.gausspyr_reduce.op, [x]) is None


def test_keyword_arguments_and_defaults_reach_the_function(cores):
    fine, coarse = (torch.from_numpy(a) for a in _pyramid_pair(np.random.default_rng(0)))
    a = fine.clone().requires_grad_()
    c1, l1 = ec.expand_contrast(a, coarse)
    c2, l2 = ec.expand_contrast(a, g_coarse=coarse, bkg_channel=1)
    assert torch.equal(c1, c2) and torch.equal(l1, l2)
    g1, = torch.autograd.grad(c1.sum() + l1.sum(), a)
    g2, = torch.autograd.grad(c2.sum() + l2.sum(), a)
    assert torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# On the card: the Function, whose forward launches the kernel, against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(value, device):
    if torch.is_tensor(value):
        return value.to(device)
    return value


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_function_on_the_card_matches_the_cpu(cores, cuda, name):
    from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
    fn, args, diff, _ = _case(name, cores)
    cpu_args = _band_views(fn, _torch_args(args))
    out, cot, want = _grad(fn, cpu_args, diff)
    cuda_ops.reset_launch_counts()
    dev_args = _band_views(fn, [_to(a, cuda) for a in cpu_args])
    _, _, got = _grad(fn, dev_args, diff, tuple(c.to(cuda) for c in cot))
    torch.cuda.synchronize()
    assert sum(cuda_ops.launch_counts().values()) == 1
    for g, w in zip(got, want):
        if w.numel():
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g.cpu() - w).abs().max()) <= CUDA_RTOL * scale
