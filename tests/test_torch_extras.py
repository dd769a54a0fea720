"""The reference's extras in fovvideovdp_tpu_torch on the CPU, against the
goldens and the JAX package on the same inputs: the PU21 encoding, PU21-PSNR,
the preference mapping, ``interp1``, the hdrvdp visualisations, the gaze
cross, the sRGB transfer functions, the testbench, the small utils and
``update_device``.

Bars: ``PU`` against ``pu_transform.npz`` at rtol 1e-4 / atol 5e-3 (the
curve crosses zero near L_min, where torch's and XLA's float32 pow differ;
tests/test_primitives.py:85-95) and against JAX at rtol 1e-5 / atol 1e-3;
``pu_psnr`` against ``pu_psnr.npz`` within 0.05 dB
(tests/test_metric_e2e.py:139-147) and JAX within 1e-3 dB; the preference
atol 1e-5; the visualisations atol 1e-4; the gaze cross bit for bit; the
sRGB functions rtol 1e-6.  The ``gpu`` tests hold the card against
``device="cpu"``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu_torch import hdrvdp_visualize as port_vis
from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.ops.interp import interp1
from fovvideovdp_tpu_torch.preference import fvvdp_preference
from fovvideovdp_tpu_torch.testbench import FovVideoVDP_Testbench
from fovvideovdp_tpu_torch.visualize import add_fixation_cross

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("pupsnr", "preference", "hdrvdp_visualize", "testbench", "ops.interp",
               "utils", "visualize")


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _video(seed=7, shape=(40, 56, 3, 12)):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-30, 30, ref.shape), 0, 255).astype(np.uint8)
    return tst, ref


# ---------------------------------------------------------------------------
# PU21 and PU21-PSNR
# ---------------------------------------------------------------------------

def test_pu_against_the_golden(goldens):
    g = goldens("pu_transform")
    pu = utils.PU()
    V = pu.encode(torch.as_tensor(g["Y"])).numpy()
    np.testing.assert_allclose(V, g["V"], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(pu.peak, g["peak"], rtol=1e-6)
    Y2 = pu.decode(torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(Y2, np.clip(g["Y"], pu.L_min, pu.L_max), rtol=5e-3)


@pytest.mark.parametrize("kind", list(utils.PU.COEFFS))
def test_pu_against_jax(kind):
    import jax.numpy as jnp
    from fovvideovdp_tpu.utils import PU as jax_PU
    Y = np.logspace(-3.5, 4.2, 500).astype(np.float32)
    mine, theirs = utils.PU(type=kind), jax_PU(type=kind)
    assert mine.peak == theirs.peak and mine.COEFFS == theirs.COEFFS
    V = mine.encode(torch.as_tensor(Y)).numpy()
    np.testing.assert_allclose(V, np.asarray(theirs.encode(jnp.asarray(Y))), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(mine.decode(torch.as_tensor(V)).numpy(),
                               np.asarray(theirs.decode(jnp.asarray(V))), rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError):
        utils.PU(type="unknown")


def test_pu_psnr_against_the_golden(goldens):
    g = goldens("pu_psnr")
    pp = fvt.pu_psnr(device="cpu")
    pp.display_photometry = fvt.fvvdp_display_photometry.load("standard_4k")
    Q, stats = pp.predict(g["test"], g["ref"], dim_order="HWC")
    assert stats is None
    np.testing.assert_allclose(Q, float(g["Q"]), atol=0.05)


@pytest.mark.parametrize("content", ["image", "clip"])
def test_pu_psnr_against_jax(content):
    from fovvideovdp_tpu import pu_psnr as jax_pu_psnr
    tst, ref = _video()
    if content == "image":
        args, kw = (tst[..., 0], ref[..., 0]), dict(dim_order="HWC")
    else:     # 12 frames: a block of 16 holds them all, and one of 5 leaves a tail of 2
        args, kw = (tst, ref), dict(dim_order="HWCF", frames_per_second=30)
    q_j, _ = jax_pu_psnr().predict(*args, **kw)
    q_p, _ = fvt.pu_psnr(device="cpu").predict(*args, **kw)
    assert abs(q_p - q_j) <= 1e-3
    if content == "clip":
        from fovvideovdp_tpu_torch import pupsnr
        old = pupsnr._BLOCK_FRAMES
        pupsnr._BLOCK_FRAMES = 5
        try:
            q_5, _ = fvt.pu_psnr(device="cpu").predict(*args, **kw)
        finally:
            pupsnr._BLOCK_FRAMES = old
        assert abs(q_5 - q_p) <= 1e-9


def test_pu_psnr_surface():
    pp = fvt.pu_psnr(device="cpu")
    assert (pp.short_name(), pp.quality_unit(), pp.get_info_string()) == \
        ("PU21-PSNR", "dB", None)
    assert pp.device == torch.device("cpu")


def test_pu_psnr_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fvt.pu_psnr()


# ---------------------------------------------------------------------------
# preference, interp1, sRGB
# ---------------------------------------------------------------------------

def test_preference_against_jax():
    from fovvideovdp_tpu.preference import fvvdp_preference as jax_pref
    d = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(fvvdp_preference(d).numpy(), np.asarray(jax_pref(d)), atol=1e-5)
    assert abs(float(fvvdp_preference(0.0)) - 50.0) <= 1e-4
    assert abs(float(fvvdp_preference(1.0)) - 75.0) <= 0.5
    assert abs(float(fvvdp_preference(torch.tensor(2.5))) + float(fvvdp_preference(-2.5))
               - 100.0) <= 1e-3


def test_interp1_against_jax():
    import jax.numpy as jnp
    from fovvideovdp_tpu.ops.interp import interp1 as jax_interp1
    x = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    v = np.array([1.0, 3.0, -2.0, 0.5, 4.0], np.float32)
    q = np.random.RandomState(0).uniform(-0.3, 1.3, (7, 9)).astype(np.float32)
    q[0, :5] = x                                  # on the knots
    got = interp1(torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(q)).numpy()
    want = np.asarray(jax_interp1(jnp.asarray(x), jnp.asarray(v), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_srgb_transfer_against_jax():
    from fovvideovdp_tpu.utils import linear2srgb as j_l2s
    from fovvideovdp_tpu.utils import srgb2linear as j_s2l
    x = np.linspace(-0.1, 1.1, 1201).astype(np.float32)
    np.testing.assert_allclose(utils.srgb2linear(torch.as_tensor(x)).numpy(),
                               np.asarray(j_s2l(x)), rtol=1e-6)
    np.testing.assert_allclose(utils.linear2srgb(torch.as_tensor(x)).numpy(),
                               np.asarray(j_l2s(x)), rtol=1e-6)
    y = np.linspace(0, 1, 101).astype(np.float32)
    np.testing.assert_allclose(utils.linear2srgb(utils.srgb2linear(torch.as_tensor(y))).numpy(),
                               y, atol=1e-5)


def test_numpy_helpers_against_jax():
    from fovvideovdp_tpu import utils as jax_utils
    rng = np.random.RandomState(0)
    img = (rng.rand(6, 8, 1) * 255).astype(np.uint8)
    a = jax_utils.img2np(img)
    assert np.array_equal(utils.img2np(img), a) and utils.img2np(img).dtype == np.float32
    assert np.array_equal(utils.l2rgb(a), jax_utils.l2rgb(a))
    stack = rng.rand(3, 6, 8, 3)
    assert np.array_equal(utils.stack_horizontal(stack), jax_utils.stack_horizontal(stack))
    assert np.array_equal(utils.stack_vertical(stack), jax_utils.stack_vertical(stack))


def test_platform_info():
    line = utils.platform_info()
    cpu, acc = line.split(" | ")
    assert cpu and acc
    if not torch.cuda.is_available():
        assert acc == "no CUDA card"


# ---------------------------------------------------------------------------
# visualisations
# ---------------------------------------------------------------------------

def _prob_map(shape=(24, 32)):
    return np.random.RandomState(0).rand(*shape).astype(np.float32)


def _context(shape=(24, 32, 3)):
    return (np.random.RandomState(1).rand(*shape) * 100 + 1).astype(np.float32)


@pytest.mark.parametrize("colormap", ["trichromatic", "dichromatic", "monochromatic"])
@pytest.mark.parametrize("target", ["screen", "print"])
@pytest.mark.parametrize("context", ["rgb", "luminance", "none"])
def test_visualize_pmap_against_jax(colormap, target, context):
    from fovvideovdp_tpu import hdrvdp_visualize as jax_vis
    ctx = {"rgb": _context(), "luminance": _context((24, 32)), "none": None}[context]
    P = _prob_map()
    got = port_vis.visualize_pmap(torch.as_tensor(P), ctx, target=target, colormap=colormap)
    want = jax_vis.visualize_pmap(P, ctx, target=target, colormap=colormap)
    assert tuple(got.shape) == (24, 32, 3)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_visualize_diff_and_norm_diff_against_jax():
    from fovvideovdp_tpu import hdrvdp_visualize as jax_vis
    rng = np.random.RandomState(2)
    ref = (rng.rand(24, 32) * 100).astype(np.float32)
    tst = ref + rng.randn(24, 32).astype(np.float32) * 5 + 5.0
    np.testing.assert_allclose(_np(port_vis.norm_diff_img(tst, ref)),
                               _np(jax_vis.norm_diff_img(tst, ref)), atol=1e-4)
    rgb_t, rgb_r = _context(), _context()[::-1].copy()
    np.testing.assert_allclose(_np(port_vis.norm_diff_img(rgb_t, rgb_r, sigma=2.0)),
                               _np(jax_vis.norm_diff_img(rgb_t, rgb_r, sigma=2.0)), atol=1e-4)
    for target in ("screen", "print"):
        np.testing.assert_allclose(
            _np(port_vis.visualize_diff(_prob_map(), tst, ref, _context(), target=target)),
            _np(jax_vis.visualize_diff(_prob_map(), tst, ref, _context(), target=target)),
            atol=1e-4)


def test_visualize_civdm_against_jax():
    from fovvideovdp_tpu import hdrvdp_visualize as jax_vis
    rng = np.random.RandomState(3)
    loss, ampl, rev = (rng.rand(16, 16).astype(np.float32) for _ in range(3))
    ctx = (np.random.RandomState(4).rand(16, 16) * 100 + 1).astype(np.float32)
    for c in (None, ctx):
        got = port_vis.visualize_civdm(loss, ampl, rev, c)
        np.testing.assert_allclose(_np(got), _np(jax_vis.visualize_civdm(loss, ampl, rev, c)),
                                   atol=1e-4)
    assert ((_np(port_vis.visualize_civdm(loss, ampl, rev)) > 0).sum(-1) <= 1).all()


def test_visualize_refusals():
    with pytest.raises(RuntimeError, match="colormap"):
        port_vis.visualize_pmap(_prob_map(), colormap="viridis")
    with pytest.raises(RuntimeError, match="target"):
        port_vis.visualize_pmap(_prob_map(), _context(), target="web")


def test_blur_and_log_luminance_against_jax():
    from fovvideovdp_tpu import hdrvdp_visualize as jax_vis
    X = np.random.RandomState(5).rand(20, 27).astype(np.float32)
    np.testing.assert_allclose(_np(port_vis._blur_gaussian(torch.as_tensor(X), 2.0)),
                               _np(jax_vis._blur_gaussian(X, 2.0)), atol=1e-6)
    zero = np.zeros((6, 7), np.float32)
    got = port_vis._log_luminance(torch.as_tensor(zero))
    assert np.allclose(_np(got), np.log(1e-6)) and np.allclose(
        _np(got), _np(jax_vis._log_luminance(zero)))


@pytest.mark.parametrize("point,size,value", [((10, 7), 21, 1.0), ((0, 0), 5, 0.25),
                                              ((30.7, 2.2), 9, 3.0), ((-4, 40), 21, 1.0)])
def test_add_fixation_cross_against_jax(point, size, value):
    from fovvideovdp_tpu.visualize import add_fixation_cross as jax_cross
    frame = np.random.RandomState(6).rand(3, 24, 32).astype(np.float32)
    got = add_fixation_cross(torch.as_tensor(frame), point, size=size, value=value).numpy()
    want = np.asarray(jax_cross(frame, point, size=size, value=value))
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the testbench
# ---------------------------------------------------------------------------

def _dumps(tmp_path):
    from scipy.io import savemat
    rng = np.random.RandomState(8)
    a, b = rng.rand(4, 5).astype(np.float32), rng.rand(3).astype(np.float32)
    np.savez(tmp_path / "bands.npz", T=a, R=b)
    np.save(tmp_path / "lum.npy", a)
    savemat(str(tmp_path / "mat_dump.mat"), {"S": b.astype(np.float64), "Q": a})
    savemat(str(tmp_path / "empty.mat"), {})
    return a, b


def _bench_run(bench, a, b, as_tensor):
    t = torch.as_tensor if as_tensor else np.asarray
    outcomes = []
    for args, kw in [
            ((t(a), "bands"), dict(key="T")), ((t(b), "bands"), dict(key="R")),
            ((t(a + 2e-3), "bands"), dict(key="T")),
            ((t(a * 1.0005), "bands"), dict(key="T", relative=True)),
            ((t(a), "lum"), {}), ((t(a[:3]), "lum"), {}),
            ((t(b), "mat_dump"), dict(key="S")), ((t(a), "mat_dump"), dict(key="Q")),
            ((t(a), "nowhere"), {})]:
        outcomes.append(bench.verify(*args, **kw))
    for args, kw, err in [((t(a), "bands"), dict(key="X"), KeyError),
                          ((t(a), "mat_dump"), dict(key="X"), KeyError),
                          ((t(a), "empty"), {}, RuntimeError)]:
        with pytest.raises(err):
            bench.verify(*args, **kw)
    return outcomes, bench.total_tested, bench.total_passed, [f for f, _ in bench.failures], \
        bench.print_summary()


def test_testbench_outcomes_match_jax(tmp_path):
    from fovvideovdp_tpu.testbench import FovVideoVDP_Testbench as JaxBench
    a, b = _dumps(tmp_path)
    mine = _bench_run(FovVideoVDP_Testbench(str(tmp_path)), a, b, as_tensor=True)
    theirs = _bench_run(JaxBench(str(tmp_path)), a, b, as_tensor=False)
    assert mine == theirs
    assert mine[0] == [True, True, False, True, True, False, True, True, False]


# ---------------------------------------------------------------------------
# update_device, and what the new modules import
# ---------------------------------------------------------------------------

def test_update_device_to_the_cpu_drops_the_cores():
    tst, ref = _video(shape=(32, 48, 3, 6))
    fv = fvt.fvvdp(display_name="standard_fhd", foveated=True, device="cpu")
    call = dict(dim_order="HWCF", frames_per_second=30, fixation_point=np.array([20, 12]))
    q0, _ = fv.predict(tst, ref, **call)
    core = fv._get_core(48, 32)
    assert core._fov_table_cache
    cache = fv.csf_cache
    fv.update_device("cpu")
    assert fv._cores == {} and not core._fov_table_cache and fv.csf_cache is not cache
    assert all(v.device.type == "cpu" for lut in fv._luts for v in lut.values()
               if torch.is_tensor(v))
    q1, _ = fv.predict(tst, ref, **call)
    assert q1 == q0


def test_update_device_to_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fv = fvt.fvvdp(display_name="standard_fhd", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fv.update_device("cuda")
    assert fv.device == torch.device("cpu")


def test_new_modules_import_no_jax():
    mods = ", ".join(f"fovvideovdp_tpu_torch.{m}" for m in NEW_MODULES)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}.split(', '):\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'fovvideovdp_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_pu_psnr_matches_cpu(cuda):
    from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
    tst, ref = _video(shape=(270, 480, 3, 20))
    kw = dict(dim_order="HWCF", frames_per_second=30)
    cuda_ops.reset_launch_counts()
    q_card, _ = fvt.pu_psnr().predict(tst, ref, **kw)
    counts = cuda_ops.launch_counts()
    # the frames' luminance is the only kernel PU21-PSNR reaches
    assert counts["luminance"] > 0 and not any(v for k, v in counts.items() if k != "luminance")
    q_cpu, _ = fvt.pu_psnr(device="cpu").predict(tst, ref, **kw)
    assert abs(q_card - q_cpu) <= 1e-3


@pytest.mark.gpu
def test_card_visualisations_match_cpu(cuda):
    P, ctx = _prob_map(), _context()
    for target in ("screen", "print"):
        got = port_vis.visualize_pmap(torch.as_tensor(P, device=cuda),
                                      torch.as_tensor(ctx, device=cuda), target=target)
        want = port_vis.visualize_pmap(torch.as_tensor(P), torch.as_tensor(ctx), target=target)
        assert got.is_cuda
        np.testing.assert_allclose(_np(got.cpu()), _np(want), atol=1e-4)


@pytest.mark.gpu
def test_card_update_device_matches_a_card_metric(cuda):
    tst, ref = _video(shape=(270, 480, 3, 8))
    kw = dict(dim_order="HWCF", frames_per_second=30)
    fv = fvt.fvvdp(display_name="standard_fhd", device="cpu")
    fv.predict(tst, ref, **kw)
    fv.update_device("cuda")
    q, _ = fv.predict(tst, ref, **kw)
    q_card, _ = fvt.fvvdp(display_name="standard_fhd").predict(tst, ref, **kw)
    assert abs(q - q_card) <= 1e-6
