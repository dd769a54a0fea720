"""The metric's ablations and options in fovvideovdp_tpu_torch on the CPU,
against the JAX package on the same inputs: the ``local_adapt`` variants,
log contrast, the masking ablations, ``pu_dilate``,
``ignore_boundary_pixels``, ``band_callback`` and the 360° content mapping,
through ``predict``, ``predict_batch`` and ``predict_traced``; their route
and the wrappers it reaches (JAX's gating, ``fovvideovdp_tpu/core.py:418-449``);
``ImGaussFilt`` and the ``pu_dilate`` masking.

Inputs follow tests/test_core_options.py:9-14 and
tests/test_round2_fixes.py:15-99.  Bars: |dJOD| <= 1e-4 and Q_per_ch at
rtol 2e-3 / atol 2e-4 (tests/test_metric_e2e.py:13-17); the callback's
arrays, ``ImGaussFilt`` and the masking at rtol 1e-5; gradients at the bars
of tests/test_torch_traced.py.  Both packages load the shipped LUTs, which
the port holds byte for byte (tests/test_torch_package.py).

The ``gpu`` tests hold each option group on the card against
``device="cpu"``; they import no JAX, so they run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_options.py``.
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.content_mapping import fvvdp_content_mapping_equirect
from fovvideovdp_tpu_torch.ops import masking as mask_ops

torch.set_num_threads(2)

JOD_BAR = 1e-4
Q_BAR = dict(rtol=2e-3, atol=2e-4)
GRAD_BAR = dict(rtol=2e-3, atol=5e-6)


def _jax():
    """The JAX package, imported where a test compares with it."""
    import fovvideovdp_tpu
    return fovvideovdp_tpu


def _video(seed=3, shape=(32, 48, 3, 5)):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref / 255.0 + rng.randn(*ref.shape) * 0.05, 0, 1)
    return (tst * 255).astype(np.uint8), ref


def _content(kind):
    tst, ref = _video()
    if kind == "image":
        return tst[..., 0], ref[..., 0], dict(dim_order="HWC")
    return tst, ref, dict(dim_order="HWCF", frames_per_second=30)


def _mapping(pkg_name):
    if pkg_name == "jax":
        from fovvideovdp_tpu.content_mapping import fvvdp_content_mapping_equirect as cm
        return cm(48, 32)
    return fvvdp_content_mapping_equirect(48, 32)


def _both(kwargs, **extra):
    """(JAX metric, the port's metric on the CPU) with the same options;
    ``content_mapping=True`` stands for each package's equirect mapping."""
    kw = dict(display_name="standard_fhd", **kwargs, **extra)
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if kw.get("content_mapping") is True:
        jkw["content_mapping"], pkw["content_mapping"] = _mapping("jax"), _mapping("port")
    return _jax().fvvdp(**jkw), fv_port.fvvdp(**pkw)


def _assert_scores_match(got, want):
    (q_p, s_p), (q_j, s_j) = got, want
    assert np.isfinite(q_p)
    assert abs(q_p - q_j) <= JOD_BAR, (q_p, q_j)
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]), **Q_BAR)


OPTIONS = {
    "gpyr0": dict(parameter_overrides={"local_adapt": "gpyr0"}),
    "gpyr2": dict(parameter_overrides={"local_adapt": "gpyr2"}),
    "simple": dict(parameter_overrides={"local_adapt": "simple"}),
    "global": dict(parameter_overrides={"local_adapt": "global"}),
    "log": dict(parameter_overrides={"contrast": "log"}),
    "log_gpyr0": dict(parameter_overrides={"contrast": "log", "local_adapt": "gpyr0"}),
    "contrast_difference": dict(parameter_overrides={"masking_model": "contrast_difference"}),
    "contrast_difference_perc_norm": dict(
        parameter_overrides={"masking_model": "contrast_difference_perc_norm"}),
    "pu_dilate": dict(parameter_overrides={"pu_dilate": 0.5}),
    "ignore_boundary_pixels": dict(ignore_boundary_pixels=True),
}


@pytest.mark.parametrize("kind", ["video", "image"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(option, kind):
    tst, ref, call = _content(kind)
    jm, pm = _both(OPTIONS[option])
    _assert_scores_match(pm.predict(tst, ref, **call), jm.predict(tst, ref, **call))
    core = pm._get_core(48, 32)
    assert core.route == "composed"
    if kind == "image":
        assert np.all(pm.predict(tst, ref, **call)[1]["Q_per_ch"][:, 1] == 0.0)


def test_band_callback_sees_what_jax_sees():
    """The same (band, channel) calls, with T, R and N_nCSF on the host at
    rtol 1e-5.  JAX's callbacks are unordered within a band, so the calls
    are compared sorted."""
    tst, ref, call = _content("video")
    calls = {"jax": [], "port": []}

    def recorder(name):
        def cb(bb, n_bands, cc, T_f, R_f, N):
            calls[name].append(((int(bb), int(n_bands), int(cc)),
                                [np.array(np.asarray(a)) for a in (T_f, R_f, N)]))
        return cb

    jm, pm = _both({}, band_callback=recorder("jax"))
    pm.band_callback = recorder("port")
    pm._cores = {}
    _assert_scores_match(pm.predict(tst, ref, **call), jm.predict(tst, ref, **call))
    j_calls = sorted(calls["jax"], key=lambda c: c[0])
    p_calls = sorted(calls["port"], key=lambda c: c[0])
    assert [c[0] for c in p_calls] == [c[0] for c in j_calls]
    assert len({c[0][0] for c in p_calls}) == 4
    for (_, got), (key, want) in zip(p_calls, j_calls):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(key))


def test_band_callback_gets_host_tensors_and_changes_no_score():
    tst, ref, call = _content("video")
    seen = []
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       band_callback=lambda *a: seen.append(a))
    q_cb, _ = fv.predict(tst, ref, **call)
    q, _ = fv_port.fvvdp(display_name="standard_fhd", device="cpu").predict(tst, ref, **call)
    assert abs(q_cb - q) <= 1e-5
    bb, n_bands, cc, T_f, R_f, N = seen[0]
    assert (bb, n_bands, cc) == (0, 4, 0)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in (T_f, R_f, N))
    assert np.asarray(T_f).shape == (5, 32, 48)


@pytest.mark.parametrize("kind", ["video", "image"])
def test_content_mapping_matches_jax(kind):
    """Foveated 360° content: the point becomes a gaze per frame, no table
    is built, and the eccentricity is the mapping's."""
    tst, ref, call = _content(kind)
    call["fixation_point"] = np.array([24, 16])
    jm, pm = _both(dict(foveated=True, content_mapping=True))
    _assert_scores_match(pm.predict(tst, ref, **call), jm.predict(tst, ref, **call))
    core = pm._get_core(48, 32)
    assert core.route == core.moving_route == "composed"
    assert not core._fov_table_cache and core.fov_table_bytes() == 0


def test_content_mapping_eccentricity_matches_jax():
    rng = np.random.RandomState(2)
    xx = rng.rand(7, 9).astype(np.float32) * 48
    yy = rng.rand(7, 9).astype(np.float32) * 32
    g = np.array([[3.5, 30.5], [40.5, 2.5]], np.float32)
    got = _mapping("port").eccentricity((48, 32), torch.tensor(xx), torch.tensor(yy),
                                        torch.tensor(g[:, 0, None, None]),
                                        torch.tensor(g[:, 1, None, None]))
    want = np.stack([np.asarray(_mapping("jax").eccentricity((48, 32), xx, yy, gx, gy))
                     for gx, gy in g])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-3)


def test_content_mapping_is_ignored_without_foveation():
    tst, ref, call = _content("video")
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       content_mapping=_mapping("port"))
    q, _ = fv.predict(tst, ref, **call)
    q0, _ = fv_port.fvvdp(display_name="standard_fhd", device="cpu").predict(tst, ref, **call)
    assert fv._get_core(48, 32).route == "fused" and q == q0


@pytest.mark.parametrize("gaze", ["fixed", "moving"])
def test_simple_adaptation_foveated_matches_jax(gaze):
    tst, ref, call = _content("video")
    call["fixation_point"] = np.array([30.0, 10.0]) if gaze == "fixed" else \
        np.stack([np.linspace(2, 45, 5), np.linspace(30, 1, 5)], axis=1).astype(np.float32)
    jm, pm = _both(dict(foveated=True, **OPTIONS["simple"]))
    _assert_scores_match(pm.predict(tst, ref, **call), jm.predict(tst, ref, **call))
    core = pm._get_core(48, 32)
    # the ablations keep the whole Y grid: L_bkg may fall below 0.1 cd/m^2
    assert core._fov_trim is None
    assert bool(core._fov_table_cache) == (gaze == "fixed")


@pytest.mark.parametrize("kind", ["video", "image"])
def test_raw_heatmap_with_ignored_boundary_matches_jax(kind):
    tst, ref, call = _content(kind)
    jm, pm = _both(dict(heatmap="raw", ignore_boundary_pixels=True))
    got, want = pm.predict(tst, ref, **call), jm.predict(tst, ref, **call)
    _assert_scores_match(got, want)
    hp, hj = got[1]["heatmap"].astype(np.float32), np.asarray(want[1]["heatmap"], np.float32)
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("content", ["images", "clips"])
@pytest.mark.parametrize("option", ["log", "global"])
def test_predict_batch_matches_jax(option, content):
    rng = np.random.RandomState(9)
    shape = (3, 32, 48, 3) if content == "images" else (3, 32, 48, 3, 4)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-25, 25, ref.shape),
                  0, 255).astype(np.uint8)
    call = dict(dim_order="BHWC") if content == "images" else \
        dict(dim_order="BHWCF", frames_per_second=30)
    jm, pm = _both(OPTIONS[option])
    j_jods, j_stats = jm.predict_batch(tst, ref, **call)
    p_jods, p_stats = pm.predict_batch(tst, ref, **call)
    np.testing.assert_allclose(p_jods, np.asarray(j_jods), rtol=0, atol=JOD_BAR)
    if content == "clips":
        np.testing.assert_allclose(p_stats["Q_per_ch"], np.asarray(j_stats["Q_per_ch"]),
                                   **Q_BAR)
    # each pair scores as it does alone
    for i in range(3):
        q_i, _ = pm.predict(tst[i], ref[i], **dict(call, dim_order=call["dim_order"][1:]))
        assert abs(q_i - p_jods[i]) <= 1e-5


def _float_pair(seed, shape):
    rng = np.random.RandomState(seed)
    ref = rng.rand(*shape).astype(np.float32)
    tst = np.clip(ref + rng.randn(*shape).astype(np.float32) * 0.05, 0, 1)
    return tst.astype(np.float32), ref


@pytest.mark.parametrize("kind", ["image", "video"])
def test_traced_log_contrast_matches_jax(kind):
    """predict_traced under contrast="log": the JOD against JAX's and the
    loss's gradient against jax.grad."""
    import jax
    if kind == "image":
        tst, ref = _float_pair(5, (40, 56, 3))
        call = dict(dim_order="HWC")
    else:
        tst, ref = _float_pair(1, (24, 32, 6))
        call = dict(dim_order="HWF", frames_per_second=30)
    jm, pm = _both(OPTIONS["log"])
    val_j, g_j = jax.jit(jax.value_and_grad(lambda x: jm.loss(x, ref, **call)))(tst)
    x = torch.tensor(tst, requires_grad=True)
    loss = pm.loss(x, torch.tensor(ref), **call)
    loss.backward()
    g, g_j = x.grad.numpy(), np.asarray(g_j)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert abs(float(loss.detach()) - float(val_j)) <= JOD_BAR
    np.testing.assert_allclose(g, g_j, **GRAD_BAR)
    q_stream, _ = pm.predict(tst, ref, **call)
    assert abs(float(pm.predict_traced(tst, ref, **call)) - q_stream) <= 1e-4


@pytest.mark.parametrize("mode", ["gpyr0", "global"])
def test_dark_content_clamp_matches_jax(mode):
    """Content below 0.1 cd/m^2: L_bkg is clamped before the Weber division
    (tests/test_round2_fixes.py:80-99)."""
    rng = np.random.RandomState(1)
    ref = rng.rand(32, 48).astype(np.float32) * 0.05 + 0.01
    tst = np.clip(ref + rng.randn(32, 48).astype(np.float32) * 0.002, 1e-4, None)
    from fovvideovdp_tpu.display_model import fvvdp_display_photo_absolute as jax_abs
    jm = _jax().fvvdp(display_name="standard_fhd", display_photometry=jax_abs(),
                      parameter_overrides={"local_adapt": mode})
    pm = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       display_photometry=fv_port.fvvdp_display_photo_absolute(),
                       parameter_overrides={"local_adapt": mode})
    got = pm.predict(tst[..., None], ref[..., None], dim_order="HWC")
    _assert_scores_match(got, jm.predict(tst[..., None], ref[..., None], dim_order="HWC"))
    assert 5.0 < got[0] <= 10.0


@pytest.mark.parametrize("pu_dilate", [0.0, 0.7])
def test_masking_model_matches_jax(pu_dilate):
    from fovvideovdp_tpu.ops import masking as jax_masking
    rng = np.random.RandomState(0)
    T, R = (rng.randn(2, 16, 24).astype(np.float32) for _ in range(2))
    N = rng.rand(2, 16, 24).astype(np.float32) + 0.05
    got = mask_ops.apply_masking_model(torch.tensor(T), torch.tensor(R), torch.tensor(N),
                                       2.4, 2.43, -0.97, pu_dilate=pu_dilate)
    want = jax_masking.apply_masking_model(T, R, N, 2.4, 2.43, -0.97, pu_dilate=pu_dilate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    W = rng.rand(3, 5).astype(np.float32) * 3
    np.testing.assert_allclose(mask_ops.weber2log(torch.tensor(W)).numpy(),
                               np.asarray(jax_masking.weber2log(W)), rtol=1e-6)


@pytest.mark.parametrize("pad_mode", ["reflect", "edge"])
@pytest.mark.parametrize("sigma,shape", [(0.7, (2, 1, 16, 24)), (18.9, (3, 1, 32, 48)),
                                         (2.5, (9, 13))])
def test_imgaussfilt_matches_jax(pad_mode, sigma, shape):
    """Both pad modes, with a support wider than the image (0.5 deg at
    standard_fhd: reflected again and again, as np.pad does)."""
    from fovvideovdp_tpu.utils import ImGaussFilt as JaxFilt
    from fovvideovdp_tpu.utils import gaussian_kernel_2d
    x = np.random.RandomState(4).rand(*shape).astype(np.float32) * 100
    got = utils.ImGaussFilt(sigma, pad_mode=pad_mode).run(torch.tensor(x))
    want = JaxFilt(sigma, pad_mode=pad_mode).run(x)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(utils.gaussian_kernel_2d(sigma), gaussian_kernel_2d(sigma))


@pytest.mark.parametrize("log", [False, True])
def test_decompose_matches_jax_on_log_input(log):
    """The Laplacian decomposition the options take, on luminance and on
    log10 luminance."""
    from fovvideovdp_tpu.ops.pyramid import PyramidPlan as JaxPlan
    from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan
    x = np.random.RandomState(6).rand(2, 4, 37, 53).astype(np.float32) * 200 + 0.01
    if log:
        x = np.log10(x)
    bands, gbands = PyramidPlan(53, 37, 60.0).decompose(torch.tensor(x))
    j_bands, j_gbands = JaxPlan(53, 37, 60.0).decompose(x)
    for got, want in zip(bands + gbands, list(j_bands) + list(j_gbands)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the route and the wrappers it reaches, against JAX's gating
# ---------------------------------------------------------------------------

WRAPPERS = {
    "gausspyr_reduce": "fovvideovdp_tpu_torch.ops.cuda.reduce",
    "expand_contrast": "fovvideovdp_tpu_torch.ops.cuda.expand_contrast",
    "expand_score2": "fovvideovdp_tpu_torch.ops.cuda.band_pipeline",
    "band_score": "fovvideovdp_tpu_torch.ops.cuda.band_score",
    "band_score2_fov": "fovvideovdp_tpu_torch.ops.cuda.band_score",
    "band_score2_mov": "fovvideovdp_tpu_torch.ops.cuda.mov_score",
    "temporal_channels_pair": "fovvideovdp_tpu_torch.ops.temporal",
}


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls of each kernel wrapper (its plain version runs on
    the CPU, so the launch counts stay 0 here)."""
    import importlib
    calls = dict.fromkeys(WRAPPERS, 0)
    for name, mod_name in WRAPPERS.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


# option -> wrappers that must run, beside reduce and the temporal filter
GATING = {
    "gpyr0": (), "gpyr2": (), "simple": (), "global": (), "log": (), "log_gpyr0": (),
    "contrast_difference": ("expand_contrast",),
    "contrast_difference_perc_norm": ("expand_contrast",),
    "pu_dilate": ("expand_contrast",), "ignore_boundary_pixels": ("expand_contrast",),
    "band_callback": ("expand_contrast",), "content_mapping": ("expand_contrast",),
    "csf_sigma": ("expand_score2",), "k_cm": ("expand_score2",),
}


@pytest.mark.parametrize("option", list(GATING))
def test_route_follows_jax_gating(option, wrapper_calls):
    """gpyr with Weber contrast decomposes through expand_contrast; the
    other adaptations and log contrast through reduce alone; no option but
    the generated LUTs reaches a scoring kernel, and a content mapping builds
    no table and reaches no mov_score."""
    tst, ref, call = _content("video")
    kw = dict(OPTIONS.get(option, {}))
    if option == "band_callback":
        kw["band_callback"] = lambda *a: None
    if option == "content_mapping":
        kw.update(foveated=True, content_mapping=_mapping("port"))
        call["fixation_point"] = np.array([24, 16])
    if option in ("csf_sigma", "k_cm"):
        kw["parameter_overrides"] = {"csf_sigma": -2.0} if option == "csf_sigma" \
            else {"k_cm": 0.5}
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", **kw)
    q, _ = fv.predict(tst, ref, **call)
    assert np.isfinite(q)
    must = ("gausspyr_reduce", "temporal_channels_pair") + GATING[option]
    assert all(wrapper_calls[k] > 0 for k in must), wrapper_calls
    assert all(wrapper_calls[k] == 0 for k in WRAPPERS if k not in must), wrapper_calls
    assert fv._get_core(48, 32).route == ("fused" if option in ("csf_sigma", "k_cm")
                                          else "composed")


# ---------------------------------------------------------------------------
# on the card: each option group against device="cpu"
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_GROUPS = {
    "gpyr2_log": (dict(parameter_overrides={"local_adapt": "gpyr2", "contrast": "log"}),
                  ("gausspyr_reduce", "temporal_pair"),
                  ("expand_contrast", "expand_score2", "mov_score", "band_score2_fov")),
    "simple": (OPTIONS["simple"], ("gausspyr_reduce", "temporal_pair"),
               ("expand_contrast", "expand_score2")),
    "global": (OPTIONS["global"], ("gausspyr_reduce", "temporal_pair"),
               ("expand_contrast", "expand_score2")),
    "gpyr0": (OPTIONS["gpyr0"], ("gausspyr_reduce", "temporal_pair"),
              ("expand_contrast", "expand_score2")),
    "masking_pu_dilate": (dict(parameter_overrides={
        "masking_model": "contrast_difference_perc_norm", "pu_dilate": 0.5}),
        ("gausspyr_reduce", "temporal_pair", "expand_contrast"), ("expand_score2",)),
    "contrast_difference": (OPTIONS["contrast_difference"],
                            ("gausspyr_reduce", "expand_contrast"), ("expand_score2",)),
    "pu_dilate": (OPTIONS["pu_dilate"], ("gausspyr_reduce", "expand_contrast"),
                  ("expand_score2",)),
    "boundary_content_mapping": (dict(ignore_boundary_pixels=True, foveated=True,
                                      content_mapping=True),
                                 ("gausspyr_reduce", "temporal_pair", "expand_contrast"),
                                 ("expand_score2", "mov_score", "band_score2_fov")),
    "band_callback": (dict(band_callback=lambda *a: None),
                      ("gausspyr_reduce", "expand_contrast"), ("expand_score2",)),
    "csf_sigma": (dict(parameter_overrides={"csf_sigma": -2.0}),
                  ("gausspyr_reduce", "temporal_pair", "expand_score2"),
                  ("expand_contrast",)),
    "k_cm": (dict(parameter_overrides={"k_cm": 0.5}),
             ("gausspyr_reduce", "temporal_pair", "expand_score2"), ("expand_contrast",)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("group", list(CARD_GROUPS))
def test_card_option_matches_cpu_and_launches_its_kernels(cuda, group):
    from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
    kw, must, must_not = CARD_GROUPS[group]
    tst, ref = _video(5, (67, 131, 3, 10))
    call = dict(dim_order="HWCF", frames_per_second=30)
    if kw.get("foveated"):
        call["fixation_point"] = np.array([60, 30])
    jods = {}
    for dev in ("cuda", "cpu"):
        opts = dict(kw, device=dev)
        if opts.get("content_mapping") is True:
            opts["content_mapping"] = fvvdp_content_mapping_equirect(131, 67)
        fv = fv_port.fvvdp(display_name="standard_fhd", **opts)
        cuda_ops.reset_launch_counts()
        jods[dev], _ = fv.predict(tst, ref, **call)
        if dev == "cuda":
            counts = cuda_ops.launch_counts()
            assert all(counts[k] > 0 for k in must), counts
            assert all(counts[k] == 0 for k in must_not), counts
            assert not fv._get_core(131, 67)._fov_table_cache or not kw.get("content_mapping")
    bar = 1e-3 if kw.get("foveated") else 1e-4
    assert abs(jods["cuda"] - jods["cpu"]) <= bar, jods
