"""The CSF cache of fovvideovdp_tpu_torch on the CPU: its search order
(packaged .npz, then user .mat caches, then the analytic generator, as
``fovvideovdp_tpu/csf.py:40-96``), the port's copy of the generator against
the shipped LUTs and the JAX package's generator, the SCCSF self-checks of
tests/test_sccsf.py, and scores from generated and .mat LUTs against the
JAX package's on the same input.

Bars: the generator as tests/test_csf.py:24-36 holds it (grids rtol 1e-6,
S_log within 2e-3 of the shipped files) and equal to JAX's; scores at
|dJOD| <= 1e-4 and Q_per_ch rtol 2e-3 / atol 2e-4.
"""
import os

import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu import csf_generator as jax_generator
from fovvideovdp_tpu_torch import csf, csf_generator, state, utils

torch.set_num_threads(2)

JOD_BAR = 1e-4
Q_BAR = dict(rtol=2e-3, atol=2e-4)
SHIPPED = (-1.5, 0.604562)


def _video(seed=3, shape=(32, 48, 3, 5)):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref / 255.0 + rng.randn(*ref.shape) * 0.05, 0, 1)
    return (tst * 255).astype(np.uint8), ref


def _scores_match(got, want):
    (q_p, s_p), (q_j, s_j) = got, want
    assert np.isfinite(q_p) and abs(q_p - q_j) <= JOD_BAR, (q_p, q_j)
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]), **Q_BAR)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_cache_key_format():
    assert csf.cache_key(0, -1.5, 0.604562) == "o0_sn1_5_cm0_604562"
    assert csf.cache_key(5, -2.0, 0.5) == "o5_sn2_cm0_500000"


@pytest.mark.parametrize("omega", [0, 5])
def test_generator_reproduces_shipped_luts(omega):
    lut = csf_generator.precompute_lut(omega, *SHIPPED)
    with np.load(os.path.join(utils._DATA_DIR,
                              f"csf_lut_o{omega}_sn1_5_cm0_604562.npz")) as ref:
        for ax in ("Y", "rho", "ecc"):
            np.testing.assert_allclose(lut[ax], ref[ax], rtol=1e-6)
        assert np.abs(lut["S_log"] - ref["S_log"]).max() < 2e-3


@pytest.mark.parametrize("args", [(10.0, -1.5, 0.604562, 8), (0.0, -2.0, 0.604562, 32),
                                  (5.0, -1.5, 0.5, 32)])
def test_generator_equals_jax(args):
    got = csf_generator.precompute_lut(*args[:3], n=args[3])
    want = jax_generator.precompute_lut(*args[:3], n=args[3])
    assert set(got) == set(want) == set(csf.LUT_FIELDS)
    for k in csf.LUT_FIELDS:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # uniform in every transformed axis: the kernels take a generated LUT
    flags = csf.lut_from_numpy(got, "cpu")["_uniform"]
    assert all(flags.values()), flags


def _binary_search(fn, target, lo, hi, iters=40):
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if fn(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@pytest.mark.parametrize("Y_mean", [0.1, 1.0, 10.0, 100.0])
def test_sccsf_threshold_matches_binary_search(Y_mean):
    """tests/test_sccsf.py:26-50 on the port's copy."""
    g = csf_generator
    rng = np.random.RandomState(int(Y_mean * 10))
    freq, area = 2.0, 0.5 ** 2 * np.pi
    LMS_mean = g.xyz2lms2006(g.WHITEPOINT_D65 * Y_mean)
    LMS_delta = (rng.rand(3) * 2 - 1) * 0.01 * Y_mean
    _, LMS_delta_thr, _, _ = g.sccsf_sensitivity(freq, LMS_mean[None, :],
                                                 LMS_delta[None, :], area)
    thr_s = LMS_delta_thr[0] / LMS_delta
    assert np.abs(thr_s[0] - thr_s[1]) < 1e-4 and np.abs(thr_s[1] - thr_s[2]) < 1e-4

    def C_of(scale):
        return float(g.sccsf_pdet(freq, LMS_mean[None, :], (LMS_delta * scale)[None, :],
                                  area)[1][0])

    assert abs(thr_s[0] - _binary_search(C_of, 1.0, 1e-3, 100.0)) < 1e-4


def test_sccsf_pdet_half_at_threshold():
    g = csf_generator
    LMS_mean = g.xyz2lms2006(g.WHITEPOINT_D65 * 10.0)
    _, LMS_delta_thr, _, _ = g.sccsf_sensitivity(
        4.0, LMS_mean[None, :], np.array([[0.01, 0.004, 0.0002]]), 1.0)
    P, C = g.sccsf_pdet(4.0, LMS_mean[None, :], LMS_delta_thr, 1.0)
    np.testing.assert_allclose(C[0], 1.0, rtol=1e-10)
    np.testing.assert_allclose(P[0], 0.5, rtol=1e-10)


def test_sccsf_mechanism_shapes_match_jax():
    """Achromatic band-pass, chromatic low-pass (tests/test_sccsf.py:63-80),
    and the same values as the JAX package's."""
    LMS_mean = csf_generator.xyz2lms2006(csf_generator.WHITEPOINT_D65 * 100.0)[None, :]
    freqs = [1.0, 4.0, 16.0, 32.0]
    S = {c: [float(csf_generator.sccsf_sensitivity_coldir(f, LMS_mean, c, np.pi)[0])
             for f in freqs] for c in (1, 2, 3)}
    for c in (1, 2, 3):
        assert all(np.isfinite(v) and v > 0 for v in S[c])
        assert S[c] == [float(jax_generator.sccsf_sensitivity_coldir(f, LMS_mean, c, np.pi)[0])
                        for f in freqs]
    assert S[1][1] > S[1][0] and S[1][1] > S[1][3]
    assert S[2] == sorted(S[2], reverse=True) and S[3] == sorted(S[3], reverse=True)


# ---------------------------------------------------------------------------
# the search order
# ---------------------------------------------------------------------------

def _warp(grid):
    """Monotone non-uniform warp of a uniform grid with the same ends
    (tests/test_round2_fixes.py:104-109)."""
    g = np.asarray(grid, dtype=np.float64)
    u = (g - g[0]) / (g[-1] - g[0])
    return (g[0] + (g[-1] - g[0]) * u ** 1.35).astype(np.float32)


def _nonuniform_lut(omega, n=12):
    """A LUT in the cache format on warped grids, its S from the analytic
    model, so that the metric sees realistic sensitivities."""
    Y_log = _warp(np.linspace(np.log2(1e-3), np.log2(1e4), n))
    rho_log = _warp(np.linspace(-4.0, 6.0, n))
    ecc_sqrt = _warp(np.linspace(0.0, np.sqrt(120.0), n))
    Y, rho, ecc = 2.0 ** Y_log, 2.0 ** rho_log, ecc_sqrt ** 2
    Yg, rg, eg = np.meshgrid(Y, rho, ecc, indexing="ij")
    S = np.maximum(csf_generator.sensitivity(rg, omega, Yg, eg, *SHIPPED), 1e-4)
    return dict(Y=Y.astype(np.float32), rho=rho.astype(np.float32),
                ecc=ecc.astype(np.float32), Y_log=Y_log, rho_log=rho_log,
                ecc_sqrt=ecc_sqrt, S_log=np.log2(S).reshape(n, n, n).astype(np.float32))


def _write_mat(path, lut):
    import scipy.io as sio
    sio.savemat(path, {"lut": {k: np.asarray(v, np.float64) for k, v in lut.items()}})


SIGMA = -1.7     # a key with no packaged .npz


@pytest.fixture
def mat_cache(tmp_path, monkeypatch):
    """csf_cache/ under the working directory, holding both temporal
    channels' LUTs of key sigma = -1.7 on non-uniform grids."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("csf_cache")
    luts = {}
    for omega in (0, 5):
        luts[omega] = _nonuniform_lut(omega)
        _write_mat(os.path.join("csf_cache", csf.cache_key(omega, SIGMA, SHIPPED[1])
                                + "_gpu0.mat"), luts[omega])
    return luts


def test_npz_wins_over_a_mat_cache(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("csf_cache")
    key = csf.cache_key(0, *SHIPPED)
    _write_mat(os.path.join("csf_cache", key + "_gpu0.mat"), _nonuniform_lut(0))
    lut = csf.CSFCache("cpu").get(0, *SHIPPED)
    with np.load(os.path.join(utils._DATA_DIR, f"csf_lut_{key}.npz")) as z:
        np.testing.assert_array_equal(lut["S_log"].numpy(), z["S_log"])
    assert all(lut["_uniform"].values())


def test_mat_cache_is_loaded_with_its_grids(mat_cache):
    lut = csf.CSFCache("cpu").get(0, SIGMA, SHIPPED[1])
    want = fv_jax.csf.CSFCache().get(0, SIGMA, SHIPPED[1])
    for k in csf.LUT_FIELDS:
        assert tuple(lut[k].shape) == np.asarray(want[k]).shape
        np.testing.assert_array_equal(lut[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert lut["_uniform"] == want["_uniform"] == dict(Y_log=False, rho_log=False,
                                                       ecc_sqrt=False)


@pytest.mark.parametrize("suffix", ["_gpu0.mat", ".mat"])
def test_mat_suffixes_in_order_under_extra_dirs(tmp_path, suffix):
    key = csf.cache_key(5, SIGMA, SHIPPED[1])
    _write_mat(str(tmp_path / (key + suffix)), _nonuniform_lut(5))
    if suffix == ".mat":       # a _gpu0 file would win; here there is none
        assert not (tmp_path / (key + "_gpu0.mat")).exists()
    else:                      # ... and here it wins over a plain .mat
        _write_mat(str(tmp_path / (key + ".mat")), _nonuniform_lut(0))
    lut = csf.CSFCache("cpu", extra_dirs=["no_such_dir", str(tmp_path)]).get(
        5, SIGMA, SHIPPED[1])
    np.testing.assert_array_equal(lut["S_log"].numpy(), _nonuniform_lut(5)["S_log"])


def test_missing_key_is_generated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cache = csf.CSFCache("cpu")
    lut = cache.get(0, -2.0, SHIPPED[1])
    np.testing.assert_array_equal(lut["S_log"].numpy(),
                                  csf_generator.precompute_lut(0, -2.0, SHIPPED[1])["S_log"])
    assert cache.get(0, -2.0, SHIPPED[1]) is lut


@pytest.mark.parametrize("foveated", [None, "fixed", "moving"])
def test_mat_cache_on_a_non_uniform_grid_scores_as_jax(mat_cache, foveated):
    """Both packages read the same files; the port takes the composed route
    with the monotone cell search on every axis."""
    tst, ref = _video()
    call = dict(dim_order="HWCF", frames_per_second=30)
    kw = dict(display_name="standard_fhd", parameter_overrides={"csf_sigma": SIGMA})
    if foveated:
        kw["foveated"] = True
        call["fixation_point"] = np.array([20.0, 12.0]) if foveated == "fixed" else \
            np.stack([np.linspace(3, 44, 5), np.linspace(28, 2, 5)], axis=1).astype(np.float32)
    pm = fv_port.fvvdp(device="cpu", **kw)
    _scores_match(pm.predict(tst, ref, **call), fv_jax.fvvdp(**kw).predict(tst, ref, **call))
    core = pm._get_core(48, 32)
    assert core.route == "composed" and core._fov_trim is None


@pytest.mark.parametrize("kind", ["video", "image"])
@pytest.mark.parametrize("override", [{"csf_sigma": -2.0}, {"k_cm": 0.5},
                                      {"csf_sigma": -1.0, "k_cm": 0.8}],
                         ids=["csf_sigma", "k_cm", "both"])
def test_generated_luts_score_as_jax(tmp_path, monkeypatch, override, kind):
    monkeypatch.chdir(tmp_path)         # no csf_cache/ here: both generate
    tst, ref = _video()
    call = dict(dim_order="HWCF", frames_per_second=30)
    if kind == "image":
        tst, ref, call = tst[..., 0], ref[..., 0], dict(dim_order="HWC")
    kw = dict(display_name="standard_fhd", parameter_overrides=override)
    pm = fv_port.fvvdp(device="cpu", **kw)
    _scores_match(pm.predict(tst, ref, **call), fv_jax.fvvdp(**kw).predict(tst, ref, **call))
    assert pm._get_core(48, 32).route == "fused"


def test_state_from_jax_carries_a_non_uniform_lut(mat_cache):
    """state_from_numpy takes the JAX metric's .mat LUTs and ablation
    parameters: the port scores from them as JAX does."""
    tst, ref = _video()
    call = dict(dim_order="HWCF", frames_per_second=30)
    jm = fv_jax.fvvdp(display_name="standard_fhd",
                      parameter_overrides={"csf_sigma": SIGMA, "local_adapt": "gpyr2"})
    pm = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    params, luts = state.state_from_numpy(
        jm.parameters, [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jm._luts], "cpu")
    pm.load_state(params, luts)
    assert pm.local_adapt == "gpyr2" and not pm._luts[0]["_uniform"]["Y_log"]
    _scores_match(pm.predict(tst, ref, **call), jm.predict(tst, ref, **call))
