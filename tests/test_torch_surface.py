"""The JAX package's public surface against the port's, name by name, and
the helpers that closed it, each against the JAX package on the CPU.

Every public module-level function and class of each module of
``fovvideovdp_tpu`` (those defined there, and the names of its ``__all__``)
and every public method, property, static and class method of those
classes must exist under the same name in the module of the same path in
``fovvideovdp_tpu_torch``, or stand in ``EXCLUDED`` with its reason.  The
TPU kernels of ``ops/pallas`` are ported kernel by kernel under other
names (``PERF.md``, the kernel table): each of those modules must have its
counterpart in ``ops/cuda`` (``KERNEL_MODULES``).

The helpers: ``csf.sensitivity``, ``csf.sensitivity_trilinear`` and
``csf.lut_is_uniform``; ``ops.interp.interp3``; ``PyramidPlan.get_band``,
``set_band``, ``get_gband``, ``get_gband_count`` and the module-level
``ops.pyramid.gausspyr_reduce``; ``display_model.lin2pq``;
``ops.temporal.temporal_channels``;
``frames_to_luminance`` of the port's sources.  The counterparts of
tests/test_csf_trilinear.py's three cases hold the port's trilinear CSF
against its cell search, the reference goldens and the JAX package.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import fovvideovdp_tpu
import fovvideovdp_tpu_torch
from fovvideovdp_tpu_torch import csf as p_csf
from fovvideovdp_tpu_torch import display_model as p_dm
from fovvideovdp_tpu_torch.ops import interp as p_interp
from fovvideovdp_tpu_torch.ops import pyramid as p_pyr
from fovvideovdp_tpu_torch.ops import temporal as p_temporal

torch.set_num_threads(2)

# Names the port leaves out, each for a reason the North star of ROADMAP.md
# gives: port what the package does, not the ways it works around the TPU
# and XLA (the jitted programs, the scan and its chunk ladder, the MXU's
# fp32 emulation).  Keys are paths under the package.
JIT = ("a builder of a jitted XLA program; the port has no jit: the core's "
       "methods score directly (score_image, video_step, score_frames)")
SCAN = ("the device-resident scan path and its chunk ladder, which the port "
        "does not have: it streams blocks (score_video)")
EXCLUDED = {
    "core.MetricCore.image_fn": JIT,
    "core.MetricCore.image_block_fn": JIT,
    "core.MetricCore.video_block_fn": JIT,
    "core.MetricCore.video_block_step_fn": JIT,
    "core.MetricCore.video_scan_fn": JIT + "; " + SCAN,
    "parallel.sharding.shard_video_scan_fn": SCAN,
    "parallel.shard_video_scan_fn": SCAN,
    "core.MetricCore.mov_kernel_available": (
        "a gate on the Pallas moving-gaze kernel's Mosaic limits; the port's "
        "kernels take every level (ROADMAP.md queue 3 item 5, no per-level switch)"),
    "video_source.fvvdp_video_source.luminance_is_device_resident": "a gate of " + SCAN,
    "video_source.fvvdp_video_source.device_resident_bytes": "a gate of " + SCAN,
    "video_source.fvvdp_video_source_array.luminance_is_device_resident": "a gate of " + SCAN,
    "video_source.fvvdp_video_source_array.device_resident_bytes": "a gate of " + SCAN,
    "ops.temporal.temporal_channels_pair_chunks": (
        "a block split into chunks that the Pallas kernel can hold in a TPU core's "
        "memory; the port's temporal kernel takes the whole block "
        "(temporal_channels_pair)"),
    "ops.pallas.mxu.dot3": ("fp32 products emulated with three bf16 MXU passes; the "
                            "port keeps fp32 and turns TF32 off"),
}

# ops/pallas module -> its counterpart under ops/cuda (None: excluded above)
KERNEL_MODULES = {"band_pipeline": "band_pipeline", "band_score": "band_score",
                  "expand": "expand_contrast", "mov_score": "mov_score", "reduce": "reduce",
                  "score_math": "score_math", "temporal": "temporal", "mxu": None}


def _modules():
    """Paths under the JAX package of its Python modules, the package first."""
    out = [""]
    for m in pkgutil.walk_packages(fovvideovdp_tpu.__path__, "fovvideovdp_tpu."):
        path = m.name[len("fovvideovdp_tpu."):]
        if path.startswith("native.lib"):
            continue            # the native reader's shared library
        out.append(path)
    return out


MODULES = _modules()
NAMED = [m for m in MODULES if not m.startswith("ops.pallas")]


def _import(pkg, path):
    return importlib.import_module(pkg + ("." + path if path else ""))


def _public(mod):
    """{name: object} of what a module defines or lists in ``__all__``."""
    names = {k for k, v in vars(mod).items() if not k.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and getattr(v, "__module__", None) == mod.__name__}
    names |= set(getattr(mod, "__all__", ()))
    return {k: getattr(mod, k) for k in sorted(names)}


def _methods(cls):
    return sorted(k for k, v in vars(cls).items() if not k.startswith("_") and (
        inspect.isfunction(v) or isinstance(v, (staticmethod, classmethod, property))))


def _key(path, *names):
    return ".".join(([path] if path else []) + list(names))


@pytest.mark.parametrize("path", NAMED, ids=[p or "package" for p in NAMED])
def test_every_public_name_is_ported_or_excluded(path):
    jax_mod = _import("fovvideovdp_tpu", path)
    port_mod = _import("fovvideovdp_tpu_torch", path)
    missing = []
    for name, obj in _public(jax_mod).items():
        key = _key(path, name)
        if key in EXCLUDED:
            assert not hasattr(port_mod, name), f"{key} is ported: drop it from EXCLUDED"
            continue
        if not hasattr(port_mod, name):
            missing.append(key)
            continue
        if inspect.isclass(obj) and obj.__module__ == jax_mod.__name__:
            port_cls = getattr(port_mod, name)
            for meth in _methods(obj):
                mkey = _key(path, name, meth)
                if mkey in EXCLUDED:
                    assert not hasattr(port_cls, meth), f"{mkey} is ported"
                elif not hasattr(port_cls, meth):
                    missing.append(mkey)
    assert not missing, f"not in the port and not excluded: {missing}"


@pytest.mark.parametrize("module", sorted(KERNEL_MODULES))
def test_every_tpu_kernel_module_has_its_cuda_counterpart(module):
    jax_mod = _import("fovvideovdp_tpu", "ops.pallas." + module)
    if KERNEL_MODULES[module] is None:
        assert any(k.startswith(f"ops.pallas.{module}.") for k in EXCLUDED)
        return
    port_mod = _import("fovvideovdp_tpu_torch", "ops.cuda." + KERNEL_MODULES[module])
    assert _public(jax_mod) and _public(port_mod)


def test_the_kernel_modules_are_all_listed():
    listed = {"ops.pallas"} | {"ops.pallas." + m for m in KERNEL_MODULES}
    assert {m for m in MODULES if m.startswith("ops.pallas")} == listed


@pytest.mark.parametrize("key", sorted(EXCLUDED))
def test_each_exclusion_names_a_jax_name_with_its_reason(key):
    obj = fovvideovdp_tpu
    parts = key.split(".")
    for i, part in enumerate(parts):
        sub = ".".join(parts[:i + 1])
        obj = getattr(obj, part) if hasattr(obj, part) else \
            importlib.import_module("fovvideovdp_tpu." + sub)
    assert len(EXCLUDED[key]) > 20


# ----------------------------------------------------------------------
# the helpers against the JAX package
# ----------------------------------------------------------------------
def _luts(omega):
    from fovvideovdp_tpu.csf import CSFCache
    return CSFCache().get(omega, -1.5, 0.604562), \
        p_csf.CSFCache("cpu").get(omega, -1.5, 0.604562)


def _queries(seed=7, shape=(5, 19, 23)):
    rng = np.random.RandomState(seed)
    return (2.0 ** rng.uniform(-3, 6, shape).astype(np.float32),
            10.0 ** rng.uniform(-3, 4, shape).astype(np.float32),
            rng.uniform(0, 120, shape).astype(np.float32))


def test_trilinear_matches_interp3(goldens):
    """tests/test_csf_trilinear.py's first case on the port, and each query
    against the JAX package's."""
    from fovvideovdp_tpu.csf import sensitivity as j_sensitivity
    from fovvideovdp_tpu.csf import sensitivity_trilinear as j_trilinear
    g = goldens("csf_lut")
    for omega in [0, 5]:
        j_lut, lut = _luts(omega)
        rho, L, ecc = (torch.as_tensor(np.asarray(g[k], np.float32)) for k in ("rho", "L", "ecc"))
        S_ref = p_csf.sensitivity(lut, rho, L, ecc).numpy()
        S_new = p_csf.sensitivity_trilinear(lut, rho, L, ecc).numpy()
        np.testing.assert_allclose(S_new, S_ref, rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(S_new, g[f"S_omega{omega}"], rtol=3e-4, atol=1e-5)
        args = [np.asarray(g[k], np.float32) for k in ("rho", "L", "ecc")]
        np.testing.assert_allclose(S_ref, np.asarray(j_sensitivity(j_lut, *args)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(S_new, np.asarray(j_trilinear(j_lut, *args)),
                                   rtol=2e-5, atol=1e-6)


def test_trilinear_scalar_broadcast():
    from fovvideovdp_tpu.csf import sensitivity_trilinear as j_trilinear
    j_lut, lut = _luts(0)
    L = np.random.RandomState(0).rand(7, 33).astype(np.float32) * 100 + 0.5
    S_a = p_csf.sensitivity_trilinear(lut, 2.0, torch.as_tensor(L), 0.0).numpy()
    S_b = p_csf.sensitivity(lut, 2.0, torch.as_tensor(L), 0.0).numpy()
    np.testing.assert_allclose(S_a, S_b, rtol=5e-5)
    assert S_a.shape == (7, 33)
    np.testing.assert_allclose(S_a, np.asarray(j_trilinear(j_lut, 2.0, L, 0.0)), rtol=2e-5)


def test_trilinear_block_matches_per_frame():
    """The moving-gaze block lookup (rho shared by the frames) against the
    per-frame trilinear query, an ecc per frame and one for all frames."""
    from fovvideovdp_tpu.csf import sensitivity_trilinear_block as j_block
    rng = np.random.RandomState(7)
    F, h, w = 5, 19, 23
    rho_map = 2.0 ** rng.uniform(-3, 6, (h, w)).astype(np.float32)
    L = 10.0 ** rng.uniform(-3, 4, (F, h, w)).astype(np.float32)
    ecc = rng.uniform(0, 120, (F, h, w)).astype(np.float32)
    for omega in [0, 5]:
        j_lut, lut = _luts(omega)
        S_blk = p_csf.sensitivity_trilinear_block(lut, torch.as_tensor(rho_map),
                                                  torch.as_tensor(L),
                                                  torch.as_tensor(ecc)).numpy()
        S_ref = np.stack([p_csf.sensitivity_trilinear(lut, torch.as_tensor(rho_map),
                                                      torch.as_tensor(L[f]),
                                                      torch.as_tensor(ecc[f])).numpy()
                          for f in range(F)])
        np.testing.assert_allclose(S_blk, S_ref, rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(S_blk, np.asarray(j_block(j_lut, rho_map, L, ecc)),
                                   rtol=5e-5, atol=1e-6)
    j_lut, lut = _luts(0)
    ecc2 = ecc[0]
    S_blk = p_csf.sensitivity_trilinear_block(lut, torch.as_tensor(rho_map),
                                              torch.as_tensor(L), torch.as_tensor(ecc2))
    S_ref = np.stack([p_csf.sensitivity_trilinear(lut, torch.as_tensor(rho_map),
                                                  torch.as_tensor(L[f]),
                                                  torch.as_tensor(ecc2)).numpy()
                      for f in range(F)])
    np.testing.assert_allclose(S_blk.numpy(), S_ref, rtol=5e-5, atol=1e-6)


def _warped(lut_np):
    """A LUT whose rho axis is not uniform in log2 (a user .mat cache)."""
    out = dict(lut_np)
    out["rho_log"] = np.sort(lut_np["rho_log"] + np.linspace(0, 0.3, lut_np["rho_log"].size)
                             ** 2).astype(np.float32)
    out["rho"] = (2.0 ** out["rho_log"]).astype(np.float32)
    return out


def test_lut_is_uniform_as_jax():
    from fovvideovdp_tpu import csf as j_csf
    j_lut, lut = _luts(0)
    assert p_csf.lut_is_uniform(lut) and j_csf.lut_is_uniform(j_lut)
    warped = _warped({k: np.asarray(j_lut[k]) for k in p_csf.LUT_FIELDS})
    p_lut = p_csf.lut_from_numpy(warped, "cpu")
    # the flags as the JAX package's CSFCache.get sets them
    j_flags = {ax: j_csf._grid_is_uniform(warped[ax]) for ax in ("Y_log", "rho_log", "ecc_sqrt")}
    assert p_lut["_uniform"] == j_flags
    assert not p_csf.lut_is_uniform(p_lut)
    assert p_csf.lut_is_uniform(p_lut) == j_csf.lut_is_uniform(dict(warped, _uniform=j_flags))
    # a LUT without flags counts as uniform in both
    assert p_csf.lut_is_uniform({}) and j_csf.lut_is_uniform({})


def test_sensitivity_on_a_warped_lut_matches_jax():
    """Both general queries on a LUT whose rho grid is not uniform: the cell
    search on every axis, as the JAX package searches."""
    from fovvideovdp_tpu import csf as j_csf
    j_lut, _ = _luts(0)
    warped = _warped({k: np.asarray(j_lut[k]) for k in p_csf.LUT_FIELDS})
    p_lut = p_csf.lut_from_numpy(warped, "cpu")
    j_w = dict({k: np.asarray(v) for k, v in warped.items()},
               _uniform=dict(p_lut["_uniform"]))
    rho, L, ecc = _queries()
    want = np.asarray(j_csf.sensitivity(j_w, rho, L, ecc))
    for fn in (p_csf.sensitivity, p_csf.sensitivity_trilinear):
        got = fn(p_lut, torch.as_tensor(rho), torch.as_tensor(L), torch.as_tensor(ecc)).numpy()
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)


def test_interp3_matches_jax():
    """Non-uniform ascending grids, queries inside, on and outside them,
    v indexed [y, x, z]."""
    from fovvideovdp_tpu.ops.interp import interp3 as j_interp3
    rng = np.random.RandomState(3)
    x, y, z = (np.sort(rng.rand(n)).astype(np.float32) * s for n, s in ((7, 4.0), (5, 2.0),
                                                                        (6, 3.0)))
    v = rng.rand(5, 7, 6).astype(np.float32)
    q = [rng.uniform(-0.5, s + 0.5, (4, 9)).astype(np.float32) for s in (4.0, 2.0, 3.0)]
    q[0][0, :3] = x[:3]                               # queries on knots
    got = p_interp.interp3(*(torch.as_tensor(a) for a in (x, y, z, v, *q))).numpy()
    want = np.asarray(j_interp3(x, y, z, v, *q))
    assert got.shape == (4, 9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pyramid_band_accessors_as_jax():
    from fovvideovdp_tpu.ops.pyramid import PyramidPlan as JPlan
    j_plan, plan = JPlan(64, 48, 60.0), p_pyr.PyramidPlan(64, 48, 60.0)
    img = np.random.RandomState(5).rand(2, 48, 64).astype(np.float32) * 100
    j_bands, j_g = j_plan.decompose(img)
    bands, g = plan.decompose(torch.as_tensor(img))
    assert plan.get_gband_count() == j_plan.get_gband_count() == len(g)
    for b in range(len(bands)):
        np.testing.assert_allclose(plan.get_band(bands, b).numpy(),
                                   np.asarray(j_plan.get_band(j_bands, b)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p_pyr.PyramidPlan.get_gband(g, b).numpy(),
                                   np.asarray(JPlan.get_gband(j_g, b)), rtol=1e-5, atol=1e-5)
    bands, j_bands = list(bands), list(j_bands)
    data = np.full(bands[1].shape, 3.0, np.float32)
    plan.set_band(bands, 1, torch.as_tensor(data))
    j_plan.set_band(j_bands, 1, data)
    np.testing.assert_array_equal(bands[1].numpy(), np.asarray(j_bands[1]))
    np.testing.assert_array_equal(bands[1].numpy(), data / 2.0)


def test_module_level_gausspyr_reduce_as_jax():
    from fovvideovdp_tpu.ops.pyramid import gausspyr_reduce as j_reduce
    x = np.random.RandomState(6).rand(3, 37, 50).astype(np.float32) * 100
    got = p_pyr.gausspyr_reduce(torch.as_tensor(x)).numpy()
    assert got.shape == (3, 19, 25)
    np.testing.assert_allclose(got, np.asarray(j_reduce(x)), rtol=1e-5, atol=1e-5)


def test_lin2pq_as_jax_and_inverts_pq2lin():
    from fovvideovdp_tpu.display_model import lin2pq as j_lin2pq
    L = np.concatenate([[0.0, 0.001, 0.005], 10.0 ** np.linspace(-2, 4, 61),
                        [2e4]]).astype(np.float32)
    got = p_dm.lin2pq(torch.as_tensor(L))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_lin2pq(L)), rtol=1e-5, atol=1e-7)
    inside = (L >= 0.005) & (L <= 1e4)
    back = p_dm.pq2lin(got).numpy()
    np.testing.assert_allclose(back[inside], L[inside], rtol=2e-3)


def _taps():
    fl = p_temporal.filter_len_for_fps(30.0)
    return p_temporal.temporal_filters(30.0, fl), fl


def test_temporal_channels_as_jax():
    from fovvideovdp_tpu.ops.temporal import temporal_channels as j_channels
    filt, fl = _taps()
    rng = np.random.RandomState(8)
    pt = rng.rand(fl - 1 + 6, 12, 20).astype(np.float32) * 100
    pr = pt * 1.02 + 0.3
    got = p_temporal.temporal_channels(torch.as_tensor(pt), torch.as_tensor(pr), filt)
    assert got.shape == (6, 4, 12, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_channels(pt, pr, filt)),
                               rtol=1e-5, atol=1e-4)


FRAMES = {
    "uint8_srgb": ("standard_4k", lambda r: r.randint(0, 256, (3, 3, 20, 30)).astype(np.uint8)),
    "uint16_pq": ("standard_hdr_pq",
                  lambda r: r.randint(0, 65536, (2, 3, 20, 30)).astype(np.uint16)),
    "float_gray": ("standard_4k", lambda r: r.rand(4, 1, 20, 30).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_frames_to_luminance_as_jax(case):
    """The display model's conversion of (n, C, H, W) frames on the port's
    array source (every source class inherits it) against the JAX source's."""
    import fovvideovdp_tpu.video_source as j_vs
    import fovvideovdp_tpu_torch.video_source as p_vs
    display, make = FRAMES[case]
    frames = make(np.random.RandomState(9))
    clip = np.ascontiguousarray(frames.transpose(2, 3, 1, 0))       # HWCF
    photometry = fovvideovdp_tpu_torch.fvvdp(display_name=display,
                                             device="cpu").display_photometry
    j_photometry = fovvideovdp_tpu.fvvdp(display_name=display).display_photometry
    j_src = j_vs.fvvdp_video_source_array(clip, clip, 30, dim_order="HWCF",
                                          display_photometry=j_photometry)
    p_src = p_vs.fvvdp_video_source_array(clip, clip, 30, dim_order="HWCF",
                                          display_photometry=photometry, device="cpu")
    want = np.asarray(j_src.frames_to_luminance(frames))
    got = p_src.frames_to_luminance(frames)
    assert got.shape == (frames.shape[0], 20, 30) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    for cls in (p_vs.fvvdp_video_source_packed_array,
                importlib.import_module("fovvideovdp_tpu_torch.video_source_yuv")
                .fvvdp_video_source_yuv_file,
                importlib.import_module("fovvideovdp_tpu_torch.video_source_file")
                .fvvdp_video_source_video_file):
        assert cls.frames_to_luminance is p_vs.fvvdp_video_source_dm.frames_to_luminance
