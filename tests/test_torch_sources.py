"""fovvideovdp_tpu_torch's sources on the CPU: a source written against the
reference's per-frame API, the array source's host-resident path, float16
clips and the refusal of a short per-frame trajectory, against the JAX
package where it has the same function.

Bars: the repo's own (tests/test_metric_e2e.py:13-17), |dJOD| <= 0.01 and
Q_per_ch rtol 2e-3 / atol 2e-4, against JAX; bit for bit where both sides
run the port on the same luminance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu.video_source import fvvdp_video_source as jax_source
from fovvideovdp_tpu_torch import csf, memory, state
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array

torch.set_num_threads(2)

GOLDEN_BAR = dict(rtol=2e-3, atol=2e-4)
H, W, N_FRAMES, FPS = 36, 64, 7, 30.0


def _luminance_clip(seed=7, shape=(H, W, N_FRAMES)):
    """A (H, W, F) absolute-luminance pair in cd/m^2 from a numpy seed."""
    rng = np.random.default_rng(seed)
    ref = (0.5 + 150.0 * rng.random(shape)).astype(np.float32)
    test = (ref * (1.0 + 0.08 * rng.standard_normal(shape))).clip(0.05, None)
    return test.astype(np.float32), ref


def _encoded_clip(seed=3, shape=(H, W, 3, N_FRAMES)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, size=shape, dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.integers(-11, 11, size=shape),
                   0, 255).astype(np.uint8)
    return test, ref


class PortFrames(fv_port.fvvdp_video_source):
    """Implements only the reference's per-frame API."""

    def __init__(self, test, ref, fps=FPS):
        self.test, self.ref, self.fps = test, ref, fps

    def get_video_size(self):
        return self.test.shape[0], self.test.shape[1], self.test.shape[2]

    def get_frames_per_second(self):
        return self.fps

    def get_test_frame(self, frame, device=None):
        return torch.from_numpy(self.test[..., frame])[None, None, None]

    def get_reference_frame(self, frame, device=None):
        return torch.from_numpy(self.ref[..., frame])[None, None, None]


class JaxFrames(jax_source):
    """The same source against the JAX package's base class."""

    def __init__(self, test, ref, fps=FPS):
        self.test, self.ref, self.fps = test, ref, fps

    def get_video_size(self):
        return self.test.shape[0], self.test.shape[1], self.test.shape[2]

    def get_frames_per_second(self):
        return self.fps

    def get_test_frame(self, frame, device=None):
        return jnp.asarray(self.test[..., frame])[None, None, None]

    def get_reference_frame(self, frame, device=None):
        return jnp.asarray(self.ref[..., frame])[None, None, None]


def _metrics(**kw):
    """A JAX metric and a port metric on the CPU with the JAX state carried
    across."""
    jm = fv_jax.fvvdp(display_name="standard_fhd", **kw)
    pm = fv_port.fvvdp(display_name="standard_fhd", device="cpu", **kw)
    params, luts = state.state_from_numpy(
        jm.parameters, [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jm._luts],
        "cpu")
    pm.load_state(params, luts)
    return jm, pm


# ---------------------------------------------------------------------------
# (a) a source with only the per-frame methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["replicate", "circular"])
def test_per_frame_source_matches_jax(padding):
    test, ref = _luminance_clip()
    jm, pm = _metrics(temp_padding=padding)
    Q_j, s_j = jm.predict_video_source(JaxFrames(test, ref))
    Q_p, s_p = pm.predict_video_source(PortFrames(test, ref))
    assert abs(Q_p - Q_j) <= 0.01
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **GOLDEN_BAR)
    assert s_p["Q_per_ch"].shape == (pm._get_core(W, H).plan.height, 2, N_FRAMES)


def test_per_frame_image_source_matches_jax():
    test, ref = _luminance_clip(shape=(H, W, 1))
    jm, pm = _metrics()
    Q_j, s_j = jm.predict_video_source(JaxFrames(test, ref, fps=0))
    Q_p, s_p = pm.predict_video_source(PortFrames(test, ref, fps=0))
    assert abs(Q_p - Q_j) <= 0.01
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **GOLDEN_BAR)
    assert np.all(s_p["Q_per_ch"][:, 1] == 0.0)


@pytest.mark.parametrize("block_frames", [None, 3])
def test_per_frame_source_scores_like_the_array_source(block_frames):
    """The array source's per-frame methods give what its block methods
    give, so the base class's blocks built from them score the same, bit for
    bit, in any block size."""
    test, ref = _encoded_clip()
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", block_frames=block_frames)
    vs = fvvdp_video_source_array(test, ref, FPS, dim_order="HWCF",
                                  display_photometry=fv.display_photometry, device="cpu")

    class Wrapped(fv_port.fvvdp_video_source):
        get_video_size = vs.get_video_size
        get_frames_per_second = vs.get_frames_per_second
        get_test_frame = vs.get_test_frame
        get_reference_frame = vs.get_reference_frame

    _, s_blocks = fv.predict_video_source(vs)
    _, s_frames = fv.predict_video_source(Wrapped())
    np.testing.assert_array_equal(s_frames["Q_per_ch"], s_blocks["Q_per_ch"])


def test_base_class_blocks_concatenate_the_frames():
    test, ref = _luminance_clip()
    src = PortFrames(test, ref)
    t, r = src.get_luminance_block(2, 3)
    assert t.shape == r.shape == (3, H, W) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.moveaxis(test[..., 2:5], -1, 0))
    t, r = src.get_indexed_luminance_block(np.array([4, 0, 0]))
    np.testing.assert_array_equal(r.numpy(), np.moveaxis(ref[..., [4, 0, 0]], -1, 0))
    t, r = src.get_indexed_luminance_block(np.array([], dtype=np.int64))
    assert t.shape == r.shape == (0, H, W)
    assert src.supports_random_access()


def test_per_frame_methods_are_abstract():
    class BlocksOnly(fv_port.fvvdp_video_source):
        def get_video_size(self):
            return H, W, 1

        def get_frames_per_second(self):
            return 0

    with pytest.raises(TypeError):
        BlocksOnly()


def test_per_frame_source_in_float64_is_scored_in_float32():
    test, ref = _luminance_clip()
    pm = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    Q32, s32 = pm.predict_video_source(PortFrames(test, ref))
    Q64, s64 = pm.predict_video_source(PortFrames(test.astype(np.float64),
                                                  ref.astype(np.float64)))
    assert s64["Q_per_ch"].dtype == np.float32
    np.testing.assert_array_equal(s64["Q_per_ch"], s32["Q_per_ch"])


# ---------------------------------------------------------------------------
# (b) the host-resident path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim_order", ["HWCF", "BCFHW", "FHW"])
def test_host_resident_path_matches_resident_bit_for_bit(monkeypatch, dim_order):
    test, ref = _encoded_clip()
    if dim_order == "BCFHW":
        test, ref = (np.ascontiguousarray(x.transpose(2, 3, 0, 1))[None] for x in (test, ref))
    elif dim_order == "FHW":
        test, ref = (np.ascontiguousarray(x[:, :, 1].transpose(2, 0, 1)) for x in (test, ref))
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", block_frames=3)
    call = dict(dim_order=dim_order, frames_per_second=FPS)
    _, s_res = fv.predict(test, ref, **call)
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    vs = fvvdp_video_source_array(test, ref, FPS, dim_order=dim_order,
                                  display_photometry=fv.display_photometry, device="cpu")
    assert not vs.resident and vs._t.is_contiguous() and vs._t.dim() == 4
    _, s_host = fv.predict(test, ref, **call)
    np.testing.assert_array_equal(s_host["Q_per_ch"], s_res["Q_per_ch"])


@pytest.mark.parametrize("padding", ["circular", "pingpong"])
def test_host_resident_path_serves_reordered_blocks(monkeypatch, padding):
    test, ref = _encoded_clip()
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", temp_padding=padding,
                       block_frames=4)
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    _, s_res = fv.predict(test, ref, **call)
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    _, s_host = fv.predict(test, ref, **call)
    np.testing.assert_array_equal(s_host["Q_per_ch"], s_res["Q_per_ch"])


def test_residency_limit_defaults_to_the_card(monkeypatch):
    """No limit on the CPU; on a card a share of its free memory; a limit set
    on the class decides."""
    test, ref = _encoded_clip()
    assert fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES is None
    vs = fvvdp_video_source_array(test, ref, FPS, dim_order="HWCF", device="cpu")
    assert vs.resident and memory.preload_limit(vs.device) == float("inf")
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES",
                        2 * test.nbytes)
    assert fvvdp_video_source_array(test, ref, FPS, dim_order="HWCF", device="cpu").resident
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES",
                        2 * test.nbytes - 1)
    assert not fvvdp_video_source_array(test, ref, FPS, dim_order="HWCF",
                                        device="cpu").resident


@pytest.mark.parametrize("resident", [True, False])
def test_array_source_per_frame_methods(monkeypatch, resident):
    test, ref = _encoded_clip()
    if not resident:
        monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    vs = fvvdp_video_source_array(test, ref, FPS, dim_order="HWCF", device="cpu")
    assert vs.resident == resident
    t_blk, r_blk = vs.get_luminance_block(0, N_FRAMES)
    for i in (0, 4, N_FRAMES - 1):
        t, r = vs.get_test_frame(i), vs.get_reference_frame(i)
        assert t.shape == r.shape == (1, 1, 1, H, W) and t.dtype == torch.float32
        assert torch.equal(t[0, 0, 0], t_blk[i]) and torch.equal(r[0, 0, 0], r_blk[i])


# ---------------------------------------------------------------------------
# (c) float16 and other stored types
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [None, 0], ids=["resident", "host"])
def test_float16_clip_scores_like_float32_of_the_same_values(monkeypatch, limit):
    test, ref = _encoded_clip()
    t16, r16 = ((x / 255.0).astype(np.float16) for x in (test, ref))
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    _, s32 = fv.predict(t16.astype(np.float32), r16.astype(np.float32), **call)
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", limit)
    vs = fvvdp_video_source_array(t16, r16, FPS, dim_order="HWCF", device="cpu")
    assert vs._t.dtype == torch.float16          # stored as it came, not widened
    _, s16 = fv.predict(t16, r16, **call)
    np.testing.assert_array_equal(s16["Q_per_ch"], s32["Q_per_ch"])


def test_float16_clip_matches_jax():
    test, ref = _encoded_clip()
    t16, r16 = ((x / 255.0).astype(np.float16) for x in (test, ref))
    jm, pm = _metrics()
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    Q_j, s_j = jm.predict(t16, r16, **call)
    Q_p, s_p = pm.predict(t16, r16, **call)
    assert abs(Q_p - Q_j) <= 0.01
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **GOLDEN_BAR)


@pytest.mark.parametrize("dtype,stored", [(np.uint8, torch.uint8), (np.uint16, torch.int16),
                                          (np.float32, torch.float32),
                                          (np.float64, torch.float32)])
def test_stored_types(dtype, stored):
    test, ref = _encoded_clip()
    scale = 257 if dtype == np.uint16 else (1 / 255.0 if dtype in (np.float32, np.float64)
                                            else 1)
    t, r = ((x.astype(np.float64) * scale).astype(dtype) for x in (test, ref))
    vs = fvvdp_video_source_array(t, r, FPS, dim_order="HWCF", device="cpu")
    assert vs._t.dtype == stored and vs._t.shape == (3, N_FRAMES, H, W)
    lum, _ = vs.get_luminance_block(0, 2)
    assert lum.dtype == torch.float32 and torch.isfinite(lum).all()


# ---------------------------------------------------------------------------
# (d) a per-frame trajectory shorter than the video
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foveated", [False, True])
def test_short_trajectory_is_refused_whatever_foveated_is(foveated):
    test, ref = _encoded_clip()
    short = np.tile([[W / 2.0, H / 2.0]], (N_FRAMES - 1, 1)).astype(np.float32)
    call = dict(dim_order="HWCF", frames_per_second=FPS, fixation_point=short)
    with pytest.raises(RuntimeError, match="per-frame rows"):
        fv_jax.fvvdp(display_name="standard_fhd", foveated=foveated).predict(
            test, ref, **call)
    with pytest.raises(RuntimeError, match="per-frame rows"):
        fv_port.fvvdp(display_name="standard_fhd", device="cpu", foveated=foveated).predict(
            test, ref, **call)


def test_full_trajectory_is_ignored_when_not_foveated():
    test, ref = _encoded_clip()
    gaze = np.tile([[3.0, 5.0]], (N_FRAMES, 1)).astype(np.float32)
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    Q, _ = fv.predict(test, ref, **call)
    Q_g, _ = fv.predict(test, ref, fixation_point=gaze, **call)
    assert Q_g == Q
