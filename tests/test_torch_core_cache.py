"""The port's cache of metric cores, keyed as the JAX package keys it
(``fovvideovdp_tpu/fvvdp.py:198-199``): width, height, foveated, heatmap,
heatmap dtype and ignored boundary pixels.  A metric whose attributes change
between calls scores as a metric built fresh for each step does, in both
packages; a replaced core's fixed-gaze tables are dropped; and the block
size of the streaming loop counts the block a host-resident source
prefetches.

Bars: each step within |dJOD| <= 0.01 of the JAX package (the repo's bar,
tests/test_metric_e2e.py:13) and 1e-6 of a fresh port metric, the heatmap's
dtype equal.
"""
import numpy as np
import pytest
import torch

from fovvideovdp_tpu_torch import core as core_mod
from fovvideovdp_tpu_torch import fvvdp, memory
from fovvideovdp_tpu_torch.core import MetricCore
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array

torch.set_num_threads(2)

JOD_TOL = 0.01
# each step sets one attribute on the metric of the step before it
STEPS = [("first call", {}), ("uint8 heatmap", {"heatmap_dtype": "uint8"}),
         ("boundary pixels", {"ignore_boundary_pixels": True}), ("foveated", {"foveated": True})]


def _image():
    rng = np.random.RandomState(5)
    ref = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-25, 25, ref.shape), 0, 255).astype(np.uint8)
    return tst, ref


def _run_sequence(make, tst, ref):
    """(JOD, heatmap dtype) of each step, one metric throughout."""
    fv = make()
    out = []
    for _, attrs in STEPS:
        for k, v in attrs.items():
            setattr(fv, k, v)
        q, s = fv.predict(tst, ref, dim_order="HWC")
        out.append((q, np.dtype(s["heatmap"].dtype)))
    return fv, out


def _fresh(make, tst, ref, upto):
    kw = {}
    for _, attrs in STEPS[:upto + 1]:
        kw.update(attrs)
    q, s = make(**kw).predict(tst, ref, dim_order="HWC")
    return q, np.dtype(s["heatmap"].dtype)


def test_attribute_sequence_matches_jax_and_fresh_metrics():
    import fovvideovdp_tpu as fv_jax
    tst, ref = _image()

    def port(**kw):
        return fvvdp(display_name="standard_fhd", heatmap="threshold", device="cpu", **kw)

    def jax(**kw):
        return fv_jax.fvvdp(display_name="standard_fhd", heatmap="threshold", **kw)
    fv, seq_port = _run_sequence(port, tst, ref)
    _, seq_jax = _run_sequence(jax, tst, ref)
    assert [d for _, d in seq_port] == [np.float16, np.uint8, np.uint8, np.uint8]
    for k, ((q_p, d_p), (q_j, d_j)) in enumerate(zip(seq_port, seq_jax)):
        assert d_p == d_j, STEPS[k][0]
        assert abs(q_p - q_j) <= JOD_TOL, (STEPS[k][0], q_p, q_j)
        q_f, d_f = _fresh(port, tst, ref, k)
        assert abs(q_p - q_f) <= 1e-6 and d_p == d_f, (STEPS[k][0], q_p, q_f)
    # the sequence as ROADMAP describes it: boundary pixels raise the JOD,
    # foveation raises it again
    assert seq_port[2][0] > seq_port[1][0] and seq_port[3][0] > seq_port[2][0]
    assert len(fv._cores) == 4


def test_the_key_holds_jaxs_fields():
    fv = fvvdp(display_name="standard_fhd", heatmap="raw", device="cpu")
    fv._get_core(96, 64)
    fv._get_core(96, 64, with_heatmap=False)
    fv.foveated = True
    fv._get_core(96, 64)
    assert set(fv._cores) == {(96, 64, False, "raw", "float16", False),
                              (96, 64, False, None, "float16", False),
                              (96, 64, True, "raw", "float16", False)}


def test_a_replaced_core_drops_its_tables():
    """A new core of the same resolution frees the fixed-gaze tables of the
    others; a core of another resolution keeps its own."""
    fv = fvvdp(display_name="standard_fhd", foveated=True, device="cpu")
    core = fv._get_core(96, 64)
    core.fov_tables((40.0, 30.0))
    other = fv._get_core(80, 48)
    other.fov_tables((20.0, 20.0))
    assert core._fov_table_cache and other._fov_table_cache
    fv.heatmap, fv.do_heatmap = "threshold", True
    new = fv._get_core(96, 64)
    assert new is not core and not core._fov_table_cache
    assert other._fov_table_cache
    # asking for a core already built drops nothing
    new.fov_tables((40.0, 30.0))
    assert fv._get_core(96, 64) is new and new._fov_table_cache


def test_trimmed_tables_own_only_their_knots():
    """The fixed-gaze tables keep the Y knots the display reaches and free
    the rest: their storage is their size, which ``fov_table_bytes``
    reports."""
    fv = fvvdp(display_name="standard_fhd", foveated=True, device="cpu")
    core = fv._get_core(96, 64)
    assert core._fov_trim is not None
    tabs = core.fov_tables((40.0, 30.0))
    n = core._fov_trim[1] - core._fov_trim[0] + 1
    assert all(t.shape[0] == n and t.untyped_storage().nbytes() == t.numel() * 4
               for per_cc in tabs for t in per_cc)
    assert sum(t.numel() * 4 for per_cc in tabs for t in per_cc) == core.fov_table_bytes()


def test_predict_traced_takes_the_same_key():
    fv = fvvdp(display_name="standard_fhd", device="cpu")
    tst, ref = _image()
    x_t, x_r = (torch.as_tensor(x.astype(np.float32) / 255) for x in (tst, ref))
    q0 = float(fv.predict_traced(x_t, x_r, dim_order="HWC"))
    fv.ignore_boundary_pixels = True
    q1 = float(fv.predict_traced(x_t, x_r, dim_order="HWC"))
    q_fresh = float(fvvdp(display_name="standard_fhd", ignore_boundary_pixels=True,
                          device="cpu").predict_traced(x_t, x_r, dim_order="HWC"))
    assert q1 != q0 and abs(q1 - q_fresh) <= 1e-6


class _StagedSource(fvvdp_video_source_array):
    """An array source that says it stages its frames from the host."""
    STAGED = 0

    def host_block_bytes(self, count):
        return self.STAGED * count


@pytest.mark.parametrize("staged_per_px", [0, 6, 64])
def test_the_streaming_block_counts_the_prefetched_block(monkeypatch, staged_per_px):
    """The block size of the streaming loop charges the raw frames a
    host-resident source prefetches onto the card, beside the route's
    bytes per pixel-frame, as the ablation's chunks do."""
    h, w, n = 32, 48, 40
    per_px = core_mod._BLOCK_BYTES_PER_PX_FRAME["fused"] + staged_per_px
    free = 2 * 20 * per_px * h * w          # half of it holds 20 frames
    fv = fvvdp(display_name="standard_fhd", device="cpu")
    monkeypatch.setattr(memory, "usable_bytes", lambda device: free)
    picked = []
    real = MetricCore.score_video

    def spy(self, block, indexed, n_frames, taps, pad_idx, B, *a, **kw):
        picked.append(B)
        return real(self, block, indexed, n_frames, taps, pad_idx, B, *a, **kw)
    monkeypatch.setattr(MetricCore, "score_video", spy)
    rng = np.random.RandomState(0)
    ref = (rng.rand(n, h, w) * 255).astype(np.uint8)
    vs = _StagedSource(ref, ref, 30, dim_order="FHW", display_photometry=fv.display_photometry,
                       device="cpu")
    vs.STAGED = staged_per_px * h * w
    fv.predict_video_source(vs)
    assert picked == [20]
    # the route's bytes alone would hold more frames
    if staged_per_px:
        assert memory.block_size(h, w, n, fv._get_core(w, h).bytes_per_px_frame(False),
                                 fv.device) > 20


@pytest.mark.gpu
def test_card_attribute_sequence_matches_fresh_metrics():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tst, ref = _image()

    def port(**kw):
        return fvvdp(display_name="standard_fhd", heatmap="threshold", **kw)
    _, seq = _run_sequence(port, tst, ref)
    for k, (q, d) in enumerate(seq):
        q_f, d_f = _fresh(port, tst, ref, k)
        assert abs(q - q_f) <= 1e-6 and d == d_f, (STEPS[k][0], q, q_f)
