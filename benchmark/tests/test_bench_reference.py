"""The plain reference against the port's plain path (``device="cpu"``)
on small clips and image pairs, on both configurations' display: the two
compute the same metric, in another order."""
import numpy as np
import pytest
import torch

from conftest import SMALL_CLIP, SMALL_SET, small_cell
from fvbench import content
from reference.fvvdp_plain import PlainFvvdp

import fovvideovdp_tpu_torch as fv


@pytest.mark.parametrize("workload", ["4k-clip", "4k-clip-gaze"])
@pytest.mark.parametrize("seed", [0, 2**31 + 101])
def test_clip_against_port(workload, seed):
    cell = small_cell(workload, **SMALL_CLIP)
    cfg, tr = cell.config, cell.traffic
    plain = PlainFvvdp(cfg, "cpu")
    metric = fv.fvvdp(display_name=cfg["display"]["name"], device="cpu", **tr["metric"])
    for k in range(cfg["pairs"]):
        t, r = content.clip_pair(cfg, k, seed, torch.device("cpu"))
        g = content.gaze_path(cfg, tr["gaze"], k, seed) if tr["gaze"] else None
        src = fv.fvvdp_video_source_array(t, r, cfg["fps"], dim_order=cfg["layout"],
                                          display_photometry=metric.display_photometry,
                                          device="cpu")
        q, stats = metric.predict_video_source(src, fixation_point=g)
        qr, Qr = plain.score_clip(t, r, cfg["fps"], g)
        assert q < 9.99                       # the content is visibly distorted
        assert abs(q - qr) <= 2e-6
        assert np.max(np.abs(stats["Q_per_ch"] - Qr)) <= 1e-5 * np.max(np.abs(Qr))


def test_images_against_port():
    cell = small_cell("kadid-batch", **SMALL_SET)
    cfg = cell.config
    refs = content.image_refs(cfg, 5, torch.device("cpu"))
    t, r = content.image_pairs(cfg, refs, range(0, 250), 5)
    jods, _ = fv.fvvdp(display_name=cfg["display"]["name"], device="cpu").predict_batch(
        t, r, dim_order=cfg["layout"])
    ref = PlainFvvdp(cfg, "cpu").score_images(t, r, chunk=64)
    assert np.max(np.abs(jods - ref)) <= 2e-6
    assert np.ptp(ref) > 1.0                  # the levels spread the scores


def test_content_rows_are_the_sets_rows():
    """Any range of rows of an image set is those rows of the whole set."""
    cfg = small_cell("kadid-batch", **SMALL_SET).config
    refs = content.image_refs(cfg, 9, torch.device("cpu"))
    t_all, r_all = content.image_pairs(cfg, refs, range(0, 250), 9)
    t, r = content.image_pairs(cfg, refs, range(117, 190), 9)
    assert torch.equal(t, t_all[117:190]) and torch.equal(r, r_all[117:190])
