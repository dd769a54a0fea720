"""The stages' byte counts against counts made by hand, on the levels of
the reference's pyramid, which the runs count with (``cells.work``)."""
import pytest

from fvbench import roofline
from reference.fvvdp_plain import Pyramid

# 8 x 12 pixels at 60 pixels a degree: two levels below the image
SHAPES = Pyramid(12, 8, 60.0).shapes
CLIP = {"kind": "clip", "H": 8, "W": 12, "frames": 3, "fl": 8, "channels": 4, "shapes": SHAPES}
IMG = {"kind": "images", "H": 8, "W": 12, "frames": 5, "fl": 1, "channels": 2, "shapes": SHAPES}


def test_level_shapes_round_up():
    assert SHAPES == [(8, 12), (4, 6), (2, 3)]
    assert Pyramid(13, 9, 60.0).shapes == [(9, 13), (5, 7), (3, 4)]
    assert Pyramid(3840, 2160, 60.0).shapes[:2] == [(2160, 3840), (1080, 1920)]


def test_luminance_by_hand():
    # 3 frames (5 pairs) of a pair, 96 pixels: 3 B of RGB in, 4 B out
    assert roofline.luminance(CLIP) == 2 * 3 * 96 * (3 + 4)
    assert roofline.luminance(IMG) == 2 * 5 * 96 * (3 + 4)


def test_temporal_by_hand():
    # 3 frames of a pair in (the padding repeats frame 0), 4 channels x 3
    # frames out, 96 pixels, 4 B
    assert roofline.temporal(CLIP) == 4 * 96 * (2 * 3 + 4 * 3)
    assert roofline.temporal(IMG) == 0


def test_reduce_by_hand():
    # levels (96 -> 24 px) and (24 -> 6 px), 4 channels x 3 frames
    assert roofline.reduce(CLIP) == 4 * 4 * 3 * ((96 + 24) + (24 + 6))
    assert roofline.reduce(IMG) == 4 * 2 * 5 * ((96 + 24) + (24 + 6))


def test_scorers_by_hand():
    # levels of 96, 24 and 6 pixels, each read once; 2 bands
    assert roofline.expand_score(CLIP) == 4 * (4 * 3 * (96 + 24 + 6) + 2 * 3 * 2)
    assert roofline.expand_contrast(CLIP) == 4 * (4 * 3 * (96 + 24 + 6) + 5 * 3 * (96 + 24))
    assert roofline.band_score(CLIP) == 4 * ((5 * 3 * 96 + 6) + (5 * 3 * 24 + 6))
    assert roofline.fov_maps(CLIP) == 4 * 3 * (96 + 24)
    assert roofline.expand_score(IMG) == 4 * (2 * 5 * (96 + 24 + 6) + 2 * 5 * 2)


def test_least_seconds_counts_each_stage_once():
    one = roofline.least_seconds(["reduce"], CLIP, 1)
    assert one == pytest.approx(roofline.reduce(CLIP) / roofline.MEM_BYTES_PER_S)
    assert roofline.least_seconds(["reduce", "reduce"], CLIP, 3) == pytest.approx(3 * one)


def _ctx(**k):
    from fvbench import readers, registry, trace
    s = trace.Summary(window_s=2.0, busy_s=1.5, calls=3, device_ops=[], idle_gaps=[],
                      device_s_by_symbol={"reduce_kernel": 0.5, "vectorized_elementwise_kernel": 1.0})
    return readers.Context([s], registry.stages(), CLIP, calls=3, frames=9, **k)


def test_readers_on_a_trace():
    from fvbench import readers
    ctx = _ctx(step=["luminance", "reduce"])
    assert readers.mean_idle_share(ctx) == pytest.approx(25.0)
    # only the reduce stage ran: its bytes over the port's kernel time
    assert readers.kernel_roofline(ctx) == pytest.approx(
        100 * roofline.least_seconds(["reduce"], CLIP, 3) / 0.5)
    assert readers.step_share(ctx) == pytest.approx(
        100 * 3 * (roofline.luminance(CLIP) + roofline.reduce(CLIP))
        / roofline.MEM_BYTES_PER_S / 2.0)
    assert readers.other_device_ms(ctx, 9) == pytest.approx(1e3 / 9)


def test_readers_without_device_time():
    from fvbench import readers, trace
    ctx = _ctx(step=["reduce"])
    ctx.summaries = [trace.Summary(2.0, 0.0, {}, [], [], 3)]
    assert readers.mean_idle_share(ctx) is None
    assert readers.kernel_roofline(ctx) is None and readers.step_share(ctx) is None


def test_readers_over_processes():
    """Several processes doing the same calls: the mean of their kernel
    times and windows, the idle shares one per process."""
    from fvbench import readers, registry, trace
    sums = [trace.Summary(2.0, 1.5, {"reduce_kernel": 0.4}, [], [], 3),
            trace.Summary(4.0, 2.0, {"reduce_kernel": 0.6}, [], [], 3)]
    ctx = readers.Context(sums, registry.stages(), CLIP, calls=3, step=["reduce"])
    least = roofline.least_seconds(["reduce"], CLIP, 3)
    assert readers.kernel_roofline(ctx) == pytest.approx(100 * least / 0.5)
    assert readers.step_share(ctx) == pytest.approx(100 * least / 3.0)
    assert readers.idle_shares(ctx) == pytest.approx([25.0, 50.0])
