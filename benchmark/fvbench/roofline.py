"""The card's peak and the least bytes each stage of the metric must move.

Peak: one H100 SXM's HBM3 bandwidth from NVIDIA's data sheet (the rate
chip_smoke.py's ``bound()`` divides by), at the card's full power limit.
A stage's bytes are counted from the shapes of the work, whatever kernel
does it: each input byte read once and each output byte written once, in
float32 past the raw uint8 RGB frames.  Channels: four responses (test and
reference, sustained and transient) for a clip, two (test and reference)
for an image.  ``frames`` is a clip's frames, or an image set's pairs;
``shapes`` the Gaussian levels, the reference's ``Pyramid.shapes``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

MEM_BYTES_PER_S = 3.35e12
F32 = 4
RGB8 = 3


def _px(shapes: Sequence[Tuple[int, int]], l: int) -> int:
    return shapes[l][0] * shapes[l][1]


def luminance(w: Dict) -> int:
    """The raw uint8 RGB pair in, the float32 luminance pair out."""
    return 2 * w["frames"] * w["H"] * w["W"] * (RGB8 + F32)


def temporal(w: Dict) -> int:
    """The luminance pair in, the four channel responses out (the padding
    before the first frame repeats it, so it reads nothing more)."""
    if w["kind"] != "clip":
        return 0
    return F32 * w["H"] * w["W"] * (2 * w["frames"] + 4 * w["frames"])


def reduce(w: Dict) -> int:
    """Each Gaussian level in, the next level out."""
    s, C, F = w["shapes"], w["channels"], w["frames"]
    return F32 * C * F * sum(_px(s, l) + _px(s, l + 1) for l in range(len(s) - 1))


def _levels_in(w: Dict) -> int:
    """Every Gaussian level, the coarsest included, read once."""
    s = w["shapes"]
    return F32 * w["channels"] * w["frames"] * sum(_px(s, l) for l in range(len(s)))


def expand_score(w: Dict) -> int:
    """Every Gaussian level in, two sums per band and frame out."""
    return _levels_in(w) + F32 * 2 * w["frames"] * (len(w["shapes"]) - 1)


def expand_contrast(w: Dict) -> int:
    """Every Gaussian level in, each band's contrast and background
    luminance out."""
    s, C, F = w["shapes"], w["channels"], w["frames"]
    return _levels_in(w) + F32 * F * (C + 1) * sum(_px(s, l) for l in range(len(s) - 1))


def band_score(w: Dict) -> int:
    """Each band's contrast and background luminance in, two sums per band
    and frame out."""
    s, C, F = w["shapes"], w["channels"], w["frames"]
    return F32 * sum((C + 1) * F * _px(s, l) + 2 * F for l in range(len(s) - 1))


def fov_maps(w: Dict) -> int:
    """A gaze per frame: each band's static maps (two view-direction planes
    and the rho coordinate), read once per call."""
    s = w["shapes"]
    return F32 * 3 * sum(_px(s, l) for l in range(len(s) - 1))


WORK = {"luminance": luminance, "temporal": temporal, "reduce": reduce,
        "expand_score": expand_score, "expand_contrast": expand_contrast,
        "band_score": band_score, "fov_maps": fov_maps}


def least_seconds(work: Sequence[str], w: Dict, calls: int) -> float:
    """The least time ``calls`` calls of the stages ``work`` could take."""
    return calls * sum(WORK[name](w) for name in sorted(set(work))) / MEM_BYTES_PER_S
