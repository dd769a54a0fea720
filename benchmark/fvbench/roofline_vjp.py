"""The least bytes of one call of the metric as a training loss: the forward
of a float clip pair and the backward of the loss into the test clip.

The forward is ``roofline``'s clip step (``temporal``, ``reduce``,
``expand_score``) with the luminance of float input: three channels at 4 B a
sample in per side, the float32 luminance pair out.  In the backward each
stage's VJP reads its output cotangent and the inputs its derivative needs
once, and writes its input cotangent once, in float32, for the channels
that carry a gradient: the test clip's sustained and transient responses
(the reference clip is detached).  The pooling's few numbers a frame are
not counted, as ``roofline`` counts none for the forward's.

* ``expand_score`` at each band: the two sums' cotangents per frame and the
  fine and coarse levels of all four channels in (the masking and the
  background luminance need both sides), both levels' test cotangents out;
* ``reduce`` (linear: it needs no input): the coarse level's cotangent in,
  the fine level's out;
* ``temporal`` (linear): the responses' cotangents in, the test
  luminance's out (the padding before the first frame folds into frame 0,
  as the forward reads it once);
* ``luminance``: its cotangent and the float test clip in, the clip's
  cotangent (three channels) out.

``w`` is ``roofline``'s work description of a clip (``cells.work``).
"""
from __future__ import annotations

from typing import Dict

from fvbench import roofline

F32 = roofline.F32
GRAD_CHANNELS = 2            # the test clip's sustained and transient responses


def _px(w: Dict, l: int) -> int:
    return w["shapes"][l][0] * w["shapes"][l][1]


def forward(w: Dict) -> int:
    lum = 2 * w["frames"] * w["H"] * w["W"] * (3 * F32 + F32)
    return lum + roofline.temporal(w) + roofline.reduce(w) + roofline.expand_score(w)


def backward(w: Dict) -> int:
    F, C, G = w["frames"], w["channels"], GRAD_CHANNELS
    pairs = [_px(w, l) + _px(w, l + 1) for l in range(len(w["shapes"]) - 1)]
    expand = sum(F32 * F * (2 + (C + G) * p) for p in pairs)
    reduce = sum(F32 * F * G * p for p in pairs)
    frame = F * w["H"] * w["W"]
    temporal = F32 * frame * (G + 1)
    luminance = F32 * frame * (1 + 3 + 3)
    return expand + reduce + temporal + luminance


def least_seconds(w: Dict, calls: int) -> float:
    """The least time ``calls`` calls, forward and backward, could take at
    the card's memory bandwidth."""
    return calls * (forward(w) + backward(w)) / roofline.MEM_BYTES_PER_S
