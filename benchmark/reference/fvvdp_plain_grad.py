"""FovVideoVDP as a training loss, in plain PyTorch: the reference of the
configurations that back-propagate through the metric.

It extends ``fvvdp_plain`` (whose docstring gives the metric) to what a
training step asks of it, as the published implementation's
``use_checkpoints`` path does (pyfvvdp/fvvdp.py): display-encoded float
input, (3, F, H, W) sRGB values in [0, 1], the test clip differentiated and
the reference clip not.  :meth:`PlainFvvdpGrad.jod_and_grad` returns the JOD
and d loss / d test, where the loss is 10 - JOD.

The gradient is computed in two passes, so that a whole 4K clip fits on one
card:

1. Q (n_bands, 2, F) without a graph, then dJOD/dQ by autograd through
   ``pool`` alone;
2. for each block of output frames, that block's padded window (the fl - 1
   frames before it, frame 0 repeated before the clip) is recomputed from
   the test clip with a graph, and <dJOD/dQ[block], Q[block]> is
   back-propagated into it.  A block's Q depends on its window alone, so the
   blocks' gradients add up to the whole clip's.

``block=None`` takes one graph through the whole clip and the pooling
instead: the test holds the blocked passes to it.

Gradient rules at exact ties and bounds, where autograd has a choice:

* the display clips each channel to [0, 1] as min(max(v, 0), 1), so that a
  value exactly at a bound passes half of its gradient (``torch.maximum``
  and ``torch.minimum`` split it evenly at a tie): ``jnp.clip``'s rule,
  which the JAX package has and the port keeps (``utils.clip``), not
  ``torch.clamp``'s, which passes all of it.  The float content of the
  configurations holds values exactly 0 and 1 (uint8 codes over 255), so
  the choice shows: with ``torch.clamp`` every such sample's gradient
  doubles;
* everything else is ``fvvdp_plain``'s own: ``torch.clamp`` at the
  background luminance's 0.1 cd/m^2, the contrast's 1000 and D's 1e4,
  ``torch.minimum`` in the mutual masking.  The port's plain versions
  differentiate the same operations, and no sample of the content sits at
  those bounds: the clamped values are continuous, and where |T| = |R|
  exactly (test equal to reference) D and its derivatives are 0.

Everything runs in ``dtype`` (float32 for the reference, TF32 off; the
control runs it in bfloat16), the pooling in float64 as ``fvvdp_plain``'s.
It imports torch, numpy and ``fvvdp_plain`` only: nothing of the program
under test.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from reference.fvvdp_plain import PlainFvvdp, Pyramid, temporal_filters


def clip_unit(v: torch.Tensor) -> torch.Tensor:
    """v clipped to [0, 1] as min(max(v, 0), 1): ``torch.clamp``'s value,
    with half the gradient passed at an exact bound (see the module's
    docstring)."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_ones(()))


class PlainFvvdpGrad(PlainFvvdp):
    """The metric of one configuration on ``device``, in ``dtype``, on float
    display-encoded input, with its gradient (see the module's docstring)."""

    def luminance(self, v: torch.Tensor) -> torch.Tensor:
        """(3, n, H, W) display-encoded sRGB -> (n, H, W) absolute
        luminance: each channel through the display (sRGB EOTF, peak, black
        level and ambient reflection), then the ``rgb2y`` weights, summed R,
        G, B."""
        d = self.display
        ch = []
        for c in torch.unbind(v, dim=0):
            c = clip_unit(c)
            lin = torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
            ch.append((d.Y_peak - d.Y_black) * lin + d.Y_black)
        return ch[0] * self.rgb2y[0] + ch[1] * self.rgb2y[1] + ch[2] * self.rgb2y[2]

    def block_q(self, test: torch.Tensor, ref: torch.Tensor, a: int, b: int,
                taps: np.ndarray, pyr: Pyramid) -> torch.Tensor:
        """Q (n_bands, 2, b - a) of output frames a .. b-1, each side (3, F,
        H, W) in ``dtype``, from the block's own padded window; an image
        (F = 1) has no temporal channels and a transient row of 0."""
        F, H, W = test.shape[1:]
        if F == 1:
            R = torch.stack([self.luminance(test)[0], self.luminance(ref)[0]], dim=0)[None]
            q = self._band_q(R, pyr, 1, None)                       # (height, 1, 1)
            return torch.cat([q, torch.zeros_like(q)], dim=1)
        fl = taps.shape[1]
        pad = np.asarray([0] * (fl - 1) + list(range(F)))          # frame 0 repeated
        idx = torch.as_tensor(pad[a:b + fl - 1], device=test.device)
        lt = self.luminance(test.index_select(1, idx))              # (n + fl - 1, H, W)
        lr = self.luminance(ref.index_select(1, idx))
        n = b - a

        def filtered(lum, c):
            return sum(float(taps[c, j]) * lum[fl - 1 - j:fl - 1 - j + n]
                       for j in range(fl) if float(taps[c, j]) != 0.0)

        R = torch.stack([filtered(lt, 0), filtered(lr, 0), filtered(lt, 1), filtered(lr, 1)],
                        dim=1)
        return self._band_q(R, pyr, 2, None)

    def jod_and_grad(self, test: torch.Tensor, ref: torch.Tensor, fps: float,
                     block: Optional[int] = 4) -> Tuple[float, torch.Tensor]:
        """(JOD, d loss / d test in float32) of a pair, each (3, F, H, W)
        display-encoded floats on the device; ``block`` output frames are
        recomputed with a graph at a time (None: one graph through the whole
        clip and the pooling)."""
        F, H, W = test.shape[1:]
        pyr = Pyramid(W, H, self.display.ppd)
        taps = temporal_filters(fps, self.p["sustained_sigma"], self.p["sustained_beta"])
        xt = test.detach().to(self.dtype).requires_grad_(True)
        xr = ref.detach().to(self.dtype)
        if block is None:
            with torch.enable_grad():
                jod = self.pool(self.block_q(xt, xr, 0, F, taps, pyr))
                grad, = torch.autograd.grad(-jod, xt)
            return float(jod.detach()), grad.float()
        starts = range(0, F, block)
        with torch.no_grad():
            Q = torch.cat([self.block_q(xt, xr, a, min(F, a + block), taps, pyr)
                           for a in starts], dim=-1)
        Q.requires_grad_(True)
        with torch.enable_grad():
            jod = self.pool(Q)
            dQ, = torch.autograd.grad(-jod, Q)
        grad = torch.zeros_like(xt)
        for a in starts:
            b = min(F, a + block)
            with torch.enable_grad():
                g, = torch.autograd.grad(self.block_q(xt, xr, a, b, taps, pyr), xt,
                                         dQ[..., a:b])
            grad += g
            del g
        return float(jod.detach()), grad.float()
