"""FovVideoVDP in plain PyTorch on HDR10 video: the reference of the
configurations whose clips are raw Y'CbCr frames on a PQ display.

It extends ``fvvdp_plain`` (whose docstring gives the metric) with the
front stage that turns ITU-R BT.2100 HDR10 frames into absolute luminance,
written from the upstream description (pyfvvdp/video_source_yuv.py and
display_model.py of the published implementation, SMPTE ST 2084, ITU-R
BT.2020 and BT.2100):

* stored samples, planar Y', then Cb, then Cr, 10-bit samples in 16-bit
  words (uint16, or int16 holding the same bits);
* narrow range to float: Y' = D / (219 * 2^(b-8)) - 16/219 clipped to
  [0, 1], Cb and Cr = D / (224 * 2^(b-8)) - 128/224 clipped to [-0.5, 0.5];
* 4:2:0 to 4:4:4 by bilinear interpolation with half-pixel sample centres
  (each full-resolution sample 3/4 of its nearest chroma sample and 1/4 of
  the next one, the edge samples repeated), along rows, then columns;
* the BT.2020 non-constant-luminance Y'CbCr -> R'G'B' matrix, and each of
  R', G', B' clipped to [0, 1];
* the PQ display: clip(pq2lin(V), 0.005, Y_peak) + Y_black, with
  Y_black = E_ambient / pi * k_refl + Y_peak / contrast;
* Y = the configuration's ``rgb2y`` weights over the three channels.

Departures from the letter of the standards, each the upstream's:

* the matrix holds the upstream's five-digit coefficients (1.4746, 0.16455,
  0.57135, 1.8814), not the exact ones from Kr = 0.2627, Kb = 0.0593;
* ``rgb2y`` is the upstream's BT.2020 row of color_spaces.json, taken as it
  is (its three weights sum to 1.134, not 1);
* the display clips each channel's luminance at 0.005 cd/m^2 and at the
  peak before adding the black level, as the upstream's PQ display does.

The arithmetic keeps the upstream's order (the decode's scale before its
offset, the matrix's terms Y' first, the channels' luminance summed R, G,
B): in float32 the PQ EOTF near the peak divides by c2 - c3 * V^(1/m2),
about 0.25, so one unit in the last place of a channel value moves the
luminance by up to ~5e-5 of itself, and another order of the same
operations would read as a gap of that size.

Everything runs in ``dtype`` (float32 for the reference, TF32 off; the
control runs it in bfloat16).  It imports torch, numpy and ``fvvdp_plain``
only: nothing of the program under test.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from reference.fvvdp_plain import Display, PlainFvvdp, Pyramid, temporal_filters

# SMPTE ST 2084
PQ_M1 = 2610.0 / 16384.0
PQ_M2 = 2523.0 / 4096.0 * 128.0
PQ_C1 = 3424.0 / 4096.0
PQ_C2 = 2413.0 / 4096.0 * 32.0
PQ_C3 = 2392.0 / 4096.0 * 32.0
PQ_PEAK = 10000.0

# Y'CbCr -> R'G'B', BT.2020 non-constant luminance, the upstream's rounding
YCBCR_TO_RGB = {
    "BT.2020": ((1.0, 0.0, 1.4746), (1.0, -0.16455, -0.57135), (1.0, 1.8814, 0.0)),
}


def pq2lin(v: torch.Tensor) -> torch.Tensor:
    """PQ-encoded V in [0, 1] -> absolute luminance in cd/m^2 (ST 2084)."""
    p = torch.pow(torch.clamp(v, min=0.0), 1.0 / PQ_M2)
    return PQ_PEAK * torch.pow(torch.clamp(p - PQ_C1, min=0.0) / (PQ_C2 - PQ_C3 * p),
                               1.0 / PQ_M1)


def lin2pq(y: torch.Tensor) -> torch.Tensor:
    """Absolute luminance -> PQ-encoded V (ST 2084's inverse EOTF)."""
    q = torch.pow(torch.clamp(y / PQ_PEAK, 0.0, 1.0), PQ_M1)
    return torch.pow((PQ_C1 + PQ_C2 * q) / (1.0 + PQ_C3 * q), PQ_M2)


class PQDisplay(Display):
    """A display that decodes with the PQ EOTF: ``Display``'s geometry and
    black level, and its own ``luminance``."""

    def __init__(self, photometry: Dict, geometry: Dict):
        if photometry.get("EOTF") != "PQ":
            raise ValueError(f"PQDisplay decodes PQ, not {photometry.get('EOTF')!r}")
        # Display refuses any EOTF but sRGB; the geometry and the black level
        # it computes do not depend on it
        super().__init__({k: v for k, v in photometry.items() if k != "EOTF"}, geometry)

    def luminance(self, v: torch.Tensor) -> torch.Tensor:
        """PQ-encoded values -> absolute luminance (cd/m^2) on the display."""
        y = pq2lin(torch.clamp(v, 0.0, 1.0))
        return torch.clamp(y, 0.005, self.Y_peak) + self.Y_black


class YUVLayout:
    """Where each plane lies in a raw frame of the configuration."""

    def __init__(self, config: Dict):
        self.W, self.H = int(config["width"]), int(config["height"])
        self.bits = int(config["bit_depth"])
        self.subsampled = config["chroma_ss"] == "420"
        if config.get("range", "narrow") != "narrow":
            raise ValueError("the reference decodes narrow-range samples only")
        self.cw, self.ch = (self.W // 2, self.H // 2) if self.subsampled else (self.W, self.H)

    def planes(self, raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(n, frame_samples) stored samples -> the integer codes of Y'
        (n, H, W), Cb and Cr (n, ch, cw), as int32."""
        n = raw.shape[0]
        codes = raw.to(torch.int32) & 0xFFFF if raw.dtype == torch.int16 else raw.to(torch.int32)
        y_n, c_n = self.W * self.H, self.cw * self.ch
        return (codes[:, :y_n].reshape(n, self.H, self.W),
                codes[:, y_n:y_n + c_n].reshape(n, self.ch, self.cw),
                codes[:, y_n + c_n:].reshape(n, self.ch, self.cw))


def narrow_to_float(codes: torch.Tensor, bits: int, chroma: bool, dtype) -> torch.Tensor:
    """Narrow-range integer codes -> Y' in [0, 1] or Cb/Cr in [-0.5, 0.5],
    as the upstream computes them: the code times 1 / (219 * 2^(b-8)) (224
    for chroma), less 16/219 (128/224)."""
    if chroma:
        x = codes.to(dtype) * (1.0 / (2 ** (bits - 8) * 224.0)) - 128.0 / 224.0
        return torch.clamp(x, -0.5, 0.5)
    x = codes.to(dtype) * (1.0 / (2 ** (bits - 8) * 219.0)) - 16.0 / 219.0
    return torch.clamp(x, 0.0, 1.0)


def _double(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Twice the samples along ``axis``, each new sample 3/4 of its nearest
    old sample and 1/4 of the next nearest (half-pixel centres); the first
    and the last new sample are the edge samples themselves."""
    x = torch.movedim(x, axis, -1)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    even[..., 0] = x[..., 0]
    odd[..., -1] = x[..., -1]
    out = torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))
    return torch.movedim(out, -1, axis)


def upsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """(..., h, w) chroma -> (..., 2h, 2w), bilinear with half-pixel
    centres: along each row, then along each column."""
    return _double(_double(c, -1), -2)


class PlainFvvdpHDR(PlainFvvdp):
    """The metric of an HDR10 Y'CbCr configuration on ``device``, in
    ``dtype``.  ``config`` adds to ``PlainFvvdp``'s: ``width``, ``height``,
    ``bit_depth``, ``chroma_ss``, ``range`` and ``color_space``, and a PQ
    display."""

    def __init__(self, config: Dict, device, dtype=torch.float32):
        disp = config["display"]
        sdr = {k: v for k, v in disp["photometry"].items() if k != "EOTF"}
        super().__init__(dict(config, display=dict(disp, photometry=sdr)), device, dtype)
        self.display = PQDisplay(disp["photometry"], disp["geometry"])
        self.layout = YUVLayout(config)
        self.matrix = YCBCR_TO_RGB[config["color_space"]]

    def rgb(self, raw: torch.Tensor):
        """(n, frame_samples) stored samples -> R', G', B' (each (n, H, W))
        in [0, 1]."""
        lay = self.layout
        y, cb, cr = lay.planes(raw)
        y = narrow_to_float(y, lay.bits, False, self.dtype)
        cb = narrow_to_float(cb, lay.bits, True, self.dtype)
        cr = narrow_to_float(cr, lay.bits, True, self.dtype)
        if lay.subsampled:
            cb, cr = upsample_chroma(cb), upsample_chroma(cr)
        return [torch.clamp(m[0] * y + m[1] * cb + m[2] * cr, 0.0, 1.0) for m in self.matrix]

    def luminance(self, raw: torch.Tensor, chunk: int = 4) -> torch.Tensor:
        """(n, frame_samples) stored samples -> (n, H, W) absolute
        luminance, ``chunk`` frames at a time."""
        out = torch.empty((raw.shape[0], self.layout.H, self.layout.W), dtype=self.dtype,
                          device=self.device)
        for a in range(0, raw.shape[0], chunk):
            ch = [self.display.luminance(c) for c in self.rgb(raw[a:a + chunk])]
            out[a:a + chunk] = ch[0] * self.rgb2y[0] + ch[1] * self.rgb2y[1] \
                + ch[2] * self.rgb2y[2]
        return out

    def score_clip(self, test: torch.Tensor, ref: torch.Tensor, fps: float,
                   gaze: Optional[np.ndarray] = None, block: int = 8
                   ) -> Tuple[float, np.ndarray]:
        """(JOD, Q_per_ch (n_bands, 2, F)) of a clip pair, each (F,
        frame_samples) stored samples on the device; not foveated (``gaze``
        must be None).  ``block`` output frames are scored at a time, each
        from its own padded window, its frames decoded anew."""
        if gaze is not None:
            raise ValueError("the HDR reference scores without foveation")
        F, H, W = test.shape[0], self.layout.H, self.layout.W
        pyr = Pyramid(W, H, self.display.ppd)
        taps = temporal_filters(fps, self.p["sustained_sigma"], self.p["sustained_beta"])
        fl = taps.shape[1]
        pad = np.asarray([0] * (fl - 1) + list(range(F)))      # frame 0 repeated
        Q = []
        for a in range(0, F, block):
            b = min(F, a + block)
            idx = torch.as_tensor(pad[a:b + fl - 1], device=test.device)
            lt = self.luminance(test.index_select(0, idx))      # (n + fl - 1, H, W)
            lr = self.luminance(ref.index_select(0, idx))
            R = torch.zeros((b - a, 4, H, W), dtype=self.dtype, device=self.device)
            for c in range(2):
                for j in range(fl):
                    wgt = float(taps[c, j])
                    if wgt != 0.0:
                        R[:, 2 * c] += wgt * lt[fl - 1 - j:fl - 1 - j + b - a]
                        R[:, 2 * c + 1] += wgt * lr[fl - 1 - j:fl - 1 - j + b - a]
            del lt, lr
            Q.append(self._band_q(R, pyr, 2, None))
            del R
        Q = torch.cat(Q, dim=-1)
        return float(self.pool(Q)), Q.float().cpu().numpy()

