"""Seeded HDR10 clips, made on the device: raw Y'CbCr frames as an HDR10
decoder writes them (ITU-R BT.2100: PQ, BT.2020, narrow range, planar Y',
Cb, Cr, 4:2:0 or 4:4:4, 10-bit samples in 16-bit words).

The scene is ``content.texture``'s 1/f canvas panning at the pair's speed,
its luminance mapped to log luminance over the configuration's
``scene_cd_m2`` range, its colour opponent fields kept as modest BT.2020
chroma, with sparse specular highlights at ``highlight_cd_m2``.  Each
frame is encoded as a mastering chain does: linear light through the PQ
inverse EOTF, the BT.2020 Y'CbCr matrix (Kr = 0.2627, Kb = 0.0593), the
chroma averaged over 2 x 2 pixels (4:2:0), rounded to narrow-range codes.
The test clip carries the pair's distortions, applied to the planes in
code units before the rounding: white noise (sigma in codes of the
configuration's bit depth, drawn anew in every frame), a Gaussian blur
(sigma in luma pixels; the chroma planes get it scaled by their size),
and quantisation to fewer bits (banding).

The same seed gives the same samples on a given device; the seed changes
only the samples, never the amount of work.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fvbench import content
from reference.fvvdp_plain_hdr import lin2pq

# BT.2020 luma weights of the non-constant-luminance Y'CbCr encoding
KR, KB = 0.2627, 0.0593
KG = 1.0 - KR - KB


def _scene(rgb: torch.Tensor, highlight: torch.Tensor, c: Dict) -> torch.Tensor:
    """(m, 3, H, W) texture values in [0, 1] and the (m, 1, H, W) highlight
    weights -> linear R, G, B in cd/m^2."""
    lo, hi = (math.log(float(v)) for v in c["scene_cd_m2"])
    luma = KR * rgb[:, 0:1] + KG * rgb[:, 1:2] + KB * rgb[:, 2:3]
    y = torch.exp(lo + (hi - lo) * torch.clamp(luma, 0.0, 1.0))
    tint = torch.clamp(1.0 + float(c["chroma_gain"]) * (rgb - luma), 0.2, 3.0)
    return torch.lerp(y * tint, torch.full_like(tint, float(c["highlight_cd_m2"])), highlight)


def _highlights(h: int, w: int, share: float, g: torch.Tensor, device) -> torch.Tensor:
    """(1, 1, h, w) weights in [0, 1]: about ``share`` of the pixels the
    centres of small round highlights."""
    seeds = (torch.rand((1, 1, h, w), generator=g, device=device) < share).float()
    sigma = 1.5
    return torch.clamp(content.blur(seeds, sigma) * (2.0 * math.pi * sigma ** 2), 0.0, 1.0)


def _ycbcr(rgb_lin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear R, G, B (m, 3, H, W) -> Y' (m, 1, H, W), Cb and Cr in [-0.5, 0.5]."""
    v = lin2pq(rgb_lin)
    y = KR * v[:, 0:1] + KG * v[:, 1:2] + KB * v[:, 2:3]
    return y, (v[:, 2:3] - y) / (2.0 * (1.0 - KB)), (v[:, 0:1] - y) / (2.0 * (1.0 - KR))


def _codes(x: torch.Tensor, bits: int, chroma: bool) -> torch.Tensor:
    """Normalised Y' or chroma -> narrow-range codes, unrounded."""
    s = float(2 ** (bits - 8))
    return (224.0 * x + 128.0) * s if chroma else (219.0 * x + 16.0) * s


def _distort(planes, ops, bits: int, g: torch.Tensor):
    """(Y', Cb, Cr) in code units through each (op, strength) in turn."""
    out = list(planes)
    for op, v in ops:
        v = float(v)
        if op == "noise":
            out = [p + v * torch.randn(p.shape, generator=g, device=p.device) for p in out]
        elif op == "blur":
            out = [content.blur(p, v * p.shape[-1] / out[0].shape[-1]) for p in out]
        elif op == "bits":
            step = float(2 ** (bits - int(v)))
            out = [torch.round(p / step) * step for p in out]
        else:
            raise ValueError(f"unknown distortion {op!r}")
    return out


def _store(planes, bits: int) -> torch.Tensor:
    """(Y', Cb, Cr) in code units -> (m, frame_samples) stored samples."""
    m = planes[0].shape[0]
    top = 2 ** bits - 1
    flat = [torch.clamp(torch.round(p), 0, top).reshape(m, -1) for p in planes]
    return torch.cat(flat, dim=1).to(torch.int16 if bits > 8 else torch.uint8)


def clip_pair(cfg: Dict, k: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair ``k`` of an HDR10 clip configuration: (test, reference), each
    (F, frame_samples) stored samples on the device (int16 for more than
    8 bits)."""
    c = cfg["content"]
    H, W, n, bits = cfg["height"], cfg["width"], cfg["frames"], int(cfg["bit_depth"])
    sub = cfg["chroma_ss"] == "420"
    vx, vy = c["pan_px_per_frame"][k]
    g = content.generator(device, content.sub_seed(seed, 5, k))
    ch, cw = H + abs(vy) * n, W + abs(vx) * n
    canvas = content.texture(1, ch, cw, g, device)[0]
    shine = _highlights(ch, cw, float(c["highlight_share"]), g, device)[0]
    samples = H * W + 2 * ((H // 2) * (W // 2) if sub else H * W)
    dt = torch.int16 if bits > 8 else torch.uint8
    ref = torch.empty((n, samples), dtype=dt, device=device)
    test = torch.empty_like(ref)
    step = int(c.get("frames_per_chunk", 8))
    for a in range(0, n, step):
        b = min(n, a + step)
        crops = []
        for f in range(a, b):
            y0 = (abs(vy) * f) if vy >= 0 else abs(vy) * (n - f)
            x0 = (abs(vx) * f) if vx >= 0 else abs(vx) * (n - f)
            crops.append(torch.cat([canvas[:, y0:y0 + H, x0:x0 + W],
                                    shine[:, y0:y0 + H, x0:x0 + W]], dim=0))
        fr = torch.stack(crops, dim=0)                                 # (m, 4, H, W)
        y, cb, cr = _ycbcr(_scene(fr[:, :3], fr[:, 3:], c))
        del fr
        if sub:
            cb, cr = F.avg_pool2d(cb, 2), F.avg_pool2d(cr, 2)
        planes = [_codes(y, bits, False), _codes(cb, bits, True), _codes(cr, bits, True)]
        ref[a:b] = _store(planes, bits)
        test[a:b] = _store(_distort(planes, c["distortions"][k], bits, g), bits)
        del y, cb, cr, planes
    return test, ref
