"""Seeded content, made on the device: reference clips and images with a
natural-looking spectrum, their distorted test versions, and gaze paths.

The same seed gives the same bytes on a given device.  The sizes, the
distortions and their strengths come from the configuration file; the
seed changes only the pixels, never the amount of work.  Every random
draw comes from a ``torch.Generator`` on the device, a few large calls at
a time; the gaze paths, a few hundred numbers, come from numpy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MASK63 = (1 << 63) - 1


def sub_seed(seed: int, *keys: int) -> int:
    """A seed for one part of the content, from the run's seed and the
    part's index (any size of seed; the result fits a generator)."""
    s = int(seed) & _MASK63
    for k in keys:
        s = (s * 1_000_003 + int(k) + 0x9E3779B97F4A7C15) & _MASK63
    return s


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def texture(n: int, h: int, w: int, g: torch.Generator, device, octaves: int = 7,
            slope: float = 1.0, edges: float = 0.35) -> torch.Tensor:
    """(n, 3, h, w) float32 in [0, 1]: a sum of bilinearly upsampled noise
    octaves whose amplitude falls as 2^-(slope * octave) towards fine
    detail (a 1/f-like spectrum), plus sharp edges from the sign of a
    coarse field, with milder colour fields around the luminance."""
    lum = torch.zeros((n, 1, h, w), device=device)
    col = torch.zeros((n, 2, h, w), device=device)
    for o in range(octaves):                 # coarsest first, the last at full size
        ch, cw = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        amp = 2.0 ** (-0.5 * slope * o)
        lum += amp * F.interpolate(torch.randn((n, 1, ch, cw), generator=g, device=device),
                                   size=(h, w), mode="bilinear", align_corners=False)
        if o < 4:
            col += 0.5 * amp * F.interpolate(
                torch.randn((n, 2, ch, cw), generator=g, device=device),
                size=(h, w), mode="bilinear", align_corners=False)
    coarse = F.interpolate(torch.randn((n, 1, max(2, h >> 5), max(2, w >> 5)), generator=g,
                                       device=device),
                           size=(h, w), mode="bilinear", align_corners=False)
    lum = lum / lum.std(dim=(-2, -1), keepdim=True) * 0.16 + edges * 0.5 * torch.sign(coarse)
    lum = lum + 0.5
    # an opponent-colour basis: R, G, B around the luminance
    r = lum + 0.10 * col[:, 0:1] + 0.05 * col[:, 1:2]
    gg = lum - 0.05 * col[:, 0:1]
    b = lum - 0.10 * col[:, 1:2] + 0.03 * col[:, 0:1]
    return torch.clamp(torch.cat([r, gg, b], dim=1), 0.0, 1.0)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# distortion operators on (n, 3, h, w) float32 in [0, 1], one strength per row
# ---------------------------------------------------------------------------

def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _gauss_taps(sigma: float) -> List[float]:
    r = max(1, int(math.ceil(3.0 * sigma)))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    return list(k / k.sum())


def _filter_axis(x: torch.Tensor, taps: Sequence[float], axis: int) -> torch.Tensor:
    """Filter along ``axis`` (-1 or -2) by shifted sums, edges replicated."""
    r = len(taps) // 2
    pad = (r, r, 0, 0) if axis == -1 else (0, 0, r, r)
    xp = F.pad(x, pad, mode="replicate")
    n = x.shape[axis]
    return sum(t * xp.narrow(axis, i, n) for i, t in enumerate(taps))


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0:
        return x
    taps = _gauss_taps(sigma)
    return _filter_axis(_filter_axis(x, taps, -1), taps, -2)


def _per_row(x: torch.Tensor, params: Sequence[float], fn) -> torch.Tensor:
    """Apply ``fn(rows, value)`` to each run of rows with one strength."""
    out = torch.empty_like(x)
    for i, v in enumerate(params):
        out[i:i + 1] = fn(x[i:i + 1], float(v))
    return out


def _luma(x: torch.Tensor) -> torch.Tensor:
    return (0.2126 * x[:, 0:1] + 0.7152 * x[:, 1:2] + 0.0722 * x[:, 2:3])


def apply_op(op: str, x: torch.Tensor, params: Sequence[float], g: torch.Generator
             ) -> torch.Tensor:
    """Distortion ``op`` on the rows of x, row i at strength params[i]."""
    p = torch.as_tensor(np.asarray(params, np.float32), device=x.device)
    if op == "noise":                       # white noise, sigma per row
        return x + _col(p) * torch.randn(x.shape, generator=g, device=x.device)
    if op == "noise_luma":                  # the same noise on every channel
        n = torch.randn((x.shape[0], 1) + x.shape[2:], generator=g, device=x.device)
        return x + _col(p) * n
    if op == "noise_mult":                  # multiplicative noise
        return x * (1.0 + _col(p) * torch.randn(x.shape, generator=g, device=x.device))
    if op == "impulse":                     # salt and pepper, a share of pixels
        u = torch.rand((x.shape[0], 1) + x.shape[2:], generator=g, device=x.device)
        s = torch.rand(u.shape, generator=g, device=x.device)
        hit = u < _col(p)
        return torch.where(hit, (s > 0.5).to(x.dtype).expand_as(x), x)
    if op == "blur":
        return _per_row(x, params, blur)
    if op == "motion_blur":                 # horizontal box of the given length
        return _per_row(x, params, lambda r, v: _filter_axis(
            r, [1.0 / int(v)] * int(v) if int(v) % 2 else [1.0 / (int(v) + 1)] * (int(v) + 1), -1))
    if op == "chroma_blur":                 # colour bleeding, luminance kept
        def cb(r, v):
            y = _luma(r)
            return y + blur(r - y, v)
        return _per_row(x, params, cb)
    if op == "channel_shift":               # red shifted by v pixels
        def cs(r, v):
            out = r.clone()
            out[:, 0] = torch.roll(r[:, 0], shifts=int(v), dims=-1)
            return out
        return _per_row(x, params, cs)
    if op == "quantise":                    # v levels per channel
        return torch.round(x * (_col(p) - 1.0)) / (_col(p) - 1.0)
    if op == "pixelate":                    # v x v blocks of their mean
        def px(r, v):
            k = int(v)
            h, w = r.shape[-2:]
            m = F.avg_pool2d(r, k, ceil_mode=True)
            return m.repeat_interleave(k, dim=-2).repeat_interleave(k, dim=-1)[..., :h, :w]
        return _per_row(x, params, px)
    if op == "block_mix":                   # blocking: a mix towards 8x8 means
        h, w = x.shape[-2:]
        m = F.avg_pool2d(x, 8, ceil_mode=True)
        m = m.repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1)[..., :h, :w]
        return x + _col(p) * (m - x)
    if op == "brighten":                    # a gamma below 1
        return torch.clamp(x, 0.0, 1.0) ** (1.0 / (1.0 + _col(p)))
    if op == "darken":
        return torch.clamp(x, 0.0, 1.0) ** (1.0 + _col(p))
    if op == "mean_shift":
        return x + _col(p)
    if op == "contrast":                    # scaled about the image's mean
        m = x.mean(dim=(1, 2, 3), keepdim=True)
        return m + _col(p) * (x - m)
    if op == "saturation":                  # mixed towards (< 1) or away from the luma
        y = _luma(x)
        return y + _col(p) * (x - y)
    if op == "sharpen":                     # unsharp mask of a 1-pixel blur
        return x + _col(p) * (x - blur(x, 1.0))
    if op == "jitter":                      # each pixel from a random neighbour
        def jt(r, v):
            k = int(v)
            h, w = r.shape[-2:]
            dy = torch.randint(-k, k + 1, (h, w), generator=g, device=r.device)
            dx = torch.randint(-k, k + 1, (h, w), generator=g, device=r.device)
            yy = torch.clamp(torch.arange(h, device=r.device)[:, None] + dy, 0, h - 1)
            xx = torch.clamp(torch.arange(w, device=r.device)[None, :] + dx, 0, w - 1)
            return r[..., yy, xx]
        return _per_row(x, params, jt)
    raise ValueError(f"unknown distortion {op!r}")


def distort(x: torch.Tensor, ops: Sequence[Tuple[str, Sequence[float]]],
            g: torch.Generator) -> torch.Tensor:
    """x (n, 3, h, w) in [0, 1] through each (op, strengths) in turn."""
    for op, params in ops:
        x = apply_op(op, x, params, g)
    return torch.clamp(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the two kinds of content
# ---------------------------------------------------------------------------

def clip_pair(cfg: Dict, k: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair ``k`` of a clip configuration: (test, reference), each (3, F, H,
    W) uint8 sRGB on the device.  The reference pans over a textured
    canvas at the pair's speed; the test adds the pair's distortions, the
    noise drawn anew in every frame."""
    c = cfg["content"]
    H, W, n = cfg["height"], cfg["width"], cfg["frames"]
    vx, vy = c["pan_px_per_frame"][k]
    g = generator(device, sub_seed(seed, 1, k))
    canvas = texture(1, H + abs(vy) * n, W + abs(vx) * n, g, device)[0]
    ref = torch.empty((3, n, H, W), dtype=torch.uint8, device=device)
    test = torch.empty_like(ref)
    step = int(c.get("frames_per_chunk", 8))
    for a in range(0, n, step):
        b = min(n, a + step)
        frames = []
        for f in range(a, b):
            y0 = (abs(vy) * f) if vy >= 0 else abs(vy) * (n - f)
            x0 = (abs(vx) * f) if vx >= 0 else abs(vx) * (n - f)
            frames.append(canvas[:, y0:y0 + H, x0:x0 + W])
        fr = torch.stack(frames, dim=0)                            # (m, 3, H, W)
        m = b - a
        t = distort(fr, [(op, [v] * m) for op, v in c["distortions"][k]], g)
        ref[:, a:b] = to_uint8(fr).transpose(0, 1)
        test[:, a:b] = to_uint8(t).transpose(0, 1)
        del fr, t
    return test, ref


def image_refs(cfg: Dict, seed: int, device) -> torch.Tensor:
    """The configuration's reference images: (n_refs, H, W, 3) uint8."""
    n, H, W = cfg["references"], cfg["height"], cfg["width"]
    g = generator(device, sub_seed(seed, 2))
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    for a in range(0, n, 27):
        b = min(n, a + 27)
        out[a:b] = to_uint8(texture(b - a, H, W, g, device)).permute(0, 2, 3, 1)
    return out


def image_pairs(cfg: Dict, refs: torch.Tensor, rows: range, seed: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs ``rows`` of an image set, each pair p the reference p //
    (types * levels) under type (p // levels) % types at level p % levels:
    (test, reference), each (len(rows), H, W, 3) uint8 on refs' device.
    The draws of one reference's pairs come from a generator of their own,
    so any range of rows gives the same bytes as the whole set."""
    types = cfg["distortion_types"]
    n_lv = cfg["levels"]
    per_ref = len(types) * n_lv
    device = refs.device
    H, W = refs.shape[1:3]
    test = torch.empty((len(rows), H, W, 3), dtype=torch.uint8, device=device)
    ref = torch.empty_like(test)
    first = rows.start
    for r in range(rows.start // per_ref, -(-rows.stop // per_ref)):
        g = generator(device, sub_seed(seed, 3, r))
        base = refs[r].permute(2, 0, 1)[None].float() / 255.0           # (1, 3, H, W)
        for t, typ in enumerate(types):
            x = base.expand(n_lv, -1, -1, -1)
            y = distort(x, [(op, vals) for op, vals in typ["ops"]], g)
            p0 = r * per_ref + t * n_lv
            lo, hi = max(p0, rows.start), min(p0 + n_lv, rows.stop)
            if lo < hi:
                test[lo - first:hi - first] = to_uint8(y[lo - p0:hi - p0]).permute(0, 2, 3, 1)
                ref[lo - first:hi - first] = refs[r]
    return test, ref


def _gaze_base(cfg: Dict, spec: Dict, j: int) -> np.ndarray:
    """Path ``j`` of the traffic's fixed set: smooth pursuit at a speed
    drawn from ``spec["pursuit_px_per_frame"]`` in a random direction,
    broken by saccades to a random point every ``spec["saccade_every_frames"]``
    frames (drawn from that range), kept inside the frame's central
    ``spec["inside"]`` share."""
    rng = np.random.default_rng(sub_seed(spec["path_seed"], j))
    H, W, n = cfg["height"], cfg["width"], cfg["frames"]
    m = (1.0 - spec["inside"]) / 2.0
    lo, hi = np.array([m * W, m * H]), np.array([(1 - m) * W, (1 - m) * H])
    pos = rng.uniform(lo, hi)
    out = np.empty((n, 2), np.float32)
    nxt = rng.integers(*spec["saccade_every_frames"])
    speed = rng.uniform(*spec["pursuit_px_per_frame"])
    ang = rng.uniform(0, 2 * np.pi)
    for f in range(n):
        if f == nxt:
            pos = rng.uniform(lo, hi)
            speed = rng.uniform(*spec["pursuit_px_per_frame"])
            ang = rng.uniform(0, 2 * np.pi)
            nxt = f + rng.integers(*spec["saccade_every_frames"])
        pos = np.clip(pos + speed * np.array([np.cos(ang), np.sin(ang)]), lo, hi)
        out[f] = pos
    return out


def gaze_path(cfg: Dict, spec: Dict, k: int, seed: int) -> np.ndarray:
    """(F, 2) pixel coordinates of the gaze in each frame of clip ``k``.
    The paths are a fixed set of the traffic's (``spec["path_seed"]``);
    the run's seed deals them out to the clips and mirrors each about the
    frame's centre, which leaves every eccentricity, and so the work, as
    it is."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    n = int(cfg["pairs"])
    j = rng.permutation(n)[k]
    flip = rng.integers(0, 2, size=(n, 2))[k]
    g = _gaze_base(cfg, spec, int(j))
    size = np.array([cfg["width"], cfg["height"]], np.float32)
    return np.where(flip.astype(bool), size - 1.0 - g, g).astype(np.float32)
