"""FovVideoVDP in plain PyTorch: the benchmark's reference.

A straightforward composition of the metric (Mantiuk et al., "FovVideoVDP:
a visible difference predictor for wide field-of-view video", SIGGRAPH
2021; pyfvvdp/fvvdp.py of the published implementation), written from the
model's equations with no kernels, no streaming carry and no batching
tricks.  It imports torch, numpy and the standard library only: nothing of
the program under test.  It reads its display, colour and calibration
constants from the configuration file it is given, and its CSF lookup
tables from the copies in ``data/`` beside this file.

Per frame pair: display-encoded RGB -> absolute luminance (sRGB EOTF with
peak, black level and ambient reflection; RGB -> Y); the sustained and
transient temporal channels (causal filters over the clip padded by
repeating its first frame); a Laplacian pyramid (Burt-Adelson kernel,
a = 0.4, symmetric row and zero-plus-correction column edges as the
published code has them); Weber contrast against the expanded next level
of the reference's sustained channel (clamped to >= 0.1 cd/m^2); the CSF
by trilinear interpolation in (log2 rho, log2 L, sqrt ecc) with the
published interpolator's cell search; the calibrated mutual masking;
Minkowski pooling over pixels, bands, channels and frames, and the JOD
regression.  Foveated: the eccentricity of each pixel from the frame's
gaze and the resolution magnification off the screen's centre.

Everything runs in ``dtype`` (float32 for the reference; the control runs
it in bfloat16).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_LUT_FIELDS = ("Y", "rho", "ecc", "Y_log", "rho_log", "ecc_sqrt", "S_log")
# Burt-Adelson generating kernel, a = 0.4
_K5 = [float(k) for k in np.array([0.05, 0.25, 0.4, 0.25, 0.05], dtype=np.float32)]


def load_lut(omega: float, csf_sigma: float, k_cm: float, device) -> Dict[str, torch.Tensor]:
    """The CSF lookup table of temporal frequency ``omega`` (float32 host
    arrays from ``data/``) as tensors on ``device``."""
    key = ("o%g_s%g_cm%f" % (omega, csf_sigma, k_cm)).replace("-", "n").replace(".", "_")
    with np.load(os.path.join(_DATA, f"csf_lut_{key}.npz")) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
                for k in _LUT_FIELDS}


# ---------------------------------------------------------------------------
# display
# ---------------------------------------------------------------------------

class Display:
    """Photometry and geometry of the configuration's display."""

    def __init__(self, photometry: Dict, geometry: Dict):
        self.Y_peak = float(photometry["max_luminance"])
        contrast = float(photometry["contrast"])
        E_amb = float(photometry.get("E_ambient", 0.0))
        k_refl = float(photometry.get("k_refl", 0.005))
        if photometry.get("EOTF", "sRGB") != "sRGB":
            raise ValueError("the reference implements the sRGB EOTF only")
        self.Y_black = E_amb / math.pi * k_refl + self.Y_peak / contrast
        W, H = geometry["resolution"]
        ar = W / H
        diag_m = geometry["diagonal_size_inches"] * 0.0254
        height_m = math.sqrt(diag_m ** 2 / (1 + ar ** 2))
        self.size_m = (ar * height_m, height_m)
        self.distance_m = float(geometry["viewing_distance_meters"])
        self.resolution = (W, H)
        self.ppd = 1 / (2 * math.degrees(math.atan(0.5 * self.size_m[0] / W / self.distance_m)))

    def luminance(self, v: torch.Tensor) -> torch.Tensor:
        """Display-encoded values in [0, 1] -> absolute luminance (cd/m^2)."""
        v = torch.clamp(v, 0.0, 1.0)
        lin = torch.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)
        return (self.Y_peak - self.Y_black) * lin + self.Y_black

    def view_direction(self, res_wh, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Pixel coordinates of an image of ``res_wh`` pixels -> view
        directions in degrees (2, ...), origin at the screen's centre, y up."""
        w, h = float(res_wh[0]), float(res_wh[1])
        x_m = (x - w / 2) * self.size_m[0] / w
        y_m = -(y - h / 2) * self.size_m[1] / h
        return torch.stack((torch.rad2deg(torch.atan(x_m / self.distance_m)),
                            torch.rad2deg(torch.atan(y_m / self.distance_m))), dim=0)

    def resolution_magnification(self, view_dir: torch.Tensor) -> torch.Tensor:
        """Pixels per degree at ``view_dir`` over those at the centre."""
        angle = torch.clamp(torch.sqrt(torch.sum(view_dir ** 2, dim=0)), max=89.9)
        delta = (1.0 / self.ppd) / 2
        tan_a = torch.tan(torch.deg2rad(angle))
        ppd = self.ppd * (torch.tan(torch.deg2rad(angle + delta)) - tan_a) \
            / math.tan(math.radians(delta))
        return ppd / self.ppd


# ---------------------------------------------------------------------------
# temporal channels
# ---------------------------------------------------------------------------

def temporal_filters(fps: float, sustained_sigma: float, sustained_beta: float) -> np.ndarray:
    """(2, fl): the sustained (log-Gaussian, sum 1) and transient (its
    scaled derivative) filters over 250 ms; t spans [0, fl/fps] over fl
    points, as in the published code."""
    fl = max(2, int(np.ceil(250.0 / (1000.0 / fps))))
    t = np.linspace(0.0, fl / fps, fl)
    F = np.zeros((2, fl))
    F[0] = np.exp(-(np.log(t + 1e-4) - np.log(sustained_beta)) ** 2 / (2.0 * sustained_sigma ** 2))
    F[0] = F[0] / np.sum(F[0])
    F[1] = 0.062170507756932 * np.concatenate([(F[0, 1:] - F[0, :-1]) / (t[1] - t[0]), [0.0]])
    return F.astype(np.float32)


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def reduce_level(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)): 5-tap filter and stride 2,
    rows with symmetric edges, columns with zero padding and the published
    code's edge corrections (chosen by the parity of the row count)."""
    H, W = x.shape[-2:]
    Ho, Wo = _ceildiv(H, 2), _ceildiv(W, 2)
    xp = torch.cat([x[..., 1:2, :], x[..., 0:1, :], x,
                    x[..., H - 1:H, :], x[..., H - 2:H - 1, :]], dim=-2)
    y = sum(_K5[k] * xp[..., k:k + 2 * Ho - 1:2, :] for k in range(5))
    yp = torch.nn.functional.pad(y, (2, 2))
    z = sum(_K5[k] * yp[..., k:k + 2 * Wo - 1:2] for k in range(5))
    z[..., 0] += y[..., 0] * _K5[1] + y[..., 1] * _K5[0]
    if H % 2 == 1:
        z[..., -1] += y[..., -1] * _K5[3] + y[..., -2] * _K5[4]
    else:
        z[..., -1] += y[..., -1] * _K5[4]
    return z


def _expand_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Upsample by 2 along ``axis`` to length n: zero interleave with the
    published boundary fill, then a valid 5-tap filter of gain 2."""
    x = torch.movedim(x, axis, -1)
    z = torch.zeros(x.shape[:-1] + (n + 4,), dtype=x.dtype, device=x.device)
    z[..., 2:-2:2] = x
    z[..., 0] = x[..., 0]
    z[..., -2 + n % 2] = x[..., -1]
    y = sum(float(np.float32(2.0 * _K5[k])) * z[..., k:k + n] for k in range(5))
    return torch.movedim(y, -1, axis)


def expand_level(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return _expand_axis(_expand_axis(x, size[0], -2), size[1], -1)


class Pyramid:
    """Scored levels and band frequencies for an H x W image at ``ppd``."""

    def __init__(self, W: int, H: int, ppd: float):
        max_levels = int(np.floor(np.log2(min(H, W)))) - 1
        bands = np.concatenate([[1.0], np.power(2.0, -np.arange(0.0, 14.0)) * 0.3228]) * ppd / 2.0
        invalid = np.nonzero(bands <= 0.5)[0]
        max_band = invalid[0] if invalid.size > 0 else max_levels
        self.height = int(np.clip(max_band + 1, 0, max_levels))
        self.freqs = np.array([1.0] + [0.3228 * 2.0 ** (-f) for f in range(self.height)]) * ppd / 2.0
        self.shapes = [(H, W)]
        for _ in range(self.height):
            self.shapes.append((_ceildiv(self.shapes[-1][0], 2), _ceildiv(self.shapes[-1][1], 2)))

    def gain(self, bb: int) -> float:
        """Interior bands of the Laplacian pyramid (height + 1 bands with
        the base) carry a gain of 2."""
        return 1.0 if bb == 0 or bb == self.height else 2.0


# ---------------------------------------------------------------------------
# CSF
# ---------------------------------------------------------------------------

def _cell(q: torch.Tensor, grid: torch.Tensor):
    """Knots and fraction of q on an ascending grid, as the published
    interpolator finds them: the upper knot is the first >= q, the ends
    clamped, a 1e-6 in the denominator, a fraction below 0 made 0."""
    n = grid.shape[0]
    hi = torch.clamp(torch.searchsorted(grid.contiguous(), q.contiguous()), max=n - 1)
    lo = torch.clamp(hi - 1, 0, n - 1)
    f = (q - grid[lo]) / (grid[hi] - grid[lo] + 1e-6)
    f = torch.where((hi == lo) | (f < 0.0), torch.zeros_like(f), f)
    return lo, hi, f


def sensitivity(lut: Dict[str, torch.Tensor], rho: torch.Tensor, L: torch.Tensor,
                ecc: torch.Tensor) -> torch.Tensor:
    """S(rho, L, ecc) by trilinear interpolation of the LUT's log2 S in
    (log2 rho, log2 L, sqrt ecc); rho and ecc broadcast against L."""
    V = lut["S_log"]                      # [Y, rho, ecc]
    n_y, n_r, n_e = V.shape
    flat = V.reshape(-1)
    r0, r1, fr = _cell(torch.log2(torch.clamp(rho, lut["rho"][0], lut["rho"][-1])),
                       lut["rho_log"])
    y0, y1, fy = _cell(torch.log2(torch.clamp(L, lut["Y"][0], lut["Y"][-1])), lut["Y_log"])
    e0, e1, fe = _cell(torch.sqrt(torch.clamp(ecc, lut["ecc"][0], lut["ecc"][-1])),
                       lut["ecc_sqrt"])
    s = torch.zeros_like(L)
    for iy, wy in ((y0, 1.0 - fy), (y1, fy)):
        for ir, wr in ((r0, 1.0 - fr), (r1, fr)):
            for ie, we in ((e0, 1.0 - fe), (e1, fe)):
                s = s + wy * wr * we * flat[(iy * n_r + ir) * n_e + ie]
    return torch.exp2(s)


# ---------------------------------------------------------------------------
# the metric
# ---------------------------------------------------------------------------

class PlainFvvdp:
    """The metric of one configuration on ``device``, in ``dtype``.

    ``config``: the benchmark configuration's dict, with ``display``
    (``photometry``, ``geometry``), ``rgb2y`` and ``metric_parameters``."""

    def __init__(self, config: Dict, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        disp = config["display"]
        self.display = Display(disp["photometry"], disp["geometry"])
        self.rgb2y = [float(c) for c in config["rgb2y"]]
        self.p = dict(config["metric_parameters"])
        p = self.p
        self.luts = [{k: v.to(dtype) for k, v in
                      load_lut(o, p["csf_sigma"], p["k_cm"], self.device).items()}
                     for o in (0.0, 5.0)]
        self.sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
        self.q = (p["mask_q_sust"], p["mask_q_trans"])

    # -- input -----------------------------------------------------------
    def _lum(self, rgb: torch.Tensor, axis: int) -> torch.Tensor:
        """uint8 sRGB with its colour channels on ``axis`` -> luminance."""
        ch = [self.display.luminance(c.to(self.dtype) / 255.0)
              for c in torch.unbind(rgb, dim=axis)]
        return ch[0] * self.rgb2y[0] + ch[1] * self.rgb2y[1] + ch[2] * self.rgb2y[2]

    # -- scoring of a stack of channel responses ---------------------------
    def _band_q(self, R: torch.Tensor, pyr: Pyramid, n_ch: int,
                gaze_dir: Optional[torch.Tensor]) -> torch.Tensor:
        """R (F, 2 * n_ch, H, W), channels [T, R] per temporal channel ->
        Q (height, n_ch, F): per band and channel the normalised
        Minkowski norm of the masked differences."""
        p = self.p
        g = [R]
        for _ in range(pyr.height):
            g.append(reduce_level(g[-1]))
        out = []
        for bb in range(pyr.height):
            h, w = pyr.shapes[bb]
            ex = expand_level(g[bb + 1], (h, w))
            L = torch.clamp(ex[:, 1], min=0.1)                       # (F, h, w)
            C = torch.clamp((g[bb] - ex) / L[:, None], max=1000.0) * pyr.gain(bb)
            del ex
            if gaze_dir is None:
                rho = torch.tensor(float(pyr.freqs[bb]), dtype=self.dtype, device=self.device)
                ecc = torch.zeros((), dtype=self.dtype, device=self.device)
            else:
                xs = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=self.device)
                ys = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=self.device)
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                vd = self.display.view_direction((w, h), xx, yy)                 # (2, h, w)
                rho = (float(pyr.freqs[bb]) * self.display.resolution_magnification(vd)
                       ).to(self.dtype)
                ecc = torch.sqrt((vd[0] - gaze_dir[:, 0, None, None]) ** 2
                                 + (vd[1] - gaze_dir[:, 1, None, None]) ** 2).to(self.dtype)
            qs = []
            for cc in range(n_ch):
                N = 1.0 / (sensitivity(self.luts[cc], rho, L, ecc) * self.sens_corr)
                T, Rf = C[:, 2 * cc] / N, C[:, 2 * cc + 1] / N
                M = (10.0 ** p["mask_c"]) * torch.minimum(torch.abs(T), torch.abs(Rf))
                D = torch.clamp(torch.pow(torch.abs(T - Rf), p["mask_p"])
                                / (1.0 + torch.pow(M, self.q[cc])), max=1e4)
                s = torch.sum(torch.pow(D, p["beta"]), dim=(-2, -1))         # (F,)
                qs.append(torch.pow(s, 1.0 / p["beta"]) / (float(h * w) ** (1.0 / p["beta"])))
            out.append(torch.stack(qs, dim=0))
        return torch.stack(out, dim=0)

    def pool(self, Q: torch.Tensor) -> torch.Tensor:
        """Q (n_bands, 2, ..., F) -> JOD (...): Minkowski pooling over bands,
        then channels (the transient weighted), then the mean over frames,
        and the JOD regression."""
        p = self.p
        Q = Q.to(torch.float64) if self.dtype == torch.float32 else Q
        w = torch.tensor([1.0, p["w_transient"]], dtype=Q.dtype, device=Q.device)
        w = w.reshape((1, 2) + (1,) * (Q.dim() - 2))

        def norm(x, beta, dim, mean):
            s = torch.sum(torch.abs(x) ** beta, dim=dim, keepdim=True)
            return s ** (1.0 / beta) / ((x.shape[dim] if mean else 1.0) ** (1.0 / beta))

        q = norm(norm(norm(Q * w, p["beta_sch"], 0, False), p["beta_tch"], 1, False),
                 p["beta_t"], -1, True)
        q = q.reshape(Q.shape[2:-1])
        beta_jod = 10.0 ** p["log_jod_exp"]
        sign = 1.0 if p["jod_a"] >= 0 else -1.0
        return sign * (abs(p["jod_a"]) ** (1.0 / beta_jod) * q) ** beta_jod + 10.0

    # -- entry points ------------------------------------------------------
    def score_clip(self, test: torch.Tensor, ref: torch.Tensor, fps: float,
                   gaze: Optional[np.ndarray] = None, block: int = 8
                   ) -> Tuple[float, np.ndarray]:
        """(JOD, Q_per_ch (n_bands, 2, F)) of a clip pair, each (3, F, H, W)
        uint8 sRGB on the device; ``gaze``: (F, 2) pixel coordinates of the
        gaze in each frame (foveated), or None.  ``block`` output frames are
        scored at a time, each from its own padded window."""
        _, F, H, W = test.shape
        pyr = Pyramid(W, H, self.display.ppd)
        taps = temporal_filters(fps, self.p["sustained_sigma"], self.p["sustained_beta"])
        fl = taps.shape[1]
        gaze_dir = None
        if gaze is not None:
            g = torch.as_tensor(np.asarray(gaze, np.float32), device=self.device)
            gaze_dir = self.display.view_direction((W, H), g[:, 0] + 0.5, g[:, 1] + 0.5).T
        pad = np.asarray([0] * (fl - 1) + list(range(F)))      # frame 0 repeated
        Q = []
        for a in range(0, F, block):
            b = min(F, a + block)
            idx = torch.as_tensor(pad[a:b + fl - 1], device=self.device)
            lt = self._lum(test.index_select(1, idx), 0)            # (n + fl - 1, H, W)
            lr = self._lum(ref.index_select(1, idx), 0)
            R = torch.zeros((b - a, 4, H, W), dtype=self.dtype, device=self.device)
            for c in range(2):
                for j in range(fl):
                    wgt = float(taps[c, j])
                    if wgt != 0.0:
                        R[:, 2 * c] += wgt * lt[fl - 1 - j:fl - 1 - j + b - a]
                        R[:, 2 * c + 1] += wgt * lr[fl - 1 - j:fl - 1 - j + b - a]
            del lt, lr
            Q.append(self._band_q(R, pyr, 2, None if gaze_dir is None else gaze_dir[a:b]))
            del R
        Q = torch.cat(Q, dim=-1)
        return float(self.pool(Q)), Q.float().cpu().numpy()

    def score_images(self, test: torch.Tensor, ref: torch.Tensor, chunk: int = 512
                     ) -> np.ndarray:
        """JODs (N,) of image pairs, each (N, H, W, 3) uint8 sRGB on the
        device, ``chunk`` pairs at a time.  An image has no transient
        channel: its row of Q is 0."""
        N, H, W, _ = test.shape
        pyr = Pyramid(W, H, self.display.ppd)
        out = []
        for a in range(0, N, chunk):
            b = min(N, a + chunk)
            R = torch.stack([self._lum(test[a:b], -1), self._lum(ref[a:b], -1)], dim=1)
            q = self._band_q(R, pyr, 1, None)                      # (height, 1, n)
            Q = torch.cat([q, torch.zeros_like(q)], dim=1)[..., None]   # (height, 2, n, 1)
            out.append(self.pool(Q).float().cpu())
            del R
        return torch.cat(out).numpy().astype(np.float64)
