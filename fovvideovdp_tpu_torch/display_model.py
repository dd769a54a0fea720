"""Display photometry (EOTF -> absolute luminance) and geometry
(pixels per degree).

Counterpart of ``fovvideovdp_tpu/display_model.py:32-235,238-386`` on
torch tensors, with ``print`` and ``list_displays`` (``:97-106,171,201,347``)
for the CLI's ``--display ?`` and ``--verbose``.
"""
from __future__ import annotations

import logging
import math
from abc import ABC, abstractmethod
from typing import Sequence

import torch

from fovvideovdp_tpu_torch import utils


# ---------------------------------------------------------------------------
# EOTFs
# ---------------------------------------------------------------------------

def srgb2lin(p: torch.Tensor) -> torch.Tensor:
    """sRGB display-encoded values (0..1) -> relative linear (0..1)."""
    return torch.where(p > 0.04045, ((p + 0.055) / 1.055) ** 2.4, p / 12.92)


_PQ = dict(Lmax=10000.0, n=0.15930175781250000, m=78.843750000000000,
           c1=0.83593750000000000, c2=18.851562500000000,
           c3=18.687500000000000)


def lin2pq(L: torch.Tensor) -> torch.Tensor:
    """Absolute luminance (cd/m^2) -> PQ-encoded values (0..1)."""
    k = _PQ
    im = torch.pow(utils.clip(L, 0.005, k["Lmax"]) / k["Lmax"], k["n"])
    return torch.pow((k["c2"] * im + k["c1"]) / (1 + k["c3"] * im), k["m"])


def pq2lin(V: torch.Tensor) -> torch.Tensor:
    """SMPTE ST 2084 (PQ) encoded values (0..1) -> absolute luminance (cd/m^2)."""
    k = _PQ
    im_t = torch.pow(utils.clip(V, 0.0), 1.0 / k["m"])
    return k["Lmax"] * torch.pow(utils.clip(im_t - k["c1"], 0.0)
                                 / (k["c2"] - k["c3"] * im_t), 1.0 / k["n"])


# ---------------------------------------------------------------------------
# Photometry
# ---------------------------------------------------------------------------

class fvvdp_display_photometry(ABC):
    """Maps display-encoded pixel values to absolute linear luminance."""

    @abstractmethod
    def forward(self, V: torch.Tensor) -> torch.Tensor:
        ...

    @abstractmethod
    def get_peak_luminance(self) -> float:
        ...

    @abstractmethod
    def get_black_level(self) -> float:
        ...

    def print(self):
        pass

    @classmethod
    def list_displays(cls):
        models = utils.json2dict(utils.config_files.find("display_models.json"))
        for display_name in models:
            cls.load(display_name).print()

    @classmethod
    def load(cls, display_name: str) -> "fvvdp_display_photo_eotf":
        models = utils.json2dict(utils.config_files.find("display_models.json"))
        if display_name not in models:
            raise RuntimeError(f'Unknown display model: "{display_name}"')
        model = models[display_name]

        Y_peak = model["max_luminance"]
        if "min_luminance" in model:
            contrast = Y_peak / model["min_luminance"]
        else:
            contrast = model.get("contrast", 500)
        obj = fvvdp_display_photo_eotf(
            Y_peak, contrast=contrast, gamma=model.get("gamma", 2.2),
            EOTF=model.get("EOTF", "sRGB"),
            E_ambient=model.get("E_ambient", 0),
            k_refl=model.get("k_refl", 0.005), name=display_name)
        obj.full_name = model.get("name", display_name)
        obj.short_name = display_name
        return obj


class fvvdp_display_photo_eotf(fvvdp_display_photometry):
    """Multi-EOTF display model (sRGB / gamma / PQ / linear)."""

    def __init__(self, Y_peak, contrast=1000, EOTF="sRGB", gamma=2.2,
                 E_ambient=0, k_refl=0.005, name=None):
        self.Y_peak = Y_peak
        self.contrast = contrast
        self.EOTF = EOTF
        self.gamma = gamma
        self.E_ambient = E_ambient
        self.k_refl = k_refl
        self.name = name

    def forward(self, V):
        if self.EOTF != "linear":
            V = utils.clip(V, 0.0, 1.0)
        Y_black = self.get_black_level()
        if self.EOTF == "sRGB":
            return (self.Y_peak - Y_black) * srgb2lin(V) + Y_black
        if self.EOTF == "gamma":
            return (self.Y_peak - Y_black) * torch.pow(V, self.gamma) + Y_black
        if self.EOTF == "PQ":
            return utils.clip(pq2lin(V), 0.005, self.Y_peak) + Y_black
        if self.EOTF == "linear":
            return utils.clip(V, 0.005, self.Y_peak) + Y_black
        raise RuntimeError(f"Unknown EOTF '{self.EOTF}'")

    def get_peak_luminance(self):
        return self.Y_peak

    def get_black_level(self):
        # reflected ambient light plus panel leakage
        Y_refl = self.E_ambient / math.pi * self.k_refl
        return Y_refl + self.Y_peak / self.contrast

    def print(self):
        Y_black = self.get_black_level()
        logging.info(f"Photometric display model: {self.name}")
        logging.info(f"  Peak luminance: {self.Y_peak} cd/m^2")
        logging.info(f"  EOTF: {self.EOTF}")
        logging.info(f"  Contrast - theoretical: {round(self.contrast)}:1")
        logging.info(f"  Contrast - effective: {round(self.Y_peak / Y_black)}:1")
        logging.info(f"  Ambient light: {self.E_ambient} lux")
        logging.info(f"  Display reflectivity: {self.k_refl * 100}%")


class fvvdp_display_photo_absolute(fvvdp_display_photometry):
    """For content already scaled in absolute cd/m^2 (e.g. HDR images)."""

    def __init__(self, L_max=10000, L_min=0.005):
        self.L_max = L_max
        self.L_min = L_min

    def forward(self, V):
        return utils.clip(V, self.L_min, self.L_max)

    def get_peak_luminance(self):
        return self.L_max

    def get_black_level(self):
        return self.L_min

    def print(self):
        logging.info("Photometric display model:")
        logging.info("  Absolute photometric/colorimetric values")


class fvvdp_display_photo_gog(fvvdp_display_photometry):
    """Gain-gamma-offset model (deprecated; gamma == -1 selects sRGB)."""

    def __init__(self, Y_peak, contrast=1000, gamma=2.2, E_ambient=0,
                 k_refl=0.005, name=None):
        self.Y_peak = Y_peak
        self.contrast = contrast
        self.gamma = gamma
        self.E_ambient = E_ambient
        self.k_refl = k_refl
        self.name = name

    def forward(self, V):
        V = utils.clip(V, 0.0, 1.0)
        Y_black = self.get_black_level()
        if self.gamma == -1:
            return (self.Y_peak - Y_black) * srgb2lin(V) + Y_black
        return (self.Y_peak - Y_black) * torch.pow(V, self.gamma) + Y_black

    def get_peak_luminance(self):
        return self.Y_peak

    def get_black_level(self):
        Y_refl = self.E_ambient / math.pi * self.k_refl
        return Y_refl + self.Y_peak / self.contrast


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

class fvvdp_display_geometry:
    """Screen size, viewing distance or field of view -> pixels per degree
    and the off-axis resolution magnification."""

    def __init__(self, resolution: Sequence[int], distance_m=None,
                 distance_display_heights=None, fov_horizontal=None,
                 fov_vertical=None, fov_diagonal=None,
                 diagonal_size_inches=None, pix_per_deg=None):
        self.resolution = tuple(resolution)
        ar = resolution[0] / resolution[1]  # width / height
        self.fixed_ppd = pix_per_deg

        if pix_per_deg is not None:
            self.ppd_centre = pix_per_deg
            self.distance_m = distance_m if distance_m is not None else 3.0
            width_deg = (1.0 / pix_per_deg) * resolution[0]
            width_m = 2 * math.tan(math.radians(width_deg / 2)) * self.distance_m
            self.display_size_m = (width_m, width_m / ar)
            self.display_size_deg = (width_deg, width_deg / ar)
            return

        if diagonal_size_inches is not None:
            height_mm = math.sqrt((diagonal_size_inches * 25.4) ** 2 / (1 + ar ** 2))
            self.display_size_m = (ar * height_mm / 1000, height_mm / 1000)

        if distance_m is not None and distance_display_heights is not None:
            raise RuntimeError("You can pass only one of: distance_m, distance_display_heights.")

        if distance_m is not None:
            self.distance_m = distance_m
        elif distance_display_heights is not None:
            if not hasattr(self, "display_size_m"):
                raise RuntimeError(
                    "You need to specify display diagonal size 'diagonal_size_inches' "
                    "to specify viewing distance as 'distance_display_heights'")
            self.distance_m = distance_display_heights * self.display_size_m[1]
        elif fov_horizontal is not None or fov_vertical is not None or fov_diagonal is not None:
            self.distance_m = 3  # default viewing distance for VR headsets
        else:
            raise RuntimeError(
                "Viewing distance must be specified as 'distance_m' or 'distance_display_heights'.")

        n_fov = sum(x is not None for x in (fov_horizontal, fov_vertical, fov_diagonal))
        if n_fov > 1:
            raise RuntimeError(
                "You can pass only one of 'fov_horizontal', 'fov_vertical', 'fov_diagonal'.")

        if fov_horizontal is not None:
            width_m = 2 * math.tan(math.radians(fov_horizontal / 2)) * self.distance_m
            self.display_size_m = (width_m, width_m / ar)
        elif fov_vertical is not None:
            height_m = 2 * math.tan(math.radians(fov_vertical / 2)) * self.distance_m
            self.display_size_m = (height_m * ar, height_m)
        elif fov_diagonal is not None:
            # work on distances, not degrees (Pythagoras does not hold on angles)
            distance_px = math.sqrt(resolution[0] ** 2 + resolution[1] ** 2) \
                / (2.0 * math.tan(math.radians(fov_diagonal * 0.5)))
            height_deg = math.degrees(math.atan(resolution[1] / 2 / distance_px)) * 2
            height_m = 2 * math.tan(math.radians(height_deg / 2)) * self.distance_m
            self.display_size_m = (height_m * ar, height_m)

        self.display_size_deg = (
            2 * math.degrees(math.atan(self.display_size_m[0] / (2 * self.distance_m))),
            2 * math.degrees(math.atan(self.display_size_m[1] / (2 * self.distance_m))))

        # ppd of the central pixel
        self.ppd_centre = 1 / (2 * math.degrees(
            math.atan(0.5 * self.display_size_m[0] / self.resolution[0] / self.distance_m)))

    def get_ppd(self, view_dir=None):
        """Pixels per degree: the scalar at the centre of the screen, or a
        map for ``view_dir`` (2, H, W), a tensor of view directions in
        degrees (centre origin, y up)."""
        if view_dir is None:
            return self.ppd_centre
        if self.fixed_ppd is not None:
            return torch.full(view_dir.shape[-2:], float(self.fixed_ppd),
                              dtype=torch.float32, device=view_dir.device)
        view_angle = torch.sqrt(torch.sum(view_dir ** 2, dim=0))
        view_angle = torch.clamp(view_angle, max=89.9)  # avoid the tan singularity
        delta = (1.0 / self.ppd_centre) / 2
        tan_delta = math.tan(math.radians(delta))
        tan_a = torch.tan(torch.deg2rad(view_angle))
        return self.ppd_centre * (torch.tan(torch.deg2rad(view_angle + delta)) - tan_a) \
            / tan_delta

    def pix2view_direction(self, resolution_pix, x_pix: torch.Tensor,
                           y_pix: torch.Tensor) -> torch.Tensor:
        """Pixel coordinates (tensors) -> view direction in degrees (2, ...).
        ``resolution_pix`` is (width, height) of the (sub-band) image the
        coordinates refer to; the top-left pixel is (0, 0)."""
        res_w, res_h = float(resolution_pix[0]), float(resolution_pix[1])
        x_m = (x_pix - res_w / 2) * self.display_size_m[0] / res_w
        y_m = -(y_pix - res_h / 2) * self.display_size_m[1] / res_h
        return torch.stack((torch.rad2deg(torch.atan(x_m / self.distance_m)),
                            torch.rad2deg(torch.atan(y_m / self.distance_m))), dim=0)

    def get_resolution_magnification(self, view_dir: torch.Tensor) -> torch.Tensor:
        """Relative resolution magnification at the given view directions."""
        if self.fixed_ppd is not None:
            return torch.ones(view_dir.shape[-2:], dtype=torch.float32,
                              device=view_dir.device)
        return self.get_ppd(view_dir) / self.get_ppd()

    def print(self):
        logging.info("Geometric display model:")
        if self.fixed_ppd is not None:
            logging.info(f"  Fixed pixels-per-degree: {self.fixed_ppd}")
            return
        logging.info(f"  Resolution: {self.resolution[0]} x {self.resolution[1]} pixels")
        logging.info("  Display size: {:.1f} x {:.1f} cm".format(
            self.display_size_m[0] * 100, self.display_size_m[1] * 100))
        logging.info("  Display size: {:.2f} x {:.2f} deg".format(*self.display_size_deg))
        logging.info("  Viewing distance: {:.3f} m".format(self.distance_m))
        logging.info("  Pixels-per-degree (center): {:.2f}".format(self.get_ppd()))

    @classmethod
    def load(cls, display_name: str) -> "fvvdp_display_geometry":
        models = utils.json2dict(utils.config_files.find("display_models.json"))
        if display_name not in models:
            raise RuntimeError(
                f"Error: Display model '{display_name}' not found in display_models.json")
        model = models[display_name]
        if "resolution" not in model:
            raise RuntimeError(f"Display model '{display_name}' has no resolution")
        inches_to_meters = 0.0254
        W, H = model["resolution"]

        if "viewing_distance_meters" in model:
            distance_m = model["viewing_distance_meters"]
        elif "viewing_distance_inches" in model:
            distance_m = model["viewing_distance_inches"] * inches_to_meters
        else:
            distance_m = None
        if "diagonal_size_meters" in model:
            diag_inch = model["diagonal_size_meters"] / inches_to_meters
        elif "diagonal_size_inches" in model:
            diag_inch = model["diagonal_size_inches"]
        else:
            diag_inch = None

        return cls((W, H), distance_m=distance_m,
                   fov_diagonal=model.get("fov_diagonal"),
                   diagonal_size_inches=diag_inch)
