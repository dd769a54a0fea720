"""Content geometry mappings for non-flat content: 360 equirectangular video.

Counterpart of ``fovvideovdp_tpu/content_mapping.py`` (after
matlab/fvvdp_content_mapping.m:12-28): the angular distance (eccentricity,
degrees) between every pixel of an equirectangular frame and a gaze
position, on the sphere.  Used with ``fvvdp(..., foveated=True)`` through
its ``content_mapping`` argument.
"""
from __future__ import annotations

import math

import torch


class fvvdp_content_mapping_equirect:
    """Equirectangular 360 content: pixel -> direction on the unit sphere."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    def _angles(self, x_pix, y_pix, resolution_pix):
        """Pixel coordinates -> (azimuth, elevation) in radians."""
        res_w, res_h = float(resolution_pix[0]), float(resolution_pix[1])
        azimuth = (x_pix / res_w - 0.5) * 2.0 * math.pi
        elevation = (0.5 - y_pix / res_h) * math.pi
        return azimuth, elevation

    def eccentricity(self, resolution_pix, x_pix, y_pix, gaze_x, gaze_y):
        """Angular distance (degrees) between each pixel and the gaze point.

        ``resolution_pix`` is (width, height) of the (sub-band) image; the
        gaze coordinates are in full-frame pixels.  Tensors broadcast: pixel
        maps (h, w) against gazes (F, 1, 1) give (F, h, w)."""
        az, el = self._angles(x_pix, y_pix, resolution_pix)
        g_az, g_el = self._angles(gaze_x, gaze_y, (self.width, self.height))
        # great-circle distance
        cos_d = (torch.sin(el) * torch.sin(g_el)
                 + torch.cos(el) * torch.cos(g_el) * torch.cos(az - g_az))
        return torch.rad2deg(torch.arccos(torch.clamp(cos_d, -1.0, 1.0)))
