"""PU21-PSNR: the second metric behind the same interface.

Counterpart of ``fovvideovdp_tpu/pupsnr.py``.  Each block of frames is
PU21-encoded and scored on the device (per-frame PSNR in float32, no padded
tail block); the per-frame values come to the host once, where their mean
is taken in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from fovvideovdp_tpu_torch.utils import PU
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array, resolve_device

# frames per block
_BLOCK_FRAMES = 16


class pu_psnr:
    """PSNR of PU21-encoded luminance, in dB, averaged over frames."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.pu = PU()
        self.display_photometry = "sdr_4k_30"
        self.color_space = "sRGB"

    def _block_psnr(self, T: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        """(n, H, W) luminance blocks -> (n,) per-frame PU21-PSNR."""
        mse = torch.mean((self.pu.encode(T) - self.pu.encode(R)) ** 2, dim=(-2, -1))
        return 20.0 * torch.log10(self.pu.peak / torch.sqrt(mse))

    @torch.no_grad()
    def predict(self, test_cont, reference_cont, dim_order="BCFHW",
                frames_per_second=0, fixation_point=None, frame_padding="replicate"):
        vs = fvvdp_video_source_array(
            test_cont, reference_cont, frames_per_second, dim_order=dim_order,
            display_photometry=self.display_photometry,
            color_space_name=self.color_space, device=self.device)
        return self.predict_video_source(vs, fixation_point=fixation_point,
                                         frame_padding=frame_padding)

    @torch.no_grad()
    def predict_video_source(self, vid_source, fixation_point=None,
                             frame_padding="replicate"):
        """(mean PU21-PSNR over frames in dB, None)."""
        _, _, N_frames = vid_source.get_video_size()
        blocks = []
        for pos in range(0, N_frames, _BLOCK_FRAMES):
            b = min(_BLOCK_FRAMES, N_frames - pos)
            T, R = vid_source.get_luminance_block(pos, b)
            blocks.append(self._block_psnr(T.to(self.device, torch.float32),
                                           R.to(self.device, torch.float32)))
        frame_psnrs = torch.cat(blocks).cpu().numpy().astype(np.float64)
        return float(frame_psnrs.mean()), None

    def short_name(self):
        return "PU21-PSNR"

    def quality_unit(self):
        return "dB"

    def get_info_string(self):
        return None
