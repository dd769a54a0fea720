"""FovVideoVDP on PyTorch and CUDA (NVIDIA Hopper).

A port of ``fovvideovdp_tpu`` (JAX/Pallas on TPU), which stays the
reference.  This package imports torch and numpy only.  It scores images
and videos on a CUDA card through hand-written kernels (``ops/cuda``,
sources in ``csrc/``): the default configuration, foveation with a fixed or
a per-frame gaze, heatmaps and per-channel CSF LUTs.  ``device="cpu"`` runs the kernels' plain
PyTorch versions instead.
"""
from fovvideovdp_tpu_torch.display_model import (
    fvvdp_display_geometry,
    fvvdp_display_photo_absolute,
    fvvdp_display_photo_eotf,
    fvvdp_display_photo_gog,
    fvvdp_display_photometry,
)
from fovvideovdp_tpu_torch.fvvdp import fvvdp
from fovvideovdp_tpu_torch.video_source import (
    fvvdp_video_source,
    fvvdp_video_source_array,
)
from fovvideovdp_tpu_torch.visualize import vis_tonemap, visualize_diff_map

__version__ = "0.1.0"

__all__ = [
    "fvvdp",
    "fvvdp_display_photometry",
    "fvvdp_display_photo_eotf",
    "fvvdp_display_photo_absolute",
    "fvvdp_display_photo_gog",
    "fvvdp_display_geometry",
    "fvvdp_video_source",
    "fvvdp_video_source_array",
    "visualize_diff_map",
    "vis_tonemap",
]
