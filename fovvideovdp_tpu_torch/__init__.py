"""FovVideoVDP on PyTorch and CUDA (NVIDIA Hopper).

A port of ``fovvideovdp_tpu`` (JAX/Pallas on TPU), which stays the
reference.  This package imports torch and numpy only.  It scores images
and videos on a CUDA card through hand-written kernels (``ops/cuda``,
sources in ``csrc/``): the default configuration, foveation with a fixed or
a per-frame gaze, heatmaps and per-channel CSF LUTs.  ``device="cpu"``
runs the kernels' plain PyTorch versions instead.  ``fvvdp.predict_traced``,
``fvvdp.loss`` and ``fvvdp_torch_loss`` make the metric a differentiable
training loss, each kernel behind a ``torch.autograd.Function``.  The MATLAB
core's ablations and options (``local_adapt``, log contrast, the masking
ablations, ``pu_dilate``, ``ignore_boundary_pixels``, ``band_callback``, the
360° ``fvvdp_content_mapping_equirect``) score on the composed route, and a
CSF LUT comes from the packaged ``.npz`` files, a user ``.mat`` cache or the
analytic generator, in that order.  Files are read by
``fvvdp_video_source_file`` (images, raw ``.yuv``, videos through ffmpeg or
OpenCV) and scored from the command line by ``fvvdp-torch``
(``python -m fovvideovdp_tpu_torch.run_fvvdp``); raw Y'CbCr frames already
in memory go through ``fvvdp_video_source_yuv_array``.  A streamed video can be
checkpointed and resumed (``predict_video_source(checkpoint_path=...)``).
``parallel`` scores over several cards (``predict(mesh=make_mesh())``,
``predict_batch(mesh=...)``, ``fvvdp-torch --all-devices``) and several
processes (``parallel.init_multihost``, through ``torch.distributed``).
``pu_psnr`` is the second metric, PU21-PSNR; ``preference``,
``hdrvdp_visualize`` and ``testbench`` hold the reference's extras.
"""
from fovvideovdp_tpu_torch.content_mapping import fvvdp_content_mapping_equirect
from fovvideovdp_tpu_torch.display_model import (
    fvvdp_display_geometry,
    fvvdp_display_photo_absolute,
    fvvdp_display_photo_eotf,
    fvvdp_display_photo_gog,
    fvvdp_display_photometry,
)
from fovvideovdp_tpu_torch.fvvdp import fvvdp
from fovvideovdp_tpu_torch.io.images import load_image_as_array
from fovvideovdp_tpu_torch.pupsnr import pu_psnr
from fovvideovdp_tpu_torch.torch_interop import fvvdp_torch_loss
from fovvideovdp_tpu_torch.video_source import (
    fvvdp_video_source,
    fvvdp_video_source_array,
    fvvdp_video_source_packed_array,
)
from fovvideovdp_tpu_torch.video_source_file import fvvdp_video_source_file
from fovvideovdp_tpu_torch.video_source_yuv import (
    fvvdp_video_source_yuv_array,
    fvvdp_video_source_yuv_file,
)
from fovvideovdp_tpu_torch.visualize import vis_tonemap, visualize_diff_map

__version__ = "0.1.0"

__all__ = [
    "fvvdp",
    "pu_psnr",
    "fvvdp_torch_loss",
    "fvvdp_content_mapping_equirect",
    "fvvdp_display_photometry",
    "fvvdp_display_photo_eotf",
    "fvvdp_display_photo_absolute",
    "fvvdp_display_photo_gog",
    "fvvdp_display_geometry",
    "fvvdp_video_source",
    "fvvdp_video_source_array",
    "fvvdp_video_source_packed_array",
    "fvvdp_video_source_file",
    "fvvdp_video_source_yuv_file",
    "fvvdp_video_source_yuv_array",
    "load_image_as_array",
    "visualize_diff_map",
    "vis_tonemap",
]
