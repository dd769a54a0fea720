"""Scoring over several devices and processes, and batch scoring.

Counterpart of ``fovvideovdp_tpu/parallel/``, under its names.  A mesh
(:func:`make_mesh`) is a ('data', 'space') grid of devices whose entries,
the slots, score at once, each from a thread of its own on its own CUDA
stream (``sharding.py``): one streamed video with each block's frames split
over the slots (``fvvdp.predict(mesh=)``), a batch of pairs split in row
blocks (``fvvdp.predict_batch(mesh=)``), a lone image on the mesh's first
slot.  ``multihost.py`` lets several processes score one batch, each its own
pairs, gathering the results over ``torch.distributed`` (gloo).
``shard_video_scan_fn`` is not ported: the port has no scan path.
"""
from fovvideovdp_tpu_torch.parallel.multihost import (
    init_multihost,
    local_batch_to_global,
    local_row_positions,
    replicate_to_hosts,
)
from fovvideovdp_tpu_torch.parallel.sharding import (
    Mesh,
    make_batch_scorer,
    make_batch_video_scorer,
    make_mesh,
    shard_image_fn,
    shard_video_block_fn,
    shard_video_block_step_fn,
)

__all__ = ["make_mesh", "make_batch_scorer", "make_batch_video_scorer",
           "shard_video_block_fn", "shard_video_block_step_fn", "shard_image_fn",
           "init_multihost", "local_batch_to_global", "local_row_positions",
           "replicate_to_hosts", "Mesh"]
