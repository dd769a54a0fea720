"""Scoring of many independent pairs (``fvvdp.predict_batch``).

Counterpart of ``fovvideovdp_tpu/parallel/`` on one CUDA card: only the
batch scorers of ``sharding.py`` are ported.  The mesh, the ``shard_*``
functions and ``multihost.py`` (scoring over several cards and hosts) are
ROADMAP queue 1 item 1.
"""
from fovvideovdp_tpu_torch.parallel.sharding import (make_batch_scorer,
                                                     make_batch_video_scorer)

__all__ = ["make_batch_scorer", "make_batch_video_scorer"]
