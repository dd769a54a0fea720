"""One batch scored by several processes, through ``torch.distributed``.

Counterpart of ``fovvideovdp_tpu/parallel/multihost.py``.  The reference
scales to many pairs with one SLURM process per GPU
(``pyfvvdp/benchmark_cluster.sh``); the JAX package makes them one SPMD
program over a mesh of every host's chips.  Here each process joins one
process group (:func:`init_multihost`), passes its own pairs to
``fvvdp.predict_batch`` and scores them on its own cards (the slots of its
mesh); the pairs never talk, so the only traffic between processes is the
gather of the results at the end.

The group runs over gloo.  Its gathers carry kilobytes of JODs and
``Q_per_ch``, which end on the host anyway; gloo needs no card per rank, so
several processes may share one card (as ``chip_smoke.py`` runs two on its
one card), and the same code runs on the CPU in the tests.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fovvideovdp_tpu_torch.tracing import span
from fovvideovdp_tpu_torch.video_source import resolve_device

_local_device_ids: Optional[List[int]] = None


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the process group (call once per process, before scoring):
    ``torch.distributed.init_process_group("gloo")`` at
    ``tcp://<coordinator_address>`` ("host:port", where process 0 listens),
    with ``num_processes`` ranks of which this is ``process_id``.  An
    argument left None is read from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as ``env://`` reads it.
    ``local_device_ids`` picks this process's cards: ``make_mesh()`` then
    builds its mesh over them (by default over every visible card)."""
    import torch.distributed as dist
    global _local_device_ids
    init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))
    _local_device_ids = None if local_device_ids is None else [int(i) for i in local_device_ids]


def process_count() -> int:
    """Processes in the group; 1 outside one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_devices() -> List[torch.device]:
    """This process's cards: those ``init_multihost`` was given, else every
    visible card.  Raises without a card."""
    resolve_device("cuda")
    ids = _local_device_ids if _local_device_ids is not None \
        else range(torch.cuda.device_count())
    return [torch.device("cuda", i) for i in ids]


def local_batch_to_global(local_rows: int) -> slice:
    """Where this process's ``local_rows`` pairs sit in the global batch.
    PyTorch builds no global array: the global batch is every process's
    rows in rank order, and each process keeps and scores its own, as
    ``jax.make_array_from_process_local_data`` leaves each process's rows
    on its own devices.  Every process must pass the same count (a
    gather of the counts checks it, with the JAX package's error)."""
    counts = replicate_to_hosts(torch.tensor([int(local_rows)], dtype=torch.int64))
    if not bool(torch.all(counts == counts[0])):
        raise RuntimeError("predict_batch requires the same (padded) pair count on "
                           f"every process; got {counts.tolist()}")
    start = process_index() * int(local_rows)
    return slice(start, start + int(local_rows))


def replicate_to_hosts(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every process's ``x`` (a host tensor of the same shape on each)
    concatenated in rank order along ``axis``: an ``all_gather`` over the
    group, so every process can read all of it."""
    import torch.distributed as dist
    x = x.detach().cpu().contiguous()
    if process_count() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(process_count())]
    with span("fvvdp.gather"):
        dist.all_gather(parts, x)
    return torch.cat(parts, dim=axis)


def local_row_positions(n_rows_global: int) -> np.ndarray:
    """Row indices of the global batch owned by THIS process (rank r owns
    the r-th of equal contiguous blocks), to slice this process's results
    out of a gathered global result."""
    n_proc = process_count()
    if n_rows_global % n_proc != 0:
        raise ValueError(f"{n_rows_global} rows do not shard evenly over "
                         f"{n_proc} processes; row ownership is ambiguous")
    per = n_rows_global // n_proc
    return np.arange(process_index() * per, (process_index() + 1) * per)
