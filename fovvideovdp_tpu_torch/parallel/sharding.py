"""Meshes of devices, scoring over a mesh, and batch scoring.

Counterpart of ``fovvideovdp_tpu/parallel/sharding.py`` under the same
names: ``make_mesh``, ``shard_video_block_fn``, ``shard_video_block_step_fn``,
``shard_image_fn``, ``make_batch_scorer`` and ``make_batch_video_scorer``.
``shard_video_scan_fn`` has no counterpart: the port has no scan path.

Mesh and slots
--------------
A :class:`Mesh` is a ('data', 'space') grid of ``torch.device`` entries, as
a JAX mesh is a grid of devices.  Each entry is a *slot*: when the mesh
scores, every slot runs in a Python thread of its own, under
``torch.cuda.device(slot)`` and on a CUDA stream of its own, and launches
the one-card kernels on its share of the work.  The slots of a mesh run at
once.  A mesh may name one device more than once: its slots then share
that device, each on its own stream.  This is the port's counterpart of
the virtual CPU devices of the JAX package's tests
(``--xla_force_host_platform_device_count=8``): the CPU tests build
``make_mesh(["cpu"] * 4)``, and ``chip_smoke.py`` builds
``make_mesh(["cuda:0", "cuda:0"])`` on its one card.

Where JAX's ``shard_map`` runs one program on each device's shard, each
slot here scores its frames or pairs through the one-card path of its
card's core (:meth:`core.MetricCore.replica`): the frames of a streamed
block are split over the slots in contiguous runs, each with the fl-1
frames before it (the halo XLA reshards over ICI); pairs of a batch are
split in contiguous row blocks.  Each kernel scores a frame from its own
window, so the scores do not depend on the split.  An exception in any
slot is raised again in the caller, once every slot has stopped.

The batch scorers score a batch on the ``torch.device`` of the
:class:`MetricCore` they are given, reading their pairs from a
:class:`video_source.PairBatch` (or any object with its ``shape`` and
``luminance(start, count, frames=None)``) a chunk at a time; the caller
sizes the chunks from the card's free memory, and ``fvvdp.predict_batch``
gives each slot of a mesh its own rows.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.core import MetricCore, card
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.parallel import multihost
from fovvideovdp_tpu_torch.video_source import resolve_device

SPACE_SPLIT_ITEM = "queue 1 item 2"


class Mesh:
    """A ('data', 'space') grid of devices (``devices``: a numpy object
    array of ``torch.device``), each entry a slot; built by
    :func:`make_mesh`.  ``mesh.devices.shape``, ``.size`` and ``.flat``
    read as they do on a JAX mesh."""

    axis_names = ("data", "space")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self._streams: Dict[int, "torch.cuda.Stream"] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def slots(self) -> List[torch.device]:
        return list(self.devices.flat)

    def slots_on(self, device) -> int:
        """How many slots share ``device``'s card (its memory)."""
        return sum(s == card(device) for s in self.slots)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.slots]})"

    def _stream(self, k: int):
        # one stream per slot for the mesh's life: the caching allocator
        # keeps freed blocks per stream, so a new stream per call would
        # strand the memory of the last
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(self.slots[k])
        return self._streams[k]

    def run(self, fns: Sequence[Optional[Callable]]) -> list:
        """``fns[k]()`` on slot k, every slot in a thread of its own at once;
        the results in slot order (None where ``fns[k]`` is None).  A CUDA
        slot runs under ``torch.cuda.device`` of its card on its own stream,
        which first waits for what the caller queued on its current
        streams; the slot's stream is synchronised before its thread ends,
        and its results are marked in use on the caller's streams.  Launches
        are counted under the slot's index too (``_lib.launch_scope``).  The
        first exception of a slot is raised again here."""
        slots = self.slots
        waits = [torch.cuda.current_stream(d) for d in set(slots) if d.type == "cuda"]
        out: list = [None] * len(fns)
        errors: list = [None] * len(fns)

        def work(k):
            try:
                out[k] = self._in_slot(k, fns[k], waits)
            except BaseException as e:      # raised again in the caller
                errors[k] = e

        threads = [threading.Thread(target=work, args=(k,), name=f"fvvdp-slot-{k}")
                   for k in range(len(fns)) if fns[k] is not None]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return [_adopt(o) for o in out]

    def _in_slot(self, k: int, fn: Callable, waits):
        dev = self.slots[k]
        with _lib.launch_scope(k):
            if dev.type != "cuda":
                return fn()
            stream = self._stream(k)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                for s in waits:
                    stream.wait_stream(s)
                result = fn()
            stream.synchronize()
            return result


def _adopt(obj):
    """A slot's results, safe to read and free on the caller's streams: a
    CUDA tensor allocated on the slot's stream is recorded on the caller's
    current stream of its card, so that its memory is not handed back to
    the slot's stream before the caller's work on it is done."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            obj.record_stream(torch.cuda.current_stream(obj.device))
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _adopt(o)
    return obj


def make_mesh(devices: Optional[Sequence] = None,
              data_parallel: Optional[int] = None) -> Mesh:
    """A ('data', 'space') mesh over ``devices`` (``torch.device`` or
    strings such as "cuda:1" or "cpu"; one may appear more than once, one
    slot each).  By default: every ``torch.cuda`` device, or this process's
    cards after :func:`multihost.init_multihost`; without a card it raises
    as ``fvvdp(device="cuda")`` does.  ``data_parallel`` splits the device
    count between frames and pairs ('data') and image rows ('space'), as in
    the JAX package; by default every device is on 'data'."""
    if devices is None:
        devices = multihost.local_devices()
    devices = [card(resolve_device(d)) for d in devices]
    for d in devices:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"{d} is not a visible card ({torch.cuda.device_count()} "
                               f"visible)")
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if data_parallel is None:
        data_parallel = n
    if n % data_parallel != 0:
        raise ValueError(f"{n} devices not divisible by data_parallel={data_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data_parallel, n // data_parallel))


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of n rows (frames or pairs) in ``parts`` contiguous
    runs, as even as possible, the first n % parts one longer."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (k < r) for k in range(parts)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def replicas(core: MetricCore, mesh: Mesh, moving: bool = False) -> Dict:
    """The core's replica on every card of the mesh, built in the caller's
    thread before the slots start (slots on one card share its replica and
    must not race to build it or its static data): with ``moving``, with
    the static band data of the moving-gaze route too."""
    cores = {d: core.replica(d) for d in set(mesh.slots)}
    if moving:
        for c in cores.values():
            c.prepare_moving()
    return cores


def tables_on_cards(core: MetricCore, mesh: Mesh, gaze_xy) -> Dict[torch.device, list]:
    """The fixed-gaze tables of ``gaze_xy`` on every card of the mesh,
    each built by that card's replica of ``core`` (replicated, as JAX's
    ``P()``)."""
    return {d: core.replica(d).fov_tables(gaze_xy) for d in set(mesh.slots)}


def _not_divisible(B: int, n_dev: int) -> ValueError:
    return ValueError(f"block size {B} not divisible by {n_dev} devices; pass "
                      f"block_frames as a multiple of the device count")


def _score_split(mesh: Mesh, core: MetricCore, taps: torch.Tensor, window: Callable,
                 parts, tables=None, gaze: Optional[torch.Tensor] = None):
    """Score one block split over the slots: slot k's frames ``parts[k]``
    = [lo, hi) of the block, its ``window(lo, hi, device)`` the
    (fl-1 + hi-lo, H, W) test and reference luminance with the halo first,
    on its card.  ``tables``: per card (:func:`tables_on_cards`);
    ``gaze``: the block's (B, 2) rows.  Returns [(Q, heat) or None] in
    slot order, on the slots' cards."""
    fl = taps.shape[1]
    slots = mesh.slots
    taps_on = {d: taps.to(d) for d in set(slots)}
    cores = replicas(core, mesh, gaze is not None)

    def slot_fn(k):
        lo, hi = parts[k]
        dev = slots[k]

        def fn():
            t, r = window(lo, hi, dev)
            Q, heat, _, _ = cores[dev].video_step(
                t[:fl - 1], r[:fl - 1], t[fl - 1:], r[fl - 1:], taps_on[dev],
                None if tables is None else tables[dev],
                None if gaze is None else gaze[lo:hi].to(dev))
            return Q, heat
        return fn if hi > lo else None

    return mesh.run([slot_fn(k) for k in range(len(slots))])


def _gather(outs, device, do_heatmap: bool):
    """Slots' (Q, heat) -> (Q (n_bands, 2, B), heat (B, ...) or None) on
    ``device``, in frame order."""
    done = [o for o in outs if o is not None]
    Q = torch.cat([q.to(device) for q, _ in done], dim=2)
    heat = torch.cat([h.to(device) for _, h in done], dim=0) if do_heatmap else None
    return Q, heat


def shard_video_block_fn(core: MetricCore, filt: np.ndarray, mesh: Mesh):
    """The block scorer over a mesh (JAX's ``shard_video_block_fn``):
    fn(padded_t, padded_r [, gaze (B, 2)]) -> (Q_per_ch (n_bands, 2, B),
    heatmap or None) on the core's device, for (B + fl - 1, H, W)
    luminance with B divisible by the mesh's size.  Each slot filters and
    scores B / n of the frames with the fl-1 frames before them.  A
    foveated core takes the gaze."""
    taps = torch.as_tensor(np.asarray(filt, dtype=np.float32), device=core.device)
    fl = taps.shape[1]
    n_dev = mesh.size

    def fn(padded_t, padded_r, *maybe_gaze):
        B = padded_t.shape[0] - fl + 1
        if B % n_dev != 0:
            raise _not_divisible(B, n_dev)
        parts = split_rows(B, n_dev)
        gaze = maybe_gaze[0] if core.foveated else None
        outs = _score_split(
            mesh, core, taps,
            lambda lo, hi, dev: (padded_t[lo:hi + fl - 1].to(dev),
                                 padded_r[lo:hi + fl - 1].to(dev)),
            parts, gaze=None if gaze is None else torch.as_tensor(gaze))
        return _gather(outs, core.device, core.do_heatmap)

    return fn


def shard_video_block_step_fn(core: MetricCore, filt: np.ndarray, mesh: Mesh,
                              static_gaze=None, log_contrast: bool = False):
    """The streaming step over a mesh (JAX's ``shard_video_block_step_fn``,
    the contract of ``MetricCore.video_step``):
    fn(carry_t, carry_r, new_t (B, H, W), new_r [, gaze (B, 2)])
    -> (Q_per_ch, heatmap or None, carry_t', carry_r'), with B divisible
    by the mesh's size; ``log_contrast`` encodes the new frames as log10
    luminance (the carry is already encoded).  A foveated core takes
    ``static_gaze``, whose tables are built once on every card, or a gaze
    per call.  (JAX's ``defer_tables``, which spares a recompile per
    fixation point, has nothing to spare here.)"""
    taps = torch.as_tensor(np.asarray(filt, dtype=np.float32), device=core.device)
    fl = taps.shape[1]
    n_dev = mesh.size
    tables = tables_on_cards(core, mesh, static_gaze) \
        if core.foveated and static_gaze is not None else None

    def fn(carry_t, carry_r, new_t, new_r, *extra):
        B = new_t.shape[0]
        if B % n_dev != 0:
            raise _not_divisible(B, n_dev)
        if log_contrast:
            new_t = torch.log10(torch.clamp(new_t, min=1e-6))
            new_r = torch.log10(torch.clamp(new_r, min=1e-6))
        win_t = torch.cat([carry_t, new_t], dim=0)
        win_r = torch.cat([carry_r, new_r], dim=0)
        gaze = extra[0] if core.foveated and tables is None else None
        outs = _score_split(
            mesh, core, taps,
            lambda lo, hi, dev: (win_t[lo:hi + fl - 1].to(dev), win_r[lo:hi + fl - 1].to(dev)),
            split_rows(B, n_dev), tables, None if gaze is None else torch.as_tensor(gaze))
        Q, heat = _gather(outs, core.device, core.do_heatmap)
        n = win_t.shape[0]
        return Q, heat, win_t[n - (fl - 1):], win_r[n - (fl - 1):]

    return fn


def score_video_mesh(mesh: Mesh, core: MetricCore, block: Callable, indexed: Callable,
                     n_frames: int, taps: torch.Tensor, pad_idx: np.ndarray, B: int,
                     tables=None, gaze: Optional[torch.Tensor] = None,
                     keep: Optional[Callable] = None, start: int = 0, carry=None,
                     Q: Optional[torch.Tensor] = None, after_block: Optional[Callable] = None,
                     frames_at: Optional[Callable] = None) -> torch.Tensor:
    """``MetricCore.score_video`` over a mesh, with the same arguments and
    result (``tables`` per card, :func:`tables_on_cards`): each block of B
    frames is split over the slots (:func:`split_rows`), and each slot
    filters and scores its frames with the fl-1 frames before them.

    ``frames_at(indices, device)``, where given, reads the luminance of
    the source's frames at ``indices`` on ``device`` and may be called from
    several threads at once: each slot then converts its own frames and
    its halo on its own card (the padded clip's frames
    ``pad_idx[pos + lo : pos + hi + fl - 1]``), nothing of the block passes
    through the core's card, and ``carry`` is not read.  Else ``block`` and
    ``indexed`` give each block on the core's device, after the carried
    frames, and each slot's window is copied from there."""
    fl = taps.shape[1]
    stream_idx = pad_idx[fl - 1:]
    if Q is None:
        Q = torch.empty((core.plan.height, 2, n_frames), dtype=torch.float32,
                        device=core.device)
    if frames_at is None and carry is None:
        carry = indexed(pad_idx[:fl - 1])
    for pos in range(start, n_frames, B):
        b = min(B, n_frames - pos)
        parts = split_rows(b, mesh.size)
        if frames_at is not None:
            def window(lo, hi, dev):
                return frames_at(pad_idx[pos + lo:pos + hi + fl - 1], dev)

            def carried(end=pos + b):
                return frames_at(pad_idx[end:end + fl - 1], core.device)
        else:
            blk = stream_idx[pos:pos + b]
            if np.array_equal(blk, np.arange(pos, pos + b)):
                new_t, new_r = block(pos, b)
            else:  # circular/pingpong padding reorders the first frames
                new_t, new_r = indexed(blk)
            win = (torch.cat([carry[0], new_t], dim=0), torch.cat([carry[1], new_r], dim=0))
            del new_t, new_r
            n = win[0].shape[0]
            carry = tuple(w[n - (fl - 1):].clone() for w in win)

            def window(lo, hi, dev, win=win):
                return tuple(w[lo:hi + fl - 1].to(dev) for w in win)

            def carried(carry=carry):
                return carry
        outs = _score_split(mesh, core, taps, window, parts, tables,
                            None if gaze is None else gaze[pos:pos + b])
        for (lo, hi), out in zip(parts, outs):
            if out is not None:
                Q[:, :, pos + lo:pos + hi] = out[0]
                if keep is not None:
                    keep(None if out[1] is None else out[1].to(core.device))
        del outs, window
        if after_block is not None:
            after_block(pos + b, Q, carried)
    return Q


def shard_image_fn(core: MetricCore, mesh: Mesh):
    """The lone-image scorer over a mesh (JAX's ``shard_image_fn``):
    fn(T, Rf) -> (Q_per_ch (n_bands, 2, 1), heatmap or None) on the core's
    device.  On a mesh whose 'space' axis is 1, JAX leaves the image
    replicated (``P(None, None)``) and every device scores all of it; here
    it is scored once, with the kernels, on the mesh's first slot, which
    gives the same numbers.  Rows split over a 'space' axis > 1 (JAX leaves
    the convolutions' halos to XLA's partitioner) are not ported: they
    raise ``NotImplementedError``."""
    if mesh.shape["space"] > 1:
        raise NotImplementedError(
            f"a lone image row-split over the mesh's 'space' axis "
            f"({mesh.shape['space']}) is not ported to fovvideovdp_tpu_torch yet "
            f"({SPACE_SPLIT_ITEM} of ROADMAP.md); use a mesh with data_parallel "
            f"equal to its size, or no mesh")
    dev = mesh.slots[0]

    def fn(T, Rf):
        c = core.replica(dev)

        def score():
            return c.score_image(T.to(dev), Rf.to(dev))
        Q, heat = mesh.run([score])[0]
        return Q.to(core.device), None if heat is None else heat.to(core.device)

    return fn


# ----------------------------------------------------------------------
# batches of independent pairs on one device
# ----------------------------------------------------------------------
def _pool_pairs(Q: torch.Tensor, pool_params: Dict) -> torch.Tensor:
    """(n_bands, 2, N, F) -> (N,) JODs, each pair pooled on its own."""
    return mask_ops.pool_to_jod(
        Q, float(pool_params["w_transient"]), float(pool_params["beta_sch"]),
        float(pool_params["beta_tch"]), float(pool_params["beta_t"]),
        float(pool_params["jod_a"]), float(pool_params["log_jod_exp"]))


def make_batch_scorer(core: MetricCore, pairs, chunk: int, pool_params: Dict,
                      fov_tables=None, gaze: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) JODs of a batch of image pairs: ``chunk`` pairs at a time become
    ``R (chunk, 2, H, W)``, scored as images by ``core.score_frame_pairs``
    and pooled pair by pair.  A foveated core takes either ``fov_tables``,
    one fixation point's tables shared by every pair (``core.fov_tables``),
    or ``gaze``, an (N, 2) tensor with one fixation point per pair (the
    moving-gaze route)."""
    Q = core.score_frame_pairs(
        lambda start, count: tuple(x[:, 0] for x in pairs.luminance(start, count)),
        pairs.shape[0], chunk, fov_tables, gaze)
    return _pool_pairs(Q[:, :, :, None], pool_params)


def make_batch_video_scorer(core: MetricCore, pairs, filt: np.ndarray, pool_params: Dict,
                            chunk: int, block: int, temp_padding: str = "replicate",
                            fov_tables=None, gaze: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(JODs (N,), Q_per_ch (n_bands, 2, N, F)) of a batch of clip pairs,
    with the temporal filters ``filt`` (2, fl) and the clips padded by
    ``temp_padding``.  With ``chunk`` > 0, each clip's padded frames are
    filtered at once (``temporal_pair`` with an empty carry) into its slice
    of the chunk's responses, which are scored in one call.  With ``chunk``
    = 0 (a clip's window does not fit the card), each clip streams ``block``
    frames at a time with its carry (``core.score_video``).  ``gaze``: an
    (N, F, 2) tensor, one row per output frame of each clip, in place of
    ``fov_tables``."""
    device = core.device
    taps = torch.as_tensor(filt, device=device)
    N, _, F, H, W = pairs.shape
    pad_idx = temporal_ops.padding_indices(F, filt.shape[1], temp_padding)
    Q = torch.empty((core.plan.height, 2, N, F), dtype=torch.float32, device=device)
    if chunk > 0:
        idx = torch.as_tensor(pad_idx, dtype=torch.int64, device=device)
        empty = torch.empty((0, H, W), dtype=torch.float32, device=device)
        for pos in range(0, N, chunk):
            n = min(chunk, N - pos)
            lum_t, lum_r = pairs.luminance(pos, n)
            R = torch.empty((n * F, 4, H, W), dtype=torch.float32, device=device)
            for i in range(n):
                temporal_ops.temporal_channels_pair(empty, lum_t[i][idx], empty, lum_r[i][idx],
                                                    taps, out=R[i * F:(i + 1) * F])
            del lum_t, lum_r
            Q_chunk, _ = core.score_frames(
                R, 2, fov_tables, None if gaze is None else gaze[pos:pos + n].reshape(-1, 2))
            del R
            Q[:, :, pos:pos + n] = Q_chunk.reshape(-1, 2, n, F)
    else:
        for i in range(N):
            def frames(sel, i=i):
                t, r = pairs.luminance(i, 1, sel)
                return t[0], r[0]
            Q[:, :, i] = core.score_video(
                lambda start, count: frames(slice(start, start + count)), frames,
                F, taps, pad_idx, block, fov_tables, None if gaze is None else gaze[i])
    return _pool_pairs(Q, pool_params), Q
