"""Gradients through the hand-written kernels.

Each kernel's wrapper is decorated with :func:`differentiable`.  When
autograd needs a graph through the call (grad mode on and a differentiable
input that requires grad), the call goes through one
``torch.autograd.Function``:

* its forward is the wrapper itself, run with grad off: the kernel on a CUDA
  tensor, the plain version on a CPU tensor, the launch counted as always;
* its backward re-runs the kernel's *plain* version under
  ``torch.enable_grad()`` on detached copies of the saved inputs and returns
  ``torch.autograd.grad`` of it.  This is the JAX package's rule: every
  Pallas kernel there has a ``custom_vjp`` whose backward is ``jax.vjp`` of
  its jnp version (``_es2_bwd``, ``_tp_bwd``, ``_mov_bwd``, ...); the reduce,
  which is linear, takes the transpose of its jnp version
  (``_reduce_bwd``), which the VJP of the plain version is.

Only the arguments an op names as differentiable get a gradient; the others
(taps, LUT tables, the gaze, the static planes of the moving-gaze scorer,
the scalars) get ``None``.  Otherwise the wrapper runs exactly as it does
without autograd.

Ops whose plain version is separable over frames (axis 0 of every framed
argument and of every output) recompute in chunks of frames, so that the
autograd graph of the recompute holds a chunk's intermediates, not the
block's: as many frames as ``memory.recompute_budget`` holds at the op's
``graph_bytes`` per frame.

Each backward is one ``fvvdp.vjp`` span (``tracing``), on the thread
autograd runs it on, and is counted: :func:`vjp_counts` gives, per wrapper,
the backwards run and the chunks their recompute took since
:func:`reset_vjp_counts` (one chunk for an op recomputed all at once).
"""
from __future__ import annotations

import functools
import inspect
import threading
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from fovvideovdp_tpu_torch import memory
from fovvideovdp_tpu_torch.tracing import span


class KernelOp(NamedTuple):
    """How one wrapper is differentiated.  ``run``: the wrapper undecorated;
    ``plain``: its plain version, with the same positional arguments;
    ``diff``: positions of the arguments that carry a gradient; ``framed``:
    positions of the arguments whose axis 0 is the frame axis of every
    output too, or None when the plain version is not separable over frames;
    ``graph_bytes``: bytes the plain version's autograd graph keeps per
    frame, as a multiple of one frame of the framed arguments."""
    run: Callable
    plain: Callable
    diff: Tuple[int, ...]
    framed: Optional[Tuple[int, ...]]
    graph_bytes: float


# wrapper name: {"calls": backwards run, "chunks": recompute chunks}
_vjp_counts: Dict[str, Dict[str, int]] = {}
_vjp_lock = threading.Lock()


def vjp_counts() -> Dict[str, Dict[str, int]]:
    """Backwards and recompute chunks per wrapper since the last reset."""
    with _vjp_lock:
        return {k: dict(v) for k, v in _vjp_counts.items()}


def reset_vjp_counts() -> None:
    with _vjp_lock:
        _vjp_counts.clear()


def _count_vjp(op: KernelOp, chunks: int) -> None:
    with _vjp_lock:
        c = _vjp_counts.setdefault(op.run.__name__, {"calls": 0, "chunks": 0})
        c["calls"] += 1
        c["chunks"] += chunks


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _vjp_once(op: KernelOp, args: Sequence, wrt: Sequence[int], grads: Sequence):
    """Gradients of the plain version at ``args`` with respect to
    ``args[i]`` for i in ``wrt``, for the output cotangents ``grads``."""
    with torch.enable_grad():
        inputs = [a.detach().requires_grad_(i in wrt) if torch.is_tensor(a) else a
                  for i, a in enumerate(args)]
        # an output none of ``wrt`` reaches (L_bkg of expand_contrast, for the
        # fine level alone) takes no part
        pairs = [(o, g) for o, g in zip(_outputs(op.plain(*inputs)), grads)
                 if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in wrt],
                                  [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(args[i]) if g is None else g for i, g in zip(wrt, got)]


def recompute_frames(op: KernelOp, args: Sequence) -> Optional[int]:
    """Frames per chunk of the recompute: what the budget holds at the op's
    ``graph_bytes`` per frame (at least 1), or None (all at once) for an op
    that is not separable over frames or whose first framed argument is a
    single (h, w) plane."""
    if op.framed is None or args[op.framed[0]].dim() < 3:
        return None
    framed = [args[i] for i in op.framed]
    per_frame = op.graph_bytes * sum(t[0].numel() * t.element_size() for t in framed
                                     if t.shape[0] > 0)
    budget = memory.recompute_budget(framed[0].device)
    return max(1, int(budget // max(per_frame, 1.0)))


def vjp(op: KernelOp, args: Sequence, wrt: Sequence[int], grads: Sequence,
        frames: Optional[int] = None):
    """The backward of ``op``: gradients of its plain version with respect to
    ``args[i]`` for i in ``wrt``, recomputed ``frames`` frames at a time
    (None: all at once).  Every index in ``wrt`` is framed when ``frames``
    is given."""
    n_frames = args[op.framed[0]].shape[0] if op.framed else 0
    if frames is None or frames >= n_frames:
        _count_vjp(op, 1)
        return _vjp_once(op, args, wrt, grads)
    _count_vjp(op, -(-n_frames // frames))
    out = [torch.empty_like(args[i]) for i in wrt]
    for f0 in range(0, n_frames, frames):
        sl = slice(f0, f0 + frames)
        sub = [a[sl] if i in op.framed else a for i, a in enumerate(args)]
        for o, g in zip(out, _vjp_once(op, sub, wrt, [g[sl] for g in grads])):
            o[sl] = g
    return out


class _KernelFunction(torch.autograd.Function):
    """One kernel call in the autograd graph (see the module's docstring)."""

    @staticmethod
    def forward(ctx, op: KernelOp, *args):
        ctx.op = op
        ctx.tensor_at = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.others = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return op.run(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        op = ctx.op
        args = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t
        wrt = [i for i in op.diff if ctx.needs_input_grad[1 + i]]
        out = [None] * (1 + len(args))
        if wrt:
            with span("fvvdp.vjp"):
                got = vjp(op, args, wrt, grads, recompute_frames(op, args))
            for i, g in zip(wrt, got):
                out[1 + i] = g
        return tuple(out)


def differentiable(plain: Callable, diff: Tuple[int, ...],
                   framed: Optional[Tuple[int, ...]] = None, graph_bytes: float = 1.0):
    """Decorator of a kernel wrapper: the call goes through the op's
    ``torch.autograd.Function`` when autograd needs a graph through it, and
    straight to the wrapper otherwise.  The wrapper's ``op`` attribute is
    the :class:`KernelOp`."""
    def wrap(run):
        sig = inspect.signature(run)
        op = KernelOp(run, plain, tuple(diff),
                      None if framed is None else tuple(framed), float(graph_bytes))

        @functools.wraps(run)
        def wrapper(*args, **kwargs):
            if torch.is_grad_enabled():
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                full = bound.args
                if any(torch.is_tensor(full[i]) and full[i].requires_grad for i in op.diff):
                    return _KernelFunction.apply(op, *full)
            return run(*args, **kwargs)

        wrapper.op = op
        return wrapper
    return wrap
