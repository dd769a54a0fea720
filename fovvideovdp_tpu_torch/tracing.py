"""Spans of the port's stages, on the profiler's clock.

``span(name)`` marks a stage of a call in the host timeline of a recording
``torch.profiler``, as a ``record_function`` range; with no profiler
recording it returns one shared no-op context, and the check is its whole
cost.  The profiler stamps its host events on the clock it converts the
device's kernels and copies to, so a trace shows which stage launched each
kernel and which stage the host was in while the card sat idle; spans of one
thread nest by time, under the call's entry span.  The trace is the one
export: run a call under ``torch.profiler.profile`` and read its events or
``export_chrome_trace``.

The spans, all named ``fvvdp.<stage>`` and, but for ``fvvdp.vjp`` (one per
kernel call of the forward), none inside a per-level loop or a kernel
wrapper (the device trace names the kernels):

* ``fvvdp.predict_video_source``, ``fvvdp.predict_batch``,
  ``fvvdp.predict_traced``: each entry call (``loss`` through
  ``predict_traced``);
* ``fvvdp.chunk``: one block of a video streamed on one card, or one chunk
  of independent frames, images or clips;
* ``fvvdp.luminance``: raw frames to the luminance the core scores (a file
  source's reader included), or in ``predict_traced`` each side's float
  frames to it;
* ``fvvdp.yuv``: each conversion of a block of raw Y'CbCr frames
  (``video_source_yuv.yuv_block_to_luminance``), inside ``fvvdp.luminance``;
* ``fvvdp.mem_query``: each query of the card's free memory
  (``memory.usable_bytes``, its one site);
* ``fvvdp.mem_reuse``: an empty span for each answer of
  ``memory.usable_bytes`` served from its kept reading of the card, with no
  query: the share of answers reused is
  ``mem_reuse / (mem_reuse + mem_query)``;
* ``fvvdp.pool``: the pooling to JOD;
* ``fvvdp.gather``: the gather of results over the processes of a group;
* ``fvvdp.vjp``: the backward of one kernel's ``torch.autograd.Function``
  (``ops/cuda/_autograd.py``: its plain version's VJP, every recompute
  chunk inside the one span), on the thread autograd runs it on; the
  backward of the plain PyTorch around the kernels (the luminance, the
  padding's gather, the pooling) carries no span.

The slots of a mesh run in threads that a profiler started in the caller's
thread does not follow; their stages carry no span.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the trace of a recording profiler;
    the shared no-op context when none records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(name)

