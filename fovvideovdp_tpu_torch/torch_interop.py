"""The metric as a PyTorch loss.

Counterpart of ``fovvideovdp_tpu/torch_interop.py:81-135``, with the same
signature and meaning.  The JAX package needs a bridge there (DLPack and a
jitted ``jax.value_and_grad``); here the metric is PyTorch throughout, so
the loss is a closure over :meth:`fvvdp.loss` and autograd differentiates it
through every kernel's ``torch.autograd.Function``.
"""
from __future__ import annotations


def fvvdp_torch_loss(fv, dim_order="BCFHW", frames_per_second=0,
                     fixation_point=None, grad_ref=False):
    """Wrap a :class:`fovvideovdp_tpu_torch.fvvdp` instance as a torch loss.

    Returns ``loss_fn(test, ref) -> 0-d tensor`` with ``loss = 10 - Q_JOD``
    (0 when the pair is visually identical), differentiable with respect to
    ``test`` (and ``ref`` too when ``grad_ref=True``; otherwise ``ref`` is
    detached).  Inputs are display-encoded float tensors on the metric's
    device in the layout named by ``dim_order`` (luminance when the
    photometry is absolute), exactly as :meth:`fvvdp.predict_traced` takes
    them.  Under ``torch.no_grad()`` the call computes the value alone.

    Example::

        fv = fvvdp(display_name="standard_4k")
        loss_fn = fvvdp_torch_loss(fv, dim_order="HWC")
        loss = loss_fn(reconstruction, target)
        loss.backward()          # reconstruction.grad is populated
    """
    def loss_fn(test, ref):
        if not grad_ref:
            ref = ref.detach()
        return fv.loss(test, ref, dim_order=dim_order,
                       frames_per_second=frames_per_second,
                       fixation_point=fixation_point)

    return loss_fn
