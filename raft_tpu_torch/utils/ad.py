"""One test of "this tensor is being differentiated", for both modes.

Reverse mode marks a tensor by ``requires_grad`` (and only counts with
grad enabled).  Forward mode (``torch.func.jvp``, ``torch.func.jacfwd``,
``torch.autograd.forward_ad``) leaves ``requires_grad`` False and
attaches a tangent instead, which ``torch.no_grad`` does not stop; only
``.detach()`` drops it.  Every switch that attaches an implicit rule,
and every iterative loop's entry, asks :func:`differentiated`, so the
loops run on detached values in either mode and their roots enter the
result by their implicit rules.  Inside a torch.func transform every
value is one of its wrappers, tangent or not (:func:`transformed`),
which a kernel launched on data pointers cannot take.
"""

from __future__ import annotations

import torch
from torch.autograd.forward_ad import unpack_dual


def differentiated(*tensors):
    """True when any of ``tensors`` (None and non-tensors ignored) is
    being differentiated: it requires grad with grad enabled, or it
    carries a forward-mode tangent."""
    grad = torch.is_grad_enabled()
    return any(isinstance(t, torch.Tensor) and (
        (grad and t.requires_grad) or unpack_dual(t).tangent is not None)
        for t in tensors)


def transformed(*tensors):
    """True when any of ``tensors`` is one of torch.func's wrappers (a
    value inside ``jvp``, ``jacfwd``, ``vmap`` or ``grad``, with or
    without a tangent): it has no storage of its own, so a kernel
    launched on data pointers cannot take it, while the forward of a
    ``torch.autograd.Function`` receives it unwrapped."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def detached(*tensors):
    """``tensors`` with every tensor detached (no graph, no tangent);
    anything else passes through."""
    return tuple(t.detach() if isinstance(t, torch.Tensor) else t
                 for t in tensors)
