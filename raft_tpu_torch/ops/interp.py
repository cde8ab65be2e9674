"""Batched 1-D linear interpolation with the semantics of
``jnp.interp`` (torch has no ``interp``).

The reference interpolates airfoil polars per blade element, the
operating schedule, the Kaimal special-function table and the control
gains with ``jnp.interp``; these are its counterparts:

* the segment is found by ``torch.searchsorted(..., right=True)``
  clamped to [1, n - 1], as ``jnp.interp`` does, so a query on a knot
  takes the segment to its right;
* the value is ``fp[i-1] + (x - xp[i-1]) / dx * df`` in that order,
  held at ``fp[0]`` below the table and ``fp[-1]`` above it;
* the slope left for autograd (and carried by :class:`Dual` tangents)
  is ``df / dx`` inside the table and zero outside it, the derivative
  ``jnp.interp``'s own arithmetic gives.

``xp`` is one shared 1-D grid; ``fp`` is either on that grid (n,) or a
table (..., n) of one row per element, gathered along its last axis.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops.dual import Dual


def _segment(x, xp, fp):
    """(i, fp[i-1], fp[i], dx) of each query, fp gathered per element."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    if fp.dim() == 1:
        f0, f1 = fp[i - 1], fp[i]
    else:
        tab = fp.expand(x.shape + (n,))
        f0 = torch.gather(tab, -1, (i - 1)[..., None])[..., 0]
        f1 = torch.gather(tab, -1, i[..., None])[..., 0]
    return i, f0, f1


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for a tensor ``x`` of any shape, a 1-D
    ascending ``xp`` (n,) and ``fp`` (n,) or (..., n) broadcasting
    against ``x``; a :class:`Dual` ``x`` carries its tangents through
    the segment's slope."""
    xv = x.v if isinstance(x, Dual) else x
    i, f0, f1 = _segment(xv, xp, fp)
    df = f1 - f0
    x0 = xp[i - 1]
    dx = xp[i] - x0
    delta = xv - x0
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    dxs = torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, f0, f0 + (delta / dxs) * df)
    lo = xv < xp[0]
    hi = xv > xp[-1]
    first = fp[..., 0] if fp.dim() > 1 else fp[0]
    last = fp[..., -1] if fp.dim() > 1 else fp[-1]
    f = torch.where(lo, first, f)
    f = torch.where(hi, last, f)
    if not isinstance(x, Dual):
        return f
    keep = ~(dx0 | lo | hi)
    return Dual(f, torch.where(keep, (x.t / dxs) * df, 0.0))
