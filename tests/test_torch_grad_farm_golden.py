"""Reverse mode through the port's farm evaluator against JAX: the
two-unit semi_wind farm's gradient against the ``jax.grad`` golden
(``golden_grad_farm_semi_wind.npz``: ``FARM_ROWS`` rows 2-3, the
response metric sum |Xi[0]|^2 + sum X0^2 with respect to every row
input, the per-unit wind speeds included) within 1e-9 x each key's
max|g|; status and n_iter_drag equal; the adjoint solves of the
backward per size: one at N = 12 per chunk (the system response, the
kernel's N = 7-12 adjoint entry on the card) and the units' fixed
points' at N = 6.
"""

import os

import numpy as np
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models import dynamics
from raft_tpu_torch.ops import linsolve
from test_torch_grad import hold_grads, metric
from test_torch_grad_farm import FIX, ROW_KEYS, model


def test_farm_gradient_matches_golden(monkeypatch):
    """Every row input, one chunk of the two golden rows; the adjoint
    solves of the backward counted by size."""
    g = dict(np.load(os.path.join(FIX, "golden_grad_farm_semi_wind.npz")))
    ev = tapi.make_farm_evaluator(model(), device="cpu")
    sizes = []
    plain = linsolve._adjoint

    def counted(Z, *a):
        sizes.append(Z.shape[-1])
        return plain(Z, *a)

    monkeypatch.setattr(linsolve, "_adjoint", counted)
    x = {k: torch.tensor(g[k], requires_grad=True) for k in ROW_KEYS}
    out = ev(**x)
    for k in ("status", "n_iter_drag"):
        np.testing.assert_array_equal(out[k].numpy(), g[k], err_msg=k)
    val = metric(out)
    gr = torch.autograd.grad(val.sum(), list(x.values()), allow_unused=True,
                             materialize_grads=True)
    hold_grads(val, dict(zip(x, gr)), g, "")
    assert sizes.count(ev.nT) == 1
    assert sizes.count(6) == dynamics.NEUMANN_STEPS + 1
    assert len(sizes) == dynamics.NEUMANN_STEPS + 2
