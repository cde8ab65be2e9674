"""The geometry axis of a potential-flow design in the port's full
evaluator against JAX: the coarse copy's golden rows with a uniform
d_scale per row (the two off-unit scales solved on first use), and the
d_scale gradient against ``jax.grad``.  The coarse model and its panel
solve are ``tests/test_torch_bem.py``'s fixtures (these tests take
about a minute and a half: in a file of their own pytest-xdist's
``--dist loadfile`` runs them beside that file's).
"""

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from test_torch_bem import (FIX, GEOMETRY_CASES, ROW_KEYS,  # noqa: F401
                            bem_dir, check_evaluator_case, coarse, near)


@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_evaluator_matches_goldens(case, coarse, monkeypatch):
    check_evaluator_case(case, coarse, None, monkeypatch)


def test_d_scale_gradient_matches_golden(coarse, monkeypatch):
    """The geometry axis' gradient with respect to d_scale (0.95, 1.0,
    1.05: the unit row interpolates too, its derivative is not 0) and
    every row input against jax.grad (``golden_grad_bem_semi_wind_
    coarse.npz``), FUSED on and off, within 1e-9 x each key's max|g|;
    the metric within 1e-12; status and n_iter_drag equal."""
    g = dict(np.load(os.path.join(FIX,
                                  "golden_grad_bem_semi_wind_coarse.npz")))
    geo = tapi.make_full_evaluator(coarse[0], device="cpu", geometry=True)
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        x = {k: torch.tensor(g[k], requires_grad=True)
             for k in ROW_KEYS + ("d_scale",)}
        out = geo(geom=dict(d_scale=x["d_scale"]),
                  **{k: x[k] for k in ROW_KEYS})
        for k in ("status", "n_iter_drag"):
            np.testing.assert_array_equal(out[k].numpy(),
                                          g[f"{fused}_{k}"], err_msg=k)
        val = (out["Xi"][:, 0].abs() ** 2).flatten(1).sum(-1) \
            + (out["X0"] ** 2).sum(-1)
        near(val.detach().numpy(), g[f"{fused}_metric"], 1e-12, "metric")
        gr = torch.autograd.grad(val.sum(), list(x.values()),
                                 allow_unused=True, materialize_grads=True)
        for k, a in zip(x, gr):
            near(a.numpy(), g[f"{fused}_g_{k}"], 1e-9, k)
