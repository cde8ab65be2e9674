"""Reverse mode through the port's flexible (N-DOF beam) evaluator,
against JAX.

``golden_grad_flex_semi_wind.npz`` (semi_wind_flex, nDOF 168, semi_wind's
golden rows 2-3): the response metric sum |Xi[0]|^2 + sum X0^2 and its
``jax.grad`` with respect to every row input; then the same rows
through the geometry axis with the ``struct_params`` of a tower rebuilt
on the host at d x 0.9, t x 1.1, and the gradient with respect to the
row inputs and every ``struct_params`` leaf (the complex ones, Imat and
the inertia coefficients Cm, as real and imaginary parts).

The gradients pass the N = 168 statics and response solves and their
adjoints (``torch.linalg.solve`` here, ``jnp.linalg.solve`` in the
reference: pivoted LU of two libraries).  They are held at GRAD_GATE =
1e-7 x each key's max|g|, set from their readings with room on both
sides: 2.9e-10 on the CPU and 1.1e-9 on an H100 (ROADMAP §C), 340x and
90x under the gate, which in turn is 60x under kappa(Z) eps = 6.0e-6,
the gate of the forward's solve keys (``tests/test_torch_flexible.py``).
The metric, a forward value, is held at that file's kappa(K) eps;
status and n_iter_drag are equal.  Slow tier: the golden regenerated
through jax.grad.
"""

import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import make_torch_port_fixtures as mk  # noqa: E402
from test_torch_grad import hold_grads, metric  # noqa: E402
FIX = os.path.join(HERE, "fixtures", "torch_port")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
EPS = float(np.finfo(np.float64).eps)
#: the gradients' gate (x each key's max|g|) and the metric's, kappa(K)
#: eps of tests/test_torch_flexible.py
GRAD_GATE = 1e-7
METRIC_GATE = 2.80e9 * EPS

_STATE = {}


def golden():
    if "g" not in _STATE:
        _STATE["g"] = dict(np.load(os.path.join(
            FIX, "golden_grad_flex_semi_wind.npz")))
    return _STATE["g"]


def model():
    if "m" not in _STATE:
        _STATE["m"] = Model(os.path.join(FIX, "design_semi_wind_flex.json"))
    return _STATE["m"]


def hold(out, x, g, pfx):
    for k in ("status", "n_iter_drag"):
        np.testing.assert_array_equal(out[k].numpy(), g[pfx + k], err_msg=k)
    val = metric(out)
    gr = torch.autograd.grad(val.sum(), list(x.values()), allow_unused=True,
                             materialize_grads=True)
    return hold_grads(val, dict(zip(x, gr)), g, pfx, tol=GRAD_GATE,
                      metric_tol=METRIC_GATE)


def test_flex_gradient_matches_golden():
    g = golden()
    ev = tapi.make_flexible_evaluator(model(), device="cpu")
    x = {k: torch.tensor(g[k], requires_grad=True) for k in ROW_KEYS}
    hold(ev(**x), x, g, "")


def test_flex_geometry_gradient_matches_golden():
    """The row inputs and every struct_params leaf, one host-rebuilt
    tower for both rows (stacked per row)."""
    g = golden()
    ev = tapi.make_flexible_evaluator(model(), device="cpu", geometry=True)
    x = {k: torch.tensor(g[k], requires_grad=True) for k in ROW_KEYS}
    sp = {k[4:]: torch.tensor(v, requires_grad=True) for k, v in g.items()
          if k.startswith("geo_sp.")}
    out = ev(struct_params=mk._tree_struct_params(sp), **x)
    hold(out, dict(x, **sp), g, "geo_")


@pytest.mark.slow
def test_grad_flex_fixture_regenerates():
    new = mk.build_grad_flex_golden()
    old = golden()
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
