"""Reverse mode through the aero stage and the potential-flow d_scale
of the port's full evaluator, against JAX.

Fast tier:

* the blade-element root's backward (:class:`~raft_tpu_torch.physics.
  aero._RootPhi`, the implicit rule with the reference's slope floor)
  against forward mode: the loads' first derivatives against
  ``rotor_loads_and_derivs_jacfwd`` (``torch.func.jacfwd`` with the
  root's jvp rule), and the hand tangents' own derivatives, the second
  derivatives, against forward mode (``torch.autograd.forward_ad``)
  through the hand tangents, within 1e-10;
* the full evaluator's gradients against the ``jax.grad`` goldens
  (``golden_grad_aero_*.npz``: golden rows 2-5 of semi_wind, a rotor
  in air, and rows 3, 5, 6 and 7 of mhk_tidal, a submerged rotor; the rows
  left out are those where the reference's own gradient is NaN, named
  in the writer's GRAD_AERO_ROWS), FUSED on and off: the response
  metric sum |Xi[0]|^2 + sum X0^2 and its gradient with respect to
  every row input, the aero metric sum |f_aero|^2 (which holds the
  Kaimal spectrum's TI path: TI enters no response) and its gradient
  with respect to the rotor speeds, TI and yaw, within 1e-9 x each
  key's max|g|; status and n_iter_drag equal;
* at current 0, where the reference's gradient is NaN (0 x inf in the
  current drag's norm), the port's is finite, the limit: held against a
  one-sided difference of the port's forward; a clipped wind speed has
  the clamp's derivative, 0.

The d_scale gradient of a potential-flow design is held in
``tests/test_torch_bem.py`` (it reuses that file's panel solves).  Slow
tier: the goldens regenerated through jax.grad.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.physics import aero as ta

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import make_torch_port_fixtures as mk  # noqa: E402
from test_torch_grad import hold_grads, metric  # noqa: E402
FIX = os.path.join(HERE, "fixtures", "torch_port")
SETS = {"semi_wind": 1, "mhk_tidal": 2}
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
AERO_KEYS = mk.GRAD_AERO_METRIC_KEYS
ORACLE_TOL = 1e-10

_MODELS = {}


def model(name):
    if name not in _MODELS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _MODELS[name] = Model(json.load(f))
    return _MODELS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_grad_aero_{name}.npz")))


def aero_metric(out):
    """sum |f_aero|^2 per row."""
    return (out["f_aero"].abs() ** 2).flatten(1).sum(-1)


def grads(val, x, keys, retain=False):
    return dict(zip(keys, torch.autograd.grad(
        val.sum(), [x[k] for k in keys], retain_graph=retain,
        allow_unused=True, materialize_grads=True)))


# ----------------------------------------------------- the root's backward

def _rotor_args(name, rows=6):
    """The rotor of a design and ``rows`` operating points on its
    schedule (speed, rpm, pitch, tilt, yaw), (R,) each."""
    m = model(name)
    fs = m.fowtList[0]
    rot = m.rotor_aero[0]
    rt = ta.rotor_tensors(rot, "cpu")
    lo, hi = (0.6, 2.8) if fs.rotors[0].Zhub < 0 else (4.0, 24.0)
    U = torch.linspace(lo, hi, rows, dtype=torch.float64)
    Om, pit = ta.operating_point(rt, U)
    rng = np.random.default_rng(12)
    tilt = torch.as_tensor(rng.uniform(-0.15, 0.05, rows))
    yaw = torch.as_tensor(rng.uniform(-0.2, 0.2, rows))
    return rt, [U, Om, pit, tilt, yaw]


@pytest.mark.parametrize("name", sorted(SETS))
def test_root_backward_matches_jacfwd(name):
    """The loads' reverse-mode derivatives in (U, Omega, pitch) against
    rotor_loads_and_derivs_jacfwd; the derivatives of (loads, dT, dQ)
    in all five inputs, against a random cotangent, against forward
    mode (torch.autograd.forward_ad) through the hand tangents (the
    root's jvp rule), both within 1e-10; the values bit-equal to the
    plain path's."""
    rt, args = _rotor_args(name)
    p = [a.clone().requires_grad_() for a in args]
    out = ta.rotor_loads_and_derivs(rt, *p)
    plain = ta.rotor_loads_and_derivs(rt, *args)
    for a, b in zip(out, plain):
        assert torch.equal(a.detach(), b)
    _, jT, jQ = ta.rotor_loads_and_derivs_jacfwd(rt, *args)
    for col, jac in ((0, jT), (3, jQ)):
        g = torch.autograd.grad(out[0][:, col].sum(), p[:3],
                                retain_graph=True)
        for i in range(3):
            ref = jac[:, i].detach()
            assert float(torch.max(torch.abs(g[i] - ref))) <= \
                ORACLE_TOL * float(torch.max(torch.abs(ref)))
    rng = np.random.default_rng(4)
    R = len(args[0])
    u = torch.as_tensor(rng.normal(size=(R, 12)))
    flat = torch.cat([o.reshape(R, -1) for o in out], dim=1)
    g = torch.autograd.grad((u * flat).sum(), p)
    fwd = torch.autograd.forward_ad
    for i in range(5):
        # forward mode along input i (rows are independent), the inputs
        # requiring grad so that the root is the attached one
        with fwd.dual_level():
            q = [a.clone().requires_grad_() for a in args]
            q[i] = fwd.make_dual(q[i], torch.ones_like(args[i]))
            tan = torch.cat([fwd.unpack_dual(o).tangent.reshape(R, -1)
                             for o in ta.rotor_loads_and_derivs(rt, *q)],
                            dim=1).detach()
        ref = (u * tan).sum(-1)
        assert float(torch.max(torch.abs(g[i] - ref))) <= \
            ORACLE_TOL * float(torch.max(torch.abs(ref)))


# ------------------------------------------------------ end to end goldens

@pytest.mark.parametrize("name", sorted(SETS))
def test_aero_gradients_match_goldens(name, monkeypatch):
    g = golden(name)
    ev = tapi.make_full_evaluator(model(name), nWaves=SETS[name],
                                  device="cpu")
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        x = {k: torch.tensor(g[k], requires_grad=True) for k in ROW_KEYS}
        out = ev(**x)
        for k in ("status", "n_iter_drag"):
            np.testing.assert_array_equal(out[k].numpy(), g[f"{fused}_{k}"],
                                          err_msg=k)
        val = metric(out)
        hold_grads(val, grads(val, x, ROW_KEYS, retain=True), g,
                   f"{fused}_")
        aval = aero_metric(out)
        hold_grads(aval, grads(aval, x, AERO_KEYS), g, f"{fused}_aero_")


def test_current_zero_and_clipped_wind_gradients():
    """semi_wind's golden row 1 (current 0, wind 0.05 m/s clipped to
    0.1): d/d current_speed is finite and agrees with a one-sided
    difference of the port's own forward (the reference's is NaN there);
    d/d wind_speed is 0, the clamp's derivative."""
    with open(os.path.join(FIX, "golden_full_semi_wind.npz"), "rb") as f:
        rows = {k: v[1:2] for k, v in np.load(f).items() if k in ROW_KEYS}
    ev = tapi.make_full_evaluator(model("semi_wind"), device="cpu")
    x = {k: torch.tensor(rows[k], requires_grad=True)
         for k in ("current_speed", "wind_speed")}
    out = ev(**dict(rows, **x))
    gr = grads(metric(out), x, list(x))
    gc = float(gr["current_speed"][0])
    assert np.isfinite(gc)
    assert float(gr["wind_speed"][0]) == 0.0
    h = 1e-6

    def f(c):
        with torch.no_grad():
            return float(metric(ev(**dict(rows, current_speed=[c])))[0])

    fd = (f(h) - f(0.0)) / h
    # the drag is quadratic in the speed: the difference is O(h) off
    # the derivative at 0; at 0.3 m/s the same metric's slope is ~75
    assert abs(gc - fd) <= 1e-3


@pytest.mark.slow
def test_grad_aero_fixtures_regenerate():
    """The aero gradient goldens, rebuilt through jax.grad (and checked
    against jax.jacfwd), equal the checked-in files."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for name in SETS:
        new = mk.build_grad_aero_golden(name)
        old = golden(name)
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
