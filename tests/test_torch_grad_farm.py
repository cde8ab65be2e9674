"""Reverse mode through the port's farm evaluator, against JAX.

Fast tier:

* a network's free points attached at their equilibrium by the
  implicit rule (``MooringNetwork.attach_free_points``) against the
  reference's form, the 25 damped Newton steps taped by autograd
  (``solve_free_points`` with grad on), within 1e-10; the body forces
  and the coupled stiffness written from the attached state equal the
  solved ones;
* the two-unit semi_wind farm's gradient against the ``jax.grad``
  golden (``golden_grad_farm_semi_wind.npz``: ``FARM_ROWS`` rows 2-3,
  the response metric sum |Xi[0]|^2 + sum X0^2 with respect to every
  row input, the per-unit wind speeds included) within 1e-9 x each
  key's max|g|; status and n_iter_drag equal; the adjoint solves of the
  backward per size: one at N = 12 per chunk (the system response, the
  kernel's N = 7-12 adjoint entry on the card) and the units' fixed
  points' at N = 6.

Slow tier: the network stiffness's pose derivative against
``torch.func.jvp`` through the whole inner loop, and the golden
regenerated through jax.grad (about 20-30 min).
"""

import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models import dynamics
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.ops import linsolve

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_grad import hold_grads, metric  # noqa: E402
FIX = os.path.join(HERE, "fixtures", "torch_port")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
ORACLE_TOL = 1e-10

_MODEL = []


def model():
    if not _MODEL:
        _MODEL.append(Model(os.path.join(FIX,
                                         "design_farm_semi_wind.json")))
    return _MODEL[0]


def network_poses(rows):
    g = np.load(os.path.join(FIX, "golden_network_semi_wind.npz"))
    return torch.as_tensor(g["X"][:rows])


def test_free_points_attach_matches_taped_newton():
    """dr_free/dX, against a random cotangent, by the implicit rule and
    by autograd through the reference's 25 Newton steps (each with its
    Jacobian and clip) at golden row 0's equilibrium; F and K written
    from the attached state equal the solved ones (F exactly, K to the
    rounding of the implicit tangents)."""
    net = model().ms_array
    X0 = network_poses(1)
    with torch.no_grad():
        base = net.solve(X0)
    X = X0.clone().requires_grad_()
    out = net.solve(X, root=base["root"])
    assert torch.equal(out["r_free"].detach(), base["r_free"])
    assert torch.equal(out["F"].detach(), base["F"])
    assert float(torch.max(torch.abs(out["K"].detach() - base["K"]))) <= \
        1e-12 * float(torch.max(torch.abs(base["K"])))
    u = torch.as_tensor(np.random.default_rng(8).normal(
        size=base["r_free"].shape))
    got = torch.autograd.grad((u * out["r_free"]).sum(), X)[0]
    Xt = X0.clone().requires_grad_()
    ref = torch.autograd.grad((u * net.solve_free_points(Xt)).sum(), Xt)[0]
    assert float(torch.max(torch.abs(got - ref))) <= \
        ORACLE_TOL * float(torch.max(torch.abs(ref)))


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


def test_parts_refuse_a_pose_the_statics_did_not_attach():
    """The stiffness parts of a pose that requires grad come only from
    the statics' attached state, handed over once: any other such pose
    raises (no second network solve behind the caller's back)."""
    moor = tapi.make_farm_evaluator(model(), device="cpu").mooring
    X0 = network_poses(1).reshape(1, -1)
    with torch.no_grad():
        _, _, state = moor.with_root(X0)
    X = X0.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="at_root"):
        moor.parts(X)
    moor.at_root(X, state)
    Cu, Ka = moor.parts(X)
    assert Cu.requires_grad and Ka.requires_grad
    with pytest.raises(RuntimeError, match="at_root"):
        moor.parts(X)


@pytest.mark.slow
def test_network_stiffness_pose_derivative_matches_jvp():
    """d K/dX written from the attached state against torch.func.jvp of
    the solved stiffness through the whole inner loop (about 1 min)."""
    net = model().ms_array
    X0 = network_poses(1)
    with torch.no_grad():
        base = net.solve(X0)
    X = X0.clone().requires_grad_()
    K = net.solve(X, root=base["root"])["K"]
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.normal(size=K.shape))
    v = torch.as_tensor(rng.normal(size=X0.shape))
    got = float((torch.autograd.grad((u * K).sum(), X)[0] * v).sum())
    dK = torch.func.jvp(lambda x: net.solve(x)["K"], (X0,), (v,))[1]
    ref = float((u * dK).sum())
    assert abs(got - ref) <= ORACLE_TOL * abs(ref)


@pytest.mark.slow
def test_grad_farm_fixture_regenerates():
    import make_torch_port_fixtures as mk

    new = mk.build_grad_farm_golden()
    old = dict(np.load(os.path.join(FIX, "golden_grad_farm_semi_wind.npz")))
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
