"""The farm's wake coupling against the JAX package's: the wake model's
Gaussian deficit and waked speeds, and the coupling's
``find_equilibrium`` on the two-unit farm against the JAX coupling's in
``golden_drivers.npz`` (driver tests of ``test_torch_drivers.py``, in a
file of their own so that pytest-xdist's ``--dist loadfile`` runs them
beside the rest; ``calc_aep`` and the coupling's curves are in
``test_torch_drivers_aep.py``).
"""

import os

import numpy as np

from tests.test_torch_drivers import TOL, _mk, drivers_golden
from tests.test_torch_orchestrated import FIX, close


_FARM = {}


def _wake():
    """The port's WakeCoupling of the two-unit farm on the golden's grid
    (made once)."""
    if not _FARM:
        from raft_tpu_torch.models.model import Model

        model = Model(os.path.join(FIX, "design_farm_semi_wind_cases.json"))
        _FARM["wc"] = model.wake_coupling(
            u_grid=np.asarray(_mk().WAKE_GRID), device="cpu")
    return _FARM["wc"]


def test_wake_find_equilibrium_matches_jax():
    """The wake/position fixed point of the farm's first case (the rear
    unit in the front one's wake), as the JAX WakeCoupling's
    (golden_drivers.npz): the waked speeds, positions and powers of
    every iteration within 1e-10 x max."""
    mk, g, wc = _mk(), drivers_golden(), _wake()
    for i in range(2):
        close(wc.curves[i]["Ct"], g[f"wake_Ct_{i}"], TOL, what="Ct")
        close(wc.curves[i]["power"], g[f"wake_power_{i}"], TOL,
              what="power")
    keys = wc.model.design["cases"]["keys"]
    case = dict(zip(keys, wc.model.design["cases"]["data"][mk.WAKE_CASE]))
    got = wc.find_equilibrium(case, n_iter=mk.WAKE_EQ_ITER)
    for a, k in zip(got, ("eq_winds", "eq_xs", "eq_ys", "eq_powers")):
        close(a, g[k], TOL, what=k)
    assert got[0][-1][1] < got[0][-1][0]


def test_wake_model_matches_jax():
    """The Gaussian deficit and the front-to-back waked speeds on a row
    of three turbines with a lateral offset, as the JAX wake's."""
    from raft_tpu.physics import wake as jw
    from raft_tpu_torch.physics import wake as tw

    dx = np.array([-10.0, 50.0, 300.0, 900.0])
    dy = np.array([0.0, 20.0, -80.0, 150.0])
    close(tw.gaussian_deficit(dx, dy, 240.0, 0.8, 0.08),
          jw.gaussian_deficit(dx, dy, 240.0, 0.8, 0.08), TOL, what="deficit")
    xy = np.array([[0.0, 0.0], [1200.0, 60.0], [2400.0, -40.0]])
    D = np.full(3, 240.0)

    def ct(U):
        return 0.8 * np.exp(-((U - 9.0) / 8.0) ** 2)

    got = tw.farm_velocities(xy, D, [ct] * 3, 11.0, 5.0, 0.07)
    want = jw.farm_velocities(xy, D, [ct] * 3, 11.0, 5.0, 0.07)
    for a, b in zip(got, want):
        close(a, b, TOL, what="farm velocities")
    assert got[0][2] < got[0][0]
