"""The farm's wake coupling against the JAX package's: ``calc_aep`` over
three wind states on the two-unit farm against the JAX coupling's in
``golden_drivers.npz``, and the coupling's per-unit power and thrust
curves (driver tests of ``test_torch_drivers.py``, in a file of their
own so that pytest-xdist's ``--dist loadfile`` runs them beside the
rest).
"""

import os

import numpy as np

from tests.test_torch_drivers import TOL, _mk, drivers_golden
from tests.test_torch_drivers_wake import _wake
from tests.test_torch_orchestrated import FIX, close


def test_wake_calc_aep_matches_jax():
    """The probability-weighted AEP over three wind states (below
    cut-in, waked at 30 deg, above cut-out), as the JAX WakeCoupling's
    (golden_drivers.npz): the powers per state, the energy per state and
    the total within 1e-10 x max."""
    mk, g = _mk(), drivers_golden()
    powers, per_state, total = _wake().calc_aep(**mk.AEP_STATES,
                                                n_iter=mk.AEP_ITER)
    close(powers, g["aep_powers"], TOL, what="powers")
    close(per_state, g["aep_states"], TOL, what="aep per state")
    close(total, g["aep_total"], TOL, what="aep")
    assert np.all(powers[[0, 2]] == 0) and np.all(powers[1] > 0)


def test_wake_coupling_curves_match_jax():
    """The coupling's per-unit power and thrust-coefficient curves on the
    farm, from the port's power_thrust_curve, as the JAX coupling's."""
    import raft_tpu
    from raft_tpu.physics.wake import WakeCoupling as JW

    from raft_tpu_torch.models.model import Model

    path = os.path.join(FIX, "design_farm_semi_wind_cases.json")
    grid = np.array([4.0, 8.0, 10.59, 14.0, 20.0])
    got = Model(path).wake_coupling(u_grid=grid, device="cpu")
    want = JW(raft_tpu.Model(path), u_grid=grid)
    for a, b in zip(got.curves, want.curves):
        for k in ("D", "power", "Ct"):
            close(a[k], b[k], TOL, what=k)
