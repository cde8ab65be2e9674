"""The port's lumped-mass mooring line dynamics (``moorMod`` 1 and 2)
against JAX.

Unit tests on one chain line (that of ``tests/test_mooring_dynamics.py``:
850 m of 0.333 m chain from 200 m depth to a fairlead 14 m deep):
``line_static_shape``, ``line_dynamics`` at three frequencies with waves
and a moving fairlead (with and without internal damping), and the
FOWT-level ``fowt_line_tension_amps`` and ``fowt_mooring_impedance`` of
semi_wind's mooring at a displaced pose, each against the JAX function
on the same inputs within 1e-10 x its max.  End to end:
``analyze_cases`` of semi_wind with ``moorMod`` 1 and 2 against the JAX
Model's goldens (``golden_orch_semi_wind_moor*.npz``) at the gates of
``tests/test_torch_orchestrated.py``; the line-dynamics tensions differ
from the quasi-static ones.
"""

import json
import os

import numpy as np
import pytest

from raft_tpu.physics import mooring_dynamics as jmd
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.physics import mooring_dynamics as tmd
from tests.test_torch_orchestrated import close, golden, hold_results, run

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
TOL = 1e-10

ANCHOR = np.array([-837.6, 0.0, -200.0])
FAIR = np.array([-58.0, 0.0, -14.0])
L, W_LIN, EA = 850.0, (685.0 - 1025 * np.pi / 4 * 0.333 ** 2) * 9.81, 3.27e9
M_LIN, D_VOL = 685.0, 0.333
W3 = np.array([0.05, 0.4, 1.2])


def _np(x):
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)


def test_line_static_shape_matches_jax():
    """Node positions, tensions, the grounded mask and the arc
    coordinates of the static catenary (its touchdown is a node)."""
    got = tmd.line_static_shape(ANCHOR, FAIR, L, W_LIN, EA)
    want = jmd.line_static_shape(ANCHOR, FAIR, L, W_LIN, EA)
    assert want[2].any() and not want[2].all()
    for a, b, k in zip(got, want, ("r_nodes", "T_nodes", "grounded", "s")):
        if k == "grounded":
            np.testing.assert_array_equal(a, b)
        else:
            close(a, np.asarray(b, dtype=float), TOL, what=k)


@pytest.mark.parametrize("BA", [0.0, -0.8])
def test_line_dynamics_matches_jax(BA):
    """Tension amplitudes, the condensed fairlead impedance and the
    interior motions at three frequencies, waves from 17 deg and a
    fairlead moving in all three directions."""
    rng = np.random.default_rng(11)
    zeta = rng.normal(size=3) + 1j * rng.normal(size=3)
    rao = rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3))
    shape = jmd.line_static_shape(ANCHOR, FAIR, L, W_LIN, EA)
    args = (*shape[:3], L, EA, M_LIN, D_VOL, W3, W3 ** 2 / 9.81, zeta,
            np.deg2rad(17.0), 200.0)
    want = jmd.line_dynamics(*args, RAO_B=rao, s_arc=shape[3], BA=BA)
    got = tmd.line_dynamics(*args, RAO_B=rao, s_arc=shape[3], BA=BA,
                            device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        close(_np(got[k]), np.asarray(want[k]), TOL, what=k)


def _semi_moor(mod):
    with open(os.path.join(FIX, f"design_semi_wind_moor{mod}.json")) as f:
        return Model(json.load(f))


POSE = np.array([4.0, -1.5, -0.6, 0.01, 0.03, -0.02])


def test_fowt_mooring_impedance_matches_jax():
    """semi_wind's three lines condensed to the platform's 6 x 6
    impedance at a displaced pose under its case's sea."""
    import raft_tpu

    model = _semi_moor(2)
    jms = raft_tpu.Model(os.path.join(FIX, "design_semi_wind_moor2.json")).ms
    S = np.linspace(0.0, 3.0, model.nw) * np.exp(-np.linspace(0, 4, model.nw))
    fs = model.fowtList[0]
    kw = dict(rho=fs.rho_water, g=fs.g)
    want = jmd.fowt_mooring_impedance(jms, POSE, model.w, model.k, S, 0.3,
                                      model.depth, **kw)
    got = tmd.fowt_mooring_impedance(model.ms, POSE, model.w, model.k, S,
                                     0.3, model.depth, device="cpu", **kw)
    close(_np(got), np.asarray(want), TOL, what="Z_moor")


def test_fowt_line_tension_amps_matches_jax():
    """Both end tensions of every line under a platform motion."""
    import raft_tpu

    model = _semi_moor(1)
    jms = raft_tpu.Model(os.path.join(FIX, "design_semi_wind_moor1.json")).ms
    rng = np.random.default_rng(5)
    Xi = (rng.normal(size=(6, model.nw)) + 1j * rng.normal(size=(6, model.nw))
          ) * np.array([1, 1, 0.5, 0.01, 0.01, 0.01])[:, None]
    S = np.full(model.nw, 0.7)
    fs = model.fowtList[0]
    kw = dict(rho=fs.rho_water, g=fs.g)
    want = jmd.fowt_line_tension_amps(jms, POSE, Xi, model.w, model.k, S,
                                      -0.4, model.depth, **kw)
    got = tmd.fowt_line_tension_amps(model.ms, POSE, Xi, model.w, model.k,
                                     S, -0.4, model.depth, device="cpu", **kw)
    close(got, np.asarray(want), TOL, what="T_amps")


@pytest.mark.parametrize("mod", [1, 2])
def test_moormod_analyze_cases_matches_golden(mod):
    """analyze_cases with moorMod 1 (lumped-mass tensions) and 2 (and the
    lumped-mass mooring impedance in the dynamics) against the JAX
    Model: Tmoor_std, Tmoor_PSD, the motions and every other key."""
    name = f"semi_wind_moor{mod}"
    hold_results(run(name), golden(name))


def test_line_dynamics_change_the_tensions():
    """semi_wind at moorMod 0 (the port's run) has the motions of
    moorMod 1, whose dynamics keep the quasi-static stiffness, but not
    its tensions: the lumped-mass line dynamics are not the quasi-static
    Jacobian; moorMod 2's impedance moves the motions too."""
    qs = run("semi_wind").results["case_metrics"][0][0]
    m1, m2 = golden("semi_wind_moor1"), golden("semi_wind_moor2")
    for k in ("surge_std", "heave_std", "pitch_std"):
        close(qs[k], m1[f"m0_0_{k}"], TOL, what=k)
    assert not np.allclose(qs["Tmoor_std"], m1["m0_0_Tmoor_std"], rtol=1e-3)
    close(qs["Tmoor_avg"], m1["m0_0_Tmoor_avg"], TOL, what="Tmoor_avg")
    assert not np.allclose(m2["m0_0_surge_std"], m1["m0_0_surge_std"],
                           rtol=1e-6)
