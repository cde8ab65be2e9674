"""The port's driver layer against the JAX package's.

* ``drivers.run`` and ``run_farm`` on the CPU against the JAX Model's
  goldens (``golden_orch_*.npz``) at the gates of
  ``tests/test_torch_orchestrated.py``, their CSV against the JAX
  ``save_responses`` text; the farm is two semi_wind units with a shared
  line over a buoy and a 2-case table (nDOF 12);
* ``python -m raft_tpu_torch design_spar.json --csv ... --device cpu``
  in a subprocess, its CSV against the golden; without ``--device`` on a
  host with no card it exits non-zero naming ``device="cpu"``;
* ``power_thrust_curve`` (the speeds as rows of one blade-element call)
  against the JAX vmapped curve within 1e-10 x each key's max;
  ``adjust_ballast_density`` and ``adjust_wisdem`` against the JAX
  drivers; ``adjust_ballast`` against the JAX driver's result in
  ``golden_drivers.npz`` (written by ``tests/make_torch_port_fixtures.py
  --drivers``: the fast tier traces no JAX);
* the wake model's deficit and waked speeds and the coupling's curves
  against JAX's; the coupling's ``find_equilibrium`` and ``calc_aep`` on
  the two-unit farm against the JAX coupling's in ``golden_drivers.npz``;
  the IEC wind events against the JAX copy.

Slow tier: ``golden_drivers.npz`` rebuilt by the live JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from raft_tpu_torch import drivers
from tests.test_torch_orchestrated import (FIX, close, golden, hold_csv,
                                           hold_results)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TOL = 1e-10
SPAR = os.path.join(FIX, "design_spar.json")


def test_run_matches_golden(tmp_path):
    """drivers.run on the spar: the JAX Model's results and CSV."""
    csv = tmp_path / "spar.csv"
    model = drivers.run(SPAR, save_csv=str(csv), device="cpu")
    g = golden("spar")
    hold_results(model, g)
    hold_csv(csv.read_text(), g["csv"].item())


def test_run_farm_matches_golden(tmp_path):
    """run_farm on the two-unit semi_wind farm (own moorings, the shared
    network, a 2-case table): every unit's metrics, the coupled
    equilibria and each unit's drag diagnostics as the JAX Model's; the
    system response is N = 12."""
    csv = tmp_path / "farm.csv"
    model = drivers.run_farm(
        os.path.join(FIX, "design_farm_semi_wind_cases.json"),
        save_csv=str(csv), device="cpu")
    g = golden("farm_semi_wind")
    assert model.nFOWT == 2 and model.case_stats[0]["system_n"] == 12
    hold_results(model, g)
    hold_csv(csv.read_text(), g["csv"].item())
    assert "properties" not in model.results


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)


def test_cli_on_the_cpu(tmp_path):
    """The module CLI with --device cpu writes the golden CSV and prints
    one summary line per case and FOWT."""
    csv = tmp_path / "cli.csv"
    out = _cli(os.path.relpath(SPAR, ROOT), "--csv", str(csv), "--device",
               "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("case 0 fowt 0: surge") == 1
    hold_csv(csv.read_text(), golden("spar")["csv"].item())


def test_cli_without_a_card_exits_nonzero(tmp_path):
    """No --device and no card: a non-zero exit naming device="cpu", no
    CSV, no silent CPU run."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    csv = tmp_path / "none.csv"
    out = _cli(os.path.relpath(SPAR, ROOT), "--csv", str(csv), env=env)
    assert out.returncode != 0
    assert 'device="cpu"' in out.stderr
    assert not csv.exists()


def _model(name):
    from raft_tpu_torch.models.model import Model

    return Model(os.path.join(FIX, f"design_{name}.json"))


@pytest.mark.parametrize("name", ["semi_wind", "mhk_tidal"])
def test_power_thrust_curve_matches_jax(name):
    """The steady curve over the schedule's speeds, one row per speed,
    against the JAX vmapped curve (NaN where JAX's is)."""
    import raft_tpu
    from raft_tpu.drivers import power_thrust_curve as jcurve

    model = _model(name)
    speeds = np.asarray(model.rotor_aero[0].U_sched, dtype=float)
    got = drivers.power_thrust_curve(model, speeds, device="cpu")
    want = jcurve(raft_tpu.Model(os.path.join(FIX, f"design_{name}.json")),
                  speeds)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        # the schedule's last points lie past cut-out, where the
        # blade-element solve of both packages has no root (NaN)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        ok = ~np.isnan(b)
        close(a[ok], b[ok], TOL, what=k)
    assert np.all(np.diff(got["thrust"][:4]) > 0)


def test_adjust_ballast_density_matches_jax():
    """The density shift that zeroes the spar's unloaded net heave force
    and the rebuilt design, as the JAX driver's."""
    from raft_tpu.drivers import adjust_ballast_density as jadjust

    with open(SPAR) as f:
        d = json.load(f)
    m, delta = drivers.adjust_ballast_density(d, device="cpu")
    jm, jdelta = jadjust(d)
    close(delta, jdelta, TOL, what="delta_rho")
    for a, b in zip(m.design["platform"]["members"],
                    jm.design["platform"]["members"]):
        if "rho_fill" in b:
            close(np.asarray(a["rho_fill"], dtype=float),
                  np.asarray(b["rho_fill"], dtype=float), TOL,
                  what="rho_fill")


def _mk():
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    return mk


def drivers_golden():
    return dict(np.load(os.path.join(FIX, "golden_drivers.npz")))


def test_adjust_ballast_matches_jax():
    """The secant on the fill scale, as the JAX driver's on the spar with
    the same arguments (golden_drivers.npz): the scale within 1e-10, the
    rebuilt design's fill lengths and its unloaded equilibrium within
    1e-10 x max, and the heave within its tolerance of the target."""
    args = _mk().BALLAST_ARGS
    g = drivers_golden()
    with open(SPAR) as f:
        d = json.load(f)
    model, scale = drivers.adjust_ballast(d, **args, device="cpu")
    close(scale, g["bal_scale"], TOL, what="scale")
    filled = {k for k in g if k.startswith("bal_l_fill_")}
    for i, mi in enumerate(model.design["platform"]["members"]):
        if "l_fill" in mi:
            filled.remove(f"bal_l_fill_{i}")
            close(np.asarray(mi["l_fill"], dtype=float),
                  g[f"bal_l_fill_{i}"], TOL, what=f"l_fill {i}")
    assert not filled
    X = model.solve_statics(None, device="cpu")
    close(X, g["bal_X0"], TOL, what="X0")
    assert abs(X[2] - args["target_heave"]) < args["heave_tol"]
    assert scale != 1.0


def _wisdem_yaml(model):
    """A WISDEM geometry document for the spar's members: a ballasted
    member on each of the spar's bottom joints, one whose diameter
    differs, and one without ballast."""
    members = model.fowtList[0].members
    joints = [dict(name=f"j{i}", location=[0.0, 0.0, float(m.rA0[2])])
              for i, m in enumerate(members)]
    wm = [dict(name=f"m{i}", joint1=f"j{i}", joint2=f"j{i}",
               outer_shape=dict(outer_diameter=dict(
                   values=[float(m.d[0, 0]), float(m.d[0, 0])])),
               internal_structure=dict(ballasts=[dict(volume=1.0)]))
          for i, m in enumerate(members)]
    wm.append(dict(name="other_d", joint1="j0", joint2="j0",
                   outer_shape=dict(outer_diameter=dict(values=[1.5, 1.5])),
                   internal_structure=dict(ballasts=[dict(volume=2.0)])))
    wm.append(dict(name="no_ballast", joint1="j0", joint2="j0",
                   outer_shape=dict(outer_diameter=dict(values=[9.4])),
                   internal_structure=dict()))
    return dict(components=dict(floating_platform=dict(joints=joints,
                                                       members=wm)))


def test_adjust_wisdem_matches_jax(tmp_path):
    """The fill volumes written back into a WISDEM geometry YAML, by the
    port's and the JAX driver's from the same adjusted spar design: the
    same document and the same file text."""
    yaml = pytest.importorskip("yaml")
    import raft_tpu
    from raft_tpu.drivers import adjust_wisdem as jadjust

    from raft_tpu_torch.models.model import Model

    with open(SPAR) as f:
        d = json.load(f)
    for mi in d["platform"]["members"]:
        if "l_fill" in mi:
            mi["l_fill"] = (np.atleast_1d(np.asarray(
                mi["l_fill"], dtype=float)) * 0.93).tolist()
    model = Model(d)
    old = tmp_path / "wisdem.yaml"
    old.write_text(yaml.safe_dump(_wisdem_yaml(model), sort_keys=False))
    got = drivers.adjust_wisdem(model, old, tmp_path / "port.yaml")
    want = jadjust(raft_tpu.Model(d), old, tmp_path / "jax.yaml")
    assert got == want
    assert (tmp_path / "port.yaml").read_text() == \
        (tmp_path / "jax.yaml").read_text()
    vols = [m["internal_structure"]["ballasts"][0]["volume"]
            for m in got["components"]["floating_platform"]["members"]
            if m["internal_structure"]]
    assert vols[0] != 1.0 and vols[-1] == 2.0


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


def test_iec_wind_matches_jax(tmp_path):
    """The IEC class parameters, turbulence models and extreme events of
    the port's copy against the JAX module, and the .wnd writer's text."""
    from raft_tpu.physics import iec_wind as jiec
    from raft_tpu_torch.physics import iec_wind as tiec

    assert tiec.TURBINE_CLASS_VREF == jiec.TURBINE_CLASS_VREF
    assert tiec.TURBULENCE_CLASS_IREF == jiec.TURBULENCE_CLASS_IREF
    t = tiec.IECWindExtreme("II", "A", z_hub=150.0, D=240.0)
    j = jiec.IECWindExtreme("II", "A", z_hub=150.0, D=240.0)
    for fn in ("NTM", "ETM", "EWM", "EOG", "EDC", "ECD", "EWS"):
        a, b = getattr(t, fn)(11.0), getattr(j, fn)(11.0)
        for x, y in zip(np.atleast_1d(a) if np.isscalar(a) else a,
                        np.atleast_1d(b) if np.isscalar(b) else b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=fn)
    cols = [np.linspace(0, 1, 5), np.linspace(3, 4, 5)]
    tiec.write_wnd(tmp_path / "t.wnd", cols, header_lines=["! a"])
    jiec.write_wnd(tmp_path / "j.wnd", cols, header_lines=["! a"])
    assert (tmp_path / "t.wnd").read_text() == (tmp_path / "j.wnd").read_text()


@pytest.mark.slow
def test_drivers_golden_regenerates():
    """golden_drivers.npz rebuilt by the live JAX package equals the
    checked-in file."""
    new = _mk().build_drivers_golden()
    old = drivers_golden()
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
