"""The port's farm evaluator against JAX.

Fast tier: ``make_farm_evaluator`` on the CPU against the JAX goldens
(``golden_farm_*.npz``, 8 rows each): the two-unit semi_wind farm with
its shared line over a free buoy (nT = 12, the solve kernel's largest
size) under FUSED on, the three-spar farm (nT = 18, headings 0, 120 and
240 deg, ``torch.linalg.solve``) under FUSED on and off; every output
key within 1e-10 x its max, ``status`` and the per-unit ``n_iter_drag``
bit-equal.  A scalar wind speed against the same per-unit speeds; the
array builder against the JAX builder (unit placement, headings,
moorings, tolerances); the refusals that remain.  Slow tier: the
semi_wind farm under FUSED off (the farm has no fused path, so the two
goldens are the same: about 20 s per setting here), and the
regeneration of the farm fixtures by the live JAX evaluator.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.models.statics_solve import make_tolerances

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
SETS = {"semi_wind": 1, "spar3": 2}
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
TOL = 1e-10
EXACT = ("status", "n_iter_drag")

_MODELS, _EVS = {}, {}


def design(name):
    with open(os.path.join(FIX, f"design_farm_{name}.json")) as f:
        return json.load(f)


def model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(design(name), base_dir=FIX)
    return _MODELS[name]


def evaluator(name):
    if name not in _EVS:
        _EVS[name] = tapi.make_farm_evaluator(model(name), nWaves=SETS[name],
                                              device="cpu")
    return _EVS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_farm_{name}.npz")))


def hold(out, ref, pfx):
    assert sorted(out) == sorted(tapi.FARM_OUT_KEYS)
    for k in tapi.FARM_OUT_KEYS:
        a = out[k].cpu().numpy()
        b = ref[pfx + k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= TOL * scale, f"{k}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("name,fused", [
    ("semi_wind", "on"),
    pytest.param("semi_wind", "off", marks=pytest.mark.slow),
    ("spar3", "on"), ("spar3", "off")])
def test_farm_matches_goldens(name, fused, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    g = golden(name)
    hold(evaluator(name)(**{k: g[k] for k in ROW_KEYS}), g, f"{fused}_")


def test_goldens_cover_the_status_bits():
    """The semi_wind goldens: the row whose downstream unit sees 0.05 m/s
    carries INPUT_CLIPPED (its wind is clamped to 0.1), the others none;
    both farms' status words agree with FUSED on and off."""
    from raft_tpu_torch.utils import health

    for name in SETS:
        g = golden(name)
        np.testing.assert_array_equal(g["on_status"], g["off_status"])
    g = golden("semi_wind")
    ws = g["wind_speed"]
    expect = np.any((ws > 0) & (ws < 0.1), axis=1)
    assert expect.sum() == 1
    np.testing.assert_array_equal(
        (g["on_status"] & health.INPUT_CLIPPED) != 0, expect)


def test_scalar_wind_is_every_units_speed():
    """A wind speed per row (or one for all rows) is every unit's: the
    rows parse to the same (R, nFOWT) speeds as equal columns do, and
    the aero stage, the only one that reads them, gives the same
    terms."""
    g = golden("semi_wind")
    rows = {k: g[k][4:6] for k in ROW_KEYS}
    ev = evaluator("semi_wind")
    U = rows["wind_speed"][:, 0]
    per_unit, _ = ev._rows(dict(rows, wind_speed=np.stack([U, U], axis=1)))
    per_row, _ = ev._rows(dict(rows, wind_speed=U))
    for k in ROW_KEYS:
        np.testing.assert_array_equal(per_row[k].numpy(),
                                      per_unit[k].numpy(), err_msg=k)
    assert per_row["wind_speed"].shape == (2, 2)
    one, n = ev._rows(dict(rows, wind_speed=U[0]))
    assert n == 2 and torch.all(one["wind_speed"] == U[0])
    for a, b in zip(ev._aero(per_row, 2), ev._aero(per_unit, 2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", sorted(SETS))
def test_array_model_matches_jax_builder(name):
    """The port's array mode against the JAX Model's: units at their
    x_ref / y_ref / heading_adjust with the same nodes, strip axes and
    rotor nodes, the same unit moorings (anchors moved and turned) and
    shared network, DOF offsets and statics tolerances."""
    import raft_tpu
    from raft_tpu.models.statics_solve import make_tolerances as jtol

    t, j = model(name), raft_tpu.Model(design(name), base_dir=FIX)
    assert (t.nFOWT, t.nDOF) == (j.nFOWT, j.nDOF)
    np.testing.assert_array_equal(t.dof_offsets, j.dof_offsets)
    for ft, fj, ht, hj in zip(t.fowtList, j.fowtList, t.hydro, j.hydro):
        assert (ft.x_ref, ft.y_ref, ft.heading_adjust) == (
            fj.x_ref, fj.y_ref, fj.heading_adjust)
        np.testing.assert_array_equal(ft.node_r0, fj.node_r0)
        np.testing.assert_array_equal(ft.rotor_node, fj.rotor_node)
        for k in ("q0", "p10", "p20", "ls", "ds"):
            np.testing.assert_array_equal(getattr(ht.strips, k),
                                          np.asarray(getattr(hj.strips, k)),
                                          err_msg=k)
    for mt, mj in zip(t.ms_list, j.ms_list):
        for k in ("r_anchor", "r_fair0", "L", "w", "EA"):
            np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k),
                                          err_msg=k)
    assert (t.ms_array is None) == (j.ms_array is None)
    for a, b in zip(make_tolerances(t.fowtList), jtol(j.fowtList)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if name == "spar3":
        # heading_adjust turns the anchors about the unit (the spar's one
        # column lies on its own axis)
        c, s = np.cos(np.deg2rad(120.0)), np.sin(np.deg2rad(120.0))
        a0 = t.ms_list[0].r_anchor[0]
        np.testing.assert_allclose(
            t.ms_list[1].r_anchor[0] - [2000.0, 0.0, 0.0],
            [c * a0[0] - s * a0[1], s * a0[0] + c * a0[1], a0[2]], atol=1e-9)


def _unit_refusals():
    def beam(d):
        d["platform"]["members"][0]["type"] = "beam"

    def pot_mod(d):
        d["platform"]["potModMaster"] = 2

    def qtf(d):
        d["platform"]["potSecOrder"] = 2
        d["platform"]["hydroPath"] = "semi_wind_qtf"

    def moor_mod(d):
        d["mooring"]["moorMod"] = 2

    return {f.__name__: f for f in (beam, pot_mod, qtf, moor_mod)}


@pytest.mark.parametrize("variant", sorted(_unit_refusals()))
def test_array_refusals(variant):
    """What the reference's farm evaluator refuses still raises, naming
    its ROADMAP item and Model.analyze_cases, which takes such arrays:
    beam (flexible) units and potential-flow units (A11) and an external
    QTF (A13) build, and the farm evaluator refuses them, as the
    reference's does (the potential-flow units without running the panel
    solver, the QTF without reading its file).  Units with line dynamics
    (moorMod 2) build and the farm evaluator, which never reads moorMod,
    gives the bits of the same array at moorMod 0."""
    d = copy.deepcopy(design("spar3"))
    _unit_refusals()[variant](d)
    if variant in ("beam", "pot_mod", "qtf"):
        item = {"beam": "A11", "pot_mod": "A11", "qtf": "A13"}[variant]
        model = Model(d, base_dir=FIX)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP {item}.*analyze_cases"):
            tapi.make_farm_evaluator(model, device="cpu")
        assert not hasattr(model, "_qtf")
        return
    assert variant == "moor_mod"
    m2 = Model(d, base_dir=FIX)
    assert all(ms.moorMod == 2 for ms in m2.ms_list)
    g = golden("spar3")
    rows = {k: g[k][:2] for k in ROW_KEYS}
    out = tapi.make_farm_evaluator(m2, nWaves=2, device="cpu")(**rows)
    ref = evaluator("spar3")(**rows)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_farm_raises_without_cuda_and_is_forward_only(monkeypatch):
    """No card and no device: the farm evaluator raises naming
    device="cpu".  An input that requires grad (refused while the farm
    was forward only) gives a finite gradient, here through the three
    units' system response at nT = 18 (the library's solve and its
    adjoint)."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tapi.make_farm_evaluator(model("spar3"))
    Hs = torch.tensor([2.0, 3.0], dtype=torch.float64, requires_grad=True)
    out = evaluator("spar3")(Hs=Hs[:, None].expand(2, 2), Tp=8.0)
    g, = torch.autograd.grad((out["Xi"][:, 0].abs() ** 2).sum(), Hs)
    assert bool(torch.isfinite(g).all()) and bool(torch.all(g > 0))


@pytest.mark.slow
def test_farm_fixtures_regenerate():
    """Every farm fixture, rebuilt from the JAX package, equals the
    checked-in file (designs and the shared-line file byte for byte)."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    with open(os.path.join(FIX, "farm_shared.dat")) as f:
        assert f.read() == mk.FARM_SHARED_DAT
    for name, fn in mk.FARM_DESIGNS.items():
        assert fn() == design(name), name
        new = mk.build_farm_golden(name)
        old = golden(name)
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    new = mk.build_network_golden(golden("semi_wind")["on_X0"])
    old = dict(np.load(os.path.join(FIX, "golden_network_semi_wind.npz")))
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
