"""The port's full-physics evaluator against JAX.

Fast tier: ``make_full_evaluator`` on the CPU against the JAX goldens
(``golden_full_*.npz``: semi_wind with one wave heading, mhk_tidal and
the three demos with two headings and current, 8 rows each) under FUSED
on and off: every output key within 1e-10 x its max magnitude,
``status``, ``n_iter_drag`` and ``drag_converged`` bit-equal;
INPUT_CLIPPED exactly where an active rotor sees 0 < speed < 0.1;
chunking; the case-table helpers; the refusals that remain.  Slow tier:
the live JAX evaluator on those rows and the regeneration of every
fixture of the full path.

Every model is built by the port from ``design_*.json``.
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
from raft_tpu_torch.utils import health

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
SETS = {"semi_wind": 1, "mhk_tidal": 2, "spar": 2, "semi": 2, "mhk": 2}
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
TOL = 1e-10
EXACT = ("status", "n_iter_drag", "drag_converged")

_MODELS, _EVS = {}, {}


def design(name):
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        return json.load(f)


def model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(design(name))
    return _MODELS[name]


def evaluator(name):
    if name not in _EVS:
        _EVS[name] = tapi.make_full_evaluator(model(name), nWaves=SETS[name],
                                              device="cpu")
    return _EVS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_full_{name}.npz")))


def case_rows(cases, nWaves=1):
    """Parsed cases as evaluator rows through ``case_to_traced``: (R,)
    environment scalars and (R, nWaves) sea-state parameters."""
    rows = [tapi.case_to_traced(c, nWaves) for c in cases]
    return {k: np.stack([np.asarray(r[k], dtype=float) for r in rows])
            for k in ROW_KEYS}


def rows(g):
    return {k: g[k] for k in ROW_KEYS}


def hold(out, ref, pfx=""):
    """Every output key against the reference; the worst relative error
    per key."""
    worst = {}
    assert sorted(out) == sorted(tapi.FULL_OUT_KEYS)
    for k in tapi.FULL_OUT_KEYS:
        a = out[k].cpu().numpy()
        b = ref[pfx + k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= TOL * scale, f"{k}: {err:.3e} > {TOL} x {scale:.3e}"
        worst[k] = err / scale if scale else 0.0
    return worst


@pytest.mark.parametrize("name", sorted(SETS))
def test_full_matches_goldens(name, monkeypatch):
    """FUSED on and off (one evaluator: the flag is read per call)."""
    g = golden(name)
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        hold(evaluator(name)(**rows(g)), g, f"{fused}_")


@pytest.mark.parametrize("name", sorted(SETS))
def test_input_clipped_exactly_where_a_rotor_idles(name):
    """INPUT_CLIPPED on exactly the rows where a rotor with
    aeroServoMod > 0 sees 0 < speed < 0.1 (wind above water, current
    below), never on a design without one; the goldens agree."""
    g = golden(name)
    fs = model(name).fowtList[0]
    expect = np.zeros(len(g["Hs"]), dtype=bool)
    for rot, _ in zip(fs.rotors, model(name).rotor_aero):
        if rot.aeroServoMod > 0:
            v = g["current_speed"] if rot.Zhub < 0 else g["wind_speed"]
            expect |= (v > 0) & (v < 0.1)
    bit = (g["on_status"] & health.INPUT_CLIPPED) != 0
    np.testing.assert_array_equal(bit, expect)
    if name in ("semi_wind", "mhk_tidal"):
        assert expect.sum() == 1
    else:
        assert not expect.any()
    out = evaluator(name)(**rows(g))
    got = (out["status"].numpy() & health.INPUT_CLIPPED) != 0
    np.testing.assert_array_equal(got, expect)


def test_rotor_off_rows_carry_no_aero():
    """A rotor at zero speed is off: no aero load, no operating point."""
    g = golden("semi_wind")
    out = evaluator("semi_wind")(**rows(g))
    off = g["wind_speed"] == 0
    for k in ("f_aero0", "f_aero", "A00", "B00", "Omega_rpm", "pitch_deg"):
        assert np.all(out[k].numpy()[off] == 0), k
    assert np.all(out["Omega_rpm"].numpy()[~off] > 0)


def test_chunks_equal_one_batch(monkeypatch):
    g = golden("mhk_tidal")
    monkeypatch.setenv("RAFT_TPU_BUCKET_ROWS", "3")
    marks = []
    out = evaluator("mhk_tidal")(**rows(g), timer=marks.append)
    assert marks.count("start") == 3
    assert [m for m in marks[:6]] == ["start"] + list(tapi.FULL_STAGES)
    hold(out, g, "on_")


def test_scalars_and_single_heading_rows_broadcast():
    """Scalar environment values and (R,) sea states broadcast over rows
    and headings."""
    ev = evaluator("mhk_tidal")
    out = ev(current_speed=1.5, TI=0.1, Hs=[2.0, 3.0], Tp=[8.0, 9.0],
             beta_deg=0.0)
    assert out["Xi"].shape == (2, 3, 6, ev.nw)
    assert out["S"].shape == (2, 2, ev.nw)
    np.testing.assert_array_equal(out["S"][:, 0].numpy(),
                                  out["S"][:, 1].numpy())
    with pytest.raises(ValueError, match=r"expected \(R, 2\)"):
        ev(Hs=np.ones((2, 3)), Tp=np.ones((2, 3)))
    with pytest.raises(TypeError, match="unknown row parameters"):
        ev(Hs=1.0, Tp=5.0, wave_height=1.0)


def test_case_table_helpers_match_jax():
    """``case_to_traced`` and ``case_in_traced_domain`` against the JAX package's on the demo case tables."""
    from raft_tpu.api import case_in_traced_domain as jdomain
    from raft_tpu.api import case_to_traced as jtraced

    cases = []
    for name in ("spar", "semi", "mhk", "semi_wind"):
        cases += model(name).cases
    extra = dict(cases[0], wave_heading=[0.0, 30.0], wave_height=[2.0, 1.0],
                 wave_period=[8.0, 6.0], wave_spectrum=["JONSWAP"] * 2)
    for c in cases + [dict(cases[0], turbulence="IB_NTM"),
                      dict(cases[0], turbine_status="parked"), extra]:
        assert tapi.case_in_traced_domain(c) == jdomain(c)
    for c in cases:
        a, b = tapi.case_to_traced(c), jtraced(c)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    r = case_rows([extra, extra], nWaves=2)
    assert r["Hs"].shape == (2, 2) and r["wind_speed"].shape == (2,)


def test_design_case_rows_evaluate():
    """A design's own case table through case_to_traced into the
    evaluator."""
    m = model("semi_wind")
    r = case_rows(m.cases)
    out = evaluator("semi_wind")(**r)
    assert out["X0"].shape == (len(m.cases), 6)
    assert np.all(np.isfinite(out["Xi"].numpy()))


def test_refusals_by_message():
    """What the full path still refuses: the geometry axis of a design
    with coefficient files (the reference's ValueError), beams, arrays
    (which the farm evaluator takes); an external QTF, which the full
    path takes, is refused by the case path without reading its file.
    Gradients through the aero stage's inputs, once refused, flow."""
    from raft_tpu_torch.structure import bucketing as tb

    d = design("spar")
    bem = copy.deepcopy(d)
    bem["platform"]["potFirstOrder"] = 1
    bem["platform"]["hydroPath"] = "spar_bem"
    with pytest.raises(ValueError, match=r"WAMIT files.*hydroPath"):
        tapi.make_full_evaluator(Model(bem), device="cpu", geometry=True)
    qtf = copy.deepcopy(d)
    qtf["platform"]["potSecOrder"] = 2
    qtf["platform"]["hydroPath"] = "semi_wind_qtf"
    qtf_model = Model(qtf, base_dir=FIX)
    with pytest.raises(tb.UnbucketableDesignError, match=r"QTF.*ROADMAP A13"):
        tapi.make_case_evaluator(qtf_model, device="cpu")
    assert not hasattr(qtf_model, "_qtf")
    beam = copy.deepcopy(d)
    beam["platform"]["members"][0]["type"] = "beam"
    with pytest.raises(NotImplementedError,
                       match=r"make_flexible_evaluator.*ROADMAP A11"):
        tapi.make_full_evaluator(Model(beam), device="cpu")
    arr = copy.deepcopy(d)
    arr["array"] = {"keys": ["ID", "turbineID", "platformID", "mooringID",
                             "x_location", "y_location"],
                    "data": [[1, 1, 1, 1, 0, 0], [2, 1, 1, 1, 2000, 0]]}
    with pytest.raises(ValueError, match=r"array.*make_farm_evaluator"):
        tapi.make_full_evaluator(Model(arr), device="cpu")
    # the aero stage's inputs are differentiable (they once raised here)
    U = torch.tensor([8.0], dtype=torch.float64, requires_grad=True)
    out = evaluator("semi_wind")(wind_speed=U, Hs=4.0, Tp=9.0)
    g, = torch.autograd.grad((out["Xi"][:, 0].abs() ** 2).sum()
                             + (out["X0"] ** 2).sum(), U)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.make_full_evaluator(model("mhk"))


def _jax_full(name, fused, monkeypatch):
    import jax

    import raft_tpu
    from raft_tpu.api import make_full_evaluator

    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    ev = make_full_evaluator(raft_tpu.Model(design(name)), nWaves=SETS[name])
    out = jax.jit(jax.vmap(ev))(rows(golden(name)))
    return {f"{fused}_{k}": np.asarray(v) for k, v in out.items()}


@pytest.mark.slow
@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_live_jax_full(name, fused, monkeypatch):
    """The port against the JAX full evaluator traced live."""
    ref = _jax_full(name, fused, monkeypatch)
    hold(evaluator(name)(**rows(golden(name))), ref, f"{fused}_")


@pytest.mark.slow
def test_full_fixtures_regenerate():
    """Every fixture of the full path, rebuilt from the JAX package,
    equals the checked-in file (designs byte for byte)."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    for name, fn in mk.ROTOR_DESIGNS.items():
        assert fn() == design(name), name
        for kind, build in (("rotor", mk.build_rotor_fixture),
                            ("packed", mk.build_rotor_packed),
                            ("golden_aero", mk.build_aero_golden)):
            new = build(name)
            old = dict(np.load(os.path.join(FIX, f"{kind}_{name}.npz")))
            assert sorted(new) == sorted(old)
            for k in old:
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    for name in SETS:
        new = mk.build_full_golden(name)
        old = golden(name)
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
