"""The frequency (``sp``) axis of the port's meshes and their entry
threads (``raft_tpu_torch/parallel/sweep.py``,
``raft_tpu_torch/parallel/freq.py``) on CPU meshes, against the JAX
package's ``sweep_cases_full(..., shard_freq=True)``.

* ``make_mesh(4, ("dp", "sp"), device="cpu")``, a (dp, sp) = (2, 2)
  mesh, holds ``golden_mesh_full_{spar,semi_wind}.npz`` (the JAX sweep
  on a (2, 2) CPU mesh, ``tests/make_torch_port_fixtures.py --mesh``)
  within 1e-10 x each key's max, ``status`` and ``n_iter_drag`` equal;
  each entry ran its dp block on its frequency slice; the port's own
  one-entry result holds the same goldens and the (2, 2) result at the
  same gate, and a second (2, 2) run repeats the bits;
* the farm, flexible, external-QTF and WAMIT-file evaluators on
  (dp, sp) = (1, 2) hold their own goldens at their own gates (the
  flexible keys past its N = 108-168 LAPACK solves at kappa eps,
  ROADMAP §C), every output key gathered;
* a checkpointed ``shard_freq`` sweep on a (2, 2) mesh cut after its
  first shard and resumed gives the uninterrupted sweep's bits;
* the slices (``np.array_split`` sizes, the larger first), the gather of
  a toy evaluator's frequency slices, the entries' own evaluators, a
  thread's error failing the call and a coupling missed by one entry
  failing its group at once instead of hanging it.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.parallel import freq
from raft_tpu_torch.parallel import sweep as tsweep

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
TOL = 1e-10
EXACT = ("status", "n_iter_drag", "drag_converged")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
MESH_KEYS = ("PSD", "Xi", "X0", "status", "n_iter_drag")
N_WAVES = {"spar": 2, "semi_wind": 1}
#: the flexible evaluator's gates (tests/test_torch_flexible.py): the
#: keys past its LAPACK solves at kappa(Z) eps, X0 at kappa(K) eps
EPS = float(np.finfo(np.float64).eps)
FLEX_GATES = {"Xi": 2.72e10 * EPS, "PSD": 2.72e10 * EPS,
              "drag_resid": 2.72e10 * EPS, "X0": 2.80e9 * EPS}

_EVS = {}


def near(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def hold(out, ref, pfx="", keys=None, gates=None):
    for k in keys or out:
        if k in EXACT:
            np.testing.assert_array_equal(out[k], ref[pfx + k], err_msg=k)
        else:
            near(out[k], ref[pfx + k], (gates or {}).get(k, TOL), k)


def sp_mesh(dp, sp):
    """A (dp, sp) mesh of CPU entries."""
    return tsweep.Mesh(tsweep.device_array(["cpu"] * (dp * sp), (dp, sp)),
                       ("dp", "sp"))


def full_evaluator(name):
    if name not in _EVS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _EVS[name] = tapi.make_full_evaluator(
                Model(json.load(f)), nWaves=N_WAVES[name], device="cpu")
    return _EVS[name]


def golden(name):
    return dict(np.load(os.path.join(FIX, f"{name}.npz")))


@pytest.mark.parametrize("name", sorted(N_WAVES))
def test_freq_split_holds_jax_shard_freq_goldens(name):
    g = golden(f"golden_mesh_full_{name}")
    ev = full_evaluator(name)
    rows = {k: g[k] for k in ROW_KEYS}
    mesh = tsweep.make_mesh(4, ("dp", "sp"), device="cpu")
    assert mesh.shape == {"dp": 2, "sp": 2}
    out = tsweep.sweep_cases_full(ev, rows, mesh=mesh, out_keys=MESH_KEYS,
                                  shard_freq=True)
    hold(out, g)
    assert [(e["dp"], e["sp"], e["rows"], e["freq"])
            for e in tsweep.last_entries()] == [
                (0, 0, (0, 4), (0, 20)), (0, 1, (0, 4), (20, 40)),
                (1, 0, (4, 8), (0, 20)), (1, 1, (4, 8), (20, 40))]
    one = tsweep.sweep_cases_full(ev, rows,
                                  mesh=tsweep.make_mesh(device="cpu"),
                                  out_keys=MESH_KEYS, shard_freq=True)
    hold(one, g)
    hold(out, one)
    again = tsweep.sweep_cases_full(ev, rows, mesh=mesh, out_keys=MESH_KEYS,
                                    shard_freq=True)
    for k in MESH_KEYS:
        np.testing.assert_array_equal(again[k], out[k], err_msg=k)


def _farm():
    m = Model(os.path.join(FIX, "design_farm_semi_wind.json"), base_dir=FIX)
    return (tapi.make_farm_evaluator(m, nWaves=1, device="cpu"),
            golden("golden_farm_semi_wind"), "", "on_", tapi.FARM_OUT_KEYS,
            None)


def _flex():
    with open(os.path.join(FIX, "design_semi_wind_flex.json")) as f:
        m = Model(json.load(f))
    return (tapi.make_flexible_evaluator(m, nWaves=1, device="cpu"),
            golden("golden_flex_semi_wind"), "", "on_", tapi.FLEX_OUT_KEYS,
            FLEX_GATES)


def _qtf():
    m = Model(os.path.join(FIX, "design_semi_wind_qtf.json"))
    return (tapi.make_full_evaluator(m, nWaves=2, device="cpu"),
            golden("golden_semi_wind_qtf"), "h2_", "h2_on_",
            tapi.FULL_OUT_KEYS, None)


def _wamit():
    m = Model(os.path.join(FIX, "design_semi_wind_wamit.json"))
    return (tapi.make_full_evaluator(m, nWaves=1, device="cpu"),
            golden("golden_bem_semi_wind_wamit"), "h1_", "h1_on_",
            tapi.FULL_OUT_KEYS, None)


@pytest.mark.parametrize("case", ["farm", "flex", "qtf", "wamit"])
def test_freq_split_holds_each_evaluators_goldens(case):
    ev, g, row_pfx, pfx, keys, gates = {
        "farm": _farm, "flex": _flex, "qtf": _qtf, "wamit": _wamit}[case]()
    rows = {k: g[row_pfx + k] for k in ROW_KEYS}
    out = tsweep.sweep_cases_full(ev, rows, mesh=sp_mesh(1, 2),
                                  out_keys=keys, shard_freq=True)
    hold(out, g, pfx, keys, gates)
    assert [e["freq"] for e in tsweep.last_entries()] == [(0, 20), (20, 40)]


def test_resumed_freq_split_sweep_repeats_the_bits(tmp_path):
    g = golden("golden_mesh_full_spar")
    ev = full_evaluator("spar")
    rows = {k: g[k] for k in ROW_KEYS}
    mesh = sp_mesh(2, 2)
    whole = tsweep.run_sweep_checkpointed_full(
        ev, rows, str(tmp_path / "whole"), shard_size=4, mesh=mesh,
        out_keys=MESH_KEYS, shard_freq=True)
    hold(whole, g)

    def cut(done, total, fresh):
        if done == 1:
            raise KeyboardInterrupt("preempted after the first shard")

    with pytest.raises(KeyboardInterrupt):
        tsweep.run_sweep_checkpointed_full(
            ev, rows, str(tmp_path / "cut"), shard_size=4, mesh=mesh,
            out_keys=MESH_KEYS, shard_freq=True, on_shard=cut)
    assert sorted(os.listdir(tmp_path / "cut")).count("shard_0000.npz") == 1
    assert "shard_0001.npz" not in os.listdir(tmp_path / "cut")
    resumed = tsweep.run_sweep_checkpointed_full(
        ev, rows, str(tmp_path / "cut"), shard_size=4, mesh=mesh,
        out_keys=MESH_KEYS, shard_freq=True)
    for k in MESH_KEYS:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


class Toy(torch.nn.Module):
    """A frequency-resolved toy: PSD (R, 6) = Hs w and X0 = Hs sum(w)
    over the grid w = 0..5; ``skew`` makes sp entry 1 reduce once more
    than its peers (a coupling the others miss)."""

    nw = 6

    def __init__(self, skew=False):
        super().__init__()
        self.skew = skew

    def forward(self, Hs):
        w = freq.take(torch.arange(6.0, dtype=torch.float64))
        psd = Hs[:, None] * w
        s = freq.current()
        if self.skew and s is not None and s.index == 1:
            freq.wsum(psd, dim=-1)
        return {"PSD": psd, "X0": freq.wsum(psd, dim=-1),
                "status": torch.zeros(Hs.shape, dtype=torch.int32)}


def test_slices_gather_and_entry_failures(monkeypatch):
    # the reference's split: (nw + 1) // 2 and nw // 2 bins
    assert freq.slices(41, 2) == [(0, 21), (21, 41)]
    assert freq.slices(40, 3) == [(0, 14), (14, 27), (27, 40)]
    with pytest.raises(ValueError, match="at least one frequency"):
        freq.slices(2, 3)
    Hs = np.arange(1.0, 5.0)
    out = tsweep.sweep_cases_full(Toy(), {"Hs": Hs}, mesh=sp_mesh(2, 3),
                                  out_keys=("PSD", "X0", "status"),
                                  shard_freq=True)
    np.testing.assert_array_equal(out["PSD"], Hs[:, None] * np.arange(6.0))
    np.testing.assert_array_equal(out["X0"], 15.0 * Hs)
    assert [e["freq"] for e in tsweep.last_entries()] == [
        (0, 2), (2, 4), (4, 6)] * 2
    # a coupling one entry makes and its peers miss fails the group at
    # once (the finished peers leave it), never hanging it
    monkeypatch.setattr(freq, "WAIT_S", 60.0)
    with pytest.raises(freq.GroupBroken):
        tsweep.sweep_cases_full(Toy(skew=True), {"Hs": Hs},
                                mesh=sp_mesh(1, 2), out_keys=("X0",),
                                shard_freq=True)

    def fails(Hs):
        if float(Hs[0]) > 2.0:
            raise ArithmeticError("block 1 failed")
        return {"X0": Hs}

    with pytest.raises(ArithmeticError, match="block 1 failed"):
        tsweep.sweep_cases_full(fails, {"Hs": Hs}, mesh=sp_mesh(2, 1),
                                out_keys=("X0",))

    class Fails(Toy):
        def forward(self, Hs):
            if freq.current().index == 1:
                raise ArithmeticError("sp entry 1 failed")
            return super().forward(Hs)

    # an sp group's thread that fails fails the call, its peer released
    with pytest.raises(ArithmeticError, match="sp entry 1 failed"):
        tsweep.sweep_cases_full(Fails(), {"Hs": Hs}, mesh=sp_mesh(1, 2),
                                out_keys=("X0",), shard_freq=True)


def test_entries_of_one_device_get_their_own_evaluators():
    ev = full_evaluator("spar")
    twins = [tsweep.bind_evaluator(ev, "cpu", slot) for slot in range(3)]
    assert twins[0] is ev
    assert len({id(t) for t in twins}) == 3
    assert tsweep.bind_evaluator(ev, "cpu", 2) is twins[2]
