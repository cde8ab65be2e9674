"""Forward mode through the port's full evaluator with an active rotor
against JAX: ``golden_jvp_aero_<set>.npz`` (semi_wind, a rotor in air,
and mhk_tidal, a submerged one; the rows of
``golden_grad_aero_<set>.npz``, two seeded directions over every row
input), FUSED on and off (on only with mhk_tidal's two headings, whose
response is staged either way), by ``tests/test_torch_fwd.py``'s
``check_tangents``.  The blade-element root enters by its implicit
rule (``physics/aero.py`` ``_RootPhi.jvp``), never through its
bisection.  Then the external-QTF design (``golden_jvp_qtf_semi_wind.npz``,
semi_wind_qtf on the same semi_wind rows): the mean drift's second
equilibrium attaches by the statics' implicit rule as the first does."""

import os

import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from test_torch_fwd import (FIX, check_tangents, golden, model,  # noqa: F401
                            one_thread)

SETS = {"semi_wind": 1, "mhk_tidal": 2}


@pytest.mark.parametrize("name", sorted(SETS))
def test_aero_tangents_match_goldens(name, monkeypatch):
    g = golden(f"aero_{name}")
    ev = tapi.make_full_evaluator(model(name), nWaves=SETS[name],
                                  device="cpu")
    x = {k: torch.tensor(g[k]) for k in tapi.ENV_KEYS + tapi.SEA_KEYS}
    for fused in ("on", "off") if SETS[name] == 1 else ("on",):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        check_tangents(lambda x: ev(**x), x, g, f"{fused}_",
                       reverse=fused == "on")


def test_qtf_tangents_match_golden(monkeypatch):
    g = golden("qtf_semi_wind")
    ev = tapi.make_full_evaluator(
        Model(os.path.join(FIX, "design_semi_wind_qtf.json")), device="cpu")
    x = {k: torch.tensor(g[k]) for k in tapi.ENV_KEYS + tapi.SEA_KEYS}
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        check_tangents(lambda x: ev(**x), x, g, f"{fused}_",
                       reverse=fused == "on")
