"""``torch.func.jacfwd`` of the response metric sum |Xi[0]|^2 + sum X0^2
through every evaluator against the ``jax.grad`` goldens
``golden_grad_*.npz``, at their gates (1e-9 x each key's max|g|; the
flexible path 1e-7): the evaluator runs once, with one direction per
element of a row's inputs batched through it (a perturbation shared by
the rows, which are independent), each solve's directions folded into
one tangent solve by its vmap rule.  The design demos FUSED off (the
spar's FUSED on is ``tests/test_torch_fwd.py``'s fault test); the
geometry and aero sets FUSED on (their FUSED-off forward mode is held
by the jvp goldens).  The farm's, the flexible rows' (not the geometry
axis' struct_params leaves, about 65,000 a row: the jvp golden's
directions hold those) and the potential-flow d_scale's are in
``tests/test_torch_fwd_farm.py``, ``_flex.py`` and ``_bem.py``."""

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from test_torch_fwd import (FIX, hold_jacfwd, model, one_thread,  # noqa: F401
                            row_jacfwd)
from test_torch_grad import DESIGN_KEYS

ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS


def grad_golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_grad_{name}.npz")))


@pytest.mark.parametrize("name", ["spar", "semi", "mhk"])
def test_design_jacfwd(name, monkeypatch):
    g = grad_golden(f"design_{name}")
    ev = tapi.make_design_evaluator(model(name), device="cpu")
    x = {k: torch.tensor(g[k]) for k in DESIGN_KEYS}
    monkeypatch.setenv("RAFT_TPU_FUSED", "off")
    hold_jacfwd(row_jacfwd(lambda x: ev(**x), x), g, "off_")


@pytest.mark.parametrize("name,nWaves", [("spar", 2), ("semi", 2),
                                         ("semi_wind", 1)])
def test_geometry_jacfwd(name, nWaves):
    g = grad_golden(name)
    ev = tapi.make_full_evaluator(model(name), nWaves=nWaves, device="cpu",
                                  geometry=True)
    rows = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    x = {k[5:]: torch.tensor(v) for k, v in g.items()
         if k.startswith("geom_")}
    hold_jacfwd(row_jacfwd(lambda x: ev(geom=x, **rows), x), g, "on_")


@pytest.mark.parametrize("name,nWaves", [("semi_wind", 1),
                                         ("mhk_tidal", 2)])
def test_aero_jacfwd(name, nWaves):
    g = grad_golden(f"aero_{name}")
    ev = tapi.make_full_evaluator(model(name), nWaves=nWaves, device="cpu")
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    hold_jacfwd(row_jacfwd(lambda x: ev(**x), x), g, "on_")
