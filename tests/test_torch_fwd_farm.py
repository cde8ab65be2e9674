"""Forward mode through the port's farm evaluator against JAX:
``golden_jvp_farm_semi_wind.npz`` (the two-unit shared-mooring farm on
the rows of ``golden_grad_farm_semi_wind.npz``, two seeded directions
over every row input, per-unit wind speeds included), by
``tests/test_torch_fwd.py``'s ``check_tangents``: the coupled statics
attach by their implicit rule with the free buoy attached by its own
(``MooringNetwork.attach_free_points``), and ``FarmMooring.parts`` hands
the system response the stiffness at the attached pose, tangents
included.  The ``jvp`` over inputs that require grad gives the
reverse gradient too (as ``chip_smoke.py``'s farm warm-up takes it),
held against the tangent.  Then ``torch.func.jacfwd`` of the response
metric by every row input against ``golden_grad_farm_semi_wind.npz``
(1e-9 x max|g|)."""

import os

import numpy as np
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from test_torch_fwd import (FIX, check_tangents, golden,  # noqa: F401
                            hold_jacfwd, one_thread, row_jacfwd)

ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
_EV = {}


def evaluator():
    if "ev" not in _EV:
        _EV["ev"] = tapi.make_farm_evaluator(
            Model(os.path.join(FIX, "design_farm_semi_wind.json")),
            nWaves=1, device="cpu")
    return _EV["ev"]


def test_farm_tangents_match_golden():
    g = golden("farm_semi_wind")
    ev = evaluator()
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    check_tangents(lambda x: ev(**x), x, g, "")


def test_farm_jacfwd():
    g = dict(np.load(os.path.join(FIX, "golden_grad_farm_semi_wind.npz")))
    ev = evaluator()
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    hold_jacfwd(row_jacfwd(lambda x: ev(**x), x), g, "")
