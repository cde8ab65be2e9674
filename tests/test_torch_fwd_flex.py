"""Forward mode through the port's flexible (N-DOF beam) evaluator
against JAX: ``golden_jvp_flex_semi_wind.npz`` (semi_wind_flex, nDOF
168, the rows of ``golden_grad_flex_semi_wind.npz``, two seeded
directions over every row input; then its geometry axis with the
struct_params of the tower rebuilt at d x 0.9, t x 1.1, the directions
over the row inputs and every struct_params leaf, the complex ones as
real and imaginary parts), by ``tests/test_torch_fwd.py``'s
``check_tangents``.

The tangents pass the N = 168 statics and response solves
(``torch.linalg.solve`` here and its forward AD, ``jnp.linalg.solve``
in the reference: pivoted LU of two libraries), so they are held at the
flexible gradients' gate, 1e-7 x each key's max|tangent|
(``tests/test_torch_grad_flex.py`` GRAD_GATE, ROADMAP §C), not 1e-9:
the keys past those solves differ by the libraries' rounding times
kappa(Z), up to 2.72e10 over these rows.  ``torch.func.jacfwd`` of
the response metric by the row inputs is held against
``golden_grad_flex_semi_wind.npz`` at the same gate in
``test_torch_fwd_flex_jacfwd.py`` (about two minutes: in a file of its
own pytest-xdist's ``--dist loadfile`` runs it beside these)."""

import os

import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from test_torch_fwd import (FIX, check_tangents, golden,  # noqa: F401
                            one_thread)
from test_torch_grad_flex import GRAD_GATE, mk

ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
_STATE = {}


def _model():
    if "m" not in _STATE:
        _STATE["m"] = Model(os.path.join(FIX, "design_semi_wind_flex.json"))
        _STATE["g"] = golden("flex_semi_wind")
    return _STATE["m"], _STATE["g"]


def test_flex_tangents_match_golden():
    m, g = _model()
    ev = tapi.make_flexible_evaluator(m, device="cpu")
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    check_tangents(lambda x: ev(**x), x, g, "", tol=GRAD_GATE)


def test_flex_geometry_tangents_match_golden():
    """The struct_params leaves of golden_grad_flex_semi_wind.npz's
    geometry rows (their directions drawn again from the seed)."""
    import numpy as np

    m, g = _model()
    gg = dict(np.load(os.path.join(FIX, "golden_grad_flex_semi_wind.npz")))
    ev = tapi.make_flexible_evaluator(m, device="cpu", geometry=True)
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    x.update({k[4:]: torch.tensor(v) for k, v in gg.items()
              if k.startswith("geo_sp.")})

    def fn(x):
        return ev(struct_params=mk._tree_struct_params(x),
                  **{k: x[k] for k in ROW_KEYS})

    check_tangents(fn, x, g, "geo_", tol=GRAD_GATE)
