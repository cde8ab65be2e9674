"""Forward mode through the port's geometry design axis
(``make_full_evaluator(geometry=True)``) against JAX:
``golden_jvp_geometry_<set>.npz`` (spar, semi and semi_wind, the rows of
``golden_grad_<set>.npz``, two seeded directions over every geometry
key), by ``tests/test_torch_fwd.py``'s ``check_tangents``: each float
key's tangent within 1e-9 x its max|tangent|, every output under the
transform bit-equal to the plain call, forward and reverse mode
agreeing.  FUSED on and off where they differ: with two wave headings
(spar, semi) the response is staged either way, and the goldens' on and
off tangents are equal."""

import pytest
import torch

from raft_tpu_torch import api as tapi
from test_torch_fwd import (check_tangents, golden, model,  # noqa: F401
                            one_thread)

#: wave headings of each geometry set (tests/test_torch_grad.py)
SETS = {"spar": 2, "semi": 2, "semi_wind": 1}


@pytest.mark.parametrize("name", sorted(SETS))
def test_geometry_tangents_match_goldens(name, monkeypatch):
    g = golden(f"geometry_{name}")
    ev = tapi.make_full_evaluator(model(name), nWaves=SETS[name],
                                  device="cpu", geometry=True)
    rows = {k: torch.tensor(g[k]) for k in tapi.ENV_KEYS + tapi.SEA_KEYS}
    x = {k[5:]: torch.tensor(v) for k, v in g.items()
         if k.startswith("geom_")}
    for fused in ("on", "off") if SETS[name] == 1 else ("on",):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        check_tangents(lambda x: ev(geom=x, **rows), x, g, f"{fused}_",
                       reverse=fused == "on")
