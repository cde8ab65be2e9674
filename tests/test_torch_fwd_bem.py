"""Forward mode through a potential-flow design's geometry axis against
JAX: ``golden_jvp_bem_semi_wind_coarse.npz`` (the coarse panel copy of
semi_wind on the rows of ``golden_grad_bem_semi_wind_coarse.npz``, one
uniform d_scale each, 0.95, 1.0 and 1.05, two seeded directions over
d_scale and every row input), FUSED on and off, by
``tests/test_torch_fwd.py``'s ``check_tangents``: a d_scale that carries
a tangent takes the quadratic interpolation of the coefficients at 1
too (its derivative there is not 0).  Then ``torch.func.jacfwd`` of the
response metric against the gradient golden.  The panel solves (the
design's and the two off-unit scales', about 10 s each on the CPU) run
once into a temporary cache."""

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from test_torch_fwd import FIX, check_tangents, golden, hold_jacfwd, \
    one_thread, row_jacfwd  # noqa: F401

ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS


@pytest.fixture(scope="module")
def geo(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_BEM_DIR", str(tmp_path_factory.mktemp("bem")))
        m = Model(os.path.join(FIX, "design_semi_wind_bem_coarse.json"))
        yield tapi.make_full_evaluator(m, device="cpu", geometry=True)


def _fn(geo):
    def fn(x):
        return geo(geom=dict(d_scale=x["d_scale"]),
                   **{k: x[k] for k in ROW_KEYS})
    return fn


def test_d_scale_tangents_match_golden(geo, monkeypatch):
    g = golden("bem_semi_wind_coarse")
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS + ("d_scale",)}
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        check_tangents(_fn(geo), x, g, f"{fused}_", reverse=fused == "on")


def test_d_scale_jacfwd_matches_gradient_golden(geo):
    g = dict(np.load(os.path.join(
        FIX, "golden_grad_bem_semi_wind_coarse.npz")))
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS + ("d_scale",)}
    hold_jacfwd(row_jacfwd(_fn(geo), x), g, "on_")
