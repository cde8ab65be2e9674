"""``torch.func.jacfwd`` of the response metric through the port's
flexible (N-DOF beam) evaluator by the row inputs, against
``golden_grad_flex_semi_wind.npz`` at the flexible gradients' gate, 1e-7
x each key's max|g| (``tests/test_torch_fwd_flex.py`` says why; the
tangents are held there).
"""

import os

import numpy as np
import torch

from raft_tpu_torch import api as tapi
from test_torch_fwd import (FIX, hold_jacfwd, one_thread,  # noqa: F401
                            row_jacfwd)
from test_torch_fwd_flex import ROW_KEYS, _model
from test_torch_grad_flex import GRAD_GATE


def test_flex_jacfwd():
    m, _ = _model()
    g = dict(np.load(os.path.join(FIX, "golden_grad_flex_semi_wind.npz")))
    ev = tapi.make_flexible_evaluator(m, device="cpu")
    x = {k: torch.tensor(g[k]) for k in ROW_KEYS}
    hold_jacfwd(row_jacfwd(lambda x: ev(**x), x), g, "", tol=GRAD_GATE)
