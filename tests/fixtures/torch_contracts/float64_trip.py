"""Seeded contract negative: a float64 op inside the float32 trips (the
drag damping widened to float64 and narrowed again on every trip, the
silent upcast a hard-coded dtype brings back).

The dtype contract must catch it in ``solve_dynamics_fowt`` under
``RAFT_TPU_DTYPE=float32``.  ``python -m raft_tpu_torch.analysis
contracts --fixture <this file>`` must exit 1.
"""

import torch

from raft_tpu_torch.physics import morison

_drag_lin_iter = morison.drag_lin_iter


def drag_lin_iter(pre, Xi):
    out = _drag_lin_iter(pre, Xi)
    B = out["B_hydro_drag"]
    return dict(out, B_hydro_drag=B.to(torch.float64).to(B.dtype))


PATCHES = {"raft_tpu_torch.physics.morison:drag_lin_iter": drag_lin_iter}
ENTRIES = (("solve_dynamics_fowt", "float32"),)
