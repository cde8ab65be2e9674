"""Seeded contract negative: a geometry gather re-done inside the drag
linearisation (``drag_lin_iter`` indexes the strips' lever arms again
on every call, where ``drag_lin_precompute`` gathered them once).

The op contracts must catch it twice: ``drag_lin_iter`` runs two
gather-class ops where one is allowed, and the fixed point's trips run
two gathers a trip.  ``python -m raft_tpu_torch.analysis contracts
--fixture <this file>`` must exit 1.
"""

import torch

from raft_tpu_torch.physics import morison

_drag_lin_iter = morison.drag_lin_iter


def drag_lin_iter(pre, Xi):
    idx = torch.arange(pre["r_off"].shape[1], device=Xi.device)
    return _drag_lin_iter(dict(pre, r_off=pre["r_off"].index_select(1, idx)),
                          Xi)


PATCHES = {"raft_tpu_torch.physics.morison:drag_lin_iter": drag_lin_iter}
ENTRIES = (("drag_lin_iter", "float64"), ("solve_dynamics_fowt", "float64"))
