"""Seeded violations for the dtype-literal rule (linted as a traced
module): each flagged line pins a 64-bit width whatever the
RAFT_TPU_DTYPE policy says."""

import numpy as np
import torch


def traced_allocations(nw, x):
    a = torch.zeros(nw, dtype=complex)               # line 10: bare complex
    b = torch.ones((3, nw), dtype=torch.complex128)  # line 11: pinned 64-bit
    c = torch.full((nw,), 1.0, dtype=torch.double)   # line 12: alias
    d = x.to(torch.float64)                          # line 13: cast literal
    e = x.double()                                   # line 14: cast method
    return a, b, c, d, e


def host_allocation(nw):
    return np.zeros(nw, dtype=complex)               # line 19: ambiguous width
