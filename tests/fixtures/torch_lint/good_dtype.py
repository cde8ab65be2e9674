"""Clean twins of bad_dtype.py: derived or explicitly-audited dtypes."""

import numpy as np
import torch

from raft_tpu_torch.utils.dtypes import compute_dtypes


def traced_allocations(x, nw):
    rdt, cdt = compute_dtypes(x)
    a = torch.zeros(nw, dtype=cdt)
    b = torch.ones((3, nw), dtype=cdt)
    c = torch.full((nw,), 1.0, dtype=rdt)
    return a, b, c, x.to(cdt), x.dtype == torch.float64


def host_allocation(nw):
    # explicit 64-bit width: audited host-side precision, not a leak
    return np.zeros(nw, dtype=np.complex128)
