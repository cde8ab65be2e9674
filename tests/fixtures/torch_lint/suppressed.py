"""Every violation here carries a suppression: the file must lint clean.

# raft-lint: disable-file=env-read
"""

import os

import numpy as np
import torch


def audited(nw, x):
    a = torch.zeros(nw, dtype=torch.complex128)  # raft-lint: disable=dtype-literal (audited)
    # raft-lint: disable=dtype-literal
    b = np.zeros(nw, dtype=complex)
    y = torch.sum(x)
    # raft-lint: disable=host-coercion
    v = float(y)
    flag = os.environ.get("RAFT_TPU_SOLVER")  # file-level suppression
    return a, b, v, flag
