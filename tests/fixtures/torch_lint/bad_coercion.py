"""Seeded violations for the host-coercion rule: host pulls of values
that dataflow from torch expressions (each a device-to-host sync on a
CUDA tensor)."""

import numpy as np
import torch


def resid_to_python(x):
    r = torch.amax(torch.abs(x))
    flag = bool(r < 1e-3)           # line 11: bool() of a tensor
    val = float(r)                  # line 12: float() of a tensor
    return flag, val


def pull_to_host(x):
    y = torch.fft.rfft(x)
    scalar = y.sum().item()         # line 18: .item() via tainted name
    host = np.asarray(y)            # line 19: host pull mid-pipeline
    rows = y.abs().tolist()         # line 20: .tolist()
    back = y.cpu()                  # line 21: .cpu()
    arr = y.real.numpy()            # line 22: .numpy()
    return scalar, host, rows, back, arr


def shape_access_is_fine(x):
    y = torch.abs(x)
    n = int(y.shape[0])             # host metadata: NOT flagged
    m = int(y.size(-1))             # host metadata: NOT flagged
    return n, m, len(np.asarray(y.shape))
