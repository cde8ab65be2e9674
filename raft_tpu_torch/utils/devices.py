"""Device-placement helpers (counterpart of ``raft_tpu/utils/devices.py``).

:func:`on_cpu` runs a block with the CPU as torch's default device, for
small eager build work; :func:`to_host` pulls a tree of tensors to host
numpy; :func:`probe_backend` health-checks the CUDA device in a child
process, so a wedged driver cannot hang the caller.

The reference's ``enable_compile_cache`` (the persistent XLA
compilation cache, its recompile sentinel and program bank) has no
counterpart here: the port compiles its CUDA kernels once per build
directory (:mod:`raft_tpu_torch.ops.linsolve`) and traces nothing.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from raft_tpu_torch.utils import config


@contextlib.contextmanager
def on_cpu():
    """Run the block with the CPU as torch's default device."""
    with torch.device("cpu"):
        yield


def to_host(tree):
    """Pull a tree (dicts, lists, tuples) of tensors to host numpy;
    other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if hasattr(tree, "dtype"):
        return np.asarray(tree)
    return tree


#: the child's program: one small CUDA matmul, synchronised
_PROBE = ("import torch; x = torch.ones(128, 128, device='cuda'); "
          "(x @ x).sum().item(); torch.cuda.synchronize(); "
          "print('ok', torch.cuda.get_device_name(0))")


def probe_backend(timeout_s=None, detail=False):
    """Health-probe the CUDA device without risking this process: a
    child process runs one small matmul on it, under ``timeout_s``
    (default ``RAFT_TPU_PROBE_S``).

    Returns True when the device answered, False on timeout or error;
    with ``detail=True``, ``(ok, words)`` where ``words`` is the child's
    own last line (its error, or ``ok <device name>``)."""
    import os
    import subprocess
    import sys

    from raft_tpu_torch.utils import faults

    if faults.take("unhealthy", "backend_probe"):
        res = (False, "injected fault unhealthy:backend_probe")
    else:
        if timeout_s is None:
            timeout_s = config.get("PROBE_S")
        try:
            p = subprocess.run([sys.executable, "-c", _PROBE],
                               timeout=timeout_s, capture_output=True,
                               text=True, env=dict(os.environ))
            lines = (p.stdout.strip() or p.stderr.strip()).splitlines()
            res = (p.returncode == 0,
                   lines[-1] if lines else f"exit code {p.returncode}")
        except subprocess.TimeoutExpired:
            res = (False, f"no answer within {timeout_s} s")
        except OSError as e:
            res = (False, str(e))
    return res if detail else res[0]
