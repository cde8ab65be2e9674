"""Program identity: the content fingerprint of a design.

Counterpart of ``content_fingerprint`` in ``raft_tpu/aot/bank.py``: the
same walk over nested plain data, so the same object hashes to the same
16-hex digest in both packages (the result cache keys of
:mod:`raft_tpu_torch.omdao` are comparable across them).  A torch tensor
hashes as its CPU numpy array, as the reference hashes its arrays
through ``np.asarray``.

The rest of the reference's ``bank.py`` (the compiled-program bank, its
keys and code fingerprint) is not ported: it rests on serialized XLA
executables, and the port's program warm-up is ROADMAP A15.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def content_fingerprint(obj):
    """Deterministic 16-hex hash of a nested plain-data structure
    (dicts, lists / tuples, scalars, strings, numpy arrays, torch
    tensors).

    Scalars hash by their ``repr``, arrays by dtype, shape and raw
    bytes (an object array by its ``tolist()``, never its pointers),
    dicts in ``repr``-sorted key order.  Any other object that numpy
    coerces to a non-object array hashes as that array; anything else
    by its type alone."""
    h = hashlib.sha256()

    def walk(o):
        if o is None or isinstance(o, (bool, int, float, complex,
                                       str, bytes)):
            h.update(repr(o).encode())
        elif isinstance(o, torch.Tensor):
            walk(o.detach().cpu().numpy())
        elif isinstance(o, np.ndarray):
            if o.dtype == object:
                walk(o.tolist())
            else:
                h.update(str((o.dtype, o.shape)).encode())
                h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, np.generic):
            h.update(repr(o.item()).encode())
        elif isinstance(o, dict):
            h.update(b"{")
            for k in sorted(o, key=repr):
                walk(k)
                walk(o[k])
            h.update(b"}")
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for v in o:
                walk(v)
            h.update(b"]")
        else:
            try:
                arr = np.asarray(o)
            except Exception:
                arr = None
            if arr is not None and arr.dtype != object:
                walk(arr)
            else:
                h.update(repr(type(o)).encode())

    walk(obj)
    return h.hexdigest()[:16]
