"""Program identity: the content fingerprint of a design.

Counterpart of ``content_fingerprint`` in ``raft_tpu/aot/bank.py``: the
same walk over nested plain data, so the same object hashes to the same
16-hex digest in both packages (the result cache keys of
:mod:`raft_tpu_torch.omdao` are comparable across them).  A torch tensor
hashes as its CPU numpy array, as the reference hashes its arrays
through ``np.asarray``.

Also here: :func:`code_fingerprint` (the content hash of the port's
sources, which run records carry) and the per-program ledger of
``ledger_summary`` / ``merge_ledgers``.  The port has no
compiled-program bank, so its ledger is that of its hand-written
kernel: one row per entry of ``csrc/linsolve.cu`` that launched in this
process, from the launch counters of :mod:`raft_tpu_torch.ops.linsolve`.
A fabric worker publishes its rows in its status file and the
coordinator folds them fleet-wide by the reference's rules.

The rest of the reference's ``bank.py`` (the compiled-program bank and
its keys) is not ported: it rests on serialized XLA executables, and
the port's program warm-up is ROADMAP A15(e).
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

_CODE_FP_CACHE: dict = {}


def code_fingerprint():
    """Content hash (16 hex) over every ``raft_tpu_torch`` source file
    (``.py``, and the kernels' ``.cu`` / ``.cpp``); cached per
    process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root in _CODE_FP_CACHE:
        return _CODE_FP_CACHE[root]
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if not fn.endswith((".py", ".cu", ".cpp")):
                continue
            path = os.path.join(dirpath, fn)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    fp = h.hexdigest()[:16]
    _CODE_FP_CACHE[root] = fp
    return fp


def ledger_summary():
    """JSON-ready per-program ledger rows of this process (a fabric
    worker's status file, run records): ``key`` (the kernel entry),
    ``kind`` (``"cuda"``) and ``dispatches`` (its launches), for every
    entry of the solve kernel that launched at least once (none when
    the solve module was never imported: nothing launched)."""
    linsolve = sys.modules.get("raft_tpu_torch.ops.linsolve")
    if linsolve is None:
        return []
    return [{"key": key, "kind": "cuda", "dispatches": int(n)}
            for key, n in sorted(linsolve.launch_ledger().items()) if n]


def merge_ledgers(row_lists):
    """Fold several :func:`ledger_summary` row lists (every fabric
    worker's published ledger) into one fleet-wide view by the
    reference's rules: dispatches and wall sum per key, the
    dispatch-weighted mean GFLOP/s recomputed where a row carries
    flops.  Garbled rows are skipped: telemetry pooling must never
    crash."""
    merged: dict[str, dict] = {}
    for rows in row_lists:
        for row in rows or ():
            try:
                key = row["key"]
                m = merged.setdefault(
                    key, {"key": key, "kind": row.get("kind"),
                          "dispatches": 0, "wall_s": 0.0})
                m["dispatches"] += int(row.get("dispatches") or 0)
                m["wall_s"] += float(row.get("wall_s") or 0.0)
                for k in ("flops", "bytes_accessed", "arg_bytes",
                          "out_bytes"):
                    if k in row:
                        m[k] = row[k]
            except (KeyError, TypeError, ValueError):
                continue
    for m in merged.values():
        flops = m.get("flops")
        if flops and m["wall_s"] > 0 and m["dispatches"]:
            m["gflops_s_mean"] = round(
                flops * m["dispatches"] / m["wall_s"] / 1e9, 6)
        m["wall_s"] = round(m["wall_s"], 4)
    return [merged[k] for k in sorted(merged)]


def content_fingerprint(obj):
    """Deterministic 16-hex hash of a nested plain-data structure
    (dicts, lists / tuples, scalars, strings, numpy arrays, torch
    tensors).

    Scalars hash by their ``repr``, arrays by dtype, shape and raw
    bytes (an object array by its ``tolist()``, never its pointers),
    dicts in ``repr``-sorted key order.  Any other object that numpy
    coerces to a non-object array hashes as that array; anything else
    by its type alone."""
    import torch

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
