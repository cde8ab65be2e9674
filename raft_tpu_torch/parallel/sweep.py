"""Mixed-design sea-state sweep (counterpart of ``sweep_heterogeneous``
in ``raft_tpu/parallel/sweep.py``).

The sweep takes the port's models (:class:`raft_tpu_torch.models.model.
Model`, each packed once into its bucket) or packed designs
(:class:`raft_tpu_torch.structure.bucketing.PackedDesign`, e.g. from
:func:`~raft_tpu_torch.structure.bucketing.load_packed`).  The
semantics are the reference's: rows are grouped by bucket signature,
each group runs through one :class:`BucketEvaluator` in chunks of
``RAFT_TPU_BUCKET_ROWS`` rows (the last chunk of a multi-chunk group
padded with masked repeat rows), and the results come back as host
numpy arrays in input order.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.structure import bucketing
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.dtypes import resolve_device


def _pack(model):
    sig = bucketing.bucket_signature(model)
    return bucketing.PackedDesign(sig=sig,
                                  leaves=bucketing.pack_design(model, sig))


def sweep_heterogeneous(designs, Hs, Tp, beta, device=None,
                        out_keys=("PSD", "X0", "status"), timer=None):
    """Evaluate row i = (designs[i], Hs[i], Tp[i], beta[i]) for all rows.

    designs : sequence of Model or PackedDesign, one per row (repeat an
        object to evaluate it under several sea states; each distinct
        model is packed once, and each distinct design is moved to the
        device once).
    Hs, Tp, beta : (n,) sea-state arrays.
    timer : optional ``timer(stage)`` callback passed to every chunk's
        evaluator (see :meth:`BucketEvaluator.forward`).

    Returns a dict of host numpy arrays of length n per ``out_keys``.
    """
    device = resolve_device(device)
    Hs = np.asarray(Hs, dtype=float)
    Tp = np.asarray(Tp, dtype=float)
    beta = np.asarray(beta, dtype=float)
    n = len(Hs)
    if n == 0:
        raise ValueError("empty batch: no case rows to sweep")
    if not (len(Tp) == len(beta) == n):
        raise ValueError("Hs/Tp/beta must have equal length")
    if len(designs) != n:
        raise ValueError(f"need one model or packed design per case row: "
                         f"{len(designs)} designs for {n} rows")
    packed = {}
    for d in designs:
        if id(d) not in packed:
            packed[id(d)] = d if isinstance(d, bucketing.PackedDesign) \
                else _pack(d)
    designs = [packed[id(d)] for d in designs]
    w_grids = {tuple(bucketing.signature_meta(d.sig)["w"]) for d in designs}
    if len(w_grids) > 1:
        raise ValueError("mixed frequency grids in one heterogeneous sweep: "
                         "outputs cannot be stacked")
    groups = {}
    for i, d in enumerate(designs):
        groups.setdefault(d.sig, []).append(i)

    cap = int(config.get("BUCKET_ROWS"))
    out = {}
    for sig, idxs in groups.items():
        # each distinct design of the group on the device once; a chunk
        # gathers its rows from this stack
        slot = {}
        distinct = []
        for i in idxs:
            if id(designs[i]) not in slot:
                slot[id(designs[i])] = len(distinct)
                distinct.append(designs[i].leaves)
        stacked = bucketing.packed_from_numpy(
            bucketing.stack_packed(distinct), device)
        row_slot = np.asarray([slot[id(designs[i])] for i in idxs])
        ev = bucketing.BucketEvaluator(sig, device)
        if cap and len(idxs) > cap:
            bounds = [(a, min(a + cap, len(idxs)))
                      for a in range(0, len(idxs), cap)]
        else:
            bounds = [(0, len(idxs))]
        for a, b in bounds:
            rows = b - a
            pad = cap - rows if len(bounds) > 1 else 0
            take = np.concatenate([np.arange(a, b), np.full(pad, b - 1)])
            sel = torch.as_tensor(row_slot[take], device=device)
            design = {k: v[sel] for k, v in stacked.items()}
            rows_in = np.asarray(idxs)[take]
            with torch.no_grad():
                res = ev(design, torch.as_tensor(Hs[rows_in]),
                         torch.as_tensor(Tp[rows_in]),
                         torch.as_tensor(beta[rows_in]), timer=timer)
            chunk = np.asarray(idxs[a:b])
            for k in out_keys:
                host = res[k][:rows].cpu().numpy()
                if k not in out:
                    out[k] = np.zeros((n,) + host.shape[1:], dtype=host.dtype)
                out[k][chunk] = host
    return out
