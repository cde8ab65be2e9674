"""Scatter-adds whose result does not depend on the run.

``Tensor.index_add`` on a CUDA tensor accumulates by atomic adds in no
fixed order, so two evaluations of the same rows on the card differ in
their last bits (the strip -> node sums of the excitation, the hydro
constants and the drag linearisation; a mooring network's point
loads), and a resumed checkpointed sweep could not reproduce the
shards of the run it resumes.  Here a CUDA tensor sums through a
one-hot matrix product instead: cuBLAS gives the same bits every run
for the same shapes.  Where the index is a constant of its caller (a
mooring network's line ends), the caller builds the one-hot matrix once
(:func:`onehot`) and each sum is one product, fewer launches than
``index_add``'s zeros, copy and scatter.

A CPU tensor keeps ``index_add``.  It adds in index order, so its bits
are already the same on every run, and they are the bits on which the
CPU tests hold the port's status words and iteration counts equal to
the reference's (a one-hot product may add three or more terms in
another order, and a count may move on a tie).  The tests also run the
card's form on the CPU, through whole evaluators, against the same
goldens (``tests/test_torch_ops.py``).  Both forms are differentiable in
reverse and forward mode.
"""

from __future__ import annotations

import torch


def _card_form(t):
    """Whether ``t`` sums by one-hot products (a CUDA tensor)."""
    return t.device.type == "cuda"


def onehot(index, n, dtype):
    """The (n, m) matrix with 1 where ``index[j] == i``: ``index`` 1-D
    (m,) integer in [0, n)."""
    rows = torch.arange(n, device=index.device)
    return (rows[:, None] == index.to(torch.int64)[None, :]).to(dtype)


def index_sum(source, index, n, matrix=None):
    """Per row, sum source's entries at their index: source (R, m, ...),
    ``index`` (m,) in [0, n) -> (R, n, ...), the same bits on every run
    of a CUDA tensor.  ``matrix`` is ``onehot(index, n, source.dtype)``
    where the caller keeps it; the CPU never needs it."""
    R, m = source.shape[:2]
    if not _card_form(source):
        out = source.new_zeros((R, n) + source.shape[2:])
        return out.index_add(1, index, source)
    if matrix is None:
        matrix = onehot(index, n, source.dtype)
    out = torch.matmul(matrix, source.reshape(R, m, -1))
    return out.reshape((R, n) + source.shape[2:])


def segment_sum_rows(x, seg, n_seg):
    """Per row, sum x's segment entries into their segments: x (R, S,
    ...), seg (R, S) integer in [0, n_seg) -> (R, n_seg, ...), the same
    bits on every run of a CUDA tensor: there, per row the (n_seg, S)
    one-hot matrix of ``seg`` times x, one batched product.  On the CPU
    one ``index_add`` over flattened ``row * n_seg + seg`` offsets."""
    R, S = x.shape[:2]
    if _card_form(x):
        match = (seg.to(torch.int64)[:, None, :]
                 == torch.arange(n_seg, device=seg.device)[None, :, None])
        out = torch.bmm(match.to(x.dtype), x.reshape(R, S, -1))
        return out.reshape((R, n_seg) + x.shape[2:])
    rows = torch.arange(R, device=seg.device, dtype=torch.int64)
    flat = (rows[:, None] * n_seg + seg.to(torch.int64)).reshape(-1)
    out = torch.zeros((R * n_seg,) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    out = out.index_add(0, flat, x.reshape((R * S,) + x.shape[2:]))
    return out.reshape((R, n_seg) + x.shape[2:])
