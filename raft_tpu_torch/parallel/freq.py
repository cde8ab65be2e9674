"""The frequency (``sp``) axis of a mesh: one entry's share of the
frequency grid and the reducer its sp group shares (the port's
counterpart of GSPMD's ``shard_freq`` out-sharding in the reference's
``sweep_cases_full``).

With ``shard_freq=True`` on a mesh whose ``sp`` axis is larger than 1,
:mod:`raft_tpu_torch.parallel.sweep` runs every entry of an sp group
on the group's dp block, each on one contiguous slice of the frequency
grid (:func:`slices`), under :func:`sharing`.  The evaluators then

* cut every per-frequency tensor to the entry's slice with
  :func:`take` (work with no frequency axis — the statics, the mean
  aero and current loads — runs whole on every entry);
* pass every reduction over the frequency axis through :func:`wsum`,
  :func:`wall` or :func:`wamax`: the local reduction, then the group's
  :class:`GroupReducer`, which combines the entries' partials in
  sp-index order, never in arrival order, so a mesh gives the same bits
  on every run.

Outside :func:`sharing` (an sp group of one entry, every caller that is
not a sweep) :func:`take` returns its tensor and the reductions are the
plain torch ones: today's code, with no reducer in the path.

The group's entries are threads of one process, ranks of a
``torch.distributed`` job, or both: the threads of a rank meet at a
barrier, and the lowest-index local entry exchanges the rank's partials
with the other ranks by an all-gather over the group's process group.
Every wait has a timeout (:data:`WAIT_S`); an entry that fails or
finishes leaves the group, so a peer that waits for it in a round it
will not complete raises :class:`GroupBroken` instead of hanging.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

#: seconds an entry waits for its group at a reduction before it fails
WAIT_S = 300.0

#: the frequency axis of every evaluator output key that has one (the
#: gather concatenates these slices in sp order); the other keys are
#: whole on every entry of a group
FREQ_AXES = {"Xi": -1, "RAO": -1, "PSD": -1, "S": -1, "zeta": -1,
             "f_aero": -1, "A00": 1, "B00": 1, "Z": 1}

_LOCAL = threading.local()


def slices(nw, sp):
    """The ``(lo, hi)`` frequency slices of ``sp`` entries over a grid of
    ``nw`` bins: contiguous, in order, sized as ``np.array_split`` sizes
    them (the larger slices first)."""
    if sp > nw:
        raise ValueError(f"an sp axis of {sp} entries over {nw} frequencies: "
                         "every entry needs at least one frequency")
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(nw),
                                                             sp)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


class Share:
    """One entry's share of the frequency grid: bins ``lo:hi``, its
    ``index`` in its sp group and the group's ``reducer``."""

    def __init__(self, lo, hi, index, reducer):
        self.lo, self.hi, self.index, self.reducer = lo, hi, index, reducer


def current():
    """The calling thread's :class:`Share`, or None outside
    :func:`sharing`."""
    return getattr(_LOCAL, "share", None)


@contextlib.contextmanager
def sharing(share, turn=None):
    """Run the block on ``share`` (None: the whole grid), holding
    ``turn`` when given: the lock the threads of an sp group take turns
    by (:func:`raft_tpu_torch.parallel.sweep._run_block`), held but
    while the thread waits for its group (:func:`released`)."""
    prev = current(), getattr(_LOCAL, "turn", None)
    _LOCAL.share, _LOCAL.turn = share, turn
    try:
        if turn is None:
            yield share
        else:
            with turn:
                yield share
    finally:
        _LOCAL.share, _LOCAL.turn = prev


@contextlib.contextmanager
def released():
    """Give up the calling entry thread's turn for the block, a wait
    for the group: another entry issues its work meanwhile.  Outside
    an sp group's threads, nothing."""
    turn = getattr(_LOCAL, "turn", None)
    if turn is None:
        yield
        return
    turn.release()
    try:
        yield
    finally:
        turn.acquire()


def take(t, dim=-1):
    """``t``'s bins of the calling entry's slice along ``dim``, the
    frequency axis of a whole-grid tensor (``t`` itself outside
    :func:`sharing`)."""
    s = current()
    if s is None:
        return t
    return t.narrow(dim, s.lo, s.hi - s.lo)


def _reduced(out, op):
    s = current()
    if s is None:
        return out
    return s.reducer.combine(s.index, out, op)


def wsum(t, dim):
    """``torch.sum(t, dim)`` over the whole grid, ``dim`` including the
    frequency axis of a sliced ``t``."""
    return _reduced(torch.sum(t, dim=dim), "sum")


def wall(t, dim):
    """``torch.all(t, dim)`` over the whole grid."""
    return _reduced(torch.all(t, dim=dim), "all")


def wamax(t, dim):
    """``torch.amax(t, dim)`` over the whole grid."""
    return _reduced(torch.amax(t, dim=dim), "max")


def fold(parts, op):
    """The partials combined in list order: a sum, a logical AND or an
    elementwise maximum."""
    out = parts[0]
    for p in parts[1:]:
        if op == "sum":
            out = out + p
        elif op == "all":
            out = out & p
        else:
            out = torch.maximum(out, p)
    return out


class GroupBroken(RuntimeError):
    """A group's wait failed: a peer failed or left, or the wait timed
    out."""


class _Rendezvous:
    """A barrier of ``n`` threads that a member can leave: a member that
    fails or finishes calls :meth:`leave`, and every wait of a round it
    will not complete raises :class:`GroupBroken` at once (a round that
    completed before still releases its waiters)."""

    def __init__(self, n, timeout):
        self.n, self.timeout = n, timeout
        self._cond = threading.Condition()
        self._count = 0  # raft-lint: guarded-by=self._cond
        self._gen = 0  # raft-lint: guarded-by=self._cond
        self._left = False  # raft-lint: guarded-by=self._cond

    def wait(self):
        with self._cond:
            if self._left:
                raise GroupBroken("a peer of the sp group failed or left")
            gen = self._gen
            self._count += 1
            if self._count == self.n:
                self._count = 0
                self._gen += 1
                self._cond.notify_all()
                return
            ok = self._cond.wait_for(lambda: self._gen != gen or self._left,
                                     self.timeout)
            if self._gen != gen:
                return
            if not ok:
                self._left = True
                self._cond.notify_all()
                raise GroupBroken(f"the sp group's peers did not arrive "
                                  f"within {self.timeout} s")
            raise GroupBroken("a peer of the sp group failed or left")

    def leave(self):
        with self._cond:
            self._left = True
            self._cond.notify_all()


class GroupReducer:
    """The reducer one sp group shares.

    ``owners`` names the rank of each of the group's ``len(owners)``
    entries, in sp order; ``rank`` is this process's.  The entries this
    rank owns are threads that meet at a barrier; where the group spans
    ranks, ``group`` is its ``torch.distributed`` process group and
    ``exchange_device`` the device its all-gather runs on (the CPU for
    ``gloo``, the card for ``nccl``)."""

    def __init__(self, owners, rank=0, group=None, exchange_device=None,
                 timeout=None):
        self.owners = list(owners)
        self.rank = rank
        self.local = [i for i, r in enumerate(self.owners) if r == rank]
        self.ranks = sorted(set(self.owners))
        self.group = group
        self.exchange_device = exchange_device
        self._slots = {}
        self._result = None
        self._rv = _Rendezvous(len(self.local),
                               WAIT_S if timeout is None else timeout)

    def _wait(self):
        with released():
            self._rv.wait()

    def leave(self):
        """An entry failed or finished: every wait of a round it will
        not complete raises :class:`GroupBroken`."""
        self._rv.leave()

    def combine(self, index, t, op):
        """Entry ``index``'s partial ``t`` combined with its group's (each
        entry gets the same tensor, on its own device)."""
        self._slots[index] = t
        self._wait()
        if len(self.ranks) == 1:
            out = fold([self._slots[i].to(t.device)
                        for i in range(len(self.owners))], op)
            self._wait()
            return out
        if index == self.local[0]:
            self._result = self._exchange(t, op)
        self._wait()
        out = self._result.to(t.device)
        self._wait()
        return out

    def _exchange(self, t, op):
        """All-gather this rank's partials with the other ranks' and fold
        every entry's in sp order (the first local entry's thread)."""
        import torch.distributed as dist

        dev = self.exchange_device or t.device
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        stack = torch.zeros((len(self.owners),) + tuple(wire.shape),
                            dtype=wire.dtype, device=dev)
        for i in self.local:
            p = self._slots[i]
            stack[i] = (p.to(torch.uint8) if p.dtype == torch.bool
                        else p).to(dev)
        got = [torch.empty_like(stack) for _ in self.ranks]
        dist.all_gather(got, stack, group=self.group)
        by_rank = dict(zip(self.ranks, got))
        parts = [by_rank[r][i] for i, r in enumerate(self.owners)]
        if t.dtype == torch.bool:
            parts = [p.to(torch.bool) for p in parts]
        return fold(parts, op)
