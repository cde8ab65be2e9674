"""Device-list sweep drivers (counterpart of ``raft_tpu/parallel/sweep.py``).

A sweep lays a batch of rows (sea states, full-physics cases, mixed
designs) over a :class:`Mesh`: an array of ``torch.device`` entries with
named axes, each entry owned by one process (its ``torch.distributed``
rank; every entry is this process's without ``RAFT_TPU_DIST``).  Rows
split into contiguous ``dp`` blocks, one block per index of the ``dp``
axis, each block run through the evaluator bound to its entry's device
(the evaluator chunks its block by its own ``RAFT_TPU_BUCKET_ROWS``); a
batch not divisible by the ``dp`` size is padded by repeating its last
row (``dp_autopad`` counter and event) and the pad is dropped on
gather.  The results come back as host numpy arrays in input order, the
same dict on every rank.

The dp blocks run one after another, in dp order on every rank, each
gathered to the host before the next starts (a mesh of k cards on one
process takes as long as its k blocks back to back: to use k cards at
once, run one process per card under ``RAFT_TPU_DIST``).  The entries
of one block's sp group that this process owns run at once, one host
thread each, under the entry's device context and with an evaluator of
its own (two entries of one card never share an evaluator object:
:func:`bind_evaluator`); they take turns on the host, each holding the
turn but while it waits for its group (the couplings' rendezvous).  A
thread's exception fails the call (after its peers stop), and so does a
rank's death, within the collectives' timeout (:data:`DIST_TIMEOUT_S`);
on a mesh that spans processes, an error on any rank is raised on every
rank.  A row's result does not depend on the block it ran in on the
CPU: one entry gives the plain evaluator call's bits, k entries the
same bits again.  On the card the same holds where every block keeps
the evaluator's chunk size; a block of another size may round
differently (the library's batched products pick their kernels by
shape).

The frequency (``sp``) axis: with ``shard_freq=True`` on a mesh whose
``sp`` axis is larger than 1, every entry of a dp block's sp group
evaluates the block on one contiguous slice of the frequency grid
(``np.array_split`` sizes, the larger slices first), the couplings
across frequencies going through one reducer the group shares, which
combines the partials in sp order (:mod:`raft_tpu_torch.parallel.freq`);
the gather concatenates each output's frequency slices
(:data:`~raft_tpu_torch.parallel.freq.FREQ_AXES`) and takes every other
key from the group's first entry, after checking that ``status`` and
``n_iter_drag`` agree across the group.  Without ``shard_freq``, or
with a plain-function evaluator, an sp group runs its block on its
first entry (the reference replicates the block over ``sp``: the values
are the same).  An sp group of one entry runs with no reducer in the
path.

An evaluator made by one of the factories of :mod:`raft_tpu_torch.api`
holds tensors built for its device; on another entry of the mesh it
runs as a twin, built by the same factory with the same arguments for
that entry's device (:func:`bind_evaluator`).  A plain function
evaluator gets its inputs on each block's device.

Multi-process meshes: with ``RAFT_TPU_DIST`` set,
:func:`ensure_distributed` (which
:func:`~raft_tpu_torch.parallel.resilience.resolve_mesh` runs first)
joins the ``torch.distributed`` job of the ``RAFT_TPU_DIST_*`` flags,
and :func:`make_mesh` then spans every rank's devices in rank order.
Each process runs only its own entries; an all-gather gives every rank
the whole result.

Under ``RAFT_TPU_AOT=load|require`` the program bank
(:mod:`raft_tpu_torch.aot.bank`) fronts :func:`sweep_cases`,
:func:`sweep_cases_full` and each bucket chunk of
:func:`sweep_heterogeneous`, with the reference's memo keys (the
evaluator's program identity, out_keys, the mesh's devices and, across
processes, their ranks, the evaluator flags) and the padded inputs'
signature.

:func:`run_sweep_checkpointed_full` and :func:`run_sweep_checkpointed`
run a sweep in shards through the fault-tolerant runtime of
:mod:`raft_tpu_torch.parallel.resilience` (atomic shard files, manifest,
retries, OOM halving, quarantine); :func:`qtf_slender_sharded` splits
the slender-body QTF's frequency pairs over the mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import pickle
import socket
import threading

import numpy as np
import torch

from raft_tpu_torch.aot import bank
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import span
from raft_tpu_torch.parallel import freq
from raft_tpu_torch.structure import bucketing
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.devices import to_host
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device
from raft_tpu_torch.utils.structlog import log_event

#: seconds a collective of the distributed job waits for its peers (a
#: dead rank fails the call after it)
DIST_TIMEOUT_S = 300.0
#: seconds the calling thread waits for one entry thread to finish
#: after the entry's own waits have all timed out
JOIN_S = 3600.0


class Mesh:
    """Devices laid out over named axes (the port's stand-in for a JAX
    ``Mesh``): ``devices`` an object array of ``torch.device``, one
    array axis per name; ``shape`` ``{axis: size}``; ``axis_names``;
    ``ranks`` the owning process of each entry (an int array of the
    devices' shape; None: every entry is the calling process's)."""

    def __init__(self, devices, axis_names=("dp",), ranks=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{self.axis_names}")
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=int).reshape(devices.shape)
        self.ranks = ranks
        self.shape = dict(zip(self.axis_names, devices.shape))

    def rank_array(self):
        """The owning rank of every entry (this process's where the
        mesh names none)."""
        if self.ranks is None:
            return np.full(self.devices.shape, dist_rank(), dtype=int)
        return self.ranks

    def spans_ranks(self):
        """True when the mesh's entries belong to more than one
        process."""
        return self.ranks is not None and len(set(self.ranks.flat)) > 1

    def __repr__(self):
        ranks = ("" if not self.spans_ranks() else
                 f", ranks={self.ranks.ravel().tolist()}")
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape}{ranks})")


def device_array(devices, shape=None):
    """``devices`` (torch devices or their names) as an object array of
    ``torch.device`` of ``shape`` (default: one axis)."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape or (len(devices),))


# ------------------------------------------------------ distributed job

#: the distributed job this process joined: whether it did, and the
#: backend of its tensor collectives on the card (``_DIST_LOCK``)
_DIST_LOCK = threading.Lock()
_DIST = {"done": False, "card_backend": "gloo"}
#: process groups by (ranks, backend), made in one order on every rank
_GROUPS: dict = {}


def ensure_distributed(dryrun=False):
    """Join the ``torch.distributed`` job of a multi-process mesh.

    Gated on ``RAFT_TPU_DIST``; the coordinator address, this process's
    rank and the process count come from the ``RAFT_TPU_DIST_*`` flags
    (set them per process in the launcher).  The default process group
    is ``gloo`` over ``tcp://<coordinator>``; the collectives of a mesh
    on the card take ``nccl`` where every rank has a card of its own
    (no two ranks' visible cards are one card) and ``gloo`` where ranks
    share a card, as NCCL refuses two ranks on one card; a CPU mesh's
    take ``gloo`` (:func:`dist_backend`).  After it, :func:`make_mesh`
    spans every process's devices.  ``dryrun=True`` validates and
    returns the parsed config without touching ``torch.distributed``.
    Returns the config dict, or ``None`` when distribution is off.
    Idempotent: a second call in an initialized process is a no-op."""
    if not config.get("DIST"):
        return None
    cfg = {
        "coordinator": str(config.get("DIST_COORDINATOR")),
        "process_id": int(config.get("DIST_PROCESS_ID")),
        "num_processes": int(config.get("DIST_NUM_PROCESSES")),
    }
    if ":" not in cfg["coordinator"]:
        raise ValueError(
            f"RAFT_TPU_DIST_COORDINATOR={cfg['coordinator']!r}: expected "
            "host:port")
    if not 0 <= cfg["process_id"] < cfg["num_processes"]:
        raise ValueError(
            f"RAFT_TPU_DIST_PROCESS_ID={cfg['process_id']} out of range "
            f"for RAFT_TPU_DIST_NUM_PROCESSES={cfg['num_processes']}")
    log_event("distributed_init", coordinator=cfg["coordinator"],
              process_id=cfg["process_id"],
              num_processes=cfg["num_processes"], dryrun=bool(dryrun))
    if dryrun:
        return cfg
    import torch.distributed as dist

    with _DIST_LOCK:
        if _DIST["done"]:
            return cfg
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method=f"tcp://{cfg['coordinator']}",
                rank=cfg["process_id"], world_size=cfg["num_processes"],
                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        cards = [None] * dist.get_world_size()
        dist.all_gather_object(cards, _visible_cards())
        _DIST["card_backend"] = _card_backend(cards)
        _DIST["done"] = True
    return cfg


def _visible_cards():
    """The identities of this process's visible cards (host and UUID)."""
    if not torch.cuda.is_available():
        return []
    host = socket.gethostname()
    return [(host, str(torch.cuda.get_device_properties(i).uuid))
            for i in range(torch.cuda.device_count())]


def _card_backend(cards):
    """The backend of the card collectives, by the rule of
    :func:`ensure_distributed`, from every rank's visible cards."""
    flat = [c for per in cards for c in per]
    if not all(cards) or len(flat) != len(set(flat)):
        return "gloo"
    return "nccl"


def dist_ready():
    """True when this process joined a distributed job."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def dist_rank():
    """This process's rank (0 outside a distributed job)."""
    return torch.distributed.get_rank() if dist_ready() else 0


def dist_backend(device_type):
    """The backend of the collectives over entries of ``device_type``:
    ``gloo`` on the CPU, on the card the one :func:`ensure_distributed`
    chose."""
    if device_type != "cuda":
        return "gloo"
    with _DIST_LOCK:
        return _DIST["card_backend"]


def process_group(ranks, backend="gloo", tag=None):
    """The process group of ``ranks`` for the use ``tag`` names (None:
    the default group where ``ranks`` are every rank and the backend is
    its own).  Every rank must call this for every group, in one order
    (``torch.distributed.new_group``)."""
    import torch.distributed as dist

    ranks = tuple(sorted(int(r) for r in ranks))
    if (tag is None and backend == "gloo"
            and ranks == tuple(range(dist.get_world_size()))):
        return dist.group.WORLD
    key = (ranks, backend, tag)
    with _DIST_LOCK:
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(
                list(ranks), backend=backend,
                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        return _GROUPS[key]


def _cuda_devices():
    """This process's CUDA devices (raises without CUDA)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, axis_names=("dp",), device=None):
    """A mesh of the first ``n_devices`` CUDA devices (all of them when
    None), or of ``device`` repeated ``n_devices`` times (default once):
    k CPU entries stand in for k devices in the CPU tests, and
    ``make_mesh(2, device="cuda")`` puts two row blocks on one card.
    Without CUDA and without ``device`` this raises, as
    :func:`~raft_tpu_torch.utils.dtypes.resolve_device` does.  Two axis
    names split the devices as evenly as possible, ``(n // dp, dp)``, as
    the reference does.

    In a distributed job (:func:`ensure_distributed`) the devices are
    every rank's in rank order, as ``jax.devices()`` spans every process
    after ``jax.distributed.initialize``: a rank's CUDA devices, or with
    ``device`` ``ceil(n_devices / world size)`` entries of it (default
    one) per rank, of which the first ``n_devices`` are taken."""
    ranks = None
    if dist_ready():
        world = torch.distributed.get_world_size()
        local = ([device] * (-(-int(n_devices) // world) if n_devices else 1)
                 if device is not None else _cuda_devices())
        every = [None] * world
        torch.distributed.all_gather_object(every, [str(d) for d in local])
        devices = [d for per in every for d in per][: n_devices or None]
        ranks = [r for r, per in enumerate(every)
                 for _ in per][: n_devices or None]
    elif device is not None:
        devices = [device] * int(n_devices or 1)
    else:
        devices = _cuda_devices()[: n_devices or None]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n)
        shape = (n // dp, dp)
    return Mesh(device_array(devices, shape), axis_names,
                ranks=None if ranks is None or set(ranks) == {dist_rank()}
                else ranks)


def _grid(a, mesh):
    """``a`` (of the mesh's shape) as (dp, sp): the entries of each dp
    block's sp group in sp order, the first along any other axis."""
    names = list(mesh.axis_names)
    a = np.asarray(a)
    for ax in ("sp", "dp"):
        if ax not in names:
            a = a[None]
            names = [ax] + names
    a = np.moveaxis(a, [names.index("dp"), names.index("sp")], [0, 1])
    return a.reshape(a.shape[0], a.shape[1], -1)[:, :, 0]


def own_entry_mesh(mesh):
    """The calling process's first entry of ``mesh`` as a one-entry mesh
    of the same axis names (the re-solves of one row on a mesh that
    spans processes run there, on one rank alone)."""
    mine = np.flatnonzero(mesh.rank_array().ravel() == dist_rank())
    if not len(mine):
        raise ValueError(f"rank {dist_rank()} owns no entry of {mesh}")
    return Mesh(device_array([mesh.devices.flat[int(mine[0])]],
                             (1,) * len(mesh.axis_names)), mesh.axis_names)


def _autopad_rows(n, mesh):
    """Rows to append so the batch splits evenly over the dp axis (the
    tail repeats the last row and is dropped on gather; the
    ``dp_autopad_rows`` counter and a ``dp_autopad`` event keep the
    padding visible)."""
    dp = mesh.shape.get("dp", 1)
    if n == 0:
        raise ValueError(
            f"empty batch cannot be laid out over the dp mesh axis "
            f"(mesh {dict(mesh.shape)})")
    pad = (-n) % dp
    if pad:
        metrics.counter("dp_autopad_rows").inc(pad)
        log_event("dp_autopad", rows=n, pad=pad, dp=dp)
    return pad


def _pad_tail(a, pad):
    """Repeat the last row ``pad`` times (host numpy)."""
    a = np.asarray(a)
    if not pad:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == \
        (b.index if b.index is not None else cur())


def _policy_kept(evaluate):
    """Does the evaluator's real dtype satisfy ``RAFT_TPU_DTYPE`` (an
    unset policy keeps any)?"""
    rdt = getattr(evaluate, "rdt", None)
    return (rdt is None or not config.get("DTYPE")
            or rdt == compute_dtypes()[0])


#: guards the twins kept on evaluators: entry threads bind at once
_TWIN_LOCK = threading.Lock()


def bind_evaluator(evaluate, device, slot=0):
    """``evaluate`` on ``device``: the evaluator itself when it is bound
    to that device in a dtype the ``RAFT_TPU_DTYPE`` policy accepts (or
    holds no device: a plain function), else its twin, built by the
    factory that made it (the ``_raft_factory`` stamp of
    :mod:`raft_tpu_torch.api`) with the same arguments for ``device``
    under the current policy, and kept on the evaluator for the next
    call.  ``slot`` k > 0 names the k-th further entry of the same
    device in a mesh: it always gets a twin of its own, so no two
    entries share an evaluator object."""
    own = getattr(evaluate, "device", None)
    if own is None or (slot == 0 and _same_device(own, device)
                       and _policy_kept(evaluate)):
        return evaluate
    stamp = getattr(evaluate, "_raft_factory", None)
    if stamp is None:
        raise ValueError(
            f"the evaluator is bound to {own} and carries no factory "
            f"stamp to build its twin on {device}: make it with a "
            "raft_tpu_torch.api factory, or use a mesh of its device")
    factory, args, kwargs = stamp
    key = (str(torch.device(device)), config.get("DTYPE"), int(slot))
    with _TWIN_LOCK:
        twins = evaluate.__dict__.setdefault("_raft_twins", {})
        if key not in twins:
            twins[key] = factory(*args, **dict(kwargs, device=device))
        return twins[key]


def _as_rows(a, device):
    """One input column as a tensor on ``device`` (floats as float64,
    the evaluators cast to their policy)."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float64)
    return torch.as_tensor(a, device=device)


def _banked(kind, key, args, mesh, pk):
    """The program bank in front of one program of a funnel
    (:func:`raft_tpu_torch.aot.bank.consult`): the memo key is ``key``
    plus the mesh, the evaluator flags and the program identity ``pk``,
    as the reference's ``_cached_jit`` builds it; an evaluator without
    an identity runs unbanked."""
    memo = key + (bank.mesh_key(mesh), config.flags_key(), ("program", pk))
    return bank.consult(kind, memo, args, mesh.devices.flat[0],
                        bankable=pk is not None)


#: (signature, rows, out_keys, mesh key, flags key) -> (memo_key, args)
#: of :func:`bucket_program`; a dict's get / setdefault need no lock
_BUCKET_PROGRAMS: dict = {}


def bucket_program(sig, leaves, rows, out_keys, mkey):
    """``(memo_key, args)`` of the bucket program of ``sig`` at ``rows``
    padded rows on the mesh of key ``mkey``: the one program behind
    :func:`sweep_heterogeneous`'s chunks and the serving engine's
    dispatches, so both share bank entries.  ``leaves`` are one design's
    packed leaves; the input signature is their shapes stacked to
    ``rows`` and the three sea-state columns.  Memoised per process:
    the signature fixes the leaves' shapes and dtypes, so a repeat call
    is a dict lookup."""
    ck = (sig, int(rows), tuple(out_keys), mkey, config.flags_key())
    hit = _BUCKET_PROGRAMS.get(ck)
    if hit is not None:
        return hit
    design = {k: bank.ArgSpec((int(rows),) + tuple(np.shape(v)),
                              str(np.asarray(v).dtype))
              for k, v in leaves.items()}
    sea = bank.ArgSpec((int(rows),), "float64")
    memo = ("bucket", tuple(out_keys), sig, mkey, ck[-1],
            ("program", ("bucket_evaluator",
                         bank.content_fingerprint(list(sig)))))
    return _BUCKET_PROGRAMS.setdefault(
        ck, (memo, {"design": design, "Hs": sea, "Tp": sea, "beta": sea}))


class Entry:
    """One mesh entry a sweep runs: its ``device``, owning ``rank``, dp
    and sp indices, ``slot`` (its index among the earlier entries of
    its block on the same rank and device, which run at once) and
    frequency share
    (:class:`~raft_tpu_torch.parallel.freq.Share`, None: the whole
    grid)."""

    def __init__(self, device, rank, dp, sp, slot=0, share=None):
        self.device, self.rank, self.dp, self.sp = device, rank, dp, sp
        self.slot, self.share = slot, share


#: the entries of this process's last split run and what each did
#: (:func:`last_entries`)
_LAST_LOCK = threading.Lock()
_LAST: list = []  # raft-lint: guarded-by=_LAST_LOCK


def last_entries():
    """What each local entry of this process's last sweep dispatch did:
    one dict per entry with its ``device``, ``rank``, ``dp`` and ``sp``
    indices, its ``rows`` and ``freq`` (lo, hi) ranges and ``launches``,
    its solve-kernel launches by kernel entry (the thread's own
    ledger, :func:`raft_tpu_torch.ops.linsolve.thread_launch_ledger`)."""
    with _LAST_LOCK:
        return [dict(e) for e in _LAST]


def freq_size(evaluate):
    """The frequency grid size of an evaluator made by a
    :mod:`raft_tpu_torch.api` factory (None for a plain function: its
    sp group runs on its first entry)."""
    if not isinstance(evaluate, torch.nn.Module):
        return None
    nw = getattr(evaluate, "nw", None)
    return None if nw is None else int(nw)


def _plan(mesh, nw):
    """The entries of every dp block, ``[[Entry, ...] per dp index]``:
    each block's sp group when ``nw`` (the frequency grid to split) is
    given and the sp axis is larger than 1, else its first entry; and
    the reducers of the groups, made in one order on every rank.  The
    groups that span ranks exchange over a process group of their own
    (never the default group, which the sweep's gather and the
    checkpointed drivers' orders use); groups over the same ranks share
    it, as the blocks run one after another in one order on every
    rank."""
    devs, ranks = _grid(mesh.devices, mesh), _grid(mesh.rank_array(), mesh)
    n_dp, n_sp = devs.shape
    if nw is None or n_sp == 1:
        devs, ranks, n_sp = devs[:, :1], ranks[:, :1], 1
    cuts = freq.slices(nw, n_sp) if n_sp > 1 else [None]
    me = dist_rank()
    plan = []
    for j in range(n_dp):
        reducer = None
        if n_sp > 1:
            owners = [int(r) for r in ranks[j]]
            group, where = None, None
            if len(set(owners)) > 1:
                backend = dist_backend(torch.device(devs[j, 0]).type)
                group = process_group(owners, backend, tag="sp")
                where = (torch.device("cpu") if backend == "gloo"
                         else torch.device(devs[j, owners.index(me)])
                         if me in owners else None)
            if me in owners:
                reducer = freq.GroupReducer(owners, rank=me, group=group,
                                            exchange_device=where)
        block, seen = [], {}
        for i in range(n_sp):
            dev, rank = torch.device(devs[j, i]), int(ranks[j, i])
            slot = seen.get((rank, str(dev)), 0)
            seen[(rank, str(dev))] = slot + 1
            share = (None if cuts[i] is None
                     else freq.Share(cuts[i][0], cuts[i][1], i, reducer))
            block.append(Entry(dev, rank, j, i, slot, share))
        plan.append(block)
    return plan


def _gather_group(parts, out_keys):
    """One dp block's result from its sp group's parts (in sp order):
    the frequency slices of every key with a frequency axis
    concatenated, every other key the first entry's, after checking
    that ``status`` and ``n_iter_drag`` agree across the group."""
    if len(parts) == 1:
        return parts[0]
    for k in ("status", "n_iter_drag"):
        if k in out_keys and not all(np.array_equal(parts[0][k], p[k])
                                     for p in parts[1:]):
            raise RuntimeError(
                f"the sp group's entries disagree on {k!r}: a coupling "
                "across the frequency axis did not go through the "
                "group's reducer")
    return {k: (np.concatenate([p[k] for p in parts],
                               axis=freq.FREQ_AXES[k])
                if k in freq.FREQ_AXES else parts[0][k]) for k in out_keys}


def _run_entry(run, entry, lo, hi, out_keys, turn=None):
    """One entry's block on the calling thread: under its device's
    context and its frequency share (holding ``turn``, when given, but
    while it waits for its group), gathered to host numpy; with the
    entry's solve-kernel launches."""
    from raft_tpu_torch.ops import linsolve

    ctx = (torch.cuda.device(entry.device) if entry.device.type == "cuda"
           else contextlib.nullcontext())
    l0 = linsolve.thread_launch_ledger()
    with ctx, torch.no_grad(), freq.sharing(entry.share, turn):
        out = run(entry, lo, hi)
        host = {k: to_host(out[k]) for k in out_keys}
    l1 = linsolve.thread_launch_ledger()
    rec = dict(device=str(entry.device), rank=entry.rank, dp=entry.dp,
               sp=entry.sp, rows=(lo, hi),
               freq=(None if entry.share is None
                     else (entry.share.lo, entry.share.hi)),
               launches={k: l1[k] - l0.get(k, 0) for k in l1})
    return host, rec


def _run_threads(jobs, leave):
    """Run ``jobs`` [(key, fn)], an sp group's entries, each on a named
    daemon thread of its own in the caller's context; returns ``{key:
    fn()}``.  A job that raises or finishes leaves the group
    (``leave()``): a peer still waiting on it, in a round it will not
    complete, fails instead of hanging; the call raises the first error
    that is not a peer's broken wait."""
    results, errors = {}, []
    lock = threading.Lock()

    def body(key, fn):
        try:
            value = fn()
            with lock:
                results[key] = value
        except BaseException as e:  # re-raised by the caller
            with lock:
                errors.append(e)
        finally:
            leave()

    threads = []
    for key, fn in jobs:
        ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run, args=(body, key, fn),
                             name=f"sweep-entry-{key}", daemon=True)
        threads.append(t)
        t.start()
    for t in threads:
        t.join(JOIN_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a sweep entry thread is still running after "
                           f"{JOIN_S} s")
    if errors:
        real = [e for e in errors if not isinstance(e, freq.GroupBroken)]
        raise (real or errors)[0]
    return results


def _run_block(run, local, lo, hi, out_keys):
    """This process's entries of one dp block (rows ``lo:hi``):
    ``{(dp, sp): (host, record)}``.  One entry runs on the calling
    thread; the entries of an sp group run at once, a thread each, and
    take turns on the host: each holds the turn but while it waits for
    its group (threads issuing small ops at once only contend for the
    interpreter lock: four on one card ran 18x slower than one,
    PERF.md §6, PR 20)."""
    if len(local) == 1:
        e = local[0]
        return {(e.dp, e.sp): _run_entry(run, e, lo, hi, out_keys)}
    turn = threading.Lock()
    return _run_threads(
        [((e.dp, e.sp),
          (lambda e=e: _run_entry(run, e, lo, hi, out_keys, turn)))
         for e in local], local[0].share.reducer.leave)


def portable_error(e):
    """``e`` as it can travel to another rank: itself when it pickles,
    else a RuntimeError naming its type and message."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _split_run(run, n, mesh, out_keys, nw=None, prepare=None):
    """Run ``run(entry, lo, hi)`` on every dp block of the ``n`` padded
    rows, one block after another in dp order (each block's sp group on
    its frequency slices when ``nw``, the evaluator's frequency grid
    size, is given) and gather ``out_keys`` as host numpy in row order,
    the same dict on every rank.  ``prepare(entry)``, when given, runs
    for every local entry of a block on the calling thread first (the
    evaluator twins are built there: a factory reads the model the
    other entries evaluate).  On a mesh that spans processes a rank's
    error is raised on every rank, after the gather."""
    plan = _plan(mesh, nw)
    size = n // len(plan)
    me = dist_rank()
    parts, err = {}, None
    try:
        for j, block in enumerate(plan):
            local = [e for e in block if e.rank == me]
            if not local:
                continue
            if prepare is not None:
                for e in local:
                    prepare(e)
            parts.update(_run_block(run, local, j * size, (j + 1) * size,
                                    out_keys))
    except Exception as e:
        if not mesh.spans_ranks():
            raise
        err = portable_error(e)
    with _LAST_LOCK:
        _LAST[:] = [parts[k][1] for k in sorted(parts)]
    host = {k: v[0] for k, v in parts.items()}
    if mesh.spans_ranks():
        every = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(every, (err, host))
        errors = [e for e, _ in every if e is not None]
        if errors:
            raise errors[0]
        host = {k: v for _, per in every for k, v in per.items()}
    blocks = [_gather_group([host[(e.dp, e.sp)] for e in block], out_keys)
              for block in plan]
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks]) for k in out_keys}


def sweep_cases(evaluate, Hs, Tp, beta, mesh=None, out_keys=("PSD", "X0")):
    """Evaluate a batch of sea states split over the mesh's dp axis.

    evaluate : a batched ``evaluate(Hs, Tp, beta)`` (the port's
        :func:`~raft_tpu_torch.api.make_case_evaluator`, or a function
        of (R,) tensors returning a dict of (R, ...) tensors)
    Hs/Tp/beta : (N,) arrays; a ragged batch is padded to the dp size
        (masked repeat rows, dropped on gather, ``dp_autopad`` event).

    Returns a dict of host numpy arrays of length N per ``out_keys``.
    """
    if mesh is None:
        mesh = make_mesh()
    cols = [np.asarray(x) for x in (Hs, Tp, beta)]
    n = len(cols[0])
    pad = _autopad_rows(n, mesh)
    cols = [_pad_tail(x, pad) for x in cols]

    def bind(entry):
        return bind_evaluator(evaluate, entry.device, entry.slot)

    def run(entry, lo, hi):
        return bind(entry)(*(_as_rows(x[lo:hi], entry.device) for x in cols))

    with span("sweep_dispatch", kind="cases", rows=n + pad), _banked(
            "cases", ("cases", tuple(out_keys)), cols, mesh,
            bank.program_key(evaluate)):
        out = _split_run(run, n + pad, mesh, out_keys, prepare=bind)
    return {k: v[:n] for k, v in out.items()}


def sweep_cases_full(evaluate, cases, mesh=None, out_keys=("PSD", "X0"),
                     shard_freq=False):
    """Evaluate a batch of full-physics cases split over the mesh.

    evaluate : a batched ``evaluate(**rows)`` (the port's
        :func:`~raft_tpu_torch.api.make_full_evaluator`, or the farm /
        flexible variants, or a function of (R, ...) tensors)
    cases : dict of (N, ...) arrays — any subset of the evaluator's row
        keys; a ragged N pads to the dp size (masked repeat rows,
        dropped on gather, ``dp_autopad`` event).
    shard_freq : on a mesh with an ``sp`` axis larger than 1, split the
        frequency grid over each dp block's sp group (see the module
        docstring); elsewhere it changes nothing.

    ``"status"`` is a first-class out_key: the per-row int32 solver
    health word the checkpointed drivers' quarantine reads.

    Returns a dict of host numpy arrays of length N per ``out_keys``.
    """
    if mesh is None:
        mesh = make_mesh()
    cases = {k: np.asarray(v) for k, v in cases.items()}
    lengths = {k: len(v) for k, v in cases.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(
            f"ragged case dict: all case arrays must have equal length, "
            f"got {lengths}")
    n = next(iter(lengths.values()))
    pad = _autopad_rows(n, mesh)
    cases = {k: _pad_tail(v, pad) for k, v in cases.items()}

    def bind(entry):
        return bind_evaluator(evaluate, entry.device, entry.slot)

    def run(entry, lo, hi):
        return bind(entry)(**{k: _as_rows(v[lo:hi], entry.device)
                              for k, v in cases.items()})

    with span("sweep_dispatch", kind="cases_full", rows=n), _banked(
            "cases_full", ("cases_full", tuple(out_keys), tuple(sorted(cases)),
                           bool(shard_freq)), cases, mesh,
            bank.program_key(evaluate)):
        out = _split_run(run, n + pad, mesh, out_keys,
                         nw=freq_size(evaluate) if shard_freq else None,
                         prepare=bind)
    return {k: v[:n] for k, v in out.items()}


def _pack(model):
    sig = bucketing.bucket_signature(model)
    return bucketing.PackedDesign(sig=sig,
                                  leaves=bucketing.pack_design(model, sig))


def sweep_heterogeneous(designs, Hs, Tp, beta, device=None, mesh=None,
                        out_keys=("PSD", "X0", "status"), timer=None):
    """Evaluate row i = (designs[i], Hs[i], Tp[i], beta[i]) for all rows.

    designs : sequence of Model or PackedDesign, one per row (repeat an
        object to evaluate it under several sea states; each distinct
        model is packed once).
    Hs, Tp, beta : (n,) sea-state arrays.
    mesh : the devices to split rows over (default: a mesh of
        ``device`` when it is given, else :func:`make_mesh`).
    timer : optional ``timer(stage)`` callback passed to every chunk's
        evaluator (see :meth:`BucketEvaluator.forward`).

    Rows are grouped by bucket signature; each group runs in chunks of
    ``RAFT_TPU_BUCKET_ROWS`` (rounded up to the dp size; the last chunk
    of a multi-chunk group padded with masked repeat rows, a single
    chunk padded to the dp size), each chunk split over the mesh's dp
    devices, through the process-cached :class:`BucketEvaluator` of
    each (signature, device).  Each chunk dispatch runs in a
    ``sweep_dispatch`` span; the padding waste per axis feeds the
    metrics registry and the ``bucket_sweep`` event.

    Returns a dict of host numpy arrays of length n per ``out_keys``.
    """
    if mesh is None:
        mesh = make_mesh(device=device)
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
    packed, axes = {}, {}
    for d in designs:
        if id(d) not in packed:
            if isinstance(d, bucketing.PackedDesign):
                packed[id(d)] = d
                axes[id(d)] = None
            else:
                packed[id(d)] = p = _pack(d)
                axes[id(d)] = bucketing.axis_counts(d, p.sig)
    rows = [packed[id(d)] for d in designs]
    w_grids = {tuple(bucketing.signature_meta(d.sig)["w"]) for d in rows}
    if len(w_grids) > 1:
        raise ValueError("mixed frequency grids in one heterogeneous sweep: "
                         "outputs cannot be stacked")
    groups = {}
    for i, d in enumerate(rows):
        groups.setdefault(d.sig, []).append(i)

    dp = mesh.shape.get("dp", 1)
    cap = int(config.get("BUCKET_ROWS"))
    if cap:
        cap = -(-cap // dp) * dp
    out = {}
    n_row_pad = 0
    for sig, idxs in groups.items():
        if cap and len(idxs) > cap:
            chunks = [idxs[a:a + cap] for a in range(0, len(idxs), cap)]
        else:
            chunks = [idxs]
        # each distinct design of the group on each device once; a
        # block gathers its rows from that stack
        slot, distinct = {}, []
        for i in idxs:
            if id(rows[i]) not in slot:
                slot[id(rows[i])] = len(distinct)
                distinct.append(rows[i].leaves)
        leaves = bucketing.stack_packed(distinct)
        stacks = {}  # the group's designs per device

        def run(entry, lo, hi, take=None, leaves=leaves, slot=slot,
                stacks=stacks):
            dev = entry.device
            if str(dev) not in stacks:
                stacks[str(dev)] = bucketing.packed_from_numpy(leaves, dev)
            stack = stacks[str(dev)]
            ev = bucketing.get_bucket_evaluator(sig, dev)
            t = take[lo:hi]
            sel = torch.as_tensor(
                np.asarray([slot[id(rows[i])] for i in t]), device=dev)
            design = {k: v[sel] for k, v in stack.items()}
            return ev(design, _as_rows(Hs[t], dev), _as_rows(Tp[t], dev),
                      _as_rows(beta[t], dev), timer=timer)

        for chunk in chunks:
            m = len(chunk)
            pad = (cap - m) if len(chunks) > 1 else _autopad_rows(m, mesh)
            n_row_pad += pad
            take = chunk + [chunk[-1]] * pad
            memo, args = bucket_program(sig, distinct[0], m + pad,
                                        out_keys, bank.mesh_key(mesh))
            with span("sweep_dispatch", kind="bucket", rows=m,
                      bucket=bucketing.signature_fingerprint(sig)), \
                    bank.consult("bucket", memo, args, mesh.devices.flat[0]):
                res = _split_run(
                    lambda entry, lo, hi, take=take: run(entry, lo, hi, take),
                    m + pad, mesh, out_keys)
            for k in out_keys:
                host = res[k][:m]
                if k not in out:
                    out[k] = np.zeros((n,) + host.shape[1:], dtype=host.dtype)
                out[k][chunk] = host
    # waste is row-weighted: one packed entry per dispatched row
    row_axes = [axes[id(d)] for d in designs if axes[id(d)] is not None]
    bucketing.observe_axis_waste(row_axes, rows_valid=n,
                                 rows_padded=n + n_row_pad)
    log_event("bucket_sweep", rows=n, n_buckets=len(groups),
              n_designs=len(packed),
              padding_waste_frac=round(bucketing.padding_waste_frac(
                  [d.leaves for d in rows]), 4),
              waste_by_axis=bucketing.waste_by_axis(row_axes))
    metrics.counter("bucket_sweeps").inc()
    return out


def full_compute(evaluate, out_keys=("PSD", "X0"), shard_freq=False):
    """The per-shard compute of the full checkpointed driver:
    ``compute(chunk_dict, mesh) -> dict`` padding the chunk to the
    device count and running :func:`sweep_cases_full`.  Module-level so
    every runner evaluates shards through one code path; the
    evaluator's fabric stamp (``_raft_fabric_entry``) is carried onto
    the returned callable."""
    def compute(chunk, mesh_):
        ndev = mesh_.devices.size
        pad = (-len(next(iter(chunk.values())))) % ndev
        if pad:
            chunk = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                     for k, v in chunk.items()}
        return sweep_cases_full(evaluate, chunk, mesh=mesh_,
                                out_keys=out_keys, shard_freq=shard_freq)

    _stamp_fabric(compute, evaluate, out_keys, shard_freq=shard_freq)
    return compute


def case_compute(evaluate, out_keys=("PSD", "X0")):
    """Per-shard compute of the (Hs, Tp, beta) checkpointed driver — see
    :func:`full_compute`."""
    def compute(chunk, mesh_):
        ndev = mesh_.devices.size
        h, t, b = chunk["Hs"], chunk["Tp"], chunk["beta"]
        pad = (-len(h)) % ndev  # pad the tail shard to the device count
        if pad:
            h = np.concatenate([h, np.full(pad, h[-1])])
            t = np.concatenate([t, np.full(pad, t[-1])])
            b = np.concatenate([b, np.full(pad, b[-1])])
        return sweep_cases(evaluate, h, t, b, mesh=mesh_, out_keys=out_keys)

    _stamp_fabric(compute, evaluate, out_keys)
    return compute


def _routes_to_fabric(evaluate):
    """True when the checkpointed runner would hand this sweep to the
    worker fabric (the condition of ``resilience.run_checkpointed``)."""
    return (int(config.get("FABRIC_WORKERS") or 0) > 1
            and getattr(evaluate, "_raft_fabric_entry", None) is not None)


def _stamp_fabric(compute, evaluate, out_keys, shard_freq=False):
    """Copy the evaluator's fabric entry spec onto its compute closure,
    with the call-time sweep arguments (out_keys, shard_freq) folded
    in.  An evaluator without a stamp cannot run on a fabric."""
    spec = getattr(evaluate, "_raft_fabric_entry", None)
    if not spec:
        return
    compute._raft_fabric_entry = {
        "entry": spec["entry"],
        "kwargs": {**(spec.get("kwargs") or {}),
                   "out_keys": list(out_keys),
                   "shard_freq": bool(shard_freq)},
        "warmup": spec.get("warmup"),
    }


def run_sweep_checkpointed_full(evaluate, cases, out_dir, shard_size=256,
                                mesh=None, out_keys=("PSD", "X0"),
                                shard_freq=False, on_shard=None,
                                max_retries=3, backoff_s=0.5,
                                quarantine_retry=True):
    """Checkpointed full-physics sweep over a case dict.

    Each shard of the (N,)-array batch runs through
    :func:`sweep_cases_full` and lands in ``<out_dir>/shard_NNNN.npz``;
    re-running skips completed shards (resume after preemption).
    ``on_shard(done, total, fresh)`` is called after each shard
    (``fresh`` False when it was resumed from disk).

    Fault tolerance (:mod:`raft_tpu_torch.parallel.resilience`): shard
    files are written atomically and validated on resume (a truncated,
    corrupt or stale shard is recomputed); ``manifest.json``
    fingerprints the inputs, so resuming with changed cases, out_keys or
    shard_size raises ``ManifestMismatchError``; transient errors retry
    with exponential backoff (``max_retries``, ``backoff_s``), a device
    OOM halves the shard; non-finite and SEVERE-status rows are
    quarantined to ``quarantine.json`` (after an optional solo
    re-evaluation on the CPU, ``quarantine_retry``).  ``mesh=None``
    resolves the CUDA devices after a health probe, and raises when the
    probe fails or no CUDA device exists (pass a CPU mesh,
    ``make_mesh(device="cpu")``, to run on the CPU).  An evaluator that
    carries a fabric entry stamp runs on ``RAFT_TPU_FABRIC_WORKERS``
    worker processes when that is > 1 (:mod:`raft_tpu_torch.parallel.
    fabric`); ``mesh=None`` is then left to the workers, which probe the
    card themselves, and a CPU mesh sends them to the CPU.
    """
    from raft_tpu_torch.parallel import resilience

    if mesh is None and not _routes_to_fabric(evaluate):
        mesh = resilience.resolve_mesh(make_mesh)
    return resilience.run_checkpointed(
        full_compute(evaluate, out_keys=out_keys, shard_freq=shard_freq),
        cases, out_dir, shard_size, mesh, out_keys,
        on_shard=on_shard, max_retries=max_retries, backoff_s=backoff_s,
        quarantine_retry=quarantine_retry)


def run_sweep_checkpointed(evaluate, Hs, Tp, beta, out_dir, shard_size=256,
                           mesh=None, out_keys=("PSD", "X0"),
                           on_shard=None, max_retries=3, backoff_s=0.5,
                           quarantine_retry=True):
    """Checkpointed (Hs, Tp, beta) sweep through :func:`sweep_cases`,
    with the fault-tolerant runtime of
    :func:`run_sweep_checkpointed_full`.  Returns the dict of
    concatenated results."""
    from raft_tpu_torch.parallel import resilience

    if mesh is None and not _routes_to_fabric(evaluate):
        mesh = resilience.resolve_mesh(make_mesh)
    cases = {"Hs": np.asarray(Hs), "Tp": np.asarray(Tp),
             "beta": np.asarray(beta)}
    return resilience.run_checkpointed(
        case_compute(evaluate, out_keys=out_keys),
        cases, out_dir, shard_size, mesh, out_keys,
        on_shard=on_shard, max_retries=max_retries, backoff_s=backoff_s,
        quarantine_retry=quarantine_retry)


def qtf_slender_sharded(model, beta, Xi0=None, ifowt=0, mesh=None,
                        pair_chunk=None):
    """The slender-body QTF of one FOWT with its upper-triangle
    frequency pairs split over the mesh's devices (the reference's
    ``qtf_slender_sharded``; ``beta`` [rad] is the heading, as in
    :meth:`~raft_tpu_torch.models.model.Model.qtf_slender`).

    :func:`~raft_tpu_torch.physics.qtf_slender.fowt_qtf_slender` with
    ``devices``: the pair list padded to the device count (repeating
    its first pair) and cut into contiguous blocks, each block's pair
    forces of every member run on its device, and the assembly (Pinkster
    IV, Kim & Yue, the hermitian completion) on the mesh's first device.
    Returns (nw2, nw2, 1, nDOF) complex128 numpy.
    """
    from raft_tpu_torch.physics.qtf_slender import fowt_qtf_slender

    if mesh is None:
        mesh = make_mesh()
    devs = list(mesh.devices.flat)
    nw2 = 0 if model.w1_2nd is None else len(model.w1_2nd)
    with torch.no_grad(), span("qtf_slender_sharded",
                               pairs=nw2 * (nw2 + 1) // 2,
                               devices=len(devs)):
        qtf = fowt_qtf_slender(model, beta, Xi0=Xi0, ifowt=ifowt,
                               device=devs[0], devices=devs,
                               pair_chunk=pair_chunk)
        return qtf.cpu().numpy()
