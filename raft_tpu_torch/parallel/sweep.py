"""Device-list sweep drivers (counterpart of ``raft_tpu/parallel/sweep.py``).

A sweep lays a batch of rows (sea states, full-physics cases, mixed
designs) over a :class:`Mesh`: an array of ``torch.device`` entries with
named axes.  Rows split into contiguous ``dp`` blocks, one block per
device, each block run through the evaluator bound to that device (the
evaluator chunks its block by its own ``RAFT_TPU_BUCKET_ROWS``); a batch
not divisible by the ``dp`` size is padded by repeating its last row
(``dp_autopad`` counter and event) and the pad is dropped on gather.
The results come back as host numpy arrays in input order.  The blocks
run one after another, each gathered before the next starts, so a mesh
of k cards takes as long as its k blocks back to back (overlap is
ROADMAP A15(g)).  A row's
result does not depend on the block it ran in on the CPU: one entry
gives the plain evaluator call's bits, k entries the same bits again.
On the card the same holds where every block keeps the evaluator's
chunk size; a block of another size may round differently (the
library's batched products pick their kernels by shape).

An evaluator made by one of the factories of :mod:`raft_tpu_torch.api`
holds tensors built for its device; on another device of the mesh it
runs as a twin, built by the same factory with the same arguments for
that device (:func:`bind_evaluator`).  A plain function evaluator gets
its inputs on each block's device.

Under ``RAFT_TPU_AOT=load|require`` the program bank
(:mod:`raft_tpu_torch.aot.bank`) fronts :func:`sweep_cases`,
:func:`sweep_cases_full` and each bucket chunk of
:func:`sweep_heterogeneous`, with the reference's memo keys (the
evaluator's program identity, out_keys, the mesh's devices, the
evaluator flags) and the padded inputs' signature.

:func:`run_sweep_checkpointed_full` and :func:`run_sweep_checkpointed`
run a sweep in shards through the fault-tolerant runtime of
:mod:`raft_tpu_torch.parallel.resilience` (atomic shard files, manifest,
retries, OOM halving, quarantine); :func:`qtf_slender_sharded` splits
the slender-body QTF's frequency pairs over the mesh.

The reference's frequency-axis sharding (``shard_freq`` over an ``sp``
mesh axis) changes a layout and never a value: the argument is kept,
and on a mesh without an ``sp`` axis of size > 1 the values are those
of ``shard_freq=False``.  A mesh with ``sp`` > 1 raises, and the
reference's multi-host ``ensure_distributed`` has no counterpart yet
(both ROADMAP A15(g)).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.aot import bank
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.obs.spans import span
from raft_tpu_torch.structure import bucketing
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.devices import to_host
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device
from raft_tpu_torch.utils.structlog import log_event

#: the ROADMAP item that will hold a frequency (``sp``) mesh axis
SP_ITEM = "A15(g)"


class Mesh:
    """Devices laid out over named axes (the port's stand-in for a JAX
    ``Mesh``): ``devices`` an object array of ``torch.device``, one
    array axis per name; ``shape`` ``{axis: size}``; ``axis_names``."""

    def __init__(self, devices, axis_names=("dp",)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def device_array(devices, shape=None):
    """``devices`` (torch devices or their names) as an object array of
    ``torch.device`` of ``shape`` (default: one axis)."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape or (len(devices),))


def make_mesh(n_devices=None, axis_names=("dp",), device=None):
    """A mesh of the first ``n_devices`` CUDA devices (all of them when
    None), or of ``device`` repeated ``n_devices`` times (default once):
    k CPU entries stand in for k devices in the CPU tests, and
    ``make_mesh(2, device="cuda")`` puts two row blocks on one card.
    Without CUDA and without ``device`` this raises, as
    :func:`~raft_tpu_torch.utils.dtypes.resolve_device` does.  Two axis
    names split the devices as evenly as possible, ``(n // dp, dp)``, as
    the reference does."""
    if device is not None:
        devices = [device] * int(n_devices or 1)
    else:
        resolve_device(None)  # raises without CUDA
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)][: n_devices or n]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n)
        shape = (n // dp, dp)
    return Mesh(device_array(devices, shape), axis_names)


def _dp_devices(mesh):
    """The devices of the ``dp`` axis, one per row block.  A mesh with
    an ``sp`` axis of size > 1 raises (see the module docstring)."""
    if mesh.shape.get("sp", 1) > 1:
        raise NotImplementedError(
            f"a mesh with an 'sp' axis of size {mesh.shape['sp']}: the "
            f"frequency axis is not split over devices yet (ROADMAP "
            f"{SP_ITEM})")
    if "dp" not in mesh.shape:
        return [mesh.devices.flat[0]]
    ax = mesh.axis_names.index("dp")
    return list(np.moveaxis(mesh.devices, ax, 0).reshape(
        mesh.shape["dp"], -1)[:, 0])


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


def bind_evaluator(evaluate, device):
    """``evaluate`` on ``device``: the evaluator itself when it is bound
    to that device in a dtype the ``RAFT_TPU_DTYPE`` policy accepts (or
    holds no device: a plain function), else its twin, built by the
    factory that made it (the ``_raft_factory`` stamp of
    :mod:`raft_tpu_torch.api`) with the same arguments for ``device``
    under the current policy, and kept on the evaluator for the next
    call."""
    own = getattr(evaluate, "device", None)
    if own is None or (_same_device(own, device)
                       and _policy_kept(evaluate)):
        return evaluate
    stamp = getattr(evaluate, "_raft_factory", None)
    if stamp is None:
        raise ValueError(
            f"the evaluator is bound to {own} and carries no factory "
            f"stamp to build its twin on {device}: make it with a "
            "raft_tpu_torch.api factory, or use a mesh of its device")
    factory, args, kwargs = stamp
    twins = evaluate.__dict__.setdefault("_raft_twins", {})
    key = (str(torch.device(device)), config.get("DTYPE"))
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


def _split_run(run, n, mesh, out_keys):
    """Run ``run(device, lo, hi)`` on every dp block of the ``n`` padded
    rows and gather ``out_keys`` as host numpy in row order."""
    devs = _dp_devices(mesh)
    size = n // len(devs)
    parts = []
    with torch.no_grad():
        for j, dev in enumerate(devs):
            out = run(dev, j * size, (j + 1) * size)
            parts.append({k: to_host(out[k]) for k in out_keys})
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in out_keys}


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

    def run(dev, lo, hi):
        ev = bind_evaluator(evaluate, dev)
        return ev(*(_as_rows(x[lo:hi], dev) for x in cols))

    with span("sweep_dispatch", kind="cases", rows=n + pad), _banked(
            "cases", ("cases", tuple(out_keys)), cols, mesh,
            bank.program_key(evaluate)):
        out = _split_run(run, n + pad, mesh, out_keys)
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
    shard_freq : the reference's frequency-axis output sharding; it
        changes no value (see the module docstring).

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
    # shard_freq is a layout, never a value (module docstring)
    cases = {k: _pad_tail(v, pad) for k, v in cases.items()}

    def run(dev, lo, hi):
        ev = bind_evaluator(evaluate, dev)
        return ev(**{k: _as_rows(v[lo:hi], dev) for k, v in cases.items()})

    with span("sweep_dispatch", kind="cases_full", rows=n), _banked(
            "cases_full", ("cases_full", tuple(out_keys), tuple(sorted(cases)),
                           bool(shard_freq)), cases, mesh,
            bank.program_key(evaluate)):
        out = _split_run(run, n + pad, mesh, out_keys)
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

        def run(dev, lo, hi, take=None):
            if str(dev) not in stacks:
                stacks[str(dev)] = bucketing.packed_from_numpy(leaves, dev)
            ev = bucketing.get_bucket_evaluator(sig, dev)
            t = take[lo:hi]
            sel = torch.as_tensor(
                np.asarray([slot[id(rows[i])] for i in t]), device=dev)
            design = {k: v[sel] for k, v in stacks[str(dev)].items()}
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
                res = _split_run(lambda dev, lo, hi: run(dev, lo, hi, take),
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
