"""Static and dynamic checkers of the port (counterpart of
``raft_tpu/analysis``).

* :mod:`raft_tpu_torch.analysis.lint` — an AST linter for the hot
  path's bug classes: 64-bit dtype literals, host coercions of tensors
  in the traced modules, raw ``RAFT_TPU_*`` env reads outside
  :mod:`raft_tpu_torch.utils.config`, unregistered event and span
  names, and dead registry entries;
* :mod:`raft_tpu_torch.analysis.concurrency` — the multi-process
  runtime's invariants: atomic ledger and store writes, a non-blocking
  serve event loop, lock discipline over the annotated shared
  registries, thread hygiene;
* :mod:`raft_tpu_torch.analysis.schemas` — the writer and reader key
  sets of every cross-process record family, pinned in
  ``schema_baseline.json``;
* :mod:`raft_tpu_torch.analysis.protocol` and
  :mod:`~raft_tpu_torch.analysis.mcheck` — the shared-filesystem
  mutation sites of the fleet's protocols, pinned in
  ``protocol_baseline.json``, and an explorer of their interleavings
  and crashes over the real protocol functions;
* :mod:`raft_tpu_torch.analysis.contracts` — the counterpart of the
  reference's jaxpr contracts: the aten ops each hot-path entry runs on
  the spar demo, recorded under a ``TorchDispatchMode`` (gathers in
  the drag trips, host syncs, 64-bit outputs under float32, per-entry
  op budgets pinned in ``op_baseline.json``, and a repeat call that
  builds nothing).

CLI: ``python -m raft_tpu_torch.analysis
{lint,concurrency,schemas,protocol,contracts,baseline,flags}``.  The
first four import neither torch nor jax.
"""

from raft_tpu_torch.analysis.lint import Finding, lint_paths  # noqa: F401
