"""Telemetry core of the port (counterpart of ``raft_tpu/obs``): spans,
metrics, the flight recorder and heartbeats, in the reference's record
formats.

* :mod:`raft_tpu_torch.obs.spans` — hierarchical, contextvar-propagated
  spans around sweeps, shards, retry attempts and escalation rungs,
  mirrored onto the ``torch.profiler`` timeline under
  ``RAFT_TPU_PROFILE``;
* :mod:`raft_tpu_torch.obs.metrics` — the process-wide registry
  (counters, gauges, log-bucket histograms with exemplars), snapshotted
  into the sweep manifest and ``metrics.json`` and exportable as
  Prometheus text (``RAFT_TPU_METRICS``);
* :mod:`raft_tpu_torch.obs.flight` — the always-on postmortem ring,
  dumped on a SEVERE quarantine (``RAFT_TPU_FLIGHT_DIR``);
* :mod:`raft_tpu_torch.obs.heartbeat` — the optional device sampler
  thread (``RAFT_TPU_HEARTBEAT_S``).

* :mod:`raft_tpu_torch.obs.events` — the registry of every event and
  span name the port emits;
* :mod:`raft_tpu_torch.obs.runs` — the run-record store and regression
  sentinel (``RAFT_TPU_RUNS_DIR``);
* :mod:`raft_tpu_torch.obs.report` — ``python -m raft_tpu_torch.obs
  report`` and ``... trace`` (Chrome/Perfetto export, multi-process
  merge) over captured JSONL.

* :mod:`raft_tpu_torch.obs.alerts` — the alert-rule engine, its daemon
  and sink, and the ``x-raft-provenance`` codec.

Importing this package turns the flight recorder on.
"""

from raft_tpu_torch.obs import events, metrics  # noqa: F401
from raft_tpu_torch.obs.heartbeat import (  # noqa: F401
    Heartbeat, maybe_heartbeat)
from raft_tpu_torch.obs.spans import (  # noqa: F401
    current_ids, format_traceparent, parse_traceparent, propagation_env,
    span)
from raft_tpu_torch.utils.structlog import run_id  # noqa: F401
