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

The reference's event registry, run records, alerts, trace report and
CLI are not ported yet (ROADMAP A15(c)).  Importing this package turns
the flight recorder on.
"""

from raft_tpu_torch.obs import metrics  # noqa: F401
from raft_tpu_torch.obs.heartbeat import (  # noqa: F401
    Heartbeat, maybe_heartbeat)
from raft_tpu_torch.obs.spans import (  # noqa: F401
    current_ids, format_traceparent, parse_traceparent, propagation_env,
    span)
from raft_tpu_torch.utils.structlog import run_id  # noqa: F401
