"""Periodic device heartbeats for OOM forensics and liveness (the
port's copy of ``raft_tpu/obs/heartbeat.py``, sampling the CUDA
caching allocator).

A sweep that dies of device OOM (or silently slows down as live
buffers pile up) is much easier to debug when the event log carries
the memory picture that *preceded* the failure: quarantined rows and
``shard_oom_split`` events then have heartbeats around them showing
per-device allocator bytes (``torch.cuda.memory_allocated`` /
``max_memory_allocated`` / ``mem_get_info``) and how far the sweep had
progressed.

Enable with ``RAFT_TPU_HEARTBEAT_S=<seconds>`` (0 disables — the
default).  The sampler is one daemon thread emitting ``heartbeat``
JSONL events (the structlog sink is lock-protected for exactly this
reason) and updating the ``device_bytes_in_use`` /
``device_peak_bytes_in_use`` / ``live_arrays`` gauges, whose high
watermarks survive into the metrics snapshot (``heartbeat`` block of
the bench breakdown).

A CPU device has no allocator stats: its row carries only its id and
kind, and the heartbeat still reports shard progress and host RSS.
PyTorch keeps no registry of live tensors, so ``live_arrays`` is
``None``.  Sampling must never take down the run: every CUDA query is
wrapped, and a failure is reported in-band on the device's row
(``error``).
"""

from __future__ import annotations

import contextlib
import re
import threading

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.structlog import log_event

#: the procfs status file the RSS sampler reads — module-level so tests
#: (and exotic hosts) can point it elsewhere
PROC_STATUS_PATH = "/proc/self/status"

# one-shot availability memo: a host without procfs (macOS, some
# sandboxes) fails the FIRST open and is never probed again — the rss
# gauges simply stay absent, with no per-beat reopen or warning spam
_PROC_AVAILABLE = [True]


def sample_host_rss():
    """``(rss_bytes, peak_bytes)`` of THIS process from
    ``/proc/self/status`` (``VmRSS``/``VmHWM`` — no psutil dependency):
    the host-side memory picture the device allocator cannot see
    (packed design pytrees, result caches, the CPU backend's arrays all
    live in host RSS).  ``(None, None)`` on hosts without procfs —
    permanently, after one failed open."""
    if not _PROC_AVAILABLE[0]:
        return None, None
    try:
        with open(PROC_STATUS_PATH) as f:
            text = f.read()
    except OSError:
        _PROC_AVAILABLE[0] = False
        return None, None

    def field(name):
        m = re.search(rf"^{name}:\s+(\d+)\s*kB", text, re.MULTILINE)
        return int(m.group(1)) * 1024 if m else None

    return field("VmRSS"), field("VmHWM")


def sample_devices(devices=None):
    """One host-side sample: per-device allocator bytes.  Returns
    ``(device_rows, live_arrays)`` (``live_arrays`` is always None:
    PyTorch keeps no registry of live tensors); ``devices`` are
    ``torch.device`` entries (default: every visible CUDA device)."""
    import torch

    rows = []
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            rows.append({"id": d.index, "kind": d.type})
            continue
        idx = d.index if d.index is not None else torch.cuda.current_device()
        row = {"id": idx, "kind": "?"}
        try:
            row["kind"] = torch.cuda.get_device_name(idx)
            row["bytes_in_use"] = int(torch.cuda.memory_allocated(idx))
            row["peak_bytes_in_use"] = int(
                torch.cuda.max_memory_allocated(idx))
            free, total = torch.cuda.mem_get_info(idx)
            row["bytes_limit"] = int(total)
            row["bytes_free"] = int(free)
        except Exception as e:  # noqa: BLE001 — reported in-band
            row["error"] = str(e)[:200]
        rows.append(row)
    return rows, None


class Heartbeat(threading.Thread):
    """Daemon sampler thread (use :func:`maybe_heartbeat` to gate on
    the flag).  ``progress`` is a plain dict the owner mutates in
    place (e.g. ``{"shards_done": 3, "n_shards": 20}``); each beat
    snapshots it, so the heartbeat stream doubles as a liveness probe
    for the sweep itself."""

    def __init__(self, interval_s, devices=None, progress=None,
                 worker_id=None, leases=None):
        super().__init__(name="raft-tpu-heartbeat", daemon=True)
        self.interval_s = float(interval_s)
        self.devices = list(devices) if devices is not None else None
        self.progress = progress
        # fabric liveness: each beat carries the worker id and the
        # shard leases it currently holds, so a captured stream shows
        # who was alive holding what when a lease later expired
        self.worker_id = worker_id
        self.leases = leases  # callable -> list of held shard ids
        self.beats = 0
        # NB: not `_stop` — threading.Thread uses that name internally
        self._stop_evt = threading.Event()
        self._final_done = False

    def beat(self):
        try:
            rows, live = sample_devices(self.devices)
        except Exception as e:  # backend gone mid-run: report, don't die
            log_event("heartbeat", devices=[], live_arrays=None,
                      error=str(e)[:200])
            return
        in_use = [r["bytes_in_use"] for r in rows if "bytes_in_use" in r]
        peak = [r["peak_bytes_in_use"] for r in rows
                if "peak_bytes_in_use" in r]
        if in_use:
            metrics.gauge("device_bytes_in_use").set(max(in_use))
        if peak:
            metrics.gauge("device_peak_bytes_in_use").set(max(peak))
        if live is not None:
            metrics.gauge("live_arrays").set(live)
        kw = {}
        # host-process RSS next to the device picture: the gauges' high
        # watermarks survive into the metrics snapshot, so run records
        # capture peak host memory alongside the device allocator's
        rss, hwm = sample_host_rss()
        if rss is not None:
            metrics.gauge("host_rss_bytes").set(rss)
            kw["host_rss_bytes"] = rss
        if hwm is not None:
            metrics.gauge("host_rss_peak_bytes").set(hwm)
            kw["host_rss_peak_bytes"] = hwm
        # same window length the live /healthz endpoint reports, so a
        # captured beat and a concurrent scrape agree on the SLO view
        wins = metrics.sample_windows(
            float(config.get("SERVE_WINDOW_S") or 0) or None)
        if wins:
            # sliding-window time series (serve request latency): each
            # beat carries the last-N-seconds p50/p95/rate, so a capture
            # shows the SLO view over time, not just the final state
            kw["windows"] = wins
        if self.progress:
            kw["progress"] = dict(self.progress)
        if self.worker_id is not None:
            kw["worker_id"] = self.worker_id
        if self.leases is not None:
            try:
                kw["leases"] = sorted(self.leases())
            except Exception:  # ledger mid-mutation: beat without leases
                pass
        log_event("heartbeat", devices=rows, live_arrays=live, **kw)
        self.beats += 1

    def run(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.beat()
            except Exception:
                # the sampler must outlive any single bad sample (beat
                # already reports failures in-band where it can)
                pass

    def stop(self, final_beat=True):
        """Stop the sampler; by default take one last beat so the log
        (and the gauges' watermarks) end with the terminal memory
        picture.  Idempotent — the sweep runner stops the heartbeat
        explicitly before snapshotting metrics, and the context exit
        calling again is a no-op."""
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=max(2.0, 2 * self.interval_s))
        if final_beat and not self._final_done:
            self._final_done = True
            self.beat()


@contextlib.contextmanager
def maybe_heartbeat(devices=None, progress=None, worker_id=None,
                    leases=None):
    """Start a :class:`Heartbeat` for the block when
    ``RAFT_TPU_HEARTBEAT_S`` > 0, else yield ``None`` at zero cost."""
    interval = config.get("HEARTBEAT_S")
    if not interval or interval <= 0:
        yield None
        return
    hb = Heartbeat(interval, devices=devices, progress=progress,
                   worker_id=worker_id, leases=leases)
    hb.start()
    try:
        yield hb
    finally:
        hb.stop()
