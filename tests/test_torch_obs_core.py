"""The port's telemetry core (``raft_tpu_torch/obs`` and
``utils/structlog.py``) against the reference's modules.

The same calls go through both packages' modules and must give the
same outputs, apart from ids and clocks:

* ``metrics``: the snapshot (counters, gauges, histograms with their
  exemplars, windows) and the Prometheus text;
* ``spans`` over ``structlog``: the JSONL records of nested spans, a
  failing span, a ``stage`` and the free events inside them;
* ``flight``: the dump records of a ring filled with logging off.

Then a subset of ``tests/test_obs.py`` on the port's copies alone
(registry thread safety, kind collisions, windows, exemplar admission,
the flight ring's bound, dump layout and the strict reader), and the
port's own heartbeat sampler (CPU rows carry no allocator stats; a
CUDA query failure is reported in-band).
"""

import io
import json
import os
import re
import threading
import time

import pytest
import torch

from raft_tpu.obs import flight as jflight
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.obs import spans as jspans
from raft_tpu.utils import structlog as jstructlog
from raft_tpu_torch.obs import flight, heartbeat, metrics
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.utils import structlog

PAIRS = {"port": (metrics, tspans, structlog, flight),
         "jax": (jmetrics, jspans, jstructlog, jflight)}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in ("RAFT_TPU_LOG", "RAFT_TPU_FLIGHT_DIR", "RAFT_TPU_FLIGHT_RING",
              "RAFT_TPU_EXEMPLAR_MIN_S", "RAFT_TPU_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAFT_TPU_EXEMPLAR_K", "2")
    for m, _, _, f in PAIRS.values():
        m.reset()
        f.reset()
    yield
    for m, _, _, f in PAIRS.values():
        m.reset()
        f.reset()


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _drive_metrics(m):
    m.counter("rows_evaluated").inc(12)
    m.counter("shards_done").inc()
    m.counter("shards_done").inc(2)
    m.gauge("device_bytes_in_use").set(7.0)
    m.gauge("device_bytes_in_use").set(3.0)
    h = m.histogram("shard_wall_s")
    for v in (0.013, 0.21, 0.22, 1.7, 45.0):
        h.observe(v, exemplar={"shard": int(v * 10), "rows": 4})
    m.histogram("pad_waste_strips").observe(0.25)
    w = m.window("serve_latency_s")
    for v in (0.02, 0.04, 0.5):
        w.observe(v)


_UNIX = re.compile(r"(# \{.*\} \S+) \d+\.\d{3}$")


def test_metrics_snapshot_and_prometheus_match_reference():
    snaps, texts = {}, {}
    for name, (m, _, _, _) in PAIRS.items():
        _drive_metrics(m)
        snap = m.snapshot()
        snap.pop("uptime_s")
        for h in snap["histograms"].values():
            for ex in h.get("exemplars", {}).values():
                ex[1] = None  # the admission's unix time
        snaps[name] = snap
        # exemplar clauses end in the admission's unix time
        texts[name] = "\n".join(_UNIX.sub(r"\1 T", line)
                                for line in m.to_prometheus().splitlines())
    assert snaps["port"] == snaps["jax"]
    assert texts["port"] == texts["jax"]
    assert 'raft_tpu_shard_wall_s_bucket{le="+Inf"} 5' in texts["port"]
    assert "# {rows=" in texts["port"]


def _drive_spans(sp, sl):
    with sp.span("sweep", out_dir="d", n_cases=3):
        sl.log_event("sweep_start", n_cases=3, out_keys=["X0"])
        with sp.span("shard", shard=0, rows=3):
            sl.log_event("shard_start", shard=0, rows=3)
            with sl.stage("statics", case=1):
                pass
        with pytest.raises(ValueError):
            with sp.span("shard_attempt", shard=1, attempt=1):
                raise ValueError("boom")
        sl.log_event("sweep_done", n_quarantined=0)


def _normalise(records):
    """Records without clocks (times, span wall times), pids and run
    ids; span and trace ids as their order of first appearance."""
    ids = {}

    def idn(v):
        return None if v is None else ids.setdefault(v, len(ids))

    out = []
    for r in records:
        r = {k: v for k, v in r.items()
             if k not in ("t", "pid", "run_id", "wall_s", "unix_t", "argv0")}
        for k in ("trace_id", "span_id", "parent_id"):
            if k in r:
                r[k] = idn(r[k])
        if r["event"] == "exemplar_recorded":
            r.pop("value")  # a span's wall time
        out.append(r)
    return out


def test_span_records_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_RUN_ID", "run-parity")
    recs = {}
    for name, (_, sp, sl, _) in PAIRS.items():
        path = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("RAFT_TPU_LOG", path)
        _drive_spans(sp, sl)
        monkeypatch.delenv("RAFT_TPU_LOG")
        sl.log_event("after_close")  # retargets: the file is complete
        evs = _events(path)
        assert evs[0]["event"] == "proc_start"
        assert all(e["run_id"] == "run-parity" for e in evs)
        recs[name] = _normalise(evs[1:])
    assert recs["port"] == recs["jax"]
    names = [r["event"] for r in recs["port"]]
    assert names.count("span_begin") == names.count("span_end") == 3
    (end,) = [r for r in recs["port"]
              if r["event"] == "span_end" and r["name"] == "shard_attempt"]
    assert end["ok"] is False and "boom" in end["error"]


def test_flight_dump_matches_reference():
    recs = {}
    for name, (_, sp, sl, f) in PAIRS.items():
        _drive_spans(sp, sl)
        recs[name] = _normalise(f.serialize_records(trigger="parity"))
    assert recs["port"] == recs["jax"]
    hdr = recs["port"][0]
    assert hdr["event"] == "proc_start"
    assert hdr["flight"]["trigger"] == "parity"
    assert hdr["flight"]["version"] == jflight.SCHEMA_VERSION


# --------------------------------------------------- the port's copies alone


def test_registry_thread_safety_and_kind_collision():
    c = metrics.counter("t_conc")
    h = metrics.histogram("t_conc_h")

    def work():
        for i in range(2000):
            c.inc()
            h.observe(i % 7 + 0.5)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8 * 2000 and h.count == 8 * 2000
    assert h.min == 0.5 and h.max == 6.5
    with pytest.raises(TypeError, match="already registered"):
        metrics.gauge("t_conc")


def test_window_percentiles_expiry_and_tail_exemplars():
    w = metrics.window("t_win")
    now = time.perf_counter()
    w.observe(99.0, t=now - 120.0)
    for v in (1.0, 2.0, 3.0, 4.0):
        w.observe(v, t=now - 1.0, exemplar={"v": v})
    snap = w.snapshot(now=now)
    assert snap["count"] == 4 and snap["total"] == 5
    assert snap["p95"] == 4.0 and snap["max"] == 4.0
    assert w.percentile(1.0, window_s=300.0, now=now) == 99.0
    assert [lab["v"] for _, lab in w.tail_exemplars(k=2, now=now)] \
        == [4.0, 3.0]


def test_exemplar_admission_and_event(tmp_path, monkeypatch):
    p = str(tmp_path / "ev.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)
    h = metrics.histogram("t_ex")
    h.observe(1.10, exemplar={"design": "a"})
    h.observe(1.30, exemplar={"design": "b"})
    h.observe(1.20, exemplar={"design": "c"})
    ((v, unix_t, labels),) = h.exemplars().values()
    assert v == 1.30 and labels == {"design": "b"} and unix_t > 1e9
    monkeypatch.setenv("RAFT_TPU_EXEMPLAR_MIN_S", "2.0")
    h2 = metrics.histogram("t_ex_min")
    h2.observe(1.5, exemplar={"design": "d"})
    assert h2.exemplars() == {}
    assert [e["value"] for e in _events(p)
            if e["event"] == "exemplar_recorded"] == [1.10, 1.30, 1.20]


def test_flight_ring_bound_dump_layout_and_strict_reader(tmp_path,
                                                         monkeypatch):
    with tspans.span("boxed", shard=3):
        structlog.log_event("shard_start", shard=3, rows=8)
    assert not structlog.enabled()
    assert [r[0] for r in flight.ring_records()] == ["sb", "ev", "se"]
    monkeypatch.setenv("RAFT_TPU_FLIGHT_RING", "4")
    flight.reset()
    for i in range(10):
        structlog.log_event("shard_start", shard=i, rows=1)
    recs = flight.ring_records()
    assert len(recs) == 4 and recs[-1][4]["shard"] == 9
    monkeypatch.delenv("RAFT_TPU_FLIGHT_RING")
    flight.reset()

    assert flight.dump(trigger="manual") is None  # nowhere to write
    p = str(tmp_path / "flight.jsonl")
    structlog.log_event("shard_start", shard=0, rows=1)
    assert flight.dump(trigger="manual", path=p) == p
    hdr, records = flight.read_shard(p)
    assert hdr["flight"]["trigger"] == "manual"
    # the summary: the reference's lines, its span table from the
    # port's trace report module
    buf = io.StringIO()
    assert flight.show(p, out=buf) == 0
    text = buf.getvalue()
    assert "flight shard v1 (trigger=manual" in text
    assert "spans: 0 matched, 0 still open at dump" in text
    assert "shard_start" in text
    monkeypatch.setenv("RAFT_TPU_FLIGHT_DIR", str(tmp_path / "box"))
    auto = flight.dump(trigger="quarantine-severe")
    assert auto.endswith(f"flight-{os.getpid()}-quarantine-severe.jsonl")
    monkeypatch.delenv("RAFT_TPU_FLIGHT_DIR")

    text = open(p).read()
    trunc = tmp_path / "trunc.jsonl"
    trunc.write_text(text[:-15])
    with pytest.raises(flight.FlightError, match="unparseable"):
        flight.read_shard(str(trunc))
    headless = tmp_path / "headless.jsonl"
    headless.write_text("".join(text.splitlines(True)[1:]))
    with pytest.raises(flight.FlightError, match="anchor"):
        flight.read_shard(str(headless))


# ------------------------------------------------------------- heartbeat


def test_heartbeat_samples_devices_and_progress(tmp_path, monkeypatch):
    p = str(tmp_path / "hb.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)
    progress = {"shards_done": 1, "n_shards": 4}
    hb = heartbeat.Heartbeat(0.05, devices=[torch.device("cpu")],
                             progress=progress)
    hb.beat()
    (ev,) = [e for e in _events(p) if e["event"] == "heartbeat"]
    assert ev["devices"] == [{"id": None, "kind": "cpu"}]
    assert ev["live_arrays"] is None
    assert ev["progress"] == progress
    assert ev["host_rss_bytes"] > 0

    # a CUDA query that fails is reported on the device's row
    def fail(*a, **k):
        raise RuntimeError("driver gone")

    monkeypatch.setattr(torch.cuda, "get_device_name", fail)
    rows, live = heartbeat.sample_devices([torch.device("cuda", 0)])
    assert rows == [{"id": 0, "kind": "?", "error": "driver gone"}]
    assert live is None


def test_heartbeat_thread_lifecycle_and_gate(tmp_path, monkeypatch):
    p = str(tmp_path / "hb.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", p)
    monkeypatch.delenv("RAFT_TPU_HEARTBEAT_S", raising=False)
    with heartbeat.maybe_heartbeat(devices=[torch.device("cpu")]) as hb:
        assert hb is None
    monkeypatch.setenv("RAFT_TPU_HEARTBEAT_S", "0.02")
    with heartbeat.maybe_heartbeat(devices=[torch.device("cpu")],
                                   progress={"shards_done": 0}) as hb:
        time.sleep(0.1)
    assert not hb.is_alive() and hb.beats >= 2
    assert sum(e["event"] == "heartbeat" for e in _events(p)) == hb.beats
