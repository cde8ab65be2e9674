"""The port's evaluation service core (``raft_tpu_torch.serve``), ported
from ``tests/test_serve.py``: the result cache, quotas and ladder
helpers, then the socket-free batcher on the CPU over the spar demo
(tick coalescing, in-flight dedup, span links, the stage split, tail
exemplars, the SLO window and ``/healthz``, mixed-bucket routing, the
cache, out_keys subsets, quota -> 429 and a full queue -> 503, drain,
the f64 escalation, the bounded inline registry, the report section).

Every served row is also held bit-equal to a direct
:class:`~raft_tpu_torch.structure.bucketing.BucketEvaluator` call on
the padded group the batcher recorded.  The goldens of the JAX serving
engine are held in ``tests/test_torch_serve_goldens.py``; the server
subprocess (HTTP, SIGTERM drain) in ``tests/test_torch_serve_http.py``.
"""

import os

import numpy as np
import pytest

from raft_tpu_torch.serve import engine
from tests.test_torch_ladders import _toy_entry, _ToyRegistry

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")


def design_path(name):
    return os.path.join(FIX, f"design_{name}.json")


def hold_direct(batcher, group, out_keys=None):
    """One recorded dispatch group against a direct bucket-evaluator
    call on the same padded group: bit-equal, every key."""
    import torch

    from raft_tpu_torch.structure import bucketing
    from raft_tpu_torch.utils.devices import to_host

    entries = group["entries"]
    n = len(entries)
    design, seas = engine.padded_group(entries, group["Hs"], group["Tp"],
                                       group["beta"], group["padded"],
                                       batcher.device)
    with torch.no_grad():
        ev = bucketing.get_bucket_evaluator(entries[0].sig, batcher.device)
        direct = ev(design, *seas)
    for k in out_keys or batcher.out_keys:
        np.testing.assert_array_equal(group["out"][k],
                                      to_host(direct[k][:n]), err_msg=k)
    return direct


# ------------------------------------------------------------- pure units


def test_result_cache_hit_and_evict():
    from raft_tpu_torch.serve.cache import ResultCache, result_cache_key

    row = {"PSD": np.zeros((6, 40)), "status": np.int32(0)}
    nbytes = sum(np.asarray(v).nbytes for v in row.values())
    cache = ResultCache(max_bytes=int(nbytes * 2.5),
                        metrics_prefix="test_torch_cache")
    k1 = result_cache_key("d", {"Hs": 5.0, "Tp": 10.0}, ("PSD", "status"))
    k2 = result_cache_key("d", {"Hs": 5.0, "Tp": 10.000001},
                          ("PSD", "status"))
    assert k1 != k2  # exact float bits, no rounding
    assert result_cache_key("d", {"Tp": 10.0, "Hs": 5.0},
                            ("PSD", "status")) == k1  # order-insensitive
    assert cache.get(k1) is None
    assert cache.put(k1, row)
    got = cache.get(k1)
    assert got is not None and np.array_equal(got["PSD"], row["PSD"])
    # fill past the byte budget: LRU (k1 was just touched) evicts k2
    assert cache.put(k2, row)
    k3 = result_cache_key("d", {"Hs": 7.0}, ("PSD", "status"))
    assert cache.get(k1) is not None  # refresh k1 recency
    assert cache.put(k3, row)
    assert cache.evictions == 1
    assert cache.get(k2) is None and cache.get(k1) is not None
    # an entry larger than the whole budget is refused, not crashed on
    assert not cache.put(k3, {"big": np.zeros(10**6)})
    stats = cache.stats()
    assert stats["entries"] == 2 and stats["evictions"] == 1


def test_token_bucket_and_quotas():
    from raft_tpu_torch.serve.quota import ClientQuotas, TokenBucket

    clock = [0.0]
    b = TokenBucket(rate=2.0, burst=2.0, clock=lambda: clock[0])
    assert b.acquire() and b.acquire()
    assert not b.acquire()          # burst drained
    assert b.retry_after_s() > 0
    clock[0] += 0.5                 # one token refilled
    assert b.acquire() and not b.acquire()
    # rate<=0 disables
    assert all(TokenBucket(0, 1).acquire() for _ in range(100))
    q = ClientQuotas(rate=1.0, burst=1.0, max_clients=2,
                     clock=lambda: clock[0])
    assert q.acquire("a") and not q.acquire("a")
    assert q.acquire("b")           # independent buckets


def test_token_bucket_equals_the_references():
    """The same clock and the same calls: the same answers."""
    from raft_tpu.serve.quota import ClientQuotas as JQuotas
    from raft_tpu_torch.serve.quota import ClientQuotas

    clock = [0.0]
    rng = np.random.default_rng(3)
    qs = [cls(rate=2.0, burst=3.0, max_clients=3, clock=lambda: clock[0])
          for cls in (ClientQuotas, JQuotas)]
    for _ in range(200):
        clock[0] += float(rng.uniform(0.0, 0.4))
        client = f"c{int(rng.integers(5))}"
        got = [q.acquire(client) for q in qs]
        assert got[0] == got[1]
        if rng.uniform() < 0.2:
            for q in qs:
                q.bucket(client).refund()
        ra = [q.bucket(client).retry_after_s() for q in qs]
        assert ra[0] == ra[1]


def test_wire_and_backoff_equal_the_references():
    from raft_tpu.serve import client as jclient
    from raft_tpu.serve import wire as jwire
    from raft_tpu_torch.serve import client, wire

    for args in ((200, {"ok": True}, True), (429, {"retry_after_s": 2.4},
                                             False),
                 (503, {"ok": False}, True, {"traceparent": "x"}),
                 (200, "metric 1\n", False)):
        assert wire.response_bytes(*args) == jwire.response_bytes(*args)
    for attempt in range(6):
        for ra in (None, 0.3, 5.0):
            assert client.backoff_delay(attempt, retry_after_s=ra) == \
                jclient.backoff_delay(attempt, retry_after_s=ra)


def test_out_keys_normalization_and_ladder():
    assert engine.normalize_out_keys(("PSD",)) == ("PSD", "status")
    assert engine.normalize_out_keys(("status", "X0")) == ("status", "X0")
    assert engine.batch_ladder(8) == (1, 2, 4, 8)
    assert engine.batch_ladder(5) == (1, 2, 4)
    assert engine.pick_padded(3, (1, 2, 4, 8)) == 4
    assert engine.pick_padded(1, (1, 2, 4, 8)) == 1


def test_pack_for_serving_equals_the_packed_fixture():
    """api.pack_for_serving: the bucket signature and packed leaves of
    the JAX builder's fixture, and the design's content fingerprint as
    the reference computes it."""
    import json

    from raft_tpu.aot.bank import content_fingerprint as jfp
    from raft_tpu_torch.api import pack_for_serving
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.structure import bucketing

    with open(design_path("mhk")) as f:
        design = json.load(f)
    sig, packed, fp = pack_for_serving(Model(design))
    ref = bucketing.load_packed(os.path.join(FIX, "packed_mhk.npz"))
    assert sig == ref.sig
    assert sorted(packed) == sorted(ref.leaves)
    assert fp == jfp(design)


def test_unbucketable_design_is_refused_at_registration():
    from raft_tpu_torch.serve.engine import Registry
    from raft_tpu_torch.structure.bucketing import UnbucketableDesignError

    with pytest.raises(UnbucketableDesignError):
        Registry().register("flex", design_path("spar_flex"))


# ------------------------------------------------------ batcher core (cpu)


@pytest.fixture(scope="module")
def serve_stack():
    """One spar registry and a manual-tick batcher on the CPU that
    records its dispatched groups."""
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.cache import ResultCache
    from raft_tpu_torch.serve.engine import Registry
    from raft_tpu_torch.serve.quota import ClientQuotas

    registry = Registry()
    registry.register("spar", design_path("spar"))
    batcher = Batcher(
        registry, device="cpu", tick_ms=5, max_batch=2,
        cache=ResultCache(32 * 10**6, metrics_prefix="test_torch_serve"),
        quotas=ClientQuotas(rate=0.0, burst=1.0), queue_bound=64,
        group_log=64)
    return registry, batcher


def test_tick_coalescing_one_dispatch(serve_stack):
    from raft_tpu_torch.obs import metrics

    _, batcher = serve_stack
    d0 = metrics.counter("serve_dispatches").value
    futs = [batcher.submit("spar", 4.0 + 0.25 * i, 9.0, 0.05 * i)
            for i in range(2)]
    assert all(not f.done() for f in futs)   # pending until the tick
    assert batcher.run_tick() == 2
    # 2 distinct spar cases coalesce into ONE padded dispatch
    assert metrics.counter("serve_dispatches").value - d0 == 1
    for i, f in enumerate(futs):
        res = f.result(timeout=5)
        assert res["status_text"] == "ok" and not res["cache_hit"]
        assert set(res["outputs"]) == {"PSD", "X0", "status"}
        group = batcher.groups[-1]
        for k in batcher.out_keys:
            np.testing.assert_array_equal(res["outputs"][k],
                                          group["out"][k][i])
    hold_direct(batcher, batcher.groups[-1])


def test_duplicate_inflight_requests_share_one_row(serve_stack):
    from raft_tpu_torch.obs import metrics

    _, batcher = serve_stack
    c0 = metrics.counter("serve_coalesced").value
    d0 = metrics.counter("serve_dispatches").value
    futs = [batcher.submit("spar", 6.125, 11.0, 0.25) for _ in range(3)]
    futs += [batcher.submit("spar", 6.5, 11.5, 0.25) for _ in range(3)]
    batcher.run_tick()
    # 6 requests, 2 unique rows, one 2-row dispatch
    assert metrics.counter("serve_coalesced").value - c0 == 4
    assert metrics.counter("serve_dispatches").value - d0 == 1
    rows = [f.result(5)["outputs"]["PSD"] for f in futs[:3]]
    for r in rows[1:]:
        assert np.array_equal(np.asarray(rows[0]), np.asarray(r))
    hold_direct(batcher, batcher.groups[-1])


def test_tick_span_links_request_spans(serve_stack, tmp_path, monkeypatch):
    """One trace across the submit/tick thread boundary: the tick span
    records span-links to every coalesced request span, and the bucket
    dispatch span nests under the tick."""
    from raft_tpu_torch.obs.report import collect_spans, read_events

    _, batcher = serve_stack
    log = str(tmp_path / "serve_events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    ctx_a = ("feed" * 4, "aaaa" * 4)
    ctx_b = ("feed" * 4, "bbbb" * 4)
    futs = [batcher.submit("spar", 5.0, 10.0, 0.0, trace_ctx=ctx_a),
            batcher.submit("spar", 5.0, 10.0, 0.0, trace_ctx=ctx_b),
            batcher.submit("spar", 5.5, 10.5, 0.1)]  # no client trace
    batcher.run_tick()
    for f in futs:
        f.result(timeout=30)
    evs, bad = read_events(log)
    assert bad == 0
    spans_, _ = collect_spans(evs)
    by_name = {s["name"]: s for s in spans_}
    tick = by_name["serve_tick"]
    links = tick["attrs"]["links"]
    assert {(lk["trace_id"], lk["span_id"]) for lk in links} == \
        {ctx_a, ctx_b}
    # the dispatch span is a tree CHILD of the tick span
    dispatch = by_name["sweep_dispatch"]
    assert dispatch["parent_id"] == tick["span_id"]
    assert dispatch["trace_id"] == tick["trace_id"]
    assert dispatch["attrs"]["kind"] == "serve"


def test_request_stage_attribution_sums_to_total(serve_stack, tmp_path,
                                                 monkeypatch):
    """Tail attribution: every dispatched request's latency decomposes
    into queue-wait / tick-wait / dispatch / solve / post stages that
    sum to its measured end-to-end latency, feed the serve_stage_*
    histograms, and render as the p50-vs-p95 table in obs report."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.obs import report as obs_report
    from raft_tpu_torch.obs.report import SERVE_STAGES

    _, batcher = serve_stack
    log = str(tmp_path / "stage_events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    c0 = {s: metrics.histogram(f"serve_stage_{s}_s").count
          for s in SERVE_STAGES}
    futs = [batcher.submit("spar", 4.5 + 0.125 * i, 9.5, 0.02 * i)
            for i in range(2)]
    batcher.run_tick()
    for f in futs:
        f.result(timeout=60)
    for s in SERVE_STAGES:
        assert metrics.histogram(f"serve_stage_{s}_s").count - c0[s] == 2
    evs, bad = obs_report.read_events(log)
    assert bad == 0
    stage_evs = [e for e in evs if e["event"] == "serve_request_stages"]
    assert len(stage_evs) == 2
    for e in stage_evs:
        total = sum(e[f"{s}_s"] for s in SERVE_STAGES)
        assert total == pytest.approx(e["wall_s"], rel=0.01, abs=1e-4)
        assert e["solve_s"] > 0
    att = obs_report.report_data(evs)["serve_stages"]
    assert att["n_requests"] == 2
    for col in ("p50", "p95"):
        assert att[col]["stages_sum_s"] == pytest.approx(
            att[col]["total_s"], rel=0.01, abs=1e-4)
    # waste attribution fed by the serving dispatch: exact per-axis
    # counter pairs (the spar's strips are padded)
    assert metrics.counter("pad_total_strips").value \
        > metrics.counter("pad_valid_strips").value > 0
    assert metrics.counter("pad_total_rows").value \
        >= metrics.counter("pad_valid_rows").value > 0
    # cache hits resolve at submit and carry no stage decomposition
    n0 = metrics.histogram("serve_stage_solve_s").count
    fut = batcher.submit("spar", 4.5, 9.5, 0.0)
    assert fut.result(timeout=5)["cache_hit"]
    assert metrics.histogram("serve_stage_solve_s").count == n0


def test_request_exemplars_name_the_actual_request(serve_stack, tmp_path,
                                                   monkeypatch):
    """Tail exemplars ride the real dispatch path: the latency histogram
    names the request (design hash, bucket signature, rows, ids,
    replica), /metrics renders it in OpenMetrics exemplar syntax, and
    ``obs report --tail`` joins it back to the stage breakdown."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.obs import report as obs_report

    _, batcher = serve_stack
    log = str(tmp_path / "ex_events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    metrics.reset()       # empty exemplar slots: both requests admit
    ctx_a = ("feed" * 4, "cafe" * 4)
    ctx_b = ("feed" * 4, "beef" * 4)
    futs = [batcher.submit("spar", 3.75, 9.25, 0.05, trace_ctx=ctx_a),
            batcher.submit("spar", 3.85, 9.75, 0.0, trace_ctx=ctx_b)]
    batcher.run_tick()
    for f in futs:
        f.result(timeout=60)
    ex = metrics.histogram("serve_request_s").exemplars()
    labels = [lab for _, _, lab in ex.values()]
    hit = next(lab for lab in labels if lab.get("trace_id") == "feed" * 4)
    assert hit["span_id"] in (ctx_a[1], ctx_b[1])
    assert hit["design"] and hit["sig"] and hit["rows"] == 2
    assert hit["cache_hit"] == 0 and hit["status"] == 0
    assert hit["replica"]
    assert any("serve_request_s_bucket" in line and "# {" in line
               for line in metrics.to_prometheus().splitlines())
    evs, bad = obs_report.read_events(log)
    assert bad == 0
    view = obs_report.tail_view(evs, rank=1.0)
    assert view["n_requests"] == 2
    assert view["span_id"] in (ctx_a[1], ctx_b[1])
    assert view["trace_id"] == "feed" * 4
    assert view["exemplar"]["span_id"] == view["span_id"]
    assert view["exemplar"]["design"] == hit["design"]
    assert view["stages"]["solve"] > 0
    txt = obs_report.render_tail(evs, rank=1.0, source=log)
    assert "design" in txt and "solve" in txt


def test_slo_breach_window_and_healthz(serve_stack, monkeypatch):
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.serve.http import Server

    _, batcher = serve_stack
    # an absurdly tight SLO: every real dispatch breaches it
    monkeypatch.setenv("RAFT_TPU_SERVE_SLO_MS", "0.0001")
    b0 = metrics.counter("serve_slo_breaches").value
    w0 = metrics.window("serve_request_window_s").total
    fut = batcher.submit("spar", 7.0, 12.0, 0.125)
    batcher.run_tick()
    fut.result(timeout=30)
    assert metrics.counter("serve_slo_breaches").value > b0
    assert metrics.window("serve_request_window_s").total > w0
    code, body = Server(batcher)._healthz()
    assert code == 200
    assert body["window"]["count"] >= 1 and body["window"]["p95"] > 0
    assert body["slo"]["slo_ms"] == 0.0001
    assert body["slo"]["breaches"] >= 1
    assert isinstance(body["cost_ledger"], list)
    # the port's counterparts of the reference's XLA compile counts
    assert body["kernel"] == {"built_here": bool(linsolve.BUILT_HERE),
                              "loaded": linsolve._LIB is not None,
                              "launches": linsolve.launch_ledger()}
    assert "xla_compiles" not in body
    assert body["device"] == "cpu"
    monkeypatch.setenv("RAFT_TPU_SERVE_SLO_MS", "0")
    code, body = Server(batcher)._healthz()
    assert body["slo"]["slo_ms"] is None


def test_bucket_group_routing_one_dispatch_per_signature(serve_stack):
    """Mixed spar+semi tick: one dispatch per bucket signature, each
    group bit-equal to a direct evaluator call on it, each row equal to
    its group's row."""
    from raft_tpu_torch.obs import metrics

    registry, batcher = serve_stack
    spar = registry.get("spar")
    semi = (registry.get("semi")
            or registry.register("semi", design_path("semi")))
    assert spar.sig != semi.sig
    cases = [(spar, 5.5, 10.0, 0.1), (semi, 5.5, 10.0, 0.1),
             (spar, 7.0, 12.0, -0.2), (semi, 3.0, 8.0, 0.3)]
    d0 = metrics.counter("serve_dispatches").value
    futs = [batcher.submit(e, h, t, b) for e, h, t, b in cases]
    batcher.run_tick()
    assert metrics.counter("serve_dispatches").value - d0 == 2  # per sig
    groups = list(batcher.groups)[-2:]
    assert {g["entries"][0].sig for g in groups} == {spar.sig, semi.sig}
    for g in groups:
        assert len(g["entries"]) == 2 and g["padded"] == 2
        hold_direct(batcher, g)
    for (entry, h, t, b), fut in zip(cases, futs):
        res = fut.result(5)
        g = next(g for g in groups if g["entries"][0] is entry)
        i = next(i for i, (x, y, z) in enumerate(zip(g["Hs"], g["Tp"],
                                                     g["beta"]))
                 if (x, y, z) == (h, t, b))
        assert res["status"] == int(g["out"]["status"][i])
        for k in ("PSD", "X0"):
            np.testing.assert_array_equal(res["outputs"][k], g["out"][k][i])


def test_cache_hit_skips_dispatch(serve_stack):
    from raft_tpu_torch.obs import metrics

    _, batcher = serve_stack
    f1 = batcher.submit("spar", 4.75, 9.5, 0.0)
    batcher.submit("spar", 4.8, 9.5, 0.0)
    batcher.run_tick()
    r1 = f1.result(5)
    d0 = metrics.counter("serve_dispatches").value
    f2 = batcher.submit("spar", 4.75, 9.5, 0.0)
    assert f2.done()                       # resolved at submit time
    r2 = f2.result(0)
    assert r2["cache_hit"] and not r1["cache_hit"]
    assert metrics.counter("serve_dispatches").value == d0
    for k in r1["outputs"]:
        assert np.array_equal(np.asarray(r1["outputs"][k]),
                              np.asarray(r2["outputs"][k]))


def test_requested_out_keys_subset_and_unknown(serve_stack):
    _, batcher = serve_stack
    f = batcher.submit("spar", 5.0, 10.0, 0.0, out_keys=("X0",))
    batcher.submit("spar", 5.1, 10.0, 0.0)
    batcher.run_tick()
    assert set(f.result(5)["outputs"]) == {"X0"}
    with pytest.raises(ValueError, match="not served"):
        batcher.submit("spar", 5.0, 10.0, 0.0, out_keys=("Xi",))
    with pytest.raises(KeyError):
        batcher.submit("nope", 5.0, 10.0, 0.0)


def test_quota_and_queue_rejection(serve_stack):
    from raft_tpu_torch.serve.batcher import Batcher, QueueFull, QuotaExceeded
    from raft_tpu_torch.serve.cache import ResultCache
    from raft_tpu_torch.serve.quota import ClientQuotas

    registry, _ = serve_stack
    clock = [0.0]
    tight = Batcher(
        registry, device="cpu", tick_ms=5, max_batch=2,
        cache=ResultCache(10**6, metrics_prefix="test_torch_serve2"),
        quotas=ClientQuotas(rate=0.001, burst=2.0, clock=lambda: clock[0]),
        queue_bound=4)
    assert tight.submit("spar", 9.0, 10.0, 0.0, client="greedy") is not None
    assert tight.submit("spar", 9.1, 10.0, 0.0, client="greedy") is not None
    with pytest.raises(QuotaExceeded) as ei:
        tight.submit("spar", 9.2, 10.0, 0.0, client="greedy")
    assert ei.value.http_status == 429 and ei.value.retry_after_s > 0
    # other clients are unaffected by one client's dry bucket...
    assert tight.submit("spar", 9.3, 10.0, 0.0, client="polite") is not None
    assert tight.submit("spar", 9.4, 10.0, 0.0, client="other") is not None
    # ...until the shared admission queue hits its bound (503)
    with pytest.raises(QueueFull) as ei:
        tight.submit("spar", 9.5, 10.0, 0.0, client="other")
    assert ei.value.http_status == 503
    tight.drain()


def test_drain_finishes_pending_then_refuses(serve_stack):
    from raft_tpu_torch.serve.batcher import Batcher, Draining
    from raft_tpu_torch.serve.cache import ResultCache

    registry, _ = serve_stack
    b = Batcher(registry, device="cpu", tick_ms=5, max_batch=2,
                cache=ResultCache(10**6,
                                  metrics_prefix="test_torch_serve3"),
                queue_bound=16)
    # submit BEFORE starting the tick thread: the backlog drains as one
    # deterministic 2-row tick
    futs = [b.submit("spar", 3.0 + 0.5 * i, 10.5, 0.0) for i in range(2)]
    b.start()
    rep = b.drain(timeout=120)
    assert rep["completed"]
    for f in futs:                      # every accepted request resolved
        assert f.done() and f.result(0)["status_text"] == "ok"
    with pytest.raises(Draining):
        b.submit("spar", 3.0, 10.5, 0.0)


def test_escalate_row_f64(serve_stack, monkeypatch):
    """The per-request quarantine-style re-solve: the row alone on the
    CPU under the f64_cpu rung flags, counted in serve_escalations; a
    healthy case re-solves healthy, with the plain dispatch's numbers
    (its drag fixed point ends before either iteration budget)."""
    from raft_tpu_torch.obs import metrics

    registry, batcher = serve_stack
    e0 = metrics.counter("serve_escalations").value
    row, status = engine.escalate_row(registry.get("spar"), 5.0, 10.0, 0.1,
                                      out_keys=batcher.out_keys)
    assert metrics.counter("serve_escalations").value == e0 + 1
    assert set(row) == set(batcher.out_keys)
    assert status == 0
    assert np.asarray(row["status"]).dtype == np.int32
    base = engine.dispatch([registry.get("spar")], [5.0], [10.0], [0.1],
                           out_keys=batcher.out_keys, device="cpu",
                           padded=1, record_metrics=False)
    for k in batcher.out_keys:
        np.testing.assert_array_equal(row[k], base[k][0])


def test_escalation_adopts_only_a_healthy_resolve(serve_stack, monkeypatch):
    """A SEVERE row with escalate_f64 re-solves once; a healthy re-solve
    is adopted for the escalating requester only, a still-severe one
    never is, and no severe row is cached."""
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.cache import ResultCache

    registry, _ = serve_stack
    severe = _severe_status()
    real = engine.dispatch

    def flagged(*a, **k):
        out = real(*a, **k)
        out["status"] = np.full_like(out["status"], severe)
        return out

    for healthy in (True, False):
        monkeypatch.setattr(engine, "dispatch", flagged)
        calls = []

        def esc(entry, Hs, Tp, beta, out_keys=None):
            calls.append((Hs, Tp, beta))
            row = {k: np.zeros(1) for k in out_keys}
            row["status"] = np.int32(0 if healthy else severe)
            return row, int(row["status"])

        monkeypatch.setattr(engine, "escalate_row", esc)
        b = Batcher(registry, device="cpu", tick_ms=5, max_batch=2,
                    cache=ResultCache(10**6,
                                      metrics_prefix="test_torch_serve4"))
        f_esc = b.submit("spar", 6.0, 9.0, 0.0, escalate_f64=True)
        f_plain = b.submit("spar", 6.0, 9.0, 0.0)
        b.run_tick()
        r_esc, r_plain = f_esc.result(5), f_plain.result(5)
        assert len(calls) == 1
        assert r_plain["severe"] and r_plain["escalated"] is None
        assert r_esc["escalated"]["resolved"] is healthy
        assert r_esc["severe"] is (not healthy)
        assert b.cache.stats()["entries"] == 0


def _severe_status():
    from raft_tpu_torch.utils import health

    for bit in range(31):
        if health.any_bit(1 << bit):
            return 1 << bit
    raise AssertionError("no severe status bit")


def test_report_serve_section():
    from raft_tpu_torch.obs.report import render_report

    events = [
        {"t": 0.1, "event": "serve_request", "pid": 1, "endpoint":
         "/evaluate", "method": "POST", "code": 200, "client": "a",
         "wall_s": 0.02, "cache_hit": False},
        {"t": 0.2, "event": "serve_request", "pid": 1, "endpoint":
         "/evaluate", "method": "POST", "code": 200, "client": "a",
         "wall_s": 0.001, "cache_hit": True},
        {"t": 0.3, "event": "serve_request", "pid": 1, "endpoint":
         "/healthz", "method": "GET", "code": 200, "client": "a",
         "wall_s": 0.0005, "cache_hit": False},
        {"t": 0.25, "event": "serve_tick", "pid": 1, "rows": 3,
         "unique": 2, "n_groups": 1, "dispatches": 1, "wall_s": 0.015},
    ]
    text = render_report(events, source="synthetic")
    assert "serve endpoints" in text
    assert "/evaluate" in text and "/healthz" in text
    assert "ticks: 1 (3 requests, 2 unique rows, 1 dispatches" in text


def test_registry_inline_cache_is_bounded(monkeypatch):
    """Tenant-supplied inline designs must recycle LRU slots, not grow
    the always-on server's RSS without bound."""
    from raft_tpu_torch.aot.bank import content_fingerprint
    from raft_tpu_torch.serve.engine import Registry

    built = []

    class _Dummy:
        def __init__(self, name, fp):
            self.name, self.fingerprint = name, fp

    reg = Registry(max_inline=2)
    monkeypatch.setattr(
        Registry, "_build",
        lambda self, name, design: built.append(name) or _Dummy(
            name, content_fingerprint(design)))
    a = reg.resolve_inline({"d": 1.0})
    assert reg.resolve_inline({"d": 1.0}) is a      # fingerprint hit
    reg.resolve_inline({"d": 2.0})
    reg.resolve_inline({"d": 1.0})                  # refresh a's recency
    reg.resolve_inline({"d": 3.0})                  # evicts d=2 (LRU)
    assert len(built) == 3
    reg.resolve_inline({"d": 2.0})          # rebuilt; evicts d=1 (LRU)
    assert len(built) == 4
    reg.resolve_inline({"d": 3.0})          # still cached, no rebuild
    assert len(built) == 4


def test_inline_design_of_a_registered_design_is_that_entry(serve_stack):
    """An inline post of a registered design's content (as its model
    holds it: the model build fills defaults in, in both packages) resolves
    to the registered entry, nothing is built."""
    import copy

    from raft_tpu_torch.obs import metrics

    registry, _ = serve_stack
    spar = registry.get("spar")
    n0 = metrics.counter("serve_inline_designs").value
    assert registry.resolve_inline(copy.deepcopy(spar.model.design)) is spar
    assert metrics.counter("serve_inline_designs").value == n0


def test_warm_and_provenance(serve_stack):
    """warm dispatches every (signature x rung) twice and fills the wall
    ledger the cost ladder reads; the provenance stamps name the
    program identity per design, the port's code hash and flags."""
    from raft_tpu_torch.aot.bank import code_fingerprint

    registry, batcher = serve_stack
    entries = [registry.get("spar")]
    reps = engine.warm(entries, device="cpu", out_keys=batcher.out_keys,
                       sizes=(1, 2))
    assert [(r["rows"], r["kind"]) for r in reps] == [(1, "serve"),
                                                     (2, "serve")]
    walls = engine.ladder_walls(entries, (1, 2, 4),
                                out_keys=batcher.out_keys)
    assert walls[1] > 0 and walls[2] > 0
    prov = engine.build_provenance(registry, out_keys=batcher.out_keys,
                                   sizes=(1, 2), replica_id="rA")
    assert prov["*"] == {"code": code_fingerprint(),
                         "flags": engine.flags_fingerprint(),
                         "replica": "rA"}
    assert prov["spar"]["bank_key"] == engine.program_identity(
        entries[0], out_keys=batcher.out_keys, rows=1)[0]
    assert prov["spar"]["bank_sha"] == "none"


def test_warm_reports_bank_loads_and_provenance_bank_sha(serve_stack,
                                                       tmp_path,
                                                       monkeypatch):
    """The AOT halves of the reference's warm/provenance assertions:
    under RAFT_TPU_AOT=load a cold bank's warm-up builds and stores
    every (signature x rung) program (``compiled``), a process that
    finds them warm loads them (``loaded``, nothing built), and the
    provenance then stamps the entry's payload sha and the release the
    pointer resolves to."""
    from raft_tpu_torch.aot import bank, release

    registry, batcher = serve_stack
    entries = [registry.get("spar")]
    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    reps = engine.warm(entries, device="cpu", out_keys=batcher.out_keys,
                       sizes=(1, 2))
    assert [(r["rows"], r["loaded"], r["compiled"]) for r in reps] == [
        (1, 0, 1), (2, 0, 1)]
    monkeypatch.setattr(bank, "_SEEN", set())   # a fresh process's view
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    reps = engine.warm(entries, device="cpu", out_keys=batcher.out_keys,
                       sizes=(1, 2))
    assert [(r["loaded"], r["compiled"]) for r in reps] == [(1, 0), (1, 0)]
    rid = release.cut(promote_after=True)["release"]
    prov = engine.build_provenance(registry, out_keys=batcher.out_keys,
                                   sizes=(1, 2), replica_id="rA",
                                   device="cpu")
    key, side = engine.program_identity(entries[0],
                                        out_keys=batcher.out_keys, rows=1,
                                        device="cpu")
    assert prov["spar"]["bank_key"] == key
    assert prov["spar"]["bank_sha"] == side["payload_sha256"][:16] != "none"
    assert prov["spar"]["release"] == prov["*"]["release"] == rid


def test_escalation_heals_under_require_and_budget_zero(serve_stack,
                                                        tmp_path,
                                                        monkeypatch):
    """Under the serving config (RAFT_TPU_AOT=require, no build left in
    the compile budget) on a bank warmed only for the base program, a
    request's float64 escalation still re-solves its row: the rung's
    flags let it build its own program and store its entry, and a later
    process's escalation loads that entry."""
    from raft_tpu_torch.aot import bank
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.utils import config

    registry, batcher = serve_stack
    entry = registry.get("spar")
    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    monkeypatch.delenv("RAFT_TPU_DTYPE", raising=False)
    monkeypatch.setattr(bank, "_SEEN", set())
    base = engine.dispatch([entry], [4.0], [9.0], [0.1],
                           out_keys=batcher.out_keys, device="cpu", padded=1)
    sidecars = tmp_path / bank.BANK_DIRNAME
    assert len(list(sidecars.glob("*.json"))) == 1

    monkeypatch.setattr(bank, "_SEEN", set())   # a fresh process's view
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    monkeypatch.setenv("RAFT_TPU_COMPILE_BUDGET", str(bank.builds()))
    again = engine.dispatch([entry], [4.0], [9.0], [0.1],
                            out_keys=batcher.out_keys, device="cpu",
                            padded=1)
    for k in base:
        np.testing.assert_array_equal(again[k], base[k])
    c = lambda n: metrics.counter(n).value   # noqa: E731
    compiled0, loaded0 = c("aot_programs_compiled"), c("aot_programs_loaded")
    row, status = engine.escalate_row(entry, 4.0, 9.0, 0.1,
                                      out_keys=batcher.out_keys)
    assert np.isfinite(np.asarray(row["PSD"])).all()
    assert isinstance(status, int)
    assert c("aot_programs_compiled") == compiled0 + 1
    rung = [m for m in map(bank._read_json, sidecars.glob("*.json"))
            if m["environment"]["dtype"] == "float64"]
    assert len(rung) == 1 and rung[0]["raft_flags"]["DTYPE"] == "float64"
    # the rung's flags are put back: the base program still holds the
    # budget and the miss policy of the serving config
    assert config.get("COMPILE_BUDGET") == bank.builds() - 1
    assert config.get("AOT_MISS") == "error"

    monkeypatch.setattr(bank, "_SEEN", set())   # the next process
    engine.escalate_row(entry, 4.0, 9.0, 0.1, out_keys=batcher.out_keys)
    assert c("aot_programs_compiled") == compiled0 + 1
    assert c("aot_programs_loaded") == loaded0 + 1


def test_failed_dispatch_is_a_serve_error_for_every_requester(monkeypatch):
    """A dispatch that raises reaches every requester of its group as
    the exception (HTTP 500), is counted in serve_errors, and nothing
    retries it elsewhere."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.cache import ResultCache

    calls = []

    def broken(*a, **k):
        calls.append(k.get("device"))
        raise RuntimeError("launch failed")

    monkeypatch.setattr(engine, "dispatch", broken)
    entry = _toy_entry()
    b = Batcher(_ToyRegistry(entry), device="cpu", tick_ms=5, max_batch=4,
                cache=ResultCache(10**6, metrics_prefix="test_torch_serve5"))
    e0 = metrics.counter("serve_errors").value
    futs = [b.submit(entry, 4.0 + i, 9.0, 0.0) for i in range(3)]
    b.run_tick()
    for f in futs:
        with pytest.raises(RuntimeError, match="launch failed"):
            f.result(1)
    assert metrics.counter("serve_errors").value == e0 + 1
    assert len(calls) == 1 and str(calls[0]) == "cpu"
    assert b.stats()["inflight_rows"] == 0
