"""The port's serve batch ladder and adaptive tick
(``raft_tpu_torch.serve.engine`` / ``batcher``), ported from
``tests/test_ladders.py``.

Socket-free and evaluator-free: the batcher runs against a faked
``engine.dispatch`` and a hand-built design entry on the CPU, so these
cover the scheduling/ladder logic (window scaling, full-rung early
dispatch, rung pruning, stage-sum accounting) without building a model.
The ladder's rung lists and the pruning decisions are also held equal
to the JAX package's on the same inputs.  The real-dispatch twins live
in ``tests/test_torch_serve.py``.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _obs_helpers import read_events  # noqa: E402

from raft_tpu_torch.serve import engine  # noqa: E402
from raft_tpu_torch.serve.batcher import Batcher  # noqa: E402
from raft_tpu_torch.serve.cache import ResultCache  # noqa: E402
from raft_tpu_torch.serve.quota import ClientQuotas  # noqa: E402


# ------------------------------------------------------------ ladder math

def test_batch_ladder_policies():
    # 'cost' and 'pow2' share the candidate generator (pruning is a
    # separate post-warmup step)
    assert engine.batch_ladder(8, policy="pow2") == (1, 2, 4, 8)
    assert engine.batch_ladder(8, policy="cost") == (1, 2, 4, 8)
    # explicit rung lists are used verbatim
    assert engine.batch_ladder(64, policy="1,4,16,64") == (1, 4, 16, 64)
    for bad in ("4,2", "0,4", "a,b", ""):
        with pytest.raises(ValueError):
            engine.batch_ladder(64, policy=bad)


@pytest.mark.parametrize("max_batch,policy", [
    (8, "pow2"), (8, "cost"), (5, "cost"), (1, "pow2"), (64, "1,4,16,64"),
    (64, "1,4,16")])
def test_batch_ladder_equals_jax(max_batch, policy):
    """The port's ladder on one device is the reference's on a
    one-device mesh."""
    from raft_tpu.parallel.sweep import make_mesh
    from raft_tpu.serve import engine as jengine

    assert engine.batch_ladder(max_batch, policy=policy) == \
        jengine.batch_ladder(make_mesh(1), max_batch, policy=policy)


def test_prune_ladder_drops_flat_rungs():
    sizes = (1, 2, 4, 8)
    # walls flat through 1/2/4 (fixed dispatch-overhead floor), real
    # growth only at 8: the flat rungs buy nothing -> pruned
    walls = {1: 0.010, 2: 0.0101, 4: 0.011, 8: 0.020}
    assert engine.prune_ladder(sizes, walls, tol=1.15) == (4, 8)
    # strictly scaling walls (compute-bound): every rung saves time
    walls = {1: 0.01, 2: 0.02, 4: 0.04, 8: 0.08}
    assert engine.prune_ladder(sizes, walls, tol=1.15) == sizes
    # missing measurements are kept, never pruned on ignorance
    assert engine.prune_ladder(sizes, {}, tol=1.15) == sizes
    # the top rung (the tick's chunk cap) always survives
    assert engine.prune_ladder(sizes, {s: 0.01 for s in sizes},
                               tol=1.15) == (8,)


@pytest.mark.parametrize("seed", range(4))
def test_prune_ladder_equals_jax(seed):
    from raft_tpu.serve import engine as jengine

    rng = np.random.default_rng(seed)
    sizes = (1, 2, 4, 8, 16)
    walls = {s: float(w) for s, w in zip(sizes, np.cumsum(
        rng.uniform(0.0, 0.01, len(sizes))) + 0.01)}
    if seed % 2:
        walls.pop(4)
    for tol in (1.0, 1.15, 1.5):
        assert engine.prune_ladder(sizes, walls, tol=tol) == \
            jengine.prune_ladder(sizes, walls, tol=tol)


def test_refine_ladder_policies(monkeypatch):
    sizes = (1, 2, 4, 8)
    # non-cost policies come back unchanged without measuring anything
    monkeypatch.setenv("RAFT_TPU_SERVE_LADDER", "pow2")
    assert engine.refine_ladder([], sizes) == sizes
    # cost policy prunes per measured walls (stubbed here; the real
    # walls come from the dispatch wall ledger after warm-up)
    monkeypatch.setenv("RAFT_TPU_SERVE_LADDER", "cost")
    monkeypatch.setattr(engine, "ladder_walls",
                        lambda *a, **k: {1: 0.010, 2: 0.0101,
                                         4: 0.011, 8: 0.020})
    assert engine.refine_ladder([], sizes) == (4, 8)
    # no measurements: candidates unchanged
    monkeypatch.setattr(engine, "ladder_walls", lambda *a, **k: {})
    assert engine.refine_ladder([], sizes) == sizes


def test_ladder_walls_read_the_dispatch_ledger(monkeypatch):
    """ladder_walls reads the best wall per (signature x rung) that
    dispatch recorded, the worst of those over the signatures, and
    None where nothing dispatched."""
    a, b = _toy_entry(sig="sig-a"), _toy_entry(sig="sig-b")
    monkeypatch.setattr(engine, "_WALLS", {})
    for e, rung, w in ((a, 1, 0.02), (a, 1, 0.01), (b, 1, 0.015),
                       (a, 2, 0.03)):
        key, side = engine.program_identity(e, out_keys=("PSD",), rows=rung)
        assert side is None
        engine._record_wall(key, w)
    walls = engine.ladder_walls([a, b, a], (1, 2, 4), out_keys=("PSD",))
    assert walls == {1: 0.015, 2: 0.03, 4: None}
    st = engine.program_stats(engine.program_identity(a, ("PSD",), 1)[0])
    assert st == {"dispatches": 2, "wall_s": pytest.approx(0.03),
                  "wall_min_s": 0.01}


# ------------------------------------------------ faked-dispatch batcher

def _toy_entry(sig="toy-sig", fingerprint="toy-fp"):
    e = object.__new__(engine.DesignEntry)
    e.name = "toy"
    e.model = None
    e.sig = sig
    e.packed = {}
    e.fingerprint = fingerprint
    e.axes = {"strips": (4, 8), "nodes": (2, 2), "lines": (0, 0)}
    return e


class _ToyRegistry:
    def __init__(self, entry):
        self._entry = entry

    def get(self, name):
        return self._entry

    def names(self):
        return ["toy"]


def _fake_dispatch(solve_sleep_s=0.0):
    def dispatch(entries, Hs, Tp, beta, out_keys=("PSD", "X0", "status"),
                 device=None, padded=None, record_metrics=True,
                 timings=None):
        if solve_sleep_s:
            time.sleep(solve_sleep_s)
        n = len(entries)
        out = {}
        for k in out_keys:
            if k == "status":
                out[k] = np.zeros(n, dtype=np.int32)
            else:
                out[k] = np.stack([np.full(3, h) for h in Hs])
        if timings is not None:
            timings["solve_s"] = solve_sleep_s
        return out

    return dispatch


def _make_batcher(monkeypatch, tick_ms=200.0, max_batch=4,
                  solve_sleep_s=0.0, mode=None, floor_ms=None):
    if mode is not None:
        monkeypatch.setenv("RAFT_TPU_SERVE_TICK_MODE", mode)
    if floor_ms is not None:
        monkeypatch.setenv("RAFT_TPU_SERVE_TICK_MIN_MS", str(floor_ms))
    monkeypatch.setattr(engine, "dispatch", _fake_dispatch(solve_sleep_s))
    entry = _toy_entry()
    b = Batcher(_ToyRegistry(entry), out_keys=("PSD", "status"),
                device="cpu", tick_ms=tick_ms, max_batch=max_batch,
                cache=ResultCache(10**6, metrics_prefix="test_ladders"),
                quotas=ClientQuotas(rate=0.0, burst=1.0), queue_bound=64)
    return b, entry


def test_adaptive_wake_window(monkeypatch):
    b, entry = _make_batcher(monkeypatch, tick_ms=200.0, floor_ms=2.0)
    t0 = time.perf_counter()
    # idle queue parks on the ceiling
    with b._cond:
        assert b._wake_in(t0) == pytest.approx(0.2, abs=0.05)
    # one pending request + zero load EMA: the window is ~the floor,
    # anchored on the request's submit time
    b.submit(entry, 4.0, 9.0, 0.0)
    with b._cond:
        assert b._wake_in(t0) < 0.01
    # a full top ladder rung dispatches NOW
    for i in range(b.sizes[-1]):
        b.submit(entry, 5.0 + i, 9.0, 0.0)
    with b._cond:
        assert b._wake_in(t0) == 0.0
    b.run_tick()
    # sustained load (EMA ~ top rung) widens the window to the ceiling
    with b._cond:
        b._load_ema = float(b.sizes[-1])
        b._first_pending_t = time.perf_counter()
        b._pending.append(object())  # sentinel: non-empty queue
        w = b._wake_in(time.perf_counter())
        b._pending.pop()
    assert w == pytest.approx(0.2, abs=0.05)


def test_full_rung_trigger_counts_unique_rows(monkeypatch):
    """A same-case burst dedups to ONE dispatched row, so it must NOT
    fire the full-rung early dispatch (that would collapse the
    coalescing window for a 1-row batch)."""
    b, entry = _make_batcher(monkeypatch, tick_ms=200.0, floor_ms=50.0)
    t0 = time.perf_counter()
    for _ in range(b.sizes[-1] + 2):      # duplicates of one corner
        b.submit(entry, 4.0, 9.0, 0.0)
    with b._cond:
        assert b._wake_in(t0) > 0.0       # window intact
    b.submit(entry, 99.0, 9.0, 0.0)       # distinct rows DO count
    for i in range(b.sizes[-1] - 3):      # the dup corner is 1 unique
        b.submit(entry, 50.0 + i, 9.0, 0.0)
    with b._cond:
        assert b._wake_in(t0) > 0.0       # one short of the rung
    b.submit(entry, 98.0, 9.0, 0.0)
    with b._cond:
        assert b._wake_in(t0) == 0.0      # full rung of UNIQUE rows
    b.run_tick()


def test_fixed_mode_keeps_cadence(monkeypatch):
    b, entry = _make_batcher(monkeypatch, tick_ms=100.0, mode="fixed")
    assert b.tick_mode == "fixed"
    t0 = time.perf_counter()
    b.submit(entry, 4.0, 9.0, 0.0)
    with b._cond:
        # pending or not, fixed mode sleeps out the cadence
        assert b._wake_in(t0) == pytest.approx(0.1, abs=0.03)
    b.run_tick()


def test_adaptive_thread_light_load_latency(monkeypatch):
    """A lone request against an idle adaptive batcher resolves in ~the
    tick floor, not the (deliberately huge) tick ceiling — the
    light-load acceptance mechanic."""
    b, entry = _make_batcher(monkeypatch, tick_ms=500.0, floor_ms=2.0)
    b.start()
    try:
        t0 = time.perf_counter()
        fut = b.submit(entry, 4.0, 9.0, 0.0)
        res = fut.result(timeout=10)
        wall = time.perf_counter() - t0
        assert res["status"] == 0
        # floor(2ms) + scheduling slack << the 500ms ceiling
        assert wall < 0.25
    finally:
        b.drain(timeout=10)


def test_full_rung_early_dispatch_thread(monkeypatch):
    """A burst filling the top ladder rung dispatches without waiting
    out the window."""
    b, entry = _make_batcher(monkeypatch, tick_ms=500.0, floor_ms=400.0)
    b.start()
    try:
        t0 = time.perf_counter()
        futs = [b.submit(entry, 4.0 + 0.1 * i, 9.0, 0.0)
                for i in range(b.sizes[-1])]
        for f in futs:
            f.result(timeout=10)
        # the 400ms floor window would apply to a PARTIAL batch; a full
        # rung must go out immediately
        assert time.perf_counter() - t0 < 0.3
    finally:
        b.drain(timeout=10)


def test_stage_sum_invariant_at_p50_and_p95(monkeypatch, tmp_path):
    """Adaptive-tick tail attribution: every resolved request's stage
    decomposition sums to its measured wall — asserted at the p50 and
    p95 latency ranks specifically (the report's stage table is the
    per-request breakdown AT those ranks)."""
    log = str(tmp_path / "ev.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    b, entry = _make_batcher(monkeypatch, tick_ms=50.0,
                             solve_sleep_s=0.002)
    futs = [b.submit(entry, 3.0 + 0.01 * i, 9.0, 0.0) for i in range(12)]
    b.run_tick()
    for f in futs:
        f.result(timeout=10)
    evs = [e for e in read_events(log)
           if e["event"] == "serve_request_stages"]
    assert len(evs) == 12
    stages = ("queue_wait_s", "tick_wait_s", "dispatch_s", "solve_s",
              "post_s")
    by_wall = sorted(evs, key=lambda e: e["wall_s"])
    for rank in (len(evs) // 2, int(len(evs) * 0.95)):
        e = by_wall[min(rank, len(evs) - 1)]
        # stage values are rounded to 1e-6 in the event payload
        assert sum(e[s] for s in stages) == pytest.approx(
            e["wall_s"], abs=5e-5)
    for e in evs:  # and the invariant holds for every request
        assert sum(e[s] for s in stages) == pytest.approx(
            e["wall_s"], abs=5e-5)


def test_set_sizes_swaps_ladder(monkeypatch):
    b, entry = _make_batcher(monkeypatch, max_batch=8)
    assert b.sizes == (1, 2, 4, 8)
    assert b.set_sizes((4, 8)) == (4, 8)
    assert b.stats()["batch_sizes"] == [4, 8]
    with pytest.raises(ValueError):
        b.set_sizes(())


def test_cross_tick_inflight_join(monkeypatch):
    """A duplicate case submitted while its row is MID-SOLVE joins the
    solving tick instead of queueing a redundant dispatch; later
    submits hit the cache."""
    import threading

    from raft_tpu_torch.obs import metrics

    gate = threading.Event()
    dispatched = []

    def blocking_dispatch(entries, Hs, Tp, beta, out_keys=("PSD", "status"),
                          device=None, padded=None, record_metrics=True,
                          timings=None):
        dispatched.append(len(entries))
        gate.wait(timeout=10)
        n = len(entries)
        out = {"PSD": np.stack([np.full(3, h) for h in Hs]),
               "status": np.zeros(n, dtype=np.int32)}
        if timings is not None:
            timings["solve_s"] = 0.0
        return out

    monkeypatch.setattr(engine, "dispatch", _fake_dispatch())
    entry = _toy_entry()
    b = Batcher(_ToyRegistry(entry), out_keys=("PSD", "status"),
                device="cpu", tick_ms=50, max_batch=4,
                cache=ResultCache(10**6, metrics_prefix="test_join"),
                quotas=ClientQuotas(rate=0.0, burst=1.0), queue_bound=64)
    monkeypatch.setattr(engine, "dispatch", blocking_dispatch)
    f1 = b.submit(entry, 4.0, 9.0, 0.0)
    t = threading.Thread(target=b.run_tick, daemon=True, name="tick")
    t.start()
    for _ in range(100):          # wait until the dispatch is in flight
        if dispatched:
            break
        time.sleep(0.01)
    assert dispatched == [1]
    j0 = metrics.counter("serve_inflight_joins").value
    f2 = b.submit(entry, 4.0, 9.0, 0.0)   # duplicate, mid-solve: joins
    assert metrics.counter("serve_inflight_joins").value == j0 + 1
    assert len(b._pending) == 0           # never queued a second row
    gate.set()
    t.join(timeout=10)
    r1, r2 = f1.result(timeout=10), f2.result(timeout=10)
    assert not r1["cache_hit"] and not r2["cache_hit"]
    np.testing.assert_array_equal(r1["outputs"]["PSD"],
                                  r2["outputs"]["PSD"])
    assert dispatched == [1]              # ONE dispatch served both
    # the row is cached now: a third submit resolves without queueing
    f3 = b.submit(entry, 4.0, 9.0, 0.0)
    assert f3.result(timeout=1)["cache_hit"]
    assert b.stats()["inflight_rows"] == 0


# -------------------------------------------------- fused-path plumbing

def test_fused_flag_in_flags_key(monkeypatch):
    """The flags key holds FUSED (the fused and staged responses must
    never share a result-cache key); the reference's memo-key half of
    this test rests on its jit memo, which the port does not have."""
    from raft_tpu_torch.models.dynamics import fused_response_enabled
    from raft_tpu_torch.utils import config

    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    assert fused_response_enabled()
    k_on = config.flags_key()
    monkeypatch.setenv("RAFT_TPU_FUSED", "off")
    assert not fused_response_enabled()
    k_off = config.flags_key()
    assert k_on != k_off and "on" in k_on and "off" in k_off


def test_fused_flag_in_bank_key(monkeypatch):
    """The reference's memo-key half of ``test_fused_flag_in_memo_key``:
    the fused and staged programs never share a program-bank key (the
    port has no jit memo; its bank key holds the flags key)."""
    monkeypatch.delenv("RAFT_TPU_FUSED", raising=False)
    e = _toy_entry()
    k_on, _ = engine.program_identity(e, out_keys=("PSD",), rows=2,
                                      device="cpu")
    monkeypatch.setenv("RAFT_TPU_FUSED", "off")
    k_off, _ = engine.program_identity(e, out_keys=("PSD",), rows=2,
                                       device="cpu")
    assert k_on != k_off


def test_flags_key_is_the_references_less_fixed_point(monkeypatch):
    from raft_tpu.parallel.sweep import _flags_key
    from raft_tpu_torch.utils import config

    for name in config.EVALUATOR_FLAGS + ("FIXED_POINT",):
        monkeypatch.delenv("RAFT_TPU_" + name, raising=False)
    monkeypatch.setenv("RAFT_TPU_ITER_SCALE", "3")
    monkeypatch.setenv("RAFT_TPU_DTYPE", "f32")
    ref = dict(zip(("SOLVER", "FIXED_POINT", "SCAN_CHUNK", "DTYPE",
                    "COND_CHECK", "COND_THRESHOLD", "ITER_SCALE", "FUSED"),
                   _flags_key()))
    ref.pop("FIXED_POINT")
    ref["SOLVER"] = config.get("SOLVER")   # no 'pallas' choice here
    assert config.flags_key() == tuple(ref[k] for k in config.EVALUATOR_FLAGS)


@pytest.mark.parametrize("flag,value", [
    ("FUSED", "off"), ("ITER_SCALE", "4"), ("DTYPE", "float32"),
    ("SOLVER", "lapack"), ("SCAN_CHUNK", "2"), ("COND_CHECK", "1")])
def test_flag_flip_changes_the_result_cache_key(monkeypatch, flag, value):
    """A flag flip — or the escalation rung's DTYPE / ITER_SCALE — must
    change the result-cache key the batcher computes."""
    from raft_tpu_torch.serve.cache import result_cache_key

    def key():
        return result_cache_key("fp", {"Hs": 4.0, "Tp": 9.0, "beta": 0.0},
                                ("PSD", "status"),
                                extra=engine.flags_extra())

    for name in engine.config.EVALUATOR_FLAGS:
        monkeypatch.delenv("RAFT_TPU_" + name, raising=False)
    k0 = key()
    monkeypatch.setenv("RAFT_TPU_" + flag, value)
    assert key() != k0
    monkeypatch.delenv("RAFT_TPU_" + flag)
    assert key() == k0


def test_escalation_rung_changes_the_result_cache_key(monkeypatch):
    from raft_tpu_torch.parallel import resilience

    for name in engine.config.EVALUATOR_FLAGS:
        monkeypatch.delenv("RAFT_TPU_" + name, raising=False)
    base = engine.flags_extra()
    with resilience._rung_flags("f64_cpu"):
        esc = engine.flags_extra()
    assert esc != base
    assert engine.flags_extra() == base
