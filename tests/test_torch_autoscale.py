"""The port's autoscaler (``raft_tpu_torch/serve/autoscale.py``) against
the reference's ``tests/test_autoscale.py``, test for test under the
same names (fast, socket-free): the control loop against a faked
backend and clock — for-duration hysteresis both ways, the shared
cooldown, min/max bounds, hot-beats-cold, and the occupancy
estimator's two-sample rule.

Beyond the reference: ``scaling_rules`` and ``Autoscaler.step`` held
against the JAX package's on the same fake backend, clock and seeded
signal sequence."""

import numpy as np
import pytest

from _torch_env_guard import raft_env_unchanged


@pytest.fixture(autouse=True)
def _raft_env_guard():
    """Fail a test that leaves a RAFT_TPU_* variable behind."""
    with raft_env_unchanged():
        yield


class FakeBackend:
    """Scriptable stand-in for autoscale.FleetBackend: tests set
    ``press``/``occ``/``n`` directly and read the action log."""

    def __init__(self, n=2):
        self.n = n
        self.press = 0.0
        self.occ = 0.5
        self.actions = []
        self._next = 0

    def n_replicas(self):
        return self.n

    def pressure(self):
        return self.press

    def occupancy(self):
        return self.occ

    def scale_out(self):
        self.n += 1
        self._next += 1
        rid = f"as-{self._next}"
        self.actions.append(("out", rid))
        return rid

    def scale_in(self):
        self.n -= 1
        rid = f"r{self.n}"
        self.actions.append(("in", rid))
        return rid


def _mk(monkeypatch, n=2, out_for=3.0, in_for=15.0, cooldown=30.0,
        minimum=1, maximum=4, low_occ=0.1):
    from raft_tpu_torch.serve.autoscale import Autoscaler

    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_OUT_FOR_S", str(out_for))
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_IN_FOR_S", str(in_for))
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_LOW_OCC", str(low_occ))
    clock = [0.0]
    backend = FakeBackend(n=n)
    scaler = Autoscaler(backend=backend, clock=lambda: clock[0],
                        interval_s=1.0, minimum=minimum, maximum=maximum,
                        cooldown_s=cooldown)
    return scaler, backend, clock


def _tick(scaler, clock, t):
    clock[0] = t
    return scaler.step(now=t)


def test_scale_out_needs_sustained_pressure(monkeypatch):
    scaler, backend, clock = _mk(monkeypatch, out_for=3.0)
    backend.press = 1.0
    # pressure below the for-duration: pending, no action
    assert _tick(scaler, clock, 0.0) is None
    assert _tick(scaler, clock, 2.0) is None
    # a blip that clears re-arms the for-duration from scratch
    backend.press = 0.0
    assert _tick(scaler, clock, 2.5) is None
    backend.press = 1.0
    assert _tick(scaler, clock, 3.0) is None
    assert _tick(scaler, clock, 5.0) is None  # only 2s sustained again
    act = _tick(scaler, clock, 6.5)
    assert act is not None and act[0] == "out"
    assert backend.n == 3


def test_cooldown_gates_both_directions(monkeypatch):
    scaler, backend, clock = _mk(monkeypatch, out_for=1.0, in_for=1.0,
                                 cooldown=30.0)
    backend.press = 1.0
    assert _tick(scaler, clock, 0.0) is None
    assert _tick(scaler, clock, 1.5) == ("out", "as-1")
    # still hot, but cooling: no second spawn (the join transient must
    # not read as the next signal)
    assert _tick(scaler, clock, 2.5) is None
    assert _tick(scaler, clock, 20.0) is None
    # pressure resolved + occupancy collapsed: scale-in ALSO waits out
    # the same cooldown, then its own for-duration
    backend.press, backend.occ = 0.0, 0.0
    assert _tick(scaler, clock, 25.0) is None   # cooling
    act = None
    for t in (32.0, 33.5):
        act = _tick(scaler, clock, t) or act
    assert act == ("in", "r2")
    assert [a[0] for a in backend.actions] == ["out", "in"]


def test_bounds_are_hard(monkeypatch):
    scaler, backend, clock = _mk(monkeypatch, out_for=1.0, in_for=1.0,
                                 cooldown=0.0, minimum=2, maximum=3)
    backend.press = 1.0
    assert _tick(scaler, clock, 0.0) is None
    assert _tick(scaler, clock, 1.5) == ("out", "as-1")
    # at the ceiling: sustained pressure scales nothing
    for t in (3.0, 4.5, 6.0):
        assert _tick(scaler, clock, t) is None
    assert backend.n == 3
    backend.press, backend.occ = 0.0, 0.0
    _tick(scaler, clock, 7.0)
    act = _tick(scaler, clock, 8.5)
    assert act is not None and act[0] == "in" and backend.n == 2
    # at the floor: sustained cold scales nothing
    for t in (10.0, 11.5, 13.0):
        assert _tick(scaler, clock, t) is None
    assert backend.n == 2


def test_hot_beats_cold_no_flap(monkeypatch):
    """Contradictory signals (pressure firing while occupancy reads
    low — exactly the scale-out warm-up window) must never shrink."""
    scaler, backend, clock = _mk(monkeypatch, out_for=1.0, in_for=1.0,
                                 cooldown=0.0, maximum=3)
    backend.press, backend.occ = 1.0, 0.0
    assert _tick(scaler, clock, 0.0) is None
    act = _tick(scaler, clock, 1.5)
    assert act is not None and act[0] == "out"
    # both rules stay active; at the ceiling the answer is "hold", not
    # "in" — hot gates cold
    for t in (3.0, 4.5, 6.0, 7.5):
        a = _tick(scaler, clock, t)
        assert a is None or a[0] == "out"
    assert [a[0] for a in backend.actions].count("in") == 0


def test_one_action_per_tick(monkeypatch):
    scaler, backend, clock = _mk(monkeypatch, out_for=1.0, in_for=1.0,
                                 cooldown=0.0, maximum=8)
    backend.press = 1.0
    _tick(scaler, clock, 0.0)
    assert _tick(scaler, clock, 1.5) == ("out", "as-1")
    # even with cooldown 0 a single tick only ever takes one action
    assert len(backend.actions) == 1


def test_scaling_rules_read_flags(monkeypatch):
    from raft_tpu_torch.serve.autoscale import scaling_rules

    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_OUT_FOR_S", "7")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_IN_FOR_S", "21")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_LOW_OCC", "0.25")
    hot, cold = scaling_rules()
    assert hot.name == "autoscale-hot" and hot.for_s == 7.0
    assert cold.name == "autoscale-cold" and cold.for_s == 21.0
    assert cold.threshold == 0.25
    # in deliberately slower than out (shrink is the careful direction)
    assert cold.for_s > hot.for_s


def test_occupancy_two_sample_rule(tmp_path, monkeypatch):
    """The real backend's occupancy: 0.0 until two lease samples, then
    the busy_s delta rate, clamped to [0, 1], dead rids pruned."""
    import json
    import os

    import time

    from raft_tpu_torch.serve.autoscale import FleetBackend
    from raft_tpu_torch.serve.fleet import _replicas_dir

    clock = [100.0]
    backend = FleetBackend(str(tmp_path), clock=lambda: clock[0])
    rep_dir = _replicas_dir(str(tmp_path))

    def lease(rid, busy_s):
        # renewed far in the (real) future so the lease stays live no
        # matter how long this test takes
        rec = {"replica": rid, "pid": 1, "host": "h", "addr": "127.0.0.1",
               "port": 1, "claimed_t": 1.0,
               "renewed_t": time.time() + 3600.0,
               "ttl_s": 10.0, "designs": {}, "buckets": [],
               "out_keys": [], "healthz": {"busy_s": busy_s},
               "token": rid}
        with open(os.path.join(rep_dir, f"{rid}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(rec, f)

    os.makedirs(rep_dir, exist_ok=True)
    lease("r0", 0.0)
    lease("r1", 0.0)
    assert backend.occupancy() == 0.0  # first sample: no rate yet
    clock[0] = 110.0
    lease("r0", 5.0)   # 5 busy seconds over 10s wall = 0.5
    lease("r1", 20.0)  # faster than wall: clamps to 1.0
    assert backend.occupancy() == pytest.approx(0.75)
    # a vanished replica is pruned, not a crash or a stale rate
    os.remove(os.path.join(rep_dir, "r1.json"))
    clock[0] = 120.0
    lease("r0", 5.0)   # idle decade
    assert backend.occupancy() == pytest.approx(0.0)
    assert "r1" not in backend._busy


# ------------------------------------------------- equal to the reference


def test_scaling_rules_equal_the_references(monkeypatch):
    from raft_tpu.serve.autoscale import scaling_rules as jrules
    from raft_tpu_torch.serve.autoscale import scaling_rules as trules

    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_OUT_FOR_S", "4.5")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_IN_FOR_S", "12")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_LOW_OCC", "0.2")
    for t, j in zip(trules(), jrules()):
        assert (t.name, t.metric, t.predicate, t.threshold, t.for_s,
                t.clear_s, t.severity) == \
            (j.name, j.metric, j.predicate, j.threshold, j.for_s,
             j.clear_s, j.severity)


@pytest.mark.parametrize("seed", range(3))
def test_autoscaler_steps_equal_the_references(seed, monkeypatch):
    """Seeded pressure / occupancy sequences on twin fake backends: the
    port's and the reference's Autoscaler take the same action (or
    none) at every tick and end with the same fleet size."""
    from raft_tpu.serve.autoscale import Autoscaler as JA
    from raft_tpu_torch.serve.autoscale import Autoscaler as TA

    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_OUT_FOR_S", "2")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_IN_FOR_S", "5")
    monkeypatch.setenv("RAFT_TPU_AUTOSCALE_LOW_OCC", "0.1")
    rng = np.random.default_rng(seed)
    clock = [0.0]
    bt, bj = FakeBackend(n=2), FakeBackend(n=2)
    kw = dict(clock=lambda: clock[0], interval_s=1.0, minimum=1,
              maximum=4, cooldown_s=float(rng.choice([0.0, 3.0, 10.0])))
    t, j = TA(backend=bt, **kw), JA(backend=bj, **kw)
    press, occ = 0.0, 0.5
    for _ in range(300):
        clock[0] += float(rng.choice([0.5, 1.0, 1.5]))
        if rng.random() < 0.1:
            press = float(rng.random() < 0.5)
        if rng.random() < 0.1:
            occ = float(rng.choice([0.0, 0.05, 0.5, 0.9]))
        bt.press = bj.press = press
        bt.occ = bj.occ = occ
        assert t.step(now=clock[0]) == j.step(now=clock[0])
    assert bt.actions == bj.actions and bt.n == bj.n
