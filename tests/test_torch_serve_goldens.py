"""Served rows of the port against the JAX serving engine's goldens.

``golden_serve_<name>.npz`` (``tests/make_torch_port_fixtures.py
--serve``) holds ``raft_tpu.serve.engine.dispatch`` of the spar, semi
and mhk demos on the CPU (float64) over a fixed set of requests padded
to the rungs 1, 4 and 16.  Here the same requests go through the port's
batcher on the CPU, one tick per rung, into the same padded groups:

* every served row within 1e-10 x each key's max of the golden, with
  ``status`` bit-equal (and every other bucket key of the group too);
* every served row bit-equal to a direct
  :class:`~raft_tpu_torch.structure.bucketing.BucketEvaluator` call on
  the padded group the batcher recorded;
* the first request of every rung is the same case: its row at rungs 1,
  4 and 16 is recorded (its largest difference across rungs, in the
  port and in the goldens) and held within 1e-10 x max — a larger
  difference would be a fault to list in ROADMAP §C.
"""

import os

import numpy as np
import pytest

from raft_tpu_torch.serve import engine
from tests.test_torch_serve import FIX, design_path, hold_direct

TOL = 1e-10
RUNGS = (1, 4, 16)
BUCKET_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "drag_resid",
               "drag_converged", "n_iter_drag", "status")
EXACT = ("status", "n_iter_drag", "drag_converged")


def _hold(got, gold, tag):
    for k in BUCKET_KEYS:
        a, b = np.asarray(got[k]), np.asarray(gold[k])
        assert a.shape == b.shape, (tag, k, a.shape, b.shape)
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")
            continue
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert err <= TOL * scale, \
            f"{tag} {k}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("name", ["spar", "semi", "mhk"])
def test_served_rows_hold_the_jax_goldens(name):
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.cache import ResultCache
    from raft_tpu_torch.serve.engine import Registry
    from raft_tpu_torch.serve.quota import ClientQuotas

    gold = np.load(os.path.join(FIX, f"golden_serve_{name}.npz"))
    registry = Registry()
    registry.register(name, design_path(name))
    # a cache that holds nothing: the shared first case dispatches in
    # every rung's group, as it did for the goldens
    b = Batcher(registry, out_keys=BUCKET_KEYS, device="cpu", tick_ms=5,
                max_batch=16,
                cache=ResultCache(0, metrics_prefix="test_torch_serve_gold"),
                quotas=ClientQuotas(rate=0.0, burst=1.0), queue_bound=64,
                group_log=8)
    shared = {}
    for rung in RUNGS:
        Hs, Tp, beta = (gold[f"r{rung}_{k}"] for k in ("Hs", "Tp", "beta"))
        futs = [b.submit(name, h, t, bb) for h, t, bb in zip(Hs, Tp, beta)]
        assert b.run_tick() == len(Hs)
        group = b.groups[-1]
        assert group["padded"] == rung and len(group["entries"]) == len(Hs)
        np.testing.assert_array_equal(group["Hs"], Hs)
        hold_direct(b, group)
        results = [f.result(5) for f in futs]
        served = {k: np.stack([np.asarray(r["outputs"][k]) for r in results])
                  for k in BUCKET_KEYS}
        for k in BUCKET_KEYS:
            np.testing.assert_array_equal(served[k], group["out"][k])
        assert [r["status"] for r in results] == \
            gold[f"r{rung}_status"].tolist()
        _hold(served, {k: gold[f"r{rung}_{k}"] for k in BUCKET_KEYS},
              f"{name} rung {rung}")
        shared[rung] = {k: served[k][0] for k in BUCKET_KEYS}
    # the shared case across rungs, in the port and in the goldens
    for k in BUCKET_KEYS:
        if k in EXACT:
            for rung in RUNGS[1:]:
                assert np.array_equal(shared[rung][k], shared[1][k])
            continue
        scale = float(np.max(np.abs(shared[1][k]))) or 1.0
        for rung in RUNGS[1:]:
            port = float(np.max(np.abs(shared[rung][k] - shared[1][k])))
            jax = float(np.max(np.abs(gold[f"r{rung}_{k}"][0]
                                      - gold[f"r1_{k}"][0])))
            assert port <= TOL * scale, (name, k, rung, port)
            assert jax <= TOL * scale, (name, k, rung, jax)


def test_engine_dispatch_is_the_batchers_row():
    """engine.dispatch called directly on a golden group holds the
    golden and reports its solve wall and its kernel launches (none on
    the CPU: the plain solve launches no kernel)."""
    from raft_tpu_torch.serve.engine import Registry

    gold = np.load(os.path.join(FIX, "golden_serve_mhk.npz"))
    entry = Registry().register("mhk", design_path("mhk"))
    Hs, Tp, beta = (gold[f"r4_{k}"] for k in ("Hs", "Tp", "beta"))
    timings = {}
    out = engine.dispatch([entry] * len(Hs), Hs, Tp, beta,
                          out_keys=BUCKET_KEYS, device="cpu", padded=4,
                          record_metrics=False, timings=timings)
    assert timings["launches"] == 0 and timings["solve_s"] > 0
    _hold(out, {k: gold[f"r4_{k}"] for k in BUCKET_KEYS}, "mhk direct")
