"""The port's device-list sweeps and checkpointed drivers
(``raft_tpu_torch/parallel/sweep.py``) against the JAX package's.

Fast tier, on CPU meshes of one and two entries, against the goldens
of ``tests/make_torch_port_fixtures.py --sweeps`` (the JAX drivers on
a 2-device CPU mesh, shards of 3 rows):

* ``run_sweep_checkpointed_full`` and ``sweep_cases_full`` of the
  spar's and semi_wind's full evaluator, ragged and divisible, within
  1e-10 x each key's max magnitude of ``golden_sweep_full_*.npz``, with
  ``status`` and ``n_iter_drag`` bit-equal, and bit-equal to the plain
  evaluator call;
* ``run_sweep_checkpointed`` and ``sweep_cases`` of the spar's case
  evaluator against ``golden_sweep_cases_spar.npz``, the same way;
* ``sweep_heterogeneous`` of the three demos interleaved against
  ``golden_sweep_hetero.npz``, its ``bucket_sweep`` event
  (``padding_waste_frac``, ``waste_by_axis``), ``axis_counts``,
  signature fingerprints and ``tuned_rungs`` equal to JAX's;
* the escalated sweep (``RAFT_TPU_ESCALATE=retol``) of the spar with
  its drag budget cut: its ``quarantine.json`` entries equal JAX's
  (case parameters, status before and after, rungs, resolution), the
  result deltas within 1e-10 x max;
* ``qtf_slender_sharded`` on one and three entries within 1e-10 x max
  of ``fowt_qtf_slender`` and of ``golden_qtf_slender.npz``;
* the evaluator twin (built by the same factory for another device or
  dtype policy) gives the bits of a fresh evaluator; the mesh layouts
  (a plain function's sp group runs on its first entry) and refusals
  (no CUDA, an unstamped evaluator bound elsewhere).
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.parallel import resilience
from raft_tpu_torch.parallel import sweep as tsweep
from raft_tpu_torch.structure import bucketing

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
TOL = 1e-10
EXACT = ("status", "n_iter_drag")
OUT_KEYS = ("PSD", "X0", "status", "n_iter_drag")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
N_WAVES = {"spar": 2, "semi_wind": 1}
DEMOS = ("spar", "semi", "mhk")

_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def design(name):
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        return json.load(f)


def golden(name):
    return _cached(("g", name), lambda: dict(
        np.load(os.path.join(FIX, f"golden_sweep_{name}.npz"))))


def full_ev(name):
    return _cached(("ev", name), lambda: tapi.make_full_evaluator(
        Model(design(name)), nWaves=N_WAVES[name], device="cpu"))


def host(out, keys=OUT_KEYS):
    return {k: out[k].cpu().numpy() for k in keys}


def plain_full(name):
    g = golden(f"full_{name}")
    return _cached(("plain", name), lambda: host(full_ev(name)(
        **{k: torch.as_tensor(g[k]) for k in ROW_KEYS})))


def mesh(k):
    return tsweep.make_mesh(k, device="cpu")


def hold(out, ref, keys=OUT_KEYS):
    for k in keys:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            scale = max(float(np.max(np.abs(b))), 1e-300)
            assert float(np.max(np.abs(a - b))) <= TOL * scale, k


def bits(out, ref, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


# ------------------------------------------------------------ full sweeps

@pytest.mark.parametrize("name, k, shard", [("spar", 1, 8), ("spar", 2, 3),
                                            ("semi_wind", 2, 8)])
def test_checkpointed_full_sweep_matches_jax(name, k, shard, tmp_path):
    """On one entry in one shard, and on two entries in shards of 3
    (each padded to the device count, the last one ragged) or of 8
    (divisible): the JAX golden within 1e-10 x max, the plain call's
    bits."""
    g = golden(f"full_{name}")
    rows = {key: g[key] for key in ROW_KEYS}
    out = tsweep.run_sweep_checkpointed_full(
        full_ev(name), rows, str(tmp_path / "sweep"), shard_size=shard,
        mesh=mesh(k), out_keys=OUT_KEYS)
    hold(out, g)
    bits(out, plain_full(name))
    with open(tmp_path / "sweep" / "manifest.json") as f:
        fp = json.load(f)["fingerprint"]
    assert fp["mesh_shape"] == [k] and fp["n_cases"] == len(g["Hs"])


def test_sweep_cases_full_on_two_entries_is_the_plain_call(monkeypatch):
    """A ragged batch (7 rows) on two entries: the plain call's bits;
    ``shard_freq`` changes no value on a mesh without an ``sp`` axis."""
    g = golden("full_spar")
    rows = {key: g[key][:7] for key in ROW_KEYS}
    out = tsweep.sweep_cases_full(full_ev("spar"), rows, mesh=mesh(2),
                                  out_keys=OUT_KEYS, shard_freq=True)
    bits(out, {k: v[:7] for k, v in plain_full("spar").items()})


# ------------------------------------------------------------ case sweeps

def test_case_sweeps_match_jax(tmp_path):
    g = golden("cases_spar")
    ev = _cached(("case", "spar"), lambda: tapi.make_case_evaluator(
        Model(design("spar")), device="cpu"))
    plain = host(ev(*(torch.as_tensor(g[k]) for k in ("Hs", "Tp", "beta"))))
    hold(plain, g)
    out = tsweep.run_sweep_checkpointed(
        ev, g["Hs"], g["Tp"], g["beta"], str(tmp_path / "sweep"),
        shard_size=4, mesh=mesh(2), out_keys=OUT_KEYS)
    bits(out, plain)
    out = tsweep.sweep_cases(ev, g["Hs"][:5], g["Tp"][:5], g["beta"][:5],
                             mesh=mesh(1), out_keys=OUT_KEYS)
    bits(out, {k: v[:5] for k, v in plain.items()})


# --------------------------------------------------- heterogeneous sweeps

def _demo_models():
    return _cached("demos", lambda: {n: Model(design(n)) for n in DEMOS})


@pytest.mark.parametrize("k", [1, 2])
def test_heterogeneous_sweep_matches_jax(k, tmp_path, monkeypatch):
    """Rows of the three demos interleaved, in chunks of 3 rows (4 on
    two entries): the JAX outputs, and the JAX ``bucket_sweep`` event's
    waste fields."""
    g = golden("hetero")
    with open(os.path.join(FIX, "golden_sweep_events.json")) as f:
        ev_ref = json.load(f)
    models = _demo_models()
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("RAFT_TPU_LOG", str(log))
    monkeypatch.setenv("RAFT_TPU_BUCKET_ROWS", "3")
    out = tsweep.sweep_heterogeneous(
        [models[str(n)] for n in g["design"]], g["Hs"], g["Tp"], g["beta"],
        mesh=mesh(k), out_keys=OUT_KEYS)
    hold(out, g)
    with open(log) as f:
        evs = [json.loads(line) for line in f]
    (bs,) = [e for e in evs if e["event"] == "bucket_sweep"]
    assert {key: bs[key] for key in ev_ref["bucket_sweep"]} \
        == ev_ref["bucket_sweep"]
    dispatch = [e for e in evs if e["event"] == "span_begin"
                and e["name"] == "sweep_dispatch"]
    assert sum(e["rows"] for e in dispatch) == len(g["Hs"])
    assert {e["bucket"] for e in dispatch} == {
        bucketing.signature_fingerprint(bucketing.bucket_signature(m))
        for m in models.values()}
    if k == 1:
        sigs = {n: bucketing.bucket_signature(m) for n, m in models.items()}
        axes = {n: bucketing.axis_counts(m, sigs[n])
                for n, m in models.items()}
        assert {n: {a: list(v) for a, v in c.items()}
                for n, c in axes.items()} == ev_ref["axis_counts"]
        assert {n: bucketing.signature_fingerprint(s)
                for n, s in sigs.items()} == ev_ref["signature_fingerprint"]
        assert {a: list(bucketing.tuned_rungs([axes[n][a][0] for n in DEMOS]))
                for a in ("strips", "nodes", "lines")} \
            == ev_ref["tuned_rungs"]


# ------------------------------------------------------------- quarantine

def test_escalated_quarantine_matches_jax(tmp_path, monkeypatch):
    """The spar with nIter 2 under ``RAFT_TPU_ESCALATE=retol`` at
    ESCALATE_ITER_SCALE 2: the rows that need 4-5 drag trips are
    re-solved healthy, the two that need 6 stay flagged; every entry
    equals JAX's, and each rung's record names its device and the bits
    it cleared and left."""
    g = golden("quarantine_spar")
    with open(os.path.join(FIX, "golden_sweep_quarantine_spar.json")) as f:
        ref = json.load(f)["entries"]
    d = design("spar")
    d["settings"] = dict(d["settings"], nIter=2)
    ev = tapi.make_full_evaluator(Model(d), nWaves=2, device="cpu")
    monkeypatch.setenv("RAFT_TPU_ESCALATE", "retol")
    monkeypatch.setenv("RAFT_TPU_ESCALATE_ITER_SCALE", "2")
    out_dir = str(tmp_path / "sweep")
    out = tsweep.run_sweep_checkpointed_full(
        ev, {k: g[k] for k in ROW_KEYS}, out_dir, shard_size=3,
        mesh=mesh(1), out_keys=OUT_KEYS)
    hold(out, g)
    got = resilience.load_quarantine(out_dir)
    assert len(got) == len(ref) == 7
    fields = ("shard", "index", "keys_nonfinite", "status", "reason",
              "status_after", "reason_after", "resolved")
    for a, b in zip(got, ref):
        assert {f: a[f] for f in fields} == {f: b[f] for f in fields}
        assert a["case"].keys() == b["case"].keys()
        for key in a["case"]:
            np.testing.assert_array_equal(a["case"][key], b["case"][key])
        ea, eb = a["escalation"], b["escalation"]
        for f in ("mode", "rungs_tried", "resolved_by"):
            assert ea[f] == eb[f]
        (rung,) = ea["rungs"]
        assert rung["device"] == "cpu" and rung["rung"] == "retol"
        assert rung["cleared"] == a["status"] & ~a["status_after"]
        assert rung["persistent"] == a["status"] & a["status_after"]
        if eb["result_delta"] is None:
            assert ea["result_delta"] is None
            continue
        for key, db in eb["result_delta"].items():
            da = ea["result_delta"][key]
            scale = float(np.max(np.abs(g[key])))
            assert (da is None) == (db is None), key
            if db is not None:
                assert abs(da - db) <= TOL * scale, key
    assert sorted(e["index"] for e in got if not e["resolved"]) == [3, 7]


# --------------------------------------------------------- sharded QTF

@pytest.mark.parametrize("k", [1, 3])
def test_qtf_slender_sharded_matches_unsharded_and_jax(k):
    from raft_tpu_torch.physics.qtf_slender import fowt_qtf_slender

    m = _cached("slender", lambda: Model(os.path.join(
        FIX, "design_semi_wind_slender.json")))
    qg = _cached("qtf_golden", lambda: dict(np.load(os.path.join(
        FIX, "golden_qtf_slender.npz"))))
    beta = float(qg["beta"])
    ref = _cached("qtf_plain", lambda: fowt_qtf_slender(
        m, beta, Xi0=qg["Xi0"], device="cpu").numpy())
    got = tsweep.qtf_slender_sharded(m, beta, Xi0=qg["Xi0"], mesh=mesh(k),
                                     pair_chunk=256)
    scale = float(np.max(np.abs(ref)))
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) <= TOL * scale
    assert float(np.max(np.abs(got - qg["rao_qtf"]))) <= TOL * scale


# ------------------------------------------------------- twins and meshes

def test_twin_evaluator_gives_a_fresh_evaluators_bits(monkeypatch):
    """An evaluator asked for on another device or dtype policy runs as
    a twin from its factory stamp: the bits of a fresh evaluator made
    for that policy; an unstamped evaluator bound elsewhere is refused."""
    g = golden("full_spar")
    rows = {k: torch.as_tensor(g[k][:2]) for k in ROW_KEYS}
    m = Model(design("spar"))
    monkeypatch.setenv("RAFT_TPU_DTYPE", "float32")
    ev32 = tapi.make_full_evaluator(m, nWaves=2, device="cpu")
    assert ev32.rdt == torch.float32
    assert tsweep.bind_evaluator(ev32, "cpu") is ev32
    monkeypatch.setenv("RAFT_TPU_DTYPE", "float64")
    twin = tsweep.bind_evaluator(ev32, torch.device("cpu"))
    assert twin is not ev32 and twin.rdt == torch.float64
    assert tsweep.bind_evaluator(ev32, "cpu") is twin  # kept
    fresh = tapi.make_full_evaluator(m, nWaves=2, device="cpu")
    bits(host(twin(**rows)), host(fresh(**rows)))

    class Elsewhere:
        device = torch.device("cuda", 0)

        def __call__(self, **rows):
            raise AssertionError("never called")

    with pytest.raises(ValueError, match="factory stamp"):
        tsweep.sweep_cases_full(Elsewhere(), {"Hs": np.ones(2)},
                                mesh=mesh(1))


def test_mesh_layouts_and_refusals(monkeypatch):
    m = mesh(4)
    assert m.shape == {"dp": 4} and m.devices.size == 4
    assert [str(d) for d in tsweep._grid(m.devices, m)[:, 0]] == ["cpu"] * 4
    m2 = tsweep.make_mesh(4, axis_names=("dp", "sp"), device="cpu")
    assert m2.shape == {"dp": 2, "sp": 2}
    # a plain function has no frequency grid: each sp group runs its dp
    # block on its first entry, shard_freq or not
    for shard_freq in (False, True):
        out = tsweep.sweep_cases_full(lambda Hs: {"X0": Hs * 3},
                                      {"Hs": np.arange(4.0)}, mesh=m2,
                                      out_keys=("X0",),
                                      shard_freq=shard_freq)
        np.testing.assert_array_equal(out["X0"], 3 * np.arange(4.0))
        assert [(e["dp"], e["sp"], e["rows"], e["freq"])
                for e in tsweep.last_entries()] == [
                    (0, 0, (0, 2), None), (1, 0, (2, 4), None)]
    m3 = tsweep.make_mesh(3, axis_names=("dp", "sp"), device="cpu")
    assert m3.shape == {"dp": 3, "sp": 1}
    out = tsweep.sweep_cases_full(lambda Hs: {"X0": Hs * 2},
                                  {"Hs": np.arange(5.0)}, mesh=m3,
                                  out_keys=("X0",))
    np.testing.assert_array_equal(out["X0"], 2 * np.arange(5.0))
    with pytest.raises(ValueError, match="empty batch"):
        tsweep.sweep_cases_full(lambda Hs: {"X0": Hs}, {"Hs": np.ones(0)},
                                mesh=m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsweep.make_mesh()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsweep.qtf_slender_sharded(_cached("slender", lambda: Model(
            os.path.join(FIX, "design_semi_wind_slender.json"))), 0.0)
