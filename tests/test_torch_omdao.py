"""The port's design-optimisation surface (``raft_tpu_torch/omdao.py``,
``serve/cache.py``, ``aot/bank.py``) against the JAX package's.

Goldens: ``golden_omdao_<set>.npz``, the JAX ``DesignEvaluation`` and
``RAFT_OMDAO_Core`` on the CPU with x64, written by
``tests/make_torch_port_fixtures.py --omdao`` (the fast tier traces no
JAX).  The port runs the same designs on the CPU.

Gates:

* ``DesignEvaluation``: the route (farm, full, flexible or host) equal
  to the reference's; the output keys and their Python types (float or
  numpy array) equal; each value within 1e-10 x its key's scale.  A
  ``stats_<channel>_<stat>_case<i>_fowt<j>`` key's scale is the largest
  magnitude over its channel family and statistic kind in the same case
  and FOWT, as ``tests/test_torch_orchestrated.py`` ``key_scale`` holds
  the case metrics; ``Max_Offset`` and ``Max_PtfmPitch`` take their
  family's scale over every case; every other key its own max.  The
  natural periods are held each to its own value.  The flexible design
  at the kappa eps gates of ROADMAP §C: the X0-derived means and the
  periods at kappa(K) eps, the Xi-derived std and max at kappa(Z) eps.
  ``diag`` (the result cache's counters) equal after every call;
* ``RAFT_OMDAO_Core``: ``build_design`` exactly equal to the
  reference's (keys, Python types, array dtypes, shapes and values),
  ``case_mask`` equal; ``compute``'s outputs as ``DesignEvaluation``'s,
  a ``stats_*`` array per case (its first axis);
* ``content_fingerprint`` and ``result_cache_key`` hex-equal to the
  reference's, ``ResultCache`` with the same counters and entries as
  the reference's after every step of one sequence.

The module imports no JAX at its top: ``chip_smoke.py`` imports it by
path for its gates on a machine without JAX.  Slow tier: one golden
rebuilt by the live JAX package.
"""

import json
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from test_torch_orchestrated import (FAMILIES, FLEX_GATE,  # noqa: E402
                                     FLEX_X0_GATE, KIND, TOL, close)

#: DesignEvaluation golden sets: set -> (design file, use_traced, the
#: override call's overrides or None)
SETS = {
    "spar": ("design_spar.json", True, {"mooring.lines.0.length": 920.0}),
    "semi_wind": ("design_semi_wind.json", True, None),
    "semi_wind_moor1": ("design_semi_wind_moor1.json", True, None),
    "semi_wind_wamit": ("design_semi_wind_wamit.json", True, None),
    "semi_wind_cases": ("design_semi_wind_cases.json", True, None),
    "semi_wind_flex": ("design_semi_wind_flex.json", True, None),
    "farm_semi_wind_cases": ("design_farm_semi_wind_cases.json", True,
                             None),
    "spar_host": ("design_spar.json", False, None),
}
#: the WEIS aggregates: key -> (channel, statistic) whose family scale
#: holds it
AGGREGATES = {"Max_Offset": ("surge", "max"),
              "Max_PtfmPitch": ("pitch", "max"),
              "heave_avg": ("heave", "avg"),
              "Std_PtfmPitch": ("pitch", "std"),
              "max_nac_accel": ("AxRNA", "max"),
              "max_tower_base": ("Mbase", "max")}
STAT_KEY = re.compile(
    r"stats_(\w+?)_(avg|std|max|min|PSD)_case(\d+)_fowt(\d+)$")


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_omdao_{name}.npz")))


def golden_outputs(g, tag):
    """(values, types) of one call's outputs in a golden."""
    types = json.loads(str(g[f"types__{tag}"]))
    return {k: g[f"{tag}__{k}"] for k in types}, types


def _family(ch):
    return next((f for f in FAMILIES if ch in f), (ch,))


def stat_scale(gv, key):
    """The scale of a per-case ``stats_*`` key: the largest magnitude
    over its channel family and statistic kind in its case and FOWT."""
    ch, s, c, f = STAT_KEY.match(key).groups()
    fam, kind = _family(ch), KIND.get(s, s)
    scale = 0.0
    for k, v in gv.items():
        m = STAT_KEY.match(k)
        if (m and m.group(3) == c and m.group(4) == f
                and m.group(1) in fam
                and KIND.get(m.group(2), m.group(2)) == kind):
            scale = max(scale, float(np.max(np.abs(v))))
    return scale


def aggregate_scale(gv, key):
    """The scale of a WEIS aggregate: its family's over every case."""
    ch, s = AGGREGATES[key]
    fam, kind = _family(ch), KIND.get(s, s)
    scale = abs(float(gv[key]))
    for k, v in gv.items():
        m = STAT_KEY.match(k) or re.match(r"stats_(\w+?)_(avg|std|max)$", k)
        if (m and m.group(1) in fam
                and KIND.get(m.group(2), m.group(2)) == kind):
            scale = max(scale, float(np.max(np.abs(v))))
    return scale


def hold_periods(got, want, tol):
    """Natural periods, each within ``tol`` of its own value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    assert rel <= tol, f"rigid_body_periods: {rel:.3e} > {tol}"
    return rel


def hold_types(got, types, what):
    assert sorted(got) == sorted(types), (
        what, sorted(set(got) ^ set(types)))
    for k, v in got.items():
        want = types[k]
        ok = (isinstance(v, float) if want == "float"
              else type(v).__name__ == want)
        assert ok, f"{what} {k}: {type(v).__name__}, expected {want}"


def hold_compute(got, g, tag, flex=False):
    """A DesignEvaluation.compute() result against a golden call: keys,
    types and values at the module's gates; returns the worst error over
    its gate's scale."""
    gv, types = golden_outputs(g, tag)
    hold_types(got, types, tag)
    worst = 0.0
    for k, v in got.items():
        m = STAT_KEY.match(k)
        if k == "rigid_body_periods":
            worst = max(worst, hold_periods(v, gv[k], FLEX_X0_GATE
                                            if flex else TOL))
            continue
        tol = TOL
        if m:
            scale = stat_scale(gv, k)
            if flex:
                tol = FLEX_X0_GATE if m.group(2) == "avg" else FLEX_GATE
        elif k in AGGREGATES:
            scale = aggregate_scale(gv, k)
            if flex:
                tol = FLEX_GATE
        else:
            scale = None
        worst = max(worst, close(v, gv[k], tol, scale, f"{tag} {k}"))
    return worst


def hold_diag(diag, g, tag):
    want = json.loads(str(g[f"diag__{tag}"]))
    assert diag == want, (tag, diag, want)


def weis_set(name):
    with open(os.path.join(FIX, f"{name}.json")) as f:
        return json.load(f)


def weis_core(s, device="cpu"):
    from raft_tpu_torch.omdao import RAFT_OMDAO_Core

    return RAFT_OMDAO_Core(s["modeling_options"], s["analysis_options"],
                           s["turbine_options"], s["mooring_options"],
                           s["member_options"], device=device)


def hold_weis_design(design, case_mask, g):
    """build_design's output exactly equal to the golden's (through the
    fixture writer's type-keeping JSON), and the case mask."""
    from make_torch_port_fixtures import design_to_json

    assert json.dumps(design_to_json(design)) == str(g["design"])
    assert list(case_mask) == g["case_mask"].tolist()


def weis_stat_scale(gv, key, i):
    """The scale of case ``i`` of a RAFT_OMDAO_Core ``stats_*`` array:
    the largest magnitude over its family and kind in that case."""
    m = re.match(r"stats_(\w+?)_(avg|std|max|PSD)$", key)
    fam, kind = _family(m.group(1)), KIND.get(m.group(2), m.group(2))
    scale = 0.0
    for k, v in gv.items():
        m2 = re.match(r"stats_(\w+?)_(avg|std|max|PSD)$", k)
        if m2 and m2.group(1) in fam and KIND.get(m2.group(2),
                                                  m2.group(2)) == kind:
            scale = max(scale, float(np.max(np.abs(np.asarray(v)[i]))))
    return scale


def hold_weis_compute(got, g):
    """RAFT_OMDAO_Core.compute's outputs against the golden's: keys and
    types, a ``stats_*`` array case by case at its family scale, the
    aggregates at theirs, the periods each at its own value, the rest
    within 1e-10 x its max."""
    gv, types = golden_outputs(g, "out")
    hold_types(got, types, "weis")
    worst = 0.0
    for k, v in got.items():
        if k == "rigid_body_periods" or k.endswith("_period"):
            worst = max(worst, hold_periods(v, gv[k], TOL))
        elif k.startswith("stats_"):
            v, w = np.asarray(v), np.asarray(gv[k])
            assert v.shape == w.shape, (k, v.shape, w.shape)
            for i in range(w.shape[0]):
                worst = max(worst, close(v[i], w[i], TOL,
                                         weis_stat_scale(gv, k, i),
                                         f"weis {k}[{i}]"))
        elif k in AGGREGATES:
            worst = max(worst, close(v, gv[k], TOL, aggregate_scale(gv, k),
                                     f"weis {k}"))
        else:
            worst = max(worst, close(v, gv[k], TOL, what=f"weis {k}"))
    return worst


def evaluation(name, device="cpu"):
    """The port's DesignEvaluation of a set, built from its design file."""
    from raft_tpu_torch.omdao import DesignEvaluation

    fn, traced, _ = SETS[name]
    return DesignEvaluation(os.path.join(FIX, fn), use_traced=traced,
                            device=device)


def run_set(name, ev, hold=True):
    """The golden calls of a set on ``ev``: compute(), a repeat and, for
    the spar, the override; each held, with the route, the diag
    counters and the evaluator calls (none on a repeat).  Returns
    {tag: (output, wall s, evaluator calls)}."""
    import time

    g = golden(name)
    _, _, override = SETS[name]
    calls = [("first", None), ("repeat", None)]
    if override:
        calls.append(("override", override))
    flex = name.endswith("flex")
    res = {}
    for tag, ov in calls:
        n0 = ev.n_evaluations
        t0 = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = ev.compute(ov)
        res[tag] = (out, time.time() - t0, ev.n_evaluations - n0)
        if hold:
            hold_compute(out, g, tag, flex=flex)
            hold_diag(ev.diag, g, tag)
        if tag == "first":
            assert ev.route == str(g["route"]), (ev.route, str(g["route"]))
        if tag != "first":
            assert ev.n_evaluations == n0, f"{tag}: the evaluator ran"
    return res


# --------------------------------------------------------------- goldens

@pytest.mark.parametrize("name", list(SETS))
def test_design_evaluation_matches_golden(name):
    """Every set: the reference's route, the outputs of the first call,
    the repeat call (no evaluator call) and the override at the gates,
    the result cache's counters equal after each."""
    run_set(name, evaluation(name))


def test_fingerprints_and_cache_keys_match_golden():
    """content_fingerprint of every set's design and result_cache_key of
    each of its cases' traced rows equal the reference's, and
    case_to_traced gives the reference's rows."""
    from raft_tpu_torch.aot.bank import content_fingerprint
    from raft_tpu_torch.api import case_to_traced
    from raft_tpu_torch.omdao import DesignEvaluation
    from raft_tpu_torch.serve.cache import result_cache_key
    from raft_tpu_torch.structure.schema import load_design, parse_cases

    for name, (fn, _, _) in SETS.items():
        g = golden(name)
        design = load_design(os.path.join(FIX, fn))
        fp = content_fingerprint(design)
        assert fp == str(g["design_fp"]), name
        for i, case in enumerate(parse_cases(design)):
            row = case_to_traced(case, nWaves=np.size(
                case.get("wave_heading", 0.0)))
            for k, v in row.items():
                np.testing.assert_array_equal(v, g[f"row{i}__{k}"])
            assert result_cache_key(fp, row, DesignEvaluation._CACHE_KEYS) \
                == str(g[f"cache_key{i}"]), (name, i)


def test_routing_catches_nothing(monkeypatch):
    """A failure inside the chosen evaluator propagates out of compute()
    and no other route is tried; a failing factory too."""
    from raft_tpu_torch import api

    class Boom(RuntimeError):
        pass

    def evaluator(*a, **k):
        raise Boom("kernel launch failed")

    monkeypatch.setattr(api, "make_full_evaluator", lambda m, **k: evaluator)
    ev = evaluation("spar")
    with pytest.raises(Boom):
        ev.compute()
    assert ev.route == "full"

    def factory(m, **k):
        raise Boom("kernel build failed")

    monkeypatch.setattr(api, "make_full_evaluator", factory)
    with pytest.raises(Boom):
        evaluation("spar").compute()


def test_weis_branches_build_matches_golden():
    """build_design on the build-only set (rect members, rings on a rect
    member, rigid bodies, potential-model override 3, a downwind
    two-bladed rotor) exactly equal to the reference's."""
    s = weis_set("weis_branches")
    core = weis_core(s)
    design = core.build_design(s["inputs"], s["discrete_inputs"])
    hold_weis_design(design, core.case_mask, golden("weis_branches"))


def test_weis_semi_wind_matches_golden():
    """build_design exactly, then compute (the unloaded statics,
    analyze_cases over the two kept cases, calc_outputs) at the
    gates."""
    s = weis_set("weis_semi_wind")
    g = golden("weis_semi_wind")
    core = weis_core(s)
    hold_weis_design(core.build_design(s["inputs"], s["discrete_inputs"]),
                     core.case_mask, g)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = core.compute(s["inputs"], s["discrete_inputs"])
    hold_weis_compute(out, g)


# ------------------------------------------- fingerprint and cache parity

def _plain_objects():
    """Plain-data objects of every kind the fingerprint walks."""
    rng = np.random.default_rng(3)
    obj = np.empty(3, dtype=object)
    obj[:] = ["a", 1.5, None]
    return [
        {"b": [1, 2.5, "x"], "a": None, "c": (1, (2.0, ("z", None)))},
        [rng.normal(size=(3, 4)), np.arange(5, dtype=np.int32), obj],
        {"nested": {"arr": rng.normal(size=7).astype(np.float32),
                    "flag": True, 3: np.float64(2.5), "c": 1 + 2j}},
        (0.1, -0.0, float("inf"), 7, b"bytes"),
        np.asarray(3.25),
    ]


def test_content_fingerprint_matches_jax():
    """The same digest as the reference's on plain dicts, lists, numpy
    arrays (an object array too), floats, None and nested tuples; a
    torch tensor hashes as its numpy array."""
    from raft_tpu.aot.bank import content_fingerprint as jfp
    from raft_tpu_torch.aot.bank import content_fingerprint as tfp

    for o in _plain_objects():
        assert tfp(o) == jfp(o), o
    a = np.random.default_rng(4).normal(size=(2, 5))
    assert tfp({"x": torch.as_tensor(a)}) == jfp({"x": a})


def test_result_cache_key_matches_jax():
    """result_cache_key equal to the reference's over scalar, array and
    object case values, out_keys and extras."""
    from raft_tpu.serve.cache import result_cache_key as jkey
    from raft_tpu_torch.serve.cache import result_cache_key as tkey

    cases = [dict(Hs=6.0, Tp=11.0, beta=0.0),
             dict(Hs=np.asarray([2.0]), Tp=np.asarray([8.0, 9.0]),
                  label="IB_NTM", n=np.int64(3)),
             dict(wind_speed=10.59, gamma=np.zeros((1,)),
                  beta_deg=np.asarray([[0.0, 30.0]]), obj=[1, "a"])]
    for case in cases:
        for keys, extra in ((("X0", "Xi"), ()), (("PSD",), ("x64", 1))):
            assert tkey("abc123", case, keys, extra) == \
                jkey("abc123", case, keys, extra)


def test_result_cache_matches_jax():
    """ResultCache's LRU order, byte budget, evictions, oversize refusal
    and stats() equal to the reference's over one sequence of puts and
    gets."""
    from raft_tpu.serve.cache import ResultCache as JCache
    from raft_tpu_torch.serve.cache import ResultCache as TCache

    rng = np.random.default_rng(5)
    rows = {f"k{i}": {"X0": rng.normal(size=6),
                      "Xi": rng.normal(size=(2, 6, 10 + i))}
            for i in range(6)}
    budget = 4200
    caches = [JCache(budget, metrics_prefix="omdao_cache_test"),
              TCache(budget, metrics_prefix="omdao_cache_test")]
    ops = [("put", "k0"), ("put", "k1"), ("get", "k0"), ("put", "k2"),
           ("get", "k1"), ("put", "k3"), ("get", "k9"), ("put", "k0"),
           ("get", "k2"), ("put", "k4"), ("put", "k5"), ("get", "k4")]
    big = {"Xi": np.zeros((budget // 8 + 1,))}
    for op, key in ops + [("big", "kb")]:
        res = []
        for c in caches:
            if op == "put":
                res.append(c.put(key, rows[key]))
            elif op == "big":
                res.append(c.put(key, big))
            else:
                got = c.get(key)
                res.append(None if got is None else sorted(got))
        assert res[0] == res[1], (op, key, res)
        assert caches[0].stats() == caches[1].stats(), (op, key)
        assert list(caches[0]._entries) == list(caches[1]._entries)
        assert len(caches[0]) == len(caches[1])
        assert caches[0].bytes == caches[1].bytes
    got = caches[1].get("k5")
    np.testing.assert_array_equal(got["Xi"], rows["k5"]["Xi"])


def test_openmdao_component_absent():
    """openmdao is not installed: both packages export None."""
    import raft_tpu.omdao as jomdao
    import raft_tpu_torch.omdao as tomdao

    assert jomdao.RAFT_TPU_Component is None
    assert tomdao.RAFT_TPU_Component is None


# ----------------------------------------------------------- slow tier

@pytest.mark.slow
def test_omdao_golden_regenerates():
    """One DesignEvaluation golden (spar) and one WEIS golden rebuilt by
    the live JAX package equal the checked-in files."""
    import make_torch_port_fixtures as mk

    for new, old in ((mk.build_omdao_golden("spar"), golden("spar")),
                     (mk.build_weis_golden("weis_branches"),
                      golden("weis_branches"))):
        assert sorted(new) == sorted(old)
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
