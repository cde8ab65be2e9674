"""The port's trace report, event registry and obs CLI
(``raft_tpu_torch/obs/{report,events,__main__}.py``) against the JAX
package's.

* ``merge_captures``, ``read_events``, ``collect_spans``,
  ``report_data``, ``render_report``, ``tail_view``, ``render_tail`` and
  ``chrome_trace`` give the JAX package's output exactly on
  ``tests/fixtures/obs/trace-{101,202}.jsonl`` (each alone and merged),
  and on a capture of the port's own checkpointed sweep;
* every event and span name in the port's sources is registered in the
  port's ``obs/events.py``, with the reference's payload fields where
  the reference emits the same event;
* the CLI's ``report``, ``trace --merge --check``, ``events`` and
  ``spans`` verbs and their exit codes.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.obs import events as jevents
from raft_tpu.obs import report as jreport
from raft_tpu_torch.obs import __main__ as cli
from raft_tpu_torch.obs import events, report
from raft_tpu_torch.parallel.sweep import (make_mesh,
                                           run_sweep_checkpointed_full)
from raft_tpu_torch.utils import faults

HERE = os.path.dirname(os.path.abspath(__file__))
OBS_FIX = os.path.join(HERE, "fixtures", "obs")
PORT = os.path.join(os.path.dirname(HERE), "raft_tpu_torch")
CAPTURES = [os.path.join(OBS_FIX, f) for f in ("trace-101.jsonl",
                                               "trace-202.jsonl")]


def _same(a, b):
    """Equal as JSON documents (tuples and lists alike)."""
    return json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


def _all_views(mod, events, bad, source):
    return {
        "spans": mod.collect_spans(events),
        "data": mod.report_data(events, bad, source=source),
        "text": mod.render_report(events, bad, source=source),
        "tail": mod.tail_view(events),
        "tail_text": mod.render_tail(events, source=source),
        "trace": mod.chrome_trace(events),
        "trace_merged": mod.chrome_trace(events, merged=True),
    }


@pytest.mark.parametrize("which", ["101", "202", "merged"])
def test_report_views_equal_the_jax_package_on_fixtures(which):
    if which == "merged":
        got = report.merge_captures([OBS_FIX])
        ref = jreport.merge_captures([OBS_FIX])
        assert _same(got, ref)
        assert got[2]["files"] == 2 and not got[2]["unanchored_files"]
        events, bad = got[0], got[1]
    else:
        path = os.path.join(OBS_FIX, f"trace-{which}.jsonl")
        events, bad = report.read_events(path)
        assert _same((events, bad), jreport.read_events(path))
    port = _all_views(report, events, bad, which)
    ref = _all_views(jreport, events, bad, which)
    for k in port:
        assert _same(port[k], ref[k]), k
    assert "span wall-time tree" in port["text"]


def test_report_views_equal_on_a_port_sweep_capture(tmp_path, monkeypatch):
    """A capture of the port's own checkpointed sweep (spans, retries,
    quarantine, the metrics snapshot) renders the same in both."""
    log = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)

    def toy(Hs, Tp):
        return {"PSD": torch.stack([Hs, Tp], -1), "X0": Hs - Tp}

    rng = np.random.default_rng(5)
    cases = {"Hs": rng.random(12), "Tp": rng.random(12)}
    with faults.inject("transient:shard_eval:1", "nan:shard_result:1"):
        run_sweep_checkpointed_full(
            toy, cases, str(tmp_path / "sweep"), shard_size=4,
            mesh=make_mesh(2, device="cpu"), backoff_s=0.0,
            quarantine_retry=False)
    events, bad = report.read_events(log)
    port = _all_views(report, events, bad, "sweep")
    ref = _all_views(jreport, events, bad, "sweep")
    for k in port:
        assert _same(port[k], ref[k]), k
    data = port["data"]
    rel = data["reliability"]
    assert rel["retries"] == 1 and rel["quarantine_judgements"] == 1
    assert rel["sweeps_done"][0]["n_quarantined"] == 1
    assert [r["path"] for r in data["spans"]["paths"]][:2] == [
        ["sweep"], ["sweep", "shard"]]
    assert data["snapshot"]["counters"]["shards_done"] == 3


# ---------------------------------------------------------------- registry


def _emitted_names(root):
    """(event names, span names) of every ``log_event("...")`` and
    ``span("...")`` call with a literal first argument under ``root``."""
    evs, sps = {}, {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                f_ = node.func
                name = f_.attr if isinstance(f_, ast.Attribute) else \
                    getattr(f_, "id", None)
                where = f"{os.path.relpath(path, root)}:{node.lineno}"
                if name == "log_event":
                    evs.setdefault(node.args[0].value, where)
                elif name == "span":
                    sps.setdefault(node.args[0].value, where)
    return evs, sps


def test_every_emitted_name_is_registered():
    evs, sps = _emitted_names(PORT)
    assert {"fabric_init", "fabric_worker_spawn", "fabric_worker_start",
            "fabric_worker_done", "fabric_worker_exit", "fabric_assemble",
            "fabric_unavailable", "shard_claim", "shard_steal",
            "run_record", "regression_detected", "drag_linearisation",
            "statics_unconverged"} <= set(evs)
    assert {"sweep", "shard", "solve_statics", "solve_dynamics"} <= set(sps)
    unregistered = {n: w for n, w in evs.items()
                    if not events.is_registered(n)}
    assert not unregistered, unregistered
    unregistered = {n: w for n, w in sps.items()
                    if not events.is_registered_span(n)}
    assert not unregistered, unregistered
    # the records the obs core writes itself
    for n in ("proc_start", "span_begin", "span_end", "flight_metrics"):
        assert events.is_registered(n)
    # an event both packages emit promises the same payload fields,
    # except the fabric worker's (no AOT bank: device and start-up
    # time in place of the program counts)
    own = {"fabric_worker_start", "fabric_worker_done", "heartbeat",
           "profile_start", "profile_stop", "profile_failed"}
    for name, fields, _ in events.describe():
        assert jevents.is_registered(name), name
        if name not in own:
            assert fields == jevents.EVENTS[name][0], name
    for name, _ in events.describe_spans():
        assert name == "qtf_slender_sharded" or \
            jevents.is_registered_span(name), name


# --------------------------------------------------------------------- CLI


def test_cli_report_trace_events_spans(tmp_path, capsys):
    assert cli.main(["report", "--merge", OBS_FIX]) == 0
    out = capsys.readouterr().out
    assert out == jreport.render_report(
        *jreport.merge_captures([OBS_FIX])[:2], source=OBS_FIX)
    assert cli.main(["report", CAPTURES[0], "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert _same(data, jreport.report_data(
        *jreport.read_events(CAPTURES[0]), source=CAPTURES[0]))
    # two captures without --merge is a usage error
    with pytest.raises(SystemExit) as ei:
        cli.main(["report"] + CAPTURES)
    assert ei.value.code == 2
    capsys.readouterr()

    trace = str(tmp_path / "t.json")
    assert cli.main(["trace", "--merge", OBS_FIX, "-o", trace,
                     "--check"]) == 0
    with open(trace) as f:
        assert _same(json.load(f), jreport.chrome_trace(
            jreport.merge_captures([OBS_FIX])[0], merged=True))
    # a shard with an unmatched span begin fails the check
    broken = tmp_path / "broken"
    broken.mkdir()
    with open(CAPTURES[1]) as f:
        lines = [ln for ln in f if '"span_end"' not in ln]
    (broken / "trace-202.jsonl").write_text("".join(lines))
    assert cli.main(["trace", "--merge", str(broken), "-o", trace,
                     "--check"]) == 1
    assert "check FAILED" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ei:
        cli.main(["trace", str(tmp_path / "missing.jsonl"), "-o", trace])
    assert ei.value.code == 2

    assert cli.main(["events"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(events.EVENTS)
    assert lines[0].split()[0] == sorted(events.EVENTS)[0]
    assert cli.main(["spans"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(events.SPANS)
