"""The port's serving process end to end, ported from
``tests/test_serve.py::test_server_end_to_end_sigterm_drain``: a real
``python -m raft_tpu_torch.serve --device cpu`` subprocess, concurrent
clients, every route, then SIGTERM mid-load — every accepted request
is answered, the process exits 0 and flushes its metrics.  The
reference test's JAX setup (``JAX_PLATFORMS``, ``XLA_FLAGS``, the
compile cache) has no counterpart here.

Also the CLI's refusals: the fleet modes and options exit 2 naming
ROADMAP A15(h), and without a card and without ``--device`` the server
exits 2 naming ``--device cpu``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_serve import FIX, design_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait_ready(proc, deadline_s):
    """Read server stdout until the ready line; returns the port."""
    t0 = time.monotonic()
    for line in proc.stdout:
        if "serving" in line and "http://" in line:
            return int(line.split("http://", 1)[1].split()[0]
                       .rsplit(":", 1)[1])
        if time.monotonic() - t0 > deadline_s:
            break
    raise AssertionError("server never printed its ready line")


def test_server_end_to_end_sigterm_drain(tmp_path):
    from raft_tpu_torch.serve.client import ServeClient

    metrics_path = tmp_path / "serve_metrics.prom"
    log_path = tmp_path / "serve_events.jsonl"
    stderr_path = tmp_path / "serve_stderr.txt"
    env = dict(
        os.environ,
        PYTHONPATH=ROOT,
        RAFT_TPU_SERVE_TICK_MS="10",
        # one padded size (burst of 12 -> 2-row dispatches)
        RAFT_TPU_SERVE_MAX_BATCH="2",
        RAFT_TPU_METRICS=str(metrics_path),
        RAFT_TPU_LOG=str(log_path),
        # black-box flight recorder: periodic flush shards land here
        RAFT_TPU_FLIGHT_DIR=str(tmp_path / "flight"),
        RAFT_TPU_FLIGHT_FLUSH_S="0.5",
        # a small torch thread pool: the suite runs beside this process
        OMP_NUM_THREADS="2",
    )
    stderr_f = open(stderr_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.serve",
         "--designs", f"spar={design_path('spar')}",
         "--port", "0", "--no-warm", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=stderr_f,
        text=True)
    try:
        port = _wait_ready(proc, deadline_s=180)
        results, errors = [], []

        def client(i, n_req):
            c = ServeClient("127.0.0.1", port, client_id=f"c{i}",
                            timeout=300)
            try:
                for j in range(n_req):
                    code, body = c.evaluate("spar", 4.0 + (i % 5) * 0.5,
                                            9.0 + j, 0.1 * (i % 3))
                    results.append((i, j, code, body))
            except Exception as e:  # noqa: BLE001 — assert below
                errors.append((i, repr(e)))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i, 2))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert len(results) == 12
        assert all(code == 200 for (_, _, code, _) in results), \
            [(c, b) for (_, _, c, b) in results if c != 200][:3]
        body = results[0][3]
        assert body["ok"] and body["status_text"] == "ok"
        assert "PSD" in body["outputs"] and "X0" in body["outputs"]

        c = ServeClient("127.0.0.1", port)
        # a golden request: the JAX serving engine's row within 1e-10
        gold = np.load(os.path.join(FIX, "golden_serve_spar.npz"))
        code, body = c.evaluate("spar", float(gold["r1_Hs"][0]),
                                float(gold["r1_Tp"][0]),
                                float(gold["r1_beta"][0]))
        assert code == 200 and body["status"] == int(gold["r1_status"][0])
        for k in ("X0", "PSD"):
            ref = gold[f"r1_{k}"][0]
            err = np.max(np.abs(np.asarray(body["outputs"][k]) - ref))
            assert err <= 1e-10 * np.max(np.abs(ref)), k
        # every response names what produced its numbers
        prov = c.last_provenance
        assert prov["replica"] and prov["code"] and prov["flags"]
        assert prov["bank_sha"] == "none"
        # traceparent contract: a traced client's header is adopted
        tp_in = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        code, _ = c.evaluate("spar", 4.25, 9.5, 0.0, traceparent=tp_in)
        assert code == 200
        tp_out = c.last_headers.get("traceparent")
        assert tp_out and tp_out.split("-")[1] == "ab" * 16
        assert tp_out != tp_in          # the span is the server's own
        code, _ = c.evaluate("spar", 4.25, 9.5, 0.0)
        assert code == 200 and c.last_headers.get("traceparent")
        code, health = c.healthz()
        assert code == 200 and health["ok"]
        assert health["serve_requests"] >= 13
        assert "window" in health and "slo" in health
        assert "cost_ledger" in health
        # the port's counterparts of the reference's XLA compile counts:
        # no kernel on the CPU
        assert health["kernel"]["built_here"] is False
        assert health["kernel"]["launches"]["ge_solve"] == 0
        assert health["device"] == "cpu"
        code, prom = c.metrics_text()
        assert code == 200
        assert "raft_tpu_serve_requests" in prom
        assert "raft_tpu_serve_batch_occupancy_bucket" in prom
        assert any("raft_tpu_serve_request_s_bucket" in line
                   and "# {" in line for line in prom.splitlines())
        code, box = c.request("GET", "/debug/flight")
        assert code == 200 and isinstance(box, str)
        first = json.loads(box.splitlines()[0])
        assert first["event"] == "proc_start"
        assert first["flight"]["trigger"] == "debug"
        code, designs = c.request("GET", "/designs")
        assert code == 200 and designs["designs"] == ["spar"]
        code, al = c.request("GET", "/alerts")
        assert code == 200 and al["enabled"] is False
        # unknown design -> 404, bad body -> 400, missing scalar -> 400
        assert c.evaluate("nope", 5, 10, 0)[0] == 404
        assert c.request("POST", "/evaluate", {"Hs": "x"})[0] == 400
        assert c.request("POST", "/evaluate",
                         {"design": "spar", "Hs": 5, "Tp": 9})[0] == 400
        assert c.request("GET", "/evaluate")[0] == 405
        c.close()

        # ---- SIGTERM drain: fire a burst, signal mid-flight; every
        # accepted request must still get its full response
        drain_results, drain_errors = [], []

        def drain_client(i):
            dc = ServeClient("127.0.0.1", port, client_id=f"d{i}",
                             timeout=300)
            try:
                code, body = dc.evaluate("spar", 2.0 + 0.1 * i, 8.0, 0.0)
                drain_results.append((i, code, body))
            except (ConnectionError, OSError):
                # raced the socket close before ACCEPTANCE — a refused
                # connection is a clean reject, not a dropped response
                drain_results.append((i, "refused", None))
            except Exception as e:  # noqa: BLE001
                drain_errors.append((i, repr(e)))
            finally:
                dc.close()

        hc = ServeClient("127.0.0.1", port)
        n0 = hc.healthz()[1]["serve_requests"]
        threads = [threading.Thread(target=drain_client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        # signal once the whole burst is admitted (each dispatch takes
        # a good fraction of a second here, so the signal lands while
        # the burst is being solved)
        t_wait = time.monotonic()
        while hc.healthz()[1]["serve_requests"] < n0 + 4 and \
                time.monotonic() - t_wait < 60:
            time.sleep(0.005)
        hc.close()
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=120)
        stderr_f.flush()
        assert rc == 0, stderr_path.read_text()[-2000:]
        assert not drain_errors, drain_errors
        accepted = [r for r in drain_results if r[1] == 200]
        assert len(accepted) == 4, drain_results
        for _, _, body in accepted:
            assert body["ok"] and "PSD" in body["outputs"]
        assert all(r[1] in (200, 503, "refused") for r in drain_results)
        # metrics flushed on shutdown
        prom_text = metrics_path.read_text()
        assert "raft_tpu_serve_requests" in prom_text
        events = [json.loads(line)
                  for line in log_path.read_text().splitlines()]
        names = {e["event"] for e in events}
        assert {"serve_start", "serve_tick", "serve_request",
                "serve_drain", "serve_stop"} <= names
        drain = next(e for e in events if e["event"] == "serve_drain")
        assert drain["completed"] is True
        # the flight recorder left its stable flush shard behind
        from raft_tpu_torch.obs import flight

        shard = tmp_path / "flight" / f"flight-{proc.pid}.jsonl"
        assert shard.exists(), "no flight flush shard after shutdown"
        hdr, _recs = flight.read_shard(str(shard))
        assert hdr["flight"]["version"] == flight.SCHEMA_VERSION
        # report --tail on the capture: the slowest request joins its
        # exemplar identity AND its span tree
        from raft_tpu_torch.obs.report import tail_view

        view = tail_view(events, rank=1.0)
        assert view is not None and view["n_requests"] >= 12
        assert view["trace_id"] and view["span_id"]
        assert view["exemplar"] is not None
        assert view["exemplar"]["span_id"] == view["span_id"]
        assert view["exemplar"]["design"] and view["exemplar"]["replica"]
        assert any(s["name"] == "serve_request" for s in view["spans"])
        assert view["stages"]["solve"] > 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        stderr_f.close()


@pytest.mark.parametrize("argv", [
    ["fleet", "--replicas", "2"], ["router"], ["rollout", "--to", "r1"],
    ["--designs", "spar=x.json", "--fleet-dir", "d"],
    ["--designs", "spar=x.json", "--replica-id", "r0"],
    ["--designs", "spar=x.json", "--takeover"]])
def test_fleet_modes_exit_2_naming_the_roadmap_item(argv, capsys):
    from raft_tpu_torch.serve.__main__ import main

    assert main(argv) == 2
    assert "A15(h)" in capsys.readouterr().err


def test_server_without_a_card_or_device_exits_2(capsys):
    import torch

    from raft_tpu_torch.serve.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    assert main(["--designs", f"spar={design_path('spar')}"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_free_port_helper_unused():
    """Guard: the end-to-end test relies on --port 0 ephemeral binding;
    keep a socket sanity check so a change of the ready-line protocol
    fails here with a readable message."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    assert s.getsockname()[1] > 0
    s.close()
