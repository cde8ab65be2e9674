"""The port's program bank (``raft_tpu_torch/aot``) against the
reference's ``tests/test_aot.py``, case for case, on the CPU.

* mechanics, in-process: a load-mode store, then a require-mode load
  from a fresh process's view (the set of checked keys emptied) gives
  the same outputs bit for bit; misses are CLEAN (a flag flip, a code
  fingerprint change, a corrupted payload): a stale or damaged entry is
  rebuilt or refused, never run; an unstamped evaluator is never banked;
  ``off`` reads and writes nothing;
* the maintenance CLI (``list`` / ``verify`` / ``gc``) catches orphans,
  corruption and tmp leftovers and reclaims dead entries;
* the per-process compile budget (``RAFT_TPU_COMPILE_BUDGET``) raises
  or warns before the build that exceeds it;
* three child processes in all, at a few rows of the spar demo: ``python
  -m raft_tpu_torch.aot warmup`` stores the case and serve programs; a
  fresh process under ``require`` + ``COMPILE_BUDGET=0`` loads both,
  builds nothing and answers bit-equal to this process's unbanked
  calls; a fresh process with another code fingerprint misses, rebuilds
  and stores beside them (it first checks a release manifest before
  anything imports torch);
* beyond the reference: bank-loaded serve dispatches bit-equal to
  unbanked ones and within 1e-10 x max of the JAX serving engine's
  ``golden_serve_spar.npz``; the JAX package's bank and the port's in one
  root, neither listing, loading or deleting the other's files; one
  payload file per sha under concurrent stores; the warm-up's kinds and
  ``drivers.warmup``; a fabric worker's warm-up before its first claim.

Reference tests whose mechanism is XLA's, and what stands for them here:

* ``test_roundtrip_bit_identical_vs_fresh_trace`` asserts each sidecar's
  XLA ``cost_analysis`` block and the cost ledger's flops: the port has
  no compiled program to analyse, its ledger is the kernel ledger, so
  the sidecar's payload, first-run wall and launches are asserted;
* ``test_compile_budget_enforced_and_warn`` counts XLA backend
  compiles through the recompile sentinel, with the XLA disk cache off:
  here the budget counts program builds (bank misses and ``nvcc`` runs),
  charged before the build;
* the subprocess tests pin ``RAFT_TPU_CACHE_DIR`` (the XLA disk cache)
  and count XLA compile events in the child: the port has no disk
  cache, and the child reports its builds, ``nvcc`` runs and the file
  its kernel library came from instead;
* ``test_spar_warmup_then_fresh_process_is_compile_free`` asserts a
  cold start under 20 s against the ~25 s trace + compile it replaces:
  the port's CPU path compiles nothing, so no wall clock is asserted;
  its meaning — a fresh process on a warm bank builds nothing — is
  (on the card, with the library, in ``tests/test_torch_cuda.py``).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from raft_tpu_torch.aot import bank
from raft_tpu_torch.aot.__main__ import main as aot_cli
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.parallel.sweep import make_mesh, sweep_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_aot_child.py")
FIX = os.path.join(REPO, "tests", "fixtures", "torch_port")
SPAR = os.path.join(FIX, "design_spar.json")
GOOD = os.path.join(REPO, "tests", "fixtures", "releases", "good.json")


def tiny_evaluator(stamp=("tiny", 1)):
    """Deterministic stamped function (a fresh object per call)."""

    def evaluate(h, t, b):
        w = torch.linspace(0.1, 2.0, 16, dtype=torch.float64)
        psd = (h / t)[:, None] ** 2 / (
            (w - 2 * np.pi / t[:, None]) ** 2 + 0.01)
        return {"PSD": psd, "X0": torch.stack([h * torch.cos(b),
                                               h * torch.sin(b)], 1)}

    if stamp is not None:
        evaluate._raft_program_key = stamp
    return evaluate


def run_sweep(evaluate, seed=3):
    rng = np.random.default_rng(seed)
    return sweep_cases(evaluate, rng.uniform(2, 8, 8), rng.uniform(6, 14, 8),
                       rng.uniform(-0.5, 0.5, 8),
                       mesh=make_mesh(2, device="cpu"))


def counters():
    return metrics.snapshot()["counters"]


def delta(c0, name):
    return counters().get(name, 0) - c0.get(name, 0)


@pytest.fixture
def bank_dir(tmp_path, monkeypatch):
    d = tmp_path / "aot_bank"
    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(d))
    monkeypatch.setattr(bank, "_SEEN", set())
    return d


def fresh_process_view(monkeypatch):
    """What a new process knows: no key checked yet."""
    monkeypatch.setattr(bank, "_SEEN", set())


def bank_files(d, suffix=".json"):
    v = d / bank.BANK_DIRNAME
    return sorted(p for p in v.iterdir() if p.name.endswith(suffix)) \
        if v.is_dir() else []


def payload_files(d):
    v = d / bank.BANK_DIRNAME / bank.PAYLOAD_DIRNAME
    return sorted(v.iterdir()) if v.is_dir() else []


# ------------------------------------------------------------- mechanics


def test_roundtrip_bit_identical_vs_fresh_trace(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    c0 = counters()
    b0 = bank.builds()
    out_fresh = run_sweep(tiny_evaluator())   # builds, stores
    assert delta(c0, "aot_programs_compiled") == 1
    assert bank.builds() == b0 + 1
    assert len(bank_files(bank_dir)) == 1

    fresh_process_view(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    c1 = counters()
    out_loaded = run_sweep(tiny_evaluator())  # new function, same stamp
    assert delta(c1, "aot_programs_loaded") == 1
    assert delta(c1, "aot_programs_compiled") == 0
    assert bank.builds() == b0 + 1
    for k in out_fresh:
        np.testing.assert_array_equal(out_fresh[k], out_loaded[k])
    # the sidecar records the payload (the plain-version marker on the
    # CPU), the first run's wall and launches, the flags, the inputs
    with open(bank_files(bank_dir)[0]) as f:
        meta = json.load(f)
    assert meta["payload"].endswith(".plain") and meta["payload_bytes"] > 0
    assert meta["compile_s"] >= 0 and meta["launches"] == 0
    assert meta["inputs"] == [["(8,)", "float64"]] * 3
    assert meta["environment"]["platform"] == "cpu"
    assert meta["version"] == bank.version_fingerprint()
    assert set(meta["raft_flags"]) == set(bank.config.EVALUATOR_FLAGS)


def test_banked_program_and_compile_or_load(bank_dir, monkeypatch):
    """The reference's two direct faces of the bank: compile_or_load
    runs a program through it once (built, then loaded from a fresh
    process's view), BankedProgram wraps a callable the same way, and
    under off both are the plain call."""
    fn = tiny_evaluator()
    h, t, b = (torch.tensor([4.0, 5.0], dtype=torch.float64),
               torch.tensor([9.0, 10.0], dtype=torch.float64),
               torch.tensor([0.1, 0.2], dtype=torch.float64))
    plain = fn(h, t, b)
    prog = bank.BankedProgram("cases", ("direct", 1), fn)
    assert torch.equal(prog(h, t, b)["PSD"], plain["PSD"])
    assert bank_files(bank_dir) == []              # off: nothing stored
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    out, loaded, dt = bank.compile_or_load(fn, (h, t, b), "cases",
                                           ("direct", 1))
    assert not loaded and dt >= 0 and torch.equal(out["X0"], plain["X0"])
    fresh_process_view(monkeypatch)
    out, loaded, _ = bank.compile_or_load(fn, (h, t, b), "cases",
                                          ("direct", 1))
    assert loaded and torch.equal(out["X0"], plain["X0"])
    fresh_process_view(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    c0 = counters()
    assert torch.equal(prog(h, t, b)["PSD"], plain["PSD"])
    assert delta(c0, "aot_programs_loaded") == 1
    assert len(bank_files(bank_dir)) == 1


def test_flag_flip_is_a_miss(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    monkeypatch.setenv("RAFT_TPU_SOLVER", "lapack")
    with pytest.raises(bank.BankMissError, match="warmup"):
        run_sweep(tiny_evaluator())


def test_require_miss_can_fall_back_flag_controlled(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    monkeypatch.setenv("RAFT_TPU_AOT_MISS", "compile")
    c0 = counters()
    out = run_sweep(tiny_evaluator())
    assert np.isfinite(out["PSD"]).all()
    assert delta(c0, "aot_bank_misses") == 1
    assert delta(c0, "aot_programs_compiled") == 1


def test_stale_code_fingerprint_misses_cleanly(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())
    assert len(bank_files(bank_dir)) == 1
    monkeypatch.setattr(bank, "code_fingerprint", lambda: "deadbeef" * 2)
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    with pytest.raises(bank.BankMissError):
        run_sweep(tiny_evaluator())
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())              # clean rebuild, new entry
    assert len(bank_files(bank_dir)) == 2
    # the old entry is stale for this toolchain: gc reclaims it, and the
    # shared payload stays for the live one
    s = bank.gc_bank()
    assert (s["removed"], s["kept"]) == (1, 1)
    assert len(payload_files(bank_dir)) == 1


def test_corrupt_payload_is_miss_not_crash(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())
    [payload] = payload_files(bank_dir)
    payload.write_bytes(payload.read_bytes()[:16])   # truncate

    fresh_process_view(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    c0 = counters()
    with pytest.raises(bank.BankMissError):
        run_sweep(tiny_evaluator())
    assert delta(c0, "aot_bank_errors") == 1

    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    out = run_sweep(tiny_evaluator())        # rebuilds, heals the payload
    assert np.isfinite(out["PSD"]).all()
    fresh_process_view(monkeypatch)
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    monkeypatch.setenv("RAFT_TPU_COMPILE_BUDGET", str(bank.builds()))
    c1 = counters()
    run_sweep(tiny_evaluator())
    assert delta(c1, "aot_programs_loaded") == 1


def test_unstamped_closure_is_never_banked(bank_dir, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    out = run_sweep(tiny_evaluator(stamp=None))
    assert np.isfinite(out["PSD"]).all()
    assert bank_files(bank_dir) == []        # nothing stored


def test_off_mode_touches_nothing(bank_dir, monkeypatch):
    """Under off no bank file is read or written, and the outputs are
    those of an armed bank's run (and of the bank's absence)."""
    monkeypatch.delenv("RAFT_TPU_AOT", raising=False)
    calls = []
    for name in ("lookup", "store", "read_meta", "peek"):
        real = getattr(bank, name)
        monkeypatch.setattr(bank, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    from raft_tpu_torch.serve import engine

    entry = engine.Registry().register("spar", SPAR)
    off = run_sweep(tiny_evaluator())
    served = engine.dispatch([entry], [4.0], [9.0], [0.1], device="cpu",
                             padded=1)
    key, side = engine.program_identity(entry, rows=1, device="cpu")
    assert side is None and calls == []
    assert not (bank_dir / bank.BANK_DIRNAME).exists()
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    armed = run_sweep(tiny_evaluator())
    for k in off:
        np.testing.assert_array_equal(off[k], armed[k])
    served_armed = engine.dispatch([entry], [4.0], [9.0], [0.1],
                                   device="cpu", padded=1)
    for k in served:
        np.testing.assert_array_equal(served[k], served_armed[k])
    assert len(bank_files(bank_dir)) == 2


# ------------------------------------------------------------------ CLI


def test_cli_list_verify_gc(bank_dir, monkeypatch, capsys):
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())
    [meta_path] = bank_files(bank_dir)
    key = meta_path.name[:-5]

    assert aot_cli(["verify"]) == 0
    assert aot_cli(["list"]) == 0
    assert key in capsys.readouterr().out

    stray = meta_path.parent / (meta_path.name + ".tmp")
    stray.write_bytes(b"interrupted write")
    assert aot_cli(["verify"]) == 0          # note, not a CI failure
    assert "interrupted" in capsys.readouterr().out

    orphan = payload_files(bank_dir)[0].parent / ("ff" * 12 + ".so")
    orphan.write_bytes(b"not a library")
    assert aot_cli(["verify"]) == 1
    assert "orphan" in capsys.readouterr().err

    meta_path.write_text("{not json")
    assert aot_cli(["verify"]) == 1

    assert aot_cli(["gc"]) == 0     # corrupt + orphans + .tmp reclaimed
    assert not stray.exists() and not orphan.exists()
    assert aot_cli(["verify"]) == 0
    run_sweep(tiny_evaluator(stamp=("tiny", 2)))
    assert aot_cli(["gc", "--all"]) == 0
    assert bank_files(bank_dir) == [] and payload_files(bank_dir) == []


def test_content_fingerprint_deterministic_and_content_blind_fallback():
    a = np.array([{"Hs": 6.0}, [1, 2]], dtype=object)
    b = np.array([{"Hs": 6.0}, [1, 2]], dtype=object)
    assert bank.content_fingerprint(a) == bank.content_fingerprint(b)
    c = np.array([{"Hs": 7.0}, [1, 2]], dtype=object)
    assert bank.content_fingerprint(a) != bank.content_fingerprint(c)

    class Opaque:
        pass

    assert bank.content_fingerprint(Opaque()) == \
        bank.content_fingerprint(Opaque())


def test_warmup_rejects_unknown_kind(capsys):
    from raft_tpu_torch.aot import warmup

    with pytest.raises(ValueError, match="unknown warmup kind"):
        warmup.warmup_model(kinds=("case",), device="cpu")   # singular
    assert aot_cli(["warmup", "--kinds", "case", "--device", "cpu"]) == 2
    assert "unknown warmup kind" in capsys.readouterr().err


# -------------------------------------------------------- compile budget


def test_compile_budget_enforced_and_warn(bank_dir, monkeypatch):
    """The budget counts program builds (bank misses that build and nvcc
    runs) and is charged before the build: past it, the miss raises and
    nothing runs or is stored; under ``warn`` it logs and counts."""
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    monkeypatch.setenv("RAFT_TPU_COMPILE_BUDGET", str(bank.builds()))
    ran = []

    def evaluate(h, t, b):
        ran.append(1)
        return {"PSD": h[:, None] * t[:, None], "X0": b[:, None]}

    evaluate._raft_program_key = ("budget", 1)
    with pytest.raises(bank.CompileBudgetError,
                       match="RAFT_TPU_COMPILE_BUDGET"):
        run_sweep(evaluate)
    assert ran == [] and bank_files(bank_dir) == []
    with pytest.raises(bank.CompileBudgetError):
        bank.charge_build("nvcc")

    monkeypatch.setenv("RAFT_TPU_COMPILE_BUDGET_ACTION", "warn")
    c0 = counters()
    run_sweep(evaluate)                       # logs, does not raise
    assert ran == [1, 1] and len(bank_files(bank_dir)) == 1
    assert delta(c0, "compile_budget_exceeded") == 1


# ------------------------------------------------------ fresh processes


def _child_env(bank_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith("RAFT_TPU_") or k.startswith("AOT_CHILD"))}
    env.update(RAFT_TPU_AOT_DIR=str(bank_path), RAFT_TPU_SERVE_LADDER="2",
               PYTHONPATH=REPO)
    env.update(extra)
    return env


def _run_child(env):
    p = subprocess.run([sys.executable, CHILD], env=env, timeout=600,
                       capture_output=True, text=True, cwd=REPO)
    assert p.returncode == 0, f"child failed:\n{p.stderr[-2000:]}"
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The three child processes: the warm-up CLI into a fresh bank, a
    require + budget-0 reader of it, a reader with another code
    fingerprint."""
    tmp = tmp_path_factory.mktemp("aot_children")
    bank_path = tmp / "bank"
    warm = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.aot", "warmup", "--design",
         SPAR, "--kinds", "cases,serve", "--n", "4", "--device", "cpu"],
        env=_child_env(bank_path), timeout=600, capture_output=True,
        text=True, cwd=REPO)
    assert warm.returncode == 0, f"warmup failed:\n{warm.stderr[-2000:]}"
    req = _run_child(_child_env(
        bank_path, RAFT_TPU_AOT="require", RAFT_TPU_COMPILE_BUDGET="0",
        AOT_CHILD_OUT=str(tmp / "require.npz")))
    stale = _run_child(_child_env(
        bank_path, RAFT_TPU_AOT="load", AOT_CHILD_FAKE_CODE="0123456789abcdef",
        AOT_CHILD_MANIFEST=GOOD, AOT_CHILD_OUT=str(tmp / "stale.npz")))
    return dict(tmp=tmp, bank=bank_path, warm=warm.stdout, require=req,
                stale=stale)


def _unbanked(n=4, rung=2):
    """This process's calls on the children's inputs, bank off."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.serve import engine

    model = Model(SPAR, base_dir=FIX)
    rng = np.random.default_rng(0)
    Hs, Tp, beta = (rng.uniform(2.0, 8.0, n), rng.uniform(6.0, 14.0, n),
                    rng.uniform(-0.5, 0.5, n))
    out = sweep_cases(api.make_case_evaluator(model, device="cpu"), Hs, Tp,
                      beta, mesh=make_mesh(device="cpu"),
                      out_keys=("PSD", "X0", "status"))
    served = engine.dispatch([engine.DesignEntry("spar", model)] * rung,
                             Hs[:rung], Tp[:rung], beta[:rung], device="cpu",
                             padded=rung)
    return {**{f"cases_{k}": v for k, v in out.items()},
            **{f"serve_{k}": v for k, v in served.items()}}


def test_subprocess_export_then_fresh_runtime_loads(children, monkeypatch):
    """Store in one process, load in a fresh one under require and
    COMPILE_BUDGET=0: both programs loaded, nothing built, and the
    outputs bit-equal to this process's unbanked calls."""
    monkeypatch.delenv("RAFT_TPU_AOT", raising=False)
    r = children["require"]
    assert r["rung"] == 2
    assert (r["loaded"], r["compiled"], r["misses"], r["errors"]) == \
        (2, 0, 0, 0)
    assert r["builds"] == r["nvcc_runs"] == 0 and not r["built_here"]
    got = np.load(children["tmp"] / "require.npz")
    want = _unbanked()
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k


def test_subprocess_stale_code_relowers_not_crashes(children):
    """A fresh process whose sources hash differently misses both
    entries, rebuilds them cleanly beside the old ones, same results;
    before it imported torch it checked a release manifest."""
    r = children["stale"]
    assert (r["loaded"], r["compiled"], r["misses"]) == (0, 2, 2)
    assert r["verify_rc"] == 0 and r["imported"] == []
    a = np.load(children["tmp"] / "require.npz")
    b = np.load(children["tmp"] / "stale.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    v = children["bank"] / bank.BANK_DIRNAME
    assert len([p for p in v.iterdir() if p.name.endswith(".json")]) == 4


def test_spar_warmup_then_fresh_process_is_compile_free(children):
    """``python -m raft_tpu_torch.aot warmup`` stores the spar case
    program and the serve program of the one-rung ladder; a fresh
    process then answers both from the bank with no build."""
    lines = children["warm"].splitlines()
    assert any(ln.startswith("warmup cases") and "compiled 1 program(s)"
               in ln for ln in lines)
    assert any(ln.startswith("warmup serve") and "rows=2" in ln
               and "compiled 1 program(s)" in ln for ln in lines)
    r = children["require"]
    assert r["compiled"] == 0 and r["builds"] == 0 and r["loaded"] == 2


# ------------------------------------------------- beyond the reference


def test_bank_loaded_serve_bit_equal_and_hold_the_goldens(bank_dir,
                                                          monkeypatch):
    """Rung 4 of golden_serve_spar.npz: unbanked, then under load (built
    and stored), then under require from a fresh process's view
    (loaded): torch.equal outputs every time, within 1e-10 x max of the
    JAX serving engine, status equal."""
    from raft_tpu_torch.serve import engine

    entry = engine.Registry().register("spar", SPAR)
    g = np.load(os.path.join(FIX, "golden_serve_spar.npz"))
    Hs, Tp, beta = (g[f"r4_{k}"] for k in ("Hs", "Tp", "beta"))
    outs = {}
    for mode in ("off", "load", "require"):
        if mode == "require":
            fresh_process_view(monkeypatch)
        monkeypatch.setenv("RAFT_TPU_AOT", mode)
        c0 = counters()
        outs[mode] = engine.dispatch([entry] * len(Hs), Hs, Tp, beta,
                                     device="cpu", padded=4,
                                     record_metrics=False)
        want = {"off": (0, 0), "load": (0, 1), "require": (1, 0)}[mode]
        assert (delta(c0, "aot_programs_loaded"),
                delta(c0, "aot_programs_compiled")) == want, mode
    for mode in ("load", "require"):
        for k in outs["off"]:
            assert torch.equal(torch.as_tensor(outs[mode][k]),
                               torch.as_tensor(outs["off"][k])), (mode, k)
    np.testing.assert_array_equal(outs["require"]["status"], g["r4_status"])
    for k in ("PSD", "X0"):
        ref = g[f"r4_{k}"]
        assert np.max(np.abs(outs["require"][k] - ref)) \
            <= 1e-10 * np.max(np.abs(ref)), k


def _jax_bank_layout(root):
    """A bank laid out by the JAX package's format: an entry (sidecar +
    payload) under v1/, a release and its pointer under releases/."""
    import hashlib

    from raft_tpu.aot import bank as jbank

    v = os.path.join(root, f"v{jbank.BANK_FORMAT}")
    os.makedirs(v)
    payload = b"a serialized executable"
    meta = {"format": 1, "kind": "cases", "key": "ab" * 12,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "payload_bytes": len(payload), "version": {"jax": "0"},
            "created": 0.0}
    with open(os.path.join(v, "ab" * 12 + ".bin"), "wb") as f:
        f.write(payload)
    with open(os.path.join(v, "ab" * 12 + ".json"), "w") as f:
        json.dump(meta, f)
    rel = os.path.join(root, "releases")
    os.makedirs(rel)
    with open(GOOD) as f, open(os.path.join(rel, "e17e4da699db.json"),
                               "w") as g:
        g.write(f.read())
    with open(os.path.join(rel, "current.json"), "w") as f:
        json.dump({"release": "e17e4da699db", "t": 0.0}, f)
    return sorted(os.path.relpath(os.path.join(dp, fn), root)
                  for dp, _, fns in os.walk(root) for fn in fns)


def test_jax_and_port_banks_stay_apart(bank_dir, monkeypatch):
    """One RAFT_TPU_AOT_DIR holding both packages' banks: the port's
    scan / verify / gc (even --all) and releases never list, load or
    delete a JAX file, and the JAX package's never see the port's."""
    from raft_tpu.aot import bank as jbank
    from raft_tpu.aot import release as jrel
    from raft_tpu_torch.aot import release

    root = str(bank_dir)
    jax_files = _jax_bank_layout(root)
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    run_sweep(tiny_evaluator())
    release.cut(flags_fp="f" * 12, promote_after=True)
    port_files = sorted(
        os.path.relpath(os.path.join(dp, fn), root)
        for dp, _, fns in os.walk(root) for fn in fns
        if os.path.relpath(os.path.join(dp, fn), root) not in jax_files)
    assert all(p.startswith(("torch-v1/", "torch-releases/"))
               for p in port_files)

    assert [k for k, *_ in bank.scan()] == [bank_files(bank_dir)[0].stem]
    problems, _, n = bank.verify_bank()
    assert problems == [] and n == 1
    assert [m["release"] for m in release.list_releases()] == \
        [release.current_release()] != ["e17e4da699db"]
    assert [k for k, *_ in jbank.scan()] == ["ab" * 12]
    assert [m["release"] for m in jrel.list_releases()] == ["e17e4da699db"]

    assert bank.gc_bank(remove_all=True)["removed"] == 1
    assert bank_files(bank_dir) == [] and payload_files(bank_dir) == []
    left = sorted(os.path.relpath(os.path.join(dp, fn), root)
                  for dp, _, fns in os.walk(root) for fn in fns)
    assert set(jax_files) <= set(left)
    run_sweep(tiny_evaluator(stamp=("tiny", 3)))
    jbank.gc_bank(remove_all=True)
    assert len(bank_files(bank_dir)) == 1 and len(payload_files(bank_dir)) == 1
    assert release.current_release() is not None


def test_one_payload_per_sha_under_concurrent_stores(bank_dir, monkeypatch):
    """Entries share one payload file; stores racing on it from several
    threads leave it whole, with no tmp litter."""
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    errs = []

    def store(i):
        try:
            for j in range(5):
                bank.store("cases", ("race", i, j), ([1.0],), "cpu")
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=store, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    assert len(bank_files(bank_dir)) == 20
    [payload] = payload_files(bank_dir)
    assert payload.read_bytes() == bank.PLAIN_PAYLOAD
    assert bank.stray_tmp_files() == []
    assert bank.verify_bank()[0] == []


@pytest.mark.parametrize("same_bytes", [True, False])
def test_lookup_checks_the_library_in_use(bank_dir, tmp_path, monkeypatch,
                                          same_bytes):
    """An entry whose payload is a kernel library loads only when the
    library this process runs is that payload: a process that loaded
    another file of the same bytes loads the entry; one that loaded other
    bytes (another local nvcc build) misses, loudly, so no entry is
    stamped for a library that does not run."""
    from raft_tpu_torch.ops import linsolve

    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    lib = b"\x7fELF entry library"
    monkeypatch.setattr(bank, "_payload_bytes", lambda device: (lib, ".so"))
    bank.store("cases", ("lib",), ([1.0],), "cpu")
    in_use = tmp_path / "liblinsolve_local.so"
    in_use.write_bytes(lib if same_bytes else b"\x7fELF another build")
    monkeypatch.setattr(linsolve, "use_library", lambda path: str(in_use))
    c0 = counters()
    meta = bank.lookup("cases", ("lib",), ([1.0],), "cpu")
    assert (meta is not None) == same_bytes
    assert delta(c0, "aot_programs_loaded") == int(same_bytes)
    assert delta(c0, "aot_bank_errors") == int(not same_bytes)


def test_warmup_kinds_and_drivers_warmup(bank_dir, monkeypatch):
    """Every kind through warmup_model on the CPU (the serve ladder one
    rung): each report has the reference's fields plus launches, the bank
    stays off afterwards, and a second process's warm-up loads
    everything (drivers.warmup, the driver-level face)."""
    from raft_tpu_torch import drivers
    from raft_tpu_torch.aot import warmup

    monkeypatch.delenv("RAFT_TPU_AOT", raising=False)
    monkeypatch.setenv("RAFT_TPU_SERVE_LADDER", "1")
    reps = warmup.warmup_model(sizes=(2,), kinds=warmup.ALL_KINDS,
                               device="cpu")
    assert [r["kind"] for r in reps] == ["cases", "full", "design",
                                         "bucketed", "serve"]
    for r in reps:
        assert {"kind", "rows", "wall_s", "loaded", "compiled",
                "launches"} <= set(r)
        assert r["launches"] == 0 and r["loaded"] == 0
    assert [r["compiled"] for r in reps] == [1, 1, 1, 3, 1]
    assert bank.mode() == "off"
    fresh_process_view(monkeypatch)
    reps = drivers.warmup(SPAR, sizes=(2,), kinds=("cases", "design"),
                          device="cpu")
    assert [(r["loaded"], r["compiled"]) for r in reps] == [(1, 0), (1, 0)]


def test_fabric_worker_warms_before_its_first_claim(bank_dir, tmp_path,
                                                    monkeypatch):
    """A worker of a spec with a warm-up runs it before its first claim
    when the bank is armed: its start event and status carry the bank's
    counters and the warm-up's wall and launches, the shards then find
    the warm-up's program (no second build), and the sweep is
    bit-identical to the serial one."""
    from raft_tpu_torch.parallel import fabric, resilience

    log = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("RAFT_TPU_LOG", log)
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    entry = "raft_tpu_torch.parallel.fabric:demo_entry"
    kw = {"n": 8, "seed": 5, "out_keys": ["PSD", "X0", "status"]}
    ent = fabric.resolve_entry(entry, dict(kw, device="cpu"))
    out_dir = str(tmp_path / "fab")
    fabric.init_sweep(out_dir, entry, ent["cases"], kw["out_keys"], 4,
                      entry_kwargs=kw, warmup={"sizes": [4]}, device="cpu")
    monkeypatch.setattr(bank, "_SEEN", set())
    c0 = counters()
    worker = fabric.Worker(out_dir, worker_id="w0")
    try:
        assert worker.run() == 2
    finally:
        monkeypatch.delenv("RAFT_TPU_WORKER_ID", raising=False)
    assert delta(c0, "aot_programs_compiled") == 1
    with open(log) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    (start,) = [e for e in evs if e["event"] == "fabric_worker_start"]
    n0 = c0.get("aot_programs_compiled", 0)   # the process's counters
    assert start["programs_compiled"] == n0 + 1
    assert start["warmup_launches"] == 0
    assert start["warmup_s"] > 0
    (warm,) = [e for e in evs if e["event"] == "aot_warmup"]
    assert warm["kind"] == "cases" and warm["n"] == 4
    assert [e["t"] for e in evs if e["event"] == "shard_start"][0] > \
        warm["t"]
    status = fabric.Ledger(out_dir, 2).worker_states()["w0"]
    assert status["programs_compiled"] == n0 + 1
    out = fabric.assemble(out_dir)
    monkeypatch.delenv("RAFT_TPU_AOT")
    serial = resilience.run_checkpointed(
        ent["compute"], ent["cases"], str(tmp_path / "serial"), 4,
        make_mesh(device="cpu"), kw["out_keys"])
    for k in kw["out_keys"]:
        np.testing.assert_array_equal(out[k], serial[k])
