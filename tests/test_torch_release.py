"""The port's release manifests (``raft_tpu_torch/aot/release.py``)
against the reference's ``tests/test_release.py``, case for case, and
against the JAX package's own functions on the same inputs.

* every test of ``tests/test_release.py`` on the port's module: cut /
  verify / promote / rollback over a tmp releases dir — atomic current
  flips, tampered-manifest rejection, parent-chain walks, the
  rollout-marker parity window, the mismatch classifier and the
  release CLI;
* parity: ``compute_release_id``, ``sign_manifest``,
  ``verify_manifest``, ``walk_parents``, ``classify_mismatch``,
  ``format_diagnosis`` and ``ladder_state`` give the reference's bytes
  and values on fixed entries, code, flags, ladder, parent and
  ``created`` (the diagnosis' text names each package's own CLI); the
  checked-in ``tests/fixtures/releases/{good,tampered}.json`` verify in
  both packages as the reference says;
* the live diagnosis on the CPU: a warmed serve program, a release cut
  from it, then a flipped ``RAFT_TPU_FUSED`` named ``flags`` by
  ``release.diagnose`` and by the serving CLI, which exits 3 under
  ``RAFT_TPU_AOT=require``.
"""

import copy
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(ROOT, "tests", "fixtures", "releases")
SPAR = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                    "design_spar.json")


@pytest.fixture()
def rel_env(tmp_path, monkeypatch):
    """The port's release module pointed at an empty tmp AOT dir (every
    path in release.py resolves through RAFT_TPU_AOT_DIR on each call)."""
    from raft_tpu_torch.aot import release

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    release._PARITY_CACHE[:] = []
    return release


def _entries(n=2, sha_char="a"):
    return {f"k{i}": {"payload_sha256": sha_char * 64, "kind": "serve"}
            for i in range(n)}


def _cut(release, entries=None, flags="f" * 12, label=None, parent=None,
         promote_after=False):
    """A torch-free cut: build + write the manifest exactly like
    release.cut but with an injected flags fingerprint and entry set."""
    from raft_tpu_torch.aot import bank

    man = release.build_manifest(entries if entries is not None
                                 else _entries(),
                                 bank.code_fingerprint(), flags,
                                 parent=parent, label=label)
    os.makedirs(release.releases_dir(), exist_ok=True)
    bank._atomic_write(
        release.manifest_path(man["release"]),
        (json.dumps(man, indent=1, sort_keys=True) + "\n").encode())
    if promote_after:
        release.promote(man["release"])
    return man


# ------------------------------------------------------- identity & sign


def test_release_id_is_content_addressed(rel_env):
    release = rel_env
    a = _cut(release, flags="f1")
    b = _cut(release, flags="f1")
    c = _cut(release, flags="f2")
    assert a["release"] == b["release"]
    assert a["release"] != c["release"]
    assert len(a["release"]) == 12
    d = _cut(release, flags="f1", label="relabeled")
    assert d["release"] == a["release"]


def test_verify_manifest_clean_and_tampered(rel_env):
    release = rel_env
    man = _cut(release)
    assert release.verify_manifest(man) == []
    bad = json.loads(json.dumps(man))
    next(iter(bad["entries"].values()))["payload_sha256"] = "e" * 64
    problems = release.verify_manifest(bad)
    assert any("manifest_sha256" in p for p in problems)
    assert any("does not match its content" in p for p in problems)
    resigned = release.sign_manifest(dict(bad))
    problems = release.verify_manifest(resigned)
    assert problems and all("manifest_sha256" not in p for p in problems)
    swapped = dict(man)
    swapped["parent"] = "fff000fff000"
    assert release.verify_manifest(release.sign_manifest(dict(swapped)))
    assert release.verify_manifest({"schema": "nope"})
    assert release.verify_manifest(None)


def test_checked_in_lint_fixtures_verify_as_expected(rel_env):
    release = rel_env
    with open(os.path.join(FX, "good.json"), encoding="utf-8") as f:
        good = json.load(f)
    with open(os.path.join(FX, "tampered.json"), encoding="utf-8") as f:
        tampered = json.load(f)
    assert release.verify_manifest(good) == []
    assert release.verify_manifest(tampered)


# ------------------------------------------------------ pointer lifecycle


def test_promote_flips_current_atomically(rel_env):
    release = rel_env
    a = _cut(release, flags="fa")
    b = _cut(release, flags="fb")
    assert release.current_release() is None
    assert release.promote(a["release"]) is None
    assert release.current_release() == a["release"]
    assert release.promote(b["release"]) == a["release"]
    rid, man = release.resolve()
    assert rid == b["release"] and man["release"] == b["release"]
    names = os.listdir(release.releases_dir())
    assert "current.json" in names
    assert not [n for n in names if ".tmp" in n]


def test_promote_refuses_missing_or_tampered(rel_env):
    release = rel_env
    with pytest.raises(FileNotFoundError):
        release.promote("000000000000")
    man = _cut(release)
    path = release.manifest_path(man["release"])
    with open(path, encoding="utf-8") as f:
        bad = json.load(f)
    bad["entries"]["k0"]["payload_sha256"] = "e" * 64
    with open(path, "w", encoding="utf-8") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="refusing to promote"):
        release.promote(man["release"])


def test_rollback_walks_to_parent(rel_env):
    release = rel_env
    a = _cut(release, flags="fa", promote_after=True)
    b = _cut(release, flags="fb", parent=a["release"], promote_after=True)
    assert release.current_release() == b["release"]
    assert release.rollback() == (b["release"], a["release"])
    assert release.current_release() == a["release"]
    with pytest.raises(ValueError, match="no parent"):
        release.rollback()


def test_walk_parents_chain_and_cycle_guard(rel_env):
    release = rel_env
    a = _cut(release, flags="fa")
    b = _cut(release, flags="fb", parent=a["release"])
    c = _cut(release, flags="fc", parent=b["release"])
    chain = release.walk_parents(c["release"])
    assert [m["release"] for m in chain] == [c["release"], b["release"],
                                             a["release"]]
    with open(release.manifest_path(a["release"]), encoding="utf-8") as f:
        a2 = json.load(f)
    a2["parent"] = c["release"]
    with open(release.manifest_path(a["release"]), "w",
              encoding="utf-8") as f:
        json.dump(a2, f)
    assert len(release.walk_parents(c["release"])) == 3


def test_list_releases_newest_first_skips_pointers(rel_env):
    release = rel_env
    assert release.list_releases() == []
    a = _cut(release, flags="fa", promote_after=True)
    b = _cut(release, flags="fb", parent=a["release"])
    release.write_rollout_marker(a["release"], b["release"])
    ids = [m["release"] for m in release.list_releases()]
    assert set(ids) == {a["release"], b["release"]}
    assert ids[0] == b["release"]
    with open(os.path.join(release.releases_dir(), "junk.json"), "w",
              encoding="utf-8") as f:
        f.write("{not json")
    assert len(release.list_releases()) == 2


# ---------------------------------------------------- parity window view


def test_parity_context_rollout_window(rel_env):
    release = rel_env
    assert release.parity_context(now=0.0) is None
    a = _cut(release, entries=_entries(sha_char="a"), flags="fa",
             promote_after=True)
    ctx = release.parity_context(now=10.0)
    assert ctx["allowed"] == [a["release"]]
    assert ctx["entries"][a["release"]] == ["a" * 16]
    b = _cut(release, entries=_entries(sha_char="b"), flags="fb",
             parent=a["release"])
    release.promote(b["release"])
    release.write_rollout_marker(a["release"], b["release"])
    ctx = release.parity_context(now=20.0)
    assert ctx["allowed"] == sorted([a["release"], b["release"]])
    assert ctx["entries"][b["release"]] == ["b" * 16]
    release.clear_rollout_marker()
    assert release.parity_context(now=20.5)["allowed"] == ctx["allowed"]
    assert release.parity_context(now=30.0)["allowed"] == [b["release"]]


def test_version_aware_provenance_consistency(rel_env):
    """A mixed-version fleet mid-rollout is consistent; a replica on a
    release outside the window, or a sha outside its release's manifest,
    still splits (the port's obs.alerts on the release view)."""
    from raft_tpu_torch.obs.alerts import provenance_consistency

    releases = {"allowed": ["relA", "relB"],
                "entries": {"relA": ["a" * 16], "relB": ["b" * 16]}}

    def prov(rel, sha):
        return {"release": rel, "bank_sha": sha, "bank_key": "k",
                "code": "c", "flags": "f"}

    view = {"d": {"r0": prov("relA", "a" * 16),
                  "r1": prov("relB", "b" * 16)}}
    assert provenance_consistency(view, releases=releases)["consistent"]
    assert not provenance_consistency(view)["consistent"]
    view = {"d": {"r0": prov("relA", "a" * 16),
                  "r1": prov("relB", "skew" + "e" * 12)}}
    res = provenance_consistency(view, releases=releases)
    assert not res["consistent"]
    assert any(s["field"] == "bank_sha" for s in res["splits"])
    view = {"d": {"r0": prov("relZ", "a" * 16)}}
    res = provenance_consistency(view, releases=releases)
    assert any(s["field"] == "release" for s in res["splits"])


# ------------------------------------------------------------- diagnosis


def test_classify_mismatch_precedence(rel_env):
    release = rel_env
    ladder = release.ladder_state()
    man = {"code": "c1", "flags": "f1", "ladder": dict(ladder)}
    assert release.classify_mismatch(man, "c2", "f1", ladder) == "code"
    assert release.classify_mismatch(man, "c1", "f2", ladder) == "flags"
    retuned = dict(ladder, SERVE_MAX_BATCH=999)
    assert release.classify_mismatch(man, "c1", "f1", retuned) == "ladder"
    assert release.classify_mismatch(man, "c1", "f1", ladder) == "avals"


def _report():
    return {"release": "abc123abc123", "total": 4, "warmed": 2,
            "unwarmed": [{"design": "spar", "rows": 8, "key": "k1",
                          "reason": "ladder"},
                         {"design": "spar", "rows": 16, "key": "k2",
                          "reason": "bank-missing"}],
            "reason": "ladder"}


def test_format_diagnosis_names_reason_and_fix(rel_env):
    release = rel_env
    lines = release.format_diagnosis(_report(),
                                     design_paths=["designs/spar.json"])
    text = "\n".join(lines)
    assert "2/4" in text and "UNWARMED" in text
    assert "why [ladder]" in text and "why [bank-missing]" in text
    assert "python -m raft_tpu_torch.aot warmup --kinds serve" in text
    assert "--design designs/spar.json" in text
    assert "release cut --promote" in text


def test_capture_env_only_set_flags(rel_env, monkeypatch):
    release = rel_env
    monkeypatch.delenv("RAFT_TPU_SERVE_MAX_BATCH", raising=False)
    monkeypatch.setenv("RAFT_TPU_BUCKET_STEPS", "strips=16,32")
    env = release.capture_env()
    assert env.get("RAFT_TPU_BUCKET_STEPS") == "strips=16,32"
    assert "RAFT_TPU_SERVE_MAX_BATCH" not in env


def test_release_cli_verify_manifest_paths(rel_env, tmp_path):
    from raft_tpu_torch.aot.__main__ import main

    man = _cut(rel_env)
    path = rel_env.manifest_path(man["release"])
    assert main(["release", "verify", "--manifest", path]) == 0
    with open(path, encoding="utf-8") as f:
        bad = json.load(f)
    bad["flags"] = "tampered"
    bad_path = str(tmp_path / "bad.json")
    with open(bad_path, "w", encoding="utf-8") as f:
        json.dump(bad, f)
    assert main(["release", "verify", "--manifest", bad_path]) == 1
    b = _cut(rel_env, flags="fb", parent=man["release"])
    assert main(["release", "promote", man["release"]]) == 0
    assert main(["release", "promote", b["release"]]) == 0
    assert main(["release", "list"]) == 0
    assert main(["release", "rollback"]) == 0
    assert rel_env.current_release() == man["release"]


# ------------------------------------------- parity with the JAX package

LADDER = {"BUCKET_ROWS": 512,
          "BUCKET_STEPS": "strips=16,24,32,48,64,96,128;nodes=pow2;"
                          "lines=pow2",
          "SERVE_LADDER": "cost", "SERVE_MAX_BATCH": 64}
PARITY_SETS = [
    (None, "c0dec0dec0de", "f1a95f1a95f1", LADDER, _entries(2, "a")),
    ("e17e4da699db", "0123456789abcdef", "ffffffffffff",
     dict(LADDER, SERVE_MAX_BATCH=16), _entries(3, "b")),
    ("abc", "c", "f", {}, {}),
]


@pytest.mark.parametrize("case", range(len(PARITY_SETS)))
def test_release_identity_and_signature_match_the_reference(case):
    """compute_release_id, sign_manifest and verify_manifest give the
    reference's bytes and values on the same fixed inputs, a manifest
    made by either package verifies in both, and a tamper is caught by
    both with the same problems."""
    from raft_tpu.aot import release as jrel
    from raft_tpu_torch.aot import release as trel

    parent, code, flags, ladder, entries = PARITY_SETS[case]
    rid = trel.compute_release_id(parent, code, flags, ladder, entries)
    assert rid == jrel.compute_release_id(parent, code, flags, ladder,
                                          entries)
    man = {"schema": "release-manifest-v1", "release": rid,
           "created": 1754500000.0, "label": "parity", "parent": parent,
           "bank_format": 1, "code": code, "flags": flags,
           "ladder": ladder, "env": {}, "entries": entries,
           "n_entries": len(entries), "manifest_sha256": ""}
    t_man = trel.sign_manifest(copy.deepcopy(man))
    j_man = jrel.sign_manifest(copy.deepcopy(man))
    assert t_man == j_man
    assert trel._canonical(t_man) == jrel._canonical(j_man)
    assert trel.verify_manifest(j_man) == jrel.verify_manifest(t_man) == []
    bad = copy.deepcopy(t_man)
    bad["flags"] = "tampered"
    assert trel.verify_manifest(bad) == jrel.verify_manifest(bad)
    assert trel.verify_manifest(bad)


@pytest.mark.parametrize("name", ("good", "tampered"))
def test_checked_in_fixtures_verify_in_both_packages(name):
    from raft_tpu.aot import release as jrel
    from raft_tpu_torch.aot import release as trel

    man = trel.load_manifest(os.path.join(FX, f"{name}.json"))
    assert trel.verify_manifest(man) == jrel.verify_manifest(man)
    assert (trel.verify_manifest(man) == []) == (name == "good")


def test_walk_parents_classify_and_ladder_match_the_reference(tmp_path,
                                                              monkeypatch):
    """The same chain of manifests, written under each package's
    releases directory of one root, walks the same; classify_mismatch
    and ladder_state agree."""
    from raft_tpu.aot import release as jrel
    from raft_tpu_torch.aot import release as trel

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    assert trel.releases_dir() != jrel.releases_dir()
    parent = None
    for i in range(3):
        man = trel.sign_manifest({
            "schema": "release-manifest-v1",
            "release": trel.compute_release_id(parent, "c", f"f{i}",
                                               LADDER, _entries(i)),
            "created": 1754500000.0 + i, "label": "", "parent": parent,
            "bank_format": 1, "code": "c", "flags": f"f{i}",
            "ladder": LADDER, "env": {}, "entries": _entries(i),
            "n_entries": i, "manifest_sha256": ""})
        for rel in (trel, jrel):
            os.makedirs(rel.releases_dir(), exist_ok=True)
            with open(rel.manifest_path(man["release"]), "w",
                      encoding="utf-8") as f:
                json.dump(man, f)
        parent = man["release"]
    assert trel.walk_parents(parent) == jrel.walk_parents(parent)
    assert len(trel.walk_parents(parent)) == 3
    assert [m["release"] for m in trel.list_releases()] == \
        [m["release"] for m in jrel.list_releases()]
    assert trel.ladder_state() == jrel.ladder_state()
    man = {"code": "c1", "flags": "f1", "ladder": dict(LADDER)}
    for args in (("c2", "f1", LADDER), ("c1", "f2", LADDER),
                 ("c1", "f1", dict(LADDER, SERVE_LADDER="pow2")),
                 ("c1", "f1", LADDER)):
        assert trel.classify_mismatch(man, *args) == \
            jrel.classify_mismatch(man, *args)


def test_format_diagnosis_matches_the_reference():
    """The same report renders the reference's lines, each package
    naming its own CLI and sources."""
    from raft_tpu.aot import release as jrel
    from raft_tpu_torch.aot import release as trel

    for paths in ((), ("designs/spar.json", "designs/semi.json")):
        want = [ln.replace("raft_tpu", "raft_tpu_torch")
                for ln in jrel.format_diagnosis(_report(), paths)]
        assert trel.format_diagnosis(_report(), paths) == want


# --------------------------------------------------- the live diagnosis


@pytest.fixture()
def warmed(tmp_path, monkeypatch):
    """One spar serve program (rung 1) warmed on the CPU under load,
    and a release cut from it and promoted."""
    from raft_tpu_torch.aot import release
    from raft_tpu_torch.serve import engine

    monkeypatch.setenv("RAFT_TPU_AOT_DIR", str(tmp_path))
    monkeypatch.setenv("RAFT_TPU_SERVE_LADDER", "1")
    monkeypatch.setenv("RAFT_TPU_AOT", "load")
    release._PARITY_CACHE[:] = []
    reg = engine.Registry()
    entry = reg.register("spar", SPAR)
    reps = engine.warm([entry], device="cpu")
    assert [r["rows"] for r in reps] == [1]
    man = release.cut(promote_after=True)
    assert man["n_entries"] == 1
    return entry, man


def test_live_diagnosis_names_flags_after_a_flag_flip(warmed, monkeypatch):
    from raft_tpu_torch.aot import release

    entry, man = warmed
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    rep = release.diagnose([entry], device="cpu", manifest=man)
    assert rep["unwarmed"] == [] and rep["warmed"] == rep["total"] == 1
    monkeypatch.setenv("RAFT_TPU_FUSED", "off")
    rep = release.diagnose([entry], device="cpu", manifest=man)
    assert rep["reason"] == "flags" and rep["total"] == 1
    assert [u["reason"] for u in rep["unwarmed"]] == ["flags"]
    assert release.verify_against_bank(man) == []


def test_require_server_on_a_skewed_bank_exits_3_naming_flags(
        warmed, monkeypatch, capsys):
    """``python -m raft_tpu_torch.serve`` under require on a bank warmed
    under other flags resolves the release, prints it, and exits 3 with
    the preflight diagnosis naming ``flags`` (in-process: the CLI
    returns before it binds a socket)."""
    from raft_tpu_torch.serve.__main__ import main

    _, man = warmed
    monkeypatch.setenv("RAFT_TPU_AOT", "require")
    monkeypatch.setenv("RAFT_TPU_FUSED", "off")
    rc = main(["--designs", f"spar={SPAR}", "--device", "cpu",
               "--port", "0"])
    out, err = capsys.readouterr()
    assert rc == 3
    assert f"release: {man['release']}" in out
    assert f"bank preflight vs release {man['release']}" in err
    assert "why [flags]" in err and "spar x rows=1: flags" in err
    assert "python -m raft_tpu_torch.aot warmup --kinds serve" in err
