"""Immutable, content-addressed releases of the program bank (the port's
counterpart of ``raft_tpu/aot/release.py``, on the same manifest
schema, canonical JSON and signing).

A warmed bank directory is the deploy artifact, but a directory is not
a *version*: nothing names the exact entry set a server was warmed
from.  A **release** is a signed manifest snapshotting the port's bank
— every entry key with its payload sha, the code fingerprint, the
flags fingerprint and the batch-ladder state that shaped the keys,
plus the parent release — written under ``RAFT_TPU_AOT_DIR/
torch-releases/`` (the JAX package's are under ``releases/``) and
addressed by a hash of its own content:

* the release id is ``sha256(format, parent, code, flags, ladder,
  entries)[:12]`` — two cuts of the same bank state under the same
  flags are the SAME release;
* the manifest is signed by ``manifest_sha256`` over its canonical JSON
  body, so any tamper after the cut (an edited entry sha, a swapped
  parent) is caught by ``release verify``;
* the bank directory stays the one content-addressed store; a release
  is a *view*, so cutting one writes metadata, never copies;
* ``torch-releases/current.json`` is the pointer a serving process
  resolves at start-up (flipped by atomic rename: ``promote`` /
  ``rollback``); the resolved id is stamped into every
  ``x-raft-provenance`` header, and ``rollout.json`` marks a rolling
  upgrade's window.

A manifest is plain data, so the reference's manifests verify here as
there.  The flags whose values shape the port's keys are
:data:`TRACE_FLAG_NAMES` (the port's evaluator flags: the reference's
less ``FIXED_POINT``, which the port does not have) and
:data:`LADDER_FLAG_NAMES`.  The mismatch classes of :func:`diagnose`
are the reference's, ``code | flags | ladder | avals``; the port's
"avals" is the input signature.

CLI: ``python -m raft_tpu_torch.aot release {cut,list,verify,promote,
rollback}``.  ``verify --manifest`` is a pure integrity check: it
imports the standard library and the port's stdlib-only modules (this
one, the bank's key and layout, the flag registry), never torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from raft_tpu_torch.aot import bank
from raft_tpu_torch.utils import config, fsops
from raft_tpu_torch.utils.structlog import log_event

RELEASES_DIRNAME = "torch-releases"
MANIFEST_SCHEMA = "release-manifest-v1"

#: the flags whose values shape bank keys (the evaluator flags + the
#: batch-ladder geometry), captured into the manifest's ``env`` block
TRACE_FLAG_NAMES = config.EVALUATOR_FLAGS
LADDER_FLAG_NAMES = ("SERVE_LADDER", "SERVE_MAX_BATCH",
                     "BUCKET_STEPS", "BUCKET_ROWS")


def releases_dir(aot_dir=None):
    return os.path.join(aot_dir or bank.aot_root(), RELEASES_DIRNAME)


def manifest_path(release_id, aot_dir=None):
    return os.path.join(releases_dir(aot_dir), f"{release_id}.json")


def current_path(aot_dir=None):
    return os.path.join(releases_dir(aot_dir), "current.json")


def rollout_marker_path(aot_dir=None):
    return os.path.join(releases_dir(aot_dir), "rollout.json")


def _canonical(obj):
    """Canonical JSON bytes — the signing/addressing domain."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


# ----------------------------------------------------------------- build


def ladder_state():
    """The batch-ladder flag values that shape the serve bank keys —
    part of the release identity: a ladder retune re-keys the bank."""
    return {k: config.get(k) for k in LADDER_FLAG_NAMES}


def capture_env():
    """The explicitly-SET ``RAFT_TPU_*`` environment of the key-shaping
    flags (unset flags stay unset: a process of the release then sees
    the same defaults)."""
    env = {}
    for k in TRACE_FLAG_NAMES + LADDER_FLAG_NAMES:
        name = config.env_name(k)
        if name in os.environ:
            env[name] = os.environ[name]
    return env


def snapshot_entries():
    """``{entry_key: {payload_sha256, kind}}`` of every bank entry the
    CURRENT code would load (other source states are dead weight, not
    release content; other environments — another card, the CPU — are
    legitimate coexisting variants and stay in)."""
    code = bank.code_fingerprint()
    out = {}
    for key, meta, meta_path, path in bank.scan():
        if meta is None or meta_path is None or path is None \
                or not os.path.exists(path):
            continue
        if meta.get("format") != bank.BANK_FORMAT:
            continue
        if (meta.get("version") or {}).get("code") != code:
            continue
        out[key] = {"payload_sha256": meta.get("payload_sha256") or "",
                    "kind": meta.get("kind") or "?"}
    return out


def compute_release_id(parent, code, flags, ladder, entries):
    """Content address over everything that makes the release what it
    is (created/label/env are provenance, not identity)."""
    ident = {"format": bank.BANK_FORMAT, "parent": parent, "code": code,
             "flags": flags, "ladder": ladder, "entries": entries}
    return hashlib.sha256(_canonical(ident)).hexdigest()[:12]


def sign_manifest(man):
    """``manifest_sha256`` over the canonical body minus the signature
    itself; returns the signed manifest."""
    body = {k: v for k, v in man.items() if k != "manifest_sha256"}
    man["manifest_sha256"] = hashlib.sha256(_canonical(body)).hexdigest()
    return man


def build_manifest(entries, code, flags, parent=None, label=None):
    """The release-manifest record (schema ``release-manifest-v1``)."""
    ladder = ladder_state()
    man = {
        "schema": MANIFEST_SCHEMA,
        "release": compute_release_id(parent, code, flags, ladder,
                                      entries),
        "created": time.time(),
        "label": str(label or ""),
        "parent": parent,
        "bank_format": bank.BANK_FORMAT,
        "code": code,
        "flags": flags,
        "ladder": ladder,
        "env": capture_env(),
        "entries": dict(entries),
        "n_entries": len(entries),
        "manifest_sha256": "",  # filled by sign_manifest below
    }
    return sign_manifest(man)


def cut(label=None, flags_fp=None, promote_after=False):
    """Cut a release from the current bank snapshot; returns the written
    manifest.  ``flags_fp`` defaults to the live serving flags
    fingerprint (:func:`raft_tpu_torch.serve.engine.flags_fingerprint`,
    which imports torch; pass one to stay torch-free).  Cutting an
    identical state twice is idempotent: same id, same file."""
    if flags_fp is None:
        from raft_tpu_torch.serve import engine

        flags_fp = engine.flags_fingerprint()
    entries = snapshot_entries()
    man = build_manifest(entries, bank.code_fingerprint(), str(flags_fp),
                         parent=current_release(), label=label)
    fsops.makedirs(releases_dir(), exist_ok=True)
    fsops.write_atomic(
        manifest_path(man["release"]),
        json.dumps(man, indent=1, sort_keys=True) + "\n")
    log_event("release_cut", release=man["release"], parent=man["parent"],
              entries=man["n_entries"], label=man["label"] or None)
    if promote_after:
        promote(man["release"])
    return man


# ------------------------------------------------------------------ load


def load_manifest(path):
    """Parse one manifest file; None when missing/garbled (a reader
    must never crash on a foreign file)."""
    try:
        man = json.loads(fsops.read_text(path))
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) else None


def load_release(release_id, aot_dir=None):
    return load_manifest(manifest_path(release_id, aot_dir))


def list_releases(aot_dir=None):
    """Every readable manifest under torch-releases/, newest first."""
    d = releases_dir(aot_dir)
    out = []
    try:
        names = sorted(fsops.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json") or name in ("current.json",
                                                  "rollout.json"):
            continue
        man = load_manifest(os.path.join(d, name))
        if man is not None and man.get("release") == name[:-5]:
            out.append(man)
    out.sort(key=lambda m: m.get("created") or 0, reverse=True)
    return out


def current_release(aot_dir=None):
    """The id the ``current`` pointer names, or None."""
    try:
        rec = json.loads(fsops.read_text(current_path(aot_dir)))
        return str(rec["release"]) if isinstance(rec, dict) else None
    except (OSError, ValueError, KeyError):
        return None


def resolve(aot_dir=None):
    """``(release_id, manifest)`` through the current pointer — what a
    serving process resolves at start-up — or ``(None, None)`` when no
    release is in use (releases are opt-in)."""
    rid = current_release(aot_dir)
    if rid is None:
        return None, None
    return rid, load_release(rid, aot_dir)


# ---------------------------------------------------------------- verify


def verify_manifest(man):
    """Pure integrity problems of one manifest (no bank access): the
    schema, the self-signature and the content address must all hold."""
    problems = []
    if not isinstance(man, dict) or man.get("schema") != MANIFEST_SCHEMA:
        return [f"not a {MANIFEST_SCHEMA} manifest"]
    for k in ("release", "code", "flags", "ladder", "entries",
              "manifest_sha256", "bank_format"):
        if k not in man:
            problems.append(f"missing required key {k!r}")
    if problems:
        return problems
    body = {k: v for k, v in man.items() if k != "manifest_sha256"}
    want = hashlib.sha256(_canonical(body)).hexdigest()
    if man["manifest_sha256"] != want:
        problems.append("manifest_sha256 mismatch (tampered or "
                        "hand-edited manifest)")
    rid = compute_release_id(man.get("parent"), man["code"], man["flags"],
                             man["ladder"], man["entries"])
    if man["release"] != rid:
        problems.append(f"release id {man['release']} does not match "
                        f"its content (expect {rid})")
    if man["bank_format"] != bank.BANK_FORMAT:
        problems.append(f"bank format {man['bank_format']} != "
                        f"{bank.BANK_FORMAT} (foreign toolchain)")
    return problems


def verify_against_bank(man):
    """Problems of a release against the live bank directory: every
    manifest entry must exist with its exact payload sha (a release
    whose objects were gc'd or rewritten cannot be served)."""
    problems = []
    for key, ent in sorted((man.get("entries") or {}).items()):
        meta = bank.read_meta(key)
        if meta is None:
            problems.append(f"{key}: bank entry missing/unreadable "
                            "(gc'd from under the release?)")
            continue
        if meta.get("payload_sha256") != ent.get("payload_sha256"):
            problems.append(f"{key}: bank payload sha differs from the "
                            "manifest (entry rewritten after the cut)")
    return problems


def walk_parents(release_id, aot_dir=None, max_depth=64):
    """The parent chain starting at ``release_id`` (inclusive), oldest
    last; cycles/missing parents just end the walk."""
    chain, seen = [], set()
    rid = release_id
    while rid and rid not in seen and len(chain) < max_depth:
        seen.add(rid)
        man = load_release(rid, aot_dir)
        if man is None:
            break
        chain.append(man)
        rid = man.get("parent")
    return chain


# --------------------------------------------------------------- pointer


def promote(release_id, aot_dir=None):
    """Flip ``current`` to ``release_id`` (atomic rename — a reader
    sees the old pointer or the new one, never a torn write).  Returns
    the previous id.  The manifest must exist and verify."""
    man = load_release(release_id, aot_dir)
    if man is None:
        raise FileNotFoundError(
            f"no release {release_id!r} under {releases_dir(aot_dir)} "
            "(cut it first: python -m raft_tpu_torch.aot release cut)")
    problems = verify_manifest(man)
    if problems:
        raise ValueError(f"refusing to promote {release_id}: "
                         + "; ".join(problems))
    previous = current_release(aot_dir)
    fsops.makedirs(releases_dir(aot_dir), exist_ok=True)
    fsops.write_atomic(
        current_path(aot_dir),
        json.dumps({"release": str(release_id), "t": time.time()}) + "\n")
    log_event("release_promote", release=str(release_id),
              previous=previous)
    return previous


def rollback(aot_dir=None):
    """Re-point ``current`` at the current release's parent.  Returns
    ``(from_id, to_id)``."""
    rid = current_release(aot_dir)
    if rid is None:
        raise FileNotFoundError("no current release to roll back from")
    man = load_release(rid, aot_dir)
    parent = (man or {}).get("parent")
    if not parent:
        raise ValueError(f"release {rid} has no parent to roll back to")
    promote(parent, aot_dir)
    log_event("release_rollback", release=rid, to=parent)
    return rid, parent


# --------------------------------------------------------- rollout marker


def write_rollout_marker(from_id, to_id, aot_dir=None):
    """Mark a rolling upgrade in progress: BOTH releases are legitimate
    fleet members until the marker clears — the canary's
    provenance-consistency check reads this window."""
    fsops.makedirs(releases_dir(aot_dir), exist_ok=True)
    fsops.write_atomic(
        rollout_marker_path(aot_dir),
        json.dumps({"from": from_id, "to": to_id, "t": time.time()}) + "\n")


def read_rollout_marker(aot_dir=None):
    try:
        rec = json.loads(fsops.read_text(rollout_marker_path(aot_dir)))
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


def clear_rollout_marker(aot_dir=None):
    try:
        fsops.unlink(rollout_marker_path(aot_dir))
        return True
    except OSError:
        return False


_PARITY_LOCK = threading.Lock()
#: (aot_dir, computed_t, value) — the canary calls parity_context per
#: probe observation; 1s of staleness is fine, per-probe file IO is not
_PARITY_CACHE: list = []  # raft-lint: guarded-by=_PARITY_LOCK


def parity_context(aot_dir=None, ttl_s=1.0, now=None):
    """The release view the provenance-consistency check needs
    (:func:`raft_tpu_torch.obs.alerts.provenance_consistency`):
    ``{"allowed": [release ids legitimately in the fleet], "entries":
    {release_id: [16-char payload sha prefixes]}}`` — or None when no
    release is present.  Mid-rollout the marker's from/to are BOTH
    allowed; otherwise only ``current`` is.  Cached ~1s."""
    aot_dir = aot_dir or bank.aot_root()
    now = time.monotonic() if now is None else now
    with _PARITY_LOCK:
        if _PARITY_CACHE and _PARITY_CACHE[0] == aot_dir \
                and now - _PARITY_CACHE[1] < ttl_s:
            return _PARITY_CACHE[2]
    rid = current_release(aot_dir)
    value = None
    if rid is not None:
        allowed = {rid}
        marker = read_rollout_marker(aot_dir)
        if marker:
            allowed |= {str(v) for v in (marker.get("from"),
                                         marker.get("to")) if v}
        entries = {}
        for r in sorted(allowed):
            man = load_release(r, aot_dir)
            if man is not None:
                entries[r] = sorted(
                    {str(e.get("payload_sha256") or "")[:16]
                     for e in (man.get("entries") or {}).values()})
        value = {"allowed": sorted(allowed), "entries": entries}
    with _PARITY_LOCK:
        _PARITY_CACHE[:] = [aot_dir, now, value]
    return value


# ------------------------------------------------------------- diagnosis


def classify_mismatch(man, code, flags, ladder):
    """WHY a live process misses a release's bank entries, in key-
    component precedence order: a code edit re-keys everything (check
    first), then a flag flip, then a ladder retune; ``avals`` is the
    remainder (design set / out_keys / input-signature drift)."""
    if man.get("code") != code:
        return "code"
    if man.get("flags") != flags:
        return "flags"
    if {k: man.get("ladder", {}).get(k) for k in LADDER_FLAG_NAMES} \
            != {k: ladder.get(k) for k in LADDER_FLAG_NAMES}:
        return "ladder"
    return "avals"


def diagnose(entries, device=None, out_keys=None, sizes=None,
             manifest=None):
    """Bank-warmth report of the live design set against a release: for
    every (design x ladder rung) program on ``device``, is it banked —
    and when not, WHICH key component drifted from the manifest.
    Returns ``{"release", "total", "warmed", "unwarmed": [{design,
    rows, key, reason}], "reason"}``."""
    from raft_tpu_torch.serve import engine

    out_keys = engine.normalize_out_keys(out_keys)
    sizes = tuple(sizes) if sizes else engine.batch_ladder()
    man = manifest or {}
    reason = classify_mismatch(man, bank.code_fingerprint(),
                               engine.flags_fingerprint(),
                               ladder_state()) if man else None
    unwarmed, total = [], 0
    for entry in entries:
        for rows in sizes:
            total += 1
            try:
                key = engine.program_identity(
                    entry, out_keys=out_keys, rows=rows, device=device)[0]
                side = bank.read_meta(key)
            except Exception:  # noqa: BLE001 — diagnosis is telemetry
                key, side = None, None
            if side is not None:
                continue
            why = reason or "avals"
            if man and key and key in (man.get("entries") or {}):
                why = "bank-missing"  # manifest promises it; bank lost it
            unwarmed.append({"design": entry.name, "rows": int(rows),
                             "key": key, "reason": why})
    report = {"release": man.get("release"), "total": total,
              "warmed": total - len(unwarmed), "unwarmed": unwarmed,
              "reason": (reason if unwarmed else None)}
    log_event("release_preflight", release=report["release"],
              unwarmed=len(unwarmed), total=total,
              reason=report["reason"])
    return report


def warmup_command(design_paths, dtype=None, device=None):
    """The exact re-warm command a failed preflight prints (``dtype`` and
    ``device`` as the server ran them; the reference's ``x64``)."""
    cmd = "python -m raft_tpu_torch.aot warmup --kinds serve"
    for p in design_paths:
        cmd += f" --design {p}"
    if dtype:
        cmd += f" --dtype {dtype}"
    if device:
        cmd += f" --device {device}"
    return cmd


_REASON_HELP = {
    "code": "the raft_tpu_torch source changed since the release was cut "
            "(every bank key embeds the code fingerprint)",
    "flags": "trace-time RAFT_TPU_* flags differ from the release "
             "(SOLVER/DTYPE/ITER_SCALE/... are part of every key)",
    "ladder": "the batch ladder changed (SERVE_LADDER/SERVE_MAX_BATCH/"
              "BUCKET_* retune re-keys the serve programs — cut a new "
              "release and roll it out instead of re-warming by hand)",
    "avals": "the design set / out_keys / batch shapes differ from "
             "what was warmed",
    "bank-missing": "the manifest promises this entry but the bank "
                    "directory lost it (gc'd or deleted?)",
}


def format_diagnosis(report, design_paths=(), dtype=None, device=None):
    """Human lines for a failed preflight: which programs are cold,
    why, and the exact command that fixes it."""
    lines = []
    rel = report.get("release")
    head = (f"release {rel}" if rel else "bank (no release manifest)")
    lines.append(f"bank preflight vs {head}: "
                 f"{len(report['unwarmed'])}/{report['total']} serve "
                 "program(s) UNWARMED")
    for row in report["unwarmed"]:
        lines.append(f"  {row['design']} x rows={row['rows']}: "
                     f"{row['reason']} (key {row['key']})")
    reasons = {row["reason"] for row in report["unwarmed"]}
    for r in sorted(reasons):
        if r in _REASON_HELP:
            lines.append(f"  why [{r}]: {_REASON_HELP[r]}")
    if design_paths:
        lines.append("warm the bank, then cut + promote a release:")
        cmd = warmup_command(design_paths, dtype=dtype, device=device)
        lines.append(f"  {cmd}")
        lines.append("  python -m raft_tpu_torch.aot release cut --promote")
    return lines
