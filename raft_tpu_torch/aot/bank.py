"""The program bank: records of the programs a warm-up built and ran, so
that a fresh process loads them instead of building them (the port's
counterpart of ``raft_tpu/aot/bank.py``).

Torch has no serialized executable.  A port program is eager PyTorch
plus one hand-written library, ``csrc/linsolve.cu``, which ``nvcc``
builds into ``raft_tpu_torch/build/liblinsolve_<sha12>.so``
(:mod:`raft_tpu_torch.ops.linsolve`).  So a bank entry is a record of a
program that ran on this environment, in two parts:

* a **sidecar** ``<key>.json``, keyed like the reference's
  :func:`entry_key`: the kind, the memo key (out_keys, the mesh's
  devices, the evaluator flags :func:`raft_tpu_torch.utils.config.
  flags_key` and the program identity — a design's content fingerprint
  or a bucket signature's), the **input signature** in place of avals
  (structure, shapes and dtypes of the padded inputs), the
  **environment** (platform, device name, compute capability, dtype
  policy) and the **version** (torch, ``torch.version.cuda``, the
  port's :func:`code_fingerprint`, the bank format).  It also carries
  ``payload``, ``payload_sha256``, ``payload_bytes``, ``created``, the
  first run's wall (``compile_s``) and its kernel launches;
* a **payload**, the kernel library the entry ran, stored once per
  library sha under ``lib/`` of the bank, so a bank directory is a
  self-contained deploy artifact.  An entry recorded on the CPU ran no
  kernel: its payload is the plain-version marker :data:`PLAIN_PAYLOAD`,
  checked like a library.

Layout: ``<RAFT_TPU_AOT_DIR>/torch-v<BANK_FORMAT>/`` for the sidecars
and ``lib/``, ``<RAFT_TPU_AOT_DIR>/torch-releases/`` for the releases
(:mod:`raft_tpu_torch.aot.release`).  The JAX package keeps ``v1/`` and
``releases/`` under the same root: neither package lists, loads or
deletes the other's files.

Modes (``RAFT_TPU_AOT``, re-read per call):

* ``off`` (default) — no file is read or written; outputs and launch
  counts are those of a process without a bank;
* ``load`` — the funnels (:func:`raft_tpu_torch.parallel.sweep.
  sweep_cases` / ``sweep_cases_full`` / ``sweep_heterogeneous`` and
  :func:`raft_tpu_torch.serve.engine.dispatch`) consult the bank once
  per (program identity x input signature x environment) per process,
  before the program's first run; after that the check is a set lookup;
* ``require`` — a miss raises :class:`BankMissError` before anything
  runs (or, with ``RAFT_TPU_AOT_MISS=compile``, logs and builds).

The counters: ``aot_programs_loaded`` — a valid entry was found, so
nothing was built (on the card the bank's copy of the library is
loaded, after its sha is checked, and ``nvcc`` never runs);
``aot_programs_compiled`` — the entry was missing or stale, so the
program was built (run a first time, the library built with ``nvcc``
only when its file is absent) and stored; ``aot_bank_misses`` and
``aot_bank_errors`` (a corrupt entry is a miss, never a crash).
``RAFT_TPU_COMPILE_BUDGET`` bounds the program builds of a process:
``aot_programs_compiled`` plus ``nvcc`` runs (:func:`charge_build`, from
:mod:`raft_tpu_torch.utils.budget`).

Not ported, being XLA's: ``_arm_native_callbacks`` (it initialises
LAPACK's kernel pointers before a deserialised executable can call
them; a loaded library is ready when dlopened), ``_compile_fresh`` (it
dodges XLA's disk cache, whose executables re-serialise without their
symbols; a library is stored as the file that ran) and
``cost_analysis_dict`` (XLA's cost analysis; the port's cost ledger is
the kernel ledger of :func:`ledger_summary`).

Also here: :func:`content_fingerprint` (the same 16-hex digest as the
reference's for the same data) and :func:`ledger_summary` /
:func:`merge_ledgers`, one row per solve-kernel entry that launched.

Pure stdlib at import: the release module and its manifest check import
this without torch or numpy.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import threading
import time
from typing import NamedTuple

from raft_tpu_torch.obs import metrics
from raft_tpu_torch.utils import budget, config, fsops
from raft_tpu_torch.utils.structlog import log_event

#: bump when the on-disk layout or payload format changes — old
#: directories are simply never read (the reference's format number, so
#: release manifests of both packages check the same way)
BANK_FORMAT = 1
#: the port's format directory under RAFT_TPU_AOT_DIR (the reference's
#: is ``v<format>``)
BANK_DIRNAME = f"torch-v{BANK_FORMAT}"
PAYLOAD_DIRNAME = "lib"
#: the payload of an entry recorded on the CPU, where a program runs
#: the plain PyTorch version of the kernel
PLAIN_PAYLOAD = (b"raft_tpu_torch program bank: plain PyTorch version, "
                 b"no kernel library\n")

_META_SUFFIX = ".json"
_PAYLOAD_SUFFIXES = (".so", ".plain")


class BankMissError(RuntimeError):
    """``RAFT_TPU_AOT=require`` and the program bank has no entry for
    this key (run ``python -m raft_tpu_torch.aot warmup`` first, or warm
    the bank with one ``RAFT_TPU_AOT=load`` run of the same workload)."""


def mode():
    """Current bank mode (off | load | require), re-read per call."""
    return config.get("AOT")


def aot_root():
    """``RAFT_TPU_AOT_DIR``, else the port's own default root
    ``~/.cache/raft_tpu_torch/aot_bank`` (the JAX package's default is
    another directory)."""
    return (config.get("AOT_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "raft_tpu_torch", "aot_bank"))


def bank_dir():
    """The port's versioned bank directory for the current format."""
    return os.path.join(aot_root(), BANK_DIRNAME)


def payload_dir():
    """Where the payloads live, one file per sha."""
    return os.path.join(bank_dir(), PAYLOAD_DIRNAME)


# --------------------------------------------------------------- fingerprints

_CODE_FP_CACHE: dict = {}


def code_fingerprint():
    """Content hash (16 hex) over every ``raft_tpu_torch`` source file
    (``.py``, and the kernels' ``.cu`` / ``.cpp``); cached per
    process.  Coarse on purpose: any edit re-keys every entry, so an
    entry never serves a program the current code would not run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root in _CODE_FP_CACHE:
        return _CODE_FP_CACHE[root]
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if not fn.endswith((".py", ".cu", ".cpp")):
                continue
            path = os.path.join(dirpath, fn)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    fp = h.hexdigest()[:16]
    _CODE_FP_CACHE[root] = fp
    return fp


def file_fingerprint(path):
    """Content hash of one source file — for code living outside the
    ``raft_tpu_torch`` package (a user's sweep script), which
    :func:`code_fingerprint` cannot see: mix it into the program stamp
    so an edit there misses the bank."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def program_key(evaluate):
    """The evaluator's bank identity stamp (``_raft_program_key``, set by
    the factories of :mod:`raft_tpu_torch.api`), or None when it has
    none: an unstamped evaluator is never banked, since nothing else in
    the key tells apart the data it holds."""
    return getattr(evaluate, "_raft_program_key", None)


def version_fingerprint():
    """Toolchain identity: entries of another torch / CUDA or another
    state of the port's sources are dead (gc'd), not variants."""
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "code": code_fingerprint(), "format": BANK_FORMAT}


def device_name(device):
    """``device`` as a stable string: a CUDA device with its index."""
    import torch

    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def fingerprint_device(device=None):
    """The device an identity is computed for: ``device``, else the
    current CUDA device, else the CPU.  Nothing runs there: this only
    names the environment a key belongs to."""
    import torch

    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_ENV_CACHE: dict = {}


def environment_fingerprint(device=None):
    """Runtime identity of ``device`` (default: :func:`fingerprint_device`):
    platform, device name, compute capability and the dtype policy —
    variants that legitimately coexist in one bank, never grounds for
    gc."""
    import torch

    d = fingerprint_device(device)
    name = device_name(d)
    if name not in _ENV_CACHE:
        if d.type == "cuda":
            _ENV_CACHE[name] = {
                "platform": "cuda", "device": name,
                "device_kind": torch.cuda.get_device_name(d),
                "capability": list(torch.cuda.get_device_capability(d))}
        else:
            _ENV_CACHE[name] = {"platform": d.type, "device": name,
                                "device_kind": d.type, "capability": None}
    return dict(_ENV_CACHE[name], dtype=config.get("DTYPE") or "derived")


class ArgSpec(NamedTuple):
    """The shape and dtype of an input that is not materialised (the
    padded design rows of a bucket program)."""

    shape: tuple
    dtype: str


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def input_signature(args):
    """Canonical signature of a program's inputs, in place of the
    reference's avals: ``(structure, leaves)``, the nesting of dicts /
    lists / tuples with ``*`` for each leaf, and per leaf its shape and
    dtype (tensors, numpy arrays, :class:`ArgSpec`; a scalar by its
    type).  The device is not part of it: the environment is."""
    leaves = []

    def walk(o):
        if isinstance(o, dict):
            return "{" + ",".join(f"{k}:{walk(o[k])}"
                                  for k in sorted(o, key=str)) + "}"
        if isinstance(o, (list, tuple)) and not isinstance(o, ArgSpec):
            return "[" + ",".join(walk(v) for v in o) + "]"
        shape = getattr(o, "shape", None)
        dtype = getattr(o, "dtype", None)
        if shape is not None and dtype is not None:
            leaves.append((str(tuple(int(n) for n in shape)),
                           _dtype_name(dtype)))
        else:
            leaves.append(("()", type(o).__name__))
        return "*"

    structure = walk(args)
    return structure, tuple(leaves)


def mesh_key(mesh):
    """A mesh's identity in a memo key: axis names, shape, devices."""
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            tuple(device_name(d) for d in mesh.devices.flat))


def entry_key(kind, memo_key, args, device=None):
    """(hash, metadata) for one bank entry.  The hash covers every
    validity condition, so a lookup is a pure existence check."""
    ver = version_fingerprint()
    env = environment_fingerprint(device)
    structure, sig = input_signature(args)
    ident = repr((BANK_FORMAT, kind, memo_key, structure, sig,
                  sorted(ver.items()), sorted(env.items())))
    key = hashlib.sha256(ident.encode()).hexdigest()[:24]
    meta = {
        "format": BANK_FORMAT,
        "kind": kind,
        "key": key,
        "memo_key": repr(memo_key),
        "structure": structure,
        "inputs": [list(a) for a in sig],
        "version": ver,
        "environment": env,
    }
    return key, meta


def _meta_path(key):
    return os.path.join(bank_dir(), key + _META_SUFFIX)


def _payload_path(meta):
    name = (meta or {}).get("payload")
    if not isinstance(name, str) or os.sep in name or not name:
        return None
    return os.path.join(payload_dir(), name)


def _atomic_write(path, data):
    """tmp write + fsync + atomic replace under a name unique to this
    process, so two processes storing one payload never write one file
    and a reader never sees a half-written one."""
    tmp = fsops.tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        fsops.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _read_json(path):
    try:
        with open(path, encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    return meta if isinstance(meta, dict) else None


# ------------------------------------------------------------ compile budget

#: the compile budget lives in :mod:`raft_tpu_torch.utils.budget`, below
#: the kernel loader that charges its nvcc runs; re-exported here
CompileBudgetError = budget.CompileBudgetError
builds = budget.builds
charge_build = budget.charge


# -------------------------------------------------------------- load/store


def peek(kind, memo_key, args, device=None):
    """The entry's sidecar when the bank holds this program, else None —
    a file check (no payload read, no counters)."""
    key, _ = entry_key(kind, memo_key, args, device)
    return read_meta(key)


def lookup(kind, memo_key, args, device=None):
    """Load the entry for (kind, memo_key, inputs, environment): check
    its payload's sha and, for a kernel library, load the bank's copy
    (:func:`raft_tpu_torch.ops.linsolve.use_library`).  Returns the
    sidecar, or None on a miss.  A corrupt or unreadable entry is
    logged, counted (``aot_bank_errors``) and treated as a miss, and so
    is one whose library differs in bytes from the one this process had
    already loaded (that one would run, not the entry's)."""
    key, _ = entry_key(kind, memo_key, args, device)
    meta_path = _meta_path(key)
    if not os.path.exists(meta_path):
        return None
    t0 = time.perf_counter()
    try:
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        path = _payload_path(meta)
        if path is None:
            raise ValueError("sidecar names no payload")
        with open(path, "rb") as f:
            buf = f.read()
        if meta.get("payload_sha256") != hashlib.sha256(buf).hexdigest():
            raise ValueError("payload sha256 mismatch (truncated or "
                             "externally modified payload)")
        if path.endswith(".so"):
            from raft_tpu_torch.ops import linsolve

            in_use = linsolve.use_library(path)
            if in_use != path and _file_sha(in_use) != meta["payload_sha256"]:
                # the process loaded another library before this lookup:
                # the entry's program is not the one that would run
                raise ValueError(f"kernel library in use ({in_use}) is not "
                                 "the entry's payload")
    except Exception as e:  # corrupt or unusable entry: miss, loudly
        metrics.counter("aot_bank_errors").inc()
        log_event("aot_error", kind=kind, key=key, error=repr(e)[:300])
        return None
    metrics.counter("aot_programs_loaded").inc()
    log_event("aot_load", kind=kind, key=key, bytes=len(buf),
              wall_s=round(time.perf_counter() - t0, 4))
    return meta


def _payload_bytes(device):
    """The payload of a program that ran on ``device``: the kernel
    library in use on a card (built with ``nvcc`` only when its file is
    absent), :data:`PLAIN_PAYLOAD` elsewhere."""
    import torch

    if torch.device(device).type != "cuda":
        return PLAIN_PAYLOAD, ".plain"
    from raft_tpu_torch.ops import linsolve

    src = linsolve.loaded_library() or linsolve.build()[0]
    with open(src, "rb") as f:
        return f.read(), ".so"


def store(kind, memo_key, args, device=None, compile_s=0.0, launches=0):
    """Store the entry of a program that just ran (best effort: a
    failure is logged and counted, never fatal).  The payload is written
    once per sha (rewritten when the file there is damaged) before its
    sidecar, so a crash between the writes leaves an orphan that
    ``verify`` and ``gc`` surface, never an entry that loads."""
    device = fingerprint_device(device)
    key, meta = entry_key(kind, memo_key, args, device)
    try:
        buf, suffix = _payload_bytes(device)
        sha = hashlib.sha256(buf).hexdigest()
        name = sha[:24] + suffix
        fsops.makedirs(payload_dir(), exist_ok=True)
        path = os.path.join(payload_dir(), name)
        if not _payload_intact(path, sha):
            _atomic_write(path, buf)
        meta.update(payload=name, payload_sha256=sha, payload_bytes=len(buf),
                    compile_s=round(float(compile_s), 3),
                    launches=int(launches), created=time.time(),
                    raft_flags={k: config.get(k)
                                for k in config.EVALUATOR_FLAGS})
        fsops.write_atomic(_meta_path(key),
                           json.dumps(meta, indent=1, sort_keys=True) + "\n")
    except Exception as e:
        metrics.counter("aot_bank_errors").inc()
        log_event("aot_error", kind=kind, key=key, error=repr(e)[:300])
        return None
    log_event("aot_store", kind=kind, key=key, bytes=len(buf),
              compile_s=round(float(compile_s), 3))
    return _meta_path(key)


def _file_sha(path):
    """sha256 hex of the file at ``path``, or None when unreadable."""
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except (OSError, TypeError):
        return None


def _payload_intact(path, sha):
    return _file_sha(path) == sha


def _on_miss(kind, key, m):
    """Account for a bank miss; under ``require`` this is where the call
    fails loudly (or, flag-controlled, goes on to build)."""
    metrics.counter("aot_bank_misses").inc()
    log_event("aot_miss", kind=kind, key=key, mode=m)
    if m == "require" and config.get("AOT_MISS") == "error":
        raise BankMissError(
            f"AOT bank miss for {kind!r} key {key} under "
            f"RAFT_TPU_AOT=require (bank: {bank_dir()}).  Warm the bank "
            "with `python -m raft_tpu_torch.aot warmup` or one "
            "RAFT_TPU_AOT=load run of this workload; set "
            "RAFT_TPU_AOT_MISS=compile to log and build instead.")


# ------------------------------------------------------------------ dispatch

_SEEN_LOCK = threading.Lock()
#: (bank directory, entry key) pairs this process has loaded or built:
#: each is checked against its bank once
_SEEN: set = set()  # raft-lint: guarded-by=_SEEN_LOCK
#: kinds whose unbankable evaluators were reported (once each)
_UNBANKABLE: set = set()  # raft-lint: guarded-by=_SEEN_LOCK


class _Outcome:
    __slots__ = ("loaded", "compiled")

    def __init__(self):
        self.loaded = self.compiled = False


@contextlib.contextmanager
def consult(kind, memo_key, args, device=None, bankable=True):
    """Front one run of a program with the bank: around the block that
    runs it, ``with consult(kind, memo_key, args, device) as o: ...``.

    Under ``off`` nothing is read or written.  Otherwise the first call
    per entry key in this process loads the entry (``o.loaded``) or, on
    a miss (``require`` may raise :class:`BankMissError` here, before
    the block), charges one build to the compile budget, lets the block
    run and stores the entry with the block's wall and kernel launches
    (``o.compiled``).  Later calls of the same key pass straight through
    after a set lookup."""
    out = _Outcome()
    m = mode()
    if m == "off":
        yield out
        return
    if not bankable:
        with _SEEN_LOCK:
            first = kind not in _UNBANKABLE
            _UNBANKABLE.add(kind)
        if first:
            log_event("aot_unbankable", kind=kind)
        yield out
        return
    device = fingerprint_device(device)
    key, _ = entry_key(kind, memo_key, args, device)
    seen_key = (bank_dir(), key)
    with _SEEN_LOCK:
        seen = seen_key in _SEEN
    if seen:
        yield out
        return
    if lookup(kind, memo_key, args, device) is not None:
        out.loaded = True
        with _SEEN_LOCK:
            _SEEN.add(seen_key)
        yield out
        return
    _on_miss(kind, key, m)
    charge_build("program")
    from raft_tpu_torch.ops import linsolve

    l0 = linsolve.forward_launches()
    t0 = time.perf_counter()
    yield out
    dt = time.perf_counter() - t0
    out.compiled = True
    metrics.counter("aot_programs_compiled").inc()
    store(kind, memo_key, args, device, compile_s=dt,
          launches=linsolve.forward_launches() - l0)
    with _SEEN_LOCK:
        _SEEN.add(seen_key)


def compile_or_load(fn, args, kind, memo_key=(), bankable=True, device=None):
    """Run ``fn(*args)`` through the bank (see :func:`consult`).
    Returns ``(outputs, loaded, seconds)``: whether the entry came from
    the bank, and the wall of the run with its load or build."""
    t0 = time.perf_counter()
    with consult(kind, memo_key, args, device, bankable) as o:
        res = fn(*args)
    return res, o.loaded, time.perf_counter() - t0


class BankedProgram:
    """A program fronted by the bank: ``BankedProgram(kind, memo_key,
    fn)(*args)`` runs ``fn(*args)`` under :func:`consult`, with the
    environment of ``device`` (default: the first tensor argument's).
    Under ``RAFT_TPU_AOT=off`` it is ``fn`` itself."""

    def __init__(self, kind, memo_key, fn, bankable=True, device=None):
        self._kind = kind
        self._memo_key = memo_key
        self._fn = fn
        self._bankable = bankable
        self._device = device

    def __call__(self, *args):
        if mode() == "off":
            return self._fn(*args)
        device = self._device
        if device is None:
            device = next((a.device for a in args
                           if hasattr(a, "device")), None)
        with consult(self._kind, self._memo_key, args, device,
                     self._bankable):
            return self._fn(*args)


# ------------------------------------------------------------- kernel ledger


def ledger_summary():
    """JSON-ready per-program ledger rows of this process (a fabric
    worker's status file, run records): ``key`` (the kernel entry),
    ``kind`` (``"cuda"``) and ``dispatches`` (its launches), for every
    entry of the solve kernel that launched at least once (none when
    the solve module was never imported: nothing launched)."""
    linsolve = sys.modules.get("raft_tpu_torch.ops.linsolve")
    if linsolve is None:
        return []
    return [{"key": key, "kind": "cuda", "dispatches": int(n)}
            for key, n in sorted(linsolve.launch_ledger().items()) if n]


def merge_ledgers(row_lists):
    """Fold several :func:`ledger_summary` row lists (every fabric
    worker's published ledger) into one fleet-wide view by the
    reference's rules: dispatches and wall sum per key, the
    dispatch-weighted mean GFLOP/s recomputed where a row carries
    flops.  Garbled rows are skipped: telemetry pooling must never
    crash."""
    merged: dict[str, dict] = {}
    for rows in row_lists:
        for row in rows or ():
            try:
                key = row["key"]
                m = merged.setdefault(
                    key, {"key": key, "kind": row.get("kind"),
                          "dispatches": 0, "wall_s": 0.0})
                m["dispatches"] += int(row.get("dispatches") or 0)
                m["wall_s"] += float(row.get("wall_s") or 0.0)
                for k in ("flops", "bytes_accessed", "arg_bytes",
                          "out_bytes"):
                    if k in row:
                        m[k] = row[k]
            except (KeyError, TypeError, ValueError):
                continue
    for m in merged.values():
        flops = m.get("flops")
        if flops and m["wall_s"] > 0 and m["dispatches"]:
            m["gflops_s_mean"] = round(
                flops * m["dispatches"] / m["wall_s"] / 1e9, 6)
        m["wall_s"] = round(m["wall_s"], 4)
    return [merged[k] for k in sorted(merged)]


# ------------------------------------------------------- bank maintenance


def _is_tmp(name):
    """A leftover of an interrupted atomic write: ``<name>.tmp`` or the
    port's ``<name>.tmp.<pid>.<n>``."""
    return name.endswith(".tmp") or ".tmp." in name


def stray_tmp_files():
    """Leftover tmp files of interrupted writes in the bank directory
    and its payload directory: never valid, invisible to :func:`scan`'s
    pairing — ``verify`` notes them, ``gc`` removes them."""
    out = []
    for d in (bank_dir(), payload_dir()):
        if os.path.isdir(d):
            out += [os.path.join(d, n) for n in sorted(os.listdir(d))
                    if _is_tmp(n)]
    return out


def _payload_files():
    d = payload_dir()
    if not os.path.isdir(d):
        return []
    return sorted(n for n in os.listdir(d)
                  if n.endswith(_PAYLOAD_SUFFIXES) and not _is_tmp(n))


def scan():
    """Yield ``(key, meta | None, meta_path, payload_path | None)`` for
    every entry of the port's bank directory, then ``(name, None, None,
    path)`` for every payload no sidecar names (an orphan).  ``meta`` is
    None when the sidecar is unparseable."""
    d = bank_dir()
    if not os.path.isdir(d):
        return
    used = set()
    for n in sorted(os.listdir(d)):
        if not n.endswith(_META_SUFFIX) or _is_tmp(n):
            continue
        key = n[:-len(_META_SUFFIX)]
        meta_path = os.path.join(d, n)
        meta = _read_json(meta_path)
        path = _payload_path(meta)
        if path is not None:
            used.add(os.path.basename(path))
        yield key, meta, meta_path, path
    for n in _payload_files():
        if n not in used:
            yield n, None, None, os.path.join(payload_dir(), n)


def read_meta(key):
    """One entry's sidecar by bank key — or None when the entry (or its
    payload) is missing or unparseable.  No torch: the release
    machinery resolves manifest entries through this."""
    meta = _read_json(_meta_path(key))
    path = _payload_path(meta)
    if meta is None or path is None or not os.path.exists(path):
        return None
    return meta


def is_stale(meta):
    """True when an entry's version fingerprint no longer matches the
    running toolchain and sources (it can never be loaded again)."""
    return meta is None or meta.get("version") != version_fingerprint()


def verify_bank():
    """Integrity check of the port's bank directory (the ``verify``
    CLI).  Returns ``(problems, notes, n_entries)``: ``problems`` are
    failures (unparseable sidecars, missing, orphaned, truncated or
    altered payloads); ``notes`` are benign (stale entries awaiting gc,
    writes in progress)."""
    problems, notes = [], []
    n = 0
    checked = {}
    for key, meta, meta_path, path in scan():
        n += 1
        if meta_path is None:
            problems.append(f"{key}: orphan payload (no sidecar names it "
                            "— interrupted store; gc removes it)")
            continue
        if meta is None:
            problems.append(f"{key}: metadata sidecar unparseable")
            continue
        if path is None or not os.path.exists(path):
            problems.append(f"{key}: metadata without payload "
                            f"({meta.get('payload')} missing)")
            continue
        size = os.path.getsize(path)
        if size != meta.get("payload_bytes"):
            problems.append(
                f"{key}: payload is {size} bytes, metadata promises "
                f"{meta.get('payload_bytes')} (truncated write?)")
            continue
        if path not in checked:
            with open(path, "rb") as f:
                checked[path] = hashlib.sha256(f.read()).hexdigest()
        if checked[path] != meta.get("payload_sha256"):
            problems.append(f"{key}: payload sha256 mismatch")
            continue
        if is_stale(meta):
            got = meta.get("version") or {}
            notes.append(
                f"{key}: stale ({meta.get('kind')}; torch "
                f"{got.get('torch')}, code {got.get('code')}) — never "
                "loaded by this toolchain; `gc` reclaims it")
    for tmp in stray_tmp_files():
        # a tmp may also be another process mid-store: a note
        notes.append(f"{os.path.basename(tmp)}: interrupted write "
                     "(or a store in progress); `gc` reclaims it")
    return problems, notes, n


def gc_bank(max_age_days=None, remove_all=False, dry_run=False):
    """Remove dead entries of the port's bank: stale version
    fingerprints, unparseable sidecars, sidecars without a payload,
    orphan payloads, tmp leftovers and (optionally) anything older than
    ``max_age_days``.  Foreign *environment* variants (another card,
    the CPU) are kept: they are live entries for other processes.
    Nothing outside ``torch-v<format>/`` is touched.  Returns a summary
    dict."""
    removed, kept, freed = [], 0, 0
    now = time.time()
    live_payloads = set()
    rows = list(scan())

    dropped = set()

    def drop(path):
        nonlocal freed
        if path and path not in dropped and os.path.exists(path):
            dropped.add(path)
            freed += os.path.getsize(path)
            if not dry_run:
                os.remove(path)

    for key, meta, meta_path, path in rows:
        if meta_path is None:
            continue   # orphans go after the sidecars are judged
        dead = (remove_all or is_stale(meta) or path is None
                or not os.path.exists(path))
        if (not dead and max_age_days is not None
                and now - (meta.get("created") or 0) > max_age_days * 86400):
            dead = True
        if not dead:
            kept += 1
            live_payloads.add(path)
            continue
        drop(meta_path)
        removed.append(key)
    for key, meta, meta_path, path in rows:
        if path and path not in live_payloads and path not in dropped \
                and os.path.exists(path):
            drop(path)
            if meta_path is None:
                removed.append(key)
    for tmp in stray_tmp_files():
        with contextlib.suppress(OSError):
            drop(tmp)
            removed.append(os.path.basename(tmp))
    summary = dict(removed=len(removed), kept=kept, bytes_freed=freed,
                   dry_run=bool(dry_run))
    log_event("aot_gc", **summary)
    return summary


# ------------------------------------------------------- program identity


def content_fingerprint(obj):
    """Deterministic 16-hex hash of a nested plain-data structure
    (dicts, lists / tuples, scalars, strings, numpy arrays, torch
    tensors).

    Scalars hash by their ``repr``, arrays by dtype, shape and raw
    bytes (an object array by its ``tolist()``, never its pointers),
    dicts in ``repr``-sorted key order.  Any other object that numpy
    coerces to a non-object array hashes as that array; anything else
    by its type alone."""
    import numpy as np
    import torch

    h = hashlib.sha256()

    def walk(o):
        if o is None or isinstance(o, (bool, int, float, complex,
                                       str, bytes)):
            h.update(repr(o).encode())
        elif isinstance(o, torch.Tensor):
            walk(o.detach().cpu().numpy())
        elif isinstance(o, np.ndarray):
            if o.dtype == object:
                walk(o.tolist())
            else:
                h.update(str((o.dtype, o.shape)).encode())
                h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, np.generic):
            h.update(repr(o.item()).encode())
        elif isinstance(o, dict):
            h.update(b"{")
            for k in sorted(o, key=repr):
                walk(k)
                walk(o[k])
            h.update(b"}")
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for v in o:
                walk(v)
            h.update(b"]")
        else:
            try:
                arr = np.asarray(o)
            except Exception:
                arr = None
            if arr is not None and arr.dtype != object:
                walk(arr)
            else:
                h.update(repr(type(o)).encode())

    walk(obj)
    return h.hexdigest()[:16]
