"""Custom AST linter for the port's hot-path hygiene (counterpart of
``raft_tpu/analysis/lint.py``).

Each rule targets a bug class of the eager torch hot path:

``dtype-literal``
    Hard-coded 64-bit dtype literals in the traced modules
    (:data:`TRACED_MODULES`): ``dtype=torch.float64`` /
    ``torch.complex128`` (or ``.double`` / ``.cdouble``) as a dtype
    argument, ``.to(torch.float64)``, ``.double()`` / ``.cdouble()``.
    Such a literal turns a float32 pipeline into a float64 one whatever
    ``RAFT_TPU_DTYPE`` says: derive the pair from the inputs or the
    policy with :func:`raft_tpu_torch.utils.dtypes.compute_dtypes`.
    Anywhere in the package, ``dtype=complex`` is flagged: its width is
    ambiguous (write ``np.complex128`` where double precision is the
    audited host-side intent).

``host-coercion``
    ``float()`` / ``int()`` / ``bool()`` / ``complex()`` /
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``np.asarray()`` of a value that dataflows from a ``torch``
    expression inside the same function, in the traced modules only.
    On a CUDA tensor each is a device-to-host copy that waits for every
    queued kernel: the launch queue drains and the card idles while the
    host decides.  Shape, size and dtype metadata are exempt.  The drag
    fixed point's one stop test per ``RAFT_TPU_SCAN_CHUNK`` trips is
    the audited exception, suppressed on its line with its reason.

``env-read``
    Raw ``os.environ`` / ``os.getenv`` reads of ``RAFT_TPU_*`` names
    outside the registry (:mod:`raft_tpu_torch.utils.config`):
    unregistered reads are how flag typos fail silently.

``event-name``
    ``log_event("<name>", ...)`` with a literal name not registered in
    :mod:`raft_tpu_torch.obs.events` ``EVENTS``: a typo'd name splits
    the event stream in two for every consumer.

``span-name``
    ``span("<name>", ...)`` with a literal name not registered in
    ``SPANS`` of :mod:`raft_tpu_torch.obs.events`: a typo'd name forks
    the wall-time tree and mints a ``span_<name>_s`` histogram nobody
    reads.

``registered-unused`` (whole-scan audit, not a per-file rule)
    Events or spans that nothing emits, flags that nothing reads, and
    flags missing from the README's flag tables.  Runs when the CLI
    lints the default scan set; see :func:`registered_unused`.

The reference's ``jit-static`` rule is not ported: an eager port has
no jit call site and no static argument to declare.

Suppression: append ``# raft-lint: disable=<rule>[,<rule>]`` to the
offending line (or put it alone on the line above); a file-level
``# raft-lint: disable-file=<rule>`` comment disables a rule for the
whole file.  Suppressing ``all`` disables every rule.

Pure stdlib ``ast``: it imports neither torch nor jax.  Run ``python
-m raft_tpu_torch.analysis lint``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

RULES = {
    "dtype-literal": "hard-coded complex/float64 dtype literal",
    "host-coercion": "host-Python coercion of a tensor in a traced module",
    "env-read": "raw RAFT_TPU_* env read outside raft_tpu_torch.utils.config",
    "event-name": "log_event() with an unregistered event name",
    "span-name": "obs.span() with an unregistered span name",
}

_EVENT_NAMES = None
_SPAN_NAMES = None


def _event_names():
    """Registered event names (lazy: :mod:`raft_tpu_torch.obs.events` is
    pure stdlib).  An unloadable registry disables the rule rather than
    flagging everything."""
    global _EVENT_NAMES
    if _EVENT_NAMES is None:
        try:
            from raft_tpu_torch.obs.events import EVENTS

            _EVENT_NAMES = frozenset(EVENTS)
        except Exception:
            _EVENT_NAMES = frozenset()
    return _EVENT_NAMES


def _span_names():
    """Registered span names (same lazy, fail-open contract as
    :func:`_event_names`)."""
    global _SPAN_NAMES
    if _SPAN_NAMES is None:
        try:
            from raft_tpu_torch.obs.events import SPANS

            _SPAN_NAMES = frozenset(SPANS)
        except Exception:
            _SPAN_NAMES = frozenset()
    return _SPAN_NAMES


#: the modules of the device hot path: host-coercion and the torch
#: 64-bit dtype literals apply here.  Host-orchestration modules (the
#: builder, drivers, outputs, plotting, the orchestrated path of
#: models/model.py) pull results to numpy on purpose.  Paths are
#: repo-relative '/'-separated prefixes.
TRACED_MODULES = (
    "raft_tpu_torch/ops/",
    "raft_tpu_torch/models/dynamics.py",
    "raft_tpu_torch/physics/morison.py",
    "raft_tpu_torch/api.py",
    "raft_tpu_torch/structure/members_traced.py",
    "raft_tpu_torch/structure/topology_traced.py",
)

_SUPPRESS_RE = re.compile(
    r"#\s*raft-lint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[a-z\-,\s]+)")

#: torch dtype attributes that pin a 64-bit width
_BAD_TORCH_DTYPES = ("float64", "double", "complex128", "cdouble")
#: tensor methods that convert to a 64-bit width
_BAD_CAST_METHODS = ("double", "cdouble")
#: tensor methods that pull a value to the host
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self):
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def _attr_root(node):
    """Leftmost name of a dotted expression ('torch' for torch.zeros,
    'np' for np.ctypeslib.ndpointer), or None."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_np_root(root):
    return root in ("np", "numpy")


class _Suppressions:
    """Per-file suppression table parsed from comments."""

    def __init__(self, source):
        self.by_line = {}
        self.file_level = set()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
            if m.group("file"):
                self.file_level |= rules
            else:
                self.by_line.setdefault(i, set()).update(rules)
                # a standalone suppression comment covers the next line
                if text.lstrip().startswith("#"):
                    self.by_line.setdefault(i + 1, set()).update(rules)

    def active(self, rule, line):
        for scope in (self.file_level, self.by_line.get(line, ())):
            if rule in scope or "all" in scope:
                return True
        return False


class _TaintScope:
    """Names in the current function known to flow from torch
    expressions."""

    def __init__(self, parent=None):
        self.names = set(parent.names) if parent else set()

    def expr_tainted(self, node):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and (
                    sub.id in self.names or sub.id == "torch"):
                return True
        return False


def _coercion_arg_is_hostlike(node):
    """Shape/size/len() accesses are host metadata even on a CUDA
    tensor: coercing them is free."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "dtype", "device", "is_cuda"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in ("size", "dim", "numel", "element_size"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "len":
            return True
    return False


def _is_64bit_torch_dtype(node):
    return isinstance(node, ast.Attribute) \
        and node.attr in _BAD_TORCH_DTYPES and _attr_root(node) == "torch"


class _Linter(ast.NodeVisitor):
    def __init__(self, path, display_path, source, rules, traced=True):
        self.path = path
        self.display = display_path
        self.rules = rules
        #: a traced module: the torch 64-bit literals are flagged too
        self.traced = traced
        self.suppress = _Suppressions(source)
        self.findings = []
        self.scopes = [_TaintScope()]
        self.visit(ast.parse(source, filename=path))

    # ------------------------------------------------------------- helpers

    def _emit(self, rule, node, message):
        if rule not in self.rules:
            return
        if self.suppress.active(rule, node.lineno):
            return
        self.findings.append(Finding(
            self.display, node.lineno, node.col_offset + 1, rule, message))

    # ------------------------------------------------------------- scoping

    def visit_FunctionDef(self, node):
        self.scopes.append(_TaintScope(self.scopes[-1]))
        self.generic_visit(node)
        self.scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Assign(self, node):
        if self.scopes[-1].expr_tainted(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.scopes[-1].names.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for e in t.elts:
                        if isinstance(e, ast.Name):
                            self.scopes[-1].names.add(e.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name) and \
                self.scopes[-1].expr_tainted(node.value):
            self.scopes[-1].names.add(node.target.id)
        self.generic_visit(node)

    # --------------------------------------------------------------- rules

    def visit_Call(self, node):
        self._check_dtype_literal(node)
        self._check_host_coercion(node)
        self._check_env_read(node)
        self._check_event_name(node)
        self._check_span_name(node)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # os.environ["RAFT_TPU_X"]
        if isinstance(node.value, ast.Attribute) \
                and node.value.attr == "environ" \
                and _attr_root(node.value) == "os":
            key = node.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str) \
                    and key.value.startswith("RAFT_TPU_"):
                self._emit("env-read", node,
                           f"os.environ[{key.value!r}] outside the flag "
                           "registry; use raft_tpu_torch.utils.config")
        self.generic_visit(node)

    # positional index of the dtype arg on numpy's constructors, so
    # `np.zeros((6, nw), complex)` is caught as well as the kwarg form
    _DTYPE_ARG_POS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
                      "asarray": 1, "array": 1}

    def _check_dtype_literal(self, node):
        values = [kw.value for kw in node.keywords if kw.arg == "dtype"]
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            # x.astype(complex) / x.to(torch.float64) / x.type(...)
            if attr in ("astype", "to", "type") and node.args:
                values.extend(node.args[:2] if attr == "to"
                              else node.args[:1])
            pos = self._DTYPE_ARG_POS.get(attr)
            if pos is not None and len(node.args) > pos \
                    and _is_np_root(_attr_root(node.func)):
                values.append(node.args[pos])
            if self.traced and attr in _BAD_CAST_METHODS \
                    and not node.args and not node.keywords:
                self._emit(
                    "dtype-literal", node,
                    f".{attr}() pins a 64-bit width in a traced module; "
                    "derive the dtype from the inputs or the "
                    "RAFT_TPU_DTYPE policy "
                    "(raft_tpu_torch.utils.dtypes.compute_dtypes)")
        for v in values:
            if isinstance(v, ast.Name) and v.id == "complex":
                self._emit(
                    "dtype-literal", v,
                    "bare `complex` dtype has an ambiguous width; derive "
                    "it from the inputs via "
                    "raft_tpu_torch.utils.dtypes.compute_dtypes, or write "
                    "np.complex128 for audited host-side precision")
            elif self.traced and _is_64bit_torch_dtype(v):
                self._emit(
                    "dtype-literal", v,
                    f"hard-coded dtype torch.{v.attr} in a traced module "
                    "pins a 64-bit width; derive it from the inputs or the "
                    "RAFT_TPU_DTYPE policy "
                    "(raft_tpu_torch.utils.dtypes.compute_dtypes)")

    def _check_host_coercion(self, node):
        scope = self.scopes[-1]
        # float(x) / int(x) / bool(x) / complex(x)
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool", "complex") \
                and len(node.args) == 1:
            arg = node.args[0]
            if scope.expr_tainted(arg) and not _coercion_arg_is_hostlike(arg):
                self._emit(
                    "host-coercion", node,
                    f"{node.func.id}() of a tensor waits for the device "
                    "(a host sync in the hot path); keep it a tensor op "
                    "(torch.where / masks)")
        # x.item() / x.tolist() / x.cpu() / x.numpy()
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_METHODS and not node.args:
            if scope.expr_tainted(node.func.value) \
                    and not _coercion_arg_is_hostlike(node.func.value):
                self._emit(
                    "host-coercion", node,
                    f".{node.func.attr}() of a tensor is a device-to-host "
                    "copy inside the hot path (it drains the launch "
                    "queue)")
        # np.asarray(x) / np.array(x) on a tensor
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("asarray", "array") \
                and _is_np_root(_attr_root(node.func)) and node.args:
            arg = node.args[0]
            if scope.expr_tainted(arg) and not _coercion_arg_is_hostlike(arg):
                self._emit(
                    "host-coercion", node,
                    "np.asarray/np.array of a tensor pulls it to the host "
                    "(a sync); keep it on the device or move the pull out "
                    "of the hot path")

    def _check_env_read(self, node):
        if not isinstance(node.func, ast.Attribute):
            return
        is_environ_get = (node.func.attr in ("get", "setdefault")
                          and isinstance(node.func.value, ast.Attribute)
                          and node.func.value.attr == "environ"
                          and _attr_root(node.func.value) == "os")
        is_getenv = (node.func.attr == "getenv"
                     and _attr_root(node.func) == "os")
        if not (is_environ_get or is_getenv) or not node.args:
            return
        key = node.args[0]
        if isinstance(key, ast.Constant) and isinstance(key.value, str) \
                and key.value.startswith("RAFT_TPU_"):
            self._emit(
                "env-read", node,
                f"raw read of {key.value!r} outside the flag registry; "
                "register it in raft_tpu_torch/utils/config.py and use "
                "config.get/config.raw")

    def _check_event_name(self, node):
        # log_event("name", ...) / structlog.log_event("name", ...);
        # dynamic first args are not checkable
        fn = node.func
        is_log_event = ((isinstance(fn, ast.Name) and fn.id == "log_event")
                        or (isinstance(fn, ast.Attribute)
                            and fn.attr == "log_event"))
        if not is_log_event or not node.args:
            return
        name = node.args[0]
        if not (isinstance(name, ast.Constant)
                and isinstance(name.value, str)):
            return
        registry = _event_names()
        if registry and name.value not in registry:
            self._emit(
                "event-name", node,
                f"log_event({name.value!r}): event name not registered "
                "in raft_tpu_torch/obs/events.py — a typo'd name silently "
                "splits the event stream for every consumer")

    def _check_span_name(self, node):
        # span("name", ...) / obs.span("name", ...) / spans.span(...);
        # dynamic first args are not checkable
        fn = node.func
        is_span = ((isinstance(fn, ast.Name) and fn.id == "span")
                   or (isinstance(fn, ast.Attribute) and fn.attr == "span"
                       and _attr_root(fn) in ("obs", "spans")))
        if not is_span or not node.args:
            return
        name = node.args[0]
        if not (isinstance(name, ast.Constant)
                and isinstance(name.value, str)):
            return
        registry = _span_names()
        if registry and name.value not in registry:
            self._emit(
                "span-name", node,
                f"span({name.value!r}): span name not registered in the "
                "SPANS table of raft_tpu_torch/obs/events.py — a typo'd "
                "name silently forks the wall-time tree for every consumer")


# ----------------------------------------------------------------- driver

def repo_root():
    """The repository root (two levels above this package)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_paths(root=None):
    """The default lint scan set: every module of the
    ``raft_tpu_torch`` package."""
    root = root or repo_root()
    paths = []
    pkg = os.path.join(root, "raft_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                paths.append(os.path.join(dirpath, fn))
    return paths


def _in_traced(display_path):
    norm = display_path.replace(os.sep, "/")
    return any(norm.startswith(p) or norm.endswith(p)
               for p in TRACED_MODULES)


def _rules_for(display_path):
    """Rule set by file role: the registry itself is exempt from
    env-read (it IS the sanctioned reader), and host-coercion only
    applies to the traced modules."""
    rules = set(RULES)
    if display_path.replace(os.sep, "/").endswith(
            "raft_tpu_torch/utils/config.py"):
        rules.discard("env-read")
    if not _in_traced(display_path):
        rules.discard("host-coercion")
    return rules


def lint_file(path, display_path=None, source=None, rules=None):
    """Lint one file; returns a list of :class:`Finding`.

    ``rules`` overrides the path-based rule selection and treats the
    file as a traced module (the fixture tests force every rule on
    regardless of location)."""
    display = display_path or os.path.relpath(path, repo_root())
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        return _Linter(path, display, source, rules or _rules_for(display),
                       traced=bool(rules) or _in_traced(display)).findings
    except SyntaxError as e:
        return [Finding(display, e.lineno or 1, (e.offset or 0) + 1,
                        "syntax", f"cannot parse: {e.msg}")]


def lint_paths(paths=None, root=None):
    """Lint many files (default: :func:`default_paths`); directory
    paths are walked for ``*.py``; findings are sorted by path/line for
    stable CI output."""
    expanded = []
    for p in (paths or default_paths(root)):
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                expanded += [os.path.join(dirpath, fn)
                             for fn in sorted(filenames)
                             if fn.endswith(".py")]
        else:
            expanded.append(p)
    findings = []
    for p in expanded:
        findings.extend(lint_file(p))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ----------------------------------------------- registered-unused audit


class _UsageCollector(ast.NodeVisitor):
    """Literal usages of registered names across one file: event names
    (``log_event("x", ...)`` and ``{"event": "x"}`` dict records), span
    names (``span("x", ...)``), and flag names (``config.get/raw/
    env_name("X")``)."""

    def __init__(self):
        self.events = set()
        self.spans = set()
        self.flags = set()

    @staticmethod
    def _str_arg(node):
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value
        return None

    def visit_Call(self, node):
        fn = node.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None)
        arg = self._str_arg(node)
        if arg is not None:
            if name == "log_event":
                self.events.add(arg)
            elif name == "span":
                self.spans.add(arg)
            elif name in ("get", "raw", "env_name") \
                    and isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "config":
                # receiver-checked: `anydict.get("X")` must not mark a
                # flag as read — only the registry module's accessors do
                self.flags.add(arg)
        self.generic_visit(node)

    def visit_Dict(self, node):
        # hand-built records ({"event": "proc_start", ...}) emit events
        # without going through log_event (the structlog clock anchor)
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and k.value == "event" \
                    and isinstance(v, ast.Constant) \
                    and isinstance(v.value, str):
                self.events.add(v.value)
        self.generic_visit(node)


def _registration_line(lines, needle):
    """1-based line of the first occurrence of ``needle`` in ``lines``
    (where a dead-entry finding points)."""
    for i, text in enumerate(lines, start=1):
        if needle in text:
            return i
    return 1


def _source_lines(path):
    try:
        with open(path, encoding="utf-8") as f:
            return f.read().splitlines()
    except OSError:
        return []


def registered_unused(root=None):
    """Dead-entry audit over the full scan set: events and spans of
    :mod:`raft_tpu_torch.obs.events` that no scanned file emits, flags
    of :mod:`raft_tpu_torch.utils.config` that nothing reads, and flags
    missing from the README.  Returns :class:`Finding` rows anchored at
    the dead registration.  Only meaningful over the default scan set:
    a partial path list would flag everything."""
    root = root or repo_root()
    used = _UsageCollector()
    for p in default_paths(root):
        try:
            with open(p, encoding="utf-8") as f:
                used.visit(ast.parse(f.read(), filename=p))
        except (OSError, SyntaxError):
            continue
    findings = []
    events_disp = "raft_tpu_torch/obs/events.py"
    events_lines = _source_lines(os.path.join(root, events_disp))
    try:
        from raft_tpu_torch.obs.events import EVENTS, SPANS
    except Exception:
        EVENTS, SPANS = {}, {}
    for name in sorted(set(EVENTS) - used.events):
        findings.append(Finding(
            events_disp, _registration_line(events_lines, f'"{name}"'), 1,
            "registered-unused",
            f"event {name!r} is registered but no scanned file ever "
            "emits it — emit it or prune the registration"))
    for name in sorted(set(SPANS) - used.spans):
        findings.append(Finding(
            events_disp, _registration_line(events_lines, f'"{name}"'), 1,
            "registered-unused",
            f"span {name!r} is registered in SPANS but no scanned file "
            "ever opens it — open it or prune the registration"))
    config_disp = "raft_tpu_torch/utils/config.py"
    config_lines = _source_lines(os.path.join(root, config_disp))
    try:
        from raft_tpu_torch.utils.config import FLAGS
    except Exception:
        FLAGS = {}
    readme = "\n".join(_source_lines(os.path.join(root, "README.md")))
    for name in sorted(FLAGS):
        if name not in used.flags:
            findings.append(Finding(
                config_disp,
                _registration_line(config_lines, f'Flag("{name}"'), 1,
                "registered-unused",
                f"flag RAFT_TPU_{name} is registered but nothing reads "
                "it (config.get/raw/env_name) — read it or prune the "
                "registration"))
        if readme and f"RAFT_TPU_{name}" not in readme:
            findings.append(Finding(
                config_disp,
                _registration_line(config_lines, f'Flag("{name}"'), 1,
                "registered-unused",
                f"flag RAFT_TPU_{name} is registered but undocumented "
                "in README.md — every knob must appear in a flag table"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
