"""Concurrency-invariant analyzer for the port's multi-process runtime
(counterpart of ``raft_tpu/analysis/concurrency.py``).

The port's sweep fabric, run records, program bank and serving fleet
are cooperating processes and daemon threads whose correctness hangs on
hand-maintained idioms: every ledger/run-store/bank mutation must be
an atomic filesystem operation, the serve event loop must never block,
the shared registries are only safe under their locks, and every
background thread needs a shutdown path.  None of those invariants crash when violated — they corrupt
concurrent readers, stall the event loop, or tear a dict under a racing
thread, usually only under load.  This module makes them lintable.

Four rules, applied to the declared shared-state modules
(:data:`SHARED_STATE_MODULES`; ``async-blocking`` scans the
:data:`ASYNC_MODULES` event-loop code):

``atomic-write``
    A write-mode ``open()`` / ``os.fdopen()`` / ``np.save*`` landing in
    a ledger/out-dir/store path without the atomic idioms the
    checkpoint layer trusts: tmp + ``os.replace`` (the enclosing
    function must perform the replace), an ``O_CREAT|O_EXCL`` claim, or
    delegation to a sanctioned atomic writer
    (:data:`SANCTIONED_WRITERS`).  A torn plain write is silent data
    loss for every concurrent reader (``runs list``/``regress``,
    fabric lease scans, bank loads).  Append-mode sinks (worker logs,
    the structlog JSONL stream) are exempt: appends of one line are the
    audited exception.

``async-blocking``
    A blocking operation reachable from an ``async def`` in the serve
    event loop: ``time.sleep``, blocking file IO (``open``/
    ``os.fdopen``), ``subprocess``, ``Future.result()`` /
    ``Thread.join()``, or a lock ``.acquire()`` without a timeout.
    The check is taint-based: a package-internal call graph is built
    over the whole scan set and blocking-ness propagates through sync
    helpers, so ``shutdown() -> metrics.export() -> open()`` is caught
    even though ``shutdown`` itself never names ``open``.  Calls
    handed to ``run_in_executor`` (as arguments, not performed) are
    naturally exempt; :mod:`raft_tpu_torch.utils.structlog` is allowlisted
    (bounded single-line append+flush under a lock — the audited
    telemetry exception, see :data:`NONBLOCKING_MODULES`).

``lock-discipline``
    A mutation of declared lock-guarded state lexically outside a
    ``with <lock>:`` block.  State declares its lock inline::

        _REGISTRY = {}  # raft-lint: guarded-by=_REGISTRY_LOCK
        self._entries = OrderedDict()  # raft-lint: guarded-by=self._lock

    and every assignment / augmented assignment / item-write / mutating
    method call (``append``/``pop``/``update``/...) on that name must
    then sit inside ``with <that lock>:``.  The annotation's own
    function (the constructor) and module-level initial bindings are
    exempt — state is not shared before it exists.  Reads are not
    checked (the registries deliberately allow brief stale reads).

``thread-hygiene``
    Every ``threading.Thread`` must be ``daemon=True`` (a forgotten
    non-daemon sampler wedges interpreter shutdown), carry a ``name``
    (an anonymous ``Thread-3`` in a hang dump is useless), and have a
    stop/join path: a ``Thread`` subclass must define a ``stop``/
    ``close``/``shutdown`` method that ``join``\\ s, and a plain
    ``Thread(target=...)`` construction must have a ``.join(`` call on
    its binding somewhere in the module.

Suppression uses the shared ``# raft-lint: disable=<rule>`` syntax
(:mod:`raft_tpu_torch.analysis.lint`).  Pure stdlib ``ast``: it imports
neither torch nor jax.  Run ``python -m raft_tpu_torch.analysis
concurrency``.
"""

from __future__ import annotations

import ast
import os
import re

from raft_tpu_torch.analysis.lint import (Finding, _Suppressions,
                                          _attr_root, default_paths,
                                          repo_root)

RULES = {
    "atomic-write": "non-atomic write into a shared ledger/store path",
    "async-blocking": "blocking call reachable from the serve event loop",
    "lock-discipline": "guarded state mutated outside its lock",
    "thread-hygiene": "thread without daemon/name/stop-join hygiene",
}

#: modules whose on-disk state is read concurrently by other processes
#: (ledgers, stores, banks) or mutated by daemon threads (registries,
#: sinks): atomic-write + lock-discipline + thread-hygiene apply here.
#: Paths are repo-relative '/'-separated prefixes, like
#: ``lint.TRACED_MODULES``.
SHARED_STATE_MODULES = (
    "raft_tpu_torch/parallel/fabric.py",
    "raft_tpu_torch/parallel/freq.py",
    "raft_tpu_torch/parallel/resilience.py",
    "raft_tpu_torch/parallel/sweep.py",
    "raft_tpu_torch/obs/runs.py",
    "raft_tpu_torch/obs/metrics.py",
    "raft_tpu_torch/obs/heartbeat.py",
    "raft_tpu_torch/obs/alerts.py",
    "raft_tpu_torch/aot/bank.py",
    "raft_tpu_torch/serve/",
    "raft_tpu_torch/utils/structlog.py",
)

#: modules whose ``async def`` functions run on the serve event loop
ASYNC_MODULES = ("raft_tpu_torch/serve/",)

#: atomic-writer helpers: a write op inside an argument to (or the body
#: of) one of these is the sanctioned idiom, not a finding
SANCTIONED_WRITERS = frozenset(
    {"_atomic_write", "_atomic_json", "atomic_savez"})

#: modules whose functions are never treated as blocking for the
#: async-blocking taint: structlog's sink is a bounded single-line
#: append+flush under a lock (and the lazy sink open happens once) —
#: the audited telemetry exception every async handler relies on.
NONBLOCKING_MODULES = ("raft_tpu_torch/utils/structlog.py",)

#: method names that mutate their receiver (dict/list/set/deque/
#: OrderedDict) for the lock-discipline rule
_MUTATORS = frozenset({
    "append", "appendleft", "add", "clear", "extend", "insert",
    "pop", "popitem", "popleft", "remove", "discard", "update",
    "setdefault", "sort", "move_to_end",
})

_GUARD_RE = re.compile(
    r"#\s*raft-lint:\s*guarded-by\s*=\s*(?P<lock>[A-Za-z_][\w.]*)")


def _unparse(node):
    try:
        return ast.unparse(node).strip()
    except Exception:  # very old ast nodes / synthetic trees
        return ""


def _in_modules(display_path, prefixes):
    norm = display_path.replace(os.sep, "/")
    return any(norm.startswith(p) or norm.endswith(p) for p in prefixes)


# ===================================================================== files


class _Func:
    """One function's concurrency-relevant facts (call graph node)."""

    __slots__ = ("module", "qualname", "node", "is_async", "lineno",
                 "calls", "primitives")

    def __init__(self, module, qualname, node):
        self.module = module
        self.qualname = qualname
        self.node = node
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        self.lineno = node.lineno
        #: [(lineno, target)] where target is ``(module, name)`` for a
        #: resolved package function, else None (unresolvable)
        self.calls = []
        #: [(lineno, description)] of directly-blocking operations
        self.primitives = []


class _ModuleInfo:
    """Parsed view of one file: functions, imports, classes, guards."""

    def __init__(self, path, display, source):
        self.path = path
        self.display = display.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppress = _Suppressions(source)
        #: alias -> module display path ("metrics" -> ".../metrics.py")
        self.module_aliases = {}
        #: alias -> (module display path, function name)
        self.func_aliases = {}
        #: qualname -> _Func
        self.functions = {}
        #: class name -> ClassDef
        self.classes = {}
        #: guarded state: name -> lock  (module scope) and
        #: (class, attr) -> lock  (instance scope)
        self.module_guards = {}
        self.instance_guards = {}
        self._collect_imports()
        self._collect_functions()
        _parse_guards(self)  # guarded-by annotations (lock-discipline)

    # ------------------------------------------------------------- imports

    @staticmethod
    def _module_display(dotted):
        if not dotted.startswith("raft_tpu_torch"):
            return None
        return dotted.replace(".", "/") + ".py"

    def _collect_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    disp = self._module_display(alias.name)
                    if disp:
                        self.module_aliases[
                            alias.asname or alias.name.split(".")[0]] = disp
            elif isinstance(node, ast.ImportFrom) and node.module:
                parent = self._module_display(node.module)
                for alias in node.names:
                    child = self._module_display(
                        node.module + "." + alias.name)
                    name = alias.asname or alias.name
                    # `from raft_tpu_torch.obs import metrics` imports a
                    # MODULE; `from ...structlog import log_event`
                    # imports a function — disambiguated later against
                    # the parsed module set (both recorded here)
                    if child:
                        self.module_aliases.setdefault(name, child)
                    if parent:
                        self.func_aliases.setdefault(name, (parent,
                                                            alias.name))

    # ----------------------------------------------------------- functions

    def _collect_functions(self):
        pending = []  # register every def first: bare-name resolution
                      # must see functions defined later in the file

        def walk(node, prefix, class_name):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = (prefix + "." if prefix else "") + child.name
                    fn = _Func(self.display, qual, child)
                    self.functions[qual] = fn
                    pending.append((fn, child, class_name))
                    walk(child, qual, class_name)
                elif isinstance(child, ast.ClassDef):
                    self.classes[child.name] = child
                    walk(child, child.name, child.name)
                else:
                    walk(child, prefix, class_name)

        walk(self.tree, "", None)
        for fn, node, class_name in pending:
            self._scan_body(fn, node, class_name)

    def _scan_body(self, fn, node, class_name):
        """Record calls + blocking primitives of ONE function body,
        without descending into nested defs/lambdas (they are separate
        scopes — passing a function is not calling it)."""
        def visit(n):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    self._record_call(fn, child, class_name)
                visit(child)

        visit(node)

    def _record_call(self, fn, call, class_name):
        f = call.func
        line = call.lineno
        prim = _blocking_primitive(call)
        if prim:
            fn.primitives.append((line, prim))
            return
        target = None
        if isinstance(f, ast.Name):
            # bare name: locally-defined function/class, else an import
            if f.id in self.functions or f.id in self.classes:
                target = (self.display, f.id)
            elif f.id in self.func_aliases:
                target = self.func_aliases[f.id]
        elif isinstance(f, ast.Attribute):
            v = f.value
            if isinstance(v, ast.Name):
                if v.id == "self" and class_name:
                    qual = f"{class_name}.{f.attr}"
                    if qual in self.functions:
                        target = (self.display, qual)
                elif v.id in self.module_aliases:
                    target = (self.module_aliases[v.id], f.attr)
        fn.calls.append((line, target))


def _blocking_primitive(call):
    """Description of a directly-blocking operation, or None.

    The event loop's own awaitables (``asyncio.sleep``, stream reads,
    executor dispatch) never match: only host-thread blockers do."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "open":
            return "open() — blocking file IO"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    root = _attr_root(f)
    if root == "time" and f.attr == "sleep":
        return "time.sleep()"
    if root == "subprocess":
        return f"subprocess.{f.attr}()"
    if root == "os" and f.attr in ("fdopen", "system", "popen"):
        return f"os.{f.attr}() — blocking file IO"
    if f.attr == "result" and not call.args and not call.keywords:
        return ".result() — blocks until the future resolves"
    if f.attr == "acquire":
        bounded = any(kw.arg == "timeout" for kw in call.keywords) or \
            len(call.args) >= 2 or (
                call.args and isinstance(call.args[0], ast.Constant)
                and call.args[0].value is False)  # acquire(False): no wait
        if not bounded:
            return ".acquire() without timeout"
        return None
    if f.attr == "join":
        # distinguish Thread.join from str.join: a literal-str receiver
        # or a non-timeout argument (an iterable being joined) is
        # string work, not a blocking wait
        if isinstance(f.value, ast.Constant):
            return None
        if call.keywords and not any(kw.arg == "timeout"
                                     for kw in call.keywords):
            return None
        if call.args:
            a = call.args[0]
            timeoutish = (isinstance(a, ast.Constant)
                          and isinstance(a.value, (int, float))) or \
                (isinstance(a, (ast.Name, ast.Attribute))
                 and "timeout" in _unparse(a))
            if not timeoutish:
                return None
        return ".join() — blocks until the thread/process exits"
    return None


# ============================================================ blocking taint


def _propagate_blocking(modules):
    """Fixpoint: qualify every package function as blocking when it
    contains a blocking primitive or calls a blocking *sync* package
    function.  Returns ``{(module, qualname): witness}`` where witness
    is the human-readable chain to the primitive.

    Async callees never taint their callers: an async function that
    blocks is its own finding (awaiting it is not what blocks the
    loop — its body is)."""
    funcs = {}
    for m in modules.values():
        for fn in m.functions.values():
            funcs[(fn.module, fn.qualname)] = fn
    blocking = {}
    for key, fn in funcs.items():
        if fn.module in NONBLOCKING_MODULES:
            continue
        if fn.primitives:
            line, prim = fn.primitives[0]
            blocking[key] = f"{prim} ({fn.module}:{line})"
    changed = True
    while changed:
        changed = False
        for key, fn in funcs.items():
            if key in blocking or fn.module in NONBLOCKING_MODULES:
                continue
            for line, target in fn.calls:
                if target is None:
                    continue
                tgt = _resolve_target(funcs, modules, target)
                if tgt is None or tgt not in blocking:
                    continue
                if funcs[tgt].is_async:
                    continue  # awaited coroutine: reported at itself
                blocking[key] = (f"calls {tgt[0]}::{funcs[tgt].qualname} "
                                 f"-> {blocking[tgt]}")
                changed = True
                break
    return blocking, funcs


def _resolve_target(funcs, modules, target):
    """(module, name) -> the function-registry key, following class
    constructors to ``__init__``; None when the name is not a parsed
    package function."""
    module, name = target
    if (module, name) in funcs:
        return (module, name)
    m = modules.get(module)
    if m is not None and name in m.classes:
        init = f"{name}.__init__"
        if (module, init) in funcs:
            return (module, init)
    return None


# ================================================================= checks


class _FileChecker:
    """Per-file rule application (atomic-write, lock-discipline,
    thread-hygiene, and the per-async-function half of
    async-blocking)."""

    def __init__(self, info, rules, blocking=None, funcs=None,
                 modules=None, force=False):
        self.info = info
        self.rules = rules
        self.blocking = blocking or {}
        self.funcs = funcs or {}
        self.modules = modules or {}
        #: fixture mode: apply every rule regardless of the module sets
        self.force = force
        self.findings = []

    def _emit(self, rule, node, message):
        if rule not in self.rules:
            return
        if self.info.suppress.active(rule, node.lineno):
            return
        self.findings.append(Finding(
            self.info.display, node.lineno, node.col_offset + 1, rule,
            message))

    def run(self):
        self._check_atomic_writes()
        self._check_lock_discipline()
        self._check_thread_hygiene()
        self._check_async_blocking()
        return self.findings

    # --------------------------------------------------------- atomic-write

    def _check_atomic_writes(self):
        if "atomic-write" not in self.rules:
            return
        for fn in self.info.functions.values():
            self._atomic_in_scope(fn.node, fn.node.name)
        # module-level statements (rare, but a top-level open("w")
        # would otherwise be invisible)
        self._atomic_in_scope(self.info.tree, None, top_level=True)

    def _atomic_in_scope(self, scope, fname, top_level=False):
        if fname in SANCTIONED_WRITERS:
            return  # the atomic-writer helper IS the idiom
        writes = []

        def visit(n, in_sanctioned_arg):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef)):
                    continue  # nested scopes are checked on their own
                if isinstance(child, ast.Call):
                    self._note_write(child, writes, in_sanctioned_arg)
                    if self._is_sanctioned_writer_call(child):
                        # everything inside this call's arguments (the
                        # writer lambda) IS the atomic idiom
                        for a in list(child.args) + \
                                [kw.value for kw in child.keywords]:
                            visit(a, True)
                        continue
                visit(child, in_sanctioned_arg)

        visit(scope, False)
        if not writes:
            return
        if not top_level:
            # the idiom markers must live in THIS function's own body —
            # the same scope the writes were collected from.  Walking
            # into nested defs (or matching "O_EXCL" as a source
            # substring, where a comment counts) would let an unrelated
            # atomic helper excuse a torn write beside it.
            def scope_nodes(n):
                for child in ast.iter_child_nodes(n):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        continue
                    yield child
                    yield from scope_nodes(child)

            has_replace = has_excl = False
            for n in scope_nodes(scope):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in ("replace", "rename") \
                        and _attr_root(n.func) == "os":
                    has_replace = True
                elif isinstance(n, ast.Attribute) and n.attr == "O_EXCL":
                    has_excl = True
            if has_replace or has_excl:
                return
        for node, what in writes:
            self._emit(
                "atomic-write", node,
                f"{what} into a shared-state module without the atomic "
                "idiom (tmp + os.replace in this function, an "
                "O_CREAT|O_EXCL claim, or one of "
                f"{sorted(SANCTIONED_WRITERS)}) — a torn write is "
                "silent corruption for every concurrent reader")

    @staticmethod
    def _is_sanctioned_writer_call(call):
        f = call.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        return name in SANCTIONED_WRITERS

    @staticmethod
    def _write_mode(call, arg_index):
        if len(call.args) > arg_index:
            m = call.args[arg_index]
            if isinstance(m, ast.Constant) and isinstance(m.value, str):
                return m.value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                return kw.value.value
        return None

    def _note_write(self, call, writes, in_sanctioned_arg):
        if in_sanctioned_arg:
            return
        f = call.func
        if isinstance(f, ast.Name) and f.id == "open":
            mode = self._write_mode(call, 1) or "r"
            if any(c in mode for c in "wx+"):
                writes.append((call, f"open(..., {mode!r})"))
        elif isinstance(f, ast.Attribute):
            root = _attr_root(f)
            if root == "os" and f.attr == "fdopen":
                mode = self._write_mode(call, 1) or "r"
                if any(c in mode for c in "wx+"):
                    writes.append((call, f"os.fdopen(..., {mode!r})"))
            elif root in ("np", "numpy") and f.attr in (
                    "save", "savez", "savez_compressed", "savetxt"):
                writes.append((call, f"np.{f.attr}(...)"))

    # ----------------------------------------------------- lock-discipline

    def _check_lock_discipline(self):
        if "lock-discipline" not in self.rules:
            return
        if not self.info.module_guards and not self.info.instance_guards:
            return

        def walk(node, locks, class_name, func_node):
            for child in ast.iter_child_nodes(node):
                child_locks = locks
                child_class = class_name
                child_func = func_node
                if isinstance(child, ast.ClassDef):
                    child_class = child.name
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                    child_func = child
                elif isinstance(child, (ast.With, ast.AsyncWith)):
                    held = {_unparse(item.context_expr)
                            for item in child.items}
                    child_locks = locks | held
                self._lock_check_node(child, locks, class_name, func_node)
                walk(child, child_locks, child_class, child_func)

        walk(self.info.tree, frozenset(), None, None)

    def _guard_for(self, expr, class_name):
        """``(lock, display name, declaration line)`` of the guarded
        state ``expr`` mutates, or ``(None, None, None)``."""
        if isinstance(expr, ast.Name):
            lock, line = self.info.module_guards.get(expr.id, (None, None))
            return lock, expr.id, line
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and class_name:
            lock, line = self.info.instance_guards.get(
                (class_name, expr.attr), (None, None))
            return lock, f"self.{expr.attr}", line
        return None, None, None

    def _state_expr(self, node, class_name):
        """Resolve a mutation target down to its guarded base: a bare
        name / self-attr, or the base of (possibly nested) subscripts
        on one."""
        while isinstance(node, ast.Subscript):
            node = node.value
        return self._guard_for(node, class_name)

    def _lock_check_node(self, node, locks, class_name, func_node):
        # definition-site exemptions, PER TARGET: a mutation is exempt
        # only inside the function that carries THAT state's own
        # guarded-by annotation (its constructor), or at module level
        # (initial binding) — an annotation for one name must not
        # excuse unlocked mutations of a different guarded name
        def exempt(decl_line):
            if func_node is None:
                return True  # module-level statement: initial binding
            if decl_line is None:
                return False
            return (func_node.lineno <= decl_line
                    <= getattr(func_node, "end_lineno", func_node.lineno))

        targets = []
        if isinstance(node, (ast.Assign,)):
            for t in node.targets:
                targets.extend(t.elts if isinstance(
                    t, (ast.Tuple, ast.List)) else [t])
        elif isinstance(node, ast.AugAssign):
            targets.append(node.target)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets.append(node.target)
        elif isinstance(node, ast.Delete):
            targets.extend(node.targets)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            lock, name, decl = self._state_expr(node.func.value, class_name)
            if lock and lock not in locks and not exempt(decl):
                self._emit(
                    "lock-discipline", node,
                    f"{name}.{node.func.attr}(...) mutates state guarded "
                    f"by `{lock}` outside `with {lock}:`")
            return
        for t in targets:
            lock, name, decl = self._state_expr(t, class_name)
            if lock and lock not in locks and not exempt(decl):
                what = (_unparse(t) or name)
                self._emit(
                    "lock-discipline", node,
                    f"assignment to {what} mutates state guarded by "
                    f"`{lock}` outside `with {lock}:`")

    # ----------------------------------------------------- thread-hygiene

    def _thread_classes(self):
        out = set()
        for name, cls in self.info.classes.items():
            for base in cls.bases:
                b = _unparse(base)
                if b in ("threading.Thread", "Thread"):
                    out.add(name)
        return out

    def _check_thread_hygiene(self):
        if "thread-hygiene" not in self.rules:
            return
        thread_classes = self._thread_classes()
        for name in thread_classes:
            cls = self.info.classes[name]
            stop = next(
                (m for m in cls.body
                 if isinstance(m, ast.FunctionDef)
                 and m.name in ("stop", "close", "shutdown")), None)
            if stop is None or ".join(" not in (
                    ast.get_source_segment(self.info.source, stop) or ""):
                self._emit(
                    "thread-hygiene", cls,
                    f"Thread subclass {name!r} has no stop/join path "
                    "(define stop()/close()/shutdown() that joins) — an "
                    "unjoinable daemon can outlive the state it samples")
            init = next((m for m in cls.body
                         if isinstance(m, ast.FunctionDef)
                         and m.name == "__init__"), None)
            if init is not None:
                for n in ast.walk(init):
                    if isinstance(n, ast.Call) and _unparse(n.func) in (
                            "super().__init__", "threading.Thread.__init__"):
                        self._thread_ctor_kwargs(n, f"{name}.__init__")
        for fn in self.info.functions.values():
            for n in ast.walk(fn.node):
                if isinstance(n, ast.Call) and _unparse(n.func) in (
                        "threading.Thread", "Thread"):
                    self._thread_ctor_kwargs(n, fn.qualname)
                    self._thread_join_path(n, fn)

    def _thread_ctor_kwargs(self, call, where):
        kw = {k.arg: k.value for k in call.keywords}
        daemon = kw.get("daemon")
        if not (isinstance(daemon, ast.Constant) and daemon.value is True):
            self._emit(
                "thread-hygiene", call,
                f"thread constructed in {where} without daemon=True — a "
                "non-daemon background thread wedges interpreter "
                "shutdown when its owner forgets to stop it")
        if "name" not in kw:
            self._emit(
                "thread-hygiene", call,
                f"thread constructed in {where} without a name= — "
                "anonymous Thread-N in a hang dump is undebuggable")

    def _thread_join_path(self, call, fn):
        # the binding this construction lands in must be .join()ed
        # somewhere in the module (drain/stop paths live in the same
        # file for every runtime thread)
        parent = None
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Assign) and any(
                    c is call for c in ast.walk(n.value)):
                parent = n
                break
        bound = None
        if parent is not None and parent.targets:
            t = parent.targets[0]
            if isinstance(t, ast.Name):
                bound = t.id
            elif isinstance(t, ast.Attribute):
                bound = t.attr
        if bound is None or f"{bound}.join(" not in self.info.source:
            self._emit(
                "thread-hygiene", call,
                "thread construction with no visible join path "
                f"({'unbound' if bound is None else bound + '.join(...) '}"
                "not found in this module) — every runtime thread needs "
                "a stop/join so shutdown is deterministic")

    # ----------------------------------------------------- async-blocking

    def _check_async_blocking(self):
        if "async-blocking" not in self.rules:
            return
        if not self.force and not _in_modules(self.info.display,
                                              ASYNC_MODULES):
            return
        for fn in self.info.functions.values():
            if not fn.is_async:
                continue
            for line, prim in fn.primitives:
                node = _NodeAt(line)
                self._emit(
                    "async-blocking", node,
                    f"async def {fn.qualname}: {prim} blocks the serve "
                    "event loop — await an async equivalent or push it "
                    "through loop.run_in_executor")
            for line, target in fn.calls:
                if target is None:
                    continue
                tgt = _resolve_target(self.funcs, self.modules, target)
                if tgt is None or tgt not in self.blocking:
                    continue
                if self.funcs[tgt].is_async:
                    continue
                self._emit(
                    "async-blocking", _NodeAt(line),
                    f"async def {fn.qualname} calls blocking "
                    f"{tgt[0]}::{self.funcs[tgt].qualname} "
                    f"[{self.blocking[tgt]}] — push it through "
                    "loop.run_in_executor")


class _NodeAt:
    """Minimal location carrier for findings derived from call-graph
    facts (only lineno/col are consumed by :class:`Finding`)."""

    __slots__ = ("lineno", "col_offset")

    def __init__(self, lineno):
        self.lineno = lineno
        self.col_offset = 0


# ================================================================== driver


def _parse_guards(info):
    """Attach ``guarded-by`` declarations to ``info``: maps of state
    name -> ``(lock, declaration line)`` — the line scopes the
    per-target constructor exemption in the lock-discipline check."""
    decls = {}
    for i, text in enumerate(info.source.splitlines(), start=1):
        m = _GUARD_RE.search(text)
        if m:
            decls[i] = m.group("lock")
    if not decls:
        return
    class_of_line = {}
    for name, cls in info.classes.items():
        for ln in range(cls.lineno, getattr(cls, "end_lineno",
                                            cls.lineno) + 1):
            class_of_line[ln] = name
    for node in ast.walk(info.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        # the annotation may sit on any physical line of a multi-line
        # assignment (a wrapped AnnAssign puts it on the continuation)
        lock = next((decls[ln] for ln in
                     range(node.lineno,
                           getattr(node, "end_lineno", node.lineno) + 1)
                     if ln in decls), None)
        if lock is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if isinstance(t, ast.Name):
                info.module_guards[t.id] = (lock, node.lineno)
            elif isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                cls = class_of_line.get(node.lineno)
                if cls:
                    info.instance_guards[(cls, t.attr)] = (lock,
                                                           node.lineno)


def _load_module(path, display=None, source=None):
    display = display or os.path.relpath(path, repo_root())
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    return _ModuleInfo(path, display, source)


def analyze_paths(paths=None, root=None, rules=None):
    """Run every concurrency rule; returns sorted :class:`Finding`\\ s.

    Default scan: the whole package scan set (the call graph needs it
    all) with per-module rule gating.  Explicit ``paths`` analyze just
    those files with EVERY rule forced on (the fixture/CI-negative
    mode) — their call graph is file-local."""
    forced = paths is not None
    scan = list(paths) if forced else default_paths(root)
    modules = {}
    for p in scan:
        try:
            info = _load_module(p)
        except SyntaxError as e:
            return [Finding(os.path.relpath(p, repo_root()), e.lineno or 1,
                            (e.offset or 0) + 1, "syntax",
                            f"cannot parse: {e.msg}")]
        modules[info.display] = info
    blocking, funcs = _propagate_blocking(modules)
    findings = []
    for info in modules.values():
        if forced:
            active = set(rules or RULES)
        else:
            active = set(RULES)
            if not _in_modules(info.display, SHARED_STATE_MODULES):
                active -= {"atomic-write", "lock-discipline",
                           "thread-hygiene"}
            if not _in_modules(info.display, ASYNC_MODULES):
                active.discard("async-blocking")
        if not active:
            continue
        checker = _FileChecker(info, active, blocking=blocking,
                               funcs=funcs, modules=modules, force=forced)
        findings.extend(checker.run())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
