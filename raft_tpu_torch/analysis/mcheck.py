"""Deterministic interleaving explorer for the fleet's fs protocols
(counterpart of ``raft_tpu/analysis/mcheck.py``, over the port's
protocol functions).

The static half of the protocol engine (``analysis/protocol.py``)
pins WHERE the shared-filesystem mutations are; this module checks
WHAT their composition guarantees.  It runs the *real* protocol
functions — :mod:`raft_tpu_torch.parallel.fabric` lease primitives, the
:class:`~raft_tpu_torch.serve.fleet.FleetLedger`, the
:mod:`~raft_tpu_torch.aot.release` pointer, the rollout gate and the
router :class:`~raft_tpu_torch.serve.router.Breaker` — against an
in-memory virtual filesystem implementing exactly the atomicity the
engines assume (atomic create-exclusive, atomic rename, atomic
replace; everything else interruptible), and enumerates EVERY
interleaving of 2–3 cooperative actors, plus crash injection at each
tmp-write → replace/rename boundary.

Global invariants asserted at every explored state:

* ``single-holder`` — at most one live lease holder per shard/rid: a
  non-seizer action never changes the token of an existing lease.
* ``current-verified`` — the ``current`` release pointer always
  resolves to a manifest that passes ``verify_manifest``, including
  with a promoter crashed mid-flip.
* ``rollout-recoverable`` — a crashed rollout always leaves the
  parent release promotable and the replica lease re-seizable.
* ``grave-not-resurrected`` — a stolen lease's grave name is never
  renamed back into (or created as) live state.
* ``gate-candidate-probed`` — the rollout gate only turns green after
  ``ROLLOUT_CANARY_PROBES`` canary observations of the replaced
  replica at its post-seize endpoint.
* ``breaker-liveness`` — the breaker never refuses traffic with the
  half-open trial slot held and zero trials outstanding.
* ``no-tmp-live`` — a leftover ``*.tmp*`` file is never treated as
  live membership or release state.

State-space control is canonicalization + memoized state hashing: a
state is the canonical virtual-fs image plus each actor's observation
history; alternatives of an already-expanded state are pruned.  The
protocols are small (bounded actors, bounded fs keys), so exploration
completes in seconds.  Nothing here imports torch or jax: the
protocol modules of the port are torch-free.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import threading
import time
import uuid

from raft_tpu_torch.utils import fsops

EPOCH = 1_700_000_000.0

#: invariant identifiers — pinned in protocol_baseline.json so adding
#: or dropping a checked invariant diffs against the baseline like a
#: mutation-site change does
INVARIANTS = (
    "breaker-liveness",
    "current-verified",
    "gate-candidate-probed",
    "grave-not-resurrected",
    "no-tmp-live",
    "rollout-recoverable",
    "single-holder",
)

_STEP_TIMEOUT_S = 20.0


class Violation(Exception):
    """A protocol invariant failed in some interleaving."""

    def __init__(self, invariant, detail, trace=()):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant
        self.detail = detail
        self.trace = tuple(trace)


class EngineError(Exception):
    """The explorer itself broke (nondeterminism, deadlock, blowup) —
    distinct from a Violation: CI treats it as exit 2, not 1."""


class _Crash(BaseException):
    """Injected actor death.  BaseException so protocol ``except
    (OSError, ValueError)`` cleanup paths cannot swallow it — a dead
    process runs no cleanup."""


# ------------------------------------------------------------ virtual fs


class VirtualClock:
    """Deterministic stand-in for ``time.time``/``time.monotonic``:
    every read advances by 1µs (strictly monotonic, reproducible per
    choice sequence); scenarios advance whole seconds explicitly."""

    def __init__(self):
        self.wall = EPOCH
        self.mono = 1000.0

    def time(self):
        self.wall += 1e-6
        return self.wall

    def monotonic(self):
        self.mono += 1e-6
        return self.mono

    def advance(self, seconds):
        self.wall += float(seconds)
        self.mono += float(seconds)


class VirtualFS:
    """In-memory filesystem with the protocol's assumed atomicity.

    Every op is one atomic step; the scheduler interleaves actors
    BETWEEN ops (``checkpoint``), never inside one.  Mutations are
    logged (``oplog``) so invariants can attribute ownership changes
    to a sanctioned cause."""

    def __init__(self, sched):
        self.sched = sched
        self.files = {}   # path -> text
        self.mtimes = {}  # path -> virtual wall time
        self.dirs = set()
        #: mutation log: (actor, op, path, src, text_after) — invariants
        #: attribute every ownership change to its sanctioned primitive
        self.oplog = []
        self._seq = 0
        self._version = 0        # bumps on every mutation
        self._canon_memo = None  # (version, canon image)

    # -- bookkeeping

    def _log(self, op, path, src=""):
        self._version += 1
        self.oplog.append((self.sched.current_name(), op, path, src,
                           self.files.get(path)))

    def _mkparents(self, path):
        d = os.path.dirname(path)
        while d and d not in self.dirs:
            self.dirs.add(d)
            d = os.path.dirname(d)

    # -- mutations (checkpointed; rename/replace/unlink crashable)

    def create_exclusive(self, path, text):
        self.sched.checkpoint("create_excl", path)
        if path in self.files:
            raise FileExistsError(path)
        self.files[path] = text
        self.mtimes[path] = self.sched.clock.wall
        self._mkparents(path)
        self._log("create_excl", path)

    def write_text(self, path, text):
        self.sched.checkpoint("write", path)
        self.files[path] = text
        self.mtimes[path] = self.sched.clock.wall
        self._mkparents(path)
        self._log("write", path)

    def replace(self, src, dst):
        self.sched.checkpoint("replace", dst, crashable=True)
        if src not in self.files:
            raise FileNotFoundError(src)
        self.files[dst] = self.files.pop(src)
        self.mtimes[dst] = self.mtimes.pop(src)
        self._log("replace", dst, src=src)

    def rename(self, src, dst):
        self.sched.checkpoint("rename", src, crashable=True)
        if src not in self.files:
            raise FileNotFoundError(src)
        self.files[dst] = self.files.pop(src)
        self.mtimes[dst] = self.mtimes.pop(src)
        self._log("rename", dst, src=src)

    def unlink(self, path):
        self.sched.checkpoint("unlink", path, crashable=True)
        if path not in self.files:
            raise FileNotFoundError(path)
        del self.files[path]
        del self.mtimes[path]
        self._log("unlink", path)

    def utime(self, path):
        self.sched.checkpoint("utime", path)
        if path not in self.files:
            raise FileNotFoundError(path)
        self.mtimes[path] = self.sched.clock.wall
        self._log("utime", path)

    def makedirs(self, path, exist_ok=True):
        # not a coordination-relevant op: apply without a checkpoint
        if not exist_ok and path in self.dirs:
            raise FileExistsError(path)
        self.dirs.add(path)
        self._mkparents(os.path.join(path, "x"))

    # -- reads (checkpointed so read/write interleavings are explored;
    #    the observed VALUE joins the actor's history — two states only
    #    memo-merge when every actor has seen the same data, otherwise
    #    pruning could hide an interleaving the continuation depends on)

    def read_text(self, path):
        self.sched.checkpoint("read", path)
        if path not in self.files:
            self.sched.note(("read", path, None))
            raise FileNotFoundError(path)
        text = self.files[path]
        self.sched.note(("read", path, text))
        return text

    def exists(self, path):
        self.sched.checkpoint("exists", path)
        found = path in self.files or path in self.dirs
        self.sched.note(("exists", path, found))
        return found

    def listdir(self, path):
        self.sched.checkpoint("listdir", path)
        names = {os.path.basename(p) for p in self.files
                 if os.path.dirname(p) == path}
        self.sched.note(("listdir", path, tuple(sorted(names))))
        if not names and path not in self.dirs:
            raise FileNotFoundError(path)
        return sorted(names)

    def getmtime(self, path):
        self.sched.checkpoint("stat", path)
        if path not in self.files:
            self.sched.note(("stat", path, None))
            raise FileNotFoundError(path)
        mtime = self.mtimes[path]
        self.sched.note(("stat", path, mtime))
        return mtime

    # -- deterministic unique names (no checkpoint)

    def tmp_name(self, path):
        self._seq += 1
        return f"{path}.tmp.{self.sched.current_name()}.{self._seq}"

    def grave_name(self, path, tag):
        self._seq += 1
        return f"{path}.{tag}.{self.sched.current_name()}.{self._seq}"

    # -- canonical image for state hashing

    def canon(self, aliases):
        if self._canon_memo is not None \
                and self._canon_memo[0] == self._version:
            return self._canon_memo[1]
        out = tuple((path, _canon_text(self.files[path], aliases))
                    for path in sorted(self.files))
        self._canon_memo = (self._version, out)
        return out


_TIME_KEYS = {"claimed_t", "renewed_t", "t", "created", "t_unix"}


def _canon_value(key, val, aliases):
    if key == "token" and isinstance(val, str):
        return aliases.get(val, "?token")
    if key in _TIME_KEYS and isinstance(val, (int, float)):
        return int(val)
    if key in ("pid",):
        return 0
    if key in ("host",):
        return "h"
    if isinstance(val, dict):
        return {k: _canon_value(k, v, aliases) for k, v in sorted(
            val.items())}
    return val


#: (text, alias fingerprint) -> canonical form.  Tokens and graves are
#: deterministic per run (virtual uuid/clock), so the same texts recur
#: across thousands of replays — without this cache canonicalization
#: dominates exploration time.
_CANON_CACHE = {}


def _canon_text(text, aliases):
    key = (text, tuple(sorted(aliases.items())))
    hit = _CANON_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        obj = json.loads(text)
    except ValueError:
        return text
    if not isinstance(obj, dict):
        return text
    out = json.dumps(
        {k: _canon_value(k, v, aliases) for k, v in sorted(obj.items())},
        sort_keys=True, default=str)
    if len(_CANON_CACHE) < 100_000:
        _CANON_CACHE[key] = out
    return out


# ------------------------------------------------------------- scheduler


class _FakeUUID:
    __slots__ = ("hex",)

    def __init__(self, hex_):
        self.hex = hex_

    def __str__(self):
        return self.hex


def _gate():
    """A binary semaphore at 0: a raw lock taken at birth.  The
    scheduler and an actor hand control back and forth through two of
    them; releasing a raw lock wakes its waiter in one call, where a
    ``threading.Semaphore`` goes through a Condition's several (the
    hand-offs are most of the explorer's time)."""
    lock = threading.Lock()
    lock.acquire()
    return lock


class _Actor:
    def __init__(self, name, fn):
        self.name = name
        self.fn = fn
        self.go = _gate()
        self.thread = None
        self.started = False
        self.finished = False
        self.crashed = False
        self.error = None
        self.pending = None        # (kind, path, crashable) at a checkpoint
        self.history = []          # every checkpoint passed (its position)
        self.canon_hist = []       # canonical prefix of history
        self.choose_options = None
        self.choose_value = None


class Scheduler:
    """One deterministic execution of a scenario under a prescribed
    choice prefix; choices past the prefix default to the first
    enabled one, and every decision point is recorded for the
    explorer to branch on."""

    def __init__(self, scenario, prefix, max_crashes=1):
        self.scenario = scenario
        self.prefix = tuple(prefix)
        self.max_crashes = max_crashes
        self.clock = VirtualClock()
        self.fs = VirtualFS(self)
        self.back = _gate()
        self.actors = {}
        self.current = None
        self.crashes = 0
        self.decisions = []
        self.applied = []
        self.ctx = None

    # -- actor-side API (called from actor threads via the vfs / ctx)

    def current_name(self):
        return self.current.name if self.current is not None else "_env"

    def checkpoint(self, kind, path, crashable=False):
        actor = self.current
        if actor is None or actor.thread is not threading.current_thread():
            return  # setup/finalize/invariant context: apply immediately
        if actor.crashed:
            raise _Crash()
        actor.pending = (kind, path, bool(crashable))
        self.back.release()
        actor.go.acquire()
        if actor.crashed:
            raise _Crash()
        actor.history.append((kind, path))
        actor.pending = None

    def note(self, observed):
        """Record a read's RESULT in the acting actor's history (no
        scheduling point — the value was determined by the checkpoint
        that admitted the read)."""
        actor = self.current
        if actor is not None and actor.thread is threading.current_thread():
            actor.history.append(("res",) + tuple(observed))

    def pause(self, label="pause"):
        self.checkpoint("pause", label)

    def choose(self, options):
        actor = self.current
        if actor is None or actor.thread is not threading.current_thread():
            return options[0]
        if actor.crashed:
            raise _Crash()
        actor.choose_options = tuple(options)
        self.back.release()
        actor.go.acquire()
        if actor.crashed:
            raise _Crash()
        value = actor.choose_value
        actor.choose_options = None
        actor.choose_value = None
        actor.history.append(("choose", value))
        return value

    # -- scheduler side

    def _actor_main(self, actor):
        actor.go.acquire()
        try:
            actor.fn(self.ctx)
        except _Crash:
            pass
        except Exception as e:                       # scenario bug
            actor.error = e
        finally:
            actor.finished = True
            self.back.release()

    def _step(self, actor):
        self.current = actor
        if not actor.started:
            actor.started = True
            actor.thread = threading.Thread(
                target=self._actor_main, args=(actor,), daemon=True)
            actor.thread.start()
        actor.go.release()
        if not self.back.acquire(timeout=_STEP_TIMEOUT_S):
            raise EngineError(
                f"actor {actor.name} never yielded (deadlock in "
                f"scenario {self.scenario.name})")
        self.current = None
        if actor.error is not None:
            raise EngineError(
                f"actor {actor.name} raised {actor.error!r} in scenario "
                f"{self.scenario.name}")

    def _crash(self, actor):
        actor.crashed = True
        self.crashes += 1
        self.applied.append(f"{actor.name}: CRASH before "
                            f"{(actor.pending or ('?',))[0]}")
        self._step(actor)  # unwind: checkpoints now raise _Crash

    def _enabled(self):
        out = []
        for name in sorted(self.actors):
            a = self.actors[name]
            if a.finished:
                continue
            if a.choose_options is not None:
                out.extend(("pick", name, i)
                           for i in range(len(a.choose_options)))
                continue
            out.append(("step", name))
            if (a.pending is not None and a.pending[2]
                    and self.crashes < self.max_crashes
                    and name in self.scenario.crashable):
                out.append(("crash", name))
        return tuple(out)

    def _canon_history(self, actor):
        # incremental: aliases are registered before their token can
        # reach the fs or a read result, so canonical prefixes never
        # go stale and only new entries need work
        aliases = self.ctx.aliases
        done = actor.canon_hist
        for entry in actor.history[len(done):]:
            if entry[0] == "res":
                _, kind, path, val = entry
                if isinstance(val, str):
                    val = _canon_text(val, aliases)
                elif isinstance(val, float):
                    val = int(val)
                done.append(("res", kind, path, val))
            else:
                done.append(entry)
        return tuple(done)

    def _state_key(self):
        actors = tuple(
            (a.name, a.started, a.finished, a.crashed,
             self._canon_history(a), a.pending, a.choose_options)
            for _, a in sorted(self.actors.items()))
        return (self.fs.canon(self.ctx.aliases), actors,
                self.scenario.digest(self.ctx))

    def _apply(self, choice):
        kind = choice[0]
        actor = self.actors[choice[1]]
        if kind == "crash":
            self._crash(actor)
            return
        if kind == "pick":
            actor.choose_value = actor.choose_options[choice[2]]
            self.applied.append(
                f"{actor.name}: choose {actor.choose_value}")
            self._step(actor)
            return
        if actor.pending is not None:
            self.applied.append(
                f"{actor.name}: {actor.pending[0]} {actor.pending[1]}")
        else:
            self.applied.append(f"{actor.name}: start")
        self._step(actor)

    def run(self):
        """Execute to completion; returns the decision list.  Raises
        Violation (with the interleaving trace attached) or
        EngineError."""
        self.ctx = Ctx(self)
        fsops.install(self.fs)
        saved = (time.time, time.monotonic, uuid.uuid4)
        time.time = self.clock.time
        time.monotonic = self.clock.monotonic
        uid = [0]

        def _uuid4():
            # deterministic tokens: replays reproduce them exactly and
            # identical lease texts recur across runs (canon cache)
            uid[0] += 1
            return _FakeUUID(f"{uid[0]:032x}")

        uuid.uuid4 = _uuid4
        try:
            self.scenario.setup(self.ctx)
            for name, fn in self.scenario.actors(self.ctx).items():
                self.actors[name] = _Actor(name, fn)
            self._check()
            step = 0
            while any(not a.finished for a in self.actors.values()):
                step += 1
                if step > 10_000:
                    raise EngineError(
                        f"scenario {self.scenario.name}: run did not "
                        "terminate")
                enabled = self._enabled()
                if not enabled:
                    break
                idx = len(self.decisions)
                if idx < len(self.prefix):
                    choice = self.prefix[idx]
                    if choice not in enabled:
                        raise EngineError(
                            f"nondeterministic replay in scenario "
                            f"{self.scenario.name}: prescribed {choice} "
                            f"not in {enabled}")
                else:
                    choice = enabled[0]
                # the explorer branches only where there is a choice:
                # the state is hashed there alone
                self.decisions.append(
                    (self._state_key() if len(enabled) > 1 else None,
                     enabled, choice))
                self._apply(choice)
                self._check()
            self.scenario.finalize(self.ctx)
            return self.decisions
        except Violation as v:
            raise Violation(v.invariant, v.detail,
                            trace=tuple(self.applied)) from None
        finally:
            time.time, time.monotonic, uuid.uuid4 = saved
            fsops.uninstall()
            for a in self.actors.values():
                if a.started and not a.finished:
                    # violation unwound the run mid-flight: let the
                    # paused daemon threads die with the process
                    a.crashed = True
                    if a.go.locked():
                        a.go.release()

    def _check(self):
        self.scenario.invariant(self.ctx)


class Ctx:
    """What scenario scripts and invariants see: the scheduler's
    cooperative API plus shared scenario state."""

    def __init__(self, sched):
        self.sched = sched
        self.fs = sched.fs
        self.clock = sched.clock
        self.shared = {}
        self.aliases = {}   # raw token -> stable actor alias

    def pause(self, label="pause"):
        self.sched.pause(label)

    def choose(self, options):
        return self.sched.choose(options)

    def alias(self, token, name):
        self.aliases[str(token)] = name


# -------------------------------------------------------------- explorer


def explore(scenario, max_crashes=1, max_runs=50_000):
    """Exhaustively explore every interleaving (modulo memoized-state
    pruning).  Returns ``(violation_or_None, stats)``."""
    expanded = set()
    stack = [()]
    runs = 0
    while stack:
        prefix = stack.pop()
        runs += 1
        if runs > max_runs:
            raise EngineError(
                f"scenario {scenario.name}: exceeded {max_runs} runs — "
                "state space blew up")
        try:
            decisions = Scheduler(scenario, prefix,
                                  max_crashes=max_crashes).run()
        except Violation as v:
            return v, {"runs": runs, "states": len(expanded)}
        for i, (key, enabled, chosen) in enumerate(decisions):
            if len(enabled) < 2 or key in expanded:
                continue
            expanded.add(key)
            base = tuple(d[2] for d in decisions[:i])
            for alt in enabled:
                if alt != chosen:
                    stack.append(base + (alt,))
    return None, {"runs": runs, "states": len(expanded)}


# ------------------------------------------------- invariant helpers


def _text_token(text):
    try:
        rec = json.loads(text) if text is not None else None
    except ValueError:
        return None
    return rec.get("token") if isinstance(rec, dict) else None


def check_lease_ownership(ctx, seizers=()):
    """``single-holder`` + ``grave-not-resurrected`` over the vfs
    mutation log.

    A lease file (shard/replica membership) may only ever be touched
    by the sanctioned ownership primitives:

    * ``create_excl`` — claim: the filesystem itself guarantees one
      winner, so it is always legal;
    * ``replace`` — rewrite: legal only when the installed token has
      held THIS lease before (a renewer refreshing its own record —
      including the accepted wedged-renewer lost-update) or the actor
      is a scenario-designated seizer (rolling-upgrade takeover);
    * ``rename``/``unlink`` away — steal/evict/release.

    A plain ``write`` to a lease path (torn-write channel), or a
    ``replace`` installing a never-before-seen token by a non-seizer,
    is a hijack: a live holder displaced without steal/evict/seize —
    exactly the claim-collision live-twin bug of a check-then-write
    claim."""
    fs = ctx.fs
    book = ctx.shared.setdefault(
        "_ownership", {"idx": 0, "ever": {}})
    new_ops = fs.oplog[book["idx"]:]
    book["idx"] = len(fs.oplog)
    for actor, op, path, src, text in new_ops:
        if op in ("rename", "replace") and ".stolen." in src \
                and ".stolen." not in path:
            raise Violation(
                "grave-not-resurrected",
                f"{actor} renamed grave {src} back to live path {path}")
        base = os.path.basename(path)
        is_lease = base.endswith(".json") and (
            "/leases/" in path or "/replicas/" in path)
        if not is_lease:
            continue
        ever = book["ever"].setdefault(path, set())
        tok = _text_token(text)
        if op == "write":
            raise Violation(
                "single-holder",
                f"{actor} mutated lease {path} with a plain "
                "(interruptible) write — claims must be "
                "create-exclusive and rewrites tmp+replace")
        if op == "replace" and tok is not None and tok not in ever \
                and actor not in seizers:
            raise Violation(
                "single-holder",
                f"{actor} installed a brand-new token into live lease "
                f"{path} via replace without being a designated seizer "
                "(claim-collision hijack: the holder was displaced "
                "without steal/evict/seize)")
        if tok is not None:
            ever.add(tok)


def check_no_tmp_live(ctx, ledger=None):
    """Membership/release views must never surface tmp leftovers."""
    if ledger is not None:
        for rid in ledger.replicas():
            if ".tmp" in rid or ".stolen." in rid:
                raise Violation(
                    "no-tmp-live",
                    f"membership lists non-live file as replica {rid!r}")


# ------------------------------------------------------------- scenarios


class Scenario:
    """Base: subclasses define name/crashable/seizers, setup, actors,
    invariant, digest, finalize."""

    name = "?"
    crashable = frozenset()
    seizers = frozenset()
    max_crashes = 1

    def setup(self, ctx):
        pass

    def actors(self, ctx):
        return {}

    def invariant(self, ctx):
        pass

    def digest(self, ctx):
        return None

    def finalize(self, ctx):
        pass


class LeaseLedgerScenario(Scenario):
    """2 workers race claim/renew/steal/release on one fabric shard —
    the thief only steals when :meth:`Ledger.stealable` says the lease
    expired (TTL, advanced by a clock actor), with crash injection
    inside the renew rewrite, the release unlink and the steal's
    rename→unlink window."""

    name = "lease-ledger"
    crashable = frozenset({"A", "B"})

    OUT = "/proto/sweep"

    def setup(self, ctx):
        fabric = importlib.import_module("raft_tpu_torch.parallel.fabric")
        ctx.shared["fabric"] = fabric
        ctx.shared["LA"] = fabric.Ledger(self.OUT, 1, worker_id="wA")
        ctx.shared["LB"] = fabric.Ledger(self.OUT, 1, worker_id="wB")
        ctx.alias(ctx.shared["LA"].token, "A")
        ctx.alias(ctx.shared["LB"].token, "B")

    def actors(self, ctx):
        def actor_a(c):
            led = c.shared["LA"]
            if led.claim(0):
                led.renew(0)
                led.release(0)

        def actor_b(c):
            led = c.shared["LB"]
            if led.claim(0):
                return
            for attempt in (2, 3):
                c.pause("b-retry")
                reason, age, holder, _ = led.stealable(0)
                if reason:
                    if led.steal(0, reason, age, holder):
                        led.claim(0, attempt=attempt)
                    return
                if led.claim(0, attempt=attempt):
                    return

        def ticker(c):
            # one TTL expiry: everything after this sees A's unrenewed
            # lease as stealable (FABRIC_TTL_S defaults to 30s)
            c.pause("tick")
            c.clock.advance(31.0)

        return {"A": actor_a, "B": actor_b, "T": ticker}

    def invariant(self, ctx):
        check_lease_ownership(ctx)

    def finalize(self, ctx):
        # whatever happened (incl. crashes mid-rewrite / mid-steal), a
        # late worker must still be able to take the shard over
        fabric = ctx.shared["fabric"]
        ctx.clock.advance(31.0)
        led = fabric.Ledger(self.OUT, 1, worker_id="wC")
        ctx.alias(led.token, "C")
        if not led.claim(0):
            reason, age, holder, _ = led.stealable(0)
            if not reason:
                raise Violation(
                    "rollout-recoverable",
                    "shard lease held but not stealable a full TTL "
                    "after every worker stopped (wedged ledger)")
            if not led.steal(0, reason, age, holder):
                raise Violation(
                    "rollout-recoverable",
                    "expired shard lease could not be stolen")
            if not led.claim(0, attempt=9):
                raise Violation(
                    "rollout-recoverable",
                    "shard lease unclaimable after a winning steal")
        check_lease_ownership(ctx)


class ReleasePointerScenario(Scenario):
    """Concurrent promote(R2) vs rollback with crash injection at the
    pointer flip: ``current`` must resolve to a verified manifest at
    every state, including with the promoter dead mid-flip."""

    name = "release-pointer"
    crashable = frozenset({"P", "Q"})

    AOT = "/proto/aot"

    def setup(self, ctx):
        release = importlib.import_module("raft_tpu_torch.aot.release")
        release._PARITY_CACHE[:] = []  # run-scoped: don't leak clocks
        ctx.shared["release"] = release
        man1 = release.build_manifest({}, "code", "flags")
        man2 = release.build_manifest({}, "code", "flags",
                                      parent=man1["release"])
        for man in (man1, man2):
            fsops.makedirs(release.releases_dir(self.AOT))
            fsops.write_atomic(
                release.manifest_path(man["release"], self.AOT),
                json.dumps(man, sort_keys=True))
        ctx.shared["r1"] = man1["release"]
        ctx.shared["r2"] = man2["release"]
        release.promote(man1["release"], self.AOT)

    def actors(self, ctx):
        release = ctx.shared["release"]

        def promoter(c):
            release.promote(c.shared["r2"], self.AOT)

        def rollbacker(c):
            try:
                release.rollback(self.AOT)
            except (ValueError, FileNotFoundError):
                pass  # current had no parent yet: nothing to roll back

        return {"P": promoter, "Q": rollbacker}

    def invariant(self, ctx):
        release = ctx.shared["release"]
        rid, man = release.resolve(self.AOT)
        if rid is None:
            raise Violation("current-verified",
                            "current pointer lost (resolves to nothing)")
        if ".tmp" in rid:
            raise Violation("no-tmp-live",
                            f"current resolves through a tmp file: {rid}")
        if man is None:
            raise Violation("current-verified",
                            f"current names {rid} but its manifest is "
                            "missing/unreadable")
        problems = release.verify_manifest(man)
        if problems:
            raise Violation("current-verified",
                            f"current manifest {rid} fails verification: "
                            + "; ".join(problems))
        if rid not in (ctx.shared["r1"], ctx.shared["r2"]):
            raise Violation("current-verified",
                            f"current names a foreign release {rid}")

    def finalize(self, ctx):
        self.invariant(ctx)


class RolloutScenario(Scenario):
    """A rollout driver promotes, marks, and seizes against a renewing
    old replica; the driver is crashable at every flip.  After any
    crash the parent must be able to re-seize and re-promote."""

    name = "rollout-takeover"
    crashable = frozenset({"R"})
    seizers = frozenset({"R", "_env"})   # finalize recovery seizes too

    AOT = "/proto/aot"
    ROOT = "/proto/deploy"

    def setup(self, ctx):
        release = importlib.import_module("raft_tpu_torch.aot.release")
        fleet = importlib.import_module("raft_tpu_torch.serve.fleet")
        release._PARITY_CACHE[:] = []
        ctx.shared["release"] = release
        ctx.shared["fleet"] = fleet
        man1 = release.build_manifest({}, "code", "flags")
        man2 = release.build_manifest({}, "code", "flags",
                                      parent=man1["release"])
        for man in (man1, man2):
            fsops.makedirs(release.releases_dir(self.AOT))
            fsops.write_atomic(
                release.manifest_path(man["release"], self.AOT),
                json.dumps(man, sort_keys=True))
        ctx.shared["r1"] = man1["release"]
        ctx.shared["r2"] = man2["release"]
        release.promote(man1["release"], self.AOT)
        old = fleet.FleetLedger(self.ROOT, replica_id="r0")
        old.claim(7001)
        ctx.shared["old"] = old
        ctx.alias(old.token, "OLD")

    def actors(self, ctx):
        release = ctx.shared["release"]
        fleet = ctx.shared["fleet"]

        def rollout(c):
            cand = fleet.FleetLedger(self.ROOT, replica_id="r0")
            c.alias(cand.token, "CAND")
            c.shared["cand"] = cand
            release.promote(c.shared["r2"], self.AOT)
            release.write_rollout_marker(c.shared["r1"],
                                         c.shared["r2"], self.AOT)
            cand.seize(7002)
            release.clear_rollout_marker(self.AOT)

        def old_renewer(c):
            c.shared["old"].renew()

        return {"R": rollout, "O": old_renewer}

    def invariant(self, ctx):
        release = ctx.shared["release"]
        fleet = ctx.shared["fleet"]
        check_lease_ownership(ctx, seizers=self.seizers)
        rid, man = release.resolve(self.AOT)
        if rid is None or man is None or release.verify_manifest(man):
            raise Violation(
                "current-verified",
                f"current does not resolve to a verified manifest "
                f"mid-rollout (got {rid!r})")
        check_no_tmp_live(ctx, fleet.FleetLedger(self.ROOT))

    def finalize(self, ctx):
        # parent recovery after any outcome (incl. a crashed driver):
        # re-promote the parent and re-seize the replica
        release = ctx.shared["release"]
        fleet = ctx.shared["fleet"]
        try:
            release.promote(ctx.shared["r1"], self.AOT)
        except (OSError, ValueError) as e:
            raise Violation(
                "rollout-recoverable",
                f"parent release no longer promotable after rollout: {e}")
        parent = fleet.FleetLedger(self.ROOT, replica_id="r0")
        ctx.alias(parent.token, "PARENT")
        if not parent.seize(7001):
            raise Violation("rollout-recoverable",
                            "parent could not re-seize the replica lease")
        rec, _ = parent.read("r0")
        if not rec or rec.get("token") != parent.token:
            raise Violation("rollout-recoverable",
                            "parent seize did not take effect")
        release.clear_rollout_marker(self.AOT)
        self.invariant(ctx)


class RolloutGateScenario(Scenario):
    """The REAL per-replica rollout gate interleaved with the REAL
    canary observation runs across a same-rid takeover: green requires
    the candidate to have been probed at its post-seize endpoint."""

    name = "rollout-gate"
    seizers = frozenset({"C"})

    ROOT = "/proto/deploy"
    E_OLD = "127.0.0.1:7001"
    E_NEW = "127.0.0.1:7002"

    def setup(self, ctx):
        fleet = importlib.import_module("raft_tpu_torch.serve.fleet")
        canary = importlib.import_module("raft_tpu_torch.serve.canary")
        rollout = importlib.import_module("raft_tpu_torch.serve.rollout")
        release = importlib.import_module("raft_tpu_torch.aot.release")
        release._PARITY_CACHE[:] = []
        from raft_tpu_torch.obs import metrics
        ctx.shared["fleet"] = fleet
        ctx.shared["rollout"] = rollout
        old = fleet.FleetLedger(self.ROOT, replica_id="r0")
        old.claim(7001)
        neighbor = fleet.FleetLedger(self.ROOT, replica_id="r1")
        neighbor.claim(7003)
        ctx.alias(old.token, "OLD")
        ctx.alias(neighbor.token, "NBR")
        ctx.shared["old"] = old
        state = canary.CanaryState()
        ctx.shared["canary"] = state
        ctx.shared["baseline"] = {
            "passes": metrics.counter("canary_pass").value,
            "fails": metrics.counter("canary_fail").value,
        }
        ctx.shared["need"] = 2
        ctx.shared["gate"] = None  # (verdict, reason) once decided

    def _observe(self, ctx, rid, endpoint):
        ctx.shared["canary"].observe(
            design="d", replica=rid, fingerprint="fp",
            case=(1.0, 2.0, 3.0), out_keys=("x",),
            outputs={"x": [1.0]}, status=0, endpoint=endpoint)

    def actors(self, ctx):
        rollout = ctx.shared["rollout"]
        fleet = ctx.shared["fleet"]

        def candidate(c):
            cand = fleet.FleetLedger(self.ROOT, replica_id="r0")
            c.alias(cand.token, "CAND")
            cand.seize(7002)

        def prober(c):
            # two passes over live membership, probing each replica
            # at whatever endpoint its lease names RIGHT NOW — exactly
            # what the router canary daemon does
            led = fleet.FleetLedger(self.ROOT)
            for _ in range(2):
                live = led.live()
                for rid in sorted(live):
                    rec = live[rid]
                    self._observe(
                        c, rid, f"{rec.get('addr')}:{rec.get('port')}")
                c.pause("probe-pass")

        def gate(c):
            for _ in range(4):
                c.pause("gate-poll")
                payload = {"canary": c.shared["canary"].summary(),
                           "active": []}
                verdict, reason = rollout.gate_decision(
                    payload, c.shared["baseline"], c.shared["need"],
                    replica="r0", endpoint=self.E_NEW)
                if verdict != "pending":
                    c.shared["gate"] = (verdict, reason)
                    return

        return {"C": candidate, "P": prober, "G": gate}

    def invariant(self, ctx):
        check_lease_ownership(ctx, seizers=self.seizers)
        gate = ctx.shared["gate"]
        if gate is None or gate[0] != "green":
            return
        state = ctx.shared["canary"]
        with state._lock:
            run = dict(state._probes.get("r0") or {})
        if run.get("endpoint") != self.E_NEW \
                or int(run.get("n") or 0) < ctx.shared["need"]:
            raise Violation(
                "gate-candidate-probed",
                "rollout gate turned green before the candidate was "
                f"probed {ctx.shared['need']}x at its post-seize "
                f"endpoint (observation run: {run or None}) — the "
                "fleet-wide-pass race of a gate that ignores the replica")

    def digest(self, ctx):
        state = ctx.shared["canary"]
        with state._lock:
            probes = tuple(sorted(
                (rid, run.get("endpoint"), run.get("n"))
                for rid, run in state._probes.items()))
        return (probes, ctx.shared["gate"])


class BreakerScenario(Scenario):
    """Two requesters + a cooldown clock against the REAL router
    breaker: after any interleaving of admit/success/failure/cancel,
    the half-open trial slot is never left held with no trial
    outstanding (the wedged-breaker liveness bug)."""

    name = "breaker"

    def setup(self, ctx):
        router = importlib.import_module("raft_tpu_torch.serve.router")
        br = router.Breaker(fails=1, cooldown_s=5.0,
                            clock=ctx.clock.monotonic)
        ctx.shared["br"] = br
        ctx.shared["trials"] = set()

    def actors(self, ctx):
        br = ctx.shared["br"]
        trials = ctx.shared["trials"]

        def requester(name):
            def fn(c):
                for _ in range(2):
                    c.pause("request")
                    if not br.allow():
                        continue
                    if br._trial_inflight:
                        trials.add(name)
                    outcome = c.choose(["success", "failure", "cancel"])
                    if outcome == "success":
                        br.record_success()
                    elif outcome == "failure":
                        br.record_failure()
                    else:
                        br.release_trial()   # cancelled hedge loser
                    trials.discard(name)
            return fn

        def clock_actor(c):
            for _ in range(2):
                c.pause("tick")
                c.clock.advance(6.0)

        return {"U": requester("U"), "V": requester("V"),
                "T": clock_actor}

    def invariant(self, ctx):
        br = ctx.shared["br"]
        if br._trial_inflight and not ctx.shared["trials"]:
            raise Violation(
                "breaker-liveness",
                "breaker refuses traffic with the half-open trial slot "
                "held and zero trials outstanding (a cancelled attempt "
                "did not release_trial)")

    def digest(self, ctx):
        br = ctx.shared["br"]
        return (br._consecutive, br._trial_inflight,
                None if br._opened_t is None else round(br._opened_t),
                round(ctx.clock.mono), tuple(sorted(ctx.shared["trials"])))


SCENARIOS = (LeaseLedgerScenario, ReleasePointerScenario,
             RolloutScenario, RolloutGateScenario, BreakerScenario)


# ----------------------------------------------------------- entry points


def _apply_patches(patches):
    # import EVERY target module before patching ANY: fleet.py binds
    # the fabric lease primitives by value at import time, so patching
    # fabric first and importing fleet second would save the patched
    # function as fleet's "original" and restore the bug permanently
    specs = [(spec.split(":"), obj)
             for spec, obj in (patches or {}).items()]
    mods = {name: importlib.import_module(name) for (name, _), _ in specs}
    saved = []
    for (mod_name, attr), obj in specs:
        mod = mods[mod_name]
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, obj)
    return saved


def _restore_patches(saved):
    for mod, attr, obj in saved:
        setattr(mod, attr, obj)


def run_all(patches=None, scenarios=None):
    """Explore every scenario (optionally with fixture patches
    applied).  Returns ``(violations, stats)`` where violations is a
    list of Violation and stats maps scenario name -> counters."""
    saved = _apply_patches(patches)
    violations, stats = [], {}
    try:
        for cls in (scenarios or SCENARIOS):
            scen = cls()
            v, st = explore(scen, max_crashes=scen.max_crashes)
            stats[scen.name] = st
            if v is not None:
                violations.append((scen.name, v))
    finally:
        _restore_patches(saved)
    return violations, stats


def load_fixture(path):
    """Import a ``tests/fixtures/protocol/`` fixture module; its
    ``PATCHES`` dict maps ``"module.path:attr"`` to the reverted
    (historically-buggy) implementation to explore with."""
    name = "_raft_protocol_fixture_" + \
        os.path.basename(path).replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "PATCHES"):
        raise EngineError(f"fixture {path} defines no PATCHES dict")
    return mod
