"""Seeded negatives for the ``lock-discipline`` concurrency rule."""

import threading

_LOCK = threading.Lock()
REGISTRY = {}  # raft-lint: guarded-by=_LOCK


def register_ok(name, value):
    with _LOCK:
        REGISTRY[name] = value


def register_bad(name, value):
    REGISTRY[name] = value      # item write outside the lock
    REGISTRY.pop(name, None)    # mutating method outside the lock


def snapshot():
    return dict(REGISTRY)       # reads are not gated


class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}  # raft-lint: guarded-by=self._lock
        self._bytes = 0  # raft-lint: guarded-by=self._lock

    def put_ok(self, k, v):
        with self._lock:
            self._items[k] = v
            self._bytes += 1

    def put_bad(self, k, v):
        self._items[k] = v      # instance state outside its lock
        self._bytes += 1        # augmented assign outside its lock
