"""Instrumentable filesystem seam for the coordination protocols (the
port's copy of ``raft_tpu/utils/fsops.py``; in the port the flight
recorder's shard writes route through it).

Every shared-filesystem mutation the fleet's state machines perform —
lease claims (``O_CREAT|O_EXCL``), tmp+``os.replace`` rewrites, rename
steals/evictions, pointer flips, lease removes — routes through this
module instead of calling ``os`` directly.  At runtime it is a
passthrough: ``_FS`` is ``None`` and every helper is one attribute
check away from the bare ``os`` call.

The indirection exists for the reference's ``analysis/mcheck.py``: the
protocol model checker installs an in-memory virtual filesystem here
(``install``) that implements exactly the atomicity the protocols
assume — atomic create-exclusive, atomic rename, atomic replace;
everything else interruptible — and then drives the *real* protocol functions through
every interleaving of 2–3 actors with crash injection at the
tmp-write → replace boundaries.

The seam is also what ``analysis/protocol.py`` keys its static
extraction on: a raw ``os.replace``/``os.rename``/``os.unlink`` in a
protocol module is an unmodeled mutation site and fails
``analysis protocol check``.
"""
from __future__ import annotations

import itertools
import os

#: Installed virtual filesystem (``analysis/mcheck.py``) or ``None``
#: for the real ``os``-backed implementation.  Never mutated at
#: runtime outside the model checker and its tests.
_FS = None

_TMP_COUNTER = itertools.count()


def install(fs):
    """Substitute ``fs`` for the real filesystem.  Checker/test only."""
    global _FS
    _FS = fs


def uninstall():
    global _FS
    _FS = None


def installed():
    return _FS


# ------------------------------------------------------------ mutations


def create_exclusive(path, text):
    """Atomically create ``path`` with ``text``.

    Raises :class:`FileExistsError` if the path already exists — the
    lease-claim primitive: exactly one creator wins.
    """
    if _FS is not None:
        return _FS.create_exclusive(path, text)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    return None


def write_text(path, text):
    """Plain (interruptible) write — the tmp half of a rewrite."""
    if _FS is not None:
        return _FS.write_text(path, text)
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    return None


def replace(src, dst):
    """Atomic replace: readers of ``dst`` see old-or-new, never torn."""
    if _FS is not None:
        return _FS.replace(src, dst)
    return os.replace(src, dst)


def rename(src, dst):
    """Atomic rename; raises :class:`OSError` if ``src`` is absent —
    the steal/evict primitive: exactly one renamer wins."""
    if _FS is not None:
        return _FS.rename(src, dst)
    return os.rename(src, dst)


def unlink(path):
    if _FS is not None:
        return _FS.unlink(path)
    return os.unlink(path)


def tmp_name(path):
    """Unique sibling tmp path for ``path``.  Never ends in the final
    path's suffix, so directory scans (``*.json`` filters) can never
    mistake a tmp for live state."""
    if _FS is not None:
        return _FS.tmp_name(path)
    return f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"


def grave_name(path, tag):
    """Unique grave path for an atomic remove-via-rename of ``path``."""
    if _FS is not None:
        return _FS.grave_name(path, tag)
    import uuid

    return f"{path}.{tag}.{uuid.uuid4().hex[:8]}"


def write_atomic(path, text):
    """tmp write + atomic replace, composed from the two seam ops so
    the model checker sees (and can crash between) both halves."""
    tmp = tmp_name(path)
    try:
        write_text(tmp, text)
        replace(tmp, path)
    except BaseException:
        try:
            unlink(tmp)
        except OSError:
            pass
        raise


def makedirs(path, exist_ok=True):
    if _FS is not None:
        return _FS.makedirs(path, exist_ok=exist_ok)
    return os.makedirs(path, exist_ok=exist_ok)


def utime(path):
    if _FS is not None:
        return _FS.utime(path)
    return os.utime(path, None)


# ------------------------------------------------------------ reads


def read_text(path):
    """Read ``path``; raises :class:`OSError` when absent (like open)."""
    if _FS is not None:
        return _FS.read_text(path)
    with open(path) as f:
        return f.read()


def exists(path):
    if _FS is not None:
        return _FS.exists(path)
    return os.path.exists(path)


def listdir(path):
    if _FS is not None:
        return _FS.listdir(path)
    return os.listdir(path)


def getmtime(path):
    if _FS is not None:
        return _FS.getmtime(path)
    return os.path.getmtime(path)
