"""Seeded negatives for the ``thread-hygiene`` concurrency rule."""

import threading


def spawn_anonymous(fn):
    t = threading.Thread(target=fn)     # no daemon, no name, no join
    t.start()
    return t


class NoStopSampler(threading.Thread):  # no stop/join path
    def __init__(self):
        super().__init__()              # and no daemon/name either

    def run(self):
        pass


class GoodSampler(threading.Thread):
    def __init__(self):
        super().__init__(name="fixture-sampler", daemon=True)
        self._stop_evt = threading.Event()

    def run(self):
        self._stop_evt.wait()

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=2.0)


def spawn_joined(fn):
    worker = threading.Thread(target=fn, daemon=True, name="fixture-w")
    worker.start()
    worker.join(timeout=1.0)
    return worker
