"""Fixture: span() call sites with unregistered literal names (the
span-name rule must flag both the bare-name and attribute forms, and
must NOT flag dynamic names or registered ones)."""
from raft_tpu_torch import obs
from raft_tpu_torch.obs.spans import span


def work(name):
    with span("shrad"):            # typo'd name: flagged
        pass
    with obs.span("sweep_dispach", rows=4):   # typo'd name: flagged
        pass
    with span("sweep"):            # registered: clean
        pass
    with span(name):               # dynamic: not checkable, clean
        pass
