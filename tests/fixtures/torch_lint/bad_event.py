"""Fixture: event-name rule — unregistered literal event names are
flagged; registered names and dynamic names pass."""
from raft_tpu_torch.utils import structlog
from raft_tpu_torch.utils.structlog import log_event


def emit(name):
    log_event("shard_done", shard=1, rows=4)      # registered: clean
    log_event("shard_don", shard=1)               # typo -> flagged
    structlog.log_event("my_custom_event", x=2)   # unregistered -> flagged
    log_event(name, x=3)                          # dynamic: not checkable
    log_event("heartbeat", devices=[])            # registered: clean
