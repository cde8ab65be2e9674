"""Seeded violations for the env-read rule: raw flag reads that bypass
the raft_tpu_torch.utils.config registry."""

import os


def read_flags():
    a = os.environ.get("RAFT_TPU_SOLVER", "native")   # line 8
    b = os.environ["RAFT_TPU_DTYPE"]                  # line 9
    c = os.getenv("RAFT_TPU_SCAN_CHUNK", "4")         # line 10
    d = os.environ.get("XLA_FLAGS", "")               # not RAFT_TPU_: fine
    return a, b, c, d
