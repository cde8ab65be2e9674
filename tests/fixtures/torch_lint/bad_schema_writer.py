"""Deliberately drifted lease writer/reader pair for the schema-contract
engine (`python -m raft_tpu_torch.analysis schemas --fixture` must exit 1).

Two seeded drifts, one per violation class:

* the writer emits ``renewd_t`` (typo) while the reader dereferences
  ``renewed_t`` — ``read-never-written``;
* the writer emits ``ttl_s`` only for named workers while the reader
  hard-subscripts it — ``required-but-conditional``.
"""

import json
import os
import time


def write_lease(path, worker, token):
    rec = {
        "worker": worker,
        "claimed_t": time.time(),
        "renewd_t": time.time(),   # typo: readers want "renewed_t"
        "token": token,
    }
    if worker:
        rec["ttl_s"] = 30.0        # conditional: anonymous leases lack it
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def read_lease(path, now):
    with open(path) as f:
        rec = json.load(f)
    age = now - rec["renewed_t"]       # never written (writer typo'd it)
    expired = age > rec["ttl_s"]       # required, but only conditionally written
    return expired, rec.get("worker")
