"""Seeded protocol bug: the claim-collision live-twin.

A claim that is a check-then-write (stat the lease path, and when
absent write the record) in place of an ``O_CREAT|O_EXCL`` create:
two workers racing the same shard id can both see "absent" and both
write — two live claimants of one lease (the live-twin), with the
loser's record silently clobbered.

The model checker must catch this through the single-holder invariant:
a plain (non-exclusive, non-atomic-replace) write to a lease path is a
hijack channel regardless of interleaving.  ``python -m
raft_tpu_torch.analysis protocol check --fixture <this file>`` must exit 1.
"""

import json

from raft_tpu_torch.utils import fsops


def lease_claim(path, rec):
    # the TOCTOU: exists-check then plain write
    if fsops.exists(path):
        return False
    fsops.write_text(path, json.dumps(rec))
    return True


# fleet.py imports the primitive BY VALUE, so both bindings need the
# buggy implementation for the revert to be faithful.
PATCHES = {
    "raft_tpu_torch.parallel.fabric:lease_claim": lease_claim,
    "raft_tpu_torch.serve.fleet:lease_claim": lease_claim,
}

# the live-twin lives in the sweep ledger's claim path
SCENARIOS = ("lease-ledger",)
