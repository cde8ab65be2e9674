"""Seeded protocol drift: an unmodeled mutation in a new module.

A hypothetical sidecar that "compacts" worker status records by
renaming them with raw ``os.rename`` — bypassing the fsops seam, so
the interleaving explorer can never crash or reorder it.  The static
extraction pass must flag the raw call as protocol-unmodeled (and the
sanctioned write below as a site the baseline has never seen).

This fixture is SCANNED, never imported: ``PROTOCOL_MODULE`` tells the
static engine to treat this file as that protocol module and diff it
against the pinned baseline.  ``python -m raft_tpu_torch.analysis protocol
check --fixture <this file>`` must exit 1.
"""

import json
import os

from raft_tpu_torch.utils import fsops

PROTOCOL_MODULE = "sidecar"


def compact_status(status_dir, records):
    merged = os.path.join(status_dir, "status.json")
    fsops.write_atomic(merged, json.dumps(records))
    for name in sorted(records):
        # raw rename: invisible to the model checker
        os.rename(os.path.join(status_dir, name + ".json"),
                  os.path.join(status_dir, name + ".done"))
