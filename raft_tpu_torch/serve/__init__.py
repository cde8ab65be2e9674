"""The evaluation service and its fleet (counterpart of
``raft_tpu/serve``): long-lived processes that batch requests from many
tenants over the design axis into the bucket evaluator, one device
each, behind a failover router.

Layout (stdlib asyncio, no new dependencies):

``cache``     content-addressed LRU result cache with a byte budget
              (design hash + case + out_keys → outputs)
``quota``     per-client token buckets (429) and the bounded admission
              queue semantics (503)
``engine``    design registry + the packed-row dispatch through the
              process-cached bucket evaluator, at a ladder of padded
              batch sizes
``batcher``   the socket-free continuous-batching core: submit →
              pending queue → adaptive-tick coalescing → per-request
              fan-out (unit-testable without a server)
``http``      the asyncio HTTP front end: ``POST /evaluate``,
              ``GET /healthz``, ``GET /metrics``, ``GET /designs``,
              ``GET /alerts``; graceful drain on SIGTERM (the fleet
              lease released at drain start)
``client``    minimal stdlib client with the 429/503 backoff schedule
              (``backoff_delay``, shared with the router)
``wire``      the HTTP/1.1 parser/formatter + the router's asyncio
              upstream client
``fleet``     replica membership for the horizontal serving fleet: a
              ``_fleet/`` lease ledger on the fabric's atomic
              primitives (claim = join, renewed = alive, expired =
              dead, release = drain) + the local fleet coordinator
``router``    the consistent-hash failover front: hash ring by (bucket
              signature, design content hash), retry-with-backoff onto
              the next replica, per-replica circuit breakers, hedged
              requests, 503 + Retry-After only when nobody can answer
``canary``    golden-answer canary prober: content-addressed golden
              rows per design, low-rate probes pinned per replica,
              bit-for-status / tolerance-for-floats comparison and the
              cross-replica provenance consistency check feeding the
              canary_parity alert (see raft_tpu_torch.obs.alerts)
``rollout``   canary-gated rolling upgrades to a cut release, replica
              by replica, with automatic rollback
``autoscale`` the SLO-driven autoscaler (router-side daemon)

Start a server (on the card; ``--device cpu`` for the CPU)::

    python -m raft_tpu_torch.serve \
        --designs spar=tests/fixtures/torch_port/design_spar.json --port 8787

Or a fault-tolerant fleet behind one endpoint::

    python -m raft_tpu_torch.serve fleet --replicas 2 --fleet-dir /srv/raft \
        --designs spar=tests/fixtures/torch_port/design_spar.json --warm-bank
    python -m raft_tpu_torch.serve router --fleet-dir /srv/raft --port 8788
"""

from __future__ import annotations

import importlib

#: the package's names, each imported from its module on first access,
#: so that the fleet's torch-free modules (fleet, router, canary,
#: rollout) load without the engine: the protocol explorer
#: (:mod:`raft_tpu_torch.analysis.mcheck`) runs them without torch
_EXPORTS = {
    "Batcher": "batcher", "Draining": "batcher", "QueueFull": "batcher",
    "QuotaExceeded": "batcher", "RejectError": "batcher",
    "ResultCache": "cache", "result_cache_key": "cache",
    "DesignEntry": "engine", "Registry": "engine", "TokenBucket": "quota",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
