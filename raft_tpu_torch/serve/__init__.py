"""The evaluation service (counterpart of ``raft_tpu/serve``): one
long-lived process that batches requests from many tenants over the
design axis into the bucket evaluator on one device.

Layout (stdlib asyncio, no new dependencies):

``cache``    content-addressed LRU result cache with a byte budget
             (design hash + case + out_keys → outputs)
``quota``    per-client token buckets (429) and the bounded admission
             queue semantics (503)
``engine``   design registry + the packed-row dispatch through the
             process-cached bucket evaluator, at a ladder of padded
             batch sizes
``batcher``  the socket-free continuous-batching core: submit →
             pending queue → adaptive-tick coalescing → per-request
             fan-out (unit-testable without a server)
``http``     the asyncio HTTP front end: ``POST /evaluate``,
             ``GET /healthz``, ``GET /metrics``, ``GET /designs``;
             graceful drain on SIGTERM
``client``   minimal stdlib client with the 429/503 backoff schedule
``wire``     the HTTP/1.1 parser/formatter

Start a server (on the card; ``--device cpu`` for the CPU)::

    python -m raft_tpu_torch.serve \
        --designs spar=tests/fixtures/torch_port/design_spar.json --port 8787

The reference's serving fleet (``fleet``, ``router``, ``canary``,
``rollout``, ``autoscale``) is ROADMAP A15(h).
"""

from __future__ import annotations

from raft_tpu_torch.serve.batcher import (Batcher, Draining,  # noqa: F401
                                          QueueFull, QuotaExceeded,
                                          RejectError)
from raft_tpu_torch.serve.cache import (ResultCache,  # noqa: F401
                                        result_cache_key)
from raft_tpu_torch.serve.engine import DesignEntry, Registry  # noqa: F401
from raft_tpu_torch.serve.quota import TokenBucket  # noqa: F401
