"""A fabric entry for ``tests/test_torch_fleet.py``'s merged-trace
drill, in a module of its own so that the fabric's worker processes
load it by path without the test module's imports."""

import time

import torch

from raft_tpu_torch.parallel.sweep import full_compute


def _toy_full(Hs, Tp):
    """Cheap deterministic evaluator: case rows -> dict of outputs."""
    return {"PSD": torch.stack([Hs, Tp, Hs * Tp], -1), "X0": Hs - Tp}


def slow_toy_entry(out_keys=("PSD", "X0"), delay_s=0.3, **_):
    """Toy entry whose every shard takes ``delay_s`` of wall time — long
    enough that several workers demonstrably interleave."""
    inner = full_compute(_toy_full, out_keys=tuple(out_keys))

    def compute(chunk, mesh):
        time.sleep(float(delay_s))
        return inner(chunk, mesh)

    return compute
