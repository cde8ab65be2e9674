"""Time the port's scatter-add forms against each other on one GPU.

    python3 time_scatter.py [--farm-rows 512] [--full-rows 512]

``raft_tpu_torch/ops/scatter.py`` sums strip -> node and mooring-network
point loads by one-hot products on the card, where ``index_add``'s
atomics would make two evaluations of the same rows differ in their
last bits.  This script runs three forms in one process, each switched
in by patching that module:

- ``index_add``: the CPU's form on the card (atomics; bits vary);
- ``onehot_per_call``: one-hot products whose matrices are built on
  every call;
- ``onehot_kept``: the port's form, the network's matrices built once.

For each form, in the order A B C C B A (so that a drift of the host
falls on every form alike): one chunk of the farm evaluator on
design_farm_semi_wind (the network's free-point solve in every statics
Newton iteration), one chunk of the full semi_wind evaluator, and one
``drivers.run`` of a few orchestrated designs (the analyze path), wall
seconds, synchronized.  Then, per form, the kernel launches of one
network force-and-stiffness assembly and of one 64-row full chunk under
torch.profiler, and whether two evaluations of the full chunk give the
same bits.  Prints the card's name and power limit, the host's launch
rate, and one JSON object as its last line.  Needs CUDA; reads the
fixtures under tests/fixtures/torch_port.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

FORMS = ("index_add", "onehot_per_call", "onehot_kept")
ORDER = FORMS + FORMS[::-1]
ANALYZE = ("spar", "semi", "semi_wind_moor1")


def use_form(form):
    """Switch ``ops.scatter`` to ``form``; returns the undo."""
    from raft_tpu_torch.ops import scatter

    card_form, index_sum = scatter._card_form, scatter.index_sum
    if form == "index_add":
        scatter._card_form = lambda t: False
    elif form == "onehot_per_call":
        scatter.index_sum = (lambda source, index, n, matrix=None:
                             index_sum(source, index, n))

    def undo():
        scatter._card_form, scatter.index_sum = card_form, index_sum
    return undo


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--farm-rows", type=int, default=512)
    ap.add_argument("--full-rows", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scatter: CUDA is not available", file=sys.stderr)
        return 2
    from raft_tpu_torch import drivers
    from raft_tpu_torch.api import make_farm_evaluator, make_full_evaluator
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.ops import linsolve

    card = cs.phase_device()
    cpu, cores, launch_us = cs.host_speed()
    linsolve.build()

    fmodel, nW, fgold = cs._farm("semi_wind")
    farm = make_farm_evaluator(fmodel, nWaves=nW, device="cuda")
    fp = cs.farm_rows(fgold, args.farm_rows)
    with open(os.path.join(cs.FIX, "design_semi_wind.json")) as f:
        smodel = Model(json.load(f))
    full = make_full_evaluator(smodel, nWaves=1, device="cuda")
    sgold = dict(np.load(os.path.join(cs.FIX, "golden_full_semi_wind.npz")))
    sp = cs.full_rows("semi_wind", sgold, args.full_rows, cs.FULL_CONFIGS[
        "semi_wind"]["seed"])
    designs = {n: os.path.join(cs.FIX, cs.ORCH_SETS[n][0]) for n in ANALYZE}

    # warm every path once in every form (kernels, allocator, caches)
    for form in FORMS:
        undo = use_form(form)
        try:
            farm(**{k: v[:8] for k, v in fp.items()})
            full(**{k: v[:8] for k, v in sp.items()})
            for src in designs.values():
                drivers.run(src, device="cuda")
        finally:
            undo()

    res = {f: dict(farm_s=[], full_s=[], analyze_s=[]) for f in FORMS}
    for form in ORDER:
        undo = use_form(form)
        try:
            r = res[form]
            r["farm_s"].append(timed(lambda: farm(**fp))[0])
            r["full_s"].append(timed(lambda: full(**sp))[0])
            r["analyze_s"].append(sum(
                timed(lambda: drivers.run(src, device="cuda"))[0]
                for src in designs.values()))
        finally:
            undo()

    net = fmodel.ms_array
    X = torch.zeros((args.farm_rows, net.n_bodies, 6), dtype=torch.float64,
                    device="cuda")
    t = net._on(X)
    pos = net.point_positions(X, t["free0"].expand(
        (args.farm_rows,) + t["free0"].shape))
    few = {k: v[:64] for k, v in sp.items()}
    for form in FORMS:
        undo = use_form(form)
        try:
            r = res[form]
            wall, busy, launches, _ = cs._device_profile(
                lambda: net._assemble(pos))
            r["assemble"] = dict(wall_ms=wall, busy_ms=busy,
                                 launches=launches)
            wall, busy, launches, _ = cs._device_profile(lambda: full(**few))
            r["full64"] = dict(wall_ms=wall, busy_ms=busy, launches=launches)
            a, b = full(**sp), full(**sp)
            r["repeat_bits_equal"] = all(torch.equal(a[k], b[k]) for k in a)
        finally:
            undo()

    print(card)
    print(f"host: {cpu}, {cores} cores; {launch_us:.2f} us per launch")
    for form in FORMS:
        r = res[form]
        print(f"{form}: farm chunk ({args.farm_rows} rows) "
              + ", ".join(f"{x:.2f}" for x in r["farm_s"]) + " s; full chunk ("
              f"{args.full_rows} rows) "
              + ", ".join(f"{x:.3f}" for x in r["full_s"]) + " s; analyze "
              f"{'+'.join(ANALYZE)} "
              + ", ".join(f"{x:.2f}" for x in r["analyze_s"]) + " s; one "
              f"network assembly {r['assemble']['launches']} launches, "
              f"64-row full chunk {r['full64']['launches']} launches; "
              f"repeat bits equal {r['repeat_bits_equal']}")
    print(json.dumps(dict(card=card, host=cpu, cores=cores,
                          launch_us=launch_us, farm_rows=args.farm_rows,
                          full_rows=args.full_rows, analyze=ANALYZE,
                          forms=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
