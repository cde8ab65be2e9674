"""Write the design, packed-design and JAX-golden fixtures of the
PyTorch port.

For each of the three bundled demo designs this script writes:

* ``design_<name>.json``: ``yaml.safe_load`` of the design's YAML, dumped
  as JSON (the port and ``chip_smoke.py`` read designs without PyYAML);
* ``packed_<name>.npz``: the numpy leaves of
  :func:`raft_tpu.structure.bucketing.pack_design`, plus the
  bucket-signature metadata, the reference for the port's own builder;
* ``golden_<name>.npz``: the JAX bucket evaluator's outputs (float64,
  CPU, vmapped) over a fixed grid of 8 sea states;
* ``golden_design_<name>.npz``: the JAX design evaluator's outputs
  (``raft_tpu.api.make_design_evaluator``, float64, CPU, vmapped) over
  8 fixed rows of sea state and drag / added-mass / mooring-length
  scales;

the goldens under ``RAFT_TPU_FUSED=on`` and ``off``.

Run from the repository root::

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py

It writes ``tests/fixtures/torch_port/*``.
The checked-in files came from ``raft_tpu`` as of commit d384195 (its
sources are unchanged since c7d9048).  Not collected by pytest (the
file name does not start with ``test_``); the slow test
``tests/test_torch_bucket.py::test_fixtures_regenerate`` re-runs
:func:`build_fixtures` and compares with the files.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(HERE, "fixtures", "torch_port")
DESIGNS = {"spar": "spar_demo.yaml", "semi": "semi_demo.yaml",
           "mhk": "mhk_demo.yaml"}

#: the golden sea-state grid (Hs [m], Tp [s], beta [rad]), shared by
#: every design: mild to severe, short to long period, all headings
GOLDEN_CASES = (
    (6.0, 12.0, 0.0),
    (2.5, 7.5, 0.35),
    (1.0, 4.0, 3.1),
    (12.0, 20.0, 1.2),
    (9.0, 14.0, 2.4),
    (4.0, 9.0, 0.8),
    (11.0, 6.0, 1.9),
    (3.0, 17.0, 0.1),
)

#: the golden design rows (Hs [m], Tp [s], beta [rad], Cd_scale,
#: Ca_scale, L_moor_scale): the sea states above with scales below and
#: above 1
DESIGN_KEYS = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
GOLDEN_DESIGN_ROWS = (
    (6.0, 12.0, 0.0, 1.0, 1.0, 1.0),
    (2.5, 7.5, 0.35, 0.5, 0.5, 0.98),
    (1.0, 4.0, 3.1, 2.0, 1.5, 1.02),
    (12.0, 20.0, 1.2, 0.75, 1.25, 0.99),
    (9.0, 14.0, 2.4, 1.5, 0.8, 1.01),
    (4.0, 9.0, 0.8, 1.2, 1.1, 0.985),
    (11.0, 6.0, 1.9, 0.6, 0.7, 1.015),
    (3.0, 17.0, 0.1, 1.8, 1.4, 1.0),
)

OUT_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "drag_resid", "drag_converged",
            "n_iter_drag", "status")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def pack(name):
    """(packed numpy leaves, signature meta) of one bundled design."""
    _jax()
    import raft_tpu
    from raft_tpu.structure import bucketing

    model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                        DESIGNS[name]))
    sig = bucketing.bucket_signature(model)
    return bucketing.pack_design(model, sig), sig


def golden(packed, sig, fused):
    """JAX bucket-evaluator outputs over :data:`GOLDEN_CASES`."""
    jax = _jax()
    import numpy as np

    from raft_tpu.structure import bucketing

    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        # a fresh evaluator per mode: the flag is read at trace time
        ev = bucketing.make_bucket_evaluator(sig)
        n = len(GOLDEN_CASES)
        Hs, Tp, beta = (np.asarray(c, dtype=float)
                        for c in zip(*GOLDEN_CASES))
        case = dict(design=bucketing.stack_packed([packed] * n),
                    Hs=Hs, Tp=Tp, beta=beta)
        out = jax.jit(jax.vmap(ev))(case)
        return {k: np.asarray(out[k]) for k in OUT_KEYS}
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def design_dict(name):
    """The design dict of one bundled design, as ``yaml.safe_load``
    reads it."""
    import yaml

    with open(os.path.join(ROOT, "raft_tpu", "designs", DESIGNS[name])) as f:
        return yaml.safe_load(f)


def design_json(name):
    """The text of ``design_<name>.json``."""
    import json

    return json.dumps(design_dict(name), indent=1) + "\n"


def golden_design(name, fused, rows=GOLDEN_DESIGN_ROWS):
    """JAX design-evaluator outputs over ``rows`` of :data:`DESIGN_KEYS`."""
    jax = _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_design_evaluator

    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                            DESIGNS[name]))
        ev = make_design_evaluator(model)
        params = {k: np.asarray(c, dtype=float)
                  for k, c in zip(DESIGN_KEYS, zip(*rows))}
        out = jax.jit(jax.vmap(ev))(params)
        return {k: np.asarray(out[k]) for k in OUT_KEYS}
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def build_design_golden(name):
    """The ``golden_design_<name>.npz`` dict, as written."""
    import numpy as np

    gd = {k: np.asarray(c, dtype=float)
          for k, c in zip(DESIGN_KEYS, zip(*GOLDEN_DESIGN_ROWS))}
    for fused in ("on", "off"):
        for k, v in golden_design(name, fused).items():
            gd[f"{fused}_{k}"] = v
    return gd


def build_fixtures(name):
    """``(packed_npz, golden_npz)`` dicts of one design, as written."""
    import numpy as np

    packed, sig = pack(name)
    from raft_tpu.structure import bucketing

    meta = bucketing.signature_meta(sig)
    pk = {k: np.asarray(v) for k, v in packed.items()}
    for k in ("S", "N", "L", "nIter", "nIterExtra"):
        pk["sig_" + k] = np.int64(meta[k])
    pk["sig_XiStart"] = np.float64(meta["XiStart"])
    pk["sig_w"] = np.asarray(meta["w"], dtype=np.float64)
    gd = {"Hs": np.asarray([c[0] for c in GOLDEN_CASES]),
          "Tp": np.asarray([c[1] for c in GOLDEN_CASES]),
          "beta": np.asarray([c[2] for c in GOLDEN_CASES])}
    for fused in ("on", "off"):
        for k, v in golden(packed, sig, fused).items():
            gd[f"{fused}_{k}"] = v
    return pk, gd


def main():
    import numpy as np

    os.makedirs(OUT_DIR, exist_ok=True)
    for name in DESIGNS:
        pk, gd = build_fixtures(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"packed_{name}.npz"), **pk)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_{name}.npz"), **gd)
        with open(os.path.join(OUT_DIR, f"design_{name}.json"), "w") as f:
            f.write(design_json(name))
        gdd = build_design_golden(name)
        np.savez_compressed(
            os.path.join(OUT_DIR, f"golden_design_{name}.npz"), **gdd)
        print(f"{name}: design status_on={gdd['on_status'].tolist()} "
              f"n_iter_on={gdd['on_n_iter_drag'].tolist()}")
        print(f"{name}: S={int(pk['sig_S'])} N={int(pk['sig_N'])} "
              f"L={int(pk['sig_L'])} status_on={gd['on_status'].tolist()} "
              f"n_iter_on={gd['on_n_iter_drag'].tolist()}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
