"""The port's registry of ``RAFT_TPU_*`` environment flags.

Main-path flags and the result cache's byte budget, under the same
environment names and defaults as ``raft_tpu/utils/config.py`` so that
one environment drives both packages in the parity tests.  Flags are re-read on every :func:`get`
(tests change them mid-process).

``SOLVER`` has no ``pallas`` choice here: on a CUDA tensor ``native``
is the hand-written kernel (:mod:`raft_tpu_torch.ops.linsolve`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

PREFIX = "RAFT_TPU_"


@dataclass(frozen=True)
class Flag:
    """One registered flag (``name`` is the ``RAFT_TPU_``-less suffix)."""

    name: str
    kind: str = "str"          # str | int | float | bool | choice
    default: object = None
    choices: tuple = ()
    help: str = ""
    aliases: dict = field(default_factory=dict)

    @property
    def env(self):
        return PREFIX + self.name


FLAGS: dict[str, Flag] = {}

DTYPE_F32_NAMES = ("float32", "f32", "single", "complex64")
DTYPE_F64_NAMES = ("float64", "f64", "double", "complex128")


def _register(*flags):
    for f in flags:
        FLAGS[f.name] = f


def get(name):
    """Typed, validated value of a registered flag.

    Bad values raise ``ValueError`` naming the variable; unknown flag
    names raise ``KeyError``."""
    f = FLAGS[name]
    s = os.environ.get(f.env)
    if s is None or (s == "" and f.kind != "str"):
        return f.default
    if f.kind == "str":
        return s
    if f.kind in ("int", "float"):
        try:
            return int(s) if f.kind == "int" else float(s)
        except ValueError:
            raise ValueError(f"{f.env}={s!r}: expected a number")
    if f.kind == "bool":
        v = s.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{f.env}={s!r}: expected a boolean (0/1)")
    v = s.strip().lower()
    v = f.aliases.get(v, v)
    if v not in f.choices:
        raise ValueError(f"{f.env}={v!r}: expected one of "
                         + "/".join(repr(c) for c in f.choices if c))
    return v


_register(
    Flag("SOLVER", "choice", "native", choices=("native", "lapack"),
         help="impedance solve: 'native' (the hand-written CUDA kernel "
              "on a CUDA tensor, its plain PyTorch version on a CPU "
              "tensor) or 'lapack' (torch.linalg.solve)"),
    Flag("FUSED", "choice", "on", choices=("on", "off"),
         help="take the response from the drag fixed point's final "
              "solve ('on') or re-stage drag_excitation + a second "
              "solve ('off', the parity oracle)"),
    Flag("DTYPE", "choice", "", choices=("", "float32", "float64"),
         aliases={**{a: "float32" for a in DTYPE_F32_NAMES},
                  **{a: "float64" for a in DTYPE_F64_NAMES}},
         help="compute-dtype policy (default: derive from the inputs)"),
    Flag("SCAN_CHUNK", "int", 4,
         help="drag fixed-point trips between all-rows-done checks"),
    Flag("ITER_SCALE", "int", 1,
         help="iteration-budget multiplier for the statics Newton and "
              "the drag fixed point"),
    Flag("COND_CHECK", "bool", False,
         help="fold a one-step Hager condition estimate of Z(w) into "
              "the status word (ILL_CONDITIONED_Z)"),
    Flag("COND_THRESHOLD", "float", 1e7,
         help="kappa_1(Z) estimate above which ILL_CONDITIONED_Z is set"),
    Flag("BUCKET_ROWS", "int", 512,
         help="rows per dispatched bucket chunk in sweep_heterogeneous "
              "and the design/case evaluators (0 = unlimited)"),
    Flag("BUCKET_STEPS", "str",
         "strips=16,24,32,48,64,96,128;nodes=pow2;lines=pow2",
         help="per-axis shape-bucket pad ladders: ';'-separated "
              "axis=rungs entries where rungs is an ascending comma list "
              "(doubling continues past the last rung) or 'pow2' "
              "(power-of-two ceiling at the axis floor)"),
    Flag("BEM_DIR", "str", "",
         help="panel-solver coefficient cache directory (default: "
              "_bem_cache in the working directory)"),
    Flag("SERVE_CACHE_MB", "float", 64.0,
         help="byte budget of the content-addressed result cache "
              "(design hash + case + out_keys -> outputs, LRU)"),
)
