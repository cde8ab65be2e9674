"""In-band solver-health status bits (the port's copy of the registry).

Value for value the registry of ``raft_tpu/utils/health.py``: the
status word is int32, bits are append-only, and the helpers are plain
operator arithmetic that works on numpy values and torch tensors alike
(``tests/test_torch_health.py`` holds the two registries equal).
"""

from __future__ import annotations

import numpy as np

MASKS = {
    # statics Newton hit its iteration budget with the step rule unmet
    "STATICS_MAX_ITER": 1 << 0,
    # at least one applied Newton step saturated the per-DOF step cap
    "STATICS_STEP_CAPPED": 1 << 1,
    # drag fixed point stopped by its cap with the change rule unmet
    "DRAG_CAP_HIT": 1 << 2,
    # Hager estimate of kappa_1(Z(w)) above RAFT_TPU_COND_THRESHOLD
    "ILL_CONDITIONED_Z": 1 << 3,
    # a non-finite value in a solver output (X0 / Xi)
    "NONFINITE_INTERMEDIATE": 1 << 4,
    # an input was clamped to keep the physics defined
    "INPUT_CLIPPED": 1 << 5,
}

STATICS_MAX_ITER = MASKS["STATICS_MAX_ITER"]
STATICS_STEP_CAPPED = MASKS["STATICS_STEP_CAPPED"]
DRAG_CAP_HIT = MASKS["DRAG_CAP_HIT"]
ILL_CONDITIONED_Z = MASKS["ILL_CONDITIONED_Z"]
NONFINITE_INTERMEDIATE = MASKS["NONFINITE_INTERMEDIATE"]
INPUT_CLIPPED = MASKS["INPUT_CLIPPED"]

OK = 0

SEVERE = (STATICS_MAX_ITER | DRAG_CAP_HIT | ILL_CONDITIONED_Z
          | NONFINITE_INTERMEDIATE)
INFORMATIONAL = STATICS_STEP_CAPPED | INPUT_CLIPPED


def set_bit(status, mask, cond):
    """``status | mask`` where ``cond`` holds, ``status`` elsewhere."""
    return status | (cond * np.int32(mask))


def any_bit(status, mask=SEVERE):
    """Does ``status`` carry any bit of ``mask``?"""
    return (status & np.int32(mask)) != 0


def describe(status):
    """A host status value as text: ``"ok"`` for 0, else the names of
    its bits joined by ``|`` (an unknown bit as ``bit<N>``)."""
    s = int(status)
    if s == 0:
        return "ok"
    names = [name for name, mask in MASKS.items() if s & mask]
    known = 0
    for mask in MASKS.values():
        known |= mask
    unknown = s & ~known
    bit = 0
    while unknown:
        if unknown & 1:
            names.append(f"bit{bit}")
        unknown >>= 1
        bit += 1
    return "|".join(names)
