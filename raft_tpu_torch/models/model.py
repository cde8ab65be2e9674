"""Top-level Model of one design (counterpart of the build half of
``raft_tpu/models/model.py``): frequency grid, wave numbers, the FOWT
structure, its mooring, strips and statics.

All of it is host work in numpy or float64 CPU tensors; the evaluators
(:mod:`raft_tpu_torch.api`) and the bucket packer
(:func:`raft_tpu_torch.structure.bucketing.pack_design`) move what they
need to the card.  One rigid FOWT with an inline catenary mooring (or
none), and its rotors' blade-element models (:attr:`Model.rotor_aero`);
arrays and MoorDyn-file moorings (ROADMAP A11) and line dynamics (A10)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.models.fowt import FOWTStructure
from raft_tpu_torch.models.hydro import FOWTHydro
from raft_tpu_torch.ops.waves import wave_number_ref
from raft_tpu_torch.physics.mooring import build_mooring
from raft_tpu_torch.physics.statics import calc_statics
from raft_tpu_torch.structure.schema import (coerce, frequency_grid,
                                             load_design, parse_cases)


class Model:
    """One design: ``Model(design)`` with a design dict or a ``.json`` /
    ``.yaml`` path."""

    def __init__(self, design):
        design = load_design(design)
        self.design = design
        if "array" in design:
            raise NotImplementedError(
                "array (multi-FOWT) designs are not ported (ROADMAP A11)")

        settings = design.get("settings", {}) or {}
        self.XiStart = coerce(settings, "XiStart", default=0.1)
        self.nIter = int(coerce(settings, "nIter", default=15, dtype=int))
        self.nIterExtra = int(coerce(settings, "nIterExtra", default=0,
                                     dtype=int))
        self.w = frequency_grid(design)
        self.nw = len(self.w)
        self.depth = float(coerce(design["site"], "water_depth"))
        # the reference's loose 1e-3 dispersion solve, so every stage
        # downstream sees its wave numbers
        self.k = wave_number_ref(self.w, self.depth)
        self.cases = parse_cases(design)

        mo = design.get("mooring")
        if isinstance(mo, dict) and "file" in mo and "lines" not in mo:
            raise NotImplementedError(
                "MoorDyn-file moorings are not ported (ROADMAP A11); give "
                "the mooring inline as points / lines / line_types")
        fs = FOWTStructure(design, depth=self.depth)
        self.fowtList = [fs]
        self.ms = (build_mooring(mo, rho_water=fs.rho_water, g=fs.g)
                   if isinstance(mo, dict) else None)
        self.nFOWT = 1
        self.nDOF = fs.nDOF
        self._hydro = None
        self._statics = None
        self._rotor_aero = None

    @property
    def hydro(self):
        """``[FOWTHydro]``: strips and zero-pose hydro constants (built on
        first use)."""
        if self._hydro is None:
            self._hydro = [FOWTHydro(self.fowtList[0], self.w, self.k)]
        return self._hydro

    @property
    def rotor_aero(self):
        """Per-rotor :class:`~raft_tpu_torch.physics.aero.RotorAeroModel`
        (built on first use; empty without a turbine ``wt_ops``
        schedule).  A submerged rotor takes the water's properties."""
        if self._rotor_aero is None:
            from raft_tpu_torch.physics.aero import build_rotor_aero

            self._rotor_aero = []
            turbine = self.design.get("turbine")
            if turbine is not None and "wt_ops" in turbine:
                t = dict(turbine)
                site = self.design.get("site", {})
                t.setdefault("nrotors", self.fowtList[0].nrotors)
                t.setdefault("rho_air", coerce(site, "rho_air", default=1.225))
                t.setdefault("mu_air", coerce(site, "mu_air", default=1.81e-5))
                t.setdefault(
                    "shearExp_air",
                    coerce(site, "shearExp_air",
                           default=coerce(site, "shearExp", default=0.12)),
                )
                for ir in range(self.fowtList[0].nrotors):
                    submerged = self.fowtList[0].rotors[ir].Zhub < 0
                    self._rotor_aero.append(
                        build_rotor_aero(t, ir, submerged=submerged))
        return self._rotor_aero

    def statics(self, ifowt=0, Xi0=None):
        """FOWT statics as numpy (cached at the zero pose; host work)."""
        if Xi0 is not None:
            return _host(calc_statics(self.fowtList[ifowt], Xi0))
        if self._statics is None:
            self._statics = [_host(calc_statics(f)) for f in self.fowtList]
        return self._statics[ifowt]


def _host(stat):
    """Row 0 of :func:`calc_statics`' one-row output as numpy."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v[0].numpy()
        if isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            return [x[0].numpy() for x in v]
        return v

    return {k: one(v) for k, v in stat.items()}
