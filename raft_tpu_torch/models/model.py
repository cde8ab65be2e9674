"""Top-level Model of one design (counterpart of the build half of
``raft_tpu/models/model.py``): frequency grid, wave numbers, the FOWT
structures, their moorings, strips and statics.

All of it is host work in numpy or float64 CPU tensors; the evaluators
(:mod:`raft_tpu_torch.api`) and the bucket packer
(:func:`raft_tpu_torch.structure.bucketing.pack_design`) move what they
need to the card.  One rigid FOWT, or with an ``array`` section one per
array row at its position and heading (the farm evaluator's input),
each with an inline catenary mooring, a MoorDyn-file mooring or none;
an array may add a shared-mooring network from its ``array_mooring``
MoorDyn file.  Rotors get their blade-element models
(:attr:`Model.rotor_aero`), potential-flow members or WAMIT files their
coefficients (:attr:`Model.bem_list`, :meth:`Model.run_bem`), an
external ``.12d`` file its QTF (:attr:`Model.qtf`); a slender-body QTF
is computed on demand (:meth:`Model.qtf_slender`).  Line
dynamics (``moorMod`` 1 or 2, ROADMAP A10) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raft_tpu_torch.models.fowt import FOWTStructure
from raft_tpu_torch.models.hydro import FOWTHydro
from raft_tpu_torch.ops.waves import wave_number_ref
from raft_tpu_torch.physics.mooring import (build_mooring, parse_moordyn,
                                            parse_moordyn_system)
from raft_tpu_torch.physics.statics import calc_statics
from raft_tpu_torch.structure.schema import (array_mooring, array_units,
                                             coerce, frequency_grid,
                                             load_design, parse_cases)


#: the panel solver's version token in the coefficient cache key (its
#: own, so a file the reference package wrote is never served here)
BEM_TOKEN = b"raft_tpu_torch/panel_bem-v2-fd"


class Model:
    """One design: ``Model(design)`` with a design dict or a ``.json`` /
    ``.yaml`` path.  ``base_dir`` resolves the relative data paths of a
    design dict (MoorDyn and bathymetry files); a path's own directory
    is the default."""

    def __init__(self, design, base_dir=None):
        self.base_dir = base_dir
        if not isinstance(design, dict):
            self.base_dir = os.path.dirname(os.path.abspath(design))
        design = load_design(design)
        self.design = design

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
        # the slender-body QTF's frequency grid (``min_freq2nd``,
        # ``max_freq2nd``, ``df_freq2nd`` [Hz] of the first platform)
        platform0 = (design.get("platform")
                     or (design.get("platforms") or [{}])[0])
        if "min_freq2nd" in platform0 and "max_freq2nd" in platform0:
            mf2 = platform0["min_freq2nd"]
            Mf2 = platform0["max_freq2nd"]
            df2 = platform0.get("df_freq2nd", mf2)
            self.w1_2nd = np.arange(mf2, Mf2 + 0.5 * mf2, df2) * 2 * np.pi
            self.k1_2nd = wave_number_ref(self.w1_2nd, self.depth)
        else:
            self.w1_2nd = None
            self.k1_2nd = None
        self.cases = parse_cases(design)

        self.fowtList, self.ms_list = [], []
        self.ms_array = None
        if "array" in design:
            for unit, info in array_units(design):
                place = dict(x_ref=info["x_location"],
                             y_ref=info["y_location"],
                             heading_adjust=info.get("heading_adjust", 0))
                fs = FOWTStructure(unit, depth=self.depth, **place)
                self.fowtList.append(fs)
                self.ms_list.append(self._unit_mooring(
                    unit.get("mooring"), fs, **place))
            shared = array_mooring(design)
            if shared is not None:
                path, bath = shared
                self.ms_array = parse_moordyn(
                    self._resolve_data_path(path), self.depth,
                    rho=self.fowtList[0].rho_water, g=self.fowtList[0].g,
                    bathymetry=bath and self._resolve_data_path(bath))
        else:
            fs = FOWTStructure(design, depth=self.depth)
            self.fowtList.append(fs)
            self.ms_list.append(self._unit_mooring(design.get("mooring"), fs))
        self.nFOWT = len(self.fowtList)
        self.nDOF = sum(f.nDOF for f in self.fowtList)
        self.dof_offsets = np.cumsum([0] + [f.nDOF for f in self.fowtList])
        self.ms = self.ms_list[0]                 # the single-FOWT alias
        self._hydro = None
        self._statics = None
        self._rotor_aero = None
        self._bem_list = None

    def _unit_mooring(self, mo, fs, x_ref=0.0, y_ref=0.0, heading_adjust=0.0):
        """One unit's own mooring: an inline catenary system at the
        unit's position, a MoorDyn file (a simple vessel-to-anchor file
        as a catenary system, else a network), or None."""
        if not isinstance(mo, dict):
            return None
        moorMod = int(coerce(mo, "moorMod", default=0, dtype=int))
        if moorMod != 0:
            raise NotImplementedError(
                f"moorMod {moorMod}: mooring line dynamics are not ported "
                "(ROADMAP A10); only the quasi-static catenary (moorMod 0) "
                "is")
        if "file" in mo and "lines" not in mo:
            path = self._resolve_data_path(mo["file"])
            depth = coerce(mo, "water_depth", default=self.depth)
            try:
                return parse_moordyn_system(path, depth, rho=fs.rho_water,
                                            g=fs.g)
            except ValueError:
                return parse_moordyn(path, depth, rho=fs.rho_water, g=fs.g)
        return build_mooring(mo, rho_water=fs.rho_water, g=fs.g, x_ref=x_ref,
                             y_ref=y_ref, heading_adjust=heading_adjust)

    def _resolve_data_path(self, path, suffixes=("",)):
        """A design-relative data path: tried against ``base_dir`` and
        its parent (the reference resolves such paths against the
        working directory it runs from); a candidate counts when it
        exists with one of ``suffixes`` (a WAMIT ``hydroPath`` names
        its files without their ``.1`` / ``.3``)."""
        if os.path.isabs(path) or self.base_dir is None:
            return path
        for base in (self.base_dir,
                     os.path.normpath(os.path.join(self.base_dir, ".."))):
            cand = os.path.normpath(os.path.join(base, path))
            if any(os.path.exists(cand + s) for s in suffixes):
                return cand
        return os.path.join(self.base_dir, path)

    def qtf_path(self):
        """The first FOWT's external QTF file (``hydroPath`` + ``.12d``
        with ``potSecOrder: 2``) when it exists, else None; the file is
        not read."""
        fs = self.fowtList[0]
        if fs.potSecOrder != 2 or not fs.hydroPath:
            return None
        path = self._resolve_data_path(fs.hydroPath, (".12d",)) + ".12d"
        return path if os.path.exists(path) else None

    @property
    def qtf(self):
        """The first FOWT's external difference-frequency QTF (read on
        first use by :func:`~raft_tpu_torch.physics.secondorder.
        read_qtf_12d`), or None when the design has none or its file is
        absent, as in the reference."""
        if not hasattr(self, "_qtf"):
            from raft_tpu_torch.physics.secondorder import read_qtf_12d

            path = self.qtf_path()
            fs = self.fowtList[0]
            self._qtf = (None if path is None
                         else read_qtf_12d(path, rho=fs.rho_water, g=fs.g))
        return self._qtf

    def qtf_slender(self, beta, Xi0=None, ifowt=0, device=None,
                    timer=None):
        """The slender-body difference-frequency QTF of one FOWT
        (``potSecOrder: 1``) on the grid :attr:`w1_2nd`: an (nw2, nw2, 1,
        nDOF) complex128 tensor on the device, hermitian
        (:func:`~raft_tpu_torch.physics.qtf_slender.fowt_qtf_slender`).

        ``beta`` is the wave heading [rad].  The reference's entry takes
        a heading index and reads the heading its hydro object kept from
        the last case's excitation; the port's :class:`FOWTHydro` keeps
        no case, so the heading is an argument.  ``Xi0`` (nDOF, nw) are
        motion RAOs on the model grid (None: a fixed body).  Runs on
        ``device`` (default: the current CUDA device; raises without
        one); ``timer(stage)`` marks its stages."""
        from raft_tpu_torch.physics.qtf_slender import fowt_qtf_slender

        return fowt_qtf_slender(self, beta, Xi0=Xi0, ifowt=ifowt,
                                device=device, timer=timer)

    @property
    def hydro(self):
        """``[FOWTHydro]``: strips and zero-pose hydro constants (built on
        first use)."""
        if self._hydro is None:
            self._hydro = [FOWTHydro(f, self.w, self.k)
                           for f in self.fowtList]
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

    @property
    def bem(self):
        """The first FOWT's potential-flow coefficients (see
        :attr:`bem_list`)."""
        return self.bem_list[0]

    @property
    def bem_list(self):
        """Per-FOWT potential-flow coefficients (built on first use), the
        dict of :func:`raft_tpu_torch.io.wamit.load_bem_coefficients` or
        None: read from WAMIT files where the design points at them
        (``hydroPath`` with ``potFirstOrder: 1``), else solved by the
        panel solver on the potMod members (:meth:`run_bem`), else None.
        Non-finite file coefficients raise."""
        if self._bem_list is None:
            from raft_tpu_torch.io.wamit import load_bem_coefficients

            out = []
            for i, fs in enumerate(self.fowtList):
                bem_i = None
                if fs.potFirstOrder == 1 and fs.hydroPath:
                    path = self._resolve_data_path(fs.hydroPath, (".1", ".3"))
                    bem_i = load_bem_coefficients(
                        path, self.w, fs.rho_water, fs.g,
                        r_ref=fs.node_r0[fs.root_id])
                    for key in ("A_BEM", "B_BEM", "X_BEM"):
                        if not np.all(np.isfinite(bem_i[key])):
                            raise RuntimeError(
                                f"non-finite {key} coefficients loaded from "
                                f"{path}")
                elif any(m.potMod for m in fs.members):
                    bem_i = self.run_bem(ifowt=i)
                out.append(bem_i)
            self._bem_list = out
        return self._bem_list

    def run_bem(self, ifowt=0, w_bem=None, headings=None, save_dir=None,
                n_az=None, dz_max=None, force=False, workers=None,
                d_scale=1.0):
        """Solve the FOWT's potMod members with the panel solver
        (:func:`raft_tpu_torch.native.solve_bem`) and read the
        coefficients back through WAMIT ``.1`` / ``.3`` files, as the
        reference does (mesh, solve, write, read).

        The files are cached in ``save_dir`` (default: the
        ``RAFT_TPU_BEM_DIR`` flag, else ``_bem_cache`` in the working
        directory) under a key hashed from this package's solver token,
        the panel vertices and areas, the frequencies, headings, depth,
        rho and g; ``force=True`` solves again.  The token differs from
        the reference package's, so a file it wrote is never read here.
        ``d_scale`` scales the potMod members' diameters before meshing
        (the geometry axis).  BEM frequencies default to the settings'
        ``dw_BEM`` / ``wMax_BEM`` (else 25 steps over the model grid),
        headings to 0-315 deg by 45, the mesh to ``nAz_BEM`` (18) and
        ``dz_BEM``.  Returns the dict of
        :func:`~raft_tpu_torch.io.wamit.load_bem_coefficients`, or None
        when no potMod member is submerged."""
        import copy
        import dataclasses
        import hashlib

        from raft_tpu_torch.io.panels import mesh_fowt
        from raft_tpu_torch.io.wamit import (load_bem_coefficients,
                                             write_wamit1, write_wamit3)
        from raft_tpu_torch.utils import config

        fs = self.fowtList[ifowt]
        settings = self.design.get("settings", {}) or {}
        name = str(self.design.get("name", "design")).replace(" ", "_")[:40]
        if save_dir is None:
            save_dir = (config.get("BEM_DIR")
                        or os.path.join(os.getcwd(), "_bem_cache"))
        os.makedirs(save_dir, exist_ok=True)

        if w_bem is None:
            dw = float(coerce(settings, "dw_BEM", default=0.0) or 0.0)
            wMax = float(coerce(settings, "wMax_BEM", default=0.0) or 0.0)
            if dw <= 0:
                dw = max((self.w[-1] - self.w[0]) / 24.0, 1e-3)
            if wMax <= 0:
                wMax = float(self.w[-1])
            w_bem = np.arange(dw, wMax + 0.5 * dw, dw)
        if headings is None:
            headings = np.arange(0.0, 360.0, 45.0)

        n_az_v = n_az or int(coerce(settings, "nAz_BEM", default=18,
                                    dtype=int))
        dz_v = dz_max or (coerce(settings, "dz_BEM", default=0.0) or None)
        fs_mesh = fs
        if abs(float(d_scale) - 1.0) > 1e-12:
            fs_mesh = copy.copy(fs)
            fs_mesh.members = [
                dataclasses.replace(m, d=np.asarray(m.d) * float(d_scale))
                if m.potMod else m for m in fs.members]
        v, c, nrm, a = mesh_fowt(fs_mesh, dz_max=dz_v, n_az=n_az_v)
        if len(a) == 0:
            return None
        hsh = hashlib.sha256()
        hsh.update(BEM_TOKEN)
        for arr in (v, a, np.asarray(w_bem, float),
                    np.asarray(headings, float),
                    np.asarray([self.depth, fs.rho_water, fs.g], float)):
            hsh.update(np.ascontiguousarray(
                np.asarray(arr, dtype=np.float64)).tobytes())
        prefix = os.path.join(save_dir,
                              f"{name}_f{ifowt}_{hsh.hexdigest()[:12]}")

        if force or not os.path.exists(prefix + ".1"):
            from raft_tpu_torch.native import solve_bem

            A, B, X = solve_bem(v, c, nrm, a, w_bem, headings_deg=headings,
                                depth=self.depth, rho=fs.rho_water, g=fs.g,
                                ref=(0.0, 0.0, 0.0), workers=workers)
            write_wamit1(prefix + ".1", w_bem, A, B, rho=fs.rho_water)
            write_wamit3(prefix + ".3", w_bem, headings, X,
                         rho=fs.rho_water, g=fs.g)
        return load_bem_coefficients(prefix, self.w, fs.rho_water, fs.g,
                                     r_ref=fs.node_r0[fs.root_id])

    def bem_matrices(self, ifowt=0):
        """Potential-flow added mass and radiation damping on the model
        grid, (nDOF, nDOF, nw) numpy each (zero without coefficients)."""
        nDOF, nw = self.fowtList[ifowt].nDOF, self.nw
        A = np.zeros((nDOF, nDOF, nw))
        B = np.zeros((nDOF, nDOF, nw))
        bem = self.bem_list[ifowt]
        if bem is not None:
            A[:6, :6, :] = bem["A_BEM"]
            B[:6, :6, :] = bem["B_BEM"]
        return A, B

    def statics(self, ifowt=0, Xi0=None):
        """FOWT statics as numpy (cached at the zero pose; host work): a
        single rigid body by :func:`~raft_tpu_torch.physics.statics.
        calc_statics`, any other structure by :func:`~raft_tpu_torch.
        physics.statics_general.calc_statics_general`."""
        if Xi0 is not None:
            return _fowt_statics(self.fowtList[ifowt], Xi0)
        if self._statics is None:
            self._statics = [_fowt_statics(f) for f in self.fowtList]
        return self._statics[ifowt]


def _fowt_statics(fs, Xi0=None):
    if not fs.is_single_body:
        from raft_tpu_torch.physics.statics_general import \
            calc_statics_general

        return calc_statics_general(fs, Xi0=Xi0)
    return _host(calc_statics(fs, Xi0))


def _host(stat):
    """Row 0 of :func:`calc_statics`' one-row output as numpy."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v[0].numpy()
        if isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            return [x[0].numpy() for x in v]
        return v

    return {k: one(v) for k, v in stat.items()}
