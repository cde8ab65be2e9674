"""Top-level Model of one design (counterpart of
``raft_tpu/models/model.py``): the host build (frequency grid, wave
numbers, the FOWT structures, their moorings, strips and statics) and
the orchestrated analysis path over the design's case table.

The build is host work in numpy or float64 CPU tensors.  One rigid or
flexible FOWT, or with an ``array`` section one per array row at its
position and heading, each with an inline catenary mooring, a MoorDyn
file (a simple vessel-to-anchor file as a catenary system, else a
network) or none; an array may add a shared-mooring network from its
``array_mooring`` MoorDyn file.  A mooring's ``moorMod`` 1 or 2 keeps
its lumped-mass line-dynamics columns.  Rotors get their blade-element
models (:attr:`Model.rotor_aero`), potential-flow members or WAMIT files
their coefficients (:attr:`Model.bem_list`, :meth:`Model.run_bem`), an
external ``.12d`` file its QTF (:attr:`Model.qtf`); a slender-body QTF
is computed on demand (:meth:`Model.qtf_slender`).

The orchestrated path (:meth:`Model.analyze_cases`, the reference's
analyzeCases) runs per case :meth:`Model.solve_statics`,
:meth:`Model.solve_dynamics` and the channel statistics
(:mod:`raft_tpu_torch.models.outputs`); :meth:`Model.calc_outputs` and
:meth:`Model.solve_eigen` give the properties and the natural modes.
Each case runs as one row of the port's batched functions on the
chosen device (default: the current CUDA device; without one they
raise), so the drag fixed point and the system response of a rigid
FOWT pass the hand-written solve kernel on the card; the evaluators
(:mod:`raft_tpu_torch.api`) batch the same physics over rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raft_tpu_torch.models.fowt import FOWTStructure
from raft_tpu_torch.models.hydro import FOWTHydro
from raft_tpu_torch.ops import transforms as tf
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
        # where the slender-body QTF loop writes its checkpoints (the
        # converged RAOs as .4, the QTF as .12d), or None
        self.out_folder_qtf = platform0.get("outFolderQTF")
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
        # per-case aero terms, keyed as the reference keys them
        self._aero_cache = {}
        self._Tn0_cache = {}
        self._moorings = {}

    def _unit_mooring(self, mo, fs, x_ref=0.0, y_ref=0.0, heading_adjust=0.0):
        """One unit's own mooring: an inline catenary system at the
        unit's position, a MoorDyn file (a simple vessel-to-anchor file
        as a catenary system, else a network), or None."""
        if not isinstance(mo, dict):
            return None
        if "file" in mo and "lines" not in mo:
            path = self._resolve_data_path(mo["file"])
            depth = coerce(mo, "water_depth", default=self.depth)
            try:
                return parse_moordyn_system(
                    path, depth, rho=fs.rho_water, g=fs.g,
                    moorMod=coerce(mo, "moorMod", default=0, dtype=int))
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


    # ------------------------------------------------- orchestrated path
    def _mooring(self, device):
        """The :class:`ModelMooring` of every FOWT's own mooring and the
        array's shared network on ``device`` (made once per device)."""
        key = str(device)
        if key not in self._moorings:
            self._moorings[key] = ModelMooring(self, device)
        return self._moorings[key]

    def solve_statics(self, case=None, extra_force=None, device=None):
        """Mean offsets X (nDOF,) numpy for a load case (the reference's
        ``solve_statics``, its solveStatics): each FOWT's current loads
        and mean rotor loads at its zero pose (never at an earlier
        case's pose), ``extra_force`` (nDOF,) added (the mean drift fed
        back after the dynamics), then the coupled Newton equilibrium
        over all FOWTs with their moorings and the shared network, as
        one row of :func:`~raft_tpu_torch.models.statics_solve.
        solve_equilibrium_general` on ``device`` (default: the current
        CUDA device; raises without one).  Sets ``statics_status`` (the
        health word), ``statics_iterations`` and ``X0``; warns as the
        reference does when the Newton does not converge."""
        import warnings

        import scipy.linalg

        from raft_tpu_torch.models.statics_solve import (
            make_tolerances, solve_equilibrium_general)
        from raft_tpu_torch.utils import health
        from raft_tpu_torch.utils.dtypes import resolve_device

        dev = resolve_device(device)
        K_blocks, C_elast_blocks, F_und, F_env = [], [], [], []
        for i, fs in enumerate(self.fowtList):
            stat = self.statics(i)
            K_blocks.append(np.asarray(stat["C_struc"] + stat["C_hydro"]))
            C_elast_blocks.append(np.asarray(stat["C_elast"]))
            F_und.append(np.asarray(stat["W_struc"] + stat["W_hydro"]
                                    + stat["f0_additional"]))
            F = np.zeros(fs.nDOF)
            if case is not None:
                F = F + self.hydro[i].current_loads(case, dev)
                F = F + self.aero_mean_force(case, i, device=dev)
            F_env.append(F)
        F_env = np.concatenate(F_env)
        if extra_force is not None:
            F_env = F_env + np.asarray(extra_force)
        kw = dict(dtype=torch.float64, device=dev)

        def row(a):
            return torch.as_tensor(np.asarray(a), **kw)[None]

        tol, caps, refs = (torch.tensor(v, **kw) for v in
                           make_tolerances(self.fowtList))
        X, _, n_iter, converged, status, _ = solve_equilibrium_general(
            row(scipy.linalg.block_diag(*K_blocks)),
            row(np.concatenate(F_und)), row(F_env), self._mooring(dev), tol,
            caps, refs, C_elast=row(scipy.linalg.block_diag(*C_elast_blocks)))
        self.statics_status = int(status[0])
        self.statics_iterations = int(n_iter[0])
        if not bool(converged[0]):
            warnings.warn(
                "solveStatics Newton did not converge within "
                f"{int(n_iter[0])} iterations "
                f"(status: {health.describe(int(status[0]))})")
        self.X0 = X[0].cpu().numpy()
        return self.X0

    def _Tn0(self, ifowt):
        """The node reduction (N, 6, nDOF) of a FOWT at its zero pose."""
        cache = self._Tn0_cache
        if ifowt not in cache:
            fs = self.fowtList[ifowt]
            cache[ifowt] = self.hydro[ifowt].pose(
                np.zeros(fs.nDOF), torch.device("cpu")).Tn[0].numpy()
        return cache[ifowt]

    def turbine_constants(self, case, ifowt=0, device=None):
        """The aero-servo added mass, damping and excitation and the
        gyroscopic damping of a FOWT's rotors in its reduced DOFs for a
        case (the reference's ``turbine_constants``, its
        calcTurbineConstants), as numpy: f_aero0 (nDOF, nRotor), A_aero,
        B_aero (nDOF, nDOF, nw), f_aero (nDOF, nw), B_gyro (nDOF, nDOF),
        the rotor-axis A00, B00 (nw, nRotor) and each rotor's channel
        data ``rotor_info`` (with the cavitation margins of a
        current-driven rotor with ``cpmin`` polars).

        Cached per FOWT and per the case's wind, current, turbulence,
        yaw and status entries, as the reference caches them; a
        per-FOWT wind-speed list (the farm's waked speeds) gives each
        FOWT its own.  The rotor loads reduce through the node rows of
        the zero pose (where the reference's solve_statics, the first to
        ask for a case, holds its FOWTs).  Each rotor's blade-element
        solve runs as one row on ``device``."""
        from raft_tpu_torch.physics.aero import calc_aero, calc_cavitation
        from raft_tpu_torch.utils.dtypes import resolve_device

        fs = self.fowtList[ifowt]
        nDOF, nw = fs.nDOF, self.nw
        nr = max(fs.nrotors, 1)
        out = dict(f_aero0=np.zeros((nDOF, nr)),
                   A_aero=np.zeros((nDOF, nDOF, nw)),
                   B_aero=np.zeros((nDOF, nDOF, nw)),
                   f_aero=np.zeros((nDOF, nw), dtype=np.complex128),
                   B_gyro=np.zeros((nDOF, nDOF)), A00=np.zeros((nw, nr)),
                   B00=np.zeros((nw, nr)), rotor_info=[None] * nr)
        status = str(case.get("turbine_status", "operating"))
        if status != "operating" or not self.rotor_aero:
            return out
        key = (ifowt,) + tuple(sorted(
            (k, str(v)) for k, v in case.items()
            if k in ("wind_speed", "wind_heading", "turbulence",
                     "yaw_misalign", "turbine_heading", "current_speed",
                     "current_heading", "turbine_status")))
        if key in self._aero_cache:
            return self._aero_cache[key]
        dev = resolve_device(device)
        for ir, rot in enumerate(self.rotor_aero):
            rprops = fs.rotors[ir]
            current = rprops.Zhub < 0
            if current:
                speed = float(coerce(case, "current_speed", shape=0,
                                     default=1.0))
            elif isinstance(case.get("wind_speed"),
                            (list, tuple, np.ndarray)):
                ws = np.asarray(case["wind_speed"], dtype=float)
                speed = float(ws[min(ifowt, len(ws) - 1)])
            else:
                speed = float(coerce(case, "wind_speed", shape=0,
                                     default=10))
            if rprops.aeroServoMod <= 0 or speed <= 0:
                continue
            f0, f, a, b, info = calc_aero(rot, rprops, case, self.w,
                                          speed=speed, current=current,
                                          device=dev)
            Tn = self._Tn0(ifowt)[int(fs.rotor_node[ir])]   # (6, nDOF)
            out["f_aero0"][:, ir] = Tn.T @ f0
            out["f_aero"] += Tn.T @ f
            out["A_aero"] += np.einsum("ia,ijw,jb->abw", Tn, a, Tn)
            out["B_aero"] += np.einsum("ia,ijw,jb->abw", Tn, b, Tn)
            out["A00"][:, ir] = a[0, 0, :]
            out["B00"][:, ir] = b[0, 0, :]
            out["rotor_info"][ir] = dict(info, speed=speed,
                                         aeroServoMod=rprops.aeroServoMod,
                                         Ng=rot.Ng)
            if current and rot.cpmin is not None:
                out["rotor_info"][ir]["cavitation"] = calc_cavitation(
                    rot, rprops, case, rho=fs.rho_water, g=fs.g, device=dev)
            # gyroscopic damping
            IO = info["q"] * (rprops.I_drivetrain * info["Omega_rpm"]
                              * 2 * np.pi / 60)
            G = np.zeros((6, 6))
            G[3:, 3:] = tf.skew(torch.as_tensor(IO)).numpy()
            out["B_gyro"] += Tn.T @ G @ Tn
        self._aero_cache[key] = out
        return out

    def aero_mean_force(self, case, ifowt=0, device=None):
        """The mean rotor loads of a FOWT in its reduced DOFs (nDOF,)."""
        tc = self.turbine_constants(case, ifowt, device=device)
        return np.sum(tc["f_aero0"], axis=1)

    def bem_excitation(self, case, ifowt=0):
        """Potential-flow wave excitation per heading (nWaves, nDOF, nw)
        complex numpy (the reference's ``bem_excitation``): the
        coefficients interpolated at the heading less the FOWT's
        ``heading_adjust``, rotated by the absolute heading, times the
        wave amplitudes and the array phase ``exp(-i k (x cos b + y sin
        b))``; zero without coefficients."""
        from raft_tpu_torch.io.wamit import interp_heading
        from raft_tpu_torch.models.hydro import make_sea_state

        fs = self.fowtList[ifowt]
        nWaves = (1 if np.isscalar(case.get("wave_heading", 0))
                  else len(case["wave_heading"]))
        F = np.zeros((nWaves, fs.nDOF, self.nw), dtype=np.complex128)
        bem = self.bem_list[ifowt]
        if bem is not None and np.any(np.abs(bem["X_BEM"]) > 0):
            _, zeta, beta = make_sea_state(case, self.w)
            heading = np.atleast_1d(np.degrees(beta))
            for ih in range(nWaves):
                phase = np.exp(-1j * self.k * (
                    fs.x_ref * np.cos(np.radians(heading[ih]))
                    + fs.y_ref * np.sin(np.radians(heading[ih]))))
                X = interp_heading(bem["X_BEM"], bem["headings"],
                                   (heading[ih] - fs.heading_adjust) % 360)
                F[ih, :6, :] = X * zeta[ih] * phase
        return F

    def solve_dynamics(self, case, X0=None, device=None):
        """The drag-linearised response of one case (the reference's
        ``solve_dynamics``, its solveDynamics) on ``device`` (default:
        the current CUDA device; raises without one).

        Each FOWT converges on its own, as one row of
        :func:`~raft_tpu_torch.models.dynamics.solve_dynamics_fowt`: its
        strip excitation at the mean offset, potential-flow and rotor
        terms, the mooring stiffness (``moorMod`` 2: the lumped-mass
        impedance instead), the external QTF's forces on FOWT 0, and for
        ``potSecOrder`` 1 a second solve with the slender-body QTF of its
        RAO (written as ``.4`` / ``.12d`` files to ``outFolderQTF``
        when set).  Then the system impedance, the FOWTs' blocks plus the
        shared network's stiffness, is solved for every heading (the
        solve kernel up to 12 DOFs, ``torch.linalg.solve`` above).

        Returns (Xi (nWaves + 1, nDOF, nw) complex numpy, the last source
        zero, and info: Z, Bmat, S, zeta, exc, tc of FOWT 0 and ``infos``,
        per FOWT S, zeta, exc, tc, dyn_diag and the pose).  Sets
        ``_last_drift_mean`` (nWaves, nDOF), the mean second-order
        forces.  Warns as the reference does when a drag linearisation
        does not converge; raises on a non-finite response."""
        import warnings

        from raft_tpu_torch.models.dynamics import (solve_dynamics_fowt,
                                                    system_response)
        from raft_tpu_torch.utils.dtypes import resolve_device

        dev = resolve_device(device)
        if X0 is None:
            X0 = self.solve_statics(case, device=dev)
        X0 = np.asarray(X0, dtype=float)
        offs = self.dof_offsets
        nw = self.nw
        kw = dict(dtype=torch.float64, device=dev)
        w_t = torch.as_tensor(np.asarray(self.w, dtype=float), **kw)
        nWaves = (1 if np.isscalar(case.get("wave_heading", 0))
                  else len(case["wave_heading"]))
        moor = self._mooring(dev)
        C_units, Ka = moor.parts(torch.as_tensor(X0, **kw)[None])
        Z_blocks, Bmats, infos = [], [], []
        F_waves = [[] for _ in range(nWaves)]
        F_2nd_mean = np.zeros((nWaves, self.nDOF))
        for i, fs in enumerate(self.fowtList):
            fh = self.hydro[i]
            nDOF = fs.nDOF
            pose = fh.pose(X0[offs[i]:offs[i + 1]], dev)
            stat = self.statics(i)
            exc = fh.hydro_excitation(pose, case)
            A_BEM, B_BEM = self.bem_matrices(i)
            F_BEM = torch.as_tensor(self.bem_excitation(case, i)).to(dev)
            tc = self.turbine_constants(case, i, device=dev)
            M_lin = (tc["A_aero"] + stat["M_struc"][:, :, None]
                     + fh.hc0["A_hydro"][:, :, None] + A_BEM)
            B_lin = tc["B_aero"] + B_BEM + tc["B_gyro"][:, :, None]
            C_moor = np.zeros((nDOF, nDOF))
            Z_moor = None
            ms_i = self.ms_list[i]
            if ms_i is not None:
                if (getattr(ms_i, "moorMod", 0) == 2
                        and getattr(ms_i, "m_lin", None) is not None):
                    from raft_tpu_torch.physics.mooring_dynamics import \
                        fowt_mooring_impedance

                    Z6 = fowt_mooring_impedance(
                        ms_i, X0[offs[i]:offs[i] + 6], self.w, self.k,
                        exc["S"][0], exc["beta"][0], self.depth,
                        rho=fs.rho_water, g=fs.g, device=dev)
                    Z_moor = torch.zeros((1, nw, nDOF, nDOF), dtype=Z6.dtype,
                                         device=dev)
                    Z_moor[0, :, :6, :6] = Z6
                else:
                    C_moor[:6, :6] += C_units[i]
            C_lin = stat["C_struc"] + stat["C_hydro"] + C_moor \
                + stat["C_elast"]
            F_lin = F_BEM[0] + exc["F_hydro_iner"][0]
            F_2nd = torch.zeros((nWaves, nDOF, nw), dtype=F_lin.dtype,
                                device=dev)
            if self.qtf is not None and i == 0:
                from raft_tpu_torch.physics.secondorder import \
                    hydro_force_2nd

                for ih in range(nWaves):
                    fm, f2 = hydro_force_2nd(self.qtf, exc["beta"][ih],
                                             exc["S"][ih], self.w)
                    F_2nd[ih, :6, :] += torch.as_tensor(f2[:6]).to(dev)
                    F_2nd_mean[ih, offs[i]:offs[i] + 6] = fm[:6]
                F_lin = F_lin + F_2nd[0]
            d = fh._on(dev)
            lin = [torch.as_tensor(np.asarray(a, dtype=float), **kw)[None]
                   for a in (M_lin, B_lin, C_lin)]

            def fixed_point(F_lin):
                return solve_dynamics_fowt(
                    d["site"], d["ss"], pose.hc, exc["u"][0], *lin,
                    F_lin[None], w_t, pose.Tn, pose.r_nodes,
                    n_iter=self.nIter, Xi_start=self.XiStart,
                    n_iter_extra=self.nIterExtra, Z_extra=Z_moor)

            Z_i, Xi_i, Bmat, dyn_diag = fixed_point(F_lin)
            trips = dyn_diag["trips"] + 1
            if fs.potSecOrder == 1 and self.w1_2nd is not None:
                F_lin = F_lin + self._slender_forces(
                    i, exc, Xi_i[0], F_2nd, F_2nd_mean, dev)
                Z_i, Xi_i, Bmat, dyn_diag = fixed_point(F_lin)
                trips += dyn_diag["trips"] + 1
            dyn_diag = dict(dyn_diag, solves=trips)
            Z_blocks.append(Z_i[0])
            Bmats.append(Bmat)
            if not bool(dyn_diag["drag_converged"][0]):
                warnings.warn(
                    "solveDynamics drag linearisation did not converge to "
                    "tolerance (residual "
                    f"{float(dyn_diag['drag_resid'][0]):.2e}) for FOWT {i}")
            infos.append(dict(S=exc["S"], zeta=exc["zeta"], exc=exc, tc=tc,
                              dyn_diag=dyn_diag, pose=pose))
            for ih in range(nWaves):
                F_drag = fh.drag_excitation(pose, Bmat, exc["u"][ih])
                F_waves[ih].append(F_BEM[ih] + exc["F_hydro_iner"][ih]
                                   + F_drag + F_2nd[ih])
        self._last_drift_mean = F_2nd_mean

        # the system impedance: the FOWTs' blocks plus the shared
        # network's stiffness at X0
        Z_sys = torch.zeros((nw, self.nDOF, self.nDOF),
                            dtype=Z_blocks[0].dtype, device=dev)
        for i in range(self.nFOWT):
            Z_sys[:, offs[i]:offs[i + 1], offs[i]:offs[i + 1]] += Z_blocks[i]
        if Ka is not None:
            for i in range(self.nFOWT):
                for j in range(self.nFOWT):
                    Z_sys[:, offs[i]:offs[i] + 6, offs[j]:offs[j] + 6] += \
                        Ka[6 * i:6 * i + 6, 6 * j:6 * j + 6][None]
        F_sys = torch.stack([torch.cat(Fw, dim=0) for Fw in F_waves])
        Xi = system_response(Z_sys, F_sys)
        if not bool(torch.all(torch.isfinite(torch.abs(Xi)))):
            raise RuntimeError(
                "NaN detected in response vector Xi (solveDynamics guard)")
        Xi = torch.cat([Xi, torch.zeros((1, self.nDOF, nw), dtype=Xi.dtype,
                                        device=dev)]).cpu().numpy()
        info0 = infos[0]
        return Xi, dict(Z=Z_sys, Bmat=Bmats[0], S=info0["S"],
                        zeta=info0["zeta"], exc=info0["exc"], tc=info0["tc"],
                        infos=infos)

    def _slender_forces(self, i, exc, Xi_i, F_2nd, F_2nd_mean, dev):
        """The potSecOrder 1 step of :meth:`solve_dynamics` for FOWT i:
        the slender-body QTF of its converged RAO at the first heading,
        written to ``outFolderQTF`` when set (``.4`` RAO and ``.12d``
        QTF, the case number in their names), and its forces added to
        F_2nd (nWaves, nDOF, nw) and F_2nd_mean in place.  Returns the
        first heading's forces, which join the fixed point's
        excitation."""
        from raft_tpu_torch.ops.waves import get_rao
        from raft_tpu_torch.physics.secondorder import hydro_force_2nd

        fs = self.fowtList[i]
        offs = self.dof_offsets
        beta0 = float(exc["beta"][0])
        RAO = get_rao(Xi_i[:6], torch.as_tensor(exc["zeta"][0]).to(
            dev).to(Xi_i.dtype)).cpu().numpy()
        qtf = self.qtf_slender(beta0, Xi0=RAO, ifowt=i,
                               device=dev).cpu().numpy()
        qtf_data = dict(w_2nd=self.w1_2nd, heads_rad=np.asarray([beta0]),
                        qtf=qtf)
        if self.out_folder_qtf:
            from raft_tpu_torch.io.wamit import write_rao_4
            from raft_tpu_torch.physics.secondorder import write_qtf_12d

            os.makedirs(self.out_folder_qtf, exist_ok=True)
            whead = float(np.degrees(beta0))
            iCase = getattr(self, "_current_case_index", None)
            tag = (f"Head{whead:.0f}_WT{i}" if iCase is None
                   else f"Head{whead:.0f}_Case{iCase + 1}_WT{i}")
            write_rao_4(os.path.join(self.out_folder_qtf,
                                     f"raos-slender_body_{tag}.4"),
                        self.w, RAO, beta_deg=whead)
            write_qtf_12d(os.path.join(
                self.out_folder_qtf, f"qtf-slender_body-total_{tag}.12d"),
                qtf, self.w1_2nd, np.asarray([beta0]), rho=fs.rho_water,
                g=fs.g)
        for ih in range(F_2nd.shape[0]):
            fm, f2 = hydro_force_2nd(qtf_data, exc["beta"][ih],
                                     exc["S"][ih], self.w)
            F_2nd[ih, :6, :] += torch.as_tensor(f2[:6]).to(dev)
            F_2nd_mean[ih, offs[i]:offs[i] + 6] += fm[:6]
        return F_2nd[0]

    def solve_eigen(self, case=None, device=None):
        """Natural frequencies [Hz] and modes (the reference's
        ``solve_eigen``, its solveEigen) at the last statics' mean
        offsets (solved for ``case`` on ``device`` when there are
        none): host ``np.linalg.eig`` of M^-1 C with the zero-frequency
        added mass and the mooring stiffness there.  Rigid systems take
        the reference's DOF-claiming sort of the modes, others the
        ascending one.  Raises on a non-positive eigenvalue."""
        from raft_tpu_torch.utils.dtypes import resolve_device

        X0 = getattr(self, "X0", None)
        if X0 is None:
            X0 = self.solve_statics(case, device=device)
        dev = resolve_device(device)
        offs = self.dof_offsets
        M_tot = np.zeros((self.nDOF, self.nDOF))
        C_tot = np.zeros((self.nDOF, self.nDOF))
        for i, fs in enumerate(self.fowtList):
            stat = self.statics(i)
            A_BEM, _ = self.bem_matrices(i)
            sl = slice(offs[i], offs[i + 1])
            M_tot[sl, sl] += (np.asarray(stat["M_struc"])
                              + np.asarray(self.hydro[i].hc0["A_hydro"])
                              + A_BEM[:, :, 0])
            C_tot[sl, sl] += (np.asarray(stat["C_struc"])
                              + np.asarray(stat["C_hydro"])
                              + np.asarray(stat["C_elast"]))
            C_tot[offs[i] + 5, offs[i] + 5] += fs.yaw_stiffness
        _, C_moor = self._mooring(dev)(torch.as_tensor(
            np.asarray(X0), dtype=torch.float64, device=dev)[None])
        C_tot += C_moor[0].cpu().numpy()

        eigenvals, eigenvectors = np.linalg.eig(np.linalg.solve(M_tot, C_tot))
        if np.any(eigenvals.real <= 0.0):
            raise RuntimeError("zero or negative system eigenvalues detected")
        if not all(f.nDOF == 6 for f in self.fowtList):
            order = np.argsort(eigenvals.real)
            fns = np.sqrt(eigenvals[order].real) / 2.0 / np.pi
            return fns, eigenvectors[:, order]
        # the DOF-claiming sort: from the last DOF down, each DOF claims
        # the unclaimed mode with its largest component
        nDOF = self.nDOF
        ind_list = []
        for i in range(nDOF - 1, -1, -1):
            vec = np.abs(eigenvectors[i, :]).copy()
            for _ in range(nDOF):
                ind = int(np.argmax(vec))
                if ind in ind_list:
                    vec[ind] = 0.0
                else:
                    ind_list.append(ind)
                    break
        ind_list.reverse()
        fns = np.sqrt(eigenvals[ind_list].real) / 2.0 / np.pi
        return fns, eigenvectors[:, ind_list]

    def calc_outputs(self, device=None):
        """System properties and eigen outputs (the reference's
        ``calc_outputs``, its calcOutputs): ``results['properties']``
        (masses, centres, inertias, buoyancy, the hydrostatic and system
        stiffness with the unloaded mooring's) and
        ``results['eigen']`` (frequencies and modes) at the unloaded
        equilibrium, solved on ``device``.  Returns the results dict."""
        from raft_tpu_torch.utils.dtypes import resolve_device

        dev = resolve_device(device)
        fs = self.fowtList[0]
        stat = self.statics(0)
        if not hasattr(self, "results"):
            self.results = {}
        props = self.results.setdefault("properties", {})

        X0 = self.solve_statics(None, device=dev)
        F_moor0, C_moor0 = self._mooring(dev)(
            torch.as_tensor(X0, dtype=torch.float64, device=dev)[None])
        F_moor0 = F_moor0[0].cpu().numpy()[:6]
        C_moor0 = C_moor0[0].cpu().numpy()[:6, :6]

        props["tower mass"] = np.asarray(stat["mtower"])
        props["tower CG"] = np.asarray(stat["rCG_tow"])
        props["substructure mass"] = float(stat["m_sub"])
        props["substructure CG"] = np.asarray(stat["rCG_sub"])
        props["shell mass"] = float(sum(m.mshell for m in fs.members
                                        if m.part_of == "platform"))
        props["ballast mass"] = np.asarray(stat["m_ballast"])
        props["ballast densities"] = np.asarray(stat["pb"])
        props["total mass"] = float(np.asarray(stat["M_struc"])[0, 0])
        props["total CG"] = np.asarray(stat["rCG"])
        # the substructure's inertias about its own CG
        M_subCG = tf.translate_matrix_6to6(
            torch.as_tensor(np.asarray(stat["M_sub6"], dtype=float)),
            -torch.as_tensor(np.asarray(stat["rCG_sub"], dtype=float))
        ).numpy()
        props["roll inertia at subCG"] = M_subCG[3, 3]
        props["pitch inertia at subCG"] = M_subCG[4, 4]
        props["yaw inertia at subCG"] = M_subCG[5, 5]
        props["buoyancy (pgV)"] = fs.rho_water * fs.g * float(stat["V"])
        props["center of buoyancy"] = np.asarray(stat["rCB"])
        props["C hydrostatic"] = np.asarray(stat["C_hydro"])[:6, :6]
        props["C system"] = np.asarray(
            stat["C_struc"] + stat["C_hydro"] + stat["C_elast"])[:6, :6] \
            + C_moor0
        props["F_lines0"] = F_moor0
        props["C_lines0"] = C_moor0
        props["M support structure"] = np.asarray(
            stat["M_struc_sub"])[:6, :6]
        A_BEM, _ = self.bem_matrices(0)
        props["A support structure"] = (
            np.asarray(self.hydro[0].hc0["A_hydro"])[:6, :6]
            + A_BEM[:6, :6, -1])
        props["C support structure"] = np.asarray(
            stat["C_struc_sub"] + stat["C_hydro"])[:6, :6] + C_moor0

        fns, modes = self.solve_eigen(device=dev)
        self.results["eigen"] = {"frequencies": np.asarray(fns),
                                 "modes": np.asarray(modes)}
        return self.results

    def write_modes_json(self, filename, fns=None, modes=None, ifowt=0,
                         device=None):
        """Write eigenmodes in the viz3Danim JSON layout
        (:func:`raft_tpu_torch.models.outputs.write_modes_json`; solved
        here on ``device`` when not given)."""
        from raft_tpu_torch.models.outputs import write_modes_json

        if fns is None or modes is None:
            fns, modes = self.solve_eigen(device=device)
        write_modes_json(self, filename, np.asarray(fns), np.asarray(modes),
                         ifowt=ifowt)

    def wake_coupling(self, u_grid=None, device=None):
        """The farm's wake coupling on this model's own power and thrust
        curves (:class:`raft_tpu_torch.physics.wake.WakeCoupling`: its
        equilibrium and AEP), kept as ``self.wake``."""
        from raft_tpu_torch.physics.wake import WakeCoupling

        self.wake = WakeCoupling(self, u_grid=u_grid, device=device)
        return self.wake

    def analyze_cases(self, device=None):
        """Every case of the design's case table (the reference's
        ``analyze_cases``, its analyzeCases) on ``device`` (default: the
        current CUDA device; raises without one): the statics, the
        dynamics, for a second-order design the equilibrium again with
        the mean drift, then each FOWT's channel statistics.  Returns
        ``results`` with ``case_metrics[iCase][iFOWT]``,
        ``mean_offsets`` and, per case, ``statics_status`` and each
        FOWT's drag-linearisation diagnostics (``dyn_diag``).  Per case,
        ``case_stats`` keeps the wall seconds of its statics (both
        equilibria), dynamics (second-order forces and line dynamics
        included) and outputs, its Newton iterations, each FOWT's
        fixed-point solves and the system response's size."""
        import time

        from raft_tpu_torch.models.outputs import turbine_outputs
        from raft_tpu_torch.utils.dtypes import resolve_device

        dev = resolve_device(device)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        self.results = {"freq_rad": self.w, "case_metrics": {},
                        "mean_offsets": [], "statics_status": [],
                        "dyn_diag": []}
        self.case_stats = []
        second_order = self.qtf is not None or (
            self.w1_2nd is not None
            and any(fs.potSecOrder == 1 for fs in self.fowtList))
        for iCase, case in enumerate(self.cases):
            self._current_case_index = iCase
            t0 = time.perf_counter()
            X0 = self.solve_statics(case, device=dev)
            st_status, st_iter = self.statics_status, self.statics_iterations
            sync()
            t1 = time.perf_counter()
            Xi, info = self.solve_dynamics(case, X0=X0, device=dev)
            poses = [inf["pose"] for inf in info["infos"]]
            sync()
            t2 = time.perf_counter()
            if second_order:
                # the mean drift moves the reported equilibrium; the
                # reference's hydro objects are back at the zero pose
                # when its outputs run
                X0 = self.solve_statics(
                    case, extra_force=np.sum(self._last_drift_mean, axis=0),
                    device=dev)
                st_iter += self.statics_iterations
                poses = [self.hydro[i].pose(np.zeros(fs.nDOF), dev)
                         for i, fs in enumerate(self.fowtList)]
            sync()
            t3 = time.perf_counter()
            self.results["mean_offsets"].append(np.asarray(X0))
            self.results["statics_status"].append(st_status)
            self.results["dyn_diag"].append([
                {k: (int(dd[k][0]) if k in ("status", "n_iter_drag")
                     else bool(dd[k][0]) if k == "drag_converged"
                     else float(dd[k][0]))
                 for k in ("status", "n_iter_drag", "drag_converged",
                           "drag_resid")}
                for dd in (inf["dyn_diag"] for inf in info["infos"])])
            metrics = {}
            offs = self.dof_offsets
            for i in range(self.nFOWT):
                tc_i = info["infos"][i]["tc"]
                metrics[i] = turbine_outputs(
                    self, case, X0[offs[i]:offs[i + 1]],
                    Xi[:, offs[i]:offs[i + 1], :], info["infos"][i]["S"],
                    info["infos"][i]["zeta"], poses[i],
                    A_aero=tc_i["A00"].T, B_aero=tc_i["B00"].T,
                    f_aero0=tc_i["f_aero0"], ifowt=i,
                    rotor_info=tc_i.get("rotor_info"), device=dev)
            self.results["case_metrics"][iCase] = metrics
            sync()
            t4 = time.perf_counter()
            self.case_stats.append(dict(
                statics_s=(t1 - t0) + (t3 - t2), dynamics_s=t2 - t1,
                outputs_s=t4 - t3, newton_iterations=st_iter,
                fixed_point_solves=[inf["dyn_diag"]["solves"]
                                    for inf in info["infos"]],
                system_n=self.nDOF))
        self._current_case_index = None
        return self.results


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


class ModelMooring:
    """``mooring_fn(X) -> (F, C)`` of a model's moorings at poses X (R,
    nDOF) (the reference's ``_mooring_closures``, force and stiffness
    from one evaluation): each FOWT's own catenary system (one row of the
    catenary on its first six DOFs) or one-body network, then the array's
    shared network over every unit, whose coupled stiffness couples the
    units' blocks.  :meth:`parts` gives at one pose the units' own
    6 x 6 stiffness (numpy, per FOWT, None where it has no mooring) and
    the shared network's (6 nF, 6 nF) tensor or None: the system
    impedance takes them apart.  It reuses the last evaluation when that
    was at the same pose (the statics' final one, at X0), where the
    reference evaluates the stiffness again."""

    def __init__(self, model, device):
        from raft_tpu_torch.physics.mooring import MooringNetwork

        self.offs = model.dof_offsets
        self.nDOF = model.nDOF
        self.nF = model.nFOWT
        self.units = [(i, ms if isinstance(ms, MooringNetwork)
                       else ms.to(device))
                      for i, ms in enumerate(model.ms_list) if ms is not None]
        self.shared = model.ms_array
        self._last = None

    def _evaluate(self, X):
        from raft_tpu_torch.physics import mooring

        R = X.shape[0]
        offs = self.offs
        F = torch.zeros_like(X)
        C = torch.zeros((R, self.nDOF, self.nDOF), dtype=X.dtype,
                        device=X.device)
        C_units = [None] * self.nF
        for i, ms in self.units:
            o = offs[i]
            X6 = X[:, o:o + 6]
            if isinstance(ms, mooring.MooringNetwork):
                out = ms.solve(X6[:, None])
                Fi, Ci = out["F"][:, 0], out["K"]
            else:
                Fi, Ci = mooring.line_forces_and_stiffness(
                    *mooring.line_args(ms, X6), X6)
            F[:, o:o + 6] += Fi
            C[:, o:o + 6, o:o + 6] += Ci
            C_units[i] = Ci
        Ka = None
        if self.shared is not None:
            nb = self.shared.n_bodies
            out = self.shared.solve(torch.stack(
                [X[:, offs[i]:offs[i] + 6] for i in range(nb)], dim=1))
            Ka = out["K"]
            for i in range(nb):
                F[:, offs[i]:offs[i] + 6] += out["F"][:, i]
                for j in range(nb):
                    C[:, offs[i]:offs[i] + 6, offs[j]:offs[j] + 6] += \
                        Ka[:, 6 * i:6 * i + 6, 6 * j:6 * j + 6]
        self._last = (X.clone(), F, C, C_units, Ka)
        return F, C, C_units, Ka

    def __call__(self, X):
        F, C, _, _ = self._evaluate(X)
        return F, C

    def parts(self, X):
        last = self._last
        if (last is not None and last[0].shape == X.shape
                and torch.equal(last[0], X)):
            C_units, Ka = last[3], last[4]
        else:
            _, _, C_units, Ka = self._evaluate(X)
        return ([None if c is None else c[0].cpu().numpy()
                 for c in C_units], None if Ka is None else Ka[0])
