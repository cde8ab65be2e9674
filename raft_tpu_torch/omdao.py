"""Design-optimisation surface: the WEIS / OpenMDAO-facing evaluation
(counterpart of ``raft_tpu/omdao.py``).

One ``compute`` call is one design evaluation: build the model, solve
the statics and dynamics over its case table, and return flat outputs
(platform properties, response statistics, natural periods, WEIS
aggregates).

* :class:`DesignEvaluation` — a design dict or file in, flat metrics
  out, for optimizer loops.  An unchanged design runs its cases through
  the batched farm, full or flexible evaluator (one call per case not
  already in its result cache), or through ``Model.analyze_cases``;
  dotted-path overrides rebuild the model and take ``analyze_cases``.
* :class:`RAFT_OMDAO_Core` — the WEIS flat-I/O contract: about 150 flat
  named inputs rebuilt into the nested design, analysed, and flattened
  into WEIS's outputs.
* ``RAFT_TPU_Component`` — an OpenMDAO ``ExplicitComponent`` over
  :class:`DesignEvaluation` where ``openmdao`` imports, else None.

Every entry runs on ``device`` (default: the current CUDA device; it
raises without one unless ``device="cpu"`` is passed).
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def traced_route(model, use_traced=True):
    """The route of an unchanged design: ``"farm"``, ``"full"`` or
    ``"flexible"`` where the batched evaluator of that name takes the
    model and every case of its table lies in
    :func:`~raft_tpu_torch.api.case_in_traced_domain`, else ``"host"``
    (``Model.analyze_cases``).

    The conditions are those under which the reference's evaluator
    factories accept a model: the farm evaluator takes arrays of rigid
    units without potential-flow coefficients or an external QTF, the
    full evaluator any single rigid FOWT, the flexible evaluator a
    single N-DOF structure without either.  ``model.bem_list`` is read
    only where the reference reads it (it may run the panel solver)."""
    from raft_tpu_torch.api import case_in_traced_domain

    if not use_traced or not all(case_in_traced_domain(c)
                                 for c in model.cases):
        return "host"
    if model.nFOWT > 1:
        ok = (all(fs.is_single_body for fs in model.fowtList)
              and all(b is None for b in model.bem_list)
              and model.qtf is None)
        return "farm" if ok else "host"
    if model.fowtList[0].is_single_body:
        return "full"
    ok = all(b is None for b in model.bem_list) and model.qtf is None
    return "flexible" if ok else "host"


class DesignEvaluation:
    """One design in, flat metrics out, for optimizer loops.

    ``base_design`` is a design dict or a ``.json`` / ``.yaml`` path (a
    path's directory resolves the design's relative data files).  An
    unchanged design (no overrides) takes the route of
    :func:`traced_route`: its cases run one at a time through the
    batched evaluator, their outputs X0, Xi, S and zeta land in a
    content-addressed :class:`~raft_tpu_torch.serve.cache.ResultCache`
    (design fingerprint + exact case values), and a repeated iterate
    reads them back bit-identically without calling the evaluator.
    Dotted-path overrides rebuild the model and run
    ``Model.analyze_cases``, as does the host route.

    ``cache_mb`` is the cache's budget (default
    ``RAFT_TPU_SERVE_CACHE_MB``); ``device`` is resolved once and every
    model and evaluator call runs there.  :attr:`diag` reports the
    cache's counters; :attr:`route` the route taken (None before the
    first unchanged-design call); :attr:`n_evaluations` the evaluator
    calls made; :attr:`model` the Model the last call evaluated."""

    #: the evaluator outputs the metric chain reads (and the result
    #: cache stores per case)
    _CACHE_KEYS = ("X0", "Xi", "S", "zeta")

    def __init__(self, base_design, use_traced=True, cache_mb=None,
                 device=None):
        import os

        from raft_tpu_torch.serve.cache import ResultCache
        from raft_tpu_torch.structure.schema import load_design
        from raft_tpu_torch.utils import config
        from raft_tpu_torch.utils.dtypes import resolve_device

        self.device = resolve_device(device)
        self._base_dir = (os.path.dirname(os.path.abspath(base_design))
                          if isinstance(base_design, str) else None)
        self.base_design = load_design(base_design)
        self.use_traced = use_traced
        self._fast = None   # (model, evaluator or None, route)
        if cache_mb is None:
            cache_mb = float(config.get("SERVE_CACHE_MB"))
        self._cache = ResultCache(int(cache_mb * 1e6),
                                  metrics_prefix="omdao_cache")
        self._design_fp = None
        self.n_evaluations = 0
        self.model = None

    @property
    def diag(self):
        """The result cache's counters, ``cache_<name>``."""
        return {f"cache_{k}": v for k, v in self._cache.stats().items()}

    @property
    def route(self):
        return None if self._fast is None else self._fast[2]

    # ---------------------------------------------------- batched route

    def _fast_model(self):
        """(model, evaluator, route) of the base design, made once; the
        evaluator is None on the host route.  Only the evaluator the
        route names is built, and nothing is caught: a build or launch
        failure propagates."""
        if self._fast is not None:
            return self._fast
        from raft_tpu_torch.api import (make_farm_evaluator,
                                        make_flexible_evaluator,
                                        make_full_evaluator)
        from raft_tpu_torch.models.model import Model

        model = Model(copy.deepcopy(self.base_design),
                      base_dir=self._base_dir)
        route = traced_route(model, self.use_traced)
        make = {"farm": make_farm_evaluator, "full": make_full_evaluator,
                "flexible": make_flexible_evaluator}.get(route)
        evaluate = None if make is None else make(model, device=self.device)
        self._fast = (model, evaluate, route)
        return self._fast

    def _evaluate_cached(self, evaluate, traced_case):
        """One case through the result cache: X0, Xi, S and zeta of the
        evaluator's single row as host numpy, stored under the case's
        content key, or read back when the key is there."""
        from raft_tpu_torch.aot.bank import content_fingerprint
        from raft_tpu_torch.serve.cache import result_cache_key

        if self._design_fp is None:
            self._design_fp = content_fingerprint(self.base_design)
        key = result_cache_key(self._design_fp, traced_case,
                               self._CACHE_KEYS)
        row = self._cache.get(key)
        if row is None:
            rows = {k: np.asarray(v, dtype=float)[None]
                    for k, v in traced_case.items()}
            with torch.no_grad():
                out = evaluate(**rows)
            self.n_evaluations += 1
            row = {k: out[k][0].cpu().numpy() for k in self._CACHE_KEYS}
            self._cache.put(key, row)
        return row

    def _compute_traced(self, model, evaluate):
        """``model.results['case_metrics']`` from the batched evaluator:
        X0 and Xi per case, the channel statistics by the host path's
        ``turbine_outputs``.  Its pose is each FOWT's zero pose: the
        reference's outputs read the pose its hydro objects hold, and on
        this route nothing moves them from it."""
        from raft_tpu_torch.api import case_to_traced
        from raft_tpu_torch.models.outputs import turbine_outputs

        dev = self.device
        model.results = {"case_metrics": {}, "mean_offsets": []}
        offs = model.dof_offsets
        poses = [model.hydro[i].pose(np.zeros(fs.nDOF), dev)
                 for i, fs in enumerate(model.fowtList)]
        for iCase, case in enumerate(model.cases):
            out = self._evaluate_cached(evaluate, case_to_traced(case))
            X0, Xi = out["X0"], out["Xi"]
            model.results["case_metrics"][iCase] = {}
            for i in range(model.nFOWT):
                tc = model.turbine_constants(case, ifowt=i, device=dev)
                model.results["case_metrics"][iCase][i] = turbine_outputs(
                    model, case, X0[offs[i]:offs[i + 1]],
                    Xi[:, offs[i]:offs[i + 1], :], out["S"], out["zeta"],
                    poses[i], A_aero=np.asarray(tc["A00"]).T,
                    B_aero=np.asarray(tc["B00"]).T, f_aero0=tc["f_aero0"],
                    ifowt=i, rotor_info=tc.get("rotor_info"), device=dev)
            model.results["mean_offsets"].append(X0)
        return model.results

    def compute(self, overrides=None):
        """Evaluate a design variant.

        ``overrides``: dotted design path -> value, e.g.
        ``{"platform.members.0.d": [...], "mooring.lines.0.length": 870}``.
        Returns the flat outputs: ``properties_*``, per case and FOWT
        ``stats_<channel>_<avg|std|max>_case<i>_fowt<j>`` (and
        ``stats_Tmoor_max_...``), ``rigid_body_periods``, and the WEIS
        aggregates ``Max_Offset`` and ``Max_PtfmPitch``."""
        from raft_tpu_torch.models.model import Model

        dev = self.device
        if not overrides:
            model, evaluate, _ = self._fast_model()
            if evaluate is not None:
                self._compute_traced(model, evaluate)
            elif "case_metrics" not in getattr(model, "results", {}):
                model.analyze_cases(device=dev)
        else:
            design = copy.deepcopy(self.base_design)
            for path, value in overrides.items():
                node = design
                keys = path.split(".")
                for k in keys[:-1]:
                    node = node[int(k)] if isinstance(node, list) else node[k]
                k = keys[-1]
                if isinstance(node, list):
                    node[int(k)] = value
                else:
                    node[k] = value
            model = Model(design, base_dir=self._base_dir)
            model.analyze_cases(device=dev)
        self.model = model
        stat = model.statics(0)

        out = {
            "properties_substructure_mass": float(stat["m_sub"]),
            "properties_total_mass": float(stat["m"]),
            "properties_displacement": float(stat["V"]),
            "properties_AWP": float(stat["AWP"]),
            "properties_center_of_mass": np.asarray(stat["rCG"]),
            "properties_center_of_buoyancy": np.asarray(stat["rCB"]),
            "properties_metacentric_height": float(stat["rM"][2]
                                                   - stat["rCG"][2]),
        }

        # natural periods: case-independent, kept on the model for the
        # repeat calls
        fns = getattr(model, "_eigen_fns_cache", None)
        if fns is None:
            fns, _ = model.solve_eigen(device=dev)
            model._eigen_fns_cache = np.asarray(fns)
        out["rigid_body_periods"] = 1.0 / np.maximum(np.asarray(fns), 1e-12)

        max_offset = 0.0
        max_pitch = 0.0
        for iCase, per_fowt in model.results["case_metrics"].items():
            for ifowt, m in per_fowt.items():
                for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"):
                    for s in ("avg", "std", "max"):
                        out[f"stats_{ch}_{s}_case{iCase}_fowt{ifowt}"] = float(
                            m[f"{ch}_{s}"])
                off = np.hypot(float(m["surge_max"]), float(m["sway_max"]))
                max_offset = max(max_offset, off)
                max_pitch = max(max_pitch, abs(float(m["pitch_max"])))
                if "Tmoor_avg" in m:
                    out[f"stats_Tmoor_max_case{iCase}_fowt{ifowt}"] = float(
                        np.max(np.asarray(m["Tmoor_max"])))
        out["Max_Offset"] = max_offset
        out["Max_PtfmPitch"] = max_pitch
        return out


class RAFT_OMDAO_Core:
    """The WEIS flat-I/O contract without the openmdao dependency.

    :meth:`build_design` rebuilds the nested design from WEIS's flat
    named inputs (``turbine_*``, ``rotor_*``, ``blade_*``,
    ``airfoils_*``, ``platform_member<i>_*``, ``rigid_body_<k>_*``,
    ``mooring_*``) and its option dicts; :meth:`compute` analyses it and
    returns the flat outputs (``properties_*``, ``stats_*`` over the
    cases, the natural periods, the WEIS aggregates ``Max_Offset``,
    ``heave_avg``, ``Max_PtfmPitch``, ``Std_PtfmPitch``,
    ``max_nac_accel``, ``max_tower_base``, ``rotor_overspeed`` and the
    ``platform_*`` properties).  ``device`` as everywhere in the port;
    :attr:`model` is the Model the last :meth:`compute` analysed.
    """

    def __init__(self, modeling_options, analysis_options, turbine_options,
                 mooring_options, member_options, device=None):
        self.modeling_opt = modeling_options
        self.analysis_options = analysis_options
        self.turbine_opt = turbine_options
        self.mooring_opt = mooring_options
        self.members_opt = member_options
        self.device = device
        self.model = None

    # ------------------------------------------------------------- build
    def build_design(self, inputs, discrete_inputs=None):
        """Flat inputs -> the nested design dict; sets :attr:`case_mask`
        (which rows of ``raft_dlcs`` are kept: the NTM / ETM / EWM
        spectral-wind cases)."""
        modeling_opt = self.modeling_opt
        turbine_opt = self.turbine_opt
        members_opt = self.members_opt
        mooring_opt = self.mooring_opt
        discrete_inputs = discrete_inputs or {}

        def arr(k):
            return np.atleast_1d(np.asarray(inputs[k], dtype=float))

        def arr2(k):
            return np.asarray(inputs[k], dtype=float)

        def val(k):
            return float(arr(k)[0])

        upwind = str(discrete_inputs.get(
            "rotor_orientation", inputs.get("rotor_orientation", "upwind"))
        ) == "upwind"
        sgn = -1.0 if upwind else 1.0

        design = {
            "type": ["input dictionary for RAFT"],
            "name": [self.analysis_options["general"]["fname_output"]],
            "comments": ["none"],
            "settings": {
                "XiStart": float(modeling_opt["xi_start"]),
                "min_freq": float(modeling_opt["min_freq"]),
                "max_freq": float(modeling_opt["max_freq"]),
                "nIter": int(modeling_opt["nIter"]),
            },
            "site": {
                "water_depth": val("mooring_water_depth"),
                "rho_air": val("rho_air"),
                "rho_water": val("rho_water"),
                "mu_air": val("mu_air"),
                "shearExp": val("shear_exp"),
            },
        }

        t = {
            "mRNA": val("turbine_mRNA"),
            "IxRNA": val("turbine_IxRNA"),
            "IrRNA": val("turbine_IrRNA"),
            "xCG_RNA": val("turbine_xCG_RNA"),
            "hHub": val("turbine_hHub"),
            "overhang": val("turbine_overhang") * sgn,
            "Fthrust": val("turbine_Fthrust"),
            "yaw_stiffness": val("turbine_yaw_stiffness"),
            "gear_ratio": val("gear_ratio"),
            "nBlades": int(discrete_inputs.get("nBlades",
                                               inputs.get("nBlades", 3))),
            "shaft_tilt": val("tilt") * sgn,
            "precone": val("precone") * sgn,
            "Zhub": val("wind_reference_height"),
            "Rhub": val("hub_radius"),
            "I_drivetrain": val("rotor_inertia"),
        }
        design["turbine"] = t

        # tower member (rA below rB; flipped for a submerged rotor)
        rA = arr2("turbine_tower_rA")
        rB = arr2("turbine_tower_rB")
        if rA[2] > rB[2]:
            rA, rB = rB, rA
        tow = {
            "name": "tower", "type": "rigid", "rA": rA, "rB": rB,
            "shape": turbine_opt["shape"],
            "gamma": val("turbine_tower_gamma"),
            "stations": arr2("turbine_tower_stations"),
            "rho_shell": val("turbine_tower_rho_shell"),
        }
        for key, scalar in (("d", turbine_opt["scalar_diameters"]),
                            ("t", turbine_opt["scalar_thicknesses"])):
            v = arr2(f"turbine_tower_{key}")
            tow[key] = float(np.atleast_1d(v)[0]) if scalar else v
        for key in ("Cd", "Ca", "CdEnd", "CaEnd"):
            v = arr2(f"turbine_tower_{key}")
            tow[key] = (float(np.atleast_1d(v)[0])
                        if turbine_opt["scalar_coefficients"] else v)
        t["tower"] = tow

        # blade and airfoils
        t["blade"] = {
            "geometry": np.c_[arr2("blade_r"), arr2("blade_chord"),
                              arr2("blade_theta"), arr2("blade_precurve"),
                              arr2("blade_presweep")],
            "Rtip": val("blade_Rtip"),
            "precurveTip": val("blade_precurveTip"),
            "presweepTip": val("blade_presweepTip"),
            "airfoils": [
                [float(ap), nm] for ap, nm in zip(
                    np.atleast_1d(arr2("airfoils_position")),
                    turbine_opt["af_used_names"])],
        }
        n_af = turbine_opt["n_af"]
        n_aoa = len(arr2("airfoils_aoa"))

        # polars arrive as (n_af, n_aoa, n_Re) or squeezed (n_af, n_aoa)
        def tab3(k):
            return np.asarray(inputs[k], dtype=float).reshape(
                n_af, -1)[:, :n_aoa]

        cl = tab3("airfoils_cl")
        cd = tab3("airfoils_cd")
        cm = tab3("airfoils_cm")
        aoa = arr2("airfoils_aoa")
        t["airfoils"] = []
        for i in range(n_af):
            t["airfoils"].append({
                "name": turbine_opt["af_used_names"][i],
                "relative_thickness": float(arr2("airfoils_r_thick")[i]),
                "data": np.c_[aoa, cl[i], cd[i], cm[i]],
            })

        t["pitch_control"] = {
            "GS_Angles": arr2("rotor_PC_GS_angles"),
            "GS_Kp": arr2("rotor_PC_GS_Kp"),
            "GS_Ki": arr2("rotor_PC_GS_Ki"),
            "Fl_Kp": val("Fl_Kp"),
        }
        t["torque_control"] = {"VS_KP": val("rotor_TC_VS_Kp"),
                               "VS_KI": val("rotor_TC_VS_Ki")}
        t["wt_ops"] = {
            "v": arr2("rotor_powercurve_v"),
            "omega_op": arr2("rotor_powercurve_omega_rpm"),
            "pitch_op": arr2("rotor_powercurve_pitch"),
        }

        # platform members, trimmed to their ghost-segment-free span
        p = {"potModMaster": int(modeling_opt["potential_model_override"]),
             "dlsMax": float(modeling_opt["dls_max"])}
        if p["potModMaster"] == 3:
            p["potFirstOrder"] = 1
            p["hydroPath"] = modeling_opt["BEM_dir"]
        design["platform"] = p
        nmembers = members_opt["nmembers"]
        member_shapes = members_opt["shape"]
        scalar_d = members_opt["scalar_diameters"]
        scalar_t = members_opt["scalar_thicknesses"]
        scalar_c = members_opt["scalar_coefficients"]
        p["members"] = []
        for i in range(nmembers):
            mn = f"platform_member{i+1}_"
            shape = member_shapes[i]
            rA_0 = arr2(mn + "rA")
            rB_0 = arr2(mn + "rB")
            sA = val(mn + "s_ghostA")
            sB = val(mn + "s_ghostB")
            s_0 = arr2(mn + "stations")
            idx = np.logical_and(s_0 >= sA, s_0 <= sB)
            s_grid = np.unique(np.r_[sA, s_0[idx], sB])
            rA = rA_0 + sA * (rB_0 - rA_0)
            rB = rA_0 + sB * (rB_0 - rA_0)
            m = {
                "name": mn, "type": "rigid", "rA": rA, "rB": rB,
                "extensionA": float(np.linalg.norm(rA_0 - rA)),
                "extensionB": float(np.linalg.norm(rB_0 - rB)),
                "shape": shape, "gamma": val(mn + "gamma"),
                "potMod": members_opt[mn + "potMod"],
                "stations": s_grid,
                "rho_shell": val(mn + "rho_shell"),
            }
            if shape in ("circ", "square"):
                m["d"] = ([val(mn + "d")] * len(s_grid) if scalar_d[i]
                          else np.interp(s_grid, s_0, arr2(mn + "d")))
            else:
                dv = arr2(mn + "d")
                d2 = np.zeros((len(s_grid), 2))
                if scalar_d[i]:
                    d2[:, 0], d2[:, 1] = dv[0], dv[1]
                else:
                    d2[:, 0] = np.interp(s_grid, s_0, dv[:, 0])
                    d2[:, 1] = np.interp(s_grid, s_0, dv[:, 1])
                m["d"] = d2
            m["t"] = (val(mn + "t") if scalar_t[i]
                      else np.interp(s_grid, s_0, arr2(mn + "t")))
            for cname in ("Cd", "Ca"):
                cv = arr2(mn + cname)
                if shape == "circ":
                    m[cname] = (float(np.atleast_1d(cv)[0]) if scalar_c[i]
                                else np.interp(s_grid, s_0, cv))
                elif scalar_c[i]:
                    m[cname] = [float(cv[0]), float(cv[1])]
                else:
                    c2 = np.zeros((len(s_grid), 2))
                    c2[:, 0] = np.interp(s_grid, s_0, cv[:, 0])
                    c2[:, 1] = np.interp(s_grid, s_0, cv[:, 1])
                    m[cname] = c2
            for cname in ("CdEnd", "CaEnd"):
                cv = arr2(mn + cname)
                m[cname] = (float(np.atleast_1d(cv)[0]) if scalar_c[i]
                            else np.interp(s_grid, s_0, cv))
            if members_opt["nreps"][i] > 0:
                m["heading"] = arr2(mn + "heading")
            if members_opt["npts_lfill"][i] > 0:
                m["l_fill"] = arr2(mn + "l_fill")
                m["rho_fill"] = arr2(mn + "rho_fill")
            # bulkheads and ring stiffeners become cap stations
            ncaps = members_opt["ncaps"][i]
            ring_spacing = (val(mn + "ring_spacing")
                            if mn + "ring_spacing" in inputs else 0.0)
            if ncaps > 0 or ring_spacing > 0:
                s_height = s_grid[-1] - s_grid[0]
                n_stiff = (0 if ring_spacing == 0.0
                           else int(np.floor(s_height / ring_spacing)))
                s_ring = ((np.arange(1, n_stiff + 0.1) - 0.5)
                          * (ring_spacing / s_height))
                s_cap_0 = arr2(mn + "cap_stations")
                idx_cap = np.logical_and(s_cap_0 >= sA, s_cap_0 <= sB)
                s_cap, isort = np.unique(np.r_[sA, s_cap_0[idx_cap], sB],
                                         return_index=True)
                t_all = arr2(mn + "cap_t")
                t_cap = np.r_[t_all[0], t_all[idx_cap], t_all[-1]][isort]
                d_arr = np.asarray(m["d"])
                rect = d_arr.ndim == 2
                # rect members carry (side_x, side_y) hole pairs
                di_cap = np.zeros((len(s_cap), 2) if rect else s_cap.shape)
                if sA > 0.0:
                    s_cap, t_cap, di_cap = s_cap[1:], t_cap[1:], di_cap[1:]
                if sB < 1.0:
                    s_cap, t_cap, di_cap = (s_cap[:-1], t_cap[:-1],
                                            di_cap[:-1])
                if np.any(s_ring):
                    if rect:
                        d_ring = np.stack(
                            [np.interp(s_ring, s_grid, d_arr[:, j])
                             for j in range(2)], axis=1)
                    else:
                        d_ring = np.interp(s_ring, s_grid, d_arr)
                    s_cap = np.r_[s_ring, s_cap]
                    t_cap = np.r_[val(mn + "ring_t") * np.ones(n_stiff),
                                  t_cap]
                    di_cap = np.concatenate(
                        [d_ring - 2 * val(mn + "ring_h"), di_cap], axis=0)
                if len(s_cap) > 0:
                    isort = np.argsort(s_cap)
                    m["cap_stations"] = s_cap[isort]
                    m["cap_t"] = t_cap[isort]
                    m["cap_d_in"] = di_cap[isort]
            p["members"].append(m)

        # rigid bodies become point inertias
        rb = (modeling_opt.get("floating", {}) or {}).get(
            "rigid_bodies", {"n_bodies": 0})
        add = []
        for k in range(rb.get("n_bodies", 0)):
            add.append({
                "type": "point_inertia",
                "location": arr2(f"rigid_body_{k}_node"),
                "mass": val(f"rigid_body_{k}_mass"),
                "moments_of_inertia": np.r_[arr2(f"rigid_body_{k}_inertia"),
                                            0.0, 0.0, 0.0],
            })
        if add:
            p["additional_effects"] = add

        # mooring
        mo = {"water_depth": val("mooring_water_depth"), "points": [],
              "lines": [], "line_types": []}
        for i in range(mooring_opt["nconnections"]):
            pn = f"mooring_point{i+1}_"
            pt = {"name": mooring_opt[pn + "name"],
                  "type": mooring_opt[pn + "type"],
                  "location": arr2(pn + "location")}
            if pt["type"].lower() == "fixed":
                pt["anchor_type"] = "drag_embedment"
            mo["points"].append(pt)
        for i in range(mooring_opt["nlines"]):
            ln = f"mooring_line{i+1}_"
            mo["lines"].append({
                "name": f"line{i+1}",
                "endA": mooring_opt[ln + "endA"],
                "endB": mooring_opt[ln + "endB"],
                "type": mooring_opt[ln + "type"],
                "length": val(ln + "length"),
            })
        for i in range(mooring_opt["nline_types"]):
            lt = f"mooring_line_type{i+1}_"
            mo["line_types"].append({
                "name": mooring_opt[lt + "name"],
                "diameter": val(lt + "diameter"),
                "mass_density": val(lt + "mass_density"),
                "stiffness": val(lt + "stiffness"),
                "breaking_load": val(lt + "breaking_load"),
                "cost": val(lt + "cost"),
                "transverse_added_mass": val(lt + "transverse_added_mass"),
                "tangential_added_mass": val(lt + "tangential_added_mass"),
                "transverse_drag": val(lt + "transverse_drag"),
                "tangential_drag": val(lt + "tangential_drag"),
            })
        mo["anchor_types"] = [{"name": "drag_embedment", "mass": 1e3,
                               "cost": 1e4, "max_vertical_load": 0.0,
                               "max_lateral_load": 1e5}]
        design["mooring"] = mo

        # load cases: the spectral-wind ones only
        keys = modeling_opt["raft_dlcs_keys"]
        turb_ind = keys.index("turbulence")
        self.case_mask = [
            any(tt in str(cd[turb_ind]) for tt in ("NTM", "ETM", "EWM"))
            for cd in modeling_opt["raft_dlcs"]]
        data = [cd for cd, keep in zip(modeling_opt["raft_dlcs"],
                                       self.case_mask) if keep]
        design["cases"] = {"keys": keys, "data": data}
        return design

    # ----------------------------------------------------------- compute
    def compute(self, inputs, discrete_inputs=None):
        """One design evaluation: build, the unloaded statics,
        ``analyze_cases``, ``calc_outputs``, then the flat outputs."""
        from raft_tpu_torch.models.model import Model
        from raft_tpu_torch.utils.dtypes import resolve_device

        dev = resolve_device(self.device)
        design = self.build_design(inputs, discrete_inputs)
        model = self.model = Model(design)
        model.solve_statics(None, device=dev)
        model.analyze_cases(device=dev)
        results = model.calc_outputs(device=dev)

        outputs = {}
        for name, v in results["properties"].items():
            outputs["properties_" + name] = v

        names = ["surge", "sway", "heave", "roll", "pitch", "yaw",
                 "AxRNA", "Mbase", "Tmoor"]
        stats = ["avg", "std", "max", "PSD"]
        case_metrics = [cm[0] for cm in results["case_metrics"].values()]
        for n in names:
            for s in stats:
                outputs[f"stats_{n}_{s}"] = np.squeeze(np.array(
                    [np.asarray(cm[f"{n}_{s}"]) for cm in case_metrics]))
        for n in ("omega", "torque", "power", "bPitch"):
            key = f"{n}_max" if n == "omega" else f"{n}_avg"
            if key in case_metrics[0]:
                for s in stats:
                    k2 = f"{n}_{s}"
                    if k2 in case_metrics[0]:
                        outputs[f"stats_{k2}"] = np.squeeze(np.array(
                            [np.asarray(cm[k2]) for cm in case_metrics]))

        fns = np.asarray(results["eigen"]["frequencies"])
        outputs["rigid_body_periods"] = 1.0 / np.maximum(fns, 1e-12)
        for i, n in enumerate(("surge", "sway", "heave", "roll", "pitch",
                               "yaw")):
            outputs[f"{n}_period"] = float(outputs["rigid_body_periods"][i])

        # WEIS aggregates
        outputs["Max_Offset"] = float(np.max(np.sqrt(
            np.atleast_1d(outputs["stats_surge_max"]) ** 2
            + np.atleast_1d(outputs["stats_sway_max"]) ** 2)))
        outputs["heave_avg"] = float(np.mean(outputs["stats_heave_avg"]))
        outputs["Max_PtfmPitch"] = float(np.max(outputs["stats_pitch_max"]))
        outputs["Std_PtfmPitch"] = float(np.mean(outputs["stats_pitch_std"]))
        outputs["max_nac_accel"] = float(np.max(outputs["stats_AxRNA_max"]))
        outputs["max_tower_base"] = float(np.max(outputs["stats_Mbase_max"]))
        if "stats_omega_max" in outputs and "rated_rotor_speed" in inputs:
            rated = float(np.atleast_1d(np.asarray(
                inputs["rated_rotor_speed"], dtype=float))[0])
            if rated > 0:
                outputs["rotor_overspeed"] = float(
                    (np.max(outputs["stats_omega_max"]) - rated) / rated)

        outputs["platform_displacement"] = outputs[
            "properties_buoyancy (pgV)"] / (design["site"]["rho_water"] * 9.81)
        outputs["platform_mass"] = outputs["properties_substructure mass"]
        outputs["platform_total_center_of_mass"] = outputs[
            "properties_substructure CG"]
        outputs["platform_I_total"] = np.r_[
            outputs["properties_roll inertia at subCG"],
            outputs["properties_pitch inertia at subCG"],
            outputs["properties_yaw inertia at subCG"], 0.0, 0.0, 0.0]
        return outputs


try:  # the OpenMDAO component, where openmdao is installed
    import openmdao.api as om

    class RAFT_TPU_Component(om.ExplicitComponent):
        """An ExplicitComponent over :class:`DesignEvaluation`: each
        declared input overrides one dotted design path, each declared
        output is one of its flat outputs."""

        def initialize(self):
            self.options.declare("base_design")
            self.options.declare("design_vars", types=dict,
                                 desc="input name -> dotted design path")
            self.options.declare("outputs", types=list)

        def setup(self):
            self._eval = DesignEvaluation(self.options["base_design"])
            for name in self.options["design_vars"]:
                self.add_input(name)
            for name in self.options["outputs"]:
                self.add_output(name)

        def compute(self, inputs, outputs):
            overrides = {
                path: float(inputs[name])
                for name, path in self.options["design_vars"].items()
            }
            res = self._eval.compute(overrides)
            for name in self.options["outputs"]:
                outputs[name] = res[name]

except ImportError:  # openmdao is not installed
    RAFT_TPU_Component = None
