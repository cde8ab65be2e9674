"""High-level drivers of the port (counterpart of ``raft_tpu/drivers.py``):
the ``runRAFT``-style entry points :func:`run` and :func:`run_farm`, the
program bank's warm-up (:func:`warmup`), the
channel-statistics CSV (:func:`save_responses`), the steady power and
thrust curve, and the ballast adjustments.  ``python -m raft_tpu_torch
design.json`` runs :func:`run` (:mod:`raft_tpu_torch.__main__`).

Every entry point runs on ``device`` (default: the current CUDA device;
raises without one, naming ``device="cpu"``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def run(input_file, save_csv=None, device=None):
    """Load a design (a ``.json`` / ``.yaml`` path or a dict), analyze
    every load case on ``device`` and, with ``save_csv``, write the
    channel statistics there.  Returns the Model.  The work runs under
    a ``driver.run`` span, the root of the case spans."""
    from raft_tpu_torch.obs.spans import span
    from raft_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    with span("driver.run", input=str(input_file)):
        return _analyze(input_file, save_csv, dev)


def run_farm(input_file, save_csv=None, device=None):
    """The one-call farm driver (the reference's ``run_farm``, its
    runRAFTFarm): ``run``'s work under a ``driver.run_farm`` span.  The
    reference's farm entry leaves the single-FOWT property and eigen
    outputs out; ``analyze_cases`` already covers the array path and
    leaves them to ``Model.calc_outputs``."""
    from raft_tpu_torch.obs.spans import span
    from raft_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    with span("driver.run_farm", input=str(input_file)):
        return _analyze(input_file, save_csv, dev)


def _analyze(input_file, save_csv, dev):
    from raft_tpu_torch.models.model import Model

    model = Model(input_file)
    model.analyze_cases(device=dev)
    if save_csv:
        save_responses(model, save_csv)
    return model


def warmup(input_file=None, sizes=(8,), kinds=("cases", "full", "design"),
           out_keys=("PSD", "X0", "status"), device=None):
    """Warm the program bank for a design before serving it (the
    reference's ``drivers.warmup``; the driver-level face of ``python -m
    raft_tpu_torch.aot warmup``): builds the model once and pushes every
    requested kind through the production funnel under
    ``RAFT_TPU_AOT=load``, so each program is built, run and stored in
    the bank (``RAFT_TPU_AOT_DIR``).  A later fresh process — a fabric
    worker, a serving process — then loads them, with no ``nvcc`` run on
    the card (run it under ``RAFT_TPU_AOT=require`` +
    ``RAFT_TPU_COMPILE_BUDGET=0`` to make that an enforced invariant).

    sizes : batch sizes to warm, one program each (warm the shard sizes
        you will dispatch).
    device : where the programs run (default: the current CUDA device;
        raises without one, naming ``device="cpu"``).
    Returns the per-program warm-up reports (kind, rows, wall_s,
    loaded, compiled, launches)."""
    from raft_tpu_torch.aot.warmup import warmup_model
    from raft_tpu_torch.utils.dtypes import resolve_device

    return warmup_model(design=input_file, sizes=sizes, kinds=kinds,
                        out_keys=out_keys, device=resolve_device(device))


def save_responses(model, path):
    """Write every case's and FOWT's channel statistics (the six motions
    and each line-end tension: avg, std, max, min) as CSV."""
    rows = ["case,fowt,channel,avg,std,max,min"]
    for iCase, per_fowt in model.results["case_metrics"].items():
        for ifowt, metrics in per_fowt.items():
            for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"):
                rows.append(
                    f"{iCase},{ifowt},{ch},"
                    f"{float(metrics[ch + '_avg']):.6e},"
                    f"{float(metrics[ch + '_std']):.6e},"
                    f"{float(metrics[ch + '_max']):.6e},"
                    f"{float(metrics[ch + '_min']):.6e}")
            if "Tmoor_avg" in metrics:
                T = np.asarray(metrics["Tmoor_avg"])
                Ts = np.asarray(metrics["Tmoor_std"])
                for iT in range(len(T)):
                    rows.append(
                        f"{iCase},{ifowt},Tmoor{iT},"
                        f"{T[iT]:.6e},{Ts[iT]:.6e},"
                        f"{T[iT] + 3 * Ts[iT]:.6e},{T[iT] - 3 * Ts[iT]:.6e}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def power_thrust_curve(model, speeds, ifowt=0, ir=0, device=None):
    """The steady power and thrust curve of one rotor over ``speeds``
    (the reference's ``power_thrust_curve``): the speeds as the rows of
    one blade-element call on ``device`` at the scheduled rotor speed and
    pitch, the shaft tilt, no yaw.  Returns dict(speeds, thrust [N],
    torque [N m], power [W], Omega_rpm, pitch_deg) as numpy."""
    from raft_tpu_torch.physics.aero import (operating_point, rotor_loads,
                                             rotor_tensors)
    from raft_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    rt = rotor_tensors(model.rotor_aero[ir], dev)
    rprops = model.fowtList[ifowt].rotors[ir]
    tilt = -np.arctan2(rprops.q_rel[2],
                       np.hypot(rprops.q_rel[0], rprops.q_rel[1]))
    U = torch.as_tensor(np.asarray(speeds, dtype=float),
                        dtype=torch.float64, device=dev)
    Om, pit = operating_point(rt, U)
    loads = rotor_loads(rt, U, Om, pit, torch.full_like(U, tilt),
                        torch.zeros_like(U))
    T, Q = loads[:, 0], loads[:, 3]
    P = Q * Om * np.pi / 30.0
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in dict(speeds=np.asarray(speeds), thrust=T, torque=Q,
                             power=P, Omega_rpm=Om, pitch_deg=pit).items()}


def adjust_ballast(base_design, target_heave=0.0, heave_tol=0.05,
                   max_iter=12, device=None):
    """Scale every ballasted section's fill length by one factor until
    the unloaded mean heave reaches ``target_heave`` (the reference's
    ``adjust_ballast``, its adjustBallast): a secant iteration, each
    step a rebuilt Model and its unloaded equilibrium on ``device``.
    Returns (model, scale)."""
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.structure.schema import load_design

    base = load_design(base_design)

    def heave_at(scale):
        d = copy.deepcopy(base)
        for mi in d["platform"]["members"]:
            if "l_fill" in mi and np.any(
                    np.asarray(mi["l_fill"], dtype=float) > 0):
                lf = np.atleast_1d(np.asarray(mi["l_fill"],
                                              dtype=float)) * scale
                st = np.asarray(mi["stations"], dtype=float)
                lf = np.minimum(lf, np.diff(st))   # no section overfills
                mi["l_fill"] = lf.tolist() if lf.size > 1 else float(lf[0])
        model = Model(d)
        X = model.solve_statics(None, device=device)
        return float(X[2]), model

    s0, s1 = 1.0, 1.05
    h0, model = heave_at(s0)
    if abs(h0 - target_heave) < heave_tol:
        return model, s0
    h1, model = heave_at(s1)
    for _ in range(max_iter):
        if abs(h1 - h0) < 1e-12:
            break
        s2 = s1 - (h1 - target_heave) * (s1 - s0) / (h1 - h0)
        s2 = float(np.clip(s2, 0.0, 3.0))
        h2, model = heave_at(s2)
        s0, h0, s1, h1 = s1, h1, s2, h2
        if abs(h1 - target_heave) < heave_tol:
            break
    return model, s1


def adjust_ballast_density(base_design, device=None):
    """Shift every filled section's ballast density by one amount that
    zeroes the unloaded net heave force (the reference's
    ``adjust_ballast_density``): ``delta_rho = sumFz / (g V_ballast)``,
    the mooring's force taken at the unloaded equilibrium on ``device``.
    Returns (the rebuilt model, delta_rho)."""
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.structure.schema import load_design
    from raft_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    base = load_design(base_design)
    model = Model(copy.deepcopy(base))
    fs = model.fowtList[0]
    stat = model.statics(0)
    g = fs.g
    X0 = model.solve_statics(None, device=dev)
    Fm = np.zeros(6)
    if model.ms is not None:
        F, _ = model._mooring(dev)(torch.as_tensor(
            X0[None], dtype=torch.float64, device=dev))
        Fm = F[0, :6].cpu().numpy()
    sumFz = (-float(np.asarray(stat["M_struc"])[0, 0]) * g
             + float(stat["V"]) * fs.rho_water * g + Fm[2])
    V_ballast = float(sum(sum(m.vfill) for m in fs.members))
    if V_ballast <= 0:
        raise ValueError("adjust_ballast_density needs nonzero ballast volume")
    delta_rho = sumFz / g / V_ballast
    d = copy.deepcopy(base)
    for mi in d["platform"]["members"]:
        if "rho_fill" in mi and "l_fill" in mi:
            lf = np.atleast_1d(np.asarray(mi["l_fill"], dtype=float))
            rf = np.atleast_1d(np.asarray(mi["rho_fill"], dtype=float))
            rf = np.where(lf > 0, rf + delta_rho, rf)
            mi["rho_fill"] = rf.tolist() if rf.size > 1 else float(rf[0])
    return Model(d), float(delta_rho)


def adjust_wisdem(model, old_wisdem_file, new_wisdem_file):
    """Write the model's ballast fill volumes back into a WISDEM geometry
    YAML (the reference's ``adjust_wisdem``): WISDEM members match the
    model's by bottom-joint elevation and base diameter, and their
    first ballast volume takes the member's fill.  Needs PyYAML."""
    import yaml

    with open(old_wisdem_file, encoding="utf-8") as f:
        wisdem_design = yaml.safe_load(f)
    fs = model.fowtList[0]
    members_w = wisdem_design["components"]["floating_platform"]["members"]
    joints_w = wisdem_design["components"]["floating_platform"]["joints"]
    for wm in members_w:
        if "ballasts" not in wm.get("internal_structure", {}):
            continue
        for rm in fs.members:
            matched = False
            for joint in joints_w:
                if wm["joint1"] != joint["name"]:
                    continue
                same_z = str(joint["location"][2])[0:5] == str(rm.rA0[2])[0:5]
                same_d = (wm["outer_shape"]["outer_diameter"]["values"][0]
                          == rm.d[0, 0])
                if same_z and same_d:
                    area = np.pi * ((rm.d[0, 0] - 2 * rm.t[0]) / 2) ** 2
                    lf = np.atleast_1d(np.asarray(rm.l_fill, dtype=float))
                    wm["internal_structure"]["ballasts"][0]["volume"] = \
                        float(area * lf[0])
                    matched = True
                break
            if matched:
                break
    with open(new_wisdem_file, "w", encoding="utf-8") as f:
        yaml.safe_dump(wisdem_design, f, default_flow_style=None,
                       sort_keys=False)
    return wisdem_design
