"""Per-case channel statistics of the orchestrated path (counterpart of
``raft_tpu/models/outputs.py``): platform motions, mooring tensions
(quasi-static through the tension Jacobian, or the lumped-mass line
dynamics of ``moorMod`` 1 and 2), nacelle accelerations, the tower base
bending moment (rigid, or from the FE stiffness of a beam tower), the
wave spectrum and the rotor channels (speed, torque, blade pitch,
power), plus the eigenmode JSON for viz3Danim.

Post-processing is host numpy, as in the reference, on the response the
device returned; the one device call is the tension Jacobian's 13
catenary evaluations, which run as 13 rows of one batched catenary
call.  Statistics sum the excitation sources (wave headings and the
rotor's turbulence) as RMS.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.utils.dtypes import resolve_device

RAD2DEG = 57.29577951308232


def get_rms(xi):
    """sqrt(0.5 sum |xi|^2) over every axis."""
    return np.sqrt(0.5 * np.sum(np.abs(xi) ** 2))


def get_psd(xi, dw, axis=None):
    """The response PSD 0.5 |xi|^2 / dw, summed over ``axis`` (the
    excitation sources) when given."""
    psd = 0.5 * np.abs(xi) ** 2 / dw
    return psd if axis is None else np.sum(psd, axis=axis)


def _chan(results, name, avg, amps, dw):
    """One channel's mean, RMS, mean +- 3 RMS, PSD and amplitudes."""
    std = get_rms(amps)
    results[f"{name}_avg"] = avg
    results[f"{name}_std"] = std
    results[f"{name}_max"] = avg + 3 * std
    results[f"{name}_min"] = avg - 3 * std
    results[f"{name}_PSD"] = get_psd(amps, dw, axis=0)
    results[f"{name}_RA"] = amps


def mooring_tension_vector(ms, r6, device=None):
    """End tensions ``[T_end_A..., T_end_B...]`` of every line at poses
    r6 (R, 6) -> (R, 2 nL) (MoorPy's getTensions layout; end A the
    anchor): a catenary system's from its per-line loads, a one-body
    network's from its line-end tensions, on ``device`` (default: the
    current CUDA device; raises without one)."""
    from raft_tpu_torch.physics.mooring import (MooringNetwork,
                                                catenary_line_forces)

    device = resolve_device(device)
    X = torch.as_tensor(np.asarray(r6, dtype=float), dtype=torch.float64,
                        device=device)
    if isinstance(ms, MooringNetwork):
        t = ms.solve(X[:, None], stiffness=False)["tensions"]
        return torch.cat([torch.abs(t[..., 0]), torch.abs(t[..., 1])],
                         dim=-1).cpu().numpy()
    m = ms.to(device)
    _, info = catenary_line_forces(m.r_fair0, m.r_anchor, m.L, m.w, m.EA, X)
    TA = torch.sqrt(info["HA"] ** 2 + info["VA"] ** 2)
    TB = torch.sqrt(info["HF"] ** 2 + info["VF"] ** 2)
    return torch.cat([TA, TB], dim=-1).cpu().numpy()


def tension_stats(ms, x6, dx=0.1, device=None):
    """(T_mean (2 nL,), J (2 nL, 6)): the end tensions at pose x6 and
    their Jacobian by MoorPy's 0.1-step central secant
    (``getCoupledStiffness(tensions=True)``, its 0.1 rad rotational step
    included), not the derivative.  The 13 poses run as the rows of one
    catenary call on ``device`` (the reference jits 13 calls)."""
    x6 = np.asarray(x6, dtype=float)
    eye = np.eye(6) * dx
    T = mooring_tension_vector(
        ms, np.concatenate([x6[None], x6 + eye, x6 - eye]), device=device)
    J = np.stack([(T[1 + j] - T[7 + j]) / (2 * dx) for j in range(6)],
                 axis=1)
    return T[0], J


def write_modes_json(model, filename, fns, modes, ifowt=0):
    """Eigenmodes in the viz3Danim JSON layout (the reference's
    ``write_modes_json``): the structural nodes plus virtual nodes along
    rigid members' stations, the element connectivity with diameters,
    and each mode's nodal displacements mapped through the reduction
    T."""
    fs = model.fowtList[ifowt]
    T = np.asarray(fs.T)
    node_r0 = np.asarray(fs.node_r0)

    nodes = [list(map(float, r)) for r in node_r0]
    connectivity = []
    elem_props = []
    virtual = {}
    for im, mem in enumerate(fs.members):
        n0 = int(fs.member_node[im])
        if mem.mtype == "rigid":
            stations_r = [mem.rA0 + mem.q0 * s for s in mem.stations]
            prev = n0
            for i in range(len(mem.stations) - 1):
                rB = stations_r[i + 1]
                nodes.append(list(map(float, rB)))
                n2 = len(nodes) - 1
                virtual[n2] = (n0, rB - node_r0[n0])
                n1 = n0 if i == 0 else prev
                connectivity.append([int(n1), int(n2)])
                d = 0.5 * (np.max(mem.d[i]) + np.max(mem.d[i + 1]))
                elem_props.append({"shape": "cylinder", "type": 1,
                                   "Diam": float(d)})
                prev = n2
        else:
            for i in range(mem.ns - 1):
                connectivity.append([n0 + i, n0 + i + 1])
                if mem.dorsl_node_ext is not None:
                    d = 0.5 * (np.max(mem.dorsl_node_ext[i])
                               + np.max(mem.dorsl_node_ext[i + 1]))
                else:
                    d = float(np.max(mem.d))
                elem_props.append({"shape": "cylinder", "type": 1,
                                   "Diam": float(d)})

    modes_list = []
    for i in range(modes.shape[1]):
        full = T @ np.asarray(modes[:, i])
        displ = []
        for idx in range(len(nodes)):
            if idx < len(node_r0):
                displ.append([float(full[6 * idx + k]) for k in range(3)])
            else:
                nid, off = virtual[idx]
                t = full[6 * nid:6 * nid + 3]
                rot = full[6 * nid + 3:6 * nid + 6]
                displ.append(list(map(float, t + np.cross(rot, off))))
        modes_list.append({"name": f"FEM{i+1}",
                           "frequency": float(fns[i]),
                           "omega": float(fns[i] * 2 * np.pi),
                           "Displ": displ})
    doc = {"writer": "raft_tpu", "fileKind": "Modes",
           "groundLevel": float(fs.depth), "Connectivity": connectivity,
           "Nodes": nodes, "ElemProps": elem_props, "Modes": modes_list}
    with open(filename, "w") as f:
        json.dump(doc, f)


def _tower_inertia(mem):
    """A rigid tower's 6 x 6 mass matrix about its node (numpy)."""
    from raft_tpu_torch.physics.statics import member_inertia

    kw = dict(dtype=torch.float64, device=torch.device("cpu"))
    M6, _, _ = member_inertia(mem, torch.as_tensor(mem.R0, **kw)[None],
                              torch.as_tensor(mem.q0, **kw)[None], 1, kw)
    return M6[0]


def turbine_outputs(model, case, X0, Xi, S, zeta, pose, A_aero=None,
                    B_aero=None, f_aero0=None, ifowt=0, rotor_info=None,
                    device=None):
    """Channel statistics of one case and one FOWT (the reference's
    ``turbine_outputs``, its ``saveTurbineOutputs``).

    Xi (nWaves + 1, nDOF, nw): this FOWT's response amplitudes, the last
    row the rotor's excitation source; X0 (nDOF,) its mean offsets; S,
    zeta the case's spectra; ``pose`` the :class:`~raft_tpu_torch.models.
    hydro.Pose` whose node reduction and positions the hub motion, the
    tower base and a beam tower's FE loads are taken at (the pose the
    reference's hydro object holds when its outputs run); A_aero, B_aero
    (nRotor, nw) the fore-aft aero coefficients at the hub, f_aero0 the
    mean rotor loads, rotor_info the rotors' channel data.  Numpy in,
    a dict of numpy out; ``device`` (default: the current CUDA device;
    raises without one) runs the tension Jacobian's or the line
    dynamics' solves."""
    device = resolve_device(device)
    fs = model.fowtList[ifowt]
    w = np.asarray(model.w, dtype=float)
    dw = float(w[1] - w[0])
    results = {}
    Xi = np.asarray(Xi)
    X0 = np.asarray(X0, dtype=float)
    Tn = pose.Tn[0].cpu().numpy()
    r_nodes = pose.r_nodes[0].cpu().numpy()

    # PRP motions: the root node sits at the origin of the supported
    # topologies; mean offsets are relative to the array position
    Xi_PRP = Xi
    ref = np.zeros(X0.shape[0])
    ref[0], ref[1] = fs.x_ref, fs.y_ref
    Xi0_PRP = X0 - ref
    _chan(results, "surge", Xi0_PRP[0], Xi_PRP[:, 0, :], dw)
    _chan(results, "sway", Xi0_PRP[1], Xi_PRP[:, 1, :], dw)
    _chan(results, "heave", Xi0_PRP[2], Xi_PRP[:, 2, :], dw)
    _chan(results, "roll", RAD2DEG * Xi0_PRP[3], RAD2DEG * Xi_PRP[:, 3, :], dw)
    _chan(results, "pitch", RAD2DEG * Xi0_PRP[4], RAD2DEG * Xi_PRP[:, 4, :],
          dw)
    _chan(results, "yaw", RAD2DEG * Xi0_PRP[5], RAD2DEG * Xi_PRP[:, 5, :], dw)

    # ----- mooring tensions: lumped-mass line dynamics (moorMod 1/2) or
    # the quasi-static tension Jacobian
    ms = model.ms_list[ifowt]
    if ms is not None and getattr(ms, "moorMod", 0) >= 1 \
            and getattr(ms, "m_lin", None) is not None:
        from raft_tpu_torch.physics.mooring_dynamics import \
            fowt_line_tension_amps

        T_mean = mooring_tension_vector(ms, X0[None, :6], device=device)[0]
        nL = ms.n_lines
        nWp1 = Xi.shape[0]
        T_amps = np.zeros((nWp1, 2 * nL, model.nw), dtype=np.complex128)
        beta = np.atleast_1d(np.deg2rad(np.asarray(
            case.get("wave_heading", 0.0), dtype=float)))
        S_arr = np.atleast_2d(np.asarray(S))
        for ih in range(nWp1 - 1):       # the wave sources only
            T_amps[ih] = fowt_line_tension_amps(
                ms, X0[:6], Xi[ih, :6, :], w, model.k,
                S_arr[min(ih, len(S_arr) - 1)],
                float(beta[min(ih, len(beta) - 1)]), model.depth,
                rho=fs.rho_water, g=fs.g, device=device)
        T_std = np.sqrt(0.5 * np.sum(np.abs(T_amps) ** 2, axis=(0, 2)))
        results["Tmoor_avg"] = T_mean
        results["Tmoor_std"] = T_std
        results["Tmoor_max"] = T_mean + 3 * T_std
        results["Tmoor_min"] = T_mean - 3 * T_std
        results["Tmoor_PSD"] = np.sum(0.5 * np.abs(T_amps) ** 2 / dw, axis=0)
    elif ms is not None:
        T_mean, J = tension_stats(ms, X0[:6], device=device)
        T_amps = np.einsum("tj,hjw->htw", J, Xi_PRP[:, :6, :])
        T_std = np.sqrt(0.5 * np.sum(np.abs(T_amps) ** 2, axis=(0, 2)))
        results["Tmoor_avg"] = T_mean
        results["Tmoor_std"] = T_std
        results["Tmoor_max"] = T_mean + 3 * T_std
        results["Tmoor_min"] = T_mean - 3 * T_std
        results["Tmoor_PSD"] = np.sum(0.5 * np.abs(T_amps) ** 2 / dw, axis=0)

    # ----- nacelle accelerations
    nrot = fs.nrotors
    for key in ("AxRNA", "AyRNA", "AzRNA"):
        for suf in ("std", "avg", "max", "min"):
            results[f"{key}_{suf}"] = np.zeros(nrot)
        results[f"{key}_PSD"] = np.zeros((model.nw, nrot))
    for suf in ("avg", "std", "max", "min"):
        results[f"Mbase_{suf}"] = np.zeros(nrot)
    results["Mbase_PSD"] = np.zeros((model.nw, nrot))

    stat = model.statics(ifowt)
    g = fs.g
    for ir in range(nrot):
        rot = fs.rotors[ir]
        node = int(fs.rotor_node[ir])
        XiHub = np.einsum("ia,haw->hiw", Tn[node], Xi_PRP)
        for ax, key in enumerate(("AxRNA", "AyRNA", "AzRNA")):
            amps = XiHub[:, ax, :] * w ** 2
            results[f"{key}_std"][ir] = float(get_rms(amps))
            results[f"{key}_PSD"][:, ir] = get_psd(amps, dw, axis=0)
            if key == "AxRNA":
                avg = abs(float(np.sin(X0[4])) * g)
            elif key == "AyRNA":
                avg = abs(float(np.sin(X0[3])) * g)
            else:
                avg = abs(g)
            results[f"{key}_avg"][ir] = avg
            results[f"{key}_max"][ir] = avg + 3 * results[f"{key}_std"][ir]
            results[f"{key}_min"][ir] = avg - 3 * results[f"{key}_std"][ir]

        # ----- tower base bending moment
        tower_idx = [i for i, m in enumerate(fs.members)
                     if m.part_of == "tower"]
        if not tower_idx:
            continue
        mem_tower = fs.members[tower_idx[ir]]
        if mem_tower.mtype != "rigid":
            # a beam tower: internal loads at its base node from the FE
            # stiffness; Mbase_* aliases the fore-aft MbaseY
            from raft_tpu_torch.physics.beams import fe_stiffness

            n0 = int(fs.member_node[tower_idx[ir]])
            nn = mem_tower.ns
            r_tow = r_nodes[n0:n0 + nn]
            Kf = np.asarray(fe_stiffness(mem_tower, r_tow))
            Tn_tow = Tn[n0:n0 + nn].reshape(6 * nn, -1)
            Xi0_int = Tn_tow @ X0
            Xi_int = np.einsum("fa,haw->hfw", Tn_tow, Xi)
            Fi0 = -Kf @ Xi0_int
            Fi = -np.einsum("fe,hew->hfw", Kf, Xi_int)
            base = (slice(0, 6) if r_tow[0, 2] <= r_tow[-1, 2]
                    else slice(6 * nn - 6, 6 * nn))
            Fi0_b = Fi0[base]
            Fi_b = Fi[:, base, :]
            for c, nm in enumerate(("FbaseX", "FbaseY", "FbaseZ", "MbaseX",
                                    "MbaseY", "MbaseZ")):
                std = float(get_rms(Fi_b[:, c, :]))
                for suf in ("avg", "std", "max", "min"):
                    results.setdefault(f"{nm}_{suf}", np.zeros(nrot))
                results.setdefault(f"{nm}_PSD", np.zeros((model.nw, nrot)))
                results[f"{nm}_avg"][ir] = Fi0_b[c]
                results[f"{nm}_std"][ir] = std
                results[f"{nm}_PSD"][:, ir] = get_psd(Fi_b[:, c, :], dw,
                                                      axis=0)
                results[f"{nm}_max"][ir] = Fi0_b[c] + 3 * std
                results[f"{nm}_min"][ir] = Fi0_b[c] - 3 * std
            for suf in ("avg", "std", "max", "min"):
                results[f"Mbase_{suf}"][ir] = results[f"MbaseY_{suf}"][ir]
            results["Mbase_PSD"][:, ir] = results["MbaseY_PSD"][:, ir]
            continue
        mtower = float(np.asarray(stat["mtower"])[ir])
        rCG_tow = np.asarray(stat["rCG_tow"][ir])
        m_turb = mtower + rot.mRNA
        zCG = (rCG_tow[2] * mtower + rot.r_rel[2] * rot.mRNA) / m_turb
        # the tower base at the pose (the reference's member rA tracks
        # the mean offset)
        zBase = float(r_nodes[int(fs.member_node[tower_idx[ir]])][2])
        hArm = zCG - zBase
        node_tow = int(fs.member_node[tower_idx[ir]])
        ICG = float(tf.translate_matrix_6to6(
            _tower_inertia(mem_tower),
            torch.as_tensor(fs.node_r0[node_tow] - np.array([0, 0, zCG]),
                            dtype=torch.float64))[4, 4]) \
            + rot.mRNA * (rot.r_rel[2] - zCG) ** 2 + rot.IrRNA
        aCG = -(w ** 2) * (Xi_PRP[:, 0, :] + zCG * Xi_PRP[:, 4, :])
        M_I = -m_turb * aCG * hArm - ICG * (-(w ** 2) * Xi_PRP[:, 4, :])
        M_w = m_turb * g * hArm * Xi_PRP[:, 4, :]
        if A_aero is not None:
            M_X_aero = -(-(w ** 2) * np.asarray(A_aero[ir])
                         + 1j * w * np.asarray(B_aero[ir])) \
                * (rot.r_rel[2] - zBase) ** 2 * Xi_PRP[:, 4, :]
        else:
            M_X_aero = 0.0
        dyn_moment = M_I + M_w + M_X_aero
        Mrms = float(get_rms(dyn_moment))
        Mavg = m_turb * g * hArm * float(np.sin(X0[4]))
        if f_aero0 is not None:
            # the reduced mean rotor force mapped back to the rotor node
            f6 = Tn[node] @ np.asarray(f_aero0)[:, ir]
            Mavg += float(tf.transform_force_6(
                torch.as_tensor(f6), torch.tensor([0.0, 0.0, -hArm],
                                                  dtype=torch.float64))[4])
        results["Mbase_avg"][ir] = Mavg
        results["Mbase_std"][ir] = Mrms
        results["Mbase_PSD"][:, ir] = get_psd(dyn_moment, dw, axis=0)
        results["Mbase_max"][ir] = Mavg + 3 * Mrms
        results["Mbase_min"][ir] = Mavg - 3 * Mrms

    results["wave_PSD"] = get_psd(np.asarray(zeta), dw, axis=0)

    # ----- rotor channels: azimuth, speed, torque and blade pitch
    # through the control transfer function C applied to the hub's
    # fore-aft motion, the turbulence inflow V_w driving the last
    # (rotor) source
    for key in ("omega", "torque", "bPitch"):
        for suf in ("avg", "std", "max", "min"):
            results[f"{key}_{suf}"] = np.zeros(nrot)
        results[f"{key}_PSD"] = np.zeros((model.nw, nrot))
    results["power_avg"] = np.zeros(nrot)
    # one column per rotor (the reference keeps the last rotor's only)
    results["wind_PSD"] = np.zeros((model.nw, nrot))
    RADPS2RPM = 60.0 / (2 * np.pi)
    for ir in range(nrot):
        ri = rotor_info[ir] if rotor_info else None
        if ri is not None and ri.get("cavitation") is not None:
            results["cavitation"] = np.asarray(ri["cavitation"])
        if (ri is None or ri.get("aeroServoMod", 0) <= 1
                or ri.get("speed", 0) <= 0):
            continue
        node = int(fs.rotor_node[ir])
        XiHub = np.einsum("ia,haw->hiw", Tn[node], Xi)[:, 0, :]
        C = np.asarray(ri["C"])
        V_w = np.asarray(ri["V_w"])
        phi_w = C[None, :] * XiHub
        phi_w[-1] = C * (XiHub[-1] - V_w / (1j * w))
        omega_w = 1j * w * phi_w
        torque_w = (1j * w * ri["kp_tau"] + ri["ki_tau"]) * phi_w
        bPitch_w = (1j * w * ri["kp_beta"] + ri["ki_beta"]) * phi_w

        results["omega_avg"][ir] = ri["Omega_rpm"]
        results["omega_std"][ir] = RADPS2RPM * float(get_rms(omega_w))
        # the reference's 2-sigma band for the rotor speed
        results["omega_max"][ir] = (results["omega_avg"][ir]
                                    + 2 * results["omega_std"][ir])
        results["omega_min"][ir] = (results["omega_avg"][ir]
                                    - 2 * results["omega_std"][ir])
        results["omega_PSD"][:, ir] = RADPS2RPM ** 2 * get_psd(omega_w, dw,
                                                               axis=0)
        Ng = ri.get("Ng", 1.0) or 1.0
        results["torque_avg"][ir] = ri["aero_torque"] / Ng
        results["torque_std"][ir] = float(get_rms(torque_w))
        results["torque_PSD"][:, ir] = get_psd(torque_w, dw, axis=0)
        results["power_avg"][ir] = ri["aero_power"]
        results["bPitch_avg"][ir] = ri["pitch_deg"]
        results["bPitch_std"][ir] = RAD2DEG * float(get_rms(bPitch_w))
        results["bPitch_PSD"][:, ir] = RAD2DEG ** 2 * get_psd(bPitch_w, dw,
                                                              axis=0)
        results["wind_PSD"][:, ir] = get_psd(V_w, dw)
    return results
