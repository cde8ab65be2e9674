"""General statics of mixed rigid/flexible FOWTs (numpy, build time;
counterpart of ``raft_tpu/physics/statics_general.py``).

The reference RAFT's ``FOWT.calcStatics`` for structures with flexible
(beam) members (``raft_fowt.py:811-1285``, with the beam branches of
``raft_member.py``: ``getInertia`` :542-657, ``getWeight`` :1183-1258,
``getHydrostatics`` :1008-1146), optionally at a displaced mean pose.
Rigid members take the port's batched :func:`~raft_tpu_torch.physics.
statics.member_inertia` and :func:`~raft_tpu_torch.physics.statics.
member_hydrostatics` at one row of float64 CPU tensors; beams take the
FE matrices of :mod:`raft_tpu_torch.physics.beams` and the per-node
hydrostatics below.  The reduced matrices enter the flexible evaluator
as its constants or, rebuilt at other member sizes, as the rows of its
geometry axis (:func:`raft_tpu_torch.api.make_flexible_evaluator`,
``struct_params``, differentiable there; this host build stays outside
the gradient, as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.physics.beams import (fe_inertia, fe_stiffness,
                                          mass_and_center)
from raft_tpu_torch.physics.statics import (member_hydrostatics,
                                            member_inertia)
from raft_tpu_torch.structure.members import _frustum_vcv
from raft_tpu_torch.structure.topology import _rotmat

_F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    """One row of a float64 CPU tensor of ``a``."""
    return torch.as_tensor(np.asarray(a, dtype=float), **_F64)[None]


def _getH(r):
    return np.array([[0.0, r[2], -r[1]], [-r[2], 0.0, r[0]], [r[1], -r[0], 0.0]])


def _translate6(M, r):
    H = _getH(r)
    out = np.zeros((6, 6))
    m = M[:3, :3]
    out[:3, :3] = m
    out[:3, 3:] = m @ H + M[:3, 3:]
    out[3:, :3] = out[:3, 3:].T
    out[3:, 3:] = H @ m @ H.T + M[3:, :3] @ H + H.T @ M[:3, 3:] + M[3:, 3:]
    return out


def _force3to6(F, r):
    return np.concatenate([F, np.cross(r, F)])


def _weight_point(mass, dR, g):
    W = _force3to6(np.array([0.0, 0.0, -g * mass]), dR)
    C = np.zeros((6, 6))
    C[3, 3] = -mass * g * dR[2]
    C[4, 4] = -mass * g * dR[2]
    return W, C


def _beam_member_arrays(mem, node_r, g):
    """Per-node inertia/weight/stiffness of a beam member at ref pose.

    Returns dict with M (6n,6n), W (6n,), C_struc (6n,6n), Kf (6n,6n),
    mass, center, mshell."""
    n = mem.ns
    M = fe_inertia(mem, node_r)
    Kf = fe_stiffness(mem, node_r)
    mass_fe, _ = mass_and_center(M, node_r)

    # lumped ballast + caps into diagonal blocks (raft_member.py:550-657)
    for i in range(n):
        for m_l, c_l, I_l in (
            (mem.node_ballast_mass[i], mem.node_ballast_center[i], mem.node_ballast_I[i]),
            (mem.node_cap_mass[i], mem.node_cap_center[i], mem.node_cap_I[i]),
        ):
            if m_l <= 0:
                continue
            Mm = np.diag([m_l, m_l, m_l, 0, 0, 0]).astype(float)
            T = mem.R0.T
            Mm[3:, 3:] = T.T @ np.diag(I_l) @ T
            M[6 * i:6 * i + 6, 6 * i:6 * i + 6] += _translate6(Mm, c_l - node_r[i])

    mass, center = mass_and_center(M, node_r)

    # ---- weight vector + per-node weight stiffness (getWeight beam branch)
    W = np.zeros(6 * n)
    C_struc = np.zeros((6 * n, 6 * n))
    mass_node = np.zeros(n)
    m_center_sum = np.zeros((n, 3))
    Dc = np.column_stack((mem.p10, mem.p20, mem.q0))
    for i in range(n - 1):
        L = np.linalg.norm(node_r[i + 1] - node_r[i])
        if mem.circular:
            Do = 0.5 * (mem.dorsl_node_ext[i, 0] + mem.dorsl_node_ext[i + 1, 0])
            Di = 0.5 * (mem.dorsl_node_int[i, 0] + mem.dorsl_node_int[i + 1, 0])
            A = np.pi * (Do**2 - Di**2) / 4
        else:
            Lo = 0.5 * (mem.dorsl_node_ext[i] + mem.dorsl_node_ext[i + 1])
            Li = 0.5 * (mem.dorsl_node_int[i] + mem.dorsl_node_int[i + 1])
            A = Lo[0] * Lo[1] - Li[0] * Li[1]
        W[6 * i:6 * i + 6] += mem.rho_shell * A * g * np.array(
            [0, 0, -L / 2, -L**2 / 12 * Dc[1, 2], L**2 / 12 * Dc[0, 2], 0])
        W[6 * (i + 1):6 * (i + 1) + 6] += mem.rho_shell * A * g * np.array(
            [0, 0, -L / 2, L**2 / 12 * Dc[1, 2], -L**2 / 12 * Dc[0, 2], 0])
        mass_node[i] += mem.rho_shell * A * L / 2
        mass_node[i + 1] += mem.rho_shell * A * L / 2
        m_center_sum[i] += mem.rho_shell * A * L / 2 * (node_r[i] + L / 4 * mem.q0)
        m_center_sum[i + 1] += mem.rho_shell * A * L / 2 * (node_r[i + 1] - L / 4 * mem.q0)

    for i in range(n):
        for m_l, c_l in ((mem.node_ballast_mass[i], mem.node_ballast_center[i]),
                         (mem.node_cap_mass[i], mem.node_cap_center[i])):
            f = m_l * g * np.array([0.0, 0, -1, 0, 0, 0])
            off = c_l - node_r[i]
            f6 = f.copy()
            f6[3:] += np.cross(off, f[:3])
            W[6 * i:6 * i + 6] += f6
            mass_node[i] += m_l
            m_center_sum[i] += m_l * c_l
        cmn = m_center_sum[i] / mass_node[i] if mass_node[i] > 0 else np.zeros(3)
        W_own, C_own = _weight_point(mass_node[i], cmn - node_r[i], g)
        C_struc[6 * i:6 * i + 6, 6 * i:6 * i + 6] = C_own

    return dict(M=M, W=W, C_struc=C_struc, Kf=Kf, mass=mass, center=center,
                mshell=mass_fe + float(mem.node_cap_mass.sum()))


def _beam_hydrostatics(mem, node_r, rho, g):
    """Beam branch of getHydrostatics (raft_member.py:1008-1146)."""
    n = mem.ns
    Fvec = np.zeros(6 * n)
    Cmat = np.zeros((6 * n, 6 * n))
    V_UW = 0.0
    r_centerV = np.zeros(3)
    AWP = IWP = xWP = yWP = 0.0

    q = mem.q0
    beta = np.arctan2(q[1], q[0])
    phi = np.arctan2(np.hypot(q[0], q[1]), q[2])
    cosPhi, sinPhi = np.cos(phi), np.sin(phi)
    tanPhi = np.tan(phi)
    cosBeta, sinBeta = np.cos(beta), np.sin(beta)

    nodes_z = node_r[:, 2]
    nodes_s = np.linalg.norm(node_r - node_r[0], axis=1)
    dist_p = np.diff(nodes_s, prepend=0)
    dist_n = np.diff(nodes_s, append=nodes_s[-1])

    waterline_node = None
    for i in range(n - 1):
        if nodes_z[i] * nodes_z[i + 1] < 0:
            waterline_node = i if abs(nodes_z[i]) < abs(nodes_z[i + 1]) else i + 1
            break

    for i in range(1, len(mem.stations)):
        lsec = mem.stations[i] - mem.stations[i - 1]
        if lsec <= 0:
            continue
        for inode in range(n):
            sA = max(nodes_s[inode] - dist_p[inode] / 2, mem.stations[i - 1])
            sB = min(nodes_s[inode] + dist_n[inode] / 2, mem.stations[i])
            l_node = sB - sA
            if l_node <= 0:
                continue
            if inode == 0:
                rA = node_r[0]
            else:
                rA = node_r[inode - 1] + (node_r[inode] - node_r[inode - 1]) * (
                    (sA - nodes_s[inode - 1]) / (nodes_s[inode] - nodes_s[inode - 1]))
            if inode == n - 1:
                rB = node_r[-1]
            else:
                rB = node_r[inode] + (node_r[inode + 1] - node_r[inode]) * (
                    (sB - nodes_s[inode]) / (nodes_s[inode + 1] - nodes_s[inode]))

            def shape_at(s):
                if mem.circular:
                    dA_st, dB_st = mem.d[i - 1, 0], mem.d[i, 0]
                    return (dB_st - dA_st) * ((s - mem.stations[i - 1]) / lsec) + dA_st
                slA_st, slB_st = mem.d[i - 1], mem.d[i]
                return (slB_st - slA_st) * ((s - mem.stations[i - 1]) / lsec) + slA_st

            if rA[2] < 0 and rB[2] < 0:
                V_sub, hc = _frustum_vcv(shape_at(sA), shape_at(sB), l_node)
                r_center = rA + (rB - rA) * (hc / l_node)
                r_rel = r_center - node_r[inode]
                Fvec[6 * inode:6 * inode + 6] += _force3to6(
                    np.array([0, 0, rho * g * V_sub]), r_rel)
                Cmat[6 * inode + 3, 6 * inode + 3] += rho * g * V_sub * r_rel[2]
                Cmat[6 * inode + 4, 6 * inode + 4] += rho * g * V_sub * r_rel[2]
                Cmat[6 * inode + 3, 6 * inode + 5] += -rho * g * V_sub * r_rel[0]
                Cmat[6 * inode + 4, 6 * inode + 5] += -rho * g * V_sub * r_rel[1]
                V_UW += V_sub
                r_centerV += r_center * V_sub
            elif rA[2] * rB[2] < 0:
                frac = abs(rA[2] / (rA[2] - rB[2]))
                rWP = rA + frac * (rB - rA)
                sWP = sA + frac * (sB - sA)
                wet = np.linalg.norm(rWP - rA)
                V_sub, hc = _frustum_vcv(shape_at(sA), shape_at(sWP), wet)
                r_center = rA + (rWP - rA) * (hc / wet)
                r_rel = r_center - node_r[inode]
                Fvec[6 * inode:6 * inode + 6] += _force3to6(
                    np.array([0, 0, rho * g * V_sub]), r_rel)
                Cmat[6 * inode + 3, 6 * inode + 3] += rho * g * V_sub * r_rel[2]
                Cmat[6 * inode + 4, 6 * inode + 4] += rho * g * V_sub * r_rel[2]
                Cmat[6 * inode + 3, 6 * inode + 5] += -rho * g * V_sub * r_rel[0]
                Cmat[6 * inode + 4, 6 * inode + 5] += -rho * g * V_sub * r_rel[1]
                V_UW += V_sub
                r_centerV += r_center * V_sub

                if inode == waterline_node:
                    M = 0.0
                    if mem.circular:
                        dWP = shape_at(sWP)
                        AWP = np.pi / 4 * dWP**2
                        IWP = np.pi / 64 * dWP**4
                        IxWP = IyWP = IWP
                        M = -rho * g * np.pi * (
                            dWP**2 / 32 * (2.0 + tanPhi**2)
                            + 0.5 * (rA[2] / cosPhi) ** 2) * sinPhi
                    else:
                        slWP = shape_at(sWP)
                        AWP = slWP[0] * slWP[1]
                        IxWP_l = slWP[0] * slWP[1] ** 3 / 12
                        IyWP_l = slWP[0] ** 3 * slWP[1] / 12
                        I_rot = mem.R0 @ np.diag([IxWP_l, IyWP_l, 0]) @ mem.R0.T
                        IxWP, IyWP = I_rot[0, 0], I_rot[1, 1]
                    Fvec[6 * inode + 3] += -sinBeta * M
                    Fvec[6 * inode + 4] += M * cosBeta
                    xWP, yWP = rWP[0], rWP[1]
                    b = 6 * inode
                    Cmat[b + 2, b + 2] += rho * g * AWP / cosPhi
                    Cmat[b + 2, b + 3] += rho * g * (-AWP * yWP)
                    Cmat[b + 2, b + 4] += rho * g * (AWP * xWP)
                    Cmat[b + 3, b + 2] += rho * g * (-AWP * yWP)
                    Cmat[b + 3, b + 3] += rho * g * (IxWP + AWP * yWP**2)
                    Cmat[b + 3, b + 4] += rho * g * (AWP * xWP * yWP)
                    Cmat[b + 4, b + 2] += rho * g * (AWP * xWP)
                    Cmat[b + 4, b + 3] += rho * g * (AWP * xWP * yWP)
                    Cmat[b + 4, b + 4] += rho * g * (IyWP + AWP * xWP**2)

    rCB = r_centerV / V_UW if V_UW > 0 else np.zeros(3)
    return dict(Fvec=Fvec, Cmat=Cmat, V_UW=V_UW, r_centerV=r_centerV, rCB=rCB,
                AWP=AWP, IWP=IWP, xWP=xWP, yWP=yWP)


def _rotated_member(mem, th):
    """Shallow member copy with axes rotated by the (finite) node
    rotation vector th — member.setPosition tracking nodeList[0].r[3:]
    (raft_member.py:348-357)."""
    import dataclasses

    if th is None or not np.any(th):
        return mem
    R = _rotmat(th)
    return dataclasses.replace(
        mem, q0=R @ mem.q0, p10=R @ mem.p10, p20=R @ mem.p20,
        R0=R @ mem.R0)


def calc_statics_general(fs, Xi0=None):
    """FOWT.calcStatics equivalent for mixed rigid/flexible structures
    (raft_fowt.py:811-1285), optionally at a DISPLACED mean pose: node
    positions from the nonlinear rigid-link/beam kinematics
    (setNodesPosition, raft_fowt.py:669-752), member axes rotated with
    their nodes, and T rebuilt at the displaced positions.  Returns the
    same dict as :func:`~raft_tpu_torch.physics.statics.calc_statics`
    (numpy values, no row axis)."""
    rho, g = fs.rho_water, fs.g
    N = fs.n_nodes
    nF = 6 * N
    T = fs.T
    dT = fs.dT
    node_r = fs.node_r0
    node_rot = None
    if Xi0 is not None and np.any(np.asarray(Xi0)):
        # self-consistent displaced-pose kinematics (see
        # Topology.self_consistent_displacements)
        disp, T = fs.topology.self_consistent_displacements(
            fs.T, fs.reducedDOF, fs.root_id, np.asarray(Xi0, dtype=float))
        node_r = fs.node_r0 + disp[:, :3]
        node_rot = disp[:, 3:]

    M_full = np.zeros((nF, nF))
    Msub_full = np.zeros((nF, nF))
    Cs_full = np.zeros((nF, nF))
    Cssub_full = np.zeros((nF, nF))
    Ch_full = np.zeros((nF, nF))
    Ce_full = np.zeros((nF, nF))
    W_full = np.zeros(nF)
    Wsub_full = np.zeros(nF)
    Wh_full = np.zeros(nF)
    f0_full = np.zeros(nF)
    Wint_s_full = np.zeros(nF)
    Wint_h_full = np.zeros(nF)

    m_center_sum = np.zeros(3)
    m_sub_sum = np.zeros(3)
    m_sub = 0.0
    VTOT = AWP_TOT = IWPx = IWPy = 0.0
    Sum_V_rCB = np.zeros(3)
    mtower, rCG_tow = [], []
    mem_info = []

    claimed = set(d[0] for d in fs.reducedDOF)

    for im, mem in enumerate(fs.members):
        n0 = int(fs.member_node[im])
        if node_rot is not None:
            mem = _rotated_member(mem, node_rot[n0])
        if mem.mtype == "rigid":
            nn = 1
            r_n = node_r[n0]
            if mem.part_of != "nacelle":
                M6, mass, s_bar = member_inertia(
                    mem, _t(mem.R0), _t(mem.q0), 1, _F64)
                M6 = M6[0].numpy()
                mass = float(mass[0])
                dCG = np.asarray(mem.q0) * float(s_bar[0])
                W6, C6 = _weight_point(mass, dCG, g)
                sl = slice(6 * n0, 6 * n0 + 6)
                M_full[sl, sl] += M6
                W_full[sl.start:sl.stop] += W6
                Cs_full[sl, sl] += C6
                center = dCG + node_r[n0]
                m_center_sum += center * mass
                if mem.part_of == "tower":
                    mtower.append(mass)
                    rCG_tow.append(center)
                else:
                    Msub_full[sl, sl] += M6
                    Cssub_full[sl, sl] += C6
                    Wsub_full[sl.start:sl.stop] += W6
                    m_sub += mass
                    m_sub_sum += center * mass
                mem_info.append(dict(mass=mass, center=center, V=None))
            elif mem.name != "nacelle":
                mem_info.append(dict(mass=0.0, center=np.zeros(3), V=None))
                continue
            else:
                mem_info.append(dict(mass=0.0, center=np.zeros(3), V=None))
            hs = {k: v[0].numpy() for k, v in member_hydrostatics(
                mem, _t(mem.q0), _t(mem.R0), _t(r_n), rho, g, 1,
                _F64).items()}
            sl = slice(6 * n0, 6 * n0 + 6)
            Wh_full[sl.start:sl.stop] += np.asarray(hs["Fvec"])
            Ch_full[sl, sl] += np.asarray(hs["Cmat"])
            V = float(hs["V_UW"])
            rCB_m = (np.asarray(hs["r_centerV"]) / V - r_n) if V > 0 else np.zeros(3)
            xWP = float(hs["xWP"]) - r_n[0] + node_r[n0][0]
            yWP = float(hs["yWP"]) - r_n[1] + node_r[n0][1]
            VTOT += V
            AWP_TOT += float(hs["AWP"])
            IWPx += float(hs["IWP"]) + float(hs["AWP"]) * yWP**2
            IWPy += float(hs["IWP"]) + float(hs["AWP"]) * xWP**2
            Sum_V_rCB += (rCB_m + node_r[n0]) * V
            mem_info[-1]["V"] = V
            mem_info[-1]["rCB"] = rCB_m + node_r[n0]
        else:  # beam
            nn = mem.ns
            sl = slice(6 * n0, 6 * (n0 + nn))
            r_nodes_m = node_r[n0:n0 + nn]
            arr = _beam_member_arrays(mem, r_nodes_m, g)
            M_full[sl, sl] += arr["M"]
            W_full[sl.start:sl.stop] += arr["W"]
            Cs_full[sl, sl] += arr["C_struc"]
            Ce_full[sl, sl] += arr["Kf"]
            m_center_sum += arr["center"] * arr["mass"]
            if mem.part_of == "tower":
                mtower.append(arr["mass"])
                rCG_tow.append(arr["center"])
            else:
                Msub_full[sl, sl] += arr["M"]
                Cssub_full[sl, sl] += arr["C_struc"]
                Wsub_full[sl.start:sl.stop] += arr["W"]
                m_sub += arr["mass"]
                m_sub_sum += arr["center"] * arr["mass"]
            hs = _beam_hydrostatics(mem, r_nodes_m, rho, g)
            Wh_full[sl.start:sl.stop] += hs["Fvec"]
            Ch_full[sl, sl] += hs["Cmat"]
            V = hs["V_UW"]
            VTOT += V
            AWP_TOT += hs["AWP"]
            IWPx += hs["IWP"] + hs["AWP"] * hs["yWP"] ** 2
            IWPy += hs["IWP"] + hs["AWP"] * hs["xWP"] ** 2
            Sum_V_rCB += hs["r_centerV"]
            mem_info.append(dict(mass=arr["mass"], center=arr["center"],
                                 V=V, rCB=hs["rCB"]))

            # internal loads at beam end nodes (raft_fowt.py:1088-1115)
            endA, endB = n0, n0 + nn - 1
            incA = endA not in claimed
            incB = endB not in claimed
            FwA = FwB = np.zeros(6)
            FbA = FbB = np.zeros(6)
            if incA and incB:
                FwA, _ = _weight_point(arr["mass"] / 2, arr["center"] - node_r[endA], g)
                FwB, _ = _weight_point(arr["mass"] / 2, arr["center"] - node_r[endB], g)
                FbA = _force3to6(np.array([0, 0, rho * g * V / 2]), hs["rCB"] - node_r[endA])
                FbB = _force3to6(np.array([0, 0, rho * g * V / 2]), hs["rCB"] - node_r[endB])
            elif incA:
                FwA, _ = _weight_point(arr["mass"], arr["center"] - node_r[endA], g)
                FbA = _force3to6(np.array([0, 0, rho * g * V]), hs["rCB"] - node_r[endA])
            elif incB:
                FwB, _ = _weight_point(arr["mass"], arr["center"] - node_r[endB], g)
                FbB = _force3to6(np.array([0, 0, rho * g * V]), hs["rCB"] - node_r[endB])
            Wint_s_full[6 * endA:6 * endA + 6] += FwA
            Wint_s_full[6 * endB:6 * endB + 6] += FwB
            Wint_h_full[6 * endA:6 * endA + 6] += FbA
            Wint_h_full[6 * endB:6 * endB + 6] += FbB

    # ---- RNA (raft_fowt.py:1033-1052)
    for ir, rot in enumerate(fs.rotors):
        node = int(fs.rotor_node[ir])
        Rn = np.eye(3)
        if node_rot is not None and np.any(node_rot[node]):
            Rn = _rotmat(node_rot[node])
        Mm = np.diag([rot.mRNA, rot.mRNA, rot.mRNA, rot.IxRNA, rot.IrRNA, rot.IrRNA])
        Mm = tf.rotate_matrix_6(torch.as_tensor(Mm, **_F64),
                                torch.as_tensor(Rn @ rot.R_q0, **_F64)).numpy()
        dCG = (Rn @ rot.q_rel) * rot.xCG_RNA
        W6, C6 = _weight_point(rot.mRNA, dCG, g)
        sl = slice(6 * node, 6 * node + 6)
        W_full[sl.start:sl.stop] += W6
        M_full[sl, sl] += _translate6(Mm, dCG)
        Cs_full[sl, sl] += C6
        m_center_sum += (rot.r_rel + dCG) * rot.mRNA

    # ---- point inertias / loads
    for pi_ in fs.pointInertias:
        node = int(np.argmin(np.linalg.norm(node_r - np.asarray(pi_["r"]), axis=1)))
        dR = np.asarray(pi_["r"]) - node_r[node]
        W6, C6 = _weight_point(pi_["m"], dR, g)
        M6 = _translate6(np.asarray(pi_["inertia"], dtype=float), dR)
        sl = slice(6 * node, 6 * node + 6)
        W_full[sl.start:sl.stop] += W6
        M_full[sl, sl] += M6
        Cs_full[sl, sl] += C6
        Msub_full[sl, sl] += M6
        Cssub_full[sl, sl] += C6
        Wsub_full[sl.start:sl.stop] += W6
        m_sub += pi_["m"]
        m_sub_sum += np.asarray(pi_["r"]) * pi_["m"]
        m_center_sum += np.asarray(pi_["r"]) * pi_["m"]
    for pl in fs.pointLoads:
        node = int(np.argmin(np.linalg.norm(node_r - np.asarray(pl["r"]), axis=1)))
        f6 = np.asarray(pl["f"], dtype=float).copy()
        f6[3:] += np.cross(np.asarray(pl["r"]) - node_r[node], f6[:3])
        f0_full[6 * node:6 * node + 6] += f6

    # ---- reduce (raft_fowt.py:1118-1128)
    M_struc = T.T @ M_full @ T
    M_struc_sub = T.T @ Msub_full @ T
    C_hydro = T.T @ Ch_full @ T
    C_struc = T.T @ Cs_full @ T
    C_struc_sub = T.T @ Cssub_full @ T
    C_elast = T.T @ Ce_full @ T
    W_struc = T.T @ W_full
    W_hydro = T.T @ Wh_full
    f0_add = T.T @ f0_full
    W_int_s = T.T @ Wint_s_full
    W_int_h = T.T @ Wint_h_full

    # ---- geometric stiffness of flexible members (raft_fowt.py:1131-1180)
    def geom_stiffness(mem, n0, force_red):
        nn = mem.ns
        Wnodes = np.zeros((nn, 6))
        for i in range(nn):
            Wnodes[i] = T[6 * (n0 + i):6 * (n0 + i) + 6, :] @ force_red
        Kg = np.zeros((6 * nn, 6 * nn))
        for i in range(nn):
            W_after = np.sum(Wnodes[i + 1:], axis=0)
            W_before = -W_after - Wnodes[i]
            r_b = np.zeros(3)
            r_a = np.zeros(3)
            if i != 0:
                r_b = (node_r[n0 + i] + node_r[n0 + i - 1]) / 2 - node_r[n0 + i]
            if i != nn - 1:
                r_a = (node_r[n0 + i] + node_r[n0 + i + 1]) / 2 - node_r[n0 + i]
            Kn = np.zeros((6, 6))
            Kn[3, 3] = (W_after[2] * r_a[2] + W_before[2] * r_b[2]) + (W_after[1] * r_a[1] + W_before[1] * r_b[1])
            Kn[4, 4] = (W_after[2] * r_a[2] + W_before[2] * r_b[2]) + (W_after[0] * r_a[0] + W_before[0] * r_b[0])
            Kn[5, 5] = (W_after[1] * r_a[1] + W_before[1] * r_b[1]) + (W_after[0] * r_a[0] + W_before[0] * r_b[0])
            Kn[3, 4] = -W_after[1] * r_a[0] - W_before[1] * r_b[0]
            Kn[3, 5] = -W_after[2] * r_a[0] - W_before[2] * r_b[0]
            Kn[4, 5] = -W_after[2] * r_a[1] - W_before[2] * r_b[1]
            Kn[4, 3] = -W_after[0] * r_a[1] - W_before[0] * r_b[1]
            Kn[5, 4] = -W_after[0] * r_a[2] - W_before[0] * r_b[2]
            Kn[5, 3] = -W_after[1] * r_a[2] - W_before[1] * r_b[2]
            Kg[6 * i:6 * i + 6, 6 * i:6 * i + 6] = Kn
        return Kg

    Kg_s_full = np.zeros((nF, nF))
    Kg_h_full = np.zeros((nF, nF))
    for im, mem in enumerate(fs.members):
        if mem.mtype == "beam":
            n0 = int(fs.member_node[im])
            sl = slice(6 * n0, 6 * (n0 + mem.ns))
            Kg_s_full[sl, sl] = geom_stiffness(mem, n0, W_struc + W_int_s)
            Kg_h_full[sl, sl] = geom_stiffness(mem, n0, W_hydro + W_int_h)
    C_struc = C_struc + T.T @ Kg_s_full @ T
    C_hydro = C_hydro + T.T @ Kg_h_full @ T

    # ---- dT geometric terms (raft_fowt.py:1182-1194)
    nD = fs.nDOF
    Cg_h = -np.einsum("fij,f->ij", dT, Wh_full + Wint_h_full)
    Cg_s = -np.einsum("fij,f->ij", dT, W_full + Wint_s_full)
    Cg_ss = -np.einsum("fij,f->ij", dT, Wsub_full)
    C_hydro = C_hydro + Cg_h
    C_struc = C_struc + Cg_s
    C_struc_sub = C_struc_sub + Cg_ss

    sym = lambda A: 0.5 * (A + A.T)
    M_struc, M_struc_sub = sym(M_struc), sym(M_struc_sub)
    C_hydro, C_struc, C_struc_sub = sym(C_hydro), sym(C_struc), sym(C_struc_sub)
    C_elast = sym(C_elast)

    # ---- totals (raft_fowt.py:1206-1285)
    Xh = np.array([1.0 if d[1] == 0 else 0.0 for d in fs.reducedDOF])
    m_all = float(np.sum((M_struc @ Xh) * Xh))
    rCG = m_center_sum / m_all
    rCG_sub = m_sub_sum / m_sub if m_sub > 0 else np.zeros(3)
    rCB = Sum_V_rCB / VTOT if VTOT > 0 else np.zeros(3)
    zMeta = rCB[2] + IWPx / VTOT if VTOT > 0 else 0.0

    M_sub6 = _translate6(M_struc_sub[:6, :6], -rCG_sub)
    M_all6 = _translate6(M_struc[:6, :6], -rCG)

    pb, m_ballast = [], []
    for mem in fs.members:
        if mem.part_of == "nacelle":
            continue
        for p in mem.pfill:
            if p != 0 and p not in pb:
                pb.append(p)
    m_ballast = np.zeros(len(pb))
    for mem in fs.members:
        if mem.part_of == "nacelle":
            continue
        for mf, p in zip(mem.mfill, mem.pfill):
            if p != 0:
                m_ballast[pb.index(p)] += mf

    return dict(
        M_struc=M_struc, M_struc_sub=M_struc_sub, C_struc=C_struc,
        C_struc_sub=C_struc_sub, C_hydro=C_hydro, C_elast=C_elast,
        W_struc=W_struc, W_hydro=W_hydro, f0_additional=f0_add,
        rCG=rCG, rCG_sub=rCG_sub, rCB=rCB, m=m_all, m_sub=m_sub,
        V=VTOT, AWP=AWP_TOT, rM=np.array([rCB[0], rCB[1], zMeta]),
        m_ballast=m_ballast, pb=pb, mtower=mtower, rCG_tow=rCG_tow,
        M_all6=M_all6, M_sub6=M_sub6, r_nodes=node_r,
        R_ptfm=np.eye(3), Tn=None,
    )
