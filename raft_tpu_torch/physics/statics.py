"""Statics of a rigid FOWT: rigid kinematics, mass/inertia, weight and
hydrostatics (torch counterparts of ``raft_tpu/physics/statics.py``).

:func:`platform_kinematics` and :func:`node_T` are batched over rows and
run on the evaluating device.  :func:`calc_statics` is build-time host
work, as in the reference (which pins it to the CPU): one design, float64
tensors on the CPU, the member geometry integrals already reduced to
per-element constants by :mod:`raft_tpu_torch.structure.members`, the
waterplane-crossing branches as ``torch.where`` masks, and the DOF
reduction node-block-wise with ``T_n = [[I, H(r_n - r_root)], [0, I]]``
plus the closed-form geometric stiffness.  Rigid single-body FOWTs only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch.ops import frustum as fr
from raft_tpu_torch.ops import transforms as tf

_HOST = dict(dtype=torch.float64, device="cpu")


def platform_kinematics(node_r0, root, X):
    """Displaced node positions of single rigid bodies (exact rigid
    motion about each row's root node).

    node_r0 : (R, N, 3); root : (R,) int; X : (R, 6).  Returns
    (r_nodes (R, N, 3), R_ptfm (R, 3, 3), r_root (R, 3)).
    """
    R_ptfm = tf.rotation_matrix(X[:, 3], X[:, 4], X[:, 5])
    rows = torch.arange(X.shape[0], device=X.device)
    root = root.to(torch.int64)
    dvec = node_r0 - node_r0[rows, root][:, None, :]
    r_nodes = (node_r0 + X[:, None, :3]
               + (dvec @ R_ptfm.transpose(-1, -2) - dvec))
    return r_nodes, R_ptfm, r_nodes[rows, root]


def node_T(r_nodes, r_root):
    """Per-node reduction matrix ``[[I, H(d)], [0, I]]``, d = r_n - r_root.

    r_nodes : (..., N, 3); r_root : (..., 3) -> (..., N, 6, 6).
    """
    d = r_nodes - r_root[..., None, :]
    H = tf.skew(d)
    I3 = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape)
    Z3 = torch.zeros_like(H)
    top = torch.cat([I3, H], dim=-1)
    bot = torch.cat([Z3, I3], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ------------------------------------------------------------ member pieces

def member_inertia(mem, R_mem, q):
    """Member mass matrix (6x6 about its node) from the precomputed
    inertia elements.  Returns (M6, mass, s_bar, M6_e) with s_bar the
    axial CG offset."""
    m_e = torch.as_tensor(mem.elem_mass, **_HOST)
    s_e = torch.as_tensor(mem.elem_s, **_HOST)
    ne = m_e.shape[0]
    I_loc = torch.zeros((ne, 3, 3), **_HOST)
    I_loc[:, 0, 0] = torch.as_tensor(mem.elem_Ixx, **_HOST)
    I_loc[:, 1, 1] = torch.as_tensor(mem.elem_Iyy, **_HOST)
    I_loc[:, 2, 2] = torch.as_tensor(mem.elem_Izz, **_HOST)
    I_rot = R_mem @ I_loc @ R_mem.T

    M6_e = torch.zeros((ne, 6, 6), **_HOST)
    M6_e[:, 0, 0] = m_e
    M6_e[:, 1, 1] = m_e
    M6_e[:, 2, 2] = m_e
    M6_e[:, 3:, 3:] = I_rot

    r_e = q[None, :] * s_e[:, None]
    M6 = torch.sum(tf.translate_matrix_6to6(M6_e, r_e), dim=0)
    mass = torch.sum(m_e)
    s_bar = torch.where(mass > 0, torch.sum(m_e * s_e)
                        / torch.where(mass > 0, mass, 1.0), 0.0)
    return M6, mass, s_bar, M6_e


def member_hydrostatics(mem, q, p1, p2, R_mem, r_node, rho, g):
    """Buoyancy force/stiffness of one rigid member about its node, over
    its sections with crossing/submerged masks (the reference RAFT's
    ``raft_member.py:838-1156``, rigid branch).

    Returns dict with Fvec (6), Cmat (6, 6), V_UW, r_centerV (3),
    AWP, IWP, xWP, yWP (last-crossing values; positions global).
    """
    st = torch.as_tensor(mem.stations, **_HOST)
    n = len(mem.stations)
    circ = mem.circular

    beta = torch.atan2(q[1], q[0])
    phi = torch.atan2(torch.sqrt(q[0] ** 2 + q[1] ** 2), q[2])
    cosPhi, sinPhi, tanPhi = torch.cos(phi), torch.sin(phi), torch.tan(phi)
    cosBeta, sinBeta = torch.cos(beta), torch.sin(beta)
    zero = torch.zeros((), **_HOST)

    Fvec = torch.zeros(6, **_HOST)
    Cmat = torch.zeros((6, 6), **_HOST)
    V_UW = zero
    r_centerV = torch.zeros(3, **_HOST)
    AWP = zero
    IWP = zero
    xWPr = zero
    yWPr = zero
    rg = rho * g

    for i in range(1, n):
        rA = r_node + q * st[i - 1]
        rB = r_node + q * st[i]
        crossing = rA[2] * rB[2] <= 0
        submerged = (~crossing) & (rA[2] <= 0) & (rB[2] <= 0)

        dz = rB[2] - rA[2]
        dz_safe = torch.where(dz == 0, 1.0, dz)
        frac0 = (0.0 - rA[2]) / dz_safe

        # waterplane geometry: the reference interpolates with the
        # diameter endpoints swapped (raft_member.py:902,908), kept
        if circ:
            dA_o, dB_o = float(mem.d[i - 1, 0]), float(mem.d[i, 0])
            dWP = dB_o + frac0 * (dA_o - dB_o)
            AWP_i = 0.25 * math.pi * dWP ** 2
            IWP_i = (math.pi / 64.0) * dWP ** 4
            IxWP_i = IWP_i
            IyWP_i = IWP_i
        else:
            slA_o = torch.as_tensor(mem.d[i - 1], **_HOST)
            slB_o = torch.as_tensor(mem.d[i], **_HOST)
            slWP = slB_o + frac0 * (slA_o - slB_o)
            AWP_i = slWP[0] * slWP[1]
            Ix_loc = (1.0 / 12.0) * slWP[0] * slWP[1] ** 3
            Iy_loc = (1.0 / 12.0) * slWP[0] ** 3 * slWP[1]
            I_loc = torch.diag(torch.stack([Ix_loc, Iy_loc, zero]))
            I_rot = R_mem @ I_loc @ R_mem.T
            IxWP_i = I_rot[0, 0]
            IyWP_i = I_rot[1, 1]

        cosPhi_safe = torch.where(cosPhi == 0, 1.0, cosPhi)
        LWP = torch.abs(rA[2] / cosPhi_safe)

        # ---- crossing branch (partially submerged)
        if circ:
            V_c, hc_c = fr.frustum_vcv_circ(float(mem.d[i - 1, 0]), dWP, LWP)
        else:
            V_c, hc_c = fr.frustum_vcv_rect(
                torch.as_tensor(mem.d[i - 1], **_HOST), slWP, LWP)
        r_center_c = rA + q * hc_c

        Fz_c = rg * V_c
        if circ:
            M_c = -rg * math.pi * (
                dWP ** 2 / 32.0 * (2.0 + tanPhi ** 2)
                + 0.5 * (rA[2] / cosPhi_safe) ** 2) * sinPhi
        else:
            M_c = zero

        F_c = tf.translate_force_3to6(
            torch.stack([0.0 * Fz_c, 0.0 * Fz_c, Fz_c]), rA - r_node)
        F_c[3] += M_c * (-sinBeta)
        F_c[4] += M_c * cosBeta

        xWP_c = rA[0] + frac0 * (rB[0] - rA[0]) - r_node[0]
        yWP_c = rA[1] + frac0 * (rB[1] - rA[1]) - r_node[1]
        r_rel_c = r_center_c - r_node
        C_c = torch.zeros((6, 6), **_HOST)
        C_c[2, 2] += rg * AWP_i / cosPhi_safe
        C_c[2, 3] += rg * (-AWP_i * yWP_c)
        C_c[2, 4] += rg * (AWP_i * xWP_c)
        C_c[3, 2] += rg * (-AWP_i * yWP_c)
        C_c[3, 3] += rg * (IxWP_i + AWP_i * yWP_c ** 2)
        C_c[3, 4] += rg * (AWP_i * xWP_c * yWP_c)
        C_c[4, 2] += rg * (AWP_i * xWP_c)
        C_c[4, 3] += rg * (AWP_i * xWP_c * yWP_c)
        C_c[4, 4] += rg * (IyWP_i + AWP_i * xWP_c ** 2)
        C_c[3, 3] += rg * V_c * r_rel_c[2]
        C_c[4, 4] += rg * V_c * r_rel_c[2]
        C_c[3, 5] += -rg * V_c * r_rel_c[0]
        C_c[4, 5] += -rg * V_c * r_rel_c[1]

        # ---- fully submerged branch
        if circ:
            V_s, hc_s = fr.frustum_vcv_circ(float(mem.d[i - 1, 0]),
                                            float(mem.d[i, 0]),
                                            st[i] - st[i - 1])
        else:
            V_s, hc_s = fr.frustum_vcv_rect(
                torch.as_tensor(mem.d[i - 1], **_HOST),
                torch.as_tensor(mem.d[i], **_HOST), st[i] - st[i - 1])
        r_center_s = rA + q * hc_s
        r_rel_s = r_center_s - r_node
        F_s = tf.translate_force_3to6(
            torch.stack([0.0 * V_s, 0.0 * V_s, rg * V_s]), r_rel_s)
        C_s = torch.zeros((6, 6), **_HOST)
        C_s[3, 3] += rg * V_s * r_rel_s[2]
        C_s[4, 4] += rg * V_s * r_rel_s[2]
        C_s[3, 5] += -rg * V_s * r_rel_s[0]
        C_s[4, 5] += -rg * V_s * r_rel_s[1]

        # ---- select by mask and accumulate
        c, s = crossing, submerged
        Fvec = Fvec + torch.where(c, F_c, 0.0) + torch.where(s, F_s, 0.0)
        Cmat = Cmat + torch.where(c, C_c, 0.0) + torch.where(s, C_s, 0.0)
        V_i = torch.where(c, V_c, torch.where(s, V_s, 0.0))
        r_center_i = torch.where(c, r_center_c,
                                 torch.where(s, r_center_s, 0.0))
        V_UW = V_UW + V_i
        r_centerV = r_centerV + r_center_i * V_i
        # member-level waterplane values keep the LAST crossing section
        AWP = torch.where(c, AWP_i, AWP)
        if circ:
            IWP = torch.where(c, IWP_i, IWP)
        xWPr = torch.where(c, xWP_c + r_node[0], xWPr)
        yWPr = torch.where(c, yWP_c + r_node[1], yWPr)

    return dict(Fvec=Fvec, Cmat=Cmat, V_UW=V_UW, r_centerV=r_centerV,
                AWP=AWP, IWP=IWP, xWP=xWPr, yWP=yWPr)


# ------------------------------------------------------------ FOWT assembly

def calc_statics(fs, Xi0=None):
    """Full FOWT statics about the root node in reduced DOFs (the
    reference's ``calc_statics``, rigid single-body branch: the port's
    FOWTStructure is always one rigid body), on the host in float64.  Returns a dict of tensors (and the ballast lists
    ``pb``, ``mtower``, ``rCG_tow``)."""
    rho, g = fs.rho_water, fs.g
    nDOF = fs.nDOF
    X = (torch.zeros((1, nDOF), **_HOST) if Xi0 is None
         else torch.as_tensor(np.asarray(Xi0, dtype=float), **_HOST)[None])
    node_r0 = torch.as_tensor(fs.node_r0, **_HOST)
    r_nodes, R_ptfm, r_root = platform_kinematics(
        node_r0[None], torch.tensor([fs.root_id]), X)
    r_nodes, R_ptfm, r_root = r_nodes[0], R_ptfm[0], r_root[0]
    Tn = node_T(r_nodes, r_root)                             # (N, 6, 6)

    N = fs.n_nodes
    M_blocks = torch.zeros((N, 6, 6), **_HOST)
    Msub_blocks = torch.zeros((N, 6, 6), **_HOST)
    Cs_blocks = torch.zeros((N, 6, 6), **_HOST)
    Cssub_blocks = torch.zeros((N, 6, 6), **_HOST)
    Ch_blocks = torch.zeros((N, 6, 6), **_HOST)
    W_blocks = torch.zeros((N, 6), **_HOST)
    Wsub_blocks = torch.zeros((N, 6), **_HOST)
    Wh_blocks = torch.zeros((N, 6), **_HOST)
    f0_blocks = torch.zeros((N, 6), **_HOST)

    zero = torch.zeros((), **_HOST)
    m_center_sum = torch.zeros(3, **_HOST)
    m_sub_sum = torch.zeros(3, **_HOST)
    m_sub = zero
    VTOT = zero
    AWP_TOT = zero
    IWPx_TOT = zero
    IWPy_TOT = zero
    Sum_V_rCB = torch.zeros(3, **_HOST)
    mtower = []
    rCG_tow = []

    def h(a):
        return torch.as_tensor(np.asarray(a, dtype=float), **_HOST)

    # ---- members (the inertia loop excludes nacelles; hydrostatics of
    # members named 'nacelle' are added separately)
    for im, mem in enumerate(fs.members):
        node = int(fs.member_node[im])
        r_node = r_nodes[node]
        R_mem = R_ptfm @ h(mem.R0)
        q = R_ptfm @ h(mem.q0)
        p1 = R_ptfm @ h(mem.p10)
        p2 = R_ptfm @ h(mem.p20)

        if mem.part_of != "nacelle":
            M6, mass, s_bar, _ = member_inertia(mem, R_mem, q)
            W6, C6 = tf.weight_of_point_mass(mass, q * s_bar, g=g)
            M_blocks[node] += M6
            W_blocks[node] += W6
            Cs_blocks[node] += C6
            center = q * s_bar + h(fs.node_r0[node])  # the reference's r0
            m_center_sum = m_center_sum + center * mass
            if mem.part_of == "tower":
                mtower.append(mass)
                rCG_tow.append(center)
            else:
                Msub_blocks[node] += M6
                Cssub_blocks[node] += C6
                Wsub_blocks[node] += W6
                m_sub = m_sub + mass
                m_sub_sum = m_sub_sum + center * mass
            hs = member_hydrostatics(mem, q, p1, p2, R_mem, r_node, rho, g)
        elif mem.name == "nacelle":
            hs = member_hydrostatics(mem, q, p1, p2, R_mem, r_node, rho, g)
        else:
            continue

        Wh_blocks[node] += hs["Fvec"]
        Ch_blocks[node] += hs["Cmat"]
        xWP = hs["xWP"] - r_node[0] + float(fs.node_r0[node][0])
        yWP = hs["yWP"] - r_node[1] + float(fs.node_r0[node][1])
        VTOT = VTOT + hs["V_UW"]
        AWP_TOT = AWP_TOT + hs["AWP"]
        IWPx_TOT = IWPx_TOT + hs["IWP"] + hs["AWP"] * yWP ** 2
        IWPy_TOT = IWPy_TOT + hs["IWP"] + hs["AWP"] * xWP ** 2
        V = hs["V_UW"]
        rCB_m = torch.where(
            V > 0, hs["r_centerV"] / torch.where(V > 0, V, 1.0) - r_node,
            torch.zeros(3, **_HOST))
        Sum_V_rCB = Sum_V_rCB + (rCB_m + h(fs.node_r0[node])) * V

    # ---- RNA inertia, and the blade buoyancy of submerged rotors
    for ir, rot in enumerate(fs.rotors):
        node = int(fs.rotor_node[ir])
        q_rot = R_ptfm @ h(rot.q_rel)
        R_q = h(rot.R_q0) @ R_ptfm
        Mmat = torch.diag(h([rot.mRNA, rot.mRNA, rot.mRNA,
                             rot.IxRNA, rot.IrRNA, rot.IrRNA]))
        Mmat = tf.rotate_matrix_6(Mmat, R_q)
        dCG = q_rot * rot.xCG_RNA
        W6, C6 = tf.weight_of_point_mass(rot.mRNA, dCG, g=g)
        W_blocks[node] += W6
        M_blocks[node] += tf.translate_matrix_6to6(Mmat, dCG)
        Cs_blocks[node] += C6
        r_CG_rel = R_ptfm @ h(rot.r_rel) + dCG
        m_center_sum = m_center_sum + r_CG_rel * rot.mRNA
        if rot.hydro is not None:
            Wh_blocks[node] += h(rot.hydro["Fvec"])
            Ch_blocks[node] += h(rot.hydro["Cmat"])
            V_rot = float(rot.hydro["V"])
            VTOT = VTOT + V_rot
            Sum_V_rCB = Sum_V_rCB + h(fs.node_r0[node]) * V_rot

    # ---- point inertias
    for pi in fs.pointInertias:
        node = int(np.argmin(np.linalg.norm(
            fs.node_r0 - np.asarray(pi["r"]), axis=1)))
        dR = h(pi["r"] - fs.node_r0[node])
        W6, C6 = tf.weight_of_point_mass(pi["m"], dR, g=g)
        M6 = tf.translate_matrix_6to6(h(pi["inertia"]), dR)
        W_blocks[node] += W6
        M_blocks[node] += M6
        Cs_blocks[node] += C6
        Msub_blocks[node] += M6
        Cssub_blocks[node] += C6
        Wsub_blocks[node] += W6
        m_sub = m_sub + pi["m"]
        m_sub_sum = m_sub_sum + h(pi["r"]) * pi["m"]
        m_center_sum = m_center_sum + h(pi["r"]) * pi["m"]

    # ---- user point loads
    for pl in fs.pointLoads:
        node = int(np.argmin(np.linalg.norm(
            fs.node_r0 - np.asarray(pl["r"]), axis=1)))
        f0_blocks[node] += tf.transform_force_6(h(pl["f"]),
                                                h(pl["r"] - fs.node_r0[node]))

    # ---- reduce to the structure DOFs
    def reduce_mat(blocks):
        return torch.einsum("nia,nij,njb->ab", Tn, blocks, Tn)

    def reduce_vec(blocks):
        return torch.einsum("nia,ni->a", Tn, blocks)

    M_struc = reduce_mat(M_blocks)
    M_struc_sub = reduce_mat(Msub_blocks)
    C_struc = reduce_mat(Cs_blocks)
    C_struc_sub = reduce_mat(Cssub_blocks)
    C_hydro = reduce_mat(Ch_blocks)
    W_struc = reduce_vec(W_blocks)
    W_hydro = reduce_vec(Wh_blocks)
    f0_additional = reduce_vec(f0_blocks)

    # ---- geometric stiffness:
    # C_geom[3+i, 3+j] = -sum_n cross(cross(e_j, d_n), F_n)[i]
    d_n = r_nodes - r_root
    eye3 = torch.eye(3, **_HOST)

    def c_geom(F_blocks):
        F = F_blocks[:, :3]
        cj = tf.cross(eye3[None, :, :], d_n[:, None, :])      # (N, 3j, 3)
        contrib = tf.cross(cj, F[:, None, :])                  # (N, 3j, 3i)
        C = torch.zeros((6, 6), **_HOST)
        C[3:, 3:] = -torch.sum(contrib, dim=0).T
        return C

    C_hydro = C_hydro + c_geom(Wh_blocks)
    C_struc = C_struc + c_geom(W_blocks)
    C_struc_sub = C_struc_sub + c_geom(Wsub_blocks)

    def sym(A):
        return 0.5 * (A + A.T)

    M_struc, M_struc_sub = sym(M_struc), sym(M_struc_sub)
    C_hydro, C_struc, C_struc_sub = sym(C_hydro), sym(C_struc), sym(C_struc_sub)

    # ---- totals
    m_all = M_struc[0, 0]
    rCG = m_center_sum / m_all
    rCG_sub = m_sub_sum / torch.where(m_sub > 0, m_sub, 1.0)
    M_sub6 = tf.translate_matrix_6to6(M_struc_sub[:6, :6], -rCG_sub)
    M_all6 = tf.translate_matrix_6to6(M_struc[:6, :6], -rCG)
    rCB = Sum_V_rCB / torch.where(VTOT > 0, VTOT, 1.0)
    zMeta = torch.where(VTOT > 0,
                        rCB[2] + IWPx_TOT / torch.where(VTOT > 0, VTOT, 1.0),
                        0.0)

    # ballast bookkeeping
    pb = []
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
        C_struc_sub=C_struc_sub, C_hydro=C_hydro,
        C_elast=torch.zeros((nDOF, nDOF), **_HOST),
        W_struc=W_struc, W_hydro=W_hydro, f0_additional=f0_additional,
        rCG=rCG, rCG_sub=rCG_sub, rCB=rCB, m=m_all, m_sub=m_sub, V=VTOT,
        AWP=AWP_TOT, rM=torch.stack([rCB[0], rCB[1], zMeta]),
        m_ballast=torch.as_tensor(m_ballast, **_HOST), pb=pb,
        mtower=mtower, rCG_tow=rCG_tow, M_all6=M_all6, M_sub6=M_sub6,
        r_nodes=r_nodes, R_ptfm=R_ptfm, Tn=Tn,
    )
