"""Statics of a rigid FOWT: rigid kinematics, mass/inertia, weight and
hydrostatics (torch counterparts of ``raft_tpu/physics/statics.py``).

Every function is batched over a leading row axis R and runs on the
device of its inputs.  :func:`calc_statics` serves two callers: the
builder, at one row on the CPU in float64 (the member geometry reduced
to per-element constants by :mod:`raft_tpu_torch.structure.members`),
and the geometry design axis, at R rows on the evaluating device with
per-row member constants from :func:`raft_tpu_torch.structure.
members_traced.apply_geometry` (differentiable in them).  The
waterplane-crossing branches are ``torch.where`` masks, and the DOF
reduction is node-block-wise with ``T_n = [[I, H(r_n - r_root)], [0,
I]]`` plus the closed-form geometric stiffness.  Rigid single-body FOWTs
only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch.ops import frustum as fr
from raft_tpu_torch.ops import transforms as tf


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

def _rows(a, R, kw):
    """A member constant as an (R, ...) tensor: a tensor already carries
    its row axis (the geometry axis); numpy is shared by every row."""
    if isinstance(a, torch.Tensor):
        return a.to(**kw)
    t = torch.as_tensor(np.asarray(a, dtype=float), **kw)
    return t.expand((R,) + t.shape)


def _mat(entries, like):
    """A (..., 6, 6) matrix from ``{(i, j): (...) tensor}``, zero
    elsewhere, built without writing into a tensor."""
    z = torch.zeros_like(like)
    return torch.stack([torch.stack([entries.get((i, j), z)
                                     for j in range(6)], dim=-1)
                        for i in range(6)], dim=-2)


def member_inertia(mem, R_mem, q, R, kw):
    """Member mass matrix (6x6 about its node) of R rows from its inertia
    elements.  R_mem (R, 3, 3), q (R, 3).  Returns (M6 (R, 6, 6), mass
    (R,), s_bar (R,)) with s_bar the axial CG offset."""
    m_e = _rows(mem.elem_mass, R, kw)                        # (R, ne)
    s_e = _rows(mem.elem_s, R, kw)
    I_loc = torch.diag_embed(torch.stack(
        [_rows(mem.elem_Ixx, R, kw), _rows(mem.elem_Iyy, R, kw),
         _rows(mem.elem_Izz, R, kw)], dim=-1))              # (R, ne, 3, 3)
    Rm = R_mem[:, None]
    I_rot = Rm @ I_loc @ Rm.transpose(-1, -2)
    mI = m_e[..., None, None] * torch.eye(3, **kw)
    Z3 = torch.zeros_like(mI)
    M6_e = torch.cat([torch.cat([mI, Z3], dim=-1),
                      torch.cat([Z3, I_rot], dim=-1)], dim=-2)
    r_e = q[:, None, :] * s_e[..., None]
    M6 = torch.sum(tf.translate_matrix_6to6(M6_e, r_e), dim=1)
    mass = torch.sum(m_e, dim=-1)
    s_bar = torch.where(mass > 0, torch.sum(m_e * s_e, dim=-1)
                        / torch.where(mass > 0, mass, 1.0), 0.0)
    return M6, mass, s_bar


def member_hydrostatics(mem, q, R_mem, r_node, rho, g, R, kw):
    """Buoyancy force/stiffness of one rigid member about its node, over
    its sections with crossing/submerged masks (the reference RAFT's
    ``raft_member.py:838-1156``, rigid branch), for R rows: q (R, 3),
    R_mem (R, 3, 3), r_node (R, 3).

    Returns dict with Fvec (R, 6), Cmat (R, 6, 6), V_UW (R,), r_centerV
    (R, 3), AWP, IWP, xWP, yWP (R,) (last-crossing values; positions
    global).
    """
    st = np.asarray(mem.stations, dtype=float)
    n = len(st)
    circ = mem.circular
    d = _rows(mem.d, R, kw)                                  # (R, n, 2)

    beta = torch.atan2(q[:, 1], q[:, 0])
    phi = torch.atan2(torch.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2), q[:, 2])
    cosPhi, sinPhi, tanPhi = torch.cos(phi), torch.sin(phi), torch.tan(phi)
    cosBeta, sinBeta = torch.cos(beta), torch.sin(beta)
    zero = torch.zeros(R, **kw)
    cosPhi_safe = torch.where(cosPhi == 0, 1.0, cosPhi)

    Fvec = torch.zeros((R, 6), **kw)
    Cmat = torch.zeros((R, 6, 6), **kw)
    V_UW = zero
    r_centerV = torch.zeros((R, 3), **kw)
    AWP = IWP = xWPr = yWPr = zero
    rg = rho * g

    for i in range(1, n):
        rA = r_node + q * st[i - 1]
        rB = r_node + q * st[i]
        crossing = rA[:, 2] * rB[:, 2] <= 0
        submerged = (~crossing) & (rA[:, 2] <= 0) & (rB[:, 2] <= 0)

        dz = rB[:, 2] - rA[:, 2]
        dz_safe = torch.where(dz == 0, 1.0, dz)
        frac0 = (0.0 - rA[:, 2]) / dz_safe

        # waterplane geometry: the reference interpolates with the
        # diameter endpoints swapped (raft_member.py:902,908), kept
        if circ:
            dA_o, dB_o = d[:, i - 1, 0], d[:, i, 0]
            dWP = dB_o + frac0 * (dA_o - dB_o)
            AWP_i = 0.25 * math.pi * dWP ** 2
            IWP_i = (math.pi / 64.0) * dWP ** 4
            IxWP_i = IyWP_i = IWP_i
        else:
            slA_o, slB_o = d[:, i - 1], d[:, i]
            slWP = slB_o + frac0[:, None] * (slA_o - slB_o)
            AWP_i = slWP[:, 0] * slWP[:, 1]
            Ix_loc = (1.0 / 12.0) * slWP[:, 0] * slWP[:, 1] ** 3
            Iy_loc = (1.0 / 12.0) * slWP[:, 0] ** 3 * slWP[:, 1]
            I_loc = torch.diag_embed(torch.stack([Ix_loc, Iy_loc, zero],
                                                 dim=-1))
            I_rot = R_mem @ I_loc @ R_mem.transpose(-1, -2)
            IxWP_i = I_rot[:, 0, 0]
            IyWP_i = I_rot[:, 1, 1]

        LWP = torch.abs(rA[:, 2] / cosPhi_safe)

        # ---- crossing branch (partially submerged)
        if circ:
            V_c, hc_c = fr.frustum_vcv_circ(d[:, i - 1, 0], dWP, LWP)
        else:
            V_c, hc_c = fr.frustum_vcv_rect(d[:, i - 1], slWP, LWP)
        r_center_c = rA + q * hc_c[:, None]

        Fz_c = rg * V_c
        if circ:
            M_c = -rg * math.pi * (
                dWP ** 2 / 32.0 * (2.0 + tanPhi ** 2)
                + 0.5 * (rA[:, 2] / cosPhi_safe) ** 2) * sinPhi
        else:
            M_c = zero

        F_c = tf.translate_force_3to6(
            torch.stack([0.0 * Fz_c, 0.0 * Fz_c, Fz_c], dim=-1), rA - r_node)
        F_c = F_c + torch.stack([zero, zero, zero, M_c * (-sinBeta),
                                 M_c * cosBeta, zero], dim=-1)

        xWP_c = rA[:, 0] + frac0 * (rB[:, 0] - rA[:, 0]) - r_node[:, 0]
        yWP_c = rA[:, 1] + frac0 * (rB[:, 1] - rA[:, 1]) - r_node[:, 1]
        r_rel_c = r_center_c - r_node
        C_c = _mat({
            (2, 2): rg * AWP_i / cosPhi_safe,
            (2, 3): rg * (-AWP_i * yWP_c),
            (2, 4): rg * (AWP_i * xWP_c),
            (3, 2): rg * (-AWP_i * yWP_c),
            (3, 3): rg * (IxWP_i + AWP_i * yWP_c ** 2)
            + rg * V_c * r_rel_c[:, 2],
            (3, 4): rg * (AWP_i * xWP_c * yWP_c),
            (4, 2): rg * (AWP_i * xWP_c),
            (4, 3): rg * (AWP_i * xWP_c * yWP_c),
            (4, 4): rg * (IyWP_i + AWP_i * xWP_c ** 2)
            + rg * V_c * r_rel_c[:, 2],
            (3, 5): -rg * V_c * r_rel_c[:, 0],
            (4, 5): -rg * V_c * r_rel_c[:, 1],
        }, zero)

        # ---- fully submerged branch
        if circ:
            V_s, hc_s = fr.frustum_vcv_circ(d[:, i - 1, 0], d[:, i, 0],
                                            st[i] - st[i - 1])
        else:
            V_s, hc_s = fr.frustum_vcv_rect(d[:, i - 1], d[:, i],
                                            st[i] - st[i - 1])
        r_center_s = rA + q * hc_s[:, None]
        r_rel_s = r_center_s - r_node
        F_s = tf.translate_force_3to6(
            torch.stack([0.0 * V_s, 0.0 * V_s, rg * V_s], dim=-1), r_rel_s)
        C_s = _mat({
            (3, 3): rg * V_s * r_rel_s[:, 2],
            (4, 4): rg * V_s * r_rel_s[:, 2],
            (3, 5): -rg * V_s * r_rel_s[:, 0],
            (4, 5): -rg * V_s * r_rel_s[:, 1],
        }, zero)

        # ---- select by mask and accumulate
        c, s_ = crossing, submerged
        Fvec = (Fvec + torch.where(c[:, None], F_c, 0.0)
                + torch.where(s_[:, None], F_s, 0.0))
        Cmat = (Cmat + torch.where(c[:, None, None], C_c, 0.0)
                + torch.where(s_[:, None, None], C_s, 0.0))
        V_i = torch.where(c, V_c, torch.where(s_, V_s, 0.0))
        r_center_i = torch.where(c[:, None], r_center_c,
                                 torch.where(s_[:, None], r_center_s, 0.0))
        V_UW = V_UW + V_i
        r_centerV = r_centerV + r_center_i * V_i[:, None]
        # member-level waterplane values keep the LAST crossing section
        AWP = torch.where(c, AWP_i, AWP)
        if circ:
            IWP = torch.where(c, IWP_i, IWP)
        xWPr = torch.where(c, xWP_c + r_node[:, 0], xWPr)
        yWPr = torch.where(c, yWP_c + r_node[:, 1], yWPr)

    return dict(Fvec=Fvec, Cmat=Cmat, V_UW=V_UW, r_centerV=r_centerV,
                AWP=AWP, IWP=IWP, xWP=xWPr, yWP=yWPr)


# ------------------------------------------------------------ FOWT assembly

class _NodeSum:
    """Per-node sums of (R, ...) terms, kept as a Python list (the node
    of every term is known when the model is built)."""

    def __init__(self, N, shape, kw):
        self.zero = torch.zeros(shape, **kw)
        self.v = [self.zero] * N

    def add(self, node, x):
        self.v[node] = self.v[node] + x

    def stacked(self):
        return torch.stack(self.v, dim=1)                  # (R, N, ...)


def calc_statics(fs, Xi0=None, rows=1, device="cpu", dtype=torch.float64):
    """Full FOWT statics about the root node in reduced DOFs (the
    reference's ``calc_statics``, rigid single-body branch) for ``rows``
    rows on ``device``.

    The members' constants are numpy (the builder's, shared by every
    row) or (rows, ...) tensors (:func:`~raft_tpu_torch.structure.
    members_traced.apply_geometry`'s).  ``Xi0`` is the pose, (nDOF,) or
    (rows, nDOF), default zero.  Returns a dict of (rows, ...) tensors
    and the lists ``pb`` (ballast densities), ``mtower`` and ``rCG_tow``
    (per tower member, (rows,) and (rows, 3))."""
    kw = dict(dtype=dtype, device=device)
    R = int(rows)
    rho, g = fs.rho_water, fs.g
    nDOF = fs.nDOF
    if Xi0 is None:
        X = torch.zeros((R, nDOF), **kw)
    else:
        X = torch.as_tensor(np.asarray(Xi0, dtype=float) if not isinstance(
            Xi0, torch.Tensor) else Xi0, **kw).expand(R, nDOF)
    node_r0 = torch.as_tensor(np.asarray(fs.node_r0, dtype=float), **kw)
    r_nodes, R_ptfm, r_root = platform_kinematics(
        node_r0.expand((R,) + node_r0.shape),
        torch.full((R,), fs.root_id, device=device), X)
    Tn = node_T(r_nodes, r_root)                             # (R, N, 6, 6)

    N = fs.n_nodes
    M_b, Msub_b, Cs_b, Cssub_b, Ch_b = (_NodeSum(N, (R, 6, 6), kw)
                                        for _ in range(5))
    W_b, Wsub_b, Wh_b, f0_b = (_NodeSum(N, (R, 6), kw) for _ in range(4))

    zero = torch.zeros(R, **kw)
    m_center_sum = torch.zeros((R, 3), **kw)
    m_sub_sum = torch.zeros((R, 3), **kw)
    m_sub = VTOT = AWP_TOT = IWPx_TOT = IWPy_TOT = zero
    Sum_V_rCB = torch.zeros((R, 3), **kw)
    mtower = []
    rCG_tow = []

    def h(a):
        return torch.as_tensor(np.asarray(a, dtype=float), **kw)

    # ---- members (the inertia loop excludes nacelles; hydrostatics of
    # members named 'nacelle' are added separately)
    for im, mem in enumerate(fs.members):
        node = int(fs.member_node[im])
        r_node = r_nodes[:, node]
        R_mem = R_ptfm @ h(mem.R0)
        q = R_ptfm @ h(mem.q0)

        if mem.part_of != "nacelle":
            M6, mass, s_bar = member_inertia(mem, R_mem, q, R, kw)
            W6, C6 = tf.weight_of_point_mass(mass, q * s_bar[:, None], g=g)
            M_b.add(node, M6)
            W_b.add(node, W6)
            Cs_b.add(node, C6)
            center = q * s_bar[:, None] + h(fs.node_r0[node])  # the ref's r0
            m_center_sum = m_center_sum + center * mass[:, None]
            if mem.part_of == "tower":
                mtower.append(mass)
                rCG_tow.append(center)
            else:
                Msub_b.add(node, M6)
                Cssub_b.add(node, C6)
                Wsub_b.add(node, W6)
                m_sub = m_sub + mass
                m_sub_sum = m_sub_sum + center * mass[:, None]
            hs = member_hydrostatics(mem, q, R_mem, r_node, rho, g, R, kw)
        elif mem.name == "nacelle":
            hs = member_hydrostatics(mem, q, R_mem, r_node, rho, g, R, kw)
        else:
            continue

        Wh_b.add(node, hs["Fvec"])
        Ch_b.add(node, hs["Cmat"])
        xWP = hs["xWP"] - r_node[:, 0] + float(fs.node_r0[node][0])
        yWP = hs["yWP"] - r_node[:, 1] + float(fs.node_r0[node][1])
        VTOT = VTOT + hs["V_UW"]
        AWP_TOT = AWP_TOT + hs["AWP"]
        IWPx_TOT = IWPx_TOT + hs["IWP"] + hs["AWP"] * yWP ** 2
        IWPy_TOT = IWPy_TOT + hs["IWP"] + hs["AWP"] * xWP ** 2
        V = hs["V_UW"][:, None]
        rCB_m = torch.where(
            V > 0, hs["r_centerV"] / torch.where(V > 0, V, 1.0) - r_node,
            0.0)
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
        W6, C6 = tf.weight_of_point_mass(
            torch.full((R,), float(rot.mRNA), **kw), dCG, g=g)
        W_b.add(node, W6)
        M_b.add(node, tf.translate_matrix_6to6(Mmat, dCG))
        Cs_b.add(node, C6)
        r_CG_rel = R_ptfm @ h(rot.r_rel) + dCG
        m_center_sum = m_center_sum + r_CG_rel * rot.mRNA
        if rot.hydro is not None:
            Wh_b.add(node, h(rot.hydro["Fvec"]))
            Ch_b.add(node, h(rot.hydro["Cmat"]))
            V_rot = float(rot.hydro["V"])
            VTOT = VTOT + V_rot
            Sum_V_rCB = Sum_V_rCB + h(fs.node_r0[node]) * V_rot

    # ---- point inertias
    for pi in fs.pointInertias:
        node = int(np.argmin(np.linalg.norm(
            fs.node_r0 - np.asarray(pi["r"]), axis=1)))
        dR = h(pi["r"] - fs.node_r0[node]).expand(R, 3)
        W6, C6 = tf.weight_of_point_mass(
            torch.full((R,), float(pi["m"]), **kw), dR, g=g)
        M6 = tf.translate_matrix_6to6(h(pi["inertia"]).expand(R, 6, 6), dR)
        for acc, x in ((W_b, W6), (M_b, M6), (Cs_b, C6), (Msub_b, M6),
                       (Cssub_b, C6), (Wsub_b, W6)):
            acc.add(node, x)
        m_sub = m_sub + pi["m"]
        m_sub_sum = m_sub_sum + h(pi["r"]) * pi["m"]
        m_center_sum = m_center_sum + h(pi["r"]) * pi["m"]

    # ---- user point loads
    for pl in fs.pointLoads:
        node = int(np.argmin(np.linalg.norm(
            fs.node_r0 - np.asarray(pl["r"]), axis=1)))
        f0_b.add(node, tf.transform_force_6(h(pl["f"]),
                                            h(pl["r"] - fs.node_r0[node])))

    # ---- reduce to the structure DOFs
    def reduce_mat(blocks):
        return torch.einsum("rnia,rnij,rnjb->rab", Tn, blocks.stacked(), Tn)

    def reduce_vec(blocks):
        return torch.einsum("rnia,rni->ra", Tn, blocks.stacked())

    M_struc = reduce_mat(M_b)
    M_struc_sub = reduce_mat(Msub_b)
    C_struc = reduce_mat(Cs_b)
    C_struc_sub = reduce_mat(Cssub_b)
    C_hydro = reduce_mat(Ch_b)
    W_struc = reduce_vec(W_b)
    W_hydro = reduce_vec(Wh_b)
    f0_additional = reduce_vec(f0_b)

    # ---- geometric stiffness:
    # C_geom[3+i, 3+j] = -sum_n cross(cross(e_j, d_n), F_n)[i]
    d_n = r_nodes - r_root[:, None]
    eye3 = torch.eye(3, **kw)

    def c_geom(blocks):
        F = blocks.stacked()[..., :3]                        # (R, N, 3)
        cj = tf.cross(eye3[None, None], d_n[:, :, None, :])  # (R, N, 3j, 3)
        contrib = tf.cross(cj, F[:, :, None, :])             # (R, N, 3j, 3i)
        Cg = -torch.sum(contrib, dim=1).transpose(-1, -2)
        Z3 = torch.zeros_like(Cg)
        return torch.cat([torch.cat([Z3, Z3], dim=-1),
                          torch.cat([Z3, Cg], dim=-1)], dim=-2)

    C_hydro = C_hydro + c_geom(Wh_b)
    C_struc = C_struc + c_geom(W_b)
    C_struc_sub = C_struc_sub + c_geom(Wsub_b)

    def sym(A):
        return 0.5 * (A + A.transpose(-1, -2))

    M_struc, M_struc_sub = sym(M_struc), sym(M_struc_sub)
    C_hydro, C_struc, C_struc_sub = sym(C_hydro), sym(C_struc), sym(C_struc_sub)

    # ---- totals
    m_all = M_struc[:, 0, 0]
    rCG = m_center_sum / m_all[:, None]
    rCG_sub = m_sub_sum / torch.where(m_sub > 0, m_sub, 1.0)[:, None]
    M_sub6 = tf.translate_matrix_6to6(M_struc_sub[:, :6, :6], -rCG_sub)
    M_all6 = tf.translate_matrix_6to6(M_struc[:, :6, :6], -rCG)
    Vs = torch.where(VTOT > 0, VTOT, 1.0)
    rCB = Sum_V_rCB / Vs[:, None]
    zMeta = torch.where(VTOT > 0, rCB[:, 2] + IWPx_TOT / Vs, 0.0)

    # ballast bookkeeping
    pb = []
    for mem in fs.members:
        if mem.part_of == "nacelle":
            continue
        for p in mem.pfill:
            if p != 0 and p not in pb:
                pb.append(p)
    m_ballast = [zero] * len(pb)
    for mem in fs.members:
        if mem.part_of == "nacelle":
            continue
        mfill = _rows(mem.mfill, R, kw)
        for j, p in enumerate(mem.pfill):
            if p != 0:
                m_ballast[pb.index(p)] = m_ballast[pb.index(p)] + mfill[:, j]

    return dict(
        M_struc=M_struc, M_struc_sub=M_struc_sub, C_struc=C_struc,
        C_struc_sub=C_struc_sub, C_hydro=C_hydro,
        C_elast=torch.zeros((R, nDOF, nDOF), **kw),
        W_struc=W_struc, W_hydro=W_hydro, f0_additional=f0_additional,
        rCG=rCG, rCG_sub=rCG_sub, rCB=rCB, m=m_all, m_sub=m_sub, V=VTOT,
        AWP=AWP_TOT, rM=torch.stack([rCB[:, 0], rCB[:, 1], zMeta], dim=-1),
        m_ballast=(torch.stack(m_ballast, dim=-1) if pb
                   else torch.zeros((R, 0), **kw)), pb=pb,
        mtower=mtower, rCG_tow=rCG_tow, M_all6=M_all6, M_sub6=M_sub6,
        r_nodes=r_nodes, R_ptfm=R_ptfm, Tn=Tn,
    )
