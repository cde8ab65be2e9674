"""Morison strip-theory hydrodynamics (batch-first torch counterpart of
``raft_tpu/physics/morison.py``).

Two kinds of function live here:

* build time (numpy, one design): :func:`build_strips` flattens every
  member's strips into one :class:`StripSet` and bakes the MacCamy-Fuchs
  Cm(k) factors (:func:`mcf_blend`, scipy's Hankel functions);
* evaluation (torch, every tensor with a leading row axis R, one design
  x sea state per row): hydro constants, excitation and the drag
  linearisation.  The strip -> node map is per-row data, so the
  reference's ``segment_sum`` over it becomes one ``index_add_`` over
  flattened ``row * N + node`` offsets on the CPU and a one-hot matrix
  product on the card (:mod:`raft_tpu_torch.ops.scatter`: the same bits
  on every run), and its gathers become index gathers with the same
  offsets.

A flexible (beam) member's strips sit on their own structural nodes and
rotate with their member's first node (``node_rot`` of
:func:`strip_frames`).  Above 12 reduced DOFs the drag linearisation
reduces its damping through the nodes each trip instead of folding it
per strip (:func:`drag_lin_precompute`), as the reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.ops import scatter
from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.utils import ad


@dataclass
class StripSet:
    """Flattened strip arrays: (S, ...) numpy leaves of one design from
    :func:`build_strips`, or (R, S, ...) tensors of a batch of rows.

    The bucket path reads only the fields up to ``Cd_End`` (its added
    mass and inertial excitation come from the packed zero-pose
    constants); the design path also reads the added-mass and
    MacCamy-Fuchs coefficients to recompute them per row."""

    node: object            # (S,) int — structural node of each strip
    ls: object              # (S,) axial position along the member
    dls: object             # (S,)
    ds: object              # (S, 2)
    drs: object             # (S, 2)
    circ: object            # (S,) bool
    active: object          # (S,) bool — False for potMod strips
    q0: object              # (S, 3) member axes at the reference pose
    p10: object
    p20: object
    Cd_q: object            # (S,)
    Cd_p1: object
    Cd_p2: object
    Cd_End: object
    Ca_q: object = None
    Ca_p1: object = None
    Ca_p2: object = None
    Ca_End: object = None
    Cm_p1_w: object = None  # (S, nw) complex — (1 + Ca_p1) or MCF-corrected
    Cm_p2_w: object = None
    mcf: object = None      # (S,) bool — MacCamy-Fuchs members
    mnode0: object = None   # (S,) the strip's member's first node

    @property
    def S(self):
        return self.ls.shape[-1]


@dataclass
class SiteRows:
    """The site scalars of a batch of rows, (R,) each, and the (padded)
    node count: what the strip physics reads of a FOWT."""

    rho_water: torch.Tensor
    depth: torch.Tensor
    g: torch.Tensor
    n_nodes: int


# ------------------------------------------------------------------ build

_MCF_TABLE = None
_MCF_KR_MAX = 80.0
_MCF_N = 1 << 15


def _mcf_table():
    """Cm(x) and its exact derivative on the table grid, for cubic-Hermite
    interpolation: dCm/dx = (4i/pi) (-2 x^-3 / H1' - x^-2 H1'' / H1'^2)
    with H1''(x) = H2(x)/x - H1(x)."""
    global _MCF_TABLE
    if _MCF_TABLE is None:
        from scipy.special import hankel1

        x = np.linspace(0.0, _MCF_KR_MAX, _MCF_N)
        with np.errstate(all="ignore"):
            H1 = hankel1(1, x)
            H2 = hankel1(2, x)
            Hp1 = 0.5 * (hankel1(0, x) - H2)
            Cm = 4j / (np.pi * x**2 * Hp1)
            dCm = (4j / np.pi) * (-2.0 / (x**3 * Hp1)
                                  - (H2 / x - H1) / (x**2 * Hp1**2))
        # analytic x -> 0 limits (Cm -> 2, dCm -> 0)
        Cm[0] = 2.0
        dCm[0] = 0.0
        _MCF_TABLE = (np.nan_to_num(Cm), np.nan_to_num(dCm))
    return _MCF_TABLE


def mcf_cm(kR):
    """MacCamy-Fuchs complex inertia coefficient Cm(kR) =
    4i/(pi (kR)^2 H1'(kR)) through the reference's cubic-Hermite table
    (clamped beyond kR = 80); numpy in, numpy out, or a real tensor in
    and a complex tensor out (differentiable in kR, as the geometry axis
    needs)."""
    Cm_t, dCm_t = _mcf_table()
    h = _MCF_KR_MAX / (_MCF_N - 1)
    if isinstance(kR, torch.Tensor):
        cdt = torch.complex128 if kR.dtype == torch.float64 \
            else torch.complex64
        Cm_t, dCm_t = (torch.as_tensor(a, dtype=cdt, device=kR.device)
                       for a in (Cm_t, dCm_t))
        xq = torch.clamp(kR, 0.0, _MCF_KR_MAX)
        i = torch.clamp((xq / h).to(torch.int64), 0, _MCF_N - 2)
    else:
        xq = np.clip(np.asarray(kR, dtype=float), 0.0, _MCF_KR_MAX)
        i = np.clip((xq / h).astype(int), 0, _MCF_N - 2)
    t = xq / h - i
    y0, y1 = Cm_t[i], Cm_t[i + 1]
    d0, d1 = dCm_t[i], dCm_t[i + 1]
    t2 = t * t
    t3 = t2 * t
    return ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + t) * (h * d0)
            + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * (h * d1))


def mcf_blend(kR, Cm0_p1, Cm0_p2):
    """Blend the MCF Cm(kR) with the baseline (1 + Ca) coefficients by
    the reference's long-wave ramp (k < pi/(5R), i.e. kR < pi/5); numpy
    or tensors, as :func:`mcf_cm`."""
    Cm = mcf_cm(kR)
    if isinstance(kR, torch.Tensor):
        ramp = torch.where(kR < np.pi / 5, 0.5 * (1 - torch.cos(5 * kR)),
                           1.0)
        ramp = torch.where(kR <= 0, 0.0, ramp)
    else:
        ramp = np.where(kR < np.pi / 5, 0.5 * (1 - np.cos(5 * kR)), 1.0)
        ramp = np.where(kR <= 0, 0.0, ramp)
    return Cm * ramp + Cm0_p1 * (1 - ramp), Cm * ramp + Cm0_p2 * (1 - ramp)


def build_strips(fs, k_array=None):
    """Flatten all members' strips of one FOWT (numpy); with ``k_array``
    (nw,) also bake the per-frequency Cm of MacCamy-Fuchs members."""
    cols = {f: [] for f in (
        "node mnode0 ls dls ds drs circ active mcf q0 p10 p20 "
        "Cd_q Cd_p1 Cd_p2 Cd_End Ca_q Ca_p1 Ca_p2 Ca_End".split()
    )}
    mcf_rows = []
    nw = len(k_array) if k_array is not None else 1
    for im, mem in enumerate(fs.members):
        ns = mem.ns
        if mem.mtype == "rigid":
            cols["node"] += [int(fs.member_node[im])] * ns
            cols["ls"] += list(mem.ls)  # axial offset from the member node
        else:
            # beam strips sit exactly at their own structural nodes
            cols["node"] += [int(fs.member_node[im]) + i for i in range(ns)]
            cols["ls"] += [0.0] * ns
        cols["mnode0"] += [int(fs.member_node[im])] * ns
        cols["dls"] += list(mem.dls)
        cols["ds"] += list(mem.ds)
        cols["drs"] += list(mem.drs)
        cols["circ"] += [mem.circular] * ns
        cols["active"] += [not mem.potMod] * ns
        cols["mcf"] += [bool(mem.MCF) and k_array is not None] * ns
        cols["q0"] += [mem.q0] * ns
        cols["p10"] += [mem.p10] * ns
        cols["p20"] += [mem.p20] * ns
        for cname in "Cd_q Cd_p1 Cd_p2 Cd_End Ca_q Ca_p1 Ca_p2 Ca_End".split():
            cols[cname] += list(getattr(mem, cname))
        for il in range(ns):
            Cm0_p1 = 1.0 + mem.Ca_p1[il]
            Cm0_p2 = 1.0 + mem.Ca_p2[il]
            if mem.MCF and k_array is not None:
                R = mem.ds[il, 0] / 2.0
                Cm_p1, Cm_p2 = mcf_blend(np.asarray(k_array) * R, Cm0_p1,
                                         Cm0_p2)
                mcf_rows.append((np.nan_to_num(Cm_p1), np.nan_to_num(Cm_p2)))
            else:
                mcf_rows.append((np.full(nw, Cm0_p1, dtype=np.complex128),
                                 np.full(nw, Cm0_p2, dtype=np.complex128)))

    out = {k2: np.asarray(v) for k2, v in cols.items()}
    out["Cm_p1_w"] = np.stack([r[0] for r in mcf_rows])
    out["Cm_p2_w"] = np.stack([r[1] for r in mcf_rows])
    return StripSet(**out)


# ------------------------------------------------------------- evaluation

def strips_to_rows(ss, device, rows=1):
    """A numpy :class:`StripSet` as tensors on ``device`` with a leading
    row axis of ``rows`` (a broadcast view, not a copy): ints stay int64,
    masks bool, reals float64, the Cm tables complex128."""
    def conv(a):
        a = np.asarray(a)
        t = torch.from_numpy(a.copy())
        if a.dtype.kind == "f":
            t = t.to(torch.float64)  # raft-lint: disable=dtype-literal (build precision; the policy casts later)
        elif a.dtype.kind == "c":
            t = t.to(torch.complex128)  # raft-lint: disable=dtype-literal (build precision; the policy casts later)
        elif a.dtype.kind in "iu":
            t = t.to(torch.int64)
        t = t.to(device)
        return t.expand((rows,) + t.shape)

    return StripSet(**{k: None if v is None else conv(v)
                       for k, v in vars(ss).items()})



def _row_offsets(node, n_nodes):
    """Flat ``row * n_nodes + node`` indices of a (R, S) node map."""
    R = node.shape[0]
    rows = torch.arange(R, device=node.device, dtype=torch.int64)
    return (rows[:, None] * n_nodes + node.to(torch.int64)).reshape(-1)


def gather_nodes(x, node):
    """``x[r, node[r, s]]`` for x (R, N, ...) and node (R, S) ->
    (R, S, ...)."""
    R, N = x.shape[:2]
    flat = x.reshape((R * N,) + x.shape[2:])
    return flat[_row_offsets(node, N)].reshape((R, node.shape[1])
                                               + x.shape[2:])


def strip_frames(ss, R_ptfm, r_nodes, node_rot=None):
    """Strip positions and member axes under the pose (r_strip = r_node
    + q * ls).  R_ptfm (R, 3, 3), r_nodes (R, N, 3) -> (r, q, p1, p2)
    each (R, S, 3).  A general structure passes its node rotations
    ``node_rot`` (R, N, 3) instead: each member then rotates with its
    first node (the reference's ``member.setPosition``,
    raft_member.py:348-357) and R_ptfm is not read."""
    if node_rot is not None:
        th = gather_nodes(node_rot, ss.mnode0)                # (R, S, 3)
        Rs = tf.rotation_matrix(th[..., 0], th[..., 1], th[..., 2])
        q = torch.einsum("rsij,rsj->rsi", Rs, ss.q0)
        p1 = torch.einsum("rsij,rsj->rsi", Rs, ss.p10)
        p2 = torch.einsum("rsij,rsj->rsi", Rs, ss.p20)
    else:
        Rt = R_ptfm.transpose(-1, -2)
        q = ss.q0 @ Rt
        p1 = ss.p10 @ Rt
        p2 = ss.p20 @ Rt
    r = gather_nodes(r_nodes, ss.node) + q * ss.ls[..., None]
    return r, q, p1, p2


def _abs_ref(x):
    """``|x|`` with the reference's derivative at 0: +1, as ``jnp.abs``
    differentiates (``select(x >= 0, 1, -1)``), where torch's is 0.  It
    matters where the argument is exactly 0 and its own derivative is
    not: a strip whose diameter does not change has end area 0, and
    its derivative in ``drs`` is pi ds.  The value is ``torch.abs``'s,
    bit for bit; the derivative is the reference's in reverse and in
    forward mode (a tangent takes the same path as a gradient)."""
    y = torch.abs(x)
    if not ad.differentiated(x):
        return y
    sx = torch.where(x >= 0, 1.0, -1.0) * x
    return y.detach() + (sx - sx.detach())


def _areas(ss):
    """Per-strip reference volumes and areas
    (v_side, v_end, a_end, a_q, a_p1, a_p2), each (R, S)."""
    ds, drs, dls, circ = ss.ds, ss.drs, ss.dls, ss.circ
    v_side = torch.where(circ, 0.25 * math.pi * ds[..., 0] ** 2 * dls,
                         ds[..., 0] * ds[..., 1] * dls)
    v_end_c = math.pi / 12.0 * _abs_ref(
        (ds[..., 0] + drs[..., 0]) ** 3 - (ds[..., 0] - drs[..., 0]) ** 3)
    dmean_p = torch.mean(ds + drs, dim=-1)
    dmean_m = torch.mean(ds - drs, dim=-1)
    v_end_r = math.pi / 12.0 * (dmean_p ** 3 - dmean_m ** 3)
    v_end = torch.where(circ, v_end_c, v_end_r)
    a_end = torch.where(
        circ, math.pi * ds[..., 0] * drs[..., 0],
        (ds[..., 0] + drs[..., 0]) * (ds[..., 1] + drs[..., 1])
        - (ds[..., 0] - drs[..., 0]) * (ds[..., 1] - drs[..., 1]))
    # the reference's ds[0]+ds[0] rectangular axial area, verbatim
    a_q = torch.where(circ, math.pi * ds[..., 0] * dls,
                      2 * (ds[..., 0] + ds[..., 0]) * dls)
    a_p1 = ds[..., 0] * dls
    a_p2 = torch.where(circ, ds[..., 0] * dls, ds[..., 1] * dls)
    return v_side, v_end, a_end, a_q, a_p1, a_p2


def _submerged_scale(ss, r, v_side):
    """Submergence mask and partial-emergence volume scaling of each
    strip: (sub (R, S) bool, v (R, S))."""
    dls = ss.dls
    z = r[..., 2]
    sub = z < 0
    dls_safe = torch.where(dls == 0, 1.0, dls)
    scale = torch.where(z + 0.5 * dls > 0, (0.5 * dls - z) / dls_safe, 1.0)
    return sub, v_side * scale


def _reduce_force(Tn, node, F6, n_nodes):
    """Sum per-strip 6-forces at their nodes and T-reduce:
    F6 (R, S, 6, nw) -> (R, n, nw)."""
    Fn = scatter.segment_sum_rows(F6, node, n_nodes)          # (R, N, 6, nw)
    return torch.einsum("rnia,rniw->raw", Tn.to(Fn.dtype), Fn)


def _reduce_matrix(Tn, node, M3, r_off, n_nodes):
    """Sum per-strip 3x3 matrices translated to their nodes and
    T-reduce: M3 (R, S, 3, 3), r_off (R, S, 3) -> (R, n, n)."""
    M6 = tf.translate_matrix_3to6(M3, r_off)                 # (R, S, 6, 6)
    Mn = scatter.segment_sum_rows(M6, node, n_nodes)
    return torch.einsum("rnia,rnij,rnjb->rab", Tn, Mn, Tn)


def hydro_constants(fs, ss, R_ptfm, r_nodes, Tn):
    """Added-mass matrix and per-strip inertial-excitation tensors at the
    pose (R_ptfm (R, 3, 3), r_nodes (R, N, 3), Tn (R, N, 6, n)): the
    reference's ``hydro_constants`` batched over rows, from the strips'
    added-mass and (complex, per-frequency) inertia coefficients.

    Returns dict with A_hydro (R, n, n), Amat (R, S, 3, 3), Imat
    (R, S, 3, 3, nw) complex, a_i (R, S), and the strip frames r, q, p1,
    p2, sub, active.
    """
    rho = fs.rho_water[:, None, None, None]
    r, q, p1, p2 = strip_frames(ss, R_ptfm, r_nodes)
    v_side, v_end, a_end, *_ = _areas(ss)
    sub, v_i = _submerged_scale(ss, r, v_side)
    active = sub & ss.active

    qq = tf.vec_vec_trans(q)
    p1p1 = tf.vec_vec_trans(p1)
    p2p2 = tf.vec_vec_trans(p2)

    Amat = (rho * v_i[..., None, None] * (
        ss.Ca_p1[..., None, None] * p1p1 + ss.Ca_p2[..., None, None] * p2p2)
        + rho * v_end[..., None, None] * ss.Ca_End[..., None, None] * qq)
    Amat = torch.where(active[..., None, None], Amat, 0.0)

    # inertial excitation with (possibly frequency-dependent) Cm
    Imat = (rho[..., None] * v_i[..., None, None, None] * (
        ss.Cm_p1_w[:, :, None, None, :] * p1p1[..., None]
        + ss.Cm_p2_w[:, :, None, None, :] * p2p2[..., None])
        + (rho[..., 0, 0] * v_end * ss.Ca_End)[..., None, None, None]
        * qq[..., None])
    Imat = torch.where(active[..., None, None, None], Imat, 0.0)

    a_i = torch.where(active, a_end, 0.0)
    r_off = r - gather_nodes(r_nodes, ss.node)
    A_hydro = _reduce_matrix(Tn, ss.node, Amat, r_off, Tn.shape[1])
    return dict(A_hydro=A_hydro, Amat=Amat, Imat=Imat, a_i=a_i,
                r=r, q=q, p1=p1, p2=p2, sub=sub, active=active)


def hydro_excitation(fs, ss, hc, zeta, beta, w, k, Tn, r_nodes):
    """Linear strip-theory wave excitation for one heading per row.

    F_strip = Imat @ ud + pDyn a_i q on submerged active strips,
    translated to the nodes and T-reduced.  zeta (R, nw) complex,
    beta (R,), k (R, nw).  Returns dict with F_hydro_iner (R, 6, nw)
    and the kinematics u, ud (R, S, 3, nw), pDyn (R, S, nw).
    """
    r, q = hc["r"], hc["q"]
    u, ud, pDyn = wv.wave_kinematics(zeta, beta, w, k, fs.depth, r,
                                     rho=fs.rho_water, g=fs.g)
    F3 = (torch.einsum("rsijw,rsjw->rsiw", hc["Imat"], ud)
          + pDyn[:, :, None, :] * (hc["a_i"][..., None] * q)[..., None])
    F3 = torch.where(hc["active"][:, :, None, None], F3, 0.0)
    r_off = r - gather_nodes(r_nodes, ss.node)
    mom = tf.cross(r_off[..., None].to(F3.dtype).expand(F3.shape), F3,
                   dim=2)
    F6 = torch.cat([F3, mom], dim=2)                        # (R, S, 6, nw)
    F_red = _reduce_force(Tn, ss.node, F6, fs.n_nodes)
    return dict(F_hydro_iner=F_red, u=u, ud=ud, pDyn=pDyn)


def drag_lin_precompute(fs, ss, hc, u_ih, Tn, r_nodes, w, dtype=None):
    """Everything Xi-independent of the drag linearisation, hoisted out
    of the fixed point (geometry, projections, the separable
    drag-force fold T6_d and, up to 12 reduced DOFs, the folded damping
    tensors G_d: (R, S, n, n) each, which the N-DOF models of flexible
    structures skip for the per-trip node reduction of
    :func:`drag_lin_iter`).  u_ih (R, S, 3, nw); dtype: (real, complex)
    policy."""
    rho = fs.rho_water
    r, q, p1, p2 = hc["r"], hc["q"], hc["p1"], hc["p2"]
    _, _, a_end, a_q, a_p1, a_p2 = _areas(ss)
    sub = hc["sub"]
    r_off = r - gather_nodes(r_nodes, ss.node)

    c = (math.sqrt(8.0 / math.pi) * 0.5 * rho)[:, None]
    pre = dict(
        q=q, p1=p1, p2=p2,
        qq=tf.vec_vec_trans(q), p1p1=tf.vec_vec_trans(p1),
        p2p2=tf.vec_vec_trans(p2),
        circ=ss.circ, sub=sub,
        cq=c * a_q * ss.Cd_q, cp1=c * a_p1 * ss.Cd_p1,
        cp2=c * a_p2 * ss.Cd_p2, cEnd=c * _abs_ref(a_end) * ss.Cd_End,
        Tn=Tn, node=ss.node, r_off=r_off, u=u_ih, iw=1j * w,
    )
    Tn_s = gather_nodes(Tn, ss.node)                         # (R, S, 6, n)

    def reduce_force_dir(axis):
        e6 = torch.cat([axis, tf.cross(r_off, axis)], dim=-1)
        T6 = torch.einsum("rsia,rsi->rsa", Tn_s, e6)         # (R, S, n)
        proj = torch.einsum("rsiw,rsi->rsw", u_ih, axis.to(u_ih.dtype))
        return torch.where(sub[..., None], T6, 0.0), proj

    pre["T6q"], pre["uq"] = reduce_force_dir(q)
    pre["T6p1"], pre["up1"] = reduce_force_dir(p1)
    pre["T6p2"], pre["up2"] = reduce_force_dir(p2)

    H = tf.skew(r_off)
    if Tn.shape[-1] > 12:
        pre["H"] = H
    else:
        Ht = H.transpose(-1, -2)

        def reduce_dir(P):
            MH = P @ H
            M6 = torch.cat([torch.cat([P, MH], dim=-1),
                            torch.cat([MH.transpose(-1, -2), H @ P @ Ht],
                                      dim=-1)], dim=-2)
            G = torch.einsum("rsia,rsij,rsjb->rsab", Tn_s, M6, Tn_s)
            return torch.where(sub[..., None, None], G, 0.0)

        pre["Gq"] = reduce_dir(pre["qq"])
        pre["Gp1"] = reduce_dir(pre["p1p1"])
        pre["Gp2"] = reduce_dir(pre["p2p2"])
    if dtype is not None:
        rdt, cdt = dtype
        pre = {k2: (v.to(cdt) if v.is_complex()
                    else v.to(rdt) if v.is_floating_point() else v)
               for k2, v in pre.items()}
    return pre


def drag_lin_iter(pre, Xi):
    """One drag-linearisation evaluation at the response Xi (R, n, nw):
    the reduced damping matrix B_hydro_drag (R, n, n), the per-strip
    Bmat (R, S, 3, 3) and the drag excitation F_hydro_drag (R, n, nw)."""
    q, p1, p2 = pre["q"], pre["p1"], pre["p2"]
    sub = pre["sub"]
    cdt = Xi.dtype

    # node motion at each strip: i w applied at node level, then one
    # gather and a lever-arm cross product
    Vn = pre["iw"] * torch.einsum("rnia,raw->rniw", pre["Tn"].to(cdt), Xi)
    Vs = gather_nodes(Vn, pre["node"])                       # (R, S, 6, nw)
    rr = pre["r_off"][..., None].to(cdt).expand(Vs[:, :, 3:].shape)
    vnode = Vs[:, :, :3] + tf.cross(Vs[:, :, 3:], rr, dim=2)

    vrel = pre["u"] - vnode
    vq_c = torch.einsum("rsiw,rsi->rsw", vrel, q.to(cdt))
    vp1_c = torch.einsum("rsiw,rsi->rsw", vrel, p1.to(cdt))
    vp2_c = torch.einsum("rsiw,rsi->rsw", vrel, p2.to(cdt))

    def a2(z):
        return z.real ** 2 + z.imag ** 2

    def rms(x):
        # circular strips take vRMS_p_tot: their per-axis sums, which may
        # be exactly 0, never reach the sqrt (a zero there would give
        # the masked branch a NaN derivative)
        s2 = torch.where(pre["circ"], 1.0, torch.sum(a2(x), dim=-1))
        return torch.sqrt(0.5 * s2)

    vq2 = torch.sum(a2(vq_c), dim=-1)                        # (R, S)
    vRMS_q = torch.sqrt(0.5 * vq2)
    tot2 = torch.sum(a2(vrel), dim=(-2, -1))
    vRMS_p_tot = torch.sqrt(0.5 * torch.clamp(tot2 - vq2, min=0.0))
    vRMS_p1 = torch.where(pre["circ"], vRMS_p_tot, rms(vp1_c))
    vRMS_p2 = torch.where(pre["circ"], vRMS_p_tot, rms(vp2_c))

    Bq = vRMS_q * pre["cq"]
    Bp1 = vRMS_p1 * pre["cp1"]
    Bp2 = vRMS_p2 * pre["cp2"]
    BEnd = vRMS_q * pre["cEnd"]

    Bmat = ((Bq + BEnd)[..., None, None] * pre["qq"]
            + Bp1[..., None, None] * pre["p1p1"]
            + Bp2[..., None, None] * pre["p2p2"])
    Bmat = torch.where(sub[..., None, None], Bmat, 0.0)

    cq_ = Bq + BEnd
    F_drag = (torch.einsum("rsa,rsw->raw", pre["T6q"].to(cdt),
                           cq_[..., None] * pre["uq"])
              + torch.einsum("rsa,rsw->raw", pre["T6p1"].to(cdt),
                             Bp1[..., None] * pre["up1"])
              + torch.einsum("rsa,rsw->raw", pre["T6p2"].to(cdt),
                             Bp2[..., None] * pre["up2"]))

    if "Gq" in pre:
        B_red = torch.sum(cq_[..., None, None] * pre["Gq"]
                          + Bp1[..., None, None] * pre["Gp1"]
                          + Bp2[..., None, None] * pre["Gp2"], dim=1)
        return dict(B_hydro_drag=B_red, Bmat=Bmat, F_hydro_drag=F_drag)

    # general (N-DOF) reduction: Bmat translated by the lever arms,
    # summed over each node's strips, then the T congruence
    H = pre["H"]
    MH = Bmat @ H
    M6 = torch.cat([torch.cat([Bmat, MH], dim=-1),
                    torch.cat([MH.transpose(-1, -2),
                               H @ Bmat @ H.transpose(-1, -2)], dim=-1)],
                   dim=-2)
    Tn = pre["Tn"]
    Mn = scatter.segment_sum_rows(M6, pre["node"], Tn.shape[1])  # (R, N, 6, 6)
    B_red = torch.einsum("rnia,rnij,rnjb->rab", Tn, Mn, Tn)
    return dict(B_hydro_drag=B_red, Bmat=Bmat, F_hydro_drag=F_drag)


def hydro_linearization(fs, ss, hc, u_ih, Xi, w, Tn, r_nodes):
    """The stochastic drag linearisation of one sea state in one call:
    :func:`drag_lin_precompute` then :func:`drag_lin_iter` (the fixed
    point calls the two stages itself, so that the precompute runs once
    per chunk).  u_ih (R, S, 3, nw): the wave velocity of the
    linearisation heading; Xi (R, n, nw): the response amplitudes in
    reduced DOFs.  Returns B_hydro_drag, Bmat and F_hydro_drag."""
    pre = drag_lin_precompute(fs, ss, hc, u_ih, Tn, r_nodes, w)
    return drag_lin_iter(pre, Xi)


def drag_excitation(fs, ss, hc, Bmat, u_ih, Tn, r_nodes):
    """F = Bmat @ u per strip and frequency, reduced to (R, 6, nw): the
    staged drag excitation the FUSED=off oracle uses."""
    F3 = torch.einsum("rsij,rsjw->rsiw", Bmat.to(u_ih.dtype), u_ih)
    F3 = torch.where(hc["sub"][:, :, None, None], F3, 0.0)
    r_off = hc["r"] - gather_nodes(r_nodes, ss.node)
    mom = tf.cross(r_off[..., None].to(F3.dtype).expand(F3.shape), F3,
                   dim=2)
    return _reduce_force(Tn, ss.node, torch.cat([F3, mom], dim=2),
                         fs.n_nodes)


# -------------------------------------------------------------- current

def current_loads(fs, ss, hc, speed, heading_deg, Zref, shear_exp, Tn,
                  r_nodes):
    """Mean current drag loads at the pose of ``hc``'s strip frames:
    a power-law current profile of exponent ``shear_exp`` (the FOWT's
    ``shearExp_water``) referenced to the depth ``Zref`` (0, or the hub
    depth of a submerged rotor), quadratic drag on the submerged
    strips in their axial and transverse directions, translated to the
    nodes and T-reduced.  speed, heading_deg (R,) -> (R, n)."""
    rho = fs.rho_water[:, None, None]
    r, q, p1, p2 = hc["r"], hc["q"], hc["p1"], hc["p2"]
    _, _, a_end, a_q, a_p1, a_p2 = _areas(ss)
    a_end_abs = _abs_ref(a_end)
    circ = ss.circ
    sub = hc["sub"]

    z = r[..., 2]
    depth = fs.depth[:, None]
    v = speed[:, None] * ((depth - torch.abs(z)) / (depth + Zref)) \
        ** shear_exp
    hd = (heading_deg * (math.pi / 180))[:, None]
    vcur = torch.stack([v * torch.cos(hd), v * torch.sin(hd),
                        torch.zeros_like(v)], dim=-1)        # (R, S, 3)

    vq_c = torch.sum(vcur * q, dim=-1)
    vp1_c = torch.sum(vcur * p1, dim=-1)
    vp2_c = torch.sum(vcur * p2, dim=-1)
    vrel_q = vq_c[..., None] * q
    vrel_p = vcur - vrel_q
    vrel_p1 = vp1_c[..., None] * p1
    vrel_p2 = vp2_c[..., None] * p2

    nq = torch.abs(vq_c)
    np_tot = torch.linalg.vector_norm(vrel_p, dim=-1)
    np1 = torch.where(circ, np_tot, torch.linalg.vector_norm(vrel_p1, dim=-1))
    np2 = torch.where(circ, np_tot, torch.linalg.vector_norm(vrel_p2, dim=-1))

    D = (
        0.5 * rho * (a_q * ss.Cd_q * nq)[..., None] * vrel_q
        + 0.5 * rho * (a_p1 * ss.Cd_p1 * np1)[..., None] * vrel_p1
        + 0.5 * rho * (a_p2 * ss.Cd_p2 * np2)[..., None] * vrel_p2
        + 0.5 * rho * (a_end_abs * ss.Cd_End * nq)[..., None] * vrel_q
    )
    D = torch.where(sub[..., None], D, 0.0)

    r_off = r - gather_nodes(r_nodes, ss.node)
    F6 = torch.cat([D, tf.cross(r_off, D)], dim=-1)          # (R, S, 6)
    Fn = scatter.segment_sum_rows(F6, ss.node, fs.n_nodes)
    return torch.einsum("rnia,rni->ra", Tn, Fn)
