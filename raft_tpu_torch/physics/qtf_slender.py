"""Slender-body difference-frequency QTFs (``potSecOrder: 1``; the torch
counterpart of ``raft_tpu/physics/qtf_slender.py``).

The quadratic transfer functions by the slender-body approximation:
per member the Pinkster (1979) and Rainey force components of every
submerged strip over the upper triangle of the (w1, w2) frequency
pairs, plus the Kim & Yue (1989/1990) analytic second-order diffraction
correction of surface-piercing vertical MacCamy-Fuchs cylinders; per
FOWT the Pinkster IV term (the rotation of the first-order inertial
forces) and the hermitian completion.

Layout on the card: :func:`member_qtf` computes each node's first-order
kinematics over the QTF grid once (nodes x frequencies) and the
second-order potential of every (pair, node) once, then evaluates the
rest of the pair terms for chunks of upper-triangle pairs at a time with
every node vectorised, so that ``pair_chunk`` bounds the (pairs, nodes,
3, 3) temporaries.  What a chunk computes is products and sums of those
precomputed factors, pair by pair, so the result does not depend on the
chunk size.  The reference evaluates the
same pair body under a ``vmap`` over all pairs.  The Kim & Yue series
depends only on the static geometry and the QTF grid: it stays host
numpy and scipy (:func:`kim_yue_correction`), its Hankel functions
taken once per frequency and the pairs vectorised.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.ops import waves2
from raft_tpu_torch.utils.dtypes import resolve_device

#: default number of frequency pairs :func:`member_qtf` evaluates at once
PAIR_CHUNK = 4096
#: the pair chunks' granule: a CPU's vector loops round a complex
#: product in a vector's scalar tail differently from its body (the tail
#: may fuse a multiply-add), so chunks are whole multiples of this many
#: pairs and the pair list is padded to one
PAIR_ALIGN = 8


def _mv(A, x):
    """A (..., 3, 3) times x (..., 3), written out per row."""
    return (A[..., 0] * x[..., 0:1] + A[..., 1] * x[..., 1:2]
            + A[..., 2] * x[..., 2:3])


def _dot3(a, b):
    """sum_i a[..., i] b[..., i] over the last axis of length 3."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def get_kinematics(r, Xi, w):
    """Displacement, velocity and acceleration amplitudes (..., 3, nw)
    at points r (..., 3) of a rigid body moving with Xi (..., 6, nw)."""
    th = Xi[..., 3:, :]
    rot = tf.cross(th, r[..., :, None].expand(th.shape), dim=-2)
    dr = Xi[..., :3, :] + rot
    v = 1j * w * dr
    a = 1j * w * v
    return dr, v, a


def _wave_kin(beta, w, k, depth, r, rho, g):
    """Wave velocity, acceleration and pressure per unit amplitude at
    points r (P, 3): (P, 3, nw), (P, 3, nw), (P, nw)."""
    kw = dict(dtype=w.dtype, device=w.device)
    one = torch.ones(1, **kw)
    u, ud, p = wv.wave_kinematics(
        torch.ones((1, len(w)), dtype=torch.complex128, device=w.device),
        beta * one, w, k[None], depth * one, r[None], rho * one, g * one)
    return u[0], ud[0], p[0]


def _member_static(mem):
    """Host arrays of one member's strips: node positions r (ns, 3),
    side and end volumes and the waterline crossing."""
    ds, drs, dls = mem.ds, mem.drs, mem.dls
    r = np.asarray(mem.rA0)[None, :] + np.asarray(mem.q0)[None, :] * mem.ls[:, None]
    if mem.circular:
        v_side = 0.25 * np.pi * ds[:, 0] ** 2 * dls
        v_end = np.pi / 12.0 * np.abs((ds[:, 0] + drs[:, 0]) ** 3
                                      - (ds[:, 0] - drs[:, 0]) ** 3)
    else:
        v_side = ds[:, 0] * ds[:, 1] * dls
        v_end = np.pi / 12.0 * (np.mean(ds + drs, axis=1) ** 3
                                - np.mean(ds - drs, axis=1) ** 3)
    scale = np.where(
        (r[:, 2] + 0.5 * dls > 0) & (dls > 0),
        (0.5 * dls - r[:, 2]) / np.where(dls == 0, 1, dls), 1.0)
    out = dict(r=r, v_side=v_side * scale, v_end=v_end,
               crosses=bool(r[-1, 2] * r[0, 2] < 0))
    if out["crosses"]:
        fr = (0.0 - r[0, 2]) / (r[-1, 2] - r[0, 2])
        out["r_int"] = r[0] + (r[-1] - r[0]) * fr
        i_wl = int(np.where(r[:, 2] < 0)[0][-1])
        ns = mem.ns
        if mem.circular:
            d_wl = (0.5 * (ds[i_wl, 0] + ds[i_wl + 1, 0]) if i_wl != ns - 1
                    else ds[i_wl, 0])
            out["a_wl_area"] = 0.25 * np.pi * d_wl**2
        else:
            if i_wl != ns - 1:
                d1 = 0.5 * (ds[i_wl, 0] + ds[i_wl + 1, 0])
                d2 = 0.5 * (ds[i_wl, 1] + ds[i_wl + 1, 1])
            else:
                d1, d2 = ds[i_wl, 0], ds[i_wl, 1]
            out["a_wl_area"] = d1 * d2
    return out


def member_qtf(mem, a_i_member, Xi, beta, w2nd, k2nd, depth, rho, g,
               pair_chunk=None):
    """Upper-triangle QTF contribution of one rigid member (6 DOFs about
    the PRP), the reference's ``member_qtf``.

    mem : :class:`~raft_tpu_torch.structure.members.MemberGeometry` at
    the reference pose; a_i_member (ns,) its strips' signed axial areas
    (the zero-pose hydro constants); Xi (6, nw2) complex tensor, the
    motion RAOs on the QTF grid, on the device the work runs on;
    beta [rad]; w2nd, k2nd (nw2,) numpy.  Pairs run ``pair_chunk``
    (default :data:`PAIR_CHUNK`, rounded up to a multiple of
    :data:`PAIR_ALIGN`) at a time; the result does not depend on it.
    Returns (nw2, nw2, 6) complex on Xi's device with the upper triangle
    filled."""
    dev, cdt = Xi.device, Xi.dtype
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    kw = dict(dtype=rdt, device=dev)
    nw2 = len(w2nd)
    i1, i2 = np.triu_indices(nw2)
    npairs = len(i1)
    if mem.rA0[2] > 0 and mem.rB0[2] > 0:
        return torch.zeros((nw2, nw2, 6), dtype=cdt, device=dev)
    # whole vectors of PAIR_ALIGN pairs: the pair list padded with the
    # first pair, every chunk a multiple of it
    pad = -npairs % PAIR_ALIGN
    i1p = np.concatenate([i1, np.full(pad, i1[0])])
    i2p = np.concatenate([i2, np.full(pad, i2[0])])

    st = _member_static(mem)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=float), **kw)  # noqa: E731
    w = t(w2nd)
    k = t(k2nd)
    q, p1, p2 = t(mem.q0), t(mem.p10), t(mem.p20)
    qc = q.to(cdt)
    qMat, p1Mat, p2Mat = (tf.vec_vec_trans(v) for v in (q, p1, p2))
    r = t(st["r"])
    sub = r[:, 2] < 0
    Ca_p1, Ca_p2, Ca_End = t(mem.Ca_p1), t(mem.Ca_p2), t(mem.Ca_End)
    v_side, v_end, a_i = t(st["v_side"]), t(st["v_end"]), t(a_i_member)
    CmMat = ((1.0 + Ca_p1)[:, None, None] * p1Mat
             + (1.0 + Ca_p2)[:, None, None] * p2Mat)
    CaMat = Ca_p1[:, None, None] * p1Mat + Ca_p2[:, None, None] * p2Mat

    # ---- per-node first-order kinematics over the QTF grid, laid out
    # frequency first so that a chunk gathers its pairs' rows
    ns = mem.ns
    dr_n, nodeV, _ = get_kinematics(r, Xi[None].expand(ns, 6, nw2), w)
    u_n, _, _ = _wave_kin(beta, w, k, depth, r, rho, g)      # (ns, 3, nw2)
    rr, ww, kk = r[None], w[:, None], k[:, None]             # (nw2, ns)
    grad_u = waves2.grad_u1(ww, kk, beta, depth, rr)        # (nw2, ns, 3, 3)
    grad_dudt = 1j * w[:, None, None, None] * grad_u
    grad_p1 = waves2.grad_pres1st(kk, beta, depth, rr, rho=rho, g=g)
    u_s = waves2.u_single(ww, kk, beta, depth, rr)           # (nw2, ns, 3)
    dwdz = waves2.dwdz(grad_u, qc)                           # (nw2, ns)
    drT, vT, uT = (x.permute(2, 0, 1) for x in (dr_n, nodeV, u_n))
    vrel_ax = waves2._dot(uT - vT, q)                        # (nw2, ns)

    # ---- the waterline
    if st["crosses"]:
        r_int = t(st["r_int"])
        _, ud_wl, eta = _wave_kin(beta, w, k, depth, r_int[None], 1.0, 1.0)
        ud_wl, eta = ud_wl[0], eta[0]
        dr_wl, _, a_wl = get_kinematics(r_int, Xi, w)
        eta_r = eta - dr_wl[2, :]
        a_wl_area = st["a_wl_area"]
        XiR = Xi[3:, :].T
        g_e1 = -g * (tf.cross(XiR, p1.to(cdt)[None].expand_as(XiR))[:, 2][None, :]
                     * p1[:, None]
                     + tf.cross(XiR, p2.to(cdt)[None].expand_as(XiR))[:, 2][None, :]
                     * p2[:, None])                           # (3, nw2)
        # the reference's waterline term reuses the last strip's
        # coefficients
        CmMat_wl = (1.0 + Ca_p1[-1]) * p1Mat + (1.0 + Ca_p2[-1]) * p2Mat
        CaMat_wl = Ca_p1[-1] * p1Mat + Ca_p2[-1] * p2Mat

    rv = rho * v_side[:, None]
    rve = (rho * v_end * Ca_End)[:, None]

    i1t = torch.as_tensor(i1p, device=dev)
    i2t = torch.as_tensor(i2p, device=dev)
    # the second-order potential of every pair in one call: its
    # transcendental functions must see the same batch whatever the
    # chunk size (a CPU's vector loop and its scalar tail round them
    # differently)
    pot = waves2.pot_2nd_ord(w[i1t][:, None], w[i2t][:, None],
                             k[i1t][:, None], k[i2t][:, None], beta, depth,
                             rr, g=g, rho=rho)       # (npairs, ns, 3), (npairs, ns)

    def chunk(a, b):
        j1, j2 = i1t[a:b], i2t[a:b]
        acc2, p2nd = pot[0][a:b], pot[1][a:b]
        f_2ndPot = rv * _mv(CmMat, acc2)

        gu1, gu2 = grad_u[j1], grad_u[j2]
        u1, u2 = uT[j1], uT[j2]
        conv = 0.25 * (_mv(gu1, torch.conj(u2)) + _mv(torch.conj(gu2), u1))
        f_conv = rv * _mv(CmMat, conv)

        axdv = waves2.axdiv_acc_from(dwdz[j1], u_s[j1], dwdz[j2], u_s[j2],
                                     vT[j1], vT[j2], qc)
        f_axdv = rv * _mv(CaMat, axdv)

        d1, d2 = drT[j1], drT[j2]
        acc_nabla = 0.25 * (_mv(grad_dudt[j1], torch.conj(d2))
                            + _mv(torch.conj(grad_dudt[j2]), d1))
        f_nabla = rv * _mv(CmMat, acc_nabla)

        # Rainey's body-rotation terms
        OM1 = -tf.skew(1j * w[j1][:, None] * Xi[3:, j1].T)[:, None]
        OM2 = -tf.skew(1j * w[j2][:, None] * Xi[3:, j2].T)[:, None]
        va1, va2 = vrel_ax[j1], vrel_ax[j2]
        f_rslb = -0.25 * 2 * _mv(
            CaMat,
            _mv(OM1, qc) * torch.conj(va2)[..., None]
            + _mv(torch.conj(OM2), qc) * va1[..., None])
        f_rslb = rv * f_rslb

        u1a = u1 - vT[j1]
        u2a = u2 - vT[j2]
        V1 = gu1 + OM1
        V2 = gu2 + OM2
        aux = 0.25 * (_mv(V1, torch.conj(_mv(CaMat, u2a)))
                      + _mv(torch.conj(V2), _mv(CaMat, u1a)))
        aux = aux - _mv(qMat, aux)
        f_rslb = f_rslb + rv * aux

        u1p = u1a - _mv(qMat, u1a)
        u2p = u2a - _mv(qMat, u2a)
        aux = 0.25 * (_mv(CaMat, _mv(V1, torch.conj(u2p)))
                      + _mv(CaMat, _mv(torch.conj(V2), u1p)))
        f_rslb = f_rslb - rv * aux

        # ---- axial and end effects
        f_2ndPot = f_2ndPot + a_i[:, None] * p2nd[..., None] * q
        f_2ndPot = f_2ndPot + rve * _mv(qMat, acc2)
        f_conv = f_conv + rve * _mv(qMat, conv)
        f_nabla = f_nabla + rve * _mv(qMat, acc_nabla)
        gp1, gp2 = grad_p1[j1], grad_p1[j2]
        p_nabla = 0.25 * (_dot3(gp1, torch.conj(d2))
                          + _dot3(torch.conj(gp2), d1))
        f_nabla = f_nabla + (a_i * p_nabla)[..., None] * q
        p_drop = -2 * 0.25 * 0.5 * rho * _dot3(
            _mv(p1Mat + p2Mat, u1a), torch.conj(_mv(CaMat, u2a)))
        f_conv = f_conv + (a_i * p_drop)[..., None] * q

        u1c = _mv(CaMat, u1p)
        u2c = _mv(CaMat, u2p)
        f_transv = 0.25 * a_i[:, None] * rho * (
            torch.conj(u1c) * va2[..., None] + u2c * torch.conj(va1)[..., None])
        f_conv = f_conv + f_transv

        # strips -> 6 DOFs about the PRP, submerged nodes only, summed
        # node by node in order (a library reduction picks its order by
        # the tensor's shape, so by the chunk size)
        f3 = torch.where(sub[:, None], torch.stack(
            [f_2ndPot, f_conv, f_axdv, f_nabla, f_rslb]), 0.0)
        f6 = torch.cat([f3, tf.cross(rr.expand_as(f3), f3)], dim=-1)
        S = f6[:, :, 0]
        for i in range(1, ns):
            S = S + f6[:, :, i]
        F = S[0] + S[1] + S[2] + S[3] + S[4]

        # ---- the relative wave elevation at the waterline
        if st["crosses"]:
            e1, e2 = eta_r[j1][:, None], eta_r[j2][:, None]
            f_eta = 0.25 * (ud_wl[:, j1].T * torch.conj(e2)
                            + torch.conj(ud_wl[:, j2].T) * e1)
            f_eta = rho * a_wl_area * _mv(CmMat_wl, f_eta)
            a_eta = 0.25 * (a_wl[:, j1].T * torch.conj(e2)
                            + torch.conj(a_wl[:, j2].T) * e1)
            f_eta = f_eta - rho * a_wl_area * _mv(CaMat_wl, a_eta)
            f_eta = f_eta - 0.25 * rho * a_wl_area * (
                g_e1[:, j1].T * torch.conj(e2)
                + torch.conj(g_e1[:, j2].T) * e1)
            F = F + torch.cat([f_eta, tf.cross(r_int.expand_as(f_eta),
                                               f_eta)], dim=-1)
        return F

    n = -(-int(pair_chunk or PAIR_CHUNK) // PAIR_ALIGN) * PAIR_ALIGN
    F = torch.cat([chunk(a, a + n) for a in range(0, len(i1p), n)])[:npairs]
    out = torch.zeros((nw2, nw2, 6), dtype=cdt, device=dev)
    out[i1t[:npairs], i2t[:npairs]] = F
    return out


def kim_yue_correction(mem, beta, w2nd, k2nd, depth, rho, g, Nm=10):
    """Kim & Yue's second-order diffraction correction of a
    surface-piercing MacCamy-Fuchs member (host numpy and scipy; static:
    geometry and grid only), the reference's ``kim_yue_correction``
    with its pair loop vectorised.  Returns (nw2, nw2, 6) complex numpy
    with the upper triangle filled (zero unless ``mem.MCF`` and the
    member pierces the surface)."""
    from scipy.special import hankel1

    nw2 = len(w2nd)
    out = np.zeros((nw2, nw2, 6), dtype=np.complex128)
    if not mem.MCF:
        return out
    if not (mem.rA0[2] * mem.rB0[2] < 0):
        return out

    w2nd = np.asarray(w2nd, dtype=float)
    k2nd = np.asarray(k2nd, dtype=float)
    r = mem.rA0[None, :] + mem.q0[None, :] * mem.ls[:, None]
    radii = 0.5 * mem.ds[:, 0]
    R_wl = np.interp(0.0, r[:, 2], radii)
    rwl = mem.rA0 + (mem.rB0 - mem.rA0) * (0 - mem.rA0[2]) / (mem.rB0[2] - mem.rA0[2])

    cosB, sinB = np.cos(beta), np.sin(beta)
    beta_vec = np.array([cosB, sinB, 0.0])
    pforce = (np.dot(beta_vec, mem.p10) * mem.p10
              + np.dot(beta_vec, mem.p20) * mem.p20)
    pforce = pforce / np.linalg.norm(pforce)

    i1, i2 = np.triu_indices(nw2)
    w1_, w2_ = w2nd[i1], w2nd[i2]
    k1_, k2_ = k2nd[i1], k2nd[i2]

    def omega_n(R, n):
        """The series term of order n per pair, its Hankel functions
        taken once per frequency of the grid."""
        kR = k2nd * R
        h = {m: hankel1(m, kR) for m in (n - 1, n, n + 1, n + 2)}
        H_N = 0.5 * (h[n - 1] - h[n + 1])
        H_Nc = 0.5 * np.conj(h[n - 1] - h[n + 1])
        H_Nm1 = 0.5 * (h[n] - h[n + 2])
        H_Nm1c = 0.5 * np.conj(h[n] - h[n + 2])
        return 1 / (H_Nm1[i1] * H_Nc[i2]) - 1 / (H_N[i1] * H_Nm1c[i2])

    def to6(F3, at):
        """(npairs, 3) forces at point ``at`` -> (npairs, 6)."""
        return np.concatenate([F3, _cross(at, F3)], axis=-1)

    kx = k1_ * cosB - k2_ * cosB
    ky = k1_ * sinB - k2_ * sinB
    shift = np.exp(-1j * (kx * rwl[0] + ky * rwl[1] + 0.0 * rwl[2]))
    F = np.zeros((len(i1), 6), dtype=np.complex128)

    # the waterline term
    k1R, k2R = k1_ * R_wl, k2_ * R_wl
    Fwl = np.zeros(len(i1), dtype=np.complex128)
    for nn in range(Nm + 1):
        Fwl += -rho * g * R_wl * 2j / np.pi / (k1R * k2R) * omega_n(R_wl, nn)
    Fwl = np.real(Fwl) * shift
    F += to6(Fwl[:, None] * pforce, rwl)

    # the quadratic-velocity term, integrated analytically per node zone
    same = w1_ == w2_
    for il in range(mem.ns - 1):
        z1 = r[il, 2]
        if z1 > 0:
            continue
        z2 = min(r[il + 1, 2], 0.0)
        R1 = mem.ds[il, 0] / 2
        if mem.dls[il] == 0:
            R1 = mem.ds[il, 0]
        R2 = mem.ds[il + 1, 0] / 2
        if mem.dls[il + 1] == 0:
            R2 = mem.ds[il, 0]  # the reference's quirk, kept
        R = 0.5 * (R1 + R2)
        k1R, k2R = k1_ * R, k2_ * R
        H = depth / R
        k1h, k2h = k1R * H, k2R * H
        with np.errstate(divide="ignore", invalid="ignore"):
            Im_eq = 0.5 * (np.sinh((k1_ + k2_) * (z2 + depth)) / (k1h + k2h) - (z2 + depth) / depth
                           - np.sinh((k1_ + k2_) * (z1 + depth)) / (k1h + k2h) + (z1 + depth) / depth)
            Ip_eq = 0.5 * (np.sinh((k1_ + k2_) * (z2 + depth)) / (k1h + k2h) + (z2 + depth) / depth
                           - np.sinh((k1_ + k2_) * (z1 + depth)) / (k1h + k2h) - (z1 + depth) / depth)
            Im_ne = 0.5 * (np.sinh((k1_ + k2_) * (z2 + depth)) / (k1h + k2h)
                           - np.sinh((k1_ - k2_) * (z2 + depth)) / (k1h - k2h)
                           - np.sinh((k1_ + k2_) * (z1 + depth)) / (k1h + k2h)
                           + np.sinh((k1_ - k2_) * (z1 + depth)) / (k1h - k2h))
            Ip_ne = 0.5 * (np.sinh((k1_ + k2_) * (z2 + depth)) / (k1h + k2h)
                           + np.sinh((k1_ - k2_) * (z2 + depth)) / (k1h - k2h)
                           - np.sinh((k1_ + k2_) * (z1 + depth)) / (k1h + k2h)
                           - np.sinh((k1_ - k2_) * (z1 + depth)) / (k1h - k2h))
        Im = np.where(same, Im_eq, Im_ne)
        Ip = np.where(same, Ip_eq, Ip_ne)
        coshk1h, coshk2h = np.cosh(k1h), np.cosh(k2h)
        dF = np.zeros(len(i1), dtype=np.complex128)
        for nn in range(Nm + 1):
            dF += rho * g * R * 2j / np.pi / (k1R * k2R) * omega_n(R, nn) * (
                k1h * k2h / np.sqrt(k1h * np.tanh(k1h)) / np.sqrt(k2h * np.tanh(k2h))
                * (Im + Ip * nn * (nn + 1) / k1R / k2R) / coshk1h / coshk2h)
        rmid = 0.5 * (r[il] + r[il + 1])
        dF = np.real(dF) * shift
        F += to6(dF[:, None] * pforce, rmid)

    F = np.where((k1_ < k2_)[:, None], np.conj(F), F)
    out[i1, i2, :] = F
    return out


def _cross(a, b):
    """a (3,) x b (..., 3), component-wise."""
    return np.stack([a[1] * b[..., 2] - a[2] * b[..., 1],
                     a[2] * b[..., 0] - a[0] * b[..., 2],
                     a[0] * b[..., 1] - a[1] * b[..., 0]], axis=-1)


def pinkster_iv(Xi, F1st, block=512):
    """Pinkster's term IV, the rotation of the first-order inertial
    forces, for all upper-triangle (w1, w2) pairs, blocked over w1 to
    bound the (block, nw2, 3) temporaries.

    Xi, F1st (nDOF, nw2) complex tensors: the motion RAOs and the
    first-order inertial forces on the QTF grid.  Returns (nw2, nw2, 6)
    complex with the upper triangle filled (the callers complete the
    lower one)."""
    nw2 = Xi.shape[1]
    Xr = Xi[3:6].T
    Fl = F1st[:3].T
    Fr_ = F1st[3:6].T
    Xrc, Flc, Frc = torch.conj(Xr), torch.conj(Fl), torch.conj(Fr_)
    out = torch.zeros((nw2, nw2, 6), dtype=Xi.dtype, device=Xi.device)
    j = torch.arange(nw2, device=Xi.device)
    for s in range(0, nw2, block):
        e = min(s + block, nw2)
        mask = (j[s:e, None] <= j[None, :])[..., None]
        m = 0.25 * mask.to(Xr.real.dtype)
        a, ac = Xr[s:e, None, :], Xrc[None, :, :]
        out[s:e, :, 0:3] = m * (tf.cross(a.expand(-1, nw2, -1),
                                         Flc[None].expand(e - s, -1, -1))
                                + tf.cross(ac.expand(e - s, -1, -1),
                                           Fl[s:e, None].expand(-1, nw2, -1)))
        out[s:e, :, 3:6] = m * (tf.cross(a.expand(-1, nw2, -1),
                                         Frc[None].expand(e - s, -1, -1))
                                + tf.cross(ac.expand(e - s, -1, -1),
                                           Fr_[s:e, None].expand(-1, nw2, -1)))
    return out


def fowt_qtf_slender(model, beta, Xi0=None, ifowt=0, device=None,
                     timer=None):
    """The slender-body QTF of one FOWT (the reference's
    ``fowt_qtf_slender``): (nw2, nw2, 1, nDOF) complex128 tensor on
    ``device`` (default: the current CUDA device; raises without one),
    hermitian, on the grid ``model.w1_2nd``.

    beta [rad] the wave heading; Xi0 (nDOF, nw) the motion RAOs on the
    model grid (None: a fixed body), interpolated linearly onto the QTF
    grid (zero outside it).  The Pinkster IV term with the structural
    mass, each member's :func:`member_qtf` (its strips' slice of the
    zero-pose axial areas) and :func:`kim_yue_correction`, then the
    hermitian completion.  ``timer(stage)``, when given, is called with
    "start", then "kim_yue" (every member's correction, on the host),
    "pinkster_iv" and "member_qtf" (every member's pair terms, added in
    the reference's order)."""
    dev = resolve_device(device)
    mark = timer or (lambda stage: None)
    fs = model.fowtList[ifowt]
    fh = model.hydro[ifowt]
    stat = model.statics(ifowt)
    w2nd, k2nd = model.w1_2nd, model.k1_2nd
    if w2nd is None:
        raise ValueError("the design sets no second-order frequency grid "
                         "(platform min_freq2nd and max_freq2nd)")
    nw2 = len(w2nd)
    nDOF = fs.nDOF
    if Xi0 is None:
        Xi0 = np.zeros((nDOF, model.nw), dtype=np.complex128)
    Xi0 = np.asarray(Xi0)
    Xi = np.zeros((nDOF, nw2), dtype=np.complex128)
    for i in range(nDOF):
        Xi[i] = np.interp(w2nd, model.w, Xi0[i], left=0, right=0)

    mark("start")
    kys = [kim_yue_correction(mem, beta, w2nd, k2nd, fs.depth, fs.rho_water,
                              fs.g) for mem in fs.members]
    mark("kim_yue")
    Xi_t = torch.as_tensor(Xi, device=dev)
    M = torch.as_tensor(np.asarray(stat["M_struc"], dtype=float), device=dev)
    w2_t = torch.as_tensor(np.asarray(w2nd, dtype=float), device=dev)
    F1st = (M.to(Xi_t.dtype) @ (-(w2_t ** 2) * Xi_t))
    qtf = torch.zeros((nw2, nw2, nDOF), dtype=Xi_t.dtype, device=dev)
    qtf[:, :, :6] = pinkster_iv(Xi_t, F1st)
    mark("pinkster_iv")

    # each member's terms, then its Kim & Yue correction
    a_i_all = np.asarray(fh.hc0["a_i"])
    ofs = 0
    for mem, ky in zip(fs.members, kys):
        a_i_m = a_i_all[ofs:ofs + mem.ns]
        ofs += mem.ns
        qtf = qtf + member_qtf(mem, a_i_m, Xi_t, beta, w2nd, k2nd, fs.depth,
                               fs.rho_water, fs.g)
        qtf = qtf + torch.as_tensor(ky, device=dev)
    mark("member_qtf")

    # hermitian completion
    qc = torch.conj(qtf)
    eye = torch.eye(nw2, dtype=torch.bool, device=dev)[..., None]
    qtf = qtf + qc.transpose(0, 1) - torch.where(eye, qc, 0.0)
    return qtf[:, :, None, :]
