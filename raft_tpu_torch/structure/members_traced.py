"""Member inertia elements as functions of the geometry design variables,
batched over rows (counterpart of ``raft_tpu/structure/members_traced.py``).

The build-time path (:mod:`raft_tpu_torch.structure.members`) reduces
each member's shell, ballast and cap geometry to per-element inertia
constants with numpy, once per design.  The geometry design axis (member
diameters and thicknesses, ballast fills and densities, mooring
properties: the WEIS design variables of ``omdao_raft`` /
``parametersweep``) needs those constants per row, as differentiable
tensors, so one evaluator serves a whole geometry DoE:

* the *shapes* (stations, strips, elements, which cap branch applies)
  depend only on the station layout and are fixed per design;
* the *values* are torch tensors with a leading row axis R: station
  diameters ``d`` (R, n, 2), thicknesses ``t`` (R, n), fill lengths and
  densities (R, n - 1);
* the reference's equal-endpoint special cases of the frustum and box
  moments of inertia are limits of the general polynomial forms, so one
  branch-free expression covers both (the ``(r2^5 - r1^5)/(r2 - r1)``
  ratio is expanded to its polynomial and stays finite at equality).

:func:`apply_geometry` applies a row batch of design scales to a FOWT:
per-row member constants for :func:`raft_tpu_torch.physics.statics.
calc_statics` and scaled strips for the hydro constants.  Rigid members
only, as in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from raft_tpu_torch.physics import morison


# --------------------------------------------------------- geometry bits

def _sdiv(a, b):
    """a / b, 0 where b == 0 (the division never sees the zero)."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def vcv_circ(dA, dB, H):
    """Circular frustum volume and axial centroid from the dA end."""
    A1 = math.pi / 4 * dA ** 2
    A2 = math.pi / 4 * dB ** 2
    Am = math.pi / 4 * dA * dB
    s = A1 + Am + A2
    return s * H / 3.0, _sdiv(A1 + 2 * Am + 3 * A2, s) * H / 4.0


def vcv_rect(slA, slB, H):
    """Rectangular frustum volume and axial centroid; slA, slB (..., 2)
    side-length pairs."""
    A1 = slA[..., 0] * slA[..., 1]
    A2 = slB[..., 0] * slB[..., 1]
    Am = torch.sqrt(torch.clamp(A1 * A2, min=0.0))
    s = A1 + Am + A2
    return s * H / 3.0, _sdiv(A1 + 2 * Am + 3 * A2, s) * H / 4.0


def moi_circ(dA, dB, H, rho):
    """Circular frustum radial and axial moments of inertia about end A,
    one polynomial for tapered and straight sections."""
    r1 = dA / 2.0
    r2 = dB / 2.0
    # (r2^5 - r1^5)/(r2 - r1) = sum_{j=0..4} r2^j r1^(4-j)
    p4 = (r2 ** 4 + r2 ** 3 * r1 + r2 ** 2 * r1 ** 2 + r2 * r1 ** 3
          + r1 ** 4)
    I_rad = (1 / 20) * rho * math.pi * H * p4 + (1 / 30) * rho * math.pi \
        * H ** 3 * (r1 ** 2 + 3 * r1 * r2 + 6 * r2 ** 2)
    I_ax = (1 / 10) * rho * math.pi * H * p4
    zero = torch.as_tensor(H, device=I_ax.device) == 0
    return torch.where(zero, 0.0, I_rad), torch.where(zero, 0.0, I_ax)


def moi_rect(La, Wa, Lb, Wb, H, rho):
    """Box frustum moments of inertia about end A: the general polynomial
    form, of which the reference's equal-side branches are exact
    specialisations."""
    x2 = (1 / 12) * rho * (
        (Lb - La) ** 3 * H * (Wb / 5 + Wa / 20)
        + (Lb - La) ** 2 * La * H * (3 * Wb / 4 + Wa / 4)
        + (Lb - La) * La ** 2 * H * (Wb + Wa / 2)
        + La ** 3 * H * (Wb / 2 + Wa / 2))
    y2 = (1 / 12) * rho * (
        (Wb - Wa) ** 3 * H * (Lb / 5 + La / 20)
        + (Wb - Wa) ** 2 * Wa * H * (3 * Lb / 4 + La / 4)
        + (Wb - Wa) * Wa ** 2 * H * (Lb + La / 2)
        + Wa ** 3 * H * (Lb / 2 + La / 2))
    z2 = rho * (Wb * Lb / 5 + Wa * Lb / 20 + La * Wb / 20
                + Wa * La / 30) * H ** 3
    zero = torch.as_tensor(H, device=z2.device) == 0
    return (torch.where(zero, 0.0, y2 + z2), torch.where(zero, 0.0, x2 + z2),
            torch.where(zero, 0.0, x2 + y2))


def _interp1(x, xs, v):
    """Linear interpolation of ``v`` (..., n) over fixed abscissae ``xs``
    (n,) at a fixed query ``x``: the index and weight are Python
    numbers."""
    xs = np.asarray(xs, dtype=float)
    x = float(x)
    if x <= xs[0]:
        return v[..., 0]
    if x >= xs[-1]:
        return v[..., -1]
    i = int(np.searchsorted(xs, x, side="right") - 1)
    f = (x - xs[i]) / (xs[i + 1] - xs[i])
    return v[..., i] * (1 - f) + v[..., i + 1] * f


def traced_cap_elements(g, d, t):
    """Cap and bulkhead elements of member ``g`` at station diameters
    ``d`` (R, n, 2) and thicknesses ``t`` (R, n): a list of (mass, axial
    CG offset, Ixx, Iyy, Izz), each (R,).  Which branch a cap takes is
    fixed by the station and cap layout."""
    out = []
    cap_L = g.cap_L
    if cap_L is None or len(cap_L) == 0:
        return out
    st = g.stations
    rho_cap = g.rho_shell
    for ic in range(len(cap_L)):
        L = cap_L[ic]
        h = g.cap_t_arr[ic]
        if g.circular:
            d_hole = float(g.cap_d_in_arr[ic])
            d_in = d[..., 0] - 2 * t
            if L == st[0]:
                dA = d_in[..., 0]
                dB = _interp1(L + h, st, d_in)
                dAi = torch.full_like(dA, d_hole)
                dBi = dB * _sdiv(dAi, dA)
            elif L == st[-1]:
                dA = _interp1(L - h, st, d_in)
                dB = d_in[..., -1]
                dBi = torch.full_like(dB, d_hole)
                dAi = dA * _sdiv(dBi, dB)
            elif ic < len(cap_L) - 1 and L == cap_L[ic + 1]:
                dA = _interp1(L - h, st, d_in)
                dB = d_in[..., ic]
                dBi = torch.full_like(dB, d_hole)
                dAi = dA * _sdiv(dBi, dB)
            elif ic > 0 and L == cap_L[ic - 1]:
                dA = d_in[..., ic]
                dB = _interp1(L + h, st, d_in)
                dAi = torch.full_like(dA, d_hole)
                dBi = dB * _sdiv(dAi, dA)
            else:
                dA = _interp1(L - h / 2, st, d_in)
                dB = _interp1(L + h / 2, st, d_in)
                dM = _interp1(L, st, d_in)
                dMi = torch.full_like(dM, d_hole)
                dAi = dA * _sdiv(dMi, dM)
                dBi = dB * _sdiv(dMi, dM)
            V_o, hco = vcv_circ(dA, dB, h)
            V_i, hci = vcv_circ(dAi, dBi, h)
            m_cap = (V_o - V_i) * rho_cap
            hc_cap = _sdiv(hco * V_o - hci * V_i, V_o - V_i)
            Ir_o, Ia_o = moi_circ(dA, dB, h, rho_cap)
            Ir_i, Ia_i = moi_circ(dAi, dBi, h, rho_cap)
            I_rad = (Ir_o - Ir_i) - m_cap * hc_cap ** 2
            Ixx = Iyy = I_rad
            Izz = Ia_o - Ia_i
        else:
            sl_in = d - 2 * t[..., None]
            hole = torch.as_tensor(np.asarray(g.cap_d_in_arr[ic], dtype=float),
                                   dtype=d.dtype, device=d.device)

            def interp2(x):
                return torch.stack([_interp1(x, st, sl_in[..., 0]),
                                    _interp1(x, st, sl_in[..., 1])], dim=-1)

            if L == st[0]:
                slA = sl_in[..., 0, :]
                slB = interp2(L + h)
                slAi = hole.expand(slA.shape)
                slBi = slB * (slAi / slA)
            elif L == st[-1]:
                slB = sl_in[..., -1, :]
                slA = interp2(L - h)
                slBi = hole.expand(slB.shape)
                slAi = slA * (slBi / slB)
            elif ic < len(cap_L) - 1 and L == cap_L[ic + 1]:
                slA = interp2(L - h)
                slB = sl_in[..., ic, :]
                slBi = hole.expand(slB.shape)
                slAi = slA * (slBi / slB)
            elif ic > 0 and L == cap_L[ic - 1]:
                slA = sl_in[..., ic, :]
                slB = interp2(L + h)
                slAi = hole.expand(slA.shape)
                slBi = slB * (slAi / slA)
            else:
                slA = interp2(L - h / 2)
                slB = interp2(L + h / 2)
                slM = interp2(L)
                slAi = slA * (hole / slM)
                slBi = slB * (hole / slM)
            V_o, hco = vcv_rect(slA, slB, h)
            V_i, hci = vcv_rect(slAi, slBi, h)
            m_cap = (V_o - V_i) * rho_cap
            hc_cap = _sdiv(hco * V_o - hci * V_i, V_o - V_i)
            Ix_o, Iy_o, Iz_o = moi_rect(slA[..., 0], slA[..., 1], slB[..., 0],
                                        slB[..., 1], h, rho_cap)
            Ix_i, Iy_i, Iz_i = moi_rect(slAi[..., 0], slAi[..., 1],
                                        slBi[..., 0], slBi[..., 1], h,
                                        rho_cap)
            Ixx = (Ix_o - Ix_i) - m_cap * hc_cap ** 2
            Iyy = (Iy_o - Iy_i) - m_cap * hc_cap ** 2
            Izz = Iz_o - Iz_i

        if L == st[0]:
            s_cg = L + hc_cap
        elif L == st[-1]:
            s_cg = L - (h - hc_cap)
        else:
            s_cg = L - (h / 2 - hc_cap)
        out.append((m_cap, s_cg, Ixx, Iyy, Izz))
    return out


def traced_inertia_elements(g, d, t, l_fill, rho_fill):
    """Inertia elements of rigid member ``g`` at per-row geometry, with
    exactly the build-time element layout (sections, including the
    reference's zero-length-section quirk, then caps).

    d : (R, n, 2) outer diameters / side pairs at the stations;
    t : (R, n) shell thicknesses; l_fill, rho_fill : (R, n - 1).

    Returns (elem_mass, elem_s, elem_Ixx, elem_Iyy, elem_Izz), each
    (R, ne), and (mshell (R,), mfill (R, n - 1)).  All sections in one
    pass over the section axis; the zero-length quirk (the previous real
    section's inertia re-added with zero mass) is a fixed index map.
    """
    st = np.asarray(g.stations, dtype=float)
    n = len(st)
    lsec_np = np.diff(st)
    pos = lsec_np > 0
    kw = dict(dtype=d.dtype, device=d.device)
    lsec = torch.as_tensor(np.where(pos, lsec_np, 1.0), **kw)
    posf = torch.as_tensor(pos.astype(float), **kw)
    lf, rf = l_fill, rho_fill

    if g.circular:
        dA, dB = d[..., :-1, 0], d[..., 1:, 0]
        dAi = dA - 2 * t[..., :-1]
        dBi = dB - 2 * t[..., 1:]
        V_o, hco = vcv_circ(dA, dB, lsec)
        V_i, hci = vcv_circ(dAi, dBi, lsec)
        m_shell = (V_o - V_i) * g.rho_shell * posf
        hc_shell = _sdiv(hco * V_o - hci * V_i, V_o - V_i)
        dBi_fill = (dBi - dAi) * (lf / lsec) + dAi
        v_fill, hc_fill = vcv_circ(dAi, dBi_fill, lf)
        m_fill = v_fill * rf * posf
        mass = m_shell + m_fill
        hc = _sdiv(hc_fill * m_fill + hc_shell * m_shell, mass)
        Ir_o, Ia_o = moi_circ(dA, dB, lsec, g.rho_shell)
        Ir_i, Ia_i = moi_circ(dAi, dBi, lsec, g.rho_shell)
        Ir_f, Ia_f = moi_circ(dAi, dBi_fill, lf, rf)
        I_rad = ((Ir_o - Ir_i) * posf + Ir_f * posf) - mass * hc ** 2
        Ixx_s = Iyy_s = I_rad
        Izz_s = ((Ia_o - Ia_i) + Ia_f) * posf
    else:
        slA, slB = d[..., :-1, :], d[..., 1:, :]
        slAi = slA - 2 * t[..., :-1, None]
        slBi = slB - 2 * t[..., 1:, None]
        V_o, hco = vcv_rect(slA, slB, lsec)
        V_i, hci = vcv_rect(slAi, slBi, lsec)
        m_shell = (V_o - V_i) * g.rho_shell * posf
        hc_shell = _sdiv(hco * V_o - hci * V_i, V_o - V_i)
        slBi_fill = (slBi - slAi) * (lf / lsec)[..., None] + slAi
        v_fill, hc_fill = vcv_rect(slAi, slBi_fill, lf)
        m_fill = v_fill * rf * posf
        mass = m_shell + m_fill
        hc = _sdiv(hc_fill * m_fill + hc_shell * m_shell, mass)
        Ix_o, Iy_o, Iz_o = moi_rect(slA[..., 0], slA[..., 1], slB[..., 0],
                                    slB[..., 1], lsec, g.rho_shell)
        Ix_i, Iy_i, Iz_i = moi_rect(slAi[..., 0], slAi[..., 1],
                                    slBi[..., 0], slBi[..., 1], lsec,
                                    g.rho_shell)
        Ix_f, Iy_f, Iz_f = moi_rect(slAi[..., 0], slAi[..., 1],
                                    slBi_fill[..., 0], slBi_fill[..., 1], lf,
                                    rf)
        Ixx_s = ((Ix_o - Ix_i) + Ix_f) * posf - mass * hc ** 2
        Iyy_s = ((Iy_o - Iy_i) + Iy_f) * posf - mass * hc ** 2
        Izz_s = ((Iz_o - Iz_i) + Iz_f) * posf

    s_sec = torch.as_tensor(st[:-1], **kw) + hc

    # the element layout: section index and mass mask per element; a
    # zero-length section reuses the previous real section's inertia
    # with zero mass (and is skipped before any real section)
    idx, msk = [], []
    prev = -1
    for j in range(n - 1):
        if pos[j]:
            idx.append(j)
            msk.append(1.0)
            prev = j
        elif prev >= 0:
            idx.append(prev)
            msk.append(0.0)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=d.device)
    msk = torch.as_tensor(msk, **kw)
    elems = [mass[..., idx] * msk, s_sec[..., idx] * msk, Ixx_s[..., idx],
             Iyy_s[..., idx], Izz_s[..., idx]]
    mshell = torch.sum(m_shell, dim=-1)

    caps = traced_cap_elements(g, d, t)
    if caps:
        elems = [torch.cat([e, torch.stack([
            torch.as_tensor(c[i], **kw).expand(e.shape[:-1]) for c in caps],
            dim=-1)], dim=-1) for i, e in enumerate(elems)]
        mshell = mshell + sum(c[0] for c in caps)
    return (*elems, mshell, m_fill)


# --------------------------------------------------------- FOWT assembly

#: the geometry keys per member (one value per entry of ``fs.members``,
#: or one for all) and per row
MEMBER_KEYS = ("d_scale", "t_scale", "fill_scale", "rho_fill_scale")
ROW_KEYS = ("Cd_scale", "Ca_scale")


def member_scales(params, n_members, R, like):
    """The per-member scales of ``params`` as (R, n_members) tensors of
    ``like``'s dtype and device (a missing key is 1; a key given as (R,)
    applies to every member)."""
    out = {}
    for k in MEMBER_KEYS:
        v = torch.as_tensor(params.get(k, 1.0), dtype=like.dtype,
                            device=like.device)
        if v.dim() == 1:
            v = v[:, None]
        out[k] = v.expand(R, n_members)
    return out


def apply_geometry(fs, ss0, params, R, k=None, device=None,
                   dtype=torch.float64):
    """Apply ``R`` rows of geometry scales to a FOWT.

    params keys (each optional; a scalar, (R,) or, for the per-member
    keys, (R, nMember) with nMember = ``len(fs.members)``):

    * ``d_scale``, ``t_scale``: outer diameter / side and shell
      thickness multipliers;
    * ``fill_scale``, ``rho_fill_scale``: ballast fill length and
      density multipliers;
    * ``Cd_scale``, ``Ca_scale``: strip drag and added-mass coefficient
      multipliers (per row).

    ``ss0`` is the design's numpy :class:`StripSet`.  Returns (fs2,
    ss2): a shallow FOWT copy whose rigid members carry per-row tensors
    (``d``, ``t``, fills, the inertia elements, ``mshell``, ``mfill``)
    for :func:`~raft_tpu_torch.physics.statics.calc_statics`, and the
    strips as (R, S, ...) tensors with scaled diameters and
    coefficients.  MacCamy-Fuchs Cm factors are re-evaluated at the
    scaled kR through :func:`~raft_tpu_torch.physics.morison.mcf_blend`
    (pass the wave numbers ``k`` (nw,) when the design has MCF
    members).  Every member is rigid: the builder refuses flexible ones.
    """
    kw = dict(dtype=dtype, device=device)
    nm = len(fs.members)
    like = torch.zeros((), **kw)
    sc = member_scales(params, nm, R, like)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), **kw)

    members2 = []
    for im, mem in enumerate(fs.members):
        ds, ts = sc["d_scale"][:, im], sc["t_scale"][:, im]
        d = t(mem.d) * ds[:, None, None]
        th = t(mem.t) * ts[:, None]
        lf = t(mem.l_fill) * sc["fill_scale"][:, im, None]
        rf = t(mem.rho_fill) * sc["rho_fill_scale"][:, im, None]
        em, es, ex, ey, ez, mshell, mfill = traced_inertia_elements(
            mem, d, th, lf, rf)
        members2.append(dataclasses.replace(
            mem, d=d, t=th, l_fill=lf, rho_fill=rf,
            ds=t(mem.ds) * ds[:, None, None],
            drs=t(mem.drs) * ds[:, None, None],
            elem_mass=em, elem_s=es, elem_Ixx=ex, elem_Iyy=ey, elem_Izz=ez,
            mshell=mshell, mfill=mfill))
    fs2 = copy.copy(fs)
    fs2.members = members2

    # strip diameters are linear in the station diameters for a fixed
    # station layout: one member scale per strip
    strip_mem = np.concatenate(
        [np.full(m.ns, i, dtype=np.int64) for i, m in enumerate(fs.members)])
    sd = sc["d_scale"][:, torch.as_tensor(strip_mem, device=device)]
    Cd_s, Ca_s = (torch.as_tensor(params.get(k2, 1.0), **kw).expand(R)[:, None]
                  for k2 in ROW_KEYS)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    ss = morison.strips_to_rows(ss0, device, rows=R)
    ss = morison.StripSet(**{
        k2: v.to(cdt) if v is not None and v.is_complex() else
        v.to(dtype) if v is not None and v.is_floating_point() else v
        for k2, v in vars(ss).items()})
    Ca_p1 = ss.Ca_p1 * Ca_s
    Ca_p2 = ss.Ca_p2 * Ca_s
    ds2 = ss.ds * sd[..., None]
    Cm_p1_w = 1.0 + Ca_s[..., None] * (ss.Cm_p1_w - 1.0)
    Cm_p2_w = 1.0 + Ca_s[..., None] * (ss.Cm_p2_w - 1.0)
    mcf = np.asarray(ss0.mcf, dtype=bool)
    if mcf.any():
        if k is None:
            raise ValueError("apply_geometry needs k (nw,) for MCF members")
        kR = t(k) * (ds2[..., 0] / 2.0)[..., None]
        Cm1, Cm2 = morison.mcf_blend(kR, (1.0 + Ca_p1)[..., None],
                             (1.0 + Ca_p2)[..., None])
        sel = torch.as_tensor(mcf, device=device)[:, None]
        Cm_p1_w = torch.where(sel, Cm1, Cm_p1_w)
        Cm_p2_w = torch.where(sel, Cm2, Cm_p2_w)
    return fs2, dataclasses.replace(
        ss, ds=ds2, drs=ss.drs * sd[..., None],
        Cd_q=ss.Cd_q * Cd_s, Cd_p1=ss.Cd_p1 * Cd_s, Cd_p2=ss.Cd_p2 * Cd_s,
        Cd_End=ss.Cd_End * Cd_s, Ca_q=ss.Ca_q * Ca_s, Ca_p1=Ca_p1,
        Ca_p2=Ca_p2, Ca_End=ss.Ca_End * Ca_s, Cm_p1_w=Cm_p1_w,
        Cm_p2_w=Cm_p2_w)
