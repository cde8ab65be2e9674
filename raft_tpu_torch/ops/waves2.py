"""Second-order wave kinematics (batched torch counterparts of
``raft_tpu/ops/waves2.py``), used by the slender-body QTF
(:mod:`raft_tpu_torch.physics.qtf_slender`).

Every function is elementwise over a batch: the frequencies and wave
numbers broadcast against the points' leading axes (``r`` is (..., 3)),
so a whole grid of nodes x frequencies, or of frequency pairs x nodes,
is one call; the heading ``beta_rad`` and the depth ``h`` are scalars.

A quirk of the reference is kept on purpose: these helpers receive the
wave heading in RADIANS, but apply a degrees-to-radians factor to it
for the direction cosines while the raw value enters the phase factor
(in :func:`grad_u1`; :func:`grad_pres1st` and :func:`pot_2nd_ord` use
the converted cosines throughout).  The reference's golden QTFs encode
this mixed-units behaviour, so pass ``beta_rad`` as the reference does.
"""

from __future__ import annotations

import math

import torch

DEG2RAD = 0.017453292519943295


def _khz(k, h, z, denom="sinh"):
    """cosh/sinh(k(z+h)) / {sinh,cosh}(kh) with the reference's deep-water
    switch at k h >= 10 (then exp(k z) for both)."""
    kh = k * h
    deep = kh >= 10.0
    arg_zh = torch.where(deep, 0.0, k * (z + h))
    arg_h = torch.where(deep, 1.0, kh)
    den = torch.sinh(arg_h) if denom == "sinh" else torch.cosh(arg_h)
    ekz = torch.exp(k * z)
    khz_xy = torch.where(deep, ekz, torch.cosh(arg_zh) / den)
    khz_z = torch.where(deep, ekz, torch.sinh(arg_zh) / den)
    return khz_xy, khz_z


def grad_u1(w, k, beta_rad, h, r):
    """(..., 3, 3) complex gradient of the first-order velocity per unit
    wave amplitude at points r (..., 3), zero above the waterline or at
    k = 0.  Entry [2, 1] repeats [0, 1], as in the reference."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    cosB = math.cos(DEG2RAD * beta_rad)
    sinB = math.sin(DEG2RAD * beta_rad)
    khz_xy, khz_z = _khz(k, h, z, denom="sinh")
    active = (z <= 0) & (k > 0)

    phase = torch.exp(-1j * (k * (math.cos(beta_rad) * x
                                  + math.sin(beta_rad) * y)))
    aux_x = w * cosB * phase
    aux_y = w * sinB * phase
    aux_z = 1j * w * phase

    g00 = -1j * aux_x * khz_xy * k * cosB
    g01 = -1j * aux_x * khz_xy * k * sinB
    g02 = aux_x * k * khz_z
    g11 = -1j * aux_y * khz_xy * k * sinB
    g12 = aux_y * k * khz_z
    g22 = aux_z * k * khz_xy
    G = torch.stack([torch.stack([g00, g01, g02], dim=-1),
                     torch.stack([g01, g11, g12], dim=-1),
                     torch.stack([g02, g01, g22], dim=-1)], dim=-2)
    return torch.where(active[..., None, None], G, 0.0)


def grad_dudt(w, k, beta_rad, h, r):
    """Gradient of the first-order acceleration: ``1j w grad_u1``."""
    return 1j * w[..., None, None] * grad_u1(w, k, beta_rad, h, r)


def grad_pres1st(k, beta_rad, h, r, rho=1025.0, g=9.81):
    """(..., 3) complex gradient of the first-order pressure per unit
    wave amplitude at points r (..., 3)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    cosB = math.cos(DEG2RAD * beta_rad)
    sinB = math.sin(DEG2RAD * beta_rad)
    khz_xy, khz_z = _khz(k, h, z, denom="cosh")
    active = (z <= 0) & (k > 0)
    phase = torch.exp(-1j * (k * (cosB * x + sinB * y)))
    out = torch.stack([
        rho * g * khz_xy * phase * (-1j * k * cosB),
        rho * g * khz_xy * phase * (-1j * k * sinB),
        rho * g * khz_z * phase * k,
    ], dim=-1)
    return torch.where(active[..., None], out, 0.0)


def u_single(w, k, beta_rad, h, r):
    """(..., 3) complex first-order velocity per unit wave amplitude at
    points r (..., 3), one frequency each (the reference's wave
    kinematics for a single component: deep water above k h = 89.4)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zeta = torch.exp(-1j * (k * (math.cos(beta_rad) * x
                                 + math.sin(beta_rad) * y)))
    kh = k * h
    deep = kh > 89.4
    kzero = k == 0.0
    arg_zh = torch.where(deep | kzero, 0.0, k * (z + h))
    arg_h = torch.where(deep | kzero, 1.0, kh)
    SINH = torch.sinh(arg_zh) / torch.sinh(arg_h)
    COSHs = torch.cosh(arg_zh) / torch.sinh(arg_h)
    ekz = torch.exp(torch.clamp(k * z, max=0.0))
    SINH = torch.where(deep, ekz, torch.where(kzero, 1.0, SINH))
    COSHs = torch.where(deep, ekz, torch.where(kzero, 99999.0, COSHs))
    u = torch.stack([w * zeta * COSHs * math.cos(beta_rad),
                     w * zeta * COSHs * math.sin(beta_rad),
                     1j * w * zeta * SINH], dim=-1)
    return torch.where((z <= 0)[..., None], u, 0.0)


def _dot(a, q):
    """sum_i a[..., i] q[i] over the last axis of length 3."""
    return a[..., 0] * q[0] + a[..., 1] * q[1] + a[..., 2] * q[2]


def axdiv_acc_from(dwdz1, u1, dwdz2, u2, vel1, vel2, q):
    """Rainey's axial-divergence acceleration (..., 3) from the pieces of
    both frequencies: dwdz = (grad_u1 q) . q, u the velocity
    (:func:`u_single`), vel the body velocity at the point; q (3,) the
    member axis (complex)."""
    v1 = vel1 - _dot(vel1, q)[..., None] * q
    v2 = vel2 - _dot(vel2, q)[..., None] * q
    u1p = u1 - _dot(u1, q)[..., None] * q
    u2p = u2 - _dot(u2, q)[..., None] * q
    acc = 0.25 * (dwdz1[..., None] * torch.conj(u2p - v2)
                  + torch.conj(dwdz2)[..., None] * (u1p - v1))
    return acc - _dot(acc, q)[..., None] * q


def dwdz(G, q):
    """(grad_u1 q) . q of gradients G (..., 3, 3) and axis q (3,)."""
    return _dot(_mv(G, q), q)


def _mv(A, x):
    """A (..., 3, 3) times x (..., 3) (or (3,)), written out per row."""
    return (A[..., 0] * x[..., 0:1] + A[..., 1] * x[..., 1:2]
            + A[..., 2] * x[..., 2:3])


def axdiv_acc(w1, w2, k1, k2, beta_rad, h, r, vel1, vel2, q):
    """Rainey's axial-divergence acceleration (..., 3) at points r of
    the frequency pair (w1, k1), (w2, k2)."""
    qc = q.to(torch.promote_types(q.dtype, torch.complex64))
    G1 = grad_u1(w1, k1, beta_rad, h, r)
    G2 = grad_u1(w2, k2, beta_rad, h, r)
    return axdiv_acc_from(dwdz(G1, qc), u_single(w1, k1, beta_rad, h, r),
                          dwdz(G2, qc), u_single(w2, k2, beta_rad, h, r),
                          vel1, vel2, qc)


def pot_2nd_ord(w1, w2, k1, k2, beta_rad, h, r, g=9.81, rho=1025.0):
    """Difference-frequency second-order potential: acceleration
    (..., 3) and pressure (...) complex at points r (..., 3) of the
    frequency pair (w1, k1), (w2, k2), zero above the waterline, at
    k = 0 and on the diagonal w1 = w2."""
    b = DEG2RAD * beta_rad
    cosB, sinB = math.cos(b), math.sin(b)
    z = r[..., 2]
    kx = k1 * cosB - k2 * cosB
    ky = k1 * sinB - k2 * sinB
    nk = torch.sqrt(kx * kx + ky * ky)
    nk_safe = torch.where(nk == 0, 1e-30, nk)

    dw2 = (w1 - w2) ** 2
    den1 = dw2 / g - nk * torch.tanh(nk_safe * h)
    den1 = torch.where(torch.abs(den1) < 1e-30, 1e-30, den1)
    t1, t2 = torch.tanh(k1 * h), torch.tanh(k2 * h)
    g12 = (-1j * g / (2 * w1)) * (
        k1**2 * (1 - t1 ** 2) - 2 * k1 * k2 * (1 + t1 * t2)) / den1
    g21 = (-1j * g / (2 * w2)) * (
        k2**2 * (1 - t2 ** 2) - 2 * k2 * k1 * (1 + t2 * t1)) / den1
    aux = 0.5 * (g21 + torch.conj(g12))

    khz_xy = torch.cosh(nk_safe * (z + h)) / torch.cosh(nk_safe * h)
    khz_z = torch.sinh(nk_safe * (z + h)) / torch.cosh(nk_safe * h)
    phase = torch.exp(-1j * (kx * r[..., 0] + ky * r[..., 1] + 0.0 * z))

    dw = w1 - w2
    acc = torch.stack([
        aux * khz_xy * phase * dw * (k1 * cosB - k2 * cosB),
        aux * khz_xy * phase * dw * (k1 * sinB - k2 * sinB),
        aux * khz_z * phase * 1j * dw * nk,
    ], dim=-1)
    p = aux * khz_xy * phase * (-1j) * rho * dw

    active = (z <= 0) & (k1 > 0) & (k2 > 0) & (w1 != w2)
    return (torch.where(active[..., None], acc, 0.0),
            torch.where(active, p, 0.0))
