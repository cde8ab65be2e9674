"""Linear (Airy) wave ops: dispersion, JONSWAP spectrum, kinematics,
RAO, RMS and PSD (batch-first torch counterparts of
``raft_tpu/ops/waves.py``).

The guards of the reference are kept exactly: ``_kh_ratios`` clamps
the ``sinh``/``cosh`` arguments before evaluating them, so the untaken
deep-water / zero-k branch can never overflow into a NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wave_number_ref(w, h, g=9.81, e=0.001):
    """Build-time (numpy) dispersion iteration with the reference's loose
    1e-3 stopping rule (RAFT ``helpers.py:377-392``), op for op: the
    model's wave numbers, which every later stage reads, match the
    reference's bit for bit."""
    w = np.atleast_1d(np.asarray(w, dtype=float))
    k = np.zeros_like(w)
    for i, wi in enumerate(w):
        k1 = wi * wi / g
        if k1 == 0.0:
            k[i] = 0.0
            continue
        k2 = wi * wi / (np.tanh(k1 * h) * g)
        while abs(k2 - k1) / k1 > e:
            k1 = k2
            k2 = wi * wi / (np.tanh(k1 * h) * g)
        k[i] = k2
    return k


def wave_number(w, h, g=9.81, n_iter=12):
    """Dispersion ``w^2 = g k tanh(k h)`` to double precision (numpy):
    ``n_iter`` Newton steps on ``g k tanh(k h) - w^2`` from the Eckart
    seed, op for op the reference's ``wave_number`` (the panel solver's
    wave number above K h = 6 at a finite depth)."""
    w = np.asarray(w, dtype=float)
    w2g = w * w / g
    arg = np.maximum(w2g * h, 1e-30)
    k = w2g / np.sqrt(np.tanh(arg))
    for _ in range(n_iter):
        kh = np.minimum(k * h, 50.0)  # tanh saturates; keep sech2 stable
        th = np.tanh(kh)
        sech2 = 1.0 - th * th
        f = k * th - w2g
        fp = th + kh * sech2
        fp = np.where(fp == 0, 1.0, fp)
        k = np.maximum(k - f / fp, 0.0)
    return k


def jonswap(ws, Hs, Tp, gamma=None):
    """One-sided JONSWAP spectrum.

    ws : (nw,) [rad/s]; Hs, Tp : (...); gamma : (...) or None ->
    S : (..., nw) [m^2/(rad/s)].  ``gamma`` None or 0 (per element)
    takes the IEC 61400-3 default as a function of Tp/sqrt(Hs); 1 gives
    Pierson-Moskowitz.
    """
    Hs = Hs[..., None]
    Tp = Tp[..., None]
    TpOvrSqrtHs = Tp / torch.sqrt(Hs)
    gamma_iec = torch.where(
        TpOvrSqrtHs <= 3.6, 5.0,
        torch.where(TpOvrSqrtHs >= 5.0, 1.0,
                    torch.exp(5.75 - 1.15 * TpOvrSqrtHs)))
    if gamma is None:
        gamma = gamma_iec
    else:
        gamma = torch.as_tensor(gamma, dtype=ws.dtype,
                                device=ws.device)[..., None]
        gamma = torch.where(gamma == 0, gamma_iec, gamma)
    f = 0.5 / math.pi * ws
    fpOvrf4 = (Tp * f) ** -4.0
    C = 1.0 - 0.287 * torch.log(gamma)
    # two python scalars would make torch.where return the default dtype
    sigma = torch.where(f <= 1.0 / Tp, f.new_tensor(0.07), f.new_tensor(0.09))
    alpha = torch.exp(-0.5 * ((f * Tp - 1.0) / sigma) ** 2)
    return (0.5 / math.pi * C * 0.3125 * Hs * Hs * fpOvrf4 / f
            * torch.exp(-1.25 * fpOvrf4) * gamma ** alpha)


def amplitudes(S, dw):
    """Wave component amplitudes ``sqrt(2 S dw)``.  Where the spectrum
    underflows to 0 (the JONSWAP tail below about 0.2 / Tp) the
    amplitude is 0 and so is its derivative, the limit of
    ``sqrt(2 c Hs^2 e dw)`` as e -> 0; the plain sqrt would give it
    0 * inf = NaN (as the reference's does)."""
    pos = S > 0
    return torch.where(pos, torch.sqrt(2.0 * torch.where(pos, S, 1.0) * dw),
                       0.0)


def _kh_ratios(k, h, z):
    """sinh(k(z+h))/sinh(kh), cosh(k(z+h))/sinh(kh), cosh(k(z+h))/cosh(kh)
    with the reference's guards (k == 0; kh > 89.4 deep water); all
    arguments broadcast."""
    kh = k * h
    deep = kh > 89.4
    kzero = k == 0.0
    arg_zh = torch.where(deep | kzero, 0.0, k * (z + h))
    arg_h = torch.where(deep | kzero, 1.0, kh)
    sinh_den = torch.sinh(arg_h)
    SINH = torch.sinh(arg_zh) / sinh_den
    COSHs = torch.cosh(arg_zh) / sinh_den
    COSHc = torch.cosh(arg_zh) / torch.cosh(arg_h)

    ekz = torch.exp(torch.clamp(k * z, max=0.0))
    SINH = torch.where(deep, ekz, SINH)
    COSHs = torch.where(deep, ekz, COSHs)
    COSHc = torch.where(
        deep, ekz + torch.exp(torch.clamp(-k * (z + 2.0 * h), max=0.0)),
        COSHc)
    SINH = torch.where(kzero, 1.0, SINH)
    COSHs = torch.where(kzero, 99999.0, COSHs)
    COSHc = torch.where(kzero, 99999.0, COSHc)
    return SINH, COSHs, COSHc


def wave_kinematics(zeta0, beta, w, k, h, r, rho, g):
    """Complex wave velocity, acceleration and dynamic pressure at
    points ``r`` for one heading per batch row.

    zeta0 : (R, nw) complex; beta, h, rho, g : (R,); w : (nw,);
    k : (R, nw); r : (R, P, 3).  Returns u, ud : (R, P, 3, nw) and
    p : (R, P, nw).  Points above the waterline get zero kinematics.
    """
    x, y, z = r[..., 0:1], r[..., 1:2], r[..., 2:3]          # (R, P, 1)
    cosb = torch.cos(beta)[:, None, None]
    sinb = torch.sin(beta)[:, None, None]
    k = k[:, None, :]                                       # (R, 1, nw)
    zeta = zeta0[:, None, :] * torch.exp(-1j * (k * (cosb * x + sinb * y)))

    SINH, COSHs, COSHc = _kh_ratios(k, h[:, None, None], z)
    sub = z <= 0

    u_x = w * zeta * COSHs * cosb
    u_y = w * zeta * COSHs * sinb
    u_z = 1j * w * zeta * SINH
    u = torch.stack([u_x, u_y, u_z], dim=-2)                # (R, P, 3, nw)
    u = torch.where(sub[..., None, :], u, 0.0)
    ud = 1j * w * u
    rg = (rho * g)[:, None, None]
    p = torch.where(sub, rg * zeta * COSHc, 0.0)
    return u, ud, p


def get_kinematics(r, Xi, w):
    """Point displacement, velocity and acceleration amplitudes from
    6-DOF motion amplitudes (the reference's ``getKinematics``).

    r : (..., 3) point about the reference; Xi : (..., 6, nw) complex;
    w : (nw,).  Returns (dr, v, a), each (..., 3, nw)."""
    from raft_tpu_torch.ops.transforms import cross

    th = Xi[..., 3:, :]
    rr = torch.as_tensor(r)[..., :, None].expand(th.shape)
    dr = Xi[..., :3, :] + cross(th, rr, dim=-2)
    v = 1j * w * dr
    a = 1j * w * v
    return dr, v, a


def get_rms(xi):
    """sqrt(0.5 sum |xi|^2) over every axis."""
    return torch.sqrt(0.5 * torch.sum(torch.abs(xi) ** 2))


def get_psd(xi, dw, axis=None):
    """Response PSD 0.5 |xi|^2 / dw, summed over ``axis`` (the
    excitation sources) when given."""
    psd = 0.5 * torch.abs(xi) ** 2 / dw
    if axis is not None:
        psd = torch.sum(psd, dim=axis)
    return psd


def get_rao(Xi, zeta, eps=1e-6):
    """Response per unit wave amplitude, zero where |zeta| <= eps."""
    ok = torch.abs(zeta) > eps
    zsafe = torch.where(ok, zeta, 1.0)
    return torch.where(ok, Xi / zsafe, 0.0)
