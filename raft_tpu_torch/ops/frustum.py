"""Frustum (tapered-cylinder / tapered-cuboid) geometry (torch
counterparts of ``raft_tpu/ops/frustum.py``).

Closed-form volume / centroid / moment-of-inertia formulas of member
sections.  Degenerate inputs (zero height, zero taper, zero area) are
handled with ``torch.where`` guards whose divide-by-zero operands are
sanitised before the division, as in the reference.  Arguments may be
Python or numpy numbers or tensors; the result follows the first
tensor's device and dtype (float64 on the CPU when there is none).
"""

from __future__ import annotations

import math

import torch


def _tensors(*xs):
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    kw = (dict(dtype=like.dtype, device=like.device) if like is not None
          else dict(dtype=torch.float64, device="cpu"))
    return [torch.as_tensor(x, **kw) for x in xs]


def _safe_div(num, den, fallback=0.0):
    """num/den with den == 0 mapped to ``fallback``."""
    num, den = _tensors(num, den)
    den_ok = den != 0
    den_safe = torch.where(den_ok, den, 1.0)
    return torch.where(den_ok, num / den_safe, fallback)


def frustum_vcv_circ(dA, dB, H):
    """Volume and axial centroid (from the dA end) of a circular
    frustum.  Returns (V, hc)."""
    dA, dB, H = _tensors(dA, dB, H)
    A1 = 0.25 * math.pi * dA ** 2
    A2 = 0.25 * math.pi * dB ** 2
    Am = 0.25 * math.pi * dA * dB
    V = (A1 + A2 + Am) * H / 3.0
    hc = _safe_div(A1 + 2.0 * Am + 3.0 * A2, A1 + Am + A2) * H / 4.0
    return V, hc


def frustum_vcv_rect(slA, slB, H):
    """Volume and axial centroid of a rectangular frustum; slA/slB:
    (..., 2) side-length pairs."""
    slA, slB, H = _tensors(slA, slB, H)
    A1 = slA[..., 0] * slA[..., 1]
    A2 = slB[..., 0] * slB[..., 1]
    Am = torch.sqrt(A1 * A2)
    V = (A1 + A2 + Am) * H / 3.0
    hc = _safe_div(A1 + 2.0 * Am + 3.0 * A2, A1 + Am + A2) * H / 4.0
    return V, hc


def frustum_moi_circ(dA, dB, H, rho):
    """Radial and axial mass moments of inertia of a (possibly tapered)
    circular frustum about its dA-end node: (I_rad, I_ax).  The cylinder
    limit (dA == dB), where the tapered formula is 0/0, takes the
    cylinder formula."""
    dA, dB, H, rho = _tensors(dA, dB, H, rho)
    r1 = dA / 2.0
    r2 = dB / 2.0
    I_rad_cyl = (1.0 / 12.0) * (rho * H * math.pi * r1 ** 2) * (
        3.0 * r1 ** 2 + 4.0 * H ** 2)
    I_ax_cyl = 0.5 * rho * math.pi * H * r1 ** 4
    dr = r2 - r1
    dr_safe = torch.where(dr == 0, 1.0, dr)
    r5 = (r2 ** 5 - r1 ** 5) / dr_safe
    I_rad_tap = (1.0 / 20.0) * rho * math.pi * H * r5 + (
        1.0 / 30.0) * rho * math.pi * H ** 3 * (
        r1 ** 2 + 3.0 * r1 * r2 + 6.0 * r2 ** 2)
    I_ax_tap = (1.0 / 10.0) * rho * math.pi * H * r5
    is_cyl = dr == 0
    I_rad = torch.where(is_cyl, I_rad_cyl, I_rad_tap)
    I_ax = torch.where(is_cyl, I_ax_cyl, I_ax_tap)
    zero = H == 0
    return torch.where(zero, 0.0, I_rad), torch.where(zero, 0.0, I_ax)


def frustum_moi_rect(slA, slB, H, rho):
    """Moments of inertia (Ixx, Iyy, Izz) of a tapered cuboid about its
    slA-end node; slA/slB: (..., 2) as (L, W) pairs.  The double-taper
    closed form with the cuboid and single-taper cases selected by
    ``torch.where``, as the reference selects them."""
    slA, slB, H, rho = _tensors(slA, slB, H, rho)
    La, Wa = slA[..., 0], slA[..., 1]
    Lb, Wb = slB[..., 0], slB[..., 1]

    M = rho * La * Wa * H
    Ixx_c = (1.0 / 12.0) * M * (Wa ** 2 + 4.0 * H ** 2)
    Iyy_c = (1.0 / 12.0) * M * (La ** 2 + 4.0 * H ** 2)
    Izz_c = (1.0 / 12.0) * M * (La ** 2 + Wa ** 2)

    dL = Lb - La
    dW = Wb - Wa
    x2 = (1.0 / 12.0) * rho * (
        dL ** 3 * H * (Wb / 5.0 + Wa / 20.0)
        + dL ** 2 * La * H * (3.0 * Wb / 4.0 + Wa / 4.0)
        + dL * La ** 2 * H * (Wb + Wa / 2.0)
        + La ** 3 * H * (Wb / 2.0 + Wa / 2.0))
    y2 = (1.0 / 12.0) * rho * (
        dW ** 3 * H * (Lb / 5.0 + La / 20.0)
        + dW ** 2 * Wa * H * (3.0 * Lb / 4.0 + La / 4.0)
        + dW * Wa ** 2 * H * (Lb + La / 2.0)
        + Wa ** 3 * H * (Lb / 2.0 + La / 2.0))
    z2 = rho * (Wb * Lb / 5.0 + Wa * Lb / 20.0 + La * Wb / 20.0
                + Wa * La / 30.0) * H ** 3

    x2_w = (1.0 / 24.0) * rho * (La ** 3) * H * (Wb + Wa)
    y2_w = (1.0 / 48.0) * rho * La * H * (Wb ** 3 + Wa * Wb ** 2
                                          + Wa ** 2 * Wb + Wa ** 3)
    z2_w = (1.0 / 12.0) * rho * La * (H ** 3) * (3.0 * Wb + Wa)
    x2_l = (1.0 / 48.0) * rho * Wa * H * (Lb ** 3 + La * Lb ** 2
                                          + La ** 2 * Lb + La ** 3)
    y2_l = (1.0 / 24.0) * rho * (Wa ** 3) * H * (Lb + La)
    z2_l = (1.0 / 12.0) * rho * Wa * (H ** 3) * (3.0 * Lb + La)

    sameL = dL == 0
    sameW = dW == 0
    x2s = torch.where(sameL, torch.where(sameW, 0.0, x2_w),
                      torch.where(sameW, x2_l, x2))
    y2s = torch.where(sameL, torch.where(sameW, 0.0, y2_w),
                      torch.where(sameW, y2_l, y2))
    z2s = torch.where(sameL, torch.where(sameW, 0.0, z2_w),
                      torch.where(sameW, z2_l, z2))

    both_same = sameL & sameW
    Ixx = torch.where(both_same, Ixx_c, y2s + z2s)
    Iyy = torch.where(both_same, Iyy_c, x2s + z2s)
    Izz = torch.where(both_same, Izz_c, x2s + y2s)
    zero = H == 0
    return (torch.where(zero, 0.0, Ixx), torch.where(zero, 0.0, Iyy),
            torch.where(zero, 0.0, Izz))
