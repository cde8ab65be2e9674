"""Rigid-body transform ops (batch-first torch counterparts of
``raft_tpu/ops/transforms.py``).

Conventions are the reference's: ``skew(r) @ th == cross(th, r)``, and
``rotation_matrix(x3, x2, x1) = Rz(x1) Ry(x2) Rx(x3)``.  Every function
takes leading batch dimensions.
"""

from __future__ import annotations

import torch


def cross(a, b, dim=-1):
    """``a x b`` along ``dim`` (real or complex, broadcasting), written
    out component-wise as ``jnp.cross`` computes it."""
    a0, a1, a2 = a.unbind(dim)
    b0, b1, b2 = b.unbind(dim)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=dim)


def skew(r):
    """Alternator matrix H of a 3-vector: ``H @ v == cross(v, r)``;
    (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, r[..., 2], -r[..., 1]], dim=-1),
        torch.stack([-r[..., 2], z, r[..., 0]], dim=-1),
        torch.stack([r[..., 1], -r[..., 0], z], dim=-1),
    ], dim=-2)


def rotation_matrix(x3, x2, x1):
    """Intrinsic z-y-x rotation ``Rz(x1) Ry(x2) Rx(x3)``; inputs
    broadcast against each other, output (..., 3, 3)."""
    s1, c1 = torch.sin(x1), torch.cos(x1)
    s2, c2 = torch.sin(x2), torch.cos(x2)
    s3, c3 = torch.sin(x3), torch.cos(x3)
    r00 = c1 * c2
    r01 = c1 * s2 * s3 - c3 * s1
    r02 = s1 * s3 + c1 * c3 * s2
    r10 = c2 * s1
    r11 = c1 * c3 + s1 * s2 * s3
    r12 = c3 * s1 * s2 - c1 * s3
    r20 = -s2
    r21 = c2 * s3
    r22 = c2 * c3
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def translate_force_3to6(F, r):
    """Force ``F`` at point ``r`` -> 6-DOF force/moment about the
    origin; (..., 3) -> (..., 6)."""
    return torch.cat([F, cross(r, F)], dim=-1)


def vec_vec_trans(v):
    """Outer product ``v v^T``; (..., 3) -> (..., 3, 3)."""
    return v[..., :, None] * v[..., None, :]


def translate_matrix_3to6(M3, r):
    """3x3 mass-like matrix at point ``r`` -> 6x6 about the origin;
    (..., 3, 3), (..., 3) -> (..., 6, 6)."""
    H = skew(r)
    MH = M3 @ H
    top = torch.cat([M3, MH], dim=-1)
    bot = torch.cat([MH.transpose(-1, -2), H @ M3 @ H.transpose(-1, -2)],
                    dim=-1)
    return torch.cat([top, bot], dim=-2)


def translate_matrix_6to6(M6, r):
    """Translate a 6x6 matrix to a new reference point; ``r`` points from
    the new reference point to the old one."""
    H = skew(r)
    Ht = H.transpose(-1, -2)
    m = M6[..., :3, :3]
    J = M6[..., :3, 3:]
    Jt = M6[..., 3:, :3]
    I = M6[..., 3:, 3:]
    J2 = m @ H + J
    I2 = H @ m @ Ht + Jt @ H + Ht @ J + I
    top = torch.cat([m, J2], dim=-1)
    bot = torch.cat([J2.transpose(-1, -2), I2], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rotate_matrix_6(M6, R):
    """Rotate a 6x6 mass/inertia tensor block-wise: ``R @ block @ R^T``."""
    Rt = R.transpose(-1, -2)
    m = R @ M6[..., :3, :3] @ Rt
    J = R @ M6[..., :3, 3:] @ Rt
    I = R @ M6[..., 3:, 3:] @ Rt
    top = torch.cat([m, J], dim=-1)
    bot = torch.cat([J.transpose(-1, -2), I], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_force_6(f6, offset):
    """Shift a 6-component force/moment by ``offset`` (adds r x F to the
    moment)."""
    return torch.cat([f6[..., :3], f6[..., 3:] + cross(offset, f6[..., :3])],
                     dim=-1)


def weight_of_point_mass(mass, dR, g=9.81):
    """6-DOF weight load and 6x6 weight stiffness of a point mass whose CG
    sits at ``dR`` from the reference point: (W (..., 6), C (..., 6, 6))."""
    mass = torch.as_tensor(mass, dtype=dR.dtype, device=dR.device)
    Fz = -g * mass
    zeros = torch.zeros_like(Fz)
    W = translate_force_3to6(torch.stack([zeros, zeros, Fz], dim=-1), dR)
    C = torch.zeros(mass.shape + (6, 6), dtype=W.dtype, device=W.device)
    C[..., 3, 3] = -mass * g * dR[..., 2]
    C[..., 4, 4] = -mass * g * dR[..., 2]
    return W, C
