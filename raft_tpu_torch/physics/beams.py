"""Finite-element Timoshenko beam matrices of flexible members (numpy;
counterpart of ``raft_tpu/physics/beams.py``).

The reference RAFT's frame FE model (``raft_member.py``
``computeStiffnessMatrix_FE`` :2154-2298, ``computeInertiaMatrix_FE``
:2300-2408): each element between adjacent member nodes contributes a
12x12 stiffness or consistent-mass matrix in the local (p1, p2, q)
frame, rotated to global and assembled into the member's (6 n_nodes)
square matrices.  Evaluated once per design at build time; the
assembled matrices enter the evaluators as constants.
"""

from __future__ import annotations

import numpy as np


def _section_props(mem, i):
    """Cross-section area / second moments of the element between nodes
    i and i+1 (mean of the node sections)."""
    if mem.circular:
        Do = 0.5 * (mem.dorsl_node_ext[i, 0] + mem.dorsl_node_ext[i + 1, 0])
        Di = 0.5 * (mem.dorsl_node_int[i, 0] + mem.dorsl_node_int[i + 1, 0])
        A = np.pi * (Do**2 - Di**2) / 4
        Jp1 = np.pi * (Do**4 - Di**4) / 64
        Jp2 = Jp1
        return A, Jp1, Jp2, Do, Di, None, None
    Wo = 0.5 * (mem.dorsl_node_ext[i] + mem.dorsl_node_ext[i + 1])
    Wi = 0.5 * (mem.dorsl_node_int[i] + mem.dorsl_node_int[i + 1])
    A = Wo[0] * Wo[1] - Wi[0] * Wi[1]
    Jp1 = (Wo[0] ** 3 * Wo[1] - Wi[0] ** 3 * Wi[1]) / 12
    Jp2 = (Wo[0] * Wo[1] ** 3 - Wi[0] * Wi[1] ** 3) / 12
    return A, Jp1, Jp2, None, None, Wo, Wi


def _rotation_12(mem):
    Dc_aux = np.column_stack((mem.p10, mem.p20, mem.q0))
    Dc = np.zeros((12, 12))
    for b in range(4):
        Dc[3 * b:3 * b + 3, 3 * b:3 * b + 3] = Dc_aux
    return Dc


def fe_stiffness(mem, node_r):
    """(6n, 6n) global-frame Timoshenko stiffness matrix of a beam
    member; node_r : (n, 3) current node positions."""
    n = len(node_r)
    K = np.zeros((6 * n, 6 * n))
    if mem.mtype != "beam":
        return K
    E, G = mem.E, mem.G
    nu = E / (2 * G) - 1
    Dc = _rotation_12(mem)

    for i in range(n - 1):
        L = np.linalg.norm(node_r[i + 1] - node_r[i])
        A, Jp1, Jp2, Do, Di, Wo, Wi = _section_props(mem, i)
        if mem.circular:
            ratio2 = (Di / Do) ** 2
            kp1 = (6 * (1 + nu) ** 2 * (1 + ratio2) ** 2) / (
                (1 + ratio2) ** 2 * (7 + 14 * nu + 8 * nu**2)
                + 4 * ratio2 * (5 + 10 * nu + 4 * nu**2))
            kp2 = kp1
            Jt = 2 * Jp1
        else:
            if Wi[0] == 0 or Wi[1] == 0:
                a, b = max(Wo), min(Wo)
                Jt = a * b**3 / 16 * (16 / 3 - 3.36 * (b / a) * (1 - b**4 / a**4 / 12))
                kp1 = 10 * (1 + nu) / (12 + 11 * nu)
                kp2 = kp1
            else:
                t0 = (Wo[0] - Wi[0]) / 2
                t1 = (Wo[1] - Wi[1]) / 2
                Jt = 2 * t0 * t1 * (Wo[0] - t0) ** 2 * (Wo[1] - t1) ** 2 / (
                    Wo[0] * t0 + Wo[1] * t1 - t0**2 - t1**2)

                m = Wi[0] * t1 / Wo[1] / t0
                nn = Wi[0] / Wo[1]
                kp1 = 10 * (1 + nu) * (1 + 3 * m) ** 2 / (
                    12 + 72 * m + 150 * m**2 + 90 * m**3
                    + nu * (11 + 66 * m + 135 * m**2 + 90 * m**3)
                    + 10 * nn**2 * ((3 + nu) * m + 3 * m**2))
                m = Wi[1] * t0 / Wo[0] / t1
                nn = Wi[1] / Wo[0]
                kp2 = 10 * (1 + nu) * (1 + 3 * m) ** 2 / (
                    12 + 72 * m + 150 * m**2 + 90 * m**3
                    + nu * (11 + 66 * m + 135 * m**2 + 90 * m**3)
                    + 10 * nn**2 * ((3 + nu) * m + 3 * m**2))

        Ksx = 12 * E * Jp2 / (G * kp1 * A * L**2)
        Ksy = 12 * E * Jp1 / (G * kp2 * A * L**2)

        K11 = np.zeros((6, 6))
        K11[0, 0] = 12 * E * Jp2 / L**3 / (1 + Ksx)
        K11[1, 1] = 12 * E * Jp1 / L**3 / (1 + Ksy)
        K11[2, 2] = E * A / L
        K11[3, 3] = (4 + Ksy) * E * Jp1 / L / (1 + Ksy)
        K11[4, 4] = (4 + Ksx) * E * Jp2 / L / (1 + Ksx)
        K11[5, 5] = G * Jt / L
        K11[0, 4] = 6 * E * Jp2 / L**2 / (1 + Ksx)
        K11[1, 3] = -6 * E * Jp1 / L**2 / (1 + Ksy)

        K22 = K11.copy()
        K22[0, 4] *= -1
        K22[1, 3] *= -1

        K12 = np.zeros((6, 6))
        K12[0, 0] = -K11[0, 0]
        K12[1, 1] = -K11[1, 1]
        K12[2, 2] = -K11[2, 2]
        K12[3, 3] = (2 - Ksy) * E * Jp1 / L / (1 + Ksy)
        K12[4, 4] = (2 - Ksx) * E * Jp2 / L / (1 + Ksx)
        K12[5, 5] = -K11[5, 5]
        K12[0, 4] = K11[0, 4]
        K12[1, 3] = K11[1, 3]
        K12[4, 0] = -K11[0, 4]
        K12[3, 1] = -K11[1, 3]

        K11 = K11 + K11.T - np.diag(K11.diagonal())
        K22 = K22 + K22.T - np.diag(K22.diagonal())
        Ke = np.block([[K11, K12], [K12.T, K22]])
        Keg = Dc @ Ke @ Dc.T
        K[6 * i:6 * i + 12, 6 * i:6 * i + 12] += Keg
    return K


def fe_inertia(mem, node_r):
    """(6n, 6n) global-frame consistent-mass matrix of a beam member."""
    n = len(node_r)
    M = np.zeros((6 * n, 6 * n))
    if mem.mtype != "beam":
        return M
    Dc = _rotation_12(mem)
    for i in range(n - 1):
        L = np.linalg.norm(node_r[i + 1] - node_r[i])
        A, Jp1, Jp2, *_ = _section_props(mem, i)
        Jz = Jp1 + Jp2

        M11 = np.zeros((6, 6))
        M11[0, 0] = 13 * A * L / 35 + 6 * Jp2 / 5 / L
        M11[1, 1] = 13 * A * L / 35 + 6 * Jp1 / 5 / L
        M11[2, 2] = A * L / 3
        M11[3, 3] = A * L**3 / 105 + 2 * L * Jp1 / 15
        M11[4, 4] = A * L**3 / 105 + 2 * L * Jp2 / 15
        M11[5, 5] = Jz * L / 3
        M11[0, 4] = 11 * A * L**2 / 210 + Jp2 / 10
        M11[1, 3] = -11 * A * L**2 / 210 - Jp1 / 10

        M22 = M11.copy()
        M22[0, 4] *= -1
        M22[1, 3] *= -1

        M12 = np.zeros((6, 6))
        M12[0, 0] = 9 * A * L / 70 - 6 * Jp2 / 5 / L
        M12[1, 1] = 9 * A * L / 70 - 6 * Jp1 / 5 / L
        M12[2, 2] = A * L / 6
        M12[3, 3] = -A * L**3 / 140 - L * Jp1 / 30
        M12[4, 4] = -A * L**3 / 140 - L * Jp2 / 30
        M12[5, 5] = Jz * L / 6
        M12[0, 4] = -13 * A * L**2 / 420 + Jp2 / 10
        M12[1, 3] = 13 * A * L**2 / 420 - Jp1 / 10
        M12[4, 0] = 13 * A * L**2 / 420 - Jp2 / 10
        M12[3, 1] = -13 * A * L**2 / 420 + Jp1 / 10

        M11 = M11 + M11.T - np.diag(M11.diagonal())
        M22 = M22 + M22.T - np.diag(M22.diagonal())
        Me = np.block([[M11, M12], [M12.T, M22]]) * mem.rho_shell
        Meg = Dc @ Me @ Dc.T
        M[6 * i:6 * i + 12, 6 * i:6 * i + 12] += Meg
    return M


def mass_and_center(M, node_r):
    """Mass and CG of a beam from its FE inertia matrix
    (helpers.py:1084-1125 getMassAndCenterOfBeam)."""
    n = len(node_r)
    nDOF = 6 * n
    X = np.zeros(nDOF)
    X[0::6] = 1
    mass = float(np.sum((M @ X) * X))
    center = np.zeros(3)
    if mass != 0:
        for ax in range(3):
            aux = np.zeros(nDOF)
            aux[ax::6] = 1
            rvec = np.zeros(nDOF)
            rvec[ax::6] = node_r[:, ax]
            center[ax] = np.sum(M @ (rvec) * aux) / mass
    return mass, center
