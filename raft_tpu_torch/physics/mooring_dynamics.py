"""Frequency-domain lumped-mass mooring line dynamics, ``moorMod`` 1 and
2 (counterpart of ``raft_tpu/physics/mooring_dynamics.py``).

Each line is cut into lumped nodes along its static elastic catenary
(:func:`line_static_shape`, host numpy); per node three DOFs carry the
structural and added mass, the axial (EA) and geometric (mean-tension)
stiffness, the segments' internal damping, Morison drag linearised
stochastically, and the wave excitation.  The anchor end is fixed, the
fairlead end moves with the platform, grounded nodes are held
vertically by the seabed.  :func:`line_dynamics` assembles the interior
system on the host, as the reference does, and solves it on the device
for every frequency at once: ``torch.linalg.solve`` on (nw, 3 n_int,
3 n_int), where the reference calls ``jnp.linalg.solve`` (a library
solve there too, no Pallas kernel), five drag trips and a last solve.

Outputs: the dynamic tension amplitudes along the line (``moorMod`` 1
tensions, :func:`fowt_line_tension_amps`) and the fairlead impedance
with the interior condensed out, which :func:`fowt_mooring_impedance`
carries to the platform's 6 DOFs (the ``moorMod`` 2 mooring reaction,
in place of the quasi-static stiffness).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.physics.mooring import solve_catenary
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device


def _np_rotation(r6):
    """The rotation matrix of pose angles r6[3:6] as numpy."""
    a = torch.as_tensor(np.asarray(r6[3:6], dtype=float))
    return tf.rotation_matrix(a[0], a[1], a[2]).numpy()


def line_static_shape(r_anchor, r_fair, L, w_lin, EA, n_seg=24,
                      can_ground=True):
    """Node positions and mean tensions along the static elastic
    catenary (anchor node 0, fairlead node ``n_seg``): the reference's
    ``line_static_shape``, host numpy around the port's catenary solve.

    Returns (r_nodes (n+1, 3), T_nodes (n+1,), grounded (n+1,) bool,
    s (n+1,) the unstretched arc coordinates)."""
    r_anchor = np.asarray(r_anchor, dtype=float)
    r_fair = np.asarray(r_fair, dtype=float)
    dv = r_fair - r_anchor
    XF = float(np.hypot(dv[0], dv[1]))
    ZF = float(dv[2])
    uh = dv[:2] / max(XF, 1e-9)

    t = [torch.tensor(float(x), dtype=torch.float64)
         for x in (XF, ZF, L, w_lin, EA)]
    HF, VF, _, _ = solve_catenary(*t, can_ground=can_ground)
    HF, VF = float(HF), float(VF)

    VA = VF - w_lin * L
    partly = can_ground and VF < w_lin * L
    LB = max(L - VF / w_lin, 0.0) if partly else 0.0
    if LB > 0:
        # the touchdown point is a node; most nodes go to the suspended
        # span (the grounded part is straight)
        n_g = max(2, n_seg // 6)
        n_s = n_seg - n_g
        s = np.concatenate([np.linspace(0.0, LB, n_g + 1)[:-1],
                            np.linspace(LB, L, n_s + 1)])
    else:
        s = np.linspace(0.0, L, n_seg + 1)
    grounded = s <= LB + 1e-9

    x = np.zeros_like(s)
    z = np.zeros_like(s)
    T = np.zeros_like(s)
    for i, si in enumerate(s):
        if partly:
            if si <= LB:
                x[i] = si * (1.0 + HF / EA)
                z[i] = 0.0
                T[i] = HF
            else:
                sp = si - LB
                V = w_lin * sp
                x[i] = (LB * (1.0 + HF / EA)
                        + (HF / w_lin) * np.arcsinh(V / HF) + HF * sp / EA)
                z[i] = ((HF / w_lin) * (np.sqrt(1 + (V / HF) ** 2) - 1.0)
                        + V ** 2 / (2 * EA * w_lin))
                T[i] = np.hypot(HF, V)
        else:
            V = VA + w_lin * si
            x[i] = ((HF / w_lin) * (np.arcsinh(V / HF) - np.arcsinh(VA / HF))
                    + HF * si / EA)
            z[i] = ((HF / w_lin) * (np.sqrt(1 + (V / HF) ** 2)
                                    - np.sqrt(1 + (VA / HF) ** 2))
                    + (VA * si + 0.5 * w_lin * si ** 2) / EA)
            T[i] = np.hypot(HF, V)

    r_nodes = np.zeros((n_seg + 1, 3))
    r_nodes[:, 0] = r_anchor[0] + x * uh[0]
    r_nodes[:, 1] = r_anchor[1] + x * uh[1]
    r_nodes[:, 2] = r_anchor[2] + z
    return r_nodes, T, grounded, s


def _assemble(r_nodes, T_nodes, L, EA, m_lin, d_vol, rho, Ca, CaAx, s_arc,
              BA):
    """The host half of :func:`line_dynamics`: segment and node
    geometry, the interior stiffness, damping and mass and their end
    couplings (numpy, in the reference's order of assembly)."""
    n = len(r_nodes) - 1
    n_int = n - 1
    if s_arc is None:
        l0 = np.full(n, L / n)
    else:
        l0 = np.diff(np.asarray(s_arc, dtype=float))
    l0 = np.maximum(l0, 1e-9)
    ds_node = np.zeros(n + 1)
    ds_node[:-1] += 0.5 * l0
    ds_node[1:] += 0.5 * l0

    seg_vec = r_nodes[1:] - r_nodes[:-1]
    l_seg = np.linalg.norm(seg_vec, axis=1)
    t_seg = seg_vec / np.maximum(l_seg, 1e-9)[:, None]
    T_seg = 0.5 * (T_nodes[1:] + T_nodes[:-1])
    A_c = np.pi / 4 * d_vol ** 2

    tt = np.einsum("si,sj->sij", t_seg, t_seg)
    I3 = np.eye(3)
    k_seg = ((EA / l0)[:, None, None] * tt
             + (T_seg / np.maximum(l_seg, 1e-9))[:, None, None] * (I3 - tt))
    # internal axial damping, MoorDyn's BA convention: BA >= 0 a
    # coefficient [N-s] (c = BA / l0), BA < 0 a ratio of each segment's
    # spring-mass critical damping
    if BA < 0:
        c_ax = -BA * 2.0 * np.sqrt((EA / l0) * (m_lin * l0))
    else:
        c_ax = np.full(n, BA) / l0
    c_seg = c_ax[:, None, None] * tt

    K = np.zeros((3 * n_int, 3 * n_int))
    K_A = np.zeros((3 * n_int, 3))
    K_B = np.zeros((3 * n_int, 3))
    C = np.zeros((3 * n_int, 3 * n_int))
    C_A = np.zeros((3 * n_int, 3))
    C_B = np.zeros((3 * n_int, 3))
    for si in range(n):
        iL, iR = si - 1, si
        for mat, matA, matB, k in ((K, K_A, K_B, k_seg[si]),
                                   (C, C_A, C_B, c_seg[si])):
            if 0 <= iL < n_int:
                mat[3 * iL:3 * iL + 3, 3 * iL:3 * iL + 3] += k
            if 0 <= iR < n_int:
                mat[3 * iR:3 * iR + 3, 3 * iR:3 * iR + 3] += k
            if 0 <= iL < n_int and 0 <= iR < n_int:
                mat[3 * iL:3 * iL + 3, 3 * iR:3 * iR + 3] -= k
                mat[3 * iR:3 * iR + 3, 3 * iL:3 * iL + 3] -= k
            if iL == -1 and 0 <= iR < n_int:
                matA[3 * iR:3 * iR + 3] -= k
            if iR == n - 1 and 0 <= iL < n_int:
                matB[3 * iL:3 * iL + 3] -= k

    t_node = np.zeros((n + 1, 3))
    t_node[0] = t_seg[0]
    t_node[-1] = t_seg[-1]
    t_node[1:-1] = t_seg[:-1] + t_seg[1:]
    t_node /= np.maximum(np.linalg.norm(t_node, axis=1), 1e-9)[:, None]
    ttn = np.einsum("ni,nj->nij", t_node, t_node)
    M_node = (m_lin * ds_node[:, None, None] * I3[None]
              + rho * A_c * ds_node[:, None, None]
              * (Ca * (I3[None] - ttn) + CaAx * ttn))
    M = np.zeros((3 * n_int, 3 * n_int))
    for i in range(n_int):
        M[3 * i:3 * i + 3, 3 * i:3 * i + 3] = M_node[i + 1]
    clamp = np.zeros(3 * n_int, dtype=bool)
    return dict(n=n, n_int=n_int, l0=l0, ds_node=ds_node, t_seg=t_seg,
                A_c=A_c, k_seg=k_seg, c_ax=c_ax, c_seg=c_seg, K=K, K_A=K_A,
                K_B=K_B, C=C, C_A=C_A, C_B=C_B, ttn=ttn, M_node=M_node, M=M,
                clamp=clamp)


def line_dynamics(r_nodes, T_nodes, grounded, L, EA, m_lin, d_vol,
                  w_arr, k_arr, zeta, beta, depth, rho=1025.0, g=9.81,
                  Cd=1.2, Ca=1.0, CdAx=0.05, CaAx=0.0,
                  RAO_A=None, RAO_B=None, n_drag_iter=5, s_arc=None,
                  BA=0.0, device=None):
    """Frequency-domain lumped-mass solve of one line (the reference's
    ``line_dynamics``).

    r_nodes, T_nodes, grounded, s_arc: the static discretisation of
    :func:`line_static_shape` (n + 1 nodes; ``s_arc`` None: uniform
    L / n).  zeta (nw,) complex wave amplitudes, beta the heading [rad];
    RAO_A, RAO_B (3, nw) complex end-motion amplitudes (None: fixed).
    The interior solves run on ``device`` (default: the current CUDA
    device; raises without one).

    Returns dict of tensors on the device: T_amp (n+1, nw) dynamic
    tension amplitudes, Z_fair (nw, 3, 3) the fairlead impedance with
    the interior condensed out, X (n-1, 3, nw) the interior motions."""
    dev = resolve_device(device)
    r_nodes = np.asarray(r_nodes, dtype=float)
    a = _assemble(r_nodes, np.asarray(T_nodes, dtype=float), L, EA, m_lin,
                  d_vol, rho, Ca, CaAx, s_arc, BA)
    n, n_int = a["n"], a["n_int"]
    nw = len(w_arr)
    for i in range(n_int):
        if grounded[i + 1]:
            a["clamp"][3 * i + 2] = True

    kw = dict(dtype=torch.float64, device=dev)
    w = torch.as_tensor(np.asarray(w_arr, dtype=float), **kw)
    zeta_t = torch.as_tensor(np.asarray(zeta))
    cdt = compute_dtypes(w, zeta_t)[1]
    zeta_t = zeta_t.to(dev).to(cdt)
    u, ud, _ = wv.wave_kinematics(
        zeta_t[None], torch.tensor([float(beta)], **kw), w,
        torch.as_tensor(np.asarray(k_arr, dtype=float), **kw)[None],
        torch.tensor([float(depth)], **kw),
        torch.as_tensor(r_nodes, **kw)[None],
        torch.tensor([float(rho)], **kw), torch.tensor([float(g)], **kw))
    u, ud = u[0], ud[0]                                   # (n+1, 3, nw)

    def end(X):
        return (torch.zeros((3, nw), dtype=cdt, device=dev) if X is None
                else torch.as_tensor(np.asarray(X)).to(dev).to(cdt))

    XA, XB = end(RAO_A), end(RAO_B)
    K, M, Cm, K_A, K_B, C_A, C_B = (torch.as_tensor(a[k], **kw) for k in (
        "K", "M", "C", "K_A", "K_B", "C_A", "C_B"))
    ttn_i = torch.as_tensor(a["ttn"][1:-1], **kw)
    I3 = torch.eye(3, **kw)
    idx = torch.as_tensor(a["clamp"], device=dev).to(torch.float64)
    eye = torch.eye(3 * n_int, **kw)
    ds_i = torch.as_tensor(a["ds_node"][1:-1], **kw)

    # Morison inertial excitation of the interior nodes
    ud_i = ud[1:-1]
    ud_t = torch.einsum("nij,njw->niw", ttn_i.to(cdt), ud_i)
    F_in = (rho * a["A_c"] * ds_i)[:, None, None] * (
        (1.0 + Ca) * (ud_i - ud_t) + (1.0 + CaAx) * ud_t)
    drag_c = 0.5 * rho * d_vol * ds_i
    iwc = 1j * w[:, None]

    def system(Bfull):
        D = (K[None] + 1j * w[:, None, None] * (Bfull + Cm)[None]
             - (w ** 2)[:, None, None] * M[None])
        D = D.to(cdt)
        D = D * (1 - idx[None, :, None]) * (1 - idx[None, None, :])
        return D + eye[None] * idx[None, :]

    def solve_with_B(Bn):
        Bfull = torch.block_diag(*Bn) if n_int else torch.zeros_like(K)
        F_drag = torch.einsum("nij,njw->niw", Bn.to(cdt), u[1:-1])
        F = (F_in + F_drag).permute(2, 0, 1).reshape(nw, 3 * n_int)
        F = (F - torch.einsum("ij,jw->wi", K_A.to(cdt), XA)
             - torch.einsum("ij,jw->wi", K_B.to(cdt), XB)
             - iwc * torch.einsum("ij,jw->wi", C_A.to(cdt), XA)
             - iwc * torch.einsum("ij,jw->wi", C_B.to(cdt), XB))
        F = F * (1 - idx[None, :])
        return torch.linalg.solve(system(Bfull), F[..., None])[..., 0]

    Bn = torch.zeros((n_int, 3, 3), **kw)
    X = solve_with_B(Bn)
    cfac = np.sqrt(8.0 / np.pi) * drag_c
    for _ in range(n_drag_iter):
        Xn = X.reshape(nw, n_int, 3).permute(1, 2, 0)
        v_node = 1j * w[None, None, :] * Xn
        vrel = u[1:-1] - v_node
        vt = torch.einsum("nij,njw->niw", ttn_i.to(cdt), vrel)
        vp = vrel - vt
        sig_p = torch.sqrt(0.5 * torch.sum(torch.abs(vp) ** 2, dim=(1, 2)))
        sig_t = torch.sqrt(0.5 * torch.sum(torch.abs(vt) ** 2, dim=(1, 2)))
        Bn = ((cfac * Cd * sig_p)[:, None, None] * (I3[None] - ttn_i)
              + (cfac * CdAx * sig_t)[:, None, None] * ttn_i)
        X = solve_with_B(Bn)

    # dynamic tensions: the axial stretch of each segment, with the
    # internal damping's share (T = EA strain + c_ax l0 strain rate)
    Xn = X.reshape(nw, n_int, 3).permute(1, 2, 0)
    X_all = torch.cat([XA[None], Xn, XB[None]], dim=0)
    dX = X_all[1:] - X_all[:-1]
    T_amp_seg = (torch.as_tensor(EA / a["l0"], **kw)[:, None]
                 + 1j * w[None, :] * torch.as_tensor(a["c_ax"], **kw)[:, None]
                 ) * torch.einsum("si,siw->sw",
                                  torch.as_tensor(a["t_seg"], **kw).to(cdt),
                                  dX)
    T_amp = torch.cat([T_amp_seg[:1], 0.5 * (T_amp_seg[1:] + T_amp_seg[:-1]),
                       T_amp_seg[-1:]], dim=0)

    # the fairlead impedance: force at end B per unit end-B motion with
    # the interior dynamically condensed out
    D = system(torch.block_diag(*Bn) if n_int else torch.zeros_like(K))
    KC_B = (K_B[None] + 1j * w[:, None, None] * C_B[None]) \
        * (1 - idx[None, :, None])
    K_bb = torch.as_tensor(a["k_seg"][-1], **kw)
    C_bb = torch.as_tensor(a["c_seg"][-1], **kw)
    M_bb = torch.as_tensor(a["M_node"][-1], **kw) * 0.5
    Dinv_KB = torch.linalg.solve(D, KC_B.to(cdt))
    Z_fair = (K_bb[None] + 1j * w[:, None, None] * C_bb[None]
              - (w ** 2)[:, None, None] * M_bb[None]
              - torch.einsum("wij,wjk->wik", KC_B.transpose(1, 2).to(cdt),
                             Dinv_KB))
    return dict(T_amp=T_amp, Z_fair=Z_fair, X=Xn)


def _line_kw(ms, il):
    """The line-dynamics properties of line ``il`` of ``ms``."""
    return dict(Cd=float(ms.Cd[il]), Ca=float(ms.Ca[il]),
                CdAx=float(ms.CdAx[il]), CaAx=float(ms.CaAx[il]),
                BA=float(ms.BA[il]) if ms.BA is not None else 0.0)


def fowt_line_tension_amps(ms, r6, Xi_PRP, w_arr, k_arr, S, beta, depth,
                           rho=1025.0, g=9.81, n_seg=24, device=None):
    """Dynamic end-tension amplitudes of every line of a FOWT's catenary
    system under the platform motion Xi_PRP (6, nw) of one excitation
    source (the ``moorMod`` 1 tensions; the reference's
    ``fowt_line_tension_amps``): each line's fairlead follows the
    platform RAO, its anchor stays.  r6 (6,) the mean pose, S (nw,) the
    wave spectrum, beta its heading [rad].  Returns (2 nL, nw) complex
    numpy: [end A of every line, end B of every line]."""
    w_np = np.asarray(w_arr, dtype=float)
    nw = len(w_np)
    nL = ms.n_lines
    dw = w_np[1] - w_np[0]
    zeta = np.sqrt(2 * np.asarray(S) * dw).astype(np.complex128)
    out = np.zeros((2 * nL, nw), dtype=np.complex128)
    r6 = np.asarray(r6, dtype=float)
    R = _np_rotation(r6)
    Xi = np.asarray(Xi_PRP)
    for il in range(nL):
        r_fair = r6[:3] + R @ np.asarray(ms.r_fair0[il])
        lever = r_fair - r6[:3]
        # fairlead motion: translation plus rotation x lever
        dr = Xi[:3] + np.stack([
            Xi[4] * lever[2] - Xi[5] * lever[1],
            Xi[5] * lever[0] - Xi[3] * lever[2],
            Xi[3] * lever[1] - Xi[4] * lever[0]])
        r_nodes, T_nodes, grounded, s_arc = line_static_shape(
            ms.r_anchor[il], r_fair, float(ms.L[il]), float(ms.w[il]),
            float(ms.EA[il]), n_seg=n_seg)
        res = line_dynamics(
            r_nodes, T_nodes, grounded, float(ms.L[il]), float(ms.EA[il]),
            float(ms.m_lin[il]), float(ms.d_vol[il]), w_np,
            np.asarray(k_arr), zeta, float(beta), depth, rho=rho, g=g,
            RAO_A=None, RAO_B=dr, s_arc=s_arc, device=device,
            **_line_kw(ms, il))
        T_amp = res["T_amp"].cpu().numpy()
        out[il] = T_amp[0]
        out[il + nL] = T_amp[-1]
    return out


def fowt_mooring_impedance(ms, r6, w_arr, k_arr, S, beta, depth,
                           rho=1025.0, g=9.81, n_seg=24, device=None):
    """The frequency-dependent 6 x 6 mooring impedance about the platform
    reference (``moorMod`` 2, in place of the quasi-static stiffness;
    the reference's ``fowt_mooring_impedance``): each line's condensed
    fairlead impedance translated to the platform as a mass matrix is.
    Returns (nw, 6, 6) complex on ``device``."""
    dev = resolve_device(device)
    w_np = np.asarray(w_arr, dtype=float)
    nw = len(w_np)
    dw = w_np[1] - w_np[0]
    zeta = np.sqrt(2 * np.asarray(S) * dw).astype(np.complex128)
    r6 = np.asarray(r6, dtype=float)
    R = _np_rotation(r6)
    Z = torch.zeros((nw, 6, 6), dtype=compute_dtypes()[1], device=dev)
    for il in range(ms.n_lines):
        r_fair = r6[:3] + R @ np.asarray(ms.r_fair0[il])
        r_nodes, T_nodes, grounded, s_arc = line_static_shape(
            ms.r_anchor[il], r_fair, float(ms.L[il]), float(ms.w[il]),
            float(ms.EA[il]), n_seg=n_seg)
        res = line_dynamics(
            r_nodes, T_nodes, grounded, float(ms.L[il]), float(ms.EA[il]),
            float(ms.m_lin[il]), float(ms.d_vol[il]), w_np,
            np.asarray(k_arr), zeta, float(beta), depth, rho=rho, g=g,
            s_arc=s_arc, device=dev, **_line_kw(ms, il))
        Zf = res["Z_fair"]
        H = tf.skew(torch.as_tensor(r_fair - r6[:3], dtype=torch.float64,
                                    device=dev)).to(Zf.dtype)
        Ht = H.T
        Z[:, :3, :3] += Zf
        Z[:, :3, 3:] += Zf @ H
        Z[:, 3:, :3] += torch.einsum("ij,wjk->wik", Ht, Zf)
        Z[:, 3:, 3:] += torch.einsum("ij,wjk,kl->wil", Ht, Zf, H)
    return Z
