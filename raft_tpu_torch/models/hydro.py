"""Per-FOWT Morison hydro (counterpart of ``raft_tpu/models/hydro.py``):
the build half (the flattened strips and the hydro constants at the
zero pose) and the per-case half of the orchestrated path (the sea
state of a case, the pose at a mean offset, the wave and drag
excitation there and the current loads).

The constants are host work, as in the reference (which pins them to
the CPU): :func:`raft_tpu_torch.physics.morison.hydro_constants` on one
row of float64 tensors on the CPU, returned as numpy.  A single rigid
body takes its closed-form rigid kinematics; any other structure the
node positions and T of :meth:`~raft_tpu_torch.structure.topology.
Topology.self_consistent_displacements` at the zero pose (the
reference positions and the build-time T).

The per-case half keeps no case on the object: :meth:`FOWTHydro.pose`
returns a :class:`Pose` for a mean offset, and the excitation, drag and
current functions take the pose and the case and return what the
reference's object would have stored (S, zeta, beta, the strip wave
velocities ``u``).  They run as one row of :mod:`raft_tpu_torch.physics.
morison`'s batched functions on the pose's device.
"""

from __future__ import annotations

import numpy as np
import torch

from dataclasses import dataclass

from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.physics import morison
from raft_tpu_torch.physics.statics import node_T, platform_kinematics
from raft_tpu_torch.structure.schema import coerce

_CPU = torch.device("cpu")


def make_sea_state(case, w):
    """(S, zeta, beta [rad]) of a case as numpy, (nWaves, nw) and
    (nWaves,): the reference's ``make_sea_state``, JONSWAP (gamma 0 the
    IEC default), ``unit``, ``constant`` (S = the height), ``none`` /
    ``still``; zeta = sqrt(2 S dw)."""
    w = np.asarray(w, dtype=float)
    dw = w[1] - w[0]
    nWaves = (1 if np.isscalar(case["wave_heading"])
              else len(case["wave_heading"]))
    heading = coerce(case, "wave_heading", shape=nWaves, default=0)
    spectrum = coerce(case, "wave_spectrum", shape=nWaves, dtype=str,
                      default="JONSWAP")
    period = coerce(case, "wave_period", shape=nWaves)
    height = coerce(case, "wave_height", shape=nWaves)
    gamma = coerce(case, "wave_gamma", shape=nWaves, default=0)
    S = np.zeros((nWaves, len(w)))
    zeta = np.zeros((nWaves, len(w)))
    for ih in range(nWaves):
        if spectrum[ih] == "unit":
            S[ih] = 1.0
        elif spectrum[ih] == "constant":
            S[ih] = height[ih]
        elif spectrum[ih] == "JONSWAP":
            t = [torch.tensor(float(x), dtype=torch.float64)
                 for x in (height[ih], period[ih], gamma[ih])]
            S[ih] = wv.jonswap(torch.as_tensor(w), t[0], t[1],
                               gamma=t[2]).numpy()
        elif spectrum[ih] in ("none", "still"):
            continue
        else:
            raise ValueError(f"unknown wave spectrum {spectrum[ih]!r}")
        zeta[ih] = np.sqrt(2 * S[ih] * dw)
    return S, zeta, np.deg2rad(heading)


@dataclass
class Pose:
    """One FOWT at a mean offset X0 (the per-case state the reference's
    ``set_position`` stores on its hydro object), one row on the
    device: node positions r_nodes (1, N, 3), the node reduction Tn
    (1, N, 6, n) and ``hc``, the zero-pose hydro constants with the
    strip frames r, q, p1, p2 and the sub / active masks at the pose."""

    X0: np.ndarray
    r_nodes: torch.Tensor
    Tn: torch.Tensor
    hc: dict


def add_rotor_added_mass(A, fs, Tn):
    """Add the blade added mass of submerged (MHK) rotors about their
    nodes: A (..., nDOF, nDOF), Tn (..., N, 6, nDOF) the node reduction
    rows; both numpy (the builder) or both tensors (per row, the
    geometry axis)."""
    for ir, rot in enumerate(fs.rotors):
        if rot.hydro is not None:
            Tn_n = Tn[..., int(fs.rotor_node[ir]), :, :]
            if isinstance(A, torch.Tensor):
                Ar = torch.as_tensor(np.asarray(rot.hydro["A_hydro"]),
                                     dtype=A.dtype, device=A.device)
                A = A + Tn_n.transpose(-1, -2) @ Ar @ Tn_n
            else:
                Tn_n = np.asarray(Tn_n)
                A = A + np.swapaxes(Tn_n, -1, -2) @ np.asarray(
                    rot.hydro["A_hydro"]) @ Tn_n
    return A


def site_rows(fs, device, rows=1):
    """The FOWT's site scalars as (rows,) float64 tensors on ``device``."""
    def col(x):
        return torch.full((rows,), float(x), dtype=torch.float64,
                          device=device)

    return morison.SiteRows(rho_water=col(fs.rho_water), depth=col(fs.depth),
                            g=col(fs.g), n_nodes=fs.n_nodes)


class FOWTHydro:
    """Strips of one FOWT plus its hydro constants ``hc0`` (numpy) at the
    zero pose: ``A_hydro`` (6, 6), ``Imat`` (S, 3, 3, nw) complex,
    ``Amat``, ``a_i`` and the strip frames."""

    def __init__(self, fs, w, k):
        self.fs = fs
        self.w = np.asarray(w)
        self.k = np.asarray(k)
        self.nw = len(self.w)
        self.strips = morison.build_strips(fs, k_array=self.k)
        f64 = dict(dtype=torch.float64, device=_CPU)
        if fs.is_single_body:
            r_nodes, R_ptfm, r_root = platform_kinematics(
                torch.as_tensor(fs.node_r0, **f64)[None],
                torch.tensor([fs.root_id]), torch.zeros((1, fs.nDOF), **f64))
            Tn = node_T(r_nodes, r_root)
        else:
            disp, T = fs.topology.self_consistent_displacements(
                fs.T, fs.reducedDOF, fs.root_id, np.zeros(fs.nDOF))
            r_nodes = torch.as_tensor(fs.node_r0 + disp[:, :3], **f64)[None]
            R_ptfm = torch.eye(3, **f64)[None]
            Tn = torch.as_tensor(T.reshape(fs.n_nodes, 6, fs.nDOF),
                                 **f64)[None]
        hc = morison.hydro_constants(
            site_rows(fs, _CPU), morison.strips_to_rows(self.strips, _CPU),
            R_ptfm, r_nodes, Tn)
        self.hc0 = {k2: v[0].numpy() for k2, v in hc.items()}
        self.hc0["A_hydro"] = add_rotor_added_mass(self.hc0["A_hydro"], fs,
                                                   Tn[0].numpy())
        self._device_rows = {}

    def _on(self, device):
        """The strips, site scalars and zero-pose constants as one row of
        tensors on ``device`` (made once per device)."""
        cache = self._device_rows
        key = str(device)
        if key not in cache:
            fs = self.fs
            kw = dict(dtype=torch.float64, device=device)
            hc0 = {k: torch.as_tensor(np.asarray(self.hc0[k])).to(device)[None]
                   for k in ("A_hydro", "Amat", "Imat", "a_i")}
            cache[key] = dict(
                ss=morison.strips_to_rows(self.strips, device),
                site=site_rows(fs, device), hc0=hc0,
                node_r0=torch.as_tensor(fs.node_r0, **kw)[None],
                root=torch.tensor([fs.root_id], device=device),
                w=torch.as_tensor(self.w, **kw),
                k=torch.as_tensor(self.k, **kw)[None])
        return cache[key]

    def pose(self, X0, device):
        """The :class:`Pose` at mean offset X0 (nDOF,): the exact rigid
        kinematics of a single rigid body; for any other structure the
        node positions, rotations and T of :meth:`~raft_tpu_torch.
        structure.topology.Topology.self_consistent_displacements` on the
        host, each member rotating with its first node."""
        fs = self.fs
        d = self._on(device)
        X0 = np.asarray(X0, dtype=float)
        kw = dict(dtype=torch.float64, device=device)
        node_rot = None
        if fs.is_single_body:
            r_nodes, R_ptfm, r_root = platform_kinematics(
                d["node_r0"], d["root"], torch.as_tensor(X0, **kw)[None])
            Tn = node_T(r_nodes, r_root)
        else:
            disp, T = fs.topology.self_consistent_displacements(
                fs.T, fs.reducedDOF, fs.root_id, X0)
            r_nodes = torch.as_tensor(fs.node_r0 + disp[:, :3], **kw)[None]
            Tn = torch.as_tensor(T.reshape(fs.n_nodes, 6, fs.nDOF),
                                 **kw)[None]
            node_rot = torch.as_tensor(disp[:, 3:], **kw)[None]
            R_ptfm = None
        ss = d["ss"]
        r, q, p1, p2 = morison.strip_frames(ss, R_ptfm, r_nodes,
                                            node_rot=node_rot)
        sub = r[..., 2] < 0
        hc = dict(d["hc0"], r=r, q=q, p1=p1, p2=p2, sub=sub,
                  active=sub & ss.active)
        return Pose(X0=X0, r_nodes=r_nodes, Tn=Tn, hc=hc)

    def hydro_excitation(self, pose, case):
        """The strip wave excitation of every heading of ``case`` at
        ``pose`` (the reference's ``hydro_excitation``), with the
        inertial excitation of submerged rotors from the wave
        acceleration at their hubs (their ``I_hydro`` is taken about the
        rotor node).  Returns dict(S, zeta, beta (numpy, per heading),
        F_hydro_iner (nWaves, nDOF, nw) complex and u, the strip wave
        velocities, a list of (1, S, 3, nw) per heading)."""
        fs = self.fs
        d = self._on(pose.r_nodes.device)
        S, zeta, beta = make_sea_state(case, self.w)
        cdt = torch.complex128
        dev = pose.r_nodes.device
        F, u = [], []
        for ih in range(len(beta)):
            z = torch.as_tensor(zeta[ih]).to(dev).to(cdt)[None]
            b = torch.tensor([float(beta[ih])], dtype=torch.float64,
                             device=dev)
            out = morison.hydro_excitation(d["site"], d["ss"], pose.hc, z, b,
                                           d["w"], d["k"], pose.Tn,
                                           pose.r_nodes)
            Fi = out["F_hydro_iner"][0]
            for ir, rot in enumerate(fs.rotors):
                if rot.hydro is None:
                    continue
                node = int(fs.rotor_node[ir])
                r_hub = (pose.r_nodes[0, node] + torch.as_tensor(
                    np.asarray(rot.q_rel, dtype=float) * rot.overhang,
                    dtype=torch.float64, device=dev))
                _, ud, _ = wv.wave_kinematics(
                    z, b, d["w"], d["k"], d["site"].depth, r_hub[None, None],
                    d["site"].rho_water, d["site"].g)
                ud = ud[0, 0]                                # (3, nw)
                I6 = torch.as_tensor(np.asarray(rot.hydro["I_hydro"]),
                                     dtype=torch.float64, device=dev).to(cdt)
                f6 = torch.cat([I6[:3, :3] @ ud, I6[3:, :3] @ ud])
                Fi = Fi + torch.einsum("ia,iw->aw", pose.Tn[0, node].to(cdt),
                                       f6)
            F.append(Fi)
            u.append(out["u"])
        return dict(S=S, zeta=zeta, beta=beta, F_hydro_iner=torch.stack(F),
                    u=u)

    def drag_excitation(self, pose, Bmat, u_ih):
        """The drag excitation (nDOF, nw) of one heading's strip wave
        velocities u_ih (1, S, 3, nw) through the linearised strip drag
        Bmat (1, S, 3, 3) at ``pose``."""
        d = self._on(pose.r_nodes.device)
        return morison.drag_excitation(d["site"], d["ss"], pose.hc, Bmat,
                                       u_ih, pose.Tn, pose.r_nodes)[0]

    def current_loads(self, case, device):
        """The mean current drag loads (nDOF,) numpy of ``case`` at the
        zero pose (the reference computes them after resetting the pose,
        so a case's current loads do not depend on earlier cases), the
        profile referenced to the hub depth of the last submerged
        rotor, if any."""
        fs = self.fs
        d = self._on(device)
        kw = dict(dtype=torch.float64, device=device)
        speed = coerce(case, "current_speed", shape=0, default=0.0)
        heading = coerce(case, "current_heading", shape=0, default=0)
        Zref = 0.0
        for rot in fs.rotors:
            if rot.Zhub < 0:
                Zref = rot.Zhub
        p0 = self.pose(np.zeros(fs.nDOF), device)
        F = morison.current_loads(
            d["site"], d["ss"], p0.hc, torch.tensor([float(speed)], **kw),
            torch.tensor([float(heading)], **kw), Zref, fs.shearExp_water,
            p0.Tn, p0.r_nodes)
        return F[0].cpu().numpy()
