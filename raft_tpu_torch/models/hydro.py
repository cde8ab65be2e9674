"""Per-FOWT Morison hydro build (counterpart of the build half of
``raft_tpu/models/hydro.py``): the flattened strips and the hydro
constants at the zero pose.

The constants are host work, as in the reference (which pins them to
the CPU): :func:`raft_tpu_torch.physics.morison.hydro_constants` on one
row of float64 tensors on the CPU, returned as numpy.  A single rigid
body takes its closed-form rigid kinematics; any other structure the
node positions and T of :meth:`~raft_tpu_torch.structure.topology.
Topology.self_consistent_displacements` at the zero pose (the
reference positions and the build-time T).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.physics import morison
from raft_tpu_torch.physics.statics import node_T, platform_kinematics

_CPU = torch.device("cpu")


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
