"""Batched torch replay of the topology kinematics of flexible and
multibody FOWTs (counterpart of ``raft_tpu/structure/topology_traced.py``).

The numpy :class:`~raft_tpu_torch.structure.topology.Topology` computes

* ``displacements``: the nonlinear mean node displacements (rigid links
  rotate exactly, ball joints keep their own linear rotation, beam
  chains get the end node's nonlinear-minus-linear correction; the
  reference's setNodesPosition, raft_fowt.py:669-752), and
* ``reduce(positions)``: the transformation matrix T, whose rigid-link
  blocks depend on the current node positions (reduceDOF/attachToNode,
  raft_fowt.py:553-624, raft_node.py:79-159),

by breadth-first traversals whose structure (visit order, joint types,
column bookkeeping) is fixed when the model is built.
:class:`TracedTopology` records both traversals once into schedules and
replays them with torch values, batched over rows: ``Xi0 (R, n)`` ->
``r_nodes (R, N, 3)``, ``node_rot (R, N, 3)``, ``Tn (R, N, 6, n)``.  T
is assembled with one indexed write per group of nodes that share a
column count.  The builder holds the replay against the numpy path at
1e-12 before returning.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf


class TracedTopology:
    """Schedules of one FOWT's topology and their batched replays."""

    def __init__(self, fs):
        topo = fs.topology
        self.n_nodes = len(topo.nodes)
        self.nDOF = fs.nDOF
        self.root_id = fs.root_id
        self.T0 = np.asarray(fs.T)
        self.node_r0 = np.asarray(fs.node_r0)
        self._build_disp_schedule(topo)
        self._build_reduce_schedule(topo)
        self._cache = {}
        self._validate(topo, fs)

    # ------------------------------------------------ displacement map
    def _build_disp_schedule(self, topo):
        """Replay Topology.displacements' BFS, recording the op list."""
        nodes = topo.nodes
        links_by_node, joint_groups = topo._links_by_node(), topo._joint_groups()
        chains_by_node = topo._chains_by_node()

        sched = []
        root = nodes[self.root_id]
        visited = {root.id}
        queue = [root]
        while queue:
            node = queue.pop(0)
            for pid in links_by_node.get(node.id, []):
                p = nodes[pid]
                if p.id in visited:
                    continue
                sched.append(("rigid", p.id, node.id,
                              np.asarray(p.r0 - node.r0)))
                visited.add(p.id)
                queue.append(p)
            if node.joint_id is not None:
                for nid in joint_groups.get(node.joint_id, []):
                    nn = nodes[nid]
                    if nn.id in visited:
                        continue
                    sched.append(("joint", nn.id, node.id,
                                  nn.joint_type == "ball"))
                    visited.add(nn.id)
                    queue.append(nn)
            if node.end_node and node.id in chains_by_node:
                chain_new = [nid for nid in chains_by_node[node.id]
                             if nid not in visited]
                if chain_new:
                    sched.append(("chain", tuple(chain_new), node.id, None))
                for nid in chain_new:
                    visited.add(nid)
                    queue.append(nodes[nid])
        self.disp_schedule = sched

    def _consts(self, device, dtype):
        """The replay's constant tensors on (device, dtype), made once."""
        key = (str(device), dtype)
        c = self._cache.get(key)
        if c is None:
            kw = dict(device=device, dtype=dtype)
            c = dict(T0t=torch.as_tensor(self.T0.T, **kw),
                     node_r0=torch.as_tensor(self.node_r0, **kw),
                     eye3=torch.eye(3, **kw),
                     aux={i: torch.as_tensor(a, **kw) for i, (kind, _, _, a)
                          in enumerate(self.disp_schedule)
                          if kind == "rigid"},
                     groups=[(torch.as_tensor(rows, device=device),
                              torch.as_tensor(cols, device=device), nids)
                             for rows, cols, nids in self.write_groups])
            self._cache[key] = c
        return c

    def displacements(self, Xi0):
        """Mean node displacements (R, N, 6) of reduced displacements Xi0
        (R, n), with the build-time T (the reference's one-step solver
        lag; see Topology.self_consistent_displacements)."""
        R = Xi0.shape[0]
        c = self._consts(Xi0.device, Xi0.dtype)
        lin = (Xi0 @ c["T0t"]).reshape(R, self.n_nodes, 6)
        disp = [None] * self.n_nodes
        disp[self.root_id] = lin[:, self.root_id]
        for i, (kind, child, parent, aux) in enumerate(self.disp_schedule):
            if kind == "rigid":
                th = lin[:, parent, 3:]
                Rm = tf.rotation_matrix(th[:, 0], th[:, 1], th[:, 2])
                dd = (Rm - c["eye3"]) @ c["aux"][i]
                disp[child] = torch.cat([disp[parent][:, :3] + dd,
                                         disp[parent][:, 3:]], dim=-1)
            elif kind == "joint":
                d = disp[parent]
                if aux:  # a ball joint keeps its own linear rotation
                    d = torch.cat([d[:, :3], lin[:, child, 3:]], dim=-1)
                disp[child] = d
            else:  # beam chain: linear + the end node's nonlinear correction
                block = lin[:, list(child)] + (disp[parent]
                                               - lin[:, parent])[:, None]
                for j, nid in enumerate(child):
                    disp[nid] = block[:, j]
        # unreached nodes fall back to the linear map
        disp = [lin[:, i] if d is None else d for i, d in enumerate(disp)]
        return torch.stack(disp, dim=1)

    # --------------------------------------------------- T(positions)
    def _build_reduce_schedule(self, topo):
        """Replay Topology.reduce at the reference pose, recording per
        node: parent, op kind, the child's column selection, and the
        node's global column indices; then group the nodes by column
        count for the assembly of T."""
        T_ref, reducedDOF, root_id = topo.reduce()
        assert root_id == self.root_id
        nodes = topo.nodes
        glob_col = {tuple(d): i for i, d in enumerate(reducedDOF)}
        self.node_cols = [
            np.asarray([glob_col[tuple(d)] for d in n.reducedDOF], dtype=int)
            for n in nodes
        ]

        links_by_node, joint_groups = topo._links_by_node(), topo._joint_groups()
        chains_by_node = topo._chains_by_node()

        sched = []
        visited = {root_id}
        queue = [nodes[root_id]]
        identity_nodes = {root_id}
        while queue:
            node = queue.pop(0)
            for pid in links_by_node.get(node.id, []):
                p = nodes[pid]
                if p.id in visited:
                    continue
                sched.append(self._attach_record(p, node, "rigid_link"))
                visited.add(p.id)
                queue.append(p)
            if node.joint_id is not None:
                for nid in joint_groups.get(node.joint_id, []):
                    nn = nodes[nid]
                    if nn.id in visited:
                        continue
                    sched.append(self._attach_record(nn, node, nn.joint_type))
                    visited.add(nn.id)
                    queue.append(nn)
            if node.end_node and node.id in chains_by_node:
                for nid in chains_by_node[node.id]:
                    if nid not in visited:
                        visited.add(nid)
                        identity_nodes.add(nid)
                        queue.append(nodes[nid])
        self.reduce_schedule = sched
        self.identity_nodes = sorted(identity_nodes)

        by_width = {}
        for nid in range(self.n_nodes):
            by_width.setdefault(len(self.node_cols[nid]), []).append(nid)
        self.write_groups = [
            (np.asarray([np.arange(6 * nid, 6 * nid + 6) for nid in nids]),
             np.asarray([self.node_cols[nid] for nid in nids]), nids)
            for nids in by_width.values()]

    @staticmethod
    def _attach_record(child, parent, jtype):
        """Static column bookkeeping of one attach (Topology.reduce)."""
        p_dofs = [tuple(d) for d in parent.reducedDOF]
        c_dofs = [tuple(d) for d in child.reducedDOF]
        if jtype in ("rigid_link", "cantilever"):
            # the same column set; the child's order is the (node, dof)
            # sort of the parent's columns
            perm = np.asarray([p_dofs.index(d) for d in c_dofs], dtype=int)
            return (jtype, child.id, parent.id, perm)
        if jtype in ("ball", "universal"):
            # columns: the kept subset of [parent cols..., 3 new rot cols]
            ext = p_dofs + [(child.id, i) for i in range(3, 6)]
            sel = np.asarray([ext.index(d) for d in c_dofs], dtype=int)
            return (jtype, child.id, parent.id, sel)
        raise ValueError(f"joint type {jtype!r} not supported")

    def reduce_T(self, positions):
        """T (R, 6 N, n) at node positions (R, N, 3)."""
        r = positions
        R = r.shape[0]
        kw = dict(device=r.device, dtype=r.dtype)
        c = self._consts(r.device, r.dtype)
        Taux = {nid: torch.eye(6, **kw).expand(R, 6, 6)
                for nid in self.identity_nodes}
        for kind, child, parent, sel in self.reduce_schedule:
            Tp = Taux[parent]
            if kind == "rigid_link":
                H = tf.skew(r[:, child] - r[:, parent])
                Tc = torch.cat([Tp[:, :3] + H @ Tp[:, 3:6], Tp[:, 3:6]],
                               dim=1)
                Taux[child] = Tc[:, :, sel]
            elif kind == "cantilever":
                Taux[child] = Tp[:, :, sel]
            else:  # ball/universal: rotations replaced by 3 new columns
                rot = torch.cat([torch.zeros((R, 3, 3), **kw),
                                 torch.eye(3, **kw).expand(R, 3, 3)], dim=1)
                ext = torch.cat([torch.cat([Tp[:, :3], torch.zeros_like(
                    Tp[:, 3:])], dim=1), rot], dim=2)
                Taux[child] = ext[:, :, sel]
        T = torch.zeros((R, 6 * self.n_nodes, self.nDOF), **kw)
        for rows, cols, nids in c["groups"]:
            vals = torch.stack([Taux[nid] for nid in nids], dim=1)
            T[:, rows[:, :, None], cols[:, None, :]] = vals
        return T

    # ------------------------------------------------------ validation
    def _validate(self, topo, fs, atol=1e-12):
        rng = np.random.default_rng(0)
        Xi0 = 1e-2 * rng.standard_normal(self.nDOF)
        disp_np = topo.displacements(fs.T, fs.reducedDOF, fs.root_id, Xi0)
        x = torch.as_tensor(Xi0, dtype=torch.float64)[None]
        disp_tr = self.displacements(x)[0].numpy()
        if not np.allclose(disp_tr, disp_np, rtol=0.0, atol=atol):
            raise RuntimeError("traced displacement map mismatch")
        r_np = self.node_r0 + disp_np[:, :3]
        T_np, _, _ = topo.reduce(positions=r_np)
        topo.reduce()  # restore the reference-pose traversal state
        T_tr = self.reduce_T(torch.as_tensor(r_np)[None])[0].numpy()
        if not np.allclose(T_tr, T_np, rtol=0.0, atol=atol):
            raise RuntimeError("traced reduce(T) mismatch")

    # --------------------------------------------------- kinematics map
    def kinematics(self, Xi0):
        """(r_nodes (R, N, 3), node_rot (R, N, 3), Tn (R, N, 6, n)) at the
        displaced poses Xi0 (R, n): displacements with the build-time T,
        T rebuilt once at the displaced positions (the reference's
        one-step lag)."""
        disp = self.displacements(Xi0)
        c = self._consts(Xi0.device, Xi0.dtype)
        r_nodes = c["node_r0"] + disp[..., :3]
        Tn = self.reduce_T(r_nodes).reshape(Xi0.shape[0], self.n_nodes, 6,
                                            self.nDOF)
        return r_nodes, disp[..., 3:], Tn
