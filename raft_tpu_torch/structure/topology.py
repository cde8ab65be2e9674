"""Build-time structural topology: joints, rigid links, DOF reduction
(numpy; counterpart of ``raft_tpu/structure/topology.py``).

The FOWT is a graph of 6-DOF nodes (one per rigid member, rotor, or
joint anchor) connected by joints (cantilever / ball / universal) and
rigid links.  A breadth-first traversal assigns each node a set of
*reduced* DOFs and a linear map ``T_aux`` from those reduced DOFs to the
node's 6 DOFs; stacking gives the structure transformation matrix
``T (nFullDOF x nDOF)`` with ``fullDOF = T @ reducedDOF`` (the reference
RAFT's ``raft_fowt.py`` ``addJoint`` :439, ``attachMemberToJoint`` :477,
``reduceDOF`` :553 and ``raft_node.py`` ``attachToNode`` :79-159, with a
single anchor node per offset joint in place of its two dummy nodes).

A flexible (beam) member is a chain of nodes, one per strip
(:meth:`Topology.add_chain`): its end nodes attach through joints, its
internal nodes own their six DOFs.  :meth:`Topology.displacements` and
:meth:`Topology.self_consistent_displacements` give the nonlinear mean
node displacements of such structures (the reference's
``setNodesPosition``, ``raft_fowt.py:669-780``); T depends on the
current node positions through the rigid-link offsets, so it is rebuilt
at the displaced pose.  :mod:`raft_tpu_torch.structure.topology_traced`
records both traversals once and replays them in torch over rows.
Single rigid bodies take the closed-form rigid motion of
:func:`raft_tpu_torch.physics.statics.platform_kinematics` instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _rotmat(th):
    """Intrinsic z-y-x rotation matrix of the rotation vector th (3,),
    numpy, by the evaluators' own :func:`~raft_tpu_torch.ops.transforms.
    rotation_matrix`."""
    import torch

    from raft_tpu_torch.ops.transforms import rotation_matrix

    t = torch.as_tensor(np.asarray(th, dtype=float))
    return rotation_matrix(t[0], t[1], t[2]).numpy()


def _getH(r):
    return np.array(
        [[0.0, r[2], -r[1]], [-r[2], 0.0, r[0]], [r[1], -r[0], 0.0]]
    )


@dataclass
class TopoNode:
    id: int
    r0: np.ndarray                 # reference position wrt PRP (3,)
    kind: str                      # 'member' | 'rotor' | 'anchor'
    owner: int = -1                # member or rotor index
    end_node: bool = True          # False for internal beam nodes
    joint_id: int | None = None
    joint_type: str | None = None
    rigid_partner: int | None = None   # node id connected by a rigid link
    # traversal state
    reducedDOF: list = field(default_factory=list)
    T_aux: np.ndarray | None = None
    parent: int | None = None


class Topology:
    """Node graph + DOF reduction for one FOWT."""

    def __init__(self):
        self.nodes: list[TopoNode] = []
        self.joints: list[dict] = []
        self._links: list[tuple[int, int]] = []
        self._chains: list[list[int]] = []  # beam member node chains

    # ---------------------------------------------------------- build
    def add_node(self, r0, kind, owner=-1, end_node=True):
        n = TopoNode(id=len(self.nodes), r0=np.array(r0, dtype=float), kind=kind,
                     owner=owner, end_node=end_node)
        self.nodes.append(n)
        return n

    def add_chain(self, node_ids):
        """Register a flexible member's node chain: internal nodes own
        their DOFs; traversal reaches them through the chain (the BFS
        beam handling of raft_fowt.py:601-605)."""
        self._chains.append(list(node_ids))

    def add_joint(self, r, jtype, name, tol=1e-3):
        """Create (or reuse, by name+position) a joint; raft_fowt.py:439-475."""
        r = np.asarray(r, dtype=float)
        for j in self.joints:
            if j["name"] == name and np.linalg.norm(j["r"] - r) <= tol:
                return j
        j = {"id": len(self.joints), "r": r.copy(), "type": jtype, "name": name}
        self.joints.append(j)
        return j

    def attach_node_to_joint(self, node: TopoNode, joint, tol=1e-3):
        """raft_fowt.py:477-551 with the single-anchor simplification."""
        dist = np.linalg.norm(node.r0 - joint["r"])
        if dist <= tol:
            node.joint_id = joint["id"]
            node.joint_type = joint["type"]
            return
        # offset attachment: anchor node at the joint + rigid link
        anchor = None
        for n in self.nodes:
            if n.kind == "anchor" and n.joint_id == joint["id"]:
                anchor = n
                break
        if anchor is None:
            anchor = self.add_node(joint["r"], "anchor")
            anchor.joint_id = joint["id"]
            anchor.joint_type = joint["type"]
        # a rigid link can only pair two nodes; chain through the member
        # node (a node may carry several links in general — keep a list)
        self._links.append((anchor.id, node.id))

    # ------------------------------------------------------- traversal
    def _links_by_node(self):
        out: dict[int, list[int]] = {}
        for a, b in self._links:
            out.setdefault(a, []).append(b)
            out.setdefault(b, []).append(a)
        return out

    def _joint_groups(self):
        out: dict[int, list[int]] = {}
        for n in self.nodes:
            if n.joint_id is not None:
                out.setdefault(n.joint_id, []).append(n.id)
        return out

    def _chains_by_node(self):
        return {nid: chain for chain in self._chains for nid in chain}

    def reduce(self, positions=None):
        """Assign reduced DOFs via BFS from the root node and build T.

        positions: optional (n_nodes, 3) current node positions (defaults
        to reference positions) — T depends on them through the rigid
        link offsets (raft_node.py:113-118).

        Returns (T, reducedDOF, root_id).
        """
        nodes = self.nodes
        r = (
            np.array([n.r0 for n in nodes])
            if positions is None
            else np.asarray(positions, dtype=float)
        )

        for n in nodes:
            n.reducedDOF = None
            n.T_aux = None
            n.parent = None

        # root: node closest to the origin (raft_fowt.py:315-318)
        root = min(nodes, key=lambda n: np.linalg.norm(n.r0))

        links_by_node, joint_groups = self._links_by_node(), self._joint_groups()

        def attach(child: TopoNode, parent: TopoNode, rigid_link: bool):
            """raft_node.py:79-159 (open-tree branches)."""
            assert child.end_node, "only end nodes attach via joints/links"
            dofs = [list(d) for d in parent.reducedDOF]
            T2 = parent.T_aux.copy()
            jt = "rigid_link" if rigid_link else child.joint_type
            if jt == "rigid_link":
                rot = parent.T_aux[3:6, :]
                T2 = T2.copy()
                T2[:3, :] = T2[:3, :] + _getH(r[child.id] - r[parent.id]) @ rot
            elif jt in ("ball", "universal"):
                T2 = np.hstack([T2, np.zeros((6, 3))])
                T2[3:6, :] = 0.0
                for idof in range(3, 6):
                    dofs.append([child.id, idof])
                    T2[idof, len(dofs) - 1] = 1.0
                keep = [i for i in range(T2.shape[1]) if np.any(T2[:, i] != 0)]
                T2 = T2[:, keep]
                dofs = [dofs[i] for i in keep]
            elif jt == "cantilever":
                pass
            else:
                raise ValueError(f"joint type {jt!r} not supported")
            order = sorted(range(len(dofs)), key=lambda i: (dofs[i][0], dofs[i][1]))
            child.reducedDOF = [dofs[i] for i in order]
            child.T_aux = T2[:, order]
            child.parent = parent.id

        chains_by_node = self._chains_by_node()

        root.reducedDOF = [[root.id, i] for i in range(6)]
        root.T_aux = np.eye(6)
        root.parent = root.id
        visited = {root.id}
        queue = [root]
        while queue:
            node = queue.pop(0)
            # unattached nodes reached through a beam chain get their own
            # identity DOFs (raft_fowt.py:577-584)
            if node.reducedDOF is None:
                node.reducedDOF = [[node.id, i] for i in range(6)]
                node.T_aux = np.eye(6)
                node.parent = node.id
            for pid in links_by_node.get(node.id, []):
                p = nodes[pid]
                if p.id not in visited:
                    attach(p, node, rigid_link=True)
                    visited.add(p.id)
                    queue.append(p)
            if node.joint_id is not None:
                for nid in joint_groups.get(node.joint_id, []):
                    nn = nodes[nid]
                    if nn.id not in visited:
                        attach(nn, node, rigid_link=False)
                        visited.add(nn.id)
                        queue.append(nn)
            # traverse beam chains from their end nodes
            if node.end_node and node.id in chains_by_node:
                for nid in chains_by_node[node.id]:
                    if nid not in visited:
                        visited.add(nid)
                        queue.append(nodes[nid])

        if len(visited) != len(nodes):
            missing = [n.id for n in nodes if n.id not in visited]
            raise RuntimeError(f"structure not fully connected; unreached nodes {missing}")

        # collect unique DOFs with the root node first (the reference
        # moves the rigid-body node to the front of nodeList,
        # raft_fowt.py:321-328)
        reducedDOF = []
        for n in [root] + [x for x in nodes if x.id != root.id]:
            for d in n.reducedDOF:
                if d not in reducedDOF:
                    reducedDOF.append(d)

        nDOF = len(reducedDOF)
        T = np.zeros((6 * len(nodes), nDOF))
        for n in nodes:
            for jcol, d in enumerate(n.reducedDOF):
                T[6 * n.id : 6 * n.id + 6, reducedDOF.index(d)] = n.T_aux[:, jcol]
        return T, reducedDOF, root.id

    def displacements(self, T, reducedDOF, root_id, Xi0):
        """Nonlinear mean node displacements (n_nodes, 6) for reduced
        displacements Xi0 — the setNodesPosition nonlinear path
        (raft_fowt.py:669-752): rigid links rotate exactly
        ((R(theta) - I) d), ball joints keep their own linear rotation,
        beam chains get linear displacements plus the end-node's
        nonlinear-minus-linear correction.  Preserves rigid link lengths
        at large mean rotations (the displaced-pose statics of
        flexible/multibody structures need this).

        NOTE the linear map ``T`` is an input: the reference evaluates
        setDisplacementLinear with each node's *current* T (recomputed
        by reduceDOF at the latest node positions), so at a converged
        mean pose the kinematics satisfy the self-consistency
        T* = reduce(positions(T*, Xi0)) — see
        :func:`self_consistent_displacements`."""
        Xi0 = np.asarray(Xi0, dtype=float)
        nodes = self.nodes
        n = len(nodes)
        lin = (np.asarray(T) @ Xi0).reshape(n, 6)
        disp = np.full((n, 6), np.nan)

        links_by_node, joint_groups = self._links_by_node(), self._joint_groups()
        chains_by_node = self._chains_by_node()

        root = nodes[root_id]
        disp[root.id] = lin[root.id]
        visited = {root.id}
        queue = [root]
        while queue:
            node = queue.pop(0)
            # rigid-link partners: exact rotation of the offset
            for pid in links_by_node.get(node.id, []):
                p = nodes[pid]
                if p.id in visited:
                    continue
                d = p.r0 - node.r0
                R = _rotmat(lin[node.id][3:])
                disp[p.id] = disp[node.id].copy()
                disp[p.id][:3] += (R - np.eye(3)) @ d
                visited.add(p.id)
                queue.append(p)
            # joint-connected nodes: same translation; ball/universal
            # joints keep their own (linear) rotation
            if node.joint_id is not None:
                for nid in joint_groups.get(node.joint_id, []):
                    nn = nodes[nid]
                    if nn.id in visited:
                        continue
                    disp[nn.id] = disp[node.id].copy()
                    # the reference overrides the rotation only for ball
                    # joints (raft_fowt.py:731-733)
                    if nn.joint_type == "ball":
                        disp[nn.id][3:] = lin[nn.id][3:]
                    visited.add(nn.id)
                    queue.append(nn)
            # beam chains: linear + the end node's nonlinear correction
            if node.end_node and node.id in chains_by_node:
                dR = disp[node.id] - lin[node.id]
                for nid in chains_by_node[node.id]:
                    if nid in visited:
                        continue
                    disp[nid] = lin[nid] + dR
                    visited.add(nid)
                    queue.append(nodes[nid])
        # any unreached node (shouldn't happen on a connected structure)
        # falls back to the linear map
        missing = np.isnan(disp[:, 0])
        disp[missing] = lin[missing]
        return disp

    def self_consistent_displacements(self, T0, reducedDOF, root_id, Xi0,
                                      n_iter=1, atol=1e-13):
        """Displacements + T of the displaced pose with ``n_iter`` lag
        updates of the node-displacement map.

        The reference's solveStatics calls setPosition at every solver
        evaluation; each call computes node displacements with the T of
        the *previous* reduceDOF and then recomputes T at the new
        positions (raft_fowt.py:753-780).  Its published equilibria
        correspond to ONE applied Newton step (the loose 0.05 m /
        0.005 rad dsolve tolerances discard the second), so the final
        node positions are computed with the reference-pose T and the
        final T is rebuilt once at those positions — ``n_iter=1``, the
        default, replicates that (validated against the flexible
        analyzeCases golden; the high-frequency excitation-phase band is
        ~100x closer than the full fixed point).  ``n_iter>=2`` iterates
        toward the self-consistent fixed point
        T* = reduce(positions(T*, Xi0)) instead — the path-independent
        choice if matching the reference's solver-path artifact is not
        required.

        Returns (disp (n_nodes, 6), T (nFull, nDOF)).
        """
        Xi0 = np.asarray(Xi0, dtype=float)
        r0 = np.array([n.r0 for n in self.nodes])
        T_cur = np.asarray(T0)
        disp = None
        mutated = False
        try:
            for _ in range(max(1, int(n_iter))):
                disp = self.displacements(T_cur, reducedDOF, root_id, Xi0)
                if not np.any(disp):
                    break
                T_new, _, _ = self.reduce(positions=r0 + disp[:, :3])
                mutated = True
                dT = np.max(np.abs(T_new - T_cur))
                T_cur = T_new
                if dT <= atol:
                    break
        finally:
            if mutated:
                self.reduce()  # restore reference-pose traversal state
        return disp, T_cur

    def reduce_with_derivative(self):
        """T at the reference pose plus dT/d(reduced rotation dofs).

        Mirrors computeDerivativeTransformationMatrix
        (raft_fowt.py:640-667): perturb each rotational reduced DOF by a
        unit *linear* displacement (node shift = T-row), rebuild T from
        the shifted positions, subtract.  T is linear in node positions
        so this equals the analytic derivative.
        """
        T, reducedDOF, root_id = self.reduce()
        n_nodes = len(self.nodes)
        nDOF = len(reducedDOF)
        r0 = np.array([n.r0 for n in self.nodes])
        dT = np.zeros((6 * n_nodes, nDOF, nDOF))
        for i, dof in enumerate(reducedDOF):
            if dof[1] > 2 and self.nodes[dof[0]].end_node:
                disp = T[:, i].reshape(n_nodes, 6)[:, :3]
                Ti, _, _ = self.reduce(positions=r0 + disp)
                dT[:, :, i] = Ti - T
        # restore reference-pose traversal state
        self.reduce()
        return T, dT, reducedDOF, root_id
