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

The displaced-pose node kinematics of flexible and multibody structures
are not ported (ROADMAP A11): the port evaluates single rigid bodies,
whose displaced pose is the closed-form rigid motion of
:func:`raft_tpu_torch.physics.statics.platform_kinematics`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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

    # ---------------------------------------------------------- build
    def add_node(self, r0, kind, owner=-1, end_node=True):
        n = TopoNode(id=len(self.nodes), r0=np.array(r0, dtype=float), kind=kind,
                     owner=owner, end_node=end_node)
        self.nodes.append(n)
        return n

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

        links_by_node: dict[int, list[int]] = {}
        for a, b in self._links:
            links_by_node.setdefault(a, []).append(b)
            links_by_node.setdefault(b, []).append(a)

        joint_groups: dict[int, list[int]] = {}
        for n in nodes:
            if n.joint_id is not None:
                joint_groups.setdefault(n.joint_id, []).append(n.id)

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

        root.reducedDOF = [[root.id, i] for i in range(6)]
        root.T_aux = np.eye(6)
        root.parent = root.id
        visited = {root.id}
        queue = [root]
        while queue:
            node = queue.pop(0)
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
