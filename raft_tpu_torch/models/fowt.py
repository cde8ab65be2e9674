"""FOWT structure: build-time assembly of one floating unit (numpy;
counterpart of ``raft_tpu/models/fowt.py``).

Parses the platform/turbine sections of a design dict into
``MemberGeometry`` objects, rotor (RNA) properties, point inertias and
loads and the joint topology, as the reference RAFT ``FOWT.__init__``
(``raft_fowt.py`` :36-437, joints :439-551) does, minus all runtime
state: the object is immutable after construction.

A submerged rotor with blades gets its blades' hydro summary
(:func:`raft_tpu_torch.physics.aero.blade_hydro`) at build time.
Potential-flow members (``potMod``), first-order coefficient files
(``hydroPath`` with ``potFirstOrder: 1``) and external QTF files
(``potSecOrder: 2``) build; their coefficients are the model's
(:attr:`raft_tpu_torch.models.model.Model.bem_list`,
:attr:`~raft_tpu_torch.models.model.Model.qtf`), and the evaluators that
do not take them refuse them.  A flexible
(``type: beam``) member gets one node per strip, chained in the topology;
whether the structure reduces to one rigid 6-DOF body is
``is_single_body``, which picks the evaluator (the full and farm
evaluators refuse other structures, as the reference's do, and
:func:`raft_tpu_torch.api.make_flexible_evaluator` takes them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from raft_tpu_torch.structure.members import (MemberGeometry, _heading_rot,
                                              build_member)
from raft_tpu_torch.structure.schema import coerce
from raft_tpu_torch.structure.topology import Topology


def _rotmat_np(x3, x2, x1):
    s1, c1 = np.sin(x1), np.cos(x1)
    s2, c2 = np.sin(x2), np.cos(x2)
    s3, c3 = np.sin(x3), np.cos(x3)
    return np.array(
        [
            [c1 * c2, c1 * s2 * s3 - c3 * s1, s1 * s3 + c1 * c3 * s2],
            [c2 * s1, c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3],
            [-s2, c2 * s3, c2 * c3],
        ]
    )


@dataclass
class RotorProps:
    """RNA mass/geometry needed for statics & dynamics assembly.

    From the reference's Rotor.__init__ / setPosition / setYaw
    (raft_rotor.py:38-135, 390-478)."""

    mRNA: float
    IxRNA: float
    IrRNA: float
    xCG_RNA: float
    overhang: float
    shaft_tilt: float       # [rad]
    shaft_toe: float        # [rad]
    precone: float          # [rad]
    nBlades: int
    r_rel: np.ndarray       # RNA reference point wrt PRP (3,)
    q_rel: np.ndarray       # rotor axis unit vector at zero pose
    R_q0: np.ndarray        # rotation matrix local->global at zero pose
    Zhub: float
    I_drivetrain: float = 0.0
    aeroServoMod: int = 1
    yaw_mode: int = 0
    # submerged (MHK) rotor blade hydro summary about the rotor node:
    # dict(A_hydro, I_hydro, Fvec, Cmat, V, r_hub) or None
    hydro: dict | None = None


class FOWTStructure:
    """Immutable build-time description of one FOWT."""

    def __init__(self, design, depth=600.0, x_ref=0.0, y_ref=0.0, heading_adjust=0.0):
        self.design = design
        self.depth = float(depth)
        self.x_ref = x_ref
        self.y_ref = y_ref
        self.heading_adjust = heading_adjust

        site = design.get("site", {})
        self.rho_water = float(coerce(site, "rho_water", default=1025.0))
        self.g = float(coerce(site, "g", default=9.81))
        self.shearExp_water = float(coerce(site, "shearExp_water", default=0.12))

        platform = design["platform"]
        self.potModMaster = int(coerce(platform, "potModMaster", dtype=int, default=0))
        dlsMax = float(coerce(platform, "dlsMax", default=5.0))
        self.yaw_stiffness = float(platform.get("yaw_stiffness", 0.0))
        self.potFirstOrder = int(coerce(platform, "potFirstOrder", dtype=int, default=0))
        self.potSecOrder = int(coerce(platform, "potSecOrder", dtype=int, default=0))
        self.hydroPath = platform.get("hydroPath", None)

        # ---- members: platform (with heading copies), tower, nacelle ----
        self.members: list[MemberGeometry] = []
        for mi in platform["members"]:
            mi = dict(mi)
            if self.potModMaster in (1,):
                mi["potMod"] = False
            elif self.potModMaster in (2, 3):
                mi["potMod"] = True
            if "dlsMax" not in mi:
                mi["dlsMax"] = dlsMax
            headings = coerce(mi, "heading", shape=-1, default=0.0)
            headings = [headings] if np.isscalar(headings) else list(headings)
            for h in headings:
                self.members.append(
                    build_member(mi, heading=h + heading_adjust, part_of="platform")
                )

        self.nrotors = 0
        self.ntowers = 0
        turbine = design.get("turbine", None)
        if turbine is not None:
            self.nrotors = int(coerce(turbine, "nrotors", dtype=int, shape=0, default=1))
            turbine.setdefault("nrotors", self.nrotors)
            towers = turbine.get("tower", None)
            if towers is not None:
                if isinstance(towers, dict):
                    towers = [towers] * self.nrotors
                self.ntowers = len(towers)
                for mem in towers:
                    self.members.append(build_member(mem, part_of="tower"))
            nacelles = turbine.get("nacelle", None)
            if nacelles is not None:
                if isinstance(nacelles, dict):
                    nacelles = [nacelles] * self.nrotors
                for mem in nacelles:
                    self.members.append(build_member(mem, part_of="nacelle"))

        self.nplatmems = sum(1 for m in self.members if m.part_of == "platform")

        # ---- rotors ----
        self.rotors: list[RotorProps] = []
        for ir in range(self.nrotors):
            self.rotors.append(self._build_rotor(turbine, ir))

        # ---- point inertias / mean loads (raft_fowt.py:96-120) ----
        self.pointInertias = []
        self.pointLoads = []
        for eff in platform.get("additional_effects", []) or []:
            if eff["type"] == "point_inertia":
                m = coerce(eff, "mass", shape=0, default=0)
                J = coerce(eff, "moments_of_inertia", shape=6, default=[0, 0, 0])
                M = np.diag([m, m, m, J[0], J[1], J[2]])
                M[3, 4] = M[4, 3] = J[3]
                M[3, 5] = M[5, 3] = J[4]
                M[4, 5] = M[5, 4] = J[5]
                self.pointInertias.append(
                    {"m": m, "inertia": M, "r": coerce(eff, "location", shape=3, default=[0, 0, 0])}
                )
            elif eff["type"] == "mean_load":
                self.pointLoads.append(
                    {
                        "f": coerce(eff, "load", shape=6, default=np.zeros(6)),
                        "r": coerce(eff, "location", shape=3, default=[0, 0, 0]),
                    }
                )

        # ---- topology: nodes, joints, DOF reduction ----
        self._build_topology(design)

    # ------------------------------------------------------------------
    def _build_rotor(self, turbine, ir):
        nrotors = turbine["nrotors"]
        if "rRNA" in turbine:
            r_rel = coerce(turbine, "rRNA", shape=[nrotors, 3])[ir].astype(float)
        else:
            r_rel = np.zeros(3)
        overhang = coerce(turbine, "overhang", shape=nrotors)[ir]
        shaft_tilt = coerce(turbine, "shaft_tilt", shape=nrotors)[ir] * np.pi / 180
        shaft_toe = coerce(turbine, "shaft_toe", shape=nrotors, default=0)[ir] * np.pi / 180
        precone = coerce(turbine, "precone", shape=nrotors, default=0)[ir] * np.pi / 180
        q_rel = _rotmat_np(0.0, -shaft_tilt, shaft_toe) @ np.array([1.0, 0.0, 0.0])
        if "hHub" in turbine:
            hHub = coerce(turbine, "hHub", shape=nrotors)[ir]
            r_rel = r_rel.copy()
            r_rel[2] = hHub - q_rel[2] * overhang
        R_q0 = _rotmat_np(0.0, -shaft_tilt, shaft_toe)  # yaw = 0 at build
        Zhub = r_rel[2] + q_rel[2] * overhang
        rotor_hydro = None
        if Zhub < 0 and "blade" in turbine and "airfoils" in turbine:
            from raft_tpu_torch.physics.aero import blade_hydro

            props = RotorProps(
                mRNA=0, IxRNA=0, IrRNA=0, xCG_RNA=0, overhang=overhang,
                shaft_tilt=shaft_tilt, shaft_toe=shaft_toe, precone=precone,
                nBlades=int(coerce(turbine, "nBlades", shape=nrotors,
                                   dtype=int, default=3)[ir]),
                r_rel=r_rel, q_rel=q_rel, R_q0=R_q0, Zhub=Zhub)
            rotor_hydro = blade_hydro(
                turbine, ir, props, rho_water=self.rho_water, g=self.g)
        return RotorProps(
            mRNA=coerce(turbine, "mRNA", shape=nrotors)[ir],
            IxRNA=coerce(turbine, "IxRNA", shape=nrotors)[ir],
            IrRNA=coerce(turbine, "IrRNA", shape=nrotors)[ir],
            xCG_RNA=coerce(turbine, "xCG_RNA", shape=nrotors, default=0)[ir],
            overhang=overhang,
            shaft_tilt=shaft_tilt,
            shaft_toe=shaft_toe,
            precone=precone,
            nBlades=int(coerce(turbine, "nBlades", shape=nrotors, dtype=int, default=3)[ir]),
            r_rel=r_rel,
            q_rel=q_rel,
            R_q0=R_q0,
            Zhub=r_rel[2] + q_rel[2] * overhang,
            I_drivetrain=float(coerce(turbine, "I_drivetrain", shape=nrotors, default=0.0)[ir]),
            aeroServoMod=int(coerce(turbine, "aeroServoMod", shape=nrotors, dtype=int, default=1)[ir]),
            yaw_mode=int(coerce(turbine, "yaw_mode", shape=nrotors, dtype=int, default=0)[ir]),
            hydro=rotor_hydro,
        )

    # ------------------------------------------------------------------
    def _build_topology(self, design):
        """Joints + nodes + reduction; raft_fowt.py:183-339."""
        topo = Topology()

        # nodes per member: rigid members have a single node at rA0;
        # beams get one node per strip (raft_member.py:273-287)
        member_nodes = []
        for im, mem in enumerate(self.members):
            if mem.mtype == "rigid":
                member_nodes.append(topo.add_node(mem.rA0, "member", owner=im).id)
            else:
                r = mem.rA0[None, :] + mem.q0[None, :] * mem.ls[:, None]
                ids = []
                for i in range(mem.ns):
                    end = i == 0 or i == mem.ns - 1
                    ids.append(topo.add_node(r[i], "member", owner=im,
                                             end_node=end).id)
                topo.add_chain(ids)
                member_nodes.append(ids[0])
        rotor_nodes = []
        for ir, rot in enumerate(self.rotors):
            rotor_nodes.append(topo.add_node(rot.r_rel, "rotor", owner=ir).id)

        # joint data (raft_fowt.py:188-212): explicit or the virtual
        # origin joint connecting all platform members + towers
        turbine = design.get("turbine", {}) or {}
        tower_names = []
        if "tower" in turbine:
            tw = turbine["tower"]
            tw = [tw] if isinstance(tw, dict) else tw
            tower_names = [m["name"] for m in tw]

        joint_data = design.get("joints", None)
        if joint_data is None:
            names = [m["name"] for m in design["platform"]["members"]] + tower_names
            joint_data = [
                {"name": "origin_joint", "type": "cantilever", "location": [0, 0, 0],
                 "members": names}
            ]

        for j_data in joint_data:
            j_headings = coerce(j_data, "heading", shape=-1, default=0.0)
            j_headings = [j_headings] if np.isscalar(j_headings) else list(j_headings)
            for count_heading, j_heading in enumerate(j_headings):
                r_j = np.array(j_data["location"], dtype=float)
                if j_heading != 0.0:
                    r_j = _heading_rot(j_heading) @ r_j
                joint = topo.add_joint(r_j, j_data["type"], j_data["name"])
                for member_name in j_data["members"]:
                    idxs = [i for i, m in enumerate(self.members) if m.name == member_name]
                    if not idxs:
                        raise ValueError(f"joint references unknown member {member_name!r}")
                    if len(idxs) == 1 or len(j_headings) == 1:
                        chosen = idxs
                    else:
                        chosen = [idxs[count_heading]]
                    for im in chosen:
                        topo.attach_node_to_joint(
                            self._closest_end_node(topo, member_nodes, im, joint),
                            joint,
                        )

        # rotor-to-tower joints (raft_fowt.py:303-312)
        tower_member_idx = [i for i, m in enumerate(self.members) if m.part_of == "tower"]
        nacelle_member_idx = [i for i, m in enumerate(self.members) if m.part_of == "nacelle"]
        for ir, rot in enumerate(self.rotors):
            joint = topo.add_joint(rot.r_rel, "cantilever", "tower2rotor")
            topo.attach_node_to_joint(
                self._closest_end_node(topo, member_nodes, tower_member_idx[ir], joint),
                joint)
            topo.attach_node_to_joint(topo.nodes[rotor_nodes[ir]], joint)
            # nacelle members ride the tower top (the reference leaves
            # them unjoined, which breaks its own DOF reduction on the
            # MHK designs; rigid attachment to the RNA joint is the
            # physically intended configuration)
            if ir < len(nacelle_member_idx):
                topo.attach_node_to_joint(
                    topo.nodes[member_nodes[nacelle_member_idx[ir]]], joint)

        T, dT, reducedDOF, root_id = topo.reduce_with_derivative()
        self.topology = topo
        self.T = T
        self.dT = dT
        self.reducedDOF = reducedDOF
        self.root_id = root_id
        self.member_node = np.array(member_nodes)
        self.rotor_node = np.array(rotor_nodes)
        self.n_nodes = len(topo.nodes)
        self.node_r0 = np.array([n.r0 for n in topo.nodes])
        self.nFullDOF = 6 * self.n_nodes
        self.nDOF = len(reducedDOF)
        self.is_single_body = self.nDOF == 6 and all(
            d[0] == root_id for d in reducedDOF
        )

    @staticmethod
    def _closest_end_node(topo, member_nodes, im, joint):
        """The member end node closest to the joint (raft_fowt.py:498-511)."""
        first = member_nodes[im]
        n0 = topo.nodes[first]
        # find the member's last node (same owner, contiguous ids)
        last = first
        while (last + 1 < len(topo.nodes)
               and topo.nodes[last + 1].kind == "member"
               and topo.nodes[last + 1].owner == n0.owner):
            last += 1
        if last == first:
            return n0
        n1 = topo.nodes[last]
        dA = np.linalg.norm(n0.r0 - joint["r"])
        dB = np.linalg.norm(n1.r0 - joint["r"])
        return n0 if dA < dB else n1
