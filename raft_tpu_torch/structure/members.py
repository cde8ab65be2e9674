"""Build-time member geometry (numpy; counterpart of
``raft_tpu/structure/members.py``).

Turns one member entry of the design schema into static arrays: station
data, the strip-theory discretisation, interpolated hydro coefficients,
end-cap/bulkhead geometry, and the per-section inertia elements (mass,
axial CG offset and principal moments of inertia about the CG in
member-local axes), following the reference RAFT ``Member`` constructor
(``raft_member.py``: strips :190-267, stations :82-188, caps :161-176,
inertia :412-541 and :659-823).

A ``type: beam`` (flexible) member also carries its Young's and shear
moduli ``E`` and ``G``, its outer and inner section at every strip node
and, per node, the lumped ballast and end-cap mass, centre and principal
moments (:func:`_build_beam_node_data`); its shell comes from the FE
matrices of :mod:`raft_tpu_torch.physics.beams`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from raft_tpu_torch.structure.schema import coerce


def _heading_rot(heading_deg):
    c, s = np.cos(np.deg2rad(heading_deg)), np.sin(np.deg2rad(heading_deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _frustum_vcv(dA, dB, H):
    """numpy twin of ops.frustum.frustum_vcv_* for build-time use.

    dA/dB scalars (circular diameters) or length-2 arrays (side pairs);
    helpers.py:36-63."""
    dA = np.asarray(dA, dtype=float)
    dB = np.asarray(dB, dtype=float)
    if np.sum(dA) == 0 and np.sum(dB) == 0:
        return 0.0, 0.0
    if dA.ndim == 0:
        A1 = np.pi / 4 * dA**2
        A2 = np.pi / 4 * dB**2
        Am = np.pi / 4 * dA * dB
    else:
        A1 = dA[0] * dA[1]
        A2 = dB[0] * dB[1]
        Am = np.sqrt(A1 * A2)
    V = (A1 + A2 + Am) * H / 3.0
    hc = ((A1 + 2 * Am + 3 * A2) / (A1 + Am + A2)) * H / 4.0 if (A1 + Am + A2) != 0 else 0.0
    return V, hc


def _frustum_moi(dA, dB, H, rho):
    """helpers.py:65-83 (circular)."""
    if H == 0:
        return 0.0, 0.0
    r1, r2 = dA / 2.0, dB / 2.0
    if dA == dB:
        I_rad = (1 / 12) * (rho * H * np.pi * r1**2) * (3 * r1**2 + 4 * H**2)
        I_ax = 0.5 * rho * np.pi * H * r1**4
    else:
        I_rad = (1 / 20) * rho * np.pi * H * (r2**5 - r1**5) / (r2 - r1) + (
            1 / 30
        ) * rho * np.pi * H**3 * (r1**2 + 3 * r1 * r2 + 6 * r2**2)
        I_ax = (1 / 10) * rho * np.pi * H * (r2**5 - r1**5) / (r2 - r1)
    return I_rad, I_ax


def _rect_moi(La, Wa, Lb, Wb, H, rho):
    """helpers.py:85-146 (rectangular)."""
    if H == 0:
        return 0.0, 0.0, 0.0
    if La == Lb and Wa == Wb:
        M = rho * La * Wa * H
        return (
            (1 / 12) * M * (Wa**2 + 4 * H**2),
            (1 / 12) * M * (La**2 + 4 * H**2),
            (1 / 12) * M * (La**2 + Wa**2),
        )
    if La != Lb and Wa != Wb:
        x2 = (1 / 12) * rho * (
            (Lb - La) ** 3 * H * (Wb / 5 + Wa / 20)
            + (Lb - La) ** 2 * La * H * (3 * Wb / 4 + Wa / 4)
            + (Lb - La) * La**2 * H * (Wb + Wa / 2)
            + La**3 * H * (Wb / 2 + Wa / 2)
        )
        y2 = (1 / 12) * rho * (
            (Wb - Wa) ** 3 * H * (Lb / 5 + La / 20)
            + (Wb - Wa) ** 2 * Wa * H * (3 * Lb / 4 + La / 4)
            + (Wb - Wa) * Wa**2 * H * (Lb + La / 2)
            + Wa**3 * H * (Lb / 2 + La / 2)
        )
        z2 = rho * (Wb * Lb / 5 + Wa * Lb / 20 + La * Wb / 20 + Wa * La / 30) * H**3
    elif La == Lb:
        x2 = (1 / 24) * rho * (La**3) * H * (Wb + Wa)
        y2 = (1 / 48) * rho * La * H * (Wb**3 + Wa * Wb**2 + Wa**2 * Wb + Wa**3)
        z2 = (1 / 12) * rho * La * (H**3) * (3 * Wb + Wa)
    else:  # Wa == Wb
        x2 = (1 / 48) * rho * Wa * H * (Lb**3 + La * Lb**2 + La**2 * Lb + La**3)
        y2 = (1 / 24) * rho * (Wa**3) * H * (Lb + La)
        z2 = (1 / 12) * rho * Wa * (H**3) * (3 * Lb + La)
    return y2 + z2, x2 + z2, x2 + y2


@dataclass
class MemberGeometry:
    """Static geometry of one member (one heading copy)."""

    name: str
    part_of: str            # 'platform' | 'tower' | 'nacelle'
    mtype: str              # 'rigid' | 'beam'
    circular: bool
    potMod: bool
    MCF: bool
    rA0: np.ndarray         # (3,) end A wrt PRP, heading applied
    rB0: np.ndarray
    l: float
    gamma: float            # twist [deg] (incl. heading for vertical members)
    q0: np.ndarray          # member axes at reference pose (no platform rot)
    p10: np.ndarray
    p20: np.ndarray
    R0: np.ndarray          # (3,3), columns map local (x,y,z)->(p1,p2,q)

    stations: np.ndarray    # (n,) axial station positions 0..l
    d: np.ndarray           # (n,2) outer diameter pair (duplicated if circular)
    t: np.ndarray           # (n,) shell thickness
    rho_shell: float
    l_fill: np.ndarray      # (n-1,) ballast fill length per section [m]
    rho_fill: np.ndarray    # (n-1,) ballast density per section

    # strips (hydro nodes), raft_member.py:190-267
    ls: np.ndarray          # (ns,) node position along axis
    dls: np.ndarray         # (ns,) lumped strip length
    ds: np.ndarray          # (ns,2) strip mean diameter/side pair
    drs: np.ndarray         # (ns,2) strip radius/side-half change
    # strip coefficients interpolated at ls (raft_member.py:1315-1318 etc.)
    Cd_q: np.ndarray
    Cd_p1: np.ndarray
    Cd_p2: np.ndarray
    Cd_End: np.ndarray
    Ca_q: np.ndarray
    Ca_p1: np.ndarray
    Ca_p2: np.ndarray
    Ca_End: np.ndarray

    # inertia elements: sections + caps flattened (see module docstring)
    elem_mass: np.ndarray     # (ne,)
    elem_s: np.ndarray        # (ne,) axial CG offset from rA along axis
    elem_Ixx: np.ndarray      # (ne,) about CG, member-local axes (p1,p2,q)
    elem_Iyy: np.ndarray
    elem_Izz: np.ndarray

    # bookkeeping for reporting (mass of shell incl. caps, ballast lists)
    mshell: float = 0.0
    mfill: list = field(default_factory=list)
    pfill: list = field(default_factory=list)
    vfill: list = field(default_factory=list)

    # cap/bulkhead configuration (resolved axial positions)
    cap_L: np.ndarray | None = None       # (nc,) axial positions 0..l
    cap_t_arr: np.ndarray | None = None   # (nc,) cap thicknesses
    cap_d_in_arr: np.ndarray | None = None  # (nc,) or (nc,2) hole sizes
    # beam (flexible) member data
    E: float = 0.0
    G: float = 0.0
    dorsl_node_ext: np.ndarray | None = None  # (ns, 2) external d/side at strip nodes
    dorsl_node_int: np.ndarray | None = None  # (ns, 2) internal
    # per-node lumped ballast/cap data of beams (raft_member.py:550-657, 806-823)
    node_ballast_mass: np.ndarray | None = None    # (ns,)
    node_ballast_center: np.ndarray | None = None  # (ns, 3) global at the ref pose
    node_ballast_I: np.ndarray | None = None       # (ns, 3) local principal MoI about its CG
    node_cap_mass: np.ndarray | None = None
    node_cap_center: np.ndarray | None = None
    node_cap_I: np.ndarray | None = None

    @property
    def ns(self):
        return len(self.ls)


def build_member(mi, heading=0.0, part_of="platform", global_dlsMax=5.0):
    """Construct MemberGeometry from a member dict of the design schema.

    Mirrors Member.__init__ (raft_member.py:17-310) minus runtime state.
    """
    # normalise the member type: the current schema uses 'rigid'/'beam';
    # legacy designs carry numeric type codes (all rigid)
    mtype = "beam" if str(mi.get("type", "rigid")).lower() == "beam" else "rigid"
    rA0 = np.array(mi["rA"], dtype=float)
    rB0 = np.array(mi["rB"], dtype=float)
    shape = str(mi["shape"])
    circular = shape[0].lower() == "c"

    gamma = float(coerce(mi, "gamma", default=0.0))
    rAB = rB0 - rA0
    l = float(np.linalg.norm(rAB))

    if heading != 0.0:
        R_h = _heading_rot(heading)
        rA0 = R_h @ rA0
        rB0 = R_h @ rB0
        if rAB[0] == 0.0 and rAB[1] == 0.0:  # vertical: heading becomes twist
            gamma += heading

    st = np.array(mi["stations"], dtype=float)
    n = len(st)
    stations = (st - st[0]) / (st[-1] - st[0]) * l

    if circular:
        d1 = coerce(mi, "d", shape=n)
        d = np.stack([d1, d1], axis=1)
        gamma = 0.0  # twist irrelevant for circular (raft_member.py:104)
    else:
        d = coerce(mi, "d", shape=[n, 2])

    t = coerce(mi, "t", shape=n, default=0)
    rho_shell = float(coerce(mi, "rho_shell", shape=0, default=8500.0))

    st_fill = coerce(mi, "l_fill", shape=n - 1, default=0)
    l_fill = st_fill / (st[-1] - st[0]) * l
    rho_fill_in = coerce(mi, "rho_fill", shape=-1, default=1025)
    if np.isscalar(rho_fill_in):
        rho_fill = np.zeros(n - 1) + rho_fill_in
    else:
        rho_fill = np.array(rho_fill_in, dtype=float)

    # drag / added mass coefficients at stations (raft_member.py:179-188)
    Cd_q_st = coerce(mi, "Cd_q", shape=n, default=0.0)
    Cd_p1_st = coerce(mi, "Cd", shape=n, default=0.6, index=0)
    Cd_p2_st = coerce(mi, "Cd", shape=n, default=0.6, index=1)
    Cd_End_st = coerce(mi, "CdEnd", shape=n, default=0.6)
    Ca_q_st = coerce(mi, "Ca_q", shape=n, default=0.0)
    Ca_p1_st = coerce(mi, "Ca", shape=n, default=0.97, index=0)
    Ca_p2_st = coerce(mi, "Ca", shape=n, default=0.97, index=1)
    Ca_End_st = coerce(mi, "CaEnd", shape=n, default=0.6)

    # ----- strip discretisation (raft_member.py:190-254) -----
    dorsl = [d[i].copy() for i in range(n)]
    dorsl_int = [np.maximum(0.0, d[i] - 2 * t[i]) for i in range(n)]
    dlsMax = float(coerce(mi, "dlsMax", shape=0, default=global_dlsMax))

    ls = [0.0]
    dls = [0.0]
    ds = [0.5 * dorsl[0]]
    drs = [0.5 * dorsl[0]]
    d_node_ext = [dorsl[0]]
    d_node_int = [dorsl_int[0]]
    for i in range(1, n):
        lstrip = stations[i] - stations[i - 1]
        if lstrip > 0.0:
            ns_i = int(np.ceil(lstrip / dlsMax))
            dlstrip = lstrip / ns_i
            m = 0.5 * (dorsl[i] - dorsl[i - 1]) / lstrip
            m_int = 0.5 * (dorsl_int[i] - dorsl_int[i - 1]) / lstrip
            ls += [stations[i - 1] + dlstrip * (0.5 + j) for j in range(ns_i)]
            dls += [dlstrip] * ns_i
            ds += [dorsl[i - 1] + dlstrip * 2 * m * (0.5 + j) for j in range(ns_i)]
            drs += [dlstrip * m] * ns_i
            d_node_ext += [dorsl[i - 1] + dlstrip * 2 * m * (0.5 + j) for j in range(ns_i)]
            d_node_int += [dorsl_int[i - 1] + dlstrip * 2 * m_int * (0.5 + j) for j in range(ns_i)]
        elif lstrip == 0.0:
            ls += [stations[i - 1]]
            dls += [0.0]
            ds += [0.5 * (dorsl[i - 1] + dorsl[i])]
            drs += [0.5 * (dorsl[i] - dorsl[i - 1])]
            d_node_ext += [dorsl[i - 1]]
            d_node_int += [dorsl_int[i - 1]]
    # end B strip (raft_member.py:245-254)
    ls += [stations[-1]]
    dls += [0.0]
    ds += [0.5 * dorsl[-1]]
    drs += [-0.5 * dorsl[-1]]
    d_node_ext += [dorsl[-1]]
    d_node_int += [dorsl_int[-1]]

    ls = np.array(ls, dtype=float)
    dls = np.array(dls, dtype=float)
    ds = np.stack([np.broadcast_to(x, (2,)) for x in ds])
    drs = np.stack([np.broadcast_to(x, (2,)) for x in drs])
    d_node_ext = np.stack([np.broadcast_to(x, (2,)) for x in d_node_ext])
    d_node_int = np.stack([np.broadcast_to(x, (2,)) for x in d_node_int])

    # ----- member axes at reference pose (raft_member.py:312-345) -----
    q = (rB0 - rA0) / l
    beta_m = np.arctan2(q[1], q[0])
    phi_m = np.arctan2(np.sqrt(q[0] ** 2 + q[1] ** 2), q[2])
    s1, c1 = np.sin(beta_m), np.cos(beta_m)
    s2, c2 = np.sin(phi_m), np.cos(phi_m)
    s3, c3 = np.sin(np.deg2rad(gamma)), np.cos(np.deg2rad(gamma))
    R0 = np.array(
        [
            [c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2],
            [c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2],
            [-c3 * s2, s2 * s3, c2],
        ]
    )
    p1 = R0 @ np.array([1.0, 0.0, 0.0])
    p2 = np.cross(q, p1)

    # ----- per-strip coefficients (np.interp over stations) -----
    def interp(c_st):
        return np.interp(ls, stations, c_st)

    geom = MemberGeometry(
        name=str(mi.get("name", "member")),
        part_of=part_of.lower(),
        mtype=mtype,
        circular=circular,
        potMod=bool(coerce(mi, "potMod", dtype=bool, default=False)),
        MCF=bool(coerce(mi, "MCF", dtype=bool, default=False)) and circular,
        rA0=rA0,
        rB0=rB0,
        l=l,
        gamma=gamma,
        q0=q,
        p10=p1,
        p20=p2,
        R0=R0,
        stations=stations,
        d=d,
        t=t,
        rho_shell=rho_shell,
        l_fill=l_fill,
        rho_fill=rho_fill,
        ls=ls,
        dls=dls,
        ds=ds,
        drs=drs,
        Cd_q=interp(Cd_q_st),
        Cd_p1=interp(Cd_p1_st),
        Cd_p2=interp(Cd_p2_st),
        Cd_End=interp(Cd_End_st),
        Ca_q=interp(Ca_q_st),
        Ca_p1=interp(Ca_p1_st),
        Ca_p2=interp(Ca_p2_st),
        Ca_End=interp(Ca_End_st),
        elem_mass=np.zeros(0),
        elem_s=np.zeros(0),
        elem_Ixx=np.zeros(0),
        elem_Iyy=np.zeros(0),
        elem_Izz=np.zeros(0),
        E=float(np.atleast_1d(mi.get("E", [0.0]))[0]) if "E" in mi else 0.0,
        G=float(np.atleast_1d(mi.get("G", [0.0]))[0]) if "G" in mi else 0.0,
        dorsl_node_ext=d_node_ext,
        dorsl_node_int=d_node_int,
    )
    _parse_caps(geom, mi)
    if mtype == "beam":
        _build_beam_node_data(geom, mi)
    else:
        _build_inertia_elements(geom, mi)
    return geom


def _parse_caps(g: MemberGeometry, mi):
    """Resolve the cap/bulkhead configuration onto the geometry object
    (axial positions scaled to member length, raft_member.py:161-176)."""
    cap_stations_in = coerce(mi, "cap_stations", shape=-1, default=[])
    if len(np.atleast_1d(cap_stations_in)) == 0:
        g.cap_L = np.zeros(0)
        g.cap_t_arr = np.zeros(0)
        g.cap_d_in_arr = np.zeros(0)
        return
    cap_st_in = np.atleast_1d(np.array(cap_stations_in, dtype=float))
    g.cap_t_arr = np.atleast_1d(coerce(mi, "cap_t", shape=cap_st_in.shape[0]))
    if g.circular:
        g.cap_d_in_arr = np.atleast_1d(
            coerce(mi, "cap_d_in", shape=cap_st_in.shape[0]))
    else:
        g.cap_d_in_arr = coerce(mi, "cap_d_in", shape=[cap_st_in.shape[0], 2])
    st0 = np.array(mi["stations"], dtype=float)
    g.cap_L = (cap_st_in - st0[0]) / (st0[-1] - st0[0]) * g.l


def _cap_elements(g: MemberGeometry):
    """Cap/bulkhead inertia elements (raft_member.py:659-823):
    list of (mass, axial CG offset, Ixx, Iyy, Izz about CG, local axes).
    Uses the cap configuration resolved by :func:`_parse_caps`."""
    out = []
    cap_L = g.cap_L
    cap_t = g.cap_t_arr
    cap_d_in = g.cap_d_in_arr
    if cap_L is not None and len(cap_L) > 0:

        for ic in range(len(cap_L)):
            L = cap_L[ic]
            h = cap_t[ic]
            rho_cap = g.rho_shell
            if g.circular:
                d_hole = cap_d_in[ic]
                d_in = g.d[:, 0] - 2 * g.t
                if L == g.stations[0]:
                    dA = d_in[0]
                    dB = np.interp(L + h, g.stations, d_in)
                    dAi = d_hole
                    dBi = dB * (dAi / dA) if dA != 0 else 0.0
                elif L == g.stations[-1]:
                    dA = np.interp(L - h, g.stations, d_in)
                    dB = d_in[-1]
                    dBi = d_hole
                    dAi = dA * (dBi / dB) if dB != 0 else 0.0
                elif ic < len(cap_L) - 1 and L == cap_L[ic + 1]:
                    # discontinuity station, lower-member end cap
                    # (raft_member.py:689-693; note d_in indexed by cap idx)
                    dA = np.interp(L - h, g.stations, d_in)
                    dB = d_in[ic]
                    dBi = d_hole
                    dAi = dA * (dBi / dB) if dB != 0 else 0.0
                elif ic > 0 and L == cap_L[ic - 1]:
                    # discontinuity station, upper-member end cap
                    # (raft_member.py:694-698)
                    dA = d_in[ic]
                    dB = np.interp(L + h, g.stations, d_in)
                    dAi = d_hole
                    dBi = dB * (dAi / dA) if dA != 0 else 0.0
                else:
                    dA = np.interp(L - h / 2, g.stations, d_in)
                    dB = np.interp(L + h / 2, g.stations, d_in)
                    dM = np.interp(L, g.stations, d_in)
                    dMi = d_hole
                    dAi = dA * (dMi / dM) if dM != 0 else 0.0
                    dBi = dB * (dMi / dM) if dM != 0 else 0.0
                V_o, hco = _frustum_vcv(dA, dB, h)
                V_i, hci = _frustum_vcv(dAi, dBi, h)
                v_cap = V_o - V_i
                m_cap = v_cap * rho_cap
                hc_cap = ((hco * V_o) - (hci * V_i)) / (V_o - V_i) if V_o != V_i else 0.0
                Ir_o, Ia_o = _frustum_moi(dA, dB, h, rho_cap)
                Ir_i, Ia_i = _frustum_moi(dAi, dBi, h, rho_cap)
                I_rad = (Ir_o - Ir_i) - m_cap * hc_cap**2
                I_ax = Ia_o - Ia_i
                Ixx, Iyy, Izz = I_rad, I_rad, I_ax
            else:
                sl_hole = cap_d_in[ic]
                sl_in = g.d - 2 * g.t[:, None]
                if L == g.stations[0]:
                    slA = sl_in[0]
                    slB = np.array(
                        [np.interp(L + h, g.stations, sl_in[:, 0]),
                         np.interp(L + h, g.stations, sl_in[:, 1])]
                    )
                    slAi = sl_hole
                    slBi = slB * (slAi / slA)
                elif L == g.stations[-1]:
                    slB = sl_in[-1]
                    slA = np.array(
                        [np.interp(L - h, g.stations, sl_in[:, 0]),
                         np.interp(L - h, g.stations, sl_in[:, 1])]
                    )
                    slBi = sl_hole
                    slAi = slA * (slBi / slB)
                elif ic < len(cap_L) - 1 and L == cap_L[ic + 1]:
                    slA = np.array(
                        [np.interp(L - h, g.stations, sl_in[:, 0]),
                         np.interp(L - h, g.stations, sl_in[:, 1])]
                    )
                    slB = sl_in[ic]
                    slBi = sl_hole
                    slAi = slA * (slBi / slB)
                elif ic > 0 and L == cap_L[ic - 1]:
                    slA = sl_in[ic]
                    slB = np.array(
                        [np.interp(L + h, g.stations, sl_in[:, 0]),
                         np.interp(L + h, g.stations, sl_in[:, 1])]
                    )
                    slAi = sl_hole
                    slBi = slB * (slAi / slA)
                else:
                    slA = np.array(
                        [np.interp(L - h / 2, g.stations, sl_in[:, 0]),
                         np.interp(L - h / 2, g.stations, sl_in[:, 1])]
                    )
                    slB = np.array(
                        [np.interp(L + h / 2, g.stations, sl_in[:, 0]),
                         np.interp(L + h / 2, g.stations, sl_in[:, 1])]
                    )
                    slM = np.array(
                        [np.interp(L, g.stations, sl_in[:, 0]),
                         np.interp(L, g.stations, sl_in[:, 1])]
                    )
                    slMi = sl_hole
                    slAi = slA * (slMi / slM)
                    slBi = slB * (slMi / slM)
                V_o, hco = _frustum_vcv(slA, slB, h)
                V_i, hci = _frustum_vcv(slAi, slBi, h)
                v_cap = V_o - V_i
                m_cap = v_cap * rho_cap
                hc_cap = ((hco * V_o) - (hci * V_i)) / (V_o - V_i) if V_o != V_i else 0.0
                Ix_o, Iy_o, Iz_o = _rect_moi(slA[0], slA[1], slB[0], slB[1], h, rho_cap)
                Ix_i, Iy_i, Iz_i = _rect_moi(slAi[0], slAi[1], slBi[0], slBi[1], h, rho_cap)
                Ixx = (Ix_o - Ix_i) - m_cap * hc_cap**2
                Iyy = (Iy_o - Iy_i) - m_cap * hc_cap**2
                Izz = Iz_o - Iz_i

            # cap CG axial position (raft_member.py:780-787)
            if L == g.stations[0]:
                s_cg = L + hc_cap
            elif L == g.stations[-1]:
                s_cg = L - (h - hc_cap)
            else:
                s_cg = L - (h / 2 - hc_cap)

            out.append((m_cap, s_cg, Ixx, Iyy, Izz))

    return out


def _build_inertia_elements(g: MemberGeometry, mi):
    """Precompute shell+ballast section and cap inertia elements.

    Rigid-member branch of Member.getInertia (raft_member.py:412-541)
    and the cap/bulkhead block (raft_member.py:659-823), reduced to
    (mass, axial CG offset, local principal MoI about CG) per element.
    """
    n = len(g.stations)
    masses, ss, Ixxs, Iyys, Izzs = [], [], [], [], []
    mshell = 0.0
    mfill, pfill, vfill = [], [], []

    for i in range(1, n):
        lsec = g.stations[i] - g.stations[i - 1]
        if lsec <= 0:
            # Reference quirk (replicated for parity): getInertia does not
            # reset Ixx/Iyy/Izz per iteration, so a zero-length section
            # re-adds the PREVIOUS section's CG inertia with zero mass
            # (raft_member.py:413-540: `if l > 0` skips the recompute but
            # the Mmat/I accumulation below it still runs).
            if masses:
                masses.append(0.0)
                ss.append(0.0)
                Ixxs.append(Ixxs[-1])
                Iyys.append(Iyys[-1])
                Izzs.append(Izzs[-1])
            vfill.append(0.0)
            mfill.append(0.0)
            pfill.append(0.0)
            continue
        l_fill = g.l_fill[i - 1] if np.ndim(g.l_fill) else g.l_fill
        rho_fill = g.rho_fill[i - 1] if np.ndim(g.rho_fill) else g.rho_fill

        if g.circular:
            dA, dB = g.d[i - 1, 0], g.d[i, 0]
            dAi = dA - 2 * g.t[i - 1]
            dBi = dB - 2 * g.t[i]
            V_o, hco = _frustum_vcv(dA, dB, lsec)
            V_i, hci = _frustum_vcv(dAi, dBi, lsec)
            v_shell = V_o - V_i
            m_shell = v_shell * g.rho_shell
            hc_shell = ((hco * V_o) - (hci * V_i)) / (V_o - V_i) if V_o != V_i else 0.0
            dBi_fill = (dBi - dAi) * (l_fill / lsec) + dAi
            v_fill, hc_fill = _frustum_vcv(dAi, dBi_fill, l_fill)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = ((hc_fill * m_fill) + (hc_shell * m_shell)) / mass if mass != 0 else 0.0
            Ir_o, Ia_o = _frustum_moi(dA, dB, lsec, g.rho_shell)
            Ir_i, Ia_i = _frustum_moi(dAi, dBi, lsec, g.rho_shell)
            Ir_f, Ia_f = _frustum_moi(dAi, dBi_fill, l_fill, rho_fill)
            I_rad_end = (Ir_o - Ir_i) + Ir_f
            I_rad = I_rad_end - mass * hc**2
            I_ax = (Ia_o - Ia_i) + Ia_f
            Ixx, Iyy, Izz = I_rad, I_rad, I_ax
        else:
            slA, slB = g.d[i - 1], g.d[i]
            slAi = slA - 2 * g.t[i - 1]
            slBi = slB - 2 * g.t[i]
            V_o, hco = _frustum_vcv(slA, slB, lsec)
            V_i, hci = _frustum_vcv(slAi, slBi, lsec)
            v_shell = V_o - V_i
            m_shell = v_shell * g.rho_shell
            hc_shell = ((hco * V_o) - (hci * V_i)) / (V_o - V_i) if V_o != V_i else 0.0
            slBi_fill = (slBi - slAi) * (l_fill / lsec) + slAi
            v_fill, hc_fill = _frustum_vcv(slAi, slBi_fill, l_fill)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = ((hc_fill * m_fill) + (hc_shell * m_shell)) / mass if mass != 0 else 0.0
            Ix_o, Iy_o, Iz_o = _rect_moi(slA[0], slA[1], slB[0], slB[1], lsec, g.rho_shell)
            Ix_i, Iy_i, Iz_i = _rect_moi(slAi[0], slAi[1], slBi[0], slBi[1], lsec, g.rho_shell)
            Ix_f, Iy_f, Iz_f = _rect_moi(
                slAi[0], slAi[1], slBi_fill[0], slBi_fill[1], l_fill, rho_fill
            )
            Ixx = (Ix_o - Ix_i) + Ix_f - mass * hc**2
            Iyy = (Iy_o - Iy_i) + Iy_f - mass * hc**2
            Izz = (Iz_o - Iz_i) + Iz_f

        masses.append(mass)
        ss.append(g.stations[i - 1] + hc)
        Ixxs.append(Ixx)
        Iyys.append(Iyy)
        Izzs.append(Izz)
        mshell += m_shell
        vfill.append(float(np.ravel(v_fill)[0]) if np.ndim(v_fill) else float(v_fill))
        mfill.append(float(m_fill))
        pfill.append(float(rho_fill))

    # ----- caps / bulkheads (shared helper) -----
    for (m_cap, s_cg, Ixx, Iyy, Izz) in _cap_elements(g):
        masses.append(m_cap)
        ss.append(s_cg)
        Ixxs.append(Ixx)
        Iyys.append(Iyy)
        Izzs.append(Izz)
        mshell += m_cap

    g.elem_mass = np.array(masses)
    g.elem_s = np.array(ss)
    g.elem_Ixx = np.array(Ixxs)
    g.elem_Iyy = np.array(Iyys)
    g.elem_Izz = np.array(Izzs)
    g.mshell = mshell
    g.mfill = mfill
    g.pfill = pfill
    g.vfill = vfill


def _build_beam_node_data(g: MemberGeometry, mi):
    """Per-node lumped ballast and cap data for flexible members.

    Beam branch of Member.getInertia (raft_member.py:550-657): ballast
    in each section is split between nodes by their half-spacing zones;
    caps lump at the closest node (:806-823).
    """
    ns = g.ns
    nodes_s = g.ls.copy()  # node positions along axis (straight member)
    dist_p = np.diff(nodes_s, prepend=0)
    dist_n = np.diff(nodes_s, append=nodes_s[-1])

    mass_b = np.zeros(ns)
    center_b = np.zeros((ns, 3))
    I_b = np.zeros((ns, 3))
    n = len(g.stations)
    mfill, pfill, vfill = [], [], []
    for i in range(1, n):
        lsec = g.stations[i] - g.stations[i - 1]
        sec_mass = 0.0
        sec_v = 0.0
        rho_fill = g.rho_fill[i - 1] if lsec > 0 else 0.0
        if lsec > 0:
            l_fill = g.l_fill[i - 1]
            for inode in range(ns):
                s_lo = max(nodes_s[inode] - dist_p[inode] / 2, g.stations[i - 1])
                s_hi = min(nodes_s[inode] + dist_n[inode] / 2, g.stations[i - 1] + l_fill)
                l_node = s_hi - s_lo
                if l_node <= 0:
                    continue
                if g.circular:
                    dA_st = g.d[i - 1, 0] - 2 * g.t[i - 1]
                    dB_st = g.d[i, 0] - 2 * g.t[i]
                    dA = (dB_st - dA_st) * ((s_lo - g.stations[i - 1]) / lsec) + dA_st
                    dB = (dB_st - dA_st) * ((s_hi - g.stations[i - 1]) / lsec) + dA_st
                    v_n, hc_n = _frustum_vcv(dA, dB, l_node)
                    m_n = v_n * rho_fill
                    Ir_end, Ia = _frustum_moi(dA, dB, l_node, rho_fill)
                    Ir = Ir_end - m_n * hc_n**2
                    Ixx, Iyy, Izz = Ir, Ir, Ia
                else:
                    slA_st = g.d[i - 1] - 2 * g.t[i - 1]
                    slB_st = g.d[i] - 2 * g.t[i]
                    slA = (slB_st - slA_st) * ((s_lo - g.stations[i - 1]) / lsec) + slA_st
                    slB = (slB_st - slA_st) * ((s_hi - g.stations[i - 1]) / lsec) + slA_st
                    v_n, hc_n = _frustum_vcv(slA, slB, l_node)
                    m_n = v_n * rho_fill
                    Ix_e, Iy_e, Iz_e = _rect_moi(slA[0], slA[1], slB[0], slB[1], l_node, rho_fill)
                    Ixx = Ix_e - m_n * hc_n**2
                    Iyy = Iy_e - m_n * hc_n**2
                    Izz = Iz_e
                center = g.rA0 + g.q0 * (s_lo + hc_n)
                mass_b[inode] += m_n
                center_b[inode] += center * m_n
                I_b[inode] += np.array([Ixx, Iyy, Izz])
                sec_mass += m_n
                sec_v += v_n
        vfill.append(float(sec_v))
        mfill.append(float(sec_mass))
        pfill.append(float(rho_fill))
    nonzero = mass_b > 0
    center_b[nonzero] /= mass_b[nonzero, None]

    # caps lump at the closest node (raft_member.py:806-823)
    mass_c = np.zeros(ns)
    center_c = np.zeros((ns, 3))
    I_c = np.zeros((ns, 3))
    m_caps_total = 0.0
    for (m_cap, s_cg, Ix, Iy, Iz) in _cap_elements(g):
        center_cap = g.rA0 + g.q0 * s_cg
        inode = int(np.argmin(np.linalg.norm(
            (g.rA0[None, :] + g.q0[None, :] * nodes_s[:, None]) - center_cap[None, :],
            axis=1)))
        mass_c[inode] += m_cap
        center_c[inode] += center_cap * m_cap
        I_c[inode] += np.array([Ix, Iy, Iz])
        m_caps_total += m_cap
    nz = mass_c > 0
    center_c[nz] /= mass_c[nz, None]

    g.node_ballast_mass = mass_b
    g.node_ballast_center = center_b
    g.node_ballast_I = I_b
    g.node_cap_mass = mass_c
    g.node_cap_center = center_c
    g.node_cap_I = I_c
    g.mshell = m_caps_total  # shell mass itself comes from the FE matrix
    g.mfill = mfill
    g.pfill = pfill
    g.vfill = vfill
