"""Rotor aerodynamics and aero-servo coefficients (counterpart of
``raft_tpu/physics/aero.py``).

Two halves, as in the reference:

* build time (numpy/scipy, one rotor): :class:`RotorAeroModel` from the
  design's turbine section (:func:`build_rotor_aero`: polars re-gridded,
  PCHIP across relative thickness, cubic-spline resampled onto the
  1,200-point dense angle-of-attack grid), the blade curvature, the
  Kaimal special-function table and the submerged blades' hydro summary
  (:func:`blade_hydro`);
* evaluation (torch, batched over rows): the blade-element momentum
  solve of Ning (2014) over rows x azimuths x elements with its load
  derivatives (:func:`rotor_loads_and_derivs`), the operating schedule,
  the rotor-averaged Kaimal spectrum and the aero-servo coefficients
  about the rotor node (:func:`calc_aero_traced`).

The inflow angle is a root of the Ning residual found by 50 bisection
steps and 4 Newton steps on primal values only.  The derivatives of the
loads with respect to (wind speed, rotor speed, pitch) come from the
implicit-function tangent at the root, ``dphi = -(dR/dp) / R'(phi)``
with the slope floored at +-1e-8, as the reference's
``jax.lax.custom_root`` gives them, never from differentiating through
the iterations.  Two forms compute that tangent:

* :func:`rotor_loads_and_derivs`, the evaluator's: the tangents carried
  by hand as :class:`~raft_tpu_torch.ops.dual.Dual` numbers through the
  residual and the load integrals;
* :func:`rotor_loads_and_derivs_jacfwd`, the oracle: ``torch.func.jacfwd``
  of the loads with the root as a ``torch.autograd.Function`` whose
  ``jvp`` is the same implicit tangent.

``chip_smoke.py`` holds the two against each other on the card and
times both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from raft_tpu_torch.ops import dual as du
from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops.dual import Dual
from raft_tpu_torch.ops.interp import interp
from raft_tpu_torch.structure.schema import coerce
from raft_tpu_torch.utils import ad
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device

RAD2DEG = 57.29577951308232
RPM2RADPS = 0.1047  # the reference's conversion constant

#: bisection and Newton steps of the inflow-angle root
N_BISECT = 50
N_NEWTON = 4

#: residual evaluations per root solve: the two bracket ends, one per
#: bisection step, and one per Newton step (value and slope together)
RESIDUAL_EVALS = 2 + N_BISECT + N_NEWTON


# ------------------------------------------------------------------ build

@dataclass
class RotorAeroModel:
    """Static blade/airfoil/operating-schedule data for one rotor
    (numpy arrays and floats)."""

    B: int
    Rhub: float
    Rtip: float
    precone: float          # [rad]
    shaft_tilt: float       # [rad]
    rho: float
    mu: float
    shearExp: float
    hubHt: float
    nSector: int

    r: np.ndarray           # (nr,) element radii
    chord: np.ndarray
    theta_deg: np.ndarray
    precurve: np.ndarray
    presweep: np.ndarray
    precurveTip: float
    presweepTip: float

    aoa_deg: np.ndarray     # (n_aoa,)
    cl: np.ndarray          # (nr, n_aoa)
    cd: np.ndarray          # (nr, n_aoa)

    U_sched: np.ndarray     # operating schedule (incl. parked extension)
    Omega_sched: np.ndarray  # [rpm]
    pitch_sched: np.ndarray  # [deg]

    cpmin: np.ndarray | None = None  # (nr, n_aoa) min pressure coefficient

    # control gains (aeroServoMod == 2)
    kp_0: np.ndarray | None = None
    ki_0: np.ndarray | None = None
    k_float: float = 0.0
    kp_tau: float = 0.0
    ki_tau: float = 0.0
    Ng: float = 1.0
    I_drivetrain: float = 0.0


#: the integer fields of :class:`RotorAeroModel`
INT_FIELDS = ("B", "nSector")


def rotor_aero_from_numpy(values):
    """A :class:`RotorAeroModel` from a mapping of its field names to
    numpy values (for example the arrays of the JAX builder's model):
    arrays become float64 numpy arrays, ``B`` and ``nSector`` ints, the
    other scalars floats, and absent optional fields keep their
    defaults."""
    kw = {}
    for f in fields(RotorAeroModel):
        if f.name not in values:
            continue
        v = values[f.name]
        if v is None:
            kw[f.name] = None
        elif f.name in INT_FIELDS:
            kw[f.name] = int(v)
        elif np.ndim(v) == 0:
            kw[f.name] = float(v)
        else:
            kw[f.name] = np.asarray(v, dtype=np.float64)
    return RotorAeroModel(**kw)


def build_rotor_aero(turbine, ir=0, submerged=False):
    """Parse the turbine dict into a :class:`RotorAeroModel` (the
    reference's airfoil and station processing, numpy/scipy): polars
    re-gridded onto a 200-point angle-of-attack grid, PCHIP-interpolated
    across relative thickness, then cubic-spline resampled onto the
    6x-dense grid the evaluation interpolates linearly."""
    from scipy.interpolate import CubicSpline, PchipInterpolator

    nrotors = turbine.get("nrotors", 1)
    blade = turbine["blade"]
    blade = blade[ir] if isinstance(blade, list) else blade

    nBlades = int(coerce(turbine, "nBlades", shape=nrotors, dtype=int)[ir])
    Rhub = coerce(turbine, "Rhub", shape=nrotors)[ir]
    # sign flip: the reference passes -precone to its BEM solver
    precone = -coerce(turbine, "precone", shape=nrotors)[ir] * np.pi / 180
    shaft_tilt = coerce(turbine, "shaft_tilt", shape=nrotors)[ir] * np.pi / 180
    Rtip = float(blade["Rtip"])
    hubHt = coerce(turbine, "hHub", shape=nrotors, default=coerce(
        turbine, "Zhub", shape=nrotors, default=100)[ir])[ir]

    n_aoa = 200
    aoa = np.unique(np.hstack([
        np.linspace(-180, -30, int(n_aoa / 4 + 1)),
        np.linspace(-30, 30, int(n_aoa / 2)),
        np.linspace(30, 180, int(n_aoa / 4 + 1)),
    ]))

    airfoils = turbine["airfoils"]
    n_af = len(airfoils)
    names = [a["name"] for a in airfoils]
    thick = np.array([a["relative_thickness"] for a in airfoils])
    cl = np.zeros((n_af, len(aoa)))
    cd = np.zeros((n_af, len(aoa)))
    has_cpmin = all(len(np.array(a["data"])[0]) > 4 for a in airfoils)
    cpm = np.zeros((n_af, len(aoa))) if has_cpmin else None
    for i, a in enumerate(airfoils):
        tab = np.array(a["data"])
        cl[i] = np.interp(aoa, tab[:, 0], tab[:, 1])
        cd[i] = np.interp(aoa, tab[:, 0], tab[:, 2])
        if has_cpmin:
            cpm[i] = np.interp(aoa, tab[:, 0], tab[:, 4])
        # enforce +/-180 deg continuity
        cl[i, 0] = cl[i, -1]
        cd[i, 0] = cd[i, -1]

    station_airfoil = [b for [a, b] in blade["airfoils"]]
    station_position = np.array([a for [a, b] in blade["airfoils"]])
    nSt = len(station_airfoil)
    st_thick = np.zeros(nSt)
    st_cl = np.zeros((nSt, len(aoa)))
    st_cd = np.zeros((nSt, len(aoa)))
    st_cpm = np.zeros((nSt, len(aoa))) if has_cpmin else None
    for i in range(nSt):
        j = names.index(station_airfoil[i])
        st_thick[i] = thick[j]
        st_cl[i] = cl[j]
        st_cd[i] = cd[j]
        if has_cpmin:
            st_cpm[i] = cpm[j]

    nSector = int(coerce(blade, "nSector", default=4))
    nr = int(coerce(blade, "nr", default=20))
    grid = np.linspace(0.0, 1.0, nr, endpoint=False) + 0.5 / nr

    rthick = PchipInterpolator(station_position, st_thick)(grid)
    r_thick_unique, idx = np.unique(st_thick, return_index=True)
    cl_interp = np.flip(
        PchipInterpolator(r_thick_unique, st_cl[idx])(np.flip(rthick)), axis=0)
    cd_interp = np.flip(
        PchipInterpolator(r_thick_unique, st_cd[idx])(np.flip(rthick)), axis=0)
    cpm_interp = None
    if has_cpmin:
        cpm_interp = np.flip(
            PchipInterpolator(r_thick_unique, st_cpm[idx])(np.flip(rthick)),
            axis=0)

    aoa_dense = np.unique(np.concatenate([
        np.linspace(-180, -30, 6 * int(n_aoa / 4) + 1),
        np.linspace(-30, 30, 6 * int(n_aoa / 2)),
        np.linspace(30, 180, 6 * int(n_aoa / 4) + 1)]))
    cl_dense = np.stack([CubicSpline(aoa, c)(aoa_dense) for c in cl_interp])
    cd_dense = np.stack([CubicSpline(aoa, c)(aoa_dense) for c in cd_interp])
    cpm_dense = None
    if has_cpmin:
        cpm_dense = np.stack([CubicSpline(aoa, c)(aoa_dense)
                              for c in cpm_interp])

    geom = np.array(blade["geometry"])
    dr = (Rtip - Rhub) / nr
    blade_r = np.linspace(Rhub, Rtip, nr, endpoint=False) + dr / 2
    chord = np.interp(blade_r, geom[:, 0], geom[:, 1])
    theta = np.interp(blade_r, geom[:, 0], geom[:, 2])
    precurve = np.interp(blade_r, geom[:, 0], geom[:, 3])
    presweep = np.interp(blade_r, geom[:, 0], geom[:, 4])

    wt_ops = turbine["wt_ops"]
    wt_ops = wt_ops[ir] if isinstance(wt_ops, list) else wt_ops
    U = np.asarray(coerce(wt_ops, "v", shape=-1), dtype=float)
    Om = np.asarray(coerce(wt_ops, "omega_op", shape=-1), dtype=float)
    pit = np.asarray(coerce(wt_ops, "pitch_op", shape=-1), dtype=float)
    # parked extension
    U = np.r_[U, U.max() * 1.4, 100]
    Om = np.r_[Om, 0, 0]
    pit = np.r_[pit, 90, 90]

    # submerged (MHK) rotors use water properties
    if submerged:
        rho_fl = float(turbine.get("rho_water", 1025.0))
        mu_fl = float(turbine.get("mu_water", 1.0e-3))
        shear_fl = float(turbine.get("shearExp_water", 0.12))
    else:
        rho_fl = float(turbine.get("rho_air", 1.225))
        mu_fl = float(turbine.get("mu_air", 1.81e-5))
        shear_fl = float(turbine.get("shearExp_air", 0.12))
    model = RotorAeroModel(
        B=nBlades, Rhub=Rhub, Rtip=Rtip, precone=precone,
        shaft_tilt=shaft_tilt, rho=rho_fl, mu=mu_fl, shearExp=shear_fl,
        hubHt=float(hubHt), nSector=nSector,
        r=blade_r, chord=chord, theta_deg=theta,
        precurve=precurve, presweep=presweep,
        precurveTip=float(blade.get("precurveTip", 0.0)),
        presweepTip=float(blade.get("presweepTip", 0.0)),
        aoa_deg=aoa_dense, cl=cl_dense, cd=cd_dense, cpmin=cpm_dense,
        U_sched=U, Omega_sched=Om, pitch_sched=pit,
    )

    # control gains, optional
    if "pitch_control" in turbine:
        pc = turbine["pitch_control"]
        pc_angles = np.array(pc["GS_Angles"]) * RAD2DEG
        model.kp_0 = np.interp(pit, pc_angles, pc["GS_Kp"], left=0, right=0)
        model.ki_0 = np.interp(pit, pc_angles, pc["GS_Ki"], left=0, right=0)
        model.k_float = -pc["Fl_Kp"]
    if "torque_control" in turbine:
        model.kp_tau = -turbine["torque_control"]["VS_KP"]
        model.ki_tau = -turbine["torque_control"]["VS_KI"]
        model.Ng = turbine.get("gear_ratio", 1.0)
    model.I_drivetrain = float(coerce(turbine, "I_drivetrain",
                                      shape=nrotors, default=0.0)[ir])
    return model


def _curvature(r, precurve, presweep, precone):
    """Azimuthal-frame element coordinates, local cone angles and arc
    length (the blade-curvature definition of the reference's BEM)."""
    x_az = -r * np.sin(precone) + precurve * np.cos(precone)
    z_az = r * np.cos(precone) + precurve * np.sin(precone)
    y_az = presweep.copy() if hasattr(presweep, "copy") else presweep

    n = len(r)
    cone = np.zeros(n)
    cone[0] = np.arctan2(-(x_az[1] - x_az[0]), z_az[1] - z_az[0])
    cone[1:-1] = 0.5 * (
        np.arctan2(-(x_az[1:-1] - x_az[:-2]), z_az[1:-1] - z_az[:-2])
        + np.arctan2(-(x_az[2:] - x_az[1:-1]), z_az[2:] - z_az[1:-1])
    )
    cone[-1] = np.arctan2(-(x_az[-1] - x_az[-2]), z_az[-1] - z_az[-2])

    s = np.zeros(n)
    s[0] = r[0]
    s[1:] = s[0] + np.cumsum(
        np.sqrt(np.diff(x_az) ** 2 + np.diff(y_az) ** 2 + np.diff(z_az) ** 2)
    )
    return x_az, y_az, z_az, cone, s


def blade_hydro(turbine, ir, rprops, rho_water=1025.0, g=9.81):
    """Build-time hydrodynamic summary of a SUBMERGED rotor's blades
    about the rotor node: added mass ``A_hydro`` (6, 6), inertial
    excitation ``I_hydro`` (6, 6), buoyancy force and stiffness
    (``Fvec`` (6,), ``Cmat`` (6, 6)), displaced volume ``V`` and the hub
    offset ``r_hub`` (numpy).

    Blade elements are rectangular members (chord x relative thickness
    x chord cross-section) with the airfoils' added-mass coefficients,
    summed over the B blade azimuths; only submerged elements count.
    """
    from scipy.interpolate import PchipInterpolator

    blade = turbine["blade"]
    blade = blade[ir] if isinstance(blade, list) else blade
    nrotors = turbine.get("nrotors", 1)
    B = int(coerce(turbine, "nBlades", shape=nrotors, dtype=int)[ir])
    Rhub = float(coerce(turbine, "Rhub", shape=nrotors)[ir])
    Rtip = float(blade["Rtip"])
    nr = int(coerce(blade, "nr", default=20))
    dr = (Rtip - Rhub) / nr
    r_e = np.linspace(Rhub, Rtip, nr, endpoint=False) + dr / 2

    geom = np.array(blade["geometry"])
    chord = np.interp(r_e, geom[:, 0], geom[:, 1])
    twist = np.deg2rad(np.interp(r_e, geom[:, 0], geom[:, 2]))

    airfoils = turbine["airfoils"]
    names = [a["name"] for a in airfoils]
    thick = np.array([a["relative_thickness"] for a in airfoils])
    Ca_af = np.array([a.get("added_mass_coeff", [0.5, 1.0]) for a in airfoils])
    st_pos = np.array([a for [a, b] in blade["airfoils"]])
    st_thick = np.array([thick[names.index(b)]
                         for [a, b] in blade["airfoils"]])
    st_Ca = np.array([Ca_af[names.index(b)] for [a, b] in blade["airfoils"]])
    grid = (r_e - Rhub) / (Rtip - Rhub)
    t_rel = PchipInterpolator(st_pos, st_thick)(grid)
    Ca_e = PchipInterpolator(st_pos, st_Ca)(grid)  # (nr, 2) [edge, flap]

    V_e = chord * (t_rel * chord) * dr  # rectangular cross-section volume

    azimuths = np.deg2rad(np.asarray(coerce(
        turbine, "azimuths", shape=-1,
        default=list(np.arange(B) * 360.0 / B)), dtype=float))

    R_q0 = np.asarray(rprops.R_q0)
    q_hub = R_q0 @ np.array([1.0, 0.0, 0.0])       # shaft axis (global)
    r_hub = np.asarray(rprops.q_rel) * rprops.overhang  # hub wrt rotor node

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    A6 = np.zeros((6, 6))
    I6 = np.zeros((6, 6))
    Fvec = np.zeros(6)
    Cmat = np.zeros((6, 6))
    V_tot = 0.0
    for psi in azimuths:
        cpsi, spsi = np.cos(psi), np.sin(psi)
        for ie in range(nr):
            # span direction: the 'up' blade rotated by psi about the
            # shaft, in the hub frame, then to global
            u_loc = np.array([0.0, -spsi, cpsi])
            u = R_q0 @ u_loc
            e_t = np.cross(q_hub, u)
            e_t /= max(np.linalg.norm(e_t), 1e-12)
            th = twist[ie]
            p1 = e_t * np.cos(th) + q_hub * np.sin(th)   # chordwise
            p2 = np.cross(u, p1)                          # thickness dir
            r_el = r_hub + u * r_e[ie]

            zg = rprops.r_rel[2] + r_el[2]
            if zg >= 0:
                continue  # only submerged elements contribute
            A3 = rho_water * V_e[ie] * (
                Ca_e[ie, 0] * np.outer(p1, p1)
                + Ca_e[ie, 1] * np.outer(p2, p2))
            I3 = rho_water * V_e[ie] * (
                (1 + Ca_e[ie, 0]) * np.outer(p1, p1)
                + (1 + Ca_e[ie, 1]) * np.outer(p2, p2))
            A6 += tf.translate_matrix_3to6(t(A3), t(r_el)).numpy()
            H = tf.skew(t(r_el)).numpy()
            I6[:3, :3] += I3
            I6[3:, :3] += H.T @ I3
            W6, C6 = tf.weight_of_point_mass(-rho_water * V_e[ie], t(r_el),
                                             g=g)
            Fvec += W6.numpy()
            Cmat += C6.numpy()
            V_tot += V_e[ie]

    return dict(A_hydro=A6, I_hydro=I6, Fvec=Fvec, Cmat=Cmat, V=V_tot,
                r_hub=r_hub)


_KAIMAL_TABLE = None


def _kaimal_G_table():
    """Build-time float64 tabulation of the special-function combination
    of the rotor-averaged Kaimal spectrum,

        G(x) = L_1(x) - I_1(x) - 2/pi + (x/2) (-2 L_{-2}(x) + 2 I_2(x) + 1),

    on a dense log-spaced grid (scipy's ``modstruve`` and ``iv``), which
    the evaluation interpolates: ``(log x, G)``."""
    global _KAIMAL_TABLE
    if _KAIMAL_TABLE is None:
        from scipy.special import iv, modstruve

        x = np.logspace(-8, 5, 8192)
        with np.errstate(all="ignore"):
            G = (
                modstruve(1, x) - iv(1, x) - 2 / np.pi
                + (x / 2) * (-2 * modstruve(-2, x) + 2 * iv(2, x) + 1)
            )
        _KAIMAL_TABLE = (np.log(x), np.nan_to_num(G))
    return _KAIMAL_TABLE


def parse_turbulence(turbulence):
    """Static part of a case's turbulence spec: (I_ref, V_ref_cls,
    TurbMod); I_ref is None when the spec is a numeric TI."""
    V_ref_cls = 50.0
    I_ref = None
    TurbMod = "NTM"
    if isinstance(turbulence, str):
        cls = ""
        ch = ""
        for ch in turbulence:
            if ch in ("I", "V"):
                cls += ch
            else:
                break
        if cls:
            I_ref = {"A+": 0.18, "A": 0.16, "B": 0.14, "C": 0.12}[ch]
            V_ref_cls = {"I": 50.0, "II": 42.5, "III": 37.5, "IV": 30.0}[cls]
            TurbMod = turbulence.split("_")[1]
        else:
            I_ref = None  # numeric string: TI value
    return I_ref, V_ref_cls, TurbMod


# ----------------------------------------------------- evaluation tensors

@dataclass(frozen=True, eq=False)
class RotorTensors:
    """One rotor's constants as tensors on the evaluating device: the
    per-element blade data (nr,), the polar tables (nr, n_aoa) on the
    shared grid ``aoa_rad``, the curvature, the azimuths (nSector,), the
    operating schedule and gains, and the scalars."""

    B: int
    Rtip: float
    rho: float
    shearExp: float
    hubHt: float
    theta_deg: torch.Tensor
    chord: torch.Tensor
    sigma_p: torch.Tensor
    lc_tip: torch.Tensor
    lc_hub: torch.Tensor
    aoa_rad: torch.Tensor
    cl: torch.Tensor
    cd: torch.Tensor
    x_az: torch.Tensor
    y_az: torch.Tensor
    z_az: torch.Tensor
    cone: torch.Tensor
    s: torch.Tensor
    azimuths: torch.Tensor
    U_sched: torch.Tensor
    Omega_sched: torch.Tensor
    pitch_sched: torch.Tensor
    kp_0: torch.Tensor | None
    ki_0: torch.Tensor | None
    k_float: float
    kp_tau: float
    ki_tau: float
    Ng: float
    I_drivetrain: float


def rotor_tensors(rot, device, dtype=torch.float64):
    """:class:`RotorTensors` of a :class:`RotorAeroModel` on ``device``
    (the element constants computed in numpy, as the reference does)."""
    x_az, y_az, z_az, cone, s = _curvature(rot.r, rot.precurve, rot.presweep,
                                           rot.precone)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)

    return RotorTensors(
        B=int(rot.B), Rtip=float(rot.Rtip), rho=float(rot.rho),
        shearExp=float(rot.shearExp), hubHt=float(rot.hubHt),
        theta_deg=t(rot.theta_deg), chord=t(rot.chord),
        sigma_p=t(rot.B * rot.chord / (2.0 * np.pi * rot.r)),
        lc_tip=t(rot.B / 2.0 * (rot.Rtip - rot.r) / rot.r),
        lc_hub=t(rot.B / 2.0 * (rot.r - rot.Rhub) / rot.Rhub),
        aoa_rad=t(rot.aoa_deg * (np.pi / 180)), cl=t(rot.cl), cd=t(rot.cd),
        x_az=t(x_az), y_az=t(y_az), z_az=t(z_az), cone=t(cone), s=t(s),
        azimuths=torch.arange(rot.nSector, device=device, dtype=dtype)
        * (2 * np.pi / rot.nSector),
        U_sched=t(rot.U_sched), Omega_sched=t(rot.Omega_sched),
        pitch_sched=t(rot.pitch_sched), kp_0=t(rot.kp_0), ki_0=t(rot.ki_0),
        k_float=float(rot.k_float), kp_tau=float(rot.kp_tau),
        ki_tau=float(rot.ki_tau), Ng=float(rot.Ng),
        I_drivetrain=float(rot.I_drivetrain),
    )


def _as_tensors(rot, like):
    return rot if isinstance(rot, RotorTensors) else rotor_tensors(
        rot, like.device, like.dtype)


# ------------------------------------------------------------------- BEMT

def _signed_floor(x, floor):
    """``sign(x) * max(|x|, floor)`` with sign(0) = +1 (a divide guard
    that keeps the sign)."""
    s = torch.where(du.value(x) < 0, -1.0, 1.0)
    return s * du.maximum(du.abs_(x), floor)


def _induction(phi, el):
    """(a, a', 1 - a, 1 + a') at inflow angle ``phi`` for the elements
    ``el`` (theta, sigma_p, lc_tip, lc_hub, cl, cd, aoa).

    (1 - a) and (1 + a') are computed in algebraically exact reciprocal
    forms, not as 1 minus the induction factor: at the bracket ends k is
    O(1e10), and the subtractive form loses the residual's sign."""
    theta, sigma_p, lc_tip, lc_hub, cl_tab, cd_tab, aoa = el
    sphi, cphi = du.sin(phi), du.cos(phi)
    sphi_safe = _signed_floor(sphi, 1e-9)
    alpha = phi - theta
    cl = interp(alpha, aoa, cl_tab)
    cd = interp(alpha, aoa, cd_tab)
    cn = cl * cphi + cd * sphi
    ct = cl * sphi - cd * cphi
    # Prandtl losses
    Ftip = 2 / math.pi * du.arccos(
        du.clip(du.exp(-lc_tip / du.abs_(sphi_safe)), 0.0, 1.0))
    Fhub = 2 / math.pi * du.arccos(
        du.clip(du.exp(-lc_hub / du.abs_(sphi_safe)), 0.0, 1.0))
    F = du.maximum(Ftip * Fhub, 1e-6)
    k = sigma_p * cn / (4.0 * F * sphi_safe ** 2)
    kp = sigma_p * ct / (4.0 * F * sphi_safe * cphi)
    # axial induction: momentum / Buhl empirical (phi > 0), prop brake
    g2 = du.maximum(2 * F * k - F * (4.0 / 3 - F), 1e-12)
    g3 = 2 * F * k - (25.0 / 9 - 2 * F)
    g3v = du.value(g3)
    one_m_a_buhl = du.where(
        torch.abs(g3v) < 1e-6, 1.0 / (2.0 * du.sqrt(g2)),
        (F - 5.0 / 3 + du.sqrt(g2)) / _signed_floor(g3, 1e-6))
    one_m_a_mom = 1.0 / _signed_floor(1.0 + k, 1e-12)
    kv = du.value(k)
    one_m_a_pos = du.where(kv <= 2.0 / 3, one_m_a_mom, one_m_a_buhl)
    one_m_a_brake = du.where(kv > 1.0, 1.0 / _signed_floor(1.0 - k, 1e-12),
                             1.0)
    one_m_a = du.where(du.value(phi) > 0, one_m_a_pos, one_m_a_brake)
    one_p_ap = 1.0 / _signed_floor(1.0 - kp, 1e-12)
    return 1.0 - one_m_a, one_p_ap - 1.0, one_m_a, one_p_ap


def _residual(phi, Vx, Vy, el):
    """The Ning (2014) residual of the inflow angle."""
    _, _, one_m_a, one_p_ap = _induction(phi, el)
    sphi, cphi = du.sin(phi), du.cos(phi)
    one_m_a = _signed_floor(one_m_a, 1e-12)
    one_p_ap = _signed_floor(one_p_ap, 1e-12)
    return sphi / one_m_a - Vx / Vy * cphi / one_p_ap


def _solve_phi_primal(Vx, Vy, el):
    """The root on primal values: the bracket (eps, pi/2), or the
    propeller-brake bracket (pi/2, pi - eps) when the first has no sign
    change, halved 50 times (keeping ``f(mid) f(lo) > 0``), then 4
    Newton steps clipped to +-0.1 rad.  ``f(lo)`` is carried, not
    re-evaluated: it is the value the re-evaluation would give."""
    eps = 1e-6

    def f(phi):
        return _residual(phi, Vx, Vy, el)

    lo = torch.full_like(Vx, eps)
    hi = torch.full_like(Vx, math.pi / 2)
    r_lo, r_hi = f(lo), f(hi)
    use_main = r_lo * r_hi <= 0
    lo = torch.where(use_main, lo, math.pi / 2)
    hi = torch.where(use_main, hi, math.pi - eps)
    f_lo = torch.where(use_main, r_lo, r_hi)  # f(pi/2) is r_hi
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        same = f_mid * f_lo > 0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        f_lo = torch.where(same, f_mid, f_lo)
    phi = 0.5 * (lo + hi)
    one = torch.ones((1,) + phi.shape, dtype=phi.dtype, device=phi.device)
    for _ in range(N_NEWTON):
        r = f(Dual(phi, one))
        d = r.t[0]
        d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        phi = phi - torch.clamp(r.v / d, -0.1, 0.1)
    return phi


def _slope_floor(slope):
    """The tangent solve's signed floor of R'(phi*) at +-1e-8."""
    return torch.where(torch.abs(slope) < 1e-8,
                       torch.where(slope < 0, -1e-8, 1e-8), slope)


def _wind_components(rt, U, Omega, azimuth, tilt, yaw):
    """Element inflow velocities (Vx, Vy) in the blade-aligned frame:
    shear, tilt, yaw, azimuth and curvature.  U, Omega [rad/s], tilt,
    yaw: (R,) (U and Omega may be Duals); azimuth (nS,) -> (R, nS, nr)."""
    r3 = (slice(None), None, None)
    sy, cy = torch.sin(yaw)[r3], torch.cos(yaw)[r3]
    st, ct = torch.sin(tilt)[r3], torch.cos(tilt)[r3]
    sa, ca = torch.sin(azimuth)[:, None], torch.cos(azimuth)[:, None]
    sc, cc = torch.sin(rt.cone), torch.cos(rt.cone)
    x_az, y_az, z_az = rt.x_az, rt.y_az, rt.z_az

    height = (y_az * sa + z_az * ca) * ct - x_az * st
    V = _rows3(U) * (1.0 + height / rt.hubHt) ** rt.shearExp

    Vwind_x = V * ((cy * st * ca + sy * sa) * sc + cy * ct * cc)
    Vwind_y = V * (cy * st * sa - sy * ca)
    Om = _rows3(Omega)
    Vrot_x = -Om * y_az * sc
    Vrot_y = Om * z_az
    return Vwind_x + Vrot_x, Vwind_y + Vrot_y


def _rows3(x):
    """(R,) -> (R, 1, 1), tangents kept on their leading axis."""
    return du.linear(x, lambda a: a[..., None, None])


def _trapz(y, s):
    """``jnp.trapezoid(y, s)`` over the last axis."""
    return 0.5 * ((s[1:] - s[:-1]) * (y[..., 1:] + y[..., :-1])).sum(-1)


def _hub_loads(rt, Np, Tp):
    """Distributed normal and tangential loads (R, nS, nr) -> the
    azimuth-averaged hub loads [T, Y, Z, Q, My, Mz] (R, 6)."""
    ccf, scf = torch.cos(rt.cone), torch.sin(rt.cone)
    fx = Np * ccf
    fy = Tp
    fz = Np * scf

    def integ(y):
        return du.linear(y, lambda a: _trapz(a, rt.s))

    Fx, Fy, Fz = integ(fx), integ(fy), integ(fz)
    mx = rt.y_az * fz - rt.z_az * fy
    my = rt.z_az * fx - rt.x_az * fz
    mz = rt.x_az * fy - rt.y_az * fx
    Mx, My, Mz = integ(mx), integ(my), integ(mz)
    sa, ca = torch.sin(rt.azimuths), torch.cos(rt.azimuths)
    F_h = du.stack([Fx, ca * Fy - sa * Fz, sa * Fy + ca * Fz], dim=-1)
    M_h = du.stack([Mx, ca * My - sa * Mz, sa * My + ca * Mz], dim=-1)
    F = rt.B * du.linear(F_h, lambda a: a.mean(dim=-2))
    M = rt.B * du.linear(M_h, lambda a: a.mean(dim=-2))

    def col(x, i):
        return du.linear(x, lambda a: a[..., i])

    return du.stack([col(F, 0), col(F, 1), col(F, 2), -col(M, 0), col(M, 1),
                     col(M, 2)], dim=-1)


def _elements(rt, pitch_deg):
    """The per-element constants of the residual with the blade twist
    at ``pitch_deg`` (R,) (may be a Dual): theta (R, 1, nr)."""
    theta = (rt.theta_deg + _rows3(pitch_deg)) * (math.pi / 180)
    return (theta, rt.sigma_p, rt.lc_tip, rt.lc_hub, rt.cl, rt.cd,
            rt.aoa_rad)


def _element_loads(rt, phi, Vx, Vy, el):
    """Normal and tangential load per unit span at the root ``phi``."""
    theta = el[0]
    _, _, one_m_a, one_p_ap = _induction(phi, el)
    sphi, cphi = du.sin(phi), du.cos(phi)
    alpha = phi - theta
    cl = interp(alpha, rt.aoa_rad, rt.cl)
    cd = interp(alpha, rt.aoa_rad, rt.cd)
    cn = cl * cphi + cd * sphi
    ct = cl * sphi - cd * cphi
    W2 = (Vx * one_m_a) ** 2 + (Vy * one_p_ap) ** 2
    qdyn = 0.5 * rt.rho * W2 * rt.chord
    return cn * qdyn, ct * qdyn


def _inflow(rt, U, Omega_rpm, pitch_deg, tilt, yaw):
    Omega = Omega_rpm * math.pi / 30.0
    Vx, Vy = _wind_components(rt, U, Omega, rt.azimuths, tilt, yaw)
    return Vx, Vy, _elements(rt, pitch_deg)


def rotor_loads(rot, Uinf, Omega_rpm, pitch_deg, tilt, yaw):
    """Azimuthally averaged hub loads [T, Y, Z, Q, My, Mz] (R, 6) of R
    operating points (each argument (R,); tilt and yaw in radians)."""
    rt = _as_tensors(rot, Uinf)
    Vx, Vy, el = _inflow(rt, Uinf, Omega_rpm, pitch_deg, tilt, yaw)
    phi = _solve_phi_primal(Vx, Vy, el)
    return _hub_loads(rt, *_element_loads(rt, phi, Vx, Vy, el))


def _unit(x, i, k=4):
    """Tangents of ``k`` directions on the shape of ``x``: one in
    direction ``i``, zero in the others."""
    t = torch.zeros((k,) + x.shape, dtype=x.dtype, device=x.device)
    t[i] = 1.0
    return t


def _seed(x, i, k):
    """``x`` as a Dual with the unit tangent in direction ``i`` of ``k``."""
    return Dual(x, _unit(x, i, k))


def _pad_tangents(x, k):
    """A Dual's tangents padded with zero directions up to ``k``."""
    extra = torch.zeros((k - x.t.shape[0],) + x.t.shape[1:],
                        dtype=x.t.dtype, device=x.t.device)
    return Dual(x.v, torch.cat([x.t, extra]))


def rotor_loads_and_derivs(rot, Uinf, Omega_rpm, pitch_deg, tilt, yaw):
    """Loads (R, 6) plus dT and dQ (R, 3) with respect to (U,
    Omega_rpm, pitch_deg), the implicit-function tangent of the root
    carried by hand.

    One residual evaluation with four tangent directions (the three
    parameters and phi itself) gives dR/dp and R'(phi*) at the root;
    ``dphi = -(dR/dp) / floor(R'(phi*))`` then seeds phi's tangents
    through the load integrals.

    Reverse and forward mode: with an inflow input being differentiated
    (it requires grad, or carries a ``torch.func.jvp`` / ``jacfwd``
    tangent), the root enters through :class:`_RootPhi`, whose backward
    and jvp are the implicit rule with the reference's slope floor (its
    ``tangent_solve``), never through the bisection and Newton steps.
    The transform then differentiates the hand tangents as well,
    through the attached root: the second derivatives of the
    reference's reverse or forward mode over its ``jacfwd``.  The values
    are those of the plain path, bit for bit."""
    rt = _as_tensors(rot, Uinf)
    U, Om, pit = (_seed(x, i, 3) for i, x in
                  enumerate((Uinf, Omega_rpm, pitch_deg)))
    Vx, Vy, el = _inflow(rt, U, Om, pit, tilt, yaw)
    if ad.differentiated(Vx.v, Vy.v, el[0].v):
        phi, _ = _RootPhi.apply(Vx.v, Vy.v, el[0].v, el[1:])
    else:
        phi = _solve_phi_primal(Vx.v, Vy.v, tuple(du.value(e) for e in el))

    # dR/dp (3 directions) and dR/dphi (the 4th) at the root
    phi4 = _seed(phi, 3, 4)
    el4 = (_pad_tangents(el[0], 4),) + el[1:]
    r = _residual(phi4, _pad_tangents(Vx, 4), _pad_tangents(Vy, 4), el4)
    dphi = -(r.t[:3] / _slope_floor(r.t[3]))
    loads = _hub_loads(rt, *_element_loads(rt, Dual(phi, dphi), Vx, Vy, el))
    dT = loads.t[..., 0].transpose(0, 1)
    dQ = loads.t[..., 3].transpose(0, 1)
    return loads.v, dT, dQ


class _RootPhi(torch.autograd.Function):
    """The inflow-angle root as a function of (Vx, Vy, theta), with the
    implicit-function derivative ``dphi = -(dR/d(Vx, Vy, theta)) /
    floor(R'(phi*))`` as its forward-mode tangent (the oracle's form)
    and, transposed, as its backward (the reverse mode's); the floor is
    the reference's ``tangent_solve`` one, +-1e-8.  The second output
    holds those four residual derivatives at the root."""

    generate_vmap_rule = True

    @staticmethod
    def forward(Vx, Vy, theta, rt_el):
        el = (theta,) + tuple(rt_el)
        with torch.no_grad():
            phi = _solve_phi_primal(Vx, Vy, el)
            th = theta.expand_as(Vx)
            # dR/d(Vx, Vy, theta) and R'(phi) at the root
            r = _residual(_seed(phi, 3, 4), _seed(Vx, 0, 4),
                          _seed(Vy, 1, 4), (_seed(th, 2, 4),) + tuple(rt_el))
        return phi, r.t

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output[1])
        ctx.save_for_backward(output[1])
        ctx.theta_shape = inputs[2].shape

    @staticmethod
    def jvp(ctx, dVx, dVy, dtheta, _):
        (g,) = ctx.saved_tensors
        rhs = torch.zeros_like(g[0])
        for gi, d in zip(g, (dVx, dVy, dtheta)):
            if d is not None:
                rhs = rhs + gi * d
        return -(rhs / _slope_floor(g[3])), torch.zeros_like(g)

    @staticmethod
    def backward(ctx, phi_bar, _):
        (g,) = ctx.saved_tensors
        c = -phi_bar / _slope_floor(g[3])
        need = ctx.needs_input_grad
        return (c * g[0] if need[0] else None, c * g[1] if need[1] else None,
                (c * g[2]).sum_to_size(ctx.theta_shape) if need[2] else None,
                None)


def rotor_loads_and_derivs_jacfwd(rot, Uinf, Omega_rpm, pitch_deg, tilt,
                                  yaw):
    """The oracle of :func:`rotor_loads_and_derivs`: ``torch.func.jacfwd``
    of the loads in (U, Omega_rpm, pitch_deg), row by row under
    ``torch.func.vmap``, with the root's implicit tangent supplied by
    :class:`_RootPhi`."""
    rt = _as_tensors(rot, Uinf)

    def loads_one(p, tl, yw):
        U, Om, pit = p[0:1], p[1:2], p[2:3]
        Vx, Vy, el = _inflow(rt, U, Om, pit, tl[None], yw[None])
        phi, _ = _RootPhi.apply(Vx, Vy, el[0], el[1:])
        return _hub_loads(rt, *_element_loads(rt, phi, Vx, Vy, el))[0]

    def both(p, tl, yw):
        out = loads_one(p, tl, yw)
        return out, out

    p = torch.stack([Uinf, Omega_rpm, pitch_deg], dim=-1)
    jac, loads = torch.func.vmap(torch.func.jacfwd(both, has_aux=True))(
        p, tilt, yaw)
    return loads, jac[:, 0, :], jac[:, 3, :]


def operating_point(rot, Uhub):
    """Scheduled rotor speed [rpm] and blade pitch [deg] at hub speeds
    ``Uhub`` (R,)."""
    rt = _as_tensors(rot, Uhub)
    return (interp(Uhub, rt.U_sched, rt.Omega_sched),
            interp(Uhub, rt.U_sched, rt.pitch_sched))


# ------------------------------------------------------------- calc aero

def kaimal_rot_psd_traced(w, V_ref, I_ref, hub_height, R_rot,
                          TurbMod="NTM", V_ref_cls=50.0):
    """Rotor-averaged IEC Kaimal PSD of the longitudinal turbulence,
    (R, nw) for rows of V_ref and I_ref (R,), with the special-function
    combination interpolated from :func:`_kaimal_G_table`."""
    f = w / (2 * math.pi)
    HH = abs(float(hub_height))
    V_ref = V_ref[:, None]
    I_ref = I_ref[:, None]

    if TurbMod == "NTM":
        sigma_1 = I_ref * (0.75 * V_ref + 5.6)
    elif TurbMod == "ETM":
        V_ave = V_ref_cls * 0.2
        sigma_1 = 2 * I_ref * (0.072 * (V_ave / 2 + 3) * (V_ref / 2 - 4) + 10)
    elif TurbMod == "EWM":
        sigma_1 = 0.11 * V_ref
    else:
        raise ValueError(f"unsupported turbulence model {TurbMod}")

    L_1 = 0.7 * HH if HH <= 60 else 42.0
    L_u = 8.1 * L_1
    U = (4 * L_u / V_ref) * sigma_1 ** 2 / (
        (1 + 6 * f * L_u / V_ref) ** (5.0 / 3.0))
    kappa = 12 * torch.sqrt((f / V_ref) ** 2 + (0.12 / L_u) ** 2)
    t = R_rot * kappa
    logx, G = (torch.as_tensor(a, dtype=w.dtype, device=w.device)
               for a in _kaimal_G_table())
    Gx = interp(torch.log(torch.clamp(2 * t, min=1e-300)), logx, G)
    t_safe = torch.where(t == 0, 1.0, t)
    return torch.where(t == 0, 0.0, 2 * U / t_safe ** 3 * Gx)


def calc_aero_traced(rot, rprops, w, speed, heading_rad, TI,
                     yaw_command_rad=None, turbine_heading_rad=None,
                     turb_static=("NTM", 50.0), dw=None):
    """Aero-servo coefficients about the rotor node for R rows of
    (speed, heading_rad, TI, yaw_command_rad), each (R,).

    Returns (f0 (R, 6), f (R, 6, nw) complex, a (R, 6, 6, nw),
    b (R, 6, 6, nw), B_gyro (R, 6, 6), q (R, 3), Omega_rpm (R,),
    pitch_deg (R,)): the mean load, the turbulence excitation, the
    aerodynamic added mass and damping (aeroServoMod 1: the thrust
    slope; 2: with the PI pitch/torque control transfer function), the
    gyroscopic damping and the rotor axis, with the operating point
    they were taken at.  ``dw``, the grid's bin width (default ``w[1] -
    w[0]``), is given where ``w`` is a slice of the grid."""
    rt = _as_tensors(rot, speed)
    nw = w.shape[0]
    R = speed.shape[0]
    if dw is None:
        dw = w[1] - w[0]
    zero = torch.zeros_like(speed)
    yaw_cmd = zero if yaw_command_rad is None else yaw_command_rad
    turb_head = zero if turbine_heading_rad is None else turbine_heading_rad
    yaw_mode = getattr(rprops, "yaw_mode", 0)
    if yaw_mode == 0:
        yaw = heading_rad + yaw_cmd
    elif yaw_mode == 1:
        yaw = turb_head
    elif yaw_mode in (2, 3):
        yaw = yaw_cmd
    else:
        raise ValueError("unsupported yaw_mode")

    R_q = tf.rotation_matrix(zero, torch.full_like(speed, -rprops.shaft_tilt),
                             rprops.shaft_toe + yaw)               # (R, 3, 3)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=speed.dtype, device=speed.device)
    q = R_q @ e1
    yaw_misalign = torch.atan2(q[:, 1], q[:, 0]) - heading_rad
    turbine_tilt = torch.atan2(q[:, 2], torch.hypot(q[:, 0], q[:, 1]))

    Om, pit = operating_point(rt, speed)
    loads, dT, dQ = rotor_loads_and_derivs(rt, speed, Om, pit, -turbine_tilt,
                                           yaw_misalign)
    dT_dU, dT_dOm, dT_dPi = dT[:, 0], dT[:, 1] / RPM2RADPS, dT[:, 2] * RAD2DEG
    dQ_dU, dQ_dOm, dQ_dPi = dQ[:, 0], dQ[:, 1] / RPM2RADPS, dQ[:, 2] * RAD2DEG

    f0 = torch.cat([R_q @ loads[:, :3, None], R_q @ loads[:, 3:, None]],
                   dim=1)[..., 0]

    TurbMod, V_ref_cls = turb_static
    S_rot = kaimal_rot_psd_traced(w, speed, TI, rprops.Zhub, rt.Rtip,
                                  TurbMod=TurbMod, V_ref_cls=V_ref_cls)
    cdt = compute_dtypes(S_rot, w)[1]
    V_w = torch.sqrt(2 * S_rot * dw).to(cdt)                       # (R, nw)

    qq = tf.vec_vec_trans(q)                                       # (R, 3, 3)
    c1 = (slice(None), None)
    if rprops.aeroServoMod == 1:
        a2 = torch.zeros((R, nw), dtype=speed.dtype, device=speed.device)
        b2 = dT_dU[c1].expand(R, nw)
        f2 = dT_dU[c1] * V_w
    elif rprops.aeroServoMod == 2:
        kp_beta = -interp(speed, rt.U_sched, rt.kp_0)[c1]
        ki_beta = -interp(speed, rt.U_sched, rt.ki_0)[c1]
        kp_tau = rt.kp_tau * (kp_beta == 0)
        ki_tau = rt.ki_tau * (ki_beta == 0)
        zhub = rprops.Zhub
        dT_dU, dT_dOm, dT_dPi = dT_dU[c1], dT_dOm[c1], dT_dPi[c1]
        dQ_dU, dQ_dOm, dQ_dPi = dQ_dU[c1], dQ_dOm[c1], dQ_dPi[c1]
        H_QT = ((dT_dOm + kp_beta * dT_dPi) * 1j * w + ki_beta * dT_dPi) / (
            rt.I_drivetrain * w ** 2
            + (dQ_dOm + kp_beta * dQ_dPi - rt.Ng * kp_tau) * 1j * w
            + ki_beta * dQ_dPi - rt.Ng * ki_tau
        )
        f2 = (dT_dU - H_QT * dQ_dU) * V_w
        resp = (dT_dU - rt.k_float * dT_dPi / zhub
                - H_QT * (dQ_dU - rt.k_float * dQ_dPi / zhub))
        b2 = torch.real(resp)
        a2 = torch.real(resp / (1j * w))
    else:
        a2 = torch.zeros((R, nw), dtype=speed.dtype, device=speed.device)
        b2 = a2
        f2 = torch.zeros((R, nw), dtype=cdt, device=speed.device)

    a6 = torch.zeros((R, nw, 6, 6), dtype=speed.dtype, device=speed.device)
    b6 = torch.zeros_like(a6)
    f6 = torch.zeros((R, nw, 6), dtype=cdt, device=speed.device)
    a6[:, :, :3, :3] = a2[..., None, None] * qq[:, None]
    b6[:, :, :3, :3] = b2[..., None, None] * qq[:, None]
    f6[:, :, :3] = f2[..., None] * q[:, None, :]

    # shift from the hub to the rotor node
    r_off = q * rprops.overhang
    f0 = tf.transform_force_6(f0, r_off)
    a6 = tf.translate_matrix_6to6(a6, r_off[:, None])
    b6 = tf.translate_matrix_6to6(b6, r_off[:, None])
    f6 = tf.transform_force_6(f6, r_off[:, None])

    # gyroscopic damping
    IO = q * (rprops.I_drivetrain * Om * 2 * math.pi / 60)[:, None]
    B_gyro = torch.zeros((R, 6, 6), dtype=speed.dtype, device=speed.device)
    B_gyro[:, 3:, 3:] = tf.skew(IO)

    return (f0, f6.movedim(1, -1), a6.movedim(1, -1), b6.movedim(1, -1),
            B_gyro, q, Om, pit)


# ------------------------------------------- case-setup aero (untraced)

def kaimal_rot_psd(w, V_ref, turbulence, hub_height, R_rot):
    """Rotor-averaged IEC Kaimal PSD of the longitudinal turbulence
    [(m/s)^2/(rad/s)] at the frequencies ``w`` (numpy), the reference's
    ``kaimal_rot_psd``: host numpy and scipy's special functions (``iv``,
    ``modstruve``), as the case setup of the orchestrated path takes it.
    ``turbulence`` is a TI fraction or an IEC class string such as
    ``"IB_NTM"``."""
    from scipy.special import iv, modstruve

    f = np.asarray(w) / 2 / np.pi
    HH = abs(hub_height)
    V_ref_cls = 50.0
    I_ref = 0.16
    TurbMod = "NTM"
    if isinstance(turbulence, str):
        cls = ""
        for ch in turbulence:
            if ch in ("I", "V"):
                cls += ch
            else:
                break
        if not cls:
            turbulence = float(turbulence)
        else:
            I_ref = {"A+": 0.18, "A": 0.16, "B": 0.14, "C": 0.12}[ch]
            V_ref_cls = {"I": 50.0, "II": 42.5, "III": 37.5, "IV": 30.0}[cls]
            TurbMod = turbulence.split("_")[1]
    if isinstance(turbulence, (int, float)):
        I_ref = float(turbulence)
        TurbMod = "NTM"

    if TurbMod == "NTM":
        sigma_1 = I_ref * (0.75 * V_ref + 5.6)
    elif TurbMod == "ETM":
        V_ave = V_ref_cls * 0.2
        sigma_1 = 2 * I_ref * (0.072 * (V_ave / 2 + 3) * (V_ref / 2 - 4) + 10)
    elif TurbMod == "EWM":
        sigma_1 = 0.11 * V_ref
    else:
        raise ValueError(f"unsupported turbulence model {TurbMod}")

    L_1 = 0.7 * HH if HH <= 60 else 42.0
    L_u = 8.1 * L_1
    U = (4 * L_u / V_ref) * sigma_1 ** 2 / (
        (1 + 6 * f * L_u / V_ref) ** (5.0 / 3.0))
    kappa = 12 * np.sqrt((f / V_ref) ** 2 + (0.12 / L_u) ** 2)
    x = 2 * R_rot * kappa
    with np.errstate(all="ignore"):
        Rot = (2 * U / (R_rot * kappa) ** 3) * (
            modstruve(1, x) - iv(1, x) - 2 / np.pi
            + R_rot * kappa * (-2 * modstruve(-2, x) + 2 * iv(2, x) + 1))
    Rot[np.isnan(Rot)] = 0
    return Rot


def _row(x, device):
    return torch.tensor([float(x)], dtype=torch.float64, device=device)


def _np_rotation(x3, x2, x1):
    return tf.rotation_matrix(*(torch.tensor(float(a), dtype=torch.float64)
                                for a in (x3, x2, x1))).numpy()


def calc_aero(rot, rprops, case, w, speed=None, platform_heading=0.0,
              current=False, device=None):
    """Aero-servo coefficients of one rotor about its node in the global
    frame for one load case (the reference's untraced ``calc_aero``, the
    case setup of the orchestrated path): yaw modes 0-3, ``aeroServoMod``
    1 (thrust slope) and 2 (the PI pitch/torque control transfer
    functions), the rotor channels' transfer-function data and the shift
    from the hub to the rotor node.

    The blade-element solve and its derivatives run as one row of
    :func:`rotor_loads_and_derivs` on ``device`` (default: the current
    CUDA device; raises without one); the rest is host
    numpy, per frequency as the reference loops.  A submerged rotor
    (``current``) sees the case's current, others its wind.  Returns
    (f0 (6,), f (6, nw) complex, a (6, 6, nw), b (6, 6, nw), info) as
    numpy, info holding the loads, derivatives, operating point, the
    rotor-averaged inflow amplitudes V_w, R_q, q and the channel data
    C, kp_*, ki_*, aero_torque and aero_power."""
    w = np.asarray(w, dtype=float)
    nw = len(w)
    if current:
        if speed is None:
            speed = float(coerce(case, "current_speed", shape=0, default=1.0))
        heading = float(coerce(case, "current_heading", shape=0,
                               default=0.0))
    else:
        if speed is None:
            speed = float(coerce(case, "wind_speed", shape=0, default=10))
        heading = float(coerce(case, "wind_heading", shape=0, default=0.0))
    yaw_command = float(coerce(case, "yaw_misalign", shape=0, default=0.0))
    turbine_heading = float(coerce(case, "turbine_heading", shape=0,
                                   default=0.0))
    yaw_mode = getattr(rprops, "yaw_mode", 0)
    inflow_heading = np.radians(heading)
    if yaw_mode == 0:
        yaw = inflow_heading - platform_heading + np.radians(yaw_command)
    elif yaw_mode == 1:
        yaw = np.radians(turbine_heading) - platform_heading
    elif yaw_mode == 2:
        yaw = np.radians(yaw_command)
    elif yaw_mode == 3:
        yaw = np.radians(yaw_command) - platform_heading
    else:
        raise ValueError("unsupported yaw_mode")

    R_q = _np_rotation(0.0, -rprops.shaft_tilt, rprops.shaft_toe + yaw)
    q = R_q @ np.array([1.0, 0.0, 0.0])
    yaw_misalign = np.arctan2(q[1], q[0]) - inflow_heading
    turbine_tilt = np.arctan2(q[2], np.hypot(q[0], q[1]))

    device = resolve_device(device)
    rt = rotor_tensors(rot, device)
    U = _row(speed, device)
    Om_t, pit_t = operating_point(rt, U)
    Om, pit = float(Om_t[0]), float(pit_t[0])
    loads, dT, dQ = rotor_loads_and_derivs(
        rt, U, _row(Om, device), _row(pit, device),
        _row(-turbine_tilt, device), _row(yaw_misalign, device))
    loads, dT, dQ = (x[0].cpu().numpy() for x in (loads, dT, dQ))

    dT_dU, dT_dOm, dT_dPi = dT[0], dT[1] / RPM2RADPS, dT[2] * RAD2DEG
    dQ_dU, dQ_dOm, dQ_dPi = dQ[0], dQ[1] / RPM2RADPS, dQ[2] * RAD2DEG

    f0 = np.zeros(6)
    f0[:3] = R_q @ loads[:3]
    f0[3:] = R_q @ loads[3:]

    turbulence = (case.get("current_turbulence", 0.0) if current
                  else case.get("turbulence", 0.0))
    S_rot = kaimal_rot_psd(w, speed, turbulence, rprops.Zhub, rot.Rtip)
    V_w = np.sqrt(2 * S_rot * (w[1] - w[0])).astype(np.complex128)

    a = np.zeros((6, 6, nw))
    b = np.zeros((6, 6, nw))
    f = np.zeros((6, nw), dtype=np.complex128)
    chan = dict(C=np.zeros(nw, dtype=np.complex128), kp_beta=0.0,
                ki_beta=0.0, kp_tau=0.0, ki_tau=0.0,
                aero_torque=float(loads[3]),
                aero_power=float(loads[3] * Om * 2 * np.pi / 60.0))
    Rq_t = torch.as_tensor(R_q)
    if rprops.aeroServoMod == 1:
        b_in = np.zeros((nw, 6, 6))
        b_in[:, 0, 0] = dT_dU
        b = np.moveaxis(tf.rotate_matrix_6(torch.as_tensor(b_in),
                                           Rq_t).numpy(), 0, -1).copy()
        f_in = np.zeros((6, nw), dtype=np.complex128)
        f_in[0, :] = dT_dU * V_w
        f[:3, :] = R_q @ f_in[:3, :]
    elif rprops.aeroServoMod == 2:
        kp_beta = -np.interp(speed, rot.U_sched, rot.kp_0)
        ki_beta = -np.interp(speed, rot.U_sched, rot.ki_0)
        kp_tau = rot.kp_tau * (kp_beta == 0)
        ki_tau = rot.ki_tau * (ki_beta == 0)
        zhub = rprops.Zhub
        Dden = (rot.I_drivetrain * w ** 2
                + (dQ_dOm + kp_beta * dQ_dPi - rot.Ng * kp_tau) * 1j * w
                + ki_beta * dQ_dPi - rot.Ng * ki_tau)
        chan.update(
            C=1j * w * (dQ_dU - rot.k_float * dQ_dPi / zhub) / Dden,
            kp_beta=float(kp_beta), ki_beta=float(ki_beta),
            kp_tau=float(kp_tau), ki_tau=float(ki_tau))
        H_QT = ((dT_dOm + kp_beta * dT_dPi) * 1j * w
                + ki_beta * dT_dPi) / Dden
        f2 = (dT_dU - H_QT * dQ_dU) * V_w
        resp = (dT_dU - rot.k_float * dT_dPi / zhub
                - H_QT * (dQ_dU - rot.k_float * dQ_dPi / zhub))
        b2 = np.real(resp)
        a2 = np.real(resp / (1j * w))
        for iw in range(nw):
            a[:3, :3, iw] = R_q @ np.diag([a2[iw], 0, 0]) @ R_q.T
            b[:3, :3, iw] = R_q @ np.diag([b2[iw], 0, 0]) @ R_q.T
            f[:3, iw] = R_q @ np.array([f2[iw], 0, 0])

    # shift from the hub to the rotor node
    r_off = torch.as_tensor(q * rprops.overhang)
    f0 = tf.transform_force_6(torch.as_tensor(f0), r_off).numpy()
    a = np.moveaxis(tf.translate_matrix_6to6(
        torch.as_tensor(np.moveaxis(a, -1, 0)), r_off).numpy(), 0, -1)
    b = np.moveaxis(tf.translate_matrix_6to6(
        torch.as_tensor(np.moveaxis(b, -1, 0)), r_off).numpy(), 0, -1)
    f = tf.transform_force_6(torch.as_tensor(f.T), r_off.to(
        torch.complex128)).numpy().T
    return f0, f, a, b, dict(loads=loads, dT=dT, dQ=dQ, Omega_rpm=Om,
                             pitch_deg=pit, V_w=V_w, R_q=R_q, q=q, **chan)


def calc_cavitation(rot, rprops, case, Patm=101325.0, Pvap=2300.0,
                    rho=1025.0, g=9.81, device=None):
    """Cavitation margin per (azimuth, element) of a submerged rotor at
    the case's current (the reference's ``calc_cavitation``):
    ``sigma_crit = (Patm + rho g |z| - Pvap) / (0.5 rho W^2)`` plus the
    element's ``cpmin`` at its angle of attack; negative means
    cavitation.  The inflow roots run as one row of the blade-element
    solve on ``device`` (every azimuth and element at once; default:
    the current CUDA device, raising without one).  None
    without ``cpmin`` polars (the fifth column of the airfoil tables);
    else (nSector, nr) numpy."""
    if rot.cpmin is None:
        return None
    speed = float(coerce(case, "current_speed", shape=0, default=1.0))
    device = resolve_device(device)
    rt = rotor_tensors(rot, device)
    Om_t, pit_t = operating_point(rt, _row(speed, device))
    Om, pit = float(Om_t[0]), float(pit_t[0])
    Omega = Om * np.pi / 30.0
    Vx, Vy = _wind_components(rt, _row(speed, device), _row(Omega, device),
                              rt.azimuths, _row(-rprops.shaft_tilt, device),
                              _row(0.0, device))
    el = _elements(rt, _row(pit, device))
    phi = _solve_phi_primal(Vx, Vy, el)
    a, ap, _, _ = _induction(phi, el)
    Vx, Vy, phi, a, ap = (x[0].cpu().numpy() for x in (Vx, Vy, phi, a, ap))
    W2 = (Vx * (1 - a)) ** 2 + (Vy * (1 + ap)) ** 2
    alpha = np.degrees(phi) - (rot.theta_deg + pit)
    cpmin = np.stack([
        np.interp(alpha[:, ie], rot.aoa_deg, rot.cpmin[ie])
        for ie in range(len(rot.r))], axis=1)
    _, _, z_az, _, _ = _curvature(rot.r, rot.precurve, rot.presweep,
                                  rot.precone)
    az = np.arange(rot.nSector) * 2 * np.pi / rot.nSector
    zrel = z_az[None, :] * np.cos(az)[:, None] * np.cos(rprops.shaft_tilt)
    depth = np.abs(rprops.Zhub + zrel)
    sigma_crit = (Patm + rho * g * depth - Pvap) / (
        0.5 * rho * np.maximum(W2, 1e-9))
    return sigma_crit + cpmin
