"""Quasi-static catenary mooring (torch counterpart of the main-path
subset of ``raft_tpu/physics/mooring.py``): the inline-schema builder,
the catenary solve and the body force and stiffness, the MoorDyn and
bathymetry readers and the shared-mooring network of an array
(:class:`MooringNetwork`).

Every function is elementwise over any batch of lines (rows x lines on
the bucket path), so one call solves every line of every row.  The
reference's guards are kept exactly: ``_profile`` clamps ``HF``, and a
Newton step that is not finite is rejected.

The bucket's mooring stiffness is the reference's ``-jax.jacfwd`` of
the line force: forward-mode AD *through* the 60-step catenary Newton
loop, not an implicit derivative.  Two functions compute it through the
same loop:

* :func:`stiffness_jacfwd`, the reference's form: ``-torch.func.jacfwd``
  of the masked force, vmapped over rows;
* :func:`line_forces_and_stiffness`, the bucket path's: the same six
  tangents carried by hand as :class:`Dual` numbers, one plain op per
  tangent op, without ``torch.func``'s per-op dispatch through its
  transform layers (``chip_smoke.py`` times both on the card and holds
  one against the other).

Two parts of the loop carry no tangent and run on primal values only in
the :class:`Dual` form: the backtracking search, whose output is a step
length from {1, 1/2, ..., 1/16}, and the finiteness test.  The Newton
Jacobian of the profile is written out analytically in both.

Neither reverse nor forward mode (``torch.func.jvp``, ``jacfwd``) sees
the Newton loop: it runs on detached inputs.
:func:`line_forces_at_root` takes the converged fairlead loads (HF, VF)
and attaches them to the pose and to L, w, EA by the implicit rule at
the root, with the 2 x 2 profile Jacobian; the force and stiffness
written from them have the forward's values (to rounding) and exact
first derivatives there.  :func:`line_forces_and_stiffness` returns the
forward's values with those derivatives whenever an input is being
differentiated (:func:`raft_tpu_torch.utils.ad.differentiated`).  The
reference tapes its loop, so the two agree to the catenary's
convergence.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.ops import transforms as tf
from raft_tpu_torch.ops.dual import Dual
from raft_tpu_torch.ops.dual import abs_ as _abs
from raft_tpu_torch.ops.dual import asinh as _asinh
from raft_tpu_torch.ops.dual import clamp_min as _clamp_min
from raft_tpu_torch.ops.dual import maximum as _maximum
from raft_tpu_torch.ops.dual import sqrt as _sqrt
from raft_tpu_torch.ops.dual import tanh as _tanh
from raft_tpu_torch.ops.dual import value as _v
from raft_tpu_torch.ops.dual import where as _where
from raft_tpu_torch.structure.schema import coerce
from raft_tpu_torch.utils import ad


@dataclass(frozen=True)
class MooringSystem:
    """One body's quasi-static catenary mooring: numpy arrays from
    :func:`build_mooring`, or tensors on the evaluating device (``L``
    may then carry a leading row axis, one line-length set per row)."""

    r_anchor: object        # (nL, 3) fixed anchor coordinates
    r_fair0: object         # (nL, 3) fairlead coordinates at zero pose
    L: object               # (nL,) or (R, nL) unstretched lengths
    w: object               # (nL,) submerged weight per length [N/m]
    EA: object              # (nL,) axial stiffness [N]
    depth: float
    moorMod: int = 0
    # line-dynamics properties (``moorMod`` 1 or 2, read by
    # physics/mooring_dynamics.py); the quasi-static path reads none
    m_lin: object = None    # (nL,) mass per length
    d_vol: object = None    # (nL,) volume-equivalent diameter
    Cd: object = None       # transverse drag
    Ca: object = None       # transverse added mass
    CdAx: object = None     # tangential drag
    CaAx: object = None     # tangential added mass
    BA: object = None       # internal damping [N-s], < 0 = -zeta

    @property
    def n_lines(self):
        return self.r_anchor.shape[0]

    def to(self, device, dtype=torch.float64):
        """The same system with every catenary array a tensor on
        ``device`` (the line-dynamics columns stay host numpy)."""
        kw = dict(dtype=dtype, device=device)
        return dataclasses.replace(self, **{
            k: torch.as_tensor(np.asarray(getattr(self, k)), **kw)
            for k in ("r_anchor", "r_fair0", "L", "w", "EA")})


def build_mooring(mooring, rho_water=1025.0, g=9.81, x_ref=0.0, y_ref=0.0,
                  heading_adjust=0.0):
    """Parse the design's inline ``mooring`` section (points / lines /
    line_types) into a :class:`MooringSystem` (counterpart of
    ``raft_tpu/physics/mooring.py:65-133``).

    Submerged weight per length w = (m' - rho pi/4 d^2) g with d the
    volume-equivalent diameter (MoorPy convention).  ``x_ref/y_ref`` and
    ``heading_adjust`` move the anchors to the FOWT's array position.
    The line-dynamics columns (mass, diameter, drag and added-mass
    coefficients, internal damping ``damping``) ride along for
    ``moorMod`` 1 and 2 (:mod:`raft_tpu_torch.physics.mooring_dynamics`)."""
    moorMod = int(coerce(mooring, "moorMod", default=0, dtype=int))
    depth = float(coerce(mooring, "water_depth", default=600.0))
    types = {lt["name"]: lt for lt in mooring["line_types"]}
    points = {p["name"]: p for p in mooring["points"]}

    r_anchor, r_fair, L, w, EA = [], [], [], [], []
    dyn = {k: [] for k in ("m_lin", "d_vol", "Cd", "Ca", "CdAx", "CaAx",
                           "BA")}
    for line in mooring["lines"]:
        pA = points[line["endA"]]
        pB = points[line["endB"]]
        # orient so end A is the fixed anchor
        if pA["type"] == "fixed":
            anchor, fair = pA, pB
        else:
            anchor, fair = pB, pA
        lt = types[line["type"]]
        d = float(lt["diameter"])
        m_lin = float(lt["mass_density"])
        r_anchor.append(np.array(anchor["location"], dtype=float))
        r_fair.append(np.array(fair["location"], dtype=float))
        L.append(float(line["length"]))
        w.append((m_lin - rho_water * np.pi / 4 * d**2) * g)
        EA.append(float(lt["stiffness"]))
        for k, v in (("m_lin", m_lin), ("d_vol", d),
                     ("Cd", coerce(lt, "transverse_drag", default=1.2)),
                     ("Ca", coerce(lt, "transverse_added_mass",
                                   default=1.0)),
                     ("CdAx", coerce(lt, "tangential_drag", default=0.05)),
                     ("CaAx", coerce(lt, "tangential_added_mass",
                                     default=0.0)),
                     ("BA", coerce(lt, "damping", default=0.0))):
            dyn[k].append(float(v))

    r_anchor = np.array(r_anchor)
    r_fair = np.array(r_fair)
    if heading_adjust != 0.0:
        c, s = np.cos(np.deg2rad(heading_adjust)), np.sin(np.deg2rad(heading_adjust))
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        r_anchor = r_anchor @ Rz.T
        r_fair = r_fair @ Rz.T
    r_anchor = r_anchor + np.array([x_ref, y_ref, 0.0])
    # fairleads stay body-local (the body pose carries x_ref/y_ref)
    return MooringSystem(r_anchor=np.array(r_anchor), r_fair0=np.array(r_fair),
                         L=np.array(L), w=np.array(w), EA=np.array(EA),
                         depth=depth, moorMod=moorMod,
                         **{k: np.array(v) for k, v in dyn.items()})


def _grounded(VF, L, w, can_ground):
    """Where the line rests on the seabed: VF < w L on a line that can
    ground (``can_ground`` True, False or a bool tensor; anchor lines
    can, lines between floating bodies cannot)."""
    grounded = _v(VF) < w * L
    return grounded if can_ground is True else grounded & can_ground


def _profile(HF, VF, L, w, EA, can_ground=True):
    """Horizontal/vertical fairlead-anchor spans (XF, ZF) of an elastic
    catenary with fairlead loads (HF, VF) over a flat frictionless
    seabed (grounded when VF < w L and ``can_ground``)."""
    HF = _clamp_min(HF, 1e-8)
    t1 = VF / HF
    s1 = _sqrt(1.0 + t1 * t1)
    asinh1 = _asinh(t1)

    LB = L - VF / w
    XF_g = LB + (HF / w) * asinh1 + HF * L / EA
    ZF_g = (HF / w) * (s1 - 1.0) + VF * VF / (2.0 * EA * w)

    VA = VF - w * L
    t2 = VA / HF
    s2 = _sqrt(1.0 + t2 * t2)
    asinh2 = _asinh(t2)
    XF_s = (HF / w) * (asinh1 - asinh2) + HF * L / EA
    ZF_s = (HF / w) * (s1 - s2) + (VF * L - 0.5 * w * L * L) / EA

    grounded = _grounded(VF, L, w, can_ground)
    return _where(grounded, XF_g, XF_s), _where(grounded, ZF_g, ZF_s)


def _profile_jacobian(HF, VF, L, w, EA, can_ground=True):
    """d(XF, ZF)/d(HF, VF) of :func:`_profile`, written out (the
    reference takes it by forward-mode AD): (dX/dHF, dX/dVF, dZ/dHF,
    dZ/dVF)."""
    m = _v(HF) > 1e-8                      # the HF clamp passes d/dHF
    h = _clamp_min(HF, 1e-8)
    t1 = VF / h
    s1 = _sqrt(1.0 + t1 * t1)
    a1 = _asinh(t1)
    VA = VF - w * L
    t2 = VA / h
    s2 = _sqrt(1.0 + t2 * t2)
    a2 = _asinh(t2)
    r1 = t1 / s1
    r2 = t2 / s2
    xh_g = a1 / w - r1 / w + L / EA
    xv_g = (1.0 / s1 - 1.0) / w
    zh_g = (s1 - 1.0) / w - t1 * r1 / w
    zv_g = r1 / w + VF / (EA * w)
    xh_s = (a1 - a2) / w - (r1 - r2) / w + L / EA
    xv_s = (1.0 / s1 - 1.0 / s2) / w
    zh_s = (s1 - s2) / w - (t1 * r1 - t2 * r2) / w
    zv_s = (r1 - r2) / w + L / EA
    grounded = _grounded(VF, L, w, can_ground)
    zero = torch.zeros_like(_v(HF))
    return (_where(m, _where(grounded, xh_g, xh_s), zero),
            _where(grounded, xv_g, xv_s),
            _where(m, _where(grounded, zh_g, zh_s), zero),
            _where(grounded, zv_g, zv_s))


def solve_catenary(XF, ZF, L, w, EA, n_iter=60, can_ground=True):
    """(HF, VF, HA, VA) such that the catenary spans (XF, ZF).

    Damped Newton from the MoorPy-style seed, ``n_iter`` fixed steps,
    each backtracked by up to 4 halvings until the residual norm does
    not grow; non-finite steps are rejected.  All arguments broadcast;
    ``XF``/``ZF`` may be :class:`Dual` (the tangents then run through
    every step).  ``can_ground`` (a bool or a bool tensor per line) is
    False for shared and suspended lines, which never rest on the
    seabed.
    """
    XF = _clamp_min(XF, 1e-6)
    lr = _sqrt(XF * XF + ZF * ZF)
    taut = L <= _v(lr)
    arg = _clamp_min(3.0 * ((L * L - ZF * ZF) / (XF * XF) - 1.0), 1e-12)
    lam = _sqrt(arg)
    HF_slack = _clamp_min(_abs(0.5 * w * XF / lam), 1e-3)
    VF_slack = 0.5 * w * (ZF / _tanh(lam) + L)
    T0 = _maximum(EA * (lr - L) / L, w * L)
    HF_taut = T0 * XF / lr
    VF_taut = T0 * ZF / lr + 0.5 * w * L
    HF = _where(taut, HF_taut, HF_slack)
    VF = _where(taut, VF_taut, VF_slack)
    XFv, ZFv = _v(XF), _v(ZF)
    Hv = _v(HF)
    trial = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=Hv.dtype,
                         device=Hv.device).reshape((4,) + (1,) * Hv.dim())

    for _ in range(n_iter):
        x, z = _profile(HF, VF, L, w, EA, can_ground)
        r0, r1 = x - XF, z - ZF
        j00, j01, j10, j11 = _profile_jacobian(HF, VF, L, w, EA, can_ground)
        det = j00 * j11 - j01 * j10
        det = _where(torch.abs(_v(det)) < 1e-30, 1e-30, det)
        dH = -(r0 * j11 - r1 * j01) / det
        dV = -(j00 * r1 - j10 * r0) / det

        # backtracking on primal values: the step length it picks is a
        # constant (zero tangent).  The reference halves alpha while the
        # residual at alpha grows, 4 times at most; that picks 2^-k with
        # k the number of leading growths at alpha = 1, 1/2, 1/4, 1/8,
        # all four trial steps taken in one batched profile
        Hv, Vv, dHv, dVv = _v(HF), _v(VF), _v(dH), _v(dV)
        r0v, r1v = _v(r0), _v(r1)
        rn0 = torch.sqrt(r0v * r0v + r1v * r1v)
        x2, z2 = _profile(torch.clamp(Hv + trial * dHv, min=1e-6),
                          Vv + trial * dVv, L, w, EA, can_ground)
        x2, z2 = x2 - XFv, z2 - ZFv
        worse = (torch.sqrt(x2 * x2 + z2 * z2) > rn0).to(Hv.dtype)
        alpha = torch.pow(0.5, torch.sum(torch.cumprod(worse, dim=0), dim=0))
        HF2 = _clamp_min(HF + alpha * dH, 1e-6)
        VF2 = VF + alpha * dV
        ok = torch.isfinite(_v(HF2)) & torch.isfinite(_v(VF2))
        HF = _where(ok, HF2, HF)
        VF = _where(ok, VF2, VF)
    grounded = _grounded(VF, L, w, can_ground)
    VA = _where(grounded, torch.zeros_like(_v(VF)), VF - w * L)
    return HF, VF, HF, VA


def _fairlead_geometry(r_fair0, r_anchor, r6):
    """Fairlead positions and the catenary spans at pose ``r6``:
    (XF, ZF, u_h (..., nL, 2), lever arm r_fair - r6[:3] (..., nL, 3))."""
    R = tf.rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    r_fair = r6[..., None, :3] + r_fair0 @ R.transpose(-1, -2)
    dvec = r_fair - r_anchor
    XF = torch.sqrt(dvec[..., 0] ** 2 + dvec[..., 1] ** 2)
    u_h = dvec[..., :2] / torch.clamp(XF, min=1e-8)[..., None]
    return XF, dvec[..., 2], u_h, r_fair - r6[..., None, :3]


def catenary_line_forces(r_fair0, r_anchor, L, w, EA, r6):
    """Per-line 6-DOF fairlead forces about the body origin at pose
    ``r6``, plus per-line tension components.

    r_fair0, r_anchor : (..., nL, 3); L, w, EA : (..., nL);
    r6 : (..., 6).  Returns (F6 (..., nL, 6), dict(HF, VF, HA, VA)).
    """
    XF, ZF, u_h, lever = _fairlead_geometry(r_fair0, r_anchor, r6)
    HF, VF, HA, VA = solve_catenary(XF, ZF, L, w, EA)
    F_fair = torch.cat([-HF[..., None] * u_h, -VF[..., None]], dim=-1)
    F6 = tf.translate_force_3to6(F_fair, lever)
    return F6, dict(HF=HF, VF=VF, HA=HA, VA=VA)


def _force_comps(HF, VF, ux, uy, lx, ly, lz, mask):
    """Masked 6-DOF force and ``C = -dF/dX`` from the per-line loads and
    fairlead geometry as :class:`Dual` numbers whose tangents run along
    the 6 pose directions: (F (R, 6), C (R, 6, 6))."""
    fx, fy, fz = -HF * ux, -HF * uy, -VF
    # translate_force_3to6: [F, lever x F], written per component
    comps = (fx, fy, fz, ly * fz - lz * fy, lz * fx - lx * fz,
             lx * fy - ly * fx)
    F = torch.stack([torch.sum(torch.where(mask, c.v, 0.0), dim=-1)
                     for c in comps], dim=-1)
    dF = torch.stack([torch.sum(torch.where(mask, c.t, 0.0), dim=-1)
                      for c in comps], dim=-1)          # (6 dirs, R, 6)
    return F, -dF.permute(1, 2, 0)


def _geometry_duals(r_fair0, r_anchor, X):
    """The fairlead geometry at poses X (R, 6) as :class:`Dual` numbers
    with tangents along the 6 pose directions (forward mode through the
    geometry: ``torch.func.jacfwd`` with respect to a perturbation shared
    by all rows, exact because rows do not interact)."""
    def geometry(delta):
        out = _fairlead_geometry(r_fair0, r_anchor, X + delta)
        return out, out

    jac, (XF, ZF, u_h, lever) = torch.func.jacfwd(geometry, has_aux=True)(
        torch.zeros(6, dtype=X.dtype, device=X.device))
    return tuple(Dual(v, t.movedim(-1, 0)) for v, t in (
        (XF, jac[0]), (ZF, jac[1]),
        (u_h[..., 0], jac[2][..., 0, :]), (u_h[..., 1], jac[2][..., 1, :]),
        (lever[..., 0], jac[3][..., 0, :]),
        (lever[..., 1], jac[3][..., 1, :]),
        (lever[..., 2], jac[3][..., 2, :])))


def loop_forces(r_fair0, r_anchor, L, w, EA, mask, X):
    """(F, C, HF, VF) by forward mode through the geometry and the whole
    catenary Newton loop: :func:`line_forces_and_stiffness`' values (a
    forward-mode transform of this function differentiates through the
    loop, as the reference does)."""
    XF, ZF, ux, uy, lx, ly, lz = _geometry_duals(r_fair0, r_anchor, X)
    HF, VF, _, _ = solve_catenary(XF, ZF, L, w, EA)
    F, C = _force_comps(HF, VF, ux, uy, lx, ly, lz, mask)
    return F, C, HF.v, VF.v


def line_forces_and_stiffness(r_fair0, r_anchor, L, w, EA, mask, X,
                              root=False):
    """Masked mooring force and stiffness of a batch of rows.

    r_fair0, r_anchor : (R, nL, 3); L, w, EA : (R, nL); mask : (R, nL)
    bool; X : (R, 6).  Returns (F (R, 6), C (R, 6, 6)) with
    ``C = -dF/dX``: forward mode through the fairlead geometry and then,
    as :class:`Dual` tangents, through the whole catenary Newton loop.
    With ``root`` it also returns the converged loads (HF, VF) (R, nL).

    When an input is being differentiated (it requires grad, or carries
    a forward-mode tangent), F and C keep these values and take their
    derivatives from :func:`line_forces_at_root` at the converged loads
    (the Newton loop runs on detached inputs).
    """
    with torch.no_grad():
        F, C, HF, VF = loop_forces(*ad.detached(r_fair0, r_anchor, L, w, EA,
                                                mask, X))
    if ad.differentiated(r_fair0, r_anchor, L, w, EA, X):
        F_r, C_r = line_forces_at_root(r_fair0, r_anchor, L, w, EA, mask, X,
                                       HF, VF)
        F = F + (F_r - F_r.detach())
        C = C + (C_r - C_r.detach())
    return (F, C, (HF, VF)) if root else (F, C)


def catenary_at_root(XF, ZF, L, w, EA, HF, VF, can_ground=True):
    """:func:`solve_catenary`'s (HF, VF, HA, VA) written from its
    converged fairlead loads HF, VF, differentiable in the spans and the
    line properties by the implicit rule (the Newton loop not taped).

    With r(H, V) = profile(H, V; L, w, EA) - (XF, ZF) and J its 2 x 2
    Jacobian in (H, V) at the root, the loads are attached as
    ``H* + (c - stop_grad(c))`` with ``c = -J^-1 r`` and J held
    constant: their value is H*, their derivative ``-J^-1 dr``, the
    implicit derivative.  Where XF or ZF is a :class:`Dual`, the loads'
    tangents are ``J^-1 d(XF, ZF)`` with J written from the attached
    loads, so the tangents are differentiable too (their derivative is
    the second derivative of the loads at the root)."""
    XF = _clamp_min(XF, 1e-6)
    Hs, Vs = HF.detach(), VF.detach()
    x, z = _profile(Hs, Vs, L, w, EA, can_ground)
    r0, r1 = x - _v(XF), z - _v(ZF)
    with torch.no_grad():
        j00, j01, j10, j11 = _profile_jacobian(
            Hs, Vs, *ad.detached(L, w, EA), can_ground)
        det = j00 * j11 - j01 * j10
    cH = -(r0 * j11 - r1 * j01) / det
    cV = -(j00 * r1 - j10 * r0) / det
    H = Hs + (cH - cH.detach())
    V = Vs + (cV - cV.detach())
    if isinstance(XF, Dual) or isinstance(ZF, Dual):
        j00, j01, j10, j11 = _profile_jacobian(H, V, L, w, EA, can_ground)
        det = j00 * j11 - j01 * j10
        xt = XF.t if isinstance(XF, Dual) else 0.0
        zt = ZF.t if isinstance(ZF, Dual) else 0.0
        H, V = (Dual(H, (j11 * xt - j01 * zt) / det),
                Dual(V, (j00 * zt - j10 * xt) / det))
    grounded = _grounded(V, L, w, can_ground)
    VA = _where(grounded, torch.zeros_like(_v(V)), V - w * L)
    return H, V, H, VA


def line_forces_at_root(r_fair0, r_anchor, L, w, EA, mask, X, HF, VF):
    """(F (R, 6), C (R, 6, 6)) written from the converged fairlead loads
    HF, VF (R, nL) of the pose X, differentiable in X and in the line
    properties: the loads attached at the root by
    :func:`catenary_at_root`, their pose tangents ``J^-1 d(XF, ZF)/dX``,
    so the stiffness is differentiable too."""
    XF, ZF, ux, uy, lx, ly, lz = _geometry_duals(r_fair0, r_anchor, X)
    H, V, _, _ = catenary_at_root(XF, ZF, L, w, EA, HF, VF)
    return _force_comps(H, V, ux, uy, lx, ly, lz, mask)


def stiffness_jacfwd(r_fair0, r_anchor, L, w, EA, mask, X):
    """:func:`line_forces_and_stiffness` in the reference's form: the
    masked line-force sum of one row and ``C = -torch.func.jacfwd`` of
    it through the catenary Newton loop, vmapped over rows.  Same
    arguments and returns."""
    def force(fair0, anchor, L, w, EA, mask, x):
        F6, _ = catenary_line_forces(fair0, anchor, L, w, EA, x)
        F = torch.sum(torch.where(mask[:, None], F6, 0.0), dim=0)
        return F, F

    dF, F = torch.func.vmap(torch.func.jacfwd(force, argnums=6,
                                              has_aux=True))(
        r_fair0, r_anchor, L, w, EA, mask, X)
    return F, -dF


def line_args(ms, X):
    """(r_fair0, r_anchor, L, w, EA, mask) of every line of ``ms`` as
    (R, nL, ...) tensors for poses X (R, 6); the arrays of ``ms`` may
    carry a leading row axis."""
    R = X.shape[0]
    kw = dict(dtype=X.dtype, device=X.device)

    def rows(a, tail):
        t = torch.as_tensor(a, **kw)
        return t if t.dim() > tail else t.expand((R,) + t.shape)

    L = rows(ms.L, 1)
    mask = torch.ones(L.shape, dtype=torch.bool, device=X.device)
    return (rows(ms.r_fair0, 2), rows(ms.r_anchor, 2), L, rows(ms.w, 1),
            rows(ms.EA, 1), mask)


def mooring_force_and_stiffness(ms, X):
    """(F (R, 6), C (R, 6, 6)) of every line of ``ms`` at poses X (R, 6),
    through :func:`line_forces_and_stiffness` with every line counted."""
    return line_forces_and_stiffness(*line_args(ms, X), X)


def mooring_force(ms, r6):
    """Net 6-DOF line force on the body at poses r6 (R, 6) about the body
    origin -> (R, 6)."""
    return mooring_force_and_stiffness(ms, r6)[0]


def mooring_stiffness(ms, r6):
    """Coupled mooring stiffness ``C = -dF/dr6`` at poses r6 (R, 6) ->
    (R, 6, 6): forward mode through the catenary Newton loop."""
    return mooring_force_and_stiffness(ms, r6)[1]


# ------------------------------------------------------------- networks

class MooringNetwork:
    """Quasi-static mooring network (counterpart of the reference's
    ``MooringNetwork``): lines between fixed anchors, points attached to
    bodies and *free* points (buoys, clump weights), as a MoorDyn file
    describes a shared-mooring array.

    Built on the host (:meth:`add_point`, :meth:`add_line`,
    :meth:`finalize`, numpy).  :meth:`solve` evaluates it for a batch of
    rows of body poses: the free points' equilibrium by the reference's
    inner Newton (25 fixed steps from the file's positions, the
    Jacobian damped by ``-1e-6 I``, each step clipped to +-50 m), then
    the 6-DOF force on every body and the coupled stiffness
    ``-dF/dX`` (6 nB square) through the free points' equilibrium.

    The line-end forces of every line come from one batched catenary
    solve carrying three hand tangents, along the span vector from the
    line's lower end to its upper end; the point stiffness they give is
    the inner Newton's Jacobian, and the body stiffness eliminates the
    free points by their equilibrium, ``dr_free/dX = -J^-1 dF_free/dX``:
    the limit of the reference's forward mode through its converged
    inner loop.  :meth:`stiffness_jacfwd` is that forward mode, the
    oracle.
    """

    #: the inner Newton's fixed step count, Jacobian damping and step
    #: clip (the reference's)
    FREE_STEPS = 25
    FREE_DAMPING = 1e-6
    FREE_CLIP = 50.0

    def __init__(self, depth, g=9.81, rho=1025.0, bathymetry=None):
        self.depth = float(depth)
        self.g = g
        self.rho = rho
        # (x (nx,), y (ny,), depth (ny, nx)) or None: the local seabed
        # depth decides which fixed points are anchors on the seabed
        self.bathymetry = bathymetry
        self.p_kind = []     # 0 fixed, 1 body-attached, 2 free
        self.p_body = []     # body index of a kind-1 point
        self.p_r = []        # fixed / initial position, or body-local
        self.p_mass = []
        self.p_vol = []
        self.l_ends = []     # (point A, point B)
        self.l_L = []
        self.l_w = []
        self.l_EA = []
        self._dev = {}

    def add_point(self, kind, r, body=-1, mass=0.0, vol=0.0):
        self.p_kind.append(kind)
        self.p_body.append(body)
        self.p_r.append(np.asarray(r, dtype=float))
        self.p_mass.append(mass)
        self.p_vol.append(vol)
        return len(self.p_kind) - 1

    def add_line(self, pA, pB, L, w, EA):
        self.l_ends.append((pA, pB))
        self.l_L.append(L)
        self.l_w.append(w)
        self.l_EA.append(EA)

    def finalize(self):
        self.p_kind = np.asarray(self.p_kind)
        self.p_body = np.asarray(self.p_body)
        self.p_r = np.asarray(self.p_r)
        self.p_mass = np.asarray(self.p_mass)
        self.p_vol = np.asarray(self.p_vol)
        self.l_ends = np.asarray(self.l_ends, dtype=np.int64).reshape(-1, 2)
        self.l_L = np.asarray(self.l_L, dtype=float)
        self.l_w = np.asarray(self.l_w, dtype=float)
        self.l_EA = np.asarray(self.l_EA, dtype=float)
        self.free_idx = np.where(self.p_kind == 2)[0]
        self.body_idx = np.where(self.p_kind == 1)[0]
        self.n_bodies = int(self.p_body.max()) + 1 if len(self.p_body) else 0
        # a line can rest on the seabed only where one of its ends is a
        # fixed point at the (local) seabed
        self.l_can_ground = np.asarray([
            any(self.p_kind[p] == 0
                and self.p_r[p][2] <= -self.depth_at(*self.p_r[p][:2]) + 1.0
                for p in ends) for ends in self.l_ends], dtype=bool)
        return self

    @property
    def n_lines(self):
        return len(self.l_L)

    def depth_at(self, x, y):
        """Local seabed depth [m, positive down] at (x, y): bilinear on
        the bathymetry grid when present, else the uniform depth."""
        if self.bathymetry is None:
            return self.depth
        xg, yg, dg = self.bathymetry
        ix = int(np.clip(np.searchsorted(xg, x) - 1, 0, len(xg) - 2))
        iy = int(np.clip(np.searchsorted(yg, y) - 1, 0, len(yg) - 2))
        fx = np.clip((x - xg[ix]) / (xg[ix + 1] - xg[ix]), 0.0, 1.0)
        fy = np.clip((y - yg[iy]) / (yg[iy + 1] - yg[iy]), 0.0, 1.0)
        return float(
            dg[iy, ix] * (1 - fx) * (1 - fy)
            + dg[iy, ix + 1] * fx * (1 - fy)
            + dg[iy + 1, ix] * (1 - fx) * fy
            + dg[iy + 1, ix + 1] * fx * fy)

    # ------------------------------------------------------- evaluation
    def _on(self, like):
        """The network's arrays as tensors of ``like``'s device and
        dtype (made once per device and dtype)."""
        key = (like.device, like.dtype)
        if key not in self._dev:
            kw = dict(dtype=like.dtype, device=like.device)
            idx = dict(dtype=torch.int64, device=like.device)
            fixed = np.where(self.p_kind == 0)[0]
            order = np.concatenate([fixed, self.body_idx, self.free_idx])
            nP = len(self.p_kind)
            a, b = self.l_ends[:, 0], self.l_ends[:, 1]
            buoy = np.zeros((len(self.free_idx), 3))
            buoy[:, 2] = (-self.p_mass[self.free_idx] * self.g
                          + self.rho * self.g * self.p_vol[self.free_idx])
            self._dev[key] = dict(
                fixed=torch.as_tensor(self.p_r[fixed], **kw),
                local=torch.as_tensor(self.p_r[self.body_idx], **kw),
                body=torch.as_tensor(self.p_body[self.body_idx], **idx),
                free0=torch.as_tensor(self.p_r[self.free_idx], **kw),
                # position in [fixed, body, free] of every point
                perm=torch.as_tensor(np.argsort(order), **idx),
                a=torch.as_tensor(a, **idx), b=torch.as_tensor(b, **idx),
                # flat (p, q) slots of the blocks dF_p/dr_q of each line
                pairs=torch.as_tensor(np.stack(
                    [a * nP + a, a * nP + b, b * nP + a, b * nP + b]), **idx),
                L=torch.as_tensor(self.l_L, **kw),
                w=torch.as_tensor(self.l_w, **kw),
                EA=torch.as_tensor(self.l_EA, **kw),
                can_ground=torch.as_tensor(self.l_can_ground,
                                           device=like.device),
                buoy=torch.as_tensor(buoy, **kw),
                body_of=torch.as_tensor(
                    np.eye(max(self.n_bodies, 1))[self.p_body[self.body_idx]],
                    **kw))
        return self._dev[key]

    def _body_points(self, X, t):
        """Body-attached point positions (R, nBP, 3) at body poses
        X (R, nB, 6), and their lever arms about the body origin."""
        Xp = X[:, t["body"]]                                # (R, nBP, 6)
        Rm = tf.rotation_matrix(Xp[..., 3], Xp[..., 4], Xp[..., 5])
        lever = (Rm @ t["local"][..., None])[..., 0]
        return Xp[..., :3] + lever, lever

    def point_positions(self, X, r_free):
        """Every point's position (R, nP, 3) at body poses X (R, nB, 6)
        and free-point positions r_free (R, nf, 3)."""
        t = self._on(X)
        R = X.shape[0]
        pb, _ = self._body_points(X, t)
        fixed = t["fixed"].expand((R,) + t["fixed"].shape)
        return torch.cat([fixed, pb, r_free], dim=1)[:, t["perm"]]

    def line_end_forces(self, pos, tangents=True, loads=None):
        """Forces of every line on its end A and end B points,
        (FA, FB) each (R, nL, 3), the tension magnitudes (R, nL, 2) at
        the lower and the upper end, the fairlead loads (HF, VF) (R, nL)
        (values), and with ``tangents`` the blocks (R, nL, 4, 3, 3) of
        dF_A/dr_A, dF_A/dr_B, dF_B/dr_A, dF_B/dr_B.

        Each line is solved from its lower end to its upper end (the
        catenary's anchor and fairlead), with its own ``can_ground``.
        With ``loads``, the converged fairlead loads (HF, VF) (R, nL) of
        these positions, the catenary is not solved again: the loads are
        attached at that root (:func:`catenary_at_root`), differentiable
        in the positions, tangents included."""
        t = self._on(pos)
        ra, rb = pos[:, t["a"]], pos[:, t["b"]]
        flip = ra[..., 2] > rb[..., 2]                      # A is the upper
        d = torch.where(flip[..., None], ra - rb, rb - ra)  # lower -> upper
        dx, dy, dz = d.unbind(-1)
        if tangents:
            eye = torch.eye(3, dtype=d.dtype, device=d.device)[..., None, None]
            dx, dy, dz = (Dual(c, eye[k]) for k, c in enumerate((dx, dy, dz)))
        XF = _sqrt(dx * dx + dy * dy)
        XF_safe = _maximum(XF, 1e-8)
        ux, uy = dx / XF_safe, dy / XF_safe
        if loads is None:
            HF, VF, HA, VA = solve_catenary(XF, dz, t["L"], t["w"], t["EA"],
                                            can_ground=t["can_ground"])
        else:
            HF, VF, HA, VA = catenary_at_root(XF, dz, t["L"], t["w"],
                                              t["EA"], *loads,
                                              can_ground=t["can_ground"])
        hi = (-HF * ux, -HF * uy, -VF)                      # on the upper
        lo = (HF * ux, HF * uy, VA)                         # on the lower
        FA = [_where(flip, h, l) for h, l in zip(hi, lo)]
        FB = [_where(flip, l, h) for h, l in zip(hi, lo)]
        tens = torch.stack([torch.hypot(_v(HA), _v(VA)),
                            torch.hypot(_v(HF), _v(VF))], dim=-1)
        vals = (torch.stack([_v(c) for c in FA], dim=-1),
                torch.stack([_v(c) for c in FB], dim=-1))
        vals = vals + (tens, (_v(HF).detach(), _v(VF).detach()))
        if not tangents:
            return vals
        # d/d(span) -> d/dr: the span is r_upper - r_lower
        sA = torch.where(flip, 1.0, -1.0)[..., None, None]
        dA = torch.stack([c.t for c in FA]).permute(2, 3, 0, 1)  # (R,nL,3,3)
        dB = torch.stack([c.t for c in FB]).permute(2, 3, 0, 1)
        blocks = torch.stack([sA * dA, -sA * dA, sA * dB, -sA * dB], dim=2)
        return vals + (blocks,)

    def _assemble(self, pos, tangents=True, loads=None):
        """(net line force on every point (R, nP, 3), tensions, with
        ``tangents`` the point stiffness G (R, nP, 3, nP, 3) = dF_p/dr_q
        (else None), and the line loads); ``loads`` as
        :meth:`line_end_forces` takes them."""
        t = self._on(pos)
        R, nP = pos.shape[:2]
        out = self.line_end_forces(pos, tangents, loads)
        FA, FB, tens, loads = out[:4]
        F = torch.zeros_like(pos).index_add(1, t["a"], FA).index_add(
            1, t["b"], FB)
        if not tangents:
            return F, tens, None, loads
        G = torch.zeros((R, nP * nP, 3, 3), dtype=pos.dtype,
                        device=pos.device)
        G = G.index_add(1, t["pairs"].reshape(-1),
                        out[4].transpose(1, 2).reshape(R, -1, 3, 3))
        G = G.reshape(R, nP, nP, 3, 3).permute(0, 1, 3, 2, 4)
        return F, tens, G, loads

    def _free_force_jac(self, X, r_free, loads=None):
        """The free points' net force (R, 3 nf) and its Jacobian in their
        positions (R, 3 nf, 3 nf)."""
        t = self._on(X)
        fr = torch.as_tensor(self.free_idx, device=X.device)
        F, _, G, _ = self._assemble(self.point_positions(X, r_free),
                                    loads=loads)
        nf = len(self.free_idx)
        Ff = (F[:, fr] + t["buoy"]).reshape(-1, 3 * nf)
        J = G[:, fr][:, :, :, fr].reshape(-1, 3 * nf, 3 * nf)
        return Ff, J

    def solve_free_points(self, X):
        """Free-point positions (R, nf, 3) at body poses X (R, nB, 6):
        the reference's fixed-step damped Newton from the file's
        positions."""
        t = self._on(X)
        r_free = t["free0"].expand((X.shape[0],) + t["free0"].shape)
        nf = len(self.free_idx)
        if nf == 0:
            return r_free
        damp = self.FREE_DAMPING * torch.eye(3 * nf, dtype=X.dtype,
                                             device=X.device)
        for _ in range(self.FREE_STEPS):
            Ff, J = self._free_force_jac(X, r_free)
            dX = torch.linalg.solve(J - damp, -Ff[..., None])[..., 0]
            dX = torch.clamp(dX, -self.FREE_CLIP, self.FREE_CLIP)
            r_free = r_free + dX.reshape(r_free.shape)
        return r_free

    def _to_bodies(self, X, t, F):
        """(6-DOF force on every body (R, nB, 6), the force at each body
        point (R, nBP, 3), its lever arm) from the point forces F."""
        bi = torch.as_tensor(self.body_idx, device=X.device)
        Fb = F[:, bi]
        _, lever = self._body_points(X, t)
        F6 = torch.einsum("rpi,pb->rbi",
                          torch.cat([Fb, tf.cross(lever, Fb)], dim=-1),
                          t["body_of"][:, :X.shape[1]])
        return F6, Fb, lever

    def attach_free_points(self, X, r_free, loads):
        """The free points' equilibrium ``r_free`` (R, nf, 3) of the body
        poses X, attached to X by the implicit rule: ``r_free + (c -
        stop_grad(c))`` with ``c = -J^-1 F_free(X, r_free)``, J the
        free points' stiffness held constant, so the value is r_free and
        the derivative ``dr_free/dX = -J^-1 dF_free/dX``.  That is the
        limit of the reference's derivative through its 25 fixed Newton
        steps, whose damped Jacobian (J - 1e-6 I) contracts the error
        by about 1e-6 / |lambda(J)| a step.  ``loads`` are the lines'
        converged loads at (X, r_free); the Newton steps are not
        taped."""
        nf = len(self.free_idx)
        if nf == 0:
            return r_free
        r_free = r_free.detach()
        Ff, J = self._free_force_jac(X, r_free, loads=loads)
        c = -torch.linalg.solve(J.detach(), Ff[..., None])[..., 0]
        return r_free + (c - c.detach()).reshape(r_free.shape)

    def solve(self, X, stiffness=True, root=None):
        """Body forces and coupled stiffness at body poses X (R, nB, 6):
        dict(F (R, nB, 6), K (R, 6 nB, 6 nB) with ``stiffness``,
        r_free (R, nf, 3), tensions (R, nL, 2) at the lower and upper
        end of each line, and ``root``, the free points and the lines'
        converged loads (r_free, (HF, VF))).

        Given a ``root`` of the same poses, nothing is solved again:
        the free points are attached at it
        (:meth:`attach_free_points`), the line loads too
        (:func:`catenary_at_root`), and F and K are written from them,
        differentiable in X (K's derivative is then the second
        derivative of the force through the free points'
        equilibrium)."""
        t = self._on(X)
        R, nB = X.shape[:2]
        if root is None:
            r_free = self.solve_free_points(X)
            loads = None
        else:
            r_free, loads = root
            r_free = self.attach_free_points(X, r_free, loads)
        pos = self.point_positions(X, r_free)
        F, tens, G, loads = self._assemble(pos, tangents=stiffness,
                                           loads=loads)
        F6, Fb, lever = self._to_bodies(X, t, F)
        out = dict(F=F6, r_free=r_free, tensions=tens,
                   root=(r_free.detach(), loads))
        if not stiffness:
            return out
        # total dF_P/dr_P of the body points with the free points at
        # their equilibrium: G_PP - G_PF J^-1 G_FP
        nBP, nf = len(self.body_idx), len(self.free_idx)
        bi = torch.as_tensor(self.body_idx, device=X.device)
        to_body = t["body_of"][:, :nB]                      # (nBP, nB)
        GP = G[:, bi]
        H = GP[:, :, :, bi].reshape(R, 3 * nBP, 3 * nBP)
        if nf:
            fr = torch.as_tensor(self.free_idx, device=X.device)
            J = G[:, fr][:, :, :, fr].reshape(R, 3 * nf, 3 * nf)
            GPF = GP[:, :, :, fr].reshape(R, 3 * nBP, 3 * nf)
            GFP = G[:, fr][:, :, :, bi].reshape(R, 3 * nf, 3 * nBP)
            H = H - GPF @ torch.linalg.solve(J, GFP)
        # dr_p/dX of each body point: [I, d(R p)/d(angles)] on its body
        Xp = X[:, t["body"]]

        def rotated(delta):
            ang = Xp[..., 3:] + delta
            Rm = tf.rotation_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
            return (Rm @ t["local"][..., None])[..., 0]

        dlev = torch.func.jacfwd(rotated)(
            torch.zeros(3, dtype=X.dtype, device=X.device))  # (R,nBP,3,3)
        eye = torch.eye(3, dtype=X.dtype, device=X.device).expand_as(dlev)
        A = torch.cat([eye, dlev], dim=-1)                  # (R, nBP, 3, 6)
        # spread over the columns of each point's own body
        A_full = torch.einsum("rpij,pb->rpibj", A, to_body).reshape(
            R, 3 * nBP, 6 * nB)
        dF = (H @ A_full).reshape(R, nBP, 3, 6 * nB)
        dlev_full = torch.einsum(
            "rpij,pb->rpibj", torch.cat([torch.zeros_like(dlev), dlev],
                                        dim=-1), to_body).reshape(
            R, nBP, 3, 6 * nB)
        dM = (tf.cross(lever[..., None].expand_as(dF), dF, dim=-2)
              + tf.cross(dlev_full, Fb[..., None].expand_as(dF), dim=-2))
        dF6 = torch.einsum("rpic,pb->rbic", torch.cat([dF, dM], dim=2),
                           to_body).reshape(R, 6 * nB, 6 * nB)
        out["K"] = -dF6
        return out

    # ----------------------------------------------------------- oracle
    def stiffness_jacfwd(self, X):
        """:meth:`solve`'s stiffness in the reference's form, the oracle:
        ``-torch.func.jacfwd`` of the body forces through the whole inner
        Newton loop (its every step, Jacobian and clip included), row by
        row (R, 6 nB, 6 nB)."""
        def forces(x):
            return self.solve(x.reshape(1, -1, 6),
                              stiffness=False)["F"].reshape(-1)

        return torch.stack([-torch.func.jacfwd(forces)(x.reshape(-1))
                            for x in X])


# ------------------------------------------------------------- MoorDyn

def read_bathymetry(path):
    """A MoorPy-style bathymetry grid file (``nGridX``/``nGridY``, the x
    row, then ``y d d d ...`` rows) as (x (nx,), y (ny,), depth
    (ny, nx)), depth positive down [m]."""
    rows = []
    xg = None
    nx = ny = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("---"):
                continue
            toks = line.split()
            key = toks[0].lower()
            if key == "ngridx":
                nx = int(toks[1])
            elif key == "ngridy":
                ny = int(toks[1])
            elif xg is None:
                xg = np.asarray(toks, dtype=float)
            else:
                rows.append((float(toks[0]), np.asarray(toks[1:], dtype=float)))
    yg = np.asarray([r[0] for r in rows])
    dg = np.stack([r[1] for r in rows])
    if nx is not None and (len(xg) != nx or dg.shape != (ny, nx)):
        raise ValueError(
            f"bathymetry grid shape {dg.shape} does not match declared "
            f"nGridX={nx} nGridY={ny} in {path}")
    return xg, yg, dg


def _moordyn_rows(path):
    """(section, tokens, line) of every row of a MoorDyn v1/v2 file under
    a LINE TYPES ("types"), POINTS or CONNECTIONS ("points") or LINES
    ("lines") header; rows under any other header come with section
    None."""
    section = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            up = line.upper()
            if up.startswith("---"):
                if "LINE TYPE" in up:
                    section = "types"
                elif "POINT" in up or "CONNECTION" in up:
                    section = "points"
                elif (up.startswith("---------------------- LINES")
                      or "- LINES -" in up
                      or up.strip("- ").startswith("LINES")):
                    section = "lines"
                else:
                    section = None
                continue
            yield section, line.split(), line


def _int_or_none(tok):
    try:
        return int(tok)
    except ValueError:
        return None


def _attachment(att):
    """'fixed', 'vessel' or 'other' of a MoorDyn point attachment."""
    if att.startswith(("fix", "anch")):
        return "fixed"
    if att.startswith(("vessel", "coupled", "body", "turbine")):
        return "vessel"
    return "other"


def parse_moordyn_system(path, depth, rho=1025.0, g=9.81, moorMod=0):
    """A simple MoorDyn file, every line from one Vessel point to one
    Fixed point, as a :class:`MooringSystem` with its line-dynamics
    columns (counterpart of the reference's ``parse_moordyn_system``).

    Line-type rows: 10 or more columns are MoorDyn v2 (Name Diam Mass/m
    EA BA EI Cd Ca CdAx CaAx), 9 are v1 with the hydro coefficients added
    mass first (Name Diam MassDen EA BA Can Cat Cdn Cdt), 5 or fewer are
    quasi-static (default coefficients); 6 to 8 raise.  Raises
    ValueError when the file needs the network treatment (free points,
    shared lines): :func:`parse_moordyn` reads those."""
    types, points, lines = {}, {}, []
    for section, toks, line in _moordyn_rows(path):
        if section == "types" and len(toks) >= 4:
            try:
                d = float(toks[1])
            except ValueError:
                continue
            if len(toks) >= 10:
                hydro = dict(Cd=float(toks[6]), Ca=float(toks[7]),
                             CdAx=float(toks[8]), CaAx=float(toks[9]))
            elif len(toks) == 9:
                hydro = dict(Ca=float(toks[5]), CaAx=float(toks[6]),
                             Cd=float(toks[7]), CdAx=float(toks[8]))
            elif len(toks) <= 5:
                hydro = dict(Cd=1.2, Ca=1.0, CdAx=0.05, CaAx=0.0)
            else:
                raise ValueError(
                    f"ambiguous line-type row ({len(toks)} columns) in "
                    f"{path}: expected 9 (MoorDyn v1) or >=10 (v2) "
                    f"columns; got {line!r}")
            types[toks[0]] = dict(
                d=d, m=float(toks[2]), EA=float(toks[3]),
                BA=float(toks[4]) if len(toks) > 4 else 0.0, **hydro)
        elif section == "points" and len(toks) >= 5:
            pid = _int_or_none(toks[0])
            if pid is not None:
                points[pid] = (toks[1].lower(), np.array(
                    [float(toks[2]), float(toks[3]), float(toks[4])]))
        elif section == "lines" and len(toks) >= 5:
            if _int_or_none(toks[0]) is not None:
                lines.append((toks[1], int(toks[2]), int(toks[3]),
                              float(toks[4])))
    if not lines:
        raise ValueError("no lines found")
    cols = {k: [] for k in ("r_anchor", "r_fair0", "L", "w", "EA", "m_lin",
                            "d_vol", "Cd", "Ca", "CdAx", "CaAx", "BA")}
    for tname, a, b, length in lines:
        (ka, ra), (kb, rb) = points[a], points[b]
        if _attachment(ka) == "fixed" and _attachment(kb) == "vessel":
            anc, fair = ra, rb
        elif _attachment(kb) == "fixed" and _attachment(ka) == "vessel":
            anc, fair = rb, ra
        else:
            raise ValueError(
                f"line {tname} connects {ka}-{kb}: needs the network "
                "treatment (free/shared points)")
        lt = types[tname]
        for k, v in (("r_anchor", anc), ("r_fair0", fair), ("L", length),
                     ("w", (lt["m"] - rho * np.pi / 4 * lt["d"] ** 2) * g),
                     ("EA", lt["EA"]), ("m_lin", lt["m"]), ("d_vol", lt["d"]),
                     ("Cd", lt["Cd"]), ("Ca", lt["Ca"]), ("CdAx", lt["CdAx"]),
                     ("CaAx", lt["CaAx"]), ("BA", lt["BA"])):
            cols[k].append(v)
    return MooringSystem(depth=float(depth), moorMod=int(moorMod),
                         **{k: np.array(v) for k, v in cols.items()})


def parse_moordyn(path, depth, rho=1025.0, g=9.81, bathymetry=None):
    """A MoorDyn v1/v2 file as a :class:`MooringNetwork` (counterpart of
    the reference's ``parse_moordyn``): Fixed / Anchor points, Free /
    Connect points (with their mass and volume columns), and Vessel,
    Coupled, Turbine<N> and Body<N> points attached to body N - 1 (body
    0 without a number).  ``bathymetry``: a grid file path
    (:func:`read_bathymetry`) or its arrays."""
    bath = read_bathymetry(bathymetry) if isinstance(bathymetry, str) \
        else bathymetry
    net = MooringNetwork(depth, g=g, rho=rho, bathymetry=bath)
    types, ids = {}, {}
    for section, toks, _ in _moordyn_rows(path):
        if section == "types" and len(toks) >= 4 and toks[0] not in (
                "Name", "TypeName", "(-)", "(name)"):
            try:
                d = float(toks[1])
            except ValueError:
                continue
            types[toks[0]] = dict(
                w=(float(toks[2]) - rho * np.pi / 4 * d ** 2) * g,
                EA=float(toks[3]))
        elif section == "points" and len(toks) >= 5:
            pid = _int_or_none(toks[0])
            if pid is None:
                continue
            att = toks[1].lower()
            r = np.array([float(toks[2]), float(toks[3]), float(toks[4])])
            if att.startswith(("fix", "anch")):
                ids[pid] = net.add_point(0, r)
            elif att.startswith(("free", "connect")):
                ids[pid] = net.add_point(
                    2, r, mass=float(toks[5]) if len(toks) > 5 else 0.0,
                    vol=float(toks[6]) if len(toks) > 6 else 0.0)
            else:
                digits = "".join(ch for ch in att if ch.isdigit())
                ids[pid] = net.add_point(
                    1, r, body=int(digits) - 1 if digits else 0)
        elif section == "lines" and len(toks) >= 5:
            if _int_or_none(toks[0]) is not None:
                lt = types[toks[1]]
                net.add_line(ids[int(toks[2])], ids[int(toks[3])],
                             float(toks[4]), lt["w"], lt["EA"])
    return net.finalize()
