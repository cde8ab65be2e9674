"""Evaluation API of one design (counterpart of ``raft_tpu/api.py``):
the batched case, design-axis and full-physics evaluators
(:func:`make_case_evaluator`, :func:`make_design_evaluator`,
:func:`make_full_evaluator`, with its geometry design axis), the
serving adapter :func:`pack_for_serving`, the
case-table helpers of the full evaluator (:func:`case_to_traced`,
:func:`case_in_traced_domain`), and the case-level helpers every
evaluator shares (``_policy_cdt``, ``_case_status``).

Every evaluator, the farm and flexible ones too, is differentiable in
reverse and in forward mode with respect to its row inputs (sea states,
wind, current, turbulence intensity, yaw, design scales, geometry
scales, a potential-flow design's d_scale, a flexible design's
``struct_params``): rows are independent, so
``torch.autograd.grad(metric(out).sum(), x)`` gives each row's
gradient, and ``torch.func.jvp`` / ``torch.func.jacfwd`` of a function
of the outputs give its tangents (``jacfwd`` runs the evaluator once,
with the directions batched).  Under either transform every output
keeps the plain call's value, bit for bit; the integer outputs
(``status``, ``n_iter_drag``) and the bool ``drag_converged`` carry no
tangent: ``torch.func.jvp`` returns a zero tangent of their dtype and
``jacfwd`` a zero Jacobian (``has_aux=True`` carries them out as
values).  Without an input that is being differentiated
(:func:`raft_tpu_torch.utils.ad.differentiated`) the rows run under
``no_grad``.  Both modes pass every root by its implicit rule, never
through its iterations, whose loops run on detached values: the
blade-element inflow angle (:mod:`raft_tpu_torch.physics.aero`), the
catenary loads and a network's free points
(:mod:`raft_tpu_torch.physics.mooring`), the statics and the drag fixed
point (:mod:`raft_tpu_torch.models.statics_solve`,
:mod:`raft_tpu_torch.models.dynamics`); every solve passes by its
adjoint or its tangent solve (:mod:`raft_tpu_torch.ops.linsolve`)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from raft_tpu_torch.models.statics_solve import solve_equilibrium
from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.parallel import freq
from raft_tpu_torch.physics import morison
from raft_tpu_torch.structure import members_traced
from raft_tpu_torch.utils import ad, config, health
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device


def _policy_cdt(*tensors):
    """Complex dtype of the excitation prefix under ``RAFT_TPU_DTYPE``
    (derived from ``tensors`` when the flag is unset)."""
    return compute_dtypes(*tensors)[1]


def _case_status(st_status, dyn_diag, X0, Xi, input_clipped=None):
    """One int32 health word per row: the statics bits OR the dynamics
    bits OR the evaluator guards on non-finite outputs and on clamped
    inputs (``input_clipped`` (R,) bool, or None: no input clamped, as
    on the bucket path)."""
    status = st_status | dyn_diag["status"]
    fin = torch.isfinite(torch.view_as_real(Xi))
    finite = (torch.all(torch.isfinite(X0), dim=-1)
              & freq.wall(fin, dim=tuple(range(1, fin.ndim))))
    status = health.set_bit(status, health.NONFINITE_INTERMEDIATE,
                            (~finite).to(torch.int32))
    if input_clipped is not None:
        status = health.set_bit(status, health.INPUT_CLIPPED,
                                input_clipped.to(torch.int32))
    return status.to(torch.int32)


class CaseEvaluator(nn.Module):
    """Batched sea-state evaluator of one design (the reference's
    ``make_case_evaluator``): ``forward(Hs, Tp, beta)`` over R rows, each
    a scalar or an (R,) array, returns the reference's output keys per
    row as tensors on the device.

    The design's leaves sit on the device once, unpadded (its own
    signature, every axis at its real size), in the dtypes of the
    ``RAFT_TPU_DTYPE`` policy when the evaluator is made (float64 by
    default); rows run in chunks of
    ``RAFT_TPU_BUCKET_ROWS`` through the bucket path's stages, with the
    zero-pose hydro constants and the strip frames at each row's
    displaced pose.
    """

    def __init__(self, model, device=None, full=False):
        super().__init__()
        from raft_tpu_torch.structure import bucketing

        device = resolve_device(device)
        self.device = device
        self.rdt, self.cdt = compute_dtypes()
        self.fs = model.fowtList[0]
        sig = bucketing.bucket_signature(model, ladders={}, full=full)
        self.body = bucketing.BucketEvaluator(sig, device)
        self.nw = self.body.nw
        self.design = {k: v[None] for k, v in bucketing.packed_from_numpy(
            bucketing.pack_design(model, sig), device).items()}
        self.ms = None if model.ms is None else model.ms.to(device, self.rdt)

    def forward(self, Hs, Tp, beta, timer=None):
        """``timer``, when given, is called per chunk as
        :meth:`raft_tpu_torch.structure.bucketing.BucketEvaluator.forward`
        calls it."""
        return self._rows(dict(Hs=Hs, Tp=Tp, beta=beta), timer)

    def _rows(self, params, timer):
        p = {k: v.reshape(-1) for k, v in zip(params, torch.broadcast_tensors(
            *(torch.as_tensor(v, dtype=self.rdt, device=self.device)
              for v in params.values())))}
        return self._chunks(p, p["Hs"].shape[0], timer)

    def _chunks(self, p, n, timer):
        """Run the n rows of ``p`` in chunks of ``RAFT_TPU_BUCKET_ROWS``
        and concatenate the chunks' outputs; under ``no_grad`` unless an
        input is being differentiated (then every chunk keeps its graph
        and tangents)."""
        if n == 0:
            raise ValueError("empty batch: no rows to evaluate")
        cap = int(config.get("BUCKET_ROWS")) or n
        mark = timer if timer is not None else (lambda stage: None)
        grad = ad.differentiated(*(
            t for v in p.values() for t in (
                v.tensors() if isinstance(v, GeometryConstants) else (v,))))
        outs = []
        with torch.set_grad_enabled(grad):
            for a in range(0, n, cap):
                outs.append(self._chunk({k: v[a:a + cap]
                                         for k, v in p.items()}, mark))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _design_rows(self, p, R):
        """(design leaves, mooring system, hydro hook) of R rows."""
        d = {k: v.expand((R,) + v.shape[1:]) for k, v in self.design.items()}
        return d, self.ms, None

    def _chunk(self, p, mark):
        from raft_tpu_torch.structure import bucketing

        R = p["Hs"].shape[0]
        mark("start")
        d, ms, hydro = self._design_rows(p, R)
        X0, _, _, _, st_status, C_moor = solve_equilibrium(
            self.fs, ms, d["K_h"], d["F_und"], torch.zeros_like(d["F_und"]))
        mark("statics")
        return bucketing.one_heading(self.body.respond(
            d, X0, st_status, C_moor, p["Hs"][:, None], p["Tp"][:, None],
            p["beta"][:, None], mark, hydro=hydro))


class DesignEvaluator(CaseEvaluator):
    """Batched design-axis evaluator of one design (the reference's
    ``make_design_evaluator``): ``forward(Hs, Tp, beta, Cd_scale=1,
    Ca_scale=1, L_moor_scale=1)``, each a scalar or an (R,) array.

    Per row the strip drag and added-mass coefficients are scaled
    (``Cm = 1 + Ca_scale (Cm - 1)`` on the complex inertia
    coefficients), the mooring lines' unstretched lengths are scaled in
    both the force and the stiffness, the statics are re-solved, and the
    hydro constants are recomputed at the row's displaced pose."""

    def __init__(self, model, device=None):
        super().__init__(model, device)
        ss = model.hydro[0].strips
        self.coef = {k: torch.as_tensor(
            getattr(ss, k), device=self.device,
            dtype=self.cdt if k.startswith("Cm") else self.rdt)
            for k in ("Ca_q", "Ca_p1", "Ca_p2", "Ca_End", "Cm_p1_w",
                      "Cm_p2_w")}

    def forward(self, Hs, Tp, beta, Cd_scale=1.0, Ca_scale=1.0,
                L_moor_scale=1.0, timer=None):
        return self._rows(dict(Hs=Hs, Tp=Tp, beta=beta, Cd_scale=Cd_scale,
                               Ca_scale=Ca_scale,
                               L_moor_scale=L_moor_scale), timer)

    def _design_rows(self, p, R):
        d, ms, _ = super()._design_rows(p, R)
        d = dict(d)
        Cd_s = p["Cd_scale"][:, None]
        for k in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
            d[k] = d[k] * Cd_s
        Ca_s = p["Ca_scale"][:, None]
        coef = {k: self.coef[k] * Ca_s
                for k in ("Ca_q", "Ca_p1", "Ca_p2", "Ca_End")}
        for k in ("Cm_p1_w", "Cm_p2_w"):
            coef[k] = 1.0 + Ca_s[..., None] * (self.coef[k] - 1.0)
        if ms is not None:
            ms = dataclasses.replace(ms, L=ms.L * p["L_moor_scale"][:, None])

        def hydro(fs, ss, R_ptfm, r_nodes, Tn):
            return morison.hydro_constants(
                fs, dataclasses.replace(ss, **coef), R_ptfm, r_nodes, Tn)

        return d, ms, hydro


def _stamped(ev, factory, model, **kwargs):
    """Stamp ``ev`` with the factory call that made it (the sweeps build
    its twin on another device from it:
    :func:`raft_tpu_torch.parallel.sweep.bind_evaluator`) and with its
    program identity for the program bank, the reference's
    ``_stamp_program_key``: the factory's name and a content hash of the
    design and the factory's arguments (:mod:`raft_tpu_torch.aot.bank`
    banks only stamped evaluators)."""
    from raft_tpu_torch.aot.bank import content_fingerprint

    ev._raft_factory = (factory, (model,), kwargs)
    ev._raft_program_key = (factory.__name__,
                            content_fingerprint((model.design, kwargs)))
    return ev


def make_case_evaluator(model, device=None):
    """The batched :class:`CaseEvaluator` of ``model`` on ``device``
    (default: the current CUDA device; raises without one)."""
    return _stamped(CaseEvaluator(model, device), make_case_evaluator, model)


def make_design_evaluator(model, device=None):
    """The batched :class:`DesignEvaluator` of ``model`` on ``device``
    (default: the current CUDA device; raises without one)."""
    return _stamped(DesignEvaluator(model, device), make_design_evaluator,
                    model)


# ------------------------------------------------------ full physics

#: the row parameters of :class:`FullEvaluator`: per-row environment
#: scalars, and sea-state parameters per row and wave heading
ENV_KEYS = ("wind_speed", "wind_heading_deg", "TI", "yaw_misalign_deg",
            "current_speed", "current_heading_deg")
SEA_KEYS = ("Hs", "Tp", "gamma", "beta_deg")

#: the output keys of :class:`FullEvaluator`, as the reference's
FULL_OUT_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "zeta", "f_aero", "A00",
                 "B00", "f_aero0", "Omega_rpm", "pitch_deg", "F_2nd_mean",
                 "Z", "drag_resid", "drag_converged", "n_iter_drag",
                 "status")

#: the stages a :class:`FullEvaluator` timer is called with, in order
FULL_STAGES = ("aero", "statics", "excitation", "fixed_point", "response")
#: the stages a design with an external QTF adds: its second-order
#: forces after the excitation, and after the response the second
#: equilibrium under the mean drift
SECOND_ORDER_STAGE = "second_order"
DRIFT_STAGE = "drift"
#: the stages of the geometry design axis: the per-row geometry
#: constants (member inertia elements, statics, zero-pose hydro
#: constants) first
GEOMETRY_STAGES = ("geometry",) + FULL_STAGES

#: the geometry keys of a row's ``geom``: per member (a scalar, (R,) or
#: (R, nMember)) and per row
GEOM_MEMBER_KEYS = members_traced.MEMBER_KEYS
GEOM_ROW_KEYS = members_traced.ROW_KEYS + ("L_moor_scale", "EA_moor_scale")


@dataclasses.dataclass
class GeometryConstants:
    """What a row's geometry fixes before its load case (the reference's
    ``geometry_constants``), per row: the scaled strips ``ss`` (a
    :class:`~raft_tpu_torch.physics.morison.StripSet` of (R, S, ...)
    tensors) and mooring ``ms`` (L and EA (R, nL)), the statics matrices
    K_h, C_elast, M_struc (R, 6, 6) and F_und (R, 6), and the zero-pose
    hydro constants ``hc0`` (A_hydro with the rotor added mass, Imat,
    a_i and the strip frames).  A potential-flow design's rows whose
    d_scale is not 1 also carry ``bem``: their coefficients A, B
    (R, 6, 6, nw) and X (R, nHeading, 6, nw) interpolated in d_scale
    (else None: the design's own).  Slicing takes rows."""

    ss: object
    ms: object
    K_h: torch.Tensor
    C_elast: torch.Tensor
    F_und: torch.Tensor
    M_struc: torch.Tensor
    hc0: dict
    bem: dict | None = None

    @property
    def rows(self):
        return self.K_h.shape[0]

    def tensors(self):
        """Every tensor the constants hold."""
        yield from (v for v in vars(self.ss).values()
                    if isinstance(v, torch.Tensor))
        if self.ms is not None:
            yield from (self.ms.L, self.ms.EA)
        yield from (self.K_h, self.C_elast, self.F_und, self.M_struc)
        yield from self.hc0.values()
        if self.bem is not None:
            yield from self.bem.values()

    def _map(self, f):
        ms = self.ms
        if ms is not None:
            ms = dataclasses.replace(ms, L=f(ms.L), EA=f(ms.EA))
        return GeometryConstants(
            ss=morison.StripSet(**{k: f(v) if isinstance(v, torch.Tensor)
                                   else v for k, v in vars(self.ss).items()}),
            ms=ms, K_h=f(self.K_h), C_elast=f(self.C_elast),
            F_und=f(self.F_und), M_struc=f(self.M_struc),
            hc0={k: f(v) for k, v in self.hc0.items()},
            bem=None if self.bem is None else {k: f(v) for k, v in
                                               self.bem.items()})

    def __getitem__(self, sl):
        return self._map(lambda t: t[sl])

    def expand(self, n):
        """The constants of one row repeated for ``n`` rows."""
        if self.rows == n:
            return self
        if self.rows != 1:
            raise ValueError(f"geometry constants of {self.rows} rows for "
                             f"{n} rows")
        return self._map(lambda t: t.expand((n,) + t.shape[1:]))


def pack_for_serving(model):
    """One built model resolved into what the evaluation service
    (:mod:`raft_tpu_torch.serve`) coalesces requests with: ``(sig,
    packed, fingerprint)``, the bucket signature that routes it
    (:func:`~raft_tpu_torch.structure.bucketing.bucket_signature`), the
    packed numpy leaves one request contributes as a batch row
    (:func:`~raft_tpu_torch.structure.bucketing.pack_design`) and the
    design's content fingerprint that keys the result cache
    (:func:`raft_tpu_torch.aot.bank.content_fingerprint`).

    Raises :class:`~raft_tpu_torch.structure.bucketing.
    UnbucketableDesignError` for designs outside the bucketed chain
    (flexible members, potential flow, farms): the service refuses them
    at registration, not mid-tick."""
    from raft_tpu_torch.aot.bank import content_fingerprint
    from raft_tpu_torch.structure import bucketing

    sig = bucketing.bucket_signature(model)
    packed = bucketing.pack_design(model, sig)
    return sig, packed, content_fingerprint(model.design)


def case_to_traced(case, nWaves=1):
    """One parsed case-table row (the reference's key names) as the row
    parameters of :class:`FullEvaluator`: the six environment scalars
    and (nWaves,) numpy arrays of Hs, Tp, gamma and beta_deg.  A
    turbulence given as an IEC class string gives TI 0 (such a case is
    outside :func:`case_in_traced_domain`)."""
    from raft_tpu_torch.structure.schema import coerce

    turb = case.get("turbulence", 0.0)
    TI = float(turb) if not isinstance(turb, str) else 0.0
    return dict(
        wind_speed=float(coerce(case, "wind_speed", shape=0, default=0.0)),
        wind_heading_deg=float(coerce(case, "wind_heading", shape=0,
                                      default=0.0)),
        TI=TI,
        yaw_misalign_deg=float(coerce(case, "yaw_misalign", shape=0,
                                      default=0.0)),
        current_speed=float(coerce(case, "current_speed", shape=0,
                                   default=0.0)),
        current_heading_deg=float(coerce(case, "current_heading", shape=0,
                                         default=0.0)),
        Hs=np.asarray(coerce(case, "wave_height", shape=nWaves), dtype=float),
        Tp=np.asarray(coerce(case, "wave_period", shape=nWaves), dtype=float),
        gamma=np.asarray(coerce(case, "wave_gamma", shape=nWaves,
                                default=0.0), dtype=float),
        beta_deg=np.asarray(coerce(case, "wave_heading", shape=nWaves),
                            dtype=float),
    )


def case_in_traced_domain(case):
    """True when a parsed case row is inside the full evaluator's static
    assumptions: operating turbine, JONSWAP seas, numeric turbulence
    intensity, one wave heading.  IEC turbulence-class strings, parked
    or idle rotors and other spectra need the per-case branching the
    evaluator bakes in."""
    if isinstance(case.get("turbulence", 0.0), str):
        return False
    if str(case.get("turbine_status", "operating")) != "operating":
        return False
    spec = case.get("wave_spectrum", "JONSWAP")
    specs = [spec] if isinstance(spec, str) else list(np.atleast_1d(spec))
    if any(str(s).upper() not in ("JONSWAP",) for s in specs):
        return False
    return np.ndim(case.get("wave_heading", 0.0)) == 0


def _rotor_terms(ev, p, R):
    """Every active rotor's aero-servo terms for the R rows of ``p``,
    reduced to the n DOFs of ``ev`` through the rows of its node
    reduction ``ev.Tn0`` (N, 6, n) at each rotor's node: f_aero0 (R, n),
    f_aero (R, n, nw), A_aero, B_aero (R, n, n, nw), B_gyro (R, n, n),
    the rotor-axis A00, B00 (R, nw, nRotor), Omega_rpm and pitch_deg
    (R, nRotor), and the rows with a clamped speed (R,).  ``ev`` is a
    :class:`FullEvaluator` or :class:`FlexibleEvaluator`."""
    from raft_tpu_torch.physics.aero import calc_aero_traced

    rdt, dev = ev.rdt, ev.device
    w = freq.take(ev.w)
    nw = w.shape[0]
    n = ev.Tn0.shape[-1]
    out = dict(
        f_aero0=torch.zeros((R, n), dtype=rdt, device=dev),
        f_aero=torch.zeros((R, n, nw), dtype=ev.cdt, device=dev),
        A_aero=torch.zeros((R, n, n, nw), dtype=rdt, device=dev),
        B_aero=torch.zeros((R, n, n, nw), dtype=rdt, device=dev),
        B_gyro=torch.zeros((R, n, n), dtype=rdt, device=dev),
        A00=torch.zeros((R, nw, ev.n_rot_out), dtype=rdt, device=dev),
        B00=torch.zeros((R, nw, ev.n_rot_out), dtype=rdt, device=dev),
        Omega_rpm=torch.zeros((R, ev.n_rot_out), dtype=rdt, device=dev),
        pitch_deg=torch.zeros((R, ev.n_rot_out), dtype=rdt, device=dev),
        input_clipped=torch.zeros(R, dtype=torch.bool, device=dev),
    )
    deg = math.pi / 180
    yaw_cmd = p["yaw_misalign_deg"] * deg
    for ir, rprops, rt, node in ev.rotors:
        current = rprops.Zhub < 0
        speed = p["current_speed"] if current else p["wind_speed"]
        heading = (p["current_heading_deg"] if current
                   else p["wind_heading_deg"]) * deg
        on = speed > 0
        speed_safe = torch.clamp(speed, min=0.1)
        out["input_clipped"] |= on & (speed < 0.1)
        f0, f6, a6, b6, Bg, _, Om, pit = calc_aero_traced(
            rt, rprops, w, speed_safe, heading, p["TI"],
            yaw_command_rad=yaw_cmd, turb_static=ev.turb_static,
            dw=ev.w[1] - ev.w[0])
        Tn = ev.Tn0[node]                                    # (6, n)
        onr = on.to(rdt)
        out["f_aero0"] += onr[:, None] * (f0 @ Tn)
        out["f_aero"] += onr[:, None, None] * torch.einsum(
            "ia,riw->raw", Tn.to(f6.dtype), f6)
        out["A_aero"] += onr[:, None, None, None] * torch.einsum(
            "ia,rijw,jb->rabw", Tn, a6, Tn)
        out["B_aero"] += onr[:, None, None, None] * torch.einsum(
            "ia,rijw,jb->rabw", Tn, b6, Tn)
        out["B_gyro"] += onr[:, None, None] * (Tn.T @ Bg @ Tn)
        out["A00"][:, :, ir] = onr[:, None] * a6[:, 0, 0, :]
        out["B00"][:, :, ir] = onr[:, None] * b6[:, 0, 0, :]
        out["Omega_rpm"][:, ir] = onr * Om
        out["pitch_deg"][:, ir] = onr * pit
    return out


def _interp_heading_rows(X_BEM, headings, beta_deg):
    """Wrap-around heading interpolation of excitation coefficients and
    their rotation to the global frame (the reference's
    ``_interp_heading_traced``) for rows of headings.

    X_BEM (nh, 6, nw) or per row (R, nh, 6, nw) complex at ``headings``
    (nh,) [deg] ascending in [0, 360); beta_deg (R, nH) [deg].  Returns
    (R, nH, 6, nw)."""
    h = np.asarray(headings, dtype=float)
    nh = len(h)
    ext_h = torch.as_tensor(np.concatenate([[h[-1] - 360.0], h,
                                            [h[0] + 360.0]]),
                            dtype=beta_deg.dtype, device=beta_deg.device)
    ext_X = torch.cat([X_BEM[..., -1:, :, :], X_BEM, X_BEM[..., :1, :, :]],
                      dim=-3)
    beta = torch.remainder(beta_deg, 360.0)
    idx = torch.clamp(torch.searchsorted(ext_h, beta, right=True) - 1, 0, nh)
    f = ((beta - ext_h[idx]) / (ext_h[idx + 1] - ext_h[idx]))[..., None, None]
    if ext_X.dim() == 3:
        X0, X1 = ext_X[idx], ext_X[idx + 1]
    else:
        r = torch.arange(idx.shape[0], device=idx.device)[:, None]
        X0, X1 = ext_X[r, idx], ext_X[r, idx + 1]
    Xp = X0 * (1 - f) + X1 * f                           # (R, nH, 6, nw)
    b = beta_deg * (math.pi / 180)
    sb, cb = torch.sin(b)[..., None], torch.cos(b)[..., None]
    x = [Xp[..., i, :] for i in range(6)]
    return torch.stack([x[0] * cb - x[1] * sb, x[0] * sb + x[1] * cb, x[2],
                        x[3] * cb - x[4] * sb, x[3] * sb + x[4] * cb, x[5]],
                       dim=-2)


def _lagrange3(vals, s_nodes, s):
    """Quadratic Lagrange interpolation of stacked samples vals (3, ...)
    taken at the three ``s_nodes``, at each row's s (R,): (R, ...)."""
    s0, s1, s2 = (float(x) for x in s_nodes)
    shape = s.shape + (1,) * (vals.dim() - 1)
    l0 = ((s - s1) * (s - s2) / ((s0 - s1) * (s0 - s2))).reshape(shape)
    l1 = ((s - s0) * (s - s2) / ((s1 - s0) * (s1 - s2))).reshape(shape)
    l2 = ((s - s0) * (s - s1) / ((s2 - s0) * (s2 - s1))).reshape(shape)
    return l0 * vals[0] + l1 * vals[1] + l2 * vals[2]


def _qtf_model_grid(qtf_data, w, device, cdt):
    """The external QTF on the model grid for :func:`_hydro_force_2nd_rows`
    (build time): per heading node (nh, nw, nw, 6), bilinear and zero
    outside the QTF's grid (:func:`~raft_tpu_torch.physics.secondorder.
    qtf_model_grid`), gathered on the device as its superdiagonals
    ``sup[h, mu, j] = Q[h, j, min(j + mu, nw - 1)]`` and its diagonal
    ``diag[h, j] = Q[h, j, j]``, with the heading nodes [rad]."""
    from raft_tpu_torch.physics.secondorder import qtf_model_grid

    Qm = torch.as_tensor(qtf_model_grid(qtf_data, w)).to(device=device,
                                                         dtype=cdt)
    nw = Qm.shape[1]
    j = torch.arange(nw, device=device)
    col = j[None, :] + j[:, None]                # (mu, j) -> j + mu
    colc = torch.clamp(col, max=nw - 1)
    return dict(sup=Qm[:, j[None, :], colc, :], diag=Qm[:, j, j, :],
                valid=col < nw, colc=colc,
                heads=torch.as_tensor(np.asarray(qtf_data["heads_rad"],
                                                 dtype=float),
                                      device=device))


def _hydro_force_2nd_rows(qm, beta, S, dw):
    """Difference-frequency forces of rows of seas from the external QTF
    (the reference's ``_hydro_force_2nd_traced``, its 'qtf' mode), in
    its order of operations, batched over rows and headings.

    ``qm`` from :func:`_qtf_model_grid`; beta (R, nH) [rad]; S (R, nH,
    nw) the wave spectra on the model grid.  The QTF is interpolated
    linearly between its heading nodes at beta clipped to their span
    (no wrap, unlike the first-order coefficients); then per difference
    frequency mu, ``f_mu = 4 sqrt(sum_j S_j S_{j+mu} |Q[j, j+mu]|^2)
    dw``, shifted down one bin onto the model grid, and ``f_mean = 2
    sum_j S_j Re Q[j, j] dw``.  Returns (f_mean (R, nH, 6), f (R, nH, 6,
    nw) real).

    Derivatives: the clip is ``jnp.clip``'s, whose derivative at a bound
    is 1/2 (a heading exactly on the first or last node), as
    ``torch.minimum`` / ``torch.maximum`` give it at a tie; where the
    sum under the root is 0 (the spectrum underflows at both
    frequencies) the root's derivative is its limit there, 0, where a
    plain ``sqrt`` gives 0 x inf = NaN (the reference's goldens floor
    the spectrum, ROADMAP §C).  The values are unchanged."""
    heads = qm["heads"].to(beta.dtype)
    nh = heads.shape[0]
    if nh == 1:
        sup, diag = qm["sup"][0], qm["diag"][0]
    else:
        b = torch.minimum(torch.maximum(beta, heads[0]), heads[-1])
        i = torch.clamp(torch.searchsorted(heads, b) - 1, 0, nh - 2)
        f = (b - heads[i]) / (heads[i + 1] - heads[i])
        fs = f[..., None, None, None]
        sup = qm["sup"][i] * (1 - fs) + qm["sup"][i + 1] * fs
        fd = f[..., None, None]
        diag = qm["diag"][i] * (1 - fd) + qm["diag"][i + 1] * fd
    Ssh = S[..., qm["colc"]]                         # (R, nH, mu, j)
    P = S[..., None, :, None] * Ssh[..., None] * torch.abs(sup) ** 2
    P = torch.where(qm["valid"][..., None], P, 0.0)
    Ps = torch.sum(P, dim=-2)
    pos = Ps > 0
    root = torch.where(pos, torch.sqrt(torch.where(pos, Ps, 1.0)), 0.0)
    f_mu = 4.0 * root * dw                                 # (R, nH, mu, 6)
    f_out = torch.cat([f_mu[..., 1:, :], torch.zeros_like(f_mu[..., :1, :])],
                      dim=-2)
    f_mean = 2.0 * torch.sum(S[..., None] * diag.real, dim=-2) * dw
    return f_mean, f_out.transpose(-1, -2)


class FullEvaluator(CaseEvaluator):
    """Batched full-physics evaluator of one rigid single-FOWT design
    (the reference's ``make_full_evaluator``).

    ``forward(**rows, timer=None)`` takes R rows of the environment
    (:data:`ENV_KEYS`, each a scalar or (R,)) and of the sea states
    (:data:`SEA_KEYS`, each a scalar, (R,) or (R, nWaves); gamma 0 is
    the IEC default) and returns :data:`FULL_OUT_KEYS` per row.  Per
    chunk of ``RAFT_TPU_BUCKET_ROWS`` rows, in the reference's order:

    1. ``aero``: for each rotor with ``aeroServoMod > 0``, the
       blade-element solve with its load derivatives and the aero-servo
       coefficients about the rotor node (a submerged rotor sees the
       current, others the wind).  A rotor is on where its speed is
       > 0 and is evaluated at ``max(speed, 0.1)``; INPUT_CLIPPED marks
       the rows where ``0 < speed < 0.1``;
    2. ``statics``: current loads at the zero pose, then the mean-offset
       equilibrium under the environmental mean load;
    3. - 5. ``excitation``, ``fixed_point``, ``response``: the case
       evaluator's stages (:meth:`BucketEvaluator.respond` of the
       design's unpadded bucket) with one sea state per wave heading and
       the aerodynamic added mass, damping and gyroscopic damping added
       to the linear system.

    A potential-flow design (potMod members, or WAMIT files through
    ``hydroPath`` with ``potFirstOrder: 1``) adds its coefficients
    (:attr:`~raft_tpu_torch.models.model.Model.bem`, solved or read when
    the evaluator is made): the added mass A_BEM and damping B_BEM to
    the linear system in the reference's order (``A_aero + (M_struc +
    A_hydro) + A_BEM``, ``B_aero + B_BEM + B_gyro``) and, per row and
    heading, the excitation X_BEM interpolated at ``(beta -
    heading_adjust) mod 360`` (:func:`_interp_heading_rows`) times the
    array phase and the wave amplitudes to every heading's excitation.

    A design with an external QTF (``potSecOrder: 2``, a WAMIT ``.12d``
    file through ``hydroPath``, :attr:`~raft_tpu_torch.models.model.
    Model.qtf`) adds its difference-frequency forces: the QTF on the
    model grid at build, then in :meth:`BucketEvaluator.respond`, from
    each row's and heading's spectrum, :func:`_hydro_force_2nd_rows`
    (the QTF interpolated at the heading, clipped to its nodes' span)
    gives the force amplitudes, which join
    every heading's excitation after the first-order ones (the fixed
    point's with the first heading's), and the mean drift
    ``F_2nd_mean`` (R, nWaves, 6).  After the response a second
    equilibrium under the environmental mean load plus the drift summed
    over the headings gives the reported X0, its status bits OR'd into
    the row's; Xi is not solved again (the reference's order).  Without
    a QTF, ``F_2nd_mean`` is zero.  The geometry axis keeps the design's
    QTF for every row.

    ``timer(stage)``, when given, is called with "start" and then with
    each of :data:`FULL_STAGES` per chunk; a QTF adds
    :data:`SECOND_ORDER_STAGE` after "excitation" and :data:`DRIFT_STAGE`
    last (the stages of an evaluator: :attr:`stages`).

    With ``geometry=True`` (the geometry design axis) each row may also
    carry geometry scales, ``forward(geom={...}, **rows)`` with the keys
    :data:`GEOM_MEMBER_KEYS` (per member of ``fs.members``) and
    :data:`GEOM_ROW_KEYS`, or their precomputed
    :meth:`geometry_constants` (``geom_const``, of R rows or one row for
    all): a "geometry" stage first recomputes, per row, the members'
    inertia elements (:mod:`raft_tpu_torch.structure.members_traced`),
    the statics (:func:`~raft_tpu_torch.physics.statics.calc_statics`)
    and the zero-pose hydro constants, with the strips' diameters and
    coefficients and the mooring lines' lengths and stiffnesses scaled
    (timer stages :data:`GEOMETRY_STAGES`).  Rigid members only.  On a
    potential-flow design a row's d_scale must be one scale for every
    member: its coefficients are the quadratic interpolation in d_scale
    of the panel solver's at the settings' ``bem_geom_scales`` (default
    0.92, 1.0, 1.08), the two off-unit scales solved on the first chunk
    with a d_scale other than 1 (the design's coefficients where d_scale
    is 1).  File coefficients (``hydroPath``) cannot be re-solved and
    refuse ``geometry=True``.  A d_scale being differentiated (it
    requires grad, or carries a forward-mode tangent) always takes the
    interpolation, at 1 too (its value there is the design's, its
    derivative is not 0).

    Every row input is differentiable in reverse and forward mode, the
    aero stage's included: the blade-element root enters by its
    implicit rule
    (:func:`~raft_tpu_torch.physics.aero.rotor_loads_and_derivs`), and a
    clamped speed (below 0.1 m/s) has the clamp's derivative, 0.
    """

    def __init__(self, model, nWaves=1, turb_static=None, device=None,
                 geometry=False):
        fs = model.fowtList[0]
        if model.nFOWT == 1 and not fs.is_single_body:
            raise NotImplementedError(
                f"the full evaluator covers rigid 6-DOF FOWTs; this "
                f"structure reduces to {fs.nDOF} DOFs: use "
                "make_flexible_evaluator (ROADMAP A11, the flexible path)")
        from raft_tpu_torch.structure import bucketing

        pot = bucketing.has_potential_flow(fs)
        if geometry and pot and fs.potFirstOrder == 1 and fs.hydroPath:
            raise ValueError(
                "the geometry axis of a potential-flow design needs the "
                "panel solver: coefficients read from WAMIT files "
                f"(hydroPath {fs.hydroPath!r}) cannot be re-solved per "
                "geometry")
        super().__init__(model, device, full=True)
        from raft_tpu_torch.physics.aero import rotor_tensors
        from raft_tpu_torch.physics.statics import node_T

        fs, device, rdt = self.fs, self.device, self.rdt
        self.nWaves = int(nWaves)
        if self.nWaves < 1:
            raise ValueError(f"nWaves={nWaves}: need at least one heading")
        self.turb_static = tuple(turb_static or ("NTM", 50.0))
        self.nw = self.body.nw
        self.w = self.body.w.to(rdt)
        self.C_elast = torch.as_tensor(
            np.asarray(model.statics()["C_elast"], dtype=np.float64)).to(
                dtype=rdt, device=device)
        # the zero-pose strip frames and node reductions the current
        # loads are taken at
        hc0 = model.hydro[0].hc0
        self.hc0 = {k: torch.as_tensor(hc0[k]).to(
            device=device, dtype=rdt if k != "sub" else torch.bool)
            for k in ("r", "q", "p1", "p2", "sub")}
        node_r0 = self.design["node_r0"][0]
        self.Tn0 = node_T(node_r0, node_r0[fs.root_id])
        self.Zref = min([r.Zhub for r in fs.rotors if r.Zhub < 0],
                        default=0.0)
        self.n_rot_out = max(fs.nrotors, 1)
        # (rotor index, its properties, its tensors, its node) of every
        # rotor with aero-servo physics
        self.rotors = [
            (ir, fs.rotors[ir], rotor_tensors(rot, device, rdt),
             int(fs.rotor_node[ir]))
            for ir, rot in enumerate(model.rotor_aero if fs.nrotors else [])
            if fs.rotors[ir].aeroServoMod > 0]
        self.geometry = bool(geometry)
        self.strips0 = model.hydro[0].strips
        self.k = np.asarray(model.k)
        self.n_members = len(fs.members)
        self.bem = model.bem if pot else None
        if self.bem is not None:
            self._init_bem(model)
        qtf = model.qtf
        self.qtf = (None if qtf is None else
                    _qtf_model_grid(qtf, model.w, device, self.cdt))
        stages = FULL_STAGES
        if self.qtf is not None:
            i = stages.index("excitation") + 1
            stages = (stages[:i] + (SECOND_ORDER_STAGE,) + stages[i:]
                      + (DRIFT_STAGE,))
        self.stages = (("geometry",) if self.geometry else ()) + stages

    def _init_bem(self, model):
        """The design's potential-flow coefficients on the device, and on
        the geometry axis the three d_scale sample points."""
        bem, kw = self.bem, dict(dtype=self.rdt, device=self.device)
        self.bem_headings = np.asarray(bem["headings"], dtype=float)
        self.bem_has_X = bool(np.any(np.abs(bem["X_BEM"]) > 0))
        self.bem_t = dict(
            A=torch.as_tensor(bem["A_BEM"], **kw),
            B=torch.as_tensor(bem["B_BEM"], **kw),
            X=torch.as_tensor(bem["X_BEM"]).to(dtype=self.cdt,
                                               device=self.device))
        self.k_t = torch.as_tensor(self.k, **kw)
        self._bem_tab = None
        if self.geometry:
            settings = model.design.get("settings", {}) or {}
            scales = tuple(float(s) for s in settings.get(
                "bem_geom_scales", (0.92, 1.0, 1.08)))
            if len(scales) != 3 or len(set(scales)) != 3:
                raise ValueError(
                    "bem_geom_scales: exactly 3 distinct sample scales; "
                    "d_scale should stay inside their span (the quadratic "
                    "fit extrapolates beyond it)")
            self.bem_scales = scales
            self._run_bem = model.run_bem

    def bem_samples(self):
        """The coefficients at the three ``bem_geom_scales`` (A, B and X
        stacked on a leading axis of 3, and the scales ``s``): the
        design's own at 1, the others solved by
        :meth:`~raft_tpu_torch.models.model.Model.run_bem` on first
        use."""
        if self._bem_tab is None:
            bems = [self.bem if abs(s - 1.0) < 1e-12
                    else self._run_bem(d_scale=s) for s in self.bem_scales]
            kw = dict(dtype=self.rdt, device=self.device)
            self._bem_tab = dict(
                s=self.bem_scales,
                A=torch.as_tensor(np.stack([b["A_BEM"] for b in bems]), **kw),
                B=torch.as_tensor(np.stack([b["B_BEM"] for b in bems]), **kw),
                X=torch.as_tensor(np.stack([b["X_BEM"] for b in bems])).to(
                    dtype=self.cdt, device=self.device))
        return self._bem_tab

    def geometry_constants(self, geom):
        """The per-row geometry constants (:class:`GeometryConstants`) of
        ``geom`` (keys :data:`GEOM_MEMBER_KEYS` and :data:`GEOM_ROW_KEYS`,
        each a scalar, (R,) or, per member, (R, nMember)); the reference's
        ``evaluate.geometry_constants``.  Compute it once per design to
        reuse it over a case table (``forward(geom_const=...)``)."""
        from raft_tpu_torch.models.hydro import add_rotor_added_mass
        from raft_tpu_torch.physics.statics import calc_statics
        from raft_tpu_torch.structure import bucketing

        g = self._geom_rows(geom)
        R = next(iter(g.values())).shape[0]
        kw = dict(dtype=self.rdt, device=self.device)
        fs2, ss = members_traced.apply_geometry(
            self.fs, self.strips0, g, R, k=self.k, device=self.device,
            dtype=self.rdt)
        st = calc_statics(fs2, rows=R, **kw)
        d = {k: v.expand((R,) + v.shape[1:]) for k, v in self.design.items()}
        node_r0 = d["node_r0"]
        Tn0 = self.Tn0.expand((R,) + self.Tn0.shape)
        hc = morison.hydro_constants(
            bucketing.site_of(d, self.body.N), ss,
            torch.eye(3, **kw).expand(R, 3, 3), node_r0, Tn0)
        hc["A_hydro"] = add_rotor_added_mass(hc["A_hydro"], self.fs, Tn0)
        ms = self.ms
        if ms is not None:
            ms = dataclasses.replace(ms, L=ms.L * g["L_moor_scale"][:, None],
                                     EA=ms.EA * g["EA_moor_scale"][:, None])
        return GeometryConstants(
            ss=ss, ms=ms, K_h=st["C_struc"] + st["C_hydro"],
            C_elast=st["C_elast"],
            F_und=st["W_struc"] + st["W_hydro"] + st["f0_additional"],
            M_struc=st["M_struc"], hc0=hc, bem=self._bem_geometry(g))

    def _bem_geometry(self, g):
        """The potential-flow coefficients of geometry rows ``g`` (None
        without potential flow, or where every row's d_scale is 1 and
        none is being differentiated)."""
        if self.bem is None:
            return None
        d = g["d_scale"]
        # input validation, once per chunk before any launch
        if not bool(torch.all(d == d[:, :1])):  # raft-lint: disable=host-coercion (input check)
            raise ValueError(
                "potential-flow geometry rows need one uniform d_scale "
                "for every member (the coefficients are interpolated in "
                "that one scale)")
        s = d[:, 0]
        # at s = 1 the interpolation gives the design's own coefficients
        # (l1 = 1, l0 = l2 = 0 exactly) but not their derivative: a scale
        # being differentiated always interpolates
        # a host branch once per chunk: skip the interpolation at s = 1
        if not ad.differentiated(s) and not bool(torch.any(s != 1.0)):  # raft-lint: disable=host-coercion (once per chunk)
            return None
        tab = self.bem_samples()
        return {k: _lagrange3(tab[k], tab["s"], s) for k in ("A", "B", "X")}

    def _geom_rows(self, geom, n=None):
        """``geom`` as tensors: (R, nMember) per member, (R,) per row
        (R = n, or the rows the values give)."""
        unknown = set(geom) - set(GEOM_MEMBER_KEYS + GEOM_ROW_KEYS)
        if unknown:
            raise TypeError(f"unknown geometry keys {sorted(unknown)}")
        kw = dict(dtype=self.rdt, device=self.device)
        vals = {k: torch.as_tensor(geom.get(k, 1.0), **kw)
                for k in GEOM_MEMBER_KEYS + GEOM_ROW_KEYS}
        for k, v in vals.items():
            if v.dim() > (2 if k in GEOM_MEMBER_KEYS else 1):
                raise ValueError(f"geom {k}: shape {tuple(v.shape)} has too "
                                 "many axes")
            if v.dim() == 2 and v.shape[1] not in (1, self.n_members):
                raise ValueError(f"geom {k}: shape {tuple(v.shape)}, "
                                 f"expected (R, {self.n_members})")
        if n is None:
            n = max([v.shape[0] for v in vals.values() if v.dim()],
                    default=1)
        out = members_traced.member_scales(vals, self.n_members, n,
                                           vals["d_scale"])
        out.update({k: vals[k].expand(n) for k in GEOM_ROW_KEYS})
        return out

    def forward(self, timer=None, geom=None, geom_const=None, **rows):
        unknown = set(rows) - set(ENV_KEYS + SEA_KEYS)
        if unknown:
            raise TypeError(f"unknown row parameters {sorted(unknown)}")
        if not self.geometry and (geom is not None or geom_const is not None):
            raise TypeError("geom and geom_const need "
                            "make_full_evaluator(..., geometry=True)")
        if geom is not None and geom_const is not None:
            raise TypeError("pass geom or geom_const, not both")
        if not {"Hs", "Tp"} <= set(rows):
            raise TypeError("rows need Hs and Tp")
        kw = dict(dtype=self.rdt, device=self.device)
        vals = {k: torch.as_tensor(rows.get(k, 0.0), **kw)
                for k in ENV_KEYS + SEA_KEYS}
        for k, v in vals.items():
            if v.dim() > (2 if k in SEA_KEYS else 1):
                raise ValueError(f"{k}: shape {tuple(v.shape)} has too many "
                                 "axes")
            if k in SEA_KEYS and v.dim() == 2 and v.shape[1] != self.nWaves:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                                 f"(R, {self.nWaves})")
        lead = [v.shape[:1] for v in vals.values()]
        if geom is not None:
            lead += [torch.as_tensor(v).shape[:1] for v in geom.values()]
        if geom_const is not None:
            lead.append((geom_const.rows,) if geom_const.rows > 1 else ())
        n = torch.broadcast_shapes(*lead)
        n = n[0] if n else 1
        p = {}
        for k, v in vals.items():
            if k in SEA_KEYS:
                v = v[:, None] if v.dim() == 1 else v
                p[k] = v.expand(n, self.nWaves)
            else:
                p[k] = v.expand(n)
        if geom_const is not None:
            p["geom_const"] = geom_const.expand(n)
        elif self.geometry:
            p.update({"geom." + k: v for k, v in
                      self._geom_rows(geom or {}, n).items()})
        return self._chunks(p, n, timer)

    def _aero(self, p, R):
        """Every active rotor's aero-servo terms, reduced to the body."""
        return _rotor_terms(self, p, R)

    def _potential(self, p, bem):
        """The potential-flow terms of chunk ``p`` (None without potential
        flow): A_BEM and B_BEM, the design's (6, 6, nw) or the geometry
        rows' ``bem`` (R, 6, 6, nw), and X (R, nH, 6, nw), the excitation
        per unit wave amplitude at each row's headings, with the array
        phase (None where the coefficients have no excitation)."""
        if self.bem is None:
            return None
        bem = bem or self.bem_t
        out = dict(A=freq.take(bem["A"]), B=freq.take(bem["B"]), X=None)
        if self.bem_has_X:
            fs, bd = self.fs, p["beta_deg"]
            b = bd * (math.pi / 180)
            phase = torch.exp(-1j * freq.take(self.k_t) * (
                fs.x_ref * torch.cos(b) + fs.y_ref * torch.sin(b))[..., None])
            X = _interp_heading_rows(freq.take(bem["X"]), self.bem_headings,
                                     torch.remainder(bd - fs.heading_adjust,
                                                     360.0))
            out["X"] = X * phase[:, :, None, :]
        return out

    def _structure(self, p, R, mark):
        """(design leaves, mooring, zero-pose strip frames, C_elast, the
        rows' potential-flow coefficients or None) of the R rows of chunk
        ``p``: the design's own, or with the geometry axis the rows'
        :class:`GeometryConstants` (computed here from their ``geom``
        unless given), marked "geometry"."""
        d, ms, _ = self._design_rows(p, R)
        if not self.geometry:
            hc0 = {k: v.expand((R,) + v.shape) for k, v in self.hc0.items()}
            return d, ms, hc0, self.C_elast, None
        gc = p.get("geom_const")
        if gc is None:
            gc = self.geometry_constants({k[5:]: v for k, v in p.items()
                                          if k.startswith("geom.")})
        mark("geometry")
        d = dict(d, K_h=gc.K_h, F_und=gc.F_und, M_struc=gc.M_struc,
                 A_hydro=gc.hc0["A_hydro"], Imat=gc.hc0["Imat"],
                 a_i=gc.hc0["a_i"],
                 **{k: getattr(gc.ss, k) for k in ("ds", "drs", "Cd_q",
                                                   "Cd_p1", "Cd_p2",
                                                   "Cd_End")})
        hc0 = {k: gc.hc0[k] for k in ("r", "q", "p1", "p2", "sub")}
        return d, gc.ms, hc0, gc.C_elast, gc.bem

    def _chunk(self, p, mark):
        from raft_tpu_torch.structure import bucketing

        R = p["Hs"].shape[0]
        mark("start")
        d, ms, hc0, C_elast, bem = self._structure(p, R, mark)
        aero = self._aero(p, R)
        mark("aero")

        F_current = morison.current_loads(
            bucketing.site_of(d, self.body.N), bucketing.strips_of(d), hc0,
            p["current_speed"], p["current_heading_deg"], self.Zref,
            self.fs.shearExp_water, self.Tn0.expand(R, -1, -1, -1),
            d["node_r0"])
        X0, _, _, _, st_status, C_moor = solve_equilibrium(
            self.fs, ms, d["K_h"], d["F_und"], F_current + aero["f_aero0"],
            C_elast=C_elast)
        mark("statics")

        lin = dict(M=aero["A_aero"],
                   B=aero["B_aero"] + aero["B_gyro"][..., None], C=C_elast)
        pot = self._potential(p, bem)
        if pot is not None:
            lin.update(A=pot["A"], X=pot["X"],
                       B=aero["B_aero"] + pot["B"] + aero["B_gyro"][..., None])
        if self.qtf is not None:
            lin["qtf"] = self.qtf
        out = self.body.respond(
            d, X0, st_status, C_moor, p["Hs"], p["Tp"],
            p["beta_deg"] * (math.pi / 180), mark, gamma=p["gamma"],
            lin=lin, input_clipped=aero["input_clipped"])
        Xi = out["Xi"]
        if self.qtf is not None:
            # the mean drift moves the reported offsets; Xi stays
            X0, _, _, _, st2, _ = solve_equilibrium(
                self.fs, ms, d["K_h"], d["F_und"],
                F_current + aero["f_aero0"]
                + torch.sum(out["F_2nd_mean"], dim=1), C_elast=C_elast)
            finite = torch.all(torch.isfinite(X0), dim=-1)
            out["status"] = health.set_bit(
                out["status"] | st2, health.NONFINITE_INTERMEDIATE,
                (~finite).to(torch.int32))
            out["X0"] = X0
            mark(DRIFT_STAGE)
        out.update(
            Xi=torch.cat([Xi, torch.zeros((R, 1) + Xi.shape[2:],
                                          dtype=Xi.dtype,
                                          device=Xi.device)], dim=1),
            F_2nd_mean=out.get("F_2nd_mean", torch.zeros(
                (R, self.nWaves, 6), dtype=self.rdt, device=X0.device)),
            **{k: aero[k] for k in ("f_aero", "A00", "B00", "f_aero0",
                                    "Omega_rpm", "pitch_deg")})
        return {k: out[k] for k in FULL_OUT_KEYS}


def make_full_evaluator(model, nWaves=1, turb_static=None, device=None,
                        geometry=False):
    """The batched :class:`FullEvaluator` of ``model`` with ``nWaves``
    wave headings per row, on ``device`` (default: the current CUDA
    device; raises without one).  ``turb_static`` is the turbulence
    model and class reference speed (default ``("NTM", 50.0)``).
    ``geometry=True`` adds the geometry design axis (rigid members; a
    potential-flow design's coefficients are interpolated in one
    uniform ``d_scale`` per row)."""
    return _stamped(FullEvaluator(model, nWaves=nWaves,
                                  turb_static=turb_static, device=device,
                                  geometry=geometry),
                    make_full_evaluator, model, nWaves=nWaves,
                    turb_static=turb_static, geometry=geometry)


# ------------------------------------------------------------------ farm

#: the output keys of :class:`FarmEvaluator`, as the reference's
FARM_OUT_KEYS = ("X0", "Xi", "PSD", "S", "zeta", "drag_resid", "n_iter_drag",
                 "status")
#: the stages a :class:`FarmEvaluator` timer is called with, in order
FARM_STAGES = ("aero", "statics", "excitation", "fixed_point",
               "system_response")


class FarmMooring:
    """``mooring_fn(X) -> (F, C)`` of an array over its poses X (R, nT):
    every unit's own catenary lines (padded to one line count, masked)
    as rows of one catenary call, then each network, a unit's own
    (MoorDyn file with free points) or the array's shared one last,
    as the reference's closures add them.  C is the units' blocks plus
    the shared network's coupled stiffness; :meth:`parts` gives the two
    apart at a pose (the system impedance takes them apart), and
    ``calls`` counts the evaluations.

    It speaks the statics' implicit protocol
    (:class:`~raft_tpu_torch.models.statics_solve.MooringClosure`):
    :meth:`with_root` evaluates at a pose and keeps its converged state
    (the lines' loads, each network's free points and line loads), and
    :meth:`at_root` writes F and C from that state, differentiable in
    the pose (the loads and free points attached by their implicit
    rules, nothing solved again).  At the attached equilibrium pose its
    stiffness parts are kept for :meth:`parts`, with their graph."""

    def __init__(self, lines, networks, nF):
        self.lines = lines          # (fair0, anchor, L, w, EA, mask) or None
        self.networks = networks    # [(network, unit indices, shared)]
        self.nF = nF
        self.calls = 0
        self._last = None
        self._att = None

    def _evaluate(self, X, root=None):
        """(F (R, nF, 6), C_units (R, nF, 6, 6), Ka (R, nT, nT), the
        converged state) at X: solved, or with ``root`` written from
        that state (:meth:`at_root`)."""
        from raft_tpu_torch.physics import mooring

        R, nF = X.shape[0], self.nF
        Xb = X.reshape(R, nF, 6)
        F = torch.zeros_like(Xb)
        C_units = torch.zeros((R, nF, 6, 6), dtype=X.dtype, device=X.device)
        Ka = torch.zeros((R, 6 * nF, 6 * nF), dtype=X.dtype, device=X.device)
        state = dict(lines=None, nets=[])
        if self.lines is not None:
            args = [a[None].expand((R,) + a.shape).reshape(
                (R * nF,) + a.shape[1:]) for a in self.lines]
            Xl = Xb.reshape(R * nF, 6)
            if root is None:
                Fl, Cl, state["lines"] = mooring.line_forces_and_stiffness(
                    *args, Xl, root=True)
            else:
                Fl, Cl = mooring.line_forces_at_root(*args, Xl,
                                                     *root["lines"])
            F = F + Fl.reshape(R, nF, 6)
            C_units = C_units + Cl.reshape(R, nF, 6, 6)
        for k, (net, units, shared) in enumerate(self.networks):
            out = net.solve(Xb[:, units],
                            root=None if root is None else root["nets"][k])
            state["nets"].append(out["root"])
            F[:, units] += out["F"]
            if shared:
                idx = torch.as_tensor([6 * u + j for u in units
                                       for j in range(6)], device=X.device)
                Ka[:, idx[:, None], idx] += out["K"]
            else:
                C_units[:, units[0]] += out["K"]
        self.calls += 1
        if root is None:
            self._last = (X, C_units, Ka)
        return F, C_units, Ka, state

    def __call__(self, X):
        F, C_units, Ka, _ = self._evaluate(X)
        return F.reshape(X.shape), _block_diag(C_units) + Ka

    def with_root(self, X):
        """(F, C, converged state) at X, forward values only."""
        with torch.no_grad():
            F, C_units, Ka, state = self._evaluate(X)
        state.update(C_units=C_units, Ka=Ka)
        return F.reshape(X.shape), _block_diag(C_units) + Ka, state

    def at_root(self, X, root):
        """(F, C) at X written from the converged state ``root`` of that
        pose, differentiable in X; C keeps the values :meth:`with_root`
        gave, with the derivatives of the implicit form.  The stiffness
        parts at X are kept for :meth:`parts`."""
        F, Cu, Ka, _ = self._evaluate(X, root=root)
        Cu = root["C_units"] + (Cu - Cu.detach())
        Ka = root["Ka"] + (Ka - Ka.detach())
        self._att = (X, Cu, Ka)
        return F.reshape(X.shape), _block_diag(Cu) + Ka

    def differentiated(self, X):
        """The array's mooring has no parameter to differentiate."""
        return False

    def parts(self, X):
        """(C_units (R, nF, 6, 6), the shared network's stiffness
        (R, nT, nT)) at X: the last evaluation's when it was at X.  A
        pose being differentiated (it requires grad, or carries a
        forward-mode tangent) must be the attached equilibrium pose the
        statics returned: it gets the parts :meth:`at_root` kept there,
        with their graph and tangents (handed over once, so no graph
        outlives its chunk)."""
        if ad.differentiated(X):
            att, self._att = self._att, None
            if att is None or att[0] is not X:
                raise RuntimeError(
                    "FarmMooring.parts: a pose being differentiated must "
                    "be the one the statics attached through at_root")
            return att[1], att[2]
        last = self._last
        if last is None or last[0].shape != X.shape or not torch.equal(
                last[0], X):
            self._evaluate(X)
        return self._last[1], self._last[2]


def _block_diag(blocks):
    """(R, n, k, k) blocks -> (R, n k, n k) block-diagonal matrices."""
    R, n, k = blocks.shape[:3]
    out = torch.zeros((R, n, k, n, k), dtype=blocks.dtype,
                      device=blocks.device)
    i = torch.arange(n, device=blocks.device)
    out[:, i, :, i, :] = blocks.transpose(0, 1)
    return out.reshape(R, n * k, n * k)


class FarmEvaluator(nn.Module):
    """Batched full-physics evaluator of a multi-FOWT array (the
    reference's ``make_farm_evaluator``).

    ``forward(**rows, timer=None)`` takes R rows of :data:`ENV_KEYS` and
    :data:`SEA_KEYS` as :class:`FullEvaluator` does, except that
    ``wind_speed`` may be per unit (the waked speeds): a scalar, (R,) or
    (R, nFOWT).  It returns :data:`FARM_OUT_KEYS` per row: X0 (nT,), Xi
    (nWaves + 1, nT, nw) (the last heading zero), PSD, S and zeta per
    heading, drag_resid and n_iter_drag per unit and one status word
    (nT = 6 nFOWT).  Per chunk of ``RAFT_TPU_BUCKET_ROWS`` rows, with the
    units of a row as extra rows of each per-unit stage:

    1. ``aero``: every active rotor of every unit at that unit's speed,
       one blade-element call per rotor for all units alike;
    2. ``statics``: current loads at each unit's zero pose, then the
       coupled equilibrium over all units with their own moorings and
       the shared network (:class:`FarmMooring`);
    3. ``excitation``: each unit's strip excitation at its displaced
       pose, the array phase carried by its absolute node positions;
    4. ``fixed_point``: each unit's drag-linearised impedance with its
       own mooring stiffness only, every (row, unit) with its own trips;
    5. ``system_response``: the block impedance of the units plus the
       shared network's stiffness at X0, solved for every heading (N =
       nT: the solve kernel up to N = 12, ``torch.linalg.solve`` above).

    The status word ORs every unit's dynamics bits with the coupled
    statics bits and the output guards.  The reference's evaluator has
    no ``RAFT_TPU_FUSED`` path, and neither does this one.

    Every row input is differentiable in reverse and forward mode: the
    coupled statics by their implicit rule with :class:`FarmMooring`'s
    state attached (each network's free points by their own implicit
    rule), so the shared stiffness at X0 carries its pose derivative
    into the system response, whose backward is the solve's adjoint and
    whose tangent one more solve (at nT <= 12 the kernel's N = 7-12
    adjoint and forward entries on the card).
    """

    def __init__(self, model, nWaves=1, turb_static=None, device=None):
        super().__init__()
        from raft_tpu_torch.models.statics_solve import make_tolerances
        from raft_tpu_torch.physics.aero import rotor_tensors
        from raft_tpu_torch.physics.mooring import MooringNetwork
        from raft_tpu_torch.physics.statics import node_T
        from raft_tpu_torch.structure import bucketing

        device = resolve_device(device)
        self.device = device
        self.rdt, self.cdt = compute_dtypes()
        fowts = model.fowtList
        self.nF = nF = model.nFOWT
        if not all(fs.is_single_body for fs in fowts):
            raise NotImplementedError(
                "the farm evaluator covers rigid 6-DOF units (flexible "
                "units: ROADMAP A11); Model.analyze_cases takes them")
        if any(bucketing.has_potential_flow(fs) for fs in fowts):
            raise NotImplementedError(
                "potential-flow units (potMod members or hydroPath "
                "coefficients) in an array: the reference's farm "
                "evaluator refuses them (ROADMAP A11); Model.analyze_cases "
                "takes them")
        if model.qtf_path() is not None:
            raise NotImplementedError(
                "second-order forces from an external QTF in an array: the "
                "reference's farm evaluator refuses them (ROADMAP A13 "
                "ported them to make_full_evaluator only); "
                "Model.analyze_cases takes them")
        self.nT = 6 * nF
        self.nWaves = int(nWaves)
        if self.nWaves < 1:
            raise ValueError(f"nWaves={nWaves}: need at least one heading")
        self.turb_static = tuple(turb_static or ("NTM", 50.0))
        self.fs = fowts[0]
        self.nw = model.nw
        self.dw = float(model.w[1] - model.w[0])
        self.n_iter, self.Xi_start = model.nIter, model.XiStart
        self.n_iter_extra = model.nIterExtra
        kw = dict(dtype=self.rdt, device=device)
        self.w = torch.as_tensor(np.asarray(model.w, dtype=float), **kw)

        # every unit packed into one signature (the largest strip and
        # node counts), its mooring left to FarmMooring
        S = max(model.hydro[i].strips.S for i in range(nF))
        N = max(fs.n_nodes for fs in fowts)
        self.N = N
        sig = ("rigid6", bucketing.BUCKET_VERSION, S, N, 0,
               tuple(float(x) for x in np.asarray(model.w)),
               int(model.nIter), float(model.XiStart), int(model.nIterExtra))
        self.units = bucketing.packed_from_numpy(bucketing.stack_packed(
            [bucketing.pack_design(model, sig, ifowt=i, mooring=False)
             for i in range(nF)]), device)
        u = self.units
        self.K_h = _block_diag(u["K_h"][None])[0]
        self.C_elast = torch.as_tensor(np.stack(
            [model.statics(i)["C_elast"] for i in range(nF)])).to(**kw)
        self.C_elast_T = _block_diag(self.C_elast[None])[0]
        self.F_und = u["F_und"].reshape(-1)

        def padded(a, fill):
            a = np.asarray(a)
            tail = np.full((S - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, tail])

        self.hc0 = {k: torch.as_tensor(np.stack([
            padded(model.hydro[i].hc0[k], False if k == "sub" else 0.0)
            for i in range(nF)])).to(
                device=device, dtype=torch.bool if k == "sub" else self.rdt)
            for k in ("r", "q", "p1", "p2", "sub")}
        self.Tn0 = node_T(u["node_r0"], u["node_r0"][torch.arange(nF),
                                                     u["root"].long()])
        self.Zref = torch.as_tensor(
            [min([r.Zhub for r in fs.rotors if r.Zhub < 0], default=0.0)
             for fs in fowts], **kw)
        tols, caps, refs = make_tolerances(fowts)
        self.tol_vec, self.caps, self.refs = (torch.tensor(v, **kw)
                                              for v in (tols, caps, refs))

        # (ir, rotor tensors, [(units, their properties, nodes)]) of every
        # rotor with aero-servo physics; units whose properties agree
        # share one blade-element call
        rotor_models = model.rotor_aero if fowts[0].nrotors else []
        self.rotors = []
        for ir, rot in enumerate(rotor_models):
            groups = {}
            for i, fs in enumerate(fowts):
                rp = fs.rotors[ir]
                if rp.aeroServoMod <= 0:
                    continue
                key = tuple(getattr(rp, k) for k in (
                    "shaft_tilt", "shaft_toe", "Zhub", "aeroServoMod",
                    "overhang", "I_drivetrain", "yaw_mode"))
                groups.setdefault(key, (rp, []))[1].append(i)
            if groups:
                self.rotors.append((ir, rotor_tensors(rot, device, self.rdt), [
                    (units, rp, [int(fowts[i].rotor_node[ir]) for i in units])
                    for rp, units in groups.values()]))

        self.mooring = FarmMooring(
            self._unit_lines(model.ms_list, kw),
            [(ms, [i], False) for i, ms in enumerate(model.ms_list)
             if isinstance(ms, MooringNetwork)]
            + ([(model.ms_array, list(range(model.ms_array.n_bodies)), True)]
               if model.ms_array is not None else []), nF)

    def _unit_lines(self, ms_list, kw):
        """The units' own catenary lines as (nF, nL, ...) tensors padded
        to one line count (a padded line repeats a real one and is
        masked out), or None when no unit has one."""
        from raft_tpu_torch.physics.mooring import MooringSystem

        systems = [ms if isinstance(ms, MooringSystem) else None
                   for ms in ms_list]
        real = [ms for ms in systems if ms is not None]
        if not real:
            return None
        nL = max(ms.n_lines for ms in real)
        cols = []
        for key in ("r_fair0", "r_anchor", "L", "w", "EA"):
            per = []
            for ms in systems:
                a = np.asarray(getattr(ms or real[0], key), dtype=float)
                per.append(np.concatenate([a, np.repeat(
                    a[:1], nL - a.shape[0], axis=0)]))
            cols.append(torch.as_tensor(np.stack(per), **kw))
        mask = torch.as_tensor(np.stack([
            np.arange(nL) < (ms.n_lines if ms is not None else 0)
            for ms in systems]), device=kw["device"])
        return tuple(cols) + (mask,)

    def forward(self, timer=None, **rows):
        p, n = self._rows(rows)
        cap = int(config.get("BUCKET_ROWS")) or n
        mark = timer if timer is not None else (lambda stage: None)
        grad = ad.differentiated(*p.values())
        with torch.set_grad_enabled(grad):
            outs = [self._chunk({k: v[a:a + cap] for k, v in p.items()}, mark)
                    for a in range(0, n, cap)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _rows(self, rows):
        """The row parameters as tensors of n rows: (n,) environment,
        (n, nFOWT) wind speeds, (n, nWaves) seas; and n."""
        unknown = set(rows) - set(ENV_KEYS + SEA_KEYS)
        if unknown:
            raise TypeError(f"unknown row parameters {sorted(unknown)}")
        if not {"Hs", "Tp"} <= set(rows):
            raise TypeError("rows need Hs and Tp")
        kw = dict(dtype=self.rdt, device=self.device)
        vals = {k: torch.as_tensor(rows.get(k, 0.0), **kw)
                for k in ENV_KEYS + SEA_KEYS}
        for k, v in vals.items():
            wide = k in SEA_KEYS or k == "wind_speed"
            if v.dim() > (2 if wide else 1):
                raise ValueError(f"{k}: shape {tuple(v.shape)} has too many "
                                 "axes")
            width = self.nF if k == "wind_speed" else self.nWaves
            if wide and v.dim() == 2 and v.shape[1] != width:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                                 f"(R, {width})")
        n = torch.broadcast_shapes(*(v.shape[:1] for v in vals.values()))
        n = n[0] if n else 1
        p = {}
        for k, v in vals.items():
            if k in SEA_KEYS or k == "wind_speed":
                v = v[:, None] if v.dim() == 1 else v
                p[k] = v.expand(n, self.nF if k == "wind_speed"
                                else self.nWaves)
            else:
                p[k] = v.expand(n)
        if n == 0:
            raise ValueError("empty batch: no rows to evaluate")
        return p, n

    def _unit_rows(self, R):
        """The units' packed leaves for R rows: (R nF, ...), row-major
        (row, unit)."""
        return {k: v[None].expand((R,) + v.shape).reshape(
            (R * self.nF,) + v.shape[1:]) for k, v in self.units.items()}

    def _aero(self, p, R):
        """Every active rotor's aero-servo terms reduced to its unit:
        f0 (R nF, 6), A, B (R nF, 6, 6, nw), B_gyro (R nF, 6, 6) and the
        rows with a clamped speed (R,)."""
        from raft_tpu_torch.physics.aero import calc_aero_traced

        rdt, dev, nF = self.rdt, self.device, self.nF
        w = freq.take(self.w)
        nw = w.shape[0]
        U = R * nF
        f0 = torch.zeros((U, 6), dtype=rdt, device=dev)
        A = torch.zeros((U, 6, 6, nw), dtype=rdt, device=dev)
        B = torch.zeros_like(A)
        Bg = torch.zeros((U, 6, 6), dtype=rdt, device=dev)
        clipped = torch.zeros(R, dtype=torch.bool, device=dev)
        deg = math.pi / 180
        for _, rt, groups in self.rotors:
            for units, rp, nodes in groups:
                nu = len(units)
                current = rp.Zhub < 0
                speed = (p["current_speed"][:, None].expand(R, nu) if current
                         else p["wind_speed"][:, units]).reshape(-1)
                heading = (p["current_heading_deg"] if current
                           else p["wind_heading_deg"]) * deg

                def per_unit(x):
                    return x.repeat_interleave(nu)

                on = speed > 0
                clipped |= (on & (speed < 0.1)).reshape(R, nu).any(dim=1)
                f0r, _, a6, b6, Bgr, _, _, _ = calc_aero_traced(
                    rt, rp, w, torch.clamp(speed, min=0.1),
                    per_unit(heading), per_unit(p["TI"]),
                    yaw_command_rad=per_unit(p["yaw_misalign_deg"] * deg),
                    turb_static=self.turb_static,
                    dw=self.w[1] - self.w[0])
                Tn = self.Tn0[units, nodes]                     # (nu, 6, 6)
                Tn = Tn[None].expand(R, -1, -1, -1).reshape(-1, 6, 6)
                onr = on.to(rdt)
                idx = (torch.arange(R, device=dev)[:, None] * nF
                       + torch.as_tensor(units, device=dev)).reshape(-1)
                f0[idx] += onr[:, None] * (f0r[:, None, :] @ Tn)[:, 0]
                A[idx] += onr[:, None, None, None] * torch.einsum(
                    "ria,rijw,rjb->rabw", Tn, a6, Tn)
                B[idx] += onr[:, None, None, None] * torch.einsum(
                    "ria,rijw,rjb->rabw", Tn, b6, Tn)
                Bg[idx] += onr[:, None, None] * (Tn.transpose(-1, -2) @ Bgr
                                                 @ Tn)
        return f0, A, B, Bg, clipped

    def _chunk(self, p, mark):
        from raft_tpu_torch.models.dynamics import (solve_dynamics_fowt,
                                                    system_response)
        from raft_tpu_torch.models.statics_solve import \
            solve_equilibrium_general
        from raft_tpu_torch.physics.statics import node_T, platform_kinematics
        from raft_tpu_torch.structure import bucketing

        R, nF, nT = p["Hs"].shape[0], self.nF, self.nT
        w = freq.take(self.w)
        nw = w.shape[0]
        U = R * nF
        mark("start")
        f0, A_aero, B_aero, B_gyro, clipped = self._aero(p, R)
        mark("aero")

        d = self._unit_rows(R)
        site = bucketing.site_of(d, self.N)
        ss = bucketing.strips_of(d)
        hc0 = {k: v[None].expand((R,) + v.shape).reshape((U,) + v.shape[1:])
               for k, v in self.hc0.items()}
        Tn0 = self.Tn0[None].expand((R,) + self.Tn0.shape).reshape(
            (U,) + self.Tn0.shape[1:])
        F_cur = morison.current_loads(
            site, ss, hc0, p["current_speed"].repeat_interleave(nF),
            p["current_heading_deg"].repeat_interleave(nF),
            self.Zref.repeat(R)[:, None], self.fs.shearExp_water, Tn0,
            d["node_r0"])
        F_env = (F_cur + f0).reshape(R, nT)
        X0, _, _, _, st_status, _ = solve_equilibrium_general(
            self.K_h.expand(R, nT, nT), self.F_und.expand(R, nT), F_env,
            self.mooring, self.tol_vec, self.caps, self.refs,
            C_elast=self.C_elast_T)
        mark("statics")

        # ---- per-unit excitation at the displaced poses
        C_units, Ka = self.mooring.parts(X0)
        Xu = X0.reshape(U, 6)
        r_nodes, R_ptfm, r_root = platform_kinematics(d["node_r0"],
                                                      d["root"], Xu)
        Tn = node_T(r_nodes, r_root)
        hc = bucketing.packed_hydro(d, ss, R_ptfm, r_nodes)
        S_spec = wv.jonswap(w, p["Hs"], p["Tp"], gamma=p["gamma"])
        zeta = wv.amplitudes(S_spec, self.dw).to(_policy_cdt(X0))
        zeta_u = zeta.repeat_interleave(nF, dim=0)
        beta_u = (p["beta_deg"] * (math.pi / 180)).repeat_interleave(nF,
                                                                      dim=0)
        exc = [morison.hydro_excitation(site, ss, hc, zeta_u[:, ih],
                                        beta_u[:, ih], w, freq.take(d["k"]),
                                        Tn, r_nodes)
               for ih in range(self.nWaves)]
        mark("excitation")

        # ---- per-unit drag fixed point with the unit's own mooring
        M_lin = A_aero + (d["M_struc"] + d["A_hydro"])[..., None]
        B_lin = B_aero + B_gyro[..., None]
        C_lin = d["K_h"] + C_units.reshape(U, 6, 6) \
            + self.C_elast.repeat(R, 1, 1)
        Z, _, Bmat, diag = solve_dynamics_fowt(
            site, ss, hc, exc[0]["u"], M_lin, B_lin, C_lin,
            exc[0]["F_hydro_iner"], w, Tn, r_nodes, n_iter=self.n_iter,
            Xi_start=self.Xi_start, n_iter_extra=self.n_iter_extra,
            timer=mark)

        # ---- system response: unit blocks + shared stiffness at X0
        F_sys = torch.stack([
            (exc[ih]["F_hydro_iner"] + morison.drag_excitation(
                site, ss, hc, Bmat, exc[ih]["u"], Tn, r_nodes)).reshape(
                    R, nT, nw) for ih in range(self.nWaves)], dim=1)
        Zb = Z.reshape(R, nF, nw, 6, 6).transpose(1, 2).reshape(
            R * nw, nF, 6, 6)
        Z_sys = _block_diag(Zb).reshape(R, nw, nT, nT) + Ka[:, None]
        Xi = system_response(Z_sys[:, None], F_sys)
        Xi = torch.cat([Xi, torch.zeros((R, 1, nT, nw), dtype=Xi.dtype,
                                        device=Xi.device)], dim=1)
        dyn = diag["status"].reshape(R, nF)
        dyn_status = dyn[:, 0]
        for i in range(1, nF):
            dyn_status = dyn_status | dyn[:, i]
        out = dict(
            X0=X0, Xi=Xi, PSD=torch.sum(0.5 * torch.abs(Xi) ** 2 / self.dw,
                                        dim=1),
            S=S_spec, zeta=zeta,
            drag_resid=diag["drag_resid"].reshape(R, nF),
            n_iter_drag=diag["n_iter_drag"].reshape(R, nF),
            status=_case_status(st_status, dict(status=dyn_status), X0, Xi,
                                input_clipped=clipped))
        mark("system_response")
        return out


def make_farm_evaluator(model, nWaves=1, turb_static=None, device=None):
    """The batched :class:`FarmEvaluator` of an array ``model`` with
    ``nWaves`` wave headings per row, on ``device`` (default: the current
    CUDA device; raises without one).  ``turb_static`` is the turbulence
    model and class reference speed (default ``("NTM", 50.0)``)."""
    return _stamped(FarmEvaluator(model, nWaves=nWaves,
                                  turb_static=turb_static, device=device),
                    make_farm_evaluator, model, nWaves=nWaves,
                    turb_static=turb_static)


# -------------------------------------------------------------- flexible

#: the output keys of :class:`FlexibleEvaluator`, as the reference's
FLEX_OUT_KEYS = ("X0", "Xi", "PSD", "S", "zeta", "drag_resid",
                 "drag_converged", "n_iter_drag", "status")
#: the stages a :class:`FlexibleEvaluator` timer is called with, in order
#: (with the geometry axis, "geometry" first)
FLEX_STAGES = ("aero", "statics", "kinematics", "excitation", "fixed_point",
               "response")
#: rows per chunk of the flexible evaluator, from the device memory a
#: row takes.  At n = 168 DOFs and 40 frequencies one row's impedance Z
#: (nw, n, n) complex128 is 18.1 MB and each (n, n, nw) float64 operand
#: (M_lin, A_aero, B_aero, B_lin) 9.0 MB; with the impedance's
#: intermediates, the trip's Z and the library's LU copy, a 64-row chunk
#: of semi_wind_flex peaked at 5,992 MiB on an H100 (94 MiB a row,
#: ``chip_smoke.py`` flex phase), so 256 rows take about 24 GB, under a
#: third of the card's 80 GB, and leave the rest to the caller
FLEX_ROWS = 256
#: the geometry keys of ``struct_params`` (:func:`flexible_struct_params`)
FLEX_STRUCT_KEYS = ("K_h", "C_elast", "F_und", "M_struc")
FLEX_HC0_KEYS = ("A_hydro", "Amat", "Imat", "a_i")
FLEX_SS_KEYS = ("ds", "drs", "Cd_q", "Cd_p1", "Cd_p2", "Cd_End", "Ca_q",
                "Ca_p1", "Ca_p2", "Ca_End", "Cm_p1_w", "Cm_p2_w")


def flexible_struct_params(model):
    """The geometry-dependent constants of a flexible model (the
    reference's ``flexible_struct_params``), as numpy: the statics
    matrices K_h, C_elast, M_struc and F_und, the zero-pose hydro
    constants ``hc0``, the strip tables ``ss`` and the mooring's L, EA
    and w (``ms``).  Models rebuilt on the host at other member d/t
    share the station layout (nodes, topology, strip counts), so their
    parameters stack per row into one :class:`FlexibleEvaluator` with
    ``geometry=True``."""
    fh = model.hydro[0]
    stat = model.statics()
    ss = fh.strips
    ms = model.ms
    out = dict(
        K_h=np.asarray(stat["C_struc"] + stat["C_hydro"]),
        C_elast=np.asarray(stat["C_elast"]),
        F_und=np.asarray(stat["W_struc"] + stat["W_hydro"]
                         + stat["f0_additional"]),
        M_struc=np.asarray(stat["M_struc"]),
        hc0={k: np.asarray(fh.hc0[k]) for k in FLEX_HC0_KEYS},
        ss={k: np.asarray(getattr(ss, k)) for k in FLEX_SS_KEYS},
    )
    if ms is not None:
        out["ms"] = dict(L=np.asarray(ms.L), EA=np.asarray(ms.EA),
                         w=np.asarray(ms.w))
    return out


class FlexibleEvaluator(nn.Module):
    """Batched full-physics evaluator of one flexible or multibody FOWT
    (reduced N-DOF structures with beam members; the reference's
    ``make_flexible_evaluator``).

    ``forward(**rows, timer=None)`` takes R rows of :data:`ENV_KEYS`
    and :data:`SEA_KEYS` as :class:`FullEvaluator` does and returns
    :data:`FLEX_OUT_KEYS` per row: X0 (n,), Xi (nWaves + 1, n, nw) (the
    last heading zero), PSD, S and zeta per heading, and the drag fixed
    point's diagnostics and the status word.  Per chunk of
    :data:`FLEX_ROWS` rows, in the reference's order:

    1. ``aero``: every active rotor's aero-servo terms, reduced through
       its node's rows of the zero-pose T;
    2. ``statics``: current loads at the zero pose, then the N-DOF
       Newton equilibrium with the elastic stiffness C_elast and the
       mooring on the first six DOFs;
    3. ``kinematics``: the displaced-pose node positions, rotations and
       T of :class:`~raft_tpu_torch.structure.topology_traced.
       TracedTopology`, and the strip frames there (each member rotated
       with its first node);
    4. ``excitation``: the spectra and the strip excitation per heading;
    5. ``fixed_point``: the drag-linearised (nw, n, n) impedance solves
       (``torch.linalg.solve`` above 12 DOFs, as the reference's
       ``jnp.linalg.solve``);
    6. ``response``: the drag excitation of every heading and a second
       solve, always (the reference's flexible evaluator takes the
       staged response whatever ``RAFT_TPU_FUSED`` says).

    With ``geometry=True`` a row may carry ``struct_params``: the
    :func:`flexible_struct_params` of a model rebuilt on the host at
    other member d/t (one design for every row, or stacked with a
    leading row axis), which replace K_h, C_elast, F_und, M_struc, the
    zero-pose hydro constants, the strip tables and the mooring's L, EA
    and w (timer stage "geometry" first).

    Every row input and every ``struct_params`` leaf is differentiable
    in reverse and forward mode (the host rebuild that made the leaves
    is not, as in the reference); the adjoint and tangent solves of the
    N-DOF systems go to ``torch.linalg.solve``, as the forward's do.
    """

    def __init__(self, model, nWaves=1, turb_static=None, device=None,
                 geometry=False):
        super().__init__()
        from raft_tpu_torch.models.statics_solve import make_tolerances
        from raft_tpu_torch.physics.aero import rotor_tensors
        from raft_tpu_torch.structure.topology_traced import TracedTopology

        if model.nFOWT != 1:
            raise ValueError("the flexible evaluator covers single-FOWT "
                             "models: an array runs through "
                             "make_farm_evaluator")
        fs = model.fowtList[0]
        if fs.is_single_body:
            raise ValueError("a rigid 6-DOF FOWT runs through "
                             "make_full_evaluator (this is the N-DOF path)")
        from raft_tpu_torch.structure.bucketing import has_potential_flow

        if has_potential_flow(fs):
            raise NotImplementedError(
                "potential-flow coefficients on a flexible structure: the "
                "reference's flexible evaluator refuses them (ROADMAP A11); "
                "Model.analyze_cases takes them")
        if model.qtf_path() is not None:
            raise NotImplementedError(
                "second-order forces from an external QTF on a flexible "
                "structure: the reference's flexible evaluator refuses them "
                "(ROADMAP A13 ported them to make_full_evaluator only); "
                "Model.analyze_cases takes them")
        device = resolve_device(device)
        self.device = device
        self.rdt, self.cdt = compute_dtypes()
        self.nWaves = int(nWaves)
        if self.nWaves < 1:
            raise ValueError(f"nWaves={nWaves}: need at least one heading")
        self.geometry = bool(geometry)
        self.turb_static = tuple(turb_static or ("NTM", 50.0))
        self.fs = fs
        self.n = fs.nDOF
        self.nw = model.nw
        self.dw = float(model.w[1] - model.w[0])
        self.n_iter, self.Xi_start = model.nIter, model.XiStart
        self.n_iter_extra = model.nIterExtra
        self.tt = TracedTopology(fs)
        kw = dict(dtype=self.rdt, device=device)
        self.w = torch.as_tensor(np.asarray(model.w, dtype=float), **kw)
        self.k = torch.as_tensor(np.asarray(model.k, dtype=float), **kw)
        self.Tn0 = torch.as_tensor(fs.T.reshape(fs.n_nodes, 6, fs.nDOF),
                                   **kw)
        self.node_r0 = torch.as_tensor(fs.node_r0, **kw)
        self.site = dict(rho_water=fs.rho_water, depth=fs.depth, g=fs.g)
        fh = model.hydro[0]
        self.ss = morison.strips_to_rows(fh.strips, device)
        # the zero-pose hydro constants, and the strip frames the current
        # loads are taken at
        dts = dict(Imat=self.cdt, sub=torch.bool)
        self.hc0 = {k: torch.as_tensor(fh.hc0[k]).to(device,
                                                     dts.get(k, self.rdt))
                    for k in FLEX_HC0_KEYS + ("r", "q", "p1", "p2", "sub")}
        base = flexible_struct_params(model)
        self.struct = {k: torch.as_tensor(base[k], **kw)
                       for k in FLEX_STRUCT_KEYS}
        self.ms = None if model.ms is None else model.ms.to(device, self.rdt)
        self.Zref = min([r.Zhub for r in fs.rotors if r.Zhub < 0],
                        default=0.0)
        tols, caps, refs = make_tolerances([fs])
        self.tol_vec, self.caps, self.refs = (torch.tensor(v, **kw)
                                              for v in (tols, caps, refs))
        self.n_rot_out = max(fs.nrotors, 1)
        self.rotors = [
            (ir, fs.rotors[ir], rotor_tensors(rot, device, self.rdt),
             int(fs.rotor_node[ir]))
            for ir, rot in enumerate(model.rotor_aero if fs.nrotors else [])
            if fs.rotors[ir].aeroServoMod > 0]

    def forward(self, timer=None, struct_params=None, **rows):
        unknown = set(rows) - set(ENV_KEYS + SEA_KEYS)
        if unknown:
            raise TypeError(f"unknown row parameters {sorted(unknown)}")
        if struct_params is not None and not self.geometry:
            raise TypeError("struct_params needs "
                            "make_flexible_evaluator(..., geometry=True)")
        if not {"Hs", "Tp"} <= set(rows):
            raise TypeError("rows need Hs and Tp")
        kw = dict(dtype=self.rdt, device=self.device)
        vals = {k: torch.as_tensor(rows.get(k, 0.0), **kw)
                for k in ENV_KEYS + SEA_KEYS}
        sp = _tree_map(self._param, struct_params)
        grad = ad.differentiated(*vals.values(), *_tree_leaves(sp))
        for k, v in vals.items():
            if v.dim() > (2 if k in SEA_KEYS else 1):
                raise ValueError(f"{k}: shape {tuple(v.shape)} has too many "
                                 "axes")
            if k in SEA_KEYS and v.dim() == 2 and v.shape[1] != self.nWaves:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                                 f"(R, {self.nWaves})")
        lead = [v.shape[:1] for v in vals.values()]
        per_row = sp is not None and sp["K_h"].dim() == 3
        if per_row:
            lead.append(sp["K_h"].shape[:1])
        n = torch.broadcast_shapes(*lead)
        n = n[0] if n else 1
        if n == 0:
            raise ValueError("empty batch: no rows to evaluate")
        p = {}
        for k, v in vals.items():
            if k in SEA_KEYS:
                v = v[:, None] if v.dim() == 1 else v
                p[k] = v.expand(n, self.nWaves)
            else:
                p[k] = v.expand(n)
        mark = timer if timer is not None else (lambda stage: None)
        outs = []
        with torch.set_grad_enabled(grad):
            for a in range(0, n, FLEX_ROWS):
                chunk = {k: v[a:a + FLEX_ROWS] for k, v in p.items()}
                R = chunk["Hs"].shape[0]
                csp = None if sp is None else _tree_map(
                    (lambda t: t[a:a + FLEX_ROWS]) if per_row
                    else (lambda t: t.expand((R,) + t.shape)), sp)
                outs.append(self._chunk(chunk, csp, mark))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _param(self, a):
        """One struct_params leaf on the device in the policy's dtype."""
        t = torch.as_tensor(a)
        return t.to(self.device, self.cdt if t.is_complex() else self.rdt)

    def _structure(self, R, sp, mark):
        """(K_h, C_elast, F_und, M_struc, hc0, ss, ms) of R rows: the
        model's own, or the rows' ``struct_params`` (marked
        "geometry")."""
        st = {k: v.expand((R,) + v.shape) for k, v in self.struct.items()}
        hc0 = {k: v.expand((R,) + v.shape) for k, v in self.hc0.items()}
        ss, ms = self.ss, self.ms
        ss = morison.StripSet(**{
            k: v.expand((R,) + v.shape[1:]) if isinstance(v, torch.Tensor)
            else v for k, v in vars(ss).items()})
        if sp is None:
            return st, hc0, ss, ms
        st = {k: sp[k] for k in FLEX_STRUCT_KEYS}
        hc0 = dict(hc0, **sp["hc0"])
        ss = dataclasses.replace(ss, **sp["ss"])
        if ms is not None and "ms" in sp:
            ms = dataclasses.replace(ms, **sp["ms"])
        mark("geometry")
        return st, hc0, ss, ms

    def _chunk(self, p, sp, mark):
        from raft_tpu_torch.models.dynamics import (solve_dynamics_fowt,
                                                    system_response)
        from raft_tpu_torch.models.statics_solve import (
            single_ms_closures, solve_equilibrium_general)

        R, n = p["Hs"].shape[0], self.n
        w = freq.take(self.w)
        nw = w.shape[0]
        mark("start")
        st, hc0, ss, ms = self._structure(R, sp, mark)
        aero = _rotor_terms(self, p, R)
        mark("aero")

        kw = dict(dtype=self.rdt, device=self.device)
        site = morison.SiteRows(
            **{k: torch.full((R,), float(v), **kw)
               for k, v in self.site.items()}, n_nodes=self.fs.n_nodes)
        Tn0 = self.Tn0.expand((R,) + self.Tn0.shape)
        node_r0 = self.node_r0.expand((R,) + self.node_r0.shape)
        F_current = morison.current_loads(
            site, ss, hc0, p["current_speed"], p["current_heading_deg"],
            self.Zref, self.fs.shearExp_water, Tn0, node_r0)
        X0, _, _, _, st_status, C_moor = solve_equilibrium_general(
            st["K_h"], st["F_und"], F_current + aero["f_aero0"],
            single_ms_closures(ms, n), self.tol_vec, self.caps, self.refs,
            C_elast=st["C_elast"])
        mark("statics")

        r_nodes, node_rot, Tn = self.tt.kinematics(X0)
        r, q, p1, p2 = morison.strip_frames(ss, None, r_nodes,
                                            node_rot=node_rot)
        sub = r[..., 2] < 0
        hc = dict(hc0, r=r, q=q, p1=p1, p2=p2, sub=sub,
                  active=sub & ss.active)
        mark("kinematics")

        S = wv.jonswap(w, p["Hs"], p["Tp"], gamma=p["gamma"])
        zeta = wv.amplitudes(S, self.dw).to(_policy_cdt(X0))
        beta = p["beta_deg"] * (math.pi / 180)
        k = freq.take(self.k).expand(R, nw)
        exc = [morison.hydro_excitation(site, ss, hc, zeta[:, ih],
                                        beta[:, ih], w, k, Tn, r_nodes)
               for ih in range(self.nWaves)]
        mark("excitation")

        M_lin = aero["A_aero"] + (st["M_struc"] + hc0["A_hydro"])[..., None]
        B_lin = aero["B_aero"] + aero["B_gyro"][..., None]
        C_lin = st["K_h"] + C_moor + st["C_elast"]
        Z, _, Bmat, diag = solve_dynamics_fowt(
            site, ss, hc, exc[0]["u"], M_lin, B_lin, C_lin,
            exc[0]["F_hydro_iner"], w, Tn, r_nodes, n_iter=self.n_iter,
            Xi_start=self.Xi_start, n_iter_extra=self.n_iter_extra,
            timer=mark)
        del M_lin, B_lin

        F_waves = torch.stack([
            exc[ih]["F_hydro_iner"] + morison.drag_excitation(
                site, ss, hc, Bmat, exc[ih]["u"], Tn, r_nodes)
            for ih in range(self.nWaves)], dim=1)
        Xi = system_response(Z[:, None], F_waves)
        Xi = torch.cat([Xi, torch.zeros((R, 1, n, nw), dtype=Xi.dtype,
                                        device=Xi.device)], dim=1)
        out = dict(
            X0=X0, Xi=Xi,
            PSD=torch.sum(0.5 * torch.abs(Xi) ** 2 / self.dw, dim=1),
            S=S, zeta=zeta, drag_resid=diag["drag_resid"],
            drag_converged=diag["drag_converged"],
            n_iter_drag=diag["n_iter_drag"],
            status=_case_status(st_status, diag, X0, Xi,
                                input_clipped=aero["input_clipped"]))
        mark("response")
        return out


def _tree_map(f, tree):
    """``f`` over the leaves of a nested dict (None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def _tree_leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def make_flexible_evaluator(model, nWaves=1, turb_static=None, device=None,
                            geometry=False):
    """The batched :class:`FlexibleEvaluator` of a flexible or multibody
    single-FOWT ``model`` with ``nWaves`` wave headings per row, on
    ``device`` (default: the current CUDA device; raises without one).
    ``turb_static`` is the turbulence model and class reference speed
    (default ``("NTM", 50.0)``); ``geometry=True`` takes per-row
    ``struct_params`` (:func:`flexible_struct_params`)."""
    return _stamped(FlexibleEvaluator(model, nWaves=nWaves,
                                      turb_static=turb_static,
                                      device=device, geometry=geometry),
                    make_flexible_evaluator, model, nWaves=nWaves,
                    turb_static=turb_static, geometry=geometry)
