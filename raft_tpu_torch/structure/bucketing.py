"""Shape-bucketed rigid-6-DOF case evaluation (batch-first counterpart of
``raft_tpu/structure/bucketing.py``).

A bucket signature is the static shape of one evaluation program:
padded strip / node / mooring-line counts, the frequency grid and the
drag fixed point's budget.  :class:`BucketEvaluator` evaluates a batch
of rows, each a padded design of that signature under one sea state
(Hs, Tp, beta): mean-offset statics with the masked catenary mooring,
strip excitation, the drag-linearised impedance solve and the
response, exactly the chain of the reference's
``make_bucket_evaluator``.

A design enters as a port :class:`~raft_tpu_torch.models.model.Model`:
:func:`bucket_signature` names its bucket (padded sizes from the
``RAFT_TPU_BUCKET_STEPS`` ladders) and :func:`pack_design` writes its
padded leaves, a dict of numpy arrays, the same leaves the reference's
``pack_design`` writes.  :func:`load_packed` reads such leaves from a
checked-in ``.npz`` (leaves plus ``sig_*`` signature entries) and
:func:`packed_from_numpy` turns leaves into tensors on a device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from raft_tpu_torch.api import (_case_status, _hydro_force_2nd_rows,
                                _policy_cdt)
from raft_tpu_torch.models.dynamics import (fused_response_enabled,
                                            solve_dynamics_fowt,
                                            system_response)
from raft_tpu_torch.models.statics_solve import (MooringClosure,
                                                 solve_equilibrium_general)
from raft_tpu_torch.ops import waves as wv
from raft_tpu_torch.parallel import freq
from raft_tpu_torch.physics import morison
from raft_tpu_torch.physics.mooring import MooringSystem
from raft_tpu_torch.physics.statics import node_T, platform_kinematics
from raft_tpu_torch.utils import config
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device

BUCKET_VERSION = 1

#: per-axis floor of the 'pow2' ladder policy (and of any explicit
#: ladder's doubling continuation)
AXIS_FLOORS = {"strips": 16, "nodes": 2, "lines": 2}

OUT_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "drag_resid", "drag_converged",
            "n_iter_drag", "status")


def signature_meta(sig):
    """Named view of a signature tuple."""
    kind, ver, S, N, L, w, nIter, XiStart, nIterExtra = sig
    if kind != "rigid6" or ver != BUCKET_VERSION:
        raise ValueError(f"unknown bucket signature {kind!r} v{ver}")
    return dict(S=S, N=N, L=L, w=np.asarray(w, dtype=float), nw=len(w),
                nIter=nIter, XiStart=XiStart, nIterExtra=nIterExtra)


class UnbucketableDesignError(ValueError):
    """The design needs physics the bucketed chain does not evaluate."""


def _ceil_pow2(n, floor=1):
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def pad_ladder(spec=None):
    """Parse a ``RAFT_TPU_BUCKET_STEPS`` spec (default: the flag) into
    ``{axis: tuple(rungs) | None}`` (``None`` = pow2 at the axis floor).

    ``spec`` is ``';'``-separated ``axis=rungs`` entries (axes
    ``strips``/``nodes``/``lines``); ``rungs`` is ``pow2`` or an
    ascending comma list, continued by doubling past its last rung."""
    spec = config.get("BUCKET_STEPS") if spec is None else spec
    ladders = dict.fromkeys(AXIS_FLOORS)
    if not spec or spec.strip().lower() == "pow2":
        return ladders
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        axis, sep, rungs = part.partition("=")
        axis = axis.strip().lower()
        if not sep or axis not in AXIS_FLOORS:
            raise ValueError(
                f"RAFT_TPU_BUCKET_STEPS entry {part!r}: expected "
                f"axis=rungs with axis one of {sorted(AXIS_FLOORS)}")
        rungs = rungs.strip().lower()
        if rungs == "pow2":
            ladders[axis] = None
            continue
        try:
            sizes = tuple(int(r) for r in rungs.split(",") if r.strip())
        except ValueError:
            raise ValueError(
                f"RAFT_TPU_BUCKET_STEPS {axis} rungs {rungs!r}: expected "
                "'pow2' or a comma list of integers")
        if not sizes or any(s <= 0 for s in sizes) or \
                any(b <= a for a, b in zip(sizes, sizes[1:])):
            raise ValueError(
                f"RAFT_TPU_BUCKET_STEPS {axis} rungs {rungs!r}: rungs "
                "must be positive and strictly ascending")
        ladders[axis] = sizes
    return ladders


def _axis_pad(n, axis, ladders=None):
    """Padded size of ``n`` real rows on ``axis``: the smallest rung
    holding ``n`` (doubling past the last rung; pow2 at the floor when
    the axis has no rungs).  ``n == 0`` stays 0 (the axis is absent)."""
    n = int(n)
    if n <= 0:
        return 0
    ladders = pad_ladder() if ladders is None else ladders
    rungs = ladders.get(axis)
    if rungs is None:
        return _ceil_pow2(n, AXIS_FLOORS[axis])
    for r in rungs:
        if r >= n:
            return r
    r = rungs[-1]
    while r < n:
        r *= 2
    return r


def tuned_rungs(observed_sizes, max_waste=0.2, floor=None):
    """The minimal ascending rung list under which every observed axis
    size pads with at most ``max_waste`` (walk the sizes descending and
    keep a rung whenever the next-larger kept rung would waste more than
    the budget); feed it into ``RAFT_TPU_BUCKET_STEPS``."""
    sizes = sorted({int(s) for s in observed_sizes if int(s) > 0})
    if not sizes:
        return ()
    floor = int(floor if floor is not None else 1)
    rungs = []
    last = None
    for s in reversed(sizes):
        s = max(s, floor)
        if last is None or 1.0 - s / last > max_waste:
            rungs.append(s)
            last = s
    return tuple(sorted(set(rungs)))


def _check_bucketable(model, full=False):
    """The reference's refusals (some already raise when the port's
    Model is built).  ``full=True`` lets potential-flow designs and
    external QTFs through: the full evaluator, which adds their
    coefficients and forces to the bucket's stages, packs them, and
    line-dynamics designs (``moorMod`` 1 or 2) with their quasi-static
    catenary."""
    if model.nFOWT != 1:
        raise UnbucketableDesignError(
            "bucketing covers single-FOWT models: an array runs through "
            "make_farm_evaluator")
    fs = model.fowtList[0]
    if not fs.is_single_body:
        raise UnbucketableDesignError(
            "bucketing covers rigid single-body (6-DOF) FOWTs")
    if not full and has_potential_flow(fs):
        # the design's flags, not model.bem_list: that would run the
        # panel solver just to refuse the design
        raise UnbucketableDesignError(
            "potential-flow coefficients are design-shaped host data: "
            "potMod and hydroPath designs run through make_full_evaluator")
    if not full and fs.potSecOrder == 2 and fs.hydroPath:
        # the flags again: the file is not read
        raise UnbucketableDesignError(
            "external QTFs are not bucketed: potSecOrder 2 designs run "
            "through make_full_evaluator (ROADMAP A13)")
    if fs.x_ref or fs.y_ref:
        raise UnbucketableDesignError("array-positioned units not bucketed")
    ms = model.ms
    if ms is not None and not isinstance(ms, MooringSystem):
        raise UnbucketableDesignError(
            "network/file moorings with free points are not bucketed")
    if not full and ms is not None and int(getattr(ms, "moorMod", 0)
                                           or 0) != 0:
        # the full evaluator, as the reference's, never reads moorMod:
        # it takes such a design with its quasi-static catenary
        raise UnbucketableDesignError("moorMod 1/2 line dynamics not bucketed")


def has_potential_flow(fs):
    """Whether a FOWT takes potential-flow coefficients: potMod members,
    or first-order WAMIT files (``hydroPath`` with ``potFirstOrder``
    1)."""
    return bool((fs.potFirstOrder == 1 and fs.hydroPath)
                or any(m.potMod for m in fs.members))


def bucket_signature(model, ladders=None, full=False):
    """Hashable static-shape signature of a model's bucket: padded
    strip / node / line counts under the pad ladders (default: the
    ``RAFT_TPU_BUCKET_STEPS`` flag), the frequency grid verbatim and the
    fixed point's budget.  ``ladders={}`` gives the unpadded signature,
    every axis at its real size.  A potential-flow or external-QTF
    design raises unless ``full`` (the full evaluator's packing)."""
    _check_bucketable(model, full)
    fs = model.fowtList[0]
    ms = model.ms
    ss = model.hydro[0].strips
    ladders = pad_ladder() if ladders is None else ladders

    def size(n, axis):
        return _axis_pad(n, axis, ladders) if ladders else int(n)

    return (
        "rigid6", BUCKET_VERSION,
        size(ss.S, "strips"), size(fs.n_nodes, "nodes"),
        0 if ms is None else size(ms.n_lines, "lines"),
        tuple(float(x) for x in np.asarray(model.w)),
        int(model.nIter), float(model.XiStart), int(model.nIterExtra),
    )


def signature_fingerprint(sig):
    """Short stable hash of a signature (for keys, file names, logs);
    the reference's hash of the same signature."""
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:12]


def _pad_rows(a, n, fill=0.0):
    """Pad array ``a`` along axis 0 up to ``n`` rows with ``fill``."""
    a = np.asarray(a)
    pad = n - a.shape[0]
    if pad < 0:
        raise ValueError(f"array of {a.shape[0]} rows exceeds bucket {n}")
    if pad == 0:
        return a.copy()
    tail = np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, tail], axis=0)


def _pad_axis_rows(a, n, axis0_fill):
    """Pad with a per-row fill vector (axis vectors get a unit entry, so
    rotations of padded strips stay well-defined)."""
    a = np.asarray(a)
    pad = n - a.shape[0]
    if pad < 0:
        raise ValueError(f"array of {a.shape[0]} rows exceeds bucket {n}")
    if pad == 0:
        return a.copy()
    tail = np.tile(np.asarray(axis0_fill, dtype=a.dtype), (pad, 1))
    return np.concatenate([a, tail], axis=0)


def pack_design(model, sig=None, ifowt=0, mooring=True):
    """One model's padded leaves in its bucket: numpy arrays of the
    bucket's static shape, the host-built statics matrices and zero-pose
    hydro constants included.  Padded strips carry zero areas and
    coefficients and a False ``strip_mask``/``active``; padded nodes get
    no strip; padded mooring lines repeat line 0 and are masked out of
    the force sum (so of the stiffness too).

    ``ifowt`` packs that unit of an array model; ``mooring=False`` leaves
    its mooring out (a signature with no lines), as the farm evaluator,
    which couples the units' moorings itself, packs them."""
    sig = sig or bucket_signature(model)
    meta = signature_meta(sig)
    S, N, L = meta["S"], meta["N"], meta["L"]
    fs = model.fowtList[ifowt]
    fh = model.hydro[ifowt]
    ss = fh.strips
    stat = model.statics(ifowt)
    ms = model.ms_list[ifowt] if mooring else None
    if not np.array_equal(np.asarray(model.w, dtype=float), meta["w"]):
        raise ValueError("model frequency grid does not match the signature")
    if (ms is None) != (L == 0):
        raise ValueError("mooring presence does not match the signature")

    d = dict(
        node=_pad_rows(np.asarray(ss.node, dtype=np.int32), S, 0),
        ls=_pad_rows(np.asarray(ss.ls, dtype=float), S),
        dls=_pad_rows(np.asarray(ss.dls, dtype=float), S),
        ds=_pad_rows(np.asarray(ss.ds, dtype=float), S),
        drs=_pad_rows(np.asarray(ss.drs, dtype=float), S),
        circ=_pad_rows(np.asarray(ss.circ, dtype=bool), S, False),
        active=_pad_rows(np.asarray(ss.active, dtype=bool), S, False),
        q0=_pad_axis_rows(np.asarray(ss.q0, dtype=float), S, (0.0, 0.0, 1.0)),
        p10=_pad_axis_rows(np.asarray(ss.p10, dtype=float), S,
                           (1.0, 0.0, 0.0)),
        p20=_pad_axis_rows(np.asarray(ss.p20, dtype=float), S,
                           (0.0, 1.0, 0.0)),
        Cd_q=_pad_rows(np.asarray(ss.Cd_q, dtype=float), S),
        Cd_p1=_pad_rows(np.asarray(ss.Cd_p1, dtype=float), S),
        Cd_p2=_pad_rows(np.asarray(ss.Cd_p2, dtype=float), S),
        Cd_End=_pad_rows(np.asarray(ss.Cd_End, dtype=float), S),
        strip_mask=(np.arange(S) < ss.S),
        Imat=_pad_rows(np.asarray(fh.hc0["Imat"], dtype=np.complex128), S),
        a_i=_pad_rows(np.asarray(fh.hc0["a_i"], dtype=float), S),
        A_hydro=np.asarray(fh.hc0["A_hydro"], dtype=float),
        node_r0=_pad_rows(np.asarray(fs.node_r0, dtype=float), N),
        root=np.int32(fs.root_id),
        K_h=np.asarray(stat["C_struc"] + stat["C_hydro"], dtype=float),
        F_und=np.asarray(stat["W_struc"] + stat["W_hydro"]
                         + stat["f0_additional"], dtype=float),
        M_struc=np.asarray(stat["M_struc"], dtype=float),
        depth=np.float64(fs.depth),
        rho_water=np.float64(fs.rho_water),
        g=np.float64(fs.g),
        k=np.asarray(model.k, dtype=float),
    )
    if L:
        if ms.n_lines > L:
            raise ValueError(
                f"mooring system of {ms.n_lines} lines exceeds bucket {L}")

        def padL(a):
            a = np.asarray(a, dtype=float)
            reps = np.repeat(a[:1], L - a.shape[0], axis=0)
            return np.concatenate([a, reps], axis=0)

        d.update(
            moor_anchor=padL(ms.r_anchor), moor_fair0=padL(ms.r_fair0),
            moor_L=padL(ms.L), moor_w=padL(ms.w), moor_EA=padL(ms.EA),
            line_mask=(np.arange(L) < ms.n_lines),
        )
    return d


@dataclass(frozen=True, eq=False)
class PackedDesign:
    """One design packed into its bucket: the signature tuple and the
    numpy leaves of the reference's ``pack_design``."""

    sig: tuple
    leaves: dict


def load_packed(path):
    """Read a packed design written by ``tests/make_torch_port_fixtures.py``
    (packed leaves plus ``sig_S``/``sig_N``/``sig_L``/``sig_w``/
    ``sig_nIter``/``sig_XiStart``/``sig_nIterExtra``)."""
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files if not k.startswith("sig_")}
        sig = ("rigid6", BUCKET_VERSION, int(z["sig_S"]), int(z["sig_N"]),
               int(z["sig_L"]), tuple(float(x) for x in z["sig_w"]),
               int(z["sig_nIter"]), float(z["sig_XiStart"]),
               int(z["sig_nIterExtra"]))
    return PackedDesign(sig=sig, leaves=leaves)


def packed_from_numpy(packed, device=None, dtype_policy=None):
    """Packed numpy leaves -> tensors on ``device``, keeping their kinds:
    integer leaves (``node``, ``root``) stay int32, masks stay bool,
    real leaves take the policy's real dtype and ``Imat`` its complex
    one (float64 / complex128 unless the policy, or ``RAFT_TPU_DTYPE``
    when ``dtype_policy`` is None, says float32)."""
    device = resolve_device(device)
    rdt, cdt = compute_dtypes(policy=dtype_policy)
    out = {}
    for k, v in packed.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int32))
        elif np.iscomplexobj(a):
            t = torch.from_numpy(a.astype(np.complex128)).to(cdt)
        else:
            t = torch.from_numpy(a.astype(np.float64)).to(rdt)
        out[k] = t.to(device)
    return out


def stack_packed(packed_list, rows=None):
    """Stack per-row packed numpy leaves along a new leading axis,
    padded to ``rows`` by repeating the last entry (masked repeat rows
    the caller drops again)."""
    if not packed_list:
        raise ValueError("stack_packed: empty packed-design batch")
    n = len(packed_list)
    rows = n if rows is None else int(rows)
    if rows < n:
        raise ValueError(
            f"stack_packed: {n} rows exceed the requested batch {rows}")
    take = list(range(n)) + [n - 1] * (rows - n)
    return {k: np.stack([packed_list[i][k] for i in take])
            for k in packed_list[0]}


def padding_waste_frac(packed_list):
    """Fraction of padded strip rows that carry no real strip over a
    batch of packed designs: ``1 - sum(valid) / sum(padded)``."""
    valid = sum(int(np.asarray(p["strip_mask"]).sum()) for p in packed_list)
    total = sum(int(np.asarray(p["strip_mask"]).size) for p in packed_list)
    return 1.0 - valid / total if total else 0.0


def axis_counts(model, sig=None):
    """``{axis: (real, padded)}`` per padded design axis of one model in
    its bucket (strips, nodes, mooring lines)."""
    sig = sig or bucket_signature(model)
    meta = signature_meta(sig)
    fs = model.fowtList[0]
    ms = model.ms
    return {
        "strips": (int(model.hydro[0].strips.S), int(meta["S"])),
        "nodes": (int(fs.n_nodes), int(meta["N"])),
        "lines": (0 if ms is None else int(ms.n_lines), int(meta["L"])),
    }


def waste_by_axis(axis_counts_list):
    """Row-weighted per-axis padding waste over a batch (one
    :func:`axis_counts` dict per dispatched row): ``{axis: {valid,
    padded, waste_frac}}`` with ``waste_frac = 1 - sum(valid) /
    sum(padded)``."""
    agg: dict = {}
    for axes in axis_counts_list:
        for name, (real, padded) in axes.items():
            v, t = agg.get(name, (0, 0))
            agg[name] = (v + int(real), t + int(padded))
    return {name: {"valid": v, "padded": t,
                   "waste_frac": round(1.0 - v / t, 6) if t else 0.0}
            for name, (v, t) in agg.items()}


def observe_axis_waste(axis_counts_list, rows_valid=None, rows_padded=None):
    """Feed the per-axis waste metrics of one dispatched batch: the
    ``pad_valid_<axis>`` / ``pad_total_<axis>`` counters and a
    ``pad_waste_<axis>`` histogram of each row's pad fraction; the
    optional ``rows_valid`` / ``rows_padded`` pair records the batch-row
    axis (masked repeat rows) the same way."""
    from raft_tpu_torch.obs import metrics

    for axes in axis_counts_list:
        for name, (real, padded) in axes.items():
            if not padded:
                continue
            metrics.counter(f"pad_valid_{name}").inc(int(real))
            metrics.counter(f"pad_total_{name}").inc(int(padded))
            metrics.histogram(f"pad_waste_{name}").observe(
                1.0 - real / padded)
    if rows_padded:
        metrics.counter("pad_valid_rows").inc(int(rows_valid))
        metrics.counter("pad_total_rows").inc(int(rows_padded))
        metrics.histogram("pad_waste_rows").observe(
            1.0 - rows_valid / rows_padded)


def _masked_moor_closures(d):
    """``mooring_fn(X) -> (F, C)`` of the padded mooring system: the
    per-line catenary force summed under ``line_mask`` (padded lines
    repeat line 0 and are masked out of force and stiffness alike), and
    the stiffness ``C = -dF/dX`` by forward-mode AD through the whole
    catenary Newton loop (:func:`line_forces_and_stiffness`)."""
    line_args = (d["moor_fair0"], d["moor_anchor"], d["moor_L"],
                 d["moor_w"], d["moor_EA"], d["line_mask"])
    return MooringClosure(lambda X: line_args)


def _compute_dtype(K_h):
    """The real compute dtype of a batch; float32 work on the card also
    turns TF32 off, so float32 matmuls keep float32 precision."""
    rdt, _ = compute_dtypes(K_h)
    if rdt == torch.float32 and K_h.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return rdt


# 6-DOF rigid-body solver tolerances and step caps (reference values for
# a single root-node body at x_ref = y_ref = 0)
_TOL6 = (0.05, 0.05, 0.05, 0.005, 0.005, 0.005)
_CAP6 = (30.0, 30.0, 5.0, 0.1, 0.1, 0.1)


class BucketEvaluator(nn.Module):
    """Batched evaluator of one bucket signature.

    ``forward(design, Hs, Tp, beta)`` takes the packed design tensors
    with a leading row axis R (:func:`packed_from_numpy` of
    :func:`stack_packed` leaves) and (R,) sea-state tensors, and returns
    the reference's output keys (:data:`OUT_KEYS`) per row.  The
    signature's constants (frequency grid, tolerances, step caps) are
    buffers; the module holds no design.

    ``device`` defaults to the current CUDA device and raises without
    one (pass ``device="cpu"`` for the CPU).
    """

    def __init__(self, sig, device=None):
        super().__init__()
        device = resolve_device(device)
        meta = signature_meta(sig)
        self.sig = sig
        self.N, self.L, self.nw = meta["N"], meta["L"], meta["nw"]
        self.n_iter, self.Xi_start = meta["nIter"], meta["XiStart"]
        self.n_iter_extra = meta["nIterExtra"]
        self.dw = float(meta["w"][1] - meta["w"][0])
        f64 = dict(dtype=torch.float64, device=device)
        self.register_buffer("w", torch.tensor(meta["w"], **f64))
        self.register_buffer("tol_vec", torch.tensor(_TOL6, **f64))
        self.register_buffer("caps", torch.tensor(_CAP6, **f64))
        self.register_buffer("refs", torch.zeros(6, **f64))

    def forward(self, design, Hs, Tp, beta, timer=None):
        """Evaluate R rows; ``timer``, when given, is called with "start"
        and then with each stage name (statics, excitation, fixed_point,
        response) as that stage's work has been issued."""
        d = design
        mark = timer if timer is not None else (lambda stage: None)
        mark("start")
        K_h = d["K_h"]
        rdt = _compute_dtype(K_h)
        # ---- mean-offset equilibrium (zero mean environmental load)
        if self.L:
            mooring_fn = _masked_moor_closures(d)
        else:
            def mooring_fn(X):
                return (torch.zeros_like(X),
                        torch.zeros(X.shape + (6,), dtype=X.dtype,
                                    device=X.device))
        X0, _, _, _, st_status, C_moor = solve_equilibrium_general(
            K_h, d["F_und"], torch.zeros_like(d["F_und"]), mooring_fn,
            self.tol_vec.to(rdt), self.caps.to(rdt), self.refs.to(rdt))
        mark("statics")
        return one_heading(self.respond(d, X0, st_status, C_moor,
                                        *_heading_axis(Hs, Tp, beta, K_h),
                                        mark))

    def respond(self, d, X0, st_status, C_moor, Hs, Tp, beta, mark,
                hydro=None, gamma=None, lin=None, input_clipped=None):
        """Every stage after the statics, at the mean offsets X0 (R, 6)
        with their statics status and mooring stiffness C_moor: rigid
        kinematics, strip frames, excitation per wave heading, the drag
        fixed point and the response.

        Hs, Tp, beta [rad] and ``gamma`` (None or 0: the IEC default)
        are (R, nH) for nH wave headings; the first heading drives the
        fixed point.  With one heading and ``RAFT_TPU_FUSED=on`` the
        response is the fixed point's final solve; otherwise every
        heading's inertial plus drag excitation is solved against the
        one impedance in one solve.  Returns X0, Xi (R, nH, 6, nw), S
        and zeta (R, nH, nw), RAO of the first heading, PSD summed over
        the headings, Z, the fixed point's diagnostics and status
        (:func:`one_heading` makes :data:`OUT_KEYS` of it).

        ``hydro(fs, ss, R_ptfm, r_nodes, Tn)``, when given, returns the
        hydro constants at the displaced pose (A_hydro, Imat, a_i and the
        strip frames, as :func:`morison.hydro_constants`); by default
        they are the packed zero-pose ones with the displaced frames.
        ``lin``, when given, holds M, B (R, 6, 6, nw) and C (R, 6, 6)
        added to the linear system (the full path's aero-servo terms
        and elastic stiffness) and optionally the potential-flow terms:
        ``A`` (R, 6, 6, nw), added mass added after the body's own mass
        and added mass, and ``X`` (R, nH, 6, nw) complex, the
        first-order excitation per unit wave amplitude, so that
        F = X zeta is added to every heading's excitation, the fixed
        point's included (the reference's ``F_BEM``), and ``qtf``, an
        external QTF on the model grid (:func:`raft_tpu_torch.api.
        _qtf_model_grid`): from it and each heading's spectrum,
        :func:`raft_tpu_torch.api._hydro_force_2nd_rows` gives the
        second-order forces added to every heading's excitation after
        the first-order ones (the reference's ``F_2nd``; marked
        "second_order") and the mean drift, returned as ``F_2nd_mean``
        (R, nH, 6); ``input_clipped`` (R,) bool sets INPUT_CLIPPED in
        the status."""
        K_h = d["K_h"]
        rdt = _compute_dtype(K_h)
        R = K_h.shape[0]
        dev = K_h.device
        # on a split frequency axis (raft_tpu_torch.parallel.freq) every
        # per-frequency term is this entry's slice; the spectrum is
        # taken whole first, as the second-order forces need it whole
        w_whole = self.w.to(rdt)
        w = freq.take(w_whole)
        nw = w.shape[0]
        nH = Hs.shape[1]
        fsb = site_of(d, self.N)
        ss = strips_of(d)

        # ---- rigid kinematics about each row's own root node
        r_nodes, R_ptfm, r_root = platform_kinematics(d["node_r0"],
                                                      d["root"], X0)
        Tn = node_T(r_nodes, r_root)

        # ---- strip frames; the validity mask extends submergence
        if hydro is None:
            hc = packed_hydro(d, ss, R_ptfm, r_nodes)
        else:
            hc = hydro(fsb, ss, R_ptfm, r_nodes, Tn)

        # ---- sea states + excitation, one per heading
        S_whole = wv.jonswap(w_whole, Hs, Tp, gamma=gamma)
        S_spec = freq.take(S_whole)                           # (R, nH, nw)
        zeta = wv.amplitudes(S_spec, self.dw).to(_policy_cdt(K_h))
        k = freq.take(d["k"])
        exc = [morison.hydro_excitation(fsb, ss, hc, zeta[:, ih],
                                        beta[:, ih], w, k, Tn, r_nodes)
               for ih in range(nH)]
        mark("excitation")
        qtf = None if lin is None else lin.get("qtf")
        F_2 = None
        if qtf is not None:
            F_2nd_mean, F_2 = _hydro_force_2nd_rows(qtf, beta, S_whole,
                                                    self.dw)
            F_2 = freq.take(F_2).to(zeta.dtype)
            mark("second_order")

        # ---- drag-linearised impedance solve, driven by the first heading
        M_lin = (d["M_struc"] + hc["A_hydro"])[..., None].expand(
            R, 6, 6, nw)
        B_lin = torch.zeros((R, 6, 6, nw), dtype=rdt, device=dev)
        C_lin = K_h + C_moor
        F_pot = None
        if lin is not None:
            M_lin = lin["M"] + M_lin
            if lin.get("A") is not None:
                M_lin = M_lin + lin["A"]
            B_lin = B_lin + lin["B"]
            C_lin = C_lin + lin["C"]
            if lin.get("X") is not None:
                F_pot = lin["X"] * zeta[:, :, None, :]
        F_lin = exc[0]["F_hydro_iner"]
        if F_pot is not None:
            F_lin = F_pot[:, 0] + F_lin
        if F_2 is not None:
            F_lin = F_lin + F_2[:, 0]
        Z, Xi_fused, Bmat, dyn_diag = solve_dynamics_fowt(
            fsb, ss, hc, exc[0]["u"], M_lin, B_lin, C_lin, F_lin, w, Tn,
            r_nodes, n_iter=self.n_iter, Xi_start=self.Xi_start,
            n_iter_extra=self.n_iter_extra, timer=mark)
        if nH == 1 and fused_response_enabled():
            Xi = Xi_fused[:, None]
        else:
            F_waves = torch.stack([
                (exc[ih]["F_hydro_iner"] if F_pot is None
                 else F_pot[:, ih] + exc[ih]["F_hydro_iner"])
                + morison.drag_excitation(fsb, ss, hc, Bmat, exc[ih]["u"],
                                          Tn, r_nodes)
                for ih in range(nH)], dim=1)
            if F_2 is not None:
                F_waves = F_waves + F_2
            Xi = system_response(Z[:, None], F_waves)

        out = dict(
            X0=X0, Xi=Xi, RAO=wv.get_rao(Xi[:, 0], zeta[:, 0, None, :]),
            PSD=torch.sum(0.5 * torch.abs(Xi) ** 2 / self.dw, dim=1),
            S=S_spec, zeta=zeta, Z=Z, drag_resid=dyn_diag["drag_resid"],
            drag_converged=dyn_diag["drag_converged"],
            n_iter_drag=dyn_diag["n_iter_drag"],
            status=_case_status(st_status, dyn_diag, X0, Xi,
                                input_clipped=input_clipped),
        )
        if qtf is not None:
            out["F_2nd_mean"] = F_2nd_mean
        mark("response")
        return out


def _heading_axis(Hs, Tp, beta, like):
    """(R,) sea states as (R, 1) tensors of ``like``'s device and real
    compute dtype: one wave heading per row."""
    rdt = _compute_dtype(like)
    return tuple(torch.as_tensor(x, device=like.device).to(rdt)[:, None]
                 for x in (Hs, Tp, beta))


def one_heading(out):
    """:meth:`BucketEvaluator.respond`'s output of a one-heading sea as
    :data:`OUT_KEYS`: Xi (R, 6, nw) and S (R, nw)."""
    out = dict(out, Xi=out["Xi"][:, 0], S=out["S"][:, 0])
    return {k: out[k] for k in OUT_KEYS}


def packed_hydro(d, ss, R_ptfm, r_nodes):
    """The hydro constants of packed rows ``d`` at a displaced pose: the
    packed zero-pose Imat, a_i and A_hydro with the strip frames at the
    pose, submergence masked by ``strip_mask``."""
    r, q, p1, p2 = morison.strip_frames(ss, R_ptfm, r_nodes)
    sub = (r[..., 2] < 0) & d["strip_mask"]
    return dict(Imat=d["Imat"], a_i=d["a_i"], A_hydro=d["A_hydro"],
                r=r, q=q, p1=p1, p2=p2, sub=sub, active=sub & d["active"])


def site_of(d, n_nodes):
    """The site scalars of packed rows ``d`` with ``n_nodes`` nodes."""
    return morison.SiteRows(rho_water=d["rho_water"], depth=d["depth"],
                            g=d["g"], n_nodes=n_nodes)


def strips_of(d):
    """The strips of packed rows ``d`` (their leaves of the strip axis)."""
    return morison.StripSet(
        node=d["node"], ls=d["ls"], dls=d["dls"], ds=d["ds"], drs=d["drs"],
        circ=d["circ"], active=d["active"], q0=d["q0"], p10=d["p10"],
        p20=d["p20"], Cd_q=d["Cd_q"], Cd_p1=d["Cd_p1"], Cd_p2=d["Cd_p2"],
        Cd_End=d["Cd_End"])


#: process cache of bucket evaluators per (signature, device): an
#: evaluator holds nothing but its signature's constants
_EVALUATORS: dict = {}


def get_bucket_evaluator(sig, device=None):
    """The process-cached :class:`BucketEvaluator` of ``sig`` on
    ``device`` (default: the current CUDA device; raises without one)."""
    device = resolve_device(device)
    key = (sig, str(device))
    ev = _EVALUATORS.get(key)
    if ev is None:
        # a sweep's entry threads may miss at once: one evaluator wins
        ev = _EVALUATORS.setdefault(key, BucketEvaluator(sig, device))
    return ev
