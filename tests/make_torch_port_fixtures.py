"""Write the design, packed-design and JAX-golden fixtures of the
PyTorch port.

For each of the three bundled demo designs this script writes:

* ``design_<name>.json``: ``yaml.safe_load`` of the design's YAML, dumped
  as JSON (the port and ``chip_smoke.py`` read designs without PyYAML);
* ``packed_<name>.npz``: the numpy leaves of
  :func:`raft_tpu.structure.bucketing.pack_design`, plus the
  bucket-signature metadata, the reference for the port's own builder;
* ``golden_<name>.npz``: the JAX bucket evaluator's outputs (float64,
  CPU, vmapped) over a fixed grid of 8 sea states;
* ``golden_design_<name>.npz``: the JAX design evaluator's outputs
  (``raft_tpu.api.make_design_evaluator``, float64, CPU, vmapped) over
  8 fixed rows of sea state and drag / added-mass / mooring-length
  scales;

the goldens under ``RAFT_TPU_FUSED=on`` and ``off``.

For the full-physics evaluator it also writes two rotor designs, built
here from formulas (no published blade or airfoil file is in the
repository):

* ``design_semi_wind.json``: the semi demo carrying a 3-bladed,
  15 MW-class rotor in air, ``aeroServoMod: 2``, sized after the
  published IEA-15-240-RWT (Gaertner et al. 2020, NREL/TP-5000-75698):
  Rtip 120 m, Rhub 4 m, hub at 150 m, nr 20, nSector 4; chord and twist
  at 10 stations (:data:`SEMI_BLADE`), chord scaled by
  :data:`SEMI_CHORD_SCALE` so that the thrust at rated is about 2.1 MN;
  the schedule Omega = clip(0.716 U, 5, 7.56) rpm (tip-speed ratio 9,
  rated 10.59 m/s at 7.56 rpm) and pitch = 23 ((U - 10.59)+ / 14.41)^0.75
  deg from 3 to 25 m/s; ROSCO-like gain schedules and
  ``I_drivetrain`` 3.2e8 kg m^2;
* ``design_mhk_tidal.json``: the MHK demo carrying a 2-bladed submerged
  rotor, ``aeroServoMod: 1``: Rtip 5 m, Rhub 0.6 m, hub at -15 m, 12 m
  upstream of the hull on a horizontal strut ``tower``; Omega =
  min(9.55 U, 19.1) rpm (tip-speed ratio 5, rated 2 m/s) and pitch =
  14 ((U - 2)+ / 1)^0.7 deg over a current of 0.5 to 3 m/s.

Both use four analytic airfoils (:func:`analytic_polar`) over -180 to
180 deg: a cylinder (cl 0, cd 0.5) and relative thicknesses 0.40, 0.30
and 0.21 with

    f  = 1 / (1 + exp(-(|a| - a_s) / 2 deg))          (stall blend)
    cl = (1 - f) (cl0 + cla sin a cos^2 a) + f 1.1 sin 2a
    cd = cd0 + (1 - f) 0.6 sin^2 a + f 1.3 sin^2 a

(cla, cl0, a_s, cd0) = (5.0, 0.20, 9 deg, 0.016), (5.6, 0.32, 11 deg,
0.011), (6.1, 0.42, 12.5 deg, 0.0075).  And it writes:

* ``golden_full_<name>.npz`` for semi_wind (1 wave heading), mhk_tidal
  and the three demos (2 headings, current on): the JAX full evaluator's
  outputs (float64, CPU, vmapped) over 8 fixed rows, FUSED on and off;
* ``golden_aero_<rotor>.npz``: the JAX ``rotor_loads_and_derivs`` over
  a grid of (U, Omega, pitch, tilt, yaw) and ``kaimal_rot_psd_traced``
  over a grid of (V, TI) for each turbulence model;
* ``rotor_<rotor>.npz``: the JAX builder's ``RotorAeroModel`` fields
  and the submerged rotor's ``blade_hydro`` arrays;
* ``packed_<rotor>.npz``: the JAX builder's packed leaves of each rotor
  design (blade added mass and buoyancy included).

For the geometry design axis and the gradients it writes:

* ``golden_geometry_<name>.npz`` for the five full-evaluator sets: the
  JAX geometry evaluator (``make_full_evaluator(geometry=True)``) over
  the set's rows, each with geometry scales drawn over
  :data:`GEOM_BOX` (per member: diameter, thickness, ballast fill and
  fill density; per row: drag, added mass, mooring length and
  stiffness), FUSED on and off;
* ``golden_grad_<name>.npz`` for spar, semi and semi_wind: the metric
  sum |Xi[0]|^2 + sum X0^2 on the first 4 of those rows and its
  ``jax.grad`` with respect to every geometry key;
* ``golden_grad_design_<name>.npz`` for the three demos: the same
  metric's ``jax.grad`` with respect to the six design-evaluator inputs
  on :data:`GRAD_DESIGN_ROWS` (the reference's spectrum floored, see
  :func:`_floored_jonswap`);

each gradient checked against ``jax.jacfwd`` within 1e-10 x its max.

For the reverse mode of the other evaluators (``--grad-rest``,
:func:`write_grad_rest_fixtures`) it writes, each gradient checked
against ``jax.jacfwd`` and all finite, on rows whose reference gradient
is finite (:data:`GRAD_AERO_ROWS` and its neighbours name those left
out), the spectrum floored:

* ``golden_grad_aero_<name>.npz`` for semi_wind and mhk_tidal: the
  response metric by every row input and sum |f_aero|^2 by
  :data:`GRAD_AERO_METRIC_KEYS`, FUSED on and off;
* ``golden_grad_bem_<name>.npz`` for semi_wind_coarse and semi_wind:
  the geometry evaluator by d_scale (0.95, 1.0, 1.05) and every row
  input, FUSED on and off;
* ``golden_grad_farm_semi_wind.npz``: the two-unit farm by every row
  input, per-unit wind speeds included;
* ``golden_grad_flex_semi_wind.npz``: semi_wind_flex by every row
  input, and on the geometry axis by every struct_params leaf of a
  rebuilt tower too (that gradient checked along random directions).

For the flexible (N-DOF beam) evaluator it writes two designs whose
tower is a ``type: beam`` member of steel (E 200 GPa, G 79.3 GPa; the
Timoshenko beam needs both):

* ``design_spar_flex.json``: the spar demo with its tower a beam (nDOF
  108 over 22 nodes: 18 tower strips, the spar, the RNA node and two
  joint anchors; its rotor's aero is off);
* ``design_semi_wind_flex.json``: semi_wind with its tower a beam (nDOF
  168 over 38 nodes: 28 tower strips, the seven rigid semi members, the
  rotor node and two joint anchors);

and the JAX flexible evaluator's outputs (``make_flexible_evaluator``,
float64, CPU, vmapped): ``golden_flex_spar.npz`` (two headings over
:data:`FLEX_SPAR_SEED` rows of seas and current),
``golden_flex_semi_wind.npz`` (one heading over the semi_wind golden
rows) and ``golden_flex_geometry_semi_wind.npz`` (the geometry axis:
:data:`FLEX_GEOMETRY_SCALES` tower d/t scalings, each rebuilt on the
host, over the first rows of semi_wind's).

For potential flow (the panel solver and WAMIT files) it writes:

* ``design_semi_wind_bem.json``: semi_wind with ``potModMaster: 2``
  (all seven platform members meshed: 684 panels at the default
  ``nAz_BEM`` 18; 25 BEM frequencies, 8 headings, 200 m deep, so both
  the finite-depth series and the tabulated deep kernel run);
  ``design_semi_wind_bem_coarse.json``, its coarse copy for the CPU
  tests (``nAz_BEM`` 8, ``dz_BEM`` 3.0: 304 panels);
* ``design_semi_wind_wamit.json``: semi_wind reading its first-order
  coefficients from ``semi_wind_wamit.1`` / ``.3`` (``hydroPath``,
  ``potFirstOrder: 1``), the files the JAX ``Model.run_bem`` wrote for
  ``design_semi_wind_bem.json``;
* ``bem_cache_jax/``: the files the JAX ``run_bem`` wrote for the coarse
  copy, under the JAX cache names (a reference-populated cache that the
  port must not serve);
* ``golden_bem_<set>.npz`` for ``semi_wind`` (full mesh),
  ``semi_wind_coarse`` and ``semi_wind_wamit``: the raw coefficients of
  the JAX ``native.solve_bem`` on the JAX mesh and the model-grid ones
  of ``run_bem`` (panel sets), and the JAX full evaluator over
  :data:`BEM_ROWS` (``h1_*``), over :data:`BEM_ROWS2` with two headings
  (``h2_*``, coarse) and, with ``geometry=True``, over the rows with
  :data:`BEM_D_SCALE` (``geo_*``, panel sets), FUSED on and off;
* ``design_semi_wind_slender.json``: semi_wind with a slender-body QTF
  (``potSecOrder: 1``, a 40-bin grid of 0.005-0.2 Hz, MacCamy-Fuchs
  outer columns), and ``golden_qtf_slender.npz``: the JAX
  ``fowt_qtf_slender`` at :data:`SLENDER_BETA_DEG`, fixed and driven by
  the RAO of a golden full-evaluator row, with that RAO's per-member
  ``member_qtf``, ``kim_yue_correction`` and ``pinkster_iv``;
* ``semi_wind_qtf.12d``: that design's fixed-body QTF at
  :data:`QTF_HEADS_DEG`, written by the JAX ``write_qtf_12d``;
  ``design_semi_wind_qtf.json`` (semi_wind reading it, ``potSecOrder:
  2``) and ``design_semi_wind_bem_coarse_qtf.json`` (the coarse
  potential-flow copy reading it), and their goldens
  ``golden_semi_wind_qtf.npz`` (one and two headings, geometry rows)
  and ``golden_semi_wind_bem_coarse_qtf.npz``, FUSED on and off.

For the orchestrated path (``Model.analyze_cases``) and the drivers it
writes:

* ``design_semi_wind_cases.json`` (semi_wind with the 4-case table
  :data:`SEMI_WIND_CASES`), ``design_mhk_tidal_cav.json`` (mhk_tidal
  with the cpmin column of :func:`cpmin_polar`),
  ``design_farm_semi_wind_cases.json`` (the farm with
  :data:`FARM_CASES`) and ``design_semi_wind_moor1.json`` / ``_moor2``
  (semi_wind's mooring at ``moorMod`` 1 and 2);
* ``golden_orch_<set>.npz`` for every set of :data:`ORCH_DESIGN_FILES`:
  the JAX ``analyze_cases`` and ``calc_outputs`` (:func:`build_orch_golden`);
* ``golden_drivers.npz``: the JAX ``adjust_ballast`` of the spar and
  the farm's ``WakeCoupling`` curves, equilibrium and AEP
  (:func:`build_drivers_golden`).

For the design-optimisation surface it writes:

* ``weis_semi_wind.json`` and ``weis_branches.json``: WEIS's option
  dicts and flat inputs (``RAFT_OMDAO_Core``'s arguments, arrays as
  lists) made from semi_wind by :func:`weis_flat`, the inverse of
  ``build_design`` (:func:`weis_semi_wind_set`, :func:`weis_branches_set`);
* ``golden_omdao_<set>.npz``: the JAX ``DesignEvaluation`` of every
  set of :data:`OMDAO_SETS` (:func:`build_omdao_golden`: its route, the
  outputs and ``diag`` of a first and a repeat call and the spar's
  override, the design fingerprint and each case's traced row and
  cache key), the JAX ``RAFT_OMDAO_Core`` of the two WEIS sets
  (:func:`build_weis_golden`), the wave and drag helpers
  (``golden_omdao_helpers.npz``) and the plotting geometry and line
  counts (``golden_omdao_plotting.npz``).

With ``--sweeps`` (a process of its own: JAX gets 2 CPU devices) it
writes the checkpointed-sweep goldens, each sweep on a 2-device mesh
in shards of :data:`SWEEP_SHARD` rows:

* ``golden_sweep_full_<set>.npz``: ``run_sweep_checkpointed_full`` of
  the spar's and semi_wind's full evaluator over their golden rows;
* ``golden_sweep_cases_spar.npz``: ``run_sweep_checkpointed`` of the
  spar's case evaluator over the golden sea states;
* ``golden_sweep_hetero.npz`` and ``golden_sweep_events.json``:
  ``sweep_heterogeneous`` over the three demos interleaved, its
  ``bucket_sweep`` event, each demo's ``axis_counts`` and signature
  fingerprint, and ``tuned_rungs`` of their real axis sizes;
* ``golden_sweep_quarantine_spar.npz`` / ``.json``: the escalated sweep
  of :func:`quarantine_design` (``RAFT_TPU_ESCALATE=retol``) and its
  ``quarantine.json`` entries (about 5 min in all).

With ``--mesh`` (a process of its own: JAX gets 4 CPU devices) it
writes ``golden_mesh_full_{spar,semi_wind}.npz``: the JAX
``sweep_cases_full(..., shard_freq=True)`` of each set's full evaluator
over its 8 golden rows on a (dp, sp) = (2, 2) mesh, the frequency axis
of PSD and Xi split in two (about 2 min).

With ``--serve`` it writes ``golden_serve_<name>.npz`` for the three
demos: the JAX serving engine's own ``raft_tpu.serve.engine.dispatch``
(float64, one CPU device, the design registered from its dict) over
:data:`SERVE_ROWS` requests padded to each rung of
:data:`SERVE_RUNGS`, every bucket output key, the request rows' sea
states beside them (``r<rung>_Hs`` / ``_Tp`` / ``_beta`` and
``r<rung>_<key>``).  The first request of every rung is the same case
(:data:`SERVE_SHARED_CASE`), so a row's dependence on its rung can be
read off the file (about 5 min).

Run from the repository root::

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --geometry \
        [geometry] [grad] [grad_design]
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --grad-rest \
        [aero_semi_wind] [aero_mhk_tidal] [bem] [bem_full] [farm] [flex]
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --flex
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --bem
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --qtf
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py \
        --orchestrated [set ...]
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --drivers
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py \
        --omdao [set ...]
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --sweeps
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --serve
    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py --mesh

It writes ``tests/fixtures/torch_port/*`` (with ``--geometry`` only the
geometry and gradient goldens, or the named parts of them).
The checked-in files came from ``raft_tpu`` as of commit d384195 (its
sources are unchanged since c7d9048).  Not collected by pytest (the
file name does not start with ``test_``); the slow tests
``tests/test_torch_bucket.py::test_fixtures_regenerate``,
``tests/test_torch_full.py::test_full_fixtures_regenerate``,
``tests/test_torch_geometry.py::test_geometry_fixtures_regenerate``,
``tests/test_torch_grad.py::test_grad_fixtures_regenerate``,
``tests/test_torch_grad_aero.py``, ``test_torch_grad_farm.py``,
``test_torch_grad_flex.py`` and ``test_torch_bem.py``'s
``*_regenerate(s)`` tests,
``tests/test_torch_secondorder.py::test_qtf_fixtures_regenerate``,
``tests/test_torch_orchestrated.py::test_orch_golden_regenerates``,
``tests/test_torch_drivers.py::test_drivers_golden_regenerates`` and
``tests/test_torch_omdao.py::test_omdao_golden_regenerates`` re-run
the builders here and compare with the files.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(HERE, "fixtures", "torch_port")
DESIGNS = {"spar": "spar_demo.yaml", "semi": "semi_demo.yaml",
           "mhk": "mhk_demo.yaml"}

#: the golden sea-state grid (Hs [m], Tp [s], beta [rad]), shared by
#: every design: mild to severe, short to long period, all headings
GOLDEN_CASES = (
    (6.0, 12.0, 0.0),
    (2.5, 7.5, 0.35),
    (1.0, 4.0, 3.1),
    (12.0, 20.0, 1.2),
    (9.0, 14.0, 2.4),
    (4.0, 9.0, 0.8),
    (11.0, 6.0, 1.9),
    (3.0, 17.0, 0.1),
)

#: the golden design rows (Hs [m], Tp [s], beta [rad], Cd_scale,
#: Ca_scale, L_moor_scale): the sea states above with scales below and
#: above 1
DESIGN_KEYS = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
GOLDEN_DESIGN_ROWS = (
    (6.0, 12.0, 0.0, 1.0, 1.0, 1.0),
    (2.5, 7.5, 0.35, 0.5, 0.5, 0.98),
    (1.0, 4.0, 3.1, 2.0, 1.5, 1.02),
    (12.0, 20.0, 1.2, 0.75, 1.25, 0.99),
    (9.0, 14.0, 2.4, 1.5, 0.8, 1.01),
    (4.0, 9.0, 0.8, 1.2, 1.1, 0.985),
    (11.0, 6.0, 1.9, 0.6, 0.7, 1.015),
    (3.0, 17.0, 0.1, 1.8, 1.4, 1.0),
)

OUT_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "drag_resid", "drag_converged",
            "n_iter_drag", "status")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def pack(name):
    """(packed numpy leaves, signature meta) of one bundled design."""
    _jax()
    import raft_tpu
    from raft_tpu.structure import bucketing

    model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                        DESIGNS[name]))
    sig = bucketing.bucket_signature(model)
    return bucketing.pack_design(model, sig), sig


def golden(packed, sig, fused):
    """JAX bucket-evaluator outputs over :data:`GOLDEN_CASES`."""
    jax = _jax()
    import numpy as np

    from raft_tpu.structure import bucketing

    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        # a fresh evaluator per mode: the flag is read at trace time
        ev = bucketing.make_bucket_evaluator(sig)
        n = len(GOLDEN_CASES)
        Hs, Tp, beta = (np.asarray(c, dtype=float)
                        for c in zip(*GOLDEN_CASES))
        case = dict(design=bucketing.stack_packed([packed] * n),
                    Hs=Hs, Tp=Tp, beta=beta)
        out = jax.jit(jax.vmap(ev))(case)
        return {k: np.asarray(out[k]) for k in OUT_KEYS}
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def design_dict(name):
    """The design dict of one bundled design, as ``yaml.safe_load``
    reads it."""
    import yaml

    with open(os.path.join(ROOT, "raft_tpu", "designs", DESIGNS[name])) as f:
        return yaml.safe_load(f)


def design_json(name):
    """The text of ``design_<name>.json``."""
    import json

    return json.dumps(design_dict(name), indent=1) + "\n"


def golden_design(name, fused, rows=GOLDEN_DESIGN_ROWS):
    """JAX design-evaluator outputs over ``rows`` of :data:`DESIGN_KEYS`."""
    jax = _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_design_evaluator

    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                            DESIGNS[name]))
        ev = make_design_evaluator(model)
        params = {k: np.asarray(c, dtype=float)
                  for k, c in zip(DESIGN_KEYS, zip(*rows))}
        out = jax.jit(jax.vmap(ev))(params)
        return {k: np.asarray(out[k]) for k in OUT_KEYS}
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def build_design_golden(name):
    """The ``golden_design_<name>.npz`` dict, as written."""
    import numpy as np

    gd = {k: np.asarray(c, dtype=float)
          for k, c in zip(DESIGN_KEYS, zip(*GOLDEN_DESIGN_ROWS))}
    for fused in ("on", "off"):
        for k, v in golden_design(name, fused).items():
            gd[f"{fused}_{k}"] = v
    return gd


def packed_npz(packed, sig):
    """A packed design and its signature as the ``packed_*.npz`` dict."""
    import numpy as np

    from raft_tpu.structure import bucketing

    meta = bucketing.signature_meta(sig)
    pk = {k: np.asarray(v) for k, v in packed.items()}
    for k in ("S", "N", "L", "nIter", "nIterExtra"):
        pk["sig_" + k] = np.int64(meta[k])
    pk["sig_XiStart"] = np.float64(meta["XiStart"])
    pk["sig_w"] = np.asarray(meta["w"], dtype=np.float64)
    return pk


def build_fixtures(name):
    """``(packed_npz, golden_npz)`` dicts of one design, as written."""
    import numpy as np

    packed, sig = pack(name)
    pk = packed_npz(packed, sig)
    gd = {"Hs": np.asarray([c[0] for c in GOLDEN_CASES]),
          "Tp": np.asarray([c[1] for c in GOLDEN_CASES]),
          "beta": np.asarray([c[2] for c in GOLDEN_CASES])}
    for fused in ("on", "off"):
        for k, v in golden(packed, sig, fused).items():
            gd[f"{fused}_{k}"] = v
    return pk, gd


# ------------------------------------------------------- rotor fixtures

#: airfoil parameters (cla [1/rad], cl0, stall angle [deg], cd0) per
#: relative thickness
AIRFOIL_PARAMS = {0.40: (5.0, 0.20, 9.0, 0.016),
                  0.30: (5.6, 0.32, 11.0, 0.011),
                  0.21: (6.1, 0.42, 12.5, 0.0075)}

#: semi_wind blade: span fraction, chord [m], twist [deg] per station
SEMI_BLADE = (
    (0.00, 5.2, 15.0), (0.05, 5.3, 14.0), (0.15, 5.7, 11.0),
    (0.25, 5.8, 8.0), (0.40, 5.0, 5.0), (0.55, 4.2, 3.0),
    (0.70, 3.4, 1.5), (0.85, 2.6, 0.4), (0.95, 1.8, -0.2),
    (1.00, 1.0, -0.5),
)
SEMI_CHORD_SCALE = 1.15

#: mhk_tidal blade: span fraction, chord [m], twist [deg] per station
MHK_BLADE = (
    (0.00, 0.55, 22.0), (0.10, 0.75, 18.0), (0.25, 0.80, 12.0),
    (0.45, 0.68, 7.0), (0.65, 0.56, 4.0), (0.85, 0.44, 2.0),
    (1.00, 0.30, 1.0),
)


def analytic_polar(t_rel):
    """[[aoa deg, cl, cd, cm]] at 2.5 deg steps over -180..180 deg of an
    airfoil of relative thickness ``t_rel`` (1.0: a cylinder); the
    formulas are in the module docstring."""
    import numpy as np

    aoa = np.linspace(-180.0, 180.0, 145)
    a = np.deg2rad(aoa)
    if t_rel >= 1.0:
        return [[float(x), 0.0, 0.5, 0.0] for x in aoa]
    cla, cl0, a_s, cd0 = AIRFOIL_PARAMS[t_rel]
    f = 1.0 / (1.0 + np.exp(-(np.abs(a) - np.deg2rad(a_s)) / np.deg2rad(2.0)))
    cl = (1 - f) * (cl0 + cla * np.sin(a) * np.cos(a) ** 2) \
        + f * 1.1 * np.sin(2 * a)
    cd = cd0 + (1 - f) * 0.6 * np.sin(a) ** 2 + f * 1.3 * np.sin(a) ** 2
    return [[float(x), float(y), float(z), 0.0]
            for x, y, z in zip(aoa, cl, cd)]


def _airfoils():
    out = [dict(name="cylinder", relative_thickness=1.0,
                data=analytic_polar(1.0))]
    for t in (0.40, 0.30, 0.21):
        out.append(dict(name=f"af{int(round(t * 100))}",
                        relative_thickness=t, data=analytic_polar(t)))
    return out


def _blade(stations, Rhub, Rtip, chord_scale, airfoils):
    return dict(
        Rtip=Rtip, nr=20, nSector=4, precurveTip=0.0, presweepTip=0.0,
        geometry=[[Rhub + x * (Rtip - Rhub), c * chord_scale, tw, 0.0, 0.0]
                  for x, c, tw in stations],
        airfoils=airfoils)


def semi_wind_design():
    """The semi demo with a 15 MW-class rotor in air (module docstring)."""
    import numpy as np

    d = design_dict("semi")
    d["name"] = "raft_tpu_torch fixture: semi demo with a 15 MW-class rotor"
    t = d["turbine"]
    U = np.array([3.0, 4, 5, 6, 7, 8, 9, 10, 10.59, 11, 12, 14, 16, 18, 20,
                  22, 25])
    t.update(
        aeroServoMod=2, nBlades=3, Rhub=4.0, I_drivetrain=3.2e8,
        gear_ratio=1.0,
        blade=_blade(SEMI_BLADE, 4.0, 120.0, SEMI_CHORD_SCALE,
                     [[0.0, "cylinder"], [0.12, "af40"], [0.35, "af30"],
                      [0.65, "af21"], [1.0, "af21"]]),
        airfoils=_airfoils(),
        wt_ops=dict(
            v=U.tolist(),
            omega_op=np.minimum(np.maximum(0.716 * U, 5.0), 7.56).tolist(),
            pitch_op=(23.0 * (np.clip(U - 10.59, 0.0, None) / 14.41) ** 0.75
                      ).tolist()),
        pitch_control=dict(
            GS_Angles=np.deg2rad([2.0, 5.0, 10.0, 15.0, 20.0, 25.0]).tolist(),
            GS_Kp=[-1.0, -0.8, -0.6, -0.48, -0.40, -0.34],
            GS_Ki=[-0.16, -0.13, -0.10, -0.08, -0.067, -0.057], Fl_Kp=-9.0),
        torque_control=dict(VS_KP=-3.8e7, VS_KI=-4.6e6),
    )
    return d


def mhk_tidal_design():
    """The MHK demo with a submerged 2-bladed rotor (module docstring)."""
    import numpy as np

    d = design_dict("mhk")
    d["name"] = ("raft_tpu_torch fixture: MHK demo with a submerged "
                 "2-bladed rotor")
    U = np.array([0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75, 3.0])
    d["turbine"] = dict(
        mRNA=6000.0, IxRNA=2.0e4, IrRNA=1.5e4, xCG_RNA=0.0,
        nBlades=2, Rhub=0.6, hHub=-15.0, overhang=-1.0, shaft_tilt=0.0,
        precone=0.0, rRNA=[-12.0, 0.0, -15.0], aeroServoMod=1,
        I_drivetrain=4.0e3, gear_ratio=1.0,
        tower=dict(name="strut", type="rigid", rA=[-2.5, 0.0, -15.0],
                   rB=[-11.0, 0.0, -15.0], shape="circ", stations=[0, 1],
                   d=[1.0, 0.8], t=0.03, Cd=0.8, Ca=1.0, CdEnd=0.6,
                   CaEnd=0.6, rho_shell=7850),
        blade=_blade(MHK_BLADE, 0.6, 5.0, 1.0,
                     [[0.0, "cylinder"], [0.15, "af40"], [0.4, "af30"],
                      [0.7, "af21"], [1.0, "af21"]]),
        airfoils=_airfoils(),
        wt_ops=dict(
            v=U.tolist(), omega_op=np.minimum(9.55 * U, 19.1).tolist(),
            pitch_op=(14.0 * np.clip(U - 2.0, 0.0, None) ** 0.7).tolist()),
    )
    return d


#: rotor designs: name -> (design builder, wave headings of its goldens)
ROTOR_DESIGNS = {"semi_wind": semi_wind_design, "mhk_tidal": mhk_tidal_design}

#: every full-evaluator golden set: name -> wave headings
FULL_SETS = {"semi_wind": 1, "mhk_tidal": 2, "spar": 2, "semi": 2, "mhk": 2}

FULL_ENV_KEYS = ("wind_speed", "wind_heading_deg", "TI", "yaw_misalign_deg",
                 "current_speed", "current_heading_deg")
FULL_SEA_KEYS = ("Hs", "Tp", "gamma", "beta_deg")

#: semi_wind golden rows: wind 0 (rotor off), 0.05 (INPUT_CLIPPED),
#: below rated, rated, above rated, 24 m/s; current on
SEMI_WIND_ROWS = dict(
    wind_speed=[0.0, 0.05, 7.0, 10.59, 14.0, 24.0, 4.0, 18.0],
    wind_heading_deg=[0.0, 10.0, -20.0, 0.0, 15.0, 30.0, -5.0, 25.0],
    TI=[0.10, 0.12, 0.14, 0.10, 0.08, 0.16, 0.20, 0.05],
    yaw_misalign_deg=[0.0, 3.0, -5.0, 0.0, 8.0, -2.0, 6.0, -8.0],
    current_speed=[0.5, 0.0, 0.3, 1.0, 0.2, 0.8, 0.6, 0.9],
    current_heading_deg=[0.0, 90.0, 200.0, 10.0, 300.0, 45.0, 120.0, 270.0],
    Hs=[[6.0], [2.0], [4.0], [8.0], [10.0], [12.0], [1.5], [9.0]],
    Tp=[[12.0], [7.0], [9.0], [13.0], [15.0], [18.0], [5.0], [11.0]],
    gamma=[[0.0], [3.3], [0.0], [1.0], [2.0], [0.0], [5.0], [0.0]],
    beta_deg=[[0.0], [30.0], [90.0], [150.0], [10.0], [180.0], [60.0],
              [120.0]],
)

#: mhk_tidal golden rows: current 0 (rotor off), 0.05 (INPUT_CLIPPED),
#: 0.5 to 3 m/s, two headings each
MHK_TIDAL_ROWS = dict(
    wind_speed=[0.0, 5.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    wind_heading_deg=[0.0] * 8,
    TI=[0.10, 0.05, 0.08, 0.12, 0.15, 0.10, 0.06, 0.13],
    yaw_misalign_deg=[0.0, 0.0, 2.0, 0.0, -3.0, 0.0, 0.0, 4.0],
    current_speed=[0.0, 0.05, 0.5, 1.5, 2.0, 2.6, 3.0, 1.1],
    current_heading_deg=[0.0, -20.0, 0.0, 10.0, 0.0, 30.0, -30.0, 15.0],
    Hs=[[1.0, 0.5], [2.0, 1.0], [1.0, 0.5], [3.0, 2.0], [4.0, 1.0],
        [2.0, 3.0], [0.5, 4.0], [2.5, 2.5]],
    Tp=[[6.0, 4.0], [8.0, 5.0], [6.0, 4.0], [10.0, 7.0], [12.0, 9.0],
        [7.0, 11.0], [4.0, 12.0], [9.0, 6.0]],
    gamma=[[0.0, 1.0], [3.3, 0.0], [0.0, 1.0], [0.0, 0.0], [5.0, 2.0],
           [1.0, 1.0], [0.0, 4.0], [2.0, 0.0]],
    beta_deg=[[0.0, 90.0], [180.0, 30.0], [0.0, 90.0], [270.0, 0.0],
              [45.0, 300.0], [120.0, 200.0], [360.0, 10.0], [15.0, 345.0]],
)

#: demo golden rows: no active rotor; two headings, current on (0.05 m/s
#: in one row: no rotor, so no INPUT_CLIPPED)
DEMO_ROWS = dict(
    wind_speed=[0.0, 8.0, 12.0, 0.0, 20.0, 0.05, 5.0, 0.0],
    wind_heading_deg=[0.0] * 8,
    TI=[0.1] * 8,
    yaw_misalign_deg=[0.0] * 8,
    current_speed=[0.5, 1.0, 0.0, 1.5, 0.3, 0.05, 0.8, 1.2],
    current_heading_deg=[0.0, 45.0, 0.0, 180.0, 270.0, 30.0, 90.0, 330.0],
    Hs=[[6.0, 2.0], [2.5, 1.0], [1.0, 1.0], [12.0, 3.0], [9.0, 4.0],
        [4.0, 2.0], [11.0, 1.5], [3.0, 3.0]],
    Tp=[[12.0, 6.0], [7.5, 5.0], [4.0, 9.0], [20.0, 8.0], [14.0, 10.0],
        [9.0, 5.0], [6.0, 12.0], [17.0, 7.0]],
    gamma=[[0.0, 1.0], [3.3, 0.0], [0.0, 0.0], [1.0, 2.0], [0.0, 5.0],
           [2.0, 0.0], [0.0, 1.0], [4.0, 0.0]],
    beta_deg=[[0.0, 90.0], [20.0, 200.0], [178.0, 0.0], [69.0, 300.0],
              [138.0, 45.0], [46.0, 10.0], [109.0, 250.0], [6.0, 180.0]],
)

FULL_ROWS = {"semi_wind": SEMI_WIND_ROWS, "mhk_tidal": MHK_TIDAL_ROWS,
             "spar": DEMO_ROWS, "semi": DEMO_ROWS, "mhk": DEMO_ROWS}

FULL_OUT_KEYS = ("X0", "Xi", "RAO", "PSD", "S", "zeta", "f_aero", "A00",
                 "B00", "f_aero0", "Omega_rpm", "pitch_deg", "F_2nd_mean",
                 "Z", "drag_resid", "drag_converged", "n_iter_drag",
                 "status")


def full_design(name):
    """The design dict of a full-evaluator golden set."""
    if name in ROTOR_DESIGNS:
        return ROTOR_DESIGNS[name]()
    return design_dict(name)


def full_rows(name):
    """The golden rows of a set as float64 numpy arrays."""
    import numpy as np

    return {k: np.asarray(v, dtype=float) for k, v in FULL_ROWS[name].items()}


def golden_full(name, fused):
    """JAX full-evaluator outputs over the set's golden rows."""
    jax = _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_full_evaluator

    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        model = raft_tpu.Model(full_design(name))
        ev = make_full_evaluator(model, nWaves=FULL_SETS[name])
        out = jax.jit(jax.vmap(ev))(full_rows(name))
        return {k: np.asarray(out[k]) for k in FULL_OUT_KEYS}
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def build_full_golden(name):
    """The ``golden_full_<name>.npz`` dict, as written."""
    gd = dict(full_rows(name))
    for fused in ("on", "off"):
        for k, v in golden_full(name, fused).items():
            gd[f"{fused}_{k}"] = v
    return gd


#: aero grids: per rotor, (U, Omega [rpm], pitch [deg]) operating points
#: around the schedule, with tilt and yaw [rad]
AERO_GRID = {
    "semi_wind": dict(U=[0.1, 3.0, 5.5, 8.0, 10.59, 12.0, 16.0, 24.0],
                      dOm=[0.0, 0.3, -0.2, 0.0, 0.5, -0.4, 0.0, 0.2],
                      dpitch=[0.0, 1.0, 0.0, -1.0, 2.0, 0.0, -3.0, 1.5],
                      tilt=[0.1047, 0.08, 0.12, 0.0, 0.15, -0.05, 0.1, 0.2],
                      yaw=[0.0, 0.2, -0.3, 0.1, 0.0, -0.1, 0.4, -0.2]),
    "mhk_tidal": dict(U=[0.1, 0.5, 1.0, 1.5, 2.0, 2.3, 2.7, 3.0],
                      dOm=[0.0, 1.0, -0.5, 0.0, 2.0, 0.0, -1.0, 0.5],
                      dpitch=[0.0, 0.0, 1.0, -1.0, 0.0, 2.0, -2.0, 1.0],
                      tilt=[0.0, 0.05, -0.05, 0.0, 0.1, 0.0, -0.1, 0.02],
                      yaw=[0.0, 0.1, -0.2, 0.3, 0.0, -0.1, 0.2, 0.5]),
}
#: Kaimal grid: (V [m/s], TI) rows, every turbulence model
KAIMAL_V = [0.1, 3.0, 8.0, 11.0, 15.0, 25.0]
KAIMAL_TI = [0.05, 0.10, 0.14, 0.16, 0.20, 0.12]
KAIMAL_MODELS = ("NTM", "ETM", "EWM")

ROTOR_FIELDS = ("B", "Rhub", "Rtip", "precone", "shaft_tilt", "rho", "mu",
                "shearExp", "hubHt", "nSector", "r", "chord", "theta_deg",
                "precurve", "presweep", "precurveTip", "presweepTip",
                "aoa_deg", "cl", "cd", "U_sched", "Omega_sched",
                "pitch_sched", "kp_0", "ki_0", "k_float", "kp_tau",
                "ki_tau", "Ng", "I_drivetrain")


def build_rotor_packed(name):
    """The ``packed_<name>.npz`` dict of a rotor design: the JAX
    builder's packed leaves, blade added mass and buoyancy included."""
    _jax()
    import raft_tpu
    from raft_tpu.structure import bucketing

    model = raft_tpu.Model(full_design(name))
    sig = bucketing.bucket_signature(model)
    return packed_npz(bucketing.pack_design(model, sig), sig)


def build_rotor_fixture(name):
    """The ``rotor_<name>.npz`` dict: the JAX builder's RotorAeroModel
    fields (absent optional ones left out) and, for a submerged rotor,
    its blade hydro arrays as ``hydro_<key>``."""
    _jax()
    import numpy as np

    import raft_tpu

    model = raft_tpu.Model(full_design(name))
    rot = model.rotor_aero[0]
    out = {k: np.asarray(getattr(rot, k)) for k in ROTOR_FIELDS
           if getattr(rot, k) is not None}
    hyd = model.fowtList[0].rotors[0].hydro
    if hyd is not None:
        out.update({f"hydro_{k}": np.asarray(v) for k, v in hyd.items()})
    return out


def build_aero_golden(name):
    """The ``golden_aero_<name>.npz`` dict: rotor_loads_and_derivs over
    the rotor's grid, and kaimal_rot_psd_traced over the Kaimal grid
    with the rotor's hub height and radius for each turbulence model."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    import raft_tpu
    from raft_tpu.physics import aero

    model = raft_tpu.Model(full_design(name))
    rot = model.rotor_aero[0]
    g = {k: np.asarray(v, dtype=float) for k, v in AERO_GRID[name].items()}
    Om0, pit0 = (np.asarray(a) for a in jax.vmap(
        lambda u: aero.operating_point(rot, u))(g["U"]))
    Om = Om0 + g["dOm"]
    pitch = pit0 + g["dpitch"]
    f = jax.jit(jax.vmap(lambda u, o, p, t, y: aero.rotor_loads_and_derivs(
        rot, u, o, p, t, y)))
    loads, dT, dQ = f(g["U"], Om, pitch, g["tilt"], g["yaw"])
    out = dict(U=g["U"], Omega_rpm=Om, pitch_deg=pitch, tilt=g["tilt"],
               yaw=g["yaw"], Omega_sched=Om0, pitch_sched=pit0,
               loads=np.asarray(loads), dT=np.asarray(dT),
               dQ=np.asarray(dQ),
               kaimal_V=np.asarray(KAIMAL_V), kaimal_TI=np.asarray(KAIMAL_TI),
               w=np.asarray(model.w))
    hub = model.fowtList[0].rotors[0].Zhub
    for tm in KAIMAL_MODELS:
        S = jax.vmap(lambda v, i: aero.kaimal_rot_psd_traced(
            jnp.asarray(model.w), v, i, hub, rot.Rtip, TurbMod=tm,
            V_ref_cls=50.0))(out["kaimal_V"], out["kaimal_TI"])
        out[f"kaimal_{tm}"] = np.asarray(S)
    return out


def write_full_fixtures():
    """Write the rotor designs, rotor arrays and every full/aero golden."""
    import json

    import numpy as np

    for name, fn in ROTOR_DESIGNS.items():
        with open(os.path.join(OUT_DIR, f"design_{name}.json"), "w") as f:
            f.write(json.dumps(fn(), indent=1) + "\n")
        np.savez_compressed(os.path.join(OUT_DIR, f"rotor_{name}.npz"),
                            **build_rotor_fixture(name))
        np.savez_compressed(os.path.join(OUT_DIR, f"packed_{name}.npz"),
                            **build_rotor_packed(name))
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_aero_{name}.npz"),
                            **build_aero_golden(name))
    for name in FULL_SETS:
        gd = build_full_golden(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_full_{name}.npz"),
                            **gd)
        print(f"full {name}: status_on={gd['on_status'].tolist()} "
              f"n_iter_on={gd['on_n_iter_drag'].tolist()} "
              f"status_off={gd['off_status'].tolist()}")


# ---------------------------------------------------- geometry fixtures

#: the geometry keys of the full evaluator's ``geom`` rows: per member
#: (one value per entry of ``fs.members``) and per row; each drawn
#: uniformly over its range
GEOM_MEMBER_KEYS = ("d_scale", "t_scale", "fill_scale", "rho_fill_scale")
GEOM_ROW_KEYS = ("Cd_scale", "Ca_scale", "L_moor_scale", "EA_moor_scale")
GEOM_BOX = dict(d_scale=(0.9, 1.1), t_scale=(0.9, 1.1),
                fill_scale=(0.8, 1.2), rho_fill_scale=(0.9, 1.1),
                Cd_scale=(0.5, 2.0), Ca_scale=(0.5, 1.5),
                L_moor_scale=(0.98, 1.02), EA_moor_scale=(0.8, 1.2))
GEOM_SEED = 20261021
#: gradient goldens: the first GRAD_ROWS rows of these geometry sets, and
#: GRAD_ROWS rows of GOLDEN_DESIGN_ROWS from the second on the three demos
#: (the first, beta = 0 at unit scales, leaves some of the mhk demo's
#: transverse strip velocities exactly 0, where the reference's
#: derivative of the drag linearisation's masked per-axis rms is
#: 0 * inf = NaN: jax.grad gives NaN for Ca_scale there)
GRAD_SETS = ("spar", "semi", "semi_wind")
GRAD_ROWS = 4
GRAD_DESIGN_ROWS = GOLDEN_DESIGN_ROWS[1:1 + GRAD_ROWS]


def geometry_rows(n_members, n=8, seed=GEOM_SEED):
    """``n`` geometry rows over :data:`GEOM_BOX` from a fixed numpy seed:
    (n, n_members) per-member scales, (n,) per-row scales."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {k: rng.uniform(*GEOM_BOX[k], (n, n_members)
                           if k in GEOM_MEMBER_KEYS else n)
            for k in GEOM_MEMBER_KEYS + GEOM_ROW_KEYS}


def response_metric(out):
    """The optimisation metric of one row, sum |Xi[0]|^2 + sum X0^2 (as
    ``tests/test_design_sweep.py``'s reverse-mode test)."""
    import jax.numpy as jnp

    return jnp.sum(jnp.abs(out["Xi"][0]) ** 2) + jnp.sum(out["X0"] ** 2)


def _with_fused(fused, fn):
    prev = os.environ.get("RAFT_TPU_FUSED")
    os.environ["RAFT_TPU_FUSED"] = fused
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_FUSED", None)
        else:
            os.environ["RAFT_TPU_FUSED"] = prev


def _geometry_evaluator(name):
    import raft_tpu
    from raft_tpu.api import make_full_evaluator

    model = raft_tpu.Model(full_design(name))
    ev = make_full_evaluator(model, nWaves=FULL_SETS[name], geometry=True)
    return model, ev


def build_geometry_golden(name):
    """The ``golden_geometry_<name>.npz`` dict: the set's full-evaluator
    rows with :func:`geometry_rows` through the JAX geometry evaluator,
    FUSED on and off."""
    jax = _jax()
    import numpy as np

    rows = full_rows(name)
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            model, ev = _geometry_evaluator(name)
            geom = geometry_rows(len(model.fowtList[0].members))
            gd.update({f"geom_{k}": v for k, v in geom.items()})
            out = jax.jit(jax.vmap(ev))(dict(rows, geom=geom))
            return {k: np.asarray(out[k]) for k in FULL_OUT_KEYS}
        for k, v in _with_fused(fused, run).items():
            gd[f"{fused}_{k}"] = v
    return gd


def _grad_pair(metric, args):
    """Per-row jax.grad and jax.jacfwd of ``metric`` over the rows of
    ``args``; asserts the two within 1e-10 x each key's max."""
    jax = _jax()
    import numpy as np

    val = np.asarray(jax.jit(jax.vmap(metric))(*args))
    grev = jax.jit(jax.vmap(jax.grad(metric)))(*args)
    gfwd = jax.jit(jax.vmap(jax.jacfwd(metric)))(*args)
    out = {}
    for k in grev:
        a, b = np.asarray(grev[k]), np.asarray(gfwd[k])
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        assert np.all(np.isfinite(a)), (k, a)
        assert err <= 1e-10 * scale, \
            f"grad vs jacfwd {k}: {err} > 1e-10 x {scale}"
        out[k] = a
    return val, out


def build_grad_golden(name):
    """The ``golden_grad_<name>.npz`` dict: the response metric and its
    reverse-mode gradient with respect to every geometry key on the
    first :data:`GRAD_ROWS` geometry rows, FUSED on and off."""
    _jax()
    rows = {k: v[:GRAD_ROWS] for k, v in full_rows(name).items()}
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            model, ev = _geometry_evaluator(name)
            geom = {k: v[:GRAD_ROWS] for k, v in geometry_rows(
                len(model.fowtList[0].members)).items()}
            gd.update({f"geom_{k}": v for k, v in geom.items()})
            return _grad_pair(
                lambda g, r: response_metric(ev(dict(r, geom=g))),
                (geom, rows))
        val, g = _with_fused(fused, run)
        gd[f"{fused}_metric"] = val
        gd.update({f"{fused}_g_{k}": v for k, v in g.items()})
    return gd


#: the floor of the spectrum under :func:`_floored_jonswap`
SPECTRUM_FLOOR = 1e-300


def _floored_jonswap():
    """A context in which the JAX package's ``jonswap`` returns its
    spectrum floored at :data:`SPECTRUM_FLOOR`.

    Where the JONSWAP tail underflows to 0 (f below about 0.2 / Tp), the
    reference's ``sqrt(2 S dw)`` has the derivative 0 * inf = NaN, so
    its gradient with respect to Hs and Tp is NaN on every row.  With
    the floor the derivative there is 0, its limit; the amplitudes move
    by about 1e-151, below every output's rounding (a floor whose
    ``2 S dw`` is subnormal would be flushed to 0 by XLA on the CPU)."""
    import contextlib

    import jax.numpy as jnp

    from raft_tpu.ops import waves

    @contextlib.contextmanager
    def ctx():
        plain = waves.jonswap
        waves.jonswap = lambda *a, **k: jnp.maximum(plain(*a, **k),
                                                    SPECTRUM_FLOOR)
        try:
            yield
        finally:
            waves.jonswap = plain

    return ctx()


def build_grad_design_golden(name):
    """The ``golden_grad_design_<name>.npz`` dict: the response metric
    and its gradient with respect to the six design-evaluator inputs on
    :data:`GRAD_DESIGN_ROWS`, FUSED on and off, with the spectrum floored
    (:func:`_floored_jonswap`)."""
    _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_design_evaluator

    params = {k: np.asarray(c, dtype=float) for k, c in
              zip(DESIGN_KEYS, zip(*GRAD_DESIGN_ROWS))}
    gd = dict(params)
    for fused in ("on", "off"):
        def run():
            model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                                DESIGNS[name]))
            ev = make_design_evaluator(model)
            with _floored_jonswap():
                return _grad_pair(lambda p: response_metric(ev(p)),
                                  (params,))
        val, g = _with_fused(fused, run)
        gd[f"{fused}_metric"] = val
        gd.update({f"{fused}_g_{k}": v for k, v in g.items()})
    return gd


def write_geometry_fixtures(parts=("geometry", "grad", "grad_design")):
    """Write every geometry and gradient golden (of ``parts``)."""
    import numpy as np

    for name in FULL_SETS if "geometry" in parts else ():
        gd = build_geometry_golden(name)
        np.savez_compressed(
            os.path.join(OUT_DIR, f"golden_geometry_{name}.npz"), **gd)
        print(f"geometry {name}: status_on={gd['on_status'].tolist()} "
              f"n_iter_on={gd['on_n_iter_drag'].tolist()}", flush=True)
    for name in GRAD_SETS if "grad" in parts else ():
        gd = build_grad_golden(name)
        np.savez_compressed(
            os.path.join(OUT_DIR, f"golden_grad_{name}.npz"), **gd)
        print(f"grad {name}: metric_on={gd['on_metric'].tolist()}",
              flush=True)
    for name in DESIGNS if "grad_design" in parts else ():
        gd = build_grad_design_golden(name)
        np.savez_compressed(
            os.path.join(OUT_DIR, f"golden_grad_design_{name}.npz"), **gd)
        print(f"grad design {name}: metric_on={gd['on_metric'].tolist()}",
              flush=True)


# ------------------------------------------- gradients of every evaluator

#: the gradient goldens of the aero, potential-flow, farm and flexible
#: paths (``--grad-rest``): the golden rows of each set whose reference
#: gradient is finite.  Left out: semi_wind's and mhk_tidal's rows 0-1
#: (no wind, or a speed of 0.05 m/s clipped to 0.1); every row with
#: current 0, where the reference's current-load derivative is 0 x inf
#: = NaN (semi_wind row 1, the farm's rows 0 and 4); and mhk_tidal's
#: rows 2 and 4, whose current heading 0 leaves a strip's transverse
#: current velocity exactly 0, where the reference's derivative of its
#: norm is 0 x inf = NaN by current_speed and current_heading_deg (and
#: jax.jacfwd's NaN by every input)
GRAD_AERO_ROWS = {"semi_wind": [2, 3, 4, 5], "mhk_tidal": [3, 5, 6, 7]}
GRAD_FARM_ROWS = slice(2, 4)
GRAD_FLEX_ROWS = slice(2, 4)
#: the potential-flow gradient rows: semi_wind's rows 2-4, one uniform
#: d_scale each, unit scale included (its derivative is not 0)
GRAD_BEM_ROWS = slice(2, 5)
GRAD_BEM_D_SCALE = (0.95, 1.0, 1.05)
#: the host-rebuilt tower (d, t scales) of the flexible geometry rows
#: (the first of FLEX_GEOMETRY_SCALES)
GRAD_FLEX_GEOMETRY = (0.9, 1.1)
#: random directions of the struct_params check (its leaves hold ~10^5
#: numbers, too many for jax.jacfwd)
GRAD_FLEX_DIRECTIONS = 2
#: the inputs of the aero metric's gradient: the rotor speeds, TI and
#: yaw.  Its derivative in a heading is 0 up to rounding (the heading
#: rotates f_aero, whose squared norm it leaves alone): no golden
GRAD_AERO_METRIC_KEYS = ("wind_speed", "TI", "yaw_misalign_deg",
                         "current_speed")
GRAD_REST_PARTS = ("aero_semi_wind", "aero_mhk_tidal", "bem", "bem_full",
                   "farm", "flex")


def aero_metric(out):
    """The aero stage's own metric of one row, sum |f_aero|^2: the only
    one that holds the turbulence spectrum (TI enters no response)."""
    import jax.numpy as jnp

    return jnp.sum(jnp.abs(out["f_aero"]) ** 2)


def _rows_at(rows, sl):
    return {k: v[sl] for k, v in rows.items()}


def _forward_diag(ev, rows):
    """status and n_iter_drag of the JAX evaluator's forward."""
    jax = _jax()
    import numpy as np

    out = jax.jit(jax.vmap(ev))(rows)
    return {k: np.asarray(out[k]) for k in ("status", "n_iter_drag")}


def build_grad_aero_golden(name):
    """The ``golden_grad_aero_<name>.npz`` dict: on the set's rows of
    :data:`GRAD_AERO_ROWS`, FUSED on and off, the response
    metric and its gradient with respect to every row input, and
    :func:`aero_metric` and its gradient with respect to
    :data:`GRAD_AERO_METRIC_KEYS`, the spectrum floored
    (:func:`_floored_jonswap`)."""
    _jax()
    import raft_tpu
    from raft_tpu.api import make_full_evaluator

    rows = _rows_at(full_rows(name), GRAD_AERO_ROWS[name])
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            ev = make_full_evaluator(raft_tpu.Model(full_design(name)),
                                     nWaves=FULL_SETS[name])
            with _floored_jonswap():
                val, g = _grad_pair(lambda r: response_metric(ev(r)),
                                    (rows,))
                env = {k: rows[k] for k in GRAD_AERO_METRIC_KEYS}
                sea = {k: v for k, v in rows.items() if k not in env}
                aval, ag = _grad_pair(
                    lambda e, s: aero_metric(ev(dict(s, **e))), (env, sea))
                return val, g, aval, ag, _forward_diag(ev, rows)
        val, g, aval, ag, diag = _with_fused(fused, run)
        gd[f"{fused}_metric"] = val
        gd.update({f"{fused}_g_{k}": v for k, v in g.items()})
        gd[f"{fused}_aero_metric"] = aval
        gd.update({f"{fused}_aero_g_{k}": v for k, v in ag.items()})
        gd.update({f"{fused}_{k}": v for k, v in diag.items()})
    return gd


def build_grad_bem_golden(name="semi_wind_coarse"):
    """The ``golden_grad_bem_<name>.npz`` dict: a potential-flow
    design's geometry evaluator on rows :data:`GRAD_BEM_ROWS` of
    semi_wind at the uniform d_scale :data:`GRAD_BEM_D_SCALE`, FUSED on
    and off: the response metric and its gradient with respect to
    d_scale and every row input.  The coarse copy's unit-scale
    coefficients come from ``bem_cache_jax``, the full mesh's are solved
    here, as are the two off-unit scales of either (JAX's binding with
    the port's shipped Green table)."""
    import shutil
    import tempfile

    _jax()
    import numpy as np

    from raft_tpu.api import make_full_evaluator
    from raft_tpu.native import green_table as jgt

    sys.path.insert(0, ROOT)
    from raft_tpu_torch.native import green_table

    jgt._tables = dict(green_table.build_tables())
    cache = tempfile.mkdtemp(prefix="bem_cache_")
    jdir = os.path.join(OUT_DIR, "bem_cache_jax")
    for f in os.listdir(jdir):
        shutil.copy(os.path.join(jdir, f), cache)
    prev = os.environ.get("RAFT_TPU_BEM_DIR")
    os.environ["RAFT_TPU_BEM_DIR"] = cache
    try:
        rows = _rows_at(bem_rows(BEM_ROWS), GRAD_BEM_ROWS)
        x = dict(rows, d_scale=np.asarray(GRAD_BEM_D_SCALE, dtype=float))
        gd = dict(x)
        model = bem_model(name)
        for fused in ("on", "off"):
            def run():
                ev = make_full_evaluator(model, nWaves=1, geometry=True)
                ev.geometry_constants(dict(d_scale=1.0))

                def case(x):
                    c = {k: v for k, v in x.items() if k != "d_scale"}
                    c["geom"] = dict(d_scale=x["d_scale"])
                    return c

                with _floored_jonswap():
                    val, g = _grad_pair(
                        lambda x: response_metric(ev(case(x))), (x,))
                    diag = _forward_diag(lambda x: ev(case(x)), x)
                return val, g, diag
            val, g, diag = _with_fused(fused, run)
            gd[f"{fused}_metric"] = val
            gd.update({f"{fused}_g_{k}": v for k, v in g.items()})
            gd.update({f"{fused}_{k}": v for k, v in diag.items()})
        return gd
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_BEM_DIR", None)
        else:
            os.environ["RAFT_TPU_BEM_DIR"] = prev
        shutil.rmtree(cache, ignore_errors=True)


def build_grad_farm_golden():
    """The ``golden_grad_farm_semi_wind.npz`` dict: the two-unit farm on
    rows :data:`GRAD_FARM_ROWS`: the response metric and its gradient
    with respect to every row input (per-unit wind speeds included),
    the spectrum floored.  The farm evaluator has no FUSED path: one
    evaluation."""
    _jax()
    from raft_tpu.api import make_farm_evaluator

    rows = _rows_at(farm_rows("semi_wind"), GRAD_FARM_ROWS)
    ev = make_farm_evaluator(farm_model("semi_wind"),
                             nWaves=FARM_SETS["semi_wind"])
    with _floored_jonswap():
        val, g = _grad_pair(lambda r: response_metric(ev(r)), (rows,))
        diag = _forward_diag(ev, rows)
    gd = dict(rows, metric=val)
    gd.update({f"g_{k}": v for k, v in g.items()})
    gd.update(diag)
    return gd


def _flat_struct_params(sp, prefix="sp."):
    """A ``struct_params`` tree as flat real leaves ``sp.<path>``, each
    complex leaf (Imat, the inertia coefficients Cm) as ``<path>.re`` and
    ``<path>.im``: ``jax.grad`` and torch differ in their complex
    convention, real parts do not."""
    import numpy as np

    out = {}
    for k, v in sp.items():
        if isinstance(v, dict):
            out.update(_flat_struct_params(v, f"{prefix}{k}."))
        elif np.iscomplexobj(v):
            out[f"{prefix}{k}.re"] = np.real(v).copy()
            out[f"{prefix}{k}.im"] = np.imag(v).copy()
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=float)
    return out


def _tree_struct_params(flat):
    """The inverse of :func:`_flat_struct_params` (the ``sp.`` keys of
    ``flat``)."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith("sp."):
            continue
        path = key[3:].split(".")
        if path[-1] in ("re", "im"):
            if path[-1] == "im":
                continue
            v = v + 1j * flat[key[:-3] + ".im"]
            path = path[:-1]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def _grad_directional(metric, x, n_dir, seed=GEOM_SEED):
    """Per-row jax.grad of ``metric`` over the rows of the flat dict
    ``x``, checked against jax.jvp along ``n_dir`` random directions
    within 1e-10 x the directional derivative's scale, all finite."""
    jax = _jax()
    import numpy as np

    val = np.asarray(jax.jit(jax.vmap(metric))(x))
    grev = jax.jit(jax.vmap(jax.grad(metric)))(x)
    out = {k: np.asarray(v) for k, v in grev.items()}
    for k, a in out.items():
        assert np.all(np.isfinite(a)), k
    rng = np.random.default_rng(seed)
    jvp = jax.jit(jax.vmap(lambda p, t: jax.jvp(metric, (p,), (t,))[1]))
    for _ in range(n_dir):
        t = {k: rng.normal(size=np.shape(v)) for k, v in x.items()}
        fwd = np.asarray(jvp(x, t))
        rev = sum(np.sum((out[k] * t[k]).reshape(len(val), -1), axis=1)
                  for k in out)
        scale = sum(np.sum(np.abs(out[k] * t[k]).reshape(len(val), -1),
                           axis=1) for k in out)
        err = np.abs(rev - fwd)
        assert np.all(err <= 1e-10 * scale), (err, scale)
    return val, out


def build_grad_flex_golden():
    """The ``golden_grad_flex_semi_wind.npz`` dict: semi_wind_flex on
    rows :data:`GRAD_FLEX_ROWS`: the response metric and its gradient
    with respect to every row input (``jax.jacfwd``-checked), and the
    same rows through the geometry evaluator with the struct_params of
    the tower rebuilt at :data:`GRAD_FLEX_GEOMETRY` (``geo_*``): the
    gradient with respect to the row inputs and every struct_params leaf
    (``geo_g_sp.<path>``, complex leaves as real and imaginary parts),
    checked along random directions.  The flexible evaluator has no
    FUSED path."""
    _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import flexible_struct_params, make_flexible_evaluator

    rows = _rows_at(full_rows("semi_wind"), GRAD_FLEX_ROWS)
    model = raft_tpu.Model(semi_wind_flex_design())
    ev = make_flexible_evaluator(model, nWaves=1)
    gd = dict(rows)
    with _floored_jonswap():
        val, g = _grad_pair(lambda r: response_metric(ev(r)), (rows,))
        gd.update(metric=val, **{f"g_{k}": v for k, v in g.items()})
        gd.update(_forward_diag(ev, rows))
        sp = flexible_struct_params(raft_tpu.Model(
            semi_wind_flex_design(*GRAD_FLEX_GEOMETRY)))
        n = len(rows["Hs"])
        flat = {k: np.stack([v] * n)
                for k, v in _flat_struct_params(sp).items()}
        geo = make_flexible_evaluator(model, nWaves=1, geometry=True)

        def case(x):
            c = {k: v for k, v in x.items() if not k.startswith("sp.")}
            c["struct_params"] = _tree_struct_params(x)
            return c

        x = dict(rows, **flat)
        gval, gg = _grad_directional(
            lambda x: response_metric(geo(case(x))), x,
            GRAD_FLEX_DIRECTIONS)
        gdiag = _forward_diag(lambda x: geo(case(x)), x)
    gd.update({f"geo_{k}": v for k, v in flat.items()})
    gd["geo_metric"] = gval
    gd.update({f"geo_g_{k}": v for k, v in gg.items()})
    gd.update({f"geo_{k}": v for k, v in gdiag.items()})
    return gd


def write_grad_rest_fixtures(parts=GRAD_REST_PARTS):
    """Write the gradient goldens of the aero, potential-flow, farm and
    flexible paths (of ``parts``)."""
    import numpy as np

    builders = {
        "aero_semi_wind": ("golden_grad_aero_semi_wind.npz",
                           lambda: build_grad_aero_golden("semi_wind")),
        "aero_mhk_tidal": ("golden_grad_aero_mhk_tidal.npz",
                           lambda: build_grad_aero_golden("mhk_tidal")),
        "bem": ("golden_grad_bem_semi_wind_coarse.npz",
                build_grad_bem_golden),
        "bem_full": ("golden_grad_bem_semi_wind.npz",
                     lambda: build_grad_bem_golden("semi_wind")),
        "farm": ("golden_grad_farm_semi_wind.npz", build_grad_farm_golden),
        "flex": ("golden_grad_flex_semi_wind.npz", build_grad_flex_golden),
    }
    for part in parts:
        fname, build = builders[part]
        gd = build()
        np.savez_compressed(os.path.join(OUT_DIR, fname), **gd)
        metrics = {k: np.asarray(v).tolist() for k, v in gd.items()
                   if k.endswith("metric")}
        print(f"grad {part}: {metrics}", flush=True)


# --------------------------------------- forward mode of every evaluator

#: forward-mode directions per golden set, and the numpy seed of the
#: first (direction d is drawn from seed JVP_SEED + d, one standard
#: normal per input element, keys in sorted order)
JVP_DIRECTIONS = 2
JVP_SEED = 20261101
JVP_PARTS = ("design_spar", "design_semi", "design_mhk", "geometry_spar",
             "geometry_semi", "geometry_semi_wind", "aero_semi_wind",
             "aero_mhk_tidal", "bem", "bem_full", "farm", "flex", "qtf")


def jvp_directions(x, d):
    """Direction ``d`` of the forward-mode goldens over the flat dict of
    inputs ``x``: a standard normal per element, drawn from the numpy
    seed ``JVP_SEED + d`` in the sorted order of the keys."""
    import numpy as np

    rng = np.random.default_rng(JVP_SEED + d)
    return {k: rng.normal(size=np.shape(x[k])) for k in sorted(x)}


def metric_tangent(out, tan):
    """The tangent of :func:`response_metric` per row from the outputs'
    primal and tangent (numpy, rows first)."""
    import numpy as np

    Xi, dXi = np.asarray(out["Xi"]), np.asarray(tan["Xi"])
    X0, dX0 = np.asarray(out["X0"]), np.asarray(tan["X0"])
    n = X0.shape[0]
    return (2.0 * np.sum(np.real(np.conj(Xi[:, 0]) * dXi[:, 0]).reshape(
        n, -1), axis=1) + 2.0 * np.sum((X0 * dX0).reshape(n, -1), axis=1))


def _jvp_golden(fn, x, rest, grad, keys):
    """Per-row ``jax.jvp`` of ``fn(x, rest)`` (the evaluator's output
    dict) in ``x`` along :data:`JVP_DIRECTIONS` directions
    (:func:`jvp_directions`), vmapped over the rows of ``x`` and
    ``rest``.  Returns the primal of every key of ``keys`` and, per
    direction d, ``dir{d}_<input>`` and the tangent ``jvp{d}_<key>`` of
    every float key.  Each direction's metric tangent
    (:func:`metric_tangent`) is asserted against the reference's
    ``jax.grad`` of the metric along it, ``grad`` (the gradient golden
    of the same rows, keyed by input, or None: taken here, per row by
    ``jax.grad``), within 1e-10 x the sum of |g t|; every tangent
    finite."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    def one(x, r, t):
        out, tan = jax.jvp(lambda x: fn(x, r), (x,), (t,))
        return out, {k: tan[k] for k in keys
                     if jnp.issubdtype(out[k].dtype, jnp.inexact)}

    if grad is None:
        grad = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jax.grad(
            lambda x, r: response_metric(fn(x, r)))))(x, rest).items()}
    f = jax.jit(jax.vmap(one))
    gd = {}
    for d in range(JVP_DIRECTIONS):
        t = jvp_directions(x, d)
        out, tan = f(x, rest, t)
        out = {k: np.asarray(out[k]) for k in keys}
        tan = {k: np.asarray(v) for k, v in tan.items()}
        if d == 0:
            gd.update(out)
        for k, v in out.items():
            np.testing.assert_array_equal(v, gd[k], err_msg=k)
        for k, v in tan.items():
            assert np.all(np.isfinite(v)), (d, k)
        n = len(np.asarray(out["X0"]))
        rev = sum(np.sum((grad[k] * t[k]).reshape(n, -1), axis=1)
                  for k in x)
        scale = sum(np.sum(np.abs(grad[k] * t[k]).reshape(n, -1), axis=1)
                    for k in x)
        err = np.abs(metric_tangent(out, tan) - rev)
        assert np.all(err <= 1e-10 * scale), (d, err, scale)
        gd.update({f"dir{d}_{k}": v for k, v in t.items()})
        gd.update({f"jvp{d}_{k}": v for k, v in tan.items()})
    return gd


def _grad_of(name, pfx, keys):
    """The gradient golden ``golden_grad_<name>.npz``'s ``<pfx>g_<key>``
    of every key of ``keys``, keyed by input."""
    import numpy as np

    g = np.load(os.path.join(OUT_DIR, f"golden_grad_{name}.npz"))
    return {k: g[f"{pfx}g_{k}"] for k in keys}


def build_jvp_design_golden(name):
    """``golden_jvp_design_<name>.npz``: the design evaluator on
    :data:`GRAD_DESIGN_ROWS` in its six inputs, FUSED on and off, the
    spectrum floored (:func:`_floored_jonswap`)."""
    _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_design_evaluator

    params = {k: np.asarray(c, dtype=float) for k, c in
              zip(DESIGN_KEYS, zip(*GRAD_DESIGN_ROWS))}
    gd = dict(params)
    for fused in ("on", "off"):
        def run():
            model = raft_tpu.Model(os.path.join(ROOT, "raft_tpu", "designs",
                                                DESIGNS[name]))
            ev = make_design_evaluator(model)
            with _floored_jonswap():
                return _jvp_golden(
                    lambda p, r: ev(p), params, {},
                    _grad_of(f"design_{name}", f"{fused}_", DESIGN_KEYS),
                    OUT_KEYS)
        gd.update({f"{fused}_{k}": v for k, v in _with_fused(fused,
                                                             run).items()})
    return gd


def build_jvp_geometry_golden(name):
    """``golden_jvp_geometry_<name>.npz``: the geometry evaluator on the
    rows of ``golden_grad_<name>.npz`` in every geometry key, FUSED on
    and off."""
    _jax()
    rows = {k: v[:GRAD_ROWS] for k, v in full_rows(name).items()}
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            model, ev = _geometry_evaluator(name)
            geom = {k: v[:GRAD_ROWS] for k, v in geometry_rows(
                len(model.fowtList[0].members)).items()}
            gd.update({f"geom_{k}": v for k, v in geom.items()})
            return _jvp_golden(lambda g, r: ev(dict(r, geom=g)), geom, rows,
                               _grad_of(name, f"{fused}_", geom),
                               FULL_OUT_KEYS)
        gd.update({f"{fused}_{k}": v for k, v in _with_fused(fused,
                                                             run).items()})
    return gd


def build_jvp_aero_golden(name):
    """``golden_jvp_aero_<name>.npz``: the full evaluator of a rotor
    design on :data:`GRAD_AERO_ROWS` in every row input, FUSED on and
    off, the spectrum floored."""
    _jax()
    import raft_tpu
    from raft_tpu.api import make_full_evaluator

    rows = _rows_at(full_rows(name), GRAD_AERO_ROWS[name])
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            ev = make_full_evaluator(raft_tpu.Model(full_design(name)),
                                     nWaves=FULL_SETS[name])
            with _floored_jonswap():
                return _jvp_golden(
                    lambda r, _: ev(r), rows, {},
                    _grad_of(f"aero_{name}", f"{fused}_", rows),
                    FULL_OUT_KEYS)
        gd.update({f"{fused}_{k}": v for k, v in _with_fused(fused,
                                                             run).items()})
    return gd


def build_jvp_bem_golden(name="semi_wind_coarse"):
    """``golden_jvp_bem_<name>.npz``: a potential-flow design's geometry
    evaluator on the rows of ``golden_grad_bem_<name>.npz`` in d_scale
    and every row input, FUSED on and off, the spectrum floored (the
    coefficients solved as :func:`build_grad_bem_golden` solves
    them)."""
    import shutil
    import tempfile

    _jax()
    import numpy as np

    from raft_tpu.api import make_full_evaluator
    from raft_tpu.native import green_table as jgt

    sys.path.insert(0, ROOT)
    from raft_tpu_torch.native import green_table

    jgt._tables = dict(green_table.build_tables())
    cache = tempfile.mkdtemp(prefix="bem_cache_")
    jdir = os.path.join(OUT_DIR, "bem_cache_jax")
    for f in os.listdir(jdir):
        shutil.copy(os.path.join(jdir, f), cache)
    prev = os.environ.get("RAFT_TPU_BEM_DIR")
    os.environ["RAFT_TPU_BEM_DIR"] = cache
    try:
        rows = _rows_at(bem_rows(BEM_ROWS), GRAD_BEM_ROWS)
        x = dict(rows, d_scale=np.asarray(GRAD_BEM_D_SCALE, dtype=float))
        gd = dict(x)
        model = bem_model(name)
        for fused in ("on", "off"):
            def run():
                ev = make_full_evaluator(model, nWaves=1, geometry=True)
                ev.geometry_constants(dict(d_scale=1.0))

                def case(x, _):
                    c = {k: v for k, v in x.items() if k != "d_scale"}
                    c["geom"] = dict(d_scale=x["d_scale"])
                    return ev(c)

                with _floored_jonswap():
                    return _jvp_golden(
                        case, x, {}, _grad_of(f"bem_{name}", f"{fused}_", x),
                        FULL_OUT_KEYS)
            gd.update({f"{fused}_{k}": v
                       for k, v in _with_fused(fused, run).items()})
        return gd
    finally:
        if prev is None:
            os.environ.pop("RAFT_TPU_BEM_DIR", None)
        else:
            os.environ["RAFT_TPU_BEM_DIR"] = prev
        shutil.rmtree(cache, ignore_errors=True)


def build_jvp_farm_golden():
    """``golden_jvp_farm_semi_wind.npz``: the two-unit farm on
    :data:`GRAD_FARM_ROWS` in every row input, the spectrum floored (no
    FUSED path)."""
    _jax()
    from raft_tpu.api import make_farm_evaluator

    rows = _rows_at(farm_rows("semi_wind"), GRAD_FARM_ROWS)
    ev = make_farm_evaluator(farm_model("semi_wind"),
                             nWaves=FARM_SETS["semi_wind"])
    with _floored_jonswap():
        gd = _jvp_golden(lambda r, _: ev(r), rows, {},
                         _grad_of("farm_semi_wind", "", rows), FARM_OUT_KEYS)
    return dict(rows, **gd)


def build_jvp_flex_golden():
    """``golden_jvp_flex_semi_wind.npz``: semi_wind_flex on
    :data:`GRAD_FLEX_ROWS` in every row input, and (``geo_*``) its
    geometry evaluator on the same rows in the row inputs and every
    struct_params leaf of the tower rebuilt at
    :data:`GRAD_FLEX_GEOMETRY` (complex leaves as real and imaginary
    parts), the spectrum floored (no FUSED path)."""
    _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import flexible_struct_params, make_flexible_evaluator

    rows = _rows_at(full_rows("semi_wind"), GRAD_FLEX_ROWS)
    model = raft_tpu.Model(semi_wind_flex_design())
    ev = make_flexible_evaluator(model, nWaves=1)
    gd = dict(rows)
    with _floored_jonswap():
        gd.update(_jvp_golden(lambda r, _: ev(r), rows, {},
                              _grad_of("flex_semi_wind", "", rows),
                              FLEX_OUT_KEYS))
        sp = flexible_struct_params(raft_tpu.Model(
            semi_wind_flex_design(*GRAD_FLEX_GEOMETRY)))
        n = len(rows["Hs"])
        flat = {k: np.stack([v] * n)
                for k, v in _flat_struct_params(sp).items()}
        geo = make_flexible_evaluator(model, nWaves=1, geometry=True)

        def case(x, _):
            c = {k: v for k, v in x.items() if not k.startswith("sp.")}
            c["struct_params"] = _tree_struct_params(x)
            return geo(c)

        x = dict(rows, **flat)
        geo_gd = _jvp_golden(case, x, {},
                             _grad_of("flex_semi_wind", "geo_", x),
                             FLEX_OUT_KEYS)
    # the geometry rows' struct_params leaves are in the gradient golden;
    # their directions are drawn again from the seed (jvp_directions)
    gd.update({f"geo_{k}": v for k, v in geo_gd.items()
               if not (k.startswith("dir") and "_sp." in k)})
    return gd


def build_jvp_qtf_golden():
    """``golden_jvp_qtf_semi_wind.npz``: the full evaluator of
    semi_wind_qtf (the external QTF, its drift equilibrium) on
    :data:`GRAD_AERO_ROWS` of semi_wind in every row input, FUSED on and
    off, the spectrum floored; no gradient golden has these rows, so
    ``jax.grad`` is taken here for the check."""
    _jax()
    import numpy as np

    from raft_tpu.api import make_full_evaluator

    rows = _rows_at({k: np.asarray(v, dtype=float)
                     for k, v in QTF_ROWS.items()},
                    GRAD_AERO_ROWS["semi_wind"])
    gd = dict(rows)
    for fused in ("on", "off"):
        def run():
            ev = make_full_evaluator(qtf_model("semi_wind_qtf"), nWaves=1)
            with _floored_jonswap():
                return _jvp_golden(lambda r, _: ev(r), rows, {}, None,
                                   FULL_OUT_KEYS)
        gd.update({f"{fused}_{k}": v for k, v in _with_fused(fused,
                                                             run).items()})
    return gd


def write_jvp_fixtures(parts=JVP_PARTS):
    """Write the forward-mode goldens ``golden_jvp_<set>.npz`` (of
    ``parts``)."""
    import numpy as np

    builders = {
        **{f"design_{n}": (lambda n=n: build_jvp_design_golden(n))
           for n in DESIGNS},
        **{f"geometry_{n}": (lambda n=n: build_jvp_geometry_golden(n))
           for n in GRAD_SETS},
        "aero_semi_wind": lambda: build_jvp_aero_golden("semi_wind"),
        "aero_mhk_tidal": lambda: build_jvp_aero_golden("mhk_tidal"),
        "bem": lambda: build_jvp_bem_golden("semi_wind_coarse"),
        "bem_full": lambda: build_jvp_bem_golden("semi_wind"),
        "farm": build_jvp_farm_golden,
        "flex": build_jvp_flex_golden,
        "qtf": build_jvp_qtf_golden,
    }
    files = {"bem": "bem_semi_wind_coarse", "bem_full": "bem_semi_wind",
             "farm": "farm_semi_wind", "flex": "flex_semi_wind",
             "qtf": "qtf_semi_wind"}
    for part in parts:
        gd = builders[part]()
        np.savez_compressed(os.path.join(
            OUT_DIR, f"golden_jvp_{files.get(part, part)}.npz"), **gd)
        print(f"jvp {part}: {sorted(k for k in gd if 'jvp0_' in k)}",
              flush=True)


# ------------------------------------------------------- farm fixtures

#: the shared line of the two-unit farm: a MoorDyn v2 file, one line in
#: two slack segments from unit 1 over a free buoy (net buoyancy
#: 252.6 kN) to unit 2, attached body-locally on the facing sides; no
#: segment can ground (no fixed point)
FARM_SHARED_DAT = """\
--------------------- MoorDyn Input File ------------------------------------
Shared mooring line between the two units of design_farm_semi_wind.json
---------------------- LINE TYPES -----------------------------------------
Name     Diam     MassDen   EA        BA/-zeta  EI      Cd    Ca    CdAx  CaAx
(name)   (m)      (kg/m)    (N)       (N-s/-)   (N-m^2) (-)   (-)   (-)   (-)
shared   0.150    50.0      1.0e9     -1.0      0.0     1.2   1.0   0.2   0.0
---------------------- POINTS ---------------------------------------------
ID  Attachment  X       Y     Z      M       V     CdA   Ca
(#) (-)         (m)     (m)   (m)    (kg)    (m^3) (m^2) (-)
1   Turbine1    58.0    0.0   -14.0  0       0     0     0
2   Free        1000.0  0.0   -60.0  5000.0  30.0  0     0
3   Turbine2    -58.0   0.0   -14.0  0       0     0     0
---------------------- LINES ----------------------------------------------
ID  LineType  AttachA  AttachB  UnstrLen  NumSegs  Outputs
(#) (name)    (#)      (#)      (m)       (-)      (-)
1   shared    1        2        960.0     40       -
2   shared    2        3        960.0     40       -
---------------------- OPTIONS --------------------------------------------
200      depth
---------------------- OUTPUTS --------------------------------------------
END
"""

ARRAY_KEYS = ["ID", "turbineID", "platformID", "mooringID", "x_location",
              "y_location", "heading_adjust"]


def farm_semi_wind_design():
    """Two semi_wind units 2000 m apart (about 8 rotor diameters), each
    on its own three-line catenary mooring, joined by the shared line of
    ``farm_shared.dat``."""
    d = semi_wind_design()
    d["name"] = ("raft_tpu_torch fixture: two semi_wind units with a "
                 "shared line over a buoy")
    d.pop("cases", None)
    d["array"] = dict(keys=ARRAY_KEYS, data=[[1, 1, 1, 1, 0.0, 0.0, 0.0],
                                             [2, 1, 1, 1, 2000.0, 0.0, 0.0]])
    d["array_mooring"] = dict(file="farm_shared.dat")
    return d


def farm_spar3_design():
    """Three spar demo units on a 2000 m triangle at heading_adjust 0,
    120 and 240 deg, each on its own mooring, no rotor model, no shared
    line."""
    d = design_dict("spar")
    d["name"] = "raft_tpu_torch fixture: three spar demo units"
    d.pop("cases", None)
    d["array"] = dict(keys=ARRAY_KEYS, data=[
        [1, 1, 1, 1, 0.0, 0.0, 0.0],
        [2, 1, 1, 1, 2000.0, 0.0, 120.0],
        [3, 1, 1, 1, 1000.0, 1732.0508, 240.0]])
    return d


FARM_DESIGNS = {"semi_wind": farm_semi_wind_design,
                "spar3": farm_spar3_design}
#: wave headings per row of each farm golden set
FARM_SETS = {"semi_wind": 1, "spar3": 2}
#: the farm golden rows: per-unit (waked) wind speeds (one unit at
#: 0.05 m/s on row 1, clipped to 0.1), seas per wave heading
FARM_ROWS = {
    "semi_wind": dict(
        wind_speed=[[10.0, 8.5], [0.0, 0.05], [5.0, 4.1], [14.0, 11.2],
                    [25.0, 20.0], [8.0, 7.3], [11.0, 9.0], [18.0, 14.5]],
        wind_heading_deg=[0.0, 10.0, -20.0, 30.0, 0.0, -10.0, 5.0, 25.0],
        TI=[0.10, 0.05, 0.20, 0.12, 0.08, 0.15, 0.10, 0.06],
        yaw_misalign_deg=[0.0, 3.0, -5.0, 0.0, 8.0, -8.0, 2.0, 0.0],
        current_speed=[0.0, 0.5, 1.0, 0.2, 0.0, 0.8, 0.3, 0.6],
        current_heading_deg=[0.0, 45.0, 90.0, 180.0, 270.0, 10.0, 300.0,
                             30.0],
        Hs=[[6.0], [2.5], [1.0], [12.0], [9.0], [4.0], [11.0], [3.0]],
        Tp=[[12.0], [7.5], [4.0], [20.0], [14.0], [9.0], [6.0], [17.0]],
        gamma=[[0.0], [3.3], [0.0], [1.0], [0.0], [2.0], [0.0], [5.0]],
        beta_deg=[[0.0], [20.0], [178.0], [70.0], [137.0], [45.0], [110.0],
                  [5.0]]),
    "spar3": dict(
        wind_speed=[[0.0] * 3] * 8,
        wind_heading_deg=[0.0] * 8, TI=[0.0] * 8,
        yaw_misalign_deg=[0.0] * 8,
        current_speed=[0.0, 0.5, 1.0, 0.2, 0.0, 0.8, 0.3, 0.6],
        current_heading_deg=[0.0, 45.0, 90.0, 180.0, 270.0, 10.0, 300.0,
                             30.0],
        Hs=[[6.0, 2.0], [2.5, 1.0], [1.0, 0.5], [12.0, 3.0], [9.0, 2.5],
            [4.0, 1.5], [11.0, 4.0], [3.0, 3.0]],
        Tp=[[12.0, 8.0], [7.5, 5.0], [4.0, 9.0], [20.0, 11.0], [14.0, 6.0],
            [9.0, 14.0], [6.0, 7.0], [17.0, 10.0]],
        gamma=[[0.0, 0.0], [3.3, 1.0], [0.0, 2.0], [1.0, 0.0], [0.0, 5.0],
               [2.0, 0.0], [0.0, 3.3], [5.0, 1.0]],
        beta_deg=[[0.0, 90.0], [20.0, 200.0], [178.0, 0.0], [70.0, 300.0],
                  [137.0, 45.0], [45.0, 120.0], [110.0, 260.0],
                  [5.0, 175.0]]),
}
FARM_OUT_KEYS = ("X0", "Xi", "PSD", "S", "zeta", "drag_resid", "n_iter_drag",
                 "status")
#: the network golden's perturbations of golden row 0's equilibrium:
#: per pose, the offsets of both units' 6 DOFs
NETWORK_PERTURB = (
    [[3.0, -2.0, 0.5, 0.01, -0.02, 0.03], [-4.0, 1.5, -0.3, -0.01, 0.015,
                                            -0.02]],
    [[-10.0, 5.0, 1.0, 0.0, 0.03, -0.05], [12.0, -6.0, 0.0, 0.02, 0.0, 0.04]],
    [[0.0, 20.0, -1.0, 0.04, 0.0, 0.1], [0.0, -20.0, 1.0, -0.04, 0.0, -0.1]],
)
#: catenary spans (XF, ZF) and line properties (L, w, EA) for the
#: can_ground=False golden: slack, taut and inverted spans
CATENARY_SUSPENDED = (
    (942.0, 48.6, 960.0, 312.8, 1.0e9),
    (900.0, 100.0, 905.0, 312.8, 1.0e9),
    (500.0, -30.0, 600.0, 1500.0, 5.0e8),
    (300.0, 250.0, 600.0, 6400.0, 3.0e9),
    (950.0, 5.0, 949.0, 312.8, 1.0e9),
    (10.0, 80.0, 120.0, 200.0, 2.0e8),
)


def farm_model(name):
    import raft_tpu

    return raft_tpu.Model(FARM_DESIGNS[name](), base_dir=OUT_DIR)


def farm_rows(name):
    import numpy as np

    return {k: np.asarray(v, dtype=float) for k, v in FARM_ROWS[name].items()}


def golden_farm(name, fused):
    """JAX farm-evaluator outputs over the set's golden rows."""
    jax = _jax()
    import numpy as np

    from raft_tpu.api import make_farm_evaluator

    def run():
        ev = make_farm_evaluator(farm_model(name), nWaves=FARM_SETS[name])
        out = jax.jit(jax.vmap(ev))(farm_rows(name))
        return {k: np.asarray(out[k]) for k in FARM_OUT_KEYS}

    return _with_fused(fused, run)


def build_farm_golden(name):
    """The ``golden_farm_<name>.npz`` dict, as written."""
    gd = dict(farm_rows(name))
    for fused in ("on", "off"):
        for k, v in golden_farm(name, fused).items():
            gd[f"{fused}_{k}"] = v
    return gd


def build_network_golden(X0):
    """The ``golden_network_semi_wind.npz`` dict: the JAX network's body
    forces, coupled stiffness, free-point positions and line tensions at
    the golden rows' equilibria X0 (R, 12) and at NETWORK_PERTURB about
    row 0's, plus the JAX catenary with ``can_ground=False`` over
    CATENARY_SUSPENDED."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from raft_tpu.physics.mooring import solve_catenary

    net = farm_model("semi_wind").ms_array
    poses = [np.asarray(x).reshape(2, 6) for x in X0]
    poses += [poses[0] + np.asarray(d) for d in NETWORK_PERTURB]
    out = dict(X=np.stack(poses))
    keys = ("F", "K", "r_free", "tensions")
    for k in keys:
        out[k] = []
    for r6 in poses:
        F, info = net.body_forces(jnp.asarray(r6))
        out["F"].append(np.asarray(F))
        out["K"].append(np.asarray(net.stiffness(jnp.asarray(r6))))
        out["r_free"].append(np.asarray(info["r_free"]))
        out["tensions"].append(np.asarray(info["tensions"]))
    out.update({k: np.stack(out[k]) for k in keys})
    cat = np.asarray(CATENARY_SUSPENDED, dtype=float)
    res = jax.vmap(lambda c: jnp.stack(solve_catenary(
        c[0], c[1], c[2], c[3], c[4], can_ground=False)))(jnp.asarray(cat))
    out.update(cat_in=cat, cat_out=np.asarray(res))
    return out


def write_farm_fixtures():
    """Write the farm designs, the shared-line file and the farm and
    network goldens."""
    import json

    import numpy as np

    with open(os.path.join(OUT_DIR, "farm_shared.dat"), "w") as f:
        f.write(FARM_SHARED_DAT)
    for name, fn in FARM_DESIGNS.items():
        with open(os.path.join(OUT_DIR, f"design_farm_{name}.json"), "w") as f:
            f.write(json.dumps(fn(), indent=1) + "\n")
    for name in FARM_DESIGNS:
        gd = build_farm_golden(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_farm_{name}.npz"),
                            **gd)
        print(f"farm {name}: status_on={gd['on_status'].tolist()} "
              f"n_iter_on={gd['on_n_iter_drag'].tolist()}", flush=True)
        if name == "semi_wind":
            np.savez_compressed(
                os.path.join(OUT_DIR, "golden_network_semi_wind.npz"),
                **build_network_golden(gd["on_X0"]))


# ---------------------------------------------------------------- flexible

#: steel's Young's and shear moduli of the flexible towers [Pa]
STEEL_E, STEEL_G = 200.0e9, 79.3e9
#: the seed of the spar_flex golden rows
FLEX_SPAR_SEED = 11
#: rows of the spar_flex golden set
FLEX_SPAR_ROWS = 6
#: (tower d scale, tower t scale) of the flexible geometry goldens
FLEX_GEOMETRY_SCALES = ((0.9, 1.1), (1.1, 0.9), (1.05, 0.95))
#: rows of semi_wind's golden table per flexible geometry design
FLEX_GEOMETRY_ROWS = 3
FLEX_OUT_KEYS = ("X0", "Xi", "PSD", "S", "zeta", "drag_resid",
                 "drag_converged", "n_iter_drag", "status")


def flexible_tower(d, d_scale=1.0, t_scale=1.0):
    """``d`` with its tower a steel beam, diameters and thicknesses
    scaled."""
    tw = d["turbine"]["tower"]
    tw.update(type="beam", E=STEEL_E, G=STEEL_G,
              d=[x * d_scale for x in tw["d"]],
              t=[x * t_scale for x in tw["t"]])
    return d


def spar_flex_design():
    d = flexible_tower(design_dict("spar"))
    d["name"] = "raft_tpu_torch fixture: spar demo with a flexible tower"
    return d


def semi_wind_flex_design(d_scale=1.0, t_scale=1.0):
    d = flexible_tower(semi_wind_design(), d_scale, t_scale)
    d["name"] = "raft_tpu_torch fixture: semi_wind with a flexible tower"
    return d


FLEX_DESIGNS = {"spar": spar_flex_design, "semi_wind": semi_wind_flex_design}
#: wave headings per row of each flexible golden set
FLEX_SETS = {"spar": 2, "semi_wind": 1}


def flex_rows(name):
    """The golden rows of a flexible set as float64 numpy arrays: the
    spar's seeded seas (Hs 1-12 m, Tp 4-20 s, gamma 0-5, any heading)
    and current (0-1.5 m/s), or semi_wind's full-evaluator rows."""
    import numpy as np

    if name == "semi_wind":
        return full_rows("semi_wind")
    rng = np.random.default_rng(FLEX_SPAR_SEED)
    n, h = FLEX_SPAR_ROWS, FLEX_SETS["spar"]
    return dict(
        current_speed=rng.uniform(0.0, 1.5, n),
        current_heading_deg=rng.uniform(0.0, 360.0, n),
        Hs=rng.uniform(1.0, 12.0, (n, h)), Tp=rng.uniform(4.0, 20.0, (n, h)),
        gamma=rng.uniform(0.0, 5.0, (n, h)),
        beta_deg=rng.uniform(0.0, 360.0, (n, h)))


def golden_flex(name):
    """JAX flexible-evaluator outputs over the set's golden rows."""
    jax = _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_flexible_evaluator

    ev = make_flexible_evaluator(raft_tpu.Model(FLEX_DESIGNS[name]()),
                                 nWaves=FLEX_SETS[name])
    out = jax.jit(jax.vmap(ev))(flex_rows(name))
    return {k: np.asarray(out[k]) for k in FLEX_OUT_KEYS}


def flex_geometry_rows():
    """(rows, struct_params) of the flexible geometry golden: the first
    FLEX_GEOMETRY_ROWS semi_wind rows under each FLEX_GEOMETRY_SCALES
    design, the JAX ``flexible_struct_params`` of each design's host
    rebuild stacked per row."""
    _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import flexible_struct_params

    base = full_rows("semi_wind")
    n = FLEX_GEOMETRY_ROWS
    rows = {k: np.concatenate([v[:n]] * len(FLEX_GEOMETRY_SCALES))
            for k, v in base.items()}
    sps = [flexible_struct_params(raft_tpu.Model(
        semi_wind_flex_design(ds, ts))) for ds, ts in FLEX_GEOMETRY_SCALES]
    stacked = jax_tree_stack([sp for sp in sps for _ in range(n)])
    rows["d_scale"] = np.repeat([s[0] for s in FLEX_GEOMETRY_SCALES], n)
    rows["t_scale"] = np.repeat([s[1] for s in FLEX_GEOMETRY_SCALES], n)
    return rows, stacked


def jax_tree_stack(trees):
    """Stack a list of nested dicts of numpy arrays leaf by leaf."""
    import numpy as np

    if isinstance(trees[0], dict):
        return {k: jax_tree_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def golden_flex_geometry():
    """The ``golden_flex_geometry_semi_wind.npz`` dict: the rows, their
    tower scales and the JAX flexible geometry evaluator's outputs."""
    jax = _jax()
    import numpy as np

    import raft_tpu
    from raft_tpu.api import make_flexible_evaluator

    rows, sp = flex_geometry_rows()
    ev = make_flexible_evaluator(raft_tpu.Model(semi_wind_flex_design()),
                                 nWaves=1, geometry=True)
    case = {k: v for k, v in rows.items() if k not in ("d_scale", "t_scale")}
    case["struct_params"] = sp
    out = jax.jit(jax.vmap(ev))(case)
    gd = dict(rows)
    gd.update({f"on_{k}": np.asarray(out[k]) for k in FLEX_OUT_KEYS})
    return gd


def write_flex_fixtures():
    """Write the flexible designs and the flexible goldens."""
    import json

    import numpy as np

    for name, fn in FLEX_DESIGNS.items():
        with open(os.path.join(OUT_DIR, f"design_{name}_flex.json"),
                  "w") as f:
            f.write(json.dumps(fn(), indent=1) + "\n")
        gd = dict(flex_rows(name))
        gd.update({f"on_{k}": v for k, v in golden_flex(name).items()})
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_flex_{name}.npz"),
                            **gd)
        print(f"flex {name}: status={gd['on_status'].tolist()} "
              f"n_iter={gd['on_n_iter_drag'].tolist()}", flush=True)
    gd = golden_flex_geometry()
    np.savez_compressed(
        os.path.join(OUT_DIR, "golden_flex_geometry_semi_wind.npz"), **gd)
    print(f"flex geometry: status={gd['on_status'].tolist()} "
          f"n_iter={gd['on_n_iter_drag'].tolist()}", flush=True)


# ---------------------------------------------------------- potential flow

#: the coarse mesh of the CPU tests' copy
BEM_COARSE = dict(nAz_BEM=8, dz_BEM=3.0)
#: the evaluator rows of the potential-flow sets: semi_wind's
BEM_ROWS = SEMI_WIND_ROWS
#: two headings: semi_wind's rows with a second heading around the
#: wrap (negative, past 360, between the last BEM heading and 360)
BEM_ROWS2 = dict(
    SEMI_WIND_ROWS,
    Hs=[[6.0, 2.0], [2.0, 1.0], [4.0, 3.0], [8.0, 1.5], [10.0, 2.5],
        [12.0, 4.0], [1.5, 1.0], [9.0, 3.0]],
    Tp=[[12.0, 6.0], [7.0, 5.0], [9.0, 11.0], [13.0, 7.0], [15.0, 8.0],
        [18.0, 9.0], [5.0, 4.0], [11.0, 14.0]],
    gamma=[[0.0, 1.0], [3.3, 0.0], [0.0, 2.0], [1.0, 0.0], [2.0, 5.0],
           [0.0, 1.0], [5.0, 0.0], [0.0, 3.3]],
    beta_deg=[[0.0, 90.0], [30.0, 350.0], [90.0, 359.5], [150.0, -30.0],
              [10.0, 315.0], [180.0, 400.0], [60.0, 200.0],
              [120.0, 337.5]],
)
#: the geometry rows' uniform diameter scales (inside bem_geom_scales'
#: 0.92-1.08, both ends and 1 included)
BEM_D_SCALE = (1.0, 0.92, 0.95, 1.02, 1.05, 1.08, 0.97, 1.0)
BEM_SETS = ("semi_wind", "semi_wind_coarse", "semi_wind_wamit")
BEM_COEF_KEYS = ("A_BEM", "B_BEM", "X_BEM", "headings")


def semi_wind_bem_design(coarse=False):
    """semi_wind with every platform member potential flow; ``coarse``
    the CPU tests' mesh (:data:`BEM_COARSE`)."""
    d = semi_wind_design()
    # the cache files are named after the design: no colon in the name
    d["name"] = ("semi_wind_bem - raft_tpu_torch fixture of semi_wind with "
                 "potential flow")
    d["platform"]["potModMaster"] = 2
    if coarse:
        d["name"] = ("semi_wind_bem_coarse - raft_tpu_torch fixture of "
                     "semi_wind with potential flow on a coarse mesh")
        d["settings"].update(BEM_COARSE)
    return d


def semi_wind_wamit_design():
    """semi_wind with its first-order coefficients from
    ``semi_wind_wamit.1`` / ``.3`` (its members potential flow, so no
    Morison inertia)."""
    d = semi_wind_design()
    d["name"] = ("semi_wind_wamit - raft_tpu_torch fixture of semi_wind with "
                 "WAMIT coefficient files")
    d["platform"].update(potModMaster=2, potFirstOrder=1,
                         hydroPath="semi_wind_wamit")
    return d


BEM_DESIGNS = {"semi_wind": semi_wind_bem_design,
               "semi_wind_coarse": lambda: semi_wind_bem_design(True),
               "semi_wind_wamit": semi_wind_wamit_design}
BEM_DESIGN_FILES = {"semi_wind": "design_semi_wind_bem.json",
                    "semi_wind_coarse": "design_semi_wind_bem_coarse.json",
                    "semi_wind_wamit": "design_semi_wind_wamit.json"}


def bem_model(name):
    """The JAX model of a potential-flow set (designs read from their
    fixture file, so a WAMIT path resolves against the fixtures)."""
    _jax()
    import raft_tpu

    return raft_tpu.Model(os.path.join(OUT_DIR, BEM_DESIGN_FILES[name]))


def bem_rows(rows, d_scale=None):
    import numpy as np

    out = {k: np.asarray(v, dtype=float) for k, v in rows.items()}
    if d_scale is not None:
        out["geom"] = dict(d_scale=np.asarray(d_scale, dtype=float))
    return out


def golden_bem_rows(name, rows, nWaves, fused, geometry=False):
    """JAX full-evaluator outputs of a potential-flow set over ``rows``
    (a ``geom`` entry with ``geometry``)."""
    jax = _jax()
    import numpy as np

    from raft_tpu.api import make_full_evaluator

    def run():
        ev = make_full_evaluator(bem_model(name), nWaves=nWaves,
                                 geometry=geometry)
        if geometry:
            # the d_scale samples are host solves: run them before the
            # trace, which then reads them
            ev.geometry_constants(dict(d_scale=1.0))
        out = jax.jit(jax.vmap(ev))(rows)
        return {k: np.asarray(out[k]) for k in FULL_OUT_KEYS}
    return _with_fused(fused, run)


def bem_coefficients(name):
    """The panel set's coefficients: the JAX mesh, the raw JAX
    ``native.solve_bem`` output on it and the model-grid coefficients of
    the JAX ``Model.run_bem`` (in the ``RAFT_TPU_BEM_DIR`` cache)."""
    import numpy as np

    from raft_tpu.io.panels import mesh_fowt
    from raft_tpu.native import solve_bem

    model = bem_model(name)
    st = model.design["settings"]
    fs = model.fowtList[0]
    v, c, n, a = mesh_fowt(fs, dz_max=st.get("dz_BEM") or None,
                           n_az=int(st.get("nAz_BEM", 18)))
    dw = (model.w[-1] - model.w[0]) / 24.0
    w_bem = np.arange(dw, model.w[-1] + 0.5 * dw, dw)
    heads = np.arange(0.0, 360.0, 45.0)
    A, B, X = solve_bem(v, c, n, a, w_bem, headings_deg=heads,
                        depth=model.depth, rho=fs.rho_water, g=fs.g)
    bem = model.run_bem()
    out = dict(n_panels=np.int64(len(a)), w_bem=w_bem, bem_headings=heads,
               A=A, B=B, X=X)
    out.update({f"coef_{k}": np.asarray(bem[k]) for k in BEM_COEF_KEYS})
    return out


def write_bem_fixtures():
    """Write the potential-flow designs, the WAMIT files, the JAX cache
    copy and the ``golden_bem_*`` files (about 20 min on 8 cores)."""
    import glob
    import json
    import shutil
    import tempfile

    import numpy as np

    cache = tempfile.mkdtemp(prefix="bem_cache_")
    os.environ["RAFT_TPU_BEM_DIR"] = cache
    try:
        for name in ("semi_wind", "semi_wind_coarse"):
            with open(os.path.join(OUT_DIR, BEM_DESIGN_FILES[name]), "w") as f:
                f.write(json.dumps(BEM_DESIGNS[name](), indent=1) + "\n")
        gds = {}
        for name in ("semi_wind", "semi_wind_coarse"):
            before = set(glob.glob(os.path.join(cache, "*")))
            gds[name] = bem_coefficients(name)
            new = sorted(set(glob.glob(os.path.join(cache, "*"))) - before)
            if name == "semi_wind":
                for f in new:
                    shutil.copy(f, os.path.join(
                        OUT_DIR, "semi_wind_wamit" + os.path.splitext(f)[1]))
            else:
                jdir = os.path.join(OUT_DIR, "bem_cache_jax")
                shutil.rmtree(jdir, ignore_errors=True)
                os.makedirs(jdir)
                for f in new:
                    shutil.copy(f, jdir)
        with open(os.path.join(OUT_DIR, BEM_DESIGN_FILES["semi_wind_wamit"]),
                  "w") as f:
            f.write(json.dumps(semi_wind_wamit_design(), indent=1) + "\n")
        gds["semi_wind_wamit"] = {}
        for name in BEM_SETS:
            gd = gds[name]
            runs = [("h1", BEM_ROWS, 1, None)]
            if name == "semi_wind_coarse":
                runs.append(("h2", BEM_ROWS2, 2, None))
            if name != "semi_wind_wamit":
                runs.append(("geo", BEM_ROWS, 1, BEM_D_SCALE))
            for tag, rows, nW, ds in runs:
                r = bem_rows(rows, ds)
                gd.update({f"{tag}_{k}": v for k, v in r.items()
                           if k != "geom"})
                if ds is not None:
                    gd[f"{tag}_d_scale"] = r["geom"]["d_scale"]
                for fused in ("on", "off"):
                    out = golden_bem_rows(name, r, nW, fused,
                                          geometry=ds is not None)
                    gd.update({f"{tag}_{fused}_{k}": v
                               for k, v in out.items()})
                print(f"bem {name} {tag}: "
                      f"status_on={gd[f'{tag}_on_status'].tolist()} "
                      f"n_iter_on={gd[f'{tag}_on_n_iter_drag'].tolist()}")
            np.savez_compressed(os.path.join(OUT_DIR, f"golden_bem_{name}.npz"),
                                **gd)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


# ------------------------------------------------------------ second order

#: the slender-body QTF grid of the slender design [Hz] (40 bins, the
#: model grid's span)
SLENDER_FREQ2ND = dict(min_freq2nd=0.005, max_freq2nd=0.2, df_freq2nd=0.005)
#: the heading of the slender goldens and the heading nodes of the
#: external QTF file [deg] (the span of the operating tables' headings)
SLENDER_BETA_DEG = 30.0
QTF_HEADS_DEG = (0.0, 45.0, 90.0, 135.0, 180.0)
#: the golden full-evaluator row whose RAO drives the slender QTF (the
#: rated-wind row of golden_full_semi_wind)
SLENDER_RAO_ROW = 3
#: the external-QTF evaluator rows: semi_wind's (headings on and
#: between the QTF's nodes over its 0-180 deg span), with two headings
#: BEM_ROWS2 (a second heading below, above and far past the span, so
#: the clip runs)
QTF_ROWS = SEMI_WIND_ROWS
QTF_ROWS2 = BEM_ROWS2
QTF_DESIGN_FILES = {"semi_wind_slender": "design_semi_wind_slender.json",
                    "semi_wind_qtf": "design_semi_wind_qtf.json",
                    "semi_wind_bem_coarse_qtf":
                        "design_semi_wind_bem_coarse_qtf.json"}


def semi_wind_slender_design():
    """semi_wind with a slender-body QTF (``potSecOrder: 1``) on a 40-bin
    grid and MacCamy-Fuchs outer columns (surface-piercing, so the Kim
    & Yue correction runs)."""
    d = semi_wind_design()
    d["name"] = ("semi_wind_slender - raft_tpu_torch fixture of semi_wind "
                 "with a slender-body QTF")
    d["platform"].update(potSecOrder=1, **SLENDER_FREQ2ND)
    for m in d["platform"]["members"]:
        if m["name"] == "offset_column":
            m["MCF"] = True
    return d


def semi_wind_qtf_design():
    """semi_wind (Morison strips) with the external QTF
    ``semi_wind_qtf.12d`` (``potSecOrder: 2``)."""
    d = semi_wind_design()
    d["name"] = ("semi_wind_qtf - raft_tpu_torch fixture of semi_wind with "
                 "an external QTF")
    d["platform"].update(potSecOrder=2, hydroPath="semi_wind_qtf")
    return d


def semi_wind_bem_coarse_qtf_design():
    """The coarse potential-flow semi_wind with the same external QTF
    (its name, and so its coefficient cache, the coarse design's)."""
    d = semi_wind_bem_design(coarse=True)
    d["platform"].update(potSecOrder=2, hydroPath="semi_wind_qtf")
    return d


QTF_DESIGNS = {"semi_wind_slender": semi_wind_slender_design,
               "semi_wind_qtf": semi_wind_qtf_design,
               "semi_wind_bem_coarse_qtf": semi_wind_bem_coarse_qtf_design}


def qtf_model(name):
    """The JAX model of a second-order set (read from its fixture file,
    so ``hydroPath`` resolves against the fixtures)."""
    _jax()
    import raft_tpu

    return raft_tpu.Model(os.path.join(OUT_DIR, QTF_DESIGN_FILES[name]))


def slender_qtf(model, beta_deg, Xi0=None):
    """The JAX ``fowt_qtf_slender`` of ``model`` at one heading [deg]."""
    import numpy as np

    from raft_tpu.physics.qtf_slender import fowt_qtf_slender

    model.hydro[0].beta = np.deg2rad(np.atleast_1d(float(beta_deg)))
    return np.asarray(fowt_qtf_slender(model, 0, Xi0=Xi0))


def build_slender_golden():
    """The ``golden_qtf_slender.npz`` dict: the fixed-body QTF at
    :data:`SLENDER_BETA_DEG`; driven by the RAO of golden_full_semi_wind
    row :data:`SLENDER_RAO_ROW`, the QTF, each member's ``member_qtf``
    (its upper triangle as pairs), the MacCamy-Fuchs members'
    ``kim_yue_correction`` (pairs) and ``pinkster_iv``."""
    import numpy as np

    from raft_tpu.physics.qtf_slender import (kim_yue_correction,
                                              member_qtf, pinkster_iv)

    model = qtf_model("semi_wind_slender")
    fs, fh = model.fowtList[0], model.hydro[0]
    beta = float(np.deg2rad(SLENDER_BETA_DEG))
    rao = np.load(os.path.join(OUT_DIR, "golden_full_semi_wind.npz"))[
        "on_RAO"][SLENDER_RAO_ROW]
    w2, k2 = model.w1_2nd, model.k1_2nd
    i1, i2 = np.triu_indices(len(w2))
    gd = dict(beta=np.float64(beta), w1_2nd=w2, k1_2nd=k2, Xi0=rao,
              fixed_qtf=slender_qtf(model, SLENDER_BETA_DEG),
              rao_qtf=slender_qtf(model, SLENDER_BETA_DEG, Xi0=rao))
    Xi = np.stack([np.interp(w2, model.w, rao[i], left=0, right=0)
                   for i in range(fs.nDOF)])
    F1st = np.asarray(model.statics()["M_struc"]) @ (-(w2 ** 2) * Xi)
    gd.update(Xi=Xi, F1st=F1st, pinkster=pinkster_iv(Xi, F1st)[i1, i2])
    a_i = np.asarray(fh.hc0["a_i"])
    ofs = 0
    for im, mem in enumerate(fs.members):
        mq = np.asarray(member_qtf(mem, a_i[ofs:ofs + mem.ns], Xi, beta, w2,
                                   k2, fs.depth, fs.rho_water, fs.g))
        ofs += mem.ns
        gd[f"member_{im}"] = mq[i1, i2]
        if mem.MCF:
            gd[f"kim_yue_{im}"] = kim_yue_correction(
                mem, beta, w2, k2, fs.depth, fs.rho_water, fs.g)[i1, i2]
    return gd


def write_qtf_12d_fixture():
    """``semi_wind_qtf.12d``: the slender design's fixed-body QTF at
    :data:`QTF_HEADS_DEG`, written by the JAX ``write_qtf_12d``."""
    import numpy as np

    from raft_tpu.physics.secondorder import write_qtf_12d

    model = qtf_model("semi_wind_slender")
    fs = model.fowtList[0]
    qtf = np.concatenate([slender_qtf(model, h) for h in QTF_HEADS_DEG],
                         axis=2)
    write_qtf_12d(os.path.join(OUT_DIR, "semi_wind_qtf.12d"), qtf,
                  model.w1_2nd, np.deg2rad(QTF_HEADS_DEG),
                  rho=fs.rho_water, g=fs.g)


def golden_qtf_rows(name, rows, nWaves, fused, geom=None):
    """JAX full-evaluator outputs of a second-order set over ``rows``
    (with ``geom`` the geometry axis)."""
    jax = _jax()
    import numpy as np

    from raft_tpu.api import make_full_evaluator

    def run():
        ev = make_full_evaluator(qtf_model(name), nWaves=nWaves,
                                 geometry=geom is not None)
        r = dict(rows) if geom is None else dict(rows, geom=geom)
        out = jax.jit(jax.vmap(ev))(r)
        return {k: np.asarray(out[k]) for k in FULL_OUT_KEYS}
    return _with_fused(fused, run)


def build_qtf_golden(name):
    """The ``golden_qtf_<name>.npz`` dict: h1 rows (:data:`QTF_ROWS`), on
    semi_wind_qtf also h2 (:data:`QTF_ROWS2`) and geometry rows
    (``geo``, :func:`geometry_rows`), FUSED on and off."""
    import numpy as np

    runs = [("h1", QTF_ROWS, 1, False)]
    if name == "semi_wind_qtf":
        runs += [("h2", QTF_ROWS2, 2, False), ("geo", QTF_ROWS, 1, True)]
    gd = {}
    for tag, rows, nW, geometry in runs:
        r = {k: np.asarray(v, dtype=float) for k, v in rows.items()}
        gd.update({f"{tag}_{k}": v for k, v in r.items()})
        geom = None
        if geometry:
            geom = geometry_rows(len(qtf_model(name).fowtList[0].members))
            gd.update({f"{tag}_geom_{k}": v for k, v in geom.items()})
        for fused in ("on", "off"):
            out = golden_qtf_rows(name, r, nW, fused, geom)
            gd.update({f"{tag}_{fused}_{k}": v for k, v in out.items()})
        print(f"qtf {name} {tag}: status_on={gd[f'{tag}_on_status'].tolist()}"
              f" n_iter_on={gd[f'{tag}_on_n_iter_drag'].tolist()}",
              flush=True)
    return gd


def write_qtf_fixtures():
    """Write the second-order designs, ``semi_wind_qtf.12d`` and the
    ``golden_qtf_*`` files (about 10 min on 8 cores)."""
    import json
    import shutil
    import tempfile

    import numpy as np

    for name, fn in QTF_DESIGNS.items():
        with open(os.path.join(OUT_DIR, QTF_DESIGN_FILES[name]), "w") as f:
            f.write(json.dumps(fn(), indent=1) + "\n")
    write_qtf_12d_fixture()
    np.savez_compressed(os.path.join(OUT_DIR, "golden_qtf_slender.npz"),
                        **build_slender_golden())
    cache = tempfile.mkdtemp(prefix="bem_cache_")
    os.environ["RAFT_TPU_BEM_DIR"] = cache
    try:
        for name in ("semi_wind_qtf", "semi_wind_bem_coarse_qtf"):
            np.savez_compressed(os.path.join(OUT_DIR, f"golden_{name}.npz"),
                                **build_qtf_golden(name))
    finally:
        shutil.rmtree(cache, ignore_errors=True)


# ------------------------------------------------------ orchestrated path

#: the case-table keys of the orchestrated designs (the demos')
CASE_KEYS = ["wind_speed", "wind_heading", "turbulence", "turbine_status",
             "yaw_misalign", "wave_spectrum", "wave_period", "wave_height",
             "wave_heading", "current_speed", "current_heading"]
#: design_semi_wind_cases.json: two operating cases with yaw and current
#: (a numeric TI, then an IEC class string), an idle case, and a
#: two-heading case whose wind and current repeat the first case's (the
#: aero cache serves it)
SEMI_WIND_CASES = [
    [10.59, 0.0, 0.1, "operating", 5.0, "JONSWAP", 10.0, 4.0, 0.0, 0.6,
     30.0],
    [16.0, 20.0, "IB_NTM", "operating", -6.0, "JONSWAP", 12.0, 6.0, 30.0,
     0.3, 200.0],
    [30.0, 0.0, 0.12, "idle", 0.0, "JONSWAP", 14.0, 9.0, 0.0, 0.0, 0.0],
    [10.59, 0.0, 0.1, "operating", 5.0, ["JONSWAP", "JONSWAP"],
     [10.0, 7.0], [4.0, 2.0], [0.0, 60.0], 0.6, 30.0],
]
#: the farm's two cases (one wind speed for both units; current on one)
FARM_CASES = [
    [10.0, 0.0, 0.1, "operating", 0.0, "JONSWAP", 12.0, 6.0, 0.0, 0.0, 0.0],
    [14.0, 10.0, 0.12, "operating", 3.0, "JONSWAP", 9.0, 3.0, 20.0, 0.5,
     45.0],
]
#: every orchestrated golden set -> its design file
ORCH_DESIGN_FILES = {
    "spar": "design_spar.json", "semi": "design_semi.json",
    "mhk": "design_mhk.json",
    "semi_wind_cases": "design_semi_wind_cases.json",
    "mhk_tidal": "design_mhk_tidal.json",
    "mhk_tidal_cav": "design_mhk_tidal_cav.json",
    "semi_wind_flex": "design_semi_wind_flex.json",
    "farm_semi_wind": "design_farm_semi_wind_cases.json",
    "semi_wind_wamit": "design_semi_wind_wamit.json",
    "semi_wind_qtf": "design_semi_wind_qtf.json",
    "semi_wind_slender": "design_semi_wind_slender.json",
    "semi_wind_moor1": "design_semi_wind_moor1.json",
    "semi_wind_moor2": "design_semi_wind_moor2.json",
}
#: the sets run through run_farm (case metrics only)
ORCH_FARMS = ("farm_semi_wind",)


def semi_wind_cases_design():
    """semi_wind with the 4-case table :data:`SEMI_WIND_CASES`."""
    d = semi_wind_design()
    d["name"] = ("semi_wind_cases - raft_tpu_torch fixture of semi_wind "
                 "with a 4-case table")
    d["cases"] = dict(keys=CASE_KEYS, data=SEMI_WIND_CASES)
    return d


def cpmin_polar(t_rel):
    """:func:`analytic_polar` with a fifth column, a synthetic minimum
    pressure coefficient ``cpmin = -(1 + 0.5 cl^2 + 3 sin^2 a)`` (-3 for
    the cylinder, the potential-flow value at its shoulders)."""
    import numpy as np

    rows = analytic_polar(t_rel)
    out = []
    for aoa, cl, cd, cm in rows:
        a = np.deg2rad(aoa)
        cp = -3.0 if t_rel >= 1.0 else -(1.0 + 0.5 * cl ** 2
                                         + 3.0 * np.sin(a) ** 2)
        out.append([aoa, cl, cd, cm, float(cp)])
    return out


def mhk_tidal_cav_design():
    """mhk_tidal whose airfoil tables carry the cpmin column of
    :func:`cpmin_polar`, for the cavitation margins."""
    d = mhk_tidal_design()
    d["name"] = ("mhk_tidal_cav - raft_tpu_torch fixture of mhk_tidal with "
                 "cpmin polars")
    for af in d["turbine"]["airfoils"]:
        af["data"] = cpmin_polar(af["relative_thickness"])
    return d


def farm_semi_wind_cases_design():
    """design_farm_semi_wind.json with the 2-case table
    :data:`FARM_CASES`."""
    d = farm_semi_wind_design()
    d["name"] = ("farm_semi_wind_cases - raft_tpu_torch fixture of the "
                 "semi_wind farm with a 2-case table")
    d["cases"] = dict(keys=CASE_KEYS, data=FARM_CASES)
    return d


def semi_wind_moor_design(mod):
    """semi_wind's inline mooring with ``moorMod`` ``mod`` (1: lumped-mass
    tensions, 2: also the lumped-mass mooring impedance)."""
    d = semi_wind_design()
    d["name"] = (f"semi_wind_moor{mod} - raft_tpu_torch fixture of semi_wind "
                 f"with moorMod {mod}")
    d["mooring"]["moorMod"] = mod
    return d


#: the designs this part writes: set name -> the function that makes it
ORCH_NEW_DESIGNS = {
    "semi_wind_cases": semi_wind_cases_design,
    "mhk_tidal_cav": mhk_tidal_cav_design,
    "farm_semi_wind": farm_semi_wind_cases_design,
    "semi_wind_moor1": lambda: semi_wind_moor_design(1),
    "semi_wind_moor2": lambda: semi_wind_moor_design(2),
}


def orch_model(name, qtf_dir=None):
    """The JAX Model of an orchestrated set, from its fixture file (so
    data paths resolve against the fixtures); ``qtf_dir`` sets the
    slender design's ``outFolderQTF``."""
    import json

    _jax()
    import raft_tpu

    with open(os.path.join(OUT_DIR, ORCH_DESIGN_FILES[name])) as f:
        d = json.load(f)
    if qtf_dir is not None:
        d["platform"]["outFolderQTF"] = qtf_dir
    return raft_tpu.Model(d, base_dir=OUT_DIR)


class _CaseMetrics(dict):
    """A case's channel dict that also answers the telemetry calls."""

    class _Noop:
        def inc(self, *a, **k):
            pass

        observe = inc

    def counter(self, name):
        return self._Noop()

    histogram = counter


class _metrics_shadow_guard:
    """The JAX ``Model.analyze_cases`` binds each case's channel dict to
    the local name of its telemetry module (``metrics``), so from the
    second case on its ``metrics.counter(...)`` calls land on that dict
    and raise.  While this guard is open its ``turbine_outputs`` returns
    a dict that answers them (doing nothing), so a multi-case table runs
    through the unchanged JAX code."""

    def __enter__(self):
        from raft_tpu.models import outputs

        self._orig = outputs.turbine_outputs
        orig = self._orig
        outputs.turbine_outputs = lambda *a, **k: _CaseMetrics(orig(*a, **k))
        return self

    def __exit__(self, *exc):
        from raft_tpu.models import outputs

        outputs.turbine_outputs = self._orig
        return False


def build_orch_golden(name):
    """The ``golden_orch_<name>.npz`` dict: the JAX ``analyze_cases`` of
    the set's design (a farm: ``run_farm``'s scope, case metrics only;
    else also ``calc_outputs``), float64 on the CPU:

    * ``m<case>_<fowt>_<key>``: every ``case_metrics`` key;
    * ``mean_offsets`` (nCase, nDOF), ``statics_status`` (nCase,) of each
      case's first equilibrium, and per case and FOWT the drag
      linearisation's ``dyn_status``, ``n_iter_drag``,
      ``drag_converged``, ``drag_resid``;
    * ``prop_<name>`` for every property, ``eig_frequencies`` and
      ``eig_modes`` (not for a farm);
    * ``csv``: the text ``save_responses`` writes; ``modes_json``: the
      text of ``write_modes_json`` (not for a farm);
    * for the slender design, ``ckpt_<file>``: the text of each ``.4``
      and ``.12d`` checkpoint written to ``outFolderQTF``."""
    import shutil
    import tempfile

    import numpy as np

    from raft_tpu.drivers import save_responses

    tmp = tempfile.mkdtemp(prefix="orch_")
    try:
        qdir = (os.path.join(tmp, "qtf") if name == "semi_wind_slender"
                else None)
        model = orch_model(name, qtf_dir=qdir)
        status, diags = [], []
        solve_statics, solve_dynamics = model.solve_statics, \
            model.solve_dynamics

        def statics(case=None, extra_force=None):
            X = solve_statics(case, extra_force=extra_force)
            if case is not None and extra_force is None:
                status.append(model.statics_status)
            return X

        def dynamics(case, X0=None):
            Xi, info = solve_dynamics(case, X0=X0)
            diags.append([inf["dyn_diag"] for inf in info["infos"]])
            return Xi, info

        model.solve_statics, model.solve_dynamics = statics, dynamics
        with _metrics_shadow_guard():
            res = model.analyze_cases()
        gd = {}
        for ic, per in res["case_metrics"].items():
            for i, met in per.items():
                for k, v in met.items():
                    gd[f"m{ic}_{i}_{k}"] = np.asarray(v)
        gd["mean_offsets"] = np.stack([np.asarray(x)
                                       for x in res["mean_offsets"]])
        gd["statics_status"] = np.asarray(status, dtype=np.int32)
        for k, dt in (("status", np.int32), ("n_iter_drag", np.int32),
                      ("drag_converged", bool), ("drag_resid", float)):
            gd["dyn_status" if k == "status" else k] = np.asarray(
                [[np.asarray(dd[k]).astype(dt) for dd in per]
                 for per in diags])
        csv = os.path.join(tmp, "out.csv")
        save_responses(model, csv)
        with open(csv) as f:
            gd["csv"] = np.asarray(f.read())
        if name not in ORCH_FARMS:
            model.calc_outputs()
            for k, v in model.results["properties"].items():
                gd[f"prop_{k}"] = np.asarray(v)
            gd["eig_frequencies"] = np.asarray(
                model.results["eigen"]["frequencies"])
            gd["eig_modes"] = np.asarray(model.results["eigen"]["modes"])
            mj = os.path.join(tmp, "modes.json")
            model.write_modes_json(mj)
            with open(mj) as f:
                gd["modes_json"] = np.asarray(f.read())
        if qdir is not None:
            for fn in sorted(os.listdir(qdir)):
                with open(os.path.join(qdir, fn)) as f:
                    gd[f"ckpt_{fn}"] = np.asarray(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"orch {name}: statics_status={gd['statics_status'].tolist()} "
          f"n_iter_drag={gd['n_iter_drag'].tolist()}", flush=True)
    return gd


def write_orch_fixtures(names=None):
    """Write the orchestrated designs (:data:`ORCH_NEW_DESIGNS`) and the
    ``golden_orch_*`` files (about 10 min on 8 cores)."""
    import json

    import numpy as np

    for name, fn in ORCH_NEW_DESIGNS.items():
        with open(os.path.join(OUT_DIR, ORCH_DESIGN_FILES[name]), "w") as f:
            f.write(json.dumps(fn(), indent=1) + "\n")
    for name in names or ORCH_DESIGN_FILES:
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_orch_{name}.npz"),
                            **build_orch_golden(name))


#: adjust_ballast's arguments on the spar (golden_drivers.npz)
BALLAST_ARGS = dict(target_heave=-1.0, heave_tol=0.05)
#: the wake coupling's power/thrust grid, the farm case and iterations
#: of its equilibrium, and calc_aep's wind states (below cut-in, waked
#: at 30 deg, above cut-out) and iterations
WAKE_GRID = [4.0, 8.0, 10.59, 14.0, 20.0]
WAKE_CASE = 0
WAKE_EQ_ITER = 3
AEP_STATES = dict(windspeeds=[2.0, 9.0, 26.0], winddirs=[0.0, 30.0, 0.0],
                  probabilities=[0.2, 0.5, 0.3])
AEP_ITER = 2


def build_drivers_golden():
    """The ``golden_drivers.npz`` dict, from the JAX package on the CPU:

    * ``bal_scale``, ``bal_l_fill_<member>`` and ``bal_X0``: the JAX
      ``adjust_ballast`` of the spar at :data:`BALLAST_ARGS`, its fill
      lengths and the rebuilt design's unloaded equilibrium;
    * ``wake_Ct_<fowt>``, ``wake_power_<fowt>``: the JAX
      ``WakeCoupling`` curves of the two-unit farm on :data:`WAKE_GRID`;
      ``eq_winds``, ``eq_xs``, ``eq_ys``, ``eq_powers``: its
      ``find_equilibrium`` histories on the farm's case
      :data:`WAKE_CASE` over :data:`WAKE_EQ_ITER` iterations;
      ``aep_powers``, ``aep_states``, ``aep_total``: its ``calc_aep`` over
      :data:`AEP_STATES` at :data:`AEP_ITER` iterations a state."""
    import json

    import numpy as np

    _jax()
    import raft_tpu
    from raft_tpu.drivers import adjust_ballast
    from raft_tpu.physics.wake import WakeCoupling

    gd = {}
    with open(os.path.join(OUT_DIR, "design_spar.json")) as f:
        spar = json.load(f)
    model, scale = adjust_ballast(spar, **BALLAST_ARGS)
    gd["bal_scale"] = np.asarray(scale)
    for i, mi in enumerate(model.design["platform"]["members"]):
        if "l_fill" in mi:
            gd[f"bal_l_fill_{i}"] = np.asarray(mi["l_fill"], dtype=float)
    gd["bal_X0"] = np.asarray(model.solve_statics(None))

    farm = raft_tpu.Model(os.path.join(OUT_DIR,
                                       ORCH_DESIGN_FILES["farm_semi_wind"]))
    wc = WakeCoupling(farm, u_grid=np.asarray(WAKE_GRID))
    for i, c in enumerate(wc.curves):
        gd[f"wake_Ct_{i}"] = np.asarray(c["Ct"])
        gd[f"wake_power_{i}"] = np.asarray(c["power"])
    keys = farm.design["cases"]["keys"]
    case = dict(zip(keys, farm.design["cases"]["data"][WAKE_CASE]))
    for k, v in zip(("eq_winds", "eq_xs", "eq_ys", "eq_powers"),
                    wc.find_equilibrium(case, n_iter=WAKE_EQ_ITER)):
        gd[k] = np.asarray(v)
    powers, per_state, total = wc.calc_aep(**AEP_STATES, n_iter=AEP_ITER)
    gd["aep_powers"] = np.asarray(powers)
    gd["aep_states"] = np.asarray(per_state)
    gd["aep_total"] = np.asarray(total)
    print(f"drivers: ballast scale {scale!r}, AEP {total!r} Wh", flush=True)
    return gd


def write_drivers_fixtures():
    """Write ``golden_drivers.npz`` (about 3 min)."""
    import numpy as np

    np.savez_compressed(os.path.join(OUT_DIR, "golden_drivers.npz"),
                        **build_drivers_golden())


# ------------------------------------------------ design-optimisation

#: the DesignEvaluation golden sets: set name -> (design file,
#: use_traced, whether the override call runs)
OMDAO_SETS = {
    "spar": ("design_spar.json", True, True),
    "semi_wind": ("design_semi_wind.json", True, False),
    "semi_wind_moor1": ("design_semi_wind_moor1.json", True, False),
    "semi_wind_wamit": ("design_semi_wind_wamit.json", True, False),
    "semi_wind_cases": ("design_semi_wind_cases.json", True, False),
    "semi_wind_flex": ("design_semi_wind_flex.json", True, False),
    "farm_semi_wind_cases": ("design_farm_semi_wind_cases.json", True,
                             False),
    "spar_host": ("design_spar.json", False, False),
}
#: the override of the ``spar`` set's third call (it takes the host route)
OMDAO_OVERRIDE = {"mooring.lines.0.length": 920.0}
#: the WEIS flat-input sets: weis_semi_wind is analysed, weis_branches
#: only rebuilt
WEIS_SETS = ("weis_semi_wind", "weis_branches")
#: weis_semi_wind's case table: two spectral-wind cases (an IEC NTM and
#: an ETM class) and a numeric-TI case that the case filter drops
WEIS_DLCS = [
    [10.59, 0.0, "IB_NTM", "operating", 0.0, "JONSWAP", 10.0, 4.0, 0.0,
     0.5, 0.0],
    [9.0, 0.0, 0.12, "operating", 0.0, "JONSWAP", 8.0, 2.0, 0.0, 0.0, 0.0],
    [14.0, 10.0, "IB_ETM", "operating", 4.0, "JONSWAP", 12.0, 6.0, 30.0,
     0.3, 200.0],
]
#: seeds of the wave / drag helpers' inputs and of the plotting rows
HELPER_SEED = 20261030
#: the sets whose geometry the plotting goldens hold
PLOT_SETS = ("spar", "semi_wind")


def _route_of(ev):
    """The route a JAX DesignEvaluation took: its evaluator's kind, or
    "host" where it built none."""
    model, evaluate = ev._fast
    if evaluate is None:
        return "host"
    if model.nFOWT > 1:
        return "farm"
    return "full" if model.fowtList[0].is_single_body else "flexible"


def _flat_outputs(gd, tag, out):
    """A compute() result into the golden dict: each value under
    ``<tag>__<key>`` and its Python type (float or ndarray) under
    ``types__<tag>``."""
    import json

    import numpy as np

    types = {}
    for k, v in out.items():
        types[k] = "float" if isinstance(v, float) else type(v).__name__
        gd[f"{tag}__{k}"] = np.asarray(v)
    gd[f"types__{tag}"] = np.asarray(json.dumps(types))


def build_omdao_golden(name):
    """The ``golden_omdao_<name>.npz`` dict: the JAX DesignEvaluation of
    a set (its design read from the fixtures, run with the fixtures as
    the working directory so its data paths resolve), float64 on the
    CPU:

    * ``route``: the route it took;
    * ``first__<key>`` / ``repeat__<key>``: the outputs of compute() and
      of a repeat compute(), ``types__<tag>`` their types; for ``spar``
      also ``override__<key>`` (:data:`OMDAO_OVERRIDE`);
    * ``diag__<tag>``: ``ev.diag`` after each call, as JSON;
    * ``design_fp``: ``content_fingerprint`` of the design;
      ``row<i>__<key>``: ``case_to_traced`` of each case;
      ``cache_key<i>``: its ``result_cache_key`` (a row per wave heading
      of the case)."""
    import json

    import numpy as np

    _jax()
    from raft_tpu.aot.bank import content_fingerprint
    from raft_tpu.api import case_to_traced
    from raft_tpu.omdao import DesignEvaluation
    from raft_tpu.serve.cache import result_cache_key

    fn, traced, override = OMDAO_SETS[name]
    with open(os.path.join(OUT_DIR, fn)) as f:
        base = json.load(f)
    cwd = os.getcwd()
    os.chdir(OUT_DIR)
    gd = {}
    try:
        ev = DesignEvaluation(base, use_traced=traced)
        calls = [("first", None), ("repeat", None)]
        if override:
            calls.append(("override", OMDAO_OVERRIDE))
        with _metrics_shadow_guard():
            for tag, ov in calls:
                _flat_outputs(gd, tag, ev.compute(ov))
                gd[f"diag__{tag}"] = np.asarray(json.dumps(ev.diag))
        gd["route"] = np.asarray(_route_of(ev))
        model = ev._fast[0]
    finally:
        os.chdir(cwd)
    fp = content_fingerprint(base)
    gd["design_fp"] = np.asarray(fp)
    for i, case in enumerate(model.cases):
        row = case_to_traced(case, nWaves=np.size(case.get("wave_heading",
                                                           0.0)))
        for k, v in row.items():
            gd[f"row{i}__{k}"] = np.asarray(v)
        gd[f"cache_key{i}"] = np.asarray(result_cache_key(
            fp, row, DesignEvaluation._CACHE_KEYS))
    print(f"omdao {name}: route {gd['route']}, "
          f"diag {json.loads(str(gd['diag__repeat']))}", flush=True)
    return gd


def _member_flat(i, m, ext=(0.0, 0.0), per_station=False, rings=None,
                 caps=None):
    """(inputs, member options) of WEIS platform member ``i`` from a
    design member ``m``: its axis extended by ghost segments of ``ext``
    metres at each end (so ``build_design`` trims them again), its
    diameter, thickness and coefficients scalar or, with
    ``per_station``, tapered per station, ring stiffeners ``rings``
    (spacing, t, h, in station units) and bulkheads ``caps`` (stations,
    t)."""
    import numpy as np

    mn = f"platform_member{i + 1}_"
    rA, rB = np.asarray(m["rA"], float), np.asarray(m["rB"], float)
    L = float(np.linalg.norm(rB - rA))
    q = (rB - rA) / L
    L0 = L + ext[0] + ext[1]
    sA, sB = ext[0] / L0, (ext[0] + L) / L0
    st = np.asarray(m["stations"], float)
    s_in = sA + (st - st[0]) / (st[-1] - st[0]) * (sB - sA)
    s0 = np.unique(np.r_[0.0, s_in, 1.0])
    rect = m["shape"] == "rect"
    taper = 1.0 + 0.05 * (s0 - 0.5) if per_station else np.ones_like(s0)
    d = np.asarray(m["d"], float)
    if per_station:
        dd = np.broadcast_to(d.reshape(-1)[:2] if rect else d.reshape(-1)[0],
                             (len(s0), 2) if rect else (len(s0),))
        d_in = dd * (taper[:, None] if rect else taper)
        t_in = float(np.atleast_1d(m["t"])[0]) * taper

        def coef(c):
            c = np.atleast_1d(np.asarray(c, float))
            if rect:
                return np.stack([np.full(len(s0), c[0]),
                                 np.full(len(s0), c[-1])], axis=1) \
                    * taper[:, None]
            return np.full(len(s0), c[0]) * taper
    else:
        d_in = d.reshape(-1)[:2] if rect else d.reshape(-1)[:1]
        t_in = np.atleast_1d(float(np.atleast_1d(m["t"])[0]))

        def coef(c):
            c = np.atleast_1d(np.asarray(c, float))
            return np.r_[c[0], c[-1]] if rect else c[:1]
    inputs = {
        mn + "rA": rA - ext[0] * q, mn + "rB": rB + ext[1] * q,
        mn + "s_ghostA": [sA], mn + "s_ghostB": [sB], mn + "stations": s0,
        mn + "gamma": [0.0], mn + "rho_shell": [float(m["rho_shell"])],
        mn + "d": d_in, mn + "t": t_in,
    }
    for c in ("Cd", "Ca"):
        inputs[mn + c] = coef(m[c])
    for c in ("CdEnd", "CaEnd"):
        cv = np.atleast_1d(np.asarray(m[c], float))[:1]
        inputs[mn + c] = (np.full(len(s0), cv[0]) * taper if per_station
                          else cv)
    heading = m.get("heading")
    if heading is not None:
        inputs[mn + "heading"] = np.atleast_1d(np.asarray(heading, float))
    if "l_fill" in m:
        # fill lengths in the station units: WEIS's run over the whole
        # (ghost-extended) axis, 0 to 1
        inputs[mn + "l_fill"] = (np.atleast_1d(np.asarray(m["l_fill"], float))
                                 * L / (st[-1] - st[0]) / L0)
        inputs[mn + "rho_fill"] = np.atleast_1d(
            np.asarray(m["rho_fill"], float))
    if rings is not None:
        inputs[mn + "ring_spacing"] = [rings[0]]
        inputs[mn + "ring_t"] = [rings[1]]
        inputs[mn + "ring_h"] = [rings[2]]
    if caps is not None or rings is not None:
        cs, ct = caps if caps is not None else ([0.0], [0.1])
        inputs[mn + "cap_stations"] = np.asarray(cs, float)
        inputs[mn + "cap_t"] = np.asarray(ct, float)
    opts = dict(
        shape=m["shape"], scalar_d=not per_station, scalar_t=not per_station,
        scalar_c=not per_station, potMod=bool(m.get("potMod", False)),
        nreps=0 if heading is None else len(np.atleast_1d(heading)),
        npts_lfill=len(np.atleast_1d(m["l_fill"])) if "l_fill" in m else 0,
        ncaps=0 if caps is None else len(caps[0]))
    return inputs, opts


def weis_flat(design, members, dlcs, rigid_bodies=(), bem_dir=None,
              orientation="upwind", tower_scalar=False, rated=None,
              n_blades=None):
    """WEIS's option dicts and flat inputs (``RAFT_OMDAO_Core``'s
    arguments) that ``build_design`` turns back into a design: the site,
    turbine, tower, blade, airfoils, controls, power curve and mooring of
    ``design``, the platform members given as :func:`_member_flat`
    argument tuples, the case table ``dlcs`` (``CASE_KEYS``), rigid
    bodies (node, mass, inertia), ``potential_model_override`` 3 with
    ``bem_dir``, the rotor ``orientation``, the tower scalar
    (``tower_scalar``) or per station, ``rated_rotor_speed`` and
    ``n_blades`` as a discrete input.  Arrays as lists (JSON)."""
    import numpy as np

    t = design["turbine"]
    sgn = -1.0 if orientation == "upwind" else 1.0
    site = design["site"]
    inputs = {
        "rho_air": [float(site["rho_air"])],
        "rho_water": [float(site["rho_water"])],
        "mu_air": [float(site["mu_air"])],
        "shear_exp": [float(site["shearExp"])],
        "mooring_water_depth": [float(site["water_depth"])],
        "turbine_mRNA": [float(t["mRNA"])],
        "turbine_IxRNA": [float(t["IxRNA"])],
        "turbine_IrRNA": [float(t["IrRNA"])],
        "turbine_xCG_RNA": [float(t["xCG_RNA"])],
        "turbine_hHub": [float(t["hHub"])],
        "turbine_overhang": [float(t["overhang"]) * sgn],
        "turbine_Fthrust": [0.0],
        "turbine_yaw_stiffness": [0.0],
        "gear_ratio": [float(t["gear_ratio"])],
        "tilt": [float(t["shaft_tilt"]) * sgn],
        "precone": [float(t["precone"]) * sgn],
        "wind_reference_height": [float(t["Zhub"])],
        "hub_radius": [float(t["Rhub"])],
        "rotor_inertia": [float(t["I_drivetrain"])],
        "rotor_orientation": orientation,
    }
    tow = t["tower"]
    inputs.update({
        "turbine_tower_rA": tow["rA"], "turbine_tower_rB": tow["rB"],
        "turbine_tower_gamma": [0.0],
        "turbine_tower_stations": tow["stations"],
        "turbine_tower_rho_shell": [float(tow["rho_shell"])]})
    n_st = len(tow["stations"])
    for key in ("d", "t"):
        v = np.atleast_1d(np.asarray(tow[key], float))
        inputs[f"turbine_tower_{key}"] = (
            [float(v[0])] if tower_scalar else np.resize(v, n_st))
    for key in ("Cd", "Ca", "CdEnd", "CaEnd"):
        v = float(np.atleast_1d(tow[key])[0])
        inputs[f"turbine_tower_{key}"] = (
            [v] * n_st if tower_scalar else [v])
    geo = np.asarray(t["blade"]["geometry"], float)
    for j, key in enumerate(("r", "chord", "theta", "precurve",
                             "presweep")):
        inputs[f"blade_{key}"] = geo[:, j]
    for key in ("Rtip", "precurveTip", "presweepTip"):
        inputs[f"blade_{key}"] = [float(t["blade"][key])]
    afs = {a["name"]: a for a in t["airfoils"]}
    used = [nm for _, nm in t["blade"]["airfoils"]]
    inputs["airfoils_position"] = [float(p) for p, _ in
                                   t["blade"]["airfoils"]]
    tab = [np.asarray(afs[nm]["data"], float) for nm in used]
    inputs["airfoils_aoa"] = tab[0][:, 0]
    for j, key in ((1, "cl"), (2, "cd"), (3, "cm")):
        # (n_af, n_aoa, n_Re = 1), as WEIS hands them
        inputs[f"airfoils_{key}"] = np.stack([a[:, j] for a in tab])[..., None]
    inputs["airfoils_r_thick"] = [float(afs[nm]["relative_thickness"])
                                  for nm in used]
    pc, tc, ops = t["pitch_control"], t["torque_control"], t["wt_ops"]
    inputs.update({
        "rotor_PC_GS_angles": pc["GS_Angles"], "rotor_PC_GS_Kp": pc["GS_Kp"],
        "rotor_PC_GS_Ki": pc["GS_Ki"], "Fl_Kp": [float(pc["Fl_Kp"])],
        "rotor_TC_VS_Kp": [float(tc["VS_KP"])],
        "rotor_TC_VS_Ki": [float(tc["VS_KI"])],
        "rotor_powercurve_v": ops["v"],
        "rotor_powercurve_omega_rpm": ops["omega_op"],
        "rotor_powercurve_pitch": ops["pitch_op"]})
    if rated is not None:
        inputs["rated_rotor_speed"] = [rated]

    member_opt = {"nmembers": len(members), "shape": [],
                  "scalar_diameters": [], "scalar_thicknesses": [],
                  "scalar_coefficients": [], "nreps": [], "npts_lfill": [],
                  "ncaps": []}
    for i, args in enumerate(members):
        m_in, o = _member_flat(i, *args[:1], **args[1])
        inputs.update(m_in)
        member_opt["shape"].append(o["shape"])
        member_opt["scalar_diameters"].append(o["scalar_d"])
        member_opt["scalar_thicknesses"].append(o["scalar_t"])
        member_opt["scalar_coefficients"].append(o["scalar_c"])
        member_opt[f"platform_member{i + 1}_potMod"] = o["potMod"]
        for k in ("nreps", "npts_lfill", "ncaps"):
            member_opt[k].append(o[k])

    mo = design["mooring"]
    mooring_opt = {"nconnections": len(mo["points"]),
                   "nlines": len(mo["lines"]),
                   "nline_types": len(mo["line_types"])}
    for i, pt in enumerate(mo["points"]):
        pn = f"mooring_point{i + 1}_"
        mooring_opt[pn + "name"] = pt["name"]
        mooring_opt[pn + "type"] = pt["type"]
        inputs[pn + "location"] = pt["location"]
    for i, ln in enumerate(mo["lines"]):
        lp = f"mooring_line{i + 1}_"
        for k in ("endA", "endB", "type"):
            mooring_opt[lp + k] = ln[k]
        inputs[lp + "length"] = [float(ln["length"])]
    for i, lt in enumerate(mo["line_types"]):
        tp = f"mooring_line_type{i + 1}_"
        mooring_opt[tp + "name"] = lt["name"]
        extra = dict(breaking_load=2.0e7, cost=0.0,
                     transverse_added_mass=1.0, tangential_added_mass=0.0,
                     transverse_drag=1.6, tangential_drag=0.1)
        for k in ("diameter", "mass_density", "stiffness", *extra):
            inputs[tp + k] = [float(lt.get(k, extra.get(k)))]

    modeling = {
        "xi_start": float(design["settings"].get("XiStart", 0.1)),
        "min_freq": float(design["settings"]["min_freq"]),
        "max_freq": float(design["settings"]["max_freq"]),
        "nIter": int(design["settings"].get("nIter", 15)),
        "potential_model_override": 0 if bem_dir is None else 3,
        "dls_max": 5.0,
        "raft_dlcs_keys": CASE_KEYS,
        "raft_dlcs": dlcs,
        "floating": {"rigid_bodies": {"n_bodies": len(rigid_bodies)}},
    }
    if bem_dir is not None:
        modeling["BEM_dir"] = bem_dir
    for k, (node, mass, inertia) in enumerate(rigid_bodies):
        inputs[f"rigid_body_{k}_node"] = node
        inputs[f"rigid_body_{k}_mass"] = [mass]
        inputs[f"rigid_body_{k}_inertia"] = inertia
    turbine_opt = {"shape": tow["shape"], "scalar_diameters": tower_scalar,
                   "scalar_thicknesses": tower_scalar,
                   "scalar_coefficients": not tower_scalar,
                   "af_used_names": used, "n_af": len(used)}
    discrete = {} if n_blades is None else {"nBlades": n_blades}
    return _jsonable(dict(
        modeling_options=modeling,
        analysis_options={"general": {"fname_output": design["name"]}},
        turbine_options=turbine_opt, mooring_options=mooring_opt,
        member_options=member_opt, inputs=inputs,
        discrete_inputs=discrete))


def _jsonable(o):
    """numpy arrays and scalars inside ``o`` as lists and Python
    numbers."""
    import numpy as np

    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    return o


def weis_semi_wind_set():
    """semi_wind's WEIS flat inputs: the main column carried on 6 m of
    ghost segment below its keel (trimmed again), the offset columns
    tapered per station (d, t and coefficients), the base columns with
    ring stiffeners every quarter of their height and end bulkheads,
    ``rated_rotor_speed`` 7.56 rpm, and :data:`WEIS_DLCS`."""
    d = semi_wind_design()
    d["name"] = "weis_semi_wind"
    main, offset, base = d["platform"]["members"]
    members = [(main, dict(ext=(6.0, 0.0))),
               (offset, dict(per_station=True)),
               (base, dict(rings=(0.25, 0.02, 0.5), caps=([0.0], [0.1])))]
    return weis_flat(d, members, WEIS_DLCS, rated=7.56)


def weis_branches_set():
    """A build-only WEIS input set over ``build_design``'s other
    branches: a rect pontoon with scalar sides and coefficients; a rect
    brace on ghost segments at both ends, tapered per station, with ring
    stiffeners and bulkheads; a circular column on ghost segments at both
    ends, tapered, with bulkheads; two rigid bodies;
    ``potential_model_override`` 3; a downwind two-bladed rotor; the
    tower scalar with per-station coefficients."""
    d = semi_wind_design()
    d["name"] = "weis_branches"
    common = dict(rho_shell=7850, Cd=[0.8, 0.9], Ca=[1.0, 0.7], CdEnd=0.6,
                  CaEnd=0.6)
    pontoon = dict(common, shape="rect", rA=[5.0, 0.0, -17.0],
                   rB=[45.0, 0.0, -17.0], stations=[0, 1], d=[12.0, 7.0],
                   t=0.04, potMod=True)
    brace = dict(common, shape="rect", rA=[0.0, 5.0, -10.0],
                 rB=[0.0, 45.0, 10.0], stations=[0.0, 0.5, 1.0],
                 d=[[3.0, 2.0]] * 3, t=0.02)
    column = dict(common, shape="circ", rA=[-40.0, 0.0, -20.0],
                  rB=[-40.0, 0.0, 12.0], stations=[-20.0, -5.0, 12.0],
                  d=9.0, t=0.03, Cd=0.8, Ca=1.0)
    members = [(pontoon, {}),
               (brace, dict(ext=(2.0, 3.0), per_station=True,
                            rings=(0.2, 0.015, 0.3),
                            caps=([0.05, 0.5, 0.97], [0.05, 0.06, 0.07]))),
               (column, dict(ext=(1.5, 2.5), per_station=True,
                             caps=([0.0, 0.3, 1.0], [0.1, 0.08, 0.1])))]
    bodies = (([10.0, 0.0, -15.0], 2.0e5, [1.0e6, 1.1e6, 9.0e5]),
              ([-10.0, 5.0, -12.0], 5.0e4, [2.0e5, 2.0e5, 1.0e5]))
    return weis_flat(d, members, WEIS_DLCS, rigid_bodies=bodies,
                     bem_dir="weis_bem", orientation="downwind",
                     tower_scalar=True, n_blades=2)


WEIS_WRITERS = {"weis_semi_wind": weis_semi_wind_set,
                "weis_branches": weis_branches_set}


def design_to_json(o):
    """A nested design dict as plain JSON data that keeps every type:
    an array as ``{"__array__": list, "dtype": str, "shape": list}``, a
    tuple as ``{"__tuple__": list}``; Python floats, ints, bools, strings
    and None as themselves.  Equal output means an exactly equal design
    (keys, Python types, array dtypes, shapes and values)."""
    import numpy as np

    if isinstance(o, dict):
        return {str(k): design_to_json(v) for k, v in o.items()}
    if isinstance(o, list):
        return [design_to_json(v) for v in o]
    if isinstance(o, tuple):
        return {"__tuple__": [design_to_json(v) for v in o]}
    if isinstance(o, np.ndarray):
        return {"__array__": o.tolist(), "dtype": str(o.dtype),
                "shape": list(o.shape)}
    if isinstance(o, np.generic):
        return {"__scalar__": o.item(), "dtype": str(o.dtype)}
    return o


def build_weis_golden(name):
    """``golden_omdao_<name>.npz``: the JAX ``RAFT_OMDAO_Core`` on the
    set's flat inputs (``weis_<name>.json``): ``design`` (the
    ``build_design`` output through :func:`design_to_json`, as JSON),
    ``case_mask`` and, for weis_semi_wind, the outputs of ``compute``
    (``out__<key>``, ``types__out``)."""
    import json

    import numpy as np

    _jax()
    from raft_tpu.omdao import RAFT_OMDAO_Core

    with open(os.path.join(OUT_DIR, f"{name}.json")) as f:
        s = json.load(f)
    core = RAFT_OMDAO_Core(s["modeling_options"], s["analysis_options"],
                           s["turbine_options"], s["mooring_options"],
                           s["member_options"])
    design = core.build_design(s["inputs"], s["discrete_inputs"])
    gd = {"design": np.asarray(json.dumps(design_to_json(design))),
          "case_mask": np.asarray(core.case_mask)}
    if name == "weis_semi_wind":
        with _metrics_shadow_guard():
            _flat_outputs(gd, "out", core.compute(s["inputs"],
                                                  s["discrete_inputs"]))
    print(f"omdao {name}: case_mask {core.case_mask}", flush=True)
    return gd


def build_helpers_golden():
    """``golden_omdao_helpers.npz``: seeded inputs and the JAX outputs
    of ``get_kinematics`` (``kin_*``), ``get_rms`` and ``get_psd`` (over
    every axis and summed over the first), and the spar demo's
    ``hydro_linearization`` at its zero pose for its first case's wave
    velocities (``lin_u``) and a seeded response (``lin_Xi``)."""
    import json

    import jax.numpy as jnp
    import numpy as np

    _jax()
    import raft_tpu
    from raft_tpu.ops import waves as jwv

    rng = np.random.default_rng(HELPER_SEED)
    nw = 40
    gd = {}
    r = rng.normal(size=(4, 3)) * 20.0
    Xi = (rng.normal(size=(4, 6, nw)) + 1j * rng.normal(size=(4, 6, nw)))
    w = np.linspace(0.05, 2.0, nw)
    gd.update(kin_r=r, kin_Xi=Xi, kin_w=w)
    for k, v in zip(("dr", "v", "a"), jwv.get_kinematics(
            jnp.asarray(r), jnp.asarray(Xi), jnp.asarray(w))):
        gd[f"kin_{k}"] = np.asarray(v)
    xi = rng.normal(size=(3, 6, nw)) + 1j * rng.normal(size=(3, 6, nw))
    gd["psd_xi"] = xi
    gd["psd_dw"] = np.asarray(0.05)
    gd["rms"] = np.asarray(jwv.get_rms(jnp.asarray(xi)))
    gd["psd"] = np.asarray(jwv.get_psd(jnp.asarray(xi), 0.05))
    gd["psd_sum0"] = np.asarray(jwv.get_psd(jnp.asarray(xi), 0.05, axis=0))

    with open(os.path.join(OUT_DIR, "design_spar.json")) as f:
        model = raft_tpu.Model(json.load(f))
    fh = model.hydro[0]
    fh.hydro_excitation(model.cases[0])
    XiL = (rng.normal(size=(6, model.nw))
           + 1j * rng.normal(size=(6, model.nw))) * 0.5
    out = fh.hydro_linearization(XiL)
    gd["lin_u"] = np.asarray(fh.u[0])
    gd["lin_Xi"] = XiL
    for k in ("B_hydro_drag", "Bmat", "F_hydro_drag"):
        gd[f"lin_{k}"] = np.asarray(out[k])
    return gd


def build_plotting_golden():
    """``golden_omdao_plotting.npz``: the JAX plotting geometry of
    :data:`PLOT_SETS` and of the two-unit farm: ``<set>_poly<m>_<k>``,
    polyline k of member m (the nacelle's left out, as the renderers
    do); ``<set>_line<l>``, the catenary points of each mooring line;
    ``farm_net<l>``, the farm's network line profiles at its units'
    array positions; ``counts``: the lines each plot function draws
    (Agg backend) on each set, ``plot_responses`` and
    ``plot_responses_extended`` after the spar's ``analyze_cases``, as
    JSON."""
    import json

    import jax.numpy as jnp
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    _jax()
    import raft_tpu
    from raft_tpu import plotting

    gd, counts = {}, {}
    models = {}
    for name in PLOT_SETS + ("farm_semi_wind",):
        fn = ORCH_DESIGN_FILES.get(name, f"design_{name}.json")
        with open(os.path.join(OUT_DIR, fn)) as f:
            models[name] = raft_tpu.Model(json.load(f), base_dir=OUT_DIR)
    for name in PLOT_SETS:
        model = models[name]
        fs = model.fowtList[0]
        off = np.array([fs.x_ref, fs.y_ref, 0.0])
        for im, mem in enumerate(fs.members):
            if mem.part_of == "nacelle":
                continue
            for k, pts in enumerate(plotting._member_polylines(mem, off)):
                gd[f"{name}_poly{im}_{k}"] = pts
        ms = model.ms_list[0]
        for il in range(ms.n_lines):
            gd[f"{name}_line{il}"] = plotting._catenary_points(
                ms.r_anchor[il], off + ms.r_fair0[il], ms.L[il], ms.w[il],
                ms.EA[il])
    farm = models["farm_semi_wind"]
    net = farm.ms_array
    r6 = np.stack([[f.x_ref, f.y_ref, 0, 0, 0, 0] for f in farm.fowtList])
    _, info = net.body_forces(jnp.asarray(r6, dtype=float))
    pos = np.asarray(net._point_positions(jnp.asarray(r6, dtype=float),
                                          info["r_free"]))
    for il, ((a, b), L, w_l, EA) in enumerate(zip(net.l_ends, net.l_L,
                                                  net.l_w, net.l_EA)):
        gd[f"farm_net{il}"] = plotting._catenary_points(pos[a], pos[b], L,
                                                        w_l, EA)
    for name, model in models.items():
        ax = plotting.plot_system(model)
        fig, ax2 = plotting.plot2d(model)
        counts[name] = dict(plot_system=len(ax.lines),
                            plot2d=len(ax2.lines))
        plt.close("all")
    spar = models["spar"]
    with _metrics_shadow_guard():
        spar.analyze_cases()
    for fn in ("plot_responses", "plot_responses_extended"):
        fig, axs = getattr(plotting, fn)(spar)
        counts["spar"][fn] = [len(a.lines) for a in axs]
        plt.close("all")
    gd["counts"] = np.asarray(json.dumps(counts))
    print(f"omdao plotting: {counts}", flush=True)
    return gd


def write_omdao_fixtures(parts=None):
    """Write the design-optimisation fixtures (about 15 min):
    ``weis_<set>.json`` (:data:`WEIS_WRITERS`) and ``golden_omdao_*.npz``
    of every DesignEvaluation set (:data:`OMDAO_SETS`), the WEIS sets,
    ``helpers`` and ``plotting``; ``parts`` names a subset."""
    import json

    import numpy as np

    names = parts or (list(OMDAO_SETS) + list(WEIS_SETS)
                      + ["helpers", "plotting"])
    for name in names:
        if name in WEIS_SETS:
            with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as f:
                f.write(json.dumps(WEIS_WRITERS[name](), indent=1) + "\n")
            gd = build_weis_golden(name)
        elif name == "helpers":
            gd = build_helpers_golden()
        elif name == "plotting":
            gd = build_plotting_golden()
        else:
            gd = build_omdao_golden(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_omdao_{name}.npz"),
                            **gd)


# ------------------------------------------------------------- sweeps

#: the full-evaluator sets of the checkpointed-sweep goldens
SWEEP_FULL_SETS = ("spar", "semi_wind")
#: rows per checkpoint shard of every sweep golden: smaller than the 8
#: rows (ragged last shard) and odd (each 2-device shard pads one row)
SWEEP_SHARD = 3
#: out_keys of every sweep golden
SWEEP_OUT_KEYS = ("PSD", "X0", "status", "n_iter_drag")
#: the mixed-design sweep: row i is DESIGNS[i % 3] under
#: GOLDEN_CASES[i % 8]
SWEEP_HETERO_ROWS = 10
#: the quarantine golden: the spar with its drag fixed point cut to
#: nIter 2 (a cap of 3 trips, where the golden rows need 3-6), escalated
#: with RAFT_TPU_ESCALATE=retol at ESCALATE_ITER_SCALE 2 (a cap of 5):
#: the rows that need 4-5 trips clear DRAG_CAP_HIT, the two that need 6
#: keep it
QUARANTINE_NITER = 2
QUARANTINE_ITER_SCALE = "2"


def _sweep_mesh2():
    """A 2-device JAX CPU mesh (the process must not have initialised
    JAX before: the device count is an XLA flag)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
    _jax()
    from raft_tpu.parallel.sweep import make_mesh

    mesh = make_mesh(2)
    if mesh.devices.size != 2:
        raise RuntimeError("the sweep goldens need 2 JAX CPU devices: run "
                           "--sweeps in a process of its own")
    return mesh


def _with_env(env, fn):
    """``fn()`` with the environment variables of ``env`` set."""
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def quarantine_design():
    """The spar design of the quarantine golden."""
    d = design_dict("spar")
    d["settings"] = dict(d["settings"], nIter=QUARANTINE_NITER)
    return d


def build_sweep_goldens():
    """``{file name: content}`` of the sweep goldens: the JAX
    checkpointed drivers on a 2-device CPU mesh, the mixed-design
    sweep with its ``bucket_sweep`` event, and the quarantine of an
    escalated sweep."""
    import json
    import tempfile

    import numpy as np

    mesh = _sweep_mesh2()
    import raft_tpu
    from raft_tpu.api import make_case_evaluator, make_full_evaluator
    from raft_tpu.parallel import resilience
    from raft_tpu.parallel.sweep import (run_sweep_checkpointed,
                                         run_sweep_checkpointed_full,
                                         sweep_heterogeneous)
    from raft_tpu.structure import bucketing

    files = {}
    tmp = tempfile.mkdtemp(prefix="sweep_golden_")
    for name in SWEEP_FULL_SETS:
        rows = full_rows(name)
        ev = make_full_evaluator(raft_tpu.Model(full_design(name)),
                                 nWaves=FULL_SETS[name])
        out = run_sweep_checkpointed_full(
            ev, rows, os.path.join(tmp, f"full_{name}"),
            shard_size=SWEEP_SHARD, mesh=mesh, out_keys=SWEEP_OUT_KEYS)
        files[f"golden_sweep_full_{name}.npz"] = dict(
            rows, **{k: np.asarray(v) for k, v in out.items()})

    Hs, Tp, beta = (np.asarray(c, dtype=float) for c in zip(*GOLDEN_CASES))
    ev = make_case_evaluator(raft_tpu.Model(design_dict("spar")))
    out = run_sweep_checkpointed(
        ev, Hs, Tp, beta, os.path.join(tmp, "cases_spar"),
        shard_size=SWEEP_SHARD, mesh=mesh, out_keys=SWEEP_OUT_KEYS)
    files["golden_sweep_cases_spar.npz"] = dict(
        Hs=Hs, Tp=Tp, beta=beta, **{k: np.asarray(v) for k, v in out.items()})

    names = list(DESIGNS)
    models = {n: raft_tpu.Model(design_dict(n)) for n in names}
    idx = np.arange(SWEEP_HETERO_ROWS)
    row_design = [names[i % len(names)] for i in idx]
    sea = [GOLDEN_CASES[i % len(GOLDEN_CASES)] for i in idx]
    hH, hT, hb = (np.asarray(c, dtype=float) for c in zip(*sea))
    log = os.path.join(tmp, "hetero.jsonl")
    out = _with_env({"RAFT_TPU_LOG": log}, lambda: sweep_heterogeneous(
        [models[n] for n in row_design], hH, hT, hb, mesh=mesh,
        out_keys=SWEEP_OUT_KEYS))
    files["golden_sweep_hetero.npz"] = dict(
        Hs=hH, Tp=hT, beta=hb, design=np.asarray(row_design),
        **{k: np.asarray(v) for k, v in out.items()})
    with open(log) as f:
        event = [json.loads(line) for line in f
                 if '"bucket_sweep"' in line][-1]
    sigs = {n: bucketing.bucket_signature(m) for n, m in models.items()}
    axes = {n: bucketing.axis_counts(m, sigs[n]) for n, m in models.items()}
    files["golden_sweep_events.json"] = {
        "bucket_sweep": {k: event[k] for k in (
            "rows", "n_buckets", "n_designs", "padding_waste_frac",
            "waste_by_axis")},
        "axis_counts": {n: {a: list(v) for a, v in c.items()}
                        for n, c in axes.items()},
        "signature_fingerprint": {n: bucketing.signature_fingerprint(s)
                                  for n, s in sigs.items()},
        "tuned_rungs": {a: list(bucketing.tuned_rungs(
            [axes[n][a][0] for n in names])) for a in
            ("strips", "nodes", "lines")},
    }

    rows = full_rows("spar")
    ev = make_full_evaluator(raft_tpu.Model(quarantine_design()),
                             nWaves=FULL_SETS["spar"])
    qdir = os.path.join(tmp, "quarantine_spar")
    out = _with_env({"RAFT_TPU_ESCALATE": "retol",
                     "RAFT_TPU_ESCALATE_ITER_SCALE": QUARANTINE_ITER_SCALE},
                    lambda: run_sweep_checkpointed_full(
                        ev, rows, qdir, shard_size=SWEEP_SHARD, mesh=mesh,
                        out_keys=SWEEP_OUT_KEYS))
    files["golden_sweep_quarantine_spar.npz"] = dict(
        rows, **{k: np.asarray(v) for k, v in out.items()})
    files["golden_sweep_quarantine_spar.json"] = {
        "entries": resilience.load_quarantine(qdir)}
    return files


def write_sweep_fixtures():
    import json

    import numpy as np

    for fname, content in build_sweep_goldens().items():
        path = os.path.join(OUT_DIR, fname)
        if fname.endswith(".json"):
            with open(path, "w") as f:
                json.dump(content, f, indent=1, sort_keys=True)
                f.write("\n")
        else:
            np.savez_compressed(path, **content)
        print(f"wrote {fname}")


#: the frequency-axis goldens: the sets, their out keys and the JAX mesh
#: (dp, sp) = (2, 2) of 4 CPU devices
MESH_SETS = ("spar", "semi_wind")
MESH_OUT_KEYS = ("PSD", "Xi", "X0", "status", "n_iter_drag")
MESH_DEVICES = 4


def build_mesh_goldens():
    """``{file name: content}`` of the frequency-axis goldens: the JAX
    ``sweep_cases_full(..., shard_freq=True)`` of the spar's and
    semi_wind's full evaluator over their 8 golden rows on a (dp, sp) =
    (2, 2) CPU mesh (the process must not have initialised JAX before:
    the device count is an XLA flag)."""
    import numpy as np

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{MESH_DEVICES}").strip()
    _jax()
    import raft_tpu
    from raft_tpu.api import make_full_evaluator
    from raft_tpu.parallel.sweep import make_mesh, sweep_cases_full

    mesh = make_mesh(MESH_DEVICES, axis_names=("dp", "sp"))
    if dict(mesh.shape) != {"dp": 2, "sp": 2}:
        raise RuntimeError("the mesh goldens need 4 JAX CPU devices: run "
                           "--mesh in a process of its own")
    files = {}
    for name in MESH_SETS:
        rows = full_rows(name)
        ev = make_full_evaluator(raft_tpu.Model(full_design(name)),
                                 nWaves=FULL_SETS[name])
        out = sweep_cases_full(ev, rows, mesh=mesh, out_keys=MESH_OUT_KEYS,
                               shard_freq=True)
        files[f"golden_mesh_full_{name}.npz"] = dict(
            rows, **{k: np.asarray(v) for k, v in out.items()})
    return files


def write_mesh_fixtures():
    import numpy as np

    for fname, content in build_mesh_goldens().items():
        np.savez_compressed(os.path.join(OUT_DIR, fname), **content)
        print(f"wrote {fname}")


#: the serve goldens: the padded batch sizes (rungs) dispatched, the
#: requests per rung (each rung padded by repeating its last request),
#: the seed of their sea states and the case every rung starts with
SERVE_RUNGS = (1, 4, 16)
SERVE_ROWS = {1: 1, 4: 3, 16: 11}
SERVE_SEED = 20261101
SERVE_SHARED_CASE = (5.0, 10.0, 0.1)


def serve_requests(name, rung):
    """``(Hs, Tp, beta)`` arrays of the requests of one demo at one
    rung: :data:`SERVE_SHARED_CASE` first, then seeded seas (Hs 2-8 m,
    Tp 6-14 s, beta -0.5-0.5 rad, the serve warm-up's box)."""
    import numpy as np

    n = SERVE_ROWS[rung]
    rng = np.random.default_rng(
        [SERVE_SEED, list(DESIGNS).index(name), rung])
    lo_hi = ((2.0, 8.0), (6.0, 14.0), (-0.5, 0.5))
    return tuple(np.concatenate([[c], rng.uniform(lo, hi, n - 1)])
                 for c, (lo, hi) in zip(SERVE_SHARED_CASE, lo_hi))


def build_serve_golden(name):
    """The ``golden_serve_<name>.npz`` dict, as written."""
    _jax()
    import numpy as np

    from raft_tpu.parallel.sweep import make_mesh
    from raft_tpu.serve import engine

    reg = engine.Registry()
    entry = reg.register(name, design_dict(name))
    mesh = make_mesh(1)
    gd = {}
    for rung in SERVE_RUNGS:
        Hs, Tp, beta = serve_requests(name, rung)
        out = engine.dispatch([entry] * len(Hs), Hs, Tp, beta,
                              out_keys=OUT_KEYS, mesh=mesh, padded=rung,
                              record_metrics=False)
        gd.update({f"r{rung}_Hs": Hs, f"r{rung}_Tp": Tp,
                   f"r{rung}_beta": beta})
        gd.update({f"r{rung}_{k}": np.asarray(v) for k, v in out.items()})
    return gd


def write_serve_fixtures():
    import numpy as np

    for name in DESIGNS:
        gd = build_serve_golden(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_serve_{name}.npz"),
                            **gd)
        print(f"wrote golden_serve_{name}.npz: status "
              + " ".join(f"r{r}={gd[f'r{r}_status'].tolist()}"
                         for r in SERVE_RUNGS))


def main():
    import numpy as np

    os.makedirs(OUT_DIR, exist_ok=True)
    if sys.argv[1:] and sys.argv[1] == "--geometry":
        write_geometry_fixtures(*([sys.argv[2:]] if sys.argv[2:] else []))
        return
    if sys.argv[1:2] == ["--grad-rest"]:
        write_grad_rest_fixtures(*([sys.argv[2:]] if sys.argv[2:] else []))
        return
    if sys.argv[1:2] == ["--jvp"]:
        write_jvp_fixtures(*([sys.argv[2:]] if sys.argv[2:] else []))
        return
    if sys.argv[1:] == ["--farm"]:
        write_farm_fixtures()
        return
    if sys.argv[1:] == ["--flex"]:
        write_flex_fixtures()
        return
    if sys.argv[1:] == ["--bem"]:
        write_bem_fixtures()
        return
    if sys.argv[1:] == ["--qtf"]:
        write_qtf_fixtures()
        return
    if sys.argv[1:2] == ["--orchestrated"]:
        write_orch_fixtures(sys.argv[2:])
        return
    if sys.argv[1:] == ["--drivers"]:
        write_drivers_fixtures()
        return
    if sys.argv[1:2] == ["--omdao"]:
        write_omdao_fixtures(sys.argv[2:])
        return
    if sys.argv[1:] == ["--sweeps"]:
        write_sweep_fixtures()
        return
    if sys.argv[1:] == ["--serve"]:
        write_serve_fixtures()
        return
    if sys.argv[1:] == ["--mesh"]:
        write_mesh_fixtures()
        return
    for name in DESIGNS:
        pk, gd = build_fixtures(name)
        np.savez_compressed(os.path.join(OUT_DIR, f"packed_{name}.npz"), **pk)
        np.savez_compressed(os.path.join(OUT_DIR, f"golden_{name}.npz"), **gd)
        with open(os.path.join(OUT_DIR, f"design_{name}.json"), "w") as f:
            f.write(design_json(name))
        gdd = build_design_golden(name)
        np.savez_compressed(
            os.path.join(OUT_DIR, f"golden_design_{name}.npz"), **gdd)
        print(f"{name}: design status_on={gdd['on_status'].tolist()} "
              f"n_iter_on={gdd['on_n_iter_drag'].tolist()}")
        print(f"{name}: S={int(pk['sig_S'])} N={int(pk['sig_N'])} "
              f"L={int(pk['sig_L'])} status_on={gd['on_status'].tolist()} "
              f"n_iter_on={gd['on_n_iter_drag'].tolist()}")
    write_full_fixtures()
    write_geometry_fixtures()
    write_farm_fixtures()
    write_flex_fixtures()
    write_bem_fixtures()
    write_grad_rest_fixtures()
    write_jvp_fixtures()
    write_qtf_fixtures()
    write_orch_fixtures()
    write_drivers_fixtures()
    write_omdao_fixtures()
    write_sweep_fixtures()
    write_serve_fixtures()
    write_mesh_fixtures()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
