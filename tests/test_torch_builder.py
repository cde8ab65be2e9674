"""The port's host builder (design dict -> Model -> packed bucket) against
the JAX builder.

Fast tier: the three demo designs, read from their checked-in JSON
(``tests/fixtures/torch_port/design_*.json``), packed by the port and
held against the JAX builder's ``packed_*.npz``; the JSON and YAML give
the same dict; the refusals; the MacCamy-Fuchs strip coefficients, the
frustum ops and the pad ladders against JAX; one live JAX comparison of
the statics and zero-pose hydro constants (the smallest design, mhk).
The two rotor designs of the full path (``design_semi_wind.json``,
``design_mhk_tidal.json``) are held against the JAX builder's
``packed_semi_wind.npz`` and ``packed_mhk_tidal.npz`` the same way: the
submerged rotor's blade added mass enters ``A_hydro`` and its blade
buoyancy ``K_h`` and ``F_und``.  Slow tier: the live comparison for spar
and semi.

Tolerances: packed float leaves within 1e-12 x each leaf's max
magnitude, integer and boolean leaves exact; the signature, ``w`` and
``k`` exact (the signature embeds ``w``).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from raft_tpu_torch.models.model import Model
from raft_tpu_torch.ops import frustum as tfr
from raft_tpu_torch.physics import mooring as tmoor
from raft_tpu_torch.structure import bucketing as tb
from raft_tpu_torch.structure.schema import load_design

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "torch_port")
DESIGNS = ("spar", "semi", "mhk")
TOL = 1e-12


def design(name):
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        return json.load(f)


def hold_leaves(got, ref, tol=TOL):
    assert sorted(got) == sorted(ref)
    for k, b in ref.items():
        a = np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            scale = np.max(np.abs(b))
            assert np.max(np.abs(a - b)) <= tol * scale, k


@pytest.mark.parametrize("name", DESIGNS)
def test_pack_matches_jax_builder(name):
    model = Model(design(name))
    ref = tb.load_packed(os.path.join(FIX, f"packed_{name}.npz"))
    sig = tb.bucket_signature(model)
    assert sig == ref.sig
    leaves = tb.pack_design(model, sig)
    hold_leaves(leaves, ref.leaves)
    # the frequency grid and wave numbers bit for bit
    np.testing.assert_array_equal(model.w, tb.signature_meta(ref.sig)["w"])
    np.testing.assert_array_equal(leaves["k"], ref.leaves["k"])


@pytest.mark.parametrize("name", ("semi_wind", "mhk_tidal"))
def test_rotor_design_pack_matches_jax_builder(name):
    """The rotor designs' packed leaves, with the submerged rotor's blade
    added mass and buoyancy, against the JAX builder's."""
    model = Model(design(name))
    ref = tb.load_packed(os.path.join(FIX, f"packed_{name}.npz"))
    sig = tb.bucket_signature(model)
    assert sig == ref.sig
    hold_leaves(tb.pack_design(model, sig), ref.leaves)
    rot = model.fowtList[0].rotors[0]
    assert (rot.hydro is not None) == (name == "mhk_tidal")
    if rot.hydro is not None:
        # the blade added mass is in A_hydro, on top of the strips'
        strips_only = model.hydro[0].hc0["A_hydro"] - ref.leaves["A_hydro"]
        assert np.max(np.abs(strips_only)) <= TOL * np.max(
            np.abs(ref.leaves["A_hydro"]))
        assert np.max(np.abs(rot.hydro["A_hydro"])) > 0


@pytest.mark.parametrize("name", DESIGNS)
def test_json_and_yaml_give_the_same_dict(name):
    yml = os.path.join(ROOT, "raft_tpu", "designs", f"{name}_demo.yaml")
    with open(yml) as f:
        want = yaml.safe_load(f)
    assert design(name) == want
    assert load_design(yml) == want
    assert load_design(os.path.join(FIX, f"design_{name}.json")) == want


def test_unbucketed_signature_is_the_real_size():
    model = Model(design("semi"))
    sig = tb.bucket_signature(model, ladders={})
    assert sig[2:5] == (model.hydro[0].strips.S, model.fowtList[0].n_nodes,
                        model.ms.n_lines) == (73, 11, 3)
    leaves = tb.pack_design(model, sig)
    assert leaves["strip_mask"].all() and leaves["line_mask"].all()


def _refusals():
    def beam(d):
        d["platform"]["members"][0]["type"] = "beam"

    def pot_mod(d):
        d["platform"]["potModMaster"] = 0
        d["platform"]["members"][0]["potMod"] = True

    def pot_master(d):
        d["platform"]["potModMaster"] = 2

    def hydro_path(d):
        d["platform"]["potFirstOrder"] = 1
        d["platform"]["hydroPath"] = "spar_bem"

    def file_mooring(d):
        # a MoorDyn-file mooring with line dynamics (the file is written
        # by the test, see _spar_moordyn)
        d["mooring"] = {"water_depth": 320, "file": "lines.dat", "moorMod": 1}

    def moor_mod(d):
        d["mooring"]["moorMod"] = 1

    def array(d):
        # an array of potential-flow units
        d["array"] = {"keys": ["ID", "turbineID", "platformID", "mooringID",
                               "x_location", "y_location"],
                      "data": [[1, 1, 1, 1, 0, 0], [2, 1, 1, 1, 900, 0]]}
        d["platform"]["potModMaster"] = 2

    def qtf(d):
        d["platform"]["potSecOrder"] = 2
        d["platform"]["hydroPath"] = "spar_bem"

    return {f.__name__: f for f in (beam, pot_mod, pot_master, hydro_path,
                                    file_mooring, moor_mod, array, qtf)}


def _spar_moordyn(d):
    """The spar's inline mooring as a MoorDyn v2 text (vessel-to-anchor
    lines; MoorDyn's default line coefficients)."""
    mo = d["mooring"]
    lt = mo["line_types"][0]
    pts = {p["name"]: (i + 1, p) for i, p in enumerate(mo["points"])}
    rows = ["--- LINE TYPES ---",
            "Name Diam MassDen EA BA/-zeta EI Cd Ca CdAx CaAx",
            "(name) (m) (kg/m) (N) (N-s/-) (N-m^2) (-) (-) (-) (-)",
            f"{lt['name']} {lt['diameter']} "
            f"{lt['mass_density']} {float(lt['stiffness'])} -1.0 0.0 1.2 1.0 "
            "0.05 0.0", "--- POINTS ---", "ID Attachment X Y Z M V CdA Ca",
            "(#) (-) (m) (m) (m) (kg) (m3) (m2) (-)"]
    for i, p in pts.values():
        kind = "Fixed" if p["type"] == "fixed" else "Vessel"
        x, y, z = p["location"]
        rows.append(f"{i} {kind} {x} {y} {z} 0 0 0 0")
    rows += ["--- LINES ---", "ID LineType AttachA AttachB UnstrLen NumSegs "
             "Outputs", "(#) (name) (#) (#) (m) (-) (-)"]
    for i, ln in enumerate(mo["lines"]):
        rows.append(f"{i + 1} {ln['type']} {pts[ln['endA']][0]} "
                    f"{pts[ln['endB']][0]} {ln['length']} 20 -")
    rows += ["--- OPTIONS ---", "320 depth", "END"]
    return "\n".join(rows) + "\n"


def _same_full_rows(model, model0):
    """The full evaluator of ``model`` gives the bits of ``model0``'s on
    two rows with current and two headings."""
    from raft_tpu_torch.api import make_full_evaluator

    rows = dict(current_speed=[0.0, 0.8], current_heading_deg=[0.0, 40.0],
                Hs=[[6.0, 2.0], [3.0, 1.0]], Tp=[[12.0, 8.0], [9.0, 6.0]],
                beta_deg=[[0.0, 90.0], [30.0, 200.0]])
    out = make_full_evaluator(model, nWaves=2, device="cpu")(**rows)
    ref = make_full_evaluator(model0, nWaves=2, device="cpu")(**rows)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("variant", sorted(_refusals()))
def test_unsupported_designs_raise(variant, tmp_path):
    """Each variant of the spar the port does not build raises, naming
    its ROADMAP item, before any Model exists.  What builds is refused
    where the reference refuses it: a beam member (the flexible path) by
    the rigid full evaluator, naming make_flexible_evaluator;
    potential-flow members and coefficient files by the bucket path
    (the case, design and sweep paths), without running the panel
    solver; an array of potential-flow units by the farm evaluator; an
    external QTF by the bucket path, without reading its file.  Line
    dynamics (moorMod 1, an inline or a MoorDyn-file mooring) build:
    the bucket path refuses them, as the reference's does, and the full
    evaluator, which never reads moorMod, gives the bits of the same
    design at moorMod 0 (their lumped-mass physics runs in
    Model.analyze_cases)."""
    from raft_tpu_torch.api import make_farm_evaluator, make_full_evaluator

    d = copy.deepcopy(design("spar"))
    text = _spar_moordyn(d)
    _refusals()[variant](d)
    if variant == "beam":
        model = Model(d)
        assert not model.fowtList[0].is_single_body
        with pytest.raises(NotImplementedError,
                           match=r"make_flexible_evaluator.*ROADMAP A11"):
            make_full_evaluator(model, device="cpu")
        return
    if variant in ("pot_mod", "pot_master", "hydro_path"):
        model = Model(d)
        assert tb.has_potential_flow(model.fowtList[0])
        with pytest.raises(tb.UnbucketableDesignError, match="potential"):
            tb.bucket_signature(model)
        assert model._bem_list is None
        return
    if variant == "array":
        model = Model(d)
        with pytest.raises(NotImplementedError, match=r"ROADMAP A11"):
            make_farm_evaluator(model, device="cpu")
        assert model._bem_list is None
        return
    if variant == "qtf":
        # builds; the bucket path (case, design, sweep) refuses an
        # external QTF on the design's flags, reading no file
        model = Model(d)
        with pytest.raises(tb.UnbucketableDesignError,
                           match=r"QTF.*ROADMAP A13"):
            tb.bucket_signature(model)
        assert not hasattr(model, "_qtf")
        return
    assert variant in ("file_mooring", "moor_mod")
    (tmp_path / "lines.dat").write_text(text)
    model = Model(copy.deepcopy(d), base_dir=str(tmp_path))
    assert model.ms.moorMod == 1 and model.ms.m_lin is not None
    with pytest.raises(tb.UnbucketableDesignError, match="moorMod"):
        tb.bucket_signature(model)
    d["mooring"]["moorMod"] = 0
    model0 = Model(d, base_dir=str(tmp_path))
    assert model0.ms.moorMod == 0
    _same_full_rows(model, model0)


def test_mcf_strips_match_jax():
    """One spar member with MCF: True: the baked Cm_p1_w/Cm_p2_w (scipy
    Hankel table) against JAX's build_strips."""
    from raft_tpu.models.fowt import FOWTStructure as JFOWT
    from raft_tpu.ops.waves import wave_number_ref as jk
    from raft_tpu.physics import morison as jmor

    d = copy.deepcopy(design("spar"))
    d["platform"]["members"][0]["MCF"] = True
    model = Model(d)
    ss = model.hydro[0].strips
    assert ss.mcf.any()
    jfs = JFOWT(copy.deepcopy(d), depth=model.depth)
    jss = jmor.build_strips(jfs, k_array=jk(model.w, model.depth))
    for k in ("Cm_p1_w", "Cm_p2_w"):
        a, b = getattr(ss, k), getattr(jss, k)
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), k
        assert not np.allclose(b, b[:, :1]), "MCF must vary with frequency"
    for k in ("node", "mnode0", "mcf", "active", "circ"):
        np.testing.assert_array_equal(getattr(ss, k), getattr(jss, k))


FRUSTA = [
    ((8.0, 6.0, 4.0, 1025.0), "taper"),
    ((5.0, 5.0, 3.0, 7850.0), "cylinder"),
    ((5.0, 5.0, 0.0, 7850.0), "flat"),
]


@pytest.mark.parametrize("args,kind", FRUSTA, ids=[k for _, k in FRUSTA])
def test_frustum_ops_match_jax(args, kind):
    from raft_tpu.ops import frustum as jfr

    dA, dB, H, rho = args
    slA, slB = np.array([dA, 0.5 * dA]), np.array([dB, 0.7 * dB])
    pairs = [
        (tfr.frustum_vcv_circ(dA, dB, H), jfr.frustum_vcv_circ(dA, dB, H)),
        (tfr.frustum_vcv_rect(slA, slB, H),
         jfr.frustum_vcv_rect(slA, slB, H)),
        (tfr.frustum_moi_circ(dA, dB, H, rho),
         jfr.frustum_moi_circ(dA, dB, H, rho)),
        (tfr.frustum_moi_rect(slA, slB, H, rho),
         jfr.frustum_moi_rect(slA, slB, H, rho)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert abs(float(a) - float(b)) <= TOL * max(abs(float(b)), 1.0)


@pytest.mark.parametrize("spec", [
    None, "pow2", "strips=20,40;nodes=3,5", "lines=2,3;strips=pow2"])
def test_pad_ladders_match_jax(spec):
    from raft_tpu.structure import bucketing as jb

    assert tb.pad_ladder(spec or "") == jb.pad_ladder(spec or "")
    lad = tb.pad_ladder(spec)
    jlad = jb.pad_ladder(spec)
    for axis in tb.AXIS_FLOORS:
        for n in (0, 1, 3, 17, 47, 73, 200):
            assert tb._axis_pad(n, axis, lad) == jb._axis_pad(n, axis, jlad)


def test_bad_ladder_raises():
    with pytest.raises(ValueError, match="BUCKET_STEPS"):
        tb.pad_ladder("strips=32,16")


def test_mooring_closures_are_the_all_lines_sum():
    """mooring_force/mooring_stiffness of the spar's system at two poses
    equal the masked line sum with every line counted, and a per-row L
    scales the lines of its own row only."""
    ms = Model(design("spar")).ms
    X = torch.tensor([[0.0] * 6, [4.0, -2.0, 0.5, 0.01, -0.02, 0.03]],
                     dtype=torch.float64)
    m = ms.to("cpu")
    F = tmoor.mooring_force(m, X)
    C = tmoor.mooring_stiffness(m, X)
    args = [t.expand((2,) + t.shape) for t in
            (m.r_fair0, m.r_anchor, m.L, m.w, m.EA)]
    F2, C2 = tmoor.line_forces_and_stiffness(
        *args, torch.ones(2, 3, dtype=torch.bool), X)
    assert torch.equal(F, F2) and torch.equal(C, C2)
    from dataclasses import replace

    scaled = replace(m, L=m.L * torch.tensor([[1.0], [1.02]],
                                             dtype=torch.float64))
    Fs = tmoor.mooring_force(scaled, X)
    assert torch.equal(Fs[0], F[0]) and not torch.equal(Fs[1], F[1])


def _rect_mast(d):
    """The mhk design with its sensor mast made a tapered rectangular
    member crossing the waterline (the rectangular branches of the
    member, statics and strip geometry)."""
    mast = d["platform"]["members"][2]
    mast.update(shape="rect", d=[[1.2, 0.9], [0.8, 0.5]], rA=[0, 0, -2],
                rB=[0, 0, 6], l_fill=[1.0], rho_fill=[1025.0],
                cap_stations=[0], cap_t=[0.05], cap_d_in=[[0.2, 0.1]])
    return d


def _live_statics(d):
    """The port's statics and zero-pose hydro constants against JAX's
    ``calc_statics`` and ``hydro_constants`` (jitted, float64, CPU) on
    the JAX builder's structure of the same design dict."""
    import jax

    import raft_tpu
    from raft_tpu.physics import morison as jmor
    from raft_tpu.physics.statics import (calc_statics, node_T,
                                          platform_kinematics)

    jm = raft_tpu.Model(copy.deepcopy(d))
    fs = jm.fowtList[0]
    strips = jmor.build_strips(fs, k_array=jm.k)

    def reference():
        r_nodes, R_ptfm, r_root = platform_kinematics(fs, np.zeros(6))
        hc0 = jmor.hydro_constants(fs, strips, R_ptfm, r_nodes,
                                   node_T(r_nodes, r_root))
        st = calc_statics(fs)
        return ({k: v for k, v in st.items()
                 if k not in ("pb", "mtower", "rCG_tow")}, hc0)

    js, jh = jax.tree_util.tree_map(np.asarray, jax.jit(reference)())
    tm = Model(copy.deepcopy(d))
    ts, th = tm.statics(), tm.hydro[0].hc0
    for k in js:
        a, b = np.asarray(ts[k]), js[k]
        assert a.shape == b.shape, k
        assert np.max(np.abs(a - b)) <= TOL * max(np.max(np.abs(b)), 1e-300), k
    for k in ("A_hydro", "Amat", "Imat", "a_i", "r", "q", "p1", "p2"):
        a, b = th[k], jh[k]
        assert np.max(np.abs(a - b)) <= TOL * max(np.max(np.abs(b)), 1e-300), k
    for k in ("sub", "active"):
        np.testing.assert_array_equal(th[k], jh[k])
    np.testing.assert_array_equal(tm.hydro[0].strips.circ, strips.circ)


@pytest.mark.parametrize("variant", ["mhk", "mhk_rect"])
def test_live_jax_statics_and_hydro_mhk(variant):
    d = design("mhk")
    if variant == "mhk_rect":
        d = _rect_mast(d)
        assert not Model(copy.deepcopy(d)).hydro[0].strips.circ.all()
    _live_statics(d)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["spar", "semi"])
def test_live_jax_statics_and_hydro(name):
    _live_statics(design(name))
