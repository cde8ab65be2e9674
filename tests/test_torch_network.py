"""The port's MoorDyn parsers and quasi-static mooring network against
JAX.

Fast tier: ``parse_moordyn`` / ``parse_moordyn_system`` against the JAX
parsers (imported, nothing traced) on ``farm_shared.dat`` and on simple
vessel-to-anchor files (MoorDyn v1, v2 and quasi-static line types):
points, kinds, bodies, lengths, ``w``, ``EA``, ``can_ground`` and the
line-dynamics columns equal; the single-unit MoorDyn-file mooring of a
Model; the suspended catenary (``can_ground=False``) and the network's
body forces, coupled stiffness, free-point positions and line tensions
within 1e-10 x each key's max of ``golden_network_semi_wind.npz``;
bathymetry grids and their interpolation.  Slow tier: the hand-carried
network stiffness against the ``torch.func.jacfwd`` oracle within 1e-9
relative.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.physics import mooring as jmoor
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.physics import mooring as tmoor

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
SHARED = os.path.join(FIX, "farm_shared.dat")
TOL = 1e-10

SIMPLE = """--------------------- MoorDyn Input File -------------------
---------------------- LINE TYPES -----------------------------
Name     Diam    MassDen   EA        BA/-zeta  {typecols}
(name)   (m)     (kg/m)    (N)       (N-s/-)   {typeunits}
{typerow}
---------------------- POINTS ---------------------------------
ID  Attachment  X       Y      Z     M  V  CdA Ca
(#) (-)         (m)     (m)    (m)  (kg) (m3) (m2) (-)
1   Fixed      -837.6   0.0   -200.0  0  0  0  0
2   Vessel     -58.0    0.0   -14.0   0  0  0  0
3   Anchor      418.8   725.4 -200.0  0  0  0  0
4   Vessel      29.0    50.2  -14.0   0  0  0  0
5   Fixed       418.8  -725.4 -200.0  0  0  0  0
6   Vessel      29.0   -50.2  -14.0   0  0  0  0
---------------------- LINES ----------------------------------
ID  LineType  AttachA  AttachB  UnstrLen  NumSegs Outputs
(#) (name)    (#)      (#)      (m)       (-)     (-)
1   chain     1        2        850.0     40      -
2   chain     4        3        851.5     40      -
3   chain     5        6        849.0     40      -
---------------------- OPTIONS --------------------------------
0.001  dtM
"""
FORMATS = {
    "v2": dict(typecols="EI     Cd    Ca    CdAx   CaAx",
               typeunits="(N-m^2) (-)  (-)   (-)    (-)",
               typerow="chain   0.333   685.0   3.27e9    -1.0      0.0    "
                       "1.1   0.82  0.21   0.27"),
    "v1": dict(typecols="Can   Cat    Cdn   Cdt",
               typeunits="(-)   (-)    (-)   (-)",
               typerow="chain   0.333   685.0   3.27e9    -1.0      0.82   "
                       "0.27  1.1   0.21"),
    "quasi_static": dict(typecols="", typeunits="",
                         typerow="chain   0.333   685.0   3.27e9    -1.0"),
}
SYSTEM_FIELDS = ("r_anchor", "r_fair0", "L", "w", "EA", "m_lin", "d_vol",
                 "Cd", "Ca", "CdAx", "CaAx", "BA")


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _same_network(t, j):
    for k in ("p_kind", "p_body", "p_r", "p_mass", "p_vol", "free_idx",
              "l_can_ground"):
        np.testing.assert_array_equal(getattr(t, k), np.asarray(getattr(j, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(t.l_ends, np.asarray(j.l_ends))
    for k in ("l_L", "l_w", "l_EA"):
        np.testing.assert_array_equal(getattr(t, k),
                                      np.asarray(getattr(j, k)), err_msg=k)
    assert t.n_bodies == j.n_bodies


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_parse_moordyn_system_matches_jax(tmp_path, fmt):
    path = _write(tmp_path, f"{fmt}.dat", SIMPLE.format(**FORMATS[fmt]))
    t = tmoor.parse_moordyn_system(path, 200.0)
    j = jmoor.parse_moordyn_system(path, 200.0)
    for k in SYSTEM_FIELDS:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    assert t.depth == j.depth == 200.0
    # the same file as a network: three anchors, three fairleads on body 0
    _same_network(tmoor.parse_moordyn(path, 200.0),
                  jmoor.parse_moordyn(path, 200.0))


def test_moordyn_refusals_match_jax(tmp_path):
    """A 7-column line-type row is ambiguous, and a file with free or
    shared points needs the network: both parsers raise ValueError."""
    bad = _write(tmp_path, "ambiguous.dat", SIMPLE.format(
        typecols="Cd Ca", typeunits="(-) (-)",
        typerow="chain   0.333   685.0   3.27e9    -1.0      1.1    0.82"))
    for path in (bad, SHARED):
        for parse in (tmoor.parse_moordyn_system, jmoor.parse_moordyn_system):
            with pytest.raises(ValueError):
                parse(path, 200.0)


def test_shared_file_matches_jax():
    """farm_shared.dat: two bodies, one free buoy, two suspended
    segments that cannot ground."""
    t = tmoor.parse_moordyn(SHARED, 200.0)
    _same_network(t, jmoor.parse_moordyn(SHARED, 200.0))
    assert t.n_bodies == 2 and list(t.free_idx) == [1]
    assert not t.l_can_ground.any()


def test_model_reads_a_moordyn_file(tmp_path):
    """A single unit's MoorDyn-file mooring: a vessel-to-anchor file
    becomes the JAX Model's catenary system, a file with free points its
    network; with moorMod 1 or 2 the file's system carries that moorMod
    and the line-dynamics columns, as the JAX Model's does."""
    import raft_tpu

    path = _write(tmp_path, "lines.dat", SIMPLE.format(**FORMATS["v2"]))
    with open(os.path.join(FIX, "design_semi.json")) as f:
        d = json.load(f)
    d["mooring"] = {"water_depth": 200, "file": "lines.dat"}
    t = Model(copy.deepcopy(d), base_dir=str(tmp_path))
    j = raft_tpu.Model(copy.deepcopy(d), base_dir=str(tmp_path))
    assert isinstance(t.ms, tmoor.MooringSystem)
    for k in SYSTEM_FIELDS:
        np.testing.assert_array_equal(getattr(t.ms, k), getattr(j.ms, k),
                                      err_msg=k)
    d["mooring"]["file"] = SHARED
    _same_network(Model(copy.deepcopy(d)).ms,
                  raft_tpu.Model(copy.deepcopy(d)).ms)
    for mod in (1, 2):
        d["mooring"] = {"water_depth": 200, "file": path, "moorMod": mod}
        t = Model(copy.deepcopy(d)).ms
        j = raft_tpu.Model(copy.deepcopy(d)).ms
        assert t.moorMod == j.moorMod == mod
        for k in SYSTEM_FIELDS:
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                          err_msg=k)


def _golden():
    return dict(np.load(os.path.join(FIX, "golden_network_semi_wind.npz")))


def test_suspended_catenary_matches_golden():
    """``solve_catenary(can_ground=False)`` (no seabed contact) against
    the JAX solve; on the spans where VF < w L it differs from the
    anchor-line solve."""
    g = _golden()
    c = torch.as_tensor(g["cat_in"])
    got = torch.stack(tmoor.solve_catenary(*c.unbind(1), can_ground=False),
                      dim=1).numpy()
    want = g["cat_out"]
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
    grounded = torch.stack(tmoor.solve_catenary(*c.unbind(1)), dim=1).numpy()
    lifts = want[:, 1] < c[:, 2].numpy() * c[:, 3].numpy()
    assert lifts.any()
    assert not np.allclose(grounded[lifts], want[lifts])


def test_network_matches_goldens():
    """The farm's shared network, built by the port's Model from
    design_farm_semi_wind.json: body forces, coupled stiffness (12 x 12),
    free-point positions and line tensions at the 8 golden rows'
    equilibria and 3 perturbed poses, within 1e-10 x each key's max."""
    with open(os.path.join(FIX, "design_farm_semi_wind.json")) as f:
        net = Model(json.load(f), base_dir=FIX).ms_array
    g = _golden()
    out = net.solve(torch.as_tensor(g["X"]))
    for k in ("F", "K", "r_free", "tensions"):
        a, b = out[k].numpy(), g[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        scale = np.max(np.abs(b))
        assert np.max(np.abs(a - b)) <= TOL * scale, k
    # the forces alone, without the stiffness's tangents
    alone = net.solve(torch.as_tensor(g["X"]), stiffness=False)
    for k in ("F", "r_free", "tensions"):
        np.testing.assert_array_equal(alone[k].numpy(), out[k].numpy())


@pytest.mark.slow
def test_network_stiffness_matches_jacfwd():
    """The hand-carried stiffness (the free points eliminated by their
    equilibrium) against -torch.func.jacfwd of the body forces through
    the whole inner Newton loop, at a perturbed pose: within 1e-9
    relative."""
    net = tmoor.parse_moordyn(SHARED, 200.0)
    X = torch.as_tensor(_golden()["X"][-1:])
    K = net.solve(X)["K"]
    Kj = net.stiffness_jacfwd(X)
    assert float(torch.max(torch.abs(K - Kj))) <= 1e-9 * float(
        torch.max(torch.abs(Kj)))


BATHY = """--- MoorPy Bathymetry Input File ---
nGridX 3
nGridY 2
-1000 0 1000
-500 190 200 215
500 196 204 230
"""


def test_bathymetry_matches_jax(tmp_path):
    """A small grid: the same arrays, the same bilinear depth (clamped
    outside the grid), and the same anchors on the local seabed."""
    path = _write(tmp_path, "bathy.txt", BATHY)
    t, j = tmoor.read_bathymetry(path), jmoor.read_bathymetry(path)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    tn = tmoor.parse_moordyn(SHARED, 200.0, bathymetry=path)
    jn = jmoor.parse_moordyn(SHARED, 200.0, bathymetry=path)
    for x, y in ((0.0, 0.0), (-1000.0, -500.0), (333.0, -120.0),
                 (2500.0, 900.0), (-3000.0, 0.0)):
        assert tn.depth_at(x, y) == jn.depth_at(x, y)
    assert tn.depth_at(500.0, 0.0) == pytest.approx(
        0.25 * (200 + 215 + 204 + 230))
    with pytest.raises(ValueError, match="nGridX"):
        tmoor.read_bathymetry(_write(tmp_path, "bad.txt",
                                     BATHY.replace("nGridX 3", "nGridX 4")))
    # a fixed point at the local seabed grounds its line
    text = SIMPLE.format(**FORMATS["v2"]).replace(
        "1   Fixed      -837.6   0.0   -200.0",
        "1   Fixed      -837.6   0.0   -198.4")
    path2 = _write(tmp_path, "local.dat", text)
    tl = tmoor.parse_moordyn(path2, 200.0, bathymetry=path)
    _same_network(tl, jmoor.parse_moordyn(path2, 200.0, bathymetry=path))
    assert tl.l_can_ground[0]
