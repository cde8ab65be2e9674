"""The port's potential-flow path against JAX: the panel mesher, the WAMIT
files, the wave Green functions, the panel solver's binding, the
model's coefficients and the full evaluator on potential-flow designs.

Fast tier (CPU):

* the mesh is bit-equal to JAX's (``mesh_fowt`` on both meshes of
  ``design_semi_wind_bem*.json``, and the primitives);
* the WAMIT writers write JAX's bytes, the readers read what JAX reads,
  the model-grid coefficients and the heading interpolation match;
* the Green functions: dispersion roots and evanescent coefficients
  exactly, 30 seeded table nodes against JAX's quadrature and the
  shipped table at 1e-12;
* the panel solver (the port's own build of its own source) against
  JAX's binding of the reference source: the frequency-limit added
  mass and one finite-depth and one deep frequency at 1e-12 x max.
  JAX's binding gets the port's shipped table in place of its own
  cache, which it would otherwise spend minutes building; the shipped
  table is JAX's builder's at the nodes checked here and over the whole
  grid in the slow rebuild test;
* ``Model.run_bem`` on the coarse copy (304 panels): raw output,
  files and model-grid coefficients within 1e-12 x max of JAX's; the
  files JAX wrote sit in the same cache directory under JAX's names and
  are not served to the port;
* the full evaluator on the coarse copy (one and two headings) and on
  the WAMIT-file design against the JAX goldens, FUSED on and off:
  every key within 1e-10 x max, ``status``, ``n_iter_drag`` and
  ``drag_converged`` bit-equal;
* what the reference refuses.

The coarse copy's d_scale geometry axis (its golden rows, and its
gradient with respect to d_scale, unit scale included, and every row
input against jax.grad, ``golden_grad_bem_semi_wind_coarse.npz``, within
1e-9 x max|g|) is held in ``test_torch_bem_geometry.py`` with this
file's fixtures.

Slow tier: the Green table rebuilt equals the shipped one; the full
mesh's coefficients and golden rows against live JAX.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from raft_tpu_torch import api as tapi
from raft_tpu_torch import native
from raft_tpu_torch.io import panels, wamit
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.native import green_fd, green_table

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
JAX_CACHE = os.path.join(FIX, "bem_cache_jax")
ROW_KEYS = tapi.ENV_KEYS + tapi.SEA_KEYS
TOL = 1e-10
COEF_TOL = 1e-12
EXACT = ("status", "n_iter_drag", "drag_converged")
DESIGNS = {"semi_wind": "design_semi_wind_bem.json",
           "semi_wind_coarse": "design_semi_wind_bem_coarse.json",
           "semi_wind_wamit": "design_semi_wind_wamit.json"}


def design_path(name):
    return os.path.join(FIX, DESIGNS[name])


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_bem_{name}.npz")))


def near(a, b, tol, what=""):
    """max |a - b| <= tol x max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def hold(out, ref, pfx):
    assert sorted(out) == sorted(tapi.FULL_OUT_KEYS)
    for k in tapi.FULL_OUT_KEYS:
        a = out[k].cpu().numpy()
        b = ref[pfx + k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            near(a, b, TOL, k)


def jax_model(name):
    import raft_tpu

    return raft_tpu.Model(design_path(name))


@pytest.fixture(scope="module")
def bem_dir(tmp_path_factory):
    """A coefficient cache holding the files JAX's run_bem wrote for the
    coarse copy, under JAX's names; the module's port models cache
    here."""
    d = tmp_path_factory.mktemp("bem_cache")
    for f in os.listdir(JAX_CACHE):
        shutil.copy(os.path.join(JAX_CACHE, f), d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_BEM_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def coarse(bem_dir):
    """The port's coarse model, its coefficients solved once here, the
    raw output of that solve and the files it wrote."""
    raw = []
    solve = native.solve_bem

    def recording(*a, **kw):
        raw.append(solve(*a, **kw))
        return raw[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "solve_bem", recording)
        m = Model(design_path("semi_wind_coarse"))
        assert m.bem is not None
    assert len(raw) == 1
    return m, raw[0], sorted(set(os.listdir(bem_dir))
                             - set(os.listdir(JAX_CACHE)))


@pytest.fixture(scope="module")
def wamit_model():
    return Model(design_path("semi_wind_wamit"))


@pytest.fixture
def jax_native(monkeypatch):
    """JAX's binding with the port's shipped Green table in place of its
    own (minutes to build where its cache is absent)."""
    import raft_tpu.native as jn
    from raft_tpu.native import green_table as jgt

    monkeypatch.setattr(jgt, "_tables", dict(green_table.build_tables()))
    return jn


# ------------------------------------------------------------------ mesher

@pytest.mark.parametrize("name", ["semi_wind", "semi_wind_coarse"])
@pytest.mark.parametrize("clip_depth", [3, 0])
def test_mesh_fowt_bit_equal_to_jax(name, clip_depth):
    """Both meshes (684 and 304 panels), with the subdivision clipping of
    intersections and with whole-panel removal."""
    from raft_tpu.io.panels import mesh_fowt as jmesh

    with open(design_path(name)) as f:
        d = json.load(f)
    st = d["settings"]
    kw = dict(n_az=int(st.get("nAz_BEM", 18)), dz_max=st.get("dz_BEM"),
              clip_depth=clip_depth)
    a = panels.mesh_fowt(Model(copy.deepcopy(d)).fowtList[0], **kw)
    b = jmesh(jax_model(name).fowtList[0], **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if clip_depth == 3:
        assert len(a[3]) == int(golden(name)["n_panels"])


def _primitives():
    q = np.array([0.3, 0.0, 1.0]) / np.linalg.norm([0.3, 0.0, 1.0])
    return {
        "cylinder": ("mesh_cylinder", ([0.0, 10.0, 25.0], [12.0, 12.0, 8.0],
                                       [0.0, 0.0, -20.0], [0, 0, 1.0]),
                     dict(n_az=12, dz_max=3.0)),
        "capped_pontoon": ("mesh_cylinder_capped",
                           ([0.0, 40.0], [3.0, 3.0], [5.0, 2.0, -18.0],
                            [1.0, 0.0, 0.0]), dict(n_az=10, dz_max=4.0)),
        "capped_inclined": ("mesh_cylinder_capped",
                            ([0.0, 12.0], [4.0, 2.5], [0.0, 0.0, -30.0], q),
                            dict(n_az=9, dz_max=2.0)),
        "rectangular": ("mesh_rectangular",
                        ([0.0, 20.0], [[6.0, 4.0], [5.0, 3.0]],
                         [0.0, 0.0, -15.0], [0, 0, 1.0], [1.0, 0, 0],
                         [0, 1.0, 0]), dict(dz_max=2.5, da_max=1.5)),
    }


@pytest.mark.parametrize("case", sorted(_primitives()))
def test_mesh_primitives_bit_equal_to_jax(case):
    from raft_tpu.io import panels as jpanels

    fn, args, kw = _primitives()[case]
    a = getattr(panels, fn)(*args, **kw)
    b = getattr(jpanels, fn)(*args, **kw)
    assert len(a[3]) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pnl_and_gdf_files_match_jax(tmp_path):
    """The writers write JAX's bytes; the readers read what JAX's read
    (a .gdf written here, to its 3 decimals; a HAMS node-list .pnl with a
    triangle)."""
    from raft_tpu.io import panels as jpanels

    v, c, n, a = panels.mesh_cylinder_capped(
        [0.0, 40.0], [3.0, 3.0], [5.0, 2.0, -18.0], [1.0, 0.0, 0.0],
        n_az=6, dz_max=8.0)
    for ext, w_fn in (("pnl", "write_pnl"), ("gdf", "write_gdf")):
        p, jp = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        getattr(panels, w_fn)(str(p), v)
        getattr(jpanels, w_fn)(str(jp), v)
        assert p.read_bytes() == jp.read_bytes(), ext
    got = panels.read_gdf(str(tmp_path / "port.gdf"))
    for x, y in zip(got, jpanels.read_gdf(str(tmp_path / "port.gdf"))):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(got[3], a, rtol=1e-3)
    hams = tmp_path / "hams.pnl"
    hams.write_text(
        "    --------------Hull Mesh File---------------\n\n"
        "    # Number of Panels, Nodes, X-Symmetry and Y-Symmetry\n"
        "         2         5         0         0\n\n"
        "    #Start Definition of Node Coordinates     ! node_number   x   y   z\n"
        "         1   0.0   0.0  -1.0\n         2   1.0   0.0  -1.0\n"
        "         3   1.0   1.0  -1.0\n         4   0.0   1.0  -1.0\n"
        "         5   0.5   2.0  -1.0\n"
        "   #End Definition of Node Coordinates\n\n"
        "   #Start Definition of Node Relations   ! panel_number  "
        "number_of_vertices   Vertex1_ID   Vertex2_ID   Vertex3_ID   "
        "(Vertex4_ID)\n"
        "         1         4          1          2          3          4\n"
        "         2         3          4          3          5\n"
        "   #End Definition of Node Relations\n")
    got = panels.read_pnl(str(hams))
    assert got[0].shape == (2, 4, 3)
    for x, y in zip(got, jpanels.read_pnl(str(hams))):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------- WAMIT

def test_wamit_writers_write_jax_bytes_and_round_trip(tmp_path):
    """The coarse set's raw coefficients through both packages' writers
    (same bytes) and readers (same arrays); the round trip keeps the
    .6e digits."""
    from raft_tpu.io import wamit as jwamit

    g = golden("semi_wind_coarse")
    w, heads = g["w_bem"], g["bem_headings"]
    for ext, wr, args in ((".1", "write_wamit1", (g["A"], g["B"])),
                          (".3", "write_wamit3", (heads, g["X"]))):
        p, jp = str(tmp_path / ("port" + ext)), str(tmp_path / ("jax" + ext))
        getattr(wamit, wr)(p, w, *args)
        getattr(jwamit, wr)(jp, w, *args)
        with open(p, "rb") as f1, open(jp, "rb") as f2:
            assert f1.read() == f2.read(), ext
    w1, A, B = wamit.read_wamit1(str(tmp_path / "port.1"))
    jw1, jA, jB = jwamit.read_wamit1(str(tmp_path / "port.1"))
    for x, y in ((w1, jw1), (A, jA), (B, jB)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(w1, w, rtol=1e-6)
    near(A * 1025.0, g["A"], 1e-6, "A round trip")
    near(B * 1025.0 * w[None, None], g["B"], 1e-6, "B round trip")
    w3, h3, X = wamit.read_wamit3(str(tmp_path / "port.3"))
    jw3, jh3, jX = jwamit.read_wamit3(str(tmp_path / "port.3"))
    for x, y in ((w3, jw3), (h3, jh3), (X, jX)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(h3, heads)
    near(X * 1025.0 * 9.81, g["X"], 1e-6, "X round trip")


def test_rao_and_p2_files_match_jax(tmp_path):
    """The .4 RAO writer and reader and the .p2 reader."""
    from raft_tpu.io import wamit as jwamit

    rng = np.random.default_rng(8)
    w = np.linspace(0.1, 2.0, 7)
    Xi = rng.normal(size=(6, 7)) + 1j * rng.normal(size=(6, 7))
    p, jp = str(tmp_path / "port.4"), str(tmp_path / "jax.4")
    wamit.write_rao_4(p, w, Xi, beta_deg=30.0)
    jwamit.write_rao_4(jp, w, Xi, beta_deg=30.0)
    with open(p, "rb") as f1, open(jp, "rb") as f2:
        assert f1.read() == f2.read()
    for x, y in zip(wamit.read_rao_4(p), jwamit.read_rao_4(p)):
        np.testing.assert_array_equal(x, y)
    rows = [(T, h, i, 1.0, 0.0, rng.normal(), rng.normal())
            for T in (5.0, 10.0, 20.0) for h in (0.0, 45.0)
            for i in range(1, 7)]
    p2 = str(tmp_path / "q.p2")
    np.savetxt(p2, np.asarray(rows))
    a = wamit.read_wamit_p2(p2, rho=1025.0, ulen=2.0, g=9.81)
    b = jwamit.read_wamit_p2(p2, rho=1025.0, ulen=2.0, g=9.81)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("r_ref", [(0.0, 0.0, 0.0), (1.5, -2.0, 3.0)])
def test_load_bem_coefficients_matches_jax(r_ref, wamit_model):
    """The model-grid A, B and heading-relative X of the WAMIT files,
    translated to a reference point, with the zero-frequency pad below
    the first BEM frequency (the model grid starts below it)."""
    from raft_tpu.io.wamit import load_bem_coefficients as jload

    path = os.path.join(FIX, "semi_wind_wamit")
    w = wamit_model.w
    assert w[0] < golden("semi_wind")["w_bem"][0]
    a = wamit.load_bem_coefficients(path, w, 1025.0, 9.81, r_ref=r_ref)
    b = jload(path, w, 1025.0, 9.81, r_ref=r_ref)
    np.testing.assert_array_equal(a["headings"], b["headings"])
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        near(a[k], b[k], COEF_TOL, k)


def _heading_cases():
    rng = np.random.default_rng(20261017)
    beta = np.concatenate([rng.uniform(-400.0, 800.0, 40),
                           [0.0, 315.0, 337.5, 359.9, 360.0, -0.1, 22.5,
                            -360.0, 720.0, 45.0]])
    return {"regular": np.arange(0.0, 360.0, 45.0),
            "irregular": np.array([10.0, 80.0, 200.0, 300.0])}, beta


@pytest.mark.parametrize("heads", ["regular", "irregular"])
@pytest.mark.parametrize("per_row", [False, True])
def test_interp_heading_rows_matches_jax(heads, per_row):
    """Row-batched wrap-around interpolation and rotation against JAX's
    ``_interp_heading_traced`` at seeded headings (below the first BEM
    heading, past the last, negative, beyond 360), shared or per-row
    coefficients; and against the numpy ``interp_heading``."""
    import jax

    from raft_tpu.api import _interp_heading_traced

    hs, beta = _heading_cases()
    h = hs[heads]
    rng = np.random.default_rng(3)
    R, nH, nw = 25, 2, 5
    shape = ((R,) if per_row else ()) + (len(h), 6, nw)
    X = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    b = beta[:R * nH].reshape(R, nH)
    got = tapi._interp_heading_rows(torch.as_tensor(X), h,
                                    torch.as_tensor(b)).numpy()
    one = jax.vmap(lambda x, bd: _interp_heading_traced(x, h, bd),
                   in_axes=(0 if per_row else None, 0))
    ref = np.stack([np.asarray(one(X, b[:, ih])) for ih in range(nH)], 1)
    near(got, ref, 1e-14, "X")
    for r in range(3):
        Xr = X[r] if per_row else X
        near(got[r, 0], wamit.interp_heading(Xr, h, b[r, 0] % 360), 1e-12,
             "numpy")


def test_lagrange3_matches_jax():
    from raft_tpu.api import _lagrange3 as jlag

    rng = np.random.default_rng(5)
    vals = rng.normal(size=(3, 6, 4)) + 1j * rng.normal(size=(3, 6, 4))
    s = rng.uniform(0.9, 1.1, 7)
    got = tapi._lagrange3(torch.as_tensor(vals), (0.92, 1.0, 1.08),
                          torch.as_tensor(s)).numpy()
    ref = np.stack([np.asarray(jlag(vals, (0.92, 1.0, 1.08), x)) for x in s])
    near(got, ref, 1e-15, "lagrange3")
    at1 = tapi._lagrange3(torch.as_tensor(vals), (0.92, 1.0, 1.08),
                          torch.ones(1, dtype=torch.float64)).numpy()[0]
    np.testing.assert_array_equal(at1, vals[1])


# ---------------------------------------------------------- Green functions

@pytest.mark.parametrize("omega,h", [(0.3, 200.0), (0.9, 50.0), (0.05, 320.0)])
def test_dispersion_roots_and_evan_coeffs_equal_jax(omega, h):
    from raft_tpu.native import green_fd as jfd

    K = omega * omega / 9.81
    k0, km = green_fd.dispersion_roots(K, h, 512)
    jk0, jkm = jfd.dispersion_roots(K, h, 512)
    assert k0 == jk0
    np.testing.assert_array_equal(km, jkm)
    np.testing.assert_array_equal(green_fd._evan_coeffs(km, K, h),
                                  jfd._evan_coeffs(jkm, K, h))
    assert green_fd._prop_factor(k0, K, h, -5.0, -12.0) == \
        jfd._prop_factor(jk0, K, h, -5.0, -12.0)


def test_green_fd_oracles_equal_jax():
    """The series and the PV-integral oracle of the finite-depth Green
    function, which agree with each other."""
    from raft_tpu.native import green_fd as jfd

    K, h = 0.3 ** 2 / 9.81, 200.0
    for Rh, z, zeta in ((15.0, -5.0, -12.0), (60.0, -20.0, -1.0)):
        s = green_fd.green_fd_series(Rh, z, zeta, K, h)
        assert s == jfd.green_fd_series(Rh, z, zeta, K, h)
        r = green_fd.green_fd_reference(Rh, z, zeta, K, h)
        assert r == jfd.green_fd_reference(Rh, z, zeta, K, h)
        assert abs(s - r) <= 1e-4 * abs(r)


def test_pv_nodes_match_jax_and_the_shipped_table():
    """30 seeded table nodes: the port's quadrature equals JAX's and the
    shipped table's entries (within 1e-12 x the table's max)."""
    from raft_tpu.native import green_table as jgt

    t = green_table.build_tables()
    assert t["L"].shape == (green_table.ND, green_table.NA)
    np.testing.assert_array_equal(t["lnd"], jgt.LND)
    np.testing.assert_array_equal(t["alpha"], jgt.ALPHA)
    rng = np.random.default_rng(20261017)
    ii = rng.integers(0, green_table.ND, 30)
    jj = rng.integers(0, green_table.NA, 30)
    for key, order in (("L", 0), ("M", 1)):
        scale = float(np.max(np.abs(t[key])))
        for i, j in zip(ii, jj):
            d = np.exp(green_table.LND[i])
            a = green_table.ALPHA[j]
            R, Z = d * a, -d * np.sqrt(max(0.0, 1.0 - a * a))
            v = green_table._pv_node(order, R, Z)
            assert abs(v - jgt._pv_node(order, R, Z)) <= 1e-12 * scale
            assert abs(v - t[key][i, j]) <= 1e-12 * scale
    x = np.array([0.5, 3.0, 40.0])
    z = np.array([-0.2, -1.0, -7.0])
    assert np.all(np.isfinite(green_table.interp_L(x, z)))


def test_wave_number_matches_jax():
    """The Newton dispersion solve of the deep branch within a few ulp of
    JAX's (its tanh rounds differently)."""
    from raft_tpu.ops.waves import wave_number as jk

    from raft_tpu_torch.ops.waves import wave_number

    w = np.linspace(0.02, 3.0, 300)
    for h in (20.0, 200.0, 1e4):
        np.testing.assert_allclose(wave_number(w, h), np.asarray(jk(w, h)),
                                   rtol=4e-15, atol=0)


# ------------------------------------------------------------ panel solver

def _coarse_mesh():
    g = golden("semi_wind_coarse")
    m = Model(design_path("semi_wind_coarse"))
    mesh = panels.mesh_fowt(m.fowtList[0], n_az=8, dz_max=3.0)
    assert len(mesh[3]) == int(g["n_panels"])
    return mesh


def test_library_builds_into_the_port_and_rebuilds_when_stale(tmp_path,
                                                              monkeypatch):
    """The build goes to ``raft_tpu_torch/build/`` under a name hashed
    from the source and flags; an edited source gets another name."""
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libpanel_bem_")
    src = tmp_path / "panel_bem.cpp"
    src.write_text(open(native.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    assert native.library_path() != path


@pytest.mark.parametrize("mirror", [-1, 1])
def test_radiation_added_mass_matches_jax(mirror, jax_native):
    v, c, n, a = _coarse_mesh()
    got = native.radiation_added_mass(v, c, n, a, mirror=mirror)
    ref = jax_native.radiation_added_mass(v, c, n, a, mirror=mirror)
    near(got, ref, COEF_TOL, "A")


@pytest.mark.parametrize("omega", [0.3, 1.0], ids=["finite_depth", "deep"])
def test_solve_bem_frequency_matches_jax(omega, jax_native):
    """One frequency of each branch at 200 m (K h 1.8 takes the
    finite-depth series, 20.4 the tabulated kernel)."""
    v, c, n, a = _coarse_mesh()
    heads = np.deg2rad(np.arange(0.0, 360.0, 45.0))
    got = native.solve_bem_frequency(v, c, n, a, omega, heads, depth=200.0)
    ref = jax_native.solve_bem_frequency(v, c, n, a, omega, heads,
                                         depth=200.0)
    for x, y, k in zip(got, ref, "ABX"):
        near(x, y, COEF_TOL, k)


def test_solve_bem_does_not_depend_on_the_workers():
    v, c, n, a = panels.mesh_cylinder_capped(
        [0.0, 30.0], [10.0, 10.0], [0.0, 0.0, -20.0], [0, 0, 1.0],
        n_az=8, dz_max=5.0)
    w = [0.2, 0.6, 1.1]
    one = native.solve_bem(v, c, n, a, w, headings_deg=(0.0, 90.0),
                           depth=200.0, workers=1)
    three = native.solve_bem(v, c, n, a, w, headings_deg=(0.0, 90.0),
                             depth=200.0, workers=3)
    for x, y in zip(one, three):
        np.testing.assert_array_equal(x, y)


def test_fd_mode_count_matches_jax():
    from raft_tpu.native import _fd_mode_count as jcount

    for depth, areas in ((200.0, [4.0, 9.0]), (50.0, [0.01, 1.0]),
                         (20.0, [25.0])):
        assert native._fd_mode_count(depth, areas, 512) == \
            jcount(depth, areas, 512)


# ---------------------------------------------------------------- run_bem

def test_run_bem_matches_jax_and_ignores_its_cache(coarse, bem_dir):
    """The coarse copy: the raw solve and the model-grid coefficients
    within 1e-12 x max of JAX's; the port solved (the JAX files in the
    directory were not served) and wrote its own files, which read back
    within 1e-12 x max of JAX's.  (The deep branch's wave number differs
    from JAX's by an ulp, so a 7th digit of a small coefficient may
    differ in the text.)"""
    m, (A, B, X), ours = coarse
    g = golden("semi_wind_coarse")
    for x, k in ((A, "A"), (B, "B"), (X, "X")):
        near(x, g[k], COEF_TOL, "raw " + k)
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        near(m.bem[k], g["coef_" + k], COEF_TOL, k)
    np.testing.assert_array_equal(m.bem["headings"], g["coef_headings"])
    jax_files = os.listdir(JAX_CACHE)
    assert sorted(os.path.splitext(f)[1] for f in ours) == [".1", ".3"]
    assert not set(ours) & set(jax_files)
    read = {".1": wamit.read_wamit1, ".3": wamit.read_wamit3}
    for ext in (".1", ".3"):
        mine = [f for f in ours if f.endswith(ext)][0]
        theirs = [f for f in jax_files if f.endswith(ext)][0]
        a = read[ext](os.path.join(bem_dir, mine))
        b = read[ext](os.path.join(JAX_CACHE, theirs))
        for x, y in zip(a, b):
            near(x, y, COEF_TOL, mine)


def test_run_bem_serves_its_own_cache(coarse, monkeypatch):
    """A second model of the same design reads the port's files without
    solving."""
    def no_solve(*a, **kw):
        raise AssertionError("solved again")

    monkeypatch.setattr(native, "solve_bem", no_solve)
    m = Model(design_path("semi_wind_coarse"))
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        np.testing.assert_array_equal(m.bem[k], coarse[0].bem[k])
    A, B = m.bem_matrices()
    np.testing.assert_array_equal(A, m.bem["A_BEM"])
    np.testing.assert_array_equal(B, m.bem["B_BEM"])


def test_hydro_path_resolves_with_its_suffixes(tmp_path, wamit_model):
    """``hydroPath`` names its files without ``.1``/``.3``: resolved
    against the design's directory or its parent; non-finite file
    coefficients raise."""
    with open(design_path("semi_wind_wamit")) as f:
        d = json.load(f)
    sub = tmp_path / "designs"
    sub.mkdir()
    for ext in (".1", ".3"):
        shutil.copy(os.path.join(FIX, "semi_wind_wamit" + ext), tmp_path)
    m = Model(copy.deepcopy(d), base_dir=str(sub))
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        np.testing.assert_array_equal(m.bem[k], wamit_model.bem[k])
    text = (tmp_path / "semi_wind_wamit.1").read_text().splitlines()
    parts = text[40].split()
    parts[3] = "nan"
    text[40] = " ".join(parts)
    (tmp_path / "semi_wind_wamit.1").write_text("\n".join(text) + "\n")
    with pytest.raises(RuntimeError, match="non-finite A_BEM"):
        Model(copy.deepcopy(d), base_dir=str(tmp_path)).bem


# --------------------------------------------------------------- evaluator

#: evaluator golden sets: (design set, rows tag, headings, geometry)
CASES = {"coarse_h1": ("semi_wind_coarse", "h1", 1, False),
         "coarse_h2": ("semi_wind_coarse", "h2", 2, False),
         "coarse_geometry": ("semi_wind_coarse", "geo", 1, True),
         "wamit_h1": ("semi_wind_wamit", "h1", 1, False)}


def golden_rows(g, tag):
    return {k: g[f"{tag}_{k}"] for k in ROW_KEYS}


#: the geometry axis' set, held in test_torch_bem_geometry.py
GEOMETRY_CASES = ("coarse_geometry",)


def check_evaluator_case(case, coarse, wamit_model, monkeypatch):
    """One golden set, FUSED on and off; on the geometry axis each row
    carries its uniform d_scale (the two off-unit scales solved on first
    use)."""
    name, tag, nW, geometry = CASES[case]
    m = coarse[0] if name == "semi_wind_coarse" else wamit_model
    g = golden(name)
    ev = tapi.make_full_evaluator(m, nWaves=nW, device="cpu",
                                  geometry=geometry)
    kw = golden_rows(g, tag)
    if geometry:
        kw["geom"] = dict(d_scale=g[f"{tag}_d_scale"])
    for fused in ("on", "off"):
        monkeypatch.setenv("RAFT_TPU_FUSED", fused)
        hold(ev(**kw), g, f"{tag}_{fused}_")


@pytest.mark.parametrize("case", sorted(set(CASES) - set(GEOMETRY_CASES)))
def test_evaluator_matches_goldens(case, coarse, wamit_model, monkeypatch):
    check_evaluator_case(case, coarse, wamit_model, monkeypatch)


def test_bem_terms_enter_the_evaluator(coarse):
    """The coefficients move the response (a design whose excitation is
    the BEM's): zeroing them changes every row's Xi; geometry rows at
    unit d_scale solve nothing more and give the design's output."""
    m = coarse[0]
    g = golden("semi_wind_coarse")
    kw = golden_rows(g, "h1")
    ev = tapi.make_full_evaluator(m, device="cpu")
    out = ev(**kw)
    geo = tapi.make_full_evaluator(m, device="cpu", geometry=True)
    out1 = geo(geom=dict(d_scale=1.0), **kw)
    assert geo._bem_tab is None
    for k in ("X0", "Xi", "PSD"):
        near(out1[k].numpy(), out[k].numpy(), TOL, k)
    ev.bem_t = {k: torch.zeros_like(v) for k, v in ev.bem_t.items()}
    out0 = ev(**kw)
    diff = (out0["Xi"] - out["Xi"]).abs().flatten(1).amax(1)
    assert bool(torch.all(diff > 0))


def test_bem_refusals(coarse, wamit_model):
    """What the reference refuses: geometry with file coefficients, a
    d_scale that differs between members, bad sample scales; the bucket,
    case and design paths.  A d_scale that requires grad (refused until
    its gradient was ported) gives a finite gradient, nonzero at 1."""
    from raft_tpu_torch.structure import bucketing as tb

    m = coarse[0]
    with pytest.raises(ValueError, match="WAMIT"):
        tapi.make_full_evaluator(wamit_model, device="cpu", geometry=True)
    geo = tapi.make_full_evaluator(m, device="cpu", geometry=True)
    nM = geo.n_members
    ds = np.ones((2, nM))
    ds[1, 0] = 1.05
    with pytest.raises(ValueError, match="uniform d_scale"):
        geo(geom=dict(d_scale=ds), Hs=4.0, Tp=10.0)
    d = torch.ones(2, dtype=torch.float64, requires_grad=True)
    out = geo(geom=dict(d_scale=d), Hs=4.0, Tp=10.0)
    g, = torch.autograd.grad((out["Xi"][:, 0].abs() ** 2).sum(), d)
    assert bool(torch.isfinite(g).all()) and bool(torch.all(g != 0))
    for scales in ((0.9, 1.0), (0.9, 1.0, 1.0)):
        bad = copy.copy(m)
        bad.design = dict(m.design, settings=dict(m.design["settings"],
                                                  bem_geom_scales=scales))
        with pytest.raises(ValueError, match="bem_geom_scales"):
            tapi.make_full_evaluator(bad, device="cpu", geometry=True)
    for mk in (lambda: tb.bucket_signature(m),
               lambda: tapi.make_case_evaluator(m, device="cpu"),
               lambda: tapi.make_design_evaluator(wamit_model, device="cpu")):
        with pytest.raises(tb.UnbucketableDesignError, match="potential"):
            mk()


def test_farm_and_flexible_refuse_potential_flow():
    """The reference's farm and flexible evaluators refuse potential-flow
    designs; neither runs the panel solver to do so."""
    with open(os.path.join(FIX, "design_farm_spar3.json")) as f:
        farm = json.load(f)
    farm["platform"]["potModMaster"] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tapi.make_farm_evaluator(Model(farm, base_dir=FIX), device="cpu")
    with open(os.path.join(FIX, "design_semi_wind_flex.json")) as f:
        flex = json.load(f)
    flex["platform"]["potModMaster"] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tapi.make_flexible_evaluator(Model(flex), device="cpu")


# -------------------------------------------------------------------- slow

@pytest.mark.slow
def test_green_table_rebuild_equals_shipped(tmp_path):
    """The whole table rebuilt (minutes of quadrature, spread over worker
    processes) equals the shipped file."""
    t = green_table.build_tables(rebuild=True, path=str(tmp_path / "t.npz"))
    with np.load(green_table.TABLE) as s:
        for k in ("lnd", "alpha", "L", "M"):
            np.testing.assert_array_equal(t[k], s[k], err_msg=k)


@pytest.mark.slow
def test_full_mesh_matches_live_jax(tmp_path, monkeypatch):
    """The full mesh (684 panels): the port's run_bem against JAX's live
    (raw and model-grid coefficients, 1e-12 x max) and the evaluator's
    golden rows against the live JAX evaluator."""
    import jax

    from raft_tpu.api import make_full_evaluator as jmake

    monkeypatch.setenv("RAFT_TPU_BEM_DIR", str(tmp_path))
    jm = jax_model("semi_wind")
    jb = jm.bem
    m = Model(design_path("semi_wind"))
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        near(m.bem[k], jb[k], COEF_TOL, k)
        near(m.bem[k], golden("semi_wind")["coef_" + k], COEF_TOL, k)
    g = golden("semi_wind")
    rows = golden_rows(g, "h1")
    ref = jax.jit(jax.vmap(jmake(jm)))(rows)
    out = tapi.make_full_evaluator(m, device="cpu")(**rows)
    hold(out, {k: np.asarray(v) for k, v in ref.items()}, "")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["semi_wind_coarse", "semi_wind"])
def test_grad_bem_fixture_regenerates(name):
    """The d_scale gradient goldens (the coarse copy's, held here, and
    the full mesh's, held by chip_smoke.py), rebuilt through jax.grad
    (and checked against jax.jacfwd), equal the checked-in files (the
    full mesh's about 25 min: three JAX panel solves)."""
    import sys

    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    new = mk.build_grad_bem_golden(name)
    old = dict(np.load(os.path.join(FIX, f"golden_grad_bem_{name}.npz")))
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
