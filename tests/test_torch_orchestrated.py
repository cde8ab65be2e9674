"""The port's orchestrated path (``Model.analyze_cases``, ``calc_outputs``,
``solve_eigen``, ``write_modes_json``) against the JAX Model.

Goldens: ``golden_orch_<set>.npz``, the JAX ``analyze_cases`` and
``calc_outputs`` of each design on the CPU with x64, written by
``tests/make_torch_port_fixtures.py --orchestrated`` (the fast tier
traces no JAX).  The port runs the same designs on the CPU.

Gates:

* rigid designs: every ``case_metrics`` key within 1e-10 x its scale.
  A key's scale is the largest magnitude over its family and kind in
  the same case and FOWT (:func:`key_scale`): the three translations,
  the three rotations, the three nacelle accelerations and the base
  force and moment components each form one family; mean, max and min
  are one kind, std, PSD and RA one each.  A channel that is zero in
  the physics (sway in head seas) is rounding noise in both packages
  (1e-16 of its family), so its own magnitude is no scale;
* mean offsets within 1e-10 x their max, the properties within 1e-10 x
  each one's max; ``statics_status`` and every FOWT's ``dyn_status``,
  ``n_iter_drag`` and ``drag_converged`` bit-equal, ``drag_resid``
  within 1e-10;
* the flexible design: the keys at kappa(Z) eps and the mean offsets
  at kappa(K) eps, as ``tests/test_torch_flexible.py`` holds its keys;
* eigenfrequencies within 1e-10 relative; the modes as the projector
  onto each eigenspace of equal frequency (a simple one is its mode up
  to scale and sign), within 1e-8: rounding may turn the eigenvectors
  inside a degenerate pair (the spar's surge and sway) and the
  DOF-claiming sort may then swap the pair's columns (ROADMAP §C).  The
  flexible design's frequencies at kappa(K) eps (its unloaded
  equilibrium, whose mooring stiffness enters the eigenproblem, is held
  there), its near-degenerate modes grouped (:data:`FLEX_CLUSTER`);
* the CSV: the same rows and channels, each number within one unit of
  its last printed digit, or 1e-10 x its family's largest;
* the modes JSON written from the golden's modes: the same layout,
  every number within 1e-10 x the file's max; the ``.4`` / ``.12d``
  checkpoints of the slender-body QTF loop, printed to 7 digits: the
  same rows, each number within one unit of its last digit or 1e-10 x
  its column's max, phases only where the magnitude is not rounding
  noise (:func:`hold_checkpoint`).

Slow tier: one golden rebuilt by the live JAX Model.
"""

import json
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from raft_tpu_torch.models.model import Model

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
TOL = 1e-10
EIG_TOL = 1e-10
MODE_TOL = 1e-8
#: the flexible design's eigenspaces: modes whose frequencies lie within
#: 1e-4 of each other form one (its surge and sway, 9e-6 apart: the
#: rotor breaks the symmetry), held at 1e-5 (its frequencies move by
#: up to 1.5e-7, the rounding of its unloaded equilibrium)
FLEX_CLUSTER = 1e-4
FLEX_MODE_TOL = 1e-5
EPS = float(np.finfo(np.float64).eps)
#: the flexible gates of tests/test_torch_flexible.py: kappa(Z) eps for
#: what passes the response solves, kappa(K) eps for the mean offsets
FLEX_GATE = 2.72e10 * EPS
FLEX_X0_GATE = 2.80e9 * EPS
#: orchestrated golden sets (the farm's and the moorMod ones run in
#: their own files)
SETS = ("spar", "semi", "mhk", "semi_wind_cases", "mhk_tidal",
        "mhk_tidal_cav", "semi_wind_flex", "semi_wind_wamit",
        "semi_wind_qtf", "semi_wind_slender")
DESIGN_FILES = {"semi_wind_cases": "design_semi_wind_cases.json",
                "farm_semi_wind": "design_farm_semi_wind_cases.json"}
FAMILIES = (("surge", "sway", "heave"), ("roll", "pitch", "yaw"),
            ("AxRNA", "AyRNA", "AzRNA"), ("FbaseX", "FbaseY", "FbaseZ"),
            ("MbaseX", "MbaseY", "MbaseZ"))
KIND = {"avg": "level", "max": "level", "min": "level"}
EXACT = ("dyn_status", "n_iter_drag", "drag_converged")

_RUNS = {}


def design(name, qtf_dir=None):
    path = os.path.join(FIX, DESIGN_FILES.get(name, f"design_{name}.json"))
    with open(path) as f:
        d = json.load(f)
    if qtf_dir is not None:
        d["platform"]["outFolderQTF"] = str(qtf_dir)
    return d


def golden(name):
    return dict(np.load(os.path.join(FIX, f"golden_orch_{name}.npz")))


def run(name, qtf_dir=None, outputs=True):
    """The port's Model of a set after ``analyze_cases`` (and
    ``calc_outputs``) on the CPU, made once per set."""
    if qtf_dir is not None or name not in _RUNS:
        model = Model(design(name, qtf_dir), base_dir=FIX)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.analyze_cases(device="cpu")
            if outputs:
                model.calc_outputs(device="cpu")
        if qtf_dir is not None:
            return model
        _RUNS[name] = model
    return _RUNS[name]


def _split(key):
    """(case/fowt prefix, channel, suffix) of a golden metrics key
    ``m<case>_<fowt>_<channel>_<suffix>``."""
    c, f, rest = key.split("_", 2)
    ch, _, suf = rest.rpartition("_")
    if not ch:
        ch, suf = rest, ""
    return f"{c}_{f}", ch, suf


def key_scale(g, key):
    """The scale a metrics key is held at: the largest magnitude over
    the keys of its family and kind in the same case and FOWT."""
    pre, ch, suf = _split(key)
    fam = next((f for f in FAMILIES if ch in f), (ch,))
    kind = KIND.get(suf, suf)
    scale = 0.0
    for k, v in g.items():
        if not k.startswith("m") or not k.startswith(pre + "_"):
            continue
        p2, c2, s2 = _split(k)
        if (c2 in fam and KIND.get(s2, s2) == kind and v.size
                and v.dtype.kind in "fc"):
            scale = max(scale, float(np.max(np.abs(v))))
    return scale


def close(a, b, tol, scale=None, what=""):
    """Assert max |a - b| <= tol x scale (default: max |b|); returns
    the error over the scale."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if not b.size:
        return 0.0
    if scale is None:
        scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * max(scale, 1e-300), \
        f"{what}: {err:.3e} > {tol} x {scale:.3e}"
    return err / max(scale, 1e-300)


def golden_cases(g, n):
    """A golden cut to its first ``n`` cases: their metrics keys, mean
    offsets, status words, drag diagnostics and CSV rows (a run of the
    first ``n`` rows of the design's case table is held against it)."""
    per_case = ("mean_offsets", "statics_status", "drag_resid") + EXACT
    out = {}
    for k, v in g.items():
        m = re.match(r"m(\d+)_\d+_", k)
        if m and int(m.group(1)) >= n:
            continue
        out[k] = v[:n] if k in per_case else v
    rows = g["csv"].item().strip().split("\n")
    out["csv"] = np.asarray("\n".join(
        [rows[0]] + [r for r in rows[1:] if int(r.split(",")[0]) < n])
        + "\n")
    return out


def hold_results(model, g, flex=False):
    """Every case metric, the mean offsets, the status words and the
    drag diagnostics of a port run against a golden; returns the worst
    error over its gate's scale."""
    res = model.results
    tol = FLEX_GATE if flex else TOL
    keys = set()
    worst = 0.0
    for ic, per in res["case_metrics"].items():
        for i, met in per.items():
            for k, v in met.items():
                gk = f"m{ic}_{i}_{k}"
                keys.add(gk)
                assert gk in g, f"{gk} is not in the golden"
                worst = max(worst, close(v, g[gk], tol, key_scale(g, gk), gk))
    assert keys == {k for k in g if re.match(r"m\d+_\d+_", k)}
    worst = max(worst, close(np.stack(res["mean_offsets"]),
                             g["mean_offsets"],
                             FLEX_X0_GATE if flex else TOL,
                             what="mean_offsets"))
    np.testing.assert_array_equal(res["statics_status"], g["statics_status"])
    for k in EXACT + ("drag_resid",):
        got = np.asarray([[dd["status" if k == "dyn_status" else k]
                           for dd in per] for per in res["dyn_diag"]])
        if k in EXACT:
            np.testing.assert_array_equal(got, g[k], err_msg=k)
        else:
            worst = max(worst, close(got, g[k], tol, what=k))
    return worst


def _csv_family(channel):
    if channel.startswith("Tmoor"):
        return "Tmoor"
    return next((f for f in FAMILIES if channel in f), (channel,))[0]


def hold_csv(text, want):
    """Same rows and channels; each number within one unit of its last
    printed digit (six after the point of the mantissa: two values a
    rounding apart may print one unit apart) or within
    1e-10 x the largest number of its family (the translations, the
    rotations, the line tensions) in the same case and FOWT."""
    got_rows = text.strip().split("\n")
    want_rows = want.strip().split("\n")
    assert len(got_rows) == len(want_rows)
    assert got_rows[0] == want_rows[0]
    scale = {}
    for b in want_rows[1:]:
        fb = b.split(",")
        key = (fb[0], fb[1], _csv_family(fb[2]))
        scale[key] = max([scale.get(key, 0.0)]
                         + [abs(float(x)) for x in fb[3:]])
    for a, b in zip(got_rows[1:], want_rows[1:]):
        fa, fb = a.split(","), b.split(",")
        assert fa[:3] == fb[:3], (a, b)
        fam = scale[(fb[0], fb[1], _csv_family(fb[2]))]
        for x, y in zip(fa[3:], fb[3:]):
            x, y = float(x), float(y)
            ulp = 1e-6 * 10 ** np.floor(np.log10(abs(y))) if y else 0.0
            assert abs(x - y) <= max(ulp * (1 + 1e-9), TOL * fam), (a, b)


def _numbers(text):
    return np.asarray([float(t) for t in re.findall(
        r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", text)])


def hold_json_numbers(text, want, what):
    """The same JSON layout (every key, list length and string) and every
    number within 1e-10 x the document's largest."""
    a, b = json.loads(text), json.loads(want)
    na, nb = [], []

    def walk(x, y, path):
        if isinstance(y, dict):
            assert isinstance(x, dict) and sorted(x) == sorted(y), path
            for k in y:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(y, list):
            assert isinstance(x, list) and len(x) == len(y), path
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(y, (int, float)) and not isinstance(y, bool):
            na.append(float(x))
            nb.append(float(y))
        else:
            assert x == y, path

    walk(a, b, what)
    close(na, nb, TOL, what=what)


def _printed_unit(v):
    """One unit of the last digit of a number printed as ``%.6e``."""
    v = np.abs(v)
    return np.where(v > 0, 1e-6 * 10.0 ** np.floor(np.log10(
        np.where(v > 0, v, 1.0))), 0.0)


def hold_checkpoint(text, want, what, mag_col):
    """A WAMIT ``.4`` (``mag_col`` 3) or ``.12d`` (5) checkpoint: the same
    rows and index columns (period, heading, DoF), and the magnitude,
    real and imaginary parts within one unit of their last printed
    digit or 1e-10 x their column's largest.  The phase is held, modulo
    2 pi, only where the magnitude is above 1e-6 of its largest: a
    rounding-noise entry has no phase."""
    a, b = np.loadtxt(text.splitlines()), np.loadtxt(want.splitlines())
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a[:, :mag_col], b[:, :mag_col],
                                  err_msg=what)
    for c in (mag_col, mag_col + 2, mag_col + 3):
        gate = np.maximum(_printed_unit(b[:, c]),
                          TOL * np.max(np.abs(b[:, c])))
        assert np.all(np.abs(a[:, c] - b[:, c]) <= gate), (what, c)
    big = b[:, mag_col] > 1e-6 * np.max(b[:, mag_col])
    dph = np.angle(np.exp(1j * (a[big, mag_col + 1] - b[big, mag_col + 1])))
    assert np.all(np.abs(dph) <= 2e-6), what


def eigenspaces(fns, modes, rel=1e-9):
    """Groups of columns with equal frequency (to ``rel``) and the
    orthogonal projector onto each group's span."""
    order = np.argsort(fns)
    groups, cur = [], [order[0]]
    for i in order[1:]:
        if abs(fns[i] - fns[cur[-1]]) <= rel * abs(fns[cur[-1]]):
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    groups.append(cur)
    out = []
    for grp in groups:
        V = np.asarray(modes)[:, grp]
        P = V @ np.linalg.solve(V.conj().T @ V, V.conj().T)
        out.append((sorted(grp), P))
    return out


def hold_eigen(fns, modes, g_fns, g_modes, flex=False):
    """The eigenfrequencies relative to the golden's and the modes as
    eigenspace projectors; returns the frequencies' worst error over
    their gate's scale."""
    worst = close(fns / g_fns, np.ones_like(g_fns),
                  FLEX_X0_GATE if flex else EIG_TOL, scale=1.0,
                  what="eigen frequencies")
    rel, tol = (FLEX_CLUSTER, FLEX_MODE_TOL) if flex else (1e-9, MODE_TOL)
    got = eigenspaces(fns, modes, rel)
    want = eigenspaces(g_fns, g_modes, rel)
    assert [len(a) for a, _ in got] == [len(a) for a, _ in want]
    for (_, P), (_, Q) in zip(got, want):
        close(P, Q, tol, scale=1.0, what="eigenspace projector")
    return worst


def hold_outputs(model, g, flex=False):
    """calc_outputs' properties within 1e-10 x each one's max (kappa(K)
    eps on the flexible design) and its eigen outputs by
    :func:`hold_eigen`; returns the worst error over its gate's scale."""
    props = model.results["properties"]
    assert sorted(f"prop_{k}" for k in props) == sorted(
        k for k in g if k.startswith("prop_"))
    worst = 0.0
    for k, v in props.items():
        worst = max(worst, close(v, g[f"prop_{k}"],
                                 FLEX_X0_GATE if flex else TOL, what=k))
    eig = model.results["eigen"]
    return max(worst, hold_eigen(eig["frequencies"], eig["modes"],
                                 g["eig_frequencies"], g["eig_modes"],
                                 flex=flex))


# --------------------------------------------------------------- goldens

@pytest.mark.parametrize("name", SETS)
def test_analyze_cases_matches_golden(name):
    """analyze_cases on the CPU against the JAX Model's, every key and
    the diagnostics at the module's gates."""
    hold_results(run(name), golden(name), flex=name.endswith("flex"))


@pytest.mark.parametrize("name", SETS)
def test_calc_outputs_matches_golden(name):
    """The properties within 1e-10 x each one's max (kappa(K) eps on the
    flexible design, whose unloaded equilibrium passes its statics
    solves); the eigenfrequencies within 1e-10 relative, the modes as
    eigenspace projectors."""
    hold_outputs(run(name), golden(name), flex=name.endswith("flex"))


@pytest.mark.parametrize("name", ("spar", "semi_wind_cases", "mhk_tidal",
                                  "semi_wind_flex"))
def test_csv_and_modes_json(name, tmp_path):
    """save_responses' CSV against the golden's; write_modes_json of the
    golden's own frequencies and modes against the golden's JSON."""
    from raft_tpu_torch.drivers import save_responses

    model, g = run(name), golden(name)
    path = tmp_path / "out.csv"
    save_responses(model, path)
    hold_csv(path.read_text(), g["csv"].item())
    mj = tmp_path / "modes.json"
    model.write_modes_json(mj, g["eig_frequencies"], g["eig_modes"])
    hold_json_numbers(mj.read_text(), g["modes_json"].item(), "modes json")


def test_slender_checkpoints(tmp_path):
    """The potSecOrder 1 loop writes the reference's checkpoint files to
    outFolderQTF (the case number in the names): the same files, each
    held by :func:`hold_checkpoint`; the run itself as the golden's."""
    g = golden("semi_wind_slender")
    model = run("semi_wind_slender", qtf_dir=tmp_path, outputs=False)
    want = sorted(k[5:] for k in g if k.startswith("ckpt_"))
    assert sorted(os.listdir(tmp_path)) == want
    assert any(n.endswith(".4") for n in want)
    assert any(n.endswith(".12d") for n in want)
    for fn in want:
        hold_checkpoint((tmp_path / fn).read_text(), g[f"ckpt_{fn}"].item(),
                        fn, 3 if fn.endswith(".4") else 5)
    hold_results(model, g)


# ------------------------------------------------------------ behaviour

def test_case_results_do_not_depend_on_case_order():
    """Each case of the 4-case table run alone, in reverse order, on a
    fresh model, gives its golden: the current loads and mean rotor
    loads come from the zero pose, never from an earlier case's, and
    the aero cache keys on the case's wind and current."""
    g = golden("semi_wind_cases")
    model = Model(design("semi_wind_cases"), base_dir=FIX)
    cases = list(model.cases)
    for ic in reversed(range(len(cases))):
        model.cases = [cases[ic]]
        model.analyze_cases(device="cpu")
        for k, v in model.results["case_metrics"][0][0].items():
            gk = f"m{ic}_0_{k}"
            close(v, g[gk], TOL, key_scale(g, gk), gk)
        close(model.results["mean_offsets"][0], g["mean_offsets"][ic], TOL,
              what="mean offsets")
    # the idle case takes no aero; the last case repeats the first's
    # wind and current, so it shares the first's entry
    assert len(model._aero_cache) == 2


def test_golden_cut_to_its_first_cases(tmp_path):
    """A run of the first two rows of the 4-case table holds against the
    golden cut to its first two cases (the card's smoke test runs the
    farm's first case alone so): their keys, per-case arrays and CSV
    rows, none of the later cases'."""
    from raft_tpu_torch.drivers import save_responses

    cut = golden_cases(golden("semi_wind_cases"), 2)
    assert {k.split("_")[0] for k in cut if re.match(r"m\d+_", k)} == \
        {"m0", "m1"}
    assert len(cut["mean_offsets"]) == 2 and cut["n_iter_drag"].shape[0] == 2
    d = design("semi_wind_cases")
    d["cases"]["data"] = d["cases"]["data"][:2]
    model = Model(d, base_dir=FIX)
    model.analyze_cases(device="cpu")
    hold_results(model, cut)
    save_responses(model, tmp_path / "cut.csv")
    hold_csv((tmp_path / "cut.csv").read_text(), cut["csv"].item())


def test_two_headings_and_idle():
    """The two-heading case has three excitation sources; the idle case
    has no rotor terms (zero mean thrust, no rotor channels)."""
    model = run("semi_wind_cases")
    met = model.results["case_metrics"]
    assert met[3][0]["surge_RA"].shape[0] == 3
    assert met[2][0]["omega_avg"][0] == 0.0
    assert met[0][0]["omega_avg"][0] > 0.0


def test_cavitation_margins():
    """The cpmin design carries the cavitation margins per (azimuth,
    element); the same rotor without cpmin carries none."""
    g = golden("mhk_tidal_cav")
    cav = run("mhk_tidal_cav").results["case_metrics"][0][0]["cavitation"]
    rot = run("mhk_tidal_cav").rotor_aero[0]
    assert cav.shape == (rot.nSector, len(rot.r))
    close(cav, g["m0_0_cavitation"], TOL, what="cavitation")
    assert "cavitation" not in run("mhk_tidal").results["case_metrics"][0][0]


def test_statics_warning_text(monkeypatch):
    """A Newton stopped by its budget warns with the reference's text
    and sets the status word."""
    import raft_tpu_torch.models.statics_solve as ss

    orig = ss.solve_equilibrium_general
    monkeypatch.setattr(ss, "solve_equilibrium_general",
                        lambda *a, **k: orig(*a, **dict(k, max_iter=1)))
    model = Model(design("spar"), base_dir=FIX)
    with pytest.warns(UserWarning, match=r"solveStatics Newton did not "
                                         r"converge within 1 iterations"):
        model.solve_statics(model.cases[0], device="cpu")
    assert model.statics_status != 0


def test_drag_warning_text():
    """A drag linearisation stopped by its cap warns with the
    reference's text, naming the FOWT."""
    model = Model(design("spar"), base_dir=FIX)
    model.nIter = 0
    with pytest.warns(UserWarning, match=r"solveDynamics drag linearisation "
                                         r"did not converge to tolerance "
                                         r"\(residual .*\) for FOWT 0"):
        model.solve_dynamics(model.cases[0], device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    """No card and no device: every entry point raises naming
    device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(design("spar"), base_dir=FIX)
    case = model.cases[0]
    for call in (lambda: model.solve_statics(case),
                 lambda: model.solve_dynamics(case),
                 lambda: model.solve_eigen(case), model.calc_outputs,
                 model.analyze_cases):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_module_functions_raise_without_cuda(monkeypatch):
    """No card and no device: the public functions under the entry
    points (the outputs, the tension statistics, the case-setup aero and
    the cavitation margins, the density driver) raise naming
    device="cpu" too, rather than run on the CPU."""
    from raft_tpu_torch.drivers import adjust_ballast_density
    from raft_tpu_torch.models.outputs import (mooring_tension_vector,
                                               tension_stats,
                                               turbine_outputs)
    from raft_tpu_torch.physics.aero import calc_aero, calc_cavitation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spar = Model(design("spar"), base_dir=FIX)
    cav = Model(design("mhk_tidal_cav"), base_dir=FIX)
    rot, rprops = cav.rotor_aero[0], cav.fowtList[0].rotors[0]
    for call in (
            lambda: mooring_tension_vector(spar.ms, np.zeros((1, 6))),
            lambda: tension_stats(spar.ms, np.zeros(6)),
            lambda: turbine_outputs(spar, spar.cases[0], np.zeros(6), None,
                                    None, None, None),
            lambda: calc_aero(rot, rprops, cav.cases[0], cav.w,
                              current=True),
            lambda: calc_cavitation(rot, rprops, cav.cases[0]),
            lambda: adjust_ballast_density(design("spar"))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_solve_path_by_size():
    """The system response goes to the solve kernel's dispatch up to 12
    DOFs and to torch.linalg.solve above (the flexible design, nDOF
    168): the per-case statistics name the system's size and each
    FOWT's fixed-point solves (trips plus the final one)."""
    from raft_tpu_torch.ops import linsolve

    for name in ("spar", "semi_wind_flex"):
        model = run(name)
        st = model.case_stats[0]
        n = st["system_n"]
        assert n == model.nDOF
        assert (linsolve.solver_path(n) == "lapack") == (n > 12)
        dd = model.results["dyn_diag"][0]
        assert st["fixed_point_solves"][0] >= dd[0]["n_iter_drag"] + 1


def test_z_extra_keeps_existing_bits():
    """solve_dynamics_fowt without Z_extra gives the bits of before (the
    impedance untouched); a zero Z_extra gives the same bits; a nonzero
    one moves the response."""
    from raft_tpu_torch.models.dynamics import solve_dynamics_fowt

    model = Model(design("spar"), base_dir=FIX)
    fh = model.hydro[0]
    dev = torch.device("cpu")
    X0 = model.solve_statics(model.cases[0], device=dev)
    pose = fh.pose(X0, dev)
    exc = fh.hydro_excitation(pose, model.cases[0])
    stat = model.statics()
    d = fh._on(dev)
    kw = dict(dtype=torch.float64)
    M = torch.as_tensor(stat["M_struc"][:, :, None] + fh.hc0["A_hydro"][
        :, :, None] + np.zeros((6, 6, model.nw)), **kw)[None]
    B = torch.zeros_like(M)
    C = torch.as_tensor(stat["C_struc"] + stat["C_hydro"], **kw)[None]
    w = torch.as_tensor(model.w, **kw)
    args = (d["site"], d["ss"], pose.hc, exc["u"][0], M, B, C,
            exc["F_hydro_iner"][0][None], w, pose.Tn, pose.r_nodes)
    Z0, X0_, _, d0 = solve_dynamics_fowt(*args)
    Zz, Xz, _, dz = solve_dynamics_fowt(
        *args, Z_extra=torch.zeros_like(Z0))
    assert torch.equal(Z0, Zz) and torch.equal(X0_, Xz)
    assert torch.equal(d0["n_iter_drag"], dz["n_iter_drag"])
    extra = torch.zeros_like(Z0)
    extra[..., 0, 0] = 1e5
    _, Xe, _, _ = solve_dynamics_fowt(*args, Z_extra=extra)
    assert not torch.equal(Xe, X0_)


# ----------------------------------------------------------- slow tier

@pytest.mark.slow
def test_orch_golden_regenerates():
    """One orchestrated golden (spar) rebuilt by the live JAX Model
    equals the checked-in file."""
    sys.path.insert(0, HERE)
    import make_torch_port_fixtures as mk

    new = mk.build_orch_golden("spar")
    old = golden("spar")
    assert sorted(new) == sorted(old)
    for k in old:
        np.testing.assert_array_equal(new[k], old[k], err_msg=k)
