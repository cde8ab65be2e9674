"""Tests of the port that need a CUDA device (marker ``cuda``).

They skip here, with a reason, where there is no card.  This file
imports no JAX, so it also runs on a machine that has only PyTorch; run
it there without the repository's conftest (which imports JAX)::

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are the kernel-vs-plain ones of ``chip_smoke.py``: float64
bit-equal (both designs follow the plain version's operation order under
--fmad=false), float32 within 1e-5 x max|x| (the forward and the
adjoint entry alike); the slice, the design, the full and the geometry
evaluator and the farm evaluator within 1e-10 x max of the JAX
goldens with ``status`` and ``n_iter_drag`` equal (the full evaluator
on the potential-flow and external-QTF designs too); the slender-body
QTF within 1e-10 x max|qtf|; reverse-mode gradients within 1e-9 x
each key's max|g| of the JAX goldens, forward-mode tangents within 1e-9
x each key's max|tangent| (the solve's tangent bit-equal to the plain
version on its right-hand side, and jacfwd's directions one launch);
the orchestrated path's case metrics at the gates of
``tests/test_torch_orchestrated.py``; a served row bit-equal to a direct
bucket-evaluator call on the padded group that served it; a fresh
process on a warmed program bank bit-equal to this process's calls,
with no nvcc run; two fleet replicas on the card behind a router
bit-equal to each other and within 1e-10 x max of the JAX serving
engine's goldens.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.api import (ENV_KEYS, FARM_OUT_KEYS, FULL_OUT_KEYS,
                                SEA_KEYS, make_design_evaluator,
                                make_farm_evaluator, make_full_evaluator)
from raft_tpu_torch.models import dynamics
from raft_tpu_torch.models.model import Model
from raft_tpu_torch.ops import linsolve
from raft_tpu_torch.structure import bucketing as tb

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solve kernel has no CPU "
                    "mode (on the card: PYTHONPATH=. python -m pytest "
                    "--noconftest tests/test_torch_cuda.py)")
    return torch.device("cuda")


def systems(N, lead, nw, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=lead + (N, N))
    M = M @ np.swapaxes(M, -1, -2) + N * np.eye(N)
    C = rng.normal(size=lead + (N, N))
    C = C @ np.swapaxes(C, -1, -2) + N * np.eye(N)
    B = rng.normal(size=lead + (N, N))
    B = 0.05 * B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(N)
    w = np.linspace(0.01, 2.0, nw)[:, None, None]
    Z = (-(w ** 2) * M[..., None, :, :] + 1j * w * B[..., None, :, :]
         + C[..., None, :, :])
    F = rng.normal(size=Z.shape[:-1]) + 1j * rng.normal(size=Z.shape[:-1])
    return torch.as_tensor(Z), torch.as_tensor(F)


NS = [1, 2, 3, 6, 7, 8, 9, 10, 11, 12]
DTYPES = [(torch.complex128, 0.0), (torch.complex64, 1e-5)]


def _launches():
    return (linsolve.KERNEL_LAUNCHES, linsolve.ADJ_KERNEL_LAUNCHES,
            linsolve.ROW_KERNEL_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_kernel_matches_plain(cuda, N, dtype, tol):
    Z, F = systems(N, (3,), 41, N)      # 123 systems: not a block multiple
    Z, F = Z.to(dtype).to(cuda), F.to(dtype).to(cuda)
    fwd, adj, rows = _launches()
    x_k = linsolve.solve(Z, F)
    torch.cuda.synchronize()
    row = int(N >= linsolve.ROW_MIN_N)
    assert _launches() == (fwd + 1, adj, rows + row)
    x_p = linsolve._native_solve(Z, F)
    scale = float(torch.max(torch.abs(x_p)))
    assert float(torch.max(torch.abs(x_k - x_p))) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("N", [7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_row_kernel_layouts(cuda, N, dtype, tol):
    """The N = 7-12 design on a ragged batch (not a multiple of its
    8-system tile), a broadcast Z (nw, N, N) against F (nH, nw, N), and
    a non-contiguous F, forward and adjoint, against the plain
    version."""
    Z, F = systems(N, (), 13, 50 + N)
    Z, F = Z.to(dtype).to(cuda), F.to(dtype).to(cuda)
    H = torch.as_tensor(np.random.default_rng(N).normal(
        size=(3, 13, 2 * N, 2))).to(cuda)
    H = torch.complex(H[..., 0], H[..., 1]).to(dtype)
    G = H[..., :N].contiguous()
    cases = {"ragged": (Z, F),
             "broadcast": (Z, G),
             "noncontiguous": (Z[None].expand(3, 13, N, N).contiguous(),
                               H[..., ::2])}
    for name, (z, f) in cases.items():
        for adjoint in (False, True):
            x_k = linsolve._cuda_solve_rows(z, f, adjoint=adjoint)
            x_p = linsolve._native_solve(z.mH if adjoint else z, f)
            torch.cuda.synchronize()
            assert x_k.shape == x_p.shape, name
            scale = float(torch.max(torch.abs(x_p)))
            assert float(torch.max(torch.abs(x_k - x_p))) <= tol * scale, \
                (name, adjoint)


@pytest.mark.cuda
def test_kernel_broadcast_layout(cuda):
    """Z (nw, N, N) against F (nH, nw, N), the system_response layout."""
    Z, _ = systems(6, (), 17, 4)
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 17, 6))
                        + 0j)
    x_k = linsolve.solve(Z.to(cuda), F.to(cuda))
    x_p = linsolve._native_solve(Z, F)
    assert x_k.shape == (3, 17, 6)
    assert float(torch.max(torch.abs(x_k.cpu() - x_p))) <= \
        1e-12 * float(torch.max(torch.abs(x_p)))


@pytest.mark.cuda
def test_kernel_wrapper_rejects(cuda):
    Z = torch.eye(6, dtype=torch.complex128, device=cuda)[None]
    F = torch.ones(1, 6, dtype=torch.complex128, device=cuda)
    with pytest.raises(TypeError):
        linsolve._cuda_solve(Z.real, F.real)
    with pytest.raises(TypeError):
        linsolve._cuda_solve(Z, F.to(torch.complex64))
    with pytest.raises(ValueError):
        linsolve._cuda_solve(torch.eye(13, dtype=torch.complex128,
                                       device=cuda)[None],
                             torch.ones(1, 13, dtype=torch.complex128,
                                        device=cuda))
    Z9 = torch.eye(9, dtype=torch.complex128, device=cuda)[None]
    F9 = torch.ones(1, 9, dtype=torch.complex128, device=cuda)
    with pytest.raises(ValueError):
        linsolve._cuda_solve_rows(Z, F)          # N = 6: the SoA design's
    with pytest.raises(ValueError):              # the raw launch: strided
        linsolve.launch_rows(Z9.transpose(-1, -2), F9, torch.empty_like(F9))


@pytest.mark.cuda
def test_bucket_on_card_matches_goldens(cuda):
    """The MHK bucket's golden rows on the card, FUSED on, float64."""
    p = tb.load_packed(os.path.join(FIX, "packed_mhk.npz"))
    g = np.load(os.path.join(FIX, "golden_mhk.npz"))
    n = len(g["Hs"])
    d = tb.packed_from_numpy(tb.stack_packed([p.leaves] * n), cuda)
    before = linsolve.KERNEL_LAUNCHES
    with torch.no_grad():
        out = tb.BucketEvaluator(p.sig, cuda)(
            d, torch.as_tensor(g["Hs"]), torch.as_tensor(g["Tp"]),
            torch.as_tensor(g["beta"]))
    assert linsolve.KERNEL_LAUNCHES > before
    for k in tb.OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spar", "semi", "mhk"])
def test_design_on_card_matches_goldens(cuda, name):
    """The design evaluator's golden rows on the card, FUSED on, float64,
    the model built by the port from its JSON."""
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, f"golden_design_{name}.npz"))
    keys = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
    before = linsolve.KERNEL_LAUNCHES
    out = make_design_evaluator(model, cuda)(**{k: g[k] for k in keys})
    assert linsolve.KERNEL_LAUNCHES > before
    for k in tb.OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name,nWaves", [("semi_wind", 1), ("mhk_tidal", 2)])
def test_full_on_card_matches_goldens(cuda, name, nWaves):
    """The full evaluator's golden rows on the card, FUSED on, float64,
    the rotor design built by the port from its JSON."""
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, f"golden_full_{name}.npz"))
    before = linsolve.KERNEL_LAUNCHES
    out = make_full_evaluator(model, nWaves=nWaves, device=cuda)(
        **{k: g[k] for k in ENV_KEYS + SEA_KEYS})
    assert linsolve.KERNEL_LAUNCHES > before
    for k in FULL_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name,design", [
    ("semi_wind_coarse", "design_semi_wind_bem_coarse.json"),
    ("semi_wind_wamit", "design_semi_wind_wamit.json")])
def test_bem_on_card_matches_goldens(cuda, name, design, tmp_path,
                                     monkeypatch):
    """The full evaluator on a potential-flow design's golden rows on the
    card, FUSED on, float64: the coarse panel-solver copy (solved on the
    host into a fresh cache) and the WAMIT-file design."""
    monkeypatch.setenv("RAFT_TPU_BEM_DIR", str(tmp_path))
    model = Model(os.path.join(FIX, design))
    g = np.load(os.path.join(FIX, f"golden_bem_{name}.npz"))
    before = linsolve.KERNEL_LAUNCHES
    out = make_full_evaluator(model, device=cuda)(
        **{k: g["h1_" + k] for k in ENV_KEYS + SEA_KEYS})
    assert linsolve.KERNEL_LAUNCHES > before
    for k in FULL_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["h1_on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


QTF_CASES = {"h1": ("semi_wind_qtf", 1, False),
             "h2": ("semi_wind_qtf", 2, False),
             "geo": ("semi_wind_qtf", 1, True),
             "bem_h1": ("semi_wind_bem_coarse_qtf", 1, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QTF_CASES))
def test_qtf_on_card_matches_goldens(cuda, case, tmp_path, monkeypatch):
    """The full evaluator with an external QTF on the card, FUSED on,
    float64: one and two headings, geometry rows, and the coarse
    potential-flow design with the same file."""
    monkeypatch.setenv("RAFT_TPU_BEM_DIR", str(tmp_path))
    name, nW, geometry = QTF_CASES[case]
    tag = case.split("_")[-1]
    g = np.load(os.path.join(FIX, f"golden_{name}.npz"))
    ev = make_full_evaluator(Model(os.path.join(FIX, f"design_{name}.json")),
                             nWaves=nW, device=cuda, geometry=geometry)
    kw = {k: g[f"{tag}_{k}"] for k in ENV_KEYS + SEA_KEYS}
    if geometry:
        kw["geom"] = {k[len(tag) + 6:]: g[k] for k in g.files
                      if k.startswith(f"{tag}_geom_")}
    out = ev(**kw)
    for k in FULL_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g[f"{tag}_on_{k}"]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fixed", "rao"])
def test_qtf_slender_on_card_matches_goldens(cuda, which):
    """Model.qtf_slender at the 40-bin fixture grid on the card within
    1e-10 x max|qtf| of the JAX goldens, and member_qtf's bits the same
    at two pair-chunk sizes."""
    from raft_tpu_torch.physics import qtf_slender as qs

    g = np.load(os.path.join(FIX, "golden_qtf_slender.npz"))
    m = Model(os.path.join(FIX, "design_semi_wind_slender.json"))
    Xi0 = g["Xi0"] if which == "rao" else None
    got = m.qtf_slender(float(g["beta"]), Xi0=Xi0, device=cuda)
    assert got.is_cuda
    ref = g[f"{which}_qtf"]
    got = got.cpu().numpy()
    assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))
    fs = m.fowtList[0]
    mem = fs.members[1]
    a_i = m.hydro[0].hc0["a_i"][fs.members[0].ns:][:mem.ns]
    args = (mem, a_i, torch.as_tensor(g["Xi"], device=cuda),
            float(g["beta"]), m.w1_2nd, m.k1_2nd, fs.depth, fs.rho_water,
            fs.g)
    a = qs.member_qtf(*args, pair_chunk=97)
    b = qs.member_qtf(*args, pair_chunk=4096)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["semi_wind", "spar3"])
def test_farm_on_card_matches_goldens(cuda, name):
    """The farm evaluator's golden rows on the card, float64: the
    two-unit shared-mooring farm (its system response is the kernel at
    N = 12) and the three-spar farm (N = 18, torch.linalg.solve)."""
    with open(os.path.join(FIX, f"design_farm_{name}.json")) as f:
        model = Model(json.load(f), base_dir=FIX)
    g = np.load(os.path.join(FIX, f"golden_farm_{name}.npz"))
    before = linsolve.KERNEL_LAUNCHES
    out = make_farm_evaluator(model, nWaves=g["Hs"].shape[1], device=cuda)(
        **{k: g[k] for k in ENV_KEYS + SEA_KEYS})
    assert linsolve.KERNEL_LAUNCHES > before
    for k in FARM_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_adjoint_kernel_matches_plain(cuda, N, dtype, tol):
    """The adjoint entry (on the forward's planes at N <= 6, on Z at
    N = 7-12) against ``_native_solve(Z.mH, G)``."""
    Z, G = systems(N, (3,), 41, N + 100)
    Z, G = Z.to(dtype).to(cuda), G.to(dtype).to(cuda)
    _, planes = linsolve._cuda_solve(Z, G, keep_planes=True)
    assert (planes is None) == (N >= linsolve.ROW_MIN_N)
    fwd, adj, rows = _launches()
    lam = linsolve._adjoint(Z, planes, G, "native")
    torch.cuda.synchronize()
    assert _launches() == (fwd, adj + 1,
                           rows + int(N >= linsolve.ROW_MIN_N))
    ref = linsolve._native_solve(Z.mH, G)
    scale = float(torch.max(torch.abs(ref)))
    assert float(torch.max(torch.abs(lam - ref))) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("N", [6, 12])
def test_solve_backward_on_card_matches_cpu(cuda, N):
    """The solve's gradient through the adjoint kernel (broadcast Z) on
    the card against the same backward on the CPU, in both designs."""
    Z, _ = systems(N, (4, 1), 17, 7)
    F = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 3, 17, N))
                        + 1j)
    grads = []
    for dev in ("cpu", cuda):
        z = Z.to(dev).requires_grad_()
        f = F.to(dev).requires_grad_()
        x = linsolve.solve(z, f)
        gz, gf = torch.autograd.grad((x.abs() ** 2).sum(), (z, f))
        grads.append((gz.cpu(), gf.cpu()))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert float(torch.max(torch.abs(a - b))) <= \
            1e-12 * float(torch.max(torch.abs(b)))


def _geometry_rows(g):
    return ({k: g[k] for k in ENV_KEYS + SEA_KEYS},
            {k[5:]: g[k] for k in g if k.startswith("geom_")})


@pytest.mark.cuda
def test_geometry_on_card_matches_goldens(cuda):
    """The geometry evaluator's golden rows of semi_wind on the card,
    FUSED on, float64."""
    with open(os.path.join(FIX, "design_semi_wind.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, "golden_geometry_semi_wind.npz"))
    rows, geom = _geometry_rows(g)
    out = make_full_evaluator(model, nWaves=1, device=cuda,
                              geometry=True)(geom=geom, **rows)
    for k in FULL_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.cuda
def test_geometry_gradient_on_card_matches_goldens(cuda):
    """Reverse-mode gradients of sum |Xi[0]|^2 + sum X0^2 with respect to
    every geometry key of spar's golden rows on the card; the adjoint
    kernel launches at least once per Neumann step."""
    with open(os.path.join(FIX, "design_spar.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, "golden_grad_spar.npz"))
    rows, geom = _geometry_rows(g)
    geom = {k: torch.tensor(v, device=cuda, requires_grad=True)
            for k, v in geom.items()}
    out = make_full_evaluator(model, nWaves=2, device=cuda,
                              geometry=True)(geom=geom, **rows)
    metric = (out["Xi"][:, 0].abs() ** 2).sum((-2, -1)) \
        + (out["X0"] ** 2).sum(-1)
    before = linsolve.ADJ_KERNEL_LAUNCHES
    grads = torch.autograd.grad(metric.sum(), list(geom.values()))
    assert linsolve.ADJ_KERNEL_LAUNCHES - before >= dynamics.NEUMANN_STEPS
    for k, a in zip(geom, grads):
        b = g["on_g_" + k]
        assert np.max(np.abs(a.cpu().numpy() - b)) <= \
            1e-9 * np.max(np.abs(b)), k


#: the flexible path's gates past its N-DOF solves (pivoted LU of two
#: libraries; tests/test_torch_flexible.py): X0 at kappa(K) eps, Xi, PSD
#: and drag_resid at kappa(Z) eps, the largest condition numbers of the
#: golden rows
FLEX_GATES = dict(X0=2.80e9 * np.finfo(np.float64).eps,
                  Xi=2.72e10 * np.finfo(np.float64).eps,
                  PSD=2.72e10 * np.finfo(np.float64).eps,
                  drag_resid=2.72e10 * np.finfo(np.float64).eps)


@pytest.mark.cuda
@pytest.mark.parametrize("name,nWaves", [("spar", 2), ("semi_wind", 1)])
def test_flexible_on_card_matches_goldens(cuda, name, nWaves):
    """The flexible evaluator's golden rows on the card (nDOF 108 and
    168), float64, with no launch of either solve-kernel design: its
    solves are N > 12, torch.linalg.solve as in the reference."""
    from raft_tpu_torch.api import FLEX_OUT_KEYS, make_flexible_evaluator

    with open(os.path.join(FIX, f"design_{name}_flex.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, f"golden_flex_{name}.npz"))
    before = (linsolve.KERNEL_LAUNCHES, linsolve.ROW_KERNEL_LAUNCHES)
    out = make_flexible_evaluator(model, nWaves=nWaves, device=cuda)(
        **{k: g[k] for k in ENV_KEYS + SEA_KEYS if k in g})
    assert (linsolve.KERNEL_LAUNCHES, linsolve.ROW_KERNEL_LAUNCHES) == before
    for k in FLEX_OUT_KEYS:
        a, b = out[k].cpu().numpy(), g["on_" + k]
        if k in ("status", "n_iter_drag", "drag_converged"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            tol = FLEX_GATES.get(k, 1e-10)
            assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b)), k


@pytest.mark.cuda
def test_traced_topology_on_card_matches_cpu(cuda):
    """TracedTopology.kinematics of 4 seeded rows on the card against the
    same replay on the CPU (semi_wind_flex, nDOF 168)."""
    from raft_tpu_torch.structure.topology_traced import TracedTopology

    with open(os.path.join(FIX, "design_semi_wind_flex.json")) as f:
        fs = Model(json.load(f)).fowtList[0]
    tt = TracedTopology(fs)
    X = 0.05 * np.random.default_rng(7).standard_normal((4, fs.nDOF))
    cpu = tt.kinematics(torch.as_tensor(X))
    card = tt.kinematics(torch.as_tensor(X, device=cuda))
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda"
        b = b.numpy()
        assert np.max(np.abs(a.cpu().numpy() - b)) <= 1e-12 * np.max(
            np.abs(b))


@pytest.mark.cuda
def test_solve_dispatch_above_12_goes_to_the_library(cuda):
    """A CUDA system of N = 108 goes to torch.linalg.solve: no launch of
    either solve-kernel design, the library's answer bit for bit."""
    Z, F = systems(108, (2,), 4, seed=108)
    Z, F = Z.to(cuda), F.to(cuda)
    before = (linsolve.KERNEL_LAUNCHES, linsolve.ADJ_KERNEL_LAUNCHES,
              linsolve.ROW_KERNEL_LAUNCHES)
    x = linsolve.solve(Z, F)
    assert (linsolve.KERNEL_LAUNCHES, linsolve.ADJ_KERNEL_LAUNCHES,
            linsolve.ROW_KERNEL_LAUNCHES) == before
    assert torch.equal(x, torch.linalg.solve(Z, F[..., None])[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spar", "semi_wind_moor2"])
def test_analyze_cases_on_card_matches_golden(cuda, name):
    """drivers.run on the card: the JAX Model's case metrics within 1e-10
    x each key's family scale (as tests/test_torch_orchestrated.py holds
    them), the status words and n_iter_drag equal, and the solve kernel
    launched once per fixed-point solve and once for the response."""
    import sys

    from raft_tpu_torch import drivers

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_orchestrated import golden, hold_results

    linsolve.reset_launches()
    model = drivers.run(os.path.join(FIX, f"design_{name}.json"),
                        device=cuda)
    launches = linsolve.KERNEL_LAUNCHES
    hold_results(model, golden(name))
    st = model.case_stats
    assert launches == sum(sum(c["fixed_point_solves"]) + 1 for c in st)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spar", "spar_host", "semi_wind_flex"])
def test_design_evaluation_on_card_matches_golden(cuda, name):
    """DesignEvaluation on the card: the reference's route, each call
    held at the gates of tests/test_torch_omdao.py with the result
    cache's counters equal; the solve kernel launched by the first call
    (and the spar's override) only, none on the cache-hit repeat and
    none on the flexible route (N = 168 goes to the library)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_omdao import evaluation, run_set

    ev = evaluation(name, device=cuda)
    linsolve.reset_launches()
    first = run_set(name, ev)
    launches = linsolve.KERNEL_LAUNCHES
    assert first["repeat"][2] == 0
    if ev.route == "flexible":
        assert launches == 0
    else:
        assert launches > 0
    linsolve.reset_launches()
    ev.compute()
    assert linsolve.KERNEL_LAUNCHES == 0, "a cache-hit repeat launched"


@pytest.mark.cuda
def test_weis_core_on_card_matches_golden(cuda):
    """RAFT_OMDAO_Core on weis_semi_wind on the card: build_design
    exactly the reference's, compute at the CPU tests' gates, the solve
    kernel launched once per fixed-point solve and system response."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_omdao import (golden, hold_weis_compute,
                                  hold_weis_design, weis_core, weis_set)

    s = weis_set("weis_semi_wind")
    g = golden("weis_semi_wind")
    core = weis_core(s, device=cuda)
    hold_weis_design(core.build_design(s["inputs"], s["discrete_inputs"]),
                     core.case_mask, g)
    linsolve.reset_launches()
    out = core.compute(s["inputs"], s["discrete_inputs"])
    launches = linsolve.KERNEL_LAUNCHES
    hold_weis_compute(out, g)
    st = core.model.case_stats
    assert launches == sum(sum(c["fixed_point_solves"]) + 1 for c in st)


def _grad_gates():
    """tests/test_torch_grad.py's gradient gate and metric, and the aero
    metric's keys of the golden writer."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import make_torch_port_fixtures as mk
    from test_torch_grad import hold_grads, metric
    return hold_grads, metric, mk.GRAD_AERO_METRIC_KEYS


@pytest.mark.cuda
def test_farm_gradient_on_card_matches_golden(cuda):
    """The two-unit farm's gradient with respect to every row input on
    the card (golden_grad_farm_semi_wind.npz); the backward grows
    ROW_KERNEL_LAUNCHES by one, the system response's N = 12 adjoint
    (the kernel's lane-per-row adjoint entry)."""
    with open(os.path.join(FIX, "design_farm_semi_wind.json")) as f:
        model = Model(json.load(f), base_dir=FIX)
    hold_grads, metric, _ = _grad_gates()
    g = np.load(os.path.join(FIX, "golden_grad_farm_semi_wind.npz"))
    x = {k: torch.tensor(g[k], device=cuda, requires_grad=True)
         for k in ENV_KEYS + SEA_KEYS}
    out = make_farm_evaluator(model, device=cuda)(**x)
    for k in ("status", "n_iter_drag"):
        np.testing.assert_array_equal(out[k].cpu().numpy(), g[k], err_msg=k)
    val = metric(out)
    rows0, adj0 = linsolve.ROW_KERNEL_LAUNCHES, linsolve.ADJ_KERNEL_LAUNCHES
    grads = torch.autograd.grad(val.sum(), list(x.values()),
                                allow_unused=True, materialize_grads=True)
    assert linsolve.ROW_KERNEL_LAUNCHES - rows0 == 1
    assert linsolve.ADJ_KERNEL_LAUNCHES - adj0 == \
        dynamics.NEUMANN_STEPS + 2
    hold_grads(val, dict(zip(x, grads)), g, "")


@pytest.mark.cuda
@pytest.mark.parametrize("name,nWaves", [("semi_wind", 1), ("mhk_tidal", 2)])
def test_aero_gradient_on_card_matches_golden(cuda, name, nWaves):
    """The full evaluator's gradient with respect to every row input,
    the aero stage's included, on the card (golden_grad_aero_*.npz),
    and sum |f_aero|^2's with respect to the rotor speeds, TI and yaw."""
    hold_grads, metric, aero = _grad_gates()
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        model = Model(json.load(f))
    g = np.load(os.path.join(FIX, f"golden_grad_aero_{name}.npz"))
    keys = ENV_KEYS + SEA_KEYS
    x = {k: torch.tensor(g[k], device=cuda, requires_grad=True)
         for k in keys}
    out = make_full_evaluator(model, nWaves=nWaves, device=cuda)(**x)
    val = metric(out)
    grads = torch.autograd.grad(val.sum(), list(x.values()),
                                retain_graph=True, allow_unused=True,
                                materialize_grads=True)
    hold_grads(val, dict(zip(x, grads)), g, "on_")
    aval = (out["f_aero"].abs() ** 2).flatten(1).sum(-1)
    grads = torch.autograd.grad(aval.sum(), [x[k] for k in aero],
                                allow_unused=True, materialize_grads=True)
    hold_grads(aval, dict(zip(aero, grads)), g, "on_aero_")


# ------------------------------------------------------------ forward mode

@pytest.mark.cuda
@pytest.mark.parametrize("N", [6, 12])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_solve_jvp_on_card_matches_plain(cuda, N, dtype, tol):
    """The solve's jvp on the card: its tangent solve ``Z^-1 (dF - dZ x)``
    through the forward entry (at N = 6 on the forward's saved planes)
    against the plain version on the same right-hand side, bit-equal in
    float64 (float32 within 1e-5 x max|x|); one launch for the primal,
    one for the tangent."""
    Z, F = systems(N, (4,), 37, 3)
    Z, F = Z.to(dtype).to(cuda), F.to(dtype).to(cuda)
    dZ, dF = systems(N, (4,), 37, 4)
    dZ, dF = 0.1 * dZ.to(dtype).to(cuda), dF.to(dtype).to(cuda)
    fwd, _, rows = _launches()
    x, dx = torch.func.jvp(linsolve.solve, (Z, F), (dZ, dF))
    assert linsolve.KERNEL_LAUNCHES - fwd == 2
    assert linsolve.ROW_KERNEL_LAUNCHES - rows == (2 if N >= 7 else 0)
    rhs = dF.expand_as(x) - (dZ @ x[..., None])[..., 0]
    ref = linsolve._native_solve(Z, rhs)
    err = float(torch.max(torch.abs(dx - ref)))
    assert err <= tol * float(torch.max(torch.abs(ref)))
    assert torch.equal(x, linsolve.solve(Z, F))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [6, 12])
def test_solve_jacfwd_on_card_is_one_launch(cuda, N):
    """jacfwd of k directions: the primal and one tangent launch, for k
    = 3 and k = 8 (the vmap rule folds the directions into the batch of
    systems), each column within 1e-12 x max of that direction's jvp
    (the tangent's right-hand side ``dF - dZ x`` is a batched matmul,
    whose library kernel may round otherwise over k times the batch)."""
    Z, F = systems(N, (4,), 37, 5)
    Z, F = Z.to(cuda), F.to(cuda)
    for k in (3, 8):
        s0 = torch.linspace(0.9, 1.1, k, dtype=torch.float64, device=cuda)

        def f(s):
            return torch.view_as_real(linsolve.solve(
                Z * s[0], F * s[1:].sum() + s[-1]))

        fwd = linsolve.KERNEL_LAUNCHES
        J = torch.func.jacfwd(f)(s0)
        assert linsolve.KERNEL_LAUNCHES - fwd == 2
        for i in range(k):
            e = torch.zeros(k, dtype=torch.float64, device=cuda)
            e[i] = 1.0
            col = torch.func.jvp(f, (s0,), (e,))[1]
            assert float(torch.max(torch.abs(col - J[..., i]))) <= \
                1e-12 * float(torch.max(torch.abs(col)))


@pytest.mark.cuda
def test_design_forward_mode_on_card_matches_goldens(cuda):
    """The spar design evaluator's tangents on the card
    (golden_jvp_design_spar.npz, 1e-9 x max|tangent|; the outputs under
    the transform within 1e-10 x max of the plain call's, status and
    n_iter_drag equal: under torch.func's wrappers a library kernel may
    round otherwise) and jacfwd of the response metric by its
    six inputs (golden_grad_design_spar.npz); jacfwd's six directions
    launch the forward entry as often as one jvp's: the plain call's
    trips and final solve, plus the fixed point's tangent work."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_fwd as fw
    from test_torch_grad import DESIGN_KEYS

    with open(os.path.join(FIX, "design_spar.json")) as f:
        ev = make_design_evaluator(Model(json.load(f)), cuda)
    gj = dict(np.load(os.path.join(FIX, "golden_jvp_design_spar.npz")))
    gd = dict(np.load(os.path.join(FIX, "golden_grad_design_spar.npz")))
    x = {k: torch.tensor(gd[k], device=cuda) for k in DESIGN_KEYS}
    n0 = linsolve.KERNEL_LAUNCHES
    plain = ev(**x)
    n0 = linsolve.KERNEL_LAUNCHES - n0
    n1 = linsolve.KERNEL_LAUNCHES
    prim, tan = torch.func.jvp(lambda x: ev(**x), (x,),
                               (fw.directions(x, 0),))
    n1 = linsolve.KERNEL_LAUNCHES - n1
    fw.hold_primal(prim, plain, gj, "on_", tol=1e-10)
    fw.hold_tangents(tan, gj, "on_", 0)
    n2 = linsolve.KERNEL_LAUNCHES
    fw.hold_jacfwd(fw.row_jacfwd(lambda x: ev(**x), x), gd, "on_")
    n2 = linsolve.KERNEL_LAUNCHES - n2
    assert n1 == n2 == n0 + dynamics.NEUMANN_STEPS + 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["semi_wind", "farm_semi_wind"])
def test_evaluators_repeat_bit_for_bit_on_card(cuda, name):
    """Two evaluations of the same rows on the card give the same bits
    (the strip -> node and network scatter-adds are one-hot products,
    ops/scatter.py, not index_add's atomics): what a resumed
    checkpointed sweep needs to reproduce the shards it resumes."""
    with open(os.path.join(FIX, f"design_{name}.json")) as f:
        model = Model(json.load(f), base_dir=FIX)
    if name.startswith("farm"):
        g = np.load(os.path.join(FIX, f"golden_{name}.npz"))
        ev = make_farm_evaluator(model, nWaves=g["Hs"].shape[1], device=cuda)
    else:
        g = np.load(os.path.join(FIX, f"golden_full_{name}.npz"))
        ev = make_full_evaluator(model, nWaves=1, device=cuda)
    rows = {k: g[k] for k in ENV_KEYS + SEA_KEYS}
    a, b = ev(**rows), ev(**rows)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_two_worker_fabric_on_card_is_bit_identical_to_serial(cuda,
                                                              tmp_path,
                                                              monkeypatch):
    """Two fabric workers on the card (both on cuda:0) give the bits of
    the same entry's serial checkpointed sweep in this process, on the
    rows of ``golden_sweep_cases_spar.npz``, and stay within 1e-10 x max
    of the JAX case evaluator's there; the workers' kernel ledgers count
    their launches."""
    from raft_tpu_torch.parallel import fabric, resilience
    from raft_tpu_torch.parallel.sweep import make_mesh

    monkeypatch.setenv("RAFT_TPU_FABRIC_POLL_S", "0.1")
    keys = ("PSD", "X0", "status", "n_iter_drag")
    gold = dict(np.load(os.path.join(FIX, "golden_sweep_cases_spar.npz")))
    cases = {k: gold[k] for k in ("Hs", "Tp", "beta")}
    entry = "raft_tpu_torch.parallel.fabric:demo_entry"
    res = fabric.resolve_entry(entry, {"out_keys": list(keys),
                                       "device": "cuda"})
    serial = resilience.run_checkpointed(
        res["compute"], cases, str(tmp_path / "serial"), 4, make_mesh(1),
        keys)
    out = fabric.run_fabric(str(tmp_path / "fab"), 2, entry, cases=cases,
                            entry_kwargs={"out_keys": list(keys)},
                            out_keys=keys, shard_size=4, device="cuda")
    for k in keys:
        assert np.array_equal(out[k], serial[k]), k
    for k in ("status", "n_iter_drag"):
        np.testing.assert_array_equal(out[k], gold[k])
    for k in ("PSD", "X0"):
        scale = np.max(np.abs(gold[k]))
        assert np.max(np.abs(out[k] - gold[k])) <= 1e-10 * scale, k
    with open(tmp_path / "fab" / "metrics.json") as f:
        programs = {r["key"]: r["dispatches"]
                    for r in json.load(f)["programs"]}
    assert programs["ge_solve"] > 0


@pytest.mark.cuda
def test_serving_process_on_card_is_bit_equal_to_direct_calls(cuda):
    """One in-process server on cuda:0 (the batcher's thread dispatches,
    the asyncio server's loop runs in another) under 4 concurrent
    clients over loopback: every served row bit-equal to a direct
    bucket-evaluator call on the padded group that served it, status
    equal, and the solve kernel's launches in the run equal to the sum
    of the dispatches' launches."""
    import asyncio
    import threading

    from raft_tpu_torch.serve import engine
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.http import Server
    from raft_tpu_torch.utils.devices import to_host

    dev = torch.device("cuda", 0)
    registry = engine.Registry()
    for n in ("spar", "semi"):
        registry.register(n, os.path.join(FIX, f"design_{n}.json"))
    batcher = Batcher(registry, device=dev, max_batch=4, group_log=256)
    engine.warm([registry.get(n) for n in registry.names()], device=dev,
                out_keys=batcher.out_keys, sizes=batcher.sizes)
    box, up = {}, threading.Event()

    def serve():
        loop = asyncio.new_event_loop()

        async def run():
            box["server"] = await Server(batcher, "127.0.0.1", 0).start()
            up.set()
            await box["server"].serve_until_stopped()

        loop.run_until_complete(run())
        loop.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert up.wait(60)
    port = box["server"].port
    linsolve.reset_launches()
    results = []

    def client(i):
        c = ServeClient("127.0.0.1", port, client_id=f"c{i}")
        for j in range(6):
            name = ("spar", "semi")[(i + j) % 2]
            case = (3.0 + 0.5 * ((i * 6 + j) % 5), 8.0 + j % 3, 0.1 * i)
            code, body = c.evaluate(name, *case)
            results.append((name, case, code, body))
        c.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    c = ServeClient("127.0.0.1", port)
    assert c.request("POST", "/drain")[0] == 202
    c.close()
    th.join(timeout=120)
    launches = linsolve.KERNEL_LAUNCHES
    groups = list(batcher.groups)
    assert len(results) == 24 and all(r[2] == 200 for r in results)
    assert launches == sum(g["launches"] for g in groups) > 0
    rows = {}
    with torch.no_grad():
        for g in groups:
            ents, n = g["entries"], len(g["entries"])
            ev = tb.get_bucket_evaluator(ents[0].sig, dev)
            design, seas = engine.padded_group(ents, g["Hs"], g["Tp"],
                                               g["beta"], g["padded"], dev)
            direct = ev(design, *seas)
            for k in batcher.out_keys:
                np.testing.assert_array_equal(g["out"][k],
                                              to_host(direct[k][:n]))
            for i, e in enumerate(ents):
                rows[(e.name, g["Hs"][i], g["Tp"][i], g["beta"][i])] = (g, i)
    for name, case, _, body in results:
        g, i = rows[(name,) + tuple(float(x) for x in case)]
        assert body["status"] == int(g["out"]["status"][i])
        for k, v in body["outputs"].items():
            np.testing.assert_array_equal(np.asarray(v, g["out"][k].dtype),
                                          g["out"][k][i])


@pytest.mark.cuda
def test_warmed_bank_loads_on_card_under_require_without_nvcc(cuda,
                                                              tmp_path):
    """A bank warmed in this process (the spar case program at 4 rows
    and the serve program at rung 2, under RAFT_TPU_AOT=load), then a
    fresh process under require and COMPILE_BUDGET=0: it loads both
    entries and the bank's copy of the kernel library, runs no nvcc,
    builds nothing, and answers bit-equal to this process's calls."""
    import subprocess
    import sys

    from raft_tpu_torch.aot import bank, warmup

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_keys = ("RAFT_TPU_AOT_DIR", "RAFT_TPU_SERVE_LADDER")
    saved = {k: os.environ.get(k) for k in env_keys}
    os.environ["RAFT_TPU_AOT_DIR"] = str(tmp_path / "bank")
    os.environ["RAFT_TPU_SERVE_LADDER"] = "2"
    try:
        reps = warmup.warmup_model(sizes=(4,), kinds=("cases", "serve"),
                                   device=torch.device("cuda", 0))
        assert [r["compiled"] for r in reps] == [1, 1]
        assert all(r["launches"] > 0 for r in reps)
        payloads = os.listdir(bank.payload_dir())
        assert len(payloads) == 1 and payloads[0].endswith(".so")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("RAFT_TPU_", "AOT_CHILD"))}
        env.update(RAFT_TPU_AOT_DIR=str(tmp_path / "bank"),
                   RAFT_TPU_SERVE_LADDER="2", RAFT_TPU_AOT="require",
                   RAFT_TPU_COMPILE_BUDGET="0", AOT_CHILD_DEVICE="cuda",
                   AOT_CHILD_OUT=str(tmp_path / "child.npz"),
                   PYTHONPATH=root)
        p = subprocess.run(
            [sys.executable, os.path.join(root, "tests",
                                          "_torch_aot_child.py")],
            env=env, capture_output=True, text=True, timeout=600, cwd=root)
        assert p.returncode == 0, p.stderr[-2000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert (r["loaded"], r["compiled"], r["builds"], r["nvcc_runs"]) \
            == (2, 0, 0, 0) and not r["built_here"]
        assert r["library"] == os.path.join(bank.payload_dir(), payloads[0])
        assert r["launches"] > 0
        # this process's calls on the child's inputs (the bank off)
        from raft_tpu_torch import api
        from raft_tpu_torch.parallel.sweep import make_mesh, sweep_cases
        from raft_tpu_torch.serve import engine

        os.environ.pop("RAFT_TPU_AOT", None)
        model = Model(os.path.join(FIX, "design_spar.json"), base_dir=FIX)
        rng = np.random.default_rng(0)
        Hs, Tp, beta = (rng.uniform(2.0, 8.0, 4), rng.uniform(6.0, 14.0, 4),
                        rng.uniform(-0.5, 0.5, 4))
        dev = torch.device("cuda", 0)
        out = sweep_cases(api.make_case_evaluator(model, device=dev), Hs, Tp,
                          beta, mesh=make_mesh(device=dev),
                          out_keys=("PSD", "X0", "status"))
        served = engine.dispatch([engine.DesignEntry("spar", model)] * 2,
                                 Hs[:2], Tp[:2], beta[:2], device=dev,
                                 padded=2)
        got = np.load(tmp_path / "child.npz")
        for k, v in list(out.items()):
            assert np.array_equal(got[f"cases_{k}"], v), k
        for k, v in served.items():
            assert np.array_equal(got[f"serve_{k}"], v), k
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.cuda
def test_two_replicas_on_card_behind_a_router_are_bit_equal(cuda, tmp_path,
                                                           monkeypatch):
    """Two fleet replicas (``python -m raft_tpu_torch.serve --fleet-dir``)
    on cuda:0 behind an in-process router: the same cases answered by
    each replica directly and through the router are bit-equal, status
    equal, and within 1e-10 x max of the JAX serving engine's
    ``golden_serve_spar.npz``."""
    import asyncio
    import threading
    import time

    from raft_tpu_torch.serve import fleet
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.router import Router

    g = np.load(os.path.join(FIX, "golden_serve_spar.npz"))
    rows = [{k: g[f"r{rung}_{k}"][i] for k in ("Hs", "Tp", "beta", "X0",
                                                "status")}
            for rung in (1, 4) for i in range(len(g[f"r{rung}_Hs"]))]
    root = str(tmp_path / "deploy")
    env = {"RAFT_TPU_SERVE_LADDER": "1,4", "RAFT_TPU_FLEET_TTL_S": "5",
           "RAFT_TPU_AOT": "off"}
    for drop in ("RAFT_TPU_LOG", "RAFT_TPU_RUNS_DIR", "RAFT_TPU_FAULTS"):
        monkeypatch.delenv(drop, raising=False)
    monkeypatch.setenv("RAFT_TPU_ROUTER_PROBE_S", "0.3")
    spar = os.path.join(FIX, "design_spar.json")
    procs = [fleet.spawn_replica(root, [f"spar={spar}"], index=i,
                                 replica_id=f"r{i}", env=env, device="cuda")
             for i in range(2)]
    box, up = {}, threading.Event()
    loop = asyncio.new_event_loop()

    def serve():
        asyncio.set_event_loop(loop)

        async def run():
            box["router"] = await Router(root, port=0).start()
            up.set()
            await box["router"].serve_until_stopped()

        loop.run_until_complete(run())

    th = None
    try:
        ledger = fleet.FleetLedger(root)
        t0 = time.monotonic()
        while not {"r0", "r1"} <= set(ledger.live()):
            assert all(p.poll() is None for p, _ in procs)
            assert time.monotonic() - t0 < 300
            time.sleep(0.2)
        live = ledger.live()
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        assert up.wait(60)
        answers = {}
        for where, port in (("r0", live["r0"]["port"]),
                            ("r1", live["r1"]["port"]),
                            ("router", box["router"].port)):
            c = ServeClient("127.0.0.1", port, timeout=300)
            try:
                answers[where] = [c.evaluate("spar", float(r["Hs"]),
                                             float(r["Tp"]),
                                             float(r["beta"]))
                                  for r in rows]
            finally:
                c.close()
        for (ca, a), (cb, b), (cr, rb), row in zip(
                answers["r0"], answers["r1"], answers["router"], rows):
            assert ca == cb == cr == 200
            assert a["status"] == b["status"] == rb["status"] \
                == int(row["status"])
            assert a["outputs"] == b["outputs"] == rb["outputs"]
            ref = row["X0"]
            assert np.max(np.abs(np.asarray(a["outputs"]["X0"]) - ref)) \
                <= 1e-10 * np.max(np.abs(ref))
    finally:
        if th is not None:
            loop.call_soon_threadsafe(box["router"]._stop.set)
            th.join(timeout=60)
        rcs = fleet._shutdown_replicas(procs)
    assert set(rcs.values()) == {0}
