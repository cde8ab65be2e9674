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
goldens with ``status`` and ``n_iter_drag`` equal; reverse-mode gradients within 1e-9 x each key's
max|g| of the JAX goldens.
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
