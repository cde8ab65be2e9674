"""The port's batched complex solve (:mod:`raft_tpu_torch.ops.linsolve`)
against the JAX package's on the same numpy inputs.

On the CPU the port runs its plain PyTorch version (the transcription
of ``_native_solve``); the CUDA kernel is held against that plain
version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the
card.  Tolerances: float64 within 1e-12 x max|x| (the same algebra in
the same operation order, so only the rounding of XLA's fused loop
against eager ops differs); float32 within 1e-5 x max|x| (each side
rounds its own float32 elimination on impedance systems of condition
~1e2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import linsolve as jls
from raft_tpu_torch.ops import linsolve as tls

F64_TOL = 1e-12
F32_TOL = 1e-5


def impedance_systems(rng, N, nw=17, nH=3):
    """Impedance-structured systems, Z (nw, N, N) against F (nH, nw, N),
    as tests/test_linsolve.py builds them."""
    M = rng.normal(size=(N, N))
    M = M @ M.T + N * np.eye(N)
    C = rng.normal(size=(N, N))
    C = C @ C.T + N * np.eye(N)
    B = rng.normal(size=(N, N))
    B = 0.05 * B @ B.T + 0.1 * np.eye(N)
    w = np.linspace(0.01, 2.0, nw)
    Z = -(w ** 2)[:, None, None] * M + 1j * w[:, None, None] * B + C
    F = rng.normal(size=(nH, nw, N)) + 1j * rng.normal(size=(nH, nw, N))
    return Z, F


@pytest.mark.parametrize("N", [1, 2, 3, 6, 9, 12])
def test_plain_solve_matches_jax_native(N):
    """Broadcast layout (Z (nw,N,N) against F (nH,nw,N)), float64."""
    Z, F = impedance_systems(np.random.default_rng(N), N)
    x_j = np.asarray(jls._native_solve(jnp.asarray(Z), jnp.asarray(F)))
    x_t = tls.solve(torch.as_tensor(Z), torch.as_tensor(F)).numpy()
    assert x_t.shape == x_j.shape == (3, 17, N)
    assert np.max(np.abs(x_t - x_j)) <= F64_TOL * np.max(np.abs(x_j))


@pytest.mark.parametrize("N", [1, 6, 12])
def test_plain_solve_batched_rows_and_float32(N):
    """Per-row systems (the bucket's (R, nw, N, N) layout) in float64,
    and the float32/complex64 path at its stated tolerance."""
    rng = np.random.default_rng(100 + N)
    Z = np.stack([impedance_systems(rng, N, nH=1)[0] for _ in range(4)])
    F = rng.normal(size=Z.shape[:-1]) + 1j * rng.normal(size=Z.shape[:-1])
    x_j = np.asarray(jls._native_solve(jnp.asarray(Z), jnp.asarray(F)))
    x_t = tls.solve(torch.as_tensor(Z), torch.as_tensor(F)).numpy()
    scale = np.max(np.abs(x_j))
    assert np.max(np.abs(x_t - x_j)) <= F64_TOL * scale
    x32 = tls.solve(torch.as_tensor(Z).to(torch.complex64),
                    torch.as_tensor(F).to(torch.complex64))
    assert x32.dtype == torch.complex64
    assert np.max(np.abs(x32.numpy() - x_j)) <= F32_TOL * scale


def test_large_n_routes_to_torch_linalg():
    """N > MAX_NATIVE_N takes torch.linalg.solve even with path=native,
    as the reference routes it to jnp.linalg.solve."""
    rng = np.random.default_rng(0)
    N = tls.MAX_NATIVE_N + 4
    A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N)) + 3 * np.eye(N)
    b = rng.normal(size=(2, N)) + 0j
    assert tls.solver_path(N) == "lapack"
    x = tls.solve(torch.as_tensor(A), torch.as_tensor(b), path="native")
    x_j = np.asarray(jls.solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_j, rtol=1e-10, atol=1e-12)


def test_solver_flag_and_cond_estimate(monkeypatch):
    """RAFT_TPU_SOLVER drives both packages; cond_estimate agrees."""
    monkeypatch.delenv("RAFT_TPU_SOLVER", raising=False)
    assert tls.solver_path(6) == jls.solver_path(6) == "native"
    monkeypatch.setenv("RAFT_TPU_SOLVER", "lapack")
    assert tls.solver_path(6) == "lapack"
    monkeypatch.setenv("RAFT_TPU_SOLVER", "numpy")
    with pytest.raises(ValueError):
        tls.solver_path(6)
    monkeypatch.delenv("RAFT_TPU_SOLVER")
    Z, _ = impedance_systems(np.random.default_rng(9), 6)
    k_j = np.asarray(jls.cond_estimate(jnp.asarray(Z), path="native"))
    k_t = tls.cond_estimate(torch.as_tensor(Z)).numpy()
    np.testing.assert_allclose(k_t, k_j, rtol=1e-12)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """Dispatch is by device: a CUDA tensor goes to the kernel wrapper
    (which raises on what it cannot launch), never to the plain
    version.  Simulated with a stand-in device check, since there is
    no card here."""
    calls = []
    monkeypatch.setattr(tls, "_cuda_solve",
                        lambda Z, F: calls.append("kernel") or "k")
    monkeypatch.setattr(tls, "_native_solve",
                        lambda Z, F: calls.append("plain") or "p")

    class FakeCuda:
        shape = (2, 6, 6)
        device = torch.device("cuda", 0)

    assert tls.solve(FakeCuda(), None) == "k"
    assert calls == ["kernel"]


def test_kernel_wrapper_rejects_cpu_and_bad_inputs():
    """The wrapper raises on anything the kernel does not take."""
    Z = torch.eye(6, dtype=torch.complex128)[None]
    F = torch.ones(1, 6, dtype=torch.complex128)
    with pytest.raises(ValueError, match="CUDA"):
        tls._cuda_solve(Z, F)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_soa_planes_layout(dtype):
    """The kernel's input planes, built here on the CPU: Z (nw, N, N)
    broadcast against F (nH, nw, N), system b = (h, k) at column
    b = h * nw + k, entry (i, j) of Z at row i * N + j."""
    Z, F = impedance_systems(np.random.default_rng(4), 3, nw=5, nH=2)
    (zr, zi, fr, fi), bshape = tls.soa_planes(
        torch.as_tensor(Z).to(dtype), torch.as_tensor(F).to(dtype))
    assert bshape == (2, 5)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    for p, shape in zip((zr, zi, fr, fi), ((9, 10), (9, 10), (3, 10),
                                           (3, 10))):
        assert p.shape == shape and p.dtype == rdt and p.is_contiguous()
    Zc = np.broadcast_to(Z, (2, 5, 3, 3)).reshape(10, 9).astype(
        np.complex64 if dtype == torch.complex64 else complex)
    Fc = F.reshape(10, 3).astype(Zc.dtype)
    np.testing.assert_array_equal(zr.numpy(), Zc.real.T)
    np.testing.assert_array_equal(zi.numpy(), Zc.imag.T)
    np.testing.assert_array_equal(fr.numpy(), Fc.real.T)
    np.testing.assert_array_equal(fi.numpy(), Fc.imag.T)


@pytest.mark.slow
def test_plain_solve_matches_pallas_interpret():
    """The port's plain version against the TPU kernel itself, run as
    tests/test_linsolve.py runs it (Pallas interpret mode on the CPU),
    including a batch that is not a multiple of the Pallas block."""
    rng = np.random.default_rng(3)
    Z, F = impedance_systems(rng, 6, nw=17, nH=2)
    x_pal = np.asarray(jls.solve(jnp.asarray(Z), jnp.asarray(F),
                                 path="pallas"))
    x_t = tls.solve(torch.as_tensor(Z), torch.as_tensor(F)).numpy()
    assert np.max(np.abs(x_t - x_pal)) <= F64_TOL * np.max(np.abs(x_pal))


def row_design(Z, F, adjoint=False):
    """The N = 7-12 kernel design's operation order in plain torch: lane
    i holds row i of [Z | F] (row i of Z^H, the conjugated column i of
    Z, for the adjoint) as one tensor per column; step kk broadcasts the
    pivot row, every row below it inverts the pivot through |z|^2, forms
    its multiplier and updates its live columns (j > kk) and right-hand
    side only; back substitution is row-oriented, each term a[kk][jj]
    x[jj] formed once x[jj] is known and subtracted in increasing jj."""
    N = Z.shape[-1]
    bshape = torch.broadcast_shapes(Z.shape[:-2], F.shape[:-1])
    Zb = Z.expand(bshape + (N, N))
    Fb = F.expand(bshape + (N,))
    if adjoint:
        ar = [[Zb.real[..., j, i] for j in range(N)] for i in range(N)]
        ai = [[-Zb.imag[..., j, i] for j in range(N)] for i in range(N)]
    else:
        ar = [[Zb.real[..., i, j] for j in range(N)] for i in range(N)]
        ai = [[Zb.imag[..., i, j] for j in range(N)] for i in range(N)]
    gr = [Fb.real[..., i] for i in range(N)]
    gi = [Fb.imag[..., i] for i in range(N)]

    for kk in range(N - 1):
        # the pivot row, as lane kk writes it for the team
        qr, qi = ar[kk][kk:], ai[kk][kk:]
        fr, fi = gr[kk], gi[kk]
        for ii in range(kk + 1, N):
            pr, pi = qr[0], qi[0]
            d = pr * pr + pi * pi
            ivr, ivi = pr / d, -pi / d
            cr, ci = ar[ii][kk], ai[ii][kk]
            mr = cr * ivr - ci * ivi
            mi = cr * ivi + ci * ivr
            for j in range(kk + 1, N):
                rr = ar[ii][j] - (mr * qr[j - kk] - mi * qi[j - kk])
                ri = ai[ii][j] - (mr * qi[j - kk] + mi * qr[j - kk])
                ar[ii][j], ai[ii][j] = rr, ri
            gr[ii], gi[ii] = (gr[ii] - (mr * fr - mi * fi),
                              gi[ii] - (mr * fi + mi * fr))

    xr, xi = [None] * N, [None] * N
    for kk in range(N - 1, -1, -1):
        if kk < N - 1:
            yr, yi = xr[kk + 1], xi[kk + 1]
            for ii in range(kk + 1):
                tr = ar[ii][kk + 1] * yr - ai[ii][kk + 1] * yi
                ti = ar[ii][kk + 1] * yi + ai[ii][kk + 1] * yr
                ar[ii][kk + 1], ai[ii][kk + 1] = tr, ti
        sr, si = gr[kk], gi[kk]
        for jj in range(kk + 1, N):
            sr = sr - ar[kk][jj]
            si = si - ai[kk][jj]
        pr, pi = ar[kk][kk], ai[kk][kk]
        d = pr * pr + pi * pi
        xr[kk] = (sr * pr + si * pi) / d
        xi[kk] = (si * pr - sr * pi) / d
    return torch.complex(torch.stack(xr, dim=-1), torch.stack(xi, dim=-1))


@pytest.mark.parametrize("N", range(1, 13))
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_row_design_order_is_bit_equal_to_plain(N, dtype):
    """The one-lane-per-row design's order (dead columns skipped, pivot
    row broadcast, row-oriented back substitution with early products)
    gives the plain version's bits, forward and adjoint, on three seeds
    of impedance systems in the broadcast layout."""
    for seed in range(3):
        Z, F = impedance_systems(np.random.default_rng(1000 * N + seed), N)
        Z = torch.as_tensor(Z).to(dtype)
        F = torch.as_tensor(F).to(dtype)
        x = row_design(Z, F)
        assert x.dtype == dtype and x.shape == (3, 17, N)
        assert torch.equal(x, tls._native_solve(Z, F))
        lam = row_design(Z, F, adjoint=True)
        assert torch.equal(lam, tls._native_solve(Z.mH, F))


class _FakeCuda:
    """A stand-in CUDA tensor: enough of one for the dispatch to read
    its device, type and shape."""

    device = torch.device("cuda", 0)
    dtype = torch.complex128
    requires_grad = False

    def __init__(self, shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)

    def expand(self, shape):
        return _FakeCuda(shape)

    def __getitem__(self, idx):
        return _FakeCuda(self.shape + (1,))

    @property
    def mH(self):
        return self


class _Launched(Exception):
    pass


@pytest.mark.parametrize("N", [1, 6, 7, 9, 12, 13])
def test_cuda_dispatch_by_n(monkeypatch, N):
    """On a CUDA tensor, forward and adjoint: N <= 6 repacks with
    soa_planes for the thread-per-system design, N = 7-12 goes to the
    row design and never to soa_planes, N > 12 to torch.linalg.solve;
    never to the plain version.  Simulated with stand-in tensors, since
    there is no card here."""
    calls = []

    def soa(Z, F):
        calls.append("soa")
        raise _Launched

    def lapack(A, b):
        calls.append("lapack")
        return torch.zeros(tuple(A.shape[:-1]) + (1,))

    monkeypatch.setattr(tls, "soa_planes", soa)
    monkeypatch.setattr(tls, "_cuda_solve_rows",
                        lambda Z, F, adjoint=False: calls.append(
                            "rows_adj" if adjoint else "rows") or "r")
    monkeypatch.setattr(tls, "_cuda_solve_adj",
                        lambda planes, G: calls.append("soa_adj") or "a")
    monkeypatch.setattr(tls, "_native_solve",
                        lambda Z, F: calls.append("plain") or "p")
    monkeypatch.setattr(torch.linalg, "solve", lapack)
    Z, F = _FakeCuda((4, N, N)), _FakeCuda((4, N))
    try:
        tls.solve(Z, F)
    except _Launched:
        pass
    tls._adjoint(Z, None, F, tls.solver_path(N))
    expect = {1: ["soa", "soa_adj"], 6: ["soa", "soa_adj"],
              13: ["lapack", "lapack"]}.get(N, ["rows", "rows_adj"])
    assert calls == expect
