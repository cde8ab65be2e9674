"""Batched small-N complex linear solves (counterpart of
``raft_tpu/ops/linsolve.py``).

``solve(Z, F)`` solves ``Z x = F`` for batches of complex N x N systems
by pivot-free blocked Gaussian elimination of the real 2N x 2N
embedding: each pivot is a complex diagonal entry inverted in closed
form through ``|z|^2``, safe for impedance matrices whose damping keeps
``|z_kk| > 0``.

Dispatch is by the tensors' device, never by a fallback:

* a CPU tensor takes :func:`_native_solve`, the plain PyTorch version
  (the SSA elimination of the reference's ``_native_solve``, op for op);
* a CUDA tensor takes the hand-written kernel ``csrc/linsolve.cu``
  through :func:`_cuda_solve`, which raises on anything the kernel does
  not take or a launch it cannot make.  The kernel has two designs:
  N <= 6 one system per thread on batch-last planes that
  :func:`soa_planes` repacks; N = 7-12 (``ROW_MIN_N`` up) one lane per
  row, on Z and F in PyTorch's own layout (:func:`_cuda_solve_rows`);
* N > ``MAX_NATIVE_N`` goes to ``torch.linalg.solve`` on either device,
  as the reference routes it to ``jnp.linalg.solve`` (not on the
  bucket path, whose systems are 6 x 6).

``RAFT_TPU_SOLVER=lapack`` sends every size to ``torch.linalg.solve``.

:func:`solve` is differentiable through one ``torch.autograd.Function``
(:class:`_Solve`): its backward solves the adjoint system ``Z^H lam =
X_bar`` through the same dispatch (the kernel's adjoint entry on the
card, which reads the forward's saved planes of Z transposed at N <= 6
and the saved Z itself at N = 7-12;
``_native_solve(Z.mH, G)`` on the CPU; ``torch.linalg.solve`` above
N = 12) and returns ``F_bar = lam`` and ``Z_bar = -lam X^H``, each
summed over the broadcast dimensions: the formula of
``torch.linalg.solve``'s own backward, in torch's complex convention.
The reference differentiates through its elimination instead; the two
agree up to rounding.

Forward mode (``torch.func.jvp`` and ``jacfwd``) takes :class:`_Solve`'s
``jvp``: the tangent ``dx = Z^-1 (dF - dZ x)`` is one more solve through
the same dispatch, the kernel's forward entry on the card (at N <= 6 on
the forward's saved planes of Z, only the right-hand side repacked).
Its ``vmap`` rule folds the directions of ``jacfwd`` into the batch of
systems, so k directions cost one launch per solve, whatever k is.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
import threading

import torch

from raft_tpu_torch.utils import ad, budget, config

MAX_NATIVE_N = 12
#: the smallest N that takes the kernel's one-lane-per-row design
ROW_MIN_N = 7

#: launches of the CUDA kernel's forward entry, either design, counted by
#: :func:`_cuda_solve` and :func:`_cuda_solve_rows` where they launch (and
#: nowhere else), so a run can show the main path went through the kernel
KERNEL_LAUNCHES = 0
#: launches of the kernel's adjoint entry (the solve's backward), counted
#: apart from the forward's
ADJ_KERNEL_LAUNCHES = 0
#: launches of the N = 7-12 design, forward and adjoint (each counted in
#: KERNEL_LAUNCHES or ADJ_KERNEL_LAUNCHES as well)
ROW_KERNEL_LAUNCHES = 0
#: launches of the N = 7-12 design's adjoint entry (each counted in
#: ADJ_KERNEL_LAUNCHES and ROW_KERNEL_LAUNCHES as well)
ROW_ADJ_KERNEL_LAUNCHES = 0
#: guards the four counters: a serving process launches from its batcher
#: thread while other threads read them, and a sweep's entry threads
#: launch at once
_COUNT_LOCK = threading.Lock()
#: each thread's own launches by kernel entry (:func:`thread_launch_ledger`)
_THREAD = threading.local()
#: True once :func:`build` has compiled the kernel library in this
#: process (False while it only loaded an existing build, or none)
BUILT_HERE = False
#: nvcc runs of :func:`build` in this process (the program bank's
#: compile budget counts them)
NVCC_RUNS = 0
#: the file the loaded kernel library came from (None before the first
#: load): the build directory's, or a program bank's copy
LIB_PATH = None

_HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.dirname(_HERE)
SOURCE = os.path.join(PKG_DIR, "csrc", "linsolve.cu")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
THREADS = 128


def solver_path(n=None):
    """Active solver for size-``n`` systems: 'native' or 'lapack'."""
    mode = config.get("SOLVER")
    if n is not None and n > MAX_NATIVE_N:
        return "lapack"
    return mode


def solve(Z, F, path=None, keep=None):
    """Solve ``Z x = F``; Z (..., N, N) complex, F (..., N), batch dims
    broadcast (e.g. Z (nw, N, N) against F (nH, nw, N)).  Differentiable
    in Z and F (see the module docstring).

    Inputs being differentiated, or inside a torch.func transform (whose
    wrappers have no data pointers to hand the kernel), go through
    :class:`_Solve`, which receives them unwrapped.  ``keep``, a
    :class:`Keep`, routes the call through it whatever its inputs (so
    ``torch.func.vmap`` takes its vmap rule: the implicit rules' tangent
    solves, whose right-hand sides may be batched over ``jacfwd``'s
    directions), reuses the kernel's planes of Z it holds when they
    match the batch, and is left holding this Z's planes."""
    N = Z.shape[-1]
    if path is None:
        path = solver_path(N)
    elif path not in ("native", "lapack"):
        raise ValueError(f"path={path!r}: expected 'native' or 'lapack'")
    elif N > MAX_NATIVE_N:
        path = "lapack"
    if Z.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no solve for tensors on {Z.device}")
    if keep is not None or ad.differentiated(Z, F) or ad.transformed(Z, F):
        return _Solve.apply(Z, F, path, Keep() if keep is None else keep)
    return _forward(Z, F, path)[0]


def _forward(Z, F, path, keep_planes=False, planes=None):
    """(x, the kernel's SoA planes of Z when ``keep_planes`` and the
    SoA design ran, else None) by the forward dispatch; ``planes``, the
    SoA planes of this Z from an earlier solve of the same batch, spare
    their repack (:func:`_cuda_solve`)."""
    if path == "lapack":
        N = Z.shape[-1]
        bshape = torch.broadcast_shapes(Z.shape[:-2], F.shape[:-1])
        x = torch.linalg.solve(Z.expand(bshape + (N, N)),
                               F.expand(bshape + (N,))[..., None])
        return x[..., 0], None
    if Z.device.type == "cuda":
        kw = {} if planes is None else dict(planes=planes)
        if keep_planes:
            return _cuda_solve(Z, F, keep_planes=True, **kw)
        return _cuda_solve(Z, F, **kw), None
    return _native_solve(Z, F), None


def _adjoint(Z, planes, G, path):
    """lam with ``Z^H lam = G`` (G of the broadcast batch shape), by the
    forward's dispatch: the kernel's adjoint entry (on the forward's
    planes at N <= 6, on Z at N = 7-12), the plain version, or
    ``torch.linalg.solve``."""
    if path == "lapack":
        N = Z.shape[-1]
        return torch.linalg.solve(Z.mH.expand(G.shape[:-1] + (N, N)),
                                  G[..., None])[..., 0]
    if Z.device.type == "cuda":
        if Z.shape[-1] >= ROW_MIN_N:
            return _cuda_solve_rows(Z, G, adjoint=True)
        return _cuda_solve_adj(planes, G)
    return _native_solve(Z.mH, G)


def solve_vjp(Z, x, G, planes=None, path=None):
    """The cotangents of ``x = Z^-1 F`` at the solution x, given G of
    x's shape, in torch's complex convention: ``(Z_bar, F_bar) =
    (-lam x^H, lam)`` with ``Z^H lam = G``, one adjoint solve
    (:func:`_adjoint`: the kernel's adjoint entry on the card, on
    ``planes``, the forward's SoA planes of Z, at N <= 6), each of x's
    batch shape."""
    if path is None:
        path = solver_path(Z.shape[-1])
    lam = _adjoint(Z, planes, G.contiguous(), path)
    return -lam[..., :, None] * x.conj()[..., None, :], lam


def _sum_to(x, shape):
    """Sum ``x`` over the dimensions that broadcasting added to
    ``shape``."""
    lead = x.dim() - len(shape)
    if lead:
        x = x.sum(dim=tuple(range(lead)))
    keep = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(dim=keep, keepdim=True) if keep else x


class Keep:
    """The kernel's SoA planes of one Z (N <= 6 on the card; None
    elsewhere), kept between solves with that Z: :class:`_Solve`'s
    forward leaves them here.  A plain object, which torch.func passes
    through as it is."""

    __slots__ = ("planes",)

    def __init__(self, planes=None):
        self.planes = planes


class _Solve(torch.autograd.Function):
    """``x = Z^-1 F`` with the adjoint-solve backward, the tangent-solve
    jvp and a vmap rule that folds the vmapped dimension into the batch
    of systems.  The forward leaves the SoA planes of Z in ``keep``
    (:class:`Keep`, for the backward and the jvp); given planes there,
    of the same Z and batch, it launches on them."""

    @staticmethod
    def forward(Z, F, path, keep):
        x, keep.planes = _forward(Z, F, path, keep_planes=True,
                                  planes=keep.planes)
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        Z, F, path, keep = inputs
        ctx.path = path
        ctx.planes = keep.planes
        ctx.shapes = (Z.shape, F.shape)
        ctx.save_for_backward(Z, output)
        ctx.save_for_forward(Z, output)

    @staticmethod
    def backward(ctx, G):
        Z, x = ctx.saved_tensors
        gZ, lam = solve_vjp(Z, x, G, ctx.planes, ctx.path)
        return (_sum_to(gZ, ctx.shapes[0]) if ctx.needs_input_grad[0]
                else None,
                _sum_to(lam, ctx.shapes[1]) if ctx.needs_input_grad[1]
                else None, None, None)

    @staticmethod
    def jvp(ctx, dZ, dF, _path, _keep):
        """``dx = Z^-1 (dF - dZ x)``: one solve with the forward's Z (and
        its planes), through the forward's dispatch."""
        Z, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if dF is None else dF.expand_as(x)
        if dZ is not None:
            rhs = rhs - (dZ @ x[..., None])[..., 0]
        return _Solve.apply(Z, rhs, ctx.path, Keep(ctx.planes))

    @staticmethod
    def vmap(info, in_dims, Z, F, path, keep):
        """The vmapped dimension as the leading batch dimension of the
        systems (each operand's batch padded to the broadcast rank): one
        solve, one launch, for all of them."""
        zd, fd = in_dims[:2]
        r = max(Z.dim() - 2 - (zd is not None), F.dim() - 1 - (fd is not None))

        def lead(t, d, core):
            t = t.movedim(d, 0)
            return t.reshape(t.shape[:1] + (1,) * (r - (t.dim() - 1 - core))
                             + t.shape[1:])

        if zd is not None:
            Z = lead(Z, zd, 2)
        if fd is not None:
            F = lead(F, fd, 1)
        return _Solve.apply(Z, F, path, Keep()), 0


def cond_estimate(Z, path=None):
    """One-step Hager lower bound on ``kappa_1(Z)``: exact ``||Z||_1``
    times ``||Z^-1 e||_1`` with ``e = ones/N``; (..., N, N) -> (...)."""
    N = Z.shape[-1]
    norm1 = torch.amax(torch.sum(torch.abs(Z), dim=-2), dim=-1)
    e = torch.full(Z.shape[:-2] + (N,), 1.0 / N, dtype=Z.dtype,
                   device=Z.device)
    inv_lb = torch.sum(torch.abs(solve(Z, e, path=path)), dim=-1)
    return norm1 * inv_lb


def pivot_moduli(Z):
    """|pivot| of each step of the pivot-free elimination (that of
    :func:`_native_solve`, here in complex arithmetic) of Z (..., N, N)
    -> (..., N): how close a system comes to a zero pivot (compare Z
    with Z.mH for the adjoint solve)."""
    N = Z.shape[-1]
    rows = [Z[..., i, :] for i in range(N)]
    out = []
    for kk in range(N):
        p = rows[kk][..., kk]
        out.append(torch.abs(p))
        for ii in range(kk + 1, N):
            m = rows[ii][..., kk] / p
            rows[ii] = rows[ii] - m[..., None] * rows[kk]
    return torch.stack(out, dim=-1)


def _native_solve(Z, F):
    """The plain PyTorch version: pivot-free blocked elimination of the
    real 2N x 2N embedding as explicit (real, imag) pairs, in the
    reference's SSA row order."""
    N = Z.shape[-1]
    Ar, Ai = Z.real, Z.imag
    br, bi = F.real, F.imag
    bshape = torch.broadcast_shapes(Ar.shape[:-2], br.shape[:-1])
    rows = [(Ar[..., i, :].expand(bshape + (N,)),
             Ai[..., i, :].expand(bshape + (N,))) for i in range(N)]
    rhs = [(br[..., i].expand(bshape), bi[..., i].expand(bshape))
           for i in range(N)]

    for kk in range(N - 1):
        pkr, pki = rows[kk]
        fr, fi = rhs[kk]
        pr, pi = pkr[..., kk], pki[..., kk]
        d = pr * pr + pi * pi
        ivr, ivi = pr / d, -pi / d                       # 1/z_kk
        for ii in range(kk + 1, N):
            air, aii = rows[ii]
            cr, ci = air[..., kk], aii[..., kk]
            mr = cr * ivr - ci * ivi                     # multiplier
            mi = cr * ivi + ci * ivr
            rows[ii] = (air - (mr[..., None] * pkr - mi[..., None] * pki),
                        aii - (mr[..., None] * pki + mi[..., None] * pkr))
            gr, gi = rhs[ii]
            rhs[ii] = (gr - (mr * fr - mi * fi), gi - (mr * fi + mi * fr))

    xr = [None] * N
    xi = [None] * N
    for kk in range(N - 1, -1, -1):
        sr, si = rhs[kk]
        akr, aki = rows[kk]
        for jj in range(kk + 1, N):
            ar, ai = akr[..., jj], aki[..., jj]
            sr = sr - (ar * xr[jj] - ai * xi[jj])
            si = si - (ar * xi[jj] + ai * xr[jj])
        pr, pi = akr[..., kk], aki[..., kk]
        d = pr * pr + pi * pi
        xr[kk] = (sr * pr + si * pi) / d
        xi[kk] = (si * pr - sr * pi) / d
    return torch.complex(torch.stack(xr, dim=-1), torch.stack(xi, dim=-1))


# ------------------------------------------------------------ CUDA kernel

_LIB = None
_LIB_LOCK = threading.Lock()


def library_path():
    """Where the kernel library for the current source is built: the
    file name carries a hash of the source and the flags, so an edited
    source never loads a stale build."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liblinsolve_{h.hexdigest()[:12]}.so")


def build(force=False):
    """Compile ``csrc/linsolve.cu`` with ``nvcc`` for ``sm_90a`` into
    ``raft_tpu_torch/build/`` unless that build exists (or ``force``);
    returns the library path and, when it compiled, nvcc's ``-Xptxas
    -v`` report.  Raises ``RuntimeError`` with the compiler's output on
    failure."""
    global BUILT_HERE, NVCC_RUNS
    out = library_path()
    if os.path.exists(out) and not force:
        return out, ""
    budget.charge("nvcc")   # RAFT_TPU_COMPILE_BUDGET, before the run
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILT_HERE = True
        NVCC_RUNS += 1
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stderr


def use_library(path):
    """Load the kernel library from ``path`` (a program bank's copy,
    whose sha the bank checked) unless this process has loaded one
    already; returns the path of the library in use.  A process that
    loads the bank's copy before its first launch never calls
    :func:`build`, so it runs no ``nvcc``."""
    with _LIB_LOCK:
        if _LIB is None:
            _bind(path)
        return LIB_PATH


def loaded_library():
    """The path of the kernel library this process loaded, or None."""
    with _LIB_LOCK:
        return LIB_PATH


def _lib():
    with _LIB_LOCK:
        if _LIB is None:
            _bind(build()[0])
    return _LIB


def _bind(path):
    """dlopen ``path`` and declare its entries (under ``_LIB_LOCK``)."""
    global _LIB, LIB_PATH
    lib = ctypes.CDLL(path)
    args = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    for name in ("raft_ge_solve_f64", "raft_ge_solve_f32",
                 "raft_ge_solve_adj_f64", "raft_ge_solve_adj_f32"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    args = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
    for name in ("raft_ge_solve_rows_f64", "raft_ge_solve_rows_f32",
                 "raft_ge_solve_rows_adj_f64",
                 "raft_ge_solve_rows_adj_f32"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    _LIB, LIB_PATH = lib, path


def soa_planes(Z, F):
    """Z broadcast against F as :func:`solve` does, repacked into the
    kernel's batch-last (SoA) real/imag planes so neighbouring threads
    read neighbouring addresses: ``((zr, zi, fr, fi), bshape)`` with
    zr, zi (N * N, B) and fr, fi (N, B), each contiguous, B the size of
    the broadcast batch shape ``bshape``."""
    N = Z.shape[-1]
    bshape = torch.broadcast_shapes(Z.shape[:-2], F.shape[:-1])
    B = math.prod(bshape)
    rdt = torch.float64 if Z.dtype == torch.complex128 else torch.float32
    Zb = torch.view_as_real(Z.expand(bshape + (N, N)).reshape(B, N * N))
    Fb = torch.view_as_real(F.expand(bshape + (N,)).reshape(B, N))
    planes = (torch.empty((N * N, B), dtype=rdt, device=Z.device),
              torch.empty((N * N, B), dtype=rdt, device=Z.device),
              torch.empty((N, B), dtype=rdt, device=Z.device),
              torch.empty((N, B), dtype=rdt, device=Z.device))
    for dst, src in zip(planes, (Zb[..., 0], Zb[..., 1], Fb[..., 0],
                                 Fb[..., 1])):
        dst.copy_(src.T)
    return planes, bshape


def launch(planes, xr, xi, adjoint=False):
    """One launch of the kernel on :func:`soa_planes`' planes, writing
    the solution planes xr, xi (N, B) on the current stream; with
    ``adjoint`` the adjoint entry, which solves with Z^H from the same
    planes of Z (fr, fi then hold the cotangent).  Returns the C
    function's ``cudaError_t`` (0 on success).  Counts nothing: the
    wrappers count their own launches."""
    zr, zi, fr, fi = planes
    N, B = fr.shape
    f64 = zr.dtype == torch.float64
    lib = _lib()
    if adjoint:
        fn = lib.raft_ge_solve_adj_f64 if f64 else lib.raft_ge_solve_adj_f32
    else:
        fn = lib.raft_ge_solve_f64 if f64 else lib.raft_ge_solve_f32
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    with torch.cuda.device(zr.device):
        return fn(zr.data_ptr(), zi.data_ptr(), fr.data_ptr(), fi.data_ptr(),
                  xr.data_ptr(), xi.data_ptr(), B, N, THREADS, stream)


def _check_inputs(Z, F, who, lo=1):
    """Raise unless Z (..., N, N) and F (..., N) are complex128 or
    complex64 of one type on one CUDA device with lo <= N <= 12."""
    if Z.device.type != "cuda" or F.device != Z.device:
        raise ValueError(f"{who} needs Z and F on one CUDA device, "
                         f"got {Z.device} and {F.device}")
    if Z.dtype not in (torch.complex128, torch.complex64) or \
            F.dtype != Z.dtype:
        raise TypeError(f"{who} takes complex128 or complex64 Z and "
                        f"F of the same type, got {Z.dtype} and {F.dtype}")
    N = Z.shape[-1]
    if Z.dim() < 2 or Z.shape[-2] != N or F.dim() < 1 or F.shape[-1] != N \
            or not lo <= N <= MAX_NATIVE_N:
        raise ValueError(f"{who} takes Z (..., N, N) and F (..., N) "
                         f"with {lo} <= N <= {MAX_NATIVE_N}, got "
                         f"{tuple(Z.shape)} and {tuple(F.shape)}")


def _cuda_solve(Z, F, keep_planes=False, planes=None):
    """Launch the hand-written kernel on ``Z``'s CUDA device.

    At N <= 6 it repacks Z and F with :func:`soa_planes` and launches one
    thread per system on the current stream; at N = 7-12 it takes
    :func:`_cuda_solve_rows` (no planes).  Raises on a device, dtype,
    shape or launch the kernel does not take; there is no fallback.
    With ``keep_planes`` it returns ``(x, planes)``, the planes of Z for
    the adjoint entry (None at N = 7-12, whose adjoint reads Z).
    ``planes``, the SoA planes of this Z from an earlier call on the
    same broadcast batch (a tangent solve's), are used where they match
    that batch: only F is repacked.
    """
    global KERNEL_LAUNCHES
    _check_inputs(Z, F, "_cuda_solve")
    N = Z.shape[-1]
    if N >= ROW_MIN_N:
        x = _cuda_solve_rows(Z, F)
        return (x, None) if keep_planes else x
    bshape = torch.broadcast_shapes(Z.shape[:-2], F.shape[:-1])
    if planes is not None and planes[0].shape == (N * N, math.prod(bshape)) \
            and planes[0].device == Z.device and \
            planes[0].dtype == Z.real.dtype:
        Fb = torch.view_as_real(F.expand(bshape + (N,)).reshape(-1, N))
        planes = planes[:2] + (Fb[..., 0].T.contiguous(),
                               Fb[..., 1].T.contiguous())
    else:
        planes, bshape = soa_planes(Z, F)
    out_shape = bshape + (N,)
    if math.prod(bshape) == 0:
        x = torch.empty(out_shape, dtype=Z.dtype, device=Z.device)
        return (x, planes) if keep_planes else x
    xr = torch.empty_like(planes[2])
    xi = torch.empty_like(planes[2])
    err = launch(planes, xr, xi)
    if err != 0:
        raise RuntimeError(f"linsolve kernel launch failed: cudaError {err} "
                           f"(N={N}, batch shape={tuple(bshape)}, {Z.dtype})")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    _tally("ge_solve")
    x = torch.complex(xr.T, xi.T).reshape(out_shape)
    return (x, planes) if keep_planes else x


def _cuda_solve_adj(planes, G):
    """The adjoint entry: lam with ``Z^H lam = G`` from the forward's
    planes of Z (:func:`soa_planes`) and the cotangent G (..., N) of the
    forward's broadcast batch shape; only G is repacked.  Raises on a
    launch it cannot make."""
    global ADJ_KERNEL_LAUNCHES
    zr, zi = planes[0], planes[1]
    N = planes[2].shape[0]
    B = zr.shape[1]
    if G.device != zr.device or G.shape[-1] != N or \
            math.prod(G.shape[:-1]) != B:
        raise ValueError(f"_cuda_solve_adj: cotangent {tuple(G.shape)} on "
                         f"{G.device} does not match planes of {B} systems "
                         f"of size {N} on {zr.device}")
    if B == 0:
        return torch.empty_like(G)
    Gb = torch.view_as_real(G.to(torch.complex128 if zr.dtype == torch.float64
                                 else torch.complex64).reshape(B, N))
    fr = Gb[..., 0].T.contiguous()
    fi = Gb[..., 1].T.contiguous()
    xr = torch.empty_like(fr)
    xi = torch.empty_like(fr)
    err = launch((zr, zi, fr, fi), xr, xi, adjoint=True)
    if err != 0:
        raise RuntimeError(f"linsolve adjoint kernel launch failed: "
                           f"cudaError {err} (N={N}, {B} systems)")
    with _COUNT_LOCK:
        ADJ_KERNEL_LAUNCHES += 1
    _tally("ge_solve_adj")
    return torch.complex(xr.T, xi.T).reshape(G.shape)


def launch_rows(Z, F, x, adjoint=False):
    """One launch of the N = 7-12 design on Z (B, N, N) and F (B, N),
    writing x (B, N) on the current stream; with ``adjoint`` it solves
    ``Z^H x = F``.  Each tensor must be contiguous, of one complex type,
    unconjugated and aligned to its element (16 B for complex128).
    Raises ``ValueError`` on anything else; returns the C function's
    ``cudaError_t`` (0 on success).  Counts nothing: the wrapper counts
    its own launches."""
    N = Z.shape[-1]
    B = x.numel() // N
    if Z.shape != (B, N, N) or F.shape != (B, N) or x.shape != (B, N) or \
            not ROW_MIN_N <= N <= MAX_NATIVE_N:
        raise ValueError(f"launch_rows takes Z (B, N, N), F (B, N) and x "
                         f"(B, N) with {ROW_MIN_N} <= N <= {MAX_NATIVE_N}, "
                         f"got {tuple(Z.shape)}, {tuple(F.shape)} and "
                         f"{tuple(x.shape)}")
    for name, t in (("Z", Z), ("F", F), ("x", x)):
        if t.dtype != Z.dtype or t.device != Z.device or \
                not t.is_contiguous() or t.is_conj() or \
                t.data_ptr() % t.element_size():
            raise ValueError(f"launch_rows: {name} must be a contiguous, "
                             f"unconjugated {Z.dtype} tensor on {Z.device} "
                             f"aligned to {Z.element_size()} bytes")
    lib = _lib()
    f64 = Z.dtype == torch.complex128
    if adjoint:
        fn = lib.raft_ge_solve_rows_adj_f64 if f64 else \
            lib.raft_ge_solve_rows_adj_f32
    else:
        fn = lib.raft_ge_solve_rows_f64 if f64 else lib.raft_ge_solve_rows_f32
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    with torch.cuda.device(Z.device):
        return fn(Z.data_ptr(), F.data_ptr(), x.data_ptr(), B, N, stream)


def _cuda_solve_rows(Z, F, adjoint=False):
    """The kernel's N = 7-12 design, one lane per row, on Z and F in
    PyTorch's layout: Z is broadcast against F as :func:`solve` does.  A
    Z that has F's batch shape is read where it lies when it is
    contiguous; a broadcast Z is materialised once, and F is made
    contiguous (1/N of Z's bytes).  With ``adjoint`` it solves ``Z^H x
    = F`` (F then the cotangent, of the forward's broadcast batch
    shape).  Raises on anything the kernel does not take or a launch it
    cannot make; there is no fallback."""
    global KERNEL_LAUNCHES, ADJ_KERNEL_LAUNCHES, ROW_KERNEL_LAUNCHES, \
        ROW_ADJ_KERNEL_LAUNCHES
    _check_inputs(Z, F, "_cuda_solve_rows", lo=ROW_MIN_N)
    N = Z.shape[-1]
    bshape = torch.broadcast_shapes(Z.shape[:-2], F.shape[:-1])
    x = torch.empty(bshape + (N,), dtype=Z.dtype, device=Z.device)
    B = math.prod(bshape)
    if B == 0:
        return x
    Zc = Z.expand(bshape + (N, N)).resolve_conj().contiguous()
    Fc = F.expand(bshape + (N,)).resolve_conj().contiguous()
    err = launch_rows(Zc.view(B, N, N), Fc.view(B, N), x.view(B, N),
                      adjoint)
    if err != 0:
        raise RuntimeError(f"linsolve {'adjoint ' if adjoint else ''}row "
                           f"kernel launch failed: cudaError {err} (N={N}, "
                           f"batch shape={tuple(bshape)}, {Z.dtype})")
    with _COUNT_LOCK:
        if adjoint:
            ADJ_KERNEL_LAUNCHES += 1
            ROW_ADJ_KERNEL_LAUNCHES += 1
        else:
            KERNEL_LAUNCHES += 1
        ROW_KERNEL_LAUNCHES += 1
    _tally("ge_solve_rows_adj" if adjoint else "ge_solve_rows")
    return x


def reset_launches():
    """Set :data:`KERNEL_LAUNCHES`, :data:`ADJ_KERNEL_LAUNCHES`,
    :data:`ROW_KERNEL_LAUNCHES` and :data:`ROW_ADJ_KERNEL_LAUNCHES` to 0
    (returns the previous forward count)."""
    global KERNEL_LAUNCHES, ADJ_KERNEL_LAUNCHES, ROW_KERNEL_LAUNCHES, \
        ROW_ADJ_KERNEL_LAUNCHES
    with _COUNT_LOCK:
        n = KERNEL_LAUNCHES
        KERNEL_LAUNCHES = ADJ_KERNEL_LAUNCHES = ROW_KERNEL_LAUNCHES = \
            ROW_ADJ_KERNEL_LAUNCHES = 0
    return n


def forward_launches():
    """:data:`KERNEL_LAUNCHES` now, read under the counters' lock."""
    with _COUNT_LOCK:
        return KERNEL_LAUNCHES


def launch_ledger():
    """The kernel's launches in this process, one count per entry:
    ``ge_solve`` (N <= 6), ``ge_solve_adj`` (its adjoint),
    ``ge_solve_rows`` (N = 7-12) and ``ge_solve_rows_adj`` (read under
    the counters' lock)."""
    with _COUNT_LOCK:
        fwd, adj = KERNEL_LAUNCHES, ADJ_KERNEL_LAUNCHES
        rows, rows_adj = ROW_KERNEL_LAUNCHES, ROW_ADJ_KERNEL_LAUNCHES
    rows_fwd = rows - rows_adj
    return {"ge_solve": fwd - rows_fwd, "ge_solve_adj": adj - rows_adj,
            "ge_solve_rows": rows_fwd, "ge_solve_rows_adj": rows_adj}


LEDGER_KEYS = ("ge_solve", "ge_solve_adj", "ge_solve_rows",
               "ge_solve_rows_adj")


def _tally(entry):
    """One launch of ``entry`` on the calling thread's own ledger."""
    counts = getattr(_THREAD, "counts", None)
    if counts is None:
        counts = _THREAD.counts = dict.fromkeys(LEDGER_KEYS, 0)
    counts[entry] += 1


def thread_launch_ledger():
    """The kernel's launches made by the calling thread, by entry (the
    keys of :func:`launch_ledger`): a sweep's entry thread reads its own
    launches here, apart from its peers' on the same card."""
    return dict(getattr(_THREAD, "counts", None)
                or dict.fromkeys(LEDGER_KEYS, 0))
