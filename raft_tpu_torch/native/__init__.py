"""ctypes binding of the host panel solver (counterpart of
``raft_tpu/native/__init__.py``).

The solver is host C++, ``raft_tpu_torch/csrc/panel_bem.cpp``: influence
assembly with the free-surface wave Green function and a dense pivoted
LU per frequency.  :func:`build` compiles it with ``g++ -O3 -shared
-fPIC`` at first use into ``raft_tpu_torch/build/``, under a file name
that carries a hash of the source and the flags, so an edited source is
rebuilt and a stale build is never loaded.

* :func:`solve_bem_frequency` — radiation and diffraction at one
  frequency: the finite-depth eigenfunction series where K h <= 6
  (:mod:`raft_tpu_torch.native.green_fd` gives its roots and
  coefficients), else the tabulated infinite-depth kernel
  (:mod:`raft_tpu_torch.native.green_table`) at the finite-depth wave
  number;
* :func:`solve_bem` — a frequency sweep, the frequencies in a thread
  pool (each call releases the GIL; the result does not depend on the
  worker count);
* :func:`radiation_added_mass` — the frequency-limit added mass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "panel_bem.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path():
    """Where the library of the current source and flags is built."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpanel_bem_{h.hexdigest()[:12]}.so")


def build(force=False):
    """Compile ``csrc/panel_bem.cpp`` with ``g++`` into
    ``raft_tpu_torch/build/`` unless that build exists (or ``force``);
    returns the library path.  Raises ``RuntimeError`` with the
    compiler's output on failure."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _dbl():
    return np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _load():
    """The loaded library with its entry points' signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.panel_radiation_added_mass.restype = ctypes.c_int
            lib.panel_radiation_added_mass.argtypes = [
                ctypes.c_int, _dbl(), _dbl(), _dbl(), _dbl(),  # mesh
                ctypes.c_int, ctypes.c_double, _dbl(),         # mirror, rho, ref
                _dbl(),                                        # output
            ]
            lib.panel_solve_frequency.restype = ctypes.c_int
            lib.panel_solve_frequency.argtypes = [
                ctypes.c_int, _dbl(), _dbl(), _dbl(), _dbl(),  # mesh
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,                               # K, w, rho, g
                _dbl(),                                        # ref
                ctypes.c_int, _dbl(),                          # headings
                ctypes.c_int, ctypes.c_int, _dbl(), _dbl(), _dbl(),
                _dbl(),                                        # tables
                _dbl(), _dbl(), _dbl(),                        # outputs
            ]
            lib.panel_solve_frequency_fd.restype = ctypes.c_int
            lib.panel_solve_frequency_fd.argtypes = [
                ctypes.c_int, _dbl(), _dbl(), _dbl(), _dbl(),  # mesh
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,                               # w, rho, g, h
                _dbl(),                                        # ref
                ctypes.c_int, _dbl(),                          # headings
                ctypes.c_int, ctypes.c_double, _dbl(), _dbl(),  # modes
                _dbl(), _dbl(), _dbl(),                        # outputs
            ]
            _lib = lib
    return _lib


def _fd_mode_count(depth, areas, n_modes, n_cap=16384):
    """Evanescent mode count that keeps the kernel's small-R
    extrapolation cutoff Rc = 40 h / (pi n_modes) at or below half the
    panel edge scale (sqrt of the smallest panel area), so near-field
    accuracy tracks mesh refinement; capped at ``n_cap`` with a
    warning."""
    import warnings

    d_panel = float(np.sqrt(np.min(np.asarray(areas))))
    need = int(np.ceil(80.0 * depth / (np.pi * max(d_panel, 1e-9))))
    if need <= n_modes:
        return n_modes
    if need > n_cap:
        warnings.warn(
            f"finite-depth Green function: {need} evanescent modes needed "
            f"to resolve panel spacing {d_panel:.3g} m at depth {depth:.3g} "
            f"m exceeds the cap {n_cap}; near-diagonal influences use the "
            "smooth-remainder extrapolation below "
            f"Rc={40.0 * depth / (np.pi * n_cap):.3g} m")
        return n_cap
    return need


def _mesh(vertices, centroids, normals, areas):
    return (np.ascontiguousarray(vertices, dtype=np.float64).reshape(-1),
            np.ascontiguousarray(centroids, dtype=np.float64).reshape(-1),
            np.ascontiguousarray(normals, dtype=np.float64).reshape(-1),
            np.ascontiguousarray(areas, dtype=np.float64))


def solve_bem_frequency(vertices, centroids, normals, areas, omega,
                        headings_rad=(0.0,), depth=np.inf, rho=1025.0,
                        g=9.81, ref=(0.0, 0.0, 0.0), n_modes=512):
    """Radiation and diffraction at one frequency: (A (6, 6), B (6, 6),
    X (nh, 6) complex per unit wave amplitude).

    A finite depth with K h = omega^2 depth / g <= 6 takes the
    finite-depth series (propagating mode + ``n_modes`` evanescent
    modes, at least :func:`_fd_mode_count`); above it the finite- and
    infinite-depth kernels agree to ~e^{-2Kh} and the tabulated
    infinite-depth kernel runs at the finite-depth wave number."""
    from raft_tpu_torch.native.green_fd import _evan_coeffs, dispersion_roots
    from raft_tpu_torch.native.green_table import build_tables
    from raft_tpu_torch.ops.waves import wave_number

    lib = _load()
    n = len(areas)
    nh = len(headings_rad)
    A = np.zeros(36)
    B = np.zeros(36)
    X = np.zeros(nh * 12)
    mesh = _mesh(vertices, centroids, normals, areas)
    ref = np.ascontiguousarray(ref, dtype=np.float64)
    heads = np.ascontiguousarray(headings_rad, dtype=np.float64)

    Kdeep = omega * omega / g
    if np.isfinite(depth) and Kdeep * depth <= 6.0:
        n_modes = _fd_mode_count(float(depth), areas, int(n_modes))
        k0, km = dispersion_roots(Kdeep, float(depth), int(n_modes))
        Cm = _evan_coeffs(km, Kdeep, float(depth))
        rc = lib.panel_solve_frequency_fd(
            n, *mesh, float(omega), float(rho), float(g), float(depth), ref,
            nh, heads, int(n_modes), float(k0), np.ascontiguousarray(km),
            np.ascontiguousarray(Cm), A, B, X)
    else:
        t = build_tables()
        K = (float(wave_number(np.asarray([omega]), depth, g=g)[0])
             if np.isfinite(depth) else Kdeep)
        rc = lib.panel_solve_frequency(
            n, *mesh, K, float(omega), float(rho), float(g), ref, nh, heads,
            len(t["lnd"]), len(t["alpha"]), np.ascontiguousarray(t["lnd"]),
            np.ascontiguousarray(t["alpha"]),
            np.ascontiguousarray(t["L"]).reshape(-1),
            np.ascontiguousarray(t["M"]).reshape(-1), A, B, X)
    if rc != 0:
        raise RuntimeError("panel frequency solve failed (singular system)")
    Xc = X.reshape(nh, 6, 2)
    return A.reshape(6, 6), B.reshape(6, 6), Xc[..., 0] + 1j * Xc[..., 1]


def solve_bem(vertices, centroids, normals, areas, omegas,
              headings_deg=(0.0,), depth=np.inf, rho=1025.0, g=9.81,
              ref=(0.0, 0.0, 0.0), workers=None):
    """Frequency sweep: A (6, 6, nw), B (6, 6, nw), X (nh, 6, nw)
    complex.  The frequencies are independent dense solves and run in a
    pool of ``workers`` threads (default: the cores less one, at most
    8)."""
    import concurrent.futures as cf

    from raft_tpu_torch.native.green_table import build_tables

    omegas = np.asarray(omegas, dtype=float)
    nh = len(headings_deg)
    heads = np.deg2rad(np.asarray(headings_deg, dtype=float))
    A = np.zeros((6, 6, len(omegas)))
    B = np.zeros((6, 6, len(omegas)))
    X = np.zeros((nh, 6, len(omegas)), dtype=np.complex128)
    # the table and the library are loaded once, before the pool
    build_tables()
    _load()

    def one(iw):
        A[:, :, iw], B[:, :, iw], X[:, :, iw] = solve_bem_frequency(
            vertices, centroids, normals, areas, omegas[iw], heads,
            depth, rho, g, ref)

    workers = workers or min(8, max(1, (os.cpu_count() or 2) - 1))
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, range(len(omegas))))
    return A, B, X


def radiation_added_mass(vertices, centroids, normals, areas, mirror=-1,
                         rho=1025.0, ref=(0.0, 0.0, 0.0)):
    """6 x 6 frequency-limit added mass: ``mirror`` -1 the
    high-frequency free surface (phi = 0, A(w -> inf)), +1 a rigid lid
    (A(w -> 0))."""
    lib = _load()
    A = np.zeros(36)
    rc = lib.panel_radiation_added_mass(
        len(areas), *_mesh(vertices, centroids, normals, areas), int(mirror),
        float(rho), np.ascontiguousarray(ref, dtype=np.float64), A)
    if rc != 0:
        raise RuntimeError("panel radiation solve failed (singular system)")
    return A.reshape(6, 6)
