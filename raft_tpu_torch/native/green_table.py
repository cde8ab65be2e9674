"""Free-surface Green-function wave-term tables (counterpart of
``raft_tpu/native/green_table.py``, plain numpy and scipy).

The infinite-depth wave Green function (source + its free-surface wave
part; Wehausen & Laitone eq. 13.17) is

    G = 1/r + 1/r1 + 2K L(R, Z) + i 2 pi K e^Z J0(R)

with nondimensional horizontal distance R = K R_h and vertical
Z = K (z + zeta) <= 0 (field + source depth), K = w^2/g, r1 the
distance to the image point, and the principal-value integral

    L(R, Z) = PV int_0^inf  e^{mu Z} J0(mu R) / (mu - 1)  d mu .

The gradient needs the companion J1 kernel

    M(R, Z) = PV int_0^inf  e^{mu Z} J1(mu R) / (mu - 1)  d mu

through the exact relations (all derived by mu/(mu-1) = 1 + 1/(mu-1)):

    dL/dZ = L + 1/d,          d = sqrt(R^2 + Z^2)
    dL/dR = -( (d - |Z|) / (R d)  +  M )

L and M are tabulated on a (ln d, alpha = R/d) grid, the coordinates in
which the d -> 0 log singularity is linear, by scipy quadrature:

* [0, 2]: QAWC Cauchy-weight quadrature (exact PV handling);
* [2, inf): block integration between Bessel zeros with repeated
  averaging (Euler transform) of the alternating partial sums, which
  converges for the conditionally-convergent Z -> 0 tails.

The table ships with the package (``green_table_v1.npz``, written by
:func:`build_tables` of this module): building it takes minutes of
quadrature, so :func:`build_tables` loads the shipped file and builds
only when it is missing or when asked to (``rebuild=True``; the rows
run in a pool of processes, and since the nodes are independent the
table does not depend on their number).  The panel solver receives
the raw arrays and interpolates bilinearly (:func:`interp_L` is the
same scheme in numpy).
"""

from __future__ import annotations

import os

import numpy as np

#: the table shipped with the package
TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "green_table_v1.npz")

# grid: ln d in [ln 1e-5, ln 700], alpha = R/d in [0, 1]
ND, NA = 280, 72
LND = np.linspace(np.log(1e-5), np.log(700.0), ND)
ALPHA = np.linspace(0.0, 1.0, NA)

_tables = None


def _tail_blocks(order, R, Z, a0, n_blocks=80, tol=1e-11):
    """int_a0^inf e^{mu Z} J_order(mu R)/(mu-1) dmu by Bessel-zero blocks
    with repeated averaging of the alternating partial sums."""
    from scipy.special import exp1, j0, j1, jn_zeros

    if R < 1e-12:
        if order == 1:
            return 0.0
        # J0 -> 1: exact via exponential integral (Z < 0 strictly)
        if Z > -1e-300:
            Z = -1e-300
        return np.exp(Z) * exp1((a0 - 1.0) * (-Z))

    jfun = j0 if order == 0 else j1
    zeros = jn_zeros(order, n_blocks + 2) / R
    bounds = [a0] + [z for z in zeros if z > a0]
    if len(bounds) < 3:
        # oscillation slower than any decay window: direct quad
        from scipy.integrate import quad

        val, _ = quad(lambda mu: np.exp(mu * Z) * jfun(mu * R) / (mu - 1.0),
                      a0, a0 + max(60.0 / max(-Z, 1e-3), 10 * np.pi / R),
                      limit=400)
        return val

    # integrate each block with fixed Gauss-Legendre
    gx, gw = np.polynomial.legendre.leggauss(12)
    vals = []
    for i in range(len(bounds) - 1):
        a, b = bounds[i], bounds[i + 1]
        mu = 0.5 * (a + b) + 0.5 * (b - a) * gx
        f = np.exp(mu * Z) * jfun(mu * R) / (mu - 1.0)
        vals.append(0.5 * (b - a) * np.dot(gw, f))
        if abs(vals[-1]) < tol and i > 2:
            break
    partial = np.cumsum(vals)
    # repeated averaging (Euler transform) for the alternating tail
    s = partial[max(0, len(partial) - 24):].astype(float)
    while len(s) > 1:
        s = 0.5 * (s[1:] + s[:-1])
    return float(s[0])


def _pv_node(order, R, Z):
    """PV int_0^inf e^{mu Z} J_order(mu R)/(mu-1) dmu."""
    from scipy.integrate import quad
    from scipy.special import j0, j1

    jfun = j0 if order == 0 else j1

    def f(mu):
        return np.exp(mu * Z) * jfun(mu * R)

    # PV over [0, 2] via Cauchy-weight quadrature
    I1, _ = quad(f, 0.0, 2.0, weight="cauchy", wvar=1.0, limit=200)
    return I1 + _tail_blocks(order, R, Z, 2.0)


def _table_row(i):
    """Row ``i`` of L and M (the NA nodes at ln d = LND[i])."""
    d = np.exp(LND[i])
    L = np.zeros(NA)
    M = np.zeros(NA)
    for j, a in enumerate(ALPHA):
        R = d * a
        Z = -d * np.sqrt(max(0.0, 1.0 - a * a))
        L[j] = _pv_node(0, R, Z)
        M[j] = _pv_node(1, R, Z)
    return L, M


def build_tables(rebuild=False, path=None):
    """The L and M tables: dict of ``lnd`` (ND,), ``alpha`` (NA,), ``L``
    and ``M`` (ND, NA).  Loads the shipped :data:`TABLE` (once per
    process); with ``rebuild=True``, or when the file is missing,
    computes the table and writes it to ``path`` (default
    :data:`TABLE`)."""
    global _tables
    if not rebuild:
        if _tables is not None:
            return _tables
        if os.path.exists(TABLE):
            with np.load(TABLE) as d:
                if len(d["lnd"]) == ND and len(d["alpha"]) == NA:
                    _tables = dict(lnd=d["lnd"], alpha=d["alpha"], L=d["L"],
                                   M=d["M"])
                    return _tables

    import concurrent.futures as cf
    import multiprocessing

    # spawned workers: forking a process that runs threads can deadlock
    with cf.ProcessPoolExecutor(
            mp_context=multiprocessing.get_context("spawn")) as ex:
        rows = list(ex.map(_table_row, range(ND)))
    t = dict(lnd=LND, alpha=ALPHA, L=np.stack([r[0] for r in rows]),
             M=np.stack([r[1] for r in rows]))
    np.savez_compressed(path or TABLE, **t)
    if path is None or os.path.abspath(path) == TABLE:
        _tables = t
    return t


def interp_L(R, Z):
    """Bilinear interpolation of L, the scheme the C++ kernel uses
    (numpy; for table self-tests)."""
    t = build_tables()
    d = np.sqrt(R**2 + Z**2)
    d = np.clip(d, np.exp(t["lnd"][0]), np.exp(t["lnd"][-1]))
    a = np.clip(R / d, 0.0, 1.0)
    x = np.log(d)
    i = np.clip(np.searchsorted(t["lnd"], x) - 1, 0, ND - 2)
    j = np.clip(np.searchsorted(t["alpha"], a) - 1, 0, NA - 2)
    fx = (x - t["lnd"][i]) / (t["lnd"][i + 1] - t["lnd"][i])
    fa = (a - t["alpha"][j]) / (t["alpha"][j + 1] - t["alpha"][j])
    T = t["L"]
    return ((1 - fx) * (1 - fa) * T[i, j] + fx * (1 - fa) * T[i + 1, j]
            + (1 - fx) * fa * T[i, j + 1] + fx * fa * T[i + 1, j + 1])
