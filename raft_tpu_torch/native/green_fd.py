"""Finite-depth free-surface Green function (John's eigenfunction
series; counterpart of ``raft_tpu/native/green_fd.py``, plain numpy):
the per-frequency constants the panel solver's finite-depth branch
takes (:func:`dispersion_roots`, :func:`_evan_coeffs`) and the two
validation oracles (:func:`green_fd_series`, :func:`green_fd_reference`).

The finite-depth wave source potential (Wehausen & Laitone eq. 13.19)
is

    G = 1/r + 1/r2 + Gw,     r2 = image about the SEABED z = -h,

    Gw = 2 PV int_0^inf  (mu+K) e^{-mu h} cosh mu(z+h) cosh mu(zeta+h)
                         / (mu sinh mu h - K cosh mu h) J0(mu R) dmu
         + i 2 pi (k0+K) e^{-k0 h} cosh k0(z+h) cosh k0(zeta+h)
                         / D'(k0) J0(k0 R)

with K = omega^2/g and k0 the real dispersion root
k0 tanh k0 h = K.  The equivalent eigenfunction (John's) series for the
TOTAL G, exponentially convergent in the evanescent modes for R > 0,
is

    G = 2 pi C0 cosh k0(z+h) cosh k0(zeta+h) (-Y0(k0 R) + i J0(k0 R))
        + 4 sum_m Cm cos km(z+h) cos km(zeta+h) K0(km R)

    C0 = (k0^2 - K^2) / ( h (k0^2 - K^2) + K )
    Cm = (km^2 + K^2) / ( h (km^2 + K^2) - K )

with km the evanescent roots km tan km h = -K (one per interval
((m-1/2) pi/h, m pi/h)).  The stable forms divide the unbounded
cosh factors through the coefficient so every exponent is <= 0
(:func:`_prop_factor`).
"""

from __future__ import annotations

import numpy as np


def dispersion_roots(K, h, n_modes):
    """k0 (real root of k tanh kh = K) and km (m=1..n_modes roots of
    k tan kh = -K, km in ((m-1/2) pi/h, m pi/h))."""
    # real root: Newton on y tanh y = Kh (y = k h) from the deep guess
    Kh = K * h
    y = max(Kh, np.sqrt(max(Kh, 1e-12)))
    for _ in range(100):
        t = np.tanh(y)
        f = y * t - Kh
        df = t + y * (1 - t * t)
        dy = f / df
        y -= dy
        if abs(dy) < 1e-14 * max(y, 1.0):
            break
    k0 = y / h

    km = np.zeros(n_modes)
    for m in range(1, n_modes + 1):
        # f(y) = y tan y + Kh on ((m-1/2) pi, m pi): -inf at the left
        # endpoint, +Kh at the right — bracketed bisection, then Newton
        lo = (m - 0.5) * np.pi + 1e-9
        hi = m * np.pi - 1e-12
        for _ in range(80):
            y = 0.5 * (lo + hi)
            if y * np.tan(y) + Kh < 0:
                lo = y
            else:
                hi = y
        y = 0.5 * (lo + hi)
        for _ in range(5):
            t = np.tan(y)
            f = y * t + Kh
            df = t + y * (1 + t * t)
            if df == 0:
                break
            y -= f / df
        km[m - 1] = y / h
    return k0, km


def _prop_factor(k0, K, h, z, zeta):
    """C0 cosh k0(z+h) cosh k0(zeta+h) with no overflow:
    = k0^2 [cosh k0(z+h) cosh k0(zeta+h) / cosh^2 k0 h]
      / (h k0^2 + K cosh^2 k0 h / cosh^2 k0 h * ... )

    Using k0^2 - K^2 = k0^2 / cosh^2(k0 h) * (cosh^2 - sinh^2 ... ):
    exactly, K = k0 tanh k0 h so k0^2 - K^2 = k0^2 (1 - tanh^2)
    = k0^2 / cosh^2 k0 h, hence

    C0 cosh a cosh b = k0^2 * [cosh a cosh b / cosh^2 k0 h]
                       / ( h k0^2 / cosh^2 k0 h + K ).

    cosh a cosh b / cosh^2 k0h is evaluated in exp form with all
    exponents <= 0 (a, b <= k0 h for z, zeta in [-h, 0])."""
    a = k0 * (np.asarray(z) + h)
    b = k0 * (np.asarray(zeta) + h)
    c = k0 * h
    # cosh a / cosh c = e^{a-c} (1+e^{-2a}) / (1+e^{-2c})
    f = (np.exp(a + b - 2 * c) * (1 + np.exp(-2 * a)) * (1 + np.exp(-2 * b))
         / (1 + np.exp(-2 * c)) ** 2)
    sech2 = 1.0 / np.cosh(c) ** 2 if c < 350 else 4.0 * np.exp(-2 * c)
    return k0 ** 2 * f / (h * k0 ** 2 * sech2 + K)


def _evan_coeffs(km, K, h):
    """Cm for the stable form: Cm = km^2 / (h km^2 - K cos^2 km h)
    times cos^2 km h absorbed into the cos-product normalisation —
    returned as the plain Cm = (km^2+K^2)/(h(km^2+K^2)-K)."""
    k2K2 = km ** 2 + K ** 2
    return k2K2 / (h * k2K2 - K)


def green_fd_series(Rh, z, zeta, K, h, n_modes=80):
    """Total finite-depth G (WITHOUT any Rankine subtraction) by the
    eigenfunction series; scalar/broadcast numpy.  Valid for Rh > 0."""
    from scipy.special import j0, k0 as K0, y0

    kr, km = dispersion_roots(K, h, n_modes)
    A0 = _prop_factor(kr, K, h, z, zeta)
    G = 2 * np.pi * A0 * (-y0(kr * Rh) + 1j * j0(kr * Rh))
    Cm = _evan_coeffs(km, K, h)
    zc = (np.asarray(z) + h)
    zz = (np.asarray(zeta) + h)
    for m in range(n_modes):
        G = G + 4 * Cm[m] * np.cos(km[m] * zc) * np.cos(km[m] * zz) * K0(km[m] * Rh)
    return G


def green_fd_reference(Rh, z, zeta, K, h):
    """Scipy PV-integral evaluation of the WAVE part Gw (see module
    docstring) plus the two Rankine terms 1/r(=0 here; Rh>0 assumed
    with z != zeta possible) — returns the TOTAL G for validation.

    The ratios N/D and N/D' are evaluated in exp-normalised form (every
    exponent <= 0 for z, zeta in [-h, 0]: a+b-2c = mu(z+zeta) <= 0), so
    the integrand never overflows even for near-surface point pairs at
    large mu*h where the naive cosh/sinh factors exceed float range.

    Slow; used only in tests."""
    from scipy.integrate import quad
    from scipy.special import j0

    k0v, _ = dispersion_roots(K, h, 1)

    def N_over_D(mu):
        # N = (mu+K) e^{-c} cosh a cosh b,  D = mu sinh c - K cosh c
        # with a = mu(z+h), b = mu(zeta+h), c = mu h (all >= 0):
        # N/D = (mu+K) e^{a+b-2c} (1+e^{-2a})(1+e^{-2b})
        #       / (2 [mu(1-e^{-2c}) - K(1+e^{-2c})])
        a = mu * (z + h)
        b = mu * (zeta + h)
        c = mu * h
        num = (mu + K) * np.exp(a + b - 2 * c) \
            * (1 + np.exp(-2 * a)) * (1 + np.exp(-2 * b))
        den = 2.0 * (mu * (1 - np.exp(-2 * c)) - K * (1 + np.exp(-2 * c)))
        return num / den

    def N_over_dD(mu):
        # D' = sinh c + mu h cosh c - K h sinh c
        #    = e^c/2 [(1-Kh)(1-e^{-2c}) + mu h (1+e^{-2c})]
        a = mu * (z + h)
        b = mu * (zeta + h)
        c = mu * h
        num = (mu + K) * np.exp(a + b - 2 * c) \
            * (1 + np.exp(-2 * a)) * (1 + np.exp(-2 * b))
        den = 2.0 * ((1 - K * h) * (1 - np.exp(-2 * c))
                     + mu * h * (1 + np.exp(-2 * c)))
        return num / den

    def integrand(mu):
        return 2.0 * N_over_D(mu) * j0(mu * Rh)

    # PV: split at the pole k0 with symmetric excision + Cauchy weight
    def f_cauchy(mu):
        # integrand = fc(mu)/(mu - k0): fc = 2 N J0 (mu-k0)/D
        if abs(mu - k0v) < 1e-12:
            return 2.0 * N_over_dD(mu) * j0(mu * Rh)  # derivative limit
        return 2.0 * N_over_D(mu) * j0(mu * Rh) * (mu - k0v)

    a, b = max(k0v - 0.5 * k0v, 1e-10), k0v + 0.5 * k0v
    pv, _ = quad(f_cauchy, a, b, weight="cauchy", wvar=k0v, limit=400)
    head, _ = quad(integrand, 0, a, limit=400)
    # tail: decays like e^{mu(z+zeta)} J0 oscillation; integrate far
    span = max(60.0 / max(-(z + zeta), 1e-3), 30.0 / max(Rh, 1e-3), 50 / h)
    tail, _ = quad(integrand, b, b + span, limit=2000)

    res_term = 2j * np.pi * N_over_dD(k0v) * j0(k0v * Rh)

    Gw = head + pv + tail + res_term
    r = np.sqrt(Rh ** 2 + (z - zeta) ** 2)
    r2 = np.sqrt(Rh ** 2 + (z + zeta + 2 * h) ** 2)
    return 1.0 / r + 1.0 / r2 + Gw
