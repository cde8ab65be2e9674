"""WAMIT-format hydrodynamic coefficient file I/O (counterpart of
``raft_tpu/io/wamit.py``, numpy; the writers' formats are the
reference's character for character, since the panel solver's
coefficients round-trip through them).

RAFT consumes pre-computed potential-flow coefficients in the WAMIT
interchange format via pyHAMS (``raft_fowt.py:1444-1509`` readHydro;
``readQTF`` :2081-2129):

* ``.1``  — added mass / radiation damping: rows of
  [period, i, j, Abar(, Bbar)], nondimensional (A = rho Abar,
  B = rho w Bbar).  Sentinel periods: T < 0 is zero frequency,
  T = 0 is infinite frequency.
* ``.3``  — excitation: [period, heading, i, |X|, phase, Re, Im]
  (nondimensional; X = rho g Xbar).

Parsing is numpy at build time; the interpolated model-grid arrays are
constants of the evaluators.
"""

from __future__ import annotations

import os

import numpy as np


def read_wamit1(path):
    """Read a .1 file -> (w (nfreq,), A (6,6,nfreq), B (6,6,nfreq)),
    nondimensional, sorted by ascending frequency.  Zero-frequency /
    infinite-frequency sentinel rows are mapped to w = 0 / np.inf."""
    data = np.loadtxt(path)
    T = data[:, 0]
    w = np.where(T < 0, 0.0, np.where(T == 0, np.inf, 2 * np.pi / np.where(T == 0, 1, T)))
    freqs = np.unique(w)
    A = np.zeros((6, 6, len(freqs)))
    B = np.zeros((6, 6, len(freqs)))
    idx = {f: n for n, f in enumerate(freqs)}
    for row, wi in zip(data, w):
        i, j = int(row[1]) - 1, int(row[2]) - 1
        n = idx[wi]
        A[i, j, n] = row[3]
        if len(row) > 4:
            B[i, j, n] = row[4]
    return freqs, A, B


def read_wamit3(path):
    """Read a .3 file -> (w (nf,), headings (nh,), X (nh,6,nf) complex),
    nondimensional."""
    data = np.loadtxt(path)
    T = data[:, 0]
    w = np.where(T < 0, 0.0, np.where(T == 0, np.inf, 2 * np.pi / np.where(T == 0, 1, T)))
    freqs = np.unique(w)
    heads = np.unique(data[:, 1])
    X = np.zeros((len(heads), 6, len(freqs)), dtype=np.complex128)
    fi = {f: n for n, f in enumerate(freqs)}
    hi = {h: n for n, h in enumerate(heads)}
    for row, wi in zip(data, w):
        X[hi[row[1]], int(row[2]) - 1, fi[wi]] = row[5] + 1j * row[6]
    return freqs, heads, X


def write_wamit1(path, w, A, B, rho=1025.0, ulen=1.0):
    """Write added mass / radiation damping in the WAMIT .1 interchange
    format (nondimensional: Abar = A/(rho ULEN^k), Bbar = B/(rho w ULEN^k);
    ULEN exponent handled as in read_wamit1's inverse)."""
    w = np.asarray(w)
    with open(path, "w") as f:
        for iw, wi in enumerate(w):
            T = 2 * np.pi / wi
            for i in range(6):
                for j in range(6):
                    f.write(f" {T: .6e} {i+1:5d} {j+1:5d}"
                            f" {A[i, j, iw] / rho: .6e}"
                            f" {B[i, j, iw] / (rho * wi): .6e}\n")


def write_wamit3(path, w, headings_deg, X, rho=1025.0, g=9.81):
    """Write excitation coefficients in the WAMIT .3 format
    (X (nh, 6, nw) complex, dimensional; file stores X/(rho g))."""
    w = np.asarray(w)
    with open(path, "w") as f:
        for iw, wi in enumerate(w):
            T = 2 * np.pi / wi
            for ih, h in enumerate(headings_deg):
                for i in range(6):
                    x = X[ih, i, iw] / (rho * g)
                    f.write(f" {T: .6e} {h: .4f} {i+1:5d}"
                            f" {abs(x): .6e} {np.degrees(np.angle(x)): .6e}"
                            f" {x.real: .6e} {x.imag: .6e}\n")


def write_rao_4(path, w, Xi, beta_deg=0.0):
    """Write motion RAOs in the WAMIT .4 column layout the reference
    emits next to its QTF outputs (raft_fowt.py:2027-2041): rows of
    [period, heading, DoF, |x|, phase(rad), Re x, Im x] for
    ``Xi`` (ndof, nw) complex (response per unit wave amplitude)."""
    w = np.asarray(w)
    Xi = np.asarray(Xi)
    with open(path, "w") as f:
        for idof in range(Xi.shape[0]):
            for wi, x in zip(w, Xi[idof]):
                f.write(f"{2 * np.pi / wi: 8.6e} {beta_deg: 8.4e} "
                        f"{idof + 1} {np.abs(x): 8.6e} "
                        f"{np.angle(x): 8.6e} {x.real: 8.6e} "
                        f"{x.imag: 8.6e}\n")


def read_rao_4(path):
    """Read a WAMIT .4 motion-RAO file (as written by write_rao_4 /
    the reference's QTF debug output) -> (w (nw,), headings_deg (nh,),
    Xi (nh, ndof, nw) complex), frequencies ascending."""
    data = np.loadtxt(path)
    w_all = 2 * np.pi / data[:, 0]
    freqs = np.unique(w_all)
    heads = np.unique(data[:, 1])
    ndof = int(np.max(data[:, 2]))
    Xi = np.zeros((len(heads), ndof, len(freqs)), dtype=np.complex128)
    fi = {f: n for n, f in enumerate(freqs)}
    hi = {h: n for n, h in enumerate(heads)}
    for row, wi in zip(data, w_all):
        Xi[hi[row[1]], int(row[2]) - 1, fi[wi]] = row[5] + 1j * row[6]
    return freqs, heads, Xi


def read_wamit_p2(path, rho=1.0, ulen=1.0, g=1.0):
    """Read a WAMIT .p2 second-order (sum/difference) output file into
    per-DOF complex matrices — the readWAMIT_p2 equivalent
    (RAFT helpers.py:1434-1469).

    Rows: [period, heading, DoF, |F|, phase, Re, Im].  Returns a dict
    keyed 'surge'...'yaw' of (n_period, n_heading) complex arrays
    dimensionalised by rho g ULEN^k (k = 2 for forces, 3 for moments),
    plus 'period' and 'heading' vectors.  Defaults keep the data
    nondimensional, as the reference does."""
    data = np.loadtxt(path)
    heads = np.unique(data[:, 1])
    periods = np.unique(data[:, 0])
    names = ["surge", "sway", "heave", "roll", "pitch", "yaw"]
    k_ulen = [2, 2, 2, 3, 3, 3]
    out = {}
    for idof, name in enumerate(names):
        rows = data[data[:, 2] == idof + 1]
        rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
        re = rows[:, 5].reshape(-1, len(heads))
        im = rows[:, 6].reshape(-1, len(heads))
        out[name] = (re + 1j * im) * rho * g * ulen ** k_ulen[idof]
    out["period"] = periods
    out["heading"] = heads
    return out


def _interp_freq(w_model, w_data, Y, pad_zero_freq=None):
    """Linear interpolation along the last axis onto the model grid,
    with an optional value prepended at w = 0 (the reference pads the
    zero-frequency added mass / zero damping, raft_fowt.py:1469-1473)."""
    finite = np.isfinite(w_data)
    wd = w_data[finite]
    Yd = Y[..., finite]
    if pad_zero_freq is not None and (len(wd) == 0 or wd[0] > 0):
        wd = np.hstack([[0.0], wd])
        Yd = np.concatenate([pad_zero_freq[..., None], Yd], axis=-1)
    out = np.zeros(Y.shape[:-1] + (len(w_model),))
    for k in range(len(w_model)):
        out[..., k] = _interp_point(w_model[k], wd, Yd)
    return out


def _interp_point(x, xs, Ys):
    i = np.searchsorted(xs, x)
    if i <= 0:
        return Ys[..., 0]
    if i >= len(xs):
        return Ys[..., -1]
    f = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
    return Ys[..., i - 1] * (1 - f) + Ys[..., i] * f


def load_bem_coefficients(hydro_path, w_model, rho, g, r_ref=None):
    """Model-grid BEM tensors from WAMIT files, reference conventions:

    A_BEM (6,6,nw) = rho * Abar translated to the reference point;
    B_BEM (6,6,nw) = rho * w * Bbar translated;
    X coefficients (nh, 6, nw) rotated heading-relative
    (raft_fowt.py:1476-1501).  Returns dict; X entries zero if no .3
    file is present (the snapshot's OC4 dataset ships only the .1).
    """
    import torch

    from raft_tpu_torch.ops.transforms import translate_matrix_6to6

    nw = len(w_model)
    out = dict(
        A_BEM=np.zeros((6, 6, nw)),
        B_BEM=np.zeros((6, 6, nw)),
        X_BEM=np.zeros((1, 6, nw), dtype=np.complex128),
        headings=np.array([0.0]),
    )

    p1 = hydro_path + ".1"
    if os.path.exists(p1):
        w1, Abar, Bbar = read_wamit1(p1)
        # zero-frequency added mass used as the low-frequency pad
        if np.any(w1 == 0):
            A0 = Abar[:, :, np.where(w1 == 0)[0][0]]
        else:
            A0 = Abar[:, :, 0]
        mask = np.isfinite(w1) & (w1 > 0)
        A_i = _interp_freq(w_model, w1[mask], Abar[:, :, mask], pad_zero_freq=A0)
        B_i = _interp_freq(w_model, w1[mask], Bbar[:, :, mask],
                           pad_zero_freq=np.zeros((6, 6)))
        r_off = torch.as_tensor(
            np.zeros(3) if r_ref is None else -np.asarray(r_ref, dtype=float))
        for iw in range(nw):
            out["A_BEM"][:, :, iw] = translate_matrix_6to6(
                torch.as_tensor(rho * A_i[:, :, iw]), r_off).numpy()
            out["B_BEM"][:, :, iw] = translate_matrix_6to6(
                torch.as_tensor(rho * w_model[iw] * B_i[:, :, iw]),
                r_off).numpy()

    p3 = hydro_path + ".3"
    if os.path.exists(p3):
        w3, heads, Xbar = read_wamit3(p3)
        heads = np.asarray(heads) % 360
        order = np.argsort(heads)
        heads = heads[order]
        Xbar = Xbar[order]
        mask = np.isfinite(w3) & (w3 > 0)
        Xr = _interp_freq(w_model, w3[mask], Xbar.real[:, :, mask],
                          pad_zero_freq=np.zeros((len(heads), 6)))
        Xi = _interp_freq(w_model, w3[mask], Xbar.imag[:, :, mask],
                          pad_zero_freq=np.zeros((len(heads), 6)))
        X = rho * g * (Xr + 1j * Xi)
        # rotate DOFs heading-relative (raft_fowt.py:1489-1498)
        Xrot = np.zeros_like(X)
        for ih, h in enumerate(heads):
            ch, sh = np.cos(np.radians(h)), np.sin(np.radians(h))
            Xrot[ih, 0] = ch * X[ih, 0] + sh * X[ih, 1]
            Xrot[ih, 1] = -sh * X[ih, 0] + ch * X[ih, 1]
            Xrot[ih, 2] = X[ih, 2]
            Xrot[ih, 3] = ch * X[ih, 3] + sh * X[ih, 4]
            Xrot[ih, 4] = -sh * X[ih, 3] + ch * X[ih, 4]
            Xrot[ih, 5] = X[ih, 5]
        out["X_BEM"] = Xrot
        out["headings"] = heads

    return out


def interp_heading(X_BEM, headings, beta_deg):
    """Wrap-around heading interpolation of excitation coefficients
    (raft_fowt.py:1805-1833) + rotation back to the global frame
    (:1837-1846).  Returns (6, nw) complex for one wave heading."""
    beta = beta_deg % 360
    nhs = len(headings)
    if beta <= headings[0]:
        hlast = headings[-1] - 360
        i1, i2 = nhs - 1, 0
        f2 = (beta - hlast) / (headings[0] - hlast)
    elif beta >= headings[-1]:
        hfirst = headings[0] + 360
        i1, i2 = nhs - 1, 0
        f2 = (beta - headings[-1]) / (hfirst - headings[-1])
    else:
        for i in range(nhs - 1):
            if headings[i + 1] > beta:
                i1, i2 = i, i + 1
                f2 = (beta - headings[i]) / (headings[i + 1] - headings[i])
                break
    X_prime = X_BEM[i1] * (1 - f2) + X_BEM[i2] * f2

    b = np.radians(beta_deg)
    sb, cb = np.sin(b), np.cos(b)
    X = np.zeros_like(X_prime)
    X[0] = X_prime[0] * cb - X_prime[1] * sb
    X[1] = X_prime[0] * sb + X_prime[1] * cb
    X[2] = X_prime[2]
    X[3] = X_prime[3] * cb - X_prime[4] * sb
    X[4] = X_prime[3] * sb + X_prime[4] * cb
    X[5] = X_prime[5]
    return X
