"""Second-order (difference-frequency) wave forces from an external QTF
(counterpart of ``raft_tpu/physics/secondorder.py``), host numpy and
scipy: the WAMIT ``.12d`` reader and writer and the host force-spectrum
oracle :func:`hydro_force_2nd`.  The full evaluator's batched twin of
the oracle is :func:`raft_tpu_torch.api._hydro_force_2nd_rows`.

The force-spectrum evaluation (the reference's 'qtf' interpolation
mode): bilinearly interpolate the QTF onto the model's w x w grid, then
for each difference frequency mu_i sum the i-th superdiagonal against
the shifted wave spectrum:

    f(mu_i) = 4 sqrt( sum_j S(w_j) S(w_j+mu_i) |Q(w_j, w_j+mu_i)|^2 ) dw
    f_mean  = 2 sum_j S(w_j) Re Q(w_j, w_j) dw

which loses the relative phase between components, as the reference
does.
"""

from __future__ import annotations

import numpy as np


def read_qtf_12d(path, rho=1025.0, g=9.81, ulen=1.0, ndof=6):
    """Read a WAMIT ``.12d`` difference-frequency QTF file.

    Returns dict(w_2nd (nw,), heads_rad (nh,), qtf (nw, nw, nh, ndof)):
    dimensional (rho g ULEN, one more ULEN for moments) and completed
    to a hermitian matrix from the file's one triangle."""
    data = np.loadtxt(path)
    data[:, 0:2] = 2.0 * np.pi / data[:, 0:2]  # periods -> rad/s
    if not (data[:, 2] == data[:, 3]).all():
        raise ValueError("only unidirectional QTFs are supported")
    heads = np.deg2rad(np.sort(np.unique(data[:, 2])))
    w1 = np.unique(data[:, 0])
    w2 = np.unique(data[:, 1])
    if not (w1 == w2).all():
        raise ValueError("both frequency columns must contain the same values")

    qtf = np.zeros([len(w1), len(w2), len(heads), ndof], dtype=np.complex128)
    for row in data:
        i1 = np.searchsorted(w1, row[0])
        i2 = np.searchsorted(w2, row[1])
        ih = np.searchsorted(heads, np.deg2rad(row[2]))
        idof = round(row[4] - 1)
        factor = rho * g * ulen * (ulen if idof >= 3 else 1.0)
        qtf[i1, i2, ih, idof] = factor * (row[7] + 1j * row[8])
        if i1 != i2:  # hermitian completion
            qtf[i2, i1, ih, idof] = factor * (row[7] - 1j * row[8])
    return dict(w_2nd=w1, heads_rad=heads, qtf=qtf)


def write_qtf_12d(path, qtf, w_2nd, heads_rad, rho=1025.0, g=9.81,
                  ulen=1.0):
    """Write a difference-frequency QTF in the WAMIT ``.12d`` format, the
    inverse of :func:`read_qtf_12d`.

    ``qtf`` (nw, nw, nh, ndof) complex, dimensional; only the upper
    triangle i2 >= i1 is written (the matrix is hermitian).  Columns:
    T1, T2, head, head, DoF, |F|, phase, Re F, Im F with
    F = Q / (rho g ULEN) (one more ULEN for moments)."""
    qtf = np.asarray(qtf)
    w = np.asarray(w_2nd)
    with open(path, "w") as f:
        for ih in range(len(heads_rad)):
            hd = np.rad2deg(heads_rad[ih])
            for idof in range(qtf.shape[3]):
                factor = rho * g * ulen * (ulen if idof >= 3 else 1.0)
                for i1 in range(len(w)):
                    for i2 in range(i1, len(w)):
                        F = qtf[i1, i2, ih, idof] / factor
                        f.write(
                            f"{2 * np.pi / w[i1]: 8.6e} "
                            f"{2 * np.pi / w[i2]: 8.6e} "
                            f"{hd: 8.4e} {hd: 8.4e} {idof + 1} "
                            f"{np.abs(F): 8.6e} {np.angle(F): 8.6e} "
                            f"{F.real: 8.6e} {F.imag: 8.6e}\n")


def _interp_heading(qtf, heads, beta):
    """The QTF (nw, nw, nh, ndof) at heading ``beta`` [rad]: linear
    between the heading nodes, clipped to their span (no wrap)."""
    if len(heads) == 1:
        return qtf[:, :, 0, :]
    b = np.clip(beta, heads[0], heads[-1])
    i = np.clip(np.searchsorted(heads, b) - 1, 0, len(heads) - 2)
    f = (b - heads[i]) / (heads[i + 1] - heads[i])
    return qtf[:, :, i, :] * (1 - f) + qtf[:, :, i + 1, :] * f


def qtf_on_grid(Q, w2nd, w):
    """One (nw2, nw2) complex QTF plane bilinearly interpolated onto the
    model grid ``w`` (nw,), zero outside the QTF's grid: (nw, nw)."""
    from scipy.interpolate import RegularGridInterpolator

    w = np.asarray(w)
    pts = np.stack(np.meshgrid(w, w, indexing="ij"), axis=-1).reshape(-1, 2)
    Qr = RegularGridInterpolator((w2nd, w2nd), Q.real, bounds_error=False,
                                 fill_value=0)(pts)
    Qi = RegularGridInterpolator((w2nd, w2nd), Q.imag, bounds_error=False,
                                 fill_value=0)(pts)
    return (Qr + 1j * Qi).reshape(len(w), len(w))


def hydro_force_2nd(qtf_data, beta, S0, w):
    """Mean drift and difference-frequency force amplitudes of one sea
    (the reference's ``calcHydroForce_2ndOrd``, 'qtf' mode), host
    numpy: the oracle of the full evaluator's batched twin.

    beta [rad], S0 (nw,) the wave spectrum on the model grid w (nw,).
    Returns (f_mean (ndof,), f (ndof, nw) real amplitudes)."""
    w = np.asarray(w)
    S0 = np.asarray(S0)
    nw = len(w)
    dw = w[1] - w[0]
    ndof = qtf_data["qtf"].shape[-1]
    w2nd = qtf_data["w_2nd"]
    Q_beta = _interp_heading(qtf_data["qtf"], qtf_data["heads_rad"], beta)

    f = np.zeros((ndof, nw))
    f_mean = np.zeros(ndof)
    for idof in range(ndof):
        Q = qtf_on_grid(Q_beta[:, :, idof], w2nd, w)
        for imu in range(1, nw):
            Saux = np.zeros(nw)
            Saux[: nw - imu] = S0[imu:]
            Qd = np.zeros(nw, dtype=np.complex128)
            Qd[: nw - imu] = np.diag(Q, imu)
            f[idof, imu] = 4 * np.sqrt(np.sum(S0 * Saux * np.abs(Qd) ** 2)) * dw
        f_mean[idof] = 2 * np.sum(S0 * np.diag(Q.real)) * dw

    # shift the difference frequencies onto the model grid
    f[:, 0:-1] = f[:, 1:]
    f[:, -1] = 0
    return f_mean, f


def qtf_model_grid(qtf_data, w):
    """The QTF of every heading node on the model grid ``w``:
    (nh, nw, nw, ndof) complex (bilinear, zero outside the QTF's
    grid).  Linear interpolations over independent axes commute, so the
    heading interpolation can follow per row."""
    w = np.asarray(w)
    nw = len(w)
    w2 = qtf_data["w_2nd"]
    qtf = qtf_data["qtf"]  # (nw2, nw2, nh, ndof)
    nh, ndof = qtf.shape[2], qtf.shape[3]
    Qm = np.zeros((nh, nw, nw, ndof), dtype=np.complex128)
    for ih in range(nh):
        for idof in range(ndof):
            Qm[ih, :, :, idof] = qtf_on_grid(qtf[:, :, ih, idof], w2, w)
    return Qm
