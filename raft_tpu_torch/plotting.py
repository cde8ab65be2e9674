"""Visualisation: system geometry and response spectra (counterpart of
``raft_tpu/plotting.py``).

matplotlib is imported inside the plot functions only, so the module
and its geometry helpers (:func:`_member_polylines`,
:func:`_catenary_points`) work where matplotlib is not installed; a
plot function there raises the ``ImportError`` of matplotlib.  The catenary
profiles are solved by the port's mooring functions on ``device``
(default: the current CUDA device; it raises without one unless
``device="cpu"`` is passed).
"""

from __future__ import annotations

import numpy as np
import torch


def _system_polylines(model, n_theta, device):
    """Every polyline of the system as (points (n, 3), is_line), in the
    order the reference draws them: per FOWT its members but the
    nacelle's, then its own mooring lines (anchor to fairlead at the
    zero pose); then the shared network's lines, its free points at
    their equilibrium with the units at their array positions."""
    from raft_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    out = []
    for i, fs in enumerate(model.fowtList):
        off = np.array([fs.x_ref, fs.y_ref, 0.0])
        for mem in fs.members:
            if mem.part_of != "nacelle":
                out += [(pts, False) for pts in
                        _member_polylines(mem, off, n_theta=n_theta)]
        ms = model.ms_list[i]
        if ms is not None:
            out += [(_catenary_points(ms.r_anchor[il], off + ms.r_fair0[il],
                                      ms.L[il], ms.w[il], ms.EA[il],
                                      device=dev), True)
                    for il in range(ms.n_lines)]
    net = model.ms_array
    if net is not None:
        r6 = np.stack([[f.x_ref, f.y_ref, 0, 0, 0, 0]
                       for f in model.fowtList])
        X = torch.as_tensor(r6, dtype=torch.float64, device=dev)[None]
        pos = net.point_positions(X, net.solve_free_points(X))[0]
        pos = pos.cpu().numpy()
        out += [(_catenary_points(pos[a], pos[b], L, w_l, EA, device=dev),
                 True)
                for (a, b), L, w_l, EA in zip(net.l_ends, net.l_L, net.l_w,
                                              net.l_EA)]
    return out


def plot_system(model, ax=None, color="k", n_theta=12, device=None):
    """3-D render of every FOWT's members (station rings and
    longitudinal lines), its mooring lines (catenary profiles) and the
    shared network's lines.  Returns the axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=(9, 7))
        ax = fig.add_subplot(111, projection="3d")
    for pts, line in _system_polylines(model, n_theta, device):
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2],
                color="tab:blue" if line else color, lw=0.8 if line else 0.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.set_box_aspect((1, 1, 0.5))
    return ax


def _member_polylines(mem, off, n_theta=12):
    """Station rings and longitudinal lines of one member as 3-D
    polylines (n_theta + 1 points a ring; a line every quarter turn)."""
    th = np.linspace(0, 2 * np.pi, n_theta + 1)
    rings = []
    for i in range(len(mem.stations)):
        c = off + np.asarray(mem.rA0) + np.asarray(mem.q0) * mem.stations[i]
        d = np.atleast_1d(np.asarray(mem.d[i], dtype=float))
        d = d if d.size == 2 else np.r_[d, d]
        rings.append(c[None, :]
                     + 0.5 * d[0] * np.cos(th)[:, None]
                     * np.asarray(mem.p10)[None, :]
                     + 0.5 * d[1] * np.sin(th)[:, None]
                     * np.asarray(mem.p20)[None, :])
    lines = [np.stack([r[k] for r in rings])
             for k in range(0, n_theta + 1, max(1, n_theta // 4))]
    return rings + lines


def plot_responses(model, channels=("surge", "heave", "pitch"), ifowt=0):
    """Response PSDs of every case, one panel per channel, on a Hz axis
    (rad/s densities times 2 pi; a per-rotor channel plots rotor 0).
    Returns (figure, axes)."""
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(len(channels), 1, sharex=True,
                            figsize=(8, 2.5 * len(channels)))
    axs = np.atleast_1d(axs)
    f_hz = model.w / (2 * np.pi)
    for iCase, per_fowt in model.results["case_metrics"].items():
        m = per_fowt[ifowt]
        for ax, ch in zip(axs, channels):
            psd = np.asarray(m[f"{ch}_PSD"])
            psd = psd[:, 0] if psd.ndim == 2 else psd
            ax.plot(f_hz, 2 * np.pi * psd, label=f"case {iCase + 1}")
            ax.set_ylabel(f"{ch} PSD")
    axs[0].legend()
    axs[-1].set_xlabel("frequency [Hz]")
    return fig, axs


def plot2d(model, ax=None, color="k", Xuvec=(1, 0, 0), Yuvec=(0, 0, 1),
           figsize=(6, 4), n_theta=12, device=None):
    """2-D projection of the whole system onto the plane spanned by
    ``Xuvec`` / ``Yuvec`` (default: the x-z side view): member outlines,
    mooring and network line profiles.  Returns (figure, axes)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=figsize)
    else:
        fig = ax.get_figure()
    Xu = np.asarray(Xuvec, dtype=float)
    Yu = np.asarray(Yuvec, dtype=float)
    for pts, line in _system_polylines(model, n_theta, device):
        ax.plot(pts @ Xu, pts @ Yu, color="tab:blue" if line else color,
                lw=0.8 if line else 0.5)
    ax.axis("equal")
    ax.set_xlabel("[m]")
    ax.set_ylabel("[m]")
    return fig, ax


def _catenary_points(rA, rB, L, w_line, EA, n=30, device=None):
    """Catenary profile polyline (n, 3) between two points: the line's
    fairlead tensions by :func:`~raft_tpu_torch.physics.mooring.
    solve_catenary`, then the spans of its first s of arc length, s in
    [0, L], by :func:`~raft_tpu_torch.physics.mooring._profile`, on
    ``device``."""
    from raft_tpu_torch.physics.mooring import _profile, solve_catenary
    from raft_tpu_torch.utils.dtypes import resolve_device

    kw = dict(dtype=torch.float64, device=resolve_device(device))
    lo, hi = (rA, rB) if rA[2] <= rB[2] else (rB, rA)
    lo = np.asarray(lo, dtype=float)
    dv = np.asarray(hi, dtype=float) - lo
    XF = max(np.hypot(dv[0], dv[1]), 1e-6)
    uh = dv[:2] / XF
    L, w_line, EA = float(L), float(w_line), float(EA)
    HF, VF, _, _ = solve_catenary(
        *(torch.tensor(v, **kw) for v in (XF, dv[2], L, w_line, EA)))
    HF, VF = float(HF), float(VF)
    s = np.linspace(0, L, n)
    VFs = np.maximum(VF - w_line * (L - s), 0.0)
    x, z = _profile(torch.full((n,), HF, **kw), torch.as_tensor(VFs, **kw),
                    torch.as_tensor(s, **kw), torch.tensor(w_line, **kw),
                    torch.tensor(EA, **kw))
    xs = np.clip(x.cpu().numpy(), 0, XF)
    zs = z.cpu().numpy()
    return np.stack([lo[0] + uh[0] * xs, lo[1] + uh[1] * xs, lo[2] + zs],
                    axis=1)


def plot_responses_extended(model, ifowt=0):
    """The 9-panel PSD figure of the standard response channels per
    case: surge, sway, heave, pitch, roll, yaw, nacelle acceleration,
    tower-base moment and the wave elevation."""
    return plot_responses(
        model,
        channels=("surge", "sway", "heave", "pitch", "roll", "yaw", "AxRNA",
                  "Mbase", "wave"),
        ifowt=ifowt)
