"""Farm wake coupling and AEP (counterpart of ``raft_tpu/physics/
wake.py``).

The Bastankhah & Porte-Agel (2014) Gaussian wake deficit with
sum-of-squares superposition over a front-to-back sweep (the class of
FLORIS's default 'gauss' velocity model), the thrust coefficients from
the model's own power/thrust curve (:func:`raft_tpu_torch.drivers.
power_thrust_curve`, its speeds as rows of one blade-element call on the
device), and the position feedback of the reference's
florisFindEquilibrium (0.9 / 0.1 under-relaxation, its power and
position tests): platform drift moves the turbines, which moves the
wakes.  The deficit sweep is host numpy; each equilibrium is the
model's :meth:`~raft_tpu_torch.models.model.Model.solve_statics` on the
device.
"""

from __future__ import annotations

import numpy as np


def gaussian_deficit(dx, dy, D, Ct, TI):
    """Bastankhah-Porte-Agel Gaussian wake velocity deficit fraction at
    (dx, dy) downstream/crosswind of a turbine of diameter D.

    dx, dy : distances in the wind frame [m] (dx > 0 downstream)
    Ct     : thrust coefficient of the waking turbine
    TI     : turbulence intensity (fraction) — sets wake growth
    """
    dx = np.asarray(dx, dtype=float)
    dy = np.asarray(dy, dtype=float)
    kstar = 0.38 * TI + 0.004          # wake growth rate (Niayifar & Porte-Agel)
    Ct = np.clip(Ct, 1e-4, 0.999)
    eps = 0.2 * np.sqrt(0.5 * (1 + np.sqrt(1 - Ct)) / np.sqrt(1 - Ct))
    sigma_D = kstar * dx / D + eps      # sigma / D
    with np.errstate(invalid="ignore", divide="ignore"):
        radicand = 1.0 - Ct / (8.0 * sigma_D**2)
        C = 1.0 - np.sqrt(np.maximum(radicand, 0.0))
        deficit = C * np.exp(-(dy / D) ** 2 / (2.0 * sigma_D**2))
    return np.where(dx > 0.1 * D, deficit, 0.0)


def farm_velocities(xy, D, ct_funcs, U_inf, wind_heading_deg, TI):
    """Rotor-averaged waked wind speed per turbine.

    xy : (n, 2) turbine positions (global); D : (n,) rotor diameters;
    ct_funcs : list of callables U -> Ct; U_inf free-stream speed;
    wind_heading_deg : wind propagation heading (deg from +x, RAFT
    convention); TI turbulence intensity.

    Front-to-back sweep: upstream turbines' deficits (at each turbine's
    own waked speed) combine by sum of squares (Katic).
    Returns (U_eff (n,), Ct (n,)).
    """
    xy = np.asarray(xy, dtype=float)
    n = len(xy)
    b = np.deg2rad(wind_heading_deg)
    # wind-frame coordinates: x_w downstream, y_w crosswind
    ex = np.array([np.cos(b), np.sin(b)])
    ey = np.array([-np.sin(b), np.cos(b)])
    xw = xy @ ex
    yw = xy @ ey

    order = np.argsort(xw)
    U_eff = np.full(n, float(U_inf))
    Ct = np.zeros(n)
    for idx in order:
        dsq = 0.0
        for j in order:
            if xw[j] >= xw[idx] or Ct[j] <= 0:
                continue
            d = gaussian_deficit(xw[idx] - xw[j], yw[idx] - yw[j],
                                 D[j], Ct[j], TI) * (U_eff[j] / U_inf)
            dsq += float(d) ** 2
        U_eff[idx] = U_inf * (1.0 - np.sqrt(dsq))
        Ct[idx] = float(ct_funcs[idx](U_eff[idx]))
    return U_eff, Ct


class WakeCoupling:
    """Wake-coupled farm equilibrium and AEP of a Model (the reference's
    ``WakeCoupling``): :meth:`find_equilibrium` and :meth:`calc_aep`,
    each equilibrium on ``device``."""

    def __init__(self, model, u_grid=None, device=None):
        from raft_tpu_torch.drivers import power_thrust_curve

        self.model = model
        self.device = device
        self.u_grid = np.asarray(
            u_grid if u_grid is not None else np.arange(3.0, 25.5, 0.5))
        # per-FOWT power/thrust curves from the vmapped BEMT
        self.curves = []
        for i, fs in enumerate(model.fowtList):
            if fs.nrotors == 0 or not model.rotor_aero:
                self.curves.append(None)
                continue
            pc = power_thrust_curve(model, self.u_grid, ifowt=i, ir=0,
                                    device=device)
            rprops = fs.rotors[0]
            R = model.rotor_aero[0].Rtip
            A = np.pi * R**2
            rho = model.rotor_aero[0].rho
            Ct = pc["thrust"] / (0.5 * rho * A * np.maximum(self.u_grid, 0.1) ** 2)
            self.curves.append(dict(D=2 * R, power=pc["power"], Ct=Ct))

    def _ct_fn(self, i):
        c = self.curves[i]
        return lambda U: np.interp(U, self.u_grid, c["Ct"], left=0, right=0)

    def _power(self, i, U):
        c = self.curves[i]
        return float(np.interp(U, self.u_grid, c["power"], left=0, right=0))

    def find_equilibrium(self, case, cutin=3.0, n_iter=100, power_tol=10.0,
                         pos_tol=0.01):
        """Wake/position fixed point for one case
        (florisFindEquilibrium, raft_model.py:2055-2218).

        Returns (winds, xpositions, ypositions, powers) iteration
        histories as arrays, reference-compatible."""
        import copy

        model = self.model
        n = model.nFOWT
        TI = float(np.atleast_1d(np.asarray(
            case.get("turbulence", 0.06), dtype=float))[0]) or 0.06
        U_inf = float(np.atleast_1d(np.asarray(case["wind_speed"],
                                               dtype=float))[0])
        heading = float(np.atleast_1d(np.asarray(
            case.get("wind_heading", 0.0), dtype=float))[0])
        D = np.array([c["D"] if c else 100.0 for c in self.curves])
        refs = np.array([[fs.x_ref, fs.y_ref] for fs in model.fowtList])

        case = copy.deepcopy(case)
        winds, xs, ys, powers = [], [], [], []
        offs = model.dof_offsets
        for it in range(n_iter):
            X = np.asarray(model.solve_statics(case, device=self.device))
            pos = np.stack([X[offs[i]:offs[i] + 2] for i in range(n)])
            if it > 0:
                pos = 0.9 * pos + 0.1 * np.c_[xs[-1], ys[-1]]
            U_eff, Ct = farm_velocities(
                pos, D, [self._ct_fn(i) for i in range(n)], U_inf, heading, TI)
            case["wind_speed"] = list(U_eff)
            winds.append(U_eff)
            xs.append(pos[:, 0])
            ys.append(pos[:, 1])
            if np.min(U_eff) > cutin:
                powers.append(np.array([self._power(i, U_eff[i])
                                        for i in range(n)]))
            else:
                powers.append(np.zeros(n))
            if it > 1:
                dp = np.max(np.abs(powers[-1] - powers[-2]))
                dx = np.max(np.abs(xs[-1] - xs[-2]))
                if (np.min(U_eff) > cutin and dp < power_tol and dx < pos_tol) \
                        or (np.min(U_eff) <= cutin and dx < pos_tol):
                    break
        return (np.array(winds), np.array(xs), np.array(ys), np.array(powers))

    def calc_aep(self, windspeeds, winddirs, probabilities, cutin=3.0,
                 cutout=25.0, TI=0.06, hours=8760.0, n_iter=30):
        """Probability-weighted AEP over a wind rose
        (florisCalcAEP, raft_model.py:2219-2245).

        Returns (powers per state (n_states, nFOWT) [W],
        aep per state [Wh], total AEP [Wh])."""
        model = self.model
        keys = model.design["cases"]["keys"]
        powers, aeps = [], []
        for ws, wd, pr in zip(windspeeds, winddirs, probabilities):
            if not (cutin <= ws <= cutout):
                powers.append(np.zeros(model.nFOWT))
                aeps.append(np.zeros(model.nFOWT))
                continue
            case = dict(zip(keys, [ws, wd, TI, "operating", 0,
                                   "JONSWAP", 0, 0, 0]))
            _, _, _, p_hist = self.find_equilibrium(case, cutin=cutin,
                                                    n_iter=n_iter)
            powers.append(p_hist[-1])
            aeps.append(p_hist[-1] * pr * hours)
        return np.array(powers), np.array(aeps), float(np.sum(aeps))
