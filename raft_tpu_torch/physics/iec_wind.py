"""IEC 61400-1 wind models: turbulence classes and extreme events
(counterpart of ``raft_tpu/physics/iec_wind.py``, plain numpy).

The turbine and turbulence class parameters, the NTM / ETM / EWM
turbulence standard deviations, and the extreme transient events (EOG
6.3.2.2, EDC 6.3.2.4, ECD 6.3.2.5, EWS 6.3.2.6) as array-returning
generators, plus the InflowWind ``.wnd`` writer for interchange: the
driver layer's IEC wind events, host work with no device part.
"""

from __future__ import annotations

import numpy as np

TURBINE_CLASS_VREF = {"I": 50.0, "II": 42.5, "III": 37.5, "IV": 30.0}
TURBULENCE_CLASS_IREF = {"A+": 0.18, "A": 0.16, "B": 0.14, "C": 0.12}


class IECWindExtreme:
    """IEC 61400-1 extreme-condition wind generator."""

    def __init__(self, turbine_class="I", turbulence_class="B", z_hub=90.0,
                 D=126.0, vert_slope=0.0, dt=0.05, dir_change="both",
                 shear_orient="both"):
        self.turbine_class = turbine_class
        self.turbulence_class = turbulence_class
        self.z_hub = z_hub
        self.D = D
        self.vert_slope = vert_slope
        self.dt = dt
        self.dir_change = dir_change
        self.shear_orient = shear_orient
        self.setup()

    def setup(self):
        self.V_ref = TURBINE_CLASS_VREF[self.turbine_class]
        self.V_ave = 0.2 * self.V_ref
        self.I_ref = TURBULENCE_CLASS_IREF[self.turbulence_class]
        self.Sigma_1 = 42.0 if self.z_hub > 60 else 0.7 * self.z_hub

    # --- turbulence standard deviations (pyIECWind.py:54-79)
    def NTM(self, V_hub):
        return self.I_ref * (0.75 * V_hub + 5.6)

    def ETM(self, V_hub):
        c = 2.0
        return c * self.I_ref * (0.072 * (self.V_ave / c + 3) * (V_hub / c - 4) + 10)

    def EWM(self, V_hub):
        V_e50 = 1.4 * self.V_ref
        return 0.11 * V_hub, V_e50, 0.8 * V_e50, self.V_ref, 0.8 * self.V_ref

    # --- transient events; each returns dict of time-series columns
    def EOG(self, V_hub_in):
        """Extreme operating gust (6.3.2.2): Mexican-hat velocity dip/rise."""
        T = 10.5
        t = np.linspace(0.0, T, int(T / self.dt + 1))
        V_hub = V_hub_in * np.cos(np.radians(self.vert_slope))
        sigma_1 = self.NTM(V_hub)
        _, _, V_e1, _, _ = self.EWM(V_hub)
        V_gust = min(1.35 * (V_e1 - V_hub),
                     3.3 * (sigma_1 / (1 + 0.1 * (self.D / self.Sigma_1))))
        V_gust_t = np.where(
            t < T,
            -0.37 * V_gust * np.sin(3 * np.pi * t / T) * (1 - np.cos(2 * np.pi * t / T)),
            0.0,
        )
        return dict(t=t, V=np.full_like(t, V_hub), V_gust=V_gust_t,
                    sigma_1=sigma_1, V_gust_peak=V_gust)

    def EDC(self, V_hub_in):
        """Extreme direction change (6.3.2.4)."""
        T = 6.0
        t = np.linspace(0.0, T, int(T / self.dt + 1))
        V_hub = V_hub_in * np.cos(np.radians(self.vert_slope))
        sigma_1 = self.NTM(V_hub)
        theta_e = np.degrees(
            4.0 * np.arctan(sigma_1 / (V_hub * (1 + 0.01 * (self.D / self.Sigma_1)))))
        theta_e = min(theta_e, 180.0)
        ramp = 0.5 * theta_e * (1 - np.cos(np.pi * t / T))
        return dict(t=t, V=np.full_like(t, V_hub),
                    theta_pos=np.where(t < T, ramp, theta_e),
                    theta_neg=-np.where(t < T, ramp, theta_e),
                    sigma_1=sigma_1, theta_e=theta_e)

    def ECD(self, V_hub_in):
        """Extreme coherent gust with direction change (6.3.2.5)."""
        T = 10.0
        t = np.linspace(0.0, 2 * T, int(2 * T / self.dt + 1))
        V_hub = V_hub_in * np.cos(np.radians(self.vert_slope))
        V_cg = 15.0
        theta_cg = 180.0 if V_hub < 4 else 720.0 / V_hub
        rise = 0.5 * (1 - np.cos(np.pi * np.clip(t, 0, T) / T))
        return dict(t=t, V=V_hub + V_cg * rise,
                    theta_pos=theta_cg * rise, theta_neg=-theta_cg * rise,
                    V_cg=V_cg, theta_cg=theta_cg)

    def EWS(self, V_hub_in):
        """Extreme wind shear (6.3.2.6): transient vertical/horizontal
        linear shear on top of the power-law profile."""
        T = 12.0
        alpha = 0.2
        beta = 6.4
        t = np.linspace(0.0, T, int(T / self.dt + 1))
        V_hub = V_hub_in * np.cos(np.radians(self.vert_slope))
        sigma_1 = self.NTM(V_hub)
        amp = (2.5 + 0.2 * beta * sigma_1 * (self.D / self.Sigma_1) ** 0.25) / self.D
        shear_t = np.where(t < T, amp * (1 - np.cos(2 * np.pi * t / T)), 0.0)
        return dict(t=t, V=np.full_like(t, V_hub), shear_lin=shear_t,
                    shear_vert=np.full_like(t, alpha), sigma_1=sigma_1)


def write_wnd(path, data_columns, header_lines=()):
    """Write an InflowWind uniform-wind .wnd file (pyIECWind.py:373-404).

    data_columns: sequence of equal-length 1-D arrays in the order
    (t, V, dir, V_vert, shear_horz, shear_vert, shear_vert_lin, V_gust,
    upflow)."""
    data = np.column_stack(data_columns)
    with open(path, "w") as f:
        for h in header_lines:
            f.write(h if h.endswith("\n") else h + "\n")
        f.write("! Time  Wind  Wind  Vertical  Horiz.  Pwr. Law  Lin. Vert.  Gust   Upflow\n")
        f.write("!       Speed Dir.  Speed     Shear   Vert.Shr  Shear       Speed\n")
        for row in data:
            f.write(" ".join(f"{v: 10.4f}" for v in row) + "\n")
