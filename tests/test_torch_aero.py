"""The port's rotor aerodynamics against JAX.

Fast tier: ``ops/interp.py`` against ``jnp.interp`` (values within 1
ulp, the same segment at a knot, the same slope); ``jonswap`` with a
per-row gamma against JAX (1e-14 relative); the port's
``build_rotor_aero`` and ``blade_hydro`` from ``design_semi_wind.json``
and ``design_mhk_tidal.json`` against the JAX builder's arrays
(``rotor_*.npz``, within 1e-12 x max, ints exact); the blade-element
loads and their six derivatives (``rotor_loads_and_derivs``) and the
operating schedule against the JAX goldens (``golden_aero_*.npz``,
1e-10 x max), on a rotor rebuilt from the JAX arrays by
``rotor_aero_from_numpy`` so the solver is held apart from the build;
the rotor-averaged Kaimal spectrum (1e-12 x max).  Slow tier: the
``torch.func.jacfwd`` oracle of the load derivatives against the
hand-carried tangents.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch.models.model import Model
from raft_tpu_torch.ops import waves as twv
from raft_tpu_torch.ops.dual import Dual
from raft_tpu_torch.ops.interp import interp
from raft_tpu_torch.physics import aero as ta

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
ROTORS = ("semi_wind", "mhk_tidal")
INT_FIELDS = ("B", "nSector")

_MODELS = {}


def model(name):
    if name not in _MODELS:
        with open(os.path.join(FIX, f"design_{name}.json")) as f:
            _MODELS[name] = Model(json.load(f))
    return _MODELS[name]


def fixture(kind, name):
    return dict(np.load(os.path.join(FIX, f"{kind}_{name}.npz")))


def jax_rotor(name):
    """The port's RotorAeroModel rebuilt from the JAX builder's arrays."""
    z = fixture("rotor", name)
    return ta.rotor_aero_from_numpy(
        {k: v for k, v in z.items() if not k.startswith("hydro_")})


def rel_err(a, b):
    scale = float(np.max(np.abs(b)))
    return float(np.max(np.abs(np.asarray(a) - b))) / (scale or 1.0)


# ----------------------------------------------------------------- interp

def _grid():
    xp = np.unique(np.concatenate([np.linspace(-3.0, 3.0, 61),
                                   [0.05, 0.051, 1.7]]))
    rng = np.random.default_rng(7)
    x = np.concatenate([xp, rng.uniform(-3.0, 3.0, 200),
                        [-3.5, -3.0000001, 3.0, 3.2, 10.0]])
    return xp, x


def seg_ulp(x, xp, fp):
    """One ulp of the larger table value of each query's segment: XLA
    may fuse ``fp[i-1] + t * df`` into one rounding, so where the sum
    cancels, the two differ by an ulp of its operands, not of the
    result."""
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    tab = np.broadcast_to(fp, np.shape(x) + (len(xp),))

    def at(j):
        return np.take_along_axis(tab, j[..., None], -1)[..., 0]

    return np.spacing(np.maximum(np.abs(at(i - 1)), np.abs(at(i))))


def test_interp_matches_jnp_interp_1d():
    """Knots, between knots and outside the table, a 1-D ``fp``: within
    1 ulp of the segment's table values."""
    xp, x = _grid()
    fp = np.sin(2 * xp) + xp ** 2
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = interp(torch.as_tensor(x), torch.as_tensor(xp),
                 torch.as_tensor(fp)).numpy()
    ulp = seg_ulp(x, xp, fp)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
    # outside the table: the end values exactly
    out = (x < xp[0]) | (x > xp[-1])
    np.testing.assert_array_equal(got[out], want[out])


def test_interp_per_element_table_matches_jnp_interp():
    """A (rows, elements) batch against an (elements, n) table of one
    row per element, as the polars are gathered; within 1 ulp of the
    segment's table values."""
    xp, _ = _grid()
    rng = np.random.default_rng(8)
    tab = rng.normal(size=(5, xp.size))
    x = rng.uniform(-3.4, 3.4, size=(4, 5))
    x[0] = xp[[0, 10, 20, 30, -1]]                      # knots and ends
    want = np.stack([[float(jnp.interp(x[i, j], xp, tab[j]))
                      for j in range(5)] for i in range(4)])
    got = interp(torch.as_tensor(x), torch.as_tensor(xp),
                 torch.as_tensor(tab)).numpy()
    assert np.all(np.abs(got - want) <= seg_ulp(x, xp, tab))


def test_interp_slope_matches_jax_grad():
    """The slope under autograd and under a Dual tangent equals
    ``jax.grad(jnp.interp)``: the right-hand segment at a knot, zero
    outside the table."""
    xp, x = _grid()
    fp = np.cos(xp) * 3.0
    g = jax.vmap(jax.grad(lambda v: jnp.interp(v, xp, fp)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    interp(xt, torch.as_tensor(xp), torch.as_tensor(fp)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-13,
                               atol=0)
    d = interp(Dual(torch.as_tensor(x), torch.ones(1, x.size,
                                                   dtype=torch.float64)),
               torch.as_tensor(xp), torch.as_tensor(fp))
    np.testing.assert_allclose(d.t[0].numpy(), np.asarray(g), rtol=1e-13,
                               atol=0)


def test_jonswap_gamma_matches_jax():
    """Per-row gamma (0: the IEC default) against JAX's jonswap."""
    from raft_tpu.ops import waves as jwv

    w = np.linspace(0.03, 1.3, 40)
    Hs = np.array([1.0, 6.0, 12.0, 3.0, 0.5])
    Tp = np.array([4.0, 12.0, 20.0, 7.0, 9.0])
    gamma = np.array([0.0, 3.3, 1.0, 5.0, 0.0])
    want = np.stack([np.asarray(jwv.jonswap(w, h, t, gamma=g))
                     for h, t, g in zip(Hs, Tp, gamma)])
    got = twv.jonswap(torch.as_tensor(w), torch.as_tensor(Hs),
                      torch.as_tensor(Tp), gamma=torch.as_tensor(gamma))
    assert rel_err(got.numpy(), want) <= 1e-14
    default = twv.jonswap(torch.as_tensor(w), torch.as_tensor(Hs),
                          torch.as_tensor(Tp))
    np.testing.assert_array_equal(default[[0, 4]].numpy(),
                                  got[[0, 4]].numpy())


# ------------------------------------------------------------------ build

@pytest.mark.parametrize("name", ROTORS)
def test_rotor_aero_matches_jax_builder(name):
    """Every field of the port's RotorAeroModel (built from the design
    JSON) against the JAX builder's, within 1e-12 x max, ints exact."""
    rot = model(name).rotor_aero[0]
    ref = fixture("rotor", name)
    for f in dataclasses.fields(ta.RotorAeroModel):
        a = getattr(rot, f.name)
        if f.name not in ref:
            assert a is None, f.name
            continue
        b = ref[f.name]
        if f.name in INT_FIELDS:
            assert int(a) == int(b), f.name
            continue
        a = np.asarray(a, dtype=float)
        assert a.shape == b.shape, f.name
        assert rel_err(a, b) <= 1e-12, f.name


def test_rotor_aero_from_numpy_round_trip():
    rot = model("semi_wind").rotor_aero[0]
    back = ta.rotor_aero_from_numpy(
        {f.name: getattr(rot, f.name) for f in dataclasses.fields(rot)})
    for f in dataclasses.fields(rot):
        a, b = getattr(rot, f.name), getattr(back, f.name)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(back.B, int) and isinstance(back.nSector, int)


def test_blade_hydro_matches_jax_builder():
    """The submerged rotor's blade hydro summary against the JAX
    builder's, within 1e-12 x max; the rotor in air has none."""
    hyd = model("mhk_tidal").fowtList[0].rotors[0].hydro
    ref = {k[len("hydro_"):]: v for k, v in
           fixture("rotor", "mhk_tidal").items() if k.startswith("hydro_")}
    assert sorted(hyd) == sorted(ref)
    for k, b in ref.items():
        a = np.asarray(hyd[k], dtype=float)
        assert a.shape == b.shape, k
        assert rel_err(a, b) <= 1e-12, k
    assert float(hyd["V"]) > 0
    assert model("semi_wind").fowtList[0].rotors[0].hydro is None


# ------------------------------------------------------------------- BEMT

def _grid_args(g):
    return [torch.as_tensor(g[k]) for k in
            ("U", "Omega_rpm", "pitch_deg", "tilt", "yaw")]


@pytest.mark.parametrize("name", ROTORS)
def test_rotor_loads_and_derivs_match_jax(name):
    """Loads and dT, dQ by (U, Omega, pitch) over the golden grid,
    within 1e-10 x max each, on the JAX builder's rotor arrays."""
    g = fixture("golden_aero", name)
    loads, dT, dQ = ta.rotor_loads_and_derivs(jax_rotor(name),
                                              *_grid_args(g))
    for k, a in (("loads", loads), ("dT", dT), ("dQ", dQ)):
        for j in range(a.shape[1]):
            assert rel_err(a[:, j].numpy(), g[k][:, j]) <= 1e-10, (k, j)
    plain = ta.rotor_loads(jax_rotor(name), *_grid_args(g))
    np.testing.assert_array_equal(plain.numpy(), loads.numpy())


@pytest.mark.parametrize("name", ROTORS)
def test_operating_point_matches_jax(name):
    g = fixture("golden_aero", name)
    rot = jax_rotor(name)
    Om, pit = ta.operating_point(rot, torch.as_tensor(g["U"]))
    for a, b, tab in ((Om, g["Omega_sched"], rot.Omega_sched),
                      (pit, g["pitch_sched"], rot.pitch_sched)):
        ulp = seg_ulp(g["U"], rot.U_sched, tab)
        assert np.all(np.abs(a.numpy() - b) <= ulp)


@pytest.mark.parametrize("name", ROTORS)
def test_kaimal_matches_jax(name):
    g = fixture("golden_aero", name)
    rot = jax_rotor(name)
    hub = model(name).fowtList[0].rotors[0].Zhub
    for tm in ("NTM", "ETM", "EWM"):
        S = ta.kaimal_rot_psd_traced(
            torch.as_tensor(g["w"]), torch.as_tensor(g["kaimal_V"]),
            torch.as_tensor(g["kaimal_TI"]), hub, rot.Rtip, TurbMod=tm)
        assert rel_err(S.numpy(), g[f"kaimal_{tm}"]) <= 1e-12, tm


def test_parse_turbulence_matches_jax():
    from raft_tpu.physics import aero as ja

    for spec in ("IB_NTM", "IIA_ETM", "IIIC_EWM", "IVA+_NTM", "0.12", 0.1):
        assert ta.parse_turbulence(spec) == ja.parse_turbulence(spec), spec


@pytest.mark.slow
@pytest.mark.parametrize("name", ROTORS)
def test_jacfwd_oracle_matches_hand_tangents(name):
    """The torch.func.jacfwd form of the implicit tangent against the
    hand-carried one, and both against the JAX goldens."""
    g = fixture("golden_aero", name)
    rot = jax_rotor(name)
    hand = ta.rotor_loads_and_derivs(rot, *_grid_args(g))
    orac = ta.rotor_loads_and_derivs_jacfwd(rot, *_grid_args(g))
    for a, b, k in zip(hand, orac, ("loads", "dT", "dQ")):
        assert rel_err(b.detach().numpy(), a.numpy()) <= 1e-12, k
        assert rel_err(b.detach().numpy(), g[k]) <= 1e-10, k
