"""Per-function parity of the port's transform and wave ops with the
JAX package's, on the same seeded numpy inputs (float64, 1e-13
relative: the same formulas op for op, so only rounding of
transcendental functions differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import transforms as jtf
from raft_tpu.ops import waves as jwv
from raft_tpu_torch.ops import transforms as ttf
from raft_tpu_torch.ops import waves as twv

RTOL = 1e-13


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_transforms(rng):
    r = rng.normal(size=(5, 4, 3))
    close(ttf.skew(torch.as_tensor(r)), jtf.skew(jnp.asarray(r)))
    close(ttf.vec_vec_trans(torch.as_tensor(r)),
          jtf.vec_vec_trans(jnp.asarray(r)))
    ang = rng.normal(size=(3, 7)) * 0.3
    close(ttf.rotation_matrix(*torch.as_tensor(ang)),
          jtf.rotation_matrix(*jnp.asarray(ang)))
    F = rng.normal(size=(5, 4, 3)) + 1j * rng.normal(size=(5, 4, 3))
    close(ttf.translate_force_3to6(torch.as_tensor(F),
                                   torch.as_tensor(r).to(torch.complex128)),
          jtf.translate_force_3to6(jnp.asarray(F), jnp.asarray(r)))


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_cross_every_axis(rng, axis):
    """The port's cross against jnp.cross with an axis, real x complex."""
    shape = [4, 5, 6, 2]
    shape[axis] = 3
    a = rng.normal(size=shape)
    b = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    close(ttf.cross(torch.as_tensor(a), torch.as_tensor(b), dim=axis),
          jnp.cross(jnp.asarray(a), jnp.asarray(b), axis=axis))


def test_jonswap(rng):
    w = np.linspace(0.05, 2.5, 40)
    Hs = np.array([1.0, 2.5, 6.0, 12.0, 11.0])
    Tp = np.array([4.0, 7.5, 12.0, 20.0, 6.0])   # every gamma branch
    out = twv.jonswap(torch.as_tensor(w), torch.as_tensor(Hs),
                      torch.as_tensor(Tp))
    assert out.dtype == torch.float64
    ref = np.stack([np.asarray(jwv.jonswap(w, h, t)) for h, t in zip(Hs, Tp)])
    close(out, ref)


def test_kh_ratios_guards(rng):
    """Deep-water and k == 0 branches stay finite and equal."""
    k = np.array([0.0, 0.01, 0.3, 2.0, 5.0])[:, None]
    z = -rng.uniform(0, 60, size=(1, 6))
    for h in (50.0, 200.0):
        got = twv._kh_ratios(torch.as_tensor(k), h, torch.as_tensor(z))
        ref = jwv._kh_ratios(jnp.asarray(k), h, jnp.asarray(z))
        for g, r in zip(got, ref):
            assert torch.isfinite(g).all()
            close(g, r)


def test_wave_kinematics_and_rao(rng):
    R, P, nw = 3, 7, 40
    w = np.linspace(0.05, 2.0, nw)
    k = np.stack([np.asarray(jwv.wave_number(w, h)) for h in (30., 80., 300.)])
    h = np.array([30.0, 80.0, 300.0])
    r = rng.normal(size=(R, P, 3)) * [20.0, 20.0, 15.0]   # some z > 0
    zeta = rng.uniform(0.1, 1.0, size=(R, nw)) + 0j
    beta = np.array([0.0, 0.7, 2.9])
    rho, g = np.full(R, 1025.0), np.full(R, 9.81)
    u, ud, p = twv.wave_kinematics(
        torch.as_tensor(zeta), torch.as_tensor(beta), torch.as_tensor(w),
        torch.as_tensor(k), torch.as_tensor(h), torch.as_tensor(r),
        torch.as_tensor(rho), torch.as_tensor(g))
    for i in range(R):
        ju, jud, jp = jwv.wave_kinematics(
            jnp.asarray(zeta[i])[None, :], beta[i], jnp.asarray(w),
            jnp.asarray(k[i]), h[i], jnp.asarray(r[i]), rho=1025.0, g=9.81)
        close(u[i], ju)
        close(ud[i], jud)
        close(p[i], jp)
    Xi = rng.normal(size=(R, 6, nw)) + 1j * rng.normal(size=(R, 6, nw))
    zeta[0, :5] = 1e-8                                    # guarded bins
    close(twv.get_rao(torch.as_tensor(Xi), torch.as_tensor(zeta)[:, None]),
          jwv.get_rao(jnp.asarray(Xi), jnp.asarray(zeta)[:, None]))


def _helpers_golden():
    import os

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port")
    return dict(np.load(os.path.join(fix, "golden_omdao_helpers.npz")))


def test_kinematics_rms_psd_match_golden():
    """get_kinematics, get_rms and get_psd (over every axis and summed
    over the sources) against the JAX package's on the golden's seeded
    inputs, within 1e-10 x max."""
    g = _helpers_golden()
    t = {k: torch.as_tensor(g[k]) for k in ("kin_r", "kin_Xi", "kin_w",
                                            "psd_xi")}
    for k, v in zip(("dr", "v", "a"), twv.get_kinematics(
            t["kin_r"], t["kin_Xi"], t["kin_w"])):
        close(v, g[f"kin_{k}"], rtol=1e-10)
    dw = float(g["psd_dw"])
    close(twv.get_rms(t["psd_xi"]), g["rms"], rtol=1e-10)
    close(twv.get_psd(t["psd_xi"], dw), g["psd"], rtol=1e-10)
    close(twv.get_psd(t["psd_xi"], dw, axis=0), g["psd_sum0"], rtol=1e-10)


def test_get_kinematics_broadcasts_as_jax(rng):
    """One point against one motion and against a batch of motions, as
    the reference broadcasts the point to the motions' shape."""
    nw = 9
    w = np.linspace(0.1, 1.5, nw)
    Xi = rng.normal(size=(5, 6, nw)) + 1j * rng.normal(size=(5, 6, nw))
    r = rng.normal(size=(3,))
    for r_, X_ in ((r, Xi), (r, Xi[0])):
        got = twv.get_kinematics(torch.as_tensor(r_), torch.as_tensor(X_),
                                 torch.as_tensor(w))
        ref = jwv.get_kinematics(jnp.asarray(r_), jnp.asarray(X_),
                                 jnp.asarray(w))
        for a, b in zip(got, ref):
            close(a, b)
