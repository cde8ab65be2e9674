"""The port's slender-body QTF (``potSecOrder: 1``) against JAX.

Fast tier (CPU), on ``design_semi_wind_slender.json`` (semi_wind with
MacCamy-Fuchs outer columns, a 40-bin QTF grid) against
``golden_qtf_slender.npz`` (the JAX package's ``fowt_qtf_slender`` and
its parts at a 30 deg heading):

* each second-order wave helper of ``ops/waves2.py`` against JAX's on
  seeded points and frequencies on both sides of the deep-water switch
  (k h = 10), 1e-12 x max;
* ``member_qtf`` of every member driven by the RAO of a golden
  full-evaluator row, within 1e-10 x max|qtf|, and the same bits at two
  pair-chunk sizes;
* ``kim_yue_correction`` of the MacCamy-Fuchs members within 1e-12 x
  max, ``pinkster_iv`` within 1e-12 x max;
* ``Model.qtf_slender`` (the fixed body and the RAO-driven body) within
  1e-10 x max|qtf|, hermitian; the QTF grid equal to JAX's.

Slow tier: the slender goldens against the live JAX functions (the
regeneration test of ``tests/test_torch_secondorder.py`` rebuilds them
all).
"""

import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.models.model import Model
from raft_tpu_torch.ops import waves2
from raft_tpu_torch.physics import qtf_slender as qs

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "torch_port")
DESIGN = os.path.join(FIX, "design_semi_wind_slender.json")
TOL = 1e-10
KY_TOL = 1e-12
HELPER_TOL = 1e-12

_CACHE = {}


def golden():
    if "g" not in _CACHE:
        _CACHE["g"] = dict(np.load(os.path.join(FIX,
                                                "golden_qtf_slender.npz")))
    return _CACHE["g"]


def model():
    if "m" not in _CACHE:
        _CACHE["m"] = Model(DESIGN)
    return _CACHE["m"]


def near(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def pairs(nw2):
    return np.triu_indices(nw2)


# -------------------------------------------------------------- helpers

#: (depth [m], frequencies [rad/s]): 200 m from 0.2 to 0.7 rad/s crosses
#: k h = 10 near 0.7; 20 m stays below it; 400 m above it at 0.6-1.0
REGIMES = {"mixed": (200.0, (0.2, 0.75)), "shallow": (20.0, (0.1, 0.5)),
           "deep": (400.0, (0.6, 1.0))}


def _points(regime, n=12, seed=5):
    from raft_tpu_torch.ops.waves import wave_number_ref

    h, (lo, hi) = REGIMES[regime]
    rng = np.random.default_rng(seed)
    w = rng.uniform(lo, hi, n)
    w[0] = w[1]                                  # one pair on the diagonal
    k = np.asarray(wave_number_ref(w, h))
    r = np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n),
                  rng.uniform(-25, 3, n)], axis=-1)
    r[2, 2] = 0.0
    return h, w, k, r, rng


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("helper", ["grad_u1", "grad_dudt", "grad_pres1st",
                                    "u_single", "axdiv_acc", "pot_2nd_ord"])
def test_waves2_helpers_match_jax(helper, regime):
    """Each helper, batched over the points, against JAX's per point."""
    import jax.numpy as jnp

    from raft_tpu.ops import waves2 as jw

    h, w, k, r, rng = _points(regime)
    assert (k * h >= 10).any() or regime == "shallow"
    assert (k * h < 10).any() or regime == "deep"
    beta = 0.61
    t = torch.as_tensor
    w2, k2 = np.roll(w, 3), np.roll(k, 3)
    q = np.array([0.2, -0.3, 0.93])
    q /= np.linalg.norm(q)
    v1 = rng.standard_normal((len(w), 3)) + 1j * rng.standard_normal(
        (len(w), 3))
    v2 = np.roll(v1, 1, axis=0)
    if helper in ("grad_u1", "grad_dudt"):
        got = getattr(waves2, helper)(t(w), t(k), beta, h, t(r)).numpy()
        ref = [getattr(jw, helper)(w[i], k[i], beta, h, jnp.asarray(r[i]))
               for i in range(len(w))]
    elif helper == "grad_pres1st":
        got = waves2.grad_pres1st(t(k), beta, h, t(r)).numpy()
        ref = [jw.grad_pres1st(k[i], beta, h, jnp.asarray(r[i]))
               for i in range(len(w))]
    elif helper == "u_single":
        got = waves2.u_single(t(w), t(k), beta, h, t(r)).numpy()
        ref = [jw._u_single(w[i], k[i], beta, h, jnp.asarray(r[i]))
               for i in range(len(w))]
    elif helper == "axdiv_acc":
        got = waves2.axdiv_acc(t(w), t(w2), t(k), t(k2), beta, h, t(r),
                               t(v1), t(v2), t(q)).numpy()
        ref = [jw.axdiv_acc(w[i], w2[i], k[i], k2[i], beta, h,
                            jnp.asarray(r[i]), jnp.asarray(v1[i]),
                            jnp.asarray(v2[i]), jnp.asarray(q))
               for i in range(len(w))]
    else:
        acc, p = waves2.pot_2nd_ord(t(w), t(w2), t(k), t(k2), beta, h, t(r))
        got = np.concatenate([acc.numpy(), p.numpy()[:, None]], axis=1)
        ref = [np.concatenate([np.asarray(a), np.asarray(b)[None]])
               for a, b in (jw.pot_2nd_ord(w[i], w2[i], k[i], k2[i], beta, h,
                                           jnp.asarray(r[i]))
                            for i in range(len(w)))]
    ref = np.stack([np.asarray(x) for x in ref])
    near(got, ref, HELPER_TOL, helper)
    assert np.any(ref != 0)


# --------------------------------------------------------------- member

def _member_args(im):
    m, g = model(), golden()
    fs = m.fowtList[0]
    a_i = m.hydro[0].hc0["a_i"]
    ofs = sum(mem.ns for mem in fs.members[:im])
    mem = fs.members[im]
    return (mem, a_i[ofs:ofs + mem.ns], torch.as_tensor(g["Xi"]),
            float(g["beta"]), m.w1_2nd, m.k1_2nd, fs.depth, fs.rho_water,
            fs.g)


N_MEMBERS = 8


def test_grid_and_members_match_jax():
    """The QTF grid is JAX's bit for bit; the member list is the one the
    goldens index (the tower above the water gives zero)."""
    m, g = model(), golden()
    np.testing.assert_array_equal(m.w1_2nd, g["w1_2nd"])
    np.testing.assert_array_equal(m.k1_2nd, g["k1_2nd"])
    assert len(m.fowtList[0].members) == N_MEMBERS
    assert [im for im in range(N_MEMBERS) if f"kim_yue_{im}" in g] == [1, 2, 3]


@pytest.mark.parametrize("im", range(N_MEMBERS))
def test_member_qtf_matches_jax(im):
    """Driven by a golden row's RAO (every term of the pair body
    carries weight), within 1e-10 x max|qtf| of the member."""
    args = _member_args(im)
    nw2 = len(args[4])
    got = qs.member_qtf(*args).numpy()
    i1, i2 = pairs(nw2)
    ref = golden()[f"member_{im}"]
    if not np.any(ref):
        assert not np.any(got)
        return
    near(got[i1, i2], ref, TOL, f"member {im}")
    low = np.tril(np.ones((nw2, nw2), bool), -1)
    assert not np.any(got[low])


@pytest.mark.parametrize("im", [0, 1])
def test_member_qtf_does_not_depend_on_the_pair_chunk(im):
    """The same bits from chunks of 97 (rounded up to 104) and of 820
    pairs, and from chunks of 5 (8 at a time)."""
    args = _member_args(im)
    a = qs.member_qtf(*args, pair_chunk=97).numpy()
    b = qs.member_qtf(*args, pair_chunk=820).numpy()
    c = qs.member_qtf(*args, pair_chunk=5).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("im", [1, 2, 3])
def test_kim_yue_correction_matches_jax(im):
    mem, _, _, beta, w2, k2, depth, rho, g = _member_args(im)
    got = qs.kim_yue_correction(mem, beta, w2, k2, depth, rho, g)
    i1, i2 = pairs(len(w2))
    near(got[i1, i2], golden()[f"kim_yue_{im}"], KY_TOL, f"kim_yue {im}")


def test_kim_yue_is_zero_off_mcf_and_off_the_surface():
    for im in (0, 4, 7):
        mem, _, _, beta, w2, k2, depth, rho, g = _member_args(im)
        assert not np.any(qs.kim_yue_correction(mem, beta, w2, k2, depth,
                                                rho, g))


def test_pinkster_iv_matches_jax():
    g = golden()
    got = qs.pinkster_iv(torch.as_tensor(g["Xi"]), torch.as_tensor(g["F1st"]),
                         block=16).numpy()
    i1, i2 = pairs(g["Xi"].shape[1])
    near(got[i1, i2], g["pinkster"], KY_TOL, "pinkster")


# ----------------------------------------------------------------- fowt

@pytest.mark.parametrize("which", ["fixed", "rao"])
def test_qtf_slender_matches_jax(which):
    """Model.qtf_slender: the fixed body and the body moving with a
    golden row's RAO, within 1e-10 x max|qtf|, hermitian off the
    diagonal (the reference's completion keeps the diagonal as
    computed)."""
    g = golden()
    Xi0 = g["Xi0"] if which == "rao" else None
    got = model().qtf_slender(float(g["beta"]), Xi0=Xi0,
                              device="cpu").numpy()
    ref = g[f"{which}_qtf"]
    near(got, ref, TOL, which)
    q = got[:, :, 0, :]
    off = ~np.eye(q.shape[0], dtype=bool)
    np.testing.assert_array_equal(q[off],
                                  np.conj(np.transpose(q, (1, 0, 2)))[off])


def test_qtf_slender_needs_a_grid_and_a_device(monkeypatch):
    m = Model(os.path.join(FIX, "design_semi_wind.json"))
    assert m.w1_2nd is None
    with pytest.raises(ValueError, match="min_freq2nd"):
        m.qtf_slender(0.0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        model().qtf_slender(0.0)


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_qtf_slender_matches_live_jax():
    """The fixed-body QTF at another heading against the live JAX
    ``fowt_qtf_slender`` of the same design."""
    import raft_tpu
    from raft_tpu.physics.qtf_slender import fowt_qtf_slender

    jm = raft_tpu.Model(DESIGN)
    beta = float(np.deg2rad(50.0))
    jm.hydro[0].beta = np.asarray([beta])
    ref = np.asarray(fowt_qtf_slender(jm, 0))
    near(model().qtf_slender(beta, device="cpu").numpy(), ref, TOL, "live")
