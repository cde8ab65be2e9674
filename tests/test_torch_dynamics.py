"""The port's strip excitation, drag linearisation and drag-linearised
impedance solve against the JAX package on one packed fixture (the MHK
design, S = 16), on the same numpy inputs.

The pose-dependent inputs (strip frames, node reduction, wave
velocities) are taken from the port at the JAX golden equilibrium and
handed to both packages as numpy arrays.  Tolerance: 1e-11 x each
output's max magnitude in float64 (same formulas; summation order of
the reductions differs), with n_iter_drag and the status word equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.models import dynamics as jdyn
from raft_tpu.physics import morison as jmor
from raft_tpu.structure.bucketing import _BucketFOWT as JFOWT
from raft_tpu_torch.models import dynamics as tdyn
from raft_tpu_torch.ops import transforms as ttf
from raft_tpu_torch.ops import waves as twv
from raft_tpu_torch.physics import morison as tmor
from raft_tpu_torch.physics.statics import node_T
from raft_tpu_torch.structure import bucketing as tb
from raft_tpu_torch.utils import health

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
TOL = 1e-11
ROWS = (0, 1)            # two golden sea states of the MHK design; their
                         # fixed points stop after 5 and 7 trips


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def case():
    """Port-side stage inputs of the MHK design at the golden X0 for
    the golden rows ROWS (R = 2), as torch tensors and numpy arrays."""
    p = tb.load_packed(os.path.join(FIX, "packed_mhk.npz"))
    g = np.load(os.path.join(FIX, "golden_mhk.npz"))
    meta = tb.signature_meta(p.sig)
    R = len(ROWS)
    d = tb.packed_from_numpy(tb.stack_packed([p.leaves] * R), "cpu")
    X0 = torch.as_tensor(g["on_X0"][list(ROWS)])
    w = torch.as_tensor(meta["w"])
    dw = float(meta["w"][1] - meta["w"][0])
    R_ptfm = ttf.rotation_matrix(X0[:, 3], X0[:, 4], X0[:, 5])
    rows = torch.arange(R)
    root = d["root"].long()
    r0 = d["node_r0"]
    dvec = r0 - r0[rows, root][:, None]
    r_nodes = r0 + X0[:, None, :3] + (dvec @ R_ptfm.transpose(-1, -2) - dvec)
    Tn = node_T(r_nodes, r_nodes[rows, root])
    ss = tmor.StripSet(**{k: d[k] for k in (
        "node", "ls", "dls", "ds", "drs", "circ", "active", "q0", "p10",
        "p20", "Cd_q", "Cd_p1", "Cd_p2", "Cd_End")})
    r, q, p1, p2 = tmor.strip_frames(ss, R_ptfm, r_nodes)
    sub = (r[..., 2] < 0) & d["strip_mask"]
    hc = dict(Imat=d["Imat"], a_i=d["a_i"], r=r, q=q, p1=p1, p2=p2,
              sub=sub, active=sub & d["active"])
    Hs = torch.as_tensor(g["Hs"][list(ROWS)])
    Tp = torch.as_tensor(g["Tp"][list(ROWS)])
    beta = torch.as_tensor(g["beta"][list(ROWS)])
    zeta = torch.sqrt(2.0 * twv.jonswap(w, Hs, Tp) * dw).to(torch.complex128)
    fs = tmor.SiteRows(rho_water=d["rho_water"], depth=d["depth"],
                       g=d["g"], n_nodes=meta["N"])
    return dict(p=p, meta=meta, d=d, X0=X0, w=w, r_nodes=r_nodes, Tn=Tn,
                ss=ss, hc=hc, zeta=zeta, beta=beta, fs=fs)


def jax_strips(lv, S, nw):
    z = np.zeros(S)
    return jmor.StripSet(
        node=lv["node"], mnode0=lv["node"], ls=lv["ls"], dls=lv["dls"],
        ds=lv["ds"], drs=lv["drs"], circ=lv["circ"], active=lv["active"],
        mcf=np.zeros(S, dtype=bool), q0=lv["q0"], p10=lv["p10"],
        p20=lv["p20"], Cd_q=lv["Cd_q"], Cd_p1=lv["Cd_p1"],
        Cd_p2=lv["Cd_p2"], Cd_End=lv["Cd_End"], Ca_q=z, Ca_p1=z, Ca_p2=z,
        Ca_End=z, Cm_p1_w=np.zeros((S, nw), complex),
        Cm_p2_w=np.zeros((S, nw), complex))


def jax_row(case, i):
    """JAX-side (fs, ss, hc, Tn, r_nodes) of row i from the same data."""
    lv, meta = case["p"].leaves, case["meta"]
    fs = JFOWT(rho_water=float(lv["rho_water"]), depth=float(lv["depth"]),
               g=float(lv["g"]), n_nodes=meta["N"])
    hc = {k: jnp.asarray(v[i].numpy()) for k, v in case["hc"].items()}
    return (fs, jax_strips(lv, meta["S"], meta["nw"]), hc,
            jnp.asarray(case["Tn"][i].numpy()),
            jnp.asarray(case["r_nodes"][i].numpy()))


def test_hydro_excitation_matches_jax(case):
    exc = tmor.hydro_excitation(case["fs"], case["ss"], case["hc"],
                                case["zeta"], case["beta"], case["w"],
                                case["d"]["k"], case["Tn"], case["r_nodes"])
    for i in range(len(ROWS)):
        fs, ss, hc, Tn, r_nodes = jax_row(case, i)
        ref = jmor.hydro_excitation(
            fs, ss, hc, jnp.asarray(case["zeta"][i].numpy())[None],
            jnp.asarray([float(case["beta"][i])]),
            jnp.asarray(case["w"].numpy()),
            jnp.asarray(case["d"]["k"][i].numpy()), Tn, r_nodes)
        close(exc["F_hydro_iner"][i], ref["F_hydro_iner"][0])
        close(exc["u"][i], ref["u"][0])


def test_drag_linearisation_matches_jax(case):
    exc = tmor.hydro_excitation(case["fs"], case["ss"], case["hc"],
                                case["zeta"], case["beta"], case["w"],
                                case["d"]["k"], case["Tn"], case["r_nodes"])
    pre = tmor.drag_lin_precompute(case["fs"], case["ss"], case["hc"],
                                   exc["u"], case["Tn"], case["r_nodes"],
                                   case["w"])
    rng = np.random.default_rng(5)
    nw = case["meta"]["nw"]
    Xi = rng.normal(size=(len(ROWS), 6, nw)) + 1j * rng.normal(
        size=(len(ROWS), 6, nw))
    out = tmor.drag_lin_iter(pre, torch.as_tensor(Xi))
    Bmat_t = out["Bmat"]
    F_st = tmor.drag_excitation(case["fs"], case["ss"], case["hc"], Bmat_t,
                                exc["u"], case["Tn"], case["r_nodes"])
    for i in range(len(ROWS)):
        fs, ss, hc, Tn, r_nodes = jax_row(case, i)
        u = jnp.asarray(exc["u"][i].numpy())
        jpre = jmor.drag_lin_precompute(fs, ss, hc, u, Tn, r_nodes,
                                        jnp.asarray(case["w"].numpy()))
        for k in ("T6q", "T6p1", "T6p2", "uq", "Gq", "Gp1", "Gp2", "cq",
                  "cEnd"):
            close(pre[k][i], jpre[k])
        ref = jmor.drag_lin_iter(jpre, jnp.asarray(Xi[i]))
        for k in ("B_hydro_drag", "Bmat", "F_hydro_drag"):
            close(out[k][i], ref[k])
        close(F_st[i], jmor.drag_excitation(fs, ss, hc, ref["Bmat"], u, Tn,
                                            r_nodes))


def solve_both(case, fused, kw):
    """The port's batched fixed point and the JAX solve (each row through
    its own while loop under vmap) on the same inputs: (Z, Xi, diag) of
    the port and of JAX."""
    d, meta = case["d"], case["meta"]
    exc = tmor.hydro_excitation(case["fs"], case["ss"], case["hc"],
                                case["zeta"], case["beta"], case["w"],
                                d["k"], case["Tn"], case["r_nodes"])
    # the mooring stiffness at X0 enters C; take the port's
    _, C_moor = tb._masked_moor_closures(d)(case["X0"])
    R, nw = len(ROWS), meta["nw"]
    M_lin = (d["M_struc"] + d["A_hydro"])[..., None].expand(R, 6, 6, nw)
    B_lin = torch.zeros(R, 6, 6, nw, dtype=torch.float64)
    C_lin = d["K_h"] + C_moor
    Z, Xi, Bmat, diag = tdyn.solve_dynamics_fowt(
        case["fs"], case["ss"], case["hc"], exc["u"], M_lin, B_lin, C_lin,
        exc["F_hydro_iner"], case["w"], case["Tn"], case["r_nodes"], **kw)
    if fused == "off":
        Xi = tdyn.system_response(Z, exc["F_hydro_iner"] + tmor.drag_excitation(
            case["fs"], case["ss"], case["hc"], Bmat, exc["u"], case["Tn"],
            case["r_nodes"]))
    fs, ss, _, _, _ = jax_row(case, 0)
    wj = jnp.asarray(case["w"].numpy())

    @jax.jit
    @jax.vmap
    def run(u, M, B, C, F, hc, Tn, r_nodes):
        Zj, Xj, Bm, dg = jdyn.solve_dynamics_fowt(
            fs, ss, hc, u, M, B, C, F, wj, Tn, r_nodes, **kw)
        if fused == "off":
            Fw = F + jmor.drag_excitation(fs, ss, hc, Bm, u, Tn, r_nodes)
            Xj = jdyn.system_response(Zj, Fw[None])[0]
        return Zj, Xj, dg

    # one trace for both rows: the JAX rows each run their own while
    # loop under vmap, the reference's batching of the fixed point
    Zj, Xj, dg = run(*(np.asarray(a) for a in (
        exc["u"], M_lin, B_lin, C_lin, exc["F_hydro_iner"])),
        {k: np.asarray(v) for k, v in case["hc"].items()},
        np.asarray(case["Tn"]), np.asarray(case["r_nodes"]))
    return (Z, Xi, diag), (Zj, Xj, dg)


@pytest.mark.parametrize("fused", [
    "on", pytest.param("off", marks=pytest.mark.slow)])
def test_solve_dynamics_matches_jax(case, fused, monkeypatch):
    """The batched fixed point (per-row stop, masked relaxation) against
    the JAX solve, with the signature's own budget and the condition
    check on, so cond_Z is compared too."""
    monkeypatch.setenv("RAFT_TPU_FUSED", fused)
    monkeypatch.setenv("RAFT_TPU_COND_CHECK", "1")
    meta = case["meta"]
    kw = dict(n_iter=meta["nIter"], Xi_start=meta["XiStart"],
              n_iter_extra=meta["nIterExtra"])
    (Z, Xi, diag), (Zj, Xj, dg) = solve_both(case, fused, kw)
    g = np.load(os.path.join(FIX, "golden_mhk.npz"))
    close(Z, Zj)
    close(Xi, Xj)
    np.testing.assert_array_equal(diag["n_iter_drag"].numpy(),
                                  np.asarray(dg["n_iter_drag"]))
    np.testing.assert_array_equal(diag["status"].numpy(),
                                  np.asarray(dg["status"]))
    np.testing.assert_array_equal(diag["drag_converged"].numpy(),
                                  np.asarray(dg["drag_converged"]))
    close(diag["drag_resid"], dg["drag_resid"], tol=1e-9)
    close(diag["cond_Z"], dg["cond_Z"], tol=1e-10)
    assert float(diag["cond_Z"].min()) > 1.0
    # and the goldens' iteration counts for the same rows
    np.testing.assert_array_equal(diag["n_iter_drag"].numpy(),
                                  g[f"{fused}_n_iter_drag"][list(ROWS)])


def test_solve_dynamics_at_the_cap_matches_jax(case):
    """A budget of 5 + 1 trips: row 0 converges on its 5th trip, row 1
    runs into the cap on its 6th (of the 7 it needs).  The capped row
    keeps its last linearisation point unrelaxed, counts the cap's trips
    and sets DRAG_CAP_HIT, as the JAX fixed point does; the port runs 4
    + 2 trips where JAX runs two blocks of 4 with the last two masked."""
    meta = case["meta"]
    kw = dict(n_iter=5, Xi_start=meta["XiStart"], n_iter_extra=0)
    (Z, Xi, diag), (Zj, Xj, dg) = solve_both(case, "on", kw)
    close(Z, Zj)
    close(Xi, Xj)
    np.testing.assert_array_equal(diag["n_iter_drag"].numpy(), [5, 6])
    np.testing.assert_array_equal(np.asarray(dg["n_iter_drag"]), [5, 6])
    np.testing.assert_array_equal(diag["status"].numpy(),
                                  np.asarray(dg["status"]))
    np.testing.assert_array_equal(
        diag["status"].numpy() & health.DRAG_CAP_HIT,
        [0, health.DRAG_CAP_HIT])
    np.testing.assert_array_equal(diag["drag_converged"].numpy(),
                                  [True, False])
    close(diag["drag_resid"], dg["drag_resid"], tol=1e-9)


def test_impedance_layout():
    rng = np.random.default_rng(2)
    w = np.linspace(0.1, 2.0, 5)
    M, B = rng.normal(size=(2, 6, 6, 5)), rng.normal(size=(2, 6, 6, 5))
    C = rng.normal(size=(2, 6, 6))
    Z = tdyn.impedance(torch.as_tensor(w), torch.as_tensor(M),
                       torch.as_tensor(B), torch.as_tensor(C))
    for i in range(2):
        close(Z[i], jdyn.impedance(jnp.asarray(w), M[i], B[i], C[i]))


def test_hydro_linearization_matches_golden():
    """hydro_linearization (drag_lin_precompute then drag_lin_iter) on
    the spar demo's strips at its zero pose, for the golden's wave
    velocities and seeded response, against the JAX package's within
    1e-10 x each output's max."""
    import json

    from raft_tpu_torch.models.model import Model

    g = np.load(os.path.join(FIX, "golden_omdao_helpers.npz"))
    with open(os.path.join(FIX, "design_spar.json")) as f:
        model = Model(json.load(f))
    fh = model.hydro[0]
    cpu = torch.device("cpu")
    pose = fh.pose(np.zeros(6), cpu)
    d = fh._on(cpu)
    out = tmor.hydro_linearization(
        d["site"], d["ss"], pose.hc, torch.as_tensor(g["lin_u"])[None],
        torch.as_tensor(g["lin_Xi"])[None], d["w"], pose.Tn, pose.r_nodes)
    for k in ("B_hydro_drag", "Bmat", "F_hydro_drag"):
        close(out[k][0], g[f"lin_{k}"], tol=1e-10)
