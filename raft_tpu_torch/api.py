"""Evaluation API of one design (counterpart of ``raft_tpu/api.py``):
the batched case and design-axis evaluators, and the case-level helpers
every evaluator shares (``_policy_cdt``, ``_case_status``)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from raft_tpu_torch.models.statics_solve import solve_equilibrium
from raft_tpu_torch.physics import morison
from raft_tpu_torch.utils import config, health
from raft_tpu_torch.utils.dtypes import compute_dtypes, resolve_device


def _policy_cdt(*tensors):
    """Complex dtype of the excitation prefix under ``RAFT_TPU_DTYPE``
    (derived from ``tensors`` when the flag is unset)."""
    return compute_dtypes(*tensors)[1]


def _case_status(st_status, dyn_diag, X0, Xi):
    """One int32 health word per row: the statics bits OR the dynamics
    bits OR the evaluator guard on non-finite outputs (the bucket path
    clamps no input, so INPUT_CLIPPED stays clear)."""
    status = st_status | dyn_diag["status"]
    finite = (torch.all(torch.isfinite(X0), dim=-1)
              & torch.all(torch.isfinite(torch.view_as_real(Xi)).flatten(1),
                          dim=1))
    status = health.set_bit(status, health.NONFINITE_INTERMEDIATE,
                            (~finite).to(torch.int32))
    return status.to(torch.int32)


class CaseEvaluator(nn.Module):
    """Batched sea-state evaluator of one design (the reference's
    ``make_case_evaluator``): ``forward(Hs, Tp, beta)`` over R rows, each
    a scalar or an (R,) array, returns the reference's output keys per
    row as tensors on the device.

    The design's leaves sit on the device once, unpadded (its own
    signature, every axis at its real size), in the dtypes of the
    ``RAFT_TPU_DTYPE`` policy when the evaluator is made (float64 by
    default); rows run in chunks of
    ``RAFT_TPU_BUCKET_ROWS`` through the bucket path's stages, with the
    zero-pose hydro constants and the strip frames at each row's
    displaced pose.  Forward only.
    """

    def __init__(self, model, device=None):
        super().__init__()
        from raft_tpu_torch.structure import bucketing

        device = resolve_device(device)
        self.device = device
        self.rdt, self.cdt = compute_dtypes()
        self.fs = model.fowtList[0]
        sig = bucketing.bucket_signature(model, ladders={})
        self.body = bucketing.BucketEvaluator(sig, device)
        self.design = {k: v[None] for k, v in bucketing.packed_from_numpy(
            bucketing.pack_design(model, sig), device).items()}
        self.ms = None if model.ms is None else model.ms.to(device, self.rdt)

    def forward(self, Hs, Tp, beta, timer=None):
        """``timer``, when given, is called per chunk as
        :meth:`raft_tpu_torch.structure.bucketing.BucketEvaluator.forward`
        calls it."""
        return self._rows(dict(Hs=Hs, Tp=Tp, beta=beta), timer)

    def _rows(self, params, timer):
        p = {k: v.reshape(-1) for k, v in zip(params, torch.broadcast_tensors(
            *(torch.as_tensor(v, dtype=self.rdt, device=self.device)
              for v in params.values())))}
        n = p["Hs"].shape[0]
        if n == 0:
            raise ValueError("empty batch: no rows to evaluate")
        cap = int(config.get("BUCKET_ROWS")) or n
        mark = timer if timer is not None else (lambda stage: None)
        outs = []
        with torch.no_grad():
            for a in range(0, n, cap):
                outs.append(self._chunk({k: v[a:a + cap]
                                         for k, v in p.items()}, mark))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _design_rows(self, p, R):
        """(design leaves, mooring system, hydro hook) of R rows."""
        d = {k: v.expand((R,) + v.shape[1:]) for k, v in self.design.items()}
        return d, self.ms, None

    def _chunk(self, p, mark):
        R = p["Hs"].shape[0]
        mark("start")
        d, ms, hydro = self._design_rows(p, R)
        X0, _, _, _, st_status, C_moor = solve_equilibrium(
            self.fs, ms, d["K_h"], d["F_und"], torch.zeros_like(d["F_und"]))
        mark("statics")
        return self.body.respond(d, X0, st_status, C_moor, p["Hs"],
                                 p["Tp"], p["beta"], mark, hydro=hydro)


class DesignEvaluator(CaseEvaluator):
    """Batched design-axis evaluator of one design (the reference's
    ``make_design_evaluator``): ``forward(Hs, Tp, beta, Cd_scale=1,
    Ca_scale=1, L_moor_scale=1)``, each a scalar or an (R,) array.

    Per row the strip drag and added-mass coefficients are scaled
    (``Cm = 1 + Ca_scale (Cm - 1)`` on the complex inertia
    coefficients), the mooring lines' unstretched lengths are scaled in
    both the force and the stiffness, the statics are re-solved, and the
    hydro constants are recomputed at the row's displaced pose.  Forward
    only."""

    def __init__(self, model, device=None):
        super().__init__(model, device)
        ss = model.hydro[0].strips
        self.coef = {k: torch.as_tensor(
            getattr(ss, k), device=self.device,
            dtype=self.cdt if k.startswith("Cm") else self.rdt)
            for k in ("Ca_q", "Ca_p1", "Ca_p2", "Ca_End", "Cm_p1_w",
                      "Cm_p2_w")}

    def forward(self, Hs, Tp, beta, Cd_scale=1.0, Ca_scale=1.0,
                L_moor_scale=1.0, timer=None):
        return self._rows(dict(Hs=Hs, Tp=Tp, beta=beta, Cd_scale=Cd_scale,
                               Ca_scale=Ca_scale,
                               L_moor_scale=L_moor_scale), timer)

    def _design_rows(self, p, R):
        d, ms, _ = super()._design_rows(p, R)
        d = dict(d)
        Cd_s = p["Cd_scale"][:, None]
        for k in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
            d[k] = d[k] * Cd_s
        Ca_s = p["Ca_scale"][:, None]
        coef = {k: self.coef[k] * Ca_s
                for k in ("Ca_q", "Ca_p1", "Ca_p2", "Ca_End")}
        for k in ("Cm_p1_w", "Cm_p2_w"):
            coef[k] = 1.0 + Ca_s[..., None] * (self.coef[k] - 1.0)
        if ms is not None:
            ms = dataclasses.replace(ms, L=ms.L * p["L_moor_scale"][:, None])

        def hydro(fs, ss, R_ptfm, r_nodes, Tn):
            return morison.hydro_constants(
                fs, dataclasses.replace(ss, **coef), R_ptfm, r_nodes, Tn)

        return d, ms, hydro


def make_case_evaluator(model, device=None):
    """The batched :class:`CaseEvaluator` of ``model`` on ``device``
    (default: the current CUDA device; raises without one)."""
    return CaseEvaluator(model, device)


def make_design_evaluator(model, device=None):
    """The batched :class:`DesignEvaluator` of ``model`` on ``device``
    (default: the current CUDA device; raises without one)."""
    return DesignEvaluator(model, device)
