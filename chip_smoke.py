"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--rows-per-design 4096] [--out DIR]

Phases, each printing one line (the last line is the result object):

1. device  - the card's name and power limit (nvidia-smi); TF32 off.
2. build   - nvcc builds raft_tpu_torch/csrc/linsolve.cu for sm_90a
             (or reuses the build); the -Xptxas -v report goes to
             <out>/ptxas_linsolve.txt.
3. kernel  - the solve kernel against its plain PyTorch version on the
             card: N in {1, 2, 3, 6, 9, 12}, float64 and float32,
             impedance-structured systems, the main-path shape (512 rows
             x 40 frequencies = 20,480 systems at N = 6), a broadcast
             case and a batch that is not a multiple of the block; then
             CUDA-event times of the kernel, the plain version and
             torch.linalg.solve at the main-path shape.
4. builder - the port's host builder: the three demo designs from
             tests/fixtures/torch_port/design_*.json to Models, bucket
             signatures and packed leaves, held against the JAX builder's
             packed_*.npz (signatures equal, float leaves within 1e-12 x
             max, integer and boolean leaves exact); build time per design.
5. slice   - the three port-built packed designs through
             sweep_heterogeneous in float64: first the golden rows alone
             (warm-up, held against tests/fixtures/torch_port/golden_*.npz),
             then --rows-per-design seeded sea states per design with the
             golden rows inside, timed per stage with CUDA events, with
             the kernel's launch count checked against the trips run.
6. design  - the design-axis DoE: make_design_evaluator of each Model
             over --rows-per-design seeded rows of (Hs, Tp, beta,
             Cd_scale, Ca_scale, L_moor_scale) in chunks of
             RAFT_TPU_BUCKET_ROWS, the golden design rows first (held
             against golden_design_*.npz), timed per stage with CUDA
             events, the kernel's launches checked against the trips run.
7. catenary - per design at 512 rows: the statics Newton's iterations
             and mooring evaluations per chunk, and the wall time of one
             mooring force + stiffness evaluation by the bucket path's
             hand-carried tangents and by torch.func.jacfwd, the two
             held against each other.
8. profile - torch.profiler over one 512-row chunk: device busy time,
             idle share, kernel launches (top kernels to
             <out>/profile_top.txt).
9. kernels - one JSON object listing every kernel the slice and design
             paths launched, with its launches on both.

Exits non-zero, before printing any result, without CUDA, outside the
repository, or when any phase misses its tolerance.  Measurements go to
<out>/chip_smoke.json as well.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures", "torch_port")
DESIGNS = ("spar", "semi", "mhk")
#: the design DoE's box: each parameter uniform over its range
DOE_BOX = dict(Hs=(1.0, 12.0), Tp=(4.0, 20.0), beta=(0.0, math.pi),
               Cd_scale=(0.5, 2.0), Ca_scale=(0.5, 1.5),
               L_moor_scale=(0.98, 1.02))
MEM_BPS = 3.35e12                      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.float64: 34e12,    # FP64 outside the tensor cores
              torch.float32: 67e12}    # FP32 outside the tensor cores
F64_TOL = 1e-12                        # x max|x|, kernel vs plain
F32_TOL = 1e-5                         # x max|x|, kernel vs plain
SLICE_TOL = 1e-10                      # x each key's max |golden|
BUILD_TOL = 1e-12                      # x each packed leaf's max
EXACT = ("status", "n_iter_drag", "drag_converged")
DEVICE = "cuda"


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def impedance_systems(rng, N, lead, nw, dtype):
    """Z (*lead, nw, N, N) = -w^2 M + i w B + C with SPD M, C and a
    small SPD damping B, as tests/test_linsolve.py builds them."""
    M = rng.normal(size=lead + (N, N))
    M = M @ np.swapaxes(M, -1, -2) + N * np.eye(N)
    C = rng.normal(size=lead + (N, N))
    C = C @ np.swapaxes(C, -1, -2) + N * np.eye(N)
    B = rng.normal(size=lead + (N, N))
    B = 0.05 * B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(N)
    w = np.linspace(0.01, 2.0, nw)[:, None, None]
    Z = (-(w ** 2) * M[..., None, :, :] + 1j * w * B[..., None, :, :]
         + C[..., None, :, :])
    return torch.as_tensor(Z).to(dtype)


def ge_flops(N):
    """Real floating-point operations of one pivot-free complex N x N
    elimination and back substitution (the kernel's arithmetic)."""
    f = 0
    for kk in range(N - 1):
        f += 3 + 3                       # |z|^2, 1/z
        f += (N - 1 - kk) * (6 + 8 * N + 8)
    for kk in range(N):
        f += (N - 1 - kk) * 8 + 3 + 8
    return f


def cuda_time(fn, reps=20, warm=3, queue_ahead=False):
    """Device ms per call over ``reps`` calls (CUDA events).  With
    ``queue_ahead`` the calls are queued behind a ~5 ms spin kernel, so
    a call shorter than its own launch runs back to back with the next
    and the events time the device work alone."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(10_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off")
    return card


def phase_build(out_dir):
    from raft_tpu_torch.ops import linsolve

    t0 = time.time()
    path, report = linsolve.build()
    dt = time.time() - t0
    with open(os.path.join(out_dir, "ptxas_linsolve.txt"), "w") as f:
        f.write(report)
    regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                   for ln in report.splitlines() if "Used" in ln})
    spills = sorted({ln.strip() for ln in report.splitlines()
                     if "spill" in ln and not
                     ln.strip().startswith("0 bytes spill")})
    linsolve._lib()
    print(f"build: {os.path.relpath(path, HERE)} in {dt:.1f} s "
          f"(registers {', '.join(regs) or 'reused build'}; "
          f"{len(spills)} spill lines)")
    return dict(build_s=dt, ptxas=report)


def phase_kernel():
    from raft_tpu_torch.ops import linsolve

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    worst = {}
    for dtype, tol in ((torch.complex128, F64_TOL),
                       (torch.complex64, F32_TOL)):
        for N in (1, 2, 3, 6, 9, 12):
            cases = {
                "broadcast": (impedance_systems(rng, N, (), 17, dtype),
                              (3, 17, N)),
                "ragged": (impedance_systems(rng, N, (25,), 40, dtype),
                           (25, 40, N)),
            }
            if N == 6:
                cases["main"] = (impedance_systems(rng, N, (512,), 40,
                                                   dtype), (512, 40, N))
            for name, (Z, fshape) in cases.items():
                F = torch.as_tensor(rng.normal(size=fshape)
                                    + 1j * rng.normal(size=fshape)).to(dtype)
                Z, F = Z.to(dev), F.to(dev)
                x_k = linsolve._cuda_solve(Z, F)
                x_p = linsolve._native_solve(Z, F)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(torch.view_as_real(x_k)).all()),
                      f"kernel N={N} {name} {dtype}: non-finite output")
                err = float(torch.max(torch.abs(x_k - x_p)))
                scale = float(torch.max(torch.abs(x_p)))
                check(err <= tol * scale,
                      f"kernel N={N} {name} {dtype}: |x_k - x_p| = {err:.3e}"
                      f" > {tol:g} x {scale:.3e}")
                worst[(str(dtype), N, name)] = (err, scale)

    # times at the main-path shape, float64
    Z = impedance_systems(rng, 6, (512,), 40, torch.complex128).to(dev)
    F = torch.as_tensor(rng.normal(size=(512, 40, 6))
                        + 1j * rng.normal(size=(512, 40, 6))).to(dev)
    B, N = 512 * 40, 6
    planes, _ = linsolve.soa_planes(Z, F)
    xr, xi = torch.empty_like(planes[2]), torch.empty_like(planes[2])

    def raw():
        err = linsolve.launch(planes, xr, xi)
        check(err == 0, f"raw kernel launch failed: cudaError {err}")

    t = dict(
        ms=cuda_time(raw, reps=100, queue_ahead=True),
        wrapper_ms=cuda_time(lambda: linsolve._cuda_solve(Z, F), reps=50),
        plain_ms=cuda_time(lambda: linsolve._native_solve(Z, F), reps=10),
        library_ms=cuda_time(lambda: torch.linalg.solve(Z, F[..., None]),
                             reps=10),
    )
    x_k = linsolve._cuda_solve(Z, F)
    x_p = linsolve._native_solve(Z, F)
    max_abs_err = float(torch.max(torch.abs(x_k - x_p)))
    nbytes = B * (2 * N * N + 2 * N + 2 * N) * 8
    bound_bytes = nbytes / MEM_BPS * 1e3
    bound_ops = B * ge_flops(N) / PEAK_FLOPS[torch.float64] * 1e3
    t.update(max_abs_err=max_abs_err, bytes=nbytes, flops=B * ge_flops(N),
             bound_ms=max(bound_bytes, bound_ops),
             bound_by="bytes" if bound_bytes >= bound_ops else "operations",
             worst_rel={f"{k[0]} N={k[1]} {k[2]}": e / s
                        for k, (e, s) in worst.items()})
    n_checks = len(worst)
    print(f"kernel: {n_checks} comparisons within tolerance (f64 "
          f"{F64_TOL:g}, f32 {F32_TOL:g} x max|x|); 20,480 systems N=6 f64: "
          f"kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms, torch.linalg.solve {t['library_ms']:.3f} "
          f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), max abs err "
          f"{max_abs_err:.3e}")
    return t


class StageTimer:
    """``timer(stage)`` callback: records a CUDA event per mark."""

    def __init__(self):
        self.marks = []

    def __call__(self, stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append((stage, e))

    def chunks(self):
        """Per chunk, {stage: ms since the previous mark}."""
        out, cur, prev = [], None, None
        for stage, e in self.marks:
            if stage == "start":
                cur = {}
                out.append(cur)
            else:
                cur[stage] = prev.elapsed_time(e)
            prev = e
        return out


def expected_launches(n_iter_rows, chunk_rows, cap, scan_chunk, fused):
    """Kernel launches the sweep must make: per chunk, the fixed point
    runs whole blocks of scan_chunk trips until every row is done (at
    most cap trips), then one final solve (and one more when FUSED is
    off)."""
    total = 0
    for a in range(0, len(n_iter_rows), chunk_rows):
        m = int(max(n_iter_rows[a:a + chunk_rows]))
        total += min(cap, math.ceil(m / scan_chunk) * scan_chunk) + 1
        total += 0 if fused else 1
    return total


def hold_goldens(out, where, gold, pfx, tag):
    """Rows ``where[name]`` of ``out`` against ``gold[name]``'s keys with
    prefix ``pfx``: floats within SLICE_TOL x each key's max, the status
    word, iteration counts and convergence flags exactly.  Returns the
    worst relative error per design.key."""
    from raft_tpu_torch.structure import bucketing as bk

    worst = {}
    for n, idx in where.items():
        g = gold[n]
        for k in bk.OUT_KEYS:
            a, b = out[k][idx], g[pfx + k]
            if k in EXACT:
                check(np.array_equal(a, b),
                      f"{tag} {n} {k}: {a.tolist()} != {b.tolist()}")
                continue
            scale = float(np.max(np.abs(b)))
            err = float(np.max(np.abs(a - b)))
            check(err <= SLICE_TOL * scale,
                  f"{tag} {n} {k}: {err:.3e} > {SLICE_TOL:g} x {scale:.3e}")
            worst[f"{n}.{k}"] = err / scale
    return worst


def phase_builder():
    """The three demo designs from their JSON through the port's builder
    (host work), held against the JAX builder's packed fixtures."""
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.structure import bucketing as bk

    models, packed, times, worst = {}, {}, {}, 0.0
    for n in DESIGNS:
        with open(os.path.join(FIX, f"design_{n}.json")) as f:
            d = json.load(f)
        t0 = time.time()
        m = Model(d)
        sig = bk.bucket_signature(m)
        leaves = bk.pack_design(m, sig)
        times[n] = time.time() - t0
        ref = bk.load_packed(os.path.join(FIX, f"packed_{n}.npz"))
        check(sig == ref.sig, f"builder {n}: signature {sig[:5]} != "
              f"{ref.sig[:5]}")
        check(sorted(leaves) == sorted(ref.leaves),
              f"builder {n}: leaves {sorted(leaves)}")
        for k, b in ref.leaves.items():
            a = np.asarray(leaves[k])
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"builder {n} {k}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
            if b.dtype.kind in "biu":
                check(np.array_equal(a, b), f"builder {n} {k}: not equal")
                continue
            scale = float(np.max(np.abs(b)))
            err = float(np.max(np.abs(a - b)))
            check(err <= BUILD_TOL * scale, f"builder {n} {k}: {err:.3e} > "
                  f"{BUILD_TOL:g} x {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        models[n] = m
        packed[n] = bk.PackedDesign(sig=sig, leaves=leaves)
    print("builder: design_*.json -> Model -> pack_design on the host, "
          f"signatures equal, leaves within {worst:.2e} x max (gate "
          f"{BUILD_TOL:g}), integer and boolean leaves exact; build s "
          + ", ".join(f"{n} {t:.3f}" for n, t in times.items()))
    return dict(build_s=times, worst_rel=worst), models, packed


def path_launches(n_iter_drag, sigs, rows_per_design):
    """Solve-kernel launches a run over DESIGNS (rows_per_design rows
    each, in design order) must make, from each row's trip count."""
    from raft_tpu_torch.structure import bucketing as bk
    from raft_tpu_torch.utils import config

    rows_chunk = int(config.get("BUCKET_ROWS")) or rows_per_design
    fused = config.get("FUSED") == "on"
    exp = 0
    for j, n in enumerate(DESIGNS):
        meta = bk.signature_meta(sigs[n])
        cap = meta["nIter"] * max(int(config.get("ITER_SCALE")), 1) + 1 \
            + max(int(meta["nIterExtra"]), 0)
        i0 = j * rows_per_design
        exp += expected_launches(
            n_iter_drag[i0:i0 + rows_per_design],
            min(rows_chunk, rows_per_design), cap,
            min(max(1, config.get("SCAN_CHUNK")), cap), fused)
    return exp


def per_design_stats(out, chunks, rows_per_design):
    """Per design (rows and chunks in design order): stage ms summed over
    its chunks, evaluations per second of device time, non-zero status
    rows and the largest trip count."""
    per = len(chunks) // len(DESIGNS)
    res = {}
    for j, n in enumerate(DESIGNS):
        cs = chunks[j * per:(j + 1) * per]
        st = {s: sum(c.get(s, 0.0) for c in cs)
              for s in ("statics", "excitation", "fixed_point", "response")}
        rows = slice(j * rows_per_design, (j + 1) * rows_per_design)
        res[n] = dict(stage_ms=st, chunks=len(cs),
                      evals_per_s=rows_per_design / (sum(st.values()) / 1e3),
                      status_nonzero=int(np.count_nonzero(out["status"][rows])),
                      n_iter_drag_max=int(np.max(out["n_iter_drag"][rows])))
    return res


def phase_slice(packed, rows_per_design, card, seed=20261016):
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel.sweep import sweep_heterogeneous
    from raft_tpu_torch.structure import bucketing as bk
    from raft_tpu_torch.utils import config

    dev = torch.device(DEVICE)
    keys = bk.OUT_KEYS
    gold = {n: dict(np.load(os.path.join(FIX, f"golden_{n}.npz")))
            for n in DESIGNS}
    fused = config.get("FUSED") == "on"
    pfx = "on_" if fused else "off_"

    def hold(out, where):
        return hold_goldens(out, where, gold, pfx, "slice")

    # warm-up: the golden rows alone
    designs, Hs, Tp, beta, where = [], [], [], [], {}
    for n in DESIGNS:
        g = gold[n]
        where[n] = np.arange(len(designs), len(designs) + len(g["Hs"]))
        designs += [packed[n]] * len(g["Hs"])
        Hs += list(g["Hs"])
        Tp += list(g["Tp"])
        beta += list(g["beta"])
    t0 = time.time()
    out = sweep_heterogeneous(designs, Hs, Tp, beta, device=dev,
                              out_keys=keys)
    warm_s = time.time() - t0
    worst_warm = hold(out, where)

    # main run: rows_per_design seeded sea states per design, golden
    # rows first, designs in order so chunk k of a design holds rows
    # [k * BUCKET_ROWS, (k + 1) * BUCKET_ROWS)
    rng = np.random.default_rng(seed)
    designs, Hs, Tp, beta, where = [], [], [], [], {}
    for n in DESIGNS:
        g = gold[n]
        m = rows_per_design - len(g["Hs"])
        where[n] = np.arange(len(designs), len(designs) + len(g["Hs"]))
        designs += [packed[n]] * rows_per_design
        Hs += list(g["Hs"]) + list(rng.uniform(1.0, 12.0, m))
        Tp += list(g["Tp"]) + list(rng.uniform(4.0, 20.0, m))
        beta += list(g["beta"]) + list(rng.uniform(0.0, np.pi, m))
    timer = StageTimer()
    linsolve.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = sweep_heterogeneous(designs, Hs, Tp, beta, device=dev,
                              out_keys=keys, timer=timer)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = linsolve.KERNEL_LAUNCHES
    worst_main = hold(out, where)
    for k in ("X0", "Xi", "PSD"):
        v = out[k]
        check(np.all(np.isfinite(v)), f"slice main run: non-finite {k}")

    exp = path_launches(out["n_iter_drag"],
                        {n: packed[n].sig for n in DESIGNS}, rows_per_design)
    check(launches == exp,
          f"slice: solve kernel launched {launches} times, expected {exp}")
    per_design = per_design_stats(out, timer.chunks(), rows_per_design)
    total_rows = rows_per_design * len(DESIGNS)
    res = dict(rows=total_rows, wall_s=wall, evals_per_s=total_rows / wall,
               warm_s=warm_s, launches=launches, expected_launches=exp,
               per_design=per_design,
               worst_rel=max(list(worst_warm.values())
                             + list(worst_main.values())))
    print(f"slice on {card}: {total_rows} rows ({rows_per_design}/design, "
          f"{len(timer.chunks())} chunks) in {wall:.2f} s = "
          f"{res['evals_per_s']:.1f} case-evals/s; goldens within "
          f"{res['worst_rel']:.2e} x max (gate {SLICE_TOL:g}), status and "
          f"n_iter_drag equal; solve kernel launches {launches} "
          f"(expected {exp})")
    for n, p in per_design.items():
        st = p["stage_ms"]
        print(f"  {n}: {p['evals_per_s']:.1f} case-evals/s; stage ms "
              + ", ".join(f"{s} {v:.1f}" for s, v in st.items())
              + f"; status!=0 rows {p['status_nonzero']}")
    return res


def phase_design(models, rows_per_design, card, seed=20261017):
    """The design-axis DoE on the card: per design, rows_per_design rows
    of DOE_BOX from a fixed seed, the golden design rows first."""
    from raft_tpu_torch.api import make_design_evaluator
    from raft_tpu_torch.models import statics_solve
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    keys = list(DOE_BOX)
    gold = {n: dict(np.load(os.path.join(FIX, f"golden_design_{n}.npz")))
            for n in DESIGNS}
    pfx = "on_" if config.get("FUSED") == "on" else "off_"
    evs = {n: make_design_evaluator(models[n], DEVICE) for n in DESIGNS}

    def run(params, timer=None):
        out = {}
        for n in DESIGNS:
            res = evs[n](**params[n], timer=timer)
            for k, v in res.items():
                out.setdefault(k, []).append(v.cpu().numpy())
        return {k: np.concatenate(v) for k, v in out.items()}

    # warm-up: the golden rows alone
    n_gold = len(gold[DESIGNS[0]]["Hs"])
    t0 = time.time()
    out = run({n: {k: gold[n][k] for k in keys} for n in DESIGNS})
    warm_s = time.time() - t0
    where = {n: np.arange(j * n_gold, (j + 1) * n_gold)
             for j, n in enumerate(DESIGNS)}
    worst = hold_goldens(out, where, gold, pfx, "design")

    rng = np.random.default_rng(seed)
    params = {}
    for n in DESIGNS:
        m = rows_per_design - n_gold
        params[n] = {k: np.concatenate([gold[n][k], rng.uniform(*DOE_BOX[k],
                                                                m)])
                     for k in keys}
    # count the statics' mooring force+stiffness evaluations (Newton
    # iterations + 1 per chunk: the per-row mooring lengths set them)
    evals = []
    mooring_fs = statics_solve.mooring_force_and_stiffness

    def counted(ms, X):
        evals.append(1)
        return mooring_fs(ms, X)

    timer = StageTimer()
    statics_solve.mooring_force_and_stiffness = counted
    linsolve.reset_launches()
    torch.cuda.synchronize()
    try:
        t0 = time.time()
        out = run(params, timer)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        statics_solve.mooring_force_and_stiffness = mooring_fs
    launches = linsolve.KERNEL_LAUNCHES
    where = {n: np.arange(j * rows_per_design, j * rows_per_design + n_gold)
             for j, n in enumerate(DESIGNS)}
    worst.update(hold_goldens(out, where, gold, pfx, "design"))
    for k in ("X0", "Xi", "PSD"):
        check(np.all(np.isfinite(out[k])), f"design run: non-finite {k}")
    exp = path_launches(out["n_iter_drag"],
                        {n: evs[n].body.sig for n in DESIGNS},
                        rows_per_design)
    check(launches == exp,
          f"design: solve kernel launched {launches} times, expected {exp}")
    per_design = per_design_stats(out, timer.chunks(), rows_per_design)
    total = rows_per_design * len(DESIGNS)
    n_chunks = len(timer.chunks())
    res = dict(rows=total, wall_s=wall, evals_per_s=total / wall,
               warm_s=warm_s, launches=launches, expected_launches=exp,
               mooring_evals=len(evals), chunks=n_chunks,
               per_design=per_design, worst_rel=max(worst.values()),
               box=DOE_BOX)
    print(f"design on {card}: {total} rows ({rows_per_design}/design, "
          f"{n_chunks} chunks) in {wall:.2f} s = "
          f"{res['evals_per_s']:.1f} design-evals/s; goldens within "
          f"{res['worst_rel']:.2e} x max (gate {SLICE_TOL:g}), status and "
          f"n_iter_drag equal; solve kernel launches {launches} "
          f"(expected {exp}); statics mooring evaluations {len(evals)} "
          f"({len(evals) / n_chunks:.2f} per chunk)")
    for n, p in per_design.items():
        st = p["stage_ms"]
        print(f"  {n}: {p['evals_per_s']:.1f} design-evals/s; stage ms "
              f"statics {st['statics']:.1f}, hydro constants + excitation "
              f"{st['excitation']:.1f}, fixed_point {st['fixed_point']:.1f}, "
              f"response {st['response']:.1f}; status!=0 rows "
              f"{p['status_nonzero']}")
    return res


def phase_catenary(rows=512, reps=3):
    """Per design at one chunk's rows: the statics Newton's iterations
    and mooring evaluations (the same for every row of a design: the
    statics sees no sea state), and the wall time of one mooring force +
    stiffness evaluation (the forward-mode catenary storm), by the bucket
    path's hand-carried tangents and by the vmapped torch.func.jacfwd,
    the two held against each other."""
    from raft_tpu_torch.models.statics_solve import solve_equilibrium_general
    from raft_tpu_torch.physics import mooring
    from raft_tpu_torch.structure import bucketing as bk

    def wall_ms(fn, X, reps):
        """Mean wall ms of ``reps`` calls, after the warm-up calls the
        statics run and the comparison below have made."""
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            fn(X)
        torch.cuda.synchronize()
        return (time.time() - t0) / reps * 1e3

    out = {}
    for n in DESIGNS:
        p = bk.load_packed(os.path.join(FIX, f"packed_{n}.npz"))
        d = bk.packed_from_numpy(bk.stack_packed([p.leaves] * rows), DEVICE)
        line_args = [d[k] for k in ("moor_fair0", "moor_anchor", "moor_L",
                                    "moor_w", "moor_EA", "line_mask")]
        hand = bk._masked_moor_closures(d)
        evals = []

        def counted(X):
            evals.append(1)
            return hand(X)

        f64 = dict(dtype=torch.float64, device=DEVICE)
        X0, _, it, _, _, _ = solve_equilibrium_general(
            d["K_h"], d["F_und"], torch.zeros_like(d["F_und"]), counted,
            torch.tensor(bk._TOL6, **f64), torch.tensor(bk._CAP6, **f64),
            torch.zeros(6, **f64))

        def jacfwd(X):
            return mooring.stiffness_jacfwd(*line_args, X)

        F_h, C_h = hand(X0)
        F_j, C_j = jacfwd(X0)
        err = {}
        for k, a, b in (("F", F_h, F_j), ("C", C_h, C_j)):
            err[k] = float(torch.max(torch.abs(a - b))
                           / torch.max(torch.abs(b)))
            check(err[k] <= 1e-11, f"catenary {n}: hand tangents vs "
                  f"jacfwd {k} {err[k]:.3e} > 1e-11 x max")
        out[n] = dict(newton_iters=int(it.max()), mooring_evals=len(evals),
                      hand_ms=wall_ms(hand, X0, reps),
                      jacfwd_ms=wall_ms(jacfwd, X0, 1), rel_err=err)
    print(f"catenary: one mooring force + stiffness at {rows} rows, wall ms "
          f"(hand tangents over {reps} calls / torch.func.jacfwd over 1, "
          "within 1e-11 x max of each other); statics Newton iterations "
          "and mooring evaluations per chunk: " + "; ".join(
              f"{n} {v['hand_ms']:.1f} / {v['jacfwd_ms']:.1f} ms, "
              f"{v['newton_iters']} it, {v['mooring_evals']} evals"
              for n, v in out.items()))
    return out


def phase_profile(out_dir, name="mhk", rows=512):
    """torch.profiler over one chunk of the bucket path: the device's
    busy time (sum of kernel self times on the one stream) against the
    chunk's wall time, and the number of kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.structure import bucketing as bk

    p = bk.load_packed(os.path.join(FIX, f"packed_{name}.npz"))
    g = np.load(os.path.join(FIX, f"golden_{name}.npz"))
    take = np.arange(rows) % len(g["Hs"])
    d = bk.packed_from_numpy(bk.stack_packed([p.leaves] * rows), DEVICE)
    ev = bk.BucketEvaluator(p.sig, DEVICE)
    args = [torch.as_tensor(g[k][take]) for k in ("Hs", "Tp", "beta")]
    with torch.no_grad():
        ev(d, *args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            ev(d, *args)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    avg = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in avg
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)
    with open(os.path.join(out_dir, "profile_top.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=25))
    ge = [e for e in kernels if "ge_solve_kernel" in e.key]
    ge_us = (sum(e.self_device_time_total for e in ge)
             / max(sum(e.count for e in ge), 1))
    res = dict(design=name, rows=rows, wall_ms=wall_ms, busy_ms=busy_ms,
               idle_share=(1.0 - busy_ms / wall_ms) if wall_ms else None,
               kernel_launches=launches, ge_solve_us=ge_us,
               top=[(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in top[:5]])
    if busy_ms > 0:
        print(f"profile: one {rows}-row {name} chunk: wall {wall_ms:.1f} ms "
              f"(under the profiler), device busy {busy_ms:.1f} ms, idle "
              f"share {res['idle_share']:.3f}, {launches} kernel launches; "
              f"ge_solve_kernel {ge_us:.2f} us per launch")
    else:
        print("profile: the profiler recorded no device time (not measured)")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per-design", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(HERE, "chip_smoke_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    rec = {}
    try:
        rec["card"] = phase_device()
        rec["build"] = phase_build(args.out)
        rec["kernel"] = phase_kernel()
        rec["builder"], models, packed = phase_builder()
        rec["slice"] = phase_slice(packed, args.rows_per_design, rec["card"])
        rec["design"] = phase_design(models, args.rows_per_design,
                                     rec["card"])
        rec["catenary"] = phase_catenary()
        rec["profile"] = phase_profile(args.out)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k = rec["kernel"]
    kernels = [dict(
        name="ge_solve", route="cuda",
        source="raft_tpu_torch/csrc/linsolve.cu",
        replaces="raft_tpu/ops/linsolve.py:277",
        launches=rec["slice"]["launches"] + rec["design"]["launches"],
        max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=k["library_ms"])]
    rec["build"].pop("ptxas")
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
