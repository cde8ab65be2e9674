"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--rows-per-design 4096] [--out DIR]

Phases, each printing one line (the last line is the result object):

1. device  - the card's name and power limit (nvidia-smi); TF32 off.
2. build   - nvcc builds raft_tpu_torch/csrc/linsolve.cu for sm_90a
             afresh; the -Xptxas -v report goes to
             <out>/ptxas_linsolve.txt, and the registers and spill bytes
             of every instantiation (design, type, N, entry) are
             printed; fails if one is missing or an instantiation of
             the one-lane-per-row design (N = 7-12) spills.
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
9. full    - the full-physics evaluator (make_full_evaluator, float64,
             default flags) on the two rotor designs: semi_wind (one wave
             heading) and mhk_tidal (two), FULL_ROWS (4096) rows each
             from a fixed seed with the golden rows first (held against
             tests/fixtures/torch_port/golden_full_*.npz, warm-up on the
             golden rows alone); full-evals/s, stage ms (aero, statics,
             excitation, fixed_point, response), statics Newton
             iterations per chunk, the solve kernel's launches against
             the trips run.
10. bemt   - the blade-element load derivatives at 512 semi_wind
             operating points by the hand-carried tangents and by the
             torch.func.jacfwd oracle, held against each other and timed;
    staged_solve - the staged response's solve at its shape (512 rows x
             2 headings x 40 frequencies against one Z per row): times
             of the SoA repack, the kernel and the wrapper.
11. profile_full - torch.profiler over one 512-row semi_wind chunk of
             the full path: kernel launches and device busy time of the
             aero stage alone and of the whole chunk, idle share.
12. geometry - the geometry design axis: make_full_evaluator(...,
             geometry=True) on design_semi_wind.json over GEOMETRY_ROWS
             (4096) rows in 512-row chunks, the full phase's operating rows
             with per-member diameter, thickness, fill and fill-density
             scales and per-row drag, added-mass, mooring-length and
             mooring-stiffness scales drawn over GEOM_BOX; the golden
             geometry rows first (held against golden_geometry_semi_wind.npz,
             warm-up on them alone); geometry-evals/s, stage ms (geometry,
             aero, statics, excitation, fixed_point, response), Newton
             iterations per chunk, status-bit shares, the solve kernel's
             launches against the trips run; the pivots of the adjoint
             systems Z^H of every row against the forward's.
13. grad    - reverse-mode gradients of sum |Xi[0]|^2 + sum X0^2 with
             respect to every geometry key on GRAD_ROWS (512) semi_wind
             rows (the golden gradient rows first, held against
             golden_grad_semi_wind.npz within 1e-9 x max|g|), and with
             respect to the six design-evaluator inputs on the demos'
             golden rows (golden_grad_design_*.npz); gradient rows/s,
             backward/forward time, peak memory per chunk, the adjoint
             entry's launches per chunk against NEUMANN_STEPS + 2; then
             the adjoint entry against its plain version
             _native_solve(Z.mH, G) at 20,480 systems (bit-equal), its
             time beside the byte bound, the plain version's and
             torch.linalg.solve's on the same adjoint systems.
14. farm    - the farm evaluator (make_farm_evaluator, float64) on
             design_farm_semi_wind.json, two units with their own
             catenaries and a shared line over a free buoy (nT = 12):
             warm-up on the golden rows alone, then FARM_ROWS (1024)
             seeded operating rows (free-stream wind for the upstream
             unit, a wake deficit of 0-35% for the downstream one) with
             the golden rows first, held against golden_farm_semi_wind.npz;
             farm-evals/s, stage ms (aero, statics, excitation,
             fixed_point, system_response), statics Newton iterations per
             chunk and free-point steps per network solve, status-bit
             shares, the solve kernel's launches against the trips run
             (per chunk: trips + the final update at N = 6 + the system
             response at N = 12), the system response's launches on the
             one-lane-per-row design (one per chunk); then the golden
             rows of the three-spar farm (nT = 18, torch.linalg.solve),
             held, untimed.
15. kernel12 - the one-lane-per-row design (N = 7-12), forward and
             adjoint, against its plain versions _native_solve(Z, F) and
             _native_solve(Z.mH, G) at N = 7-12 on a ragged batch
             (float64 bit-equal, float32 within F32_TOL); then at the
             farm's system-response shape (512 rows x 40 frequencies =
             20,480 systems of N = 12, complex128), for each entry, the
             raw kernel's time on Z and F as they lie, the wrapper's, the
             plain version's, torch.linalg.solve's and the bound.
16. profile_farm - torch.profiler over one 512-row farm chunk: kernel
             launches, device busy time, idle share.
17. kernels - one JSON object listing both entries of the solve kernel,
             the forward with its launches on every path and the adjoint
             with its launches on the grad path, each with its N = 12
             (one-lane-per-row) figures.

Exits non-zero, before printing any result, without CUDA, outside the
repository, or when any phase misses its tolerance.  Measurements go to
<out>/chip_smoke.json as well.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
BEMT_TOL = 1e-12                       # x max, hand tangents vs jacfwd
#: the full path's configurations: wave headings per row and the seed of
#: their rows
FULL_CONFIGS = {"semi_wind": dict(nWaves=1, seed=20261018),
                "mhk_tidal": dict(nWaves=2, seed=20261019)}
FULL_ROWS = 4096                       # rows per rotor design, full phase
#: the geometry phase's design, rows and seed; its box of geometry scales
GEOMETRY_DESIGN = "semi_wind"
GEOMETRY_ROWS = 4096
GEOMETRY_SEED = 20261022
GEOM_BOX = dict(d_scale=(0.9, 1.1), t_scale=(0.9, 1.1),
                fill_scale=(0.8, 1.2), rho_fill_scale=(0.9, 1.1),
                Cd_scale=(0.5, 2.0), Ca_scale=(0.5, 1.5),
                L_moor_scale=(0.98, 1.02), EA_moor_scale=(0.8, 1.2))
GRAD_ROWS = 512                        # rows of the grad phase (one chunk)
GRAD_TOL = 1e-9                        # x each key's max |golden gradient|
FARM_ROWS = 1024                       # rows of the farm phase (2 chunks)
FARM_SEED = 20261023
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


def ge_flops(N, live=False):
    """Real floating-point operations of one pivot-free complex N x N
    elimination and back substitution: as the thread-per-system design
    computes them (whole rows), or with ``live`` only those whose result
    is read again (columns j > kk of the rows below the pivot), as the
    one-lane-per-row design computes them."""
    f = 0
    for kk in range(N - 1):
        f += 3 + 3                       # |z|^2, 1/z
        cols = N - 1 - kk if live else N
        f += (N - 1 - kk) * (6 + 8 * cols + 8)
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


ROW_NS = (7, 8, 9, 10, 11, 12)         # the one-lane-per-row design's N


def ptxas_table(report):
    """{(design, type, N, entry): {registers, stack, spill_stores,
    spill_loads}} of every kernel instantiation in nvcc's -Xptxas -v
    report; design "soa" (thread per system) or "rows" (lane per row)."""
    name = re.compile(r"(ge_solve(_rows)?_kernel)I([df])Li(\d+)ELb([01])E")
    table, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = name.search(m.group(1))
            cur = None if k is None else (
                "rows" if k.group(2) else "soa",
                "f64" if k.group(3) == "d" else "f32", int(k.group(4)),
                "adj" if k.group(5) == "1" else "fwd")
            if cur:
                table[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            table[cur].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[cur]["registers"] = int(m[1])
    return table


def phase_build(out_dir):
    from raft_tpu_torch.ops import linsolve

    t0 = time.time()
    path, report = linsolve.build(force=True)
    dt = time.time() - t0
    with open(os.path.join(out_dir, "ptxas_linsolve.txt"), "w") as f:
        f.write(report)
    table = ptxas_table(report)
    want = [(d, t, n, e) for t in ("f64", "f32") for e in ("fwd", "adj")
            for d, ns in (("soa", range(1, 7)), ("rows", ROW_NS))
            for n in ns]
    missing = [k for k in want if "registers" not in table.get(k, {})]
    check(not missing, f"build: no ptxas report of {missing}")
    check(sorted(table) == sorted(want),
          f"build: unexpected instantiations "
          f"{sorted(set(table) - set(want))}")
    spilled = [k for k in want if k[0] == "rows" and (
        table[k].get("spill_stores", 0) or table[k].get("spill_loads", 0))]
    linsolve._lib()
    print(f"build: {os.path.relpath(path, HERE)} in {dt:.1f} s, "
          f"{len(table)} instantiations")
    for d, ns in (("soa", range(1, 7)), ("rows", ROW_NS)):
        for t in ("f64", "f32"):
            for e in ("fwd", "adj"):
                print(f"  ptxas {d} {t} {e}: " + ", ".join(
                    f"N={n} {table[(d, t, n, e)]['registers']} regs "
                    f"{table[(d, t, n, e)].get('spill_stores', 0)}"
                    f"+{table[(d, t, n, e)].get('spill_loads', 0)} B spill"
                    for n in ns))
    check(not spilled, f"build: the row design spills in {spilled}")
    return dict(build_s=dt, ptxas=report,
                ptxas_table={" ".join(map(str, k)): v
                             for k, v in table.items()})


def time_kernel(Z, F):
    """CUDA-event times of the raw kernel, the wrapper, the plain version
    and torch.linalg.solve on the systems Z (..., N, N) against F
    (..., N), float64, the kernel's max abs difference from the plain
    version, and its bound: the larger of the bytes it must move (Z, F
    and x, each once) over the memory rate and its operations over the
    FP64 peak."""
    from raft_tpu_torch.ops import linsolve

    N = Z.shape[-1]
    B = F.numel() // N
    planes, _ = linsolve.soa_planes(Z, F)
    xr, xi = torch.empty_like(planes[2]), torch.empty_like(planes[2])

    def raw():
        err = linsolve.launch(planes, xr, xi)
        check(err == 0, f"raw kernel launch N={N} failed: cudaError {err}")

    t = dict(
        N=N, systems=B,
        ms=cuda_time(raw, reps=100, queue_ahead=True),
        wrapper_ms=cuda_time(lambda: linsolve._cuda_solve(Z, F), reps=50),
        plain_ms=cuda_time(lambda: linsolve._native_solve(Z, F), reps=10),
        library_ms=cuda_time(lambda: torch.linalg.solve(Z, F[..., None]),
                             reps=10),
    )
    x_k = linsolve._cuda_solve(Z, F)
    x_p = linsolve._native_solve(Z, F)
    nbytes = B * (2 * N * N + 2 * N + 2 * N) * 8
    bound_bytes = nbytes / MEM_BPS * 1e3
    bound_ops = B * ge_flops(N) / PEAK_FLOPS[torch.float64] * 1e3
    t.update(max_abs_err=float(torch.max(torch.abs(x_k - x_p))),
             bytes=nbytes, flops=B * ge_flops(N),
             bound_ms=max(bound_bytes, bound_ops),
             bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    return t


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
    t = time_kernel(Z, F)
    t.update(worst_rel={f"{k[0]} N={k[1]} {k[2]}": e / s
                        for k, (e, s) in worst.items()})
    n_checks = len(worst)
    print(f"kernel: {n_checks} comparisons within tolerance (f64 "
          f"{F64_TOL:g}, f32 {F32_TOL:g} x max|x|); 20,480 systems N=6 f64: "
          f"kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms, torch.linalg.solve {t['library_ms']:.3f} "
          f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), max abs err "
          f"{t['max_abs_err']:.3e}")
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


def hold_goldens(out, where, gold, pfx, tag, keys=None):
    """Rows ``where[name]`` of ``out`` against ``gold[name]``'s keys with
    prefix ``pfx`` (``keys``, default the bucket path's): floats within
    SLICE_TOL x each key's max, the status word, iteration counts and
    convergence flags exactly.  Returns the worst relative error per
    design.key."""
    from raft_tpu_torch.structure import bucketing as bk

    worst = {}
    for n, idx in where.items():
        g = gold[n]
        for k in keys or bk.OUT_KEYS:
            a, b = out[k][idx], g[pfx + k]
            if k in EXACT:
                check(np.array_equal(a, b),
                      f"{tag} {n} {k}: {a.tolist()} != {b.tolist()}")
                continue
            scale = float(np.max(np.abs(b)))
            err = float(np.max(np.abs(a - b)))
            check(err <= SLICE_TOL * scale,
                  f"{tag} {n} {k}: {err:.3e} > {SLICE_TOL:g} x {scale:.3e}")
            worst[f"{n}.{k}"] = err / scale if scale else 0.0
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
    timer = StageTimer()
    with MooringCounter() as moor:
        linsolve.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = run(params, timer)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evals = [1] * moor.n
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


def full_rows(name, gold, n, seed):
    """``n`` rows of one full-path configuration: the golden rows first,
    then draws from a fixed numpy seed over the configuration's box."""
    from raft_tpu_torch.api import ENV_KEYS, SEA_KEYS

    rng = np.random.default_rng(seed)
    m = n - len(gold["Hs"])
    nW = FULL_CONFIGS[name]["nWaves"]
    u = rng.uniform
    if name == "semi_wind":
        wind = u(3.0, 25.0, m)
        wind[rng.random(m) < 0.05] = 0.0
        new = dict(wind_speed=wind, wind_heading_deg=u(-30.0, 30.0, m),
                   TI=u(0.05, 0.20, m), yaw_misalign_deg=u(-8.0, 8.0, m),
                   current_speed=u(0.0, 1.0, m),
                   current_heading_deg=u(0.0, 360.0, m),
                   Hs=u(1.0, 12.0, (m, nW)), Tp=u(4.0, 20.0, (m, nW)),
                   gamma=np.zeros((m, nW)), beta_deg=u(0.0, 180.0, (m, nW)))
    else:
        gamma = np.where(rng.random((m, nW)) < 0.5, 0.0, u(1.0, 5.0, (m, nW)))
        new = dict(wind_speed=np.zeros(m), wind_heading_deg=np.zeros(m),
                   TI=u(0.05, 0.15, m), yaw_misalign_deg=np.zeros(m),
                   current_speed=u(0.5, 3.0, m),
                   current_heading_deg=u(-30.0, 30.0, m),
                   Hs=u(0.5, 4.0, (m, nW)), Tp=u(4.0, 12.0, (m, nW)),
                   gamma=gamma, beta_deg=u(0.0, 360.0, (m, nW)))
    return {k: np.concatenate([gold[k], new[k]]) for k in ENV_KEYS + SEA_KEYS}


class MooringCounter:
    """Counts the statics' mooring force + stiffness evaluations (one per
    Newton iteration plus one at the returned pose) while installed, and
    splits them per chunk at the timer's "start" and "statics" marks."""

    def __init__(self):
        from raft_tpu_torch.physics import mooring

        self.mod = mooring
        self.fn = mooring.line_forces_and_stiffness
        self.n = 0
        self.per_chunk = []

    def __enter__(self):
        def counted(*a, **kw):
            self.n += 1
            return self.fn(*a, **kw)

        self.mod.line_forces_and_stiffness = counted
        return self

    def __exit__(self, *exc):
        self.mod.line_forces_and_stiffness = self.fn

    def mark(self, stage):
        if stage == "start":
            self._n0 = self.n
        elif stage == "statics":
            self.per_chunk.append(self.n - self._n0)


def phase_full(models, rows, card):
    """The full-physics evaluator on each rotor design: warm-up on the
    golden rows (held), then ``rows`` rows with the golden rows first,
    timed per stage, the solve kernel's launches checked against the
    trips run, the statics Newton iterations counted per chunk."""
    from raft_tpu_torch.api import FULL_OUT_KEYS, make_full_evaluator
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config, health

    fused = config.get("FUSED") == "on"
    pfx = "on_" if fused else "off_"
    res, evs = {}, {}
    for name, cfg in FULL_CONFIGS.items():
        nW = cfg["nWaves"]
        gold = dict(np.load(os.path.join(FIX, f"golden_full_{name}.npz")))
        ev = make_full_evaluator(models[name], nWaves=nW, device=DEVICE)
        evs[name] = ev
        n_gold = len(gold["Hs"])

        def run(p, timer=None):
            out = ev(**p, timer=timer)
            return {k: v.cpu().numpy() for k, v in out.items()}

        t0 = time.time()
        out = run(full_rows(name, gold, n_gold, cfg["seed"]))
        warm_s = time.time() - t0
        worst = hold_goldens(out, {name: np.arange(n_gold)}, {name: gold},
                             pfx, "full", keys=FULL_OUT_KEYS)

        p = full_rows(name, gold, rows, cfg["seed"])
        timer = StageTimer()
        with MooringCounter() as moor:
            def mark(stage):
                moor.mark(stage)
                timer(stage)

            linsolve.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            out = run(p, mark)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = linsolve.KERNEL_LAUNCHES
        main = hold_goldens(out, {name: np.arange(n_gold)}, {name: gold},
                            pfx, "full", keys=FULL_OUT_KEYS)
        for k, v in main.items():
            worst[k] = max(worst[k], v)
        for k in ("X0", "Xi", "PSD", "f_aero"):
            check(np.all(np.isfinite(out[k])), f"full {name}: non-finite {k}")
        cap = ev.body.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
            + max(int(ev.body.n_iter_extra), 0)
        chunk_rows = int(config.get("BUCKET_ROWS")) or rows
        exp = expected_launches(out["n_iter_drag"], chunk_rows, cap,
                                min(max(1, config.get("SCAN_CHUNK")), cap),
                                fused and nW == 1)
        check(launches == exp, f"full {name}: solve kernel launched "
              f"{launches} times, expected {exp}")
        chunks = timer.chunks()
        stage_ms = {s: sum(c.get(s, 0.0) for c in chunks)
                    for s in ("aero", "statics", "excitation", "fixed_point",
                              "response")}
        newton = [e - 1 for e in moor.per_chunk]
        st = out["status"]
        res[name] = dict(
            rows=rows, nWaves=nW, wall_s=wall, evals_per_s=rows / wall,
            device_evals_per_s=rows / (sum(stage_ms.values()) / 1e3),
            warm_s=warm_s, chunks=len(chunks), stage_ms=stage_ms,
            newton_per_chunk=newton, launches=launches,
            expected_launches=exp, staged=not (fused and nW == 1),
            n_iter_drag_max=int(out["n_iter_drag"].max()),
            status_counts={int(v): int(c) for v, c in
                           zip(*np.unique(st, return_counts=True))},
            rows_with_bit={b: int(np.count_nonzero(st & m))
                           for b, m in health.MASKS.items()
                           if np.any(st & m)},
            # where the step-capped rows' Newton ended: |X0| per DOF
            capped_X0_absmax=np.abs(out["X0"][
                (st & health.STATICS_STEP_CAPPED) > 0]).max(
                    axis=0, initial=0.0).tolist(),
            worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()})
        r = res[name]
        print(f"full {name} on {card}: {rows} rows, nWaves {nW}, "
              f"{r['chunks']} chunks in {wall:.2f} s = "
              f"{r['evals_per_s']:.1f} full-evals/s; stage ms "
              + ", ".join(f"{s} {v:.1f}" for s, v in stage_ms.items())
              + f"; statics Newton iterations per chunk {newton}; solve "
              f"kernel launches {launches} (expected {exp}: trips + "
              f"{2 if r['staged'] else 1} per chunk); rows per status "
              f"bit {r['rows_with_bit']}, step-capped rows end within "
              f"|X0| {np.round(r['capped_X0_absmax'], 3).tolist()}")
        print(f"  {name} goldens (gate {SLICE_TOL:g} x max; status, "
              "n_iter_drag, drag_converged equal): " + ", ".join(
                  f"{k} {v:.1e}" for k, v in r["worst_rel"].items()))
    return res, evs


def _bemt_points(ev, rows, seed=20261020):
    """``rows`` semi_wind operating points on the card: U over 3-25 m/s,
    the schedule's rotor speed and pitch, tilt and yaw around zero."""
    from raft_tpu_torch.physics import aero

    rt = ev.rotors[0][2]
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float64, device=DEVICE)
    U = torch.as_tensor(rng.uniform(3.0, 25.0, rows), **kw)
    Om, pit = aero.operating_point(rt, U)
    tilt = torch.as_tensor(rng.uniform(0.0, 0.2, rows), **kw)
    yaw = torch.as_tensor(rng.uniform(-0.3, 0.3, rows), **kw)
    return rt, (U, Om, pit, tilt, yaw)


def phase_bemt(ev, rows=512, reps=3):
    """The load derivatives by hand-carried tangents and by the
    torch.func.jacfwd oracle at ``rows`` operating points on the card:
    held against each other, wall ms per call (synchronised)."""
    from raft_tpu_torch.physics import aero

    rt, args = _bemt_points(ev, rows)

    def wall_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            out = fn(rt, *args)
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3, out

    wall_ms(aero.rotor_loads_and_derivs, 1)
    wall_ms(aero.rotor_loads_and_derivs_jacfwd, 1)
    hand_ms, hand = wall_ms(aero.rotor_loads_and_derivs, reps)
    jac_ms, jac = wall_ms(aero.rotor_loads_and_derivs_jacfwd, reps)
    err = {}
    for k, a, b in zip(("loads", "dT", "dQ"), hand, jac):
        err[k] = float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(a)))
        check(err[k] <= BEMT_TOL, f"bemt: hand vs jacfwd {k} {err[k]:.3e} > "
              f"{BEMT_TOL:g} x max")
    res = dict(rows=rows, hand_ms=hand_ms, jacfwd_ms=jac_ms, rel_err=err,
               residual_evals=aero.RESIDUAL_EVALS)
    print(f"bemt: loads + dT, dQ at {rows} operating points x "
          f"{rt.azimuths.numel()} azimuths x {rt.theta_deg.numel()} elements: "
          f"hand tangents {hand_ms:.1f} ms, torch.func.jacfwd {jac_ms:.1f} ms "
          f"(wall, per call); within " + ", ".join(
              f"{k} {v:.1e}" for k, v in err.items())
          + f" x max of each other (gate {BEMT_TOL:g})")
    return res


def phase_staged_solve(rows=512, nWaves=2, nw=40):
    """The staged multi-heading response's solve at the full path's
    shape: Z (rows, 1, nw, 6, 6) against F (rows, nWaves, nw, 6), as
    ``system_response`` broadcasts it.  CUDA-event times of the SoA
    repack (which copies Z once per heading), of the raw kernel on the
    repacked planes and of the whole wrapper."""
    from raft_tpu_torch.ops import linsolve

    rng = np.random.default_rng(3)
    Z = impedance_systems(rng, 6, (rows, 1), nw, torch.complex128).to(DEVICE)
    F = torch.as_tensor(rng.normal(size=(rows, nWaves, nw, 6))
                        + 1j * rng.normal(size=(rows, nWaves, nw, 6))
                        ).to(DEVICE)
    planes, _ = linsolve.soa_planes(Z, F)
    xr, xi = torch.empty_like(planes[2]), torch.empty_like(planes[2])

    def raw():
        check(linsolve.launch(planes, xr, xi) == 0, "staged: launch failed")

    res = dict(rows=rows, nWaves=nWaves, systems=rows * nWaves * nw,
               repack_ms=cuda_time(lambda: linsolve.soa_planes(Z, F),
                                   reps=20),
               kernel_ms=cuda_time(raw, reps=50, queue_ahead=True),
               wrapper_ms=cuda_time(lambda: linsolve._cuda_solve(Z, F),
                                    reps=20))
    err = float(torch.max(torch.abs(linsolve._cuda_solve(Z, F)
                                    - linsolve._native_solve(Z, F))))
    check(err <= F64_TOL * float(torch.max(torch.abs(
        linsolve._native_solve(Z, F)))), f"staged: kernel vs plain {err:.3e}")
    print(f"staged solve: {res['systems']:,} systems ({rows} rows x "
          f"{nWaves} headings x {nw} frequencies, Z shared by the "
          f"headings): SoA repack {res['repack_ms']:.4f} ms, kernel "
          f"{res['kernel_ms']:.4f} ms, wrapper {res['wrapper_ms']:.4f} ms")
    return res


def _profiled(fn):
    """(wall ms, device busy ms, kernel launches, key_averages) of one
    call of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    return wall_ms, busy_ms, launches, avg


def phase_profile_full(out_dir, ev, rows=512):
    """torch.profiler over the aero stage alone and over one whole
    ``rows``-row semi_wind chunk of the full path."""
    gold = dict(np.load(os.path.join(FIX, "golden_full_semi_wind.npz")))
    p = full_rows("semi_wind", gold, rows, FULL_CONFIGS["semi_wind"]["seed"])
    kw = dict(dtype=torch.float64, device=DEVICE)
    pt = {k: torch.as_tensor(v, **kw) for k, v in p.items()}
    with torch.no_grad():
        ev(**p)
        aero = _profiled(lambda: ev._aero(pt, rows))
        whole = _profiled(lambda: ev(**p))
    with open(os.path.join(out_dir, "profile_full_top.txt"), "w") as f:
        f.write(whole[3].table(sort_by="self_device_time_total",
                               row_limit=25))
    res = {}
    for tag, (wall, busy, launches, _) in (("aero", aero), ("chunk", whole)):
        res[tag] = dict(wall_ms=wall, busy_ms=busy, kernel_launches=launches,
                        idle_share=(1.0 - busy / wall) if wall else None)
    if whole[1] > 0:
        print(f"profile_full: one {rows}-row semi_wind chunk: aero stage "
              f"alone {res['aero']['kernel_launches']} kernel launches, "
              f"device busy {res['aero']['busy_ms']:.1f} ms of "
              f"{res['aero']['wall_ms']:.1f} ms; whole chunk "
              f"{res['chunk']['kernel_launches']} launches, device busy "
              f"{res['chunk']['busy_ms']:.1f} ms of "
              f"{res['chunk']['wall_ms']:.1f} ms (under the profiler), idle "
              f"share {res['chunk']['idle_share']:.3f}")
    else:
        print("profile_full: the profiler recorded no device time "
              "(not measured)")
    return res


def geometry_rows(n_members, n, seed, gold=None):
    """``n`` rows of geometry scales over GEOM_BOX from a fixed numpy
    seed, the golden rows (``geom_*`` of ``gold``) first."""
    rng = np.random.default_rng(seed)
    m = n - (0 if gold is None else len(gold["Hs"]))
    out = {}
    for k, box in GEOM_BOX.items():
        shape = (m, n_members) if k in ("d_scale", "t_scale", "fill_scale",
                                        "rho_fill_scale") else (m,)
        new = rng.uniform(*box, shape)
        out[k] = new if gold is None else np.concatenate(
            [gold["geom_" + k], new])
    return out


def _status_shares(st):
    from raft_tpu_torch.utils import health

    return {b: int(np.count_nonzero(st & mk)) / len(st)
            for b, mk in health.MASKS.items() if np.any(st & mk)}


def _adjoint_pivots(Z):
    """Per system, the smallest pivot modulus of the pivot-free
    elimination of Z^H over that of Z: how many systems the adjoint's
    elimination takes nearer a zero pivot, and the worst ratio."""
    from raft_tpu_torch.ops import linsolve

    fwd = torch.amin(linsolve.pivot_moduli(Z), dim=-1)
    adj = torch.amin(linsolve.pivot_moduli(Z.mH), dim=-1)
    ratio = (adj / fwd).flatten()
    return dict(systems=int(ratio.numel()),
                adjoint_smaller=int(torch.count_nonzero(ratio < 1.0)),
                min_ratio=float(ratio.min()),
                min_adjoint_pivot_rel=float(torch.min(
                    adj.flatten() / torch.amax(torch.abs(Z), dim=(-2, -1))
                    .flatten())))


def phase_geometry(model, card):
    """The geometry design axis on GEOMETRY_DESIGN: warm-up on the golden
    geometry rows (held), then GEOMETRY_ROWS rows with them first, timed
    per stage, the solve kernel's launches against the trips run."""
    from raft_tpu_torch.api import (FULL_OUT_KEYS, GEOMETRY_STAGES,
                                    make_full_evaluator)
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    name = GEOMETRY_DESIGN
    nW = FULL_CONFIGS[name]["nWaves"]
    fused = config.get("FUSED") == "on"
    pfx = "on_" if fused else "off_"
    gold = dict(np.load(os.path.join(FIX, f"golden_geometry_{name}.npz")))
    ev = make_full_evaluator(model, nWaves=nW, device=DEVICE, geometry=True)
    n_gold = len(gold["Hs"])
    nm = ev.n_members

    def run(p, geom, timer=None):
        out = ev(geom=geom, timer=timer, **p)
        return {k: v.cpu().numpy() for k, v in out.items()}, out["Z"]

    t0 = time.time()
    out, _ = run(full_rows(name, gold, n_gold, GEOMETRY_SEED),
                 geometry_rows(nm, n_gold, GEOMETRY_SEED, gold))
    warm_s = time.time() - t0
    worst = hold_goldens(out, {name: np.arange(n_gold)}, {name: gold}, pfx,
                         "geometry", keys=FULL_OUT_KEYS)

    p = full_rows(name, gold, GEOMETRY_ROWS, GEOMETRY_SEED)
    geom = geometry_rows(nm, GEOMETRY_ROWS, GEOMETRY_SEED, gold)
    timer = StageTimer()
    with MooringCounter() as moor:
        def mark(stage):
            moor.mark(stage)
            timer(stage)

        linsolve.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out, Z = run(p, geom, mark)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = linsolve.KERNEL_LAUNCHES
    main = hold_goldens(out, {name: np.arange(n_gold)}, {name: gold}, pfx,
                        "geometry", keys=FULL_OUT_KEYS)
    for k, v in main.items():
        worst[k] = max(worst[k], v)
    for k in ("X0", "Xi", "PSD"):
        check(np.all(np.isfinite(out[k])), f"geometry: non-finite {k}")
    cap = ev.body.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
        + max(int(ev.body.n_iter_extra), 0)
    chunk_rows = int(config.get("BUCKET_ROWS")) or GEOMETRY_ROWS
    exp = expected_launches(out["n_iter_drag"], chunk_rows, cap,
                            min(max(1, config.get("SCAN_CHUNK")), cap),
                            fused and nW == 1)
    check(launches == exp, f"geometry: solve kernel launched {launches} "
          f"times, expected {exp}")
    chunks = timer.chunks()
    stage_ms = {s: sum(c.get(s, 0.0) for c in chunks)
                for s in GEOMETRY_STAGES}
    newton = [e - 1 for e in moor.per_chunk]
    pivots = _adjoint_pivots(Z)
    res = dict(design=name, rows=GEOMETRY_ROWS, nWaves=nW, wall_s=wall,
               evals_per_s=GEOMETRY_ROWS / wall,
               device_evals_per_s=GEOMETRY_ROWS / (sum(stage_ms.values())
                                                   / 1e3),
               warm_s=warm_s, chunks=len(chunks), stage_ms=stage_ms,
               newton_per_chunk=newton, launches=launches,
               expected_launches=exp, status_shares=_status_shares(
                   out["status"]), pivots=pivots,
               n_iter_drag_max=int(out["n_iter_drag"].max()),
               worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()},
               box=GEOM_BOX)
    print(f"geometry {name} on {card}: {GEOMETRY_ROWS} rows, nWaves {nW}, "
          f"{len(chunks)} chunks in {wall:.2f} s = {res['evals_per_s']:.1f} "
          "geometry-evals/s; stage ms " + ", ".join(
              f"{s} {v:.1f}" for s, v in stage_ms.items())
          + f"; statics Newton iterations per chunk {newton}; solve kernel "
          f"launches {launches} (expected {exp}: trips + 1 per chunk); "
          f"status-bit shares {res['status_shares']}")
    print(f"  {name} geometry goldens (gate {SLICE_TOL:g} x max; status, "
          "n_iter_drag, drag_converged equal): worst "
          f"{max(res['worst_rel'].values()):.1e}; adjoint pivots: "
          f"{pivots['adjoint_smaller']} of {pivots['systems']:,} systems "
          f"take a smaller smallest pivot in Z^H than in Z, worst ratio "
          f"{pivots['min_ratio']:.4f}, smallest adjoint pivot "
          f"{pivots['min_adjoint_pivot_rel']:.3e} x max|Z|")
    return res, ev


def _metric(out):
    return (out["Xi"][:, 0].abs() ** 2).flatten(1).sum(-1) \
        + (out["X0"] ** 2).sum(-1)


def _hold_grads(val, grads, gold, pfx, tag, n):
    """The first ``n`` rows' metric and gradients against the golden's:
    the metric within 1e-12, each key within GRAD_TOL x its max|g|."""
    b = gold[pfx + "metric"]
    a = val[:n].detach().cpu().numpy()
    check(np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b)),
          f"{tag}: metric {a} != {b}")
    worst = {}
    for k, g in grads.items():
        b = gold[f"{pfx}g_{k}"]
        a = g[:n].cpu().numpy()
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        check(err <= GRAD_TOL * scale, f"{tag} {k}: {err:.3e} > "
              f"{GRAD_TOL:g} x {scale:.3e}")
        worst[k] = err / scale
    return worst


def phase_grad(geo_ev, demo_models, card):
    """Reverse-mode gradients on the card: every geometry key on
    GRAD_ROWS semi_wind rows, the six design-evaluator inputs on the
    demos' golden rows; then the adjoint entry against its plain version
    and torch.linalg.solve at the main-path shape."""
    from raft_tpu_torch.api import make_design_evaluator
    from raft_tpu_torch.models import dynamics
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    name = GEOMETRY_DESIGN
    pfx = "on_" if config.get("FUSED") == "on" else "off_"
    gold = dict(np.load(os.path.join(FIX, f"golden_grad_{name}.npz")))
    n_gold = len(gold["Hs"])
    p = full_rows(name, gold, GRAD_ROWS, GEOMETRY_SEED + 1)
    geom_np = geometry_rows(geo_ev.n_members, GRAD_ROWS, GEOMETRY_SEED + 1,
                            gold)
    kw = dict(dtype=torch.float64, device=DEVICE)

    def run():
        geom = {k: torch.tensor(v, **kw, requires_grad=True)
                for k, v in geom_np.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        val = _metric(geo_ev(geom=geom, **p))
        torch.cuda.synchronize()
        t1 = time.time()
        g = torch.autograd.grad(val.sum(), list(geom.values()))
        torch.cuda.synchronize()
        return val, dict(zip(geom, g)), t1 - t0, time.time() - t1

    run()                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    linsolve.reset_launches()
    val, grads, fwd_s, bwd_s = run()
    fwd_launches = linsolve.KERNEL_LAUNCHES
    adj_launches = linsolve.ADJ_KERNEL_LAUNCHES
    row_launches = linsolve.ROW_KERNEL_LAUNCHES
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
    chunks = math.ceil(GRAD_ROWS / (int(config.get("BUCKET_ROWS"))
                                    or GRAD_ROWS))
    exp_adj = chunks * (dynamics.NEUMANN_STEPS + 2)
    check(adj_launches == exp_adj, f"grad: adjoint entry launched "
          f"{adj_launches} times, expected {exp_adj}")
    worst = _hold_grads(val, grads, gold, pfx, "grad geometry", n_gold)
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"grad: non-finite d/d{k}")

    # the design-evaluator gradients on the demos' golden rows
    keys = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
    worst_design = {}
    for n in DESIGNS:
        gd = dict(np.load(os.path.join(FIX, f"golden_grad_design_{n}.npz")))
        ev = make_design_evaluator(demo_models[n], DEVICE)
        prm = {k: torch.tensor(gd[k], **kw, requires_grad=True) for k in keys}
        v = _metric(ev(**prm))
        g = dict(zip(prm, torch.autograd.grad(v.sum(), list(prm.values()))))
        for k, e in _hold_grads(v, g, gd, pfx, f"grad design {n}",
                                len(gd["Hs"])).items():
            worst_design[f"{n}.{k}"] = e

    # the adjoint entry at the main-path shape: 512 rows x 40 frequencies
    rng = np.random.default_rng(5)
    Z = impedance_systems(rng, 6, (512,), 40, torch.complex128).to(DEVICE)
    G = torch.as_tensor(rng.normal(size=(512, 40, 6))
                        + 1j * rng.normal(size=(512, 40, 6))).to(DEVICE)
    B, N = 512 * 40, 6
    _, planes = linsolve._cuda_solve(Z, G, keep_planes=True)
    Gb = torch.view_as_real(G.reshape(B, N))
    adj_planes = (planes[0], planes[1], Gb[..., 0].T.contiguous(),
                  Gb[..., 1].T.contiguous())
    xr, xi = torch.empty_like(adj_planes[2]), torch.empty_like(adj_planes[2])

    def raw():
        err = linsolve.launch(adj_planes, xr, xi, adjoint=True)
        check(err == 0, f"raw adjoint launch failed: cudaError {err}")

    Zh = Z.mH
    t = dict(
        ms=cuda_time(raw, reps=100, queue_ahead=True),
        wrapper_ms=cuda_time(lambda: linsolve._cuda_solve_adj(planes, G),
                             reps=50),
        plain_ms=cuda_time(lambda: linsolve._native_solve(Zh, G), reps=10),
        library_ms=cuda_time(lambda: torch.linalg.solve(Zh, G[..., None]),
                             reps=10))
    lam = linsolve._cuda_solve_adj(planes, G)
    ref = linsolve._native_solve(Zh, G)
    torch.cuda.synchronize()
    max_abs_err = float(torch.max(torch.abs(lam - ref)))
    check(max_abs_err == 0.0, f"adjoint entry vs _native_solve(Z.mH, G): "
          f"not bit-equal, max abs err {max_abs_err:.3e}")
    nbytes = B * (2 * N * N + 2 * N + 2 * N) * 8
    bound_bytes = nbytes / MEM_BPS * 1e3
    bound_ops = B * ge_flops(N) / PEAK_FLOPS[torch.float64] * 1e3
    t.update(max_abs_err=max_abs_err, bound_ms=max(bound_bytes, bound_ops),
             bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    res = dict(rows=GRAD_ROWS, fwd_s=fwd_s, bwd_s=bwd_s,
               rows_per_s=GRAD_ROWS / (fwd_s + bwd_s),
               bwd_over_fwd=bwd_s / fwd_s, peak_mb_per_chunk=peak_mb / chunks,
               chunks=chunks, fwd_launches=fwd_launches,
               adj_launches=adj_launches, expected_adj_launches=exp_adj,
               row_launches=row_launches,
               worst_rel=worst, worst_rel_design=worst_design, adjoint=t)
    print(f"grad {name} on {card}: {GRAD_ROWS} rows, d/d{{{', '.join(grads)}}}"
          f" of sum |Xi[0]|^2 + sum X0^2: forward {fwd_s:.2f} s, backward "
          f"{bwd_s:.2f} s ({res['bwd_over_fwd']:.2f}x) = "
          f"{res['rows_per_s']:.1f} gradient rows/s; peak memory "
          f"{res['peak_mb_per_chunk']:.0f} MiB per chunk; adjoint launches "
          f"{adj_launches} (expected {exp_adj}: {dynamics.NEUMANN_STEPS} "
          f"Neumann + 2 per chunk), forward launches {fwd_launches}; golden "
          f"rows within {max(worst.values()):.1e} x max|g| (gate "
          f"{GRAD_TOL:g}); design gradients on the demos within "
          f"{max(worst_design.values()):.1e}")
    print(f"  adjoint entry, 20,480 systems N=6 f64: kernel {t['ms']:.4f} ms,"
          f" wrapper {t['wrapper_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
          f"torch.linalg.solve {t['library_ms']:.3f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}), bit-equal to "
          "_native_solve(Z.mH, G)")
    return res


def farm_rows(gold, n, seed=FARM_SEED):
    """``n`` rows of the farm's operating traffic, the golden rows first:
    free-stream wind U over 3-25 m/s (5% at 0), the upstream unit at U
    and the downstream one at U (1 - d), d uniform over 0-0.35 (a
    Gaussian wake's deficit at 8 diameters); TI 0.05-0.20, wind heading
    -30 to 30 deg, yaw -8 to 8 deg, current 0-1 m/s from 0-360 deg, Hs
    1-12 m, Tp 4-20 s, beta 0-180 deg, gamma 0 (the IEC default)."""
    from raft_tpu_torch.api import ENV_KEYS, SEA_KEYS

    rng = np.random.default_rng(seed)
    m = n - len(gold["Hs"])
    u = rng.uniform
    U = u(3.0, 25.0, m)
    U[rng.random(m) < 0.05] = 0.0
    new = dict(wind_speed=np.stack([U, U * (1.0 - u(0.0, 0.35, m))], axis=1),
               wind_heading_deg=u(-30.0, 30.0, m), TI=u(0.05, 0.20, m),
               yaw_misalign_deg=u(-8.0, 8.0, m), current_speed=u(0.0, 1.0, m),
               current_heading_deg=u(0.0, 360.0, m),
               Hs=u(1.0, 12.0, (m, 1)), Tp=u(4.0, 20.0, (m, 1)),
               gamma=np.zeros((m, 1)), beta_deg=u(0.0, 180.0, (m, 1)))
    return {k: np.concatenate([gold[k], new[k]]) for k in ENV_KEYS + SEA_KEYS}


def _farm(name):
    """(Model, nWaves, golden dict) of a farm fixture."""
    from raft_tpu_torch.models.model import Model

    with open(os.path.join(FIX, f"design_farm_{name}.json")) as f:
        model = Model(json.load(f), base_dir=FIX)
    gold = dict(np.load(os.path.join(FIX, f"golden_farm_{name}.npz")))
    return model, gold["Hs"].shape[1], gold


def phase_farm(card, rows=FARM_ROWS):
    """The farm evaluator on the two-unit shared-mooring farm: warm-up on
    the golden rows (held), then ``rows`` operating rows with the golden
    rows first, timed per stage, the statics' network evaluations per
    chunk, the kernel's launches against the trips run, status shares;
    then the three-spar farm's golden rows (nT = 18, the library solve),
    held, untimed."""
    from raft_tpu_torch.api import FARM_OUT_KEYS, FARM_STAGES
    from raft_tpu_torch.api import make_farm_evaluator
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.physics.mooring import MooringNetwork
    from raft_tpu_torch.utils import config

    model, nW, gold = _farm("semi_wind")
    ev = make_farm_evaluator(model, nWaves=nW, device=DEVICE)
    n_gold = len(gold["Hs"])
    pfx = "on_" if config.get("FUSED") == "on" else "off_"

    def run(p, timer=None):
        return {k: v.cpu().numpy() for k, v in ev(**p, timer=timer).items()}

    t0 = time.time()
    out = run(farm_rows(gold, n_gold))
    warm_s = time.time() - t0
    worst = hold_goldens(out, {"semi_wind": np.arange(n_gold)},
                         {"semi_wind": gold}, pfx, "farm", keys=FARM_OUT_KEYS)

    p = farm_rows(gold, rows)
    timer = StageTimer()
    calls = []

    def mark(stage):
        if stage == "start":
            calls.append(ev.mooring.calls)
        elif stage == "statics":
            calls[-1] = ev.mooring.calls - calls[-1]
        timer(stage)

    linsolve.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = run(p, mark)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = linsolve.KERNEL_LAUNCHES
    row_launches = linsolve.ROW_KERNEL_LAUNCHES
    main = hold_goldens(out, {"semi_wind": np.arange(n_gold)},
                        {"semi_wind": gold}, pfx, "farm", keys=FARM_OUT_KEYS)
    for k, v in main.items():
        worst[k] = max(worst[k], v)
    for k in ("X0", "Xi", "PSD"):
        check(np.all(np.isfinite(out[k])), f"farm: non-finite {k}")
    cap = ev.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
        + max(int(ev.n_iter_extra), 0)
    chunk_rows = int(config.get("BUCKET_ROWS")) or rows
    # per chunk: the trips, the fixed point's final update and the system
    # response (N = 12, the kernel)
    exp = expected_launches(out["n_iter_drag"].max(axis=1), chunk_rows, cap,
                            min(max(1, config.get("SCAN_CHUNK")), cap),
                            fused=False)
    check(launches == exp, f"farm: solve kernel launched {launches} times, "
          f"expected {exp}")
    chunks = timer.chunks()
    check(row_launches == len(chunks), f"farm: the row design launched "
          f"{row_launches} times, expected {len(chunks)} (one system "
          f"response at N = {ev.nT} per chunk)")
    stage_ms = {s: sum(c.get(s, 0.0) for c in chunks) for s in FARM_STAGES}
    st = out["status"]
    res = dict(
        rows=rows, nT=ev.nT, wall_s=wall, evals_per_s=rows / wall,
        device_evals_per_s=rows / (sum(stage_ms.values()) / 1e3),
        warm_s=warm_s, chunks=len(chunks), stage_ms=stage_ms,
        statics_share=stage_ms["statics"] / sum(stage_ms.values()),
        newton_per_chunk=[c - 1 for c in calls],
        free_point_steps=MooringNetwork.FREE_STEPS,
        launches=launches, expected_launches=exp, row_launches=row_launches,
        n_iter_drag_max=int(out["n_iter_drag"].max()),
        status_shares=_status_shares(st),
        worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()})
    print(f"farm semi_wind on {card}: {rows} rows x 2 units (nT {ev.nT}), "
          f"{res['chunks']} chunks in {wall:.2f} s = "
          f"{res['evals_per_s']:.2f} farm-evals/s; stage ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
          + f" (statics {100 * res['statics_share']:.1f}%); statics Newton "
          f"iterations per chunk {res['newton_per_chunk']} (one network "
          f"solve each, {MooringNetwork.FREE_STEPS} free-point steps per "
          f"solve); solve kernel launches {launches} (expected {exp}: trips "
          f"+ final update at N = 6 + system response at N = 12, per "
          f"chunk), {row_launches} of them on the one-lane-per-row design "
          f"(the system responses); status shares {res['status_shares']}")
    print("  farm goldens (gate {:g} x max; status, n_iter_drag equal): "
          .format(SLICE_TOL) + ", ".join(
              f"{k} {v:.1e}" for k, v in res["worst_rel"].items()))

    model3, nW3, gold3 = _farm("spar3")
    ev3 = make_farm_evaluator(model3, nWaves=nW3, device=DEVICE)
    out3 = {k: v.cpu().numpy() for k, v in ev3(
        **{k: gold3[k] for k in p}).items()}
    res["spar3_worst_rel"] = {
        k.split(".", 1)[1]: v for k, v in hold_goldens(
            out3, {"spar3": np.arange(len(gold3["Hs"]))}, {"spar3": gold3},
            pfx, "farm", keys=FARM_OUT_KEYS).items()}
    print(f"  spar3 (3 units, nT {ev3.nT}, torch.linalg.solve) goldens: "
          + ", ".join(f"{k} {v:.1e}"
                      for k, v in res["spar3_worst_rel"].items()))
    return res, ev, p


def time_rows(Z, F, adjoint=False):
    """CUDA-event times of the one-lane-per-row design on Z (..., N, N)
    and F (..., N) of one batch shape, float64: the raw kernel on Z and F
    as they lie (no copy), the wrapper, the plain version and
    torch.linalg.solve, each solving Z x = F (Z^H x = F with
    ``adjoint``); the kernel's max abs difference from the plain
    version; and its bound, the larger of the bytes it must move (Z, F
    and x, each once) over the memory rate and its live operations over
    the FP64 peak."""
    from raft_tpu_torch.ops import linsolve

    N = Z.shape[-1]
    B = F.numel() // N
    Zb, Fb = Z.reshape(B, N, N), F.reshape(B, N)
    x = torch.empty_like(Fb)
    Zp = Z.mH if adjoint else Z

    def raw():
        err = linsolve.launch_rows(Zb, Fb, x, adjoint)
        check(err == 0, f"raw row kernel launch N={N} failed: cudaError "
              f"{err}")

    t = dict(
        N=N, systems=B, adjoint=adjoint,
        ms=cuda_time(raw, reps=100, queue_ahead=True),
        wrapper_ms=cuda_time(lambda: linsolve._cuda_solve_rows(
            Z, F, adjoint=adjoint), reps=50),
        plain_ms=cuda_time(lambda: linsolve._native_solve(Zp, F), reps=10),
        library_ms=cuda_time(lambda: torch.linalg.solve(Zp, F[..., None]),
                             reps=10),
    )
    x_k = linsolve._cuda_solve_rows(Z, F, adjoint=adjoint)
    x_p = linsolve._native_solve(Zp, F)
    nbytes = B * (2 * N * N + 2 * N + 2 * N) * 8
    flops = B * ge_flops(N, live=True)
    bound_bytes = nbytes / MEM_BPS * 1e3
    bound_ops = flops / PEAK_FLOPS[torch.float64] * 1e3
    t.update(max_abs_err=float(torch.max(torch.abs(x_k - x_p))),
             bytes=nbytes, flops=flops,
             bound_ms=max(bound_bytes, bound_ops),
             bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    return t


def sass_census(path, kernel):
    """{opcode: count} of one kernel's instructions in cuobjdump's SASS
    listing of the library at ``path`` (static: every instruction once,
    the never-taken slow paths of the divisions included), or None where
    the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    ops, on = {}, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            on = kernel in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     ln) if on else None
        if m:
            ops[m.group(2)] = ops.get(m.group(2), 0) + 1
    return ops


def phase_kernel12(rows=512, nw=40):
    """The one-lane-per-row design, forward and adjoint: against the
    plain versions at N = 7-12 on a ragged batch (25 x 41 systems),
    float64 bit-equal and float32 within F32_TOL; then at the farm's
    system response shape, rows x nw systems of N = 12 in complex128,
    both entries bit-equal, timed beside the wrapper, the plain
    version, torch.linalg.solve and the bound."""
    from raft_tpu_torch.ops import linsolve

    rng = np.random.default_rng(12)
    worst = {}
    for dtype, tol in ((torch.complex128, 0.0), (torch.complex64, F32_TOL)):
        for N in ROW_NS:
            Z = impedance_systems(rng, N, (25,), 41, dtype).to(DEVICE)
            F = torch.as_tensor(rng.normal(size=(25, 41, N)) + 1j
                                * rng.normal(size=(25, 41, N))
                                ).to(dtype).to(DEVICE)
            for adjoint in (False, True):
                x_k = linsolve._cuda_solve_rows(Z, F, adjoint=adjoint)
                x_p = linsolve._native_solve(Z.mH if adjoint else Z, F)
                torch.cuda.synchronize()
                tag = (f"kernel12 N={N} {dtype} "
                       f"{'adjoint' if adjoint else 'forward'}")
                check(bool(torch.isfinite(torch.view_as_real(x_k)).all()),
                      f"{tag}: non-finite output")
                err = float(torch.max(torch.abs(x_k - x_p)))
                scale = float(torch.max(torch.abs(x_p)))
                check(err <= tol * scale, f"{tag}: |x_k - x_p| = {err:.3e} "
                      f"> {tol:g} x {scale:.3e}")
                worst[tag] = err / scale

    Z = impedance_systems(rng, 12, (rows,), nw, torch.complex128).to(DEVICE)
    F = torch.as_tensor(rng.normal(size=(rows, nw, 12))
                        + 1j * rng.normal(size=(rows, nw, 12))).to(DEVICE)
    res = dict(checks=len(worst), worst_rel=worst)
    for entry, adjoint in (("forward", False), ("adjoint", True)):
        t = res[entry] = time_rows(Z, F, adjoint)
        check(t["max_abs_err"] == 0.0, f"kernel12 {entry} N=12: differs "
              f"from its plain version by {t['max_abs_err']:.3e}")

    # what holds it back: the raw forward per N at rows x nw systems, per
    # system against the batch at N = 12, and the SASS it issues
    def raw_us(Zr, Fr):
        B, N = Fr.shape
        x = torch.empty_like(Fr)
        return 1e3 * cuda_time(lambda: linsolve.launch_rows(
            Zr.reshape(B, N, N), Fr, x), reps=50, queue_ahead=True)

    per_n = {}
    for N in ROW_NS:
        Zn = impedance_systems(rng, N, (rows,), nw, torch.complex128)
        Fn = torch.as_tensor(rng.normal(size=(rows * nw, N))
                             + 1j * rng.normal(size=(rows * nw, N)))
        Zn, Fn = Zn.to(DEVICE).reshape(-1, N, N), Fn.to(DEVICE)
        us = raw_us(Zn, Fn)
        bound = rows * nw * (2 * N * N + 4 * N) * 8 / MEM_BPS * 1e6
        per_n[N] = dict(us=us, bound_us=bound, share=bound / us)
    Zb = Z.reshape(-1, 12, 12)
    Fb = F.reshape(-1, 12)
    scaling = {}
    for frac in (8, 1):
        B = Fb.shape[0] // frac
        scaling[B] = raw_us(Zb[:B], Fb[:B]) / B * 1e3      # ns per system
    B4 = 4 * Fb.shape[0]
    scaling[B4] = raw_us(Zb.repeat(4, 1, 1), Fb.repeat(4, 1)) / B4 * 1e3
    census = sass_census(linsolve.library_path(),
                         "ge_solve_rows_kernelIdLi12ELb0E")
    res.update(per_n=per_n, ns_per_system=scaling, sass_n12_f64_fwd=census)
    print(f"kernel12: {len(worst)} comparisons of the row design at N = "
          f"7-12 within tolerance (f64 bit-equal, f32 {F32_TOL:g} x "
          f"max|x|), forward and adjoint")
    for entry in ("forward", "adjoint"):
        t = res[entry]
        print(f"  {entry}, {t['systems']:,} systems N=12 f64: kernel "
              f"{t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, torch.linalg.solve "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%} of it), "
              f"bit-equal")
    print("  raw forward at 20,480 systems: " + ", ".join(
        f"N={n} {v['us']:.2f} us ({v['share']:.1%} of its byte bound)"
        for n, v in per_n.items()) + "; N=12 ns per system at " + ", ".join(
        f"{b:,} systems {v:.3f}" for b, v in scaling.items()))
    if census:
        dp = sum(v for k, v in census.items() if k in ("DADD", "DMUL",
                                                      "DFMA"))
        print(f"  SASS of the N=12 f64 forward (static): "
              f"{sum(census.values())} instructions, {dp} FP64, "
              f"{census.get('SHFL', 0)} SHFL, "
              f"{census.get('LDS', 0)} LDS, {census.get('STS', 0)} STS, "
              f"{census.get('BRA', 0)} BRA per warp (two systems)")
    else:
        print("  SASS census: no cuobjdump (not measured)")
    return res


def _device_profile(fn):
    """(wall ms, device busy ms, runtime kernel launches, device events)
    of one call of ``fn`` under torch.profiler with the CUDA activity
    alone, read from the profiler's raw events: ``key_averages`` builds
    one Python object per event, too slow for the millions of launches
    of a farm chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    busy_ns = launches = device_events = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            device_events += 1
        elif e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return wall_ms, busy_ns / 1e6, launches, device_events


def phase_profile_farm(ev, p, rows=512):
    """torch.profiler over one ``rows``-row chunk of the farm: runtime
    kernel launches, device events, busy time and idle share."""
    q = {k: v[:rows] for k, v in p.items()}
    wall, busy, launches, events = _device_profile(lambda: ev(**q))
    res = dict(wall_ms=wall, busy_ms=busy, kernel_launches=launches,
               device_events=events,
               idle_share=(1.0 - busy / wall) if wall else None)
    if busy > 0:
        print(f"profile_farm: one {rows}-row farm chunk: {launches} kernel "
              f"launches, {events} device events, device busy {busy:.1f} ms "
              f"of {wall:.1f} ms (under the profiler), idle share "
              f"{res['idle_share']:.3f}")
    else:
        print("profile_farm: the profiler recorded no device time "
              "(not measured)")
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
        from raft_tpu_torch.models.model import Model
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    rec = {"phase_s": {}}
    t_start = time.time()

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        rec["phase_s"][name] = time.time() - t0
        return out

    try:
        rec["card"] = timed("device", phase_device)
        rec["build"] = timed("build", phase_build, args.out)
        rec["kernel"] = timed("kernel", phase_kernel)
        rec["builder"], models, packed = timed("builder", phase_builder)
        rec["slice"] = timed("slice", phase_slice, packed,
                             args.rows_per_design, rec["card"])
        rec["design"] = timed("design", phase_design, models,
                              args.rows_per_design, rec["card"])
        rec["catenary"] = timed("catenary", phase_catenary)
        rec["profile"] = timed("profile", phase_profile, args.out)
        rotor_models = {}
        for n in FULL_CONFIGS:
            with open(os.path.join(FIX, f"design_{n}.json")) as f:
                rotor_models[n] = Model(json.load(f))
        rec["full"], evs = timed("full", phase_full, rotor_models,
                                 FULL_ROWS, rec["card"])
        rec["bemt"] = timed("bemt", phase_bemt, evs["semi_wind"])
        rec["staged_solve"] = timed("staged_solve", phase_staged_solve)
        rec["profile_full"] = timed("profile_full", phase_profile_full,
                                    args.out, evs["semi_wind"])
        rec["geometry"], geo_ev = timed("geometry", phase_geometry,
                                        rotor_models[GEOMETRY_DESIGN],
                                        rec["card"])
        rec["grad"] = timed("grad", phase_grad, geo_ev, models, rec["card"])
        rec["farm"], farm_ev, farm_p = timed("farm", phase_farm, rec["card"])
        rec["kernel12"] = timed("kernel12", phase_kernel12)
        rec["profile_farm"] = timed("profile_farm", phase_profile_farm,
                                    farm_ev, farm_p)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k = rec["kernel"]
    a = rec["grad"]["adjoint"]
    rec["launches_by_path"] = dict(
        slice=rec["slice"]["launches"], design=rec["design"]["launches"],
        **{f"full_{n}": r["launches"] for n, r in rec["full"].items()},
        geometry=rec["geometry"]["launches"],
        grad=rec["grad"]["fwd_launches"],
        grad_adjoint=rec["grad"]["adj_launches"],
        farm=rec["farm"]["launches"])
    k12 = rec["kernel12"]["forward"]
    a12 = rec["kernel12"]["adjoint"]
    kernels = [dict(
        name="ge_solve", route="cuda",
        source="raft_tpu_torch/csrc/linsolve.cu",
        replaces="raft_tpu/ops/linsolve.py:277",
        launches=(rec["slice"]["launches"] + rec["design"]["launches"]
                  + sum(r["launches"] for r in rec["full"].values())
                  + rec["geometry"]["launches"]
                  + rec["grad"]["fwd_launches"] + rec["farm"]["launches"]),
        max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=k["library_ms"],
        n12_ms=k12["ms"], n12_wrapper_ms=k12["wrapper_ms"],
        n12_plain_ms=k12["plain_ms"], n12_bound_ms=k12["bound_ms"],
        n12_library_ms=k12["library_ms"],
        n12_max_abs_err=k12["max_abs_err"],
        n12_launches=rec["farm"]["row_launches"]), dict(
        name="ge_solve_adj", route="cuda",
        source="raft_tpu_torch/csrc/linsolve.cu",
        replaces="raft_tpu/ops/linsolve.py:277",
        launches=rec["grad"]["adj_launches"],
        max_abs_err=a["max_abs_err"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=a["library_ms"],
        n12_ms=a12["ms"], n12_wrapper_ms=a12["wrapper_ms"],
        n12_plain_ms=a12["plain_ms"], n12_bound_ms=a12["bound_ms"],
        n12_library_ms=a12["library_ms"],
        n12_max_abs_err=a12["max_abs_err"],
        n12_launches=rec["grad"]["row_launches"])]
    rec["build"].pop("ptxas")
    rec["total_s"] = time.time() - t_start
    print(f"phases: {rec['total_s']:.1f} s in all; " + ", ".join(
        f"{n} {t:.1f}" for n, t in rec["phase_s"].items()))
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
