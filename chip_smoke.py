"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--rows-per-design 1024] [--out DIR]

Phases, each printing one line (the last line is the result object):

1. device  - the card's name and power limit (nvidia-smi); TF32 off;
             the host's CPU model and microseconds per kernel launch.
2. build   - nvcc builds raft_tpu_torch/csrc/linsolve.cu for sm_90a
             afresh, while g++ builds the host panel solver
             raft_tpu_torch/csrc/panel_bem.cpp; the -Xptxas -v report goes to
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
8. profile - torch.profiler (the CUDA activity, raw events) over one
             512-row chunk: device busy time, idle share, kernel
             launches (top kernels to <out>/profile_top.txt).
9. full    - the full-physics evaluator (make_full_evaluator, float64,
             default flags) on the two rotor designs: semi_wind (one wave
             heading) and mhk_tidal (two), FULL_ROWS (1024) rows each
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
11. profile_full - torch.profiler (the CUDA activity, raw events) over
             one 512-row semi_wind chunk of the full path: kernel
             launches and device busy time of the aero stage alone and
             of the whole chunk, idle share (top kernels to
             <out>/profile_full_top.txt).
12. geometry - the geometry design axis: make_full_evaluator(...,
             geometry=True) on design_semi_wind.json over GEOMETRY_ROWS
             (1024) rows in 512-row chunks, the full phase's operating rows
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
14. kernel12 - the one-lane-per-row design (N = 7-12), forward and
             adjoint, against its plain versions _native_solve(Z, F) and
             _native_solve(Z.mH, G) at N = 7-12 on a ragged batch
             (float64 bit-equal, float32 within F32_TOL); then at the
             farm's system-response shape (512 rows x 40 frequencies =
             20,480 systems of N = 12, complex128), for each entry, the
             raw kernel's time on Z and F as they lie, the wrapper's, the
             plain version's, torch.linalg.solve's and the bound.
15. farm    - the farm evaluator (make_farm_evaluator, float64) on
             design_farm_semi_wind.json, two units with their own
             catenaries and a shared line over a free buoy (nT = 12):
             warm-up on the golden rows alone (in forward and reverse
             mode: one jvp, its tangent held against
             golden_jvp_farm_semi_wind.npz, and the gradient of the
             response metric at the gradient golden's rows, reported by
             grad_paths), then FARM_ROWS (512)
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
16. profile_farm - torch.profiler (the CUDA activity, raw events) over
             one network evaluation of the farm's mooring (what each
             statics Newton iteration of a chunk runs) at the farm
             phase's 512 equilibrium poses: kernel launches, device busy
             time, idle share.
17. flex    - the flexible evaluator (make_flexible_evaluator, float64)
             on design_semi_wind_flex.json (the semi_wind rotor on a
             steel beam tower, nDOF 168): warm-up on the golden rows
             (held against golden_flex_semi_wind.npz), then FLEX_ROWS
             (1024) rows of the full phase's semi_wind operating table
             with the golden rows first, in chunks of the evaluator's
             FLEX_ROWS; flex-evals/s, stage ms (aero, statics,
             kinematics, excitation, fixed_point, response), Newton
             iterations and peak device memory per chunk, status
             shares, the torch.linalg.solve share of the fixed point
             and its FLOP rate (LU and substitution),
             and no launch of either solve-kernel design (N > 12 goes to
             the library, as in the reference).  The keys past the
             N-DOF solves are held at kappa eps (FLEX_KAPPA_K for X0,
             FLEX_KAPPA_Z for Xi, PSD, drag_resid).
    flex_geometry - the flexible geometry axis: the golden rows of
             golden_flex_geometry_semi_wind.npz (three rebuilt tower
             designs, held), then FLEX_GEOMETRY_DESIGNS (8) host-rebuilt
             designs (tower d and t each scaled over 0.9-1.1) x
             FLEX_GEOMETRY_ROWS (64) operating rows through
             geometry=True, with the golden rows first; host build s per
             design, geometry-evals/s, stage ms.
18. bem     - potential flow on design_semi_wind_bem.json (semi_wind
             with every platform member meshed: 684 panels, 25 BEM
             frequencies, 8 headings, 200 m deep): the port's run_bem
             solves on the host (g++-built csrc/panel_bem.cpp, the
             shipped Green table) into a fresh cache under <out>, in a
             thread started before the farm phase, beside the phases up
             to this one (the design's solve and the d_scale axis' two,
             on BEM_HOST_THREADS threads); its raw
             A/B/X and its model-grid coefficients after the .1/.3 round
             trip held against golden_bem_semi_wind.npz within
             BEM_COEF_TOL (1e-10) x max; host seconds of the table load,
             the build and the solve.  Then make_full_evaluator (float64,
             default flags) on the golden rows (held) and BEM_ROWS (1024)
             semi_wind operating rows with them first: full-evals/s,
             stage ms, Newton iterations per chunk, the solve kernel's
             launches against the trips run; the WAMIT-file design
             (design_semi_wind_wamit.json) on its golden rows (held);
             the d_scale geometry axis: its two extra host solves served
             from that cache, the golden d_scale rows (held), then BEM_GEOMETRY_ROWS (1024)
             rows with d_scale uniform over D_SCALE_BOX, geometry-evals/s,
             launches against the trips run.
    grad_paths - reverse mode through every other evaluator, on golden
             rows held against the jax.grad goldens by the CPU tests'
             gate (tests/test_torch_grad.py hold_grads: 1e-9 x each
             key's max|g|; the flexible path at 1e-7, the gate of
             tests/test_torch_grad_flex.py): the full
             evaluator's aero inputs on the full phase's semi_wind and
             mhk_tidal evaluators (golden_grad_aero_*.npz: the response
             metric by every row input, sum |f_aero|^2 by the rotor
             speeds, TI and yaw); d_scale and the rows through the bem
             phase's geometry evaluator, its off-unit panel solves
             reused (golden_grad_bem_semi_wind.npz); the farm's every
             row input on the farm phase's warm-up call (its golden
             rows, one chunk: the coupled statics' launch storm is paid
             once), held at golden_grad_farm_semi_wind.npz's two rows,
             with the adjoint launches of its backward per entry, the
             N = 12 one (the system response's, on the one-lane-per-row
             design) against the count the code gives; semi_wind_flex's
             rows and its struct_params leaves
             (golden_grad_flex_semi_wind.npz).  Per path: gradient
             rows/s, backward/forward time, peak memory of the chunk.
    fwd     - forward mode (torch.func.jvp and jacfwd) through every
             evaluator on golden rows, held by the gates of
             tests/test_torch_fwd.py (each float key's tangent within
             1e-9 x its max|tangent|, the flexible path 1e-7; every
             output under the transform within 1e-10 x max of the plain
             call, the flexible keys past its solves at their kappa
             eps, status and n_iter_drag equal; bit-equal on the CPU):
             jacfwd of the response metric by the six inputs of the
             demos' design evaluators (golden_grad_design_*.npz); both
             directions of golden_jvp_{geometry_semi_wind,aero_semi_wind,
             aero_mhk_tidal,bem_semi_wind,flex_semi_wind}.npz at once
             (torch.func.vmap over jvp) on the geometry, full and bem
             phases' evaluators (the panel solves reused) and
             semi_wind_flex by its rows and struct_params.  Per path
             forward-mode s over the plain forward's, and the forward
             entry's launches: the plain call's plus the tangent work
             the code makes (per chunk the differentiable update at the
             fixed point and its tangent, NEUMANN_STEPS Neumann tangent
             solves, the final update's tangent, a staged response's
             tangent), the same for jacfwd's six directions as for one.
             The farm's forward mode rides on the farm phase's warm-up:
             one jvp over its golden rows, which require grad, gives the
             primal (held), the tangent (golden_jvp_farm_semi_wind.npz)
             and the reverse gradient (grad_paths), its forward launches
             counted against the trips and the tangent work.
19. qtf     - second-order forces: make_full_evaluator on
             design_semi_wind_qtf.json (semi_wind with the external QTF
             semi_wind_qtf.12d): the golden rows (held against
             golden_semi_wind_qtf.npz), then QTF_ROWS (1024) semi_wind
             operating rows with them first: full-evals/s, stage ms with
             the second_order stage (the QTF forces) and the drift stage
             (the second equilibrium under the mean drift), Newton iterations per chunk of both equilibria, the
             solve kernel's launches against the trips run (the drift
             launches none); the two-heading golden rows; the geometry
             axis' golden rows and QTF_GEOMETRY_ROWS (1024) rows; the
             slender-body QTF of design_semi_wind_slender.json at its
             40-bin grid, fixed and RAO-driven, held against
             golden_qtf_slender.npz; the slender-body QTF on
             SLOW_DRIFT_GRID (200 bins, 20,100 pairs): member_qtf's device
             ms over all members (CUDA events), the pair chunk and peak
             memory, kim_yue_correction's host s, the same bits at two
             chunk sizes, hermitian off the diagonal.
20. analyze - the orchestrated path: each of ORCH_SETS' 13 designs (the
             three demos, semi_wind with a 4-case table, mhk_tidal with
             and without cpmin polars, semi_wind_flex, the first case of
             the two-unit farm's 2-case table through run_farm, the
             WAMIT-file design, the external and slender-body QTF
             designs, semi_wind with moorMod 1 and 2) through drivers.run
             on the card, held against golden_orch_*.npz by the CPU
             tests' own gates (imported from
             tests/test_torch_orchestrated.py: case metrics, mean
             offsets, status words, drag diagnostics, the CSV;
             calc_outputs' properties and eigen);
             per design cases/s, the per-case wall split (statics,
             dynamics with second-order forces and line dynamics,
             outputs), Newton iterations and the solve kernel's launches
             on the path against the fixed-point solves run (each FOWT's
             trips plus its final solve at N <= 12, plus the system
             response at N <= 12); one `python -m raft_tpu_torch
             design_spar.json --csv` run on the card beside the designs,
             its CSV held; the
             kernel on the captured system responses (Z, F) of the spar
             (N = 6, the thread-per-system entry) and the farm (N = 12,
             the lane-per-row entry) bit-equal to its plain version.
21. omdao  - the design-optimisation surface: DesignEvaluation on the
             card for OMDAO_SETS (the spar: first call, a repeat that
             hits the result cache, the mooring-length override, then
             use_traced=False; semi_wind; semi_wind at moorMod 1;
             semi_wind_flex), each held against golden_omdao_*.npz by
             the gates of tests/test_torch_omdao.py (imported by path),
             its route (full, flexible or host) the reference's, its
             result cache's counters equal; the solve kernel's launches
             per call against the evaluator's trips, analyze_cases'
             fixed-point solves or none (N = 168), 0 and no evaluator
             call on every repeat; per set the wall s of each call.
             Then RAFT_OMDAO_Core on weis_semi_wind.json (build_design
             exactly the reference's, compute held, its launches
             counted) and the spar's catenary polylines of
             plotting._catenary_points held against
             golden_omdao_plotting.npz.
22. sweep   - checkpointed, fault-tolerant sweeps: the full phase's
             semi_wind evaluator through run_sweep_checkpointed_full
             over SWEEP_ROWS (2048) seeded rows in shards of
             SWEEP_SHARD (512), with status among the out keys, on the
             mesh resolve_mesh gives after its health probe (one card),
             held against the plain evaluator call on the same rows
             (bits, else 1e-10 x max; status equal) and its launches
             against the trips; the same sweep crashed by an injected
             truncation of shard 2 and resumed (bit-identical to the
             uninterrupted sweep, only the truncated shard recomputed);
             a shard under an injected transient fault (retried) and one
             under an injected OOM (halved); sweep_cases of the three
             demos over the two-entry mesh [cuda:0, cuda:0], bit-equal
             to a one-entry mesh; a twin of a CPU-built evaluator on the
             card, bit-equal to the card's own; qtf_slender_sharded at
             SLOW_DRIFT_GRID over the two-entry mesh against
             Model.qtf_slender (1e-10 x max).  Rows/s of the
             checkpointed sweep against the plain call's, shard write
             and resume s, launches.
23. fabric  - the elastic sweep fabric on the card: the port's
             demo_entry (spar, case evaluator, FABRIC_ROWS (512) seeded
             rows in shards of FABRIC_SHARD (128), keys PSD, X0, status,
             n_iter_drag) through run_fabric with FABRIC_WORKERS (2)
             worker processes, both on cuda:0, held bit-identical to the
             same entry's serial run_checkpointed in this process; then
             with RAFT_TPU_FAULTS=worker_kill:worker_shard forwarded to
             worker 0, which is SIGKILLed at its first claim (a worker's
             first shard takes seconds, so worker 0 claims one before
             worker 1 is done): the dead worker's lease expires after
             FABRIC_TTL_S and is stolen, the sweep assembled
             bit-identical; the first run under RAFT_TPU_RUNS_DIR
             writes its run record, and `python -m raft_tpu_torch.obs
             runs list` and `obs trace --merge <its log dir> --check`
             exit 0.  The killed run carries the entry's AOT warm-up
             spec (one shard's worth of the spar case program) under
             RAFT_TPU_AOT=load into a fresh bank the two workers share:
             each worker warms before its first claim, loading or
             building the one program and launching the kernel as many
             times as the same rows in this process.  The workers'
             kernel ledgers (metrics.json `programs`) give the phase's
             launches (the killed run's: the serial sweep's plus the
             surviving worker's warm-up); every worker's exit code is
             checked.  Worker start-up s and first-shard wall, cold and
             warmed, rows/s against the serial sweep's.
24. serve   - one serving process in this process on cuda:0: the spar
             and semi demos registered, the batch ladder SERVE_LADDER
             (1,4,16) through RAFT_TPU_SERVE_LADDER, every (signature x
             rung) warmed, the asyncio HTTP server on a loopback port in
             a thread of its own; SERVE_CLIENTS (8) client threads x
             SERVE_REQS (8) requests over real sockets, mixed across the
             two designs from a small pool of cases (repeats give
             in-flight joins and cache hits), one of them asking for
             escalate_f64, one an out_keys subset, one an inline design
             (the mhk demo's dict); then POST /drain from loopback.
             Every accepted request answered, no 5xx; every served row
             bit-equal to a direct BucketEvaluator call on the padded
             group the batcher recorded, status equal; the solve
             kernel's launches in the run equal to the dispatches'
             (trips + 1 each, from the direct calls' n_iter_drag) and
             to their sum; the JAX serving engine's golden_serve_*.npz
             groups at rungs 1, 4, 16 dispatched on the card within
             SLICE_TOL x max, status equal, the shared first case's
             difference across rungs recorded.  p50 / p95 request
             latency, rows/s, batch
             occupancy, the stage split (mean s per stage), the launches
             and the phase's wall beside its SERVE_BUDGET_S (45 s).  The
             server warms under RAFT_TPU_AOT=load into a fresh bank:
             every (signature x rung) program built and stored, and
             every design's provenance stamp names its entry's payload
             sha (bank_sha not none).
25. aot     - the program bank, its warm-up and its releases: `python -m
             raft_tpu_torch.aot warmup --kinds serve,cases` in a child
             process into a fresh bank (the spar serve program at rung
             AOT_RUNG (4), its case program at AOT_ROWS (8) rows: two
             entries, one payload, the kernel library); meanwhile the
             same calls in this process, the bank off.  Releases: cut +
             promote A, cut + promote B (parent A), verify B against the
             bank, roll back to A; a tampered copy of A's manifest
             refused by `release verify --manifest`.  Then, side by
             side: a child under RAFT_TPU_AOT=require and
             COMPILE_BUDGET=0 (tests/_torch_aot_child.py, started up
             beside the warm-up and waiting for a go file before its
             first program) that loads both programs and the bank's
             copy of the library, builds nothing, runs no nvcc, and
             answers bit-equal to this process's calls; a `python -m
             raft_tpu_torch.serve` under
             require and RAFT_TPU_FUSED=off that prints the release and
             exits 3 with the preflight diagnosis naming `flags`.  The
             children's launches are the phase's, each equal to this
             process's same calls; the phase's wall beside its
             AOT_BUDGET_S (45 s).
26. fleet   - the serving fleet on the card: one program bank for the
             spar and semi demos at ladder FLEET_LADDER (1,4) warmed in
             this process, release A cut and promoted; two replica
             processes (`python -m raft_tpu_torch.serve --fleet-dir`, by
             fleet.spawn_replica) on cuda:0 under RAFT_TPU_AOT=require,
             each one's start-up (process start to its lease) and what
             it built and ran nvcc for (0, 0) printed; the router in
             this process.  The replica given replica_kill (index 1,
             RAFT_TPU_FLEET_FAULT_REPLICA) gets an id that owns neither
             demo on the ring, only the spar design posted inline.  (b)
             FLEET_CLIENTS (4) x FLEET_REQS (8) requests through the
             router from FLEET_POOL (4) cases per demo of the serve
             phase's pool, every answer within SLICE_TOL x max of a
             direct rung-1 call in this process, status equal; router
             p50 / p95 beside the serve phase's, its overhead a request
             (router_request less router_upstream).  (c) the inline
             spar request kills the armed replica mid-request: 0
             dropped, the failovers counted, its lease expired and
             evicted, its flight dump read.  (d) the router's canary on
             the survivor, release B cut and rolled out: the survivor
             replaced by --takeover under the canary gate
             (rollout_done ok), its ring keys unmoved, the canary's
             checks all ok across the old and the new process.  The
             survivor's launches from its kernel ledger equal the trips
             + 1 of its dispatches, rebuilt from its trace shard (each
             request carries a traceparent of its own); the phase's
             wall beside FLEET_BUDGET_S (100 s).
27. analysis - the op contracts on the card
             (raft_tpu_torch/analysis/contracts.py): the seven entries
             of `python -m raft_tpu_torch.analysis contracts` once each
             on the spar demo on cuda:0 (float64, FUSED on), their aten
             ops beside the CPU baseline (op_baseline.json), the solve
             kernel's launches (one per raft.solve), host syncs and
             host-to-card copies: the per-entry launch table.  The
             bucket evaluator and the case evaluator in float64 and
             float32 are held: aten ops, host syncs and trips equal to
             the same call's on the CPU in this process (this torch),
             those within op_baseline.json's budget slack (it was
             recorded with another torch), launches = trips + 1, the
             structure, stop-test and float32-trip contracts, a repeat
             call that builds nothing, runs nvcc no time and runs the
             same ops and launches, outputs against the CPU's (float64
             within SLICE_TOL x max with status, n_iter_drag and
             drag_converged equal; float32 within ANALYSIS_F32_TOL);
             the phase's wall beside ANALYSIS_BUDGET_S (30 s).
28. kernels - one JSON object listing both entries of the solve kernel,
             the forward with its launches on every path (the analyze,
             omdao, sweep, fabric, serve, aot, fleet and analysis paths'
             also as analyze_launches, omdao_launches, sweep_launches,
             fabric_launches, serve_launches, aot_launches,
             fleet_launches and analysis_launches) and the adjoint
             with its launches on the grad and grad_paths paths, each
             with its N = 12 (one-lane-per-row) figures (the adjoint's
             from the farm's backward).

Exits non-zero, before printing any result, without CUDA, outside the
repository, or when any phase misses its tolerance.  Measurements go to
<out>/chip_smoke.json as well.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import platform
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures", "torch_port")
DESIGNS = ("spar", "semi", "mhk")
#: the design evaluator's row inputs
DESIGN_KEYS = ("Hs", "Tp", "beta", "Cd_scale", "Ca_scale", "L_moor_scale")
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
FULL_ROWS = 1024                       # rows per rotor design, full phase
#: the geometry phase's design, rows and seed; its box of geometry scales
GEOMETRY_DESIGN = "semi_wind"
GEOMETRY_ROWS = 1024
GEOMETRY_SEED = 20261022
GEOM_BOX = dict(d_scale=(0.9, 1.1), t_scale=(0.9, 1.1),
                fill_scale=(0.8, 1.2), rho_fill_scale=(0.9, 1.1),
                Cd_scale=(0.5, 2.0), Ca_scale=(0.5, 1.5),
                L_moor_scale=(0.98, 1.02), EA_moor_scale=(0.8, 1.2))
GRAD_ROWS = 512                        # rows of the grad phase (one chunk)
#: the grad_paths phase's aero golden sets
GRAD_AERO_SETS = ("semi_wind", "mhk_tidal")
FARM_ROWS = 512                        # rows of the farm phase (1 chunk)
FARM_SEED = 20261023
FLEX_DESIGN = "semi_wind"
FLEX_ROWS = 1024                       # rows of the flex phase
FLEX_SEED = 20261024
FLEX_GEOMETRY_DESIGNS = 8              # host-rebuilt tower designs
FLEX_GEOMETRY_ROWS = 64                # operating rows per design
FLEX_GEOMETRY_SEED = 20261025
#: the potential-flow phase: rows of the evaluator and of its d_scale
#: geometry axis (uniform over D_SCALE_BOX), their seeds, and the gate of
#: the host solve's coefficients against the JAX goldens
BEM_ROWS = 1024
BEM_SEED = 20261026
BEM_GEOMETRY_ROWS = 1024
BEM_GEOMETRY_SEED = 20261027
D_SCALE_BOX = (0.92, 1.08)
BEM_COEF_TOL = 1e-10
#: the threads of the host panel solves, which run beside the phases
#: from farm to flex: the cores less two (the script's and the CUDA
#: driver's), at most 8
BEM_HOST_THREADS = min(8, max(1, (os.cpu_count() or 3) - 2))
#: the flexible path's gates past its N = 108-168 solves (pivoted LU of
#: two libraries, tests/test_torch_flexible.py): X0 at kappa(K) eps and
#: Xi, PSD and drag_resid at kappa(Z) eps, with the largest condition
#: numbers of the statics stiffness and of the response impedance over
#: the golden rows
FLEX_KAPPA_K = 2.80e9
FLEX_KAPPA_Z = 2.72e10
#: the second-order phase: operating rows of the external-QTF design and
#: of its geometry axis, their seeds; the slow-drift grid of the
#: slender-body QTF [Hz] (200 bins, 20,100 pairs)
QTF_ROWS = 1024
QTF_SEED = 20261028
QTF_GEOMETRY_ROWS = 1024
QTF_GEOMETRY_SEED = 20261029
SWEEP_ROWS = 2048                      # rows of the checkpointed sweep
SWEEP_SHARD = 512
SWEEP_SEED = 20261030
SWEEP_CASE_ROWS = 1024                 # sea states per demo, two-entry mesh
SLOW_DRIFT_GRID = dict(min_freq2nd=0.00125, df_freq2nd=0.00125,
                       max_freq2nd=0.25)
#: the fabric phase: the spar demo entry's rows, its shards, their seed,
#: the workers of its first run and the lease TTL of its killed-worker
#: run [s]
FABRIC_ROWS = 512
FABRIC_SHARD = 128
FABRIC_SEED = 20261031
FABRIC_WORKERS = 2
FABRIC_TTL_S = 3.0
#: the serve phase: its batch ladder, client threads, requests per
#: client, the seed of the case pool, the pool's cases per design and
#: the phase's wall budget [s]
SERVE_LADDER = "1,4,16"
SERVE_CLIENTS = 8
SERVE_REQS = 8
SERVE_SEED = 20261102
SERVE_POOL = 12
SERVE_BUDGET_S = 45.0
#: the aot phase: the spar case program's rows, the serve program's rung
#: and the phase's wall budget [s]
AOT_ROWS = 8
AOT_RUNG = 4
AOT_BUDGET_S = 45.0
FLEET_LADDER = "1,4"
FLEET_CLIENTS = 4
FLEET_REQS = 8
FLEET_POOL = 4                         # cases per demo from the serve pool
FLEET_TTL_S = 2.0
FLEET_BUDGET_S = 100.0                # three replica start-ups, 26-32 s each
ANALYSIS_BUDGET_S = 30.0
ANALYSIS_F32_TOL = 1e-3                # x max|x|, float32 card vs CPU
BUILD_TOL = 1e-12                      # x each packed leaf's max
EXACT = ("status", "n_iter_drag", "drag_converged")
DEVICE = "cuda"


#: processes a phase starts to run beside its own work: stopped on the
#: way out, whatever the outcome
CHILDREN = []


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


def host_speed(n=20_000):
    """The host's CPU model and core count, and the wall microseconds
    per launch of a one-element add on the card, ``n`` launches
    synchronized: the launch-bound phases move with it, so a script's
    time is read beside it (hosts differ)."""
    model = platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    x = torch.zeros(1, device=DEVICE)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return model, os.cpu_count(), (time.perf_counter() - t0) / n * 1e6


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
    cpu, cores, us = host_speed()
    print(f"host: {cpu}, {cores} cores; {us:.2f} us per launch of a "
          "one-element add (20,000 launches, synchronized)")
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
    import threading

    from raft_tpu_torch import native
    from raft_tpu_torch.ops import linsolve

    # g++ builds the host panel solver while nvcc builds the kernel
    host = {}

    def gxx():
        t = time.time()
        try:
            host["path"] = native.build(force=True)
        except RuntimeError as e:
            host["error"] = str(e)
        host["s"] = time.time() - t

    th = threading.Thread(target=gxx)
    th.start()
    t0 = time.time()
    path, report = linsolve.build(force=True)
    dt = time.time() - t0
    th.join()
    check("error" not in host, f"build: {host.get('error')}")
    print(f"build: {os.path.relpath(host['path'], HERE)} (g++, host panel "
          f"solver) in {host['s']:.1f} s")
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
    return dict(build_s=dt, gxx_s=host["s"], ptxas=report,
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


def hold_goldens(out, where, gold, pfx, tag, keys=None, tols=None):
    """Rows ``where[name]`` of ``out`` against ``gold[name]``'s keys with
    prefix ``pfx`` (``keys``, default the bucket path's): floats within
    SLICE_TOL (or ``tols[key]``) x each key's max, the status word,
    iteration counts and convergence flags exactly.  Returns the worst
    relative error per design.key."""
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
            tol = (tols or {}).get(k, SLICE_TOL)
            check(err <= tol * scale,
                  f"{tag} {n} {k}: {err:.3e} > {tol:g} x {scale:.3e}")
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


def _device_profile(fn, by_kernel=False):
    """torch.profiler with the CUDA activity alone over one call of
    ``fn``, read from the profiler's raw events (``key_averages`` builds
    one Python object per event and takes tens of seconds over a chunk's
    launches): dict of the wall ms, the device busy ms (the device
    events' durations summed: one stream), the runtime's kernel
    launches, the device events and, with ``by_kernel``, {kernel name:
    [device ms, calls]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    busy_ns = launches = device_events = 0
    kernels = {} if by_kernel else None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            device_events += 1
            if by_kernel:
                k = kernels.setdefault(e.name(), [0.0, 0])
                k[0] += e.duration_ns() / 1e6
                k[1] += 1
        elif e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return dict(wall_ms=wall_ms, busy_ms=busy_ns / 1e6,
                kernel_launches=launches, device_events=device_events,
                idle_share=(1.0 - busy_ns / 1e6 / wall_ms) if wall_ms
                else None, kernels=kernels)


def _write_top(path, kernels, n=25):
    """The ``n`` kernels of most device time, from a by-kernel
    :func:`_device_profile`, as a table; returns them sorted."""
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    with open(path, "w") as f:
        f.write(f"{'device ms':>10} {'calls':>8} {'us/call':>9}  kernel\n")
        for name, (ms, calls) in top[:n]:
            f.write(f"{ms:10.3f} {calls:8d} {1e3 * ms / calls:9.2f}  "
                    f"{name[:160]}\n")
    return top


def phase_profile(out_dir, name="mhk", rows=512):
    """torch.profiler over one chunk of the bucket path: the device's
    busy time (sum of kernel self times on the one stream) against the
    chunk's wall time, and the number of kernel launches."""
    from raft_tpu_torch.structure import bucketing as bk

    p = bk.load_packed(os.path.join(FIX, f"packed_{name}.npz"))
    g = np.load(os.path.join(FIX, f"golden_{name}.npz"))
    take = np.arange(rows) % len(g["Hs"])
    d = bk.packed_from_numpy(bk.stack_packed([p.leaves] * rows), DEVICE)
    ev = bk.BucketEvaluator(p.sig, DEVICE)
    args = [torch.as_tensor(g[k][take]) for k in ("Hs", "Tp", "beta")]
    with torch.no_grad():
        ev(d, *args)
        prof = _device_profile(lambda: ev(d, *args), by_kernel=True)
    top = _write_top(os.path.join(out_dir, "profile_top.txt"),
                     prof["kernels"])
    ge = [v for k, v in top if "ge_solve_kernel" in k]
    ge_us = 1e3 * sum(ms for ms, _ in ge) / max(sum(c for _, c in ge), 1)
    res = dict(design=name, rows=rows, wall_ms=prof["wall_ms"],
               busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
               kernel_launches=prof["kernel_launches"], ge_solve_us=ge_us,
               top=[(k, ms, c) for k, (ms, c) in top[:5]])
    if res["busy_ms"] > 0:
        print(f"profile: one {rows}-row {name} chunk: wall "
              f"{res['wall_ms']:.1f} ms (under the profiler), device busy "
              f"{res['busy_ms']:.1f} ms, idle share {res['idle_share']:.3f}, "
              f"{res['kernel_launches']} kernel launches; ge_solve_kernel "
              f"{ge_us:.2f} us per launch")
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
    Newton iteration, the last of them at the returned pose; one more
    where a row hits the iteration cap) while installed, and splits them
    per chunk at the timer's "start" and "statics" marks."""

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
        newton = list(moor.per_chunk)
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


def phase_profile_full(out_dir, ev, rows=512):
    """torch.profiler over the aero stage alone and over one whole
    ``rows``-row semi_wind chunk of the full path."""
    gold = dict(np.load(os.path.join(FIX, "golden_full_semi_wind.npz")))
    p = full_rows("semi_wind", gold, rows, FULL_CONFIGS["semi_wind"]["seed"])
    kw = dict(dtype=torch.float64, device=DEVICE)
    pt = {k: torch.as_tensor(v, **kw) for k, v in p.items()}
    with torch.no_grad():
        ev(**p)
        aero = _device_profile(lambda: ev._aero(pt, rows))
        whole = _device_profile(lambda: ev(**p), by_kernel=True)
    _write_top(os.path.join(out_dir, "profile_full_top.txt"),
               whole["kernels"])
    keep = ("wall_ms", "busy_ms", "kernel_launches", "idle_share")
    res = {tag: {k: r[k] for k in keep}
           for tag, r in (("aero", aero), ("chunk", whole))}
    if whole["busy_ms"] > 0:
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
    newton = list(moor.per_chunk)
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
    return _test_module("test_torch_grad").metric(out)


def _hold_grads(val, grads, gold, pfx, tag, n, **tols):
    """The first ``n`` rows' metric and gradients held by the CPU tests'
    gate (tests/test_torch_grad.py ``hold_grads``: the metric within
    1e-12, each key finite and within 1e-9 x its max|g|, or ``tols``);
    each key's error over that scale."""
    gates = _test_module("test_torch_grad")
    return _held("gradients", gates.hold_grads, val[:n],
                 {k: g[:n] for k, g in grads.items()}, gold, pfx,
                 phase=tag, **tols)


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
          f"{_test_module('test_torch_grad').TOL:g}); design gradients on the demos within "
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


def _farm_warm_grad(ev, p0):
    """The farm phase's warm-up: the golden rows ``p0`` through ``ev``
    in one ``torch.func.jvp`` over row inputs that require grad, along
    golden_jvp_farm_semi_wind.npz's first direction at its rows (FARM_ROWS
    rows 2-3, found among ``p0``'s; zero elsewhere), then the backward of
    the response metric of golden_grad_farm_semi_wind.npz's rows (the
    same), both held against their goldens: (numpy outputs, the gradient
    record, the forward's s).  One forward, the coupled statics' launch
    storm paid once, gives the primal, the tangent and the gradient.  The
    forward entry's launches are counted against the trips and the
    tangent work, the adjoint entry's of the backward from 0, the N = 12
    ones (the system response's, on the lane-per-row design) against the
    count the code gives."""
    from raft_tpu_torch.api import ENV_KEYS, SEA_KEYS
    from raft_tpu_torch.models import dynamics
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    gold = dict(np.load(os.path.join(FIX, "golden_grad_farm_semi_wind.npz")))
    gj = dict(np.load(os.path.join(FIX, "golden_jvp_farm_semi_wind.npz")))
    fwdt = _test_module("test_torch_fwd")
    keys = ENV_KEYS + SEA_KEYS
    n = len(gold["Hs"])
    idx = [i for i in range(len(p0["Hs"])) if all(
        any(np.array_equal(p0[k][i], gold[k][j]) for j in range(n))
        for k in keys)]
    check(len(idx) == n and all(np.array_equal(p0[k][idx], gold[k])
                                and np.array_equal(p0[k][idx], gj[k])
                                for k in keys),
          "farm: the gradient and jvp goldens' rows are not among the "
          "golden rows")
    x = {k: torch.tensor(p0[k], dtype=torch.float64, device=DEVICE,
                         requires_grad=True) for k in keys}
    t = {k: torch.zeros_like(v) for k, v in x.items()}
    for k, v in fwdt.directions({k: x[k][idx] for k in keys}, 0).items():
        t[k][idx] = v
    linsolve.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    out, tan = torch.func.jvp(lambda x: ev(**x), (x,), (t,))
    torch.cuda.synchronize()
    t1 = time.time()
    fwd_launches = linsolve.KERNEL_LAUNCHES
    fwd_row = linsolve.ROW_KERNEL_LAUNCHES
    worst_tan = _held("farm tangents", fwdt.hold_tangents,
                      {k: v[idx] for k, v in tan.items()}, gj, "", 0,
                      phase="farm")
    val = _metric(out)[idx]
    # CUDA events around each launch of the lane-per-row design in the
    # backward (the system response's N = 12 adjoint)
    rows_fn, n12 = linsolve._cuda_solve_rows, []

    def timed_rows(Z, F, adjoint=False):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        lam = rows_fn(Z, F, adjoint=adjoint)
        ev1.record()
        n12.append((ev0, ev1, tuple(Z.shape)))
        return lam

    linsolve.reset_launches()
    linsolve._cuda_solve_rows = timed_rows
    try:
        grads = dict(zip(keys, torch.autograd.grad(
            val.sum(), list(x.values()), allow_unused=True,
            materialize_grads=True)))
    finally:
        linsolve._cuda_solve_rows = rows_fn
    torch.cuda.synchronize()
    t2 = time.time()
    adj = linsolve.ADJ_KERNEL_LAUNCHES
    row_adj = linsolve.ROW_KERNEL_LAUNCHES
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    rows = len(p0["Hs"])
    chunks = math.ceil(rows / (int(config.get("BUCKET_ROWS")) or rows))
    # per chunk: the system response's adjoint at N = nT on the
    # lane-per-row design; the units' fixed point's NEUMANN_STEPS
    # Neumann steps and its pull-back at N = 6 (the final update's
    # solve is unused: the farm takes Z and Bmat from it, not Xi)
    exp_row = chunks
    exp_adj = chunks * (dynamics.NEUMANN_STEPS + 2)
    check(row_adj == exp_row, f"farm: the N = {ev.nT} adjoint entry "
          f"launched {row_adj} times in the backward, expected {exp_row}")
    check(adj == exp_adj, f"farm: adjoint launches {adj}, expected "
          f"{exp_adj}")
    np_out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    # the forward's: per chunk the trips and the final update at N = 6
    # and the system response at N = 12, each solve with its tangent, and
    # the fixed point's tangent work
    cap = ev.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
        + max(int(ev.n_iter_extra), 0)
    exp_fwd = expected_launches(
        np_out["n_iter_drag"].max(axis=1), int(config.get("BUCKET_ROWS"))
        or rows, cap, min(max(1, config.get("SCAN_CHUNK")), cap),
        fused=True) + chunks * (_tangent_launches(True) + 2)
    check(fwd_launches == exp_fwd and fwd_row == 2 * chunks,
          f"farm: forward entry launched {fwd_launches} times, "
          f"{fwd_row} at N = {ev.nT}, in the warm-up's forward mode; "
          f"expected {exp_fwd}, {2 * chunks}")
    _hold_exact({k: v[idx] for k, v in out.items()}, gold, "",
                "grad_paths farm")
    worst = _hold_grads(val, {k: g[idx] for k, g in grads.items()}, gold,
                        "", "grad_paths farm", n)
    rec = _grad_record(
        n, t1 - t0, t2 - t1, peak, worst=max(worst.values()), nT=ev.nT,
        rows_evaluated=rows, chunks=chunks, adj_launches=adj,
        expected_adj_launches=exp_adj, row_adj_launches=row_adj,
        expected_row_adj_launches=exp_row, adj_n6_launches=adj - row_adj,
        n12_adj_ms=sum(a.elapsed_time(b) for a, b, _ in n12),
        n12_adj_shapes=[z for _, _, z in n12], fwd_launches=fwd_launches,
        expected_fwd_launches=exp_fwd, row_fwd_launches=fwd_row,
        worst_tangent=max(worst_tan.values()))
    return np_out, rec, t1 - t0


def phase_farm(card, rows=FARM_ROWS):
    """The farm evaluator on the two-unit shared-mooring farm: warm-up on
    the golden rows (held, and differentiated: :func:`_farm_warm_grad`),
    then ``rows`` operating rows with the golden
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

    out, grad, warm_s = _farm_warm_grad(ev, farm_rows(gold, n_gold))
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
        newton_per_chunk=calls,
        free_point_steps=MooringNetwork.FREE_STEPS,
        launches=launches, expected_launches=exp, row_launches=row_launches,
        n_iter_drag_max=int(out["n_iter_drag"].max()),
        status_shares=_status_shares(st),
        worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()},
        grad=grad)
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
    return res, ev, out["X0"]


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


def phase_profile_farm(ev, X0):
    """torch.profiler over one network evaluation of the farm's mooring
    (the evaluator's own closure, as one statics Newton iteration calls
    it, the bulk of a farm chunk) at the farm phase's equilibrium poses
    ``X0`` (R, nT): kernel launches, device events, busy time and idle
    share.  A whole chunk under the profiler makes about 2.8 million
    launches, whose events take minutes to read."""
    X = torch.as_tensor(X0, dtype=torch.float64, device=DEVICE)
    r = _device_profile(lambda: ev.mooring.with_root(X))
    res = {k: v for k, v in r.items() if k != "kernels"}
    res["rows"] = X.shape[0]
    if r["busy_ms"] > 0:
        print(f"profile_farm: one network evaluation of the farm's mooring "
              f"at {X.shape[0]} rows: {r['kernel_launches']} kernel "
              f"launches, {r['device_events']} device events, device busy "
              f"{r['busy_ms']:.1f} ms of {r['wall_ms']:.1f} ms (under the "
              f"profiler), idle share {r['idle_share']:.3f}")
    else:
        print("profile_farm: the profiler recorded no device time "
              "(not measured)")
    return res


# ---------------------------------------------------------------- flexible

def _flex_tols():
    """The flexible path's gates, x each key's max (FLEX_KAPPA_*)."""
    eps = float(np.finfo(np.float64).eps)
    z = FLEX_KAPPA_Z * eps
    return dict(X0=FLEX_KAPPA_K * eps, Xi=z, PSD=z, drag_resid=z)


def _flex_design(d_scale=1.0, t_scale=1.0):
    """design_semi_wind_flex.json with its tower's d and t scaled."""
    with open(os.path.join(FIX, f"design_{FLEX_DESIGN}_flex.json")) as f:
        d = json.load(f)
    tw = d["turbine"]["tower"]
    tw["d"] = [x * d_scale for x in tw["d"]]
    tw["t"] = [x * t_scale for x in tw["t"]]
    return d


class SolveTimer:
    """While installed, a CUDA event pair around every call of
    ``torch.linalg.solve``, attributed to the stage in progress (the one
    that ends at the timer's next mark), with the real FLOP its systems
    need: per complex N x N system 8/3 N^3 for the LU and 8 N^2 per
    right-hand side for the two triangular solves (a real system a
    quarter of that)."""

    def __init__(self, stages):
        self.fn = torch.linalg.solve
        self.after = dict(zip(("start",) + tuple(stages), stages))
        self.stage = None
        self.events = []

    def __enter__(self):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **kw)
            e1.record()
            A, B = a[0], a[1]
            N = A.shape[-1]
            systems = math.prod(torch.broadcast_shapes(
                A.shape[:-2], B.shape[:-2] if B.dim() == A.dim()
                else B.shape[:-1]))
            rhs = B.shape[-1] if B.dim() == A.dim() else 1
            flop = systems * (8 / 3 * N ** 3 + 8 * N ** 2 * rhs)
            if not A.is_complex():
                flop /= 4
            self.events.append((self.stage, e0, e1, flop))
            return out

        torch.linalg.solve = timed
        return self

    def __exit__(self, *exc):
        torch.linalg.solve = self.fn

    def mark(self, stage):
        self.stage = self.after.get(stage)

    def ms(self):
        """{stage: (ms in torch.linalg.solve, calls, FLOP)}."""
        out = {}
        for stage, e0, e1, flop in self.events:
            ms, n, f = out.get(stage, (0.0, 0, 0.0))
            out[stage] = (ms + e0.elapsed_time(e1), n + 1, f + flop)
        return out


def _flex_run(ev, p, stages, sp=None):
    """One timed run of the flexible evaluator: outputs (numpy), wall s,
    stage ms summed over chunks, Newton iterations, peak device memory
    and torch.linalg.solve time per stage; the solve kernel's launch
    counters must not move."""
    from raft_tpu_torch.ops import linsolve

    timer = StageTimer()
    peaks, base = [], []
    with MooringCounter() as moor, SolveTimer(stages) as solves:
        def mark(stage):
            moor.mark(stage)
            solves.mark(stage)
            if stage == "start":
                torch.cuda.reset_peak_memory_stats()
                base.append(torch.cuda.memory_allocated())
            elif stage == "response":
                peaks.append(torch.cuda.max_memory_allocated())
            timer(stage)

        linsolve.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = ev(**p, struct_params=sp, timer=mark)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        wall = time.time() - t0
        torch.cuda.synchronize()
    check(linsolve.KERNEL_LAUNCHES == 0 and linsolve.ADJ_KERNEL_LAUNCHES == 0
          and linsolve.ROW_KERNEL_LAUNCHES == 0,
          f"flex: the solve kernel launched ({linsolve.KERNEL_LAUNCHES}, "
          f"{linsolve.ADJ_KERNEL_LAUNCHES}, {linsolve.ROW_KERNEL_LAUNCHES}); "
          "N > 12 goes to torch.linalg.solve")
    chunks = timer.chunks()
    stage_ms = {st: sum(c.get(st, 0.0) for c in chunks) for st in stages}
    return dict(out=out, wall=wall, chunks=len(chunks), stage_ms=stage_ms,
                newton=list(moor.per_chunk),
                peak_mib=[x / 2 ** 20 for x in peaks],
                base_mib=[x / 2 ** 20 for x in base], solve=solves.ms())


def phase_flex(card, rows=FLEX_ROWS):
    """The flexible evaluator on semi_wind_flex: warm-up on the golden
    rows (held), then ``rows`` operating rows with the golden rows first,
    timed per stage, Newton iterations and peak memory per chunk, the
    library solve's share of the fixed point, no solve-kernel launch."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model

    t0 = time.time()
    model = Model(_flex_design())
    ev = api.make_flexible_evaluator(model, nWaves=1, device=DEVICE)
    build_s = time.time() - t0
    gold = dict(np.load(os.path.join(FIX, f"golden_flex_{FLEX_DESIGN}.npz")))
    n_gold = len(gold["Hs"])
    tols = _flex_tols()
    keys = api.FLEX_OUT_KEYS

    t0 = time.time()
    warm = _flex_run(ev, full_rows("semi_wind", gold, n_gold,
                                   FLEX_SEED), api.FLEX_STAGES)
    warm_s = time.time() - t0
    worst = hold_goldens(warm["out"], {FLEX_DESIGN: np.arange(n_gold)},
                         {FLEX_DESIGN: gold}, "on_", "flex", keys=keys,
                         tols=tols)
    r = _flex_run(ev, full_rows("semi_wind", gold, rows, FLEX_SEED),
                  api.FLEX_STAGES)
    out = r["out"]
    main = hold_goldens(out, {FLEX_DESIGN: np.arange(n_gold)},
                        {FLEX_DESIGN: gold}, "on_", "flex", keys=keys,
                        tols=tols)
    for k, v in main.items():
        worst[k] = max(worst[k], v)
    for k in ("X0", "Xi", "PSD"):
        check(np.all(np.isfinite(out[k])), f"flex: non-finite {k}")
    check(out["Xi"].shape == (rows, 2, ev.n, ev.nw),
          f"flex: Xi shape {out['Xi'].shape}")
    stage_ms = r["stage_ms"]
    total = sum(stage_ms.values())
    fp_solve_ms, fp_solves, fp_flop = r["solve"].get("fixed_point",
                                                     (0.0, 0, 0.0))
    res = dict(
        design=FLEX_DESIGN, nDOF=ev.n, nodes=ev.fs.n_nodes, rows=rows,
        chunk_rows=api.FLEX_ROWS, build_s=build_s, warm_s=warm_s,
        wall_s=r["wall"], evals_per_s=rows / r["wall"],
        device_evals_per_s=rows / (total / 1e3), chunks=r["chunks"],
        stage_ms=stage_ms,
        stage_share={k: v / total for k, v in stage_ms.items()},
        newton_per_chunk=r["newton"], peak_mib_per_chunk=r["peak_mib"],
        base_mib=r["base_mib"][0] if r["base_mib"] else 0.0,
        solve_ms_by_stage={k: v[0] for k, v in r["solve"].items()},
        solve_calls_by_stage={k: v[1] for k, v in r["solve"].items()},
        fixed_point_solve_share=(fp_solve_ms / stage_ms["fixed_point"]
                                 if stage_ms["fixed_point"] else 0.0),
        fixed_point_solve_tflops=(fp_flop / fp_solve_ms / 1e9
                                  if fp_solve_ms else 0.0),
        fixed_point_solve_peak_share=(
            fp_flop / fp_solve_ms / 1e-3 / PEAK_FLOPS[torch.float64]
            if fp_solve_ms else 0.0),
        n_iter_drag_max=int(out["n_iter_drag"].max()),
        status_shares=_status_shares(out["status"]),
        worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()},
        gates=tols)
    print(f"flex {FLEX_DESIGN} (nDOF {ev.n}, {ev.fs.n_nodes} nodes) on "
          f"{card}: {rows} rows in {r['chunks']} chunks of {api.FLEX_ROWS} "
          f"in {r['wall']:.2f} s = {res['evals_per_s']:.2f} flex-evals/s; "
          "stage ms " + ", ".join(
              f"{k} {v:.1f} ({100 * res['stage_share'][k]:.1f}%)"
              for k, v in stage_ms.items())
          + f"; torch.linalg.solve {fp_solve_ms:.1f} ms of the fixed point "
          f"({100 * res['fixed_point_solve_share']:.1f}%, {fp_solves} "
          f"calls, {res['fixed_point_solve_tflops']:.2f} TFLOP/s of LU and "
          f"substitution, {100 * res['fixed_point_solve_peak_share']:.1f}% "
          f"of the FP64 peak); statics Newton iterations per chunk "
          f"{r['newton']}; peak device memory per chunk {max(r['peak_mib']):.0f} MiB "
          f"(before a chunk {res['base_mib']:.0f} MiB); status shares "
          f"{res['status_shares']}; solve-kernel launches 0 (N > 12: "
          "torch.linalg.solve)")
    print("  flex goldens (gates x max: " + ", ".join(
        f"{k} {v:.1e}" for k, v in tols.items())
        + ", else {:g}; status, n_iter_drag, drag_converged equal): "
        .format(SLICE_TOL) + ", ".join(
            f"{k} {v:.1e}" for k, v in res["worst_rel"].items()))
    res["flex_geometry"] = phase_flex_geometry(model, card)
    return res


def _bem_hold(got, gold, tag):
    """Coefficients ``got`` against ``gold`` (name -> (array, golden
    array)) at BEM_COEF_TOL x max; the worst relative error per name."""
    worst = {}
    for k, (a, b) in got.items():
        a, b = np.asarray(a), np.asarray(b)
        check(a.shape == b.shape, f"{tag} {k}: shape {a.shape} != {b.shape}")
        scale = float(np.max(np.abs(b)))
        err = float(np.max(np.abs(a - b)))
        check(err <= BEM_COEF_TOL * scale,
              f"{tag} {k}: {err:.3e} > {BEM_COEF_TOL:g} x {scale:.3e}")
        worst[k] = err / scale
    return worst


class DriftCounter(MooringCounter):
    """A :class:`MooringCounter` that also splits the evaluations of the
    second equilibrium (the mean drift) per chunk, between the
    "response" and "drift" marks."""

    def __init__(self):
        super().__init__()
        self.drift = []

    def mark(self, stage):
        super().mark(stage)
        if stage == "response":
            self._d0 = self.n
        elif stage == "drift":
            self.drift.append(self.n - self._d0)


def _timed_full_rows(ev, p, tag, geom=None):
    """``p`` (and ``geom``) through the full evaluator ``ev`` with stage
    events, the statics iterations counted and the solve kernel's
    launches counted from 0: (numpy outputs, wall s, stage ms, Newton
    iterations per chunk, those of the drift equilibrium per chunk
    (empty without a QTF), launches, expected launches)."""
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    timer = StageTimer()
    with DriftCounter() as moor:
        def mark(stage):
            moor.mark(stage)
            timer(stage)

        kw = {} if geom is None else dict(geom=geom)
        linsolve.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = {k: v.cpu().numpy() for k, v in ev(**p, **kw,
                                                   timer=mark).items()}
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = linsolve.KERNEL_LAUNCHES
    cap = ev.body.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
        + max(int(ev.body.n_iter_extra), 0)
    rows = len(p["Hs"])
    exp = expected_launches(out["n_iter_drag"],
                            int(config.get("BUCKET_ROWS")) or rows, cap,
                            min(max(1, config.get("SCAN_CHUNK")), cap),
                            config.get("FUSED") == "on" and ev.nWaves == 1)
    check(launches == exp, f"{tag}: solve kernel launched {launches} times, "
          f"expected {exp}")
    for k in ("X0", "Xi", "PSD", "F_2nd_mean"):
        check(np.all(np.isfinite(out[k])), f"{tag}: non-finite {k}")
    chunks = timer.chunks()
    check(all(set(c) == set(ev.stages) for c in chunks),
          f"{tag}: a chunk's stages are not {ev.stages}")
    stage_ms = {s: sum(c.get(s, 0.0) for c in chunks) for s in ev.stages}
    return (out, wall, stage_ms, list(moor.per_chunk),
            list(moor.drift), launches, exp)


def start_bem_host(out_dir):
    """Start the bem phase's host work in a thread, to run beside the
    launch-bound phases before it: a fresh cache under ``out_dir``
    (RAFT_TPU_BEM_DIR, restored by :func:`phase_bem`), the Green table
    and the panel library loaded, design_semi_wind_bem.json's Model and
    its panel solves, the design's own and those of its d_scale axis'
    two other sample scales, each recorded as solve_bem returns it, on
    BEM_HOST_THREADS threads (ctypes frees the GIL for each frequency's
    solve).  Returns a dict whose ``future`` gives (Model, [(panels,
    (A, B, X))], seconds)."""
    import concurrent.futures as cf

    from raft_tpu_torch import native
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.native import green_table

    cache = os.path.join(out_dir, "bem_cache")
    shutil.rmtree(cache, ignore_errors=True)
    host = dict(prev=os.environ.get("RAFT_TPU_BEM_DIR"), t0=time.time())
    os.environ["RAFT_TPU_BEM_DIR"] = cache

    def work():
        sec = {}
        t0 = time.time()
        green_table.build_tables()
        sec["table_s"] = time.time() - t0
        t0 = time.time()
        native.build()
        sec["gxx_s"] = time.time() - t0
        raw = []
        solve = native.solve_bem

        def recording(*a, **kw):
            kw["workers"] = kw.get("workers") or BEM_HOST_THREADS
            raw.append((len(a[3]), solve(*a, **kw)))
            return raw[-1][1]

        native.solve_bem = recording
        try:
            with open(os.path.join(FIX, "design_semi_wind_bem.json")) as f:
                model = Model(json.load(f))
            t0 = time.time()
            model.bem
            sec["solve_s"] = time.time() - t0
            # the geometry evaluator's sample scales (api.py, bem_samples)
            scales = (model.design.get("settings", {}) or {}).get(
                "bem_geom_scales", (0.92, 1.0, 1.08))
            t0 = time.time()
            for sc in scales:
                if abs(float(sc) - 1.0) > 1e-12:
                    model.run_bem(d_scale=float(sc))
            sec["geometry_solve_s"] = time.time() - t0
        finally:
            native.solve_bem = solve
        sec["host_s"] = time.time() - host["t0"]
        return model, raw, sec

    ex = cf.ThreadPoolExecutor(max_workers=1)
    host["future"] = ex.submit(work)
    ex.shutdown(wait=False)
    return host


def phase_bem(out_dir, card, host):
    """Potential flow on semi_wind_bem (module docstring, phase 18): the
    host panel solves of :func:`start_bem_host` into a fresh cache,
    their raw and model-grid coefficients held against the JAX goldens;
    the full evaluator's golden rows and BEM_ROWS rows; the WAMIT-file
    design's golden rows; the d_scale geometry axis (its panel solves
    served from the cache) with its golden rows and BEM_GEOMETRY_ROWS
    rows."""
    from raft_tpu_torch import native
    from raft_tpu_torch.api import (ENV_KEYS, FULL_OUT_KEYS, SEA_KEYS,
                                    make_full_evaluator)
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.utils import config

    pfx = "on_" if config.get("FUSED") == "on" else "off_"
    gold = dict(np.load(os.path.join(FIX, "golden_bem_semi_wind.npz")))
    res = {}
    try:
        # ---- the host solves, nothing served from a cache
        t0 = time.time()
        model, raw, sec = host["future"].result()
        res.update(sec, wait_s=time.time() - t0)
        bem = model.bem
        check(len(raw) == 3, f"bem: {len(raw)} panel solves, expected 3 "
              "(the design's and two d_scale samples)")
        mesh, (A, B, X) = raw[0]
        check(mesh == int(gold["n_panels"]),
              f"bem: {mesh} panels, the reference meshes {gold['n_panels']}")
        res["raw_worst"] = _bem_hold(dict(A=(A, gold["A"]), B=(B, gold["B"]),
                                          X=(X, gold["X"])), gold, "bem raw")
        res["coef_worst"] = _bem_hold(
            {k: (bem[k], gold["coef_" + k]) for k in ("A_BEM", "B_BEM",
                                                      "X_BEM")},
            gold, "bem coefficients")
        check(np.array_equal(bem["headings"], gold["coef_headings"]),
              "bem: headings differ")
        res.update(panels=mesh, frequencies=len(gold["w_bem"]),
                   headings=len(gold["bem_headings"]),
                   threads=BEM_HOST_THREADS)
        print(f"bem host solve on {card}: {mesh} panels x "
              f"{res['frequencies']} frequencies x {res['headings']} "
              f"headings, {res['threads']} threads on {os.cpu_count()} "
              f"cores, beside the phases from farm on: table load "
              f"{res['table_s']:.2f} s, g++ {res['gxx_s']:.2f} s (built in "
              f"the build phase), mesh + solve + .1/.3 round trip "
              f"{res['solve_s']:.1f} s, the d_scale axis' two "
              f"{res['geometry_solve_s']:.1f} s, all done "
              f"{res['host_s']:.1f} s after the start, waited for "
              f"{res['wait_s']:.1f} s; raw A/B/X against the JAX goldens "
              f"(gate {BEM_COEF_TOL:g} x max) " + ", ".join(
                  f"{k} {v:.1e}" for k, v in res["raw_worst"].items())
              + "; after the WAMIT round trip " + ", ".join(
                  f"{k} {v:.1e}" for k, v in res["coef_worst"].items()))

        # ---- the evaluator: golden rows, then BEM_ROWS rows
        ev = make_full_evaluator(model, device=DEVICE)
        g1 = {k: gold["h1_" + k] for k in ENV_KEYS + SEA_KEYS}
        n_gold = len(g1["Hs"])
        ref = {"semi_wind_bem": {k[3:]: v for k, v in gold.items()
                                 if k.startswith("h1_")}}
        out = {k: v.cpu().numpy() for k, v in ev(**g1).items()}
        worst = hold_goldens(out, {"semi_wind_bem": np.arange(n_gold)}, ref,
                             pfx, "bem", keys=FULL_OUT_KEYS)
        p = full_rows("semi_wind", g1, BEM_ROWS, BEM_SEED)
        out, wall, stage_ms, newton, _, launches, exp = _timed_full_rows(
            ev, p, "bem")
        main = hold_goldens(out, {"semi_wind_bem": np.arange(n_gold)}, ref,
                            pfx, "bem", keys=FULL_OUT_KEYS)
        worst = {k: max(v, main[k]) for k, v in worst.items()}
        res.update(rows=BEM_ROWS, wall_s=wall, evals_per_s=BEM_ROWS / wall,
                   stage_ms=stage_ms, newton_per_chunk=newton,
                   launches=launches, expected_launches=exp,
                   status_shares=_status_shares(out["status"]),
                   worst_rel={k.split(".", 1)[1]: v
                              for k, v in worst.items()})
        print(f"bem semi_wind_bem on {card}: {BEM_ROWS} rows, nWaves 1, "
              f"{wall:.2f} s = {res['evals_per_s']:.1f} full-evals/s; "
              "stage ms " + ", ".join(f"{s} {v:.1f}"
                                      for s, v in stage_ms.items())
              + f"; statics Newton iterations per chunk {newton}; solve "
              f"kernel launches {launches} (expected {exp}); status-bit "
              f"shares {res['status_shares']}; goldens (gate "
              f"{SLICE_TOL:g} x max; status, n_iter_drag, drag_converged "
              f"equal): worst {max(res['worst_rel'].values()):.1e}")

        # ---- the WAMIT-file design's golden rows
        gw = dict(np.load(os.path.join(FIX, "golden_bem_semi_wind_wamit.npz")))
        wm = Model(os.path.join(FIX, "design_semi_wind_wamit.json"))
        out = {k: v.cpu().numpy() for k, v in make_full_evaluator(
            wm, device=DEVICE)(**{k: gw["h1_" + k]
                                  for k in ENV_KEYS + SEA_KEYS}).items()}
        ww = hold_goldens(
            out, {"semi_wind_wamit": np.arange(len(gw["h1_Hs"]))},
            {"semi_wind_wamit": {k[3:]: v for k, v in gw.items()
                                 if k.startswith("h1_")}},
            pfx, "bem wamit", keys=FULL_OUT_KEYS)
        res["wamit_worst"] = max(ww.values())
        print(f"bem semi_wind_wamit on {card}: golden rows held, worst "
              f"{res['wamit_worst']:.1e}")

        # ---- the d_scale geometry axis
        geo = make_full_evaluator(model, device=DEVICE, geometry=True)
        solve, solved = native.solve_bem, []
        native.solve_bem = lambda *a, **kw: solved.append(1) or solve(
            *a, **kw)
        t0 = time.time()
        try:
            geo.bem_samples()
        finally:
            native.solve_bem = solve
        res["geometry_load_s"] = time.time() - t0
        check(not solved, f"bem geometry: {len(solved)} panel solve(s) at "
              f"the d_scale samples {geo.bem_scales}, expected all served "
              "from the cache the host solves wrote")
        gg = {k: gold["geo_" + k] for k in ENV_KEYS + SEA_KEYS}
        ds = gold["geo_d_scale"]
        out = {k: v.cpu().numpy() for k, v in geo(
            geom=dict(d_scale=ds), **gg).items()}
        gref = {"semi_wind_bem": {k[4:]: v for k, v in gold.items()
                                  if k.startswith("geo_")}}
        wg = hold_goldens(out, {"semi_wind_bem": np.arange(len(ds))}, gref,
                          pfx, "bem geometry", keys=FULL_OUT_KEYS)
        rng = np.random.default_rng(BEM_GEOMETRY_SEED)
        pg = full_rows("semi_wind", gg, BEM_GEOMETRY_ROWS, BEM_GEOMETRY_SEED)
        dsg = np.concatenate([ds, rng.uniform(*D_SCALE_BOX,
                                              BEM_GEOMETRY_ROWS - len(ds))])
        out, gwall, gstage, gnewton, _, glaunch, gexp = _timed_full_rows(
            geo, pg, "bem geometry", geom=dict(d_scale=dsg))
        main = hold_goldens(out, {"semi_wind_bem": np.arange(len(ds))}, gref,
                            pfx, "bem geometry", keys=FULL_OUT_KEYS)
        res["geometry"] = dict(
            rows=BEM_GEOMETRY_ROWS, wall_s=gwall,
            evals_per_s=BEM_GEOMETRY_ROWS / gwall, stage_ms=gstage,
            newton_per_chunk=gnewton, launches=glaunch,
            expected_launches=gexp,
            worst=max(max(wg.values()), max(main.values())))
        r = res["geometry"]
        print(f"bem geometry on {card}: the two more host solves (d_scale "
              f"{geo.bem_scales[0]:g}, {geo.bem_scales[2]:g}) read from the "
              f"cache in {res['geometry_load_s']:.2f} s; {BEM_GEOMETRY_ROWS} rows, "
              f"d_scale over {D_SCALE_BOX}, {gwall:.2f} s = "
              f"{r['evals_per_s']:.1f} geometry-evals/s; stage ms "
              + ", ".join(f"{s} {v:.1f}" for s, v in gstage.items())
              + f"; solve kernel launches {glaunch} (expected {gexp}); "
              f"goldens worst {r['worst']:.1e}")
    finally:
        if host["prev"] is None:
            os.environ.pop("RAFT_TPU_BEM_DIR", None)
        else:
            os.environ["RAFT_TPU_BEM_DIR"] = host["prev"]
    return res, geo


def _grad_pass(fn, x, metrics):
    """One differentiable evaluation ``fn(x)`` and the backward of each
    metric (name -> (metric of the outputs, keys of ``x``)), timed and
    with the peak device memory above the start: (outputs, {name: (per
    row values, {key: gradient})}, forward s, backward s, peak MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    out = fn(x)
    torch.cuda.synchronize()
    t1 = time.time()
    res = {}
    names = list(metrics)
    for i, name in enumerate(names):
        f, keys = metrics[name]
        val = f(out)
        g = torch.autograd.grad(val.sum(), [x[k] for k in keys],
                                retain_graph=i + 1 < len(names),
                                allow_unused=True, materialize_grads=True)
        res[name] = (val, dict(zip(keys, g)))
    torch.cuda.synchronize()
    t2 = time.time()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return out, res, t1 - t0, t2 - t1, peak


def _grad_record(rows, fwd_s, bwd_s, peak, **kw):
    return dict(rows=rows, fwd_s=fwd_s, bwd_s=bwd_s,
                bwd_over_fwd=bwd_s / fwd_s,
                rows_per_s=rows / (fwd_s + bwd_s), peak_mb=peak, **kw)


def _hold_exact(out, gold, pfx, tag):
    for k in ("status", "n_iter_drag"):
        a = out[k].cpu().numpy()
        check(np.array_equal(a, gold[pfx + k]),
              f"{tag}: {k} {a.tolist()} != {gold[pfx + k].tolist()}")


def phase_grad_paths(full_evs, farm_grad, bem_geo, card):
    """Reverse mode through the aero stage, the potential-flow d_scale
    and the flexible path on golden rows (module docstring, grad_paths),
    each held against its jax.grad golden; with the farm's, taken in the
    farm phase (``farm_grad``, :func:`_farm_warm_grad`)."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    keys = api.ENV_KEYS + api.SEA_KEYS
    kw = dict(dtype=torch.float64, device=DEVICE)
    pfx = "on_" if config.get("FUSED") == "on" else "off_"
    mk = _test_module("make_torch_port_fixtures")
    aero_metric = _test_module("test_torch_grad_aero").aero_metric
    flex_gates = _test_module("test_torch_grad_flex")
    res = {}
    fwd_launches = adj_launches = 0

    def leaves(src, names):
        return {k: torch.tensor(src[k], **kw, requires_grad=True)
                for k in names}

    def counted(fn, x, metrics):
        nonlocal fwd_launches, adj_launches
        linsolve.reset_launches()
        out = _grad_pass(fn, x, metrics)
        fwd_launches += linsolve.KERNEL_LAUNCHES
        adj_launches += linsolve.ADJ_KERNEL_LAUNCHES
        return out

    # ---- the aero stage's inputs, the full phase's evaluators
    for name in GRAD_AERO_SETS:
        gold = dict(np.load(os.path.join(FIX, f"golden_grad_aero_{name}.npz")))
        x = leaves(gold, keys)
        out, g, fwd_s, bwd_s, peak = counted(
            lambda x: full_evs[name](**x), x,
            dict(response=(_metric, keys), aero=(
                aero_metric, mk.GRAD_AERO_METRIC_KEYS)))
        n = len(gold["Hs"])
        _hold_exact(out, gold, pfx, f"grad_paths aero {name}")
        worst = _hold_grads(*g["response"], gold, pfx,
                            f"grad_paths aero {name}", n)
        worst.update({f"aero.{k}": v for k, v in _hold_grads(
            *g["aero"], gold, pfx + "aero_", f"grad_paths aero {name}",
            n).items()})
        res[f"aero_{name}"] = _grad_record(n, fwd_s, bwd_s, peak,
                                           worst=max(worst.values()))

    # ---- d_scale of the potential-flow design: the bem phase's geometry
    # evaluator, its off-unit panel solves reused
    gold = dict(np.load(os.path.join(FIX, "golden_grad_bem_semi_wind.npz")))
    x = leaves(gold, keys + ("d_scale",))
    solves = []
    run_bem = bem_geo._run_bem
    bem_geo._run_bem = lambda **k: solves.append(k) or run_bem(**k)
    try:
        out, g, fwd_s, bwd_s, peak = counted(
            lambda x: bem_geo(geom=dict(d_scale=x["d_scale"]),
                              **{k: x[k] for k in keys}), x,
            dict(response=(_metric, keys + ("d_scale",))))
    finally:
        bem_geo._run_bem = run_bem
    check(not solves, f"grad_paths bem: {len(solves)} panel solves, "
          "expected the bem phase's to be reused")
    n = len(gold["Hs"])
    _hold_exact(out, gold, pfx, "grad_paths bem")
    worst = _hold_grads(*g["response"], gold, pfx, "grad_paths bem", n)
    res["bem"] = _grad_record(n, fwd_s, bwd_s, peak,
                              worst=max(worst.values()),
                              g_d_scale=g["response"][1]["d_scale"].tolist())

    # ---- the farm: its golden gradient rows, taken on the farm phase's
    # warm-up call (its coupled statics' launch storm paid once)
    res["farm"] = farm_grad
    adj_launches += farm_grad["adj_launches"]

    # ---- the flexible path: the rows, then struct_params
    gold = dict(np.load(os.path.join(FIX, "golden_grad_flex_semi_wind.npz")))
    model = Model(_flex_design())
    n = len(gold["Hs"])
    for tag, geometry in (("flex", False), ("flex_geometry", True)):
        pre = "geo_" if geometry else ""
        ev = api.make_flexible_evaluator(model, nWaves=1, device=DEVICE,
                                         geometry=geometry)
        x = leaves(gold, keys)
        if geometry:
            x.update({k[len(pre):]: torch.tensor(v, **kw,
                                                 requires_grad=True)
                      for k, v in gold.items() if k.startswith(pre + "sp.")})

            def fn(x):
                return ev(struct_params=mk._tree_struct_params(x),
                          **{k: x[k] for k in keys})
        else:
            def fn(x):
                return ev(**x)
        out, g, fwd_s, bwd_s, peak = counted(fn, x, dict(
            response=(_metric, list(x))))
        _hold_exact(out, gold, pre, f"grad_paths {tag}")
        worst = _hold_grads(*g["response"], gold, pre, f"grad_paths {tag}",
                            n, tol=flex_gates.GRAD_GATE,
                            metric_tol=flex_gates.METRIC_GATE)
        res[tag] = _grad_record(n, fwd_s, bwd_s, peak,
                                worst=max(worst.values()), keys=len(x))
    res.update(fwd_launches=fwd_launches, adj_launches=adj_launches,
               row_adj_launches=res["farm"]["row_adj_launches"])
    for tag, r in res.items():
        if not isinstance(r, dict):
            continue
        print(f"grad_paths {tag} on {card}: {r['rows']} rows, forward "
              f"{r['fwd_s']:.2f} s, backward {r['bwd_s']:.2f} s "
              f"({r['bwd_over_fwd']:.2f}x) = {r['rows_per_s']:.2f} gradient "
              f"rows/s; peak memory {r['peak_mb']:.0f} MiB; golden within "
              f"{r['worst']:.1e} x max|g|")
    f = res["farm"]
    print(f"  farm backward adjoint launches: {f['adj_launches']} (expected "
          f"{f['expected_adj_launches']}), of them on the N = "
          f"{f['nT']} lane-per-row entry {f['row_adj_launches']} "
          f"(expected {f['expected_row_adj_launches']}: one system "
          f"response per chunk; its wrapper {f['n12_adj_ms']:.3f} ms on Z "
          f"{f['n12_adj_shapes']}), at N = 6 {f['adj_n6_launches']}; bem "
          f"d metric/d d_scale {res['bem']['g_d_scale']}")
    print(f"  farm forward mode (the same call, one jvp): tangent within "
          f"{f['worst_tangent']:.1e} x max|tangent|; forward entry "
          f"launches {f['fwd_launches']} (expected "
          f"{f['expected_fwd_launches']}: trips + final update + tangent "
          f"work at N = 6, the system response and its tangent at N = "
          f"{f['nT']}), {f['row_fwd_launches']} of them at N = {f['nT']}")
    return res


def _tangent_launches(fused_response):
    """The forward entry's launches that forward mode adds per chunk,
    as the code makes them (models/dynamics.py): the differentiable
    update at the fixed point and its tangent solve, NEUMANN_STEPS
    Neumann tangent solves, the final update's tangent solve, and the
    staged response's tangent solve where the response is staged."""
    from raft_tpu_torch.models import dynamics

    return dynamics.NEUMANN_STEPS + 3 + (0 if fused_response else 1)


def phase_fwd(demo_models, full_evs, geo_ev, bem_geo, card):
    """Forward mode (torch.func.jvp, jacfwd) through every evaluator on
    golden rows, held by the CPU tests' gates (tests/test_torch_fwd.py);
    the outputs under the transform against the plain call's (bit-equal
    on the CPU; here within SLICE_TOL x max, the flexible path's keys
    past its N = 168 solves at their kappa eps, the integer keys equal:
    under torch.func's wrappers a library kernel may round otherwise);
    per path forward-mode s over the plain forward's, and the forward
    entry's launches against the count the code gives, the same for
    any number of directions."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    fwdt = _test_module("test_torch_fwd")
    flex_gates = _test_module("test_torch_grad_flex")
    mk = _test_module("make_torch_port_fixtures")
    kw = dict(dtype=torch.float64, device=DEVICE)
    fused = config.get("FUSED") == "on"
    pfx = "on_" if fused else "off_"
    keys = api.ENV_KEYS + api.SEA_KEYS
    res = {}
    launches = 0

    def counted(fn):
        nonlocal launches
        linsolve.reset_launches()
        _sync()
        t0 = time.time()
        out = fn()
        _sync()
        s = time.time() - t0
        n = linsolve.KERNEL_LAUNCHES
        launches += n
        return out, s, n

    def held(tag, fn, *a, **k):
        return _held(tag, fn, *a, phase="fwd", **k)

    def tangents(tag, fn, x, g, pre, staged, tol=fwdt.TOL, solves=True,
                 primal_tol=SLICE_TOL):
        """The plain call, then both golden directions at once (vmap of
        jvp: the evaluator once); the primal bit-equal, the tangents
        held; launches plain + the tangent work (0 without solves)."""
        plain, s0, n0 = counted(lambda: fn(x))
        ts = [fwdt.directions(x, d) for d in range(2)]
        T = {k: torch.stack([t[k] for t in ts]) for k in x}
        (prim, tan), s1, n1 = counted(lambda: torch.func.vmap(
            lambda t: torch.func.jvp(fn, (x,), (t,)))(T))
        worst = moved = 0.0
        for d in range(2):
            moved = max(moved, held(
                f"{tag} primal", fwdt.hold_primal,
                {k: v[d] for k, v in prim.items()}, plain, g, pre,
                primal_tol))
            w = held(f"{tag} tangents", fwdt.hold_tangents,
                     {k: v[d] for k, v in tan.items()}, g, pre, d, tol)
            worst = max([worst] + list(w.values()))
        exp = n0 + _tangent_launches(not staged) if solves else 0
        check(n1 == exp, f"fwd {tag}: forward entry launched {n1} times "
              f"in forward mode, expected {exp} (plain {n0} + the tangent "
              "work)")
        res[tag] = dict(rows=len(x[next(iter(x))]), fwd_s=s0, jvp_s=s1,
                        jvp_over_fwd=s1 / s0, launches=n0,
                        jvp_launches=n1, directions=2, worst=worst,
                        primal_moved=moved)

    # ---- the demos' design evaluators: jacfwd by the six inputs (N = 6,
    # the vmap rule on the kernel), its launches those of one direction
    for n in DESIGNS:
        gd = dict(np.load(os.path.join(FIX, f"golden_grad_design_{n}.npz")))
        ev = api.make_design_evaluator(demo_models[n], DEVICE)
        x = {k: torch.tensor(gd[k], **kw) for k in DESIGN_KEYS}
        _, s0, n0 = counted(lambda: ev(**x))
        J, s2, n2 = counted(lambda: fwdt.row_jacfwd(lambda x: ev(**x), x))
        held(f"design {n} jacfwd", fwdt.hold_jacfwd, J, gd, pfx)
        exp = n0 + _tangent_launches(fused)
        check(n2 == exp, f"fwd design {n}: forward entry launched {n2} "
              f"times (jacfwd, {len(DESIGN_KEYS)} directions), expected "
              f"{exp}, as for one")
        res[f"design_{n}"] = dict(
            rows=len(gd["Hs"]), fwd_s=s0, jacfwd_s=s2,
            jacfwd_over_fwd=s2 / s0, launches=n0, jacfwd_launches=n2,
            directions=len(DESIGN_KEYS))

    # ---- the geometry axis and the rotors, the earlier phases' evaluators
    g = dict(np.load(os.path.join(FIX, "golden_jvp_geometry_semi_wind.npz")))
    rows = {k: torch.tensor(g[k], **kw) for k in keys}
    tangents("geometry_semi_wind", lambda x: geo_ev(geom=x, **rows),
             {k[5:]: torch.tensor(v, **kw) for k, v in g.items()
              if k.startswith("geom_")}, g, pfx, staged=not fused)
    for name in GRAD_AERO_SETS:
        g = dict(np.load(os.path.join(FIX, f"golden_jvp_aero_{name}.npz")))
        ev = full_evs[name]
        tangents(f"aero_{name}", lambda x: ev(**x),
                 {k: torch.tensor(g[k], **kw) for k in keys}, g, pfx,
                 staged=not fused or ev.nWaves > 1)

    # ---- d_scale of the potential-flow design, its panel solves reused
    g = dict(np.load(os.path.join(FIX, "golden_jvp_bem_semi_wind.npz")))
    solves = []
    run_bem = bem_geo._run_bem
    bem_geo._run_bem = lambda **k: solves.append(k) or run_bem(**k)
    try:
        tangents("bem_d_scale", lambda x: bem_geo(
            geom=dict(d_scale=x["d_scale"]), **{k: x[k] for k in keys}),
            {k: torch.tensor(g[k], **kw) for k in keys + ("d_scale",)}, g,
            pfx, staged=not fused)
    finally:
        bem_geo._run_bem = run_bem
    check(not solves, f"fwd bem: {len(solves)} panel solves, expected the "
          "bem phase's to be reused")

    # ---- the flexible path by its rows and by struct_params (N = 168:
    # torch.linalg.solve and its forward AD, no kernel launch)
    g = dict(np.load(os.path.join(FIX, "golden_jvp_flex_semi_wind.npz")))
    gg = dict(np.load(os.path.join(FIX, "golden_grad_flex_semi_wind.npz")))
    model = Model(_flex_design())
    for tag, geometry in (("flex", False), ("flex_geometry", True)):
        ev = api.make_flexible_evaluator(model, nWaves=1, device=DEVICE,
                                         geometry=geometry)
        x = {k: torch.tensor(g[k], **kw) for k in keys}
        if geometry:
            x.update({k[4:]: torch.tensor(v, **kw) for k, v in gg.items()
                      if k.startswith("geo_sp.")})

            def fn(x, ev=ev):
                return ev(struct_params=mk._tree_struct_params(x),
                          **{k: x[k] for k in keys})
        else:
            def fn(x, ev=ev):
                return ev(**x)
        tangents(tag, fn, x, g, "geo_" if geometry else "", staged=True,
                 tol=flex_gates.GRAD_GATE, solves=False,
                 primal_tol=dict(dict.fromkeys(api.FLEX_OUT_KEYS, SLICE_TOL),
                                 **_flex_tols()))
    res["launches"] = launches
    for tag, r in res.items():
        if not isinstance(r, dict):
            continue
        if "jacfwd_s" in r:
            print(f"fwd {tag} on {card}: {r['rows']} rows, forward "
                  f"{r['fwd_s']:.2f} s, jacfwd ({r['directions']} "
                  f"directions) {r['jacfwd_s']:.2f} s "
                  f"({r['jacfwd_over_fwd']:.2f}x); forward entry launches "
                  f"{r['launches']} plain, {r['jacfwd_launches']} in "
                  "forward mode; the gradient golden held")
            continue
        print(f"fwd {tag} on {card}: {r['rows']} rows, forward "
              f"{r['fwd_s']:.2f} s, jvp ({r['directions']} directions) "
              f"{r['jvp_s']:.2f} s ({r['jvp_over_fwd']:.2f}x); forward "
              f"entry launches {r['launches']} plain, {r['jvp_launches']} "
              f"in forward mode; goldens within {r['worst']:.1e} x "
              f"max|tangent|; outputs under the transform within "
              f"{r['primal_moved']:.1e} x max of the plain call's")
    return res


def _stack_rows(trees):
    """Nested dicts of numpy arrays stacked leaf by leaf (rows first)."""
    if isinstance(trees[0], dict):
        return {k: _stack_rows([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def phase_flex_geometry(model, card):
    """The flexible geometry axis: the golden rows (three rebuilt tower
    designs, held), then FLEX_GEOMETRY_DESIGNS host-rebuilt designs x
    FLEX_GEOMETRY_ROWS operating rows with the golden rows first."""
    from raft_tpu_torch import api
    from raft_tpu_torch.models.model import Model

    ev = api.make_flexible_evaluator(model, nWaves=1, device=DEVICE,
                                     geometry=True)
    gold = dict(np.load(os.path.join(
        FIX, f"golden_flex_geometry_{FLEX_DESIGN}.npz")))
    n_gold = len(gold["Hs"])
    rng = np.random.default_rng(FLEX_GEOMETRY_SEED)
    scales = [tuple(x) for x in rng.uniform(0.9, 1.1,
                                             (FLEX_GEOMETRY_DESIGNS, 2))]
    gold_scales = sorted(set(zip(gold["d_scale"].tolist(),
                                 gold["t_scale"].tolist())))
    t0 = time.time()
    sps = {sc: api.flexible_struct_params(Model(_flex_design(*sc)))
           for sc in scales}
    build_s = (time.time() - t0) / len(scales)
    sps.update({sc: api.flexible_struct_params(Model(_flex_design(*sc)))
                for sc in gold_scales})
    gkeys = list(zip(gold["d_scale"].tolist(), gold["t_scale"].tolist()))
    m = FLEX_GEOMETRY_ROWS * len(scales)
    base = {k: v[n_gold:] for k, v in full_rows(
        "semi_wind", gold, n_gold + m, FLEX_GEOMETRY_SEED).items()}
    p = {k: np.concatenate([gold[k], base[k]])
         for k in api.ENV_KEYS + api.SEA_KEYS}
    keys = gkeys + [sc for sc in scales for _ in range(FLEX_GEOMETRY_ROWS)]
    sp = _stack_rows([sps[k] for k in keys])
    stages = ("geometry",) + api.FLEX_STAGES
    tols = _flex_tols()

    warm = _flex_run(ev, {k: v[:n_gold] for k, v in p.items()}, stages,
                     _stack_rows([sps[k] for k in gkeys]))
    worst = hold_goldens(warm["out"], {FLEX_DESIGN: np.arange(n_gold)},
                         {FLEX_DESIGN: gold}, "on_", "flex_geometry",
                         keys=api.FLEX_OUT_KEYS, tols=tols)
    r = _flex_run(ev, p, stages, sp)
    main = hold_goldens(r["out"], {FLEX_DESIGN: np.arange(n_gold)},
                        {FLEX_DESIGN: gold}, "on_", "flex_geometry",
                        keys=api.FLEX_OUT_KEYS, tols=tols)
    for k, v in main.items():
        worst[k] = max(worst[k], v)
    for k in ("X0", "Xi", "PSD"):
        check(np.all(np.isfinite(r["out"][k])),
              f"flex_geometry: non-finite {k}")
    rows = len(keys)
    res = dict(designs=len(scales), rows_per_design=FLEX_GEOMETRY_ROWS,
               rows=rows, scales=scales, build_s_per_design=build_s,
               wall_s=r["wall"], evals_per_s=rows / r["wall"],
               chunks=r["chunks"], stage_ms=r["stage_ms"],
               newton_per_chunk=r["newton"],
               peak_mib_per_chunk=r["peak_mib"],
               status_shares=_status_shares(r["out"]["status"]),
               worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()})
    print(f"flex_geometry on {card}: {len(scales)} host-rebuilt tower "
          f"designs ({build_s:.2f} s each) x {FLEX_GEOMETRY_ROWS} rows + "
          f"{n_gold} golden rows in {r['wall']:.2f} s = "
          f"{res['evals_per_s']:.2f} evals/s; stage ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in r["stage_ms"].items())
          + f"; Newton iterations per chunk {r['newton']}; status shares "
          f"{res['status_shares']}; goldens worst " + ", ".join(
              f"{k} {v:.1e}" for k, v in res["worst_rel"].items()))
    return res


def _qtf_gold(g, tag):
    """The golden set ``tag`` of a second-order golden file in the
    layout full_rows and hold_goldens read: the rows, the geometry
    scales as geom_*, the outputs under on_/off_."""
    n = len(tag) + 1
    return {k[n:]: v for k, v in g.items() if k.startswith(tag + "_")}


def _slow_drift(gold, card):
    """The slender-body QTF of semi_wind_slender on SLOW_DRIFT_GRID,
    moving with the golden RAO: member_qtf of every member timed with
    CUDA events, kim_yue_correction on the host, peak device memory, the
    whole Model.qtf_slender per stage, hermitian off the diagonal."""
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.physics import qtf_slender as qs

    with open(os.path.join(FIX, "design_semi_wind_slender.json")) as f:
        d = json.load(f)
    d["platform"].update(SLOW_DRIFT_GRID)
    m = Model(d)
    fs, fh = m.fowtList[0], m.hydro[0]
    w2, k2 = m.w1_2nd, m.k1_2nd
    nw2 = len(w2)
    beta = float(gold["beta"])
    Xi = torch.as_tensor(np.stack([
        np.interp(w2, m.w, gold["Xi0"][i], left=0, right=0)
        for i in range(fs.nDOF)]), device=DEVICE)
    a_i = fh.hc0["a_i"]
    args = []
    ofs = 0
    for mem in fs.members:
        args.append((mem, a_i[ofs:ofs + mem.ns], Xi, beta, w2, k2, fs.depth,
                     fs.rho_water, fs.g))
        ofs += mem.ns
    for a in args:                                    # warm-up
        qs.member_qtf(*a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    parts = [qs.member_qtf(*a) for a in args]
    ev[1].record()
    torch.cuda.synchronize()
    member_ms = ev[0].elapsed_time(ev[1])
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    t0 = time.time()
    for a in args:
        qs.kim_yue_correction(a[0], beta, w2, k2, fs.depth, fs.rho_water,
                              fs.g)
    ky_s = time.time() - t0
    a = qs.member_qtf(*args[1], pair_chunk=997)
    check(torch.equal(a, parts[1]), "slow drift: member_qtf differs between "
          f"pair chunks of 997 and {qs.PAIR_CHUNK}")
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.time()
    q = m.qtf_slender(beta, Xi0=gold["Xi0"], device=DEVICE, timer=timer)
    torch.cuda.synchronize()
    wall = time.time() - t0
    stage_ms = timer.chunks()[0]
    q = q[:, :, 0, :]
    off = ~torch.eye(nw2, dtype=torch.bool, device=q.device)
    herm = torch.equal(q[off], torch.conj(q.transpose(0, 1))[off])
    check(herm, "slow drift: the QTF is not hermitian off the diagonal")
    check(bool(torch.all(torch.isfinite(torch.view_as_real(q)))),
          "slow drift: non-finite QTF")
    res = dict(bins=nw2, pairs=nw2 * (nw2 + 1) // 2,
               pair_chunk=qs.PAIR_CHUNK, members=len(args),
               member_qtf_ms=member_ms, member_peak_mib=peak_mib,
               kim_yue_host_s=ky_s, qtf_slender_wall_s=wall,
               qtf_slender_stage_ms=stage_ms, hermitian=herm,
               max_abs=float(q.abs().max()))
    print(f"  slow-drift slender QTF on {card}: {nw2} bins "
          f"({res['pairs']:,} pairs, chunks of {qs.PAIR_CHUNK}), "
          f"member_qtf of {len(args)} members {member_ms:.1f} device ms, "
          f"peak {peak_mib:.0f} MiB; kim_yue_correction {ky_s:.3f} host s; "
          f"Model.qtf_slender {wall:.2f} s wall (stage ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in stage_ms.items())
          + "); hermitian off the diagonal, bits equal at chunks of 997")
    return res


def phase_qtf(card):
    """Second-order forces (module docstring, phase 19): the
    external-QTF full evaluator on semi_wind_qtf (golden rows held, then
    QTF_ROWS operating rows with them first, timed per stage with the
    drift stage, Newton iterations of both equilibria, launches against
    the trips run), its two-heading golden rows, its geometry axis
    (golden rows held, QTF_GEOMETRY_ROWS rows); the slender-body QTF at
    the fixture grid held against the JAX goldens on the card; the
    slender-body QTF on the slow-drift grid (:func:`_slow_drift`)."""
    from raft_tpu_torch.api import (ENV_KEYS, FULL_OUT_KEYS, SEA_KEYS,
                                    make_full_evaluator)
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.utils import config

    pfx = "on_" if config.get("FUSED") == "on" else "off_"
    g = dict(np.load(os.path.join(FIX, "golden_semi_wind_qtf.npz")))
    m = Model(os.path.join(FIX, "design_semi_wind_qtf.json"))
    t0 = time.time()
    ev = make_full_evaluator(m, device=DEVICE)
    build_s = time.time() - t0
    check(ev.qtf is not None, "qtf: the design's .12d was not read")
    gold = _qtf_gold(g, "h1")
    n_gold = len(gold["Hs"])
    where = {"semi_wind_qtf": np.arange(n_gold)}
    out = {k: v.cpu().numpy() for k, v in ev(**full_rows(
        "semi_wind", gold, n_gold, QTF_SEED)).items()}
    worst = hold_goldens(out, where, {"semi_wind_qtf": gold}, pfx, "qtf",
                         keys=FULL_OUT_KEYS)
    out, wall, stage_ms, newton, newton_drift, launches, exp = \
        _timed_full_rows(ev, full_rows("semi_wind", gold, QTF_ROWS, QTF_SEED),
                         "qtf")
    for k, v in hold_goldens(out, where, {"semi_wind_qtf": gold}, pfx, "qtf",
                             keys=FULL_OUT_KEYS).items():
        worst[k] = max(worst[k], v)
    st = out["status"]
    total = sum(stage_ms.values())
    res = dict(rows=QTF_ROWS, build_s=build_s, wall_s=wall,
               evals_per_s=QTF_ROWS / wall,
               device_evals_per_s=QTF_ROWS / (total / 1e3),
               stage_ms=stage_ms, drift_share=stage_ms["drift"] / total,
               second_order_share=stage_ms["second_order"] / total,
               statics_share=(stage_ms["statics"] + stage_ms["drift"]) / total,
               newton_per_chunk=newton, drift_newton_per_chunk=newton_drift,
               launches=launches, expected_launches=exp,
               status_shares=_status_shares(st),
               F_2nd_mean_surge_max=float(np.abs(
                   out["F_2nd_mean"][..., 0]).max()),
               worst_rel={k.split(".", 1)[1]: v for k, v in worst.items()})
    print(f"qtf semi_wind_qtf on {card}: {QTF_ROWS} rows, nWaves 1, "
          f"{len(newton)} chunks in {wall:.2f} s = {res['evals_per_s']:.1f} "
          "full-evals/s; stage ms " + ", ".join(
              f"{s} {v:.1f}" for s, v in stage_ms.items())
          + f" (QTF forces {100 * res['second_order_share']:.2f}%, drift "
          f"{100 * res['drift_share']:.1f}%, both equilibria "
          f"{100 * res['statics_share']:.1f}%); Newton iterations per chunk "
          f"{newton}, drift {newton_drift}; solve kernel launches "
          f"{launches} (expected {exp}: trips + 1 per chunk); status-bit "
          f"shares {res['status_shares']}")
    print(f"  semi_wind_qtf goldens (gate {SLICE_TOL:g} x max; status, "
          "n_iter_drag, drag_converged equal): " + ", ".join(
              f"{k} {v:.1e}" for k, v in res["worst_rel"].items()))

    # two headings (one inside the QTF's span, one clipped), golden rows
    ev2 = make_full_evaluator(m, nWaves=2, device=DEVICE)
    gold2 = _qtf_gold(g, "h2")
    out = {k: v.cpu().numpy() for k, v in ev2(
        **{k: gold2[k] for k in ENV_KEYS + SEA_KEYS}).items()}
    res["h2_worst_rel"] = max(hold_goldens(
        out, where, {"semi_wind_qtf": gold2}, pfx, "qtf h2",
        keys=FULL_OUT_KEYS).values())

    # the geometry axis: the design's QTF for every row
    geo = make_full_evaluator(m, device=DEVICE, geometry=True)
    goldg = _qtf_gold(g, "geo")
    nm = geo.n_members
    out = {k: v.cpu().numpy() for k, v in geo(
        geom=geometry_rows(nm, n_gold, QTF_GEOMETRY_SEED, goldg),
        **full_rows("semi_wind", goldg, n_gold, QTF_GEOMETRY_SEED)).items()}
    gw = hold_goldens(out, where, {"semi_wind_qtf": goldg}, pfx,
                      "qtf geometry", keys=FULL_OUT_KEYS)
    out, gwall, gstage, gnewton, gdrift, glaunch, gexp = _timed_full_rows(
        geo, full_rows("semi_wind", goldg, QTF_GEOMETRY_ROWS,
                       QTF_GEOMETRY_SEED), "qtf geometry",
        geom=geometry_rows(nm, QTF_GEOMETRY_ROWS, QTF_GEOMETRY_SEED, goldg))
    for k, v in hold_goldens(out, where, {"semi_wind_qtf": goldg}, pfx,
                             "qtf geometry", keys=FULL_OUT_KEYS).items():
        gw[k] = max(gw[k], v)
    res["geometry"] = dict(
        rows=QTF_GEOMETRY_ROWS, wall_s=gwall,
        evals_per_s=QTF_GEOMETRY_ROWS / gwall, stage_ms=gstage,
        newton_per_chunk=gnewton, drift_newton_per_chunk=gdrift,
        launches=glaunch, expected_launches=gexp,
        worst_rel=max(gw.values()))
    print(f"  qtf geometry axis: {QTF_GEOMETRY_ROWS} rows in {gwall:.2f} s "
          f"= {res['geometry']['evals_per_s']:.1f} geometry-evals/s; stage "
          "ms " + ", ".join(f"{s} {v:.1f}" for s, v in gstage.items())
          + f"; Newton iterations per chunk {gnewton}, drift {gdrift}; "
          f"launches {glaunch} (expected {gexp}); goldens worst "
          f"{res['geometry']['worst_rel']:.1e}, two-heading goldens worst "
          f"{res['h2_worst_rel']:.1e}")

    # the slender-body QTF at the fixture grid, held
    sg = dict(np.load(os.path.join(FIX, "golden_qtf_slender.npz")))
    sm = Model(os.path.join(FIX, "design_semi_wind_slender.json"))
    slender = {}
    for which, Xi0 in (("fixed", None), ("rao", sg["Xi0"])):
        torch.cuda.synchronize()
        t0 = time.time()
        q = sm.qtf_slender(float(sg["beta"]), Xi0=Xi0, device=DEVICE)
        q = q.cpu().numpy()
        wall_s = time.time() - t0
        ref = sg[f"{which}_qtf"]
        scale = float(np.abs(ref).max())
        err = float(np.abs(q - ref).max())
        check(err <= SLICE_TOL * scale, f"qtf slender {which}: {err:.3e} > "
              f"{SLICE_TOL:g} x {scale:.3e}")
        slender[which] = dict(worst_rel=err / scale, wall_s=wall_s)
    res["slender"] = slender
    print(f"  slender QTF at the fixture grid ({len(sm.w1_2nd)} bins) on "
          f"{card}: fixed body {slender['fixed']['worst_rel']:.1e}, "
          f"RAO-driven {slender['rao']['worst_rel']:.1e} x max|qtf| of the "
          f"JAX goldens (gate {SLICE_TOL:g})")
    res["slow_drift"] = _slow_drift(sg, card)
    return res


#: the analyze phase's designs: golden set -> (design file, run_farm,
#: the cases run: None for the whole table, n for its first n)
ORCH_SETS = {
    "spar": ("design_spar.json", False, None),
    "semi": ("design_semi.json", False, None),
    "mhk": ("design_mhk.json", False, None),
    "semi_wind_cases": ("design_semi_wind_cases.json", False, None),
    "mhk_tidal": ("design_mhk_tidal.json", False, None),
    "mhk_tidal_cav": ("design_mhk_tidal_cav.json", False, None),
    "semi_wind_flex": ("design_semi_wind_flex.json", False, None),
    # a farm case pays its network solves at one row (45-56 s a case in
    # runs Z-AB): the first of its two cases keeps the script inside its
    # limit at the earlier phases' full depth
    "farm_semi_wind": ("design_farm_semi_wind_cases.json", True, 1),
    "semi_wind_wamit": ("design_semi_wind_wamit.json", False, None),
    "semi_wind_qtf": ("design_semi_wind_qtf.json", False, None),
    "semi_wind_slender": ("design_semi_wind_slender.json", False, None),
    "semi_wind_moor1": ("design_semi_wind_moor1.json", False, None),
    "semi_wind_moor2": ("design_semi_wind_moor2.json", False, None),
}
#: the designs whose system response is captured: the kernel is held
#: bit-equal to its plain version on it (N = 6 and N = 12)
ORCH_CAPTURE = ("spar", "farm_semi_wind")


def _sync():
    if str(DEVICE).startswith("cuda"):
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def _test_module(name):
    """tests/<name>.py, imported by its path (on some machines a site
    package named ``tests`` shadows the repository's) and once: the CPU
    tests' goldens and gates, which the grad, grad_paths, analyze and
    omdao phases hold the card to."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _orch_gates():
    return _test_module("test_torch_orchestrated")


def _held(what, fn, *a, phase="analyze", **k):
    """A gate of the CPU tests, its assertion a phase failure here."""
    try:
        return fn(*a, **k)
    except AssertionError as e:
        raise PhaseError(f"{phase} {what}: {e}") from None


def phase_analyze(out_dir, card):
    """The orchestrated path (module docstring, phase 20): every
    orchestrated design through drivers.run (run_farm for the farm) on
    the card, held against golden_orch_*.npz by the CPU tests' own gates
    (tests/test_torch_orchestrated.py); per design cases/s, the per-case
    statics / dynamics / outputs wall split, Newton iterations and the
    solve kernel's launches on the path against the fixed-point solves
    run; then calc_outputs held (properties, eigen); one CLI run on the
    card, its CSV held; the kernel on the captured system responses
    (N = 6 and N = 12) bit-equal to its plain version."""
    import raft_tpu_torch.models.dynamics as dyn
    from raft_tpu_torch import drivers
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    orch = _orch_gates()
    res = dict(designs={}, launches=0, row_launches=0)
    captured = {}
    system_response = dyn.system_response

    def capture(tag):
        def response(Z, F):
            captured.setdefault(tag, (Z.clone(), F.clone()))
            return system_response(Z, F)
        return response

    chunk = max(1, config.get("SCAN_CHUNK"))
    t_phase = time.time()
    # the CLI on the card, beside the designs (its CSV held below)
    cli_csv = os.path.join(out_dir, "cli_spar.csv")
    cli_err = os.path.join(out_dir, "cli_spar.err")
    with open(cli_err, "w") as err:
        cli = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch",
             os.path.join(FIX, "design_spar.json"), "--csv", cli_csv],
            cwd=HERE, stdout=subprocess.DEVNULL, stderr=err)
    CHILDREN.append(cli)
    cli_done = []
    threading.Thread(target=lambda: cli_done.append(
        (cli.wait(), time.time())), daemon=True).start()
    for name, (fn, farm, n_cases) in ORCH_SETS.items():
        g = orch.golden(name)
        src = os.path.join(FIX, fn)
        flex = name.endswith("flex")
        if name == "semi_wind_slender" or n_cases is not None:
            with open(src) as f:
                src = json.load(f)
            if name == "semi_wind_slender":
                src["platform"]["outFolderQTF"] = os.path.join(out_dir, "qtf")
            if n_cases is not None:
                src["cases"]["data"] = src["cases"]["data"][:n_cases]
                g = orch.golden_cases(g, n_cases)
            if "file" in src.get("array_mooring", {}):
                # a design given as a dict resolves no relative data path
                src["array_mooring"]["file"] = os.path.join(
                    FIX, src["array_mooring"]["file"])
        if name in ORCH_CAPTURE:
            dyn.system_response = capture(name)
        linsolve.reset_launches()
        _sync()
        t0 = time.time()
        model = (drivers.run_farm if farm else drivers.run)(src,
                                                            device=DEVICE)
        _sync()
        wall = time.time() - t0
        launches = linsolve.KERNEL_LAUNCHES
        rows = linsolve.ROW_KERNEL_LAUNCHES
        dyn.system_response = system_response
        stats = model.case_stats
        # kernel solves the path must have made: each FOWT's fixed-point
        # solves at N <= 12 and the system response at N <= 12
        exp = sum(sum(s for s, fs in zip(c["fixed_point_solves"],
                                         model.fowtList) if fs.nDOF <= 12)
                  + (c["system_n"] <= 12) for c in stats)
        check(launches == exp, f"analyze {name}: solve kernel launched "
              f"{launches} times, expected {exp}")
        exp_rows = sum(7 <= c["system_n"] <= 12 for c in stats)
        check(rows == exp_rows, f"analyze {name}: the N = 7-12 design "
              f"launched {rows} times, expected {exp_rows}")
        # the trips a lone row runs: whole blocks of SCAN_CHUNK up to its
        # n_iter_drag (one fixed point per FOWT without a slender QTF)
        if model.w1_2nd is None:
            for c, dd in zip(stats, model.results["dyn_diag"]):
                for s, d_i in zip(c["fixed_point_solves"], dd):
                    cap = model.nIter + 1 + model.nIterExtra
                    trips = min(-(-d_i["n_iter_drag"] // chunk) * chunk, cap)
                    check(s == trips + 1, f"analyze {name}: {s} fixed-point "
                          f"solves, expected {trips + 1}")
        worst = _held(name, orch.hold_results, model, g, flex=flex)
        csv = os.path.join(out_dir, f"analyze_{name}.csv")
        drivers.save_responses(model, csv)
        with open(csv) as f:
            _held(f"{name} CSV", orch.hold_csv, f.read(), g["csv"].item())
        out_s = None
        if not farm:
            t1 = time.time()
            model.calc_outputs(device=DEVICE)
            out_s = time.time() - t1
            worst = max(worst, _held(f"{name} outputs", orch.hold_outputs,
                                     model, g, flex=flex))
        n = len(stats)
        split = {k: float(np.mean([c[k] for c in stats]))
                 for k in ("statics_s", "dynamics_s", "outputs_s")}
        r = dict(cases=n, wall_s=wall, cases_per_s=n / wall,
                 per_case_s=split,
                 newton_iterations=[c["newton_iterations"] for c in stats],
                 fixed_point_solves=[c["fixed_point_solves"] for c in stats],
                 system_n=stats[0]["system_n"], launches=launches,
                 expected_launches=exp, row_launches=rows,
                 calc_outputs_s=out_s, worst_rel=worst)
        res["designs"][name] = r
        res["launches"] += launches
        res["row_launches"] += rows
        print(f"analyze {name} on {card}: {n} case(s) in {wall:.2f} s = "
              f"{r['cases_per_s']:.2f} cases/s; per case statics "
              f"{split['statics_s']:.2f} s, dynamics {split['dynamics_s']:.2f}"
              f" s, outputs {split['outputs_s']:.2f} s; Newton iterations "
              f"{r['newton_iterations']}; solve kernel launches {launches} "
              f"(expected {exp}: the fixed-point solves "
              f"{r['fixed_point_solves']} at N <= 12 + the system response "
              f"at N = {r['system_n']}{' (library)' if r['system_n'] > 12 else ''}"
              f"), {rows} on the N = 7-12 design; worst {worst:.1e} of "
              f"the golden gates")

    # the CLI run: its exit and its CSV
    cli.wait(timeout=600)
    while not cli_done:
        time.sleep(0.01)
    res["cli_s"] = cli_done[0][1] - t_phase
    with open(cli_err) as f:
        check(cli.returncode == 0, f"analyze CLI: exit {cli.returncode}: "
              f"{f.read()[-800:]}")
    with open(cli_csv) as f:
        _held("CLI CSV", orch.hold_csv, f.read(),
              orch.golden("spar")["csv"].item())

    # the kernel on the captured cases: bit-equal to its plain version,
    # the thread-per-system entry at N = 6, the lane-per-row one at 12
    res["captured"] = {}
    for tag, solve in (("spar", linsolve._cuda_solve),
                       ("farm_semi_wind", linsolve._cuda_solve_rows)):
        Z, F = captured[tag]
        Ft = F.transpose(-1, -2).contiguous()
        x_k = solve(Z, Ft)
        x_p = linsolve._native_solve(Z, Ft)
        check(torch.equal(x_k, x_p), f"analyze: the kernel on the captured "
              f"{tag} case (N = {Z.shape[-1]}) is not bit-equal to its "
              "plain version")
        res["captured"][tag] = [list(Z.shape), list(F.shape)]
    res["phase_s"] = time.time() - t_phase
    total = sum(r["cases"] for r in res["designs"].values())
    print(f"  analyze: {total} cases over {len(ORCH_SETS)} designs in "
          f"{res['phase_s']:.1f} s; solve kernel launches on the path "
          f"{res['launches']} ({res['row_launches']} on the N = 7-12 "
          f"design); CLI spar on the card {res['cli_s']:.1f} s (beside the "
          "designs), CSV held; "
          "captured system responses " + ", ".join(
              f"{t} Z {tuple(z)} / F {tuple(f)}"
              for t, (z, f) in res["captured"].items())
          + ": kernel bit-equal to the plain version")
    return res


#: the omdao phase's DesignEvaluation sets (of tests/test_torch_omdao.py
#: SETS): the spar (first call, repeat, override) and its host route, and
#: the rotor, moorMod 1 and flexible designs.  The farm, the 4-case table
#: and the WAMIT-file design are held by the CPU tests only: a farm case
#: pays its network solves at one row (about 36 s a chunk, PERF.md §5)
OMDAO_SETS = ("spar", "spar_host", "semi_wind", "semi_wind_moor1",
              "semi_wind_flex")


def _host_launches(model):
    """Solve-kernel launches an analyze_cases run must have made: each
    FOWT's fixed-point solves at N <= 12 and the system response at
    N <= 12, per case (as the analyze phase counts them)."""
    return sum(sum(s for s, fs in zip(c["fixed_point_solves"],
                                      model.fowtList) if fs.nDOF <= 12)
               + (c["system_n"] <= 12) for c in model.case_stats)


def phase_omdao(card):
    """The design-optimisation surface (module docstring, phase 21): each
    set of OMDAO_SETS through DesignEvaluation on the card (compute, a
    repeat that must hit the result cache, the spar's override), held
    against golden_omdao_*.npz by the gates of tests/test_torch_omdao.py
    (imported by path), its route the golden's; the solve kernel's
    launches per call against the evaluator's trips (full route), none
    (flexible route, N = 168) or analyze_cases' fixed-point solves (host
    route and override), 0 on every cache-hit repeat with no evaluator
    call; then RAFT_OMDAO_Core on weis_semi_wind (build_design exactly,
    compute at the gates, launches against its analyze_cases) and the
    spar's catenary points against golden_omdao_plotting.npz."""
    from raft_tpu_torch import plotting
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.utils import config

    gates = _test_module("test_torch_omdao")
    res = dict(sets={}, launches=0)
    chunk = max(1, config.get("SCAN_CHUNK"))
    fused = config.get("FUSED") == "on"
    t_phase = time.time()

    def timed(fn, *a):
        linsolve.reset_launches()
        _sync()
        t0 = time.time()
        out = fn(*a)
        _sync()
        return out, time.time() - t0, linsolve.KERNEL_LAUNCHES

    for name in OMDAO_SETS:
        g = gates.golden(name)
        ev = gates.evaluation(name, device=DEVICE)
        (model, evaluate, route), build_s, n0 = timed(ev._fast_model)
        check(route == str(g["route"]), f"omdao {name}: route {route}, the "
              f"reference took {g['route']}")
        check(n0 == 0, f"omdao {name}: {n0} launches building the model")
        trips = []
        if evaluate is not None:
            def counted(evaluate=evaluate, **rows):
                out = evaluate(**rows)
                trips.append(int(out["n_iter_drag"][0]))
                return out
            ev._fast = (model, counted, route)
        _, _, override = gates.SETS[name]
        calls = [("first", None), ("repeat", None)]
        if override:
            calls.append(("override", override))
        r = dict(route=route, build_s=build_s, calls={})
        for tag, ov in calls:
            n_ev = ev.n_evaluations
            del trips[:]
            out, wall, launches = timed(ev.compute, ov)
            _held(f"{name} {tag}", gates.hold_compute, out, g, tag,
                  flex=name.endswith("flex"), phase="omdao")
            _held(f"{name} {tag} diag", gates.hold_diag, ev.diag, g, tag,
                  phase="omdao")
            if tag == "override":
                exp = _host_launches(ev.model)
            elif tag == "repeat":
                exp = 0
                check(ev.n_evaluations == n_ev, f"omdao {name}: the repeat "
                      "call ran the evaluator")
            elif route == "full":
                cap = evaluate.body.n_iter * max(
                    int(config.get("ITER_SCALE")), 1) + 1 \
                    + max(int(evaluate.body.n_iter_extra), 0)
                exp = sum(expected_launches([n], 1, cap, min(chunk, cap),
                                            fused) for n in trips)
            elif route == "flexible":
                exp = 0
            else:
                exp = _host_launches(model)
            check(launches == exp, f"omdao {name} {tag}: solve kernel "
                  f"launched {launches} times, expected {exp}")
            r["calls"][tag] = dict(wall_s=wall, launches=launches,
                                   evaluations=ev.n_evaluations - n_ev,
                                   n_iter_drag=list(trips))
            res["launches"] += launches
        res["sets"][name] = r
        print(f"omdao {name} on {card}: route {route}; " + ", ".join(
            f"{t} {c['wall_s']:.2f} s ({c['launches']} launches, "
            f"{c['evaluations']} evaluator calls)"
            for t, c in r["calls"].items())
            + f"; model + evaluator build {build_s:.2f} s; held, diag "
            "equal")

    # the WEIS flat-I/O core
    s = gates.weis_set("weis_semi_wind")
    g = gates.golden("weis_semi_wind")
    core = gates.weis_core(s, device=DEVICE)
    design, build_s, _ = timed(core.build_design, s["inputs"],
                               s["discrete_inputs"])
    _held("weis build_design", gates.hold_weis_design, design,
          core.case_mask, g, phase="omdao")
    out, wall, launches = timed(core.compute, s["inputs"],
                                s["discrete_inputs"])
    _held("weis compute", gates.hold_weis_compute, out, g, phase="omdao")
    exp = _host_launches(core.model)
    check(launches == exp, f"omdao weis_semi_wind: solve kernel launched "
          f"{launches} times, expected {exp}")
    res["launches"] += launches
    res["weis"] = dict(build_s=build_s, compute_s=wall, launches=launches,
                       cases=len(core.model.cases))
    print(f"omdao weis_semi_wind on {card}: build_design {build_s * 1e3:.1f}"
          f" ms (exactly the reference's), compute {wall:.2f} s over "
          f"{len(core.model.cases)} cases ({launches} launches); held")

    # the spar's catenary points (tests/test_torch_plotting.py holds
    # them within 1e-10 x the polyline's largest coordinate; that module
    # imports matplotlib, which this machine may lack)
    gp = np.load(os.path.join(FIX, "golden_omdao_plotting.npz"))
    from raft_tpu_torch.models.model import Model

    m = Model(os.path.join(FIX, "design_spar.json"))
    fs, ms = m.fowtList[0], m.ms_list[0]
    off = np.array([fs.x_ref, fs.y_ref, 0.0])
    t0 = time.time()
    for il in range(ms.n_lines):
        pts = plotting._catenary_points(ms.r_anchor[il], off + ms.r_fair0[il],
                                        ms.L[il], ms.w[il], ms.EA[il],
                                        device=DEVICE)
        want = gp[f"spar_line{il}"]
        err = float(np.max(np.abs(pts - want)))
        check(pts.shape == want.shape and err <= SLICE_TOL * float(
            np.max(np.abs(want))), f"omdao: the spar's line {il} catenary "
            f"points off by {err:.3e}")
    res["catenary_points_s"] = time.time() - t0
    res["phase_s"] = time.time() - t_phase
    print(f"  omdao: {len(OMDAO_SETS)} sets and the WEIS core in "
          f"{res['phase_s']:.1f} s; solve kernel launches "
          f"{res['launches']}; the spar's {ms.n_lines} catenary polylines "
          f"held in {res['catenary_points_s']:.2f} s")
    return res



def _jsonl_since(path, start):
    """Events of a JSONL capture from line ``start`` on, and its length."""
    with open(path) as f:
        lines = f.readlines()
    return [json.loads(x) for x in lines[start:] if x.strip()], len(lines)


def _sweep_hold(out, ref, tag, keys):
    """``out`` against ``ref``: bit-equal (True), or floats within
    SLICE_TOL x max (False); integer keys always equal."""
    same = all(np.array_equal(out[k], ref[k]) for k in keys)
    if not same:
        for k in keys:
            a, b = out[k], ref[k]
            if k in EXACT:
                check(np.array_equal(a, b), f"sweep {tag}: {k} differs")
                continue
            scale = float(np.max(np.abs(b)))
            err = float(np.max(np.abs(a - b)))
            check(err <= SLICE_TOL * scale, f"sweep {tag}: {k} off by "
                  f"{err:.3e} > {SLICE_TOL:g} x {scale:.3e}")
    return same


def phase_sweep(ev, models, out_dir, card):
    """Checkpointed, fault-tolerant sweeps on the card (module docstring,
    phase 22); ``ev`` is the full phase's semi_wind evaluator."""
    from raft_tpu_torch.api import make_case_evaluator
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel import resilience
    from raft_tpu_torch.parallel import sweep as ts
    from raft_tpu_torch.utils import config, faults

    t_phase = time.time()
    fused = config.get("FUSED") == "on"
    keys = ("PSD", "X0", "status", "n_iter_drag")
    base = os.path.join(out_dir, "sweep")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    log = os.path.join(base, "events.jsonl")
    prev_log = os.environ.get("RAFT_TPU_LOG")
    os.environ["RAFT_TPU_LOG"] = log
    writes = []
    atomic_savez = resilience.atomic_savez

    def timed_savez(path, **arrays):
        t0 = time.time()
        try:
            atomic_savez(path, **arrays)
        finally:
            writes.append(time.time() - t0)

    resilience.atomic_savez = timed_savez
    try:
        gold = dict(np.load(os.path.join(FIX, "golden_full_semi_wind.npz")))
        p = full_rows("semi_wind", gold, SWEEP_ROWS, SWEEP_SEED)
        res = dict(rows=SWEEP_ROWS, shard=SWEEP_SHARD)

        # the plain evaluator call on the same rows
        _sync()
        t0 = time.time()
        plain = {k: v.cpu().numpy() for k, v in ev(**p).items()
                 if k in keys}
        res["plain_s"] = time.time() - t0

        # 1. the checkpointed sweep on the mesh resolve_mesh gives
        linsolve.reset_launches()
        t0 = time.time()
        mesh = resilience.resolve_mesh(ts.make_mesh)
        res["resolve_mesh_s"] = time.time() - t0
        check(mesh.devices.size == torch.cuda.device_count(),
              f"sweep: resolve_mesh gave {mesh}")
        if mesh.devices.size > 1:  # one card, as the contract asks
            mesh = ts.make_mesh(1)
        del writes[:]
        t0 = time.time()
        out1 = ts.run_sweep_checkpointed_full(
            ev, p, os.path.join(base, "clean"), shard_size=SWEEP_SHARD,
            mesh=mesh, out_keys=keys)
        res["sweep_s"] = time.time() - t0
        res["write_s"] = list(writes)
        launches = linsolve.KERNEL_LAUNCHES
        cap = ev.body.n_iter * max(int(config.get("ITER_SCALE")), 1) + 1 \
            + max(int(ev.body.n_iter_extra), 0)
        chunk_rows = min(int(config.get("BUCKET_ROWS")) or SWEEP_SHARD,
                         SWEEP_SHARD)
        exp = sum(expected_launches(
            out1["n_iter_drag"][a:a + SWEEP_SHARD], chunk_rows, cap,
            min(max(1, config.get("SCAN_CHUNK")), cap), fused)
            for a in range(0, SWEEP_ROWS, SWEEP_SHARD))
        check(launches == exp, f"sweep: solve kernel launched {launches} "
              f"times in the checkpointed sweep, expected {exp}")
        res["bits_equal_plain"] = _sweep_hold(out1, plain, "vs plain", keys)
        for k in ("PSD", "X0"):
            check(np.all(np.isfinite(out1[k])), f"sweep: non-finite {k}")
        res["launches"] = launches
        res["expected_launches"] = exp

        # 2. a crash by an injected truncation of shard 2, then the resume
        crash = os.path.join(base, "crash")
        armed = []

        def arm_truncation(done, total, fresh):
            if done == 2 and not armed:
                armed.append(faults.inject("truncate:shard_write:1"))
                armed[0].__enter__()

        _, n0 = _jsonl_since(log, 0)
        linsolve.reset_launches()
        try:
            ts.run_sweep_checkpointed_full(
                ev, p, crash, shard_size=SWEEP_SHARD, mesh=mesh,
                out_keys=keys, on_shard=arm_truncation)
            raise PhaseError("sweep: the injected truncation did not crash "
                             "the sweep")
        except faults.InjectedFault:
            pass
        finally:
            for a in armed:
                a.__exit__(None, None, None)
        launches += linsolve.KERNEL_LAUNCHES
        try:
            resilience.load_shard(os.path.join(crash, "shard_0002.npz"),
                                  keys)
            raise PhaseError("sweep: shard 2 is not truncated")
        except resilience.ShardCorruptError:
            pass
        _, n1 = _jsonl_since(log, n0)
        linsolve.reset_launches()
        t0 = time.time()
        out2 = ts.run_sweep_checkpointed_full(
            ev, p, crash, shard_size=SWEEP_SHARD, mesh=mesh, out_keys=keys)
        res["resume_s"] = time.time() - t0
        launches += linsolve.KERNEL_LAUNCHES
        evs, _ = _jsonl_since(log, n1)
        corrupt = [e["shard"] for e in evs if e["event"] == "shard_corrupt"]
        resumed = [e["shard"] for e in evs if e["event"] == "shard_resume"]
        ran = [e["shard"] for e in evs if e["event"] == "shard_start"]
        check(corrupt == [2] and resumed == [0, 1] and ran == [2, 3],
              f"sweep: the resume found corrupt {corrupt}, resumed "
              f"{resumed}, ran {ran}")
        check(all(np.array_equal(out2[k], out1[k]) for k in keys),
              "sweep: the resumed sweep differs from the uninterrupted one")
        res["resume"] = dict(corrupt=corrupt, resumed=resumed, ran=ran)

        # 3. a transient fault on shard 0, an OOM on shard 1
        half = {k: v[:2 * SWEEP_SHARD] for k, v in p.items()}
        armed = []

        def arm_oom(done, total, fresh):
            if done == 1 and not armed:
                armed.append(faults.inject("oom:shard_eval:1"))
                armed[0].__enter__()

        _, n2 = _jsonl_since(log, 0)
        linsolve.reset_launches()
        try:
            with faults.inject("transient:shard_eval:1"):
                out3 = ts.run_sweep_checkpointed_full(
                    ev, half, os.path.join(base, "faults"),
                    shard_size=SWEEP_SHARD, mesh=mesh, out_keys=keys,
                    backoff_s=0.05, on_shard=arm_oom)
        finally:
            for a in armed:
                a.__exit__(None, None, None)
        launches += linsolve.KERNEL_LAUNCHES
        evs, _ = _jsonl_since(log, n2)
        retries = [(e["shard"], e["attempt"]) for e in evs
                   if e["event"] == "shard_retry"]
        splits = [(e["shard"], e["split"]) for e in evs
                  if e["event"] == "shard_oom_split"]
        check(retries == [(0, 1)], f"sweep: retries {retries}")
        check(splits == [(1, [SWEEP_SHARD // 2] * 2)],
              f"sweep: OOM splits {splits}")
        res["faults"] = dict(retries=retries, oom_splits=splits,
                             bits_equal=_sweep_hold(
                                 out3, {k: v[:2 * SWEEP_SHARD]
                                        for k, v in out1.items()},
                                 "faults", keys))

        # 4. the three demos over a two-entry mesh
        mesh1 = ts.make_mesh(device=DEVICE)
        mesh2 = ts.make_mesh(2, device=DEVICE)
        rng = np.random.default_rng(SWEEP_SEED + 1)
        res["cases"] = {}
        res["two_entries"] = [str(d) for d in mesh2.devices.flat]
        from raft_tpu_torch.structure import bucketing as bk

        linsolve.reset_launches()
        for n in DESIGNS:
            ce = make_case_evaluator(models[n], device=DEVICE)
            lo, hi = DOE_BOX["Hs"], DOE_BOX["Tp"]
            sea = (rng.uniform(*lo, SWEEP_CASE_ROWS),
                   rng.uniform(*hi, SWEEP_CASE_ROWS),
                   rng.uniform(*DOE_BOX["beta"], SWEEP_CASE_ROWS))
            t0 = time.time()
            o1 = ts.sweep_cases(ce, *sea, mesh=mesh1, out_keys=bk.OUT_KEYS)
            t1 = time.time()
            o2 = ts.sweep_cases(ce, *sea, mesh=mesh2, out_keys=bk.OUT_KEYS)
            t2 = time.time()
            check(all(np.array_equal(o1[k], o2[k]) for k in bk.OUT_KEYS),
                  f"sweep: sweep_cases of {n} on two entries differs from "
                  "one entry")
            res["cases"][n] = dict(one_entry_s=t1 - t0, two_entries_s=t2 - t1)
        launches += linsolve.KERNEL_LAUNCHES

        # a twin of a CPU-built evaluator on the card
        factory, args, kw = ev._raft_factory
        cpu_ev = factory(*args, **dict(kw, device="cpu"))
        twin = ts.bind_evaluator(cpu_ev, torch.device(DEVICE))
        few = {k: v[:64] for k, v in p.items()}
        linsolve.reset_launches()
        a = {k: v.cpu().numpy() for k, v in twin(**few).items()}
        b = {k: v.cpu().numpy() for k, v in ev(**few).items()}
        launches += linsolve.KERNEL_LAUNCHES
        check(twin is not cpu_ev
              and twin.device.type == torch.device(DEVICE).type
              and all(np.array_equal(a[k], b[k]) for k in a),
              "sweep: the twin of a CPU-built evaluator differs from the "
              "card's own")

        # 5. the sharded slender-body QTF at the slow-drift grid
        sg = np.load(os.path.join(FIX, "golden_qtf_slender.npz"))
        with open(os.path.join(FIX, "design_semi_wind_slender.json")) as f:
            d = json.load(f)
        d["platform"].update(SLOW_DRIFT_GRID)
        m = Model(d)
        beta = float(sg["beta"])
        _sync()
        t0 = time.time()
        ref = m.qtf_slender(beta, Xi0=sg["Xi0"], device=DEVICE).cpu().numpy()
        t1 = time.time()
        got = ts.qtf_slender_sharded(m, beta, Xi0=sg["Xi0"], mesh=mesh2)
        t2 = time.time()
        scale = float(np.max(np.abs(ref)))
        err = float(np.max(np.abs(got - ref)))
        check(got.shape == ref.shape and err <= SLICE_TOL * scale,
              f"sweep: qtf_slender_sharded off by {err:.3e} > "
              f"{SLICE_TOL:g} x {scale:.3e}")
        res["qtf"] = dict(bins=len(m.w1_2nd), unsharded_s=t1 - t0,
                          sharded_s=t2 - t1, rel_err=err / scale)
    finally:
        resilience.atomic_savez = atomic_savez
        if prev_log is None:
            os.environ.pop("RAFT_TPU_LOG", None)
        else:
            os.environ["RAFT_TPU_LOG"] = prev_log
    res["launches"] = launches
    res["rows_per_s"] = SWEEP_ROWS / res["sweep_s"]
    res["plain_rows_per_s"] = SWEEP_ROWS / res["plain_s"]
    res["phase_s"] = time.time() - t_phase
    w = res["write_s"]
    print(f"sweep on {card}: run_sweep_checkpointed_full of semi_wind, "
          f"{SWEEP_ROWS} rows in shards of {SWEEP_SHARD}: "
          f"{res['sweep_s']:.2f} s = {res['rows_per_s']:.1f} rows/s "
          f"against the plain call's {res['plain_rows_per_s']:.1f} rows/s "
          f"({res['plain_s']:.2f} s); resolve_mesh (probe) "
          f"{res['resolve_mesh_s']:.2f} s; shard writes "
          f"{min(w) * 1e3:.1f}-{max(w) * 1e3:.1f} ms; "
          f"{'bits equal' if res['bits_equal_plain'] else 'within 1e-10'} "
          f"to the plain call; launches {res['expected_launches']} "
          f"(= trips + 1 per shard)")
    print(f"  sweep on {card}: crash at shard 2 then resume "
          f"{res['resume_s']:.2f} s (resumed {res['resume']['resumed']}, "
          f"recomputed {res['resume']['corrupt']}, ran "
          f"{res['resume']['ran']}), bit-identical; transient retry "
          f"{res['faults']['retries']}, OOM split "
          f"{res['faults']['oom_splits']} "
          f"({'bits equal' if res['faults']['bits_equal'] else 'within 1e-10'}"
          f"); sweep_cases of the demos on {res['two_entries']} bit-equal "
          "to one entry (" + ", ".join(
              f"{n} {c['one_entry_s']:.2f}/{c['two_entries_s']:.2f} s"
              for n, c in res["cases"].items())
          + f"); qtf_slender_sharded at {res['qtf']['bins']} bins "
          f"{res['qtf']['sharded_s']:.2f} s (unsharded "
          f"{res['qtf']['unsharded_s']:.2f} s), rel err "
          f"{res['qtf']['rel_err']:.1e}; ge_solve launches "
          f"{res['launches']}; phase {res['phase_s']:.1f} s")
    return res


def _fabric_events(log_dir):
    """Every record of a RAFT_TPU_LOG directory's per-process shards."""
    evs = []
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".jsonl"):
            evs += _jsonl_since(os.path.join(log_dir, name), 0)[0]
    return evs


def _fabric_ledger(sweep_dir):
    """The fleet kernel ledger and per-worker rows of an assembled
    fabric sweep (its metrics.json)."""
    with open(os.path.join(sweep_dir, "metrics.json")) as f:
        snap = json.load(f)
    return ({r["key"]: r["dispatches"] for r in snap["programs"]},
            {w: st["shards_done"] for w, st in snap["workers"].items()})


def phase_fabric(out_dir, card):
    """The elastic sweep fabric on the card (module docstring, phase
    23)."""
    from raft_tpu_torch.obs import runs
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel import fabric, resilience
    from raft_tpu_torch.parallel import sweep as ts

    t_phase = time.time()
    on_card = str(DEVICE).startswith("cuda")
    where = "cuda" if on_card else "cpu"
    if on_card:
        torch.cuda.empty_cache()   # earlier phases' cached blocks
    keys = ("PSD", "X0", "status", "n_iter_drag")
    base = os.path.join(out_dir, "fabric")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    entry = "raft_tpu_torch.parallel.fabric:demo_entry"
    kw = {"n": FABRIC_ROWS, "seed": FABRIC_SEED, "out_keys": list(keys)}
    env_keys = ("RAFT_TPU_LOG", "RAFT_TPU_RUNS_DIR", "RAFT_TPU_FAULTS",
                "RAFT_TPU_FABRIC_TTL_S", "RAFT_TPU_FABRIC_POLL_S",
                "RAFT_TPU_AOT", "RAFT_TPU_AOT_DIR")
    saved = {k: os.environ.get(k) for k in env_keys}
    res = dict(rows=FABRIC_ROWS, shard=FABRIC_SHARD, workers=FABRIC_WORKERS)
    try:
        os.environ["RAFT_TPU_FABRIC_POLL_S"] = "0.1"
        # the entry and its serial checkpointed sweep in this process
        ent = fabric.resolve_entry(entry, dict(kw, device=DEVICE))
        cases = ent["cases"]
        linsolve.reset_launches()
        t0 = time.time()
        serial = resilience.run_checkpointed(
            ent["compute"], cases, os.path.join(base, "serial"),
            FABRIC_SHARD, ts.make_mesh(1, device=None if on_card else "cpu"),
            keys)
        res["serial_s"] = time.time() - t0
        res["serial_launches"] = linsolve.KERNEL_LAUNCHES
        for k in ("PSD", "X0"):
            check(np.all(np.isfinite(serial[k])), f"fabric: non-finite {k}")

        def same(out, tag):
            for k in keys:
                check(np.array_equal(out[k], serial[k]),
                      f"fabric {tag}: {k} differs from the serial sweep")

        # (a) two workers on cuda:0
        logs_a = os.path.join(base, "logs_a") + os.sep
        store = os.path.join(base, "runs")
        os.environ["RAFT_TPU_LOG"] = logs_a
        os.environ["RAFT_TPU_RUNS_DIR"] = store
        dir_a = os.path.join(base, "a")
        linsolve.reset_launches()
        t0 = time.time()
        out_a = fabric.run_fabric(
            dir_a, FABRIC_WORKERS, entry, cases=cases, entry_kwargs=kw,
            out_keys=keys, shard_size=FABRIC_SHARD, device=where)
        res["fabric_s"] = time.time() - t0
        check(linsolve.KERNEL_LAUNCHES == 0,
              "fabric: the coordinator launched the kernel")
        same(out_a, "(a)")
        evs = _fabric_events(logs_a)
        exits = {e["worker"]: e["returncode"] for e in evs
                 if e["event"] == "fabric_worker_exit"}
        check(exits == {f"w{i}": 0 for i in range(FABRIC_WORKERS)},
              f"fabric (a): worker exit codes {exits}")
        res["startup_s"] = {e["worker"]: e["startup_s"] for e in evs
                            if e["event"] == "fabric_worker_start"}
        res["first_shard_s"] = _first_shards(evs)
        res["worker_devices"] = sorted({e["device"] for e in evs if
                                        e["event"] == "fabric_worker_start"})
        prog_a, res["shards_by_worker"] = _fabric_ledger(dir_a)
        res["launches_a"] = prog_a.get("ge_solve", 0)
        check(res["launches_a"] == res["serial_launches"] > 0,
              f"fabric (a): the workers launched the kernel "
              f"{res['launches_a']} times, the serial sweep "
              f"{res['serial_launches']}")
        check(set(prog_a) == {"ge_solve"},
              f"fabric (a): unexpected kernel entries {prog_a}")

        # (c) the run record and the obs CLI over the first run
        recs = [r for _, r in runs.list_records(store)
                if r.get("extra", {}).get("n_workers") == FABRIC_WORKERS]
        check(len(recs) == 1 and recs[0]["kind"] == "sweep",
              f"fabric: {len(recs)} fabric run record(s) in {store}")
        res["record_env"] = {k: recs[0]["env"].get(k)
                             for k in ("platform", "device_kind",
                                       "n_devices", "torch", "cuda")}
        for argv in (["runs", "list", "--dir", store],
                     ["trace", "--merge", logs_a, "--check", "-o",
                      os.path.join(base, "trace_a.json")]):
            p = subprocess.run(
                [sys.executable, "-m", "raft_tpu_torch.obs"] + argv,
                capture_output=True, text=True, timeout=120, cwd=HERE)
            check(p.returncode == 0, f"fabric: obs {argv[0]} exited "
                  f"{p.returncode}: {(p.stdout + p.stderr)[-400:]}")
        res["trace_check"] = p.stdout.strip()

        # (b) the same run with the entry's AOT warm-up spec (a shard's
        # worth of the spar case program before the first claim, under
        # RAFT_TPU_AOT=load into a fresh bank both workers share) and
        # worker 0 SIGKILLed at its first claim: its lease expires and
        # worker 1 steals it.  Both workers do the same work up to their
        # first claim (their start-ups agree within tens of ms), so
        # worker 0 claims one before worker 1 can finish the sweep.  The
        # warm-up's launches, predicted by the same rows in this process
        rng = np.random.default_rng(0)              # warmup_model's rows
        l0 = linsolve.forward_launches()
        ent["compute"]({"Hs": rng.uniform(2.0, 8.0, FABRIC_SHARD),
                        "Tp": rng.uniform(6.0, 14.0, FABRIC_SHARD),
                        "beta": rng.uniform(-0.5, 0.5, FABRIC_SHARD)},
                       ts.make_mesh(1, device=None if on_card else "cpu"))
        res["warmup_launches_want"] = linsolve.forward_launches() - l0
        del os.environ["RAFT_TPU_RUNS_DIR"]
        logs_b = os.path.join(base, "logs_b") + os.sep
        os.environ["RAFT_TPU_LOG"] = logs_b
        os.environ["RAFT_TPU_FAULTS"] = "worker_kill:worker_shard:1"
        os.environ["RAFT_TPU_FABRIC_TTL_S"] = str(FABRIC_TTL_S)
        os.environ["RAFT_TPU_AOT"] = "load"
        os.environ["RAFT_TPU_AOT_DIR"] = os.path.join(base, "bank_b")
        dir_b = os.path.join(base, "b")
        t0 = time.time()
        out_b = fabric.run_fabric(
            dir_b, FABRIC_WORKERS, entry, cases=cases, entry_kwargs=kw,
            out_keys=keys, shard_size=FABRIC_SHARD, device=where,
            warmup={"sizes": [FABRIC_SHARD], "kinds": ["cases"]})
        res["killed_s"] = time.time() - t0
        same(out_b, "(b)")
        evs = _fabric_events(logs_b)
        starts = {e["worker"]: e for e in evs
                  if e["event"] == "fabric_worker_start"}
        check(set(starts) == {f"w{i}" for i in range(FABRIC_WORKERS)} and all(
            st.get("warmup_launches") == res["warmup_launches_want"]
            and st["programs_loaded"] + st["programs_compiled"] == 1
            for st in starts.values()),
              f"fabric (b): worker warm-ups {starts} (each must load or "
              f"build the one program, launching "
              f"{res['warmup_launches_want']} times as this process did)")
        res["startup_s_b"] = {w: st["startup_s"] for w, st in starts.items()}
        res["warmup_s_b"] = {w: st["warmup_s"] for w, st in starts.items()}
        res["programs_b"] = {w: (st["programs_loaded"],
                                 st["programs_compiled"])
                             for w, st in starts.items()}
        res["first_shard_s_b"] = _first_shards(evs)
        exits = {e["worker"]: e["returncode"] for e in evs
                 if e["event"] == "fabric_worker_exit"}
        check(exits.get("w0") == -9 and all(
            rc == 0 for w, rc in exits.items() if w != "w0"),
              f"fabric (b): worker exit codes {exits} (worker 0 must die "
              "by its SIGKILL, the others exit 0)")
        steals = [(e["shard"], e["from_worker"], e["reason"]) for e in evs
                  if e["event"] == "shard_steal"]
        ledger = fabric.Ledger(dir_b, FABRIC_ROWS // FABRIC_SHARD)
        reclaimed = [s for s in range(ledger.n_shards)
                     if (ledger.read_done(s) or {}).get("attempt") == 2]
        check(steals and steals[0][1] == "w0" and reclaimed,
              f"fabric (b): steals {steals}, re-claimed shards {reclaimed}")
        res["steals"] = steals
        prog_b, res["shards_by_worker_b"] = _fabric_ledger(dir_b)
        res["launches_b"] = prog_b.get("ge_solve", 0)
        # the surviving worker's ledger: every shard and its warm-up
        check(res["launches_b"] == res["serial_launches"]
              + res["warmup_launches_want"],
              f"fabric (b): the workers launched the kernel "
              f"{res['launches_b']} times, the serial sweep "
              f"{res['serial_launches']} + one warm-up "
              f"{res['warmup_launches_want']}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res["launches"] = res["launches_a"] + res["launches_b"]
    res["rows_per_s"] = FABRIC_ROWS / res["fabric_s"]
    res["serial_rows_per_s"] = FABRIC_ROWS / res["serial_s"]
    res["phase_s"] = time.time() - t_phase
    print(f"fabric on {card}: demo_entry (spar) {FABRIC_ROWS} rows in "
          f"shards of {FABRIC_SHARD} on {FABRIC_WORKERS} workers "
          f"({', '.join(res['worker_devices'])}): {res['fabric_s']:.2f} s = "
          f"{res['rows_per_s']:.1f} rows/s against the serial sweep's "
          f"{res['serial_rows_per_s']:.1f} rows/s ({res['serial_s']:.2f} s), "
          f"bit-identical; worker start-up "
          + ", ".join(f"{w} {s:.2f} s" for w, s in
                      sorted(res["startup_s"].items()))
          + ", first shard " + ", ".join(
              f"{w} {s:.2f} s" for w, s in
              sorted(res["first_shard_s"].items()))
          + f"; shards by worker {res['shards_by_worker']}; worker 0 killed "
          f"at its first claim: steals {res['steals']}, shards by worker "
          f"{res['shards_by_worker_b']}, {res['killed_s']:.2f} s, "
          f"bit-identical; run record and obs "
          f"trace --check ok; ge_solve launches {res['launches_a']} + "
          f"{res['launches_b']} (the serial sweep's "
          f"{res['serial_launches']} each, + {res['warmup_launches_want']} "
          f"of the surviving worker's warm-up in (b)); phase "
          f"{res['phase_s']:.1f} s")
    print("  fabric (b) with the AOT warm-up spec (RAFT_TPU_AOT=load): "
          "worker start-up " + ", ".join(
              f"{w} {s:.2f} s (warm-up {res['warmup_s_b'][w]:.2f} s, "
              f"loaded/compiled {res['programs_b'][w]})"
              for w, s in sorted(res["startup_s_b"].items()))
          + "; first shard " + ", ".join(
              f"{w} {s:.2f} s" for w, s in
              sorted(res["first_shard_s_b"].items()))
          + " (run (a), cold: start-up " + ", ".join(
              f"{w} {s:.2f} s" for w, s in sorted(res["startup_s"].items()))
          + ", first shard " + ", ".join(
              f"{w} {s:.2f} s" for w, s in
              sorted(res["first_shard_s"].items())) + ")")
    return res


def _first_shards(evs):
    """Each worker's first evaluated shard's wall (its first
    ``shard_done`` event)."""
    first = {}
    for e in sorted((e for e in evs if e["event"] == "shard_done"
                     and e.get("worker")), key=lambda e: e["t"]):
        first.setdefault(e["worker"], e["wall_s"])
    return first


def _serve_pool(rng):
    """SERVE_POOL seeded (Hs, Tp, beta) cases per demo, rounded to 3
    decimals, drawn from ``rng`` (the serve phase's SERVE_SEED
    generator)."""
    return {n: [tuple(round(float(x), 3) for x in c) for c in zip(
        rng.uniform(2.0, 8.0, SERVE_POOL), rng.uniform(6.0, 14.0, SERVE_POOL),
        rng.uniform(-0.5, 0.5, SERVE_POOL))] for n in ("spar", "semi")}


def _serve_plan():
    """Per client thread, its SERVE_REQS request bodies: the design
    alternates between spar and semi with the client and request index,
    the case is drawn from a pool of SERVE_POOL seeded cases per design
    (so cases repeat: in-flight joins and cache hits); client 0's first
    request asks for escalate_f64, client 1's first for an out_keys
    subset, client 2's first is the mhk demo's dict inline."""
    rng = np.random.default_rng(SERVE_SEED)
    pool = _serve_pool(rng)
    plan = []
    for i in range(SERVE_CLIENTS):
        reqs = []
        for j in range(SERVE_REQS):
            name = ("spar", "semi")[(i + j) % 2]
            h, t, b = pool[name][int(rng.integers(SERVE_POOL))]
            reqs.append({"design": name, "Hs": h, "Tp": t, "beta": b})
        plan.append(reqs)
    plan[0][0]["escalate_f64"] = True
    plan[1][0]["out_keys"] = ["X0", "status"]
    with open(os.path.join(FIX, "design_mhk.json")) as f:
        plan[2][0] = {"design_inline": json.load(f), "Hs": 4.0, "Tp": 9.0,
                      "beta": 0.2}
    return plan


def _start_server(batcher):
    """The asyncio HTTP server of ``batcher`` on a loopback port, its
    event loop in a thread of its own; returns (server, thread, box),
    box holding the error that ended the loop, if one did."""
    import asyncio

    from raft_tpu_torch.serve.http import Server

    box, up = {}, threading.Event()

    def serve():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def run():
            box["server"] = await Server(batcher, "127.0.0.1", 0).start()
            up.set()
            await box["server"].serve_until_stopped()

        try:
            loop.run_until_complete(run())
        except BaseException as e:  # noqa: BLE001 — reported below
            box["error"] = e
            up.set()
        finally:
            loop.close()

    th = threading.Thread(target=serve, name="chip-smoke-serve", daemon=True)
    th.start()
    check(up.wait(60) and "server" in box,
          f"serve: the server did not start: {box.get('error')!r}")
    return box["server"], th, box


def phase_serve(card, out_dir=None):
    """One serving process on the card (module docstring, phase 24)."""
    import tempfile

    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.obs.report import SERVE_STAGES
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.serve import engine
    from raft_tpu_torch.serve.batcher import Batcher
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.structure import bucketing as bk
    from raft_tpu_torch.utils import config
    from raft_tpu_torch.utils.devices import to_host

    t_phase = time.time()
    on_card = str(DEVICE).startswith("cuda")
    dev = torch.device("cuda", 0) if on_card else torch.device(DEVICE)
    env_names = (config.env_name("SERVE_LADDER"), config.env_name("AOT"),
                 config.env_name("AOT_DIR"))
    prev = {k: os.environ.get(k) for k in env_names}
    os.environ[config.env_name("SERVE_LADDER")] = SERVE_LADDER
    # the server warms under RAFT_TPU_AOT=load into a fresh bank, so its
    # provenance stamps name the entries it stored
    os.environ[config.env_name("AOT")] = "load"
    os.environ[config.env_name("AOT_DIR")] = (
        os.path.join(out_dir, "serve_bank") if out_dir
        else tempfile.mkdtemp(prefix="serve_bank"))
    shutil.rmtree(os.environ[config.env_name("AOT_DIR")], ignore_errors=True)
    try:
        registry = engine.Registry()
        for n in ("spar", "semi"):
            registry.register(n, os.path.join(FIX, f"design_{n}.json"))
        batcher = Batcher(registry, device=dev, group_log=4096)
        check(batcher.sizes == (1, 4, 16),
              f"serve: ladder {batcher.sizes}, want {SERVE_LADDER}")
        entries = [registry.get(n) for n in registry.names()]
        t0 = time.time()
        warm = engine.warm(entries, device=dev, out_keys=batcher.out_keys,
                           sizes=batcher.sizes)
        warm_s = time.time() - t0
        walls = engine.ladder_walls(entries, batcher.sizes,
                                    out_keys=batcher.out_keys, device=dev)
        prov = engine.build_provenance(registry, out_keys=batcher.out_keys,
                                       sizes=batcher.sizes, device=dev)
        check(all(prov[n]["bank_sha"] != "none" for n in registry.names())
              and sum(r["compiled"] for r in warm) == len(warm),
              f"serve: warmed under load, provenance {prov}, warm-up "
              f"{[(r['loaded'], r['compiled']) for r in warm]}")
        server, th, box = _start_server(batcher)
        plan = _serve_plan()
        results, errors = [], []

        def client(i):
            c = ServeClient("127.0.0.1", server.port, client_id=f"c{i}",
                            timeout=120)
            try:
                for j, body in enumerate(plan[i]):
                    t0 = time.perf_counter()
                    code, resp = c.request("POST", "/evaluate", body)
                    results.append((i, j, body, code, resp,
                                    time.perf_counter() - t0))
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append((i, repr(e)))
            finally:
                c.close()

        stage0 = {st: (metrics.histogram(f"serve_stage_{st}_s").count,
                       metrics.histogram(f"serve_stage_{st}_s").sum)
                  for st in SERVE_STAGES}
        c0 = {k: metrics.counter(k).value for k in (
            "serve_dispatches", "serve_rows_dispatched", "serve_coalesced",
            "serve_inflight_joins", "serve_errors", "serve_escalations")}
        h0 = metrics.counter("serve_cache_hits").value
        linsolve.reset_launches()
        t_load = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        load_s = time.time() - t_load
        c = ServeClient("127.0.0.1", server.port)
        code, drained = c.request("POST", "/drain")
        c.close()
        th.join(timeout=120)
        launches = linsolve.forward_launches()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(code == 202 and not th.is_alive() and "error" not in box,
          f"serve: drain answered {code} {drained}, server thread alive "
          f"{th.is_alive()}, error {box.get('error')!r}")
    check(not errors, f"serve: client errors {errors[:3]}")
    n_req = SERVE_CLIENTS * SERVE_REQS
    check(len(results) == n_req, f"serve: {len(results)} of {n_req} "
          "requests answered")
    codes = sorted({r[3] for r in results})
    check(all(cd in (200, 422) for cd in codes),
          f"serve: response codes {codes} (5xx or rejects)")
    groups = list(batcher.groups)
    d = {k: metrics.counter(k).value - v for k, v in c0.items()}
    check(d["serve_errors"] == 0, f"serve: {d['serve_errors']} serve_errors")
    check(len(groups) == d["serve_dispatches"],
          f"serve: {len(groups)} recorded groups, "
          f"{d['serve_dispatches']} dispatches")

    # every recorded group against a direct evaluator call on it (after
    # the counts were read: these launches are not the path's)
    fused = config.get("FUSED") == "on"
    exp_launches, rows_at = 0, {}
    with torch.no_grad():
        for gi, g in enumerate(groups):
            ents, n = g["entries"], len(g["entries"])
            ev = bk.get_bucket_evaluator(ents[0].sig, dev)
            design, seas = engine.padded_group(ents, g["Hs"], g["Tp"],
                                               g["beta"], g["padded"], dev)
            direct = ev(design, *seas)
            for k in batcher.out_keys:
                check(np.array_equal(g["out"][k], to_host(direct[k][:n])),
                      f"serve: group {gi} {k} differs from the direct call")
            meta = bk.signature_meta(ents[0].sig)
            cap = meta["nIter"] * max(int(config.get("ITER_SCALE")), 1) + 1 \
                + max(int(meta["nIterExtra"]), 0)
            exp = expected_launches(to_host(direct["n_iter_drag"]),
                                    g["padded"], cap,
                                    min(max(1, config.get("SCAN_CHUNK")),
                                        cap), fused)
            check(g["launches"] == exp, f"serve: group {gi} launched "
                  f"{g['launches']} times, its trips want {exp}")
            exp_launches += exp
            for i, e in enumerate(ents):
                rows_at.setdefault((e.name, g["Hs"][i], g["Tp"][i],
                                    g["beta"][i]), []).append((g, i))
    check(launches == exp_launches == sum(g["launches"] for g in groups),
          f"serve: {launches} launches in the run, the dispatches' trips "
          f"want {exp_launches}, the dispatches counted "
          f"{sum(g['launches'] for g in groups)}")

    # every served row is its group's row, bit for bit
    inline = {g["entries"][0].name for g in groups
              if g["entries"][0].name.startswith("inline-")}
    check(len(inline) == 1, f"serve: inline groups {sorted(inline)}")
    hits = 0
    for i, j, body, code, resp, _ in results:
        name = body.get("design") or next(iter(inline))
        at = rows_at.get((name, body["Hs"], body["Tp"], body["beta"]))
        check(at, f"serve: client {i} request {j} ({name}) in no group")
        want = set(body.get("out_keys") or batcher.out_keys)
        check(set(resp["outputs"]) == want,
              f"serve: client {i} request {j} keys {sorted(resp['outputs'])}")
        check(any(resp["status"] == int(g["out"]["status"][r]) and all(
            np.array_equal(np.asarray(v, dtype=g["out"][k].dtype),
                           g["out"][k][r])
            for k, v in resp["outputs"].items()) for g, r in at),
            f"serve: client {i} request {j} ({name}) differs from its "
            "group's row")
        hits += bool(resp["cache_hit"])
    check(hits > 0, "serve: no request hit the result cache")

    # the JAX serving engine's goldens at rungs 1, 4 and 16 on the card
    # (each rung's first request is one shared case: its rung
    # dependence is recorded)
    gold_err, rung_dep = {}, {}
    for n in ("spar", "semi"):
        g = np.load(os.path.join(FIX, f"golden_serve_{n}.npz"))
        first = {}
        for rung in (1, 4, 16):
            Hs, Tp, beta = (g[f"r{rung}_{k}"] for k in ("Hs", "Tp", "beta"))
            out = engine.dispatch([registry.get(n)] * len(Hs), Hs, Tp, beta,
                                  out_keys=batcher.out_keys, device=dev,
                                  padded=rung, record_metrics=False)
            check(np.array_equal(out["status"], g[f"r{rung}_status"]),
                  f"serve: {n} rung {rung} status {out['status'].tolist()}")
            for k in ("PSD", "X0"):
                ref = g[f"r{rung}_{k}"]
                err = float(np.max(np.abs(out[k] - ref))
                            / np.max(np.abs(ref)))
                check(err <= SLICE_TOL, f"serve: {n} rung {rung} {k} "
                      f"{err:.3e} x max off the golden")
                gold_err[f"{n}.r{rung}.{k}"] = err
            first[rung] = out
        rung_dep[n] = max(float(np.max(np.abs(first[r][k][0]
                                              - first[1][k][0]))
                                / np.max(np.abs(first[1][k][0])))
                          for r in (4, 16) for k in ("PSD", "X0"))

    walls_req = np.array([r[5] for r in results])
    p50, p95 = (float(np.percentile(walls_req, q)) for q in (50, 95))
    occ = float(np.mean([len(g["entries"]) / g["padded"] for g in groups]))
    stages = {}
    for st in SERVE_STAGES:
        h = metrics.histogram(f"serve_stage_{st}_s")
        dn = h.count - stage0[st][0]
        stages[st] = (h.sum - stage0[st][1]) / dn if dn else 0.0
    rows = d["serve_rows_dispatched"]
    res = dict(
        requests=n_req, codes=codes, dispatches=len(groups),
        rows_dispatched=rows, coalesced=d["serve_coalesced"],
        inflight_joins=d["serve_inflight_joins"], cache_hits=hits,
        escalations=d["serve_escalations"], launches=launches,
        latency_p50_s=p50, latency_p95_s=p95, load_s=load_s,
        requests_per_s=n_req / load_s, rows_per_s=rows / load_s,
        occupancy_mean=occ, stage_mean_s=stages, warm_s=warm_s,
        warm=warm, ladder_walls_s={str(r): w for r, w in walls.items()},
        by_rung={str(r): sum(g["padded"] == r for g in groups)
                 for r in batcher.sizes},
        golden_worst_rel=max(gold_err.values()), rung_dependence=rung_dep,
        bank_sha={n: prov[n]["bank_sha"] for n in registry.names()})
    res["phase_s"] = time.time() - t_phase
    print(f"serve on {card}: {n_req} requests from {SERVE_CLIENTS} client "
          f"threads over loopback in {load_s:.2f} s, every one answered "
          f"(codes {codes}), no 5xx; latency p50 {p50 * 1e3:.2f} ms, p95 "
          f"{p95 * 1e3:.2f} ms; {n_req / load_s:.1f} requests/s, "
          f"{rows / load_s:.1f} dispatched rows/s")
    print(f"  serve: {len(groups)} dispatches (by rung "
          f"{res['by_rung']}), {rows} rows, occupancy mean {occ:.3f}; "
          f"{d['serve_coalesced']} coalesced ({d['serve_inflight_joins']} "
          f"in-flight joins), {hits} cache hits, "
          f"{d['serve_escalations']} escalations; every served row "
          "bit-equal to a direct BucketEvaluator call on its group, status "
          "equal")
    print("  serve: stage split (mean ms) " + ", ".join(
        f"{st} {v * 1e3:.3f}" for st, v in stages.items())
          + f"; serve_launches {launches} (= the dispatches' trips + 1 "
          f"each); warm-up {len(warm)} (signature x rung) in "
          f"{warm_s:.2f} s under RAFT_TPU_AOT=load ("
          f"{sum(r['compiled'] for r in warm)} programs stored, provenance "
          f"bank_sha {res['bank_sha']}), best walls ms " + ", ".join(
              f"{r}: {w * 1e3:.2f}" for r, w in walls.items() if w))
    print(f"  serve: golden_serve_{{spar,semi}} at rungs 1, 4, 16 held "
          f"(worst {res['golden_worst_rel']:.2e} x max, status equal); the "
          "shared case's rung dependence " + ", ".join(
              f"{n} {v:.2e} x max" for n, v in rung_dep.items()))
    print(f"  serve: phase wall {res['phase_s']:.1f} s of its "
          f"{SERVE_BUDGET_S:.0f} s budget")
    return res


def _aot_cli(*argv):
    """``python -m raft_tpu_torch.aot`` in this process: (exit code,
    stdout + stderr)."""
    import contextlib
    import io

    from raft_tpu_torch.aot.__main__ import main as aot_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = aot_main(list(argv))
    return rc, buf.getvalue()


def phase_aot(out_dir, card):
    """The program bank, its warm-up and its releases (module docstring,
    phase 25)."""
    from raft_tpu_torch import api
    from raft_tpu_torch.aot import bank, release
    from raft_tpu_torch.models.model import Model
    from raft_tpu_torch.ops import linsolve
    from raft_tpu_torch.parallel import sweep as ts
    from raft_tpu_torch.serve import engine

    t_phase = time.time()
    on_card = str(DEVICE).startswith("cuda")
    dev = torch.device("cuda", 0) if on_card else torch.device(DEVICE)
    dev_arg = "cuda" if on_card else str(DEVICE)
    base = os.path.join(out_dir, "aot")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    root = os.path.join(base, "bank")
    spar = os.path.join(FIX, "design_spar.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RAFT_TPU_", "AOT_CHILD"))}
    env.update(RAFT_TPU_AOT_DIR=root, RAFT_TPU_SERVE_LADDER=str(AOT_RUNG),
               PYTHONPATH=HERE)
    res = dict(rows=AOT_ROWS, rung=AOT_RUNG)

    def spawn(argv, **extra):
        p = subprocess.Popen([sys.executable] + argv, env=dict(env, **extra),
                             cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        CHILDREN.append(p)
        return p

    def finish(p, what):
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        return p.returncode, out, err

    # 1. the warm-up CLI into a fresh bank: the serve program at the
    #    rung, the spar case program at AOT_ROWS rows.  Beside it the
    #    require child (COMPILE_BUDGET=0) starts up — imports, context,
    #    model and evaluator — and waits for the go file before its
    #    first program, and this process makes the same calls, the bank
    #    off (the bits the children are held to, and their launches: the
    #    prediction)
    t0 = time.time()
    go = os.path.join(base, "go")
    warm = spawn(["-m", "raft_tpu_torch.aot", "warmup", "--design", spar,
                  "--kinds", "serve,cases", "--n", str(AOT_ROWS),
                  "--device", dev_arg])
    child = spawn([os.path.join(HERE, "tests", "_torch_aot_child.py")],
                  RAFT_TPU_AOT="require", RAFT_TPU_COMPILE_BUDGET="0",
                  AOT_CHILD_DEVICE=dev_arg, AOT_CHILD_N=str(AOT_ROWS),
                  AOT_CHILD_GO=go,
                  AOT_CHILD_OUT=os.path.join(base, "require.npz"))
    prev = {k: os.environ.get(k) for k in ("RAFT_TPU_SERVE_LADDER",
                                           "RAFT_TPU_AOT_DIR")}
    os.environ["RAFT_TPU_SERVE_LADDER"] = str(AOT_RUNG)
    os.environ["RAFT_TPU_AOT_DIR"] = root
    try:
        model = Model(spar, base_dir=FIX)
        entry = engine.DesignEntry("spar", model)
        rng = np.random.default_rng(0)          # warmup_model's rows
        Hs, Tp, beta = (rng.uniform(2.0, 8.0, AOT_ROWS),
                        rng.uniform(6.0, 14.0, AOT_ROWS),
                        rng.uniform(-0.5, 0.5, AOT_ROWS))
        l0 = linsolve.forward_launches()
        here = ts.sweep_cases(api.make_case_evaluator(model, device=dev),
                              Hs, Tp, beta, mesh=ts.make_mesh(device=dev),
                              out_keys=("PSD", "X0", "status"))
        l1 = linsolve.forward_launches()
        served = engine.dispatch([entry] * AOT_RUNG, Hs[:AOT_RUNG],
                                 Tp[:AOT_RUNG], beta[:AOT_RUNG], device=dev,
                                 padded=AOT_RUNG, record_metrics=False)
        l2 = linsolve.forward_launches()
        engine.warm([entry], device=dev, sizes=(AOT_RUNG,))
        l3 = linsolve.forward_launches()
        want_warm, want_child = (l1 - l0) + (l3 - l2), (l1 - l0) + (l2 - l1)
        rc, out, err = finish(warm, "warmup")
        res["warmup_s"] = time.time() - t0
        check(rc == 0, f"aot: the warm-up exited {rc}: {err[-600:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("warmup ")]
        got_warm = sum(int(re.search(r"(\d+) kernel launch", ln).group(1))
                       for ln in lines)
        check(len(lines) == 2 and all("compiled 1 program(s)" in ln
                                      for ln in lines),
              f"aot: warm-up reports {lines}")
        check(got_warm == want_warm,
              f"aot: the warm-up launched {got_warm} times, this process's "
              f"same calls {want_warm}")
        res["warmup_launches"] = got_warm
        metas = [m for _, m, mp, _ in bank.scan() if mp]
        payloads = os.listdir(bank.payload_dir())
        check(len(metas) == 2 and len(payloads) == 1 and payloads[0]
              .endswith(".so" if on_card else ".plain"),
              f"aot: bank holds {len(metas)} entries, payloads {payloads}")
        res["first_run_s"] = {m["kind"]: m["compile_s"] for m in metas}

        # 3. releases: cut A, cut B over A, verify, roll back to A
        rc_a, txt_a = _aot_cli("release", "cut", "--promote", "--label", "a")
        rid_a = release.current_release()
        rc_b, txt_b = _aot_cli("release", "cut", "--promote", "--label", "b")
        rid_b = release.current_release()
        rc_v, txt_v = _aot_cli("release", "verify")
        rc_r, txt_r = _aot_cli("release", "rollback")
        check((rc_a, rc_b, rc_v, rc_r) == (0, 0, 0, 0) and rid_a != rid_b
              and release.current_release() == rid_a
              and release.load_release(rid_b)["parent"] == rid_a,
              f"aot: release cut/promote/verify/rollback "
              f"{(rc_a, rc_b, rc_v, rc_r)}: {txt_a} {txt_b} {txt_v} {txt_r}")
        man_a = release.load_release(rid_a)
        check(man_a["n_entries"] == 2 and release.verify_against_bank(
            man_a) == [], f"aot: release {rid_a} {man_a['n_entries']} entries")
        # 4. a tampered manifest is refused
        bad = dict(man_a, entries={k: dict(v, payload_sha256="e" * 64)
                                   for k, v in man_a["entries"].items()})
        bad_path = os.path.join(base, "tampered.json")
        with open(bad_path, "w") as f:
            json.dump(bad, f)
        rc_t, txt_t = _aot_cli("release", "verify", "--manifest", bad_path)
        rc_g, _ = _aot_cli("release", "verify", "--manifest",
                           release.manifest_path(rid_a))
        check(rc_t == 1 and "manifest_sha256 mismatch" in txt_t and rc_g == 0,
              f"aot: tampered manifest verify exited {rc_t}, the good one "
              f"{rc_g}: {txt_t}")
        res.update(release=rid_a, releases=[rid_a, rid_b])
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # 2. the require child runs its programs on the warm bank, and 5. a
    #    require server under a flipped RAFT_TPU_FUSED starts beside it
    t0 = time.time()
    with open(go, "w") as f:
        f.write("warm\n")
    skew = spawn(["-m", "raft_tpu_torch.serve", "--designs", f"spar={spar}",
                  "--port", "0", "--device", dev_arg],
                 RAFT_TPU_AOT="require", RAFT_TPU_FUSED="off")
    rc, out, err = finish(child, "require")
    res["require_s"] = time.time() - t0
    check(rc == 0, f"aot: the require child exited {rc}: {err[-600:]}")
    r = json.loads(out.strip().splitlines()[-1])
    res["require"] = r
    check((r["loaded"], r["compiled"], r["builds"], r["nvcc_runs"],
           r["built_here"]) == (2, 0, 0, 0, False),
          f"aot: the require child loaded {r['loaded']}, compiled "
          f"{r['compiled']}, builds {r['builds']}, nvcc {r['nvcc_runs']}")
    if on_card:
        check(r["library"] and r["library"].startswith(root),
              f"aot: the require child's library {r['library']} is not the "
              "bank's copy")
    check(r["launches"] == want_child,
          f"aot: the require child launched {r['launches']} times, this "
          f"process's same calls {want_child}")
    got = np.load(os.path.join(base, "require.npz"))
    for k, v in list(here.items()):
        check(np.array_equal(got[f"cases_{k}"], v),
              f"aot: the require child's cases {k} differs")
    for k, v in served.items():
        check(np.array_equal(got[f"serve_{k}"], v),
              f"aot: the require child's served {k} differs")
    rc, out, err = finish(skew, "skew")
    res["skew_s"] = time.time() - t0
    check(rc == 3 and f"release: {rid_a}" in out and "why [flags]" in err
          and f"bank preflight vs release {rid_a}" in err,
          f"aot: the skewed require server exited {rc}: {out[-300:]} "
          f"{err[-600:]}")
    res["diagnosis"] = [ln for ln in err.splitlines() if ln.startswith(
        ("bank preflight", "  spar", "  why"))]
    res["launches"] = res["warmup_launches"] + r["launches"]
    res["phase_s"] = time.time() - t_phase
    print(f"aot on {card}: warm-up child (serve at rung {AOT_RUNG}, spar "
          f"cases at {AOT_ROWS} rows) {res['warmup_s']:.2f} s, 2 programs "
          f"stored (first runs " + ", ".join(
              f"{k} {v:.2f} s" for k, v in res["first_run_s"].items())
          + f"), one {'library' if on_card else 'plain'} payload; require "
          f"child (COMPILE_BUDGET=0, started beside the warm-up) "
          f"{res['require_s']:.2f} s after the go: loaded "
          f"{r['loaded']}, compiled 0, nvcc 0, its programs "
          f"{r['run_s']:.2f} s, cold start {r['cold_start_s']:.2f} s "
          f"(the wait for the go, {r['wait_s']:.2f} s, left out), "
          "bit-equal to this process")
    print(f"  aot: releases {rid_a} <- {rid_b} cut, promoted, verified, "
          f"rolled back to {rid_a}; tampered manifest refused; require "
          f"server under RAFT_TPU_FUSED=off exited 3: "
          + " | ".join(res["diagnosis"][:3]))
    print(f"  aot: ge_solve launches {res['launches']} (warm-up "
          f"{res['warmup_launches']} + require child {r['launches']}, "
          f"each as predicted); phase {res['phase_s']:.1f} s of its "
          f"{AOT_BUDGET_S:.0f} s budget")
    return res


def _fleet_spans(log_dir, pid):
    """The ``span_begin`` records of one replica's trace shard."""
    out = []
    with open(os.path.join(log_dir, f"trace-{pid}.jsonl")) as f:
        for line in f:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if e.get("event") == "span_begin":
                out.append(e)
    return out


def _fleet_dispatches(spans, bodies, bucket_of, canary_case):
    """Every serving dispatch of one replica, rebuilt from its trace
    shard: each ``sweep_dispatch`` span under a ``serve_tick`` span, its
    rows the distinct requests the tick links to in the dispatch's
    bucket.  A link resolves through its trace id to a request body
    this process sent (``bodies``: trace id -> (design, Hs, Tp, beta)),
    or, for the router canary's probes (client ``canary``, no
    traceparent), to the canary case.  Returns ``[(rows, n_rows)]``,
    ``n_rows`` the span's own row count."""
    by_span = {e["span_id"]: e for e in spans}
    ticks = {e["span_id"]: e for e in spans if e["name"] == "serve_tick"}
    out = []
    for d in spans:
        if d["name"] != "sweep_dispatch" or d.get("parent_id") not in ticks:
            continue
        rows = set()
        for link in ticks[d["parent_id"]].get("links") or ():
            body = bodies.get(link["trace_id"])
            if body is not None:
                row = body + (False,)
            else:
                req = by_span.get(link["span_id"])
                check(req is not None and req.get("client") == "canary",
                      f"fleet: a tick links to an unknown request {link}")
                row = (None,) + tuple(canary_case) + (True,)
            design = row[0] or next((n for n, b in bucket_of.items()
                                     if b == d["bucket"]), None)
            if bucket_of.get(design) == d["bucket"]:
                rows.add((design,) + row[1:])
        out.append((sorted(rows, key=repr), int(d["rows"])))
    return out


def phase_fleet(out_dir, card, serve=None):
    """The serving fleet on the card (module docstring, phase 26)."""
    import asyncio

    from raft_tpu_torch.aot import release
    from raft_tpu_torch.obs import flight, metrics
    from raft_tpu_torch.serve import canary as canary_mod
    from raft_tpu_torch.serve import engine, fleet, rollout
    from raft_tpu_torch.serve.client import ServeClient
    from raft_tpu_torch.serve.router import HashRing, Router, routing_key
    from raft_tpu_torch.structure import bucketing as bk
    from raft_tpu_torch.utils import config

    t_phase = time.time()
    on_card = str(DEVICE).startswith("cuda")
    dev = torch.device("cuda", 0) if on_card else torch.device(DEVICE)
    dev_arg = "cuda" if on_card else str(DEVICE)
    base = os.path.join(out_dir, "fleet")
    shutil.rmtree(base, ignore_errors=True)
    root, logs = os.path.join(base, "deploy"), os.path.join(base, "logs")
    os.makedirs(logs)
    spec = [f"{n}={os.path.join(FIX, f'design_{n}.json')}"
            for n in ("spar", "semi")]
    phase_env = dict(
        RAFT_TPU_AOT_DIR=os.path.join(base, "bank"),
        RAFT_TPU_SERVE_LADDER=FLEET_LADDER,
        RAFT_TPU_FLEET_TTL_S=str(FLEET_TTL_S),
        RAFT_TPU_FLEET_FAULT_REPLICA="1",
        RAFT_TPU_ROUTER_PROBE_S="0.3", RAFT_TPU_ROUTER_BACKOFF_MS="10",
        RAFT_TPU_ROUTER_BREAKER_FAILS="1",
        RAFT_TPU_ROLLOUT_CANARY_PROBES="2", RAFT_TPU_ROLLOUT_POLL_S="0.2",
        RAFT_TPU_ROLLOUT_HEALTH_TIMEOUT_S="120")
    prev = {k: os.environ.get(k) for k in list(phase_env) + [
        config.env_name("AOT")]}
    os.environ.update(phase_env)
    res = dict(ladder=FLEET_LADDER, clients=FLEET_CLIENTS,
               requests=FLEET_CLIENTS * FLEET_REQS)
    loop = th = router = None
    procs = []

    class Ops(rollout.FleetOps):
        """The rollout's side effects as the driver's, its takeover
        replicas stopped on the way out with the phase's children."""

        def spawn_takeover(self, rid, env):
            p = super().spawn_takeover(rid, env)
            CHILDREN.append(p)
            res["takeover_spawn_t"] = time.time()
            return p

    def get(port, path):
        c = ServeClient("127.0.0.1", port, timeout=60)
        try:
            return c.request("GET", path)
        finally:
            c.close()

    try:
        # (a) one bank for both demos at ladder 1,4 (the chip process
        #     pays the first runs), release A promoted; two replicas
        #     under RAFT_TPU_AOT=require.  The one given the
        #     replica_kill fault (index 1, RAFT_TPU_FLEET_FAULT_REPLICA)
        #     gets an id that owns neither demo on the ring, only the
        #     spar design posted inline: no request reaches it before (c)
        t0 = time.time()
        warm = fleet.warm_shared_bank(spec, device=dev)
        res["warm_s"] = time.time() - t0
        rid_a = release.cut(label="fleet-a", promote_after=True)["release"]
        registry = engine.Registry()
        for n in ("spar", "semi"):
            registry.register(n, os.path.join(FIX, f"design_{n}.json"))
        meta = {n: {"sig": bk.signature_fingerprint(registry.get(n).sig),
                    "fingerprint": registry.get(n).fingerprint}
                for n in registry.names()}
        bucket_of = {n: m["sig"] for n, m in meta.items()}
        with open(os.path.join(FIX, "design_spar.json")) as f:
            spar_inline = json.load(f)
        keys = {n: routing_key({"design": n}, meta) for n in meta}
        keys["inline"] = routing_key({"design_inline": spar_inline}, meta)
        victim = None
        for i in range(512):
            ring = HashRing()
            ring.add("r0")
            ring.add(f"rk{i}")
            own = {k: ring.owners(v)[0] for k, v in keys.items()}
            if own == {"spar": "r0", "semi": "r0", "inline": f"rk{i}"}:
                victim = f"rk{i}"
                break
        check(victim is not None, "fleet: no replica id owns the inline "
              "key alone")
        env = dict(RAFT_TPU_AOT="require", RAFT_TPU_LOG=logs + os.sep,
                   RAFT_TPU_FAULTS="replica_kill:serve_evaluate:1",
                   RAFT_TPU_FLIGHT_FLUSH_S="0.5", PYTHONPATH=HERE)
        t_spawn = {}
        for i, rid in enumerate(("r0", victim)):
            t_spawn[rid] = time.time()
            p, _ = fleet.spawn_replica(root, spec, index=i, replica_id=rid,
                                       env=env, device=dev_arg)
            CHILDREN.append(p)
            procs.append((p, rid))

        # while the replicas start: every case of the phase (the pool's
        # and the canary's) by a direct call at rung 1 in this process,
        # the bank off (these are not the path's programs) — the answers
        # are held against these, and their trips give the launches
        rng = np.random.default_rng(SERVE_SEED)
        pool = {n: c[:FLEET_POOL] for n, c in _serve_pool(rng).items()}
        os.environ[config.env_name("AOT")] = "off"
        direct = {}
        for key in [(n,) + c for n, cs in pool.items() for c in cs] + [
                (n,) + canary_mod.CANARY_CASE for n in meta]:
            direct[key] = engine.dispatch(
                [registry.get(key[0])], [key[1]], [key[2]], [key[3]],
                out_keys=("PSD", "X0", "status", "n_iter_drag"),
                device=dev, padded=1, record_metrics=False)
        iters = {k: int(d["n_iter_drag"][0]) for k, d in direct.items()}
        ledger = fleet.FleetLedger(root)
        while True:
            live = ledger.live()
            if {"r0", victim} <= set(live):
                break
            for p, rid in procs:
                log = os.path.join(fleet._replicas_dir(root), f"{rid}.log")
                check(p.poll() is None, f"fleet: replica {rid} exited "
                      f"{p.returncode}: {open(log).read()[-800:]}")
            check(time.time() - t0 < FLEET_BUDGET_S,
                  "fleet: the replicas did not join in the budget")
            time.sleep(0.1)
        res["startup_s"] = {rid: live[rid]["claimed_t"] - t_spawn[rid]
                            for rid in ("r0", victim)}
        res["built"] = {rid: (live[rid]["healthz"]["builds"],
                              live[rid]["healthz"]["nvcc_runs"])
                        for rid in ("r0", victim)}
        check(all(v == (0, 0) for v in res["built"].values()),
              f"fleet: replicas built {res['built']} (builds, nvcc runs)")

        box, up = {}, threading.Event()
        loop = asyncio.new_event_loop()

        def serve_router():
            asyncio.set_event_loop(loop)

            async def run():
                box["router"] = await Router(root, port=0).start()
                up.set()
                await box["router"].serve_until_stopped()

            try:
                loop.run_until_complete(run())
            except BaseException as e:  # noqa: BLE001 — reported below
                box["error"] = e
                up.set()

        th = threading.Thread(target=serve_router, name="chip-smoke-router",
                              daemon=True)
        th.start()
        check(up.wait(60) and "router" in box,
              f"fleet: the router did not start: {box.get('error')!r}")
        router = box["router"]
        check(router.state.ring_view() == {"spar": ["r0", victim],
                                           "semi": ["r0", victim]},
              f"fleet: ring {router.state.ring_view()}")

        # (b) FLEET_CLIENTS x FLEET_REQS requests through the router from
        #     the serve phase's pool, each with a traceparent of its own
        #     (its trace id names its body in the replica's trace)
        plan = [[("spar", "semi")[(i + j) % 2] for j in range(FLEET_REQS)]
                for i in range(FLEET_CLIENTS)]
        bodies, results, errors = {}, [], []
        for i, names in enumerate(plan):
            for j, n in enumerate(names):
                h, tp, b = pool[n][int(rng.integers(FLEET_POOL))]
                tid = f"{i:02x}{j:02x}" + "f" * 28
                plan[i][j] = (n, h, tp, b, tid)
                bodies[tid] = (n, h, tp, b)
        l0 = get(live["r0"]["port"], "/healthz")[1]["kernel"]["launches"]
        h0 = {k: (metrics.histogram(k).count, metrics.histogram(k).sum)
              for k in ("span_router_request_s", "span_router_upstream_s")}

        def client(i):
            c = ServeClient("127.0.0.1", router.port, client_id=f"f{i}",
                            timeout=120)
            try:
                for n, h, tp, b, tid in plan[i]:
                    t1 = time.perf_counter()
                    code, body = c.evaluate(
                        n, h, tp, b, traceparent=f"00-{tid}-{'1' * 16}-01")
                    results.append((n, h, tp, b, code, body,
                                    c.last_headers.get("x-raft-replica"),
                                    time.perf_counter() - t1))
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append((i, repr(e)))
            finally:
                c.close()

        t1 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        res["load_s"] = time.time() - t1
        check(not errors and len(results) == res["requests"],
              f"fleet: {len(results)} answers, errors {errors[:3]}")
        check(all(r[4] in (200, 422) and r[6] == "r0" for r in results),
              "fleet: codes / replicas "
              f"{sorted({(r[4], r[6]) for r in results})}")
        walls = np.array([r[7] for r in results])
        res["latency_p50_s"], res["latency_p95_s"] = (
            float(np.percentile(walls, q)) for q in (50, 95))
        hd = {k: (metrics.histogram(k).count - c0,
                  metrics.histogram(k).sum - s0)
              for k, (c0, s0) in h0.items()}
        n_req = hd["span_router_request_s"][0]
        res["router_overhead_ms"] = 1e3 * (
            hd["span_router_request_s"][1]
            - hd["span_router_upstream_s"][1]) / max(n_req, 1)

        # (c) the kill: the spar design posted inline routes to the armed
        #     replica, which SIGKILLs itself mid-request; the router
        #     fails the request over to r0
        retries0 = metrics.counter("router_retries").value
        kill_tid = "0b" * 16
        bodies[kill_tid] = ("spar",) + pool["spar"][0]
        c = ServeClient("127.0.0.1", router.port, client_id="kill",
                        timeout=120)
        code, body = c.request(
            "POST", "/evaluate", dict(zip(("Hs", "Tp", "beta"),
                                          pool["spar"][0]),
                                      design_inline=spar_inline),
            headers={"traceparent": f"00-{kill_tid}-{'2' * 16}-01"})
        answered_by = c.last_headers.get("x-raft-replica")
        c.close()
        results.append(("spar",) + pool["spar"][0]
                       + (code, body, answered_by, 0.0))
        vp = procs[1][0]
        check(code in (200, 422) and answered_by == "r0"
              and vp.wait(timeout=30) == -signal.SIGKILL,
              f"fleet: the kill request answered {code} by {answered_by}, "
              f"the armed replica's exit {vp.poll()}")
        res["failovers"] = metrics.counter("router_retries").value - retries0
        check(res["failovers"] >= 1, "fleet: no failover counted")
        t_kill = time.time()
        while router.state.snapshot()["n_replicas"] != 1 \
                or victim in ledger.replicas():
            check(time.time() - t_kill < 30, "fleet: the dead lease was "
                  f"not evicted: {ledger.summary()}")
            time.sleep(0.1)
        res["evict_s"] = time.time() - t_kill
        dump = os.path.join(fleet._replicas_dir(root), "flight",
                            f"flight-{vp.pid}.jsonl")
        check(os.path.exists(dump), f"fleet: no flight dump {dump}")
        res["flight_records"] = len(flight.read_shard(dump)[1])

        # every answer within SLICE_TOL x max of its direct call at rung
        # 1, status equal
        worst = 0.0
        for n, h, tp, b, code, body, _, _ in results:
            d = direct[(n, h, tp, b)]
            check(body["status"] == int(d["status"][0]),
                  f"fleet: {n} {h} status {body['status']}")
            for k in ("PSD", "X0"):
                ref = d[k][0]
                err = float(np.max(np.abs(np.asarray(body["outputs"][k])
                                          - ref)) / np.max(np.abs(ref)))
                check(err <= SLICE_TOL, f"fleet: {n} {k} {err:.2e} x max "
                      "off the direct call")
                worst = max(worst, err)
        res["direct_worst_rel"] = worst

        # (d) the router's canary on r0 (goldens from its first probes),
        #     then release B rolled out: r0 replaced by --takeover under
        #     the canary gate, its ring keys unmoved
        canary = canary_mod.RouterCanary(router.state, interval_s=0.3)
        router.canary = canary
        canary.start()
        t2 = time.time()
        while canary.canary.summary()["passes"] < 2 * len(meta):
            check(time.time() - t2 < 30, "fleet: the canary did not pass "
                  f"on r0: {canary.canary.summary()}")
            time.sleep(0.1)
        l1 = get(live["r0"]["port"], "/healthz")[1]["kernel"]["launches"]
        rid_b = release.cut(label="fleet-b")["release"]
        probe_keys = [routing_key({"design": n, "Hs": float(x)}, meta)
                      for n in meta for x in range(8)] + list(keys.values())
        owners0 = [router.state.owners(k) for k in probe_keys]
        os.environ[config.env_name("AOT")] = "require"
        t3 = time.time()
        record = rollout.run_rollout(
            root, rid_b, spec, router_url=f"http://127.0.0.1:{router.port}",
            ops=Ops(root, spec, router_url=f"http://127.0.0.1:{router.port}",
                    device=dev_arg))
        res["rollout_s"] = time.time() - t3
        check(record["ok"] and record["replaced"] == ["r0"]
              and release.current_release() == rid_b,
              f"fleet: rollout {rollout.summarize_record(record)} "
              f"{record['steps']}")
        res["rollout_steps_s"] = {s["replica"]: s["wall_s"]
                                  for s in record["steps"]}
        check(procs[0][0].wait(timeout=60) == 0,
              "fleet: the replaced r0 did not drain to exit 0")
        new = ledger.live()["r0"]
        res["takeover_startup_s"] = new["claimed_t"] - res.pop(
            "takeover_spawn_t")
        res["takeover_built"] = (new["healthz"]["builds"],
                                 new["healthz"]["nvcc_runs"])
        check(res["takeover_built"] == (0, 0),
              f"fleet: the takeover replica built {res['takeover_built']}")
        check([router.state.owners(k) for k in probe_keys] == owners0,
              "fleet: the takeover moved ring keys")
        summ = canary.canary.summary()
        check(summ["fails"] == 0 and summ["parity_ok"]
              and summ["probes"].get("r0", {}).get("endpoint")
              == f"{new['addr']}:{new['port']}",
              f"fleet: canary {summ}")
        res["canary"] = {k: summ[k] for k in ("goldens", "passes", "fails",
                                              "parity_ok")}
        res["releases"] = [rid_a, rid_b]
    finally:
        if loop is not None and router is not None:
            loop.call_soon_threadsafe(router._stop.set)
            th.join(timeout=60)
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fleet._shutdown_replicas([(p, "x") for p in CHILDREN
                                  if p.poll() is None])

    # the solve kernel's launches on r0 from its kernel ledger, against
    # its dispatches rebuilt from its trace (trips + 1 each, the rows'
    # trips from the direct calls); the armed replica dispatched nothing
    dispatches = _fleet_dispatches(_fleet_spans(logs, procs[0][0].pid),
                                   bodies, bucket_of,
                                   canary_mod.CANARY_CASE)
    fused = config.get("FUSED") == "on"
    exp = 0
    for rows, n_rows in dispatches:
        check(len(rows) == n_rows, f"fleet: a dispatch of {n_rows} rows "
              f"rebuilt as {rows}")
        meta_sig = bk.signature_meta(registry.get(rows[0][0]).sig)
        cap = meta_sig["nIter"] * max(int(config.get("ITER_SCALE")), 1) \
            + 1 + max(int(meta_sig["nIterExtra"]), 0)
        padded = engine.pick_padded(n_rows, tuple(
            int(x) for x in FLEET_LADDER.split(",")))
        exp += expected_launches([iters[k[:4]] for k in rows], padded, cap,
                                 min(max(1, config.get("SCAN_CHUNK")), cap),
                                 fused)
    got = l1["ge_solve"] - l0["ge_solve"]
    res.update(launches=got, dispatches=len(dispatches))
    check(got == exp, f"fleet: r0's kernel ledger counts {got} launches, "
          f"its {len(dispatches)} dispatches' trips want {exp}")
    res["phase_s"] = time.time() - t_phase
    su = ", ".join(f"{r} {s:.2f} s" for r, s in res["startup_s"].items())
    print(f"fleet on {card}: one bank for spar + semi at ladder "
          f"{FLEET_LADDER} warmed here in {res['warm_s']:.2f} s "
          f"({sum(r['compiled'] for r in warm)} programs), release "
          f"{rid_a}; 2 replicas on {dev_arg} under RAFT_TPU_AOT=require, "
          f"start-up (process start to lease) {su}, built "
          f"{res['built']} (builds, nvcc runs)")
    sv = serve or {}
    print(f"  fleet: {res['requests']} requests from {FLEET_CLIENTS} "
          f"clients through the router in {res['load_s']:.2f} s, all "
          f"answered by r0; router p50 {res['latency_p50_s'] * 1e3:.2f} ms, "
          f"p95 {res['latency_p95_s'] * 1e3:.2f} ms (the serve phase's "
          f"direct p50 {sv.get('latency_p50_s', float('nan')) * 1e3:.2f} "
          f"ms, p95 {sv.get('latency_p95_s', float('nan')) * 1e3:.2f} ms); "
          f"router overhead {res['router_overhead_ms']:.3f} ms a request "
          "(router_request less router_upstream); every answer within "
          f"{res['direct_worst_rel']:.2e} x max of a direct rung-1 call, "
          "status equal")
    print(f"  fleet: kill drill — the inline request to {victim} killed it "
          f"(SIGKILL), {res['failovers']} failover(s), 0 dropped; lease "
          f"evicted {res['evict_s']:.2f} s after, its flight dump "
          f"{res['flight_records']} records")
    print(f"  fleet: rollout {rid_a} -> {rid_b}: r0 replaced by --takeover "
          f"in {res['rollout_s']:.2f} s (step "
          + ", ".join(f"{r} {w:.2f} s" for r, w in
                      res["rollout_steps_s"].items())
          + f", takeover start-up {res['takeover_startup_s']:.2f} s, built "
          f"{res['takeover_built']}), ring keys unmoved; canary "
          f"{res['canary']}")
    print(f"  fleet: ge_solve launches {got} on r0 (its kernel ledger) = "
          f"the trips + 1 of its {len(dispatches)} dispatches; phase "
          f"{res['phase_s']:.1f} s of its {FLEET_BUDGET_S:.0f} s budget")
    return res


def phase_analysis(card):
    """The op contracts on the card (module docstring, phase 27)."""
    from raft_tpu_torch.analysis import contracts as oc

    t_phase = time.time()
    base = oc.load_baseline()
    check(base.get("entries"), "analysis: raft_tpu_torch/analysis/"
          "op_baseline.json is missing")
    card_run = oc.EntryRunner(device=DEVICE)
    cpu_run = oc.EntryRunner(device="cpu")
    res = dict(entries={}, launches=0)
    held = ("bucket_evaluator", "fused_case")
    plan = [(e, "float64+fused" if oc.CONTRACTS[e].fused else "float64")
            for e in oc.CONTRACTS if e not in held]
    plan += [(e, v) for e in held for v in ("float64+fused",
                                           "float32+fused")]
    for entry, variant in plan:
        t0 = time.time()
        s = card_run.record(entry, variant, repeat=entry in held)
        wall = time.time() - t0
        b = base["entries"][entry][variant]
        tag = f"analysis {entry}[{variant}]"
        res["launches"] += s["launches"] + s.get("repeat", {}).get(
            "launches", 0)
        row = dict(cpu_ops=b["total"], card_ops=s["total"],
                   solves=s["ops"].get(oc.SOLVE_OP, 0),
                   launches=s["launches"], syncs=s["syncs"], h2d=s["h2d"],
                   trips=s["trips"], wall_s=wall)
        res["entries"][f"{entry}[{variant}]"] = row
        # the card's solves are the kernel's launches, one per solve
        check(s["launches"] == row["solves"],
              f"{tag}: {s['launches']} launches for {row['solves']} solves")
        if entry not in held:
            continue
        # the held entries: their ops, syncs and trips those of the same
        # call on the CPU in this process (this torch), and those within
        # the checked-in baseline's budget (recorded with the sandbox's)
        cpu = cpu_run.record(entry, variant)
        row["cpu_here_ops"] = cpu["total"]
        diff = sorted(k for k in set(s["ops"]) | set(cpu["ops"])
                      if s["ops"].get(k) != cpu["ops"].get(k))
        check(not diff, f"{tag}: aten ops differ from the CPU's: "
              + ", ".join(f"{k} {cpu['ops'].get(k, 0)} -> "
                          f"{s['ops'].get(k, 0)}" for k in diff[:8]))
        over = oc.check_budget(entry, variant, cpu, base)
        check(not over, f"{tag}: " + "; ".join(over))
        check(s["syncs"] == cpu["syncs"] and s["trips"] == cpu["trips"],
              f"{tag}: host syncs {s['syncs']} / trips {s['trips']}, "
              f"CPU {cpu['syncs']} / {cpu['trips']}")
        check(s["launches"] == sum(s["trips"]) + 1,
              f"{tag}: {s['launches']} launches, want trips + 1 = "
              f"{sum(s['trips']) + 1}")
        bad = oc.check_structure(entry, variant, s)
        check(not bad, f"{tag}: " + "; ".join(bad))
        r = s["repeat"]
        check(r["builds"] == 0 and r["nvcc"] == 0,
              f"{tag}: the repeat call built {r['builds']}, ran nvcc "
              f"{r['nvcc']} times")
        check(r["ops"] == s["ops"] and r["launches"] == s["launches"],
              f"{tag}: the repeat call ran other ops or launches")
        # the outputs against the plain version (the CPU's)
        ref = cpu["outputs"]
        f32 = variant.startswith("float32")
        errs = {}
        for k, v in s["outputs"].items():
            g, w = v.detach().cpu(), ref[k].detach()
            if k in EXACT:
                if not f32:
                    check(torch.equal(g, w), f"{tag}: {k} differs")
                continue
            scale = float(w.abs().max()) or 1.0
            errs[k] = float((g - w).abs().max()) / scale
            tol = ANALYSIS_F32_TOL if f32 else SLICE_TOL
            check(errs[k] <= tol, f"{tag}: {k} off by {errs[k]:.3e} x max "
                  f"(tol {tol:g})")
        row["max_rel_err"] = max(errs.values())
        row["exact_equal"] = all(torch.equal(
            s["outputs"][k].detach().cpu(), ref[k]) for k in EXACT
            if k in ref)
    res["phase_s"] = time.time() - t_phase
    print(f"analysis on {card}: per-entry aten ops (the CPU baseline, "
          "raft_tpu_torch/analysis/op_baseline.json, torch "
          f"{base.get('torch')}; held entries also the CPU here, torch "
          f"{torch.__version__}) and on the card, solve kernel launches, "
          "host syncs, host-to-card copies:")
    for name, r in res["entries"].items():
        extra = (f", outputs within {r['max_rel_err']:.2e} x max of the "
                 f"CPU's, exact keys {'equal' if r['exact_equal'] else 'differ'}"
                 if "max_rel_err" in r else "")
        here = (f" (here {r['cpu_here_ops']})" if "cpu_here_ops" in r
                else "")
        print(f"  analysis {name}: ops CPU {r['cpu_ops']}{here} card "
              f"{r['card_ops']} ({r['solves']} x raft.solve), launches "
              f"{r['launches']}, syncs {r['syncs']}, h2d {r['h2d']}, trips "
              f"{r['trips']}, {r['wall_s']:.2f} s{extra}")
    print(f"  analysis: held entries' ops equal the CPU's, launches "
          f"= trips + 1, repeat calls built 0 and ran nvcc 0 times; ge_solve "
          f"launches {res['launches']}; phase {res['phase_s']:.1f} s of its "
          f"{ANALYSIS_BUDGET_S:.0f} s budget")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per-design", type=int, default=1024)
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
        rec["kernel12"] = timed("kernel12", phase_kernel12)
        bem_host = start_bem_host(args.out)
        rec["farm"], farm_ev, farm_x0 = timed("farm", phase_farm,
                                              rec["card"])
        rec["profile_farm"] = timed("profile_farm", phase_profile_farm,
                                    farm_ev, farm_x0)
        rec["flex"] = timed("flex", phase_flex, rec["card"])
        rec["bem"], bem_geo = timed("bem", phase_bem, args.out, rec["card"],
                                    bem_host)
        rec["grad_paths"] = timed("grad_paths", phase_grad_paths, evs,
                                  rec["farm"]["grad"], bem_geo, rec["card"])
        rec["fwd"] = timed("fwd", phase_fwd, models, evs, geo_ev, bem_geo,
                           rec["card"])
        rec["qtf"] = timed("qtf", phase_qtf, rec["card"])
        rec["analyze"] = timed("analyze", phase_analyze, args.out,
                               rec["card"])
        rec["omdao"] = timed("omdao", phase_omdao, rec["card"])
        rec["sweep"] = timed("sweep", phase_sweep, evs["semi_wind"], models,
                             args.out, rec["card"])
        rec["fabric"] = timed("fabric", phase_fabric, args.out, rec["card"])
        rec["serve"] = timed("serve", phase_serve, rec["card"], args.out)
        rec["aot"] = timed("aot", phase_aot, args.out, rec["card"])
        rec["fleet"] = timed("fleet", phase_fleet, args.out, rec["card"],
                             rec["serve"])
        rec["analysis"] = timed("analysis", phase_analysis, rec["card"])
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    k = rec["kernel"]
    a = rec["grad"]["adjoint"]
    rec["launches_by_path"] = dict(
        slice=rec["slice"]["launches"], design=rec["design"]["launches"],
        **{f"full_{n}": r["launches"] for n, r in rec["full"].items()},
        geometry=rec["geometry"]["launches"],
        grad=rec["grad"]["fwd_launches"],
        grad_adjoint=rec["grad"]["adj_launches"],
        grad_paths=rec["grad_paths"]["fwd_launches"],
        grad_paths_adjoint=rec["grad_paths"]["adj_launches"],
        fwd=rec["fwd"]["launches"],
        farm_warm_fwd=rec["farm"]["grad"]["fwd_launches"],
        farm=rec["farm"]["launches"], bem=rec["bem"]["launches"],
        bem_geometry=rec["bem"]["geometry"]["launches"],
        qtf=rec["qtf"]["launches"],
        qtf_geometry=rec["qtf"]["geometry"]["launches"],
        analyze=rec["analyze"]["launches"],
        omdao=rec["omdao"]["launches"], sweep=rec["sweep"]["launches"],
        fabric=rec["fabric"]["launches"], serve=rec["serve"]["launches"],
        aot=rec["aot"]["launches"], fleet=rec["fleet"]["launches"],
        analysis=rec["analysis"]["launches"])
    k12 = rec["kernel12"]["forward"]
    a12 = rec["kernel12"]["adjoint"]
    kernels = [dict(
        name="ge_solve", route="cuda",
        source="raft_tpu_torch/csrc/linsolve.cu",
        replaces="raft_tpu/ops/linsolve.py:277",
        launches=(rec["slice"]["launches"] + rec["design"]["launches"]
                  + sum(r["launches"] for r in rec["full"].values())
                  + rec["geometry"]["launches"]
                  + rec["grad"]["fwd_launches"] + rec["farm"]["launches"]
                  + rec["bem"]["launches"]
                  + rec["grad_paths"]["fwd_launches"]
                  + rec["fwd"]["launches"]
                  + rec["farm"]["grad"]["fwd_launches"]
                  + rec["bem"]["geometry"]["launches"]
                  + rec["qtf"]["launches"]
                  + rec["qtf"]["geometry"]["launches"]
                  + rec["analyze"]["launches"]
                  + rec["omdao"]["launches"]
                  + rec["sweep"]["launches"]
                  + rec["fabric"]["launches"]
                  + rec["serve"]["launches"]
                  + rec["aot"]["launches"]
                  + rec["fleet"]["launches"]
                  + rec["analysis"]["launches"]),
        analyze_launches=rec["analyze"]["launches"],
        omdao_launches=rec["omdao"]["launches"],
        sweep_launches=rec["sweep"]["launches"],
        fabric_launches=rec["fabric"]["launches"],
        serve_launches=rec["serve"]["launches"],
        aot_launches=rec["aot"]["launches"],
        fleet_launches=rec["fleet"]["launches"],
        analysis_launches=rec["analysis"]["launches"],
        max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=k["library_ms"],
        n12_ms=k12["ms"], n12_wrapper_ms=k12["wrapper_ms"],
        n12_plain_ms=k12["plain_ms"], n12_bound_ms=k12["bound_ms"],
        n12_library_ms=k12["library_ms"],
        n12_max_abs_err=k12["max_abs_err"],
        n12_launches=(rec["farm"]["row_launches"]
                      + rec["farm"]["grad"]["row_fwd_launches"]
                      + rec["analyze"]["row_launches"])), dict(
        name="ge_solve_adj", route="cuda",
        source="raft_tpu_torch/csrc/linsolve.cu",
        replaces="raft_tpu/ops/linsolve.py:277",
        launches=(rec["grad"]["adj_launches"]
                  + rec["grad_paths"]["adj_launches"]),
        max_abs_err=a["max_abs_err"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=a["library_ms"],
        n12_ms=a12["ms"], n12_wrapper_ms=a12["wrapper_ms"],
        n12_plain_ms=a12["plain_ms"], n12_bound_ms=a12["bound_ms"],
        n12_library_ms=a12["library_ms"],
        n12_max_abs_err=a12["max_abs_err"],
        n12_launches=(rec["grad"]["row_launches"]
                      + rec["grad_paths"]["row_adj_launches"]))]
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
