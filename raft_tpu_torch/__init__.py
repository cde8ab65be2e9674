"""PyTorch/CUDA port of raft_tpu: its orchestrated analysis path and
its rigid-FOWT, flexible-FOWT and farm evaluators.

The JAX package :mod:`raft_tpu` is the reference; this package mirrors
its module paths (``raft_tpu_torch/ops/linsolve.py`` is the counterpart
of ``raft_tpu/ops/linsolve.py``, and so on) and imports neither JAX nor
anything of :mod:`raft_tpu`.

Entry points:

* :func:`raft_tpu_torch.drivers.run` / :func:`~raft_tpu_torch.drivers.
  run_farm` and ``python -m raft_tpu_torch design.json [--csv out.csv]
  [--device cpu]`` — a design's whole case table through
  :meth:`~raft_tpu_torch.models.model.Model.analyze_cases` (the
  reference's runRAFT), its channel statistics as CSV;
* :class:`raft_tpu_torch.models.model.Model` — one design (a dict or a
  ``.json``/``.yaml`` path) built on the host: structure, mooring
  (quasi-static catenary, networks, and the lumped-mass line dynamics of
  ``moorMod`` 1 and 2), statics, strips and zero-pose hydro constants;
  its orchestrated path, one case at a time: ``solve_statics``,
  ``solve_dynamics``, ``solve_eigen``, ``calc_outputs``,
  ``write_modes_json`` and ``analyze_cases``;
* :class:`raft_tpu_torch.omdao.DesignEvaluation` — the optimizer-loop
  surface: a design in, flat metrics out (properties, per-case channel
  statistics, natural periods, WEIS aggregates), an unchanged design's
  cases through the farm, full or flexible evaluator behind a
  content-addressed result cache (:mod:`raft_tpu_torch.serve.cache`,
  :func:`raft_tpu_torch.aot.bank.content_fingerprint`), overrides and
  other designs through ``analyze_cases``;
  :class:`~raft_tpu_torch.omdao.RAFT_OMDAO_Core` — WEIS's flat inputs
  rebuilt into a design, analysed and flattened into WEIS's outputs;
* :mod:`raft_tpu_torch.plotting` — ``plot_system``, ``plot2d``,
  ``plot_responses`` and ``plot_responses_extended`` (matplotlib,
  imported by each plot function only);
* :func:`raft_tpu_torch.structure.bucketing.bucket_signature` /
  :func:`~raft_tpu_torch.structure.bucketing.pack_design` — a model's
  bucket and its padded numpy leaves;
* :func:`raft_tpu_torch.api.make_case_evaluator` /
  :func:`~raft_tpu_torch.api.make_design_evaluator` — one design's
  batched sea-state and design-axis (drag / added-mass / mooring-length
  scales) evaluators;
* :func:`raft_tpu_torch.api.make_full_evaluator` — one design's batched
  full-physics evaluator (rotor aero-servo with load derivatives,
  submerged-rotor blade hydro, current loads, several wave headings,
  potential-flow coefficients from the host panel solver or WAMIT
  files) over rows of wind, current and seas, with
  :func:`~raft_tpu_torch.api.case_to_traced` turning a case-table row
  into its row parameters;
* :meth:`raft_tpu_torch.models.model.Model.run_bem` — the potential-flow
  coefficients of a design's potMod members: the panel mesh
  (:mod:`raft_tpu_torch.io.panels`), the host C++ panel solver
  (:mod:`raft_tpu_torch.native`, ``csrc/panel_bem.cpp`` built with g++
  at first use) and the WAMIT files (:mod:`raft_tpu_torch.io.wamit`);
* :func:`raft_tpu_torch.api.make_flexible_evaluator` — one flexible or
  multibody design's batched evaluator (beam members as FE chains,
  reduced N-DOF structures: general statics, the displaced-pose
  topology replayed in torch over rows, the N-DOF drag linearisation
  and impedance solves), with a geometry axis over
  host-rebuilt designs (:func:`~raft_tpu_torch.api.
  flexible_struct_params`);
* :func:`raft_tpu_torch.api.make_farm_evaluator` — an array design's
  batched farm evaluator (several rigid units, their own moorings and a
  shared-mooring network from a MoorDyn file, the coupled statics and
  the system response);
* :class:`raft_tpu_torch.structure.bucketing.BucketEvaluator` — one
  bucket signature's batched evaluator (statics, excitation, drag
  fixed point, response);
* :func:`raft_tpu_torch.parallel.sweep.sweep_heterogeneous` — mixed
  models or packed designs x sea states, grouped by signature and
  chunked;
* :func:`raft_tpu_torch.structure.bucketing.load_packed` /
  :func:`~raft_tpu_torch.structure.bucketing.packed_from_numpy` — the
  packed-design seam between the two packages.

Every evaluator is differentiable in reverse mode with respect to its
row inputs (sea states, wind, current, turbulence, yaw, design and
geometry scales, a flexible design's ``struct_params``):
``torch.autograd.grad`` of a metric of the outputs.

They run on the CUDA device unless ``device="cpu"`` is passed; without
a card and without an explicit device they raise.  The one hand-written
kernel is the batched complex solve, ``csrc/linsolve.cu``, built with
``nvcc`` at first use into ``raft_tpu_torch/build/``; the panel solver
is host C++, as in the reference.
"""
