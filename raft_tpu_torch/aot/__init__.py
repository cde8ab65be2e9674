"""The program bank, its warm-up and its releases (the port's counterpart
of ``raft_tpu/aot``).

:mod:`raft_tpu_torch.aot.bank` records the programs a warm-up built and
ran (a sidecar keyed by program identity, input signature, environment
and version, and the kernel library it ran), so a fresh process loads
them instead of building them; :mod:`raft_tpu_torch.aot.warmup` fills
it through the production funnels; :mod:`raft_tpu_torch.aot.release`
cuts signed, content-addressed snapshots of it.  ``python -m
raft_tpu_torch.aot {warmup,list,verify,gc,release}`` is the operator
surface.  Importing the package imports nothing else: the manifest
check runs without torch.
"""
