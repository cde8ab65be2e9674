"""Seeded protocol bug: the rollout-gate fleet-wide-pass race.

A gate that is not keyed to the replaced replica's post-seize
observation run counts *fleet-wide* fresh canary passes: probes
of neighbor replicas (or of the candidate at its pre-seize endpoint)
can satisfy ``need`` and turn the gate green before the upgraded
process has ever answered a probe.

The model checker must catch this through the gate-candidate-probed
invariant in the rollout-gate scenario.  ``python -m raft_tpu_torch.analysis
protocol check --fixture <this file>`` must exit 1.
"""


def gate_decision(payload, baseline, need, replica=None, endpoint=None):
    # the racy gate: replica/endpoint accepted but IGNORED —
    # any fresh pass anywhere in the fleet counts toward `need`.
    can = (payload or {}).get("canary")
    if not can:
        return "pending", "no-canary"
    fails = int(can.get("fails") or 0) - baseline["fails"]
    if fails > 0:
        return "red", "canary-fail"
    if not can.get("parity_ok", True):
        return "red", "canary-parity"
    active = (payload or {}).get("active") or []
    if active:
        names = sorted(a.get("rule") or "?" for a in active)
        return "red", "alert:" + ",".join(names)
    fresh = int(can.get("passes") or 0) - baseline["passes"]
    if fresh >= need:
        return "green", f"canary-green({fresh})"
    return "pending", "waiting"


PATCHES = {
    "raft_tpu_torch.serve.rollout:gate_decision": gate_decision,
}

SCENARIOS = ("rollout-gate",)
