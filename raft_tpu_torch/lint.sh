#!/bin/sh
# The port's lint gate: ruff (when installed) + the port's checkers
# (python -m raft_tpu_torch.analysis) + its offline CLI contracts.
#
# The counterpart of the repository's root lint.sh, line for line, over
# raft_tpu_torch/ and its fixtures (tests/fixtures/torch_lint/,
# tests/fixtures/torch_protocol/, tests/fixtures/torch_contracts/; the
# record fixtures under
# tests/fixtures/{releases,obs,obs_router,flight,runs} are the
# reference's, which the port reads as they are).  Every line of the
# root script has its counterpart here; the reference's jaxpr contracts
# are the port's op contracts (`analysis contracts`: the aten ops each
# hot-path entry runs on the spar demo, recorded on the CPU).
#
#     raft_tpu_torch/lint.sh && python -m pytest tests/test_torch_*.py -q -m 'not slow'
#
# The checked-in tree lints CLEAN — exit 1 means a new finding.
# Suppress an audited exception inline with
# `# raft-lint: disable=<rule> (reason)`.
set -e
cd "$(dirname "$0")/.."
tmp="${TMPDIR:-/tmp}"

if command -v ruff >/dev/null 2>&1; then
    # error-class rules only (syntax errors, undefined names, misused
    # comparisons): meaningful everywhere, no style churn
    ruff check --quiet --select E9,F63,F7,F82 raft_tpu_torch chip_smoke.py
else
    echo "raft_tpu_torch/lint.sh: ruff not installed; skipping ruff" \
         "(the port's linter still runs)"
fi

python -m raft_tpu_torch.analysis lint

# concurrency invariants over the shared-state + serve modules:
# atomic-write / async-blocking / lock-discipline / thread-hygiene —
# the checked-in tree is CLEAN, and each seeded bad fixture must be
# caught with EXACTLY exit 1 (a crash/usage error is a broken engine,
# not a caught finding)
python -m raft_tpu_torch.analysis concurrency
for fixture in bad_atomic bad_async bad_lock bad_thread; do
    conc_rc=0
    python -m raft_tpu_torch.analysis concurrency \
        "tests/fixtures/torch_lint/$fixture.py" > /dev/null 2>&1 \
        || conc_rc=$?
    if [ "$conc_rc" -ne 1 ]; then
        echo "raft_tpu_torch/lint.sh: analysis concurrency exited" \
             "$conc_rc on the $fixture fixture (want 1: findings" \
             "reported)" >&2
        exit 1
    fi
done

# cross-process schema contracts: writer/reader key sets of every
# record family must match raft_tpu_torch/analysis/schema_baseline.json
# with no reader-never-written / required-but-conditional drift; the
# seeded drifted-lease fixture must be caught with EXACTLY exit 1
python -m raft_tpu_torch.analysis schemas
schema_rc=0
python -m raft_tpu_torch.analysis schemas --fixture > /dev/null 2>&1 \
    || schema_rc=$?
if [ "$schema_rc" -ne 1 ]; then
    echo "raft_tpu_torch/lint.sh: analysis schemas --fixture exited" \
         "$schema_rc on the drifted-lease fixture (want 1: drift" \
         "caught)" >&2
    exit 1
fi

# protocol model checker: every shared-fs mutation site in the six
# protocol modules (fabric, fleet, release, rollout, router, canary)
# must match raft_tpu_torch/analysis/protocol_baseline.json, and the
# interleaving + crash-injection explorer must find no invariant
# violation over the port's protocol functions; each seeded race (the
# check-then-write claim, the fleet-wide gate, a raw-rename sidecar)
# must be caught with EXACTLY exit 1
python -m raft_tpu_torch.analysis protocol check
for fixture in claim_hijack gate_fleetwide unmodeled_site; do
    proto_rc=0
    python -m raft_tpu_torch.analysis protocol check \
        --fixture "tests/fixtures/torch_protocol/$fixture.py" \
        > /dev/null 2>&1 || proto_rc=$?
    if [ "$proto_rc" -ne 1 ]; then
        echo "raft_tpu_torch/lint.sh: analysis protocol exited" \
             "$proto_rc on the $fixture fixture (want 1: seeded race" \
             "caught)" >&2
        exit 1
    fi
done

# op contracts of the hot-path entries on the spar demo: at most one
# gather in the drag linearisation, one host sync per SCAN_CHUNK trips,
# no 64-bit op in the float32 trips, a repeat call that builds
# nothing, and the op budgets of raft_tpu_torch/analysis/op_baseline.json;
# each seeded negative (a geometry gather re-done in the drag
# linearisation, a float64 op in the float32 trips) must be caught
# with EXACTLY exit 1
python -m raft_tpu_torch.analysis contracts
for fixture in regather float64_trip; do
    contract_rc=0
    python -m raft_tpu_torch.analysis contracts \
        --fixture "tests/fixtures/torch_contracts/$fixture.py" \
        > /dev/null 2>&1 || contract_rc=$?
    if [ "$contract_rc" -ne 1 ]; then
        echo "raft_tpu_torch/lint.sh: analysis contracts exited" \
             "$contract_rc on the $fixture fixture (want 1: negative" \
             "caught)" >&2
        exit 1
    fi
done

# program-bank integrity: entries parse, payload checksums/sizes match
# their metadata, no orphaned half-writes; stale entries are reported
# but don't fail.  Trivially clean on an empty bank.
python -m raft_tpu_torch.aot verify

# release-manifest integrity: the good manifest fixture must verify
# clean (exit 0) and the tampered twin must be caught with EXACTLY
# exit 1; a pure file check, no bank and no torch
python -m raft_tpu_torch.aot release verify \
    --manifest tests/fixtures/releases/good.json > /dev/null
release_rc=0
python -m raft_tpu_torch.aot release verify \
    --manifest tests/fixtures/releases/tampered.json > /dev/null 2>&1 \
    || release_rc=$?
if [ "$release_rc" -ne 1 ]; then
    echo "raft_tpu_torch/lint.sh: aot release verify exited $release_rc" \
         "on the tampered manifest fixture (want 1: tamper caught)" >&2
    exit 1
fi

# cross-process trace assembly: the two-process capture must merge onto
# one timeline with every span balanced and every parent id resolving
python -m raft_tpu_torch.obs trace --merge tests/fixtures/obs \
    -o "$tmp/raft_torch_obs_merge_check.json" --check > /dev/null

# serving-fleet trace assembly: the router + replica shards must merge
# with 0 orphan spans
python -m raft_tpu_torch.obs trace --merge tests/fixtures/obs_router \
    -o "$tmp/raft_torch_obs_router_merge_check.json" --check > /dev/null

# flight-recorder shards: the valid dump must pass `obs flight show`
# (exit 0) and the truncated twin must be refused with EXACTLY exit 1
python -m raft_tpu_torch.obs flight show tests/fixtures/flight/valid.jsonl \
    > /dev/null
flight_rc=0
python -m raft_tpu_torch.obs flight show \
    tests/fixtures/flight/truncated.jsonl > /dev/null 2>&1 || flight_rc=$?
if [ "$flight_rc" -ne 1 ]; then
    echo "raft_tpu_torch/lint.sh: obs flight show exited $flight_rc on" \
         "the truncated shard fixture (want 1: damage refused)" >&2
    exit 1
fi

# alert-rule engine: the default rule pack must validate, the clean
# run-record fixture must replay with no rule firing (exit 0), and the
# seeded alerting fixture must be caught with EXACTLY exit 1
python -m raft_tpu_torch.obs alerts check > /dev/null
python -m raft_tpu_torch.obs alerts eval \
    --record tests/fixtures/runs/clean.json > /dev/null
alerts_rc=0
python -m raft_tpu_torch.obs alerts eval \
    --record tests/fixtures/runs/alerting.json > /dev/null 2>&1 \
    || alerts_rc=$?
if [ "$alerts_rc" -ne 1 ]; then
    echo "raft_tpu_torch/lint.sh: obs alerts eval exited $alerts_rc on" \
         "the alerting fixture (want 1: rules fired)" >&2
    exit 1
fi

# perf-regression sentinel: against the baseline record, the clean
# fixture run must PASS (exit 0) and the regressed fixture must be
# CAUGHT with EXACTLY exit 1 (exit 2 is a broken sentinel)
python -m raft_tpu_torch.obs runs regress tests/fixtures/runs/clean.json \
    --baseline tests/fixtures/runs/baseline.json --check > /dev/null
regress_rc=0
python -m raft_tpu_torch.obs runs regress \
    tests/fixtures/runs/regressed.json \
    --baseline tests/fixtures/runs/baseline.json --check \
    > /dev/null 2>&1 || regress_rc=$?
if [ "$regress_rc" -ne 1 ]; then
    echo "raft_tpu_torch/lint.sh: obs runs regress exited $regress_rc" \
         "on the regressed fixture (want 1: regression caught)" >&2
    exit 1
fi
