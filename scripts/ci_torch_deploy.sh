#!/usr/bin/env bash
# Continuous-deployment gate of the PyTorch port (gym_tpu_torch), the CPU
# twin of scripts/ci_deploy.sh:
#
# 1. the port's servesim suite (traces byte-equal to gym_tpu's, the cost
#    model equal to gym_tpu's, calibration against a live fleet);
# 2. the serving-policy FRONTIER regression gate of the port against the
#    committed baseline (logs/servesim/frontier_baseline.json) —
#    deterministic cost-model path;
# 3. the TENANT frontier gate against the committed baseline
#    (logs/servesim/tenant/tenant_baseline.json);
# 4. the CLOSED TRAIN->DEPLOY LOOP drill on the CPU: a live trainer
#    (SIGKILLed mid-run and resumed) streams checkpoints into a
#    reload-watching OUT-OF-PROCESS fleet while a trace replays open-loop.
#    Gates: zero dropped requests, zero recompiles across every hot swap
#    (the workers' programs_compiled), post-swap streams byte-exact
#    against generate_fast;
# 5. no worker process leaked.
#
# Left out: ci_deploy.sh's bench.py rider (--tracesim-only, the
# sim-vs-live agreement); it comes with the port's benchmark. On the card
# the drill is chip_smoke.py phase 14b.
#
# Usage: scripts/ci_torch_deploy.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
REPO="$(pwd)"
TMP="${TMPDIR:-/tmp}"

log="$TMP/_torch_deploy.log"
rm -f "$log"
timeout -k 10 600 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_servesim.py -q -m 'not slow' \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo DEPLOY_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

# policy-frontier regression gate (deterministic cost-model path)
timeout -k 10 300 env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.servesim.frontier_gate \
    --baseline logs/servesim/frontier_baseline.json || {
    echo "ci_torch_deploy: serving frontier regression"; exit 1; }

# tenant-isolation frontier gate: per-class SLO attainment + kept batch
# goodput vs the baseline
timeout -k 10 300 env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.servesim.tenant_gate \
    --baseline logs/servesim/tenant/tenant_baseline.json || {
    echo "ci_torch_deploy: tenant-isolation frontier regression"; exit 1; }

# the closed train->deploy loop: trainer (killed + resumed) ->
# --reload-watch process fleet -> open-loop trace replay; the drill
# asserts zero dropped / zero recompiles / post-swap streams exact and
# exits nonzero otherwise
OUT=${GYM_TPU_CI_DEPLOY_OUT:-$TMP/gym_tpu_torch_ci_deploy}
rm -rf "$OUT"; mkdir -p "$OUT"
timeout -k 10 900 env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.servesim.drill --out "$OUT/drill" \
    --replicas 2 --out-of-process --kill-trainer --device cpu \
    2>&1 | tee "$OUT/drill.log" | grep -v '"POST /generate'
rc=${PIPESTATUS[0]}
[ "$rc" -ne 0 ] && { echo "ci_torch_deploy: closed-loop drill failed";
    tail -40 "$OUT/drill.log"; exit "$rc"; }
grep -q '"ok": true' "$OUT/drill.log" || {
    echo "ci_torch_deploy: drill reported not-ok"; tail -40 "$OUT/drill.log";
    exit 1; }
pgrep -f "gym_tpu_torch.serve.worker" > /dev/null && {
    echo "ci_torch_deploy: leaked worker processes:";
    pgrep -af "gym_tpu_torch.serve.worker"; exit 1; }

echo "ci_torch_deploy: OK"
exit 0
