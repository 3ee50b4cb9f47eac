#!/usr/bin/env bash
# Network-simulation gate of the PyTorch port (gym_tpu_torch), the CPU
# twin of scripts/ci_sim.sh:
#
# 1. the port's sim suite (the copied topology/cost model/simulator pinned
#    to gym_tpu's, every strategy's trace priced equal to gym_tpu's on
#    every preset, trace vs cum_comm_bytes on real fits, the frontier
#    gates, a tiny sweep with a join cell and its resume);
# 2. a CPU sweep through the CLI entry point (--device cpu), the same
#    cells and the same checks on report.md, results.json and
#    frontier.csv as ci_sim.sh's;
# 3. the compressed-gossip frontier gate against the committed baseline
#    (logs/frontier/frontier_baseline.json), read and never rewritten.
#
# On the card the sweep is chip_smoke.py phase 15c.
#
# Usage: scripts/ci_torch_sim.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
REPO="$(pwd)"
TMP="${TMPDIR:-/tmp}"

log="$TMP/_torch_sim.log"
rm -f "$log"
timeout -k 10 600 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_sim.py tests/test_torch_compress.py -q \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo SIM_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

# CLI smoke sweep: a fresh out dir (a stale one would resume-skip every
# cell and test nothing), 4 strategies x 2 topologies, tiny steps, the
# low-communication cells and the codec axis
SWEEP_OUT=${GYM_TPU_CI_SWEEP_OUT:-$TMP/gym_tpu_torch_ci_sweep}
rm -rf "$SWEEP_OUT"
timeout -k 10 420 env PYTHONPATH="$REPO" python -m gym_tpu_torch.sim.sweep \
    --preset wan,datacenter \
    --strategies diloco,simple_reduce,noloco,dynamiq_int8 \
    --codecs dense,int4 \
    --nodes 2 --steps 8 --batch_size 4 --block_size 32 \
    --n_layer 1 --n_embd 32 --out "$SWEEP_OUT" --device cpu
rc=$?
[ "$rc" -ne 0 ] && exit "$rc"
grep -q "Headline: DiLoCo" "$SWEEP_OUT/report.md" || {
    echo "ci_torch_sim: sweep report missing the DiLoCo headline"; exit 1; }
grep -q "RECONCILIATION FAILURES" "$SWEEP_OUT/report.md" && {
    echo "ci_torch_sim: trace/cum_comm_bytes reconciliation failed"; exit 1; }
for cell in noloco_H10_n2_wan noloco_H10_int4_n2_wan \
            diloco_H10_int4_n2_wan dynamiq_int8_n2_wan; do
    grep -q "\"cell\": \"$cell\"" "$SWEEP_OUT/results.json" || {
        echo "ci_torch_sim: sweep missing cell $cell"; exit 1; }
done
grep -q "^wan,2,noloco" "$SWEEP_OUT/frontier.csv" || {
    echo "ci_torch_sim: frontier.csv missing the noloco verdict row"; exit 1; }
grep -q "noloco H=10 int4" "$SWEEP_OUT/frontier.csv" || {
    echo "ci_torch_sim: frontier.csv missing the compressed-gossip row";
    exit 1; }
grep -q "^wan,2,dynamiq int8" "$SWEEP_OUT/frontier.csv" || {
    echo "ci_torch_sim: frontier.csv missing the dynamiq verdict row";
    exit 1; }

# the frontier regression gate: the federated family re-priced through the
# cost model against the committed baseline
timeout -k 10 300 env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.sim.frontier_gate \
    --baseline logs/frontier/frontier_baseline.json || {
    echo "ci_torch_sim: frontier regression gate failed"; exit 1; }
echo "ci_torch_sim: OK (report at $SWEEP_OUT/report.md)"
exit 0
