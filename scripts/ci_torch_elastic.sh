#!/usr/bin/env bash
# Elastic-membership gate of the PyTorch port (gym_tpu_torch), the CPU
# twin of scripts/ci_elastic.sh:
#
# 1. the port's elastic suite: the ZeRO-2 checkpoint shards bit-equal to
#    gym_tpu's codec, K->K'->K bit-identical for both layouts (the pad
#    tail included), a K=2 fit resumed at K'=3 against gym_tpu's same
#    fits, the typed error on per-node state with nothing quarantined, no
#    program built by a second reshard, the controller and elastic_fit
#    against gym_tpu's, and the kill drill (SIGKILL past a durable save,
#    resume at K-1 and K+1, pre-kill rows verbatim, the loss bounded);
# 2. the reshard-vs-cold-restart frontier gate against the committed
#    baseline (logs/frontier/elastic_frontier.json), read and never
#    rewritten.
#
# Left out: ci_elastic.sh's jaxpr audit of the reshard programs; the
# port's analysis layer comes with ROADMAP Queue A item 17. On the card
# the drill is chip_smoke.py phase 15b.
#
# Usage: scripts/ci_torch_elastic.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
REPO="$(pwd)"
TMP="${TMPDIR:-/tmp}"

log="$TMP/_torch_elastic.log"
rm -f "$log"
timeout -k 10 600 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_elastic.py -q \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo ELASTIC_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

# the deterministic membership-event frontier against the baseline
timeout -k 10 300 env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.sim.elastic_frontier \
    --baseline logs/frontier/elastic_frontier.json || {
    echo "ci_torch_elastic: elastic frontier regression"; exit 1; }
echo "ci_torch_elastic: OK"
exit 0
