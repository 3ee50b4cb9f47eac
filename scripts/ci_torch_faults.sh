#!/usr/bin/env bash
# Fault-tolerance gate of the PyTorch port (gym_tpu_torch), the twin of
# scripts/ci_faults.sh and the train half of scripts/ci_sdc.sh, run next
# to the tier-1 suite (which leaves out the slow-marked campaigns).
#
#   1. the kill harness (tests/test_torch_kill_harness.py): Trainer.fit in
#      a subprocess, SIGKILL at dispatch.boundary, prefetch.fill,
#      checkpoint.write and checkpoint.device_get, the SIGTERM drill, and
#      the compressed-DiLoCo residual round trip: every relaunch ends with
#      a train.csv byte-identical to an uninterrupted run's; plus its
#      seeded chaos campaigns (5 seeds of random fault mixes over every
#      train-pipeline site, the copied gym_tpu_torch/utils/chaos.py): no
#      silent divergence, every failure typed, recovery completes;
#   2. the in-process suites: the manager, the sidecars, the prefetcher,
#      the resume knob and the preemption drill
#      (tests/test_torch_resilience.py), the guard's rollback-and-replay
#      (tests/test_torch_guard.py) and resume against gym_tpu
#      (tests/test_torch_checkpoint.py).
#
# CPU only; the kill harness's subprocesses run one thread each.
#
# Usage: scripts/ci_torch_faults.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
log="${TMPDIR:-/tmp}/_torch_faults.log"
rm -f "$log"
timeout -k 10 900 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_kill_harness.py tests/test_torch_resilience.py \
    tests/test_torch_guard.py tests/test_torch_checkpoint.py -q \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo TORCH_FAULT_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
exit $rc
