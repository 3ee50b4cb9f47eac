#!/usr/bin/env bash
# Chaos gate of the PyTorch port (gym_tpu_torch), the CPU twin of
# scripts/ci_chaos.sh's six layers against `python -m gym_tpu_torch.serve`:
#
#   1. the port's serving suites (the typed HTTP failures, the supervisor
#      and router twins, the process fleet's kill -9 splice);
#   2. the port's serve parity suite RE-RUN under injected latency faults
#      (GYM_TPU_FAULTS delay on every prefill and decode dispatch): token
#      streams must stay EXACT under host-side latency chaos;
#   3. the HTTP chaos smoke with an injected decode HANG: the supervisor
#      abandons the wedged driver, fails the in-flight request TYPED (503
#      inside its deadline), rebuilds the engine and answers the next
#      request; an infeasible deadline draws 429 + Retry-After; SIGTERM
#      exits 0 with a clean shutdown line;
#   4. the REPLICA-KILL drill against `--replicas 2 --max-restarts 0`: a
#      decode hang mid-stream on replica 0 becomes a hard engine death and
#      the client still gets its 200 through the sibling; SIGTERM exits 0
#      with replica 0's driver still wedged;
#   5. the PROCESS-KILL drill against `--out-of-process --replicas 2
#      --autoscale`: kill -9 the worker process serving a stream,
#      mid-stream, under concurrent load — zero dropped streams, the
#      spliced stream byte-identical to an uncontended run, the
#      autoscaler's respawn in /stats, and SIGTERM reaping every worker;
#   6. the TENANT-ISOLATION drill against `--preempt --quotas`: the
#      interactive victim's TTFT stays inside its SLO while a batch
#      tenant floods, the overflow sheds typed 429 + Retry-After, and a
#      parked-then-resumed flood stream equals its uncontended run.
#
# Left out: ci_chaos.sh's bench.py riders (--chaos-only, --fleet-only
# with its process A/B, --tenant-only); they come with the port's
# benchmark. On the card the process fleet is chip_smoke.py phase 14a.
#
# Usage: scripts/ci_torch_chaos.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
REPO="$(pwd)"

TMP="${TMPDIR:-/tmp}"

log="$TMP/_torch_chaos.log"
rm -f "$log"
timeout -k 10 600 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_serve_http.py tests/test_torch_serve_fleet.py \
    tests/test_torch_serve_procfleet.py -q -m 'not slow' \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo CHAOS_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

# Layer 2: the parity oracles must hold UNDER latency faults — a delayed
# dispatch may be slow, never wrong.
log2="$TMP/_torch_chaos2.log"
rm -f "$log2"
timeout -k 10 600 env JAX_PLATFORMS=cpu \
    GYM_TPU_FAULTS="serve.decode:delay=0.002,serve.prefill:delay=0.002" \
    python -m pytest tests/test_torch_serve.py -q -m 'not slow' \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log2"
rc=${PIPESTATUS[0]}
echo CHAOS_PARITY_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log2" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

# Layer 3: HTTP chaos smoke. Fresh tiny checkpoint, then the real server
# under an injected decode hang.
OUT=${GYM_TPU_CI_CHAOS_OUT:-$TMP/gym_tpu_torch_ci_chaos}
PORT=${GYM_TPU_CI_CHAOS_PORT:-8742}
rm -rf "$OUT"; mkdir -p "$OUT"

timeout -k 10 300 env PYTHONPATH="$REPO" python - "$OUT" <<'EOF'
import sys, numpy as np
from gym_tpu_torch import Trainer
from gym_tpu_torch.data import ArrayDataset
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.strategy import OptimSpec, SimpleReduceStrategy

out = sys.argv[1]
cfg = GPTConfig(block_size=32, vocab_size=48, n_layer=2, n_head=2,
                n_embd=32, dropout=0.0)
rng = np.random.default_rng(0)
toks = rng.integers(0, 48, (64, 33))
ds = ArrayDataset(toks[:, :-1].astype(np.int64),
                  toks[:, 1:].astype(np.int64))
Trainer(GPT(cfg), ds).fit(
    strategy=SimpleReduceStrategy(optim_spec=OptimSpec("adamw", lr=1e-3)),
    num_nodes=1, max_steps=4, batch_size=4, val_size=0, val_interval=0,
    show_progress=False, seed=1, checkpoint_interval=4, device="cpu",
    save_dir=out + "/ckpts", run_name="ci", log_dir=out + "/logs")
print("ci_torch_chaos: checkpoint trained")
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: training the smoke ckpt failed"; exit "$rc"; }

# Injected hang at decode dispatch 4 (request A consumes dispatches 1-3,
# so the hang lands in request B); the 15 s watchdog reaps it. Bare
# `python ... &` so $! is the server pid, not a subshell's.
env PYTHONPATH="$REPO" \
    GYM_TPU_FAULTS="serve.decode:hang=600@4" \
    python -m gym_tpu_torch.serve \
    --ckpt "$OUT/ckpts/ci" --port "$PORT" --num_slots 2 --device cpu \
    --dispatch-timeout 15 \
    > "$OUT/server.log" 2>&1 &
SRV=$!
for _ in $(seq 1 90); do
    grep -q "listening" "$OUT/server.log" && break
    kill -0 "$SRV" 2>/dev/null || { echo "ci_torch_chaos: server died at startup";
        cat "$OUT/server.log"; exit 1; }
    sleep 1
done
grep -q "listening" "$OUT/server.log" || {
    echo "ci_torch_chaos: server never started"; kill -9 "$SRV"; exit 1; }

timeout -k 10 240 env GYM_TPU_CI_CHAOS_PORT="$PORT" python - <<'EOF'
import json, os, time, urllib.error, urllib.request

port = os.environ["GYM_TPU_CI_CHAOS_PORT"]

def post(payload, timeout=120):
    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", body,
            {"Content-Type": "application/json"}), timeout=timeout)
        return r.status, json.loads(r.read()), r.headers, \
            time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers, \
            time.perf_counter() - t0

# A: dispatches 1-3 — completes, primes the programs + the tokens/s EWMA
code, body, _, dt = post({"prompt": [1, 2, 3], "max_new_tokens": 4,
                          "top_k": 4, "seed": 0, "deadline_s": 90})
assert code == 200 and len(body["tokens"]) == 4, (code, body)
print("ci_torch_chaos: pre-chaos request ok", body["tokens"])

# B: hits the hung dispatch 4 — must fail TYPED (503, not 500, not a
# connection drop) INSIDE its deadline, via supervisor failover
code, body, _, dt = post({"prompt": [1, 2, 3], "max_new_tokens": 8,
                          "top_k": 4, "seed": 1, "deadline_s": 60})
assert code == 503, (code, body)
assert "EngineFailedError" in body["error"], body
assert dt < 60, f"typed failure took {dt:.1f}s — past its deadline"
print(f"ci_torch_chaos: wedged request failed typed in {dt:.1f}s (503)")

# C: post-chaos — the rebuilt engine serves cleanly
code, body, _, dt = post({"prompt": [1, 2, 3], "max_new_tokens": 6,
                          "top_k": 4, "seed": 2, "deadline_s": 90})
assert code == 200 and len(body["tokens"]) == 6, (code, body)
assert dt < 90, f"post-chaos request took {dt:.1f}s"
print("ci_torch_chaos: post-chaos request ok", body["tokens"])

# D: infeasible deadline — shed at admission: 429 + Retry-After, never
# enqueued
code, body, headers, _ = post({"prompt": [1, 2, 3],
                               "max_new_tokens": 28,
                               "deadline_s": 1e-4})
assert code == 429, (code, body)
assert headers.get("Retry-After") is not None, dict(headers)
print("ci_torch_chaos: infeasible deadline shed at admission "
      f"(429, Retry-After={headers['Retry-After']})")

stats = json.loads(urllib.request.urlopen(
    f"http://127.0.0.1:{port}/stats", timeout=30).read())
assert stats["engine_restarts"] == 1, stats
assert stats["requests_rejected"] == 1, stats
assert stats["status"] == "ok", stats
print("ci_torch_chaos: stats ok —",
      json.dumps({k: stats[k] for k in
                  ("engine_restarts", "requests_done", "requests_failed",
                   "requests_rejected")}))
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: HTTP chaos drill failed";
    cat "$OUT/server.log"; kill -9 "$SRV"; exit "$rc"; }

grep -q "supervisor — engine rebuilt" "$OUT/server.log" || {
    echo "ci_torch_chaos: no supervisor-rebuild line in server log";
    cat "$OUT/server.log"; exit 1; }

# SIGTERM drill: the server must still exit 0 cleanly AFTER an engine
# failover (the abandoned wedged thread is a daemon, still asleep)
kill -TERM "$SRV"
wait "$SRV"; rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: server exit rc=$rc after SIGTERM";
    cat "$OUT/server.log"; exit 1; }
grep -q "shut down cleanly" "$OUT/server.log" || {
    echo "ci_torch_chaos: no clean-shutdown line"; cat "$OUT/server.log"; exit 1; }
grep -q "engine restart" "$OUT/server.log" || {
    echo "ci_torch_chaos: no restart count in shutdown line";
    cat "$OUT/server.log"; exit 1; }

# Layer 4: replica-kill drill — same tiny checkpoint, 2 replicas, zero
# restart budget. Request A (max_new 4: prefill + decode dispatches 1-3)
# primes replica 0; request B (max_new 8) lands on replica 0 too (idle
# tie-break) and wedges at decode dispatch 6 — MID-stream, ~3 tokens in.
# The 15 s watchdog reaps the wedged driver, the exhausted budget
# declares replica 0 dead, and the router must retry B on replica 1
# under B's remaining deadline: the client sees 200 and the full 8
# tokens, never the death. --drain-deadline is short because replica 0's
# driver is STILL wedged at SIGTERM: close must dump its stacks and fail
# its requests typed instead of waiting out the hang.
PORT2=$((PORT + 1))
env PYTHONPATH="$REPO" \
    GYM_TPU_FAULTS="serve.decode:hang=600@6" \
    python -m gym_tpu_torch.serve \
    --ckpt "$OUT/ckpts/ci" --port "$PORT2" --num_slots 2 --device cpu \
    --replicas 2 --max-restarts 0 --dispatch-timeout 15 \
    --drain-deadline 5 \
    > "$OUT/fleet.log" 2>&1 &
SRV=$!
for _ in $(seq 1 90); do
    grep -q "listening" "$OUT/fleet.log" && break
    kill -0 "$SRV" 2>/dev/null || { echo "ci_torch_chaos: fleet server died at startup";
        cat "$OUT/fleet.log"; exit 1; }
    sleep 1
done
grep -q "listening" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: fleet server never started"; kill -9 "$SRV"; exit 1; }

timeout -k 10 240 env GYM_TPU_CI_CHAOS_PORT="$PORT2" python - <<'EOF'
import json, os, time, urllib.error, urllib.request

port = os.environ["GYM_TPU_CI_CHAOS_PORT"]

def post(payload, timeout=120):
    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", body,
            {"Content-Type": "application/json"}), timeout=timeout)
        return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0

# A: decode dispatches 1-3 on replica 0 — completes, primes programs
code, body, _ = post({"prompt": [1, 2, 3], "max_new_tokens": 4,
                      "top_k": 4, "seed": 0, "deadline_s": 90})
assert code == 200 and len(body["tokens"]) == 4, (code, body)
assert body["replica"] == 0 and body["failovers"] == 0, body
print("ci_torch_chaos: fleet pre-kill request ok on replica", body["replica"])

# B: wedges replica 0 at dispatch 6, mid-stream; restart budget 0 makes
# it a hard death — the router must answer via replica 1: 200, full
# stream, inside B's deadline
code, body, dt = post({"prompt": [1, 2, 3], "max_new_tokens": 8,
                       "top_k": 4, "seed": 1, "deadline_s": 60})
assert code == 200, (code, body)
assert len(body["tokens"]) == 8, body
assert body["replica"] == 1, body
assert body["failovers"] >= 1, body
assert dt < 60, f"failover took {dt:.1f}s — past B's deadline"
print(f"ci_torch_chaos: replica-kill survived — 200 via replica 1 in "
      f"{dt:.1f}s ({body['failovers']} failover)")

# C: the dead replica is OUT of dispatch — every subsequent request
# lands on the sibling
for seed in (2, 3):
    code, body, _ = post({"prompt": [1, 2, 3], "max_new_tokens": 4,
                          "top_k": 4, "seed": seed, "deadline_s": 90})
    assert code == 200 and body["replica"] == 1, (code, body)
print("ci_torch_chaos: dead replica excluded from dispatch")

stats = json.loads(urllib.request.urlopen(
    f"http://127.0.0.1:{port}/stats", timeout=30).read())
assert stats["failovers"] >= 1, stats
assert stats["healthy_replicas"] == 1, stats
reps = {r["id"]: r for r in stats["replicas"]}
assert reps[0]["dead"] is True and reps[0]["healthy"] is False, stats
assert reps[1]["healthy"] is True, stats
assert stats["status"] == "degraded", stats
print("ci_torch_chaos: fleet stats ok —", json.dumps({
    "failovers": stats["failovers"],
    "healthy_replicas": stats["healthy_replicas"],
    "retries_exhausted": stats["retries_exhausted"]}))
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: replica-kill drill failed";
    cat "$OUT/fleet.log"; kill -9 "$SRV"; exit "$rc"; }

grep -q "failover: request retried on replica 1" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: no failover line in fleet log";
    cat "$OUT/fleet.log"; exit 1; }
grep -q "replica 0 declared dead" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: no replica-death line in fleet log";
    cat "$OUT/fleet.log"; exit 1; }

# SIGTERM with replica 0's driver still wedged in the 600 s hang: the
# close must dump that replica's stacks, fail its requests typed and
# STILL exit 0 with the clean-shutdown headline (failovers included)
kill -TERM "$SRV"
wait "$SRV"; rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: fleet exit rc=$rc after SIGTERM";
    cat "$OUT/fleet.log"; exit 1; }
grep -q "replica 0 driver wedged" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: no per-replica wedge stack dump";
    cat "$OUT/fleet.log"; exit 1; }
grep -q "shut down cleanly" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: no clean-shutdown line in fleet log";
    cat "$OUT/fleet.log"; exit 1; }
grep -q "failover(s)" "$OUT/fleet.log" || {
    echo "ci_torch_chaos: no failover count in shutdown line";
    cat "$OUT/fleet.log"; exit 1; }
echo "ci_torch_chaos: replica-kill drill OK (log at $OUT/fleet.log)"

# Layer 5: PROCESS-kill drill — the out-of-process fleet
# with the autoscaler. kill -9 the worker pid serving a stream,
# mid-stream, with concurrent streams in flight.
PORT3=$((PORT + 2))
env PYTHONPATH="$REPO" \
    python -m gym_tpu_torch.serve \
    --ckpt "$OUT/ckpts/ci" --port "$PORT3" --num_slots 2 --device cpu \
    --out-of-process --replicas 2 --autoscale --min-replicas 2 \
    --max-replicas 3 --autoscale-interval 0.5 \
    --program-cache-dir "$OUT/progcache5" --drain-deadline 15 \
    > "$OUT/procfleet.log" 2>&1 &
SRV=$!
for _ in $(seq 1 180); do
    grep -q "listening" "$OUT/procfleet.log" && break
    kill -0 "$SRV" 2>/dev/null || { echo "ci_torch_chaos: proc-fleet server died at startup";
        cat "$OUT/procfleet.log"; exit 1; }
    sleep 1
done
grep -q "listening" "$OUT/procfleet.log" || {
    echo "ci_torch_chaos: proc-fleet server never started"; kill -9 "$SRV"; exit 1; }

timeout -k 10 300 env GYM_TPU_CI_CHAOS_PORT="$PORT3" python - <<'EOF'
import concurrent.futures, json, os, signal, time, urllib.request

port = os.environ["GYM_TPU_CI_CHAOS_PORT"]
base = f"http://127.0.0.1:{port}"

def stats():
    return json.loads(urllib.request.urlopen(base + "/stats",
                                             timeout=30).read())

def stream(payload, kill_after_chunks=None, pid_by_rid=None):
    """Consume one SSE stream; optionally kill -9 the serving worker
    PROCESS after N chunk events (pids pre-resolved — a /stats round
    trip inside the loop would let a fast stream finish before the
    kill lands). Returns (tokens, final_event)."""
    body = json.dumps(dict(payload, stream=True)).encode()
    r = urllib.request.urlopen(urllib.request.Request(
        base + "/generate", body,
        {"Content-Type": "application/json"}), timeout=180)
    toks, chunks, fin = [], 0, None
    for line in r:
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[6:])
        if ev.get("done") or ev.get("error"):
            fin = ev
            break
        toks.extend(ev["tokens"])
        chunks += 1
        if kill_after_chunks is not None and chunks == kill_after_chunks:
            rid = ev["replica"]
            pid = pid_by_rid[rid]
            os.kill(pid, signal.SIGKILL)
            print(f"ci_torch_chaos: SIGKILLed worker pid {pid} (replica "
                  f"{rid}) after {chunks} chunks "
                  f"({len(toks)} tokens)", flush=True)
            kill_after_chunks = None
    return toks, fin

req = {"prompt": [1, 2, 3], "max_new_tokens": 24, "top_k": 4,
       "seed": 7, "deadline_s": 120}
# uncontended reference stream (deterministic engine)
ref, fin = stream(req)
assert fin.get("done") and len(ref) == 24, (ref, fin)
before = stats()
assert before["healthy_replicas"] == 2, before["replicas"]
spawned0 = before["replicas_spawned"]

# under load: two sibling streams in flight while the victim stream's
# worker process is kill -9'd mid-stream — ZERO dropped streams
pid_by_rid = {rep["id"]: rep["pid"] for rep in before["replicas"]
              if not rep["retired"]}
with concurrent.futures.ThreadPoolExecutor(3) as ex:
    bg = [ex.submit(stream, {"prompt": [1, 2, 3], "max_new_tokens": 10,
                             "top_k": 4, "seed": 20 + i,
                             "deadline_s": 120}) for i in range(2)]
    toks, fin = stream(req, kill_after_chunks=1, pid_by_rid=pid_by_rid)
    bg_results = [f.result() for f in bg]
assert fin.get("done") is True, fin
assert toks == ref, f"spliced stream diverged:\n  got {toks}\n  ref {ref}"
assert fin["failovers"] >= 1, fin
for btoks, bfin in bg_results:
    assert bfin.get("done") is True and len(btoks) == 10, (btoks, bfin)
print("ci_torch_chaos: kill -9 mid-stream — spliced stream byte-identical, "
      f"{fin['failovers']} failover(s), sibling streams intact")

# the autoscaler must respawn the dead worker: healthy_replicas back
# to 2, replicas_spawned grew
deadline = time.monotonic() + 120
st = stats()
while time.monotonic() < deadline:
    st = stats()
    if (st["healthy_replicas"] >= 2
            and st["replicas_spawned"] > spawned0):
        break
    time.sleep(1)
assert st["healthy_replicas"] >= 2, st["replicas"]
assert st["replicas_spawned"] > spawned0, (
    st["replicas_spawned"], spawned0)
assert st["streams_active"] == 0, st["streams_active"]
print("ci_torch_chaos: autoscaler respawned —",
      json.dumps({"replicas_spawned": st["replicas_spawned"],
                  "healthy_replicas": st["healthy_replicas"],
                  "failovers": st["failovers"]}))

# and the recovered fleet still serves exact streams
toks, fin = stream(req)
assert fin.get("done") and toks == ref, (toks, fin)
print("ci_torch_chaos: post-respawn stream exact")
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: process-kill drill failed";
    cat "$OUT/procfleet.log"; kill -9 "$SRV"; exit "$rc"; }

grep -q "declared dead" "$OUT/procfleet.log" || {
    echo "ci_torch_chaos: no worker-death line in proc-fleet log";
    cat "$OUT/procfleet.log"; exit 1; }
grep -q "failover: request retried" "$OUT/procfleet.log" || {
    echo "ci_torch_chaos: no splice-failover line in proc-fleet log";
    cat "$OUT/procfleet.log"; exit 1; }
grep -q "autoscaler — scale UP" "$OUT/procfleet.log" || {
    echo "ci_torch_chaos: no autoscaler respawn line in proc-fleet log";
    cat "$OUT/procfleet.log"; exit 1; }

# SIGTERM drill: exit 0, clean shutdown, EVERY worker child reaped
kill -TERM "$SRV"
wait "$SRV"; rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: proc-fleet exit rc=$rc after SIGTERM";
    cat "$OUT/procfleet.log"; exit 1; }
grep -q "shut down cleanly" "$OUT/procfleet.log" || {
    echo "ci_torch_chaos: no clean-shutdown line in proc-fleet log";
    cat "$OUT/procfleet.log"; exit 1; }
pgrep -f "gym_tpu_torch.serve.worker" > /dev/null && {
    echo "ci_torch_chaos: leaked worker processes after SIGTERM:";
    pgrep -af "gym_tpu_torch.serve.worker"; exit 1; }
echo "ci_torch_chaos: process-kill drill OK (log at $OUT/procfleet.log)"

# Layer 6: tenant-isolation drill — quotas + preemptible
# decode on the live server. Tenant B floods; tenant A must not feel
# it. The injected 50 ms decode delay makes every flood stream a real
# slot-holder (warm tiny-model decode is otherwise too fast for the
# victim to ever contend) — the same latency-chaos idiom as layer 2.
PORT4=$((PORT + 3))
env PYTHONPATH="$REPO" \
    GYM_TPU_FAULTS="serve.decode:delay=0.05" \
    python -m gym_tpu_torch.serve \
    --ckpt "$OUT/ckpts/ci" --port "$PORT4" --num_slots 2 --device cpu \
    --preempt --quotas '{"batch": {"tokens_per_s": 30, "burst_s": 2}}' \
    > "$OUT/tenant.log" 2>&1 &
SRV=$!
for _ in $(seq 1 90); do
    grep -q "listening" "$OUT/tenant.log" && break
    kill -0 "$SRV" 2>/dev/null || { echo "ci_torch_chaos: tenant server died at startup";
        cat "$OUT/tenant.log"; exit 1; }
    sleep 1
done
grep -q "listening" "$OUT/tenant.log" || {
    echo "ci_torch_chaos: tenant server never started"; kill -9 "$SRV"; exit 1; }

timeout -k 10 240 env GYM_TPU_CI_CHAOS_PORT="$PORT4" python - <<'EOF'
import concurrent.futures, json, os, time, urllib.error, urllib.request

port = os.environ["GYM_TPU_CI_CHAOS_PORT"]
base = f"http://127.0.0.1:{port}"

def post(payload, timeout=120):
    body = json.dumps(payload).encode()
    try:
        r = urllib.request.urlopen(urllib.request.Request(
            base + "/generate", body,
            {"Content-Type": "application/json"}), timeout=timeout)
        return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers

def stream_ttft(payload):
    """Consume one SSE stream; return (ttft_s, tokens)."""
    body = json.dumps(dict(payload, stream=True)).encode()
    t0 = time.perf_counter()
    r = urllib.request.urlopen(urllib.request.Request(
        base + "/generate", body,
        {"Content-Type": "application/json"}), timeout=120)
    ttft, toks = None, []
    for line in r:
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[6:])
        if ev.get("done") or ev.get("error"):
            assert ev.get("done"), ev
            break
        if ev["tokens"] and ttft is None:
            ttft = time.perf_counter() - t0
        toks.extend(ev["tokens"])
    return ttft, toks

FLOOD = {"prompt": [1, 2, 3], "max_new_tokens": 24, "top_k": 4,
         "seed": 7, "deadline_s": 120, "tenant": "tenant_b",
         "slo_class": "batch"}

# warm request + the UNCONTENDED reference for the flood signature
# (same engine, empty server): the resume-exactness oracle
code, body, _ = post(dict(FLOOD, seed=0))
assert code == 200 and len(body["tokens"]) == 24, (code, body)
code, ref_body, _ = post(FLOOD)
assert code == 200 and len(ref_body["tokens"]) == 24, (code, ref_body)
ref = ref_body["tokens"]
print("ci_torch_chaos: tenant warm + reference ok")
time.sleep(2.5)      # refill the batch bucket to its 60-token cap

# tenant B floods: 6 concurrent batch streams of 24 tokens against a
# 60-token bucket — ~2 admit and hold both slots, the tail sheds 429
with concurrent.futures.ThreadPoolExecutor(6) as ex:
    flood = [ex.submit(post, FLOOD) for _ in range(6)]
    time.sleep(0.4)  # flood decoding; both slots busy
    # tenant A: interactive requests DURING the flood — preemptible
    # decode must park a flood slot for each
    ttfts = []
    for i in range(3):
        ttft, toks = stream_ttft({"prompt": [1, 2, 3],
                                  "max_new_tokens": 4, "top_k": 4,
                                  "seed": 100 + i, "deadline_s": 60,
                                  "tenant": "tenant_a",
                                  "slo_class": "interactive"})
        assert ttft is not None and len(toks) == 4, (ttft, toks)
        ttfts.append(ttft)
    flood = [f.result() for f in flood]

ok = [b for c, b, _ in flood if c == 200]
shed = [(c, b, h) for c, b, h in flood if c == 429]
assert ok and shed, [c for c, _, _ in flood]
for c, b, h in shed:
    assert h.get("Retry-After") is not None, dict(h)
    assert "quota" in b["error"].lower(), b
# every admitted flood stream — parked and resumed under tenant A's
# arrivals — equals the uncontended reference token-for-token
for b in ok:
    assert b["tokens"] == ref, (b["tokens"], ref)
worst = max(ttfts)
assert worst < 5.0, f"victim TTFT {worst:.2f}s blew the 5s SLO"
print(f"ci_torch_chaos: tenant drill — victim TTFTs "
      f"{[round(t, 3) for t in ttfts]}s (SLO 5s), "
      f"{len(ok)} flood admitted (streams exact), {len(shed)} shed "
      f"typed 429+Retry-After")

stats = json.loads(urllib.request.urlopen(base + "/stats",
                                          timeout=30).read())
ten = stats["tenants"]
assert ten["preemptions"] >= 1 and ten["resumes"] >= 1, ten
assert ten["quota_rejections"].get("batch", 0) >= len(shed), ten
print("ci_torch_chaos: tenant stats ok —", json.dumps({
    "preemptions": ten["preemptions"], "resumes": ten["resumes"],
    "quota_rejections": ten["quota_rejections"]}))
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: tenant-isolation drill failed";
    cat "$OUT/tenant.log"; kill -9 "$SRV"; exit "$rc"; }

kill -TERM "$SRV"
wait "$SRV"; rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_chaos: tenant server exit rc=$rc after SIGTERM";
    cat "$OUT/tenant.log"; exit 1; }
grep -q "shut down cleanly" "$OUT/tenant.log" || {
    echo "ci_torch_chaos: no clean-shutdown line in tenant log";
    cat "$OUT/tenant.log"; exit 1; }
echo "ci_torch_chaos: tenant-isolation drill OK (log at $OUT/tenant.log)"

echo "ci_torch_chaos: OK (logs at $OUT/server.log, $OUT/fleet.log, $OUT/procfleet.log, $OUT/tenant.log)"
exit 0
