#!/usr/bin/env bash
# Serving gate of the PyTorch port (gym_tpu_torch), the CPU twin of the
# first half of scripts/ci_serve.sh: the port's serving suites, then
# `python -m gym_tpu_torch.serve` end to end — train a tiny checkpoint
# with the port, serve it over HTTP with --device cpu (paged by default),
# answer 4 CONCURRENT requests, prove prefix sharing live (two requests
# sharing a 16-token prefix -> prefix_hit_blocks > 0 in /stats), wait for
# the background warmup (every program of the family built), the SIGTERM
# drill (rc 0, a clean-shutdown line, a tokens_per_s headline, serve.csv
# with its ts_s,kind header), and the restart drill against the same
# kernel build directory (--program-cache-dir): first request 200 with
# the same stream, programs_compiled 0.
#
# Then the quantized pass, the twin of ci_serve.sh's: the same checkpoint
# served with --quant int8 --kv-quant int8 — 200s, /stats echoing the
# dtypes and the int8 pool's capacity, the warmup done, the SIGTERM drill,
# and a restart against its build directory with programs_compiled 0.
#
# Not here: ci_serve.sh's process-fleet drill (--out-of-process) waits for
# ROADMAP item 15. On the card the same servers are chip_smoke.py phases
# 12b and 13d.
#
# Usage: scripts/ci_torch_serve.sh   (from the repo root or anywhere)
set -o pipefail
cd "$(dirname "$0")/.."
REPO="$(pwd)"
TMP="${TMPDIR:-/tmp}"

log="$TMP/_torch_serve.log"
rm -f "$log"
timeout -k 10 900 env JAX_PLATFORMS=cpu python -m pytest \
    tests/test_torch_serve.py tests/test_torch_serve_paged.py \
    tests/test_torch_serve_http.py tests/test_torch_serve_fleet.py \
    tests/test_torch_programs.py tests/test_torch_serve_quant.py -q \
    -p no:cacheprovider -p no:xdist -p no:randomly \
    2>&1 | tee "$log"
rc=${PIPESTATUS[0]}
echo SERVE_DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "$log" | tr -cd . | wc -c)
[ "$rc" -ne 0 ] && exit "$rc"

OUT=${GYM_TPU_CI_SERVE_OUT:-$TMP/gym_tpu_torch_ci_serve}
PORT=${GYM_TPU_CI_SERVE_PORT:-8742}
rm -rf "$OUT"; mkdir -p "$OUT"

timeout -k 10 300 env PYTHONPATH="$REPO" python - "$OUT" <<'EOF'
import sys
import numpy as np
from gym_tpu_torch import Trainer
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.strategy import OptimSpec, SimpleReduceStrategy

out = sys.argv[1]
cfg = GPTConfig(block_size=32, vocab_size=48, n_layer=2, n_head=2,
                n_embd=32, dropout=0.0)
toks = np.random.default_rng(0).integers(0, 48, 4000).astype(np.int32)
Trainer(GPT(cfg), ContiguousGPTTrainDataset(toks, 32)).fit(
    strategy=SimpleReduceStrategy(optim_spec=OptimSpec("adamw", lr=1e-3)),
    num_nodes=1, max_steps=4, batch_size=4, val_size=0, val_interval=0,
    show_progress=False, seed=1, checkpoint_interval=4, device="cpu",
    save_dir=out + "/ckpts", run_name="ci", log_dir=out + "/logs")
print("ci_torch_serve: checkpoint trained")
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_serve: training the ckpt failed"; exit "$rc"; }

# bare `python ... &` so $! is the server pid, not a subshell's; $2 the
# build directory, the rest extra flags
serve() {
    log_file="$1"; cache="$2"; shift 2
    env PYTHONPATH="$REPO" python -m gym_tpu_torch.serve \
        --ckpt "$OUT/ckpts/ci" --port "$PORT" --num_slots 2 --device cpu \
        --program-cache-dir "$OUT/$cache" "$@" > "$log_file" 2>&1 &
    SRV=$!
    for _ in $(seq 1 90); do
        grep -q "listening" "$log_file" && return 0
        kill -0 "$SRV" 2>/dev/null || { echo "ci_torch_serve: server died";
            cat "$log_file"; exit 1; }
        sleep 1
    done
    echo "ci_torch_serve: server never started"; cat "$log_file"
    kill -9 "$SRV"
    exit 1
}

sigterm() {
    kill -TERM "$SRV"
    wait "$SRV"; rc=$?
    [ "$rc" -ne 0 ] && { echo "ci_torch_serve: exit rc=$rc after SIGTERM";
        cat "$1"; exit 1; }
    grep -q "shut down cleanly" "$1" || {
        echo "ci_torch_serve: no clean-shutdown line"; cat "$1"; exit 1; }
    grep -q "tokens_per_s" "$1" || {
        echo "ci_torch_serve: no tokens_per_s headline"; cat "$1"; exit 1; }
}

serve "$OUT/server.log" progcache
timeout -k 10 180 env GYM_TPU_CI_SERVE_PORT="$PORT" \
    GYM_TPU_CI_SERVE_OUT="$OUT" python - <<'EOF'
import concurrent.futures, json, os, time, urllib.request

port = os.environ["GYM_TPU_CI_SERVE_PORT"]


def post(body):
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"}), timeout=120)
    return json.loads(r.read())


def stats():
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=10).read())


def gen(seed):
    return post({"prompt": [1, 2, 3], "max_new_tokens": 6, "top_k": 4,
                 "seed": seed})

with concurrent.futures.ThreadPoolExecutor(4) as ex:
    outs = list(ex.map(gen, range(4)))
for o in outs:
    assert len(o["tokens"]) == 6, o
    print("ci_torch_serve: completion", o["tokens"], "ttft", o["ttft_s"])
s = stats()
assert s["requests_done"] == 4 and s["paged"], s
shared = list(range(1, 17))
for tail in ([17], [18]):
    assert len(post({"prompt": shared + tail, "max_new_tokens": 4,
                     "top_k": 4, "seed": 9})["tokens"]) == 4
s = stats()
assert s["prefix_hit_blocks"] > 0, s
print("ci_torch_serve: prefix_hit_blocks =", s["prefix_hit_blocks"])
deadline = time.monotonic() + 110
while not (s["warmup"] or {}).get("done"):
    assert time.monotonic() < deadline, s["warmup"]
    time.sleep(0.5)
    s = stats()
print("ci_torch_serve: warmup done:", s["warmup"],
      "programs_compiled =", s["programs_compiled"],
      "graphs_captured =", s["graphs_captured"])
with open(os.path.join(os.environ["GYM_TPU_CI_SERVE_OUT"],
                       "first.json"), "w") as f:
    json.dump(outs[0]["tokens"], f)
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_serve: HTTP requests failed";
    cat "$OUT/server.log"; kill -9 "$SRV"; exit "$rc"; }
sigterm "$OUT/server.log"
head -1 "$OUT/ckpts/ci/serve/serve.csv" | grep -q "ts_s,kind" || {
    echo "ci_torch_serve: serve.csv missing/markerless"; exit 1; }

# the restart drill: the same build directory, nothing to build again
serve "$OUT/server2.log" progcache
timeout -k 10 180 env GYM_TPU_CI_SERVE_PORT="$PORT" \
    GYM_TPU_CI_SERVE_OUT="$OUT" python - <<'EOF'
import json, os, urllib.request

port = os.environ["GYM_TPU_CI_SERVE_PORT"]
body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 6, "top_k": 4,
                   "seed": 0}).encode()
r = urllib.request.urlopen(urllib.request.Request(
    f"http://127.0.0.1:{port}/generate", body,
    {"Content-Type": "application/json"}), timeout=120)
assert r.status == 200, r.status
with open(os.path.join(os.environ["GYM_TPU_CI_SERVE_OUT"],
                       "first.json")) as f:
    assert json.loads(r.read())["tokens"] == json.load(f)
stats = json.loads(urllib.request.urlopen(
    f"http://127.0.0.1:{port}/stats", timeout=10).read())
assert stats["programs_compiled"] == 0, stats["programs"]
print("ci_torch_serve: restart drill — first request 200, the same "
      "stream, programs_compiled =", stats["programs_compiled"])
EOF
rc=$?
[ "$rc" -ne 0 ] && { echo "ci_torch_serve: restart drill failed";
    cat "$OUT/server2.log"; kill -9 "$SRV"; exit "$rc"; }
sigterm "$OUT/server2.log"

# the quantized pass: int8 weights, int8 KV, then its restart drill
for run in 3 4; do
    serve "$OUT/server$run.log" progcache_q --quant int8 --kv-quant int8
    grep -q "quantized (weights int8, kv int8)" "$OUT/server$run.log" || {
        echo "ci_torch_serve: no quantization note"; cat "$OUT/server$run.log"
        kill -9 "$SRV"; exit 1; }
    timeout -k 10 180 env GYM_TPU_CI_SERVE_PORT="$PORT" python - <<'PYEOF'
import json, os, time, urllib.request

port = os.environ["GYM_TPU_CI_SERVE_PORT"]


def stats():
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=10).read())


for seed in range(2):
    body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 6,
                       "top_k": 4, "seed": seed}).encode()
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", body,
        {"Content-Type": "application/json"}), timeout=120)
    assert r.status == 200, r.status
    assert len(json.loads(r.read())["tokens"]) == 6
s = stats()
assert s["weights_dtype"] == "int8", s.get("weights_dtype")
assert s["kv_dtype"] == "int8", s.get("kv_dtype")
assert s["kv_blocks_capacity_effective"] == 4 * (s["kv_pages"] - 1), \
    (s["kv_blocks_capacity_effective"], s["kv_pages"])
assert s["requests_done"] == 2, s["requests_done"]
deadline = time.monotonic() + 110
while not (s["warmup"] or {}).get("done"):
    assert time.monotonic() < deadline, s["warmup"]
    time.sleep(0.5)
    s = stats()
assert s["programs_compiled"] == 0, s["programs"]
print("ci_torch_serve: quantized — weights", s["weights_dtype"], "kv",
      s["kv_dtype"], "capacity_eff", s["kv_blocks_capacity_effective"],
      "weights_bytes", s["weights_bytes"], "warmup", s["warmup"],
      "programs_compiled", s["programs_compiled"])
PYEOF
    rc=$?
    [ "$rc" -ne 0 ] && { echo "ci_torch_serve: quantized pass failed";
        cat "$OUT/server$run.log"; kill -9 "$SRV"; exit "$rc"; }
    sigterm "$OUT/server$run.log"
done
echo "ci_torch_serve: all passed"
