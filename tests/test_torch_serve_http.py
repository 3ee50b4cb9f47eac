"""The port's HTTP server (``python -m gym_tpu_torch.serve``) against
``gym_tpu``'s on the CPU, and its copied modules pinned to their
originals.

- ``create_server`` of both packages over the same weights (a numpy-made
  flax tree carried across by ``convert.serving_params_from_jax``): greedy,
  sampled and nucleus streams equal token for token over HTTP, and
  ``/stats`` has the JAX server's keys plus ``graphs_captured``;
- the typed failures of ``tests/test_serve_chaos.py``'s HTTP cases: 400
  (malformed JSON, a prompt too long, out-of-vocab ids), 429 +
  ``Retry-After`` (an infeasible deadline, body or header), 503 (an
  injected IO fault), 504 (a deadline that expires mid-decode);
- ``main``: no card and no ``--device cpu`` exits 1; the process fleet's
  six flags and the quantization flags reach the loader and the server;
- ``wire.py`` and ``metrics.py``: the same frames, CRC rejections and
  headlines through both modules, and the same code (docstrings and
  comments apart); ``serve/autoscale.py``, ``servesim/*`` (but
  ``drill.py``) and ``sim/gridlib.py`` the same code up to the strings of
  ``RENAMED`` that name the package.
"""

import ast
import io
import json
import pathlib
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import gym_tpu.serve.metrics as jmetrics
import gym_tpu.serve.wire as jwire
import gym_tpu_torch.serve.metrics as tmetrics
import gym_tpu_torch.serve.wire as twire
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.utils.resilience import faults as tfaults
from test_torch_decode import J, numpy_params, port_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
V = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    yield
    tfaults.reset()


@pytest.fixture(scope="module")
def tiny():
    """The ci_serve checkpoint's model (2L/2H/32d, block 32, vocab 48) from
    numpy: the flax tree, the port's params and both configs."""
    cfg = J.GPTConfig(block_size=32, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 11)
    return cfg, params, port_config(cfg), serving_params_from_jax(params,
                                                                   "cpu")


def _start(handle):
    t = threading.Thread(target=handle.httpd.serve_forever, daemon=True)
    t.start()
    return t


def _post(port, body_bytes, headers=None, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", body_bytes,
        {"Content-Type": "application/json", **(headers or {})})
    try:
        r = urllib.request.urlopen(req, timeout=120)
        return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _stats(port):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())


# one prompt bucket (4) for every request: the JAX server compiles one
# prefill and one decode program
REQUESTS = [
    {"prompt": [1, 2, 3], "max_new_tokens": 8, "top_k": 1},
    {"prompt": [5, 7, 9, 11], "max_new_tokens": 8, "temperature": 0.8,
     "top_k": 5, "seed": 4},
    {"prompt": [2, 3], "max_new_tokens": 6, "top_p": 0.9, "seed": 7},
    {"text": "ab", "max_new_tokens": 5, "seed": 1},
]


def test_http_streams_equal_the_jax_server(tiny, tmp_path):
    from gym_tpu.serve.__main__ import create_server as jcreate
    from gym_tpu_torch.serve.__main__ import create_server as tcreate
    jcfg, jparams, tcfg, tparams = tiny
    handles = {
        "jax": jcreate(jparams, jcfg, port=0, num_slots=2,
                       metrics_dir=str(tmp_path / "j"), warmup=False,
                       dispatch_timeout=60.0),
        "torch": tcreate(tparams, tcfg, port=0, num_slots=2,
                         metrics_dir=str(tmp_path / "t"), device="cpu",
                         dispatch_timeout=60.0)}
    threads = [_start(h) for h in handles.values()]
    try:
        assert handles["torch"].warmup.wait(timeout=60)
        outs = {}
        for name, h in handles.items():
            outs[name] = []
            for req in REQUESTS:
                code, body, _ = _post(h.port, json.dumps(req).encode())
                assert code == 200, (name, body)
                outs[name].append((body["tokens"], body.get("text")))
        assert outs["torch"] == outs["jax"]
        js, ts = _stats(handles["jax"].port), _stats(handles["torch"].port)
        assert set(ts) == set(js) | {"graphs_captured"}
        assert set(ts["programs"]) == set(js["programs"]) | {
            "graphs_captured"}
        assert ts["requests_done"] == js["requests_done"] == len(REQUESTS)
        assert ts["paged"] and ts["programs_compiled"] == 0
        assert ts["graphs_captured"] == 0          # no graphs on the CPU
        # decode, copy-on-write and the six buckets 1..32
        assert ts["warmup"]["done"] and ts["warmup"]["warmed"] == 8
    finally:
        for h in handles.values():
            h.close()
        for t in threads:
            t.join(timeout=10)


@pytest.fixture()
def server(tiny, tmp_path):
    from gym_tpu_torch.serve.__main__ import create_server
    _, _, tcfg, tparams = tiny
    handle = create_server(tparams, tcfg, port=0, num_slots=2,
                           metrics_dir=str(tmp_path), device="cpu",
                           dispatch_timeout=30.0, request_timeout=120.0)
    t = _start(handle)
    yield handle
    handle.close()
    t.join(timeout=10)


def test_http_typed_400s(server):
    code, body, _ = _post(server.port, b"{not json")
    assert code == 400 and "malformed JSON" in body["error"]
    code, body, _ = _post(server.port, b"[1, 2, 3]")
    assert code == 400 and "must be an object" in body["error"]
    code, body, _ = _post(server.port, json.dumps(
        {"prompt": list(range(20)), "max_new_tokens": 20}).encode())
    assert code == 400 and "exceeds the KV cache" in body["error"]
    code, body, _ = _post(server.port, json.dumps(
        {"prompt": [1, 2, 999]}).encode())
    assert code == 400 and "token ids" in body["error"]
    code, body, _ = _post(server.port, b"{}", path="/nowhere")
    assert code == 404


def test_http_deadline_504_then_429_and_fault_503(server):
    """A cold EWMA admits a 0.2 s deadline; a decode held up 0.5 s
    cancels it at the chunk boundary (504). The warm EWMA then sheds an
    infeasible deadline at admission, by body field or header (429 +
    Retry-After); an injected IO fault is a typed 503."""
    tfaults.install("serve.decode", "delay", arg=0.5, first=1, last=1)
    code, body, _ = _post(server.port, json.dumps(
        {"prompt": [1, 2, 3], "max_new_tokens": 12,
         "deadline_s": 0.2}).encode())
    assert code == 504 and "deadline" in body["error"]
    ok = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 6,
                     "top_k": 4, "seed": 0}).encode()
    for _ in range(2):
        code, body, _ = _post(server.port, ok)
        assert code == 200 and len(body["tokens"]) == 6
    code, body, headers = _post(server.port, json.dumps(
        {"prompt": [1, 2, 3], "max_new_tokens": 20,
         "deadline_s": 1e-4}).encode())
    assert code == 429 and "shed at admission" in body["error"]
    assert int(headers["Retry-After"]) >= 1
    code, body, headers = _post(
        server.port, json.dumps({"prompt": [1, 2, 3],
                                 "max_new_tokens": 20}).encode(),
        headers={"X-Deadline-S": "0.0001"})
    assert code == 429 and headers["Retry-After"] is not None
    tfaults.reset()                       # hits count from the install
    tfaults.install("serve.http", "oserror", first=1, last=1)
    code, body, headers = _post(server.port, ok)
    assert code == 503 and "InjectedFault" in body["error"]
    assert headers["Retry-After"] is not None
    stats = _stats(server.port)
    assert stats["requests_rejected"] == 2 and stats["requests_shed"] == 1
    assert stats["engine_restarts"] == 0 and stats["status"] == "ok"


FLEET_FLAGS = ["--out-of-process", "--autoscale", "--autoscale-interval",
               "0.5", "--min-replicas", "2", "--max-replicas", "3",
               "--worker-startup-timeout", "60"]


def test_main_refuses_the_cpu_and_later_items(tmp_path, capsys,
                                              monkeypatch):
    import gym_tpu_torch.serve.__main__ as tmain
    from gym_tpu_torch.serve import load as tload
    main = tmain.main
    assert not torch.cuda.is_available()
    assert main(["--ckpt", str(tmp_path)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    # the process fleet asked for the card with no card: exits 1, never a
    # quiet CPU fleet
    assert main(["--ckpt", str(tmp_path), *FLEET_FLAGS]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert main(["--ckpt", str(tmp_path / "missing"), "--device",
                 "cpu"]) == 1
    assert "cannot load" in capsys.readouterr().err
    # the process fleet's flags reach the loader ...
    assert main(["--ckpt", str(tmp_path / "missing"), "--device", "cpu",
                 *FLEET_FLAGS]) == 1
    assert "cannot load" in capsys.readouterr().err
    # ... and the quantization flags too
    assert main(["--ckpt", str(tmp_path / "missing"), "--device", "cpu",
                 "--quant", "int8", "--kv-quant", "int8",
                 *FLEET_FLAGS]) == 1
    assert "cannot load" in capsys.readouterr().err
    # ... and then the server, each as create_server's keyword

    class Reached(Exception):
        pass

    seen = {}

    def fake_load(run_dir, **kw):
        seen["load"] = kw
        return ({}, J.GPTConfig(), {"step": 3, "num_nodes": 1})

    def fake_create(params, cfg, **kw):
        seen.update(kw)
        raise Reached

    monkeypatch.setattr(tload, "load_for_serving", fake_load)
    monkeypatch.setattr(tmain, "create_server", fake_create)
    with pytest.raises(Reached):
        main(["--ckpt", str(tmp_path), "--device", "cpu", "--replicas",
              "2", "--quant", "int8", *FLEET_FLAGS])
    assert seen["load"]["weights_dtype"] == "int8"
    assert (seen["out_of_process"], seen["autoscale"],
            seen["autoscale_interval_s"], seen["min_replicas"],
            seen["max_replicas"], seen["worker_startup_timeout_s"],
            seen["replicas"], seen["device"]) == (
        True, True, 0.5, 2, 3, 60.0, 2, "cpu")


# -- the copies, pinned -----------------------------------------------------


def _code(path_or_source):
    """The module's AST without docstrings (comments never reach it)."""
    src = (path_or_source.read_text()
           if isinstance(path_or_source, pathlib.Path) else path_or_source)
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


#: the strings a copy may differ in, each an (original, copy) substring
#: pair applied to the original's string constants: log and usage lines
#: that name the package
RENAMED = {
    "serve/autoscale.py": [("gym_tpu.serve: autoscaler",
                            "gym_tpu_torch.serve: autoscaler")],
    "servesim/replay.py": [("against a live gym_tpu server",
                            "against a live gym_tpu_torch server")],
    "servesim/sweep.py": [("python -m gym_tpu.servesim.",
                           "python -m gym_tpu_torch.servesim.")],
}


def _renamed(path, pairs):
    """``_code`` of ``path`` with each pair's original substring replaced
    in its string constants."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for old, new in pairs:
                node.value = node.value.replace(old, new)
    return _code(ast.unparse(tree))


@pytest.mark.parametrize("rel", [
    "serve/wire.py", "serve/metrics.py", "serve/autoscale.py",
    "sim/gridlib.py", "servesim/__init__.py", "servesim/traces.py",
    "servesim/replay.py", "servesim/cost_model.py", "servesim/sweep.py",
    "servesim/frontier_gate.py", "servesim/tenant_gate.py"])
def test_copies_are_their_originals_code(rel):
    copy = ROOT / "gym_tpu_torch" / rel
    orig = ROOT / "gym_tpu" / rel
    pairs = RENAMED.get(rel, [])
    assert _code(copy) == _renamed(orig, pairs)
    # each allowed difference is used: no stale entry in the map
    consts = [n.value for n in ast.walk(ast.parse(orig.read_text()))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for old, _new in pairs:
        assert any(old in c for c in consts), old


def test_wire_frames_and_crc_rejections_match():
    frames = [{"type": "submit", "id": 7, "prompt": [1, 2, 3],
               "sampling": twire.sampling_to_dict(types.SimpleNamespace(
                   max_new_tokens=4, temperature=0.5, top_k=None,
                   top_p=0.9, eos_token=2, seed=3))},
              {"type": "chunk", "id": 7, "tokens": [4, 5]},
              {"type": "health"}]
    for f in frames:
        raw = twire.encode_frame(f)
        assert raw == jwire.encode_frame(f)
        assert twire.read_frame(io.BytesIO(raw).read) == \
            jwire.read_frame(io.BytesIO(raw).read)
        payload = bytearray(raw[4:])
        payload[payload.index(b"type") + 8] ^= 0x01
        for mod in (twire, jwire):
            with pytest.raises((mod.FrameCorruptError,
                                mod.MalformedFrameError)):
                mod.decode_payload(bytes(payload))
    for mod in (twire, jwire):
        with pytest.raises(mod.TruncatedFrameError):
            mod.read_frame(io.BytesIO(twire.encode_frame(frames[1])[:7]
                                      ).read)
        with pytest.raises(mod.FrameTooLargeError):
            mod.read_frame(io.BytesIO(b"\xff\xff\xff\xff").read)
        with pytest.raises(mod.MalformedFrameError):
            mod.decode_payload(json.dumps({"type": "nope"}).encode())
    assert twire.MAX_FRAME_BYTES == jwire.MAX_FRAME_BYTES
    assert twire.FRAME_TYPES == jwire.FRAME_TYPES


def test_metrics_read_headline_matches_on_a_synthetic_csv(tmp_path):
    assert tmetrics.HEADER == jmetrics.HEADER
    rows = [",".join(["ts_s", "kind", "request_id", "status",
                      "queue_depth", "active_slots", "prompt_tokens",
                      "new_tokens", "ttft_s", "avg_token_latency_s",
                      "cum_tokens", "tokens_per_s", "kv_blocks_in_use",
                      "prefix_hit_blocks", "spec_accept_rate",
                      "replica_id", "programs_built", "programs_compiled",
                      "program_compile_s"])]
    for i in range(1, 61):
        rows.append(f"{i / 10:.4f},request,{i},done,0,1,4,3,"
                    f"{i / 100:.5f},{i / 1000:.5f},{3 * i},1.0,,,,"
                    f"{i % 2},,,")
    rows += ["6.2,request,61,shed,0,1,4,1,0.5,,181,1.0,,,,0,,,",
             "6.3,request,,rejected,1,1,,,,,181,1.0,,,,1,,,",
             "6.4,engine,,restart,,,,,,,181,1.0,3,2,,0,9,0,0.25",
             "6.5,engine,,reload,0,0,,,,,181,1.0,3,2,0.5,1,18,0,0.5"]
    path = tmp_path / "serve.csv"
    path.write_text("\n".join(rows) + "\n")
    assert tmetrics.read_headline(str(path)) == \
        jmetrics.read_headline(str(path))
    # and a live collector writes the same columns and headline shape
    heads = {}
    for name, mod in (("t", tmetrics), ("j", jmetrics)):
        m = mod.ServeMetrics(str(tmp_path / name))
        m.request_done(types.SimpleNamespace(
            id=1, prompt=np.zeros(4, np.int32), tokens=[1, 2], error=None,
            exception=None, ttft_s=0.01, avg_token_latency_s=0.002),
            queue_depth=0, active_slots=1)
        m.sync()
        heads[name] = set(m.headline())
        m.close()
        with open(tmp_path / name / "serve.csv") as f:
            assert f.readline().strip() == ",".join(mod.HEADER)
    assert heads["t"] == heads["j"]
