"""Wire-corruption failover of the port's process fleet (twin of
``tests/test_sdc_wire_failover.py``): a worker whose frames arrive with
flipped bits must NEVER deliver a wrong token — the per-frame crc turns the
corruption into a typed ``FrameCorruptError``, the router marks the worker
dead with that reason, and the stream completes through the surviving
sibling equal to ``gym_tpu``'s ``generate_fast`` on the same weights.

Fault arming is PER-REPLICA via ``GYM_TPU_FAULTS_REPLICA_<id>`` in the
workers' environment (a fleet-wide ``GYM_TPU_FAULTS`` would corrupt the
failover target too). The window ``@4+`` leaves the hello (hit 1) and the
first health frames clean so ``wait_ready`` sees a healthy fleet before the
corruption strikes every later frame replica 0 sends. Slow, as its
original is.
"""

import tempfile

import numpy as np
import pytest

from gym_tpu.models import nanogpt as J
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.serve.engine import SamplingParams
from gym_tpu_torch.serve.metrics import ServeMetrics
from gym_tpu_torch.serve.router import build_process_fleet
from test_torch_decode import numpy_params, port_config

pytestmark = pytest.mark.slow


@pytest.fixture()
def corrupt_fleet():
    jcfg = J.GPTConfig(block_size=64, vocab_size=48, n_layer=2, n_head=2,
                       n_embd=32, dropout=0.0, bias=True)
    jparams = numpy_params(jcfg, 0)
    metrics = ServeMetrics(tempfile.mkdtemp(prefix="gym_torch_sdcm_"))
    router = build_process_fleet(
        serving_params_from_jax(jparams, "cpu"), port_config(jcfg),
        tempfile.mkdtemp(prefix="gym_torch_sdcw_"), replicas=2,
        num_slots=2, metrics=metrics, no_warmup=True, max_restarts=0,
        device="cpu", env={"GYM_TPU_FAULTS_REPLICA_0":
                           "wire.frame:bitflip=1@4+",
                           "OMP_NUM_THREADS": "1"},
        log=lambda *a, **k: None)
    try:
        router.start()
        router.wait_ready(timeout_s=120)
        yield jcfg, jparams, router
    finally:
        router.close(drain_deadline_s=60)
        metrics.close()


def test_corrupt_wire_frames_fail_over_without_wrong_tokens(
        corrupt_fleet):
    jcfg, jparams, router = corrupt_fleet
    prompt = [1, 2, 3, 4, 5, 6]
    ref = J.generate_fast(jparams, jcfg, np.asarray(prompt)[None], 16,
                          temperature=0.9, top_k=7,
                          seed=3)[0, len(prompt):].tolist()
    got = []
    pr = router.submit(prompt, SamplingParams(
        max_new_tokens=16, temperature=0.9, top_k=7, seed=3))
    for chunk in pr.stream(timeout=120):
        got.extend(chunk)
    # never a wrong token: the stream is exact although replica 0 emits
    # corrupt frames for every post-readiness message
    assert got == ref, (got, ref)
    st = router.status()
    dead = [r for r in st["replicas"] if r.get("dead")]
    assert dead, st
    assert any("FrameCorruptError" in (r.get("death_reason") or "")
               for r in dead), st
    # the survivor is still healthy — the fleet did not collapse
    assert any(not r.get("dead") for r in st["replicas"]), st
