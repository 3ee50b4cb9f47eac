"""The port's serving simulator (``gym_tpu_torch/servesim``, twin of
``tests/test_servesim.py``) against ``gym_tpu``'s on the CPU.

- the trace generators write byte-equal files for the same seed, and each
  package loads the other's (the header is shared);
- the cost model (the autoscale controller inside it) gives the same
  outcomes, autoscale log and report on the same trace, with and without
  quotas and preemption;
- the port's frontier and tenant gates pass against the committed
  baselines (``logs/servesim/frontier_baseline.json``,
  ``logs/servesim/tenant/tenant_baseline.json``);
- ``calibrate_router`` probes a live in-process fleet of the port through
  its ``SamplingParams``;
- the copies (``serve/autoscale.py``, ``servesim/*`` but ``drill.py``,
  ``sim/gridlib.py``) are pinned to their originals' code in
  ``tests/test_torch_serve_http.py``;
- the closed train→deploy drill (slow, as its original): zero dropped,
  zero recompiles, the post-swap stream equal to ``generate_fast``.
"""

import dataclasses
import pathlib
import tempfile

import numpy as np
import pytest
import torch

import gym_tpu.servesim as jsim
import gym_tpu_torch.servesim as tsim
from gym_tpu.serve.autoscale import AutoscalePolicy as JPolicy
from gym_tpu.servesim.cost_model import class_reports as jclass_reports
from gym_tpu_torch.serve.autoscale import AutoscalePolicy as TPolicy
from gym_tpu_torch.servesim.cost_model import class_reports as tclass_reports

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("diurnal", "bursty", "flash_crowd", "noisy_neighbor",
            "tenant_flash", "mixed_slo")


@pytest.mark.parametrize("family", FAMILIES)
def test_traces_are_byte_equal_and_cross_load(family, tmp_path):
    kw = dict(seed=5, duration_s=30.0)
    if family in ("diurnal", "bursty", "flash_crowd"):
        kw.update(deadline_s=5.0, deadline_frac=0.5, prefix_groups=3)
    jev = jsim.make_trace(family, **kw)
    tev = tsim.make_trace(family, **kw)
    jp, tp = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jsim.save_trace(jp, jev)
    tsim.save_trace(tp, tev)
    assert pathlib.Path(jp).read_bytes() == pathlib.Path(tp).read_bytes()
    assert [dataclasses.asdict(e) for e in tsim.load_trace(jp)] == \
        [dataclasses.asdict(e) for e in jev]
    assert [dataclasses.asdict(e) for e in jsim.load_trace(tp)] == \
        [dataclasses.asdict(e) for e in tev]
    assert tsim.trace_stats(tev) == jsim.trace_stats(jev)
    ev = tev[0]
    assert np.array_equal(tsim.prompt_tokens(ev, 48),
                          jsim.prompt_tokens(jsim.RequestEvent(
                              **dataclasses.asdict(ev)), 48))


def _cost(sim, policy_cls, family, quotas, preempt, autoscale):
    prof = sim.ServiceProfile(tokens_per_s=120.0, num_slots=4,
                              max_queue=64, request_overhead_s=0.05,
                              startup_s=4.0)
    events = sim.make_trace(family, seed=3, duration_s=60.0)
    pol = policy_cls(min_replicas=1, max_replicas=4, up_drain_s=2.0,
                     down_drain_s=0.25, up_patience=1, down_patience=4,
                     cooldown=2)
    return events, sim.FleetCostModel(
        prof, pol, initial_replicas=2, autoscale=autoscale, quotas=quotas,
        preempt=preempt).run(events)


@pytest.mark.parametrize("family,quotas,preempt,autoscale", [
    ("flash_crowd", None, False, True),
    ("bursty", None, False, False),
    ("noisy_neighbor", {"batch": {"share": 0.5}}, True, False),
    ("mixed_slo", {"batch": {"share": 0.5}}, True, True),
])
def test_cost_model_equals_the_jax_package(family, quotas, preempt,
                                           autoscale):
    jev, jres = _cost(jsim, JPolicy, family, quotas, preempt, autoscale)
    tev, tres = _cost(tsim, TPolicy, family, quotas, preempt, autoscale)
    assert tres.report() == jres.report()
    assert tres.autoscale_log == jres.autoscale_log
    assert [dataclasses.asdict(o) for o in tres.outcomes] == \
        [dataclasses.asdict(o) for o in jres.outcomes]
    assert (tres.spawns, tres.retires, tres.preemptions,
            tres.quota_rejected) == (jres.spawns, jres.retires,
                                     jres.preemptions, jres.quota_rejected)
    assert tclass_reports(tev, tres.outcomes, slo_ttft_s=2.0) == \
        jclass_reports(jev, jres.outcomes, slo_ttft_s=2.0)


def test_frontier_gate_passes_against_the_committed_baseline(capsys):
    from gym_tpu_torch.servesim import frontier_gate
    base = ROOT / "logs" / "servesim" / "frontier_baseline.json"
    before = base.read_bytes()
    assert frontier_gate.main(["--baseline", str(base)]) == 0
    out = capsys.readouterr().out
    assert "-> OK" in out and "REGRESSION" not in out
    assert base.read_bytes() == before


def test_tenant_gate_passes_against_the_committed_baseline(capsys):
    from gym_tpu_torch.servesim import tenant_gate
    base = ROOT / "logs" / "servesim" / "tenant" / "tenant_baseline.json"
    before = base.read_bytes()
    assert tenant_gate.main(["--baseline", str(base)]) == 0
    out = capsys.readouterr().out
    assert "-> OK" in out and "REGRESSION" not in out
    assert base.read_bytes() == before


def test_calibrate_router_probes_the_ports_fleet():
    """``cost_model.calibrate_router`` against a live in-process fleet of
    the port (its ``SamplingParams`` through ``Router.submit``) and the
    open-loop replay of a tiny trace through ``RouterClient``: every
    request done."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.serve.metrics import ServeMetrics
    from gym_tpu_torch.serve.router import build_fleet
    from gym_tpu_torch.convert import serving_params
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = GPTConfig(block_size=64, vocab_size=48, n_layer=2, n_head=2,
                    n_embd=32, dropout=0.0, bias=True)
    params = serving_params(GPT(cfg).init_params(1, 0, "cpu"))
    m = ServeMetrics(tempfile.mkdtemp(prefix="gym_torch_svsmoke_"))
    router = build_fleet(params, cfg, replicas=1, num_slots=2,
                         decode_chunk=2, metrics=m, device="cpu",
                         log=lambda *a, **k: None).start()
    try:
        prof = tsim.calibrate_router(router, 48, num_slots=2, probes=1,
                                     m1=4, m2=12)
        tr = tsim.diurnal_trace(duration_s=6, base_rps=1.5, seed=9,
                                prompt_lens=(4, 16), max_news=(4, 8))
        live = tsim.replay_router(router, tr, vocab_size=48,
                                  time_scale=4.0)["report"]
    finally:
        router.close(drain_deadline_s=60)
        m.close()
        torch.set_num_threads(threads)
    assert prof.tokens_per_s > 0 and prof.num_slots == 2
    assert prof.request_overhead_s >= 0
    assert live["requests"] == live["done"] == len(tr)


@pytest.mark.slow
def test_drill_in_process(tmp_path):
    from gym_tpu_torch.servesim.drill import run_drill
    result = run_drill(str(tmp_path / "drill"), replicas=2,
                       out_of_process=False, kill_trainer=False,
                       final_steps=8, trace_duration_s=12.0, device="cpu")
    assert result["ok"], result["failures"]
    assert result["replay"]["done"] == result["replay"]["requests"]
    assert result["post_swap_stream_exact"]
    assert result["compiles_before"] == result["compiles_after"]
