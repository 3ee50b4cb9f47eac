"""The kill harness of the port: ``Trainer.fit`` in a subprocess, SIGKILL
at every registered fault site of the train pipeline, a fault-free
relaunch, and the stitched ``train.csv`` must be BYTE-IDENTICAL to an
uninterrupted run's (the twin of ``tests/test_kill_harness.py`` and
``scripts/ci_faults.sh``). The SIGTERM drill exercises preemption: the
worker exits 0, reports ``preempted=True``, and leaves an emergency
checkpoint a relaunch continues from.

This file is its own subprocess worker: ``python
tests/test_torch_kill_harness.py --worker --save-dir D --log-dir L ...``
runs one fit of a tiny GPT (2L/2H/32d, T=32, K=2, 12 steps, checkpoints
every 3), armed through ``GYM_TPU_FAULTS``, and writes a JSON result on a
clean finish; ``--strategy zero --num-nodes K`` runs ZeRO-1 (ZeRO-2
checkpoints) at K nodes, the elastic drill's worker
(``tests/test_torch_elastic.py``). The seeded chaos campaigns over the same worker (the twin of
``tests/test_chaos_campaign.py:230``) are marked slow, as there;
``scripts/ci_torch_faults.sh`` runs them with this file.
"""

import argparse
import json
import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_STEPS = 12
CKPT_INTERVAL = 3
TIMEOUT_S = 120

# site -> (kill hit, synchronous checkpoints?). Hits land mid-run, so a
# checkpoint is durable before the kill and work remains after it. The
# loop-side sites save synchronously (the commit precedes later
# boundaries); the writer's sites keep the async path, where they live,
# and its serialization: the hit-1 save commits before hit 2 dies.
KILL_SITES = {
    "dispatch.boundary": (8, True),
    "prefetch.fill": (7, True),
    "checkpoint.write": (2, False),
    "checkpoint.device_get": (2, False),
}


def worker(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--log-dir", required=True)
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--strategy", default="simple",
                    choices=["simple", "diloco_int4", "zero"])
    ap.add_argument("--num-nodes", type=int, default=2)
    ap.add_argument("--guard", action="store_true",
                    help="run under fit(guard=...), as a campaign that may "
                         "corrupt the live state (dispatch.state) needs")
    ap.add_argument("--result", default="")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import (DiLoCoStrategy, OptimSpec,
                                        SimpleReduceStrategy,
                                        ZeroReduceStrategy)
    from gym_tpu_torch.utils.integrity import Guard

    torch.set_num_threads(1)
    toks = np.random.default_rng(0).integers(0, 65, 6000).astype(np.int32)
    if args.strategy == "diloco_int4":
        # H=2 < the interval: every checkpoint lands mid-cycle with a
        # nonzero error-feedback residual in the strategy state
        strategy = DiLoCoStrategy(OptimSpec("sgd", lr=0.05), H=2,
                                  codec="int4")
    elif args.strategy == "zero":
        # sharded AdamW moments and ZeRO-2 checkpoints: a resume at another
        # --num-nodes reshards them
        strategy = ZeroReduceStrategy(OptimSpec("adamw", lr=3e-3))
    else:
        strategy = SimpleReduceStrategy(OptimSpec("sgd", lr=0.05))
    res = Trainer(GPT(GPTConfig(block_size=32, vocab_size=65, n_layer=2,
                                n_head=2, n_embd=32)),
                  ContiguousGPTTrainDataset(toks, 32)).fit(
        strategy=strategy, num_nodes=args.num_nodes, max_steps=MAX_STEPS,
        batch_size=4,
        minibatch_size=2, device="cpu", val_size=0, show_progress=False,
        seed=3, checkpoint_interval=CKPT_INTERVAL, save_dir=args.save_dir,
        run_name="kill", log_dir=args.log_dir,
        async_checkpoint=not args.sync_ckpt,
        guard=Guard(max_rollbacks=3) if args.guard else None)
    if args.result:
        with open(args.result, "w") as f:
            json.dump({"steps": res.steps, "preempted": res.preempted,
                       "losses": [[s, l] for s, l in
                                  res.history["train_loss"]]}, f)


def run_worker(save_dir, log_dir, *, faults="", result=None,
               sync_ckpt=False, strategy=None, guard=False, num_nodes=2):
    env = dict(os.environ)
    env["GYM_TPU_FAULTS"] = faults
    env["GYM_TPU_IO_RETRIES"] = "2"
    env["GYM_TPU_IO_RETRY_BASE_S"] = "0.01"
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--save-dir", str(save_dir), "--log-dir", str(log_dir)]
    if result:
        cmd += ["--result", str(result)]
    if sync_ckpt:
        cmd += ["--sync-ckpt"]
    if strategy:
        cmd += ["--strategy", strategy]
    if guard:
        cmd += ["--guard"]
    if num_nodes != 2:
        cmd += ["--num-nodes", str(num_nodes)]
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=TIMEOUT_S)


def train_csv(log_dir) -> bytes:
    with open(os.path.join(str(log_dir), "kill", "train.csv"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_kill_harness")


@pytest.fixture(scope="module")
def baseline(scratch):
    """One uninterrupted 0→12 run: the oracle every crash+resume
    trajectory must reproduce byte for byte."""
    result = scratch / "base.json"
    p = run_worker(scratch / "base_ckpt", scratch / "base_logs",
                   result=result)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(open(result).read())
    assert res["steps"] == MAX_STEPS and not res["preempted"]
    return train_csv(scratch / "base_logs")


def _kill_resume_roundtrip(scratch, site, hit, sync_ckpt, strategy=None):
    tag = f"{site}_{strategy or 'simple'}"
    save, log, result = (scratch / f"{tag}_ckpt", scratch / f"{tag}_logs",
                         scratch / f"{tag}.json")
    p = run_worker(save, log, faults=f"{site}:kill@{hit}",
                   sync_ckpt=sync_ckpt, strategy=strategy)
    assert p.returncode == -signal.SIGKILL, (
        f"expected SIGKILL death at {site}@{hit}, got rc={p.returncode}\n"
        f"{p.stderr[-4000:]}")
    assert not os.path.exists(result)
    p = run_worker(save, log, result=result, sync_ckpt=sync_ckpt,
                   strategy=strategy)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(open(result).read())
    assert res["steps"] == MAX_STEPS
    # the relaunch genuinely started from a checkpoint
    first = res["losses"][0][0]
    assert first > 0 and first % CKPT_INTERVAL == 0, first
    return train_csv(log)


@pytest.mark.parametrize("site", sorted(KILL_SITES))
def test_kill9_at_site_resumes_byte_identical(scratch, baseline, site):
    hit, sync_ckpt = KILL_SITES[site]
    assert _kill_resume_roundtrip(scratch, site, hit, sync_ckpt) == \
        baseline, f"crash at {site}@{hit} + resume is not byte-identical"


def test_kill9_compressed_diloco_residual_roundtrips(scratch):
    """The error-feedback residual is training state: compressed DiLoCo
    (int4, H=2) killed past a durable mid-cycle save resumes
    byte-identical to its own uninterrupted run."""
    p = run_worker(scratch / "ef_base_ckpt", scratch / "ef_base_logs",
                   sync_ckpt=True, strategy="diloco_int4")
    assert p.returncode == 0, p.stderr[-4000:]
    oracle = train_csv(scratch / "ef_base_logs")
    got = _kill_resume_roundtrip(scratch, "dispatch.boundary", 8, True,
                                 strategy="diloco_int4")
    assert got == oracle, "the residual did not round-trip"


def test_sigterm_drill_emergency_checkpoint_and_clean_exit(scratch,
                                                           baseline):
    save, log, result = (scratch / "sigterm_ckpt", scratch / "sigterm_logs",
                         scratch / "sigterm.json")
    p = run_worker(save, log, result=result,
                   faults="dispatch.boundary:sigterm@5")
    assert p.returncode == 0, (
        f"SIGTERM drill did not exit cleanly: rc={p.returncode}\n"
        f"{p.stderr[-4000:]}")
    res = json.loads(open(result).read())
    assert res["preempted"] and 0 < res["steps"] < MAX_STEPS
    assert os.path.isdir(os.path.join(str(save), "kill", str(res["steps"])))
    p = run_worker(save, log, result=result)
    assert p.returncode == 0, p.stderr[-4000:]
    res2 = json.loads(open(result).read())
    assert not res2["preempted"] and res2["steps"] == MAX_STEPS
    assert res2["losses"][0][0] == res["steps"]
    assert train_csv(log) == baseline


# -- seeded chaos campaigns over the worker ---------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_seeded_campaign_holds_invariants(scratch, seed):
    """Random fault mixes over every compatible train-pipeline site (the
    copied ``utils/chaos.py``): no silent divergence (train.csv
    byte-identical to a fault-free guarded run), every failure typed,
    recovery within the relaunch budget, and the run dir still restores."""
    from gym_tpu_torch.utils import chaos
    from gym_tpu_torch.utils.checkpoint import restore_params

    oracle_log = scratch / "campaign_base_logs"
    if not os.path.exists(os.path.join(str(oracle_log), "kill")):
        p = run_worker(scratch / "campaign_base_ckpt", oracle_log,
                       sync_ckpt=True, guard=True)
        assert p.returncode == 0, p.stderr[-4000:]
    oracle = train_csv(oracle_log)
    base = scratch / f"seed{seed}"
    save, log, result = base / "ckpt", base / "logs", base / "result.json"

    def launch(spec):
        if os.path.exists(result):
            os.unlink(result)
        p = run_worker(save, log, faults=spec, result=result,
                       sync_ckpt=True, guard=True)
        completed = False
        if p.returncode == 0 and os.path.exists(result):
            out = json.loads(open(result).read())
            completed = out["steps"] == MAX_STEPS and not out["preempted"]
        return {"returncode": p.returncode, "stderr": p.stderr,
                "completed": completed}

    def verify():
        violations = []
        if train_csv(log) != oracle:
            violations.append(f"seed {seed}: train.csv diverged")
        step, params, _ = restore_params(str(save / "kill"))
        if not params or step <= 0:
            violations.append(f"seed {seed}: the run dir does not restore")
        return violations

    res = chaos.run_train_campaign(seed, launch, verify=verify)
    assert res.ok, (f"campaign seed {seed}: schedule "
                    f"{chaos.faults_spec(res.events)}, attempts "
                    f"{res.attempts}, violations {res.violations}")


if __name__ == "__main__":
    if sys.argv[1:2] != ["--worker"]:
        sys.exit("usage: test_torch_kill_harness.py --worker --save-dir D "
                 "--log-dir L [--sync-ckpt] [--strategy S] [--guard] "
                 "[--result R]")
    worker(sys.argv[2:])
