"""The SDC guard of the port: anomaly detection on the live fit loop and
the rollback-and-replay in ``Trainer.fit``, against the JAX package's.

- ``GuardRuntime`` trips at the same step for the same reason on the same
  loss and fingerprint sequences as ``gym_tpu``'s (twins of
  ``tests/test_guard_rollback.py:34-79``);
- ``corrupt_state_tree`` flips the same element and bits as ``gym_tpu``'s
  for the same spec and hit;
- end to end, the oracle is BYTE-IDENTITY: a guarded fit that takes a
  ``dispatch.state`` bit flip mid-run rolls back to the last
  checksum-verified checkpoint, replays, and writes a ``train.csv``
  byte-identical to an uninterrupted run without a guard.

Every fit is a tiny GPT (2L/2H/32d, T=32) at K=2, checkpointed every 3
steps, SGD."""

import math
import os

import jax
import numpy as np
import pytest
import torch

from gym_tpu.utils import integrity as jintegrity
from gym_tpu.utils.resilience import faults as jfaults
from gym_tpu_torch import Trainer
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.strategy import OptimSpec, SimpleReduceStrategy
from gym_tpu_torch.utils import integrity
from gym_tpu_torch.utils.integrity import (Guard, GuardRuntime,
                                           GuardTrippedError)
from gym_tpu_torch.utils.resilience import faults

T, V = 32, 65
TINY = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These fits are tiny: one intra-op thread runs them fastest, and
    keeps them fast beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# -- the guard's policy against the JAX package's ---------------------------


def _trips(mod, cfg, events):
    """Feed ``events`` ((kind, step, value[, worst])) to ``mod``'s
    GuardRuntime; the (step, reason) of every trip, the run continuing
    after each."""
    rt = mod.GuardRuntime(mod.Guard(**cfg))
    out = []
    for kind, step, *vals in events:
        try:
            if kind == "loss":
                rt.observe_loss(step, *vals)
            elif kind == "fp":
                rt.observe_fingerprint(step, *vals)
            else:
                rt.note_rollback()
        except mod.GuardTrippedError as e:
            out.append((e.step, e.reason))
    return out, rt.rollbacks


SEQUENCES = {
    "nonfinite_in_warmup": (dict(warmup=100), [
        ("loss", 0, 2.0), ("loss", 1, float("nan")),
        ("loss", 2, float("inf"))]),
    "spike_after_warmup": (dict(ewma_alpha=0.5, spike_factor=3.0,
                                spike_slack=2.0, warmup=3), [
        ("loss", 0, 1.0), ("loss", 1, 50.0), ("loss", 2, 1.0),
        ("loss", 3, 2.0), ("loss", 4, 1e6)]),
    "slack_protects_converged": (dict(spike_factor=3.0, spike_slack=2.0,
                                      warmup=1), [
        ("loss", 0, 0.01), ("loss", 1, 0.05), ("loss", 2, 5.0)]),
    "worst_node_trips": (dict(warmup=1), [
        ("loss", 0, 1.0, 1.0), ("loss", 1, 1.1, 1.2),
        ("loss", 2, 1.0, float("nan"))]),
    "rollback_resets": (dict(warmup=1), [
        ("loss", 0, 1.0), ("loss", 1, 1.0), ("rollback", 0),
        ("loss", 2, 100.0), ("loss", 3, 100.0)]),
    "fingerprint_jump_and_nonfinite": (dict(fingerprint_interval=1,
                                            fingerprint_factor=10.0), [
        ("fp", 0, 5.0), ("fp", 1, 6.0), ("fp", 2, 1e5),
        ("fp", 3, float("nan"))]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_guard_trips_like_the_jax_package(name):
    cfg, events = SEQUENCES[name]
    got = _trips(integrity, cfg, events)
    want = _trips(jintegrity, cfg, events)
    assert got == want
    assert name == "rollback_resets" or got[0], "the sequence must trip"


# -- corrupt_state_tree flips what the JAX package flips ---------------------


@pytest.mark.parametrize("bits,hit", [(1, 1), (4, 4), (3, 7)])
def test_corrupt_state_tree_flips_the_same_bits(bits, hit):
    """The same tree, spec and hit: the same element of the same leaf
    (the largest float leaf, the first of equal sizes in sorted-key order)
    gets the same exponent bits; integer leaves are never touched."""
    rng = np.random.default_rng(hit)
    tree = {"b": {"z": rng.standard_normal((2, 5, 7)).astype(np.float32),
                  "a": rng.standard_normal((2, 35)).astype(np.float32)},
            "a": rng.standard_normal((2, 3)).astype(np.float32),
            "n": np.arange(200, dtype=np.int32)}
    faults.install("dispatch.state", "bitflip", arg=bits, first=hit,
                   last=hit)
    jfaults.install("dispatch.state", "bitflip", arg=bits, first=hit,
                    last=hit)
    ttree = {"b": {k: torch.from_numpy(v.copy())
                   for k, v in tree["b"].items()},
             "a": torch.from_numpy(tree["a"].copy()),
             "n": torch.from_numpy(tree["n"].copy())}
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    for _ in range(hit):
        tout = integrity.corrupt_state_tree(ttree)
        jout = jintegrity.corrupt_state_tree(jtree)

    def flat(t, arr):
        return {"a": arr(t["a"]), "n": arr(t["n"]),
                **{f"b.{k}": arr(v) for k, v in t["b"].items()}}
    got = flat(tout, lambda x: x.numpy())
    want = flat(jout, np.asarray)
    before = flat(tree, np.asarray)
    changed = sorted(k for k in got
                     if got[k].tobytes() != before[k].tobytes())
    assert changed == ["b.a"]  # 70 elements, before b.z's 70 in key order
    for k in got:
        assert got[k].tobytes() == want[k].tobytes(), k
    # the live tree was not written
    assert np.array_equal(ttree["b"]["a"].numpy(), tree["b"]["a"])


# -- rollback-and-replay end to end -----------------------------------------


def _fit(base, tag, guard=None, max_steps=12, **kw):
    base = str(base)
    toks = np.random.default_rng(0).integers(0, V, 6000).astype(np.int32)
    res = Trainer(GPT(GPTConfig(**TINY)),
                  ContiguousGPTTrainDataset(toks, T)).fit(
        strategy=SimpleReduceStrategy(OptimSpec("sgd", lr=0.05)),
        num_nodes=2, max_steps=max_steps, batch_size=4, minibatch_size=2,
        device="cpu", val_size=0, show_progress=False, seed=3,
        checkpoint_interval=3, save_dir=os.path.join(base, tag, "ckpt"),
        run_name="g", log_dir=os.path.join(base, tag, "logs"),
        guard=guard, **kw)
    with open(os.path.join(base, tag, "logs", "g", "train.csv"), "rb") as f:
        return res, f.read()


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One unguarded, fault-free 0→12 run: the oracle of every replay."""
    res, csv = _fit(tmp_path_factory.mktemp("guard_base"), "base")
    assert res.steps == 12
    return csv


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_rollback_replay_is_byte_identical(tmp_path, baseline, async_ckpt):
    rt = GuardRuntime(Guard(max_rollbacks=2))
    faults.install("dispatch.state", "bitflip", arg=2, first=5, last=5)
    res, csv = _fit(tmp_path, "guarded", guard=rt,
                    async_checkpoint=async_ckpt, prefetch=async_ckpt)
    assert rt.rollbacks == 1, rt.trips
    assert rt.trips[0][1].startswith(("loss spike", "non-finite loss"))
    assert res.steps == 12
    assert csv == baseline, "replayed train.csv diverged"


def test_fingerprint_probe_catches_a_state_flip(tmp_path, baseline):
    """chip_smoke phase 11c's guard: the on-card fingerprint every step and
    a 4-bit exponent flip at the 4th dispatch: one rollback, and the
    replay ends byte-identical."""
    rt = GuardRuntime(Guard(fingerprint_interval=1, max_rollbacks=2))
    faults.install("dispatch.state", "bitflip", arg=4, first=4, last=4)
    res, csv = _fit(tmp_path, "fp", guard=rt)
    assert rt.rollbacks == 1, rt.trips
    assert res.steps == 12 and csv == baseline


def test_rollback_budget_exhaustion_propagates(tmp_path):
    rt = GuardRuntime(Guard(max_rollbacks=0))
    faults.install("dispatch.state", "bitflip", arg=2, first=5, last=5)
    with pytest.raises(GuardTrippedError):
        _fit(tmp_path, "exhaust", guard=rt)
    assert rt.rollbacks == 0 and len(rt.trips) == 1


def test_plain_guard_and_fingerprints_do_not_perturb_the_run(tmp_path,
                                                             baseline):
    """fit accepts a bare Guard and True; with the fingerprint probe on a
    clean run, fingerprints flow through observe_fingerprint and the
    train.csv is the unguarded run's."""
    rt = GuardRuntime(Guard(fingerprint_interval=2, fingerprint_factor=1e12,
                            spike_factor=1e9, spike_slack=1e9))
    res, csv = _fit(tmp_path, "fpobs", guard=rt)
    assert res.steps == 12 and rt.trips == [] and csv == baseline
    assert rt._last_fp is not None and math.isfinite(rt._last_fp)
    res, csv = _fit(tmp_path, "bare", guard=Guard(), max_steps=4)
    assert res.steps == 4
    with pytest.raises(ValueError, match="guard must be"):
        _fit(tmp_path, "bad", guard="yes", max_steps=1)
