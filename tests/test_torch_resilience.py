"""The port's resilience layer on the CPU, against the JAX package's where
both compute the same thing: crc32c and the checkpoint sidecars (the copied
code, on the same bytes), the hardened ``CheckpointManager`` (typed errors,
the async writer's retries, newest-wins coalescing, the corrupt-newest
fallback with quarantine, the loud close), ``fit``'s resume knob and its
preemption drill, the batch prefetcher (bit-identical to the synchronous
path, the consumed position checkpointed) and the chaos campaign's
machinery (the copied ``chaos.py`` draws the JAX package's schedules).

Twins of ``tests/test_integrity.py``, ``tests/test_resilience.py``,
``tests/test_prefetch.py`` and the fast half of
``tests/test_chaos_campaign.py``; every fit is a tiny GPT (2L/2H/32d,
T=32) at K=2. The subprocess kill and SIGTERM drills are
``tests/test_torch_kill_harness.py``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gym_tpu.utils import chaos as jchaos
from gym_tpu.utils import integrity as jintegrity
from gym_tpu_torch import Trainer
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.data.prefetch import (HostPrefetcher, PrefetchError,
                                         dispatch_schedule)
from gym_tpu_torch.data.sampler import NodeBatchIterator, resolve_node_datasets
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.strategy import (DiLoCoStrategy, OptimSpec,
                                    SimpleReduceStrategy)
from gym_tpu_torch.utils import chaos, integrity
from gym_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            CheckpointNotFoundError,
                                            CheckpointWriteError,
                                            CheckpointWriterStuckError,
                                            restore_params)
from gym_tpu_torch.utils.integrity import (ChecksumMismatchError, crc32c,
                                           tree_fingerprint,
                                           tree_fingerprint_host,
                                           verify_sidecar, write_sidecar)
from gym_tpu_torch.utils.resilience import (FaultRegistry, RetryPolicy,
                                            Watchdog, faults)

FAST_RETRY = RetryPolicy(attempts=4, base_delay=0.01, max_delay=0.02)
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
    yield
    faults.reset()


def _tokens(n=6000):
    return np.random.default_rng(0).integers(0, V, n).astype(np.int32)


def _fit(base, max_steps, tag="run", strategy=None, **kw):
    """A tiny GPT at K=2 under SimpleReduce SGD, checkpointed every 3
    steps into ``<base>/ckpt/<tag>``, logged to ``<base>/logs/<tag>``."""
    base = str(base)
    kw.setdefault("checkpoint_interval", 3)
    kw.setdefault("save_dir", os.path.join(base, "ckpt"))
    kw.setdefault("run_name", tag)
    return Trainer(GPT(GPTConfig(**TINY)),
                   ContiguousGPTTrainDataset(_tokens(), T)).fit(
        strategy=strategy or SimpleReduceStrategy(OptimSpec("sgd", lr=0.05)),
        num_nodes=2, max_steps=max_steps, batch_size=4, minibatch_size=2,
        device="cpu", val_size=0, show_progress=False, seed=3,
        log_dir=os.path.join(base, "logs"), **kw)


def _train_csv(base, tag="run"):
    with open(os.path.join(str(base), "logs", tag, "train.csv"), "rb") as f:
        return f.read()


# -- crc32c and the sidecars: the copied code on the same bytes ------------


def test_crc32c_reference_vector():
    # the canonical Castagnoli check value (RFC 3720 B.4)
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    data = bytes(range(256)) * 41  # deliberately not 8-aligned
    assert crc32c(data) == crc32c(data[100:], crc32c(data[:100]))
    assert crc32c(data) == jintegrity.crc32c(data)


def test_crc32c_detects_single_bitflip():
    data = os.urandom(4096)
    flipped = bytearray(data)
    flipped[1234] ^= 0x10
    assert crc32c(bytes(flipped)) != crc32c(data)


def _make_step_dir(tmp_path, name="7"):
    d = tmp_path / name
    (d / "state").mkdir(parents=True)
    (d / "state" / "shard0").write_bytes(os.urandom(2048))
    (d / "meta.json").write_text('{"k": 1}')
    return str(d)


def test_sidecar_roundtrip_and_mismatch(tmp_path):
    d = _make_step_dir(tmp_path)
    write_sidecar(d, fingerprint={"sum": 1.5, "num_leaves": 3})
    assert verify_sidecar(d) is True
    # the JAX package reads the port's sidecar as its own
    assert jintegrity.verify_sidecar(d) is True
    rec = json.loads(open(os.path.join(d, "integrity.json")).read())
    assert rec["algo"] == "crc32c" and "state/shard0" in rec["files"]
    assert "integrity.json" not in rec["files"]
    p = os.path.join(d, "state", "shard0")
    raw = bytearray(open(p, "rb").read())
    raw[100] ^= 0x1
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ChecksumMismatchError, match="state/shard0"):
        verify_sidecar(d)


def test_sidecar_missing_file_and_old_format(tmp_path):
    d = _make_step_dir(tmp_path)
    assert verify_sidecar(d) is False  # no sidecar: accepted
    write_sidecar(d)
    os.remove(os.path.join(d, "meta.json"))
    with pytest.raises(ChecksumMismatchError, match="file missing"):
        verify_sidecar(d)


def test_tree_fingerprint_host_and_device_agree():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    c = np.ones(5, dtype=np.int32)
    tree = {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c)},
            "skip": "not-a-tensor", "none": None}
    host = tree_fingerprint_host(tree)
    assert host["num_leaves"] == 2
    assert host == jintegrity.tree_fingerprint_host({"a": a, "b": {"c": c}})
    dev = float(tree_fingerprint(tree))
    assert abs(dev - host["sum"]) < 1e-3


def test_double_quarantine_takes_next_suffix(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "run", async_save=False)
    try:
        step = os.path.join(mgr.directory, "7")
        os.makedirs(os.path.join(step, "state"))
        os.makedirs(step + ".corrupt-0")  # an earlier quarantine
        mgr._quarantine_step(7)
        assert not os.path.exists(step)
        assert os.path.isdir(step + ".corrupt-1")
        assert os.path.isdir(step + ".corrupt-0")
        os.makedirs(os.path.join(step, "state"))
        mgr._quarantine_step(7)
        assert os.path.isdir(step + ".corrupt-2")
    finally:
        mgr.close()


# -- the manager ------------------------------------------------------------


def _small_state():
    return {"w": torch.arange(8, dtype=torch.float32),
            "b": torch.ones(2, 3), "rng": np.arange(4, dtype=np.uint32),
            "count": 3, "trace": None, "mods": [{"x": torch.zeros(2)}]}


def _mgr(tmp, **kw):
    kw.setdefault("retry_policy", FAST_RETRY)
    return CheckpointManager(str(tmp), "run", **kw)


def _corrupt_step(directory, step):
    """Zero-truncate every file of a committed step dir."""
    root = os.path.join(directory, str(step))
    for dirpath, _, files in os.walk(root):
        for name in files:
            open(os.path.join(dirpath, name), "wb").close()


def test_state_round_trips_every_leaf_type(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    s = {**_small_state(), "bf16": torch.randn(3, 2).bfloat16(),
         "pair": (1.5, torch.tensor([7], dtype=torch.int64)),
         "u64": np.array([2 ** 64 - 1], dtype=np.uint64)}
    mgr.save(5, s, {"epoch": 1, "pos": [3, 4]}, extra={"cum": 1.25})
    step, got, data_state, extra = mgr.restore(s)
    assert step == 5 and data_state == {"epoch": 1, "pos": [3, 4]}
    assert extra == {"cum": 1.25}
    assert list(got) == list(s)
    for k in ("w", "b", "bf16"):
        assert got[k].dtype == s[k].dtype and torch.equal(got[k], s[k])
    for k in ("rng", "u64"):
        assert got[k].dtype == s[k].dtype and np.array_equal(got[k], s[k])
    assert got["count"] == 3 and got["trace"] is None
    assert isinstance(got["pair"], tuple) and got["pair"][0] == 1.5
    assert torch.equal(got["mods"][0]["x"], torch.zeros(2))
    # a template of another shape is a layout mismatch, not this state
    with pytest.raises(ValueError, match="live state"):
        mgr.restore({**s, "w": torch.zeros(9)}, step=5)
    mgr.close()


def test_restore_empty_raises_typed(tmp_path):
    mgr = _mgr(tmp_path)
    with pytest.raises(CheckpointNotFoundError, match="no checkpoint"):
        mgr.restore(_small_state())
    mgr.close()


def test_restore_explicit_missing_step_raises(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(2, _small_state(), {"epoch": 0})
    with pytest.raises(CheckpointNotFoundError, match="step 7"):
        mgr.restore(_small_state(), step=7)
    mgr.close()


def test_restore_skips_corrupt_newest_and_resaves(tmp_path, capfd):
    mgr = _mgr(tmp_path)
    s = _small_state()
    mgr.save(2, s, {"epoch": 0}, extra={"tag": 2})
    mgr.save(4, s, {"epoch": 1}, extra={"tag": 4})
    assert mgr.all_steps() == [2, 4]
    _corrupt_step(mgr.directory, 4)
    step, _, data_state, extra = mgr.restore(_small_state())
    assert step == 2 and data_state == {"epoch": 0} and extra["tag"] == 2
    assert "skipping unreadable checkpoint step 4" in capfd.readouterr().err
    assert mgr.all_steps() == [2]
    assert os.path.isdir(os.path.join(mgr.directory, "4.corrupt-0"))
    mgr.save(4, s, {"epoch": 9}, extra={"tag": 44})
    step, _, _, extra = mgr.restore(_small_state())
    assert step == 4 and extra["tag"] == 44
    mgr.close()


def test_restore_all_corrupt_raises_typed_and_resaves(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(2, _small_state(), {"epoch": 0})
    _corrupt_step(mgr.directory, 2)
    with pytest.raises(CheckpointNotFoundError, match="no valid"):
        mgr.restore(_small_state())
    mgr.save(2, _small_state(), {"epoch": 5})
    step, _, data_state, _ = mgr.restore(_small_state())
    assert step == 2 and data_state == {"epoch": 5}
    mgr.close()


def test_async_writer_retries_transient_oserror(tmp_path):
    faults.install("checkpoint.write", "oserror", first=1, last=2)
    mgr = _mgr(tmp_path)
    mgr.save_async(3, _small_state(), {"epoch": 0})
    mgr.wait()
    assert faults.hits("checkpoint.write") == 3
    assert mgr.latest_step() == 3
    mgr.close()


def test_async_writer_device_get_retry(tmp_path):
    faults.install("checkpoint.device_get", "oserror", first=1, last=1)
    mgr = _mgr(tmp_path)
    mgr.save_async(3, _small_state(), {"epoch": 0})
    mgr.wait()
    assert faults.hits("checkpoint.device_get") == 2
    assert mgr.latest_step() == 3
    mgr.close()


def test_async_writer_exhausted_retries_surface_on_wait(tmp_path):
    faults.install("checkpoint.write", "oserror")  # every attempt fails
    mgr = _mgr(tmp_path)
    mgr.save_async(3, _small_state(), {"epoch": 0})
    with pytest.raises(CheckpointWriteError,
                       match="async checkpoint write failed"):
        mgr.wait()
    mgr.close()


def test_async_snapshot_is_taken_at_enqueue(tmp_path):
    """The writer saves the state as it was when ``save_async`` returned,
    whatever the caller writes into the live tensors afterwards."""
    faults.install("checkpoint.write", "delay", arg=0.3, first=1, last=1)
    mgr = _mgr(tmp_path)
    s = _small_state()
    t0 = time.perf_counter()
    mgr.save_async(1, s, {"epoch": 0})
    assert time.perf_counter() - t0 < 0.25  # the write is in flight
    s["w"].add_(100.0)
    mgr.wait()
    _, got, _, _ = mgr.restore(s)
    assert torch.equal(got["w"], torch.arange(8, dtype=torch.float32))
    mgr.close()


def test_coalescing_newest_wins_under_slow_inflight_write(tmp_path):
    faults.install("checkpoint.write", "delay", arg=0.4, first=1, last=1)
    mgr = _mgr(tmp_path)
    s = _small_state()
    mgr.save_async(1, s, {"epoch": 1})
    time.sleep(0.05)  # the writer holds step 1, slow
    mgr.save_async(2, s, {"epoch": 2})  # PENDING...
    mgr.save_async(3, s, {"epoch": 3})  # ...replaced by the newest
    mgr.wait()
    steps = mgr.all_steps()
    assert 3 in steps and 2 not in steps
    mgr.close()


def test_close_raises_on_hung_writer(tmp_path):
    faults.install("checkpoint.write", "delay", arg=1.5, first=1, last=1)
    mgr = _mgr(tmp_path, close_timeout=0.2)
    mgr.save_async(1, _small_state(), {"epoch": 0})
    time.sleep(0.05)
    with pytest.raises(CheckpointWriterStuckError,
                       match="writer thread still alive"):
        mgr.close()
    for _ in range(200):
        if not mgr._writer.is_alive():
            break
        time.sleep(0.1)
    mgr.close()


def test_watchdog_dump_names_the_hung_region(tmp_path):
    """A checkpoint write that hangs under the watchdog: the dump names
    the region (``checkpoint.write step 1``) and carries every thread's
    stack, the hung one inside the write."""
    fired = []
    wd = Watchdog(0.3, on_timeout=lambda label, msg: fired.append(
        (label, msg)), poll=0.05).start()
    faults.install("checkpoint.write", "delay", arg=1.0, first=1, last=1)
    mgr = _mgr(tmp_path, watchdog=wd, async_save=False)
    try:
        mgr.save(1, _small_state(), {"epoch": 0})
    finally:
        mgr.close()
        wd.close()
    assert fired and fired[0][0] == "checkpoint.write step 1"
    assert "'checkpoint.write step 1' exceeded" in fired[0][1]
    assert "--- thread MainThread" in fired[0][1]
    assert "in attempt" in fired[0][1]


# -- end to end: a fit's checkpoints ---------------------------------------


def test_corrupt_checkpoint_quarantined_at_restore(tmp_path):
    """A bit flip in the newest step is caught by its sidecar at restore,
    the step quarantined, and the run resumes from the older verified one
    to a train.csv byte-identical to an uninterrupted run's."""
    _fit(tmp_path / "s", 9)
    _fit(tmp_path, 6)
    run_dir = os.path.join(str(tmp_path), "ckpt", "run")
    faults.install("checkpoint.bytes", "bitflip", arg=3)
    integrity.corrupt_checkpoint_files(os.path.join(run_dir, "6"))
    faults.reset()
    res = _fit(tmp_path, 9)
    assert res.steps == 9 and res.history["train_loss"][0][0] == 3
    assert "6.corrupt-0" in os.listdir(run_dir)
    assert verify_sidecar(os.path.join(run_dir, "9")) is True
    assert _train_csv(tmp_path) == _train_csv(tmp_path / "s")


def test_restore_params_skips_corrupt_newest(tmp_path):
    _fit(tmp_path, 6)
    run_dir = os.path.join(str(tmp_path), "ckpt", "run")
    faults.install("checkpoint.bytes", "bitflip", arg=2)
    integrity.corrupt_checkpoint_files(os.path.join(run_dir, "6"))
    faults.reset()
    step, params, _extra = restore_params(run_dir)
    assert step == 3  # fell back past the corrupt newest, READ-ONLY
    assert os.path.isdir(os.path.join(run_dir, "6"))
    assert params and all(p.shape[0] == 2 for p in params.values())


def test_checkpoint_bytes_fault_fires_during_save(tmp_path):
    """checkpoint.bytes armed in the run corrupts the bytes AFTER the
    sidecar recorded the good ones."""
    faults.install("checkpoint.bytes", "bitflip", arg=2, first=2, last=2)
    try:
        _fit(tmp_path, 6)
    finally:
        faults.reset()
    run_dir = os.path.join(str(tmp_path), "ckpt", "run")
    assert verify_sidecar(os.path.join(run_dir, "3")) is True
    with pytest.raises(ChecksumMismatchError):
        verify_sidecar(os.path.join(run_dir, "6"))


def test_fit_default_run_name_resume_keeps_csv_history(tmp_path):
    _fit(tmp_path, 5, run_name=None)
    _fit(tmp_path, 8, run_name=None)
    with open(os.path.join(str(tmp_path), "logs", "default",
                           "train.csv")) as f:
        steps = [r.split(",")[0] for r in f.read().splitlines()[1:]]
    assert steps == [str(i) for i in range(8)]


def test_fit_resume_never_starts_over(tmp_path):
    _fit(tmp_path, 4)
    res = _fit(tmp_path, 4, resume="never")
    assert [s for s, _ in res.history["train_loss"]] == [0, 1, 2, 3]
    mgr = CheckpointManager(os.path.join(str(tmp_path), "ckpt"), "run")
    assert mgr.latest_step() == 4
    mgr.close()


def test_fit_resume_zero_is_a_step_pin_not_never(tmp_path):
    _fit(tmp_path, 4)
    with pytest.raises(CheckpointNotFoundError):
        _fit(tmp_path, 4, resume=0)
    mgr = CheckpointManager(os.path.join(str(tmp_path), "ckpt"), "run")
    assert mgr.latest_step() == 4  # not purged by the attempt
    mgr.close()


def test_fit_resume_validation(tmp_path):
    with pytest.raises(CheckpointNotFoundError):
        _fit(tmp_path / "x", 4, resume=7)
    with pytest.raises(ValueError, match="requires save_dir"):
        _fit(tmp_path / "x", 4, resume=7, checkpoint_interval=None,
             save_dir=None)
    with pytest.raises(ValueError, match="resume must be"):
        _fit(tmp_path / "x", 4, resume="latest")


def test_fit_resume_pinned_step(tmp_path):
    """resume=<step> restores that step, not the newest."""
    _fit(tmp_path / "s", 8)
    _fit(tmp_path, 6)
    res = _fit(tmp_path, 8, resume=3)
    assert res.history["train_loss"][0][0] == 3
    assert _train_csv(tmp_path) == _train_csv(tmp_path / "s")


def test_fit_preempted_by_sigterm_emergency_checkpoint(tmp_path):
    """SIGTERM delivered at a dispatch boundary: one synchronous emergency
    checkpoint, a clean return with preempted=True and no final eval; the
    resume ends byte-identical to an uninterrupted run."""
    _fit(tmp_path / "s", 10)
    faults.install("dispatch.boundary", "sigterm", first=5, last=5)
    res = _fit(tmp_path, 10)
    faults.reset()
    assert res.preempted and 0 < res.steps < 10
    mgr = CheckpointManager(os.path.join(str(tmp_path), "ckpt"), "run")
    assert mgr.latest_step() == res.steps
    mgr.close()
    res2 = _fit(tmp_path, 10)
    assert not res2.preempted and res2.steps == 10
    assert res2.history["train_loss"][0][0] == res.steps
    assert _train_csv(tmp_path) == _train_csv(tmp_path / "s")


# -- the prefetcher ---------------------------------------------------------


def test_dispatch_schedule_mirrors_loop_quantization():
    from gym_tpu.data.prefetch import dispatch_schedule as jschedule
    for args in ((0, 10, 4, True), (2, 10, 4, True), (0, 10, 4, False),
                 (0, 0, 4, True), (3, 29, 5, True)):
        assert dispatch_schedule(*args) == jschedule(*args)
    assert dispatch_schedule(0, 10, 4, True) == [4, 4, 1, 1]


@pytest.mark.parametrize("spc,max_steps", [(1, 5), (3, 7)])
def test_prefetch_bit_identical_to_sync(tmp_path, spc, max_steps):
    """Same seed, the same loss history, prefetcher on or off ((3, 7) runs
    the remainder's single steps)."""
    kw = dict(checkpoint_interval=None, save_dir=None,
              steps_per_call=spc)
    on = _fit(tmp_path, max_steps, "on", prefetch=True, **kw)
    off = _fit(tmp_path, max_steps, "off", prefetch=False, **kw)
    assert on.history["train_loss"] == off.history["train_loss"]
    assert _train_csv(tmp_path, "on") == _train_csv(tmp_path, "off")


def _iterator(k=2, poison_after=None):
    ds = ContiguousGPTTrainDataset(_tokens(), T)
    if poison_after is not None:
        inner, calls = ds, [0]

        class Poison:
            def __len__(self):
                return len(inner)

            def take(self, idx):
                calls[0] += 1
                if calls[0] > poison_after:
                    raise RuntimeError(f"boom at draw {poison_after + 1}")
                return inner.take(idx)
        ds = Poison()
    dsets, sharded = resolve_node_datasets(ds, k, is_val=False)
    return NodeBatchIterator(dsets, k, sharded=sharded, shuffle=True, seed=0)


def test_prefetch_consumed_state_is_the_sync_position():
    """The position a checkpoint records is the consumed batches', not the
    worker's read-ahead; and on the CPU no two batches share memory."""
    sched = dispatch_schedule(0, 6, 2, True)
    pf = HostPrefetcher(_iterator(), "cpu", sched, n_micro=1,
                        micro_bs=2).start()
    sync = _iterator()
    got = []
    try:
        for s in sched:
            batch = pf.get()
            want = [sync.next_batch(1, 2) for _ in range(s)]
            want = (np.stack([w[0] for w in want], axis=1) if s > 1
                    else want[0][0])
            assert np.array_equal(batch[0].numpy(), want)
            assert pf.consumed_state() == sync.state()
            got.append(batch[0])
    finally:
        pf.close()
    ptrs = {t.data_ptr() for t in got}
    assert len(ptrs) == len(got)


def test_prefetch_worker_error_propagates_and_shuts_down():
    before = threading.active_count()
    pf = HostPrefetcher(_iterator(poison_after=3), "cpu",
                        dispatch_schedule(0, 8, 1, False), n_micro=1,
                        micro_bs=2).start()
    with pytest.raises(RuntimeError, match="boom at draw 4"):
        for _ in range(8):
            pf.get()
    pf.close()
    pf.close()  # idempotent
    assert threading.active_count() == before
    with pytest.raises(PrefetchError, match="exhausted"):
        empty = HostPrefetcher(_iterator(), "cpu", [], n_micro=1,
                               micro_bs=2).start()
        try:
            empty.get()
        finally:
            empty.close()


def test_checkpoint_resume_mid_epoch_with_prefetch(tmp_path):
    """With the prefetcher reading ahead, a resume from a mid-run
    checkpoint replays the uninterrupted run, under DiLoCo with AdamW."""
    def diloco():
        return DiLoCoStrategy(OptimSpec("adamw", lr=1e-2), H=2)
    _fit(tmp_path / "s", 7, strategy=diloco(), prefetch=True)
    _fit(tmp_path, 5, strategy=diloco(), prefetch=True)  # saves 3 and 5
    res = _fit(tmp_path, 7, strategy=diloco(), prefetch=True)
    assert res.history["train_loss"][0][0] == 5
    assert _train_csv(tmp_path) == _train_csv(tmp_path / "s")


# -- the chaos campaign's machinery (the copied chaos.py) -------------------


def test_chaos_schedules_equal_the_jax_package():
    """The copy draws the same schedules for the same seeds, and names the
    same sites, actions and typed errors."""
    assert chaos.TRAIN_SITE_ACTIONS == jchaos.TRAIN_SITE_ACTIONS
    assert chaos.TYPED_ERRORS == jchaos.TYPED_ERRORS
    for seed in range(20):
        assert chaos.faults_spec(chaos.sample_schedule(seed)) == \
            jchaos.faults_spec(jchaos.sample_schedule(seed))


def test_sample_schedule_deterministic_and_well_formed():
    for seed in range(20):
        a = chaos.sample_schedule(seed)
        assert a == chaos.sample_schedule(seed)
        assert 1 <= len(a) <= 3
        for ev in a:
            assert ev.action in chaos.TRAIN_SITE_ACTIONS[ev.site]
            assert ev.last == ev.first >= 1
            if ev.site == "dispatch.state":
                assert ev.first >= chaos.GUARD_SAFE_FIRST_HIT
    assert len({chaos.faults_spec(chaos.sample_schedule(s))
                for s in range(20)}) > 5


def test_sampled_specs_parse_into_fault_registry():
    for seed in range(30):
        spec = chaos.faults_spec(chaos.sample_schedule(seed))
        reg = FaultRegistry()
        reg.configure(spec)
        assert len(reg._rules) == len(chaos.sample_schedule(seed))


def test_event_spec_grammar():
    ev = chaos.ChaosEvent
    assert ev("dispatch.boundary", "kill", first=3,
              last=3).spec() == "dispatch.boundary:kill@3"
    assert ev("prefetch.fill", "delay", arg=0.05, first=2,
              last=2).spec() == "prefetch.fill:delay=0.05@2"
    assert ev("wire.frame", "bitflip", arg=1.0,
              first=4).spec() == "wire.frame:bitflip=1@4+"
    assert ev("checkpoint.write", "oserror", first=2,
              last=4).spec() == "checkpoint.write:oserror@2-4"


def test_classify_exit_and_watchdog_code():
    assert chaos.classify_exit(0) == "clean"
    assert chaos.classify_exit(-9) == chaos.classify_exit(137) == "killed"
    assert chaos.classify_exit(-15) == "sigterm"
    assert chaos.classify_exit(chaos.WATCHDOG_EXIT_CODE) == "watchdog"
    assert chaos.classify_exit(1, "x\nCheckpointWriteError: y") == \
        "typed:CheckpointWriteError"
    assert chaos.classify_exit(1, "KeyError: 'oops'") == "unclassified"
    assert chaos.WATCHDOG_EXIT_CODE == Watchdog.EXIT_CODE


def test_campaign_loop_against_stub_launches():
    seen = []

    def launch(spec):
        seen.append(spec)
        if len(seen) == 1:
            return {"returncode": -9, "stderr": "", "completed": False}
        return {"returncode": 0, "stderr": "", "completed": True}

    res = chaos.run_train_campaign(7, launch)
    assert res.ok and res.attempts == ["killed", "clean"]
    assert seen == [chaos.faults_spec(chaos.sample_schedule(7)), ""]

    res = chaos.run_train_campaign(
        1, lambda spec: {"returncode": 1, "stderr": "KeyError: 'oops'",
                         "completed": False}, max_launches=4)
    assert not res.ok and res.attempts == ["unclassified"]

    res = chaos.run_train_campaign(
        3, lambda spec: {"returncode": 0, "stderr": "", "completed": True},
        verify=lambda: ["csv diverged"])
    assert res.completed and res.violations == ["csv diverged"]


def test_snapshot_layout_copies_and_rebases():
    """A snapshot packs a state's tensors into one flat buffer a dtype,
    each view aligned, the same tensor once; moving the buffers (as the
    writer's one copy a buffer to pinned memory does) and rebasing the
    views at the snapshot's offsets gives the state back."""
    from gym_tpu_torch.utils.checkpoint import _Layout, _rebase
    shared = torch.arange(5, dtype=torch.float32)
    s = {"a": torch.randn(3, 7), "b": [shared, shared],
         "i": torch.arange(9), "h": torch.randn(4).bfloat16(),
         "rng": np.arange(3, dtype=np.uint32), "n": 2}
    layout = _Layout(s)
    assert set(dt for _, dt in layout.sizes) == {torch.float32,
                                                torch.int64, torch.bfloat16}
    # 21 + 5 floats, each padded to 16 (64 bytes)
    assert layout.sizes[(torch.device("cpu"), torch.float32)] == 32 + 16
    bufs = {k: torch.empty(n, dtype=k[1]) for k, n in layout.sizes.items()}
    snap = layout.copy_into(s, bufs)
    assert snap["b"][0].data_ptr() == snap["b"][1].data_ptr()
    assert all(v.storage_offset() * v.element_size() % 64 == 0
               for v in (snap["a"], snap["b"][0], snap["i"]))
    moved = {k: b.clone() for k, b in bufs.items()}
    got = _rebase(snap, moved)
    for k in ("a", "i", "h"):
        assert torch.equal(got[k], s[k]) and got[k].dtype == s[k].dtype
        assert got[k].untyped_storage().data_ptr() == \
            moved[(torch.device("cpu"), s[k].dtype)].untyped_storage() \
            .data_ptr()
    assert torch.equal(got["b"][1], shared)
    assert np.array_equal(got["rng"], s["rng"]) and got["n"] == 2
