"""The port's CLIs, ``python -m gym_tpu_torch.examples.mnist`` and
``python -m gym_tpu_torch.examples.nanogpt``, run end to end on the CPU in a
subprocess (two steps each, from a temporary directory, where they write
their ``logs/`` and ``data/``), under the compression strategies too, sample
after training (``--sample``), train with mixture-of-experts layers
(``--n_experts``), and refuse a flag of a later slice with a message naming
it."""

import csv
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(tmp_path, module, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run(
        [sys.executable, "-m", f"gym_tpu_torch.examples.{module}", *args],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=timeout)


def _train_rows(log_dir):
    (run,) = [p for p in pathlib.Path(log_dir).iterdir() if p.is_dir()]
    with open(run / "train.csv", newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("strategy", ["sparta", "diloco"])
def test_mnist_cli_trains_on_the_digits(tmp_path, strategy):
    proc = _run(tmp_path, "mnist", "--device", "cpu", "--max_steps", "2",
                "--strategy", strategy, "--batch_size", "16")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final train loss" in proc.stdout
    rows = _train_rows(tmp_path / "logs")
    assert [r["step"] for r in rows] == ["0", "1"]
    assert all(0 < float(r["loss"]) < 10 for r in rows)


def test_nanogpt_cli_trains_on_the_docs_corpus(tmp_path):
    """Two FedAvg steps on the docs corpus, priced on the ``wan`` preset
    (``--network``): the simulated totals printed, a sim clock a row."""
    proc = _run(tmp_path, "nanogpt", "--device", "cpu", "--max_steps", "2",
                "--block_size", "64", "--batch_size", "4", "--num_nodes", "2",
                "--strategy", "fedavg", "--H", "2", "--dropout", "0.1",
                "--val_size", "4", "--network", "wan")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final train loss" in proc.stdout
    assert "simulated on wan:" in proc.stdout
    rows = _train_rows(tmp_path / "logs")
    assert len(rows) == 2 and all(float(r["loss"]) > 0 for r in rows)
    assert all(float(r["sim_step_s"]) > 0 for r in rows)
    # the docs stream of the checkout's gym_tpu/, cached under data/
    assert any((tmp_path / "data" / "docs_char").glob("stream_*.npy"))


def test_nanogpt_cli_samples_after_training(tmp_path):
    """``--sample N`` prints N characters of the docs corpus from the node
    mean through ``generate_fast``, clamped to the KV cache."""
    proc = _run(tmp_path, "nanogpt", "--device", "cpu", "--max_steps", "1",
                "--block_size", "32", "--batch_size", "4", "--val_size", "4",
                "--num_nodes", "2", "--sample", "40")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "clamping sample to 31 tokens" in out
    text = out.split("--- sample ---\n", 1)[1]
    assert 0 < len(text.rstrip("\n")) <= 31


@pytest.mark.parametrize("module,args", [
    ("nanogpt", ["--strategy", "demo", "--num_nodes", "4",
                 "--compression_topk", "8", "--compression_chunk", "16"]),
    ("nanogpt", ["--strategy", "dynamiq", "--codec", "int4",
                 "--num_nodes", "2"]),
    ("mnist", ["--strategy", "demo", "--num_nodes", "2"]),
    ("mnist", ["--strategy", "dynamiq", "--num_nodes", "2"])])
def test_compression_strategies_train_from_the_cli(tmp_path, module, args):
    """DeMo and DynamiQ from the CLIs on the CPU, two steps each: int4 on
    nanoGPT, whose run name carries the codec as in JAX, and the MNIST
    example's int8."""
    shape = (["--block_size", "64", "--batch_size", "4", "--val_size", "4"]
             if module == "nanogpt" else ["--batch_size", "16"])
    proc = _run(tmp_path, module, "--device", "cpu", "--max_steps", "2",
                *shape, *args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final train loss" in proc.stdout
    rows = _train_rows(tmp_path / "logs")
    assert len(rows) == 2 and all(0 < float(r["loss"]) < 10 for r in rows)
    if "dynamiq" in args:
        (run,) = (tmp_path / "logs").iterdir()
        assert run.name.endswith("int4" if module == "nanogpt" else "_2n")
        assert float(rows[0]["comm_bytes"]) > 0


@pytest.mark.parametrize("module,args,word", [
    ("nanogpt", ["--pp", "2"], "pipeline"),
    ("nanogpt", ["--tp", "2"], "tensor parallelism"),
    ("nanogpt", ["--wandb_project", "w"], "experiment tracking"),
    ("nanogpt", ["--n_experts", "2"], "mixture-of-experts"),
    ("nanogpt", ["--dataset", "shakespeare", "--device", "cpu"],
     "shakespeare")])
def test_later_slices_exit_naming_them(tmp_path, module, args, word):
    if "--n_experts" in args:
        # mixture of experts is ported: the flag trains two steps on the
        # CPU, and the run is named moe{E}e{k} as in the JAX example
        proc = _run(tmp_path, module, "--device", "cpu", "--max_steps", "2",
                    "--block_size", "64", "--batch_size", "4",
                    "--val_size", "4", *args)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        rows = _train_rows(tmp_path / "logs")
        assert len(rows) == 2 and all(0 < float(r["loss"]) < 10
                                      for r in rows)
        (run,) = (tmp_path / "logs").iterdir()
        assert run.name.endswith("_moe2e2")
        return
    import importlib
    main = importlib.import_module(f"gym_tpu_torch.examples.{module}").main
    with pytest.raises((SystemExit, NotImplementedError),
                       match=f"(?s){word}.*later slice|later slice.*{word}"):
        main(args)
