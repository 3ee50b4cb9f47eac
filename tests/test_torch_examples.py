"""The port's CLIs, ``python -m gym_tpu_torch.examples.mnist`` and
``python -m gym_tpu_torch.examples.nanogpt``, run end to end on the CPU in a
subprocess (two steps each, from a temporary directory, where they write
their ``logs/`` and ``data/``), and
refuse a strategy or flag of a later slice with a message naming it."""

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
    proc = _run(tmp_path, "nanogpt", "--device", "cpu", "--max_steps", "2",
                "--block_size", "64", "--batch_size", "4", "--num_nodes", "2",
                "--strategy", "fedavg", "--H", "2", "--dropout", "0.1",
                "--val_size", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final train loss" in proc.stdout
    rows = _train_rows(tmp_path / "logs")
    assert len(rows) == 2 and all(float(r["loss"]) > 0 for r in rows)
    # the docs stream of the checkout's gym_tpu/, cached under data/
    assert any((tmp_path / "data" / "docs_char").glob("stream_*.npy"))


@pytest.mark.parametrize("module,args,word", [
    ("mnist", ["--strategy", "dynamiq"], "DynamiQ"),
    ("nanogpt", ["--strategy", "demo"], "DeMo"),
    ("nanogpt", ["--codec", "int8"], "codec"),
    ("nanogpt", ["--pp", "2"], "pipeline"),
    ("nanogpt", ["--dataset", "shakespeare", "--device", "cpu"],
     "shakespeare")])
def test_later_slices_exit_naming_them(tmp_path, module, args, word):
    import importlib
    main = importlib.import_module(f"gym_tpu_torch.examples.{module}").main
    with pytest.raises((SystemExit, NotImplementedError),
                       match=f"(?s){word}.*later slice|later slice.*{word}"):
        main(args)
