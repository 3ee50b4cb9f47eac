"""The port stands alone: ``gym_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the ``gym_tpu`` package nor scikit-learn (absent on the
machine with the card), call no library attention kernel and no
``torch.compile``, and the numpy modules they copy from ``gym_tpu`` stay
pinned to their originals (same batches, same CSV columns, the same offline
text units; the serving scheduler and the fault registry line for line,
the scheduler's imports apart)."""

import ast
import csv
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import gym_tpu.data.build_dataset as jbuild
import gym_tpu.data.gpt_datasets as jds
import gym_tpu.data.offline as joffline
import gym_tpu.data.sampler as jsampler
import gym_tpu.utils.logger as jlogger
import gym_tpu_torch.data.build_dataset as tbuild
import gym_tpu_torch.data.gpt_datasets as tds
import gym_tpu_torch.data.offline as toffline
import gym_tpu_torch.data.sampler as tsampler
import gym_tpu_torch.utils.logger as tlogger

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "gym_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gym_tpu", "sklearn")
# the one module that may name cuDNN: the CNN's convolutions are XLA ops in
# the JAX package, not Pallas kernels, and it turns cuDNN's TF32 off
CUDNN_CONV = PORT / "models" / "mnist_cnn.py"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import gym_tpu_torch\n"
        "for m in pkgutil.walk_packages(gym_tpu_torch.__path__, "
        "'gym_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT / "tests"), env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: {name}"


def test_no_library_attention_or_compile_in_the_port():
    """SDPA, cuDNN attention, torch.compile and PyTorch's grouped GEMM are
    no port of a kernel; only chip_smoke.py may time SDPA and
    ``torch._grouped_mm`` as yardsticks. cuDNN may be named only by the
    CNN, for its convolutions' TF32 flag."""
    for path in sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")):
        text = path.read_text()
        words = ["scaled_dot_product_attention", "torch.compile",
                 "flash_attn", "xformers", "cudnn_attention", "sdpa",
                 "grouped_mm"]
        if path != CUDNN_CONV:
            words.append("cudnn")
        for word in words:
            assert word not in text.lower(), f"{path}: {word}"
    conv = CUDNN_CONV.read_text()
    assert "torch.backends.cudnn.allow_tf32 = False" in conv


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sampler_copy_gives_byte_equal_batches(sharded, shuffle):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 65, 3000).astype(np.uint16)
    k = 3
    if sharded:
        def jf(n, num, is_val):
            return jds.ContiguousGPTTrainDataset(toks[n * 900:(n + 1) * 900],
                                                 16)

        def tf(n, num, is_val):
            return tds.ContiguousGPTTrainDataset(toks[n * 900:(n + 1) * 900],
                                                 16)
        jd, js = jsampler.resolve_node_datasets(jf, k, False)
        td, ts = tsampler.resolve_node_datasets(tf, k, False)
    else:
        jd, js = jsampler.resolve_node_datasets(
            jds.ContiguousGPTTrainDataset(toks, 16), k, False)
        td, ts = tsampler.resolve_node_datasets(
            tds.ContiguousGPTTrainDataset(toks, 16), k, False)
    ji = jsampler.NodeBatchIterator(jd, k, sharded=js, shuffle=shuffle,
                                    seed=4)
    ti = tsampler.NodeBatchIterator(td, k, sharded=ts, shuffle=shuffle,
                                    seed=4)
    for _ in range(60):  # crosses epoch boundaries
        for a, b in zip(ji.next_batch(2, 5), ti.next_batch(2, 5)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ji.state() == ti.state()


def test_noncontiguous_dataset_copy_matches():
    rows = np.random.default_rng(1).integers(0, 100, (50, 17))
    idx = np.array([3, 0, 49, 7])
    for a, b in zip(jds.NonContiguousGPTTrainDataset(rows).take(idx),
                    tds.NonContiguousGPTTrainDataset(rows).take(idx)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_window_gather_raises_out_of_range():
    ds = tds.ContiguousGPTTrainDataset(np.arange(40), 16)
    with pytest.raises(IndexError):
        ds.take(np.array([30]))


def test_logger_copy_writes_the_same_csv(tmp_path):
    assert tlogger.CSVLogger._TRAIN_HEADER == jlogger.CSVLogger._TRAIN_HEADER
    assert tlogger.CSVLogger._VAL_HEADER == jlogger.CSVLogger._VAL_HEADER
    for mod, name in ((jlogger, "j"), (tlogger, "t")):
        lg = mod.CSVLogger(5, name, str(tmp_path), {"a": 1},
                           show_progress=False)
        for step in range(3):
            lg.log_train(4.0 - step * 0.1, 1e-3, 1000.0, step=step)
        lg.log_loss(3.5, "global", step=2)
        lg.close()
    for f in ("train.csv", "validation.csv", "config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    with open(tmp_path / "t" / "train.csv", newline="") as fh:
        assert next(csv.reader(fh)) == ["step", "loss", "lr", "comm_bytes",
                                        "cum_comm_bytes"]


def test_offline_copies_yield_the_same_text_units(tmp_path):
    """``_iter_doc_texts`` over a root with every kind of unit (a short file
    skipped, ``.md`` and ``.rst`` files, a ``.py`` whose docstrings are
    harvested, one that does not parse) gives the same units in the same
    order; the vocabulary is the same."""
    (tmp_path / "b.md").write_text("# Title\n" + "word " * 600)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "a.rst").write_text("Heading\n=======\n" +
                                            "text, " * 500)
    (tmp_path / "short.md").write_text("too short")
    doc = "A docstring long enough to be harvested. " * 4
    (tmp_path / "m.py").write_text(
        f'"""{doc}"""\n\n\ndef f():\n    """{doc}"""\n' + "#" * 2100)
    (tmp_path / "bad.py").write_text("def (:\n" + "#" * 2100)
    roots = (str(tmp_path),)
    want = list(joffline._iter_doc_texts(roots, 64))
    assert list(toffline._iter_doc_texts(roots, 64)) == want
    assert len(want) == 3
    assert tbuild.CHAR_VOCAB == jbuild.CHAR_VOCAB
    assert tbuild.char_vocab_size() == jbuild.char_vocab_size()


def _non_import_lines(path):
    return [line for line in path.read_text().splitlines()
            if not line.startswith(("from ", "import "))]


def test_serving_copies_pinned_to_their_originals():
    """``utils/resilience.py`` is a byte copy; ``serve/scheduler.py`` equals
    its original line for line but for its import lines (which name the
    port's engine and resilience) and one comment, whose closing words
    name the reference's history and are reworded in the copy."""
    for rel in ("utils/resilience.py",):
        assert (PORT / rel).read_bytes() == \
            (ROOT / "gym_tpu" / rel).read_bytes(), rel
    port = PORT / "serve" / "scheduler.py"
    got = _non_import_lines(port)
    want = _non_import_lines(ROOT / "gym_tpu" / "serve" / "scheduler.py")
    assert len(got) == len(want)
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(differ) == 1
    stem = "        # present → the first prefix_window requests (the "
    assert got[differ[0]] == stem + "prefix window)"
    assert want[differ[0]].startswith(stem)
    imports = [ln for ln in port.read_text().splitlines()
               if ln.startswith(("from ", "import "))]
    assert "from .engine import InferenceEngine, NoFreeBlocksError, " \
        "SamplingParams" in imports


def test_serve_package_is_walked_and_standalone():
    """The isolation walk reaches ``gym_tpu_torch.serve``; it exports only
    what exists in the port."""
    import pkgutil
    import gym_tpu_torch
    import gym_tpu_torch.serve as tserve
    names = {m.name for m in pkgutil.walk_packages(gym_tpu_torch.__path__,
                                                   "gym_tpu_torch.")}
    assert {"gym_tpu_torch.serve.engine", "gym_tpu_torch.serve.scheduler",
            "gym_tpu_torch.serve.programs"} <= names
    assert all(hasattr(tserve, n) for n in tserve.__all__)


def _body(path, start, stop=None):
    """The lines of ``path`` from the first starting with ``start`` up to
    the first starting with ``stop`` (or the end), import lines apart."""
    lines = path.read_text().splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.startswith(start))
    j = (next(n for n, ln in enumerate(lines) if n > i
              and ln.startswith(stop)) if stop else len(lines))
    while not lines[j - 1].strip():
        j -= 1
    return [ln for ln in lines[i:j]
            if not ln.startswith(("from ", "import "))]


def test_checkpoint_layer_copies_pinned_to_their_originals():
    """``utils/chaos.py`` equals its original line for line after its
    module docstring (the port's own). ``utils/integrity.py``'s stdlib
    part (crc32c, ``checksum_file``, the errors, the sidecars,
    ``corrupt_checkpoint_files``) and its guard (``Guard``,
    ``GuardRuntime``, ``_InnerGuard``) equal the original's line for line,
    imports apart, but for two docstring lines that named the JAX
    package's store and history; the tree functions between them are the
    port's torch versions, and the C ``crc32c`` replaces the Python one
    only after the copy."""
    jdir, tdir = ROOT / "gym_tpu" / "utils", PORT / "utils"
    assert _body(tdir / "chaos.py", "from __future__") == \
        _body(jdir / "chaos.py", "from __future__")
    for start, stop in (("from __future__", "# -- tree fingerprints"),
                        ("# -- training guard", "# -- crc32c in C")):
        got = _body(tdir / "integrity.py", start, stop)
        want = _body(jdir / "integrity.py", start,
                     stop if stop != "# -- crc32c in C" else None)
        assert len(got) == len(want) > 60
        differ = [(a, b) for a, b in zip(got, want) if a != b]
        if start == "# -- training guard":
            assert differ == []
            continue
        assert [a for a, _ in differ] == [
            "    right after the step's files are written; the sidecar "
            "travels with the",
            "    verified, False when no sidecar exists (a sidecar-less "
            "checkpoint:"]
        assert "Orbax save finalizes" in differ[0][1]
        assert differ[1][1].startswith(
            "    verified, False when no sidecar exists (pre-")


def test_checkpoint_layer_modules_are_scanned():
    """The forbidden-import scan and the import walk reach every module of
    the checkpoint layer."""
    import pkgutil
    import gym_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(gym_tpu_torch.__path__,
                                                   "gym_tpu_torch.")}
    mods = {"utils.checkpoint", "utils.integrity", "utils.chaos",
            "data.prefetch", "serve.load"}
    assert {f"gym_tpu_torch.{m}" for m in mods} <= names
    scanned = {str(p.relative_to(PORT)) for p in _port_sources()
               if PORT in p.parents}
    assert {m.replace(".", "/") + ".py" for m in mods} <= scanned
