"""Rank-0 observability: tqdm progress, CSV logs, optional wandb.

Reference (``exogym/logger.py``): base Logger drives a tqdm bar with live
loss/lr postfix; ``CSVLogger`` writes ``logs/<run>/train.csv``,
``validation.csv``, ``config.json``. This port adds the metric the
reference forgot to log: cumulative communicated bytes per node (SURVEY
§5.5 — the whole point of these algorithms). A copy of
``gym_tpu/utils/logger.py``: the same ``train.csv`` and ``validation.csv``
columns, pinned by ``tests/test_torch_isolation.py``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from typing import Any, Dict, Optional

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


class Logger:
    """Progress + train/val loss streams (reference ``logger.py:13-44``)."""

    def __init__(self, max_steps: int, show_progress: bool = True):
        self.max_steps = max_steps
        self.step = 0
        self.cum_comm_bytes = 0.0
        # perf_counter, not time.time: steps_per_second is a DURATION
        # metric and the wall clock steps under NTP
        self._t0 = time.perf_counter()
        self.pbar = (
            tqdm(total=max_steps, dynamic_ncols=True)
            if (show_progress and tqdm is not None)
            else None
        )

    def log_train(self, loss: float, lr: float = 0.0,
                  comm_bytes: float = 0.0,
                  step: Optional[int] = None,
                  sim_step_s: Optional[float] = None) -> None:
        """``step`` pins the record to the step the loss was COMPUTED at
        (the fit loop drains metrics one dispatch late for host overlap,
        so ``self.step`` has already moved on). Required for crash+resume
        CSV stitching: rows are pruned/re-logged by true step.
        ``sim_step_s`` is the network-simulated wall-clock for this step
        (fit(network=...)); None when no network is simulated."""
        self.cum_comm_bytes += comm_bytes
        if self.pbar is not None:
            self.pbar.set_postfix(
                loss=f"{loss:.4f}", lr=f"{lr:.1e}",
                comm=_fmt_bytes(self.cum_comm_bytes),
            )

    def log_loss(self, loss: float, name: str,
                 step: Optional[int] = None) -> None:
        """``step`` pins the record to the step the value was COMPUTED at —
        the fit loop defers eval/correlation host fetches past the next
        dispatch (host-overlap), by which time ``self.step`` has moved on."""
        at = self.step if step is None else step
        if self.pbar is not None:
            self.pbar.write(
                f"step {at}: {name} loss {loss:.4f} "
                f"(ppl {math.exp(min(loss, 20.0)):.2f})"
            )

    def log_event(self, msg: str) -> None:
        """One-off notable event (e.g. non-finite quarantine). Must stay
        visible in headless runs — falls back to stdout when the progress
        bar is off."""
        if self.pbar is not None:
            self.pbar.write(f"step {self.step}: {msg}")
        else:
            print(f"step {self.step}: {msg}")

    def increment_step(self) -> None:
        self.step += 1
        if self.pbar is not None:
            self.pbar.update(1)

    def log_summary(self, summary: Dict[str, Any]) -> None:
        """End-of-run aggregates (it/s, MFU, comm totals)."""
        if self.pbar is not None:
            mfu = summary.get("mfu")
            if mfu is not None:
                self.pbar.write(f"MFU {mfu:.1%}")

    def sync(self) -> None:
        """Make everything logged so far durable (fsync where backed by
        files). The Trainer calls this at every checkpoint boundary so a
        crash after a checkpoint loses no rows the checkpoint covers."""

    def close(self) -> None:
        if self.pbar is not None:
            self.pbar.close()

    @property
    def steps_per_second(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.step / dt if dt > 0 else 0.0


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0:
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}PB"


class CSVLogger(Logger):
    """``logs/<run>/{train.csv,validation.csv,config.json}``
    (reference ``logger.py:134-201``).

    Resume semantics (ISSUE 2 — these files used to be opened ``"w"``,
    so a resumed run erased all prior history): with ``resume_step > 0``
    every row logged BEFORE the restored step is preserved and rows at
    or past it are dropped — the resumed run re-logs them, so after a
    crash+resume the files read exactly as an uninterrupted run's. Rows
    are filtered, not blindly appended, because a ``kill -9`` can leave
    a torn final line and rows past the restore point would duplicate.
    ``sync()`` fsyncs both streams; the Trainer calls it at every
    checkpoint boundary, making every row a checkpoint covers durable.
    """

    _TRAIN_HEADER = ["step", "loss", "lr", "comm_bytes", "cum_comm_bytes"]
    _VAL_HEADER = ["step", "name", "loss", "perplexity"]

    def __init__(self, max_steps: int, run_name: Optional[str] = None,
                 log_dir: str = "logs", config: Optional[Dict] = None,
                 show_progress: bool = True, resume_step: int = 0,
                 resume_cum_comm: Optional[float] = None,
                 sim: bool = False):
        super().__init__(max_steps, show_progress)
        run_name = run_name or f"run_{int(time.time())}"
        self.run_dir = os.path.join(log_dir, run_name)
        os.makedirs(self.run_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump(_jsonable(config), f, indent=2, default=str)
        # network-simulated runs carry an extra per-row column; the
        # header is fixed per run (resume keeps it consistent because
        # fit(network=...) is pinned by the resumed call's arguments)
        self._sim = bool(sim)
        train_header = (self._TRAIN_HEADER + ["sim_step_s"] if self._sim
                        else self._TRAIN_HEADER)
        # both train formats (with/without the sim column) are valid
        # pre-resume rows: a resumed fit that flips network= must not
        # discard the run's whole history over one column
        train_lens = {len(self._TRAIN_HEADER), len(self._TRAIN_HEADER) + 1}
        self._train_f, self._train_w, train_kept = self._open_csv(
            "train.csv", train_header, resume_step, ok_lens=train_lens)
        self._val_f, self._val_w, _ = self._open_csv(
            "validation.csv", self._VAL_HEADER, resume_step)
        # Comm accumulation continues across the resume so the cum column
        # stays continuous (and bit-identical to an uninterrupted run).
        # ``resume_cum_comm`` is the EXACT accumulator saved in the
        # checkpoint's extra metadata (the Trainer passes it through);
        # the last kept CSV row is the fallback, %.0f-rounded, so with
        # fractional per-step comm it can drift where the extra cannot.
        if resume_cum_comm is not None:
            self.cum_comm_bytes = float(resume_cum_comm)
        elif train_kept:
            try:
                self.cum_comm_bytes = float(train_kept[-1][4])
            except (ValueError, IndexError):
                pass

    def _open_csv(self, name: str, header, resume_step: int,
                  ok_lens=None):
        """(Re)open a CSV stream, keeping pre-restore rows on resume.

        A kept row must have a known column count (``ok_lens``; default
        exactly the header's — a torn line from a mid-write crash is a
        strict prefix, so it has fewer fields or an intact step field
        that the ``< resume_step`` filter drops) and a step strictly
        before the restored step. Rows from an alternate known format
        are padded/truncated to the current header, so e.g. a resume
        that toggles the network-sim column cannot discard the run's
        whole history; torn rows stay excluded because every row a
        checkpoint covers was fsynced complete, and anything after the
        last fsync has a step the ``< resume_step`` filter drops.

        The filtered file is rewritten ATOMICALLY (temp + fsync +
        ``os.replace``) and then opened for append: truncating the
        original in place would leave a window where a kill -9 during
        resume initialization destroys the entire prior history — the
        exact event this layer defends against."""
        path = os.path.join(self.run_dir, name)
        ok_lens = ok_lens or {len(header)}
        kept = []
        if resume_step > 0 and os.path.exists(path):
            with open(path, newline="") as f:
                rows = list(csv.reader(f))
            for r in rows[1:]:
                try:
                    if len(r) in ok_lens and int(r[0]) < resume_step:
                        kept.append((r + [""] * len(header))[:len(header)])
                except ValueError:
                    continue  # unparseable (torn) row
        tmp = path + ".tmp"
        with open(tmp, "w", newline="") as tf:
            tw = csv.writer(tf)
            tw.writerow(header)
            tw.writerows(kept)
            tf.flush()
            os.fsync(tf.fileno())
        os.replace(tmp, path)
        f = open(path, "a", newline="")
        w = csv.writer(f)
        return f, w, kept

    def log_train(self, loss, lr=0.0, comm_bytes=0.0, step=None,
                  sim_step_s=None):
        super().log_train(loss, lr, comm_bytes, step, sim_step_s)
        row = [self.step if step is None else step, f"{loss:.6f}",
               f"{lr:.8f}", f"{comm_bytes:.0f}",
               f"{self.cum_comm_bytes:.0f}"]
        if self._sim:
            row.append("" if sim_step_s is None else f"{sim_step_s:.6f}")
        self._train_w.writerow(row)

    def log_loss(self, loss, name, step=None):
        super().log_loss(loss, name, step)
        self._val_w.writerow(
            [self.step if step is None else step, name, f"{loss:.6f}",
             f"{math.exp(min(loss, 20.0)):.4f}"]
        )
        self._val_f.flush()

    def log_summary(self, summary):
        super().log_summary(summary)
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(_jsonable(summary), f, indent=2, default=str)

    def sync(self):
        for f in (self._train_f, self._val_f):
            f.flush()
            os.fsync(f.fileno())

    def close(self):
        super().close()
        self._train_f.close()
        self._val_f.close()


def _jsonable(obj: Any, depth: int = 0) -> Any:
    """Best-effort config serializer (reference ``utils.py:17-99``
    extract_config: depth-guarded, non-serializable values stringified)."""
    if depth > 10:
        return str(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in
                list(obj.items())[:50]}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v, depth + 1) for v in obj[:10]]
    return str(obj)
