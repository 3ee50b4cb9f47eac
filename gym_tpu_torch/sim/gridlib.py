"""Shared resumable-grid machinery for the gym's sweep runners.

Extracted from ``sim/sweep.py`` so the serving-policy sweep
(``servesim/sweep.py``) prices its grid through EXACTLY the same
crash-safe cell protocol the training sweep proved out:

- ``atomic_json`` — tmp-write + fsync + rename; a kill -9 mid-write can
  never leave a torn cell marker.
- ``invalidate_if_stale`` — a per-out-dir workload marker: rerunning
  with a changed workload config wipes the cached cells (and any other
  named state dirs) instead of silently serving stale measurements.
- ``run_cells`` — the resumable loop: each finished cell persists as
  ``<out>/cells/<id>.json``; a rerun of the same command skips cells
  whose marker exists and re-runs only the missing ones.
- ``write_csv`` — union-of-keys row dump (cells cached by an older
  build may lack newer columns).

A copy of ``gym_tpu/sim/gridlib.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Sequence


def atomic_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    if not rows:
        return
    # union of keys, first-row order first: cells cached by an older
    # sweep build may lack newer columns
    cols = list(rows[0].keys())
    for r in rows[1:]:
        cols.extend(k for k in r.keys() if k not in cols)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        w.writerows(rows)


def invalidate_if_stale(out: str, sig: Dict[str, Any],
                        state_dirs: Sequence[str] = ("cells",)) -> bool:
    """Compare the out dir's workload marker against ``sig``; on
    mismatch wipe ``state_dirs`` (cell results plus whatever other
    per-workload state the caller names — checkpoints, logs). A rerun
    with e.g. a different trace or step count must re-measure, not
    silently serve the cached grid. Returns True when state was
    wiped."""
    marker = os.path.join(out, "workload.json")
    stale = False
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                stale = json.load(f) != sig
        except (OSError, ValueError):
            stale = True
    if stale:
        print("workload config changed — discarding cached state "
              f"({', '.join(state_dirs)}) under", out)
        for sub in state_dirs:
            shutil.rmtree(os.path.join(out, sub), ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    atomic_json(marker, sig)
    return stale


def run_cells(out: str, cell_ids: Sequence[str],
              run_one: Callable[[int], Dict[str, Any]],
              log: Callable[..., None] = print) -> List[Dict[str, Any]]:
    """The resumable cell loop: for each ``cell_ids[i]`` either load the
    cached ``<out>/cells/<id>.json`` or call ``run_one(i)`` and persist
    its row atomically. Kill the sweep at any point and rerun the same
    command — finished cells are skipped."""
    cells_dir = os.path.join(out, "cells")
    os.makedirs(cells_dir, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    for i, cid in enumerate(cell_ids):
        cell_path = os.path.join(cells_dir, cid + ".json")
        if os.path.exists(cell_path):
            with open(cell_path) as f:
                rows.append(json.load(f))
            log(f"[{i + 1}/{len(cell_ids)}] {cid}: cached")
            continue
        log(f"[{i + 1}/{len(cell_ids)}] {cid}: running ...", flush=True)
        row = run_one(i)
        atomic_json(cell_path, row)
        rows.append(row)
    return rows
