#!/usr/bin/env python3
"""Compare the compiled kernels of two checkouts of the port, on a machine
with ``nvcc``:

    python3 scripts/sass_diff.py TREE_A TREE_B

Builds each tree's kernel library (into TREE/build/, each in its own
process) and counts, from ``cuobjdump -sass``, each kernel's ``HGMMA``,
``HMMA``, ``FFMA``, ``ATOM``/``RED`` and ALU instructions
(``chip_smoke.sass_counts``). Prints the kernels only one tree has, with
their counts, and every kernel of both whose counts differ; exits non-zero
if any does.
A change that must leave some kernels as they were (a refactor of shared
headers) shows here that their code is the same to the instruction count.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def library(tree: str) -> str:
    """Build TREE's kernels in a process of its own; the library's path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from gym_tpu_torch.ops import _build; print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code, tree], check=True,
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gym_tpu_torch.ops import _build

    a, b = (cs.sass_counts(_build._nvcc(), library(os.path.abspath(t)))
            for t in sys.argv[1:])
    only = {"only_a": {k: a[k] for k in sorted(set(a) - set(b))},
            "only_b": {k: b[k] for k in sorted(set(b) - set(a))}}
    differ = {k: {"a": a[k], "b": b[k]} for k in sorted(set(a) & set(b))
              if a[k] != b[k]}
    print(json.dumps({"kernels_a": len(a), "kernels_b": len(b),
                      "same_in_both": len(set(a) & set(b)) - len(differ),
                      **only, "differ": differ}, indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
