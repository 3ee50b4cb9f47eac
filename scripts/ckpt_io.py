#!/usr/bin/env python3
"""The disk and copy rates a checkpoint of the port rests on, on the
machine with the card: ``torch.save`` of a 2 GiB f32 tensor into the
checkout's ``build/``, its fsync, ``utils/integrity.checksum_file`` of it
(the C crc32c where the kernel library is built), ``torch.load`` with
``weights_only=True``, the copy to the card from pageable memory and back
into pinned memory. Prints one line each and the card's name and power
limit.

    python3 scripts/ckpt_io.py
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    sys.path.insert(0, ROOT)
    from gym_tpu_torch.ops import _build
    from gym_tpu_torch.utils import integrity
    if not torch.cuda.is_available():
        print("ckpt_io: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(f"crc32c on the crc32 instruction: {_build.load().gym_crc32c_hw()}")
    d = os.path.join(ROOT, "build", "ckpt_io")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "s.pt")
    x = {"a": torch.randn(512 * 1024 * 1024)}  # 2 GiB of f32
    try:
        t0 = time.perf_counter()
        torch.save(x, path)
        t1 = time.perf_counter()
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        t2 = time.perf_counter()
        print(f"torch.save 2 GiB {t1 - t0:.2f} s, fsync {t2 - t1:.2f} s")
        t0 = time.perf_counter()
        integrity.checksum_file(path)
        print(f"checksum_file {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        y = torch.load(path, weights_only=True)
        print(f"torch.load {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        z = y["a"].cuda()
        torch.cuda.synchronize()
        print(f"to the card from pageable memory {time.perf_counter() - t0:.2f} s")
        p = torch.empty(z.shape, pin_memory=True)
        t0 = time.perf_counter()
        p.copy_(z)
        print(f"back into pinned memory {time.perf_counter() - t0:.2f} s")
    finally:
        os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
