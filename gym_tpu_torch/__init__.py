"""gym_tpu_torch: the PyTorch/CUDA port of gym_tpu for one NVIDIA H100.

K simulated data-parallel nodes train nanoGPT or the MNIST CNN under a
swappable sync strategy through ``Trainer.fit``; every tensor carries the
node dimension first, attention runs through hand-written CUDA kernels for
Hopper (``ops/csrc/fused_attention.cu``, ``ops/csrc/flash_attention.cu``)
and random masks through a hand-written threefry kernel
(``ops/csrc/threefry.cu``). The examples (``python -m
gym_tpu_torch.examples.mnist``, ``...nanogpt``) train on offline data. The
port imports torch and numpy only, never JAX or the ``gym_tpu`` package.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .models.base import LossModel
from .trainer import FitResult, LocalTrainer, Trainer

__all__ = ["Trainer", "LocalTrainer", "FitResult", "LossModel"]
