"""MNIST example of the port (counterpart of ``examples/mnist.py``).

Trains the 2-block CNN on K simulated nodes under a sync strategy, on the
real handwritten digits bundled with the port (``data/digits.csv.gz``, the
UCI set as scikit-learn ships it, upscaled to 28×28 and crop-augmented; no
download). Runs on the card unless ``--device cpu``.

    python -m gym_tpu_torch.examples.mnist --strategy sparta --num_nodes 2
    python -m gym_tpu_torch.examples.mnist --device cpu --max_steps 2
"""

from __future__ import annotations

import argparse

from gym_tpu_torch import Trainer
from gym_tpu_torch.data import load_digits_mnist
from gym_tpu_torch.examples import LATER_STRATEGIES, refuse_later
from gym_tpu_torch.models import MnistLossModel
from gym_tpu_torch.strategy import (DiLoCoStrategy, FedAvgStrategy, OptimSpec,
                                    SimpleReduceStrategy, SPARTAStrategy)

STRATEGIES = ("simple_reduce", "sparta", "diloco", "fedavg")


def make_strategy(name: str, lr: float):
    """The example's strategies: Adam with the lambda_cosine warmup of 100
    steps; SPARTA p 0.005; DiLoCo and FedAvg H 100."""
    if name in LATER_STRATEGIES:
        refuse_later(f"--strategy {name}", LATER_STRATEGIES[name])
    optim = OptimSpec("adam", lr=lr)
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 100})
    return {
        "simple_reduce": lambda: SimpleReduceStrategy(optim, **sched),
        "sparta": lambda: SPARTAStrategy(optim, p_sparta=0.005, **sched),
        "diloco": lambda: DiLoCoStrategy(optim, H=100, **sched),
        "fedavg": lambda: FedAvgStrategy(optim, H=100, **sched),
    }[name]()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--strategy", default="sparta",
                   choices=STRATEGIES + tuple(LATER_STRATEGIES))
    p.add_argument("--num_nodes", type=int, default=2)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="cuda (default: the card) or cpu")
    p.add_argument("--wandb_project", default=None)
    args = p.parse_args(argv)
    if args.wandb_project:
        refuse_later("--wandb_project", "experiment tracking")

    strategy = make_strategy(args.strategy, args.lr)
    res = Trainer(MnistLossModel(), load_digits_mnist(True),
                  load_digits_mnist(False)).fit(
        num_epochs=args.num_epochs,
        max_steps=args.max_steps,
        strategy=strategy,
        num_nodes=args.num_nodes,
        device=args.device,
        batch_size=args.batch_size,
        val_size=256,
        val_interval=100,
        run_name=f"mnist_{args.strategy}_{args.num_nodes}n",
    )
    print(f"final train loss {res.final_train_loss:.4f} "
          f"({res.steps_per_second:.2f} it/s)")
    return res


if __name__ == "__main__":
    main()
