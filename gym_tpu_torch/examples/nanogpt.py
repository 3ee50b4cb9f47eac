"""nanoGPT example of the port (counterpart of ``examples/nanogpt.py``).

The JAX example's flags for what the port has: the ``docs`` corpus (the
docstrings of the checkout's ``gym_tpu/``, read as text, or of
``--docs_root``), the model sizes, ``--dropout``, ``--attn_impl`` (dense or
flash, the hand-written kernels on the card), ``--autocast`` (bf16) and the
strategies base, zero, fedavg, diloco, sparta and diloco_sparta with their
knobs. Flags of a later slice of the port (DeMo, NoLoCo, DynamiQ and the
codecs; cp/tp/ep/pp; MoE; sampling; network simulation) exit naming it.
Runs on the card unless ``--device cpu``.

    python -m gym_tpu_torch.examples.nanogpt --strategy fedavg \\
        --num_nodes 16 --H 100 --block_size 256 --attn_impl flash
    python -m gym_tpu_torch.examples.nanogpt --device cpu --max_steps 2 \\
        --block_size 64 --batch_size 4
"""

from __future__ import annotations

import argparse

from gym_tpu_torch import Trainer
from gym_tpu_torch.data import get_dataset
from gym_tpu_torch.data.offline import DEFAULT_DOC_ROOTS
from gym_tpu_torch.examples import LATER_STRATEGIES, refuse_later
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.strategy import (DiLoCoStrategy, FedAvgStrategy, OptimSpec,
                                    SimpleReduceStrategy, SPARTADiLoCoStrategy,
                                    SPARTAStrategy, ZeroReduceStrategy)

STRATEGIES = ("base", "zero", "fedavg", "diloco", "sparta", "diloco_sparta")
# flag: (value that means "off", what ports it and where it is queued)
LATER_FLAGS = {
    "codec": (None, "the outer-loop codecs (ROADMAP Queue A, item 10)"),
    "cp": (1, "context parallelism (ROADMAP Queue A, item 16)"),
    "tp": (1, "tensor parallelism (ROADMAP Queue A, item 16)"),
    "ep": (1, "expert parallelism (ROADMAP Queue A, item 16)"),
    "pp": (1, "pipeline parallelism (ROADMAP Queue A, item 16)"),
    "n_experts": (0, "mixture-of-experts layers (ROADMAP Queue A, item 16)"),
    "sample": (0, "sampling with the KV-cache decoder (ROADMAP Queue A, "
                  "item 14)"),
    "ckpt": (None, "checkpoints (ROADMAP Queue A, item 12)"),
    "network": (None, "the network simulator (ROADMAP Queue A, item 13)"),
    "wandb_project": (None, "experiment tracking"),
}


def gen_run_name(args) -> str:
    """Run name as the JAX example builds it."""
    parts = [args.dataset, args.model_size, args.strategy,
             f"{args.num_nodes}n", f"bs{args.batch_size}"]
    if args.strategy in ("diloco", "diloco_sparta"):
        parts.append(f"H{args.diloco_interval}")
    if args.strategy in ("sparta", "diloco_sparta"):
        parts.append(f"p{args.p_sparta}")
    if args.participation < 1.0:
        parts.append(f"part{args.participation}")
    return "_".join(str(p) for p in parts)


def create_strategy(args):
    """The JAX example's strategy factory, for the ported strategies."""
    if args.strategy in LATER_STRATEGIES:
        refuse_later(f"--strategy {args.strategy}",
                     LATER_STRATEGIES[args.strategy])
    if (args.participation < 1.0
            and args.strategy not in ("fedavg", "diloco", "sparta",
                                      "diloco_sparta")):
        raise SystemExit(
            f"--participation is not supported by --strategy "
            f"{args.strategy} (fedavg/diloco/sparta/diloco_sparta only)")
    optim = OptimSpec("adamw", lr=args.lr)
    sched = dict(
        lr_scheduler="lambda_cosine",
        lr_scheduler_kwargs={"warmup_steps": args.warmup_steps,
                             "cosine_anneal": args.cosine_anneal},
        max_norm=args.max_norm)
    outer = OptimSpec("sgd", lr=args.outer_lr, nesterov=args.nesterov,
                      momentum=args.outer_momentum)
    if args.strategy == "base":
        return SimpleReduceStrategy(optim_spec=optim, **sched)
    if args.strategy == "zero":
        return ZeroReduceStrategy(optim_spec=optim, **sched)
    if args.strategy == "fedavg":
        return FedAvgStrategy(inner_optim=optim, H=args.H,
                              island_size=args.island_size,
                              participation=args.participation, **sched)
    if args.strategy == "diloco":
        return DiLoCoStrategy(optim_spec=optim, outer_optim_spec=outer,
                              H=args.diloco_interval,
                              participation=args.participation, **sched)
    if args.strategy == "sparta":
        return SPARTAStrategy(inner_optim=optim, p_sparta=args.p_sparta,
                              interval=args.sparta_interval,
                              participation=args.participation, **sched)
    return SPARTADiLoCoStrategy(
        optim_spec=optim, outer_optim_spec=outer, p_sparta=args.p_sparta,
        H=args.diloco_interval, sparta_interval=args.sparta_interval,
        participation=args.participation, **sched)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="docs",
                   choices=["shakespeare", "wikitext", "code", "docs", "owt"],
                   help="docs: offline English (the default here: the "
                        "others need a download, a later slice)")
    p.add_argument("--docs_root", action="append", default=None,
                   help="root of the docs corpus (repeatable; default the "
                        "checkout's gym_tpu/)")
    p.add_argument("--start_pc", type=float, default=0.0)
    p.add_argument("--end_pc", type=float, default=1.0)
    p.add_argument("--block_size", type=int, default=1024)
    p.add_argument("--num_nodes", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="cuda (default: the card) or cpu")
    p.add_argument("--model_size", default="small",
                   choices=["small", "base", "medium", "large", "xl"])
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--minibatch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--max_norm", type=float, default=1.0)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--cosine_anneal", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_size", type=int, default=256)
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--strategy", default="base",
                   choices=STRATEGIES + tuple(LATER_STRATEGIES))
    p.add_argument("--H", type=int, default=1)
    p.add_argument("--island_size", type=int, default=None)
    p.add_argument("--p_sparta", type=float, default=0.005)
    p.add_argument("--sparta_interval", type=int, default=1)
    p.add_argument("--diloco_interval", type=int, default=100)
    p.add_argument("--outer_lr", type=float, default=0.7)
    p.add_argument("--nesterov",
                   type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=True)
    p.add_argument("--outer_momentum", type=float, default=0.9)
    p.add_argument("--participation", type=float, default=1.0)
    p.add_argument("--attn_impl", default="dense",
                   choices=["dense", "flash", "ring"])
    p.add_argument("--autocast", action="store_true",
                   help="bf16 forward pass")
    p.add_argument("--skip_nonfinite", action="store_true")
    # flags of a later slice: given, they exit naming it
    p.add_argument("--codec", default=None,
                   choices=["dense", "int8", "int4", "topk"])
    for name in ("cp", "tp", "ep", "pp", "n_experts", "sample"):
        p.add_argument(f"--{name}", type=int, default=LATER_FLAGS[name][0])
    for name in ("ckpt", "network", "wandb_project"):
        p.add_argument(f"--{name}", default=None)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.codec == "dense":
        args.codec = None  # the identity link
    for name, (off, where) in LATER_FLAGS.items():
        if getattr(args, name) != off:
            refuse_later(f"--{name}", where)
    if args.attn_impl == "ring":
        refuse_later("--attn_impl ring", LATER_FLAGS["cp"][1])
    strategy = create_strategy(args)

    roots = tuple(args.docs_root) if args.docs_root else DEFAULT_DOC_ROOTS
    split = args.end_pc * 0.9
    train, vocab_size = get_dataset(
        args.dataset, args.block_size, start_pc=args.start_pc, end_pc=split,
        roots=roots)
    val, _ = get_dataset(args.dataset, args.block_size, start_pc=split,
                         end_pc=args.end_pc, roots=roots)

    cfg = GPTConfig.gpt2_size_map(args.model_size)
    cfg.vocab_size = int(vocab_size)
    cfg.block_size = args.block_size
    cfg.attn_impl = args.attn_impl
    cfg.dropout = args.dropout
    res = Trainer(GPT(cfg), train, val).fit(
        num_epochs=args.num_epochs,
        max_steps=args.max_steps,
        strategy=strategy,
        num_nodes=args.num_nodes,
        device=args.device,
        batch_size=args.batch_size,
        minibatch_size=args.minibatch_size,
        skip_nonfinite=args.skip_nonfinite,
        autocast=args.autocast,
        seed=args.seed,
        val_size=args.val_size,
        val_interval=args.val_interval,
        run_name=gen_run_name(args),
    )
    print(f"final train loss {res.final_train_loss:.4f} "
          f"({res.steps_per_second:.2f} it/s)")
    return res


if __name__ == "__main__":
    main()
