"""nanoGPT example of the port (counterpart of ``examples/nanogpt.py``).

The JAX example's flags for what the port has: the ``docs`` corpus (the
docstrings of the checkout's ``gym_tpu/``, read as text, or of
``--docs_root``), the model sizes, ``--dropout``, ``--attn_impl`` (dense or
flash, the hand-written kernels on the card), ``--autocast`` (bf16) and the
strategies base, zero, fedavg, diloco, sparta, diloco_sparta, demo,
demo_outer, noloco and dynamiq with their knobs (``--codec`` for diloco,
noloco, demo_outer and dynamiq; ``--compression_*`` for demo) and
``--sample N`` (after training, N tokens from the node-averaged model
through ``generate_fast``); ``--ckpt RUN_DIR`` samples from a fit's run
dir instead of training (a missing or wholly corrupt one is a one-line
exit); ``--no_prefetch`` and ``--sync_checkpoint`` select the serial
paths; ``--network PRESET`` (and ``--network_overlap``) prices the
strategy's collective trace on a topology and prints the simulated
totals. Flags of a later slice of the port (cp/tp/ep/pp; MoE; experiment
tracking) exit naming it. Runs on the card unless ``--device cpu``.

    python -m gym_tpu_torch.examples.nanogpt --strategy demo \\
        --num_nodes 64 --lr 1e-3 --block_size 256 --attn_impl flash
    python -m gym_tpu_torch.examples.nanogpt --device cpu --max_steps 2 \\
        --block_size 64 --batch_size 4 --strategy dynamiq --codec int4
"""

from __future__ import annotations

import argparse

import numpy as np

from gym_tpu_torch import Trainer
from gym_tpu_torch.data import get_dataset
from gym_tpu_torch.data.offline import DEFAULT_DOC_ROOTS
from gym_tpu_torch.examples import refuse_later
from gym_tpu_torch.convert import serving_params
from gym_tpu_torch.data.build_dataset import CHAR_VOCAB
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig, generate_fast
from gym_tpu_torch.strategy import (DecoupledMomentumStrategy, DeMoStrategy,
                                    DiLoCoStrategy, DynamiQStrategy,
                                    FedAvgStrategy, NoLoCoStrategy, OptimSpec,
                                    SimpleReduceStrategy, SPARTADiLoCoStrategy,
                                    SPARTAStrategy, ZeroReduceStrategy)
from gym_tpu_torch.serve.load import load_for_serving
from gym_tpu_torch.utils.checkpoint import CheckpointNotFoundError

STRATEGIES = ("base", "zero", "fedavg", "diloco", "sparta", "diloco_sparta",
              "demo", "noloco", "dynamiq", "demo_outer")
# flag: (value that means "off", what ports it and where it is queued)
LATER_FLAGS = {
    "cp": (1, "context parallelism (ROADMAP Queue A, item 16)"),
    "tp": (1, "tensor parallelism (ROADMAP Queue A, item 16)"),
    "ep": (1, "expert parallelism (ROADMAP Queue A, item 16)"),
    "pp": (1, "pipeline parallelism (ROADMAP Queue A, item 16)"),
    "n_experts": (0, "mixture-of-experts layers (ROADMAP Queue A, item 16)"),
    "wandb_project": (None, "experiment tracking"),
}


def gen_run_name(args) -> str:
    """Run name as the JAX example builds it."""
    parts = [args.dataset, args.model_size, args.strategy,
             f"{args.num_nodes}n", f"bs{args.batch_size}"]
    if args.strategy in ("diloco", "diloco_sparta", "noloco",
                         "demo_outer"):
        parts.append(f"H{args.diloco_interval}")
    if args.strategy in ("sparta", "diloco_sparta"):
        parts.append(f"p{args.p_sparta}")
    if args.strategy == "dynamiq":
        parts.append(args.codec or "int8")
    elif args.strategy == "demo_outer":
        # the default link is top-k: the default run and --codec topk share
        # a run name
        codec = args.codec or "topk"
        if codec != "dense":
            parts.append(codec)
    elif (args.strategy in ("diloco", "noloco")
            and args.codec not in (None, "dense")):
        parts.append(args.codec)
    if args.participation < 1.0:
        parts.append(f"part{args.participation}")
    return "_".join(str(p) for p in parts)


def create_strategy(args):
    """The JAX example's strategy factory."""
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
    # the link's codec, shared by diloco, noloco and demo_outer; "dense"
    # (or unset) is the identity link
    link_codec = None if args.codec in (None, "dense") else args.codec
    link_kw = {"frac": args.topk_frac} if link_codec == "topk" else {}
    if args.strategy == "diloco":
        return DiLoCoStrategy(optim_spec=optim, outer_optim_spec=outer,
                              H=args.diloco_interval,
                              participation=args.participation,
                              codec=link_codec, **link_kw, **sched)
    if args.strategy == "sparta":
        return SPARTAStrategy(inner_optim=optim, p_sparta=args.p_sparta,
                              interval=args.sparta_interval,
                              participation=args.participation, **sched)
    if args.strategy == "diloco_sparta":
        return SPARTADiLoCoStrategy(
            optim_spec=optim, outer_optim_spec=outer, p_sparta=args.p_sparta,
            H=args.diloco_interval, sparta_interval=args.sparta_interval,
            participation=args.participation, **sched)
    if args.strategy == "demo":
        return DeMoStrategy(
            optim_spec=OptimSpec("sgd", lr=args.lr),
            compression_decay=args.compression_decay,
            compression_topk=args.compression_topk,
            compression_chunk=args.compression_chunk,
            weight_decay=args.weight_decay, **sched)
    if args.strategy == "noloco":
        return NoLoCoStrategy(optim_spec=optim, outer_optim_spec=outer,
                              H=args.diloco_interval, codec=link_codec,
                              **link_kw, **sched)
    if args.strategy == "demo_outer":
        # --codec defaults to the DeMo-style top-k extraction
        codec = link_codec or ("topk" if args.codec is None else None)
        ckw = {"frac": args.topk_frac} if codec == "topk" else {}
        return DecoupledMomentumStrategy(
            optim_spec=optim, H=args.diloco_interval,
            outer_lr=args.outer_lr, outer_momentum=args.outer_momentum,
            codec=codec, **ckw, **sched)
    # dynamiq: DDP's all-reduce with both hops compressed
    if args.codec == "dense":
        raise SystemExit(
            "dynamiq is compressed by definition: --codec dense is plain "
            "DDP; use --strategy base instead")
    codec = args.codec or "int8"
    kw = {"frac": args.topk_frac} if codec == "topk" else {}
    return DynamiQStrategy(optim_spec=optim, codec=codec, **kw, **sched)


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
    p.add_argument("--weight_decay", type=float, default=0.1,
                   help="DeMo's step weight decay")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_size", type=int, default=256)
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--strategy", default="base", choices=STRATEGIES)
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
    p.add_argument("--compression_decay", type=float, default=0.999)
    p.add_argument("--compression_topk", type=int, default=32)
    p.add_argument("--compression_chunk", type=int, default=64)
    p.add_argument("--codec", default=None,
                   choices=["dense", "int8", "int4", "topk"],
                   help="outer-loop payload codec: diloco, noloco and "
                        "demo_outer default dense (demo_outer: topk), "
                        "dynamiq int8")
    p.add_argument("--topk_frac", type=float, default=0.01,
                   help="kept fraction for --codec topk")
    p.add_argument("--attn_impl", default="dense",
                   choices=["dense", "flash", "ring"])
    p.add_argument("--autocast", action="store_true",
                   help="bf16 forward pass")
    p.add_argument("--skip_nonfinite", action="store_true")
    # flags of a later slice: given, they exit naming it
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="after training, sample N tokens from the "
                        "node-averaged model (KV-cache decoder); with "
                        "--ckpt, sample from that run dir instead of "
                        "training")
    p.add_argument("--ckpt", default=None, metavar="RUN_DIR",
                   help="skip training: params-only restore from this "
                        "checkpoint run dir (fit save_dir/<run_name>) "
                        "and --sample from it")
    p.add_argument("--no_prefetch", action="store_true",
                   help="assemble and copy every batch on the dispatch "
                        "path (the prefetcher off)")
    p.add_argument("--sync_checkpoint", action="store_true",
                   help="blocking checkpoint saves instead of the "
                        "writer thread")
    for name in ("cp", "tp", "ep", "pp", "n_experts"):
        p.add_argument(f"--{name}", type=int, default=LATER_FLAGS[name][0])
    p.add_argument("--wandb_project", default=None)
    # the network simulation: the strategy's collective trace priced on a
    # topology preset, sim_step_s in train.csv and the run's totals
    p.add_argument("--network", default=None, metavar="PRESET",
                   help="simulate this network topology (datacenter, wan, "
                        "federated) — logs simulated per-step and total "
                        "wall-clock alongside comm_bytes")
    p.add_argument("--network_overlap", action="store_true",
                   help="model perfect compute/comm overlap in the "
                        "network simulation (default: comm serializes)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    for name, (off, where) in LATER_FLAGS.items():
        if getattr(args, name) != off:
            refuse_later(f"--{name}", where)
    if args.attn_impl == "ring":
        refuse_later("--attn_impl ring", LATER_FLAGS["cp"][1])
    if args.ckpt:
        # sampling only: the params-only restore, no optimizer state, no
        # dataset, no training
        try:
            params, cfg, info = load_for_serving(args.ckpt,
                                                 device=args.device)
        except (CheckpointNotFoundError, FileNotFoundError,
                ValueError) as e:
            # ValueError: a non-GPT config.json or a num_nodes / node-axis
            # mismatch, the same one-line contract
            raise SystemExit(f"nanogpt: cannot sample from {args.ckpt}: "
                             f"{e}")
        print(f"restored step {info['step']} "
              f"({info['num_nodes']}-node average) from {args.ckpt}")
        print_sample(params, cfg, cfg.vocab_size, args.sample or 200,
                     args.seed)
        return None
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
        prefetch=not args.no_prefetch,
        async_checkpoint=not args.sync_checkpoint,
        network=args.network,
        network_overlap=args.network_overlap,
        seed=args.seed,
        val_size=args.val_size,
        val_interval=args.val_interval,
        run_name=gen_run_name(args),
    )
    print(f"final train loss {res.final_train_loss:.4f} "
          f"({res.steps_per_second:.2f} it/s)")
    if res.sim is not None:
        print(f"simulated on {res.sim['topology']}: "
              f"{res.sim['sim_total_s']:.1f}s total "
              f"({res.sim['sim_comm_s']:.1f}s comm, "
              f"{res.sim['sim_compute_s']:.1f}s compute)")
    if args.sample:
        # the node mean, as FitResult.params holds it
        print_sample(serving_params(res.node_state.params,
                                    device=args.device), cfg,
                     int(vocab_size), args.sample, args.seed)
    return res


def print_sample(params, cfg, vocab_size: int, n: int, seed: int) -> None:
    """Sample ``n`` tokens from token 0 through ``generate_fast``
    (temperature 0.8, top-k 40), clamped to the KV cache, and print them:
    as text for the char-level corpora, token ids otherwise."""
    prompt = np.zeros((1, 1), np.int64)  # start from token 0
    n_new = min(n, cfg.block_size - 1)  # KV-cache capacity
    if n_new < n:
        print(f"(clamping sample to {n_new} tokens — the KV cache "
              f"holds block_size={cfg.block_size})")
    out = generate_fast(params, cfg, prompt, n_new, temperature=0.8,
                        top_k=40, seed=seed)
    toks = out[0, 1:].tolist()
    if int(vocab_size) <= len(CHAR_VOCAB) + 1:  # char-level corpus
        print("--- sample ---")
        print("".join(CHAR_VOCAB[t] if t < len(CHAR_VOCAB) else ""
                      for t in toks))
    else:
        print("--- sample (token ids) ---")
        print(toks)


if __name__ == "__main__":
    main()
