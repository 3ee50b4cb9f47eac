"""Command-line examples of the port: ``python -m
gym_tpu_torch.examples.mnist`` and ``python -m
gym_tpu_torch.examples.nanogpt`` (the counterparts of ``examples/``)."""

# strategies of a later slice of the port: name -> where they are queued
LATER_STRATEGIES = {
    "demo": "DeMo (ROADMAP Queue A, item 10)",
    "demo_outer": "decoupled outer momentum (ROADMAP Queue A, item 10)",
    "noloco": "NoLoCo (ROADMAP Queue A, item 10)",
    "dynamiq": "DynamiQ (ROADMAP Queue A, item 10)",
}


def refuse_later(what: str, where: str) -> None:
    raise SystemExit(f"{what} is ported in a later slice of gym_tpu_torch: "
                     f"{where}")
