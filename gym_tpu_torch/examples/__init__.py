"""Command-line examples of the port: ``python -m
gym_tpu_torch.examples.mnist`` and ``python -m
gym_tpu_torch.examples.nanogpt`` (the counterparts of ``examples/``)."""


def refuse_later(what: str, where: str) -> None:
    raise SystemExit(f"{what} is ported in a later slice of gym_tpu_torch: "
                     f"{where}")
