"""gym_tpu_torch.sim — the network simulator's package (counterpart of
``gym_tpu/sim``). Only ``gridlib`` (the resumable grid-cell machinery the
serving sweep shares, ``servesim/sweep.py``) is here yet; the topologies,
the cost model, the simulator and the training sweeps are ROADMAP item 13.
"""
