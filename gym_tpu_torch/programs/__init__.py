"""gym_tpu_torch.programs — the device-program registry (counterpart of
``gym_tpu.programs``).

One keyed, observable owner of the serving engine's programs: on the card
CUDA graphs, captured once and replayed (``graphs``), on the CPU the same
programs run eagerly. ``registry`` is the single-flight, pinned, LRU store
and its counters, ``warmup`` the background thread that builds an engine's
family before traffic needs it, ``keys`` the canonical program key. The
elastic programs (``gym_tpu/programs/elastic_defs.py``) are ported with
ROADMAP item 13.
"""

from .graphs import StagedProgram
from .keys import program_key
from .registry import (Program, ProgramDef, ProgramOwnerClosedError,
                       ProgramRegistry, default_registry,
                       disk_event_counters, enable_disk_tier,
                       graphs_captured_counter, inflight_programs,
                       use_program_cache_dir, xla_compile_counter)
from .warmup import WarmupThread, warm_engine_programs

__all__ = [
    "program_key", "ProgramDef", "Program", "ProgramRegistry",
    "ProgramOwnerClosedError", "StagedProgram", "default_registry",
    "xla_compile_counter", "graphs_captured_counter",
    "enable_disk_tier", "disk_event_counters", "use_program_cache_dir",
    "inflight_programs", "WarmupThread", "warm_engine_programs",
]
