"""Continuous-batching inference engine (counterpart of
``gym_tpu/serve/engine.py``): one decode program for N slots.

The design is the JAX engine's, with its programs run eagerly by PyTorch
(``serve/programs.py``) on the port's kernels:

- **Decode chunk**: the whole slot batch advances ``decode_chunk`` tokens
  in one call that reads nothing back to the host until its end. Each slot
  is an independent sequence at its own cache position (the model's
  per-row cursors, B7's per-query positions), and the per-slot sampling
  parameters and keys ride in as vectors. Inactive slots compute garbage
  that is never read and their cursors are frozen.
- **Prefill**: one request's prompt, right-padded to its power-of-two
  bucket, fills a single-row cache and samples the first token at the true
  last prompt position; buckets are at most ``⌈log2(block_size)⌉ + 1``.
- **Admit/evict** between chunks: the prefilled row is copied into the slot
  and its cursor rewound to the true prompt length; a finished slot frees
  while its neighbours keep decoding.

Parity: for a single request the engine's token stream is identical to
``generate_fast`` with the same sampling and seed (the shared
``sample_logits``, the ``fold_in(PRNGKey(seed), token_index)`` key
schedule, and a decode forward whose rows never depend on the other rows:
R1, L1 and B7, ``models/nanogpt.py``).

**Paged KV and prefix sharing** (``paged=True``): the cache is a pool of
fixed-size pages addressed through a per-slot block table; a ref-counted
``BlockAllocator`` and an exact-content prefix hash admit a prompt whose
longest block-aligned prefix is resident without prefilling or copying it
again (only the suffix is prefilled; a fully matched final block is copied
on write so its last token can be forwarded again). Every block a request
may write is reserved at admit, so shared pages are full prompt blocks and
the decode never allocates.

**Speculative decoding** (``spec_tokens=γ``): n-gram drafts verified in
one ``γ+1``-token call a step, accepted on the device, rolled back by the
cursor; every position is sampled from the true conditional with the
request's own keys, so streams equal the non-speculative engine's for every
sampling configuration.

**Park/resume**: a paged slot's whole state is host bookkeeping over pinned
pages, so a preempted request resumes byte-identical to an uncontended run.

**Programs, staged and captured.** Every device program of the engine is a
``programs.graphs.StagedProgram`` owned by the process's program registry
(``programs.registry``) under a key that names this engine: its inputs are
staged through one pinned host buffer in one copy, its outputs come back in
one copy, and on the card (``cuda_graphs=True``, the default) it is a CUDA
graph, captured at its first use or by the background warmup over
``warmup_defs`` (the family of the JAX engine: the prefill buckets, the
decode chunk, the spec chunk, the chunk-1 twin, copy-on-write or admit).
A graph holds the addresses of this engine's parameters, caches and
staging buffers, so it belongs to this engine: ``close`` frees them all. A
build takes ``dispatch_lock``, which ``admit`` and ``step`` hold, so a
capture never overlaps this engine's dispatches.

**Quantized serving** (a config's ``weights_dtype`` "int8"/"int4",
``quant_embed``, ``kv_dtype`` "int8"): an f32 tree is quantized at
construction (``load.quantize_params``; a quantized one is taken as it
is), the decode path runs on B6 and B7's int8 form, and the KV pool holds
int8 K and V with f32 scales, so the same page count holds 4× the payload
of an f32 pool in a quarter of its bytes (``kv_pool_bytes``,
``kv_blocks_capacity_effective``). Program names carry the dtypes
(``_qtag``), so an f32 engine and a quantized one never share a graph.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.nanogpt import GPT, GPTConfig, decode_config
from ..ops import threefry
from ..programs import (ProgramDef, ProgramOwnerClosedError, StagedProgram,
                        default_registry)
from ..utils.resilience import fault_point
from . import programs
from .load import params_are_quantized, quantize_params

PyTree = Any

_ENGINE_IDS = itertools.count()


def _qtag(cfg: GPTConfig) -> str:
    """The program-name suffix of a quantized config (the JAX package's
    ``serve_defs._qtag``): empty at f32, else its dtypes, e.g.
    ``",w=int8+emb,kv=int8"``."""
    parts = []
    if cfg.weights_dtype != "f32":
        parts.append(f"w={cfg.weights_dtype}"
                     + ("+emb" if cfg.quant_embed else ""))
    if cfg.kv_dtype != "f32":
        parts.append(f"kv={cfg.kv_dtype}")
    return ("," + ",".join(parts)) if parts else ""


def _release_programs(registry, keys: set) -> None:
    """Drop an engine's registry entries and free the programs built for
    it (graphs, their pools, the staging buffers): at ``close`` or when
    the engine is collected, whichever comes first."""
    for prog in registry.discard(keys):
        prog.close()


class NoFreeSlotError(RuntimeError):
    """``admit()`` was called with every slot occupied — a scheduler bug
    (the driver must check ``free_slots()`` first). Subclasses
    ``RuntimeError`` so pre-existing callers keep working."""


class NoFreeBlocksError(RuntimeError):
    """The paged KV pool cannot currently supply enough blocks for this
    admission. Unlike ``NoFreeSlotError`` this is an EXPECTED transient
    under load (an undersized pool serving long requests): the scheduler
    keeps the request queued and retries once running requests release
    their blocks. ``InferenceEngine.validate`` rejects up front any
    request whose worst-case block need exceeds the whole pool, so a
    queued request always eventually fits."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration — mirrors ``generate_fast``'s
    signature so a request and a ``generate_fast`` call are comparable.
    ``eos_token`` stops the request early (in addition to
    ``max_new_tokens``); ``None`` disables the check."""

    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class ParkedSlot:
    """Host-side snapshot of one preempted slot (paged engines only).
    The block-table REFERENCES move into the snapshot — pages stay
    pinned in the pool at their current refcounts, exactly like the
    slot-owned write blocks the spec-decode rewind masks — so a later
    ``resume`` continues the generation byte-identical to an
    uncontended run: everything a decode dispatch reads about a slot
    (block table, cursors, token history, sampling vectors, the
    ``fold_in(base, gen_idx)`` key schedule) is per-step host input.
    ``released`` marks a consumed snapshot (resumed or dropped)."""

    block_table: np.ndarray
    pos: int
    hist: np.ndarray
    prompt_len: int
    next_tok: int
    gen_idx: int
    generated: int
    max_new: int
    eos: int
    temp: float
    top_k: int
    top_p: float
    base_key: np.ndarray
    released: bool = False


@dataclasses.dataclass
class TokenEvent:
    """One generated token, as seen by the scheduler. ``poisoned`` marks
    a token from a quarantined slot (non-finite logits): the value is
    garbage and the scheduler must fail the request, not deliver it."""

    slot: int
    token: int
    finished: bool
    poisoned: bool = False


@dataclasses.dataclass
class EngineStats:
    tokens_generated: int = 0
    decode_steps: int = 0
    prefills: int = 0
    prefill_compiles: int = 0            # new bucket programs THIS engine hit
    prefill_buckets: Tuple[int, ...] = ()
    prefill_tokens: int = 0              # padded tokens dispatched through
    #                                      prefill — the prefix-sharing
    #                                      work-elision observable
    active_slots: int = 0
    num_slots: int = 0
    quarantined: int = 0                 # slots shut down on NaN/Inf logits
    # paged-KV observables (0 on an unpaged engine)
    kv_blocks_in_use: int = 0            # pages referenced by live slots
    kv_blocks_cached: int = 0            # resident reusable prefix blocks
    prefix_hit_blocks: int = 0           # cumulative blocks served from the
    #                                      prefix cache instead of prefilled
    # speculative-decoding counters (0 with speculation off)
    spec_drafted: int = 0
    spec_accepted: int = 0
    # preemptible-decode counters: slots parked for a more
    # urgent request / parked snapshots resumed into a slot
    preemptions: int = 0
    resumes: int = 0
    # quantized-serving config echo: which dtypes this
    # engine's params and KV pools are stored in — ride on stats so
    # metrics/serve.csv/stats report them without reaching into config
    weights_dtype: str = "f32"
    kv_dtype: str = "f32"

    def spec_accept_rate(self) -> Optional[float]:
        """Accepted / drafted speculative tokens (None before the first
        draft) — the EWMA-priceable acceptance observable."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted


def prompt_bucket(n: int, block_size: int) -> int:
    """Power-of-two prefill bucket for an ``n``-token prompt, capped at
    ``block_size`` — the compile-bound lever: all prompt lengths map to at
    most ``⌈log2(block_size)⌉ + 1`` distinct shapes."""
    if n < 1:
        raise ValueError("empty prompt")
    b = 1 << (n - 1).bit_length()
    return min(b, block_size)


def max_prefill_buckets(block_size: int) -> int:
    """The compile-count bound serving any mix of prompt lengths:
    buckets are {1, 2, 4, ..., 2^⌈log2(block_size)⌉ capped} — at most
    ``⌈log2(block_size)⌉ + 1`` of them."""
    return (block_size - 1).bit_length() + 1


class BlockAllocator:
    """Host-side ref-counted page allocator + prefix hash table for the
    paged KV pool (PagedAttention, arXiv 2309.06180).

    Page ids index the device pools (``[kv_pages, page_size, H, hd]``
    per layer); page 0 is the reserved NULL page — never allocated,
    the write-redirect target for deactivated rows. A page's refcount
    counts ACTIVE slot users; pages holding full, block-aligned PROMPT
    blocks are additionally content-registered in the prefix cache under
    an exact chain key ``(parent_chain_id, block_token_bytes)``. The
    parent id is a monotonically increasing content id — never a page
    id — so a recycled page can never falsely revalidate a stale child
    entry. A cached page at refcount 0 stays RESIDENT (that is the
    point: the next request with the same prefix reuses it copy-free)
    and is evicted LRU only when the free list runs dry.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"kv_pages must be >= 2 (null page + one real page), "
                f"got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = list(range(num_pages - 1, 0, -1))   # pop() → low ids
        self._ref: Dict[int, int] = {}
        # chain key → (page, content id); insertion order is LRU order
        # (lookup hits refresh recency)
        from collections import OrderedDict
        self._cache: "OrderedDict[Tuple[int, bytes], Tuple[int, int]]" = \
            OrderedDict()
        self._key_of: Dict[int, Tuple[int, bytes]] = {}
        self._cid = 0

    # -- observables ------------------------------------------------------

    def in_use(self) -> int:
        return sum(1 for r in self._ref.values() if r > 0)

    def cached(self) -> int:
        return len(self._cache)

    def available(self, exclude=()) -> int:
        """Pages an ``alloc`` burst could obtain right now: the free list
        plus evictable (refcount-0 cached) pages. ``exclude`` treats the
        given pages as unavailable — a planned admission must not count
        the very prefix blocks it is about to pin as evictable slack."""
        ex = set(exclude)
        n = len(self._free)
        for _key, (pg, _cid) in self._cache.items():
            if self._ref.get(pg, 0) == 0 and pg not in ex:
                n += 1
        return n

    # -- allocation -------------------------------------------------------

    def alloc(self) -> int:
        """Allocate a page at refcount 1, evicting the LRU refcount-0
        cached page when the free list is empty."""
        if self._free:
            pg = self._free.pop()
        else:
            pg = self._evict_one()
        self._ref[pg] = 1
        return pg

    def _evict_one(self) -> int:
        for key, (pg, _cid) in self._cache.items():      # oldest first
            if self._ref.get(pg, 0) == 0:
                del self._cache[key]
                del self._key_of[pg]
                self._ref.pop(pg, None)
                return pg
        raise NoFreeBlocksError(
            f"paged KV pool exhausted: all {self.num_pages - 1} pages "
            f"are referenced by running requests")

    def incref(self, page: int) -> None:
        self._ref[page] = self._ref.get(page, 0) + 1

    def decref(self, page: int) -> None:
        r = self._ref.get(page, 0) - 1
        if r < 0:
            raise ValueError(f"page {page} double-freed")
        self._ref[page] = r
        if r == 0 and page not in self._key_of:
            # plain owned page → straight back to the free list; cached
            # pages stay resident (evictable) for future prefix hits
            self._ref.pop(page)
            self._free.append(page)

    # -- prefix cache -----------------------------------------------------

    def lookup(self, parent_cid: int, block: bytes):
        """Resident ``(page, cid)`` for this chain link, or None. A hit
        refreshes the entry's LRU recency."""
        key = (parent_cid, block)
        ent = self._cache.get(key)
        if ent is not None:
            self._cache.move_to_end(key)
        return ent

    def touch(self, page: int) -> None:
        """Refresh a cached page's LRU recency by page id — admission
        commits touch their hit pages so a hot prefix is not the
        eviction victim just because planning probes never counted."""
        key = self._key_of.get(page)
        if key is not None:
            self._cache.move_to_end(key)

    def probe(self, parent_cid: int, block: bytes):
        """``lookup`` without the LRU touch — for capacity planning and
        scheduler ordering probes that may never admit."""
        return self._cache.get((parent_cid, block))

    def register(self, parent_cid: int, block: bytes, page: int) -> int:
        """Content-register an owned full prompt block; returns the chain
        id for the NEXT block's parent. If the key is already cached the
        existing entry wins (its cid is returned and our page stays a
        plain owned page) — chains dedupe onto the canonical lineage."""
        key = (parent_cid, block)
        ent = self._cache.get(key)
        if ent is not None:
            return ent[1]
        self._cid += 1
        self._cache[key] = (page, self._cid)
        self._key_of[page] = key
        return self._cid


class InferenceEngine:
    """Slot-level mechanics: caches, prefill, the shared decode step.

    Request-level concerns (queueing, backpressure, completion futures)
    live in ``scheduler.Scheduler``; the engine only knows slots. Not
    thread-safe — one driver thread calls ``admit``/``step``/``release``
    (the scheduler serializes access).
    """

    def __init__(self, params: Dict[str, torch.Tensor], config: GPTConfig,
                 num_slots: int = 8, decode_chunk: int = 1,
                 paged: bool = False, page_size: int = 16,
                 kv_pages: Optional[int] = None, spec_tokens: int = 0,
                 weights_tag: Optional[str] = None, device="cuda",
                 cuda_graphs: bool = True, registry=None):
        """``params``: one model's flat parameters (``convert.
        serving_params`` or ``serving_params_from_jax``), moved to
        ``device`` (the card unless the caller says otherwise): f32, or
        already quantized (``load.quantize_params``); an f32 tree under a
        quantized ``config`` is quantized here.

        ``decode_chunk``: decode steps a call (on-device EOS and max-token
        bookkeeping); 1 admits and evicts after every token, larger chunks
        spend fewer host round trips at the cost of slot turnaround.

        ``paged=True``: the KV cache is a page pool (``kv_pages`` pages of
        ``page_size`` tokens; default 1 null page + one full window a slot
        + one copy-on-write page) with per-slot block tables, a ref-counted
        allocator and a prefix hash table. ``spec_tokens=γ > 0`` (paged
        only) adds self-drafting speculative decoding with streams equal
        to the non-speculative engine's. ``weights_tag`` names the
        parameter set served (observability only).

        ``cuda_graphs``: on the card, run each program as a CUDA graph
        (False runs the same staged programs eagerly, for comparison);
        ignored on the CPU. ``registry``: the program registry (the
        process's by default)."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {decode_chunk}")
        if spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {spec_tokens}")
        if spec_tokens and not paged:
            raise ValueError(
                "speculative decoding rides on the paged KV path — pass "
                "paged=True (the rollback contract needs slot-owned "
                "write blocks)")
        self.paged = bool(paged)
        self.spec_tokens = int(spec_tokens)
        self.weights_tag = weights_tag
        self.weights_dtype = str(getattr(config, "weights_dtype", "f32"))
        self.kv_dtype = str(getattr(config, "kv_dtype", "f32"))
        if self.weights_dtype not in ("f32", "int8", "int4"):
            raise ValueError(
                f"weights_dtype must be 'f32', 'int8' or 'int4', got "
                f"{self.weights_dtype!r}")
        if self.kv_dtype not in ("f32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32' or 'int8', got "
                f"{self.kv_dtype!r}")
        self.device = torch.device(device)
        base_cfg = decode_config(config)
        self.block_size = int(config.block_size)
        self.num_slots = int(num_slots)
        self.decode_chunk = int(decode_chunk)
        if self.paged:
            if page_size < 1 or self.block_size % page_size:
                raise ValueError(
                    f"page_size must be >= 1 and divide block_size "
                    f"{self.block_size}, got {page_size}")
            self.page_size = int(page_size)
            self.max_blocks = self.block_size // self.page_size
            if kv_pages is None:
                # null page + one full window per slot + one page of
                # copy-on-write headroom
                kv_pages = 2 + self.num_slots * self.max_blocks
            if kv_pages < 2 + self.max_blocks:
                raise ValueError(
                    f"kv_pages={kv_pages} too small: need the null page "
                    f"+ one full window ({self.max_blocks} blocks) + one "
                    f"copy-on-write page")
            self.kv_pages = int(kv_pages)
            self.config = dataclasses.replace(
                base_cfg, page_size=self.page_size, kv_pages=self.kv_pages)
            self._alloc = BlockAllocator(self.kv_pages, self.page_size)
        else:
            self.page_size = 0
            self.max_blocks = 0
            self.kv_pages = 0
            self.config = base_cfg
            self._alloc = None
        self._model = GPT(self.config)
        if self.weights_dtype != "f32" and not params_are_quantized(params):
            params = quantize_params(
                {n: torch.as_tensor(p) for n, p in params.items()},
                self.config)

        def placed(p):
            p = torch.as_tensor(p)
            dtype = torch.float32 if p.is_floating_point() else p.dtype
            return p.to(self.device, dtype).contiguous()

        self.params = {n: placed(p) for n, p in params.items()}
        self.weights_bytes = int(sum(p.numel() * p.element_size()
                                     for p in self.params.values()))
        s = self.num_slots
        self.uid = next(_ENGINE_IDS)
        self.capture = bool(cuda_graphs) and self.device.type == "cuda"
        self._registry = (registry if registry is not None
                          else default_registry())
        self.dispatch_lock = threading.RLock()
        self.closed = False
        self._handles: Dict[Tuple[str, int], Any] = {}
        self._def_keys: set = set()
        # the registry's entries reach this engine only weakly (their
        # builders), so an engine dropped without close frees its
        # programs too
        self._release = weakref.finalize(self, _release_programs,
                                         self._registry, self._def_keys)
        self._seen_buckets: set = set()
        self._cache = self._model.init_cache(s, self.device)
        # unpaged: the prefill's single-row cache, admitted into a slot
        self._row_cache = (None if self.paged
                           else self._model.init_cache(1, self.device))
        if self.paged:
            self._bt = np.zeros((s, self.max_blocks), np.int32)
            self._pos = np.zeros(s, np.int32)          # per-slot KV cursor
            self._hist = np.zeros((s, self.block_size), np.int32)
            self._prompt_len = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._next_tok = np.zeros(s, np.int32)     # input token per slot
        self._gen_idx = np.zeros(s, np.int32)      # key-schedule index
        self._generated = np.zeros(s, np.int64)    # tokens emitted so far
        self._max_new = np.zeros(s, np.int64)
        self._eos = np.full(s, -1, np.int64)       # -1 = disabled
        self._temp = np.ones(s, np.float32)
        self._top_k = np.full(s, self.config.vocab_size, np.int32)
        self._top_p = np.ones(s, np.float32)
        self._base_keys = np.zeros((s, 2), np.uint32)
        self.stats = EngineStats(num_slots=s,
                                 weights_dtype=self.weights_dtype,
                                 kv_dtype=self.kv_dtype)
        self.last_logits: Optional[np.ndarray] = None  # [S, V] post-step

    # -- quantized-serving observables ------------------------------------

    @property
    def kv_elem_bytes(self) -> int:
        """Bytes of one stored K/V element: 1 under int8, 4 under f32."""
        return 1 if self.kv_dtype == "int8" else 4

    @property
    def kv_blocks_capacity_effective(self) -> int:
        """Usable blocks at the f32 pool's payload bytes: an int8 pool
        stores 4 elements in one f32 element's bytes, so the payload of an
        f32 pool of ``kv_pages`` holds ``4 × (kv_pages − 1)`` usable int8
        blocks. The scales (4 / hd of the int8 payload) are not hidden in
        it: ``kv_pool_bytes`` reports them. The usable block count at f32;
        0 unpaged."""
        if not self.paged:
            return 0
        return (self.kv_pages - 1) * (4 // self.kv_elem_bytes)

    def kv_pool_bytes(self) -> Dict[str, int]:
        """The KV cache's device bytes: the K/V payload and the scales
        (0 at f32)."""
        payload = scales = 0
        for name, c in self._cache.items():
            leaf = name.rpartition(".")[2]
            if leaf in ("k", "v"):
                payload += c.numel() * c.element_size()
            elif leaf.endswith("_scale"):
                scales += c.numel() * c.element_size()
        return {"payload": int(payload), "scales": int(scales)}

    # -- device programs --------------------------------------------------

    def _def(self, kind: str, n: int = 0) -> ProgramDef:
        """The ``ProgramDef`` of one program of this engine: ``kind`` is
        ``decode`` (``n`` its chunk), ``spec``, ``cow``, ``admit`` or
        ``prefill`` (``n`` its bucket). Its inputs are the builder's
        arguments that vary per call, each staged by name; the warm values
        make the run before a capture harmless (inactive rows write only
        the null page or their own cursor position, which a live row
        overwrites before reading)."""
        cfg, s, v = self.config, self.num_slots, self.config.vocab_size
        q = _qtag(cfg)
        i32, f32 = np.int32, np.float32
        sampling_warm = {"temp": 1.0, "top_k": v, "top_p": 1.0}

        def sampling(rows, key):
            return {key: ((rows, 2), i32), "temp": ((rows,), f32),
                    "top_k": ((rows,), i32), "top_p": ((rows,), f32)}

        warm: Dict[str, Any] = {}
        if kind in ("decode", "spec"):
            inputs = {"tok": ((s,), i32), "active": ((s,), np.bool_),
                      "gen_idx": ((s,), i32), "remaining": ((s,), i32),
                      "eos": ((s,), i32), **sampling(s, "base_keys")}
            warm = dict(sampling_warm, eos=-1)
            if self.paged:
                inputs.update(bt=((s, self.max_blocks), i32),
                              pos=((s,), i32))
            if kind == "spec":
                inputs["hist"] = ((s, self.block_size), i32)
                build = programs.build_spec_decode(cfg, s, n,
                                                   self.spec_tokens)
                name = (f"serve.spec_decode[slots={s},chunk={n},"
                        f"gamma={self.spec_tokens}{q}]")
            elif self.paged:
                build = programs.build_paged_decode(cfg, s, n)
                name = f"serve.paged_decode[slots={s},chunk={n}{q}]"
            else:
                build = programs.build_slot_decode(cfg, s, n)
                name = f"serve.decode[slots={s},chunk={n}{q}]"
            fn = functools.partial(build, self.params, self._cache)
        elif kind == "prefill":
            inputs = {"tokens": ((1, n), i32), **sampling(1, "key")}
            warm = sampling_warm
            if self.paged:
                inputs.update(bt_row=((1, self.max_blocks), i32),
                              start=((1,), i32), true_suffix=((1,), i32))
                warm = dict(warm, true_suffix=1)
                name = f"serve.paged_prefill[bucket={n}{q}]"
                fn = functools.partial(programs.build_paged_prefill(cfg, n),
                                       self.params, self._cache)
            else:
                inputs["true_len"] = ((1,), i32)
                warm = dict(warm, true_len=1)
                name = f"serve.prefill[bucket={n}{q}]"
                fn = functools.partial(programs.build_prefill(cfg, n),
                                       self.params, self._row_cache)
        elif kind == "cow":
            inputs = {"src": ((1,), i32), "dst": ((1,), i32)}
            name = f"serve.cow[page={self.page_size}{q}]"
            fn = functools.partial(programs.build_cow(cfg), self._cache)
        elif kind == "admit":
            inputs = {"slot": ((1,), i32), "true_len": ((1,), i32)}
            name = f"serve.admit[slots={s}{q}]"
            fn = functools.partial(programs.build_slot_admit(cfg, s),
                                   self._cache, self._row_cache)
        else:
            raise ValueError(f"unknown program kind {kind!r}")

        owner = weakref.ref(self)
        uid, device, capture = self.uid, self.device, self.capture

        def builder():
            eng = owner()
            if eng is None or eng.closed:
                raise ProgramOwnerClosedError(
                    f"{name}: engine {uid} was closed")
            w = warm
            if kind == "admit":
                # the run before a capture writes the slot it names: a
                # free one (an admit is built before every slot fills)
                free = eng.free_slots()
                if not free:
                    raise RuntimeError(f"{name}: no free slot to warm on")
                w = {"slot": free[0], "true_len": 1}
            return StagedProgram(name, fn, inputs, device,
                                 capture=capture, warm=w)

        pdef = ProgramDef(
            name=name, config={"engine": self.uid, "config": self.config,
                    "device": str(self.device), "graph": self.capture},
            args=tuple(inputs.items()), builder=builder,
            lock=self.dispatch_lock)
        self._def_keys.add(pdef.key()[1])
        return pdef

    def _program(self, kind: str, n: int = 0):
        """This engine's registry handle for one program, pinned for the
        engine's lifetime."""
        h = self._handles.get((kind, n))
        if h is None:
            if self.closed:
                raise ProgramOwnerClosedError(
                    f"engine {self.uid} was closed")
            h = self._registry.acquire(self._def(kind, n), pin_owner=self)
            self._handles[(kind, n)] = h
        return h

    def warmup_defs(self) -> List[ProgramDef]:
        """This engine's complete program family, which the background
        warmup builds so that no request pays a capture: the decode chunk
        (and the spec chunk), copy-on-write (paged) or admit (unpaged),
        the chunk-1 twin (teacher forcing) where it differs, and every
        power-of-two prefill bucket up to ``block_size``, traffic-critical
        first."""
        buckets: List[int] = []
        b = 1
        while b < self.block_size:
            buckets.append(b)
            b <<= 1
        buckets.append(self.block_size)
        chunk = self.decode_chunk
        defs = [self._def("decode", chunk)]
        if self.paged:
            if self.spec_tokens:
                defs.append(self._def("spec", chunk))
            defs.append(self._def("cow"))
            if chunk != 1 or self.spec_tokens:
                defs.append(self._def("decode", 1))
        else:
            defs.append(self._def("admit"))
            if chunk != 1:
                defs.append(self._def("decode", 1))
        defs.extend(self._def("prefill", b) for b in buckets)
        return defs

    def _prefill_prog(self, bucket: int):
        """This bucket's prefill program, ensured built;
        ``stats.prefill_compiles`` counts the buckets whose program this
        engine's own request built (a program the warmup built first is a
        hit, not a build)."""
        h = self._program("prefill", bucket)
        if h.ensure_reporting():
            self.stats.prefill_compiles += 1
        return h

    def close(self, wait_s: float = 30.0) -> None:
        """Tear the engine down: drop its registry entries and free its
        graphs, staging buffers and caches. Waits up to ``wait_s`` for a
        dispatch in flight; a wedged one (past it) keeps what it runs on
        until its thread lets go. Idempotent."""
        got = self.dispatch_lock.acquire(timeout=max(0.0, wait_s))
        try:
            self.closed = True
            self._handles.clear()
            if got:
                self._release()
                self.params = {}
                self._cache.clear()
            else:
                # what the wedged thread runs on stays until it lets go
                self._registry.discard(self._def_keys)
                if self._row_cache is not None:
                    self._row_cache.clear()
        finally:
            if got:
                self.dispatch_lock.release()

    # -- slot lifecycle ---------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self._active[i]]

    def validate(self, prompt: np.ndarray, sp: SamplingParams) -> None:
        """Typed rejection of requests the decode path cannot serve
        honestly — callers (scheduler.submit, the HTTP handler) fail fast
        with a ValueError instead of poisoning a slot: cache overflow
        (the same error ``generate_fast`` raises), out-of-vocab token ids
        (XLA's gather would silently CLAMP them to vocab_size-1 and serve
        a completion for a prompt the client never sent), and
        non-positive temperature (logits/0 → NaN → garbage tokens;
        greedy decoding is ``top_k=1``, not ``temperature=0``)."""
        prompt = np.asarray(prompt)
        n = int(prompt.size)
        if n < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.config.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.config.vocab_size})"
                f"; got range [{int(prompt.min())}, {int(prompt.max())}]")
        if sp.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {sp.max_new_tokens}")
        if not sp.temperature > 0:
            raise ValueError(
                f"temperature must be > 0 (got {sp.temperature}); use "
                f"top_k=1 for greedy decoding")
        if n + sp.max_new_tokens > self.block_size:
            raise ValueError(
                f"prompt {n} + {sp.max_new_tokens} new tokens exceeds the "
                f"KV cache (block_size {self.block_size}); crop the prompt "
                f"to block_size - max_new_tokens, or use `generate`, whose "
                f"full-context resampling slides the context window")
        if self.paged:
            # worst case (zero prefix hits, +1 copy-on-write headroom)
            # must fit the pool EVER, so a queued request always
            # eventually admits once running slots release their blocks
            worst = -(-(n + sp.max_new_tokens) // self.page_size) + 1
            if worst > self.kv_pages - 1:
                raise ValueError(
                    f"request needs up to {worst} KV blocks but the "
                    f"paged pool holds {self.kv_pages - 1}; raise "
                    f"kv_pages or shrink prompt/max_new_tokens")

    # -- paged planning ---------------------------------------------------

    def _walk_prefix(self, prompt: np.ndarray):
        """Consecutive resident full prompt blocks: ``(hit_pages,
        chain_cids)`` — THE prefix probe, shared by planning, capacity
        checks and the scheduler's ordering score (no LRU touch; only a
        committing admission refreshes recency)."""
        page, al = self.page_size, self._alloc
        hit_pages: List[int] = []
        chain: List[int] = []
        cid = 0
        for b in range(len(prompt) // page):
            ent = al.probe(cid, prompt[b * page:(b + 1) * page].tobytes())
            if ent is None:
                break
            hit_pages.append(ent[0])
            cid = ent[1]
            chain.append(cid)
        return hit_pages, chain

    def _plan_paged(self, prompt: np.ndarray, max_new: int):
        """Plan a paged admission without mutating allocator state:
        returns ``(hit_pages, chain_cids, cow_src, parent_cid, start,
        suffix, bucket, n_new, need)``. ``hit_pages`` are the resident
        shared-prefix blocks (to be pinned), ``cow_src`` a fully-matched
        final block to copy-on-write (its last token is re-forwarded for
        the first-token logits — recomputing INTO the shared page would
        perturb other readers by the recompute's rounding), ``n_new``
        the fresh blocks to allocate and ``need`` the total pages the
        admission must obtain (n_new + the CoW page)."""
        n = len(prompt)
        page, s_max = self.page_size, self.block_size
        full = n // page
        hit_pages, chain = self._walk_prefix(prompt)
        cid = chain[-1] if chain else 0
        cow_src = None
        if hit_pages and len(hit_pages) * page == n:
            cow_src = hit_pages.pop()
            chain.pop()
            cid = chain[-1] if chain else 0
        matched = len(hit_pages) * page
        suffix = n - matched
        # pad writes (suffix rounded up to its bucket) must stay inside
        # the [block_size] window: un-share blocks until they do. Rare —
        # only near-full-window prompts with a large unshared suffix.
        # The CoW path is exempt: its real suffix is ONE token (bucket
        # 1, start n-1 ≤ block_size-1 always fits) — running the guard
        # on the stale pre-override suffix could otherwise pop hits
        # whose table slots the CoW branch does not re-point.
        while cow_src is None and hit_pages \
                and matched + prompt_bucket(suffix, s_max) > s_max:
            hit_pages.pop()
            chain.pop()
            cid = chain[-1] if chain else 0
            matched -= page
            suffix += page
        if cow_src is not None:
            start, suffix, bucket = n - 1, 1, 1
            first_new = full                 # CoW page covers block full-1
        else:
            start = matched
            bucket = prompt_bucket(suffix, s_max)
            first_new = matched // page
        end_tokens = max(n + max_new, start + bucket)
        n_new = -(-end_tokens // page) - first_new
        need = n_new + (1 if cow_src is not None else 0)
        return (hit_pages, chain, cow_src, cid, start, suffix, bucket,
                n_new, need)

    def admit_probe(self, prompt, sp: SamplingParams) -> Tuple[bool, int]:
        """ONE planning walk answering both scheduler questions:
        ``(would admit() succeed right now, resident-prefix score)``.
        The capacity answer is exact, not conservative — it runs the
        same plan ``admit`` would and excludes the would-be-pinned
        prefix blocks from the evictable supply. Unpaged:
        ``(True, 0)`` — ordering degrades to FCFS."""
        if not self.paged:
            return True, 0
        p = np.asarray(prompt, np.int32).reshape(-1)
        hit_pages, _chain, cow_src, _cid, _start, _suffix, _bucket, \
            _n_new, need = self._plan_paged(p, sp.max_new_tokens)
        pinned = hit_pages + ([cow_src] if cow_src is not None else [])
        score = len(hit_pages) + (1 if cow_src is not None else 0)
        return self._alloc.available(exclude=pinned) >= need, score

    def resident_prefix_blocks(self, prompt) -> int:
        """How many leading full blocks of ``prompt`` the prefix cache
        could serve right now. 0 on an unpaged engine."""
        if not self.paged:
            return 0
        p = np.asarray(prompt, np.int32).reshape(-1)
        return len(self._walk_prefix(p)[0])

    def has_capacity(self, prompt, sp: SamplingParams) -> bool:
        """Whether an ``admit`` of this request would succeed RIGHT NOW
        (block supply; the caller checks ``free_slots`` itself)."""
        return self.admit_probe(prompt, sp)[0]

    def admit(self, prompt: np.ndarray,
              sp: SamplingParams) -> Tuple[int, TokenEvent]:
        """Prefill ``prompt`` into a free slot and sample its first token.
        Returns ``(slot, event)``; when the first token already finishes
        the request (``max_new_tokens == 1`` or instant EOS) the slot is
        released before returning."""
        with self.dispatch_lock:
            return self._admit(prompt, sp)

    def _admit(self, prompt, sp: SamplingParams) -> Tuple[int, TokenEvent]:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.validate(prompt, sp)
        free = self.free_slots()
        if not free:
            raise NoFreeSlotError(
                "no free slot — admit() requires one (scheduler bug: "
                "check free_slots() first)")
        slot = free[0]
        fault_point("serve.prefill")
        n = len(prompt)
        base_key = np.asarray(threefry.PRNGKey(sp.seed), np.uint32)
        top_k = (self.config.vocab_size if sp.top_k is None
                 else int(sp.top_k))
        top_p = 1.0 if sp.top_p is None else float(sp.top_p)
        if self.paged:
            first = self._prefill_paged(slot, prompt, sp, base_key,
                                        top_k, top_p)
        else:
            bucket = prompt_bucket(n, self.block_size)
            self._seen_buckets.add(bucket)
            prefill = self._prefill_prog(bucket)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = prompt
            tok, = prefill(tokens=padded, true_len=n,
                           **self._sampling_row(base_key, sp.temperature,
                                                top_k, top_p))
            self._program("admit")(slot=slot, true_len=n)
            first = int(tok[0])
            self.stats.prefill_tokens += bucket
        self.stats.prefills += 1
        self.stats.tokens_generated += 1
        # slot bookkeeping: the first token came from the prefill (key
        # index 0); decode steps continue the schedule at index 1
        self._active[slot] = True
        self._next_tok[slot] = first
        self._gen_idx[slot] = 1
        self._generated[slot] = 1
        self._max_new[slot] = sp.max_new_tokens
        self._eos[slot] = -1 if sp.eos_token is None else int(sp.eos_token)
        self._temp[slot] = sp.temperature
        self._top_k[slot] = top_k
        self._top_p[slot] = top_p
        self._base_keys[slot] = base_key
        if self.paged:
            # token history feeds the n-gram draft; the first token is
            # emitted (index n), giving hist_len == cursor + 1
            self._hist[slot, n] = first
        finished = (sp.max_new_tokens <= 1
                    or (sp.eos_token is not None and first == sp.eos_token))
        if finished:
            self._active[slot] = False
            if self.paged:
                self._release_pages(slot)
        self.stats.active_slots = int(self._active.sum())
        self.stats.prefill_buckets = tuple(sorted(self._seen_buckets))
        return slot, TokenEvent(slot, first, finished)

    def _prefill_paged(self, slot: int, prompt: np.ndarray,
                       sp: SamplingParams, base_key, top_k: int,
                       top_p: float) -> int:
        """Prefix-aware paged prefill: pin the resident shared-prefix
        blocks, copy-on-write a fully-matched final block, allocate the
        owned blocks (prefill pads + the whole decode budget — blocks
        are reserved at admit, so mid-decode writes can never need an
        allocation the jitted program couldn't perform), dispatch the
        SUFFIX-only prefill, then content-register this prompt's own
        full blocks for future requests to hit."""
        n = len(prompt)
        page, al = self.page_size, self._alloc
        full = n // page
        hit_pages, chain, cow_src, cid, start, suffix, bucket, n_new, \
            need = self._plan_paged(prompt, sp.max_new_tokens)
        # `held` tracks every page reference this admission currently
        # owns; ANY failure past this point (capacity shortfall, a
        # compile/dispatch error in CoW or prefill) unwinds it exactly —
        # an admission that fails its request must not shrink the pool
        held: List[int] = []
        try:
            # pin before the capacity check: a pinned page is neither
            # evictable nor double-counted as supply
            for pg in hit_pages:
                al.incref(pg)
                held.append(pg)
            if cow_src is not None:
                al.incref(cow_src)
                held.append(cow_src)
            if al.available() < need:
                raise NoFreeBlocksError(
                    f"paged KV pool cannot supply {need} blocks right "
                    f"now — retry after running requests release")
            row = np.zeros(self.max_blocks, np.int32)
            row[:len(hit_pages)] = hit_pages
            next_b = len(hit_pages)
            if cow_src is not None:
                dst = al.alloc()
                held.append(dst)
                row[next_b] = dst
                next_b += 1
                self._program("cow")(src=cow_src, dst=dst)
                al.decref(cow_src)       # pinned only for the copy
                held.remove(cow_src)
            for k in range(n_new):
                pg = al.alloc()
                held.append(pg)
                row[next_b + k] = pg
            self._bt[slot] = 0
            self._bt[slot, :next_b + n_new] = row[:next_b + n_new]
            self._seen_buckets.add(bucket)
            prefill = self._prefill_prog(bucket)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :suffix] = prompt[start:]
            tok, = prefill(bt_row=self._bt[slot][None], start=start,
                           tokens=padded, true_suffix=suffix,
                           **self._sampling_row(base_key, sp.temperature,
                                                top_k, top_p))
        except BaseException:
            for pg in held:
                al.decref(pg)
            self._bt[slot] = 0
            raise
        # only a COMMITTING admission refreshes hit recency — planning
        # probes must not keep a never-admitted prefix artificially hot
        for pg in hit_pages:
            al.touch(pg)
        if cow_src is None:
            # register the freshly-prefilled full PROMPT blocks (their
            # content is immutable — decode writes start past them);
            # the CoW path has nothing new: every block was cached
            reg_cid = cid
            for b in range(len(hit_pages), full):
                reg_cid = al.register(
                    reg_cid, prompt[b * page:(b + 1) * page].tobytes(),
                    int(row[b]))
        self._pos[slot] = n
        self._hist[slot] = 0
        self._hist[slot, :n] = prompt
        self._prompt_len[slot] = n
        self.stats.prefix_hit_blocks += (len(hit_pages)
                                         + (1 if cow_src is not None
                                            else 0))
        self.stats.prefill_tokens += bucket
        self.stats.kv_blocks_in_use = al.in_use()
        self.stats.kv_blocks_cached = al.cached()
        return int(tok[0])

    def _release_pages(self, slot: int) -> None:
        """Drop this slot's block-table references (idempotent: an
        already-cleared row is a no-op). Cached prefix blocks stay
        resident at refcount 0; plain owned blocks return to the free
        list."""
        if not self.paged:
            return
        for pg in self._bt[slot]:
            if pg:
                self._alloc.decref(int(pg))
        self._bt[slot] = 0
        self.stats.kv_blocks_in_use = self._alloc.in_use()
        self.stats.kv_blocks_cached = self._alloc.cached()

    def release(self, slot: int) -> None:
        """Free a slot between decode steps (EOS/max-tokens eviction or a
        cancelled request). Unpaged, the cache rows stay as-is — the next
        admit overwrites them wholesale; paged, the slot's block-table
        references are dropped (shared prefix blocks stay resident for
        future hits)."""
        self._active[slot] = False
        self._release_pages(slot)
        self.stats.active_slots = int(self._active.sum())

    # -- preemptible decode (park / resume) --------------------------------

    def park(self, slot: int) -> ParkedSlot:
        """Preempt an ACTIVE slot at a chunk boundary (between ``step``
        dispatches): snapshot its entire host-side cursor state and
        block table WITHOUT decreffing the pages — the snapshot owns the
        references — deactivate the row, and return the snapshot. Pure
        host bookkeeping: no device work, no copies of KV state. Paged
        engines only (an unpaged slot's cache rows are overwritten
        wholesale by the next admit, so nothing parkable survives)."""
        if not self.paged:
            raise ValueError(
                "park() requires a paged engine — unpaged cache rows do "
                "not survive the next admit")
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active — nothing to park")
        parked = ParkedSlot(
            block_table=self._bt[slot].copy(),
            pos=int(self._pos[slot]),
            hist=self._hist[slot].copy(),
            prompt_len=int(self._prompt_len[slot]),
            next_tok=int(self._next_tok[slot]),
            gen_idx=int(self._gen_idx[slot]),
            generated=int(self._generated[slot]),
            max_new=int(self._max_new[slot]),
            eos=int(self._eos[slot]),
            temp=float(self._temp[slot]),
            top_k=int(self._top_k[slot]),
            top_p=float(self._top_p[slot]),
            base_key=self._base_keys[slot].copy())
        self._active[slot] = False
        # references moved to the snapshot: zero the row WITHOUT decref
        # so release()/step()'s page sweep cannot double-free them
        self._bt[slot] = 0
        self.stats.preemptions += 1
        self.stats.active_slots = int(self._active.sum())
        return parked

    def resume(self, parked: ParkedSlot) -> int:
        """Restore a parked snapshot into a free slot. No device work —
        the KV pool is shared across slots and the block table is a
        per-dispatch host input, so the resumed generation continues
        from exactly the token it was preempted at, byte-identical by
        the per-token key schedule. Raises ``NoFreeSlotError`` when
        every slot is busy (the scheduler checks first)."""
        if parked.released:
            raise ValueError("parked snapshot already consumed")
        free = self.free_slots()
        if not free:
            raise NoFreeSlotError(
                "no free slot to resume the parked request into")
        slot = free[0]
        self._bt[slot] = parked.block_table
        self._pos[slot] = parked.pos
        self._hist[slot] = parked.hist
        self._prompt_len[slot] = parked.prompt_len
        self._active[slot] = True
        self._next_tok[slot] = parked.next_tok
        self._gen_idx[slot] = parked.gen_idx
        self._generated[slot] = parked.generated
        self._max_new[slot] = parked.max_new
        self._eos[slot] = parked.eos
        self._temp[slot] = parked.temp
        self._top_k[slot] = parked.top_k
        self._top_p[slot] = parked.top_p
        self._base_keys[slot] = parked.base_key
        parked.released = True
        self.stats.resumes += 1
        self.stats.active_slots = int(self._active.sum())
        return slot

    def release_parked(self, parked: ParkedSlot) -> None:
        """Drop a parked snapshot's page references without resuming it
        (deadline/cancel/shutdown caught the request while parked).
        Idempotent via the ``released`` flag."""
        if parked.released:
            return
        parked.released = True
        for pg in parked.block_table:
            if pg:
                self._alloc.decref(int(pg))
        self.stats.kv_blocks_in_use = self._alloc.in_use()
        self.stats.kv_blocks_cached = self._alloc.cached()

    @staticmethod
    def _sampling_row(base_key, temp: float, top_k: int, top_p: float):
        """One request's key and sampling parameters, the prefill's staged
        inputs."""
        return {"key": base_key[None].view(np.int32), "temp": temp,
                "top_k": top_k, "top_p": top_p}

    def step(self, override_tokens: Optional[Dict[int, int]] = None
             ) -> List[TokenEvent]:
        """Advance every active slot by up to ``decode_chunk`` tokens (one
        program call); returns the new tokens in generation order. Slots
        that finish (EOS / max-tokens, decided on the device mid-chunk)
        come back inactive and free for the next admit.

        ``override_tokens`` (teacher forcing, tests/eval only) replaces a
        slot's INPUT token for ONE single step — the call runs a chunk-1
        program regardless of ``decode_chunk`` and the returned logits
        (``self.last_logits``) are the model's prediction conditioned on
        the forced history, while sampling proceeds normally.
        """
        with self.dispatch_lock:
            return self._step(override_tokens)

    def _step(self, override_tokens) -> List[TokenEvent]:
        kind, chunk = "decode", self.decode_chunk
        spec_run = bool(self.spec_tokens)
        if override_tokens:
            for slot, tok in override_tokens.items():
                self._next_tok[slot] = int(tok)
            spec_run, chunk = False, 1
        elif spec_run:
            kind = "spec"
        if not self._active.any():
            return []
        # hit-counted AFTER the idle early-out so hit N is the Nth REAL
        # decode dispatch — "hang at dispatch 2" reproduces exactly
        fault_point("serve.decode")
        was_active = self._active.copy()
        rows = dict(tok=self._next_tok, active=self._active,
                    base_keys=self._base_keys.view(np.int32),
                    gen_idx=self._gen_idx,
                    remaining=self._max_new - self._generated,
                    eos=self._eos, temp=self._temp, top_k=self._top_k,
                    top_p=self._top_p)
        prog = self._program(kind, chunk)
        if self.paged:
            rows.update(bt=self._bt, pos=self._pos)
            if spec_run:
                rows["hist"] = self._hist
            toks, emitted, lg, final_tok, final_active, final_pos, \
                nan_seen = prog(**rows)
            self._pos = final_pos
        else:
            toks, emitted, lg, final_tok, final_active = prog(**rows)
            nan_seen = None
        if toks.ndim == 2:
            # non-speculative programs emit one token per scanned step;
            # widen to the speculative [chunk, S, γ+1] layout so ONE host
            # replay path routes both
            toks = toks[..., None]
            emitted = emitted[..., None]
        self.last_logits = lg
        self._next_tok = final_tok
        self._active = final_active
        # numerical quarantine: non-finite logits fail ONLY their own
        # slot — the model's per-row cache math keeps rows isolated (and
        # the decode attends NaN-poison an overflowing row/position on
        # purpose, so this is the designated catch point). Unpaged, the
        # check reads the LAST scanned step's logits for every slot
        # that emitted anywhere in this chunk: a poisoned slot that
        # finishes mid-chunk goes inactive but keeps attending its own
        # NaN cache rows, so the poison stays visible in the final
        # logits. Paged, that witness FAILS — a finished row's table is
        # redirected to the null page, so its later iterations read
        # clean garbage — and the programs instead LATCH non-finite
        # logits per iteration while the row is active (`nan_seen`).
        if nan_seen is not None:
            bad = nan_seen
        else:
            bad = emitted.any(axis=(0, 2)) & ~np.isfinite(
                self.last_logits).all(axis=1)
        for slot in np.nonzero(bad)[0]:
            self._active[slot] = False           # quarantine = evict
            self.stats.quarantined += 1
        events: List[TokenEvent] = []
        n_steps = toks.shape[0]
        for k in range(n_steps):
            for slot in np.nonzero(emitted[k].any(axis=1))[0]:
                if spec_run:
                    # acceptance accounting: γ drafted per active slot
                    # per iteration; all emitted beyond the one
                    # guaranteed token were accepted drafts
                    self.stats.spec_drafted += self.spec_tokens
                    self.stats.spec_accepted += int(
                        emitted[k, slot].sum()) - 1
                for j in np.nonzero(emitted[k, slot])[0]:
                    tok = int(toks[k, slot, j])
                    if self.paged:
                        hl = (int(self._prompt_len[slot])
                              + int(self._generated[slot]))
                        if hl < self.block_size:
                            self._hist[slot, hl] = tok
                    self._gen_idx[slot] += 1
                    self._generated[slot] += 1
                    # finished iff the device stopped emitting for this
                    # slot (its last emitted token) and it came back
                    # inactive
                    last_emit = (not emitted[k, slot, j + 1:].any()
                                 and not emitted[k + 1:, slot].any())
                    finished = bool(last_emit and not self._active[slot])
                    events.append(TokenEvent(int(slot), tok, finished,
                                             poisoned=bool(bad[slot])))
        if self.paged:
            # blocks of slots that finished (or were quarantined) this
            # chunk go back to the allocator; shared prefix blocks stay
            # resident for future hits
            for slot in np.nonzero(was_active & ~self._active)[0]:
                self._release_pages(slot)
        self.stats.tokens_generated += len(events)
        self.stats.decode_steps += int(was_active.any()) * n_steps
        self.stats.active_slots = int(self._active.sum())
        return events
