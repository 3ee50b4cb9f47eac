#!/usr/bin/env python3
"""Smoke run of gym_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. device: the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from this checkout (``nvcc``), print the build
   time, the ``-Xptxas -v`` report (registers, shared memory, spills), the
   f32 kernels' registers, spills and shared memory per head dim and, from
   ``cuobjdump -sass``, each kernel's count of ``HGMMA`` (wgmma), ``HMMA``,
   ``FFMA`` and ``ATOM``/``RED`` instructions; fails if a bf16 forward,
   dk/dv, dq or long-context forward kernel, or an f32 (3xTF32) forward,
   dq, dk/dv or long-context forward kernel at any head dim and copy width,
   has no ``HGMMA``, if any kernel has an atomic, or if a kernel that the
   long-context f32 forward and T1's segments replaced is still built; the
   long-context forwards' register split and blocks per SM;
3. every kernel against its plain PyTorch version on the card, bf16 and f32:
   the packed pair (B1/B2) at the flagship shape with q, k and v as strided
   views of the ``[N, T, 3C]`` projection, the per-head pair (B3/B4) at the
   GPT-2-base shape, causal and full-block with a random lse cotangent, the
   long-context pair (B5) at N=2 H=12 T=8192 D=64 on per-head views of the
   projection, at T=2048 (the tuned blocks) and at T=1152 (the default-block
   rule); the bf16 forward and backward and the f32 forward, each run
   twice at the B5 shape, and the f32 forward and backward, each run twice
   at the packed and per-head shapes, must agree bit for bit;
4. flagship training through ``Trainer.fit``: GPT 4L/4H/128d, vocab 65,
   T=256, K=64 nodes × 16 rows, bf16, DiLoCo (H=2) with the lambda_cosine
   warmup, 6 steps on random tokens; the packed kernels must have launched;
5. GPT-2 base (12L/12H/768, vocab 50304, T=1024, K=2 × 4 rows, 3 steps,
   DiLoCo H=2); the per-head kernels must have launched;
5b. long context: GPT-2 base at T=8192 with ``remat`` and ``loss_chunk=2048``,
   K=2 × 1 row, 4 steps (the steady rate counts the last two); the B5 pair
   must have launched exactly as often as the steps and evals need (the
   bf16 forward twice a layer a step under remat, the f32 forward twice a
   layer an eval), and one f32 eval is timed; then one step without
   ``remat`` and ``loss_chunk``, whose peak memory must be higher;
6. card against CPU: tiny GPTs through ``Trainer.fit`` on ``cuda`` and on
   ``cpu`` from the same weights and batches, in bf16 and in f32, at T=128
   and at T=2048 (where the card runs B5 and the CPU dense attention); at
   T=128 also under SPARTA-DiLoCo (p 0.3, H 2, participation 0.75), whose
   masks come from the threefry kernel on the card and its twin on the CPU;
7. timing with CUDA events (median of 5 runs of back-to-back launches,
   queued behind a device sleep so that the events bracket device work
   only): each kernel, its plain version, the library call
   (``scaled_dot_product_attention``, timed only as a yardstick), the bound
   at 3.35 TB/s and 989 TFLOP/s and the TFLOP/s of the tiles the kernel
   computes; the f32 long-context forward's time beside f32 SDPA's and its
   bound, with its pre-pass timed alone, and beside the whole-context f32
   forward (``attn_fwd_tf32x3``) at the same shape; T1, the threefry
   Bernoulli masks of every GPT-2 base leaf (one SPARTA step, one launch),
   against its twin and its bound (bytes, or the least integer instructions
   at the dispatch limit of 128 lanes a clock an SM at the card's highest SM
   clock);
8. the stochastic strategies through ``Trainer.fit`` (random tokens, bf16),
   each with its steady steps/s, exact launch counts of B1-B4 and T1 and
   peak memory: 8a GPT-2 base, K=4 × 4 rows, SPARTA-DiLoCo (p 0.005, H 2,
   participation 0.75), 4 steps, whose step-0 ``comm_bytes`` must equal
   the prediction from the twin's mask counts, and T1 launched once a step; 8b the flagship, K=64 × 16,
   FedAvg (H 2, islands of 16), 6 steps; 8c GPT-2 base, K=4 × 4, ZeRO-1
   then SimpleReduce (AdamW), 3 steps each, where ZeRO must peak lower;
9. the BASELINE configs through ``Trainer.fit`` at
   ``benchmarks/run_baselines.py``'s settings, cut in steps, f32, each with
   its steady steps/s, peak memory, final loss and exact launch counts:
   9a-9c the MNIST CNN on the bundled digits (batch 256 in microbatches of
   64, Adam 1e-3, lambda_cosine warmup 100, 8 steps): 9a K=2 SimpleReduce,
   9b K=8 DiLoCo (H cut from 100 to 2 so that outer steps fire), 9c K=8
   SPARTA (p 0.005), the dropout masks from the per-row T1 (3 launches a
   microbatch) and SPARTA's from T1 (one launch a step), evals at step 0
   and after the last step (the configs eval 5 times in 300 steps, so the
   steady window holds none); 9d nanoGPT "small" 4L/4H/128d, vocab 66,
   T=256, K=16 × 16 rows, FedAvg AdamW 3e-4 (H cut to 2), 6 steps on the
   ``docs`` stream of the checkout's ``gym_tpu/`` (its length and crc32
   checked), the packed pair B1/B2 in f32, evals likewise; 9e the CNN on the card against the CPU, K=2 × 8 images in
   microbatches of 4, 3 steps from the same weights, f32 and bf16 (plain
   SGD: under Adam the conv biases ahead of BatchNorm get gradients of
   pure rounding noise, which Adam scales to steps of ±lr, so two
   summation orders part after a step; PERF.md); 9f BASELINE config 5:
   nanoGPT "small" (vocab 66, T=256) at K=64 × 16 rows, DeMo (SGD 1e-3,
   top-k 32, chunk 64, lambda_cosine warmup 60), f32, 6 steps on ``docs``,
   evals at step 0 and after the last step: exact launches of the f32
   B1/B2 and of D1 (3 a step, one a tile signature), step 0's
   ``comm_bytes`` 79,872 and ``comm_recv_bytes`` 5,031,936, a finite loss
   that falls (the last eval's global loss below step 0's);
10. serving GPT-2 base (12L/12H/768, vocab 50304, block 1024, f32, random
   weights from a seed) through ``Scheduler`` over the paged engine (page
   16, 16 slots, ``decode_chunk`` 8): 32 requests of 16-512 prompt tokens
   (8 share a 256-token system prompt), 32-64 new tokens, temperature 0.9
   with top-k 40 or top-p 0.95: (a) the workload, its output tokens/s,
   TTFT p50/p99, peak memory and ``prefix_hit_blocks``, B7, R1, L1 and T1's
   bits rows launched (counted from zero); (b) ``spec_tokens=4`` over the
   workload and 8 greedy requests (its accept rate; at least 200 drafts
   accepted, the greedy streams equal to a run without speculation), (c)
   unpaged, (d) one request against ``generate_fast``, (e) 16 batch-class
   requests and an interactive one that parks one of them: every stream
   equal to (a)'s token for token; then a 32-token
   prompt and 8 greedy tokens on the card against the CPU (logits within
   rtol 1e-4 of the largest, tokens equal);
11. checkpoints (run dirs under ``build/chip_smoke_ckpt/``, removed
   after): 11a GPT-2 base, K=2 × 4 rows, bf16, DiLoCo H=2, 6 steps on
   random tokens, B3/B4 launched: run 1 straight without checkpoints,
   run 2 with ``checkpoint_interval=3``, the async writer and the
   prefetcher to step 3 and then ``resume="auto"`` to 6, whose
   ``train.csv`` must be byte-identical to run 1's and its node params
   bit-equal; the bytes of a step dir against the state's tensors, one
   synchronous save and one restore timed, the resumed run's steady
   steps/s beside phase 5's, peak memory with and without checkpoints;
   11b-11c the same recipe at 4L/4H/256d, each drill in a worker process
   (``chip_smoke.py --ckpt-worker SPEC``, all four started together)
   under ``GYM_TPU_FAULTS``: ``dispatch.boundary:sigterm@4`` (exit 0,
   ``preempted``, an emergency checkpoint), ``checkpoint.write:kill@2``,
   ``checkpoint.bytes:bitflip=8@2`` (quarantined as ``6.corrupt-0`` at the
   relaunch) and ``dispatch.state:bitflip=4@4`` under
   ``Guard(fingerprint_interval=1)`` (one rollback); every relaunch, and
   the guarded run, byte-identical to an uninterrupted run in this
   process; 11d ``load_for_serving`` of 11a's run dir through the
   paged engine (page 16, 16 slots, ``decode_chunk`` 8) over 8 of phase
   10's requests, the streams equal token for token to those of
   ``serving_params`` of 11a's in-process result, B7, R1, L1 and T1's bits
   rows launched, and ``python -m gym_tpu_torch.examples.nanogpt --ckpt
   RUN_DIR --sample 32``, started beside 11b;
12. the engine's CUDA graphs and the HTTP server, on 11a's run dir before
   it is removed: 12a phase 10's workload through the paged engine with
   its programs as CUDA graphs and eagerly, three runs each in turns, each
   engine's family built first (14 graphs captured), every stream equal;
   output tokens/s, TTFT p50/p99, peak memory, the warmup's seconds,
   launch calls and device kernels a decode step (one chunk under
   ``torch.profiler``) and the device busy share
   (``scripts/profile_serve.py``'s ``profile_workload``) of each; 12b
   ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir ``--num_slots 16
   --decode_chunk 8`` in a subprocess with no ``--device``: its warmup
   done, 11d's 8 requests sent together over HTTP, each stream equal to
   the eager in-process engine's on ``load_for_serving`` of the run dir,
   ``/stats`` with ``requests_done`` 8 and prefix hits, the SIGTERM drill
   (rc 0, "shut down cleanly", ``tokens_per_s``, ``serve.csv``'s
   ``ts_s,kind`` header), then a restart against the same kernel build
   directory: the first request 200 and equal, ``programs_compiled`` 0,
   the family's 14 graphs captured again; 12c ``create_server`` with two
   in-process replicas, ``POST /reload`` to steps 3, 6 and 3: streams
   after equal to a fresh engine's on step 3, peak memory after three
   reloads within 5% of the peak after one;
13. quantized serving, on 11a's run dir before it is removed: 13a B6
   (``row_qlinear``: R1 over int8/int4 weights) at GPT-2 base's
   [16, 768] x [768, 3072], its lm head [16, 768] x wte^T (``[V, C]`` read
   transposed) and a [1024, 768] x [768, 3072] prefill, int8 and int4, and
   B7 int8 at decode (b=16, t=1, cursors 16-576, page 16), a verify
   (b=16, t=5) and prefill (b=1, t=512): each bit for bit the f32 kernel
   (R1, B7) on the dequantized operands, B7 int8 bit for bit its oracle,
   beside its plain version, every B6 row bit for bit at M = 1, 16, 80 and
   1024, ``kv_quantize`` on the card bit for bit the CPU's; then each timed
   beside its bound, its plain version and its yardstick
   (``dequantize_tiles`` then ``torch.matmul``; ``kv_dequantize`` then SDPA
   on the gathered window), B7 int8 in turns with its oracle; 13b phase 10's workload through the
   paged engine under int8 weights and int8 KV on CUDA graphs, three runs
   in turns with f32 graphs (output tokens/s, TTFT p50/p99, peak memory,
   graphs captured, launches), the streams equal to an eager int8 run's
   and to the card's quantized ``generate_fast``, the card's quantized
   logits within rtol 1e-4 of the CPU's, and one run under int4 weights
   and embedding equal to its own ``generate_fast``; 13c distinct
   one-block prompts (300: more than the int8 pool holds) at page 16
   through an f32 pool of 66 pages and an int8 pool of 261 (equal payload
   bytes): the int8 payload no larger and at least 4x the resident prefix
   blocks, the weight bytes of f32, int8
   and int8 with the embedding, the streams' divergence from f32 (greedy,
   temperature 0.9 with top-k 16, top-p 0.9) and the eval-loss delta;
   13d ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir ``--quant
   int8 --kv-quant int8 --num_slots 16 --decode_chunk 8`` in a subprocess
   with no ``--device``: 11d's 8 requests over HTTP equal to the eager
   in-process engine's on ``load_for_serving(..., weights_dtype="int8",
   kv_dtype="int8")``, ``/stats`` echoing the dtypes, a restart with
   ``programs_compiled`` 0;
14. the process fleet and the deploy drill, on 11a's run dir before it is
   removed: 14a ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir
   ``--out-of-process --replicas 2 --autoscale --min-replicas 2
   --max-replicas 3 --program-cache-dir build/gym_tpu_torch --num_slots 16
   --decode_chunk 8`` in a subprocess with no ``--device`` (the parent
   builds nothing: 12b's build directory): every worker (and the respawn)
   reports ``programs_compiled`` 0 and warms its family, 11d's 8 requests
   streamed over HTTP together equal to 12b's streams, then again with a
   ``kill -9`` of the worker serving one stream once it has 4 or more
   tokens: every stream equal to 12b's, the victim's with ``failovers`` of
   at least 1, the autoscaler's respawn in ``/stats``; the SIGTERM drill
   (rc 0, "shut down cleanly", no worker process left); it prints each
   worker's startup seconds (its spawn to its socket's handshake, read
   off the server's log), each worker's card memory (``nvidia-smi
   --query-compute-apps``) and the fleet's output tokens/s beside 12b's
   in-process figure; 14b ``python -m gym_tpu_torch.servesim.drill
   --out-of-process --replicas 2 --kill-trainer --time-scale 2`` on the
   card: the trainer killed and resumed, zero dropped requests, zero
   ``nvcc`` builds in every worker across the hot swaps, the post-swap
   stream equal to ``generate_fast``;
15. the network simulator and elastic membership: 15a phase 11a's fit
   (GPT-2 base, K=2 × 4 rows, bf16, DiLoCo H=2, 6 steps) with
   ``network="wan"``, with ``"datacenter"`` and without: ``sim_step_s`` in
   every ``train.csv`` row, ``FitResult.sim["trace_tx_bytes"]`` equal to
   the logged ``cum_comm_bytes`` exactly, wan's ``sim_comm_s`` above
   datacenter's, B3/B4 exactly as the steps and evals need, the three
   steady rates printed; 15b ZeRO-1 (AdamW) at GPT-2 base, K=4 × 4 rows,
   checkpoints every 3, 9 steps: the step dir in the ZeRO-2 layout within
   1% of 4·(n + 2·4·ceil(n/4)) bytes (n = 124,475,904), a worker (``--ckpt-worker``)
   killed by ``dispatch.boundary:kill@5`` past its synchronous step-3
   save and resumed at K=3 and K=5 in workers of their own, each to step 9
   from step 3, its pre-kill ``train.csv`` rows verbatim, its mean loss
   within 0.25 of the uninterrupted in-process run's, no step quarantined
   and no ``nvcc`` build; K=4→3→4 and 4→5→4 of the trained state through
   ``reshard_state`` on the card, bit-identical with the pad tail; the
   replicate path at 4L/4H/256d (DiLoCo int8 without error feedback, SGD,
   K=2→3: resumed at a sync boundary, ``NodeCountMismatchError`` mid-cycle
   with nothing quarantined); restore plus reshard timed beside 11a's
   restore; 15c ``python -m gym_tpu_torch.sim.sweep --preset
   wan,datacenter --strategies diloco,simple_reduce --events none,join@4
   --nodes 2 --steps 8 --batch_size 4 --block_size 128 --n_layer 2 --n_embd
   64`` in a subprocess with no ``--device``: the DiLoCo headline, no
   reconciliation failure, 6 cells in ``frontier.csv``, the join cells'
   reshard priced, and in every cell the attention pair the port's gate
   picks at that shape launched (the packed pair) and no other;
16. mixture of experts on one card: 16a B8 (``tc::grouped_gemm_kernel``,
   ``tc::grouped_outer_kernel``: bf16 on TMA and ``wgmma``; f32 on the
   ``cp.async`` ring kernels ``grouped_gemm_f32_kernel`` (three tilings by
   R) and ``grouped_outer_f32_kernel``, R1's chains) against its plain
   version at the MoE path's shapes, [16384, 768] x [8, 768, 3072] and
   [16384, 3072] x [8, 3072, 768], each ct_x (w read transposed) and each
   grouped_outer, bf16 and f32, group sizes with an empty group and one of
   60% of the rows, K=2 flattened to 16 groups (forward, ct_x and
   grouped_outer) and 333 rows past sum(gs); in f32 also the served steps
   16c gives B8 (decode of 1-16 slots, prefills of 32-512 tokens, top-2
   rows routed as ``moe_mlp`` routes them, most groups empty at a few
   rows); each output poisoned first, in the dtype's band (bf16 phase 3's)
   and run twice bit for bit; bf16 also in the band of the first kernels
   kept as the oracle (``grouped_*_ref_kernel``; bit for bit reported), a
   bf16 view TMA does not take (C = 100) on the first kernels, counted
   apart; every f32 case bit for bit its oracle (the first f32 kernels,
   ``grouped_*_f32_ref_kernel``) and R1's in-order FMA chains a group;
   grouped_dot and grouped_outer captured in a CUDA graph, replayed equal
   to eager, in both dtypes (f32 also a decode step of 1 and of 16
   tokens); then timed beside the oracle, the plain version, the library
   yardstick (``torch._grouped_mm`` where it takes the operands, else a
   per-expert ``torch.matmul`` loop, labelled) and the bound (in f32 at a
   few rows the larger of the bytes of the experts with rows and the
   chain floor, K dependent FMAs); in f32 also the served decode of 1 and
   16 tokens and the 512-token prefill; 16b the repo's MoE config (GPT-2
   base, every second block's MLP 8 experts top-2, T=1024) through
   ``Trainer.fit``, K=2 × 4 rows, bf16, DiLoCo (AdamW, H=2), 4 steps: B8's
   launches exactly (none on the first kernels' path), steady steps/s,
   peak memory, active-parameter MFU; then in f32, K=2 × 1 row, 2 steps:
   every product on the f32 ring kernels, their launches exactly; 16c the
   same model in f32, random weights, 8 of phase 10's requests through the
   paged engine eagerly and on CUDA graphs (tokens and launches equal, the
   tokens' digest printed for ``scripts/moe_serve_digest.py``), one
   request alone equal to its tokens in the batch and to
   ``generate_fast``; 16d
   ``python -m gym_tpu_torch.examples.nanogpt --n_experts 4 --dataset
   docs`` at 4L/4H/128d, three steps. ``chip_smoke.py --b8-check`` runs
   the build and 16a's checks alone (``scripts/b8_faults.py``);
17. the ``kernels`` JSON line, then the result line.

The serving kernels (no Pallas counterpart: each replaces an XLA lowering of
the JAX package's decode path): B7 (``decode_attention_kernel``, the paged
decode attention, in two paths by t, and over int8 pools B7 int8; its
oracle ``decode_attention_ref_kernel``, the first version, whose bits the
path keeps), R1 (``row_gemm_pipe_kernel``, the row-invariant f32 linear
layer, lm head and scan, and over int8 weights B6; its oracle
``row_gemm_ref_kernel``), L1 with the residual add before it
(``row_add_layer_norm_kernel``; its oracle ``row_layer_norm_kernel`` after
a torch add) and T1's bits rows (``threefry_rows_bits_kernel``, the
sampler's gumbel bits, keys folded on the card). Phase 2 requires all of
them built, without atomics, and R1's, B6's, B7's and L1's kernels FMA
chains without a tensor-core instruction, and prints their registers and
spills. Phase 3 holds B7 and B7 int8 bit for bit to their oracles on every
path at t = 1, 5, 16, 64 and 512, head dims 16-128, pages of 16 and 32 and
unpaged, cursors 0, S - 1 and random, with NaN past each row's last
position and in unmapped pages changing no bit and a NaN scale reaching
exactly its query, and L1 with the add bit for bit a torch add and the
oracle L1 at M = 1-1024 and C = 768 and 100. Phase 3
holds R1 bit for bit to its oracle at M = 1, 2, 15-17, 31-33, 63-65, 80,
128, 256, 512 and 1024 on GPT-2 base's dense shapes and lm head and on
ragged shapes, both layouts, with and without a bias, and on the scan's
[16·1572, 32] and [80·1572, 32] x [32, 32]; then B6 int8 and int4 bit for
bit R1 on the dequantized weights and its own oracle at the same M. Phase 3
holds them to their twins at GPT-2 base's shapes (B7: decode b=16 with
cursors spread over 0-1023 on shuffled pages of 16, a t=5 verify, prefills
of 512 and 1024, a prefix-hit prefill from position 256 on shared pages,
unpaged; R1 at M = 1, 16, 80, 1024 on the four dense shapes and the lm head,
also against ``torch.matmul``; L1; T1's bits rows at 16 and 80 rows of
50,304 bit for bit), B7 paged against unpaged and a query alone against the
same query in its batch, verify chunk and prefill bit for bit, every R1 and
L1 row and the sampler's scan (``row_cumsum``) bit for bit at M = 1, 16, 80
and 1024 (``torch.matmul``'s, PyTorch's layer norm's and ``torch.cumsum``'s
rows are printed beside them, for the record), and the decode forward
end to end (a prompt against its bucket, a row alone against 16 rows, a
verify chunk against single steps) and the sampler's tokens bit for bit.
Phase 7 times B7 in turns with its oracle at the decode, a 5-token verify
and a 512-token prefill shape beside SDPA on the gathered, masked window;
R1 in turns with its oracle (new, oracle,
oracle, new) at M = 16 on the four dense layers and the lm head, at the
prefill buckets 64-512, a verify's 80 rows and 1024 rows of the 768-to-3072
layer, the lm head at 80 rows and the scan, and B6 int8 likewise at the
decode and bucket shapes, each beside ``torch.matmul``, its bound and its
chain floor (K FMAs at 4 cycles at the highest SM clock), failing if R1 or
B6 is slower than the oracle at any of them; L1 with the add in turns with
a torch add and the oracle L1, beside a torch add and ``F.layer_norm``,
and the bits rows in turns with their oracle at 16 and 80 x 50,304 and
1 x 804,864, each with its bound (bytes at 3.35 TB/s, or f32 FMAs at 67
TFLOP/s, or int32 work at the dispatch limit).

Phase 8d trains the other compression strategies on the flagship (bf16,
random tokens, K=16 × 16, 4 steps, H 2): decoupled outer momentum (top-k),
NoLoCo dense and int8, DynamiQ int8 and top-k, DiLoCo with ``codec="int8"``;
each with its steady steps/s and peak memory, every step's ``comm_bytes``
equal to the prediction from the codec's wire bytes, and exact launches of
B1/B2 and of the threefry bits kernel (the int8 rounding: DynamiQ one a hop,
2 a step; NoLoCo and DiLoCo one a node a round). Phase 6 also runs DeMo at
K=8 on a tiny GPT (the dense decode, so D1 on the card and its twin on the
CPU), f32, and prints the update signs that differ between card and CPU
each step. Phase 2 also requires D1 (``scatter_mean_kernel``, warps owning
runs of slots) and its oracle (``scatter_mean_ref_kernel``, the first
kernel) to be built, T1 bits rows' kernel at its 4 groups a lane and for
rows past 2^32 elements and its oracle (``threefry_rows_bits_ref_kernel``),
none with an atomic, and prints their registers, spills and shared memory
and D1's launch plan at config 5's row widths; phase 3 holds D1 to its twin bit for
bit at config 5's three signatures ((G, m, E) = (200, 2048, 4096), (108,
2048, 64), (4, 2048, 2112)) and at m = 64 (K = 2's picks), two runs
bit-identical, and on a planted table (v and −v at one slot give exactly
0.0, an untouched slot +0.0), then holds D1 to its oracle and its twin bit
for bit, twice, each output buffer poisoned first, at those shapes and at
(3, 5000, 9000), (1, 1, 1) and m = 0, with a row's picks in one slot, with
1, 1e8, −1e8 and v, 0, −v in one slot, and with picks outside [0, E)
(against the oracle; the twin takes them sent past the row), and T1 bits
rows to its oracle and its twin likewise at [1, 3], [16, 50304], [80, 65],
[80, 50304], [1, 804864] and [65535, 4], with and without step indices;
phase 7 times D1 in turns with its oracle (new, oracle, oracle, new) at
the four signatures beside its byte bound and the yardstick
``index_put_(accumulate=True)`` twice (sums, counts) and a divide (and the
twin at 64 × 64) and T1 bits rows in turns with its oracle at [16, 50304]
and [80, 50304] with step indices (the sampler), and fails if either is
slower than its oracle at any of them (T1 bits rows at [1, 804864], one
key with no step index as ``generate`` draws it and with one, is timed
beside them and not held: it ties the oracle there); and the bits kernel
at DynamiQ's hop-1 length on the flagship.

Phase 3 also holds the threefry kernels (random bits and the fused
Bernoulli mask, T1) to their plain twin bit for bit at 1, 4097, 786,432
(``wpe``) and 38,633,472 (``wte``) elements and, at 2³² + 4097 elements,
where the counter's high word is 1, on the last 8192; and the card's
permutation to the twin's at 38,633,472; T1's segments (one launch for a
table of keys, sizes and places) on a mixed table (sizes 0, 1, 3, 4, 5,
1023, 4097 and GPT-2 base's 148 leaves), at the CNN's 20 leaves under
SPARTA's keys of phase 9c's 8 steps, and as dropout draws them (a row a
node) at phase 9's dropouts (K = 8 and 2 rows of 64 × 64, 128 and 256
elements, the keys of two steps) and at 32 rows of 4096 and of 191
elements. Phase 7 also times the f32
packed pair at config 4's shape (N=256) and the f32 per-head pair at B3/B4's
shape, each beside f32 SDPA, its plain version, its bound (bytes, or three
times the products at TF32's 495 TFLOP/s: the kernels run split-precision
TF32) and the products at the 67 TFLOP/s of f32 FMAs, for comparison only;
the per-row mask at config 2's dropout shapes and the host's key algebra a
step. The launch counts in the
``kernels`` line are those of the training runs of phases 4 (B1/B2), 5
(B3/B4), 5b (B5, its f32 forward in the evals), 8a (T1), 9b (T1's per-row
entry) and 9d (the f32 B1/B2), and of phase 10's run (a) (B7, R1, L1 with the add, T1's
bits rows), each counted from zero; the packed pair and
B5's forward count their bf16 and f32 kernels apart (every eval runs in
f32); B6 and B7 int8 count 13b's first int8 run; B8's two kernels count
16b's fit (grouped_dot's launches include the ct_x products), their f32
ring kernels 16b's f32 fit; each B8 row also names its kernel, its oracle
and the oracle's time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# f32 products on the tensor cores in split-precision TF32: three TF32
# products each (hopper.cuh); f32 FMAs (67 TFLOP/s) are printed for
# comparison only
TF32_FLOPS = 495e12
TF32_SPLIT = 3
F32_FLOPS = 67e12
# the least time of integer work: an SM dispatches at most one warp instruction
# (32 lanes) a clock from each of its 4 schedulers, 128 lanes a clock, which
# the integer pipe (64 INT32 lanes) and the FMA pipe (which runs IMAD and
# VIADD) share; times the SM count and the card's highest SM clock, both read
# from the card (phase 1). 64 lanes is no ceiling: T1 beat it (PERF.md).
DISPATCH_LANES_PER_SM = 128
# the least int32 work of one Bernoulli mask element: threefry2x32's 20
# rounds of add, rotate and xor, six key injections of two adds and the
# final xor (73), then the mask as an integer test, (bits >> 9) <
# ceil(p·2^23): a shift and a compare
THREEFRY_LEAST_OPS = 73 + 2
FUSED_CU = "gym_tpu_torch/ops/csrc/fused_attention.cu"
FLASH_CU = "gym_tpu_torch/ops/csrc/flash_attention.cu"
THREEFRY_CU = "gym_tpu_torch/ops/csrc/threefry.cu"
SCATTER_CU = "gym_tpu_torch/ops/csrc/scatter_mean.cu"
DECODE_CU = "gym_tpu_torch/ops/csrc/decode_attention.cu"
ROW_CU = "gym_tpu_torch/ops/csrc/row_gemm.cu"
QUANTIZE_CU = "gym_tpu_torch/ops/csrc/quantize_tiles.cu"
B8_CU = "gym_tpu_torch/ops/csrc/grouped_gemm.cu"
NANOGPT_JAX = "gym_tpu/models/nanogpt.py"
# JAX's bundled Pallas TPU kernel, which gym_tpu/ops/flash_attention.py:77,84
# calls for T > 1024
BUNDLED = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# name: (module, wrapper, its launch count, source, TPU kernel it replaces);
# the packed pair counts its bf16 and f32 kernels apart
KERNELS = {
    "B1_fwd_packed": ("fused", "_fwd_packed", "launches_bf16", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:246"),
    "B2_bwd_packed": ("fused", "_bwd_packed", "launches_bf16", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:267"),
    "B3_blk_fwd": ("fused", "_blk_fwd", "launches", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:137"),
    "B4_blk_bwd": ("fused", "_blk_bwd", "launches", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:153"),
    "B5f_flash_fwd": ("flash", "_flash_fwd", "launches_bf16", FLASH_CU,
                      f"{BUNDLED}:758"),
    "B5b_flash_bwd": ("flash", "_flash_bwd", "launches", FUSED_CU,
                      f"{BUNDLED}:1121 and :1456"),
    # no pallas_call: XLA's threefry2x32 lowering of jax.random.bernoulli,
    # which SPARTA's masks reach, all of a step's in one launch
    "T1_threefry_bernoulli": ("threefry", "bernoulli_segments", "launches",
                              THREEFRY_CU, "gym_tpu/strategy/sparta.py:60"),
    # the f32 instantiations of the packed pair: the path of config 4,
    # which trains without autocast, and of every eval
    "B1_fwd_packed_f32": ("fused", "_fwd_packed", "launches_f32", FUSED_CU,
                          "gym_tpu/ops/fused_attention.py:246"),
    "B2_bwd_packed_f32": ("fused", "_bwd_packed", "launches_f32", FUSED_CU,
                          "gym_tpu/ops/fused_attention.py:267"),
    # the f32 long-context forward: every eval of the long-context config
    "B5f_flash_fwd_f32": ("flash", "_flash_fwd", "launches_f32", FLASH_CU,
                          f"{BUNDLED}:758"),
    # T1 with a key per row: flax nn.Dropout's jax.random.bernoulli, one
    # mask a node, drawn for all the nodes in one launch
    "T1_threefry_bernoulli_rows": ("threefry", "bernoulli_rows", "launches",
                                   THREEFRY_CU,
                                   "gym_tpu/models/mnist_cnn.py:36,45"),
    # T1's bits kernel: jax.random.uniform of the codecs' stochastic
    # rounding (XLA's threefry lowering, no pallas_call); on the main path
    # a key shared by a compress call's rows draws its bits once here
    # (DynamiQ's hops)
    "T1_threefry_bits": ("threefry", "random_bits", "launches", THREEFRY_CU,
                         "gym_tpu/strategy/compress.py:121"),
    # T1 bits on its main path: the codec's whole quantize, its threefry
    # bits drawn where the rounding uses them (no pallas_call: XLA's fusion
    # of jax.random.uniform into QuantizeCodec.compress in the jitted step)
    "T1_quantize_tiles": ("quantize_tiles", "quantize_tiles", "launches",
                          QUANTIZE_CU, "gym_tpu/strategy/compress.py:112-126"),
    # no pallas_call: XLA's serial scatter-add of DeMo's dense decode
    "D1_scatter_mean": ("scatter_mean", "scatter_mean_decode", "launches",
                        SCATTER_CU, "gym_tpu/ops/topk_compress.py:83-99"),
    # the serving path (no pallas_call): XLA's einsum-mask-softmax-einsum
    # of the decode attends, its dots of nn.Dense and wte.attend and its
    # nn.LayerNorm under decode=True, and jax.random.categorical's bits
    "B7_decode_attention": ("decode_attention", "decode_attention",
                            "launches", DECODE_CU,
                            f"{NANOGPT_JAX}:370-376 and :478-484"),
    "R1_row_gemm": ("row_linear", "row_linear", "launches", ROW_CU,
                    f"{NANOGPT_JAX}:253 and :662"),
    # L1 with the residual add before it (the oracle L1, row_layer_norm,
    # is off the path)
    "L1_row_add_layer_norm": ("row_linear", "row_add_layer_norm", "launches",
                              ROW_CU, f"{NANOGPT_JAX}:515,519,656"),
    "T1_threefry_bits_rows": ("threefry", "random_bits_rows", "launches",
                              THREEFRY_CU, f"{NANOGPT_JAX}:905"),
    # quantized serving (no pallas_call): XLA's fusion of dequantize_tiles
    # into the dots of quantized_dot and quantized_attend, and of
    # kv_dequantize into the int8 KV attends
    "B6_row_qgemm": ("row_linear", "row_qlinear", "launches", ROW_CU,
                     "gym_tpu/ops/grouped_matmul.py:253 and :265"),
    "B7_decode_attention_int8": ("decode_attention", "decode_attention_int8",
                                 "launches", DECODE_CU,
                                 f"{NANOGPT_JAX}:361-362 and :460-465"),
    # the MoE layers' grouped matmuls (no pallas_call: lax.ragged_dot and
    # its transpose under the MoE fast path, gym_tpu/models/moe.py:137-140);
    # grouped_dot's launches include the ct_x products (w read transposed)
    "B8_grouped_dot": ("grouped_matmul", "grouped_dot", "launches", B8_CU,
                       "gym_tpu/ops/grouped_matmul.py:40-65"),
    "B8_grouped_outer": ("grouped_matmul", "grouped_outer", "launches",
                         B8_CU, "gym_tpu/ops/grouped_matmul.py:75-102"),
    # their f32 launches alone: the ring kernels (grouped_gemm_f32_kernel,
    # grouped_outer_f32_kernel), timed beside their oracle, the first ones
    "B8_grouped_dot_f32": ("grouped_matmul", "grouped_dot", "launches_f32",
                           B8_CU, "gym_tpu/ops/grouped_matmul.py:40-65"),
    "B8_grouped_outer_f32": ("grouped_matmul", "grouped_outer",
                             "launches_f32", B8_CU,
                             "gym_tpu/ops/grouped_matmul.py:75-102"),
}
# the kernels a JSON row of B8 times, and the oracle timed beside them
B8_ORACLES = {
    "B8_grouped_dot": ("tc::grouped_gemm_kernel", "grouped_gemm_ref_kernel"),
    "B8_grouped_outer": ("tc::grouped_outer_kernel",
                         "grouped_outer_ref_kernel"),
    "B8_grouped_dot_f32": ("f32::grouped_gemm_f32_kernel",
                           "grouped_gemm_f32_ref_kernel"),
    "B8_grouped_outer_f32": ("f32::grouped_outer_f32_kernel",
                             "grouped_outer_f32_ref_kernel")}
# GPT-2 base (12L/12H/768, vocab 50304, T=1024), phases 5 and 8
GPT2_BASE = dict(block_size=1024, vocab_size=50304, n_layer=12, n_head=12,
                 n_embd=768, attn_impl="flash")
# the bits of the (fold_in(fold_in(PRNGKey(7), leaf), 0), step) keys
# SPARTA's masks use; three leaves and steps for phase 3
THREEFRY_KEYS = ((0, 0), (146, 3), (37, 1000))
THREEFRY_N = (1, 4097, 786_432, 38_633_472)  # 38,633,472: GPT-2 base wte
# stated tolerances, kernel against plain version on the same inputs:
# |a − b| <= atol + rms_frac·rms(b) + rtol·|b| elementwise, rms(b) the root
# mean square of the plain version's tensor (o and the gradients shrink as T
# grows: at T=8192 a typical element is about 0.02-0.05). bf16: p and ds are
# rounded to bf16 at the same points in both, but a value on a rounding
# boundary can go either way when the f32 sums differ in order: rtol covers
# two bf16 steps of an element, the rms part such a flip on an element near
# zero (the kernels need at most 0.019 rms at phase 3's shapes; PERF.md has
# the measurement and the planted faults this tolerance fails).
TOL = {"bfloat16": {"out": (0.0, 5e-2, 2e-2),
                    "lse": (1e-4, 0.0, 1e-5)},
       "float32": {"out": (5e-5, 0.0, 1e-4), "lse": (1e-5, 0.0, 1e-6)}}
# card against CPU, per-step train loss: bf16 compute rounds differently
# in cuBLAS and the CPU kernels; f32 differs by summation order only
LOSS_RTOL = {"bf16": 1e-2, "f32": 1e-4}
# the docs stream of the checkout's gym_tpu/: tokens and crc32 of its bytes
DOCS_TOKENS, DOCS_CRC = 279_562, 1349009140


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def int32_rate(torch) -> float:
    """int32 instructions a second at the dispatch limit: 128 lanes a clock
    on each SM at the card's highest SM clock (``nvidia-smi``)."""
    mhz = max_sm_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = DISPATCH_LANES_PER_SM * sms * mhz * 1e6
    log(f"  {sms} SMs, highest SM clock {mhz:.0f} MHz: int32 instructions "
        f"at the dispatch limit {rate / 1e12:.2f} TOP/s")
    return rate


# -- phase 2: what the compiler made ----------------------------------------

SASS_OPS = ("HGMMA", "HMMA", "FFMA", "ATOM/RED", "ALU")
# per-thread integer and float-compare ALU instructions (the uniform
# datapath's U* instructions run once a warp and are not counted)
ALU_OPS = {"IADD3", "IADD", "VIADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF",
           "SHL", "SHR", "ISETP", "LEA", "PRMT", "SEL", "IMNMX", "VIMNMX",
           "IABS", "FADD", "FSETP", "FSEL", "FMUL"}
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*)")


def sass_counts(nvcc, lib_path):
    """{kernel: {op: count}} from ``cuobjdump -sass`` of the library."""
    bindir = os.path.dirname(nvcc)
    out = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                          lib_path], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS + ("ROT",), 0)
            continue
        m = _SASS_INSN.match(line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op in ("ATOM", "ATOMS", "ATOMG", "RED", "REDG"):
            op = "ATOM/RED"
        if op in ALU_OPS:
            counts[name]["ALU"] += 1
        if "SHF.L.W" in line:  # a 32-bit rotate: a funnel shift that wraps
            counts[name]["ROT"] += 1
        if op in counts[name]:
            counts[name][op] += 1
    check(counts, "cuobjdump listed no kernels")
    return dict(zip(demangle(nvcc, list(counts)), counts.values()))


def demangle(nvcc, names):
    """``names`` demangled by ``cu++filt`` (or ``c++filt``), else as
    given."""
    bindir = os.path.dirname(nvcc)
    for tool in (os.path.join(bindir, "cu++filt"), "c++filt"):
        try:
            dem = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if dem.returncode == 0 and len(dem.stdout.splitlines()) == len(names):
            return dem.stdout.splitlines()
    return names


# kernels the f32 long-context forward and T1's segments replaced
GONE = ("flash_fwd_kernel", "threefry_rows_kernel", "threefry_kernel<true>",
        "threefry_kernel<(bool)1>")


def check_sass(counts):
    """Every bf16 wgmma kernel and every f32 3xTF32 kernel uses the tensor
    cores; no kernel has an atomic; the replaced kernels are gone."""
    wgmma = [k for k in counts if "wgmma" in k]
    check(len(wgmma) == 16, f"expected 16 bf16 wgmma kernels (forward, dq, "
          f"dk/dv and the long-context forward at 4 head dims), found "
          f"{len(wgmma)}: {wgmma}")
    flash = [k for k in wgmma if "flash_fwd_wgmma" in k]
    check(len(flash) == 4, f"expected flash_fwd_wgmma at 4 head dims, found "
          f"{flash}")
    # the products of the f32 kernels; the long-context forward's pre-pass
    # (split_kv_tf32x3) only splits k and v
    tf32 = [k for k in counts if "tf32x3" in k and "split_kv" not in k]
    check(len(tf32) == 32, f"expected 32 f32 3xTF32 kernels (forward, dq, "
          f"dk/dv and the long-context forward at 4 head dims and 2 copy "
          f"widths), found {len(tf32)}: {tf32}")
    # the head dim: the first template argument, demangled or not
    long_f32 = {re.search(r"flash_fwd_tf32x3(?:<\D*|ILi)(\d+)", k).group(1)
                for k in tf32 if "flash_fwd_tf32x3" in k}
    check(long_f32 == {"16", "32", "64", "128"}, f"expected "
          f"flash_fwd_tf32x3 at D = 16, 32, 64, 128, found {long_f32}")
    gone = [k for k in counts if any(g in k for g in GONE)]
    check(not gone, f"replaced kernels still built: {gone}")
    for name in ("scatter_mean_kernel", "scatter_mean_ref_kernel"):
        d1 = [k for k in counts if name in k]
        check(len(d1) == 1, f"expected D1's {name}, found {d1}")
    for k in sorted(counts):
        c = counts[k]
        log("  " + k + ": " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
        check(c["ATOM/RED"] == 0, f"{k}: {c['ATOM/RED']} atomic instructions")
        if k in wgmma or k in tf32:
            check(c["HGMMA"] > 0, f"{k}: no HGMMA (wgmma) instruction")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores")
_TF32_KERNEL = re.compile(
    r"(attn_fwd|attn_dq|attn_dkdv|flash_fwd|split_kv)_tf32x3ILi(\d+)ELi(\d+)E")


def f32_kernel_report(build_log, lib):
    """The f32 (3xTF32) kernels' registers and spill stores from the
    ``ptxas`` report, and their dynamic shared memory, a line per head
    dim."""
    found, name = {}, None
    for line in build_log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name, spill = _TF32_KERNEL.search(m.group(1)), 0
            continue
        m = _PTXAS_SPILL.search(line)
        if m and name:
            spill = int(m.group(1))
        m = _PTXAS_USED.search(line)
        if m and name:
            kind, d, vec = name.groups()
            found[(kind, int(d), int(vec))] = (int(m.group(1)), spill)
            name = None
    # dynamic shared memory (gym_attn_smem_bytes); the pre-pass has static
    # shared memory only (the ptxas report)
    smem_id = {"attn_fwd": 0, "attn_dkdv": 1, "attn_dq": 2, "flash_fwd": 3}

    def copies(kind, d, vec):
        regs, spill = found.get((kind, d, vec), ("?", "?"))
        return (f"{16 if vec == 4 else 4}-byte copies {regs} registers "
                f"{spill} B spilled")

    for d in (16, 32, 64, 128):
        log(f"  f32 3xTF32 kernels at D={d}: " + "; ".join(
            f"{kind}"
            + (f" {lib.gym_attn_smem_bytes(smem_id[kind], d)} B smem"
               if kind in smem_id else "")
            + f", {copies(kind, d, 4)}, {copies(kind, d, 1)}"
            for kind in ("attn_fwd", "attn_dq", "attn_dkdv", "split_kv",
                         "flash_fwd")))


# -- phase 3: kernels against plain versions --------------------------------


def compare(name, got, ref, kind, dtype):
    atol, frac, rtol = TOL[str(dtype).replace("torch.", "")][kind]
    a, b = got.float(), ref.float()
    err = (a - b).abs()
    rms = b.square().mean().sqrt().item()
    over = err - rtol * b.abs()  # what atol has to cover
    bad = (over > atol + frac * rms).sum().item()
    mx = err.max().item()
    log(f"  {name}: max_abs_err {mx:.3e}, rms {rms:.3e}, largest |a-b| - "
        f"rtol|b| {over.max().item() / rms:.2e} rms (atol {atol} + "
        f"{frac} rms, rtol {rtol}) "
        f"{'ok' if bad == 0 else f'{bad} elements outside'}")
    check(bad == 0 and math.isfinite(mx), f"{name} disagrees with its "
          f"plain version")
    return mx


def per_head_views(torch, g, n, h, t, d, dtype):
    """q, k, v as [N, H, T, D] views of one [N, T, 3·H·D] projection (token
    stride 3C, as the model passes them) and a random cotangent."""
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g).to(dtype)
    heads = [z.view(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dtype)
    return heads, do


def check_long_context(torch, tflash, shapes, g, dtype):
    """B5 forward and backward against their plain versions; the largest
    error of each at the slice's shape (the first in ``shapes``)."""
    dn = str(dtype).replace("torch.", "")
    errs = []
    for n, h, t, d in shapes:
        heads, do = per_head_views(torch, g, n, h, t, d, dtype)
        scale = 1.0 / math.sqrt(d)
        log(f"B5 long-context {dn} N={n} H={h} T={t} D={d} "
            f"(per-head views, blocks {tflash._block_sizes(t, d)}):")
        o, lse = tflash._flash_fwd(*heads, scale)
        ro, rl = tflash.plain_flash_fwd(*heads, scale)
        ef = max(compare("B5f o", o, ro, "out", dtype),
                 compare("B5f lse", lse, rl, "lse", dtype))
        if not errs:
            o2, lse2 = tflash._flash_fwd(*heads, scale)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            log(f"  B5f {dn} run twice: o, lse "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(same, f"B5f: two runs of the {dn} forward differ")
            del o2, lse2
        got = tflash._flash_bwd(*heads, o, do, lse, scale)
        ref = tflash.plain_flash_bwd(*heads, o, do, lse, scale)
        eb = max(compare(f"B5b {nm}", a, b, "out", dtype)
                 for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
        if dtype == torch.bfloat16 and not errs:
            again = tflash._flash_bwd(*heads, o, do, lse, scale)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  B5b bf16 run twice: dq, dk, dv "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(same, "B5b: two runs of the bf16 backward differ")
            del again
        errs.append((ef, eb))
        del heads, do, o, lse, ro, rl, got, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs[0]


def same_twice(torch, name, first, again):
    """Two runs of a kernel on the same inputs: identical outputs."""
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {name} run twice: {'bit-identical' if same else 'DIFFER'}")
    check(same, f"{name}: two runs on the same inputs differ")


def check_kernels(torch, tfa, tflash, shapes):
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        n, t, c, h = shapes["flagship"]
        scale = 1.0 / math.sqrt(c // h)
        qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g).to(dtype)
        q, k, v = qkv.split(c, dim=-1)
        do = torch.randn(n, t, c, device="cuda", generator=g).to(dtype)
        log(f"B1/B2 packed {dn} N={n} T={t} C={c} H={h} (strided views):")
        o, lse = tfa._fwd_packed(q, k, v, scale, h)
        ro, rl = tfa.plain_fwd_packed(q, k, v, scale, h)
        e1 = max(compare("B1 o", o, ro, "out", dtype),
                 compare("B1 lse", lse, rl, "lse", dtype))
        got = tfa._bwd_packed(q, k, v, o, do, lse, scale, h)
        ref = tfa.plain_bwd_packed(q, k, v, o, do, lse, scale, h)
        e2 = max(compare(f"B2 {nm}", a, b, "out", dtype)
                 for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
        if dtype == torch.float32:
            same_twice(torch, "B1 f32 o, lse", (o, lse),
                       tfa._fwd_packed(q, k, v, scale, h))
            same_twice(torch, "B2 f32 dq, dk, dv", got,
                       tfa._bwd_packed(q, k, v, o, do, lse, scale, h))
        del qkv, q, k, v, do, o, lse, ro, rl, got, ref
        torch.cuda.empty_cache()

        n, h, t, d = shapes["base"]
        e3 = e4 = 0.0
        for causal in (True, False):
            qkv = torch.randn(n, t, 3 * h * d, device="cuda",
                              generator=g).to(dtype)
            heads = [z.reshape(n, t, h, d).transpose(1, 2)
                     for z in qkv.split(h * d, dim=-1)]
            do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dtype)
            dlse = (None if causal else
                    torch.randn(n, h, t, 1, device="cuda", generator=g))
            log(f"B3/B4 per-head {dn} N={n} H={h} T={t} D={d} "
                f"causal={causal} dlse={'random' if dlse is not None else 0}:")
            o, lse = tfa._blk_fwd(*heads, 0.125, causal)
            ro, rl = tfa.plain_fwd(*heads, 0.125, causal)
            ef = max(compare("B3 o", o, ro, "out", dtype),
                     compare("B3 lse", lse, rl, "lse", dtype))
            got = tfa._blk_bwd(*heads, o, do, lse, dlse, 0.125, causal)
            ref = tfa.plain_bwd(*heads, o, do, lse, dlse, 0.125, causal)
            eb = max(compare(f"B4 {nm}", a, b, "out", dtype)
                     for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
            if dtype == torch.float32:
                same_twice(torch, "B3 f32 o, lse", (o, lse),
                           tfa._blk_fwd(*heads, 0.125, causal))
                same_twice(torch, "B4 f32 dq, dk, dv", got, tfa._blk_bwd(
                    *heads, o, do, lse, dlse, 0.125, causal))
            if causal:
                e3, e4 = ef, eb
            del qkv, heads, do, dlse, o, lse, ro, rl, got, ref
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        e5f, e5b = check_long_context(
            torch, tflash, (shapes["long"], shapes["long_tuned_blocks"],
                            shapes["long_default_blocks"]), g, dtype)
        if dtype == torch.bfloat16:  # the training runs' dtype
            errs.update(B1_fwd_packed=e1, B2_bwd_packed=e2, B3_blk_fwd=e3,
                        B4_blk_bwd=e4, B5f_flash_fwd=e5f, B5b_flash_bwd=e5b)
        else:  # the evals' long-context forward
            errs["B5f_flash_fwd_f32"] = e5f
    return errs


def threefry_ops_per_element(counts):
    """ALU instructions of the Bernoulli mask kernel per element, counted
    from its SASS, a diagnostic beside the bound's THREEFRY_LEAST_OPS: every
    threefry evaluation has exactly 20 rotations (``SHF.L.W``), so the
    kernel's ALU count over its rotations / 20 is the work of one element,
    the loop's and the last group's instructions shared out among the
    evaluations."""
    name = [k for k in counts if "threefry_segments_kernel" in k]
    check(len(name) == 1, f"expected one Bernoulli mask kernel in the "
          f"SASS, found {name}")
    c = counts[name[0]]
    check(c["ROT"] >= 20 and c["ROT"] % 20 == 0, f"T1: {c['ROT']} "
          f"rotations are not whole threefry evaluations")
    evals = c["ROT"] // 20
    ops = c["ALU"] / evals
    log(f"  T1 {name[0]}: {c['ALU']} ALU instructions, {c['ROT']} rotations "
        f"= {evals} threefry evaluations in the code (4 a group), {ops:.2f} "
        f"an element (the least, which the bound counts: "
        f"{THREEFRY_LEAST_OPS})")
    check(THREEFRY_LEAST_OPS <= ops <= 160, f"T1: {ops} ALU instructions an element is "
          f"outside 73-160")
    return ops


def threefry_key(tf, leaf, step, seed=7):
    return tf.fold_in(tf.fold_in(tf.fold_in(tf.PRNGKey(seed), leaf), 0),
                      step)


# the mixed table's own segment sizes: empty, shorter than a group, one
# group, a group and one, and lengths that end inside a group
SEGMENT_SIZES = [0, 1, 3, 4, 5, 1023, 4097]


def hold_segments(torch, tf, keys, p, sizes, what):
    """One ``bernoulli_segments`` launch against the twin's masks, segment
    by segment; every segment 16-byte aligned. Returns the elements that
    differ (0)."""
    before = tf.bernoulli_segments.launches
    buf, views = tf.bernoulli_segments(keys, p, sizes, "cuda")
    check(tf.bernoulli_segments.launches == before + 1,
          f"T1 segments {what}: not one launch")
    refs = tf.plain_bernoulli_segments(keys, p, sizes, "cuda")
    diff = 0
    for i, (got, ref) in enumerate(zip(views, refs)):
        check((got.data_ptr() - buf.data_ptr()) % 16 == 0,
              f"T1 segments {what}: segment {i} not 16-byte aligned")
        diff += int((got != ref).sum())
    check(diff == 0, f"T1 segments {what}: {diff} elements differ from the "
          f"twin")
    return diff


def check_threefry(torch, tf):
    """The bits and mask kernels against the plain twin, bit for bit, and
    the card's permutation against the twin's (the twin runs on the card
    here too, for speed). Returns the largest |kernel − twin| (0)."""
    worst = 0
    for n in THREEFRY_N:
        for leaf, step in THREEFRY_KEYS:
            key = threefry_key(tf, leaf, step)
            got = tf.random_bits(key, n, "cuda")
            ref = tf.plain_random_bits(key, n, "cuda")
            diff = int((got != ref).sum())
            worst = max(worst, diff)
            check(diff == 0, f"T1 bits n={n} key {key}: {diff} elements "
                  f"differ from the twin")
            for p in (0.005, 0.5):
                got = tf.bernoulli(key, p, n, "cuda")
                ref = tf.plain_bernoulli(key, p, n, "cuda")
                diff = int((got != ref).sum())
                worst = max(worst, diff)
                check(diff == 0, f"T1 mask n={n} p={p} key {key}: {diff} "
                      f"elements differ from the twin")
            del got, ref
        log(f"  T1 threefry n={n}: bits and masks (p 0.005, 0.5) of "
            f"{len(THREEFRY_KEYS)} keys bit-identical to the twin")
    # past 2^32 elements the counter's hi word is 1: the mask kernel's last
    # elements against the twin at those indices (4 GiB of mask)
    n = 2 ** 32 + 4097
    key = threefry_key(tf, 146, 3)
    tail = tf.bernoulli(key, 0.5, n, "cuda")[-8192:]
    idx = torch.arange(n - 8192, n, dtype=torch.int64, device="cuda")
    ref = tf.bits_to_uniform(tf.plain_bits_at(key, idx)) < 0.5
    diff = int((tail != ref).sum())
    worst = max(worst, diff)
    log(f"  T1 threefry n={n}: the last 8192 elements "
        f"{'bit-identical to' if diff == 0 else 'DIFFER FROM'} the twin")
    check(diff == 0, f"T1 mask past 2^32: {diff} elements differ")
    del tail, idx, ref
    # T1's segments: a mixed table, then SPARTA's masks of the CNN's leaves
    # over phase 9c's 8 steps, each step one launch as SPARTA draws them
    sizes = SEGMENT_SIZES + [n for _, n in gpt_leaves(GPT2_BASE)]
    keys = [threefry_key(tf, i, 3) for i in range(len(sizes))]
    for p in (0.005, 0.5):
        worst = max(worst, hold_segments(torch, tf, keys, p, sizes,
                                         f"mixed table p={p}"))
    log(f"  T1 segments: one launch for {len(sizes)} segments (sizes "
        f"{SEGMENT_SIZES} and GPT-2 base's {len(sizes) - len(SEGMENT_SIZES)}"
        f" leaves), p 0.005 and 0.5: bit-identical to the twin, each "
        f"segment 16-byte aligned")
    leaves = cnn_leaves()
    for step in range(8):
        keys = [threefry_key(tf, leaf, step) for leaf, _ in leaves]
        worst = max(worst, hold_segments(
            torch, tf, keys, 0.005, [n for _, n in leaves],
            f"CNN leaves step {step}"))
    log(f"  T1 segments at the CNN's {len(leaves)} SPARTA leaves "
        f"({min(n for _, n in leaves)}-{max(n for _, n in leaves)} "
        f"elements), p 0.005, steps 0-7, one launch a step: bit-identical "
        f"to the twin")
    torch.cuda.empty_cache()
    n = THREEFRY_N[-1]
    key = threefry_key(tf, 0, 0)
    perm = tf.permutation(key, n, "cuda")
    twin = torch.arange(n, dtype=torch.int64, device="cuda")
    for _ in range(tf.sort_rounds(n)):
        key, sub = tf.split(key)
        bits = tf.plain_random_bits(sub, n, "cuda") ^ -0x80000000
        twin = twin[torch.sort(bits, stable=True).indices]
    same = torch.equal(perm, twin)
    log(f"  permutation n={n} ({tf.sort_rounds(n)} sort rounds): card "
        f"{'equals' if same else 'DIFFERS FROM'} the twin")
    check(same, "permutation on the card differs from the twin")
    del perm, twin
    torch.cuda.empty_cache()
    return float(worst)


def check_threefry_bits_path(torch, tf, flagship):
    """The bits kernel against its twin, bit for bit, at the keys of phase
    8d's codec calls (``codec_draws``), each key's draw over its call's
    row length padded to whole tiles: DynamiQ's shared hop keys (the draws
    its codec calls read) and NoLoCo's and DiLoCo's per-node link keys
    (the codec kernel's oracle's draws). Returns the largest |kernel −
    twin| (0)."""
    draws = []                                   # (what, key, length)
    for what, _, n, keys in codec_draws(flagship):
        length = -(-n // 256) * 256
        if isinstance(keys, list):
            draws += [(f"{what} node {i}", key, length)
                      for i, key in enumerate(keys)]
        else:
            draws.append((what, keys, length))
    n = flagship_params(flagship)
    shard = -(-n // 16)
    hop1, hop2 = -(-n // 256) * 256, -(-shard // 256) * 256
    worst = 0
    for what, key, length in draws:
        got = tf.random_bits(key, length, "cuda").to(torch.int64)
        ref = tf.plain_random_bits(key, length, "cuda").to(torch.int64)
        err = int((got - ref).abs().max())
        worst = max(worst, err)
        check(err == 0, f"T1 bits {what} ({length} elements): max |kernel "
              f"- twin| {err}")
    log(f"  T1 bits at phase 8d's draws ({n} params a node, K=16, "
        f"steps 0-3): {len(draws)} draws, DynamiQ's shared hop "
        f"keys at {hop1} and {hop2} elements and NoLoCo's and DiLoCo's "
        f"per-node keys at {hop1}: bit-identical to the twin")
    torch.cuda.empty_cache()
    return float(worst)


def codec_draws(flagship, nodes=16, steps=4):
    """Phase 8d's codec calls on the flagship: (what, rows, n, keys) of
    DynamiQ's shared hop keys at hop 1 (the flat gradient) and hop 2 (a
    node's shard) and of NoLoCo's and DiLoCo's per-node link keys at hop
    1's length, over the phase's steps."""
    from gym_tpu_torch.strategy import (DiLoCoStrategy, DynamiQStrategy,
                                        NoLoCoStrategy, OptimSpec)
    from gym_tpu_torch.strategy.compress import hop_keys
    adamw = OptimSpec("adamw", lr=3e-4)
    n = flagship_params(flagship)
    shard = -(-n // nodes)
    dynamiq = DynamiQStrategy(adamw, codec="int8")
    draws = []
    for step in range(steps):
        k1, k2 = hop_keys(dynamiq.seed, step)
        draws += [(f"DynamiQ hop 1 step {step}", nodes, n, k1),
                  (f"DynamiQ hop 2 step {step}", nodes, shard, k2)]
        for title, strat in (("NoLoCo", NoLoCoStrategy(adamw, codec="int8")),
                             ("DiLoCo", DiLoCoStrategy(adamw, codec="int8"))):
            link = strat.communication_modules[0].link
            draws.append((f"{title} step {step}", nodes, n,
                          link.node_keys(step, nodes)))
    return draws


def special_tiles(torch, x, tile, seed):
    """x [R, n] with, in each row, a zero tile, a NaN, ±inf, a tile scaled
    by 1e37, a -0.0 tile and one scaled by 1e-30 (tiles picked from the
    seed)."""
    t = -(-x.shape[1] // tile)
    gen = torch.Generator().manual_seed(seed)
    for r in range(x.shape[0]):
        for k, tt in enumerate(torch.randperm(t, generator=gen)[:6].tolist()):
            a, b = tt * tile, min(x.shape[1], (tt + 1) * tile)
            if k == 0:
                x[r, a:b] = 0.0
            elif k == 1:
                x[r, (a + b) // 2] = float("nan")
            elif k == 2:
                x[r, a], x[r, b - 1] = float("inf"), float("-inf")
            elif k == 3:
                x[r, a:b] *= 1e37
            elif k == 4:
                x[r, a:b] = -0.0
            else:
                x[r, a:b] *= 1e-30
    return x


def check_quantize_tiles(torch, tqt, tf, flagship):
    """T1 bits on its main path against its plain version and against the
    first bits kernel's uniform followed by the plain quantize, bit for bit
    (q and the scales' bits), two launches each: phase 8d's codec calls,
    then tiles 7 and 64 at n =
    4097, int4, rounding to nearest, an unaligned x and tiles of zeros,
    NaN, ±inf, huge, -0.0 and tiny values at tiles 256, 64 and 7. Returns
    the largest |q − plain q| (0)."""
    g = torch.Generator(device="cuda").manual_seed(18)
    cases = [(what, rows, n, 256, 127, keys, True, False)
             for what, rows, n, keys in codec_draws(flagship)]
    base = tf.fold_in(tf.PRNGKey(2602), 5)
    per_row = [tf.fold_in(base, i) for i in range(3)]
    for tile in (7, 64, 256):
        for qmax in (127, 7):
            for keys, stochastic in ((per_row, True), (base, True),
                                     (None, False)):
                kind = ("rows" if keys is per_row else "shared"
                        if stochastic else "nearest")
                for special in (False, True):
                    cases.append((f"tile {tile} int{8 if qmax == 127 else 4}"
                                  f" {kind}{' special' if special else ''}",
                                  3, 4097 if tile != 256 else 4096, tile,
                                  qmax, keys, stochastic, special))
    worst = 0
    for what, rows, n, tile, qmax, keys, stochastic, special in cases:
        x = torch.randn(rows, n, device="cuda", generator=g) * 3
        if special:
            x = special_tiles(torch, x, tile, len(what))
        runs = [tqt.quantize_tiles(x, keys, qmax, tile, stochastic)
                for _ in range(2)]
        plain = tqt.plain_quantize_tiles(x, keys, qmax, tile, stochastic)
        ref = tqt.quantize_tiles_ref(x, keys, qmax, tile, stochastic)
        for i, (q, sc) in enumerate(runs + [ref]):
            err = int((q.int() - plain[0].int()).abs().max())
            scales = int((sc.view(torch.int32)
                          != plain[1].view(torch.int32)).sum())
            worst = max(worst, err)
            check(err == 0 and scales == 0,
                  f"T1_quantize_tiles {what} [{rows}, {n}] tile {tile}: "
                  f"{'run ' + str(i) if i < len(runs) else 'the composition'}"
                  f" differs from the plain version (max |q - plain| {err}, "
                  f"{scales} scales)")
    buf = torch.randn(3 * 1024 + 1, device="cuda", generator=g)
    x = buf[1:].view(3, 1024)
    q, sc = tqt.quantize_tiles(x, per_row, 127, 256)
    plain = tqt.plain_quantize_tiles(x, per_row, 127, 256)
    check(torch.equal(q, plain[0]) and same_bits(torch, sc, plain[1]),
          "T1_quantize_tiles on an unaligned x differs from the plain "
          "version")
    calls = sum(1 for c in cases if c[3] == 256 and c[1] == 16)
    log(f"  T1_quantize_tiles at phase 8d's {calls} codec calls ([16, {flagship_params(flagship)}] and DynamiQ's hop "
        f"2 shards) and {len(cases) - calls} "
        f"cases at tiles 7, 64 and 256, int8 and int4, keys a row, shared "
        f"and to nearest, with zero, NaN, inf, huge, -0.0 and tiny tiles, "
        f"and an unaligned x: two launches each bit-identical to the plain "
        f"version and to the first bits kernel's composition")
    torch.cuda.empty_cache()
    return float(worst)


# D1 at config 5's three tile signatures (64 nodes × top-k 32 = 2048 picks a
# chunk row) and at K = 2's 64 picks: (rows G, picks m, slots E)
D1_SHAPES = ((200, 2048, 4096), (108, 2048, 64), (4, 2048, 2112),
             (200, 64, 4096))


def same_bits(torch, a, b):
    """Bit-identical f32 tensors (NaN patterns and signed zeros included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_scatter_mean(torch, tsm):
    """D1 against its twin bit for bit at ``D1_SHAPES`` (random slots, so
    a 64-slot row holds 32 picks a slot), two runs bit-identical, and a
    planted row: v and −v at one slot with picks between them give exactly
    0.0, an untouched slot +0.0. Returns the largest |kernel − twin| (0)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    for rows, m, e in D1_SHAPES:
        idx = torch.randint(0, e, (rows, m), device="cuda", generator=g,
                            dtype=torch.int32)
        val = torch.randn(rows, m, device="cuda", generator=g)
        got = tsm.scatter_mean_decode(idx, val, e)
        ref = tsm.plain_scatter_mean_decode(idx, val, e)
        check(same_bits(torch, got, ref), f"D1 (G, m, E) = ({rows}, {m}, "
              f"{e}): {int((got != ref).sum())} slots differ from the twin")
        check(same_bits(torch, got, tsm.scatter_mean_decode(idx, val, e)),
              f"D1 ({rows}, {m}, {e}): two runs differ")
        log(f"  D1 scatter-mean (G, m, E) = ({rows}, {m}, {e}): "
            f"bit-identical to the twin; two runs bit-identical")
    idx = torch.randint(0, 4096, (3, 2048), device="cuda", generator=g,
                        dtype=torch.int32)
    val = torch.randn(3, 2048, device="cuda", generator=g)
    idx[1] = torch.where(idx[1] < 2, 2, idx[1])
    idx[1, [0, 1000, 2047]] = 0
    val[1, 1000] = 0.0
    val[1, 2047] = -val[1, 0]
    out = tsm.scatter_mean_decode(idx, val, 4096)
    check(out[1, 0].item() == 0.0, f"D1: v, 0 and −v at one slot gave "
          f"{out[1, 0].item()!r}, not 0.0")
    check(out[1, 1].view(torch.int32).item() == 0, f"D1: an untouched slot "
          f"gave {out[1, 1].item()!r}, not +0.0")
    check(same_bits(torch, out, tsm.plain_scatter_mean_decode(idx, val,
                                                              4096)),
          "D1 planted table differs from the twin")
    log("  D1 planted table: v, 0, −v at one slot decode to exactly 0.0, "
        "an untouched slot to +0.0, bit-identical to the twin")
    torch.cuda.empty_cache()
    return 0.0


# D1's second kernel against its oracle: D1_SHAPES, a row of more picks
# than a warp's chunk and more slots than a block's run, one slot, no picks
D1_ORACLE_CASES = D1_SHAPES + ((3, 5000, 9000), (1, 1, 1), (5, 0, 64))


def poison(torch, nbytes):
    """0xFF bytes through a block of ``nbytes`` that is freed at once: the
    caching allocator hands it to the next output of that size, so an
    element a kernel never writes shows as NaN or -1, not as an earlier
    call's value."""
    torch.full((nbytes,), 0xFF, dtype=torch.uint8, device="cuda")


def check_d1_oracle(torch, tsm):
    """D1 (the second kernel) bit for bit its oracle (the first kernel)
    and its twin, two runs bit-identical, each output buffer poisoned
    first: at ``D1_ORACLE_CASES``; a row's picks all in one slot (E = 1, 64,
    4096); 1, 1e8, −1e8 and v, 0, −v in one slot, in one batch of 32 and
    across chunks (their sums 0 and exactly 0.0); picks at −1, −2³¹, E and
    2³¹ − 1 (the twin sees them sent to a slot past the row's: its
    ``scatter_add_`` would trip a device-side assert on them)."""
    g = torch.Generator(device="cuda").manual_seed(12)

    def hold(idx, val, e, what, twin=None):
        runs = []
        for _ in range(2):
            poison(torch, idx.shape[0] * e * 4)
            runs.append(tsm.scatter_mean_decode(idx, val, e))
        ref = tsm.scatter_mean_decode_ref(idx, val, e)
        if twin is None:
            twin = tsm.plain_scatter_mean_decode(idx, val, e)
        ok = [same_bits(torch, runs[0], runs[1]),
              same_bits(torch, runs[0], ref), same_bits(torch, runs[0], twin)]
        log(f"  D1 {what}: {'bit-identical to' if ok[1] else 'DIFFERS from'} "
            f"the oracle, {'bit-identical to' if ok[2] else 'DIFFERS from'} "
            f"the twin; two runs {'bit-identical' if ok[0] else 'DIFFER'}")
        check(all(ok), f"D1 {what}: the second kernel is not its oracle "
              f"and its twin bit for bit, twice")
        return runs[0]

    for rows, m, e in D1_ORACLE_CASES:
        idx = torch.randint(0, e, (rows, m), device="cuda", generator=g,
                            dtype=torch.int32)
        val = torch.randn(rows, m, device="cuda", generator=g)
        hold(idx, val, e, f"(G, m, E) = ({rows}, {m}, {e})")
    for e in (1, 64, 4096):
        val = torch.randn(3, 2048, device="cuda", generator=g)
        idx = torch.full((3, 2048), e - 1, dtype=torch.int32, device="cuda")
        idx[1] = 0
        hold(idx, val, e, f"(3, 2048, {e}), a row's picks in one slot")
    idx = torch.randint(2, 64, (2, 4096), device="cuda", generator=g,
                        dtype=torch.int32)
    val = torch.randn(2, 4096, device="cuda", generator=g)
    for row, (a, b, c) in enumerate(((0, 1, 2), (5, 700, 4000))):
        idx[row, [a, b, c]] = 0
        val[row, [a, b, c]] = torch.tensor([1.0, 1e8, -1e8], device="cuda")
        idx[row, [a + 3, b + 3, c + 3]] = 1
        val[row, [a + 3, b + 3, c + 3]] = torch.tensor([0.37, 0.0, -0.37],
                                                       device="cuda")
    out = hold(idx, val, 64, "1, 1e8, -1e8 and v, 0, -v in one slot")
    check(bool((out[:, :2] == 0.0).all()), f"D1: 1, 1e8, -1e8 or v, 0, -v "
          f"did not sum to 0: {out[:, :2].tolist()}")
    idx = torch.randint(0, 2112, (4, 2048), device="cuda", generator=g,
                        dtype=torch.int32)
    val = torch.randn(4, 2048, device="cuda", generator=g)
    bad = torch.tensor([-1, -2 ** 31, 2112, 2 ** 31 - 1], dtype=torch.int32,
                       device="cuda")
    idx[:, ::7] = bad.repeat(75)[:idx[:, ::7].shape[1]]
    keep = (idx >= 0) & (idx < 2112)
    hold(idx, val, 2112, "(4, 2048, 2112) with picks outside [0, E)",
         twin=tsm.plain_scatter_mean_decode(torch.where(keep, idx, 2112),
                                            val, 2113)[:, :2112].contiguous())
    torch.cuda.empty_cache()


def dropout_tables(tf, nodes, step, n_micro=4, seed=0):
    """A step's dropout key tables as the training step derives them from
    the K node keys: [microbatch][dropout] of [K, 2]."""
    from gym_tpu_torch.train_node import micro_keys
    mk = micro_keys(tf.node_keys(seed, nodes), step, n_micro)
    return [tf.fold_in_paths(mk[i], cnn_dropout_paths())
            for i in range(n_micro)]


def check_threefry_rows(torch, tf):
    """The per-row mask kernel against its twin, bit for bit: at phase 9's
    dropouts (a step's 3 × 4 launches at a microbatch of 64, K = 8 and
    K = 2, two steps), and at 32 rows of 4096 elements (aligned rows) and
    of 191 (rows that start unaligned)."""
    import numpy as np
    worst = 0

    def hold(keys, p, n, what):
        nonlocal worst
        got = tf.bernoulli_rows(keys, p, n, "cuda")
        ref = tf.plain_bernoulli_rows(keys, p, n, "cuda")
        diff = int((got != ref).sum())
        worst = max(worst, diff)
        check(diff == 0, f"T1 rows {what} n={n} p={p}: {diff} elements "
              f"differ from the twin")

    for nodes in (8, 2):
        for step in (0, 3):
            for sites in dropout_tables(tf, nodes, step):
                for keys, (width, keep) in zip(sites, CNN_DROPOUTS):
                    hold(keys, keep, MNIST_MICRO * width,
                         f"K={nodes} step {step}")
        log(f"  T1 per-row masks at phase 9's dropouts, K={nodes} rows x "
            f"{[MNIST_MICRO * w for w, _ in CNN_DROPOUTS]}, steps 0 and 3: "
            f"bit-identical to the twin")
    # the first dropout's keys over 4 microbatches of 8 nodes
    table = np.concatenate([sites[0] for sites in dropout_tables(tf, 8, 3)])
    for n in (4096, 64 * 3 - 1):
        for p in (0.75, 0.5):
            hold(table, p, n, f"{table.shape[0]} rows")
        log(f"  T1 per-row masks, {table.shape[0]} rows x {n}: bit-identical "
            f"to the twin (p 0.75, 0.5)")
    return float(worst)


# -- phases 4-6: training through Trainer.fit --------------------------------


SCHED = dict(lr_scheduler="lambda_cosine",
             lr_scheduler_kwargs={"warmup_steps": 2})


def diloco():
    from gym_tpu_torch.strategy import DiLoCoStrategy, OptimSpec
    return DiLoCoStrategy(optim_spec=OptimSpec("adamw", lr=3e-4), H=2,
                          **SCHED)


def gpt_fit(torch, cfg_kw, nodes, batch, steps, device, autocast, seed,
            run_name, init_params=None, tokens=200_000, strategy=None,
            **fit_kw):
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    import numpy as np

    cfg = GPTConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, tokens).astype(np.int32)
    cut = tokens * 9 // 10
    ds = ContiguousGPTTrainDataset(toks[:cut], cfg.block_size)
    val = ContiguousGPTTrainDataset(toks[cut:], cfg.block_size)
    strategy = strategy if strategy is not None else diloco()
    return Trainer(GPT(cfg), ds, val).fit(
        strategy=strategy, num_nodes=nodes, max_steps=steps,
        batch_size=batch, device=device, autocast=autocast, seed=seed,
        val_size=batch, val_interval=100,
        init_params=init_params, show_progress=False,
        log_dir=os.path.join(HERE, "build", "chip_smoke_logs"),
        run_name=run_name, **fit_kw)


def reset_counts(mods):
    for m in mods.values():
        m.reset_launch_counts()


def read_counts(mods):
    return {k: getattr(getattr(mods[m], w), c)
            for k, (m, w, c, _, _) in KERNELS.items()}


def train_phase(torch, mods, title, cfg_kw, nodes, batch, steps, want,
                tokens=200_000, strategy=None):
    log(f"{title}: K={nodes} x {batch} rows, {steps} steps, bf16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = gpt_fit(torch, cfg_kw, nodes, batch, steps, "cuda", True, 0, title,
                  tokens=tokens, strategy=strategy)
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    losses = [l for _, l in res.history["train_loss"]]
    for step, loss in res.history["train_loss"]:
        log(f"  step {step}: loss {loss:.6f}")
    for (step, lo), (_, gl) in zip(res.history["local_loss"],
                                   res.history["global_loss"]):
        log(f"  eval at step {step}: local {lo:.6f} global {gl:.6f}")
    log(f"  steps/s {res.steps_per_second:.4f} (steady "
        f"{res.steps_per_second_steady}) on {torch.cuda.get_device_name(0)}, "
        f"wall {wall:.1f} s incl. init, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
        f"{held / 2**30:.2f} GiB held before the fit)")
    log(f"  launches: {counts}")
    check(len(losses) == steps and all(math.isfinite(l) for l in losses),
          f"{title}: non-finite or missing losses {losses}")
    ln_v = math.log(cfg_kw["vocab_size"])
    check(abs(losses[0] - ln_v) < 0.5,
          f"{title}: first loss {losses[0]} far from ln(V) = {ln_v:.3f}")
    for name in want:
        check(counts[name] > 0, f"{title}: {name} never launched")
    return counts, res


def long_context_phase(torch, mods, cfg_kw, nodes, steps):
    """GPT-2 base at T=8192 under remat and loss_chunk: losses, the exact
    B5 launch counts, steps/s, peak memory and MFU; then one step without
    the memory levers, which must peak higher."""
    from gym_tpu_torch.models.nanogpt import GPTConfig, node_mfu
    title = "phase 5b long-context"
    counts, res = train_phase(torch, mods, title, cfg_kw, nodes, 1, steps,
                              ("B5f_flash_fwd", "B5b_flash_bwd"),
                              tokens=400_000)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg_kw["n_layer"]
    # every eval runs the f32 forward twice (local and global params), one
    # validation microbatch each
    evals = 2 * len(res.history["global_loss"])
    want = {"B5f_flash_fwd": layers * 2 * steps,
            "B5f_flash_fwd_f32": layers * evals,
            "B5b_flash_bwd": layers * steps}
    got = {k: counts[k] for k in want}
    check(got == want, f"{title}: B5 launches {got}, expected {want} "
          f"({layers} layers, {steps} steps under remat, {evals} eval "
          f"forwards)")
    sps = res.steps_per_second_steady or res.steps_per_second
    mfu = node_mfu(GPTConfig(**cfg_kw), res.node_state.params, nodes,
                   1.0 / sps, peak_flops=BF16_FLOPS)
    log(f"  B5 launches as expected: bf16 forward {want['B5f_flash_fwd']} = "
        f"{layers} x 2 x {steps} steps, f32 forward "
        f"{want['B5f_flash_fwd_f32']} = {layers} x {evals} eval forwards, "
        f"backward {want['B5b_flash_bwd']}")
    log(f"  one f32 eval (K={nodes} x 1 row, node 0's and the mean params): "
        f"{time_eval(torch, cfg_kw, nodes):.1f} ms (median of 3; "
        f"scripts/eval_time.py compares checkouts)")
    log(f"  MFU {mfu:.4%} at {BF16_FLOPS / 1e12:.0f} TFLOP/s (steady "
        f"{sps:.4f} steps/s); peak memory with remat and loss_chunk "
        f"{peak / 2**30:.2f} GiB")
    del res  # its node state would count in the next run's peak
    plain_kw = dict(cfg_kw, remat=False, loss_chunk=0)
    train_phase(torch, mods, f"{title} without remat", plain_kw, nodes, 1,
                1, ("B5f_flash_fwd", "B5b_flash_bwd"), tokens=400_000)
    peak1 = torch.cuda.max_memory_allocated()
    log(f"  peak memory without remat and loss_chunk {peak1 / 2**30:.2f} GiB "
        f"(with: {peak / 2**30:.2f} GiB)")
    check(peak < peak1, f"{title}: remat and loss_chunk did not lower the "
          f"peak memory ({peak} >= {peak1} bytes)")
    return counts


def time_eval(torch, cfg_kw, nodes, reps=3):
    """ms of one f32 eval of the GPT at ``cfg_kw`` as ``Trainer.fit`` runs
    it (``make_eval_step``: node 0's params and the node mean, one
    validation row a node), on random weights (seed 0) and tokens; the host
    clock around a synchronise, median of ``reps`` after one warm-up."""
    import types
    from gym_tpu_torch.models.base import LossModel
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.parallel.axis import AxisCtx
    from gym_tpu_torch.train_node import make_eval_step
    cfg = GPTConfig(**cfg_kw)
    model = LossModel(GPT(cfg))
    params, model_state = model.init(nodes, 0, "cuda")
    state = types.SimpleNamespace(params=params, model_state=model_state)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.randint(0, cfg.vocab_size,
                                (nodes, 1, 1, cfg.block_size), device="cuda",
                                generator=g) for _ in range(2))
    step = make_eval_step(model, AxisCtx(nodes))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del params, state, batch
    torch.cuda.empty_cache()
    return sorted(times[1:])[reps // 2]


def card_vs_cpu(torch, mods, cfg_kw, nodes, batch, steps, tokens, want=(),
                strategy_fn=diloco, label=""):
    """Train losses and global evals of the same fit on the card and on the
    CPU; ``want`` names kernels the card run must have launched, in both
    modes or ({mode: names}) in each."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    t = f"{cfg_kw['block_size']}{label}"
    init = {n: p[0] for n, p in GPT(GPTConfig(**cfg_kw)).init_params(
        1, seed=11, device="cpu").items()}
    for mode, autocast in (("bf16", True), ("f32", False)):
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts(mods)
            res = gpt_fit(torch, cfg_kw, nodes, batch, steps, device,
                          autocast, 5, f"card_vs_cpu_T{t}_{mode}_{device}",
                          init_params=init, tokens=tokens,
                          strategy=strategy_fn())
            out[device] = [l for _, l in res.history["train_loss"]] + [
                l for _, l in res.history["global_loss"]]
            if device == "cuda":
                counts = read_counts(mods)
                names = want[mode] if isinstance(want, dict) else want
                for name in names:
                    check(counts[name] > 0, f"card vs CPU T={t}: {name} "
                          f"never launched on the card")
                if names:
                    log(f"  card launches T={t} {mode}: "
                        f"{ {n: counts[n] for n in names} }")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"],
                                                      out["cpu"]))
        log(f"card vs CPU T={t} {mode}: cuda "
            f"{['%.6f' % x for x in out['cuda']]}")
        log(f"                  cpu  {['%.6f' % x for x in out['cpu']]}")
        log(f"  max rel diff {rel:.3e} (band {LOSS_RTOL[mode]})")
        check(rel <= LOSS_RTOL[mode], f"card vs CPU {mode}: losses differ "
              f"by {rel:.3e} > {LOSS_RTOL[mode]}")


# card against CPU under DeMo: its evals after sign-SGD steps. A gradient
# that differs in the last bits (cuBLAS's and the CPU's f32 sums, the
# 3xTF32 attention) can move a pick of the packed top-k key across a tie,
# which changes every decoded value of that chunk and flips the signs near
# 0; each flipped sign moves a parameter by 2·lr, and the flips cascade
# (PERF.md §6: 58, 141 and 2,711 of 112,448 in steps 1-3, the last eval
# 1.128e-4 apart). ``demo_flips_witness`` shows the cause each run: the CPU
# step from the card's inputs flips no sign, and the picks that the card's
# and the CPU's inputs give are counted beside the gaps in those inputs.
# The train losses keep the f32 band.
DEMO_EVAL_RTOL = 1e-3


def demo_step_card_vs_cpu(torch, strategy_cls, shapes, nodes, steps=3):
    """DeMo's step alone on the card and on the CPU from the same state and
    gradients (numpy, seeded): the update signs that differ, a step. Only
    the DCT products' rounding differs (cuBLAS against the CPU), and the
    decode is exact on both, so none may differ."""
    import numpy as np
    from gym_tpu_torch.parallel.axis import AxisCtx
    from gym_tpu_torch.strategy import OptimSpec
    rng = np.random.default_rng(8)
    p0 = {n: rng.standard_normal((nodes,) + s).astype(np.float32)
          for n, s in shapes.items()}
    grads = [{n: 1e-2 * rng.standard_normal(v.shape).astype(np.float32)
              for n, v in p0.items()} for _ in range(steps)]
    signs = {}
    for device in ("cuda", "cpu"):
        strat = strategy_cls(OptimSpec("sgd", lr=1e-3)).finalize(steps)
        params = {n: torch.tensor(v, device=device) for n, v in p0.items()}
        state, ctx, out = strat.init(params), AxisCtx(nodes), []
        for step, g in enumerate(grads):
            new, state, _ = strat.step(
                {n: torch.tensor(v, device=device) for n, v in g.items()},
                params, state, step, ctx)
            out.append(torch.cat([torch.sign(params[n][0] - new[n][0])
                                  .flatten() for n in sorted(new)]).cpu())
            params = new
        signs[device] = out
    return [int((a != b).sum()) for a, b in zip(signs["cuda"],
                                                signs["cpu"])]


def on_cpu(tree):
    """A copy on the CPU of a dict of tensors, nested."""
    if isinstance(tree, dict):
        return {k: on_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def demo_flips_witness(torch, strategy_cls, inputs, card_signs, nodes,
                       steps):
    """Where the fit's flipped signs come from. Each step of the card's fit
    is replayed on the CPU from the card's own inputs (gradients, params,
    DeMo's residual): its signs must equal the card's, so the step itself is
    device-independent. Then each step runs on the CPU from the card's
    inputs and from the CPU fit's: the chunk rows whose top-k picks differ
    between the two, beside the largest gap in the gradients and in the
    residual, a step."""
    import gym_tpu_torch.strategy.demo as demo_mod
    from gym_tpu_torch.parallel.axis import AxisCtx
    ctx = AxisCtx(nodes)

    def cpu_step(step, grads, params, state):
        """One CPU step: its update sign and the picks of every chunk row,
        each row's picks sorted."""
        strat, picks = strategy_cls().finalize(steps), []
        select = demo_mod.topk_compress

        def spy(coeffs, k):
            idx, val = select(coeffs, k)
            picks.append(torch.sort(idx.reshape(-1, idx.shape[-1]),
                                    dim=-1).values)
            return idx, val

        demo_mod.topk_compress = spy
        try:
            strat.step(grads, params, state, step, ctx)
        finally:
            demo_mod.topk_compress = select
        return strat.signs[0], picks

    def gap(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a)

    replay, moved, g_gap, d_gap = [], [], [], []
    for step in range(steps):
        card, cpu = inputs["cuda"][step], inputs["cpu"][step]
        sign, picks = cpu_step(step, *card)
        replay.append(int((sign != card_signs[step]).sum()))
        _, own = cpu_step(step, *cpu)
        moved.append(sum(int((a != b).any(dim=-1).sum())
                         for a, b in zip(picks, own)))
        g_gap.append(gap(card[0], cpu[0]))
        d_gap.append(gap(card[2]["delta"], cpu[2]["delta"]))
    log(f"  CPU step from the card's inputs: update signs that differ from "
        f"the card's, a step: {replay}")
    log(f"  CPU step from the card's inputs against the CPU fit's: chunk "
        f"rows whose picks differ, a step: {moved} (of "
        f"{sum(a.shape[0] for a in picks)}); "
        f"largest gap in the gradients {['%.3e' % x for x in g_gap]}, in "
        f"the residual {['%.3e' % x for x in d_gap]}")
    check(replay == [0] * steps, f"DeMo step on the CPU from the card's "
          f"inputs: {replay} update signs differ from the card's")


def demo_card_vs_cpu(torch, mods, cfg_kw, nodes, batch, steps, tokens):
    """DeMo (SGD 1e-3, top-k 32, chunk 64) at K = ``nodes`` on a tiny GPT:
    K·32 > 128 picks a chunk, so the dense decode runs, D1 on the card and
    its twin on the CPU. First the strategy step alone from the same state
    and gradients (no sign may differ); then ``Trainer.fit`` on the card and
    on the CPU from the same weights and batches, f32: the train losses in
    the f32 band, the evals in ``DEMO_EVAL_RTOL``, the update signs that
    differ counted each step."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import DeMoStrategy, OptimSpec

    class SignLog(DeMoStrategy):
        """DeMo that keeps each step's update sign of node 0 (every node
        steps by the same sign)."""

        def __init__(self, optim=None):
            super().__init__(optim or OptimSpec("sgd", lr=1e-3), **SCHED)
            self.signs, self.inputs = [], []

        def step(self, grads, params, state, step, ctx):
            self.inputs.append(tuple(on_cpu(x) for x in (grads, params,
                                                         state)))
            out = super().step(grads, params, state, step, ctx)
            self.signs.append(torch.cat([
                torch.sign(params[n][0] - out[0][n][0]).flatten()
                for n in sorted(params)]).cpu())
            return out

    shapes = {n: shape for n, (shape, _) in
              GPT(GPTConfig(**cfg_kw))._param_specs().items()}
    reset_counts(mods)
    flips = demo_step_card_vs_cpu(torch, SignLog, shapes, nodes)
    log(f"card vs CPU DeMo step alone, K={nodes}, same state and gradients: "
        f"update signs that differ, a step: {flips} (D1 launched "
        f"{read_counts(mods)['D1_scatter_mean']} times)")
    check(flips == [0] * len(flips), f"DeMo step on the card against the "
          f"CPU: {flips} update signs differ")

    init = {n: p[0] for n, p in GPT(GPTConfig(**cfg_kw)).init_params(
        1, seed=11, device="cpu").items()}
    out, signs, inputs = {}, {}, {}
    for device in ("cuda", "cpu"):
        reset_counts(mods)
        strat = SignLog()
        res = gpt_fit(torch, cfg_kw, nodes, batch, steps, device, False, 5,
                      f"card_vs_cpu_demo_{device}", init_params=init,
                      tokens=tokens, strategy=strat)
        out[device] = ([l for _, l in res.history["train_loss"]],
                       [l for _, l in res.history["global_loss"]])
        signs[device], inputs[device] = strat.signs, strat.inputs
        if device == "cuda":
            _, groups = strat._groups(shapes)
            want = len(groups) * steps
            got = read_counts(mods)["D1_scatter_mean"]
            check(got == want, f"card vs CPU DeMo: D1 launched {got} times, "
                  f"expected {want} ({len(groups)} tile signatures x "
                  f"{steps} steps)")
    flips = [int((a != b).sum()) for a, b in zip(signs["cuda"],
                                                 signs["cpu"])]

    def rel(i):
        return max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][i],
                                                        out["cpu"][i]))

    log(f"card vs CPU DeMo K={nodes} T={cfg_kw['block_size']} f32 (dense "
        f"decode, D1 {want} launches): train, evals cuda "
        f"{['%.6f' % x for x in out['cuda'][0] + out['cuda'][1]]}")
    log(f"                  cpu  "
        f"{['%.6f' % x for x in out['cpu'][0] + out['cpu'][1]]}")
    log(f"  update signs that differ, a step: {flips} (of "
        f"{len(signs['cpu'][0])} params)")
    log(f"  max rel diff train {rel(0):.3e} (band {LOSS_RTOL['f32']}), "
        f"evals {rel(1):.3e} (band {DEMO_EVAL_RTOL})")
    demo_flips_witness(torch, SignLog, inputs, signs["cuda"], nodes, steps)
    check(rel(0) <= LOSS_RTOL["f32"], f"card vs CPU DeMo f32: train losses "
          f"differ by {rel(0):.3e} > {LOSS_RTOL['f32']}")
    check(rel(1) <= DEMO_EVAL_RTOL, f"card vs CPU DeMo f32: evals differ by "
          f"{rel(1):.3e} > {DEMO_EVAL_RTOL}")
    return flips


# -- phase 7: timing --------------------------------------------------------


# above the H100's highest SM clock (1.98 GHz), so torch.cuda._sleep of
# s * SLEEP_HZ cycles lasts at least s seconds
SLEEP_HZ = 2.0e9


def timed(torch, fn, reps=5, inner=10):
    """Median ms of one call over ``reps`` runs of ``inner`` back-to-back
    calls. Each run is queued behind a device sleep longer than the host
    takes to queue it, so the events bracket device work only, not the
    host's launch cost."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(min(2 * host_s + 1e-3, 1.0) * SLEEP_HZ)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def attn_flops(n, h, t, d, backward, causal=True):
    """The products of attention: 2 (forward) or 5 (backward) of 2·D flops
    a pair; causal pairs only."""
    pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
    return 2 * d * pairs * (5 if backward else 2)


def bound_parts(n, h, t, d, itemsize, backward, causal=True):
    """(bytes ms, operations ms): each input read once and each output
    written once at 3.35 TB/s; the products on the tensor cores, at 989
    TFLOP/s (bf16) or as three TF32 products each at 495 TFLOP/s (f32, in
    split-precision TF32, which meets the f32 tolerance)."""
    elems = n * h * t * d
    stats = n * h * t * 4
    # backward: read q k v o do lse, write dq dk dv; forward: read q k v,
    # write o lse
    nbytes = (8 if backward else 4) * elems * itemsize + stats
    flops = attn_flops(n, h, t, d, backward, causal)
    t_ops = (flops / BF16_FLOPS if itemsize == 2
             else TF32_SPLIT * flops / TF32_FLOPS)
    return nbytes / HBM_BYTES_PER_S * 1e3, t_ops * 1e3


def bound(n, h, t, d, itemsize, backward, causal=True):
    """Least time (ms) for the work, the larger of ``bound_parts``."""
    t_bytes, t_ops = bound_parts(n, h, t, d, itemsize, backward, causal)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ffma_ms(n, h, t, d, backward, causal=True):
    """The products at the 67 TFLOP/s of f32 FMAs (ms): printed beside an
    f32 bound for comparison, not a bound."""
    return attn_flops(n, h, t, d, backward, causal) / F32_FLOPS * 1e3


def tile_tflops(n, h, t, d, products, ms, causal=True):
    """TFLOP/s of the 64 x 64 tiles a kernel computes: causal, the tiles on
    or below the diagonal, diagonal tiles whole (B5f's 128-row blocks
    compute the same tiles: warpgroup 0 skips its block's last key tile),
    ``products`` matrix products of 2·D flops a pair each."""
    nt = t // 64
    tiles = nt * (nt + 1) // 2 if causal else nt * nt
    return n * h * tiles * 64 * 64 * 2 * d * products / (ms * 1e-3) / 1e12


def time_kernels(torch, tfa, tflash, shapes):
    import torch.nn.functional as F
    out = {}
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    n, t, c, h = shapes["flagship"]
    d = c // h
    scale = 1.0 / math.sqrt(d)
    qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g).to(bf)
    q, k, v = qkv.split(c, dim=-1)
    do = torch.randn(n, t, c, device="cuda", generator=g).to(bf)
    o, lse = tfa._fwd_packed(q, k, v, scale, h)
    lib = [x.view(n, t, h, d).transpose(1, 2).detach().requires_grad_(True)
           for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    ldo = do.view(n, t, h, d).transpose(1, 2)
    out["B1_fwd_packed"] = dict(
        ms=timed(torch, lambda: tfa._fwd_packed(q, k, v, scale, h)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd_packed(q, k, v, scale, h),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *[x.detach() for x in lib], is_causal=True, scale=scale)),
        shape=f"N={n} T={t} C={c} H={h} bf16 packed views",
        bound=bound(n, h, t, d, 2, False), work=(n, h, t, d, 3))
    out["B2_bwd_packed"] = dict(
        ms=timed(torch, lambda: tfa._bwd_packed(q, k, v, o, do, lse, scale,
                                                h)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd_packed(
            q, k, v, o, do, lse, scale, h), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, ldo, retain_graph=True)),
        shape=f"N={n} T={t} C={c} H={h} bf16 packed views",
        bound=bound(n, h, t, d, 2, True), work=(n, h, t, d, 7))
    del qkv, q, k, v, do, o, lse, lib, lo, ldo
    torch.cuda.empty_cache()

    n, h, t, d = shapes["base"]
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g).to(bf)
    heads = [z.reshape(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g).to(bf)
    o, lse = tfa._blk_fwd(*heads, 0.125, True)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=0.125)
    out["B3_blk_fwd"] = dict(
        ms=timed(torch, lambda: tfa._blk_fwd(*heads, 0.125, True)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd(*heads, 0.125, True),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=0.125)),
        shape=f"N={n} H={h} T={t} D={d} bf16 per-head views",
        bound=bound(n, h, t, d, 2, False), work=(n, h, t, d, 3))
    out["B4_blk_bwd"] = dict(
        ms=timed(torch, lambda: tfa._blk_bwd(*heads, o, do, lse, None, 0.125,
                                             True)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd(
            *heads, o, do, lse, None, 0.125, True), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=f"N={n} H={h} T={t} D={d} bf16 per-head views",
        bound=bound(n, h, t, d, 2, True), work=(n, h, t, d, 7))
    del qkv, heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()

    n, h, t, d = shapes["long"]
    scale = 1.0 / math.sqrt(d)
    heads, do = per_head_views(torch, g, n, h, t, d, bf)
    o, lse = tflash._flash_fwd(*heads, scale)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    shape = f"N={n} H={h} T={t} D={d} bf16 per-head views"
    out["B5f_flash_fwd"] = dict(
        ms=timed(torch, lambda: tflash._flash_fwd(*heads, scale), inner=3),
        plain_ms=timed(torch, lambda: tflash.plain_flash_fwd(*heads, scale),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=scale)),
        shape=shape, bound=bound(n, h, t, d, 2, False),
        work=(n, h, t, d, 2))
    out["B5b_flash_bwd"] = dict(
        ms=timed(torch, lambda: tflash._flash_bwd(*heads, o, do, lse, scale),
                 inner=3),
        plain_ms=timed(torch, lambda: tflash.plain_flash_bwd(
            *heads, o, do, lse, scale), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=shape, bound=bound(n, h, t, d, 2, True),
        work=(n, h, t, d, 7))
    del heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()
    f32 = time_long_f32(torch, tfa, tflash, g, n, h, t, d)
    for name, r in out.items():
        b, by = r["bound"]
        log(f"{name} [{r['shape']}]: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {b:.4f} ({by}) -> {b / r['ms']:.1%} of bound, "
            f"{tile_tflops(*r['work'], r['ms']):.1f} TFLOP/s of computed "
            f"64 x 64 tiles on or below the diagonal ({r['work'][-1]} "
            f"products)")
    out["B5f_flash_fwd_f32"] = f32
    return out


def time_long_f32(torch, tfa, tflash, g, n, h, t, d):
    """The f32 long-context forward (pre-pass and forward) on per-head
    views at B5f's shape, its pre-pass alone, its plain version, f32 SDPA,
    the bound, and the whole-context f32 forward (``attn_fwd_tf32x3``, which
    computes the same function: launched directly, since ``_blk_fwd``'s gate
    is for T <= 1024)."""
    import torch.nn.functional as F
    from gym_tpu_torch.ops import _build
    scale = 1.0 / math.sqrt(d)
    heads, _ = per_head_views(torch, g, n, h, t, d, torch.float32)
    o = torch.empty(n, h, t, d, device="cuda")
    lse = torch.empty(n, h, t, 1, device="cuda")
    strides = [int(v) for x in (*heads, o, lse)
               for v in tfa._strides(x, "blk")]
    work = torch.empty(16 * n * h * t * d, dtype=torch.uint8, device="cuda")
    lib = _build.load()
    st = (ctypes.c_longlong * 15)(*strides)

    def split():
        code = lib.gym_flash_split_kv(*(x.data_ptr() for x in (*heads, o)),
                                      work.data_ptr(), st, n, h, t, d,
                                      tfa._stream(o))
        _build.check(lib, code, "gym_flash_split_kv")

    r = dict(ms=timed(torch, lambda: tflash._flash_fwd(*heads, scale),
                      inner=3),
             plain_ms=timed(torch, lambda: tflash.plain_flash_fwd(
                 *heads, scale), reps=3, inner=1),
             library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                 *heads, is_causal=True, scale=scale), inner=3),
             shape=f"N={n} H={h} T={t} D={d} f32 per-head views",
             bound=bound(n, h, t, d, 4, False), work=(n, h, t, d, 2),
             backward=False)
    split_ms = timed(torch, split, inner=3)
    whole_ms = timed(torch, lambda: tfa._launch_fwd(
        *heads, o, lse, strides, n, h, t, d, True, scale), inner=3)
    log_f32("B5f_flash_fwd_f32 (pre-pass and flash_fwd_tf32x3)", r)
    # the pre-pass reads k and v and writes four split copies of them
    split_bytes = 6 * n * h * t * d * 4
    log(f"  B5f f32 pre-pass split_kv_tf32x3 alone: {split_ms:.4f} ms "
        f"({split_bytes / 1e6:.0f} MB, bound "
        f"{split_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s), "
        f"{split_ms / r['ms']:.1%} of the forward; the whole-context "
        f"attn_fwd_tf32x3 at this shape {whole_ms:.4f} ms, "
        f"{whole_ms / r['ms']:.2f}x the long-context forward's time")
    check(r["ms"] < whole_ms and r["ms"] < r["library_ms"],
          f"B5f f32: {r['ms']:.4f} ms is not faster than attn_fwd_tf32x3 "
          f"({whole_ms:.4f}) and f32 SDPA ({r['library_ms']:.4f})")
    del heads, o, lse, work
    torch.cuda.empty_cache()
    return r


def gpt_leaves(cfg_kw):
    """(JAX leaf index, per-node element count) of every leaf of the GPT,
    in the port's dict order, from the parameter shapes alone."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    specs = GPT(GPTConfig(**cfg_kw))._param_specs()
    order = jax_leaf_order(specs)
    return [(order[n], math.prod(shape)) for n, (shape, _) in specs.items()]


def time_threefry(torch, tf, leaves, sass_ops, int32_ops_per_s, p=0.005):
    """T1 at phase 8a's shapes: the masks of every leaf for one SPARTA
    step, in one launch (``bernoulli_segments``, the segment table's upload
    included); its twin on the card; the bound, from the least operations
    an element (the compiled kernel's ``sass_ops`` is printed beside it);
    and the largest leaf alone."""
    keys = [threefry_key(tf, i, 0) for i, _ in leaves]
    sizes = [n for _, n in leaves]
    total = sum(sizes)
    t_bytes = total / HBM_BYTES_PER_S  # one byte written an element
    t_ops = total * THREEFRY_LEAST_OPS / int32_ops_per_s
    r = dict(ms=timed(torch, lambda: tf.bernoulli_segments(
                 keys, p, sizes, "cuda")),
             plain_ms=timed(torch, lambda: tf.plain_bernoulli_segments(
                 keys, p, sizes, "cuda"), reps=3, inner=1),
             library_ms=None,
             bound=(max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    n = max(sizes)
    key = keys[sizes.index(n)]
    one = timed(torch, lambda: tf.bernoulli(key, p, n, "cuda"))
    log(f"T1 the largest leaf alone ({n} elements): {one:.4f} ms, bound "
        f"{n * THREEFRY_LEAST_OPS / int32_ops_per_s * 1e3:.4f} ms")
    log(f"T1_threefry_bernoulli [{len(leaves)} leaves, {total} elements, "
        f"p {p}, one launch]: kernel_ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} (twin, int64) library_ms none (no PyTorch "
        f"call computes threefry2x32) bound_ms {r['bound'][0]:.4f} "
        f"({r['bound'][1]}: {THREEFRY_LEAST_OPS} ops an element at "
        f"{int32_ops_per_s / 1e12:.2f} TOP/s int32; bytes "
        f"{t_bytes * 1e3:.4f} ms; at the compiled kernel's {sass_ops:.2f} "
        f"ops an element {total * sass_ops / int32_ops_per_s * 1e3:.4f} ms) "
        f"-> {r['bound'][0] / r['ms']:.1%} of bound")
    torch.cuda.empty_cache()
    return r


def time_scatter_mean(torch, tsm):
    """D1 in turns with its oracle (new, oracle, oracle, new; the better of
    each pair) at every signature of ``D1_SHAPES``, beside the yardstick
    (``index_put_(accumulate=True)`` of the sums and of the counts into flat
    slots, then the divide: one PyTorch call for each, in no fixed order on
    the card; timed only) and the byte bound (each pick read once, 8
    bytes, each output written once, 4); the twin at config 5's 64 × 64
    signature. Fails if D1 is slower than its oracle at any signature.
    Returns the 64 × 64 signature's record."""
    g = torch.Generator(device="cuda").manual_seed(5)
    slower, out = [], None
    for rows, m, e in D1_SHAPES:
        idx = torch.randint(0, e, (rows, m), device="cuda", generator=g,
                            dtype=torch.int32)
        val = torch.randn(rows, m, device="cuda", generator=g)
        flat = (idx.long() + torch.arange(rows, device="cuda")[:, None] * e
                ).view(-1)
        ones = torch.ones(rows * m, device="cuda")

        def yardstick():
            z = torch.zeros(rows * e, device="cuda")
            sums = z.index_put_((flat,), val.view(-1), accumulate=True)
            cnts = torch.zeros(rows * e, device="cuda").index_put_(
                (flat,), ones, accumulate=True)
            return torch.where(cnts > 0, sums / cnts.clamp(min=1.0), 0.0)

        def new():
            return tsm.scatter_mean_decode(idx, val, e)

        def ref():
            return tsm.scatter_mean_decode_ref(idx, val, e)

        nbytes = rows * m * 8 + rows * e * 4
        new_a, ref_a = timed(torch, new), timed(torch, ref)
        ref_b, new_b = timed(torch, ref), timed(torch, new)
        r = dict(ms=min(new_a, new_b), ref_ms=min(ref_a, ref_b),
                 library_ms=timed(torch, yardstick), plain_ms=None,
                 bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        if out is None:
            r["plain_ms"] = timed(torch, lambda: tsm.plain_scatter_mean_decode(
                idx, val, e), reps=3, inner=1)
            out = r
        log(f"D1_scatter_mean [(G, m, E) = ({rows}, {m}, {e})]: kernel_ms "
            f"{r['ms']:.4f} ({new_a:.4f}, {new_b:.4f}) oracle_ms "
            f"{r['ref_ms']:.4f} ({ref_a:.4f}, {ref_b:.4f}) "
            + (f"plain_ms {r['plain_ms']:.4f} (twin) " if r["plain_ms"]
               else "")
            + f"library_ms {r['library_ms']:.4f} (index_put_ accumulate x2 "
            f"+ divide, a yardstick) bound_ms {r['bound'][0]:.6f} (bytes: "
            f"{nbytes / 1e6:.2f} MB at 3.35 TB/s) -> "
            f"{r['bound'][0] / r['ms']:.2%} of bound, "
            f"{r['ref_ms'] / r['ms']:.2f}x the oracle")
        if r["ms"] > r["ref_ms"]:
            slower.append((rows, m, e))
        del idx, val, flat, ones
    check(not slower, f"D1 slower than its oracle at {slower}")
    torch.cuda.empty_cache()
    return out


def time_threefry_bits(torch, tf, n, int32_ops_per_s):
    """The bits kernel at DynamiQ's hop-1 length on the flagship (the
    flat gradient padded to whole 256-element tiles): its twin, the bound
    (4 bytes written an element, or the 73 int32 operations of threefry2x32
    and its final xor at the dispatch limit)."""
    key = tf.fold_in(tf.PRNGKey(2602), 3)
    t_bytes = 4 * n / HBM_BYTES_PER_S
    t_ops = n * (THREEFRY_LEAST_OPS - 2) / int32_ops_per_s
    r = dict(ms=timed(torch, lambda: tf.random_bits(key, n, "cuda")),
             plain_ms=timed(torch, lambda: tf.plain_random_bits(key, n,
                                                                 "cuda"),
                            reps=3, inner=1),
             library_ms=None,
             bound=(max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    log(f"T1_threefry_bits [{n} elements, DynamiQ's hop 1 on the flagship]: "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} (twin) "
        f"library_ms none bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}) -> "
        f"{r['bound'][0] / r['ms']:.1%} of bound")
    return r


def todays_compress(torch, tf, x, keys, qmax, tile):
    """The codec before T1 bits' redesign on its path: the first bits
    kernel once a key (a stack of their uniforms), then the torch passes
    (pad, abs, max, the scale, divide, add, floor, clamp, the int8 cast)."""
    rows, n = x.shape
    t = -(-n // tile)
    xt = torch.nn.functional.pad(x.float(), (0, t * tile - n))
    xt = xt.view(rows, t, tile)
    amax = xt.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = xt / scale
    keys = [keys] if isinstance(keys, tuple) else keys
    u = torch.stack([tf.uniform(k, t * tile, x.device) for k in keys])
    q = torch.floor(q + u.view(-1, t, tile))
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def peak_bytes(torch, fn):
    """Device memory one call of ``fn`` holds at its peak above what was
    held before it, and what the call returned."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held, out


# the codec calls phase 7 times: (what, rows, n, keys a row or one shared)
CODEC_SHAPES = (
    ("DiLoCo/NoLoCo sync on the flagship, K=16, keys a row", 16, None,
     "rows"),
    ("DynamiQ hop 1 on the flagship, K=16, one shared key", 16, None,
     "shared"),
    ("DiLoCo int8 sync at GPT-2 base, K=4, keys a row", 4, 124_475_904,
     "rows"),
)


def time_quantize_tiles(torch, tqt, tf, flagship, int32_ops_per_s):
    """T1 bits on its main path at ``CODEC_SHAPES`` (n None: the flagship's
    parameters), in turns with today's path (kernel, today's, today's,
    kernel; the better of each pair); the plain version; the bound, the
    larger of the bytes (each x read once, 4 bytes, each q written once, 1,
    and a 4-byte scale a tile) and 73 int32 operations a distinct (key,
    counter) at the dispatch limit; at GPT-2 base each path's peak memory,
    and the kernel's q and scales there bit for bit the plain version's.
    Fails if the kernel is slower than today's path or differs from the
    plain version. Returns the flagship's keys-a-row record."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out, slower = None, []
    for what, rows, n, which in CODEC_SHAPES:
        n = n or flagship_params(flagship)
        t = -(-n // 256)
        x = torch.randn(rows, n, device="cuda", generator=g)
        base = tf.fold_in(tf.PRNGKey(1206), 2)
        keys = base if which == "shared" else [tf.fold_in(base, i)
                                               for i in range(rows)]
        distinct = t * 256 * (1 if which == "shared" else rows)
        nbytes = 4 * rows * n + rows * t * 256 + 4 * rows * t
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = distinct * (THREEFRY_LEAST_OPS - 2) / int32_ops_per_s

        def kernel():
            return tqt.quantize_tiles(x, keys, 127, 256)

        def today():
            return todays_compress(torch, tf, x, keys, 127, 256)

        k_a, d_a = timed(torch, kernel), timed(torch, today)
        d_b, k_b = timed(torch, today), timed(torch, kernel)
        r = dict(ms=min(k_a, k_b), today_ms=min(d_a, d_b), library_ms=None,
                 plain_ms=timed(torch, lambda: tqt.plain_quantize_tiles(
                     x, keys, 127, 256), reps=3, inner=1),
                 bound=(max(t_bytes, t_ops) * 1e3,
                        "bytes" if t_bytes >= t_ops else "operations"))
        log(f"T1_quantize_tiles [{rows}, {n}] ({what}; {t} tiles of 256 a "
            f"row): kernel_ms {r['ms']:.4f} ({k_a:.4f}, {k_b:.4f}) "
            f"today_ms {r['today_ms']:.4f} ({d_a:.4f}, {d_b:.4f}; the first "
            f"bits kernel and the torch passes) plain_ms "
            f"{r['plain_ms']:.4f} (twin) library_ms none bound_ms "
            f"{r['bound'][0]:.6f} ({r['bound'][1]}: {nbytes / 1e6:.2f} MB "
            f"{t_bytes * 1e3:.6f} ms, {distinct} draws {t_ops * 1e3:.6f} "
            f"ms) -> {r['bound'][0] / r['ms']:.1%} of bound, "
            f"{r['today_ms'] / r['ms']:.2f}x today's path")
        if n == 124_475_904:
            peaks, outs = {}, {}
            for name, fn in (("kernel", kernel), ("today", today),
                             ("plain", lambda: tqt.plain_quantize_tiles(
                                 x, keys, 127, 256))):
                peaks[name], outs[name] = peak_bytes(torch, fn)
                if name == "today":
                    del outs[name]
            (q, sc), (pq, psc) = outs["kernel"], outs["plain"]
            check(torch.equal(q, pq) and same_bits(torch, sc, psc),
                  f"T1_quantize_tiles [{rows}, {n}]: "
                  f"{int((q != pq).sum())} q and "
                  f"{int((sc.view(torch.int32) != psc.view(torch.int32)).sum())}"
                  f" scales differ from the plain version")
            log(f"  [{rows}, {n}]: the kernel's q and scales bit-identical "
                f"to the plain version's")
            del outs, q, sc, pq, psc
            log(f"  peak memory above x ({rows * n * 4 / 2**30:.2f} GiB): "
                + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in
                            peaks.items())
                + f"; goals: at least 5x today's path "
                f"({'met' if r['today_ms'] >= 5 * r['ms'] else 'not met'}),"
                f" within 2x of the bound "
                f"({'met' if r['ms'] <= 2 * r['bound'][0] else 'not met'})")
        if r["ms"] > r["today_ms"]:
            slower.append(what)
        out = out or r
        del x
        torch.cuda.empty_cache()
    check(not slower, f"T1_quantize_tiles slower than today's path at "
          f"{slower}")
    return out


def log_f32(name, r):
    """One f32 timing line: the kernel beside its plain version, f32 SDPA
    and its bound (bytes, or three TF32 products each), and the products at
    the 67 TFLOP/s of f32 FMAs for comparison."""
    n, h, t, d, _ = r["work"]
    t_bytes, t_ops = bound_parts(n, h, t, d, 4, r["backward"])
    b = max(t_bytes, t_ops)
    plain = "" if r["plain_ms"] is None else f"plain_ms {r['plain_ms']:.4f} "
    log(f"{name} [{r['shape']}]: kernel_ms {r['ms']:.4f} {plain}library_ms "
        f"{r['library_ms']:.4f} (f32 SDPA) bound_ms {b:.4f} (bytes "
        f"{t_bytes:.4f} at 3.35 TB/s; 3 x the products at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 {t_ops:.4f}) -> "
        f"{b / r['ms']:.1%} of bound; the products at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s of f32 FMAs "
        f"{ffma_ms(n, h, t, d, r['backward']):.4f} ms (comparison only); "
        f"{tile_tflops(*r['work'], r['ms']):.1f} TFLOP/s of computed 64 x 64 "
        f"tiles ({r['work'][-1]} f32 products)")


def time_packed_f32(torch, tfa, shape):
    """The f32 packed pair (3xTF32 wgmma) at config 4's shape: held to the
    plain version there (phase 3's f32 tolerance), then timed beside it, f32
    ``scaled_dot_product_attention`` and the bound."""
    import torch.nn.functional as F
    n, t, c, h = shape
    d = c // h
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g)
    q, k, v = qkv.split(c, dim=-1)
    do = torch.randn(n, t, c, device="cuda", generator=g)
    log(f"B1/B2 packed float32 N={n} T={t} C={c} H={h} (config 4, strided "
        f"views):")
    o, lse = tfa._fwd_packed(q, k, v, scale, h)
    ro, rl = tfa.plain_fwd_packed(q, k, v, scale, h)
    errs = {"B1_fwd_packed_f32": max(compare("B1 o", o, ro, "out", f32),
                                     compare("B1 lse", lse, rl, "lse", f32))}
    got = tfa._bwd_packed(q, k, v, o, do, lse, scale, h)
    ref = tfa.plain_bwd_packed(q, k, v, o, do, lse, scale, h)
    errs["B2_bwd_packed_f32"] = max(
        compare(f"B2 {nm}", a, b, "out", f32)
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
    lib = [x.view(n, t, h, d).transpose(1, 2).detach().requires_grad_(True)
           for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    ldo = do.view(n, t, h, d).transpose(1, 2)
    desc = f"N={n} T={t} C={c} H={h} f32 packed views"
    out = {
        "B1_fwd_packed_f32": dict(
            ms=timed(torch, lambda: tfa._fwd_packed(q, k, v, scale, h)),
            plain_ms=timed(torch, lambda: tfa.plain_fwd_packed(
                q, k, v, scale, h), inner=3),
            library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                *[x.detach() for x in lib], is_causal=True, scale=scale)),
            shape=desc, bound=bound(n, h, t, d, 4, False),
            work=(n, h, t, d, 2), backward=False),
        "B2_bwd_packed_f32": dict(
            ms=timed(torch, lambda: tfa._bwd_packed(q, k, v, o, do, lse,
                                                    scale, h)),
            plain_ms=timed(torch, lambda: tfa.plain_bwd_packed(
                q, k, v, o, do, lse, scale, h), inner=3),
            library_ms=timed(torch, lambda: torch.autograd.grad(
                lo, lib, ldo, retain_graph=True)),
            shape=desc, bound=bound(n, h, t, d, 4, True),
            work=(n, h, t, d, 7), backward=True)}
    for name, r in out.items():
        log_f32(name, r)
    del qkv, q, k, v, do, o, lse, ro, rl, got, ref, lib, lo, ldo
    torch.cuda.empty_cache()
    return out, errs


def time_heads_f32(torch, tfa, shape):
    """The same f32 kernels on per-head views at B3/B4's shape (GPT-2
    base's f32 evals run this forward), timed as ``time_packed_f32``."""
    import torch.nn.functional as F
    n, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g)
    heads = [z.reshape(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g)
    o, lse = tfa._blk_fwd(*heads, 0.125, True)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=0.125)
    desc = f"N={n} H={h} T={t} D={d} f32 per-head views"
    log_f32("B3 f32 (per-head forward)", dict(
        ms=timed(torch, lambda: tfa._blk_fwd(*heads, 0.125, True)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd(*heads, 0.125, True),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=0.125)),
        shape=desc, work=(n, h, t, d, 2), backward=False))
    log_f32("B4 f32 (per-head backward)", dict(
        ms=timed(torch, lambda: tfa._blk_bwd(*heads, o, do, lse, None, 0.125,
                                             True)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd(
            *heads, o, do, lse, None, 0.125, True), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=desc, work=(n, h, t, d, 7), backward=True))
    del qkv, heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()


# the CNN's three dropouts at a microbatch of 64: masks of [64, 1, 1, 64],
# [64, 1, 1, 128] and [64, 256] a node, keep 0.75, 0.75 and 0.5
CNN_DROPOUTS = ((64, 0.75), (128, 0.75), (256, 0.5))


def time_threefry_rows(torch, tf, int32_ops_per_s, nodes=8, micro=64,
                       n_micro=4):
    """T1's per-row entry at config 2's dropout shapes: a step's 12
    launches (3 dropouts × 4 microbatches, each over the 8 nodes' keys),
    its twin, the bound; and the host's key algebra a step (the step and
    microbatch folds, then each dropout's path)."""
    from gym_tpu_torch.train_node import micro_keys
    paths = cnn_dropout_paths()
    node = tf.node_keys(0, nodes)
    t0 = time.perf_counter()
    for step in range(50):
        mk = micro_keys(node, step, n_micro)
        for i in range(n_micro):
            tf.fold_in_paths(mk[i], paths)
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    tables = dropout_tables(tf, nodes, 3, n_micro)

    def run(draw):
        for sites in tables:
            for keys, (width, keep) in zip(sites, CNN_DROPOUTS):
                draw(keys, keep, micro * width, "cuda")

    total = nodes * n_micro * micro * sum(w for w, _ in CNN_DROPOUTS)
    t_bytes = total / HBM_BYTES_PER_S
    t_ops = total * THREEFRY_LEAST_OPS / int32_ops_per_s
    r = dict(ms=timed(torch, lambda: run(tf.bernoulli_rows), inner=2),
             plain_ms=timed(torch, lambda: run(tf.plain_bernoulli_rows),
                            reps=3, inner=1),
             library_ms=None,
             bound=(max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    launches = n_micro * len(CNN_DROPOUTS)
    log(f"T1_threefry_bernoulli_rows [config 2's dropouts: {launches} "
        f"launches a step, {nodes} rows each, {total} elements]: kernel_ms "
        f"{r['ms']:.4f} ({r['ms'] / launches * 1e3:.2f} us a launch, key "
        f"table upload included) plain_ms {r['plain_ms']:.4f} (twin) "
        f"library_ms none bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}) -> "
        f"{r['bound'][0] / r['ms']:.2%} of bound; host key algebra "
        f"{host_ms:.3f} ms a step")
    torch.cuda.empty_cache()
    return r, host_ms


# -- phase 8: the stochastic strategies --------------------------------------


def expected_launches(res, cfg_kw, steps, packed, t1_per_step=0):
    """Exact launches of a bf16 fit: the attention pair's forward and
    backward once a layer a step in bf16, the forward twice a layer an eval
    in f32 (local and global params, one validation microbatch; evals run
    in f32 whatever autocast says); T1 once a SPARTA step."""
    layers = cfg_kw["n_layer"]
    train = layers * steps
    evals = 2 * layers * len(res.history["global_loss"])
    want = dict.fromkeys(KERNELS, 0)
    if packed:
        want.update(B1_fwd_packed=train, B2_bwd_packed=train,
                    B1_fwd_packed_f32=evals)
    else:
        want.update(B3_blk_fwd=train + evals, B4_blk_bwd=train)
    want["T1_threefry_bernoulli"] = t1_per_step * steps
    return want


def stochastic_phase(torch, mods, tf, card, base, flagship):
    """8a SPARTA-DiLoCo at GPT-2 base, 8b FedAvg islands at the flagship,
    8c ZeRO-1 against SimpleReduce at GPT-2 base; returns 8a's counts."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.strategy import (FedAvgStrategy, OptimSpec,
                                        SimpleReduceStrategy,
                                        SPARTADiLoCoStrategy,
                                        ZeroReduceStrategy)
    from gym_tpu_torch.strategy.faults import host_participation, ring_bytes
    adamw = OptimSpec("adamw", lr=3e-4)

    def run(title, cfg_kw, nodes, batch, steps, strategy, packed, t1=0):
        counts, res = train_phase(torch, mods, title, cfg_kw, nodes, batch,
                                  steps, (), strategy=strategy)
        want = expected_launches(res, cfg_kw, steps, packed, t1)
        log(f"  {title} on {card}: steady steps/s "
            f"{res.steps_per_second_steady}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(counts == want, f"{title}: launches {counts}, expected {want}")
        log(f"  launches exactly as expected: {want}")
        return counts, res

    # 8a: every leaf's mask each step, on the card through T1
    strat = SPARTADiLoCoStrategy(adamw, p_sparta=0.005, H=2,
                                 participation=0.75, **SCHED)
    c8a, res = run("phase 8a gpt2-base SPARTA-DiLoCo", base, 4, 4, 4, strat,
                   False, t1=1)
    # step 0's comm_bytes: the twin's realized mask count over every leaf
    order = jax_leaf_order(res.node_state.params)
    count = 0
    for name, p in res.node_state.params.items():
        key = threefry_key(tf, order[name], 0)
        count += int(tf.plain_bernoulli(key, 0.005, p[0].numel(),
                                        "cuda").sum())
    group, frac = host_participation(5678, 0, 4, 0.75)
    predicted = frac * ring_bytes(group, 4.0 * count)
    got = res.history["comm_bytes"][0][1]
    log(f"  step 0 comm_bytes {got:.1f}, predicted {predicted:.1f} from the "
        f"twin's {count} masked elements, {group} of 4 nodes alive")
    check(abs(got - predicted) <= 1e-6 * predicted,
          f"8a: step 0 comm_bytes {got} != predicted {predicted}")
    del res
    # 8b: FedAvg with 16-node islands among 64 nodes
    strat = FedAvgStrategy(adamw, H=2, island_size=16, **SCHED)
    run("phase 8b flagship FedAvg islands", flagship, 64, 16, 6, strat, True)
    # 8c: ZeRO-1 against SimpleReduce, both AdamW
    peaks = {}
    for title, cls in (("ZeRO-1", ZeroReduceStrategy),
                       ("SimpleReduce", SimpleReduceStrategy)):
        run(f"phase 8c gpt2-base {title}", base, 4, 4, 3,
            cls(adamw, **SCHED), False)
        peaks[title] = torch.cuda.max_memory_allocated()
    log(f"  8c peak memory on {card}: ZeRO-1 "
        f"{peaks['ZeRO-1'] / 2**30:.2f} GiB, SimpleReduce "
        f"{peaks['SimpleReduce'] / 2**30:.2f} GiB")
    check(peaks["ZeRO-1"] < peaks["SimpleReduce"],
          "8c: ZeRO-1 did not lower the peak memory")
    return c8a


def flagship_params(flagship):
    """A node's parameter count of the GPT at ``flagship``."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    return sum(math.prod(shape) for shape, _ in
               GPT(GPTConfig(**flagship))._param_specs().values())


def compression_phase(torch, mods, card, flagship, nodes=16, batch=16,
                      steps=4):
    """8d: the compression strategies at the flagship, K=16 × 16, 4 steps,
    H 2: every step's ``comm_bytes`` against the prediction from the
    codec's wire bytes, exact launches of B1/B2, of the codec kernel (once
    a compress call) and of the bits kernel (a shared key's one draw a
    call, DynamiQ's, where the codec reads it). Returns the codec and bits
    kernels' launches summed over the runs."""
    from gym_tpu_torch.strategy import (DecoupledMomentumStrategy,
                                        DiLoCoStrategy, DynamiQStrategy,
                                        NoLoCoStrategy, OptimSpec)
    from gym_tpu_torch.strategy.compress import QuantizeCodec, TopKCodec
    adamw = OptimSpec("adamw", lr=3e-4)
    n, k = flagship_params(flagship), nodes
    shard = -(-n // k)
    int8, topk = QuantizeCodec(bits=8).wire_bytes, TopKCodec().wire_bytes
    ring = 2.0 * (k - 1) / k
    rounds = [s % 2 == 0 and s > 0 for s in range(steps)]
    syncs = sum(rounds)
    # a DynamiQ step's two hops each draw their shared key's bits once
    hop_bits = 2 * steps
    # (title, strategy, comm_bytes a step, codec launches, bits launches)
    runs = [
        ("decoupled momentum top-k",
         DecoupledMomentumStrategy(adamw, H=2, **SCHED),
         [ring * topk(n) * r for r in rounds], 0, 0),
        ("NoLoCo dense", NoLoCoStrategy(adamw, H=2, **SCHED),
         [4.0 * n * r for r in rounds], 0, 0),
        ("NoLoCo int8", NoLoCoStrategy(adamw, H=2, codec="int8", **SCHED),
         [int8(n) * r for r in rounds], syncs, 0),
        ("DynamiQ int8", DynamiQStrategy(adamw, codec="int8", **SCHED),
         [(k - 1) / k * (int8(n) + k * int8(shard))] * steps, 2 * steps,
         hop_bits),
        ("DynamiQ top-k", DynamiQStrategy(adamw, codec="topk", **SCHED),
         [(k - 1) / k * (topk(n) + k * topk(shard))] * steps, 0, 0),
        ("DiLoCo int8", DiLoCoStrategy(adamw, H=2, codec="int8", **SCHED),
         [ring * int8(n) * r for r in rounds], syncs, 0),
    ]
    total = {"T1_quantize_tiles": 0, "T1_threefry_bits": 0}
    for title, strat, comm, codec_calls, bits in runs:
        title = f"phase 8d flagship {title}"
        counts, res = train_phase(torch, mods, title, flagship, k, batch,
                                  steps, (), strategy=strat)
        want = expected_launches(res, flagship, steps, True)
        want["T1_quantize_tiles"] = codec_calls
        want["T1_threefry_bits"] = bits
        log(f"  {title} on {card}: steady steps/s "
            f"{res.steps_per_second_steady}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(counts == want, f"{title}: launches {counts}, expected {want}")
        got = [c for _, c in res.history["comm_bytes"]]
        log(f"  comm_bytes a step {got}, predicted from the codec's wire "
            f"bytes ({n} params a node) {[float(x) for x in comm]}")
        check(all(abs(a - b) <= 1e-6 * max(b, 1.0) for a, b in
                  zip(got, comm)) and len(got) == steps,
              f"{title}: comm_bytes {got} != predicted {comm}")
        log(f"  launches exactly as expected: {want}")
        for name in total:
            total[name] += counts[name]
        del res
    return total


def codec_full_width(torch, mods, card, base, nodes=4, batch=4, steps=4):
    """8e: DiLoCo with the int8 codec at GPT-2 base, K=4 × 4 rows, bf16, H
    2: its one sync's compress of [4, 124,475,904] is one launch of the
    codec kernel and none of the bits kernel; ``comm_bytes`` against the
    codec's wire bytes; steady steps/s and peak memory. Returns its
    counts."""
    from gym_tpu_torch.strategy import DiLoCoStrategy, OptimSpec
    from gym_tpu_torch.strategy.compress import QuantizeCodec
    title = "phase 8e gpt2-base DiLoCo int8"
    strat = DiLoCoStrategy(OptimSpec("adamw", lr=3e-4), H=2, codec="int8",
                           **SCHED)
    counts, res = train_phase(torch, mods, title, base, nodes, batch, steps,
                              (), strategy=strat)
    rounds = [s % 2 == 0 and s > 0 for s in range(steps)]
    want = expected_launches(res, base, steps, False)
    want["T1_quantize_tiles"] = sum(rounds)
    n = flagship_params(base)
    comm = [2.0 * (nodes - 1) / nodes * QuantizeCodec(bits=8).wire_bytes(n)
            * r for r in rounds]
    log(f"  {title} on {card}: steady steps/s {res.steps_per_second_steady},"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({n} params a node; the compress of [{nodes}, {n}] at step 2)")
    check(counts == want, f"{title}: launches {counts}, expected {want}")
    got = [c for _, c in res.history["comm_bytes"]]
    check(len(got) == steps and all(abs(a - b) <= 1e-6 * max(b, 1.0)
                                    for a, b in zip(got, comm)),
          f"{title}: comm_bytes {got} != predicted {comm}")
    log(f"  launches exactly as expected: {want}; comm_bytes a step {got}")
    del res
    torch.cuda.empty_cache()
    return counts


# -- phase 9: the BASELINE configs ------------------------------------------

LOGS = os.path.join(HERE, "build", "chip_smoke_logs")
DATA = os.path.join(HERE, "build", "chip_smoke_data")
# run_baselines.py's MNIST settings
MNIST_BATCH, MNIST_MICRO = 256, 64


def mnist_strategy(which, optim=None, warmup=100):
    """The MNIST example's strategies: Adam 1e-3 with the lambda_cosine
    warmup of 100 steps; DiLoCo's H cut from 100 to 2 so that outer steps
    fire in a short run; SPARTA p 0.005."""
    from gym_tpu_torch.strategy import (DiLoCoStrategy, OptimSpec,
                                        SimpleReduceStrategy, SPARTAStrategy)
    optim = optim or OptimSpec("adam", lr=1e-3)
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": warmup})
    if which == "diloco":
        return DiLoCoStrategy(optim, H=2, **sched)
    if which == "sparta":
        return SPARTAStrategy(optim, p_sparta=0.005, **sched)
    return SimpleReduceStrategy(optim, **sched)


def mnist_fit(strategy, nodes, steps, device, batch, micro, run_name,
              autocast=False, init_params=None, val_size=256, seed=0,
              val_interval=None):
    """The MNIST CNN on the digits. Evals by default at step 0 and after
    the last step only: configs 1-3 eval 5 times in 300 steps, so a steady
    window of a few steps holds none."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import load_digits_mnist
    from gym_tpu_torch.models import MnistLossModel
    return Trainer(MnistLossModel(), load_digits_mnist(True),
                   load_digits_mnist(False)).fit(
        strategy=strategy, num_nodes=nodes, max_steps=steps,
        batch_size=batch, minibatch_size=micro, device=device,
        autocast=autocast, seed=seed, val_size=val_size,
        val_interval=val_interval or steps, init_params=init_params,
        show_progress=False, log_dir=LOGS, run_name=run_name)


def baseline_run(torch, mods, card, title, fit, steps, want, ln_first):
    """One BASELINE config: losses, steady steps/s, peak memory and the
    exact launch counts ``want`` (every kernel not named: 0)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = fit()
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in res.history["train_loss"]]
    log(f"{title}: train losses {['%.5f' % l for l in losses]}")
    for (step, lo), (_, gl) in zip(res.history["local_loss"],
                                   res.history["global_loss"]):
        log(f"  eval at step {step}: local {lo:.6f} global {gl:.6f}")
    log(f"  {title} on {card}: steady steps/s "
        f"{res.steps_per_second_steady} (all {res.steps_per_second:.4f}), "
        f"wall {wall:.1f} s incl. init, peak memory {peak / 2**30:.3f} GiB, "
        f"final loss {res.final_train_loss:.6f}")
    log(f"  launches: {counts}")
    check(len(losses) == steps and all(math.isfinite(l) for l in losses),
          f"{title}: non-finite or missing losses {losses}")
    check(abs(losses[0] - ln_first) < 0.7, f"{title}: first loss "
          f"{losses[0]} far from ln(classes) = {ln_first:.3f}")
    full = {k: 0 for k in KERNELS}
    full.update(want)
    for name, n in full.items():
        check(counts[name] == n, f"{title}: {name} launched {counts[name]} "
              f"times, expected {n}")
    log(f"  launches exactly as expected: { {k: n for k, n in want.items()} }")
    return counts, res


# BASELINE config 4 at run_baselines.py's settings, H cut from 100 to 2
CONFIG4 = dict(block=256, nodes=16, batch=16, n_layer=4)


def config4_fit(steps, val_size=256, run_name="9d_fedavg"):
    """nanoGPT "small" on the docs stream, FedAvg (AdamW 3e-4, H 2), f32,
    the packed kernels (``attn_impl="flash"``). Evals at step 0 and after
    the last step only: config 4 evals 5 times in 300 steps, so a steady
    window of a few steps holds none."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import get_dataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import FedAvgStrategy, OptimSpec
    block, batch = CONFIG4["block"], CONFIG4["batch"]
    train, vocab = get_dataset("docs", block, end_pc=0.9, data_root=DATA)
    val, _ = get_dataset("docs", block, start_pc=0.9, data_root=DATA)
    cfg = GPTConfig.gpt2_size_map("small")
    cfg.vocab_size, cfg.block_size, cfg.attn_impl = int(vocab), block, \
        "flash"
    sched = dict(lr_scheduler="lambda_cosine", lr_scheduler_kwargs={
        "warmup_steps": min(100, steps // 5)})
    strategy = FedAvgStrategy(inner_optim=OptimSpec("adamw", lr=3e-4), H=2,
                              **sched)
    return Trainer(GPT(cfg), train, val).fit(
        strategy=strategy, num_nodes=CONFIG4["nodes"], max_steps=steps,
        batch_size=batch, minibatch_size=batch, device="cuda",
        val_size=val_size, val_interval=steps,
        show_progress=False, log_dir=LOGS, run_name=run_name)


# BASELINE config 5 at run_baselines.py's settings (its 300 steps give the
# warmup min(100, 300 // 5) = 60), cut to 6 steps
CONFIG5 = dict(block=256, nodes=64, batch=16, n_layer=4, warmup=60)
# its picks a step: (200 + 108 + 4) chunks × 32 picks × 8 bytes, and the
# K − 1 = 63 other nodes' picks received
CONFIG5_COMM, CONFIG5_RECV = 79_872, 5_031_936


def config5_fit(steps, val_size=256, run_name="9f_demo"):
    """nanoGPT "small" on the docs stream, 64-node DeMo (SGD 1e-3, top-k 32,
    chunk 64), f32, the packed kernels; evals at step 0 and after the last
    step only."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import get_dataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import DeMoStrategy, OptimSpec
    block, batch = CONFIG5["block"], CONFIG5["batch"]
    train, vocab = get_dataset("docs", block, end_pc=0.9, data_root=DATA)
    val, _ = get_dataset("docs", block, start_pc=0.9, data_root=DATA)
    cfg = GPTConfig.gpt2_size_map("small")
    cfg.vocab_size, cfg.block_size, cfg.attn_impl = int(vocab), block, \
        "flash"
    strategy = DeMoStrategy(
        optim_spec=OptimSpec("sgd", lr=1e-3), compression_topk=32,
        compression_chunk=64, lr_scheduler="lambda_cosine",
        lr_scheduler_kwargs={"warmup_steps": CONFIG5["warmup"]})
    return Trainer(GPT(cfg), train, val).fit(
        strategy=strategy, num_nodes=CONFIG5["nodes"], max_steps=steps,
        batch_size=batch, minibatch_size=batch, device="cuda",
        val_size=val_size, val_interval=steps,
        show_progress=False, log_dir=LOGS, run_name=run_name)


def cnn_leaves():
    """(JAX leaf index, per-node element count) of every leaf of the CNN,
    as SPARTA keys its masks."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.models.mnist_cnn import MnistLossModel
    specs = MnistLossModel().cnn.param_specs()
    order = jax_leaf_order(specs)
    return [(order[n], math.prod(shape)) for n, (shape, _) in specs.items()]


def cnn_dropout_paths():
    from gym_tpu_torch.models.mnist_cnn import MnistLossModel
    return MnistLossModel().cnn.dropout_paths()


def baseline_phase(torch, mods, card):
    """9a-9d; returns the counts of 9b (T1's per-row entry) and 9d (the f32
    packed pair)."""
    import numpy as np
    import zlib
    from gym_tpu_torch.data import build_docs_corpus

    steps = 8
    rows = len(CNN_DROPOUTS) * (MNIST_BATCH // MNIST_MICRO) * steps
    counts = {}
    for tag, which, nodes in (("9a", "simple_reduce", 2),
                              ("9b", "diloco", 8), ("9c", "sparta", 8)):
        want = {"T1_threefry_bernoulli_rows": rows}
        if which == "sparta":
            want["T1_threefry_bernoulli"] = steps  # every leaf in one
        counts[tag], _ = baseline_run(
            torch, mods, card,
            f"phase {tag} MNIST K={nodes} {which} (batch {MNIST_BATCH}, "
            f"microbatch {MNIST_MICRO}, {steps} steps, f32)",
            lambda: mnist_fit(mnist_strategy(which), nodes, steps, "cuda",
                              MNIST_BATCH, MNIST_MICRO, f"9_{which}"),
            steps, want, math.log(10))

    # 9d: config 4 on the docs stream of the checkout's gym_tpu/
    stream = build_docs_corpus(DATA)
    crc = zlib.crc32(np.ascontiguousarray(stream).tobytes())
    log(f"phase 9d docs stream: {len(stream)} tokens, crc32 {crc} (expected "
        f"{DOCS_TOKENS}, {DOCS_CRC})")
    check(len(stream) == DOCS_TOKENS and crc == DOCS_CRC,
          "9d: the docs stream differs from the checkout's gym_tpu/ stream")
    steps, layers, batch = 6, CONFIG4["n_layer"], CONFIG4["batch"]
    val_size = 256
    # all in f32: the forward once a layer a step and, each eval, twice a
    # layer a validation microbatch (local and global params); evals at
    # step 0 and after the last step
    evals = 2
    fwd = layers * (steps + 2 * evals * (val_size // batch))
    want = {"B1_fwd_packed_f32": fwd, "B2_bwd_packed_f32": layers * steps}
    counts["9d"], res = baseline_run(
        torch, mods, card,
        f"phase 9d nanoGPT small K={CONFIG4['nodes']} x {batch} rows "
        f"T={CONFIG4['block']} vocab 66 FedAvg (H 2, {steps} steps, f32)",
        lambda: config4_fit(steps, val_size), steps, want, math.log(66))
    check(len(res.history["global_loss"]) == evals,
          f"9d: {len(res.history['global_loss'])} evals, expected {evals}")
    del res

    # 9f: config 5, 64-node DeMo: D1 once a tile signature a step
    nodes, layers = CONFIG5["nodes"], CONFIG5["n_layer"]
    fwd = layers * (steps + 2 * evals * (val_size // batch))
    want = {"B1_fwd_packed_f32": fwd, "B2_bwd_packed_f32": layers * steps,
            "D1_scatter_mean": 3 * steps}
    counts["9f"], res = baseline_run(
        torch, mods, card,
        f"phase 9f nanoGPT small K={nodes} x {batch} rows T={CONFIG5['block']}"
        f" vocab 66 DeMo (SGD 1e-3, top-k 32, chunk 64, warmup "
        f"{CONFIG5['warmup']}, {steps} steps, f32)",
        lambda: config5_fit(steps, val_size), steps, want, math.log(66))
    comm = res.history["comm_bytes"][0][1]
    recv = res.history["comm_recv_bytes"][0][1]
    log(f"  9f step 0: comm_bytes {comm}, comm_recv_bytes {recv} (expected "
        f"{CONFIG5_COMM}, {CONFIG5_RECV})")
    check(comm == CONFIG5_COMM and recv == CONFIG5_RECV,
          f"9f: step 0 comm_bytes {comm}, comm_recv_bytes {recv}")
    glob = [l for _, l in res.history["global_loss"]]
    check(len(glob) == evals and all(math.isfinite(l) for l in glob)
          and glob[-1] < glob[0], f"9f: the global eval loss did not fall: "
          f"{glob}")
    log(f"  9f global eval loss {glob[0]:.6f} -> {glob[-1]:.6f}")
    return counts


def cnn_card_vs_cpu(torch, mods):
    """9e: the CNN's train losses and global evals on the card and on the
    CPU from the same weights, batches and dropout masks (T1 on the card,
    the twin on the CPU), f32 and bf16."""
    from gym_tpu_torch.models import MnistLossModel
    from gym_tpu_torch.strategy import OptimSpec
    init = {n: p[0] for n, p in MnistLossModel().init_params(
        1, seed=11, device="cpu").items()}
    nodes, batch, micro, steps = 2, 8, 4, 3
    for mode, autocast in (("bf16", True), ("f32", False)):
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts(mods)
            res = mnist_fit(mnist_strategy("simple_reduce",
                                           OptimSpec("sgd", lr=1e-3), 1),
                            nodes, steps, device, batch, micro,
                            f"9e_{mode}_{device}", autocast=autocast,
                            init_params=init, val_size=micro, seed=5,
                            val_interval=1)
            out[device] = [l for _, l in res.history["train_loss"]] + [
                l for _, l in res.history["global_loss"]]
            if device == "cuda":
                n = read_counts(mods)["T1_threefry_bernoulli_rows"]
                want = len(CNN_DROPOUTS) * (batch // micro) * steps
                check(n == want, f"9e: the card drew {n} per-row masks, "
                      f"expected {want}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"],
                                                      out["cpu"]))
        log(f"phase 9e CNN card vs CPU {mode}: cuda "
            f"{['%.6f' % x for x in out['cuda']]}")
        log(f"                              cpu  "
            f"{['%.6f' % x for x in out['cpu']]}")
        log(f"  max rel diff {rel:.3e} (band {LOSS_RTOL[mode]})")
        check(rel <= LOSS_RTOL[mode], f"9e CNN card vs CPU {mode}: losses "
              f"differ by {rel:.3e} > {LOSS_RTOL[mode]}")


# -- the serving path: B7, R1, L1 and T1's bits rows (phases 2, 3, 7, 10) ----


SERVING_KERNELS = ("B7_decode_attention", "R1_row_gemm",
                   "L1_row_add_layer_norm", "T1_threefry_bits_rows")
# GPT-2 base's serving shapes: heads, head dim, window, page
SERVE_H, SERVE_HD, SERVE_S, SERVE_PAGE = 12, 64, 1024, 16
# GPT-2 base's four dense layers (in, out) and the tied lm head
DENSE_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
LM_HEAD = (768, 50304)


# R1 and B6: 5 tilings of row_gemm_pipe_kernel for each of the two weight
# sources (F32Src, Q8Src); their oracle, row_gemm_ref_kernel, at its 2
# tilings x 2 layouts for each of its loaders (F32W, QuantW)
ROW_PIPE_KERNELS = 10


# B7 and B7 int8: the kernel at 4 head dims x 2 paths for each pool type
# (F32Pools, Int8Pools); their oracle at 4 head dims for each loader (F32KV,
# Int8KV). L1 with the add: 7 instances (columns a lane); the oracle L1
B7_KERNELS = 16
ADD_LN_KERNELS = 7


def check_serving_sass(counts):
    """B7, R1, L1 and the bits-rows entry are built, without atomics (the
    global check above); B7 and its int8 form (one kernel templated on the
    pools, the head dim and the path) and their oracle (the first kernel,
    templated on the pool's loader) at 4 head dims each; R1 and B6 (one
    kernel templated on the tiling, the layout and the weight source) in
    every tiling; L1 with the add and its oracle; R1, B6, B7 and L1 FMA
    chains without a tensor-core instruction (HMMA, HGMMA) or an atomic."""
    for name, n in (("decode_attention_ref_kernel", 8), ("F32KV", 4),
                    ("Int8KV", 4), ("decode_attention_kernel", B7_KERNELS),
                    ("F32Pools", B7_KERNELS // 2),
                    ("Int8Pools", B7_KERNELS // 2),
                    ("row_gemm_ref_kernel", 8), ("F32W", 4),
                    ("QuantW", 4), ("row_gemm_pipe_kernel", ROW_PIPE_KERNELS),
                    ("F32Src", ROW_PIPE_KERNELS // 2),
                    ("Q8Src", ROW_PIPE_KERNELS // 2),
                    ("row_layer_norm_kernel", 1),
                    ("row_add_layer_norm_kernel", ADD_LN_KERNELS),
                    ("threefry_rows_bits_kernel", BITS_ROWS_KERNELS),
                    ("threefry_rows_bits_ref_kernel", 1)):
        found = [k for k in counts if name in k]
        check(len(found) == n, f"expected {n} {name}, found {found}")
        for k in found:
            log(f"  {k}: FFMA {counts[k]['FFMA']}, HMMA {counts[k]['HMMA']}, "
                f"HGMMA {counts[k]['HGMMA']}, ATOM/RED "
                f"{counts[k]['ATOM/RED']}")
    for k in counts:
        if any(n in k for n in ("row_gemm_pipe_kernel", "decode_attention",
                                "layer_norm_kernel")):
            c = counts[k]
            check(c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0
                  and c["ATOM/RED"] == 0, f"{k}: R1, B6, B7 and L1 must be "
                  f"FFMA chains without tensor cores or atomics ({c})")


# T1 bits on its main path: the 256-tile kernel and the any-tile kernel,
# each rounding to nearest, drawing the bits (16 threefry evaluations a
# lane, one) or reading them
QUANTIZE_KERNELS = 6


def kernel_label(name):
    """A demangled kernel name without its parameter list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def check_quantize_sass(counts):
    """The codec kernel's six instances, without atomics (the global check
    above): its threefry inlined whole, 20 rotations an evaluation, 16
    evaluations a lane in the 256-tile kernel's drawing instance, one in
    the any-tile kernel's, none where the bits are read or not needed."""
    rots = {}
    for name in ("quantize_tiles_kernel", "quantize_tiles_any_kernel"):
        found = [k for k in counts if name + "<" in k or name + "I" in k]
        check(len(found) == QUANTIZE_KERNELS // 2, f"expected "
              f"{QUANTIZE_KERNELS // 2} {name}, found {found}")
        rots[name] = sorted(counts[k]["ROT"] for k in found)
        for k in found:
            c = counts[k]
            log(f"  {kernel_label(k)}: ALU {c['ALU']}, rotations {c['ROT']}, "
                f"FFMA {c['FFMA']} (the IEEE division's), ATOM/RED "
                f"{c['ATOM/RED']}")
    check(rots == {"quantize_tiles_kernel": [0, 0, 16 * 20],
                   "quantize_tiles_any_kernel": [0, 0, 20]},
          f"T1_quantize_tiles: rotations {rots}, expected 16 threefry "
          f"evaluations of 20 in the 256-tile kernel that draws, one in the "
          f"any-tile kernel's")


# B8's kernels: the TMA path's three (the forward with w as it lies and
# read transposed, the outer), the first bf16 kernels kept as their oracle
# (grouped_*_ref_kernel), the f32 ring kernels' seven (the forward in three
# tilings, each with w as it lies and read transposed, and the outer) and
# the first f32 kernels kept as their oracle (grouped_*_f32_ref_kernel)
B8_KERNELS = {"tma": 3, "ref": 2, "f32": 7, "f32_ref": 2}
B8_NAMES = ("grouped_gemm_kernel", "grouped_outer_kernel",
            "grouped_gemm_ref_kernel", "grouped_outer_ref_kernel",
            "grouped_gemm_f32_kernel", "grouped_outer_f32_kernel",
            "grouped_gemm_f32_ref_kernel", "grouped_outer_f32_ref_kernel")


def b8_kind(name):
    """"tma", "ref", "f32" or "f32_ref" for a B8 kernel's name (demangled
    or not), else None."""
    if not any(n in name for n in B8_NAMES):
        return None
    if "CUtensorMap" in name:
        return "tma"
    if "_f32_ref_kernel" in name:
        return "f32_ref"
    return "f32" if "_f32_kernel" in name else "ref"


def check_b8_sass(counts):
    """B8's kernels without atomics: the TMA path's bf16 kernels on wgmma
    (HGMMA, no HMMA), the first bf16 kernels kept as the oracle on
    mma.sync (HMMA, no HGMMA), the f32 kernels and their oracle FFMA
    chains without a tensor-core instruction."""
    found = {kind: [] for kind in B8_KERNELS}
    for k, c in counts.items():
        kind = b8_kind(k)
        if kind is None:
            continue
        found[kind].append(k)
        log(f"  {kernel_label(k)} ({kind}): HGMMA {c['HGMMA']}, HMMA "
            f"{c['HMMA']}, FFMA {c['FFMA']}, ATOM/RED {c['ATOM/RED']}")
        check(c["ATOM/RED"] == 0, f"{k}: an atomic in B8")
        if kind == "tma":
            check(c["HGMMA"] > 0 and c["HMMA"] == 0,
                  f"{k}: the TMA path's B8 must run on wgmma ({c})")
        elif kind == "ref":
            check(c["HMMA"] > 0 and c["HGMMA"] == 0,
                  f"{k}: B8's first bf16 kernel runs on mma.sync ({c})")
        else:
            check(c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0,
                  f"{k}: f32 B8 must be FFMA chains ({c})")
    check({k: len(v) for k, v in found.items()} == B8_KERNELS,
          f"B8 kernels {found}, expected {B8_KERNELS} of each kind")


B8_OCCUPANCY = ("grouped_gemm_kernel (bf16, w as it lies)",
                "grouped_gemm_kernel (bf16, w read transposed)",
                "grouped_outer_kernel (bf16)",
                "grouped_gemm_f32_kernel (few rows, w read transposed)",
                "grouped_gemm_f32_kernel (few rows, w as it lies)",
                "grouped_gemm_f32_kernel (prefill, w read transposed)",
                "grouped_gemm_f32_kernel (prefill, w as it lies)",
                "grouped_gemm_f32_kernel (many rows, w read transposed)",
                "grouped_gemm_f32_kernel (many rows, w as it lies)",
                "grouped_outer_f32_kernel")


def b8_occupancy(lib):
    """The TMA path's and the f32 ring kernels: blocks an SM, threads,
    registers, shared memory."""
    for kind, name in enumerate(B8_OCCUPANCY):
        threads, regs = ctypes.c_int(), ctypes.c_int()
        smem = ctypes.c_longlong()
        per_sm = lib.gym_grouped_occupancy(kind, ctypes.byref(threads),
                                           ctypes.byref(regs),
                                           ctypes.byref(smem))
        check(per_sm >= 1, f"B8 {name} cannot be resident ({per_sm})")
        log(f"  B8 {name}: {threads.value} threads at {regs.value} "
            f"registers, {smem.value} B of shared memory, {per_sm} "
            f"block(s) per SM")


def row_gemm_report(build_log, nvcc, kernels=("row_gemm_pipe_kernel",
                                              "row_gemm_ref_kernel"),
                    want=ROW_PIPE_KERNELS + 8):
    """The kernels whose names hold one of ``kernels`` (R1's and B6's, and
    their oracle's, by default): registers and spill stores from the
    ``ptxas`` report, a line each; ``want`` of them."""
    found, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in kernels) \
                else None
            spill = 0
            continue
        m = _PTXAS_SPILL.search(line)
        if m and name:
            spill = int(m.group(1))
        m = _PTXAS_USED.search(line)
        if m and name:
            found.append((name, int(m.group(1)), spill))
            name = None
    check(len(found) == want, f"ptxas reported {len(found)} kernels of "
          f"{kernels}, expected {want}")
    for dem, (_, regs, spill) in zip(demangle(nvcc, [f[0] for f in found]),
                                     found):
        log(f"  {kernel_label(dem)}: {regs} registers, {spill} B spilled")


# T1 bits rows' kernel: one instantiation a number of groups a lane (1, 2,
# 4, 8) for rows shorter than 2^32 elements, and one for longer rows
BITS_ROWS_KERNELS = 5
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def d1_t1_report(build_log, nvcc, tsm):
    """D1's and T1 bits rows' kernels and their oracles: registers, spill
    stores and static shared memory from the ``ptxas`` report, a line
    each; D1's dynamic shared memory and launch plan at config 5's three
    row widths."""
    found, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in (
                "scatter_mean", "threefry_rows_bits")) else None
            spill = 0
            continue
        m = _PTXAS_SPILL.search(line)
        if m and name:
            spill = int(m.group(1))
        m = _PTXAS_USED.search(line)
        if m and name:
            smem = _PTXAS_SMEM.search(line)
            found.append((name, int(m.group(1)), spill,
                          int(smem.group(1)) if smem else 0))
            name = None
    want = 2 + BITS_ROWS_KERNELS + 1
    check(len(found) == want, f"ptxas reported {len(found)} D1 and T1 bits "
          f"rows kernels, expected {want}")
    for dem, (_, regs, spill, smem) in zip(
            demangle(nvcc, [f[0] for f in found]), found):
        log(f"  {dem.split('(')[0]}: {regs} registers, {spill} B spilled, "
            f"{smem} B static shared memory")
    for rows, _, e in D1_SHAPES:
        p = tsm.launch_plan(rows, e)
        log(f"  scatter_mean_kernel at (G, E) = ({rows}, {e}): a warp "
            f"{p['run']} slots, "
            f"{p['warps']} warps a block, {p['blocks_a_row']} blocks a row, "
            f"{p['smem_bytes']} B dynamic shared memory a block")


def paged_window(torch, g, b, extra=1):
    """A pool holding b rows' windows on shuffled pages (page 0 the null
    page) and the same windows as an unpaged [b, S, H, hd] cache."""
    s, page, h, hd = SERVE_S, SERVE_PAGE, SERVE_H, SERVE_HD
    nblk = s // page
    k_rows = torch.randn(b, s, h, hd, device="cuda", generator=g)
    v_rows = torch.randn(b, s, h, hd, device="cuda", generator=g)
    pages = 1 + b * nblk + extra
    perm = 1 + torch.randperm(pages - 1, device="cuda", generator=g)
    table = perm[:b * nblk].view(b, nblk).to(torch.int32)
    k_pool = torch.randn(pages, page, h, hd, device="cuda", generator=g)
    v_pool = torch.randn(pages, page, h, hd, device="cuda", generator=g)
    k_pool[table.long()] = k_rows.view(b, nblk, page, h, hd)
    v_pool[table.long()] = v_rows.view(b, nblk, page, h, hd)
    return k_rows, v_rows, k_pool, v_pool, table


def check_b7(torch, tdec, g):
    """B7 against its twin (phase 3's f32 band) at GPT-2 base's shapes, B7
    paged against unpaged bit for bit, and a query's bits independent of
    the batch, the number of queries and its tile."""
    h, hd, s = SERVE_H, SERVE_HD, SERVE_S
    k_rows, v_rows, k_pool, v_pool, table = paged_window(torch, g, 16)
    cursors = torch.randint(0, s, (16,), device="cuda", generator=g,
                            dtype=torch.int32)
    cursors[0], cursors[1] = 0, s - 1
    worst = 0.0
    cases = []
    q1 = torch.randn(16, 1, h, hd, device="cuda", generator=g)
    cases.append(("decode b=16 t=1 (paged, page 16)", q1, k_pool, v_pool,
                  table, cursors))
    q5 = torch.randn(16, 5, h, hd, device="cuda", generator=g)
    vcur = torch.clamp(cursors, max=s - 3)       # two queries clamp at S-1
    cases.append(("verify b=16 t=5", q5, k_pool, v_pool, table, vcur))
    for t in (512, 1024):
        qp = torch.randn(1, t, h, hd, device="cuda", generator=g)
        cases.append((f"prefill b=1 t={t} start 0", qp, k_pool, v_pool,
                      table[:1], torch.zeros(1, dtype=torch.int32,
                                             device="cuda")))
    # a prefix hit: rows 2 and 3 share row 0's first 16 pages (256
    # positions) and prefill 256 more from position 256
    shared = table[:4].clone()
    shared[1:, :16] = shared[0, :16]
    qh = torch.randn(4, 256, h, hd, device="cuda", generator=g)
    cases.append(("prefix-hit prefill b=4 t=256 start 256 (shared pages)",
                  qh, k_pool, v_pool, shared,
                  torch.full((4,), 256, dtype=torch.int32, device="cuda")))
    unp = tdec.unpaged_table(16, "cuda")
    cases.append(("unpaged decode b=16 t=1", q1, k_rows, v_rows, unp,
                  cursors))
    for name, q, kp, vp, tb, cur in cases:
        got = tdec.decode_attention(q, kp, vp, tb, cur)
        ref = tdec.plain_decode_attention(q, kp, vp, tb, cur)
        worst = max(worst, compare(f"B7 {name}", got, ref, "out",
                                   torch.float32))
        ok = same_bits(torch, got, tdec.decode_attention_ref(q, kp, vp, tb,
                                                             cur))
        log(f"  B7 {name} ({tdec.PATHS[tdec.path_of(q.shape[1])]}) vs the "
            f"oracle: {'bit-identical' if ok else 'DIFFER'}")
        check(ok, f"B7 {name} differs from its oracle")
    # paged against unpaged, bit for bit, decode and verify
    for name, q, cur in (("t=1", q1, cursors), ("t=5", q5, vcur)):
        a = tdec.decode_attention(q, k_pool, v_pool, table, cur)
        b = tdec.decode_attention(q, k_rows, v_rows, unp, cur)
        ok = same_bits(torch, a, b)
        log(f"  B7 paged vs unpaged {name}: "
            f"{'bit-identical' if ok else 'DIFFER'}")
        check(ok, f"B7 paged and unpaged differ at {name}")
    # a query alone against the same query in the batch, in a verify
    # chunk and inside a prefill tile
    full = tdec.decode_attention(q5, k_pool, v_pool, table, vcur)
    ok = True
    for r in (0, 5, 15):
        for j in range(5):
            one = tdec.decode_attention(
                q5[r:r + 1, j:j + 1].contiguous(), k_pool, v_pool,
                table[r:r + 1], vcur[r:r + 1] + j)
            ok &= same_bits(torch, one[0, 0], full[r, j])
    pre = cases[3]
    pfull = tdec.decode_attention(pre[1], k_pool, v_pool, pre[4], pre[5])
    for j in (0, 1, 37, 511, 1023):
        one = tdec.decode_attention(pre[1][:, j:j + 1].contiguous(), k_pool,
                                    v_pool, pre[4], pre[5] + j)
        ok &= same_bits(torch, one[0, 0], pfull[0, j])
    log(f"  B7 a query alone vs in its batch, verify chunk and prefill: "
        f"{'bit-identical' if ok else 'DIFFER'}")
    check(ok, "B7: a query's bits depend on its batch or tile")
    torch.cuda.synchronize()
    return worst


# B7 against its oracle on the CPU tests' grid: the paths' regimes (a
# decode step, a verify chunk, a prefill tile and its edge, a 512-token
# prompt), every head dim, pages of 16 and 32 and the unpaged cache
B7_ORACLE_T = (1, 5, 16, 64, 512)
B7_ORACLE_PAGES = (16, 32, 0)          # 0: unpaged


def b7_oracle_case(torch, tdec, tfa, g, t, hd, page, int8, b=3, h=2,
                   s=1024):
    """q (a strided view of a projection), the pools (int8 with their
    scales when ``int8``), the table and the cursors: rows at 0, S - 1 (its
    queries past it clamp) and a random one."""
    nblk, pg = s // (page or s), page or s
    k_rows = torch.randn(b, s, h, hd, device="cuda", generator=g)
    v_rows = torch.randn(b, s, h, hd, device="cuda", generator=g)
    if page:
        pages = 2 + b * nblk
        perm = 1 + torch.randperm(pages - 1, device="cuda", generator=g)
        table = perm[:b * nblk].view(b, nblk).to(torch.int32)
        kp = torch.randn(pages, pg, h, hd, device="cuda", generator=g)
        vp = torch.randn(pages, pg, h, hd, device="cuda", generator=g)
        kp[table.long()] = k_rows.view(b, nblk, pg, h, hd)
        vp[table.long()] = v_rows.view(b, nblk, pg, h, hd)
    else:
        kp, vp, table = k_rows, v_rows, tdec.unpaged_table(b, "cuda")
    cur = torch.randint(1, s - 1, (b,), device="cuda", generator=g,
                        dtype=torch.int32)
    cur[0], cur[1] = 0, s - 1
    q = torch.randn(b, t, 3 * h * hd, device="cuda",
                    generator=g)[..., :h * hd].unflatten(-1, (h, hd))
    scales = ()
    if int8:
        (kp, ks), (vp, vs) = tfa.kv_quantize(kp), tfa.kv_quantize(vp)
        scales = (ks, vs)
    return q, kp, vp, scales, table, cur


def b7_call(tdec, case, ref=False, path=None):
    """B7 (or B7 int8: the case has scales) on the dispatch's path, on
    ``path``, or the oracle."""
    q, kp, vp, scales, table, cur = case
    if path is not None:
        return tdec.decode_attention_on_path(q, kp, vp, table, cur, path,
                                             scales)
    if scales:
        fn = (tdec.decode_attention_int8_ref if ref
              else tdec.decode_attention_int8)
        return fn(q, kp, vp, *scales, table, cur)
    fn = tdec.decode_attention_ref if ref else tdec.decode_attention
    return fn(q, kp, vp, table, cur)


def poison_past(torch, pool, table, cur, t, s, paged):
    """NaN at every position past each row's last query's and, paged, in
    every page no row maps."""
    pool = pool.clone()
    page = pool.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    for r in range(table.shape[0]):
        last = min(int(cur[r]) + t - 1, s - 1)
        p = torch.arange(last + 1, s, device="cuda")
        if paged:
            flat[table[r, p // page].long() * page + p % page] = float("nan")
        else:
            pool[r, last + 1:] = float("nan")
    if paged:
        mapped = torch.zeros(pool.shape[0], dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        pool[~mapped] = float("nan")
    return pool


def check_b7_oracle(torch, tdec, tfa, g):
    """B7 and B7 int8 bit for bit their oracles, on the dispatch's path and
    on every path, at t in B7_ORACLE_T x head dims 16-128 x B7_ORACLE_PAGES;
    NaN past each row's last position and in unmapped pages (K and V, or
    the int8 pools' scales) changing no bit (t = 1, 5, 64; page 16 and
    unpaged); a NaN scale making exactly its query's outputs NaN on every
    path, as in the oracle."""
    s = 1024
    bad, poisoned, total = [], [], 0
    for int8 in (False, True):
        for hd in (16, 32, 64, 128):
            for page in B7_ORACLE_PAGES:
                for t in B7_ORACLE_T:
                    case = b7_oracle_case(torch, tdec, tfa, g, t, hd, page,
                                          int8)
                    ref = b7_call(tdec, case, ref=True)
                    outs = [b7_call(tdec, case)] + [
                        b7_call(tdec, case, path=p)
                        for p in range(len(tdec.PATHS))]
                    total += len(outs)
                    bad += [(int8, hd, page, t, i) for i, o in
                            enumerate(outs) if not same_bits(torch, o, ref)]
                    if t == 512 or page == 32:
                        continue
                    q, kp, vp, scales, table, cur = case
                    if int8:
                        scales = tuple(poison_past(torch, x, table, cur, t, s,
                                                   bool(page))
                                       for x in scales)
                    else:
                        kp, vp = (poison_past(torch, x, table, cur, t, s,
                                              bool(page)) for x in (kp, vp))
                    dirty = (q, kp, vp, scales, table, cur)
                    outs = [b7_call(tdec, dirty), b7_call(tdec, dirty,
                                                          ref=True)] + [
                        b7_call(tdec, dirty, path=p)
                        for p in range(len(tdec.PATHS))]
                    poisoned += [(int8, hd, page, t, i) for i, o in
                                 enumerate(outs) if not same_bits(torch, o,
                                                                  ref)]
    log(f"  B7 and B7 int8 vs their oracles, {total} calls (t = "
        f"{', '.join(map(str, B7_ORACLE_T))}; hd 16-128; pages 16, 32 and "
        f"unpaged; the dispatch's path and {', '.join(tdec.PATHS)}): "
        f"{'bit-identical' if not bad else f'DIFFER at {bad[:8]}'}; NaN past "
        f"each row's last position and in unmapped pages: "
        f"{'no bit changed' if not poisoned else f'CHANGED {poisoned[:8]}'}")
    check(not bad, f"B7 differs from its oracle in {len(bad)} of {total} "
          f"calls")
    check(not poisoned, "B7 read past a query's last position or an "
          "unmapped page")
    q, kp, vp, (ks, vs), table, cur = b7_oracle_case(torch, tdec, tfa, g, 64,
                                                     64, 16, True)
    ks = ks.clone()
    ks[table[2, 0].long(), 0, 1] = float("nan")   # row 2, position 0, head 1
    want = torch.zeros(q.shape, dtype=torch.bool, device="cuda")
    want[2, :, 1] = True
    ref = tdec.decode_attention_int8_ref(q, kp, vp, ks, vs, table, cur)
    ok = torch.equal(torch.isnan(ref), want)
    for p in range(len(tdec.PATHS)):
        got = tdec.decode_attention_on_path(q, kp, vp, table, cur, p,
                                            (ks, vs))
        ok &= torch.equal(torch.isnan(got), want) and torch.equal(
            got[~want], ref[~want])
    log(f"  B7 int8: a NaN scale makes its query's outputs NaN on every "
        f"path, as in the oracle, and no other: {ok}")
    check(ok, "B7 int8: a NaN scale's reach differs between the paths and "
          "the oracle")
    torch.cuda.synchronize()


def rows_invariant(torch, fn, x, what):
    """fn on row r alone, bit for bit against row r of fn on the first 16,
    80 and all of x's rows (x has 1024)."""
    full = {m: fn(x[:m]) for m in (16, 80, x.shape[0])}
    ok = True
    for r in (0, 5, 15):
        one = fn(x[r:r + 1])[0]
        ok &= all(same_bits(torch, one, full[m][r]) for m in full)
    log(f"  {what}: a row alone vs in M = 16, 80, {x.shape[0]}: "
        f"{'bit-identical' if ok else 'DIFFER'}")
    return ok


def check_r1_l1(torch, trow, g):
    """R1 against its twin and torch.matmul at M in {1, 16, 80, 1024} x
    GPT-2 base's dense shapes and lm head, its rows bit for bit across M;
    L1 likewise; the same row-invariance question put to torch's own
    layer norm and cumsum, for the record."""
    worst_r1 = worst_l1 = 0.0
    for kin, nout in DENSE_SHAPES + (LM_HEAD,):
        lm = (kin, nout) == LM_HEAD
        w = torch.randn(*((nout, kin) if lm else (kin, nout)), device="cuda",
                        generator=g) * 0.02
        bias = None if lm else torch.randn(nout, device="cuda", generator=g)
        x = torch.randn(1024, kin, device="cuda", generator=g)
        for m in (1, 16, 80, 1024):
            got = trow.row_linear(x[:m], w, bias, w_nk=lm)
            ref = trow.plain_row_linear(x[:m], w, bias, w_nk=lm)
            lib = x[:m] @ (w.t() if lm else w)
            if bias is not None:
                lib = lib + bias
            tag = f"R1 [{m}, {kin}] x [{kin}, {nout}]{' (lm head)' if lm else ''}"
            worst_r1 = max(worst_r1, compare(tag, got, ref, "out",
                                             torch.float32))
            compare(tag + " vs torch.matmul", got, lib, "out", torch.float32)
        ok = rows_invariant(torch, lambda z: trow.row_linear(
            z, w, bias, w_nk=lm), x, f"R1 {kin}->{nout}")
        check(ok, f"R1 {kin}->{nout}: a row's bits depend on M")
        ok = rows_invariant(torch, lambda z: z @ (w.t() if lm else w), x,
                            f"torch.matmul {kin}->{nout} (for the record)")
        del w, bias, x
    x = torch.randn(1024, 768, device="cuda", generator=g) * 3 + 0.5
    scale = torch.randn(768, device="cuda", generator=g)
    bias = torch.randn(768, device="cuda", generator=g)
    for m in (1, 16, 80, 1024):
        worst_l1 = max(worst_l1, compare(
            f"L1 [{m}, 768]", trow.row_layer_norm(x[:m], scale, bias),
            trow.plain_row_layer_norm(x[:m], scale, bias), "out",
            torch.float32))
    ok = rows_invariant(torch, lambda z: trow.row_layer_norm(z, scale, bias),
                        x, "L1 768")
    check(ok, "L1: a row's bits depend on M")
    # L1 with the residual add: s a torch add and y the oracle L1 on it,
    # bit for bit, at C = 768 and 100 (not a multiple of 32)
    worst_l1 = 0.0
    for c in (768, 100):
        xc = torch.randn(1024, c, device="cuda", generator=g) * 3 + 0.5
        dc = torch.randn(1024, c, device="cuda", generator=g)
        sc = torch.randn(c, device="cuda", generator=g)
        bi = torch.randn(c, device="cuda", generator=g)
        same = True
        for m in (1, 16, 80, 512, 1024):
            sm, ym = trow.row_add_layer_norm(xc[:m], dc[:m], sc, bi)
            add = xc[:m] + dc[:m]
            same &= same_bits(torch, sm, add) and same_bits(
                torch, ym, trow.row_layer_norm(add, sc, bi))
            if c == 768:
                worst_l1 = max(worst_l1, compare(
                    f"L1 with the add [{m}, 768]", ym,
                    trow.plain_row_layer_norm(add, sc, bi), "out",
                    torch.float32))
        log(f"  L1 with the add [M, {c}] vs a torch add and the oracle L1 at"
            f" M = 1, 16, 80, 512, 1024: "
            f"{'bit-identical' if same else 'DIFFER'}")
        check(same, f"L1 with the add differs from a torch add and the "
              f"oracle L1 at C = {c}")
        ok = rows_invariant(torch, lambda z: trow.row_add_layer_norm(
            z, z * 0.5, sc, bi)[1], xc, f"L1 with the add {c}")
        check(ok, "L1 with the add: a row's bits depend on M")
    rows_invariant(torch, lambda z: trow.plain_row_layer_norm(z, scale, bias),
                   x, "torch's layer norm (the twin; for the record)")
    e = torch.rand(80, 50304, device="cuda", generator=g)
    e = torch.cat([e, e[:1].repeat(1024 - 80, 1)])
    ok = rows_invariant(torch, trow.row_cumsum, e, "row_cumsum 50304 (R1 "
                        "scan)")
    check(ok, "row_cumsum: a row's bits depend on the row count")
    rows_invariant(torch, lambda z: torch.cumsum(z, dim=-1), e,
                   "torch.cumsum 50304 (for the record)")
    compare("row_cumsum [80, 50304] vs torch.cumsum in f64",
            trow.row_cumsum(e[:80]), torch.cumsum(e[:80].double(), -1),
            "out", torch.float32)
    torch.cuda.synchronize()
    return worst_r1, worst_l1


# an FMA's latency on the card (cycles): one of R1's chains advances at most
# once in this many, so K FMAs take at least K of them at the highest SM
# clock (the chain floor, printed beside the bound and not folded into it)
FMA_CHAIN_CYCLES = 4
SCAN_BLOCK = 32
# phase 3: R1 against its oracle at every M-boundary of the dispatch and
# around it, and the sampler's scan at 16 and 80 rows (a decode step and a
# gamma-4 verify) of 50,304
R1_ORACLE_M = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 80, 128, 256, 512,
               1024)
SCAN_M = (16 * 1572, 80 * 1572)


def check_r1_oracle(torch, trow, g):
    """R1 bit for bit its oracle (the first kernel, whose bits the served
    path has) at every M of ``R1_ORACLE_M`` on GPT-2 base's dense shapes
    and lm head, on ragged shapes (K = 100 and 33, N = 50 and 7: K a
    multiple of no BK, rows not 16-byte aligned) in both layouts, with and
    without a bias, and on the scan's [16·1572, 32] and [80·1572, 32] x
    [32, 32]; then B6 int8 and int4 bit for bit R1 on the dequantized
    weights, and B6 its own oracle, at the same M."""
    from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
    mmax = max(R1_ORACLE_M)
    cases = [(kin, nout, (kin, nout) == LM_HEAD)
             for kin, nout in DENSE_SHAPES + (LM_HEAD,)]
    cases += [(k, n, nk) for k, n in ((100, 50), (33, 7))
              for nk in (False, True)]
    total = differ = 0
    for kin, nout, nk in cases:
        w = torch.randn(*((nout, kin) if nk else (kin, nout)), device="cuda",
                        generator=g) * 0.02
        bias = torch.randn(nout, device="cuda", generator=g)
        x = torch.randn(mmax, kin, device="cuda", generator=g)
        bad = []
        for m in R1_ORACLE_M:
            for b in (None, bias):
                got = trow.row_linear(x[:m], w, b, w_nk=nk)
                ref = trow.row_linear_ref(x[:m], w, b, w_nk=nk)
                total += 1
                if not same_bits(torch, got, ref):
                    bad.append((m, b is not None))
        differ += len(bad)
        tilings = sorted({trow.TILINGS[trow.tiling_of(m, kin, nout, nk)]
                          for m in R1_ORACLE_M})
        log(f"  R1 [M, {kin}] x {'wte^T ' if nk else ''}[{kin}, {nout}] "
            f"vs the oracle at M = {', '.join(map(str, R1_ORACLE_M))}, "
            f"with and without a bias ({'; '.join(tilings)}): "
            f"{'bit-identical' if not bad else f'DIFFER at {bad}'}")
        del w, x
    tri = torch.triu(torch.ones(32, 32, device="cuda"))
    for m in SCAN_M:
        e = torch.rand(m, 32, device="cuda", generator=g)
        ok = same_bits(torch, trow.row_linear(e, tri),
                       trow.row_linear_ref(e, tri))
        total += 1
        differ += not ok
        log(f"  R1 scan [{m}, 32] x [32, 32] "
            f"({trow.TILINGS[trow.tiling_of(m, 32, 32)]}) vs the oracle: "
            f"{'bit-identical' if ok else 'DIFFER'}")
    check(differ == 0, f"R1 differs from its oracle in {differ} of {total} "
          f"calls")
    for kin, nout, nk in cases:
        x = torch.randn(mmax, kin, device="cuda", generator=g)
        bias = None if nk else torch.randn(nout, device="cuda", generator=g)
        for bits in (8, 4):
            q, scale = quantized_weight(torch, g, (nout, kin) if nk
                                        else (kin, nout), bits)
            w = dequantize_tiles(q, scale)
            bad = [m for m in R1_ORACLE_M if not (
                same_bits(torch, trow.row_qlinear(x[:m], q, scale, bias, nk),
                          trow.row_linear(x[:m], w, bias, nk))
                and same_bits(torch, trow.row_qlinear(x[:m], q, scale, bias,
                                                      nk),
                              trow.row_qlinear_ref(x[:m], q, scale, bias,
                                                   nk)))]
            log(f"  B6 int{bits} {kin}->{nout}{' (lm head)' if nk else ''} "
                f"vs R1 on dequantize_tiles and vs its oracle at every M: "
                f"{'bit-identical' if not bad else f'DIFFER at M = {bad}'}")
            check(not bad, f"B6 int{bits} {kin}->{nout} differs from R1 on "
                  f"the dequantized weight or from its oracle")
            del q, scale, w
        del x
    torch.cuda.synchronize()


def check_bits_rows(torch, tf, g):
    """T1's bits rows bit for bit against the twin at 16 x 50,304 (a decode
    step's keys folded on the card) and 80 rows (a verify at gamma 4)."""
    for rows in (16, 80):
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                             generator=g, dtype=torch.int32)
        data = torch.randint(0, 1000, (rows,), device="cuda", generator=g,
                             dtype=torch.int32)
        for d in (data, None):
            got = tf.random_bits_rows(keys, d, 50304)
            ref = tf.plain_random_bits_rows(keys, d, 50304)
            ok = torch.equal(got, ref)
            log(f"  T1 bits rows [{rows}, 50304] "
                f"{'folded on the card' if d is not None else 'keys as given'}"
                f": {'bit-identical' if ok else 'DIFFER'}")
            check(ok, "T1 bits rows differ from the twin")
    return 0.0


# T1 bits rows' second kernel against its oracle: a decode step's 16 and a
# verify's 80 rows of 50,304, rows that start unaligned, the one-key path's
# row of 16 x 50,304, the most rows a launch takes
BITS_ROWS_SHAPES = ((1, 3), (16, 50304), (80, 65), (80, 50304),
                    (1, 16 * 50304), (65535, 4))


def check_bits_rows_oracle(torch, tf, g):
    """T1 bits rows (the second kernel) bit for bit its oracle (the first
    kernel) and its twin at ``BITS_ROWS_SHAPES``, with and without step
    indices, two runs bit-identical, each output buffer poisoned first."""
    for rows, n in BITS_ROWS_SHAPES:
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                             generator=g, dtype=torch.int32)
        data = torch.randint(0, 10 ** 6, (rows,), device="cuda", generator=g,
                             dtype=torch.int32)
        for d in (data, None):
            runs = []
            for _ in range(2):
                poison(torch, rows * n * 4)
                runs.append(tf.random_bits_rows(keys, d, n))
            ok = [torch.equal(runs[0], runs[1]),
                  torch.equal(runs[0], tf.random_bits_rows_ref(keys, d, n)),
                  torch.equal(runs[0], tf.plain_random_bits_rows(keys, d, n))]
            log(f"  T1 bits rows [{rows}, {n}] "
                f"{'folded on the card' if d is not None else 'keys as given'}"
                f": {'bit-identical to' if ok[1] else 'DIFFERS from'} the "
                f"oracle, {'bit-identical to' if ok[2] else 'DIFFERS from'} "
                f"the twin; two runs {'bit-identical' if ok[0] else 'DIFFER'}")
            check(all(ok), f"T1 bits rows [{rows}, {n}]: the second kernel "
                  f"is not its oracle and its twin bit for bit, twice")
        del keys, data, runs
    torch.cuda.empty_cache()


def serve_model_cfg(n_layer=12):
    from gym_tpu_torch.models.nanogpt import GPTConfig
    return GPTConfig(block_size=1024, vocab_size=50304, n_layer=n_layer,
                     n_head=12, n_embd=768)


def serve_params(n_layer=12, seed=0, device="cuda"):
    """GPT-2 base's weights at random, f32, from a seed (one model, no
    node dimension)."""
    from gym_tpu_torch.convert import serving_params
    from gym_tpu_torch.models.nanogpt import GPT
    stacked = GPT(serve_model_cfg(n_layer)).init_params(1, seed, device)
    return serving_params(stacked, node=0)


def check_decode_rows(torch, g):
    """Every op of the decode forward and the sampler, end to end on a
    2-layer GPT-2-base-width model (paged, page 16): a row decoded alone
    against the same row among 16, a prompt against its bucket-padded
    prefill, one position against a 5-token verify chunk: logits bit for
    bit; the sampler's tokens for a row alone and among 16 and 80."""
    import dataclasses
    from gym_tpu_torch.models.nanogpt import GPT, decode_config, sample_logits
    from gym_tpu_torch.ops import threefry as tf
    base = serve_model_cfg(2)
    v, nblk = base.vocab_size, base.block_size // SERVE_PAGE
    cfg = dataclasses.replace(decode_config(base), page_size=SERVE_PAGE,
                              kv_pages=1 + 16 * nblk)
    model = GPT(cfg)
    params = serve_params(2, seed=3)
    ok = True
    with torch.no_grad():
        cache = model.init_cache(16, "cuda")
        table = (1 + torch.arange(16 * nblk, device="cuda",
                                  dtype=torch.int32)).view(16, nblk)
        prompts = torch.randint(0, v, (16, 40), device="cuda",
                                generator=g, dtype=torch.int32)
        zero = torch.zeros(16, dtype=torch.int32, device="cuda")
        model.decode(params, prompts, cache, table, zero)
        # a prompt against its bucket: row 0's 37 tokens padded to 64
        pad = torch.zeros(1, 64, dtype=torch.int32, device="cuda")
        pad[0, :37] = prompts[0, :37]
        c2 = {k: v.clone() for k, v in cache.items()}
        a = model.decode(params, prompts[:1, :37], c2, table[:1], zero[:1],
                         logits_at=36)
        b = model.decode(params, pad, c2, table[:1], zero[:1], logits_at=36)
        ok_p = same_bits(torch, a, b)
        # a decode step: row 5 alone against the 16 rows
        tok = torch.randint(0, v, (16, 1), device="cuda", generator=g,
                            dtype=torch.int32)
        cur = torch.full((16,), 40, dtype=torch.int32, device="cuda")
        c3 = {k: v.clone() for k, v in cache.items()}
        all16 = model.decode(params, tok, c3, table, cur)
        c4 = {k: v.clone() for k, v in cache.items()}
        one = model.decode(params, tok[5:6], c4, table[5:6], cur[5:6])
        ok_d = same_bits(torch, one[0], all16[5])
        # a verify chunk of 5 against 5 single steps
        drafts = torch.randint(0, v, (16, 5), device="cuda", generator=g,
                               dtype=torch.int32)
        c5 = {k: v.clone() for k, v in cache.items()}
        chunk = model.decode(params, drafts, c5, table, cur)
        c6 = {k: v.clone() for k, v in cache.items()}
        ok_v = True
        for j in range(5):
            step = model.decode(params, drafts[:, j:j + 1], c6, table,
                                cur + j)
            ok_v &= same_bits(torch, step[:, 0], chunk[:, j])
        log(f"  decode forward (2 layers at GPT-2 base width): prompt vs "
            f"bucket {'bit-identical' if ok_p else 'DIFFER'}, a row alone "
            f"vs among 16 {'bit-identical' if ok_d else 'DIFFER'}, verify "
            f"chunk vs single steps {'bit-identical' if ok_v else 'DIFFER'}")
        ok = ok_p and ok_d and ok_v
        # the sampler: top-k and top-p rows, alone and among 16 and 80
        lg = torch.cat([all16[:, 0]] * 5)                       # [80, V]
        keys = tf.key_tensor([tf.PRNGKey(i) for i in range(80)], "cuda")
        gidx = torch.arange(80, dtype=torch.int32, device="cuda")
        temp = torch.full((80,), 0.9, device="cuda")
        top_k = torch.where(gidx % 2 == 0, 40, v).to(torch.int32)
        top_p = torch.where(gidx % 2 == 0, 1.0, 0.95).to(torch.float32)
        full = {m: sample_logits(lg[:m], keys[:m], temp[:m], top_k[:m],
                                 top_p[:m], gidx[:m]) for m in (16, 80)}
        ok_s = True
        for r in (0, 1, 5, 15):
            s1 = sample_logits(lg[r:r + 1], keys[r:r + 1], temp[r:r + 1],
                               top_k[r:r + 1], top_p[r:r + 1],
                               gidx[r:r + 1])
            ok_s &= all(int(s1[0]) == int(full[m][r]) for m in full)
        log(f"  sampler (temperature, top-k 40 / top-p 0.95, gumbel argmax):"
            f" a row alone vs among 16 and 80: "
            f"{'same tokens' if ok_s else 'DIFFER'}")
    check(ok and ok_s, "the decode forward or the sampler is not "
          "row-invariant")


def check_serving_kernels(torch, tdec, trow, tf):
    g = torch.Generator(device="cuda").manual_seed(10)
    log("phase 3 serving: B7, R1, L1, T1 bits rows (f32, GPT-2 base shapes)")
    from gym_tpu_torch.ops import fused_attention as tfa
    errs = {"B7_decode_attention": check_b7(torch, tdec, g)}
    check_b7_oracle(torch, tdec, tfa, g)
    errs["R1_row_gemm"], errs["L1_row_add_layer_norm"] = check_r1_l1(
        torch, trow, g)
    check_r1_oracle(torch, trow, g)
    errs["T1_threefry_bits_rows"] = check_bits_rows(torch, tf, g)
    check_bits_rows_oracle(torch, tf, g)
    check_decode_rows(torch, g)
    torch.cuda.empty_cache()
    return errs


def time_b7(torch, tdec, q, k_pool, v_pool, scales, tb, cur, plain=True):
    """B7 (or B7 int8, with ``scales``) and its oracle in turns (new,
    oracle, oracle, new; the better of each pair), its twin, the yardstick
    (SDPA on the gathered window with its mask; for int8 kv_dequantize
    first) and the bound: each input byte read once (q, the distinct
    positions' K and V and, int8, their scales), the output written once,
    or the FMAs of the (query, key) pairs at 67 TFLOP/s."""
    import torch.nn.functional as F
    from gym_tpu_torch.ops.fused_attention import kv_dequantize
    b, t, h, hd = q.shape
    s = tb.shape[1] * k_pool.shape[1]
    keys = sum(min(int(c) + j, s - 1) + 1 for c in cur.tolist()
               for j in range(t))                   # (query, key) pairs
    distinct = sum(min(int(c) + t - 1, s - 1) + 1 for c in cur.tolist())
    per_pos = h * (hd + 4) if scales else 4 * h * hd
    nbytes = 4 * 2 * q.numel() + 2 * distinct * per_pos + 8 * b
    flops = 4 * keys * h * hd
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    pages = tb.long()

    def window(pool, sc):
        w = pool[pages] if not scales else kv_dequantize(pool[pages],
                                                         sc[pages])
        return w.view(b, s, h, hd).transpose(1, 2)

    def sdpa():
        kw = window(k_pool, scales[0] if scales else None)
        vw = window(v_pool, scales[1] if scales else None)
        pos = cur[:, None] + torch.arange(t, device="cuda")
        mask = torch.arange(s, device="cuda") <= pos[:, :, None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kw, vw, attn_mask=mask[:, None])

    if scales:
        def new():
            return tdec.decode_attention_int8(q, k_pool, v_pool, *scales, tb,
                                              cur)

        def ref():
            return tdec.decode_attention_int8_ref(q, k_pool, v_pool, *scales,
                                                  tb, cur)

        def twin():
            return tdec.plain_decode_attention_int8(q, k_pool, v_pool,
                                                    *scales, tb, cur)
    else:
        def new():
            return tdec.decode_attention(q, k_pool, v_pool, tb, cur)

        def ref():
            return tdec.decode_attention_ref(q, k_pool, v_pool, tb, cur)

        def twin():
            return tdec.plain_decode_attention(q, k_pool, v_pool, tb, cur)
    new_a, ref_a = timed(torch, new), timed(torch, ref)
    ref_b, new_b = timed(torch, ref), timed(torch, new)
    return dict(ms=min(new_a, new_b), ref_ms=min(ref_a, ref_b),
                new=(new_a, new_b), ref=(ref_a, ref_b),
                plain_ms=(timed(torch, twin, reps=3, inner=1) if plain
                          else None),
                library_ms=timed(torch, sdpa),
                bound=(max(t_b, t_f) * 1e3,
                       "bytes" if t_b >= t_f else "operations"),
                mb=nbytes / 1e6, gflop=flops / 1e9,
                path=tdec.PATHS[tdec.path_of(t)])


def time_serving_kernels(torch, tdec, trow, tf, int32_ops_per_s):
    """Phase 7 for the serving kernels at phase 10's shapes, each beside
    its twin, its bound (bytes at 3.35 TB/s, or f32 FMAs at 67 TFLOP/s) and
    its yardstick: SDPA on the gathered window with its mask for B7,
    torch.matmul for R1 and B6 (beside their chain floor), a torch add and
    F.layer_norm for L1 with the add; B7, R1, B6 and L1 in turns with
    their oracles."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(11)
    h, hd, s = SERVE_H, SERVE_HD, SERVE_S
    _, _, k_pool, v_pool, table = paged_window(torch, g, 16)
    out = {}

    def b7_case(tag, q, tb, cur, plain=True):
        r = time_b7(torch, tdec, q, k_pool, v_pool, (), tb, cur, plain)
        log(f"B7_decode_attention [{tag}] ({r['path']}): kernel_ms "
            f"{r['ms']:.4f} ({r['new'][0]:.4f}, {r['new'][1]:.4f}) oracle_ms "
            f"{r['ref_ms']:.4f} ({r['ref'][0]:.4f}, {r['ref'][1]:.4f}) "
            + (f"plain_ms {r['plain_ms']:.4f} (twin) " if plain else "")
            + f"library_ms {r['library_ms']:.4f} (SDPA on the gathered "
            f"window, masked) bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}: "
            f"{r['mb']:.2f} MB, {r['gflop']:.3f} GFLOP) -> "
            f"{r['bound'][0] / r['ms']:.2%} of bound, "
            f"{r['ref_ms'] / r['ms']:.2f}x the oracle")
        return r

    cur = torch.randint(16, 577, (16,), device="cuda", generator=g,
                        dtype=torch.int32)
    out["B7_decode_attention"] = b7_case(
        "decode b=16 t=1, cursors 16-576, page 16",
        torch.randn(16, 1, h, hd, device="cuda", generator=g), table, cur)
    b7_case("verify b=16 t=5, cursors 16-576, page 16",
            torch.randn(16, 5, h, hd, device="cuda", generator=g), table, cur,
            plain=False)
    b7_case("prefill b=1 t=512 start 0",
            torch.randn(1, 512, h, hd, device="cuda", generator=g),
            table[:1], torch.zeros(1, dtype=torch.int32, device="cuda"))
    del k_pool, v_pool

    chain_cycles_per_ms = max_sm_mhz() * 1e3 / FMA_CHAIN_CYCLES
    slower = []

    def r1_case(m, kin, nout, lm=False, bits=0, w=None, plain=False):
        """R1 (or B6 at ``bits``) and its oracle in turns (new, oracle,
        oracle, new; the better of each pair), beside the bound, the chain
        floor (K FMAs of FMA_CHAIN_CYCLES at the highest SM clock) and the
        yardstick (torch.matmul; for B6 dequantize_tiles first)."""
        from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
        shape = (nout, kin) if lm else (kin, nout)
        if bits:
            q, sc = quantized_weight(torch, g, shape, bits)
            wbytes = q.numel() + 4 * sc.numel()
        else:
            if w is None:
                w = torch.randn(*shape, device="cuda", generator=g) * 0.02
            wbytes = 4 * w.numel()
        bias = (None if lm or kin == nout == SCAN_BLOCK
                else torch.randn(nout, device="cuda", generator=g))
        x = torch.randn(m, kin, device="cuda", generator=g)
        nbytes = wbytes + 4 * (m * kin + m * nout
                               + (0 if bias is None else nout))
        flops = 2 * m * kin * nout
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        if bits:
            def new():
                return trow.row_qlinear(x, q, sc, bias, lm)

            def ref():
                return trow.row_qlinear_ref(x, q, sc, bias, lm)

            def lib():
                wd = dequantize_tiles(q, sc)
                y = x @ (wd.t() if lm else wd)
                return y if bias is None else y + bias
        else:
            def new():
                return trow.row_linear(x, w, bias, lm)

            def ref():
                return trow.row_linear_ref(x, w, bias, lm)

            def lib():
                y = x @ (w.t() if lm else w)
                return y if bias is None else y + bias
        new_a, ref_a = timed(torch, new), timed(torch, ref)
        ref_b, new_b = timed(torch, ref), timed(torch, new)
        r = dict(ms=min(new_a, new_b), ref_ms=min(ref_a, ref_b),
                 library_ms=timed(torch, lib),
                 chain_ms=kin / chain_cycles_per_ms,
                 bound=(max(t_b, t_f) * 1e3,
                        "bytes" if t_b >= t_f else "operations"))
        r["plain_ms"] = (timed(torch, lambda: (
            trow.plain_row_qlinear(x, q, sc, bias, lm) if bits else
            trow.plain_row_linear(x, w, bias, lm)), reps=3, inner=1)
            if plain else None)
        name = f"B6_row_qgemm int{bits}" if bits else "R1_row_gemm"
        tiling = trow.TILINGS[trow.tiling_of(m, kin, nout, lm)]
        log(f"{name} [{m}, {kin}] x [{kin}, {nout}]"
            f"{' (lm head)' if lm else ''} ({tiling}): kernel_ms "
            f"{r['ms']:.4f} ({new_a:.4f}, {new_b:.4f}) oracle_ms "
            f"{r['ref_ms']:.4f} ({ref_a:.4f}, {ref_b:.4f}) library_ms "
            f"{r['library_ms']:.4f} ({'dequantize_tiles + ' if bits else ''}"
            f"torch.matmul) bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}) "
            f"chain_floor_ms {r['chain_ms']:.6f}"
            + (f" plain_ms {r['plain_ms']:.4f}" if plain else "")
            + f" -> {r['bound'][0] / r['ms']:.2%} of bound, "
            f"{max(r['bound'][0], r['chain_ms']) / r['ms']:.2%} of "
            f"max(bound, chain floor)")
        if r["ms"] > r["ref_ms"]:
            slower.append(f"{name} [{m}, {kin}] x [{kin}, {nout}]")
        return r

    out["R1_row_gemm"] = r1_case(16, 768, 3072, plain=True)
    for kin, nout in ((768, 2304), (768, 768), (3072, 768)):
        r1_case(16, kin, nout)
    r1_case(16, *LM_HEAD, lm=True)
    for m in (64, 128, 256, 512, 80, 1024):
        r1_case(m, 768, 3072)
    r1_case(80, *LM_HEAD, lm=True)
    tri = torch.triu(torch.ones(SCAN_BLOCK, SCAN_BLOCK, device="cuda"))
    for m in SCAN_M:
        r1_case(m, SCAN_BLOCK, SCAN_BLOCK, w=tri)
    for kin, nout in DENSE_SHAPES:
        r1_case(16, kin, nout, bits=8)
    r1_case(16, *LM_HEAD, lm=True, bits=8)
    for m in (64, 128, 256, 512, 1024):
        r1_case(m, 768, 3072, bits=8)
    check(not slower, f"R1/B6 slower than the oracle at {slower}")
    x = torch.randn(16, 768, device="cuda", generator=g)
    d = torch.randn(16, 768, device="cuda", generator=g)
    sc = torch.randn(768, device="cuda", generator=g)
    bi = torch.randn(768, device="cuda", generator=g)
    # x and d read once, s and y written once, scale and bias read
    nbytes = 4 * (4 * x.numel() + 2 * 768)

    def new():
        return trow.row_add_layer_norm(x, d, sc, bi)

    def ref():
        return trow.row_layer_norm(x + d, sc, bi)

    new_a, ref_a = timed(torch, new), timed(torch, ref)
    ref_b, new_b = timed(torch, ref), timed(torch, new)
    out["L1_row_add_layer_norm"] = r = dict(
        ms=min(new_a, new_b), ref_ms=min(ref_a, ref_b),
        plain_ms=timed(torch, lambda: trow.plain_row_layer_norm(x + d, sc,
                                                                 bi)),
        library_ms=timed(torch, lambda: F.layer_norm(x + d, (768,), sc, bi)),
        bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    r["ln_ms"] = timed(torch, lambda: trow.row_layer_norm(x, sc, bi))
    log(f"L1_row_add_layer_norm [16, 768]: kernel_ms {r['ms']:.4f} "
        f"({new_a:.4f}, {new_b:.4f}) oracle_ms {r['ref_ms']:.4f} ({ref_a:.4f},"
        f" {ref_b:.4f}; a torch add, then the oracle L1, alone "
        f"{r['ln_ms']:.4f}) plain_ms {r['plain_ms']:.4f} (a torch add, then "
        f"the twin) library_ms {r['library_ms']:.4f} (a torch add, then "
        f"F.layer_norm) bound_ms {r['bound'][0]:.6f} (bytes)")
    out["T1_threefry_bits_rows"] = time_bits_rows(torch, tf, g,
                                                  int32_ops_per_s)
    torch.cuda.empty_cache()
    return out


# T1 bits rows' timed shapes: the serving sampler's, a decode step's 16
# and a verify's 80 rows of the vocabulary, each row's key folded with its
# slot's step index (sample_logits), held to the oracle; and the one-key
# path's row of 16 x 50,304, as generate's categorical draws it (no step
# index) and with one, timed for the record: there the kernel ties the
# oracle (PERF.md §6), so a strict comparison would flip with noise
BITS_ROWS_TIMED = ((16, 50304, True), (80, 50304, True))
BITS_ROWS_RECORD = ((1, 16 * 50304, False), (1, 16 * 50304, True))


def time_bits_rows(torch, tf, g, int32_ops_per_s):
    """T1 bits rows in turns with its oracle (new, oracle, oracle, new; the
    better of each pair) at ``BITS_ROWS_TIMED`` and ``BITS_ROWS_RECORD``,
    each beside its bound (4 bytes written an element, or threefry2x32's 73
    int32 operations at the dispatch limit), the twin at 16 rows. Fails if
    the kernel is slower than its oracle at a shape of ``BITS_ROWS_TIMED``.
    Returns the 16-row record."""
    slower, first = [], None
    for (rows, n, fold), held in ([(s, True) for s in BITS_ROWS_TIMED]
                                  + [(s, False) for s in BITS_ROWS_RECORD]):
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                             generator=g, dtype=torch.int32)
        data = (torch.arange(rows, dtype=torch.int32, device="cuda") if fold
                else None)

        def new():
            return tf.random_bits_rows(keys, data, n)

        def ref():
            return tf.random_bits_rows_ref(keys, data, n)

        t_b = 4 * rows * n / HBM_BYTES_PER_S
        t_o = rows * n * (THREEFRY_LEAST_OPS - 2) / int32_ops_per_s
        new_a, ref_a = timed(torch, new), timed(torch, ref)
        ref_b, new_b = timed(torch, ref), timed(torch, new)
        r = dict(ms=min(new_a, new_b), ref_ms=min(ref_a, ref_b),
                 plain_ms=None, library_ms=None,
                 bound=(max(t_b, t_o) * 1e3,
                        "bytes" if t_b >= t_o else "operations"))
        if first is None:
            r["plain_ms"] = timed(torch, lambda: tf.plain_random_bits_rows(
                keys, data, n), reps=3, inner=1)
            first = r
        log(f"T1_threefry_bits_rows [{rows}, {n}] "
            f"{'folded with step indices' if fold else 'one key, no fold'}"
            f"{'' if held else ' (for the record, not held)'}: kernel_ms "
            f"{r['ms']:.4f} ({new_a:.4f}, {new_b:.4f}) oracle_ms "
            f"{r['ref_ms']:.4f} ({ref_a:.4f}, {ref_b:.4f}) "
            + (f"plain_ms {r['plain_ms']:.4f} (twin) " if r["plain_ms"]
               else "")
            + f"library_ms none bound_ms {r['bound'][0]:.6f} "
            f"({r['bound'][1]}) -> {r['bound'][0] / r['ms']:.1%} of bound, "
            f"{r['ref_ms'] / r['ms']:.2f}x the oracle")
        if held and r["ms"] > r["ref_ms"]:
            slower.append((rows, n))
    check(not slower, f"T1 bits rows slower than its oracle at {slower}")
    return first


# phase 10's workload: 32 requests, 8 sharing a 256-token system prompt
SERVE_REQUESTS, SERVE_SHARED, SERVE_SYSTEM = 32, 8, 256


def serve_workload(seed=0):
    """(prompt, SamplingParams kwargs) of phase 10's requests: prompts of
    16-512 tokens (8 of them a shared 256-token system prompt and a
    question), 32-64 new tokens, temperature 0.9 with top-k 40, or top-p
    0.95; each request its own seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 50304, SERVE_SYSTEM).astype(np.int32)
    out = []
    for i in range(SERVE_REQUESTS):
        if i % (SERVE_REQUESTS // SERVE_SHARED) == 0:
            q = rng.integers(0, 50304, int(rng.integers(16, 257)))
            prompt = np.concatenate([system, q.astype(np.int32)])
        else:
            prompt = rng.integers(0, 50304, int(rng.integers(16, 513))
                                  ).astype(np.int32)
        kw = (dict(temperature=0.9, top_k=40) if i % 2 == 0
              else dict(top_p=0.95))
        out.append((prompt, dict(max_new_tokens=int(rng.integers(32, 65)),
                                 seed=1000 + i, **kw)))
    return out


# (b)'s greedy requests: a random model's greedy stream falls into a loop
# that the n-gram drafter predicts, so drafts are accepted and rolled back
SERVE_GREEDY, SPEC_ACCEPTED_FLOOR = 8, 200


def serve_greedy(seed=1):
    """(prompt, SamplingParams kwargs) of (b)'s greedy requests: prompts of
    16-128 tokens, 64 new tokens, top-k 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 50304, int(rng.integers(16, 129))
                          ).astype(np.int32),
             dict(max_new_tokens=64, top_k=1, seed=2000 + i))
            for i in range(SERVE_GREEDY)]


def serve_loop(torch, eng, work, label):
    """``work`` through ``Scheduler`` over ``eng``, all submitted at once:
    the token streams, the scheduler, the wall time and the handles."""
    from gym_tpu_torch.serve import RequestStatus, SamplingParams, Scheduler
    sched = Scheduler(eng, max_queue=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [sched.submit(p, SamplingParams(**kw)) for p, kw in work]
    for _ in range(100_000):
        if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
               for h in handles):
            break
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    failed = [h for h in handles if h.status is not RequestStatus.DONE]
    check(not failed, f"{label}: {len(failed)} requests failed: "
          f"{[h.exception for h in failed[:3]]}")
    return [h.result(timeout=1) for h in handles], sched, wall, handles


def serve_run(torch, params, cfg, work, label, **engine_kw):
    """Phase 10's workload through ``Scheduler`` over a fresh engine (its
    programs CUDA graphs, captured at first use, unless ``cuda_graphs=
    False``): the token streams, the engine, the wall time and the
    handles."""
    from gym_tpu_torch.serve import InferenceEngine
    eng = InferenceEngine(params, cfg, device="cuda", **engine_kw)
    got, sched, wall, handles = serve_loop(torch, eng, work,
                                           f"phase 10 {label}")
    return got, eng, sched, wall, handles


def greedy_on(torch, params, cfg, dev, steps):
    """A 32-token prompt and ``steps`` greedy tokens through the decode
    forward on ``dev``: each step's logits (on the CPU), the tokens and the
    cache."""
    import numpy as np
    from gym_tpu_torch.models.nanogpt import GPT, decode_config
    model = GPT(decode_config(cfg))
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 32)).astype(np.int32)
    p = {n: t.to(dev) for n, t in params.items()}
    cache = model.init_cache(1, dev)
    lgs, toks = [], []
    with torch.no_grad():
        lg = model.decode(p, torch.from_numpy(prompt).to(dev), cache,
                          logits_at=31)[:, 0]
        for j in range(steps):
            lgs.append(lg.float().cpu())
            tok = torch.argmax(lg, dim=-1)
            toks.append(int(tok[0]))
            if j + 1 < steps:
                lg = model.decode(p, tok[:, None].to(torch.int32),
                                  cache)[:, 0]
    return lgs, toks, cache


def logits_gap(out):
    """The largest |card − CPU| over the steps, in units of each step's
    largest CPU logit."""
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(out["cuda"][0], out["cpu"][0]))


def card_vs_cpu_serving(torch, params, cfg, steps=8, label="phase 10"):
    """A 32-token prompt and 8 greedy tokens through the decode forward on
    the card and on the CPU from the same weights: logits at every step
    within phase 6's f32 band (rtol 1e-4 of the largest logit), the
    greedy tokens identical."""
    out = {dev: greedy_on(torch, params, cfg, dev, steps)
           for dev in ("cuda", "cpu")}
    worst = logits_gap(out)
    log(f"{label} card vs CPU (32-token prompt, {steps} greedy tokens, "
        f"GPT-2 base): max |a-b| / max|b| over the steps' logits "
        f"{worst:.3e} (band {LOSS_RTOL['f32']}); tokens card "
        f"{out['cuda'][1]} cpu {out['cpu'][1]}")
    check(worst <= LOSS_RTOL["f32"], f"{label}: card and CPU logits differ "
          f"by {worst:.3e}")
    check(out["cuda"][1] == out["cpu"][1], f"{label}: card and CPU greedy "
          "tokens differ")


def serving_phase(torch, mods, card):
    """Phase 10: GPT-2 base (random f32 weights from a seed) served by the
    paged engine (page 16, 16 slots, decode_chunk 8) through Scheduler:
    (a) phase 10's workload, the kernels' launches counted; (b) the same
    and 8 greedy requests with spec_tokens=4, the greedy ones held to a
    run without speculation and the accepted drafts to a floor; (c)
    unpaged; each stream equal to (a)'s; (d) one
    request against generate_fast; (e) 16 batch-class requests of (a) and
    an interactive one that parks one of them: the parked stream resumes
    equal to (a)'s; then the card against the CPU."""
    from gym_tpu_torch.models.nanogpt import generate_fast
    from gym_tpu_torch.serve import (InferenceEngine, RequestStatus,
                                     SamplingParams, Scheduler)
    cfg = serve_model_cfg()
    params = serve_params()
    work = serve_workload()
    paged = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
    log(f"phase 10 serving GPT-2 base (12L/12H/768, vocab 50304, block "
        f"1024, f32, random weights): {len(work)} requests, prompts "
        f"{min(len(p) for p, _ in work)}-{max(len(p) for p, _ in work)} "
        f"tokens ({SERVE_SHARED} share a {SERVE_SYSTEM}-token system "
        f"prompt), {sum(kw['max_new_tokens'] for _, kw in work)} new tokens;"
        f" engine paged, page 16, 16 slots, decode_chunk 8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    ref, eng, _, wall, handles = serve_run(torch, params, cfg, work, "(a)",
                                           **paged)
    counts = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    ntok = sum(len(t) for t in ref)
    ttft = sorted(h.ttft_s for h in handles)
    p50 = ttft[len(ttft) // 2]
    p99 = ttft[min(len(ttft) - 1, int(math.ceil(0.99 * len(ttft))) - 1)]
    st = eng.stats
    log(f"  (a) {ntok} tokens in {wall:.3f} s: {ntok / wall:.1f} output "
        f"tokens/s, TTFT p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms "
        f"(all {len(work)} submitted at once), peak memory "
        f"{peak / 2**30:.3f} GiB; prefills {st.prefills}, prefill_tokens "
        f"{st.prefill_tokens}, prefix_hit_blocks {st.prefix_hit_blocks}, "
        f"decode_steps {st.decode_steps} on {card}")
    log(f"  (a) launches: { {k: counts[k] for k in SERVING_KERNELS} }")
    for k in SERVING_KERNELS:
        check(counts[k] > 0, f"phase 10: {k} never launched")
    check(st.prefix_hit_blocks >= (SERVE_SHARED - 1) * (SERVE_SYSTEM // 16),
          f"phase 10: prefix_hit_blocks {st.prefix_hit_blocks}")
    del eng
    greedy = serve_greedy()
    gref, eng, _, _, _ = serve_run(torch, params, cfg, greedy,
                                   "(b) greedy", **paged)
    del eng
    got, eng, _, wall_b, _ = serve_run(torch, params, cfg, work + greedy,
                                       "(b)", spec_tokens=4, **paged)
    st = eng.stats
    log(f"  (b) spec_tokens=4, (a)'s requests and {len(greedy)} greedy "
        f"ones: {sum(len(t) for t in got) / wall_b:.1f} tokens/s, spec "
        f"accept rate {st.spec_accept_rate():.4f} ({st.spec_accepted}/"
        f"{st.spec_drafted}); streams "
        f"{'equal to (a)' if got[:len(work)] == ref else 'DIFFER from (a)'}"
        f", greedy streams {'equal' if got[len(work):] == gref else 'DIFFER'}"
        f" without speculation")
    check(got == ref + gref, "phase 10: speculative streams differ from "
          "the non-speculative ones")
    check(st.spec_accepted >= SPEC_ACCEPTED_FLOOR, f"phase 10: only "
          f"{st.spec_accepted} drafts accepted (floor "
          f"{SPEC_ACCEPTED_FLOOR}): speculation's rollback went untested")
    del eng
    got, eng, _, wall_c, _ = serve_run(torch, params, cfg, work, "(c)",
                                       num_slots=16, decode_chunk=8)
    log(f"  (c) unpaged: {sum(len(t) for t in got) / wall_c:.1f} tokens/s; "
        f"streams {'equal to (a)' if got == ref else 'DIFFER from (a)'}")
    check(got == ref, "phase 10: unpaged streams differ from (a)")
    del eng
    p, kw = work[3]
    one, _, _, _, _ = serve_run(torch, params, cfg, [(p, kw)], "(d)",
                                **paged)
    gen_kw = {k: v for k, v in kw.items() if k != "max_new_tokens"}
    gf = generate_fast(params, cfg, p[None], kw["max_new_tokens"],
                       **gen_kw)[0, len(p):].tolist()
    log(f"  (d) one request ({len(p)}-token prompt) vs generate_fast: "
        f"{'equal' if one[0] == gf else 'DIFFER'}")
    check(one[0] == gf and one[0] == ref[3], "phase 10: the engine differs "
          "from generate_fast")
    # (e): 16 batch-class requests fill the slots; an interactive one
    # arrives after the first chunk and parks the least urgent
    eng = InferenceEngine(params, cfg, device="cuda", **paged)
    sched = Scheduler(eng, max_queue=64, preempt=True)
    hs = [sched.submit(p, SamplingParams(**kw), slo_class="batch")
          for p, kw in work[:16]]
    sched.step()
    hi = sched.submit(work[16][0], SamplingParams(**work[16][1]),
                      slo_class="interactive")
    for _ in range(100_000):
        if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
               for h in hs + [hi]):
            break
        sched.step()
    got = [h.result(timeout=1) for h in hs + [hi]]
    log(f"  (e) park/resume: preemptions {eng.stats.preemptions}, resumes "
        f"{eng.stats.resumes}; streams "
        f"{'equal to (a)' if got == ref[:17] else 'DIFFER from (a)'}")
    check(eng.stats.preemptions >= 1 and eng.stats.resumes >= 1,
          "phase 10: nothing was parked and resumed")
    check(got == ref[:17], "phase 10: parked streams differ from (a)")
    del eng, sched
    torch.cuda.empty_cache()
    card_vs_cpu_serving(torch, params, cfg)
    return {k: counts[k] for k in SERVING_KERNELS}


# -- phase 11: checkpoints, resume, preemption, the guard, a run dir served --


CKPT_ROOT = os.path.join(HERE, "build", "chip_smoke_ckpt")
# 11b and 11c: 11a's recipe at 4L/4H/256d (vocab 50304, T=1024)
CKPT_SMALL = dict(GPT2_BASE, n_layer=4, n_head=4, n_embd=256)
CKPT_STEPS, CKPT_EVERY = 6, 3
# 11a's one restore, timed, for phase 15b's restore-plus-reshard beside it
PHASE_11A = {}


def ckpt_fit(torch, cfg_kw, steps, tag, nodes=2, strategy=None, **kw):
    """Phase 11's fit: K=2 × 4 rows, bf16, DiLoCo (H=2, AdamW 3e-4,
    lambda_cosine warmup 2) on random tokens from seed 0, checkpoints every
    3 steps into ``CKPT_ROOT/ckpt/<tag>`` through the async writer, the
    prefetcher on, no evals; ``nodes`` and ``strategy`` (phase 15b's) and
    ``kw`` pass on (max_steps via ``steps``)."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    import numpy as np
    cfg = GPTConfig(**cfg_kw)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 200_000).astype(np.int32)
    root = kw.pop("root", CKPT_ROOT)
    fit_kw = dict(checkpoint_interval=CKPT_EVERY,
                  save_dir=os.path.join(root, "ckpt"), run_name=tag,
                  log_dir=os.path.join(root, "logs"), device="cuda")
    fit_kw.update(kw)
    return Trainer(GPT(cfg), ContiguousGPTTrainDataset(
        toks, cfg.block_size)).fit(
        strategy=strategy if strategy is not None else diloco(),
        num_nodes=nodes, max_steps=steps, batch_size=4, autocast=True,
        seed=0, val_size=0, show_progress=False, **fit_kw)


def ckpt_csv(tag) -> bytes:
    with open(os.path.join(CKPT_ROOT, "logs", tag, "train.csv"), "rb") as f:
        return f.read()


def ckpt_dir(tag) -> str:
    return os.path.join(CKPT_ROOT, "ckpt", tag)


def ckpt_worker(spec: dict) -> int:
    """``chip_smoke.py --ckpt-worker SPEC``: one ``ckpt_fit`` in a process
    of its own (armed through ``GYM_TPU_FAULTS``; under
    ``Guard(**spec["guard"])`` if given; phase 15b's ZeRO-1 at
    ``spec["nodes"]`` nodes, synchronous saves, if ``spec["zero"]``), its
    steps, ``preempted``, losses, ``nvcc`` builds and the guard's rollbacks
    and trips written to ``spec["result"]``."""
    import torch
    sys.path.insert(0, HERE)
    from gym_tpu_torch.ops import _build
    from gym_tpu_torch.utils.integrity import Guard, GuardRuntime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    rt = (GuardRuntime(Guard(**spec["guard"])) if spec.get("guard")
          else None)
    kw = {}
    if spec.get("zero"):
        kw = dict(nodes=spec["nodes"], strategy=elastic_zero(),
                  async_checkpoint=False, root=spec["root"])
    res = ckpt_fit(torch, spec["cfg"], spec["steps"], spec["tag"], guard=rt,
                   **kw)
    with open(spec["result"], "w") as f:
        json.dump({"steps": res.steps, "preempted": res.preempted,
                   "rollbacks": rt.rollbacks if rt else 0,
                   "trips": rt.trips if rt else [],
                   "losses": res.history["train_loss"],
                   "nvcc_builds": _build.stats["nvcc_builds"]}, f)
    return 0


def start_ckpt_worker(tag, faults, guard=None):
    """A worker process running 11b's fit under the ``GYM_TPU_FAULTS``
    spec ``faults`` (and ``Guard(**guard)``); ``finish_ckpt_worker``
    collects it."""
    spec = {"cfg": CKPT_SMALL, "steps": CKPT_STEPS, "tag": tag,
            "result": os.path.join(CKPT_ROOT, f"{tag}.json"),
            "guard": guard}
    env = dict(os.environ, GYM_TPU_FAULTS=faults, GYM_TPU_IO_RETRIES="2",
               GYM_TPU_IO_RETRY_BASE_S="0.01")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--ckpt-worker", json.dumps(spec)], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), spec


def finish_ckpt_worker(started, timeout=300):
    """(returncode, result or None, stderr tail) of a started worker."""
    proc, spec = started
    _, err = proc.communicate(timeout=timeout)
    out = None
    if os.path.exists(spec["result"]):
        with open(spec["result"]) as f:
            out = json.load(f)
    return proc.returncode, out, err[-3000:]


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, n))
               for r, _, names in os.walk(path) for n in names)


def tree_bytes(tree) -> int:
    import torch
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def same_params(torch, a, b) -> bool:
    return list(a) == list(b) and all(torch.equal(a[n], b[n]) for n in a)


def checkpoint_full_width(torch, mods, card, base_sps):
    """11a: GPT-2 base, 6 steps straight without checkpoints, then 3 with
    and a resume to 6: the train.csv byte-identical and the node params
    bit-equal; the bytes of a step dir, one synchronous save and one
    restore timed, the steady steps/s with checkpoints beside the straight
    run's and phase 5's, the peak memory with and without them."""
    import shutil
    from gym_tpu_torch.trainer import _state_tree
    from gym_tpu_torch.utils.checkpoint import CheckpointManager
    title = "phase 11a gpt2-base checkpoints"
    log(f"{title}: K=2 x 4 rows, bf16, DiLoCo H=2, {CKPT_STEPS} steps; "
        f"run 1 straight without checkpoints, run 2 with "
        f"checkpoint_interval={CKPT_EVERY}, the async writer and the "
        f"prefetcher, to step {CKPT_EVERY} and then resumed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    run1 = ckpt_fit(torch, GPT2_BASE, CKPT_STEPS, "a",
                    checkpoint_interval=None)
    peak1 = torch.cuda.max_memory_allocated()
    losses = [l for _, l in run1.history["train_loss"]]
    check(len(losses) == CKPT_STEPS and all(math.isfinite(l)
                                            for l in losses),
          f"{title}: losses {losses}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt_fit(torch, GPT2_BASE, CKPT_EVERY, "b")
    run2 = ckpt_fit(torch, GPT2_BASE, CKPT_STEPS, "b")
    wall2 = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated()
    counts = read_counts(mods)
    for name in ("B3_blk_fwd", "B4_blk_bwd"):
        check(counts[name] > 0, f"{title}: {name} never launched")
    first = [s for s, _ in run2.history["train_loss"]]
    check(first == list(range(CKPT_EVERY, CKPT_STEPS)),
          f"{title}: the resumed run logged steps {first}")
    same_csv = ckpt_csv("b") == ckpt_csv("a")
    same = same_params(torch, run1.node_state.params,
                       run2.node_state.params)
    log(f"  run 1 (0->6) and run 2 (0->3, then resume 3->6): train.csv "
        f"{'byte-identical' if same_csv else 'DIFFERS'}, node params "
        f"{'bit-equal' if same else 'DIFFER'}; losses {losses}")
    check(same_csv, f"{title}: the resumed train.csv differs:\n"
          f"{ckpt_csv('a').decode()}\n{ckpt_csv('b').decode()}")
    check(same, f"{title}: the resumed node params differ")
    st = run2.node_state
    sstate = st.strategy_state
    parts = {"params": tree_bytes(st.params),
             "AdamW moments": tree_bytes(sstate["opt"]),
             "DiLoCo outer state": tree_bytes(sstate["modules"])}
    step_dir = os.path.join(ckpt_dir("b"), str(CKPT_STEPS))
    disk = dir_bytes(step_dir)
    log(f"  step dir {os.path.relpath(step_dir, HERE)}: {disk:,} bytes on "
        f"disk (" + ", ".join(f"{k} {v:,}" for k, v in parts.items())
        + f"; predicted {sum(parts.values()):,})")
    check(sum(parts.values()) <= disk < sum(parts.values()) + (1 << 24),
          f"{title}: step dir of {disk} bytes, tensors {parts}")
    mgr = CheckpointManager(os.path.join(CKPT_ROOT, "sync"), "s",
                            async_save=False)
    tree = _state_tree(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(CKPT_STEPS, tree, {"epoch": 0}, {})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, got, _, _ = mgr.restore(tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    PHASE_11A["restore_s"] = restore_s
    mgr.close()
    check(same_params(torch, got["params"], st.params),
          f"{title}: a restored state differs from the saved one")
    del got, run1
    shutil.rmtree(os.path.join(CKPT_ROOT, "sync"), ignore_errors=True)
    log(f"  one synchronous save {save_s:.2f} s ({disk / save_s / 1e9:.2f} "
        f"GB/s: the copy to pinned memory, torch.save, fsync, crc32c), one "
        f"restore {restore_s:.2f} s (crc32c verify, torch.load, to the "
        f"card); steady steps/s of the resumed run with its save at step "
        f"{CKPT_STEPS}: {run2.steps_per_second_steady} (phase 5 without "
        f"checkpoints: {base_sps}); run 2's fits {wall2:.1f} s, the "
        f"writer's closes included; peak memory {peak2 / 2**30:.2f} GiB "
        f"with checkpoints, {peak1 / 2**30:.2f} GiB without; MFU "
        f"{run2.mfu:.4%} at 989 TFLOP/s on {card}")
    log(f"  launches (runs 1 and 2): "
        f"{ {k: counts[k] for k in ('B3_blk_fwd', 'B4_blk_bwd')} }")
    return run2


def checkpoint_faults(torch, card, workers):
    """11b and 11c at 4L/4H/256d, each drill in a worker process of its
    own (started by the caller, all together): SIGTERM, SIGKILL in a
    checkpoint write, a corrupt step, a corrupted live state under the
    guard; each ends byte-identical to an uninterrupted run in this
    process, the first three through a relaunch here."""
    small = (f"{CKPT_SMALL['n_layer']}L/{CKPT_SMALL['n_head']}H/"
             f"{CKPT_SMALL['n_embd']}d")
    ckpt_fit(torch, CKPT_SMALL, CKPT_STEPS, "base")
    oracle = ckpt_csv("base")

    rc, out, err = finish_ckpt_worker(workers["term"])
    check(rc == 0 and out is not None and out["preempted"]
          and 0 < out["steps"] < CKPT_STEPS,
          f"phase 11b: the SIGTERM drill gave rc {rc}, {out}\n{err}")
    check(os.path.isdir(os.path.join(ckpt_dir("term"), str(out["steps"]))),
          "phase 11b: no emergency checkpoint")
    res = ckpt_fit(torch, CKPT_SMALL, CKPT_STEPS, "term")
    check(res.history["train_loss"][0][0] == out["steps"]
          and ckpt_csv("term") == oracle,
          "phase 11b: the relaunch after SIGTERM is not byte-identical")
    log(f"phase 11b {small}: SIGTERM at the 4th dispatch boundary: exit 0, "
        f"preempted at step {out['steps']} with an emergency checkpoint; "
        f"the relaunch resumed there, train.csv byte-identical")
    rc, out, err = finish_ckpt_worker(workers["kill"])
    check(rc == -9 and out is None,
          f"phase 11b: checkpoint.write:kill@2 gave rc {rc}\n{err}")
    res = ckpt_fit(torch, CKPT_SMALL, CKPT_STEPS, "kill")
    first = res.history["train_loss"][0][0]
    check(first > 0 and first % CKPT_EVERY == 0
          and ckpt_csv("kill") == oracle,
          f"phase 11b: the relaunch after SIGKILL (resumed at {first}) is "
          f"not byte-identical")
    log(f"  SIGKILL in the second checkpoint write: the relaunch resumed at "
        f"step {first}, train.csv byte-identical")

    rc, out, err = finish_ckpt_worker(workers["bytes"])
    check(rc == 0 and out is not None and out["steps"] == CKPT_STEPS,
          f"phase 11c: the checkpoint.bytes run gave rc {rc}, {out}\n{err}")
    res = ckpt_fit(torch, CKPT_SMALL, CKPT_STEPS, "bytes")
    names = sorted(os.listdir(ckpt_dir("bytes")))
    first = res.history["train_loss"][0][0]
    check(f"{CKPT_STEPS}.corrupt-0" in names and first == CKPT_EVERY
          and ckpt_csv("bytes") == oracle,
          f"phase 11c: corrupt step: {names}, resumed at {first}")
    log(f"phase 11c {small}: 8 bits flipped in step {CKPT_STEPS}'s state.pt "
        f"after its sidecar: quarantined as {CKPT_STEPS}.corrupt-0, resumed "
        f"at step {first}, train.csv byte-identical; run dir {names}")
    rc, out, err = finish_ckpt_worker(workers["guard"])
    check(rc == 0 and out is not None and out["rollbacks"] == 1
          and out["steps"] == CKPT_STEPS and ckpt_csv("guard") == oracle,
          f"phase 11c: guard: rc {rc}, {out}\n{err}")
    log(f"  4 exponent bits flipped in the live state at the 4th dispatch: "
        f"the guard tripped ({out['trips'][0][1]}), rolled back once, and "
        f"the replay's train.csv is byte-identical on {card}")


def serve_run_dir(torch, mods, card, run2, cli):
    """11d: 11a's run dir through load_for_serving, served by phase 10's
    paged engine over 8 seeded requests: the streams equal, token for
    token, those of ``serving_params`` of 11a's in-process result (the
    resumed run's); and
    ``cli`` (started by the caller: the nanoGPT CLI sampling from the run
    dir) must have restored it."""
    from gym_tpu_torch.convert import serving_params
    from gym_tpu_torch.serve.load import load_for_serving
    run_dir = ckpt_dir("b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, cfg, info = load_for_serving(run_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = serving_params(run2.node_state.params)
    check(info["step"] == CKPT_STEPS and same_params(torch, params, live),
          f"phase 11d: the run dir's params differ from the fit's "
          f"(step {info['step']})")
    work = serve_workload()[:8]
    paged = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
    reset_counts(mods)
    got, eng, _, wall, _ = serve_run(torch, params, cfg, work, "(11d)",
                                     **paged)
    counts = read_counts(mods)
    del eng
    want, eng, _, _, _ = serve_run(torch, live, cfg, work, "(11d live)",
                                   **paged)
    del eng
    ntok = sum(len(t) for t in got)
    log(f"phase 11d: load_for_serving of step {info['step']} "
        f"({info['num_nodes']}-node average) in {load_s:.2f} s; {len(work)} "
        f"requests, {ntok} tokens in {wall:.3f} s ({ntok / wall:.1f} output "
        f"tokens/s) through the paged engine; streams "
        f"{'equal to' if got == want else 'DIFFER from'} the in-process "
        f"weights' on {card}")
    log(f"  launches: { {k: counts[k] for k in SERVING_KERNELS} }")
    check(got == want, "phase 11d: the run dir serves other tokens than the "
          "in-process weights")
    for k in SERVING_KERNELS:
        check(counts[k] > 0, f"phase 11d: {k} never launched")
    proc, t0 = cli
    stdout, stderr = proc.communicate(timeout=300)
    check(proc.returncode == 0 and f"restored step {CKPT_STEPS}" in stdout,
          f"phase 11d: the --ckpt CLI failed ({proc.returncode}):\n"
          f"{stdout[-2000:]}{stderr[-2000:]}")
    log(f"  python -m gym_tpu_torch.examples.nanogpt --ckpt "
        f"{os.path.relpath(run_dir, HERE)} "
        f"--sample 32, beside 11b-11d: "
        + " | ".join(stdout.strip().splitlines()[:1])
        + f" ({time.perf_counter() - t0:.1f} s after its start)")
    return {k: counts[k] for k in SERVING_KERNELS}


def checkpoint_phase(torch, mods, card, base_sps, t_all):
    """Phase 11 (11a-11d), then phases 12, 13 and 14 on 11a's run dir; the
    run dirs are removed after them. Returns phase 13's kernel errors,
    times and launches."""
    import shutil
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    procs = []
    try:
        run2 = checkpoint_full_width(torch, mods, card, base_sps)
        # 11b-11c's four workers and 11d's CLI start together and run
        # beside the in-process fits
        cli_t0 = time.perf_counter()
        cli = subprocess.Popen(
            [sys.executable, "-m", "gym_tpu_torch.examples.nanogpt",
             "--ckpt", ckpt_dir("b"), "--sample", "32"], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(cli)
        workers = {
            "term": start_ckpt_worker("term", "dispatch.boundary:sigterm@4"),
            "kill": start_ckpt_worker("kill", "checkpoint.write:kill@2"),
            "bytes": start_ckpt_worker("bytes",
                                       "checkpoint.bytes:bitflip=8@2"),
            "guard": start_ckpt_worker(
                "guard", "dispatch.state:bitflip=4@4",
                guard=dict(fingerprint_interval=1, max_rollbacks=2))}
        procs += [w[0] for w in workers.values()]
        checkpoint_faults(torch, card, workers)
        serve_run_dir(torch, mods, card, run2, (cli, cli_t0))
        del run2
        log(f"phase 11: {time.perf_counter() - t0:.1f} s")
        log(f"phase 12: CUDA graphs against eager, the HTTP server and a "
            f"hot swap ({time.perf_counter() - t_all:.1f} s since the "
            f"start)")
        ref12b = graphs_phase(torch, mods, card)
        log(f"phase 13: quantized serving ({time.perf_counter() - t_all:.1f}"
            f" s since the start)")
        out13 = quant_phase(torch, mods, card)
        log(f"phase 14: the process fleet and the deploy drill "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        fleet_phase(torch, card, ref12b)
        return out13
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)


# -- phase 12: CUDA graphs and the HTTP server --------------------------------


SERVE_ENGINE = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
# the paged family at decode_chunk 8 and block 1024: the decode chunk,
# copy-on-write, the chunk-1 twin and the prefill buckets 1, 2, ..., 1024
SERVE_FAMILY = 3 + 11
# peak memory after three hot swaps against after one
RELOAD_PEAK_RATIO = 1.05


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))]


def step_launches(torch, params, cfg, graphs, work):
    """Host calls that queue work on the card (kernel and graph launches,
    copies) and device kernels and copies, per decode step: one decode
    chunk of 16 active slots under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from gym_tpu_torch.serve import InferenceEngine, SamplingParams
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_serve import LAUNCH_CALLS
    eng = InferenceEngine(params, cfg, device="cuda", cuda_graphs=graphs,
                          **SERVE_ENGINE)
    for p, kw in work[:SERVE_ENGINE["num_slots"]]:
        eng.admit(p, SamplingParams(**kw))
    eng.step()                        # builds the decode chunk's program
    check(eng._active.all(), "phase 12a: a slot finished in chunk 1")
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    dev = sum(e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA)
    eng.close()
    chunk = SERVE_ENGINE["decode_chunk"]
    return host / chunk, dev / chunk


def graphs_vs_eager(torch, mods, card):
    """12a: phase 10's workload through the paged engine, eager and CUDA
    graphs in turn (eager, graphs, three times), each engine's family
    built first (the warmup: graphs captured, eager programs run once).
    Every stream equal; output tokens/s, TTFT p50/p99 and peak memory of
    each run, the warmup's seconds and captures; launches per decode
    step; the device busy share through ``scripts/profile_serve.py``."""
    from gym_tpu_torch.programs import (graphs_captured_counter,
                                        warm_engine_programs)
    from gym_tpu_torch.serve import InferenceEngine
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_serve import profile_workload
    cfg, params, work = serve_model_cfg(), serve_params(), serve_workload()
    runs = {False: [], True: []}
    streams, launches = {}, {}
    t_start = time.perf_counter()
    for graphs in (False, True) * 3:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine(params, cfg, device="cuda",
                              cuda_graphs=graphs, **SERVE_ENGINE)
        g0 = graphs_captured_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = warm_engine_programs(eng, start=False)
        warm.run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        captured = graphs_captured_counter() - g0
        check(warm.stats()["warmed"] == SERVE_FAMILY,
              f"phase 12a: warmup built {warm.stats()}")
        check(captured == (SERVE_FAMILY if graphs else 0),
              f"phase 12a: {captured} graphs captured (graphs={graphs})")
        label = "graphs" if graphs else "eager"
        reset_counts(mods)
        got, _, wall, handles = serve_loop(torch, eng, work,
                                           f"phase 12a {label}")
        counts = read_counts(mods)
        launches[graphs] = {k: counts[k] for k in SERVING_KERNELS}
        for k in SERVING_KERNELS:
            check(counts[k] > 0, f"phase 12a: {k} never launched ({label})")
        ttft = [h.ttft_s for h in handles]
        ntok = sum(len(t) for t in got)
        runs[graphs].append(dict(
            tps=ntok / wall, p50=pctl(ttft, 0.5), p99=pctl(ttft, 0.99),
            peak=torch.cuda.max_memory_allocated(), warm_s=warm_s,
            captured=captured, steps=eng.stats.decode_steps))
        streams.setdefault(graphs, got)
        check(got == streams[graphs], f"phase 12a: {label} streams differ "
              f"from run to run")
        eng.close()
        del eng
    check(streams[True] == streams[False], "phase 12a: the CUDA graphs' "
          "streams differ from the eager engine's")
    t_runs = time.perf_counter()
    per_step = {g: step_launches(torch, params, cfg, g, work)
                for g in (False, True)}
    t_steps = time.perf_counter()
    prof, tables = {}, {}
    for g in (False, True):
        text, prof[g] = profile_workload(torch, sys.modules[__name__],
                                         SERVE_ENGINE, graphs=g,
                                         warm_pass=False)
        tables[g] = text.splitlines()[1:8]     # the top six by device time
    t_prof = time.perf_counter()
    log(f"phase 12a graphs against eager, phase 10's workload ({len(work)} "
        f"requests, {sum(len(t) for t in streams[True])} tokens, paged, "
        f"page 16, 16 slots, decode_chunk 8; three runs each, in turns; "
        f"streams equal token for token) on {card}:")
    for g in (False, True):
        r = runs[g]
        label = "graphs" if g else "eager "
        log(f"  {label}: output tokens/s "
            + ", ".join(f"{x['tps']:.1f}" for x in r)
            + "; TTFT p50 " + ", ".join(f"{x['p50'] * 1e3:.1f}" for x in r)
            + " ms, p99 " + ", ".join(f"{x['p99'] * 1e3:.1f}" for x in r)
            + " ms; peak memory " + ", ".join(f"{x['peak'] / 2**30:.3f}"
                                             for x in r)
            + " GiB; warmup " + ", ".join(f"{x['warm_s']:.2f}" for x in r)
            + f" s, {r[0]['captured']} graphs captured; "
            f"{r[0]['steps']} decode steps; the last run's launches "
            f"{launches[g]}")
        host, dev = per_step[g]
        p = prof[g]
        log(f"    per decode step (16 slots active, one chunk profiled): "
            f"{host:.1f} host launch calls, {dev:.1f} device kernels and "
            f"copies; profiled run (scripts/profile_serve.py): device busy "
            f"{p['busy']:.1%}, {p['tokens_per_s']:.1f} tokens/s under the "
            f"profiler, host time in launches and copies "
            f"{p['launch_ms']:.1f} ms, {p['launch_calls']} launch calls; "
            f"its kernels by device time:")
        for line in tables[g]:
            log("    " + line)
    med = {g: sorted(x["tps"] for x in runs[g])[1] for g in (False, True)}
    log(f"  median output tokens/s: graphs {med[True]:.1f}, eager "
        f"{med[False]:.1f} ({med[True] / med[False]:.2f}x); 12a's six runs "
        f"{t_runs - t_start:.1f} s, the launch counts "
        f"{t_steps - t_runs:.1f} s, "
        f"the two profiles {t_prof - t_steps:.1f} s")
    return {"tps": med, "busy": {g: prof[g]["busy"] for g in prof}}


def http_json(port, path, payload=None, timeout=300):
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def generate_body(prompt, kw):
    return {"prompt": [int(t) for t in prompt], **kw}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(run_dir, port, log_path, extra=(), phase="12b"):
    """``python -m gym_tpu_torch.serve`` on 11a's run dir, with no
    ``--device`` flag (the card by default); ``extra`` more flags."""
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gym_tpu_torch.serve", "--ckpt", run_dir,
         "--num_slots", "16", "--decode_chunk", "8", "--port", str(port),
         *extra],
        cwd=HERE, stdout=out, stderr=subprocess.STDOUT, text=True)
    out.close()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 300:
        with open(log_path) as f:
            text = f.read()
        if "listening" in text:
            return proc, time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    proc.communicate()
    with open(log_path) as f:
        raise SmokeFailure(f"phase {phase}: the server did not start:\n"
                           f"{f.read()[-3000:]}")


def wait_warmup(port, timeout=300):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        code, stats = http_json(port, "/stats")
        if code == 200 and stats["warmup"] and stats["warmup"]["done"]:
            return stats
        time.sleep(0.2)
    raise SmokeFailure(f"phase 12b: warmup never finished: {stats}")


def stop_server(proc, log_path, what, phase="12b"):
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    with open(log_path) as f:
        text = f.read()
    check(rc == 0 and "shut down cleanly" in text and "tokens_per_s" in
          text, f"phase {phase}: {what}: SIGTERM drill failed (rc {rc}):\n"
          f"{text[-3000:]}")
    return next(ln for ln in text.splitlines() if "shut down cleanly" in ln)


def server_subprocess(torch, card):
    """12b: ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir on the
    card (its family captured by the warmup), 11d's 8 requests sent
    together over HTTP, each stream equal to the eager in-process engine's
    on ``load_for_serving`` of the same run dir; ``/stats`` with prefix
    hits; the SIGTERM drill; a restart against the same kernel build
    directory: the first request equal, ``programs_compiled`` 0 and the
    family captured again."""
    import concurrent.futures
    from gym_tpu_torch.serve.load import load_for_serving
    run_dir = ckpt_dir("b")
    work = serve_workload()[:8]
    params, cfg, info = load_for_serving(run_dir)
    want, eng, _, _, _ = serve_run(torch, params, cfg, work,
                                   "(12b eager reference)",
                                   cuda_graphs=False, **SERVE_ENGINE)
    eng.close()
    del eng, params
    torch.cuda.empty_cache()
    port = free_port()
    logs = [os.path.join(CKPT_ROOT, f"server{i}.log") for i in (1, 2)]
    t0 = time.perf_counter()
    proc, up_s = start_server(run_dir, port, logs[0])
    try:
        stats = wait_warmup(port)
        warm = stats["warmup"]
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(work)) as ex:
            outs = list(ex.map(lambda w: http_json(
                port, "/generate", generate_body(*w)), work))
        wall = time.perf_counter() - t1
        check(all(c == 200 for c, _ in outs),
              f"phase 12b: {[(c, b) for c, b in outs if c != 200][:2]}")
        got = [b["tokens"] for _, b in outs]
        _, stats = http_json(port, "/stats")
    finally:
        line = stop_server(proc, logs[0], "first server")
    ntok = sum(len(t) for t in got)
    log(f"phase 12b python -m gym_tpu_torch.serve --ckpt "
        f"{os.path.relpath(run_dir, HERE)} --num_slots 16 --decode_chunk 8 "
        f"(step {info['step']}, no --device: on {card}): listening after "
        f"{up_s:.1f} s, warmup {warm['warmed']}/{warm['total']} programs "
        f"in {warm['seconds']:.2f} s; {len(work)} requests together over "
        f"HTTP, {ntok} tokens in {wall:.3f} s ({ntok / wall:.1f} output "
        f"tokens/s); streams {'equal to' if got == want else 'DIFFER from'}"
        f" the eager in-process engine's; /stats requests_done "
        f"{stats['requests_done']}, prefix_hit_blocks "
        f"{stats['prefix_hit_blocks']}, programs_compiled "
        f"{stats['programs_compiled']}, graphs_captured "
        f"{stats['graphs_captured']}")
    check(got == want, "phase 12b: the server's streams differ from the "
          "eager engine's")
    check(stats["requests_done"] == len(work) and
          stats["prefix_hit_blocks"] > 0 and stats["paged"],
          f"phase 12b: /stats {stats}")
    check(warm["warmed"] == warm["total"] == SERVE_FAMILY and
          stats["graphs_captured"] == SERVE_FAMILY,
          f"phase 12b: warmup {warm}, graphs {stats['graphs_captured']}")
    csv_path = os.path.join(run_dir, "serve", "serve.csv")
    with open(csv_path) as f:
        header = f.readline()
    check(header.startswith("ts_s,kind"), f"phase 12b: serve.csv header "
          f"{header!r}")
    log(f"  SIGTERM: rc 0, {line.split('—')[-1].strip()}; "
        f"{os.path.relpath(csv_path, HERE)} starts {header[:10]!r}")
    proc, up_s = start_server(run_dir, port, logs[1])
    try:
        code, body = http_json(port, "/generate", generate_body(*work[0]))
        first = time.perf_counter() - t0
        stats = wait_warmup(port)
    finally:
        stop_server(proc, logs[1], "restarted server")
    log(f"  restart against build/gym_tpu_torch/: listening after "
        f"{up_s:.1f} s, first request {code} "
        f"({'equal' if body.get('tokens') == want[0] else 'DIFFERS'}), "
        f"programs_compiled {stats['programs_compiled']}, graphs_captured "
        f"{stats['graphs_captured']} (the family: {SERVE_FAMILY}); 12b "
        f"took {first:.1f} s to the restart's first reply")
    check(code == 200 and body["tokens"] == want[0],
          f"phase 12b: the restart's first request {code} {body}")
    check(stats["programs_compiled"] == 0 and
          stats["graphs_captured"] == SERVE_FAMILY,
          f"phase 12b: restart /stats {stats}")
    return want, ntok / wall


def hot_swap(torch, mods, card):
    """12c: ``create_server`` with two in-process replicas on the card
    over 11a's run dir (step 6); ``POST /reload`` to step 3, 6 and 3: each
    new engine captures its family before it serves, its predecessor
    closed; afterwards 11d's requests equal a fresh eager engine's on step
    3's weights, and the peak memory after three reloads is within 5% of
    the peak after one."""
    import gc
    import threading
    from gym_tpu_torch.serve.__main__ import create_server
    from gym_tpu_torch.serve.load import load_for_serving
    run_dir = ckpt_dir("b")
    work = serve_workload()[:8]

    def reload_source(body):
        p, _, i = load_for_serving(run_dir, step=body.get("step"))
        return p, f"step-{i['step']}"

    params, cfg, info = load_for_serving(run_dir)
    handle = create_server(params, cfg, port=0, replicas=2,
                           metrics_dir=os.path.join(CKPT_ROOT, "serve12c"),
                           info=info, reload_source=reload_source,
                           **{k: v for k, v in SERVE_ENGINE.items()
                              if k not in ("paged", "page_size")})
    del params
    t = threading.Thread(target=handle.httpd.serve_forever, daemon=True)
    t.start()
    try:
        check(handle.warmup.wait(timeout=300), "phase 12c: warmup hung")
        code, _ = http_json(handle.port, "/generate",
                            generate_body(*work[1]))
        check(code == 200, f"phase 12c: {code} before the reloads")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        peaks, walls = [], []
        for step in (3, CKPT_STEPS, 3):
            code, body = http_json(handle.port, "/reload", {"step": step})
            check(code == 200 and sorted(body["swapped"]) == [0, 1],
                  f"phase 12c: reload to {step}: {code} {body}")
            walls.append(body["wall_s"])
            gc.collect()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
        reset_counts(mods)
        outs = [http_json(handle.port, "/generate", generate_body(*w))
                for w in work]
        counts = read_counts(mods)
        _, stats = http_json(handle.port, "/stats")
    finally:
        handle.close()
        t.join(timeout=30)
    del handle
    gc.collect()
    got = [b.get("tokens") for _, b in outs]
    params3, _, _ = load_for_serving(run_dir, step=3)
    want, eng, _, _, _ = serve_run(torch, params3, cfg, work,
                                   "(12c fresh engine)", cuda_graphs=False,
                                   **SERVE_ENGINE)
    eng.close()
    del eng, params3
    log(f"phase 12c hot swap, 2 in-process replicas x 16 slots on {card}: "
        f"POST /reload to steps 3, {CKPT_STEPS}, 3 in "
        + ", ".join(f"{w:.2f}" for w in walls) + " s (each replica drained, "
        f"its new engine's {SERVE_FAMILY} graphs captured, the old engine "
        f"closed); peak memory after each reload "
        + ", ".join(f"{p / 2**30:.3f}" for p in peaks)
        + f" GiB ({peaks[-1] / peaks[0]:.4f}x after three, limit "
        f"{RELOAD_PEAK_RATIO}); {len(work)} requests after: streams "
        f"{'equal to' if got == want else 'DIFFER from'} a fresh engine's "
        f"on step 3; /stats weight_reloads {stats['weight_reloads']}, "
        f"step {stats['step']}, graphs_captured {stats['graphs_captured']};"
        f" launches { {k: counts[k] for k in SERVING_KERNELS} }")
    check(got == want, "phase 12c: streams after the hot swap differ from "
          "a fresh engine's on the new weights")
    check(peaks[-1] <= RELOAD_PEAK_RATIO * peaks[0],
          f"phase 12c: peak memory grew {peaks}")
    check(stats["weight_reloads"] == 3 and stats["step"] == 3,
          f"phase 12c: /stats {stats}")
    for k in SERVING_KERNELS:
        check(counts[k] > 0, f"phase 12c: {k} never launched")


def graphs_phase(torch, mods, card):
    """Phase 12 (12a-12c), inside phase 11 before its run dirs go; 12a's
    and 12c's launches counted from zero (12b's server is a process of its
    own). Returns 12b's streams and output tokens/s (phase 14a's
    reference)."""
    t0 = time.perf_counter()
    graphs_vs_eager(torch, mods, card)
    t1 = time.perf_counter()
    ref12b = server_subprocess(torch, card)
    t2 = time.perf_counter()
    hot_swap(torch, mods, card)
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t0:.1f} s (12a {t1 - t0:.1f} s, "
        f"12b {t2 - t1:.1f} s, 12c {time.perf_counter() - t2:.1f} s)")
    return ref12b


# -- phase 13: quantized serving ---------------------------------------------


QUANT_KERNELS = ("B6_row_qgemm", "B7_decode_attention_int8")
# 13c: the least legal f32 pool at page 16 (the null page, one window, a
# copy-on-write page) and the int8 pool of the same payload bytes. At a
# 1024-token window the f32 pool keeps 64 resident prompt blocks and the
# int8 pool 259 (its 260 usable pages less the last request's decode
# block), so the distinct one-block prompts must outnumber 259 to fill it
# (80, bench.py's count for its short window, fill 80 of its pages)
CAP_F32_PAGES = 2 + 1024 // 16
CAP_INT8_PAGES = 1 + (CAP_F32_PAGES - 1) * 4
CAP_PROMPTS = 300


def quant_cfg(weights_dtype="int8", kv_dtype="int8", quant_embed=False,
              n_layer=12):
    import dataclasses
    return dataclasses.replace(serve_model_cfg(n_layer),
                               weights_dtype=weights_dtype,
                               kv_dtype=kv_dtype, quant_embed=quant_embed)


def quantized_weight(torch, g, shape, bits, tile=256):
    """A GPT-2-base-width weight of random normal(0.02) values quantized by
    the codec (``serve/load.py``'s path: tile clamped to the rows)."""
    from gym_tpu_torch.ops.grouped_matmul import quant_tile_for
    from gym_tpu_torch.strategy.compress import QuantizeCodec
    w = torch.randn(*shape, device="cuda", generator=g) * 0.02
    codec = QuantizeCodec(bits=bits, tile=quant_tile_for(shape, tile),
                          stochastic=False)
    q, scale = codec.compress(w.reshape(1, -1), None)
    return q.reshape(shape).contiguous(), scale.reshape(-1).contiguous()


def check_b6(torch, trow, g):
    """B6 bit for bit R1 on the dequantized weights and beside its plain
    version, at the decode layer, the lm head and a prefill, int8 and
    int4, every row bit for bit at M = 1, 16, 80 and 1024."""
    from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
    worst = 0.0
    for kin, nout, lm in ((768, 3072, False), (3072, 768, False),
                          (768, 2304, False), (*LM_HEAD, True)):
        x = torch.randn(1024, kin, device="cuda", generator=g)
        for bits in (8, 4):
            q, scale = quantized_weight(torch, g, (nout, kin) if lm
                                        else (kin, nout), bits)
            w = dequantize_tiles(q, scale)
            bias = None if lm else torch.randn(nout, device="cuda",
                                               generator=g)
            same = True
            for m in (1, 16, 80, 1024):
                got = trow.row_qlinear(x[:m], q, scale, bias, w_nk=lm)
                same &= same_bits(torch, got, trow.row_linear(
                    x[:m], w, bias, w_nk=lm))
                if m in (16, 1024):
                    worst = max(worst, compare(
                        f"B6 int{bits} [{m}, {kin}] x [{kin}, {nout}]"
                        f"{' (lm head)' if lm else ''}", got,
                        trow.plain_row_qlinear(x[:m], q, scale, bias, lm),
                        "out", torch.float32))
            log(f"  B6 int{bits} {kin}->{nout}{' (lm head)' if lm else ''}"
                f" vs R1 on dequantize_tiles at M = 1, 16, 80, 1024: "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(same, f"B6 int{bits} {kin}->{nout} differs from R1 on "
                  f"the dequantized weight")
            ok = rows_invariant(torch, lambda z: trow.row_qlinear(
                z, q, scale, bias, w_nk=lm), x, f"B6 int{bits} "
                f"{kin}->{nout}")
            check(ok, f"B6 {kin}->{nout}: a row's bits depend on M")
            del q, scale, w
        del x
    torch.cuda.synchronize()
    return worst


def check_b7_int8(torch, tdec, tfa, g):
    """B7 int8 bit for bit B7 on the kv_dequantize'd pools, paged and
    unpaged, at decode, a verify chunk and prefills, beside its plain
    version; a NaN scale reaching only its row; kv_quantize on the card
    bit for bit the CPU's."""
    h, hd, s = SERVE_H, SERVE_HD, SERVE_S
    k_rows, v_rows, k_pool, v_pool, table = paged_window(torch, g, 16)
    (kq, ks), (vq, vs) = tfa.kv_quantize(k_pool), tfa.kv_quantize(v_pool)
    cq, cs = tfa.kv_quantize(k_pool.cpu())
    same = torch.equal(kq.cpu(), cq) and same_bits(torch, ks.cpu(), cs)
    log(f"  kv_quantize of a [{k_pool.shape[0]}, 16, 12, 64] pool, card vs "
        f"CPU: {'bit-identical' if same else 'DIFFER'}")
    check(same, "kv_quantize differs between the card and the CPU")
    kd, vd = tfa.kv_dequantize(kq, ks), tfa.kv_dequantize(vq, vs)
    del k_rows, v_rows, k_pool, v_pool
    cursors = torch.randint(0, s, (16,), device="cuda", generator=g,
                            dtype=torch.int32)
    cursors[0], cursors[1] = 0, s - 1
    unp = tdec.unpaged_table(16, "cuda")
    rows = table.long()
    kqr, vqr = kq[rows].flatten(1, 2), vq[rows].flatten(1, 2)
    ksr, vsr = ks[rows].flatten(1, 2), vs[rows].flatten(1, 2)
    q1 = torch.randn(16, 1, h, hd, device="cuda", generator=g)
    q5 = torch.randn(16, 5, h, hd, device="cuda", generator=g)
    vcur = torch.clamp(cursors, max=s - 3)
    qp = torch.randn(1, 512, h, hd, device="cuda", generator=g)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    worst = 0.0
    for name, q, tb, cur in (("decode b=16 t=1", q1, table, cursors),
                             ("verify b=16 t=5", q5, table, vcur),
                             ("prefill b=1 t=512", qp, table[:1], zero)):
        got = tdec.decode_attention_int8(q, kq, vq, ks, vs, tb, cur)
        same = same_bits(torch, got, tdec.decode_attention(q, kd, vd, tb,
                                                           cur))
        oracle = same_bits(torch, got, tdec.decode_attention_int8_ref(
            q, kq, vq, ks, vs, tb, cur))
        worst = max(worst, compare(
            f"B7 int8 {name}", got, tdec.plain_decode_attention_int8(
                q, kq, vq, ks, vs, tb, cur), "out", torch.float32))
        if tb.shape[0] == 16:
            same &= same_bits(torch, got, tdec.decode_attention_int8(
                q, kqr, vqr, ksr, vsr, unp, cur))
        log(f"  B7 int8 {name} vs B7 on the dequantized pools (and paged vs "
            f"unpaged): {'bit-identical' if same else 'DIFFER'}; vs its "
            f"oracle: {'bit-identical' if oracle else 'DIFFER'}")
        check(same, f"B7 int8 {name} differs from B7 on the dequantized "
              f"pools")
        check(oracle, f"B7 int8 {name} differs from its oracle")
    ks = ks.clone()
    ks[table[3, 0].long(), 0, 5] = float("nan")
    bad = tdec.decode_attention_int8(q1, kq, vq, ks, vs, table, cursors)
    good = tdec.decode_attention_int8(q1, kq, vq, ks.nan_to_num(1.0), vs,
                                      table, cursors)
    keep = torch.ones_like(bad, dtype=torch.bool)
    keep[3, :, 5] = False
    ok = bool(torch.isnan(bad[3, :, 5]).all()) and torch.equal(bad[keep],
                                                              good[keep])
    log(f"  B7 int8: a NaN scale at row 3's position 0, head 5 reaches "
        f"that row and head only: {ok}")
    check(ok, "B7 int8: a NaN scale did not reach its row, or reached "
          "another")
    torch.cuda.synchronize()
    return worst


def time_b6(torch, trow, g, m, kin, nout, bits, lm=False):
    from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
    q, scale = quantized_weight(torch, g, (nout, kin) if lm else (kin, nout),
                                bits)
    bias = None if lm else torch.randn(nout, device="cuda", generator=g)
    x = torch.randn(m, kin, device="cuda", generator=g)
    nbytes = (q.numel() + 4 * (scale.numel() + m * kin + m * nout
                               + (0 if lm else nout)))
    flops = 2 * m * kin * nout
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS

    def lib():
        w = dequantize_tiles(q, scale)
        y = x @ (w.t() if lm else w)
        return y if bias is None else y + bias

    r = dict(ms=timed(torch, lambda: trow.row_qlinear(x, q, scale, bias,
                                                      lm)),
             plain_ms=timed(torch, lambda: trow.plain_row_qlinear(
                 x, q, scale, bias, lm), reps=3, inner=1),
             library_ms=timed(torch, lib),
             bound=(max(t_b, t_f) * 1e3,
                    "bytes" if t_b >= t_f else "operations"))
    log(f"B6_row_qgemm int{bits} [{m}, {kin}] x [{kin}, {nout}]"
        f"{' (lm head, [V, C] read transposed)' if lm else ''}: kernel_ms "
        f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} (twin) library_ms "
        f"{r['library_ms']:.4f} (dequantize_tiles then torch.matmul) "
        f"bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}: {nbytes / 1e6:.2f} "
        f"MB, {flops / 1e9:.3f} GFLOP) -> {r['bound'][0] / r['ms']:.2%} of "
        f"bound")
    return r


def time_b7_int8(torch, tdec, tfa, g, tag, b, t, cur_lo, cur_hi,
                 plain=True):
    _, _, k_pool, v_pool, table = paged_window(torch, g, b)
    (kq, ks), (vq, vs) = tfa.kv_quantize(k_pool), tfa.kv_quantize(v_pool)
    del k_pool, v_pool
    tb = table[:b]
    cur = (torch.randint(cur_lo, cur_hi + 1, (b,), device="cuda",
                         generator=g, dtype=torch.int32) if cur_hi
           else torch.zeros(b, dtype=torch.int32, device="cuda"))
    q = torch.randn(b, t, SERVE_H, SERVE_HD, device="cuda", generator=g)
    r = time_b7(torch, tdec, q, kq, vq, (ks, vs), tb, cur, plain)
    log(f"B7_decode_attention_int8 [{tag}] ({r['path']}): kernel_ms "
        f"{r['ms']:.4f} ({r['new'][0]:.4f}, {r['new'][1]:.4f}) oracle_ms "
        f"{r['ref_ms']:.4f} ({r['ref'][0]:.4f}, {r['ref'][1]:.4f}) "
        + (f"plain_ms {r['plain_ms']:.4f} (twin) " if plain else "")
        + f"library_ms {r['library_ms']:.4f} (kv_dequantize then SDPA on the"
        f" gathered window, masked) bound_ms {r['bound'][0]:.6f} "
        f"({r['bound'][1]}: {r['mb']:.2f} MB, {r['gflop']:.3f} GFLOP) -> "
        f"{r['bound'][0] / r['ms']:.2%} of bound, "
        f"{r['ref_ms'] / r['ms']:.2f}x the oracle")
    return r


def quant_kernels(torch, mods, card):
    """13a: B6 and B7 int8 checked bit for bit against R1 and B7 on the
    dequantized operands, then timed at the main path's shapes."""
    tdec, trow = mods["decode_attention"], mods["row_linear"]
    from gym_tpu_torch.ops import fused_attention as tfa
    g = torch.Generator(device="cuda").manual_seed(13)
    log(f"phase 13a: B6 and B7 int8 at GPT-2 base's shapes on {card}")
    errs = {"B6_row_qgemm": check_b6(torch, trow, g),
            "B7_decode_attention_int8": check_b7_int8(torch, tdec, tfa, g)}
    torch.cuda.empty_cache()
    times = {"B6_row_qgemm": time_b6(torch, trow, g, 16, 768, 3072, 8)}
    time_b6(torch, trow, g, 16, 768, 3072, 4)
    time_b6(torch, trow, g, 16, 3072, 768, 8)
    time_b6(torch, trow, g, 16, *LM_HEAD, 8, lm=True)
    time_b6(torch, trow, g, 1024, 768, 3072, 8)
    times["B7_decode_attention_int8"] = time_b7_int8(
        torch, tdec, tfa, g, "decode b=16 t=1, cursors 16-576, page 16", 16,
        1, 16, 576)
    time_b7_int8(torch, tdec, tfa, g, "verify b=16 t=5, cursors 16-576, "
                 "page 16", 16, 5, 16, 576, plain=False)
    time_b7_int8(torch, tdec, tfa, g, "prefill b=1 t=512 start 0", 1, 512,
                 0, 0)
    torch.cuda.empty_cache()
    return errs, times


def quant_run(torch, mods, params, cfg, work, graphs=True):
    """One warmed engine over ``work``: the streams, tokens/s, TTFT, peak
    memory, graphs captured and the kernels' launches in the run."""
    from gym_tpu_torch.programs import (graphs_captured_counter,
                                        warm_engine_programs)
    from gym_tpu_torch.serve import InferenceEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(params, cfg, device="cuda", cuda_graphs=graphs,
                          **SERVE_ENGINE)
    g0 = graphs_captured_counter()
    warm = warm_engine_programs(eng, start=False)
    warm.run()
    captured = graphs_captured_counter() - g0
    reset_counts(mods)
    got, _, wall, handles = serve_loop(torch, eng, work,
                                       f"phase 13b {cfg.weights_dtype}")
    counts = read_counts(mods)
    ttft = [h.ttft_s for h in handles]
    ntok = sum(len(t) for t in got)
    r = dict(streams=got, tps=ntok / wall, p50=pctl(ttft, 0.5),
             p99=pctl(ttft, 0.99), peak=torch.cuda.max_memory_allocated(),
             captured=captured,
             names=sorted(h.name for h in eng._handles.values()),
             launches={k: counts[k] for k in
                       SERVING_KERNELS + QUANT_KERNELS if counts[k]},
             weights_bytes=eng.weights_bytes, pool=eng.kv_pool_bytes())
    eng.close()
    del eng
    return r


def on_card(params):
    return {n: t.to("cuda") for n, t in params.items()}


def solo_fast(params, cfg, work, idx):
    from gym_tpu_torch.models.nanogpt import generate_fast
    out = []
    for i in idx:
        p, kw = work[i]
        gen_kw = {k: v for k, v in kw.items() if k != "max_new_tokens"}
        out.append(generate_fast(params, cfg, p[None], kw["max_new_tokens"],
                                 **gen_kw)[0, len(p):].tolist())
    return out


def quant_card_vs_cpu(torch, q8, qcfg, steps=8):
    """The card against the CPU on the same int8 weights: with an f32 KV
    cache, the logits in phase 10's band (the weights' path: B6 against
    its plain version); with the int8 KV cache, the greedy tokens equal
    and each K/V element at most one int8 level apart: a value within its
    rounding of a half step lands on either side when the f32 K and V it
    came from differ in their last bits (R1's chains on the card, MKL's
    order on the CPU), and a level moves its scores by up to amax/127 of
    the element, far outside phase 10's band, which is why the logits'
    and the scales' gaps are printed, not held to it."""
    import dataclasses
    card_vs_cpu_serving(torch, q8, dataclasses.replace(qcfg, kv_dtype="f32"),
                        steps, "phase 13b int8 weights, f32 KV:")
    out = {dev: greedy_on(torch, q8, qcfg, dev, steps)
           for dev in ("cuda", "cpu")}
    card, cpu = out["cuda"][2], out["cpu"][2]
    n = flipped = wide = 0
    scale_gap = 0.0
    for name, c in cpu.items():
        a = card[name].cpu()
        if c.dtype == torch.int8:
            d = (a.int() - c.int()).abs()
            n += d.numel()
            flipped += int((d > 0).sum())
            wide += int((d > 1).sum())
        elif name.endswith("_scale"):
            written = c != 0
            scale_gap = max(scale_gap, float(
                ((a - c).abs() / c.abs().clamp_min(1e-30))[written].max()))
    log(f"phase 13b int8 weights, int8 KV: card vs CPU greedy tokens "
        f"{'equal' if out['cuda'][1] == out['cpu'][1] else 'DIFFER'}; "
        f"{flipped} of {n} cached int8 elements one level apart, {wide} "
        f"more; the scales' largest relative gap {scale_gap:.2e}, the "
        f"logits' gap {logits_gap(out):.3e} of the largest (for the "
        f"record)")
    check(out["cuda"][1] == out["cpu"][1], "phase 13b: card and CPU greedy "
          "tokens differ under int8 KV")
    check(wide == 0, f"phase 13b: {wide} cached int8 elements of the card "
          f"more than one level from the CPU's")


def quant_serving(torch, mods, card):
    """13b: phase 10's workload under int8 weights and int8 KV, graphs, in
    turns with f32 graphs (three runs each); the streams against an eager
    int8 run and the card's quantized generate_fast; card against CPU;
    one run under int4 weights and embedding."""
    from gym_tpu_torch.serve.load import quantize_params
    f32_cfg, work = serve_model_cfg(), serve_workload()
    qcfg = quant_cfg()
    # both trees wait on the CPU: each engine copies its own to the card,
    # so a run's peak memory holds one tree
    f32 = serve_params(device="cpu")
    q8 = quantize_params(f32, qcfg)
    runs = {"f32": [], "int8": []}
    for _ in range(3):
        runs["f32"].append(quant_run(torch, mods, f32, f32_cfg, work))
        runs["int8"].append(quant_run(torch, mods, q8, qcfg, work))
    for arm in runs:
        check(all(r["streams"] == runs[arm][0]["streams"]
                  for r in runs[arm]), f"phase 13b: {arm} streams differ "
              f"from run to run")
    q = runs["int8"][0]
    launches = {k: q["launches"].get(k, 0) for k in QUANT_KERNELS}
    for k in QUANT_KERNELS:
        check(launches[k] > 0, f"phase 13b: {k} never launched")
    check("B7_decode_attention" not in q["launches"] and
          "R1_row_gemm" in q["launches"],
          f"phase 13b: int8 launches {q['launches']}")
    eager = quant_run(torch, mods, q8, qcfg, work, graphs=False)
    check(eager["streams"] == q["streams"], "phase 13b: the int8 graphs' "
          "streams differ from the eager engine's")
    check(eager["launches"] == q["launches"], f"phase 13b: launches eager "
          f"{eager['launches']} vs graphs {q['launches']}")
    solo = solo_fast(on_card(q8), qcfg, work, (3, 4))
    ok = solo == [q["streams"][3], q["streams"][4]]
    log(f"phase 13b int8 weights + int8 KV, phase 10's workload ({len(work)}"
        f" requests, paged, page 16, 16 slots, decode_chunk 8, CUDA graphs;"
        f" three runs each in turns with f32) on {card}:")
    for arm in ("f32", "int8"):
        rs = runs[arm]
        log(f"  {arm}: output tokens/s "
            + ", ".join(f"{r['tps']:.1f}" for r in rs)
            + "; TTFT p50 " + ", ".join(f"{r['p50'] * 1e3:.1f}" for r in rs)
            + " ms, p99 " + ", ".join(f"{r['p99'] * 1e3:.1f}" for r in rs)
            + " ms; peak memory " + ", ".join(f"{r['peak'] / 2**30:.3f}"
                                             for r in rs)
            + f" GiB; {rs[0]['captured']} graphs captured; weights "
            f"{rs[0]['weights_bytes']:,} B, KV pool {rs[0]['pool']}; "
            f"launches {rs[0]['launches']}")
    med = {a: sorted(r["tps"] for r in runs[a])[1] for a in runs}
    log(f"  median output tokens/s int8 {med['int8']:.1f} / f32 "
        f"{med['f32']:.1f} = {med['int8'] / med['f32']:.3f}x; int8 graphs "
        f"vs eager ({eager['tps']:.1f} tokens/s): streams equal, launches "
        f"equal; requests 3 and 4 vs the card's quantized generate_fast: "
        f"{'equal' if ok else 'DIFFER'}; program names "
        f"{[n for n in q['names'] if 'decode' in n]}")
    check(ok, "phase 13b: the int8 engine differs from generate_fast")
    check(runs["int8"][0]["captured"] == SERVE_FAMILY,
          f"phase 13b: {runs['int8'][0]['captured']} graphs captured")
    quant_card_vs_cpu(torch, q8, qcfg)
    del q8
    q4cfg = quant_cfg("int4", quant_embed=True)
    q4 = quantize_params(f32, q4cfg)
    del f32
    r4 = quant_run(torch, mods, q4, q4cfg, work)
    solo = solo_fast(on_card(q4), q4cfg, work, (3, 4))
    ok = solo == [r4["streams"][3], r4["streams"][4]]
    div = sum(a != b for s, t in zip(r4["streams"], q["streams"])
              for a, b in zip(s, t)) / sum(len(s) for s in q["streams"])
    log(f"  int4 weights and embedding, int8 KV: {r4['tps']:.1f} output "
        f"tokens/s, peak {r4['peak'] / 2**30:.3f} GiB, weights "
        f"{r4['weights_bytes']:,} B, launches {r4['launches']}; requests "
        f"3 and 4 vs its generate_fast: {'equal' if ok else 'DIFFER'}; "
        f"tokens differing from int8's {div:.3f}")
    check(ok, "phase 13b: the int4 engine differs from generate_fast")
    check("R1_row_gemm" in r4["launches"] and
          r4["launches"].get("B6_row_qgemm", 0) > 0,
          f"phase 13b int4: launches {r4['launches']}")
    torch.cuda.empty_cache()
    return launches


def quant_capacity(torch, card):
    """13c (bench.py's quantized arm at GPT-2 base): capacity at equal KV
    payload bytes, the weight bytes, the divergence from f32 and the eval
    loss delta."""
    import numpy as np
    from gym_tpu_torch.models.nanogpt import GPT, generate_fast
    from gym_tpu_torch.serve import InferenceEngine, SamplingParams
    from gym_tpu_torch.serve.load import quantize_params
    cfg, qcfg = serve_model_cfg(), quant_cfg()
    f32 = serve_params()
    q8 = quantize_params(f32, qcfg)
    rng = np.random.default_rng(13)

    def nbytes(p):
        return sum(t.numel() * t.element_size() for t in p.values())

    def arm(c, p, pages):
        eng = InferenceEngine(p, c, device="cuda", num_slots=2, paged=True,
                              page_size=16, kv_pages=pages)
        prompts = np.random.default_rng(900).integers(
            0, c.vocab_size, (CAP_PROMPTS, 16)).astype(np.int32)
        for i, prompt in enumerate(prompts):
            slot, ev = eng.admit(prompt, SamplingParams(max_new_tokens=2,
                                                        seed=900 + i))
            while not ev.finished:
                ev = [e for e in eng.step() if e.slot == slot][-1]
        out = (eng.kv_pool_bytes(), eng.stats.kv_blocks_cached,
               eng.kv_blocks_capacity_effective)
        eng.close()
        return out

    t0 = time.perf_counter()
    fb, fc, fe = arm(cfg, f32, CAP_F32_PAGES)
    ib, ic, ie = arm(qcfg, q8, CAP_INT8_PAGES)
    ratio = ic / max(fc, 1)
    emb = quantize_params(f32, quant_cfg(quant_embed=True))
    wb = (nbytes(f32), nbytes(q8), nbytes(emb))
    del emb
    log(f"phase 13c capacity ({CAP_PROMPTS} distinct one-block prompts, page "
        f"16, sequential) on {card}: f32 pool {CAP_F32_PAGES} pages "
        f"{fb}, {fc} resident prefix blocks; int8 pool {CAP_INT8_PAGES} pages"
        f" {ib}, {ic} resident; ratio {ratio:.3f} (capacity_effective "
        f"{fe} vs {ie}); {time.perf_counter() - t0:.1f} s")
    check(ib["payload"] <= fb["payload"], f"phase 13c: int8 payload "
          f"{ib} > f32 {fb}")
    check(ic >= 4 * fc, f"phase 13c: int8 holds {ic} resident blocks, "
          f"f32 {fc}: under 4x")
    log(f"  weight bytes: f32 {wb[0]:,}, int8 {wb[1]:,} "
        f"({wb[0] / wb[1]:.3f}x), int8 with the embedding {wb[2]:,} "
        f"({wb[0] / wb[2]:.3f}x)")
    prompt = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    divs = []
    for name, kw in (("greedy", dict(top_k=1)),
                     ("temperature 0.9, top-k 16",
                      dict(temperature=0.9, top_k=16)),
                     ("top-p 0.9", dict(top_p=0.9))):
        ref = generate_fast(f32, cfg, prompt[None], 32, seed=7,
                            **kw)[0, 24:]
        got = generate_fast(q8, qcfg, prompt[None], 32, seed=7,
                            **kw)[0, 24:]
        diff = ref != got
        divs.append(f"{name} {diff.mean():.4f} (first at "
                    f"{int(np.argmax(diff)) if diff.any() else None})")
    ev = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4, 65))).to(
        "cuda")
    batch = (ev[..., :-1], ev[..., 1:])
    with torch.no_grad():
        lf = float(GPT(cfg)({n: p[None] for n, p in f32.items()}, batch,
                            train=False)[0])
        lq = float(GPT(qcfg)({n: p[None] for n, p in q8.items()}, batch,
                             train=False)[0])
    log(f"  divergence from f32 over 32 tokens (fraction of tokens that "
        f"differ): {'; '.join(divs)}; eval loss f32 {lf:.6f}, int8 "
        f"{lq:.6f}, delta {lq - lf:+.6f} (random weights: the delta is the "
        f"codec's cost)")
    del f32, q8
    torch.cuda.empty_cache()
    return ratio


def quant_server(torch, card):
    """13d: ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir with
    ``--quant int8 --kv-quant int8``: 11d's 8 requests over HTTP equal to
    the eager in-process engine's on the same quantized load; /stats with
    the dtypes; a restart with programs_compiled 0."""
    import concurrent.futures
    from gym_tpu_torch.serve.load import load_for_serving
    run_dir = ckpt_dir("b")
    work = serve_workload()[:8]
    params, cfg, info = load_for_serving(run_dir, weights_dtype="int8",
                                         kv_dtype="int8")
    want, eng, _, _, _ = serve_run(torch, params, cfg, work,
                                   "(13d eager reference)",
                                   cuda_graphs=False, **SERVE_ENGINE)
    eng.close()
    del eng, params
    torch.cuda.empty_cache()
    port = free_port()
    logs = [os.path.join(CKPT_ROOT, f"server_q{i}.log") for i in (1, 2)]
    quant = ("--quant", "int8", "--kv-quant", "int8")
    proc, up_s = start_server(run_dir, port, logs[0], quant)
    try:
        stats = wait_warmup(port)
        warm = stats["warmup"]
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(work)) as ex:
            outs = list(ex.map(lambda w: http_json(
                port, "/generate", generate_body(*w)), work))
        wall = time.perf_counter() - t1
        check(all(c == 200 for c, _ in outs),
              f"phase 13d: {[(c, b) for c, b in outs if c != 200][:2]}")
        got = [b["tokens"] for _, b in outs]
        _, stats = http_json(port, "/stats")
    finally:
        stop_server(proc, logs[0], "quantized server")
    with open(logs[0]) as f:
        banner = [ln for ln in f.read().splitlines()
                  if "restored" in ln or "listening" in ln]
    ntok = sum(len(t) for t in got)
    log(f"phase 13d python -m gym_tpu_torch.serve --ckpt "
        f"{os.path.relpath(run_dir, HERE)} --quant int8 --kv-quant int8 "
        f"--num_slots 16 --decode_chunk 8 (step {info['step']}, no "
        f"--device: on {card}): listening after {up_s:.1f} s, warmup "
        f"{warm['warmed']}/{warm['total']} in {warm['seconds']:.2f} s; "
        f"{len(work)} requests over HTTP, {ntok} tokens in {wall:.3f} s "
        f"({ntok / wall:.1f} output tokens/s); streams "
        f"{'equal to' if got == want else 'DIFFER from'} the eager "
        f"in-process int8 engine's; /stats weights_dtype "
        f"{stats['weights_dtype']}, kv_dtype {stats['kv_dtype']}, "
        f"weights_bytes {stats['weights_bytes']:,}, "
        f"kv_blocks_capacity_effective "
        f"{stats['kv_blocks_capacity_effective']}")
    for ln in banner:
        log("  " + ln.strip())
    check(got == want, "phase 13d: the quantized server's streams differ "
          "from the eager engine's")
    check(stats["weights_dtype"] == stats["kv_dtype"] == "int8" and
          stats["requests_done"] == len(work),
          f"phase 13d: /stats {stats}")
    check(any("quant w=int8 kv=int8" in ln for ln in banner),
          f"phase 13d: status line {banner}")
    proc, up_s = start_server(run_dir, port, logs[1], quant)
    try:
        code, body = http_json(port, "/generate", generate_body(*work[0]))
        stats = wait_warmup(port)
    finally:
        stop_server(proc, logs[1], "restarted quantized server")
    log(f"  restart: listening after {up_s:.1f} s, first request {code} "
        f"({'equal' if body.get('tokens') == want[0] else 'DIFFERS'}), "
        f"programs_compiled {stats['programs_compiled']}, graphs_captured "
        f"{stats['graphs_captured']}")
    check(code == 200 and body["tokens"] == want[0],
          f"phase 13d: the restart's first request {code} {body}")
    check(stats["programs_compiled"] == 0, f"phase 13d: restart /stats "
          f"{stats}")


def quant_phase(torch, mods, card):
    """Phase 13 (13a-13d), after phase 12 and before 11a's run dirs go:
    returns the kernels' errors, times and 13b's launch counts."""
    t0 = time.perf_counter()
    errs, times = quant_kernels(torch, mods, card)
    t1 = time.perf_counter()
    launches = quant_serving(torch, mods, card)
    t2 = time.perf_counter()
    quant_capacity(torch, card)
    t3 = time.perf_counter()
    quant_server(torch, card)
    torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t0:.1f} s (13a {t1 - t0:.1f} s, "
        f"13b {t2 - t1:.1f} s, 13c {t3 - t2:.1f} s, 13d "
        f"{time.perf_counter() - t3:.1f} s)")
    return errs, times, launches


# -- phase 14: the process fleet and the deploy drill -------------------------


FLEET_FLAGS = ("--out-of-process", "--replicas", "2", "--autoscale",
               "--min-replicas", "2", "--max-replicas", "3")


def card_memory():
    """(the card's used MiB, [(pid, MiB)] of its compute processes): what
    ``nvidia-smi --query-gpu=memory.used`` and ``--query-compute-apps=
    pid,used_memory`` report. Where the driver sees another pid namespace
    the second lists pids that are not this machine's, each with the
    card's total (the chip machine: pid 1 each time); phase 14a then reads
    a worker's memory off the first, as the change across its start or its
    death."""
    def query(*args):
        return subprocess.run(["nvidia-smi", *args,
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True,
                              timeout=60).stdout
    used = float(query("--query-gpu=memory.used").split()[0])
    apps = []
    for line in query("--query-compute-apps=pid,used_memory").splitlines():
        pid, _, mib = (x.strip() for x in line.partition(","))
        if pid.isdigit():
            try:
                apps.append((int(pid), float(mib)))
            except ValueError:
                pass
    return used, apps


def worker_pids():
    """Pids of this machine's ``gym_tpu_torch.serve.worker`` processes."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if b"gym_tpu_torch.serve.worker" in cmd:
            pids.append(int(name))
    return pids


def watch_log(path, stop, seen):
    """Poll ``path`` every 0.1 s until ``stop`` is set, appending (time
    first seen, line) for each new complete line to ``seen``."""
    n = 0
    while not stop.is_set():
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            text = ""
        lines = text.split("\n")[:-1]
        now = time.perf_counter()
        seen.extend((now, ln) for ln in lines[n:])
        n = len(lines)
        time.sleep(0.1)


def worker_startups(seen):
    """{replica id: (pid, seconds from its spawn to its socket's
    handshake)} from the router's log lines."""
    spawned, connected = {}, {}
    for t, ln in seen:
        m = re.search(r"spawned replica (\d+) \(pid (\d+)", ln)
        if m:
            spawned.setdefault(int(m.group(1)), (t, int(m.group(2))))
        m = re.search(r"replica (\d+) connected \(pid", ln)
        if m:
            connected.setdefault(int(m.group(1)), t)
    return {rid: (pid, connected[rid] - t)
            for rid, (t, pid) in spawned.items() if rid in connected}


def sse_stream(port, prompt, kw, on_tokens=None, timeout=300):
    """One ``"stream": true`` request: its tokens and the final event;
    ``on_tokens(tokens, event)`` after each chunk."""
    import urllib.request
    body = json.dumps(dict(generate_body(prompt, kw), stream=True)).encode()
    toks, fin = [], None
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", body,
            {"Content-Type": "application/json"}), timeout=timeout) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if ev.get("done") or ev.get("error"):
                fin = ev
                break
            toks.extend(ev["tokens"])
            if on_tokens is not None:
                on_tokens(toks, ev)
    return toks, fin


def fleet_warm(port, n=2, timeout=300):
    """/stats once ``n`` live workers are healthy and each warmed its
    family."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        code, st = http_json(port, "/stats")
        live = [r for r in st.get("replicas", []) if r["healthy"]]
        if (code == 200 and len(live) >= n and
                all((r["warmup"] or {}).get("done") for r in live)):
            return st
        time.sleep(0.2)
    raise SmokeFailure(f"phase 14a: the fleet never came up warm: {st}")


def fleet_round(port, work, victim=None, kill=None):
    """``work`` streamed over HTTP together: [(tokens, final event)] and
    the wall seconds; ``kill(tokens, event)`` after each chunk of request
    ``victim``."""
    import concurrent.futures
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(work)) as ex:
        outs = list(ex.map(lambda iw: sse_stream(
            port, *iw[1], on_tokens=kill if iw[0] == victim else None),
            enumerate(work)))
    return outs, time.perf_counter() - t0


def process_fleet(torch, card, ref12b):
    """14a: ``python -m gym_tpu_torch.serve --ckpt`` 11a's run dir
    ``--out-of-process --replicas 2 --autoscale --min-replicas 2
    --max-replicas 3`` against 12b's build directory: workers that build
    nothing and warm their families, 11d's 8 requests streamed equal to
    12b's, a ``kill -9`` of the worker serving one of them (4 or more
    tokens in) under the others' load with every stream still equal and
    the autoscaler's respawn in /stats, the SIGTERM drill with no worker
    left."""
    import signal
    import threading
    from gym_tpu_torch.ops import _build
    want, tps12b = ref12b
    run_dir = ckpt_dir("b")
    work = serve_workload()[:8]
    victim = max(range(len(work)), key=lambda i: work[i][1]["max_new_tokens"])
    port = free_port()
    log_path = os.path.join(CKPT_ROOT, "server_fleet.log")
    stop_watch, seen = threading.Event(), []
    watcher = threading.Thread(target=watch_log,
                               args=(log_path, stop_watch, seen),
                               daemon=True)
    watcher.start()
    flags = (*FLEET_FLAGS, "--program-cache-dir", _build.BUILD_DIR)
    mem0 = card_memory()
    proc, up_s = start_server(run_dir, port, log_path, flags, phase="14a")
    killed = {}
    try:
        st = fleet_warm(port)
        outs, wall = fleet_round(port, work)
        got = [t for t, _ in outs]
        ntok = sum(len(t) for t in got)
        mem = card_memory()
        _, st = http_json(port, "/stats")
        live = [r for r in st["replicas"] if not r["retired"]]
        pid_by_rid = {r["id"]: r["pid"] for r in live}

        def kill(toks, ev):
            if not killed and len(toks) >= 4:
                pid = pid_by_rid[ev["replica"]]
                os.kill(pid, signal.SIGKILL)
                killed.update(pid=pid, rid=ev["replica"], at=len(toks),
                              t=time.perf_counter())

        outs2, wall2 = fleet_round(port, work, victim, kill)
        # the killed worker's memory is gone; its respawn is still
        # starting (it reaches the card about 8 s after its spawn)
        mem2 = card_memory()
        t_mem2 = time.perf_counter()
        t_respawn = None
        t_wait = time.perf_counter()
        while time.perf_counter() - t_wait < 300:
            _, st2 = http_json(port, "/stats")
            warm = [r for r in st2["replicas"] if r["healthy"] and
                    (r["warmup"] or {}).get("done")]
            if (st2["autoscaler"]["spawns"] >= 1 and len(warm) >= 2
                    and st2["replicas_spawned"] >= 3):
                t_respawn = time.perf_counter()
                break
            time.sleep(0.2)
        outs3, wall3 = fleet_round(port, work)
        _, st3 = http_json(port, "/stats")
        mem3 = card_memory()
    finally:
        line = stop_server(proc, log_path, "process fleet", phase="14a")
        stop_watch.set()
        watcher.join()
    startups = worker_startups(seen)
    left = [pid for pid, _ in startups.values()
            if os.path.exists(f"/proc/{pid}")] + worker_pids()
    pids = {pid for pid, _ in startups.values()}
    log(f"phase 14a python -m gym_tpu_torch.serve --ckpt "
        f"{os.path.relpath(run_dir, HERE)} {' '.join(FLEET_FLAGS)} "
        f"--program-cache-dir {os.path.relpath(_build.BUILD_DIR, HERE)} "
        f"--num_slots 16 --decode_chunk 8 (no --device: on {card}): "
        f"listening after {up_s:.1f} s (the parent's load, both workers' "
        f"startups); router programs_compiled {st['programs_compiled']}")
    for rid, (pid, secs) in sorted(startups.items()):
        rep = next((r for r in st3["replicas"] if r["id"] == rid), {})
        warm = rep.get("warmup") or {}
        log(f"  worker {rid} pid {pid}: startup {secs:.1f} s (spawn to the "
            f"socket's handshake), warmup {warm.get('warmed')}/"
            f"{warm.get('total')} programs in {warm.get('seconds')} s, "
            f"programs_compiled {rep.get('programs_compiled')}, "
            f"graphs_captured {rep.get('graphs_captured')}"
            + (" (killed)" if pid == killed.get("pid") else ""))
    by_pid = {pid: mib for pid, mib in mem[1] + mem3[1] if pid in pids}
    respawn_up = [t for t, ln in seen if re.search(
        rf"replica {max(startups, default=-1)} connected", ln)]
    log(f"  card memory, MiB (nvidia-smi): compute apps "
        + (f"by worker pid {by_pid}" if by_pid else
           f"{mem[1]} (pids not this machine's)")
        + f"; the card's used memory {mem0[0]:.0f} before the server, "
        f"{mem[0]:.0f} after round 1 (the server and its 2 workers "
        f"{mem[0] - mem0[0]:.0f}), {mem2[0]:.0f} "
        f"{t_mem2 - killed.get('t', t_mem2):.1f} s after the kill (the killed worker "
        f"{mem[0] - mem2[0]:.0f}; the respawn "
        + (f"connected {respawn_up[0] - killed.get('t', 0):.1f} s after the kill"
           if respawn_up else "not connected")
        + f"), {mem3[0]:.0f} after the respawn (the respawned worker "
        f"{mem3[0] - mem2[0]:.0f})")
    log(f"  round 1: {len(work)} requests streamed together, {ntok} tokens "
        f"in {wall:.3f} s ({ntok / wall:.1f} output tokens/s; 12b's "
        f"in-process server {tps12b:.1f}); streams "
        f"{'equal to' if got == want else 'DIFFER from'} 12b's")
    got2 = [t for t, _ in outs2]
    fin_v = outs2[victim][1] or {}
    log(f"  round 2: kill -9 of worker {killed.get('rid')} (pid "
        f"{killed.get('pid')}) after {killed.get('at')} of request "
        f"{victim}'s {len(want[victim])} tokens, the other 7 in flight: "
        f"{wall2:.3f} s, streams {'equal to' if got2 == want else 'DIFFER from'}"
        f" 12b's, the victim's failovers {fin_v.get('failovers')}; /stats "
        f"failovers {st3['failovers']}, autoscaler {st3['autoscaler']}, "
        f"replicas_spawned {st3['replicas_spawned']}, healthy "
        f"{st3['healthy_replicas']}; respawned and warm "
        + (f"{t_respawn - killed['t']:.1f} s after the kill"
           if t_respawn and killed else "NEVER"))
    got3 = [t for t, _ in outs3]
    log(f"  round 3 after the respawn: {wall3:.3f} s, streams "
        f"{'equal to' if got3 == want else 'DIFFER from'} 12b's; SIGTERM: "
        f"rc 0, {line.split('—')[-1].strip()}; worker processes left: "
        f"{left or 'none'}")
    check(got == want, "phase 14a: the fleet's streams differ from 12b's")
    check(killed and killed["at"] < len(want[victim]),
          f"phase 14a: the kill never landed mid-stream: {killed}")
    check(got2 == want, "phase 14a: streams differ from 12b's across the "
          "kill -9")
    check(all(f and f.get("done") for _, f in outs2),
          f"phase 14a: a stream failed across the kill: "
          f"{[f for _, f in outs2]}")
    check(fin_v.get("failovers", 0) >= 1 and st3["failovers"] >= 1,
          f"phase 14a: no failover recorded: {fin_v} {st3['failovers']}")
    check(t_respawn is not None and st3["autoscaler"]["spawns"] >= 1,
          f"phase 14a: the autoscaler never respawned: {st3['autoscaler']}")
    check(got3 == want, "phase 14a: the respawned fleet's streams differ")
    check(all(r["programs_compiled"] == 0 for r in st3["replicas"]
              if r["programs_compiled"] is not None) and
          st["programs_compiled"] == 0,
          f"phase 14a: a worker or the router ran nvcc: "
          f"{[(r['id'], r['programs_compiled']) for r in st3['replicas']]}")
    check(len(startups) >= 3, f"phase 14a: worker startups {startups}")
    check(not left, f"phase 14a: worker processes left after SIGTERM: "
          f"{left}")


def deploy_drill(torch, card):
    """14b: ``python -m gym_tpu_torch.servesim.drill --out-of-process
    --replicas 2 --kill-trainer --time-scale 2`` on the card: the trainer
    killed and resumed, zero dropped, zero nvcc builds across the swaps,
    the post-swap stream exact, no worker left."""
    import shutil
    import tempfile
    out = tempfile.mkdtemp(prefix="gym_drill_")
    cmd = [sys.executable, "-m", "gym_tpu_torch.servesim.drill", "--out",
           os.path.join(out, "d"), "--out-of-process", "--replicas", "2",
           "--kill-trainer", "--time-scale", "2"]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                           timeout=420)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith('{"deploy_drill"')]
    check(r.returncode == 0 and lines, f"phase 14b: the drill gave rc "
          f"{r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    res = json.loads(lines[-1])["deploy_drill"]
    rep = res["replay"]
    left = worker_pids()
    log(f"phase 14b python -m gym_tpu_torch.servesim.drill "
        f"--out-of-process --replicas 2 --kill-trainer --time-scale 2 (no "
        f"--device: on {card}): {wall:.1f} s; trainer killed and resumed "
        f"{res['trainer_killed_and_resumed']}, swaps to steps "
        f"{res['reload_steps']}, final step served "
        f"{res['final_step_served']}; replay {rep['done']}/"
        f"{rep['requests']} done, TTFT p50 {rep['ttft_p50_s']} s p99 "
        f"{rep['ttft_p99_s']} s, {rep['tokens_per_s']} output tokens/s; "
        f"workers' programs_compiled {res['compiles_before']} -> "
        f"{res['compiles_after']}; post-swap stream exact "
        f"{res['post_swap_stream_exact']}; worker processes left: "
        f"{left or 'none'}")
    check(res["ok"] and rep["done"] == rep["requests"] and
          res["post_swap_stream_exact"] and
          res["compiles_before"] == res["compiles_after"] and
          res["trainer_killed_and_resumed"],
          f"phase 14b: {res}")
    check(not left, f"phase 14b: worker processes left: {left}")


def fleet_phase(torch, card, ref12b):
    """Phase 14 (14a, 14b), after phase 13 and before 11a's run dirs
    go."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    process_fleet(torch, card, ref12b)
    t1 = time.perf_counter()
    deploy_drill(torch, card)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s (14a {t1 - t0:.1f} s, "
        f"14b {time.perf_counter() - t1:.1f} s)")


# -- phase 15: the network simulator and elastic membership ------------------


ELASTIC_ROOT = os.path.join(HERE, "build", "chip_smoke_elastic")
SWEEP_OUT = os.path.join(HERE, "build", "chip_smoke_sweep")
# 15b: ZeRO-1 at GPT-2 base, K=4 × 4 rows, checkpoints every 3, 9 steps
ELASTIC_NODES, ELASTIC_STEPS = 4, 9
# GPT-2 base's per-node parameter count (148 leaves)
GPT2_BASE_PARAMS = 124_475_904


def elastic_zero():
    from gym_tpu_torch.strategy import OptimSpec, ZeroReduceStrategy
    return ZeroReduceStrategy(OptimSpec("adamw", lr=3e-4), **SCHED)


def csv_rows(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def network_fits(torch, mods, card):
    """15a: phase 11a's fit (K=2 × 4 rows, bf16, DiLoCo H=2, 6 steps) with
    ``network="wan"``, with ``"datacenter"`` and without a network: every
    train.csv row priced, the trace's bytes the logged bytes exactly, wan's
    comm above datacenter's, B3/B4 exactly as the steps and evals need."""
    title = "phase 15a gpt2-base fit(network=)"
    log(f"{title}: K=2 x 4 rows, bf16, DiLoCo H=2, 6 steps, with "
        f"network='wan', 'datacenter' and none")
    out = {}
    for net in ("wan", "datacenter", None):
        run = f"15a_{net or 'none'}"
        reset_counts(mods)
        res = gpt_fit(torch, GPT2_BASE, 2, 4, 6, "cuda", True, 0, run,
                      network=net)
        counts = read_counts(mods)
        want = expected_launches(res, GPT2_BASE, 6, packed=False)
        check(counts == want, f"{title} {net}: launches {counts}, "
              f"expected {want}")
        out[net] = res
        if net is None:
            continue
        run_dir = os.path.join(HERE, "build", "chip_smoke_logs", run)
        rows = csv_rows(os.path.join(run_dir, "train.csv"))
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        check(len(rows) == 6 and all(float(r["sim_step_s"]) > 0
                                     for r in rows),
              f"{title} {net}: train.csv rows {rows}")
        check(res.sim["trace_tx_bytes"] == summary["cum_comm_bytes"],
              f"{title} {net}: trace {res.sim['trace_tx_bytes']} != "
              f"cum_comm_bytes {summary['cum_comm_bytes']}")
        log(f"  {net}: sim_total_s {res.sim['sim_total_s']:.6f}, "
            f"sim_comm_s {res.sim['sim_comm_s']:.6f}, sim_compute_s "
            f"{res.sim['sim_compute_s']:.6f}, trace_tx_bytes "
            f"{res.sim['trace_tx_bytes']:.0f} = cum_comm_bytes; per-row "
            f"sim_step_s {[r['sim_step_s'] for r in rows]}; launches "
            f"{ {k: counts[k] for k in ('B3_blk_fwd', 'B4_blk_bwd')} } as "
            f"expected")
    check(out["wan"].sim["sim_comm_s"] > out["datacenter"].sim["sim_comm_s"],
          f"{title}: wan's comm is not above datacenter's")
    log(f"  steady steps/s on {card}: network='wan' "
        f"{out['wan'].steps_per_second_steady}, 'datacenter' "
        f"{out['datacenter'].steps_per_second_steady}, none "
        f"{out[None].steps_per_second_steady} (the simulator runs on the "
        f"host; no claim is made on these)")


def start_elastic_worker(tag, nodes, faults=""):
    """A ``--ckpt-worker`` process running 15b's ZeRO-1 fit at ``nodes``
    nodes (synchronous saves) under the ``GYM_TPU_FAULTS`` spec."""
    spec = {"cfg": GPT2_BASE, "steps": ELASTIC_STEPS, "tag": tag,
            "result": os.path.join(ELASTIC_ROOT, f"{tag}.json"),
            "zero": True, "nodes": nodes, "root": ELASTIC_ROOT}
    env = dict(os.environ, GYM_TPU_FAULTS=faults, GYM_TPU_IO_RETRIES="2",
               GYM_TPU_IO_RETRY_BASE_S="0.01")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--ckpt-worker", json.dumps(spec)], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), spec


def elastic_csv(tag) -> str:
    with open(os.path.join(ELASTIC_ROOT, "logs", tag, "train.csv")) as f:
        return f.read()


def meta_like(torch, tree, k):
    """A state tree of ``tree``'s structure at ``k`` nodes, every tensor on
    the meta device: the shapes a reshard target needs, no memory."""
    from gym_tpu_torch.ops import threefry
    from gym_tpu_torch.programs.elastic_defs import elastic_shard_size
    n = GPT2_BASE_PARAMS

    def leaf(x):
        if not torch.is_tensor(x):
            return x
        shape = list(x.shape)
        if len(shape) == 2 and shape[1] == elastic_shard_size(
                n, ELASTIC_NODES):
            shape[1] = elastic_shard_size(n, k)
        return torch.empty([k] + shape[1:], dtype=x.dtype, device="meta")

    def walk(t):
        if isinstance(t, dict):
            return {key: walk(v) for key, v in t.items()}
        return leaf(t)

    out = {key: walk(tree[key]) for key in ("params", "model_state",
                                             "strategy_state")}
    out.update(step=tree["step"], rng=threefry.node_keys(0, k))
    return out


def elastic_round_trip(torch, tree):
    """K=4 → 3 → 4 and 4 → 5 → 4 of a trained ZeRO state through the
    ZeRO-2 codec and ``reshard_state`` on the card: params, both moments
    and the pad tail bit-identical."""
    from gym_tpu_torch.elastic import (STACKED_LAYOUT, ZERO2_LAYOUT,
                                       elastic_meta, make_zero2_codec,
                                       reshard_state)
    n = GPT2_BASE_PARAMS
    to_canon, _ = make_zero2_codec(tree, ELASTIC_NODES)
    raw = to_canon(tree)
    opt = tree["strategy_state"]["opt"]
    # n = 4 · 31,118,976 = 3 · 41,491,968: only K=5 pads its last shard
    for k_mid in (3, 5):
        mid = reshard_state(raw, elastic_meta(ELASTIC_NODES, ZERO2_LAYOUT, n),
                            meta_like(torch, tree, k_mid))
        tail = mid["strategy_state"]["opt"]["mu"]["flat"].reshape(-1)[n:]
        back = reshard_state(mid, elastic_meta(k_mid, STACKED_LAYOUT, n),
                             meta_like(torch, tree, ELASTIC_NODES))
        same = (all(torch.equal(back["params"][m], tree["params"][m])
                    for m in tree["params"])
                and all(torch.equal(back["strategy_state"]["opt"][m]["flat"],
                                    opt[m]["flat"]) for m in ("mu", "nu")))
        log(f"  K=4 -> {k_mid} -> 4 on the card: params, mu and nu "
            f"{'bit-identical' if same else 'DIFFER'}; the K={k_mid} "
            f"shards' pad tail: {tail.numel()} moment(s), "
            f"{'all zero' if not tail.any() else 'NONZERO'}")
        check(same and not tail.any(),
              f"phase 15b: the K=4 -> {k_mid} -> 4 round trip differs")
        del mid, back


def replicate_path(torch, card):
    """DiLoCo int8 (no error feedback, stateless SGD inner), K=2 → 3 at
    4L/4H/256d: checkpointed at a sync boundary (step 3, H=2: step 2
    synced) it resumes, every per-node leaf a replica; checkpointed
    mid-cycle (H=4) it raises NodeCountMismatchError and quarantines
    nothing."""
    from gym_tpu_torch.strategy import (DiLoCoStrategy,
                                        NodeCountMismatchError, OptimSpec)

    def strat(H):
        return DiLoCoStrategy(OptimSpec("sgd", lr=0.05), H=H, codec="int8",
                              error_feedback=False)

    for H, tag in ((2, "sync"), (4, "mid")):
        ckpt_fit(torch, CKPT_SMALL, 3, f"rep_{tag}", strategy=strat(H),
                 root=ELASTIC_ROOT)
    res = ckpt_fit(torch, CKPT_SMALL, 6, "rep_sync", nodes=3,
                   strategy=strat(2), root=ELASTIC_ROOT)
    first = [s for s, _ in res.history["train_loss"]]
    check(first == [3, 4, 5] and all(p.shape[0] == 3 for p in
                                     res.node_state.params.values()),
          f"phase 15b: the sync-boundary resume logged {first}")
    raised = None
    try:
        ckpt_fit(torch, CKPT_SMALL, 6, "rep_mid", nodes=3, strategy=strat(4),
                 root=ELASTIC_ROOT)
    except NodeCountMismatchError as e:
        raised = e
    names = sorted(os.listdir(os.path.join(ELASTIC_ROOT, "ckpt", "rep_mid")))
    check(raised is not None and names == ["3", "config.json"],
          f"phase 15b: the mid-cycle resume gave {raised!r}, left {names}")
    log(f"  replicate path (4L/4H/256d, DiLoCo int8 without error feedback, "
        f"SGD): K=2 -> 3 at a sync boundary resumed, steps {first}; "
        f"mid-cycle (H=4) refused: {str(raised)[:110]}...; quarantined "
        f"nothing ({names})")


def elastic_phase(torch, mods, card):
    """15b: ZeRO-1 at GPT-2 base with ZeRO-2 checkpoints; a worker killed
    -9 past the step-3 save and resumed at K=3 and K=5 in processes of
    their own; the in-process uninterrupted run, its step dir's bytes and
    round trips; the replicate path; restore-plus-reshard timed."""
    import shutil
    from gym_tpu_torch.elastic import (ZERO2_LAYOUT, elastic_meta,
                                       reshard_state)
    from gym_tpu_torch.trainer import _on_device, _state_tree
    from gym_tpu_torch.utils.checkpoint import CheckpointManager
    title = "phase 15b gpt2-base elastic ZeRO"
    n = GPT2_BASE_PARAMS
    log(f"{title}: K={ELASTIC_NODES} x 4 rows, bf16, ZeRO-1 AdamW, "
        f"checkpoint_interval={CKPT_EVERY}, {ELASTIC_STEPS} steps; a worker "
        f"killed by dispatch.boundary:kill@5, resumed at K=3 and K=5")
    shutil.rmtree(ELASTIC_ROOT, ignore_errors=True)
    procs = []
    try:
        kill = start_elastic_worker("kill", ELASTIC_NODES,
                                    "dispatch.boundary:kill@5")
        procs.append(kill[0])
        reset_counts(mods)
        torch.cuda.empty_cache()
        base = ckpt_fit(torch, GPT2_BASE, ELASTIC_STEPS, "base",
                        nodes=ELASTIC_NODES, strategy=elastic_zero(),
                        root=ELASTIC_ROOT)
        counts = read_counts(mods)
        want = expected_launches(base, GPT2_BASE, ELASTIC_STEPS,
                                 packed=False)
        check(counts == want, f"{title}: launches {counts}, expected {want}")
        step_dir = os.path.join(ELASTIC_ROOT, "ckpt", "base",
                                str(ELASTIC_STEPS))
        disk = dir_bytes(step_dir)
        shard = -(-n // ELASTIC_NODES)
        zero2 = 4 * (n + 2 * ELASTIC_NODES * shard)
        stacked = 4 * (ELASTIC_NODES * n + 2 * ELASTIC_NODES * shard)
        with open(os.path.join(step_dir, "meta.json")) as f:
            layout = json.load(f)["extra"]["elastic"]
        log(f"  step dir {os.path.relpath(step_dir, HERE)}: {disk:,} bytes "
            f"on disk, layout {layout}; ZeRO-2 predicts {zero2:,} "
            f"(4·(n + 2·4·ceil(n/4)), n={n:,}), the stacked layout "
            f"{stacked:,}; launches {counts} as expected")
        check(layout == elastic_meta(ELASTIC_NODES, ZERO2_LAYOUT, n),
              f"{title}: the step dir's layout {layout}")
        check(abs(disk - zero2) <= 0.01 * zero2,
              f"{title}: step dir of {disk} bytes, ZeRO-2 predicts {zero2}")

        rc, out, err = finish_ckpt_worker(kill, timeout=600)
        check(rc == -9 and out is None,
              f"{title}: the killed worker gave rc {rc}\n{err}")
        pre_kill = elastic_csv("kill")
        for k in (3, 5):
            for sub in ("ckpt", "logs"):
                shutil.copytree(os.path.join(ELASTIC_ROOT, sub, "kill"),
                                os.path.join(ELASTIC_ROOT, sub, f"k{k}"))
        resumes = {k: start_elastic_worker(f"k{k}", k) for k in (3, 5)}
        procs += [w[0] for w in resumes.values()]

        live = _state_tree(base.node_state)
        elastic_round_trip(torch, live)
        target3 = meta_like(torch, live, 3)
        tail = [l for s, l in base.history["train_loss"] if s >= CKPT_EVERY]
        del base, live
        torch.cuda.empty_cache()
        # restore-plus-reshard: the K=4 step dir read as saved, onto the
        # card, resharded onto K=3
        mgr = CheckpointManager(os.path.join(ELASTIC_ROOT, "ckpt"), "base",
                                async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, raw, _, extra = mgr.restore(None, step=ELASTIC_STEPS)
        tree3 = reshard_state(_on_device(raw, torch.device("cuda")),
                              extra["elastic"], target3)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        mgr.close()
        check(tree3["strategy_state"]["opt"]["mu"]["flat"].shape[0] == 3,
              f"{title}: the reshard onto K=3 gave the wrong shapes")
        del raw, tree3
        log(f"  restore plus reshard onto K=3 on {card}: {reshard_s:.2f} s "
            f"(crc32c verify, torch.load, to the card, unshard and "
            f"re-partition); phase 11a's restore of a stacked K=2 step: "
            f"{PHASE_11A.get('restore_s', float('nan')):.2f} s")
        replicate_path(torch, card)

        for k, started in resumes.items():
            rc, out, err = finish_ckpt_worker(started, timeout=600)
            check(rc == 0 and out is not None,
                  f"{title}: the K={k} resume gave rc {rc}\n{err}")
            first = out["losses"][0][0]
            got = [l for _, l in out["losses"]]
            stitched = elastic_csv(f"k{k}")
            quarantined = [x for x in os.listdir(os.path.join(
                ELASTIC_ROOT, "ckpt", f"k{k}")) if "corrupt" in x]
            gap = abs(sum(got) / len(got) - sum(tail) / len(tail))
            log(f"  K=4 -> {k}: resumed at step {first} to "
                f"{out['steps']}, pre-kill rows "
                f"{'verbatim' if stitched.startswith(pre_kill) else 'LOST'}"
                f", mean loss {sum(got) / len(got):.4f} against the "
                f"uninterrupted run's {sum(tail) / len(tail):.4f} (gap "
                f"{gap:.4f}), nvcc builds {out['nvcc_builds']}, "
                f"quarantined {quarantined}")
            check(out["steps"] == ELASTIC_STEPS and first == CKPT_EVERY
                  and stitched.startswith(pre_kill)
                  and len(stitched.splitlines()) == 1 + ELASTIC_STEPS
                  and gap < 0.25 and out["nvcc_builds"] == 0
                  and not quarantined,
                  f"{title}: the K={k} resume: {out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(ELASTIC_ROOT, ignore_errors=True)


def sweep_phase(torch, tfa, card):
    """15c: ``python -m gym_tpu_torch.sim.sweep`` in a subprocess with no
    ``--device`` (the card): 2 presets x DiLoCo and AllReduce x static and
    join@4 (AllReduce's; DiLoCo's per-node state has no reshard), 2 nodes,
    8 steps of a 2L/64d GPT at T=128 (the fused kernels' smallest block;
    at T=64 the gate would take dense attention); the report's headline and
    reconciliation, frontier.csv, the join cells' reshard, and the pair the
    gate picks launched in every cell."""
    import shutil
    title = "phase 15c the sweep on the card"
    q = torch.empty((4, 128, 64), device="cuda")
    packed = tfa.packed_supported(q, 2)
    pair = (("fwd_packed", "bwd_packed") if packed
            else ("blk_fwd", "blk_bwd"))
    cmd = [sys.executable, "-m", "gym_tpu_torch.sim.sweep", "--preset",
           "wan,datacenter", "--strategies", "diloco,simple_reduce",
           "--events", "none,join@4", "--nodes", "2", "--steps", "8",
           "--batch_size", "4", "--block_size", "128", "--n_layer", "2",
           "--n_embd", "64", "--out", SWEEP_OUT]
    log(f"{title}: {' '.join(cmd[1:])}; the gate's pair at [4, 128, 64] x "
        f"2 heads: {pair}")
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"{title}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        with open(os.path.join(SWEEP_OUT, "report.md")) as f:
            report = f.read()
        with open(os.path.join(SWEEP_OUT, "results.json")) as f:
            rows = json.load(f)["rows"]
        front = csv_rows(os.path.join(SWEEP_OUT, "frontier.csv"))
        check("Headline: DiLoCo" in report
              and "RECONCILIATION FAILURES" not in report,
              f"{title}: report.md\n{report}")
        check(len(rows) == 6 and len(front) == 6
              and all(r["reconciled"] for r in rows),
              f"{title}: {len(rows)} cells, {len(front)} frontier rows")
        joins = [r for r in rows if r["event"]]
        check(len(joins) == 2 and all(r["reshard_s"] > 0
                                      and r["nodes_after"] == 3
                                      for r in joins),
              f"{title}: join cells {joins}")
        for r in rows:
            got = r["attention_launches"]
            check(all(got[k] > 0 for k in pair)
                  and all(v == 0 for k, v in got.items() if k not in pair),
                  f"{title}: cell {r['cell']} launched {got}")
        for line in report.splitlines():
            if line.startswith("**Headline"):
                log("  " + line)
        for r in rows:
            log(f"  {r['cell']}: sim_total_s {r['sim_total_s']:.4f}, "
                f"sim_comm_s {r['sim_comm_s']:.4f}, compute "
                f"{r['compute_s_per_step']:.6f} s/step, reconciled, "
                + (f"reshard {r['reshard_s']:.6f} s against a cold restart's "
                   f"{r['cold_restart_s']:.6f} s, " if r["event"] else "")
                + f"launches {r['attention_launches']}")
        log(f"  {len(front)} frontier.csv rows; the sweep took {wall:.1f} s "
            f"on {card}")
    finally:
        shutil.rmtree(SWEEP_OUT, ignore_errors=True)


# -- phase 16: mixture of experts on one card ---------------------------------


# the repo's MoE config (BENCHMARKS.md, benchmarks/bench_gpt2_base.py): GPT-2
# base with every other block's MLP an 8-expert, top-2 routed MoE layer
MOE_BASE = dict(GPT2_BASE, n_experts=8, expert_topk=2, moe_every=2)
# 16a's grouped matmuls: 8 sequences of 1024 tokens, top-2 (16,384 rows),
# C 768, H 3072, 8 experts
B8_ROWS, B8_C, B8_H, B8_E = 16_384, 768, 3072, 8
# 16a's rows past sum(gs)
B8_PAST = 333
MOE_CLI_DIR = os.path.join(HERE, "build", "chip_smoke_moe_cli")


def b8_skewed(rows, e, past=0, big_first=True):
    """Group sizes summing to ``rows - past``: one empty group, one with 60%
    of the rows, the rest spread over the others (no size a multiple of the
    kernels' 128-row tiles)."""
    n = rows - past
    big = int(0.6 * n)
    rest = [(n - big) // (e - 2) + (i < (n - big) % (e - 2))
            for i in range(e - 2)]
    sizes = [0, big] + rest
    return sizes if big_first else sizes[::-1]


def b8_bound(flops, nbytes, f32, chain_ms=0.0):
    """(ms, "operations", "bytes" or "the chain"): the products at 989
    TFLOP/s (bf16) or at 67 TFLOP/s of f32 FMAs, the bytes at 3.35 TB/s,
    or (f32 forward) the chain floor, K dependent FMAs, the largest."""
    t_ops = flops / (F32_FLOPS if f32 else BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max((t_ops, "operations"), (t_bytes, "bytes"),
               (chain_ms, "the chain"))


def b8_library(torch, op, a, b, gs):
    """The yardstick's callable and its label: ``torch._grouped_mm`` where
    the installed torch has it and takes the operands (bf16; the weights
    laid out as it wants them, outside the timing), else a per-expert
    ``torch.matmul`` loop over host-known group sizes."""
    sizes = [int(n) for n in gs.tolist()]
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    if op == "dot":
        def loop():
            return [a[s:s + n] @ b[i] for i, (s, n) in
                    enumerate(zip(starts, sizes)) if n]
    else:
        def loop():
            return [a[s:s + n].t() @ b[s:s + n] for i, (s, n) in
                    enumerate(zip(starts, sizes)) if n]
    gm = getattr(torch, "_grouped_mm", None)
    if gm is None or a.dtype != torch.bfloat16:
        return loop, "per-expert torch.matmul loop"
    if op == "outer" and any(n % 8 for n in sizes):
        # the ragged axis contracted: _grouped_mm asserts on the device
        # unless each group's rows are a multiple of 16 bytes
        return loop, ("per-expert torch.matmul loop (torch._grouped_mm "
                      "takes no group of rows that is not a multiple of 8)")
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        if op == "dot":
            bt = b.transpose(1, 2).contiguous().transpose(1, 2)
            fn = lambda: gm(a, bt, offs=offs)  # noqa: E731
        else:
            at = a.t().contiguous()
            fn = lambda: gm(at, b, offs=offs)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn, "torch._grouped_mm"
    except (RuntimeError, TypeError, ValueError) as e:
        return loop, f"per-expert torch.matmul loop (_grouped_mm: {e})"[:160]


def b8_r1_oracle(torch, op, a, b, gs):
    """B8's f32 chains computed by R1 (``row_linear``), a group at a time:
    each element one in-order FMA chain from 0.0f, R1's contract and B8's;
    rows past sum(gs) and empty groups zero."""
    from gym_tpu_torch.ops.row_linear import row_linear
    from gym_tpu_torch.ops.grouped_matmul import _group_rows
    if op == "dot":
        out = torch.zeros(a.shape[0], b.shape[-1], device="cuda")
        w_nk = b.stride(2) != 1
        for g, s, n in _group_rows(gs, a.shape[0]):
            wg = b[g].t() if w_nk else b[g]
            out[s:s + n] = row_linear(a[s:s + n], wg.contiguous(),
                                      w_nk=w_nk)
        return out
    out = torch.zeros(gs.shape[0], a.shape[1], b.shape[1], device="cuda")
    for g, s, n in _group_rows(gs, a.shape[0]):
        out[g] = row_linear(a[s:s + n].t().contiguous(), b[s:s + n])
    return out


def b8_routed(torch, randn, tokens, topk=2):
    """A served step's B8 operands: ``tokens`` unit-normal rows routed as
    ``moe_mlp`` routes them (an f32 softmax of x · router, the router at its
    init N(0, 0.02), ``lax.top_k``'s picks, a stable sort), so the group
    sizes are those of a real routing: at a few rows most groups empty.
    Returns (the sorted rows [tokens·k, C], GELU's inputs [tokens·k, H],
    the group sizes [E])."""
    from gym_tpu_torch.models.moe import _group_sizes, top_k
    x, router = randn(tokens, B8_C), randn(B8_C, B8_E, std=0.02)
    _, topi = top_k(torch.softmax(x @ router, dim=-1), topk)
    gid = topi.reshape(-1)
    order = torch.argsort(gid, stable=True)
    xs = x[:, None].expand(tokens, topk, B8_C).reshape(-1, B8_C)[order]
    return xs, randn(tokens * topk, B8_H), _group_sizes(gid[None], B8_E)[0]


# 16a's served steps in f32, tokens a call (top-2: twice the rows): a decode
# step of 1, 4, 8 and 16 slots, the prefill buckets of 16c's shortest and
# longest prompts (32, 512), and a 414-token prompt unpadded
B8_SERVED = (1, 4, 8, 16, 32, 414, 512)


def b8_cases(torch, dt):
    """16a's cases in dtype ``dt``: (name, op, a, b, gs). Scales as on the
    path: x and h unit normal (a layer norm's output, GELU's input), the
    weights N(0, 0.02) (their init), the cotangents N(0, 0.02). Training's
    shapes in both dtypes (the fit's forward and backward, and K=2 nodes
    flattened to 16 groups as 16b's backward launches them); in f32 also
    the served steps of ``B8_SERVED``, as 16c gives them to B8."""
    g = torch.Generator(device="cuda").manual_seed(16)
    r, c, h, e = B8_ROWS, B8_C, B8_H, B8_E

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * std).to(dt)

    x, hid = randn(r, c), randn(r, h)
    ct_h, ct_y = randn(r, h, std=0.02), randn(r, c, std=0.02)
    w_fc, w_pr = randn(e, c, h, std=0.02), randn(e, h, c, std=0.02)
    w_fc2, w_pr2 = randn(2 * e, c, h, std=0.02), randn(2 * e, h, c, std=0.02)

    def sizes(s):
        return torch.tensor(s, dtype=torch.int32, device="cuda")

    gs8 = sizes(b8_skewed(r, e))
    gs16 = sizes(b8_skewed(r // 2, e) + b8_skewed(r // 2, e,
                                                  big_first=False))
    past = sizes(b8_skewed(r, e, past=B8_PAST))
    cases = [
        ("fc", "dot", x, w_fc, gs8),
        ("proj", "dot", hid, w_pr, gs8),
        ("ct_x fc", "dot", ct_h, w_fc.transpose(1, 2), gs8),
        ("ct_x proj", "dot", ct_y, w_pr.transpose(1, 2), gs8),
        ("outer fc", "outer", x, ct_h, gs8),
        ("outer proj", "outer", hid, ct_y, gs8),
        ("fc K=2 (G=16)", "dot", x, w_fc2, gs16),
        ("proj K=2 (G=16)", "dot", hid, w_pr2, gs16),
        ("ct_x fc K=2 (G=16)", "dot", ct_h, w_fc2.transpose(1, 2), gs16),
        ("ct_x proj K=2 (G=16)", "dot", ct_y, w_pr2.transpose(1, 2), gs16),
        ("outer fc K=2 (G=16)", "outer", x, ct_h, gs16),
        ("outer proj K=2 (G=16)", "outer", hid, ct_y, gs16),
        (f"fc, {B8_PAST} rows past sum(gs)", "dot", x, w_fc, past),
        (f"outer fc, {B8_PAST} rows past sum(gs)", "outer", x, ct_h, past),
    ]
    if dt == torch.float32:
        for tokens in B8_SERVED:
            xs, hs, gs = b8_routed(torch, randn, tokens)
            cases += [(f"served fc, {tokens} tokens", "dot", xs, w_fc, gs),
                      (f"served proj, {tokens} tokens", "dot", hs, w_pr, gs)]
    return cases


# 16a's timed cases, in both dtypes: the JSON line's row of each kernel
# first; in f32 also the served decode of 1 and 16 tokens and the 512-token
# prefill
B8_TIMED = ("fc", "proj", "ct_x fc", "ct_x proj", "outer fc", "outer proj")
B8_TIMED_SERVED = tuple(f"served {op}, {n} tokens" for n in (1, 16, 512)
                        for op in ("fc", "proj"))


def b8_out_bytes(op, a, b, gs):
    return (a.shape[0] * b.shape[-1] if op == "dot"
            else gs.shape[0] * a.shape[1] * b.shape[1]) * a.element_size()


def b8_unaligned(torch, tgm):
    """bf16 views TMA does not take (C = 100: rows of 200 bytes) on the
    first kernels: each call one launch counted in ``launches_ref`` and
    none in ``launches``, in phase 3's band of the plain version; rows
    past sum(gs) and the empty group among the sizes."""
    g = torch.Generator(device="cuda").manual_seed(17)
    r, c, h, e = 4096, 100, 400, B8_E
    dt = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * std).to(dt)

    x, ct, w = randn(r, c), randn(r, h, std=0.02), randn(e, c, h, std=0.02)
    gs = torch.tensor(b8_skewed(r, e, past=B8_PAST), dtype=torch.int32,
                      device="cuda")
    for name, op, a, b in (("fc", "dot", x, w),
                           ("ct_x", "dot", ct, w.transpose(1, 2)),
                           ("outer", "outer", x, ct)):
        fn = tgm.grouped_dot if op == "dot" else tgm.grouped_outer
        plain = (tgm.plain_grouped_dot if op == "dot"
                 else tgm.plain_grouped_outer)
        before = (fn.launches, fn.launches_ref)
        poison(torch, b8_out_bytes(op, a, b, gs))
        with torch.no_grad():
            got = fn(a, b, gs)
            ref = plain(a, b, gs)
        torch.cuda.synchronize()
        compare(f"B8 {name} bf16 [{r}, {a.shape[1]}] x {list(b.shape)} "
                f"(unaligned: the first kernel)", got, ref, "out", dt)
        after = (fn.launches, fn.launches_ref)
        check(after == (before[0], before[1] + 1), f"B8 {name} unaligned: "
              f"launches {before} -> {after}, expected one on the first "
              f"kernel's path")
    log(f"  unaligned bf16 views took the first kernels, one launch each "
        f"in launches_ref")


def b8_graphs(torch, tgm, cases, tag):
    """grouped_dot and grouped_outer captured in a CUDA graph and replayed:
    equal bit for bit to the eager call."""
    for name, op, a, b, gs in cases:
        fn = tgm.grouped_dot if op == "dot" else tgm.grouped_outer
        with torch.no_grad():
            eager = fn(a, b, gs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(a, b, gs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(a, b, gs)
            out.fill_(float("nan"))
            graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(out, eager)
        log(f"  B8 {name} {tag} captured in a CUDA graph: replay "
            f"{'equal bit for bit to' if same else 'DIFFERS from'} eager")
        check(same, f"B8 {name} {tag}: a graph replay differs from eager")
        del graph, out, eager


def b8_kernel(op, f32):
    """The JSON line's row of a B8 case."""
    return ("B8_grouped_dot" if op == "dot" else "B8_grouped_outer") + (
        "_f32" if f32 else "")


def check_b8(torch, tgm, card, timing=True):
    """16a: B8 against its plain version on the card at the MoE path's
    shapes, bf16 and f32 (each output poisoned first), in the dtype's band,
    and run twice, bit for bit; bf16 also against the first kernels kept as
    the oracle (in the band; bit for bit reported); f32 bit for bit the
    oracle (the first f32 kernels) and R1's chains a group; bf16 views TMA does
    not take on the first kernels; graphs replayed equal to eager; then the
    timed cases beside the oracle, the plain version, the library yardstick
    and the bound. Returns (errs, times) keyed by the kernels' names."""
    errs = {b8_kernel(op, f32): 0.0 for op in ("dot", "outer")
            for f32 in (False, True)}
    times, rows, bits = {}, [], []
    chain_ms_per_k = FMA_CHAIN_CYCLES / (max_sm_mhz() * 1e3)
    for dt in (torch.bfloat16, torch.float32):
        f32 = dt == torch.float32
        tag = "f32" if f32 else "bf16"
        cases = b8_cases(torch, dt)
        for name, op, a, b, gs in cases:
            fn = tgm.grouped_dot if op == "dot" else tgm.grouped_outer
            plain = (tgm.plain_grouped_dot if op == "dot"
                     else tgm.plain_grouped_outer)
            first = (tgm.grouped_dot_ref if op == "dot"
                     else tgm.grouped_outer_ref)
            poison(torch, b8_out_bytes(op, a, b, gs))
            with torch.no_grad():
                got = fn(a, b, gs)
                ref = plain(a, b, gs)
            torch.cuda.synchronize()
            kernel = b8_kernel(op, f32)
            tiling = ""
            if f32 and op == "dot":
                t = tgm.f32_tiling(a.shape[0])
                tiling = (f", {tgm.F32_TILE_ROWS[t]}-row tiles "
                          f"(f32_tiling {t})")
            label = (f"B8 {name} {tag} [{a.shape[0]}, {a.shape[1]}] x "
                     f"{list(b.shape)}, G={gs.shape[0]}, sum(gs)="
                     f"{int(gs.sum())}" + (f", gs {gs.tolist()}"
                                           if name.startswith("served")
                                           else "") + tiling)
            err = compare(label, got, ref, "out", dt)
            errs[kernel] = max(errs[kernel], err)
            if op == "dot":
                used = int(gs.sum())
                check(torch.all(got[used:] == 0).item(),
                      f"B8 {op} {name} {tag}: rows past sum(gs) not zero")
            else:
                empty = (gs == 0).nonzero().flatten().tolist()
                check(all(torch.all(got[i] == 0).item() for i in empty),
                      f"B8 {name} {tag}: an empty group not zero")
            poison(torch, b8_out_bytes(op, a, b, gs))
            with torch.no_grad():
                again = fn(a, b, gs)
                old = first(a, b, gs)
            torch.cuda.synchronize()
            same_twice(torch, f"B8 {name} {tag}", (got,), (again,))
            same = torch.equal(got, old)
            what = ("the oracle (the first f32 kernel)" if f32
                    else "the first kernel")
            log(f"    {'bit for bit' if same else 'NOT bit for bit'} {what} "
                f"(max |a-b| "
                f"{(got.float() - old.float()).abs().max().item():.3e})")
            if f32:
                check(same, f"B8 {name} f32: differs from its oracle")
                with torch.no_grad():
                    chain = b8_r1_oracle(torch, op, a, b, gs)
                same = torch.equal(got, chain)
                log(f"    f32 {'bit for bit' if same else 'NOT bit for bit'}"
                    f" R1's in-order FMA chains a group (max |a-b| "
                    f"{(got - chain).abs().max().item():.3e})")
                check(same, f"B8 {name}: f32 differs from R1's chains")
                del chain
            else:
                compare(f"  against the first kernel", got, old, "out", dt)
                bits.append(same)
            del again, old
            if not timing or name not in B8_TIMED + (
                    B8_TIMED_SERVED if f32 else ()):
                continue
            used = int(gs.sum())
            k_dim, n_dim = (a.shape[1], b.shape[-1]) if op == "dot" else (
                used, b.shape[1])
            m_dim = used if op == "dot" else a.shape[1]
            flops = 2 * m_dim * k_dim * n_dim
            isz = a.element_size()
            nonempty = int((gs > 0).sum())
            if op == "dot":
                nbytes = isz * (used * a.shape[1]
                                + nonempty * a.shape[1] * b.shape[-1]
                                + a.shape[0] * b.shape[-1])
            else:
                nbytes = isz * (used * (a.shape[1] + b.shape[1])
                                + gs.shape[0] * a.shape[1] * b.shape[1])
            lib_fn, lib_label = b8_library(torch, op, a, b, gs)
            with torch.no_grad():
                ms = timed(torch, lambda: fn(a, b, gs))
                first_ms = timed(torch, lambda: first(a, b, gs))
                plain_ms = timed(torch, lambda: plain(a, b, gs), reps=3,
                                 inner=3)
                lib_ms = timed(torch, lib_fn)
            chain_ms = k_dim * chain_ms_per_k if f32 and op == "dot" else 0.0
            bound_ms, by = b8_bound(flops, nbytes, f32, chain_ms)
            log(f"    {name} {tag} timed (CUDA events, median of 5): "
                f"{ms:.4f} ms, oracle {first_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms")
            rows.append((f"{name} {tag}", ms, first_ms, plain_ms, lib_ms,
                         lib_label, bound_ms, by, flops / ms / 1e9))
            if name in ("fc", "outer fc"):
                times[kernel] = {"ms": ms, "plain_ms": plain_ms,
                                 "library_ms": lib_ms,
                                 "bound": (bound_ms, by),
                                 "oracle_ms": first_ms}
        if not f32:
            log(f"  bf16: {sum(bits)} of {len(bits)} cases bit for bit the "
                f"first kernel")
        b8_graphs(torch, tgm, [c for c in cases if c[0] in (
            "fc", "outer fc", "served fc, 1 tokens",
            "served proj, 16 tokens")], tag)
        del cases
    b8_unaligned(torch, tgm)
    if timing:
        log(f"  16a B8 times (CUDA events, median of 5) on {card}:")
        for (name, ms, first_ms, plain_ms, lib_ms, lib_label, bound_ms, by,
             tf) in rows:
            log(f"    {name}: {ms:.4f} ms ({tf:.1f} TFLOP/s), the oracle "
                f"{first_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms ({lib_label}), bound {bound_ms:.4f} ms "
                f"({by}), {bound_ms / ms:.1%} of the bound")
    return errs, times


def moe_fit(torch, mods, card):
    """16b: the MoE GPT-2 base at T=1024 through ``Trainer.fit``, K=2 x 4
    rows, bf16, DiLoCo (AdamW, H=2), 4 steps: B8's launches exactly (each
    MoE layer 2 forward products, 2 ct_x and 2 outers a step, 2 forward
    products an eval forward), steps/s, peak memory, active-parameter
    MFU."""
    from gym_tpu_torch.models.nanogpt import GPTConfig, node_mfu
    title = "phase 16b gpt2-base MoE (8 experts, top-2, every 2nd block)"
    nodes, batch, steps = 2, 4, 4
    counts, res = train_phase(torch, mods, title, MOE_BASE, nodes, batch,
                              steps, ("B8_grouped_dot", "B8_grouped_outer",
                                      "B3_blk_fwd", "B4_blk_bwd"))
    peak = torch.cuda.max_memory_allocated()
    cfg = GPTConfig(**MOE_BASE)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layer))
    evals = 2 * len(res.history["global_loss"])
    want = {"B8_grouped_dot": n_moe * (4 * steps + 2 * evals),
            "B8_grouped_outer": n_moe * 2 * steps}
    got = {k: counts[k] for k in want}
    import gym_tpu_torch.ops.grouped_matmul as tgm
    check(got == want, f"{title}: B8 launches {got}, expected {want}")
    check(tgm.grouped_dot.launches_wt == n_moe * 2 * steps,
          f"{title}: {tgm.grouped_dot.launches_wt} launches read w "
          f"transposed, expected {n_moe * 2 * steps}")
    ref = (tgm.grouped_dot.launches_ref, tgm.grouped_outer.launches_ref)
    check(ref == (0, 0), f"{title}: B8 launches on the first kernels' path "
          f"{ref}: every MoE shape must take the TMA kernels")
    sps = res.steps_per_second_steady or res.steps_per_second
    mfu = node_mfu(cfg, res.node_state.params, nodes * batch, 1.0 / sps,
                   peak_flops=BF16_FLOPS)
    n_total = sum(p[0].numel() for p in res.node_state.params.values())
    log(f"  B8 launches as expected: grouped_dot {want['B8_grouped_dot']} "
        f"= {n_moe} MoE layers x (4 x {steps} steps + 2 x {evals} eval "
        f"forwards), of them {tgm.grouped_dot.launches_wt} ct_x reading w "
        f"transposed; grouped_outer {want['B8_grouped_outer']}")
    log(f"  {n_total:,} parameters a node; steady {sps:.4f} steps/s, "
        f"active-parameter MFU {mfu:.4%} at {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB on {card}")
    del res
    torch.cuda.empty_cache()
    return got


def moe_fit_f32(torch, mods, card):
    """16b in f32 (no autocast), K=2 x 1 row, 2 steps: every MoE product on
    the f32 ring kernels, their launches exactly (each MoE layer 2 forward
    products, 2 ct_x and 2 outers a step, 2 forward products an eval
    forward), none on another path."""
    from gym_tpu_torch.models.nanogpt import GPTConfig
    import gym_tpu_torch.ops.grouped_matmul as tgm
    title = "phase 16b f32 gpt2-base MoE"
    nodes, batch, steps = 2, 1, 2
    torch.cuda.empty_cache()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = gpt_fit(torch, MOE_BASE, nodes, batch, steps, "cuda", False, 0,
                  "16b_f32")
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    losses = [l for _, l in res.history["train_loss"]]
    check(len(losses) == steps and all(math.isfinite(l) for l in losses),
          f"{title}: non-finite or missing losses {losses}")
    cfg = GPTConfig(**MOE_BASE)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layer))
    evals = 2 * len(res.history["global_loss"])
    want = {"B8_grouped_dot_f32": n_moe * (4 * steps + 2 * evals),
            "B8_grouped_outer_f32": n_moe * 2 * steps}
    got = {k: counts[k] for k in want}
    check(got == want, f"{title}: f32 B8 launches {got}, expected {want}")
    check((counts["B8_grouped_dot"], counts["B8_grouped_outer"],
           tgm.grouped_dot.launches_ref, tgm.grouped_outer.launches_ref) ==
          (want["B8_grouped_dot_f32"], want["B8_grouped_outer_f32"], 0, 0),
          f"{title}: B8 launches off the f32 ring kernels {counts}")
    log(f"{title}: K={nodes} x {batch} rows, {steps} steps, losses "
        f"{[f'{l:.6f}' for l in losses]}, {wall:.1f} s on {card}; f32 B8 "
        f"launches as expected: {got}")
    del res
    torch.cuda.empty_cache()
    return got


def tokens_digest(streams) -> str:
    """A short digest of token streams (lists of ints), to compare runs of
    two checkouts (``scripts/moe_serve_digest.py``)."""
    return hashlib.sha256(json.dumps(streams).encode()).hexdigest()[:16]


def moe_serving(torch, mods, card):
    """16c: the same MoE model in f32 (random weights from a seed) through
    the paged engine: 8 of phase 10's requests eagerly and on CUDA graphs,
    the same tokens; one request alone gives its tokens in the batch and
    ``generate_fast``'s."""
    from gym_tpu_torch.convert import serving_params
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig, generate_fast
    title = "phase 16c serving the MoE GPT-2 base"
    cfg = GPTConfig(**{k: v for k, v in MOE_BASE.items()
                       if k != "attn_impl"})
    params = serving_params(GPT(cfg).init_params(1, 0, "cuda"), node=0)
    work = serve_workload()[:8]
    paged = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
    log(f"{title}: f32, {len(work)} of phase 10's requests, prompts "
        f"{min(len(p) for p, _ in work)}-{max(len(p) for p, _ in work)} "
        f"tokens, paged engine (page 16, 16 slots, decode_chunk 8)")
    streams, launches = {}, {}
    for graphs in (False, True):
        label = "graphs" if graphs else "eager"
        reset_counts(mods)
        got, eng, _, wall, _ = serve_run(torch, params, cfg, work,
                                         f"16c {label}", cuda_graphs=graphs,
                                         **paged)
        counts = read_counts(mods)
        launches[label] = {k: counts[k] for k in ("B8_grouped_dot",
                                                  "B8_grouped_outer",
                                                  "R1_row_gemm")}
        streams[graphs] = got
        ntok = sum(len(t) for t in got)
        log(f"  {label}: {ntok} tokens in {wall:.3f} s ({ntok / wall:.1f} "
            f"tokens/s), launches {launches[label]}")
        check(counts["B8_grouped_dot"] > 0, f"{title} {label}: B8 never "
              f"launched")
        check(counts["B8_grouped_outer"] == 0, f"{title} {label}: an outer "
              f"product at inference")
        del eng
    check(streams[True] == streams[False], f"{title}: the CUDA graphs' "
          f"tokens differ from the eager engine's")
    log(f"  16c tokens digest {tokens_digest(streams[True])} (eager = "
        f"graphs; scripts/moe_serve_digest.py prints a checkout's)")
    check(launches["graphs"] == launches["eager"], f"{title}: launches on "
          f"graphs {launches['graphs']}, eagerly {launches['eager']}")
    i = 3
    p, kw = work[i]
    one, eng, _, _, _ = serve_run(torch, params, cfg, [(p, kw)],
                                  "16c alone", **paged)
    del eng
    gen_kw = {k: v for k, v in kw.items() if k != "max_new_tokens"}
    gf = generate_fast(params, cfg, p[None], kw["max_new_tokens"],
                       **gen_kw)[0, len(p):].tolist()
    log(f"  graphs equal to eager, tokens and launches (graph replays "
        f"count); request {i} alone "
        f"{'equal' if one[0] == streams[True][i] else 'DIFFERS'} to its "
        f"tokens in the batch, generate_fast "
        f"{'equal' if gf == one[0] else 'DIFFERS'}")
    check(one[0] == streams[True][i] == gf, f"{title}: a request alone "
          f"differs from its tokens in the batch or from generate_fast")
    del params
    torch.cuda.empty_cache()
    return launches["graphs"]


def moe_cli(card):
    """16d: the nanoGPT CLI with ``--n_experts 4`` on the docs corpus at a
    small width, three steps on the card, in a subprocess."""
    import shutil
    title = "phase 16d the MoE CLI"
    cmd = [sys.executable, "-m", "gym_tpu_torch.examples.nanogpt",
           "--n_experts", "4", "--dataset", "docs", "--max_steps", "3",
           "--block_size", "128", "--batch_size", "4", "--num_nodes", "2",
           "--val_size", "4", "--autocast", "--attn_impl", "flash"]
    shutil.rmtree(MOE_CLI_DIR, ignore_errors=True)
    os.makedirs(MOE_CLI_DIR)
    try:
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": HERE}
        proc = subprocess.run(cmd, cwd=MOE_CLI_DIR, capture_output=True,
                              text=True, timeout=600, env=env)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"{title}: rc {proc.returncode}\n"
              f"{proc.stderr[-3000:]}")
        runs = os.listdir(os.path.join(MOE_CLI_DIR, "logs"))
        rows = csv_rows(os.path.join(MOE_CLI_DIR, "logs", runs[0],
                                     "train.csv"))
        check(len(runs) == 1 and runs[0].endswith("_moe4e2")
              and len(rows) == 3
              and all(math.isfinite(float(r["loss"])) for r in rows),
              f"{title}: runs {runs}, rows {rows}")
        final = [l for l in proc.stdout.splitlines()
                 if l.startswith("final train loss")]
        log(f"{title}: {' '.join(cmd[3:])}: run {runs[0]}, losses "
            f"{[r['loss'] for r in rows]}; {final[0] if final else ''}; "
            f"{wall:.1f} s on {card}")
    finally:
        shutil.rmtree(MOE_CLI_DIR, ignore_errors=True)


def moe_phase(torch, mods, tgm, card):
    """Phase 16: B8 on the card (16a), the MoE GPT-2 base trained (16b) and
    served (16c), the CLI (16d). Returns (errs, times, launches) of the
    JSON line's B8 rows (launches: 16b's)."""
    t16 = time.perf_counter()
    errs, times = check_b8(torch, tgm, card)
    launches = moe_fit(torch, mods, card)
    launches.update(moe_fit_f32(torch, mods, card))
    served = moe_serving(torch, mods, card)
    log(f"  16c B8 launches on graphs: {served}")
    moe_cli(card)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    return errs, times, launches


def b8_check() -> int:
    """``chip_smoke.py --b8-check``: phase 1, the build, B8's ptxas report
    and 16a's checks alone (no timing), for ``scripts/b8_faults.py``'s
    planted faults; exits 0 when 16a passes."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import gym_tpu_torch.ops.grouped_matmul as tgm
    from gym_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = card_line()
        log(f"phase 1: {card}")
        t0 = time.perf_counter()
        _build.load()
        log(f"phase 2: built in {time.perf_counter() - t0:.1f} s")
        row_gemm_report(_build.build_log, _build._nvcc(), B8_NAMES,
                        sum(B8_KERNELS.values()))
        check_b8_sass(sass_counts(_build._nvcc(), _build.build()))
        b8_occupancy(_build.load())
        errs, _ = check_b8(torch, tgm, card, timing=False)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"16a passed: {errs}")
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gym_tpu_torch.ops.decode_attention as tdec
        import gym_tpu_torch.ops.flash_attention as tflash
        import gym_tpu_torch.ops.fused_attention as tfa
        import gym_tpu_torch.ops.grouped_matmul as tgm
        import gym_tpu_torch.ops.quantize_tiles as tqt
        import gym_tpu_torch.ops.row_linear as trow
        import gym_tpu_torch.ops.scatter_mean as tsm
        import gym_tpu_torch.ops.threefry as tf
        from gym_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: gym_tpu_torch not found beside chip_smoke.py "
              f"({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    shapes = {"flagship": (64 * 16, 256, 128, 4),
              "base": (2 * 4, 12, 1024, 64),
              "long": (2 * 1, 12, 8192, 64),
              "long_tuned_blocks": (2, 12, 2048, 64),
              "long_default_blocks": (2, 12, 1152, 64),
              "config4": (16 * 16, 256, 128, 4)}
    mods = {"fused": tfa, "flash": tflash, "threefry": tf,
            "scatter_mean": tsm, "decode_attention": tdec,
            "row_linear": trow, "quantize_tiles": tqt,
            "grouped_matmul": tgm}
    t_all = time.perf_counter()
    try:
        card = card_line()
        log(f"phase 1: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
        int32_ops_per_s = int32_rate(torch)

        t0 = time.perf_counter()
        path = _build.build()
        lib = _build.load()
        log(f"phase 2: built {os.path.relpath(path, HERE)} in "
            f"{time.perf_counter() - t0:.1f} s; ptxas:")
        for line in _build.build_log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())
        for d in (32, 64):
            log(f"  dynamic shared memory per block at D={d}: " + ", ".join(
                f"{name} {lib.gym_attn_smem_bytes(i, d)} B" for i, name in
                enumerate(("attn_fwd_tf32x3 f32", "attn_dkdv_tf32x3 f32",
                           "attn_dq_tf32x3 f32", "flash_fwd_tf32x3 f32",
                           "attn_fwd_wgmma bf16", "attn_dkdv_wgmma bf16",
                           "attn_dq_wgmma bf16", "flash_fwd_wgmma bf16"))))
        f32_kernel_report(_build.build_log, lib)
        for d in (16, 32, 64, 128):
            for bf16, kern in ((1, "flash_fwd_wgmma"), (0, "flash_fwd_tf32x3")):
                regs = (ctypes.c_int * 3)()
                per_sm = lib.gym_flash_occupancy(d, bf16, regs)
                check(per_sm >= 1, f"{kern}<{d}> cannot be resident "
                      f"({per_sm})")
                log(f"  {kern}<{d}>: 384 threads at {regs[2]} registers a "
                    f"thread at launch, setmaxnreg to {regs[0]} (producer "
                    f"warpgroup) and {regs[1]} (two consumer warpgroups); "
                    f"{per_sm} block(s) per SM")
        log("  SASS instructions per kernel (cuobjdump -sass):")
        sass = sass_counts(_build._nvcc(), path)
        check_sass(sass)
        check_serving_sass(sass)
        log("  R1 and B6 (row_gemm.cu), registers and spills (ptxas):")
        row_gemm_report(_build.build_log, _build._nvcc())
        log("  B7, B7 int8 and L1 with the add, registers and spills "
            "(ptxas):")
        row_gemm_report(_build.build_log, _build._nvcc(),
                        ("decode_attention_kernel",
                         "row_add_layer_norm_kernel"),
                        B7_KERNELS + ADD_LN_KERNELS)
        log("  D1 and T1 bits rows (scatter_mean.cu, threefry.cu) with "
            "their oracles (ptxas):")
        d1_t1_report(_build.build_log, _build._nvcc(), tsm)
        log("  T1 bits on its main path (quantize_tiles.cu), SASS and "
            "ptxas:")
        check_quantize_sass(sass)
        row_gemm_report(_build.build_log, _build._nvcc(),
                        ("quantize_tiles",), QUANTIZE_KERNELS)
        log("  B8 (grouped_gemm.cu), SASS, ptxas and occupancy:")
        check_b8_sass(sass)
        row_gemm_report(_build.build_log, _build._nvcc(), B8_NAMES,
                        sum(B8_KERNELS.values()))
        b8_occupancy(lib)
        t1_ops = threefry_ops_per_element(sass)

        log(f"phase 3: kernels against plain versions on the card "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        errs = check_kernels(torch, tfa, tflash, shapes)
        errs["T1_threefry_bernoulli"] = check_threefry(torch, tf)
        errs["T1_threefry_bernoulli_rows"] = check_threefry_rows(torch, tf)
        flagship = dict(block_size=256, vocab_size=65, n_layer=4, n_head=4,
                        n_embd=128, attn_impl="flash")
        errs["T1_threefry_bits"] = check_threefry_bits_path(torch, tf,
                                                            flagship)
        errs["T1_quantize_tiles"] = check_quantize_tiles(torch, tqt, tf,
                                                         flagship)
        errs["D1_scatter_mean"] = check_scatter_mean(torch, tsm)
        check_d1_oracle(torch, tsm)
        errs.update(check_serving_kernels(torch, tdec, trow, tf))
        base = GPT2_BASE
        long_ctx = dict(base, block_size=8192, remat=True, loss_chunk=2048)
        c4 = train_phase(torch, mods, "phase 4 flagship", flagship, 64, 16,
                         6, ("B1_fwd_packed", "B2_bwd_packed"))[0]
        c5, res5 = train_phase(torch, mods, "phase 5 gpt2-base", base, 2, 4,
                               3, ("B3_blk_fwd", "B4_blk_bwd"))
        sps5 = res5.steps_per_second_steady
        del res5
        c5b = long_context_phase(torch, mods, long_ctx, 2, 4)
        torch.cuda.empty_cache()
        launches = {"B1_fwd_packed": c4["B1_fwd_packed"],
                    "B2_bwd_packed": c4["B2_bwd_packed"],
                    "B3_blk_fwd": c5["B3_blk_fwd"],
                    "B4_blk_bwd": c5["B4_blk_bwd"],
                    "B5f_flash_fwd": c5b["B5f_flash_fwd"],
                    "B5f_flash_fwd_f32": c5b["B5f_flash_fwd_f32"],
                    "B5b_flash_bwd": c5b["B5b_flash_bwd"]}

        log(f"phase 6: card against CPU ({time.perf_counter() - t_all:.1f} s "
            f"since the start)")
        card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=64,
                                      attn_impl="flash"), 4, 4, 3, 20_000)
        card_vs_cpu(torch, mods, dict(block_size=2048, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=128,
                                      attn_impl="flash"), 2, 1, 2, 100_000,
                    want={"bf16": ("B5f_flash_fwd", "B5f_flash_fwd_f32",
                                   "B5b_flash_bwd"),
                          "f32": ("B5f_flash_fwd_f32", "B5b_flash_bwd")})

        def sparta_diloco():
            from gym_tpu_torch.strategy import (OptimSpec,
                                                SPARTADiLoCoStrategy)
            return SPARTADiLoCoStrategy(OptimSpec("adamw", lr=3e-4),
                                        p_sparta=0.3, H=2,
                                        participation=0.75, **SCHED)
        card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=64,
                                      attn_impl="flash"), 4, 4, 3, 20_000,
                    want=("T1_threefry_bernoulli",),
                    strategy_fn=sparta_diloco, label="_sparta_diloco")
        demo_card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                           n_layer=2, n_head=2, n_embd=64,
                                           attn_impl="flash"), 8, 4, 4,
                         20_000)

        log(f"phase 7: timing (CUDA events, median of 5; "
            f"{time.perf_counter() - t_all:.1f} s since the start)")
        times = time_kernels(torch, tfa, tflash, shapes)
        times["T1_threefry_bernoulli"] = time_threefry(
            torch, tf, gpt_leaves(base), t1_ops, int32_ops_per_s)
        f32_times, f32_errs = time_packed_f32(torch, tfa, shapes["config4"])
        times.update(f32_times)
        errs.update(f32_errs)
        time_heads_f32(torch, tfa, shapes["base"])
        times["T1_threefry_bernoulli_rows"], _ = time_threefry_rows(
            torch, tf, int32_ops_per_s)
        times["D1_scatter_mean"] = time_scatter_mean(torch, tsm)
        times["T1_threefry_bits"] = time_threefry_bits(
            torch, tf, -(-flagship_params(flagship) // 256) * 256,
            int32_ops_per_s)
        times["T1_quantize_tiles"] = time_quantize_tiles(
            torch, tqt, tf, flagship, int32_ops_per_s)
        times.update(time_serving_kernels(torch, tdec, trow, tf,
                                          int32_ops_per_s))

        log(f"phase 8: the stochastic strategies through Trainer.fit "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        c8a = stochastic_phase(torch, mods, tf, card, base, flagship)
        launches["T1_threefry_bernoulli"] = c8a["T1_threefry_bernoulli"]
        launches.update(compression_phase(torch, mods, card, flagship))
        codec_full_width(torch, mods, card, base)

        log(f"phase 9: the BASELINE configs through Trainer.fit "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        c9 = baseline_phase(torch, mods, card)
        cnn_card_vs_cpu(torch, mods)
        launches["T1_threefry_bernoulli_rows"] = \
            c9["9b"]["T1_threefry_bernoulli_rows"]
        launches["B1_fwd_packed_f32"] = c9["9d"]["B1_fwd_packed_f32"]
        launches["B2_bwd_packed_f32"] = c9["9d"]["B2_bwd_packed_f32"]
        launches["D1_scatter_mean"] = c9["9f"]["D1_scatter_mean"]

        log(f"phase 10: serving GPT-2 base through Scheduler "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        launches.update(serving_phase(torch, mods, card))

        log(f"phase 11: checkpoints, resume, preemption, the guard and a "
            f"run dir served ({time.perf_counter() - t_all:.1f} s since the "
            f"start)")
        q_errs, q_times, q_launches = checkpoint_phase(torch, mods, card,
                                                       sps5, t_all)
        errs.update(q_errs)
        times.update(q_times)
        launches.update(q_launches)

        t15 = time.perf_counter()
        log(f"phase 15: the network simulator and elastic membership "
            f"({t15 - t_all:.1f} s since the start)")
        network_fits(torch, mods, card)
        elastic_phase(torch, mods, card)
        sweep_phase(torch, tfa, card)
        log(f"phase 15: {time.perf_counter() - t15:.1f} s")

        log(f"phase 16: mixture of experts on one card "
            f"({time.perf_counter() - t_all:.1f} s since the start)")
        m_errs, m_times, m_launches = moe_phase(torch, mods, tgm, card)
        errs.update(m_errs)
        times.update(m_times)
        launches.update(m_launches)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    log(card)
    kernels = []
    for name, (_, _, _, source, replaces) in KERNELS.items():
        r = times[name]
        b, by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": r["library_ms"]})
        if name in B8_ORACLES:
            kernels[-1].update(kernel=B8_ORACLES[name][0],
                               oracle=B8_ORACLES[name][1],
                               oracle_ms=r["oracle_ms"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-worker"]:
        sys.exit(ckpt_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--b8-check"]:
        sys.exit(b8_check())
    sys.exit(main())
