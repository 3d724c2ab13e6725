#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 2e,2f

With no argument every phase below runs.  ``--phases`` runs only the named
phases (``PHASES``: 1, 2, 2b, 2c, 2e, 2f, 2d, 3, 4, 4b, 5, 5b, 6, 6b, 7,
7b, 8, 8b, 9, 9b, 10, 11, 12, 12b, 12c, 12d, 13, 13b, 13c), after the same
build and ptxas gate and with the same checks;
phases 2b, 2e and 2f then build phase 2's federation without its run, and
phase 2c needs phase 2.  The kernels line lists the rows of the phases that
ran.

1. Builds the CUDA kernels from the six sources of
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one
   process per source, ``decode_attention.cu`` as six objects of 8
   instances, all started together) and prints the build time and each
   kernel's registers, spills and stack frames; every instance of every
   kernel (``KERNEL_INSTANCES``: 48 ``decode_attention``, one per dtype,
   head_dim and 1..8 query heads a block, as groups of 9..16 run as two
   sub-groups; 4 ``gram_tri_kernel``, 12 ``topk_mask_kernel``, 12
   ``cross_gram_stream_kernel``, 1 ``cross_gram_ring_kernel``, 3
   ``aggregate_kernel``, 1
   ``threefry_normal_kernel``, 1 ``threefry_rounding_kernel``)
   must compile without a spill or a stack frame, and no other may appear.
   Kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the main paths' shapes (K = P = 10, Q = M = 100, D = 595,914;
   gemma3-4b's decode attention at the serve run's last step and at a 32k
   cache, recurrentgemma-2b's ring layer at G = 10, the MoE models' layers
   at G = 6, head_dim 128: dbrx-132b's global cache and mixtral-8x22b's ring
   at phase 12's last step, and mixtral's 4,096-slot ring wrapped) and at
   edge shapes (G = 9, 10 and 16 among them), and times the kernel, the plain version and one
   PyTorch library call computing the same function (CUDA events, L2
   flushed before every launch), beside the least time the card could take.
   ``topk_mask_rows`` must equal its plain version bitwise, ties, NaN, ±inf,
   -0.0, one-exponent tiles and P = 64 included; ``gram`` must be exactly
   symmetric and repeatable, and one kernel launch at P = 10 and at P = 30
   under ``torch.profiler``; ``cross_gram`` is held at K = 17, 30 and 64
   (Q = 100), at K = 30 with Q = 1,000 and on data 4 bytes past a 16-byte
   boundary too, must be bitwise repeatable there and on a second stream,
   leave its arrival counters at zero and be one kernel launch at the main
   shape, and is timed at K = 17, 30 and 64 beside ``torch.mm`` and its
   bound; all three print their planned grid, resident blocks per SM and
   registers; ``decode_attention`` within 1e-5·max|V| in fp32 and
   one ulp in bf16, in one kernel launch per call, with its planned grid,
   resident blocks per SM and shared memory printed at each timed shape.
   The Threefry kernels (``jax.random`` on the card) must equal their plain
   version bitwise: normals at edge keys and odd tails and 16 M whole,
   QuantizedFL's rounding uniforms at edge leaf layouts and at the CIFAR
   round (P = 10, D = 595,914), there also against the host draw; they are
   timed beside ``torch.rand`` / ``torch.randn`` and the INT32 units' bound.
2. Main path: the paper's CIFAR-10 model (§4.1 2conv+3fc, D = 595,914,
   ``init(0)``, the JAX package's initial weights) in a 100-client
   federation, 6 FLrce rounds through ``run_federated`` on the card.  Every
   kernel's launch count is reset just before the run and read just after;
   each kernel of the path must have run on it.  The server's ingest is
   timed each round (synchronised), and one relationship refresh is broken
   down by piece beside the same refresh from the reference's nine dot groups.
   Then 3 more rounds run under ``torch.profiler``: the device time by
   kernel and the device's busy share of the wall time are printed.
   2b. Baselines (§4.1) on the same federation at full width: 4 Fedcom rounds
   (``topk_mask_rows`` once per round), 4 FedAvg rounds and 2 rounds each
   of Fedprox, Dropout, TimelyFL, PyramidFL and QuantizedFL, each with the
   launch counts reset just before and read just after (QuantizedFL: one
   Threefry launch a round), and the time of a round's rounding uniforms
   drawn by the kernel, bitwise the host draw, beside the host draw's.
   2c. The sequential engine (one client and one batch a Python step) for 2
   rounds from phase 2's params and seed: selections and exploit flags
   equal to phase 2's first two rounds, accuracy within 2e-3, each client's
   first local step of round 0 within max(1e-5, 1e-4·max|U|) + 1e-3·|U| of
   the batched engine's, round 0's whole (P, D) update matrix within
   ``ROUND_NORM_RTOL`` of each client's norm, and each kernel launched as on
   the batched engine; per-round wall times of both engines are printed.
   2d. FLrce at a 1,000-client fleet (250,000 samples, 3.07 GB of host fp32,
   made by the CPU worker of phase 11 while the earlier phases run),
   4 rounds each with exact V/A maps (2.38 GB each), ``va_rows=40`` (no
   eviction possible: equal selections, exploit flags and stop round, Ω
   within 5e-5 of the exact run's) and ``va_rows=20`` (clients must be
   evicted, selections well formed, Ω finite); launch counts checked per
   run; per-round wall, synchronised ingest time, peak device memory and
   V/A bytes printed, with the device time by piece of one exact refresh;
   then ``cross_gram`` timed at Q = 1,000 and Q = 40 against ``torch.mm``
   and its bound.
   2e. The compiled round driver (``driver="scan"``) on phase 2's
   federation, params and seed: FLrce for 4 rounds in chunks of 2, resident
   and pipelined, resident and serial, paged with all clients as candidates
   (each equal to the loop driver's run: selections, exploit flags, stop,
   ledger, accuracy within 2e-3, the final params' max |Δ| printed), paged
   and resident with ``candidates_per_chunk=40`` (equal to each other
   bitwise); the pipelined run again with the round body eager on the card
   (no capture; bitwise the graph's); FedAvg, Fedcom and QuantizedFL for 2
   rounds against the loop (QuantizedFL bitwise: the chunk draws its
   rounding uniforms with the Threefry kernel from device tensors); then
   ``benchmarks/common.py``'s quick ``BenchConfig`` (MLP 16→24→10, M = 30,
   P = 6, 50 rounds) on the loop driver and the graph, and its first 16
   rounds captured and as eager chunks of 8.  Each scan run runs under a
   device-only ``torch.profiler``
   and must show one capture per key, one host sync per chunk (dispatch runs
   under ``set_sync_debug_mode("error")``), each kernel's launches in the
   replays as its round launches it (``gram`` every round), and the
   profiler's kernel counts between the replays' and those plus the warm-up
   rounds'; it
   prints per-round wall, device busy share, capture time, store, page and
   schedule bytes, peak device memory and real against run local steps.
   2f. Staleness-aware async rounds (``async_rounds=AsyncConfig``) on phase
   2's federation: FLrce (4 rounds, pipelined), FedAvg (2, pipelined) and
   Fedprox (2, serial) at ``max_staleness=0``, each bitwise its synchronous
   scan run (phase 2e's where it ran the same job): records, ledger, final
   params, FLrce's written-back state, launches; FLrce at ``max_staleness=2``
   on the synthetic trace for 8 rounds: every departed update arrived or is
   pending at exit, the ledger charges the departures, the trace delays
   something, ``gram`` and both ``cross_gram`` launches at the arrival
   buffer's K = 30 rows; the quick ``BenchConfig`` at ``max_staleness=2`` on
   the card against the CPU (selections, exploit flags, arrivals by
   staleness, stop round and ledger equal, accuracy within 2e-3);
   ``validate_driver_stats`` on every scan run's stats of phases 2e and 2f;
   then ``weighted_aggregate``, ``cross_gram`` (Q = 100) and ``gram`` at K =
   30 against their plain versions, timed beside ``torch.addmv`` /
   ``torch.mm`` and the bound.  The phase prints the seconds predicted for it.
3. Reference check: small federations (FLrce, Fedcom, QuantizedFL) and
   ``examples/quickstart.py``'s configuration (FLrce with and without early
   stopping, from ``init(0)``) run on the card and on the CPU (the kernels'
   plain versions) must make the same selections, exploit flags, stop
   decision and ledger charges, with accuracies and losses within fp32
   tolerance; the no-ES run must run all 25 rounds as ``flrce_no_es``.
4. Serving: gemma3-4b at full width, 12 of its 34 layers (1.80 B
   parameters, bf16: two cycles of 5 local layers and a global one; the reference's ``init(PRNGKey(0))`` drawn on the card by the Threefry
   kernel, one launch a leaf: every leaf at 4,096 sampled indices, the
   embedding's last row among them, bitwise the plain version's draw under
   the reference's key; init time printed) through
   ``repro_torch.launch.serve.generate``:
   8 requests × (1088 prompt + 64 generated) tokens, cache_len 1152, so the
   10 local layers' 1024-slot rings wrap.  ``decode_attention`` must launch
   12 times per decode step (12 × 1151), with the counts reset just before
   and read just after.  Prints prefill and generation wall time, tokens/s,
   per-step wall time and peak memory; then 8 decode steps under
   ``torch.profiler``: device time by kernel and the busy share, with
   exactly one ``decode_attention_kernel`` launch per layer per step.
   4b. Serving recurrentgemma-2b at full width, 11 of its 26 layers (8
   RG-LRU blocks and 3 local attention layers with 10 query heads over one
   KV head; the tree ``init`` builds holds 1,347,704,320 parameters, fp32 RG-LRU gates
   and bf16 elsewhere; seed 0's weights drawn and checked as in phase 4,
   fp32 RG-LRU gates and Λ included), the reference serve
   CLI's default model: 8 requests × (2112 prompt + 64 generated) tokens,
   cache_len 2176, so the 2,048-slot rings wrap.  ``decode_attention`` must
   launch 3 × 2175 times; at the last step each attention layer's kernel
   output on its own ring is held against the plain version.  Prints the
   same serving numbers as phase 4; then 8 steps under ``torch.profiler``
   by group (RG-LRU fp32 gate products, bf16 projections, conv and
   recurrence work, q/k/v/o, MLP, decode attention, unembed, the rest) and
   the busy share.  Then the whole 26-layer model in fp32 (9.2 GB): decode-step logits
   over 64 positions at B = 2 within 1e-3 of max|logit| of ``forward``'s.
5. A small gemma3-family model (8 layers, window 8, fp32) teacher-forced over
   20 positions on the card and on the CPU: logits within 1e-4 of
   max|logit|, greedy tokens equal.
   5b. The same for a small recurrentgemma-family model (the CPU tests'
   config: 8 layers, 10 heads over one KV head, window 8) over 24
   positions.
6. Federated LoRA fine-tuning of gemma3-4b at full width, 6 of its 34
   layers (1.24 B bf16 parameters, seed 0's weights drawn and checked as in phase 4;
   the adapters drawn on the card too, each A at 4,096 sampled indices
   against the plain version) through
   ``run_federated``: ``LMClassifier(cfg, seq_len=128)`` wrapped in
   ``LoRAClassifier(rank=8)`` (D = 2,629,632 over 42 target leaves), 16
   clients of 32 sequences from ``make_federated_lm`` (vocab 262,144) and 64
   eval sequences; FLrce (P = 4, 3 rounds, lr 0.01, batch 8, batched
   engine, loop driver), then FedAvg and Fedcom (keep 0.1) for 1 round
   each, every run with the launch counts reset just before and read just
   after.  Checks: (a) at B = 0 the merged model's logits equal the base
   model's bitwise; (b) ``cross_gram``, ``gram``, ``weighted_aggregate`` and
   ``topk_mask_rows`` on the phase's own operands against their plain
   versions (phase 1's tolerances, the mask bitwise), timed beside the
   plain version, the PyTorch call and the bound; (c) finite losses, P
   distinct ids a round, an exploit round, the ledger's bytes equal to the
   host formula at D; (d) the first local step of round 0's cohort on the
   batched engine within the reference's engine tolerance of the
   sequential engine's.  Prints the adapters' and the data's host time,
   per-round wall, peak memory, and from the FedAvg round, run under
   ``torch.profiler``, the device time by group (LoRA merges, chunked
   attention, cross-entropy, projection GEMMs, FL kernels, H2D), the
   device's busy share and the host's seconds inside each group's spans.
   6b. A reduced gemma3 config on the card against the CPU: LoRA FLrce over
   a bf16 and an fp32 base (3 rounds each), the full-model fp32
   ``LMClassifier`` under FedAvg (2 rounds), and LoRA FedAvg through
   ``driver="scan"`` (a captured round) against the loop: selections,
   exploit flags, stops and ledger equal, accuracy within 2e-3, losses
   within 1e-4.
7. Federated LoRA fine-tuning of recurrentgemma-2b at full width (5 of
   its 26 layers, bf16 with fp32 RG-LRU gates, seed 0's weights drawn and checked
   as in phase 4b) as phase 6 runs gemma3-4b: ``LoRAClassifier(rank=8)``
   adapts the attention layers' and MLPs' projections and every RG-LRU
   block's conv ``w`` (D = 434,240 over 11 stacked target leaves), the
   same federation at vocab 256,000, FLrce 3 rounds, FedAvg and Fedcom 1
   each, checks (a) to (d), the four FL kernels at the phase's operands,
   and its FedAvg round's profile by group (RG-LRU blocks among them).
   7b. recurrentgemma-2b's training on the card against the CPU in fp32:
   the reference CLI's pretrain case (``--silos 4 --participants 2 --rounds
   2 --local-steps 1 --batch 2 --seq 32``, reduced): silos, exploit and stop
   flags and conflicts equal, mean losses within 1e-5 relative; on a
   5-layer reduced config one LMClassifier gradient (loss within 1e-5
   relative, every leaf within 1e-5 of its max), LoRA FLrce for 3 rounds
   (discrete results equal, round 0's update rows within 1e-5 of their
   max), and LoRA FedAvg through ``driver="scan"`` against the loop and,
   captured, bitwise against the same body run eagerly.
8. Serving xlstm-1.3b at full width (48 layers: 42 mLSTM, 6 sLSTM; the
   tree ``init`` builds holds 2,119,586,128 parameters, bf16 with fp32
   gate weights and biases; seed 0's weights drawn and checked as in phase
   4, the sLSTM's recurrent matrices included): 8 requests × (128 prompt +
   64 generated) tokens through ``generate``, the same serving numbers as
   phase 4, the state's bytes (the mLSTM matrix memories are (8, 4, 1024,
   1024) fp32 a layer), 8 steps under ``torch.profiler`` by group and the
   busy share; then the model in fp32: decode-step logits over 300
   positions at B = 2 (a whole chunk of 256 and a padded one) within 1e-3
   of max|logit| of ``forward``'s, and five planted faults (states emptied
   before position 256), decoded together as one batch of 10 sequences,
   each beyond that limit.
   8b. A small xlstm-family model (9 layers: 7 mLSTM, 1 sLSTM, 1 mLSTM;
   fp32) teacher-forced over 20 positions on the card and on the CPU as in
   phase 5, and the reference CLI's serve case (``--arch xlstm-1.3b --batch
   2 --prompt-len 4 --gen 4``, reduced, fp32): tokens equal.
9. Federated LoRA fine-tuning of xlstm-1.3b at full width, 8 of its 48
   layers (seed 0's weights drawn and checked as in phase 4) as phase 6 runs gemma3-4b:
   ``LoRAClassifier(rank=8)`` adapts each mLSTM's ``wq``, ``wk``, ``wv``,
   ``wo`` and fp32 ``wi`` and each sLSTM's ``wi`` (D = 1,466,480 over 36
   stacked leaves), vocab 50,304, each client's 32 sequences in one batch;
   checks (a) to (d) ((d)'s batched side is the run's own round-0 rows,
   one batch being a client's round), the four FL kernels, the FedAvg
   round's profile (mLSTM and sLSTM blocks, and the host's seconds in each).
   9b. xLSTM's training on the card against the CPU as phase 7b checks
   recurrentgemma-2b's: the pretrain CLI case on reduced xlstm-1.3b, then a
   3-layer config (mLSTM, sLSTM, mLSTM) at 16 tokens.
10. ``examples/federated_pretrain_torch.py --size 100m --rounds 25 --chunk
   4`` (100,680,192 parameters, fp32) through ``driver="scan"``, the launch
   counts reset just before and read just after (each FL kernel launched);
   the loop driver's first 2 rounds against the example's first 2
   (selections, exploit flags, ledger, losses) and against a 2-round scan
   run (parameters within 1e-5); finite losses; ``cross_gram`` (K = 4, Q =
   8), ``gram`` and ``weighted_aggregate`` at D = 100,680,192 against their
   plain versions and float64, timed beside ``torch.mm`` / ``torch.addmv``
   and the bound.
11. The ported examples on the card against the CPU: the
   ``flrce_vs_baselines_torch`` strategies (T cut to 10) and
   ``federated_pretrain_torch --size 5m --rounds 2 --chunk 1``, each run
   against its CPU twin; ``serve_decode_torch`` for every architecture it
   offers, on the card as configured and in fp32 card against CPU (tokens
   equal).  The CPU runs, and phase 2d's federation, are made by a worker
   process (``--cpu-side DIR PARTS``) that the smoke starts after the build
   and stops at its end.
12. Serving mixtral-8x22b at full width, 12 of its 56 layers (d_model
   6,144, 48 heads over 8 KV heads, d_ff 16,384, 8 experts top-2, a 4,096
   window, vocab 32,768, bf16 with the routers fp32: 30,451,390,464
   parameters, 60.9 GB; seed 0's weights drawn and checked as in phase 4,
   the router and each expert of each stacked leaf at 4,096 indices)
   through ``generate``: 8 requests × (128 prompt + 32 generated) tokens,
   159 steps, ``decode_attention`` launched 12 times a step; the serving
   numbers of phase 4, the step's two bounds at the measured bandwidth
   (the implementation's: the bytes the drop-free step reads, every expert
   included; the function's: only the experts this run's tokens were
   routed to, each step's, and the KV slots it reads), two decode steps under
   ``set_sync_debug_mode("error")`` (the routing reads nothing back to the
   host) and 8 steps under ``torch.profiler`` by group (attention,
   ``decode_attention``, router and top-k, slotting, expert products,
   dispatch and combine, norms) with the busy share.  Then a second run
   drives the ring past its window: the first layer alone at full width
   (2,906,720,256 parameters), 8 requests × (4,468 prompt + 32 generated)
   tokens, 4,499 steps, 403 of them past the 4,096 slots; the counts are
   reset around it and give the wrapped row's launches, and the last
   step's kernel output is held against the plain version.
   12b. The same for dbrx-132b, 9 of its 40 layers (16 experts top-4,
   global attention, layernorm, vocab 100,352: 30,564,894,720 parameters
   by the config's count, 30,565,011,456 in the built tree with the
   layernorms' biases; 61.1 GB).
   12c. Both models at full width in fp32, 2 layers each (5.41 B and 7.75 B
   parameters), one after the other: decode-step logits over 48 positions
   at B = 2 within 1e-4 of max|logit| of the drop-free ``forward``'s; every
   token's experts equal in both runs, a difference allowed only where the
   forward side's gap between the k-th and (k+1)-th router probability is
   under 1e-6 (the smallest gap printed); two planted faults in the
   decode's routing (the (k+1)-th expert in place of the k-th, the gates
   not renormalised) must each pass the limit.
   12d. The reduced mixtral and dbrx models in fp32 on the card against
   the CPU: ``forward`` and ``loss`` (nll + aux) at capacity factor 1.25 in
   one group, in groups of 16 that pad 40 tokens, and at 0.5 (tokens
   dropped, as many on both), logits within 1e-4 of max|logit| and loss
   within 1e-5 relative; greedy tokens through ``generate`` equal.
13. Federated LoRA fine-tuning of mixtral-8x22b at full width, 4 of its
   56 layers (the most whose round stays under 72 GiB of device memory:
   the frozen bf16 base, the merged copy of every target leaf and one
   stacked expert leaf's fp32 merge are live at once), as phase 6 runs
   gemma3-4b: ``LoRAClassifier(rank=8)`` over each layer's attention and
   its stacked (E, d, f) experts' ``wi``, ``wg`` and ``wo`` (D =
   18,546,688; the routers frozen), each client's sequences routed one by
   one on the batched engine (the reference's ``jax.vmap`` of
   ``model.loss``); checks (a) to (c), the FLrce job run twice (equal
   selections and exploit flags, round 0's (P, D) update bitwise), the
   peak under 72 GiB, and (d) for an MoE, whose two engines train two
   functions: at one full-width layer in fp32, each engine's first local
   step against its own function computed by definition with float64
   weights and products (the per-sequence one as the mean of one-sequence
   batches' losses), within the engines' tolerance, the two engines' own
   steps' gap printed; the four FL kernels at the phase's
   operands; the FedAvg round's profile by group (MoE MLPs, LoRA merges,
   cross-entropy among them).
   13b. The same for dbrx-132b, 3 of its 40 layers (D = 20,398,080).
   13c. The reduced mixtral and dbrx models' training in fp32 on the card
   against the CPU worker, at capacity factors 1.25 and 0.5 (drops) and in
   groups of 16 that pad each 40-token sequence: a per-sequence forward's
   expert ids and kept pairs (equal where the top-k gap is 1e-6 or more)
   and each sequence's loss (within 1e-5 relative), one full-model
   ``LMClassifier`` FLrce round on each engine, one LoRA FLrce round and
   ``launch.train --mode pretrain`` for 2 rounds (selections, exploit
   flags and ledger equal, losses within 1e-4, accuracy within 2e-3).

The CPU halves of phases 2f, 3, 6b, 7b, 9b, 11 and 13c, and phase 2d's
federation, are made by a worker process (``--cpu-side``) on the last 3
cores, started after the build, in the order the phases need them.

Measurement modes, which print no result line:
``--decode-variants`` builds and times variants of the ``decode_attention``
kernel (other ring shapes, the split pass alone, an empty kernel on the
same grid; ``DECODE_VARIANTS``); ``--kernel-variants`` does the same for
``topk_mask_rows`` and ``gram`` (the stream without the select, the split
pass alone, empty kernels; ``KERNEL_VARIANTS``); ``--time-kernels [--src
DIR]`` times ``gram`` and ``topk_mask_rows`` at the main shape, and
``cross_gram`` at ``CROSS_TIMED``, from the port under DIR (default ``src``), so that two trees, such as a ``git
archive`` of a parent commit, compare in one call; ``--numerics`` measures
the FL path's float32 error against float64 at the CIFAR width (one
gradient through cuDNN's convolution and through the patch GEMM, alone and
vmapped, and the vmapped step's time; Eq. 6's entries in the reference's
expanded dot form and from r = w − a on the main path's rounds), how
far the batched and sequential engines part by local step count, and what
phase 2c's norm check reads for a sequential engine with a planted fault;
``--moe-lora-peaks`` runs one FLrce round of phases 13 and 13b at their
depth and one layer deeper and prints each one's peak device memory.

The second-to-last line is the kernels' JSON record (the five kernels at
their phase 1 shapes, ``decode_attention@recurrentgemma-2b`` at its ring
layer with phase 4b's launches, ``decode_attention@mixtral-8x22b`` (its
ring at the serve run's last step), ``decode_attention@mixtral-8x22b-wrapped``
(its 4,096-slot ring wrapped) and ``decode_attention@dbrx-132b`` (its global
cache) at their phase 1 shapes with phase 12's two runs' and 12b's launches, the two
Threefry kernels at their phase 1
shapes with phase 2b's QuantizedFL and phase 4's init launches, then the
four FL kernels at phase 6's as ``<name>@gemma3-4b-lora``, with phase 6's
launches, and at phase 7's as ``<name>@recurrentgemma-2b-lora``, with phase
7's, and at phase 2f's async round as ``<name>@async``, with its FLrce
run's wrapper launches: the warm-up round's and the capture's, and at
phase 9's as ``<name>@xlstm-1.3b-lora``, phase 10's as
``<name>@fedlm-100m``, the latter's launches the wrappers' and the
replays', and phase 13's and 13b's as ``<name>@mixtral-8x22b-lora`` and
``<name>@dbrx-132b-lora``), after the
seconds of each phase and the total; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
non-zero and no result line is printed.  Exits 1 when CUDA is absent or the
port's sources are not beside this file.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# main-path shapes: the cohort (K = P), the fleet (Q = M), PaperCNN's flat dim
K_MAIN, Q_MAIN, D_MAIN = 10, 100, 595_914
GRAM_RTOL = 1e-4           # |Δ| ≤ 1e-4·‖u_k‖‖v_j‖: fp32 sums over D reordered
AGG_ATOL = AGG_RTOL = 1e-6
GRAM_KERNEL = "gram_tri_kernel"         # the one kernel a gram call at P <= 16 launches
# the kernels a cross_gram call launches, one of them (K <= 16: the stream
# kernel; above, and gram above 16 rows: the ring kernel): the names share
# this prefix
CROSS_KERNEL = "cross_gram_"
TOPK_KERNEL = "topk_mask_kernel"
FP32_PEAK_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores (data sheet)
# H100 SXM: 132 SMs x 64 INT32 units x 1.98 GHz (Hopper white paper); the
# rotations and xors of Threefry's rounds run there and nowhere else
INT32_PEAK_OPS = 132 * 64 * 1.98e9
# a Threefry uniform's operations that only the INT32 units run: 20 rounds
# of a funnel rotation and an xor, then the words' xor, the shift and the or
THREEFRY_INT_OPS = 43
# read before every timed launch: far more than the 50 MB L2, and long
# enough (about 0.3 ms) that the host has queued the timed call before the
# card reaches it, on a slow host too
L2_FLUSH_BYTES = 1 << 30
# the phases, in the order they run; ``--phases`` picks some of them
PHASES = ("1", "2", "2b", "2c", "2e", "2f", "2d", "3", "4", "4b", "5", "5b", "6", "6b", "7", "7b",
          "8", "8b", "9", "9b", "10", "11", "12", "12b", "12c", "12d", "13", "13b", "13c")
# measurement modes: they print no result line
MODES = ("--decode-variants", "--kernel-variants", "--time-kernels", "--numerics",
         "--xlstm-gap", "--moe-lora-peaks")
# 0.05 diverges on this data: the JAX package's run of the same
# configuration, like the port's, reaches a NaN loss in round 1.
MAIN_LR = 0.01


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def short_kernel_name(mangled: str) -> str:
    """``ns::name<args>`` of a mangled kernel name as ``name`` and its mangled
    template arguments (``_ZN<n><namespace><m><name>I...EE...``)."""
    import re

    rest = mangled
    m = re.match(r"_ZN(\d+)", rest)
    if m:                                   # skip the (anonymous) namespace
        rest = rest[m.end() + int(m.group(1)):]
    m = re.match(r"(?:_Z)?(\d+)", rest)
    if not m:
        return mangled[:60]
    name, tail = rest[m.end():m.end() + int(m.group(1))], rest[m.end() + int(m.group(1)):]
    args = tail[1:tail.index("EE")] if tail.startswith("I") and "EE" in tail else ""
    return f"{name}<{args}>" if args else name


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ``-Xptxas -v``: registers and spill
    bytes."""
    import re

    out, name, spills = [], None, "spills not reported"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (f"spill stores/loads {m.group(2)}/{m.group(3)} B"
                      + (f", stack frame {m.group(1)} B" if m.group(1) != "0" else ""))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{short_kernel_name(name)}: {m.group(1)} registers, {spills}")
            name = None
    return out


def memory_bandwidth(torch) -> tuple:
    """Peak device-memory bytes/s from the memory clock and bus width the
    driver reports (HBM moves two words per clock), else the H100 SXM data
    sheet's 3.35 TB/s."""
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if clock_khz and bus_bits:
        return 2.0 * clock_khz * 1e3 * bus_bits / 8, "memory clock x bus width"
    return 3.35e12, "H100 SXM data sheet"


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each.

    The calls are queued without a synchronise in between: the 1 GiB flush
    keeps the card busy while the host runs the next wrapper, so the events
    time the device's work and not the host's launch overhead.  The flush
    reads its buffer, so it leaves clean lines in L2 and the timed call pays
    no write-back of the flush's own data.  ``flush=False`` times with the
    inputs warm in L2, a device-side sleep in place of the flush.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 3, flush: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            if flush:
                self.flush.sum()
            else:  # keep the card busy while the host queues the call, L2 untouched
                torch.cuda._sleep(200_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(start.elapsed_time(end) for start, end in pairs)
        return times[len(times) // 2]


def check_gram(name, got, plain, u, v, torch) -> tuple:
    """(max |kernel − plain|, that over ‖u_k‖‖v_j‖, the kernel's and the
    plain version's distances from the float64 product over ‖u_k‖‖v_j‖),
    with the float64 product as the referee: the kernel must lie within
    GRAM_RTOL of it, and within GRAM_RTOL plus the plain version's own
    distance from it of the plain version: at D = 10^8 cuBLAS's fp32 product
    lay up to 2.2e-4 of ‖u‖‖v‖ from float64 on the fedlm-100m rows (4e-5 on
    random rows), the kernel under 2e-6."""
    torch.cuda.synchronize()
    if got.shape != plain.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(plain.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    want = u.double() @ v.double().T
    scale = (torch.linalg.vector_norm(u.double(), dim=1)[:, None]
             * torch.linalg.vector_norm(v.double(), dim=1)[None, :]).clamp_min(1e-30)
    k64 = float(((got.double() - want).abs() / scale).max())
    p64 = float(((plain.double() - want).abs() / scale).max())
    err = (got - plain).abs()
    rel = float((err.double() / scale).max())
    del want, scale
    if k64 > GRAM_RTOL:
        fail(f"{name}: |Δ|/(‖u‖‖v‖) from the float64 product = {k64:.3e} > {GRAM_RTOL:.0e}")
    if rel > GRAM_RTOL + p64:
        fail(f"{name}: |Δ|/(‖u‖‖v‖) from the plain version = {rel:.3e} > {GRAM_RTOL:.0e} + the "
             f"plain version's own {p64:.3e} from float64")
    return float(err.max()), rel, k64, p64


def check_aggregate(name, got, want, torch) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = err > AGG_ATOL + AGG_RTOL * want.abs()
    if bool(bad.any()) or not torch.isfinite(got).all():
        fail(f"{name}: max |Δ| = {float(err.max()):.3e} beyond atol/rtol {AGG_ATOL:.0e}")
    return float(err.max())


def check_bitwise(name, got, want, torch) -> None:
    """Equal bit patterns (so -0.0 and where NaN sits are checked too)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)):
        fail(f"{name}: kernel and plain version differ bitwise")


def topk_inputs(torch, gen) -> list:
    """(label, u) pairs: normal values at the main and edge shapes, ties from
    a small integer set, NaN / ±inf / -0.0 mixed in, tiles whose 2048
    magnitudes share one exponent (every lane of a warp on one histogram
    bin), all-NaN and all -0.0 tiles, and P = 64 (many tiles a block)."""
    out = [(f"P={p} D={d}", torch.randn(p, d, generator=gen, device="cuda"))
           for p, d in [(10, 1), (10, 2047), (10, 2049), (1, D_MAIN), (17, 5000), (K_MAIN, D_MAIN),
                        (64, D_MAIN)]]
    ties = torch.randint(-3, 4, (K_MAIN, 8193), generator=gen, device="cuda").float()
    special = torch.randn(K_MAIN, 8195, generator=gen, device="cuda")
    pick = torch.randint(0, 8, special.shape, generator=gen, device="cuda")
    for code, value in ((0, float("nan")), (1, float("inf")), (2, float("-inf")), (3, -0.0)):
        special = torch.where(pick == code, torch.full_like(special, value), special)
    special[0] = float("nan")
    special[1, :2048] = -0.0
    sign = torch.where(torch.rand(K_MAIN, 4096, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    one_exp = (1.0 + torch.rand(K_MAIN, 4096, generator=gen, device="cuda")) * sign
    one_exp[1] = float("nan")
    one_exp[2] = -0.0
    return out + [("ties P=10 D=8193", ties), ("nan/inf/-0 P=10 D=8195", special),
                  ("one exponent, all-NaN and all -0.0 rows P=10 D=4096", one_exp)]


def cross_plan_line(plan) -> str:
    if plan.route == "stream":
        how = (f"{plan.warps} warps, chunks of {plan.chunk} columns, loads {plan.vec} floats "
               f"wide")
    else:
        how = (f"{plan.wk}x{plan.wq}x{plan.wc} warps, {plan.slab}-column slabs in {plan.stages} "
               f"stages ({plan.smem} B){', one copy for u = v' if plan.same else ''}")
    return (f"{plan.route} kernel: {plan.n_kt}x{plan.n_qt} tiles of {plan.kt}x{plan.qt} rows x "
            f"{plan.n_splits} blocks of {how}, sums in groups of {plan.group}; "
            f"{plan.blocks_per_sm} resident blocks per SM (occupancy query), {plan.registers} "
            f"registers")


def cross_gram_rows(torch, timer, bandwidth, gen) -> None:
    """cross_gram at K = 17, 30 and 64 rows of U against Q = 100 (the async
    round's ingest at K = 30), at K = 30 against Q = 1,000, and on data 4
    bytes past a 16-byte boundary: within GRAM_RTOL of its plain version,
    bitwise repeatable on this stream and on another, arrival counters at 0
    after; the first three timed beside torch.mm and the bound."""
    from repro_torch.kernels import grid
    from repro_torch.kernels import gram as kgram

    def bound(k, q, d):
        t_bytes, t_ops = 4 * (k * d + q * d + k * q) / bandwidth, 2 * k * q * d / FP32_PEAK_FLOPS
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    side = torch.cuda.Stream()
    for k, q, shift in [(17, Q_MAIN, 0), (30, Q_MAIN, 0), (64, Q_MAIN, 0), (30, 1000, 0),
                        (30, Q_MAIN, 1)]:
        d = D_MAIN
        if shift:   # views 4 bytes past a 16-byte boundary
            u = torch.randn(k * d + 4, generator=gen, device="cuda")[shift:shift + k * d].view(k, d)
            v = torch.randn(q * d + 4, generator=gen, device="cuda")[shift:shift + q * d].view(q, d)
        else:
            u = torch.randn(k, d, generator=gen, device="cuda")
            v = torch.randn(q, d, generator=gen, device="cuda")
        label = f"cross_gram K={k} Q={q} D={d}" + (" (data 4 bytes past 16)" if shift else "")
        got = kgram.cross_gram_cuda(u, v)
        err, rel, _, _ = check_gram(label, got, kgram.cross_gram_plain(u, v), u, v, torch)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = kgram.cross_gram_cuda(u, v)
        torch.cuda.synchronize()
        if not (torch.equal(got, kgram.cross_gram_cuda(u, v)) and torch.equal(got, other)):
            fail(f"{label}: not bitwise repeatable on one stream and on another")
        torch.cuda.synchronize()
        if any(int(c.abs().sum()) for c in grid.ARRIVALS.values()):
            fail(f"{label}: arrival counters not back at zero")
        print(f"  {label}: max |Δ| {err:.3e}, |Δ|/(‖u‖‖v‖) {rel:.2e}, bitwise repeatable on two "
              f"streams, counters at 0; plan {cross_plan_line(kgram.cross_plan(u, v))}")
        if q == Q_MAIN and not shift:
            b_ms, b_by = bound(k, q, d)
            ms, mm_ms = timer(lambda: kgram.cross_gram_cuda(u, v)), timer(lambda: torch.mm(u, v.t()))
            print(f"  cross_gram K={k} Q={q} D={d}: kernel {ms:.4f} ms, torch.mm {mm_ms:.4f} ms "
                  f"({ms / mm_ms:.3f}x), bound {b_ms:.4f} ms ({b_by}) -> "
                  f"{100 * b_ms / ms:.1f}% of bound")
        del u, v, got, other
    torch.cuda.empty_cache()


def kernel_phase(torch, timer, bandwidth) -> dict:
    from repro_torch.kernels import aggregate as kagg
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import topk_mask as ktopk

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    # edge shapes: D = 1, ragged D, K = 1, Q = 1, K = 17 past the 16-row
    # instance, Q past a warp's rows, odd D, 16-byte-aligned D
    for k, q, d in [(10, 100, 1), (10, 100, 2049), (1, 100, D_MAIN), (10, 1, D_MAIN),
                    (1, 1, 1), (17, 33, 5000), (10, 100, 4096)]:
        u, v = randn(k, d), randn(q, d)
        _, rel, _, _ = check_gram(f"cross_gram K={k} Q={q} D={d}",
                            kgram.cross_gram_cuda(u, v), kgram.cross_gram_plain(u, v), u, v, torch)
        print(f"  cross_gram edge K={k:3d} Q={q:3d} D={d:7d}: max |Δ|/(‖u‖‖v‖) {rel:.2e}")
    cross_gram_rows(torch, timer, bandwidth, gen)
    for p, d in [(10, 1), (10, 2049), (1, D_MAIN), (17, 5000), (10, 4096), (4, D_MAIN),
                 (5, D_MAIN), (12, D_MAIN), (16, D_MAIN), (17, D_MAIN), (30, D_MAIN),
                 (64, D_MAIN)]:
        u = randn(p, d)
        got = kgram.gram_cuda(u)
        _, rel, _, _ = check_gram(f"gram P={p} D={d}", got, kgram.gram_plain(u), u, u, torch)
        if not (torch.equal(got, got.T) and torch.equal(got, kgram.gram_cuda(u))):
            fail(f"gram P={p} D={d}: not exactly symmetric or not repeatable")
        print(f"  gram edge P={p:3d} D={d:7d}: max |Δ|/(‖u‖‖u‖) {rel:.2e}, symmetric, repeatable")
    for p, d in [(10, 1), (10, 2049), (1, D_MAIN), (10, 4096), (3, 7)]:
        w, u, pw = randn(d), randn(p, d), torch.rand(p, generator=gen, device="cuda")
        err = check_aggregate(f"weighted_aggregate P={p} D={d}", kagg.weighted_aggregate_cuda(w, u, pw),
                              kagg.weighted_aggregate_plain(w, u, pw), torch)
        print(f"  weighted_aggregate edge P={p:3d} D={d:7d}: max |Δ| {err:.2e}")
    for label, u in topk_inputs(torch, gen):
        for keep_frac in (0.001, 0.1, 0.5, 1.0):
            check_bitwise(f"topk_mask_rows {label} keep_frac={keep_frac}",
                          ktopk.topk_mask_rows_cuda(u, keep_frac=keep_frac),
                          ktopk.topk_mask_rows_plain(u, keep_frac=keep_frac), torch)
        print(f"  topk_mask_rows {label}: bitwise equal at keep_frac 0.001, 0.1, 0.5, 1.0")

    k, q, d = K_MAIN, Q_MAIN, D_MAIN
    u, v = randn(k, d), randn(q, d)
    w, pw = randn(d), torch.rand(k, generator=gen, device="cuda")
    pw = pw / pw.sum()

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bandwidth, flops / FP32_PEAK_FLOPS
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    rows = []
    err, rel, _, _ = check_gram("cross_gram main", kgram.cross_gram_cuda(u, v),
                                kgram.cross_gram_plain(u, v), u, v, torch)
    b_ms, b_by = bound(4 * (k * d + q * d + k * q), 2 * k * q * d)
    rows.append(dict(
        name="cross_gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:99", max_abs_err=err, rel_err=rel,
        ms=timer(lambda: kgram.cross_gram_cuda(u, v)),
        plain_ms=timer(lambda: kgram.cross_gram_plain(u, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.mm(u, v.t())),
        shape=f"K={k} Q={q} D={d}",
    ))
    err, rel, _, _ = check_gram("gram main", kgram.gram_cuda(u), kgram.gram_plain(u), u, u, torch)
    b_ms, b_by = bound(4 * (k * d + k * k), 2 * k * k * d)
    rows.append(dict(
        name="gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:56", max_abs_err=err, rel_err=rel,
        ms=timer(lambda: kgram.gram_cuda(u)),
        plain_ms=timer(lambda: kgram.gram_plain(u)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.mm(u, u.t())),
        shape=f"P={k} D={d}",
    ))
    err = check_aggregate("weighted_aggregate main", kagg.weighted_aggregate_cuda(w, u, pw),
                          kagg.weighted_aggregate_plain(w, u, pw), torch)
    b_ms, b_by = bound(4 * (d + k * d + k + d), 2 * k * d)
    rows.append(dict(
        name="weighted_aggregate", route="cuda", source="src/repro_torch/kernels/csrc/aggregate.cu",
        replaces="src/repro/kernels/aggregate.py:37", max_abs_err=err, rel_err=err,
        ms=timer(lambda: kagg.weighted_aggregate_cuda(w, u, pw)),
        plain_ms=timer(lambda: kagg.weighted_aggregate_plain(w, u, pw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.addmv(w, u.t(), pw)),
        shape=f"P={k} D={d}",
    ))
    kf, bd = 0.1, ktopk.DEFAULT_BLOCK_D
    k_keep = ktopk.keep_count(kf, bd)
    check_bitwise("topk_mask_rows main", ktopk.topk_mask_rows_cuda(u, keep_frac=kf),
                  ktopk.topk_mask_rows_plain(u, keep_frac=kf), torch)
    padded = torch.nn.functional.pad(u, (0, (-d) % bd)).reshape(-1, bd)

    # the operations any selection needs: each element compared with its
    # tile's threshold once
    b_ms, b_by = bound(4 * (k * d + k * d), k * d)
    rows.append(dict(
        name="topk_mask_rows", route="cuda", source="src/repro_torch/kernels/csrc/topk_mask.cu",
        replaces="src/repro/kernels/topk_mask.py:38", max_abs_err=0.0, rel_err=0.0,
        ms=timer(lambda: ktopk.topk_mask_rows_cuda(u, keep_frac=kf)),
        plain_ms=timer(lambda: ktopk.topk_mask_rows_plain(u, keep_frac=kf)),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call computes it; the two-call route below is
        # printed and kept in PERF.md, not in the JSON line
        library_ms=None, route_ms=timer(lambda: topk_route(torch, padded, k_keep)),
        shape=f"P={k} D={d} keep_frac={kf}",
    ))
    launch_plans(torch, kgram, ktopk, u)
    for r in rows:
        lib = (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"torch.topk+torch.where (two calls) {r['route_ms']:.4f} ms")
        print(f"  {r['name']:<18} {r['shape']:<22} max|Δ| {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"-> {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    del u, v, w, padded
    torch.cuda.empty_cache()
    return {r["name"]: r for r in rows}


def sass_census(match: str) -> dict:
    """Opcode counts of each built kernel whose name holds ``match``, from
    ``cuobjdump -sass`` of the library (beside ``nvcc``); empty without it."""
    import re

    from repro_torch.kernels import build

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print(f"  {tool} not found: no SASS census")
        return {}
    out = subprocess.run([str(tool), "-sass", build.BUILD_INFO["path"]], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    census, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_kernel_name(m.group(1)) if match in m.group(1) else None
            if name:
                census[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and m:
            census[name][m.group(1)] += 1
    return census


def threefry_phase(torch, timer, bandwidth) -> dict:
    """The Threefry kernels against their plain version, bitwise: normals
    at edge keys and odd tails and 16 M whole; QuantizedFL's rounding
    uniforms at edge leaf layouts and at the CIFAR round (P = 10 clients,
    PaperCNN's leaves, D = 595,914), also against the host draw.  Each is
    timed beside its plain version, ``torch.rand`` / ``torch.randn`` of the
    same shape and its bound: the operations of the rounds' rotations and
    xors on the INT32 units, or the bytes written."""
    import numpy as np

    from repro_torch import random as prng
    from repro_torch.fl.baselines import QuantizedFL
    from repro_torch.kernels import threefry as ktf
    from repro_torch.models import PaperCNN

    for name, a in ktf.kernel_attributes().items():
        print(f"  threefry {name} plan: {a['threads']} threads a block, {a['items']} counts a "
              f"thread, {a['registers']} registers, {a['local_bytes']} B local memory, "
              f"{a['blocks_per_sm']} resident blocks per SM (occupancy query)")
        if a["local_bytes"]:
            fail(f"threefry {name}: {a['local_bytes']} B of local memory")
    for name, ops in sass_census("threefry").items():
        alu = {op: ops[op] for op in ("SHF", "LOP3", "IADD3", "IMAD") if ops[op]}
        print(f"  SASS of {name}: {sum(ops.values())} instructions, integer "
              + ", ".join(f"{op} {n}" for op, n in alu.items())
              + f" ({sum(alu.values()) / ktf.ITEMS:.1f} a draw over its {ktf.ITEMS} unrolled "
              f"draws, every path counted); the bound counts the {THREEFRY_INT_OPS} a draw that "
              f"only the INT32 units run")
    for words in [(0, 0), (0, 1), (0xFFFFFFFF, 0xFFFFFFFF), (0x1BD11BDA, 7)]:
        key = np.array(words, np.uint32)
        for n in (1, 255, 1025, 4097, (1 << 20) + 3):
            check_bitwise(f"threefry normal key {words} n={n}", ktf.normal_cuda(key, n),
                          ktf.normal_plain(key, n, device="cuda"), torch)
    print("  threefry normal: bitwise its plain version at 4 edge keys x n = 1, 255, 1025, "
          "4097, 2^20 + 3")
    i64 = dict(dtype=torch.int64, device="cuda")
    for sizes in [(1,), (7, 3, 0, 129, 1), (1,) * 300 + (2000,), (0, 1025, 0, 0, 3)]:
        offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), **i64)
        for p in (1, 10):
            args = (7, torch.tensor(5, **i64), torch.arange(3, 3 + 7 * p, 7, **i64), offsets,
                    int(offsets[-1]))
            check_bitwise(f"threefry rounding leaves {sizes[:6]} P={p}",
                          ktf.rounding_uniforms_cuda(*args), ktf.rounding_uniforms_plain(*args),
                          torch)
    print("  threefry rounding uniforms: bitwise its plain version at 4 leaf layouts (zero-size "
          "leaves, 301 leaves in a block) x P = 1, 10")

    rows = {}
    sizes = [p.numel() for p in PaperCNN(side=32, channels=3, num_classes=10,
                                         num_fc=3).init(0, "cpu").values()]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    d, p = int(offsets[-1]), K_MAIN
    ids = np.arange(0, 100, 10)
    args = (0, torch.tensor(3, **i64), torch.tensor(ids, **i64), torch.tensor(offsets, **i64), d)
    got = ktf.rounding_uniforms_cuda(*args)
    check_bitwise("threefry rounding main", got, ktf.rounding_uniforms_plain(*args), torch)
    check_bitwise("threefry rounding main against the host", got.cpu(),
                  torch.from_numpy(QuantizedFL(100, p, 2, seed=0).rounding_uniforms(3, ids, offsets)),
                  torch)

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / bandwidth, ops / INT32_PEAK_OPS
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    b_ms, b_by = bound(4 * p * d + 8 * (1 + p + len(offsets)), THREEFRY_INT_OPS * p * d)
    rows["threefry_rounding"] = dict(
        name="threefry_rounding", route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
        replaces="src/repro/fl/baselines/quantized.py:77", max_abs_err=0.0,
        ms=timer(lambda: ktf.rounding_uniforms_cuda(*args)),
        plain_ms=timer(lambda: ktf.rounding_uniforms_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer(lambda: torch.rand(p, d, device="cuda")),
        shape=f"P={p} D={d} ({len(sizes)} leaves), grid {ktf.grid_blocks(d)} x {p} blocks")
    n = 1 << 24
    key = prng.split(prng.PRNGKey(0))[1]
    check_bitwise(f"threefry normal n={n}", ktf.normal_cuda(key, n),
                  ktf.normal_plain(key, n, device="cuda"), torch)
    b_ms, b_by = bound(4 * n, THREEFRY_INT_OPS * n)
    rows["threefry_normal"] = dict(
        name="threefry_normal", route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
        replaces="src/repro/models/layers.py:21", max_abs_err=0.0,
        ms=timer(lambda: ktf.normal_cuda(key, n)),
        plain_ms=timer(lambda: ktf.normal_plain(key, n, device="cuda")),
        bound_ms=b_ms, bound_by=b_by, library_ms=timer(lambda: torch.randn(n, device="cuda")),
        shape=f"n={n}, grid {ktf.grid_blocks(n)} blocks")
    for r in rows.values():
        print(f"  {r['name']:<18} {r['shape']}: bitwise; kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  torch.{'rand' if 'rounding' in r['name'] else 'randn'} "
              f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  -> "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    torch.cuda.empty_cache()
    return rows


def launch_plans(torch, kgram, ktopk, u) -> None:
    """The planned grids of gram, cross_gram and topk_mask_rows at the main
    shape (gram at P = 30 too), and profiled gram calls at P = 10 and 30 and
    a cross_gram call, each of which must be one kernel launch."""
    from torch.profiler import ProfilerActivity, profile

    g = kgram.gram_plan(u)
    print(f"  gram plan P={u.shape[0]}: {g.n_splits} blocks of {kgram.TRI_THREADS} threads taking "
          f"the {kgram.TRI_SLAB}-column slabs in turn, tile {g.tile} rows, on {g.sms} SMs "
          f"x {g.blocks_per_sm} resident blocks (occupancy query), {g.registers} registers")
    v = torch.randn(Q_MAIN, u.shape[1], device="cuda")
    u30 = torch.randn(30, u.shape[1], device="cuda")
    print(f"  cross_gram plan K={u.shape[0]} Q={Q_MAIN}: {cross_plan_line(kgram.cross_plan(u, v))}")
    print(f"  gram plan P=30 (the ring kernel, u = v): "
          f"{cross_plan_line(kgram.cross_plan(u30, u30))}")
    t = ktopk.launch_plan(u, torch.empty_like(u), ktopk.DEFAULT_BLOCK_D)
    print(f"  topk_mask_rows plan P={u.shape[0]}: {t.grid} blocks of {ktopk.THREADS} threads "
          f"walking {t.n_tiles} tiles ({t.n_tiles / t.grid:.2f} a block), {t.items} elements a "
          f"thread, {t.vec} floats a load, on {t.sms} SMs x {t.blocks_per_sm} resident blocks "
          f"(occupancy query), {t.registers} registers")
    for label, call, want in ((f"gram at P={u.shape[0]}", lambda: kgram.gram_cuda(u), GRAM_KERNEL),
                              ("gram at P=30", lambda: kgram.gram_cuda(u30), CROSS_KERNEL),
                              (f"cross_gram at K={u.shape[0]} Q={Q_MAIN}",
                               lambda: kgram.cross_gram_cuda(u, v), CROSS_KERNEL)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        print(f"  one {label} call under the profiler: {len(kernels)} kernel launch "
              f"({', '.join(n[:80] for n in kernels)})")
        if len(kernels) != 1 or want not in kernels[0]:
            fail(f"{label}: kernels {kernels}, want one {want}")
    del v, u30


def cifar_federation(torch) -> tuple:
    """Phase 2's federation: the paper's CIFAR-10 model (``init(0)`` on the
    card) and 100 clients of ``make_image_like``: ``(ds, model, params)``."""
    from repro_torch.data import make_image_like
    from repro_torch.models import PaperCNN

    ds = make_image_like(num_clients=100, alpha=0.1, num_samples=40_000, num_eval=4_000,
                         side=32, channels=3, num_classes=10, seed=0)
    model = PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    params = model.init(0, "cuda")
    dim = sum(p.numel() for p in params.values())
    if dim != D_MAIN:
        fail(f"PaperCNN CIFAR flat dim {dim} != {D_MAIN}")
    return ds, model, params


def main_path(torch) -> dict:
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ds, model, params = cifar_federation(torch)
    dim = D_MAIN
    strategy = FLrce(100, 10, local_epochs=2, dim=dim, es_threshold=5.0, explore_decay=0.5, seed=0)
    u0 = capture_round0(strategy)
    ingest_s: list = []
    timed_ingest(strategy, torch, ingest_s)
    print(f"  data + model set-up: {time.perf_counter() - t0:.1f} s (M=100, N=40000, D={dim})")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_federated(model, ds, strategy, max_rounds=6, learning_rate=MAIN_LR, batch_size=32,
                        seed=0, init_params=params, verbose=True, torch_device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    rounds = res.rounds_run
    exploit_rounds = sum(r.exploited for r in res.records)
    print(f"  {rounds} rounds in {wall:.2f} s; per-round wall "
          + ", ".join(f"{r.wall_s:.3f}" for r in res.records) + " s")
    print(f"  summary {json.dumps(res.summary())}")
    print(f"  selections {[r.selected for r in res.records]}")
    print(f"  exploited {[r.exploited for r in res.records]}; launches {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; ingest "
          f"(synchronised) " + ", ".join(f"{1e3 * x:.2f}" for x in ingest_s)
          + f" ms, median {1e3 * median(ingest_s):.2f} ms")
    check_launches("main path", launches, res)
    if exploit_rounds == 0:
        fail(f"no exploit round in {rounds} rounds: gram never ran")
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
            fail(f"round {r.t}: non-finite accuracy/loss")
        if len(r.selected) != 10 or len(set(r.selected)) != 10:
            fail(f"round {r.t}: bad selection {r.selected}")
    for name, p in res.final_params.items():
        if not torch.isfinite(p).all():
            fail(f"final params {name} not finite")
    state = strategy.server.state
    if tuple(state.updates.shape) != (100, D_MAIN) or not torch.isfinite(state.omega).all():
        fail("server state has the wrong shape or non-finite relationship map")
    if rounds != 6 and not res.stopped_early:
        fail(f"ran {rounds} rounds without stopping")
    ingest_breakdown(torch, Timer(torch), state)
    return launches, (ds, model, params, median(r.wall_s for r in res.records[1:])), (res, u0["u"])


def capture_round0(strategy) -> dict:
    """Keep a copy of round 0's (P, D) update matrix and (D,) model as
    post_round gets them."""
    captured: dict = {}
    inner = strategy.post_round

    def post_round(t, w_before, ids, update_matrix, stats):
        if t == 0:
            captured["u"] = update_matrix.detach().clone()
            captured["w"] = w_before.detach().clone()
        return inner(t, w_before, ids, update_matrix, stats)

    strategy.post_round = post_round
    return captured


def check_launches(label, launches, res) -> None:
    """FLrce's kernels on its path: cross_gram twice and weighted_aggregate
    once a round, gram once per exploit round, nothing else."""
    rounds, exploit = res.rounds_run, sum(r.exploited for r in res.records)
    want = {"cross_gram": 2 * rounds, "gram": exploit, "weighted_aggregate": rounds,
            "topk_mask_rows": 0, "decode_attention": 0, "threefry_normal": 0,
            "threefry_rounding": 0}
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def sequential_phase(torch, ds, model, params, batched, u_batched) -> None:
    """Phase 2c: the sequential engine at full width against phase 2's first
    two rounds (same params, seed and strategy settings)."""
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops

    rounds = 2
    strategy = FLrce(100, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0, explore_decay=0.5,
                     seed=0)
    u0 = capture_round0(strategy)
    ops.reset_launch_counts()
    res = run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR,
                        batch_size=32, seed=0, init_params=params, torch_device="cuda",
                        engine="sequential")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches("sequential engine", launches, res)
    print(f"  sequential per-round wall " + ", ".join(f"{r.wall_s:.3f}" for r in res.records)
          + " s; batched (phase 2) " + ", ".join(f"{r.wall_s:.3f}" for r in batched.records[:rounds])
          + f" s; launches {launches}")
    for a, b in zip(res.records, batched.records):
        if (a.selected, a.exploited, a.stopped) != (b.selected, b.exploited, b.stopped):
            fail(f"sequential round {a.t}: selection/flags {a.selected, a.exploited} != "
                 f"batched {b.selected, b.exploited}")
        if abs(a.accuracy - b.accuracy) > 2e-3 or (a.energy_kj, a.bytes_gb) != (b.energy_kj, b.bytes_gb):
            fail(f"sequential round {a.t}: accuracy {a.accuracy} vs {b.accuracy} or ledger differs")
    first = first_step_updates(torch, ds, model, params, batched.records[0].selected)
    err1, tol1, _ = update_gap(torch, *first)
    if err1 > 0 or not bool(torch.isfinite(first[0]).all()):
        fail(f"sequential first local step: max |Δ| beyond the reference's tolerance by {err1:.3e}")
    seq, bat = u0["u"], u_batched
    if seq.shape != bat.shape or not bool(torch.isfinite(seq).all()):
        fail(f"sequential round 0 update matrix: shape {tuple(seq.shape)} or non-finite values")
    _, err, n_beyond = update_gap(torch, seq, bat)
    ratios = torch.linalg.vector_norm(seq - bat, dim=1) / torch.linalg.vector_norm(bat, dim=1)
    if float(ratios.max()) > ROUND_NORM_RTOL:
        fail(f"sequential round 0 update matrix: ‖ΔU_k‖/‖U_k‖ up to {float(ratios.max()):.3e} "
             f"> {ROUND_NORM_RTOL:.0e}")
    print(f"  sequential == batched over {rounds} rounds: selections "
          f"{[r.selected for r in res.records]}, accuracy {[round(r.accuracy, 4) for r in res.records]}"
          f" vs {[round(r.accuracy, 4) for r in batched.records[:rounds]]}")
    print(f"  first local step of round 0's cohort: max |Δ| {tol1:.3e}, within atol "
          f"max(1e-5, 1e-4·max|U|) + rtol 1e-3; round 0 (P, D) after every step: "
          f"‖ΔU_k‖/‖U_k‖ ≤ {float(ratios.max()):.3e}, max |Δ| {err:.3e} (max|U| "
          f"{float(bat.abs().max()):.3e}), {n_beyond} of {seq.numel()} elements beyond that tolerance")


# Round 0's full update matrices of the two engines: over 20-42 local SGD
# steps the engines, which sum in other orders (a batched product over the
# cohort, padded partial batches), part past the reference's elementwise
# tolerance through ReLU and max-pool switches (``--numerics`` on the card:
# none beyond it after 4 steps, 7,845 of 5,959,140 elements after 8, 23,606
# after the whole round).  The first local step is held to that tolerance;
# the whole round to each client's relative norm.  Sound engines read
# ‖ΔU_k‖/‖U_k‖ ≤ 3.6e-3 after the round (4.5e-3 at most after 16 steps);
# ``--numerics``'s planted faults read 0.13 (the learning rate 1% high),
# 0.88 (a partial batch weighted as a full one) and 1.0 (partial batches
# dropped).
ROUND_NORM_RTOL = 1e-2


def update_gap(torch, got, want) -> tuple:
    """(largest excess over the reference's engine tolerance, max |Δ|, count
    beyond it): atol max(1e-5, 1e-4·max|U|), rtol 1e-3
    (``tests/test_batched_engine.py``)."""
    atol = max(1e-5, 1e-4 * float(want.abs().max()))
    err = (got - want).abs()
    excess = err - (atol + 1e-3 * want.abs())
    return max(0.0, float(excess.max())), float(err.max()), int((excess > 0).sum())


class PlanOrder:
    """A stand-in for the sequential trainer's generator whose permutation
    keeps the order, so that it takes a batch in the order the batched
    engine's plan holds it (a batch-routed MoE fills expert capacity in
    token order)."""

    @staticmethod
    def permutation(n):
        import numpy as np

        return np.arange(n)


def first_batch_plan(ds, ids, batch: int, epochs: int):
    """Round 0's cohort plan of clients ``ids`` (``build_cohort_plan``, as
    the run draws it)."""
    from repro_torch.fl.client import build_cohort_plan, client_batch_rng

    return build_cohort_plan([ds.client_data(c) for c in ids], [epochs] * len(ids), batch,
                             [client_batch_rng(0, 0, c) for c in ids])


def first_step_updates(torch, ds, model, params, ids, lr=MAIN_LR, batch=32, epochs=2,
                       batched=None, in_order=False) -> tuple:
    """Each client's update after its first batch of round 0, from the
    sequential trainer and from the batched trainer (same batches; with
    ``in_order`` in the same order too).  ``batched``: the batched engine's
    round-0 update rows where a client's round is that one batch, which the
    run has already made."""
    import dataclasses

    import numpy as np

    from repro_torch.core.distributed import flatten_params
    from repro_torch.fl.client import BatchedCohortTrainer, ClientTrainer

    plan = first_batch_plan(ds, ids, batch, epochs)
    one = dataclasses.replace(plan, x=plan.x[:, :1], y=plan.y[:, :1],
                              sample_w=plan.sample_w[:, :1], step_valid=plan.step_valid[:, :1])
    if batched is None:
        batched, _ = BatchedCohortTrainer(model, lr, batch, "cuda").train_cohort(
            params, one, prox_mus=[0.0] * len(ids), masks=[None] * len(ids),
            freeze_fracs=[0.0] * len(ids))
    elif int(plan.step_valid.sum(1).max()) != 1:
        fail(f"first_step_updates: a client's round has {int(plan.step_valid.sum(1).max())} "
             "batches, so its update rows are not the first batch's")
    trainer, rows = ClientTrainer(model, lr, batch, "cuda"), []
    for k in range(len(ids)):
        n = int(plan.sample_w[k, 0].sum())
        upd, _ = trainer.local_update(params, plan.x[k, 0, :n], plan.y[k, 0, :n], 1,
                                      PlanOrder() if in_order else np.random.default_rng(0))
        rows.append(flatten_params(upd)[0])
    return torch.stack(rows), batched


FLEET_M, FLEET_SAMPLES, FLEET_ROUNDS = 1000, 250_000, 4


def timed_ingest(strategy, torch, times: list) -> None:
    """Time the server's ingest (synchronised on both sides) each round."""
    inner_bind = strategy.bind_device

    def bind_device(device):
        inner_bind(device)
        server = strategy.server
        inner = server.ingest

        def ingest(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)

        server.ingest = ingest

    strategy.bind_device = bind_device


def expanded_block(ids, u, w, v, a, last, t, om):
    """Eq. 5/6 rows from the reference's nine dot groups, with ‖w − a_j‖²
    expanded as ww − 2aw + aa: the port's refresh before it formed r = w − a,
    kept as the yardstick of ``--numerics`` and of the ingest breakdown."""
    from repro_torch.core import relationship
    from repro_torch.kernels import ops

    uv, ua = ops.cross_gram(u, v), ops.cross_gram(u, a)
    uw, vw, aw = u @ w, v @ w, a @ w
    vv, av, aa, ww = (v * v).sum(1), (a * v).sum(1), (a * a).sum(1), w @ w
    dots = (uv, uw[:, None] - ua, vv, vw - av, ww - 2.0 * aw + aa)
    return relationship.rows_from_relationship_dots(ids, dots, last, t, om)


def ingest_breakdown(torch, timer, st) -> None:
    """Device time of each piece of one relationship refresh against the
    exact (M, D) maps of a finished run (its last cohort's rows as the fresh
    ones), under phase 1's timer, and of the same refresh from the
    reference's nine dot groups."""
    from repro_torch.core import relationship
    from repro_torch.kernels import ops

    ids = torch.nonzero(st.last_round == st.last_round.max()).flatten()
    u, w = st.updates[ids].clone(), st.anchors[ids[0]].clone()
    r = w[None, :] - st.anchors
    parts = [
        ("r = w - A", lambda: w[None, :] - st.anchors),
        ("cross_gram(u, V)", lambda: ops.cross_gram(u, st.updates)),
        ("cross_gram(u, r)", lambda: ops.cross_gram(u, r)),
        ("‖v‖² (vector_norm)", lambda: torch.linalg.vector_norm(st.updates, dim=1).square()),
        ("⟨r, v⟩ (row sum of r·v)", lambda: (r * st.updates).sum(1)),
        ("‖r‖² (vector_norm)", lambda: torch.linalg.vector_norm(r, dim=1).square()),
        ("whole refresh", lambda: relationship.relationship_block(
            ids, u, w, st.updates, st.anchors, st.last_round, st.t, st.omega[ids])),
        ("whole refresh from the nine groups (ww - 2aw + aa)", lambda: expanded_block(
            ids, u, w, st.updates, st.anchors, st.last_round, st.t, st.omega[ids])),
    ]
    times = [(label, timer(fn, iters=5, warmup=1)) for label, fn in parts]
    del r
    print(f"  one exact relationship refresh at M={st.omega.shape[0]} (CUDA events, median of 5): "
          + ", ".join(f"{label} {ms:.3f} ms" for label, ms in times))


def fleet_data():
    """Phase 2d's 1,000-client federation (host numpy, 3.07 GB)."""
    from repro_torch.data import make_image_like

    return make_image_like(num_clients=FLEET_M, alpha=0.1, num_samples=FLEET_SAMPLES,
                           num_eval=4_000, side=32, channels=3, num_classes=10, seed=0)


def save_dataset(ds, path: str) -> None:
    """A FederatedDataset's arrays in one .npz, written whole before it
    appears under ``path``."""
    import os

    import numpy as np

    sizes = np.asarray([len(ix) for ix in ds.client_indices])
    with open(path + ".part", "wb") as f:
        np.savez(f, x=ds.x, y=ds.y, eval_x=ds.eval_x, eval_y=ds.eval_y,
                 indices=np.concatenate(ds.client_indices), sizes=sizes,
                 num_classes=np.asarray(ds.num_classes))
    os.replace(path + ".part", path)


def load_dataset(path: str):
    import numpy as np

    from repro_torch.data import FederatedDataset

    z = np.load(path)
    bounds = np.cumsum(z["sizes"])[:-1]
    return FederatedDataset(x=z["x"], y=z["y"], client_indices=np.split(z["indices"], bounds),
                            eval_x=z["eval_x"], eval_y=z["eval_y"],
                            num_classes=int(z["num_classes"]))


def fleet_phase(torch, timer, bandwidth, worker) -> None:
    """Phase 2d: FLrce at a 1,000-client fleet, with exact maps, a sketch that
    cannot evict (40 rows, at most 40 clients in 4 rounds) and one that does
    (20 rows); then cross_gram at ingest's fleet shapes.  The federation is
    the CPU worker's (it made it beside the earlier phases)."""
    import numpy as np

    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops
    from repro_torch.models import PaperCNN

    t0 = time.perf_counter()
    ds = load_dataset(worker_file(worker, "fleet.npz"))
    sizes = ds.client_sizes()
    model = PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    params = model.init(0, "cuda")
    print(f"  data (made by the CPU worker, loaded) + model set-up: "
          f"{time.perf_counter() - t0:.1f} s (M={FLEET_M}, "
          f"N={FLEET_SAMPLES}, {ds.x.nbytes / 1e9:.2f} GB of host fp32); client sizes: smallest "
          f"{sizes.min()}, median {float(np.median(sizes))}, largest {sizes.max()}")
    if sizes.min() < 2:
        fail(f"a client of the 1,000-client federation holds {sizes.min()} samples")
    runs = {}
    for label, va_rows in (("exact", None), ("va_rows=40", 40), ("va_rows=20", 20)):
        strategy = FLrce(FLEET_M, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0,
                         explore_decay=0.5, seed=0, va_rows=va_rows)
        ingest_s: list = []
        timed_ingest(strategy, torch, ingest_s)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = run_federated(model, ds, strategy, max_rounds=FLEET_ROUNDS, learning_rate=MAIN_LR,
                            batch_size=32, seed=0, init_params=params, torch_device="cuda")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check_launches(f"M={FLEET_M} {label}", launches, res)
        if not any(r.exploited for r in res.records):
            fail(f"M={FLEET_M} {label}: no exploit round in {res.rounds_run}")
        st = strategy.server.state
        va_bytes = (st.updates.numel() + st.anchors.numel()) * 4
        walls = [r.wall_s for r in res.records]
        print(f"  {label:<10} per-round wall " + ", ".join(f"{w:.3f}" for w in walls)
              + f" s; ingest (synchronised) " + ", ".join(f"{1e3 * w:.2f}" for w in ingest_s)
              + f" ms, median {1e3 * median(ingest_s):.2f} ms = "
              f"{100 * median(ingest_s) / median(walls):.2f}% of the median round; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; V+A "
              f"{va_bytes / 1e9:.3f} GB; launches {launches}")
        print(f"  {label:<10} selections {[r.selected for r in res.records]}, exploited "
              f"{[r.exploited for r in res.records]}, accuracy "
              f"{[round(r.accuracy, 4) for r in res.records]}")
        for r in res.records:
            if len(r.selected) != 10 or len(set(r.selected)) != 10 or \
                    not all(0 <= c < FLEET_M for c in r.selected):
                fail(f"M={FLEET_M} {label} round {r.t}: bad selection {r.selected}")
            if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
                fail(f"M={FLEET_M} {label} round {r.t}: non-finite accuracy/loss")
        if not bool(torch.isfinite(st.omega).all()):
            fail(f"M={FLEET_M} {label}: non-finite relationship map")
        if va_rows is None:
            ingest_breakdown(torch, timer, st)
        runs[label] = (res, st.omega.cpu(), st.last_round.cpu(),
                       None if st.va_slot is None else st.va_slot.cpu())
        # the timing and capture wrappers close over the strategy: collect
        # the cycle so that its maps are freed before the next run
        del strategy, st
        gc.collect()
    exact, omega_exact, _, _ = runs["exact"]
    sketch, omega_sketch, _, _ = runs["va_rows=40"]
    for a, b in zip(sketch.records, exact.records):
        if (a.selected, a.exploited, a.stopped) != (b.selected, b.exploited, b.stopped):
            fail(f"va_rows=40 round {a.t}: {a.selected, a.exploited} != exact {b.selected, b.exploited}")
    if (sketch.rounds_run, sketch.stopped_early) != (exact.rounds_run, exact.stopped_early):
        fail("va_rows=40: stop round differs from the exact maps'")
    d_omega = float((omega_sketch - omega_exact).abs().max())
    if d_omega > 5e-5:
        fail(f"va_rows=40: Ω differs from the exact maps' by {d_omega:.3e} > 5e-5")
    _, _, last20, slot20 = runs["va_rows=20"]
    evicted = int(((last20 >= 0) & (slot20 < 0)).sum())
    if evicted == 0:
        fail("va_rows=20: no client was evicted")
    print(f"  va_rows=40 == exact: selections, exploit flags and stop round equal, max |ΔΩ| "
          f"{d_omega:.3e}; va_rows=20: {evicted} clients evicted, Ω finite")
    del runs, ds, params
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(1)
    for q in (FLEET_M, 40):
        u = torch.randn(K_MAIN, D_MAIN, generator=gen, device="cuda")
        v = torch.randn(q, D_MAIN, generator=gen, device="cuda")
        err, rel, _, _ = check_gram(f"cross_gram Q={q}", kgram.cross_gram_cuda(u, v),
                              kgram.cross_gram_plain(u, v), u, v, torch)
        ms = timer(lambda: kgram.cross_gram_cuda(u, v))
        mm_ms = timer(lambda: torch.mm(u, v.t()))
        nbytes = 4 * (K_MAIN * D_MAIN + q * D_MAIN + K_MAIN * q)
        bound_ms = nbytes / bandwidth * 1e3
        print(f"  cross_gram K={K_MAIN} Q={q} D={D_MAIN}: kernel {ms:.4f} ms, torch.mm {mm_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB / {bandwidth / 1e12:.3f} TB/s) -> "
              f"{100 * bound_ms / ms:.1f}% of bound; max |Δ|/(‖u‖‖v‖) {rel:.2e}")
        del u, v
    torch.cuda.empty_cache()


def profile_phase(torch, ds, model, params, round_wall_s: float, rounds: int = 3) -> None:
    """Where a warm round's time goes: a few more rounds of the main path
    under torch.profiler (the run before has warmed cuDNN and the kernel
    library), device time by kernel and the device's busy time per round.
    The profiler's host overhead inflates its own wall time, so the busy
    share is taken against ``round_wall_s``, the unprofiled run's median
    round after the first."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import FLrce, run_federated

    strategy = FLrce(100, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0, explore_decay=0.5,
                     seed=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR,
                      batch_size=32, seed=1, init_params=params, torch_device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the profiler's raw records: building prof.events()' tree over the
    # rounds' few hundred thousand records took tens of seconds
    import bisect

    events, ops, unfold = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            events.append((e.name(), e.start_ns(), e.duration_ns(), e.linked_correlation_id()))
            continue
        if e.linked_correlation_id() > 0:
            continue           # a runtime call (the launch); it links to its op
        span = (e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
        ops[e.correlation_id()] = span
        if e.name() == "aten::unfold_backward":
            unfold.setdefault(span[0], []).append(span[1:])
    if not events:
        fail("the profiler saw no device activity")
    for spans in unfold.values():
        spans.sort()
    starts = {tid: [sp[0] for sp in spans] for tid, spans in unfold.items()}

    def in_unfold(corr) -> bool:
        """Whether the op that launched a kernel ran inside an
        ``aten::unfold_backward`` (or is one)."""
        if corr not in ops:
            return False
        tid, start, end = ops[corr]
        i = bisect.bisect_right(starts.get(tid, []), start) - 1
        return i >= 0 and unfold[tid][i][1] >= end

    by_name: dict = {}
    unfold_us = 0.0
    for name, start, dur, corr in events:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
        if in_unfold(corr):
            unfold_us += dur / 1e3
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted((e[1] / 1e3, (e[1] + e[2]) / 1e3) for e in events):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    # activities can overlap (their summed time exceeds the union), so the
    # shares below are of the summed device time, and busy is the union
    total_us = sum(by_name.values())
    busy_round_s = busy_us / 1e6 / rounds
    print(f"  {rounds} rounds under the profiler: wall {wall_us / 1e6:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s (summed {total_us / 1e6:.3f} s), "
          f"{len(events)} device activities; busy per round "
          f"{busy_round_s:.3f} s = {100 * busy_round_s / round_wall_s:.1f}% of the unprofiled "
          f"median round ({round_wall_s:.3f} s)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / rounds:9.3f} ms/round  {100 * us / total_us:5.1f}%  {name[:110]}")
    for name in (CROSS_KERNEL, GRAM_KERNEL, "aggregate_kernel"):
        us = sum(t for n, t in by_name.items() if name in n)
        print(f"  {us / 1e3 / rounds:9.3f} ms/round  {100 * us / total_us:5.1f}%  {name} (this port)")
    # vmap has no batching rule for the patch convolution's backward and
    # runs it one client at a time: its device time, with its kernels'
    calls = sum(len(spans) for spans in unfold.values())
    print(f"  {unfold_us / 1e3 / rounds:9.3f} ms/round  {100 * unfold_us / total_us:5.1f}%  "
          f"aten::unfold_backward (vmap's one-client-at-a-time fallback, {calls / rounds:.0f} "
          f"calls a round)")


def run_baseline(torch, name, rounds, ds, model, params, **kw):
    """One full-width baseline job, its launch counts read just after."""
    from repro_torch.fl import baselines, run_federated
    from repro_torch.kernels import ops

    strategy = getattr(baselines, name)(100, 10, 2, seed=0, **kw)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR, batch_size=32,
                        seed=0, init_params=params, torch_device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"cross_gram": 0, "gram": 0, "weighted_aggregate": rounds,
            "topk_mask_rows": rounds if name == "Fedcom" else 0, "decode_attention": 0,
            "threefry_normal": 0, "threefry_rounding": rounds if name == "QuantizedFL" else 0}
    if launches != want:
        fail(f"{name}: launches {launches}, want {want}")
    if res.rounds_run != rounds:
        fail(f"{name}: ran {res.rounds_run} of {rounds} rounds")
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
            fail(f"{name} round {r.t}: non-finite accuracy/loss")
        if len(r.selected) != 10 or len(set(r.selected)) != 10:
            fail(f"{name} round {r.t}: bad selection {r.selected}")
    for pname, prm in res.final_params.items():
        if not torch.isfinite(prm).all():
            fail(f"{name}: final params {pname} not finite")
    summary = {k: v for k, v in res.summary().items() if k != "stopped_early"}
    print(f"  {name:<11} per-round wall " + ", ".join(f"{r.wall_s:.3f}" for r in res.records)
          + f" s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    print(f"  {name:<11} summary {json.dumps(summary)}")
    return res, launches, strategy


def baselines_phase(torch, ds, model, params) -> dict:
    """Every §4.1 baseline at full width; Fedcom is the top-k kernel's path,
    QuantizedFL the rounding uniforms'."""
    import numpy as np

    from repro_torch.kernels import ops

    runs = {}
    for name, rounds, kw in [("Fedcom", 4, dict(keep_frac=0.1)), ("FedAvg", 4, {}),
                             ("Fedprox", 2, {}), ("Dropout", 2, dict(keep_rate=0.5)),
                             ("TimelyFL", 2, {}), ("PyramidFL", 2, {}), ("QuantizedFL", 2, {})]:
        runs[name] = run_baseline(torch, name, rounds, ds, model, params, **kw)
    # QuantizedFL's stochastic-rounding uniforms: one Threefry kernel launch
    # a round; the host draw the CPU loop makes, for comparison
    strategy = runs["QuantizedFL"][2]
    sizes = [p.numel() for p in params.values()]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    ids = np.asarray(runs["QuantizedFL"][0].records[-1].selected)
    dev = dict(dtype=torch.int64, device="cuda")
    args = (strategy.seed, torch.tensor(1, **dev), torch.tensor(ids, **dev),
            torch.tensor(offsets, **dev), int(offsets[-1]))
    kernel_ms = Timer(torch)(lambda: ops.rounding_uniforms(*args))
    got = ops.rounding_uniforms(*args)
    t0 = time.perf_counter()
    unif = strategy.rounding_uniforms(1, ids, offsets)
    draw_s = time.perf_counter() - t0
    check_bitwise("QuantizedFL rounding uniforms, kernel against the host draw", got.cpu(),
                  torch.from_numpy(unif), torch)
    print(f"  QuantizedFL rounding uniforms: {unif.size} draws a round by the Threefry kernel "
          f"in {1e3 * kernel_ms:.1f} µs (CUDA events, one launch), bitwise the host draw, which "
          f"takes {draw_s:.3f} s")

    def steady(name):
        walls = sorted(r.wall_s for r in runs[name][0].records[1:])
        return walls[len(walls) // 2]

    print(f"  steady round wall (median after round 0): Fedcom {steady('Fedcom'):.3f} s, "
          f"FedAvg {steady('FedAvg'):.3f} s")
    return {name: run[1] for name, run in runs.items()}


def reference_runs(dev: str) -> dict:
    """Phase 3's small federations on ``dev`` (the card's kernels, or the
    CPU's plain versions): FLrce, Fedcom and QuantizedFL, then
    ``examples/quickstart.py``'s configuration with and without early
    stopping, from ``init(0)``, by label."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.fl.baselines import Fedcom, QuantizedFL
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, alpha=0.1, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    model = MLPClassifier(10, 4, (16,))
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    runs = {}
    for label, make in (
        ("FLrce", lambda: FLrce(8, 3, 2, dim=dim, es_threshold=10.0, explore_decay=0.5, seed=0)),
        ("Fedcom", lambda: Fedcom(8, 3, 2, seed=0, keep_frac=0.1)),
        # the card's rounding uniforms from the Threefry kernel, the CPU's from the host
        ("QuantizedFL", lambda: QuantizedFL(8, 3, 2, seed=0)),
    ):
        runs[label] = run_federated(model, ds, make(), max_rounds=6, learning_rate=0.1,
                                    batch_size=16, seed=0, init_params=init, torch_device=dev)
    ds = make_federated_classification(num_clients=20, alpha=0.1, num_samples=4000, num_eval=800,
                                       feature_dim=24, num_classes=10, noise=0.8, seed=0)
    model = MLPClassifier(24, 10, (48, 32))
    dim = sum(p.numel() for p in model.init(0, "cpu").values())
    for use_es in (True, False):
        runs[f"quickstart es={use_es}"] = run_federated(
            model, ds, FLrce(20, 5, 2, dim=dim, es_threshold=2.5, explore_decay=0.9,
                             use_early_stopping=use_es, seed=0),
            max_rounds=25, learning_rate=0.08, batch_size=32, seed=0, torch_device=dev)
    return runs


def cpu_half(worker, tag: str):
    """The CPU half of phase ``tag``'s card-against-CPU checks
    (``CPU_HALVES[tag]``), which the CPU worker made beside the earlier
    phases."""
    t0 = time.perf_counter()
    value = worker_result(worker, f"{tag}.pt")
    print(f"  the CPU half: the CPU worker's ({CPU_SIDE_THREADS} threads, beside the earlier "
          f"phases), waited for {time.perf_counter() - t0:.1f} s")
    return value


def reference_check(torch, worker) -> None:
    """The same small federations on the card (kernels) and on the CPU (plain)."""
    card = reference_runs("cuda")
    cpu = cpu_half(worker, "3")
    for label, run in card.items():
        if not label.startswith("quickstart"):
            compare_runs(label, run, cpu[label])
            continue
        use_es = label.endswith("True")
        label = f"quickstart {run.strategy}"
        compare_runs(label, run, cpu[f"quickstart es={use_es}"])
        if run.strategy != ("flrce" if use_es else "flrce_no_es"):
            fail(f"{label}: reports the name {run.strategy}")
        if not use_es and run.rounds_run != 25:
            fail(f"{label}: ran {run.rounds_run} of 25 rounds")
        print(f"  {label}: {run.rounds_run} rounds, stopped early {run.stopped_early}, final "
              f"accuracy GPU {run.final_accuracy:.4f} CPU "
              f"{cpu[f'quickstart es={use_es}'].final_accuracy:.4f}")


def compare_runs(label, a, b) -> None:
    if a.rounds_run != b.rounds_run or a.stopped_early != b.stopped_early:
        fail(f"{label}: GPU and CPU runs differ in length or stop")
    for ra, rb in zip(a.records, b.records):
        same = (ra.selected == rb.selected and ra.exploited == rb.exploited
                and ra.stopped == rb.stopped and ra.energy_kj == rb.energy_kj
                and ra.bytes_gb == rb.bytes_gb)
        if not same:
            fail(f"{label} round {ra.t}: GPU/CPU discrete results differ: {ra} vs {rb}")
        if abs(ra.accuracy - rb.accuracy) > 2e-3 or abs(ra.mean_client_loss - rb.mean_client_loss) > 1e-4:
            fail(f"{label} round {ra.t}: GPU/CPU accuracy or loss differ: {ra} vs {rb}")
    print(f"  small {label} federation GPU == CPU over {a.rounds_run} rounds: selections "
          f"{[r.selected for r in a.records]}, exploited {[r.exploited for r in a.records]}")


# ---------------------------------------------------------------------------
# phase 2e: the compiled round driver (driver="scan")
# ---------------------------------------------------------------------------
SCAN_ROUNDS, SCAN_CHUNK = 4, 2
SCAN_BASELINE_ROUNDS = 2     # FedAvg, Fedcom, QuantizedFL (2e), FedAvg and Fedprox (2f)
# the kernel whose launches stand for a wrapper's call under the profiler
# (each is one kernel; at P = 10, gram takes the triangle kernel)
PROFILED_KERNEL = {"cross_gram": CROSS_KERNEL, "gram": GRAM_KERNEL,
                   "weighted_aggregate": "aggregate_kernel", "topk_mask_rows": TOPK_KERNEL,
                   "threefry_rounding": "threefry_rounding_kernel"}


def device_busy(prof) -> tuple:
    """(busy µs as the union of the device's activities, their number,
    launches by the kernel names of ``PROFILED_KERNEL``), from the
    profiler's raw records
    (a chunk replays tens of thousands of kernels: building the event tree
    of ``prof.events()`` over them took minutes)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, names = [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        start = e.start_ns()
        spans.append((start, start + e.duration_ns()))
        names[e.name()] += 1
    counts = {k: sum(n for name, n in names.items() if kernel in name)
              for k, kernel in PROFILED_KERNEL.items()}
    busy_ns, last_end = 0, float("-inf")
    for start, end in sorted(spans):
        busy_ns += max(0, end - max(start, last_end))
        last_end = max(last_end, end)
    return busy_ns / 1e3, len(spans), counts


def scan_run(torch, label, ds, model, params, make, rounds, **kw):
    """One driver="scan" job under a device-only torch.profiler, checked: one
    capture per key, one host sync per chunk, each kernel launched in the
    replays as the strategy's round launches it, the profiler's kernel
    counts at least the replays' and at most those plus the warm-up rounds'.
    A ``gram`` that ran as the cross kernel (an async job's (B·P, D) arrival
    buffer above 16 rows), as its wrapper tells, is counted there by the
    profiler.  Returns ``(result, strategy, (launches, profiled))``: the
    wrappers' launch counts, reset just before the run and read just after,
    and the profiler's counts of the kernels' device runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import run_federated
    from repro_torch.kernels import gram as gram_kernels
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    strategy = make()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR,
                            batch_size=32, seed=0, init_params=params, driver="scan",
                            torch_device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stop_s = time.perf_counter() - t0 - wall
    launches = ops.launch_counts()
    via_cross = gram_kernels.GRAM_VIA_CROSS
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    busy_us, n_activities, prof_counts = device_busy(prof)
    read_s = time.perf_counter() - t1
    st = res.driver_stats
    n = st["replays"]
    flrce = strategy.name.startswith("flrce")
    want = {"cross_gram": 2 * n if flrce else 0, "gram": n if flrce else 0,
            "weighted_aggregate": n, "topk_mask_rows": n if strategy.name == "fedcom" else 0,
            "decode_attention": 0, "threefry_normal": 0,
            "threefry_rounding": n if strategy.name == "quantized8" else 0}
    if st["replay_launches"] != want:
        fail(f"{label}: launches in the replays {st['replay_launches']}, want {want}")
    if st["captures_chunk"] != st["programs"] or st["captures_chunk"] < 1:
        fail(f"{label}: {st['captures_chunk']} captures for {st['programs']} keys")
    if st["host_syncs"] != st["chunks"]:
        fail(f"{label}: {st['host_syncs']} host syncs in {st['chunks']} chunks")
    # the profiler sees each replayed kernel; one of the warm-up round's
    # eager launches has been seen missing from its records
    if via_cross not in (0, launches["gram"]):
        fail(f"{label}: {via_cross} of {launches['gram']} gram launches took the cross kernel")
    routed = {}
    for key in ("replay_launches", "warmup_launches"):
        routed[key] = dict(st[key])
        if via_cross:
            routed[key]["cross_gram"] += routed[key]["gram"]
            routed[key]["gram"] = 0
    for k in PROFILED_KERNEL:
        lo = routed["replay_launches"][k]
        hi = lo + routed["warmup_launches"][k]
        if not lo <= prof_counts[k] <= hi:
            fail(f"{label}: the profiler counted {prof_counts[k]} {PROFILED_KERNEL[k]} launches; "
                 f"the replays launched {lo}, and the warm-up rounds {hi - lo}")
    walls = [r.wall_s for r in res.records]
    steps = st["steps"]
    print(f"  {label}: {res.rounds_run} rounds in {st['chunks']} chunks, {wall:.2f} s; "
          f"captures {st['captures_chunk']}, replays {n}, host syncs per chunk "
          f"{st['host_syncs'] / st['chunks']:.0f}; per-round wall (chunk wall / R) "
          + ", ".join(f"{x:.3f}" for x in walls) + " s")
    print(f"  {label}: device busy {busy_us / 1e6:.3f} s of {wall:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}%, device-only profiler; {n_activities} device "
          f"activities, {n_activities / (n + st['captures_chunk']):.0f} a round; the profiler "
          f"stopped in {stop_s:.2f} s and its records were read in {read_s:.2f} s); capture "
          f"(warm-up round "
          f"and capture) {st['capture_s']:.3f} s, build and dispatch {st['host_build_s']:.3f} s, device wait {st['device_wait_s']:.3f} s, flush "
          f"{st['host_flush_s']:.3f} s; launches in the replays {st['replay_launches']}, "
          f"in the warm-up rounds {st['warmup_launches']}, by the profiler {prof_counts}"
          + (" (gram ran as the cross kernel: the profiler counts it under cross_gram)"
             if via_cross else ""))
    print(f"  {label}: store {st['store_bytes_device'] / 2**30:.2f} GiB on the device, "
          f"{st['store_bytes_host'] / 2**30:.2f} GiB on the host; H2D page "
          f"{st['page_bytes_h2d'] / 2**20:.1f} MiB, schedules {st['schedule_bytes_host'] / 2**20:.1f} "
          f"MiB, all staged {st['h2d_bytes'] / 2**20:.1f} MiB; peak device memory "
          f"{peak / 2**30:.2f} GiB; local steps per round real/run "
          + ", ".join(f"{a}/{b}" for a, b in steps))
    return res, strategy, (launches, prof_counts)


def compare_scan(label, loop, scan, torch, bitwise: bool = False, against: str = "loop") -> None:
    """A scan run against the loop run (or another ``against`` run) from the
    same params: discrete results and ledger equal, accuracy within 2e-3;
    with ``bitwise``, accuracies, losses and final params equal."""
    if (loop.rounds_run, loop.stopped_early) != (scan.rounds_run, scan.stopped_early):
        fail(f"{label}: loop ran {loop.rounds_run} rounds (stop {loop.stopped_early}), scan "
             f"{scan.rounds_run} (stop {scan.stopped_early})")
    acc_gap = loss_gap = 0.0
    for a, b in zip(loop.records, scan.records):
        if (a.selected, a.exploited, a.stopped, a.evaluated, a.energy_kj, a.bytes_gb) != \
                (b.selected, b.exploited, b.stopped, b.evaluated, b.energy_kj, b.bytes_gb):
            fail(f"{label} round {a.t}: loop and scan differ: {a} vs {b}")
        acc_gap = max(acc_gap, abs(a.accuracy - b.accuracy))
        loss_gap = max(loss_gap, abs(a.mean_client_loss - b.mean_client_loss))
        if not (math.isfinite(b.accuracy) and math.isfinite(b.mean_client_loss)):
            fail(f"{label} round {a.t}: non-finite accuracy/loss")
    if acc_gap > 2e-3:
        fail(f"{label}: accuracy {acc_gap:.2e} from the loop's")
    param_gap = max(float((loop.final_params[k] - scan.final_params[k].to(
        loop.final_params[k].device)).abs().max()) for k in loop.final_params)
    if bitwise and (acc_gap or loss_gap or any(
            not torch.equal(loop.final_params[k], scan.final_params[k])
            for k in loop.final_params)):
        fail(f"{label}: not bitwise the {against} (accuracy {acc_gap:.2e}, loss "
             f"{loss_gap:.2e}, params {param_gap:.3e})")
    print(f"  {label} == {against} over {scan.rounds_run} rounds: selections "
          f"{[r.selected for r in scan.records][:3]}..., exploited "
          f"{[r.exploited for r in scan.records]}; max |Δ| accuracy {acc_gap:.2e}, loss "
          f"{loss_gap:.2e}, final params {param_gap:.3e}")


def scan_phase(torch, ds, model, params) -> dict:
    """Phase 2e: FLrce through driver="scan" in four configurations, then
    FedAvg and Fedcom, each against the loop driver from the same params;
    then the quick BenchConfig federation on both drivers.  Returns its scan
    runs by label, ``(result, strategy)``."""
    from repro_torch.fl import FLrce, baselines, run_federated

    def flrce(**kw):
        return lambda: FLrce(100, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0,
                             explore_decay=0.5, seed=0, **kw)

    loop_kw = dict(learning_rate=MAIN_LR, batch_size=32, seed=0, init_params=params,
                   torch_device="cuda")
    t0 = time.perf_counter()
    loop = run_federated(model, ds, flrce()(), max_rounds=SCAN_ROUNDS, **loop_kw)
    torch.cuda.synchronize()
    print(f"  loop FLrce: {loop.rounds_run} rounds in {time.perf_counter() - t0:.2f} s; per-round "
          "wall " + ", ".join(f"{r.wall_s:.3f}" for r in loop.records) + " s")
    graph, done = None, {}
    for label, kw in (("resident pipelined", dict(client_store="resident", pipeline=True)),
                      ("resident serial", dict(client_store="resident", pipeline=False)),
                      ("paged", dict(client_store="paged"))):
        res, strat, _ = scan_run(torch, f"FLrce {label}", ds, model, params, flrce(),
                                 SCAN_ROUNDS, scan_chunk_rounds=SCAN_CHUNK, **kw)
        compare_scan(f"FLrce {label}", loop, res, torch)
        done[f"FLrce {label}"] = (res, strat)
        graph = graph or res
    strat = flrce()()
    done["FLrce resident pipelined eager"] = (
        eager_chunks(torch, "FLrce resident pipelined", graph, model, ds, strat, SCAN_ROUNDS,
                     MAIN_LR, params, SCAN_CHUNK), strat)
    # a 40-client candidate set: selection within the proposal, so the loop
    # cannot be its yardstick; the paged run must equal the resident one
    # bitwise, and pick only proposed clients
    runs = {}
    for store in ("paged", "resident"):
        runs[store], strat, _ = scan_run(torch, f"FLrce candidates_per_chunk=40 {store}", ds,
                                         model, params, flrce(candidates_per_chunk=40),
                                         SCAN_ROUNDS, scan_chunk_rounds=SCAN_CHUNK,
                                         client_store=store)
        done[f"FLrce candidates_per_chunk=40 {store}"] = (runs[store], strat)
    a, b = runs["paged"], runs["resident"]
    for ra, rb in zip(a.records, b.records):
        if (ra.selected, ra.exploited, ra.stopped, ra.accuracy, ra.mean_client_loss) != \
                (rb.selected, rb.exploited, rb.stopped, rb.accuracy, rb.mean_client_loss):
            fail(f"candidates_per_chunk=40 round {ra.t}: paged {ra} != resident {rb}")
        if len(set(ra.selected)) != 10:
            fail(f"candidates_per_chunk=40 round {ra.t}: bad selection {ra.selected}")
    if a.rounds_run != b.rounds_run or any(
            not torch.equal(a.final_params[k], b.final_params[k]) for k in a.final_params):
        fail("candidates_per_chunk=40: paged and resident final params differ")
    print(f"  FLrce candidates_per_chunk=40: paged == resident bitwise over {a.rounds_run} rounds; "
          f"selections {[r.selected for r in a.records][:3]}...")
    for name, kw in (("FedAvg", {}), ("Fedcom", dict(keep_frac=0.1)), ("QuantizedFL", {})):
        make = lambda: getattr(baselines, name)(100, 10, 2, seed=0, **kw)  # noqa: E731
        loop = run_federated(model, ds, make(), max_rounds=SCAN_BASELINE_ROUNDS, **loop_kw)
        print(f"  loop {name}: per-round wall " + ", ".join(f"{r.wall_s:.3f}" for r in loop.records)
              + " s")
        res, strat, _ = scan_run(torch, f"{name} resident", ds, model, params, make,
                                 SCAN_BASELINE_ROUNDS, scan_chunk_rounds=SCAN_CHUNK)
        # QuantizedFL: the chunk draws the loop's uniforms on the card
        compare_scan(name, loop, res, torch, bitwise=name == "QuantizedFL")
        done[f"{name} resident"] = (res, strat)
    for label, (res, _) in done.items():
        if label.startswith("FLrce"):
            need_exploit(label, res)
    done["quick BenchConfig scan"] = quick_bench(torch)
    return done


def need_exploit(label, res) -> None:
    """An FLrce run cut to ``SCAN_ROUNDS`` must still reach an exploit round,
    where Alg. 3 and ``gram`` run."""
    if not any(r.exploited for r in res.records):
        fail(f"{label}: no exploit round in {res.rounds_run} rounds")


def eager_chunks(torch, label, graph, model, ds, strategy, rounds, lr, params, chunk):
    """The same scan job with the round body run eagerly on the card (no
    capture): what the graph saves, and its results equal bitwise.  Returns
    the eager run."""
    from repro_torch.fl.scan_driver import run_scan_driver

    t0 = time.perf_counter()
    eager = run_scan_driver(model, ds, strategy, max_rounds=rounds, learning_rate=lr,
                            batch_size=32, device="jetson_nano", eval_every=1, seed=0,
                            init_params=params, verbose=False, chunk_rounds=chunk,
                            torch_device=torch.device("cuda"), capture=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for a, b in zip(graph.records, eager.records):
        if (a.selected, a.exploited, a.stopped, a.accuracy, a.mean_client_loss) != \
                (b.selected, b.exploited, b.stopped, b.accuracy, b.mean_client_loss):
            fail(f"{label} round {a.t}: graph {a} != eager {b}")
    if graph.rounds_run != eager.rounds_run or any(
            not torch.equal(graph.final_params[k], eager.final_params[k])
            for k in graph.final_params):
        fail(f"{label}: the graph's and the eager chunks' final params differ")
    st = eager.driver_stats
    print(f"  {label} eager chunks (no capture): {eager.rounds_run} rounds in {wall:.2f} s, "
          f"bitwise the graph's; per-round wall " + ", ".join(f"{r.wall_s:.3f}" for r in
                                                             eager.records)
          + f" s; build and dispatch {st['host_build_s']:.3f} s, device wait "
          f"{st['device_wait_s']:.3f} s, host syncs {st['host_syncs']}")
    return eager


def quick_federation():
    """``benchmarks/common.py`` ``BenchConfig`` at its quick scale: (dataset,
    MLP 16→24→10, its D, a maker of its FLrce(M = 30, P = 6, ψ = 3.3))."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=30, alpha=0.1, num_samples=12_000,
                                       num_eval=1_500, feature_dim=16, num_classes=10, noise=1.6,
                                       harmful_fraction=0.2, seed=0)
    model = MLPClassifier(16, 10, (24,))
    dim = sum(p.numel() for p in model.init(0, "cpu").values())
    return ds, model, dim, lambda: FLrce(30, 6, 2, dim=dim, es_threshold=3.3,
                                         explore_decay=0.95, seed=0)


QUICK_EAGER_ROUNDS = 16


def quick_bench(torch) -> tuple:
    """``benchmarks/common.py`` ``BenchConfig`` at its quick scale (MLP
    16→24→10, M = 30, P = 6, T = 50, FLrce ψ = 3.3): the dispatch-bound
    regime, on both drivers.  Returns the scan run and its strategy."""
    from repro_torch.fl import run_federated

    ds, model, dim, make = quick_federation()
    runs, strategies = {}, {}
    for label, kw in (("loop", {}), ("scan", dict(driver="scan", scan_chunk_rounds=8))):
        t0 = time.perf_counter()
        strategies[label] = make()
        runs[label] = run_federated(model, ds, strategies[label], max_rounds=50,
                                    learning_rate=0.1, batch_size=32, seed=0,
                                    torch_device="cuda", **kw)
        torch.cuda.synchronize()
        res = runs[label]
        steady = sorted(r.wall_s for r in res.records[8:]) or [float("nan")]
        print(f"  quick BenchConfig {label}: {res.rounds_run} rounds in "
              f"{time.perf_counter() - t0:.2f} s, steady per-round wall (median after round 8) "
              f"{1e3 * steady[len(steady) // 2]:.2f} ms, stopped early {res.stopped_early}, final "
              f"accuracy {res.final_accuracy:.4f}")
    compare_scan("quick BenchConfig", runs["loop"], runs["scan"], torch)
    # the eager body over the first QUICK_EAGER_ROUNDS rounds (an eager round
    # takes about 0.8 s), against a captured run of as many rounds
    graph = run_federated(model, ds, make(), max_rounds=QUICK_EAGER_ROUNDS, learning_rate=0.1,
                          batch_size=32, seed=0, torch_device="cuda", driver="scan",
                          scan_chunk_rounds=8)
    eager = eager_chunks(torch, "quick BenchConfig", graph, model, ds, make(),
                         QUICK_EAGER_ROUNDS, 0.1, None, 8)
    if not eager.driver_stats["captures_total"] == 0:
        fail("quick BenchConfig eager chunks: a capture was made")
    st = runs["scan"].driver_stats
    print(f"  quick BenchConfig scan: {st['chunks']} chunks, {st['captures_chunk']} captures, "
          f"{st['host_syncs']} host syncs, local steps per round real/run "
          + ", ".join(f"{a}/{b}" for a, b in st["steps"][:8]) + " ...")
    return runs["scan"], strategies["scan"]


# ---------------------------------------------------------------------------
# phase 2f: staleness-aware async rounds (async_rounds=AsyncConfig) in the
# compiled driver
# ---------------------------------------------------------------------------
ASYNC_S, ASYNC_ROUNDS = 2, 8
# the phase's seconds, predicted before its first run on the card (PERF.md §6)
PHASE_2F_PREDICTED_S = (50, 90)


def same_server(label, a, b, torch) -> None:
    """FLrce's written-back state of two runs, bitwise."""
    sa, sb = a.server.state, b.server.state
    for field in ("omega", "heuristic", "updates", "anchors", "last_round"):
        if not torch.equal(getattr(sa, field), getattr(sb, field)):
            fail(f"{label}: the written-back {field} differs")
    if (sa.t, sa.stopped, sa.stop_round, sa.last_conflicts) != \
            (sb.t, sb.stopped, sb.stop_round, sb.last_conflicts):
        fail(f"{label}: the written-back round, stop or conflicts differ")


def departure_ledger(label, model, ds, res, strategy) -> None:
    """The ledger's charges recomputed on the host from every departed
    cohort, in the driver's order: an async run charges at departure."""
    from repro_torch.fl.metrics import ResourceLedger

    want, sizes = ResourceLedger(), ds.client_sizes()
    for rec in res.records:
        for cid in rec.selected:
            cfg = strategy.client_config(rec.t, cid, None)
            want.charge_training(model.flops_per_sample() * int(sizes[cid]) * cfg.epochs
                                 * cfg.compute_fraction)
            want.charge_download(D_MAIN, cfg.download_fraction)
            want.charge_upload(D_MAIN, cfg.upload_fraction)
    got = res.ledger
    if (got.energy_j, got.bytes_up, got.bytes_down) != \
            (want.energy_j, want.bytes_up, want.bytes_down):
        fail(f"{label}: ledger {got.summary()} != the departures' charges {want.summary()}")


def check_arrivals(label, res, s: int) -> None:
    """Every departed update arrived or is pending at exit, and the ledger's
    histogram holds every arrival at a staleness in [0, S]."""
    st, hist = res.driver_stats, res.ledger.arrivals_by_staleness
    departures = sum(len(r.selected) for r in res.records)
    if st["async_arrivals"] + st["async_pending_at_exit"] != departures:
        fail(f"{label}: {st['async_arrivals']} arrived + {st['async_pending_at_exit']} pending "
             f"!= {departures} departed")
    if sum(hist.values()) != st["async_arrivals"] or not all(0 <= tau <= s for tau in hist):
        fail(f"{label}: arrivals by staleness {hist} against {st['async_arrivals']} arrivals")


def quick_async_run(dev: str):
    """The quick BenchConfig at ``max_staleness=ASYNC_S`` on ``dev``, from
    ``init(0)``: phase 2f's card-against-CPU job."""
    from repro_torch.fl import AsyncConfig, run_federated

    qds, qmodel, _, qmake = quick_federation()
    return run_federated(qmodel, qds, qmake(), max_rounds=50, learning_rate=0.1, batch_size=32,
                         seed=0, init_params=qmodel.init(0, "cpu"), driver="scan",
                         scan_chunk_rounds=8, async_rounds=AsyncConfig(max_staleness=ASYNC_S),
                         torch_device=dev)


def async_phase(torch, timer, bandwidth, ds, model, params, scan_runs, worker) -> tuple:
    """Phase 2f: FLrce, FedAvg and Fedprox at max_staleness=0, bitwise their
    synchronous scan runs (phase 2e's where it ran them); FLrce at S = 2 on
    the synthetic trace; the quick BenchConfig at S = 2 on the card against
    the CPU; every scan run's stats against the schema; then the three
    kernels of the async round at its K = (S+1)·P = 30 rows.  Returns the
    kernel rows and the S = 2 run's wrapper launch counts."""
    from repro_torch.core.distributed import flatten_params
    from repro_torch.fl import AsyncConfig, FLrce, baselines, staleness_weights
    from repro_torch.fl.async_rounds import default_decay
    from repro_torch.fl.stats_schema import validate_driver_stats

    t_phase = time.perf_counter()
    print(f"  predicted before its first run: {PHASE_2F_PREDICTED_S[0]}-"
          f"{PHASE_2F_PREDICTED_S[1]} s")

    def flrce():
        return FLrce(100, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0, explore_decay=0.5,
                     seed=0)

    stats = [(label, res.driver_stats) for label, (res, _) in scan_runs.items()]
    for label, make, rounds, pipeline in (
            ("FLrce resident pipelined", flrce, SCAN_ROUNDS, True),
            ("FedAvg resident", lambda: baselines.FedAvg(100, 10, 2, seed=0),
             SCAN_BASELINE_ROUNDS, True),
            ("Fedprox resident serial", lambda: baselines.Fedprox(100, 10, 2, seed=0),
             SCAN_BASELINE_ROUNDS, False)):
        kw = dict(scan_chunk_rounds=SCAN_CHUNK, pipeline=pipeline)
        if label in scan_runs:
            sync, sync_strat = scan_runs[label]          # phase 2e's run of this job
        else:
            sync, sync_strat, _ = scan_run(torch, f"{label} sync", ds, model, params, make,
                                           rounds, **kw)
            stats.append((f"{label} sync", sync.driver_stats))
        asy, strat, _ = scan_run(torch, f"{label} async S=0", ds, model, params, make, rounds,
                                 async_rounds=AsyncConfig(max_staleness=0), **kw)
        stats.append((f"{label} async S=0", asy.driver_stats))
        compare_scan(f"{label} async S=0", sync, asy, torch, bitwise=True,
                     against="synchronous scan run")
        if isinstance(strat, FLrce):
            same_server(f"{label} async S=0", sync_strat, strat, torch)
            need_exploit(f"{label} async S=0", asy)
        st = asy.driver_stats
        if (st["async_pending_at_exit"], st["async_arrivals"], asy.ledger.arrivals_by_staleness) \
                != (0, 10 * asy.rounds_run, {0: 10 * asy.rounds_run}):
            fail(f"{label} async S=0: arrivals {asy.ledger.arrivals_by_staleness}, pending "
                 f"{st['async_pending_at_exit']}")
        if st["replay_launches"] != sync.driver_stats["replay_launches"]:
            fail(f"{label} async S=0: launches {st['replay_launches']} against the synchronous "
                 f"{sync.driver_stats['replay_launches']}")

    s2_cfg = AsyncConfig(max_staleness=ASYNC_S)
    label = f"FLrce async S={ASYNC_S}"
    res, strat, (launches, profiled) = scan_run(torch, label, ds, model, params, flrce,
                                                ASYNC_ROUNDS, scan_chunk_rounds=SCAN_CHUNK,
                                                async_rounds=s2_cfg)
    stats.append((label, res.driver_stats))
    check_arrivals(label, res, ASYNC_S)
    departure_ledger(label, model, ds, res, strat)
    hist = res.ledger.arrivals_by_staleness
    if not any(tau > 0 for tau in hist):
        fail(f"{label}: the synthetic trace delayed nothing ({hist})")
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)) \
                or len(set(r.selected)) != 10:
            fail(f"{label} round {r.t}: non-finite accuracy/loss or bad selection {r.selected}")
    # the wrappers launch each kernel in the warm-up round and record it in
    # the capture; the replays run what was captured without the wrappers
    st = res.driver_stats
    for k in ("cross_gram", "gram", "weighted_aggregate"):
        if launches[k] != 2 * st["warmup_launches"][k] or st["replay_launches"][k] == 0:
            fail(f"{label}: the {k} wrapper launched {launches[k]} times (warm-up and capture: "
                 f"{2 * st['warmup_launches'][k]}), {st['replay_launches'][k]} in the replays")
    sync = scan_runs.get("FLrce resident pipelined", (None,))[0]
    print(f"  {label}: arrivals by staleness {dict(sorted(hist.items()))}, pending at exit "
          f"{res.driver_stats['async_pending_at_exit']}, exploited "
          f"{[r.exploited for r in res.records]}; accuracy "
          + ", ".join(f"{r.accuracy:.4f}" for r in res.records)
          + ("" if sync is None else " (synchronous " + ", ".join(
              f"{r.accuracy:.4f}" for r in sync.records) + ")")
          + f"; wrapper launches (the kernels line's) {launches}; device runs by the profiler "
          f"{profiled}: gram at K = {(ASYNC_S + 1) * 10} runs as the cross kernel, so its "
          "runs are counted under cross_gram")

    # the quick BenchConfig at S = 2: the card against the CPU (the CPU
    # worker's run, made beside the earlier phases)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = (quick_async_run(dev) if dev == "cuda" else
                     cpu_half(worker, "2f"))
        print(f"  quick BenchConfig async S={ASYNC_S} on the {dev}: {runs[dev].rounds_run} rounds "
              f"in {time.perf_counter() - t0:.2f} s, stopped early {runs[dev].stopped_early}, "
              f"arrivals {dict(sorted(runs[dev].ledger.arrivals_by_staleness.items()))}")
    gpu, cpu = runs["cuda"], runs["cpu"]
    stats.append((f"quick BenchConfig async S={ASYNC_S}", gpu.driver_stats))
    compare_scan(f"quick BenchConfig async S={ASYNC_S} card", cpu, gpu, torch, against="CPU")
    check_arrivals("quick BenchConfig async", gpu, ASYNC_S)
    if gpu.ledger.arrivals_by_staleness != cpu.ledger.arrivals_by_staleness or any(
            gpu.driver_stats[k] != cpu.driver_stats[k]
            for k in ("async_arrivals", "async_pending_at_exit")):
        fail("quick BenchConfig async: the card's arrivals differ from the CPU's")
    if (gpu.ledger.energy_j, gpu.ledger.total_bytes) != (cpu.ledger.energy_j,
                                                         cpu.ledger.total_bytes):
        fail("quick BenchConfig async: the card's ledger differs from the CPU's")

    for name, st in stats:
        try:
            validate_driver_stats(st)
        except ValueError as err:
            fail(f"{name}: driver_stats off the schema: {err}")
    print(f"  validate_driver_stats: the stats of {len(stats)} scan runs ({len(scan_runs)} of "
          f"phase 2e) match the schema")

    # the async round's three kernels at K = (S+1)·P rows: the last three
    # cohorts' stored updates, the server's V, the final model, Eq. 4's
    # staleness weights
    state = strat.server.state
    ids = [c for r in res.records[-(ASYNC_S + 1):] for c in r.selected]
    u = state.updates[torch.tensor(ids, device="cuda")].contiguous()
    w = flatten_params(res.final_params)[0].contiguous()
    taus = [tau for tau in range(ASYNC_S, -1, -1) for _ in range(10)]
    weights = torch.from_numpy(staleness_weights(ds.client_sizes()[ids], taus,
                                                 default_decay)).to("cuda")
    rows = fl_kernel_rows(torch, timer, bandwidth, u, state.updates, w, weights, "2f",
                          topk=False)
    print(f"  phase 2f wall {time.perf_counter() - t_phase:.1f} s (predicted "
          f"{PHASE_2F_PREDICTED_S[0]}-{PHASE_2F_PREDICTED_S[1]} s)")
    return rows, launches


# ---------------------------------------------------------------------------
# decode attention and the serving path (gemma3-4b, recurrentgemma-2b)
# ---------------------------------------------------------------------------
# gemma3-4b at serving: 4 KV heads, groups of 2 query heads, head_dim 256
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 1088, 64
SERVE_CACHE = SERVE_PROMPT + SERVE_GEN           # 1152: the 1,024-slot local rings wrap
SERVE_STEPS = SERVE_PROMPT + SERVE_GEN - 1       # 1151 decode steps
# served at 12 of its 34 layers (10 local, whose rings wrap, and 2 global)
# to keep the smoke within its time: the step is host-bound, about 1.4 ms a
# layer
SERVE_LAYERS, SERVE_PARAMS = 12, 1_803_614_720
# recurrentgemma-2b at serving, 11 of its 26 layers (3 cycles of 2 RG-LRU
# blocks and a local attention layer, then the 2 RG-LRU rest layers), cut as
# gemma3-4b is; 2,048-slot rings; 10 query heads over one KV head, head_dim 256
RG_ARCH = "recurrentgemma-2b"
RG_LAYERS = 11
RG_B, RG_PROMPT, RG_GEN = 8, 2112, 64
RG_CACHE = RG_PROMPT + RG_GEN                    # 2176: the rings wrap
RG_STEPS = RG_CACHE - 1                          # 2175 decode steps
RG_WINDOW, RG_GROUP = 2048, 10
RG_ATTN_LAYERS = 3
RG_PARAMS = 1_347_704_320          # the tree init builds (an RG-LRU block has no MLP)
RG_CONFIG_PARAMS = 1_583_592_960   # ArchConfig.param_count(): the reference books one anyway
RG_FP32_B, RG_FP32_POSITIONS = 2, 64
RG_FP32_RTOL = 1e-3        # decode-step logits against forward's on the card, |Δ| / max|logit|:
                           # fp32 through 26 layers, the scan against the step recurrence
DECODE_FP32_RTOL = 1e-5    # |Δ| ≤ 1e-5·max|V|: fp32 sums reordered across splits
                           # (+ half a bf16 ulp for a bf16 output's rounding)
SERVE_LOGIT_RTOL = 1e-4    # GPU vs CPU logits, |Δ| / max|logit|, fp32 end to end
DECODE_KERNEL = "decode_attention_kernel"   # the one kernel a decode_attention call launches
# the kernel of ``torch.cuda._sleep``, launched as a marker in a profile, and
# its cycles (about half a microsecond)
PROFILE_MARK, PROFILE_MARK_CYCLES = "spin_kernel", 1000
DECODE_INSTANCES = 2 * 3 * 8                # fp32/bf16 x hd 64/128/256 x a block's G 1..8
                                            # (groups of 9..16 run as two sub-groups)
GRAM_INSTANCES = 4                          # row tile 4/8/12/16
TOPK_INSTANCES = 1 + 2 + 3 * 3              # (elements a thread, load width): 1 x 1, 2 x 1/2,
                                            # 4/8/16 x 1/2/4
# every kernel the build compiles, by name, and its instance count: the ptxas
# gate fails on a missing or unknown instance, a spill or a stack frame
KERNEL_INSTANCES = {
    DECODE_KERNEL: DECODE_INSTANCES,
    GRAM_KERNEL: GRAM_INSTANCES,
    TOPK_KERNEL: TOPK_INSTANCES,
    "cross_gram_stream_kernel": 3 * 4,      # load width 1/2/4 x U rows 4/8/12/16
    "cross_gram_ring_kernel": 1,            # 8x8 sums a lane
    "aggregate_kernel": 3,                  # load width 1/2/4
    "threefry_normal_kernel": 1,
    "threefry_rounding_kernel": 1,
}

# (label, B, S, K, G, hd, dtype, lengths, window, ring): edge cases
DECODE_EDGES = [
    ("length 1", 3, 700, 4, 2, 256, "bf16", [1, 1, 1], 0, False),
    ("length 0", 3, 333, 2, 2, 256, "fp32", [0, 333, 17], 0, False),
    ("length 0 ring", 2, 100, 2, 2, 256, "bf16", [0, 7], 16, True),
    ("ragged", 4, 1600, 4, 2, 256, "bf16", [1600, 1, 800, 1599], 0, False),
    ("S=1601 not a split multiple", 2, 1601, 4, 2, 256, "bf16", [1601, 1583], 0, False),
    ("non-ring window", 2, 3000, 4, 2, 256, "bf16", [3000, 1500], 1024, False),
    ("fp32", 2, 1600, 4, 2, 256, "fp32", [1600, 999], 0, False),
    ("hd64 G1", 2, 257, 2, 1, 64, "fp32", [257, 100], 0, False),
    ("hd64 G3", 2, 257, 2, 3, 64, "bf16", [257, 3], 0, False),
    ("hd128 G1", 2, 515, 3, 1, 128, "bf16", [515, 514], 0, False),
    ("hd128 G3", 2, 515, 1, 3, 128, "fp32", [515, 1], 0, False),
    ("hd256 G8", 1, 2048, 1, 8, 256, "bf16", [2048], 0, False),
    # groups over 8 (two sub-groups a KV head): recurrentgemma-2b's 10 heads over 1 KV head
    ("G10 length 0 ring", 3, 2048, 1, 10, 256, "bf16", [0, 2175, 7], 2048, True),
    ("G10 ragged", 4, 2176, 1, 10, 256, "bf16", [2176, 1, 1100, 2175], 0, False),
    ("G10 fp32 ring", 3, 2048, 1, 10, 256, "fp32", [2175, 2048, 64], 2048, True),
    ("G10 non-ring window", 2, 3000, 1, 10, 256, "bf16", [3000, 1500], 2048, False),
    ("G10 length 0 one split", 2, 50, 1, 10, 256, "fp32", [0, 50], 0, False),
    ("G9 a dummy head", 2, 515, 2, 9, 128, "bf16", [515, 3], 0, False),
    ("G16 hd64", 2, 1000, 1, 16, 64, "fp32", [1000, 999], 0, False),
]
RG_ROW = "ring@recurrentgemma-2b"   # phase 1's timed shape at recurrentgemma-2b's ring layer
# phase 1's timed shapes at the MoE models' layers: dbrx-132b's global cache
# and mixtral-8x22b's ring at the serve run's last step (160 slots), and
# mixtral's whole 4,096-slot window wrapped
DBRX_ROW, MX_ROW, MX_WRAPPED_ROW = "global@dbrx-132b", "ring@mixtral-8x22b", "wrapped@mixtral-8x22b"
MX_WINDOW, MX_WRAPPED_LENGTH = 4096, 4500
# phase 12's wrapping run: mixtral's first layer alone at full width
MX_WRAPPED_LAYERS, MX_WRAPPED_PARAMS = 1, 2_906_720_256


def decode_inputs(torch, gen, b, s, kv, g, hd, dtype, lengths):
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    q = torch.randn(b, kv * g, hd, generator=gen, device="cuda").to(dt)
    k = torch.empty(b, s, kv, hd, device="cuda", dtype=dt)
    v = torch.empty(b, s, kv, hd, device="cuda", dtype=dt)
    for t in (k, v):   # in slices, so the fp32 draw of a 32k cache stays small
        for i in range(b):
            t[i] = torch.randn(s, kv, hd, generator=gen, device="cuda").to(dt)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def check_decode(name, got, want32, v, torch) -> float:
    """Hold the kernel's output against the plain version's fp32 result before
    any rounding (``want32``, the plain version on fp32 copies of the same
    inputs): |Δ| ≤ 1e-5·max|V| for the fp32 sums taken in another order,
    plus, for a bf16 output, half a bf16 ulp for its rounding.  (Within one
    ulp of the plain version's own bf16 output does not hold near 0, where
    cancellation leaves the fp32 reorder error larger than the ulp.)
    Returns max |Δ|."""
    torch.cuda.synchronize()
    if got.shape != want32.shape or want32.dtype != torch.float32:
        fail(f"{name}: {tuple(got.shape)} != {tuple(want32.shape)} or reference not fp32")
    g = got.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite output")
    err = (g - want32).abs()
    limit = torch.full_like(g, DECODE_FP32_RTOL * float(v.float().abs().max()))
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(g.abs(), want32.abs()).clamp_min(1e-30)
        limit = limit + 0.5 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    if not bool((err <= limit).all()):
        i = int((err - limit).argmax())
        fail(f"{name}: {int((err > limit).sum())} outputs beyond tolerance; worst got "
             f"{float(g.flatten()[i])!r} want {float(want32.flatten()[i])!r}")
    return float(err.max())


def sdpa_call(torch, q, k, v):
    """One PyTorch call computing decode attention over the whole cache
    (lengths = S): scaled_dot_product_attention with enable_gqa, or over K/V
    repeated across the group where the installed torch lacks it."""
    F = torch.nn.functional
    qh = q[:, :, None, :]                               # (B, H, 1, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # (B, K, S, hd) views
    try:
        F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)), \
            "scaled_dot_product_attention(enable_gqa=True)"
    except TypeError:
        group = q.shape[1] // k.shape[2]
        kr = kh.repeat_interleave(group, dim=1)
        vr = vh.repeat_interleave(group, dim=1)
        return (lambda: F.scaled_dot_product_attention(qh, kr, vr)), \
            "scaled_dot_product_attention over K/V repeated across the group"


def decode_kernel_phase(torch, timer, bandwidth) -> dict:
    """decode_attention against its plain version at the serve run's shapes,
    a 32k cache and edge cases; times at the three main shapes."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, b, s, kv, g, hd, dtype, lengths, window, ring in DECODE_EDGES:
        q, k, v, length = decode_inputs(torch, gen, b, s, kv, g, hd, dtype, lengths)
        err = check_decode(f"decode_attention {label}",
                           kdec.decode_attention_cuda(q, k, v, length, window=window, ring=ring),
                           kdec.decode_attention_plain(q.float(), k.float(), v.float(), length,
                                                       window=window, ring=ring), v, torch)
        print(f"  decode_attention edge {label:<28} B={b} S={s:5d} K={kv} G={g} hd={hd} {dtype}: "
              f"max |Δ| {err:.2e}")
    rows = {}
    # (label, B, S, length, window, ring, K, G, hd): gemma3-4b's global layer at
    # the serve run's last step, a local ring layer there, decode_32k's cache
    # (B cut to 16), recurrentgemma-2b's ring layer at phase 4b's last step,
    # and the MoE models' layers at phases 12's and 12b's last step (dbrx's
    # global cache; mixtral's 160-slot ring under its 4,096 window) and
    # mixtral's 4,096-slot ring wrapped
    for label, b, s, length, window, ring, kv, g, hd in (
            ("global", SERVE_B, SERVE_CACHE, SERVE_CACHE, 0, False, 4, 2, 256),
            ("ring", SERVE_B, 1024, SERVE_CACHE, 1024, True, 4, 2, 256),
            ("32k", 16, 32_768, 32_768, 0, False, 4, 2, 256),
            (RG_ROW, RG_B, RG_WINDOW, RG_STEPS, RG_WINDOW, True, 1, RG_GROUP, 256),
            (DBRX_ROW, MOE_B, MOE_CACHE, MOE_CACHE, 0, False, 8, MOE_GROUP, MOE_HEAD_DIM),
            (MX_ROW, MOE_B, MOE_CACHE, MOE_CACHE, MX_WINDOW, True, 8, MOE_GROUP, MOE_HEAD_DIM),
            (MX_WRAPPED_ROW, MOE_B, MX_WINDOW, MX_WRAPPED_LENGTH, MX_WINDOW, True, 8, MOE_GROUP,
             MOE_HEAD_DIM)):
        q, k, v, lens = decode_inputs(torch, gen, b, s, kv, g, hd, "bf16", [length] * b)
        kern = lambda: kdec.decode_attention_cuda(q, k, v, lens, window=window, ring=ring)  # noqa: E731
        plain = lambda: kdec.decode_attention_plain(q, k, v, lens, window=window, ring=ring)  # noqa: E731
        err = check_decode(f"decode_attention {label}", kern(),
                           kdec.decode_attention_plain(q.float(), k.float(), v.float(), lens,
                                                       window=window, ring=ring), v, torch)
        valid = min(length, s)
        nbytes = 2 * b * valid * kv * hd * 2 + 2 * q.numel() * 2   # valid K/V + q + out
        flops = 4 * b * kv * g * valid * hd                         # QKᵀ and PV
        t_bytes, t_ops = nbytes / bandwidth, flops / FP32_PEAK_FLOPS
        lib_fn, lib_name = sdpa_call(torch, q, k, v)
        rows[label] = dict(
            name="decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:86", max_abs_err=err,
            ms=timer(kern), plain_ms=timer(plain),
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=timer(lib_fn), library_name=lib_name,
            shape=f"{label} B={b} S={s} valid={valid} K={kv} G={g} hd={hd} bf16",
        )
        r = rows[label]
        plan = kdec.launch_plan(q, k, window=window, ring=ring)
        ops.reset_launch_counts()
        kern()
        per_call = ops.launch_counts()["decode_attention"]
        if per_call != 1:
            fail(f"decode_attention {label}: {per_call} launches for one call")
        print(f"  decode_attention {label}: grid {plan.grid} = {math.prod(plan.grid)} blocks of 128 "
              f"threads ({plan.n_sub} sub-group(s) of {plan.block_group} query heads a KV head) "
              f"on {plan.sms} SMs x {plan.blocks_per_sm} resident blocks (occupancy query), "
              f"{plan.smem_bytes} B dynamic shared memory a block, {per_call} kernel launch per "
              f"call")
        print(f"  decode_attention {r['shape']:<66} max|Δ| {err:.3e}  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms ({lib_name})  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB) "
              f"-> {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
        del q, k, v, lens
        torch.cuda.empty_cache()
    return rows


def tensors(tree):
    """Every tensor of a parameter or cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tensors(v)
    else:
        yield tree


def tree_to(tree, device):
    """A parameter or cache tree (dicts and lists) with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def cut_config(arch: str, layers=None):
    """``arch``'s full config, cut to its first ``layers`` layers where
    given: the same widths, pattern and block kinds, less depth."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def serve_phase(torch, arch, b, prompt_len, gen, want_params, want_config_params,
                keep_calls=0, layers=None) -> tuple:
    """``arch`` at full width (its first ``layers`` layers where given)
    through repro_torch.launch.serve.generate: b requests × (prompt_len
    prompt + gen generated) tokens, every step timed.  The tree ``init``
    builds must hold ``want_params`` parameters, and the config's analytic
    count must read ``want_config_params``.  The last ``keep_calls``
    decode_attention calls (operands and output) are kept for a check.
    Returns (model, params, launches, median step wall, calls)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import TransformerLM

    cfg = cut_config(arch, layers)
    model = TransformerLM(cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = ops.launch_counts()
    leaves = list(tensors(params))
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    by_dtype = collections.Counter()
    for t in leaves:
        by_dtype[str(t.dtype).removeprefix("torch.")] += t.numel()
    if n_params != want_params or cfg.param_count() != want_config_params:
        fail(f"{arch}: the built tree has {n_params} parameters (want {want_params}), the "
             f"config's count {cfg.param_count()} (want {want_config_params})")
    kinds = cfg.layer_kinds()
    if params["embed"].dtype != torch.bfloat16 or len(params["layers"]) != len(kinds):
        fail(f"{arch}: embedding not bf16 or {len(params['layers'])} layers built")
    n_attn = sum(kind.startswith("attn") for kind in kinds)
    steps_total = prompt_len + gen - 1
    print(f"  {cfg.name}: {n_params} parameters in the built tree ({n_bytes / 1e9:.2f} GB: "
          + ", ".join(f"{n} {dt}" for dt, n in by_dtype.items()) + f"; the config's "
          f"param_count() says {cfg.param_count()}), {len(kinds)} layers ("
          + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
          + f"; window {cfg.window}), init on the card {init_s:.2f} s")
    init_leaf_check(torch, cfg, params, 0, init_launches)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen_, device="cuda")
    stamps = []

    def on_step(pos):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    calls = collections.deque(maxlen=keep_calls)
    inner = ops.decode_attention

    def recording(q, k, v, length, *, window=0, ring=False):
        out = inner(q, k, v, length, window=window, ring=ring)
        calls.append((q, k, v, length, window, ring, out))
        return out

    if keep_calls:
        ops.decode_attention = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        seq = generate(model, params, prompt, gen, prompt_len + gen, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        ops.decode_attention = inner
    want = {"cross_gram": 0, "gram": 0, "weighted_aggregate": 0, "topk_mask_rows": 0,
            "decode_attention": n_attn * steps_total, "threefry_normal": 0,
            "threefry_rounding": 0}
    if launches != want:
        fail(f"serve {arch}: launches {launches}, want {want}")
    launches["threefry_normal"] = init_launches["threefry_normal"]
    if tuple(seq.shape) != (b, prompt_len + gen) or not torch.equal(seq[:, :prompt_len], prompt):
        fail(f"serve {arch}: output {tuple(seq.shape)} does not extend the prompt")
    if int(seq.min()) < 0 or int(seq.max()) >= cfg.vocab_size or len(stamps) != steps_total:
        fail(f"serve {arch}: tokens out of the vocabulary or steps missing")
    steps = [y - x for x, y in zip([t0] + stamps[:-1], stamps)]
    prefill_s = stamps[prompt_len - 1] - t0             # the prompt's steps → 1st token
    gen_s = stamps[-1] - stamps[prompt_len - 1]          # the other generated tokens
    step_med = sorted(steps)[len(steps) // 2]
    print(f"  {steps_total} decode steps in {wall:.2f} s, each step synchronised: prefill "
          f"({prompt_len} steps, to the first generated token) {prefill_s:.2f} s, generation "
          f"({gen - 1} steps) {gen_s:.3f} s")
    print(f"  tokens/s: {b * steps_total / wall:.1f} through the decode step, "
          f"{b * (gen - 1) / gen_s:.1f} generated; per-step wall median "
          f"{1e3 * step_med:.2f} ms (min {1e3 * min(steps):.2f}, max {1e3 * max(steps):.2f}; "
          f"prefill median {1e3 * sorted(steps[:prompt_len])[prompt_len // 2]:.2f}, generation "
          f"median {1e3 * sorted(steps[prompt_len:])[(gen - 1) // 2]:.2f})")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    print(f"  request 0, first generated tokens: {seq[0, prompt_len:prompt_len + 16].tolist()}")
    return model, params, launches, step_med, list(calls)


INIT_SAMPLES = 4096


def init_leaf_check(torch, cfg, params, seed, launches) -> None:
    """ROADMAP C.8 at full width: every drawn leaf of ``init(seed)`` (one
    Threefry launch each, nothing else launched) at 4,096 sampled indices,
    the embedding's last row among them, bitwise against the plain
    version's index-set draw under the reference's key for that leaf,
    scaled and rounded as the reference's ``dense_init``, ``embed_init`` and
    ``init_conv1d`` do (and the sLSTM's recurrent matrices as
    ``(0.1 · normal / sqrt(hd)).astype(dtype)``, and an MoE MLP's fp32
    router and each expert of its stacked leaves, under ``fold_in`` of its
    leaf's key, as ``init_moe`` draws them); Λ whole against the
    reference's linspace, the forget biases whole at 3."""
    import numpy as np

    from repro_torch import random as prng
    from repro_torch.kernels import threefry as ktf
    from repro_torch.models.rglru import decay_init
    from repro_torch.models.transformer import layer_key

    t0 = time.perf_counter()
    r_emb, r_dec, _, r_un = prng.split(prng.PRNGKey(seed), 4)
    d = cfg.d_model
    checks = [("embed", params["embed"], r_emb, 0.02, None)]
    if "unembed" in params:
        checks.append(("unembed", params["unembed"].T, r_un, 0.02, None))
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        r1, _, r3, _, _ = prng.split(layer_key(r_dec, i, cfg), 5)
        mix = layer["mixer"]
        if kind == "rglru":
            inner = mix["w_a"].shape[0]
            ru, rg, ro, rc, ra, rx, _ = prng.split(r1, 7)
            checks += [(f"{i}.w_up", mix["w_up"], ru, 1.0 / math.sqrt(d), None),
                       (f"{i}.w_gate", mix["w_gate"], rg, 1.0 / math.sqrt(d), None),
                       (f"{i}.w_down", mix["w_down"], ro, 1.0 / math.sqrt(inner), None),
                       (f"{i}.w_a", mix["w_a"], ra, 0.01, None),
                       (f"{i}.w_x", mix["w_x"], rx, 0.01, None),
                       (f"{i}.conv.w", mix["conv"]["w"], rc, None, 2.0)]
            if not torch.equal(mix["lam"].cpu(), torch.from_numpy(decay_init(inner))):
                fail(f"init {cfg.name}: layer {i}'s Λ is not the reference's linspace")
        elif kind == "mlstm":
            inner = mix["wo"].shape[0]
            rq, rk, rv, ro, rg, ri, rf = prng.split(r1, 7)
            checks += [(f"{i}.{name}", mix[name], key, 1.0 / math.sqrt(d), None)
                       for name, key in (("wq", rq), ("wk", rk), ("wv", rv), ("wgate", rg))]
            checks += [(f"{i}.wo", mix["wo"], ro, 1.0 / math.sqrt(inner), None),
                       (f"{i}.wi", mix["wi"], ri, 0.01, None), (f"{i}.wf", mix["wf"], rf, 0.01, None)]
        elif kind == "slstm":
            hd = d // cfg.num_heads
            rz, ri, rf, ro, rr, rp = prng.split(r1, 6)
            checks += [(f"{i}.{name}", mix[name], key, 1.0 / math.sqrt(d), None)
                       for name, key in (("wz", rz), ("wi", ri), ("wf", rf), ("wo_g", ro),
                                         ("wproj", rp))]
            checks += [(f"{i}.{name}", mix[name], prng.fold_in(rr, j), 0.1,
                        float(np.float32(math.sqrt(hd))))
                       for j, name in enumerate(("rz", "ri", "rf", "ro"))]
        else:
            for name, key in zip(("wq", "wk", "wv", "wo"), prng.split(r1, 4)):
                checks.append((f"{i}.{name}", mix[name], key, 1.0 / math.sqrt(mix[name].shape[0]),
                               None))
        if "mlp" in layer and "router" in layer["mlp"]:
            # an MoE MLP: the fp32 router, then expert e of each stacked leaf
            # drawn alone under fold_in(its leaf's key, e)
            mlp = layer["mlp"]
            rr, ri, rg, ro = prng.split(r3, 4)
            checks.append((f"{i}.mlp.router", mlp["router"], rr, 1.0 / math.sqrt(d), None))
            for name, key in (("wi", ri), ("wo", ro), ("wg", rg)):
                if name in mlp:
                    checks += [(f"{i}.mlp.{name}.{e}", w, prng.fold_in(key, e),
                                1.0 / math.sqrt(w.shape[0]), None)
                               for e, w in enumerate(mlp[name])]
        elif "mlp" in layer:
            for name, key in zip(("wi", "wo", "wg"), prng.split(r3, 3)):
                if name in layer["mlp"]:
                    w = layer["mlp"][name]
                    checks.append((f"{i}.mlp.{name}", w, key, 1.0 / math.sqrt(w.shape[0]), None))
    rng = np.random.default_rng(seed)
    kinds = collections.Counter()
    indices, words = [], []
    for label, leaf, key, _, _ in checks:
        n = leaf.numel()
        idx = rng.choice(n, size=min(n, INIT_SAMPLES), replace=False)
        if label in ("embed", "unembed"):         # the last row of the vocabulary
            idx = np.concatenate([idx, np.arange(n - leaf.shape[-1], n)])
        indices.append(idx)
        words.append(np.asarray(key, np.uint32).astype(np.int64))
    # every leaf's samples in one pass of the plain version, each element
    # under its leaf's key
    sizes = [len(idx) for idx in indices]
    every = torch.from_numpy(np.concatenate(indices)).cuda()
    key_words = torch.from_numpy(np.repeat(np.stack(words), sizes, axis=0)).cuda()
    z_all = ktf.normal_plain((key_words[:, 0], key_words[:, 1]), index=every, device="cuda")
    same = []
    for (label, leaf, _, scale, divisor), z, index in zip(checks, z_all.split(sizes),
                                                          every.split(sizes)):
        if scale is not None:
            z = z * float(np.float32(scale))
        if divisor:
            z = z / torch.tensor(divisor, device="cuda")
        got = leaf.reshape(-1)[index]
        view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        same.append((got.view(view) == z.to(got.dtype).view(view)).all())
        kinds[f"{tuple(leaf.shape)} {str(leaf.dtype).removeprefix('torch.')}"] += 1
    for (label, *_), ok in zip(checks, torch.stack(same).tolist()):
        if not ok:
            fail(f"init {cfg.name}: leaf {label} differs from the reference's draw")
    # a stacked (E, …) expert leaf is E draws
    drawn = sum(t.dim() >= 2 for t in tensors(params)) + sum(
        (layer["mlp"][name].shape[0] - 1) for layer in params["layers"]
        if "router" in layer.get("mlp", {}) for name in ("wi", "wo", "wg") if name in layer["mlp"])
    forget = [layer["mixer"]["bf"] for kind, layer in zip(cfg.layer_kinds(), params["layers"])
              if kind in ("mlstm", "slstm")]
    if not all(bool((b == 3.0).all()) and b.dtype == torch.float32 for b in forget):
        fail(f"init {cfg.name}: a forget bias is not fp32 3.0")
    want = {k: 0 for k in launches}
    want["threefry_normal"] = drawn
    if launches != want or len(checks) != drawn:
        fail(f"init {cfg.name}: launches {launches} for {drawn} drawn leaves ({len(checks)} "
             f"checked)")
    print(f"  init {cfg.name}: {drawn} leaves drawn in {drawn} Threefry launches; each leaf at "
          f"{INIT_SAMPLES} sampled indices (the embedding's last row too) bitwise the plain "
          f"version's draw under the reference's key, Λ whole the reference's linspace; leaf "
          f"kinds " + ", ".join(f"{v} x {k}" for k, v in kinds.items())
          + f" ({time.perf_counter() - t0:.1f} s)")


def rg_last_step_check(torch, cfg, calls) -> None:
    """Each local attention layer's kernel output at phase 4b's last step,
    on its own wrapped 2,048-slot ring, against the plain version."""
    from repro_torch.kernels import decode_attention as kdec

    if len(calls) != RG_ATTN_LAYERS or len({c[1].data_ptr() for c in calls}) != RG_ATTN_LAYERS:
        fail(f"serve {RG_ARCH}: the last step's {len(calls)} attention calls are not "
             f"{RG_ATTN_LAYERS} layers' own caches")
    worst = 0.0
    for i, (q, k, v, length, window, ring, out) in enumerate(calls):
        if (not ring or window != RG_WINDOW or k.shape[1] != RG_WINDOW
                or int(length.min()) != RG_STEPS or q.shape[1] != RG_GROUP * k.shape[2]):
            fail(f"serve {RG_ARCH} attention layer {i}: not a wrapped {RG_WINDOW}-slot ring at "
                 f"G = {RG_GROUP} (ring {ring}, window {window}, cache {tuple(k.shape)}, "
                 f"length {int(length.min())})")
        worst = max(worst, check_decode(
            f"serve {RG_ARCH} last step, attention layer {i}", out,
            kdec.decode_attention_plain(q.float(), k.float(), v.float(), length, window=window,
                                        ring=ring), v, torch))
    print(f"  last step: the {RG_ATTN_LAYERS} local layers' kernel outputs on their own wrapped "
          f"rings (length {RG_STEPS} > {RG_WINDOW} slots, G = {RG_GROUP}) against the plain "
          f"version: max |Δ| {worst:.3e}, within 1e-5·max|V| + half a bf16 ulp")


def serve_profile(torch, model, params, step_wall_s: float, steps: int = 8) -> None:
    """Device time by kernel over ``steps`` decode steps at the serve run's
    last positions (1144-1151 tokens in the caches), through the same serve
    step on a fresh cache: the same work and bytes as the run's last steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import build_serve_step

    serve = build_serve_step(model)
    cache = model.init_cache(SERVE_B, SERVE_CACHE, "cuda")
    tok = torch.zeros(SERVE_B, 1, dtype=torch.long, device="cuda")
    first = SERVE_STEPS - steps
    for pos in range(first - 2, first):                  # warm-up, not profiled
        tok, logits, cache = serve(params, tok, cache, pos)
        tok = tok[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for pos in range(first, SERVE_STEPS):
            tok, logits, cache = serve(params, tok, cache, pos)
            tok = tok[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not torch.isfinite(logits.float()).all() or tuple(logits.shape) != (SERVE_B, 1, 262_144):
        fail("serve profile: logits not finite or of the wrong shape")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profiler saw no device activity")
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, last_end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, last_end))
        last_end = max(last_end, e.time_range.end)
    total_us = sum(by_name.values())
    busy_step = busy_us / 1e6 / steps
    print(f"  {steps} steps under the profiler: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"(summed {total_us / 1e6:.4f} s); busy per step {1e3 * busy_step:.3f} ms = "
          f"{100 * busy_step / step_wall_s:.1f}% of the unprofiled median step "
          f"({1e3 * step_wall_s:.2f} ms)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / total_us:5.1f}%  {name[:110]}")
    # the products by their operands' shapes (aten::mm's device time), the
    # rest by kernel name
    products = {"unembed product (vocab 262,144)": 0.0, "MLP products (d_ff 10,240)": 0.0,
                "q/k/v/o projections": 0.0}
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key != "aten::mm":
            continue
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        dims = {d for shape in evt.input_shapes for d in shape}
        label = ("unembed product (vocab 262,144)" if 262_144 in dims else
                 "MLP products (d_ff 10,240)" if 10_240 in dims else "q/k/v/o projections")
        products[label] += us
    categories = dict(products)
    categories["decode attention (this port)"] = sum(
        us for n, us in by_name.items() if DECODE_KERNEL in n)
    decode_launches = sum(DECODE_KERNEL in e.name for e in events)
    print(f"  {decode_launches} {DECODE_KERNEL} launches in {steps} steps "
          f"({decode_launches / steps:.0f} per step)")
    if decode_launches != SERVE_LAYERS * steps:
        fail(f"serve profile: {decode_launches} decode attention kernel launches in {steps} steps, "
             f"want one per layer per step ({SERVE_LAYERS * steps})")
    categories["elementwise and reductions (norms, RoPE, casts, residuals)"] = sum(
        us for n, us in by_name.items() if "elementwise_kernel" in n or "reduce_kernel" in n)
    categories["other"] = total_us - sum(categories.values())
    for label, us in categories.items():
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / total_us:5.1f}%  {label}")


def small_config(arch):
    """Phase 5's, 5b's and 8b's small fp32 model of ``arch``'s family, the
    CPU tests' config: ``reduce_config`` at 8 layers and window 8 (for
    recurrentgemma-2b also its 10 query heads over one KV head; xlstm-1.3b
    at 9 layers), and how many positions it is teacher-forced over, so that
    the rings of 8 wrap."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_config

    kw = dict(num_layers=8, window=8, dtype="float32")
    if arch == RG_ARCH:
        kw.update(num_heads=RG_GROUP, num_kv_heads=1)
    if arch == XL_ARCH:                  # a cycle of 7 mLSTM and 1 sLSTM block, 1 rest layer
        kw = dict(num_layers=9, dtype="float32")
    return dataclasses.replace(reduce_config(get_arch(arch)), **kw), 24 if arch == RG_ARCH else 20


def serve_reference_check(torch, arch) -> None:
    """A small ``arch``-family model (``small_config``) teacher-forced with
    cache_len = positions on the card and on the CPU: the local rings wrap;
    logits and greedy tokens must agree, and the kernel must launch once per
    attention layer per position."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import TransformerLM

    cfg, positions = small_config(arch)
    model = TransformerLM(cfg)
    params = model.init(0, "cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, positions)))
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        serve = build_serve_step(model)
        p, cache = to(params, dev), model.init_cache(4, positions, dev)
        out = []
        for pos in range(positions):
            nxt, logits, cache = serve(p, tokens[:, pos:pos + 1].to(dev), cache, pos)
            out.append((nxt.cpu(), logits.float().cpu()))
        runs[dev] = out
    n_attn = sum(kind.startswith("attn") for kind in cfg.layer_kinds())
    if ops.launch_counts()["decode_attention"] != n_attn * positions:
        fail(f"small {arch} serve: {ops.launch_counts()['decode_attention']} kernel launches, "
             f"want {n_attn * positions}")
    worst = 0.0
    for pos, ((ta, la), (tb, lb)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        rel = float((la - lb).abs().max() / lb.abs().max())
        worst = max(worst, rel)
        if rel > SERVE_LOGIT_RTOL or not torch.equal(ta, tb):
            fail(f"small {arch} serve position {pos}: GPU/CPU logits |Δ|/max {rel:.2e} or tokens "
                 f"differ")
    kinds = cfg.layer_kinds()
    print(f"  small {arch}-family model ({cfg.num_layers} layers: "
          + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
          + f"; {cfg.num_heads} heads over {cfg.num_kv_heads} KV, window {cfg.window}, fp32) GPU == "
          f"CPU over {positions} positions: logits |Δ|/max|logit| ≤ {worst:.2e}, greedy tokens "
          f"equal, {n_attn * positions} kernel launches")


@contextlib.contextmanager
def annotated(targets):
    """While the block runs, wrap each (owner, attribute, label) callable in
    ``torch.profiler.record_function(label)``."""
    from torch.profiler import record_function

    saved = []
    for owner, attr, label in targets:
        inner = getattr(owner, attr)

        def wrapper(*args, _inner=inner, _label=label, **kwargs):
            with record_function(_label):
                return _inner(*args, **kwargs)

        saved.append((owner, attr, inner))
        setattr(owner, attr, wrapper)
    try:
        yield
    finally:
        for owner, attr, inner in reversed(saved):
            setattr(owner, attr, inner)


RG_SPANS = ("rglru_block", "rglru_gates", "rglru_conv", "attention", "mlp", "unembed")


def rg_group(name: str, label, op: str) -> str:
    """Phase 4b's group of a kernel, from its innermost ``RG_SPANS`` label
    and whether a product op (``aten::mm``, ``addmm``, ``bmm``) launched it."""
    product = op.endswith("mm")
    if DECODE_KERNEL in name:
        return "decode attention (this port's kernel, G = 10)"
    if label == "rglru_gates" and product:
        return "RG-LRU fp32 gate products (w_a, w_x)"
    if label == "rglru_block" and product:
        return "RG-LRU bf16 projections (w_up, w_gate, w_down)"
    if label in ("rglru_gates", "rglru_block", "rglru_conv"):
        return "RG-LRU conv and recurrence elementwise work"
    if label == "attention":
        return "q/k/v/o projections" if product else "norms, RoPE, casts, residuals"
    if label == "mlp":
        return "MLP (gated, d_ff 7,680)"
    if label == "unembed":
        return "unembed (tied embedding, vocab 256,000)"
    return "norms, RoPE, casts, residuals"


def group_profile(torch, model, params, b: int, last: int, spans, labels: tuple, group,
                  step_wall_s: float, attn_layers: int, state_line=None, steps: int = 8) -> None:
    """Device time by group over ``steps`` decode steps at a serve run's last
    positions (up to ``last``), through the same serve step on a fresh cache
    of ``last + 1`` slots: the rings' valid slots, the recurrent states and
    the work are the run's last steps'.  ``spans`` are the (module, function,
    label) annotations and ``group`` names a kernel's group from its name, its
    innermost label of ``labels`` and the op that launched it.  A step must
    launch ``attn_layers`` decode attention kernels.  ``state_line(cache,
    params)``, where given, prints a line on the state first."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import build_serve_step

    name = model.cfg.name
    serve = build_serve_step(model)
    cache = model.init_cache(b, last + 1, "cuda")
    if state_line is not None:
        state_line(cache, params)
    tok = torch.zeros(b, 1, dtype=torch.long, device="cuda")
    first = last - steps
    tok, logits, cache = serve(params, tok, cache, first - 2)     # warm-up, not profiled
    tok = tok[:, None]
    torch.cuda.synchronize()
    with annotated(spans), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        # the profiler can lose the records of the first kernels it sees: a
        # second warm-up step runs inside it, then a marker kernel; only the
        # kernels after the marker are read
        tok, logits, cache = serve(params, tok, cache, first - 1)
        tok = tok[:, None]
        torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(first, last):
            tok, logits, cache = serve(params, tok, cache, pos)
            tok = tok[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if (not torch.isfinite(logits.float()).all()
            or tuple(logits.shape) != (b, 1, model.cfg.vocab_size)):
        fail(f"{name} serve profile: logits not finite or of the wrong shape")
    groups, busy_us, n_kernels, top = device_groups(prof, labels, group, since=PROFILE_MARK)
    if not n_kernels:
        fail("the profiler saw no device activity")
    decode_launches = sum(n for kernel, (_, n) in top if DECODE_KERNEL in kernel)
    if decode_launches != attn_layers * steps:
        fail(f"{name} serve profile: {decode_launches} decode attention kernel launches in "
             f"{steps} steps, want one per attention layer per step ({attn_layers * steps})")
    total = sum(groups.values())
    busy_step = busy_us / 1e6 / steps
    print(f"  {steps} steps under the profiler: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"({n_kernels} kernels, {n_kernels / steps:.0f} a step, {decode_launches / steps:.0f} "
          f"{DECODE_KERNEL} a step); busy per step {1e3 * busy_step:.3f} ms = "
          f"{100 * busy_step / step_wall_s:.1f}% of the unprofiled median step "
          f"({1e3 * step_wall_s:.2f} ms)")
    for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / total:5.1f}%  {label}")
    for kernel, (us, n) in top[:10]:
        print(f"    top kernel {us / 1e3 / steps:8.3f} ms/step  {n / steps:5.0f}/step  {kernel[:110]}")


def rg_serve_profile(torch, model, params, step_wall_s: float) -> None:
    """Phase 4b's device time by group, at the run's last positions."""
    from repro_torch.models import attention, rglru, transformer

    spans = [(rglru, "rglru_decode_step", "rglru_block"), (rglru, "_gates", "rglru_gates"),
             (rglru, "conv1d_decode", "rglru_conv"),
             (attention, "attention_decode_step", "attention"),
             (transformer, "apply_mlp", "mlp"), (transformer.TransformerLM, "unembed", "unembed")]
    group_profile(torch, model, params, RG_B, RG_STEPS, spans, RG_SPANS, rg_group, step_wall_s,
                  RG_ATTN_LAYERS)


def clone_cache(cache: list) -> list:
    """A copy of a model's per-layer caches (the decode updates them in place)."""
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def decode_gap(torch, model, params, tokens, full, cache, start: int = 0, keep_at=None) -> tuple:
    """Decode ``tokens`` from position ``start`` on, from ``cache``, and
    return (the largest |Δ|/max|logit| of the step logits from ``full``,
    ``forward``'s logits; the positions whose argmax agrees; a copy of the
    cache as it stood before position ``keep_at``, or None)."""
    worst, same, kept = 0.0, 0, None
    with torch.no_grad():
        for pos in range(start, tokens.shape[1]):
            if pos == keep_at:
                kept = clone_cache(cache)
            logits, cache = model.decode_step(params, tokens[:, pos:pos + 1], cache, pos)
            want = full[:, pos]
            worst = max(worst, float((logits[:, 0] - want).abs().max() / want.abs().max()))
            same += int((logits[:, 0].argmax(-1) == want.argmax(-1)).sum())
    return worst, same, kept


def fault_gaps(torch, model, params, tokens, full, kept, faults, at: int) -> list:
    """The planted faults (label, layers) decoded together: each decodes on
    from ``kept``, a copy of the sound cache as it stood before position
    ``at``, with the caches of ``layers`` (every layer where None) emptied.
    The faults' caches are stacked along the batch (one decode of
    len(faults) x B sequences, not one of B each); each fault's gap from
    ``full`` is read from its own rows, printed and returned."""
    b, positions = tokens.shape
    n = len(faults)
    dev = tokens.device
    fresh = model.init_cache(b, positions, dev)
    probes = model.init_cache(1, positions, dev), model.init_cache(2, positions, dev)

    def batch_dim(i, key):
        one, two = probes[0][i][key].shape, probes[1][i][key].shape
        return next(d for d, (x, y) in enumerate(zip(one, two)) if x != y)

    cache = [{key: torch.cat([(fresh[i] if layers is None or i in layers else kept[i])[key]
                              for _, layers in faults], dim=batch_dim(i, key))
              for key in fresh[i]} for i in range(len(fresh))]
    del probes
    every = tokens.repeat(n, 1)
    worst = torch.zeros(n, device=dev)
    same = torch.zeros(n, dtype=torch.long, device=dev)
    with torch.no_grad():
        for pos in range(at, positions):
            logits, cache = model.decode_step(params, every[:, pos:pos + 1], cache, pos)
            got = logits[:, 0].reshape(n, b, -1)
            want = full[:, pos]
            gap = (got - want).abs().amax(dim=(1, 2)) / want.abs().max()
            worst = torch.maximum(worst, gap)
            same += (got.argmax(-1) == want.argmax(-1)).sum(-1)
    gaps = worst.tolist()
    for (label, _), gap, hits in zip(faults, gaps, same.tolist()):
        print(f"  planted fault, {label} before position {at}: |Δ|/max|logit| {gap:.3e} over "
              f"positions {at}..{positions - 1}, argmax equal at {hits} of {b * (positions - at)}")
    print(f"  ({n} planted faults decoded together, {n * b} sequences a step)")
    return gaps


def fp32_decode_check(torch, arch: str, b: int, positions: int, rtol: float,
                      faults=(), fault_at=None) -> None:
    """``arch`` at full width in fp32: decode-step logits over ``positions``
    positions at B = ``b`` against ``forward``'s on the card, within
    ``rtol`` of max|logit|.  Each planted fault (label, layers) decodes on
    from a copy of the sound cache as it stood before position ``fault_at``,
    with the caches of ``layers`` (every layer where None) emptied: a decode
    that lost state there.  Its gap must pass ``rtol``, so
    that the limit lies between a sound decode and a wrong one."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    n_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, positions), generator=gen, device="cuda")
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
    if not torch.isfinite(full).all() or tuple(full.shape) != (b, positions, cfg.vocab_size):
        fail(f"{arch} fp32 forward: logits not finite or of the wrong shape")
    worst, same, kept = decode_gap(torch, model, params, tokens, full,
                                   model.init_cache(b, positions, "cuda"), keep_at=fault_at)
    if worst > rtol:
        fail(f"{arch} fp32: decode-step logits |Δ|/max {worst:.2e} from forward's "
             f"(limit {rtol:.0e})")
    print(f"  {cfg.name} fp32 ({n_bytes / 1e9:.2f} GB of parameters): decode-step logits against "
          f"forward's over {positions} positions at B={b}: |Δ|/max|logit| ≤ {worst:.3e} (limit "
          f"{rtol:.0e}), argmax equal at {same} of {b * positions}; {time.perf_counter() - t0:.1f} s")
    gaps = fault_gaps(torch, model, params, tokens, full, kept, faults, fault_at) if faults else []
    for (label, _), gap in zip(faults, gaps):
        if gap <= rtol:
            fail(f"{arch} fp32: a decode with {label} stays within the limit {rtol:.0e} "
                 f"({gap:.2e}): the check cannot tell it from a sound one")
    del params, full, kept


# ---------------------------------------------------------------------------
# phases 12-12d: the mixture-of-experts models served
# ---------------------------------------------------------------------------
MX_ARCH, DBRX_ARCH = "mixtral-8x22b", "dbrx-132b"
# 8 requests x (128 prompt + 32 generated) tokens: mixtral's cache of 160
# slots is a ring under its 4,096 window, dbrx's a global cache
MOE_B, MOE_PROMPT, MOE_GEN = 8, 128, 32
MOE_CACHE = MOE_PROMPT + MOE_GEN                 # 160
MOE_STEPS = MOE_CACHE - 1                        # 159 decode steps
MOE_GROUP, MOE_HEAD_DIM = 6, 128                 # 48 query heads over 8 KV heads
# (layers of the cut model, parameters of the tree init builds, the config's
# param_count()): full width, depth cut so that the bf16 weights fit the card
# beside nothing else (a full-depth model is 281 or 263 GB); dbrx's built
# tree holds the layernorms' biases, which the config's count leaves out
MOE_SERVE = {
    MX_ARCH: (12, 30_451_390_464, 30_451_390_464),     # 12 of 56 layers
    DBRX_ARCH: (9, 30_565_011_456, 30_564_894_720),    # 9 of 40 layers
}
# phase 12c: fp32 at full width, 2 layers (5.41 B and 7.75 B parameters)
MOE_FP32_LAYERS, MOE_FP32_B, MOE_FP32_POSITIONS = 2, 2, 48
MOE_FP32_RTOL = 1e-4       # decode-step logits against forward's, |Δ| / max|logit|
MOE_TIE_GAP = 1e-6         # a token's experts may differ only below this top-k gap
MOE_TRAIN_RTOL = 1e-5      # phase 12d: the loss (nll + aux), card against CPU, relative
MOE_SPANS = ("attention", "moe", "moe_route", "moe_slots", "moe_experts", "unembed")


def moe_group(name: str, label, op: str) -> str:
    """Phases 12 and 12b's group of a kernel, from its innermost
    ``MOE_SPANS`` label and the op that launched it."""
    product = op.endswith("mm")
    if DECODE_KERNEL in name:
        return f"decode attention (this port's kernel, G = {MOE_GROUP}, hd {MOE_HEAD_DIM})"
    if label == "moe_route":
        return "router, softmax and top-k (fp32)"
    if label == "moe_slots":
        return "slotting (one-hot, cumsum over the group)"
    if label == "moe_experts":
        return "expert products (bmm over the experts)" if product else "expert activation"
    if label == "moe":
        return "dispatch and combine (gathers, scatter, gated sum)"
    if label == "attention":
        return "q/k/v/o projections" if product else "attention's RoPE, casts and cache writes"
    if label == "unembed":
        return "unembed"
    return "norms, residuals, embedding, argmax"


def moe_serve_phase(torch, arch: str, bandwidth: float) -> dict:
    """Phase 12 (mixtral-8x22b) or 12b (dbrx-132b): the cut model at full
    width through ``generate``, its step's bound (the bytes a step reads:
    every weight but the embedding's unused rows, and the KV caches, at the
    measured bandwidth), decode steps that read nothing back to the host,
    and 8 steps under the profiler by group.  Returns the run's launches."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import attention, moe, transformer

    layers, want_params, want_config = MOE_SERVE[arch]
    routes = []
    with recorded_routes(routes):
        model, params, launches, step_s, _ = serve_phase(
            torch, arch, MOE_B, MOE_PROMPT, MOE_GEN, want_params, want_config, layers=layers)
    cfg = model.cfg
    e, k, n_layers = cfg.moe.num_experts, cfg.moe.top_k, cfg.num_layers
    if len(routes) != MOE_STEPS * n_layers:
        fail(f"serve {arch}: {len(routes)} routings recorded, want {MOE_STEPS * n_layers}")
    emb = params["embed"]
    weight_bytes = (sum(t.numel() * t.element_size() for t in tensors(params))
                    - emb.numel() * emb.element_size() + MOE_B * cfg.d_model * emb.element_size())
    slot_bytes = 2 * n_layers * MOE_B * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    kv_bytes = MOE_CACHE * slot_bytes
    bound_s = (weight_bytes + kv_bytes) / bandwidth
    print(f"  implementation's step bound: {weight_bytes / 1e9:.2f} GB of weights (all but the "
          f"embedding's unread rows; the drop-free step runs every expert) and "
          f"{kv_bytes / 1e6:.1f} MB of KV caches a step at {bandwidth / 1e12:.3f} TB/s = "
          f"{1e3 * bound_s:.2f} ms; the median step {1e3 * step_s:.2f} ms is "
          f"{100 * bound_s / step_s:.1f}% of it; bound tokens/s {MOE_B / bound_s:.1f}")
    # the function's bound: of each layer, the experts this step's tokens
    # were routed to, and the KV slots the step reads
    ids = torch.stack([r[1] for r in routes]).reshape(MOE_STEPS, n_layers, MOE_B * k)
    used = torch.zeros(MOE_STEPS, n_layers, e, dtype=torch.bool, device=ids.device)
    idle = (~used.scatter_(2, ids, True)).sum(dim=(1, 2)).tolist()        # (steps,)
    mlp = params["layers"][0]["mlp"]
    expert_bytes = sum(mlp[n][0].numel() * mlp[n].element_size()
                       for n in ("wi", "wg", "wo") if n in mlp)
    need = [weight_bytes - idle[pos] * expert_bytes
            + min(pos + 1, cfg.window or MOE_CACHE) * slot_bytes for pos in range(MOE_STEPS)]
    routed_s = sum(need) / MOE_STEPS / bandwidth
    print(f"  function's step bound, this run's routes: of the {n_layers} x {e} experts, "
          f"{sum(idle) / MOE_STEPS:.2f} a step got no token ({100 * sum(idle) / (MOE_STEPS * n_layers * e):.1f}%; "
          f"{expert_bytes / 1e6:.1f} MB each), so a step needs {sum(need) / MOE_STEPS / 1e9:.2f} GB "
          f"(its KV slots included) = {1e3 * routed_s:.2f} ms; the median step is "
          f"{100 * routed_s / step_s:.1f}% of it; bound tokens/s {MOE_B / routed_s:.1f}")
    del routes, ids, used
    # the MoE decode step reads nothing back to the host: a sync there raises
    serve = build_serve_step(model)
    cache = model.init_cache(MOE_B, MOE_CACHE, "cuda")
    tok = torch.zeros(MOE_B, 1, dtype=torch.long, device="cuda")
    tok, _, cache = serve(params, tok, cache, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pos in range(1, 3):
            tok, _, cache = serve(params, tok[:, None], cache, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  two decode steps under set_sync_debug_mode('error'): no host read")
    del cache, tok
    print(f"profile: device time by group of the {arch} serve step")
    spans = [(attention, "attention_decode_step", "attention"), (moe, "mix", "moe"),
             (moe, "route", "moe_route"), (moe, "slots", "moe_slots"),
             (moe, "experts", "moe_experts"), (transformer.TransformerLM, "unembed", "unembed")]
    group_profile(torch, model, params, MOE_B, MOE_STEPS, spans, MOE_SPANS, moe_group, step_s,
                  cfg.num_layers)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def recorded_routes(store: list, fault=None):
    """While the block runs, every ``moe.route`` call appends its (probs,
    expert ids) to ``store``; ``fault``, where given, routes in its place."""
    from repro_torch.models import moe

    inner = moe.route

    def recording(params, xt, k):
        probs, gates, ids = (fault or inner)(params, xt, k)
        store.append((probs, ids))
        return probs, gates, ids

    moe.route = recording
    try:
        yield
    finally:
        moe.route = inner


def route_k_plus_one(params, xt, k):
    """A planted fault: the (k+1)-th expert routed in place of the k-th."""
    probs = torch_softmax_router(params, xt)
    vals, ids = probs.sort(dim=-1, descending=True, stable=True)
    pick = list(range(k - 1)) + [k]
    gates = vals[:, pick]
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), ids[:, pick]


def route_unnormalised(params, xt, k):
    """A planted fault: the top-k gates left as their raw probabilities."""
    probs = torch_softmax_router(params, xt)
    vals, ids = probs.sort(dim=-1, descending=True, stable=True)
    return probs, vals[:, :k], ids[:, :k]


def torch_softmax_router(params, xt):
    return (xt.float() @ params["router"]).softmax(dim=-1)


MOE_FAULTS = (("the (k+1)-th expert routed in place of the k-th", route_k_plus_one),
              ("the gates not renormalised", route_unnormalised))


def moe_wrapped_serve(torch) -> int:
    """Phase 12's second run: mixtral-8x22b at full width, its first layer
    alone, through ``generate`` past its window: 8 requests × (4,468 prompt
    + 32 generated) tokens into a 4,096-slot ring, so the last 403 steps
    write over the oldest slots.  Every ``decode_attention`` launch of the
    run is at the kernels line's wrapped row's shape (B = 8, 4,096 slots, 8
    KV heads, G = 6, hd 128); the last step's kernel output is held against
    the plain version.  Returns the run's launches of the kernel."""
    from repro_torch.kernels import decode_attention as kdec

    t0 = time.perf_counter()
    model, params, launches, _, calls = serve_phase(
        torch, MX_ARCH, MOE_B, MX_WRAPPED_LENGTH - MOE_GEN, MOE_GEN, MX_WRAPPED_PARAMS,
        MX_WRAPPED_PARAMS, keep_calls=1, layers=MX_WRAPPED_LAYERS)
    (q, k, v, length, window, ring, out), = calls
    last = MX_WRAPPED_LENGTH - 1
    if (not ring or window != MX_WINDOW or tuple(k.shape[:3]) != (MOE_B, MX_WINDOW, 8)
            or int(length.min()) != last or q.shape[1] != MOE_GROUP * k.shape[2]):
        fail(f"serve {MX_ARCH} past its window: the last step's attention is not a wrapped "
             f"{MX_WINDOW}-slot ring at G = {MOE_GROUP} (ring {ring}, window {window}, cache "
             f"{tuple(k.shape)}, length {int(length.min())})")
    err = check_decode(f"serve {MX_ARCH} past its window, last step", out,
                       kdec.decode_attention_plain(q.float(), k.float(), v.float(), length,
                                                   window=window, ring=ring), v, torch)
    print(f"  {launches['decode_attention']} decode_attention launches at the {MX_WINDOW}-slot "
          f"ring, {last - MX_WINDOW} steps past the window; the last step (length {last}) "
          f"against the plain version: max |Δ| {err:.3e}, within 1e-5·max|V| + half a bf16 ulp "
          f"({time.perf_counter() - t0:.1f} s)")
    del model, params, calls, q, k, v, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches["decode_attention"]


def moe_fp32_check(torch, arch: str) -> None:
    """Phase 12c for one model: ``arch`` at full width, 2 layers, fp32;
    decode-step logits over 48 positions at B = 2 against the drop-free
    ``forward``'s within 1e-4 of max|logit|; every token's experts equal in
    both runs, a difference allowed only where the forward side's gap
    between the k-th and (k+1)-th router probabilities is under 1e-6; and
    each planted fault in the decode's routing beyond the limit."""
    import dataclasses

    from repro_torch.models import TransformerLM

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cut_config(arch, MOE_FP32_LAYERS), dtype="float32")
    model = TransformerLM(cfg, moe_capacity_factor=None)
    params = model.init(0, "cuda")
    n_params = sum(t.numel() for t in tensors(params))
    b, positions, k = MOE_FP32_B, MOE_FP32_POSITIONS, cfg.moe.top_k
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, positions), generator=gen, device="cuda")
    forward_routes, decode_routes = [], []
    with torch.no_grad(), recorded_routes(forward_routes):
        full = model.forward(params, {"tokens": tokens})
    if not torch.isfinite(full).all() or tuple(full.shape) != (b, positions, cfg.vocab_size):
        fail(f"{arch} fp32 forward: logits not finite or of the wrong shape")
    with recorded_routes(decode_routes):
        worst, same, _ = decode_gap(torch, model, params, tokens, full,
                                    model.init_cache(b, positions, "cuda"))
    if worst > MOE_FP32_RTOL:
        fail(f"{arch} fp32: decode-step logits |Δ|/max {worst:.2e} from forward's (limit "
             f"{MOE_FP32_RTOL:.0e})")
    layers = cfg.num_layers
    if len(forward_routes) != layers or len(decode_routes) != layers * positions:
        fail(f"{arch} fp32: {len(forward_routes)} forward and {len(decode_routes)} decode routings")
    flips, min_gap = 0, float("inf")
    for layer, (probs, ids) in enumerate(forward_routes):
        top = probs.sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).reshape(b, positions)
        min_gap = min(min_gap, float(gap.min()))
        want = ids.sort(dim=-1).values.reshape(b, positions, k)
        for pos in range(positions):
            got = decode_routes[pos * layers + layer][1].sort(dim=-1).values
            differ = (got != want[:, pos]).any(-1)
            if bool((differ & (gap[:, pos] >= MOE_TIE_GAP)).any()):
                fail(f"{arch} fp32 layer {layer} position {pos}: decode routed to other experts "
                     f"than forward where the top-{k} gap is {float(gap[:, pos].min()):.2e}")
            flips += int(differ.sum())
    print(f"  {cfg.name} fp32, {layers} layers ({n_params / 1e9:.2f} B parameters, "
          f"{4 * n_params / 1e9:.1f} GB), drop-free: decode-step logits against forward's over "
          f"{positions} positions at B={b}: |Δ|/max|logit| ≤ {worst:.3e} (limit "
          f"{MOE_FP32_RTOL:.0e}), argmax equal at {same} of {b * positions}; each token's "
          f"top-{k} of {cfg.moe.num_experts} experts equal in both runs at "
          f"{layers * b * positions - flips} of {layers * b * positions} (token, layer) pairs; "
          f"smallest forward-side gap between a token's k-th and (k+1)-th router "
          f"probabilities {min_gap:.3e} (a difference allowed below {MOE_TIE_GAP:.0e}); "
          f"{time.perf_counter() - t0:.1f} s")
    for label, fault in MOE_FAULTS:
        with recorded_routes([], fault):
            gap, same, _ = decode_gap(torch, model, params, tokens, full,
                                      model.init_cache(b, positions, "cuda"))
        print(f"  planted fault, {label}: |Δ|/max|logit| {gap:.3e}, argmax equal at {same} of "
              f"{b * positions}")
        if gap <= MOE_FP32_RTOL:
            fail(f"{arch} fp32: a decode with {label} stays within the limit "
                 f"{MOE_FP32_RTOL:.0e} ({gap:.2e}): the check cannot tell it from a sound one")
    del model, params, full, forward_routes, decode_routes
    gc.collect()
    torch.cuda.empty_cache()


def moe_reference_check(torch) -> None:
    """Phase 12d: the reduced MoE models in fp32 on the card against the CPU
    (mixtral's window cut to 8, so that its rings wrap): ``forward`` at
    capacity factor 1.25 in one group, in groups of 16 that pad the 40
    tokens, and at factor 0.5 in those groups (tokens dropped); ``loss``
    (nll + aux) at each; greedy tokens through ``generate``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import TransformerLM

    for arch in (MX_ARCH, DBRX_ARCH):
        kw = dict(window=8) if arch == MX_ARCH else {}
        cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32", **kw)
        params = TransformerLM(cfg).init(0, "cpu")
        on_card = tree_to(params, "cuda")
        gen = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
        worst_logit = worst_loss = 0.0
        dropped = {}
        for cf, group in ((1.25, 2048), (1.25, 16), (0.5, 16)):
            model = TransformerLM(cfg, moe_capacity_factor=cf, moe_group_size=group)
            out = {}
            for dev, p in (("cuda", on_card), ("cpu", params)):
                batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
                kept = []
                with recorded_slots(kept), torch.no_grad():
                    logits = model.forward(p, batch).cpu()
                with torch.no_grad():
                    out[dev] = (logits, float(model.loss(p, batch)))
                dropped[(cf, group, dev)] = sum(int((~keep).sum()) for keep in kept)
            (lg, lo), (lc, lc_loss) = out["cuda"], out["cpu"]
            rel = float((lg - lc).abs().max() / lc.abs().max())
            rel_loss = abs(lo - lc_loss) / abs(lc_loss)
            worst_logit, worst_loss = max(worst_logit, rel), max(worst_loss, rel_loss)
            if rel > SERVE_LOGIT_RTOL or rel_loss > MOE_TRAIN_RTOL \
                    or dropped[(cf, group, "cuda")] != dropped[(cf, group, "cpu")]:
                fail(f"small {arch} forward at capacity factor {cf}, groups of {group}: logits "
                     f"|Δ|/max {rel:.2e}, loss {rel_loss:.2e} relative, dropped (token, choice) "
                     f"pairs {dropped[(cf, group, 'cuda')]} on the card, "
                     f"{dropped[(cf, group, 'cpu')]} on the CPU")
        if not dropped[(0.5, 16, "cpu")]:
            fail(f"small {arch}: capacity factor 0.5 dropped nothing")
        model = TransformerLM(cfg)
        prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
        want = generate(model, params, prompt, 8, 20)
        ops.reset_launch_counts()
        got = generate(model, on_card, prompt.cuda(), 8, 20)
        if ops.launch_counts()["decode_attention"] != cfg.num_layers * 19 or \
                not torch.equal(got.cpu(), want):
            fail(f"small {arch} generate: tokens differ on the card or "
                 f"{ops.launch_counts()['decode_attention']} kernel launches")
        print(f"  small {arch}-family model ({cfg.num_layers} layers, {cfg.moe.num_experts} "
              f"experts top-{cfg.moe.top_k}, window {cfg.window}, fp32) GPU == CPU: forward at "
              f"capacity factor 1.25 (one group, groups of 16 padding 40 tokens) and 0.5 "
              f"({dropped[(0.5, 16, 'cpu')]} of the layers' "
              f"{40 * cfg.moe.top_k * cfg.num_layers} (token, choice) pairs dropped on both) logits |Δ|/max ≤ {worst_logit:.2e}, loss (nll + aux) ≤ "
              f"{worst_loss:.2e} relative; 8 greedy tokens after 12 equal, "
              f"{cfg.num_layers * 19} kernel launches")


# ---------------------------------------------------------------------------
# phase 13c: the reduced MoE models' training on the card against the CPU
# ---------------------------------------------------------------------------
# (capacity factor, dispatch group; None: the model's 2,048, one group a
# sequence): drops at 0.5; groups of 16 pad the 40 tokens of each sequence
MOE_ROUTINGS = ((1.25, None), (0.5, None), (1.25, 16))
MOE_TRAIN_SEQ = 40


@contextlib.contextmanager
def moe_routing(cf, group):
    """While the block runs, ``LMClassifier`` and ``launch.train`` build
    their ``TransformerLM`` with capacity factor ``cf`` and dispatch groups
    of ``group`` tokens (the model's default where None)."""
    import functools

    from repro_torch.launch import train
    from repro_torch.models import lm

    saved = lm.TransformerLM, train.TransformerLM
    kw = dict(moe_capacity_factor=cf, **({"moe_group_size": group} if group else {}))
    lm.TransformerLM = functools.partial(saved[0], **kw)
    train.TransformerLM = functools.partial(saved[1], **kw)
    try:
        yield
    finally:
        lm.TransformerLM, train.TransformerLM = saved


@contextlib.contextmanager
def recorded_slots(store: list):
    """While the block runs, every ``moe.slots`` call appends its kept
    (token, choice) mask to ``store``."""
    from repro_torch.models import moe

    inner = moe.slots

    def recording(*args):
        slot, kept = inner(*args)
        store.append(kept)
        return slot, kept

    moe.slots = recording
    try:
        yield
    finally:
        moe.slots = inner


def moe_train_cfg(arch: str):
    """Phase 13c's config: the reduced ``arch`` in fp32 (mixtral's window
    cut to 8, so that it masks)."""
    import dataclasses

    from repro_torch.configs import get_arch

    kw = dict(window=8) if arch == MX_ARCH else {}
    return dataclasses.replace(get_arch(arch, reduced=True), dtype="float32", **kw)


def moe_pretrain_cli(arch: str) -> list:
    return ["--mode", "pretrain", "--arch", arch, "--silos", "4", "--participants", "2",
            "--rounds", "2", "--local-steps", "1", "--batch", "2", "--seq", str(MOE_TRAIN_SEQ)]


def moe_train_half(dev: str) -> dict:
    """Phase 13c's runs on ``dev``, by (arch, capacity factor, group): for
    each reduced MoE model (``moe_train_cfg``) at each routing of
    ``MOE_ROUTINGS``, a per-sequence forward of 4 sequences of 40 tokens
    (each layer's router probabilities, expert ids and kept pairs, and each
    sequence's loss), one FLrce round of the full-model ``LMClassifier`` on
    each engine, one LoRA FLrce round (batched engine), and ``launch.train
    --mode pretrain`` for 2 rounds."""
    import dataclasses

    import torch

    from repro_torch.data import make_federated_lm
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.launch import train
    from repro_torch.models import LMClassifier, LoRAClassifier

    out = {}
    for arch in (MX_ARCH, DBRX_ARCH):
        cfg = moe_train_cfg(arch)
        base = LMClassifier(cfg, seq_len=MOE_TRAIN_SEQ)
        host = base.init(0, "cpu")
        params = {k: v.to(dev) for k, v in host.items()}
        gen = torch.Generator().manual_seed(3)
        x = torch.randint(0, cfg.vocab_size, (4, MOE_TRAIN_SEQ), generator=gen).float()
        y = torch.randint(0, cfg.vocab_size, (4,), generator=gen)
        ds = make_federated_lm(num_clients=6, samples_per_client=8, seq_len=MOE_TRAIN_SEQ,
                               vocab_size=cfg.vocab_size, num_eval=16, seed=0)
        kw = dict(max_rounds=1, learning_rate=0.05, batch_size=4, seed=0, torch_device=dev)
        dim = sum(v.numel() for v in host.values())
        for cf, group in MOE_ROUTINGS:
            with moe_routing(cf, group):
                probs, kept = [], []
                with recorded_routes(probs), recorded_slots(kept), torch.no_grad():
                    losses = base.per_example_loss(params, x.to(dev), y.to(dev)).cpu()
                routes = [(p.cpu(), ids.cpu(), k.cpu()) for (p, ids), k in zip(probs, kept)]
                runs = {engine: run_federated(base, ds, FLrce(6, 3, 1, dim=dim, seed=0),
                                              init_params=host, engine=engine, **kw)
                        for engine in ("batched", "sequential")}
                lora = LoRAClassifier(base, params, rank=4)
                runs["LoRA"] = run_federated(
                    lora, ds, FLrce(6, 3, 1, dim=lora.adapter_dim(), seed=0), **kw)
                get = train.get_arch
                train.get_arch = lambda name, reduced=False: dataclasses.replace(
                    get(name, reduced=reduced), dtype="float32")
                try:
                    hist = train.run_pretrain_mode(train.build_parser().parse_args(
                        moe_pretrain_cli(arch) + ["--device", dev]))["history"]
                finally:
                    train.get_arch = get
            for run in runs.values():
                run.final_params = {k: v.cpu() for k, v in run.final_params.items()}
            out[(arch, cf, group)] = {"routes": routes, "losses": losses, "runs": runs,
                                      "hist": hist}
    return out


def moe_train_reference_check(torch, worker) -> None:
    """Phase 13c: ``moe_train_half`` on the card against the CPU (the CPU
    worker's): expert ids and kept (token, choice) pairs equal wherever a
    token's gap between its k-th and (k+1)-th router probability is
    ``MOE_TIE_GAP`` or more, each sequence's loss within
    ``MOE_TRAIN_RTOL``; the FLrce rounds and the pretrain rounds with equal
    selections, exploit flags and ledger, losses within 1e-4 and accuracy
    within 2e-3; capacity factor 0.5 drops pairs on both."""
    t_phase = time.perf_counter()
    card = moe_train_half("cuda")
    cpu = cpu_half(worker, "13c")
    for key, got in card.items():
        want = cpu[key]
        arch, cf, group = key
        label = f"{arch} at capacity factor {cf}, groups of {group or 'a sequence'}"
        n_tokens = n_ties = n_dropped = 0
        min_gap = float("inf")
        for (pg, ig, kg), (pw, iw, kw_) in zip(got["routes"], want["routes"]):
            k = iw.shape[1]
            top = pw.sort(dim=-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            clear = gap >= MOE_TIE_GAP
            min_gap = min(min_gap, float(gap.min()))
            n_tokens += len(gap)
            n_ties += int((~clear).sum())
            n_dropped += int((~kw_).sum())
            if not (torch.equal(ig[clear], iw[clear]) and torch.equal(kg[clear], kw_[clear])):
                fail(f"small {label}: the card's expert ids or kept pairs differ from the CPU's at "
                     f"tokens clear of a tie")
        if len(got["routes"]) != len(want["routes"]) or not got["routes"]:
            fail(f"{label}: {len(got['routes'])} routed layers on the card, "
                 f"{len(want['routes'])} on the CPU")
        if cf < 1 and not n_dropped:
            fail(f"{label}: nothing dropped")
        rel = float(((got["losses"] - want["losses"]).abs() / want["losses"].abs()).max())
        if rel > MOE_TRAIN_RTOL:
            fail(f"{label}: per-sequence losses {rel:.2e} relative apart (limit "
                 f"{MOE_TRAIN_RTOL:.0e})")
        for name, run in got["runs"].items():
            compare_runs(f"{label}, {name} FLrce", run, want["runs"][name])
        for a, b in zip(got["hist"], want["hist"]):
            if [a[f] for f in ("round", "silos", "exploit", "stopped", "conflicts")] != \
                    [b[f] for f in ("round", "silos", "exploit", "stopped", "conflicts")] or \
                    not abs(a["mean_loss"] - b["mean_loss"]) <= 1e-4:
                fail(f"{label}, pretrain: card and CPU rounds differ: {a} vs {b}")
        if len(got["hist"]) != len(want["hist"]) or len(got["hist"]) != 2:
            fail(f"{label}, pretrain: {len(got['hist'])} / {len(want['hist'])} rounds")
        print(f"  small {label}: routes equal at {n_tokens - n_ties} of {n_tokens} (token, layer) "
              f"pairs clear of a tie (smallest top-k gap {min_gap:.2e}), {n_dropped} (token, "
              f"choice) pairs dropped on both; per-sequence losses {rel:.2e} relative; pretrain "
              f"2 rounds equal, losses {[round(r['mean_loss'], 5) for r in got['hist']]}")
    print(f"  phase 13c wall {time.perf_counter() - t_phase:.1f} s")


# ``--decode-variants``: csrc/decode_attention.cu with these substitutions,
# each built into its own library and timed at the decode shapes.  Slots x
# slot bytes per warp; "split only" skips the last block's combine (its
# outputs are wrong); "empty" returns at once on the same grid.
_RING = ("constexpr int kStages = 2;", "constexpr int kWarpRingBytes = 8 * 1024;")


def _ring(stages: int, kib: int) -> list:
    return [(_RING[0], f"constexpr int kStages = {stages};"),
            (_RING[1], f"constexpr int kWarpRingBytes = {kib} * 1024;")]


DECODE_VARIANTS = {
    "2 x 4 KB (as built)": [],
    "3 x 4 KB": _ring(3, 12),
    "4 x 4 KB": _ring(4, 16),
    "8 x 4 KB": _ring(8, 32),
    "4 x 2 KB": _ring(4, 8),
    "2 x 4 KB, 32-row floor": [("constexpr int kMinRows = 64;", "constexpr int kMinRows = 32;")],
    "2 x 4 KB, one thread fences": [(
        "  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0) *last_flag",
        "  __syncthreads();\n  if (threadIdx.x == 0) __threadfence();\n  if (threadIdx.x == 0) *last_flag")],
    "2 x 4 KB, one row a rescale at G = 5": [("g <= 5 ? 2 : 1;", "g <= 4 ? 2 : 1;")],
    "2 x 4 KB, __expf": [("const float alpha = expf(", "const float alpha = __expf("),
                         ("const float p = expf(", "const float p = __expf(")],
    "2 x 4 KB, split only": [("  if (!*last_flag) return;", "  return;")],
    "2 x 4 KB, empty": [("  const int split = blockIdx.x, k = blockIdx.y / n_sub, b = blockIdx.z;",
                         "  if (S > 0) return;\n"
                         "  const int split = blockIdx.x, k = blockIdx.y / n_sub, b = blockIdx.z;")],
}


def build_variants(variants: list, show: tuple = ()) -> list:
    """Build one kernel library per variant, a (source name, [(old, new)])
    pair: that source with the substitutions, linked with the other sources
    as they are.  Every compile runs at once; the ``ptxas`` lines of the
    kernel instances named in ``show`` are printed for each variant.
    Returns the libraries' paths in variant order."""
    from repro_torch.kernels import build

    work = build.BUILD_ROOT / f"variants-{build.source_hash()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()

    def compile_cmd(src, flags, obj):
        return [nvcc, *build.NVCC_FLAGS, *flags, f"-I{build.CSRC}", "-c", str(src), "-o",
                str(obj)]

    units = build.compile_units()
    originals = [(src, work / f"{stem}.o") for src, _, stem in units]
    cmds = [compile_cmd(build.CSRC / src, flags, work / f"{stem}.o") for src, flags, stem in units]
    objs = []                    # each variant's objects: its source's units
    for i, (name, subs) in enumerate(variants):
        text = (build.CSRC / name).read_text()
        for old, new in subs:
            if old not in text:
                fail(f"{name} variant {i}: {old!r} not in the source")
            text = text.replace(old, new)
        (work / f"variant_{i}.cu").write_text(text)
        objs.append([])
        for src, flags, stem in units:
            if src == name:
                objs[i].append(work / f"variant_{i}.{stem}.o")
                cmds.append(compile_cmd(work / f"variant_{i}.cu", flags, objs[i][-1]))
    t0 = time.perf_counter()
    logs = build._run_all(cmds)[len(originals):]
    logs = ["\n".join(logs[sum(map(len, objs[:i])):sum(map(len, objs[:i + 1]))])
            for i in range(len(variants))]
    for i, log in enumerate(logs):
        for line in ptxas_summary(log):
            if line.startswith(show):
                print(f"  variant {i} ptxas: {line}")
    libs = [work / f"lib_{i}.so" for i in range(len(variants))]
    build._run_all([[nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs[i]),
                     *(str(obj) for src, obj in originals if src != variants[i][0])]
                    for i, lib in enumerate(libs)])
    print(f"  {len(variants)} kernel variants built in {time.perf_counter() - t0:.1f} s")
    return libs


# ``--kernel-variants``: csrc/topk_mask.cu and csrc/gram.cu with these
# substitutions, timed at the main shape.  "no select" keeps every finite
# value (its outputs are wrong): the walk, loads and stores alone;
# "warp-aggregated" adds one per distinct digit of a warp (__match_any_sync)
# in place of one per element; "no gather" runs all four digit passes;
# "split pass alone" skips the last block's sum of the splits; "stream
# only" drops gram's FMAs; "empty" returns at once on the same grid.
KERNEL_VARIANTS = [
    ("topk_mask.cu", "as built", []),
    ("topk_mask.cu", "no select", [("  for (int pass = 0; pass < 4; ++pass) {",
                                    "  for (int pass = 0; pass < 0; ++pass) {")]),
    ("topk_mask.cu", "warp-aggregated", [(
        "      if ((mag[i] >> high) == (prefix >> high)) atomicAdd(&hist[(mag[i] >> shift) & mask], 1u);",
        "      const bool match = (mag[i] >> high) == (prefix >> high);\n"
        "      const uint32_t digit = (mag[i] >> shift) & mask;\n"
        "      const unsigned peers = __match_any_sync(kFull, match ? digit : kAbsent);\n"
        "      if (match && (threadIdx.x & 31) == __ffs(peers) - 1) "
        "atomicAdd(&hist[digit], __popc(peers));")]),
    ("topk_mask.cu", "no gather", [("    if ((pass == 1 || pass == 2) && count <= kGather) {",
                                    "    if (false) {")]),
    ("topk_mask.cu", "first pass only", [("  for (int pass = 0; pass < 4; ++pass) {",
                                          "  for (int pass = 0; pass < 1; ++pass) {")]),
    ("topk_mask.cu", "empty", [("  __shared__ __align__(16) uint32_t hist[kBins];",
                                "  if (total > 0) return;\n"
                                "  __shared__ __align__(16) uint32_t hist[kBins];")]),
    ("gram.cu", "as built", []),
    ("gram.cu", "split pass alone", [("  if (!last) return;", "  return;")]),
    ("gram.cu", "stream only", [("    add_products<PT, N>(x, acc);",
                                 "    if (x[0][0] == 12345.0f) acc[0] += x[PT - 1][1];")]),
    ("gram.cu", "2 stages", [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    ("gram.cu", "8 stages", [("constexpr int kStages = 4;", "constexpr int kStages = 8;")]),
    ("gram.cu", "empty", [("  __shared__ float red[WARPS][N];",
                           "  if (D > 0) return;\n  __shared__ float red[WARPS][N];")]),
]


def kernel_variants(torch, timer, bandwidth) -> None:
    """Time each of KERNEL_VARIANTS at the main shape (P = 10, D = 595,914;
    topk_mask_rows at keep_frac 0.1), beside the bound."""
    import ctypes

    from repro_torch.kernels import build, grid
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import topk_mask as ktopk

    libs = build_variants([(name, subs) for name, _, subs in KERNEL_VARIANTS],
                          show=("topk_mask_kernel<Li8ELi2>", "gram_tri_kernel<Li12E"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn(K_MAIN, D_MAIN, generator=gen, device="cuda")
    # every magnitude in [1, 2): one exponent, so the first pass's lanes crowd
    one_exp = (1.0 + torch.rand(K_MAIN, D_MAIN, generator=gen, device="cuda")) * torch.where(
        torch.rand(K_MAIN, D_MAIN, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    calls = {"topk_mask.cu": (lambda: ktopk.topk_mask_rows_cuda(u, keep_frac=0.1),
                              8 * K_MAIN * D_MAIN, "topk_mask_rows"),
             "gram.cu": (lambda: kgram.gram_cuda(u), 4 * (K_MAIN * D_MAIN + K_MAIN * K_MAIN), "gram")}

    def reset():
        ktopk._occupancy.cache_clear()
        kgram._tri_occupancy.cache_clear()
        kgram._gram_plan.cache_clear()
        for counters in grid.ARRIVALS.values():
            counters.zero_()

    lib = build.library()
    want = {name: fn() for name, (fn, _, _) in calls.items()}
    try:
        for path, (name, label, _) in zip(libs, KERNEL_VARIANTS):
            build._LIB = ctypes.CDLL(str(path))
            build._declare(build._LIB)
            reset()
            fn, nbytes, kernel = calls[name]
            if label == "as built":
                check_bitwise(f"{kernel} variant {label}", fn(), want[name], torch)
            ms = timer(fn)
            bound = nbytes / bandwidth * 1e3
            crowded = ""
            if name == "topk_mask.cu":
                crowded = (f"; one-exponent input "
                           f"{timer(lambda: ktopk.topk_mask_rows_cuda(one_exp, keep_frac=0.1)):.4f} ms")
            print(f"  {kernel:<15} {label:<17} {ms:.4f} ms  bound {bound:.4f} ms "
                  f"({100 * bound / ms:.1f}%){crowded}")
    finally:
        build._LIB = lib
        reset()


# ``--time-kernels``' cross_gram shapes (K, Q, D): the main path, the async
# round (and its gram at P = 30), K = 17 and 64, the fleet's Q = 1,000, and
# the LoRA phases' ingests on gemma3-4b and recurrentgemma-2b
CROSS_TIMED = [(K_MAIN, Q_MAIN, D_MAIN), (30, Q_MAIN, D_MAIN), (30, 30, D_MAIN), (17, Q_MAIN, D_MAIN),
               (64, Q_MAIN, D_MAIN), (K_MAIN, 1000, D_MAIN), (4, 16, 14_901_248),
               (4, 16, 3_258_656)]


def time_kernels(torch, timer, bandwidth) -> None:
    """gram and topk_mask_rows at the main shape, each held against its plain
    version first, beside their library calls, then cross_gram (and gram
    where K = Q) at ``CROSS_TIMED``: the measurement that compares two source
    trees (``--src``) in one call."""
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import topk_mask as ktopk

    u = torch.randn(K_MAIN, D_MAIN, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    padded = torch.nn.functional.pad(u, (0, (-D_MAIN) % 2048)).reshape(-1, 2048)
    check_gram("gram", kgram.gram_cuda(u), kgram.gram_plain(u), u, u, torch)
    check_bitwise("topk_mask_rows", ktopk.topk_mask_rows_cuda(u, keep_frac=0.1),
                  ktopk.topk_mask_rows_plain(u, keep_frac=0.1), torch)
    for name, fn, nbytes, lib_name, lib_fn in (
            ("gram", lambda: kgram.gram_cuda(u), 4 * (K_MAIN * D_MAIN + K_MAIN * K_MAIN),
             "torch.mm", lambda: torch.mm(u, u.t())),
            ("topk_mask_rows", lambda: ktopk.topk_mask_rows_cuda(u, keep_frac=0.1),
             8 * K_MAIN * D_MAIN, "torch.topk+torch.where", lambda: topk_route(torch, padded, 205))):
        ms, lib_ms, warm_ms = timer(fn), timer(lib_fn), timer(fn, flush=False)
        bound = nbytes / bandwidth * 1e3
        print(f"  {name:<15} P={K_MAIN} D={D_MAIN}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%), {lib_name} {lib_ms:.4f} ms; with L2 warm "
              f"{warm_ms:.4f} ms")
    print(f"  reading u ({4 * K_MAIN * D_MAIN / 1e6:.1f} MB) once, torch.sum: "
          f"{timer(lambda: u.sum()):.4f} ms")
    del u, padded
    gen = torch.Generator(device="cuda").manual_seed(1)
    for k, q, d in CROSS_TIMED:
        u = torch.randn(k, d, generator=gen, device="cuda")
        v = torch.randn(q, d, generator=gen, device="cuda")
        check_gram(f"cross_gram K={k} Q={q} D={d}", kgram.cross_gram_cuda(u, v),
                   kgram.cross_gram_plain(u, v), u, v, torch)
        ms, mm_ms = timer(lambda: kgram.cross_gram_cuda(u, v)), timer(lambda: torch.mm(u, v.t()))
        nbytes, flops = 4 * (k * d + q * d + k * q), 2 * k * q * d
        bound = max(nbytes / bandwidth, flops / FP32_PEAK_FLOPS) * 1e3
        print(f"  cross_gram      K={k} Q={q} D={d}: kernel {ms:.4f} ms, torch.mm {mm_ms:.4f} ms "
              f"({ms / mm_ms:.3f}x), bound {bound:.4f} ms ({100 * bound / ms:.1f}%)")
        if k == q:
            ms, mm_ms = timer(lambda: kgram.gram_cuda(u)), timer(lambda: torch.mm(u, u.t()))
            bound = max(4 * (k * d + k * k) / bandwidth, 2 * k * k * d / FP32_PEAK_FLOPS) * 1e3
            print(f"  gram            P={k} D={d}: kernel {ms:.4f} ms, torch.mm {mm_ms:.4f} ms "
                  f"({ms / mm_ms:.3f}x), bound {bound:.4f} ms ({100 * bound / ms:.1f}%)")
        del u, v
        torch.cuda.empty_cache()


def numerics(torch) -> None:
    """``--numerics``: where the FL path's float32 results part from float64
    and from each other at the CIFAR width, behind three choices of the port:
    the card's patch convolution, Eq. 6 from r = w − a, and how phase 2c
    holds the two engines against each other."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from torch.func import grad, vmap

    from repro_torch.core import relationship
    from repro_torch.core.distributed import flatten_params
    from repro_torch.data import make_image_like
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.fl.client import (BatchedCohortTrainer, ClientTrainer, build_cohort_plan,
                                       client_batch_rng)
    from repro_torch.models import PaperCNN, cnn

    ds = make_image_like(num_clients=100, alpha=0.1, num_samples=40_000, num_eval=4_000, side=32,
                         channels=3, num_classes=10, seed=0)
    model = PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    params = model.init(0, "cuda")
    ids = [c for c in range(100) if len(ds.client_indices[c]) >= 32][:10]
    xs = torch.stack([torch.from_numpy(ds.client_data(c)[0][:32]) for c in ids]).cuda()
    ys = torch.stack([torch.from_numpy(ds.client_data(c)[1][:32]) for c in ids]).cuda().long()

    def loss(p, x, y):
        return F.cross_entropy(model.logits(p, x), y)

    def cudnn_conv(w_hwio, b, h_nhwc):
        return F.conv2d(h_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b,
                        padding=2).permute(0, 2, 3, 1)

    # (1) one local step's gradient, one client and vmapped over ten
    truth = grad(loss)({k: v.double() for k, v in params.items()}, xs[0].double(), ys[0])
    stacked = {k: v.expand(len(ids), *v.shape).contiguous() for k, v in params.items()}
    patch = cnn.patch_conv2d
    rows = {}
    for label, conv in (("cuDNN conv2d", cudnn_conv), ("patch GEMM", patch)):
        cnn.patch_conv2d = conv
        one = grad(loss)(params, xs[0], ys[0])
        many = vmap(grad(loss))(stacked, xs, ys)
        step_ms = Timer(torch)(lambda: vmap(grad(loss))(stacked, xs, ys), iters=10)
        rows[label] = (one, many, step_ms)
    cnn.patch_conv2d = patch
    print(f"  one SGD gradient of the CIFAR CNN (32 images), max |Δ| / max|g| against float64:")
    for name in ("conv1.w", "conv2.w", "fc.0.w", "fc.2.w"):
        scale = float(truth[name].abs().max())
        print(f"    {name:8s}" + "".join(
            f"  {label}: one client {float((one[name].double() - truth[name]).abs().max()) / scale:.1e},"
            f" vmapped over ten {float((many[name][0].double() - truth[name]).abs().max()) / scale:.1e};"
            for label, (one, many, _) in rows.items()))
    print("  the vmapped gradient of 10 clients x 32 images (CUDA events, median of 10): "
          + ", ".join(f"{label} {ms:.2f} ms" for label, (_, _, ms) in rows.items()))

    # (2) Eq. 6 in fp32 on a real trajectory, expanded as the reference writes
    # it (ww - 2aw + aa) and from r = w - a, each against float64
    def direct64(ids_, u, w, v, a, last, t, om):
        u, w, v, a = u.double(), w.double(), v.double(), a.double()
        r = w[None, :] - a
        dots = (u @ v.T, u @ r.T, (v * v).sum(1), (r * v).sum(1), (r * r).sum(1))
        return relationship.rows_from_relationship_dots(ids_, dots, last, t, om.double())

    inner = relationship.relationship_block
    errors = []

    def spy(ids_, u, w, v, a, last, t, om):
        got = inner(ids_, u, w, v, a, last, t, om)
        stale = (last >= 0) & (last < t - 1)
        if bool(stale.any()):
            want = direct64(ids_, u, w, v, a, last, t, om)[:, stale]
            errors.append((t, int(stale.sum()),
                           float((expanded_block(ids_, u, w, v, a, last, t, om)[:, stale].double() - want).abs().max()),
                           float((got[:, stale].double() - want).abs().max())))
        return got

    relationship.relationship_block = spy
    try:
        run_federated(model, ds, FLrce(100, 10, 2, dim=D_MAIN, es_threshold=5.0, explore_decay=0.5,
                                       seed=0),
                      max_rounds=6, learning_rate=MAIN_LR, batch_size=32, seed=0, init_params=params,
                      torch_device="cuda")
    finally:
        relationship.relationship_block = inner
    print("  Eq. 6 entries (clients last seen before t - 1) against float64, main path, M=100: "
          + "; ".join(f"t={t} ({n} clients): expanded {e:.1e}, from r = w - a {d:.1e}"
                      for t, n, e, d in errors))

    # (3) the batched and the sequential engine on round 0's cohort, by the
    # number of local steps; then, over the whole round, the sequential
    # engine with a planted fault, read by phase 2c's norm check
    rids = [16, 27, 34, 38, 56, 61, 73, 76, 79, 86]
    plan = build_cohort_plan([ds.client_data(c) for c in rids], [2] * 10, 32,
                             [client_batch_rng(0, 0, c) for c in rids])
    batched = BatchedCohortTrainer(model, MAIN_LR, 32, "cuda")

    def sequential(sub, fault=None):
        us = []
        for k in range(10):
            p = params
            for s in range(int(sub.step_valid[k].sum())):
                n = int(sub.sample_w[k, s].sum())
                lr = MAIN_LR * (1.01 if fault == "lr" else 1.0)
                if n < 32 and fault == "dropped":
                    continue
                if n < 32 and fault == "weighted":
                    lr *= n / 32
                p, _ = ClientTrainer(model, lr, 32, "cuda")._step(
                    p, params, torch.from_numpy(sub.x[k, s, :n]).cuda(),
                    torch.from_numpy(sub.y[k, s, :n]).cuda().long(), None, None, 0.0)
            us.append(flatten_params({n2: p[n2] - params[n2] for n2 in p})[0])
        return torch.stack(us)

    def norm_ratio(us, ub):
        return float((torch.linalg.vector_norm(us - ub, dim=1) / torch.linalg.vector_norm(ub, dim=1)).max())

    partial = (plan.sample_w.sum(2) % 32 > 0) & (plan.step_valid > 0)
    print(f"  round 0's cohort {rids}: valid steps {plan.step_valid.sum(1).astype(int).tolist()}, "
          f"partial batches {partial.sum(1).tolist()}")
    for steps in sorted({s for s in (1, 2, 4, 8, 16, 32) if s < plan.num_steps} | {plan.num_steps}):
        sub = dataclasses.replace(plan, x=plan.x[:, :steps], y=plan.y[:, :steps],
                                  sample_w=plan.sample_w[:, :steps],
                                  step_valid=plan.step_valid[:, :steps])
        ub, _ = batched.train_cohort(params, sub, prox_mus=[0.0] * 10, masks=[None] * 10,
                                     freeze_fracs=[0.0] * 10)
        us = sequential(sub)
        _, err, n_beyond = update_gap(torch, us, ub)
        print(f"    {steps:3d} local steps: max |Δ| {err:.2e} (max|U| {float(ub.abs().max()):.3e}), "
              f"‖ΔU_k‖/‖U_k‖ ≤ {norm_ratio(us, ub):.2e}, {n_beyond} of {us.numel()} elements beyond "
              f"the reference's tolerance")
    faults = (("a partial batch weighted as a full one", "weighted"),
              ("partial batches dropped", "dropped"), ("the learning rate 1% high", "lr"))
    print("  the whole round with a planted fault in the sequential engine, max_k ‖ΔU_k‖/‖U_k‖ "
          f"(phase 2c fails above {ROUND_NORM_RTOL:.0e}): "
          + "; ".join(f"{label} {norm_ratio(sequential(plan, fault), ub):.2e}" for label, fault in faults))


def topk_route(torch, padded, k: int):
    """The top-k mask of the zero-padded (tiles, block_d) view by two PyTorch
    calls (``torch.topk``, ``torch.where``): the library route it is timed
    against (the padding is not timed)."""
    mag = padded.abs()
    kth = torch.topk(mag, k, dim=1).values[:, k - 1:]
    return torch.where(mag >= kth, padded, 0.0)


def decode_variants(torch, timer, bandwidth) -> None:
    """Time each of DECODE_VARIANTS at the three decode shapes, an S sweep
    (B = 8, K = 4, G = 2, hd = 256, bf16) and recurrentgemma-2b's ring layer
    (K = 1, G = 10), beside SDPA; the variants that compute the function
    are held against the plain version first."""
    import ctypes

    from repro_torch.kernels import build, grid
    from repro_torch.kernels import decode_attention as kdec

    libs = build_variants([("decode_attention.cu", subs) for subs in DECODE_VARIANTS.values()],
                          show=("decode_attention_kernel<13__nv_bfloat16Li256ELi2>",
                                "decode_attention_kernel<13__nv_bfloat16Li256ELi5>"))

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [("global", SERVE_B, SERVE_CACHE, SERVE_CACHE, 0, False, 4, 2),
              ("ring", SERVE_B, 1024, SERVE_CACHE, 1024, True, 4, 2),
              ("32k", 16, 32_768, 32_768, 0, False, 4, 2),
              ("rg ring", RG_B, RG_WINDOW, RG_STEPS, RG_WINDOW, True, 1, RG_GROUP)]
    shapes += [(f"S={s}", SERVE_B, s, s, 0, False, 4, 2) for s in (64, 256, 512, 3200, 6400)]
    inputs = {label: decode_inputs(torch, gen, b, s, kv, g, 256, "bf16", [length] * b)
              for label, b, s, length, _, _, kv, g in shapes}
    sdpa = {label: timer(sdpa_call(torch, *inputs[label][:3])[0]) for label, *_ in shapes}
    lib, min_rows = build.library(), kdec._MIN_ROWS
    try:
        for i, name in enumerate(DECODE_VARIANTS):
            build._LIB = ctypes.CDLL(str(libs[i]))
            build._declare(build._LIB)
            kdec._occupancy.cache_clear()
            kdec._plan.cache_clear()
            kdec._MIN_ROWS = 32 if "32-row" in name else min_rows
            for counters in grid.ARRIVALS.values():
                counters.zero_()
            print(f"  variant {name}")
            for label, b, s, length, window, ring, kv, g in shapes:
                q, k, v, lens = inputs[label]
                fn = lambda: kdec.decode_attention_cuda(q, k, v, lens, window=window, ring=ring)  # noqa: E731
                if "split only" not in name and "empty" not in name:
                    check_decode(f"{name} {label}", fn(), kdec.decode_attention_plain(
                        q.float(), k.float(), v.float(), lens, window=window, ring=ring), v, torch)
                plan = kdec.launch_plan(q, k, window=window, ring=ring)
                ms = timer(fn)
                bound = (2 * b * min(length, s) * kv * 256 * 2 + 2 * q.numel() * 2) / bandwidth * 1e3
                print(f"    {label:<7} grid {plan.grid}, {plan.blocks_per_sm} blocks/SM, "
                      f"{plan.smem_bytes} B: {ms:.4f} ms, bound {bound:.4f} ms "
                      f"({100 * bound / ms:.1f}%), SDPA {sdpa[label]:.4f} ms")
    finally:
        build._LIB, kdec._MIN_ROWS = lib, min_rows
        kdec._occupancy.cache_clear()
        kdec._plan.cache_clear()
        for counters in grid.ARRIVALS.values():
            counters.zero_()


# ---------------------------------------------------------------------------
# phase 6: federated LoRA fine-tuning of gemma3-4b at full width
# ---------------------------------------------------------------------------
LORA_ARCH, LORA_RANK, LORA_SEQ = "gemma3-4b", 8, 128
LORA_M, LORA_N, LORA_P, LORA_EVAL, LORA_BATCH = 16, 32, 4, 64, 8
# the base models at full width, depth cut to keep the smoke within its
# time (a LoRA round is host-bound, its work in proportion to the layers):
# gemma3-4b 6 of 34 layers (a whole cycle: 5 local, 1 global),
# recurrentgemma-2b 5 of 26 (a cycle and the 2 rest layers), xlstm-1.3b 8
# of 48 (a cycle of 7 mLSTM and 1 sLSTM blocks); every block kind and leaf
# of the full model stays
LORA_LAYERS, RG_LORA_LAYERS, XL_LORA_LAYERS = 6, 5, 8
LORA_D = 2_629_632           # rank-8 adapters on gemma3-4b's 42 target leaves
RG_LORA_D = 434_240          # rank-8 adapters on recurrentgemma-2b's 11 stacked target leaves
XL_LORA_D = 1_466_480        # rank-8 adapters on xlstm-1.3b's 36 stacked target leaves
# phase 9 trains each client's 32 sequences as one batch: a client step's
# host work (the sLSTM loop's autograd graph, 128 steps x 6 layers, and its
# recomputation) does not grow with the batch, and at 4 steps a client a
# round a round took 65-82 s on the card
XL_LORA_BATCH = 32
LORA_LR = 0.01
LORA_KEEP = 0.1              # Fedcom's keep fraction
# phases 13 and 13b: the MoE models at full width, depth cut to the most
# layers whose LoRA round's measured peak stays under MOE_LORA_PEAK (the
# frozen base, the merged copy of every target leaf and one stacked expert
# leaf's fp32 merge are live at once); rank 8 adapts each layer's attention
# (311,296) and its experts' wi, wg and wo (3·E·8·(d + f))
MX_LORA_LAYERS, DBRX_LORA_LAYERS = 4, 3
MX_LORA_D = 4 * 4_636_672      # 18,546,688
DBRX_LORA_D = 3 * 6_799_360    # 20,398,080
MOE_LORA_PEAK = 72 * 2**30
# (d)'s depth for a model with experts: its fp32 engines and float64 referee
# (dbrx-132b's 4.49 B parameters at one layer: 18 GB in fp32 beside the
# referee's 36 GB of float64 merged weights and embeddings)
MOE_REFEREE_LAYERS = 1
# the runs' depth, cut to keep the smoke within its time: FLrce exploits in
# round 2 (its check needs one exploit round); FedAvg and Fedcom launch
# their kernels every round
LORA_ROUNDS, LORA_BASELINE_ROUNDS = 3, 1
# device time by group in the profiled rounds: a kernel counts for the group
# of the annotated call that launched it (forward, or its backward through
# the autograd sequence number, or its recomputation under remat); GEMMs
# outside every annotation are the model's projections and unembedding



def lora_phase(torch, timer, bandwidth, arch=LORA_ARCH, want_dim=LORA_D, tag="6",
               batch=LORA_BATCH, layers=LORA_LAYERS) -> tuple:
    """Phase 6 (gemma3-4b), 7 (recurrentgemma-2b), 9 (xlstm-1.3b), 13
    (mixtral-8x22b) and 13b (dbrx-132b): FLrce, FedAvg and Fedcom over
    rank-8 LoRA adapters on the full-width bf16 model ``arch`` at ``layers``
    of its layers, with checks (a) to (d), the kernels at the phase's own
    operands, and a profile of FedAvg's round (its wall then includes the
    profiler's overhead); ``batch`` sequences a local step.  For a model
    with experts the FLrce job runs twice (equal selections, round 0's
    update bitwise), its peak must stay under ``MOE_LORA_PEAK``, and (d)
    holds each engine, at one layer, against its own function in float64
    (``moe_first_step_check``), the two engines' functions being
    different."""
    import numpy as np

    from repro_torch.data import make_federated_lm
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.fl.baselines import FedAvg, Fedcom
    from repro_torch.kernels import ops
    from repro_torch.kernels import threefry as ktf
    from repro_torch.models import LMClassifier, LoRAClassifier
    from repro_torch.models.lm import lm_from_flat

    t_phase = time.perf_counter()
    cfg = cut_config(arch, layers)
    base = LMClassifier(cfg, seq_len=LORA_SEQ)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    base_params = base.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_base = sum(p.numel() for p in base_params.values())
    print(f"  base {cfg.name}: {n_base:,} parameters ({cfg.dtype}), {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {len(base_params)} leaves, drawn on the card in "
          f"{init_s:.1f} s")
    init_leaf_check(torch, cfg, lm_from_flat(cfg, base_params), 0, ops.launch_counts())
    lora = LoRAClassifier(base, base_params, rank=LORA_RANK)
    dim = lora.adapter_dim()
    n_targets = len({base for _, base, factor in lora.adapter_leaves() if factor is not None})
    if dim != want_dim:
        fail(f"LoRA adapter dim {dim} != {want_dim}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    adapters = lora.init(0, "cuda")
    torch.cuda.synchronize()
    adapter_s = time.perf_counter() - t0
    adapter_launches = ops.launch_counts()["threefry_normal"]
    a_keys = lora.a_keys(0)
    rng = np.random.default_rng(0)
    for name, key in a_keys.items():
        a = adapters[name].reshape(-1)
        index = torch.from_numpy(rng.choice(a.numel(), min(a.numel(), INIT_SAMPLES),
                                            replace=False)).cuda()
        root = torch.tensor(float(np.sqrt(np.float32(adapters[name].shape[-2]))), device="cuda")
        want = ktf.normal_plain(key, index=index, device="cuda") / root
        if not torch.equal(a[index].view(torch.int32), want.view(torch.int32)):
            fail(f"LoRA init: adapter {name} differs from the reference's draw")
    if adapter_launches != len(a_keys):
        fail(f"LoRA init: {adapter_launches} Threefry launches for {len(a_keys)} A factors")
    print(f"  LoRA rank {LORA_RANK}: D = {dim:,} over {n_targets} target leaves; adapters drawn "
          f"on the card ({adapter_launches} Threefry launches) in {adapter_s:.3f} s, each A at "
          f"{INIT_SAMPLES} sampled indices bitwise the plain version's draw of its key; V and A "
          f"{LORA_M * dim * 4 / 1e9:.2f} GB each")
    t0 = time.perf_counter()
    ds = make_federated_lm(num_clients=LORA_M, samples_per_client=LORA_N, seq_len=LORA_SEQ,
                           vocab_size=cfg.vocab_size, num_eval=LORA_EVAL, seed=0)
    print(f"  data: {LORA_M} x {LORA_N} + {LORA_EVAL} sequences of {LORA_SEQ} tokens at vocab "
          f"{cfg.vocab_size:,} made on the host in {time.perf_counter() - t0:.2f} s")

    # (a) B = 0: the merged model is the base model, logits bitwise
    tokens = torch.from_numpy(ds.eval_x[:4]).cuda().long()
    with torch.no_grad():
        want = base.lm.forward(lm_from_flat(cfg, base_params), {"tokens": tokens})
        got = base.lm.forward(lm_from_flat(cfg, lora.merge(adapters)), {"tokens": tokens})
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got.view(torch.int16),
                                                      want.view(torch.int16)):
            fail("(a) the merged model's logits at B = 0 differ from the base model's")
    print(f"  (a) merged logits at B = 0 equal the base model's bitwise on 4 eval sequences "
          f"{tuple(got.shape)} {got.dtype}")
    del want, got

    # the main path: FLrce, the counts reset just before and read just after
    strategy = FLrce(LORA_M, LORA_P, 1, dim=dim, explore_decay=0.5, seed=0)
    u0 = capture_round0(strategy)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_federated(lora, ds, strategy, max_rounds=LORA_ROUNDS, learning_rate=LORA_LR,
                        batch_size=batch, seed=0, init_params=adapters, verbose=True,
                        torch_device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches("LoRA FLrce", launches, res)
    lora_checks("LoRA FLrce", res, strategy, dim, need_exploit=True)
    round_wall = median(r.wall_s for r in res.records[1:])
    print(f"  FLrce: {res.rounds_run} rounds in {wall:.2f} s; per-round wall "
          + ", ".join(f"{r.wall_s:.3f}" for r in res.records) + f" s (median after the first "
          f"{round_wall:.3f} s); selections {[r.selected for r in res.records]}; exploited "
          f"{[r.exploited for r in res.records]}; losses "
          f"{[round(r.mean_client_loss, 5) for r in res.records]}; launches {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB")
    moe = cfg.moe is not None
    if moe:
        if peak >= MOE_LORA_PEAK:
            fail(f"LoRA FLrce on {cfg.name} at {cfg.num_layers} layers: peak device memory "
                 f"{peak / 2**30:.2f} GiB, over {MOE_LORA_PEAK / 2**30:.0f} GiB")
        # the same job again: the routing's gathers and scatters, their
        # backward and the merges must repeat bitwise on the card
        again = FLrce(LORA_M, LORA_P, 1, dim=dim, explore_decay=0.5, seed=0)
        u1 = capture_round0(again)
        rerun = run_federated(lora, ds, again, max_rounds=LORA_ROUNDS, learning_rate=LORA_LR,
                              batch_size=batch, seed=0, init_params=adapters,
                              torch_device="cuda")
        if [r.selected for r in rerun.records] != [r.selected for r in res.records] or \
                [r.exploited for r in rerun.records] != [r.exploited for r in res.records]:
            fail(f"LoRA FLrce on {cfg.name} run twice: selections "
                 f"{[r.selected for r in res.records]} then {[r.selected for r in rerun.records]}")
        if not torch.equal(u1["u"].view(torch.int32), u0["u"].view(torch.int32)):
            fail(f"LoRA FLrce on {cfg.name} run twice: round 0's (P, D) update differs, max |Δ| "
                 f"{float((u1['u'] - u0['u']).abs().max()):.3e}")
        same_final = all(torch.equal(rerun.final_params[k], res.final_params[k])
                         for k in res.final_params)
        print(f"  FLrce run twice: selections and exploit flags equal, round 0's "
              f"{tuple(u0['u'].shape)} update bitwise equal; final adapters bitwise equal: "
              f"{same_final}; the second run {sum(r.wall_s for r in rerun.records):.2f} s")
        del rerun, u1, again

    # (b) the four kernels on the phase's own operands
    state = strategy.server.state
    u, w = u0["u"], u0["w"]
    sizes = ds.client_sizes()[res.records[0].selected]
    weights = torch.from_numpy((sizes / sizes.sum()).astype(np.float32)).cuda()
    rows = fl_kernel_rows(torch, timer, bandwidth, u, state.updates, w, weights, tag)

    # (d) the first local step of round 0's cohort, batched against sequential;
    # where that step is a client's whole round, the batched side is the run's
    # own round-0 rows (a model with experts: below, once its base is freed)
    cohort = res.records[0].selected
    if not moe:
        seq, bat = first_step_updates(torch, ds, lora, adapters, cohort,
                                      lr=LORA_LR, batch=batch, epochs=1,
                                      batched=u0["u"] if batch >= LORA_N else None)
        step_check(torch, "batched against sequential", seq, bat)
        del seq, bat
    del u0, u, w

    # FedAvg and Fedcom, each with the counts reset just before
    other = {}
    for name, make in (("FedAvg", lambda: FedAvg(LORA_M, LORA_P, 1, seed=0)),
                       ("Fedcom", lambda: Fedcom(LORA_M, LORA_P, 1, seed=0, keep_frac=LORA_KEEP))):
        strat = make()
        ops.reset_launch_counts()
        t0 = time.perf_counter()

        def run(strat=strat):
            return run_federated(lora, ds, strat, max_rounds=LORA_BASELINE_ROUNDS,
                                 learning_rate=LORA_LR, batch_size=batch, seed=0,
                                 init_params=adapters, torch_device="cuda")

        if name == "FedAvg":
            r, prof, prof_wall = lora_profiled(torch, run)
        else:
            r = run()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = {"cross_gram": 0, "gram": 0, "weighted_aggregate": r.rounds_run,
                "topk_mask_rows": r.rounds_run if name == "Fedcom" else 0, "decode_attention": 0,
                "threefry_normal": 0, "threefry_rounding": 0}
        if got != want:
            fail(f"LoRA {name}: launches {got}, want {want}")
        lora_checks(f"LoRA {name}", r, strat, dim, need_exploit=False)
        other[name] = got
        if name == "FedAvg":
            r_fedavg = r
        under = " under the profiler" if name == "FedAvg" else ""
        print(f"  {name}: {r.rounds_run} rounds{under} in {time.perf_counter() - t0:.2f} s; "
              f"per-round wall " + ", ".join(f"{x.wall_s:.3f}" for x in r.records) + f" s; losses "
              f"{[round(x.mean_client_loss, 5) for x in r.records]}; accuracy "
              f"{[x.accuracy for x in r.records]}; launches {got}")
    launches["topk_mask_rows"] = other["Fedcom"]["topk_mask_rows"]

    lora_profile_report(prof, prof_wall, r_fedavg, "the FedAvg run above, under the profiler")
    del prof
    del lora, base_params, adapters, strategy, res, state, r_fedavg, r, strat
    gc.collect()
    torch.cuda.empty_cache()
    if moe:
        moe_first_step_check(torch, arch, ds, cohort, batch)
    print(f"  phase {tag} wall {time.perf_counter() - t_phase:.1f} s")
    return rows, launches


def moe_lora_peaks(torch) -> None:
    """``--moe-lora-peaks``: one FLrce round of phase 13's and 13b's LoRA
    federation on each MoE model at full width, at the phase's depth and one
    layer deeper: the peak device memory of each, or that it ran out, beside
    ``MOE_LORA_PEAK``."""
    from repro_torch.data import make_federated_lm
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.models import LMClassifier, LoRAClassifier

    for arch, layers in ((MX_ARCH, MX_LORA_LAYERS), (DBRX_ARCH, DBRX_LORA_LAYERS)):
        for depth in (layers, layers + 1):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg = cut_config(arch, depth)
            t0 = time.perf_counter()
            try:
                base = LMClassifier(cfg, seq_len=LORA_SEQ)
                lora = LoRAClassifier(base, base.init(0, "cuda"), rank=LORA_RANK)
                ds = make_federated_lm(num_clients=LORA_M, samples_per_client=LORA_N,
                                       seq_len=LORA_SEQ, vocab_size=cfg.vocab_size,
                                       num_eval=LORA_EVAL, seed=0)
                res = run_federated(lora, ds, FLrce(LORA_M, LORA_P, 1, dim=lora.adapter_dim(),
                                                    explore_decay=0.5, seed=0),
                                    max_rounds=1, learning_rate=LORA_LR, batch_size=LORA_BATCH,
                                    seed=0, torch_device="cuda")
                torch.cuda.synchronize()
                what = (f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, round wall "
                        f"{res.records[0].wall_s:.2f} s, D = {lora.adapter_dim():,}")
            except torch.cuda.OutOfMemoryError:
                what = (f"out of device memory (peak before it "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            base = lora = ds = res = None
            print(f"  {arch} at {depth} layers: {what} (limit {MOE_LORA_PEAK / 2**30:.0f} GiB); "
                  f"{time.perf_counter() - t0:.1f} s")


def step_check(torch, label: str, got, want) -> None:
    """(d): first-step update rows ``got`` against ``want`` within the
    reference's engine tolerance (``update_gap``)."""
    excess, gap, n_beyond = update_gap(torch, got, want)
    ratios = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
    print(f"  (d) first local step, {label}: max |Δ| {gap:.3e} (max|U| "
          f"{float(want.abs().max()):.3e}), {n_beyond} of {got.numel()} elements beyond atol "
          f"max(1e-5, 1e-4·max|U|) + rtol 1e-3; ‖ΔU_k‖/‖U_k‖ ≤ {float(ratios.max()):.3e}")
    if excess > 0 or not bool(torch.isfinite(got).all()):
        fail(f"(d) first local step, {label}: beyond the reference's engine tolerance by "
             f"{excess:.3e}")


class Widened:
    """A base-parameter dict read once in float64: each leaf taken out of
    ``params`` and widened as it is read, so that the fp32 base shrinks as
    the float64 copy grows; the router's fp32 weights as they are (the
    model routes in fp32 in every dtype)."""

    def __init__(self, params):
        self.params = params

    def __getitem__(self, name):
        leaf = self.params.pop(name)
        return leaf if name.split(".")[-1] == "router" else leaf.double()


def widened_merge(torch, lora, adapters) -> tuple:
    """``lora``'s model in float64 and its merged weights there, W + scale ·
    A·B in float64 for each adapted leaf; ``lora``'s base dict is emptied
    (``Widened``)."""
    import dataclasses

    from repro_torch.models import LMClassifier, LoRAClassifier

    model = LMClassifier(dataclasses.replace(lora.base.cfg, dtype="float64"),
                         seq_len=lora.base.seq_len)
    ref = LoRAClassifier(model, lora.base_params, rank=lora.rank, scale=lora.scale,
                         targets=lora.targets)
    ref.base_params = Widened(lora.base_params)
    with torch.no_grad():
        return model, ref.merge({k: v.double() for k, v in adapters.items()})


def moe_referee_updates(torch, model, merged, adapters, scale, batches, lr) -> tuple:
    """Each client's first-step update, ``-lr`` times the gradient of the
    adapters, for the two engines' functions computed by their definitions
    in float64 (``model`` at the merged weights ``merged`` of
    ``widened_merge``; norms, attention, the router and the cross-entropy
    stay fp32, as in every dtype): the batched engine's, the mean over the
    batch of ``loss`` of each sequence alone (the reference's ``jax.vmap``
    of ``model.loss``, ``src/repro/fl/client.py:329-332``: no dispatch group
    spans two sequences, and none runs the per-sequence route), and the
    sequential engine's, ``loss`` of the batch routed together.  An
    adapter's gradient comes from G = dL/dW at its merged leaf, dA =
    scale·G·Bᵀ and dB = scale·Aᵀ·G, with a backward pass for the attention
    leaves and one for each stacked expert leaf, so that one expert leaf's
    float64 G is live at a time.  ``batches``: each client's (x, y) in the
    order its engines took them.  Returns the (P, D) rows of each."""
    from repro_torch.core.distributed import flatten_params

    names = [k[:-2] for k in adapters if k.endswith(".a")]
    passes = [p for p in ([n for n in names if merged[n].dim() < 4],
                          *([n] for n in names if merged[n].dim() == 4)) if p]

    def grads(x, y):
        out = {}
        for group in passes:
            w = dict(merged)
            for n in group:
                w[n] = merged[n].detach().requires_grad_(True)
            gs = torch.autograd.grad(model.loss(w, x, y), [w[n] for n in group])
            for n, g in zip(group, gs):
                a, b = adapters[f"{n}.a"].double(), adapters[f"{n}.b"].double()
                out[f"{n}.a"] = scale * (g @ b.transpose(-1, -2))
                out[f"{n}.b"] = scale * (a.transpose(-1, -2) @ g)
            del w, gs, g
        return {k: out[k] for k in adapters}

    rows = {"per-sequence": [], "batch": []}
    for x, y in batches:
        n = len(x)
        each = [grads(x[i:i + 1], y[i:i + 1]) for i in range(n)]
        per = {k: sum(g[k] for g in each) / n for k in adapters}
        for key, got in (("per-sequence", per), ("batch", grads(x, y))):
            rows[key].append(flatten_params({k: -lr * g for k, g in got.items()})[0])
    return torch.stack(rows["per-sequence"]), torch.stack(rows["batch"])


def moe_first_step_check(torch, arch: str, ds, ids, batch: int) -> None:
    """(d) for a model with experts, whose engines train two functions (the
    batched one routes each sequence alone, the sequential one the batch
    together), at ``MOE_REFEREE_LAYERS`` full-width layer in fp32 (a bf16
    step is no match for a float64 one within the engines' tolerance, and
    the float64 weights of the phase's depth would not fit the card): each
    engine's first local step of round 0's cohort ``ids`` against its own
    function computed by definition in float64 (``moe_referee_updates``),
    within the reference's engine tolerance, each batch in the plan's
    order; the gap between the two engines' own steps is printed.  Every
    first batch must be full, so that the batched engine's weights are all
    1."""
    import dataclasses

    from repro_torch.models import LMClassifier, LoRAClassifier

    t0 = time.perf_counter()
    if not all(len(ds.client_data(c)[1]) >= batch for c in ids):
        fail(f"(d): a client of {ids} has fewer than {batch} sequences")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cut_config(arch, MOE_REFEREE_LAYERS), dtype="float32")
    base = LMClassifier(cfg, seq_len=LORA_SEQ)
    lora = LoRAClassifier(base, base.init(0, "cuda"), rank=LORA_RANK)
    adapters = lora.init(0, "cuda")
    seq, bat = first_step_updates(torch, ds, lora, adapters, ids, lr=LORA_LR, batch=batch,
                                  epochs=1, in_order=True)
    plan = first_batch_plan(ds, ids, batch, 1)
    batches = [(torch.from_numpy(plan.x[k, 0, :n]).cuda(),
                torch.from_numpy(plan.y[k, 0, :n]).cuda().long())
               for k, n in enumerate(int(w.sum()) for w in plan.sample_w[:, 0])]
    n_params = sum(p.numel() for p in lora.base_params.values())
    scale = lora.scale
    model, merged = widened_merge(torch, lora, adapters)
    del lora
    gc.collect()
    torch.cuda.empty_cache()
    ref_bat, ref_seq = moe_referee_updates(torch, model, merged, adapters, scale, batches,
                                           LORA_LR)
    del merged
    print(f"  (d) at {MOE_REFEREE_LAYERS} full-width layer of {cfg.name} in fp32 "
          f"({n_params:,} parameters), each engine against its function in float64:")
    step_check(torch, "batched engine against its per-sequence function", bat, ref_bat)
    step_check(torch, "sequential engine against its batch-routed function", seq, ref_seq)
    _, gap, n_beyond = update_gap(torch, seq, bat)
    ratios = torch.linalg.vector_norm(seq - bat, dim=1) / torch.linalg.vector_norm(bat, dim=1)
    print(f"  (d) the two engines' own functions apart (information): max |Δ| {gap:.3e}, "
          f"{n_beyond} of {seq.numel()} elements beyond the engines' tolerance; "
          f"‖ΔU_k‖/‖U_k‖ up to {float(ratios.max()):.3e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    del adapters, seq, bat, ref_bat, ref_seq, batches
    gc.collect()
    torch.cuda.empty_cache()


def lora_checks(label, res, strategy, dim, *, need_exploit: bool) -> None:
    """(c): finite losses and accuracy, P distinct ids a round, an exploit
    round where asked, and the ledger's bytes equal to the host formula at D."""
    up = down = 0.0
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
            fail(f"{label} round {r.t}: non-finite accuracy/loss")
        if len(r.selected) != strategy.p or len(set(r.selected)) != strategy.p:
            fail(f"{label} round {r.t}: bad selection {r.selected}")
        for cid in r.selected:
            cfg = strategy.client_config(r.t, cid, None)
            down += dim * 4 * cfg.download_fraction
            up += dim * 4 * cfg.upload_fraction
    if (res.ledger.bytes_up, res.ledger.bytes_down) != (up, down):
        fail(f"{label}: ledger bytes up/down {res.ledger.bytes_up}/{res.ledger.bytes_down}, host "
             f"formula at D = {dim}: {up}/{down}")
    if need_exploit and not any(r.exploited for r in res.records):
        fail(f"{label}: no exploit round in {res.rounds_run} rounds: Alg. 3 never ran")
    for name, p in res.final_params.items():
        if not bool(p.isfinite().all()):
            fail(f"{label}: final adapter {name} not finite")


def fl_kernel_rows(torch, timer, bandwidth, u, v, w, weights, tag="6", topk=True) -> dict:
    """Each of the four FL kernels (three without ``topk``) on phase
    ``tag``'s operands (an update matrix, the server's V after the run, a
    model) against its plain version, timed beside the plain version, the
    PyTorch call and the bound."""
    from repro_torch.kernels import aggregate as kagg
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import topk_mask as ktopk

    k, d = u.shape
    q = v.shape[0]

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bandwidth, flops / FP32_PEAK_FLOPS
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    src = "src/repro_torch/kernels/csrc/"
    rows = []
    err, rel, k64, p64 = check_gram(f"cross_gram (phase {tag})", kgram.cross_gram_cuda(u, v),
                                      kgram.cross_gram_plain(u, v), u, v, torch)
    b_ms, b_by = bound(4 * (k * d + q * d + k * q), 2 * k * q * d)
    rows.append(dict(name="cross_gram", route="cuda", source=src + "gram.cu",
                     replaces="src/repro/kernels/gram.py:99", max_abs_err=err, rel_err=rel,
                     f64=(k64, p64),
                     ms=timer(lambda: kgram.cross_gram_cuda(u, v)),
                     plain_ms=timer(lambda: kgram.cross_gram_plain(u, v)),
                     bound_ms=b_ms, bound_by=b_by, library_ms=timer(lambda: torch.mm(u, v.t())),
                     shape=f"K={k} Q={q} D={d}"))
    err, rel, k64, p64 = check_gram(f"gram (phase {tag})", kgram.gram_cuda(u),
                                      kgram.gram_plain(u), u, u, torch)
    b_ms, b_by = bound(4 * (k * d + k * k), 2 * k * k * d)
    rows.append(dict(name="gram", route="cuda", source=src + "gram.cu",
                     replaces="src/repro/kernels/gram.py:56", max_abs_err=err, rel_err=rel,
                     f64=(k64, p64),
                     ms=timer(lambda: kgram.gram_cuda(u)),
                     plain_ms=timer(lambda: kgram.gram_plain(u)),
                     bound_ms=b_ms, bound_by=b_by, library_ms=timer(lambda: torch.mm(u, u.t())),
                     shape=f"P={k} D={d}"))
    err = check_aggregate(f"weighted_aggregate (phase {tag})", kagg.weighted_aggregate_cuda(w, u, weights),
                          kagg.weighted_aggregate_plain(w, u, weights), torch)
    b_ms, b_by = bound(4 * (d + k * d + k + d), 2 * k * d)
    rows.append(dict(name="weighted_aggregate", route="cuda", source=src + "aggregate.cu",
                     replaces="src/repro/kernels/aggregate.py:37", max_abs_err=err, rel_err=err,
                     ms=timer(lambda: kagg.weighted_aggregate_cuda(w, u, weights)),
                     plain_ms=timer(lambda: kagg.weighted_aggregate_plain(w, u, weights)),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=timer(lambda: torch.addmv(w, u.t(), weights)),
                     shape=f"P={k} D={d}"))
    padded = None
    if topk:
        check_bitwise(f"topk_mask_rows (phase {tag})",
                      ktopk.topk_mask_rows_cuda(u, keep_frac=LORA_KEEP),
                      ktopk.topk_mask_rows_plain(u, keep_frac=LORA_KEEP), torch)
        bd = ktopk.DEFAULT_BLOCK_D
        padded = torch.nn.functional.pad(u, (0, (-d) % bd)).reshape(-1, bd)
        b_ms, b_by = bound(4 * (k * d + k * d), k * d)
        rows.append(dict(name="topk_mask_rows", route="cuda", source=src + "topk_mask.cu",
                         replaces="src/repro/kernels/topk_mask.py:38", max_abs_err=0.0,
                         rel_err=0.0,
                         ms=timer(lambda: ktopk.topk_mask_rows_cuda(u, keep_frac=LORA_KEEP)),
                         plain_ms=timer(lambda: ktopk.topk_mask_rows_plain(u,
                                                                           keep_frac=LORA_KEEP)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         route_ms=timer(lambda: topk_route(torch, padded,
                                                           ktopk.keep_count(LORA_KEEP, bd))),
                         shape=f"P={k} D={d} ({-(-d // bd)} tiles a row) keep_frac={LORA_KEEP}"))
    for r in rows:
        lib = (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"torch.topk+torch.where (two calls) {r['route_ms']:.4f} ms")
        f64 = (f"; from float64, kernel {r['f64'][0]:.2e} plain {r['f64'][1]:.2e} of ‖u‖‖v‖"
               if "f64" in r else "")
        print(f"  (b) {r['name']:<18} {r['shape']:<44} max|Δ| {r['max_abs_err']:.3e}  kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  {lib}  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) -> {100 * r['bound_ms'] / r['ms']:.1f}% of bound{f64}")
    del padded
    return {r["name"]: r for r in rows}


LORA_SPANS = ("chunked_attention", "cross_entropy", "lora_merge", "rglru", "mlstm", "slstm",
              "moe")


def lora_profiled(torch, run) -> tuple:
    """``run()`` under torch.profiler with the LoRA groups' calls annotated:
    (its result, the profiler, its wall)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import attention, lora as lora_mod, moe, rglru, ssm, transformer

    spans = [(attention, "chunked_attention", "chunked_attention"),
             (transformer, "_chunk_nll", "cross_entropy"),
             (lora_mod.LoRAClassifier, "merge", "lora_merge"),
             (rglru, "apply_rglru", "rglru"),
             (ssm, "apply_mlstm", "mlstm"), (ssm, "apply_slstm", "slstm"),
             (moe, "apply_moe", "moe")]
    with annotated(spans), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, prof, wall


def lora_profile_report(prof, wall, res, what: str) -> None:
    """The device's busy share of a profiled run read against its own wall
    (a lower bound, since the profiler's host overhead is in that wall);
    device time by group; the host's seconds inside each block kind's spans
    (its forward, its recomputation and the backward nodes it made)."""
    rounds = res.rounds_run
    t0 = time.perf_counter()
    groups, busy_us, n_kernels, top, host = device_groups(prof, LORA_SPANS, lora_group,
                                                          host=True)
    total = sum(groups.values())
    print(f"  profile: {what}, wall {wall:.3f} s (rounds "
          + ", ".join(f"{r.wall_s:.3f}" for r in res.records) + f" s); device busy "
          f"{busy_us / 1e6:.3f} s ({n_kernels} device activities) = "
          f"{100 * busy_us / 1e6 / wall:.1f}% of the profiled wall (a lower bound: the profiler's "
          f"host overhead is in it); events read in {time.perf_counter() - t0:.1f} s")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / rounds:10.2f} ms/round  {100 * us / max(total, 1e-9):5.1f}%  {name}")
    for name, (us, n) in top[:12]:
        print(f"    top kernel {us / 1e3 / rounds:9.2f} ms/round  {n / rounds:7.0f}/round  {name[:120]}")
    for label, (sec, n_ops) in sorted(host.items(), key=lambda kv: -kv[1][0]):
        print(f"  host {sec / rounds:8.3f} s/round ({100 * sec / wall:5.1f}% of the profiled wall), "
              f"{n_ops / rounds:9.0f} host ops/round inside the {label!r} spans (forward, "
              f"recomputation, and the backward nodes they made)")


def lora_group(name: str, label, op: str) -> str:
    """Phase 6's group of a kernel: the FL kernels by name, copies by kind,
    then its ``LORA_SPANS`` label; unlabelled GEMMs are the model's
    projections and unembedding."""
    low = name.lower()
    if any(kernel in name for kernel in PROFILED_KERNEL.values()):
        return "FL server kernels (this port's)"
    if "memcpy htod" in low:
        return "H2D copies"
    if "memcpy" in low or "memset" in low:
        return "other copies and sets"
    if label is not None:
        return {"lora_merge": "LoRA merges (forward and backward)",
                "chunked_attention": "chunked attention (fp32; forward, recompute, backward)",
                "cross_entropy": "chunked cross-entropy (forward, recompute, backward)",
                "rglru": "RG-LRU blocks (projections, fp32 gates, conv, scan; forward, "
                         "recompute, backward)",
                "mlstm": "mLSTM blocks (chunkwise, fp32 matrix memory; forward, recompute, "
                         "backward)",
                "slstm": "sLSTM blocks (the loop over positions; forward, recompute, "
                         "backward)",
                "moe": "MoE MLPs (router, slotting, dispatch, expert products, combine; "
                       "forward, recompute, backward)"}[label]
    if "gemm" in low or "xmma" in low or "nvjet" in low or "cutlass" in low:
        return "projection and unembedding GEMMs (forward, recompute, backward)"
    return "other kernels (norms, RoPE, MLP activations, residuals, gathers, SGD)"


def device_groups(prof, labels: tuple, group_of, host: bool = False, since=None) -> tuple:
    """(device µs by group, busy µs, kernel count, top kernels) from the
    profiler's raw records.  A kernel belongs to the CPU op that launched it
    (its linked correlation id); the op to the innermost span around it on
    its thread that carries a label: an annotation named in ``labels``
    (forward, or recomputed under remat), or a backward node whose
    forward op (same creating thread and sequence number) ran inside one.
    ``group_of(kernel name, label or None, launching op's name)`` names
    each kernel's group.  The annotations' own device-side ranges are not
    kernels and are left out.  With ``host``, a fifth item: for each label,
    the host seconds inside its spans (annotations and the backward nodes
    they label, merged on each thread so that nested spans count once) and
    the host ops attributed to it.  With ``since``, a kernel name: only the
    kernels that start after the last kernel of that name are read, and the
    smoke fails if the profiler has none of that name."""
    import torch

    ops, kernels, op_name = [], [], {}
    annotations, evaluate = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in labels:
                kernels.append((name, e.start_ns(), e.duration_ns(), e.linked_correlation_id()))
            continue
        if e.linked_correlation_id() > 0:
            continue           # a runtime call (the launch); it links to its op
        start, tid = e.start_ns(), e.start_thread_id()
        end = start + e.duration_ns()
        if name in labels:
            annotations.append((tid, start, end, name))
        elif name.startswith("autograd::engine::evaluate_function"):
            evaluate.append((tid, start, end, (e.fwd_thread_id(), e.sequence_nr())))
        else:
            ops.append((tid, start, end, e.correlation_id(), e.sequence_nr()))
            op_name[e.correlation_id()] = name

    def innermost(spans, items):
        """For items (tid, start, end, key) the label of the innermost span
        (tid, start, end, label) containing each; spans nest on a thread."""
        out = {}
        by_tid: dict = {}
        for sp in spans:
            by_tid.setdefault(sp[0], []).append(sp)
        for tid, tid_spans in by_tid.items():
            tid_spans.sort(key=lambda sp: (sp[1], -sp[2]))
        items = sorted(items, key=lambda it: (it[0], it[1]))
        cur_tid, stack, j, tid_spans = None, [], 0, []
        for tid, start, end, key in items:
            if tid != cur_tid:
                cur_tid, stack, j, tid_spans = tid, [], 0, by_tid.get(tid, [])
            while j < len(tid_spans) and tid_spans[j][1] <= start:
                stack.append(tid_spans[j])
                j += 1
            while stack and stack[-1][2] < end:
                stack.pop()
            if stack:
                out[key] = stack[-1][3]
        return out

    if since is not None:
        marks = [start for name, start, _, _ in kernels if since in name]
        if not marks:
            fail(f"the profiler has no record of the marker kernel {since}")
        kernels = [k for k in kernels if k[1] > max(marks)]

    # forward ops inside an annotation label the backward nodes they create
    fwd = innermost(annotations, [(tid, s, e_, (tid, seq)) for tid, s, e_, _, seq in ops
                                  if seq >= 0])
    spans = annotations + [(tid, s, e_, fwd[key]) for tid, s, e_, key in evaluate if key in fwd]
    op_label = innermost(spans, [(tid, s, e_, corr) for tid, s, e_, corr, _ in ops])
    groups: dict = {}
    top: dict = {}
    for name, start, dur, corr in kernels:
        us = dur / 1e3
        t_us, t_n = top.get(name, (0.0, 0))
        top[name] = (t_us + us, t_n + 1)
        group = group_of(name, op_label.get(corr), op_name.get(corr, ""))
        groups[group] = groups.get(group, 0.0) + us
    busy_ns, last_end = 0, float("-inf")
    for start, end in sorted((k[1], k[1] + k[2]) for k in kernels):
        busy_ns += max(0, end - max(start, last_end))
        last_end = max(last_end, end)
    top_sorted = sorted(top.items(), key=lambda kv: -kv[1][0])
    if not host:
        return groups, busy_ns / 1e3, len(kernels), top_sorted
    host_s = {}
    for label in labels:
        total, last = 0, {}
        for tid, start, end in sorted((sp[0], sp[1], sp[2]) for sp in spans if sp[3] == label):
            prev = last.get(tid, float("-inf"))
            total += max(0, end - max(start, prev))
            last[tid] = max(prev, end)
        n_ops = sum(1 for lab in op_label.values() if lab == label)
        if total:
            host_s[label] = (total / 1e9, n_ops)
    return groups, busy_ns / 1e3, len(kernels), top_sorted, host_s


def lora_reference_runs(dev: str) -> dict:
    """Phase 6b's runs on ``dev``, by label: LoRA FLrce over a bf16 and an
    fp32 base of the reduced gemma3 config (3 rounds each), and the
    full-model fp32 LMClassifier under FedAvg (2 rounds)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import make_federated_lm
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.models import LMClassifier, LoRAClassifier

    reduced = get_arch(LORA_ARCH, reduced=True)
    kw = dict(learning_rate=0.01, batch_size=8, seed=0, torch_device=dev)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(reduced, dtype=dtype)
        base = LMClassifier(cfg, seq_len=32)
        ds = make_federated_lm(num_clients=8, samples_per_client=16, seq_len=32,
                               vocab_size=cfg.vocab_size, num_eval=32, seed=0)
        host = base.init(0, "cpu")
        lora = LoRAClassifier(base, {k: v.to(dev) for k, v in host.items()}, rank=8)
        runs[f"LoRA FLrce over a {dtype} base ({cfg.name})"] = run_federated(
            lora, ds, FLrce(8, 4, 1, dim=lora.adapter_dim(), explore_decay=0.5, seed=0),
            max_rounds=3, **kw)
        if dtype == "float32":
            runs["full-model LMClassifier FedAvg (fp32)"] = run_federated(
                base, ds, FedAvg(8, 4, 1, seed=0), max_rounds=2, init_params=host, **kw)
    return runs


def lora_reference_check(torch, worker) -> None:
    """Phase 6b: a reduced gemma3 config on the card against the CPU: LoRA
    FLrce over a bf16 and an fp32 base, the full-model LMClassifier under
    FedAvg, and LoRA FedAvg through driver="scan" against the loop."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import make_federated_lm
    from repro_torch.fl import run_federated
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.models import LMClassifier, LoRAClassifier

    t_phase = time.perf_counter()
    card = lora_reference_runs("cuda")
    cpu = cpu_half(worker, "6b")
    for label, run in card.items():
        compare_runs(label, run, cpu[label])
    cfg = dataclasses.replace(get_arch(LORA_ARCH, reduced=True), dtype="float32")
    base = LMClassifier(cfg, seq_len=32)
    ds = make_federated_lm(num_clients=8, samples_per_client=16, seq_len=32,
                           vocab_size=cfg.vocab_size, num_eval=32, seed=0)
    lora = LoRAClassifier(base, {k: v.cuda() for k, v in base.init(0, "cpu").items()}, rank=8)
    kw = dict(learning_rate=0.01, batch_size=8, seed=0, torch_device="cuda")
    loop = run_federated(lora, ds, FedAvg(8, 4, 1, seed=0), max_rounds=4, **kw)
    scan = run_federated(lora, ds, FedAvg(8, 4, 1, seed=0), max_rounds=4, driver="scan",
                         scan_chunk_rounds=2, **kw)
    compare_scan("LoRA FedAvg driver='scan' on the card", loop, scan, torch)
    st = scan.driver_stats
    print(f"  LoRA FedAvg scan: captures {st['captures_chunk']}, replays {st['replays']}, "
          f"host syncs {st['host_syncs']} in {st['chunks']} chunks")
    print(f"  phase 6b wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 7b: the RG-LRU hybrid's training on the card against the CPU
# ---------------------------------------------------------------------------
RG_TRAIN_RTOL = 1e-5    # fp32: loss relative; gradient leaves and update rows |Δ| / their max
RG_PRETRAIN_CLI = ["--mode", "pretrain", "--arch", RG_ARCH, "--silos", "4", "--participants", "2",
                   "--rounds", "2", "--local-steps", "1", "--batch", "2", "--seq", "32"]


def rg_train_cfg():
    """Phase 7b's small config: the CPU tests' 5-layer reduced
    recurrentgemma-2b (a cycle of two RG-LRU blocks and a local attention
    layer, two RG-LRU rest blocks, window 4), fp32."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(RG_ARCH, reduced=True), dtype="float32", num_layers=5,
                               window=4)


def rg_train_reference_check(torch, worker) -> None:
    """Phase 7b: recurrentgemma-2b's training on the card against the CPU
    in fp32, on ``rg_train_cfg``."""
    train_reference_check(torch, RG_ARCH, RG_PRETRAIN_CLI, rg_train_cfg(), "7b", worker)


def train_half(dev: str, cli: list, cfg, seq: int = 32) -> dict:
    """Phases 7b and 9b (and 13c)'s runs on ``dev``, in fp32: the reference
    CLI's pretrain case (``cli``, the reduced config), then on the small
    config ``cfg`` (sequences of ``seq`` tokens) one LMClassifier loss and
    gradient and 3 rounds of LoRA FLrce with round 0's update rows."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data import make_federated_lm
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.launch import train
    from repro_torch.models import LMClassifier, LoRAClassifier

    get = train.get_arch
    train.get_arch = lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                                     dtype="float32")
    try:
        hist = train.run_pretrain_mode(train.build_parser().parse_args(
            cli + ["--device", dev]))["history"]
    finally:
        train.get_arch = get
    base = LMClassifier(cfg, seq_len=seq)
    host = base.init(0, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, seq)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4,)))
    live = {k: v.to(dev).requires_grad_(True) for k, v in host.items()}
    loss = base.loss(live, x.to(dev), y.to(dev))
    grads = [g.cpu() for g in torch.autograd.grad(loss, list(live.values()))]
    del live
    ds = make_federated_lm(num_clients=8, samples_per_client=16, seq_len=seq,
                           vocab_size=cfg.vocab_size, num_eval=32, seed=0)
    lora = LoRAClassifier(base, {k: v.to(dev) for k, v in host.items()}, rank=8)
    dim = lora.adapter_dim()
    strategy = FLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0)
    rows = capture_round0(strategy)
    run = run_federated(lora, ds, strategy, max_rounds=3, torch_device=dev, learning_rate=0.01,
                        batch_size=8, seed=0)
    return {"hist": hist, "loss": float(loss.detach()), "grads": grads, "n_leaves": len(host),
            "dim": dim, "lora": run, "u0": rows["u"].cpu()}


def train_reference_check(torch, arch: str, cli: list, cfg, tag: str, worker,
                          seq: int = 32) -> None:
    """Phases 7b and 9b: ``arch``'s training on the card against the CPU in
    fp32 (``train_half`` on each; the CPU's from the worker): the
    reference CLI's pretrain case, one LMClassifier gradient and
    LoRA FLrce rounds (round 0's update rows) on the small config ``cfg``;
    then a LoRA FedAvg round captured by ``driver="scan"`` against the loop
    and bitwise against the same body run eagerly."""
    from repro_torch.data import make_federated_lm
    from repro_torch.fl import run_federated
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.fl.scan_driver import run_scan_driver
    from repro_torch.models import LMClassifier, LoRAClassifier

    t_phase = time.perf_counter()
    card = train_half("cuda", cli, cfg, seq)
    cpu = cpu_half(worker, tag)
    loss_gap = 0.0
    for a, b in zip(card["hist"], cpu["hist"]):
        if [a[k] for k in ("round", "silos", "exploit", "stopped", "conflicts")] != \
                [b[k] for k in ("round", "silos", "exploit", "stopped", "conflicts")]:
            fail(f"pretrain {arch}: card and CPU rounds differ: {a} vs {b}")
        loss_gap = max(loss_gap, abs(a["mean_loss"] - b["mean_loss"]) / abs(b["mean_loss"]))
    if len(card["hist"]) != len(cpu["hist"]) or loss_gap > RG_TRAIN_RTOL:
        fail(f"pretrain {arch}: {len(card['hist'])} / {len(cpu['hist'])} rounds, mean loss "
             f"{loss_gap:.2e} relative")
    if not all(math.isfinite(r["mean_loss"]) for r in card["hist"]):
        fail(f"pretrain {arch}: a non-finite loss on the card: {card['hist']}")
    print(f"  pretrain CLI ({' '.join(cli[2:])}, fp32) card == CPU over "
          f"{len(cpu['hist'])} rounds: silos {[r['silos'] for r in cpu['hist']]}, exploit "
          f"{[r['exploit'] for r in cpu['hist']]}, conflicts "
          f"{[r['conflicts'] for r in cpu['hist']]}; mean loss {loss_gap:.2e} relative (limit "
          f"{RG_TRAIN_RTOL:.0e})")

    loss_gap = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(card["grads"], cpu["grads"]))
    if loss_gap > RG_TRAIN_RTOL or grad_gap > RG_TRAIN_RTOL:
        fail(f"LMClassifier {cfg.name}: card against CPU loss {loss_gap:.2e} relative, gradient "
             f"leaves {grad_gap:.2e} of their max (limit {RG_TRAIN_RTOL:.0e})")
    print(f"  LMClassifier ({cfg.num_layers} layers: {', '.join(cfg.layer_kinds())}; remat) "
          f"gradient card == CPU: loss {loss_gap:.2e} relative, {card['n_leaves']} gradient "
          f"leaves within {grad_gap:.2e} of their max")

    compare_runs(f"LoRA FLrce over {cfg.name} (fp32, D = {card['dim']})", card["lora"],
                 cpu["lora"])
    ua, ub = card["u0"], cpu["u0"]
    row_gap = float(((ua - ub).abs().amax(dim=1) / ub.abs().amax(dim=1).clamp_min(1e-30)).max())
    if row_gap > RG_TRAIN_RTOL:
        fail(f"LoRA {cfg.name}: round 0's update rows {row_gap:.2e} of their max apart")
    print(f"  round 0's {tuple(ub.shape)} update rows card == CPU within {row_gap:.2e} of each "
          f"row's max (limit {RG_TRAIN_RTOL:.0e})")
    del card, cpu

    base = LMClassifier(cfg, seq_len=seq)
    ds = make_federated_lm(num_clients=8, samples_per_client=16, seq_len=seq,
                           vocab_size=cfg.vocab_size, num_eval=32, seed=0)
    lora = LoRAClassifier(base, {k: v.cuda() for k, v in base.init(0, "cpu").items()}, rank=8)
    kw = dict(learning_rate=0.01, batch_size=8, seed=0)
    loop = run_federated(lora, ds, FedAvg(8, 4, 1, seed=0), max_rounds=4,
                         torch_device="cuda", **kw)
    scan = run_federated(lora, ds, FedAvg(8, 4, 1, seed=0), max_rounds=4,
                         torch_device="cuda", driver="scan", scan_chunk_rounds=2, **kw)
    compare_scan(f"LoRA FedAvg over {cfg.name}, driver='scan' on the card", loop, scan, torch)
    # the same job with the round body run eagerly: the scan run above is
    # its captured twin (run_federated's defaults), held to it bitwise
    eager = run_scan_driver(lora, ds, FedAvg(8, 4, 1, seed=0), max_rounds=4,
                            learning_rate=0.01, batch_size=8, device="jetson_nano",
                            eval_every=1, seed=0, init_params=None, verbose=False,
                            chunk_rounds=2, torch_device=torch.device("cuda"), capture=False)
    st = scan.driver_stats
    if st["captures_chunk"] < 1 or st["replays"] != 4 or st["host_syncs"] != st["chunks"]:
        fail(f"LoRA {cfg.name}: the scan driver did not capture and replay its rounds: {st}")
    compare_scan(f"LoRA FedAvg over {cfg.name}, captured rounds against the eager body", eager,
                 scan, torch, bitwise=True)
    print(f"  captured: {st['captures_chunk']} captures, {st['replays']} replays, "
          f"{st['host_syncs']} host syncs in {st['chunks']} chunks, bitwise the eager body")
    print(f"  phase {tag} wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: serving xlstm-1.3b at full width; 8b: xLSTM on the card against the CPU
# ---------------------------------------------------------------------------
XL_ARCH = "xlstm-1.3b"
XL_B, XL_PROMPT, XL_GEN = 8, 128, 64
XL_STEPS = XL_PROMPT + XL_GEN - 1
XL_PARAMS = 2_119_586_128          # the tree init builds
XL_CONFIG_PARAMS = 1_741_666_304   # ArchConfig.param_count()
XL_FP32_B, XL_FP32_POSITIONS = 2, 300   # a whole chunk of 256 and a padded one
# decode-step logits against forward's, |Δ| / max|logit|, fp32: the two
# forms round differently in every block, and the gap grows with the width
# at 48 layers (the reference's own 2.7e-4 at d_model 256 on the CPU; on the
# card 3.1e-4 at 256 to 6.8e-4 at 2048, and at 2048 the card's forward lies
# 4.7e-4 from the host CPU's: ``--xlstm-gap``)
XL_FP32_RTOL = 1e-3
# planted faults of phase 8's fp32 check (and ``--xlstm-gap``): the decode
# loses the state of these layers before the chunk boundary at 256; the
# least of them read 0.196 of max|logit| on the card, the sound decode 6.8e-4
XL_FAULT_AT = 256
XL_FAULTS = (("every layer's state emptied", None),
             ("the 6 sLSTM layers' states emptied", tuple(range(7, 48, 8))),
             ("layer 0's mLSTM state emptied", (0,)),
             ("layer 7's sLSTM state emptied", (7,)),
             ("layer 46's mLSTM state emptied", (46,)))
XL_SPANS = ("mlstm", "slstm", "unembed")


def xl_group(name: str, label, op: str) -> str:
    """Phase 8's group of a kernel, from its ``XL_SPANS`` label and the op
    that launched it."""
    if label == "mlstm":
        if op.startswith(("aten::baddbmm", "aten::bmm", "aten::mul_")):
            return "mLSTM matrix memory C (scale, rank-one add, read; fp32)"
        if op.endswith("mm"):
            return "mLSTM projections (bf16 q/k/v/gate/out, fp32 gates)"
        return "mLSTM gates, stabiliser, normaliser (elementwise)"
    if label == "slstm":
        return ("sLSTM products (bf16 weights cast to fp32)" if op.endswith("mm")
                else "sLSTM elementwise and casts")
    if label == "unembed":
        return "unembed (vocab 50,304)"
    return "norms, residuals, embedding, argmax"


def xl_serve_profile(torch, model, params, step_wall_s: float) -> None:
    """Phase 8's device time by group at the run's last positions (the state
    is the same size at every position), and the state's bytes."""
    from repro_torch.models import ssm, transformer

    def state_line(cache, params) -> None:
        state = sum(t.numel() * t.element_size() for t in tensors(cache))
        c_bytes = sum(c["C"].numel() * c["C"].element_size() for c in cache if "C" in c)
        weights = sum(t.numel() * t.element_size() for t in tensors(params))
        bytes_min = 2 * state + weights
        print(f"  state {state / 1e9:.3f} GB at B = {XL_B} ({c_bytes / 1e9:.3f} GB the mLSTM "
              f"matrix memories), weights {weights / 1e9:.3f} GB: a step reads and writes the "
              f"state and reads the weights, {bytes_min / 1e9:.2f} GB, "
              f"{1e3 * bytes_min / 3.35e12:.2f} ms at 3.35 TB/s")

    spans = [(ssm, "mlstm_decode_step", "mlstm"), (ssm, "slstm_decode_step", "slstm"),
             (transformer.TransformerLM, "unembed", "unembed")]
    group_profile(torch, model, params, XL_B, XL_STEPS, spans, XL_SPANS, xl_group, step_wall_s,
                  0, state_line)


def xlstm_gap(torch) -> None:
    """``--xlstm-gap``: xLSTM's fp32 decode-against-forward gap by two more
    routes than phase 8's.  On the card at 48 layers and d_model 256, 512,
    1024 and 2048 (the full width), to show how it grows with the width; at
    the full width on the host's CPU from the card's weights, with the
    card's ``forward`` logits against the CPU's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50_304, (XL_FP32_B, XL_FP32_POSITIONS), generator=gen,
                           device="cuda")
    for d in (256, 512, 1024, 2048):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(XL_ARCH), d_model=d, dtype="float32")
        model = TransformerLM(cfg)
        params = model.init(0, "cuda")
        with torch.no_grad():
            full = model.forward(params, {"tokens": tokens})
        worst, same, kept = decode_gap(torch, model, params, tokens, full,
                                       model.init_cache(XL_FP32_B, XL_FP32_POSITIONS, "cuda"),
                                       keep_at=XL_FAULT_AT)
        print(f"  card, 48 layers, d_model {d}: |Δ|/max|logit| {worst:.3e}, argmax equal at "
              f"{same} of {XL_FP32_B * XL_FP32_POSITIONS}; {time.perf_counter() - t0:.1f} s")
    fault_gaps(torch, model, params, tokens, full, kept, XL_FAULTS, XL_FAULT_AT)
    del kept
    t0 = time.perf_counter()
    host = tree_to(params, "cpu")
    full_card = full.cpu()
    del params, full
    torch.cuda.empty_cache()
    cpu_tokens = tokens.cpu()
    with torch.no_grad():
        full = model.forward(host, {"tokens": cpu_tokens})
    cross = float((full - full_card).abs().max() / full_card.abs().max())
    worst, same, _ = decode_gap(torch, model, host, cpu_tokens, full,
                                model.init_cache(XL_FP32_B, XL_FP32_POSITIONS, "cpu"))
    print(f"  host CPU ({torch.get_num_threads()} threads), the full width from the card's "
          f"weights: decode against forward |Δ|/max|logit| {worst:.3e}, argmax equal at {same} "
          f"of {XL_FP32_B * XL_FP32_POSITIONS}; the card's forward against the CPU's "
          f"{cross:.3e}; {time.perf_counter() - t0:.1f} s")


def xl_cli_reference_check(torch) -> None:
    """Phase 8b's CLI case: ``serve --arch xlstm-1.3b --batch 2 --prompt-len 4
    --gen 4`` (the reference's tests/test_launch_cli.py) on the reduced
    config in fp32 through ``generate``, on the card and on the CPU, from
    seed 0's weights and the CLI's prompt: the tokens must be equal."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(get_arch(XL_ARCH, reduced=True), dtype="float32")
    model = TransformerLM(cfg)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4)))
    seqs = {dev: generate(model, model.init(0, dev), prompt.to(dev), 4, 8).cpu()
            for dev in ("cuda", "cpu")}
    if not torch.equal(seqs["cuda"], seqs["cpu"]):
        fail(f"serve CLI case {cfg.name} (fp32): card tokens {seqs['cuda'].tolist()} differ from "
             f"the CPU's {seqs['cpu'].tolist()}")
    print(f"  serve CLI case ({cfg.name}, {', '.join(cfg.layer_kinds())}; batch 2, 4 + 4 tokens, "
          f"fp32) card == CPU: {seqs['cpu'].tolist()}")


# ---------------------------------------------------------------------------
# phase 9b: xLSTM's training on the card against the CPU
# ---------------------------------------------------------------------------
XL_PRETRAIN_CLI = ["--mode", "pretrain", "--arch", XL_ARCH, "--silos", "4", "--participants", "2",
                   "--rounds", "2", "--local-steps", "1", "--batch", "2", "--seq", "32"]


def xl_train_cfg():
    """Phase 9b's small config: the reduced width (d_model 256, 4 heads)
    with both block kinds, three layers, a cycle of an mLSTM and an sLSTM
    block and an mLSTM rest block (the reduced xlstm-1.3b has two mLSTM
    layers and no sLSTM), fp32."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MLSTM, SLSTM

    return dataclasses.replace(get_arch(XL_ARCH, reduced=True), dtype="float32", num_layers=3,
                               pattern=(MLSTM, SLSTM))


def xl_train_reference_check(torch, worker) -> None:
    """Phase 9b: xLSTM's training on the card against the CPU in fp32, on
    ``xl_train_cfg`` at sequences of 16 tokens: the sLSTM loop's host work
    grows with the length."""
    train_reference_check(torch, XL_ARCH, XL_PRETRAIN_CLI, xl_train_cfg(), "9b", worker,
                          seq=16)


# ---------------------------------------------------------------------------
# phase 10: examples/federated_pretrain_torch.py at --size 100m, driver="scan"
# ---------------------------------------------------------------------------
FEDLM_ARGS = ["--size", "100m", "--rounds", "25", "--chunk", "4"]
FEDLM_D = 100_680_192
FEDLM_LOOP_ROUNDS = 2
SCAN_PARAM_ATOL = 1e-5     # loop against scan, final parameters (tests/test_torch_scan.py)


def load_example(name: str):
    """``examples/<name>.py`` as a module, its ``main`` not run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fedlm_phase(torch, timer, bandwidth) -> tuple:
    """Phase 10: ``federated_pretrain_torch``'s run at ``--size 100m``
    through the compiled round driver, with the launch counts reset just
    before and read just after (the wrappers' counts, warm-up round and
    capture, are the kernels line's); its first rounds against the loop
    driver's (and a scan run of as many rounds, whose parameters the loop's
    must match), and the three FL kernels at D = 100,680,192."""
    import numpy as np

    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    example = load_example("federated_pretrain_torch")
    args = example.build_parser().parse_args(FEDLM_ARGS)
    model, ds, strategy, psi, dev = example.setup(args)
    if strategy.dim != FEDLM_D:
        fail(f"fedlm-100m: D = {strategy.dim:,}, the reference's tree has {FEDLM_D:,}")
    kw = dict(learning_rate=args.lr, batch_size=args.batch, seed=args.seed, torch_device=dev)

    def again():
        return FLrce(args.silos, args.participants, 1, dim=strategy.dim, es_threshold=psi,
                     explore_decay=0.85, seed=args.seed)

    u0 = capture_round0(strategy)
    t0 = time.perf_counter()
    loop = run_federated(model, ds, strategy, max_rounds=FEDLM_LOOP_ROUNDS, **kw)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    short = run_federated(model, ds, again(), max_rounds=FEDLM_LOOP_ROUNDS, driver="scan",
                          scan_chunk_rounds=FEDLM_LOOP_ROUNDS, **kw)
    compare_scan(f"fedlm-100m, {FEDLM_LOOP_ROUNDS} rounds through driver='scan'", loop, short,
                 torch)
    gap = max(float((loop.final_params[k] - short.final_params[k]).abs().max())
              for k in loop.final_params)
    if gap > SCAN_PARAM_ATOL:
        fail(f"fedlm-100m: after {FEDLM_LOOP_ROUNDS} rounds the scan run's parameters lie "
             f"{gap:.3e} from the loop's (limit {SCAN_PARAM_ATOL:.0e})")
    del short
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  loop: {FEDLM_LOOP_ROUNDS} rounds in {loop_s:.2f} s (rounds "
          + ", ".join(f"{r.wall_s:.3f}" for r in loop.records) + " s); the scan run of as many "
          f"rounds: parameters within {gap:.3e} of the loop's (limit {SCAN_PARAM_ATOL:.0e})")

    # the main path: the example's own run, the counts reset just before
    # and read just after (no profiler: the replays' millions of device
    # records take longer to read than the phase's own runs)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = example.main(FEDLM_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = res.driver_stats
    replays = st["replay_launches"]
    # the wrappers launch each kernel in the warm-up round and record it in
    # the capture; the replays run what was captured without the wrappers
    for name in ("cross_gram", "gram", "weighted_aggregate"):
        if launches[name] != 2 * st["warmup_launches"][name] or replays[name] < 1:
            fail(f"fedlm-100m: the {name} wrapper launched {launches[name]} times (warm-up and "
                 f"capture: {2 * st['warmup_launches'][name]}), {replays[name]} in the replays")
    for r in res.records:
        if not (math.isfinite(r.mean_client_loss) and math.isfinite(r.accuracy)):
            fail(f"fedlm-100m round {r.t}: non-finite loss or accuracy")
    for p in res.final_params.values():
        if not bool(p.isfinite().all()):
            fail("fedlm-100m: non-finite final parameters")
    for a, b in zip(loop.records, res.records):
        if (a.selected, a.exploited, a.stopped, a.evaluated, a.energy_kj, a.bytes_gb) != \
                (b.selected, b.exploited, b.stopped, b.evaluated, b.energy_kj, b.bytes_gb) or \
                abs(a.accuracy - b.accuracy) > 2e-3 or \
                abs(a.mean_client_loss - b.mean_client_loss) > 1e-4:
            fail(f"fedlm-100m round {a.t}: the loop and the example's scan run differ: {a} vs {b}")
    print(f"  the example's first {FEDLM_LOOP_ROUNDS} rounds == the loop's: selections "
          f"{[r.selected for r in loop.records]}, exploited {[r.exploited for r in loop.records]}, "
          f"ledger equal, losses {[r.mean_client_loss for r in loop.records]} against "
          f"{[r.mean_client_loss for r in res.records[:FEDLM_LOOP_ROUNDS]]}")
    print(f"  the example: {res.rounds_run} rounds in {wall:.2f} s ({wall / res.rounds_run:.3f} s "
          f"a round; capture {st['capture_s']:.2f} s, {st['captures_total']} captures, "
          f"{st['replays']} replays, {st['host_syncs']} host syncs in {st['chunks']} chunks); "
          f"losses {[round(r.mean_client_loss, 4) for r in res.records]}; exploited "
          f"{[r.exploited for r in res.records]}; peak device memory {peak / 2**30:.2f} GiB")
    print(f"  wrapper launches (the kernels line's; warm-up round and capture) {launches}; in "
          f"the replays, derived by the driver as replays x launches recorded at capture "
          f"(not measured) {replays}")

    u, w = u0["u"], u0["w"]
    sizes = ds.client_sizes()[loop.records[0].selected]
    weights = torch.from_numpy((sizes / sizes.sum()).astype(np.float32)).cuda()
    v = strategy.server.state.updates
    print(f"  V {tuple(v.shape)}: {v.numel():,} elements, {v.numel() * 4 / 1e9:.2f} GB")
    rows = fl_kernel_rows(torch, timer, bandwidth, u, v, w, weights, "10", topk=False)
    print(f"  phase 10 wall {time.perf_counter() - t_phase:.1f} s")
    del u0, u, w, v, loop, res, strategy
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# phase 11: the ported examples on the card; their CPU runs in a worker
# ---------------------------------------------------------------------------
# depth cuts of the examples' runs card against CPU (the CPU's runs take
# minutes at full depth): flrce_vs_baselines' T, federated_pretrain's rounds
EX_FVB_ROUNDS = 10
EX_FEDLM_ARGS = ["--size", "5m", "--rounds", "2", "--chunk", "1"]
CPU_SIDE_THREADS = 3
# the CPU halves of the phases' card-against-CPU checks, by phase: the CPU
# worker makes those of the selected phases beside the earlier ones
CPU_HALVES = {
    "2f": lambda: quick_async_run("cpu"),
    "3": lambda: reference_runs("cpu"),
    "6b": lambda: lora_reference_runs("cpu"),
    "7b": lambda: train_half("cpu", RG_PRETRAIN_CLI, rg_train_cfg()),
    "9b": lambda: train_half("cpu", XL_PRETRAIN_CLI, xl_train_cfg(), 16),
    "13c": lambda: moe_train_half("cpu"),
}
# the worker's parts in the order it makes them (the phases' order), each
# with the phase that needs it
WORKER_PARTS = (("2f", "2f"), ("fleet", "2d"), ("3", "3"), ("6b", "6b"), ("7b", "7b"),
                ("9b", "9b"), ("examples", "11"), ("13c", "13c"))


def cpu_side(out: str, parts: str) -> None:
    """``--cpu-side DIR PARTS CORES``: host work of later phases, written
    under ``DIR`` in the order of ``PARTS`` (the order the phases need it):
    a phase's tag in ``CPU_HALVES`` the CPU half of its card-against-CPU
    checks (``<tag>.pt``), ``fleet`` phase 2d's federation (``fleet.npz``),
    ``examples`` the CPU runs phase 11 holds the card's against
    (``examples.pt``); last ``ended``, the wall clock at its end.  The
    smoke starts this in a worker process after the build, pinned to
    ``CORES``, so that it runs beside the card's phases."""
    import os

    import torch

    torch.set_num_threads(CPU_SIDE_THREADS)

    def save(name, value):
        torch.save(value, os.path.join(out, name + ".part"))
        os.replace(os.path.join(out, name + ".part"), os.path.join(out, name))

    for part in parts.split(","):
        if part in CPU_HALVES:
            save(f"{part}.pt", CPU_HALVES[part]())
        elif part == "fleet":
            ds = fleet_data()
            save_dataset(ds, os.path.join(out, "fleet.npz"))
            del ds
        elif part == "examples":
            fvb = load_example("flrce_vs_baselines_torch")
            fvb.T = EX_FVB_ROUNDS
            results = {"fvb": fvb.main(["--device", "cpu"])}
            results["fedlm"] = load_example("federated_pretrain_torch").main(
                EX_FEDLM_ARGS + ["--device", "cpu"])
            save("examples.pt", results)
    with open(os.path.join(out, "ended"), "w") as f:
        f.write(repr(time.time()))


def pin_process(cores) -> None:
    """Every thread of this process onto ``cores`` (threads it starts later
    inherit their starter's cores)."""
    import os

    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except ProcessLookupError:
            pass               # the thread has exited


class CpuWorker:
    """The ``cpu_side`` worker for ``parts``, started on the last
    ``CPU_SIDE_THREADS`` cores this process may use while this process
    keeps the others (and as many torch threads), so that the card's
    phases that overlap it share no core with it; ``poll`` gives this
    process its cores and threads back once the worker has exited and notes
    when it ended.  With too few cores to split, neither is pinned."""

    def __init__(self, torch, parts: list):
        import os
        import tempfile

        self.torch, self.threads, self.parts = torch, torch.get_num_threads(), list(parts)
        self.all_cores = sorted(os.sched_getaffinity(0))
        split = len(self.all_cores) > CPU_SIDE_THREADS + 1
        self.cores = self.all_cores[-CPU_SIDE_THREADS:] if split else self.all_cores
        self.main_cores = self.all_cores[:-CPU_SIDE_THREADS] if split else self.all_cores
        self.out = tempfile.mkdtemp(prefix="chip_smoke_")
        self.log = tempfile.TemporaryFile(mode="w+")
        self.started, self.ended = time.time(), None
        env = dict(os.environ, OMP_NUM_THREADS=str(CPU_SIDE_THREADS))
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-side", self.out,
             ",".join(parts), ",".join(map(str, self.cores))],
            env=env, stdout=self.log, stderr=subprocess.STDOUT, text=True)
        if split:
            pin_process(self.main_cores)
            torch.set_num_threads(min(self.threads, len(self.main_cores)))

    def poll(self) -> bool:
        """Whether the worker has exited; the first time it has, this
        process gets every core and its torch threads back."""
        import os

        if self.ended is None and self.proc.poll() is not None:
            path = os.path.join(self.out, "ended")
            self.ended = time.time()
            if os.path.exists(path):
                with open(path) as f:
                    self.ended = float(f.read())
            if self.main_cores != self.all_cores:
                pin_process(self.all_cores)
                self.torch.set_num_threads(self.threads)
        return self.ended is not None

    def report(self, starts: list) -> str:
        """Its cores, its span and the phases (of ``starts``, (name,
        perf_counter, wall clock) each) that began before it ended."""
        self.poll()
        ended = time.time() if self.ended is None else self.ended
        overlap = [name for name, _, wall in starts if wall < ended]
        return (f"CPU worker: cores {self.cores}, {CPU_SIDE_THREADS} threads; this process on "
                f"cores {self.main_cores} with {min(self.threads, len(self.main_cores))} torch "
                f"threads until it ended, {ended - self.started:.1f} s after it started"
                f"{'' if self.ended is not None else ' (still running)'}; phases that began "
                f"while it ran: {', '.join(overlap) or 'none'}")

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(self.out, ignore_errors=True)


def worker_file(worker: CpuWorker, name: str, timeout: float = 900.0) -> str:
    """The path of the worker's file ``name`` once it is written; fails if
    the worker exits without writing it."""
    import os

    proc, log = worker.proc, worker.log
    path = os.path.join(worker.out, name)
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            log.seek(0)
            fail(f"the CPU worker exited {proc.returncode} without writing {name}: "
                 f"{log.read()[-3000:]}")
        if time.perf_counter() > deadline:
            fail(f"the CPU worker wrote no {name} in {timeout:.0f} s")
        time.sleep(0.2)
    return path


def worker_result(worker: CpuWorker, name: str):
    """The object the worker saved as ``name``, once it is written (the
    file is removed after loading)."""
    import os

    import torch

    path = worker_file(worker, name)
    value = torch.load(path, weights_only=False)
    os.unlink(path)
    return value


def examples_phase(torch, worker) -> None:
    """Phase 11: ``flrce_vs_baselines_torch`` (T cut to ``EX_FVB_ROUNDS``)
    and ``federated_pretrain_torch`` at ``--size 5m`` on the card, each
    strategy's run against the worker's CPU run; then
    ``serve_decode_torch`` for every architecture it offers, on the card as
    shipped (bf16 where the config is), and in fp32 card against CPU,
    tokens equal."""
    import dataclasses

    from repro_torch.configs import list_archs

    t_phase = time.perf_counter()
    fvb = load_example("flrce_vs_baselines_torch")
    fvb.T = EX_FVB_ROUNDS
    card = fvb.main([])
    fedlm = load_example("federated_pretrain_torch").main(EX_FEDLM_ARGS)
    t0 = time.perf_counter()
    cpu = worker_result(worker, "examples.pt")
    waited = time.perf_counter() - t0
    print(f"  the CPU worker's runs ({CPU_SIDE_THREADS} threads, beside the earlier phases) "
          f"were waited for {waited:.1f} s")
    if list(card) != list(cpu["fvb"]):
        fail(f"flrce_vs_baselines: strategies {list(card)} on the card, {list(cpu['fvb'])} on "
             "the CPU")
    for name in card:
        compare_runs(f"flrce_vs_baselines {name} (T = {EX_FVB_ROUNDS})", card[name],
                     cpu["fvb"][name])
    compare_runs(f"federated_pretrain {' '.join(EX_FEDLM_ARGS)} (driver='scan')", fedlm,
                 cpu["fedlm"])
    if fedlm.driver_stats["captures_chunk"] < 1:
        fail(f"federated_pretrain on the card captured no round: {fedlm.driver_stats}")

    serve = load_example("serve_decode_torch")
    get = serve.get_arch
    archs = list_archs()
    for arch in archs:
        tokens = serve.main(["--arch", arch])
        if tuple(tokens.shape) != (4, 36) or int(tokens.min()) < 0:
            fail(f"serve_decode {arch}: tokens {tuple(tokens.shape)}")
    serve.get_arch = lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                                     dtype="float32")
    try:
        for arch in archs:
            seqs = {dev: serve.main(["--arch", arch, "--device", dev]) for dev in ("cuda", "cpu")}
            if not torch.equal(seqs["cuda"], seqs["cpu"]):
                fail(f"serve_decode {arch} in fp32: card tokens {seqs['cuda'].tolist()} differ "
                     f"from the CPU's {seqs['cpu'].tolist()}")
    finally:
        serve.get_arch = get
    print(f"  serve_decode: {len(archs)} architectures ({', '.join(archs)}) served on the card; "
          f"in fp32 the card's tokens equal the CPU's")
    print(f"  phase 11 wall {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--cpu-side"] and len(args) == 4:
        # the worker's cores, before torch starts any thread
        import os

        os.sched_setaffinity(0, [int(c) for c in args[3].split(",")])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    if args[:1] == ["--cpu-side"] and len(args) == 4:
        sys.path.insert(0, str(SRC))
        cpu_side(args[1], args[2])
        return 0
    selected = set(PHASES)
    if args[:1] == ["--phases"]:
        selected = set(args[1].split(",")) if len(args) == 2 else set()
        if not selected or selected - set(PHASES) or ("2c" in selected and "2" not in selected):
            print(f"usage: chip_smoke.py --phases P[,P...] with P among {', '.join(PHASES)}; "
                  "phase 2c compares with phase 2's run and needs it", file=sys.stderr)
            return 2
        args = []
    mode = args[0] if args and args[0] in MODES else None
    src = SRC
    if mode == "--time-kernels" and args[1:2] == ["--src"] and len(args) == 3:
        src = Path(args[2]).resolve()
    elif args != ([mode] if mode else []):
        print(f"usage: chip_smoke.py [{' | '.join(MODES)}]; --time-kernels takes --src DIR",
              file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    resolve_device("cuda")
    print(gpu_identity())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    info = build.BUILD_INFO
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if info.get('built') else 'cached'}) -> {info['path']}")
    bandwidth, bw_src = memory_bandwidth(torch)
    if mode == "--time-kernels":
        print(f"gram, topk_mask_rows and cross_gram from {src}")
        time_kernels(torch, Timer(torch), bandwidth)
        return 0
    ptxas = ptxas_summary(str(info.get("log", "")))
    for line in ptxas:
        print(f"  ptxas: {line}")
    unknown = [line for line in ptxas
               if not any(line.startswith((f"{k}<", f"{k}:")) for k in KERNEL_INSTANCES)]
    if unknown and mode is None:
        fail(f"ptxas reports kernels the gate does not declare: {unknown}")
    for kernel, instances in KERNEL_INSTANCES.items():
        lines = [line for line in ptxas if line.startswith((f"{kernel}<", f"{kernel}:"))]
        # a stack frame is local memory too, though ptxas reports no spill
        spilling = [line for line in lines
                    if "spill stores/loads 0/0 B" not in line or "stack frame" in line]
        regs = sorted(int(line.split(": ")[1].split()[0]) for line in lines)
        print(f"  ptxas: {len(lines)} {kernel} instances, {regs[0] if regs else '-'}-"
              f"{regs[-1] if regs else '-'} registers, {len(spilling)} with spills or stack frames")
        if (len(lines) != instances or spilling) and mode is None:
            fail(f"{kernel}: {len(lines)} instances compiled (want {instances}), "
                 f"with spills or stack frames: {spilling}")
    print(f"memory bandwidth {bandwidth / 1e12:.3f} TB/s ({bw_src}); "
          f"fp32 peak {FP32_PEAK_FLOPS / 1e12:.0f} TFLOP/s")
    if mode == "--decode-variants":
        print("decode_attention variants")
        decode_variants(torch, Timer(torch), bandwidth)
        return 0
    if mode == "--numerics":
        print("numerics of the FL path at the CIFAR width")
        numerics(torch)
        return 0
    if mode == "--xlstm-gap":
        print(f"{XL_ARCH} in fp32: decode steps against forward by width, and on the host's CPU")
        xlstm_gap(torch)
        return 0
    if mode == "--kernel-variants":
        print("topk_mask_rows and gram variants")
        kernel_variants(torch, Timer(torch), bandwidth)
        return 0
    if mode == "--moe-lora-peaks":
        print("the MoE models' LoRA round at full width: peak device memory by depth")
        moe_lora_peaks(torch)
        return 0

    # host work of phases 2d and 11, in a worker beside the card's phases
    parts = [part for part, name in WORKER_PARTS if name in selected]
    worker = CpuWorker(torch, parts) if parts else None
    try:
        return run_phases(torch, selected, bandwidth, worker, t_start)
    finally:
        if worker is not None:
            worker.close()


def run_phases(torch, selected: set, bandwidth: float, worker, t_start: float) -> int:
    """Every selected phase in order, the kernels line and the result line."""
    starts = []

    def phase(name: str, header: str) -> bool:
        """Whether phase ``name`` runs; if it does, print its header and note
        when it started."""
        if name not in selected:
            return False
        if worker is not None:
            worker.poll()
        starts.append((name, time.perf_counter(), time.time()))
        print(f"phase {name}: {header}")
        return True

    rows, launches, fl_rows = {}, {}, {}
    if phase("1", "kernels against their plain versions"):
        timer = Timer(torch)
        rows = kernel_phase(torch, timer, bandwidth)
        decode_rows = decode_kernel_phase(torch, timer, bandwidth)
        rows["decode_attention"] = decode_rows["global"]
        rows[f"decode_attention@{RG_ARCH}"] = decode_rows[RG_ROW]
        rows[f"decode_attention@{MX_ARCH}"] = decode_rows[MX_ROW]
        rows[f"decode_attention@{MX_ARCH}-wrapped"] = decode_rows[MX_WRAPPED_ROW]
        rows[f"decode_attention@{DBRX_ARCH}"] = decode_rows[DBRX_ROW]
        rows.update(threefry_phase(torch, timer, bandwidth))
        del timer
        torch.cuda.empty_cache()

    fed = scan_runs = None
    if phase("2", "main path, CIFAR-10 PaperCNN, M=100, P=10, 6 FLrce rounds"):
        launches, (ds, model, params, round_wall_s), (main_res, main_u0) = main_path(torch)
        fed = (ds, model, params)
        print("profile: the main path's device time by kernel")
        profile_phase(torch, ds, model, params, round_wall_s)
    elif selected & {"2b", "2e", "2f"}:
        fed = cifar_federation(torch)

    if phase("2b", "the §4.1 baselines at full width, M=100, P=10"):
        baseline_launches = baselines_phase(torch, *fed)
        launches["topk_mask_rows"] = baseline_launches["Fedcom"]["topk_mask_rows"]
        launches["threefry_rounding"] = baseline_launches["QuantizedFL"]["threefry_rounding"]

    if phase("2c", "the sequential engine at full width, M=100, P=10, 2 FLrce rounds"):
        sequential_phase(torch, *fed, main_res, main_u0)

    if phase("2e", f"the compiled round driver (driver='scan'), CIFAR-10 PaperCNN, M=100, "
                   f"P=10, {SCAN_ROUNDS} FLrce rounds in chunks of {SCAN_CHUNK}, FedAvg, Fedcom "
                   "and QuantizedFL"):
        scan_runs = scan_phase(torch, *fed)

    if phase("2f", f"async rounds (async_rounds=AsyncConfig), CIFAR-10 PaperCNN, M=100, P=10: "
                   f"FLrce, FedAvg and Fedprox at max_staleness=0 against the synchronous scan "
                   f"runs, FLrce at max_staleness={ASYNC_S} for {ASYNC_ROUNDS} rounds, the quick "
                   f"BenchConfig at max_staleness={ASYNC_S} card against CPU"):
        timer = Timer(torch)
        fl_rows["async"] = async_phase(torch, timer, bandwidth, *fed, scan_runs or {}, worker)
        del timer
    fed = scan_runs = ds = model = params = main_res = main_u0 = None
    gc.collect()
    torch.cuda.empty_cache()

    if phase("2d", f"FLrce at a {FLEET_M}-client fleet, CIFAR-10 PaperCNN, P=10, "
                   f"{FLEET_ROUNDS} rounds: exact maps, va_rows=40 and va_rows=20"):
        timer = Timer(torch)
        fleet_phase(torch, timer, bandwidth, worker)
        del timer
        torch.cuda.empty_cache()

    if phase("3", "small federations, GPU against CPU"):
        reference_check(torch, worker)
        torch.cuda.empty_cache()

    if phase("4", f"serve gemma3-4b at full width, {SERVE_LAYERS} of its layers, {SERVE_B} "
                  f"requests x ({SERVE_PROMPT} prompt + {SERVE_GEN} generated) tokens"):
        model, params, serve_launches, step_wall_s, _ = serve_phase(
            torch, "gemma3-4b", SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_PARAMS, SERVE_PARAMS,
            layers=SERVE_LAYERS)
        launches["decode_attention"] = serve_launches["decode_attention"]
        launches["threefry_normal"] = serve_launches["threefry_normal"]
        print("profile: device time by kernel of the serve step")
        serve_profile(torch, model, params, step_wall_s)
        del model, params
        torch.cuda.empty_cache()

    if phase("4b", f"serve {RG_ARCH} at full width, {RG_LAYERS} of its layers, {RG_B} requests "
                   f"x ({RG_PROMPT} prompt + {RG_GEN} generated) tokens"):
        model, params, rg_launches, rg_step_s, calls = serve_phase(
            torch, RG_ARCH, RG_B, RG_PROMPT, RG_GEN, RG_PARAMS, RG_CONFIG_PARAMS,
            keep_calls=RG_ATTN_LAYERS, layers=RG_LAYERS)
        launches[f"decode_attention@{RG_ARCH}"] = rg_launches["decode_attention"]
        rg_last_step_check(torch, model.cfg, calls)
        del calls
        print(f"profile: device time by group of the {RG_ARCH} serve step")
        rg_serve_profile(torch, model, params, rg_step_s)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{RG_ARCH} at full width in fp32, {RG_FP32_POSITIONS} positions at "
              f"B={RG_FP32_B}: decode steps against forward")
        fp32_decode_check(torch, RG_ARCH, RG_FP32_B, RG_FP32_POSITIONS, RG_FP32_RTOL)
        gc.collect()
        torch.cuda.empty_cache()

    if phase("5", "a small gemma3-family model served on the GPU and on the CPU"):
        serve_reference_check(torch, "gemma3-4b")
    if phase("5b", f"a small {RG_ARCH}-family model served on the GPU and on the CPU"):
        serve_reference_check(torch, RG_ARCH)
        torch.cuda.empty_cache()

    if phase("6", f"federated LoRA (rank {LORA_RANK}) on {LORA_ARCH} at full width, "
                  f"{LORA_LAYERS} of its layers, M={LORA_M}, "
                  f"P={LORA_P}, {LORA_N} sequences of {LORA_SEQ} tokens a client: FLrce, "
                  "FedAvg, Fedcom"):
        timer = Timer(torch)
        fl_rows[f"{LORA_ARCH}-lora"] = lora_phase(torch, timer, bandwidth)
        del timer
        torch.cuda.empty_cache()

    if phase("6b", "a reduced gemma3 config, LoRA and full-model federations, GPU against CPU"):
        lora_reference_check(torch, worker)
        torch.cuda.empty_cache()

    if phase("7", f"federated LoRA (rank {LORA_RANK}) on {RG_ARCH} at full width, "
                  f"{RG_LORA_LAYERS} of its layers, M={LORA_M}, "
                  f"P={LORA_P}, {LORA_N} sequences of {LORA_SEQ} tokens a client: FLrce, "
                  "FedAvg, Fedcom"):
        timer = Timer(torch)
        fl_rows[f"{RG_ARCH}-lora"] = lora_phase(torch, timer, bandwidth, RG_ARCH, RG_LORA_D, "7",
                                                layers=RG_LORA_LAYERS)
        del timer
        torch.cuda.empty_cache()

    if phase("7b", f"{RG_ARCH}'s training, reduced configs in fp32, GPU against CPU"):
        rg_train_reference_check(torch, worker)
        torch.cuda.empty_cache()

    if phase("8", f"serve {XL_ARCH} at full width, {XL_B} requests x ({XL_PROMPT} prompt + "
                  f"{XL_GEN} generated) tokens"):
        model, params, _, xl_step_s, _ = serve_phase(torch, XL_ARCH, XL_B, XL_PROMPT, XL_GEN,
                                                     XL_PARAMS, XL_CONFIG_PARAMS)
        print(f"profile: device time by group of the {XL_ARCH} serve step")
        xl_serve_profile(torch, model, params, xl_step_s)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{XL_ARCH} at full width in fp32, {XL_FP32_POSITIONS} positions at "
              f"B={XL_FP32_B}: decode steps against forward")
        fp32_decode_check(torch, XL_ARCH, XL_FP32_B, XL_FP32_POSITIONS, XL_FP32_RTOL, XL_FAULTS,
                          XL_FAULT_AT)
        gc.collect()
        torch.cuda.empty_cache()

    if phase("8b", f"small {XL_ARCH}-family models served on the GPU and on the CPU"):
        serve_reference_check(torch, XL_ARCH)
        xl_cli_reference_check(torch)
        torch.cuda.empty_cache()

    if phase("9", f"federated LoRA (rank {LORA_RANK}) on {XL_ARCH} at full width, "
                  f"{XL_LORA_LAYERS} of its layers, M={LORA_M}, "
                  f"P={LORA_P}, {LORA_N} sequences of {LORA_SEQ} tokens a client in batches of "
                  f"{XL_LORA_BATCH}: FLrce, FedAvg, Fedcom"):
        timer = Timer(torch)
        fl_rows[f"{XL_ARCH}-lora"] = lora_phase(torch, timer, bandwidth, XL_ARCH, XL_LORA_D, "9",
                                                XL_LORA_BATCH, XL_LORA_LAYERS)
        del timer
        gc.collect()
        torch.cuda.empty_cache()

    if phase("9b", f"{XL_ARCH}'s training, reduced configs in fp32, GPU against CPU"):
        xl_train_reference_check(torch, worker)
        torch.cuda.empty_cache()

    if phase("10", f"examples/federated_pretrain_torch.py {' '.join(FEDLM_ARGS)}: a "
                   f"{FEDLM_D:,}-parameter LM federated through driver='scan'"):
        timer = Timer(torch)
        fl_rows["fedlm-100m"] = fedlm_phase(torch, timer, bandwidth)
        del timer
        torch.cuda.empty_cache()

    if phase("11", "the ported examples on the card against the CPU: flrce_vs_baselines, "
                   "federated_pretrain --size 5m, serve_decode for every architecture"):
        examples_phase(torch, worker)

    for arch, tag in ((MX_ARCH, "12"), (DBRX_ARCH, "12b")):
        layers = MOE_SERVE[arch][0]
        if phase(tag, f"serve {arch} at full width, {layers} of its layers, {MOE_B} requests x "
                      f"({MOE_PROMPT} prompt + {MOE_GEN} generated) tokens"):
            got = moe_serve_phase(torch, arch, bandwidth)
            launches[f"decode_attention@{arch}"] = got["decode_attention"]
            if arch == MX_ARCH:
                print(f"  {MX_ARCH} past its {MX_WINDOW}-slot window: its first layer at full "
                      f"width, {MOE_B} requests x ({MX_WRAPPED_LENGTH - MOE_GEN} prompt + "
                      f"{MOE_GEN} generated) tokens")
                launches[f"decode_attention@{MX_ARCH}-wrapped"] = moe_wrapped_serve(torch)

    if phase("12c", f"{MX_ARCH} and {DBRX_ARCH} at full width in fp32, {MOE_FP32_LAYERS} layers "
                    f"each, {MOE_FP32_POSITIONS} positions at B={MOE_FP32_B}: decode steps "
                    "against the drop-free forward"):
        for arch in (MX_ARCH, DBRX_ARCH):
            moe_fp32_check(torch, arch)

    if phase("12d", "small MoE models (mixtral and dbrx families), forward, loss and greedy "
                    "tokens on the GPU and on the CPU"):
        moe_reference_check(torch)
        torch.cuda.empty_cache()

    for arch, tag, layers, want_dim in ((MX_ARCH, "13", MX_LORA_LAYERS, MX_LORA_D),
                                        (DBRX_ARCH, "13b", DBRX_LORA_LAYERS, DBRX_LORA_D)):
        if phase(tag, f"federated LoRA (rank {LORA_RANK}) on {arch} at full width, {layers} of "
                      f"its layers, M={LORA_M}, P={LORA_P}, {LORA_N} sequences of {LORA_SEQ} "
                      "tokens a client: FLrce (twice), FedAvg, Fedcom"):
            timer = Timer(torch)
            fl_rows[f"{arch}-lora"] = lora_phase(torch, timer, bandwidth, arch, want_dim, tag,
                                                 layers=layers)
            del timer
            gc.collect()
            torch.cuda.empty_cache()

    if phase("13c", "small MoE models' training (mixtral and dbrx families, per-sequence "
                    "routing at capacity factors 1.25 and 0.5 and in groups of 16), GPU against "
                    "CPU"):
        moe_train_reference_check(torch, worker)
        torch.cuda.empty_cache()

    # every kernel row of the phases that ran (with no --phases, all of them)
    kernels = []
    for name in ("cross_gram", "gram", "weighted_aggregate", "topk_mask_rows", "decode_attention",
                 f"decode_attention@{RG_ARCH}", f"decode_attention@{MX_ARCH}",
                 f"decode_attention@{MX_ARCH}-wrapped", f"decode_attention@{DBRX_ARCH}",
                 "threefry_rounding", "threefry_normal"):
        if name not in rows or name not in launches:
            continue
        r = rows[name]
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            # topk_mask_rows: its path is the Fedcom run; decode_attention: the
            # gemma3-4b serve run (@recurrentgemma-2b: phase 4b's; @mixtral-8x22b:
            # phase 12's; its wrapped row: phase 12's run past the window;
            # @dbrx-132b: 12b's); threefry_rounding:
            # phase 2b's QuantizedFL run; threefry_normal: phase 4's gemma3-4b init;
            # the others: FLrce's
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    # the FL kernels at phase 6's and 7's operands (LoRA), and at phase 2f's
    # async round, with those runs' launches
    for tag in (f"{LORA_ARCH}-lora", f"{RG_ARCH}-lora", "async", f"{XL_ARCH}-lora",
                "fedlm-100m", f"{MX_ARCH}-lora", f"{DBRX_ARCH}-lora"):
        if tag not in fl_rows:
            continue
        lrows, llaunches = fl_rows[tag]
        for name in lrows:
            r = lrows[name]
            kernels.append({
                "name": f"{name}@{tag}", "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "launches": llaunches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
            })
    ends = [t for _, t, _ in starts[1:]] + [time.perf_counter()]
    print("phase seconds: " + ", ".join(f"{name} {end - t:.1f}"
                                        for (name, t, _), end in zip(starts, ends)))
    if worker is not None:
        print(worker.report(starts))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
