#!/usr/bin/env python3
"""Drive the PyTorch port (``areal_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, the result lines
    python3 chip_smoke.py --only spec,serve    # some phases, no result lines
    python3 chip_smoke.py --decode-times DIR   # kernel #1 of DIR's areal_tpu_torch
                                               # timed at the kernel phase's shapes
    python3 chip_smoke.py --flash-times DIR    # K2, K3 and K4 of DIR's areal_tpu_torch
                                               # timed at the kernel_flash phase's shapes
    python3 chip_smoke.py --gmm-times DIR      # the gmm forward of DIR's areal_tpu_torch
                                               # timed at the kernel_gmm phase's shapes
    python3 chip_smoke.py --gmm-bwd-times DIR  # gmm_bwd_lhs and tgmm of DIR's areal_tpu_torch
                                               # timed at the kernel_gmm_bwd phase's shapes
    python3 chip_smoke.py --tree-times DIR     # #4, #5 and #6 of DIR's areal_tpu_torch
                                               # timed on the kernel_tree phase's forests
          [--fwd FILE]                         # FILE: a #4 output, saved if missing,
                                               # else fed to DIR's #5 / #6

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles every ``areal_tpu_torch/csrc/*.cu`` with nvcc (one
              process per source, all at once).
3. kernel   — the paged decode-attention kernel (#1) against its plain
              PyTorch twin at the serving shapes of Qwen2.5-1.5B (H=12, KH=2,
              hd=128, psz=128, S=32, 28-layer stacked cache, layer 5) and
              of Qwen3-30B-A3B (H=32, KH=4: G=8, 48 layers), ragged lengths
              and shared pages, for bf16, int8 and fp8 pages: the largest
              difference, the element-wise check against f32 with two
              planted faults, the split count (first launch under sync-debug
              "error"), registers and blocks an SM; kernel / plain /
              SDPA-yardstick times (graph replay, host loop beside) and the
              bound.
4. kernel_flash — the flash-attention forward K2 against its plain PyTorch
              version at three shapes: the trainer's packed grid (12 rows
              of 1,024 from the train phase's sequences, padded tails) with
              Qwen2.5-1.5B's heads (H=12, KV repeated from 2) and with
              Qwen3-30B-A3B's (H=32 from 4), and a long-rollout grid (2
              rows of 8,192: segments 8,192 and 5,000 + 3,000), hd=128,
              bf16: O element by element, lse, padding zeros, O's bits with
              and without lse, four planted faults, sync-debug "error" on
              the first launch, occupancy and tile-pair counts; K2 and SDPA
              times by graph replay (host loop beside) and the bound. Then,
              at each shape, K3 (dK, dV) and K4 (dQ) against theirs on K2's
              lse: dq, dk, dv element by element, exact zeros on padding
              rows, the same bits on a second call and from a CUDA-graph
              replay, three planted faults, sync-debug "error" on the first
              launches, occupancy; K3, K4 and SDPA's backward by graph
              replay (host loop beside) and the bounds.
5. kernel_suffix — the paged suffix-attention kernel (#3) against its plain
              version at the same two head configs: a warm suffix prefill (8 rows
              of 64..256 suffix tokens over a shared 1,024-token prefix) and
              speculative verify (S=32, prefixes 1..2048, B=5 chains and B=9
              trees), bf16 / int8 / fp8 pages, planted faults; kernel / plain
              / SDPA-yardstick times and the bound.
6. serve    — an ``InferenceServer`` over Qwen2.5-1.5B (full width and
              depth, random bf16 weights from a seed) at the prefix-cache
              settings of ``ServerConfig()`` answers 16 concurrent /generate
              requests; checks completeness, logprobs against a dense
              prefill and kernel #1's launch count. Then 16 requests sharing
              a 1,024-token system prompt: radix hits, kernel #3's chain
              launches, logprobs, and the pool's accounting after
              /flush_prefix_cache. Then the version tags across a
              mid-generation weight update.
7. serve_int8 — a short second engine with int8 KV pages.
8. rollout  — the rollout half of the asynchronous GRPO loop over HTTP: an
              ``InferenceServer`` over Qwen2.5-1.5B (the serve phase's
              settings) and ``RemoteTorchEngine`` (8 rollouts at once, batches
              of 4, staleness bound 1) run ``prepare_batch`` with
              ``RLVRWorkflow`` (4 samples x 128 tokens, the synthetic
              target-token reward) three times over 16 prompts. One episode
              is cancelled once (/abort_request reaps its requests; the
              executor retries it), and a pause / set_version(1) / continue
              lands while the second call's rows decode. Checks the rows'
              layout and completeness, logprobs against a dense prefill, the
              version tags across the pause and the staleness bound, the
              resumed requests' KV resumes, the retried episode's radix hits
              (kernel #3), the capacity and the
              peak of active slots, kernel #1's launches per decode step, the
              executor's retry counters and the pool audit; prints the loop's
              tokens/s beside the serve phase's, task latency and the pause.
9. lifecycle — the serving engine's request lifecycle at Qwen2.5-1.5B
              (full width, CUT_LAYERS = 4 of 28 layers; the serve phase's settings), over HTTP through
              ``RemoteTorchEngine``: (a) 16 greedy requests abort-paused and
              resumed from their parked KV (no prefill, the tokens of an
              uninterrupted run, pause -> first resumed token beside a
              re-prefill through #3); (b) the same across a staged update of
              perturbed weights, with and without kv_reuse_across_updates;
              (c) the frequency penalty against a teacher-forced dense
              forward, across an abort; (d) deadlines, mid-decode and in the
              queue; (e) the 429 gate (max_queue_depth pushed through
              /autopilot/knobs) and the client's backpressure; (f) /drain,
              /health and /generate while draining, /undrain; (g) release /
              resume memory. The pool audit and the #1 / #3 launches.
10. observe  — the serving engine's observability at Qwen2.5-1.5B (full
              width, CUT_LAYERS = 4 of 28 layers; the serve phase's settings) over HTTP: a cold wave, a warm wave on
              a shared 1,024-token system prompt (radix hits, #3) with a 2 s
              ``POST /debug/profile`` capture during it, 16 requests
              abort-paused and resumed from parked KV through
              ``RemoteTorchEngine``, a wave across a staged weight update in
              the hold fence, one 429. Checks every response's timing fields
              + ``other_s`` against its latency (5 ms), the decode-loop
              probe's identity on every recorded pass, /statusz ``hbm``
              against the allocator, the Prometheus text line by line, the
              flight ring's kinds, ``decode_kernel`` in the capture's trace;
              prints the waves' breakdowns, the resumes' continue -> first
              token split, the probe's phase means, dominant phase and
              roofline fraction, and the probe's own cost per pass.
11. spec     — speculative decoding (ngram, then tree drafter): greedy
              tokens equal to a non-speculative engine's with the same
              weights, kernel #3's tree launches, rounds / accepted /
              rollback pages, the pool's accounting.
12. train    — two asynchronous-GRPO steps at full width and depth: the
              ``DecodeEngine`` generates 8 prompts x 4 samples (duplicates
              alias the first sample's pages), the ``TorchTrainEngine``
              recomputes proximal logprobs (K2), ``PPOActor`` computes
              advantages and runs ``ppo_update`` (two minibatches: K2 + K3 +
              K4 under per-layer checkpointing, then AdamW),
              ``update_weights`` pushes the weights into the running engine
              (the radix tree flushes), and the next wave carries version 1.
              Checks the logprobs on both waves, finite loss and grad norm
              (and the plain attention's grad norm on one minibatch), moved
              weights, version tags and every kernel's launch count.
13. grpo     — the whole GRPO loop over HTTP at full width and depth:
              ``PPOTrainer.train`` (3 global steps) with a
              ``TorchTrainEngine`` (``train``'s actor settings, a constant
              LR) and ``RemoteTorchEngine`` (16 rollouts at once, batches of
              8 prompts x 4 samples x 128 tokens, staleness bound 1, the
              hold fence) against an ``InferenceServer`` over Qwen2.5-1.5B
              started from the trainer's weights in bf16 (the serve phase's
              settings, staging on the card). Each step streams 3.09 GB of
              bf16 buckets while generation runs and commits them inside the
              hold fence. Checks, after every step, that the server's, the
              client's and the trainer's versions are global_step + 1 and
              every served parameter equals the trainer's master weight cast
              to bf16 bit for bit; no request aborted and every hold
              answered fenced; every row complete with monotone version tags
              within the staleness bound; the trainer's logprobs against the
              served ones on the first batch; K2-K4, #1 and #3 launches.
              Prints per step the phase times, stage and fence seconds,
              tokens generated during the update and the rows spanning a
              commit; staging GB/s, decode step wall time while staging
              beside the other steps, trainer tokens/s and peak memory.
13b. shard   — the trainer across GPUs: grpo's actor at full width and
              CUT_LAYERS = 4 of 28 layers (the script's time limit), unsharded in this
              process, then under ``torchrun`` (one rank a card, NCCL; a
              world of one on one card, fsdp x model 2 on several) in
              ``--shard-worker``: 2 ``train_batch`` steps on one fixed batch
              of 32 sequences each, the parameters compared (bit for bit
              at one rank), K2-K4 launches equal, the server's weights after
              the sharded push, a recover dump each way (parameters; the
              moments cross on the CPU twins), step seconds and peak memory
              beside the unsharded engine's; then 2 steps of
              ``PPOTrainer.train`` under ``allocation_mode`` over HTTP.
14. durable  — the trainer's durable state at Qwen2.5-1.5B, full width and
              CUT_LAYERS = 4 of 28 layers (the grpo phase's actor settings and the serve phase's
              server settings): (a) the disk free at the phase's root and an
              HF export of the trainer's f32 weights (GB, s, GB/s); (b) an
              ``InferenceServer`` started from the export by
              ``ServerConfig.model_path``, its served bf16 weights equal to
              the trainer's bit for bit, a wave of 16 (#1 launches); (c) a
              disk update through ``RemoteTorchEngine`` under the hold fence
              while a wave decodes, after two more optimizer steps (the
              fence's seconds, the version, bit for bit again); (d) a
              ``PPOTrainer`` with ``recover.mode="auto"``, ``freq_steps=1``:
              two steps with async dumps (the step loop's pause per dump, the
              write's GB/s and bytes); (e) a preemption requested as step 3's
              rollout wait begins: the emergency (sync) dump of step 2, then
              a fresh trainer of other weights resumes at step 3 with the
              dumped parameters, moments and step count bit for bit and runs
              it (K2-K4 launches); (f) offload / onload of the resumed actor
              (GB freed, seconds, bit for bit after). Deletes its directory
              (``_durable/``) at its end.
15. critic   — PPO with a learned critic over HTTP at Qwen2.5-1.5B (full
              width, CUT_LAYERS = 4 of 28 layers):
              ``PPOTrainer.train`` (2 global steps) with the grpo phase's
              actor and client and ``PPOCriticConfig.path`` set to the
              actor's HF export, so the trainer builds the critic (the
              actor's dims, a zero value head). Checks the critic's body
              equal to the actor's, step 1's values exactly 0 and its returns
              the plain GAE of its rewards, step 2's values nonzero and
              finite, finite critic loss and value clip ratio, pushes that
              carry the actor's parameters only, and K2-K4 launches with the
              critic's ``compute_values`` forward and updates; prints the
              step's phases, the critic's tokens/s and the peak memory.
16. sft      — SFT, the reward model and the remat policies at Qwen2.5-1.5B,
              full width and CUT_LAYERS = 4 of 28 layers, from an HF export of seeded
              random weights:
              ``SFTTrainer.train`` (4 steps of 8 rows, an eval pass every 2
              steps) and ``RWTrainer.train`` (4 steps of 8 pairs in
              microbatches of at most 4,096 tokens; ``n_pairs`` intact), each
              building its engine from ``TrainEngineConfig.path``; then one
              SFT step from the same weights on the same batch under
              "nothing", "dots_nobatch" and "everything", in two rounds:
              the parameters after "dots_nobatch" against "nothing"'s, each
              policy's peak memory, step seconds and K2-K4 launches.
17. int8serve — int8 weight serving at Qwen2.5-1.5B, full width and CUT_LAYERS = 4 of
              28 layers (since PR 24)
              (``gsm8k_grpo_int8serve.yaml``: ``quantization="int8"``,
              ``kv_quantization="int8"``): a server started from the grpo
              phase's trainer, its int8 tables and scales the server-side
              quantization of the trainer's bf16 export bit for bit; the
              serve phase's cold and warm waves (16 + 16, a shared
              1,024-token prompt) on it and on a bf16-weight server of the
              same settings in the same process (ms per decode step, the
              probe's dispatch share, the ledger's params bytes, #1 / #3
              launches, logprobs against a dense prefill of the served
              model); a q8 update to the bf16 server and an adapter fold
              into the int8 engine, both refused with no weight changed;
              then ``PPOTrainer.train`` for 2 steps over HTTP with
              ``weight_update_wire="auto"`` (resolved to q8): after each
              step the served tables are the q8 transform of the trainer's
              f32 master weights bit for bit; the q8 update's wire bytes
              against bf16's (0.577 reckoned), stage and fence seconds,
              K2-K4 and #1 launches.
18. lora     — LoRA at Qwen2.5-1.5B, full width and CUT_LAYERS of its depth
              (``gsm8k_grpo_lora.yaml``: rank 32, alpha 16, wq / wk / wv /
              wo over the grpo phase's actor): a server started from the
              trainer's adapter-free export; ``PPOTrainer.train`` for 2
              steps over HTTP whose pushes carry only the adapters (the
              server folds them into its base); one more adapter push
              timed beside a full push, then an adapter push after the full
              one, refused with no weight changed. Checks the base
              parameters bit for bit, the adapters moved, the served weights
              against the merged export within bf16 rounding, K2-K4 / #1
              launches; prints each push's bytes and seconds, trainer
              tokens/s and the peak memory (predicted 17 GiB below grpo's:
              the base has no gradients or AdamW moments).
19. vlm      — a vision-language model, Qwen2-VL-2B at full width and
              depth (the 32-layer tower, the 28-layer LLM; random bf16
              weights from a seed): an ``InferenceServer`` (``ServerConfig()``
              with ``max_seq_len`` 2,048) answers a wave of 16 image requests
              over HTTP (8 CLEVR-style prompts of 217 tokens, each sent with
              two seeded images of grid (1, 22, 34): 748 patches padded to
              768, 187 image pads) and 4 text requests, 128 tokens each:
              responses complete, served logprobs against a dense bf16
              prefill with the same embeddings, the engine's embeddings
              equal to a direct tower call bit for bit and only at the image
              pads, equal ids with other images neither aliased nor
              radix-matched (different first steps; a second wave on the
              published prompts matches nothing), #1 launches; tower ms an
              image (device stream, host loop), prefill tokens/s, ms a decode
              step, the device's busy share of a profiled wave. Then
              ``PPOTrainer.train`` for 2 GRPO steps over HTTP with
              ``VisionRLVRWorkflow`` (a seeded stand-in processor, the
              clevr_count reward), 8 prompts x 4 samples and the frozen
              tower: the trainer's logprobs against the served ones, the
              tower bit for bit unchanged on both sides, one tower run per
              engine batch (and one for a batch passed twice), K2-K4 and #1
              launches, step seconds by phase and the peak memory. Then,
              with the server stopped, one ``train_vision_tower=True`` step
              on 1 prompt x 4 samples: its logprobs against the frozen
              path's at the same weights, the tower moved and finite, the
              peak memory.
20. kernel_tree — the tree-attention kernels #4 (forward), #5 (dQ) and #6
              (dK, dV) against their plain PyTorch versions at the same head
              config on two forests of N=2,048 padded nodes: the first pack
              of the train_tree wave (prompts of 445 and 349 tokens, 4
              branches of 128 each) and an agentic trie branching at several
              depths; three planted faults in the mask words; the 64-row
              tile pairs the kernels walk (live, full, partial, the longest
              walks) and their registers, spills, shared memory and blocks
              an SM at hd 64 and 128; kernel / plain / SDPA-yardstick times
              (kernels and SDPA by graph replay, the host loop beside), #4
              against SDPA's forward, #5 + #6 against its backward, and the
              bounds over the set bits. Then #4-#6 on the card tests' walk
              tries (a chain, tile-straddling groups, all-partial chains, a
              GRPO forest of 4,096 rows) at hd 64 and 128: O's and lse's
              worst elements as shares of their limits.
21. train_tree — ``train``'s two GRPO steps with ``tree_training=True`` and
              one minibatch per step (full width, CUT_LAYERS = 4 of 28 layers): each prompt's samples merge into a
              trie, packed into forests of at most 2,048 nodes, and forward
              and backward run once per node through #4-#6 (the proximal
              recompute stays on K2). Checks the dedup counts against a host
              count, the launches per pack, and the tree path's logprobs and
              grad norm against the packed path's on the same batch and
              weights; profiles one tree optimizer step (#4's, #5's and #6's
              shares of its busy time).
22. kernel_gmm — the grouped-matmul forward (the dropless MoE FFN's GEMM, in
              place of megablox gmm) against its plain version at
              Qwen3-30B-A3B's expert shapes (128 experts, top-8, bf16 in,
              f32 out; gate / up and down) for a decode step (M=256), a
              prefill group (M=32,768) and train_moe's two microbatch sizes
              (M=49,152 and 8,192, 64 rows past the groups) routed by a
              seeded softmax, plus ragged cases in every bf16 regime and f32
              row tile; three planted faults, the same bits twice; the bf16
              kernels' registers, spills, shared memory and blocks an SM;
              kernel (graph replay, host loop beside, each regime forced) /
              plain / library-yardstick times and the bound; one MoE
              dispatch under sync-debug "error".
23. kernel_gmm_bwd — the grouped matmul's backward kernels (megablox's
              VJP: dLHS ``gmm_bwd_lhs`` and dRHS ``tgmm``) against their
              plain versions at Qwen3-30B-A3B's expert shapes (gate / up
              and down) for M = 32,768 and M = 8 x the tokens of
              train_moe's minibatch grid, f32 cotangent, f32 and bf16
              outputs, 64 rows past the groups; three planted faults; the
              bf16 kernels' registers, spills, shared memory and blocks an
              SM; kernel (graph replay, host loop beside) / plain / f32
              torch.mm loop / torch._grouped_mm on hi and lo side by side
              (the same function) and on bf16(grad) (another) times and the
              bound.
24. serve_moe — an ``InferenceServer`` over Qwen3-30B-A3B (full width,
              SERVE_MOE_LAYERS = 4 of its 48 layers since the moe_ep
              phase's trainer came (8 since moe_ep, 16 since serve_tp, 24
              since shard), 128 experts,
              top-8, random bf16 parameters from a seed)
              at the prefix-cache settings of ``ServerConfig()``: a cold
              wave of 16 requests, a warm wave of 8 on a shared 1,024-token
              system prompt, /flush_prefix_cache and the pool audit;
              logprobs against a dense prefill (near-tie route flips
              exempt and counted), the gmm / #1 / #3 launches per wave,
              experts touched per decode step, a profiled wave.
25. train_moe — ``train``'s two GRPO steps on Qwen3-30B-A3B at full width
              and 4 of its 48 layers (3.11 B parameters; the trainer's f32
              state of the whole depth does not fit one card): the grouped
              matmuls' forward and backward kernels under per-layer
              checkpointing, router and experts pushed into the running
              engine. Checks the trainer's logprobs against the served ones
              (near-tie route flips exempt, counted), the launches of gmm,
              gmm_bwd_lhs and tgmm, moved weights and version tags; on one
              minibatch the kernel backward's gradient against the plain
              backward's (norm and cosines; experts no token reached get
              exact zeros); one MoE tree step through
              ``tree_forward_logprobs_pallas`` against the packed path; a
              profiled optimizer step (the gmm forward's and its backward
              kernels' shares of its busy time) and the peak memory.
26. entry    — the entry layer, the way a user starts the system: (a)
              ``areal_tpu_torch.examples.math.gsm8k_rl.main`` on
              ``examples/smoke/synthetic_grpo.yaml`` plus overrides (a
              written Qwen2.5-1.5B ``config.json``, full width and depth,
              random weights from the YAML's seed, bf16 compute,
              ``max_seq_len`` 256, 2 steps of 8 prompts x 4 samples x 8
              tokens): every response complete, finite losses, the version
              advancing with each push, #1 / K2 (with and without lse) / K3
              / K4 / #3 launches, step seconds by phase; (b) the YAML as it
              stands (the tiny head_dim-16 f32 model): the paged kernel's
              own refusal at the server's start, no server thread left; (c)
              ``python -m areal_tpu_torch.inference.server`` as a
              subprocess (``precompile``, the preemption drainer) over a
              4-layer HF export from a seed: ``gsm8k_eval.main`` in fleet
              mode on 32 rows of synthetic_arith's test split, the greedy
              tokens of 8 requests equal to an in-process engine's on the
              same export, SIGTERM draining it to its exit code with a
              flight dump. Seconds to /health, eval n / accuracy, the
              drain's seconds.
27. serve_tp — serving on a ``model=2`` mesh (tensor parallelism):
              Qwen2.5-1.5B at full width (CUT_LAYERS = 4 of 28 layers on one card since
              the moe_ep phase came, all 28 on two or more) with the serve phase's
              ``ServerConfig``, a lead and one spawned follower, each rank
              on 6 heads and 1 KV head; the unsharded engine on the same
              seeds first, as the yardstick. Over HTTP: the cold and warm
              waves, 8 greedy requests under n-gram speculation, a staged
              push of other weights (every rank's slices then the pushed
              bf16 bits). #1 and #3 launches on every rank, greedy tokens
              against the yardstick's but at near-ties, logprobs against a
              dense prefill, the pool audit, no follower left after stop.
              One card: both ranks on it over gloo (a stand-in, at
              SERVE_TP_STANDIN_NEW new tokens a request). On four
              cards: NCCL on cards 0-1 at 128 new tokens, int8 weights on
              int8 pages, and the disaggregated loop (the server CLI on
              cards 0-1, ``PPOTrainer.train`` under ``torchrun`` on cards
              2-3 with ``sglang:d1t2+fsdp:d2``, 2 steps over HTTP, the
              server's slices against the trainer's export by
              ``/debug/weights``, a SIGTERM drain).
28. moe_ep   — MoE over the ``expert`` axis, Qwen3-30B-A3B at full width.
              One card: (a) one MoE layer's expert ranks (e = 2, 4) run
              in one process, each on its E / e experts, their partial
              outputs and gradients summed against the unsharded layer
              (out, aux, dh, router and expert gradients), gmm 3 launches
              a rank and gmm_bwd_lhs / tgmm 3 each; (b) a server on
              ``mesh.expert=2`` at 8 of 48 layers, both ranks on the card
              over gloo (a stand-in), against the unsharded engine on the
              same seeds: a cold wave of 8 requests, greedy tokens equal
              but at recorded near-ties, logprobs against a dense
              prefill, gmm and #1 on every rank, the pool, a staged push
              over HTTP (every rank's slices the pushed bits, by their
              sha256); (c) the trainer
              on ``expert=2`` under ``torchrun``, both ranks on the card
              over gloo, against the unsharded engine. Four
              cards instead: the trainer at fsdp 2
              x expert 2 against the unsharded engine at 4 layers, then at
              16 of 48 (peak and tokens/s a rank); the server at all 48
              layers on expert=4 and on model=2 x expert=2 over NCCL
              against the unsharded engine at the same depth; the
              disaggregated loop ``sglang:d2e2+fsdp:d2e2`` (the CLI server
              on ``mesh.expert=2`` on cards 0-1, the trainer on 2-3), 2
              steps over HTTP and a SIGTERM drain.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Needs one card; builds into
``areal_tpu_torch/_build/``; no network.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# Qwen2.5-1.5B (the model bench.py serves on the TPU): full width and depth
QWEN25_15B = dict(
    vocab_size=151936,
    hidden_size=1536,
    intermediate_size=8960,
    num_layers=28,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    attention_bias=True,
    dtype="bfloat16",
)
# the depth of the phases whose checks are about behaviour, not the main
# path's speed (lifecycle, observe, durable; since the int8serve and lora
# phases came, critic, sft and train_tree too; since the vlm phase came,
# int8serve; since the entry phase came, shard; since the serve_tp phase came,
# lora; since the moe_ep phase came, serve_tp on one card): 4 of Qwen2.5-1.5B's
# 28 layers at full width, so the whole script stays inside its time limit on
# a slow host (1,170 s of phases at full depth on one; 1,000 s with all but
# the first three at full depth on another; 954 s with shard at full depth on
# another; 1,025.5 s with serve_tp and lora at full depth on another; 1,248.1
# s with serve_tp at full depth and these at 8 once moe_ep came, each on one
# H100 80GB HBM3 at 700 W, PERF.md; 8 layers until moe_ep's one-card trainer
# joined the default run); serve, rollout, train, grpo and entry run all 28,
# vlm all of Qwen2-VL-2B
CUT_LAYERS = 4
# serve_moe's depth: 4 of Qwen3-30B-A3B's 48 layers, to keep the whole
# script in its limit (1,106.5 s of phases on a slow host with all 48 once
# the shard phase came, then 24; 1,025.5 s with 24 once serve_tp came, then
# 16; 1,248.1 s with 16 once moe_ep came, then 8; 4 since moe_ep's one-card
# trainer joined the default run; on one H100 80GB HBM3 at 700 W, PERF.md);
# moe_ep serves 8 on one card and all 48 on four
SERVE_MOE_LAYERS = 4
# Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B config.json): the
# qwen3_moe family's smallest public member, full width and depth
QWEN3_30B_A3B = dict(
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,
    num_layers=48,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=False,
    attention_bias=False,
    qk_norm=True,
    num_experts=128,
    num_experts_per_tok=8,
    moe_intermediate_size=768,
    norm_topk_prob=True,
    dtype="bfloat16",
)
# the attention kernels' head configs: (H, KH, layers of the stacked cache);
# Qwen3-30B-A3B's G = 32 / 4 = 8 is kernel #1's kMaxG; "tp2" is one rank's
# share of Qwen2.5-1.5B on a model=2 serving mesh (serve_tp)
HEADS = {"qwen2.5-1.5b": (12, 2, 28), "qwen3-30b-a3b": (32, 4, 48), "qwen2.5-1.5b/tp2": (6, 1, 28)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12}  # dense tensor-core rates
# kernel vs plain, max |diff| on O(1) outputs: the plain twin rounds logits
# and probabilities to bf16 (as the JAX twin does) while the kernel keeps
# f32 throughout; bf16 keeps 8 significant bits (2^-8 ~ 4e-3 relative),
# times a margin of 5
KERNEL_TOL = 2e-2
# served logprob vs a dense bf16 prefill of prompt+output: both paths round
# to bf16 at different points across 28 layers; on logits of O(1) spread
# that is ~1e-2 per logit, held with a margin of 10. The same bound holds the
# trainer's recomputed logprobs (flash kernels, logits rounded to bf16 as the
# JAX trainer rounds them) against the served ones.
LOGPROB_TOL = 0.1
# flash kernels vs their plain versions on the same bf16 inputs, element by
# element on valid rows: |kernel - plain| <= FLASH_RTOL |plain| + FLASH_ATOL
# rms(plain). The plain versions keep S, dP and every sum in f32 (the
# backward's also rounds P and dS to bf16 where the kernels feed the tensor
# cores), so what remains is the kernels' bf16 output rounding (2^-8
# relative) and their f32 summation order: FLASH_RTOL is two bf16 steps, and
# FLASH_ATOL, for entries whose sums cancel to near zero, sits between the
# kernels' need (~1e-2 rms) and that of a planted fault such as S or dP
# rounded to bf16 (~1e-1 rms); _flash_check fails if a planted fault passes
FLASH_RTOL = 2**-7
FLASH_ATOL = 2**-5
# grad norm with the plain attention vs the kernels on one minibatch, the
# proximal logprobs recomputed at the current weights (PPO ratio ~1, so no
# token sits at the clip boundary): the two round to bf16 at different
# points in every layer's forward, recompute and backward, which moved the
# norm by 0.16% (PR 2's run); six times that
GRAD_NORM_RTOL = 1e-2
# kernel #3 vs its plain version, element by element on rows with a valid
# mask bit, by the flash kernels' rule: the plain version keeps every product
# and sum in f32 on the same bf16 / int8 / fp8 inputs, the kernel rounds P
# (times the V scale) to bf16 for the tensor cores, and both round the output
# to bf16 once. Rows with no valid bit must be exact zeros.
SUFFIX_RTOL = FLASH_RTOL
SUFFIX_ATOL = FLASH_ATOL


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_cuda_graph(fn, iters: int = 20, reps: int = 5, stream: torch.cuda.Stream | None = None) -> float:
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's time to
    launch a call is not in the number (``time_cuda`` measures what an
    eager caller waits, which for a short kernel is the host's). ``stream``
    warms up and captures on a given stream (an autograd backward runs on
    its forward's stream, so it is captured on that one)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (reps * iters)
    del graph
    return ms


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(names: list[str] | None = None) -> None:
    from areal_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build(names)
    log(f"[build] {names or _build.sources()} built in {time.monotonic() - t0:.1f}s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _kernel_inputs(kv: str, seed: int = 0, heads: tuple = HEADS["qwen2.5-1.5b"]):
    """Stacked cache + ragged page tables at the serving shapes of one head
    config (H, KH, layers)."""
    from areal_tpu_torch.inference import paged_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    (H, KH, L), hd, psz, S, wp = heads, 128, 128, 32, 16
    N = S * wp + 1
    lengths = np.concatenate(
        [[1, psz - 1, psz, psz + 1, wp * psz, wp * psz - 1], rng.integers(1, wp * psz + 1, S - 6)]
    ).astype(np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pt = np.zeros((S, wp), np.int32)  # unused columns stay on trash page 0
    for s in range(S):
        need = -(-int(lengths[s]) // psz)
        pt[s, :need] = perm[s * wp : s * wp + need]
    # shared pages: slots 7 and 8 alias slot 6's first 3 pages
    pt[7, :3] = pt[6, :3]
    pt[8, :3] = pt[6, :3]
    shape = (L, KH, N, psz, hd)
    q = torch.randn((S, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    scales = {}
    if kv != "bf16":
        qd = paged_kv.quant_dtype(kv)
        k, ks = paged_kv.quantize_kv(k, qd)
        v, vs = paged_kv.quantize_kv(v, qd)
        scales = dict(k_scales=ks, v_scales=vs)
    return (
        q,
        k,
        v,
        torch.from_numpy(lengths).cuda(),
        torch.from_numpy(pt).cuda(),
        scales,
    )


def _bound(kv: str, lengths: np.ndarray, S: int, H: int, KH: int, hd: int, psz: int, wp: int):
    """Least time for the work these inputs need: each input byte read once
    (only the rows below each length), each output written once; ops are
    2 flops per multiply-add of q.k and p.v at the tensor-core rate."""
    rows = np.minimum(lengths.astype(np.int64), wp * psz)
    elem = 2 if kv == "bf16" else 1
    kv_bytes = int(rows.sum()) * KH * hd * 2 * elem
    if kv != "bf16":
        kv_bytes += int(rows.sum()) * KH * 2 * 4  # narrow f32 scales
    pt_bytes = int(np.ceil(rows / psz).sum()) * 4
    qo_bytes = 2 * S * H * hd * 2 + S * 4
    nbytes = kv_bytes + pt_bytes + qo_bytes
    ops = 4 * int(rows.sum()) * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kv] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel() -> dict:
    """Kernel #1 against its plain version at each head config of HEADS:
    Qwen2.5-1.5B's (keys "bf16", "int8", "fp8") and Qwen3-30B-A3B's G = 8
    (keys "qwen3-30b-a3b/<kv>"). Each shape: the largest difference from the
    plain version (KERNEL_TOL) and the element-wise check against it in f32
    (#3's rule), two planted faults that must fail that check, the split
    count P (the first launch under sync-debug "error"), the kernel's
    registers and blocks an SM, and kernel / plain / SDPA times with the
    bound (``_decode_timings``)."""
    per: dict[str, dict] = {}
    for tag, heads in HEADS.items():
        per.update(_kernel_heads(tag, heads))
    return per


def _decode_timings(q, k, v, lengths, pt, sc: dict) -> dict:
    """Kernel #1 and its SDPA yardstick on one shape: device ms by CUDA-graph
    replay (``ms``, ``library_ms``) and the host loop beside them (what an
    eager caller waits, launch included). Timed launches cycle over the
    stacked cache's layers, so each call finds its pages cold in the 50 MB
    L2 as a decode step does. Uses only ``paged_attention_stacked``, so it
    times any tree's kernel (``--decode-times``)."""
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    ks, vs = sc.get("k_scales"), sc.get("v_scales")
    S, H, hd = q.shape
    nl, KH, psz, wp = k.shape[0], k.shape[1], k.shape[3], pt.shape[1]
    it = iter(range(10**9))
    kernel = lambda: paged_attention_stacked(q, k, v, next(it) % nl, lengths, pt, **sc)  # noqa: E731
    res = dict(ms=time_cuda_graph(kernel), host_ms=time_cuda(kernel, iters=56))
    # yardstick: one SDPA call over the window already gathered (and
    # dequantized) — the port never calls it; the gather is outside the
    # timed calls, 4 layers' windows (> 50 MB together) cycled like the kernel's
    W = wp * psz
    ptl = pt.long()

    def gathered(pages, scales, j):
        gth = pages[j][:, ptl].reshape(KH, S, W, hd).permute(1, 0, 2, 3)
        if scales is None:
            return gth.contiguous()
        s_ = scales[j][:, ptl].reshape(KH, S, W, 1).permute(1, 0, 2, 3)
        return (gth.float() * (s_ / 127.5)).to(torch.bfloat16).contiguous()

    kvg = [(gathered(k, ks, j), gathered(v, vs, j)) for j in range(4)]
    mask = (torch.arange(W, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, *kvg[next(it) % 4], attn_mask=mask, enable_gqa=True)
    res.update(library_ms=time_cuda_graph(sdpa), library_host_ms=time_cuda(sdpa))
    del kvg
    return res


def _kernel_heads(tag: str, heads: tuple) -> dict:
    from areal_tpu_torch.ops import paged_attention as pa_mod
    from areal_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import merge_splits_plain

    li = 5
    first = tag == "qwen2.5-1.5b"
    per: dict[str, dict] = {}
    for kv in ("bf16", "int8", "fp8"):
        q, k, v, lengths, pt, sc = _kernel_inputs(kv, heads=heads)
        ks, vs = sc.get("k_scales"), sc.get("v_scales")
        S, H, hd = q.shape
        KH, psz, wp = k.shape[1], k.shape[3], pt.shape[1]
        G = H // KH
        occ = pa_mod.occupancy(hd, k.dtype)
        with torch.no_grad():
            # the first launch of the shape under sync-debug "error": the
            # split count and scratch come from shapes, no host sync
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = paged_attention_stacked(q, k, v, li, lengths, pt, **sc)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            splits = paged_attention_stacked.splits
            torch.cuda.synchronize()
            kl, vl = k[li], v[li]
            scl = (ks[li], vs[li]) if ks is not None else (None, None)
            ref = paged_attention_plain(q, kl, vl, lengths, pt, *scl)
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > KERNEL_TOL:
                raise AssertionError(f"[kernel] {tag} {kv}: max|kernel - plain| = {err} > {KERNEL_TOL}")
            # element by element against the plain version in f32 (#3's
            # rule): f32 q, bf16 pages' values in f32, every sum in f32
            kf, vf = (kl.float(), vl.float()) if kv == "bf16" else (kl, vl)
            ref32 = paged_attention_plain(q.float(), kf, vf, lengths, pt, *scl)
            live = (lengths > 0)[:, None, None]

            def excess(x):
                return _suffix_excess(x[:, None], ref32[:, None], live)

            share, rms, err32 = excess(out)
            if not share <= 1.0:
                raise AssertionError(f"[kernel] {tag} {kv}: off its f32 plain version by {share:.3f} x the limit "
                                     f"(rms {rms:.4f}, max|diff| {err32:.3e})")
            # planted faults: the last split that holds a token left out of
            # the merge (from the plain split twin), and the V scale left out
            parts = [pa_mod.decode_split_partials_plain(q.float(), kf, vf, lengths, pt, *scl,
                                                        n_splits=splits, split=p) for p in range(splits)]
            o_part, lse_part = torch.stack([o for o, _ in parts]), torch.stack([x for _, x in parts])
            last = max(p for p in range(splits) if torch.isfinite(lse_part[p]).any())
            lse_part[last] = -torch.inf
            faults = {"last non-empty split dropped": merge_splits_plain(o_part, lse_part, 1, G).reshape(S, H, hd)}
            if kv != "bf16":
                faults["V scale left out"] = paged_attention_plain(q.float(), kf, vf, lengths, pt, scl[0],
                                                                   torch.ones_like(scl[1]))
            fault_x = {n: excess(f)[0] for n, f in faults.items()}
            for n, fx in fault_x.items():
                if not fx > 1.0:
                    raise AssertionError(f"[kernel] {tag} {kv}: the check passes a planted fault ({n})")
            del parts, o_part, lse_part, faults, ref32, kf, vf
            t = _decode_timings(q, k, v, lengths, pt, sc)
            it = iter(range(10**9))
            nl = k.shape[0]

            def plain_call():
                j = next(it) % nl
                return paged_attention_plain(
                    q, k[j], v[j], lengths, pt,
                    ks[j] if ks is not None else None, vs[j] if vs is not None else None,
                )

            plain_ms = time_cuda(plain_call, iters=10)
            if kv == "bf16" and first:
                # uniform lengths: per-step slope vs the floor of a launch
                for n in (128, 512, 2048):
                    un = torch.full_like(lengths, n)
                    tu = time_cuda_graph(lambda: paged_attention_stacked(q, k, v, next(it) % nl, un, pt))
                    log(f"[kernel] bf16 pages, every slot at {n} rows: kernel={tu:.4f} ms (graph replay) "
                        f"bound={_bound(kv, un.cpu().numpy(), S, H, KH, hd, psz, wp)[0]:.4f} ms")
        bound_ms, bound_by = _bound(kv, lengths.cpu().numpy(), S, H, KH, hd, psz, wp)
        per[kv if first else f"{tag}/{kv}"] = dict(max_abs_err=err, share=share, plain_ms=plain_ms, bound_ms=bound_ms,
                                                   bound_by=bound_by, splits=splits, occupancy=occ, **t)
        log(
            f"[kernel] {'' if first else f'{tag} (H={H}, KH={KH}, G={G}, {k.shape[0]} layers) '}"
            f"{kv} pages: P={splits} splits (no host sync); {occ['registers']} registers a thread, "
            f"{occ['smem_bytes']} B shared memory, {occ['blocks_per_sm']} blocks an SM; "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL}); worst element {share:.3f} of the limit "
            f"{SUFFIX_RTOL:.4g} |plain| + {SUFFIX_ATOL:.4g} rms(plain) against f32 (rms {rms:.4f}); planted faults "
            + ", ".join(f"{n} {x:.2f}" for n, x in fault_x.items())
            + f"; kernel={t['ms']:.4f} ms plain={plain_ms:.4f} ms sdpa={t['library_ms']:.4f} ms (device time by "
            f"graph replay; host loop: kernel {t['host_ms']:.4f}, sdpa {t['library_host_ms']:.4f}) "
            f"bound={bound_ms:.4f} ms ({bound_by}) sum(len)={int(lengths.sum())}"
        )
        del q, k, v, sc, ks, vs, out, ref
        torch.cuda.empty_cache()
    return per


def decode_times() -> None:
    """``--decode-times DIR``: kernel #1 of the ``areal_tpu_torch`` under DIR
    (a tree unpacked with ``git archive``, say a parent commit's) timed by
    ``_decode_timings`` at the kernel phase's six shapes, one JSON line a
    shape, so two trees' kernels compare by graph replay in one call."""
    for tag, heads in HEADS.items():
        for kv in ("bf16", "int8", "fp8"):
            q, k, v, lengths, pt, sc = _kernel_inputs(kv, heads=heads)
            with torch.no_grad():
                t = _decode_timings(q, k, v, lengths, pt, sc)
            print(json.dumps({"decode_times": f"{tag}/{kv}", **t}), flush=True)
            del q, k, v, sc
            torch.cuda.empty_cache()


def _train_prompt_lengths(seed: int = 0) -> list[int]:
    """Prompt lengths of the train phases' 8 prompts (64-512 tokens from
    ``seed``): 445, 349, 293, 185, 202, 82, 97, 71 for seed 0."""
    return [int(n) for n in np.random.default_rng(seed).integers(64, 513, 8)]


def _train_sequences(seed: int = 0) -> list[int]:
    """Lengths of the train phase's 32 sequences: prompts of 64-512 tokens
    drawn from ``seed`` (8 prompts, 4 samples each) plus 128 new tokens."""
    return [n + 128 for n in _train_prompt_lengths(seed) for _ in range(4)]


# kernel_flash's shapes: (heads, KV heads, grid). "train": the packed grid
# the train phase builds (12 rows of 1,024, 32 segments of 199-573 tokens),
# with Qwen2.5-1.5B's heads and with Qwen3-30B-A3B's (train_moe's); "long":
# a long-rollout grid, LONG_ROWS' segments in rows of 8,192 (192 pad rows)
FLASH_SHAPES = {"train/H12": (12, 2, "train"), "train/H32": (32, 4, "train"), "long/H12": (12, 2, "long")}
LONG_ROWS = ([8192], [5000, 3000])


def _flash_inputs(seed: int = 0, shape: str = "train/H12"):
    """One of FLASH_SHAPES: per-row segment ids [G, L] (padded tails) and
    bf16 q/k/v/dO [G, L, H, 128] with K/V repeated from KH heads, dO zero on
    padding rows; and the segments' lengths."""
    from areal_tpu_torch.utils.grid import pack_grid

    H, KH, grid = FLASH_SHAPES[shape]
    if grid == "train":
        lens = _train_sequences(seed)
        mask = np.zeros((len(lens), max(lens)), bool)
        for i, n in enumerate(lens):
            mask[i, :n] = True
        packed = pack_grid({"attention_mask": mask}, 1024)
        seg_np, seq_lens = packed.data["segment_ids"], packed.seq_lens
    else:
        seg_np = np.zeros((len(LONG_ROWS), max(map(sum, LONG_ROWS))), np.int32)
        for r, row in enumerate(LONG_ROWS):
            seg_np[r, : sum(row)] = np.repeat(np.arange(1, len(row) + 1), row)
        seq_lens = [n for row in LONG_ROWS for n in row]
    seg = torch.from_numpy(seg_np).cuda()
    G, L = seg.shape
    hd = 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((G, L, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (
        torch.randn((G, L, KH, hd), generator=g, device="cuda")
        .to(torch.bfloat16)
        .repeat_interleave(H // KH, dim=2)
        for _ in range(2)
    )
    dout = torch.randn((G, L, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    dout = dout * (seg != 0)[:, :, None, None]
    return q, k, v, dout, seg, seq_lens


def _flash_bounds(G: int, L: int, H: int, hd: int, seq_lens) -> dict:
    """Least time of each kernel's work on these inputs. Operations: the
    causal pairs of every segment, sum n(n+1)/2, times 2 flops per
    multiply-add per head-dim element per product: forward 2 products (q.k,
    p.v); K3 4 (recomputed q.k and do.v, then dV, dK); K4 3 (q.k, do.v,
    dQ). (A fused backward would share the recompute: 5 products, 2.5x the
    forward.) Bytes: each input read once, each output written once."""
    pairs = sum(n * (n + 1) // 2 for n in seq_lens)
    unit = 2 * hd * H * pairs  # flops of one product over the causal pairs
    grid = G * L * H * hd * 2  # one bf16 [G, L, H, hd] tensor
    rows = G * L * H * 4  # one f32 [G, L, H] row statistic
    seg = G * L * 4
    work = {
        "flash_attention_fwd": (2 * unit, 4 * grid + rows + seg),  # q, k, v -> o, lse
        "flash_attention_bwd_dkv": (4 * unit, 6 * grid + 2 * rows + seg),  # q,k,v,do,lse,di -> dk,dv
        "flash_attention_bwd_dq": (3 * unit, 5 * grid + 2 * rows + seg),  # q,k,v,do,lse,di -> dq
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def _flash_excess(got, ref, valid) -> tuple[float, float]:
    """Worst element over valid rows of |got - ref| as a share of the limit
    FLASH_RTOL |ref| + FLASH_ATOL rms(ref) (the check passes at <= 1), and
    rms(ref)."""
    g, r = got.float()[valid], ref.float()[valid]
    rms = r.pow(2).mean().sqrt()
    return ((g - r).abs() / (FLASH_RTOL * r.abs() + FLASH_ATOL * rms)).max().item(), rms.item()


def _flash_check(grads, refs, valid, shape: str) -> dict[str, tuple[float, float, float]]:
    """Hold K3/K4's dq, dk, dv to the limit; returns each one's (share of
    the limit, rms of the reference, max |diff|)."""
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        x, rms = _flash_excess(got, ref, valid)
        e = (got.float() - ref.float())[valid].abs().max().item()
        if not x <= 1.0:
            raise AssertionError(f"[kernel_flash] {shape} {name}: off its plain version by {x:.3f} x the limit "
                                 f"(rms {rms:.4f}, max|diff| {e:.3e})")
        errs[name] = (x, rms, e)
    return errs


def _bwd_bf16_products(q, k, v, seg, dout, lse, di):
    """A planted fault for the K3/K4 check: the plain backward with S and dP
    rounded to bf16, as a kernel that kept them in bf16 would have them."""
    from areal_tpu_torch.ops import attention as fa

    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    mask = fa.attention_mask(seg)
    s = (torch.einsum("gqhd,gkhd->ghqk", q, k) * scale).bfloat16().float()
    p = torch.where(mask, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    dp = torch.einsum("gqhd,gkhd->ghqk", dout, v).bfloat16().float()
    ds = p * (dp - di.transpose(1, 2)[..., None])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return (
        torch.einsum("ghqk,gkhd->gqhd", ds, k) * scale,
        torch.einsum("ghqk,gqhd->gkhd", ds, q) * scale,
        torch.einsum("ghqk,gqhd->gkhd", p, dout),
    )


FWD_FAULTS = ("S rounded to bf16", "a segment boundary ignored", "the diagonal excluded")


def _fwd_plain_fault(q, k, v, seg, fault: str):
    """A planted fault for K2's check: the plain forward (f32) with S rounded
    to bf16 before the softmax, with the first boundary between two nonzero
    segments of each row ignored (the later segment relabelled as the
    earlier), or with each row's own key left out of its mask."""
    from areal_tpu_torch.ops import attention as fa

    if fault == "a segment boundary ignored":
        seg = seg.clone()
        for row in seg:
            cut = ((row[1:] != row[:-1]) & (row[1:] != 0) & (row[:-1] != 0)).nonzero()
            if len(cut):
                j = int(cut[0]) + 1
                row[row == int(row[j])] = int(row[j - 1])
    mask = fa.attention_mask(seg)
    if fault == "the diagonal excluded":
        mask = mask & ~torch.eye(seg.shape[-1], dtype=torch.bool, device=seg.device)
    s = torch.einsum("gqhd,gkhd->ghqk", q, k) * q.shape[-1] ** -0.5
    if fault == "S rounded to bf16":
        s = s.bfloat16().float()
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("ghqk,gkhd->gqhd", p, v)


def _by_row(fn, *grids):
    """``fn`` on one grid row at a time (the plain forward's f32 logits of an
    8,192-token row are 3.2 GB), the results stacked back into [G, ...]."""
    outs = [fn(*(x[g : g + 1] for x in grids)) for g in range(grids[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _k2_timings(q, k, v, seg) -> dict:
    """K2 on one shape: device ms by CUDA-graph replay with and without the
    logsumexp (``ms``, ``nolse_ms``) and the eager host loop beside them
    (``host_ms``: what an eager caller waits, launch included). Uses only
    ``flash_attention_fwd``, so it times any tree's K2 (``--flash-times``)."""
    from areal_tpu_torch.ops import attention as fa

    with torch.no_grad():
        return dict(
            ms=time_cuda_graph(lambda: fa.flash_attention_fwd(q, k, v, seg, with_lse=True)),
            nolse_ms=time_cuda_graph(lambda: fa.flash_attention_fwd(q, k, v, seg, with_lse=False)),
            host_ms=time_cuda(lambda: fa.flash_attention_fwd(q, k, v, seg, with_lse=True), iters=20),
        )


def _bwd_timings(q, k, v, seg, dout, lse, di) -> dict:
    """K3 and K4 on one shape: device ms by CUDA-graph replay (``dkv_ms``,
    ``dq_ms``) and the eager host loop beside them (``dkv_host_ms``,
    ``dq_host_ms``). Uses only the two C entry points' wrappers, so it times
    any tree's K3 and K4 (``--flash-times``)."""
    from areal_tpu_torch.ops import attention as fa

    def dkv():
        return fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)

    def dq():
        return fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di)

    with torch.no_grad():
        return dict(dkv_ms=time_cuda_graph(dkv), dq_ms=time_cuda_graph(dq),
                    dkv_host_ms=time_cuda(dkv, iters=20), dq_host_ms=time_cuda(dq, iters=20))


def flash_times() -> None:
    """``--flash-times DIR``: K2, K3 and K4 of the ``areal_tpu_torch`` under
    DIR (a tree unpacked with ``git archive``, say a parent commit's) timed
    by ``_k2_timings`` and ``_bwd_timings`` at kernel_flash's three shapes
    (K3 and K4 on that tree's K2's lse), one JSON line a shape, so two
    trees' kernels compare by graph replay in one call; ``bits`` digests
    the bits of K2's O and lse and of K3 / K4's dq, dk, dv, so two trees'
    outputs compare too."""
    from areal_tpu_torch.ops import attention as fa

    for shape in FLASH_SHAPES:
        q, k, v, dout, seg, _ = _flash_inputs(shape=shape)
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
            di = (dout.float() * out.float()).sum(-1)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
            dq = fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di)
        digest = hashlib.sha256()
        for x in (out, lse, dq, dk, dv):
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        t = {"bits": digest.hexdigest()[:16], **_k2_timings(q, k, v, seg), **_bwd_timings(q, k, v, seg, dout, lse, di)}
        print(json.dumps({"flash_times": shape, **t}), flush=True)
        del q, k, v, dout, seg, out, lse, di, dq, dk, dv
        torch.cuda.empty_cache()


def _kernel_flash_fwd(shape: str) -> dict:
    """K2 at one of FLASH_SHAPES: its first launch under sync-debug "error";
    O element by element against the plain forward (f32, one grid row at a
    time), lse to 1e-3, exact zeros on padding rows, O's bits the same
    without lse and on a second call; three planted faults in the plain
    forward and lse stored in bf16, each of which the checks must catch;
    occupancy and fwd_tile_pairs' counts; K2 and SDPA times (graph replay,
    host loop beside) and the bound."""
    from collections import Counter

    from areal_tpu_torch.ops import attention as fa

    q, k, v, _, seg, seq_lens = _flash_inputs(shape=shape)
    G, L, H, hd = q.shape
    valid = seg != 0
    occ = fa.occupancy(hd, L)
    pairs = Counter(kind for *_, kind in fa.fwd_tile_pairs(seg))
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again, _ = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
        nolse, _ = fa.flash_attention_fwd(q, k, v, seg, with_lse=False)
        f32 = [x.float() for x in (q, k, v)]
        ref_out, ref_lse = _by_row(fa.flash_attention_fwd_plain, *f32, seg)
        torch.cuda.synchronize()
        same_bits = torch.equal(out, nolse) and torch.equal(out, again)
        err_o = (out.float() - ref_out.float())[valid].abs().max().item()
        err_lse = (lse - ref_lse)[valid].abs().max().item()
        pad_zero = torch.count_nonzero(out[~valid]).item() == 0 and torch.count_nonzero(lse[~valid]).item() == 0
        x_o, rms_o = _flash_excess(out, ref_out, valid)
        if not math.isfinite(err_lse) or err_lse > 1e-3:  # f32 row statistics
            raise AssertionError(f"[kernel_flash] {shape} K2: max|lse - plain| = {err_lse}")
        if not x_o <= 1.0 or not pad_zero or not same_bits:
            raise AssertionError(f"[kernel_flash] {shape} K2: O off its plain version by {x_o:.3f} x the limit, "
                                 f"pad rows zero: {pad_zero}, O's bits the same without lse and again: {same_bits}")
        fault_x = {f: _flash_excess(_by_row(lambda *a, f=f: _fwd_plain_fault(*a, f), *f32, seg), ref_out, valid)[0]
                   for f in FWD_FAULTS}
        fault_x["lse stored in bf16 (max|lse - plain|)"] = (ref_lse.bfloat16().float() - ref_lse)[valid].abs().max().item()
        caught = {f: x > (1e-3 if f.startswith("lse") else 1.0) for f, x in fault_x.items()}
        if not all(caught.values()):
            raise AssertionError(f"[kernel_flash] {shape}: K2's check passes a planted fault: {fault_x}")
        del f32, ref_out, ref_lse, again, nolse
    t = _k2_timings(q, k, v, seg)
    # yardstick the port never calls: SDPA's forward with the same boolean
    # mask, on [G, H, L, hd] copies made outside the timed region
    mask = fa.attention_mask(seg)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        t.update(library_ms=time_cuda_graph(sdpa, iters=5), library_host_ms=time_cuda(sdpa, iters=5, warmup=2))
    del qt, kt, vt, mask
    bound_ms, bound_by = _flash_bounds(G, L, H, hd, seq_lens)["flash_attention_fwd"]
    log(f"[kernel_flash] {shape}: K2 G={G} L={L} H={H} hd={hd}, {len(seq_lens)} segments ({sum(seq_lens)} tokens, "
        f"{int((~valid).sum())} pad rows); tile pairs interior {pairs['interior']}, partial {pairs['partial']}, "
        f"skipped {pairs['skipped']} (a head); {occ['registers']} registers a thread, {occ['smem_bytes']} B shared "
        f"memory, {occ['blocks_per_sm']} blocks an SM; first launch under sync-debug \"error\"; worst element "
        f"{x_o:.3f} of the limit {FLASH_RTOL:.4g} |plain| + {FLASH_ATOL:.4g} rms(plain) (rms {rms_o:.4f}, "
        f"max|diff| {err_o:.3e}); max|lse - plain| {err_lse:.2e} (tol 1e-3); pad rows zero, O's bits the same "
        f"without lse and on a second call; planted faults (each must exceed 1, lse's 1e-3): "
        + "; ".join(f"{n} {x:.3g}" for n, x in fault_x.items()))
    log(f"[kernel_flash] {shape}: K2 {t['ms']:.4f} ms, without lse {t['nolse_ms']:.4f} ms, SDPA forward "
        f"{t['library_ms']:.4f} ms (device time by graph replay; host loop: K2 {t['host_ms']:.4f}, SDPA "
        f"{t['library_host_ms']:.4f}); bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err_o, bound_ms=bound_ms, bound_by=bound_by, occupancy=occ, tile_pairs=dict(pairs), **t)


def _plain_bwd(fn, q, k, v, seg, dout, lse, di, heads: int = 4):
    """``fn`` (the plain backward, or a planted fault of it: q, k, v, seg,
    dO, lse, di -> dq, dk, dv) on one grid row and ``heads`` heads at a time
    (on an 8,192-token row its f32 [1, H, L, L] intermediates are 3.2 GB
    each at H=12), put back together as f32 [G, L, H, hd]."""
    G, L, H, hd = q.shape
    outs = [torch.empty((G, L, H, hd), dtype=torch.float32, device=q.device) for _ in range(3)]
    for g in range(G):
        for h0 in range(0, H, heads):
            sl = (slice(g, g + 1), slice(None), slice(h0, h0 + heads))
            parts = fn(*(x[sl] for x in (q, k, v)), seg[g : g + 1], *(x[sl] for x in (dout, lse, di)))
            for o, part in zip(outs, parts):
                o[sl] = part.float()
    return outs


def _graph_outputs(fn) -> list[torch.Tensor]:
    """What one call of ``fn`` (returning a tuple of tensors) writes when it
    is captured in a CUDA graph and replayed once, its outputs zeroed
    before the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    outs = [o.clone() for o in outs]
    del graph
    return outs


def _sdpa_bwd_times(q, k, v, dout, seg, mask=None) -> tuple[float, float]:
    """A yardstick the port never calls: SDPA's backward (autograd of
    ``scaled_dot_product_attention`` with the same boolean mask, ``seg``'s
    or ``mask``, on [G, H, L, hd] copies made outside the timed region) by
    graph replay and by host loop. The forward runs eagerly on a side
    stream, so its backward, which autograd runs on the forward's stream, is
    captured there."""
    from areal_tpu_torch.ops import attention as fa

    mask = fa.attention_mask(seg) if mask is None else mask
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
        leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
        o = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)

    def bwd():
        return torch.autograd.grad(o, leaves, dot, retain_graph=True)

    with torch.cuda.stream(side):
        host_ms = time_cuda(bwd, iters=5, warmup=2)
    torch.cuda.current_stream().wait_stream(side)
    return time_cuda_graph(bwd, iters=5, stream=side), host_ms


def _kernel_flash_bwd(shape: str) -> dict:
    """K3 and K4 at one of FLASH_SHAPES, on K2's lse and di: their first
    launches under sync-debug "error"; dq, dk and dv element by element
    against the plain backward (f32, by row and head chunk); exact zeros on
    padding rows; the same bits on a second call and from a CUDA-graph
    replay; three planted faults in the plain backward, each of which the
    check must catch; occupancy; K3, K4 and SDPA's backward by graph replay
    (host loop beside) and the bounds."""
    from areal_tpu_torch.ops import attention as fa

    q, k, v, dout, seg, seq_lens = _flash_inputs(shape=shape)
    G, L, H, hd = q.shape
    valid = seg != 0
    occ = fa.bwd_occupancy(hd, L)

    def kernels():
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, dout, lse, di)
        return fa.flash_attention_bwd_dq(q, k, v, seg, dout, lse, di), dk, dv

    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
        di = (dout.float() * out.float()).sum(-1)
        del out
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            grads = kernels()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = kernels()
        replayed = _graph_outputs(kernels)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(grads, again, replayed))
        pad_zero = all(torch.count_nonzero(x[~valid]).item() == 0 for x in grads)
        del again, replayed
        # K3 and K4 from the kernels' lse and di, so they are held alone
        def plain(*a):
            return fa.flash_attention_bwd_plain(*a, out_dtype=torch.float32)

        args = (q, k, v, seg, dout, lse, di)
        refs = _plain_bwd(plain, *args)
        errs = _flash_check(grads, refs, valid, shape)
        if not pad_zero or not same_bits:
            raise AssertionError(f"[kernel_flash] {shape} K3/K4: pad rows of dq/dk/dv zero: {pad_zero}, the same "
                                 f"bits on a second call and from a graph replay: {same_bits}")
        faults = {
            "S, dP rounded to bf16": _bwd_bf16_products,
            "lse stored in bf16": lambda *a: plain(*a[:5], a[5].bfloat16().float(), a[6]),
            "di left out": lambda *a: plain(*a[:6], torch.zeros_like(a[6])),
        }
        fault_x = {fname: max(_flash_excess(g, r, valid)[0] for g, r in zip(_plain_bwd(fault, *args), refs))
                   for fname, fault in faults.items()}
        if not all(x > 1.0 for x in fault_x.values()):
            raise AssertionError(f"[kernel_flash] {shape}: the K3/K4 check passes a planted fault: {fault_x}")
        del refs, grads
    t = _bwd_timings(q, k, v, seg, dout, lse, di)
    t["library_ms"], t["library_host_ms"] = _sdpa_bwd_times(q, k, v, dout, seg)
    bounds = _flash_bounds(G, L, H, hd, seq_lens)
    log(f"[kernel_flash] {shape}: K3/K4 on K2's lse, first launches under sync-debug \"error\"; worst element as a "
        f"share of the limit: " + "; ".join(f"{n} {x:.3f} (rms {r:.4f}, max|diff| {e:.3e})" for n, (x, r, e) in
                                             errs.items())
        + "; pad rows of dq/dk/dv zero; the same bits on a second call and from a graph replay; planted faults "
        "(each must exceed 1): " + "; ".join(f"{n} {x:.3g}" for n, x in fault_x.items())
        + "; " + "; ".join(f"{n} {o['registers']} registers a thread, {o['smem_bytes']} B shared memory, "
                           f"{o['blocks_per_sm']} blocks an SM" for n, o in occ.items()))
    b3, b4 = bounds["flash_attention_bwd_dkv"], bounds["flash_attention_bwd_dq"]
    log(f"[kernel_flash] {shape}: K3 {t['dkv_ms']:.4f} ms, K4 {t['dq_ms']:.4f} ms, together "
        f"{t['dkv_ms'] + t['dq_ms']:.4f}; SDPA backward {t['library_ms']:.4f} ms (device time by graph replay; host "
        f"loop: K3 {t['dkv_host_ms']:.4f}, K4 {t['dq_host_ms']:.4f}, SDPA {t['library_host_ms']:.4f}); bounds K3 "
        f"{b3[0]:.4f} ms ({b3[1]}), K4 {b4[0]:.4f} ms ({b4[1]})")
    res = {}
    for name, key, err in (("flash_attention_bwd_dkv", "dkv", max(errs["dk"][2], errs["dv"][2])),
                           ("flash_attention_bwd_dq", "dq", errs["dq"][2])):
        res[name] = dict(ms=t[f"{key}_ms"], host_ms=t[f"{key}_host_ms"], library_ms=t["library_ms"],
                         library_host_ms=t["library_host_ms"], bound_ms=bounds[name][0], bound_by=bounds[name][1],
                         max_abs_err=err, occupancy=occ[key])
    return res


def phase_kernel_flash() -> dict:
    """K2 (``_kernel_flash_fwd``), then K3 and K4 (``_kernel_flash_bwd``),
    at each of FLASH_SHAPES; the plain versions' times at train/H12."""
    from areal_tpu_torch.ops import attention as fa

    shapes: dict[str, dict] = {}
    for shape in FLASH_SHAPES:
        shapes[shape] = {"flash_attention_fwd": _kernel_flash_fwd(shape)}
        torch.cuda.empty_cache()
        shapes[shape].update(_kernel_flash_bwd(shape))
        torch.cuda.empty_cache()
    q, k, v, dout, seg, _ = _flash_inputs()
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, seg, with_lse=True)
        di = (dout.float() * out.float()).sum(-1)
        p_fwd = time_cuda(lambda: fa.flash_attention_fwd_plain(q, k, v, seg), iters=3, warmup=1)
        p_bwd = time_cuda(lambda: fa.flash_attention_bwd_plain(q, k, v, seg, dout, lse, di), iters=3, warmup=1)
    del q, k, v, dout, seg, out, lse, di
    torch.cuda.empty_cache()
    fields = ("ms", "host_ms", "library_ms", "library_host_ms", "bound_ms", "bound_by", "max_abs_err")
    per = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        f = shapes["train/H12"][name]
        per[name] = dict(
            max_abs_err=max(d[name]["max_abs_err"] for d in shapes.values()), ms=f["ms"],
            plain_ms=p_fwd if name == "flash_attention_fwd" else p_bwd, library_ms=f["library_ms"],
            bound_ms=f["bound_ms"], bound_by=f["bound_by"],
            shapes={n: {x: d[name][x] for x in (*fields, *(("nolse_ms",) if name == "flash_attention_fwd" else ()))}
                    for n, d in shapes.items()})
        log(f"[kernel_flash] train/H12 {name}: kernel={f['ms']:.4f} ms plain={per[name]['plain_ms']:.4f} ms "
            f"sdpa={f['library_ms']:.4f} ms (graph replay) bound={f['bound_ms']:.4f} ms ({f['bound_by']})")
    log(f"[kernel_flash] the plain backward computes dq, dk and dv in one call ({p_bwd:.4f} ms)")
    return per


def _suffix_masks(kind: str, S: int, B: int, rng) -> np.ndarray:
    """Masks as the engine builds them. "prefill": the causal chain of
    ``qwen.forward_prefill_paged`` over suffixes of 64..B tokens, the rows
    past a suffix with no valid bit. "chain" / "tree": the drafters' verify
    masks (``speculative.draft_batch``) over periodic contexts, so most slots
    get drafts and some do not."""
    from areal_tpu_torch.api.config import SpeculativeConfig
    from areal_tpu_torch.inference import speculative as spec_mod

    if kind == "prefill":
        lens = rng.integers(64, B + 1, S)
        lens[0], lens[1] = B, 64
        i = np.arange(B)
        valid = i[None, :] < lens[:, None]
        return np.tril(np.ones((B, B), bool))[None] & valid[:, :, None] & valid[:, None, :]
    spec = SpeculativeConfig(enabled=True, drafter="tree" if kind == "tree" else "ngram")
    if spec.max_nodes() != B:
        raise ValueError(f"{kind} verify has {spec.max_nodes()} rows, not {B}")
    ctx = {}
    for s in range(S):
        period = int(rng.integers(2, 9))
        base = rng.integers(0, 5, period).tolist()
        ctx[s] = (base * 40)[: int(rng.integers(10, 60))] + rng.integers(0, 5, int(rng.integers(0, 3))).tolist()
    return spec_mod.draft_batch(spec_mod.build_drafter(spec), ctx, S, B - 1).mask


def _suffix_inputs(shape: str, kv: str, cache: dict, seed: int = 0, H: int = 12, KH: int = 2):
    """One kernel-#3 launch's operands at H query and KH KV heads: the
    suffix q/K/V, the prefix lengths, page tables into ``cache`` and the
    mask."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd, psz = 128, 128
    N = cache["k"].shape[2]
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    if shape == "warm_prefill":
        # 8 admissions of one radix hit: a shared 1,024-token prefix (8 pages)
        S, B, wp = 8, 256, 8
        plens = np.full(S, 1024, np.int32)
        pt = np.tile(perm[:wp], (S, 1))
        mask = _suffix_masks("prefill", S, B, rng)
    else:
        S, B, wp = 32, (5 if shape == "verify_chain" else 9), 16
        plens = np.concatenate([[1, psz - 1, psz, psz + 1, wp * psz, wp * psz - 1],
                                rng.integers(1, wp * psz + 1, S - 6)]).astype(np.int32)
        pt = np.zeros((S, wp), np.int32)
        for s in range(S):
            need = -(-int(plens[s]) // psz)
            pt[s, :need] = perm[s * wp : s * wp + need]
        pt[7, :3] = pt[6, :3]  # shared pages, as duplicates and radix hits give
        mask = _suffix_masks("chain" if shape == "verify_chain" else "tree", S, B, rng)
    q = torch.randn((S, B, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    ks, vs = (torch.randn((S, B, KH, hd), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    return dict(q=q, ks=ks, vs=vs, plens=torch.from_numpy(plens).cuda(), pt=torch.from_numpy(pt).cuda(),
                mask=torch.from_numpy(mask).cuda())


def _suffix_bound(x: dict, kv: str, psz: int = 128) -> tuple[float, str, float]:
    """Least time of one launch on these inputs. Operations: 4 hd flops per
    query head per (row, key) pair the mask lets through (q.k and p.v), the
    prefix's pairs only for rows whose diagonal bit is set. Bytes: q, the
    suffix K/V, the mask, the lengths, the page-table entries used and every
    distinct prefix token's K/V (and scales) read once; the output written
    once. Returns (ms, "bytes" | "operations", flops)."""
    q, mask = x["q"], x["mask"].cpu().numpy()
    S, B, H, hd = q.shape
    KH = x["ks"].shape[2]
    plens, pt = x["plens"].cpu().numpy(), x["pt"].cpu().numpy()
    diag = mask[:, np.arange(B), np.arange(B)]
    pairs = int((plens.astype(np.int64) * diag.sum(axis=1)).sum() + mask.sum())
    flops = 4 * hd * H * pairs
    tokens = set()
    for s in range(S):
        if diag[s].any():
            tokens.update((int(pt[s, t // psz]), t % psz) for t in range(int(plens[s])))
    elem = 2 if kv == "bf16" else 1
    prefix_bytes = len(tokens) * KH * 2 * (hd * elem + (4 if kv != "bf16" else 0))
    nbytes = (2 * q.numel() * 2 + 2 * x["ks"].numel() * 2 + mask.size + S * 4
              + int(np.ceil(plens / psz).sum()) * 4 + prefix_bytes)
    t_ops, t_bytes = flops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes", flops) if t_bytes >= t_ops else (t_ops, "operations", flops)


def _suffix_excess(got, ref, mask) -> tuple[float, float, float]:
    """The kernel-#3 check. Rows with a valid mask bit: worst |got - ref| as
    a share of SUFFIX_RTOL |ref| + SUFFIX_ATOL rms(ref) (passes at <= 1).
    Rows with no valid bit must be exact zeros: a nonzero there counts as
    its size over SUFFIX_ATOL rms(ref). Returns (share, rms(ref), max|diff|
    on valid rows)."""
    live = mask.any(-1)  # [S, B]
    g, r = got.float()[live], ref.float()[live]
    rms = r.pow(2).mean().sqrt()
    x = ((g - r).abs() / (SUFFIX_RTOL * r.abs() + SUFFIX_ATOL * rms)).max().item()
    dead = got.float()[~live]
    if dead.numel():
        x = max(x, (dead.abs().max() / (SUFFIX_ATOL * rms)).item())
    return x, rms.item(), (g - r).abs().max().item()


def _suffix_split_dropped(psa_mod, args, layer: int, x: dict, sc: dict, n_splits: int) -> torch.Tensor:
    """A planted fault from the plain split twin: the kernel's P splits
    merged with the last one that holds a finite log-sum-exp left out."""
    parts = [psa_mod._split_partials_plain(*args, layer, x["plens"], x["pt"], x["mask"], sc["k_scales"],
                                           sc["v_scales"], n_splits=n_splits, split=p) for p in range(n_splits)]
    o_part = torch.stack([o for o, _ in parts])
    lse_part = torch.stack([lse for _, lse in parts])
    last = max(p for p in range(n_splits) if torch.isfinite(lse_part[p]).any())
    lse_part[last] = -torch.inf
    G = x["q"].shape[2] // x["ks"].shape[2]
    return psa_mod.merge_splits_plain(o_part, lse_part, x["mask"].shape[1], G)


def phase_kernel_suffix(n_layers: int | None = None) -> dict:
    """Kernel #3 against its plain version at each head config of HEADS
    (hd=128, psz=128, the config's stacked cache, layer 5): Qwen2.5-1.5B's
    H=12, KH=2 (keys "<shape>/<kv>") and Qwen3-30B-A3B's H=32, KH=4, G=8
    (keys "qwen3-30b-a3b/<shape>/<kv>"). Shapes: a warm suffix prefill (8
    rows of 64..256 suffix tokens in a 256 bucket over a shared 1,024-token
    prefix, padded rows) and speculative verify (S=32, prefixes of 1..2048
    tokens, the ngram drafter's B=5 chains and the tree drafter's B=9
    trees), each for bf16, int8 and fp8 pages. Prints the split count P of
    each shape (its first launch runs under sync-debug "error") and the
    kernel's registers and blocks an SM. Three planted faults must fail the
    check (the gate only where a row has no valid bit). ``n_layers``
    overrides the cache depth (a CPU rehearsal)."""
    per: dict[str, dict] = {}
    for tag, (H, KH, L) in HEADS.items():
        res = _suffix_heads(H, KH, n_layers or L)
        per.update(res if tag == "qwen2.5-1.5b" else {f"{tag}/{k}": v for k, v in res.items()})
    return per


def _suffix_heads(H: int, KH: int, L: int) -> dict:
    from areal_tpu_torch.inference import paged_kv
    from areal_tpu_torch.ops import paged_suffix_attention as psa_mod
    from areal_tpu_torch.ops.paged_suffix_attention import (
        paged_suffix_attention,
        paged_suffix_attention_plain,
    )

    hd, psz, N = 128, 128, 32 * 16 + 1
    li = min(5, L - 1)
    kinds = {"warm_prefill": "chain", "verify_chain": "tree", "verify_tree": "tree"}
    per: dict[str, dict] = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    shape5 = (L, KH, N, psz, hd)
    base_k = torch.randn(shape5, generator=g, device="cuda", dtype=torch.bfloat16)
    base_v = torch.randn(shape5, generator=g, device="cuda", dtype=torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kv in ("bf16", "int8", "fp8"):
        if kv == "bf16":
            cache = {"k": base_k, "v": base_v}
        else:
            qd = paged_kv.quant_dtype(kv)
            k8, k_s = paged_kv.quantize_kv(base_k, qd)
            v8, v_s = paged_kv.quantize_kv(base_v, qd)
            cache = {"k": k8, "v": v8, "k_scale": k_s, "v_scale": v_s}
        sc = dict(k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))
        occ = {cfg: psa_mod.occupancy(hd, cache["k"].dtype, cfg == "prefill") for cfg in ("prefill", "verify")}
        log(f"[kernel_suffix] {'' if H == 12 else f'H={H} KH={KH} '}{kv} pages: split kernel "
            + "; ".join(f"{cfg} configuration {o['registers']} registers a thread, {o['smem_bytes']} B shared "
                        f"memory, {o['blocks_per_sm']} blocks an SM" for cfg, o in occ.items()))
        for shape, kind in kinds.items():
            x = _suffix_inputs(shape, kv, cache, H=H, KH=KH)
            args = (x["q"], x["ks"], x["vs"], cache["k"], cache["v"])

            def plain(layer, plens=None, mask=None):
                return paged_suffix_attention_plain(
                    *args, layer, x["plens"] if plens is None else plens, x["pt"],
                    x["mask"] if mask is None else mask, sc["k_scales"], sc["v_scales"])

            with torch.no_grad():
                # the first launch of the shape under sync-debug "error": the
                # split count and scratch come from shapes, no host sync
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = paged_suffix_attention(*args, li, x["plens"], x["pt"], x["mask"], kind=kind, **sc)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                splits = paged_suffix_attention.splits
                ref = plain(li)
                torch.cuda.synchronize()
                share, rms, err = _suffix_excess(got, ref, x["mask"])
                if not share <= 1.0:
                    raise AssertionError(f"[kernel_suffix] H={H} {shape} {kv}: off its plain version by {share:.3f} x "
                                         f"the limit (rms {rms:.4f}, max|diff| {err:.3e})")
                eye = torch.eye(x["mask"].shape[1], dtype=torch.bool, device="cuda")
                faults = {
                    "diagonal gate dropped": plain(li, mask=x["mask"] | eye),
                    "prefix one page short": plain(li, plens=(x["plens"] - psz).clamp(min=0)),
                    "last non-empty split dropped": _suffix_split_dropped(psa_mod, args, li, x, sc, splits),
                }
                fault_x = {n: _suffix_excess(f, ref, x["mask"])[0] for n, f in faults.items()}
                # the gate shows only where a row has no valid bit (padded prefill rows)
                if shape != "warm_prefill":
                    del fault_x["diagonal gate dropped"]
                for n, fx in fault_x.items():
                    if not fx > 1.0:
                        raise AssertionError(f"[kernel_suffix] H={H} {shape} {kv}: the check passes a planted fault ({n})")
                del faults, ref, got
                it = iter(range(10**9))
                kernel = lambda: paged_suffix_attention(  # noqa: E731
                    *args, next(it) % L, x["plens"], x["pt"], x["mask"], kind=kind, **sc)
                # device time (graph replay); the host loop beside it is what
                # an eager caller waits for a call, launch overhead included
                ms = time_cuda_graph(kernel)
                host_ms = time_cuda(kernel, iters=56)
                plain_ms = time_cuda(lambda: plain(next(it) % L), iters=5, warmup=1)
                # yardstick the port never calls: one SDPA over the prefix
                # already gathered (and dequantized) plus the suffix, with the
                # same boolean mask; the gather is outside the timed calls
                S, B = x["mask"].shape[:2]
                W = x["pt"].shape[1] * psz
                ptl = x["pt"].long()

                def gathered(name, j):
                    pages = cache[name][j][:, ptl].reshape(KH, S, W, hd).permute(1, 0, 2, 3)
                    if kv != "bf16":
                        s_ = cache[f"{name}_scale"][j][:, ptl].reshape(KH, S, W, 1).permute(1, 0, 2, 3)
                        pages = (pages.float() * (s_ / 127.5)).to(torch.bfloat16)
                    sfx = (x["ks"] if name == "k" else x["vs"]).permute(0, 2, 1, 3)
                    return torch.cat([pages, sfx], dim=2).contiguous()

                kvg = [(gathered("k", j), gathered("v", j)) for j in range(min(4, L))]
                ar = torch.arange(B, device="cuda")
                in_prefix = torch.arange(W, device="cuda")[None, :] < x["plens"][:, None]
                full = torch.cat([x["mask"][:, ar, ar][:, :, None] & in_prefix[:, None, :], x["mask"]], dim=-1)
                qt = x["q"].transpose(1, 2).contiguous()
                library = lambda: sdpa(qt, *kvg[next(it) % len(kvg)], attn_mask=full[:, None],  # noqa: E731
                                       enable_gqa=True)
                lib_ms = time_cuda_graph(library)
                lib_host_ms = time_cuda(library, iters=20)
                del kvg, full, qt
            bound_ms, bound_by, flops = _suffix_bound(x, kv)
            per[f"{shape}/{kv}"] = dict(max_abs_err=err, share=share, rms=rms, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, splits=splits,
                                        host_ms=host_ms, library_host_ms=lib_host_ms)
            dead = int((~x["mask"].any(-1)).sum())
            log(f"[kernel_suffix] {'' if H == 12 else f'H={H} KH={KH} G={H // KH} '}{shape} {kv} pages: S={S} B={B} rows ({dead} with no valid bit), P={splits} splits (no host sync), prefixes "
                f"{int(x['plens'].min())}..{int(x['plens'].max())}; worst element {share:.3f} of the limit "
                f"{SUFFIX_RTOL:.4g} |plain| + {SUFFIX_ATOL:.4g} rms(plain) (rms {rms:.4f}, max|diff| {err:.3e}); "
                f"planted faults " + ", ".join(f"{n} {v:.2f}" for n, v in fault_x.items())
                + f"; kernel={ms:.4f} ms plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms (gather excluded; device "
                f"time by graph replay; host loop: kernel {host_ms:.4f}, sdpa {lib_host_ms:.4f}) "
                f"bound={bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP)")
        del cache, sc
    del base_k, base_v
    torch.cuda.empty_cache()
    return per


def _tree_forests(seed: int = 0) -> dict[str, list[list[int]]]:
    """The sequences of kernel_tree's two forests. "grpo": the first pack of
    the train_tree wave, prompts of 445 and 349 tokens with 4 branches of
    128 tokens each (1,818 nodes). "agentic": three agent episodes of ~630
    nodes, each a 200-token prompt whose trajectories fork from earlier ones
    at random depths and run on for 32-160 tokens (a deep trie branching at
    several depths; the episodes' tiles below the diagonal are zero)."""
    rng = np.random.default_rng(seed)
    V = QWEN25_15B["vocab_size"]
    grpo = []
    for n in _train_prompt_lengths()[:2]:
        prompt = rng.integers(0, V, n).tolist()
        grpo += [prompt + rng.integers(0, V, 128).tolist() for _ in range(4)]
    agentic = []
    for _ in range(3):
        episode = [rng.integers(0, V, 200).tolist()]
        nodes = 200
        while nodes < 600:
            base = episode[int(rng.integers(0, len(episode)))]
            cut = int(rng.integers(1, len(base) + 1))
            tail = rng.integers(0, V, int(rng.integers(32, 161))).tolist()
            episode.append(base[:cut] + tail)
            nodes += len(tail)
        agentic += episode
    return {"grpo": grpo, "agentic": agentic}


def _tree_walk_tries(seed: int = 12) -> dict[str, tuple[list[list[int]], int]]:
    """The card tests' walk tries (``TREE_BWD_CASES``) at Qwen2.5-1.5B's
    vocabulary, with their padded node counts: "chain", one 500-token
    sequence (row 0 attends itself alone; every pair below the diagonal is
    full); "straddle", GRPO groups whose prompts (100, 70 tokens) and
    branches (90, 50) end off the 64-row tile edges; "partial", 20 disjoint
    chains of 40 nodes (no 64-row pair is full); "grpo", prompts of 500,
    400 and 300 tokens with 4, 4 and 3 branches of 250, over 4,096 rows.
    Rows near a root average few keys: where P's bf16 rounding shows."""
    rng = np.random.default_rng(seed)
    V = QWEN25_15B["vocab_size"]

    def tok(n):
        return rng.integers(0, V, n).tolist()

    groups = {"straddle": ((100, 4, 90), (70, 3, 50)), "grpo": ((500, 4, 250), (400, 4, 250), (300, 3, 250))}
    tries = {"chain": ([tok(500)], 512)}
    tries["straddle"] = ([p + tok(b) for plen, n, b in groups["straddle"] for p in [tok(plen)] for _ in range(n)],
                         1024)
    tries["partial"] = ([[i] + tok(39) for i in range(20)], 1024)
    tries["grpo"] = ([p + tok(b) for plen, n, b in groups["grpo"] for p in [tok(plen)] for _ in range(n)], 4096)
    return tries


def _tree_inputs(seqs: list[list[int]], seed: int = 0, hd: int = 128, n_pad: int | None = None):
    """One forest's bits and bf16 q/k/v/dO [N, 12, hd] with K/V repeated
    from 2 heads, dO zero on padded rows; N bucketed as the engine does
    unless ``n_pad`` is given."""
    from areal_tpu_torch.models.tree import build_tree
    from areal_tpu_torch.ops import tree_attention as ta
    from areal_tpu_torch.utils.data import round_up_to_bucket

    pack = build_tree(seqs)
    n_pad = n_pad or round_up_to_bucket(pack.n_nodes, 512)
    words, block_any = ta.pack_ancestor_bits(pack.parent, n_pad)
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, KH = 12, 2
    q, dout = (torch.randn((n_pad, H, hd), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((n_pad, KH, hd), generator=g, device="cuda").to(torch.bfloat16)
            .repeat_interleave(H // KH, dim=1) for _ in range(2))
    valid = torch.zeros(n_pad, dtype=torch.bool, device="cuda")
    valid[: pack.n_nodes] = True
    dout = dout * valid[:, None, None]
    return (q, k, v, dout, torch.from_numpy(words.view(np.int32)).cuda(), torch.from_numpy(block_any).cuda(),
            valid, pack)


TREE_LSE_TOL = 1e-3  # #4's lse against the plain version's (f32 row statistics)


def _tree_fwd_errors(q, k, v, words, block_any, valid, out, lse) -> dict:
    """#4's O and lse against the plain forward in f32: O's worst element as
    a share of the limit FLASH_RTOL |plain| + FLASH_ATOL rms(plain), its
    largest difference, lse's largest difference, and whether padding rows
    are exact zeros."""
    from areal_tpu_torch.ops import tree_attention as ta

    ref_out, ref_lse = ta.tree_attention_fwd_plain(q.float(), k.float(), v.float(), words, block_any)
    x_o, _ = _flash_excess(out, ref_out, valid)
    return dict(o_share=x_o, o_err=(out.float() - ref_out)[valid].abs().max().item(),
                lse_err=(lse - ref_lse)[valid].abs().max().item(),
                pad_zero=torch.count_nonzero(out[~valid]).item() == 0 and torch.count_nonzero(lse[~valid]).item() == 0)


def _digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    digest = hashlib.sha256()
    for x in tensors:
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def _tree_bounds(N: int, H: int, hd: int, set_bits: int) -> dict:
    """Least time of each tree kernel's work on these inputs. Operations
    over the set bits only, 2 flops per multiply-add per head-dim element per
    product: #4 2 products (q.k, p.v), #5 3 (q.k, do.v, dQ), #6 4 (q.k,
    do.v, dV, dK). Bytes: each input read once (the words and skip map
    included), each output written once."""
    unit = 2 * hd * H * set_bits
    grid = N * H * hd * 2  # one bf16 [N, H, hd] tensor
    rows = N * H * 4  # one f32 [N, H] row statistic
    bits = N * N // 8 + (N // 128) ** 2 * 4
    work = {
        "tree_attention_fwd": (2 * unit, 4 * grid + rows + bits),  # q, k, v -> o, lse
        "tree_attention_bwd_dq": (3 * unit, 5 * grid + 2 * rows + bits),  # q,k,v,do,lse,delta -> dq
        "tree_attention_bwd_dkv": (4 * unit, 6 * grid + 2 * rows + bits),  # q,k,v,do,lse,delta -> dk,dv
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def _tree_faults(words: torch.Tensor, n: int) -> dict[str, torch.Tensor]:
    """Planted faults in the mask words: a causal mask over the nodes in
    place of the ancestor bits, bit 31 of every word cleared, the diagonal
    bit dropped."""
    from areal_tpu_torch.ops import tree_attention as ta

    N = words.shape[0]
    i = torch.arange(N, device=words.device)
    causal = (i[:, None] >= i[None, :]) & (i[:, None] < n) & (i[None, :] < n)
    packed = causal.view(N, N // 32, 32).to(torch.int64) << torch.arange(32, device=words.device)
    causal_words = packed.sum(-1).to(torch.int64)
    causal_words = torch.where(causal_words >= 2**31, causal_words - 2**32, causal_words).to(torch.int32)
    diag = words.clone()
    rows = i[:n]
    diag[rows, rows // 32] &= ~(torch.ones_like(rows, dtype=torch.int32) << (rows % 32).to(torch.int32))
    faults = {"causal mask": causal_words, "bit 31 cleared": words & 0x7FFFFFFF, "diagonal dropped": diag}
    if not torch.equal(ta.expand_mask(causal_words), causal):
        raise AssertionError("[kernel_tree] the causal fault packs wrongly")
    return faults


TREE_FAULT_MIN = 10.0  # a planted fault must miss the limit by this factor


def _tree_kernel_times(q, k, v, dout, words, block_any, lse, delta) -> dict[str, tuple[float, float]]:
    """#4, #5 and #6 on one forest: (device ms by CUDA-graph replay, eager
    host-loop ms) each. Uses only the three wrappers, so it times any
    tree's kernels (``--tree-times``)."""
    from areal_tpu_torch.ops import tree_attention as ta

    kern = {
        "tree_attention_fwd": lambda: ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True),
        "tree_attention_bwd_dq": lambda: ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta),
        "tree_attention_bwd_dkv": lambda: ta.tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta),
    }
    with torch.no_grad():
        return {name: (time_cuda_graph(fn), time_cuda(fn, iters=20)) for name, fn in kern.items()}


def tree_times(fwd_file: str | None = None) -> None:
    """``--tree-times DIR [--fwd FILE]``: #4, #5 and #6 of the
    ``areal_tpu_torch`` under DIR (a tree unpacked with ``git archive``,
    say a parent commit's) timed by ``_tree_kernel_times`` on kernel_tree's
    two forests, one JSON line a forest, so two trees' kernels compare by
    graph replay in one call. ``fwd_bits`` digests #4's O and lse, ``bits``
    #5 / #6's dq, dk, dv on that O and lse; ``o_share`` and ``lse_err`` are
    #4's errors against the plain forward (``_tree_fwd_errors``), also
    printed for the walk tries at hd 64 and 128. With ``--fwd FILE``, the
    first run writes its #4's O and lse of both forests to FILE, and a run
    that finds FILE feeds #5 / #6 those in place of its own: another tree's
    backward on this tree's forward."""
    from areal_tpu_torch.ops import tree_attention as ta

    saved = torch.load(fwd_file) if fwd_file and os.path.exists(fwd_file) else None
    ours = {}
    for fname, seqs in _tree_forests().items():
        q, k, v, dout, words, block_any, valid, _ = _tree_inputs(seqs)
        with torch.no_grad():
            out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
            t = {"fwd_bits": _digest(out, lse), **_tree_fwd_errors(q, k, v, words, block_any, valid, out, lse)}
            ours[fname] = (out.cpu(), lse.cpu())
            if saved is not None:
                out, lse = (x.cuda() for x in saved[fname])
                t["fwd_from"] = fwd_file
            delta = (dout.float() * out.float()).sum(-1)
            dq = ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta)
            dk, dv = ta.tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta)
        t["bits"] = _digest(dq, dk, dv)
        for name, (ms, host_ms) in _tree_kernel_times(q, k, v, dout, words, block_any, lse, delta).items():
            t[f"{name}_ms"], t[f"{name}_host_ms"] = ms, host_ms
        t["pair_ms"] = t["tree_attention_bwd_dq_ms"] + t["tree_attention_bwd_dkv_ms"]
        print(json.dumps({"tree_times": fname, **t}), flush=True)
        del q, k, v, dout, words, block_any, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    if fwd_file and saved is None:
        torch.save(ours, fwd_file)
    for tname, (seqs, n_pad) in _tree_walk_tries().items():
        for hd in (64, 128):
            q, k, v, _, words, block_any, valid, _ = _tree_inputs(seqs, hd=hd, n_pad=n_pad)
            with torch.no_grad():
                out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
                e = _tree_fwd_errors(q, k, v, words, block_any, valid, out, lse)
            print(json.dumps({"tree_fwd": f"{tname}/hd{hd}", "fwd_bits": _digest(out, lse), **e}), flush=True)
            del q, k, v, words, block_any, out, lse
        torch.cuda.empty_cache()


def _tree_walks(words: torch.Tensor) -> dict[str, int]:
    """The 64-row tile pairs the kernels walk (``tree_tile_classes``): pairs
    on or below the diagonal, live, full, partial, and the longest walks
    (#4's and #5's live pairs of one query tile, #6's of one key tile)."""
    from areal_tpu_torch.ops import tree_attention as ta

    c = ta.tree_tile_classes(words)
    live = c != ta.DEAD
    nt = c.shape[0]
    return dict(pairs=nt * (nt + 1) // 2, live=int(live.sum()), full=int((c == ta.FULL).sum()),
                partial=int((c == ta.PARTIAL).sum()), dq_walk=int(live.sum(1).max()),
                dkv_walk=int(live.sum(0).max()))


def _tree_check(what: str, q, k, v, dout, words, block_any, valid):
    """#4, then #5 and #6 on its lse, against their plain versions: O within
    the limit, lse within TREE_LSE_TOL, dq / dk / dv within the limit,
    padding rows exact zeros; raises otherwise. Returns (out, lse, delta,
    #4's errors, {grad: (share of the limit, rms(plain), max|diff|)})."""
    from areal_tpu_torch.ops import tree_attention as ta

    with torch.no_grad():
        out, lse = ta.tree_attention_fwd(q, k, v, words, block_any, with_lse=True)
        delta = (dout.float() * out.float()).sum(-1)
        dq = ta.tree_attention_bwd_dq(q, k, v, words, block_any, dout, lse, delta)
        dk, dv = ta.tree_attention_bwd_dkv(q, k, v, words, block_any, dout, lse, delta)
        fe = _tree_fwd_errors(q, k, v, words, block_any, valid, out, lse)
        if not (fe["lse_err"] <= TREE_LSE_TOL and fe["o_share"] <= 1.0 and fe["pad_zero"]):  # NaN fails too
            raise AssertionError(f"[kernel_tree] {what} #4: O off its plain version by {fe['o_share']:.3f} x the "
                                 f"limit, max|lse - plain| {fe['lse_err']}, padded rows zero: {fe['pad_zero']}")
        refs = ta.tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta, out_dtype=torch.float32)
        errs = {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            x, rms = _flash_excess(got, ref, valid)
            e = (got.float() - ref)[valid].abs().max().item()
            if not x <= 1.0 or torch.count_nonzero(got[~valid]).item():
                raise AssertionError(f"[kernel_tree] {what} {name}: off its plain version by {x:.3f} x "
                                     f"the limit (rms {rms:.4f}, max|diff| {e:.3e}) or nonzero on padded rows")
            errs[name] = (x, rms, e)
    return out, lse, delta, fe, errs


def _tree_err_line(fe: dict, errs: dict) -> str:
    return (f"worst element as a share of the limit {FLASH_RTOL:.4g} |plain| + {FLASH_ATOL:.4g} rms(plain): O "
            f"{fe['o_share']:.3f} (max|diff| {fe['o_err']:.3e}), "
            + ", ".join(f"{n} {x:.3f} (max|diff| {e:.3e})" for n, (x, _, e) in errs.items())
            + f"; max|lse - plain| {fe['lse_err']:.2e} ({fe['lse_err'] / TREE_LSE_TOL:.4f} of {TREE_LSE_TOL:g})")


def phase_kernel_tree() -> dict:
    """Kernels #4-#6 against their plain versions at Qwen2.5-1.5B's heads
    (H=12, KV repeated from 2, hd=128, bf16) on two forests, where three
    planted faults in the mask words must fail the check by TREE_FAULT_MIN
    x, then on the walk tries at hd 64 and 128."""
    from areal_tpu_torch.ops import tree_attention as ta

    per: dict[str, dict] = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for fname, seqs in _tree_forests().items():
        q, k, v, dout, words, block_any, valid, pack = _tree_inputs(seqs)
        N, H, hd = q.shape
        mask = ta.expand_mask(words)
        set_bits = int(mask.sum())
        out, lse, delta, fe, errs = _tree_check(fname, q, k, v, dout, words, block_any, valid)
        with torch.no_grad():
            ref_out, _ = ta.tree_attention_fwd_plain(q.float(), k.float(), v.float(), words, block_any)
            refs = ta.tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta,
                                               out_dtype=torch.float32)
            fault_x = {}
            for name, fw in _tree_faults(words, pack.n_nodes).items():
                f_out, _ = ta.tree_attention_fwd_plain(q.float(), k.float(), v.float(), fw, block_any)
                f_grads = ta.tree_attention_bwd_plain(q, k, v, fw, block_any, dout, lse, delta,
                                                      out_dtype=torch.float32)
                fault_x[name] = max(_flash_excess(g_, r_, valid)[0]
                                    for g_, r_ in zip((f_out, *f_grads), (ref_out, *refs)))
                if not fault_x[name] >= TREE_FAULT_MIN:
                    raise AssertionError(f"[kernel_tree] {fname}: planted fault ({name}) only "
                                         f"{fault_x[name]:.2f} x the limit")
            del ref_out, refs
            nB = N // 128
            ba = block_any.cpu().numpy()
            below = int(ba[np.tril_indices(nB, -1)].sum())
            bit31 = int(((words >> 31) & 1).sum())
            log(f"[kernel_tree] {fname}: {len(seqs)} sequences, {sum(map(len, seqs))} tokens -> {pack.n_nodes} "
                f"nodes, N={N} (H={H}, hd={hd}); {set_bits} set bits ({set_bits / N**2:.1%} of N^2); skip map "
                f"{int(ba.sum())} of {nB * (nB + 1) // 2} tiles on or below the diagonal live ({below} below it); "
                f"{bit31} words with bit 31 set; {_tree_err_line(fe, errs)}; planted faults "
                + ", ".join(f"{n} {x:.1f}" for n, x in fault_x.items()))
            walks = _tree_walks(words)
            occ = {}
            for hd_ in (64, 128):
                b = ta.bwd_occupancy(hd_, N)
                occ[hd_] = {"#4": ta.fwd_occupancy(hd_, N), "#5": b["dq"], "#6": b["dkv"]}
            log(f"[kernel_tree] {fname}: 64-row tile pairs on or below the diagonal {walks['pairs']}: live "
                f"{walks['live']} (full {walks['full']}, partial {walks['partial']}), the rest never loaded; the "
                f"longest walks: #4 and #5 {walks['dq_walk']} key tiles, #6 {walks['dkv_walk']} query tiles; "
                + "; ".join(f"hd {hd_} {n} {o['registers']} registers a thread, {o['local_bytes']} B spilled, "
                            f"{o['smem_bytes']} B shared memory, {o['blocks_per_sm']} blocks an SM"
                            for hd_, d in occ.items() for n, o in d.items()))
            # device time by graph replay, the eager host loop beside it
            times = _tree_kernel_times(q, k, v, dout, words, block_any, lse, delta)
            p_fwd = time_cuda(lambda: ta.tree_attention_fwd_plain(q, k, v, words, block_any), iters=3, warmup=1)
            p_bwd = time_cuda(lambda: ta.tree_attention_bwd_plain(q, k, v, words, block_any, dout, lse, delta),
                              iters=3, warmup=1)
        # yardstick the port never calls: SDPA with the dense boolean mask
        # expanded from the bits (padded rows attend themselves, so no row
        # is empty), on [1, H, N, hd] copies made outside the timed region
        dense = (mask | (torch.eye(N, dtype=torch.bool, device="cuda") & ~valid[:, None]))[None, None]
        qt, kt, vt = (x.transpose(0, 1)[None].contiguous() for x in (q, k, v))
        with torch.no_grad():
            lib_fwd = (time_cuda_graph(lambda: sdpa(qt, kt, vt, attn_mask=dense), iters=5),
                       time_cuda(lambda: sdpa(qt, kt, vt, attn_mask=dense), iters=5, warmup=2))
        lib_b = _sdpa_bwd_times(q[None], k[None], v[None], dout[None], None, mask=dense)
        del qt, kt, vt, dense, mask
        bounds = _tree_bounds(N, H, hd, set_bits)
        res = {
            "tree_attention_fwd": dict(max_abs_err=fe["o_err"], plain_ms=p_fwd, library=lib_fwd),
            "tree_attention_bwd_dq": dict(max_abs_err=errs["dq"][2], plain_ms=p_bwd, library=lib_b),
            "tree_attention_bwd_dkv": dict(max_abs_err=max(errs["dk"][2], errs["dv"][2]), plain_ms=p_bwd,
                                           library=lib_b),
        }
        for name, d in res.items():
            d["ms"], d["host_ms"] = times[name]
            d["library_ms"], d["library_host_ms"] = d.pop("library")
            d["bound_ms"], d["bound_by"] = bounds[name]
            d["faults"] = fault_x
            log(f"[kernel_tree] {fname} {name}: kernel={d['ms']:.4f} ms by graph replay (host loop "
                f"{d['host_ms']:.4f}) plain={d['plain_ms']:.4f} ms sdpa={d['library_ms']:.4f} ms by graph replay "
                f"(host loop {d['library_host_ms']:.4f}) bound={d['bound_ms']:.4f} ms ({d['bound_by']})")
        fwd = res["tree_attention_fwd"]
        pair = res["tree_attention_bwd_dq"]["ms"] + res["tree_attention_bwd_dkv"]["ms"]
        log(f"[kernel_tree] {fname}: SDPA forward / #4 = {fwd['library_ms'] / fwd['ms']:.2f}, #4 at "
            f"{fwd['ms'] / fwd['bound_ms']:.1f}x its bound; the plain backward computes dq, dk and dv in one call "
            f"({p_bwd:.4f} ms); SDPA backward {lib_b[0]:.4f} ms by graph replay; #5 + #6 {pair:.4f} ms: "
            f"SDPA's backward (dq, dk, dv in one call) / (#5 + #6) = {lib_b[0] / pair:.2f}, "
            f"{pair / (bounds['tree_attention_bwd_dq'][0] + bounds['tree_attention_bwd_dkv'][0]):.1f}x their bounds")
        fwd.update(o_share=fe["o_share"], lse_err=fe["lse_err"])
        for name, key in (("tree_attention_fwd", "#4"), ("tree_attention_bwd_dq", "#5"),
                          ("tree_attention_bwd_dkv", "#6")):
            res[name]["occupancy"] = {hd_: o[key] for hd_, o in occ.items()}
        res["tile_pairs"] = walks
        per[fname] = res
        del q, k, v, dout, out, lse, delta
        torch.cuda.empty_cache()
    for tname, (seqs, n_pad) in _tree_walk_tries().items():
        for hd in (64, 128):
            q, k, v, dout, words, block_any, valid, pack = _tree_inputs(seqs, hd=hd, n_pad=n_pad)
            _, _, _, fe, errs = _tree_check(f"{tname}/hd{hd}", q, k, v, dout, words, block_any, valid)
            w = _tree_walks(words)
            log(f"[kernel_tree] walk trie {tname}, hd {hd}: {pack.n_nodes} nodes, N={q.shape[0]}; live pairs "
                f"{w['live']} (full {w['full']}, partial {w['partial']}); {_tree_err_line(fe, errs)}")
            del q, k, v, dout, words, block_any
        torch.cuda.empty_cache()
    return per


def _post(addr: str, path: str, body: dict, timeout: float = 900.0) -> dict:
    req = urllib.request.Request(
        f"http://{addr}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wave(addr: str, bodies: list[dict]) -> list[dict]:
    out: list = [None] * len(bodies)
    errs: list = []

    def run(i):
        try:
            out[i] = _post(addr, "/generate", bodies[i])
        except Exception as e:  # noqa: BLE001 — collected and raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    if errs or any(o is None for o in out):
        raise RuntimeError(f"/generate failed: {errs[:2]}")
    return out


def _check_response(r: dict, n_new: int, what: str) -> None:
    lp = r["output_logprobs"]
    if len(r["output_tokens"]) != n_new or len(lp) != n_new or len(r["output_versions"]) != n_new:
        raise AssertionError(f"[{what}] incomplete response: {len(r['output_tokens'])}/{n_new}")
    if not all(math.isfinite(x) and x <= 0.0 for x in lp):
        raise AssertionError(f"[{what}] logprobs not finite and <= 0: {lp[:4]}")


def _dense_diffs(model, prompt: list[int], r: dict, greedy: bool, image_embeds=None) -> np.ndarray:
    """Teacher-forced dense prefill over prompt + output, per output token.
    Sampled responses: |served logprob - dense log-softmax|. Greedy
    responses (their logprob is ~0 under the temperature-0 distribution):
    the shortfall of the chosen token's dense logit below the dense argmax.
    ``image_embeds`` [len(prompt), D]: a VLM prompt's embeddings, placed at
    its image-pad positions."""
    from areal_tpu_torch.models import qwen

    out = r["output_tokens"]
    ids = torch.tensor([prompt + out], device="cuda")
    img = None
    if image_embeds is not None:
        img = torch.zeros((1, ids.shape[1], image_embeds.shape[-1]), dtype=torch.float32, device="cuda")
        img[0, : len(prompt)] = image_embeds
    with torch.no_grad():
        h, _, _ = qwen.forward_prefill(model, ids, torch.arange(ids.shape[1], device="cuda")[None], image_embeds=img)
        logits = qwen.compute_logits(model, h[0, len(prompt) - 1 : len(prompt) - 1 + len(out)])
    tok = torch.tensor(out, device="cuda")[:, None]
    if greedy:
        return (logits.max(dim=-1).values - logits.gather(1, tok)[:, 0]).cpu().numpy()
    dense = torch.log_softmax(logits, dim=-1).gather(1, tok)[:, 0]
    return (dense - torch.tensor(r["output_logprobs"], device="cuda")).abs().cpu().numpy()


def _dense_check(model, prompt: list[int], r: dict, greedy: bool) -> float:
    """The worst output token of ``_dense_diffs``."""
    return float(_dense_diffs(model, prompt, r, greedy).max())


# the grouped matmul's forward kernels by name: gmm_fwd_kernel (bf16) and
# gmm_fwd_f32_kernel, and the one gmm_kernel of older trees (a parent
# package profiled with this script); not tgmm_kernel or the backward's
_GMM_FWD = re.compile(r"\bgmm_(?:fwd_(?:f32_)?)?kernel\b")


def _gmm_fwd_us(prof: dict) -> float:
    """The gmm forward's device microseconds in a ``_profile``."""
    return sum(us for name, us in prof["by_name"].items() if _GMM_FWD.search(name))


def _profile(fn, label: str, card: str) -> dict:
    """Run ``fn`` once under torch.profiler: the share of its wall time in
    which the card ran any kernel or copy ("busy"), the busy microseconds
    and the device time by kernel name ("by_name"); logs the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    log(f"[profile] {card}: device busy {busy / wall_us:.1%} of a {wall_us / 1e6:.2f} s {label} "
        f"({len(spans)} device ops); idle {1 - busy / wall_us:.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile]   {us / 1e3:9.2f} ms  {us / busy:6.1%} of busy  {name[:90]}")
    return dict(busy=busy / wall_us, busy_us=busy, by_name=by_name)


def phase_serve(card: str) -> tuple[int, dict]:
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    mcfg = qwen.ModelConfig(**QWEN25_15B)
    t0 = time.monotonic()
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serve] Qwen2.5-1.5B random weights (seed 0) in {time.monotonic() - t0:.1f}s")
    # the prefix-cache settings of ServerConfig() (radix cache on, flush at
    # a weight commit)
    cfg = ServerConfig(
        max_batch_size=32,
        max_seq_len=2048,
        page_size=128,
        decode_steps_per_call=16,
        host="127.0.0.1",
        seed=0,
    )
    engine = DecodeEngine(cfg, params=model)
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    try:
        rng = np.random.default_rng(0)
        n_new = 128
        prompts = [
            rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 16)
        ]

        def body(p, i):
            sp = {"max_new_tokens": n_new, "greedy": True} if i % 2 == 0 else {
                "max_new_tokens": n_new, "temperature": 1.0}
            return {"input_ids": p, "sampling_params": sp}

        # main path: counts to 0 just before, read just after
        paged_attention_stacked.launches = 0
        steps0 = engine.stats["decode_steps"]
        t0 = time.monotonic()
        resps = _wave(srv.address, [body(p, i) for i, p in enumerate(prompts)])
        wall = time.monotonic() - t0
        launches = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - steps0
        for r in resps:
            _check_response(r, n_new, "serve")
        if launches != mcfg.num_layers * steps or steps == 0:
            raise AssertionError(
                f"[serve] kernel launches {launches} != layers {mcfg.num_layers} x steps {steps}"
            )
        log(f"[serve] 16/16 responses complete; kernel launches {launches} = "
            f"{mcfg.num_layers} layers x {steps} decode steps")
        dev = engine.device_seconds()
        toks = sum(len(r["output_tokens"]) for r in resps)
        log(
            f"[serve] {card}: decode {toks / wall:.1f} tok/s end to end ({toks} tokens, "
            f"{wall:.2f} s wall incl. prefill); {dev['decode_s'] / dev['decode_steps'] * 1e3:.2f} "
            f"ms per decode step (device stream, S=32 slots, 16 active); prefill "
            f"{dev['prefill_tokens'] / dev['prefill_s']:.0f} tok/s (device stream, "
            f"{dev['prefill_tokens']} tokens)"
        )
        metrics = dict(
            decode_tok_s=toks / wall,
            ms_per_step=dev["decode_s"] / dev["decode_steps"] * 1e3,
            wall_ms_per_step=wall / steps * 1e3,
            prefill_tok_s=dev["prefill_tokens"] / dev["prefill_s"],
        )
        errs = [_dense_check(model, prompts[i], resps[i], greedy=False) for i in (1, 3)]
        gaps = [_dense_check(model, prompts[i], resps[i], greedy=True) for i in (0, 2)]
        log(f"[serve] sampled logprobs vs dense prefill: max|diff| {max(errs):.4f} "
            f"(tol {LOGPROB_TOL}); greedy tokens' dense-logit gap to argmax "
            f"{max(gaps):.4f} (tol {LOGPROB_TOL})")
        if max(errs) > LOGPROB_TOL or max(gaps) > LOGPROB_TOL:
            raise AssertionError("[serve] served output disagrees with the dense prefill")

        warm = _warm_wave(srv, engine, model, mcfg, n_new, body, card)
        metrics.update(warm)

        # second wave: a weight update lands while sequences are in flight
        model2 = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
        wave2: list = []
        th = threading.Thread(
            target=lambda: wave2.extend(
                _wave(srv.address, [body(p, 1) for p in prompts[:8]])
            )
        )
        gen0 = engine.stats["generated_tokens"]
        th.start()
        deadline = time.monotonic() + 300
        while engine.stats["generated_tokens"] - gen0 < 8 * 16 and time.monotonic() < deadline:
            time.sleep(0.01)
        engine.update_weights_from_params(model2, version=1)
        th.join(timeout=900)
        if len(wave2) != 8:
            raise AssertionError("[serve] second wave incomplete")
        split = 0
        for r in wave2:
            _check_response(r, n_new, "serve")
            vers = r["output_versions"]
            if vers != sorted(vers) or set(vers) - {0, 1}:
                raise AssertionError(f"[serve] version tags not 0..0,1..1: {vers}")
            split += 0 in vers and 1 in vers
        if not split:
            raise AssertionError("[serve] no in-flight sequence spans the update")
        log(f"[serve] weight update v0->v1 mid-generation: {split}/8 sequences carry 0..0,1..1")
        del model2
        _decode_share(_profile(lambda: _wave(srv.address, [body(p, i) for i, p in enumerate(prompts)]), "wave", card))
    finally:
        srv.stop()
    return launches, metrics


def _decode_share(prof: dict) -> None:
    """Log kernel #1's device time in a profiled wave: its split kernel and
    the merge of its splits (a cold wave launches no other split merge: #3
    runs only on radix hits, where its warm prefill does not split)."""
    us = sum(t for name, t in prof["by_name"].items() if "decode_kernel" in name or "merge_kernel" in name)
    log(f"[profile]   kernel #1 (decode + split merge) {us / 1e3:.2f} ms, {us / prof['busy_us']:.1%} of busy")


def _warm_wave(srv, engine, model, mcfg, n_new: int, body, card: str) -> dict:
    """16 requests sharing a 1,024-token system prompt, with tails of 64..256
    tokens: the first runs alone and publishes the prompt's pages into the
    radix cache, the other 15 admit through radix hits (suffix-only prefill
    over the cached pages: kernel #3's chain launches). Checks the hits, the
    launches, complete responses, logprobs against a dense prefill and,
    after ``/flush_prefix_cache``, the pool's page accounting."""
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa

    rng = np.random.default_rng(3)
    system = rng.integers(0, mcfg.vocab_size, 1024).tolist()
    prompts = [system + rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 257, 16)]
    bodies = [body(p, i) for i, p in enumerate(prompts)]
    keys = ("prefills", "prefill_tokens", "prefix_cache_hits", "prefix_cache_misses", "prefix_hit_tokens",
            "decode_steps", "generated_tokens")
    dev0 = engine.device_seconds()
    # main path: counts to 0 just before, read just after
    for k in psa.launches:
        psa.launches[k] = 0
    s0 = {k: engine.stats[k] for k in keys}
    t0 = time.monotonic()
    resps = _wave(srv.address, bodies[:1])
    t1 = time.monotonic()
    resps += _wave(srv.address, bodies[1:])
    wall = time.monotonic() - t1
    launches = dict(psa.launches)
    d = {k: engine.stats[k] - s0[k] for k in keys}
    dev1 = engine.device_seconds()
    for r in resps:
        _check_response(r, n_new, "serve_warm")
    n_layers = mcfg.num_layers
    if d["prefix_hit_tokens"] <= 0 or launches["chain"] <= 0 or launches["chain"] % n_layers:
        raise AssertionError(f"[serve_warm] no radix hits or chain launches: {d}, launches {launches}")
    cached = [r["cached_prefix_tokens"] for r in resps[1:]]
    if min(cached) < len(system):
        raise AssertionError(f"[serve_warm] a warm request missed the published system prompt: {cached}")
    log(f"[serve_warm] 16/16 responses complete (the first alone, {t1 - t0:.2f} s, then 15 at once, "
        f"{wall:.2f} s); radix hits {d['prefix_cache_hits']}, misses {d['prefix_cache_misses']}, hit tokens "
        f"{d['prefix_hit_tokens']} ({min(cached)}..{max(cached)} per warm request); prefills {d['prefills']} "
        f"over {d['prefill_tokens']} tokens; kernel #3 launches chain {launches['chain']} "
        f"(= {n_layers} layers x {launches['chain'] // n_layers} warm prefill batches), tree {launches['tree']}")
    errs = [_dense_check(model, prompts[i], resps[i], greedy=False) for i in (1, 3, 5)]
    gaps = [_dense_check(model, prompts[i], resps[i], greedy=True) for i in (2, 4, 6)]
    log(f"[serve_warm] warm responses vs dense prefill of prompt + output: sampled logprobs max|diff| "
        f"{max(errs):.4f}, greedy tokens' dense-logit gap to argmax {max(gaps):.4f} (tol {LOGPROB_TOL})")
    if max(errs) > LOGPROB_TOL or max(gaps) > LOGPROB_TOL:
        raise AssertionError("[serve_warm] warm-admitted output disagrees with the dense prefill")
    warm_s = dev1["prefill_s"] - dev0["prefill_s"]
    warm_tok = dev1["prefill_tokens"] - dev0["prefill_tokens"]
    toks = sum(len(r["output_tokens"]) for r in resps[1:])
    log(f"[serve_warm] {card}: 15 warm requests {toks / wall:.1f} decode tok/s end to end; prefill "
        f"{warm_tok} tokens (the first's full prompt + 15 suffixes) in {warm_s * 1e3:.1f} ms of device stream")
    stats = _post(srv.address, "/flush_prefix_cache", {})
    audit = engine.pool_audit()
    if not (audit["ok"] and audit["radix_pages"] == 0
            and audit["free"] + audit["slot_pages"] + audit["radix_pages"] == audit["total"]):
        raise AssertionError(f"[serve_warm] pool audit after the flush: {audit}")
    log(f"[serve_warm] /flush_prefix_cache freed {stats['freed_pages']} pages; pool audit ok: free "
        f"{audit['free']} + slots {audit['slot_pages']} + radix {audit['radix_pages']} = {audit['total']}")
    return dict(warm_launches=launches, warm_hit_tokens=d["prefix_hit_tokens"], warm_decode_tok_s=toks / wall,
                warm_prefill_tokens=warm_tok, warm_prefill_s=warm_s)


def _run_engine(engine, reqs: list, timeout: float = 600.0) -> list:
    """Submit ``reqs`` together to a started engine; their responses in order."""
    out: list = [None] * len(reqs)
    done = threading.Semaphore(0)

    def cb_for(i):
        def cb(r):
            out[i] = r
            done.release()

        return cb

    for i, r in enumerate(reqs):
        engine.submit(r, cb_for(i))
    for _ in reqs:
        if not done.acquire(timeout=timeout):
            raise AssertionError("engine timed out")
    return out


def phase_serve_int8() -> int:
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    mcfg = qwen.ModelConfig(**QWEN25_15B)
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(2))
    cfg = ServerConfig(
        max_batch_size=8,
        max_seq_len=1024,
        page_size=128,
        decode_steps_per_call=16,
        kv_quantization="int8",
        seed=0,
    )
    engine = DecodeEngine(cfg, params=model)
    engine.start()
    try:
        rng = np.random.default_rng(1)
        reqs = [
            ModelRequest(
                input_ids=rng.integers(0, mcfg.vocab_size, int(n)).tolist(),
                gconfig=GenerationHyperparameters(max_new_tokens=32, temperature=1.0),
            )
            for n in rng.integers(64, 513, 8)
        ]
        paged_attention_stacked.launches = 0
        steps0 = engine.stats["decode_steps"]
        resps = _run_engine(engine, reqs)
        launches = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - steps0
    finally:
        engine.stop()
    for r in resps:
        _check_response(
            {"output_tokens": r.output_tokens, "output_logprobs": r.output_logprobs,
             "output_versions": r.output_versions}, 32, "serve_int8")
    if launches != mcfg.num_layers * steps or steps == 0:
        raise AssertionError(f"[serve_int8] launches {launches} != {mcfg.num_layers} x {steps}")
    log(f"[serve_int8] 8/8 responses complete on int8 KV pages; scaled kernel launches "
        f"{launches} = {mcfg.num_layers} x {steps} steps")
    return launches


# the rollout phase: the GRPO loop's rollout half over HTTP
ROLLOUT_CLIENT = dict(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=1, request_timeout=900)
ROLLOUT_SAMPLES, ROLLOUT_NEW = 4, 128
ROLLOUT_CANCEL_MIN_PROMPT = 300  # the cancelled episode's prompt spans full pages


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _check_rollout_rows(batch: dict, n_rows: int, n_new: int, what: str) -> list[tuple[list, dict]]:
    """Every row laid out as ``workflow/rlvr.py`` lays it out and complete;
    returns (prompt, response) per row for the dense check."""
    if batch["input_ids"].shape[0] != n_rows:
        raise AssertionError(f"[{what}] {batch['input_ids'].shape[0]} rows, want {n_rows}")
    rows = []
    for i in range(n_rows):
        n = int(batch["attention_mask"][i].sum())
        lm, lp, vs = batch["loss_mask"][i, :n], batch["logprobs"][i, :n], batch["versions"][i, :n]
        p = int((lm == 0).sum())
        out = batch["input_ids"][i, p:n].tolist()
        if not ((lm[:p] == 0).all() and (lm[p:] == 1).all() and (lp[:p] == 0).all() and (vs[:p] == -1).all()):
            raise AssertionError(f"[{what}] row {i}: prompt / response layout differs from rlvr.py's")
        if len(out) != n_new or not np.isfinite(lp[p:]).all() or (lp[p:] > 0).any() or (vs[p:] < 0).any():
            raise AssertionError(f"[{what}] row {i}: {len(out)}/{n_new} tokens or bad logprobs / versions")
        if list(vs[p:]) != sorted(vs[p:].tolist()):
            raise AssertionError(f"[{what}] row {i}: version tags not monotone: {sorted(set(vs[p:].tolist()))}")
        if not bool(batch["seq_no_eos_mask"][i]):
            raise AssertionError(f"[{what}] row {i}: a length-capped response marked as EOS-terminated")
        rows.append((batch["input_ids"][i, :p].tolist(), {"output_tokens": out, "output_logprobs": lp[p:].tolist()}))
    return rows


def phase_rollout(card: str, serve: dict | None = None, model_kw: dict | None = None) -> dict:
    """The rollout half of the asynchronous GRPO loop, over HTTP, on the
    port's server: ``RemoteTorchEngine.prepare_batch`` with ``RLVRWorkflow``
    three times; one episode is cancelled once (its requests reaped by
    /abort_request, the task retried), and a pause / set_version(1) /
    continue lands while the second call's rows decode. ``serve``: the serve
    phase's metrics, printed beside the loop's."""
    import asyncio

    from areal_tpu_torch.api.config import InferenceEngineConfig, ServerConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters
    from areal_tpu_torch.api.workflow_api import RolloutWorkflow
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.observability import catalog
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa
    from areal_tpu_torch.reward.synthetic import target_token_reward_fn
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    mcfg = qwen.ModelConfig(**(model_kw or QWEN25_15B))
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    cfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                       host="127.0.0.1", seed=0)
    engine = DecodeEngine(cfg, params=model)
    srv = ServerThread(cfg, engine=engine)
    # every /generate attempt the server answers: (rid, input length, cached
    # prefix tokens, stop reason); a rid's second attempt is a resume
    attempts: list[tuple[str, int, int, str]] = []
    h_generate = srv.server.h_generate

    def h_generate_logged(d: dict, **kw):
        status, out = h_generate(d, **kw)
        attempts.append((d.get("rid", ""), len(d["input_ids"]), int(out["cached_prefix_tokens"]), out["stop_reason"]))
        return status, out

    srv.server.h_generate = h_generate_logged
    srv.start()
    rcfg = InferenceEngineConfig(**ROLLOUT_CLIENT)
    client = RemoteTorchEngine(rcfg, addresses=[srv.address])
    client.initialize()
    robust = catalog.robustness_metrics()
    gconfig = GenerationHyperparameters(n_samples=ROLLOUT_SAMPLES, max_new_tokens=ROLLOUT_NEW, temperature=1.0)
    inner = RLVRWorkflow(target_token_reward_fn, gconfig)
    episodes: list[tuple[float, float]] = []  # (start, end) of every finished episode
    cancel = dict(fired=False, chunks=0)

    class Loop(RolloutWorkflow):
        """The RLVR workflow; the first episode with a long prompt is
        cancelled once, four decode chunks after it started, and raises,
        so the executor retries it."""

        async def arun_episode(self, eng, data):
            t0 = time.monotonic()
            if not cancel["fired"] and len(data["prompt_ids"]) >= ROLLOUT_CANCEL_MIN_PROMPT:
                cancel["fired"] = True
                c0 = engine.stats["chunks"]
                task = asyncio.ensure_future(inner.arun_episode(eng, data))
                while engine.stats["chunks"] - c0 < 4 and not task.done():
                    await asyncio.sleep(0.005)
                cancel["chunks"] = engine.stats["chunks"] - c0
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                raise RuntimeError("episode cancelled by the rollout phase")
            out = await inner.arun_episode(eng, data)
            episodes.append((t0, time.monotonic()))
            return out

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 16)]
    if max(len(p) for p in prompts[:8]) < ROLLOUT_CANCEL_MIN_PROMPT:
        raise AssertionError("[rollout] no prompt of the first wave is long enough to cancel")
    loader = [{"prompt_ids": p} for p in prompts]
    samples: list[tuple[float, int, int, int]] = []  # (t, capacity, running, active slots)
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            samples.append((time.monotonic(), client.get_capacity(), client.executor.staleness.stat.running,
                            sum(t is not None for t in engine._slot_task)))
            time.sleep(0.01)

    sampler = threading.Thread(target=sample, name="rollout-sampler", daemon=True)
    batches, versions_at = [], []
    pause = {}
    try:
        # main path: counts to 0 just before, read just after
        keys = ("decode_steps", "generated_tokens", "cancelled", "aborted", "prefix_hit_tokens", "kv_resumes")
        s0 = {k: engine.stats[k] for k in keys}
        r0 = (robust.task_retries.get(), robust.task_quarantined.get())
        paged_attention_stacked.launches = 0
        for k in psa.launches:
            psa.launches[k] = 0
        sampler.start()
        t0 = time.monotonic()
        batches.append(client.prepare_batch(loader, workflow=Loop()))
        versions_at.append(client.get_version())
        box: list = []
        th = threading.Thread(target=lambda: box.append(client.prepare_batch(loader, workflow=Loop())), daemon=True)
        g0 = engine.stats["generated_tokens"]
        th.start()
        deadline = time.monotonic() + 600
        while engine.stats["generated_tokens"] - g0 < 64 and th.is_alive() and time.monotonic() < deadline:
            time.sleep(0.002)
        if not th.is_alive():
            raise AssertionError("[rollout] the second prepare_batch returned before any of its rows decoded")
        tp = time.monotonic()
        client.pause_generation()
        pause["ack_s"] = time.monotonic() - tp
        client.set_version(1)
        client.continue_generation()
        pause["pause_to_resume_s"] = time.monotonic() - tp
        th.join(timeout=900)
        if not box:
            raise AssertionError("[rollout] the second prepare_batch did not return")
        batches.append(box[0])
        versions_at.append(client.get_version())
        batches.append(client.prepare_batch(loader, workflow=Loop()))
        versions_at.append(client.get_version())
        wall = time.monotonic() - t0
        # drain: no new submissions, let the tasks in flight finish
        client.pause()
        deadline = time.monotonic() + 600
        while client.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
        while any(t is not None for t in engine._slot_task) and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        sampler.join(timeout=10)
        launches1, launches3 = paged_attention_stacked.launches, dict(psa.launches)
        d = {k: engine.stats[k] - s0[k] for k in keys}
        retries, quarantined = robust.task_retries.get() - r0[0], robust.task_quarantined.get() - r0[1]
        time.sleep(0.1)
        audit = engine.pool_audit()
    finally:
        stop.set()
        client.destroy()
        srv.stop()

    n_rows = ROLLOUT_CLIENT["consumer_batch_size"] * ROLLOUT_SAMPLES
    rows = [_check_rollout_rows(b, n_rows, ROLLOUT_NEW, f"rollout batch {i + 1}") for i, b in enumerate(batches)]
    # version tags and the staleness bound
    spans = 0
    for i, (b, v) in enumerate(zip(batches, versions_at)):
        gen = b["loss_mask"] > 0
        vs = b["versions"][gen]
        if v - int(vs.min()) > rcfg.max_head_offpolicyness:
            raise AssertionError(f"[rollout] batch {i + 1} consumed at v{v} holds tokens of v{int(vs.min())}")
        for j in range(n_rows):
            tags = b["versions"][j][gen[j]]
            spans += i == 1 and tags[0] == 0 and tags[-1] == 1
    if set(batches[0]["versions"][batches[0]["loss_mask"] > 0].tolist()) != {0} or not spans:
        raise AssertionError(f"[rollout] batch 1 not all v0, or no row of batch 2 spans the pause ({spans})")
    # the paused requests resumed from their parked KV (no prefill); the
    # cancelled episode's retry hit the pages its cancelled requests
    # published (warm prefill: #3)
    seen: dict[str, int] = {}
    resumed = []
    for rid, n_in, cached, reason in attempts:
        if rid in seen:
            resumed.append((n_in, cached))
        seen[rid] = seen.get(rid, 0) + 1
    if not resumed or d["kv_resumes"] != len(resumed) or sum(launches3.values()) <= 0:
        raise AssertionError(f"[rollout] {len(resumed)} resumed requests, {d['kv_resumes']} KV resumes, #3 launches "
                             f"{launches3}")
    cancelled = [a for a in attempts if a[3] == "cancelled"]
    if not cancel["fired"] or d["cancelled"] != ROLLOUT_SAMPLES or len(cancelled) != ROLLOUT_SAMPLES:
        raise AssertionError(f"[rollout] the cancelled episode's requests: engine {d['cancelled']}, "
                             f"responses {len(cancelled)}, want {ROLLOUT_SAMPLES}")
    if (retries, quarantined) != (1, 0):
        raise AssertionError(f"[rollout] executor retries {retries}, quarantined {quarantined}; the cancel "
                             "should cause one retry and no quarantine")
    if not audit["ok"]:
        raise AssertionError(f"[rollout] pool audit after the loop: {audit}")
    caps = [c for _, c, _, _ in samples]
    running = [r for _, _, r, _ in samples]
    peak_slots = max(a for _, _, _, a in samples)
    if max(running) > rcfg.max_concurrent_rollouts:
        raise AssertionError(f"[rollout] {max(running)} rollouts ran at once, bound {rcfg.max_concurrent_rollouts}")
    want_slots = min(cfg.max_batch_size, rcfg.max_concurrent_rollouts * ROLLOUT_SAMPLES)
    if peak_slots < want_slots:
        raise AssertionError(f"[rollout] peak active slots {peak_slots} < {want_slots}: the client capped "
                             "the requests in flight")
    steps = d["decode_steps"]
    if steps == 0 or launches1 != mcfg.num_layers * steps:
        raise AssertionError(f"[rollout] #1 launches {launches1} != {mcfg.num_layers} layers x {steps} steps")
    errs = [_dense_check(model, p, r, greedy=False) for rs in rows for p, r in rs[:4]]
    if max(errs) > LOGPROB_TOL:
        raise AssertionError(f"[rollout] served logprobs vs dense prefill {max(errs):.4f} > {LOGPROB_TOL}")
    toks = 3 * n_rows * ROLLOUT_NEW
    lat = [b - a for a, b in episodes]
    direct = (f"{serve['decode_tok_s']:.1f} tok/s, {serve['wall_ms_per_step']:.2f} ms a step at 16 slots"
              if serve is not None else "not measured in this run")
    log(f"[rollout] 3 prepare_batch calls x {n_rows} rows complete (rlvr.py layout, {ROLLOUT_NEW} tokens each); "
        f"batch versions {versions_at}; {spans} rows of batch 2 span the pause (tags 0..0,1..1); staleness "
        f"held (<= {rcfg.max_head_offpolicyness} behind)")
    log(f"[rollout] {card}: {toks / wall:.1f} tok/s through the loop ({toks} batch tokens in {wall:.2f} s wall; "
        f"{d['generated_tokens']} tokens generated in all, {d['generated_tokens'] / wall:.1f} tok/s; "
        f"{wall / steps * 1e3:.2f} ms of wall a decode step over {steps} steps, up to 32 slots, the pause and "
        f"prefills in it); the serve phase's direct wave: {direct}")
    log(f"[rollout] {card}: task latency p50 {_percentile(lat, 50):.2f} s, p95 {_percentile(lat, 95):.2f} s over "
        f"{len(lat)} episodes; pause -> resume {pause['pause_to_resume_s'] * 1e3:.1f} ms (the pause's ack "
        f"{pause['ack_s'] * 1e3:.1f} ms)")
    log(f"[rollout] capacity min {min(caps)} max {max(caps)}, running max {max(running)} (bound "
        f"{rcfg.max_concurrent_rollouts}), peak active slots {peak_slots} of {cfg.max_batch_size}; "
        f"{len(samples)} samples")
    log(f"[rollout] resumed requests {len(resumed)}, all from their parked KV ({d['kv_resumes']} KV resumes, "
        f"radix hit tokens {d['prefix_hit_tokens']} in the phase); cancelled "
        f"episode: {d['cancelled']} requests reaped after {cancel['chunks']} chunks, executor retries "
        f"{retries:.0f}, quarantined {quarantined:.0f}; pool audit ok")
    log(f"[rollout] kernel #1 launches {launches1} = {mcfg.num_layers} layers x {steps} decode steps; kernel #3 "
        f"launches {launches3}; served logprobs vs dense prefill max|diff| {max(errs):.4f} on {len(errs)} rows "
        f"(tol {LOGPROB_TOL})")
    log(f"[rollout] {card}: the phase took {time.monotonic() - t_phase:.1f} s (model, server and client set-up, "
        f"the loop, the checks)")
    return dict(launches1=launches1, launches3=sum(launches3.values()), tok_s=toks / wall, steps=steps,
                p50=_percentile(lat, 50), p95=_percentile(lat, 95), pause_ms=pause["pause_to_resume_s"] * 1e3,
                peak_slots=peak_slots)


LIFECYCLE_PROMPTS, LIFECYCLE_NEW = 16, 256


def _http_status(addr: str, path: str, body: dict | None = None, timeout: float = 60.0) -> tuple[int, dict, dict]:
    """(status, headers, JSON) of one GET (no body) or POST, 4xx / 5xx
    answers included."""
    req = urllib.request.Request(f"http://{addr}{path}", data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


NEAR_TIE = 1e-3  # two runs with the same batching part only where the top two logits are this close


def _near_ties(model, prompts: list, got: list, want: list, what: str, tol: float = NEAR_TIE):
    """Hold two greedy runs of the same requests to each other: each pair
    of outputs is equal, or parts where both tokens sit within ``tol`` of
    the dense argmax (a near-tie). The near-ties as (request, token index,
    gap of ``got``'s token, gap of ``want``'s)."""
    ties = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        j, ga, gb = _greedy_divergence(model, p, a, b)
        if max(ga, gb) > tol:
            raise AssertionError(f"[lifecycle] {what}: request {i} parts at token {j} off a near-tie "
                                 f"(dense-logit gaps {ga:.4f} / {gb:.4f}, tol {tol})")
        ties.append((i, j, ga, gb))
    return ties


def _admit_together(engine, n: int) -> None:
    """Hold ``engine``'s admission until ``n`` requests are queued, then
    admit them in one pass, ordered by their ids: two waves of the same
    requests then prefill in the same groups and decode in the same slots,
    so their greedy tokens agree bit for bit (requests arriving over HTTP
    on their own threads would otherwise group by arrival). One use; the
    gate opens anyway after 120 s, so a missing request fails the check
    that follows instead of hanging the phase."""
    from collections import deque

    t_end = time.monotonic() + 120

    def gated():
        q = engine._queue
        if q.qsize() + len(engine._backlog) < n and time.monotonic() < t_end:
            return []
        with q.mutex:
            q.queue = deque(sorted(q.queue, key=lambda t: tuple(t.req.input_ids)))
        del engine._admit_pending  # back to the engine's own
        return engine._admit_pending()

    engine._admit_pending = gated


def _penalized_gaps(model, prompt: list[int], out: list[int], pen: float) -> np.ndarray:
    """Teacher-forced dense forward over prompt + output: per output token,
    the shortfall of its penalized logit (logits - pen x the counts of the
    output tokens before it) below the penalized argmax."""
    from areal_tpu_torch.models import qwen

    ids = torch.tensor([prompt + out], device="cuda")
    with torch.no_grad():
        h, _, _ = qwen.forward_prefill(model, ids, torch.arange(ids.shape[1], device="cuda")[None])
        logits = qwen.compute_logits(model, h[0, len(prompt) - 1: len(prompt) - 1 + len(out)]).float()
    tok = torch.tensor(out, device="cuda")
    onehot = torch.nn.functional.one_hot(tok, logits.shape[-1]).float()
    before = torch.cumsum(onehot, dim=0) - onehot  # counts of the tokens before each position
    pl = logits - pen * before
    return (pl.max(dim=-1).values - pl.gather(1, tok[:, None])[:, 0]).cpu().numpy()


def phase_lifecycle(card: str) -> dict:
    """The serving engine's request lifecycle at Qwen2.5-1.5B's full width
    and ``CUT_LAYERS`` of its depth (random bf16 weights from a seed), the serve phase's
    ``ServerConfig``, over HTTP through ``RemoteTorchEngine`` where a client
    is involved:

    (a) park / resume: 16 greedy requests (64-512-token prompts, 256 new
        tokens) abort-paused after ~64 tokens, held 0.2 s and continued:
        16 KV resumes, no prefill from the pause to the end, the tokens of
        an uninterrupted run on a fresh engine (near-ties recorded); the
        continue -> first resumed token beside the same wave whose parkings a commit
        of the same weights evicted (``kv_reuse_across_updates=False``,
        the tree kept: the resubmits' warm prefill, kernel #3);
    (b) across a weight update: an abort pause, a staged update of
        perturbed weights, the resume; reuse on: no prefill, the tokens
        after the commit tagged v1; reuse off: prefill tokens equal to the
        resumed prompts' lengths, logprobs within LOGPROB_TOL of a dense
        forward under the new weights;
    (c) the frequency penalty (``enable_frequency_penalty``): 8 greedy
        requests at 5.0 and 8 at 0 in one wave with one abort / resume;
        each penalized token the argmax of the dense logits less 5 x the
        running counts, near-ties recorded;
    (d) deadlines: 8 requests of 512 tokens due 1 s out end "deadline"
        with a partial output; one due before it arrives never prefills;
        retries of the reaped ones hit their published pages (#3);
    (e) admission: ``max_queue_depth=8`` pushed through /autopilot/knobs;
        64 raw posts see 429s with Retry-After, the same 64 through the
        client (``backpressure_wait_s=60``) all complete with no retry
        attempt spent;
    (f) drain: /drain mid-wave (budget 2 s) parks the wave, leaks no page;
        /health 503 and /generate 429 "draining"; after /undrain the parked
        requests resume and complete;
    (g) release / resume memory: the reserved and allocated device memory
        fall by at least the served weights plus the KV pool; after resume
        a greedy wave equals the one before the release.

    Each wave that is compared with another admits its requests
    together, in one order (``_admit_together``), so the two batch alike.
    Then the pool audit and the #1 / #3 launches of the phase (cold prefill
    is plain PyTorch, as in the JAX engine: K2 serves the trainer only).
    The watchdog and the wedge detector need a planted stall; they are held
    on the CPU only (``tests/test_torch_request_lifecycle.py``)."""
    import asyncio

    from areal_tpu_torch.api.config import InferenceEngineConfig, PrefixCacheConfig, RequestLifecycleConfig, \
        ServerConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest, WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.observability import catalog
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa

    t_phase = time.monotonic()
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    base = dict(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16, host="127.0.0.1",
                seed=0)
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, LIFECYCLE_PROMPTS)]
    out: dict = {}
    steps = 0  # decode steps of every engine of the phase

    class Served:
        """One engine behind its server, and a client."""

        def __init__(self, **kw):
            self.cfg = ServerConfig(**base, **kw)
            self.engine = DecodeEngine(self.cfg, params=model)
            self.srv = ServerThread(self.cfg, engine=self.engine)
            self.srv.start()
            self.addr = self.srv.address
            self.client = self.new_client()

        def new_client(self, **lc):
            c = RemoteTorchEngine(InferenceEngineConfig(request_timeout=900, lifecycle=RequestLifecycleConfig(**lc)),
                                  addresses=[self.addr])
            c.initialize()
            return c

        def wave(self, reqs, client=None):
            """Every request through ``agenerate`` at once, on a thread; the
            thread and the box its responses land in."""
            client = client or self.client
            box: list = []

            async def run():
                try:
                    box.extend(await asyncio.gather(*(client.agenerate(r) for r in reqs)))
                finally:
                    await client.close_loop_connections()

            th = threading.Thread(target=lambda: asyncio.run(run()), daemon=True)
            th.start()
            return th, box

        def done(self, th, box, n, what):
            th.join(timeout=900)
            if len(box) != n:
                raise AssertionError(f"[lifecycle] {what}: {len(box)} of {n} responses")
            return box

        def wait_tokens(self, n, th, what):
            deadline = time.monotonic() + 600
            g0 = self.g0
            while self.engine.stats["generated_tokens"] - g0 < n and th.is_alive() and time.monotonic() < deadline:
                time.sleep(0.001)
            if not th.is_alive():
                raise AssertionError(f"[lifecycle] {what}: the wave ended before the pause")

        def mark(self):
            self.g0 = self.engine.stats["generated_tokens"]

        def first_token_after(self, t0):
            g = self.engine.stats["generated_tokens"]
            deadline = time.monotonic() + 120
            while self.engine.stats["generated_tokens"] == g and time.monotonic() < deadline:
                time.sleep(0.0005)
            return time.monotonic() - t0

        def close(self):
            nonlocal steps
            steps += self.engine.stats["decode_steps"]
            self.client.destroy()
            self.srv.stop()

    def greedy(p, n, rid=None, **g):
        kw = {} if rid is None else {"rid": rid}
        return ModelRequest(input_ids=list(p), gconfig=GenerationHyperparameters(max_new_tokens=n, greedy=True, **g),
                            **kw)

    def interrupted(s, reqs, at, hold, between=None):
        """A wave abort-paused once ``at`` tokens a request were generated,
        ``between(s)`` run in the pause (else a ``hold`` s sleep), then
        continued, the wave and its resubmits each admitted together:
        (responses, stats at the pause ack, seconds from the continue to
        the first resumed token)."""
        s.mark()
        _admit_together(s.engine, len(reqs))
        th, box = s.wave(reqs)
        s.wait_tokens(len(reqs) * at, th, "pause")
        s.client.pause_generation()
        at_pause = dict(s.engine.stats)
        if between is not None:
            between(s)
        else:
            time.sleep(hold)
        _admit_together(s.engine, len(reqs))
        t0 = time.monotonic()
        s.client.continue_generation()
        first = s.first_token_after(t0)
        return s.done(th, box, len(reqs), "interrupted wave"), at_pause, first

    # main path: counts to 0 just before, read just after
    paged_attention_stacked.launches = 0
    for k in psa.launches:
        psa.launches[k] = 0
    fa.flash_attention_fwd.launches = 0

    # (a) park / resume: the uninterrupted run first, on a fresh engine
    s = Served()
    t0 = time.monotonic()
    _admit_together(s.engine, LIFECYCLE_PROMPTS)
    ref = s.done(*s.wave([greedy(p, LIFECYCLE_NEW) for p in prompts]), LIFECYCLE_PROMPTS, "reference wave")
    ref_wall = time.monotonic() - t0
    s.close()
    del s
    gc.collect()
    s = Served()  # the main engine of (a), (b), (d)-(g)
    eng = s.engine
    resp, at_pause, first_on = interrupted(s, [greedy(p, LIFECYCLE_NEW, rid=f"a{i}") for i, p in enumerate(prompts)],
                                           64, 0.2)
    d_res = eng.stats["kv_resumes"] - at_pause["kv_resumes"]
    d_pre = eng.stats["prefill_tokens"] - at_pause["prefill_tokens"]
    for r in resp:
        _check_response({"output_tokens": r.output_tokens, "output_logprobs": r.output_logprobs,
                         "output_versions": r.output_versions}, LIFECYCLE_NEW, "lifecycle a")
    ties = _near_ties(model, prompts, [r.output_tokens for r in resp], [r.output_tokens for r in ref], "(a)")
    if d_res != LIFECYCLE_PROMPTS or d_pre != 0:
        raise AssertionError(f"[lifecycle] (a) kv_resumes +{d_res} (want {LIFECYCLE_PROMPTS}), prefill tokens "
                             f"+{d_pre} from the pause to the end (want 0)")
    # the same wave, its parkings evicted by a commit of the same weights
    # (kv_reuse_across_updates off) and the tree kept: the resubmits' warm
    # prefill over their published pages (#3)
    eng.config.kv_reuse_across_updates = False
    eng.config.prefix_cache = PrefixCacheConfig(across_updates="keep")
    chain0 = psa.launches["chain"]
    resp_off, at_off, first_off = interrupted(
        s, [greedy(p, LIFECYCLE_NEW, rid=f"a-off{i}") for i, p in enumerate(prompts)], 64, 0.0,
        between=lambda s: (time.sleep(0.2), s.engine.update_weights_from_params(model, version=0)))
    d_pre_off = eng.stats["prefill_tokens"] - at_off["prefill_tokens"]
    d_hit_off = eng.stats["prefix_hit_tokens"] - at_off["prefix_hit_tokens"]
    chain_off = psa.launches["chain"] - chain0
    # the warm re-prefill writes KV through #3 where decode wrote it
    # through #1: other roundings, so greedy tokens may part at bf16
    # near-ties (held to LOGPROB_TOL, as the spec phase holds its paths)
    ties_off = _near_ties(model, prompts, [r.output_tokens for r in resp_off], [r.output_tokens for r in ref],
                          "(a) re-prefilled", tol=LOGPROB_TOL)
    if eng.stats["kv_resumes"] != at_off["kv_resumes"] or d_hit_off <= 0 or chain_off <= 0:
        raise AssertionError(f"[lifecycle] (a) without reuse: resumes {eng.stats['kv_resumes'] - at_off['kv_resumes']}"
                             f", radix hit tokens {d_hit_off}, #3 chain launches {chain_off}")
    eng.config.kv_reuse_across_updates = True
    eng.config.prefix_cache = PrefixCacheConfig()
    log(f"[lifecycle] (a) {card}: 16 greedy requests x {LIFECYCLE_NEW} tokens, abort-paused at ~64 tokens each, held "
        f"0.2 s: kv_resumes +{d_res}, prefill tokens +{d_pre} from the pause to the end; tokens vs an uninterrupted "
        f"run on a fresh engine ({ref_wall:.2f} s): {LIFECYCLE_PROMPTS - len(ties)}/16 identical, near-ties "
        + (", ".join(f"req {i} tok {j} ({a:.4f} / {b:.4f})" for i, j, a, b in ties) or "none")
        + f"; continue -> first resumed token {first_on * 1e3:.1f} ms (parked KV) vs {first_off * 1e3:.1f} ms with the "
        f"parkings evicted (warm re-prefill of {d_pre_off} tokens over {d_hit_off} radix-hit tokens, #3 chain "
        f"launches {chain_off}; near-ties " + (", ".join(f"req {i} tok {j}" for i, j, _, _ in ties_off) or "none")
        + ")")
    out["a"] = dict(first_resumed_ms=first_on * 1e3, first_reprefill_ms=first_off * 1e3, resumes=d_res,
                    near_ties=len(ties), reprefill_tokens=d_pre_off)

    # (b) across a weight update: abort, staged update of perturbed weights
    # (the client streams bf16 buckets with generation paused), resume
    gen = torch.Generator(device="cuda").manual_seed(1)

    def perturbed():
        with torch.no_grad():
            return {n: (p.float() + 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")).to(p.dtype)
                    for n, p in model.state_dict().items()}

    def staged(s):
        new = perturbed()
        s.client.update_weights(WeightUpdateMeta(), params=new)
        del new

    s.client.config.weight_commit_fence = "none"  # the abort pause is the fence
    sampled = [ModelRequest(input_ids=list(p), rid=f"b{i}", gconfig=GenerationHyperparameters(
        max_new_tokens=128, temperature=1.0)) for i, p in enumerate(prompts)]
    bres = {}
    for reuse in (True, False):
        eng.config.kv_reuse_across_updates = reuse
        for r in sampled:
            r.rid = f"b{int(reuse)}-{r.rid}"
        v_new = s.client.get_version() + 1
        resp_b, at_b, first_b = interrupted(s, sampled, 32, 0.0, between=staged)
        d_res = eng.stats["kv_resumes"] - at_b["kv_resumes"]
        d_pre = eng.stats["prefill_tokens"] - at_b["prefill_tokens"]
        n_first = [r.output_versions.count(v_new - 1) for r in resp_b]
        for r, k in zip(resp_b, n_first):
            _check_response({"output_tokens": r.output_tokens, "output_logprobs": r.output_logprobs,
                             "output_versions": r.output_versions}, 128, "lifecycle b")
            if r.output_versions != [v_new - 1] * k + [v_new] * (128 - k) or not 0 < k < 128:
                raise AssertionError(f"[lifecycle] (b) version tags {sorted(set(r.output_versions))} around v{v_new}")
        if reuse:
            if d_res != LIFECYCLE_PROMPTS or d_pre != 0:
                raise AssertionError(f"[lifecycle] (b) reuse on: kv_resumes +{d_res}, prefill tokens +{d_pre}")
            err = float("nan")
        else:
            want = sum(len(p) + k for p, k in zip(prompts, n_first))
            if d_res != 0 or d_pre != want:
                raise AssertionError(f"[lifecycle] (b) reuse off: kv_resumes +{d_res}, prefill tokens {d_pre} != the "
                                     f"resumed prompts' {want}")
            # the resumed tokens' logprobs against a dense forward under the
            # new weights, over prompt + every output token
            err = max(float(_dense_diffs(model, p, {"output_tokens": r.output_tokens,
                                                    "output_logprobs": r.output_logprobs}, greedy=False)[k:].max())
                      for p, r, k in zip(prompts, resp_b, n_first))
            if not err <= LOGPROB_TOL:
                raise AssertionError(f"[lifecycle] (b) reuse off: resumed logprobs vs the new weights' dense "
                                     f"forward {err:.4f} > {LOGPROB_TOL}")
        bres[reuse] = dict(resumes=d_res, prefill=d_pre, first_ms=first_b * 1e3, err=err, pre=sum(n_first))
    eng.config.kv_reuse_across_updates = True
    log(f"[lifecycle] (b) {card}: 16 sampled requests x 128 tokens, abort pause -> staged update of perturbed "
        f"weights ({weight_bytes / 1e9:.2f} GB of bf16 buckets) -> resume; reuse on: kv_resumes +{bres[True]['resumes']}, prefill "
        f"tokens +{bres[True]['prefill']}, tokens after the commit tagged v{v_new - 1} (continue -> first token "
        f"{bres[True]['first_ms']:.0f} ms; reuse off {bres[False]['first_ms']:.0f} ms); reuse off: kv_resumes +{bres[False]['resumes']}, "
        f"prefill tokens {bres[False]['prefill']} (= the resumed prompts' lengths), resumed logprobs vs the new "
        f"weights' dense forward max|diff| {bres[False]['err']:.4f} (tol {LOGPROB_TOL})")
    out["b"] = bres

    # (d) deadlines on the main engine: reaped mid-decode, then one already
    # past in the queue, then retries over the reaped requests' pages
    dl = [ModelRequest(input_ids=list(p), gconfig=GenerationHyperparameters(max_new_tokens=512, greedy=True,
                                                                             ignore_eos=True))
          for p in prompts[:8]]
    t0 = time.time()
    for r in dl:
        r.deadline = t0 + 1.0
    resp_d = s.done(*s.wave(dl), 8, "deadline wave")
    wall_d = time.time() - t0
    n_d = [len(r.output_tokens) for r in resp_d]
    if any(r.stop_reason != "deadline" or r.truncated_by != "deadline" for r in resp_d) or not all(
            0 < n < 512 for n in n_d):
        raise AssertionError(f"[lifecycle] (d) {[(r.stop_reason, len(r.output_tokens)) for r in resp_d]}")
    pre0 = eng.stats["prefill_tokens"]
    late = ModelRequest(input_ids=list(prompts[8]), gconfig=GenerationHyperparameters(max_new_tokens=8, greedy=True))
    late.deadline = time.time() - 1.0
    r_late = s.done(*s.wave([late]), 1, "late request")[0]
    if r_late.stop_reason != "deadline" or r_late.output_tokens or eng.stats["prefill_tokens"] != pre0:
        raise AssertionError(f"[lifecycle] (d) the late request: {r_late.stop_reason}, {len(r_late.output_tokens)} "
                             f"tokens, prefill tokens +{eng.stats['prefill_tokens'] - pre0}")
    chain0, hit0 = psa.launches["chain"], eng.stats["prefix_hit_tokens"]
    s.done(*s.wave([greedy(p + r.output_tokens, 16) for p, r in zip(prompts[:8], resp_d)]), 8, "retries")
    chain_d, hit_d = psa.launches["chain"] - chain0, eng.stats["prefix_hit_tokens"] - hit0
    if chain_d <= 0 or hit_d <= 0:
        raise AssertionError(f"[lifecycle] (d) the retries missed the reaped requests' pages: hit tokens {hit_d}, "
                             f"#3 chain launches {chain_d}")
    log(f"[lifecycle] (d) {card}: 8 requests of 512 tokens due 1 s out: stop_reason deadline after {min(n_d)}..."
        f"{max(n_d)} tokens ({wall_d:.2f} s wall); one due before it arrived: 0 tokens, prefill tokens +0; retries "
        f"of the reaped 8: {hit_d} radix-hit tokens, #3 chain launches {chain_d}")
    out["d"] = dict(tokens=(min(n_d), max(n_d)), wall_s=wall_d)

    # (e) admission control, the gate pushed through /autopilot/knobs
    lc_obs = catalog.lifecycle_metrics()
    retries = catalog.robustness_metrics().retries.labels(kind="post")
    if _http_status(s.addr, "/autopilot/knobs", {"max_queue_depth": 8})[0] != 200:
        raise AssertionError("[lifecycle] (e) /autopilot/knobs refused")
    bodies = [{"input_ids": prompts[i % 16][:128], "sampling_params": {"max_new_tokens": 64, "greedy": True}}
              for i in range(64)]
    raw: list = [None] * 64

    def post(i):
        raw[i] = _http_status(s.addr, "/generate", bodies[i], timeout=900)

    ths = [threading.Thread(target=post, args=(i,)) for i in range(64)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=900)
    rejected = [r for r in raw if r is not None and r[0] == 429]
    served = [r for r in raw if r is not None and r[0] == 200]
    if (len(rejected) + len(served) != 64 or not rejected
            or not all(r[2]["reason"] == "queue_depth" and float(r[1]["Retry-After"]) > 0 for r in rejected)
            or not all(len(r[2]["output_tokens"]) == 64 for r in served)):
        raise AssertionError(f"[lifecycle] (e) raw posts: {len(served)} served, {len(rejected)} refused, "
                             f"{64 - len(served) - len(rejected)} other")
    rej0, ret0 = lc_obs.admission_rejected.labels(reason="queue_depth").get(), retries.get()
    c60 = s.new_client(backpressure_wait_s=60.0)
    t0 = time.monotonic()
    resp_e = s.done(*s.wave([greedy(b["input_ids"], 64) for b in bodies], client=c60), 64, "client wave")
    wall_e = time.monotonic() - t0
    c60.destroy()
    rej_c, ret_c = lc_obs.admission_rejected.labels(reason="queue_depth").get() - rej0, retries.get() - ret0
    if not all(len(r.output_tokens) == 64 for r in resp_e) or ret_c != 0 or rej_c <= 0:
        raise AssertionError(f"[lifecycle] (e) the client's wave: {sum(len(r.output_tokens) == 64 for r in resp_e)}"
                             f"/64 complete, {rej_c:.0f} refusals, {ret_c:.0f} retry attempts")
    _http_status(s.addr, "/autopilot/knobs", {"max_queue_depth": 0})
    log(f"[lifecycle] (e) {card}: max_queue_depth 8 (pushed through /autopilot/knobs): 64 raw posts -> "
        f"{len(served)} served, {len(rejected)} answered 429 queue_depth (Retry-After "
        f"{min(float(r[1]['Retry-After']) for r in rejected):.2f}..{max(float(r[1]['Retry-After']) for r in rejected):.2f}"
        f" s); the same 64 through the client: 64/64 complete in {wall_e:.2f} s after {rej_c:.0f} refusals waited "
        f"out, {ret_c:.0f} retry attempts spent")
    out["e"] = dict(raw_served=len(served), raw_refused=len(rejected), client_refusals=rej_c, client_s=wall_e)

    # (f) the drain, mid-wave, and the way back
    s.mark()
    drain_reqs = [greedy(p, 512, rid=f"f{i}", ignore_eos=True) for i, p in enumerate(prompts)]
    th, box = s.wave(drain_reqs)
    s.wait_tokens(16 * 32, th, "drain")
    res0 = eng.stats["kv_resumes"]
    st, _, summary = _http_status(s.addr, "/drain", {"budget_s": 2.0}, timeout=120)
    health = _http_status(s.addr, "/health")
    gate = _http_status(s.addr, "/generate", bodies[0])
    if (st != 200 or summary["leaked_pages"] != 0 or summary["parked"] <= 0
            or health[:3:2] != (503, {"status": "draining", "version": eng.get_version()})
            or gate[0] != 429 or gate[2].get("reason") != "draining"):
        raise AssertionError(f"[lifecycle] (f) drain summary {summary}, /health {health[0]} {health[2]}, "
                             f"/generate {gate[0]} {gate[2]}")
    t_undrain = time.monotonic()
    if _http_status(s.addr, "/undrain", {})[0] != 200:
        raise AssertionError("[lifecycle] (f) /undrain refused")
    resp_f = s.done(th, box, 16, "drained wave")
    d_res = eng.stats["kv_resumes"] - res0
    if not all(len(r.output_tokens) == 512 for r in resp_f) or d_res != summary["parked"]:
        raise AssertionError(f"[lifecycle] (f) after /undrain: {sum(len(r.output_tokens) == 512 for r in resp_f)}/16 "
                             f"complete, kv_resumes +{d_res} for {summary['parked']} parked")
    log(f"[lifecycle] (f) {card}: /drain (budget 2 s) mid-wave: {summary['drain_seconds']:.2f} s, finished in budget "
        f"{summary['finished_in_budget']}, parked {summary['parked']}, aborted {summary['aborted']}, leaked pages "
        f"{summary['leaked_pages']}; /health {health[0]} draining, /generate {gate[0]} draining; after /undrain "
        f"16/16 complete in {time.monotonic() - t_undrain:.2f} s, kv_resumes +{d_res}")
    out["f"] = dict(parked=summary["parked"], leaked=summary["leaked_pages"], drain_s=summary["drain_seconds"])

    # (g) release / resume memory; both waves cold (the tree flushed first:
    # the resumed engine's is empty) and admitted together
    g_bodies = [{"input_ids": p[:200], "sampling_params": {"max_new_tokens": 64, "greedy": True}} for p in prompts[:8]]
    _http_status(s.addr, "/flush_prefix_cache", {})
    _admit_together(eng, 8)
    before = [r["output_tokens"] for r in _wave(s.addr, g_bodies)]
    kv_bytes = eng.memory_bytes()["kv_pool"]
    gc.collect()
    torch.cuda.synchronize()
    r0, a0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    t0 = time.monotonic()
    if _http_status(s.addr, "/release_memory_occupation", {}, timeout=300)[0] != 200:
        raise AssertionError("[lifecycle] (g) /release_memory_occupation failed")
    t_rel = time.monotonic() - t0
    r1, a1 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    t0 = time.monotonic()
    if _http_status(s.addr, "/resume_memory_occupation", {}, timeout=300)[0] != 200:
        raise AssertionError("[lifecycle] (g) /resume_memory_occupation failed")
    t_res = time.monotonic() - t0
    _http_status(s.addr, "/continue_generation", {})
    _admit_together(eng, 8)
    after = [r["output_tokens"] for r in _wave(s.addr, g_bodies)]
    need = weight_bytes + kv_bytes
    ties_g = _near_ties(model, [b["input_ids"] for b in g_bodies], after, before, "(g)")
    if r0 - r1 < need or a0 - a1 < need:
        raise AssertionError(f"[lifecycle] (g) reserved fell {(r0 - r1) / 1e9:.3f} GB, allocated "
                             f"{(a0 - a1) / 1e9:.3f} GB < weights + KV pool {need / 1e9:.3f} GB")
    log(f"[lifecycle] (g) {card}: /release_memory_occupation in {t_rel:.2f} s: reserved {r0 / 1e9:.3f} -> "
        f"{r1 / 1e9:.3f} GB, allocated {a0 / 1e9:.3f} -> {a1 / 1e9:.3f} GB (the served weights "
        f"{weight_bytes / 1e9:.3f} GB + the KV pool {kv_bytes / 1e9:.3f} GB = {need / 1e9:.3f}); resume in "
        f"{t_res:.2f} s; the greedy wave after: {8 - len(ties_g)}/8 identical to the one before, near-ties "
        + (", ".join(f"req {i} tok {j}" for i, j, _, _ in ties_g) or "none"))
    out["g"] = dict(reserved_fall_gb=(r0 - r1) / 1e9, allocated_fall_gb=(a0 - a1) / 1e9, need_gb=need / 1e9,
                    release_s=t_rel, resume_s=t_res)
    time.sleep(0.1)
    audit = eng.pool_audit()
    if not audit["ok"] or audit["parked_pages"] or audit["slot_pages"]:
        raise AssertionError(f"[lifecycle] the main engine's pool audit: {audit}")
    s.close()
    del s, eng
    gc.collect()

    # (c) the frequency penalty, its own engine (the count table)
    s = Served(enable_frequency_penalty=True)
    eng = s.engine
    pen = 5.0
    creqs = [greedy(p, 128, rid=f"c{i}", frequency_penalty=pen if i < 8 else 0.0) for i, p in enumerate(prompts)]
    resp_c, at_c, _ = interrupted(s, creqs, 32, 0.1)
    d_res = eng.stats["kv_resumes"] - at_c["kv_resumes"]
    pen_ties, plain_gap = [], 0.0
    for i, (p, r) in enumerate(zip(prompts, resp_c)):
        if len(r.output_tokens) != 128:
            raise AssertionError(f"[lifecycle] (c) request {i}: {len(r.output_tokens)}/128 tokens")
        if i < 8:
            gaps = _penalized_gaps(model, p, r.output_tokens, pen)
            if gaps.max() > LOGPROB_TOL:
                raise AssertionError(f"[lifecycle] (c) request {i}: a token {gaps.max():.4f} below the penalized "
                                     f"argmax (tol {LOGPROB_TOL})")
            pen_ties += [(i, int(j), float(gaps[j])) for j in np.nonzero(gaps > 0)[0]]
        else:
            plain_gap = max(plain_gap, _dense_check(model, p, {"output_tokens": r.output_tokens}, greedy=True))
    if plain_gap > LOGPROB_TOL or d_res != LIFECYCLE_PROMPTS:
        raise AssertionError(f"[lifecycle] (c) plain rows' gap {plain_gap:.4f}, kv_resumes +{d_res}")
    distinct = [len(set(r.output_tokens)) / 128 for r in resp_c]
    mem = eng.memory_bytes()
    log(f"[lifecycle] (c) {card}: frequency penalty 5.0 on 8 of 16 greedy requests x 128 tokens, one abort / resume "
        f"inside (kv_resumes +{d_res}): every penalized token the argmax of the dense logits less 5 x its running "
        f"counts but {len(pen_ties)} near-ties (max gap {max([g for _, _, g in pen_ties], default=0.0):.4f}, tol "
        f"{LOGPROB_TOL}); plain rows' dense gap {plain_gap:.4f}; distinct tokens {np.mean(distinct[:8]):.1%} "
        f"penalized vs {np.mean(distinct[8:]):.1%} plain; count table {mem['freq_counts'] / 1e6:.2f} MB beside the "
        f"KV pool's {mem['kv_pool'] / 1e9:.3f} GB")
    out["c"] = dict(near_ties=len(pen_ties), distinct_pen=float(np.mean(distinct[:8])),
                    distinct_plain=float(np.mean(distinct[8:])), counts_mb=mem["freq_counts"] / 1e6)
    audit = eng.pool_audit()
    if not audit["ok"]:
        raise AssertionError(f"[lifecycle] (c) pool audit: {audit}")
    s.close()
    del s, eng

    launches1, launches3, k2 = paged_attention_stacked.launches, dict(psa.launches), fa.flash_attention_fwd.launches
    if launches1 != L * steps or steps == 0 or launches3["chain"] <= 0:
        raise AssertionError(f"[lifecycle] #1 launches {launches1} != {L} layers x {steps} steps, or #3 {launches3}")
    log(f"[lifecycle] kernel #1 launches {launches1} = {L} layers x {steps} decode steps; kernel #3 launches "
        f"{launches3} (the re-prefills of (a) and the retries of (d)); K2 {k2} (the serving prefill is plain "
        f"PyTorch, as the JAX engine's); pool audits ok")
    log(f"[lifecycle] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    del model
    return dict(launches1=launches1, launches3=sum(launches3.values()), k2=k2, steps=steps,
                seconds=time.monotonic() - t_phase, **out)


OBSERVE_PROMPTS, OBSERVE_NEW = 16, 96
OBSERVE_LATENCY_TOL_S = 5e-3  # timing fields + other_s against a response's latency
OBSERVE_IDENTITY_TOL_S = 1e-9  # a probe step's phases + other_s against its wall


def _prometheus_samples(text: str) -> tuple[int, list[str]]:
    """The Prometheus text's families (# TYPE lines) and sample lines; raises
    on a line that does not parse."""
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
                        r'([-+]?[0-9.eE+-]+|[-+]?Inf|NaN)$')
    families, samples = 0, []
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            families += 1
        elif ln.startswith("#"):
            continue
        elif not sample.match(ln):
            raise AssertionError(f"[observe] (d) an unparsable Prometheus line: {ln[:120]!r}")
        else:
            samples.append(ln)
    return families, samples


def phase_observe(card: str) -> dict:
    """The serving engine's observability at Qwen2.5-1.5B's full width and
    ``CUT_LAYERS`` of its depth (random bf16 weights from a seed), the serve phase's
    ``ServerConfig``, over HTTP: a cold wave of 16, a warm wave of 16 on a
    shared 1,024-token system prompt (radix hits, #3 chain launches) with a
    2 s ``POST /debug/profile`` capture taken during it, 16 requests
    abort-paused through ``RemoteTorchEngine`` and resumed from their
    parked KV (#1 over parked pages), a wave across one staged weight
    update inside the hold fence, and one 429. Prints, with the card's name
    and power limit:

    (a) each raw wave's mean timing breakdown and the worst |timing fields
        + other_s - latency| (fails past 5 ms), and the resumed requests'
        split of the continue -> first resumed token: the client's poll,
        the queue wait and admission -> first token;
    (b) the decode-loop probe's per-phase means and dominant phase (every
        recorded step's identity checked as it is recorded, no catch) and
        the roofline fraction with its peak source;
    (c) /statusz ``hbm`` against ``torch.cuda.memory_allocated`` /
        ``mem_get_info``, the weights and the KV pool itemized;
    (d) the Prometheus text of /metrics, parsed line by line;
    (e) the flight ring's kinds from the phase;
    (f) the profile's trace file, holding ``decode_kernel`` (kernel #1);
    (g) the probe's own cost per pass: spans x the measured cost of one
        span, as a share of the pass wall.

    Then no timeline left unterminated after a drain, and the #1 / #3
    launches of the phase."""
    import asyncio
    import collections
    import tempfile

    from areal_tpu_torch.api.config import InferenceEngineConfig, PerfTracerConfig, ServerConfig
    from areal_tpu_torch.api.io_struct import TIMING_FIELDS, GenerationHyperparameters, ModelRequest, \
        WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.observability import kernel_probe
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa
    from areal_tpu_torch.utils import perf_tracer

    t_phase = time.monotonic()
    # the capture and any flight dump go to a directory of the phase's own
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_observe_")
    flight_env = os.environ.get("AREAL_FLIGHT_DIR")
    os.environ["AREAL_FLIGHT_DIR"] = os.path.join(tmp.name, "flight")
    tracer = perf_tracer._TRACER
    perf_tracer._TRACER = perf_tracer.PerfTracer(PerfTracerConfig(output_dir=tmp.name))
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                       host="127.0.0.1", seed=0)
    engine = DecodeEngine(cfg, params=model)
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    addr = srv.address
    client = RemoteTorchEngine(InferenceEngineConfig(request_timeout=900), addresses=[addr])
    client.initialize()
    rng = np.random.default_rng(19)
    V = mcfg.vocab_size
    out: dict = {}

    # (b) / (g): every recorded pass's identity, checked as it is recorded
    # (recording an error, never raising on the decode thread), and the
    # probe spans each recorded pass opened
    probe = engine.kprobe
    bad_steps: list = []
    spans_open: dict[int, int] = collections.defaultdict(int)
    spans_per_step: list[int] = []
    sums = collections.defaultdict(float)  # FLOPs, bytes and wall of the recorded passes
    complete_step, kphase = probe.complete_step, engine._kphase

    def checked(tl, tokens=0, cost_key=None):
        bd = complete_step(tl, tokens=tokens, cost_key=cost_key)
        named = sum(bd[f"{p}_s"] for p in kernel_probe.DECODE_PHASES)
        if abs(named + bd["other_s"] - bd["total_s"]) > OBSERVE_IDENTITY_TOL_S or bd["other_s"] < 0:
            bad_steps.append(bd)
        spans_per_step.append(spans_open.pop(id(tl), 0))
        cost = probe.cost_for(cost_key) or {"flops": 0.0, "bytes": 0.0}
        sums["flops"] += cost["flops"]
        sums["bytes"] += cost["bytes"]
        sums["wall"] += bd["total_s"]
        return bd

    def counted(name):
        tl = engine._ktl
        if tl is not None:
            spans_open[id(tl)] += 1
        return kphase(name)

    probe.complete_step, engine._kphase = checked, counted

    def body(ids, rid, n=OBSERVE_NEW):
        return {"input_ids": ids, "rid": rid, "sampling_params": {"max_new_tokens": n, "greedy": True,
                                                                   "ignore_eos": True}}

    def timelines() -> dict[str, list[dict]]:
        recs: dict[str, list[dict]] = {}
        for r in _http_status(addr, "/debug/flight?timelines=512")[2]["timelines"]:
            recs.setdefault(r["rid"], []).append(r)
        return recs

    def breakdowns(resps, what) -> dict:
        """Mean timing of a raw wave and its worst |timing + other_s -
        latency| (each response against its own timeline)."""
        recs = timelines()
        worst, sums = 0.0, collections.defaultdict(float)
        for r in resps:
            bd = recs[r["rid"]][-1]["breakdown"]
            tm = r["timing"]
            if any(tm[k] != bd[k] for k in TIMING_FIELDS):
                raise AssertionError(f"[observe] (a) {what}: the response's timing {tm} is not its timeline's {bd}")
            named = tm["queue_wait_s"] + tm["prefill_s"] + tm["decode_s"] + tm["fence_stall_s"] + bd["other_s"]
            worst = max(worst, abs(named - r["latency"]))
            for k in (*TIMING_FIELDS, "other_s"):
                sums[k] += bd[k]
            sums["latency"] += r["latency"]
        if worst > OBSERVE_LATENCY_TOL_S:
            raise AssertionError(f"[observe] (a) {what}: timing + other_s parts from the latency by {worst * 1e3:.3f} ms")
        mean = {k: v / len(resps) for k, v in sums.items()}
        log(f"[observe] (a) {card}: {what}, {len(resps)} requests, mean s: "
            + ", ".join(f"{k[:-2] if k.endswith('_s') else k} {v:.4f}" for k, v in mean.items())
            + f"; worst |timing + other - latency| {worst * 1e6:.1f} us")
        return dict(mean=mean, worst_s=worst)

    def client_wave(reqs):
        box: list = []

        async def run():
            try:
                box.extend(await asyncio.gather(*(client.agenerate(r) for r in reqs)))
            finally:
                await client.close_loop_connections()

        th = threading.Thread(target=lambda: asyncio.run(run()), daemon=True)
        th.start()
        return th, box

    try:
        # main path: counts to 0 just before, read just after
        paged_attention_stacked.launches = 0
        for k in psa.launches:
            psa.launches[k] = 0

        # the cold wave
        prompts = [rng.integers(0, V, int(n)).tolist() for n in rng.integers(64, 513, OBSERVE_PROMPTS)]
        t0 = time.monotonic()
        cold = _wave(addr, [body(p, f"cold{i}") for i, p in enumerate(prompts)])
        for r in cold:
            _check_response(r, OBSERVE_NEW, "observe cold")
        out["cold"] = breakdowns(cold, f"cold wave ({time.monotonic() - t0:.2f} s)")

        # the warm wave on a shared system prompt, a 2 s capture during it
        system = rng.integers(0, V, 1024).tolist()
        _post(addr, "/generate", body(system + rng.integers(0, V, 16).tolist(), "prime", 8))
        chain0, hits0 = psa.launches["chain"], engine.stats["prefix_hit_tokens"]
        status, _, prof = _http_status(addr, "/debug/profile?duration_s=2", {})
        if status != 200:
            raise AssertionError(f"[observe] (f) /debug/profile answered {status}: {prof}")
        t0 = time.monotonic()
        warm = _wave(addr, [body(system + rng.integers(0, V, int(n)).tolist(), f"warm{i}")
                            for i, n in enumerate(rng.integers(32, 129, OBSERVE_PROMPTS))])
        for r in warm:
            _check_response(r, OBSERVE_NEW, "observe warm")
            if r["cached_prefix_tokens"] < 1024:
                raise AssertionError(f"[observe] warm wave: {r['cached_prefix_tokens']} cached prefix tokens")
        out["warm"] = breakdowns(warm, f"warm wave on a 1,024-token system prompt ({time.monotonic() - t0:.2f} s, "
                                       f"{engine.stats['prefix_hit_tokens'] - hits0} radix-hit tokens, #3 chain "
                                       f"launches {psa.launches['chain'] - chain0})")
        if psa.launches["chain"] - chain0 <= 0:
            raise AssertionError("[observe] warm wave: kernel #3 never ran a chain launch")
        if _http_status(addr, "/debug/profile?duration_s=2", {})[0] not in (200, 409):
            raise AssertionError("[observe] (f) a second /debug/profile answered neither 200 nor 409")
        deadline = time.monotonic() + 120
        while perf_tracer.device_profile_active() is not None and time.monotonic() < deadline:
            time.sleep(0.1)
        perf_tracer.stop_device_profile()  # the second capture, when it started
        trace = os.path.join(prof["trace_dir"], "trace.json")
        with open(trace, "rb") as f:
            raw = f.read()
        n_decode = raw.count(b"decode_kernel")
        if n_decode == 0:
            raise AssertionError(f"[observe] (f) the profile's trace ({len(raw)} bytes) holds no decode_kernel")
        log(f"[observe] (f) {card}: a 2 s /debug/profile capture during the warm wave: trace.json {len(raw) / 1e6:.1f} MB, "
            f"'decode_kernel' {n_decode} times")
        out["profile"] = dict(trace_mb=len(raw) / 1e6, decode_kernel=n_decode)
        del raw

        # abort pause -> parked resumes, through the client
        reqs = [ModelRequest(input_ids=list(p), rid=f"park{i}", gconfig=GenerationHyperparameters(
            max_new_tokens=128, greedy=True, ignore_eos=True)) for i, p in enumerate(prompts)]
        g0, res0 = engine.stats["generated_tokens"], engine.stats["kv_resumes"]
        th, box = client_wave(reqs)
        deadline = time.monotonic() + 300
        while engine.stats["generated_tokens"] - g0 < 32 * len(reqs) and th.is_alive() and time.monotonic() < deadline:
            time.sleep(0.001)
        client.pause_generation()
        time.sleep(0.2)
        t_cont = time.time()
        client.continue_generation()
        th.join(timeout=900)
        if len(box) != len(reqs) or engine.stats["kv_resumes"] - res0 != len(reqs):
            raise AssertionError(f"[observe] parked resumes: {len(box)} responses, kv_resumes "
                                 f"+{engine.stats['kv_resumes'] - res0}")
        recs = timelines()
        split = collections.defaultdict(list)
        for r in reqs:
            first, resumed = recs[r.rid][-2], recs[r.rid][-1]
            stg = [e["stage"] for e in resumed["events"]]
            if first["terminal_reason"] != "abort" or "resume" not in stg or "prefill_start" in stg:
                raise AssertionError(f"[observe] {r.rid}: stages {stg} after {first['terminal_reason']}")
            bd = resumed["breakdown"]
            split["poll"].append(resumed["epoch_anchor"] - t_cont)
            split["queue_wait"].append(bd["queue_wait_s"])
            split["admitted_to_first_token"].append(bd["ttft_s"] - bd["queue_wait_s"])
            split["continue_to_first_token"].append(resumed["epoch_anchor"] - t_cont + bd["ttft_s"])
            split["park"].append(bd["park_s"])
        means = {k: sum(v) / len(v) for k, v in split.items()}
        log(f"[observe] (a) {card}: 16 requests abort-paused at ~32 tokens, held 0.2 s, resumed from parked KV "
            f"(kv_resumes +{len(reqs)}): continue -> first resumed token {means['continue_to_first_token']:.4f} s "
            f"(max {max(split['continue_to_first_token']):.4f}) = client poll {means['poll']:.4f} + queue wait "
            f"{means['queue_wait']:.4f} + admission -> first token {means['admitted_to_first_token']:.4f} (the "
            f"dispatch of a chunk and the next, the first token being drained one dispatch late); park "
            f"{means['park']:.4f} s")
        out["resume"] = means

        # a wave across one staged weight update inside the hold fence
        g0 = engine.stats["generated_tokens"]
        fence_wave: list = []
        th = threading.Thread(target=lambda: fence_wave.extend(_wave(addr, [
            body(p, f"fence{i}", 128) for i, p in enumerate(prompts)])), daemon=True)
        th.start()
        deadline = time.monotonic() + 300
        while engine.stats["generated_tokens"] - g0 < 16 * len(prompts) and time.monotonic() < deadline:
            time.sleep(0.001)
        v0 = client.get_version()
        t0 = time.monotonic()
        client.update_weights(WeightUpdateMeta(), params=model.state_dict())
        t_upd = time.monotonic() - t0
        th.join(timeout=900)
        if len(fence_wave) != len(prompts):
            raise AssertionError(f"[observe] fence wave: {len(fence_wave)} responses")
        stalled = [r for r in fence_wave if r["timing"]["fence_stall_s"] > 0]
        spanning = [r for r in fence_wave if len(set(r["output_versions"])) == 2]
        if not stalled or engine.get_version() != v0 + 1:
            raise AssertionError(f"[observe] fence wave: {len(stalled)} requests with a fence stall, version "
                                 f"{engine.get_version()} (want {v0 + 1})")
        out["fence"] = breakdowns(fence_wave, f"wave across a staged update of {weight_bytes / 1e9:.2f} GB in the hold "
                                              f"fence ({t_upd:.2f} s; {len(stalled)} requests stalled, "
                                              f"{len(spanning)} spanning v{v0} -> v{v0 + 1})")

        # one 429 into the ring
        engine.begin_drain()
        status = _http_status(addr, "/generate", body([1, 2, 3], "refused", 4))[0]
        if not engine.end_drain() or status != 429:
            raise AssertionError(f"[observe] the draining gate answered {status}")

        # (b) the probe
        ks = _http_status(addr, "/statusz")[2]["kernels"]
        if bad_steps:
            raise AssertionError(f"[observe] (b) {len(bad_steps)} probe steps break the identity: {bad_steps[:2]}")
        if ks["steps"] != len(spans_per_step) or ks["steps"] == 0:
            raise AssertionError(f"[observe] (b) {ks['steps']} steps recorded, {len(spans_per_step)} checked")
        pm = ks["phase_means_s"]
        pk = ks["peaks"]
        # the mean of per-pass fractions weighs a pass that only drains a
        # chunk (milliseconds, a whole chunk's FLOPs) like a dispatching one;
        # the fraction of the summed FLOPs over the summed wall does not
        agg = kernel_probe.roofline_fraction(sums["flops"], sums["bytes"], sums["wall"], pk["flops"], pk["membw"])
        log(f"[observe] (b) {card}: {ks['steps']} recorded passes of the decode loop ({ks['abandoned']} abandoned), "
            f"identity held on every one; mean s a pass: " + ", ".join(f"{p} {v:.5f}" for p, v in pm.items())
            + f", other {ks['other_mean_s']:.5f}, total {ks['total_mean_s']:.5f}; dominant {ks['dominant_phase']} "
            f"({max(pm.values()) / ks['total_mean_s']:.1%}); roofline fraction, mean of the passes "
            f"{ks['roofline_fraction']:.6f}, of the summed FLOPs over the summed wall {agg:.6f}, against "
            f"{pk['flops'] / 1e12:.0f} TFLOP/s and {pk['membw'] / 1e12:.2f} TB/s ({pk['source']}); tokens/s over "
            f"the recorded passes {ks['tok_s']:.1f}; device attribution {ks.get('device_attribution')}")
        out["probe"] = dict(steps=ks["steps"], phase_means_s=pm, other_mean_s=ks["other_mean_s"],
                            total_mean_s=ks["total_mean_s"], dominant=ks["dominant_phase"],
                            roofline=ks["roofline_fraction"], roofline_summed=agg, peak_source=pk["source"])

        # (c) the ledger against the allocator
        torch.cuda.synchronize()
        hbm = _http_status(addr, "/statusz")[2]["hbm"]
        allocated = torch.cuda.memory_allocated()
        free, total = torch.cuda.mem_get_info()
        comp = hbm["components"]
        if hbm["source"] != "device" or comp["params"] != weight_bytes or comp["kv_page_pool"] != \
                engine.memory_bytes()["kv_pool"] or hbm["bytes_limit"] != total:
            raise AssertionError(f"[observe] (c) ledger {hbm} (weights {weight_bytes}, allocated {allocated}, "
                                 f"total {total})")
        log(f"[observe] (c) {card}: /statusz hbm params {comp['params'] / 1e9:.3f} GB, kv_page_pool "
            f"{comp['kv_page_pool'] / 1e9:.3f} GB, radix_cache {comp['radix_cache'] / 1e9:.3f} GB (in the pool), "
            f"staged_update {comp['staged_update'] / 1e9:.3f} GB, freq_counts {comp['freq_counts']}; in use "
            f"{hbm['bytes_in_use'] / 1e9:.3f} GB (torch.cuda.memory_allocated {allocated / 1e9:.3f} GB after it), "
            f"peak {hbm['peak_bytes'] / 1e9:.3f} GB, limit {hbm['bytes_limit'] / 1e9:.3f} GB (mem_get_info total "
            f"{total / 1e9:.3f}, free {free / 1e9:.3f}), headroom {hbm['headroom_fraction']:.4f}")
        out["hbm"] = dict(params=comp["params"], kv=comp["kv_page_pool"], in_use=hbm["bytes_in_use"],
                          allocated=allocated)

        # (d) the Prometheus text
        req = urllib.request.Request(f"http://{addr}/metrics", headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=60) as r:
            ctype, text = r.headers.get("Content-Type", ""), r.read().decode()
        families, samples = _prometheus_samples(text)
        names = {re.match(r"[^{ ]+", s).group(0) for s in samples}
        want = {"areal_request_queue_wait_seconds_count", "areal_request_tpot_seconds_count",
                "areal_request_fence_stall_seconds_count", "areal_decode_phase_seconds_count",
                "areal_decode_roofline_fraction", "areal_hbm_bytes", "areal_flight_events_total"}
        if not ctype.startswith("text/plain") or want - names:
            raise AssertionError(f"[observe] (d) {ctype}: missing {sorted(want - names)}")
        log(f"[observe] (d) {card}: /metrics as text/plain: {families} families, {len(samples)} samples, every line "
            f"parsed; {len(text) / 1e3:.1f} kB")
        out["prometheus"] = dict(families=families, samples=len(samples))

        # (e) the ring
        fl = _http_status(addr, "/debug/flight?timelines=0")[2]
        kinds = collections.Counter(e["kind"] for e in fl["events"])
        want = {"weight_stage", "weight_commit", "drain_begin", "admission_reject"}
        if want - set(kinds) or fl["role"] != "inference_server":
            raise AssertionError(f"[observe] (e) flight kinds {dict(kinds)}, role {fl['role']}")
        log(f"[observe] (e) {card}: flight ring ({fl['role']}, {len(fl['events'])} events, {fl['dropped']} dropped): "
            + ", ".join(f"{k} {n}" for k, n in sorted(kinds.items())))
        out["flight"] = dict(kinds)

        # (g) the probe's own cost: one span measured alone
        tl = kernel_probe.DecodeStepTimeline()
        n = 200_000
        t0 = time.perf_counter()
        for _ in range(n):
            with tl.phase("admission"):
                pass
        span_s = (time.perf_counter() - t0) / n
        per_pass = sum(spans_per_step) / len(spans_per_step)
        share = per_pass * span_s / ks["total_mean_s"]
        log(f"[observe] (g) {card}: {per_pass:.2f} probe spans a recorded pass x {span_s * 1e6:.3f} us a span = "
            f"{per_pass * span_s * 1e6:.2f} us, {share:.4%} of the mean pass ({ks['total_mean_s'] * 1e3:.2f} ms)")
        out["probe_cost"] = dict(spans_per_pass=per_pass, span_us=span_s * 1e6, share=share)

        summary = engine.drain(5.0)
        if summary["unterminated_timelines"] != 0 or summary["leaked_pages"] != 0:
            raise AssertionError(f"[observe] drain: {summary}")
        out["launches1"], out["launches3"] = paged_attention_stacked.launches, sum(psa.launches.values())
        if out["launches1"] <= 0:
            raise AssertionError("[observe] kernel #1 never launched")
        log(f"[observe] {card}: #1 launches {out['launches1']}, #3 launches {out['launches3']}; drain: 0 "
            f"unterminated timelines, 0 leaked pages; the phase {time.monotonic() - t_phase:.1f} s")
    finally:
        client.destroy()
        srv.stop()
        perf_tracer.stop_device_profile()
        perf_tracer._TRACER = tracer
        if flight_env is None:
            os.environ.pop("AREAL_FLIGHT_DIR", None)
        else:
            os.environ["AREAL_FLIGHT_DIR"] = flight_env
        tmp.cleanup()
    return out


def _greedy_divergence(model, prompt: list[int], a: list[int], b: list[int]) -> tuple[int, float, float]:
    """Where two greedy outputs part: the index, and each one's token's logit
    gap to the argmax in a dense prefill of prompt + the common prefix (a
    near-tie shows as two small gaps)."""
    from areal_tpu_torch.models import qwen

    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        raise AssertionError(f"outputs of {len(a)} and {len(b)} tokens")
    ids = torch.tensor([prompt + a[:i]], device="cuda")
    with torch.no_grad():
        h, _, _ = qwen.forward_prefill(model, ids, torch.arange(ids.shape[1], device="cuda")[None])
        logits = qwen.compute_logits(model, h[0, -1])
    top = logits.max().item()
    return i, top - logits[a[i]].item(), top - logits[b[i]].item()


def phase_spec(card: str) -> dict:
    """Speculative decoding at full width and depth: 8 greedy requests whose
    prompts repeat n-grams, through a non-speculative engine and then engines
    with the ngram drafter and the tree drafter (the same weights). The
    speculative engines' tokens must equal the non-speculative engine's;
    verify runs kernel #3's tree launches."""
    from areal_tpu_torch.api.config import ServerConfig, SpeculativeConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa

    mcfg = qwen.ModelConfig(**QWEN25_15B)
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(4))
    rng = np.random.default_rng(4)
    prompts = []
    for n in rng.integers(64, 257, 8):
        block = rng.integers(0, mcfg.vocab_size, int(rng.integers(4, 17))).tolist()
        prompts.append((block * (int(n) // len(block) + 1))[: int(n)] + rng.integers(0, mcfg.vocab_size, 4).tolist())
    n_new = 64

    def reqs():
        return [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=n_new, greedy=True))
                for p in prompts]

    base = dict(max_batch_size=32, max_seq_len=1024, page_size=128, decode_steps_per_call=16, seed=0)

    def run(spec: SpeculativeConfig | None):
        cfg = ServerConfig(**base) if spec is None else ServerConfig(**base, speculative=spec)
        eng = DecodeEngine(cfg, params=model)
        eng.start()
        try:
            t0 = time.monotonic()
            resps = _run_engine(eng, reqs())
            wall = time.monotonic() - t0
        finally:
            eng.stop()
        for r in resps:
            if len(r.output_tokens) != n_new:
                raise AssertionError(f"[spec] incomplete response {len(r.output_tokens)}/{n_new} ({r.stop_reason})")
        return eng, [r.output_tokens for r in resps], wall

    _, ref, ref_wall = run(None)
    ref_gap = max(_dense_check(model, p, {"output_tokens": r}, greedy=True) for p, r in zip(prompts, ref))
    log(f"[spec] {card}: non-speculative engine: 8 greedy requests x {n_new} tokens in {ref_wall:.2f} s "
        f"({8 * n_new / ref_wall:.1f} tok/s)")
    out = {"ref_tok_s": 8 * n_new / ref_wall}
    # main path: counts to 0 just before, read just after
    for k in psa.launches:
        psa.launches[k] = 0
    for drafter in ("ngram", "tree"):
        spec = SpeculativeConfig(enabled=True, drafter=drafter)
        eng, got, wall = run(spec)
        st, audit, dev = eng.stats, eng.pool_audit(), eng.device_seconds()
        same = sum(g == r for g, r in zip(got, ref))
        # bf16 greedy decoding is not bit-reproducible across the two paths:
        # verify reaches a token's hidden state through kernel #3 and GEMMs
        # of S*B rows, decode through kernel #1 and GEMMs of S rows, and
        # cuBLAS picks kernels by shape, so the roundings differ and a
        # near-tie can go either way. Held instead: each request equals the
        # non-speculative engine's up to its first difference, where both
        # tokens sit within LOGPROB_TOL of the dense argmax (a near-tie),
        # and every token the speculative engine emits is the dense argmax
        # within LOGPROB_TOL (the serve phase's greedy bound)
        parts = [_greedy_divergence(model, prompts[i], got[i], ref[i]) for i in range(len(ref)) if got[i] != ref[i]]
        spec_gap = max(_dense_check(model, p, {"output_tokens": g}, greedy=True) for p, g in zip(prompts, got))
        log(f"[spec] {card}: {drafter} drafter (spec_depth {spec.spec_depth}, B={spec.max_nodes()} verify rows): "
            f"{same}/8 requests token-identical to the non-speculative engine; the others part at near-ties "
            f"(token index, dense-logit gaps to argmax of the speculative / non-speculative token): "
            + (", ".join(f"{i} ({a:.4f} / {b:.4f})" for i, a, b in parts) or "none")
            + f"; speculative tokens' max dense-logit gap {spec_gap:.4f} (non-speculative {ref_gap:.4f}, tol "
            f"{LOGPROB_TOL}); {8 * n_new / wall:.1f} tok/s ({wall:.2f} s); spec_rounds {st['spec_rounds']}, draft "
            f"tokens {st['spec_draft_tokens']}, accepted {st['spec_accepted_tokens']} "
            f"({st['spec_accepted_tokens'] / max(1, st['spec_draft_tokens']):.1%}), rollback pages "
            f"{st['spec_rollback_pages']}; {dev['spec_s'] / max(1, dev['spec_rounds']) * 1e3:.2f} ms of device "
            f"stream per round; pool audit ok {audit['ok']} (free {audit['free']} + radix {audit['radix_pages']} "
            f"= {audit['total']})")
        if any(max(a, b) > LOGPROB_TOL for _, a, b in parts) or spec_gap > LOGPROB_TOL:
            raise AssertionError(f"[spec] {drafter}: speculative greedy tokens off the model's argmax beyond a near-tie")
        if st["spec_rounds"] <= 0 or st["spec_accepted_tokens"] <= 0:
            raise AssertionError(f"[spec] {drafter}: no speculative rounds or no accepted drafts")
        if not (audit["ok"] and audit["slot_pages"] == 0 and audit["free"] + audit["radix_pages"] == audit["total"]):
            raise AssertionError(f"[spec] {drafter}: pool audit after the wave: {audit}")
        out[drafter] = dict(tok_s=8 * n_new / wall, identical=same, max_gap=spec_gap,
                            rounds=st["spec_rounds"], draft=st["spec_draft_tokens"],
                            accepted=st["spec_accepted_tokens"], rollback_pages=st["spec_rollback_pages"],
                            ms_per_round=dev["spec_s"] / max(1, dev["spec_rounds"]) * 1e3)
    launches = dict(psa.launches)
    if launches["tree"] <= 0 or launches["tree"] % mcfg.num_layers:
        raise AssertionError(f"[spec] kernel #3 tree launches {launches}")
    log(f"[spec] kernel #3 launches: tree {launches['tree']} (= {mcfg.num_layers} layers x "
        f"{launches['tree'] // mcfg.num_layers} verify forwards), chain {launches['chain']}")
    out["launches"] = launches
    del model
    torch.cuda.empty_cache()
    return out


_SNAP_ROWS = 4096  # embedding rows watched


_SNAP_EXPERT = 64  # rows and columns of every expert's matrix watched


def _snapshot(model) -> dict[str, torch.Tensor]:
    """Copies of a few master weights (matrices, a bias or the router, norms,
    the first embedding rows; an MoE layer's experts as the leading
    [64, 64] block of each expert's matrix) to see them move."""
    sd = dict(model.named_parameters())
    last = model.cfg.num_layers - 1
    if model.cfg.num_experts > 0:
        names = ["layers.0.wq", "layers.0.w_router", f"layers.{last}.we_gate", f"layers.{last}.we_down",
                 f"layers.{last}.input_norm", "final_norm"]
    else:
        names = ["layers.0.wq", "layers.0.bq", f"layers.{last}.w_down", f"layers.{last}.input_norm", "final_norm"]
    snap = {n: _watched(sd[n]).clone() for n in names}
    snap["embed"] = sd["embed"][:_SNAP_ROWS].detach().clone()
    return snap


def _watched(p: torch.Tensor) -> torch.Tensor:
    return p.detach()[:, :_SNAP_EXPERT, :_SNAP_EXPERT] if p.dim() == 3 else p.detach()


def _moved(model, snap: dict[str, torch.Tensor]) -> dict[str, float]:
    """Per watched weight, the largest move; for an expert stack the smallest
    of its experts' largest moves (every expert must move)."""
    sd = dict(model.named_parameters())
    out = {}
    for n, t in snap.items():
        d = (_watched(sd[n])[: len(t)] - t).abs()
        out[n] = d.amax(dim=(1, 2)).min().item() if d.dim() == 3 else d.max().item()
    return out


def _rollout(engine, prompts: list[list[int]], n_samples: int, n_new: int):
    """One wave: every prompt ``n_samples`` times, temperature 1.0; returns
    the trajectory dicts built as the RLVR workflow builds them, the reward
    being the share of even token ids among the new tokens."""
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest

    reqs = [p for p in prompts for _ in range(n_samples)]
    out = _run_engine(
        engine,
        [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(max_new_tokens=n_new, temperature=1.0))
         for p in reqs],
        timeout=900,
    )
    trajs = []
    for p, r in zip(reqs, out):
        if len(r.output_tokens) != n_new:
            raise AssertionError(f"[train] incomplete response {len(r.output_tokens)}/{n_new} ({r.stop_reason})")
        n_p, n_o = len(p), len(r.output_tokens)
        trajs.append({
            "input_ids": np.asarray(p + r.output_tokens, np.int32),
            "loss_mask": np.concatenate([np.zeros(n_p, np.float32), np.ones(n_o, np.float32)]),
            "logprobs": np.concatenate([np.zeros(n_p, np.float32), np.asarray(r.output_logprobs, np.float32)]),
            "versions": np.concatenate([np.full(n_p, -1, np.int32), np.asarray(r.output_versions, np.int32)]),
            "rewards": np.float32(np.mean(np.asarray(r.output_tokens) % 2 == 0)),
            "seq_no_eos_mask": np.bool_(r.stop_reason == "length" or bool(r.truncated_by)),
        })
    return trajs


def _clip_set(outputs: dict, b: dict, cfg) -> torch.Tensor:
    """The tokens PPO's clip cuts out of the gradient (``clip_mask`` of
    ``ppo_actor_loss_fn``), from one grid's outputs and data."""
    lm = (b["loss_mask"] > 0) & b["label_valid"]
    ratio = torch.exp(outputs["logprobs"].detach() - b["prox_logprobs"])
    hi = cfg.eps_clip if cfg.eps_clip_higher is None else cfg.eps_clip_higher
    adv = b["advantages"]
    return (-adv * ratio < -adv * ratio.clamp(1.0 - cfg.eps_clip, 1.0 + hi)) & lm


def _logprob_gap(trainer_logp: np.ndarray, batch: dict) -> float:
    """max |trainer - served| logprob over the generated tokens."""
    gen = np.asarray(batch["loss_mask"]) > 0
    return float(np.abs(trainer_logp[gen] - np.asarray(batch["logprobs"])[gen]).max())


def _grpo_run(tag: str, kernels: tuple, model: dict | None = None, name: str = "Qwen2.5-1.5B", gap_check=None,
              **cfg_kw) -> dict:
    """Two asynchronous-GRPO steps of ``model`` (default Qwen2.5-1.5B at
    full width and depth; ``name`` labels it):
    the ``DecodeEngine`` generates 8 prompts x 4 samples (duplicates alias
    the first sample's pages), the ``TorchTrainEngine`` recomputes the
    proximal logprobs, ``PPOActor`` computes advantages and runs
    ``ppo_update``, ``update_weights`` pushes the weights into the running
    engine (the radix tree flushes), and the next wave carries version 1.
    Checks the aliasing, the version tags, the trainer's logprobs against the
    served ones, finite loss and grad norm, LR 0 on the first step and moved
    weights. ``kernels``' launch counts are set to 0 just before and read
    just after, with the engine's forwards in that window (decode steps and
    prefill forwards). ``gap_check(tag, trainer, engine, batch, step)`` holds the
    trainer's logprobs against the served ones (default: ``_logprob_gap``
    within LOGPROB_TOL). ``cfg_kw`` overrides the ``PPOActorConfig``. The
    engine is stopped on return; the trainer, actor and last batch come
    back."""
    from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig, ServerConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.trainer.ppo import PPOActor
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    group, n_prompts, n_new = 4, 8, 128
    mcfg = qwen.ModelConfig(**(model or QWEN25_15B))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg = PPOActorConfig(**{
        **dict(
            dtype="bfloat16",
            param_dtype="float32",
            attn_impl="pallas",
            gradient_checkpointing=True,
            optimizer=OptimizerConfig(lr=1e-5),
            group_size=group,
            # group_size must be given here too: NormConfig's own default (1)
            # takes precedence over PPOActorConfig.group_size, and groups of
            # one would zero every advantage
            adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group),
            use_decoupled_loss=True,
            prox_logp_mode="recompute",
            ppo_n_minibatches=2,
        ),
        **cfg_kw,
    })
    trainer = TorchTrainEngine(cfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=64, train_batch_size=n_prompts), seed=0)
    actor = PPOActor(cfg, trainer)
    engine = DecodeEngine(
        # the prefix-cache settings of ServerConfig(): a wave's duplicate
        # prompts alias the primary's pages; the radix tree flushes at a
        # weight commit
        ServerConfig(max_batch_size=32, max_seq_len=1024, page_size=128, decode_steps_per_call=16, seed=0),
        params=trainer.model.state_dict(),
        model_cfg=mcfg,
    )
    engine.start()
    meta = WeightUpdateMeta(type="mem")
    trainer.connect_engine(engine, meta)
    torch.cuda.synchronize()
    log(f"[{tag}] {name} trainer (f32 master weights, AdamW state) and decode engine "
        f"up in {time.monotonic() - t0:.1f}s; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, n_prompts)]

    # main path: counts to 0 just before, read just after
    fwd_keys = ("decode_steps", "prefill_batches")
    fwd0 = {k: engine.stats[k] for k in fwd_keys}
    for kern in kernels:
        kern.launches = 0
    parts = {"rollout": 0.0, "prox_recompute": 0.0, "ppo_update": 0.0, "weight_update": 0.0}
    r = dict(n_fwd_grids=0, n_mbs=0, trained_tokens=0, stats=[], gaps=[], admissions=[], batches=[],
             ppo_update_s=[])
    snap0, moved = None, None
    try:
        for step in range(2):
            tb = time.monotonic()
            s0 = {k: engine.stats[k] for k in ("prefills", "prefix_shared", "prefix_cache_hits")}
            batch = pad_sequences_to_tensors(_rollout(engine, prompts, group, n_new))
            parts["rollout"] += time.monotonic() - tb
            adm = {k: engine.stats[k] - v for k, v in s0.items()}
            r["admissions"].append(adm)
            log(f"[{tag}] wave {step}: {n_prompts} prompts x {group} samples admitted as {adm['prefills']} "
                f"prefills (radix hits {adm['prefix_cache_hits']}) + {adm['prefix_shared']} samples aliasing "
                f"a duplicate's pages")
            if adm["prefix_shared"] <= 0 or adm["prefills"] + adm["prefix_shared"] != n_prompts * group:
                raise AssertionError(f"[{tag}] wave {step}: duplicate prompts not aliased: {adm}")
            vers = np.asarray(batch["versions"])[np.asarray(batch["loss_mask"]) > 0]
            if not (vers == step).all():
                raise AssertionError(f"[{tag}] wave {step}: token versions {sorted(set(vers.tolist()))} != {{{step}}}")
            tb = time.monotonic()
            batch["prox_logp"] = actor.compute_logp(batch)
            torch.cuda.synchronize()
            parts["prox_recompute"] += time.monotonic() - tb
            r["n_fwd_grids"] += len(trainer._make_grids(batch))
            if gap_check is None:
                r["gaps"].append(_logprob_gap(batch["prox_logp"], batch))
                log(f"[{tag}] wave {step}: {len(vers)} generated tokens, all at version {step}; trainer's "
                    f"recomputed logprobs vs served: max|diff| {r['gaps'][-1]:.4f} (tol {LOGPROB_TOL})")
                if not r["gaps"][-1] <= LOGPROB_TOL:
                    raise AssertionError(f"[{tag}] wave {step}: trainer and server disagree on the policy")
            else:
                r["gaps"].append(gap_check(tag, trainer, engine, batch, step))
            adv = actor.compute_advantages(batch)
            if snap0 is None:
                snap0 = _snapshot(trainer.model)
            tb = time.monotonic()
            stats = actor.ppo_update(adv)
            torch.cuda.synchronize()
            r["ppo_update_s"].append(time.monotonic() - tb)
            parts["ppo_update"] += r["ppo_update_s"][-1]
            r["trained_tokens"] += int(np.asarray(batch["attention_mask"]).sum())
            r["n_mbs"] += int(sum(s["n_microbatches"] for s in stats))
            r["stats"].extend(stats)
            r["batches"].append(batch)
            for i, s in enumerate(stats):
                log(f"[{tag}] step {step} minibatch {i}: loss {s['loss']:.6f} grad_norm {s['grad_norm']:.4f} "
                    f"lr {s['lr']:.2e} actor_loss {s['actor_loss']:.6f} behave_imp_weight "
                    f"{s['behave_imp_weight']:.4f} clip_ratio {s['clip_ratio']:.4f} tokens {s['n_valid_tokens']:.0f}"
                    f" microbatches {s['n_microbatches']:.0f}")
                if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) and s["grad_norm"] > 0):
                    raise AssertionError(f"[{tag}] loss / grad_norm not finite and positive: {s}")
            if step == 0 and stats[0]["lr"] != 0.0:
                raise AssertionError(f"[{tag}] the first optimizer step must have LR 0")
            if len(r["stats"]) >= 2 and not moved:  # the first step with a nonzero LR has run
                moved = _moved(trainer.model, snap0)
                if not all(m > 0 for m in moved.values()):
                    raise AssertionError(f"[{tag}] master weights did not move after the second step: {moved}")
                log(f"[{tag}] master weights moved after the second optimizer step (the first has LR 0): "
                    + ", ".join(f"{n} {m:.2e}" + (" (its least-moved expert)" if snap0[n].dim() == 3 else "")
                                for n, m in moved.items()))
            if step == 0:
                tb = time.monotonic()
                trainer.update_weights(meta)
                trainer.set_version(trainer.get_version() + 1)
                torch.cuda.synchronize()
                parts["weight_update"] += time.monotonic() - tb
                if engine.get_version() != 1 or trainer.get_version() != 1:
                    raise AssertionError(f"[{tag}] versions after the update are not 1")
                held = engine.prefix_cache_stats()["pages_held"]
                if held != 0:
                    raise AssertionError(f"[{tag}] the radix tree holds {held} pages after the weight update")
                log(f"[{tag}] radix tree empty after update_weights (across_updates='flush')")
        r["counts"] = [kern.launches for kern in kernels]
        r["engine_forwards"] = sum(engine.stats[k] - fwd0[k] for k in fwd_keys)
        if not moved:
            raise AssertionError(f"[{tag}] fewer than two optimizer steps")
    finally:
        engine.stop()
    r.update(cfg=cfg, mcfg=mcfg, trainer=trainer, actor=actor, batch=batch, adv=adv, parts=parts)
    return r


def _flash_shares(prof: dict) -> None:
    """Logs K2's, K3's and K4's device time in a profiled step and their
    shares of its busy time."""
    for what, key in (("K2", "flash_fwd_kernel"), ("K3", "flash_bwd_dkv_kernel"), ("K4", "flash_bwd_dq_kernel")):
        us = sum(t for name, t in prof["by_name"].items() if key in name)
        log(f"[profile]   {what} ({key}): {us / 1e3:.2f} ms, {us / prof['busy_us']:.1%} of busy")


def _tree_shares(prof: dict) -> dict[str, float]:
    """Logs #4's, #5's and #6's device time in a profiled step, and their
    shares of its busy time, #5 and #6 together beside them."""
    shares = {}
    for what, key in (("#4", "tree_fwd_kernel"), ("#5", "tree_bwd_dq_kernel"), ("#6", "tree_bwd_dkv_kernel")):
        us = sum(t for name, t in prof["by_name"].items() if key in name)
        shares[what] = us / prof["busy_us"]
        log(f"[profile]   {what} ({key}): {us / 1e3:.2f} ms, {shares[what]:.1%} of busy")
    shares["#5 + #6"] = shares["#5"] + shares["#6"]
    log(f"[profile]   #5 + #6: {shares['#5 + #6']:.1%} of busy")
    return shares


def _wfn(d) -> float:
    return float((np.asarray(d["loss_mask"]) > 0).sum())


def phase_train(card: str) -> dict:
    """The packed path: two minibatches per step through K2 + K3 + K4 under
    per-layer checkpointing; every kernel's launch count; the plain
    attention's grad norm on one minibatch."""
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.utils.data import MicroBatchSpec, split_padded_tensor_dict_into_mb_list

    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    r = _grpo_run("train", kernels)
    cfg, trainer, actor, batch, adv, parts = (r[k] for k in ("cfg", "trainer", "actor", "batch", "adv", "parts"))
    counts, n_fwd_grids, n_mbs = r["counts"], r["n_fwd_grids"], r["n_mbs"]
    L = r["mcfg"].num_layers
    want = [L * n_fwd_grids + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
    log(f"[train] launches: K2 {counts[0]} (= {L} x {n_fwd_grids} forward grids + {2 * L} x {n_mbs} "
        f"microbatches, forward and its recompute), K3 {counts[1]}, K4 {counts[2]} (= {L} x {n_mbs})")
    if counts != want:
        raise AssertionError(f"[train] launch counts {counts} != {want}")

    # one more optimizer step on a minibatch of the last batch, profiled
    mb = split_padded_tensor_dict_into_mb_list(adv, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)).mbs[0]
    _flash_shares(_profile(lambda: trainer.train_batch(mb, actor._loss_fn, _wfn), "optimizer step (one minibatch)",
                           card))
    compute_cfg = trainer.model_cfg

    def by_impl(mb):
        """grad norm, clip_ratio and the clipped tokens of one minibatch
        with the kernels and with the plain attention"""
        res = {}
        for impl in ("pallas", "xla"):
            trainer.model_cfg = dataclasses.replace(compute_cfg, attn_impl=impl)
            trainer.zero_grad()
            clipped = []

            def loss_fn(outputs, b):
                clipped.append(_clip_set(outputs, b, cfg).flatten())
                return actor._loss_fn(outputs, b)

            st = trainer.compute_grads(mb, loss_fn, _wfn)
            res[impl] = (st["grad_norm"], st["clip_ratio"], torch.cat(clipped))
        trainer.model_cfg = compute_cfg
        trainer.zero_grad()
        rel = abs(res["xla"][0] - res["pallas"][0]) / res["pallas"][0]
        flips = int((res["xla"][2] ^ res["pallas"][2]).sum())
        return res, rel, flips

    def norms_line(res, rel, flips) -> str:
        (n_k, c_k, _), (n_p, c_p, _) = res["pallas"], res["xla"]
        return (f"kernels {n_k:.5f} (clip_ratio {c_k:.4f}), plain attention {n_p:.5f} (clip_ratio "
                f"{c_p:.4f}), relative diff {rel:.2e}; {flips} tokens clipped under one and not the other")

    # the same comparison three optimizer steps past the proximal logprobs,
    # where PPO's clip cuts tokens out of the gradient: a token near the
    # clip boundary falls on either side with the two attentions' rounding
    # (a reading, not a check)
    log("[train] grad_norm on one minibatch, proximal logprobs 3 steps old: " + norms_line(*by_impl(mb)))
    # the check: proximal logprobs recomputed at the current weights, so the
    # ratio is ~1 and no token sits at the clip boundary
    batch["prox_logp"] = actor.compute_logp(batch)
    adv = actor.compute_advantages(batch)
    mb = split_padded_tensor_dict_into_mb_list(adv, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)).mbs[0]
    res, rel, flips = by_impl(mb)
    norms = {impl: r_[0] for impl, r_ in res.items()}
    log(f"[train] grad_norm on one minibatch, proximal logprobs recomputed: {norms_line(res, rel, flips)} "
        f"(tol {GRAD_NORM_RTOL})")
    if not rel <= GRAD_NORM_RTOL:
        raise AssertionError("[train] kernel and plain attention gradients disagree")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps, tokens = len(r["stats"]), r["trained_tokens"]
    log(f"[train] {card}: rollout {parts['rollout']:.2f} s (2 waves x 32 x 128 tokens), "
        f"proximal recompute {parts['prox_recompute']:.2f} s, ppo_update {parts['ppo_update']:.2f} s "
        f"({n_steps} optimizer steps), weight update {parts['weight_update']:.3f} s; trainer "
        f"{tokens / parts['ppo_update']:.0f} tokens/s ({tokens} tokens); peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    del trainer, actor, r
    torch.cuda.empty_cache()
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                parts=parts, tokens_per_s=tokens / parts["ppo_update"], peak_gib=peak, norms=norms)


GRPO_CLIENT = dict(max_concurrent_rollouts=16, consumer_batch_size=8, max_head_offpolicyness=1,
                   weight_commit_fence="hold", request_timeout=900)
GRPO_STEPS, GRPO_PROMPTS = 3, 32


def _even_share_reward(prompt, completions, prompt_ids, completion_ids, **kw) -> float:
    """The share of even token ids among the new tokens (a reward that
    varies within a group, so the advantages are not all zero)."""
    return float(np.mean(np.asarray(completion_ids) % 2 == 0))


def phase_grpo(card: str, train: dict | None = None) -> dict:
    """``PPOTrainer.train`` over HTTP against the port's server, three global
    steps of Qwen2.5-1.5B; ``train``: the train phase's result, whose
    in-process trainer tokens/s is printed beside this loop's."""
    import shutil

    from areal_tpu_torch.api.config import (DatasetConfig, InferenceEngineConfig, NormConfig, OptimizerConfig,
                                            PPOActorConfig, PPOConfig, PreemptionConfig, ServerConfig,
                                            TrajectoryJournalConfig)
    from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.infra.staleness_manager import LAG_BUCKET_LABELS
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.observability import lineage
    from areal_tpu_torch.observability.metrics import get_registry
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[grpo] {held:.2f} GiB still allocated by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    group, n_new, batch_prompts = 4, 128, 8
    mcfg = qwen.ModelConfig(**QWEN25_15B)
    L = mcfg.num_layers
    acfg = PPOActorConfig(
        dtype="bfloat16",
        param_dtype="float32",
        attn_impl="pallas",
        gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"),
        group_size=group,
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group),
        use_decoupled_loss=True,
        prox_logp_mode="recompute",
        ppo_n_minibatches=2,
    )
    trainer = TorchTrainEngine(acfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=GRPO_PROMPTS, train_batch_size=batch_prompts),
                       seed=0)
    scfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                        weight_stage_target="device", host="127.0.0.1", seed=0)
    # the server starts from the trainer's weights, cast to bf16
    engine = DecodeEngine(scfg, params=trainer.model.state_dict(), model_cfg=mcfg)
    srv = ServerThread(scfg, engine=engine)
    # server-side records: every hold's answer, every commit
    fences, commits = [], []
    h_pause, h_commit = srv.server.h_pause, srv.server.h_update_commit

    # server-side seconds of each fence leg: the hold's drain, the commit
    fence_s: dict[str, list[float]] = {"hold": [], "commit": []}

    def h_pause_logged(d: dict):
        t = time.monotonic()
        status, out = h_pause(d)
        if d.get("mode") == "hold":
            fences.append(out.get("fenced"))
            fence_s["hold"].append(time.monotonic() - t)
        return status, out

    def h_commit_logged(d: dict):
        t = time.monotonic()
        status, out = h_commit(d)
        fence_s["commit"].append(time.monotonic() - t)
        commits.append(out)
        return status, out

    srv.server.h_pause, srv.server.h_update_commit = h_pause_logged, h_commit_logged
    srv.start()
    client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
    client.initialize()
    gconfig = GenerationHyperparameters(n_samples=group, max_new_tokens=n_new, temperature=1.0)
    shutil.rmtree(GRPO_ROOT, ignore_errors=True)
    jdir = os.path.join(GRPO_ROOT, "journal")
    cfg = PPOConfig(
        experiment_name="chip-smoke",
        trial_name="grpo",
        weight_update_mode="mem",
        total_train_steps=GRPO_STEPS,
        preemption=PreemptionConfig(enabled=False),
        gconfig=gconfig,
        train_dataset=DatasetConfig(batch_size=batch_prompts),
        actor=acfg,
        # the journal as it ships: an fsync per append, on the dispatcher thread
        rollout=InferenceEngineConfig(**GRPO_CLIENT, journal=TrajectoryJournalConfig(enabled=True, dir=jdir)),
    )
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(0, mcfg.vocab_size, int(n)).tolist()}
               for n in rng.integers(64, 513, GRPO_PROMPTS)]
    loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
    torch.cuda.synchronize()
    log(f"[grpo] trainer (f32 master weights, AdamW state), server and client up in "
        f"{time.monotonic() - t_phase:.1f}s; torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # what each step consumed and trained on, recorded around the loop's calls
    batches, gaps, mb_counts, fwd_grids = [], [], [], []
    prepare, compute_logp, train_batch = client.prepare_batch, loop.actor.compute_logp, trainer.train_batch

    def prepare_logged(*a, **k):
        b = prepare(*a, **k)
        batches.append((b, client.get_version()))
        return b

    def compute_logp_logged(b):
        out = compute_logp(b)
        fwd_grids.append(len(trainer._make_grids(b)))
        if len(gaps) == 0:  # the first batch: every token of v0, the trainer at v0
            gaps.append(_logprob_gap(out, b))
        return out

    def train_batch_logged(*a, **k):
        st = train_batch(*a, **k)
        mb_counts.append(int(st["n_microbatches"]))
        return st

    client.prepare_batch, loop.actor.compute_logp, trainer.train_batch = (prepare_logged, compute_logp_logged,
                                                                        train_batch_logged)
    # the journal's appends (timed: pickling, the write and its fsync) and
    # frame bytes, and each minibatch's finalized stats (the lag buckets)
    appends: list[float] = []
    frame_bytes: list[int] = []
    append, append_frame, ppo_update = loop.journal.append_trajectory, loop.journal._append_frame, loop.actor.ppo_update
    mb_stats: list[dict] = []

    def append_timed(*a, **k):
        t = time.monotonic()
        append(*a, **k)
        appends.append(time.monotonic() - t)

    def append_frame_sized(kind, version, task_id, payload):
        if kind == b"T":
            frame_bytes.append(len(payload))
        return append_frame(kind, version, task_id, payload)

    def ppo_update_recorded(data):
        out = ppo_update(data)
        mb_stats.extend(out)
        return out

    loop.journal.append_trajectory, loop.journal._append_frame = append_timed, append_frame_sized
    loop.actor.ppo_update = ppo_update_recorded
    # the staging window's two halves: encoding (the encoder thread: the
    # cast to bf16 on the card and the copy into the body) and posting
    stage_parts: dict[str, float] = {"encode": 0.0, "post": 0.0}
    encode_bucket, post_bytes = client._encode_bucket, client._post_bytes

    def encode_timed(bucket):
        t = time.monotonic()
        body = encode_bucket(bucket)
        stage_parts["encode"] += time.monotonic() - t
        return body

    def post_timed(addr, path, body):
        t = time.monotonic()
        post_bytes(addr, path, body)
        stage_parts["post"] += time.monotonic() - t

    client._encode_bucket, client._post_bytes = encode_timed, post_timed
    # decode progress and the staging windows, sampled (t, decode steps, active slots, staging)
    samples: list[tuple[float, int, int, bool]] = []
    staging = {"on": False}
    h_begin = srv.server.h_update_begin

    def h_begin_logged(d: dict):
        staging["on"] = True
        return h_begin(d)

    def h_commit_marked(d: dict):
        staging["on"] = False
        return h_commit_logged(d)

    srv.server.h_update_begin, srv.server.h_update_commit = h_begin_logged, h_commit_marked
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            samples.append((time.monotonic(), engine.stats["decode_steps"],
                            sum(t is not None for t in engine._slot_task), staging["on"]))
            time.sleep(0.002)

    per_step, checks = [], []
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    commit = loop.stats_logger.commit

    def commit_checked(epoch, step, global_step, stats):
        """After each step: the versions, the served weights against the
        trainer's bf16 export, and this step's launches."""
        want = global_step + 1
        with urllib.request.urlopen(f"http://{srv.address}/health", timeout=10) as r:
            served_v = json.loads(r.read())["version"]
        versions = (served_v, client.get_version(), trainer.get_version())
        served = dict(engine.model.named_parameters())
        unequal = [n for n, p in trainer.model.named_parameters()
                   if not torch.equal(p.detach().to(torch.bfloat16), served[n].detach())]
        counts = [k.launches for k in kernels]
        checks.append((versions, unequal))
        per_step.append(dict(stats=dict(stats), counts=counts, fwd=fwd_grids[-1], mbs=sum(mb_counts[-2:])))
        if versions != (want, want, want) or unequal:
            raise AssertionError(f"[grpo] step {global_step}: versions (server, client, trainer) {versions}, want "
                                 f"{want}; {len(unequal)} served parameters differ from the trainer's bf16 export "
                                 f"(first {unequal[:3]})")
        commit(epoch, step, global_step, stats)

    loop.stats_logger.commit = commit_checked
    s0 = {k: engine.stats[k] for k in ("decode_steps", "aborted", "suffix_prefill_batches", "generated_tokens")}
    bytes0 = client._metrics.update_bytes.get()
    try:
        # main path: counts to 0 just before, read just after
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        for k in psa.launches:
            psa.launches[k] = 0
        sampler = threading.Thread(target=sample, name="grpo-sampler", daemon=True)
        sampler.start()
        t0 = time.monotonic()
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        wall = time.monotonic() - t0
        # drain: no new submissions, the episodes in flight finish
        client.pause()
        deadline = time.monotonic() + 600
        while client.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
        while any(t is not None for t in engine._slot_task) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        counts = [k.launches for k in kernels]
        launches1, launches3 = paged_attention_stacked.launches, dict(psa.launches)
        d = {k: engine.stats[k] - v for k, v in s0.items()}
        stop.set()
        sampler.join(timeout=10)
        staged_bytes = client._metrics.update_bytes.get() - bytes0
        prom = get_registry().render_prometheus()
    finally:
        stop.set()
        loop.close()
        srv.stop()
    seg_bytes = _dir_bytes(jdir)
    n_appended = loop.journal.stats()["appended"]
    shutil.rmtree(GRPO_ROOT, ignore_errors=True)

    # checks
    if len(per_step) != GRPO_STEPS or len(commits) != GRPO_STEPS:
        raise AssertionError(f"[grpo] {len(per_step)} steps and {len(commits)} commits, want {GRPO_STEPS} each")
    if d["aborted"] != 0:
        raise AssertionError(f"[grpo] {d['aborted']} requests ended with 'abort' under the hold fence")
    if len(fences) != GRPO_STEPS or not all(fences):
        raise AssertionError(f"[grpo] hold answers {fences}: want {GRPO_STEPS} x fenced")
    n_rows = GRPO_CLIENT["consumer_batch_size"] * group
    spans = []
    for i, (b, v) in enumerate(batches):
        _check_rollout_rows(b, n_rows, n_new, f"grpo batch {i}")
        gen = b["loss_mask"] > 0
        lo = int(b["versions"][gen].min())
        if v - lo > GRPO_CLIENT["max_head_offpolicyness"]:
            raise AssertionError(f"[grpo] batch {i} consumed at v{v} holds tokens of v{lo}")
        spans.append(sum(int(b["versions"][j][gen[j]].min() != b["versions"][j][gen[j]].max())
                         for j in range(n_rows)))
    if not gaps[0] <= LOGPROB_TOL:
        raise AssertionError(f"[grpo] the trainer's logprobs vs the served ones on batch 0: {gaps[0]:.4f}")
    # the lineage: every consumed trajectory journaled, consumed and trained
    # at the version of its step
    ring, n_traj = lineage.get_lineage(), 0
    for i, (b, v) in enumerate(batches):
        for lid in dict.fromkeys(np.asarray(b["lineage_id"]).tolist()):
            rec, n_traj = ring.get(int(lid)), n_traj + 1
            if rec is None or not rec.journaled or rec.consumed_version != v or rec.trained_version != v or (
                    rec.consumed_ts is None or rec.trained_ts is None or rec.clip_fraction is None):
                raise AssertionError(f"[grpo] batch {i}: the lineage record of {lid}: {rec}")
    # the lag buckets recompose the batch-wide clip ratio, minibatch by minibatch
    errs = {"clip_ratio": 0.0, "approx_kl": 0.0}
    for s in mb_stats:
        for key in errs:
            errs[key] = max(errs[key], abs(sum(s[f"lag_{b}/token_share"] * s[f"lag_{b}/{key}"]
                                               for b in LAG_BUCKET_LABELS) - s[key]))
    if len(mb_stats) != 2 * GRPO_STEPS or errs["clip_ratio"] > 1e-6:
        raise AssertionError(f"[grpo] {len(mb_stats)} minibatch stats; the lag buckets recompose clip_ratio within "
                             f"{errs['clip_ratio']:.3g} (limit 1e-6)")
    missing = [m for m in ("areal_train_lag_clip_ratio{", "areal_train_lag_tokens_total{",
                           "areal_train_lag_behave_kl{", "areal_lineage_records_total",
                           "areal_lineage_joined_total") if m not in prom]
    if missing or len(appends) != n_appended or not appends:
        raise AssertionError(f"[grpo] the trainer's /metrics text lacks {missing}; {len(appends)} timed appends of "
                             f"{n_appended}")
    for st in per_step:
        s = st["stats"]
        if not (math.isfinite(s["ppo_actor/loss"]) and math.isfinite(s["ppo_actor/grad_norm"])):
            raise AssertionError(f"[grpo] loss / grad_norm not finite: {s}")
    n_fwd, n_mbs = sum(fwd_grids), sum(mb_counts)
    want = [L * n_fwd + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
    if counts != want:
        raise AssertionError(f"[grpo] K2 / K3 / K4 launches {counts} != {want} ({n_fwd} forward grids, {n_mbs} "
                             "microbatches)")
    steps = d["decode_steps"]
    if steps == 0 or launches1 != L * steps:
        raise AssertionError(f"[grpo] #1 launches {launches1} != {L} layers x {steps} decode steps")
    n3 = sum(launches3.values())
    if n3 != L * d["suffix_prefill_batches"]:
        raise AssertionError(f"[grpo] #3 launches {launches3} != {L} layers x {d['suffix_prefill_batches']} warm "
                             "batches")

    # the prints
    prev = [0, 0, 0]
    for i, st in enumerate(per_step):
        s = st["stats"]
        step_counts = [c - p for c, p in zip(st["counts"], prev)]
        prev = st["counts"]
        log(f"[grpo] {card}: step {i}: {s['step_secs']:.2f} s; rollout_wait {s['phase/rollout_wait_s']:.2f} s, "
            f"host_prep {s['phase/host_prep_s']:.2f} s, ppo_update {s['timing/train_step']:.2f} s, weight_publish "
            f"{s['phase/weight_publish_s']:.2f} s (stage {s['update_weights_stage_secs']:.2f} s with generation "
            f"running, commit fence {s['update_weights_pause_secs'] * 1e3:.1f} ms); "
            f"{s['generation_tokens_during_update']:.0f} tokens generated during the update; {spans[i]} of {n_rows} "
            f"rows span a commit; K2 / K3 / K4 launches {step_counts} ({st['fwd']} forward grids, {st['mbs']} "
            f"microbatches); loss {s['ppo_actor/loss']:.6f} grad_norm {s['ppo_actor/grad_norm']:.4f}")
    per_update = staged_bytes / GRPO_STEPS
    stage_s = [st["stats"]["update_weights_stage_secs"] for st in per_step]
    log(f"[grpo] {card}: {per_update / 1e9:.3f} GB of bf16 staged per update in {len(commits)} commits, staging "
        + ", ".join(f"{per_update / t / 1e9:.2f}" for t in stage_s) + " GB/s; over the 3 updates the encoder "
        f"thread took {stage_parts['encode']:.2f} s and the bucket posts {stage_parts['post']:.2f} s (overlapped) "
        f"of {sum(stage_s):.2f} s staging; on the server, each hold's drain "
        + ", ".join(f"{t * 1e3:.1f}" for t in fence_s["hold"]) + " ms and each commit "
        + ", ".join(f"{t * 1e3:.1f}" for t in fence_s["commit"]) + " ms")

    def ms_per_step(on: bool) -> tuple[float, int]:
        """Decode wall ms a step over the sampled intervals with slots active,
        inside (on) or outside the staging windows."""
        dt = ds = 0
        for (ta, sa, aa, ga), (tb, sb, _, gb) in zip(samples, samples[1:]):
            if aa and ga == on and gb == on:
                dt += tb - ta
                ds += sb - sa
        return (dt / ds * 1e3 if ds else float("nan")), ds

    (ms_on, n_on), (ms_off, n_off) = ms_per_step(True), ms_per_step(False)
    log(f"[grpo] {card}: decode step wall {ms_on:.2f} ms while staging ({n_on} steps) vs {ms_off:.2f} ms outside "
        f"({n_off} steps); #1 launches {launches1} = {L} x {steps} decode steps; #3 launches {launches3} = {L} x "
        f"{d['suffix_prefill_batches']} warm batches; holds answered {fences}; no request aborted")
    tokens = sum(int(np.asarray(b["attention_mask"]).sum()) for b, _ in batches)
    ppo_s = sum(st["stats"]["timing/train_step"] for st in per_step)
    warm_tokens = sum(int(np.asarray(b["attention_mask"]).sum()) for b, _ in batches[1:])
    warm_s = sum(st["stats"]["timing/train_step"] for st in per_step[1:])
    beside = f"{train['tokens_per_s']:.0f} tokens/s in process (train phase)" if train else "train phase not run"
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[grpo] {card}: trainer {tokens / ppo_s:.0f} tokens/s over HTTP ({tokens} tokens in {ppo_s:.2f} s of "
        f"ppo_update; {warm_tokens / warm_s:.0f} tokens/s over steps 1-2, the first step carrying the process's "
        f"one-time cost when it trains first) vs {beside}; the trainer's logprobs vs the served ones on batch 0: "
        f"max|diff| {gaps[0]:.4f} "
        f"(tol {LOGPROB_TOL}); batches consumed at versions {[v for _, v in batches]}; the loop {wall:.1f} s; "
        f"peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    ms = np.asarray(appends) * 1e3
    share = {b: np.mean([s[f"lag_{b}/token_share"] for s in mb_stats]) for b in LAG_BUCKET_LABELS}
    log(f"[grpo] {card}: the journal (fsync on): {n_appended} appends, p50 {np.percentile(ms, 50):.2f} ms, p95 "
        f"{np.percentile(ms, 95):.2f} ms, max {ms.max():.2f} ms (on the dispatcher thread); "
        f"{np.mean(frame_bytes) / 1e3:.1f} kB a trajectory's frame, {seg_bytes / 1e6:.2f} MB of segments; "
        f"{n_traj} consumed trajectories' lineage records carry journal, consume and train stamps; the lag buckets "
        f"recompose clip_ratio within {errs['clip_ratio']:.2e} and approx_kl within {errs['approx_kl']:.2e} over "
        f"{len(mb_stats)} minibatches (token shares " + ", ".join(f"{b}: {share[b]:.3f}" for b in LAG_BUCKET_LABELS)
        + "); areal_train_lag_* and areal_lineage_* in the trainer's /metrics text")
    log(f"[grpo] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    del loop, trainer, engine, srv
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                launches1=launches1, launches3=n3, steps=steps, stage_s=stage_s, per_update_bytes=per_update,
                peak_gib=peak, tokens_per_s=tokens / ppo_s, warm_tokens_per_s=warm_tokens / warm_s,
                append_ms_p50=float(np.percentile(ms, 50)), append_ms_p95=float(np.percentile(ms, 95)),
                frame_bytes=float(np.mean(frame_bytes)), lag_identity_err=errs["clip_ratio"])


# the keys of an accepted trajectory the durable phase holds its replay to
JOURNAL_KEYS = ("input_ids", "logprobs", "versions", "rewards")
# the durable phase writes here (git-ignored) and deletes it at its end
DURABLE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_durable")
# the grpo phase's journal (git-ignored), deleted at its end
GRPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_grpo")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _train_tensors(engine) -> dict:
    """A train engine's parameters, AdamW moments and step count by name
    (the live tensors)."""
    out = {f"params/{n}": p.detach() for n, p in engine.model.named_parameters()}
    for n, m, v in zip(dict(engine.model.named_parameters()), engine._opt.mu, engine._opt.nu):
        out[f"mu/{n}"], out[f"nu/{n}"] = m, v
    out["count"] = torch.tensor(engine._opt.count)
    return out


def _train_state(engine, device: str | None = None) -> dict:
    """A copy of ``_train_tensors`` (on ``device``, else where they live)."""
    return {k: t.to(device, copy=True) if device else t.clone() for k, t in _train_tensors(engine).items()}


def _unequal_state(engine, want: dict) -> list[str]:
    """Names whose tensors differ from ``want``'s in any bit (compared one
    tensor at a time on ``want``'s device)."""
    got = _train_tensors(engine)
    return [k for k, w in want.items() if not torch.equal(got[k].to(w.device), w)]


def _served_unequal(engine, trainer) -> list[str]:
    """Served parameters that are not the trainer's master weights rounded
    to bf16 once, bit for bit."""
    served = dict(engine.model.named_parameters())
    return [n for n, p in trainer.model.named_parameters()
            if not torch.equal(p.detach().to(torch.bfloat16), served[n].detach())]


def _race_check(trainer, batch, loss_fn, planted: bool) -> dict:
    """One optimizer step of ``trainer`` with a snapshot taken between its
    gradients and its update, whose copies queue behind ~0.5 s of spinning
    on their side stream: the snapshot must hold the state before the step
    bit for bit. ``planted`` takes the step's stream wait out (the
    fault the check must catch). Returns the tensors that differ and what
    decides the race: the host seconds from the snapshot's return to the
    step's first launch and of the step's launches, the device order of
    the step and the copies (CUDA events: the step's start after the
    copies' start and after their end, ms), and the caching allocator's
    retries / cudaMalloc / cudaFree calls during the step."""
    cuda = trainer.device.type == "cuda"
    compute, opt_step = trainer._compute_grads, trainer._opt.step
    seen: dict = {}

    def event(stream=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def grads_then_snapshot(*a, **k):
        out = compute(*a, **k)
        seen["ref"] = _train_state(trainer, "cpu")  # what the step is about to update
        if cuda:
            with torch.cuda.stream(trainer._save_stream):
                torch.cuda._sleep(1_000_000_000)  # clock cycles, ~0.5 s
                seen["e_copy0"] = event(trainer._save_stream)
        t = time.monotonic()
        seen["snap"] = trainer.snapshot_for_save(with_optim=True)
        seen["t_snap"] = time.monotonic()
        seen["s"] = seen["t_snap"] - t
        if cuda:
            seen["e_copy1"] = event(trainer._save_stream)
            seen["mem0"] = torch.cuda.memory_stats(trainer.device)
        return out

    def step_timed(*a, **k):
        t = time.monotonic()
        if cuda:
            seen["e_step0"] = event()
        out = opt_step(*a, **k)
        if cuda:
            seen["e_step1"] = event()
            seen["mem1"] = torch.cuda.memory_stats(trainer.device)
        seen["launch_after_snap_s"], seen["launch_s"] = t - seen["t_snap"], time.monotonic() - t
        return out

    trainer._compute_grads, trainer._opt.step = grads_then_snapshot, step_timed
    if planted:
        trainer._order_after_snapshot = lambda: None
    try:
        trainer.train_batch(batch, loss_fn, _wfn)
    finally:
        del trainer._compute_grads, trainer._opt.step
        if planted:
            del trainer._order_after_snapshot
    snap, ref = seen["snap"], seen["ref"]
    if snap["event"] is not None:
        snap["event"].synchronize()
    got = {f"{g}/{n}": t for g, ts in snap["groups"].items() for n, t in ts.items()}
    got["count"] = torch.tensor(snap["step_count"])
    out = dict(unequal=[k for k, w in ref.items() if not torch.equal(got[k], w)], n=len(ref), snap_s=seen["s"],
               launch_after_snap_s=seen["launch_after_snap_s"], launch_s=seen["launch_s"])
    trainer._snap_free.set()
    if cuda:
        torch.cuda.synchronize()
        c0, c1, s0, s1 = seen["e_copy0"], seen["e_copy1"], seen["e_step0"], seen["e_step1"]
        out.update(copies_ms=c0.elapsed_time(c1), step_ms=s0.elapsed_time(s1),
                   step_after_copy_start_ms=c0.elapsed_time(s0), step_after_copy_end_ms=c1.elapsed_time(s0))
        out.update({k: seen["mem1"].get(k, 0) - seen["mem0"].get(k, 0)
                    for k in ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")})
    return out


def _race_line(r: dict) -> str:
    s = (f"{len(r['unequal'])} of {r['n']} tensors differ; the step's first launch {r['launch_after_snap_s'] * 1e3:.1f}"
         f" ms after the snapshot returned, its launches {r['launch_s'] * 1e3:.1f} ms")
    if "copies_ms" in r:
        s += (f"; on the device the copies {r['copies_ms']:.1f} ms, the step {r['step_ms']:.1f} ms, starting "
              f"{r['step_after_copy_start_ms']:.1f} ms after the copies' start and {r['step_after_copy_end_ms']:.1f} "
              f"ms after their end; allocator retries {r['num_alloc_retries']}, cudaMalloc {r['num_device_alloc']}, "
              f"cudaFree {r['num_device_free']}")
    return s


def phase_durable(card: str) -> dict:
    """The trainer's durable state at Qwen2.5-1.5B, full width and
    ``CUT_LAYERS`` of its depth, over HTTP: (a) two optimizer steps, each right after a snapshot taken
    between its gradients and its update, which must hold the state before
    the step bit for bit (the first with its stream wait taken out, a
    planted fault that must show; ``_race_check``); an HF export of the
    trainer's weights (GB, s, GB/s); (b) a server started from it by
    ``ServerConfig.model_path`` serving the trainer's bf16 weights bit for
    bit, and a wave of 16 (#1 launches); the race check again while the
    server decodes; (c) a disk weight update
    (``RemoteTorchEngine.update_weights(type="disk")``) under the hold
    fence while a wave decodes, after two more optimizer steps, bit for bit
    again; (d) a ``PPOTrainer`` with ``recover.mode="auto"``,
    ``freq_steps=1``, two steps with async dumps (the step loop's pause per
    dump, the write's GB/s and bytes), and a sync save of the same state
    beside them (its pause); (e) a preemption requested during step 3: the
    emergency dump of step 2, already durable from its async dump,
    rewrites only its record, the trajectory journal (on, fsynced, with
    trajectory dumps) is sealed and the lineage ring dumped; then a fresh
    trainer resumes at step 3 with the dumped parameters, moments and step
    count bit for bit, replays exactly the accepted trajectories no
    checkpointed step consumed (bit for bit by task id, none dropped), and
    its first step trains on them (K2-K4 launches); (f) the resumed actor's offload /
    onload (GB freed, seconds, bit for bit after). The phase's directories
    go at its end."""
    import shutil
    import signal

    from areal_tpu_torch.api.config import (DatasetConfig, InferenceEngineConfig, NormConfig, OptimizerConfig,
                                            PPOActorConfig, PPOConfig, PreemptionConfig, RecoverConfig, SaverConfig,
                                            ServerConfig, StatsLoggerConfig, TrajectoryJournalConfig)
    from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, SaveLoadMeta, WeightUpdateMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.infra.trajectory_journal import default_journal_dir
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[durable] {held:.2f} GiB still allocated by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    shutil.rmtree(DURABLE_ROOT, ignore_errors=True)
    os.makedirs(DURABLE_ROOT)
    du = shutil.disk_usage(DURABLE_ROOT)
    log(f"[durable] {card}: (a) disk at {DURABLE_ROOT}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB")
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    group, n_new, batch_prompts = 4, 128, 8
    acfg = PPOActorConfig(
        dtype="bfloat16",
        param_dtype="float32",
        attn_impl="pallas",
        gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"),
        group_size=group,
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group),
        use_decoupled_loss=True,
        prox_logp_mode="recompute",
        ppo_n_minibatches=2,
    )
    ft = FinetuneSpec(total_train_epochs=1, dataset_size=GRPO_PROMPTS, train_batch_size=batch_prompts)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    srv = client = loop = None
    res: dict = {}
    try:
        trainer = TorchTrainEngine(acfg, model_config=mcfg)
        trainer.initialize(ft, seed=0)

        # a batch of random tokens: 16 rows of 64-512 prompt + 128 completion
        race_rng = np.random.default_rng(1)
        race_batch = pad_sequences_to_tensors([
            {"input_ids": race_rng.integers(0, mcfg.vocab_size, int(n) + n_new).astype(np.int32),
             "loss_mask": np.r_[np.zeros(int(n)), np.ones(n_new)].astype(np.float32)}
            for n in race_rng.integers(64, 513, 16)])

        def nll(outputs, b):
            m = (b["label_valid"] & (b["loss_mask"] > 0)).float()
            return -(outputs["logprobs"] * m).sum() / m.sum().clamp(min=1), {}

        # the snapshot / optimizer-step race: two steps, each with a snapshot
        # taken between its gradients and its optimizer step, whose in-place
        # updates must wait for the snapshot's copies (a side stream): the
        # first with that wait taken out (a planted fault, which must show),
        # the second as it ships. Here the trainer is alone on the card; the
        # same check runs beside the server's decoding below. A first
        # snapshot, not checked, pins the buffers
        t0 = time.monotonic()
        snap = trainer.snapshot_for_save(with_optim=True)
        pin_s = time.monotonic() - t0
        trainer.wait_for_save()
        trainer._snap_free.set()  # not written: its buffers are free again
        del snap
        races = {}
        for planted in (True, False):
            races[planted] = _race_check(trainer, race_batch, nll, planted)
            log(f"[durable] {card}: (a) race, trainer alone, {'planted (no stream wait)' if planted else 'shipped'}: "
                + _race_line(races[planted]))
        if races[False]["unequal"] or not races[True]["unequal"]:
            raise AssertionError(f"[durable] alone: a snapshot taken right before an optimizer step differs from the "
                                 f"state before it in {len(races[False]['unequal'])} tensors; with the step's stream "
                                 f"wait taken out {len(races[True]['unequal'])} differ (a planted fault the check "
                                 "must catch)")
        log(f"[durable] {card}: (a) a snapshot between a step's gradients and its optimizer step holds the state "
            f"before the step bit for bit ({races[False]['n']} tensors; the snapshot call "
            f"{races[False]['snap_s'] * 1e3:.1f} ms, a first unchecked one {pin_s:.2f} s pinning the host buffers); "
            f"with the step's stream wait taken out (planted) {len(races[True]['unequal'])} tensors differ: caught")
        res["snapshot"] = dict(planted_unequal=len(races[True]["unequal"]), pin_s=pin_s, snap_s=races[False]["snap_s"])

        # (a) the HF export
        export = os.path.join(DURABLE_ROOT, "export")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer.save(SaveLoadMeta(path=export, weight_format="hf"))
        export_s = time.monotonic() - t0
        gb = os.path.getsize(os.path.join(export, "model.safetensors")) / 1e9
        res["export"] = dict(gb=gb, s=export_s, gbps=gb / export_s)
        log(f"[durable] {card}: (a) HF export of the trainer's f32 weights: {gb:.3f} GB in {export_s:.2f} s, "
            f"{gb / export_s:.2f} GB/s (write to the page cache, no fsync)")

        # (b) a server from the export by model_path
        scfg = ServerConfig(model_path=export, dtype="bfloat16", max_batch_size=32, max_seq_len=2048, page_size=128,
                            decode_steps_per_call=16, weight_stage_target="device", host="127.0.0.1", seed=0)
        engine = DecodeEngine(scfg)
        srv = ServerThread(scfg, engine=engine)
        holds: list = []
        h_pause = srv.server.h_pause

        def h_pause_logged(d: dict):
            status, out = h_pause(d)
            holds.append((d.get("mode"), out.get("fenced")))
            return status, out

        srv.server.h_pause = h_pause_logged
        t0 = time.monotonic()
        srv.start()
        load_s = time.monotonic() - t0
        unequal = _served_unequal(engine, trainer)
        if unequal:
            raise AssertionError(f"[durable] (b) {len(unequal)} parameters served from the export differ from the "
                                 f"trainer's bf16 weights (first {unequal[:3]})")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 16)]
        bodies = [{"input_ids": p, "sampling_params": {"max_new_tokens": n_new, "greedy": True}} for p in prompts]
        paged_attention_stacked.launches = 0  # main path: counts to 0 just before, read just after
        steps0 = engine.stats["decode_steps"]
        resps = _wave(srv.address, bodies)
        launches1 = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - steps0
        for r in resps:
            _check_response(r, n_new, "durable")
        if steps == 0 or launches1 != L * steps:
            raise AssertionError(f"[durable] (b) #1 launches {launches1} != {L} layers x {steps} decode steps")
        log(f"[durable] {card}: (b) server from the export by model_path: up in {load_s:.2f} s (the load and the "
            f"engine's start), every served parameter equals the trainer's bf16 weights bit for bit; a wave of 16 x "
            f"{n_new} tokens: #1 launches {launches1} = {L} x {steps} decode steps")
        res["launches1"] = launches1

        # (b) the race again beside the server, while it decodes waves of 16
        # all along (its decode loop runs in this process, on its own thread)
        races = {}
        stop_waves = threading.Event()
        wave_errs: list = []

        def keep_decoding():
            try:
                while not stop_waves.is_set():
                    for r in _wave(srv.address, bodies):
                        _check_response(r, n_new, "durable")
            except Exception as e:  # noqa: BLE001 — raised below
                wave_errs.append(e)

        decoder = threading.Thread(target=keep_decoding, name="durable-waves", daemon=True)
        s_before = engine.stats["decode_steps"]
        decoder.start()
        try:
            for planted in (True, False):
                while engine.stats["decode_steps"] < s_before + 4 and decoder.is_alive():
                    time.sleep(0.005)
                s0 = engine.stats["decode_steps"]
                name = "planted (no stream wait)" if planted else "shipped"
                races[name] = _race_check(trainer, race_batch, nll, planted)
                races[name]["decode_steps"] = engine.stats["decode_steps"] - s0
                s_before = engine.stats["decode_steps"]
        finally:
            stop_waves.set()
            decoder.join(timeout=900)
        if wave_errs:
            raise wave_errs[0]
        for name, r in races.items():
            log(f"[durable] {card}: (b) race beside the server decoding, {name}: {_race_line(r)}; "
                f"{r['decode_steps']} decode steps ran during the check")
        planted_bad, bad = (races[k]["unequal"] for k in ("planted (no stream wait)", "shipped"))
        if bad or not planted_bad:
            raise AssertionError(f"[durable] beside the server: the shipped step's snapshot differs in {len(bad)} "
                                 f"tensors; the planted one's in {len(planted_bad)} (a fault the check must catch)")
        res["snapshot"]["beside_planted_unequal"] = len(planted_bad)

        # (c) two more optimizer steps on the wave's sequences, then the disk
        # update under the hold fence while a wave decodes
        trajs = [{"input_ids": np.asarray(p + r["output_tokens"], np.int32),
                  "loss_mask": np.r_[np.zeros(len(p)), np.ones(n_new)].astype(np.float32)}
                 for p, r in zip(prompts, resps)]
        sft = pad_sequences_to_tensors(trajs)
        for _ in range(2):
            trainer.train_batch(sft, nll, _wfn)
        dump_dir = os.path.join(DURABLE_ROOT, "trial", "dumps")
        client_cfg = InferenceEngineConfig(**GRPO_CLIENT, dump_trajectories=True, dump_dir=dump_dir)
        client = RemoteTorchEngine(client_cfg, addresses=[srv.address])
        client.initialize()
        meta = WeightUpdateMeta(type="disk", path=os.path.join(DURABLE_ROOT, "update_weights"), with_version=True)
        trainer.connect_engine(client, meta)
        box: list = []
        waver = threading.Thread(target=lambda: box.extend(_wave(srv.address, bodies)))
        a0 = engine.stats["aborted"]
        s_before = engine.stats["decode_steps"]
        waver.start()
        while engine.stats["decode_steps"] == s_before and waver.is_alive():
            time.sleep(0.005)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer.update_weights(meta)
        update_s = time.monotonic() - t0
        fence_s = client.last_pause_secs
        waver.join(timeout=600)
        version = engine.get_version()
        unequal = _served_unequal(engine, trainer)
        if unequal or version != 1 or holds != [("hold", True)] or engine.stats["aborted"] != a0 or len(box) != 16:
            raise AssertionError(f"[durable] (c) disk update: version {version} (want 1), holds {holds}, "
                                 f"{engine.stats['aborted'] - a0} aborted, {len(box)} of 16 responses, "
                                 f"{len(unequal)} served parameters unequal to the trainer's bf16 weights")
        spanning = sum(1 for r in box if len(set(r["output_versions"])) > 1)
        res["update"] = dict(s=update_s, fence_s=fence_s)
        log(f"[durable] {card}: (c) disk update after two more optimizer steps: {update_s:.2f} s in all (the export, "
            f"then the reload), of which the hold fence {fence_s:.2f} s (the reload; the decode loop waits); "
            f"version {version}; every served parameter equals the trainer's bf16 weights bit for bit; a wave of 16 "
            f"decoding through it: none aborted, {spanning} responses span the update")
        shutil.rmtree(export)
        shutil.rmtree(meta.path)

        # (d) PPOTrainer with recover auto, async dumps every step, the
        # trajectory journal (fsynced appends) and trajectory dumps
        root = os.path.join(DURABLE_ROOT, "trial")
        gconfig = GenerationHyperparameters(n_samples=group, max_new_tokens=n_new, temperature=1.0)
        flight_env = os.environ.get("AREAL_FLIGHT_DIR")
        os.environ["AREAL_FLIGHT_DIR"] = os.path.join(root, "flight")
        rollout_cfg = dataclasses.replace(client_cfg, journal=TrajectoryJournalConfig(enabled=True))

        def ppo_cfg(total_steps):
            cfg = PPOConfig(
                experiment_name="chip-smoke", trial_name="durable", weight_update_mode="mem",
                total_train_steps=total_steps, gconfig=gconfig, train_dataset=DatasetConfig(batch_size=batch_prompts),
                actor=acfg, preemption=PreemptionConfig(grace_s=120.0), rollout=rollout_cfg,
                saver=SaverConfig(fileroot=root), checkpointer=SaverConfig(fileroot=root),
                recover=RecoverConfig(mode="auto", freq_steps=1, fileroot=root),
                stats_logger=StatsLoggerConfig(fileroot=root),
            )
            cfg.cluster.fileroot = root
            return cfg

        jdir = default_journal_dir(root, "chip-smoke", "durable")
        dataset = [{"prompt_ids": rng.integers(0, mcfg.vocab_size, int(n)).tolist()}
                   for n in rng.integers(64, 513, GRPO_PROMPTS)]
        client.set_version(0)  # the server's too
        trainer.set_version(0)
        loop = PPOTrainer(ppo_cfg(4), dataset, rollout=client, actor_engine=trainer)
        saver = loop.recover_handler.saver
        dumps: list = []  # (kind, step-loop pause s, bytes, write s)
        save_async, snap, write = saver.save_async, trainer.snapshot_for_save, trainer.write_snapshot
        writes: list = []

        def save_async_timed(*a, **k):
            t = time.monotonic()
            out = save_async(*a, **k)
            dumps.append(("async", time.monotonic() - t))
            return out

        def write_timed(snapshot, path):
            t = time.monotonic()
            n = write(snapshot, path)
            writes.append((n, time.monotonic() - t))
            return n

        saver.save_async, trainer.write_snapshot = save_async_timed, write_timed
        # what the executor accepted (as journaled) and what the steps consumed
        accepted: dict = {}
        consumed: list = []  # (version, task ids)
        journal_append, mark_consumed = client.executor._journal_append, client.executor._mark_consumed

        def journal_append_recorded(traj, task_id, *a, **k):
            accepted[task_id] = {k2: np.array(traj[k2], copy=True) for k2 in JOURNAL_KEYS}
            return journal_append(traj, task_id, *a, **k)

        def mark_consumed_recorded(task_ids):
            consumed.append((client.get_version(), list(task_ids)))
            return mark_consumed(task_ids)

        client.executor._journal_append, client.executor._mark_consumed = journal_append_recorded, mark_consumed_recorded
        seal, sealed = loop.journal.seal_active, []

        def seal_listed():
            seal()
            sealed.append(sorted(os.listdir(jdir)))

        loop.journal.seal_active = seal_listed
        emergency = loop.recover_handler.dump_emergency
        at_dump: dict = {}

        def dump_recorded(eng, step_info, **kw):
            # the state at the dump, kept in host memory: the relaunch's
            # trainer needs the card's room
            at_dump["state"], at_dump["step"] = _train_state(eng, "cpu"), step_info.global_step
            t = time.monotonic()
            saver.wait_async()  # the dump's own first wait, timed apart: a write still in flight
            at_dump["wait_s"] = time.monotonic() - t
            t = time.monotonic()
            out = emergency(eng, step_info, **kw)
            at_dump["s"] = time.monotonic() - t
            at_dump["bytes"] = _dir_bytes(os.path.join(out, "state"))
            return out

        loop.recover_handler.dump_emergency = dump_recorded
        prepare = client.prepare_batch
        calls = {"n": 0}

        def prepare_preempting(*a, **k):
            calls["n"] += 1
            if calls["n"] == 3:  # step 3: the signal lands as its rollout wait begins
                loop.preemption.request(signal.SIGTERM)
            return prepare(*a, **k)

        client.prepare_batch = prepare_preempting
        committed: list = []
        commit = loop.stats_logger.commit
        loop.stats_logger.commit = lambda e, s, g, st: (committed.append(g), commit(e, s, g, st))
        t0 = time.monotonic()
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        loop_s = time.monotonic() - t0
        saver.wait_async()
        # the two async dumps' writes; the emergency dump of step 1 (step 2
        # counted from 1), already durable, writes none
        if not loop.preempted or committed != [0, 1] or at_dump.get("step") != 1 or len(writes) != 2:
            raise AssertionError(f"[durable] (d/e) preempted {loop.preempted}, steps committed {committed}, the "
                                 f"emergency dump of step {at_dump.get('step')} (want 1), {len(writes)} writes "
                                 "(want the 2 async ones)")
        lineage_dumps = [n for n in os.listdir(os.environ["AREAL_FLIGHT_DIR"]) if n.endswith("_preempt.json")]
        if len(sealed) != 1 or any(n.endswith(".open") for n in sealed[0]) or not lineage_dumps:
            raise AssertionError(f"[durable] (e) the preemption's seal left {sealed} in the journal; lineage dumps "
                                 f"{lineage_dumps}")
        saver.save_async, trainer.write_snapshot = save_async, write
        # step 0's generation is only the fallback now (.prev): its room
        # goes to the sync save
        shutil.rmtree(os.path.join(root, "chip-smoke", "durable", "recover", "epoch0epochstep0globalstep0"))
        # a sync save of the same state, for its pause beside the async ones
        t0 = time.monotonic()
        sync_path = saver.save(trainer, 0, 99, 99)
        sync_s = time.monotonic() - t0
        sync_bytes = _dir_bytes(os.path.join(sync_path, "state"))
        shutil.rmtree(sync_path)
        for (_, pause), (n, ws) in zip(dumps, writes):
            log(f"[durable] {card}: (d) async recover dump: the step loop paused {pause * 1e3:.1f} ms (the snapshot "
                f"queued on a side stream); the write {n / 1e9:.3f} GB in {ws:.2f} s, {n / 1e9 / ws:.2f} GB/s "
                "(fsynced), on the saver's thread")
        log(f"[durable] {card}: (d) a sync save of the same state: the step loop would pause {sync_s:.2f} s for "
            f"{sync_bytes / 1e9:.3f} GB ({sync_bytes / 1e9 / sync_s:.2f} GB/s, fsynced)")
        res["dumps"] = dict(async_pause_s=[p for _, p in dumps], write_s=[w for _, w in writes],
                            bytes=[n for n, _ in writes], sync_s=sync_s, sync_bytes=sync_bytes,
                            emergency_wait_s=at_dump["wait_s"], emergency_s=at_dump["s"])
        log(f"[durable] {card}: (e) preemption during step 3 (its rollout wait): the emergency dump of step 2, "
            f"already durable from its async dump ({at_dump['bytes'] / 1e9:.3f} GB) once the write still in flight "
            f"landed ({at_dump['wait_s']:.2f} s), rewrote only its record in {at_dump['s'] * 1e3:.1f} ms; the journal "
            f"sealed ({len(sealed[0])} segments, none open) and the lineage ring dumped ({lineage_dumps[0]}); train() "
            f"returned preempted after {loop_s:.1f} s")
        _drain_client(client, engine)  # the episodes in flight land in the journal too
        loop.close()  # seals the journal, destroys the client
        loop = trainer = client = None
        gc.collect()
        torch.cuda.empty_cache()
        # what the relaunch must replay: every accepted trajectory no
        # checkpointed step (version < 2) consumed, in the order accepted
        done = {tid for v, tids in consumed if v < 2 for tid in tids}
        expect = [tid for tid in accepted if tid not in done]
        if [v for v, _ in consumed] != [0, 1] or not expect:
            raise AssertionError(f"[durable] (e) batches consumed at versions {[v for v, _ in consumed]} (want "
                                 f"[0, 1]); {len(expect)} accepted trajectories left to replay")
        seg_bytes = _dir_bytes(jdir)

        # (e) the relaunch: a fresh trainer of other weights resumes at step 3
        # and replays the journal
        trainer = TorchTrainEngine(acfg, model_config=mcfg)
        trainer.initialize(ft, seed=1)
        client = RemoteTorchEngine(client_cfg, addresses=[srv.address])
        client.initialize()
        gen0 = engine.stats["generated_tokens"]
        t0 = time.monotonic()
        loop = PPOTrainer(ppo_cfg(3), dataset, rollout=client, actor_engine=trainer)
        resume_s = time.monotonic() - t0
        unequal = _unequal_state(trainer, at_dump["state"])
        info = loop.recover_info
        if info is None or info.last_step_info.next().global_step != 2 or unequal:
            raise AssertionError(f"[durable] (e) resume: {info and info.last_step_info}, {len(unequal)} of "
                                 f"{len(at_dump['state'])} tensors differ from the state at the dump "
                                 f"(first {unequal[:3]})")
        if _served_unequal(engine, trainer) or engine.get_version() != 2:
            raise AssertionError(f"[durable] (e) the fleet re-sync: version {engine.get_version()}")
        del at_dump["state"]
        replay = loop.last_replay
        replayed = list(client.executor._results)
        bad = [tid for tid, traj, _ in replayed
               if tid not in accepted or any(not np.array_equal(np.asarray(traj[k]), accepted[tid][k])
                                             or np.asarray(traj[k]).dtype != accepted[tid][k].dtype for k in JOURNAL_KEYS)]
        if replay is None or replay["dropped"] or [tid for tid, _, _ in replayed] != expect or bad:
            raise AssertionError(f"[durable] (e) journal replay {replay}: {len(replayed)} replayed, want the "
                                 f"{len(expect)} accepted and not consumed by a checkpointed step; "
                                 f"{len(bad)} differ from the accepted ones")
        saved_completion = sum(int(np.asarray(traj["loss_mask"]).sum()) for _, traj, _ in replayed)
        saved_tokens = sum(n for _, _, n in replayed)
        first_consumed: list = []
        mark_consumed = client.executor._mark_consumed
        client.executor._mark_consumed = lambda tids: (first_consumed.append(list(tids)), mark_consumed(tids))
        fwd_grids, mb_counts = [], []
        compute_logp, train_batch = loop.actor.compute_logp, trainer.train_batch

        def compute_logp_logged(b):
            fwd_grids.append(len(trainer._make_grids(b)))
            return compute_logp(b)

        def train_batch_logged(*a, **k):
            st = train_batch(*a, **k)
            mb_counts.append(int(st["n_microbatches"]))
            return st

        loop.actor.compute_logp, trainer.train_batch = compute_logp_logged, train_batch_logged
        committed = []
        commit = loop.stats_logger.commit
        loop.stats_logger.commit = lambda e, s, g, st: (committed.append((g, st)), commit(e, s, g, st))
        for kern in kernels:  # main path: counts to 0 just before, read just after
            kern.launches = 0
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        loop.recover_handler.saver.wait_async()
        counts = [k.launches for k in kernels]
        n_fwd, n_mbs = sum(fwd_grids), sum(mb_counts)
        want = [L * n_fwd + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
        if [g for g, _ in committed] != [2] or counts != want:
            raise AssertionError(f"[durable] (e) resumed steps {[g for g, _ in committed]} (want [2]); K2 / K3 / K4 "
                                 f"launches {counts} != {want}")
        n_batch = GRPO_CLIENT["consumer_batch_size"]
        if not first_consumed or first_consumed[0][: len(expect[:n_batch])] != expect[:n_batch]:
            raise AssertionError(f"[durable] (e) the resumed step trained on {first_consumed[:1]}, want the first "
                                 f"{n_batch} replayed trajectories {expect[:n_batch]}")
        st = committed[0][1]
        if not (math.isfinite(st["ppo_actor/loss"]) and math.isfinite(st["ppo_actor/grad_norm"])):
            raise AssertionError(f"[durable] (e) loss / grad_norm not finite: {st}")
        segments = sorted(os.listdir(jdir))
        n_records = sum(len(open(os.path.join(r, f)).read().splitlines())
                        for r, _, fs in os.walk(dump_dir) for f in fs)
        n_dumped = sum(len(fs) for _, _, fs in os.walk(dump_dir))
        log(f"[durable] {card}: (e) relaunch: a fresh trainer (other weights) restored step 2's parameters, AdamW "
            f"moments and step count bit for bit and re-synced the server (version 2) in {resume_s:.2f} s; its first "
            f"step (3) ran: loss {st['ppo_actor/loss']:.6f}, grad_norm {st['ppo_actor/grad_norm']:.4f}; K2 / K3 / K4 "
            f"launches {counts} ({n_fwd} forward grids, {n_mbs} microbatches)")
        log(f"[durable] {card}: (e) the journal: {len(accepted)} trajectories accepted in the first life (fsynced "
            f"appends), {len(accepted) - len(expect)} consumed by the two checkpointed steps; the relaunch replayed "
            f"{replay['replayed']} in {replay['s'] * 1e3:.1f} ms, {replay['dropped']} dropped, every one equal to the "
            f"accepted trajectory ({', '.join(JOURNAL_KEYS)}) bit for bit by task id, from {seg_bytes / 1e6:.2f} MB of "
            f"segments; the resumed step trained on the first {n_batch} of them; {saved_completion} completion "
            f"tokens ({saved_tokens} tokens with the prompts) the server did not generate again (it generated "
            f"{engine.stats['generated_tokens'] - gen0} in the second life); after the resumed step's dump the "
            f"journal's GC left {len(segments)} segments; {n_records} JSONL records in {n_dumped} trajectory dumps")
        res["journal"] = dict(accepted=len(accepted), replayed=replay["replayed"], dropped=replay["dropped"],
                              replay_s=replay["s"], segment_bytes=seg_bytes, segments_after_gc=len(segments),
                              jsonl_records=n_records, saved_completion_tokens=saved_completion,
                              saved_tokens=saved_tokens)
        res["counts"] = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts))
        _drain_client(client, engine)

        # (f) offload / onload of the resumed actor
        ref = _train_state(trainer)
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        trainer.offload()
        off_s = time.monotonic() - t0
        m1 = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        trainer.onload()
        on_s = time.monotonic() - t0
        unequal = _unequal_state(trainer, ref)
        del ref
        state_bytes = sum(t.numel() * t.element_size() for t in trainer._offload_targets())
        if unequal or m0 - m1 < state_bytes:
            raise AssertionError(f"[durable] (f) offload freed {(m0 - m1) / 1e9:.2f} GB; {len(unequal)} tensors "
                                 f"unequal after the onload (first {unequal[:3]})")
        res["offload"] = dict(freed_gb=(m0 - m1) / 1e9, offload_s=off_s, onload_s=on_s)
        log(f"[durable] {card}: (f) offload freed {(m0 - m1) / 1e9:.2f} GB (torch.cuda.memory_allocated) in "
            f"{off_s:.2f} s to pinned host memory, onload {on_s:.2f} s; parameters, moments and step count bit for "
            f"bit after")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[durable] {card}: peak torch.cuda.max_memory_allocated {peak:.2f} GiB; the phase took "
            f"{time.monotonic() - t_phase:.1f} s")
        res["peak_gib"] = peak
    finally:
        if loop is not None:
            loop.close()
        elif client is not None:
            client.destroy()
        if srv is not None:
            srv.stop()
        shutil.rmtree(DURABLE_ROOT, ignore_errors=True)
        if "flight_env" in locals():
            os.environ.pop("AREAL_FLIGHT_DIR", None)
            if flight_env is not None:
                os.environ["AREAL_FLIGHT_DIR"] = flight_env
    return res


def _drain_client(client, engine, timeout: float = 600.0) -> None:
    """No new submissions; the episodes in flight finish (closing a client
    with episodes in flight cancels them)."""
    client.pause()
    deadline = time.monotonic() + timeout
    while client.executor.staleness.stat.running and time.monotonic() < deadline:
        time.sleep(0.01)
    while any(t is not None for t in engine._slot_task) and time.monotonic() < deadline:
        time.sleep(0.01)



CRITIC_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_critic")
CRITIC_STEPS, CRITIC_PROMPTS = 2, 16
# the critic phase's peak device memory as predicted in PERF.md before its
# first run: the grpo phase's 31.23 GiB plus the critic's f32 weights and
# two moments (17.2 GiB)
CRITIC_PEAK_PREDICTED_GIB = 48.5
VALUES_RTOL = 1e-5  # step 1's returns against the plain GAE (f32 against f64 sums)


def _plain_returns(rewards: np.ndarray, loss_mask: np.ndarray, gamma: float, lam: float) -> np.ndarray:
    """GAE returns over zero values, one row and one position at a time:
    g = r_t + gamma * lam * g at each loss-masked label position, carried
    unchanged over the others (``trainer/ppo.py compute_advantages``'s
    masking; the last position stays 0)."""
    B, L = rewards.shape
    out = np.zeros((B, L), np.float64)
    for b in range(B):
        g = 0.0
        for t in range(L - 2, -1, -1):
            if loss_mask[b, t] > 0:
                g = float(rewards[b, t]) + gamma * lam * g
            out[b, t] = g
    return out


def phase_critic(card: str) -> dict:
    """PPO with a learned critic over HTTP at Qwen2.5-1.5B (full width,
    ``CUT_LAYERS`` of its depth): ``PPOTrainer.train``
    (2 global steps) with the grpo phase's actor and client and a
    ``PPOCriticConfig`` whose ``path`` is the actor's HF export, so the
    trainer builds the critic (the actor's dims, a zero value head) as
    ``gsm8k_ppo.yaml`` loads its critic from a checkpoint. Checks: the
    critic's body loaded equal to the actor's weights; step 1's values
    exactly 0 and its returns the plain GAE of its rewards; step 2's values
    nonzero and finite; finite ``ppo_critic/critic_loss`` and
    ``value_clip_ratio``; the critic ships no weights (every staged byte is
    the actor's); K2 launches include the critic's ``compute_values``
    forward. Prints the step's phases with that forward, the critic's
    tokens/s and the peak memory against the prediction."""
    import shutil

    from areal_tpu_torch.api.config import (DatasetConfig, EvaluatorConfig, InferenceEngineConfig, NormConfig,
                                            OptimizerConfig, PPOActorConfig, PPOConfig, PPOCriticConfig,
                                            PreemptionConfig, RecoverConfig, SaverConfig, ServerConfig,
                                            StatsLoggerConfig)
    from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, SaveLoadMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[critic] {held:.2f} GiB still allocated by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    group, n_new, batch_prompts = 4, 128, 8
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    acfg = PPOActorConfig(
        dtype="bfloat16", param_dtype="float32", attn_impl="pallas", gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"), group_size=group,
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=group), use_decoupled_loss=True,
        prox_logp_mode="recompute", ppo_n_minibatches=2,
    )
    trainer = TorchTrainEngine(acfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=CRITIC_PROMPTS, train_batch_size=batch_prompts),
                       seed=0)
    shutil.rmtree(CRITIC_ROOT, ignore_errors=True)
    hf_dir = os.path.join(CRITIC_ROOT, "actor_hf")
    t0 = time.monotonic()
    trainer.save(SaveLoadMeta(path=hf_dir, weight_format="hf"))
    export_s = time.monotonic() - t0
    ccfg = PPOCriticConfig(
        path=hf_dir, dtype="bfloat16", param_dtype="float32", attn_impl="pallas", gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"), ppo_n_minibatches=2,
    )
    scfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                        weight_stage_target="device", host="127.0.0.1", seed=0)
    engine = DecodeEngine(scfg, params=trainer.model.state_dict(), model_cfg=mcfg)
    srv = ServerThread(scfg, engine=engine)
    srv.start()
    client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
    client.initialize()
    gconfig = GenerationHyperparameters(n_samples=group, max_new_tokens=n_new, temperature=1.0)
    files = dict(saver=SaverConfig(fileroot=CRITIC_ROOT), checkpointer=SaverConfig(fileroot=CRITIC_ROOT),
                 evaluator=EvaluatorConfig(fileroot=CRITIC_ROOT), recover=RecoverConfig(fileroot=CRITIC_ROOT),
                 stats_logger=StatsLoggerConfig(fileroot=CRITIC_ROOT))
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name="critic", weight_update_mode="mem",
                    total_train_steps=CRITIC_STEPS, preemption=PreemptionConfig(enabled=False), gconfig=gconfig,
                    train_dataset=DatasetConfig(batch_size=batch_prompts), actor=acfg, critic=ccfg,
                    rollout=InferenceEngineConfig(**GRPO_CLIENT), **files)
    cfg.cluster.fileroot = CRITIC_ROOT
    rng = np.random.default_rng(1)
    dataset = [{"prompt_ids": rng.integers(0, mcfg.vocab_size, int(n)).tolist()}
               for n in rng.integers(64, 513, CRITIC_PROMPTS)]
    loop = None
    try:
        t0 = time.monotonic()
        loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
        critic = loop.critic
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        cparams = dict(critic.engine.model.named_parameters())
        head = cparams.pop("value_head")
        unequal = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, cparams[n])]
        if unequal or cparams.keys() != dict(trainer.model.named_parameters()).keys() or bool(head.any()):
            raise AssertionError(f"[critic] the critic's body differs from the actor's export in {unequal[:3]}, or "
                                 f"its value head is not zero")
        log(f"[critic] {card}: the actor's HF export {export_s:.2f} s; the critic (value head, f32 master weights, "
            f"AdamW state) built from it by PPOTrainer in {build_s:.1f} s, its body equal to the actor's; "
            f"torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

        # what each step computed and trained, recorded around the loop's calls
        values_s, values_grids, critic_s, adv_seen, critic_mbs, actor_mbs, fwd_grids = [], [], [], [], [], [], []
        compute_values, critic_update = critic.compute_values, critic.ppo_update
        compute_logp, actor_train, critic_train = loop.actor.compute_logp, trainer.train_batch, critic.engine.train_batch

        def compute_values_timed(b):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = compute_values(b)
            values_s.append(time.monotonic() - t)
            values_grids.append(len(critic.engine._make_grids(b)))
            return out

        def critic_update_timed(data):
            adv_seen.append({k: np.array(data[k], copy=True)
                             for k in ("values", "returns", "tot_rewards", "loss_mask", "attention_mask")})
            torch.cuda.synchronize()
            t = time.monotonic()
            out = critic_update(data)
            critic_s.append(time.monotonic() - t)
            return out

        def compute_logp_logged(b):
            fwd_grids.append(len(trainer._make_grids(b)))
            return compute_logp(b)

        def actor_train_logged(*a, **k):
            st = actor_train(*a, **k)
            actor_mbs.append(int(st["n_microbatches"]))
            return st

        def critic_train_logged(*a, **k):
            st = critic_train(*a, **k)
            critic_mbs.append(int(st["n_microbatches"]))
            return st

        def critic_ships(*a, **k):
            raise AssertionError("[critic] the critic engine pushed weights")

        pushed: list[set] = []
        client_update = client.update_weights

        def client_update_logged(meta, params=None, **k):
            pushed.append(set(params or ()))
            return client_update(meta, params=params, **k)

        client.update_weights = client_update_logged
        critic.compute_values, critic.ppo_update = compute_values_timed, critic_update_timed
        loop.actor.compute_logp, trainer.train_batch = compute_logp_logged, actor_train_logged
        critic.engine.train_batch, critic.engine.update_weights = critic_train_logged, critic_ships
        per_step = []
        commit = loop.stats_logger.commit

        def commit_recorded(epoch, step, global_step, stats):
            per_step.append(dict(stats))
            commit(epoch, step, global_step, stats)

        loop.stats_logger.commit = commit_recorded
        kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
        bytes0 = client._metrics.update_bytes.get()
        # main path: counts to 0 just before, read just after
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        t0 = time.monotonic()
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        wall = time.monotonic() - t0
        _drain_client(client, engine)
        counts = [k.launches for k in kernels]
        launches1 = paged_attention_stacked.launches
        staged = client._metrics.update_bytes.get() - bytes0
        critic_version = critic.engine.get_version()
    finally:
        if loop is not None:
            loop.close()
        else:
            client.destroy()
        srv.stop()
        shutil.rmtree(CRITIC_ROOT, ignore_errors=True)

    # checks
    if len(per_step) != CRITIC_STEPS or len(adv_seen) != CRITIC_STEPS:
        raise AssertionError(f"[critic] {len(per_step)} steps, {len(adv_seen)} critic updates, want {CRITIC_STEPS}")
    if critic_version != CRITIC_STEPS:
        raise AssertionError(f"[critic] the critic's version {critic_version}, want {CRITIC_STEPS}")
    first, second = adv_seen
    if np.any(first["values"] != 0.0):
        raise AssertionError(f"[critic] step 1's values are not all 0 (max |v| {np.abs(first['values']).max():.3g})")
    want = _plain_returns(first["tot_rewards"], first["loss_mask"], acfg.gamma, acfg.lam)
    ret_err = float(np.abs(first["returns"] - want).max())
    if not ret_err <= VALUES_RTOL * max(1.0, float(np.abs(want).max())):
        raise AssertionError(f"[critic] step 1's returns against the plain GAE: max|diff| {ret_err:.3g}")
    attn2 = second["attention_mask"].astype(bool)
    v2 = second["values"][attn2]
    if not (np.isfinite(v2).all() and np.abs(v2).min() > 0 and np.all(second["values"][~attn2] == 0)):
        raise AssertionError("[critic] step 2's values not finite and nonzero on every token (zero on padding)")
    for i, s in enumerate(per_step):
        bad = [k for k in ("ppo_critic/critic_loss", "ppo_critic/value_clip_ratio", "ppo_critic/grad_norm",
                           "ppo_actor/loss") if not math.isfinite(s.get(k, float("nan")))]
        if bad:
            raise AssertionError(f"[critic] step {i}: {bad} missing or not finite")
    actor_names = {n for n, _ in trainer.model.named_parameters()}
    if pushed != [actor_names] * CRITIC_STEPS:
        raise AssertionError(f"[critic] the pushes carried {[sorted(p ^ actor_names)[:3] for p in pushed]} beyond or "
                             "short of the actor's parameters")
    n_fwd, n_val, n_amb, n_cmb = sum(fwd_grids), sum(values_grids), sum(actor_mbs), sum(critic_mbs)
    want_counts = [L * (n_fwd + n_val) + 2 * L * (n_amb + n_cmb), L * (n_amb + n_cmb), L * (n_amb + n_cmb)]
    if counts != want_counts or n_val == 0:
        raise AssertionError(f"[critic] K2 / K3 / K4 launches {counts} != {want_counts} (actor: {n_fwd} forward "
                             f"grids, {n_amb} microbatches; critic: {n_val} values grids, {n_cmb} microbatches)")
    steps = engine.stats["decode_steps"]
    if launches1 == 0 or launches1 % L:
        raise AssertionError(f"[critic] #1 launches {launches1}, not a positive multiple of {L} layers")

    # the prints
    for i, s in enumerate(per_step):
        log(f"[critic] {card}: step {i}: {s['step_secs']:.2f} s; rollout_wait {s['phase/rollout_wait_s']:.2f} s, "
            f"compute_values {values_s[i]:.2f} s ({values_grids[i]} grids), host_prep {s['phase/host_prep_s']:.2f} s, "
            f"forward_backward {s['phase/forward_backward_s']:.2f} s, optimizer {s['phase/optimizer_s']:.2f} s, "
            f"ppo_update (actor + critic) {s['timing/train_step']:.2f} s of which the critic's {critic_s[i]:.2f} s, "
            f"weight_publish {s['phase/weight_publish_s']:.2f} s; ppo_actor/loss {s['ppo_actor/loss']:.6f}, "
            f"ppo_critic/critic_loss {s['ppo_critic/critic_loss']:.6f}, value_clip_ratio "
            f"{s['ppo_critic/value_clip_ratio']:.4f}, critic grad_norm {s['ppo_critic/grad_norm']:.4f}")
    tokens = sum(int(a["attention_mask"].sum()) for a in adv_seen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[critic] {card}: step 1's values all 0 and its returns the plain GAE of its rewards (max|diff| "
        f"{ret_err:.2e}); step 2's values nonzero and finite (|v| {np.abs(v2).min():.3g}..{np.abs(v2).max():.3g}); "
        f"the critic {tokens / sum(critic_s):.0f} tokens/s ({tokens} tokens in {sum(critic_s):.2f} s of its "
        f"ppo_update, the first step carrying its one-time cost); {staged / 1e9:.3f} GB staged in {len(pushed)} "
        "pushes of the actor's parameters only; "
        f"K2 / K3 / K4 launches {counts} (actor {n_fwd} forward grids + {n_amb} microbatches, critic {n_val} values "
        f"grids + {n_cmb} microbatches); #1 launches {launches1} = {L} x {steps} decode steps; the loop {wall:.1f} s; "
        f"peak torch.cuda.max_memory_allocated {peak:.2f} GiB ({mcfg.num_layers} layers; "
        f"{CRITIC_PEAK_PREDICTED_GIB:.1f} GiB predicted at 28)")
    log(f"[critic] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    del loop, trainer, engine, srv, critic
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                launches1=launches1, peak_gib=peak, tokens_per_s=tokens / sum(critic_s), values_s=values_s,
                step_s=[s["step_secs"] for s in per_step])


SFT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_sft")
SFT_STEPS, SFT_BATCH = 4, 8
REMAT_POLICIES, REMAT_ROUNDS = ("nothing", "dots_nobatch", "everything"), 2


def _sft_rows(n: int, seed: int, vocab: int) -> list[dict]:
    """A prompt of 64-384 tokens, then a 128-token response under the loss
    mask (seeded, no dataset)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p = int(rng.integers(64, 385))
        ids = rng.integers(0, vocab, p + 128)
        rows.append({"input_ids": ids.tolist(), "loss_mask": [0.0] * p + [1.0] * 128})
    return rows


def _pref_rows(n: int, seed: int, vocab: int) -> list[dict]:
    """Preference pairs: one prompt of 64-384 tokens, a chosen and a
    rejected response of 32-128 tokens."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p = rng.integers(0, vocab, int(rng.integers(64, 385))).tolist()
        rows.append({"chosen_ids": p + rng.integers(0, vocab, int(rng.integers(32, 129))).tolist(),
                     "rejected_ids": p + rng.integers(0, vocab, int(rng.integers(32, 129))).tolist()})
    return rows


def phase_sft(card: str) -> dict:
    """SFT, the reward model and the three remat policies at Qwen2.5-1.5B,
    full width and ``CUT_LAYERS`` of its depth, from an HF export of seeded
    random weights:
    ``SFTTrainer.train`` (4 steps of 8 rows, an eval pass every 2 steps) and
    ``RWTrainer.train`` (4 steps of 8 pairs, microbatches of at most 4,096
    tokens), each building its engine from ``TrainEngineConfig.path``; then
    one SFT step from the same weights on the same batch under each of
    "nothing", "dots_nobatch" and "everything", in two rounds. Checks
    finite losses, ``n_pairs`` equal to the step's pairs, K2 / K3 / K4
    launches (the recompute launching K2 again under "dots_nobatch"), and
    the post-step parameters under "dots_nobatch" equal to those under
    "nothing" bit for bit, or apart by no more than two runs under
    "nothing". Prints tokens/s, losses, peak memory and each policy's peak
    and step seconds."""
    import shutil

    from areal_tpu_torch.api.config import (DatasetConfig, EvaluatorConfig, MicroBatchSpec, OptimizerConfig,
                                            RecoverConfig, RWConfig, SaverConfig, SFTConfig, StatsLoggerConfig,
                                            TrainEngineConfig)
    from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.trainer.sft_trainer import LMEngine, RWTrainer, SFTTrainer
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[sft] {held:.2f} GiB still allocated by earlier phases")
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    shutil.rmtree(SFT_ROOT, ignore_errors=True)
    hf_dir = os.path.join(SFT_ROOT, "hf")
    res: dict = {}
    try:
        src = TorchTrainEngine(TrainEngineConfig(), model_config=mcfg, need_optimizer=False)
        src.initialize(seed=0)
        src.save(SaveLoadMeta(path=hf_dir, weight_format="hf"))
        del src
        gc.collect()
        torch.cuda.empty_cache()

        def engine_cfg(**over):
            return TrainEngineConfig(path=hf_dir, dtype="bfloat16", param_dtype="float32", attn_impl="pallas",
                                     gradient_checkpointing=True,
                                     optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"), **over)

        def files(name: str) -> dict:
            root = os.path.join(SFT_ROOT, name)
            return dict(experiment_name="chip-smoke", trial_name=name, saver=SaverConfig(fileroot=root),
                        checkpointer=SaverConfig(fileroot=root), recover=RecoverConfig(fileroot=root),
                        stats_logger=StatsLoggerConfig(fileroot=root))

        # (a) SFT
        torch.cuda.reset_peak_memory_stats()
        rows = _sft_rows(SFT_STEPS * SFT_BATCH, 2, mcfg.vocab_size)
        valid = _sft_rows(SFT_BATCH, 3, mcfg.vocab_size)
        cfg = SFTConfig(total_train_epochs=1, total_train_steps=SFT_STEPS, model=engine_cfg(),
                        train_dataset=DatasetConfig(batch_size=SFT_BATCH), **files("sft"),
                        evaluator=EvaluatorConfig(fileroot=SFT_ROOT, freq_steps=2))
        cfg.cluster.fileroot = SFT_ROOT
        t0 = time.monotonic()
        sft = SFTTrainer(cfg, rows, valid_dataset=valid)
        build_s = time.monotonic() - t0
        eng = sft.engine
        mbs, eval_grids, committed, step_tokens = [], [], [], []
        train_batch, eval_batch, collate = eng.train_batch, eng.eval_batch, sft._collate

        def train_logged(*a, **k):
            st = train_batch(*a, **k)
            mbs.append(int(st["n_microbatches"]))
            return st

        def eval_logged(data, *a, **k):
            eval_grids.append(len(eng._make_grids(data)))
            return eval_batch(data, *a, **k)

        def collate_counted(batch_rows):
            b = collate(batch_rows)
            step_tokens.append(int(np.asarray(b["attention_mask"]).sum()))
            return b

        eng.train_batch, eng.eval_batch, sft._collate = train_logged, eval_logged, collate_counted
        sft.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(dict(stats))
        for kern in kernels:
            kern.launches = 0
        losses = sft.train()
        counts = [k.launches for k in kernels]
        sft.close()
        want = [2 * L * sum(mbs) + L * sum(eval_grids), L * sum(mbs), L * sum(mbs)]
        evals = [s["eval/ppl_loss"] for s in committed if "eval/ppl_loss" in s]
        if len(losses) != SFT_STEPS or not all(math.isfinite(x) for x in losses + evals) or len(evals) != 2:
            raise AssertionError(f"[sft] losses {losses}, eval losses {evals}: want {SFT_STEPS} finite and 2 evals")
        if counts != want:
            raise AssertionError(f"[sft] K2 / K3 / K4 launches {counts} != {want} ({sum(mbs)} microbatches, "
                                 f"{sum(eval_grids)} eval grids)")
        # the trainer's tokens/s over the engine's spans of steps 2-4 (the
        # first carries the process's one-time cost when it trains first)
        spans = [s["phase/host_prep_s"] + s["phase/forward_backward_s"] + s["phase/optimizer_s"] for s in committed]
        sft_tps = sum(step_tokens[1:]) / sum(spans[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[sft] {card}: (a) SFTTrainer built its engine from the HF export in {build_s:.1f} s; steps "
            + ", ".join(f"{s['step_secs']:.2f}" for s in committed) + f" s ({step_tokens} tokens); {sft_tps:.0f} "
            "tokens/s over steps 2-4 (host prep, forward / backward, optimizer); losses "
            + ", ".join(f"{x:.4f}" for x in losses) + "; eval ppl_loss " + ", ".join(f"{x:.4f}" for x in evals)
            + f"; K2 / K3 / K4 launches {counts} = {2 * L} x {sum(mbs)} microbatches + {L} x {sum(eval_grids)} "
            f"eval grids; peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
        res["sft"] = dict(losses=losses, evals=evals, counts=counts, peak_gib=peak, tokens_per_s=sft_tps,
                          step_s=[s["step_secs"] for s in committed])
        del sft, eng, train_batch, eval_batch, collate
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the reward model
        torch.cuda.reset_peak_memory_stats()
        pairs = _pref_rows(SFT_STEPS * SFT_BATCH, 4, mcfg.vocab_size)
        cfg = RWConfig(total_train_epochs=1, total_train_steps=SFT_STEPS,
                       model=engine_cfg(mb_spec=MicroBatchSpec(max_tokens_per_mb=4096)),
                       train_dataset=DatasetConfig(batch_size=SFT_BATCH), **files("rw"),
                       evaluator=EvaluatorConfig(fileroot=SFT_ROOT))
        cfg.cluster.fileroot = SFT_ROOT
        rw = RWTrainer(cfg, pairs)
        if not (rw.engine.value_head and not bool(rw.engine.model.value_head.any())):
            raise AssertionError("[rw] the reward model's engine has no zero value head")
        rw_steps, rw_mbs, rw_tokens = [], [], []
        step_fn, train_rw = rw._train_step, rw.rw.train_rw

        def train_rw_counted(b):
            out = train_rw(b)
            rw_mbs.append(len(out))
            return out

        def rw_step_logged(batch):
            rw_tokens.append(int(np.asarray(batch["attention_mask"]).sum()))
            rw_steps.append(dict(step_fn(batch)))
            return rw_steps[-1]

        rw.rw.train_rw, rw._train_step = train_rw_counted, rw_step_logged
        committed = []
        rw.stats_logger.commit = lambda epoch, step, gstep, stats: committed.append(dict(stats))
        for kern in kernels:
            kern.launches = 0
        rw_losses = rw.train()
        counts = [k.launches for k in kernels]
        rw.close()
        n_pairs = [s["n_pairs"] for s in rw_steps]
        if n_pairs != [float(SFT_BATCH)] * SFT_STEPS or not all(math.isfinite(x) for x in rw_losses):
            raise AssertionError(f"[rw] n_pairs {n_pairs} (want {SFT_BATCH} a step), losses {rw_losses}")
        if min(rw_mbs) < 2:
            raise AssertionError(f"[rw] microbatches a step {rw_mbs}: the 4,096-token cap split no step")
        want = [2 * L * sum(rw_mbs), L * sum(rw_mbs), L * sum(rw_mbs)]
        if counts != want:
            raise AssertionError(f"[rw] K2 / K3 / K4 launches {counts} != {want} ({sum(rw_mbs)} microbatches)")
        spans = [s["phase/host_prep_s"] + s["phase/forward_backward_s"] + s["phase/optimizer_s"] for s in committed]
        rw_tps = sum(rw_tokens[1:]) / sum(spans[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[sft] {card}: (b) RWTrainer: steps " + ", ".join(f"{s['step_secs']:.2f}" for s in committed)
            + f" s ({rw_tokens} tokens, {rw_mbs} microbatches of <= 4,096 tokens); {rw_tps:.0f} tokens/s over steps "
            "2-4; n_pairs " + ", ".join(f"{x:.0f}" for x in n_pairs) + "; rw_loss "
            + ", ".join(f"{x:.4f}" for x in rw_losses) + "; rw_acc "
            + ", ".join(f"{s['rw_acc']:.3f}" for s in rw_steps) + f"; K2 / K3 / K4 launches {counts}; peak "
            f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
        res["rw"] = dict(losses=rw_losses, n_pairs=n_pairs, counts=counts, peak_gib=peak, tokens_per_s=rw_tps)
        del rw, step_fn, train_rw
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the remat policies: one SFT step each from the same weights,
        # moments and step count on the same batch, in two rounds (the
        # second's times are warm; its "nothing" against the first's gives
        # the run-to-run difference)
        eng = TorchTrainEngine(engine_cfg(), value_head=False)
        eng.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=64, train_batch_size=SFT_BATCH))
        eng._opt.count = 1  # past the warmup's LR 0, so the step moves the weights
        start = {n: p.detach().to("cpu", copy=True) for n, p in eng.model.named_parameters()}
        batch = pad_sequences_to_tensors(
            [{"input_ids": np.asarray(r["input_ids"], np.int32), "loss_mask": np.asarray(r["loss_mask"], np.float32)}
             for r in _sft_rows(SFT_BATCH, 5, mcfg.vocab_size)])
        lm = LMEngine(eng)
        base_cfg = eng.model_cfg
        ref: dict | None = None
        runs = []
        for policy in REMAT_POLICIES * REMAT_ROUNDS:
            with torch.no_grad():
                for n, p in eng.model.named_parameters():
                    p.copy_(start[n])
                for t in eng._opt.mu + eng._opt.nu:
                    t.zero_()
            eng._opt.count = 1
            eng.model_cfg = dataclasses.replace(base_cfg, remat=True, remat_policy=policy)
            for kern in kernels:
                kern.launches = 0
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            st = lm.train_lm(batch)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            peak_b = torch.cuda.max_memory_allocated()
            k = [kern.launches for kern in kernels]
            if ref is None:
                ref = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
                diff, equal = 0.0, True
            else:
                diffs = [float((p.detach() - ref[n]).abs().max()) for n, p in eng.model.named_parameters()]
                diff = max(diffs)
                equal = all(torch.equal(p, ref[n]) for n, p in eng.model.named_parameters())
            runs.append(dict(policy=policy, secs=secs, peak_gib=peak_b / 2**30, act_gib=(peak_b - held) / 2**30,
                             counts=k, loss=st["loss"], grad_norm=st["grad_norm"], diff=diff, equal=equal))
        eng.model_cfg = base_cfg
        moved = max(float((ref[n] - start[n].to(ref[n].device)).abs().max()) for n in ("embed", "layers.0.wq"))
        noise = runs[len(REMAT_POLICIES)]["diff"]  # the second round's "nothing"
        dots = [r for r in runs if r["policy"] == "dots_nobatch"]
        if not all(r["equal"] or r["diff"] <= noise for r in dots):
            raise AssertionError(f"[sft] (c) the parameters after a step under dots_nobatch differ from nothing's by "
                                 f"{[r['diff'] for r in dots]}, two runs under nothing by {noise:.3g}")
        counts = {r["policy"]: r["counts"] for r in runs}
        if counts["dots_nobatch"] != counts["nothing"] or counts["everything"][0] >= counts["nothing"][0] or \
                not moved > 0:
            raise AssertionError(f"[sft] (c) launches {[r['counts'] for r in runs]} (dots_nobatch must launch K2 "
                                 f"again in the recompute, as nothing does); the step moved the weights by {moved}")
        for i, r in enumerate(runs):
            log(f"[sft] {card}: (c) round {i // len(REMAT_POLICIES) + 1}, remat_policy={r['policy']!r}: one SFT "
                f"step {r['secs']:.3f} s, peak torch.cuda.max_memory_allocated {r['peak_gib']:.2f} GiB "
                f"({r['act_gib']:.2f} GiB above the {(r['peak_gib'] - r['act_gib']):.2f} GiB held before the step), "
                f"K2 / K3 / K4 launches {r['counts']}, loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}; "
                "parameters after the step against the first nothing run's: "
                + ("bit for bit" if r["equal"] else f"max|diff| {r['diff']:.3g}"))
        res["remat"] = runs
        del eng, lm, ref, start
    finally:
        shutil.rmtree(SFT_ROOT, ignore_errors=True)
    log(f"[sft] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    res["counts"] = {name: res["sft"]["counts"][i] + res["rw"]["counts"][i]
                     for i, name in enumerate(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"))}
    return res


# the int8serve and lora phases write here (git-ignored) and delete it
ITEM4_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_item4")
ITEM4_STEPS, ITEM4_PROMPTS = 2, 16
# the q8 wire's bytes over bf16's at Qwen2.5-1.5B, reckoned from the shapes
# (int8 tables 1 B, f32 scales 4 B, the rest bf16): 1.780 / 3.087 GB
Q8_RATIO = 0.577
LORA_RANK, LORA_ALPHA, LORA_TARGETS = 32, 16.0, ("wq", "wk", "wv", "wo")  # gsm8k_grpo_lora.yaml
LORA_PEAK_DROP_PREDICTED_GIB = 17.0  # the base's f32 gradients and AdamW moments against grpo's peak
# served logprobs on int8 KV pages against a dense prefill, which keeps K and
# V in bf16: each page row is rounded to 2^-8 of its largest entry, which the
# served logprobs carry and the dense ones do not (bf16 pages: LOGPROB_TOL).
# The first card run measured 0.086 on bf16 weights and 0.080 on int8 ones
INT8_KV_LOGPROB_TOL = 0.2


def _grpo_actor(**over):
    """The grpo phase's actor settings (f32 master weights, a constant LR)."""
    from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig

    return PPOActorConfig(
        dtype="bfloat16", param_dtype="float32", attn_impl="pallas", gradient_checkpointing=True,
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"), group_size=4,
        adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4), use_decoupled_loss=True,
        prox_logp_mode="recompute", ppo_n_minibatches=2, **over,
    )


def _item4_loop(tag: str, trainer, acfg, srv, scfg, seed: int, client_kw: dict | None = None):
    """A client of the started server ``srv`` at the grpo phase's settings
    and a ``PPOTrainer`` of ``ITEM4_STEPS`` global steps of 8 prompts x 4
    samples x 128 tokens writing under ``ITEM4_ROOT``, with per-step records
    of the stats, forward grids, microbatches and ppo_update seconds
    (``rec``)."""
    from areal_tpu_torch.api.config import (DatasetConfig, EvaluatorConfig, InferenceEngineConfig, PPOConfig,
                                            PreemptionConfig, RecoverConfig, SaverConfig, StatsLoggerConfig)
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer

    client = RemoteTorchEngine(InferenceEngineConfig(**{**GRPO_CLIENT, **(client_kw or {})}), addresses=[srv.address])
    client.initialize()
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=128, temperature=1.0)
    root = os.path.join(ITEM4_ROOT, tag)
    files = dict(saver=SaverConfig(fileroot=root), checkpointer=SaverConfig(fileroot=root),
                 evaluator=EvaluatorConfig(fileroot=root), recover=RecoverConfig(fileroot=root),
                 stats_logger=StatsLoggerConfig(fileroot=root))
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name=tag, weight_update_mode="mem",
                    total_train_steps=ITEM4_STEPS, preemption=PreemptionConfig(enabled=False), gconfig=gconfig,
                    train_dataset=DatasetConfig(batch_size=8), actor=acfg, server=scfg,
                    rollout=InferenceEngineConfig(**GRPO_CLIENT), **files)
    cfg.cluster.fileroot = root
    rng = np.random.default_rng(seed)
    dataset = [{"prompt_ids": rng.integers(0, QWEN25_15B["vocab_size"], int(n)).tolist()}
               for n in rng.integers(64, 513, ITEM4_PROMPTS)]
    loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
    rec: dict[str, list] = {"stats": [], "fwd": [], "mbs": [], "tokens": [], "ppo_s": []}
    compute_logp, train_batch, ppo_update = loop.actor.compute_logp, trainer.train_batch, loop.actor.ppo_update

    def compute_logp_logged(b):
        rec["fwd"].append(len(trainer._make_grids(b)))
        return compute_logp(b)

    def train_batch_logged(*a, **k):
        st = train_batch(*a, **k)
        rec["mbs"].append(int(st["n_microbatches"]))
        return st

    def ppo_update_timed(data):
        rec["tokens"].append(int(np.asarray(data["attention_mask"]).sum()))
        torch.cuda.synchronize()
        t = time.monotonic()
        out = ppo_update(data)
        torch.cuda.synchronize()
        rec["ppo_s"].append(time.monotonic() - t)
        return out

    loop.actor.compute_logp, trainer.train_batch, loop.actor.ppo_update = (compute_logp_logged, train_batch_logged,
                                                                          ppo_update_timed)
    return loop, client, gconfig, rec


def _flash_counts_check(tag: str, counts: list[int], rec: dict, L: int) -> None:
    n_fwd, n_mbs = sum(rec["fwd"]), sum(rec["mbs"])
    want = [L * n_fwd + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
    if counts != want or n_mbs == 0:
        raise AssertionError(f"[{tag}] K2 / K3 / K4 launches {counts} != {want} ({n_fwd} forward grids, {n_mbs} "
                             "microbatches)")


def _health_version(addr: str) -> int:
    with urllib.request.urlopen(f"http://{addr}/health", timeout=10) as r:
        return json.loads(r.read())["version"]


def _http_reason(e: Exception) -> str:
    """The server's error text behind a client's failed POST."""
    cause = e.__cause__
    if isinstance(cause, urllib.error.HTTPError):
        try:
            return json.loads(cause.read()).get("error", str(cause))
        except (ValueError, OSError):
            return str(cause)
    return str(e)


def _int8_unequal(engine, weights: dict, tables_from=None) -> list[str]:
    """Served parameters of an int8 engine that differ in any bit from
    ``weights`` (the port's names): each int8 table and scale from
    ``quantize_dense_int8`` of ``tables_from(w)`` (default: ``w`` cast to
    bf16, the server-side quantization), every other leaf ``w`` cast to
    bf16."""
    from areal_tpu_torch.models import qwen

    tables_from = tables_from or (lambda w: w.to(torch.bfloat16))
    served = dict(engine.model.named_parameters())
    bad = []
    for n, p in served.items():
        if n.endswith("_q8"):
            q8, s = qwen.quantize_dense_int8(tables_from(weights[n[: -len("_q8")]]))
            if not (torch.equal(p, q8) and torch.equal(served[n[: -len("_q8")] + "_scale"], s)):
                bad.append(n)
        elif not n.endswith("_scale") and not torch.equal(p.detach(), weights[n].detach().to(torch.bfloat16)):
            bad.append(n)
    return bad


def _serve_waves(tag: str, srv, engine, card: str) -> dict:
    """A cold wave of 16 (64..512-token prompts, 128 new tokens, half
    greedy) and a warm wave of 16 on a shared 1,024-token prompt (the first
    alone, then 15 through radix hits), the serve phase's prompts; #1 and
    #3 launches counted from 0 over both; ms per decode step (device
    stream and wall), the probe's dispatch share, logprobs against a dense
    prefill of the served model."""
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa

    V, n_new = QWEN25_15B["vocab_size"], 128
    rng = np.random.default_rng(0)
    cold = [rng.integers(0, V, int(n)).tolist() for n in rng.integers(64, 513, 16)]
    rng = np.random.default_rng(3)
    system = rng.integers(0, V, 1024).tolist()
    warm = [system + rng.integers(0, V, int(n)).tolist() for n in rng.integers(64, 257, 16)]

    def body(p, i):
        sp = {"max_new_tokens": n_new, "greedy": True} if i % 2 == 0 else {"max_new_tokens": n_new, "temperature": 1.0}
        return {"input_ids": p, "sampling_params": sp}

    keys = ("decode_steps", "prefix_hit_tokens", "suffix_prefill_batches")
    # main path: counts to 0 just before, read just after
    paged_attention_stacked.launches = 0
    for k in psa.launches:
        psa.launches[k] = 0
    s0, dev0 = {k: engine.stats[k] for k in keys}, engine.device_seconds()
    t0 = time.monotonic()
    resps = _wave(srv.address, [body(p, i) for i, p in enumerate(cold)])
    cold_wall = time.monotonic() - t0
    resps += _wave(srv.address, [body(warm[0], 0)])
    t1 = time.monotonic()
    resps += _wave(srv.address, [body(p, i) for i, p in enumerate(warm[1:], 1)])
    warm_wall = time.monotonic() - t1
    launches1, launches3 = paged_attention_stacked.launches, dict(psa.launches)
    d = {k: engine.stats[k] - s0[k] for k in keys}
    dev = engine.device_seconds()
    for r in resps:
        _check_response(r, n_new, tag)
    L = engine.model_cfg.num_layers
    if d["decode_steps"] == 0 or launches1 != L * d["decode_steps"]:
        raise AssertionError(f"[{tag}] #1 launches {launches1} != {L} x {d['decode_steps']} decode steps")
    if d["prefix_hit_tokens"] <= 0 or launches3["chain"] != L * d["suffix_prefill_batches"] or not launches3["chain"]:
        raise AssertionError(f"[{tag}] warm wave: {d}, #3 launches {launches3}")
    prompts = cold + warm
    errs = [_dense_check(engine.model, prompts[i], resps[i], greedy=False) for i in (1, 3, 17, 19)]
    gaps = [_dense_check(engine.model, prompts[i], resps[i], greedy=True) for i in (0, 2, 18, 20)]
    tol = INT8_KV_LOGPROB_TOL if engine.config.kv_quantization == "int8" else LOGPROB_TOL
    if max(errs) > tol or max(gaps) > tol:
        raise AssertionError(f"[{tag}] served logprobs vs a dense prefill of the served model: {errs}, greedy gaps "
                             f"{gaps} (tol {tol})")
    ks = engine.kernel_stats()
    steps = dev["decode_steps"] - dev0["decode_steps"]
    out = dict(ms_per_step=(dev["decode_s"] - dev0["decode_s"]) / steps * 1e3,
               wall_ms_per_step=(cold_wall + warm_wall) / d["decode_steps"] * 1e3,
               decode_tok_s=16 * n_new / cold_wall, dispatch_share=ks["phase_means_s"]["dispatch"] / ks["total_mean_s"],
               launches1=launches1, launches3=launches3["chain"], hit_tokens=d["prefix_hit_tokens"],
               dense_err=max(errs), greedy_gap=max(gaps), tokens=[r["output_tokens"] for r in resps])
    log(f"[{tag}] {card}: 32/32 responses complete (cold 16 in {cold_wall:.2f} s, warm 15 in {warm_wall:.2f} s "
        f"through {d['prefix_hit_tokens']} radix hit tokens); {out['ms_per_step']:.2f} ms per decode step (device "
        f"stream), {out['wall_ms_per_step']:.2f} ms wall; cold {out['decode_tok_s']:.1f} decode tok/s; the decode "
        f"loop's dispatch {out['dispatch_share']:.1%} of a pass ({ks['steps']} passes); #1 launches {launches1} = {L} x "
        f"{d['decode_steps']}, #3 chain {launches3['chain']}; logprobs vs a dense prefill of the served model max|diff| "
        f"{max(errs):.4f}, greedy gap {max(gaps):.4f} (tol {tol}, {engine.config.kv_quantization} pages)")
    return out


def phase_int8serve(card: str) -> dict:
    """int8 weight serving at Qwen2.5-1.5B, full width and ``CUT_LAYERS``
    of its depth (since the vlm phase came)
    (``gsm8k_grpo_int8serve.yaml``: ``quantization="int8"``,
    ``kv_quantization="int8"``, the q8 wire): (a) a server started from
    the grpo phase's trainer's weights serves the server-side quantization
    of their bf16 export, bit for bit; (b) the serve phase's cold and warm
    waves on it and on a bf16-weight server of the same settings (int8
    pages too) in the same process: ms per decode step, the probe's
    dispatch share, the ledger's params bytes, #1 / #3 launches; (c) a q8
    update to the bf16 server is refused and changes no weight; an adapter
    fold into the int8 engine is refused; (d) ``PPOTrainer.train`` for 2
    steps over HTTP with ``weight_update_wire="auto"``, resolved to q8:
    after each step the served tables are the q8 wire's transform of the
    trainer's f32 master weights (no bf16 rounding first), bit for bit;
    the wire bytes of an update against bf16's, stage and fence seconds,
    K2-K4 / #1 launches."""
    import shutil

    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[int8serve] {held:.2f} GiB still allocated by earlier phases")
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    acfg = _grpo_actor()
    trainer = TorchTrainEngine(acfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=ITEM4_PROMPTS, train_batch_size=8), seed=0)
    scfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                        weight_stage_target="device", host="127.0.0.1", seed=0, quantization="int8",
                        kv_quantization="int8")
    export = trainer._export_params()
    t0 = time.monotonic()
    engine = DecodeEngine(scfg, params=export, model_cfg=mcfg)
    engine.initialize()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # (a) the server-side quantization of the trainer's bf16 export
    bad = _int8_unequal(engine, export)
    n_tables = sum(n.endswith("_q8") for n, _ in engine.model.named_parameters())
    if bad or n_tables != 7 * L:
        raise AssertionError(f"[int8serve] (a) {len(bad)} served tensors differ from the server-side quantization "
                             f"of the bf16 export (first {bad[:3]}); {n_tables} int8 tables")
    ledger = engine.hbm_ledger()["components"]
    log(f"[int8serve] (a) {card}: the int8 engine up in {init_s:.1f} s; its {n_tables} int8 tables and scales equal "
        f"the server-side quantization of the trainer's bf16 export bit for bit; hbm_ledger params "
        f"{ledger['params'] / 1e9:.3f} GB, kv_page_pool {ledger['kv_page_pool'] / 1e9:.3f} GB")
    ref = srv_ref = loop = None
    srv = ServerThread(scfg, engine=engine)
    try:
        srv.start()
        q = _serve_waves("int8serve", srv, engine, card)
        # (b) the same waves on bf16 weights (int8 pages too), same process
        ref_cfg = dataclasses.replace(scfg, quantization="none")
        ref = DecodeEngine(ref_cfg, params=export, model_cfg=mcfg)
        srv_ref = ServerThread(ref_cfg, engine=ref)
        srv_ref.start()
        b = _serve_waves("int8serve/bf16", srv_ref, ref, card)
        ref_ledger = ref.hbm_ledger()["components"]
        same = sum(x == y for x, y in zip(q["tokens"], b["tokens"]))
        log(f"[int8serve] (b) {card}: ms per decode step int8 {q['ms_per_step']:.2f} against bf16 "
            f"{b['ms_per_step']:.2f} (device stream; wall {q['wall_ms_per_step']:.2f} / {b['wall_ms_per_step']:.2f}); "
            f"dispatch share {q['dispatch_share']:.1%} / {b['dispatch_share']:.1%}; hbm_ledger params "
            f"{ledger['params'] / 1e9:.3f} GB against {ref_ledger['params'] / 1e9:.3f} GB; {same}/32 responses "
            "token for token the same on both")
        # (c) the refusals: a q8 update to the bf16 server, a fold into the int8 engine
        before = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
        rclient = RemoteTorchEngine(InferenceEngineConfig(request_timeout=120, request_retries=1),
                                    addresses=[srv_ref.address])
        rclient.initialize()
        try:
            t0 = time.monotonic()
            try:
                rclient.update_weights(WeightUpdateMeta(type="mem", wire_format="q8"), params=export)
                raise AssertionError("[int8serve] (c) the bf16 server took a q8 update")
            except RuntimeError as e:
                refused_s, why = time.monotonic() - t0, _http_reason(e)
        finally:
            rclient.destroy()
        changed = [n for n, p in ref.model.named_parameters() if not torch.equal(p, before[n])]
        if changed or ref.get_version() != 0 or ref._staged is not None:
            raise AssertionError(f"[int8serve] (c) the refused q8 update changed {changed[:3]}, version "
                                 f"{ref.get_version()}")
        del before
        srv_ref.stop()
        srv_ref = ref = None
        gc.collect()
        before = {n: p.detach().clone() for n, p in engine.model.named_parameters()}
        lora = {f"layers/wq_lora_{s}": torch.zeros(shape, device="cuda")
                for s, shape in (("a", (L, mcfg.hidden_size, LORA_RANK)), ("b", (L, LORA_RANK, mcfg.q_dim)))}
        try:
            engine.update_weights_lora(lora, 0.5, version=1)
            raise AssertionError("[int8serve] (c) the int8 engine folded adapters")
        except RuntimeError as e:
            fold_why = str(e)
        changed = [n for n, p in engine.model.named_parameters() if not torch.equal(p, before[n])]
        if changed or "int8" not in fold_why or engine.get_version() != 0:
            raise AssertionError(f"[int8serve] (c) the refused fold: {fold_why!r}, changed {changed[:3]}")
        del before
        log(f"[int8serve] (c) the q8 update to the bf16 server refused in {refused_s:.2f} s ({why[:90]}...), its "
            f"weights and version unchanged; the adapter fold into the int8 engine refused ({fold_why[:60]}...), "
            "no weight changed")

        # (d) PPOTrainer over HTTP, the q8 wire
        torch.cuda.reset_peak_memory_stats()
        loop, client, gconfig, rec = _item4_loop("int8serve", trainer, acfg, srv, scfg, seed=2)
        wire = loop.weight_update_meta.wire_format
        if wire != "q8":
            raise AssertionError(f"[int8serve] (d) weight_update_wire='auto' resolved to {wire!r} against an int8 fleet")
        checks = []
        commit = loop.stats_logger.commit

        def commit_checked(epoch, step, global_step, stats):
            want = global_step + 1
            versions = (_health_version(srv.address), client.get_version(), trainer.get_version())
            master = {n: p.detach() for n, p in trainer.model.named_parameters()}
            bad = _int8_unequal(engine, master, tables_from=lambda w: w)
            checks.append((versions, len(bad)))
            rec["stats"].append(dict(stats))
            if versions != (want, want, want) or bad:
                raise AssertionError(f"[int8serve] (d) step {global_step}: versions {versions}, want {want}; {len(bad)} "
                                     f"served tensors differ from the q8 wire's transform of the master weights "
                                     f"(first {bad[:3]})")
            commit(epoch, step, global_step, stats)

        loop.stats_logger.commit = commit_checked
        kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
        bytes0 = client._metrics.update_bytes.get()
        # main path: counts to 0 just before, read just after
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        t0 = time.monotonic()
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        wall = time.monotonic() - t0
        _drain_client(client, engine)
        counts = [k.launches for k in kernels]
        launches1 = paged_attention_stacked.launches
        staged = (client._metrics.update_bytes.get() - bytes0) / ITEM4_STEPS
        bf16_bytes = sum(client._wire_nbytes(n, p) for n, p in trainer._export_params().items())
        q8_reckoned = sum(client._wire_nbytes(n, p) for n, p in
                          qwen.quantize_params_int8(trainer._export_params()).items())
    finally:
        if loop is not None:
            loop.close()
        for s in (srv, srv_ref):
            if s is not None:
                s.stop()
        shutil.rmtree(ITEM4_ROOT, ignore_errors=True)
    if len(checks) != ITEM4_STEPS:
        raise AssertionError(f"[int8serve] (d) {len(checks)} steps, want {ITEM4_STEPS}")
    _flash_counts_check("int8serve", counts, rec, L)
    if launches1 == 0 or launches1 % L:
        raise AssertionError(f"[int8serve] (d) #1 launches {launches1}, not a positive multiple of {L}")
    ratio = staged / bf16_bytes
    if abs(ratio - q8_reckoned / bf16_bytes) > 0.01 * ratio:
        raise AssertionError(f"[int8serve] (d) q8 wire {staged / 1e9:.3f} GB over bf16 {bf16_bytes / 1e9:.3f} GB = "
                             f"{ratio:.4f}, not within 1% of the shapes' {q8_reckoned / bf16_bytes:.4f}")
    for i, s in enumerate(rec["stats"]):
        log(f"[int8serve] (d) {card}: step {i}: {s['step_secs']:.2f} s; rollout_wait {s['phase/rollout_wait_s']:.2f} "
            f"s, ppo_update {s['timing/train_step']:.2f} s, weight_publish {s['phase/weight_publish_s']:.2f} s (stage "
            f"{s['update_weights_stage_secs']:.2f} s, commit fence {s['update_weights_pause_secs'] * 1e3:.1f} ms); "
            f"loss {s['ppo_actor/loss']:.6f} grad_norm {s['ppo_actor/grad_norm']:.4f}")
    tokens = sum(rec["tokens"])
    log(f"[int8serve] (d) {card}: wire 'auto' -> q8; {staged / 1e9:.4f} GB staged a q8 update (reckoned "
        f"{q8_reckoned / 1e9:.4f} GB) against {bf16_bytes / 1e9:.4f} GB in bf16: {ratio:.4f} (the shapes' "
        f"{q8_reckoned / bf16_bytes:.4f}; {Q8_RATIO} at Qwen2.5-1.5B); "
        "after each step the served int8 tables equal the q8 transform of the trainer's f32 master weights bit for "
        f"bit and every other leaf its bf16 cast; K2 / K3 / K4 launches {counts}; #1 launches {launches1}; trainer "
        f"{tokens / sum(rec['ppo_s']):.0f} tokens/s; the loop {wall:.1f} s")
    log(f"[int8serve] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    stage_s = [s["update_weights_stage_secs"] for s in rec["stats"]]
    fence_s = [s["update_weights_pause_secs"] for s in rec["stats"]]
    del loop, trainer, engine
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                launches1=launches1 + q["launches1"], launches3=q["launches3"], int8=q, bf16=b,
                params_bytes=ledger["params"], bf16_params_bytes=ref_ledger["params"], q8_bytes=staged,
                bf16_bytes=bf16_bytes, ratio=ratio, stage_s=stage_s, fence_s=fence_s)


def _fold_share(trainer, engine, n_folds: int) -> float:
    """The served weights of a server that started from the bf16 cast of the
    adapter-free base and folded ``n_folds`` adapter pushes, against the
    trainer's merged export: every leaf that no adapter targets equals the
    merged leaf's bf16 cast bit for bit (else inf); on a target the worst
    element's share of its bound, half a bf16 step for the first cast and
    for each fold (each rounds once; the step of the largest of the base,
    the merged and the served value), plus the adapters' own rounding to
    bf16 on the wire (2^-8 relative each) through scale |B| @ |A|."""
    cfg = trainer.model_cfg
    scale = cfg.lora_alpha / cfg.lora_rank
    params = dict(trainer.model.named_parameters())
    served = dict(engine.model.named_parameters())
    worst = 0.0
    for n, w in trainer._export_params().items():
        if n.rsplit(".", 1)[-1] not in cfg.lora_targets:
            if not torch.equal(served[n], w.to(torch.bfloat16)):
                return float("inf")
            continue
        # each rounding's step: of the largest value along the way
        mag = torch.maximum(torch.maximum(w.abs(), params[n].detach().abs()), served[n].float().abs())
        step = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0**-126))) - 7)
        a, b = params[f"{n}_lora_a"].detach().abs(), params[f"{n}_lora_b"].detach().abs()
        bound = 0.5 * (n_folds + 1) * step + scale * 2.0**-7 * (b @ a)
        worst = max(worst, ((served[n].float() - w).abs() / bound).max().item())
    return worst


def phase_lora(card: str) -> dict:
    """LoRA at Qwen2.5-1.5B, full width and ``CUT_LAYERS`` of its depth
    (since the serve_tp phase came) (``gsm8k_grpo_lora.yaml``:
    rank 32, alpha 16, targets wq / wk / wv / wo over the grpo phase's
    actor): a server started from the trainer's adapter-free export,
    ``PPOTrainer.train`` for 2 steps over HTTP whose pushes carry only the
    adapters (``lora_only``: the server folds them into its base), one more
    adapter push timed beside a full push, then an adapter push after that
    full push (refused, no weight changed). Checks the base parameters bit
    for bit after the steps, the adapters moved, the served weights against
    the merged export within bf16 rounding, K2-K4 / #1 launches; prints the
    bytes and seconds of each push, trainer tokens/s and the peak memory."""
    import shutil

    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[lora] {held:.2f} GiB still allocated by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    L = mcfg.num_layers
    acfg = _grpo_actor(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA, lora_targets=list(LORA_TARGETS))
    trainer = TorchTrainEngine(acfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=ITEM4_PROMPTS, train_batch_size=8), seed=0)
    params = dict(trainer.model.named_parameters())
    n_adapter = sum(p.numel() for n, p in params.items() if "_lora_" in n)
    export = trainer._export_params()
    if any("_lora_" in n for n in export) or any(not torch.equal(export[n], params[n]) for n in export):
        raise AssertionError("[lora] the export at B = 0 is not the adapter-free base")
    base0 = {n: p.detach().cpu() for n, p in params.items() if "_lora_" not in n}
    b0 = {n: p.detach().clone() for n, p in params.items() if n.endswith("_lora_b")}
    scfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                        weight_stage_target="device", host="127.0.0.1", seed=0)
    engine = DecodeEngine(scfg, params=export, model_cfg=mcfg)
    del export
    loop = None
    srv = ServerThread(scfg, engine=engine)
    try:
        srv.start()
        loop, client, gconfig, rec = _item4_loop("lora", trainer, acfg, srv, scfg, seed=4,
                                                 client_kw=dict(request_retries=1))
        meta = dataclasses.replace(loop.weight_update_meta, lora_only=True)
        loop.weight_update_meta = meta
        trainer.connect_engine(client, meta)
        commit = loop.stats_logger.commit

        def commit_recorded(epoch, step, global_step, stats):
            want = global_step + 1
            versions = (_health_version(srv.address), client.get_version(), trainer.get_version())
            rec["stats"].append(dict(stats))
            if versions != (want, want, want):
                raise AssertionError(f"[lora] step {global_step}: versions {versions}, want {want}")
            commit(epoch, step, global_step, stats)

        loop.stats_logger.commit = commit_recorded
        kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
        bytes0 = client._metrics.update_bytes.get()
        # main path: counts to 0 just before, read just after
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        t0 = time.monotonic()
        loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
        wall = time.monotonic() - t0
        _drain_client(client, engine)
        counts = [k.launches for k in kernels]
        launches1 = paged_attention_stacked.launches
        loop_bytes = client._metrics.update_bytes.get() - bytes0
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the base bit for bit, the adapters moved
        moved_base = [n for n, p in trainer.model.named_parameters() if n in base0 and not torch.equal(p.cpu(), base0[n])]
        moved_b = max(float((params[n].detach() - t).abs().max()) for n, t in b0.items())
        del base0
        if moved_base or not moved_b > 0:
            raise AssertionError(f"[lora] base parameters moved: {moved_base[:3]}; the adapters' B moved {moved_b}")
        # one more adapter push, timed, then a full push
        pushes = {}
        for kind, m in (("lora", meta), ("full", dataclasses.replace(meta, lora_only=False))):
            b_before = client._metrics.update_bytes.get()
            t0 = time.monotonic()
            trainer.update_weights(m)
            pushes[kind] = dict(bytes=client._metrics.update_bytes.get() - b_before, s=time.monotonic() - t0,
                                stage_s=client.last_stage_secs, fence_s=client.last_pause_secs)
            if kind == "lora":
                worst = _fold_share(trainer, engine, n_folds=ITEM4_STEPS + 1)
                if worst > 1.0:
                    raise AssertionError(f"[lora] the served weights after the adapter pushes part from the merged "
                                         f"export by {worst:.3f} of their bound")
        # a second adapter push after the full push: refused, nothing changes
        before = {n: p.detach().clone() for n, p in engine.model.named_parameters()}
        v_before = engine.get_version()
        try:
            trainer.update_weights(meta)
            raise AssertionError("[lora] an adapter push after a full push was folded")
        except RuntimeError as e:
            refusal = _http_reason(e)
        changed = [n for n, p in engine.model.named_parameters() if not torch.equal(p, before[n])]
        if changed or engine.get_version() != v_before:
            raise AssertionError(f"[lora] the refused push changed {changed[:3]}, version {engine.get_version()}")
        del before
        _drain_client(client, engine)
    finally:
        if loop is not None:
            loop.close()
        srv.stop()
        shutil.rmtree(ITEM4_ROOT, ignore_errors=True)
    if len(rec["stats"]) != ITEM4_STEPS:
        raise AssertionError(f"[lora] {len(rec['stats'])} steps, want {ITEM4_STEPS}")
    _flash_counts_check("lora", counts, rec, L)
    if launches1 == 0 or launches1 % L:
        raise AssertionError(f"[lora] #1 launches {launches1}, not a positive multiple of {L}")
    for i, s in enumerate(rec["stats"]):
        log(f"[lora] {card}: step {i}: {s['step_secs']:.2f} s; rollout_wait {s['phase/rollout_wait_s']:.2f} s, "
            f"ppo_update {s['timing/train_step']:.2f} s, weight_publish {s['phase/weight_publish_s']:.2f} s (an "
            f"adapter push: fence {s['update_weights_pause_secs'] * 1e3:.1f} ms); loss {s['ppo_actor/loss']:.6f} "
            f"grad_norm {s['ppo_actor/grad_norm']:.4f}")
    tokens = sum(rec["tokens"])
    lo, fu = pushes["lora"], pushes["full"]
    log(f"[lora] {card}: {n_adapter / 1e6:.3f} M adapter parameters; the loop's pushes {loop_bytes / 1e6:.2f} MB in "
        f"{ITEM4_STEPS}; an adapter push {lo['bytes'] / 1e6:.2f} MB in {lo['s']:.3f} s (encode {lo['stage_s'] * 1e3:.1f} "
        f"ms, fence {lo['fence_s'] * 1e3:.1f} ms) against a full push {fu['bytes'] / 1e9:.3f} GB in {fu['s']:.2f} s "
        f"(stage {fu['stage_s']:.2f} s, fence {fu['fence_s'] * 1e3:.1f} ms); after the adapter pushes the served "
        f"targets at {worst:.3f} of their bf16 rounding bound from the merged export, the rest its bf16 cast bit for "
        f"bit; base bit for bit, B moved by up to {moved_b:.3g}; the "
        f"adapter push after the full push refused ({refusal[:70]}...), no weight changed")
    log(f"[lora] {card}: trainer {tokens / sum(rec['ppo_s']):.0f} tokens/s ({tokens} tokens in "
        f"{sum(rec['ppo_s']):.2f} s of ppo_update, the first step carrying the process's one-time cost when it trains "
        f"first); K2 / K3 / K4 launches {counts}; #1 launches {launches1}; the loop {wall:.1f} s; peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB (predicted {LORA_PEAK_DROP_PREDICTED_GIB:.0f} GiB below "
        "grpo's)")
    log(f"[lora] {card}: the phase took {time.monotonic() - t_phase:.1f} s")
    del loop, trainer, engine
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                launches1=launches1, peak_gib=peak, tokens_per_s=tokens / sum(rec["ppo_s"]),
                lora_push=lo, full_push=fu, n_adapter=n_adapter)


def _distinct_prefixes(seqs) -> int:
    """Trie nodes counted independently of ``build_tree``: the number of
    distinct (prefix + token) sequences."""
    return len({tuple(s[: i + 1]) for s in seqs for i in range(len(s))})


def phase_train_tree(card: str) -> dict:
    """The tree path: ``train``'s two GRPO steps with ``tree_training=True``
    and one minibatch per step, so each prompt's 4 samples share one trie
    (the reference's balanced minibatch split does not keep groups whole).
    Forward and backward run once per trie node through #4-#6; the proximal
    recompute stays on K2. Checks the dedup counts against an independent
    host count, the launches per pack, and the tree path's logprobs and grad
    norm against the packed path's (K2-K4) on the same batch and weights."""
    from areal_tpu_torch.models.tree import pack_forest
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops import tree_attention as ta

    kernels = (ta.tree_attention_fwd, ta.tree_attention_bwd_dq, ta.tree_attention_bwd_dkv, fa.flash_attention_fwd,
               fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    r = _grpo_run("train_tree", kernels, model={**QWEN25_15B, "num_layers": CUT_LAYERS},
                  name=f"Qwen2.5-1.5B ({CUT_LAYERS} of 28 layers)", tree_training=True, ppo_n_minibatches=1)
    cfg, trainer, actor, adv, parts = (r[k] for k in ("cfg", "trainer", "actor", "adv", "parts"))
    L = r["mcfg"].num_layers
    n_packs = 0
    for step, (batch, s) in enumerate(zip(r["batches"], r["stats"])):
        lens = np.asarray(batch["attention_mask"]).sum(-1)
        seqs = [np.asarray(batch["input_ids"])[b, : lens[b]].tolist() for b in range(len(lens))]
        nodes = _distinct_prefixes(seqs)
        packs = pack_forest(seqs, cfg.tree_node_budget, cfg.group_size)
        n_pads = [b["node_ids"].shape[0] for b in trainer._make_tree_batches(batch)[0]]
        n_packs += len(packs)
        log(f"[train_tree] wave {step}: {int(lens.sum())} tokens -> {nodes} trie nodes (independent count; "
            f"dedup {int(lens.sum()) / nodes:.3f}x) in {len(packs)} packs of "
            f"{[p.n_nodes for p, _ in packs]} nodes, n_pad {n_pads}")
        if (s["tree_tokens"], s["tree_nodes"]) != (float(lens.sum()), float(nodes)):
            raise AssertionError(f"[train_tree] wave {step}: engine counted {s['tree_tokens']} tokens / "
                                 f"{s['tree_nodes']} nodes, the host {int(lens.sum())} / {nodes}")
        if s["n_microbatches"] != len(packs):
            raise AssertionError(f"[train_tree] wave {step}: {s['n_microbatches']} microbatches, {len(packs)} packs")
    counts = r["counts"]
    want = [2 * L * n_packs, L * n_packs, L * n_packs, L * r["n_fwd_grids"], 0, 0]
    log(f"[train_tree] launches: #4 {counts[0]} (= {2 * L} x {n_packs} packs, forward and its recompute), "
        f"#5 {counts[1]}, #6 {counts[2]} (= {L} x {n_packs}); K2 {counts[3]} (= {L} x {r['n_fwd_grids']} "
        f"proximal-recompute grids), K3 {counts[4]}, K4 {counts[5]}")
    if counts != want:
        raise AssertionError(f"[train_tree] launch counts {counts} != {want}")
    ppo_s = parts["ppo_update"]
    tokens = r["trained_tokens"]
    node_total = sum(s["tree_nodes"] for s in r["stats"])
    log(f"[train_tree] {card}: rollout {parts['rollout']:.2f} s, proximal recompute "
        f"{parts['prox_recompute']:.2f} s, ppo_update {ppo_s:.2f} s (steps: "
        + ", ".join(f"{t:.2f} s" for t in r["ppo_update_s"]) + f"), weight update {parts['weight_update']:.3f} s; "
        f"trainer {tokens / ppo_s:.0f} tokens/s, {node_total / ppo_s:.0f} nodes/s ({tokens} tokens, "
        f"{node_total:.0f} nodes)")

    # one more tree optimizer step on the last batch, profiled
    prof = _profile(lambda: trainer.train_batch(adv, actor._loss_fn, _wfn), "tree optimizer step", card)
    busy, shares = prof["busy"], _tree_shares(prof)

    # the tree path against the packed path on the same batch at the same
    # weights, the proximal logprobs recomputed (PPO ratio ~1)
    batch = r["batches"][-1]
    batch["prox_logp"] = actor.compute_logp(batch)  # packed forward (K2)
    adv = actor.compute_advantages(batch)
    tree_cfg = trainer.config
    lens = np.asarray(batch["attention_mask"]).sum(-1)
    seqs = [np.asarray(batch["input_ids"])[b, : lens[b]] for b in range(len(lens))]
    tree_logp = np.zeros_like(batch["prox_logp"])
    with torch.no_grad():
        for host, (_, rows) in zip(trainer._make_tree_batches(batch)[0],
                                   pack_forest(seqs, tree_cfg.tree_node_budget, tree_cfg.group_size)):
            out = trainer._tree_outputs_fn(trainer._tree_batch_to_device(host))["logprobs"].float().cpu().numpy()
            for i, b in enumerate(rows):  # label-aligned: position t scores token t + 1
                tree_logp[b, 1 : lens[b]] = out[i, : lens[b] - 1]
    gen = np.asarray(batch["loss_mask"]) > 0
    logp_gap = float(np.abs(tree_logp[gen] - batch["prox_logp"][gen]).max())
    norms = {}
    for tree in (True, False):
        trainer.config = dataclasses.replace(tree_cfg, tree_training=tree)
        trainer.zero_grad()
        norms["tree" if tree else "packed"] = trainer.compute_grads(adv, actor._loss_fn, _wfn)["grad_norm"]
    trainer.config = tree_cfg
    trainer.zero_grad()
    rel = abs(norms["tree"] - norms["packed"]) / norms["packed"]
    log(f"[train_tree] same batch and weights, proximal logprobs recomputed: tree vs packed logprobs on "
        f"{int(gen.sum())} generated tokens max|diff| {logp_gap:.4f} (tol {LOGPROB_TOL}); grad_norm tree "
        f"{norms['tree']:.5f}, packed {norms['packed']:.5f}, relative diff {rel:.2e} (tol {GRAD_NORM_RTOL})")
    if not logp_gap <= LOGPROB_TOL or not rel <= GRAD_NORM_RTOL:
        raise AssertionError("[train_tree] the tree path disagrees with the packed path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train_tree] {card}: peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    del trainer, actor, r
    torch.cuda.empty_cache()
    return dict(counts=dict(zip(("tree_attention_fwd", "tree_attention_bwd_dq", "tree_attention_bwd_dkv"), counts)),
                parts=parts, tokens_per_s=tokens / ppo_s, nodes_per_s=node_total / ppo_s, busy=busy,
                shares=shares, peak_gib=peak, logp_gap=logp_gap, norms=norms)


# the grouped matmul vs its plain version, element by element: the same f32
# products (bf16 inputs are exact in f32) summed in other orders. f32
# rounding over k terms stays far inside GMM_REL of the sum of the terms'
# magnitudes (|lhs| @ |rhs| per element), while an output rounded to bf16,
# a group multiplied by the next expert's weights or a row moved across a
# group boundary miss it by GMM_FAULT_MIN or more. Rows past
# sum(group_sizes) must be exact zeros.
GMM_REL = 2**-20
GMM_FAULT_MIN = 10.0


def _gmm_share(got, ref, mag, used: int) -> float:
    """Worst grouped row element of |got - ref| as a share of GMM_REL * mag
    (passes at <= 1); a nonzero row past the groups counts as infinite."""
    if torch.count_nonzero(got[used:]).item():
        return math.inf
    return ((got[:used] - ref[:used]).abs() / (GMM_REL * mag[:used]).clamp_min(1e-30)).max().item()


def _gmm_routing(M: int, E: int, K: int, g) -> torch.Tensor:
    """Group sizes of M / K tokens routed by a top-K softmax over E experts
    (seeded normal logits)."""
    probs = torch.softmax(torch.randn((M // K, E), generator=g, device="cuda"), dim=-1)
    top = torch.topk(probs, K, dim=-1).indices.reshape(-1)
    return torch.bincount(top, minlength=E).to(torch.int32)


def _gmm_bound(M: int, k: int, n: int, sizes: torch.Tensor, elem: int = 2) -> tuple[float, str]:
    """Least time of one call on these inputs: the grouped rows of lhs read
    once, the weights of the experts with rows read once, the whole f32
    output (zeros past the groups included) and the sizes written / read
    once; 2 flops per multiply-add of the grouped rows at the bf16
    tensor-core rate."""
    touched, used = int((sizes > 0).sum()), int(sizes.sum())
    nbytes = used * k * elem + touched * k * n * elem + M * n * 4 + sizes.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * used * k * n / PEAK_OPS["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gmm_library(lhs, rhs, sizes, ref, mag):
    """The yardstick (the port never calls it): ``torch._grouped_mm`` with an
    f32 output where this torch runs it and it agrees with the plain version
    (the same function), else a loop of ``torch.mm`` (f32 out) over the
    groups, sizes read once outside the timed calls. Returns (name, fn of
    the weight stack, the bf16-output grouped call or None): with a bf16
    output ``torch._grouped_mm`` computes another function (half the output
    bytes, one more rounding), a reading only."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    ends = offs.tolist()

    def loop(w):
        a = 0
        for g_, b in enumerate(ends):
            if b > a:
                torch.mm(lhs[a:b], w[g_], out_dtype=torch.float32)
            a = b

    found = {}
    for out_dtype in (torch.float32, torch.bfloat16) if hasattr(torch, "_grouped_mm") else ():
        try:
            out = torch._grouped_mm(lhs, rhs, offs=offs, out_dtype=out_dtype)
        except (RuntimeError, TypeError, ValueError) as e:
            log(f"[kernel_gmm] torch._grouped_mm, {str(out_dtype)[6:]} out: not usable here "
                f"({str(e).splitlines()[0][:100]})")
            continue
        if out_dtype == torch.float32:
            share = _gmm_share(out, ref, mag, int(sizes.sum()))
            if share > 1.0:
                log(f"[kernel_gmm] torch._grouped_mm, f32 out, disagrees with the plain version ({share:.2f} x "
                    "the limit)")
                continue
        found[out_dtype] = functools.partial(torch._grouped_mm, lhs, offs=offs, out_dtype=out_dtype)
    if torch.float32 in found:
        return "torch._grouped_mm", found[torch.float32], found.get(torch.bfloat16)
    return "loop of torch.mm", loop, found.get(torch.bfloat16)


def _gmm_inputs():
    """kernel_gmm's inputs, one (shape, projection) at a time, from one
    seeded generator: Qwen3-30B-A3B's experts (E=128, top-8), (k, n) =
    (2048, 768) for gate / up and (768, 2048) for down, routed by a seeded
    top-8 softmax, at M = 256 (a decode step of 32 slots: the roles-swapped
    regime), 32,768 (a prefill group of 8 x 512 tokens), 8 x the tokens of
    train_moe's minibatch grid and 8 x 1,024 (a 1,024-token microbatch,
    groups of ~64 rows: where 128-row tiles overtake 64), the two training
    shapes with 64 rows past the groups as kernel_gmm_bwd's; bf16 lhs and
    three bf16 weight stacks (cycled in the timed calls, so each call finds
    its weights cold in the 50 MB L2 as the 48 layers do). Yields (shape,
    projection, sizes, lhs, stacks)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    mc = QWEN3_30B_A3B
    E, K, D, Fm = mc["num_experts"], mc["num_experts_per_tok"], mc["hidden_size"], mc["moe_intermediate_size"]
    for sname, M, past in (("decode", 32 * K, 0), ("prefill", 8 * 512 * K, 0),
                           ("train", _train_moe_grid_tokens() * K, 64), ("small", 1024 * K, 64)):
        sizes = _gmm_routing(M - past, E, K, g)
        for proj, (k, n) in (("gate_up", (D, Fm)), ("down", (Fm, D))):
            lhs = torch.randn((M, k), generator=g, device="cuda").bfloat16()
            stacks = [(0.02 * torch.randn((E, k, n), generator=g, device="cuda")).bfloat16() for _ in range(3)]
            yield sname, proj, sizes, lhs, stacks
            del lhs, stacks
            torch.cuda.empty_cache()


# the expert ranks' grouped matmuls (moe_ep): rank 0 of an expert axis of e
# holds E / e of the 128 experts, and its dispatch hands the kernels every one
# of the T x K routed rows, its own experts' first and the others past the
# groups (about (1 - 1/e) of M)
GMM_EP_SIZES = (2, 4)
EP_SHAPE_FIELDS = ("used", "groups", "zero_items", "grid_items")  # an expert rank's shape's extra keys


def _gmm_ep_inputs(shapes: tuple, backward: bool = False):
    """The expert ranks' inputs, one (shape, e, projection) at a time, from
    one seeded generator: M = T x 8 rows at serve_moe's decode (32 slots)
    and prefill (8 x 512 tokens) and train_moe's grid, routed by a seeded
    top-8 softmax over all 128 experts; the group sizes of rank 0's E / e
    experts (sum(group_sizes) about M / e), bf16 lhs, three bf16 stacks of
    E / e experts, and with ``backward`` the f32 cotangent. Yields (shape,
    e, projection, sizes, lhs, stacks, grad or None)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    mc = QWEN3_30B_A3B
    E, K, D, Fm = mc["num_experts"], mc["num_experts_per_tok"], mc["hidden_size"], mc["moe_intermediate_size"]
    rows = {"decode": 32 * K, "prefill": 8 * 512 * K, "train": _train_moe_grid_tokens() * K}
    for sname in shapes:
        M = rows[sname]
        routed = _gmm_routing(M, E, K, g)
        for e in GMM_EP_SIZES:
            sizes = routed[: E // e].contiguous()
            for proj, (k, n) in (("gate_up", (D, Fm)), ("down", (Fm, D))):
                lhs = torch.randn((M, k), generator=g, device="cuda").bfloat16()
                stacks = [(0.02 * torch.randn((E // e, k, n), generator=g, device="cuda")).bfloat16()
                          for _ in range(3)]
                grad = torch.randn((M, n), generator=g, device="cuda") if backward else None
                yield sname, e, proj, sizes, lhs, stacks, grad
                del lhs, stacks, grad
                torch.cuda.empty_cache()


def _zero_items(sizes: torch.Tensor, M: int, tile: int) -> tuple[int, int]:
    """(work items that only write zeros past the groups, work items in the
    grid): a forward / dLHS grid of M / tile + E + 1 items, sized from M and
    E alone (``ops/gmm.py fwd_schedule``)."""
    from areal_tpu_torch.ops import gmm as gm

    items, grid = gm.fwd_schedule(sizes, M, gm.FWD_BN, tile)
    return sum(1 for g_, _, _, ct in items if g_ < 0 and ct == 0), grid[1]


def _gmm_timings(lhs, stacks, sizes, **kw) -> dict:
    """Device ms by CUDA-graph replay (``ms``) and the eager host loop beside
    it (``host_ms``) of the forward on these inputs, the weight stack
    cycling from call to call; ``kw`` forces a row tile or regime. Uses only
    the wrapper, so it runs any tree's kernel (``--gmm-times``)."""
    from areal_tpu_torch.ops import gmm as gm

    it = iter(range(10**9))

    def run():
        return gm.gmm(lhs, stacks[next(it) % 3], sizes, **kw)

    with torch.no_grad():
        return dict(ms=time_cuda_graph(run, iters=6, reps=3), host_ms=time_cuda(run, iters=10, warmup=2))


def _gmm_limit(lhs, rhs, sizes):
    """(the plain version's output, |lhs| @ |rhs|): the check's reference and
    the magnitudes its limit scales with."""
    from areal_tpu_torch.ops import gmm as gm

    return gm.gmm_plain(lhs, rhs, sizes), gm.gmm_plain(lhs.float().abs(), rhs.float().abs(), sizes)


def gmm_times() -> None:
    """``--gmm-times DIR``: the forward of the ``areal_tpu_torch`` under DIR (a
    tree unpacked with ``git archive``, say a parent commit's) at
    kernel_gmm's eight (shape, projection) pairs, in the regime DIR's wrapper
    picks, one JSON line a pair: its times (``_gmm_timings``), its worst
    element as a share of the limit against the plain version (``share``,
    reported, not checked) and a digest of its bits, so two trees' kernels
    compare by graph replay in one call."""
    from areal_tpu_torch.ops import gmm as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    for sname, proj, sizes, lhs, stacks in _gmm_inputs():
        with torch.no_grad():
            got = gm.gmm(lhs, stacks[0], sizes)
            share = _gmm_share(got, *_gmm_limit(lhs, stacks[0], sizes), int(sizes.sum()))
            line = dict(share=share, bits=_digest(got), M=lhs.shape[0], **_gmm_timings(lhs, stacks, sizes))
        del got
        print(json.dumps({"gmm_times": f"{sname}/{proj}", **line}), flush=True)


def _gmm_ep_case(what: str, lhs, stacks, sizes) -> dict:
    """One expert rank's forward against its plain version: the worst
    grouped element within its limit, the rows past the groups exact zeros,
    the same bits twice; the kernel by graph replay (the host loop beside
    it), the library yardstick on the grouped rows (the rows the function
    computes), the plain version at decode, the bound, and the share of the
    grid's work items that only write zeros."""
    from areal_tpu_torch.ops import gmm as gm

    M, k = lhs.shape
    E_loc, _, n = stacks[0].shape
    used = int(sizes.sum())
    rhs = stacks[0]
    got = gm.gmm(lhs, rhs, sizes)
    ref, mag = _gmm_limit(lhs, rhs, sizes)
    share = _gmm_share(got, ref, mag, used)
    err = (got - ref).abs().max().item()
    same = torch.equal(got, gm.gmm(lhs, rhs, sizes))
    bits = _digest(got)
    if not (share <= 1.0 and same):
        raise AssertionError(f"[kernel_gmm] {what}: off its plain version by {share:.3f} x the limit (rows past the "
                             f"groups included), the same bits twice: {same}")
    del got
    lib_name, lib_fn, lib_bf16 = _gmm_library(lhs[:used], rhs, sizes, ref[:used], mag[:used])
    del ref, mag
    t = _gmm_timings(lhs, stacks, sizes)
    it = iter(range(10**9))
    plain_ms = None
    if M <= 4096:
        plain_ms = time_cuda(lambda: gm.gmm_plain(lhs, stacks[next(it) % 3], sizes), iters=3, warmup=1)
    lib_ms = time_cuda_graph(lambda: lib_fn(stacks[next(it) % 3]), iters=3, reps=2)
    bf16_ms = time_cuda_graph(lambda: lib_bf16(stacks[next(it) % 3]), iters=6, reps=3) if lib_bf16 else None
    bound_ms, bound_by = _gmm_bound(M, k, n, sizes)
    tile = gm.pick_bf16_tile(M, E_loc)
    zero, items = _zero_items(sizes, M, tile)
    fmt = lambda x: f"{x:.4f} ms" if x is not None else "not timed"  # noqa: E731
    log(f"[kernel_gmm] {what}: M={M}, {used} rows in {E_loc} groups ({M - used} past them), k={k} n={n}; worst "
        f"element {share:.4f} of the limit (max|diff| {err:.3e}), rows past the groups zero, the same bits twice; "
        f"kernel={t['ms']:.4f} ms by graph replay (bf16_tile {tile}; host loop {t['host_ms']:.4f}); "
        f"plain={fmt(plain_ms)} {lib_name} on the {used} grouped rows={lib_ms:.4f} ms by graph replay; "
        f"torch._grouped_mm with a bf16 output (another function)={fmt(bf16_ms)}; bound={bound_ms:.4f} ms "
        f"({bound_by}); {zero} of the grid's {items} work items only write zeros ({zero / items:.1%})")
    return dict(max_abs_err=err, share=share, **t, plain_ms=plain_ms, library_ms=lib_ms, library=lib_name,
                grouped_mm_bf16_ms=bf16_ms, bound_ms=bound_ms, bound_by=bound_by, ms_by_tile={tile: t["ms"]},
                tile=tile, bits=bits, M=M, k=k, n=n, used=used, groups=E_loc, zero_items=zero, grid_items=items)


def phase_kernel_gmm() -> dict:
    """The grouped-matmul forward against its plain version at
    ``_gmm_inputs``' eight (shape, projection) pairs: the worst element as a
    share of GMM_REL |lhs| @ |rhs|, rows past the groups exact zeros, three
    planted faults missing the limit by GMM_FAULT_MIN; plus ragged cases
    (empty groups, a group of one row, k and n not multiples of 64, every
    row in one group) in every bf16 regime and f32 row tile. Reports the
    bf16 kernels' occupancy, the output's bits, and times the kernel by
    graph replay (the host loop beside it) in the regime the wrapper picks
    and in each forced one, the plain version (decode and prefill), the
    library yardstick and the bound. Then one ``moe_ffn`` at the decode
    shape under ``torch.cuda.set_sync_debug_mode("error")``: the dispatch
    never waits for the card. Between them, each bf16 regime timed at gate
    / up across M = 512 .. 16,384 (4 to 128 rows a group): the crossovers
    ``pick_bf16_tile`` sets."""
    from types import SimpleNamespace

    from areal_tpu_torch.models import moe, qwen
    from areal_tpu_torch.ops import gmm as gm

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products stay f32
    g = torch.Generator(device="cuda").manual_seed(0)
    mc = QWEN3_30B_A3B
    E, K, D, Fm = mc["num_experts"], mc["num_experts_per_tok"], mc["hidden_size"], mc["moe_intermediate_size"]
    occ = gm.fwd_occupancy()
    log("[kernel_gmm] bf16 kernels (rows a work item): " + "; ".join(
        f"{name} {o['registers']} registers, {o['local_bytes']} local (spill) bytes a thread, {o['smem_bytes']} B "
        f"shared memory a block, {o['blocks_per_sm']} blocks an SM" for name, o in occ.items()))
    per: dict[str, dict] = {"occupancy": occ}
    with torch.no_grad():
        # ragged cases, every bf16 regime and f32 row tile
        for M, k, n, sizes in ((203, 200, 72, [0, 1, 57, 0, 100, 3, 0, 30]), (77, 64, 136, [0, 0, 77, 0])):
            sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            for dt, key, tiles in ((torch.bfloat16, "bf16_tile", gm.BF16_TILES), (torch.float32, "tm", gm.TILES)):
                lhs = torch.randn((M, k), generator=g, device="cuda").to(dt)
                rhs = torch.randn((len(sizes), k, n), generator=g, device="cuda").to(dt)
                ref, mag = _gmm_limit(lhs, rhs, sz)
                shares = {t: _gmm_share(gm.gmm(lhs, rhs, sz, **{key: t}), ref, mag, sum(sizes)) for t in tiles}
                if not max(shares.values()) <= 1.0:
                    raise AssertionError(f"[kernel_gmm] M={M} k={k} n={n} sizes {sizes} {dt}: off its plain "
                                         f"version by {shares} x the limit")
                log(f"[kernel_gmm] ragged M={M} k={k} n={n} sizes {sizes} ({M - sum(sizes)} rows past the groups) "
                    f"{str(dt)[6:]}: worst element as a share of the limit, by {key} "
                    + ", ".join(f"{t}: {x:.4f}" for t, x in shares.items()))
        for sname, proj, sizes, lhs, stacks in _gmm_inputs():
            M, k = lhs.shape
            n = stacks[0].shape[2]
            used = int(sizes.sum())
            touched = int((sizes > 0).sum())
            rhs = stacks[0]
            got = gm.gmm(lhs, rhs, sizes)
            ref, mag = _gmm_limit(lhs, rhs, sizes)
            torch.cuda.synchronize()
            share = _gmm_share(got, ref, mag, used)
            err = (got - ref).abs().max().item()
            bits = _digest(got)
            if not share <= 1.0:
                raise AssertionError(f"[kernel_gmm] {sname} {proj}: off its plain version by {share:.3f} x "
                                     f"the limit (max|diff| {err:.3e})")
            again = gm.gmm(lhs, rhs, sizes)
            if not torch.equal(got, again):
                raise AssertionError(f"[kernel_gmm] {sname} {proj}: a second call gave other bits")
            del got, again
            big = int(sizes.argmax())
            moved = sizes.clone()
            first = int(torch.nonzero(sizes[:-1] > 0)[0])
            moved[first] -= 1
            moved[first + 1] += 1
            wrong = rhs.clone()
            wrong[big] = rhs[(big + 1) % E]
            faults = {
                "a group times the next expert's weights": lambda: gm.gmm_plain(lhs, wrong, sizes),
                "a row moved across a group boundary": lambda: gm.gmm_plain(lhs, rhs, moved),
                "output rounded to bf16": lambda: ref.bfloat16().float(),
            }
            fault_x = {f: _gmm_share(v(), ref, mag, used) for f, v in faults.items()}
            del faults, wrong
            for f, x in fault_x.items():
                if not x >= GMM_FAULT_MIN:
                    raise AssertionError(f"[kernel_gmm] {sname} {proj}: planted fault ({f}) only {x:.2f} x "
                                         f"the limit")
            lib_name, lib_fn, lib_bf16 = _gmm_library(lhs, rhs, sizes, ref, mag)
            del ref, mag
            tile = gm.pick_bf16_tile(M, E)
            t = _gmm_timings(lhs, stacks, sizes)
            by_tile = {tl: _gmm_timings(lhs, stacks, sizes, bf16_tile=tl)["ms"] for tl in gm.BF16_TILES}
            it = iter(range(10**9))
            plain_ms = None
            if sname in ("decode", "prefill"):  # no yardstick; too slow to time at the training shapes
                plain_ms = time_cuda(lambda: gm.gmm_plain(lhs, stacks[next(it) % 3], sizes), iters=3, warmup=1)
            lib_ms = time_cuda_graph(lambda: lib_fn(stacks[next(it) % 3]), iters=3, reps=2)
            lib_host_ms = time_cuda(lambda: lib_fn(stacks[next(it) % 3]), iters=5, warmup=1)
            bf16_ms = None
            if lib_bf16 is not None:
                bf16_ms = time_cuda_graph(lambda: lib_bf16(stacks[next(it) % 3]), iters=6, reps=3)
            bound_ms, bound_by = _gmm_bound(M, k, n, sizes)
            per[f"{sname}/{proj}"] = dict(max_abs_err=err, share=share, **t, plain_ms=plain_ms, library_ms=lib_ms,
                                          library_host_ms=lib_host_ms, library=lib_name,
                                          grouped_mm_bf16_ms=bf16_ms, bound_ms=bound_ms, bound_by=bound_by,
                                          ms_by_tile=by_tile, tile=tile, faults=fault_x, touched=touched, bits=bits,
                                          M=M, k=k, n=n)
            fmt = lambda x: f"{x:.4f} ms" if x is not None else "not timed"  # noqa: E731
            log(f"[kernel_gmm] {sname} {proj}: M={M} ({M - used} past the groups) k={k} n={n}, {touched} of {E} "
                f"experts touched; worst element {share:.4f} of the limit {GMM_REL:.3g} |lhs|@|rhs| (max|diff| "
                f"{err:.3e}), rows past the groups zero, the same bits twice ({bits}); planted faults "
                + ", ".join(f"{f} {x:.1f}" for f, x in fault_x.items())
                + f"; kernel={t['ms']:.4f} ms by graph replay (bf16_tile {tile}; host loop {t['host_ms']:.4f}; by "
                "bf16_tile " + ", ".join(f"{tl}: {x:.4f}" for tl, x in by_tile.items())
                + f") plain={fmt(plain_ms)} {lib_name}={lib_ms:.4f} ms by graph replay (host loop "
                f"{lib_host_ms:.4f}); torch._grouped_mm with a bf16 output (another function)={fmt(bf16_ms)}; "
                f"bound={bound_ms:.4f} ms ({bound_by}); {2 * used * k * n / t['ms'] / 1e9:.1f} TFLOP/s")
            del stacks, rhs, lhs
            torch.cuda.empty_cache()
        # the expert ranks' shapes: E / e groups, (1 - 1/e) of the rows past them
        for sname, e, proj, sizes, lhs, stacks, _ in _gmm_ep_inputs(("decode", "prefill", "train")):
            per[f"{sname}_e{e}/{proj}"] = _gmm_ep_case(f"{sname} e={e} {proj}", lhs, stacks, sizes)
            del stacks, lhs
        # each bf16 regime across the groups' average rows (gate / up): where
        # pick_bf16_tile's crossovers lie
        stacks = [(0.02 * torch.randn((E, D, Fm), generator=g, device="cuda")).bfloat16() for _ in range(3)]
        per["regimes"] = {}
        for M in (512, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384):
            sizes = _gmm_routing(M, E, K, g)
            lhs = torch.randn((M, D), generator=g, device="cuda").bfloat16()
            ms = {t: _gmm_timings(lhs, stacks, sizes, bf16_tile=t)["ms"] for t in gm.BF16_TILES}
            per["regimes"][M] = dict(ms_by_tile=ms, tile=gm.pick_bf16_tile(M, E))
            log(f"[kernel_gmm] regimes, gate/up at M={M} ({M / E:.0f} rows a group): by bf16_tile "
                + ", ".join(f"{t}: {x:.4f}" for t, x in ms.items())
                + f" ms by graph replay (picked: {gm.pick_bf16_tile(M, E)}; bound "
                f"{_gmm_bound(M, D, Fm, sizes)[0]:.4f})")
        del stacks, lhs
        # f32 inputs at the decode shape (the f32 twins' path)
        sizes = _gmm_routing(32 * K, E, K, g)
        lhs = torch.randn((32 * K, D), generator=g, device="cuda")
        rhs = 0.02 * torch.randn((E, D, Fm), generator=g, device="cuda")
        share = _gmm_share(gm.gmm(lhs, rhs, sizes), *_gmm_limit(lhs, rhs, sizes), int(sizes.sum()))
        if not share <= 1.0:
            raise AssertionError(f"[kernel_gmm] f32 decode: off its plain version by {share:.3f} x the limit")
        log(f"[kernel_gmm] f32 inputs, decode gate/up shape: worst element {share:.4f} of the limit")
        # the dispatch at the decode shape never waits for the card
        cfg = qwen.ModelConfig(**QWEN3_30B_A3B)
        layer = SimpleNamespace(
            w_router=(0.02 * torch.randn((D, E), generator=g, device="cuda")).bfloat16(),
            **{name: (0.02 * torch.randn(shape, generator=g, device="cuda")).bfloat16()
               for name, shape in (("we_gate", (E, D, Fm)), ("we_up", (E, D, Fm)), ("we_down", (E, Fm, D)))},
        )
        h = torch.randn((32, 1, D), generator=g, device="cuda").bfloat16()  # 32 slots
        moe.moe_ffn(h, layer, cfg)  # first calls (library handles) outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = moe.moe_ffn(h, layer, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not (out.shape == h.shape and torch.isfinite(out.float()).all()):
            raise AssertionError("[kernel_gmm] moe_ffn at the decode shape: bad output")
        log(f"[kernel_gmm] moe_ffn at the decode shape [32, 1, {D}] ran under "
            "torch.cuda.set_sync_debug_mode('error'): the dispatch never waits for the card")
        del layer, lhs, rhs
    torch.cuda.empty_cache()
    return per


# a served token of the MoE model may miss the dense check only where a
# route flipped at a near-tie: some layer's top-8 set differs between two
# passes of the same tokens, with the router's 8th-9th probability margin
# below ROUTE_GAP_TOL in both (bf16 noise of ~2^-8 relative on the router
# logits moves probabilities of ~1/128 by ~3e-5; ten times that, and a
# margin, sets the bound)
ROUTE_GAP_TOL = 1e-3


def _set_moe_trace(model, trace: list | None) -> list | None:
    """Set (a list) or clear (None) the routing trace of every MoE layer of
    ``model`` (``moe.moe_ffn_dropless``); returns ``trace``."""
    for layer in model.layers:
        layer.moe_trace = trace
    return trace


def _route_rows(trace: list, L: int, rows: list[tuple[int, int, int]]):
    """Per layer, the traced routes of the rows given as (call offset of the
    layer-0 call, first row, row count) concatenated: (top_e sorted along
    K, gap)."""
    tops, gaps = [], []
    for layer in range(L):
        t = [trace[c + layer][0][a : a + m] for c, a, m in rows]
        gp = [trace[c + layer][1][a : a + m] for c, a, m in rows]
        tops.append(torch.cat(t).sort(dim=-1).values)
        gaps.append(torch.cat(gp))
    return tops, gaps


def _route_flips(model, prompt: list[int], out: list[int], against=None):
    """Route flips between two passes over prompt + output, by row (row i
    holds token i, whose hidden state scores token i + 1): the served
    computation of this request replayed alone (a cold prefill of the prompt
    into fresh pages, then one paged decode step per output token,
    teacher-forced), against the dense prefill of the whole sequence (the
    pass ``_dense_diffs`` makes) or, given ``against``, against those
    routes (per layer, (top_e sorted along K, gap) for the same rows).
    Returns (near [rows] bool: a near-tie flip at some layer, far: flips with
    a margin of ROUTE_GAP_TOL or more, near-tie flips, the largest margin of
    a flipped route, total routes compared)."""
    from areal_tpu_torch.inference import paged_kv
    from areal_tpu_torch.models import qwen

    cfg, psz = model.cfg, 128
    L, P, n = cfg.num_layers, len(prompt), len(out)
    seq = prompt + out
    npg = -(-(P + n) // psz)
    cache = paged_kv.init_paged_cache(cfg, npg + 1, psz, device="cuda")
    pt = torch.arange(1, npg + 1, dtype=torch.int32, device="cuda")[None]
    trace = _set_moe_trace(model, [])
    try:
        with torch.no_grad():
            if against is None:
                qwen.forward_prefill(model, torch.tensor([seq], device="cuda"),
                                     torch.arange(P + n, device="cuda")[None])
            _, ks, vs = qwen.forward_prefill(model, torch.tensor([prompt], device="cuda"),
                                             torch.arange(P, device="cuda")[None])
            paged_kv.scatter_prefill(cache, ks, vs, pt[0, : -(-P // psz)], psz)
            del ks, vs
            for j in range(n):
                p = P - 1 + j
                qwen.forward_decode_paged(model, torch.tensor([seq[p]], device="cuda"),
                                          torch.tensor([p], device="cuda"), cache, pt, page_size=psz)
    finally:
        _set_moe_trace(model, None)
    off = 0 if against is not None else L
    dense = against if against is not None else _route_rows(trace, L, [(0, 0, P + n - 1)])
    # rows 0..P-2 from the prompt's prefill, row P-1+j from decode step j
    served = _route_rows(trace, L, [(off, 0, P - 1)] + [(off + L + j * L, 0, 1) for j in range(n)])
    near = torch.zeros(P + n - 1, dtype=torch.bool, device="cuda")
    far = n_near = 0
    worst = 0.0
    for (ta, ga), (tb, gb) in zip(zip(*dense), zip(*served)):
        diff = (ta != tb).any(-1)
        margin = torch.minimum(ga, gb)
        tie = margin < ROUTE_GAP_TOL
        near |= diff & tie
        far += int((diff & ~tie).sum())
        n_near += int((diff & tie).sum())
        if diff.any():
            worst = max(worst, margin[diff].max().item())
    return near.cpu().numpy(), far, n_near, worst, L * (P + n - 1)


def _moe_dense_check(model, prompt: list[int], r: dict, greedy: bool, what: str, replay: int = 0) -> dict:
    """``_dense_diffs`` with the near-tie rule: a token past LOGPROB_TOL is
    exempt only if a route flipped at a near-tie (``_route_flips``) at its
    row or an earlier one of the sequence (it attends their KV). ``replay``
    > 0 counts the flips over the first ``replay`` output tokens even when
    every token is within the tolerance (a reading)."""
    d = _dense_diffs(model, prompt, r, greedy)
    bad = d > LOGPROB_TOL
    res = dict(max=float(d.max()), exempt=0)
    if bad.any() or replay:
        n = len(d) if bad.any() else replay
        near, far, n_near, worst, total = _route_flips(model, prompt, r["output_tokens"][:n])
        P = len(prompt)
        reach = np.logical_or.accumulate(near)[P - 1 : P - 1 + n]  # a flip at or before the token's row
        res.update(near_flip_rows=int(near.sum()), rows=len(near), near_flips=n_near, far_flips=far,
                   worst_margin=worst, routes=total)
        bad, d = bad[:n], d[:n]
        if (bad & ~reach).any():
            raise AssertionError(f"[{what}] {int((bad & ~reach).sum())} tokens off the dense prefill by up to "
                                 f"{float(d[bad & ~reach].max()):.4f} (tol {LOGPROB_TOL}) with no near-tie "
                                 f"route flip at or before them ({int(near.sum())} near-tie flip rows, {far} "
                                 f"flips with a margin >= {ROUTE_GAP_TOL})")
        res["exempt"] = int(bad.sum())
    return res


def _moe_wave(srv, engine, bodies: list, n_first: int, L: int, what: str) -> tuple[list, dict]:
    """One wave (the first ``n_first`` requests alone, then the rest at
    once) with the kernels' counts set to 0 just before and read just
    after, held to the wave's forwards: gmm 3 x L per forward (decode steps
    and prefill / suffix forwards), kernel #1 L per decode step, kernel #3's
    chain L per warm suffix forward."""
    from areal_tpu_torch.ops.gmm import gmm
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa

    keys = ("decode_steps", "prefill_batches", "suffix_prefill_batches", "prefills", "prefill_tokens",
            "prefix_cache_hits", "prefix_hit_tokens", "generated_tokens")
    dev0 = engine.device_seconds()
    s0 = {k: engine.stats[k] for k in keys}
    # main path: counts to 0 just before, read just after
    gmm.launches = paged_attention_stacked.launches = 0
    for k in psa.launches:
        psa.launches[k] = 0
    t0 = time.monotonic()
    resps = _wave(srv.address, bodies[:n_first]) if n_first else []
    t1 = time.monotonic()
    resps += _wave(srv.address, bodies[n_first:])
    wall = time.monotonic() - t1
    counts = dict(gmm=gmm.launches, paged_attention=paged_attention_stacked.launches, **psa.launches)
    d = {k: engine.stats[k] - s0[k] for k in keys}
    dev1 = engine.device_seconds()
    want = dict(gmm=3 * L * (d["decode_steps"] + d["prefill_batches"]), paged_attention=L * d["decode_steps"],
                chain=L * d["suffix_prefill_batches"], tree=0)
    if counts != want or d["decode_steps"] == 0:
        raise AssertionError(f"[{what}] launch counts {counts} != {want} ({d})")
    for k in ("prefill_s", "prefill_tokens", "decode_s", "decode_steps"):
        d[f"dev_{k}"] = dev1[k] - dev0[k]
    d.update(counts=counts, wall=wall, first_wall=t1 - t0)
    log(f"[{what}] {len(resps)}/{len(bodies)} responses; launches gmm {counts['gmm']} = 3 x {L} layers x "
        f"({d['decode_steps']} decode steps + {d['prefill_batches']} prefill forwards, "
        f"{d['suffix_prefill_batches']} of them warm), kernel #1 {counts['paged_attention']} = {L} x "
        f"{d['decode_steps']}, kernel #3 chain {counts['chain']} = {L} x {d['suffix_prefill_batches']}")
    return resps, d


def phase_serve_moe(card: str) -> dict:
    """An ``InferenceServer`` over Qwen3-30B-A3B (full width, SERVE_MOE_LAYERS
    of its depth, random bf16 parameters from seed 0, built on the card) at the
    prefix-cache settings of ``ServerConfig()``: a cold wave of 16
    concurrent /generate requests, a warm wave of 8 sharing a 1,024-token
    system prompt (the first alone, then 7 radix hits: kernel #3's chain
    launches through the MoE layers), /flush_prefix_cache and the pool audit, a traced wave for the
    experts a decode step touches, and a profiled wave. Checks complete
    responses, served logprobs against a dense prefill (near-tie route
    flips exempt, counted), and every kernel's launches per wave."""
    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[serve_moe] before the model (earlier servers and engines stopped, allocator cache emptied): "
        f"torch.cuda.memory_allocated {held / 2**30:.2f} GiB")
    if held > 2 * 2**30:
        raise AssertionError(f"[serve_moe] {held / 2**30:.2f} GiB still held before the model")
    mcfg = qwen.ModelConfig(**{**QWEN3_30B_A3B, "num_layers": SERVE_MOE_LAYERS})
    L = mcfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve_moe] Qwen3-30B-A3B random weights (seed 0): {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, built in {time.monotonic() - t0:.1f}s")
    cfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                       host="127.0.0.1", seed=0)
    engine = DecodeEngine(cfg, params=model)  # the model itself: no second copy of the weights
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    out: dict = {}
    try:
        rng = np.random.default_rng(0)
        n_new = 128
        prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 16)]

        def body(p, i, n=n_new):
            sp = {"max_new_tokens": n, "greedy": True} if i % 2 == 0 else {"max_new_tokens": n, "temperature": 1.0}
            return {"input_ids": p, "sampling_params": sp}

        resps, d = _moe_wave(srv, engine, [body(p, i) for i, p in enumerate(prompts)], 0, L, "serve_moe")
        for r in resps:
            _check_response(r, n_new, "serve_moe")
        toks = sum(len(r["output_tokens"]) for r in resps)
        out.update(decode_tok_s=toks / d["wall"], ms_per_step=d["dev_decode_s"] / d["dev_decode_steps"] * 1e3,
                   prefill_tok_s=d["dev_prefill_tokens"] / d["dev_prefill_s"], cold_counts=d["counts"])
        log(f"[serve_moe] {card}: cold wave decode {out['decode_tok_s']:.1f} tok/s end to end ({toks} tokens, "
            f"{d['wall']:.2f} s wall incl. prefill); {out['ms_per_step']:.2f} ms per decode step (device stream, "
            f"S=32 slots, 16 active); prefill {out['prefill_tok_s']:.0f} tok/s (device stream, "
            f"{d['dev_prefill_tokens']} tokens in {d['prefill_batches']} forwards)")
        checks = [_moe_dense_check(model, prompts[i], resps[i], greedy=i % 2 == 0, what="serve_moe",
                                   replay=32 if i == 1 else 0)
                  for i in (0, 1, 2, 3)]
        c1 = checks[1]
        log(f"[serve_moe] served vs dense prefill of prompt + output: sampled logprobs max|diff| "
            f"{max(c['max'] for c in checks[1::2]):.4f}, greedy tokens' dense-logit gap to argmax "
            f"{max(c['max'] for c in checks[0::2]):.4f} (tol {LOGPROB_TOL}); near-tie exemptions "
            f"{sum(c['exempt'] for c in checks)}; request 1 (prompt + its first 32 output tokens) replayed "
            f"alone against a dense pass: {c1['near_flips']} of {c1['routes']} (row, layer) routes flipped at a "
            f"near-tie (margin < {ROUTE_GAP_TOL}; the largest margin of a flipped route {c1['worst_margin']:.2e}), "
            f"on {c1['near_flip_rows']} of {c1['rows']} rows; {c1['far_flips']} flipped with a larger margin")
        out["exempt"] = sum(c["exempt"] for c in checks)

        # warm wave: 8 requests sharing a 1,024-token system prompt
        rng = np.random.default_rng(3)
        system = rng.integers(0, mcfg.vocab_size, 1024).tolist()
        wprompts = [system + rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 257, 8)]
        # the first request runs alone and publishes the system prompt's
        # pages (16 new tokens: its decode steps are not the wave's point)
        wbodies = [body(wprompts[0], 0, 16)] + [body(p, i) for i, p in enumerate(wprompts) if i]
        wresps, wd = _moe_wave(srv, engine, wbodies, 1, L, "serve_moe_warm")
        for i, r in enumerate(wresps):
            _check_response(r, 16 if i == 0 else n_new, "serve_moe_warm")
        cached = [r["cached_prefix_tokens"] for r in wresps[1:]]
        if wd["suffix_prefill_batches"] <= 0 or min(cached) < len(system):
            raise AssertionError(f"[serve_moe_warm] warm requests missed the system prompt: {cached}, {wd}")
        wchecks = [_moe_dense_check(model, wprompts[i], wresps[i], greedy=i % 2 == 0, what="serve_moe_warm")
                   for i in (1, 2, 3, 4)]
        wtoks = sum(len(r["output_tokens"]) for r in wresps[1:])
        log(f"[serve_moe_warm] {card}: radix hits {wd['prefix_cache_hits']}, hit tokens {wd['prefix_hit_tokens']}; "
            f"7 warm requests {wtoks / wd['wall']:.1f} decode tok/s end to end; prefill {wd['dev_prefill_tokens']} "
            f"tokens in {wd['dev_prefill_s'] * 1e3:.1f} ms of device stream; vs dense prefill: max|diff| "
            f"{max(c['max'] for c in wchecks):.4f} (tol {LOGPROB_TOL}), near-tie exemptions "
            f"{sum(c['exempt'] for c in wchecks)}")
        out["exempt"] += sum(c["exempt"] for c in wchecks)
        out["warm_counts"] = wd["counts"]
        stats = _post(srv.address, "/flush_prefix_cache", {})
        audit = engine.pool_audit()
        if not (audit["ok"] and audit["radix_pages"] == 0
                and audit["free"] + audit["slot_pages"] + audit["radix_pages"] == audit["total"]):
            raise AssertionError(f"[serve_moe_warm] pool audit after the flush: {audit}")
        log(f"[serve_moe_warm] /flush_prefix_cache freed {stats['freed_pages']} pages; pool audit ok: free "
            f"{audit['free']} + slots {audit['slot_pages']} + radix {audit['radix_pages']} = {audit['total']}")

        # the experts a decode step touches: one short traced wave (the cold
        # prompts again, 16 new tokens); inactive slots are routed too
        trace = _set_moe_trace(model, [])
        try:
            _wave(srv.address, [body(p, i, 16) for i, p in enumerate(prompts)])
        finally:
            _set_moe_trace(model, None)
        touched = [int((torch.bincount(te.reshape(-1), minlength=mcfg.num_experts) > 0).sum())
                   for te, _ in trace if te.shape[0] == cfg.max_batch_size]
        out["experts_touched"] = float(np.mean(touched))
        log(f"[serve_moe] experts touched per layer per decode step (32 slots x top-8, 16 active): mean "
            f"{out['experts_touched']:.1f} of {mcfg.num_experts} over {len(touched)} layer calls (min "
            f"{min(touched)}, max {max(touched)})")
        del trace

        prof = _profile(lambda: _wave(srv.address, [body(p, i, 32) for i, p in enumerate(prompts)]),
                        "wave (16 requests x 32 new tokens)", card)
        gmm_us = _gmm_fwd_us(prof)
        out.update(busy=prof["busy"], gmm_share=gmm_us / prof["busy_us"])
        log(f"[profile]   gmm forward {gmm_us / 1e3:.2f} ms, {out['gmm_share']:.1%} of busy")
        _decode_share(prof)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[serve_moe] {card}: peak torch.cuda.max_memory_allocated {out['peak_gib']:.2f} GiB")
    finally:
        _set_moe_trace(model, None)
        srv.stop()
    del srv, engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the grouped matmul's backward kernels vs their plain versions, element by
# element on the f32 output: both multiply the f32 cotangent by the widened
# bf16 operand in f32; the kernels split the cotangent into bf16 hi + lo, which
# drops at most 2^-16 |grad| an element (u = 2^-8, squared), so each element
# stays inside GMM_BWD_REL of the sum of the terms' magnitudes (|grad| @
# |rhs|^T, |lhs|^T @ |grad|), plus the f32 rounding of two R-term sums in
# other orders (a random walk: sqrt(R) 2^-24 of it). A bf16 output may be
# one bf16 step (2^-7 of the plain value) further. Rows past
# sum(group_sizes) must be exact zeros.
GMM_BWD_REL = 2**-14
# planted faults must miss that limit by these factors. Dropping the lo half
# is a random walk of ~2^-9 relative errors: over millions of elements its
# worst one lands ~200 / sqrt(R) times the limit (R = 768..2048 here: 4-7x),
# so 2x; a wrong group or a row past the groups is off by the whole value.
GMM_BWD_FAULT_MIN = {"cotangent's lo half dropped": 2.0, "a group times the next expert's weights": 10.0,
                     "a row past the groups": 10.0}


def _bwd_share(got, ref, mag, reduce_len: int, bf16_out: bool, used: int | None = None) -> float:
    """Worst element of |got - ref| as a share of its limit; with ``used``
    (dLHS), a nonzero row past the groups counts as infinite."""
    if used is not None:
        if torch.count_nonzero(got[used:]).item():
            return math.inf
        got, ref, mag = got[:used], ref[:used], mag[:used]
    lim = (GMM_BWD_REL + math.sqrt(reduce_len) * 2**-24) * mag
    if bf16_out:
        lim = lim + 2**-7 * ref.abs()
    return ((got.float() - ref).abs() / lim.clamp_min(1e-30)).max().item()


def _train_moe_grid_tokens() -> int:
    """G x L of the first minibatch grid train_moe's trainer builds from one
    wave (the train phases' 32 sequences, two minibatches, rows of the
    bucketed longest sequence): the grouped matmuls see 8 times as many
    routed rows."""
    from areal_tpu_torch.api.config import PPOActorConfig
    from areal_tpu_torch.utils.data import MicroBatchSpec, round_up_to_bucket, split_padded_tensor_dict_into_mb_list
    from areal_tpu_torch.utils.grid import pack_grid

    lens = _train_sequences()
    mask = np.zeros((len(lens), max(lens)), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    batch = {"attention_mask": mask, "input_ids": np.zeros(mask.shape, np.int32)}
    mb = split_padded_tensor_dict_into_mb_list(batch, MicroBatchSpec(n_mbs=2)).mbs[0]
    row_len = round_up_to_bucket(int(np.asarray(mb["attention_mask"]).sum(-1).max()), PPOActorConfig().bucket_step)
    grid = pack_grid(mb, row_len)
    return grid.n_rows * grid.row_len


def _gmm_bwd_bound(which: str, M: int, k: int, n: int, sizes: torch.Tensor, out_elem: int) -> tuple[float, str]:
    """Least time of one call on these inputs: 2 flops a multiply-add of the
    grouped rows at the bf16 tensor-core rate against each input read once
    and the output written once. dLHS reads the grouped rows of the f32
    cotangent [M, n] and the touched experts' weights, writes [M, k] (zeros
    past the groups included); tgmm reads the grouped rows of lhs [M, k]
    bf16 and of the cotangent, writes [E, k, n]."""
    E, used = sizes.numel(), int(sizes.sum())
    if which == "gmm_bwd_lhs":
        touched = int((sizes > 0).sum())
        nbytes = used * n * 4 + touched * k * n * 2 + M * k * out_elem + E * 4
    else:
        nbytes = used * k * 2 + used * n * 4 + E * k * n * out_elem + E * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * used * k * n / PEAK_OPS["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gmm_bwd_library(which: str, lhs, rhs, grad, sizes):
    """Yardsticks the port never calls: the same function as a loop of
    ``torch.mm`` in f32 over the groups (sizes read once, outside the timed
    calls); where this torch runs ``torch._grouped_mm``, the same function
    again as one grouped call on the cotangent's bf16 hi and lo halves side
    by side along the reduction, against the operand repeated (the halves
    split and the operands laid out outside the timed calls; the grouped
    call writes only its inputs' dtype, so the f32 sum is rounded once to
    bf16, as the kernels' training output is); and one grouped call on
    bf16(grad) (another function: the low bits dropped, a reading only).
    Returns (loop fn, same-function fn or None, bf16 fn or None)."""
    ends = torch.cumsum(sizes, 0).tolist()
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    M, k, n = lhs.shape[0], lhs.shape[1], grad.shape[1]
    hi = grad.bfloat16()
    lo = (grad - hi.float()).bfloat16()
    if which == "gmm_bwd_lhs":
        out = torch.empty((M, k), device="cuda")

        def loop():
            a = 0
            for g_, b in enumerate(ends):
                if b > a:
                    torch.mm(grad[a:b], rhs[g_].float().t(), out=out[a:b])
                a = b

        rt = rhs.transpose(1, 2)

        def grouped():
            return lambda: torch._grouped_mm(hi, rt, offs=offs)

        def side_by_side():  # [hi | lo] @ [rhs^T; rhs^T]
            a2, r2 = torch.cat([hi, lo], 1), torch.cat([rt, rt], 1)
            return lambda: torch._grouped_mm(a2, r2, offs=offs)
    else:
        out = torch.empty((sizes.numel(), k, n), device="cuda")

        def loop():
            a = 0
            for g_, b in enumerate(ends):
                if b > a:
                    torch.mm(lhs[a:b].float().t(), grad[a:b], out=out[g_])
                else:
                    out[g_].zero_()
                a = b

        def grouped():
            lt = lhs.t()
            return lambda: torch._grouped_mm(lt, hi, offs=offs)

        def side_by_side():  # per group, its rows twice: lhs against hi, then against lo
            l2, g2, a = [], [], 0
            for b in ends:
                l2 += [lhs[a:b], lhs[a:b]]
                g2 += [hi[a:b], lo[a:b]]
                a = b
            l2, g2, offs2 = torch.cat(l2).t(), torch.cat(g2), 2 * offs
            return lambda: torch._grouped_mm(l2, g2, offs=offs2)

    found = []
    for make, what in ((side_by_side, "hi and lo side by side"), (grouped, "bf16(grad)")):
        try:
            fn = make()
            fn()
            torch.cuda.synchronize()
            found.append(fn)
        except (AttributeError, RuntimeError, TypeError, ValueError) as e:
            log(f"[kernel_gmm_bwd] torch._grouped_mm ({what}) for {which}: not usable here "
                f"({str(e).splitlines()[0][:100]})")
            found.append(None)
    return loop, *found


def _gmm_bwd_inputs():
    """kernel_gmm_bwd's inputs, one (shape, projection) at a time, from one
    seeded generator: Qwen3-30B-A3B's experts (E=128, top-8), (k, n) =
    (2048, 768) for gate / up and (768, 2048) for down, at M = 32,768
    (kernel_gmm's prefill group) and M = 8 x the tokens of train_moe's
    minibatch grid, routed by a seeded top-8 softmax with 64 rows past the
    groups; bf16 lhs, three bf16 weight stacks (cycled in dLHS's timed
    calls, so each call finds its weights cold in the 50 MB L2), the f32
    cotangent; last, M = 8 x 1,024 (a 1,024-token microbatch, whose groups
    average 64 rows: dLHS's 64-row tiles). Yields (shape, projection,
    sizes, lhs, stacks, grad)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    mc = QWEN3_30B_A3B
    E, K, D, Fm = mc["num_experts"], mc["num_experts_per_tok"], mc["hidden_size"], mc["moe_intermediate_size"]
    for sname, M in (("prefill", 8 * 512 * K), ("train", _train_moe_grid_tokens() * K), ("small", 1024 * K)):
        sizes = _gmm_routing(M - 64, E, K, g)
        for proj, (k, n) in (("gate_up", (D, Fm)), ("down", (Fm, D))):
            lhs = torch.randn((M, k), generator=g, device="cuda").bfloat16()
            stacks = [(0.02 * torch.randn((E, k, n), generator=g, device="cuda")).bfloat16() for _ in range(3)]
            grad = torch.randn((M, n), generator=g, device="cuda")
            yield sname, proj, sizes, lhs, stacks, grad
            del lhs, stacks, grad
            torch.cuda.empty_cache()


def _gmm_bwd_run(which: str, lhs, stacks, grad, sizes):
    """One kernel's bf16-output call on these inputs, the weight stack
    cycling from call to call (dLHS); uses only the wrappers, so it runs any
    tree's kernels (``--gmm-bwd-times``)."""
    from areal_tpu_torch.ops import gmm as gm

    it = iter(range(10**9))
    if which == "gmm_bwd_lhs":
        return lambda: gm.gmm_bwd_lhs(grad, stacks[next(it) % 3], sizes, out_dtype=torch.bfloat16)
    return lambda: gm.tgmm(lhs, grad, sizes, out_dtype=torch.bfloat16)


def _gmm_bwd_timings(which: str, lhs, stacks, grad, sizes) -> dict:
    """Device ms by CUDA-graph replay (``ms``) and the eager host loop beside
    it (``host_ms``) of one kernel with a bf16 output."""
    run = _gmm_bwd_run(which, lhs, stacks, grad, sizes)
    with torch.no_grad():
        return dict(ms=time_cuda_graph(run, iters=6, reps=3), host_ms=time_cuda(run, iters=10, warmup=2))


def gmm_bwd_times() -> None:
    """``--gmm-bwd-times DIR``: gmm_bwd_lhs and tgmm of the ``areal_tpu_torch``
    under DIR (a tree unpacked with ``git archive``, say a parent commit's)
    at kernel_gmm_bwd's six shapes, one JSON line a shape: each kernel's
    times (``_gmm_bwd_timings``), its bf16 output's worst element as a share
    of the limit against the plain version (``share``) and a digest of its
    bits, so two trees' kernels compare by graph replay in one call."""
    from areal_tpu_torch.ops import gmm as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    for sname, proj, sizes, lhs, stacks, grad in _gmm_bwd_inputs():
        line = {}
        with torch.no_grad():
            for which in ("gmm_bwd_lhs", "tgmm"):
                got = _gmm_bwd_run(which, lhs, stacks, grad, sizes)()
                if which == "gmm_bwd_lhs":
                    ref = gm.gmm_bwd_lhs_plain(grad, stacks[0], sizes, torch.float32)
                    mag = gm.gmm_bwd_lhs_plain(grad.abs(), stacks[0].float().abs(), sizes, torch.float32)
                    share = _bwd_share(got, ref, mag, grad.shape[1], True, int(sizes.sum()))
                else:
                    ref = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
                    mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
                    share = _bwd_share(got, ref, mag, int(sizes.max()), True)
                bits = _digest(got)
                del got, ref, mag
                line[which] = dict(share=share, bits=bits, **_gmm_bwd_timings(which, lhs, stacks, grad, sizes))
        print(json.dumps({"gmm_bwd_times": f"{sname}/{proj}", **line}), flush=True)


def phase_kernel_gmm_bwd() -> dict:
    """The grouped matmul's backward kernels (megablox's VJP: dLHS =
    ``gmm(transpose_rhs=True)``, dRHS = ``tgmm``) against their plain
    versions at ``_gmm_bwd_inputs``' six shapes. Each kernel's f32 output
    and its bf16 output (the training path's) are held to their limits;
    three planted faults must miss them by GMM_BWD_FAULT_MIN. Reports the
    bf16 kernels' occupancy and times the kernels (bf16 out; graph replay,
    the host loop beside it), the plain versions, the f32 ``torch.mm`` loop,
    ``torch._grouped_mm`` on hi and lo side by side (the same function) and
    on bf16(grad) (another) beside it, and the bound."""
    from areal_tpu_torch.ops import gmm as gm

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products stay f32
    E = QWEN3_30B_A3B["num_experts"]
    occ = gm.bwd_occupancy()
    log("[kernel_gmm_bwd] bf16 kernels (bf16 out): " + "; ".join(
        f"{name} {o['registers']} registers, {o['local_bytes']} local (spill) bytes a thread, {o['smem_bytes']} B "
        f"shared memory a block, {o['blocks_per_sm']} blocks an SM" for name, o in occ.items()))
    per: dict[str, dict] = {"occupancy": occ}
    with torch.no_grad():
        for sname, proj, sizes, lhs, stacks, grad in _gmm_bwd_inputs():
            M, k, n = lhs.shape[0], lhs.shape[1], grad.shape[1]
            used = int(sizes.sum())
            past = M - used
            last = int(torch.nonzero(sizes > 0)[-1])
            plus = sizes.clone()
            plus[last] += 1  # the fault: the last group takes the first row past the groups
            rhs = stacks[0]
            res = {}
            for which in ("gmm_bwd_lhs", "tgmm"):
                if which == "gmm_bwd_lhs":
                    R, row_used = n, used

                    def run(od, w=rhs):
                        return gm.gmm_bwd_lhs(grad, w, sizes, out_dtype=od)

                    def plain(od, sz=sizes, w=rhs, gr=grad):
                        return gm.gmm_bwd_lhs_plain(gr, w, sz, od)

                    mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)
                else:
                    R, row_used = int(sizes.max()), None

                    def run(od, w=rhs):
                        return gm.tgmm(lhs, grad, sizes, out_dtype=od)

                    def plain(od, sz=sizes, w=rhs, gr=grad):
                        return gm.tgmm_plain(lhs, gr, sz, od)

                    mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
                ref = plain(torch.float32)
                got32, got16 = run(torch.float32), run(torch.bfloat16)
                torch.cuda.synchronize()
                share32 = _bwd_share(got32, ref, mag, R, False, row_used)
                share16 = _bwd_share(got16, ref, mag, R, True, row_used)
                err32 = (got32.float() - ref).abs().max().item()
                err16 = (got16.float() - plain(torch.bfloat16).float()).abs().max().item()
                if not (share32 <= 1.0 and share16 <= 1.0):
                    raise AssertionError(f"[kernel_gmm_bwd] {sname} {proj} {which}: off its plain version by "
                                         f"{share32:.3f} (f32 out) / {share16:.3f} (bf16 out) x the limit")
                wrong = rhs.clone()
                big = int(sizes.argmax())
                wrong[big] = rhs[(big + 1) % E]
                faults = {
                    "cotangent's lo half dropped": plain(torch.float32, gr=grad.bfloat16().float()),
                    "a group times the next expert's weights": (
                        plain(torch.float32, w=wrong) if which == "gmm_bwd_lhs"
                        else torch.cat([ref[:big], ref[big + 1:big + 2], ref[big + 1:]])),
                    "a row past the groups": plain(torch.float32, sz=plus),
                }
                fault_x = {f: _bwd_share(v, ref, mag, R, False, row_used) for f, v in faults.items()}
                del faults, wrong
                for f, x in fault_x.items():
                    if not x >= GMM_BWD_FAULT_MIN[f]:
                        raise AssertionError(f"[kernel_gmm_bwd] {sname} {proj} {which}: planted fault ({f}) only "
                                             f"{x:.2f} x the limit (needs {GMM_BWD_FAULT_MIN[f]})")
                t = _gmm_bwd_timings(which, lhs, stacks, grad, sizes)
                it = iter(range(10**9))
                ms32 = time_cuda(lambda: run(torch.float32, stacks[next(it) % 3]), iters=5, warmup=1)
                plain_ms = time_cuda(lambda: plain(torch.bfloat16, w=stacks[next(it) % 3]), iters=2, warmup=1)
                loop, split, grouped = _gmm_bwd_library(which, lhs, rhs, grad, sizes)
                lib_ms = time_cuda(loop, iters=5, warmup=1)
                split_ms = split_host_ms = split_share = grouped_ms = grouped_host_ms = None
                if split is not None:
                    split_ms, split_host_ms = time_cuda_graph(split, iters=6, reps=3), time_cuda(split, iters=10)
                    # the yardstick writes no rows past the groups: held on the groups' rows
                    split_share = _bwd_share(split()[:used], ref[:used], mag[:used], R, True)
                if grouped is not None:
                    grouped_ms, grouped_host_ms = time_cuda_graph(grouped, iters=6, reps=3), time_cuda(grouped, iters=10)
                bound_ms, bound_by = _gmm_bwd_bound(which, M, k, n, sizes, 2)
                res[which] = dict(max_abs_err=err16, max_abs_err_f32_out=err32, share_f32_out=share32,
                                  share_bf16_out=share16, **t, ms_f32_out=ms32, plain_ms=plain_ms,
                                  library_ms=lib_ms, library="loop of torch.mm (f32)", grouped_mm_split_ms=split_ms,
                                  grouped_mm_split_host_ms=split_host_ms, grouped_mm_split_share=split_share,
                                  grouped_mm_bf16_ms=grouped_ms, grouped_mm_bf16_host_ms=grouped_host_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, faults=fault_x, M=M, k=k, n=n)
                fmt = lambda x: f"{x:.4f} ms" if x is not None else "not usable"  # noqa: E731
                log(f"[kernel_gmm_bwd] {sname} {proj} {which}: M={M} ({past} past the groups) k={k} n={n}; worst "
                    f"element {share32:.4f} (f32 out) / {share16:.4f} (bf16 out) of the limit (max|diff| "
                    f"{err32:.3e} / {err16:.3e}); planted faults "
                    + ", ".join(f"{f} {x:.1f}" for f, x in fault_x.items())
                    + f"; kernel={t['ms']:.4f} ms by graph replay (host loop {t['host_ms']:.4f}; f32 out "
                    f"{ms32:.4f}) plain={plain_ms:.4f} ms torch.mm loop (f32)={lib_ms:.4f} ms; torch._grouped_mm "
                    f"on hi and lo side by side (the same function)={fmt(split_ms)} by graph replay (host loop "
                    f"{fmt(split_host_ms)}; worst element "
                    + (f"{split_share:.4f}" if split_share is not None else "-")
                    + f" of the limit), on bf16(grad) (another function)={fmt(grouped_ms)}; bound={bound_ms:.4f} ms "
                    f"({bound_by}); {2 * 2 * M * k * n / t['ms'] / 1e9:.1f} TFLOP/s of split MMA")
                del ref, mag, got32, got16
            for which, d in res.items():
                per[f"{which}/{sname}/{proj}"] = d
        # the expert ranks' shapes: E / e groups, (1 - 1/e) of the rows past them
        for sname, e, proj, sizes, lhs, stacks, grad in _gmm_ep_inputs(("prefill", "train"), backward=True):
            for which in ("gmm_bwd_lhs", "tgmm"):
                per[f"{which}/{sname}_e{e}/{proj}"] = _gmm_bwd_ep_case(which, f"{sname} e={e} {proj}", lhs, stacks,
                                                                       grad, sizes)
            del lhs, stacks, grad
    return per


def _gmm_bwd_ep_case(which: str, what: str, lhs, stacks, grad, sizes) -> dict:
    """One expert rank's backward kernel against its plain version: the f32
    and the bf16 outputs within their limits, dLHS's rows past the groups
    exact zeros; the kernel (bf16 out) by graph replay, the f32 ``torch.mm``
    loop and ``torch._grouped_mm`` on hi and lo side by side over the
    grouped rows, the bound, and the share of dLHS's work items that only
    write zeros (tgmm's grid is per group: none)."""
    from areal_tpu_torch.ops import gmm as gm

    M, k, n = lhs.shape[0], lhs.shape[1], grad.shape[1]
    E_loc = sizes.numel()
    used = int(sizes.sum())
    rhs = stacks[0]
    if which == "gmm_bwd_lhs":
        R, row_used = n, used
        run = lambda od: gm.gmm_bwd_lhs(grad, rhs, sizes, out_dtype=od)  # noqa: E731
        ref = gm.gmm_bwd_lhs_plain(grad, rhs, sizes, torch.float32)
        mag = gm.gmm_bwd_lhs_plain(grad.abs(), rhs.float().abs(), sizes, torch.float32)
    else:
        R, row_used = int(sizes.max()), None
        run = lambda od: gm.tgmm(lhs, grad, sizes, out_dtype=od)  # noqa: E731
        ref = gm.tgmm_plain(lhs, grad, sizes, torch.float32)
        mag = gm.tgmm_plain(lhs.float().abs(), grad.abs(), sizes, torch.float32)
    got32, got16 = run(torch.float32), run(torch.bfloat16)
    share32 = _bwd_share(got32, ref, mag, R, False, row_used)
    share16 = _bwd_share(got16, ref, mag, R, True, row_used)
    err16 = (got16.float() - ref.to(got16.dtype).float()).abs().max().item()  # against plain(bf16)
    if not (share32 <= 1.0 and share16 <= 1.0):
        raise AssertionError(f"[kernel_gmm_bwd] {what} {which}: off its plain version by {share32:.3f} (f32 out) / "
                             f"{share16:.3f} (bf16 out) x the limit")
    del got32, got16
    t = _gmm_bwd_timings(which, lhs, stacks, grad, sizes)
    loop, split, _ = _gmm_bwd_library(which, lhs[:used], rhs, grad[:used], sizes)
    lib_ms = time_cuda(loop, iters=5, warmup=1)
    split_ms = time_cuda_graph(split, iters=6, reps=3) if split is not None else None
    bound_ms, bound_by = _gmm_bwd_bound(which, M, k, n, sizes, 2)
    zero, items = _zero_items(sizes, M, 128 if M >= 128 * E_loc else 64) if which == "gmm_bwd_lhs" else (0, 0)
    del ref, mag
    log(f"[kernel_gmm_bwd] {what} {which}: M={M}, {used} rows in {E_loc} groups ({M - used} past them), k={k} "
        f"n={n}; worst element {share32:.4f} (f32 out) / {share16:.4f} (bf16 out) of the limit"
        + (", rows past the groups zero" if which == "gmm_bwd_lhs" else "")
        + f"; kernel={t['ms']:.4f} ms by graph replay (host loop {t['host_ms']:.4f}); torch.mm loop (f32) on the "
        f"grouped rows={lib_ms:.4f} ms; torch._grouped_mm on hi and lo side by side="
        + (f"{split_ms:.4f} ms" if split_ms is not None else "not usable")
        + f"; bound={bound_ms:.4f} ms ({bound_by})"
        + (f"; {zero} of the grid's {items} work items only write zeros ({zero / items:.1%})" if items else ""))
    return dict(max_abs_err=err16, max_abs_err_f32_out=None, share_f32_out=share32, share_bf16_out=share16, **t,
                ms_f32_out=None, plain_ms=None, library_ms=lib_ms, library="loop of torch.mm (f32)",
                grouped_mm_split_ms=split_ms, grouped_mm_bf16_ms=None, bound_ms=bound_ms, bound_by=bound_by, M=M,
                k=k, n=n, used=used, groups=E_loc, zero_items=zero, grid_items=items)


def _trainer_routes(trainer, batch: dict, b: int, n: int):
    """Per layer, (top_e sorted along K, gap) of sequence ``b``'s first ``n``
    rows in the trainer's proximal-recompute forward (``forward_batch``'s
    no-grad grids, rerun on the same weights with a routing trace: the
    forward is deterministic)."""
    from areal_tpu_torch.models import qwen

    for grid in trainer._make_grids(batch):
        if b in grid.seq_index:
            break
    local = grid.seq_index.index(b)
    start = grid.row_of_seq[local] * grid.row_len + grid.col_of_seq[local]
    dev = trainer._grid_to_device(grid)
    view = qwen.ParamView(trainer.model, trainer.model_cfg)
    trace = []
    for layer in view.layers:
        layer.moe_trace = trace
    with torch.no_grad():
        qwen.forward(view, dev["input_ids"], dev["segment_ids"], dev["positions"], no_grad=True)
    return _route_rows(trace, trainer.model_cfg.num_layers, [(0, start, n)])


def _moe_gap_check(tag: str, trainer, engine, batch: dict, step: int) -> float:
    """The trainer's recomputed logprobs against the served ones with
    serve_moe's near-tie rule: a generated token past LOGPROB_TOL is exempt
    only if a route flipped at a near-tie (margin < ROUTE_GAP_TOL in both
    passes) at its row or an earlier one, between the trainer's forward of
    its sequence (``_trainer_routes``) and the served computation replayed
    (``_route_flips`` on the engine's model, idle between waves). The two
    passes' kernel launches are a check's, not the main path's: the counts
    are put back after them. Logs and returns the largest gap; raises on an
    unexempted one."""
    from areal_tpu_torch.ops.attention import flash_attention_fwd
    from areal_tpu_torch.ops.gmm import gmm

    gen = np.asarray(batch["loss_mask"]) > 0
    diff = np.where(gen, np.abs(batch["prox_logp"] - np.asarray(batch["logprobs"])), 0.0)
    lens = np.asarray(batch["attention_mask"]).sum(-1)
    ids = np.asarray(batch["input_ids"])
    exempt = near_rows = 0
    for b in np.nonzero((diff > LOGPROB_TOL).any(-1))[0]:
        n_p = int(np.argmax(gen[b]))  # the first generated token
        prompt, out = ids[b, :n_p].tolist(), ids[b, n_p: lens[b]].tolist()
        launches = gmm.launches, flash_attention_fwd.launches
        routes = _trainer_routes(trainer, batch, int(b), int(lens[b]) - 1)
        near, far, n_near, worst, total = _route_flips(engine.model, prompt, out, against=routes)
        gmm.launches, flash_attention_fwd.launches = launches
        reach = np.logical_or.accumulate(near)[n_p - 1: n_p - 1 + len(out)]
        bad = diff[b, n_p: lens[b]] > LOGPROB_TOL
        if (bad & ~reach).any():
            raise AssertionError(f"[{tag}] wave {step} sequence {b}: {int((bad & ~reach).sum())} tokens off the served "
                                 f"logprobs by up to {float(diff[b, n_p: lens[b]][bad & ~reach].max()):.4f} (tol "
                                 f"{LOGPROB_TOL}) with no near-tie route flip at or before them ({n_near} near-tie "
                                 f"flips of {total} routes, {far} with a margin >= {ROUTE_GAP_TOL})")
        exempt += int(bad.sum())
        near_rows += int(near.sum())
    gap = float(diff.max())
    log(f"[{tag}] wave {step}: {int(gen.sum())} generated tokens, all at version {step}; trainer's recomputed "
        f"logprobs vs served: max|diff| {gap:.4f} (tol {LOGPROB_TOL}); near-tie exemptions {exempt}"
        + (f" ({near_rows} rows with a near-tie route flip between the trainer's and the served routes of the "
           f"sequences concerned)" if exempt else ""))
    return gap


# Qwen3-30B-A3B cut to the depth that trains on one card: f32 master
# weights, their bf16 view, f32 gradients and two AdamW moments take ~18 B a
# parameter; a layer holds 623.1 M (11.2 GB of that state), the embedding and
# the untied head 2 x 311.2 M. Four layers: 3.11 B parameters, ~56 GB.
TRAIN_MOE_LAYERS = 4
# each of one layer's expert and router gradients, kernel backward vs the
# plain backward on the card, as a cosine: the two differ where their bf16
# outputs round an f32 value that differs by ~2^-18 relative (one bf16 step
# on a few elements) and in the order of the token scatter-add's bf16
# atomics, ~2^-8 relative noise on a share of the elements: a cosine of
# 1 - 2^-16 or so. 0.999 leaves a wide margin; a gradient of the wrong
# expert or a transposed one is uncorrelated (cosine ~0).
GRAD_COSINE_MIN = 0.999


def _grad_copies(model, names) -> dict[str, torch.Tensor]:
    sd = dict(model.named_parameters())
    return {n: sd[n].grad.detach().clone() for n in names}


def _routes_touched(view, batch, E: int, rows_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Experts layer 0 routes any grid token to, and any valid token to, in a
    forward of ``batch`` on ``view`` (the trainer's compute weights)."""
    from areal_tpu_torch.models import qwen

    trace = []
    view.layers[0].moe_trace = trace
    try:
        with torch.no_grad():
            qwen.forward(view, batch["input_ids"], batch["segment_ids"], batch["positions"])
    finally:
        view.layers[0].moe_trace = None
    top_e = trace[0][0]  # [G * L, K]
    any_ = torch.bincount(top_e.reshape(-1), minlength=E) > 0
    valid = torch.bincount(top_e[rows_valid.reshape(-1)].reshape(-1), minlength=E) > 0
    return any_, valid


def _tree_vs_packed(trainer, batch, card: str) -> dict:
    """One MoE tree step on the trainer's model: the first GRPO group's 4
    sequences through ``tree_forward_logprobs_pallas`` (#4-#6, the grouped
    matmul and its backward kernels) against the packed path (one grid, K2-K4)
    on the same weights: the generated tokens' logprobs (LOGPROB_TOL, near-tie
    route flips between the two passes exempt and counted) and the gradient
    norm of the same loss (GRAD_NORM_RTOL), with the kernels' launches of
    the tree step's forward and backward."""
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.tree import build_tree
    from areal_tpu_torch.ops import gmm as gm
    from areal_tpu_torch.ops import tree_attention as ta
    from areal_tpu_torch.utils.grid import pack_grid

    cfg = trainer.model_cfg
    lens = np.asarray(batch["attention_mask"]).sum(-1)
    gen = np.asarray(batch["loss_mask"]) > 0
    rows = list(range(4))  # the first prompt's 4 samples
    seqs = [np.asarray(batch["input_ids"])[b, : lens[b]] for b in rows]
    pack = build_tree(seqs)
    sub = {k: np.asarray(v)[rows] for k, v in batch.items() if np.asarray(v).ndim >= 1 and len(v) == len(lens)}
    grid = pack_grid(sub, int(max(lens[rows])))
    dev_grid = trainer._grid_to_device(grid)
    L_grid = grid.row_len
    # the token at position t of sequence i: its tree node and its grid row
    tree_row = [np.asarray(pack.seq_nodes[i]) for i in range(4)]
    grid_row = [grid.row_of_seq[grid.seq_index.index(i)] * L_grid + grid.col_of_seq[grid.seq_index.index(i)]
                + np.arange(lens[rows[i]]) for i in range(4)]

    def tree_logp(view):
        node_logp = ta.tree_forward_logprobs_pallas(view, pack)  # [N]: log p(token_j | ancestors)
        return [node_logp[torch.from_numpy(tree_row[i][1:]).cuda().long()] for i in range(4)]

    def packed_logp(view):  # the trainer's packed outputs (``_outputs_fn``) on ``view``
        hidden = qwen.forward(view, dev_grid["input_ids"], dev_grid["segment_ids"], dev_grid["positions"])
        out, _ = qwen.chunked_logprobs_entropy(view, hidden, dev_grid["labels"],
                                               chunk_size=trainer.config.logprob_chunk_size,
                                               temperature=trainer._logit_temperature)
        out = out.reshape(-1)  # label-aligned
        return [out[torch.from_numpy(grid_row[i][:-1]).cuda().long()] for i in range(4)]

    gmask = [torch.from_numpy(gen[rows[i], 1: lens[rows[i]]]).cuda() for i in range(4)]

    def loss_of(lps):
        tot = sum(float(m.sum()) for m in gmask)
        return -sum((lp * m).sum() for lp, m in zip(lps, gmask)) / tot

    # logprobs and routes of both passes, no gradient
    res = {}
    for name, fn, row_of in (("tree", tree_logp, tree_row), ("packed", packed_logp, grid_row)):
        view = qwen.ParamView(trainer.model, cfg)
        trace = []
        for layer in view.layers:
            layer.moe_trace = trace
        with torch.no_grad():
            lps = fn(view)
        res[name] = (torch.cat(lps).float().cpu().numpy(), trace, row_of)
    n_layers = cfg.num_layers
    exempt, worst, near_total = 0, 0.0, 0
    offs = np.cumsum([0] + [len(r) - 1 for r in tree_row])
    gap = np.abs(res["tree"][0] - res["packed"][0])
    for i in range(4):
        n = len(tree_row[i])
        near = np.zeros(n, bool)
        for layer in range(n_layers):
            (ta_, ga), (tb, gb) = res["tree"][1][layer], res["packed"][1][layer]
            ra, rb = torch.from_numpy(tree_row[i]).cuda().long(), torch.from_numpy(grid_row[i]).cuda().long()
            diff = (ta_[ra].sort(-1).values != tb[rb].sort(-1).values).any(-1)
            margin = torch.minimum(ga[ra], gb[rb])
            near |= (diff & (margin < ROUTE_GAP_TOL)).cpu().numpy()
            near_total += int((diff & (margin < ROUTE_GAP_TOL)).sum())
        reach = np.logical_or.accumulate(near)[: n - 1]  # token t + 1 is scored at row t
        g_i = gap[offs[i]: offs[i + 1]]
        m_i = gmask[i].cpu().numpy()
        bad = (g_i > LOGPROB_TOL) & m_i
        if (bad & ~reach).any():
            raise AssertionError(f"[train_moe] tree vs packed, sequence {i}: {int((bad & ~reach).sum())} tokens off by up "
                                 f"to {float(g_i[bad & ~reach].max()):.4f} with no near-tie route flip before them")
        exempt += int(bad.sum())
        worst = max(worst, float(g_i[m_i].max()))
    # the gradient norm of the same loss through each path
    counts0 = (ta.tree_attention_fwd.launches, ta.tree_attention_bwd_dq.launches, ta.tree_attention_bwd_dkv.launches,
               gm.gmm.launches, gm.gmm_bwd_lhs.launches, gm.tgmm.launches)
    norms = {}
    for name, fn in (("tree", tree_logp), ("packed", packed_logp)):
        trainer.zero_grad()
        view = qwen.ParamView(trainer.model, cfg)
        loss_of(fn(view)).backward()
        norms[name] = float(trainer._opt.global_norm(trainer._grads()))
        if name == "tree":
            counts = [c - c0 for c, c0 in zip((ta.tree_attention_fwd.launches, ta.tree_attention_bwd_dq.launches,
                                               ta.tree_attention_bwd_dkv.launches, gm.gmm.launches,
                                               gm.gmm_bwd_lhs.launches, gm.tgmm.launches), counts0)]
    trainer.zero_grad()
    want = [2 * n_layers, n_layers, n_layers, 6 * n_layers, 3 * n_layers, 3 * n_layers]
    rel = abs(norms["tree"] - norms["packed"]) / norms["packed"]
    log(f"[train_moe] tree step on the first GRPO group ({pack.n_nodes} trie nodes for {int(lens[rows].sum())} "
        f"tokens) through tree_forward_logprobs_pallas vs the packed path, same weights: generated tokens' logprobs "
        f"max|diff| {worst:.4f} (tol {LOGPROB_TOL}), near-tie exemptions {exempt} ({near_total} near-tie route flips "
        f"between the passes); grad norm tree {norms['tree']:.5f}, packed {norms['packed']:.5f}, relative diff "
        f"{rel:.2e} (tol {GRAD_NORM_RTOL}); tree step launches #4 {counts[0]}, #5 {counts[1]}, #6 {counts[2]}, gmm "
        f"{counts[3]}, gmm_bwd_lhs {counts[4]}, tgmm {counts[5]} (want {want})")
    if counts != want:
        raise AssertionError(f"[train_moe] tree step launches {counts} != {want}")
    if not rel <= GRAD_NORM_RTOL:
        raise AssertionError("[train_moe] the MoE tree step's gradient disagrees with the packed path's")
    return dict(logp_gap=worst, exempt=exempt, norms=norms, counts=counts)


def phase_train_moe(card: str) -> dict:
    """Two asynchronous-GRPO steps of Qwen3-30B-A3B at full width, its depth
    cut to TRAIN_MOE_LAYERS (``_grpo_run`` with the train phase's
    ``PPOActorConfig``: 8 prompts x 4 samples, 128 new tokens, two
    minibatches a step): the grouped matmuls' forward and backward kernels
    under per-layer checkpointing, the weights (router and experts
    included) pushed into the running engine. Checks the trainer's logprobs
    against the served ones (near-tie route flips exempt, counted), finite
    loss and grad norm, LR 0 on the first step, moved weights, version 1 on
    the second wave and the launches of gmm, gmm_bwd_lhs and tgmm against
    what the forwards, recomputes and backwards imply; then on one
    minibatch the kernel backward's gradient against the plain backward's
    (norm, and cosines of one layer's expert and router gradients; experts
    no token reached get exact zeros), one MoE tree step against the packed
    path, a profiled optimizer step and the peak memory."""
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops import gmm as gm
    from areal_tpu_torch.utils.data import MicroBatchSpec, split_padded_tensor_dict_into_mb_list

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2 * 2**30:
        raise AssertionError(f"[train_moe] {held / 2**30:.2f} GiB still held before the model")
    model = {**QWEN3_30B_A3B, "num_layers": TRAIN_MOE_LAYERS}
    kernels = (gm.gmm, gm.gmm_bwd_lhs, gm.tgmm, fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    r = _grpo_run("train_moe", kernels, model=model, name=f"Qwen3-30B-A3B (full width, {TRAIN_MOE_LAYERS} of 48 layers)",
                  gap_check=_moe_gap_check)
    cfg, trainer, actor, batch, adv, parts = (r[k] for k in ("cfg", "trainer", "actor", "batch", "adv", "parts"))
    L, E = TRAIN_MOE_LAYERS, model["num_experts"]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    counts, n_fwd_grids, n_mbs, fwd = r["counts"], r["n_fwd_grids"], r["n_mbs"], r["engine_forwards"]
    want = [3 * L * (fwd + n_fwd_grids + 2 * n_mbs), 3 * L * n_mbs, 3 * L * n_mbs,
            L * n_fwd_grids + 2 * L * n_mbs, L * n_mbs, L * n_mbs]
    log(f"[train_moe] {n_params / 1e9:.3f} B parameters; launches: gmm {counts[0]} (= 3 x {L} layers x ({fwd} engine "
        f"forwards + {n_fwd_grids} proximal-recompute grids + 2 x {n_mbs} microbatches, forward and its recompute)), "
        f"gmm_bwd_lhs {counts[1]}, tgmm {counts[2]} (= 3 x {L} x {n_mbs}); K2 {counts[3]}, K3 {counts[4]}, K4 "
        f"{counts[5]}")
    if counts != want:
        raise AssertionError(f"[train_moe] launch counts {counts} != {want}")
    tokens = r["trained_tokens"]
    log(f"[train_moe] {card}: rollout {parts['rollout']:.2f} s (2 waves x 32 x 128 tokens), proximal recompute "
        f"{parts['prox_recompute']:.2f} s, ppo_update {parts['ppo_update']:.2f} s (steps: "
        + ", ".join(f"{t:.2f} s" for t in r["ppo_update_s"]) + f"), weight update {parts['weight_update']:.3f} s; "
        f"trainer {tokens / parts['ppo_update']:.0f} tokens/s ({tokens} tokens); peak torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel backward against the plain backward on one minibatch, the
    # proximal logprobs recomputed at the current weights (PPO ratio ~1)
    batch["prox_logp"] = actor.compute_logp(batch)
    adv = actor.compute_advantages(batch)
    mb = split_padded_tensor_dict_into_mb_list(adv, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)).mbs[0]
    watch = [f"layers.0.{n}" for n in ("we_gate", "we_up", "we_down", "w_router")]
    trainer.zero_grad()
    kern = trainer.compute_grads(mb, actor._loss_fn, _wfn)
    kern_grads = _grad_copies(trainer.model, watch)
    orig = gm.gmm_bwd_lhs, gm.tgmm
    gm.gmm_bwd_lhs = lambda grad, rhs, sizes, *, out_dtype, tm=None: gm.gmm_bwd_lhs_plain(grad, rhs, sizes, out_dtype)
    gm.tgmm = lambda lhs, grad, sizes, *, out_dtype: gm.tgmm_plain(lhs, grad, sizes, out_dtype)
    try:
        trainer.zero_grad()
        plain = trainer.compute_grads(mb, actor._loss_fn, _wfn)
    finally:
        gm.gmm_bwd_lhs, gm.tgmm = orig
    plain_grads = _grad_copies(trainer.model, watch)
    trainer.zero_grad()
    cos = {n.rsplit(".", 1)[1]: torch.nn.functional.cosine_similarity(
        kern_grads[n].reshape(1, -1), plain_grads[n].reshape(1, -1)).item() for n in watch}
    rel = abs(kern["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
    grids = trainer._make_grids(mb)
    dev0 = trainer._grid_to_device(grids[0])
    any_, valid = _routes_touched(qwen.ParamView(trainer.model, trainer.model_cfg), dev0, E, dev0["segment_ids"] != 0)
    gnorm_e = kern_grads["layers.0.we_gate"].flatten(1).norm(dim=1)
    if len(grids) != 1:
        raise AssertionError(f"[train_moe] the minibatch packed into {len(grids)} grids, not 1")
    log(f"[train_moe] one minibatch ({int(np.asarray(mb['attention_mask']).sum())} tokens), kernel backward vs the "
        f"plain backward on the card: grad norm {kern['grad_norm']:.5f} vs {plain['grad_norm']:.5f}, relative diff "
        f"{rel:.2e} (tol {GRAD_NORM_RTOL}); cosine of layer 0's gradients "
        + ", ".join(f"{n} {c:.6f}" for n, c in cos.items()) + f" (min {GRAD_COSINE_MIN}); layer 0 routes valid tokens "
        f"to {int(valid.sum())} of {E} experts ({int(any_.sum())} with the padding)")
    if not rel <= GRAD_NORM_RTOL or not min(cos.values()) >= GRAD_COSINE_MIN:
        raise AssertionError("[train_moe] the kernel backward disagrees with the plain backward")
    if (gnorm_e[~any_] != 0).any() or (gnorm_e[valid] == 0).any():
        raise AssertionError("[train_moe] an expert no token reached has a gradient, or a routed one has none")
    del kern_grads, plain_grads

    tree = _tree_vs_packed(trainer, r["batches"][-1], card)
    prof = _profile(lambda: trainer.train_batch(mb, actor._loss_fn, _wfn), "MoE optimizer step (one minibatch)", card)
    busy = prof["busy"]
    _flash_shares(prof)
    shares = {"gmm": _gmm_fwd_us(prof) / prof["busy_us"]}
    for key in ("gmm_bwd_lhs", "tgmm"):
        shares[key] = sum(t for name, t in prof["by_name"].items() if key in name) / prof["busy_us"]
    log("[profile]   " + ", ".join(f"{key} {x * prof['busy_us'] / 1e3:.2f} ms, {x:.1%} of busy"
                                    for key, x in shares.items()) + " (gmm: the forward, with its recompute)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train_moe] {card}: peak torch.cuda.max_memory_allocated {peak:.2f} GiB (of the card's 80 GB)")
    del trainer, actor, r
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=dict(zip(("gmm", "gmm_bwd_lhs", "tgmm"), counts[:3])), parts=parts,
                tokens_per_s=tokens / parts["ppo_update"], peak_gib=peak, busy=busy, shares=shares, cos=cos, rel=rel,
                tree=tree)


# Qwen2-VL-2B (huggingface.co/Qwen/Qwen2-VL-2B-Instruct config.json): the
# vision tower (depth 32, embed_dim 1280, mlp_ratio 4, 16 heads, patch 14,
# temporal patch 2, 3 channels: patch_dim 1,176, spatial merge 2) over the
# LLM of Qwen2.5-1.5B's dims (QWEN25_15B); the image-pad token 151655
QWEN2_VL_2B_VISION = dict(patch_dim=1176, hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=16,
                          out_hidden_size=1536, spatial_merge=2)
VLM_IMAGE_TOKEN, VLM_VISION_START, VLM_VISION_END = 151655, 151652, 151653
VLM_GRID = (1, 22, 34)  # 748 patches, padded to 768; 187 image-pad tokens
VLM_STEPS, VLM_PROMPTS = 2, 16
VLM_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_vlm")
# the trainable tower's step: the f32 master of 2.21 B parameters (8.8 GB),
# AdamW on all of them (17.7 GB), their gradients (8.8 GB), the frozen
# trainer's weights until the copy (8.8 GB), and per image and tower layer
# the saved [16, 768, 768] attention in f32 and bf16 (~0.1 GB: 13 GB at 4
# images); predicted before the first run on the card
VLM_TRAINABLE_PEAK_PREDICTED_GIB = 50.0


def _vlm_cfg():
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.vision import VisionConfig

    return qwen.ModelConfig(**QWEN25_15B, image_token_id=VLM_IMAGE_TOKEN,
                            vision=VisionConfig(**QWEN2_VL_2B_VISION))


def _vlm_image(seed: int) -> tuple[list[int], np.ndarray]:
    """A CLEVR-style prompt (10 text tokens, the image's vision-start, 187
    image pads and vision-end, 18 text tokens) and its N(0, 1) patches
    [748, 1176] f32, from ``seed`` (the prompt from ``seed // 2``: two
    seeds share a prompt, with different images)."""
    t, h, w = VLM_GRID
    n_pad = t * h * w // QWEN2_VL_2B_VISION["spatial_merge"] ** 2
    rng = np.random.default_rng(1000 + seed // 2)
    pre, post = rng.integers(0, 151000, 10).tolist(), rng.integers(0, 151000, 18).tolist()
    ids = pre + [VLM_VISION_START] + [VLM_IMAGE_TOKEN] * n_pad + [VLM_VISION_END] + post
    px = np.random.default_rng(seed).standard_normal((t * h * w, QWEN2_VL_2B_VISION["patch_dim"])).astype(np.float32)
    return ids, px


class _VlmProcessor:
    """A seeded stand-in for Qwen2-VL's processor (no HF processor on the
    card's machine): a row's ``images`` hold one seed, from which come the
    prompt ids with the image pads, the patches and the grid."""

    class image_processor:  # noqa: N801 — the attribute a processor has
        merge_size = 2

    def __call__(self, images, text, padding, return_tensors):
        ids, px = _vlm_image(int(images[0]))
        return {"input_ids": np.asarray([ids]), "pixel_values": px, "image_grid_thw": np.asarray([VLM_GRID])}


class _VlmTokenizer:
    """Renders a completion as a bracketed count, ``[sum(ids) % 3]``, so the
    clevr_count reward (answer "0") varies within a group."""

    def decode(self, ids, skip_special_tokens=False):
        return f"the answer is [{sum(ids) % 3}]"


def _vlm_body(ids: list[int], px: np.ndarray | None, rid: str, n_new: int) -> dict:
    """A /generate body as the client sends it (``inference/client.py``)."""
    import base64
    import io

    body = {"input_ids": ids, "rid": rid, "sampling_params": {"max_new_tokens": n_new, "temperature": 1.0}}
    if px is not None:
        buf = io.BytesIO()
        np.save(buf, px)
        body.update(image_data=base64.b64encode(buf.getvalue()).decode(), image_grid_thw=[list(VLM_GRID)])
    else:
        body["sampling_params"] = {"max_new_tokens": n_new, "greedy": True}
    return body


def _vlm_tower(engine, px: np.ndarray) -> torch.Tensor:
    """A direct call of the served tower on one image, as the engine pads it."""
    from areal_tpu_torch.models import vision as vis

    vcfg = engine.model_cfg.vision
    P = px.shape[0]
    Ppad = vis.pad_patch_bucket(P, vcfg.spatial_merge**2)
    pos = vis.grid_pos_ids([VLM_GRID], vcfg.spatial_merge)
    with torch.no_grad():
        return vis.vision_forward(
            engine.model.vision, vcfg, torch.from_numpy(np.pad(px, ((0, Ppad - P), (0, 0)))).cuda(),
            torch.arange(Ppad, device="cuda") < P, torch.from_numpy(np.pad(pos, ((0, Ppad - P), (0, 0)))).cuda(),
        )


def phase_vlm(card: str) -> dict:
    """Qwen2-VL-2B at full width and depth: an ``InferenceServer`` answers
    image requests over HTTP, ``PPOTrainer.train`` runs GRPO on images over
    HTTP with ``VisionRLVRWorkflow`` and the frozen tower, then one step of
    the trainable tower in process."""
    import shutil

    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[vlm] {held:.2f} GiB still allocated by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    mcfg = _vlm_cfg()
    L, n_new = mcfg.num_layers, 128
    acfg = _grpo_actor()
    trainer = TorchTrainEngine(acfg, model_config=mcfg)
    trainer.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=VLM_PROMPTS, train_batch_size=8), seed=0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    n_tower = sum(p.numel() for p in trainer.model.vision.parameters())
    scfg = ServerConfig(max_seq_len=2048, host="127.0.0.1", seed=0)
    # the server starts from the trainer's weights, cast to bf16
    engine = DecodeEngine(scfg, params=trainer.model.state_dict(), model_cfg=mcfg)
    srv = ServerThread(scfg, engine=engine)
    captured: dict[str, torch.Tensor] = {}  # rid -> the engine's embeddings of its prompt [P, D]
    real_embeds = engine._image_embeds_for

    def embeds_recorded(group, ids_np):
        emb = real_embeds(group, ids_np)
        if emb is not None:
            for j, (task, _) in enumerate(group):
                if task.req.image_data is not None:
                    captured[task.req.rid] = emb[j, : len(task.req.input_ids)].clone()
        return emb

    engine._image_embeds_for = embeds_recorded
    srv.start()
    torch.cuda.synchronize()
    log(f"[vlm] Qwen2-VL-2B ({n_params / 1e9:.3f} B parameters, the tower {n_tower / 1e9:.3f} B): trainer (f32 "
        f"master weights, AdamW state but for the frozen tower) and server (bf16) up in "
        f"{time.monotonic() - t_phase:.1f}s; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    shutil.rmtree(VLM_ROOT, ignore_errors=True)
    secs = {"setup": time.monotonic() - t_phase}
    try:
        t0 = time.monotonic()
        serve = _vlm_serve(card, srv, engine, captured, mcfg, n_new)
        del engine._image_embeds_for  # the engine's own method again
        secs["serve"], t0 = time.monotonic() - t0, time.monotonic()
        train = _vlm_train(card, srv, engine, trainer, acfg, mcfg, n_new)
    finally:
        srv.stop()
        shutil.rmtree(VLM_ROOT, ignore_errors=True)
    del engine, srv
    gc.collect()
    torch.cuda.empty_cache()
    secs["train"], t0 = time.monotonic() - t0, time.monotonic()
    tower = _vlm_trainable(card, trainer, train.pop("batch"), mcfg)
    secs["trainable"] = time.monotonic() - t0
    log(f"[vlm] {card}: the phase took {time.monotonic() - t_phase:.1f} s (" +
        ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + " s)")
    return dict(serve=serve, train=train, tower=tower, launches1=serve["launches1"] + train["launches1"],
                counts=train["counts"], secs=secs)


def _vlm_serve(card, srv, engine, captured, mcfg, n_new) -> dict:
    """One wave of 16 image requests (8 prompts, each with two images) and 4
    text requests, then 4 image requests on wave 1's prompts with new
    images, profiled."""
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked

    images = {i: _vlm_image(i) for i in range(16)}
    rng = np.random.default_rng(7)
    texts = [rng.integers(0, 151000, int(n)).tolist() for n in rng.integers(64, 257, 4)]
    bodies = [_vlm_body(ids, px, f"img{i}", n_new) for i, (ids, px) in images.items()]
    bodies += [_vlm_body(t, None, f"txt{i}", n_new) for i, t in enumerate(texts)]
    s0 = dict(engine.stats)
    dev0 = engine.device_seconds()
    # main path: counts to 0 just before, read just after
    paged_attention_stacked.launches = 0
    t0 = time.monotonic()
    resps = _wave(srv.address, bodies)
    wall = time.monotonic() - t0
    launches1 = paged_attention_stacked.launches
    d = {k: engine.stats[k] - s0[k] for k in ("decode_steps", "prefix_shared", "prefix_cache_hits", "prefills")}
    for r in resps:
        _check_response(r, n_new, "vlm")
    if d["decode_steps"] == 0 or launches1 != mcfg.num_layers * d["decode_steps"]:
        raise AssertionError(f"[vlm] #1 launches {launches1} != {mcfg.num_layers} layers x {d['decode_steps']} steps")
    if d["prefix_shared"] or d["prefix_cache_hits"] or d["prefills"] != len(bodies):
        raise AssertionError(f"[vlm] wave 1: {d}: an image request was aliased or radix-matched")
    dev = {k: engine.device_seconds()[k] - dev0[k] for k in dev0}
    if dev["vision_images"] != 16 or len(captured) != 16:
        raise AssertionError(f"[vlm] {dev['vision_images']} tower calls, {len(captured)} embedded requests: want 16")
    # the engine's embeddings against a direct call of the tower, bit for bit
    slots = np.nonzero(np.asarray(images[0][0]) == VLM_IMAGE_TOKEN)[0]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    direct = {i: _vlm_tower(engine, px) for i, (_, px) in images.items()}
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) / len(direct) * 1e3
    unequal = [i for i in images if not torch.equal(captured[f"img{i}"][slots], direct[i][: len(slots)].float())]
    placed_elsewhere = [i for i in images if captured[f"img{i}"][np.setdiff1d(np.arange(len(images[i][0])), slots)]
                        .abs().max() != 0]
    if unequal or placed_elsewhere:
        raise AssertionError(f"[vlm] the engine's embeddings differ from the tower's for images {unequal}, or sit "
                             f"outside the image pads for {placed_elsewhere}")
    # served logprobs against a dense bf16 prefill of prompt + output with the same embeddings
    errs = [float(_dense_diffs(engine.model, images[i][0], resps[i], False, captured[f"img{i}"]).max())
            for i in range(16)]
    gaps = [float(_dense_diffs(engine.model, texts[i], resps[16 + i], True).max()) for i in range(4)]
    if max(errs) > LOGPROB_TOL or max(gaps) > LOGPROB_TOL:
        raise AssertionError(f"[vlm] served logprobs vs the dense prefill: {max(errs):.4f} / {max(gaps):.4f}")
    # equal ids, different images: different first steps
    same = [i for i in range(0, 16, 2) if resps[i]["output_logprobs"][0] == resps[i + 1]["output_logprobs"][0]]
    if same:
        raise AssertionError(f"[vlm] requests {same} and their twins (equal ids, another image) share a first step")
    # wave 2 on wave 1's prompts (their pages published) with new images: no radix match
    again = {i: (images[2 * i][0], _vlm_image(100 + i)[1]) for i in range(4)}
    s1 = dict(engine.stats)
    dev1 = engine.device_seconds()
    resps2: list = []
    prof = _profile(lambda: resps2.extend(_wave(srv.address, [_vlm_body(ids, px, f"again{i}", n_new // 4)
                                                               for i, (ids, px) in again.items()])),
                    "wave of 4 image requests", card)
    dev2 = {k: engine.device_seconds()[k] - dev1[k] for k in dev1}
    if engine.stats["prefix_cache_hits"] != s1["prefix_cache_hits"]:
        raise AssertionError("[vlm] an image request matched the radix tree")
    for i, r in enumerate(resps2):
        _check_response(r, n_new // 4, "vlm")
        err = float(_dense_diffs(engine.model, again[i][0], r, False, captured[f"again{i}"]).max())
        if err > LOGPROB_TOL:
            raise AssertionError(f"[vlm] wave 2 request {i}: served logprobs vs its own image's dense prefill {err}")
    out = dict(
        launches1=launches1, steps=d["decode_steps"],
        tower_ms_device=dev["vision_s"] / dev["vision_images"] * 1e3, tower_ms_host=host_ms,
        tower_ms_device_warm=dev2["vision_s"] / dev2["vision_images"] * 1e3,
        prefill_tok_s=dev["prefill_tokens"] / dev["prefill_s"],
        prefill_tok_s_with_tower=dev["prefill_tokens"] / (dev["prefill_s"] + dev["vision_s"]),
        ms_per_step=dev["decode_s"] / dev["decode_steps"] * 1e3, wall_s=wall, busy=prof["busy"],
        logprob_err=max(errs), greedy_gap=max(gaps),
    )
    toks = sum(len(r["output_tokens"]) for r in resps)
    n_patch = len(images[0][1])
    log(f"[vlm] {card}: wave of 16 image requests ({len(images[0][0])}-token prompts, {len(slots)} image pads, "
        f"{n_patch} patches padded to {direct[0].shape[0] * mcfg.vision.spatial_merge**2}) and 4 text requests x "
        f"{n_new} tokens: complete in {wall:.2f} s ({toks / wall:.1f} tok/s); "
        f"#1 launches {launches1} = {mcfg.num_layers} layers x {d['decode_steps']} decode steps; tower "
        f"{out['tower_ms_device']:.2f} ms an image (device stream; the process's first calls), "
        f"{out['tower_ms_device_warm']:.2f} ms in wave 2, {host_ms:.2f} ms (host loop, synchronized); "
        f"prefill {out['prefill_tok_s']:.0f} tokens/s ({out['prefill_tok_s_with_tower']:.0f} with the tower; "
        f"device stream, {dev['prefill_tokens']} tokens); {out['ms_per_step']:.2f} ms a decode step (device "
        f"stream); device busy {prof['busy']:.1%} of the profiled wave")
    log(f"[vlm] the engine's embeddings equal the tower's bit for bit (16 images) and sit only at the image pads; "
        f"served logprobs vs a dense bf16 prefill with the same embeddings: max|diff| {max(errs):.4f}, greedy text "
        f"gap {max(gaps):.4f} (tol {LOGPROB_TOL}); 8 pairs of equal ids with other images: no aliasing "
        f"({d['prefix_shared']} shared), different first steps; no radix match on wave 2's 4 requests")
    return out


def _vlm_train(card, srv, engine, trainer, acfg, mcfg, n_new) -> dict:
    """``PPOTrainer.train``: VLM_STEPS GRPO steps over HTTP, 8 prompts x 4
    samples, the frozen tower."""
    from areal_tpu_torch.api.config import (DatasetConfig, EvaluatorConfig, InferenceEngineConfig, PPOConfig,
                                            PreemptionConfig, RecoverConfig, SaverConfig, StatsLoggerConfig)
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.models import vision as vis
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.reward.clevr_count import clevr_count_reward_fn
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.workflow.vision_rlvr import VisionRLVRWorkflow

    L = mcfg.num_layers
    client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
    client.initialize()
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=n_new, temperature=1.0)
    files = dict(saver=SaverConfig(fileroot=VLM_ROOT), checkpointer=SaverConfig(fileroot=VLM_ROOT),
                 evaluator=EvaluatorConfig(fileroot=VLM_ROOT), recover=RecoverConfig(fileroot=VLM_ROOT),
                 stats_logger=StatsLoggerConfig(fileroot=VLM_ROOT))
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name="vlm", weight_update_mode="mem",
                    total_train_steps=VLM_STEPS, preemption=PreemptionConfig(enabled=False), gconfig=gconfig,
                    train_dataset=DatasetConfig(batch_size=8), actor=acfg, rollout=InferenceEngineConfig(**GRPO_CLIENT),
                    **files)
    cfg.cluster.fileroot = VLM_ROOT
    dataset = [{"messages": "How many objects are in the image? Answer as [n].", "images": [2 * i], "answer": "0"}
               for i in range(VLM_PROMPTS)]
    loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
    rec: dict[str, list] = {"fwd": [], "mbs": [], "batches": [], "gaps": [], "stats": [], "tower_calls": 0,
                            "engine_batches": 0}
    prepare, compute_logp, train_batch = client.prepare_batch, loop.actor.compute_logp, trainer.train_batch
    make_grids, forward_batch = trainer._make_grids, trainer.forward_batch
    tower_batch = vis.vision_forward_batch

    def tower_counted(*a, **k):
        rec["tower_calls"] += 1
        return tower_batch(*a, **k)

    def prepare_logged(*a, **k):
        b = prepare(*a, **k)
        rec["batches"].append(b)
        return b

    def make_grids_counted(inp, mb_spec=None):
        grids = make_grids(inp, mb_spec)
        rec["fwd"].append(len(grids))
        return grids

    def forward_logged(b, *a, **k):
        rec["engine_batches"] += 1
        trainer._make_grids = make_grids_counted
        try:
            return forward_batch(b, *a, **k)
        finally:
            trainer._make_grids = make_grids

    def compute_logp_logged(b):
        out = compute_logp(b)
        if not rec["gaps"]:  # the first batch: every token of v0, the trainer at v0
            rec["gaps"].append(_logprob_gap(out, b))
        return out

    def train_batch_logged(*a, **k):
        rec["engine_batches"] += 1
        st = train_batch(*a, **k)
        rec["mbs"].append(int(st["n_microbatches"]))
        return st

    client.prepare_batch, loop.actor.compute_logp = prepare_logged, compute_logp_logged
    trainer.forward_batch, trainer.train_batch = forward_logged, train_batch_logged
    vis.vision_forward_batch = tower_counted
    commit = loop.stats_logger.commit
    loop.stats_logger.commit = lambda e, s, g, stats: (rec["stats"].append(dict(stats)), commit(e, s, g, stats))[1]
    tower_t0 = {n: p.detach().clone() for n, p in trainer.model.vision.named_parameters()}
    served_t0 = {n: p.detach().clone() for n, p in engine.model.vision.named_parameters()}
    s0 = dict(engine.stats)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    try:
        # main path: counts to 0 just before, read just after
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        t0 = time.monotonic()
        loop.train(workflow=VisionRLVRWorkflow(clevr_count_reward_fn, gconfig, _VlmTokenizer(), _VlmProcessor()))
        wall = time.monotonic() - t0
        _drain_client(client, engine)
        counts = [k.launches for k in kernels]
        launches1 = paged_attention_stacked.launches
        steps = engine.stats["decode_steps"] - s0["decode_steps"]
        memo0 = rec["tower_calls"]
        b = rec["batches"][-1]
        trainer.forward_batch(b)
        trainer.forward_batch(b)  # the same batch object, the same version: no second tower run
        memo = rec["tower_calls"] - memo0
    finally:
        vis.vision_forward_batch = tower_batch
        trainer.forward_batch, trainer.train_batch = forward_batch, train_batch
        loop.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # checks
    if len(rec["stats"]) != VLM_STEPS or len(rec["batches"]) != VLM_STEPS:
        raise AssertionError(f"[vlm] {len(rec['stats'])} steps, {len(rec['batches'])} batches; want {VLM_STEPS}")
    for i, bt in enumerate(rec["batches"]):
        _check_rollout_rows(bt, 32, n_new, f"vlm batch {i}")
        n_patch = int(np.prod(VLM_GRID))
        if bt["pixel_values"].shape != (32, n_patch, QWEN2_VL_2B_VISION["patch_dim"]) or not (
                bt["pixel_counts"] == n_patch).all():
            raise AssertionError(f"[vlm] batch {i}: pixel_values {bt['pixel_values'].shape}")
    if not rec["gaps"] or rec["gaps"][0] > LOGPROB_TOL:
        raise AssertionError(f"[vlm] the trainer's logprobs vs the served ones on batch 0: {rec['gaps']}")
    moved = [n for n, p in trainer.model.vision.named_parameters() if not torch.equal(p.detach(), tower_t0[n])]
    served = dict(engine.model.vision.named_parameters())
    moved_s = [n for n, p in served.items() if not torch.equal(p.detach(), served_t0[n])]
    unequal = [n for n, p in trainer.model.vision.named_parameters()
               if not torch.equal(p.detach().to(torch.bfloat16), served[n].detach())]
    llm_served = dict(engine.model.named_parameters())
    stale = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach().to(torch.bfloat16), llm_served[n].detach())]
    if moved or moved_s or unequal or stale:
        raise AssertionError(f"[vlm] the tower moved on the trainer {moved[:3]} or the server {moved_s[:3]}, differs "
                             f"{unequal[:3]}, or the served weights are not the trainer's {stale[:3]}")
    if rec["tower_calls"] - memo != rec["engine_batches"] - 2 or memo != 1:
        raise AssertionError(f"[vlm] {rec['tower_calls'] - memo} tower runs for {rec['engine_batches'] - 2} engine "
                             f"batches; {memo} for a batch passed twice")
    _flash_counts_check("vlm", counts, {"fwd": rec["fwd"][: VLM_STEPS], "mbs": rec["mbs"]}, L)
    if steps == 0 or launches1 != L * steps:
        raise AssertionError(f"[vlm] #1 launches {launches1} != {L} layers x {steps} decode steps")
    for i, s in enumerate(rec["stats"]):
        if not (math.isfinite(s["ppo_actor/loss"]) and math.isfinite(s["ppo_actor/grad_norm"])):
            raise AssertionError(f"[vlm] step {i}: loss / grad_norm not finite")
        log(f"[vlm] {card}: GRPO step {i}: {s['step_secs']:.2f} s; rollout_wait {s['phase/rollout_wait_s']:.2f} s, "
            f"host_prep {s['phase/host_prep_s']:.2f} s, ppo_update {s['timing/train_step']:.2f} s, weight_publish "
            f"{s['phase/weight_publish_s']:.2f} s; mean reward {float(np.mean(rec['batches'][i]['rewards'])):.3f}; loss "
            f"{s['ppo_actor/loss']:.6f} grad_norm {s['ppo_actor/grad_norm']:.4f}")
    log(f"[vlm] {card}: {VLM_STEPS} GRPO steps over HTTP (8 prompts x 4 samples x {n_new} tokens, "
        f"{int(np.prod(VLM_GRID))} patches an image, the frozen tower) in {wall:.1f} s; the trainer's logprobs vs the served ones on batch 0: max|diff| "
        f"{rec['gaps'][0]:.4f} (tol {LOGPROB_TOL}); the tower bit for bit unchanged on the trainer and the server "
        f"(the served one = the trainer's in bf16); {rec['tower_calls'] - memo} tower runs for "
        f"{rec['engine_batches'] - 2} engine batches ({len(rec['fwd']) - 2} logprob recomputes, {len(rec['mbs'])} "
        f"minibatches), 1 for a batch passed twice; K2 / K3 / K4 launches {counts}; #1 launches {launches1} = {L} x "
        f"{steps} decode steps; peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    return dict(counts=dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"), counts)),
                launches1=launches1, steps=steps, gap=rec["gaps"][0], peak_gib=peak, wall_s=wall,
                step_secs=[s["step_secs"] for s in rec["stats"]], batch=rec["batches"][-1])


def _vlm_trainable(card, trainer, batch, mcfg) -> dict:
    """One ``train_vision_tower=True`` step on 1 prompt x 4 samples of the
    last batch (the first group whose rewards differ, so the advantages and
    the gradient are not zero), from the frozen trainer's weights and step
    count."""
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.trainer.ppo import PPOActor

    rewards = np.asarray(batch["rewards"]).reshape(-1, 4)
    varied = [g for g in range(len(rewards)) if rewards[g].std() > 0]
    if not varied:
        raise AssertionError(f"[vlm] no group of the last batch has rewards that differ: {rewards.tolist()}")
    rows = slice(4 * varied[0], 4 * varied[0] + 4)
    group = {k: np.asarray(v)[rows] for k, v in batch.items()}
    frozen_lp = trainer.forward_batch(group)
    count, state = trainer._opt.count, trainer.model.state_dict()
    trainer._opt = None  # the frozen run's moments go before the new engine's come
    torch.cuda.reset_peak_memory_stats()
    acfg = dataclasses.replace(_grpo_actor(train_vision_tower=True), ppo_n_minibatches=1)
    eng = TorchTrainEngine(acfg, model_config=mcfg)
    eng.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=4, train_batch_size=1), seed=0)
    eng.model.load_state_dict(state)
    del state, trainer.model
    gc.collect()
    # the run goes on from its step count: the step's LR is the schedule's
    # there, not warmup's first 0
    eng._opt.count = count
    lp = eng.forward_batch(group)
    gen = group["loss_mask"] > 0
    gap = float(np.abs(lp[gen] - frozen_lp[gen]).max())
    if gap > LOGPROB_TOL:
        raise AssertionError(f"[vlm] trainable-tower logprobs vs the frozen path's: {gap:.4f}")
    before = {n: p.detach().clone() for n, p in eng.model.vision.named_parameters()}
    actor = PPOActor(acfg, eng)
    group["prox_logp"] = actor.compute_logp(group)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stats = actor.ppo_update(actor.compute_advantages(group))
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = dict(eng.model.vision.named_parameters())
    moved = [n for n in before if not torch.equal(before[n], after[n].detach())]
    bad = [n for n, p in after.items() if not torch.isfinite(p).all()]
    gnorm = stats[0]["grad_norm"] if stats else float("nan")
    if len(stats) != 1 or len(moved) != len(before) or bad or not gnorm > 0:
        raise AssertionError(f"[vlm] trainable step: {len(stats)} minibatches, grad_norm {gnorm}; the tower moved "
                             f"in {len(moved)} of {len(before)} leaves; NaN or inf in {bad[:3]}")
    shift = max(float((after[n].detach() - before[n]).abs().max()) for n in before)
    log(f"[vlm] {card}: train_vision_tower=True: logprobs vs the frozen path's at the same weights max|diff| "
        f"{gap:.4f} (tol {LOGPROB_TOL}); one step on 4 samples (group {varied[0]}, rewards {rewards[varied[0]].tolist()}) in {step_s:.2f} s "
        f"(grad_norm {gnorm:.4f}); the tower moved "
        f"in {len(moved)} of {len(before)} leaves (largest change {shift:.3g}), all finite; peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB (predicted {VLM_TRAINABLE_PEAK_PREDICTED_GIB:.0f})")
    del eng, actor
    return dict(gap=gap, step_s=step_s, peak_gib=peak, moved=len(moved))


# ---------------------------------------------------------------------------
# shard: the trainer across GPUs (torchrun, FSDP2 x tensor parallelism)
# ---------------------------------------------------------------------------

SHARD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_shard")
SHARD_STEPS = 2
# on several cards the sharded steps sum in another order than the
# unsharded engine: each step's loss and grad norm within SHARD_STAT_RTOL
# of its, and the parameters' summed difference from its within
# SHARD_UPDATE_RTOL of the summed size of its update (a trainer that did
# not step, or stepped on another gradient, is 1 or more apart). On four
# H100s (fsdp 2 x model 2) the grad norm came 2.6e-4 apart and the update
# 0.040: the bounds are about 8x and 5x that
SHARD_STAT_RTOL = 2e-3
SHARD_UPDATE_RTOL = 0.2


def _shard_actor_cfg(**kw):
    """grpo's actor: f32 master weights, bf16 compute, the decoupled loss,
    2 minibatches, group 4."""
    from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig

    return PPOActorConfig(dtype="bfloat16", param_dtype="float32", attn_impl="pallas", gradient_checkpointing=True,
                          optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant"), group_size=4,
                          adv_norm=NormConfig(mean_level="group", std_level="batch", group_size=4),
                          use_decoupled_loss=True, prox_logp_mode="recompute", ppo_n_minibatches=2, **kw)


def _shard_batch(cfg, vocab: int) -> dict:
    """One fixed GRPO batch of the train phase's 32 sequences (8 prompts of
    64-512 tokens, 4 samples of 128 new tokens each), with seeded tokens,
    behaviour logprobs and rewards, through ``compute_advantages``."""
    from areal_tpu_torch.trainer.ppo import PPOActor
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    rng = np.random.default_rng(25)
    trajs = []
    for n in _train_sequences():
        p = n - 128
        trajs.append({"input_ids": rng.integers(0, vocab, n).astype(np.int32),
                      "loss_mask": np.r_[np.zeros(p), np.ones(128)].astype(np.float32),
                      "logprobs": np.r_[np.zeros(p), rng.normal(-2.0, 0.5, 128)].astype(np.float32),
                      "versions": np.r_[np.full(p, -1), np.zeros(128)].astype(np.int32),
                      "rewards": np.float32(rng.uniform()), "seq_no_eos_mask": np.bool_(False)})
    batch = pad_sequences_to_tensors(trajs)
    batch["prox_logp"] = np.asarray(batch["logprobs"], np.float32).copy()

    class _V:
        def get_version(self):
            return 0

    return PPOActor(cfg, _V()).compute_advantages(batch)


def _bits(tensors: dict) -> dict[str, list[int]]:
    """A fingerprint of each tensor's bits, computed on its device: the
    int64 sum of its elements' bit patterns and that sum weighted by the
    element's position (mod 8191). Equal bits, equal fingerprints; a
    changed element changes both."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    out = {}
    for n, t in tensors.items():
        b = t.detach().contiguous().view(ints[t.element_size()]).reshape(-1).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 8191 + 1
        out[n] = [int(b.sum()), int((b * w).sum())]
    return out


def _dev_bf16(t: torch.Tensor, device) -> torch.Tensor:
    """A leaf (a mesh's gathered leaves are on the host) cast to bf16 on
    ``device``."""
    return t.to(device).to(torch.bfloat16)


def _engine_bits(eng) -> dict:
    """``_bits`` of an engine's master parameters and AdamW moments, whole:
    on a mesh each leaf gathered in turn (every rank calls it)."""
    out = {}
    for g, ts in eng._state_groups(with_optim=True).items():
        out[g] = {}
        for n, t in ts.items():
            out[g].update(_bits({n: eng._full_leaf(n, t) if eng.mesh is not None else t}))
    return out


def phase_shard(card: str) -> dict:
    """The trainer across GPUs: the unsharded engine here, then the same
    trainer under ``torchrun`` (one rank a card, NCCL) in ``shard_worker``,
    one after the other (two trainers with f32 AdamW state and a server
    would crowd the card). Both take SHARD_STEPS ``train_batch`` steps on
    one fixed batch from the same seed: the parameters compared (the
    largest difference; bit for bit at one rank, where FSDP2 keeps the op
    order), K2 / K3 / K4 launched as often, the server's weights after the
    sharded push those of the unsharded weights cast to bf16, and a recover
    dump crossing both ways (the unsharded engine's loaded on the mesh, the
    mesh's loaded here), bit for bit. The worker then runs SHARD_STEPS
    global steps of ``PPOTrainer.train`` under ``allocation_mode`` over
    HTTP against the port's server on the same card."""
    import shutil

    from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[shard] {held:.2f} GiB still allocated by earlier phases")
    shutil.rmtree(SHARD_ROOT, ignore_errors=True)
    os.makedirs(SHARD_ROOT)
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    acfg = _shard_actor_cfg()
    adv = _shard_batch(acfg, mcfg.vocab_size)
    with open(os.path.join(SHARD_ROOT, "batch.pkl"), "wb") as f:
        import pickle

        pickle.dump(adv, f)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    # the unsharded reference, in this process (no torch.distributed)
    ref = TorchTrainEngine(acfg, model_config=mcfg)
    ref.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=32, train_batch_size=8), seed=0)
    theta0 = {n: t.detach().cpu() for n, t in ref._export_params().items()}  # the start, on the host
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    step_s, ref_stats = [], []
    for _ in range(SHARD_STEPS):
        t = time.monotonic()
        st = ref.train_batch(adv, lambda o, b: _grpo_loss(o, b, acfg), _wfn)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        ref_stats.append({k: st[k] for k in ("loss", "grad_norm")})
    ref_counts = [k.launches for k in kernels]
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    # the summed size of the update: sum |theta - theta0| over every element
    update_l1 = sum(float((t - theta0[n].to(t.device)).abs().sum(dtype=torch.float64))
                    for n, t in ref._export_params().items())
    del theta0
    ref_bits = _engine_bits(ref)
    push_bits = _bits({n: t.to(torch.bfloat16) for n, t in ref._export_params().items()})
    # the crossings' dumps hold the parameters: the moments' crossing is the
    # CPU twins' (tests/test_torch_parallel.py), and 18.5 GB dumps both ways
    # cost 90 s of disk on a slow host
    ref.save(SaveLoadMeta(path=os.path.join(SHARD_ROOT, "unsharded"), weight_format="state", with_optim=False))
    with open(os.path.join(SHARD_ROOT, "ref.json"), "w") as f:
        json.dump({"bits": ref_bits, "push_bits": push_bits, "counts": ref_counts, "stats": ref_stats}, f)
    log(f"[shard] unsharded engine ({time.monotonic() - t_phase:.1f} s with its dump): {SHARD_STEPS} steps "
        f"{', '.join(f'{s:.2f}' for s in step_s)} s, peak "
        f"torch.cuda.max_memory_allocated {ref_peak:.2f} GiB, K2 / K3 / K4 {ref_counts}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    # the sharded run: torchrun, one rank a card
    n = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
           os.path.abspath(__file__), "--shard-worker", SHARD_ROOT]
    t_run = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=420, start_new_session=True)
    for line in proc.stdout.splitlines():
        log(f"[shard/worker] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[shard] torchrun exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    with open(os.path.join(SHARD_ROOT, "shard.json")) as f:
        res = json.load(f)
    log(f"[shard] torchrun ran {time.monotonic() - t_run:.1f} s")

    # the mesh's recover dump, loaded by an unsharded engine
    t_load = time.monotonic()
    one = TorchTrainEngine(acfg, model_config=mcfg)
    one.initialize(FinetuneSpec(total_train_epochs=1, dataset_size=32, train_batch_size=8), seed=1)
    one.load(SaveLoadMeta(path=os.path.join(SHARD_ROOT, "mesh"), weight_format="state", with_optim=False))
    loaded = _engine_bits(one)["params"]
    if loaded != res["mesh_bits"]["params"]:
        raise AssertionError("[shard] the mesh's recover dump, loaded here, is not the mesh's state")
    log(f"[shard] the mesh's dump loaded by an unsharded engine in {time.monotonic() - t_load:.1f} s")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    same = res["mesh_bits"] == ref_bits
    log(f"[shard] {card}: world {res['world']} ({res['backend']}); parameters after {SHARD_STEPS} steps against "
        f"the unsharded engine: largest difference {res['max_param_diff']:.3e} (bit for bit: {same}); step "
        f"{', '.join(f'{s:.2f}' for s in res['step_s'])} s sharded vs {', '.join(f'{s:.2f}' for s in step_s)} s "
        f"unsharded; peak {res['peak_gib']:.2f} vs {ref_peak:.2f} GiB; K2 / K3 / K4 {res['counts']} vs "
        f"{ref_counts}; the server's weights after the sharded push {'equal' if res['push_same'] else 'DIFFER'} "
        f"(to the unsharded engine's: {res['push_equals_unsharded']}); "
        f"recover dumps (parameters) both ways bit for bit; the loop: {res['loop']}")
    stat_rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(res["stats"], ref_stats) for k in b)
    update_rel = res["param_diff_l1"] / update_l1
    log(f"[shard] per step (loss, grad norm): sharded {[(s['loss'], s['grad_norm']) for s in res['stats']]}, "
        f"unsharded {[(s['loss'], s['grad_norm']) for s in ref_stats]}: largest relative difference {stat_rel:.3e} "
        f"(bound {SHARD_STAT_RTOL}); parameters' summed difference {res['param_diff_l1']:.6e} against the "
        f"unsharded update's summed size {update_l1:.6e}: {update_rel:.3e} (bound {SHARD_UPDATE_RTOL}); "
        f"rank 0's gather of the weights {res['gather_s']:.2f} s, {res['gather_peak_gib']:.3f} GiB on the card above "
        f"its resting state; the push {res['push_s']:.2f} s, {res['push_peak_gib']:.3f} GiB above it (the colocated "
        f"server's staging included); offload on the mesh {res['offload']}")
    if res["world"] == 1 and not (same and res["push_equals_unsharded"] and res["stats"] == ref_stats):
        raise AssertionError("[shard] a world of one must give the unsharded engine's bits")
    # several ranks sum in another order: the trainer twin's bound
    # (tests/test_torch_train_engine.py), two steps of Adam at most 2 LR
    # apart, and the bounds above, which separate a wrong update
    if res["max_param_diff"] > 2 * acfg.optimizer.lr:
        raise AssertionError(f"[shard] parameters {res['max_param_diff']:.3e} apart, over 2 LR")
    if stat_rel > SHARD_STAT_RTOL or update_rel > SHARD_UPDATE_RTOL:
        raise AssertionError(f"[shard] loss / grad norm {stat_rel:.3e} apart or the update {update_rel:.3e} apart")
    if res["counts"] != ref_counts:
        raise AssertionError(f"[shard] K2 / K3 / K4 launches {res['counts']} != the unsharded run's {ref_counts}")
    if not (res["push_same"] and res["unsharded_loaded_same"]):
        raise AssertionError("[shard] the push or the unsharded dump's load on the mesh differs")
    log(f"[shard] phase {time.monotonic() - t_phase:.1f} s")
    shutil.rmtree(SHARD_ROOT, ignore_errors=True)
    return {"counts": dict(zip(("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                               res["loop"]["counts"])), "launches1": res["loop"]["launches1"], "res": res,
            "ref_step_s": step_s, "ref_peak_gib": ref_peak}


def _grpo_loss(outputs, b, cfg):
    from areal_tpu_torch.trainer.ppo import grpo_loss_fn

    return grpo_loss_fn(outputs, b, cfg)


def shard_worker(root: str) -> None:
    """One rank of ``phase_shard``'s world (under ``torchrun``): the twin's
    SHARD_STEPS steps, the push into a server over HTTP, the recover dumps,
    then ``PPOTrainer.train`` under ``allocation_mode``. Rank 0 writes
    ``shard.json``."""
    import pickle

    import torch.distributed as dist

    from areal_tpu_torch.api.config import (DatasetConfig, InferenceEngineConfig, MeshConfig, PPOConfig,
                                            PreemptionConfig, ServerConfig)
    from areal_tpu_torch.api.io_struct import FinetuneSpec, GenerationHyperparameters, SaveLoadMeta, WeightUpdateMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.utils.safetensors_io import SafetensorsFile
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    lead = rank == 0
    marks = [("start", time.monotonic())]

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        marks.append((name, time.monotonic()))

    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": CUT_LAYERS})
    with open(os.path.join(root, "batch.pkl"), "rb") as f:
        adv = pickle.load(f)
    with open(os.path.join(root, "ref.json")) as f:
        ref = json.load(f)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    ft = FinetuneSpec(total_train_epochs=1, dataset_size=32, train_batch_size=8)
    tp = 2 if world % 2 == 0 else 1  # on several cards, tensor parallelism too
    acfg = _shard_actor_cfg(mesh=MeshConfig(data=1, fsdp=world // tp, model=tp))
    eng = TorchTrainEngine(acfg, model_config=mcfg)  # joins torchrun's world (NCCL) at initialize
    eng.initialize(ft, seed=0)
    if not dist.is_initialized() or eng.mesh is None:
        raise AssertionError("the engine did not take the sharded path under torchrun")
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    if lead:
        print(f"world {world}, backend {dist.get_backend()}, NCCL {nccl}, mesh "
              f"{dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape))}, device {eng.device}", flush=True)
    scfg = ServerConfig(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16,
                        weight_stage_target="device", host="127.0.0.1", seed=0)
    # rank 0's, on the host (off the peaks): the servers' start
    init = {n: _dev_bf16(t, eng.device).cpu() for n, t in eng._export_params().items()}
    mark("world and engine up")
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    step_s, stats = [], []
    for _ in range(SHARD_STEPS):
        t = time.monotonic()
        st = eng.train_batch(adv, lambda o, b: _grpo_loss(o, b, acfg), _wfn)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        stats.append({k: st[k] for k in ("loss", "grad_norm")})
    counts = [k.launches for k in kernels]
    peak = torch.cuda.max_memory_allocated() / 2**30
    mark("twin steps")
    out = {"world": world, "backend": dist.get_backend(), "nccl": nccl, "step_s": step_s, "counts": counts,
           "peak_gib": peak, "stats": stats}
    # the gather of the weights (every rank; rank 0 keeps them on the host):
    # its time and rank 0's card memory above the resting state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated()
    t = time.monotonic()
    params = eng._export_params()
    out["gather_s"] = time.monotonic() - t
    out["gather_peak_gib"] = (torch.cuda.max_memory_allocated() - rest) / 2**30
    # the largest and the summed difference from the unsharded engine's
    # parameters (its dump)
    if lead:
        f = SafetensorsFile(os.path.join(root, "unsharded", "state", "params.safetensors"))
        out["max_param_diff"] = out["param_diff_l1"] = 0.0
        for n, t in params.items():
            d = (t.to(eng.device) - f.get(n).to(eng.device)).abs()
            out["max_param_diff"] = max(out["max_param_diff"], float(d.max()))
            out["param_diff_l1"] += float(d.sum(dtype=torch.float64))
        del d
    mark("largest difference")
    # the push over HTTP into a server started from the initial weights
    srv = client = None
    if lead:
        srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=init, model_cfg=mcfg))
        srv.start()
        client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
        client.initialize()
    pushed = {}
    for n, t in params.items():
        pushed.update(_bits({n: _dev_bf16(t, eng.device)}))
    del params
    eng.connect_engine(client, WeightUpdateMeta(type="mem"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated()
    t = time.monotonic()
    eng.update_weights()
    out["push_s"] = time.monotonic() - t
    out["push_peak_gib"] = (torch.cuda.max_memory_allocated() - rest) / 2**30
    if lead:
        served = _bits({n: p for n, p in srv.engine.model.named_parameters() if n in pushed})
        out["push_same"] = served == pushed
        out["push_equals_unsharded"] = served == ref["push_bits"]
        client.destroy()
        srv.stop()
    srv = client = None
    mark("server, push, check")
    # the recover dumps: the mesh's written, the unsharded engine's read
    out["mesh_bits"] = _engine_bits(eng)
    mark("state fingerprint")
    # offload and onload on the mesh: FSDP2's shard storages and the moments
    # to pinned host memory and back, the state bit for bit after
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    local = sum(x.numel() * x.element_size() for x in eng._offload_targets())
    t = time.monotonic()
    eng.offload()
    off_s = time.monotonic() - t
    freed = held - torch.cuda.memory_allocated()
    t = time.monotonic()
    eng.onload()
    on_s = time.monotonic() - t
    back = _engine_bits(eng)
    out["offload"] = {"freed_gib": freed / 2**30, "state_gib": local / 2**30, "offload_s": off_s, "onload_s": on_s}
    if back != out["mesh_bits"] or freed < local:
        raise AssertionError(f"[shard] rank {rank}: offload / onload on the mesh: {out['offload']}, state "
                             f"{'equal' if back == out['mesh_bits'] else 'CHANGED'}")
    mark("offload, onload, fingerprint")
    eng.save(SaveLoadMeta(path=os.path.join(root, "mesh"), weight_format="state", with_optim=False))
    mark("recover dump written")
    eng.load(SaveLoadMeta(path=os.path.join(root, "unsharded"), weight_format="state", with_optim=False))
    loaded = _engine_bits(eng)  # every rank joins the gathers
    out["unsharded_loaded_same"] = loaded["params"] == ref["bits"]["params"] if lead else None
    mark("unsharded dump loaded")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # PPOTrainer.train under allocation_mode, over HTTP, the server on rank 0
    group, n_new = 4, 128
    gconfig = GenerationHyperparameters(n_samples=group, max_new_tokens=n_new, temperature=1.0)
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name="shard",
                    allocation_mode=f"sglang:d1+fsdp:d{world // tp}" + (f"t{tp}" if tp > 1 else ""),
                    weight_update_mode="mem", total_train_steps=SHARD_STEPS, preemption=PreemptionConfig(enabled=False),
                    gconfig=gconfig, train_dataset=DatasetConfig(batch_size=8), actor=_shard_actor_cfg(),
                    rollout=InferenceEngineConfig(**GRPO_CLIENT))
    cfg.cluster.fileroot = os.path.join(root, "loop")
    trainer = TorchTrainEngine(cfg.actor, model_config=mcfg)  # sized by allocation_mode, initialized by the loop
    if lead:
        srv = ServerThread(scfg, engine=DecodeEngine(scfg, params=init, model_cfg=mcfg))
        srv.start()
        client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
        client.initialize()
    del init
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(0, mcfg.vocab_size, int(n)).tolist()}
               for n in rng.integers(64, 513, GRPO_PROMPTS)]
    loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
    mark("loop up")
    steps = []
    if lead:
        commit = loop.stats_logger.commit
        loop.stats_logger.commit = lambda e, s, g, st: steps.append(st["step_secs"]) or commit(e, s, g, st)
    for kern in (*kernels, paged_attention_stacked):
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
    if lead:  # drain: no new submissions, the episodes in flight finish
        client.pause()
        deadline = time.monotonic() + 600
        while client.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
        while any(t is not None for t in srv.engine._slot_task) and time.monotonic() < deadline:
            time.sleep(0.01)
    loop_counts = [k.launches for k in kernels]
    mark("loop steps")
    params = trainer._export_params()
    if lead:
        served = dict(srv.engine.model.named_parameters())
        same = all(_bits({n: _dev_bf16(t, trainer.device)}) == _bits({n: served[n]}) for n, t in params.items())
        out["loop"] = {"mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
                       "versions": [trainer.get_version(), srv.engine.get_version()], "served_same": same,
                       "step_s": steps, "counts": loop_counts, "launches1": paged_attention_stacked.launches,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params
    loop.close()
    if lead:
        srv.stop()
        loop_ok = out["loop"]["versions"] == [SHARD_STEPS, SHARD_STEPS] and out["loop"]["served_same"]
        if not loop_ok or min(loop_counts) == 0 or out["loop"]["launches1"] == 0:
            raise AssertionError(f"[shard] the loop under allocation_mode: {out['loop']}")
        mark("loop checked")
        out["parts"] = {b[0]: round(b[1] - a[1], 2) for a, b in zip(marks, marks[1:])}
        print("parts (s): " + ", ".join(f"{k} {v}" for k, v in out["parts"].items()), flush=True)
        with open(os.path.join(root, "shard.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


ENTRY_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "smoke", "synthetic_grpo.yaml")
ENTRY_CLI_LAYERS = 4  # the CLI server's depth at Qwen2.5-1.5B width (the phase's time limit)
ENTRY_EVAL_ROWS = 32  # the eval's cut of synthetic_arith's test split
ENTRY_GREEDY = 8  # requests whose greedy tokens the CLI server and an in-process engine must share
ENTRY_EXIT_CODE = 17  # the CLI server's preemption.exit_code: not a code a crash gives


def _entry_overrides(root: str) -> list[str]:
    """Every file the entry writes goes under ``root``; no signal handlers."""
    return ["preemption.enabled=false", *(f"{k}.fileroot={root}" for k in (
        "cluster", "saver", "checkpointer", "evaluator", "recover", "stats_logger"))]


def phase_entry(card: str) -> dict:
    """The entry layer on the card, the way a user starts the system: (a)
    ``gsm8k_rl.main`` on ``examples/smoke/synthetic_grpo.yaml`` with
    overrides (Qwen2.5-1.5B at full width and depth from a written
    ``config.json``, random bf16-compute weights from the YAML's seed, 2
    steps): every response complete, finite losses, the version advancing
    with each push, the launches of #1, K2 (with and without lse), K3, K4
    and #3; (b) the same YAML as it stands (the tiny head_dim-16 model)
    raising the kernel's own refusal with no server thread left; (c)
    ``python -m areal_tpu_torch.inference.server`` as a subprocess
    (``precompile`` and the preemption drainer on) over a 4-layer export:
    ``gsm8k_eval.main`` in fleet mode, greedy tokens equal to an in-process
    engine's, and SIGTERM draining it to its exit code with a flight dump."""
    import shutil
    import signal as signal_mod
    import socket

    from areal_tpu_torch import dataset as ds_mod
    from areal_tpu_torch.api.config import ServerConfig, load_expr_config
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
    from areal_tpu_torch.examples.math import gsm8k_eval, gsm8k_rl
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.hf import save_params_to_hf, write_hf_config
    from areal_tpu_torch.ops import attention as fa
    from areal_tpu_torch.ops.paged_attention import paged_attention_stacked
    from areal_tpu_torch.ops.paged_suffix_attention import paged_suffix_attention as psa
    from areal_tpu_torch.utils import stats_logger

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[entry] {held:.2f} GiB still allocated by earlier phases")
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")  # the export, configs, logs, dumps; deleted at the end
    repo = os.path.dirname(os.path.abspath(__file__))
    res: dict = {}
    proc = None
    try:
        # (c) first, so the subprocess boots while (a) runs: a 4-layer export
        # from a seed and the server's YAML document
        cli_cfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": ENTRY_CLI_LAYERS})
        export = os.path.join(root, "export")
        t0 = time.monotonic()
        model = qwen.init_params(cli_cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        nbytes = save_params_to_hf(model, cli_cfg, export)
        del model
        export_s = time.monotonic() - t0
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        server_yaml = os.path.join(root, "server.yaml")
        with open(server_yaml, "w") as f:
            f.write(
                "# a ServerConfig document (the CLI's --config)\n"
                "dtype: bfloat16\nmax_batch_size: 8\nmax_seq_len: 256\npage_size: 128\n"
                f"decode_steps_per_call: 4\nhost: 127.0.0.1\nport: {port}\nseed: 0\nprecompile: true\n"
                f"preemption:\n  enabled: true\n  grace_s: 15.0\n  drain_budget_s: 3.0\n  exit_code: {ENTRY_EXIT_CODE}\n"
            )
        flight_dir = os.path.join(root, "flight")
        env = {**os.environ, "AREAL_FLIGHT_DIR": flight_dir,
               "PYTHONPATH": os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH", "")) if p)}
        log_path = os.path.join(root, "server.log")
        t_launch = time.monotonic()
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "areal_tpu_torch.inference.server", "--config", server_yaml,
                 f"model_path={export}"], cwd=repo, env=env, stdout=logf, stderr=subprocess.STDOUT)
        addr = f"127.0.0.1:{port}"
        healthy: dict = {}

        def watch_health():
            while proc.poll() is None and "s" not in healthy:
                try:
                    with urllib.request.urlopen(f"http://{addr}/health", timeout=2) as r:
                        if r.status == 200:
                            healthy["s"] = time.monotonic() - t_launch
                            return
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                time.sleep(0.2)

        watcher = threading.Thread(target=watch_health, daemon=True)
        watcher.start()
        log(f"[entry] {ENTRY_CLI_LAYERS}-layer export {nbytes / 1e9:.2f} GB in {export_s:.1f}s; CLI server launched "
            f"on {addr}")

        # (a) GRPO through the entry: Qwen2.5-1.5B at full width and depth
        mdir = os.path.join(root, "qwen25_15b")
        write_hf_config(qwen.ModelConfig(**QWEN25_15B), mdir)
        argv = ["--config", ENTRY_YAML, f"actor.path={mdir}", "actor.dtype=bfloat16", "server.max_seq_len=256",
                "total_train_steps=2", "train_dataset.batch_size=8", "gconfig.max_new_tokens=8",
                *_entry_overrides(os.path.join(root, "grpo"))]
        committed, responses, pushes, lse_flags = [], [], [], []
        commit, agenerate = stats_logger.StatsLogger.commit, RemoteTorchEngine.agenerate
        commit_staged, fwd = DecodeEngine.commit_staged_weights, fa.flash_attention_fwd

        def commit_logged(self, epoch, step, global_step, data):
            committed.append(dict(data))
            return commit(self, epoch, step, global_step, data)

        async def agenerate_logged(self, req):
            resp = await agenerate(self, req)
            responses.append(resp)
            return resp

        def commit_staged_logged(self, version=None):
            pushes.append(version)
            return commit_staged(self, version)

        def fwd_logged(*a, with_lse, **k):
            lse_flags.append(bool(with_lse))
            return fwd(*a, with_lse=with_lse, **k)

        fwd_logged.launches = 0
        kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
        for kern in kernels:
            kern.launches = 0
        paged_attention_stacked.launches = 0
        for kind in psa.launches:
            psa.launches[kind] = 0
        (stats_logger.StatsLogger.commit, RemoteTorchEngine.agenerate, DecodeEngine.commit_staged_weights,
         fa.flash_attention_fwd) = commit_logged, agenerate_logged, commit_staged_logged, fwd_logged
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        try:
            trainer = gsm8k_rl.main(argv)
        finally:
            (stats_logger.StatsLogger.commit, RemoteTorchEngine.agenerate, DecodeEngine.commit_staged_weights,
             fa.flash_attention_fwd) = commit, agenerate, commit_staged, fwd
        grpo_s = time.monotonic() - t0
        counts = {k.__name__: k.launches for k in kernels}
        # K2's wrapper adds to the count of the name it is called by: the
        # module global, which was fwd_logged during the call
        counts["flash_attention_fwd"] = fwd_logged.launches
        launches1, launches3 = paged_attention_stacked.launches, sum(psa.launches.values())
        peak = torch.cuda.max_memory_allocated() / 2**30
        L = QWEN25_15B["num_layers"]
        n_lse = sum(lse_flags)
        gen_tokens = sum(len(r.output_tokens) for r in responses)
        step_s = [d["step_secs"] for d in committed]
        for i, d in enumerate(committed):
            ph = ", ".join(f"{k[6:-2]} {v:.2f}" for k, v in sorted(d.items()) if k.startswith("phase/") and v)
            log(f"[entry] step {i + 1}: {d['step_secs']:.2f} s ({ph}); loss {d.get('ppo_actor/loss')}, version "
                f"{d.get('version')}")
        log(f"[entry] gsm8k_rl.main on {os.path.relpath(ENTRY_YAML, repo)} at {L} layers: {grpo_s:.1f} s in all "
            f"(build, 2 steps, teardown); {len(responses)} responses, {gen_tokens} generated tokens, "
            f"{gen_tokens / sum(step_s):.1f} generated tokens/s over the steps; peak {peak:.2f} GiB")
        log(f"[entry] launches: #1 {launches1} ({launches1 / L:.0f} decode steps x {L}), K2 "
            f"{counts['flash_attention_fwd']} ({n_lse} keeping lse, {len(lse_flags) - n_lse} without), K3 "
            f"{counts['flash_attention_bwd_dkv']}, K4 {counts['flash_attention_bwd_dq']}, #3 {launches3} "
            f"({dict(psa.launches)})")
        versions = [int(d["version"]) for d in committed]
        if versions != [1, 2] or pushes != [1, 2] or trainer.actor_engine.get_version() != 2:
            raise AssertionError(f"[entry] versions: committed {versions}, pushed {pushes}, trainer "
                                 f"{trainer.actor_engine.get_version()}")
        losses = [d["ppo_actor/loss"] for d in committed]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[entry] non-finite losses {losses}")
        bad = [r.stop_reason for r in responses if r.stop_reason not in ("stop", "length") or not r.output_tokens
               or len(r.output_tokens) > 8]
        if bad or len(responses) < 2 * 8 * 4:
            raise AssertionError(f"[entry] {len(responses)} responses, incomplete: {bad[:4]}")
        if min(counts.values()) == 0 or launches1 == 0:
            raise AssertionError(f"[entry] a kernel of the path did not launch: {counts}, #1 {launches1}")
        res.update(counts=counts, launches1=launches1, launches3=launches3, k2_lse=n_lse, grpo_s=grpo_s,
                   losses=losses)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the YAML as it stands: the tiny model's head_dim 16 is refused
        threads = {t.name for t in threading.enumerate()}
        try:
            gsm8k_rl.main(["--config", ENTRY_YAML, "total_train_steps=2",
                           *_entry_overrides(os.path.join(root, "tiny"))])
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("[entry] the tiny model ran on the card: no kernel refused it")
        if "head_dim 16" not in refusal:
            raise AssertionError(f"[entry] not the kernel's refusal: {refusal!r}")
        time.sleep(0.5)
        left = {t.name for t in threading.enumerate()} - threads
        if left & {"http-server", "decode-loop"}:
            raise AssertionError(f"[entry] threads left running after the refusal: {left}")
        log(f"[entry] synthetic_grpo.yaml as written refused: {refusal}; no server thread left")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CLI server: fleet-mode eval, greedy twin, SIGTERM drain
        watcher.join(timeout=max(1.0, 120 - (time.monotonic() - t_launch)))
        if "s" not in healthy:
            raise AssertionError(f"[entry] CLI server not healthy (exit {proc.poll()}):\n" +
                                 open(log_path).read()[-3000:])
        orig_arith = ds_mod._REGISTRY["synthetic_arith"]
        ds_mod._REGISTRY["synthetic_arith"] = functools.partial(orig_arith, n=ENTRY_EVAL_ROWS)
        os.environ["AREAL_TPU_SERVER_ADDRS"] = addr
        try:
            ev = gsm8k_eval.main(["--config", ENTRY_YAML, "gconfig.max_new_tokens=16"])
        finally:
            ds_mod._REGISTRY["synthetic_arith"] = orig_arith
            os.environ.pop("AREAL_TPU_SERVER_ADDRS", None)
        if ev["n"] != ENTRY_EVAL_ROWS or ev["failed"]:
            raise AssertionError(f"[entry] eval scored {ev}")
        scfg, _ = load_expr_config(["--config", server_yaml, f"model_path={export}"], ServerConfig)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cli_cfg.vocab_size, int(n)).tolist() for n in rng.integers(16, 120, ENTRY_GREEDY)]
        served = [_post(addr, "/generate", {"input_ids": p, "sampling_params": {"max_new_tokens": 16, "greedy": True}})
                  ["output_tokens"] for p in prompts]
        twin = DecodeEngine(scfg)
        twin.initialize()
        twin.start()
        try:
            gcfg = GenerationHyperparameters(max_new_tokens=16, greedy=True)
            local = [twin.generate_sync(ModelRequest(input_ids=p, gconfig=gcfg)).output_tokens for p in prompts]
        finally:
            twin.stop()
            del twin
        differ = [i for i, (a, b) in enumerate(zip(served, local)) if list(a) != list(b)]
        if differ:
            raise AssertionError(f"[entry] greedy tokens of requests {differ} differ between the CLI server and the "
                                 "in-process engine")
        t_term = time.monotonic()
        proc.send_signal(signal_mod.SIGTERM)
        try:
            rc = proc.wait(timeout=15.0)
        except subprocess.TimeoutExpired:
            raise AssertionError("[entry] the CLI server outlived its 15 s grace window") from None
        drain_s = time.monotonic() - t_term
        dumps = [f for f in os.listdir(flight_dir) if f.endswith("_preempt.json")] if os.path.isdir(flight_dir) else []
        if rc != ENTRY_EXIT_CODE or not dumps:
            raise AssertionError(f"[entry] SIGTERM: exit {rc} (want {ENTRY_EXIT_CODE}), flight dumps {dumps}:\n" +
                                 open(log_path).read()[-3000:])
        with open(os.path.join(flight_dir, dumps[0])) as f:
            kinds = {e["kind"] for e in json.load(f)["events"]}
        log(f"[entry] CLI server: /health {healthy['s']:.1f} s after launch (precompile included); eval n "
            f"{ev['n']}, accuracy {ev['accuracy']:.4f}, mean reward {ev['mean_reward']:.4f}; greedy tokens of "
            f"{ENTRY_GREEDY} requests equal to the in-process engine's; SIGTERM -> exit {rc} in {drain_s:.2f} s, "
            f"flight dump {dumps[0]} ({sorted(kinds)})")
        res.update(health_s=healthy["s"], eval=ev, drain_s=drain_s)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    res["s"] = time.monotonic() - t_phase
    log(f"[entry] phase {res['s']:.1f} s on {card}")
    return res


# serving on a model=2 mesh: each rank's heads are Qwen2.5-1.5B's halves
# (H=6, KH=1); two engines of one seed part only where bf16 rounds in other
# places (the row-parallel products sum their halves after rounding each),
# so a greedy divergence is accepted only where both tokens sit within the
# served-vs-dense bound of the dense argmax
SERVE_TP_TIE = LOGPROB_TOL
SERVE_TP_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_serve_tp")
SERVE_TP_EXIT_CODE = 19  # the mesh CLI server's preemption.exit_code
SERVE_TP_STEPS = 2  # the disaggregated loop's GRPO steps
# new tokens a request on the one-card stand-in (both ranks over gloo, ~157
# ms a decode step: 128 new tokens took the phase to 253 s, PERF.md); 128
# (the serve cell's) on two or more cards
SERVE_TP_STANDIN_NEW = 32


def _tp_checked(L: int) -> tuple:
    """The leaves of an L-layer Qwen2.5-1.5B whose served slices are held
    to a push's bits."""
    return ("embed", "final_norm", "layers.0.wq", "layers.0.bk", f"layers.{L // 2 - 1}.wo", f"layers.{L - 1}.w_down",
            f"layers.{L - 1}.w_up")


def _tp_traffic(V: int) -> dict[str, list[list[int]]]:
    """The serve phase's cold and warm prompts, and 8 periodic prompts (a
    48-token motif 6 times over: the n-gram drafter's hits) for the
    speculative rounds."""
    rng = np.random.default_rng(0)
    cold = [rng.integers(0, V, int(n)).tolist() for n in rng.integers(64, 513, 16)]
    rng = np.random.default_rng(3)
    system = rng.integers(0, V, 1024).tolist()
    warm = [system + rng.integers(0, V, int(n)).tolist() for n in rng.integers(64, 257, 16)]
    rng = np.random.default_rng(11)
    spec = [rng.integers(0, V, 48).tolist() * 6 for _ in range(8)]
    return {"cold": cold, "warm": warm, "spec": spec}


def _tp_body(p: list[int], i: int, n_new: int = 128, greedy: bool = False) -> dict:
    sp = {"max_new_tokens": n_new, "greedy": True} if greedy or i % 2 == 0 else {"max_new_tokens": n_new,
                                                                                 "temperature": 1.0}
    return {"input_ids": p, "sampling_params": sp}


def _tp_waves(tag: str, srv, engine, traffic: dict, dense_model, tol: float, card: str, n_new: int) -> dict:
    """The cold wave of 16 and the warm wave of 16 (the first alone, then 15
    through radix hits) over HTTP, #1 and #3 counted from 0 on every rank;
    complete responses, logprobs against a dense prefill of
    ``dense_model``, the pool audit after ``/flush_prefix_cache``."""
    cold, warm = traffic["cold"], traffic["warm"]
    keys = ("decode_steps", "prefix_hit_tokens", "suffix_prefill_batches")
    # main path: counts to 0 just before, read just after (on every rank)
    engine.reset_rank_launches()
    s0, dev0 = {k: engine.stats[k] for k in keys}, engine.device_seconds()
    t0 = time.monotonic()
    resps = _wave(srv.address, [_tp_body(p, i, n_new) for i, p in enumerate(cold)])
    cold_wall = time.monotonic() - t0
    resps += _wave(srv.address, [_tp_body(warm[0], 0, n_new)])
    t1 = time.monotonic()
    resps += _wave(srv.address, [_tp_body(p, i, n_new) for i, p in enumerate(warm[1:], 1)])
    warm_wall = time.monotonic() - t1
    ranks = engine.rank_launches()
    d = {k: engine.stats[k] - s0[k] for k in keys}
    dev = engine.device_seconds()
    for r in resps:
        _check_response(r, n_new, tag)
    L = engine.model_cfg.num_layers
    for rank, c in enumerate(ranks):
        if d["decode_steps"] == 0 or c["paged_attention"] != L * d["decode_steps"]:
            raise AssertionError(f"[{tag}] rank {rank}: #1 launches {c['paged_attention']} != {L} x "
                                 f"{d['decode_steps']} decode steps")
        chain = c["paged_suffix_attention"]["chain"]
        if d["prefix_hit_tokens"] <= 0 or not chain or chain != L * d["suffix_prefill_batches"]:
            raise AssertionError(f"[{tag}] rank {rank}: warm wave {d}, #3 launches {c['paged_suffix_attention']}")
    prompts = cold + warm
    errs = [_dense_check(dense_model, prompts[i], resps[i], greedy=False) for i in (1, 3, 17, 19)]
    gaps = [_dense_check(dense_model, prompts[i], resps[i], greedy=True) for i in (0, 2, 18, 20)]
    if max(errs) > tol or max(gaps) > tol:
        raise AssertionError(f"[{tag}] served logprobs vs a dense prefill: {errs}, greedy gaps {gaps} (tol {tol})")
    stats = _post(srv.address, "/flush_prefix_cache", {})
    audit = engine.pool_audit()
    if not (audit["ok"] and audit["radix_pages"] == 0):
        raise AssertionError(f"[{tag}] pool audit after the flush: {audit}")
    steps = dev["decode_steps"] - dev0["decode_steps"]
    out = dict(ms_per_step=(dev["decode_s"] - dev0["decode_s"]) / steps * 1e3,
               wall_ms_per_step=(cold_wall + warm_wall) / d["decode_steps"] * 1e3,
               decode_tok_s=16 * n_new / cold_wall, launches=ranks, n_new=n_new, decode_steps=d["decode_steps"],
               suffix_batches=d["suffix_prefill_batches"], hit_tokens=d["prefix_hit_tokens"],
               dense_err=max(errs), greedy_gap=max(gaps), tokens=[r["output_tokens"] for r in resps],
               prompts=prompts)
    log(f"[{tag}] {card}: 32/32 responses complete (cold 16 in {cold_wall:.2f} s, warm 15 in {warm_wall:.2f} s "
        f"through {d['prefix_hit_tokens']} radix hit tokens); {out['ms_per_step']:.2f} ms per decode step (lead's "
        f"device stream), {out['wall_ms_per_step']:.2f} ms wall; cold {out['decode_tok_s']:.1f} decode tok/s; per "
        f"rank #1 {[c['paged_attention'] for c in ranks]} (= {L} x {d['decode_steps']}), #3 chain "
        f"{[c['paged_suffix_attention']['chain'] for c in ranks]} (= {L} x {d['suffix_prefill_batches']}); logprobs "
        f"vs a dense prefill max|diff| {max(errs):.4f}, greedy gap {max(gaps):.4f} (tol {tol}); pool audit ok after "
        f"the flush ({stats['freed_pages']} pages freed)")
    return out


def _tp_greedy_ties(model, got: dict, want: dict, what: str) -> list:
    """The greedy requests (even indices) of two runs of the same traffic:
    equal, or parting at a near-tie (``SERVE_TP_TIE``)."""
    idx = [i for i in range(len(want["tokens"])) if i % 2 == 0]
    return _near_ties(model, [want["prompts"][i] for i in idx], [got["tokens"][i] for i in idx],
                      [want["tokens"][i] for i in idx], what, tol=SERVE_TP_TIE)


def phase_serve_tp(card: str) -> dict:
    """Serving on a ``model=2`` mesh: Qwen2.5-1.5B at full width, and full
    depth on two or more cards (CUT_LAYERS on the one-card stand-in since
    the moe_ep phase came; random weights, seed 0) with the serve phase's
    ``ServerConfig`` (32
    slots, 2,048 tokens, page 128, 16 steps a call), a lead and one spawned
    follower, each rank on its 6 heads and 1 KV head. On one card both
    ranks share it over gloo (a stand-in: its times are not a mesh's); on
    two or more, the follower takes the next card and the ranks join over
    NCCL. The unsharded engine runs the same traffic first, as the
    yardstick. Requests take 128 new tokens on two or more cards and
    SERVE_TP_STANDIN_NEW on the one-card stand-in. Over HTTP: the cold and warm waves, 8 greedy requests under
    n-gram speculation, and a staged push of other weights, after which
    every rank's served slices must be the pushed bf16 bits. Checks: #1 and
    #3 launched on every rank (the followers report their counters), greedy
    tokens equal to the yardstick's but at near-ties, logprobs against a
    dense prefill, the pool audit, no follower alive after ``stop``. On two
    or more cards also int8 weights on int8 pages (one wave); on four, the
    disaggregated loop (``_tp_loop``)."""
    from areal_tpu_torch.api.config import InferenceEngineConfig, MeshConfig, ServerConfig
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine, tensor_digest
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[serve_tp] {held:.2f} GiB still allocated by earlier phases")
    n_cards = torch.cuda.device_count()
    mcfg = qwen.ModelConfig(**{**QWEN25_15B, "num_layers": QWEN25_15B["num_layers"] if n_cards >= 2 else CUT_LAYERS})
    checked = _tp_checked(mcfg.num_layers)
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    traffic = _tp_traffic(mcfg.vocab_size)
    base = dict(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16, host="127.0.0.1",
                seed=0)
    n_new = 128 if n_cards >= 2 else SERVE_TP_STANDIN_NEW
    spec_bodies = [_tp_body(p, i, n_new, greedy=True) for i, p in enumerate(traffic["spec"])]

    # the yardstick: the unsharded engine on the same seeds and traffic
    srv = ServerThread(ServerConfig(**base), engine=DecodeEngine(ServerConfig(**base), params=model))
    srv.start()
    try:
        ref = _tp_waves("serve_tp/unsharded", srv, srv.engine, traffic, model, LOGPROB_TOL, card, n_new)
        ref_spec = [r["output_tokens"] for r in _wave(srv.address, spec_bodies)]
    finally:
        srv.stop()
    gc.collect()

    res: dict = {"cards": n_cards, "unsharded": {k: ref[k] for k in ("ms_per_step", "wall_ms_per_step",
                                                                      "decode_tok_s")}}
    cfg = ServerConfig(**base, mesh=MeshConfig(model=2))
    engine = DecodeEngine(cfg, params=model)
    t0 = time.monotonic()
    engine.initialize()
    init_s = time.monotonic() - t0
    group = engine._group
    pids = group.pids()
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    stand_in = "a stand-in: both ranks on one card over gloo" if group.backend == "gloo" else "over NCCL"
    try:
        st = _http_status(srv.address, "/statusz")[2]
        ranks = st["mesh"]["ranks"]
        log(f"[serve_tp] {card}: model=2 up in {init_s:.1f} s (slices, spawn, the follower's engine), backend "
            f"{group.backend} ({stand_in}), devices {[r['device'] for r in ranks]}; per rank params "
            f"{[round(r['params'] / 1e9, 3) for r in ranks]} GB, KV pool {[round(r['kv_pool'] / 1e9, 3) for r in ranks]} "
            f"GB over {engine.pool.n_pages} pages (the unsharded engine's count)")
        tp = _tp_waves("serve_tp", srv, engine, traffic, model, LOGPROB_TOL, card, n_new)
        ties = _tp_greedy_ties(model, tp, ref, "serve_tp")
        log(f"[serve_tp] greedy tokens of the 16 greedy requests against the unsharded engine's: "
            f"{16 - len(ties)} equal, {len(ties)} part at near-ties (request, token, gaps): "
            f"{[(i, j, round(a, 4), round(b, 4)) for i, j, a, b in ties]} (tol {SERVE_TP_TIE})")
        # speculative rounds (n-gram drafts, kernel #3's tree launch on every rank)
        engine.set_speculative(True)
        engine.reset_rank_launches()
        r0 = engine.stats["spec_rounds"]
        spec = [r["output_tokens"] for r in _wave(srv.address, spec_bodies)]
        spec_launches = engine.rank_launches()
        engine.set_speculative(False)
        rounds = engine.stats["spec_rounds"] - r0
        trees = [c["paged_suffix_attention"]["tree"] for c in spec_launches]
        if not rounds or any(t != mcfg.num_layers * rounds for t in trees):
            raise AssertionError(f"[serve_tp] speculation: {rounds} rounds, #3 tree launches per rank {trees}")
        spec_ties = _near_ties(model, traffic["spec"], spec, ref_spec, "serve_tp/spec", tol=SERVE_TP_TIE)
        log(f"[serve_tp] n-gram speculation: {rounds} verify rounds, #3 tree launches per rank {trees} "
            f"(= {mcfg.num_layers} x rounds); accepted {engine.stats['spec_accepted_tokens']} of "
            f"{engine.stats['spec_draft_tokens']} drafted; greedy tokens against the unsharded non-speculative "
            f"engine's: {8 - len(spec_ties)} equal, {len(spec_ties)} part at near-ties")
        # a staged push over HTTP (the hold fence, bf16 buckets): every rank
        # then serves the pushed bits' slices
        model2 = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
        client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
        client.initialize()
        try:
            t0 = time.monotonic()
            client.update_weights(WeightUpdateMeta(type="mem"), params=model2.state_dict())
            push_s = time.monotonic() - t0
        finally:
            client.destroy()
        # every rank's sha256 of its served leaves over HTTP (/debug/weights;
        # the slices themselves would cross a pipe at the host's pace)
        specs = qwen.param_partition_specs(mcfg)
        pushed = dict(model2.named_parameters())
        served = _http_status(srv.address, "/debug/weights?names=" + ",".join(checked))[2]["ranks"]
        bad = [(r, n) for r, got in enumerate(served) for n in checked
               if got[n] != tensor_digest(qwen.tp_slice(pushed[n].detach().to(torch.bfloat16),
                                                        qwen.leaf_spec(specs, n), 2, r))]
        after = _wave(srv.address, [_tp_body(p, 0, n_new=16) for p in traffic["cold"][:4]])
        if bad or engine.get_version() != 1 or any(set(r["output_versions"]) != {1} for r in after):
            raise AssertionError(f"[serve_tp] after the push: slices differing {bad}, version {engine.get_version()}")
        log(f"[serve_tp] staged push over HTTP in {push_s:.2f} s (staging by part: {engine.last_stage_secs}): every "
            f"rank's slices of {len(checked)} leaves equal the pushed bf16 bits (their sha256, /debug/weights); a "
            "wave after it tagged version 1")
        del model2, pushed, served
        hbm = engine.hbm_ledger()
        res.update(tp={k: tp[k] for k in ("ms_per_step", "wall_ms_per_step", "decode_tok_s", "launches",
                                          "decode_steps", "suffix_batches")},
                   spec_launches=spec_launches, ties=len(ties), spec_ties=len(spec_ties), push_s=push_s,
                   stage_secs=engine.last_stage_secs, n_new=n_new,
                   init_s=init_s, backend=group.backend, rank_bytes=[r["components"] for r in hbm["ranks"]])
    finally:
        srv.stop()
    gone = not [p for p in pids if _pid_alive(p)]
    if not gone:
        raise AssertionError(f"[serve_tp] followers alive after stop: {pids}")
    log(f"[serve_tp] {card}: ms per decode step, model=2 ({stand_in}) {res['tp']['ms_per_step']:.2f} device / "
        f"{res['tp']['wall_ms_per_step']:.2f} wall against the unsharded engine's {ref['ms_per_step']:.2f} / "
        f"{ref['wall_ms_per_step']:.2f}; no follower alive after stop")
    del engine, srv
    gc.collect()
    torch.cuda.empty_cache()
    if n_cards >= 2:
        res["int8"] = _tp_int8(card, model, traffic, base)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if n_cards >= 4:
        res["loop"] = _tp_loop(card)
    res["s"] = time.monotonic() - t_phase
    log(f"[serve_tp] phase {res['s']:.1f} s on {card}")
    return res


def _pid_alive(pid: int) -> bool:
    """A process that runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _tp_int8(card: str, model, traffic: dict, base: dict) -> dict:
    """int8 weights on int8 pages on the mesh: one cold wave, #1 on every
    rank, logprobs against a dense prefill of the int8-quantized model."""
    from areal_tpu_torch.api.config import MeshConfig, ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    cfg = ServerConfig(**base, mesh=MeshConfig(model=2), quantization="int8", kv_quantization="int8")
    srv = ServerThread(cfg, engine=DecodeEngine(cfg, params=model))
    srv.start()
    engine = srv.engine
    pids = engine._group.pids()
    try:
        dense = qwen.QwenModel(model.cfg, model.device)
        with torch.no_grad():
            for n, p in dense.named_parameters():
                p.copy_(dict(model.named_parameters())[n])
        qwen.quantize_model_int8(dense)  # the served weights, whole: the yardstick of the logprobs
        engine.reset_rank_launches()
        s0 = engine.stats["decode_steps"]
        cold = traffic["cold"]
        t0 = time.monotonic()
        resps = _wave(srv.address, [_tp_body(p, i) for i, p in enumerate(cold)])
        wall = time.monotonic() - t0
        ranks = engine.rank_launches()
        steps = engine.stats["decode_steps"] - s0
        for r in resps:
            _check_response(r, 128, "serve_tp/int8")
        L = model.cfg.num_layers
        if any(c["paged_attention"] != L * steps for c in ranks) or not steps:
            raise AssertionError(f"[serve_tp/int8] #1 launches per rank {ranks}, {steps} steps")
        errs = [_dense_check(dense, cold[i], resps[i], greedy=False) for i in (1, 3)]
        gaps = [_dense_check(dense, cold[i], resps[i], greedy=True) for i in (0, 2)]
        if max(errs + gaps) > INT8_KV_LOGPROB_TOL:
            raise AssertionError(f"[serve_tp/int8] vs a dense prefill of the int8 model: {errs}, {gaps}")
        ledger = engine.hbm_ledger()
        out = dict(wall_s=wall, steps=steps, launches=ranks, dense_err=max(errs), greedy_gap=max(gaps),
                   params=[r["components"]["params"] for r in ledger["ranks"]])
        log(f"[serve_tp/int8] {card}: 16/16 responses complete in {wall:.2f} s ({steps} decode steps); #1 launches "
            f"per rank {[c['paged_attention'] for c in ranks]}; logprobs vs a dense prefill of the int8 model "
            f"max|diff| {max(errs):.4f}, greedy gap {max(gaps):.4f} (tol {INT8_KV_LOGPROB_TOL}); params per rank "
            f"{[round(b / 1e9, 3) for b in out['params']]} GB")
        del dense
    finally:
        srv.stop()
    if [p for p in pids if _pid_alive(p)]:
        raise AssertionError("[serve_tp/int8] a follower outlived stop")
    return out


# the disaggregated loop's two kinds: a model=2 server of Qwen2.5-1.5B
# (serve_tp) and an expert=2 server of Qwen3-30B-A3B at TRAIN_MOE_LAYERS
# (moe_ep); ``tag`` names their log lines, ``root`` their git-ignored folder
TP_LOOP = dict(tag="serve_tp/loop", model=QWEN25_15B, alloc="sglang:d1t2+fsdp:d2", mesh={"model": 2, "expert": 1},
               checked=list(_tp_checked(QWEN25_15B["num_layers"])), root=SERVE_TP_ROOT, exit_code=SERVE_TP_EXIT_CODE)


def _tp_loop(card: str, kind: dict = TP_LOOP) -> dict:
    """The disaggregated loop on four cards: ``python -m
    areal_tpu_torch.inference.server ... mesh.model=2`` (``kind["mesh"]``)
    on cards 0-1 from an HF export, ``PPOTrainer.train`` under ``torchrun``
    on cards 2-3 with ``allocation_mode`` ``kind["alloc"]`` (by default
    "sglang:d1t2+fsdp:d2") pointed at it (``tp_loop_worker``:
    SERVE_TP_STEPS steps over HTTP with the hold fence; the server's
    per-rank slices then equal the trainer's bf16 export, by
    ``/debug/weights``), then a SIGTERM drain of the server to its exit code
    with no follower left."""
    import shutil
    import signal as signal_mod

    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.models.hf import save_params_to_hf
    from areal_tpu_torch.utils.network import find_free_port

    t_loop = time.monotonic()
    root, tag = kind["root"], kind["tag"]
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = None
    try:
        mcfg = qwen.ModelConfig(**kind["model"])
        export = os.path.join(root, "export")
        m = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
        nbytes = save_params_to_hf(m, mcfg, export)
        del m
        torch.cuda.empty_cache()
        port = find_free_port()
        yaml = os.path.join(root, "server.yaml")
        with open(yaml, "w") as f:
            f.write("dtype: bfloat16\nmax_batch_size: 32\nmax_seq_len: 2048\npage_size: 128\n"
                    f"decode_steps_per_call: 16\nhost: 127.0.0.1\nport: {port}\nseed: 0\nprecompile: true\n"
                    "weight_stage_target: device\n"
                    f"preemption:\n  enabled: true\n  grace_s: 30.0\n  drain_budget_s: 5.0\n  exit_code: "
                    f"{kind['exit_code']}\n")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "0,1", "AREAL_FLIGHT_DIR": os.path.join(root, "flight"),
               "PYTHONPATH": os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH", "")) if p)}
        server_log = os.path.join(root, "server.log")
        t0 = time.monotonic()
        with open(server_log, "w") as logf:
            proc = subprocess.Popen([sys.executable, "-m", "areal_tpu_torch.inference.server", "--config", yaml,
                                     f"model_path={export}", *(f"mesh.{a}={n}" for a, n in kind["mesh"].items())],
                                    cwd=repo, env=env, stdout=logf,
                                    stderr=subprocess.STDOUT)
        addr = f"127.0.0.1:{port}"
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"[{tag}] the CLI server exited {proc.returncode}:\n"
                                     + open(server_log).read()[-4000:])
            try:
                if _http_status(addr, "/health", timeout=2)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            if time.monotonic() - t0 > 600:
                raise AssertionError(f"[{tag}] the CLI server not healthy in 600 s")
            time.sleep(0.5)
        health_s = time.monotonic() - t0
        mesh = _http_status(addr, "/statusz")[2]["mesh"]
        pids = [r["pid"] for r in mesh["ranks"][1:]]
        log(f"[{tag}] CLI server mesh {kind['mesh']} on cards 0-1 ({mesh['backend']}, devices "
            f"{[r['device'] for r in mesh['ranks']]}) healthy {health_s:.1f} s after launch; export "
            f"{nbytes / 1e9:.2f} GB")
        with open(os.path.join(root, "loop.json"), "w") as f:
            json.dump({"addr": addr, "export": export, "kind": kind}, f)
        wenv = {**env, "CUDA_VISIBLE_DEVICES": "2,3"}
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
               os.path.abspath(__file__), "--tp-loop-worker", root]
        t_run = time.monotonic()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=wenv, start_new_session=True)
        for line in run.stdout.splitlines():
            log(f"[{tag}/worker] {line}")
        if run.returncode != 0:
            raise AssertionError(f"[{tag}] torchrun exited {run.returncode}:\n{run.stderr[-6000:]}")
        with open(os.path.join(root, "loop_out.json")) as f:
            out = json.load(f)
        out["torchrun_s"] = time.monotonic() - t_run
        t_term = time.monotonic()
        proc.send_signal(signal_mod.SIGTERM)
        rc = proc.wait(timeout=60)
        drain_s = time.monotonic() - t_term
        t0 = time.monotonic()
        while [p for p in pids if _pid_alive(p)] and time.monotonic() - t0 < 15:
            time.sleep(0.1)
        left = [p for p in pids if _pid_alive(p)]
        if rc != kind["exit_code"] or left:
            raise AssertionError(f"[{tag}] SIGTERM: exit {rc} (want {kind['exit_code']}), followers left "
                                 f"{left}:\n" + open(server_log).read()[-3000:])
        out.update(health_s=health_s, drain_s=drain_s, rc=rc, s=time.monotonic() - t_loop)
        log(f"[{tag}] {card}: {kind['alloc']} took {SERVE_TP_STEPS} GRPO steps over HTTP (step "
            f"{', '.join(f'{s:.2f}' for s in out['step_s'])} s), versions trainer / server {out['versions']}; every "
            f"server rank's slices of {len(kind['checked'])} leaves equal the trainer's bf16 export; SIGTERM -> "
            f"exit {rc} in {drain_s:.2f} s, no follower left; {out['s']:.1f} s in all")
        return out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def tp_loop_worker(root: str) -> None:
    """One rank of ``_tp_loop``'s trainer (under ``torchrun``):
    ``PPOTrainer.train`` with the kind's ``allocation_mode`` from the HF
    export, against the mesh server. Rank 0 writes ``loop_out.json``: the
    step times, the versions, and whether the server's per-rank digests of
    the kind's checked leaves are those of the trainer's bf16 export's
    slices (``qwen.tp_slice`` over the server's model x expert ranks)."""
    import torch.distributed as dist

    from areal_tpu_torch.api.config import DatasetConfig, InferenceEngineConfig, PPOConfig, PreemptionConfig
    from areal_tpu_torch.api.io_struct import GenerationHyperparameters
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import tensor_digest
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.trainer.rl_trainer import PPOTrainer
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    from areal_tpu_torch.parallel.serving_group import coords

    with open(os.path.join(root, "loop.json")) as f:
        where = json.load(f)
    kind = where["kind"]
    rank = int(os.environ["RANK"])
    lead = rank == 0
    gconfig = GenerationHyperparameters(n_samples=4, max_new_tokens=128, temperature=1.0)
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name=kind["tag"].split("/")[0], allocation_mode=kind["alloc"],
                    weight_update_mode="mem", total_train_steps=SERVE_TP_STEPS,
                    preemption=PreemptionConfig(enabled=False), gconfig=gconfig,
                    train_dataset=DatasetConfig(batch_size=8), actor=_shard_actor_cfg(path=where["export"]),
                    rollout=InferenceEngineConfig(**GRPO_CLIENT))
    cfg.cluster.fileroot = os.path.join(root, "trainer")
    trainer = TorchTrainEngine(cfg.actor)  # sized by allocation_mode, initialized by the loop
    client = None
    if lead:
        client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[where["addr"]])
        client.initialize()
    mcfg = qwen.ModelConfig.from_hf_path(where["export"])
    rng = np.random.default_rng(0)
    dataset = [{"prompt_ids": rng.integers(0, mcfg.vocab_size, int(n)).tolist()}
               for n in rng.integers(64, 513, GRPO_PROMPTS)]
    loop = PPOTrainer(cfg, dataset, rollout=client, actor_engine=trainer)
    steps: list = []
    if lead:
        commit = loop.stats_logger.commit
        loop.stats_logger.commit = lambda e, s, g, st: steps.append(st["step_secs"]) or commit(e, s, g, st)
    loop.train(workflow=RLVRWorkflow(_even_share_reward, gconfig))
    if lead:  # drain: no new submissions, the episodes in flight finish
        client.pause()
        deadline = time.monotonic() + 600
        while client.executor.staleness.stat.running and time.monotonic() < deadline:
            time.sleep(0.01)
    params = trainer._export_params()  # every rank joins the gathers
    if lead:
        specs = qwen.param_partition_specs(mcfg)
        m, e = kind["mesh"]["model"], kind["mesh"]["expert"]
        want = [{n: tensor_digest(qwen.tp_slice(params[n].to(torch.bfloat16).cpu(), qwen.leaf_spec(specs, n), m,
                                                coords(r, e)[0], e, coords(r, e)[1]))
                 for n in kind["checked"]} for r in range(m * e)]
        got = _http_status(where["addr"], "/debug/weights?names=" + ",".join(kind["checked"]))[2]
        server_version = _http_status(where["addr"], "/health")[2]["version"]
        out = {"mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)), "step_s": steps,
               "versions": [trainer.get_version(), server_version], "slices_equal": got["ranks"] == want}
        print(json.dumps(out), flush=True)
        if out["versions"] != [SERVE_TP_STEPS, SERVE_TP_STEPS] or not out["slices_equal"]:
            raise AssertionError(f"[{kind['tag']}] {out}")
        with open(os.path.join(root, "loop_out.json"), "w") as f:
            json.dump(out, f)
    del params
    loop.close()
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# moe_ep: MoE over the expert axis
# ---------------------------------------------------------------------------

MOE_EP_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_moe_ep")
# (a): one Qwen3-30B-A3B MoE layer at full width, bf16, at a training grid's
# 2 x 1,024 tokens and a decode step's 32 slots
MOE_EP_SHAPES = {"train": (2, 1024), "decode": (32, 1)}
MOE_EP_AUX_COEF = 0.01
# the sum of e expert ranks' partial outputs against the unsharded layer, and
# their gradients. The partials come back in f32 and are summed in f32 and
# rounded once, as the mesh's sum over expert does; the router is held in f32
# (the trainer's master), so each rank's router gradient is summed in f32, as
# the mesh's all-reduce of the gates' cotangent makes it. So out, the router
# and the experts differ from the unsharded layer only by f32 sums in another
# order: at most one bf16 step of an entry (2^-7 of the leaf's largest) and a
# cosine of MOE_EP_COSINE or more (a wrong or missing rank's share is off by
# the whole value, cosine ~0.7 at e = 2)
MOE_EP_REL = 2**-7
MOE_EP_COSINE = 0.99999
# dh is bf16 on both sides and summed in bf16: the unsharded layer adds each
# token's K = 8 rows in bf16 (index_select's backward), the ranks add their
# bf16 partials as the mesh's all-reduce of the input's gradient does; about
# one bf16 step an entry, two at most: 2^-6 of the largest entry, a cosine
# of 1 - 2^-14 or more (an rms error of ~3 bf16 steps)
MOE_EP_DH_REL = 2**-6
MOE_EP_DH_COSINE = 1 - 2**-14
# (b): the serving stand-in, mesh.expert=2 on one card over gloo: 8 of 48
# layers, a cold wave of 8 requests of 32 new tokens
MOE_EP_SERVE_LAYERS = 8
MOE_EP_NEW = 32
MOE_EP_CHECKED = ("embed", "lm_head", "layers.0.w_router", "layers.0.we_gate", "layers.3.wq", "layers.7.we_down")
# four cards: the trainer under torchrun at fsdp 2 x expert 2, first at
# TRAIN_MOE_LAYERS against the unsharded engine, then at MOE_EP_DEEP_LAYERS
# (16 B of f32 state a parameter: per rank 604 M expert parameters a layer /
# 4 and 18.9 M attention / 2, ~2.57 GB a layer, 41 GB at 16 layers, plus ~5 GB
# of embedding and head and the activations); the server at expert=4 and at
# model=2 x expert=2 over all 48 layers
MOE_EP_DEEP_LAYERS = 16
# (c): the trainer on expert=2 with both ranks on one card over gloo: one
# layer, for the whole script's time limit (two ranks' f32 state fits the
# card beside each other at 2: 24.15 GiB a rank, 97.1 s for this part on one
# H100 80GB HBM3 at 700 W, PERF.md)
MOE_EP_GLOO_LAYERS = 1
MOE_EP_TRAIN_STEPS = 2
MOE_EP_LOOP = dict(tag="moe_ep/loop", model={**QWEN3_30B_A3B, "num_layers": TRAIN_MOE_LAYERS},
                   alloc="sglang:d2e2+fsdp:d2e2", mesh={"model": 1, "expert": 2},
                   checked=["embed", "layers.0.w_router", "layers.0.we_gate", "layers.3.we_down", "layers.3.wo"],
                   root=MOE_EP_ROOT, exit_code=23)


def _ep_close(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| as a share of want's largest entry, cosine)."""
    g, w = got.detach().float().reshape(-1), want.detach().float().reshape(-1)
    rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    return rel, torch.nn.functional.cosine_similarity(g[None], w[None]).item()


def _moe_ep_ranks() -> dict:
    """(a) One Qwen3-30B-A3B MoE layer at full width (E = 128, top-8, D =
    2,048, F = 768; bf16, random from a seed) at MOE_EP_SHAPES: ``moe_ffn``
    once per expert rank (e = 2 and 4), each with its E / e experts and its
    place ``EPInfo(group=None, rank=r, size=e)`` (the rank's partial result,
    unreduced); the router and the input
    are one leaf each, so one backward of sum(out * ct) + 0.01 aux (rank 0's
    aux) sums the ranks' gradients as the mesh's conjugates do. Against the
    unsharded ``moe_ffn`` on the same inputs: out, aux (every rank's), dh,
    the router's and the experts' gradients; gmm 3 launches a rank,
    gmm_bwd_lhs and tgmm 3 each a rank. Each rank's partial output is f32
    (``EPInfo`` without a group), summed here in f32 and rounded once to
    bf16; the router leaf is f32 on both sides (MOE_EP_REL)."""
    from types import SimpleNamespace

    from areal_tpu_torch.models import moe, qwen
    from areal_tpu_torch.ops import gmm as gm
    from areal_tpu_torch.parallel.tensor_parallel import EPInfo

    cfg = qwen.ModelConfig(**{**QWEN3_30B_A3B, "num_layers": 1})
    E, D, F = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = {"w_router": (D, E), "we_gate": (E, D, F), "we_up": (E, D, F), "we_down": (E, F, D)}
    full = {n: (0.02 * torch.randn(s, generator=g, device="cuda")).bfloat16() for n, s in shapes.items()}
    full["w_router"] = full["w_router"].float()  # bf16 values, an f32 leaf: gradients summed in f32
    experts = ("we_gate", "we_up", "we_down")
    out: dict = {}
    for sname, (G, L) in MOE_EP_SHAPES.items():
        h = torch.randn((G, L, D), generator=g, device="cuda").bfloat16()
        ct = torch.randn((G, L, D), generator=g, device="cuda")
        leaves = {n: t.clone().requires_grad_(True) for n, t in full.items()}
        h0 = h.clone().requires_grad_(True)
        o0, a0 = moe.moe_ffn(h0, SimpleNamespace(**leaves), cfg, with_aux=True)
        ((o0.float() * ct).sum() + MOE_EP_AUX_COEF * a0).backward()
        for e in (2, 4):
            E_loc = E // e
            router = full["w_router"].clone().requires_grad_(True)
            he = h.clone().requires_grad_(True)
            ranks = [{n: full[n][r * E_loc:(r + 1) * E_loc].clone().requires_grad_(True) for n in experts}
                     for r in range(e)]
            # main path: counts to 0 just before, read just after
            gm.gmm.launches = gm.gmm_bwd_lhs.launches = gm.tgmm.launches = 0
            total, auxes, fwd = torch.zeros((G, L, D), device="cuda"), [], []
            for r in range(e):
                o, a = moe.moe_ffn(he, SimpleNamespace(w_router=router, **ranks[r], ep=EPInfo(None, r, e)), cfg,
                                   with_aux=True)
                if o.dtype != torch.float32:
                    raise AssertionError(f"[moe_ep] rank {r} of {e}: a partial output in {o.dtype}, not f32")
                total = total + o
                auxes.append(a)
                fwd.append(gm.gmm.launches - sum(fwd))
            summed = total.bfloat16()  # one rounding, as the mesh's sum over expert
            ((summed.float() * ct).sum() + MOE_EP_AUX_COEF * auxes[0]).backward()
            torch.cuda.synchronize()
            counts = dict(gmm=fwd, gmm_bwd_lhs=gm.gmm_bwd_lhs.launches, tgmm=gm.tgmm.launches)
            if fwd != [3] * e or counts["gmm_bwd_lhs"] != 3 * e or counts["tgmm"] != 3 * e:
                raise AssertionError(f"[moe_ep] {sname} e={e}: launches {counts}, want gmm 3 a rank and 3 x {e} "
                                     "of each backward kernel")
            checks = {"out": _ep_close(summed, o0), "dh": _ep_close(he.grad, h0.grad),
                      "w_router": _ep_close(router.grad, leaves["w_router"].grad)}
            for n in experts:
                checks[n] = _ep_close(torch.cat([rk[n].grad for rk in ranks]), leaves[n].grad)
            aux_diff = max(abs(a.item() - a0.item()) for a in auxes)
            limits = {k: (MOE_EP_DH_REL, MOE_EP_DH_COSINE) if k == "dh" else (MOE_EP_REL, MOE_EP_COSINE) for k in checks}
            bad = {k: v for k, v in checks.items() if not (v[0] <= limits[k][0] and v[1] >= limits[k][1])}
            if bad or aux_diff > 1e-6 * abs(a0.item()):
                raise AssertionError(f"[moe_ep] {sname} e={e}: the ranks' sum against the unsharded layer {bad}, aux "
                                     f"{[a.item() for a in auxes]} vs {a0.item()}")
            out[f"{sname}/e{e}"] = dict(checks=checks, aux=a0.item(), counts=counts)
            log(f"[moe_ep] (a) {sname} [{G}, {L}, {D}] over e={e} expert ranks ({E_loc} experts each) in one "
                f"process, against the unsharded layer: " + ", ".join(
                    f"{k} {v[0]:.2e} of its largest / cosine {v[1]:.6f}" for k, v in checks.items())
                + f" (limits {MOE_EP_REL:.3g} / {MOE_EP_COSINE}, dh {MOE_EP_DH_REL:.3g} / {MOE_EP_DH_COSINE:.6f}); aux "
                f"{a0.item():.6f} on every rank (largest "
                f"difference {aux_diff:.1e}); launches gmm {fwd} a rank, gmm_bwd_lhs {counts['gmm_bwd_lhs']} and tgmm "
                f"{counts['tgmm']} (3 a rank)")
            del router, he, ranks, total, summed, auxes
        del leaves, h0, o0, h, ct
        torch.cuda.empty_cache()
    del full
    return out


def _ep_wave(tag: str, srv, engine, prompts: list, n_new: int) -> dict:
    """One cold wave over HTTP (greedy and sampled requests alternating),
    every rank's kernel counts from 0 just before and read just after: gmm
    3 x L per forward (decode steps and prefill forwards) and #1 L per
    decode step on every rank; complete responses; ms a decode step on the
    lead's device stream."""
    keys = ("decode_steps", "prefill_batches")
    L = engine.model_cfg.num_layers
    # main path: counts to 0 just before, read just after (on every rank)
    engine.reset_rank_launches()
    s0, dev0 = {k: engine.stats[k] for k in keys}, engine.device_seconds()
    t0 = time.monotonic()
    resps = _wave(srv.address, [_tp_body(p, i, n_new) for i, p in enumerate(prompts)])
    wall = time.monotonic() - t0
    ranks = engine.rank_launches()
    d = {k: engine.stats[k] - s0[k] for k in keys}
    dev = engine.device_seconds()
    for r in resps:
        _check_response(r, n_new, tag)
    want = dict(gmm=3 * L * (d["decode_steps"] + d["prefill_batches"]), paged_attention=L * d["decode_steps"])
    for rank, c in enumerate(ranks):
        if not d["decode_steps"] or any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"[{tag}] rank {rank}: launches {c}, want {want} ({d})")
    steps = dev["decode_steps"] - dev0["decode_steps"]
    return dict(resps=resps, wall=wall, launches=[{k: c[k] for k in want} for c in ranks],
                decode_steps=d["decode_steps"], prefill_batches=d["prefill_batches"], ms_per_step=(dev["decode_s"] - dev0["decode_s"]) / steps * 1e3,
                wall_ms_per_step=wall / d["decode_steps"] * 1e3)


def _ep_greedy(model, prompts: list, got: list, want: list, what: str) -> list:
    """The greedy requests (even indices) of a mesh's wave against the
    unsharded engine's: equal, or parting where both tokens sit within
    NEAR_TIE of the dense argmax, or after a route that flips at a near-tie
    (a top-8 set that differs between a replay and a dense pass with a
    margin below ROUTE_GAP_TOL, ``_route_flips``) at or before the parting
    token. Returns the partings as (request, token, kind)."""
    parts = []
    for i in range(0, len(prompts), 2):
        a, b = got[i], want[i]
        if a == b:
            continue
        j, ga, gb = _greedy_divergence(model, prompts[i], a, b)
        if max(ga, gb) <= NEAR_TIE:
            parts.append((i, j, f"logit near-tie {max(ga, gb):.1e}"))
            continue
        near, far, n_near, worst, _ = _route_flips(model, prompts[i], a[: j + 1])
        if not near[: len(prompts[i]) + j].any():
            raise AssertionError(f"[{what}] greedy request {i} parts from the unsharded engine's at token {j} "
                                 f"(dense-logit gaps {ga:.4f} / {gb:.4f}) with no near-tie route flip before it "
                                 f"({far} flips with a margin >= {ROUTE_GAP_TOL})")
        parts.append((i, j, f"route near-tie ({n_near} near-tie flips)"))
    return parts


def _moe_ep_serve(card: str) -> dict:
    """(b) The serving stand-in: Qwen3-30B-A3B at full width and
    MOE_EP_SERVE_LAYERS of 48 layers (random bf16 weights, seed 0), the
    serve phase's ``ServerConfig`` on ``mesh.expert=2``, a lead and one
    spawned follower on the same card over gloo (a stand-in: its times are
    not a mesh's), each rank on all 32 heads and 64 of the 128 experts. The
    unsharded engine serves the same cold wave of 8 requests x MOE_EP_NEW
    new tokens first, as the yardstick. Checks: gmm and #1 launched on every
    rank, greedy tokens equal to the yardstick's but at recorded near-ties,
    logprobs within LOGPROB_TOL of a dense prefill (near-tie route flips
    exempt), the page count and the pool audit; then a staged push of other
    weights over HTTP, after which every rank's slices of MOE_EP_CHECKED are
    the pushed bf16 bits (their sha256, ``/debug/weights``) and a wave is
    tagged version 1; per-rank bytes; no follower alive after stop."""
    from areal_tpu_torch.api.config import InferenceEngineConfig, MeshConfig, ServerConfig
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.inference.client import RemoteTorchEngine
    from areal_tpu_torch.inference.decode_engine import DecodeEngine, tensor_digest
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    marks = [("start", time.monotonic())]
    mcfg = qwen.ModelConfig(**{**QWEN3_30B_A3B, "num_layers": MOE_EP_SERVE_LAYERS})
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 8)]
    base = dict(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16, host="127.0.0.1",
                seed=0)
    srv = ServerThread(ServerConfig(**base), engine=DecodeEngine(ServerConfig(**base), params=model))
    srv.start()
    try:
        ref = _ep_wave("moe_ep/unsharded", srv, srv.engine, prompts, MOE_EP_NEW)
        ref_pages = srv.engine.pool.n_pages
    finally:
        srv.stop()
    gc.collect()
    marks.append(("the yardstick", time.monotonic()))
    cfg = ServerConfig(**base, mesh=MeshConfig(expert=2))
    engine = DecodeEngine(cfg, params=model)
    t0 = time.monotonic()
    engine.initialize()
    init_s = time.monotonic() - t0
    pids = engine._group.pids()
    srv = ServerThread(cfg, engine=engine)
    srv.start()
    out: dict = {"unsharded": {k: ref[k] for k in ("ms_per_step", "wall_ms_per_step")}}
    try:
        ranks = _http_status(srv.address, "/statusz")[2]["mesh"]["ranks"]
        if (engine.local_cfg.num_experts, engine.local_cfg.num_heads) != (mcfg.num_experts // 2, mcfg.num_heads) or \
                len(ranks) != 2:
            raise AssertionError(f"[moe_ep] expert=2: local config {engine.local_cfg}, ranks {ranks}")
        marks.append(("init", time.monotonic()))
        w = _ep_wave("moe_ep/serve", srv, engine, prompts, MOE_EP_NEW)
        marks.append(("wave", time.monotonic()))
        got, want = [r["output_tokens"] for r in w["resps"]], [r["output_tokens"] for r in ref["resps"]]
        parts = _ep_greedy(model, prompts, got, want, "moe_ep/serve")
        checks = [_moe_dense_check(model, prompts[i], w["resps"][i], greedy=i % 2 == 0, what="moe_ep/serve")
                  for i in range(4)]
        _post(srv.address, "/flush_prefix_cache", {})
        audit = engine.pool_audit()
        if not (audit["ok"] and engine.pool.n_pages == ref_pages
                and audit["free"] + audit["slot_pages"] + audit["radix_pages"] == audit["total"]):
            raise AssertionError(f"[moe_ep] the pool after the wave: {audit} ({engine.pool.n_pages} pages, the "
                                 f"unsharded engine's {ref_pages})")
        log(f"[moe_ep] (b) {card}: mesh.expert=2 up in {init_s:.1f} s ({engine._group.backend}: a stand-in, both "
            f"ranks on one card), per rank params {[round(r['params'] / 1e9, 3) for r in ranks]} GB, KV pool "
            f"{[round(r['kv_pool'] / 1e9, 3) for r in ranks]} GB over {engine.pool.n_pages} pages (the unsharded "
            f"engine's {ref_pages}); 8/8 responses complete; per rank gmm {[c['gmm'] for c in w['launches']]} (= 3 x "
            f"{mcfg.num_layers} x ({w['decode_steps']} decode steps + {w['prefill_batches']} prefill forwards)), #1 "
            f"{[c['paged_attention'] for c in w['launches']]}; greedy tokens against the unsharded engine's: "
            f"{4 - len(parts)} of 4 equal, partings {parts}; logprobs vs a dense prefill max|diff| "
            f"{max(c['max'] for c in checks[1::2]):.4f}, greedy gap {max(c['max'] for c in checks[0::2]):.4f} (tol "
            f"{LOGPROB_TOL}; near-tie exemptions {sum(c['exempt'] for c in checks)}); pool audit ok; "
            f"{w['ms_per_step']:.2f} ms a decode step (lead's device stream) against the unsharded engine's "
            f"{ref['ms_per_step']:.2f}")
        marks.append(("checks", time.monotonic()))
        # a staged push over HTTP: every rank then serves the pushed bits' slices
        model2 = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1))
        client = RemoteTorchEngine(InferenceEngineConfig(**GRPO_CLIENT), addresses=[srv.address])
        client.initialize()
        try:
            t0 = time.monotonic()
            client.update_weights(WeightUpdateMeta(type="mem"), params=model2.state_dict())
            push_s = time.monotonic() - t0
        finally:
            client.destroy()
        marks.append(("push", time.monotonic()))
        # every rank's sha256 of its served leaves over HTTP (/debug/weights;
        # the slices themselves would cross a pipe at the host's pace)
        specs = qwen.param_partition_specs(mcfg)
        pushed = dict(model2.named_parameters())
        served = _http_status(srv.address, "/debug/weights?names=" + ",".join(MOE_EP_CHECKED))[2]["ranks"]
        marks.append(("served digests", time.monotonic()))
        bad = [(r, n) for r, have in enumerate(served) for n in MOE_EP_CHECKED
               if have[n] != tensor_digest(qwen.tp_slice(pushed[n].detach().to(torch.bfloat16),
                                                         qwen.leaf_spec(specs, n), 1, 0, 2, r))]
        after = _wave(srv.address, [_tp_body(p, 0, n_new=16) for p in prompts[:4]])
        if bad or engine.get_version() != 1 or any(set(r["output_versions"]) != {1} for r in after):
            raise AssertionError(f"[moe_ep] after the push: slices differing {bad}, version {engine.get_version()}")
        marks.append(("a wave at version 1", time.monotonic()))
        hbm = engine.hbm_ledger()
        log(f"[moe_ep] (b) staged push over HTTP in {push_s:.2f} s (staging by part: {engine.last_stage_secs}): "
            f"every rank's slices of {len(MOE_EP_CHECKED)} leaves equal the pushed bf16 bits ({mcfg.num_experts // 2} "
            f"of {mcfg.num_experts} experts each); a wave after it tagged version 1; hbm_ledger params per rank "
            f"{[round(r['components']['params'] / 1e9, 3) for r in hbm['ranks']]} GB")
        del model2, pushed, served
        marks.append(("the ledger", time.monotonic()))
        out.update(serve={k: w[k] for k in ("ms_per_step", "wall_ms_per_step", "launches", "decode_steps",
                                            "prefill_batches")}, partings=parts, push_s=push_s, init_s=init_s,
                   dense_err=max(c["max"] for c in checks), rank_bytes=[r["components"] for r in hbm["ranks"]])
    finally:
        srv.stop()
    if [p for p in pids if _pid_alive(p)]:
        raise AssertionError(f"[moe_ep] followers alive after stop: {pids}")
    marks.append(("stop", time.monotonic()))
    out["parts"] = {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}
    log(f"[moe_ep] (b) seconds by part: {out['parts']}")
    del engine, srv, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_loss(outputs, b, cfg):
    """The GRPO loss; the router aux rides in the stats (not in the loss)."""
    loss, stats = _grpo_loss(outputs, b, cfg)
    return loss, {**stats, "moe_aux": outputs["moe_aux"].detach()}


def _moe_ep_trainer(card: str, world: int, mesh: dict, layers: int, deep_layers: int | None) -> dict:
    """The trainer on ``mesh`` under ``torchrun`` (``moe_ep_worker``, one
    rank a card, or ``world`` ranks sharing one card over gloo). First the
    unsharded engine here, at ``layers`` of Qwen3-30B-A3B's 48 layers:
    MOE_EP_TRAIN_STEPS
    ``train_batch`` steps of the GRPO loss on one fixed batch from seed 0,
    its parameters dumped; then the world takes the same steps from the same
    seed and is held to it: the parameters' largest difference within 2 LR
    and their summed difference within SHARD_UPDATE_RTOL of the update's
    summed size, each step's loss and grad norm within SHARD_STAT_RTOL, the
    aux loss beside them (the mesh's is the mean over its row blocks, as
    JAX's). Then, given ``deep_layers``, the world trains that depth, which
    no card holds alone: step times, tokens/s and the peak memory of every
    rank."""
    import pickle
    import shutil

    from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import gmm as gm

    shutil.rmtree(MOE_EP_ROOT, ignore_errors=True)
    os.makedirs(MOE_EP_ROOT)
    marks = [("start", time.monotonic())]
    try:
        mcfg = qwen.ModelConfig(**{**QWEN3_30B_A3B, "num_layers": layers})
        acfg = _shard_actor_cfg()
        adv = _shard_batch(acfg, mcfg.vocab_size)
        with open(os.path.join(MOE_EP_ROOT, "batch.pkl"), "wb") as f:
            pickle.dump(adv, f)
        ft = FinetuneSpec(total_train_epochs=1, dataset_size=32, train_batch_size=8)
        ref = TorchTrainEngine(acfg, model_config=mcfg)
        ref.initialize(ft, seed=0)
        theta0 = {n: t.detach().cpu() for n, t in ref._export_params().items()}
        kernels = (gm.gmm, gm.gmm_bwd_lhs, gm.tgmm)
        for k in kernels:
            k.launches = 0
        step_s, ref_stats = [], []
        for _ in range(MOE_EP_TRAIN_STEPS):
            t = time.monotonic()
            st = ref.train_batch(adv, lambda o, b: _moe_loss(o, b, acfg), _wfn)
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t)
            ref_stats.append({k: st[k] for k in ("loss", "grad_norm", "moe_aux")})
        ref_counts = [k.launches for k in kernels]
        marks.append(("the unsharded engine's steps", time.monotonic()))
        update_l1 = sum(float((t - theta0[n].to(t.device)).abs().sum(dtype=torch.float64))
                        for n, t in ref._export_params().items())
        del theta0
        ref.save(SaveLoadMeta(path=os.path.join(MOE_EP_ROOT, "unsharded"), weight_format="state", with_optim=False))
        marks.append(("its update and dump", time.monotonic()))
        log(f"[moe_ep] the unsharded engine at {layers} layers, steps "
            f"{', '.join(f'{s:.2f}' for s in step_s)} s, (loss, grad norm, aux) {ref_stats}, gmm / gmm_bwd_lhs / "
            f"tgmm {ref_counts}")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(MOE_EP_ROOT, "job.json"), "w") as f:
            json.dump({"mesh": mesh, "twin_layers": layers, "deep_layers": deep_layers}, f)
        res = _run_moe_ep_worker(world, timeout=900)
        marks.append(("torchrun", time.monotonic()))
        log(f"[moe_ep] the trainer's seconds by part: "
            f"{ {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])} }")
        tw = res["twin"]
        stat_rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(tw["stats"], ref_stats) for k in ("loss",
                                                                                                       "grad_norm"))
        update_rel = tw["param_diff_l1"] / update_l1
        log(f"[moe_ep] {card}: {mesh} on {world} ranks at {layers} layers against the unsharded engine: "
            f"parameters' largest difference {tw['max_param_diff']:.3e} (bound 2 LR = {2 * acfg.optimizer.lr:.1e}), "
            f"summed difference {tw['param_diff_l1']:.6e} against the update's summed size {update_l1:.6e}: "
            f"{update_rel:.3e} (bound {SHARD_UPDATE_RTOL}); per step (loss, grad norm, aux) mesh "
            f"{[(s['loss'], s['grad_norm'], s['moe_aux']) for s in tw['stats']]}, unsharded "
            f"{[(s['loss'], s['grad_norm'], s['moe_aux']) for s in ref_stats]}: largest relative difference "
            f"{stat_rel:.3e} (bound {SHARD_STAT_RTOL}); steps {', '.join(f'{s:.2f}' for s in tw['step_s'])} s vs "
            f"{', '.join(f'{s:.2f}' for s in step_s)} s; launches per rank gmm / gmm_bwd_lhs / tgmm "
            f"{tw['counts']} (unsharded {ref_counts}); peak per rank {tw['peak_gib']} GiB")
        if tw["max_param_diff"] > 2 * acfg.optimizer.lr or stat_rel > SHARD_STAT_RTOL or update_rel > SHARD_UPDATE_RTOL:
            raise AssertionError(f"[moe_ep] the {mesh} trainer parts from the unsharded engine")
        if any(c != ref_counts for c in tw["counts"]):
            raise AssertionError(f"[moe_ep] launches per rank {tw['counts']} != the unsharded run's {ref_counts}")
        deep = res.get("deep")
        if deep is not None:
            log(f"[moe_ep] {card}: {mesh} at {deep_layers} of 48 layers ({deep['params_b']:.3f} B parameters): steps "
                f"{', '.join(f'{s:.2f}' for s in deep['step_s'])} s, (loss, grad norm, aux) "
                f"{[(s['loss'], s['grad_norm'], s['moe_aux']) for s in deep['stats']]}, "
                f"{deep['tokens_per_s']:.0f} tokens/s (the second step), peak per rank {deep['peak_gib']} GiB")
        return dict(twin=tw, deep=deep, ref_stats=ref_stats, ref_step_s=step_s, update_rel=update_rel,
                    stat_rel=stat_rel)
    finally:
        shutil.rmtree(MOE_EP_ROOT, ignore_errors=True)


def _run_moe_ep_worker(n: int, timeout: float, env: dict | None = None) -> dict:
    """``torchrun`` of ``moe_ep_worker`` on ``n`` ranks over MOE_EP_ROOT's
    job; its stdout relayed; rank 0's result."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
           os.path.abspath(__file__), "--moe-ep-worker", MOE_EP_ROOT]
    t = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, start_new_session=True,
                          env=env)
    for line in proc.stdout.splitlines():
        log(f"[moe_ep/worker] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[moe_ep] torchrun exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    with open(os.path.join(MOE_EP_ROOT, "moe_ep.json")) as f:
        res = json.load(f)
    log(f"[moe_ep] torchrun of {n} ranks ran {time.monotonic() - t:.1f} s")
    return res


def _param_count(cfg) -> int:
    """A decoder's parameters by its config's shapes (arithmetic)."""
    from areal_tpu_torch.models import qwen

    layer = sum(math.prod(s) for s in qwen._layer_shapes(cfg).values())
    heads = 1 if cfg.tie_word_embeddings else 2
    return cfg.num_layers * layer + heads * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size


def moe_ep_worker(root: str) -> None:
    """One rank of the expert-parallel trainer (under ``torchrun``), on the
    job in ``root``: the twin's steps at ``twin_layers`` from seed 0 (rank 0
    then holds the gathered parameters to the unsharded engine's dump:
    largest and summed difference), then, with ``deep_layers``, that depth's
    steps, tokens/s and every rank's peak. A world larger than the cards
    shares them over gloo (the engine then joins the world this worker
    starts). Rank 0 writes ``moe_ep.json``."""
    import pickle

    import torch.distributed as dist

    from areal_tpu_torch.api.config import MeshConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.train_engine import TorchTrainEngine
    from areal_tpu_torch.models import qwen
    from areal_tpu_torch.ops import gmm as gm
    from areal_tpu_torch.utils.safetensors_io import SafetensorsFile

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    lead = rank == 0
    n_cards = torch.cuda.device_count()
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n_cards)
    torch.cuda.set_device(device)
    if world > n_cards:  # ranks share a card: NCCL refuses that, gloo carries the collectives
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    with open(os.path.join(root, "job.json")) as f:
        job = json.load(f)
    with open(os.path.join(root, "batch.pkl"), "rb") as f:
        adv = pickle.load(f)
    acfg = _shard_actor_cfg(mesh=MeshConfig(**job["mesh"]))
    ft = FinetuneSpec(total_train_epochs=1, dataset_size=32, train_batch_size=8)
    kernels = (gm.gmm, gm.gmm_bwd_lhs, gm.tgmm)
    tokens = int(np.asarray(adv["attention_mask"]).sum())
    out: dict = {}

    def steps(eng) -> tuple[list, list]:
        step_s, stats = [], []
        for _ in range(MOE_EP_TRAIN_STEPS):
            t = time.monotonic()
            st = eng.train_batch(adv, lambda o, b: _moe_loss(o, b, acfg), _wfn)
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t)
            stats.append({k: st[k] for k in ("loss", "grad_norm", "moe_aux")})
        return step_s, stats

    def peaks() -> list:
        got = [None] * world
        dist.all_gather_object(got, round(torch.cuda.max_memory_allocated() / 2**30, 2))
        return got

    for depth in ("twin", "deep"):
        layers = job.get(f"{depth}_layers")
        if not layers:
            continue
        mcfg = qwen.ModelConfig(**{**QWEN3_30B_A3B, "num_layers": layers})
        eng = TorchTrainEngine(acfg, model_config=mcfg, device=device)
        eng.initialize(ft, seed=0)
        if eng.mesh is None:
            raise AssertionError("the engine did not take the sharded path under torchrun")
        if lead:
            print(f"{depth}: world {world} ({dist.get_backend()}), mesh "
                  f"{dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape))}, {eng._local_cfg.num_experts} experts a "
                  f"rank, {layers} layers", flush=True)
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        step_s, stats = steps(eng)
        counts = [None] * world
        dist.all_gather_object(counts, [k.launches for k in kernels])
        # the whole model's parameters by the engine's full shapes of its
        # sharded leaves, held to the config's arithmetic
        full = sum(math.prod(eng._full_shape(n)) for n, _ in eng.model.named_parameters())
        if full != _param_count(mcfg):
            raise AssertionError(f"{depth}: the sharded leaves' full shapes hold {full} parameters, the config "
                                 f"{_param_count(mcfg)}")
        res = dict(step_s=step_s, stats=stats, counts=counts, peak_gib=peaks(), tokens_per_s=tokens / step_s[-1],
                   params_b=full / 1e9)
        if depth == "twin":
            params = eng._export_params()
            if lead:
                f = SafetensorsFile(os.path.join(root, "unsharded", "state", "params.safetensors"))
                res["max_param_diff"] = res["param_diff_l1"] = 0.0
                for n, t in params.items():
                    d = (t.to(device) - f.get(n).to(device)).abs()
                    res["max_param_diff"] = max(res["max_param_diff"], float(d.max()))
                    res["param_diff_l1"] += float(d.sum(dtype=torch.float64))
                f.close()
            del params
        out[depth] = res
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if lead:
        with open(os.path.join(root, "moe_ep.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _moe_ep_serve4(card: str) -> dict:
    """Four cards: Qwen3-30B-A3B at full width and all 48 layers (30.5 B
    random bf16 parameters, seed 0, built on card 0 and kept in host memory)
    served on ``mesh.expert=4`` over NCCL (each card 32 of the 128 experts
    and every head), then on ``model=2 x expert=2`` (16 heads and 64 experts
    a card); then the unsharded engine on card 0 at the same depth, the
    yardstick. Each serves the same cold wave of 8 requests x MOE_EP_NEW
    new tokens: complete responses, gmm and #1 on every rank, greedy tokens
    equal to the yardstick's but at recorded near-ties, logprobs within
    LOGPROB_TOL of a dense prefill; ms a decode step and per-rank bytes."""
    from areal_tpu_torch.api.config import MeshConfig, ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    mcfg = qwen.ModelConfig(**QWEN3_30B_A3B)
    t0 = time.monotonic()
    model = qwen.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0))
    host = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe_ep] four cards: Qwen3-30B-A3B at {mcfg.num_layers} layers, "
        f"{sum(t.numel() for t in host.values()) / 1e9:.3f} B parameters built on card 0 and moved to host memory in "
        f"{time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(n)).tolist() for n in rng.integers(64, 513, 8)]
    base = dict(max_batch_size=32, max_seq_len=2048, page_size=128, decode_steps_per_call=16, host="127.0.0.1",
                seed=0)
    out: dict = {}
    for tag, mesh in (("expert4", dict(expert=4)), ("model2_expert2", dict(model=2, expert=2))):
        cfg = ServerConfig(**base, mesh=MeshConfig(**mesh))
        engine = DecodeEngine(cfg, params=host, model_cfg=mcfg)
        t0 = time.monotonic()
        engine.initialize()
        init_s = time.monotonic() - t0
        pids = engine._group.pids()
        srv = ServerThread(cfg, engine=engine)
        srv.start()
        try:
            st = _http_status(srv.address, "/statusz")[2]["mesh"]
            w = _ep_wave(f"moe_ep/{tag}", srv, engine, prompts, MOE_EP_NEW)
            hbm = engine.hbm_ledger()
            out[tag] = dict({k: w[k] for k in ("ms_per_step", "wall_ms_per_step", "launches", "decode_steps")},
                            tokens=[r["output_tokens"] for r in w["resps"]], resps=w["resps"], init_s=init_s,
                            backend=st["backend"], devices=[r["device"] for r in st["ranks"]],
                            params_gb=[round(r["components"]["params"] / 1e9, 3) for r in hbm["ranks"]],
                            local=(engine.local_cfg.num_heads, engine.local_cfg.num_experts))
            log(f"[moe_ep] {card}: {tag} ({st['backend']}, devices {out[tag]['devices']}) up in {init_s:.1f} s, "
                f"{out[tag]['local'][0]} heads and {out[tag]['local'][1]} experts a rank, params per rank "
                f"{out[tag]['params_gb']} GB; 8/8 responses complete; {w['ms_per_step']:.2f} ms a decode step "
                f"(lead's device stream), {w['wall_ms_per_step']:.2f} ms wall; per rank gmm "
                f"{[c['gmm'] for c in w['launches']]}, #1 {[c['paged_attention'] for c in w['launches']]}")
        finally:
            srv.stop()
        if [p for p in pids if _pid_alive(p)]:
            raise AssertionError(f"[moe_ep] {tag}: followers alive after stop")
        del engine, srv
        gc.collect()
        torch.cuda.empty_cache()
    # the yardstick on card 0, then every wave's dense checks against it
    model = qwen.QwenModel(mcfg, "cuda")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(host[n])
    del host
    cfg = ServerConfig(**base)
    srv = ServerThread(cfg, engine=DecodeEngine(cfg, params=model))
    srv.start()
    try:
        ref = _ep_wave("moe_ep/unsharded48", srv, srv.engine, prompts, MOE_EP_NEW)
    finally:
        srv.stop()
    gc.collect()
    want = [r["output_tokens"] for r in ref["resps"]]
    for tag in ("expert4", "model2_expert2"):
        res = out[tag]
        res["partings"] = _ep_greedy(model, prompts, res.pop("tokens"), want, f"moe_ep/{tag}")
        resps = res.pop("resps")
        checks = [_moe_dense_check(model, prompts[i], resps[i], greedy=i % 2 == 0, what=f"moe_ep/{tag}")
                  for i in range(4)]
        res["dense_err"] = max(c["max"] for c in checks)
        log(f"[moe_ep] {tag}: greedy tokens against the unsharded engine's at {mcfg.num_layers} layers: "
            f"{4 - len(res['partings'])} of 4 equal, partings {res['partings']}; logprobs vs a dense prefill "
            f"max|diff| {res['dense_err']:.4f} (tol {LOGPROB_TOL}, near-tie exemptions "
            f"{sum(c['exempt'] for c in checks)}); ms a decode step {res['ms_per_step']:.2f} against the unsharded "
            f"engine's {ref['ms_per_step']:.2f} at the same depth on one card")
    out["unsharded"] = {k: ref[k] for k in ("ms_per_step", "wall_ms_per_step", "decode_steps")}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_ep(card: str) -> dict:
    """MoE over the ``expert`` axis. One card: (a) the expert ranks of one
    full-width Qwen3-30B-A3B layer in one process against the unsharded
    layer (``_moe_ep_ranks``), (b) the serving stand-in on
    ``mesh.expert=2`` (``_moe_ep_serve``) and (c) the trainer on
    ``expert=2``, both ranks on the card over gloo (``moe_ep_worker``: two
    steps at MOE_EP_GLOO_LAYERS against the unsharded engine). Four cards:
    the trainer at fsdp 2 x expert 2 against the unsharded engine and at
    MOE_EP_DEEP_LAYERS (``_moe_ep_trainer``), the server at 48 layers on
    expert=4 and on model=2 x expert=2 (``_moe_ep_serve4``), and the
    disaggregated loop ``sglang:d2e2+fsdp:d2e2`` (``_tp_loop`` on
    MOE_EP_LOOP)."""
    t_phase = time.monotonic()
    held = torch.cuda.memory_allocated() / 2**30
    if held > 2.0:
        raise AssertionError(f"[moe_ep] {held:.2f} GiB still allocated by earlier phases")
    res: dict = {"cards": torch.cuda.device_count()}
    if res["cards"] >= 4:
        parts = {
            "train4": lambda: _moe_ep_trainer(card, 4, {"data": 1, "fsdp": 2, "expert": 2}, TRAIN_MOE_LAYERS,
                                              MOE_EP_DEEP_LAYERS),
            "serve4": lambda: _moe_ep_serve4(card),
            "loop": lambda: _tp_loop(card, MOE_EP_LOOP),
        }
    else:
        parts = {
            "ranks": _moe_ep_ranks,
            "serve": lambda: _moe_ep_serve(card),
            "train": lambda: _moe_ep_trainer(card, 2, {"data": 1, "fsdp": 1, "expert": 2}, MOE_EP_GLOO_LAYERS,
                                             None),
        }
    secs = {}
    for name, run in parts.items():
        t = time.monotonic()
        res[name] = run()
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = round(time.monotonic() - t, 1)
        log(f"[moe_ep] {name} {secs[name]} s")
    res["s"] = time.monotonic() - t_phase
    log(f"[moe_ep] phase {res['s']:.1f} s on {card} ({secs})")
    return res


PHASES = ("kernel", "kernel_flash", "kernel_suffix", "serve", "serve_int8", "rollout", "lifecycle", "observe", "spec",
          "train", "grpo", "shard", "durable", "critic", "sft", "int8serve", "lora", "vlm", "kernel_tree", "train_tree", "kernel_gmm",
          "kernel_gmm_bwd", "serve_moe", "train_moe", "entry", "serve_tp", "moe_ep")


def main(argv: list[str]) -> int:
    only = times = other_dir = fwd_file = None
    if argv[:1] == ["--tree-times"] and len(argv) == 4 and argv[2] == "--fwd":
        fwd_file = os.path.abspath(argv[3])
        argv = argv[:2]
    if argv[:1] == ["--shard-worker"] and len(argv) == 2:  # a rank of phase_shard's torchrun world
        shard_worker(argv[1])
        return 0
    if argv[:1] == ["--tp-loop-worker"] and len(argv) == 2:  # a rank of _tp_loop's trainer
        tp_loop_worker(argv[1])
        return 0
    if argv[:1] == ["--moe-ep-worker"] and len(argv) == 2:  # a rank of moe_ep's trainer
        moe_ep_worker(argv[1])
        return 0
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
        if set(only) - set(PHASES):
            print(f"chip_smoke: --only takes phases of {PHASES}", file=sys.stderr)
            return 2
    elif argv[:1] in (["--decode-times"], ["--flash-times"], ["--gmm-times"], ["--gmm-bwd-times"],
                      ["--tree-times"]) and len(argv) == 2:
        times = argv[0][2:-len("-times")]
        other_dir = os.path.abspath(argv[1])
        sys.path.insert(0, other_dir)  # that tree's areal_tpu_torch, not this one's
    elif argv:
        print("usage: chip_smoke.py [--only phase,phase,... | --decode-times DIR | --flash-times DIR | "
              "--gmm-times DIR | --gmm-bwd-times DIR | --tree-times DIR [--fwd FILE]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import areal_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is not importable: {e}", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.monotonic()
    if times == "decode":
        log(f"[decode_times] kernel #1 of {os.path.dirname(areal_tpu_torch.__file__)}")
        phase_build(["paged_attention"])
        decode_times()
        log(f"[done] decode times in {time.monotonic() - t0:.1f}s on {card} (no result)")
        return 0
    if times == "flash":
        log(f"[flash_times] K2 of {os.path.dirname(areal_tpu_torch.__file__)}")
        phase_build(["flash_attention"])
        flash_times()
        log(f"[done] flash times in {time.monotonic() - t0:.1f}s on {card} (no result)")
        return 0
    if times == "gmm":
        log(f"[gmm_times] the gmm forward of {os.path.dirname(areal_tpu_torch.__file__)}")
        phase_build(["gmm"])
        gmm_times()
        log(f"[done] gmm forward times in {time.monotonic() - t0:.1f}s on {card} (no result)")
        return 0
    if times == "gmm-bwd":
        log(f"[gmm_bwd_times] gmm_bwd_lhs and tgmm of {os.path.dirname(areal_tpu_torch.__file__)}")
        phase_build(["gmm"])
        gmm_bwd_times()
        log(f"[done] gmm backward times in {time.monotonic() - t0:.1f}s on {card} (no result)")
        return 0
    if times == "tree":
        log(f"[tree_times] #4, #5 and #6 of {os.path.dirname(areal_tpu_torch.__file__)}")
        phase_build(["tree_attention"])
        tree_times(fwd_file)
        log(f"[done] tree times in {time.monotonic() - t0:.1f}s on {card} (no result)")
        return 0
    phase_build()
    runs = {
        "kernel": phase_kernel,
        "kernel_flash": phase_kernel_flash,
        "kernel_suffix": phase_kernel_suffix,
        "serve": lambda: phase_serve(card),
        "serve_int8": phase_serve_int8,
        "rollout": lambda: phase_rollout(card, serve=res["serve"][1] if "serve" in res else None),
        "lifecycle": lambda: phase_lifecycle(card),
        "observe": lambda: phase_observe(card),
        "spec": lambda: phase_spec(card),
        "train": lambda: phase_train(card),
        "grpo": lambda: phase_grpo(card, train=res.get("train")),
        "shard": lambda: phase_shard(card),
        "durable": lambda: phase_durable(card),
        "critic": lambda: phase_critic(card),
        "sft": lambda: phase_sft(card),
        "int8serve": lambda: phase_int8serve(card),
        "lora": lambda: phase_lora(card),
        "vlm": lambda: phase_vlm(card),
        "kernel_tree": phase_kernel_tree,
        "train_tree": lambda: phase_train_tree(card),
        "kernel_gmm": phase_kernel_gmm,
        "kernel_gmm_bwd": phase_kernel_gmm_bwd,
        "serve_moe": lambda: phase_serve_moe(card),
        "train_moe": lambda: phase_train_moe(card),
        "entry": lambda: phase_entry(card),
        "serve_tp": lambda: phase_serve_tp(card),
        "moe_ep": lambda: phase_moe_ep(card),
    }
    res, secs = {}, {}
    for name in PHASES:
        if only is None or name in only:
            t_ph = time.monotonic()
            res[name] = runs[name]()
            gc.collect()  # a phase's garbage (engines and models in reference cycles) goes before the next starts
            torch.cuda.empty_cache()
            secs[name] = time.monotonic() - t_ph
            log(f"[time] {name} {secs[name]:.1f} s")
    log("[time] phases: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f" s on {card}")
    if only is not None:
        log(f"[done] phases {only} passed in {time.monotonic() - t0:.1f}s on {card} (a partial run: no result)")
        return 0
    per, flash, suffix, train = res["kernel"], res["kernel_flash"], res["kernel_suffix"], res["train"]
    launches, serve = res["serve"]
    rollout = res["rollout"]
    # kernel #1: launches of the serve phase; the times (graph replay) of
    # Qwen2.5-1.5B's heads with bf16 pages, the other shapes beside them
    b = per["bf16"]
    kernels = [
        {
            "name": "paged_attention_stacked",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/paged_attention.cu",
            "replaces": "areal_tpu/ops/paged_attention_q8.py:274",
            "launches": launches,
            "launches_by_phase": {"serve": launches, "rollout": rollout["launches1"],
                                  "lifecycle": res["lifecycle"]["launches1"], "observe": res["observe"]["launches1"],
                                  "grpo": res["grpo"]["launches1"], "shard": res["shard"]["launches1"],
                                  "durable": res["durable"]["launches1"],
                                  "critic": res["critic"]["launches1"], "int8serve": res["int8serve"]["launches1"],
                                  "lora": res["lora"]["launches1"], "vlm": res["vlm"]["launches1"],
                                  "entry": res["entry"]["launches1"],
                                  "serve_tp": [c["paged_attention"] for c in res["serve_tp"]["tp"]["launches"]],
                                  "moe_ep": [c["paged_attention"]
                                             for c in res["moe_ep"]["serve"]["serve"]["launches"]]},
            "max_abs_err": max(p["max_abs_err"] for p in per.values()),
            "ms": b["ms"],
            "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "library_ms": b["library_ms"],
            "shapes": {k: {f: d[f] for f in ("ms", "host_ms", "library_ms", "library_host_ms", "bound_ms", "splits",
                                             "max_abs_err")}
                       for k, d in per.items()},
        }
    ]
    replaces = {
        "flash_attention_fwd": "areal_tpu/ops/attention.py:196",
        "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
    }
    for name, d in flash.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name],
            "launches": train["counts"][name],
            "launches_by_phase": {"train": train["counts"][name], "grpo": res["grpo"]["counts"][name],
                                  "shard": res["shard"]["counts"][name],
                                  "durable": res["durable"]["counts"][name], "critic": res["critic"]["counts"][name],
                                  "sft": res["sft"]["counts"][name], "int8serve": res["int8serve"]["counts"][name],
                                  "lora": res["lora"]["counts"][name], "vlm": res["vlm"]["counts"][name],
                                  "entry": res["entry"]["counts"][name]},
            "max_abs_err": d["max_abs_err"],
            "ms": d["ms"],
            "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"],
            "library_ms": d["library_ms"],
            **({"shapes": d["shapes"]} if "shapes" in d else {}),
        })
    # kernel #3: launches of the serve phase's warm wave (chain) and the spec
    # phase (tree); the times of the warm-prefill shape with bf16 pages, the
    # verify shapes beside them
    chain, tree = serve["warm_launches"]["chain"], res["spec"]["launches"]["tree"]
    w = suffix["warm_prefill/bf16"]
    kernels.append({
        "name": "paged_suffix_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/paged_suffix_attention.cu",
        "replaces": "areal_tpu/ops/paged_suffix_attention.py:370",
        "launches": chain + tree,
        "launches_by_kind": {"chain": chain, "tree": tree},
        "launches_by_phase": {"serve": chain, "spec": tree, "rollout": rollout["launches3"],
                              "lifecycle": res["lifecycle"]["launches3"], "observe": res["observe"]["launches3"],
                              "grpo": res["grpo"]["launches3"], "int8serve": res["int8serve"]["launches3"],
                              "entry": res["entry"]["launches3"],
                              "serve_tp": [c["paged_suffix_attention"]["chain"] for c in res["serve_tp"]["tp"]["launches"]],
                              "serve_tp_spec": [c["paged_suffix_attention"]["tree"]
                                                for c in res["serve_tp"]["spec_launches"]]},
        "max_abs_err": max(d["max_abs_err"] for d in suffix.values()),
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": w["library_ms"],
        "shapes": {k: {f: d[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
                                         "splits", "host_ms", "library_host_ms")}
                   for k, d in suffix.items()},
    })
    # kernels #4-#6: launches of the train_tree phase; the times of the
    # GRPO forest (the first pack of the train_tree wave), the agentic
    # trie's beside them
    tree_k, tree_t = res["kernel_tree"], res["train_tree"]
    replaces = {
        "tree_attention_fwd": "areal_tpu/ops/tree_attention.py:167",
        "tree_attention_bwd_dq": "areal_tpu/ops/tree_attention.py:364",
        "tree_attention_bwd_dkv": "areal_tpu/ops/tree_attention.py:385",
    }
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, where in replaces.items():
        d = tree_k["grpo"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/tree_attention.cu",
            "replaces": where,
            "launches": tree_t["counts"][name],
            "max_abs_err": max(f[name]["max_abs_err"] for f in tree_k.values()),
            **{f: d[f] for f in fields[1:]},
            "forests": {fo: {**{f: r[name][f] for f in (*fields, "host_ms", "library_host_ms")},
                             "tile_pairs": r["tile_pairs"]} for fo, r in tree_k.items()},
            **({"occupancy": d["occupancy"]} if "occupancy" in d else {}),
        })
    # the grouped matmul: launches of serve_moe's cold and warm waves,
    # train_moe's beside them; the times (graph replay) of the decode gate /
    # up shape, the other shapes beside them
    gmm_k, moe_run = res["kernel_gmm"], res["serve_moe"]
    d = gmm_k["decode/gate_up"]
    shapes = {k: v for k, v in gmm_k.items() if "/" in k}
    kernels.append({
        "name": "gmm",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/gmm.cu",
        "replaces": "areal_tpu/models/moe.py:227",
        "launches": moe_run["cold_counts"]["gmm"] + moe_run["warm_counts"]["gmm"],
        "launches_by_phase": {"serve_moe": moe_run["cold_counts"]["gmm"] + moe_run["warm_counts"]["gmm"],
                              "train_moe": res["train_moe"]["counts"]["gmm"],
                              "moe_ep_ranks": {k: v["counts"]["gmm"] for k, v in res["moe_ep"]["ranks"].items()},
                              "moe_ep_serve": [c["gmm"] for c in res["moe_ep"]["serve"]["serve"]["launches"]]},
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        **{f: d[f] for f in fields[1:]},
        "host_ms": d["host_ms"],
        "library": d["library"],
        "occupancy": gmm_k["occupancy"],
        "shapes": {k: {f: v[f] for f in (*fields, "host_ms", "ms_by_tile", "tile", "grouped_mm_bf16_ms", "bits", "M",
                                         "k", "n", *EP_SHAPE_FIELDS) if f in v}
                   for k, v in shapes.items()},
    })
    # the backward kernels: launches of train_moe; the times of the training
    # gate / up shape (bf16 output, as the path writes it), the other shapes
    # beside them
    bwd_k, moe_train = res["kernel_gmm_bwd"], res["train_moe"]
    for name in ("gmm_bwd_lhs", "tgmm"):
        d = bwd_k[f"{name}/train/gate_up"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/gmm.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/megablox/gmm.py:314" if name == "gmm_bwd_lhs"
                         else "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573"),
            "launches": moe_train["counts"][name],
            "launches_by_phase": {"train_moe": moe_train["counts"][name],
                                  "moe_ep_ranks": {k: v["counts"][name] for k, v in res["moe_ep"]["ranks"].items()}},
            "max_abs_err": max(v["max_abs_err"] for k, v in bwd_k.items() if k.startswith(name)),
            **{f: d[f] for f in fields[1:]},
            "library": d["library"],
            "occupancy": bwd_k["occupancy"],
            "shapes": {k.split("/", 1)[1]: {f: v[f] for f in (*fields, "host_ms", "max_abs_err_f32_out", "ms_f32_out",
                                                                "grouped_mm_split_ms", "grouped_mm_bf16_ms", "M", "k",
                                                                "n", *EP_SHAPE_FIELDS) if f in v}
                       for k, v in bwd_k.items() if k.startswith(name)},
        })
    log(f"[done] all phases passed in {time.monotonic() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
