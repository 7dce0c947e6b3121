#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit; the hand-written kernels are built from the
checkout's sources at first use (into ``ray_tpu_torch/_build/``). It imports
nothing of JAX or of the JAX package. Each phase prints one JSON line,
with ``phase_s``, its own wall in seconds. Processes it starts cache
their compiled bytecode under ``ray_tpu_torch/_build/pycache``
(``keep_bytecode``):

1. ``build``: builds the flash-attention kernels (K1, the forward,
   replacing the Pallas ``_fwd_kernel``; K2 and K3, the backward, replacing
   ``_dq_kernel`` and ``_dkv_kernel``), one nvcc per source at once, and
   prints the build seconds; then a raw line with the card's name and
   power limit, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. ``kernel_check`` (twice): K1, then K2 and K3, against their plain
   PyTorch versions on the card, in bf16, on seeded numpy inputs: causal
   and not, MHA and GQA (K3 also with groups wider than one thread-block
   cluster), head dims 32, 64 and 128, sequence lengths with a ragged tail
   and below one tile, q/k/v as strided views of a fused projection and as
   views whose rows past S hold NaN, every prefill bucket the serving slice
   runs, the training shape, ViT-L's (64, 197, 16/16, 64, no mask) and
   the ring's 2048-token chunks of
   Llama-3-8B's attention, causal and not. Then ``sp_check``: the ring's
   and Ulysses' schedules on one card, one sequence of 8192 tokens at
   Llama-3-8B's attention width (32/8 heads, D=128) in 4 chunks, the
   ranks simulated in this process by the ring's own schedule functions
   (the hop a list rotation): o, lse and dq/dk/dv against K1/K2/K3 over
   the whole sequence (relative L2 2e-2), one chunk from the past with
   the global lse against the plain versions, and the launches (10
   K1/K2/K3 causal, 16 not; Ulysses 4 K1 on 8 query and 2 kv heads each);
   and at dist_train's ring shape, the ring and the one-device kernels
   against the plain attention in f32 (the ring no further than 1.5
   times the kernels).
3. ``slice``: the main path. Llama-3-8B at full width and depth (bf16
   weights, random from a seed) behind a ``ContinuousBatchingEngine`` with
   4 slots, ticking on its ``run_forever`` thread; 6 greedy requests, the
   later ones attaching mid-flight and the last two blocking for a slot.
   Checks every budget, token range and logit, that K1 ran 32 times per
   prefill, and that one prefill's logits with K1 agree with the same
   prefill under the plain attention. Prints tokens/s, and the decode-tick
   time at 4 busy slots, timed after the run with the ticker stopped.
4. ``prefill_time`` and ``profile``: each prefill bucket's time; the
   device busy time and idle share of a decode tick and of two prefills
   (torch.profiler). Then the Serve layer (``ray_tpu_torch.serve``),
   Llama-3-8B at full width and SERVE_LAYERS (8) of its 32 layers on
   replica processes, one card a replica, weights made from SEED on the
   replica's card (``SeededLlama``), held to ``serve_witness`` (the same
   model in this process behind the slice's engine: its tokens for the
   slice's prompts, its decode tick and prefill times), one deployment at
   a time through ``serve.run`` and
   its handle: ``serve_stream`` (the streaming deployment with
   continuous batching, 4 slots: the slice's prompts streamed four at a
   time, every stream's tokens equal to the witness's; four
   more, one closed after 3 tokens, whose slot must be free before the
   engine's next decode step ends; TTFT beside the in-process prefill,
   the gap between tokens at 4 streams beside the in-process tick),
   then, on the same replica, ``serve_http`` (the HTTP proxy that
   ``serve.run(..., _http=True, http_port=0)`` started: the prompts
   streamed four at a time with urllib, chunk by chunk, tokens equal to
   the witness's; one connection closed after 3 tokens, its slot free
   within one decode step; a 1 ms deadline answered 504; TTFT and the
   gap through HTTP beside the handle's), ``serve_grpc`` (one prompt
   through the gRPC proxy's CallStream where ``grpc`` imports, else a
   line saying why it did not run) and ``serve_trace`` (the trace and
   metrics plane, on by default in every serve phase: the prompts
   streamed four at a time through HTTP with an X-Request-Id each, then
   through the handle with ``options(request_id=...)``, tokens the
   witness's; each request's ledger row ok with its proto and tokens,
   every span under its row's trace id, the root, assign, replica,
   prefill, attach and stream hops, exclusive times summing to the wall
   within rel 0.15 + 0.1 s; ``/metrics`` counting the prefills' TTFTs,
   the tokens and the requests, no slot busy after; the controller's
   TTFT p99 in the bucket of the clients' p99; 32 K1 launches a prefill;
   a 1 ms deadline's row kept as ``deadline``; printed, each of the 4
   streams started together split into assign, replica queue, prefill
   and attach, and the in-process decode tick at 4 slots with the whole
   plane, with the instruments alone (RTPU_SERVE_TRACE=0) and with no
   plane, interleaved, beside the host time a tick spends recording),
   ``serve_batch`` (the ``@batch`` deployment: four prompts of 1100-2048
   tokens sent at once, twice, each one's tokens equal to an in-process
   ``generate_ragged`` over the same rows, the batch sizes formed) and,
   with two cards or more, ``serve_disagg`` (the prefill pool on one
   card, the decode pool on another, the ingress on the CPU without
   CUDA: the slice's prompts, tokens equal to serve_stream's; the
   2048-token prompt again, a prefix-cache hit; the K/V handoff files'
   MB and seconds), ``serve_multiplex`` (a ``@serve.multiplexed``
   loader keeping two Llama-3-8B models a replica, ids A, B, A, C: A's
   tokens those of the same function in process, three loads, B evicted
   and the replica's memory at most two models plus 2 GiB after C) and
   ``serve_autoscale`` (the streaming deployment under a
   ``scaling_policy``: 8 streams at once until the target reaches 2; on
   one card the second replica stays pending and idle brings the target
   back to 1; with two cards it spawns on card 1 and idle drains it with
   no stream cut; every stream the witness's tokens). Each prints its
   replicas' spawn seconds, K1 launches (32 a prefill) and peak memory;
   on one card ``serve_disagg`` prints that it did not run.
   ``tools/serve_phases.py`` runs them alone. Then ``mpmd_pipe``: the
   same model (SERVE_LAYERS layers) as an MPMD pipeline through the core
   (``ray_tpu_torch.parallel.MPMDPipeline``): MPMD_STAGES (4) stage
   processes of two layers each, forked from the fork server, on card 0
   (``num_gpus=0``; each builds the model from the seed on the card, one
   stage after another, keeps its layers and warms with one microbatch,
   timed, its launch counts set to 0 after it), wired by shared-memory
   channels, 16 microbatches of (2, 512) tokens from ``default_rng(SEED)``
   with 4 in flight. Stage 0 embeds, the last applies the final norm and
   the head and returns the last position's f32 logits and the greedy
   token at every position. Checks channel mode, those logits bit for bit
   and the tokens equal to the same four stage functions run in order in
   this process on serve_witness's params, 2 K1 launches a stage a
   microbatch (128) counted in the stage processes, 12 steady gaps, and
   no stage process or channel segment left. Prints the steady gap's mean
   and p50, each stage's ms a microbatch by phase (recv, compute, send,
   the host copies' decode and encode), the meter's busy fractions and
   bottleneck, the bytes a hop, each stage's spawn-to-ready seconds, cold
   first step and peak memory. ``tools/mpmd_phases.py`` runs it alone, and the four-card
   arm (32 layers, 8 a stage, a card a stage). Then ``workflow_llm``: the
   same model (SERVE_LAYERS layers) on ``LlamaWorker`` actors of the core
   (a card each, ``num_gpus=1``; the witness's engine inside), through
   the workflow layer and the util shims, the slice's 6 prompts: a
   child driver (a new process) runs a durable workflow of a generate
   step a prompt, is SIGKILLed after 3 checkpoints, and this process
   resumes it (held: the child's actor gone within 10 s, RESUMABLE within
   LIVENESS_S + 5 s, the witness's tokens bit for bit, each step
   checkpointed before the kill run once and every other at most twice,
   the resumed actor's K1 launches 8 a step it ran); an ``ActorPool`` of
   a LlamaWorker a card (map in order and map_unordered as a set, the
   witness's tokens, 8 K1 launches a prompt); a ``Queue(maxsize=4)`` sent
   into the pool's actor, which puts the 2048-token prompt's tokens as
   they come while this process sleeps 0.5 s (the witness's row in
   order, the producer found the queue full); then no process, core
   directory or workflow directory left. Prints each arm's wall, the
   child's spawn to its first checkpoint, kill to RESUMABLE, each
   generate's ms in the actor beside the in-process engine's and the
   queue's gap between tokens beside the decode tick. Then
   ``core_stream``: the same model on one ``StreamingLlama`` actor
   (``num_gpus=1``, ``max_concurrency=4``; the witness's engine ticking
   inside), after a card task stopped by ``cancel(force=True)`` (its
   process gone, its card free again): four ``num_returns="streaming"``
   calls at once read round-robin (the witness's tokens bit for bit, the
   calls overlapping, 4 slots busy, each first item read while its call
   ran), a stream with a window of 4 read slowly (never more than 4
   ahead), a stream closed after 8 tokens (its slot free within one
   engine step of the producer's closed report), a running generate
   cancelled, a fifth behind four busy threads
   cancelled and a call with ``deadline_s=0.5`` behind them (neither
   starts), ``recursive=True`` on a CPU task that submitted two generates
   (both stopped), the actor's card named by ``get_runtime_context()``
   and a call's span in the driver's trace; K1 8 a prefill in the actor;
   no process or segment left. Prints each stream's submit to first item
   beside the witness's prefill, the gap between items beside the tick,
   an item's round trip, close to free, each cancel to its error and a
   force cancel to the process's exit (``tools/core_stream_phases.py``
   runs it alone).
5. ``train``: the training main path. ``bench_350m(remat=True,
   remat_policy="dots")`` at full width and depth (f32 params, bf16
   compute) through ``transformer_train_step`` with the default AdamW:
   batch 8, seq 1024, ``shift_inputs``, one seeded token batch; 2 warm-up
   and 10 timed steps. Checks finite, falling losses, the first near
   ln(vocab), and that each step launched K1 48 times (24 layers, and
   again under "dots" remat) and K2 and K3 24 times each. Prints step ms,
   tokens/s, an MFU-style share, peak memory, and one profiled step.
   Then ``moe_train``: the same model with 8 experts, top-2 (capacity
   1.25) in place of its FFN, at full width and MOE_LAYERS (8) of its 24
   layers: 5 AdamW steps with
   16/8/8 launches a step, finite and falling losses, aux per layer in
   (0.1, 10); step ms, tokens/s, peak memory, one profiled step; then its
   weights in bf16 serve one 2048-token prefill (8 K1 launches) and 16
   greedy decode steps (finite logits, tokens in range).
6. ``dist_train``: the mesh training path. The same model, batch and
   seed through ``transformer_train_step(cfg, mesh=make_mesh(
   MeshSpec(fsdp=-1)), rules=RULES_FSDP)``: params and AdamW state as
   DTensors, K1/K2/K3 on each rank's local shards through ``local_map``.
   One rank per visible card, up to 4: with one card it runs in this
   process on a world-1 NCCL group, with more it spawns one process a
   card. 2 warm-up and 3 timed steps. Checks 48/24/24 K1/K2/K3 launches a
   step and that the 5 losses equal the first 5 of ``train`` (bit for bit
   on one card; within 1e-3 relative on more, where the batch shards'
   gradients are summed in another order). Prints step ms beside
   ``train``'s (the host cost of DTensor dispatch), peak memory per rank
   and one profiled step. With 2-4 cards the same ranks then run, one
   after another in that process group, ``seq=world`` under ``RULES_TP``
   with the ring and with Ulysses (4096 tokens a row, 2 rows),
   ``expert=world`` on ``moe_train``'s model and ``pipe=world`` with
   2 x world microbatches: each against the one-device step (the first
   step's gradients per leaf, which rank 0 computes, and the losses),
   within bounds taken from the same step with the plain attention (see
   DIST_FLOOR_FACTOR; the ring's one-device step runs the ring's schedule
   on one card), and each rank's launches against its schedule's
   (rank r of the causal ring runs r + 1 chunks a layer). On one card they
   print one line saying they need 2 or more.
7. ``train_grad_check``: one step's gradients of bench_350m at depth 2,
   batch 2, seq 1024 with the kernels (bf16), with the plain attention
   (bf16) and with the plain attention in f32, compared per leaf.
8. ``vit_infer``: ViT-L/16 (``vit_l16()``, 304 M f32 params, bf16
   compute) at full width and depth on seeded weights and images, batches
   64 and 256: K1 without a mask at 197 tokens, 24 launches a forward;
   finite [B, 1000] f32 logits; at batch 64 the logits within
   LOGITS_REL_L2 of the same forward with the plain attention and no
   further (x1.5) from the f32 forward; one int8-weight forward within
   VIT_INT8_REL_L2 of the bf16 one. Prints ms a batch, images/s, peak
   memory and one profiled forward's busy time and idle share. Then
   ``data_infer``, BASELINE config 5 through the data layer
   (``ray_tpu_torch.data``): ``range(2048 W, parallelism=8 W)`` for W
   pool workers -> a task-stage ``map_batches`` that makes each row's
   224x224x3 uint8 image from ``default_rng(SEED + id)`` ->
   ``ImageNormalizer`` ->
   ``BatchPredictor(TorchPredictor)`` over ViT-L/16 at DATA_VIT_LAYERS
   (8) of its 24 layers (seeded weights in a
   dict checkpoint), batch 64, one pool worker a visible card up to 4,
   each running K1 -> ``take_all``. Checks every id once and in order,
   finite [64, 1000] f32 logits, each worker's K1 launches at 8 a batch
   (8 x 32 W in all), the logits against the same batches through
   ``vit.forward`` in this process on card 0 after the pool has gone (bit
   for bit on one card; on more, each batch bit for bit or within
   DATA_MULTI_REL_L2), then the same normalised data through
   ``iter_device_batches`` onto card 0 (batch 64, prefetch 2: every
   batch equal to its numpy counterpart, its logits the pool's), and that
   no worker is left, also after an injected worker death. Prints
   ``take_all``'s wall split into the pool's start (spawn, the
   checkpoint's load), the first block and the steady images/s beside
   ``vit_infer``'s, each worker's UDF share and pipe seconds, the
   driver's pipe seconds, ``iter_device_batches``' copy GB/s and the idle
   share of its forwards, and peak memory a worker. Then
   ``ppo_train``: PPO with the default Nature-CNN module on
   ``CnnRolloutBenchEnv(256)`` (84x84x4 uint8 frames), fragment 32, train
   batch 8192, minibatch 1024, 2 epochs, the runner's policy and the
   learner on the card: 1 warm-up and 3 timed iterations; finite losses
   and gradient norms, changed weights, env steps counted, the card's
   policy logits within PPO_POLICY_REL_L2 of the same params on the CPU,
   and the parameter change Adam applied in 3 learner updates on one
   on-policy batch (shuffle off) within PPO_LEARNER_REL_L2 per leaf of the
   same updates on the CPU from the same learner state, the CPU's ReLU
   decisions replayed on the card (the same updates with cuDNN's TF32
   allowed, and the stored parameters' change, which carries their f32
   rounding, are read beside it, ungated).
   Prints env-steps/s (sampling alone and whole iterations), learner ms a
   minibatch, the sampling/learning split and one profiled iteration's
   idle share. No kernel of the port runs there (convolutions and dense
   layers are cuDNN and cuBLAS calls, as the reference's are XLA's).
9. Off-policy, offline and multi-agent RL, the JAX package's defaults,
   runner and learner on the card (no kernel of the port runs there: MLP
   products in f32, TF32 off): ``dqn_train`` (DQN, MLP 64-64, on
   ``CartPoleBatchedEnv(16)`` through the runner's episode path, 1 warm-up
   and 3 timed iterations of 4000 env steps and 32 TD updates of 128
   rows, uniform replay and then prioritized: finite losses, changed
   weights, the epsilon schedule in the runner's weights, the target
   synced every iteration, every env step in the buffer, one
   ``update_td`` on the card within OFFPOLICY_UPDATE_REL_L2 per leaf of
   the CPU's from the same state); ``sac_train`` (SAC, actor and twin Q
   256-256, on ``PendulumBatchedEnv(16)``, gymnasium's Pendulum-v1 in
   numpy defined here: alpha moves, the targets move by polyak, actions
   inside the Box, one ``update_sac`` with given noise card against CPU);
   ``offline_train`` (CQL on the SAC buffer's transitions through
   ``write_transitions``, BC and MARWIL on CartPole fragments through
   ``write_fragments``, 2 iterations each: no env steps, one update each
   card against CPU); ``multi_agent_train`` (PPO's shared policy on
   ``MultiAgentBatchedEnv`` over ``TwoAgentEnv``, defined here: every live
   column's steps counted, the dead ones masked). Each prints env-steps/s
   or SGD steps/s; DQN and SAC also updates/s, ms an update, the
   sampling/learning split, one profiled iteration's idle share and peak
   memory.
10. ``train_glue``: the Train layer on the port's own worker processes
   (``ray_tpu_torch.train``). BASELINE config 1, the MNIST DP smoke:
   ``DataParallelTrainer`` with the host backend, 2 CPU workers on gloo,
   running the JAX package's tests/test_train.py loop (defined here), 5
   steps (final step 4, loss under 2.5), and beside it the same loop with
   a failure injected at step 3 and one restart allowed (it resumes from
   rank 0's checkpoint: final step 5, checkpoint step 6). BASELINE config
   2: GPT-2 125M (``gpt2_125m(remat=True, remat_policy="dots")``, full
   width and depth, f32 params, bf16 compute) through ``TorchTrainer``,
   one spawned worker a visible card up to 4, NCCL, ``RULES_DP`` on the
   backend's mesh, 8 x 512 tokens a card from one seeded batch, 2 warm-up
   and 10 timed steps, each loss sent back by ``train.report``. Checks
   finite, falling losses, the first within 0.5 of ln(50257); every rank
   24/12/12 K1/K2/K3 launches a step; all 12 losses bit for bit those
   of the same data=W step on the same seed and batch with no Train layer
   (``glue_dp_rank``: in this process on one card, on W spawned ranks on
   more), which isolates the glue; the losses equal to the same steps run
   with the one-device step in this process (one card; on more, the first
   five within 1e-3 relative: GLUE_LOSS_RTOL); the state every rank saves
   with ``save_sharded`` read back whole here by ``load_sharded()``, its
   leaf sums the workers'; and no worker process left. Prints each fit's
   wall and spawn seconds, the worker's step ms beside the direct step's
   and the witness's, tokens/s a card and peak memory a rank.
11. ``data_ingest``: BASELINE config 2's GPT-2 125M (train_glue's recipe,
   full width, INGEST_LAYERS (4) of its 12 layers, f32 params, bf16
   compute, 8 x 512 positions a card) trained
   through ``TorchTrainer`` from the data layer (``ray_tpu_torch.data``),
   one worker a visible card up to 4 (W). 24 x 8 rows a card, each an
   ``id`` and 513 int64 tokens from ``default_rng(SEED)`` over 50257, go
   through ``write_tfrecords`` as 16 shards; the pipeline is
   ``read_tfrecords(dir).random_shuffle(seed=SEED)``. One ``fit()`` with
   ``datasets={"train": shuffled, "splits": shuffled.streaming_split(W)}``
   (a list has no ``split_shard``, so every rank gets it whole and takes
   its own): 12 steps from ``get_dataset_shard("train")
   .iter_torch_batches(batch_size=8)``, then 12 from the rank's split,
   which the rank then reads to its end. Each rank's 8 rows are its shard
   of the data=W batch (``DTensor.from_local``). Checks: the shards read
   back are the rows written; each rank's first arm took, in order, the
   first 96 ids of the driver's ``shuffled.materialize().split_shard(rank,
   W)``; the splits delivered every id once across the ranks; every loss
   finite, the first within 0.5 of ln 50257; on one card the 24 losses bit
   for bit those of the bare one-device step fed the same batches in the
   same order, on more within GLUE_LOSS_RTOL of the bare data=W step fed
   each rank's batches; K1/K2/K3 192/96/96 launches a rank; in the
   driver ``sort("id")`` gives 0..N-1, ``groupby("shard").count()`` the
   rows a shard as numpy counts them, and ``zip`` of the ids with
   themselves ``id`` and ``id_1``; and after the fit no worker process,
   coordinator thread, socket or spilled file left. Prints the write's
   MB/s, the read's and the shuffle's wall and rows/s (``stats()``), each
   arm's step and batch wait (ms), tokens/s a card beside
   ``train_glue``'s, and a split's block fetch (ms).
12. ``tune_train``: Tune (``ray_tpu_torch.tune``), each trial a process
   of its own on the cards the controller gives it (a trial forks from
   the fork server with torch preloaded). Arm A: ``gpt2_trial`` (GPT-2
   125M at full width and depth, train_glue's seed and tokens, 2 AdamW
   steps an iteration at the trial's lr) at lr 1e-4, 3e-4, 1e-3, 3e-3,
   one card a trial, under ASHA (loss, min, max_t 8, grace 2, reduction
   2). Arm B: ``TorchTrainer(gpt2_train_loop)`` through ``Tuner`` (its
   ``as_trainable``), lr 3e-4 and 1e-3 in ``train_loop_config``, one
   worker a trial. Arm C: PPO at ``ppo_train``'s config (``SmokePPO``,
   cuDNN deterministic) as a Trainable, stopped at iteration 2. Checks:
   every trial ends, none in error; 24/12/12 launches a step in every
   trial and worker; the lr 3e-4 losses of A (as many steps as ran) and
   B (12) bit for bit the same steps in this process, and B's also
   train_glue's (one card); each trial's stop where ASHA, replayed here
   on the results in their order, stops it; the best result the least
   final loss; B's intermediate results numbered by the loop's reports
   and its best checkpoint read back to the loop's leaf sums; C's two
   results bit for bit the same PPO in this process; with 2 cards or
   more B's trials at once on two cards, with 4 A's four at once on
   four; no trial process or worker left. Prints each trial's spawn,
   first result, iterations, median step ms and peak, and the fits'
   walls against the sum of their trials' and the gaps between trials
   on a card.
13. ``kernel_time``: K1, K2, K3 and K2+K3 together (each with its
   achieved TFLOP/s) at the serving and training shapes beside their plain
   versions, the SDPA forward or backward (the yardstick, never used by
   the port: on contiguous copies, each backend that takes them pinned
   in turn, the fastest reported) and their bounds; and K1, K2 and K3
   without a mask on the ring's 2048-token chunk; K1 at ViT-L's shape
   (64, 197, 16/16, 64, no mask). Device times come from CUDA events with
   the card held while the host queues the calls (``held_ms``), each at
   least the least time the card could take for its work.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. A
failed phase raises: the script exits non-zero and prints no result line.

Without a CUDA card, or outside a checkout of the repo, it exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import socket
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
# Prompt lengths of the slice's requests: buckets 8, 128, 1024, 2048, 2048
# and 64, so every attach shape from the smallest bucket to a full prompt.
PROMPT_LENS = (5, 100, 700, 1500, 2048, 37)
NUM_SLOTS, MAX_PROMPT, MAX_NEW = 4, 2048, 64
# K1's timed serving shapes: buckets the slice runs (8, 64, 128, 1024 and
# 2048 in all).
TIMED_SEQ = (128, 1024, 2048)
DECODE_TICKS = 16  # timed ticks at 4 busy slots (< MAX_NEW - 1)
# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense
# bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel against plain: p is rounded to bf16 before p.v (as on the TPU),
# so o agrees to a few bf16 ulps; lse is kept in f32.
O_ATOL = O_RTOL = 2e-2
LSE_ATOL = 1e-3
# K2/K3 against the plain f32 backward, per tensor (dq, dk, dv): relative
# L2. p and ds are rounded to bf16 before their products, as on the TPU.
GRAD_REL_L2 = 2e-2
# The training phase: bench_350m at full width and depth.
TRAIN_BATCH, TRAIN_SEQ, WARM_STEPS, TIMED_STEPS = 8, 1024, 2, 10
# dist_train: steps on the mesh, at most this many ranks, and its losses
# against train's first ones. On one card the mesh path runs the same bf16
# model on the same whole batch, so its losses must be train's exactly; on
# more it sums the batch shards' gradients in another order, and they must
# agree within DIST_LOSS_RTOL (relative). The seq, expert and pipe layouts
# are held to that for their first two losses (the forward, and the first
# AdamW update, which follows the gradients' signs). Their later losses,
# and every layout's first-step gradients per leaf (relative L2), are held
# to a bound read in the same run: each reference's one-device step is run
# again with the plain attention in place of the kernels, and a layout may
# lie at most DIST_FLOOR_FACTOR times as far from the one-device step as
# that run does (a loss never less than DIST_LOSS_RTOL; a gradient never
# more than DIST_GRAD_CAP, so a sum where a mean belongs, or a term counted
# on every pipe or expert rank, which moves a leaf by a world-size factor,
# 0.5 or more, always shows). A layout changes only the order of its
# roundings (the shards sum in another order), as the plain attention
# does; AdamW's second step divides by the gradients' magnitudes, so from
# the third loss on such a change grows. The ring's one-device step runs
# the ring's own schedule on one card (``simulated_ring``): its chunks
# round o to bf16 before the f32 merge, a change of rounding that moved
# the third loss 1.83e-3 (3.4 times the plain attention's distance) from
# the whole-sequence kernels on four H100 80GB HBM3 cards at 700 W;
# sp_check holds the ring to the whole-sequence kernels op by op.
DIST_WARM_STEPS, DIST_TIMED_STEPS, DIST_MAX_RANKS = 2, 3, 4
DIST_LOSS_RTOL, DIST_FLOOR_FACTOR, DIST_GRAD_CAP = 1e-3, 2.0, 0.25
# train_grad_check: one step's gradients, per leaf. The kernel run against
# the plain-attention bf16 run (relative L2), and the kernel run may lie at
# most 1.5 times as far from the f32 run as the plain bf16 run does.
GRAD_CHECK_LAYERS, GRAD_CHECK_BATCH = 2, 2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_GRAD_F32_RATIO = 1.5
# One prefill's last-position logits (relative L2). K1 and the plain
# attention run the same bf16 model and differ only in the attention's
# rounding, a few bf16 ulps of o in each of 32 layers; through 32 layers of
# random weights that reaches about 2e-2 (measured on the H100), so the
# bound is 5e-2. And K1's bf16 run may lie at most 1.5 times as far from
# the same prefill in f32 as the plain attention's bf16 run does.
LOGITS_REL_L2 = 5e-2
LOGITS_F32_RATIO = 1.5
# sp_check: one sequence of SP_SEQ tokens in SP_RANKS chunks at Llama-3-8B's
# attention width, the ring and Ulysses schedules simulated on one card,
# against K1/K2/K3 over the whole sequence: relative L2 of o, dq, dk and dv
# (the kernel_check bound of K2/K3; the ring merges chunks in f32 and its
# backward rounds p and ds to bf16 per chunk as the whole-sequence kernels
# do per tile), lse within LSE_ATOL.
# ViT-L/16 batch inference (BASELINE config 5's compute): 197 tokens, 16
# heads of 64, no mask. int8 weights against the bf16 forward: per-channel
# rounding of every product's weight, 2.5e-2 at depth 4 on the CPU.
VIT_BATCHES = (64, 256)
VIT_SEQ, VIT_HEADS, VIT_HEAD_DIM = 197, 16, 64
VIT_INT8_REL_L2 = 0.15
VIT_TIMED = 5
# data_infer: BASELINE config 5 as a pipeline into a pool of card workers:
# one pool worker a visible card up to DATA_MAX_WORKERS, and DATA_ROWS rows
# in DATA_BLOCKS blocks a worker (256 rows, so every DATA_BATCH-row batch
# lies in one block; each worker runs 7 blocks after its first, which a
# fresh process pays its warm-up in). Its logits against the same batches through vit.forward
# in this process on card 0: bit for bit on one card (same program, card
# and shapes); on more, a card's cuBLAS may choose another algorithm, so a
# batch is bit for bit or within DATA_MULTI_REL_L2 (relative L2).
DATA_ROWS, DATA_BLOCKS, DATA_BATCH, DATA_MAX_WORKERS = 2048, 8, 64, 4
# data_infer's ViT-L/16 runs DATA_VIT_LAYERS of its 24 layers (its
# witness, the forward in this process, at the same depth; vit_infer
# holds the model at full depth; PERF.md section 4 lists the cut).
DATA_VIT_LAYERS = 8
DATA_PREFETCH = 2
DATA_MULTI_REL_L2 = 1e-5
# PPO on the Atari-shaped CnnRolloutBenchEnv (BASELINE config 4's shape):
# 256 envs, fragment 32 (train batch 8192), minibatch 1024, 2 epochs.
PPO_ENVS, PPO_FRAGMENT, PPO_MINIBATCH, PPO_EPOCHS = 256, 32, 1024, 2
PPO_TIMED_ITERS = 3
# ppo_remote: the same batch from PPO_RUNNERS CPU runner processes of
# PPO_RUNNER_ENVS envs (one torch thread each, as the reference's
# num_cpus=1 runner), the learner in a learner process on the card. A
# learner process built by the same factory, with cuDNN held to its
# deterministic algorithms there and in this process (for the check only),
# updates one batch (PPO_CHECK_STEPS minibatches) from the run's state,
# and PPO_REMOTE_CHECK_RUNS in-process learners do the same: the process's
# parameter change and update metrics must lie within the largest gap
# between two in-process runs, which is zero where the arithmetic is
# deterministic. An in-process update that skips the last minibatch is read
# too and must lie beyond that gap. (cuDNN's default f32 weight gradient is
# not deterministic on the H100: in-process runs read 9.4e-7-1.1e-5 apart
# and once 5.4e-4; PERF.md section 6.)
PPO_RUNNERS, PPO_RUNNER_ENVS = 4, 64
PPO_REMOTE_CHECK_RUNS = 3
# impala_async: IMPALA on IMPALA_RUNNERS CPU runner processes of
# IMPALA_ENVS CartPoleBatchedEnv columns, a sample of IMPALA_FRAGMENT
# steps a column, IMPALA_UPDATES updates a step, the weights to the whole
# fleet after every update; IMPALA_STEPS steps (the first a warm-up),
# runner 0 killed with its sample in flight before step IMPALA_KILL_AT;
# then APPO for APPO_STEPS steps.
IMPALA_RUNNERS, IMPALA_ENVS, IMPALA_FRAGMENT = 4, 64, 50
IMPALA_UPDATES, IMPALA_BROADCAST = 4, 1
IMPALA_STEPS, IMPALA_KILL_AT, APPO_STEPS = 5, 3, 2
# The card's policy logits against the same params on the CPU: both f32
# (TF32 off), other summation orders.
PPO_POLICY_REL_L2 = 1e-4
# The learner's update on the card against the CPU's: 3 minibatches of 512
# rows at lr 1e-4 (as tests/test_torch_rllib.py holds the JAX learner), the
# worst relative L2 per leaf of the change Adam applied, before the
# parameters' own f32 rounding (applied_change). The convs and their
# gradients are f32 on both sides; TF32 would read about 1e-3.
PPO_CHECK_MINIBATCH, PPO_CHECK_STEPS, PPO_CHECK_LR = 512, 3, 1e-4
PPO_LEARNER_REL_L2 = 1e-4
# Off-policy, offline and multi-agent RL: the JAX package's defaults
# (DQNConfig, SACConfig, CQLConfig, BCConfig, MARWILConfig) on 16 envs; one
# warm-up and 3 timed iterations of DQN and SAC (4000 env steps each);
# offline, two fragments of 256 steps over 16 envs (8192 rows) and 2
# iterations of 32 SGD steps; multi-agent, 8 instances of two agents, a
# fragment of 64. One update on the card against the same on the CPU from
# the same learner state (and noise): the worst relative L2 per leaf of
# the change Adam applied (applied_change), f32 products on both sides
# (TF32 off).
RL_ENVS, RL_WARM_ITERS, RL_TIMED_ITERS = 16, 1, 3
OFFLINE_FRAGMENT, OFFLINE_ITERS = 256, 2
MA_INSTANCES, MA_FRAGMENT, MA_ITERS = 8, 64, 2
OFFPOLICY_UPDATE_REL_L2 = 1e-4
# train_glue: BASELINE config 1 (the MNIST DP smoke) on 2 CPU workers, and
# config 2, GPT-2 125M data-parallel through TorchTrainer, one worker a
# visible card (up to 4), 8 x 512 tokens a card, as the JAX package's
# benchmarks/gpt2_e2e.py; 2 warm-up and 10 timed steps. On any number of
# cards every loss must be, bit for bit, that of the same data=W step run
# with no Train layer (glue_dp_rank): that holds the glue. Against the
# one-device step: on one card the worker runs the same model, params,
# batch and steps, so its losses must be the direct step's exactly. On more,
# every product runs on a rank's rows (other GEMM shapes, other roundings)
# and the shards' gradients are summed in another order: the first
# GLUE_HELD_STEPS losses must lie within GLUE_LOSS_RTOL (relative), as
# dist_train holds its five. Later ones are printed, not held: AdamW's
# first steps follow the gradients' signs, which rounding flips where a
# gradient is near 0, and from the sixth step the recipe's loss spikes (on
# one card too). On four H100 80GB HBM3 cards at 700 W the first five lay
# 8.7e-8-3.0e-4 from the direct step's, the sixth 9.5e-4, the seventh
# 2.1e-3, the eighth, after the spike, 0.12; the direct step with the plain
# attention lay 1.4e-2 from it there.
GLUE_MNIST_WORKERS, GLUE_MAX_WORKERS = 2, 4
GLUE_BATCH, GLUE_SEQ, GLUE_WARM_STEPS, GLUE_TIMED_STEPS = 8, 512, 2, 10
GLUE_LOSS_RTOL, GLUE_HELD_STEPS = 1e-3, 5
# data_ingest: train_glue's GPT-2 125M recipe fed by the data layer.
# INGEST_BATCHES x GLUE_BATCH rows a card (GLUE_SEQ + 1 tokens a row, so
# the model sees GLUE_SEQ positions as in train_glue), written as
# INGEST_SHARDS TFRecord files; INGEST_STEPS steps from the shard of
# get_dataset_shard, then INGEST_STEPS from the rank's streaming split.
INGEST_BATCHES, INGEST_SHARDS, INGEST_STEPS = 24, 16, 12
# data_ingest's model runs INGEST_LAYERS of GPT-2 125M's 12 layers (its
# witness, the bare step, at the same depth; PERF.md section 4 lists the
# cut).
INGEST_LAYERS = 4
# tune_train: train_glue's GPT-2 125M recipe (one card a trial) and
# ppo_train's PPO as Tune trials. Arm A: a trial a learning rate of
# TUNE_LRS under ASHA (grace TUNE_GRACE, reduction TUNE_RF, at most
# TUNE_MAX_T iterations of TUNE_STEPS_PER_ITER AdamW steps); arm B: a
# TorchTrainer trial a learning rate of TUNE_TRAINER_LRS (train_glue's
# 12 steps); arm C: TUNE_PPO_ITERS iterations of PPO.
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
TUNE_MAX_T, TUNE_GRACE, TUNE_RF, TUNE_STEPS_PER_ITER = 8, 2, 2, 2
TUNE_TRAINER_LRS = (3e-4, 1e-3)
TUNE_PPO_ITERS = 2
# Arm A's trials run on their card (a rehearsal on the CPU sets "cpu").
TUNE_DEVICE = "cuda:0"
SP_SEQ, SP_RANKS, SP_HEADS, SP_KV_HEADS, SP_HEAD_DIM = 8192, 4, 32, 8, 128
SP_REL_L2 = 2e-2
# moe_train: bench_350m with Mixtral's routing (8 experts, top-2, capacity
# 1.25) at full width and depth: 2 warm-up and 3 timed AdamW steps; then
# the same weights in bf16 serve one PREFILL-token prefill and SERVE_DECODE
# greedy decode steps. The aux loss per layer must lie in (0.1, 10), as
# tests/test_moe.py holds it (about 1 at uniform routing).
MOE_EXPERTS, MOE_TOP_K = 8, 2
# moe_train and dist_train's expert layout run MOE_LAYERS of bench_350m's
# 24 layers (PERF.md section 4 lists the cut).
MOE_LAYERS = 8
MOE_WARM_STEPS, MOE_TIMED_STEPS = 2, 3
MOE_PREFILL, MOE_DECODE = 2048, 16
# dist_train's layouts past fsdp, with 2-4 cards: seq (ring, Ulysses) at
# DIST_LONG_SEQ tokens a row and DIST_LONG_BATCH rows, expert (the MoE
# model), pipe (2 x world microbatches).
DIST_LONG_SEQ, DIST_LONG_BATCH = 4096, 2
DIST_LAYOUTS = ("fsdp", "seq_ring", "seq_ulysses", "expert", "pipe")
# The serve phases: Llama-3-8B behind the Serve layer, one replica process
# a card (the engine's shapes: 4 slots, prompts to 2048, 64 new tokens).
# serve_batch's prompts all fall in the 2048 bucket, so every batch the
# coalescer forms is [4, 2048]. A stream of serve_stream is closed after
# SERVE_CLOSE_AFTER tokens. serve_disagg's decode replica keeps a prefix
# cache of SERVE_PREFIX_MB: a 2048-token entry is 256 MiB of K/V (32
# layers x 8 kv heads x 128 x 2 x bf16 = 128 KiB a token) and its logits,
# past the 256 MiB default.
SERVE_BATCH_LENS = (1100, 1300, 1500, 2048)
SERVE_CLOSE_AFTER = 3
# The serve phases run Llama-3-8B at full width and SERVE_LAYERS of its 32
# layers (the slice holds it at full depth; what the Serve layer adds,
# processes, routing and streams, does not depend on the depth), held to
# a witness at that depth (phase_serve_witness). PERF.md section 4 lists
# the cut.
SERVE_LAYERS = 8
SERVE_PREFIX_MB = 2048
SERVE_READY_TIMEOUT_S = 600


# The wall clock of the last phase line: each line's ``phase_s``, unless
# the phase gives its own, is the seconds since the line before it (the
# first since the script's start).
_LAST_LINE = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    fields.setdefault("phase_s", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def keep_bytecode() -> None:
    """Let this process and the processes it starts cache the bytecode
    they compile, under ``ray_tpu_torch/_build/pycache`` (git-ignored),
    where the checkout holds the package: on a machine that sets
    PYTHONDONTWRITEBYTECODE, every fresh process (a worker, a replica, a
    trial) otherwise compiles torch's Python anew (``import torch`` 8.2-9.0
    s on the H100's host, 6.2 s with the cache; PERF.md section 5)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ray_tpu_torch")):
        return
    prefix = os.path.join(here, "ray_tpu_torch", "_build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_flops(B, S, H, D, causal):
    """q.k^T and p.v at 2 flops a multiply-add over the (query, key) pairs
    the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def flash_bound(B, S, H, KVH, D, causal):
    """Least time for one forward: q.k^T and p.v at 2 flops a multiply-add
    over the (query, key) pairs the mask keeps, against q/k/v read once and
    o/lse written once. Returns (ms, "operations" | "bytes")."""
    flops = flash_flops(B, S, H, D, causal)
    nbytes = 2.0 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4.0 * B * H * S
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def attn_inputs(seed, B, S, H, KVH, D, device, fused=""):
    """Seeded bf16 q/k/v [B, S, heads, D]. With ``fused="kv"`` k and v are
    views into one [B, S, 2, KVH, D] tensor, the layout the model's fused
    k/v projection (``wkv``, GQA) hands to attention; with ``fused="qkv"``
    q, k and v are views into one [B, S, 3, H, D] tensor, that of the fused
    ``wqkv`` projection (MHA, the training model); with ``fused="nan"``
    each is the [:, :S] view of a [B, S + 64, heads, D] tensor whose rows
    past S hold NaN."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    if fused == "nan":
        out = []
        for heads in (H, KVH, KVH):
            x = t((B, S + 64, heads, D))
            x[:, S:] = float("nan")
            out.append(x[:, :S])
        return tuple(out)
    if fused == "qkv":
        qkv = t((B, S, 3, H, D))
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = t((B, S, H, D))
    if fused == "kv":
        kv = t((B, S, 2, KVH, D))
        return q, kv[:, :, 0], kv[:, :, 1]
    return q, t((B, S, KVH, D)), t((B, S, KVH, D))


def glue_attn_case():
    """The attention train_glue runs on each card: GPT-2 125M's heads at a
    card's rows, q/k/v as views of the fused wqkv projection."""
    from ray_tpu_torch.models.configs import gpt2_125m

    cfg = gpt2_125m()
    return (GLUE_BATCH, GLUE_SEQ, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
            True, "qkv")


def phase_kernel_check(fa, bucket_len, device):
    import torch

    cases = []
    for H, KVH, D in ((16, 16, 64), (32, 8, 128)):
        for S in (96, 192, 2048):
            for causal in (True, False):
                cases.append((2 if S < 2048 else 1, S, H, KVH, D, causal,
                              ""))
    cases.append((1, 100, 4, 2, 32, True, ""))
    # Ragged lengths: below one 128-key tile, and tails past a multiple of
    # it; MHA, GQA 32/8 and 4/2 at each head dim.
    for H, KVH, D in ((16, 16, 64), (32, 8, 128), (4, 2, 32)):
        for S in (5, 37, 130, 1000):
            cases.append((2, S, H, KVH, D, True, ""))
    buckets = sorted({bucket_len(n, MAX_PROMPT) for n in PROMPT_LENS})
    cases += [(1, S, 32, 8, 128, True, "kv") for S in buckets]
    # The training shape, q/k/v as views of the fused wqkv projection,
    # and train_glue's (GPT-2 125M, a card's rows).
    cases.append((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True, "qkv"))
    cases.append(glue_attn_case())
    # ViT-L's attention: 197 tokens (64 past the last 128-key tile), no
    # mask, views of the fused wqkv projection, at vit_infer's batch 64.
    cases.append((VIT_BATCHES[0], VIT_SEQ, VIT_HEADS, VIT_HEADS,
                  VIT_HEAD_DIM, False, "qkv"))
    # q/k/v as [:, :S] views of [B, S + 64, heads, D] tensors whose rows
    # past S hold NaN: the kernel must never read past S.
    cases += [(2, 100, H, KVH, D, True, "nan")
              for H, KVH, D in ((32, 8, 128), (16, 16, 64), (4, 2, 32))]
    worst_o = worst_lse = 0.0
    rows = []
    for i, (B, S, H, KVH, D, causal, fused) in enumerate(cases):
        q, k, v = attn_inputs(100 + i, B, S, H, KVH, D, device, fused)
        o, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
        o, po = o.float(), po.float()
        o_err = float((o - po).abs().max())
        lse_err = float((lse - plse).abs().max())
        o_ok = bool(((o - po).abs() <= O_ATOL + O_RTOL * po.abs()).all()
                    and torch.isfinite(o).all() and torch.isfinite(lse).all())
        rows.append({"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": causal, "fused": fused,
                     "o_err": o_err, "lse_err": lse_err})
        if not (o_ok and lse_err <= LSE_ATOL):
            emit("kernel_check", ok=False, failed=rows[-1])
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{rows[-1]}")
        worst_o, worst_lse = max(worst_o, o_err), max(worst_lse, lse_err)
    emit("kernel_check", kernel="flash_fwd", ok=True, cases=rows,
         o_atol=O_ATOL, o_rtol=O_RTOL,
         lse_atol=LSE_ATOL, max_o_err=worst_o, max_lse_err=worst_lse)
    return worst_o


def bwd_inputs(seed, B, S, H, KVH, D, causal, device, fused=""):
    """Seeded bf16 q/k/v/do and f32 lse/delta for the backward. With
    ``fused="qkv"`` q, k and v are views into one [B, S, H + 2 KVH, D]
    tensor, the layout of the model's fused projection; with
    ``fused="nan"`` q, k, v and do are the [:, :S] views of [B, S + 64,
    heads, D] tensors whose rows past S hold NaN. lse and delta come from
    the plain forward, so kernel and plain version get the same inputs."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    def nan_tail(heads):
        x = t((B, S + 64, heads, D))
        x[:, S:] = float("nan")
        return x[:, :S]

    if fused == "nan":
        q, k, v, do = nan_tail(H), nan_tail(KVH), nan_tail(KVH), nan_tail(H)
    else:
        if fused == "qkv":
            qkv = t((B, S, H + 2 * KVH, D))
            q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KVH],
                       qkv[:, :, H + KVH:])
        else:
            q, k, v = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D))
        do = t((B, S, H, D))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
    return q, k, v, do, lse, fa.attention_delta(do, o)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_kernel_check_bwd(fa, device):
    """K2 (dq) and K3 (dk, dv) against the plain backward, per tensor."""
    import torch

    # K1's grid: lengths below one tile and ragged tails past it, each head
    # dim, MHA and GQA groups of 4 and 2 (K3 spreads a group over a
    # cluster), causal and not.
    cases = [(2, S, H, KVH, D, causal, "")
             for H, KVH in ((16, 16), (32, 8), (4, 2))
             for D in (32, 64, 128)
             for S in (5, 37, 130, 1000)
             for causal in (True, False)]
    # Groups past the portable cluster size: 16/1 takes 2 heads a block on
    # clusters of 8, 24/2 2 heads a block on clusters of 6.
    cases += [(1, 300, 16, 1, 64, True, ""), (1, 300, 24, 2, 128, False, "")]
    # q/k/v as views of the fused projection, and views whose rows past S
    # hold NaN (the kernels must never read past S); the training shape.
    cases += [(2, 130, 16, 16, 64, True, "qkv"),
              (1, 192, 32, 8, 128, False, "qkv")]
    cases += [(2, 100, H, KVH, D, causal, "nan")
              for H, KVH, D in ((32, 8, 128), (16, 16, 64), (4, 2, 32))
              for causal in (True, False)]
    cases += [(TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True, "qkv"),
              glue_attn_case()]
    # The ring's chunk shapes at Llama-3-8B's width, causal and not.
    cases += [(1, SP_SEQ // SP_RANKS, SP_HEADS, SP_KV_HEADS, SP_HEAD_DIM,
               causal, "") for causal in (True, False)]
    rows = []
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (B, S, H, KVH, D, causal, fused) in enumerate(cases):
        args = bwd_inputs(200 + i, B, S, H, KVH, D, causal, device, fused)
        got = fa.flash_bwd_core(*args, scale=D ** -0.5, causal=causal)
        want = fa.flash_attention_bwd_plain(*args, D ** -0.5, causal)
        row = {"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
               "causal": causal, "fused": fused}
        ok = True
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max())
            rel = rel_l2(g, w)
            row[name + "_max_abs"], row[name + "_rel_l2"] = err, rel
            ok &= bool(torch.isfinite(g).all()) and rel <= GRAD_REL_L2
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], err)
        rows.append(row)
        if not ok:
            emit("kernel_check", kernel="flash_bwd", ok=False, failed=row)
            raise AssertionError(f"K2/K3 disagree with their plain "
                                 f"version: {row}")
    emit("kernel_check", kernel="flash_bwd", ok=True, cases=rows,
         rel_l2_tol=GRAD_REL_L2, max_dq_err=worst["dq"],
         max_dkv_err=worst["dkv"],
         max_rel_l2={n: max(r[n + "_rel_l2"] for r in rows)
                     for n in ("dq", "dk", "dv")})
    return worst


def phase_slice(device):
    """The main path: the engine serving 6 requests on Llama-3-8B."""
    import torch

    from ray_tpu_torch import flags
    from ray_tpu_torch.models.configs import llama3_8b
    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import (ContinuousBatchingEngine,
                                                bucket_len)

    cfg = llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ContinuousBatchingEngine(
        cfg, params, num_slots=NUM_SLOTS, max_prompt_len=MAX_PROMPT,
        max_new_tokens=MAX_NEW, seed=SEED, model="llama3_8b", device=device)

    # Instrumentation around the engine's own units, no change to them:
    # tick times (host clock; a tick ends by reading its tokens, which
    # waits for the device), each prefill's logits, and a device-side
    # running check that every decode logit is finite.
    ticks = []
    prefills = []
    finite = torch.ones((), dtype=torch.bool, device=device)
    tick, step, prefill_one = eng.tick, eng._tick, eng._prefill_one

    def timed_tick():
        active = sum(eng.active)
        t = time.perf_counter()
        n = tick()
        if active:
            ticks.append((active, time.perf_counter() - t))
        return n

    def checked_step(*args):
        nxt, logits, cache = step(*args)
        finite.logical_and_(torch.isfinite(logits).all())
        return nxt, logits, cache

    def recorded_prefill(p, tokens, length):
        out = prefill_one(p, tokens, length)
        prefills.append((int(tokens.shape[1]), int(length[0]), out[0]))
        return out

    prompts = slice_prompts(cfg)
    eng.tick, eng._tick, eng._prefill_one = (timed_tick, checked_step,
                                             recorded_prefill)
    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    fa.flash_attention_fwd.launches = 0  # count the main path alone
    ticker.start()
    try:
        t0 = time.perf_counter()
        reqs = []
        for prompt in prompts:
            ticks_before = len(ticks)
            r = eng.submit(prompt, timeout=600)
            # A slot frees only when a request retires: a submit that
            # returns after an earlier request is done waited for a slot.
            reqs.append({"req": r, "prompt_len": len(prompt),
                         "bucket": bucket_len(len(prompt), MAX_PROMPT),
                         "ticks_before_attach": len(ticks),
                         "ticks_during_submit": len(ticks) - ticks_before,
                         "earlier_done_at_attach": sum(
                             eng.is_done(x["req"]) for x in reqs)})
        outs = [eng.result(x["req"], timeout=600) for x in reqs]
        wall = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
    finally:
        stop.set()
        ticker.join(timeout=60)
    if ticker.is_alive() or eng.failed is not None:
        raise RuntimeError(f"engine ticker did not stop cleanly: "
                           f"{eng.failed!r}")
    eng.tick, eng._tick, eng._prefill_one = tick, step, prefill_one

    failures = []
    for x, out in zip(reqs, outs):
        x["tokens"] = len(out)
        if len(out) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in out):
            failures.append(f"request {x['req']}: {len(out)} tokens, "
                            f"first {out[:8]}")
    if not bool(finite):
        failures.append("a decode tick produced NaN or inf logits")
    for S, n, logits in prefills:
        if not bool(torch.isfinite(logits).all()):
            failures.append(f"prefill S={S} produced non-finite logits")
    if len(prefills) != len(PROMPT_LENS) or launches != (
            cfg.n_layers * len(prefills)):
        failures.append(f"K1 launched {launches} times for {len(prefills)} "
                        f"prefills of {cfg.n_layers} layers")
    mid_flight = sum(x["ticks_before_attach"] > 0 for x in reqs)
    waited = sum(x["earlier_done_at_attach"] > 0 for x in reqs)
    if mid_flight < 2 or waited < 2:
        failures.append(f"expected >= 2 mid-flight attaches and >= 2 slot "
                        f"waits, got {mid_flight} and {waited}")

    # One prompt's prefill logits with K1 (from the engine's run) against
    # the same prefill under the plain attention, and both against the same
    # prefill computed in f32 (the bf16 weights cast up at use), which
    # shows how far apart two bf16 runs of this model fall anyway.
    S_ref, n_ref, k1_logits = next(p for p in prefills if p[1] == 700)
    tokens = torch.zeros((1, S_ref), dtype=torch.int64, device=device)
    tokens[0, :n_ref] = torch.tensor(prompts[PROMPT_LENS.index(700)])
    length = torch.tensor([n_ref], device=device)
    with flags.scoped({"RTPU_ATTN_IMPL": "xla"}):
        plain_logits = prefill(params, tokens, cfg, S_ref,
                               lengths=length)[0][0]
        f32_logits = prefill(params, tokens,
                             dataclasses.replace(cfg, dtype=torch.float32),
                             S_ref, lengths=length)[0][0]

    k1_vs_plain = rel_l2(k1_logits, plain_logits)
    k1_vs_f32 = rel_l2(k1_logits, f32_logits)
    plain_vs_f32 = rel_l2(plain_logits, f32_logits)
    if not (k1_vs_plain <= LOGITS_REL_L2
            and k1_vs_f32 <= LOGITS_F32_RATIO * plain_vs_f32):
        failures.append(f"prefill logits: K1 vs plain {k1_vs_plain} (tol "
                        f"{LOGITS_REL_L2}); vs f32 K1 {k1_vs_f32}, plain "
                        f"{plain_vs_f32} (ratio tol {LOGITS_F32_RATIO})")

    # Which ticks of the run above had every slot busy depends on how the
    # prefills on the submitting thread interleave with the ticker, so the
    # gap between tokens at 4 busy slots is timed apart: 4 requests
    # attached, the ticker stopped, no prefill alongside. A tick ends by
    # reading its tokens to the host, so the host clock spans its device
    # work.
    run_four = [dt for active, dt in ticks if active == NUM_SLOTS]
    held = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
    eng.tick()  # warm
    four = []
    for _ in range(DECODE_TICKS):
        t = time.perf_counter()
        if eng.tick() != NUM_SLOTS:
            failures.append("a timed decode tick had a slot retire")
        four.append(time.perf_counter() - t)
    for r in held:
        eng.abort(r)
    tick_ms = statistics.median(four) * 1e3
    emit("slice", ok=not failures, failures=failures, model="llama3_8b",
         param_dtype=str(cfg.param_dtype).replace("torch.", ""),
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.kv_heads, d_ff=cfg.ff_dim, vocab=cfg.vocab_size,
         num_params=cfg.num_params(), init_s=init_s,
         num_slots=NUM_SLOTS, max_prompt_len=MAX_PROMPT,
         max_new_tokens=MAX_NEW, requests=reqs, prefills=len(prefills),
         k1_launches=launches, ticks=len(ticks),
         run_ticks_at_4_slots=len(run_four),
         run_tick_ms_4_slots_median=(statistics.median(run_four) * 1e3
                                     if run_four else None),
         decode_ticks_timed=len(four),
         decode_tick_ms_4_slots_median=tick_ms,
         decode_tokens_per_s_4_slots=(NUM_SLOTS * 1e3 / tick_ms
                                      if tick_ms else None),
         wall_s=wall, tokens=sum(len(o) for o in outs),
         tokens_per_s=sum(len(o) for o in outs) / wall,
         prefill_logits={
             "prompt_len": n_ref, "bucket": S_ref,
             "k1_vs_plain_rel_l2": k1_vs_plain, "tol": LOGITS_REL_L2,
             "k1_vs_f32_rel_l2": k1_vs_f32,
             "plain_vs_f32_rel_l2": plain_vs_f32,
             "f32_ratio_tol": LOGITS_F32_RATIO,
             "k1_vs_plain_max_abs": float(
                 (k1_logits - plain_logits).abs().max()),
             "same_argmax_k1_plain_f32": [
                 int(k1_logits.argmax()), int(plain_logits.argmax()),
                 int(f32_logits.argmax())]},
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    if failures:
        raise AssertionError("; ".join(failures))
    return cfg, params, prompts, outs, launches, eng, tick_ms / 1e3


def phase_prefill_time(cfg, params, prompts, device):
    rows = _prefill_rows(cfg, params, prompts, device)
    emit("prefill_time", model="llama3_8b", rows=rows)
    return {r["bucket"]: r["ms_median"] for r in rows}


def _prefill_rows(cfg, params, prompts, device):
    """Each prefill bucket of ``prompts`` timed: 3 calls after a warm-up."""
    import torch

    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.serve.llm_engine import bucket_len

    rows = []
    for prompt in sorted(prompts, key=len):
        S = bucket_len(len(prompt), MAX_PROMPT)
        if any(r["bucket"] == S for r in rows):
            continue
        tokens = torch.zeros((1, S), dtype=torch.int64, device=device)
        tokens[0, :len(prompt)] = torch.tensor(prompt)
        length = torch.tensor([len(prompt)], device=device)
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(params, tokens, cfg, S, lengths=length)
            torch.cuda.synchronize()
            if i:  # the first call warms up
                times.append((time.perf_counter() - t) * 1e3)
        rows.append({"bucket": S, "prompt_len": len(prompt),
                     "ms_median": statistics.median(times), "ms": times})
    return rows


# In one process torch.profiler loses kernel records, more the older the
# process: without a preface, the first 2 of 20 K1 launches at 45 s, all 20
# from 285 s, idle or not (tools/profiler_probe.py; PERF.md section 6).
# Each profile therefore opens with PROFILE_PREFACE spin kernels of
# PROFILE_SPIN_CYCLES cycles (about 24 ms on the H100), left out of its
# sums: they take most of the loss (all 20 K1 records kept to 435 s), not
# all of it, so kernel times come from CUDA events (device_ms).
PROFILE_PREFACE, PROFILE_SPIN_CYCLES = 400, 100_000


@contextlib.contextmanager
def _profiled():
    """A torch.profiler window over the block, opened by the preface, the
    card's work in it finished."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PREFACE):
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
        yield prof
        torch.cuda.synchronize()


def _device_kernels(prof):
    """The kernels and copies of a profile, its preface left out (and the
    spans that annotations such as ``Optimizer.step`` lay over the device's
    timeline: they cover the kernels in them and idle time too)."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and "spin_kernel" not in e.key]


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; returns (device busy ms, every
    kernel and copy as [name, ms], by device time)."""
    with _profiled() as prof:
        fn()
    kernels = sorted(_device_kernels(prof),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us / 1e3, [[e.key[:80], e.self_device_time_total / 1e3]
                           for e in kernels]


def phase_profile(cfg, params, prompts, eng, tick_s, device):
    """Device busy time of one decode tick at 4 busy slots and of one
    prefill per bucket, from torch.profiler, against the same work timed
    without the profiler: idle share = 1 - busy / unprofiled time."""
    import torch

    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import bucket_len

    reqs = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
    eng.tick()  # warm
    busy, top = _device_profile(lambda: [eng.tick() for _ in range(3)])
    # A profiler that records no device time gives None, not an idle card.
    tick = {"busy_ms": busy / 3, "unprofiled_ms": tick_s * 1e3,
            "idle_share": 1 - busy / 3 / (tick_s * 1e3) if busy else None,
            "top_kernels_ms_per_3_ticks": top[:6]}
    for r in reqs:
        eng.abort(r)
    rows = []
    for n in (5, 2048):
        S = bucket_len(n, MAX_PROMPT)
        tokens = torch.zeros((1, S), dtype=torch.int64, device=device)
        tokens[0, :n] = torch.tensor(prompts[PROMPT_LENS.index(n)])
        length = torch.tensor([n], device=device)
        run = lambda: prefill(params, tokens, cfg, S, lengths=length)
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        busy, top = _device_profile(run)
        k1_ms = sum(ms for name, ms in top if "flash_fwd" in name)
        rows.append({"bucket": S, "busy_ms": busy, "unprofiled_ms": wall_ms,
                     "idle_share": 1 - busy / wall_ms if busy else None,
                     "k1_share_of_busy": k1_ms / busy if busy else None,
                     "top_kernels_ms": top[:6]})
    emit("profile", decode_tick_4_slots=tick, prefill=rows)



# ------------------------------------------------------------ serve phases


def serve_cfg():
    """The serve phases' model: Llama-3-8B in bf16, SERVE_LAYERS layers."""
    import torch

    from ray_tpu_torch.models.configs import llama3_8b

    return llama3_8b(param_dtype=torch.bfloat16, n_layers=SERVE_LAYERS)


class SeededLlama:
    """The serve phases' params factory, run in the replica process:
    ``serve_cfg()``'s model from ``seed`` (SEED by default) on the
    replica's card, as phase_serve_witness makes the witness's (the same
    seed on a card of the same kind gives the same weights)."""

    def __init__(self, seed=SEED):
        self.seed = seed

    def __call__(self):
        import torch

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.models.transformer import init_params

        dev = resolve_device(None)
        return init_params(serve_cfg(),
                           torch.Generator(device=dev).manual_seed(self.seed),
                           dev)


def slice_prompts(cfg):
    """The slice's prompts: PROMPT_LENS tokens from default_rng(SEED)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def phase_serve_witness(device):
    """The serve phases' witness, at their depth: serve_cfg()'s model from
    SeededLlama in this process behind the slice's engine (NUM_SLOTS
    slots, prompts to MAX_PROMPT, MAX_NEW new tokens), the slice's
    prompts: each one's greedy tokens, the decode tick at 4 busy slots and
    each prefill bucket's time. Returns (cfg, params, prompts, tokens,
    engine, tick seconds, prefill ms by bucket)."""
    import torch

    from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

    cfg = serve_cfg()
    prompts = slice_prompts(cfg)
    t0 = time.perf_counter()
    params = SeededLlama()()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ContinuousBatchingEngine(
        cfg, params, num_slots=NUM_SLOTS, max_prompt_len=MAX_PROMPT,
        max_new_tokens=MAX_NEW, seed=SEED, model="llama3_8b", device=device)
    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    ticker.start()
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, timeout=600) for p in prompts]
        outs = [eng.result(r, timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        ticker.join(timeout=60)
    if ticker.is_alive() or eng.failed is not None:
        raise RuntimeError(f"engine ticker did not stop cleanly: "
                           f"{eng.failed!r}")
    held = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
    eng.tick()  # warm
    four = []
    for _ in range(DECODE_TICKS):
        t = time.perf_counter()
        eng.tick()
        four.append(time.perf_counter() - t)
    for r in held:
        eng.abort(r)
    tick_s = statistics.median(four)
    rows = _prefill_rows(cfg, params, prompts, device)
    failures = [f"request {i}: {len(o)} tokens" for i, o in enumerate(outs)
                if len(o) != MAX_NEW]
    emit("serve_witness", ok=not failures, failures=failures,
         model="llama3_8b", n_layers=cfg.n_layers, init_s=init_s,
         wall_s=wall, tokens=sum(len(o) for o in outs),
         decode_tick_ms_4_slots_median=tick_s * 1e3, prefill=rows)
    if failures:
        raise AssertionError("; ".join(failures))
    return (cfg, params, prompts, outs, eng, tick_s,
            {r["bucket"]: r["ms_median"] for r in rows})


def _serve_run(app, **run_kwargs):
    """serve.run with a ready timeout that an 8B init leaves room for;
    returns (handle, seconds)."""
    from ray_tpu_torch import flags, serve

    t0 = time.perf_counter()
    with flags.scoped({"RTPU_SERVE_READY_TIMEOUT_S":
                       str(SERVE_READY_TIMEOUT_S)}):
        handle = serve.run(app, **run_kwargs)
    return handle, time.perf_counter() - t0


def _replicas(name):
    from ray_tpu_torch.serve import controller

    return controller._local.get_replicas(name)[1]


def _starts(name):
    from ray_tpu_torch.serve import controller

    return controller._local.get_replica_starts(name)


def _stream(handle, prompt, close_after=None, max_new_tokens=None,
            request_id=None):
    """One stream through the handle: its tokens and each token's seconds
    since the call; closed after ``close_after`` tokens."""
    t0 = time.perf_counter()
    toks, stamps = [], []
    request = {"tokens": prompt}
    if max_new_tokens is not None:
        request["max_new_tokens"] = max_new_tokens
    if request_id is not None:
        handle = handle.options(request_id=request_id)
    st = handle.options(stream=True).remote(request)
    for chunk in st:
        if "token" not in chunk:
            raise AssertionError(f"stream answered {chunk}")
        stamps.append(time.perf_counter() - t0)
        toks.append(chunk["token"])
        if close_after is not None and len(toks) == close_after:
            st.close()
            break
    return toks, stamps


def _streams_four_at_a_time(handle, prompts, close_after=None,
                            request_ids=None):
    """Stream ``prompts`` NUM_SLOTS at a time (a consumer thread each);
    ``close_after`` maps a prompt's index to the tokens read before its
    stream is closed. Returns [(tokens, stamps)] in order and the wall."""
    from concurrent.futures import ThreadPoolExecutor

    close_after = close_after or {}
    request_ids = request_ids or [None] * len(prompts)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(NUM_SLOTS) as ex:
        futs = [ex.submit(_stream, handle, p, close_after.get(i),
                          request_id=request_ids[i])
                for i, p in enumerate(prompts)]
        runs = [f.result() for f in futs]
    return runs, time.perf_counter() - t0


def _gaps_at_four(runs):
    """Gaps between tokens (ms) while the first NUM_SLOTS streams, started
    together, all stream: after the last of their first tokens, before
    the first of them ends."""
    first = runs[:NUM_SLOTS]
    lo = max(stamps[0] for _, stamps in first)
    hi = min(stamps[-1] for _, stamps in first)
    return [(b - a) * 1e3 for _, stamps in first
            for a, b in zip(stamps, stamps[1:]) if a >= lo and b <= hi]


def _ttft_rows(prompts, runs, prefill_ms):
    from ray_tpu_torch.serve.llm_engine import bucket_len

    return [{"prompt_len": len(p), "bucket": bucket_len(len(p), MAX_PROMPT),
             "ttft_ms": stamps[0] * 1e3,
             "in_process_prefill_ms": prefill_ms.get(
                 bucket_len(len(p), MAX_PROMPT))}
            for p, (_, stamps) in zip(prompts, runs)]


def _process_row(stats):
    """A replica's process meter, as printed."""
    info = stats["process"]
    return {"pid": info["pid"], "card": info.get("card"),
            "cuda_initialized": info["cuda_initialized"],
            "k1_launches": (info.get("launches") or {}).get("flash_fwd", 0),
            "peak_mem_gib": (info["peak_mem_bytes"] / 2 ** 30
                             if "peak_mem_bytes" in info else None),
            "result_files": info.get("spill_files", 0),
            "result_file_mb": info.get("spill_bytes", 0) / 2 ** 20,
            "result_file_write_s": info.get("spill_s", 0.0)}


def phase_serve_stream(cfg, prompts, witness, tick_s, prefill_ms,
                       eng=None):
    """Llama-3-8B's streaming deployment with continuous batching on one
    replica process (the card's first free one), behind the HTTP proxy
    and, where ``grpc`` imports, the gRPC proxy (both on free ports):
    PROMPT_LENS streamed through the handle four at a time, each stream's
    greedy tokens equal to the in-process engine's (phase_serve_witness,
    the witness); then four more, one closed after SERVE_CLOSE_AFTER tokens,
    whose slot must be free before the engine's next decode step ends. A
    first round, one token a prompt, one prompt at a time, meets each
    prefill shape once (its TTFT is the cold one). Then, on the same
    replica, serve_http, serve_grpc and (given the in-process engine
    ``eng``, for its tick with and without the plane) serve_trace.
    Returns the replica's K1 launches."""
    from ray_tpu_torch import serve

    try:
        import grpc  # noqa: F401 — only whether it imports
        grpc_missing = None
    except ImportError as e:
        grpc_missing = f"import grpc failed on this machine: {e}"
    name = "serve-stream"
    app = serve.build_streaming_llm_deployment(
        cfg, SeededLlama(), name=name, max_prompt_len=MAX_PROMPT,
        max_new_tokens=MAX_NEW, continuous_batching=True,
        num_slots=NUM_SLOTS)
    handle, run_s = _serve_run(app.bind(), _http=True, http_port=0,
                               _grpc=grpc_missing is None, grpc_port=0)
    failures, mismatches = [], []
    try:
        (rep,) = _replicas(name)
        cold = [_stream(handle, p, max_new_tokens=1) for p in prompts]
        runs, wall = _streams_four_at_a_time(handle, prompts)
        for i, ((toks, _), (first, _)) in enumerate(zip(runs, cold)):
            if toks != witness[i] or first != witness[i][:1]:
                mismatches.append(f"stream {i} differs from the in-process "
                                  f"engine's tokens: {toks[:8]} "
                                  f"(first {first}) vs {witness[i][:8]}")
        gaps = _gaps_at_four(runs)
        # Four more: the first closed after SERVE_CLOSE_AFTER tokens while
        # the others decode beside it.
        again = [prompts[0], prompts[1], prompts[2], prompts[5]]
        more, _ = _streams_four_at_a_time(handle, again,
                                          {0: SERVE_CLOSE_AFTER})
        wants = [witness[0][:SERVE_CLOSE_AFTER], witness[1], witness[2],
                 witness[5]]
        for (toks, _), want in zip(more, wants):
            if toks != want:
                mismatches.append(f"second round differs: {toks[:8]} vs "
                                  f"{want[:8]}")
        stats = rep.call("stats")
        cancels = stats["serve"]["cancels"]
        if len(cancels) != 1 or cancels[0]["ticks_until_free"] > 1:
            failures.append(f"the closed stream's slot: {cancels}")
        if stats["serve"]["slots_busy"] != 0:
            failures.append(f"slots busy after every stream ended: "
                            f"{stats['serve']}")
        proc = _process_row(stats)
        prefills = 2 * len(prompts) + len(again)
        if proc["k1_launches"] != cfg.n_layers * prefills:
            failures.append(f"the replica launched K1 {proc['k1_launches']} "
                            f"times for {prefills} prefills of "
                            f"{cfg.n_layers} layers")
        starts = _starts(name)
        failures += mismatches
        tokens = sum(len(t) for t, _ in runs)
        handle_ttft = _ttft_rows(prompts, runs, prefill_ms)
        gap_ms = statistics.median(gaps) if gaps else None
        emit("serve_stream", ok=not failures, failures=failures,
             model="llama3_8b", num_slots=NUM_SLOTS, run_s=run_s,
             replicas=starts, replica=proc,
             streams=len(cold) + len(runs) + len(more),
             tokens_equal_witness=not mismatches, ttft=handle_ttft,
             cold_ttft_ms=[stamps[0] * 1e3 for _, stamps in cold],
             gap_ms_at_4_streams_median=gap_ms,
             gaps_at_4_streams=len(gaps),
             in_process_tick_ms_4_slots=tick_s * 1e3,
             wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
             closed_stream=cancels)
        if failures:
            raise AssertionError("; ".join(failures))
        launches = proc["k1_launches"]
        launches += phase_serve_http(cfg, prompts, witness, rep, tick_s,
                                     handle_ttft, gap_ms)
        launches += phase_serve_grpc(prompts, witness, rep, grpc_missing)
        if eng is not None:
            launches += phase_serve_trace(cfg, prompts, witness, rep,
                                          handle, eng)
    finally:
        serve.delete(name)
    return launches


def phase_serve_batch(cfg, params, device):
    """Llama-3-8B's @batch deployment on one replica process: four
    requests sent at once, prompts of SERVE_BATCH_LENS tokens (every
    batch [4, 2048]); each one's greedy tokens equal to an in-process
    generate_ragged over the same four rows. Twice: the first round pays
    the replica's first use. Returns the replica's K1 launches."""
    import numpy as np
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.models.generate import generate_ragged

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_BATCH_LENS]
    toks = np.zeros((len(prompts), MAX_PROMPT), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = torch.tensor([len(p) for p in prompts], device=device)
    witness_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        witness = generate_ragged(params, torch.from_numpy(toks).to(device),
                                  lengths, cfg, MAX_NEW).cpu().tolist()
        witness_ms.append((time.perf_counter() - t) * 1e3)
    gc_collect()

    name = "serve-batch"
    app = serve.build_llm_deployment(
        cfg, SeededLlama(), name=name, max_batch_size=len(prompts),
        max_prompt_len=MAX_PROMPT, max_new_tokens=MAX_NEW)
    handle, run_s = _serve_run(app.bind())
    failures, mismatches = [], []
    rounds = []
    try:
        (rep,) = _replicas(name)
        for _ in range(2):
            t = time.perf_counter()
            resps = [handle.remote({"tokens": p}) for p in prompts]
            outs = [r.result(timeout=600) for r in resps]
            rounds.append((time.perf_counter() - t) * 1e3)
            for i, out in enumerate(outs):
                if out.get("tokens") != witness[i]:
                    mismatches.append(
                        f"request {i} ({len(prompts[i])} tokens): "
                        f"{str(out)[:120]} vs the witness's "
                        f"{witness[i][:8]}")
        stats = rep.call("stats")
        sizes = stats["serve"]["batch_sizes"]
        proc = _process_row(stats)
        if proc["k1_launches"] != cfg.n_layers * len(sizes):
            failures.append(f"the replica launched K1 {proc['k1_launches']} "
                            f"times for {len(sizes)} batches")
        starts = _starts(name)
    finally:
        serve.delete(name)
    failures += mismatches
    emit("serve_batch", ok=not failures, failures=failures,
         model="llama3_8b", prompt_lens=list(SERVE_BATCH_LENS),
         max_batch_size=len(prompts), run_s=run_s, replicas=starts,
         replica=proc, batch_sizes=sizes,
         tokens_equal_witness=not mismatches, round_ms=rounds,
         in_process_generate_ragged_ms=witness_ms,
         tokens_per_s_warm=len(prompts) * MAX_NEW / (rounds[-1] / 1e3))
    if failures:
        raise AssertionError("; ".join(failures))
    return proc["k1_launches"]


def phase_serve_disagg(cfg, prompts, witness, prefill_ms):
    """The disaggregated plane with two cards or more: the prefill pool
    on the first free card, the decode pool on the next, the ingress on
    the CPU (no CUDA). Each prefill shape once (other prompts, one token
    each), then PROMPT_LENS streamed four at a time, tokens equal to the
    witness's (serve_stream's), their K/V handed off as files; the
    2048-token prompt again, a
    prefix-cache hit. On one card it prints that it did not run. Returns
    the replicas' K1 launches."""
    import numpy as np
    import torch

    from ray_tpu_torch import serve

    cards = torch.cuda.device_count()
    if cards < 2:
        emit("serve_disagg", ran=False,
             reason=f"needs two cards (the prefill pool on one, the decode "
                    f"pool on another, as the JAX package needs two "
                    f"chips); {cards} visible")
        return 0
    name = "serve-disagg"
    app = serve.build_disagg_llm_deployment(
        cfg, SeededLlama(), name=name, num_prefill_replicas=1,
        num_decode_replicas=1, num_slots=NUM_SLOTS,
        max_prompt_len=MAX_PROMPT, max_new_tokens=MAX_NEW,
        prefix_cache_mb=SERVE_PREFIX_MB)
    handle, run_s = _serve_run(app)
    failures, mismatches = [], []
    try:
        (pre,) = _replicas(f"{name}-prefill")
        (dec,) = _replicas(f"{name}-decode")
        (ing,) = _replicas(name)
        # Each prefill shape once first, on other prompts of the same
        # lengths (the measured ones must miss the prefix cache).
        rng = np.random.default_rng(SEED + 2)
        cold = [_stream(handle, rng.integers(0, cfg.vocab_size,
                                             len(p)).tolist(),
                        max_new_tokens=1) for p in prompts]
        h0 = dec.call("stats")["serve"]["handoff"]
        w0 = _process_row(pre.call("stats"))
        runs, wall = _streams_four_at_a_time(handle, prompts)
        w1 = _process_row(pre.call("stats"))
        for i, (toks, _) in enumerate(runs):
            if toks != witness[i]:
                mismatches.append(f"stream {i} ({len(prompts[i])} tokens) "
                                  f"differs from serve_stream's: {toks[:8]} "
                                  f"vs {witness[i][:8]}")
        before = dec.call("stats")["serve"]["prefix"]
        i = PROMPT_LENS.index(MAX_PROMPT)
        repeat, _ = _streams_four_at_a_time(handle, [prompts[i]])
        after = dec.call("stats")["serve"]
        if repeat[0][0] != witness[i]:
            mismatches.append("the repeated prompt's tokens differ")
        hit = {"hits": after["prefix"]["hits"] - before["hits"],
               "misses": after["prefix"]["misses"] - before["misses"]}
        if hit != {"hits": 1, "misses": 0}:
            failures.append(f"the repeated prompt: {hit}")
        rows = {"prefill": _process_row(pre.call("stats")),
                "decode": _process_row(dec.call("stats")),
                "ingress": _process_row(ing.call("stats"))}
        if rows["ingress"]["cuda_initialized"]:
            failures.append("the ingress started CUDA")
        if rows["prefill"]["card"] == rows["decode"]["card"]:
            failures.append(f"prefill and decode share card "
                            f"{rows['prefill']['card']}")
        if rows["prefill"]["k1_launches"] != cfg.n_layers * 2 * len(prompts) \
                or rows["decode"]["k1_launches"] != 0:
            failures.append(f"K1 launches: {rows}")
        handoff = {k: after["handoff"][k] - h0[k] for k in h0}
        starts = {n: _starts(n) for n in (f"{name}-prefill",
                                          f"{name}-decode", name)}
    finally:
        for n in (name, f"{name}-decode", f"{name}-prefill"):
            serve.delete(n)
    failures += mismatches
    tokens = sum(len(t) for t, _ in runs)
    gaps = _gaps_at_four(runs)
    emit("serve_disagg", ran=True, ok=not failures, failures=failures,
         model="llama3_8b", cards=cards, run_s=run_s, replicas=starts,
         processes=rows, tokens_equal_serve_stream=not mismatches,
         ttft=_ttft_rows(prompts, runs, prefill_ms),
         cold_ttft_ms=[stamps[0] * 1e3 for _, stamps in cold],
         repeat_ttft_ms=repeat[0][1][0] * 1e3, prefix_hit=hit,
         prefix_cache=after["prefix"] | {"holders": None, "hot": None},
         handoffs=handoff["n"], handoff_mb=handoff["bytes"] / 2 ** 20,
         handoff_call_s=handoff["call_s"],
         handoff_file_read_s=handoff["read_s"],
         handoff_file_write_s=(w1["result_file_write_s"]
                               - w0["result_file_write_s"]),
         handoff_files_written_mb=(w1["result_file_mb"]
                                   - w0["result_file_mb"]),
         gap_ms_at_4_streams_median=(statistics.median(gaps)
                                     if gaps else None),
         wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall)
    if failures:
        raise AssertionError("; ".join(failures))
    return rows["prefill"]["k1_launches"] + rows["decode"]["k1_launches"]


# ------------------------------------------------- serve ingress phases


def _proxy_port(kind):
    from ray_tpu_torch.serve import api

    return (api._proxy if kind == "http" else api._grpc_proxy).port


def _http_stream(port, prompt, close_after=None, timeout_s=None,
                 request_id=None):
    """One stream through the HTTP proxy, read chunk by chunk (a token a
    line): its tokens and each token's seconds since the request; the
    connection is closed after ``close_after`` tokens. A ``request_id``
    goes as X-Request-Id and must come back on the response."""
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if timeout_s is not None:
        headers["X-Request-Timeout-S"] = str(timeout_s)
    if request_id is not None:
        headers["X-Request-Id"] = request_id
    req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                 data=json.dumps({"tokens": prompt}).encode(),
                                 headers=headers)
    t0 = time.perf_counter()
    toks, stamps = [], []
    with urllib.request.urlopen(req, timeout=600) as resp:
        if request_id is not None \
                and resp.headers["X-Request-Id"] != request_id:
            raise AssertionError(f"X-Request-Id {request_id} came back as "
                                 f"{resp.headers['X-Request-Id']}")
        while True:
            line = resp.readline()
            if not line:
                break
            chunk = json.loads(line)
            if "token" not in chunk:
                raise AssertionError(f"stream answered {chunk}")
            stamps.append(time.perf_counter() - t0)
            toks.append(chunk["token"])
            if close_after is not None and len(toks) == close_after:
                break
    return toks, stamps


def _http_four_at_a_time(port, prompts, close_after=None,
                         request_ids=None):
    from concurrent.futures import ThreadPoolExecutor

    close_after = close_after or {}
    request_ids = request_ids or [None] * len(prompts)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(NUM_SLOTS) as ex:
        futs = [ex.submit(_http_stream, port, p, close_after.get(i),
                          request_id=request_ids[i])
                for i, p in enumerate(prompts)]
        runs = [f.result() for f in futs]
    return runs, time.perf_counter() - t0


def _k1(rep):
    return _process_row(rep.call("stats"))["k1_launches"]


def phase_serve_http(cfg, prompts, witness, rep, tick_s, handle_ttft,
                     handle_gap_ms):
    """serve_stream's replica behind the HTTP proxy (``serve.run(...,
    _http=True, http_port=0)``): PROMPT_LENS streamed four at a time with
    urllib, read chunk by chunk, each stream the witness's tokens; four
    more with one connection closed after SERVE_CLOSE_AFTER tokens, whose
    slot must be free within one decode step of the cancel; a request
    with X-Request-Timeout-S 0.001 answered 504. TTFT and the gap between
    tokens through HTTP beside the handle's and the in-process prefill
    and tick. Returns the replica's K1 launches in this phase."""
    import urllib.error

    port = _proxy_port("http")
    failures, mismatches = [], []
    k0 = _k1(rep)
    cancels0 = len(rep.call("stats")["serve"]["cancels"])
    runs, wall = _http_four_at_a_time(port, prompts)
    for i, (toks, _) in enumerate(runs):
        if toks != witness[i]:
            mismatches.append(f"HTTP stream {i} differs from the witness: "
                              f"{toks[:8]} vs {witness[i][:8]}")
    gaps = _gaps_at_four(runs)
    again = [prompts[0], prompts[1], prompts[2], prompts[5]]
    more, _ = _http_four_at_a_time(port, again, {0: SERVE_CLOSE_AFTER})
    wants = [witness[0][:SERVE_CLOSE_AFTER], witness[1], witness[2],
             witness[5]]
    for (toks, _), want in zip(more, wants):
        if toks != want:
            mismatches.append(f"HTTP second round differs: {toks[:8]} vs "
                              f"{want[:8]}")
    deadline = time.time() + 30
    while True:
        serve_stats = rep.call("stats")["serve"]
        closed = serve_stats["cancels"][cancels0:]
        if (closed and serve_stats["slots_busy"] == 0) \
                or time.time() > deadline:
            break
        time.sleep(0.05)
    if len(closed) != 1 or closed[0]["ticks_until_free"] > 1:
        failures.append(f"the closed connection's slot: {closed}")
    if serve_stats["slots_busy"] != 0:
        failures.append(f"slots busy after every stream ended: "
                        f"{serve_stats}")
    launches = _k1(rep) - k0
    prefills = len(prompts) + len(again)
    if launches != cfg.n_layers * prefills:
        failures.append(f"K1 launched {launches} times for {prefills} "
                        f"prefills")
    t = time.perf_counter()
    try:
        _http_stream(port, prompts[0], timeout_s=0.001)
        code = 200
    except urllib.error.HTTPError as e:
        code = e.code
    deadline_s = time.perf_counter() - t
    if code != 504:
        failures.append(f"an expired deadline answered {code}, not 504")
    # The expired request may have been prefilled before its deadline
    # was seen: its launches count too.
    launches = _k1(rep) - k0
    failures += mismatches
    tokens = sum(len(t) for t, _ in runs)
    emit("serve_http", ok=not failures, failures=failures, model="llama3_8b",
         port=port, streams=len(runs) + len(more),
         tokens_equal_witness=not mismatches,
         ttft=[dict(row, http_ttft_ms=stamps[0] * 1e3)
               for row, (_, stamps) in zip(handle_ttft, runs)],
         gap_ms_at_4_streams_median=(statistics.median(gaps)
                                     if gaps else None),
         handle_gap_ms_at_4_streams_median=handle_gap_ms,
         in_process_tick_ms_4_slots=tick_s * 1e3,
         wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
         closed_connection=closed, deadline_status=code,
         deadline_answer_s=deadline_s, k1_launches=launches)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def phase_serve_grpc(prompts, witness, rep, grpc_missing):
    """One prompt through the gRPC proxy's CallStream on serve_stream's
    replica, the witness's tokens. Where ``grpc`` does not import, one
    line says that it did not run and why. Returns the K1 launches."""
    if grpc_missing is not None:
        emit("serve_grpc", ran=False, reason=grpc_missing)
        return 0
    import grpc

    port = _proxy_port("grpc")
    k0 = _k1(rep)
    i = 1
    t0 = time.perf_counter()
    toks, stamps = [], []
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_stream(
            "/rtpu.serve/CallStream",
            request_serializer=lambda o: json.dumps(o).encode(),
            response_deserializer=lambda b: json.loads(b.decode()))
        for msg in call({"route": "/", "input": {"tokens": prompts[i]},
                         "request_id": "smoke-grpc"}, timeout=600):
            toks.append(msg["item"]["token"])
            stamps.append(time.perf_counter() - t0)
    launches = _k1(rep) - k0
    ok = toks == witness[i]
    emit("serve_grpc", ran=True, ok=ok, model="llama3_8b", port=port,
         prompt_len=len(prompts[i]), tokens_equal_witness=ok,
         ttft_ms=stamps[0] * 1e3,
         gap_ms_median=statistics.median(
             (b - a) * 1e3 for a, b in zip(stamps, stamps[1:])),
         k1_launches=launches)
    if not ok:
        raise AssertionError(f"the gRPC stream differs from the witness: "
                             f"{toks[:8]} vs {witness[i][:8]}")
    return launches


# ------------------------------------------------------ serve trace plane

# The TTFT histogram's bounds (serve/llm_engine.py's rtpu_serve_ttft_s).
TTFT_BOUNDS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
TRACE_TIMEOUT_S = 30.0
TRACE_ATTR_REL, TRACE_ATTR_ABS = 0.15, 0.1


def _scrape(addr):
    """The sink's /metrics as {series line key: value}."""
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _plane_counts(addr, name):
    m = _scrape(addr)
    return {"ttft_count": m.get(f'rtpu_serve_ttft_s_count{{model="{name}"}}',
                                0.0),
            "tokens": m.get(f'rtpu_serve_decode_tokens_total{{model="{name}"}}',
                            0.0),
            "slots_busy": m.get(f'rtpu_serve_slots_busy{{model="{name}"}}'),
            "requests_ok": m.get(f'rtpu_serve_requests_total{{deployment='
                                 f'"{name}",status="ok"}}', 0.0)}


def _settled_counts(addr, name):
    """The plane's counts once two reads 1.2 s apart (past a flush period
    of every process) agree."""
    from ray_tpu_torch.util import metrics

    deadline = time.time() + TRACE_TIMEOUT_S
    prev = None
    while time.time() < deadline:
        metrics.flush_metrics()
        cur = _plane_counts(addr, name)
        if cur == prev:
            return cur
        prev = cur
        time.sleep(1.2)
    raise AssertionError(f"the /metrics counts never settled: {prev}")


def _ledger_row(rid, pred):
    """The request's ledger row with its waterfall, once ``pred`` holds
    (replica spans ship on a 0.5 s cadence)."""
    from ray_tpu_torch.serve import trace
    from ray_tpu_torch.util import state

    deadline = time.time() + TRACE_TIMEOUT_S
    row = None
    while time.time() < deadline:
        trace.flush_serve_trace()
        try:
            row = state.serve_trace(rid)
            if pred(row):
                return row
        except KeyError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"no settled ledger row for {rid}: {row}")


def _row_failures(row, proto, tokens):
    """What a finished stream's row breaks of the plane's contract."""
    out = []
    names = {s["name"] for s in row["spans"]}
    want = {f"serve.{proto}", "serve.assign", "serve.replica",
            "serve.prefill", "serve.engine_attach", "serve.stream"}
    if row["status"] != "ok" or row["proto"] != proto \
            or row.get("tokens") != tokens or not row.get("ttft_s", 0) > 0:
        out.append(f"row {row['request_id']}: status {row['status']}, "
                   f"proto {row['proto']}, tokens {row.get('tokens')}, "
                   f"ttft {row.get('ttft_s')}")
    if {s["trace_id"] for s in row["spans"]} != {row["trace_id"]}:
        out.append(f"row {row['request_id']}: spans of another trace")
    if not want <= names:
        out.append(f"row {row['request_id']}: hops {sorted(names)}, "
                   f"missing {sorted(want - names)}")
    wf = row["waterfall"]
    attributed = sum(w["self_s"] for w in wf)
    if [w["depth"] for w in wf].count(0) != 1 or abs(
            attributed - row["wall_s"]) > (TRACE_ATTR_REL * row["wall_s"]
                                           + TRACE_ATTR_ABS):
        out.append(f"row {row['request_id']}: exclusive times sum to "
                   f"{attributed} s of a {row['wall_s']} s wall")
    return out


def _split(row):
    """One request's dwell by hop (ms): assign, the replica's queue,
    prefill, attach (slot wait and splice), and the root's wall."""
    def dwell(name):
        return sum(w["dwell_s"] for w in row["waterfall"]
                   if w["name"] == name) * 1e3

    replica = [w for w in row["waterfall"] if w["name"] == "serve.replica"]
    return {"request_id": row["request_id"],
            "assign_ms": dwell("serve.assign"),
            "replica_queue_ms": sum(w["attributes"].get("replica_queue_s", 0)
                                    for w in replica) * 1e3,
            "prefill_ms": dwell("serve.prefill"),
            "engine_attach_ms": dwell("serve.engine_attach"),
            "stream_ms": dwell("serve.stream"),
            "wall_ms": row["wall_s"] * 1e3,
            "ttft_ms": (row.get("ttft_s") or 0.0) * 1e3}


def _bucket(v):
    """The TTFT histogram's bucket (lo, hi] that holds ``v``."""
    lo = 0.0
    for b in TTFT_BOUNDS:
        if v <= b:
            return (lo, b)
        lo = b
    return (lo, math.inf)


class _InstrumentClock:
    """Stands in for one of the engine's serve instruments: forwards each
    record to ``inner`` (or drops it where ``inner`` is None) and adds
    the seconds the call took to ``spent[0]``."""

    def __init__(self, inner, spent):
        self.inner, self.spent = inner, spent

    def _record(self, how, *args, **kwargs):
        t = time.perf_counter()
        if self.inner is not None:
            getattr(self.inner, how)(*args, **kwargs)
        self.spent[0] += time.perf_counter() - t

    def observe(self, *args, **kwargs):
        self._record("observe", *args, **kwargs)

    def inc(self, *args, **kwargs):
        self._record("inc", *args, **kwargs)

    def set(self, *args, **kwargs):
        self._record("set", *args, **kwargs)


# The tick's arms: the whole plane (RTPU_SERVE_TRACE=1 and the engine's
# instruments), the instruments alone (the flag off drops the token
# timeline and the ITL observations; the token counter and the slots
# gauge still record), and no plane (the flag off, the instruments
# replaced by ones that drop every record).
TICK_ARMS = (("plane_on", "1", True), ("trace_off", "0", True),
             ("plane_off", "0", False))


def _ticks_by_plane(eng, prompts, rounds=4, per_round=DECODE_TICKS // 2):
    """The in-process engine's decode tick at NUM_SLOTS busy slots (ms)
    in each of TICK_ARMS, the arms interleaved ``rounds`` times in a
    rotating order; and, for each arm, the host microseconds a timed
    tick spent inside the instruments' records."""
    from ray_tpu_torch import flags
    from ray_tpu_torch.serve import llm_engine

    real = llm_engine._serve_metrics()
    out = {arm: [] for arm, _, _ in TICK_ARMS}
    spent = {arm: [0.0] for arm, _, _ in TICK_ARMS}
    try:
        for r in range(rounds):
            k = r % len(TICK_ARMS)
            for arm, flag, instruments in TICK_ARMS[k:] + TICK_ARMS[:k]:
                with flags.scoped({"RTPU_SERVE_TRACE": flag}):
                    held = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
                    eng.tick()  # warm
                    llm_engine._serve_metrics_cache = {
                        name: _InstrumentClock(
                            inst if instruments else None, spent[arm])
                        for name, inst in real.items()}
                    for _ in range(per_round):
                        t = time.perf_counter()
                        if eng.tick() != NUM_SLOTS:
                            raise AssertionError(
                                "a timed decode tick had a slot retire")
                        out[arm].append((time.perf_counter() - t) * 1e3)
                    llm_engine._serve_metrics_cache = real
                    for q in held:
                        eng.abort(q)
    finally:
        llm_engine._serve_metrics_cache = real
    us = {arm: spent[arm][0] * 1e6 / len(out[arm]) for arm in out}
    return out, us


def phase_serve_trace(cfg, prompts, witness, rep, handle, eng):
    """The trace and metrics plane on serve_stream's replica: the
    prompts four at a time through HTTP (an X-Request-Id each), then
    through the handle (``options(request_id=...)``), every stream the
    witness's tokens. Each request's ledger row, spans and waterfall, the
    sink's /metrics counts against the streams, the controller's TTFT
    p99 against the clients', K1's launches; a 1 ms deadline's row; the
    hop split of the 4 streams started together; the in-process tick
    in each of TICK_ARMS; the split of the replica's first request. Returns the replica's K1 launches."""
    import urllib.error

    from ray_tpu_torch.serve import controller
    from ray_tpu_torch.util import state

    name = "serve-stream"
    addr = state.metrics_address()
    port = _proxy_port("http")
    failures = []
    base = _settled_counts(addr, name)
    time.sleep(2.5)  # a TSDB point of the settled state, a second back
    t_mark = time.time()
    k0 = _k1(rep)
    http_ids = [f"smoke-trace-http-{i}" for i in range(len(prompts))]
    py_ids = [f"smoke-trace-handle-{i}" for i in range(len(prompts))]
    t0 = time.perf_counter()
    http_runs, _ = _http_four_at_a_time(port, prompts,
                                        request_ids=http_ids)
    py_runs, _ = _streams_four_at_a_time(handle, prompts,
                                         request_ids=py_ids)
    wall = time.perf_counter() - t0
    for runs, how in ((http_runs, "HTTP"), (py_runs, "handle")):
        for i, (toks, _) in enumerate(runs):
            if toks != witness[i]:
                failures.append(f"{how} stream {i} differs from the witness: "
                                f"{toks[:8]} vs {witness[i][:8]}")
    rows = {}
    for rid, proto, toks in ([(r, "http", len(w)) for r, w in
                              zip(http_ids, witness)]
                             + [(r, "python", len(w)) for r, w in
                                zip(py_ids, witness)]):
        rows[rid] = _ledger_row(rid, lambda r: (
            r["status"] != "inflight" and r.get("tokens") is not None
            and "serve.prefill" in {s["name"] for s in r["spans"]}))
        failures += _row_failures(rows[rid], proto, toks)
    launches = _k1(rep) - k0
    prefills = 2 * len(prompts)
    if launches != cfg.n_layers * prefills:
        failures.append(f"K1 launched {launches} times for {prefills} "
                        f"prefills of {cfg.n_layers} layers")
    want = {"ttft_count": base["ttft_count"] + prefills,
            "tokens": base["tokens"] + sum(len(t) for t, _ in
                                           http_runs + py_runs),
            "slots_busy": 0.0,
            "requests_ok": base["requests_ok"] + prefills}
    deadline = time.time() + TRACE_TIMEOUT_S
    while True:
        got = _settled_counts(addr, name)
        if got == want or time.time() > deadline:
            break
    if got != want:
        failures.append(f"/metrics counts {got}, expected {want}")
    time.sleep(1.2)  # a TSDB point of the final state
    p99 = controller._local._ttft_p99(name, window_s=time.time() - t_mark)
    client = sorted(stamps[0] for _, stamps in http_runs + py_runs)
    client_p99 = client[math.ceil(0.99 * len(client)) - 1]
    if p99 is None or _bucket(p99) != _bucket(client_p99):
        failures.append(f"the controller's TTFT p99 {p99} is not in the "
                        f"bucket {_bucket(client_p99)} of the clients' "
                        f"p99 {client_p99}")
    # The 1 ms deadline last: its request may reach the engine (a
    # prefill, a TTFT) before the deadline is seen.
    try:
        _http_stream(port, prompts[0], timeout_s=0.001,
                     request_id="smoke-trace-deadline")
        code = 200
    except urllib.error.HTTPError as e:
        code = e.code
    deadline_row = _ledger_row("smoke-trace-deadline",
                               lambda r: r["status"] != "inflight")
    if code != 504 or deadline_row["status"] != "deadline" \
            or not deadline_row["retained"]:
        failures.append(f"the 1 ms deadline: HTTP {code}, row "
                        f"{deadline_row['status']}, kept "
                        f"{deadline_row['retained']}")
    launches = _k1(rep) - k0
    # The replica's first request (serve_stream's cold round): its row
    # is the deployment's oldest through the handle.
    first = state.list_serve_requests(model=name, limit=100000)[-1]
    cold = _split(state.serve_trace(first["request_id"]))
    ticks, instrument_us = _ticks_by_plane(eng, prompts)
    emit("serve_trace", ok=not failures, failures=failures,
         model="llama3_8b", requests=len(rows), wall_s=wall,
         k1_launches=launches,
         split_http_4_started_together=[
             _split(rows[r]) for r in http_ids[:NUM_SLOTS]],
         split_handle_4_started_together=[
             _split(rows[r]) for r in py_ids[:NUM_SLOTS]],
         split_later=[_split(rows[r]) for r in
                      http_ids[NUM_SLOTS:] + py_ids[NUM_SLOTS:]],
         split_replica_first_request=cold,
         metrics_before=base, metrics_after=got,
         ttft_p99_controller_s=p99, ttft_p99_clients_s=client_p99,
         ttft_p99_bucket=_bucket(client_p99),
         deadline_status=code, deadline_row=deadline_row["status"],
         tick_ms_4_slots=ticks,
         tick_ms_4_slots_median={arm: statistics.median(v)
                                 for arm, v in ticks.items()},
         tick_instrument_us_4_slots=instrument_us)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# -------------------------------------------- serve multiplex, autoscale

# serve_multiplex: a replica keeps MUX_MODELS Llama-3-8B models; a call
# generates MUX_NEW tokens greedily after MUX_PROMPT_LEN prompt tokens.
MUX_MODELS, MUX_NEW, MUX_PROMPT_LEN = 2, 32, 128
MUX_IDS = ("seed-0", "seed-1", "seed-0", "seed-2")  # A (SEED), B, A, C
# serve_autoscale: the pool's policy and the streams started at once.
AUTOSCALE_POLICY = {"min_replicas": 1, "max_replicas": 2,
                    "queue_depth_high": 2, "occupancy_high": 0.95,
                    "up_for_s": 2, "down_for_s": 5, "cooldown_s": 0}
AUTOSCALE_STREAMS = 8


def mux_generate(params, prompt, max_new_tokens):
    """The multiplexed deployment's work: serve_cfg()'s greedy
    ``generate`` of one prompt, on the params' card."""
    import torch

    from ray_tpu_torch.models.generate import generate

    dev = params["embed"].device
    out = generate(params, torch.tensor([prompt], device=dev),
                   serve_cfg(), max_new_tokens)
    return out[0, len(prompt):].tolist()


class MuxLlama:
    """The serve_multiplex replica: ``@serve.multiplexed`` (its function
    form, over this instance's loader) keeps MUX_MODELS models; model id
    "seed-N" is Llama-3-8B in bf16 from seed N on the replica's card."""

    def __init__(self):
        from ray_tpu_torch import serve

        self.loads = []
        self.get_model = serve.multiplexed(
            max_num_models_per_replica=MUX_MODELS)(self._load)

    def _load(self, model_id):
        import torch

        t = time.perf_counter()
        params = SeededLlama(int(model_id.split("-")[1]))()
        torch.cuda.synchronize()
        self.loads.append({"model": model_id,
                           "s": time.perf_counter() - t})
        return params

    def __call__(self, prompt):
        from ray_tpu_torch import serve

        params = self.get_model(serve.get_multiplexed_model_id())
        return {"tokens": mux_generate(params, prompt, MUX_NEW),
                "loads": [row["model"] for row in self.loads]}

    def memory(self):
        import gc

        import torch

        gc.collect()
        return {"allocated": torch.cuda.memory_allocated(),
                "peak": torch.cuda.max_memory_allocated(),
                "loads": list(self.loads)}


def phase_serve_multiplex(cfg, params):
    """One deployment (a card) whose multiplexed loader keeps MUX_MODELS
    Llama-3-8B models: ids A (the witness's seed), B, A, C. A's tokens
    equal mux_generate on the in-process params; four calls make three
    loads (the second A is not reloaded); after C loads, B is evicted and
    the replica's allocated memory is at most two models plus 2 GiB.
    Returns the replica's K1 launches."""
    import numpy as np

    from ray_tpu_torch import serve

    prompt = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, MUX_PROMPT_LEN).tolist()
    t = time.perf_counter()
    witness = mux_generate(params, prompt, MUX_NEW)
    witness_s = time.perf_counter() - t
    model_bytes = sum(
        v.numel() * v.element_size()
        for leaf in params.values()
        for v in (leaf.values() if isinstance(leaf, dict) else [leaf]))
    name = "serve-multiplex"
    dep = serve.deployment(name=name,
                           ray_actor_options={"num_gpus": 1})(MuxLlama)
    handle, run_s = _serve_run(dep.bind())
    failures = []
    try:
        (rep,) = _replicas(name)
        calls, a_equal = [], None
        for mid in MUX_IDS:
            t = time.perf_counter()
            out = handle.options(multiplexed_model_id=mid).remote(
                prompt).result(timeout=600)
            calls.append({"model": mid, "s": time.perf_counter() - t,
                          "loads": out["loads"]})
            if mid == MUX_IDS[0]:
                a_equal = out["tokens"] == witness
                if not a_equal:
                    failures.append(f"{mid}'s tokens differ from the "
                                    f"in-process run: {out['tokens'][:8]} "
                                    f"vs {witness[:8]}")
        mem = rep.handle_request("memory")
        loads = [row["model"] for row in mem["loads"]]
        if loads != [MUX_IDS[0], MUX_IDS[1], MUX_IDS[3]]:
            failures.append(f"loads {loads} for calls {list(MUX_IDS)}")
        bound = MUX_MODELS * model_bytes + 2 * 2 ** 30
        if mem["allocated"] > bound:
            failures.append(f"{mem['allocated']} bytes allocated after the "
                            f"eviction, above {bound}")
        proc = _process_row(rep.call("stats"))
        if proc["k1_launches"] != cfg.n_layers * len(MUX_IDS):
            failures.append(f"K1 launched {proc['k1_launches']} times for "
                            f"{len(MUX_IDS)} prefills")
    finally:
        serve.delete(name)
    emit("serve_multiplex", ok=not failures, failures=failures,
         model="llama3_8b", models_a_replica=MUX_MODELS,
         prompt_len=MUX_PROMPT_LEN, max_new_tokens=MUX_NEW, run_s=run_s,
         calls=calls, loads=mem["loads"],
         a_tokens_equal_in_process=a_equal,
         in_process_s=witness_s, model_gib=model_bytes / 2 ** 30,
         allocated_gib_after_eviction=mem["allocated"] / 2 ** 30,
         bound_gib=bound / 2 ** 30, peak_gib=mem["peak"] / 2 ** 30,
         replica=proc)
    if failures:
        raise AssertionError("; ".join(failures))
    return proc["k1_launches"]


def _autoscale_round(handle, prompts, witness, n, stats, watch=None):
    """``n`` greedy streams of the witness's prompts started at once; while
    they run, ``watch(stats())`` every 0.1 s. Returns the streams'
    (tokens, want) pairs; a stream that raised has its error in place of
    its tokens, so every failure of the round is reported."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(_stream, handle, prompts[i % len(prompts)])
                for i in range(n)]
        while watch is not None and not all(f.done() for f in futs):
            watch(stats())
            time.sleep(0.1)
        out = []
        for i, f in enumerate(futs):
            try:
                toks = f.result()[0]
            except Exception as e:  # noqa: BLE001 — reported as a failure
                toks = f"{type(e).__name__}: {str(e)[:400]}"
            out.append((toks, witness[i % len(prompts)]))
        return out


def _errors(streams):
    """The distinct errors of the streams that raised (at most 4)."""
    return sorted({toks for toks, _ in streams if isinstance(toks, str)})[:4]


def phase_serve_autoscale(cfg, prompts, witness):
    """The streaming deployment (continuous batching, NUM_SLOTS slots)
    under AUTOSCALE_POLICY: rounds of AUTOSCALE_STREAMS streams started
    at once until the target reaches 2. On one card the second replica
    stays pending (no spawn tried, no error) and idle brings the target
    back to 1 with nothing pending; with two cards or more the rounds go
    on until the second replica, spawned on card 1, is ready and streams
    land on both, then idle (two streams at a time) drains the pool back
    to one replica while streams keep running, none of them cut. Every
    stream's tokens are the witness's. Returns the replicas' K1
    launches."""
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import controller
    from ray_tpu_torch.serve.handle import Router

    cards = torch.cuda.device_count()
    name = "serve-autoscale"
    app = serve.build_streaming_llm_deployment(
        cfg, SeededLlama(), name=name, max_prompt_len=MAX_PROMPT,
        max_new_tokens=MAX_NEW, continuous_batching=True,
        num_slots=NUM_SLOTS).options(scaling_policy=AUTOSCALE_POLICY)
    handle, run_s = _serve_run(app.bind())
    ctrl = controller._local

    def stats():
        return ctrl.get_serve_stats()[name]

    def wait(cond, timeout_s):
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            st = stats()
            if cond(st):
                return st
            time.sleep(0.1)
        raise AssertionError(f"{name}: timed out; {stats()}")

    failures, streams, seen = [], [], {"pending": 0}
    times = {}
    per_replica = {}
    t0 = time.perf_counter()

    def watch(st):
        seen["pending"] = max(seen["pending"], st["pending"])
        if st["target"] >= 2 and "target_2_s" not in times:
            times["target_2_s"] = time.perf_counter() - t0
            seen["at_target_2"] = dict(st)
        if st["ready"] >= 2 and "second_ready_s" not in times:
            times["second_ready_s"] = time.perf_counter() - t0

    try:
        while "target_2_s" not in times and time.perf_counter() - t0 < 90:
            streams += _autoscale_round(handle, prompts, witness,
                                        AUTOSCALE_STREAMS, stats, watch)
        if "target_2_s" not in times:
            raise AssertionError(f"the target never reached 2: {stats()}; "
                                 f"stream errors: {_errors(streams)}")
        if cards < 2:
            st = stats()
            if not (st["pending"] == 1 and st["replicas"] == 1
                    and st["spawned"] == 1):
                failures.append(f"one card: not one replica and one "
                                f"pending: {st}")
            st = wait(lambda s: s["target"] == 1, 60)
            times["idle_target_1_s"] = time.perf_counter() - t0
            if st["pending"] != 0 or st["spawned"] != 1:
                failures.append(f"idle on one card: {st}")
        else:
            # The pressure stays on until the second replica is ready, and
            # until streams land on both (the handle's router reads the
            # new replica set at its next refresh).
            while "second_ready_s" not in times:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"no second replica: {stats()}; "
                                         f"stream errors: {_errors(streams)}")
                streams += _autoscale_round(handle, prompts, witness,
                                            AUTOSCALE_STREAMS, stats, watch)
            reps = _replicas(name)
            before = {r.replica_id: r.call("stats")["total"] for r in reps}
            t_both = time.perf_counter()
            while not per_replica or min(per_replica.values()) == 0:
                if time.perf_counter() - t_both > 4 * Router.REFRESH_PERIOD_S:
                    break
                streams += _autoscale_round(handle, prompts, witness,
                                            AUTOSCALE_STREAMS, stats)
                per_replica = {r.replica_id: r.call("stats")["total"]
                               - before[r.replica_id] for r in reps}
            if sorted(r.card for r in reps) != [0, 1]:
                failures.append(f"replicas on cards "
                                f"{[r.card for r in reps]}")
            if min(per_replica.values()) == 0:
                failures.append(f"streams a replica: {per_replica}")
            # Idle (2 streams on 8 slots) while streams keep running: the
            # drain must let every one of them finish.
            t_drain = time.perf_counter()
            while stats()["replicas"] != 1 or stats()["draining"] != 0:
                if time.perf_counter() - t_drain > 120:
                    raise AssertionError(f"never drained: {stats()}; "
                                         f"stream errors: {_errors(streams)}")
                streams += _autoscale_round(handle, prompts, witness, 2,
                                            stats)
            times["drained_s"] = time.perf_counter() - t0
        last_error = ctrl.get_last_error(name)
        if last_error is not None:
            failures.append(f"a replica error was recorded: {last_error}")
        launches = sum(_k1(r) for r in _replicas(name))
        retired = ctrl.get_retired(name)
        launches += sum((r["stats"].get("process", {}).get("launches") or {})
                        .get("flash_fwd", 0) for r in retired)
        starts = _starts(name)
    finally:
        serve.delete(name)
    cut = [i for i, (toks, want) in enumerate(streams) if toks != want]
    if cut:
        failures.append(f"{len(cut)} of {len(streams)} streams differ from "
                        f"the witness (first {cut[:4]}); errors: "
                        f"{_errors(streams)}")
    if launches != cfg.n_layers * len(streams):
        failures.append(f"K1 launched {launches} times for {len(streams)} "
                        f"streams")
    emit("serve_autoscale", ok=not failures, failures=failures,
         model="llama3_8b", cards=cards, policy=AUTOSCALE_POLICY,
         run_s=run_s, streams=len(streams),
         tokens_equal_witness=not cut, seconds=times,
         at_target_2=seen.get("at_target_2"), max_pending=seen["pending"],
         streams_a_replica=per_replica, replicas=starts,
         retired=[{k: r[k] for k in ("replica_id", "card", "drain_s")}
                  for r in retired],
         k1_launches=launches)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# ------------------------------------------------------------- mpmd_pipe

# The MPMD pipeline on the card: serve_cfg()'s Llama-3-8B (SERVE_LAYERS
# layers) as MPMD_STAGES stage processes, MPMD_MICRO microbatches of
# (MPMD_BATCH, MPMD_SEQ) tokens, MPMD_IN_FLIGHT in flight.
MPMD_STAGES, MPMD_MICRO, MPMD_IN_FLIGHT = 4, 16, 4
MPMD_BATCH, MPMD_SEQ = 2, 512


class SeededParams:
    """A params factory run in a stage process: ``cfg``'s model from
    ``seed`` on the process's card (the same seed on a card of the same
    kind gives the same weights; ``SeededLlama`` at another depth)."""

    def __init__(self, cfg, seed=SEED):
        self.cfg = cfg
        self.seed = seed

    def __call__(self):
        import torch

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.models.transformer import init_params

        dev = resolve_device(None)
        return init_params(self.cfg,
                           torch.Generator(device=dev).manual_seed(self.seed),
                           dev)


class WarmStage:
    """A stage factory (``TransformerStage``'s) whose step, once built in
    its stage process, runs one microbatch of the run's shape (the step's
    cold first run: CUDA's lazy module loads, cuBLAS's start; the stages
    warm at once, not one after another in the pipeline's fill), keeps
    its seconds, and sets the process's kernel launch counts to 0, so
    they count the run alone."""

    def __init__(self, inner, batch, seq):
        self.inner, self.batch, self.seq = inner, batch, seq

    def __call__(self, idx, n, mesh):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        step = self.inner(idx, n, mesh)
        if idx == 0:
            x = torch.zeros(self.batch, self.seq, dtype=torch.long)
        else:
            x = torch.zeros(self.batch, self.seq, step.cfg.d_model,
                            dtype=step.cfg.dtype, device=step.device)
        t0 = time.perf_counter()
        step(x)
        cold_s = time.perf_counter() - t0
        _zero_launch_counts(fa)
        return WarmStep(step, cold_s)


class WarmStep:
    """A built stage step and its cold first run's seconds."""

    def __init__(self, step, cold_s):
        self.step, self.cold_s = step, cold_s

    def __call__(self, x):
        return self.step(x)

    def cold_step_s(self):
        return self.cold_s

    def kernel_launches(self):
        return self.step.kernel_launches()

    def memory(self):
        return self.step.memory()


def mpmd_tokens(cfg, n):
    """``n`` microbatches of (MPMD_BATCH, MPMD_SEQ) tokens from
    ``default_rng(SEED)``."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, (MPMD_BATCH, MPMD_SEQ))
            for _ in range(n)]


def mpmd_run(cfg, witness_params, n_stages, n_micro, num_gpus, in_flight):
    """``cfg`` as ``n_stages`` stage processes (``MPMDPipeline`` of
    ``TransformerStage``: stage 0 embeds, the last applies the final norm
    and the head and returns the last position's f32 logits and the greedy
    token at every position), each building ``SeededParams(cfg)`` on its
    card and keeping its layers (``num_gpus`` 0: all on card 0, built one
    after another; 1: a card each), fed ``n_micro`` microbatches. The
    witness: the same stage functions in order in this process on
    ``witness_params`` (card 0), each microbatch timed (the first is
    cold). Each stage runs one warm-up microbatch when it is built
    (``WarmStage``: its cold first step, timed), and its launch counts
    start at 0 after it. The stages' ms a microbatch and busy fractions
    are the steady
    part of the run's (``MPMDPipeline.run``), the gaps without the fill,
    ``first_result_s`` the fill. Returns the measurements and the
    failures (the logits bit for bit the witness's, the tokens equal, 2 K1
    launches a stage a microbatch counted in the stage processes, the
    steady gaps, no stage process or channel segment left)."""
    import glob
    import multiprocessing
    import os

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.object_store import CHANNEL_PREFIX
    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.parallel.mpmd import TransformerStage, TransformerStep

    toks = mpmd_tokens(cfg, n_micro)
    here = os.path.dirname(os.path.abspath(__file__))
    lock = None
    if not num_gpus:
        lock = os.path.join(here, "ray_tpu_torch", "_build", "mpmd.lock")
        os.makedirs(os.path.dirname(lock), exist_ok=True)
    factory = WarmStage(TransformerStage(cfg, SeededParams(cfg),
                                         head="last", build_lock=lock),
                        MPMD_BATCH, MPMD_SEQ)
    failures = []
    rt.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        p = MPMDPipeline([factory] * n_stages, max_in_flight=in_flight,
                         stage_options=[{"num_gpus": num_gpus}] * n_stages)
        ready_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = p.run(toks, timeout=600)
        run_s = time.perf_counter() - t0
        first_result_s = p.last_first_result_s
        gaps = p.gap_stats()
        meter = p.meter_stats()
        p.teardown(kill_actors=False)
        launches = [c["flash_fwd"] for c in p.call_stages("kernel_launches")]
        memory = p.call_stages("memory")
        cold = p.call_stages("cold_step_s")
        pids = [s["pid"] for s in p.describe()]
        dag_id = p._compiled.dag_id
        mode = p.mode
        stages = p.describe()
        p.teardown()
    finally:
        rt.shutdown()
    left = [pid for pid in pids if _alive(pid)]
    segs = glob.glob(f"/dev/shm/{CHANNEL_PREFIX}{dag_id[:12]}*")
    children = [c.name for c in multiprocessing.active_children()]
    steps = [TransformerStep(cfg, witness_params, k, n_stages, head="last")
             for k in range(n_stages)]
    torch.cuda.synchronize()
    witness, witness_ms = [], []
    for t in toks:
        t0 = time.perf_counter()
        x = t
        for step in steps:
            x = step(x)  # each step ends in a synchronize
        witness_ms.append((time.perf_counter() - t0) * 1e3)
        witness.append(x)
    if mode != "channels":
        failures.append(f"mode {mode}, not channels")
    for i, ((last, tok), (w_last, w_tok)) in enumerate(zip(outs, witness)):
        if last.dtype != torch.float32 or last.shape != (
                MPMD_BATCH, cfg.vocab_size):
            failures.append(f"microbatch {i}: logits {last.dtype} "
                            f"{tuple(last.shape)}")
        elif not torch.equal(last, w_last.to(last.device)):
            failures.append(
                f"microbatch {i}: last-position logits differ from the "
                f"witness's (max abs "
                f"{(last - w_last.to(last.device)).abs().max().item()})")
        if not torch.equal(tok, w_tok.to(tok.device)):
            failures.append(f"microbatch {i}: argmax tokens differ from "
                            "the witness's")
    want = n_micro * (cfg.n_layers // n_stages)  # one K1 a layer
    if launches != [want] * n_stages:
        failures.append(f"K1 launches by stage {launches}, want {want} "
                        f"each")
    if gaps.get("n") != n_micro - 1 - (n_stages - 1):
        failures.append(f"gap_stats n {gaps.get('n')}, want "
                        f"{n_micro - 1 - (n_stages - 1)}")
    if left or segs or children:
        failures.append(f"left behind: stage pids {left}, segments {segs}, "
                        f"children {children}")
    stage_ms = meter.get("stage_ms", {})
    edge = meter.get("edge_stats", {})
    hop_bytes = {e: v["bytes"] / v["items"] for e, v in edge.items()
                 if v.get("items")}
    compute = [stage_ms.get(f"s{k}", {}).get("compute") for k in
               range(n_stages)]
    return {
        "failures": failures, "mode": mode, "stages": n_stages,
        "layers_a_stage": cfg.n_layers // n_stages, "microbatches": n_micro,
        "microbatch": [MPMD_BATCH, MPMD_SEQ], "in_flight": in_flight,
        "num_gpus_a_stage": num_gpus, "ready_s": ready_s, "run_s": run_s,
        "spawn_to_ready_s": [s["spawn_s"] for s in stages],
        "cold_step_s_by_stage": cold,
        "gap_n": gaps.get("n"), "gap_mean_ms": gaps.get("mean_us", 0) / 1e3,
        "gap_p50_ms": gaps.get("p50_us", 0) / 1e3,
        "gap_max_ms": gaps.get("max_us", 0) / 1e3,
        "stage_ms": stage_ms, "stage_busy": meter.get("stage_busy"),
        "bottleneck": meter.get("bottleneck"),
        "slowest_stage_compute_ms": max(c or 0 for c in compute),
        # A stage's own work a microbatch: compute + send (recv is waiting).
        "slowest_stage_work_ms": max(
            (ms["compute"] + ms["send"] for ms in stage_ms.values()),
            default=0),
        "sum_stage_work_ms": sum(ms["compute"] + ms["send"]
                                 for ms in stage_ms.values()),
        "hop_bytes": hop_bytes,
        "hop_ms_host_copies": {s: {"decode": ms["decode"],
                                   "encode": ms["encode"]}
                               for s, ms in stage_ms.items()},
        "k1_launches_by_stage": launches,
        "peak_gib_by_stage": [None if m["peak_bytes"] is None
                              else m["peak_bytes"] / 2 ** 30
                              for m in memory],
        "cards_by_stage": [m["device"] for m in memory],
        "first_result_s": first_result_s,
        "witness_first_ms": witness_ms[0],
        "witness_median_ms": statistics.median(witness_ms[1:] or witness_ms),
        "logits_equal_witness": not any("logits" in f for f in failures),
        "tokens_equal_witness": not any("tokens" in f for f in failures),
    }


def phase_mpmd_pipe(cfg, params):
    """serve_cfg()'s Llama-3-8B (SERVE_LAYERS layers, bf16) as an MPMD
    pipeline of MPMD_STAGES stage processes on card 0 (``num_gpus=0``,
    two layers each, built one after another), held to the same stage
    functions run in order in this process on phase_serve_witness's
    params (``mpmd_run``). Returns the stages' K1 launches."""
    out = mpmd_run(cfg, params, MPMD_STAGES, MPMD_MICRO, 0, MPMD_IN_FLIGHT)
    failures = out.pop("failures")
    emit("mpmd_pipe", ok=not failures, failures=failures,
         model="llama3_8b", n_layers=cfg.n_layers, **out)
    if failures:
        raise AssertionError("; ".join(failures))
    return sum(out["k1_launches_by_stage"])


# ------------------------------------------------------------ workflow_llm

WF_ACTOR = "workflow-llm"  # the workflow's actor, by name in its driver
WF_ID = "workflow-llm"
WF_KILL_AFTER = 3  # checkpointed generate steps before the driver's kill
WF_QUEUE_MAX = 4
WF_QUEUE_SLEEP_S = 0.5

# The child driver of workflow_llm's first arm: a new process that imports
# this file by its module name (so the stored DAG names chip_smoke.X, not
# __main__.X), starts a core and runs the workflow, until it is killed.
_WF_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import chip_smoke

if __name__ == "__main__":
    sys.exit(chip_smoke.workflow_child({store!r}, {prompts!r}, {marker!r},
                                       {gpus!r}))
"""


class LlamaWorker:
    """workflow_llm's actor (one card, ``num_gpus=1``): serve_cfg()'s
    Llama-3-8B from SeededLlama on its card behind a
    ContinuousBatchingEngine of the witness's NUM_SLOTS, MAX_PROMPT,
    MAX_NEW and SEED, ticking on a thread of its own."""

    def __init__(self, marker=None):
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

        self.marker = marker
        dev = resolve_device(None)
        self.eng = ContinuousBatchingEngine(
            serve_cfg(), SeededLlama()(), num_slots=NUM_SLOTS,
            max_prompt_len=MAX_PROMPT, max_new_tokens=MAX_NEW, seed=SEED,
            model="llama3_8b", device=dev)
        self.stop = threading.Event()
        threading.Thread(target=self.eng.run_forever, args=(self.stop,),
                         daemon=True).start()
        self.generate_ms = []
        self.blocked_puts = 0

    def generate(self, i, prompt):
        """Append ``(i, pid)`` to the marker file, then the prompt's greedy
        tokens."""
        import os

        if self.marker is not None:
            with open(self.marker, "a") as f:
                f.write(f"{i} {os.getpid()}\n")
        t0 = time.perf_counter()
        out = self.eng.result(self.eng.submit(prompt, timeout=600),
                              timeout=600)
        self.generate_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def stream(self, prompt, q):
        """Put each token into the queue ``q`` as the engine makes it,
        counting the puts that found ``q`` full; the count of tokens."""
        from ray_tpu_torch.util.queue import Full

        req = self.eng.submit(prompt, timeout=600)
        sent = 0
        while True:
            done = self.eng.is_done(req)
            toks = self.eng.peek(req)
            for tok in toks[sent:]:
                try:
                    q.put_nowait(tok)
                except Full:
                    self.blocked_puts += 1
                    q.put(tok, timeout=120)
                sent += 1
            if done and sent == len(toks):
                self.eng.pop_result(req)
                return sent
            time.sleep(0.001)

    def launches(self):
        from ray_tpu_torch.ops import flash_attention as fa

        return _launch_counts(fa)["flash_fwd"]

    def stats(self):
        import os

        return {"pid": os.getpid(), "generate_ms": list(self.generate_ms),
                "blocked_puts": self.blocked_puts}


def collect_tokens(*outs):
    """workflow_llm's last step, a CPU task: the generate steps' tokens."""
    return list(outs)


def workflow_dag(prompts, marker):
    """collect_tokens over a generate step a prompt, on one LlamaWorker
    (named WF_ACTOR in its driver's core), by chip_smoke's module names."""
    import chip_smoke as cs
    import ray_tpu_torch as rt

    w = rt.remote(cs.LlamaWorker).options(num_gpus=1, name=WF_ACTOR).bind(
        marker)
    return rt.remote(cs.collect_tokens).bind(
        *[w.generate.bind(i, p) for i, p in enumerate(prompts)])


def workflow_child(store, prompts_path, marker, gpus):
    """The child driver: a core of ``gpus`` cards (told, so that this
    process never imports torch), the workflow, run to its end (or until
    workflow_llm kills this process)."""
    keep_bytecode()
    import ray_tpu_torch as rt

    with open(prompts_path) as f:
        prompts = json.load(f)
    rt.init(num_cpus=2, num_gpus=gpus)
    try:
        rt.workflow.run(workflow_dag(prompts, marker), workflow_id=WF_ID,
                        storage=store)
    finally:
        rt.shutdown()
    return 0


def _wf_steps(store, prefix="generate."):
    """The ids of the SUCCESSFUL steps of workflow_llm's run."""
    import os

    d = os.path.join(store, WF_ID, "steps")
    done = set()
    for name in os.listdir(d) if os.path.isdir(d) else ():
        if name.startswith(prefix) and name.endswith(".json"):
            try:
                with open(os.path.join(d, name)) as f:
                    if json.load(f)["state"] == "SUCCESSFUL":
                        done.add(name[:-5])
            except (OSError, ValueError):
                pass  # a write in flight
    return done


def _marker_runs(marker):
    """{step index: [pid, ...]} from the marker file."""
    runs = {}
    with open(marker) as f:
        for line in f.read().splitlines():
            i, pid = line.split()
            runs.setdefault(int(i), []).append(int(pid))
    return runs


def _engine_generate_ms(eng, prompt):
    """One prompt alone through the in-process engine (its ticker on a
    thread for the call), ms."""
    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    ticker.start()
    try:
        t0 = time.perf_counter()
        eng.result(eng.submit(prompt, timeout=600), timeout=600)
        return (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        ticker.join(timeout=60)


def phase_workflow_llm(cfg, prompts, witness, tick_s, eng):
    """serve_cfg()'s Llama-3-8B through the workflow layer and the util
    shims on the card (LlamaWorker actors, one card each):

    1. ``wf_resume``: a child driver (a new process) runs a workflow of a
       generate step a prompt on one LlamaWorker and collect_tokens, and
       is SIGKILLed once WF_KILL_AFTER generate steps are checkpointed;
       held: its actor gone within 10 s, RESUMABLE within LIVENESS_S + 5
       s, ``workflow.resume`` here returning the witness's tokens, each
       step checkpointed before the kill run once (the marker file) and
       every other at most twice, SUCCESSFUL after, the resumed actor's K1
       launches 8 a generate it ran;
    2. ``pool_map``: ActorPool over a LlamaWorker a card: map equal to the
       witness's tokens in order, map_unordered the same set, 8 K1
       launches a prompt;
    3. ``queue_stream``: a Queue(maxsize=WF_QUEUE_MAX) sent into the pool's
       actor, which puts the 2048-token prompt's tokens as they come while
       this process sleeps WF_QUEUE_SLEEP_S and then takes them: the
       witness's row in order, 64 from the call, the producer found the
       queue full at least once.

    Then no actor or task process, no core directory and no workflow
    directory left. Returns the K1 launches counted in the actors."""
    import glob
    import os
    import shutil
    import signal
    import tempfile

    import torch

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.util import ActorPool, Queue
    from ray_tpu_torch.workflow.storage import WorkflowStorage

    failures = []
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    td = tempfile.mkdtemp(prefix="wf-llm-")
    store, marker = os.path.join(td, "store"), os.path.join(td, "marker")
    child_tmp = os.path.join(td, "tmp")  # the killed driver's core dir
    os.makedirs(child_tmp)
    prompts_path = os.path.join(td, "prompts.json")
    with open(prompts_path, "w") as f:
        json.dump(prompts, f)
    cores_before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                              "rtpt-core-*")))
    out = {"n_prompts": len(prompts), "new_tokens": MAX_NEW}
    pids = []
    # Arm 1: the child driver, killed after WF_KILL_AFTER checkpoints.
    t0 = time.perf_counter()
    script = os.path.join(td, "child.py")
    with open(script, "w") as f:
        f.write(_WF_CHILD.format(root=here, store=store,
                                 prompts=prompts_path, marker=marker,
                                 gpus=torch.cuda.device_count()))
    log = open(os.path.join(td, "child.log"), "w")
    child = subprocess.Popen([sys.executable, script], cwd=here,
                             stdout=log, stderr=subprocess.STDOUT,
                             env={**os.environ, "TMPDIR": child_tmp})
    first_ckpt_s = None
    try:
        deadline = time.monotonic() + 300
        while True:
            done = _wf_steps(store)
            if done and first_ckpt_s is None:
                first_ckpt_s = time.perf_counter() - t0
            if len(done) >= WF_KILL_AFTER:
                break
            if child.poll() is not None or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        t_kill = time.perf_counter()
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        log.close()
    killed_with = sorted(_wf_steps(store))
    if len(killed_with) < WF_KILL_AFTER or len(killed_with) >= len(prompts):
        with open(os.path.join(td, "child.log")) as f:
            tail = f.read()[-2000:]
        failures.append(f"wf_resume: the kill found {killed_with} "
                        f"checkpointed (exit {child.returncode}): {tail}")
    runs = _marker_runs(marker) if os.path.exists(marker) else {}
    child_pids = sorted({p for ps in runs.values() for p in ps})
    left = _pids_left(child_pids, within_s=10.0)
    if left:
        failures.append(f"wf_resume: the child's actor {left} outlived it")
    rt.init(num_cpus=4)
    try:
        limit = WorkflowStorage.LIVENESS_S + 5.0
        deadline = time.monotonic() + limit
        status = workflow.get_status(WF_ID, storage=store)
        while status != "RESUMABLE" and time.monotonic() < deadline:
            time.sleep(0.1)
            status = workflow.get_status(WF_ID, storage=store)
        kill_to_resumable_s = time.perf_counter() - t_kill
        if status != "RESUMABLE":
            failures.append(f"wf_resume: status {status} {limit} s after "
                            "the kill, not RESUMABLE")
        t1 = time.perf_counter()
        resumed = workflow.resume(WF_ID, storage=store)
        resume_s = time.perf_counter() - t1
        if resumed != witness:
            failures.append("wf_resume: the resumed tokens differ from the "
                            "witness's")
        status = workflow.get_status(WF_ID, storage=store)
        if status != "SUCCESSFUL":
            failures.append(f"wf_resume: status {status} after resume")
        runs = _marker_runs(marker)
        for i in range(len(prompts)):
            n = len(runs.get(i, []))
            if f"generate.{i}" in killed_with and n != 1:
                failures.append(f"wf_resume: checkpointed step {i} ran "
                                f"{n} times")
            elif not 1 <= n <= 2:
                failures.append(f"wf_resume: step {i} ran {n} times")
        w = rt.get_actor(WF_ACTOR)
        wstats = rt.get(w.stats.remote(), timeout=60)
        pids.append(wstats["pid"])
        ran_here = sum(pid == wstats["pid"] for ps in runs.values()
                       for pid in ps)
        resumed_launches = rt.get(w.launches.remote(), timeout=60)
        if resumed_launches != cfg.n_layers * ran_here:
            failures.append(f"wf_resume: the resumed actor's K1 launches "
                            f"{resumed_launches}, want {cfg.n_layers} x "
                            f"{ran_here} steps")
        rt.kill(w)
        out["wf_resume"] = {
            "wall_s": time.perf_counter() - t0,
            "spawn_to_first_checkpoint_s": first_ckpt_s,
            "checkpointed_at_kill": killed_with,
            "kill_to_resumable_s": kill_to_resumable_s,
            "liveness_s": WorkflowStorage.LIVENESS_S,
            "resume_s": resume_s, "steps_run_by_resumed_actor": ran_here,
            "runs_by_step": {i: len(p) for i, p in sorted(runs.items())},
            "generate_ms_resumed_actor": wstats["generate_ms"],
            "k1_launches_resumed_actor": resumed_launches,
            "tokens_equal_witness": resumed == witness}

        # Arm 2: an ActorPool of a LlamaWorker a card.
        t2 = time.perf_counter()
        n_cards = rt.cluster_resources()["GPU"]
        actors = [rt.remote(cs.LlamaWorker).options(num_gpus=1).remote()
                  for _ in range(int(n_cards))]
        pool = ActorPool(actors)
        t_map = time.perf_counter()
        mapped = list(pool.map(lambda a, v: a.generate.remote(*v),
                               enumerate(prompts)))
        map_s = time.perf_counter() - t_map
        t_map = time.perf_counter()
        unordered = list(pool.map_unordered(
            lambda a, v: a.generate.remote(*v), enumerate(prompts)))
        unordered_s = time.perf_counter() - t_map
        if mapped != witness:
            failures.append("pool_map: map's tokens differ from the "
                            "witness's")
        if sorted(unordered) != sorted(witness):
            failures.append("pool_map: map_unordered's tokens are not the "
                            "witness's set")
        pool_launches = sum(rt.get([a.launches.remote() for a in actors],
                                   timeout=60))
        if pool_launches != cfg.n_layers * 2 * len(prompts):
            failures.append(f"pool_map: K1 launches {pool_launches}, want "
                            f"{cfg.n_layers} a prompt")
        astats = rt.get([a.stats.remote() for a in actors], timeout=60)
        pids += [s["pid"] for s in astats]
        out["pool_map"] = {
            "cards": int(n_cards), "wall_s": time.perf_counter() - t2,
            "map_s": map_s, "map_unordered_s": unordered_s,
            "generate_ms_in_actor": [s["generate_ms"] for s in astats],
            "k1_launches": pool_launches,
            "tokens_equal_witness": mapped == witness}

        # Arm 3: a Queue filled token by token by the pool's actor.
        t3 = time.perf_counter()
        a = actors[0]
        before = rt.get(a.launches.remote(), timeout=60)
        q = Queue(maxsize=WF_QUEUE_MAX)
        assert q.qsize() == 0  # its actor is up before the stream starts
        ref = a.stream.remote(prompts[4], q)
        time.sleep(WF_QUEUE_SLEEP_S)
        got, stamps = [], []
        for _ in range(MAX_NEW):
            got.append(q.get(timeout=60))
            stamps.append(time.perf_counter())
        n_sent = rt.get(ref, timeout=120)
        blocked = rt.get(a.stats.remote(), timeout=60)["blocked_puts"]
        stream_launches = rt.get(a.launches.remote(), timeout=60) - before
        if got != witness[4]:
            failures.append("queue_stream: the tokens differ from the "
                            "witness's 2048-token row")
        if n_sent != MAX_NEW:
            failures.append(f"queue_stream: the call sent {n_sent}, want "
                            f"{MAX_NEW}")
        if blocked < 1:
            failures.append("queue_stream: the producer never found the "
                            "queue full")
        if stream_launches != cfg.n_layers:
            failures.append(f"queue_stream: K1 launches {stream_launches}, "
                            f"want {cfg.n_layers}")
        gaps = [(b - a_) * 1e3 for a_, b in zip(stamps, stamps[1:])]
        steady = gaps[len(gaps) // 2:]
        out["queue_stream"] = {
            "wall_s": time.perf_counter() - t3, "tokens": len(got),
            "blocked_puts": blocked, "k1_launches": stream_launches,
            "gap_ms_median_all": statistics.median(gaps),
            "gap_ms_median_second_half": statistics.median(steady),
            "gap_ms_max": max(gaps),
            "tokens_equal_witness": got == witness[4]}
        q.shutdown()
        pool_launches += stream_launches
    finally:
        rt.shutdown()
    # The in-process engine on the shortest and the longest prompt alone.
    out["generate_ms_in_process"] = {
        PROMPT_LENS[i]: _engine_generate_ms(eng, prompts[i]) for i in (0, 4)}
    out["decode_tick_ms_4_slots"] = tick_s * 1e3
    left = _pids_left(pids, within_s=10.0)
    children = [c.name for c in __import__("multiprocessing")
                .active_children() if c.name.startswith("rtpt-")]
    cores_after = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                             "rtpt-core-*")))
    shutil.rmtree(td, ignore_errors=True)
    if left or children or (cores_after - cores_before) or os.path.exists(
            td):
        failures.append(f"left behind: pids {left}, children {children}, "
                        f"core dirs {sorted(cores_after - cores_before)}, "
                        f"workflow dir {os.path.exists(td)}")
    emit("workflow_llm", ok=not failures, failures=failures,
         model="llama3_8b", n_layers=cfg.n_layers,
         phase_s=time.perf_counter() - t_phase, **out)
    if failures:
        raise AssertionError("; ".join(failures))
    return resumed_launches + pool_launches


# ------------------------------------------------------------- core_stream

CORE_STREAMS = (0, 1, 2, 3)  # the prompts streamed at once, a thread each
CORE_WINDOW = 4  # the backpressure arm's _generator_backpressure_num_objects
CORE_SLOW_READS = 24  # items that arm reads slowly, CORE_SLOW_READ_S apart
CORE_SLOW_READ_S = 0.05
CORE_CLOSE_AFTER = 8  # tokens read before the close arm closes its stream
CORE_DEADLINE_S = 0.5


class StreamingLlama(LlamaWorker):
    """core_stream's actor (one card, ``num_gpus=1``, ``max_concurrency=4``):
    LlamaWorker's engine, ticking on its own thread, behind four call
    threads. Its methods wait on the engine in 2 ms slices, so a cancel
    raised into a call thread lands between them; a call that ends early
    aborts its engine request (its slot frees at once)."""

    def __init__(self):
        import collections

        super().__init__()
        self.lock = threading.Lock()
        self.prefills = 0  # engine submits that ran their prefill
        self.calls = {}  # stream tag -> its record
        self.ended_early = []  # (what, id, monotonic clock, engine ticks)
        # When each engine step that did work ended (the monotonic clock
        # is the host's, so the driver's stamps compare with it).
        self.tick_ends = collections.deque(maxlen=4096)
        step = self.eng.tick

        def tick():
            n = step()
            if n:
                self.tick_ends.append(time.monotonic())
            return n

        self.eng.tick = tick

    def _submit(self, prompt):
        req = self.eng.submit(prompt, timeout=600)
        with self.lock:
            self.prefills += 1
        return req

    def _early(self, what, tag, req):
        self.eng.abort(req)
        self.ended_early.append((what, tag, time.monotonic(),
                                 self.eng.ticks))

    def ticks_between(self, t0, t1):
        """Engine steps that ended in (t0, t1], monotonic clock."""
        return sum(t0 < t <= t1 for t in list(self.tick_ends))

    def stream_tokens(self, tag, prompt):
        """The prompt's greedy tokens, yielded as the engine makes them
        (``num_returns="streaming"``); its record under ``tag``: call
        start and end, items whose report the driver answered, each
        report's round trip, the most slots busy seen."""
        rec = {"start": time.time(), "end": None, "acked": 0, "rtt_s": [],
               "max_busy": 0.0, "told_closed": None}
        self.calls[tag] = rec
        req, sent, done = None, 0, False
        try:
            req = self._submit(prompt)
            while True:
                done = self.eng.is_done(req)
                toks = self.eng.peek(req)
                rec["max_busy"] = max(rec["max_busy"],
                                      self.eng.stats()["slots_busy"])
                for tok in toks[sent:]:
                    t = time.perf_counter()
                    try:
                        yield tok
                    except GeneratorExit:  # the report answered closed
                        rec["told_closed"] = time.monotonic()
                        raise
                    rec["rtt_s"].append(time.perf_counter() - t)
                    sent += 1
                    rec["acked"] = sent
                if done and sent == len(toks):
                    break
                time.sleep(0.002)
        finally:
            if req is not None:
                if done:
                    self.eng.pop_result(req)
                else:  # closed or cancelled: the slot frees now
                    self._early("stream", tag, req)
            rec["end"] = time.time()

    def generate(self, i, prompt, marker=None):
        """Append ``(i, pid)`` to the marker file, then the prompt's greedy
        tokens, waited for in 2 ms slices."""
        import os

        if marker is not None:
            with open(marker, "a") as f:
                f.write(f"{i} {os.getpid()}\n")
        t0 = time.perf_counter()
        req = None
        try:
            req = self._submit(prompt)
            while not self.eng.is_done(req):
                time.sleep(0.002)
            out, req = self.eng.pop_result(req), None
        finally:
            if req is not None:  # cancelled mid-run
                self._early("generate", i, req)
        self.generate_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def acked(self, tag):
        return self.calls[tag]["acked"]

    def record(self, tag):
        return dict(self.calls[tag])

    def busy(self):
        return self.eng.stats()["slots_busy"]

    def context(self):
        """The card as get_runtime_context names it, the card torch uses,
        this pid."""
        import os

        import ray_tpu_torch as rt
        import torch

        return (rt.get_runtime_context().get_accelerator_ids()["GPU"],
                torch.cuda.current_device(), os.getpid())

    def trace_id(self):
        from ray_tpu_torch.util import tracing

        return tracing.current_trace_id()

    def counts(self):
        return {"prefills": self.prefills, "launches": self.launches(),
                "ended_early": list(self.ended_early)}


def card_spin(marker):
    """core_stream's card task: a CUDA context and 4 MiB on its card, then
    a loop of small kernels until it is stopped."""
    import os

    import torch

    x = torch.ones(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    while True:
        x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.005)


def two_generates(actor, prompts, marker):
    """core_stream's CPU task: two generate calls on ``actor``, waited for
    (a recursive cancel of this task reaches them)."""
    import ray_tpu_torch as rt

    return rt.get([actor.generate.remote(7 + j, p, marker)
                   for j, p in enumerate(prompts)])


def _marker_ids(marker):
    import os

    if not os.path.exists(marker):
        return []
    with open(marker) as f:
        return [int(line.split()[0]) for line in f.read().splitlines()]


def _wait_until(pred, timeout_s, what, failures):
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            failures.append(f"{what}: not within {timeout_s} s")
            return False
        time.sleep(0.005)
    return True


def _runtime_segments():
    """The /dev/shm segments of this driver's core runtime as they stand
    now: those it and its processes (its task workers, its actors) map,
    read from their /proc/<pid>/maps, and the channel segments the driver
    opened (``object_store``). Another process's segments on the same
    machine are not among them."""
    import multiprocessing
    import os

    from ray_tpu_torch.core import object_store

    names = set(object_store._channel_open)  # the port's, all "rtpt..."
    for pid in [os.getpid()] + [c.pid for c in multiprocessing
                                .active_children()]:
        try:
            with open(f"/proc/{pid}/maps") as f:
                for line in f:
                    path = line.split()[-1]
                    if path.startswith("/dev/shm/rtpt"):
                        names.add(path[len("/dev/shm/"):])
        except (OSError, IndexError):
            continue
    return names


def phase_core_stream(cfg, prompts, witness, tick_s, prefill_ms):
    """serve_cfg()'s Llama-3-8B (SERVE_LAYERS layers) streamed out of one
    actor of the port's core: a StreamingLlama (``num_gpus=1``,
    ``max_concurrency=4``), the witness's engine ticking on its own thread
    inside. Held:

    - ``force``: first, a card task (``card_spin``) cancelled with
      ``force=True``: TaskCancelledError, its process gone, its card free
      again (``available_resources()["GPU"]`` back where it was);
    - ``context``: in the actor, ``get_runtime_context()
      .get_accelerator_ids()["GPU"]`` names its card; with tracing on, a
      call's consumer span shares the driver's trace id;
    - ``streams``: four ``stream_tokens`` calls with
      ``num_returns="streaming"`` at once, read round-robin: each the
      witness's tokens bit for bit, the four calls' intervals overlapping,
      4 slots busy at once, each first item read while its call ran;
    - ``backpressure``: a stream with a window of CORE_WINDOW read slowly:
      the reports answered never more than the window ahead of the items
      read, and the window reached;
    - ``close``: a stream closed after CORE_CLOSE_AFTER tokens: its
      producer's next report answers closed, its finally aborts the
      request, and the slot is free within one engine step of that
      answer (Serve's measure, from when the replica learns of a close)
      and within two of the consumer's close (one until the producer's
      next report, one for the step in flight);
    - ``cancel``: a running generate (TaskCancelledError, its slot freed);
      a fifth generate behind four busy threads (fails without waiting for
      them and never starts); a call behind them with
      ``deadline_s=CORE_DEADLINE_S`` (DeadlineExceededError, never
      starts); ``recursive=True`` on a CPU task that submitted two
      generates (both stopped);
    - a first generate warms the actor (the witness's tokens);
    - K1 launched 8 times a prefill in the actor (SERVE_LAYERS a prompt);
      after ``shutdown()`` no process, core directory or /dev/shm segment
      of the core left (the segments the runtime's processes mapped).

    Prints each arm's times beside the witness's prefill and tick. Returns
    the K1 launches counted in the actor."""
    import glob
    import os
    import shutil
    import tempfile

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.serve.llm_engine import bucket_len
    from ray_tpu_torch.util import tracing

    failures = []
    t_phase = time.perf_counter()
    segments_before = _runtime_segments()
    td = tempfile.mkdtemp(prefix="core-stream-")
    marker = os.path.join(td, "marker")
    cores_before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                              "rtpt-core-*")))
    out = {"n_layers": cfg.n_layers, "new_tokens": MAX_NEW,
           "decode_tick_ms_4_slots": tick_s * 1e3,
           "prefill_ms_by_bucket": prefill_ms}
    pids = []
    launches = 0
    rt.init(num_cpus=4)
    try:
        # Arm 1: a card task stopped with force=True.
        gpu0 = rt.available_resources()["GPU"]
        spin_marker = os.path.join(td, "spin")
        t0 = time.perf_counter()
        spin = rt.remote(cs.card_spin).options(num_gpus=1).remote(
            spin_marker)
        if _wait_until(lambda: os.path.exists(spin_marker), 120,
                       "force: the card task's start", failures):
            time.sleep(0.05)
            with open(spin_marker) as f:
                spin_pid = int(f.read())
            pids.append(spin_pid)
            held = rt.available_resources()["GPU"]
            t_cancel = time.perf_counter()
            rt.cancel(spin, force=True)
            try:
                rt.get(spin, timeout=60)
                failures.append("force: the card task returned")
            except rt.TaskCancelledError:
                pass
            t_err = time.perf_counter()
            _wait_until(lambda: not _alive(spin_pid), 30,
                        "force: the card task's exit", failures)
            t_exit = time.perf_counter()
            _wait_until(lambda: rt.available_resources()["GPU"] == gpu0, 30,
                        "force: the card back", failures)
            out["force"] = {
                "spawn_to_running_s": t_cancel - t0, "gpu_before": gpu0,
                "gpu_while_running": held,
                "gpu_after": rt.available_resources()["GPU"],
                "cancel_to_error_ms": (t_err - t_cancel) * 1e3,
                "cancel_to_exit_ms": (t_exit - t_cancel) * 1e3}
            if held != gpu0 - 1:
                failures.append(f"force: GPU {held} while the task ran, "
                                f"want {gpu0 - 1}")

        # The actor, four call threads on one card.
        t0 = time.perf_counter()
        a = rt.remote(cs.StreamingLlama).options(
            num_gpus=1, max_concurrency=4).remote()
        gpu_ids, torch_card, pid = rt.get(a.context.remote(), timeout=600)
        pids.append(pid)
        out["actor_spawn_to_ready_s"] = time.perf_counter() - t0
        # A fresh actor's first generate pays CUDA's lazy loads (PERF.md
        # section 5): one generate first, so the arms read a warm engine.
        t0 = time.perf_counter()
        if rt.get(a.generate.remote(-1, prompts[5]),
                  timeout=600) != witness[5]:
            failures.append("warm: the first generate differs from the "
                            "witness's")
        out["actor_first_generate_ms"] = (time.perf_counter() - t0) * 1e3
        card = api.runtime().actor_info(a._actor_id)["card"]
        if gpu_ids != [str(card)] or torch_card != card:
            failures.append(f"context: accelerator ids {gpu_ids}, torch "
                            f"card {torch_card}, the core gave card {card}")
        tracing.setup_tracing()
        try:
            with tracing.start_span("core_stream") as root:
                inside = rt.get(a.trace_id.remote(), timeout=60)
        finally:
            os.environ.pop("RTPU_TRACING", None)
        if inside != root.context.trace_id:
            failures.append(f"spans: the call's trace {inside!r}, the "
                            f"driver's {root.context.trace_id!r}")
        out["context"] = {"accelerator_ids": gpu_ids, "card": card,
                          "span_shares_trace": inside ==
                          root.context.trace_id}

        # Arm 2: four streams on four threads, read round-robin.
        k0 = rt.get(a.counts.remote(), timeout=60)["launches"]
        t_submit = []
        gens = []
        for i in CORE_STREAMS:
            t_submit.append(time.time())
            gens.append(a.stream_tokens.options(
                num_returns="streaming").remote(f"s{i}", prompts[i]))
        got = [[] for _ in CORE_STREAMS]
        arrive = [[] for _ in CORE_STREAMS]
        live = list(range(len(CORE_STREAMS)))
        while live:
            for j in list(live):
                try:
                    ref = next(gens[j])
                except StopIteration:
                    live.remove(j)
                    continue
                got[j].append(rt.get(ref, timeout=120))
                arrive[j].append(time.time())
        recs = [rt.get(a.record.remote(f"s{i}"), timeout=60)
                for i in CORE_STREAMS]
        stream_launches = rt.get(a.counts.remote(),
                                 timeout=60)["launches"] - k0
        for j, i in enumerate(CORE_STREAMS):
            if got[j] != witness[i]:
                failures.append(f"streams: stream {i}'s tokens differ from "
                                f"the witness's: {got[j][:8]} vs "
                                f"{witness[i][:8]}")
            if not arrive[j] or arrive[j][0] >= recs[j]["end"]:
                failures.append(f"streams: stream {i}'s first item was not "
                                "read while its call ran")
        if max(r["start"] for r in recs) >= min(r["end"] for r in recs):
            failures.append("streams: the four calls did not overlap")
        if max(r["max_busy"] for r in recs) != NUM_SLOTS:
            failures.append(f"streams: at most "
                            f"{max(r['max_busy'] for r in recs)} slots busy")
        if stream_launches != cfg.n_layers * len(CORE_STREAMS):
            failures.append(f"streams: K1 launches {stream_launches}, want "
                            f"{cfg.n_layers} a prompt")
        gaps = [(b - a_) * 1e3 for ts in arrive
                for a_, b in zip(ts[len(ts) // 2:], ts[len(ts) // 2 + 1:])]
        rtts = [s * 1e3 for r in recs for s in r["rtt_s"]]
        out["streams"] = {
            "prompt_lens": [len(prompts[i]) for i in CORE_STREAMS],
            "buckets": [bucket_len(len(prompts[i]), MAX_PROMPT)
                        for i in CORE_STREAMS],
            "submit_to_first_item_ms": [(ts[0] - t) * 1e3 for ts, t in
                                        zip(arrive, t_submit)],
            "gap_ms_median_second_half": statistics.median(gaps),
            "gap_ms_max_second_half": max(gaps),
            "item_round_trip_ms_median": statistics.median(rtts),
            "item_round_trip_ms_p90": sorted(rtts)[int(0.9 * len(rtts))],
            "call_s": [r["end"] - r["start"] for r in recs],
            "max_slots_busy": max(r["max_busy"] for r in recs),
            "k1_launches": stream_launches,
            "tokens_equal_witness": [g == witness[i] for g, i in
                                     zip(got, CORE_STREAMS)]}

        # Arm 3: backpressure, read slowly.
        k = 4
        gen = a.stream_tokens.options(
            num_returns="streaming",
            _generator_backpressure_num_objects=CORE_WINDOW).remote(
                "bp", prompts[k])
        bp, ahead = [], []
        for n, ref in enumerate(gen, 1):
            bp.append(rt.get(ref, timeout=60))
            if n <= CORE_SLOW_READS:
                time.sleep(CORE_SLOW_READ_S)
                ahead.append(rt.get(a.acked.remote("bp"), timeout=60) - n)
        if bp != witness[k]:
            failures.append("backpressure: the tokens differ from the "
                            "witness's")
        if max(ahead) > CORE_WINDOW or max(ahead) < CORE_WINDOW - 1:
            failures.append(f"backpressure: the producer ran "
                            f"{max(ahead)} ahead, window {CORE_WINDOW}")
        out["backpressure"] = {"window": CORE_WINDOW,
                               "ahead_after_each_slow_read": ahead,
                               "tokens_equal_witness": bp == witness[k]}

        # Arm 4: a stream closed after CORE_CLOSE_AFTER tokens.
        gen = a.stream_tokens.options(num_returns="streaming").remote(
            "close", prompts[k])
        head = [rt.get(next(gen), timeout=60)
                for _ in range(CORE_CLOSE_AFTER)]
        t_close = time.monotonic()
        gen.close()
        freed = None
        if _wait_until(lambda: rt.get(a.record.remote("close"),
                                      timeout=60)["end"] is not None, 10,
                       "close: the producer's finally", failures):
            freed = [e for e in rt.get(a.counts.remote(), timeout=60)[
                "ended_early"] if e[1] == "close"]
        busy = rt.get(a.busy.remote(), timeout=60)
        if head != witness[k][:CORE_CLOSE_AFTER]:
            failures.append("close: the tokens read differ from the "
                            "witness's")
        # Serve's measure: engine steps from when the producer learned of
        # the close (its next report answered closed) to the free slot.
        told = rt.get(a.record.remote("close"), timeout=60)["told_closed"]
        ticks = (rt.get(a.ticks_between.remote(told, freed[0][2]),
                        timeout=60) if freed and told else None)
        if not freed or told is None or ticks > 1 or busy != 0:
            failures.append(f"close: the slot freed {freed}, {ticks} "
                            f"engine steps after the producer's closed "
                            f"report ({told}), {busy} busy")
        # From the consumer's close: one step until the producer's next
        # report hears of it, one for the step in flight when it aborts.
        ticks_close = (rt.get(a.ticks_between.remote(t_close, freed[0][2]),
                              timeout=60) if freed else None)
        if ticks_close is None or ticks_close > 2:
            failures.append(f"close: the slot freed {ticks_close} engine "
                            f"steps after the consumer's close, want <= 2")
        if freed and told:
            out["close"] = {
                "close_to_free_ms": (freed[0][2] - t_close) * 1e3,
                "close_to_told_ms": (told - t_close) * 1e3,
                "ticks_close_to_free": ticks_close,
                "ticks_until_free": ticks, "slots_busy_after": busy}

        # Arm 5: cancels and a deadline.
        r = a.generate.remote(0, prompts[4], marker)
        _wait_until(lambda: 0 in _marker_ids(marker)
                    and rt.get(a.busy.remote(), timeout=60) == 1, 60,
                    "cancel: the running generate's start", failures)
        time.sleep(0.2)
        t_cancel = time.perf_counter()
        rt.cancel(r)
        try:
            rt.get(r, timeout=60)
            failures.append("cancel: the running generate returned")
        except rt.TaskCancelledError:
            pass
        running_ms = (time.perf_counter() - t_cancel) * 1e3
        _wait_until(lambda: rt.get(a.busy.remote(), timeout=60) == 0, 5,
                    "cancel: the running generate's slot", failures)
        four = [a.generate.remote(i, prompts[i], marker) for i in (1, 2, 3, 4)]
        _wait_until(lambda: {1, 2, 3, 4} <= set(_marker_ids(marker)), 60,
                    "cancel: four generates running", failures)
        fifth = a.generate.remote(5, prompts[0], marker)
        late = a.generate.options(deadline_s=CORE_DEADLINE_S).remote(
            6, prompts[0], marker)
        time.sleep(0.05)
        t_cancel = time.perf_counter()
        rt.cancel(fifth)
        try:
            rt.get(fifth, timeout=60)
            failures.append("cancel: the queued generate returned")
        except rt.TaskCancelledError:
            pass
        queued_ms = (time.perf_counter() - t_cancel) * 1e3
        fours = rt.get(four, timeout=120)
        for i, toks in zip((1, 2, 3, 4), fours):
            if toks != witness[i]:
                failures.append(f"cancel: generate {i} differs from the "
                                "witness")
        try:
            rt.get(late, timeout=60)
            failures.append("deadline: the late generate returned")
        except rt.DeadlineExceededError:
            pass
        ran = _marker_ids(marker)
        if 5 in ran or 6 in ran:
            failures.append(f"cancel/deadline: generates {ran} started")
        gen_ms = rt.get(a.stats.remote(), timeout=60)["generate_ms"]
        if queued_ms > 0.5 * min(gen_ms):
            failures.append(f"cancel: the queued generate failed after "
                            f"{queued_ms:.1f} ms: it waited")
        before = len(rt.get(a.counts.remote(), timeout=60)["ended_early"])
        task = rt.remote(cs.two_generates).remote(a, [prompts[1],
                                                      prompts[2]], marker)
        _wait_until(lambda: {7, 8} <= set(_marker_ids(marker))
                    and rt.get(a.busy.remote(), timeout=60) == 2, 60,
                    "recursive: both generates running", failures)
        t_cancel = time.perf_counter()
        rt.cancel(task, recursive=True)
        try:
            rt.get(task, timeout=60)
            failures.append("recursive: the task returned")
        except rt.TaskCancelledError:
            pass
        _wait_until(lambda: rt.get(a.busy.remote(), timeout=60) == 0, 10,
                    "recursive: the generates' slots", failures)
        recursive_ms = (time.perf_counter() - t_cancel) * 1e3
        stopped = [e for e in rt.get(a.counts.remote(), timeout=60)[
            "ended_early"][before:] if e[0] == "generate"]
        if sorted(e[1] for e in stopped) != [7, 8]:
            failures.append(f"recursive: stopped {stopped}, want "
                            "generates 7 and 8")
        out["cancel"] = {"running_cancel_to_error_ms": running_ms,
                         "queued_cancel_to_error_ms": queued_ms,
                         "recursive_cancel_to_free_ms": recursive_ms,
                         "generate_ms_in_actor": gen_ms,
                         "deadline_s": CORE_DEADLINE_S}

        counts = rt.get(a.counts.remote(), timeout=60)
        launches = counts["launches"]
        if launches != cfg.n_layers * counts["prefills"]:
            failures.append(f"K1 launches {launches} in the actor, want "
                            f"{cfg.n_layers} x {counts['prefills']} "
                            "prefills")
        out["k1_launches"] = launches
        out["prefills"] = counts["prefills"]
        segments = _runtime_segments()
        rt.kill(a)
    finally:
        rt.shutdown()
    left = _pids_left(pids, within_s=10.0)
    children = [c.name for c in __import__("multiprocessing")
                .active_children() if c.name.startswith("rtpt-")]
    cores_after = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                             "rtpt-core-*")))
    shm_left = {n for n in segments - segments_before
                if os.path.exists(os.path.join("/dev/shm", n))}
    shutil.rmtree(td, ignore_errors=True)
    if left or children or (cores_after - cores_before) or shm_left:
        failures.append(f"left behind: pids {left}, children {children}, "
                        f"core dirs {sorted(cores_after - cores_before)}, "
                        f"/dev/shm {sorted(shm_left)}")
    emit("core_stream", ok=not failures, failures=failures,
         model="llama3_8b", card=card_line(),
         phase_s=time.perf_counter() - t_phase, **out)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def _launch_counts(fa):
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_launch_counts(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def _train_tokens(cfg, B, S, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).to(
        device)


def phase_train(fa, device):
    """The training main path: bench_350m, full width and depth."""
    import torch

    from ray_tpu_torch.models.configs import bench_350m
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = bench_350m(remat=True, remat_policy="dots")
    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    torch.cuda.reset_peak_memory_stats(device)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    batch = {"tokens": _train_tokens(cfg, TRAIN_BATCH, TRAIN_SEQ, device)}
    losses = []
    _zero_launch_counts(fa)  # count the main path alone
    for _ in range(WARM_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = _launch_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    losses = [float(x) for x in losses]

    steps = WARM_STEPS + TIMED_STEPS
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"non-finite loss: {losses}")
    elif abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        failures.append(f"first loss {losses[0]} is not within 0.5 of "
                        f"ln({cfg.vocab_size})")
    elif not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses}")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")

    # One profiled step: device busy time against the unprofiled step.
    busy, top = _device_profile(lambda: ts.step(params, opt, batch))
    shares = {name: (sum(ms for k, ms in top if name + "_kernel" in k) / busy
                     if busy else None)
              for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / step_s
    emit("train", ok=not failures, failures=failures, model="bench_350m",
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
         vocab=cfg.vocab_size, num_params=cfg.num_params(),
         remat_policy=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         warm_steps=WARM_STEPS, timed_steps=TIMED_STEPS, losses=losses,
         launches=launches, launches_per_step={
             k: v / steps for k, v in launches.items()},
         step_ms=step_s * 1e3, tokens_per_s=tok_s,
         mfu_bf16_dense=tok_s * cfg.flops_per_token(TRAIN_SEQ)
         / PEAK_BF16_FLOPS,
         flops_per_token=cfg.flops_per_token(TRAIN_SEQ),
         peak_mem_gib=peak_gib,
         profile={"busy_ms": busy, "unprofiled_ms": step_s * 1e3,
                  "idle_share": 1 - busy / (step_s * 1e3) if busy else None,
                  "kernel_share_of_busy": shares,
                  "top_kernels_ms": top[:10]})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, losses, step_s


def _count_delta(fa, before):
    now = _launch_counts(fa)
    return {k: now[k] - before[k] for k in now}


def phase_sp_check(fa, device):
    """The ring's and Ulysses' schedules on one card: one sequence of
    SP_SEQ tokens at Llama-3-8B's attention width in SP_RANKS chunks, the
    ranks simulated in this process (the ring's own schedule functions,
    the hop a list rotation), against K1/K2/K3 over the whole sequence."""
    import torch

    from ray_tpu_torch.ops.ring_attention import (ring_bwd, ring_fwd,
                                                  rotate_hop)

    B, S, H, KVH, D = 1, SP_SEQ, SP_HEADS, SP_KV_HEADS, SP_HEAD_DIM
    n, chunk, scale = SP_RANKS, SP_SEQ // SP_RANKS, SP_HEAD_DIM ** -0.5
    gen = torch.Generator(device=device).manual_seed(SEED)

    def t(heads):
        return torch.randn((B, S, heads, D), generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    def split(x):
        return [x[:, r * chunk:(r + 1) * chunk] for r in range(n)]

    rows, failures = [], []
    for causal in (True, False):
        q, k, v, do = t(H), t(KVH), t(KVH), t(H)
        o_ref, lse_ref = fa.flash_attention_fwd(q, k, v, scale, causal)
        grads_ref = fa.flash_bwd_core(q, k, v, do, lse_ref,
                                      fa.attention_delta(do, o_ref),
                                      scale=scale, causal=causal)
        ranks = list(range(n))

        def fwd():
            return ring_fwd(split(q), split(k), split(v), ranks, n,
                            rotate_hop, causal=causal, scale=scale)

        before = _launch_counts(fa)
        os_, lses = fwd()
        fwd_launches = _count_delta(fa, before)
        deltas = [fa.attention_delta(d, o) for d, o in zip(split(do), os_)]

        def bwd():
            return ring_bwd(split(q), split(k), split(v), split(do), lses,
                            deltas, ranks, n, rotate_hop, causal=causal,
                            scale=scale)

        before = _launch_counts(fa)
        grads = bwd()
        bwd_launches = _count_delta(fa, before)
        want = n * (n + 1) // 2 if causal else n * n
        row = {"causal": causal, "o_rel_l2": rel_l2(torch.cat(os_, 1),
                                                    o_ref),
               "lse_max_abs": float((torch.cat(lses, 2) - lse_ref).abs()
                                    .max()),
               "launches_fwd": fwd_launches, "launches_bwd": bwd_launches,
               "launches_expected": want}
        for name, g, w in zip(("dq", "dk", "dv"), grads, grads_ref):
            row[name + "_rel_l2"] = rel_l2(torch.cat(g, 1), w)
        # One chunk from the past with the global lse and delta of its
        # rows: K1 (no mask), K2 and K3 against their plain versions.
        q1, k0, v0, do1 = (split(x)[1] for x in (q, k, v, do))
        o_c, lse_c = fa.flash_attention_fwd(q1, k0, v0, scale, False)
        po, plse = fa.flash_attention_fwd_plain(q1, k0, v0, scale, False)
        o_c, po = o_c.float(), po.float()
        row["chunk_o_max_abs"] = float((o_c - po).abs().max())
        row["chunk_o_ok"] = bool(
            ((o_c - po).abs() <= O_ATOL + O_RTOL * po.abs()).all())
        row["chunk_lse_max_abs"] = float((lse_c - plse).abs().max())
        chunk_args = (q1, k0, v0, do1, lses[1], deltas[1])
        got = fa.flash_bwd_core(*chunk_args, scale=scale, causal=False)
        plain = fa.flash_attention_bwd_plain(*chunk_args, scale, False)
        for name, g, w in zip(("dq", "dk", "dv"), got, plain):
            row["chunk_" + name + "_rel_l2"] = rel_l2(g, w)
        # Ulysses: each simulated rank runs K1 over the whole sequence for
        # its H/n query heads and KVH/n kv heads.
        hq, hk = H // n, KVH // n
        before = _launch_counts(fa)
        o_u = torch.cat([fa.flash_attention_fwd(
            q[:, :, r * hq:(r + 1) * hq], k[:, :, r * hk:(r + 1) * hk],
            v[:, :, r * hk:(r + 1) * hk], scale, causal)[0]
            for r in range(n)], 2)
        row["ulysses_launches"] = _count_delta(fa, before)["flash_fwd"]
        row["ulysses_o_rel_l2"] = rel_l2(o_u, o_ref)
        # Times: the simulated ring (every rank's chunks in turn on this
        # card, no hop cost) beside the one-device kernels.
        row["ring_fwd_ms"] = cuda_ms(fwd, iters=3, warmup=1)
        row["one_device_k1_ms"] = cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, scale, causal), iters=3,
            warmup=1)
        row["ring_bwd_ms"] = cuda_ms(bwd, iters=3, warmup=1)
        row["one_device_k2_k3_ms"] = cuda_ms(
            lambda: fa.flash_bwd_core(q, k, v, do, lse_ref,
                                      fa.attention_delta(do, o_ref),
                                      scale=scale, causal=causal),
            iters=3, warmup=1)
        rows.append(row)
        rels = [row[k] for k in row if k.endswith("_rel_l2")]
        if not (max(rels) <= SP_REL_L2 and row["lse_max_abs"] <= LSE_ATOL
                and row["chunk_lse_max_abs"] <= LSE_ATOL
                and row["chunk_o_ok"]
                and all(math.isfinite(x) for x in rels)):
            failures.append(f"causal={causal}: errors {row}")
        if (fwd_launches != dict(flash_fwd=want, flash_bwd_dq=0,
                                 flash_bwd_dkv=0)
                or bwd_launches != dict(flash_fwd=0, flash_bwd_dq=want,
                                        flash_bwd_dkv=want)
                or row["ulysses_launches"] != n):
            failures.append(f"causal={causal}: launches {row}")
    long_row = ring_against_f32(fa, device)
    if not long_row["ok"]:
        failures.append(f"ring against f32: {long_row}")
    emit("sp_check", ok=not failures, failures=failures, B=B, S=S, H=H,
         KVH=KVH, D=D, ranks=n, chunk=chunk, rel_l2_tol=SP_REL_L2,
         lse_atol=LSE_ATOL, rows=rows, train_shape=long_row)
    if failures:
        raise AssertionError("; ".join(failures))


def ring_against_f32(fa, device):
    """The ring at dist_train's long-sequence shape (bench_350m's heads,
    DIST_LONG_BATCH x DIST_LONG_SEQ in SP_RANKS chunks, causal), simulated
    on one card, and the one-device kernels, each against the plain
    attention in f32 on the same bf16 inputs: the ring's o and dq/dk/dv
    may lie at most TRAIN_GRAD_F32_RATIO times as far from f32 as the
    kernels' do."""
    import torch

    from ray_tpu_torch.ops.ring_attention import (ring_bwd, ring_fwd,
                                                  rotate_hop)

    B, S, H, D, n = DIST_LONG_BATCH, DIST_LONG_SEQ, 16, 64, SP_RANKS
    chunk, scale = S // n, D ** -0.5
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))

    def split(x):
        return [x[:, r * chunk:(r + 1) * chunk] for r in range(n)]

    o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    kernel = (o,) + fa.flash_bwd_core(q, k, v, do, lse,
                                      fa.attention_delta(do, o),
                                      scale=scale, causal=True)
    os_, lses = ring_fwd(split(q), split(k), split(v), range(n), n,
                         rotate_hop, causal=True, scale=scale)
    deltas = [fa.attention_delta(d, o_c) for d, o_c in zip(split(do), os_)]
    ring = (torch.cat(os_, 1),) + tuple(torch.cat(g, 1) for g in ring_bwd(
        split(q), split(k), split(v), split(do), lses, deltas, range(n), n,
        rotate_hop, causal=True, scale=scale))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    of, lsef = fa.flash_attention_fwd_plain(qf, kf, vf, scale, True)
    f32 = (of,) + fa.flash_attention_bwd_plain(
        qf, kf, vf, dof, lsef, fa.attention_delta(dof, of), scale, True)
    row = {"B": B, "S": S, "H": H, "D": D, "ranks": n,
           "ratio_tol": TRAIN_GRAD_F32_RATIO, "ok": True}
    for name, r, kk, f in zip(("o", "dq", "dk", "dv"), ring, kernel, f32):
        row[name] = {"ring_vs_f32": rel_l2(r, f),
                     "kernels_vs_f32": rel_l2(kk, f),
                     "ring_vs_kernels": rel_l2(r, kk)}
        row["ok"] &= (row[name]["ring_vs_f32"]
                      <= TRAIN_GRAD_F32_RATIO * row[name]["kernels_vs_f32"])
    return row


def moe_config(**overrides):
    """bench_350m with MOE_EXPERTS experts, top MOE_TOP_K, MOE_LAYERS
    layers (``overrides`` win)."""
    from ray_tpu_torch.models.configs import bench_350m

    return bench_350m(**{"remat": True, "remat_policy": "dots",
                         "moe_num_experts": MOE_EXPERTS,
                         "moe_experts_per_token": MOE_TOP_K,
                         "n_layers": MOE_LAYERS, **overrides})


def phase_moe_train(fa, device):
    """The MoE model trains (full width, MOE_LAYERS layers, 8 experts,
    top-2), then serves in bf16: one prefill and greedy decode steps."""
    import torch

    from ray_tpu_torch.models.generate import _decode, prefill
    from ray_tpu_torch.models.transformer import forward_with_aux
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = moe_config()
    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    torch.cuda.reset_peak_memory_stats(device)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    batch = {"tokens": _train_tokens(cfg, TRAIN_BATCH, TRAIN_SEQ, device)}
    losses = []
    _zero_launch_counts(fa)  # count the main path alone
    for _ in range(MOE_WARM_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_TIMED_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_TIMED_STEPS
    launches = _launch_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    losses = [float(x) for x in losses]
    busy, top = _device_profile(lambda: ts.step(params, opt, batch))
    with torch.no_grad():
        _, aux = forward_with_aux(params, batch["tokens"][:, :-1], cfg)
    aux_per_layer = float(aux) / cfg.n_layers

    steps = MOE_WARM_STEPS + MOE_TIMED_STEPS
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"non-finite loss: {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses}")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if not 0.1 < aux_per_layer < 10.0:
        failures.append(f"aux per layer {aux_per_layer} not in (0.1, 10)")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    expert_params = (cfg.n_layers * MOE_EXPERTS * 3 * cfg.d_model
                     * cfg.ff_dim)
    train = dict(
        ok=not failures, failures=failures, model="bench_350m+moe",
        n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.ff_dim,
        experts=MOE_EXPERTS, top_k=MOE_TOP_K,
        capacity_factor=cfg.moe_capacity_factor,
        num_params=cfg.num_params(), expert_params=expert_params,
        remat_policy=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        warm_steps=MOE_WARM_STEPS, timed_steps=MOE_TIMED_STEPS,
        losses=losses, aux_per_layer=aux_per_layer, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
        peak_mem_gib=peak_gib,
        profile={"busy_ms": busy, "unprofiled_ms": step_s * 1e3,
                 "idle_share": 1 - busy / (step_s * 1e3) if busy else None,
                 "top_kernels_ms": top[:10]})
    if failures:
        emit("moe_train", **train)
        raise AssertionError("; ".join(failures))

    # The same weights in bf16 serve: one prefill, then greedy decode.
    del opt, ts
    serve_params = {k: v.detach().to(torch.bfloat16) if k != "layers"
                    else {n: w.detach().to(torch.bfloat16)
                          for n, w in v.items()}
                    for k, v in params.items()}
    del params
    gc_collect()
    rng = torch.Generator(device=device).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, MOE_PREFILL),
                           generator=rng, device=device)
    fa.flash_attention_fwd.launches = 0  # count the main path alone
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(serve_params, prompt, cfg,
                                MOE_PREFILL + MOE_DECODE)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        finite = torch.isfinite(logits).all()
        out = [logits.argmax(-1)]
        t0 = time.perf_counter()
        for _ in range(MOE_DECODE):
            logits, cache = _decode(serve_params, cache, out[-1], cfg)
            finite = finite & torch.isfinite(logits).all()
            out.append(logits.argmax(-1))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / MOE_DECODE
    serve_launches = fa.flash_attention_fwd.launches
    tokens_out = torch.cat(out).tolist()
    if not bool(finite):
        failures.append("non-finite serving logits")
    if not all(0 <= x < cfg.vocab_size for x in tokens_out):
        failures.append(f"tokens out of range: {tokens_out}")
    if serve_launches != cfg.n_layers:
        failures.append(f"prefill launched K1 {serve_launches} times, "
                        f"expected {cfg.n_layers}")
    train.update(ok=not failures, failures=failures, serve={
        "prefill_tokens": MOE_PREFILL, "prefill_ms": prefill_ms,
        "decode_steps": MOE_DECODE, "decode_ms_per_step": decode_ms,
        "tokens": tokens_out, "k1_launches": serve_launches})
    emit("moe_train", **train)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, serve_launches, losses


def gc_collect():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_layouts(world, names=DIST_LAYOUTS, **cfg_overrides):
    """dist_train's layouts: name -> (mesh axes, rules, config, batch,
    seq, environment flags, pipeline microbatches)."""
    from ray_tpu_torch.models.configs import bench_350m

    dense = dict(remat=True, remat_policy="dots", **cfg_overrides)
    table = {
        "fsdp": (dict(fsdp=-1), "RULES_FSDP", bench_350m(**dense),
                 TRAIN_BATCH, TRAIN_SEQ, {}, None),
        "seq_ring": (dict(seq=-1), "RULES_TP",
                     bench_350m(max_seq_len=DIST_LONG_SEQ, **dense),
                     DIST_LONG_BATCH, DIST_LONG_SEQ,
                     {"RTPU_SP_MODE": "ring"}, None),
        "seq_ulysses": (dict(seq=-1), "RULES_TP",
                        bench_350m(max_seq_len=DIST_LONG_SEQ, **dense),
                        DIST_LONG_BATCH, DIST_LONG_SEQ,
                        {"RTPU_SP_MODE": "ulysses"}, None),
        "expert": (dict(expert=-1), "RULES_TP", moe_config(**cfg_overrides),
                   TRAIN_BATCH, TRAIN_SEQ, {}, None),
        "pipe": (dict(pipe=-1), "RULES_TP", bench_350m(**dense),
                 TRAIN_BATCH, TRAIN_SEQ, {}, 2 * world),
    }
    return {n: table[n] for n in names}


def _expected_launches(name, layout, mesh, steps):
    """K1/K2/K3 launches a rank makes in ``steps`` steps: "dots" remat
    runs each layer's forward twice. A causal ring's rank r runs K1 on
    r + 1 chunks a layer; a pipeline stage runs its L/P layers once a
    microbatch."""
    from ray_tpu_torch.parallel.mesh import mesh_shape

    cfg, micro = layout[2], layout[6]
    per = cfg.n_layers
    if name == "seq_ring":
        per *= mesh.get_local_rank("seq") + 1
    if name == "pipe":
        per = per // mesh_shape(mesh)["pipe"] * micro
    return {"flash_fwd": 2 * per * steps, "flash_bwd_dq": per * steps,
            "flash_bwd_dkv": per * steps}


def _run_dist_layout(name, layout, device_type, check_grads):
    """One layout on this rank: warm-up and timed steps, launches read
    around the steps alone; with ``check_grads``, the first step's
    gradients against the one-device step's, and the one-device step with
    the plain attention against the same (both measured on rank 0)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import flags, parallel
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.step import transformer_train_step

    spec, rules, cfg, batch, seq, env, micro = layout
    cuda = device_type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    with flags.scoped(env):
        mesh = make_mesh(MeshSpec(**spec), device_type)
        ts = transformer_train_step(cfg, mesh, rules=getattr(parallel, rules),
                                    shift_inputs=True,
                                    pipeline_microbatches=micro)
        device = ts.device
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        params, opt = ts.init(gen)
        tokens = _train_tokens(cfg, batch, seq, device)
        sharded = ts.shard_batch({"tokens": tokens})
        losses, first_grads = [], None
        _zero_launch_counts(fa)  # count the main path alone
        for _ in range(DIST_WARM_STEPS):
            params, opt, loss = ts.step(params, opt, sharded)
            losses.append(loss)
            if check_grads and first_grads is None:
                first_grads = _leaf_grads(params)
                if rank != 0:
                    first_grads = {}
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_TIMED_STEPS):
            params, opt, loss = ts.step(params, opt, sharded)
            losses.append(loss)
        if cuda:
            torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / DIST_TIMED_STEPS
        launches = _launch_counts(fa)
        out = {"losses": [float(x) for x in losses], "step_s": step_s,
               "launches": launches, "launches_expected": _expected_launches(
                   name, layout, mesh, DIST_WARM_STEPS + DIST_TIMED_STEPS),
               "local_tokens": tuple(sharded["tokens"].to_local().shape),
               "placements": {k: repr(tuple(v.placements)) for k, v in
                              params["layers"].items()}}
        if cuda:
            out["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device)
                                   / 2 ** 30)
        if cuda and name == "fsdp":
            busy, top = _device_profile(
                lambda: ts.step(params, opt, sharded))
            # NCCL work shows twice (its "nccl:" annotation and its
            # kernel), and a collective's kernel waits for its peers:
            # it is reported apart, and compute alone is busy time.
            nccl = sum(ms for k, ms in top if k.startswith("ncclDev"))
            busy -= sum(ms for k, ms in top if k.startswith("nccl"))
            out["profile"] = {
                "compute_busy_ms": busy, "nccl_kernel_ms": nccl,
                "unprofiled_ms": step_s * 1e3,
                "idle_share": 1 - busy / (step_s * 1e3) if busy else None,
                "top_kernels_ms": top[:12]}
    del ts, params, opt, sharded
    if cuda:
        gc_collect()
    if check_grads:
        # Rank 0 takes the one-device step's first gradients on its card,
        # with the kernels (the ring: its schedule) and with the plain
        # attention, and compares; the others wait.
        if rank == 0:
            ref = one_device_grads(cfg, batch, seq, device,
                                   ring=_ring_chunks(name, world))
            out["grad_rel_l2"] = _rel_l2_by_leaf(first_grads, ref)
            first_grads = None
            if cuda:
                gc_collect()
            plain = one_device_grads(cfg, batch, seq, device, impl="xla")
            out["grad_floor_rel_l2"] = _rel_l2_by_leaf(plain, ref)
            del ref, plain
        del first_grads
        if cuda:
            gc_collect()
        dist.barrier()
    return out


def _in_world(rank, world, addr, device_type, results, work):
    """Join the world, run ``work()`` in it, leave; return (or put on
    ``results``) its numbers, or the traceback."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshBootstrap

    try:
        MeshBootstrap(addr, world, rank, local_rank=rank,
                      device_type=device_type).initialize()
        try:
            out = work()
        finally:
            dist.destroy_process_group()
    except BaseException:
        if results is None:
            raise
        import traceback
        results.put({"rank": rank, "error": traceback.format_exc()})
        return None
    if results is not None:
        results.put(out)
    return out


def dist_train_rank(rank, world, addr, device_type, layouts, results=None):
    """One rank of ``dist_train``: every layout in turn in one process
    group. One rank runs the one-device step alone: a layout's gradients
    are checked with more ranks than one."""
    return _in_world(rank, world, addr, device_type, results, lambda: {
        "rank": rank, "world": world, "layouts": {
            name: _run_dist_layout(name, layout, device_type, world > 1)
            for name, layout in layouts.items()}})


def run_dist_ranks(world, device_type, layouts, timeout_s=900,
                   rank_fn=dist_train_rank):
    """``rank_fn`` (``dist_train_rank`` or ``glue_dp_rank``) on ``world``
    spawned processes (one card each), or in this process for a world of
    one; rank-ordered results."""
    import multiprocessing

    addr = f"localhost:{_free_port()}"
    if world == 1:
        return [rank_fn(0, 1, addr, device_type, layouts)]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_fn,
                         args=(r, world, addr, device_type, layouts,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ranks = [results.get(timeout=timeout_s) for _ in range(world)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise RuntimeError(f"a {rank_fn.__name__} rank failed:\n"
                           + errors[0])
    return sorted(ranks, key=lambda r: r["rank"])


def _ring_chunks(name, world):
    """The chunks of the ring schedule a layout's one-device reference
    runs: the ring layout's, else None (the whole-sequence kernels)."""
    return world if name == "seq_ring" else None


def simulated_ring(size):
    """Attention with the ring's schedule on one card: the sequence in
    ``size`` chunks, every rank simulated in this process (the hop a list
    rotation), forward and backward through the ring's own ``ring_fwd`` and
    ``ring_bwd``, as ``size`` cards run them."""
    import torch

    from ray_tpu_torch.ops.flash_attention import attention_delta
    from ray_tpu_torch.ops.ring_attention import (ring_bwd, ring_fwd,
                                                  rotate_hop)

    ranks = range(size)

    def split(x):
        return list(x.chunk(size, dim=1))

    class Ring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            os_, lses = ring_fwd(split(q), split(k), split(v), ranks, size,
                                 rotate_hop, causal=causal, scale=scale)
            o = torch.cat(os_, 1)
            ctx.save_for_backward(q, k, v, o, *lses)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, g):
            q, k, v, o, *lses = ctx.saved_tensors
            dos = split(g.to(q.dtype))
            deltas = [attention_delta(d, x) for d, x in zip(dos, split(o))]
            grads = ring_bwd(split(q), split(k), split(v), dos, lses,
                             deltas, ranks, size, rotate_hop,
                             causal=ctx.causal, scale=ctx.scale)
            return tuple(torch.cat(g, 1) for g in grads) + (None, None)

    def attention(q, k, v, *, causal=True, scale=None):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        return Ring.apply(q, k, v, bool(causal), float(scale))

    return attention


@contextlib.contextmanager
def _one_device_attention(impl, ring):
    """``RTPU_ATTN_IMPL=impl`` for a block; with ``ring`` chunks, the
    kernels' attention runs the ring's schedule (``simulated_ring``)."""
    from ray_tpu_torch import flags
    from ray_tpu_torch.ops import attention as att

    kernels = att.flash_attention
    if ring:
        att.flash_attention = simulated_ring(ring)
    try:
        with flags.scoped({"RTPU_ATTN_IMPL": impl}):
            yield
    finally:
        att.flash_attention = kernels


def one_device_losses(cfg, batch, seq, device, steps, impl="auto",
                      ring=None):
    """The one-device step's first ``steps`` losses on dist_train's
    tokens (``impl``: ``RTPU_ATTN_IMPL``, "xla" for the plain attention;
    ``ring``: see ``_one_device_attention``): the reference of a layout
    with no other, or its rounding floor."""
    import torch

    from ray_tpu_torch.train.step import transformer_train_step

    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    tokens = {"tokens": _train_tokens(cfg, batch, seq, device)}
    losses = []
    with _one_device_attention(impl, ring):
        for _ in range(steps):
            params, opt, loss = ts.step(params, opt, tokens)
            losses.append(float(loss))
    del ts, params, opt
    gc_collect()
    return losses


def one_device_grads(cfg, batch, seq, device, impl="auto", ring=None):
    """The one-device step's first gradients, by leaf name (``impl`` and
    ``ring`` as in ``one_device_losses``)."""
    import torch

    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.train.step import param_leaves

    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    for t in param_leaves(params):
        t.requires_grad_(True)
    with _one_device_attention(impl, ring):
        loss_fn(params, {"tokens": _train_tokens(cfg, batch, seq, device)},
                cfg, shift_inputs=True).backward()
    return _leaf_grads(params)


def _rel_l2_by_leaf(got, want):
    return {k: float((g.float() - want[k].float()).norm()
                     / want[k].float().norm()) for k, g in got.items()}


def _leaf_grads(params):
    """Each leaf's gradient by name (DTensors gathered whole: every rank of
    their mesh calls this)."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        g = t.grad
        return g.full_tensor() if isinstance(g, DTensor) else g

    out = {k: whole(v) for k, v in params.items() if k != "layers"}
    out.update({"layers." + k: whole(v)
                for k, v in params["layers"].items()})
    return out


def check_dist_layouts(ranks, refs, floors, rtol):
    """Each layout's losses against its one-device reference (fsdp: every
    loss within ``rtol``; the others: the first two, then DIST_FLOOR_FACTOR
    times ``floors[name]``, the plain attention's relative distance at each
    step, and no less than ``rtol``) and the same on every rank, its
    first-step gradients against the one-device step's where rank 0
    measured them (DIST_FLOOR_FACTOR times the plain attention's distance,
    per leaf, and no more than DIST_GRAD_CAP), and each rank's launches
    against its schedule's. Returns (rows, failures)."""
    rows, failures = {}, []
    for name, ref in refs.items():
        lead = ranks[0]["layouts"][name]
        ref = ref[:len(lead["losses"])]
        rel = [abs(a - b) / abs(b) for a, b in zip(lead["losses"], ref)]
        floor = floors.get(name)
        bound = [rtol if i < 2 or name == "fsdp" or floor is None
                 else max(rtol, DIST_FLOOR_FACTOR * floor[i])
                 for i in range(len(rel))]
        grads = lead.get("grad_rel_l2")
        grad_floor = lead.get("grad_floor_rel_l2")
        if grads is not None:
            bounds = {k: min(DIST_FLOOR_FACTOR * f, DIST_GRAD_CAP)
                      for k, f in grad_floor.items()}
            over = {k: (g, bounds[k]) for k, g in grads.items()
                    if not g <= bounds[k]}
            if over:
                failures.append(f"{name}: first-step gradients against the "
                                f"one-device step's (leaf: (relative L2, "
                                f"bound)): {over}")
        for r in ranks:
            got = r["layouts"][name]
            if got["launches"] != got["launches_expected"]:
                failures.append(f"{name}: rank {r['rank']} launches "
                                f"{got['launches']}, expected "
                                f"{got['launches_expected']}")
            if got["losses"] != lead["losses"]:
                failures.append(f"{name}: rank {r['rank']} losses "
                                f"{got['losses']} differ from rank 0's")
        if not all(r <= b for r, b in zip(rel, bound)):
            failures.append(f"{name}: losses {lead['losses']} against the "
                            f"one-device {ref}: relative {rel} (bounds "
                            f"{bound})")
        rows[name] = {"losses": lead["losses"], "one_device_losses": ref,
                      "loss_rel_diff": rel, "loss_rel_bound": bound,
                      "loss_floor_rel": floor, "grad_rel_l2": grads,
                      "grad_floor_rel_l2": grad_floor,
                      "grad_over_floor_max": (
                          max(g / grad_floor[k] if grad_floor[k] else math.inf
                              for k, g in grads.items())
                          if grads else None),
                      "step_ms": lead["step_s"] * 1e3,
                      "launches_by_rank": [r["layouts"][name]["launches"]
                                           for r in ranks],
                      "peak_mem_gib_per_rank": [
                          r["layouts"][name].get("peak_mem_gib")
                          for r in ranks],
                      "local_tokens": lead["local_tokens"]}
    return rows, failures


def phase_dist_train(device, train_losses, train_step_s, moe_losses):
    """The mesh training path: bench_350m on an fsdp mesh of every visible
    card (up to 4); with 2 or more, also the seq (ring, Ulysses), expert
    (the MoE model) and pipe layouts, one after another in one process
    group."""
    import torch

    world = min(torch.cuda.device_count(), DIST_MAX_RANKS)
    names = DIST_LAYOUTS if world > 1 else ("fsdp",)
    layouts = dist_layouts(world, names)
    steps = DIST_WARM_STEPS + DIST_TIMED_STEPS
    refs = {"fsdp": train_losses, "pipe": train_losses,
            "expert": moe_losses}
    floors = {}
    if world > 1:
        long = layouts["seq_ring"][2:5]
        refs.update(
            seq_ring=one_device_losses(*long, device, steps,
                                       ring=_ring_chunks("seq_ring", world)),
            seq_ulysses=one_device_losses(*long, device, steps))
        # Each reference's rounding floor: its steps with the plain
        # attention, one run for each (config, batch, seq).
        plain = {}
        for name in names:
            key = repr(layouts[name][2:5])
            if key not in plain:
                plain[key] = one_device_losses(*layouts[name][2:5], device,
                                               steps, impl="xla")
            floors[name] = [abs(a - b) / abs(b) for a, b in
                            zip(plain[key], refs[name][:steps])]
    ranks = run_dist_ranks(world, "cuda", layouts)
    # On one card the mesh path runs the same bf16 model on the same whole
    # batch, so its losses must be train's exactly.
    rtol = DIST_LOSS_RTOL if world > 1 else 0.0
    rows, failures = check_dist_layouts(
        ranks, {n: refs[n] for n in names}, floors, rtol)
    lead = ranks[0]["layouts"]["fsdp"]
    emit("dist_train", ok=not failures, failures=failures,
         model="bench_350m", n_layers=layouts["fsdp"][2].n_layers,
         remat_policy="dots", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         mesh={"fsdp": world}, rules="RULES_FSDP", world=world,
         local_tokens=lead["local_tokens"], placements=lead["placements"],
         warm_steps=DIST_WARM_STEPS, timed_steps=DIST_TIMED_STEPS,
         losses=lead["losses"], train_losses=train_losses[:steps],
         loss_rel_diff=rows["fsdp"]["loss_rel_diff"], loss_rtol=rtol,
         loss_floor_rel=rows["fsdp"]["loss_floor_rel"],
         grad_rel_l2=rows["fsdp"]["grad_rel_l2"],
         grad_floor_rel_l2=rows["fsdp"]["grad_floor_rel_l2"],
         grad_over_floor_max=rows["fsdp"]["grad_over_floor_max"],
         floor_factor=DIST_FLOOR_FACTOR, grad_cap=DIST_GRAD_CAP,
         launches=lead["launches"],
         launches_per_step={k: v / steps for k, v in lead["launches"].items()},
         step_ms=lead["step_s"] * 1e3, train_step_ms=train_step_s * 1e3,
         step_ratio=lead["step_s"] / train_step_s,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / lead["step_s"],
         peak_mem_gib_per_rank=rows["fsdp"]["peak_mem_gib_per_rank"],
         profile=lead["profile"],
         layouts={n: r for n, r in rows.items() if n != "fsdp"})
    if world == 1:
        emit("dist_train_layouts", ok=True, ran=False, cards=world,
             layouts=[n for n in DIST_LAYOUTS if n != "fsdp"],
             reason="the seq, expert and pipe layouts need >= 2 cards")
    if failures:
        raise AssertionError("; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks[0]["layouts"].values())
            for k in lead["launches"]}


def phase_train_grad_check(device):
    """One step's gradients of bench_350m (depth 2) three ways: kernels in
    bf16, plain attention in bf16, plain attention in f32."""
    import torch

    from ray_tpu_torch import flags
    from ray_tpu_torch.models.configs import bench_350m
    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.train.step import param_leaves

    cfg = bench_350m(remat=True, remat_policy="dots",
                     n_layers=GRAD_CHECK_LAYERS)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    leaves = param_leaves(params)
    names = ([k for k in params if k != "layers"]
             + ["layers." + k for k in params["layers"]])
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": _train_tokens(cfg, GRAD_CHECK_BATCH, TRAIN_SEQ,
                                     device)}

    def grads(impl, c):
        with flags.scoped({"RTPU_ATTN_IMPL": impl}):
            loss = loss_fn(params, batch, c, shift_inputs=True)
            return torch.autograd.grad(loss, leaves)

    kernel = grads("auto", cfg)
    plain = grads("xla", cfg)
    f32 = grads("xla", dataclasses.replace(cfg, dtype=torch.float32))
    rows, failures = [], []
    for name, g_k, g_p, g_f in zip(names, kernel, plain, f32):
        row = {"leaf": name, "kernel_vs_plain": rel_l2(g_k, g_p),
               "kernel_vs_f32": rel_l2(g_k, g_f),
               "plain_vs_f32": rel_l2(g_p, g_f)}
        rows.append(row)
        if not (row["kernel_vs_plain"] <= TRAIN_GRAD_REL_L2
                and row["kernel_vs_f32"]
                <= TRAIN_GRAD_F32_RATIO * row["plain_vs_f32"]):
            failures.append(row)
    emit("train_grad_check", ok=not failures, model="bench_350m",
         n_layers=cfg.n_layers, batch=GRAD_CHECK_BATCH, seq=TRAIN_SEQ,
         rel_l2_tol=TRAIN_GRAD_REL_L2, f32_ratio_tol=TRAIN_GRAD_F32_RATIO,
         leaves=rows, failures=failures)
    if failures:
        raise AssertionError(f"gradients disagree: {failures}")


def phase_vit_infer(fa, device):
    """ViT-L/16 batch inference at full width and depth (f32 params, bf16
    compute) on seeded weights and images: K1 without a mask, 24 launches
    a forward."""
    import torch

    from ray_tpu_torch import flags
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.models.quantize import quantize_params_int8

    cfg = vit.vit_l16()
    torch.cuda.reset_peak_memory_stats(device)
    params = vit.init_params(
        torch.Generator(device=device).manual_seed(SEED), cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    images = {B: torch.randn(B, cfg.image_size, cfg.image_size, 3,
                             generator=gen, device=device)
              for B in VIT_BATCHES}
    failures, logits, per_forward = [], {}, {}
    _zero_launch_counts(fa)  # count the main path alone
    with torch.inference_mode():
        for B in VIT_BATCHES:
            before = fa.flash_attention_fwd.launches
            logits[B] = vit.forward(params, images[B], cfg)
            per_forward[B] = fa.flash_attention_fwd.launches - before
    launches = fa.flash_attention_fwd.launches
    for B in VIT_BATCHES:
        out = logits[B]
        if per_forward[B] != cfg.n_layers:
            failures.append(f"batch {B}: K1 launched {per_forward[B]} "
                            f"times, not {cfg.n_layers}")
        if (tuple(out.shape) != (B, cfg.num_classes)
                or out.dtype != torch.float32
                or not bool(torch.isfinite(out).all())):
            failures.append(f"batch {B}: logits {tuple(out.shape)} "
                            f"{out.dtype}, finite "
                            f"{bool(torch.isfinite(out).all())}")

    # Batch 64 against the plain attention (bf16) and the f32 forward; then
    # the int8-weight forward against the bf16 one.
    B = VIT_BATCHES[0]
    with torch.inference_mode():
        with flags.scoped({"RTPU_ATTN_IMPL": "xla"}):
            plain = vit.forward(params, images[B], cfg)
            f32 = vit.forward(params, images[B],
                              dataclasses.replace(cfg, dtype=torch.float32))
        q8 = vit.forward(quantize_params_int8(params), images[B], cfg)
    k1_vs_plain = rel_l2(logits[B], plain)
    k1_vs_f32, plain_vs_f32 = rel_l2(logits[B], f32), rel_l2(plain, f32)
    int8_vs_bf16 = rel_l2(q8, logits[B])
    if not (k1_vs_plain <= LOGITS_REL_L2
            and k1_vs_f32 <= LOGITS_F32_RATIO * plain_vs_f32):
        failures.append(f"logits: K1 vs plain {k1_vs_plain} (tol "
                        f"{LOGITS_REL_L2}); vs f32 K1 {k1_vs_f32}, plain "
                        f"{plain_vs_f32} (ratio tol {LOGITS_F32_RATIO})")
    if not (bool(torch.isfinite(q8).all())
            and int8_vs_bf16 <= VIT_INT8_REL_L2):
        failures.append(f"int8 logits: {int8_vs_bf16} from bf16 (tol "
                        f"{VIT_INT8_REL_L2})")

    # Host clock over synchronised forwards, after the run above warmed up.
    rows = []
    for B in VIT_BATCHES:
        times = []
        with torch.inference_mode():
            for _ in range(VIT_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                vit.forward(params, images[B], cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        ms = statistics.median(times)
        rows.append({"batch": B, "ms_median": ms, "ms": times,
                     "images_per_s": B * 1e3 / ms})
    with torch.inference_mode():
        busy, top = _device_profile(
            lambda: vit.forward(params, images[VIT_BATCHES[0]], cfg))
    unprofiled = rows[0]["ms_median"]
    k1_ms = sum(ms for name, ms in top if "flash_fwd" in name)
    emit("vit_infer", ok=not failures, failures=failures, model="vit_l16",
         num_params=cfg.num_params(), n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads, seq=cfg.num_patches + 1,
         k1_launches=launches, k1_launches_per_forward=per_forward,
         k1_vs_plain_rel_l2=k1_vs_plain, tol=LOGITS_REL_L2,
         k1_vs_f32_rel_l2=k1_vs_f32, plain_vs_f32_rel_l2=plain_vs_f32,
         f32_ratio_tol=LOGITS_F32_RATIO, int8_vs_bf16_rel_l2=int8_vs_bf16,
         int8_tol=VIT_INT8_REL_L2, timed=rows,
         profile={"batch": VIT_BATCHES[0], "busy_ms": busy,
                  "unprofiled_ms": unprofiled,
                  "idle_share": 1 - busy / unprofiled if busy else None,
                  "k1_share_of_busy": k1_ms / busy if busy else None,
                  "top_kernels_ms": top[:6]},
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, rows[0]["images_per_s"]


def data_images(batch):
    """data_infer's task UDF: each row's uint8 image from
    ``default_rng(SEED + id)``."""
    import numpy as np

    from ray_tpu_torch.models.vit import vit_l16

    size = vit_l16().image_size
    return {"id": batch["id"], "image": np.stack([
        np.random.default_rng(SEED + int(i)).integers(
            0, 256, (size, size, 3), dtype=np.uint8) for i in batch["id"]])}


def vit_l16_forward(params, images):
    """The pool workers' ``apply_fn``: ViT-L/16 (f32 params, bf16
    compute) at DATA_VIT_LAYERS layers."""
    from ray_tpu_torch.models import vit

    return vit.forward(params, images, vit.vit_l16(n_layers=DATA_VIT_LAYERS))


class ExitOnFirstBatch:
    """data_infer's injected failure: a pool worker that leaves with exit
    code 3 on its first batch."""

    def __call__(self, batch):
        import os

        os._exit(3)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _pool_row(stats):
    return next(o for o in stats.to_dict()["operators"]
                if o["operator"].startswith("ActorPool["))


def phase_data_infer(device, in_process_images_per_s):
    """BASELINE config 5 through the data layer: ``range`` -> a task-stage
    ``map_batches`` (seeded uint8 images) -> ``ImageNormalizer`` ->
    ``BatchPredictor(TorchPredictor)`` over ViT-L/16, one pool worker a
    visible card (up to 4) running K1 -> ``take_all``; then the same
    normalised dataset through ``iter_device_batches`` onto card 0."""
    import os

    import numpy as np
    import torch

    import ray_tpu_torch.data as rd
    from ray_tpu_torch import flags
    from ray_tpu_torch.data.executor import PoolWorkerDiedError
    from ray_tpu_torch.data.preprocessors import ImageNormalizer
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    cfg = vit.vit_l16(n_layers=DATA_VIT_LAYERS)
    workers = min(torch.cuda.device_count(), DATA_MAX_WORKERS)
    n_rows, n_blocks = DATA_ROWS * workers, DATA_BLOCKS * workers
    block_rows = n_rows // n_blocks
    batches = n_rows // DATA_BATCH
    failures = []
    params = vit.init_params(
        torch.Generator(device=device).manual_seed(SEED), cfg, device)
    host_params = _tree_to(params, "cpu")
    del params
    gc_collect()
    ckpt = Checkpoint.from_dict({"params": host_params})
    normalized = ImageNormalizer().transform(
        rd.range(n_rows, parallelism=n_blocks).map_batches(
            data_images))
    predicted = BatchPredictor(
        ckpt, TorchPredictor, apply_fn=vit_l16_forward,
        input_column="image").predict(
            normalized, batch_size=DATA_BATCH, min_scoring_workers=workers,
            max_scoring_workers=workers, num_gpus_per_actor=1)
    _zero_launch_counts(fa)  # this process launches nothing in the pool
    t0 = time.perf_counter()
    rows = predicted.take_all()
    take_all_s = time.perf_counter() - t0
    if fa.flash_attention_fwd.launches:
        failures.append("this process launched K1 during the pool's run")
    _no_workers_left(failures, "data_infer's pool")
    pool = _pool_row(predicted.stats())
    ids = [int(r["id"]) for r in rows]
    if ids != list(range(n_rows)):
        failures.append(f"ids out: {len(ids)} rows, in order and each "
                        f"once: {ids == list(range(n_rows))}")
    logits = np.stack([r["predictions"] for r in rows])
    del rows
    if (logits.shape != (n_rows, cfg.num_classes)
            or logits.dtype != np.float32 or not np.isfinite(logits).all()):
        failures.append(f"logits {logits.shape} {logits.dtype}, finite "
                        f"{bool(np.isfinite(logits).all())}")
    meters = pool["actor_pool"]["workers"]
    per_worker = []
    for w in meters:
        k1 = w.get("kernel_launches", {}).get("flash_fwd")
        if k1 != cfg.n_layers * w.get("batches", -1):
            failures.append(f"worker {w['slot']} (card {w['card']}): K1 "
                            f"{k1} launches for {w.get('batches')} batches")
        per_worker.append({
            "slot": w["slot"], "card": w["card"], "pid": w["pid"],
            "batches": w.get("batches"), "blocks": w.get("blocks"),
            "k1_launches": k1, "spawn_s": w["spawn_s"],
            "load_s": w["init_s"], "udf_s": w.get("udf_s"),
            "first_block_udf_s": w.get("first_block_udf_s"),
            "udf_share_of_wall": w.get("udf_s", 0) / pool["wall_s"],
            # Its UDF a batch after its first block (the forward in
            # process is vit_infer's ms at batch 64).
            "udf_ms_a_batch_after_first": 1e3 * (
                w.get("udf_s", 0) - w.get("first_block_udf_s", 0))
            / max(1, (w.get("batches") or 0) - block_rows // DATA_BATCH),
            "recv_s": w.get("recv_s"), "send_s": w.get("send_s"),
            "peak_card_gib": (w.get("peak_card_bytes") or 0) / 2 ** 30})
    pool_launches = sum(w["k1_launches"] or 0 for w in per_worker)
    if (pool_launches != cfg.n_layers * batches
            or sum(w["batches"] or 0 for w in per_worker) != batches
            or len(per_worker) != workers
            or sorted(w["card"] for w in per_worker) != list(range(workers))):
        failures.append(f"pool: {len(per_worker)} workers on cards "
                        f"{[w['card'] for w in per_worker]}, K1 "
                        f"{pool_launches} launches, not "
                        f"{cfg.n_layers * batches}")
    # Blocks go to the least-loaded worker, ties to the first: block i <
    # workers is worker i's first, and with preserve_order the workers-th
    # block out is the last of the first round. Steady: the rows after it
    # over the time from it to the last block out.
    out_s = pool["block_out_s"]
    if len(out_s) != n_blocks:
        failures.append(f"pool: {len(out_s)} blocks out, not {n_blocks}")
    first_s = out_s[0]
    round_s = out_s[workers - 1]
    steady = (n_rows - workers * block_rows) / max(1e-9, out_s[-1] - round_s)

    # The witness: the same batches through vit.forward here on card 0,
    # after the pool has gone.
    params = _tree_to(host_params, device)
    norm = ImageNormalizer()
    bitwise, worst = 0, 0.0
    with torch.inference_mode():
        for b in range(batches):
            ids_b = np.arange(b * DATA_BATCH, (b + 1) * DATA_BATCH)
            x = norm.transform_batch(data_images({"id": ids_b}))["image"]
            want = vit.forward(params, torch.from_numpy(x).to(device),
                               cfg).cpu().numpy()
            got = logits[b * DATA_BATCH:(b + 1) * DATA_BATCH]
            if np.array_equal(got, want):
                bitwise += 1
            else:
                worst = max(worst, float(np.linalg.norm(got - want)
                                         / np.linalg.norm(want)))
    if bitwise != batches and (workers == 1 or worst > DATA_MULTI_REL_L2):
        failures.append(f"witness: {bitwise} of {batches} batches bit for "
                        f"bit, the worst other {worst} relative L2 (tol "
                        f"{'0' if workers == 1 else DATA_MULTI_REL_L2})")

    # iter_device_batches onto card 0: pass 1 checks every batch against
    # its numpy counterpart and its logits against the pool's; pass 2
    # times the forwards on batches already there; pass 3 the stream with
    # the forwards, pass 4 without (copy GB/s).
    held = normalized.materialize()
    _zero_launch_counts(fa)
    on_card, exact, same_logits = [], 0, 0
    with torch.inference_mode():
        for b, batch in enumerate(held.iter_device_batches(
                batch_size=DATA_BATCH, device=device,
                prefetch=DATA_PREFETCH)):
            ids_b = np.arange(b * DATA_BATCH, (b + 1) * DATA_BATCH)
            want = norm.transform_batch(data_images({"id": ids_b}))["image"]
            exact += int(np.array_equal(batch["image"].cpu().numpy(), want)
                         and np.array_equal(batch["id"].cpu().numpy(),
                                            ids_b))
            out = vit.forward(params, batch["image"], cfg).cpu().numpy()
            same_logits += int(np.array_equal(
                out, logits[b * DATA_BATCH:(b + 1) * DATA_BATCH])
                or workers > 1 and float(np.linalg.norm(
                    out - logits[b * DATA_BATCH:(b + 1) * DATA_BATCH])
                    / np.linalg.norm(out)) <= DATA_MULTI_REL_L2)
            on_card.append(batch["image"])
    leg_launches = fa.flash_attention_fwd.launches
    if (len(on_card) != batches or exact != batches
            or same_logits != batches
            or leg_launches != cfg.n_layers * batches):
        failures.append(f"iter_device_batches: {len(on_card)} batches, "
                        f"{exact} exact, {same_logits} with the pool's "
                        f"logits, K1 {leg_launches} launches")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x in on_card:
            vit.forward(params, x, cfg)
        torch.cuda.synchronize()
        forwards_s = time.perf_counter() - t
        del on_card
        t = time.perf_counter()
        for batch in held.iter_device_batches(
                batch_size=DATA_BATCH, device=device,
                prefetch=DATA_PREFETCH):
            vit.forward(params, batch["image"], cfg)
        torch.cuda.synchronize()
        fed_s = time.perf_counter() - t
        t = time.perf_counter()
        moved = 0
        for batch in held.iter_device_batches(
                batch_size=DATA_BATCH, device=device,
                prefetch=DATA_PREFETCH):
            moved += sum(v.numel() * v.element_size()
                         for v in batch.values())
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t
    del held, params

    # An injected failure: a card worker that dies on its first batch,
    # with RTPU_DATA_FT off, fails the stage and leaves no process.
    with flags.scoped({"RTPU_DATA_FT": "0"}):
        try:
            rd.range(DATA_BATCH, parallelism=1).map_batches(
                ExitOnFirstBatch, concurrency=1, num_gpus=1).take_all()
            failures.append("the injected failure did not fail the stage")
        except PoolWorkerDiedError as e:
            if e.exitcode != 3:
                failures.append(f"injected failure: {e}")
    _no_workers_left(failures, "data_infer's injected failure")
    if os.path.isdir(ckpt.path):
        import shutil

        shutil.rmtree(ckpt.path)
    emit("data_infer", ok=not failures, failures=failures, model="vit_l16",
         card=card_line(), workers=workers, rows=n_rows,
         blocks=n_blocks, batch=DATA_BATCH,
         take_all_s=take_all_s,
         split={"pool_wall_s": pool["wall_s"],
                "pool_ready_s": pool["ready_s"],
                "spawn_s": max(w["spawn_s"] for w in per_worker),
                "load_s": max(w["load_s"] for w in per_worker),
                "first_block_s": first_s,
                "first_round_s": round_s,
                "steady_images_per_s": steady,
                "images_per_s_whole": n_rows / take_all_s,
                "vit_infer_images_per_s_batch64": in_process_images_per_s},
         driver_send_s=pool["driver_send_s"],
         driver_recv_s=pool["driver_recv_s"],
         pool_utilization=pool["actor_pool"]["utilization"],
         pool_workers=per_worker, k1_launches_pool=pool_launches,
         witness={"bitwise_batches": bitwise, "batches": batches,
                  "worst_rel_l2": worst},
         device_batches={"batches": batches, "exact": exact,
                         "logits_equal_pool": same_logits,
                         "k1_launches": leg_launches,
                         "prefetch": DATA_PREFETCH,
                         "copy_gb_per_s": moved / copy_s / 1e9,
                         "copy_s": copy_s, "fed_forwards_s": fed_s,
                         "forwards_alone_s": forwards_s,
                         "idle_share": 1 - forwards_s / fed_s})
    if failures:
        raise AssertionError("; ".join(failures))
    return pool_launches + leg_launches


def phase_ppo_train(device):
    """PPO with the default Nature-CNN module on the Atari-shaped
    CnnRolloutBenchEnv (84x84x4 uint8): the local runner's policy and the
    learner on the card."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.core.learner import tree_leaves, tree_map
    from ray_tpu_torch.rllib.env.vector_env import CnnRolloutBenchEnv

    creator = batched_creator(CnnRolloutBenchEnv)
    batch = PPO_ENVS * PPO_FRAGMENT
    minibatches = PPO_EPOCHS * (batch // PPO_MINIBATCH)
    torch.cuda.reset_peak_memory_stats(device)
    algo = (PPOConfig().environment(env_creator=creator)
            .env_runners(num_envs_per_env_runner=PPO_ENVS,
                         rollout_fragment_length=PPO_FRAGMENT)
            .training(train_batch_size=batch, minibatch_size=PPO_MINIBATCH,
                      num_epochs=PPO_EPOCHS)
            .debugging(seed=SEED).build())
    try:
        learner = algo.learner_group.learner
        runner = algo.env_runner_group.local_runner
        before = learner.get_weights()
        results = [algo.train()]  # warm-up
        t0 = time.perf_counter()
        results += [algo.train() for _ in range(PPO_TIMED_ITERS)]
        wall = time.perf_counter() - t0
        after = learner.get_weights()
        failures = []
        for r in results:
            if not (np.isfinite(r["total_loss"])
                    and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
                failures.append(f"iteration {r['training_iteration']}: loss "
                                f"{r['total_loss']}, grad_norm "
                                f"{r['grad_norm']}")
        if all(np.array_equal(a, b) for a, b in zip(tree_leaves(before),
                                                     tree_leaves(after))):
            failures.append("the learner's weights did not change")
        steps = results[-1]["timesteps_total"]
        if steps != batch * len(results):
            failures.append(f"{steps} env steps counted, not "
                            f"{batch * len(results)}")
        if learner.device.type != "cuda" or runner.device.type != "cuda":
            failures.append(f"learner on {learner.device}, runner on "
                            f"{runner.device}")
        # The card's policy against the same params on the CPU.
        obs = CnnRolloutBenchEnv(PPO_ENVS, seed=SEED + 1).reset()
        with torch.no_grad():
            on_card = runner.module.forward(
                runner.params, torch.from_numpy(obs).to(device))["logits"]
            on_cpu = runner.module.forward(
                tree_map(lambda t: t.cpu(), runner.params),
                torch.from_numpy(obs))["logits"]
        policy_rel = rel_l2(on_card.cpu(), on_cpu)
        if not policy_rel <= PPO_POLICY_REL_L2:
            failures.append(f"policy logits: card vs CPU {policy_rel} (tol "
                            f"{PPO_POLICY_REL_L2})")
        timed = results[1:]
        learner_rel, learner_rel_tf32, learner_rel_stored, relu_flips = (
            _ppo_learner_check(algo, learner, device))
        if not learner_rel <= PPO_LEARNER_REL_L2:
            failures.append(f"learner update: card vs CPU {learner_rel} "
                            f"(tol {PPO_LEARNER_REL_L2})")
        sample_s = sum(r["sample_time_s"] for r in timed)
        learn_s = sum(r["learn_time_s"] for r in timed)
        iter_s = wall / PPO_TIMED_ITERS
        busy, top = _device_profile(algo.train)
        emit("ppo_train", ok=not failures, failures=failures,
             module="CNNModule (NATURE_CONV, hidden 512)",
             env="CnnRolloutBenchEnv", obs=[84, 84, 4], num_envs=PPO_ENVS,
             fragment=PPO_FRAGMENT, train_batch=batch,
             minibatch=PPO_MINIBATCH, epochs=PPO_EPOCHS,
             minibatches_per_iter=minibatches,
             devices={"runner": str(runner.device),
                      "learner": str(learner.device)},
             results=[{k: r[k] for k in (
                 "training_iteration", "total_loss", "policy_loss",
                 "vf_loss", "entropy", "approx_kl", "grad_norm",
                 "sample_time_s", "learn_time_s", "time_this_iter_s",
                 "timesteps_total")} for r in results],
             iter_ms=iter_s * 1e3,
             env_steps_per_s=batch / iter_s,
             sample_env_steps_per_s=batch * PPO_TIMED_ITERS / sample_s,
             learner_ms_per_minibatch=learn_s * 1e3 / (
                 minibatches * PPO_TIMED_ITERS),
             sample_share=sample_s / wall, learn_share=learn_s / wall,
             policy_card_vs_cpu_rel_l2=policy_rel, tol=PPO_POLICY_REL_L2,
             learner_update_card_vs_cpu_rel_l2=learner_rel,
             learner_update_tol=PPO_LEARNER_REL_L2,
             learner_update_tf32_card_vs_cpu_rel_l2=learner_rel_tf32,
             learner_update_stored_card_vs_cpu_rel_l2=learner_rel_stored,
             learner_update_relu_flips=relu_flips,
             profile={"busy_ms": busy, "unprofiled_ms": iter_s * 1e3,
                      "idle_share": 1 - busy / (iter_s * 1e3)
                      if busy else None,
                      "top_kernels_ms": top[:8]},
             peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    finally:
        algo.stop()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"iter_ms": iter_s * 1e3, "env_steps_per_s": batch / iter_s,
            "sample_env_steps_per_s": batch * PPO_TIMED_ITERS / sample_s,
            "sample_share": sample_s / wall, "learn_share": learn_s / wall}


@contextlib.contextmanager
def shared_relu_masks(masks, replay=True):
    """``torch.relu`` as ``x * mask`` for the block. With ``masks`` empty,
    each call's mask (``x > 0``) is appended to it; otherwise the calls
    take theirs from it in order (each its own with ``replay`` false), and
    the yielded list gathers, per call, how many of those decisions differ
    from the call's own. Two f32 runs of a ReLU net differ in a
    pre-activation's last bits, and where one lies that close to 0 its
    gradient takes the row's whole term on one side and none on the
    other: one such flip in the trunk moves the trunk's update by 1e-3
    after 3 Adam steps. Replaying one side's decisions on the other leaves
    the comparison to read the arithmetic."""
    from unittest import mock

    import torch

    record = not masks
    recorded = iter(list(masks))
    flips = []

    def relu(x):
        mask = x > 0
        if record:
            masks.append(mask)
        else:
            theirs = next(recorded).to(x.device)
            flips.append((theirs != mask).sum())
            if replay:
                mask = theirs
        return x * mask

    with mock.patch.object(torch, "relu", relu):
        yield flips


def _ppo_learner_check(algo, learner, device):
    """The parameter change of PPO_CHECK_STEPS learner updates on one fixed
    on-policy batch (shuffle off), on the card against the CPU, both from
    the learner's state and with the CPU's ReLU decisions
    (:func:`shared_relu_masks`): the worst relative L2 per leaf of the
    change Adam applied (:func:`applied_change`). Then the same on the
    card with cuDNN's TF32 allowed in the convs and their gradients (the
    port keeps it off), to show what the bound tells apart. Returns the
    f32 reading, the TF32 reading, the f32 reading of the stored
    parameters' change, and how many ReLU decisions of the card's f32 run
    differed from the CPU's."""
    from unittest import mock

    import torch

    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rllib.core import catalog
    from ray_tpu_torch.rllib.core.learner import tree_leaves
    from ray_tpu_torch.rllib.utils.rollout import fragments_to_ppo_batch

    cfg = algo._algo_config.copy().training(lr=PPO_CHECK_LR)
    state = learner.get_state()
    # On-policy: the ratio starts at 1, away from PPO's clip.
    algo.env_runner_group.sync_weights(state["params"])
    frags = algo.env_runner_group.sample_fragments(PPO_FRAGMENT)
    batch = fragments_to_ppo_batch(frags, gamma=cfg.gamma, lam=cfg.lambda_)
    rows = PPO_CHECK_MINIBATCH * PPO_CHECK_STEPS
    batch = {k: v[:rows] for k, v in batch.items()}
    start = tree_leaves(state["params"])
    masks = []

    def change(dev):
        other = PPOLearner(learner.module, cfg, device=dev)
        other.set_state(state)
        applied = applied_change(other)
        with shared_relu_masks(masks) as flips:
            other.update(batch, minibatch_size=PPO_CHECK_MINIBATCH,
                         shuffle=False)
        return applied, [torch.from_numpy(w - s) for w, s in zip(
            tree_leaves(other.get_weights()), start)], int(sum(flips))

    def tf32_convs():
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=True)

    want = change("cpu")
    f32 = change(device)
    with mock.patch.object(catalog, "f32_convs", tf32_convs):
        tf32 = change(device)
    return (change_rel_l2(f32[0], want[0]), change_rel_l2(tf32[0], want[0]),
            change_rel_l2(f32[1], want[1]), f32[2])


def _delta(after, before, n=1):
    """``(after - before) / n`` per number of two meters (nested dicts
    too)."""
    return {k: (_delta(v, before.get(k, {}), n) if isinstance(v, dict)
                else (v - before.get(k, 0.0)) / n)
            for k, v in after.items() if isinstance(v, (dict, float, int))}


def _worst_change_rel(got, want, start):
    """The worst relative L2 per leaf between two parameter changes from
    ``start`` (numpy trees)."""
    import torch

    from ray_tpu_torch.rllib.core.learner import tree_leaves

    s = tree_leaves(start)
    return change_rel_l2(
        [torch.from_numpy(a - b) for a, b in zip(tree_leaves(got), s)],
        [torch.from_numpy(a - b) for a, b in zip(tree_leaves(want), s)])


class DeterministicConvs:
    """A learner factory: ``factory``'s learner, built after cuDNN is held
    to its deterministic algorithms in the process (picklable: it reaches
    a learner process)."""

    def __init__(self, factory):
        self.factory = factory

    def __call__(self):
        import torch

        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        return self.factory()


def _remote_learner_check(algo, device, deterministic=True):
    """A learner process's update of one fixed on-policy batch
    (PPO_CHECK_STEPS minibatches, shuffle off) from the run's learner
    state, against PPO_REMOTE_CHECK_RUNS updates by learners in this
    process, all from the algorithm's learner factory with cuDNN's
    deterministic algorithms (its defaults with ``deterministic`` false),
    and against one in-process update that skips the last minibatch.
    Returns the worst relative L2 per leaf of the parameter change and the
    largest relative difference of an update metric (relative to the
    larger of the value and 1e-3), each as {"process": to the nearest
    in-process run, "in_process": the largest gap between two in-process
    runs, "skipped_minibatch": the planted fault's}."""
    import torch

    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.utils.rollout import fragments_to_ppo_batch

    cfg = algo._algo_config
    state = algo.learner_group.get_state()
    algo.env_runner_group.sync_weights(state["params"])
    frags = algo.env_runner_group.sample_fragments(PPO_FRAGMENT)
    batch = fragments_to_ppo_batch(frags, gamma=cfg.gamma, lam=cfg.lambda_)
    rows = PPO_CHECK_MINIBATCH * PPO_CHECK_STEPS
    batch = {k: v[:rows] for k, v in batch.items()}
    factory = algo._learner_factory()
    group = LearnerGroup(DeterministicConvs(factory) if deterministic
                         else factory, num_learners=1, device=device)
    try:
        group.set_state(state)
        remote = (group.update(batch, minibatch_size=PPO_CHECK_MINIBATCH,
                               shuffle=False), group.get_weights())
    finally:
        group.shutdown()
    cudnn = torch.backends.cudnn
    local = []
    with cudnn.flags(enabled=cudnn.enabled,
                     benchmark=cudnn.benchmark and not deterministic,
                     deterministic=deterministic or cudnn.deterministic,
                     allow_tf32=cudnn.allow_tf32):
        for n in [rows] * PPO_REMOTE_CHECK_RUNS + [
                rows - PPO_CHECK_MINIBATCH]:
            other = factory()
            other.set_state(state)
            metrics = other.update({k: v[:n] for k, v in batch.items()},
                                   minibatch_size=PPO_CHECK_MINIBATCH,
                                   shuffle=False)
            local.append((metrics, other.get_weights()))
            del other
    *runs, skipped = local
    start = state["params"]

    def gaps(a, b):
        return (_worst_change_rel(a[1], b[1], start),
                max(abs(a[0][k] - v) / max(abs(v), 1e-3)
                    for k, v in b[0].items()))

    pairs = [gaps(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
    near = [gaps(remote, b) for b in runs]
    out = {"process": [min(g[j] for g in near) for j in (0, 1)],
           "in_process": [max(g[j] for g in pairs) for j in (0, 1)],
           "skipped_minibatch": list(gaps(skipped, runs[0]))}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def _card_runner_check(weights):
    """One card runner process (``runner_resources={"num_gpus": 1}``,
    PPO_ENVS envs) against the in-process card runner with the same
    worker index, seed and weights: the keys whose fragments differ (none
    expected) and the runner process's device."""
    import numpy as np

    from ray_tpu_torch.rllib.algorithm import ModuleFactory
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
    from ray_tpu_torch.rllib.env.vector_env import CnnRolloutBenchEnv

    creator = batched_creator(CnnRolloutBenchEnv)
    module = ModuleFactory(creator, {})
    group = EnvRunnerGroup(creator, module, num_runners=1,
                           num_envs_per_runner=PPO_ENVS, seed=SEED,
                           runner_resources={"num_gpus": 1})
    try:
        ref = SingleAgentEnvRunner(creator, module, num_envs=PPO_ENVS,
                                   seed=SEED, worker_index=1, device="cuda")
        ref.set_weights(weights)
        group.sync_weights(weights)
        got = group.sample_fragments(PPO_FRAGMENT)
        want = ref.sample_fragment(PPO_FRAGMENT)
        info = group.manager.foreach_actor("process_info")
        differ = (["the runner process failed"] if len(got) != 1 else
                  [k for k in want if not np.array_equal(
                      np.asarray(got[0][k]), np.asarray(want[k]))])
        device = info[0][1]["device"] if info else None
    finally:
        group.stop()
    return differ, device


def phase_ppo_remote(device, in_process):
    """BASELINE config 4 at its shape on the fleet: PPO, the Nature CNN on
    CnnRolloutBenchEnv, PPO_RUNNERS CPU runner processes of PPO_RUNNER_ENVS
    envs, the learner in a learner process on the card."""
    import multiprocessing
    import os
    import signal

    import numpy as np

    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.core.learner import tree_leaves
    from ray_tpu_torch.rllib.env.vector_env import CnnRolloutBenchEnv

    batch = PPO_RUNNERS * PPO_RUNNER_ENVS * PPO_FRAGMENT
    t0 = time.perf_counter()
    algo = (PPOConfig()
            .environment(env_creator=batched_creator(CnnRolloutBenchEnv))
            .env_runners(num_env_runners=PPO_RUNNERS,
                         num_envs_per_env_runner=PPO_RUNNER_ENVS,
                         rollout_fragment_length=PPO_FRAGMENT)
            .learners(num_learners=1)
            .training(train_batch_size=batch, minibatch_size=PPO_MINIBATCH,
                      num_epochs=PPO_EPOCHS)
            .debugging(seed=SEED).build())
    build_s = time.perf_counter() - t0
    failures = []
    try:
        manager = algo.env_runner_group.manager
        learner = algo.learner_group.actor
        before = algo.learner_group.get_weights()
        results = [algo.train()]  # warm-up: the runners' spawn and CUDA's
        info0 = dict(manager.foreach_actor("process_info"))
        linfo0 = learner.call("process_info")
        io0, lio0 = manager.io(), learner.io()
        t0 = time.perf_counter()
        results += [algo.train() for _ in range(PPO_TIMED_ITERS)]
        wall = time.perf_counter() - t0
        info = dict(manager.foreach_actor("process_info"))
        linfo = learner.call("process_info")
        io, lio = manager.io(), learner.io()
        after = algo.learner_group.get_weights()
        spawn_s = [manager.actor(i).spawn_s for i in sorted(info)] + [
            learner.spawn_s]
        for r in results:
            if r["env_steps_this_iter"] != batch or not (
                    np.isfinite(r["total_loss"]) and r["grad_norm"] > 0):
                failures.append(
                    f"iteration {r['training_iteration']}: "
                    f"{r['env_steps_this_iter']} env steps (not {batch}), "
                    f"loss {r['total_loss']}, grad_norm {r['grad_norm']}")
        if all(np.array_equal(a, b) for a, b in zip(tree_leaves(before),
                                                     tree_leaves(after))):
            failures.append("the learner's weights did not change")
        if not str(linfo["device"]).startswith("cuda"):
            failures.append(f"the learner process on {linfo['device']}")
        if sorted(info) != list(range(PPO_RUNNERS)) or any(
                i["device"] != "cpu" or i["cuda_initialized"]
                or i["num_threads"] != 1 for i in info.values()):
            failures.append(f"runners: {info}")
        change_gap, metric_gap = _remote_learner_check(algo, device)
        for what, gap in (("parameter change", change_gap),
                          ("update metrics", metric_gap)):
            if not (gap["process"] <= gap["in_process"]
                    < gap["skipped_minibatch"]):
                failures.append(
                    f"learner process update vs in-process, {what}: "
                    f"{gap['process']} (in-process runs apart by at most "
                    f"{gap['in_process']}; one minibatch skipped "
                    f"{gap['skipped_minibatch']})")
        # A runner killed between iterations: the next iteration samples
        # on the 3 others, and the one after on all 4 again.
        os.kill(manager.actor(0).pid, signal.SIGKILL)
        manager.actor(0).proc.join(10)
        t1 = time.perf_counter()
        killed = [algo.train() for _ in range(2)]
        recovery_s = time.perf_counter() - t1
        counts = [r["env_steps_this_iter"] for r in killed]
        want = [batch - PPO_RUNNER_ENVS * PPO_FRAGMENT, batch]
        healthy = manager.healthy_actor_ids()
        if counts != want or healthy != list(range(PPO_RUNNERS)):
            failures.append(f"after a runner's death: {counts} env steps "
                            f"(not {want}), healthy {healthy}")
        spawn_s.append(manager.actor(0).spawn_s)
        weights = algo.learner_group.get_weights()
    finally:
        algo.stop()
    _no_workers_left(failures, "ppo_remote's stop()")
    differ, card_runner = _card_runner_check(weights)
    if differ or not str(card_runner).startswith("cuda"):
        failures.append(f"card runner process on {card_runner}: fragment "
                        f"columns {differ} differ from the in-process "
                        "runner's")
    _no_workers_left(failures, "the card runner's stop()")
    timed = results[1:]
    sample_s = sum(r["sample_time_s"] for r in timed)
    learn_s = sum(r["learn_time_s"] for r in timed)
    iter_s = wall / PPO_TIMED_ITERS
    n = PPO_TIMED_ITERS
    runner_sample_s = {i: _delta(info[i], info0[i], n)["call_s"].get(
        "sample_fragment", 0.0) for i in sorted(info)}
    emit("ppo_remote", ok=not failures, failures=failures,
         module="CNNModule (NATURE_CONV, hidden 512)",
         env="CnnRolloutBenchEnv", obs=[84, 84, 4], runners=PPO_RUNNERS,
         envs_per_runner=PPO_RUNNER_ENVS, fragment=PPO_FRAGMENT,
         train_batch=batch, minibatch=PPO_MINIBATCH, epochs=PPO_EPOCHS,
         devices={"runners": "cpu (1 thread each)",
                  "learner": linfo["device"]},
         results=[{k: r[k] for k in (
             "training_iteration", "total_loss", "grad_norm",
             "env_steps_this_iter", "sample_time_s", "learn_time_s",
             "time_this_iter_s")} for r in results + killed],
         iter_ms=iter_s * 1e3, env_steps_per_s=batch / iter_s,
         sample_env_steps_per_s=batch * PPO_TIMED_ITERS / sample_s,
         sample_share=sample_s / wall, learn_share=learn_s / wall,
         sample_s_per_iter=sample_s / n, learn_s_per_iter=learn_s / n,
         rest_s_per_iter=(wall - sample_s - learn_s) / n,
         runner_sample_s_per_iter=runner_sample_s,
         moving_s_per_iter={
             "driver_runners": _delta(io, io0, n),
             "runners_send": {i: _delta(info[i], info0[i], n)["send_s"]
                              for i in sorted(info)},
             "driver_learner": _delta(lio, lio0, n),
             "learner_recv": _delta(linfo, linfo0, n)["recv_s"]},
         learner_update_s_per_iter=_delta(linfo, linfo0, n)["call_s"].get(
             "update", 0.0),
         build_s=build_s, spawn_s=spawn_s, slowest_spawn_s=max(
             s for s in spawn_s if s is not None),
         recovery_counts=counts, recovery_s=recovery_s,
         learner_check={"change_rel_l2": change_gap,
                        "metrics_rel": metric_gap,
                        "cudnn": "deterministic"},
         card_runner={"device": card_runner, "differing_columns": differ},
         cpu_count=os.cpu_count(), in_process=in_process,
         profile="not measured (the learner runs in another process)")
    if failures:
        raise AssertionError("; ".join(failures))


def phase_impala_async(device):
    """IMPALA's asynchronous sampling on IMPALA_RUNNERS CPU runner
    processes of IMPALA_ENVS CartPoleBatchedEnv columns, the learner on
    the card in this process; then APPO."""
    import os
    import signal

    import numpy as np

    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
    from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv

    def build(config):
        return (config.environment(
            env_creator=batched_creator(CartPoleBatchedEnv))
            .env_runners(num_env_runners=IMPALA_RUNNERS,
                         num_envs_per_env_runner=IMPALA_ENVS,
                         rollout_fragment_length=IMPALA_FRAGMENT)
            .training(broadcast_interval=IMPALA_BROADCAST,
                      updates_per_step=IMPALA_UPDATES)
            .debugging(seed=SEED).build())

    failures = []
    algo = build(IMPALAConfig())
    try:
        manager = algo.env_runner_group.manager
        results, walls, restored = [], [], None
        for step in range(IMPALA_STEPS):
            if step == IMPALA_KILL_AT:
                if 0 not in {t.actor_id for t in algo._inflight}:
                    failures.append("runner 0 had no sample in flight")
                os.kill(manager.actor(0).pid, signal.SIGKILL)
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
        restored = (manager.num_restarts(0), manager.healthy_actor_ids(),
                    sorted({t.actor_id for t in algo._inflight}))
        if restored != (1, list(range(IMPALA_RUNNERS)),
                        list(range(IMPALA_RUNNERS))):
            failures.append(f"after runner 0's death (restarts, healthy, "
                            f"armed): {restored}")
        learner_device = str(algo.learner_group.learner.device)
    finally:
        algo.stop()
    for r in results:
        if r["num_updates"] != IMPALA_UPDATES or not (
                r["max_runner_lag"] <= IMPALA_BROADCAST
                and np.isfinite(r["total_loss"])):
            failures.append(f"step {r['training_iteration']}: "
                            f"{r['num_updates']} updates, runner lag "
                            f"{r['max_runner_lag']}, loss {r['total_loss']}")
    if not learner_device.startswith("cuda"):
        failures.append(f"learner on {learner_device}")
    appo = build(APPOConfig())
    try:
        appo_results = [appo.train() for _ in range(APPO_STEPS)]
    finally:
        appo.stop()
    last = appo_results[-1]
    if not (np.isfinite(last["kl"]) and 0.2 < last["mean_ratio"] < 5.0
            and all(r["num_updates"] == IMPALA_UPDATES
                    for r in appo_results)):
        failures.append(f"APPO: kl {last['kl']}, mean_ratio "
                        f"{last['mean_ratio']}")
    _no_workers_left(failures, "impala_async's stop()")

    def rates(steps):
        wall = sum(walls[i] for i in steps)
        return {"updates_per_s": sum(results[i]["num_updates"]
                                     for i in steps) / wall,
                "env_steps_per_s": sum(results[i]["env_steps_this_iter"]
                                       for i in steps) / wall,
                "step_ms": wall * 1e3 / len(steps)}

    emit("impala_async", ok=not failures, failures=failures,
         env="CartPoleBatchedEnv", runners=IMPALA_RUNNERS,
         envs_per_runner=IMPALA_ENVS, fragment=IMPALA_FRAGMENT,
         sample_steps=IMPALA_FRAGMENT * IMPALA_ENVS,
         updates_per_step=IMPALA_UPDATES,
         broadcast_interval=IMPALA_BROADCAST, learner=learner_device,
         results=[{k: r[k] for k in (
             "training_iteration", "num_updates", "env_steps_this_iter",
             "max_runner_lag", "max_sample_lag", "learn_time_s",
             "step_time_s", "total_loss")} for r in results],
         steady=rates(range(1, IMPALA_KILL_AT)),
         with_restart=rates(range(IMPALA_KILL_AT, IMPALA_STEPS)),
         restored=restored,
         appo=[{k: r[k] for k in ("num_updates", "kl", "mean_ratio",
                                  "total_loss", "env_steps_this_iter")}
               for r in appo_results])
    if failures:
        raise AssertionError("; ".join(failures))


class PendulumBatchedEnv:
    """gymnasium's Pendulum-v1 for ``num_envs`` envs at once, in numpy (the
    card's machine has no gymnasium): its dynamics, reward and reset
    distribution, the 200-step truncation of its TimeLimit, and
    gymnasium's next-step autoreset (the step after a done ignores its
    action and returns the reset observation with reward 0). The state is
    f64 and the torque f32, as there. A BatchedEnv of the port by its
    attributes (``rllib/env/vector_env.py``)."""

    autoreset_mode = "next_step"
    MAX_SPEED, MAX_TORQUE, DT, G, M, L = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
    MAX_STEPS = 200

    def __init__(self, num_envs: int, seed: int = 0):
        import numpy as np

        from ray_tpu_torch.rllib.spaces import Box

        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros((num_envs, 2))  # theta, theta_dot
        self._t = np.zeros(num_envs, np.int64)
        self._needs_reset = np.zeros(num_envs, bool)
        high = np.array([1.0, 1.0, self.MAX_SPEED], np.float32)
        self.single_observation_space = Box(-high, high, (3,), np.float32)
        self.single_action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE,
                                       (1,), np.float32)

    def _reset_rows(self, rows) -> None:
        import numpy as np

        n = int(rows.sum())
        if n:
            self.state[rows] = self._rng.uniform([-np.pi, -1.0],
                                                 [np.pi, 1.0], (n, 2))
            self._t[rows] = 0

    def _obs(self):
        import numpy as np

        th, thdot = self.state.T
        return np.stack([np.cos(th), np.sin(th), thdot], 1).astype(np.float32)

    def reset(self, seed=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_rows(np.ones(self.num_envs, bool))
        self._needs_reset[:] = False
        return self._obs()

    def step(self, actions):
        import numpy as np

        u = np.clip(np.asarray(actions, np.float32).reshape(
            self.num_envs, -1)[:, 0], -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self.state.T
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        new_thdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                             + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        new_thdot = np.clip(new_thdot, -self.MAX_SPEED, self.MAX_SPEED)
        new_state = np.stack([th + new_thdot * self.DT, new_thdot], 1)
        live = ~self._needs_reset
        self.state[live] = new_state[live]
        self._t[live] += 1
        rew = np.where(live, -costs, 0.0).astype(np.float32)
        term = np.zeros(self.num_envs, bool)
        trunc = live & (self._t >= self.MAX_STEPS)
        self._reset_rows(self._needs_reset)
        self._needs_reset = trunc.copy()
        return self._obs(), rew, term, trunc

    def close(self) -> None:
        pass


class TwoAgentEnv:
    """A two-agent env of the multi-agent protocol (the shape of the JAX
    package's tests' ``TagTeam``): both agents see one random state and
    earn 1 for picking its parity; every episode lasts 8 steps, and agent
    "b" truncates after 5, so its column is dead (masked) for the last 3."""

    possible_agents = ("a", "b")
    EPISODE, B_TRUNCATES = 8, 5

    def __init__(self):
        import numpy as np

        from ray_tpu_torch.rllib.spaces import Box, Discrete

        self.single_observation_space = Box(0, 1, (3,), np.float32)
        self.single_action_space = Discrete(2)
        self._t = 0
        self._rng = np.random.default_rng(0)

    def _obs(self):
        import numpy as np

        o = self._rng.random(3).astype(np.float32)
        self._parity = int(o[0] > 0.5)
        return {a: o for a in self.possible_agents}

    def reset(self, seed=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._dead_b = False
        return self._obs()

    def step(self, actions):
        self._t += 1
        rew = {a: float(actions[a] == self._parity) for a in actions}
        term = {"__all__": self._t >= self.EPISODE}
        trunc = {}
        if self._t == self.B_TRUNCATES and "b" in actions:
            self._dead_b = True
            trunc["b"] = True
        obs = self._obs()
        if self._dead_b:
            obs.pop("b", None)
        return obs, rew, term, trunc


def batched_creator(cls, **kw):
    """An ``env_creator`` that builds a whole BatchedEnv of ``n`` columns
    (picklable: it reaches runner processes)."""
    from ray_tpu_torch.rllib.env.vector_env import BatchedCreator

    return BatchedCreator(cls, seed=SEED, **kw)


def change_rel_l2(got, want) -> float:
    """The worst relative L2 over leaves of two parameter changes (lists
    of tensors); a leaf neither changes (a head no loss reaches) reads 0,
    and a NaN anywhere reads NaN (so no bound passes it)."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        if b.norm() == 0:
            rel = 0.0 if a.norm() == 0 else math.inf
        else:
            rel = float((a - b).norm() / b.norm())
        if math.isnan(rel):
            return rel
        worst = max(worst, rel)
    return worst


def applied_change(learner):
    """The parameter change that ``learner``'s Adam applies, summed per
    leaf over its steps from here on: each step's ``-lr * m_hat /
    (sqrt(v_hat) + eps)``, in f64 from the moments the step left. That is
    the change before the parameters' own f32 rounding, which a stored
    change carries and which no update can avoid: a leaf's stored change
    is off by up to one ulp of its value, and for a 1-element leaf (a
    value head's bias near 0.5-1, changed by 3e-4 in 3 steps) one ulp is
    2e-4 of its change. Returns the list of per-leaf f64 CPU tensors that
    the optimizer's step hook fills."""
    import torch

    total = [torch.zeros(p.shape, dtype=torch.float64)
             for p in learner._leaves]
    index = {id(p): i for i, p in enumerate(learner._leaves)}

    def hook(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            (b1, b2), lr, eps = group["betas"], group["lr"], group["eps"]
            for p in group["params"]:
                st = optimizer.state[p]
                t = float(st["step"])
                m = st["exp_avg"].double().cpu() / (1 - b1 ** t)
                v = st["exp_avg_sq"].double().cpu() / (1 - b2 ** t)
                total[index[id(p)]] -= lr * m / (v.sqrt() + eps)

    learner.optimizer.register_step_post_hook(hook)
    return total


def learner_update_check(learner, make, call, targets=None):
    """One update of ``learner``'s algorithm from its state, on the card
    and on the CPU: the worst relative L2 per leaf of the change Adam
    applied (:func:`applied_change`), and of the stored parameters'
    change. ``make(device)`` builds a fresh learner; ``targets`` names the
    target-network attribute to copy across; ``call(other)`` runs the
    update. Returns (applied, stored)."""
    import torch

    from ray_tpu_torch.rllib.core.learner import tree_leaves, tree_map

    state = learner.get_state()
    start = [torch.from_numpy(x) for x in tree_leaves(state["params"])]
    applied, stored = [], []
    for dev in (learner.device, "cpu"):
        other = make(dev)
        other.set_state(state)
        if targets is not None:
            setattr(other, targets, tree_map(
                lambda t: t.detach().to(other.device, copy=True),
                getattr(learner, targets)))
        applied.append(applied_change(other))
        call(other)
        stored.append([torch.from_numpy(w) - s for w, s in
                       zip(tree_leaves(other.get_weights()), start)])
    return change_rel_l2(*applied), change_rel_l2(*stored)


def _offpolicy_speed(results, timed_wall, profile_busy, updates_per_iter,
                     device):
    """The speed fields of dqn_train and sac_train: over the timed
    iterations (host clock), and one profiled iteration's device time."""
    import torch

    steps = sum(r["env_steps_this_iter"] for r in results)
    sample_s = sum(r["sample_time_s"] for r in results)
    learn_s = sum(r["learn_time_s"] for r in results)
    iter_ms = timed_wall * 1e3 / len(results)
    updates = updates_per_iter * len(results)
    return {
        "iter_ms": iter_ms,
        "env_steps_per_s": steps / timed_wall,
        "sample_env_steps_per_s": steps / sample_s,
        "updates_per_s": updates / learn_s,
        "ms_per_update": learn_s * 1e3 / updates,
        "sample_share": sample_s / timed_wall,
        "learn_share": learn_s / timed_wall,
        "profile": {"busy_ms": profile_busy, "unprofiled_ms": iter_ms,
                    "idle_share": 1 - profile_busy / iter_ms
                    if profile_busy else None},
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
    }


def phase_dqn_train(device):
    """DQN with DQNConfig's defaults on CartPoleBatchedEnv(16) through the
    runner's episode path over a BatchedEnv: uniform replay, then
    prioritized."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner
    from ray_tpu_torch.rllib.core.learner import tree_leaves
    from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv
    from ray_tpu_torch.rllib.utils.replay_buffers import (
        PrioritizedReplayBuffer)

    failures, runs = [], []
    for kind in ("uniform", "prioritized"):
        torch.cuda.reset_peak_memory_stats(device)
        cfg = (DQNConfig()
               .environment(env_creator=batched_creator(CartPoleBatchedEnv))
               .env_runners(num_envs_per_env_runner=RL_ENVS)
               .training(replay_buffer_config={"type": kind})
               .debugging(seed=SEED))
        algo = cfg.build()
        try:
            learner = algo.learner_group.learner
            runner = algo.env_runner_group.local_runner
            before = learner.get_weights()
            results, syncs, t_timed = [], 0, None
            for i in range(RL_WARM_ITERS + RL_TIMED_ITERS):
                if i == RL_WARM_ITERS:
                    t_timed = time.perf_counter()
                ts = algo._timesteps_total
                frac = min(1.0, ts / cfg.epsilon_timesteps)
                want_eps = cfg.epsilon_initial + frac * (
                    cfg.epsilon_final - cfg.epsilon_initial)
                r = algo.train()
                results.append(r)
                if abs(r["epsilon"] - want_eps) > 1e-6 or abs(float(
                        runner.params["epsilon"]) - want_eps) > 1e-6:
                    failures.append(f"{kind} iteration {i + 1}: epsilon "
                                    f"{r['epsilon']} (runner "
                                    f"{float(runner.params['epsilon'])}), "
                                    f"schedule {want_eps}")
                if all(torch.equal(t, p) for t, p in zip(
                        tree_leaves(learner._target_params),
                        tree_leaves(learner.params))):
                    syncs += 1
                if not (np.isfinite(r.get("td_loss", np.nan))
                        and np.isfinite(r.get("mean_q", np.nan))):
                    failures.append(f"{kind} iteration {i + 1}: td_loss "
                                    f"{r.get('td_loss')}, mean_q "
                                    f"{r.get('mean_q')}")
            wall = time.perf_counter() - t_timed
            steps = [r["env_steps_this_iter"] for r in results]
            # The buffer drops the last step of an episode cut by the
            # 500-step limit (same-step autoreset returns no final
            # observation): at most one step in 500.
            dropped = sum(steps) - algo._buffer.size
            if min(steps) < cfg.train_batch_size or (
                    results[-1]["timesteps_total"] != sum(steps)
                    or not 0 <= dropped <= sum(steps)
                    // CartPoleBatchedEnv.MAX_STEPS):
                failures.append(f"{kind}: env steps {steps}, counted "
                                f"{results[-1]['timesteps_total']}, buffer "
                                f"{algo._buffer.size}")
            if syncs < 2:
                failures.append(f"{kind}: target synced after {syncs} "
                                f"iterations")
            if all(np.array_equal(a, b) for a, b in zip(
                    tree_leaves(before), tree_leaves(learner.get_weights()))):
                failures.append(f"{kind}: the weights did not change")
            if learner.device.type != "cuda" or runner.device.type != "cuda":
                failures.append(f"{kind}: learner on {learner.device}, "
                                f"runner on {runner.device}")
            buf = algo._buffer
            if kind == "prioritized":
                vals = buf._tree.values[:buf.size]
                if not (isinstance(buf, PrioritizedReplayBuffer)
                        and vals.min() < buf._max_priority ** buf.alpha):
                    failures.append("prioritized: no priority moved")
            batch = buf.sample(cfg.minibatch_size,
                               np.random.default_rng(SEED + 1))
            batch.pop("idx", None)
            update_rel, stored_rel = learner_update_check(
                learner, lambda dev: DQNLearner(learner.module, cfg,
                                                device=dev),
                lambda other: other.update_td(batch),
                targets="_target_params")
            if not update_rel <= OFFPOLICY_UPDATE_REL_L2:
                failures.append(f"{kind}: update_td card vs CPU {update_rel}")
            busy, top = _device_profile(algo.train)
            runs.append({
                "replay": kind, "target_syncs": syncs,
                "results": [{k: r.get(k) for k in (
                    "training_iteration", "td_loss", "mean_q", "epsilon",
                    "buffer_size", "env_steps_this_iter", "grad_norm",
                    "sample_time_s", "learn_time_s")} for r in results],
                "update_card_vs_cpu_rel_l2": update_rel,
                "update_stored_card_vs_cpu_rel_l2": stored_rel,
                "devices": {"runner": str(runner.device),
                            "learner": str(learner.device)},
                **_offpolicy_speed(results[RL_WARM_ITERS:], wall, busy,
                                   cfg.num_td_updates_per_iter, device),
                "top_kernels_ms": top[:6]})
        finally:
            algo.stop()
    emit("dqn_train", ok=not failures, failures=failures,
         module="DQNModule (MLP 64-64)", env="CartPoleBatchedEnv",
         num_envs=RL_ENVS, train_batch=cfg.train_batch_size,
         minibatch=cfg.minibatch_size,
         td_updates_per_iter=cfg.num_td_updates_per_iter,
         update_tol=OFFPOLICY_UPDATE_REL_L2, runs=runs)
    if failures:
        raise AssertionError("; ".join(failures))


def phase_sac_train(device):
    """SAC with SACConfig's defaults on PendulumBatchedEnv(16) through the
    runner's episode path (next-step autoreset). Returns the replay
    buffer's transition columns (offline_train's CQL corpus)."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner
    from ray_tpu_torch.rllib.core.learner import tree_leaves

    torch.cuda.reset_peak_memory_stats(device)
    cfg = (SACConfig()
           .environment(env_creator=batched_creator(PendulumBatchedEnv))
           .env_runners(num_envs_per_env_runner=RL_ENVS)
           .debugging(seed=SEED))
    algo = cfg.build()
    failures = []
    try:
        learner = algo.learner_group.learner
        runner = algo.env_runner_group.local_runner
        before = learner.get_weights()
        targets_before = [t.clone() for t in
                          tree_leaves(learner._target_q)]
        results, t_timed = [], None
        for i in range(RL_WARM_ITERS + RL_TIMED_ITERS):
            if i == RL_WARM_ITERS:
                t_timed = time.perf_counter()
            results.append(algo.train())
        wall = time.perf_counter() - t_timed
        for r in results:
            if not all(np.isfinite(r.get(k, np.nan)) for k in (
                    "critic_loss", "actor_loss", "alpha_loss", "alpha")):
                failures.append(f"iteration {r['training_iteration']}: "
                                f"losses {r}")
        if results[-1]["alpha"] == 1.0:
            failures.append("alpha did not move")
        after = learner.get_weights()
        if all(np.array_equal(a, b) for a, b in zip(tree_leaves(before),
                                                     tree_leaves(after))):
            failures.append("the weights did not change")
        targets = tree_leaves(learner._target_q)
        params = tree_leaves({k: learner.params[k] for k in ("q1", "q2")})
        if (all(torch.equal(t, b) for t, b in zip(targets, targets_before))
                or any(torch.equal(t, p) for t, p in zip(targets, params))):
            failures.append("targets not moved by polyak (unchanged, or "
                            "copied)")
        buf = algo._buffer
        acts = buf.actions[:buf.size]
        if not (np.abs(acts) <= PendulumBatchedEnv.MAX_TORQUE).all():
            failures.append(f"actions outside the Box: {np.abs(acts).max()}")
        steps = [r["env_steps_this_iter"] for r in results]
        if min(steps) < cfg.train_batch_size or buf.size != sum(steps):
            failures.append(f"env steps {steps}, buffer {buf.size}")
        if learner.device.type != "cuda" or runner.device.type != "cuda":
            failures.append(f"learner on {learner.device}, runner on "
                            f"{runner.device}")
        batch = buf.sample(cfg.minibatch_size,
                           np.random.default_rng(SEED + 1))
        rng = np.random.default_rng(SEED + 2)
        noise = {k: rng.standard_normal(
            (cfg.minibatch_size, 1)).astype(np.float32)
            for k in ("next", "pi")}
        update_rel, stored_rel = learner_update_check(
            learner, lambda dev: SACLearner(learner.module, cfg, device=dev),
            lambda other: other.update_sac(batch, noise=noise),
            targets="_target_q")
        if not update_rel <= OFFPOLICY_UPDATE_REL_L2:
            failures.append(f"update_sac card vs CPU {update_rel}")
        busy, top = _device_profile(algo.train)
        columns = {k: getattr(buf, k)[:buf.size].copy() for k in (
            "obs", "actions", "rewards", "next_obs", "dones")}
        emit("sac_train", ok=not failures, failures=failures,
             module="SACModule (actor, twin Q 256-256)",
             env="PendulumBatchedEnv (Pendulum-v1 dynamics, 200 steps)",
             num_envs=RL_ENVS, train_batch=cfg.train_batch_size,
             minibatch=cfg.minibatch_size,
             updates_per_iter=cfg.num_updates_per_iter,
             devices={"runner": str(runner.device),
                      "learner": str(learner.device)},
             results=[{k: r.get(k) for k in (
                 "training_iteration", "critic_loss", "actor_loss",
                 "alpha_loss", "alpha", "entropy", "mean_q",
                 "episode_return_mean", "env_steps_this_iter", "grad_norm",
                 "sample_time_s", "learn_time_s")} for r in results],
             update_card_vs_cpu_rel_l2=update_rel,
             update_stored_card_vs_cpu_rel_l2=stored_rel,
             update_tol=OFFPOLICY_UPDATE_REL_L2,
             **_offpolicy_speed(results[RL_WARM_ITERS:], wall, busy,
                                cfg.num_updates_per_iter, device),
             top_kernels_ms=top[:6])
    finally:
        algo.stop()
    if failures:
        raise AssertionError("; ".join(failures))
    return columns


def phase_offline_train(device, sac_columns):
    """CQL on the SAC run's transitions, then BC and MARWIL on CartPole
    fragments, each through ``write_*`` and its ``offline_data`` path on
    the card: 2 iterations each."""
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch.rllib.core.learner import tree_leaves
    from ray_tpu_torch.rllib.core.rl_module import MLPModule
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv
    from ray_tpu_torch.rllib.offline import (BCConfig, CQLConfig,
                                             MARWILConfig, write_fragments,
                                             write_transitions)
    from ray_tpu_torch.rllib.offline.bc import BCLearner
    from ray_tpu_torch.rllib.offline.cql import CQLLearner
    from ray_tpu_torch.rllib.offline.io import (iter_offline_batches,
                                                load_columns)
    from ray_tpu_torch.rllib.offline.marwil import (MARWILLearner,
                                                    monte_carlo_returns)

    failures, rows = [], []
    cartpole = batched_creator(CartPoleBatchedEnv)
    with tempfile.TemporaryDirectory() as tmp:
        write_transitions(sac_columns, f"{tmp}/cql")
        runner = SingleAgentEnvRunner(cartpole, lambda: MLPModule(4, 2),
                                      num_envs=RL_ENVS, seed=SEED,
                                      device=device)
        runner.set_weights(MLPModule(4, 2).init(
            torch.Generator().manual_seed(SEED)))
        write_fragments([runner.sample_fragment(OFFLINE_FRAGMENT)
                         for _ in range(2)], f"{tmp}/frags")
        runner.stop()
        frags = load_columns(f"{tmp}/frags")
        frags["returns"] = monte_carlo_returns(frags["rewards"],
                                               frags["dones"], 0.99)
        first = next(iter_offline_batches(frags, 128, seed=SEED))
        rng = np.random.default_rng(SEED + 3)
        B, N = 128, CQLConfig().cql_n_actions
        cql_noise = {"next": rng.standard_normal((B, 1)),
                     "pi": rng.standard_normal((B, 1)),
                     "cql_unif": rng.uniform(-1, 1, (B * N, 1)),
                     "cql_pi": rng.standard_normal((B * N, 1))}
        cql_noise = {k: v.astype(np.float32) for k, v in cql_noise.items()}
        cql_batch = next(iter_offline_batches(sac_columns, B, seed=SEED))
        specs = [
            ("cql", CQLConfig().environment(
                env_creator=batched_creator(PendulumBatchedEnv)),
             f"{tmp}/cql", ("critic_loss", "actor_loss", "alpha_loss",
                            "cql_penalty"),
             lambda cfg, m, dev: CQLLearner(m, cfg, device=dev),
             lambda other: other.update_sac(cql_batch, noise=cql_noise),
             "_target_q"),
            ("bc", BCConfig().environment(env_creator=cartpole),
             f"{tmp}/frags", ("bc_nll", "entropy"),
             lambda cfg, m, dev: BCLearner(m, lr=cfg.lr,
                                           grad_clip=cfg.grad_clip,
                                           device=dev),
             lambda other: other.update(
                 {k: first[k] for k in ("obs", "actions")}, shuffle=False),
             None),
            ("marwil", MARWILConfig().environment(env_creator=cartpole),
             f"{tmp}/frags", ("marwil_loss", "policy_loss", "vf_loss"),
             lambda cfg, m, dev: MARWILLearner(
                 m, beta=cfg.beta, vf_coeff=cfg.vf_coeff,
                 max_weight=cfg.max_weight, lr=cfg.lr,
                 grad_clip=cfg.grad_clip, device=dev),
             lambda other: other.update(
                 {k: first[k] for k in ("obs", "actions", "returns")},
                 shuffle=False),
             None),
        ]
        for name, cfg, path, keys, make, call, targets in specs:
            cfg = cfg.offline_data(input_path=path).debugging(seed=SEED)
            algo = cfg.build()
            try:
                learner = algo.learner_group.learner
                before = learner.get_weights()
                t0 = time.perf_counter()
                results = [algo.train() for _ in range(OFFLINE_ITERS)]
                wall = time.perf_counter() - t0
                for r in results:
                    if not all(np.isfinite(r.get(k, np.nan)) for k in keys):
                        failures.append(f"{name}: losses {r}")
                    if (r["env_steps_this_iter"] != 0
                            or r["sgd_steps_this_iter"]
                            != cfg.steps_per_iteration):
                        failures.append(f"{name}: steps {r}")
                if all(np.array_equal(a, b) for a, b in zip(
                        tree_leaves(before),
                        tree_leaves(learner.get_weights()))):
                    failures.append(f"{name}: the weights did not change")
                if learner.device.type != "cuda":
                    failures.append(f"{name}: learner on {learner.device}")
                update_rel, stored_rel = learner_update_check(
                    learner, lambda dev: make(cfg, learner.module, dev),
                    call, targets=targets)
                if not update_rel <= OFFPOLICY_UPDATE_REL_L2:
                    failures.append(f"{name}: update card vs CPU "
                                    f"{update_rel}")
                sgd = sum(r["sgd_steps_this_iter"] for r in results)
                rows.append({"algo": name, "rows": len(
                    algo._offline_columns["actions"]),
                    "minibatch": cfg.minibatch_size,
                    "results": [{k: r.get(k) for k in keys + (
                        "sgd_steps_this_iter", "env_steps_this_iter",
                        "grad_norm")} for r in results],
                    "sgd_steps_per_s": sgd / wall,
                    "ms_per_sgd_step": wall * 1e3 / sgd,
                    "learner": str(learner.device),
                    "update_card_vs_cpu_rel_l2": update_rel,
                    "update_stored_card_vs_cpu_rel_l2": stored_rel})
            finally:
                algo.stop()
    emit("offline_train", ok=not failures, failures=failures,
         update_tol=OFFPOLICY_UPDATE_REL_L2, runs=rows)
    if failures:
        raise AssertionError("; ".join(failures))


def phase_multi_agent_train(device):
    """PPO's shared policy on MultiAgentBatchedEnv over TwoAgentEnv: every
    live column's steps counted, the dead ones masked."""
    import numpy as np

    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import (
        make_multi_agent_creator)

    cols = MA_INSTANCES * len(TwoAgentEnv.possible_agents)
    algo = (PPOConfig()
            .environment(env_creator=make_multi_agent_creator(
                TwoAgentEnv, seed=SEED))
            .env_runners(num_envs_per_env_runner=cols,
                         rollout_fragment_length=MA_FRAGMENT)
            .debugging(seed=SEED).build())
    failures = []
    try:
        learner = algo.learner_group.learner
        runner = algo.env_runner_group.local_runner
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(MA_ITERS)]
        wall = time.perf_counter() - t0
        # Agent "a" lives every step; "b" the first B_TRUNCATES of each
        # EPISODE (fragments start on episode boundaries).
        live = MA_INSTANCES * (MA_FRAGMENT + MA_FRAGMENT
                               * TwoAgentEnv.B_TRUNCATES
                               // TwoAgentEnv.EPISODE)
        for r in results:
            if r["env_steps_this_iter"] != live:
                failures.append(f"iteration {r['training_iteration']}: "
                                f"{r['env_steps_this_iter']} live steps, "
                                f"not {live}")
            if not (np.isfinite(r["total_loss"]) and r["grad_norm"] > 0):
                failures.append(f"iteration {r['training_iteration']}: "
                                f"loss {r['total_loss']}")
        if results[-1]["timesteps_total"] != live * MA_ITERS:
            failures.append(f"{results[-1]['timesteps_total']} steps "
                            f"counted, not {live * MA_ITERS}")
        if runner.num_envs != cols or learner.device.type != "cuda" or (
                runner.device.type != "cuda"):
            failures.append(f"{runner.num_envs} columns; learner on "
                            f"{learner.device}, runner on {runner.device}")
        emit("multi_agent_train", ok=not failures, failures=failures,
             env="MultiAgentBatchedEnv(TwoAgentEnv)", instances=MA_INSTANCES,
             columns=cols, fragment=MA_FRAGMENT, live_steps_per_iter=live,
             masked_steps_per_iter=cols * MA_FRAGMENT - live,
             results=[{k: r[k] for k in (
                 "training_iteration", "total_loss", "policy_loss",
                 "vf_loss", "grad_norm", "env_steps_this_iter",
                 "episode_return_mean", "sample_time_s", "learn_time_s")}
                 for r in results],
             env_steps_per_s=live * MA_ITERS / wall,
             devices={"runner": str(runner.device),
                      "learner": str(learner.device)})
    finally:
        algo.stop()
    if failures:
        raise AssertionError("; ".join(failures))


# ------------------------------------------------------------ train_glue

def mnist_train_loop(config):
    """BASELINE config 1's loop (the JAX package's tests/test_train.py
    loop) against the port's Train layer: a numpy MLP on an MNIST-shaped
    problem, 64 inputs and 10 classes a worker, the gradients
    host-allreduced over gloo every step; rank 0 checkpoints when asked,
    and a failure is injected once at ``fail_at``."""
    import os

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.util import collective

    ctx = train.get_context()
    group = train.session.collective_group_name() or "train_default"
    rng = np.random.default_rng(ctx.get_world_rank())
    X = rng.standard_normal((64, 64)).astype(np.float32)
    true_w = rng.standard_normal((64, 10)).astype(np.float32)
    y = (X @ true_w).argmax(axis=1)
    w1 = np.zeros((64, 32), np.float32)
    w2 = np.zeros((32, 10), np.float32)
    rng0 = np.random.default_rng(0)
    if ctx.get_world_rank() == 0:
        w1 = rng0.standard_normal((64, 32)).astype(np.float32) * 0.1
        w2 = rng0.standard_normal((32, 10)).astype(np.float32) * 0.1
    w1 = collective.broadcast(w1, 0, group)
    w2 = collective.broadcast(w2, 0, group)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        w1, w2, start = state["w1"], state["w2"], state["step"]
    lr = 0.1
    for step in range(start, config["steps"]):
        h = np.maximum(X @ w1, 0)
        logits = h @ w2
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        onehot = np.eye(10, dtype=np.float32)[y]
        loss = -np.mean(np.log(p[np.arange(len(y)), y] + 1e-9))
        dlogits = (p - onehot) / len(y)
        gw2 = h.T @ dlogits
        dh = dlogits @ w2.T
        dh[h <= 0] = 0
        gw1 = X.T @ dh
        n = collective.get_collective_group_size(group)
        gw1 = collective.allreduce(gw1, group) / n
        gw2 = collective.allreduce(gw2, group) / n
        w1 -= lr * gw1
        w2 -= lr * gw2
        ckpt_out = None
        if config.get("checkpoint") and ctx.get_world_rank() == 0:
            ckpt_out = train.Checkpoint.from_dict(
                {"w1": w1, "w2": w2, "step": step + 1})
        if config.get("fail_at") is not None and \
                step + 1 == config["fail_at"] and \
                not os.path.exists(config["fail_marker"]):
            with open(config["fail_marker"], "w") as f:
                f.write("failed once")
            raise RuntimeError("injected failure")
        train.report({"loss": float(loss), "step": step},
                     checkpoint=ckpt_out)


def _tree_leaves(tree, prefix=""):
    """(dotted name, tensor) of a nested dict, in sorted name order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _leaf_sums(tree, device):
    """Each leaf's sum in f64, taken on ``device``: the same reduction on
    the same kind of card gives the same bits."""
    import torch
    from torch.distributed.tensor import DTensor

    out = {}
    for name, t in _tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[name] = float(t.detach().to(device, torch.float64).sum())
    return out


def _timed_steps(ts, params, opt, batch, steps, warm):
    """``steps`` steps, each loss read (as ``train.report`` reads it);
    returns (losses, mean seconds of the steps after ``warm``)."""
    import torch

    losses, t0 = [], None
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(float(loss))
    return losses, (time.perf_counter() - t0) / (steps - warm)


def gpt2_train_loop(config):
    """BASELINE config 2 on one worker a card: GPT-2 125M through the
    JAX package's recipe (``benchmarks/gpt2_e2e.py``) on the backend's
    mesh, ``transformer_train_step(cfg, get_mesh(), rules=RULES_DP)``, the
    batch's rows split over the ranks by ``shard_batch``. Each step's loss
    goes to the trainer process by ``train.report``; then every rank saves the
    state sharded, and rank 0 reports the ranks' launches, peaks, cards and
    pids, the last loss and the state's leaf sums with the checkpoint.
    AdamW at ``config["lr"]`` where given (tune_train), else the default
    (the same at 3e-4)."""
    import os

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import RULES_DP

    loop_start = time.time()
    cfg = gpt2_125m(remat=True, remat_policy="dots")
    mesh = train.get_mesh()
    ts = train.transformer_train_step(
        cfg, mesh, rules=RULES_DP, shift_inputs=True,
        optimizer=AdamWAt(config["lr"]) if "lr" in config else None)
    device = ts.device
    torch.cuda.reset_peak_memory_stats(device)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(
        config["seed"]))
    batch = ts.shard_batch(
        {"tokens": torch.from_numpy(config["tokens"]).to(device)})
    rows = batch["tokens"].to_local().shape[0]
    steps = config["warm"] + config["timed"]
    _zero_launch_counts(fa)  # count this rank's main path alone
    t0 = None
    for i in range(steps):
        if i == config["warm"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ts0 = time.perf_counter()
        params, opt, loss = ts.step(params, opt, batch)
        train.report({"loss": float(loss), "step": i,
                      "step_ms": (time.perf_counter() - ts0) * 1e3})
    step_s = (time.perf_counter() - t0) / config["timed"]
    mine = {"launches": _launch_counts(fa), "rows": rows, "step_s": step_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
            "card": card_identity(), "pid": os.getpid()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    state = ts.state_tree(params, opt)
    t_save = time.perf_counter()
    ckpt = train.Checkpoint.save_sharded(state, config.get("ckpt_dir"))
    save_s = time.perf_counter() - t_save
    sums = _leaf_sums(state, device)
    rank = train.get_context().get_world_rank()
    train.report({"ranks": ranks, "sums": sums, "save_s": save_s,
                  "loop_start": loop_start, "world": dist.get_world_size(),
                  "loss": float(loss)},
                 checkpoint=ckpt if rank == 0 else None)


def _fit_glue(trainer):
    """fit() and its wall seconds."""
    t0 = time.perf_counter()
    return trainer.fit(), time.perf_counter() - t0


def _no_workers_left(failures, after):
    import multiprocessing

    left = multiprocessing.active_children()
    if left:
        failures.append(f"worker processes left after {after}: {left}")


def _mnist_glue(root):
    """BASELINE config 1 twice, as tests/test_train.py holds it: 5 steps on
    2 CPU workers; and the failure at step 3 with one restart allowed. The
    two runs go side by side (a spawn costs seconds of interpreter and
    torch start, most of a run)."""
    import concurrent.futures
    import os

    from ray_tpu_torch.train import (DataParallelTrainer, FailureConfig,
                                     RunConfig, ScalingConfig)

    failures = []
    marker = os.path.join(root, "fail_marker")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        smoke_run = pool.submit(_fit_glue, DataParallelTrainer(
            mnist_train_loop, train_loop_config={"steps": 5},
            scaling_config=ScalingConfig(num_workers=GLUE_MNIST_WORKERS),
            run_config=RunConfig(name="dp_smoke", storage_path=root)))
        restart_run = pool.submit(_fit_glue, DataParallelTrainer(
            mnist_train_loop,
            train_loop_config={"steps": 6, "checkpoint": True, "fail_at": 3,
                               "fail_marker": marker},
            scaling_config=ScalingConfig(num_workers=GLUE_MNIST_WORKERS),
            run_config=RunConfig(
                name="dp_restart", storage_path=root,
                failure_config=FailureConfig(max_failures=1))))
        smoke, smoke_s = smoke_run.result()
        restart, restart_s = restart_run.result()
    _no_workers_left(failures, "the MNIST runs")
    if not (smoke.metrics["step"] == 4 and smoke.metrics["loss"] < 2.5):
        failures.append(f"MNIST smoke: {smoke.metrics}")
    resumed = restart.checkpoint.to_dict()["step"]
    if not (os.path.exists(marker) and restart.metrics["step"] == 5
            and resumed == 6 and len(restart.spawn_s) == 2):
        failures.append(f"MNIST restart: marker {os.path.exists(marker)}, "
                        f"{restart.metrics}, checkpoint step {resumed}, "
                        f"attempts {len(restart.spawn_s)}")
    return {"workers": GLUE_MNIST_WORKERS, "backend": "gloo",
            "smoke": {"metrics": smoke.metrics, "fit_s": smoke_s,
                      "spawn_s": smoke.spawn_s},
            "restart": {"metrics": restart.metrics, "fit_s": restart_s,
                        "spawn_s": restart.spawn_s,
                        "checkpoint_step": resumed}}, failures


def _direct_gpt2(cfg, tokens, device):
    """The loop's steps on one device in this process, without the Train
    layer or a mesh. Returns (losses, seconds a timed step)."""
    import torch

    from ray_tpu_torch.train.step import transformer_train_step

    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    return _timed_steps(ts, params, opt, {"tokens": tokens},
                        GLUE_WARM_STEPS + GLUE_TIMED_STEPS, GLUE_WARM_STEPS)


def _glue_dp_steps(rank, world, device_type):
    import torch

    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.parallel import RULES_DP, MeshSpec, make_mesh
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = gpt2_125m(remat=True, remat_policy="dots")
    ts = transformer_train_step(
        cfg, make_mesh(MeshSpec(data=world), device_type), rules=RULES_DP,
        shift_inputs=True)
    params, opt = ts.init(torch.Generator(device=ts.device).manual_seed(SEED))
    tokens = _train_tokens(cfg, GLUE_BATCH * world, GLUE_SEQ, ts.device)
    losses, step_s = _timed_steps(
        ts, params, opt, ts.shard_batch({"tokens": tokens}),
        GLUE_WARM_STEPS + GLUE_TIMED_STEPS, GLUE_WARM_STEPS)
    return {"rank": rank, "losses": losses, "step_s": step_s}


def glue_dp_rank(rank, world, addr, device_type, _unused, results=None):
    """One rank of train_glue's witness: gpt2_train_loop's steps on the
    same data=world mesh, seed and batch, with no Train layer (no worker
    group, session or report): its losses isolate what the glue does."""
    return _in_world(rank, world, addr, device_type, results,
                     lambda: _glue_dp_steps(rank, world, device_type))


def phase_train_glue(device):
    """The Train layer on the port's own worker processes: BASELINE
    config 1 (the MNIST DP smoke, 2 CPU workers on gloo, and its restart)
    and config 2 (GPT-2 125M, data-parallel through ``TorchTrainer``, one
    worker a visible card up to 4, K1/K2/K3 on every rank)."""
    import os
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchTrainer, TrainCallback)

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rtpu_train_glue_")
    # The workers inherit it: the temporary directories of their
    # checkpoints go with the rest.
    tmpdir = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = root
    try:
        mnist, failures = _mnist_glue(root)

        world = min(torch.cuda.device_count(), GLUE_MAX_WORKERS)
        cfg = gpt2_125m(remat=True, remat_policy="dots")
        tokens_np = glue_tokens(cfg, GLUE_BATCH * world)
        tokens = torch.from_numpy(tokens_np).to(device)
        direct, direct_s = _direct_gpt2(cfg, tokens, device)
        del tokens
        gc_collect()
        # The same data=W step with no Train layer: in this process on one
        # card, on W spawned ranks on more.
        witness = run_dist_ranks(world, "cuda", None, rank_fn=glue_dp_rank)
        gc_collect()

        class Record(TrainCallback):
            def __init__(self):
                self.reports = []

            def on_report(self, iteration, metrics, checkpoint=None):
                self.reports.append(metrics)

        rec = Record()
        fit_start = time.time()
        result, fit_s = _fit_glue(TorchTrainer(
            gpt2_train_loop,
            train_loop_config={"seed": SEED, "tokens": tokens_np,
                               "warm": GLUE_WARM_STEPS,
                               "timed": GLUE_TIMED_STEPS,
                               "ckpt_dir": f"{root}/gpt2_state"},
            scaling_config=ScalingConfig(num_workers=world),
            run_config=RunConfig(name="gpt2_dp", storage_path=root,
                                 callbacks=[rec])))
        steps = GLUE_WARM_STEPS + GLUE_TIMED_STEPS
        losses = [r["loss"] for r in rec.reports if "step" in r]
        step_ms = [r["step_ms"] for r in rec.reports if "step" in r]
        final = rec.reports[-1]
        ranks = final["ranks"]
        t0 = time.perf_counter()
        tree = result.checkpoint.load_sharded()
        load_s = time.perf_counter() - t0
        sums = _leaf_sums(tree, device)
        del tree
        gc_collect()

        want = {"flash_fwd": 2 * cfg.n_layers * steps,
                "flash_bwd_dq": cfg.n_layers * steps,
                "flash_bwd_dkv": cfg.n_layers * steps}
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            failures.append(f"GPT-2 losses: {losses}")
        elif abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            failures.append(f"first loss {losses[0]} is not within 0.5 of "
                            f"ln({cfg.vocab_size})")
        elif not losses[-1] < losses[0]:
            failures.append(f"loss did not fall: {losses}")
        # The glue alone: every loss bit for bit the witness's, on any W.
        mesh_losses = witness[0]["losses"]
        if losses != mesh_losses or any(
                r["losses"] != mesh_losses for r in witness):
            failures.append(f"losses {losses} against the same data={world} "
                            f"step without the Train layer: "
                            f"{[r['losses'] for r in witness]}")
        # Against one device: one card, the same losses, bit for bit;
        # more: see GLUE_LOSS_RTOL.
        held = steps if world == 1 else GLUE_HELD_STEPS
        rtol = 0.0 if world == 1 else GLUE_LOSS_RTOL
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, direct)]
        if len(rel) != steps or max(rel[:held]) > rtol:
            failures.append(f"losses {losses} against the direct step's "
                            f"{direct}: relative {rel}, the first {held} "
                            f"held to {rtol}")
        for r, got in enumerate(ranks):
            if got["launches"] != want:
                failures.append(f"rank {r} launches {got['launches']}, "
                                f"expected {want}")
            if got["rows"] != GLUE_BATCH:
                failures.append(f"rank {r} took {got['rows']} rows")
        if sorted(sums) != sorted(final["sums"]) or any(
                sums[k] != final["sums"][k] for k in sums):
            bad = [k for k in sums if sums[k] != final["sums"].get(k)]
            failures.append(f"checkpoint read back: {len(sums)} leaves, "
                            f"{len(final['sums'])} reported, sums differ "
                            f"on {bad[:5]}")
        _no_workers_left(failures, "the GPT-2 run")
        step_s = statistics.mean(r["step_s"] for r in ranks)
        tokens_per_card = GLUE_BATCH * GLUE_SEQ
        emit("train_glue", ok=not failures, failures=failures,
             phase_s=time.perf_counter() - phase_t0, mnist=mnist,
             gpt2={
                 "model": "gpt2_125m", "n_layers": cfg.n_layers,
                 "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                 "vocab": cfg.vocab_size, "num_params": cfg.num_params(),
                 "remat_policy": cfg.remat_policy, "workers": world,
                 "backend": "nccl", "mesh": {"data": world},
                 "rules": "RULES_DP", "batch_per_card": GLUE_BATCH,
                 "seq": GLUE_SEQ, "warm_steps": GLUE_WARM_STEPS,
                 "timed_steps": GLUE_TIMED_STEPS, "losses": losses,
                 "direct_losses": direct, "loss_rel_diff": rel,
                 "loss_rtol": rtol, "loss_held_steps": held,
                 "mesh_losses": mesh_losses,
                 "launches_by_rank": [r["launches"] for r in ranks],
                 "launches_per_step": {k: v / steps for k, v in
                                       ranks[0]["launches"].items()},
                 "worker_step_ms": step_s * 1e3,
                 "worker_step_ms_by_rank": [r["step_s"] * 1e3
                                            for r in ranks],
                 "worker_step_ms_each": step_ms,
                 "direct_step_ms": direct_s * 1e3,
                 "mesh_step_ms_by_rank": [r["step_s"] * 1e3
                                          for r in witness],
                 "tokens_per_s_per_card": tokens_per_card / step_s,
                 "direct_tokens_per_s": tokens_per_card * world / direct_s,
                 "fit_s": fit_s, "spawn_s": result.spawn_s,
                 # Spawn, the process group, the mesh and the session,
                 # up to the loop's first line.
                 "start_to_loop_s": final["loop_start"] - fit_start,
                 "save_s": final["save_s"], "load_s": load_s,
                 "checkpoint_leaves": len(sums),
                 "peak_mem_gib_per_rank": [r["peak_mem_gib"]
                                           for r in ranks]})
        if failures:
            raise AssertionError("; ".join(failures))
        return ({k: sum(r["launches"][k] for r in ranks) for k in want},
                tokens_per_card / step_s, losses if world == 1 else None)
    finally:
        if tmpdir is None:
            os.environ.pop("TMPDIR")
        else:
            os.environ["TMPDIR"] = tmpdir
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ data_ingest

def _ingest_arm(ts, params, opt, batches, steps, rows, device, arm):
    """``steps`` steps of the loop on the rank's local rows, each batch's
    ``tokens`` made this rank's shard of the data=W batch with
    ``DTensor.from_local``; each loss goes to the trainer by
    ``train.report``. Returns the ids, the batch waits and the steps."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train

    ids, wait_s, step_s = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        local = torch.as_tensor(batch["tokens"]).to(device)
        tokens = DTensor.from_local(local, rows.mesh, rows.placements)
        params, opt, loss = ts.step(params, opt, {"tokens": tokens})
        loss = float(loss)
        step_s.append(time.perf_counter() - t1)
        wait_s.append(t1 - t0)
        ids.extend(int(x) for x in batch["id"])
        train.report({"loss": loss, "arm": arm, "step": i})
    return ids, wait_s, step_s


def ingest_cfg():
    """data_ingest's model: train_glue's GPT-2 125M recipe (full width),
    INGEST_LAYERS layers."""
    from ray_tpu_torch.models.configs import gpt2_125m

    return gpt2_125m(remat=True, remat_policy="dots", n_layers=INGEST_LAYERS)


def ingest_train_loop(config):
    """data_ingest's loop, one worker a card: train_glue's GPT-2 step
    (``transformer_train_step(cfg, get_mesh(), rules=RULES_DP)``) fed by
    the data layer. Arm 1 takes ``steps`` batches of the rank's
    ``get_dataset_shard("train")`` through ``iter_torch_batches``; arm 2
    ``steps`` batches of the rank's streaming split, which it then reads
    to its end. Rank 0 reports every rank's ids, times, fetches and
    launches."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import RULES_DP
    from ray_tpu_torch.parallel.sharding import named_sharding

    cfg = ingest_cfg()
    mesh = train.get_mesh()
    ts = train.transformer_train_step(cfg, mesh, rules=RULES_DP,
                                      shift_inputs=True)
    device = ts.device
    torch.cuda.reset_peak_memory_stats(device)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(
        config["seed"]))
    rank = train.get_context().get_world_rank()
    shard = train.get_dataset_shard("train")
    split = train.get_dataset_shard("splits")[rank]
    rows = named_sharding(mesh, ("batch", None), RULES_DP)
    _zero_launch_counts(fa)  # this rank's main path alone
    steps, bs = config["steps"], config["batch"]
    arm1 = _ingest_arm(ts, params, opt, shard.iter_torch_batches(
        batch_size=bs), steps, rows, device, "shard")
    split_batches = split.iter_batches(batch_size=bs)
    arm2 = _ingest_arm(ts, params, opt, split_batches, steps, rows, device,
                       "split")
    drained = [int(x) for b in split_batches for x in b["id"]]
    mine = {"launches": _launch_counts(fa),
            "arm1": {"ids": arm1[0], "wait_s": arm1[1], "step_s": arm1[2]},
            "arm2": {"ids": arm2[0], "wait_s": arm2[1], "step_s": arm2[2],
                     "drained": drained},
            "fetch_s": split.fetch_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    train.report({"ranks": ranks})


def _direct_gpt2_batches(cfg, batches, device):
    """The bare one-device step (``_direct_gpt2``'s) on ``batches`` in
    order, one step a batch; the losses."""
    import torch

    from ray_tpu_torch.train.step import transformer_train_step

    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    losses = []
    for b in batches:
        params, opt, loss = ts.step(params, opt, {
            "tokens": torch.from_numpy(b).to(device)})
        losses.append(float(loss))
    return losses


def _ingest_dp_steps(rank, world, device_type, batches_by_rank):
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import RULES_DP, MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import named_sharding
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = ingest_cfg()
    ts = transformer_train_step(
        cfg, make_mesh(MeshSpec(data=world), device_type), rules=RULES_DP,
        shift_inputs=True)
    params, opt = ts.init(torch.Generator(device=ts.device).manual_seed(SEED))
    rows = named_sharding(ts.mesh, ("batch", None), RULES_DP)
    losses = []
    for b in batches_by_rank[rank]:
        local = torch.from_numpy(b).to(ts.device)
        params, opt, loss = ts.step(params, opt, {"tokens": DTensor.from_local(
            local, rows.mesh, rows.placements)})
        losses.append(float(loss))
    return {"rank": rank, "losses": losses}


def ingest_dp_rank(rank, world, addr, device_type, batches_by_rank,
                   results=None):
    """One rank of data_ingest's witness on more cards: the bare data=W
    step fed each rank's batches in order, no Train layer or data
    layer."""
    return _in_world(rank, world, addr, device_type, results,
                     lambda: _ingest_dp_steps(rank, world, device_type,
                                              batches_by_rank))


def _ms_summary(seconds):
    ms = [x * 1e3 for x in seconds]
    return {"median": statistics.median(ms), "mean": statistics.mean(ms),
            "max": max(ms), "n": len(ms)} if ms else None


def _driver_exchanges(td, path, n, failures):
    """The exchanges of data_ingest in the driver, on the written shards:
    ``sort("id")``, ``groupby("shard").count()`` against numpy, ``zip``
    of the ids with themselves. Returns each one's wall seconds."""
    import numpy as np

    per_shard = n // INGEST_SHARDS
    walls = {}
    t = time.perf_counter()
    got = np.concatenate([b["id"] for b in td.read_tfrecords(path)
                          .sort("id").iter_batches(batch_size=None)])
    walls["sort_s"] = time.perf_counter() - t
    if not np.array_equal(got, np.arange(n)):
        failures.append("sort('id') is not 0..N-1")
    t = time.perf_counter()
    counts = td.read_tfrecords(path).add_column(
        "shard", lambda b: b["id"] // per_shard).groupby("shard").count() \
        .take_all()
    walls["groupby_s"] = time.perf_counter() - t
    want = np.bincount(np.arange(n) // per_shard)
    got = {int(r["shard"]): int(r["count()"]) for r in counts}
    if got != {i: int(c) for i, c in enumerate(want)}:
        failures.append(f"groupby('shard').count(): {got}, numpy {want}")
    t = time.perf_counter()
    ids = td.read_tfrecords(path).select_columns(["id"])
    zipped = ids.zip(ids).take_batch(n)
    walls["zip_s"] = time.perf_counter() - t
    if sorted(zipped) != ["id", "id_1"] or not np.array_equal(
            zipped["id"], zipped["id_1"]) or len(zipped["id"]) != n:
        failures.append(f"zip of the ids: columns {sorted(zipped)}")
    return walls


def phase_data_ingest(device, glue_tokens_per_s):
    """GPT-2 125M trained through ``TorchTrainer`` on a shuffled TFRecord
    dataset, fed by ``split_shard`` and by a ``streaming_split`` (see
    ``ingest_train_loop``), one worker a visible card up to 4."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch.data as td
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchTrainer, TrainCallback)

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rtpu_data_ingest_")
    tmpdir = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = root  # the workers' temporary files go too
    failures = []
    try:
        world = min(torch.cuda.device_count(), GLUE_MAX_WORKERS)
        cfg = ingest_cfg()
        n = world * INGEST_BATCHES * GLUE_BATCH
        tokens_np = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (n, GLUE_SEQ + 1))
        path = os.path.join(root, "shards")
        t = time.perf_counter()
        td.from_blocks([{"id": idx, "tokens": tokens_np[idx]} for idx in
                        np.array_split(np.arange(n), INGEST_SHARDS)]
                       ).write_tfrecords(path)
        write_s = time.perf_counter() - t
        written = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))

        shuffled = td.read_tfrecords(path).random_shuffle(seed=SEED)
        materialized = shuffled.materialize()
        ops = {o["operator"]: o for o in shuffled.stats().operators}
        read_s = ops["read"]["wall_s"]
        shuffle_s = ops["RandomShuffle"]["self_s"]
        seen = materialized.take_batch(n)
        if not (np.array_equal(np.sort(seen["id"]), np.arange(n))
                and np.array_equal(seen["tokens"], tokens_np[seen["id"]])
                and seen["tokens"].dtype == np.int64):
            failures.append("the shards read back differ from the rows "
                            "written")
        exchanges = _driver_exchanges(td, path, n, failures)

        splits = shuffled.streaming_split(world)
        coord = shuffled._coordinators[0]
        coord_dir, coord_socket = coord._listener.dir, coord.address

        class Record(TrainCallback):
            def __init__(self):
                self.reports = []

            def on_report(self, iteration, metrics, checkpoint=None):
                self.reports.append(metrics)

        rec = Record()
        trainer = TorchTrainer(
            ingest_train_loop,
            train_loop_config={"seed": SEED, "steps": INGEST_STEPS,
                               "batch": GLUE_BATCH},
            scaling_config=ScalingConfig(num_workers=world),
            run_config=RunConfig(name="gpt2_ingest", storage_path=root,
                                 callbacks=[rec]),
            datasets={"train": shuffled, "splits": splits})
        result, fit_s = _fit_glue(trainer)
        spawn_s = result.spawn_s
        ranks = rec.reports[-1]["ranks"]
        losses = [r["loss"] for r in rec.reports if "loss" in r]
        _no_workers_left(failures, "the ingest run")

        steps = 2 * INGEST_STEPS
        rows_a_step = INGEST_STEPS * GLUE_BATCH
        for r, got in enumerate(ranks):
            want = np.concatenate([b["id"] for b in materialized.split_shard(
                r, world).iter_batches(batch_size=None)]).tolist()
            if got["arm1"]["ids"] != want[:rows_a_step]:
                failures.append(f"rank {r}: arm 1's ids are not the "
                                f"driver's split_shard({r}, {world})")
            if len(got["arm2"]["ids"]) != rows_a_step:
                failures.append(f"rank {r}: arm 2 trained on "
                                f"{len(got['arm2']['ids'])} rows")
        delivered = sorted(i for got in ranks for i in
                           got["arm2"]["ids"] + got["arm2"]["drained"])
        if delivered != list(range(n)):
            failures.append(f"the splits delivered {len(delivered)} ids, "
                            f"{len(set(delivered))} distinct, of {n}")
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            failures.append(f"losses: {losses}")
        elif abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            failures.append(f"first loss {losses[0]} is not within 0.5 of "
                            f"ln({cfg.vocab_size})")
        # The witness: the same batches in the same order, with no Train
        # layer and no data layer.
        batches_by_rank = [
            [tokens_np[got[arm]["ids"][i * GLUE_BATCH:(i + 1) * GLUE_BATCH]]
             for arm in ("arm1", "arm2") for i in range(INGEST_STEPS)]
            for got in ranks]
        del materialized, seen
        gc_collect()
        if world == 1:
            witness = _direct_gpt2_batches(cfg, batches_by_rank[0], device)
            rtol = 0.0
        else:
            witness = run_dist_ranks(world, "cuda", batches_by_rank,
                                     rank_fn=ingest_dp_rank)[0]["losses"]
            rtol = GLUE_LOSS_RTOL
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, witness)]
        if len(rel) != steps or max(rel) > rtol:
            failures.append(f"losses {losses} against the bare step's "
                            f"{witness}: relative {rel}, held to {rtol}")
        want_launches = {"flash_fwd": 2 * cfg.n_layers * steps,
                         "flash_bwd_dq": cfg.n_layers * steps,
                         "flash_bwd_dkv": cfg.n_layers * steps}
        for r, got in enumerate(ranks):
            if got["launches"] != want_launches:
                failures.append(f"rank {r} launches {got['launches']}, "
                                f"expected {want_launches}")

        # Clean-up: the coordinator goes when every split has ended and
        # its consumers have left, or with the Dataset and its iterators.
        del trainer, splits, shuffled, coord, result
        gc.collect()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                os.path.exists(coord_dir) or _split_threads()):
            time.sleep(0.1)
        if _split_threads() or os.path.exists(coord_dir) or \
                os.path.exists(coord_socket):
            failures.append(f"the split coordinator left threads "
                            f"{_split_threads()} or files in {coord_dir}")

        def arm_ms(arm, key):
            # The first step of an arm pays its iterator's start: kept in
            # "max", left out of the median.
            return _ms_summary([x for got in ranks
                                for x in got[arm][key][1:]])

        fetch = [x for got in ranks for x in got["fetch_s"]]
        step_ms = {arm: arm_ms(arm, "step_s") for arm in ("arm1", "arm2")}
        tokens_per_card = GLUE_BATCH * GLUE_SEQ
        emit("data_ingest", ok=not failures, failures=failures,
             phase_s=time.perf_counter() - phase_t0,
             model="gpt2_125m", workers=world, backend="nccl",
             rows=n, tokens_a_row=GLUE_SEQ + 1, shards=INGEST_SHARDS,
             batch_per_card=GLUE_BATCH, steps_per_arm=INGEST_STEPS,
             write_s=write_s, written_mb=written / 1e6,
             write_mb_per_s=written / 1e6 / write_s,
             read_s=read_s, read_rows_per_s=n / read_s,
             shuffle_s=shuffle_s, shuffle_rows_per_s=n / shuffle_s,
             exchanges=exchanges, fit_s=fit_s, spawn_s=spawn_s,
             losses=losses, witness_losses=witness, loss_rel_diff=rel,
             loss_rtol=rtol,
             launches_by_rank=[got["launches"] for got in ranks],
             step_ms=step_ms,
             wait_ms={arm: arm_ms(arm, "wait_s")
                      for arm in ("arm1", "arm2")},
             tokens_per_s_per_card={
                 arm: tokens_per_card / (step_ms[arm]["median"] / 1e3)
                 for arm in step_ms},
             train_glue_tokens_per_s_per_card=glue_tokens_per_s,
             split_fetch_ms=_ms_summary(fetch),
             drained_rows=[len(got["arm2"]["drained"]) for got in ranks],
             peak_mem_gib_per_rank=[got["peak_mem_gib"] for got in ranks])
        if failures:
            raise AssertionError("; ".join(failures))
        return {k: sum(got["launches"][k] for got in ranks)
                for k in want_launches}
    finally:
        if tmpdir is None:
            os.environ.pop("TMPDIR")
        else:
            os.environ["TMPDIR"] = tmpdir
        shutil.rmtree(root, ignore_errors=True)


def _split_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("rtpu-split")]


# ------------------------------------------------------------- tune_train

class AdamWAt:
    """The default optimizer (``train/step.py``'s ``default_optimizer``:
    AdamW, betas 0.9/0.999, eps 1e-8, no weight decay) at learning rate
    ``lr``; picklable, so it reaches a trial or worker process."""

    def __init__(self, lr):
        self.lr = lr

    def __call__(self, leaves):
        import torch

        return torch.optim.AdamW(leaves, lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.0)


def card_identity():
    """This process's current card: the ``CUDA_VISIBLE_DEVICES`` it was
    given and the card's UUID."""
    import os

    import torch

    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "uuid": str(getattr(props, "uuid", ""))}


def glue_tokens(cfg, rows):
    """train_glue's token batch: ``rows`` rows of GLUE_SEQ + 1 tokens from
    ``default_rng(SEED)``."""
    import numpy as np

    return np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (rows, GLUE_SEQ + 1))


def gpt2_trial(config):
    """tune_train's arm A, a function trainable in a trial process:
    GPT-2 125M (train_glue's recipe: f32 params, bf16 compute, its seed
    and tokens) on the trial's card through ``transformer_train_step``
    with AdamW at the config's lr. An iteration is TUNE_STEPS_PER_ITER
    steps, reported with their losses and ms, the K1/K2/K3 launches, the
    card, the pid and the peak memory."""
    import os

    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train.step import transformer_train_step

    device = torch.device(TUNE_DEVICE)
    torch.cuda.set_device(device)
    cfg = gpt2_125m(remat=True, remat_policy="dots")
    ts = transformer_train_step(cfg, device=device, shift_inputs=True,
                                optimizer=AdamWAt(config["lr"]))
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    batch = {"tokens": torch.from_numpy(glue_tokens(cfg, GLUE_BATCH)).to(
        device)}
    card = card_identity()
    for _ in range(TUNE_MAX_T):
        _zero_launch_counts(fa)
        losses, ms = [], []
        for _ in range(TUNE_STEPS_PER_ITER):
            t0 = time.perf_counter()
            params, opt, loss = ts.step(params, opt, batch)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        tune.report({"loss": losses[-1], "losses": losses, "step_ms": ms,
                     "launches": _launch_counts(fa), "card": card,
                     "pid": os.getpid(),
                     "peak_gib": torch.cuda.max_memory_allocated(device)
                     / 2 ** 30})


def __getattr__(name):
    """``SmokePPO``, made at first use (its base, PPO, loads torch, which
    this module's top does not): tune_train's arm C trainable, found by
    name in a trial process."""
    if name != "SmokePPO":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from ray_tpu_torch.rllib.algorithms.ppo import PPO
    from ray_tpu_torch.rllib.env.vector_env import CnnRolloutBenchEnv

    class SmokePPO(PPO):
        """PPO on ppo_train's env (CnnRolloutBenchEnv, the Nature CNN),
        cuDNN held to its deterministic algorithms: a trial's results are
        held bit for bit to the same iterations in this process."""

        @classmethod
        def get_default_config(cls):
            cfg = super().get_default_config()
            cfg.env_creator = batched_creator(CnnRolloutBenchEnv)
            return cfg

        def setup(self, config):
            import torch

            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = True
            super().setup(config)

    SmokePPO.__qualname__ = "SmokePPO"
    globals()["SmokePPO"] = SmokePPO
    return SmokePPO


def _alive(pid):
    """Is process ``pid`` alive (a zombie counts as gone)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _pids_left(pids, within_s=10.0):
    """The pids still alive ``within_s`` from now (a trial's workers leave
    when they see their trial process gone)."""
    deadline = time.time() + within_s
    left = [p for p in pids if _alive(p)]
    while left and time.time() < deadline:
        time.sleep(0.1)
        left = [p for p in left if _alive(p)]
    return left


def _tune_watch():
    """A Tune callback that keeps the results in the order the controller
    took them, and at the end its trials and timeline."""
    from ray_tpu_torch import tune

    class Watch(tune.Callback):
        def __init__(self):
            self.arrivals = []
            self.trials = []
            self.timeline = {}

        def on_trial_result(self, trial, result):
            self.arrivals.append((trial.trial_id, dict(result)))

        def on_experiment_end(self, controller):
            self.trials = list(controller.trials)
            self.timeline = controller.timeline

    return Watch()


def _tune_rows(watch, fit_s):
    """Each trial's spawn, first result, iterations, median step ms and
    peak; the fit's wall against the sum of the trials' walls, and the
    seconds from one trial's end to the next one's start on a card."""
    rows, by_card = [], {}
    for t in watch.trials:
        tl = watch.timeline.get(t.trial_id, {})
        starts, ready, ends = tl.get("starts"), tl.get("ready"), tl.get("ends")
        step_ms = []
        for r in t.results:
            v = r.get("step_ms")
            step_ms += v if isinstance(v, list) else [v] if v else []
        rows.append({
            "trial_id": t.trial_id, "config": {
                k: v for k, v in t.config.items() if k != "tokens"},
            "status": t.status, "iterations": t.iteration,
            "cards": tl.get("cards"), "pids": tl.get("pids"),
            "spawn_s": ready[0] - starts[0] if ready else None,
            "first_result_s": (tl["first_result"] - starts[0]
                               if tl.get("first_result") else None),
            "wall_s": ends[-1] - starts[0] if ends else None,
            # The first step pays the trial's warm-up: left out.
            "median_step_ms": (statistics.median(step_ms[1:])
                               if len(step_ms) > 1 else None),
            "peak_gib": max([r.get("peak_gib", 0.0) for r in t.results]
                            + [0.0])})
        for card, s, e in zip(tl.get("cards") or [], starts or [],
                              ends or []):
            if card is not None:
                by_card.setdefault(card, []).append((s, e))
    gaps = []
    for spans in by_card.values():
        spans.sort()
        gaps += [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    walls = [r["wall_s"] for r in rows if r["wall_s"] is not None]
    return {"trials": rows, "fit_s": fit_s, "trial_wall_sum_s": sum(walls),
            "card_gaps_s": gaps}


def _overlap(rows):
    """Did every trial of ``rows`` run at some moment together with all
    the others (one process each)?"""
    spans = [(r["start"], r["end"]) for r in rows]
    return max(s for s, _ in spans) < min(e for _, e in spans)


def _tune_fn_arm(root, witness, per_step, cards, failures):
    """Arm A: gpt2_trial at TUNE_LRS under ASHA, a card a trial."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune.experiment import Trial
    from ray_tpu_torch.tune.schedulers import STOP

    asha = dict(metric="loss", mode="min", max_t=TUNE_MAX_T,
                grace_period=TUNE_GRACE, reduction_factor=TUNE_RF)
    watch = _tune_watch()
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune.with_resources(gpt2_trial, {"num_gpus": 1}),
        param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=tune.AsyncHyperBandScheduler(**asha)),
        run_config=RunConfig(name="tune_fn", storage_path=root,
                             callbacks=[watch])).fit()
    fit_s = time.perf_counter() - t0
    trials = watch.trials
    if len(trials) != len(TUNE_LRS) or grid.errors or any(
            t.status == "ERROR" for t in trials):
        failures.append(f"arm A: {len(trials)} trials, errors {grid.errors}")
    per_iter = {k: v * TUNE_STEPS_PER_ITER for k, v in per_step.items()}
    launches = {k: 0 for k in per_step}
    for t in trials:
        got = [r.get("launches") for r in t.results]
        if any(g != per_iter for g in got):
            failures.append(f"arm A trial {t.config}: launches {got} by "
                            f"iteration, expected {per_iter}")
        for g in got:
            for k in launches:
                launches[k] += (g or {}).get(k, 0)
    # The lr = 3e-4 trial against the same steps in this process: as many
    # steps as both ran.
    (t3,) = [t for t in trials if t.config["lr"] == 3e-4] or [None]
    got = [x for r in t3.results for x in r["losses"]] if t3 else []
    n = min(len(got), len(witness))
    if not n or got[:n] != witness[:n]:
        failures.append(f"arm A lr=3e-4 losses {got} against the witness "
                        f"{witness}")
    # ASHA replayed on the results in the order they arrived.
    replay = tune.AsyncHyperBandScheduler(**asha)
    stubs = {t.trial_id: Trial(config=t.config, trial_id=t.trial_id)
             for t in trials}
    for s in stubs.values():
        replay.on_trial_add(s)
    stopped_at = {}
    for tid, r in watch.arrivals:
        if tid in stopped_at:
            failures.append(f"arm A trial {tid}: a result after its stop")
        elif r.get("done") or replay.on_trial_result(stubs[tid], r) == STOP:
            stopped_at[tid] = r["training_iteration"]
    asha_ok = all(stopped_at.get(t.trial_id) == t.iteration for t in trials)
    if not asha_ok:
        failures.append(f"arm A stops {[t.iteration for t in trials]}, "
                        f"ASHA replayed {stopped_at}")
    best = grid.get_best_result()
    least = min(trials, key=lambda t: t.last_result["loss"])
    if best.config != least.config:
        failures.append(f"arm A best {best.config}, least final loss "
                        f"{least.config}")
    out = _tune_rows(watch, fit_s)
    if cards >= len(TUNE_LRS):
        tl = watch.timeline
        spans = [{"start": tl[t.trial_id]["starts"][0],
                  "end": tl[t.trial_id]["ends"][-1]} for t in trials]
        uuids = {t.results[0]["card"]["uuid"] for t in trials}
        if not _overlap(spans) or len(uuids) != len(trials):
            failures.append(f"arm A on {cards} cards: trials together "
                            f"{_overlap(spans)}, cards {uuids}")
    out.update(asha=asha, asha_replay_matches=asha_ok,
               stopped_at={str(t.config["lr"]): t.iteration for t in trials},
               best_lr=best.config["lr"], lr_3e4_losses=got,
               steps_compared=n, launches=launches)
    pids = [p for t in trials for p in watch.timeline[t.trial_id]["pids"]]
    return out, launches, pids


def _tune_trainer_arm(root, tokens_np, witness, glue_losses, per_step,
                      cards, failures, device):
    """Arm B: TorchTrainer(gpt2_train_loop) trials at TUNE_TRAINER_LRS, a
    worker a trial."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import (CheckpointConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    steps = GLUE_WARM_STEPS + GLUE_TIMED_STEPS
    trainer = TorchTrainer(
        gpt2_train_loop,
        train_loop_config={"seed": SEED, "tokens": tokens_np,
                           "warm": GLUE_WARM_STEPS,
                           "timed": GLUE_TIMED_STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="tune_glue", storage_path=root))
    watch = _tune_watch()
    t0 = time.perf_counter()
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search(list(TUNE_TRAINER_LRS))}},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(
            name="tune_trainer", storage_path=root, callbacks=[watch],
            checkpoint_config=CheckpointConfig(checkpoint_at_end=True))).fit()
    fit_s = time.perf_counter() - t0
    trials = watch.trials
    if len(trials) != len(TUNE_TRAINER_LRS) or grid.errors:
        failures.append(f"arm B: {len(trials)} trials, errors {grid.errors}")
    want = {k: v * steps for k, v in per_step.items()}
    launches = {k: 0 for k in per_step}
    finals, pids = {}, []
    for t in trials:
        lr = t.config["train_loop_config"]["lr"]
        its = [r["training_iteration"] for r in t.results[:steps + 1]]
        if its != list(range(1, steps + 2)):
            failures.append(f"arm B lr={lr}: iterations {its}, not the "
                            f"loop's reports 1..{steps + 1}")
        final = next((r for r in t.results if "ranks" in r), None)
        if final is None:
            failures.append(f"arm B lr={lr}: no final report")
            continue
        finals[lr] = final
        (rank0,) = final["ranks"]
        pids.append(rank0["pid"])
        if rank0["launches"] != want:
            failures.append(f"arm B lr={lr}: launches {rank0['launches']}, "
                            f"expected {want}")
        for k in launches:
            launches[k] += rank0["launches"][k]
    t3 = next((t for t in trials
               if t.config["train_loop_config"]["lr"] == 3e-4), None)
    got = [r["loss"] for r in t3.results if "step" in r][:steps] if t3 else []
    if got != witness or (glue_losses is not None and got != glue_losses):
        failures.append(f"arm B lr=3e-4 losses {got} against the witness "
                        f"{witness} and train_glue's {glue_losses}")
    best = grid.get_best_result()
    tree = best.checkpoint.load_sharded() if best.checkpoint else None
    sums = _leaf_sums(tree, device) if tree is not None else {}
    del tree
    gc_collect()
    want_sums = finals.get(best.config["train_loop_config"]["lr"], {}).get(
        "sums", {})
    if not sums or sums != want_sums:
        failures.append(f"arm B best checkpoint: {len(sums)} leaves read "
                        f"back, {len(want_sums)} reported, equal "
                        f"{sums == want_sums}")
    out = _tune_rows(watch, fit_s)
    cards_used = [f["ranks"][0]["card"] for f in finals.values()]
    if cards >= 2:
        tl = watch.timeline
        spans = [{"start": tl[t.trial_id]["starts"][0],
                  "end": tl[t.trial_id]["ends"][-1]} for t in trials]
        if not _overlap(spans) or len({c["uuid"] for c in cards_used}) != 2:
            failures.append(f"arm B on {cards} cards: trials together "
                            f"{_overlap(spans)}, worker cards {cards_used}")
    out.update(lr_3e4_losses=got, worker_cards=cards_used,
               worker_step_ms={str(lr): f["ranks"][0]["step_s"] * 1e3
                               for lr, f in finals.items()},
               best_lr=best.config["train_loop_config"]["lr"],
               checkpoint_leaves=len(sums), launches=launches)
    pids += [p for t in trials for p in watch.timeline[t.trial_id]["pids"]]
    return out, launches, pids


def _tune_ppo_arm(root, failures):
    """Arm C: SmokePPO as a Trainable, one trial on a card, against the
    same iterations in this process."""
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    cls = getattr(sys.modules[__name__], "SmokePPO")
    space = {"num_envs_per_env_runner": PPO_ENVS,
             "rollout_fragment_length": PPO_FRAGMENT,
             "train_batch_size": PPO_ENVS * PPO_FRAGMENT,
             "minibatch_size": PPO_MINIBATCH, "num_epochs": PPO_EPOCHS,
             "seed": SEED}
    keys = ("total_loss", "policy_loss", "vf_loss", "entropy", "approx_kl",
            "grad_norm", "timesteps_total", "training_iteration")
    cudnn = torch.backends.cudnn
    t0 = time.perf_counter()
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                     deterministic=True, allow_tf32=cudnn.allow_tf32):
        algo = cls(dict(space))
        try:
            want = [algo.train() for _ in range(TUNE_PPO_ITERS)]
        finally:
            algo.stop()
    in_process_s = time.perf_counter() - t0
    gc_collect()
    watch = _tune_watch()
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune.with_resources(cls, {"num_gpus": 1}), param_space=dict(space),
        run_config=RunConfig(name="tune_ppo", storage_path=root,
                             callbacks=[watch],
                             stop={"training_iteration": TUNE_PPO_ITERS})
    ).fit()
    fit_s = time.perf_counter() - t0
    (trial,) = watch.trials or [None]
    got = [{k: r[k] for k in keys} for r in trial.results] if trial else []
    exp = [{k: r[k] for k in keys} for r in want]
    if grid.errors or got != exp:
        failures.append(f"arm C: errors {grid.errors}, results {got} "
                        f"against the in-process {exp}")
    out = _tune_rows(watch, fit_s)
    out.update(results=got, in_process=exp, in_process_s=in_process_s,
               checkpoint=bool(grid[0].checkpoint) if len(grid) else False)
    pids = watch.timeline[trial.trial_id]["pids"] if trial else []
    return out, pids


def phase_tune_train(device, glue_losses=None):
    """Tune (``ray_tpu_torch.tune``) on the card: each trial a process of
    its own on the cards the controller gives it (``CUDA_VISIBLE_DEVICES``).
    A: GPT-2 125M function trials under ASHA; B: ``TorchTrainer`` trials
    (the trainer as a trainable); C: PPO as a Trainable. Returns the
    K1/K2/K3 launches of A's trials and of B's workers."""
    import multiprocessing
    import os
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.util import procs

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rtpu_tune_")
    # The trials and their workers inherit it: their temporary
    # checkpoints go with the rest.
    tmpdir = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = root
    failures = []
    try:
        cards = torch.cuda.device_count()
        cfg = gpt2_125m(remat=True, remat_policy="dots")
        tokens_np = glue_tokens(cfg, GLUE_BATCH)
        witness, witness_s = _direct_gpt2(
            cfg, torch.from_numpy(tokens_np).to(device), device)
        gc_collect()
        per_step = {"flash_fwd": 2 * cfg.n_layers,
                    "flash_bwd_dq": cfg.n_layers,
                    "flash_bwd_dkv": cfg.n_layers}
        fn_arm, fn_launches, pids = _tune_fn_arm(root, witness, per_step,
                                                 cards, failures)
        gc_collect()
        trainer_arm, trainer_launches, more = _tune_trainer_arm(
            root, tokens_np, witness, glue_losses, per_step, cards,
            failures, device)
        pids += more
        gc_collect()
        ppo_arm, more = _tune_ppo_arm(root, failures)
        pids += more
        gc_collect()
        procs.stop_fork_server()  # what the card trials forked from
        left = _pids_left(pids)
        if left or multiprocessing.active_children():
            failures.append(f"processes left after tune_train: {left}, "
                            f"{multiprocessing.active_children()}")
        emit("tune_train", ok=not failures, failures=failures,
             phase_s=time.perf_counter() - phase_t0, cards=cards,
             model="gpt2_125m", n_layers=cfg.n_layers,
             batch=GLUE_BATCH, seq=GLUE_SEQ,
             steps_per_iteration=TUNE_STEPS_PER_ITER,
             witness_losses=witness, witness_step_ms=witness_s * 1e3,
             train_glue_losses=glue_losses, fn=fn_arm, trainer=trainer_arm,
             ppo=ppo_arm, processes_checked=len(pids))
        if failures:
            raise AssertionError("; ".join(failures))
        return fn_launches, trainer_launches
    finally:
        if tmpdir is None:
            os.environ.pop("TMPDIR")
        else:
            os.environ["TMPDIR"] = tmpdir
        shutil.rmtree(root, ignore_errors=True)


def bwd_flops(B, S, H, D, causal, products):
    """K2 (3 products) or K3 (4): 2 flops a multiply-add over the (query,
    key) pairs the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2.0 * products * B * H * D * pairs


def bwd_bound(B, S, H, KVH, D, causal, products, writes_q):
    """Least time for K2 (3 products, writes dq) or K3 (4 products, writes
    dk and dv): 2 flops a multiply-add over the (query, key) pairs the mask
    keeps, against q/k/v/do read once, lse/delta read once, outputs
    written once. Returns (ms, "operations" | "bytes")."""
    flops = bwd_flops(B, S, H, D, causal, products)
    nbytes = (2.0 * (2 * B * S * H * D + 2 * B * S * KVH * D)
              + 8.0 * B * H * S
              + 2.0 * (B * S * H * D if writes_q else 2 * B * S * KVH * D))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def held_ms(fn, iters: int, hold_cycles: float = 1e8) -> dict:
    """Device time of ``fn`` a call without the host's gaps, from CUDA
    events alone: a spin kernel (``hold_cycles`` clock cycles) holds the
    card while the host queues ``iters`` calls after it, so they run back
    to back. Returns that time (``device_ms``), the hold's time and the
    host's time to queue the calls (``hold_ms``, ``queue_ms``): the
    calls ran back to back only where the queueing ended first."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(int(hold_cycles))
    ev[1].record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    return {"device_ms": ev[1].elapsed_time(ev[2]) / iters,
            "hold_ms": ev[0].elapsed_time(ev[1]), "queue_ms": queue_ms}


def device_ms(fn, iters: int, floor_ms: float, what: str) -> float:
    """Mean device time of ``fn`` without the host's gaps
    (:func:`held_ms`), at least ``floor_ms`` (the least the card could take
    for the work). Where the host had not queued the calls before the hold
    ended, the hold is made four times longer, up to three times; then, or
    below the floor, this raises, naming ``what``."""
    fn()  # warm
    cycles = 1e8
    for _ in range(3):
        got = held_ms(fn, iters, cycles)
        if got["queue_ms"] < got["hold_ms"]:
            break
        cycles *= 4
    else:
        raise RuntimeError(f"{what}: the host queued {iters} calls in "
                           f"{got['queue_ms']} ms, past the hold "
                           f"({got['hold_ms']} ms)")
    if got["device_ms"] < floor_ms:
        raise RuntimeError(f"{what}: {got['device_ms']} ms a call, under the "
                           f"least the card could take ({floor_ms} ms)")
    return got["device_ms"]


def sdpa_times(q, k, v, scale, floor_ms, do=None, iters=20, causal=True):
    """The library yardstick: ``F.scaled_dot_product_attention`` on
    contiguous [B, H, S, D] copies of q/k/v, pinned in turn to each backend
    that takes them; with ``do``, its backward alone on a retained graph
    (one call computes dq, dk and dv). Device time (``device_ms``, at
    least ``floor_ms``): a Python autograd call is host-bound at these
    sizes, and its host time moved 0.29-0.90 ms between calls. Returns
    {backend: ms}."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    grad = do is not None
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(grad)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous() if grad else None
    gqa = k.shape[2] != q.shape[2]
    times = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def fwd(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=gqa)

        def bwd(out):
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        try:  # a backend that does not take these inputs raises
            out = fwd()
            if grad:
                bwd(out)
        except RuntimeError:
            continue
        times[backend.name] = device_ms(
            (lambda: bwd(out)) if grad else fwd, iters, floor_ms,
            f"sdpa {backend.name} {'bwd' if grad else 'fwd'} "
            f"{tuple(qt.shape)}")
    if not times:
        raise RuntimeError(f"no fast SDPA backend takes q {tuple(qt.shape)}, "
                           f"k {tuple(kt.shape)}")
    return times


def _library_fields(times):
    best = min(times, key=times.get)
    return {"library_ms": times[best], "library_backend": best,
            "library_ms_by_backend": times}


def phase_kernel_time(fa, device):
    # K1 at the serving shapes, then at the training one (q/k/v as views of
    # the fused wqkv projection, as the training path hands them over).
    # ms: CUDA events over back-to-back launches; device_ms: the same with
    # the card held while the host queues them (no host gaps).
    rows = []
    shapes = [(1, S, 32, 8, 128, "kv", True) for S in TIMED_SEQ]
    shapes.append((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, "qkv", True))
    # The ring's chunk from the past: a 2048-token chunk of Llama-3-8B's
    # attention against another chunk's keys, no mask.
    shapes.append((1, SP_SEQ // SP_RANKS, SP_HEADS, SP_KV_HEADS,
                   SP_HEAD_DIM, "", False))
    # ViT-L at vit_infer's batch 64, no mask.
    shapes.append((VIT_BATCHES[0], VIT_SEQ, VIT_HEADS, VIT_HEADS,
                   VIT_HEAD_DIM, "qkv", False))
    for B, S, H, KVH, D, fused, causal in shapes:
        q, k, v = attn_inputs(7, B, S, H, KVH, D, device, fused=fused)
        scale = D ** -0.5
        iters = 50 if B * S <= 2048 else 20
        kernel = lambda: fa.flash_attention_fwd(q, k, v, scale, causal)
        ms = cuda_ms(kernel, iters=iters)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, scale, causal),
            iters=10 if B * S <= 2048 else 3)
        bound_ms, bound_by = flash_bound(B, S, H, KVH, D, causal)
        rows.append({"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": causal, "ms": ms,
                     "device_ms": device_ms(kernel, iters, bound_ms,
                                            f"K1 {(B, S, H, KVH, D)}"),
                     "plain_ms": plain_ms,
                     # SDPA's floor: the same products (it may write no
                     # lse).
                     **_library_fields(sdpa_times(
                         q, k, v, scale,
                         flash_flops(B, S, H, D, causal)
                         / PEAK_BF16_FLOPS * 1e3,
                         iters=iters, causal=causal)),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "roofline_share": bound_ms / ms})
        # Achieved rate: the operations the mask keeps over device time.
        rows[-1]["tflops"] = flash_flops(B, S, H, D, causal) / (
            rows[-1]["device_ms"] * 1e9)
    serve_row = rows[len(TIMED_SEQ) - 1]
    emit("kernel_time", kernel="flash_fwd", l2_flushed=False, rows=rows)

    # K2 and K3 at the training shape and at Llama-3-8B's prefill shape,
    # beside the SDPA backward (dq, dk and dv together).
    bwd_rows = []
    # The training shape, Llama-3-8B's prefill shape, and the ring's chunk
    # from the past (no mask) at that shape.
    for i, (B, S, H, KVH, D, causal) in enumerate((
            (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True),
            (1, 2048, 32, 8, 128, True), (1, 2048, 32, 8, 128, False))):
        args = bwd_inputs(300 + i, B, S, H, KVH, D, causal, device,
                          fused="qkv" if KVH != H else "")
        scale = D ** -0.5
        # SDPA's floor: the 5 products dq, dk and dv need together (K2 and
        # K3 recompute p and dp apart, 7 in all).
        library = _library_fields(sdpa_times(
            *args[:3], scale,
            bwd_flops(B, S, H, D, causal, 5) / PEAK_BF16_FLOPS * 1e3,
            do=args[3], causal=causal))
        both = lambda: (fa.flash_bwd_dq(*args, scale, causal),
                        fa.flash_bwd_dkv(*args, scale, causal))
        # K2 and K3 one after the other, as the backward runs them, beside
        # the one SDPA call that computes all three gradients; the bound is
        # the sum of theirs.
        for name, kernel, plain, products in (
                ("flash_bwd_dq",
                 lambda: fa.flash_bwd_dq(*args, scale, causal),
                 fa.flash_bwd_dq_plain, (3,)),
                ("flash_bwd_dkv",
                 lambda: fa.flash_bwd_dkv(*args, scale, causal),
                 fa.flash_bwd_dkv_plain, (4,)),
                ("flash_bwd_dq+dkv", both, fa.flash_attention_bwd_plain,
                 (3, 4))):
            ms = cuda_ms(kernel, iters=20)
            plain_ms = cuda_ms(lambda: plain(*args, scale, causal), iters=3)
            bounds = [bwd_bound(B, S, H, KVH, D, causal, n, n == 3)
                      for n in products]
            bound_ms = sum(b[0] for b in bounds)
            dev_ms = device_ms(kernel, 20, bound_ms,
                               f"{name} {(B, S, H, KVH, D)}")
            bwd_rows.append({
                "kernel": name, "B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                "causal": causal, "ms": ms, "device_ms": dev_ms,
                "tflops": sum(bwd_flops(B, S, H, D, causal, n)
                              for n in products) / (dev_ms * 1e9),
                "plain_ms": plain_ms, **library,
                "library": "sdpa backward (dq, dk, dv together)",
                "bound_ms": bound_ms,
                "bound_by": "+".join(b[1] for b in bounds),
                "roofline_share": bound_ms / ms})
    emit("kernel_time", kernel="flash_bwd", l2_flushed=False, rows=bwd_rows)
    # The kernels line: K1 at its serving shape, K2/K3 at the training one.
    return serve_row, {r["kernel"]: r for r in bwd_rows
                       if r["S"] == TRAIN_SEQ and r["causal"]}


def main() -> int:
    keep_bytecode()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import bucket_len

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    fa.build()
    emit("build", ok=True, kernels=["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"],
         seconds=time.perf_counter() - t0, torch=torch.__version__,
         cuda=torch.version.cuda)
    print(card_line(), flush=True)

    max_err = phase_kernel_check(fa, bucket_len, device)
    bwd_err = phase_kernel_check_bwd(fa, device)
    phase_sp_check(fa, device)
    gc_collect()
    cfg, params, prompts, outs, serve_launches, eng, tick_s = phase_slice(
        device)
    prefill_ms = phase_prefill_time(cfg, params, prompts, device)
    phase_profile(cfg, params, prompts, eng, tick_s, device)
    # The slice's model (16 GB) leaves the card; the serve phases run
    # SERVE_LAYERS layers, held to their own witness.
    del cfg, params, eng, outs
    gc_collect()
    cfg, params, prompts, outs, eng, tick_s, prefill_ms = (
        phase_serve_witness(device))
    serve_deploy = phase_serve_stream(cfg, prompts, outs, tick_s, prefill_ms,
                                      eng)
    serve_deploy += phase_serve_batch(cfg, params, device)
    serve_deploy += phase_serve_disagg(cfg, prompts, outs, prefill_ms)
    serve_deploy += phase_serve_multiplex(cfg, params)
    serve_deploy += phase_serve_autoscale(cfg, prompts, outs)
    serve.shutdown()
    gc_collect()
    mpmd_launches = phase_mpmd_pipe(cfg, params)
    gc_collect()
    workflow_launches = phase_workflow_llm(cfg, prompts, outs, tick_s, eng)
    gc_collect()
    core_launches = phase_core_stream(cfg, prompts, outs, tick_s, prefill_ms)
    # The serving model leaves the card before training starts.
    del cfg, params, eng
    gc_collect()
    train_launches, train_losses, train_step_s = phase_train(fa, device)
    gc_collect()
    moe_launches, moe_serve_launches, moe_losses = phase_moe_train(fa,
                                                                   device)
    gc_collect()
    dist_launches = phase_dist_train(device, train_losses, train_step_s,
                                     moe_losses)
    gc_collect()
    phase_train_grad_check(device)
    gc_collect()
    vit_launches, vit_images_per_s = phase_vit_infer(fa, device)
    gc_collect()
    data_launches = phase_data_infer(device, vit_images_per_s)
    gc_collect()
    ppo_in_process = phase_ppo_train(device)
    gc_collect()
    phase_ppo_remote(device, ppo_in_process)
    gc_collect()
    phase_impala_async(device)
    gc_collect()
    phase_dqn_train(device)
    sac_columns = phase_sac_train(device)
    phase_offline_train(device, sac_columns)
    phase_multi_agent_train(device)
    gc_collect()
    glue_launches, glue_tokens_per_s, glue_losses = phase_train_glue(device)
    gc_collect()
    ingest_launches = phase_data_ingest(device, glue_tokens_per_s)
    gc_collect()
    tune_fn, tune_trainer = phase_tune_train(device, glue_losses)
    gc_collect()
    fwd_timed, bwd_timed = phase_kernel_time(fa, device)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:47",
        "launches": (serve_launches + serve_deploy + mpmd_launches
                     + workflow_launches + core_launches
                     + train_launches["flash_fwd"]
                     + moe_launches["flash_fwd"] + moe_serve_launches
                     + dist_launches["flash_fwd"] + vit_launches
                     + data_launches + glue_launches["flash_fwd"]
                     + ingest_launches["flash_fwd"] + tune_fn["flash_fwd"]
                     + tune_trainer["flash_fwd"]),
        "launches_by_path": {"serve": serve_launches,
                             "serve_deploy": serve_deploy,
                             "mpmd_pipe": mpmd_launches,
                             "workflow_llm": workflow_launches,
                             "core_stream": core_launches,
                             "train": train_launches["flash_fwd"],
                             "moe_train": moe_launches["flash_fwd"],
                             "moe_serve": moe_serve_launches,
                             "dist_train": dist_launches["flash_fwd"],
                             "vit": vit_launches,
                             "data_infer": data_launches,
                             "train_glue": glue_launches["flash_fwd"],
                             "data_ingest": ingest_launches["flash_fwd"],
                             "tune_fn": tune_fn["flash_fwd"],
                             "tune_trainer": tune_trainer["flash_fwd"]},
        "max_abs_err": max_err,
        "ms": fwd_timed["ms"],
        "device_ms": fwd_timed["device_ms"],
        "plain_ms": fwd_timed["plain_ms"],
        "bound_ms": fwd_timed["bound_ms"],
        "bound_by": fwd_timed["bound_by"],
        "library_ms": fwd_timed["library_ms"],
        "library_backend": fwd_timed["library_backend"],
    }]
    for name, line, err in (("flash_bwd_dq", 157, bwd_err["dq"]),
                            ("flash_bwd_dkv", 207, bwd_err["dkv"])):
        timed = bwd_timed[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": (train_launches[name] + moe_launches[name]
                         + dist_launches[name] + glue_launches[name]
                         + ingest_launches[name] + tune_fn[name]
                         + tune_trainer[name]),
            "launches_by_path": {"train": train_launches[name],
                                 "moe_train": moe_launches[name],
                                 "dist_train": dist_launches[name],
                                 "train_glue": glue_launches[name],
                                 "data_ingest": ingest_launches[name],
                                 "tune_fn": tune_fn[name],
                                 "tune_trainer": tune_trainer[name]},
            "max_abs_err": err,
            "ms": timed["ms"],
            "device_ms": timed["device_ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "library_backend": timed["library_backend"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
