#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit; the hand-written kernels are built from the
checkout's sources at first use (into ``ray_tpu_torch/_build/``). It imports
nothing of JAX or of the JAX package. Each phase prints one JSON line:

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
   (torch.profiler).
5. ``train``: the training main path. ``bench_350m(remat=True,
   remat_policy="dots")`` at full width and depth (f32 params, bf16
   compute) through ``transformer_train_step`` with the default AdamW:
   batch 8, seq 1024, ``shift_inputs``, one seeded token batch; 2 warm-up
   and 10 timed steps. Checks finite, falling losses, the first near
   ln(vocab), and that each step launched K1 48 times (24 layers, and
   again under "dots" remat) and K2 and K3 24 times each. Prints step ms,
   tokens/s, an MFU-style share, peak memory, and one profiled step.
   Then ``moe_train``: the same model with 8 experts, top-2 (capacity
   1.25) in place of its FFN, at full width and depth: 5 AdamW steps with
   48/24/24 launches a step, finite and falling losses, aux per layer in
   (0.1, 10); step ms, tokens/s, peak memory, one profiled step; then its
   weights in bf16 serve one 2048-token prefill (24 K1 launches) and 16
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
   ``BatchPredictor(TorchPredictor)`` over ViT-L/16 (seeded weights in a
   dict checkpoint), batch 64, one pool worker a visible card up to 4,
   each running K1 -> ``take_all``. Checks every id once and in order,
   finite [64, 1000] f32 logits, each worker's K1 launches at 24 a batch
   (24 x 32 W in all), the logits against the same batches through
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
11. ``kernel_time``: K1, K2, K3 and K2+K3 together (each with its
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
SP_SEQ, SP_RANKS, SP_HEADS, SP_KV_HEADS, SP_HEAD_DIM = 8192, 4, 32, 8, 128
SP_REL_L2 = 2e-2
# moe_train: bench_350m with Mixtral's routing (8 experts, top-2, capacity
# 1.25) at full width and depth: 2 warm-up and 3 timed AdamW steps; then
# the same weights in bf16 serve one PREFILL-token prefill and SERVE_DECODE
# greedy decode steps. The aux loss per layer must lie in (0.1, 10), as
# tests/test_moe.py holds it (about 1 at uniform routing).
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_WARM_STEPS, MOE_TIMED_STEPS = 2, 3
MOE_PREFILL, MOE_DECODE = 2048, 16
# dist_train's layouts past fsdp, with 2-4 cards: seq (ring, Ulysses) at
# DIST_LONG_SEQ tokens a row and DIST_LONG_BATCH rows, expert (the MoE
# model), pipe (2 x world microbatches).
DIST_LONG_SEQ, DIST_LONG_BATCH = 4096, 2
DIST_LAYOUTS = ("fsdp", "seq_ring", "seq_ulysses", "expert", "pipe")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    import numpy as np
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

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
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
    return cfg, params, prompts, launches, eng, tick_ms / 1e3


def phase_prefill_time(cfg, params, prompts, device):
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
    emit("prefill_time", model="llama3_8b", rows=rows)


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
    from ray_tpu_torch.models.configs import bench_350m

    return bench_350m(remat=True, remat_policy="dots",
                      moe_num_experts=MOE_EXPERTS,
                      moe_experts_per_token=MOE_TOP_K, **overrides)


def phase_moe_train(fa, device):
    """The MoE model trains (full width and depth, 8 experts, top-2), then
    serves in bf16: one prefill and greedy decode steps."""
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
    compute)."""
    from ray_tpu_torch.models import vit

    return vit.forward(params, images, vit.vit_l16())


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

    cfg = vit.vit_l16()
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
    state sharded, and rank 0 reports the ranks' launches, peaks and the
    state's leaf sums with the checkpoint."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models.configs import gpt2_125m
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import RULES_DP

    loop_start = time.time()
    cfg = gpt2_125m(remat=True, remat_policy="dots")
    mesh = train.get_mesh()
    ts = train.transformer_train_step(cfg, mesh, rules=RULES_DP,
                                      shift_inputs=True)
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
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    state = ts.state_tree(params, opt)
    t_save = time.perf_counter()
    ckpt = train.Checkpoint.save_sharded(state, config["ckpt_dir"])
    save_s = time.perf_counter() - t_save
    sums = _leaf_sums(state, device)
    rank = train.get_context().get_world_rank()
    train.report({"ranks": ranks, "sums": sums, "save_s": save_s,
                  "loop_start": loop_start, "world": dist.get_world_size()},
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

    import numpy as np
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
        rng = np.random.default_rng(SEED)
        tokens_np = rng.integers(0, cfg.vocab_size,
                                 (GLUE_BATCH * world, GLUE_SEQ + 1))
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
        losses = [r["loss"] for r in rec.reports if "loss" in r]
        step_ms = [r["step_ms"] for r in rec.reports if "loss" in r]
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
        return {k: sum(r["launches"][k] for r in ranks) for k in want}
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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
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
    cfg, params, prompts, serve_launches, eng, tick_s = phase_slice(device)
    phase_prefill_time(cfg, params, prompts, device)
    phase_profile(cfg, params, prompts, eng, tick_s, device)
    # The serving model (16 GB) leaves the card before training starts.
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
    glue_launches = phase_train_glue(device)
    gc_collect()
    fwd_timed, bwd_timed = phase_kernel_time(fa, device)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:47",
        "launches": (serve_launches + train_launches["flash_fwd"]
                     + moe_launches["flash_fwd"] + moe_serve_launches
                     + dist_launches["flash_fwd"] + vit_launches
                     + data_launches + glue_launches["flash_fwd"]),
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"],
                             "moe_train": moe_launches["flash_fwd"],
                             "moe_serve": moe_serve_launches,
                             "dist_train": dist_launches["flash_fwd"],
                             "vit": vit_launches,
                             "data_infer": data_launches,
                             "train_glue": glue_launches["flash_fwd"]},
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
                         + dist_launches[name] + glue_launches[name]),
            "launches_by_path": {"train": train_launches[name],
                                 "moe_train": moe_launches[name],
                                 "dist_train": dist_launches[name],
                                 "train_glue": glue_launches[name]},
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
