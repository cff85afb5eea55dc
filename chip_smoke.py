"""Drives the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and holds
its hand-written kernels against their plain PyTorch versions.

Run from the repository root on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, in order; a failure in any of them ends the run with an error:

1. build   - nvcc compiles ray_tpu_torch/ops/csrc/*.cu for sm_90a.
2. kernels - the paged decode kernels (single sequence, batched, fused
             heads) at the serving engine's LLAMA3_8B shapes (H=32,
             Hkv=8, D=128, page 64, a 9-page table), B in {8, 32}, f32
             and bf16, against their plain versions (tolerance 2e-4 f32,
             2e-2 bf16). Times are medians of CUDA-event timings with
             the L2 cache flushed before each launch, as a decode step
             finds it, read twice (Timer: ms, and busy_ms with the
             host's launch latency kept out); the bound is the bytes the
             call must move over the card's memory rate; the library
             yardstick is a page gather plus
             F.scaled_dot_product_attention (not used by the port). Then,
             outside the timed inputs, each kernel at length 0 (the
             mean of V over the whole table, as the reference gives it).
3. parity  - LLAMA3_8B widths at 2 layers in f32: the dense-cache
             Generator (no kernel) decodes 16 greedy tokens for 4
             prompts of 5-100 tokens, and three engines must agree with
             it: the paged LLMEngine (kernel), the dense engine and the
             dense engine with prefill_chunk=16 (the 64- and 100-token
             prompts in 4 and 7 chunks), each decode chunk a replay of
             the engine's CUDA graph; a divergence passes only at a
             near-tie (top-2 gap < 1e-3).
4. serving - LLAMA3_8B at full width and depth in bf16, random weights
             from seed 0, behind LLMServer(max_batch=8, max_len=512,
             page_size=64, decode_chunk=8): after a warm-up burst (which
             also captures the decode graph), 8 greedy prompts of 17-200
             tokens and one sampled request (temperature 0.8, top-k 50,
             top-p 0.9), 32 new tokens each, sent together. Launch
             counts are set to 0 just before the requests and read just
             after them. A wrapper counts a launch where Python launches
             it, and under the graph that is once, at capture: so a
             kernel's launches on this path are its eager ones plus the
             ones recorded in the graph times the graph's replays, and
             K3's must cover n_layers x the decode steps.
4b. serving modes - the same weights, shared by every engine: the dense
             engine serves phase 4's requests; a dense engine with
             prefill_chunk=64 takes a 448-token prompt (7 chunks) while
             two 16-token streams decode, which must keep emitting;
             drain round trips paged -> dense and dense -> paged: two
             streams on a 4-token stream buffer are read for 3 tokens,
             park, are quiesced and snapshotted, and resume through
             submit_prefilled in an engine of the other mode. The
             consumer's tokens (read, replayed from the snapshot's
             history, resumed) must be the uninterrupted stream: every
             token once, the replayed ones exactly, a divergence after
             the resume only at a near-tie (top-2 gap < 2^-6 of the top
             logit, bf16), and every KV page back in its pool.
5. flash   - the flash attention kernels (forward; backward = delta
             pre-pass, dK/dV and dQ kernels) against their plain
             versions: f32 and bf16, causal or not, D in {64, 128}, S in
             {1, 129, 2048}, Sq != Sk cases (one at D 72), one
             kv_valid_len case and a bf16 case at a negative scale, q,
             k and v as the model's (B, S, H, D) views (tolerances 2e-5
             forward / 1e-4 grads in f32; in bf16 each tensor is held to
             |err| <= 2^-6 |ref| + rms(ref) / 32, see bf16_err), then the
             training shape (B 2, H 16, S 2048, D 128, causal, bf16) with
             contiguous inputs and with the views, two backward calls
             bitwise equal, the views timed as in phase 2, and the same
             at the MoE's shape (H 32, contiguous, as its GQA repeat and
             RoPE leave q, k and v); the library
             yardstick is F.scaled_dot_product_attention (forward, and
             forward plus backward), not used by the port; and at
             DiT-XL/2's attention (B 32, H 16, S 256, D 72, non-causal,
             q, k and v views of one qkv projection).
6. train parity - the training cell's widths at 2 layers, from
             init_params(seed=0), AdamW steps of make_train_step on one
             batch with attention="reference" (plain autograd) and with
             "flash" (the kernels). In f32, 3 steps without remat and
             under both remat policies: every loss within 1e-4 (relative)
             of the reference's. In bf16 (the tensor-core kernels), 2
             steps: losses within 2^-8 and each parameter's first-step
             gradient within 2^-5 (relative norm) of the reference's. The
             kernels launch as each setting implies.
7. training - bench.py's accelerator config (1.2B: vocab 32000, d_model
             2048, 16 layers, 16 heads, d_ff 8192, bf16, flash attention,
             no remat), B 2, S 2048, tokens from default_rng(0), AdamW(3e-4,
             weight_decay 0.01): one warm-up step, then 10 timed steps read
             back once at the end. The loss must fall, and each flash
             kernel run once per layer per step (counts set to 0 just
             before the timed steps).
8. sharded training - an NCCL world of one and make_mesh(MeshConfig())
             (every axis of size 1): the training phase's config, params
             and batch, 3 steps of the single-device step, then 3 steps
             of init_sharded_state + shard_train_step with
             TRANSFORMER_RULES, in turn. Losses and every parameter must
             be bitwise equal, and each flash kernel run n_layers x 3
             times on the sharded path (counts set to 0 just before its
             steps); ms per step of both (the first step untimed) and
             peak memory are logged. Then, on the mesh's size-1 axes:
             ulysses_attention at the flash phase's training shape, out
             and grads bitwise equal to flash_attention with one launch of
             each kernel; ring_attention in f32 against mha_reference
             (2e-5 forward, 1e-4 grads); pipeline_apply against the
             layers applied in sequence (1e-5).
9. moe parity - the MoE decoder (models/moe.py) at MIXTRAL_8X7B's widths
             (d_model 4096, 32 heads over 8 KV heads, d_ff 14336, 8
             experts, top-2, capacity 1.25) at 1 layer, from
             init_params(seed=0), full remat as the config sets it, the
             training batch: 3 AdamW steps in f32 with attention
             "reference" and with "flash", every loss within 1e-4 and
             step 1's routing (top_e, slot, keep) identical but at
             near-ties (reported); 2 steps in bf16 held as phase 6 holds
             the Llama, but where bf16 rounding re-routes near-tie tokens
             the MoE blocks' gradients are reported, not held (see
             bf16_parity); then on a new NCCL world of one, 3 bf16 steps of
             shard_train_step by MOE_RULES against 3 single-device steps,
             bitwise, as phase 8.
10. moe training - MIXTRAL_8X7B's widths at 4 layers (6.07B
             parameters), bf16, flash attention, full remat, B 2, S 2048,
             the training phase's tokens and optimizer: one warm-up step,
             then 5 timed steps; the loss must fall, K1 launch 2 x
             n_layers and K1-bwd n_layers times a step; ms per step,
             tokens/s, MFU (6N of the active parameters) and peak memory.

11. model families - models/dit.py, vit.py, encoder.py and ssm.py. DiT
             (the repo's DiTConfig(), B 8, perturbed weights so every
             path has a gradient): flash attention against the
             reference's, forward and the grads of ddpm_loss at fixed
             draws, f32 at 2e-5 / 1e-4, bf16 by bf16_err (outputs) and
             bf16_parity's 2^-8 (loss) and 2^-5 (grads, relative norm);
             DiT-XL/2 (672M parameters) in bf16, B 32, AdamW(1e-4): one
             warm-up step and 5 timed steps at fixed draws, the loss
             falling, K1 and K1-bwd each 28 launches a step; ddim_sample
             on DiTConfig(), 16 images, 50 steps, guidance 4.0, twice
             from one seed bitwise equal, 600 K1 launches. ViT-B/16 in
             bf16 at B 32 (forward, 3 steps; 197 tokens: no kernel, as
             the reference), BERT-base (B 8, S 512, 15% masked) and
             T5-base (source 512, target 128, B 8), 3 steps each, losses
             falling; Mamba-130M's widths at 2 layers in f32: prefill of
             2048 tokens and 64 decode steps within 2e-5 of the parallel
             forward, then 3 steps at full depth in bf16, B 2, S 2048,
             under 60 GiB; ViT-B/16's sharded step by TRANSFORMER_RULES
             on an NCCL world of one, bitwise the single-device step.
12. disaggregated prefill - run between 4b and 5, on the serving
             weights: a PrefillEngine(max_len=512) and a PrefixCache(16)
             beside the paged engine (max_batch 8, page 64, decode chunk
             8), all three sharing one weights dict. Phase 4's 8 greedy
             prompts are prefilled (misses) and handed over through
             submit_prefilled, then again (full hits, no prefill program
             runs), then each extended by 16 tokens (partial hits, only
             the suffix program runs): every stream must be the engine's
             own submit of the prompt, but at a near-tie (as 4b). Prints
             the prefill's ms per prompt for each kind, the cache's stats
             and the launches of the hand-off path.
13. checkpoint - TRAIN_CFG's widths at 4 layers (0.40B parameters), bf16,
             flash, the training batch and optimizer. Run A: 4 steps,
             saved through CheckpointManager(num_to_keep=2) on
             torch.distributed.checkpoint after steps 1-3, which keeps
             steps 2 and 3. Run B: step 2's checkpoint restored into a
             state drawn from seed 1, then steps 3 and 4: losses, every
             parameter and moment bitwise run A's. Then on an NCCL world
             of one the checkpoint restored onto init_sharded_state's
             layout by TRANSFORMER_RULES and one sharded step, bitwise run
             A's step 3. Prints the seconds to save and to restore and the
             GB written; the directory is deleted.
14. rl learners - TF32 off. PPOLearner at RLlib's Atari config
             (atari_cnn on 84x84x4 uint8 frames, 6 actions, hidden 256)
             and on CartPole (mlp, hidden 64): PPOConfig's defaults
             (batch 1024 from default_rng(0), minibatch 256, 6 epochs, 24
             updates) on the card and on the CPU from the same numpy
             params; the first update's loss within 2e-5 and grads within
             1e-4, every update's loss within 2e-5, every parameter after
             24 updates within 1e-4 but at ties (first-step ties, and at
             most 1% of a parameter's elements whose gradient
             jumped at a later update where a ReLU input sat at 0 within
             rounding), counted and held to 2 lr an update; updates/s and
             samples/s of a second learn() on the card. BC from 30 CartPole expert
             episodes (5 iterations of 40 steps, lr 3e-3) on the card:
             evaluate(3) above 100; MARWIL (beta 1), one iteration, a
             finite loss.
15. runtime serving - run after 12, on the port's own runtime
             (ray_tpu_torch.init() with its defaults: a GCS, a raylet
             with its object store, workers forked from a torch-warm
             zygote). The node's GPU resource equals the card count; a
             task without a GPU lease sees CUDA_VISIBLE_DEVICES "" and no
             device, a num_gpus=1 task one card, the driver's; no process
             of the cluster has jax, ray_tpu, msgpack or cloudpickle
             loaded. A 64 MiB bf16 CUDA tensor returned by a num_gpus=1
             task and a CPU tensor put and got come back bitwise, 4
             rounds (GB/s of each: the first round, which touches the
             arena's pages first, and the best of the others). Then
             phase 4's LLMServer at LLAMA3_8B from a num_gpus=1 Serve
             replica that builds the seed-0 weights on its own card:
             after the warm-up burst, phase 4's 9 payloads
             together, 5 through the HTTP proxy (POST /<name>?stream=1)
             and 4 through a handle; every stream 32 tokens, each greedy
             one held against the Generator on the driver's copy of the
             weights (a divergence only at a near-tie, as 4b); the
             replica's decode steps, graph replays and K3's launches (at
             least n_layers x the steps); tokens/s and TTFT beside phase
             4's; the replica's KV pages all back in their pool. The
             control path runs on the native planes (the default): with
             a plain probe actor made and a CPU task run again once its
             worker is back in the idle pool, the GCS's and the raylet's
             native_control counters each show frames handled natively,
             the raylet's lease plane a lease granted, none degraded and
             no divergence trip. Then the GCS is killed
             with the replica alive: the replica, through its actor
             handle, serves the greedy payloads while the GCS is down,
             each held against the Generator; after restart_gcs() the
             raylet re-registers, a new task runs, the Serve controller
             is found by name, the replica's actor row is ALIVE, a KV
             row written before the kill is back, and the replica serves
             the payloads again through its Serve handle, bitwise the
             tokens it gave with the GCS down; with the deployment
             deleted a num_gpus=0.25 task gets the card. Logged: seconds
             from the restart to the re-registration and to the first
             new task, and K3's launches in the step. After
             serve.shutdown() and ray_tpu_torch.shutdown() no process of
             the phase's cluster (its GCS, raylet and every process under
             them) is left and the card's free memory is back.
16. gang training - on ray_tpu_torch.init()'s defaults again.
             A num_gpus=0.25 actor forms an NCCL group of one and runs
             allreduce (sum, product, min, max), allgather,
             reducescatter (7 rows), broadcast and barrier on seeded
             bf16 and f32 CUDA tensors, bitwise the CPU's result by the
             reference's rules for a world of one. The device plane:
             phase 15's 64 MiB bf16 tensor from a num_gpus=0.25 task
             with tensor_transport="device", got by the driver, and a
             driver tensor from device_put got by a num_gpus=0.25 actor,
             bitwise, both by the ipc route with host_fallback 0 (GB/s
             beside the same task's return by the host path); the
             registries empty once the refs are dropped. Then
             TorchTrainer(num_workers=1, use_gpu=True) on half of the
             card (the other half leaves room for 4 landings of 1/8)
             trains TRAIN_CFG: the driver's seed-0 weights by
             broadcast_weights (ipc), the training phase's batch 11
             times as a Dataset of token rows from default_rng(0) with a
             map_batches stage, read with iter_device_batches (device
             landings), make_train_step over K1 and K1-bwd, one warm-up
             and 10 timed steps each reported with its loss and time.
             The losses must equal the training phase's, bitwise, and
             fall; K1 and K1-bwd launch 16 times a step in the worker;
             every batch a device landing by the ipc route; tokens/s
             beside the training phase's. After the shutdown no process
             of the phase's cluster is left and the card's memory is
             back.
17. disaggregated serving - run after 16, on a cluster_utils.Cluster:
             the head node holds the driver (the router) and the
             prefill replica, two nodes with a `decode` resource a
             decode replica each, every node the one card.
             serve.deploy_disagg at LLAMA3_8B (bf16, seed 0, each replica
             building the weights on half of its node's card;
             page_size=64, max_batch=8, max_len=512, decode_chunk=8).
             Round A: phase 4's 9 payloads together through
             DisaggHandle.stream, every greedy stream phase 15's
             Generator tokens (a divergence only at a near-tie, judged
             by a decode replica's dense oracle: the driver keeps no
             weights); the first prompt again, a prefix-cache hit; the
             decode side's KV hand-offs by the ipc route only; K3's
             launches in the decode replicas' graphs at least n_layers x
             their decode steps; tokens/s and TTFT beside phases 15 and
             4, the prefill's ms a prompt, the hand-offs' ms and GB/s.
             Round B: two greedy streams on 4-token buffers, 3 tokens
             read of each, the decode node holding a stream preempted
             (NodePreempter, deadline 10 s: DRAINED, then killed);
             every token once and the Generator's, a resume from the
             drain's evacuation (evac_resumes, the driver's
             evacuated_in); the seconds from the drain to the next
             token. No process of the phase left, memory back.
18. elastic gang - run last, on a cluster_utils.Cluster whose gang
             nodes carry a `trainer` resource (two, then a third):
             TorchTrainer(num_workers=2, use_gpu=True,
             elastic=ElasticConfig(min_workers=1, max_workers=2)) on
             gloo (two NCCL ranks cannot share a card) trains
             CKPT_CFG (0.40B) from the driver's seed-0 weights, every
             rank on the training batch. After step 3 rank 1's node is
             drained without a kill (the gang shrinks to 1), then
             removed and a node added (the gang grows back to 2, the
             new rank seeded from rank 0 by the device plane); steps
             4-7 run on 1 rank, 8-11 on 2. The 12 losses bitwise an
             uninterrupted in-process run's; every start state (the
             survivor's, the departed rank's tree, the grown rank's)
             the kept state of its step by per-tensor checksums;
             shrinks 1, grows 1, no fallback, no restart, no
             checkpoint; K1 and K1-bwd once a layer a step in every
             worker. Prints ms a step on 2 ranks and on 1, the seconds
             from the drain to the smaller gang's first step and from
             the new node to the grown gang's, and each hand-off's bytes
             and route. No process left, memory back. Neither phase's
             processes load jax, ray_tpu, msgpack or cloudpickle.
19. rl on the runtime - run after 18, on ray_tpu_torch.init()'s
             defaults, TF32 off. (a) PPO at RLlib's Atari config
             (atari_cnn, hidden 256, on VisualCatch-v0's 42x42x1
             frames; PPOConfig's defaults: 2 rollout workers x 512
             steps, batch 1024, minibatch 256, 6 epochs), PPOConfig
             .build() with the learner in the driver on the card, 3
             iterations: every loss term finite; the first iteration's
             24 updates run again on the CPU from the same batch and
             params, held by phase 14's limits; the rollout workers
             report no CUDA context and no banned package, nor does the
             driver. (b) The same with num_learners=2: two LearnerActors
             on half the card each over gloo, 2 iterations; the
             fingerprints equal after every update; the first
             update_shards within 1e-4 of the mean-gradient step on the
             CPU from the same shards (first-step ties as phase 14's).
             (c) One iteration each of IMPALA (num_learners=2), APPO,
             PG, A2C and A3C on CartPole, learners on the card, and of
             ES and ARS, at their configs' defaults: all finite. Logs
             each algorithm's sample and learn seconds, samples/s and
             updates/s, and the groups' gradient mean in ms and bytes
             an update. No kernel lies on this path: the kernels line's
             `rl_launches` are this process's counts over the phase (0).
             After the shutdown no process of the phase's cluster is
             left.
20. off-policy rl - run after 19, on ray_tpu_torch.init()'s defaults,
             TF32 off. DQN, SimpleQ, Ape-X, Rainbow and R2D2 on CartPole,
             TD3, DDPG and SAC on Pendulum, MADDPG on CoopNav, SlateQ on
             SlateDocEnv and AlphaZero on TicTacToe, each at its config's
             defaults (the reference's widths), XConfig().build() with
             the learner in the driver on the card, train() until an
             iteration updates (its learning_starts or batch size met);
             then CQL and CRR at their defaults on phase 14's 30 CartPole
             episodes written by write_offline_json. The first updating
             iteration's updates run again on the CPU from the same state
             trees, batches and noise: every output (losses, Ape-X's and
             Rainbow's new priorities) within 2e-5, every parameter,
             target and log_alpha within 1e-4 but at ties, as phase 14;
             every loss finite; the rollout and self-play actors report
             no CUDA context and no banned package, nor does the driver.
             Logs each algorithm's samples/s, updates/s and median ms an
             update. No kernel lies on this path: the kernels line's
             `offpolicy_launches` are this process's counts over the
             phase (0). After the shutdown no process of the phase's
             cluster is left.
21. last learners and tune - run after 20, TF32 off. DT on phase 14's
             30 CartPole episodes written by write_offline_json, QMIX on
             CoopSwitch and DreamerV3 on CartPole, each at its config's
             defaults (the reference's widths: DT 64 wide, 2 layers, 2
             heads, K 8; QMIX 32 and 16; DreamerV3 deter 128, 8 x 8
             latents, hidden 128, batch 16 x 16, horizon 15),
             XConfig().build() on the card, 2 iterations (DreamerV3's
             second is its first with updates), then DT's
             evaluate(episodes=2). The first update runs again on the
             CPU from the same state, arguments and Gumbel noise: outputs
             within 2e-5, state within 1e-4 but at ties, as phase 20 (DT's
             key biases, whose gradient is 0 but for rounding, held to 2
             lr). Logs updates/s, the median ms of an update and, for
             QMIX and DreamerV3, whose acting runs on the card, env
             steps/s. Then on ray_tpu_torch.init()'s defaults: a Tuner
             with ASHAScheduler runs 4 DT trials at {"CPU": 1, "GPU":
             0.25}, each reporting its loss and the card it leased (the
             one card, in its lease and CUDA_VISIBLE_DEVICES), at least
             one stopped early, the best a finished trial; then
             PopulationBasedTraining runs 2 such trials checkpointing
             with torch.save, and an exploit must restart a trial from
             the other trial's checkpoint; a Pool worker (no CUDA
             context) and a Queue first. Every loss finite, no trial or helper
             process with a banned package, the seconds to each trial's
             first report logged. No kernel lies on this path: the
             kernels line's `last_launches` are this process's counts
             over the phase (0). After the shutdown no process of the
             phase's cluster is left.
22. control plane - run last, no model. Two fresh clusters on
             ray_tpu_torch.init()'s defaults but idle leases returned
             after 0.2 s, one with the switch RAY_TPU_TORCH_NATIVE_CONTROL
             on (the daemons' and workers' native pumps, the planes, the
             in-pump GCS service, the native scheduler) and one with it
             off: 2,000 no-op tasks, 2,000 calls on one actor and 100
             actor creations, each after a warm-up, as rates beside the
             card's name and power limit (host numbers of the card's
             machine); then 20 waves of 4 no-op tasks, each on a warm
             idle pool, whose leases the lease plane grants natively,
             their median, p90 and least ms. With the switch on each
             daemon reports a plane that handled frames, the raylet's
             native leases in the waves > 0, none degraded; with it off
             neither has one. No process of either cluster is left.
Phase 4b also holds the dense engine's prefills to the device plane:
each hands its KV to decode by local_handoff, so the plane's in_process
counter rises by at least 2 x n_layers a prefill and host_fallback stays
0.

Prints the kernels as one JSON line (a paged kernel's `launches` from
the serving phase, graph replays included; a flash kernel's from the
training phase, `sharded_launches` from the sharded one,
`moe_launches` from the MoE training phase, `moe_sharded_launches`
from phase 9's sharded steps, `dit_launches` from DiT-XL/2's timed
steps, `dit_sample_launches` from the sampler's run and
`checkpoint_launches` from phase 13's run A, `gang_launches` from
phase 16's gang worker, `elastic_launches` from phase 18's workers; a
paged kernel's `disagg_launches` from phase 12's hand-offs, every
kernel's `rl_launches` from phase 19, `offpolicy_launches` from phase
20, `last_launches` from phase 21 and `control_launches` from phase 22
(0: no kernel on the RL, Tune and control-plane paths),
`runtime_launches` from phase 15's replica, `restart_launches` from
its GCS restart step and `disagg_serve_launches` from phase 17's decode
replicas; a flash kernel's `dit_shape`
the times at DiT-XL/2's attention, B 32, H 16, S 256, D 72, non-causal),
the card's name and power limit, and
last {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ray_tpu_torch import _build
from ray_tpu_torch.models import (BERT_BASE, LLAMA3_8B, MAMBA_130M,
                                  MIXTRAL_8X7B, MOE_RULES, T5_BASE, VIT_B16,
                                  DiT, DiTConfig, Generator, LlamaConfig,
                                  SamplingParams, count_dit_params,
                                  count_flops_per_token, cross_entropy_loss,
                                  init_kv_caches, init_params, mlm_loss,
                                  moe_aux_loss, seq2seq_loss, ssm_decode_step,
                                  ssm_prefill, vit_loss)
from ray_tpu_torch.models.convert import model_class
from ray_tpu_torch.models.vit import ViTConfig
from ray_tpu_torch.models import dit, moe
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.parallel import (TRANSFORMER_RULES, MeshConfig, P,
                                    initialize_multihost, make_mesh,
                                    pipeline_apply)
from ray_tpu_torch.rllib import (BCConfig, CartPole, MARWILConfig, PPOConfig,
                                 PPOLearner, get_model, write_offline_json)
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, _Prefilled
from ray_tpu_torch.serve.llm_disagg import (DecodeServer, PrefillEngine,
                                            PrefillServer, PrefixCache,
                                            disagg_counts)
from ray_tpu_torch.train import (adamw, init_sharded_state, init_train_state,
                                 make_train_step, shard_train_step)
from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            restore_pytree)
from ray_tpu_torch.util.collective import ops as col

H, HKV, D, PAGE = 32, 8, 128, 64                 # LLAMA3_8B, engine page
MAX_LEN, CHUNK, MAX_BATCH = 512, 8, 8
NP = -(-(MAX_LEN + CHUNK) // PAGE)              # the engine's table width
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SOURCE = "ray_tpu_torch/ops/csrc/paged_decode.cu"
KERNELS = {  # launch-count key -> the TPU kernel it replaces
    "paged_decode_attention": "ray_tpu/ops/paged_attention.py:99",
    "paged_decode_attention_batch": "ray_tpu/ops/paged_attention.py:172",
    "paged_decode_attention_batch_fused": "ray_tpu/ops/paged_attention.py:193",
}
ON_PATH = "paged_decode_attention_batch"
FLASH_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_KERNELS = {  # launch-count key -> the TPU function it replaces
    "flash_attention_forward": "ray_tpu/ops/attention.py:50",
    "flash_attention_backward": "ray_tpu/ops/attention.py:231",
}
FLASH_F32_TOL = (2e-5, 1e-4)                    # forward, grads
# bench.py's accelerator config (bench.py:279-284), and its batch.
TRAIN_CFG = LlamaConfig(vocab_size=32000, d_model=2048, n_layers=16,
                        n_heads=16, n_kv_heads=16, d_ff=8192,
                        max_seq_len=2048, dtype=torch.bfloat16,
                        attention="flash", remat=False)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 10
# TRAIN_CFG's widths at 4 layers (0.40B parameters): its bf16 params and
# two AdamW moments are about 2.4 GB on disk.
CKPT_CFG = dataclasses.replace(TRAIN_CFG, n_layers=4)
SHARDED_STEPS = 3
# MIXTRAL_8X7B's widths cut to 4 layers: 6.07B parameters, whose bf16
# weights, grads and two AdamW moments take about 45 GiB of the card.
MOE_TRAIN_CFG = dataclasses.replace(MIXTRAL_8X7B, n_layers=4)
MOE_TRAIN_STEPS = 5
# DiT-XL/2's published widths (Peebles & Xie 2023, Table 1: 28 layers,
# width 1152, 16 heads, patch 2) on the 32 x 32 x 4 latents of a 256 x 256
# image, 1000 classes: 672M parameters (count_dit_params), bf16, B 32.
DIT_XL2 = DiTConfig(image_size=32, channels=4, patch_size=2, d_model=1152,
                    n_layers=28, n_heads=16, num_classes=1000)
DIT_B, DIT_STEPS = 32, 5
SAMPLE_STEPS, SAMPLE_NUM, GUIDANCE = 50, 16, 4.0
VIT_B, ENC_B, BERT_S, T5_SRC, T5_TGT = 32, 8, 512, 512, 128
# Mamba-130M trains at full depth on B x S tokens; its scan keeps two
# (B, S, 1536, 16) f32 tensors a layer for the backward, about 13 GiB of
# the 24 layers at B 2, S 2048.
MAMBA_B, MAMBA_S, FAMILY_STEPS = 2, 2048, 3
# NVIDIA data sheets, dense: (memory B/s, f32 FLOP/s, bf16 FLOP/s).
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
         "SXM": (3.35e12, 67e12, 989e12)}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


class Timer:
    """Median CUDA-event time of fn, the L2 cache flushed before each run.

    Two readings. The plain one (`ms`) records the start event right after
    the flush, so where the host takes longer to reach fn's launches than
    the card takes to flush, host time is in it. The busy one (`busy_ms`)
    keeps the card spinning for about a millisecond after the flush
    (`torch.cuda._sleep`), so that fn's launches are queued before the
    start event is reached: device time only."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self._flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 25, busy: bool = False) -> float:
        fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            if busy:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def row(self, kernel, plain, library, plain_reps: int = 25) -> dict:
        """The timed keys of a kernels-line row."""
        return {"ms": self(kernel), "busy_ms": self(kernel, busy=True),
                "plain_ms": self(plain, reps=plain_reps),
                "library_ms": self(library),
                "library_busy_ms": self(library, busy=True)}


TIMED = ("max_abs_err", "ms", "busy_ms", "plain_ms", "bound_ms", "library_ms",
         "library_busy_ms")


def kernel_inputs(B: int, dtype, seed: int):
    """Pools holding noise everywhere, sequences on shuffled pages, tables
    padded with each sequence's last page; lengths mixed and seeded."""
    rng = np.random.default_rng(seed)
    lengths = [1, 64, 65, 511, NP * PAGE]
    lengths += [int(x) for x in rng.integers(1, NP * PAGE + 1,
                                             B - len(lengths))]
    P = B * NP + 1
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    k_pool, v_pool, q = randn(P, HKV, PAGE, D), randn(P, HKV, PAGE, D), \
        randn(B, H, D)
    free = [int(x) for x in rng.permutation(P)]
    rows = []
    for length in lengths:
        own = [free.pop() for _ in range(-(-length // PAGE))]
        rows.append((own + [own[-1]] * NP)[:NP])
    tables = torch.tensor(rows, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, k_pool, v_pool, tables, lens), lengths


def library_attention(q, k_pool, v_pool, tables, lengths):
    """One PyTorch call for the same function: page gather + SDPA."""
    B = q.shape[0]
    idx = tables.long()
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, HKV, NP * PAGE, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, HKV, NP * PAGE, D)
    mask = torch.arange(NP * PAGE, device=q.device)[None] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None], enable_gqa=True)


def bound_ms(lengths, B, dtype, card: str):
    """Least time for the call: each live K/V byte, q, out, tables and
    lengths moved once, or its flops at the card's peak, the larger."""
    mem_rate, f32_rate, bf16_rate = peaks(card)
    item = torch.tensor([], dtype=dtype).element_size()
    tokens = sum(min(x, NP * PAGE) for x in lengths)
    nbytes = tokens * HKV * D * 2 * item + 2 * B * H * D * item \
        + B * (NP + 1) * 4
    flops = 4 * H * D * tokens            # q.k and p.v, a multiply-add each
    t_bytes = nbytes / mem_rate
    t_ops = flops / (f32_rate if dtype == torch.float32 else bf16_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, want, tol) -> float:
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    return (out.float() - want.float()).abs().max().item()


def bf16_err(out, want):
    """Holds a bf16 result to |err| <= 2^-6 |want| + max(rms(want) / 32,
    1e-5) elementwise: kernel and plain version round P, dS and the
    outputs to bf16 at the same places, so they differ where the f32 sum
    order moves a value across a rounding boundary, one ulp (2^-8 to 2^-7
    of the value) of the output or of a P or dS term; rms / 32 is about
    four ulps at the tensor's typical size, for values that cancel to
    near 0. Returns (max abs error, margin), the margin being the largest
    ratio of error to allowance (1 at the limit)."""
    out, want = out.float(), want.float()
    rtol, atol = 2 ** -6, max(want.square().mean().sqrt().item() / 32, 1e-5)
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    err = (out - want).abs()
    return err.max().item(), (err / (rtol * want.abs() + atol)).max().item()


def length_zero_case(args, tol, what: str) -> None:
    """K2, K3 and K4 with every other sequence at length 0, against the
    plain version, which averages V over the table there."""
    q, k_pool, v_pool, tables, lens = args
    lens = lens.clone()
    lens[::2] = 0
    want = pa.paged_decode_attention_batch_reference(q, k_pool, v_pool,
                                                     tables, lens)
    errs = [max_err(pa.paged_decode_attention_batch(
        q, k_pool, v_pool, tables, lens, fused_heads=fused), want, tol)
        for fused in (False, True)]
    errs.append(max(max_err(
        pa.paged_decode_attention(q[b], k_pool, v_pool, tables[b], lens[b]),
        want[b], tol) for b in range(0, q.shape[0], 2)))
    log(f"length 0 {what}: K3, K4, K2 max abs err "
        + ", ".join(f"{e:.3g}" for e in errs))


def kernel_phase(card: str) -> dict:
    """Checks and times every kernel; returns the main-path (B=8, bf16)
    row of each for the kernels line."""
    timer = Timer()
    rows = {}
    for B in (MAX_BATCH, 32):
        for dtype in (torch.float32, torch.bfloat16):
            args, lengths = kernel_inputs(B, dtype, seed=B)
            tol = TOL[dtype]
            cases = {}
            for fused in (False, True):
                name = ("paged_decode_attention_batch_fused" if fused
                        else "paged_decode_attention_batch")
                out = pa.paged_decode_attention_batch(*args,
                                                      fused_heads=fused)
                want = pa.paged_decode_attention_batch_reference(*args)
                cases[name] = (
                    max_err(out, want, tol),
                    lambda f=fused: pa.paged_decode_attention_batch(
                        *args, fused_heads=f),
                    lambda: pa.paged_decode_attention_batch_reference(*args),
                    lambda: library_attention(*args),
                    bound_ms(lengths, B, dtype, card))
            q, k_pool, v_pool, tables, lens = args
            err = 0.0
            for b in range(B):
                one = (q[b], k_pool, v_pool, tables[b], lens[b])
                err = max(err, max_err(pa.paged_decode_attention(*one),
                                       pa.paged_decode_attention_reference(
                                           *one), tol))
            full = lengths.index(NP * PAGE)   # time the full-table sequence
            one = (q[full], k_pool, v_pool, tables[full], lens[full])
            one_b = (q[full:full + 1], k_pool, v_pool,
                     tables[full:full + 1], lens[full:full + 1])
            cases["paged_decode_attention"] = (
                err, lambda: pa.paged_decode_attention(*one),
                lambda: pa.paged_decode_attention_reference(*one),
                lambda: library_attention(*one_b),
                bound_ms([NP * PAGE], 1, dtype, card))
            torch.cuda.synchronize()
            length_zero_case(args, tol, f"B={B} {str(dtype)[6:]}")
            for name, (err, kernel, plain, library, (bound, by)) in \
                    cases.items():
                row = {"name": name, "route": "cuda", "source": SOURCE,
                       "replaces": KERNELS[name], "max_abs_err": err,
                       "bound_ms": bound, "bound_by": by,
                       **timer.row(kernel, plain, library)}
                log(f"kernel {name} B={B} {str(dtype)[6:]}: " + json.dumps(
                    {k: row[k] for k in TIMED}))
                if B == MAX_BATCH and dtype == torch.bfloat16:
                    rows[name] = row
    return rows


@torch.no_grad()
def top2(model, cfg, tokens) -> tuple[float, float]:
    """Dense-oracle top-2 logit gap after `tokens`, and the top logit."""
    dev = model.embed.weight.device
    t = torch.tensor([tokens], device=dev)
    pos = torch.arange(len(tokens), device=dev)[None]
    logits, _ = model(t, pos, kv_caches=init_kv_caches(cfg, 1, len(tokens),
                                                       dev))
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item(), top[0].item()


def hold_greedy(what: str, model, cfg, prompt, toks, want, tie: float,
                replayed: int = 0) -> None:
    """`toks` must equal `want`, or first diverge from it at a near-tie:
    the oracle's top-2 gap there below `tie`, for bf16 `tie` times the top
    logit's size (at least 1). The first `replayed` tokens must be equal
    whatever the gap. `model` is the dense oracle, or a function of the
    tokens giving (gap, top) where the weights live in another process."""
    if toks == want:
        return
    n = min(len(toks), len(want))
    j = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b), n)
    if j == n or j < replayed:
        raise AssertionError(f"{what}: {toks} != {want}")
    gap, top = (top2(model, cfg, prompt + want[:j])
                if isinstance(model, torch.nn.Module)
                else model(prompt + want[:j]))
    limit = tie * (max(abs(top), 1.0) if cfg.dtype == torch.bfloat16 else 1)
    log(f"{what}: prompt of {len(prompt)} diverges at token {j}, top-2 gap "
        f"{gap:.3g} (limit {limit:.3g})")
    if not gap < limit:
        raise AssertionError(f"{what}: {toks} != {want}")


# LLMEngine options of the parity phase, each held against the Generator.
PARITY_ENGINES = {"paged engine": {"page_size": PAGE},
                  "dense engine": {},
                  "dense engine, prefill_chunk=16": {"prefill_chunk": 16}}


def parity_phase():
    # f32 matmuls in full f32 on both sides of the comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 17, 64, 100)]
    n_new = 16
    wants = []
    for p in prompts:
        gen = Generator(cfg, params, batch=1, max_len=len(p) + n_new)
        wants.append([int(x) for x in gen.generate(
            [p], SamplingParams(max_new_tokens=n_new))[0]])
    oracle = gen.model  # the dense-cache model on the same weights
    for name, opts in PARITY_ENGINES.items():
        eng = LLMEngine(cfg, params, max_batch=4, max_len=256,
                        decode_chunk=CHUNK, **opts)
        try:
            handles = [eng.submit(p, SamplingParams(max_new_tokens=n_new))
                       for p in prompts]
            got = [h.tokens() for h in handles]
        finally:
            eng.shutdown()
        recorded = eng.graph_launches[ON_PATH]
        if not eng.graph_replays or recorded != (
                cfg.n_layers * CHUNK if "page_size" in opts else 0):
            raise AssertionError(f"{name}: {eng.graph_replays} graph replays"
                                 f", {recorded} {ON_PATH} launches a replay")
        for p, toks, want in zip(prompts, got, wants):
            hold_greedy(f"parity: {name}", oracle, cfg, p, toks, want,
                        1e-3)
        log(f"parity: {len(prompts)} prompts x {n_new} greedy tokens, {name}"
            f" (decode graph replayed {eng.graph_replays} times, {recorded} "
            f"{ON_PATH} launches each) == dense Generator")


def pages_returned(eng, timeout: float = 10.0) -> bool:
    """Whether every KV page of a paged engine is back in its pool (less
    the dummy page), waiting up to `timeout`: a stream's pages return just
    after its last token."""
    deadline = time.time() + timeout
    while eng.page_size and time.time() < deadline \
            and eng._alloc.free_pages != eng._alloc.num_pages - 1:
        time.sleep(0.01)
    return not eng.page_size or \
        eng._alloc.free_pages == eng._alloc.num_pages - 1


def serving_payloads(cfg):
    """The serving phase's requests: 8 greedy prompts of 17-200 tokens and
    one sampled request, 32 new tokens each; and a warm-up burst."""
    rng = np.random.default_rng(2)

    def prompt(n):
        return [int(x) for x in rng.integers(1, cfg.vocab_size, n)]

    n_new = 32
    payloads = [{"prompt_tokens": prompt(int(n)), "max_new_tokens": n_new}
                for n in rng.integers(17, 201, MAX_BATCH)]
    payloads.append({"prompt_tokens": prompt(int(rng.integers(17, 201))),
                     "max_new_tokens": n_new, "temperature": 0.8,
                     "top_k": 50, "top_p": 0.9})
    warm = [{"prompt_tokens": prompt(64), "max_new_tokens": 8}
            for _ in range(MAX_BATCH)]
    return payloads, warm


def serve_payloads(server, cfg, window=None) -> dict:
    """Sends the warm-up burst (it also captures the decode graph), then
    the payloads together, each consumed on its own thread; `window` (a
    context manager, such as a torch.profiler.profile) wraps just the
    timed part. Launch counts are set to 0 just before the requests and
    read just after them. Checks every stream and returns the run's
    figures."""
    eng = server.engine
    payloads, warm = serving_payloads(cfg)
    results = [{} for _ in payloads]

    def consume(payload, rec):
        toks = []
        try:
            for tok in server(payload):
                if not toks:
                    rec["first"] = time.perf_counter()
                toks.append(tok)
        except Exception as e:  # recorded; the phase fails below
            rec["error"] = e
        rec["tokens"], rec["end"] = toks, time.perf_counter()

    handles = [eng.submit(w["prompt_tokens"], SamplingParams(max_new_tokens=8))
               for w in warm]
    for h in handles:
        h.tokens()
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    steps0, replays0 = eng.decode_steps, eng.graph_replays
    with window or contextlib.nullcontext():
        start = time.perf_counter()
        threads = []
        for payload, rec in zip(payloads, results):
            rec["submit"] = time.perf_counter()
            th = threading.Thread(target=consume, args=(payload, rec))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(600)
        torch.cuda.synchronize()
    counts = dict(pa.launch_counts)
    steps = eng.decode_steps - steps0
    replays = eng.graph_replays - replays0
    if not pages_returned(eng):
        raise AssertionError("KV pages not returned")
    for rec, payload in zip(results, payloads):
        if "error" in rec or len(rec.get("tokens", [])) != \
                payload["max_new_tokens"]:
            raise AssertionError(f"request of {len(payload['prompt_tokens'])}"
                                 f" tokens: {rec}")
        if not all(0 <= t < cfg.vocab_size for t in rec["tokens"]):
            raise AssertionError(f"token out of the vocabulary: {rec}")
    if steps == 0 or replays * CHUNK != steps:
        raise AssertionError(f"{steps} decode steps in {replays} replays of "
                             "the decode graph")
    wall = max(r["end"] for r in results) - start
    ttft = sorted((r["first"] - r["submit"]) * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    # The wrappers count a launch where Python launches it: under the
    # graph, once at capture, so a replay's launches are the graph's.
    graph = {k: n * replays for k, n in eng.graph_launches.items()}
    return {"requests": len(results), "failed": 0, "tokens": n_tok,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(ttft), "ttft_max_ms": ttft[-1],
            "decode_steps": steps, "graph_replays": replays,
            "eager_launches": counts, "graph_launches": graph,
            "launches": {k: counts[k] + graph[k] for k in counts}}


def serving_weights() -> dict:
    """LLAMA3_8B's bf16 weights from seed 0, on the card."""
    t0 = time.perf_counter()
    params = init_params(LLAMA3_8B, seed=0)
    log(f"serving: LLAMA3_8B bf16 weights ready in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def serving_phase(card: str, window=None, params=None) -> dict:
    """Serves the 9 requests through LLMServer over the paged engine, its
    decode chunk a CUDA graph; returns the run's figures, the kernels'
    launches under "launches"."""
    cfg = LLAMA3_8B
    if params is None:
        params = serving_weights()
    server = LLMServer(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       page_size=PAGE, decode_chunk=CHUNK)
    del params  # the engine's model holds the same tensors
    try:
        run = serve_payloads(server, cfg, window)
    finally:
        server.engine.shutdown()
    launches = run["launches"]
    if launches[ON_PATH] < cfg.n_layers * run["decode_steps"]:
        raise AssertionError(f"{ON_PATH} launched {launches[ON_PATH]} times "
                             f"for {run['decode_steps']} decode steps of "
                             f"{cfg.n_layers} layers")
    log("serving: " + json.dumps({"card": card, **run}))
    return run


def chunked_prefill_check(cfg, params) -> dict:
    """A dense engine with prefill_chunk=64 takes a 448-token prompt (7
    chunks) while two 16-token streams decode: the short streams must
    keep emitting while the long prompt prefills."""
    rng = np.random.default_rng(3)
    short = [[int(x) for x in rng.integers(1, cfg.vocab_size, 16)]
             for _ in range(2)]
    long_prompt = [int(x) for x in rng.integers(1, cfg.vocab_size, 448)]
    n_chunks = -(-len(long_prompt) // 64)
    eng = LLMEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                    decode_chunk=CHUNK, prefill_chunk=64)
    arrivals = [[] for _ in short]  # (time, engine decode steps) a token

    def consume(handle, out):
        for _tok in handle:
            out.append((time.perf_counter(), eng.decode_steps))

    try:
        # A first request captures the decode graph, outside the window.
        eng.generate(short[0], SamplingParams(max_new_tokens=CHUNK))
        handles = [eng.submit(p, SamplingParams(max_new_tokens=128))
                   for p in short]
        threads = [threading.Thread(target=consume, args=(h, a))
                   for h, a in zip(handles, arrivals)]
        for th in threads:
            th.start()
        deadline = time.time() + 120
        while not all(arrivals) and time.time() < deadline:
            time.sleep(0.001)
        t_submit, steps_submit = time.perf_counter(), eng.decode_steps
        long_handle = eng.submit(long_prompt, SamplingParams(max_new_tokens=32))
        it = iter(long_handle)
        next(it)
        t_first, steps_first = time.perf_counter(), eng.decode_steps
        n_long = 1 + len(list(it))
        for th in threads:
            th.join(600)
    finally:
        eng.shutdown()
    if n_long != 32 or any(len(a) != 128 for a in arrivals):
        raise AssertionError(f"chunked prefill: {n_long} long-prompt tokens, "
                             f"{[len(a) for a in arrivals]} short-stream")
    during = [[s for t, s in a if t_submit <= t <= t_first] for a in arrivals]
    ticks = (steps_first - steps_submit) // CHUNK
    gaps = [max((b - a) // CHUNK for a, b in zip(d, d[1:])) if len(d) > 1
            else None for d in during]
    figures = {"prefill_chunks": n_chunks, "long_ttft_ms":
               (t_first - t_submit) * 1e3, "decode_ticks_during_prefill":
               ticks, "short_tokens_during_prefill": [len(d) for d in during],
               "max_ticks_between_short_tokens": gaps}
    # Each prefill chunk's tick but the last runs a decode chunk after it.
    if ticks < n_chunks - 1 or min(len(d) for d in during) < \
            (n_chunks - 2) * CHUNK:
        raise AssertionError(f"the short streams stalled: {figures}")
    return figures


# A bf16 divergence passes where the oracle's top-2 gap is below 2^-6 of
# the top logit (four bf16 ulps): the paged kernel and the dense einsum
# round attention outputs to bf16 at different points.
BF16_TIE = 2 ** -6
ENGINE_MODES = {"paged": {"page_size": PAGE}, "dense": {}}


def drain_round_trip(cfg, params, src: str, dst: str) -> dict:
    """Two streams on a `src` engine with a 4-token stream buffer, each
    read for 3 tokens and left to park; then quiesce, snapshot and
    submit_prefilled into a `dst` engine. What the consumer gets (the
    tokens it read, the snapshot's history it never received, then the
    resumed stream) must be the uninterrupted stream on the `src` engine:
    every token once, the replayed part exactly, and past the resume a
    divergence only at a near-tie."""
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
               for n in (40, 90)]
    sp = SamplingParams(max_new_tokens=32)
    a = LLMEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                  decode_chunk=CHUNK, stream_buffer=4, **ENGINE_MODES[src])
    b = None
    try:
        want = [h.tokens() for h in [a.submit(p, sp) for p in prompts]]
        handles = [a.submit(p, sp, tag=f"s{i}")
                   for i, p in enumerate(prompts)]
        its = [iter(h) for h in handles]
        seen = [[next(it) for _ in range(3)] for it in its]
        deadline = time.time() + 60
        while not all(h.backlog_full() for h in handles) \
                and time.time() < deadline:
            time.sleep(0.005)
        if not a.quiesce_for_drain():
            raise AssertionError("drain: the engine did not quiesce")
        snaps = a.snapshot_active_streams()
        b = LLMEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      decode_chunk=CHUNK, **ENGINE_MODES[dst])
        got, replayed = [], []
        for i, s in enumerate(seen):
            snap = snaps[f"s{i}"]
            if snap["history"][:len(s)] != s:
                raise AssertionError(f"drain: history {snap['history']} "
                                     f"does not start with {s}")
            pack = _Prefilled(snap["kv"], snap["token"], snap["prompt_len"],
                              snap["lens"], snap["generated"],
                              snap["history"], emit_first=False)
            handle = b.submit_prefilled(pack, sp)
            got.append(s + snap["history"][len(s):] + handle.tokens())
            replayed.append(len(snap["history"]))
        returned = pages_returned(b)
    finally:
        a.shutdown()   # fails the drained streams' handles on `a`
        if b is not None:
            b.shutdown()
    if not (returned and pages_returned(a, 0)):
        raise AssertionError(f"drain: {src} -> {dst} left KV pages")
    for p, toks, w, n in zip(prompts, got, want, replayed):
        hold_greedy(f"drain {src} -> {dst}", b.model, cfg, p, toks, w,
                    BF16_TIE, replayed=n)
    return {"streams": len(got), "tokens": [len(t) for t in got],
            "read_before_drain": [len(s) for s in seen],
            "replayed_from_history": [n - len(s) for n, s in
                                      zip(replayed, seen)],
            "equal_to_uninterrupted": [t == w for t, w in zip(got, want)],
            "kv_dtype": str(snaps["s0"]["kv"][0][0].dtype)}


def serving_modes_phase(card: str, params) -> None:
    """LLAMA3_8B bf16, the serving phase's weights shared by every engine:
    the dense engine serves the serving phase's requests, chunked prefill
    keeps short streams emitting, and drained streams resume in an engine
    of the other mode, both ways."""
    from ray_tpu_torch._private import device_objects

    cfg = LLAMA3_8B
    server = LLMServer(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       decode_chunk=CHUNK)
    eng, prefills = server.engine, [0]
    real_prefill = eng._prefill_one

    def prefill_one(tokens):
        prefills[0] += 1
        return real_prefill(tokens)

    eng._prefill_one = prefill_one
    before = device_objects.counters()
    try:
        run = serve_payloads(server, cfg)
    finally:
        server.engine.shutdown()
    after = device_objects.counters()
    # Every dense prefill hands its KV (a K and a V a layer) to decode
    # through the device plane's same-process route, never the host's.
    plane = {k: after[k] - before[k]
             for k in ("in_process", "released", "host_fallback")}
    run["device_plane"] = {"dense_prefills": prefills[0], **plane}
    if not prefills[0] or plane["host_fallback"] or \
            plane["in_process"] < 2 * cfg.n_layers * prefills[0]:
        raise AssertionError(f"serving modes: the dense prefills' KV "
                             f"hand-offs: {run['device_plane']}")
    log("serving modes: dense engine: " + json.dumps({"card": card, **run}))
    log("serving modes: chunked prefill: "
        + json.dumps(chunked_prefill_check(cfg, params)))
    for src, dst in (("paged", "dense"), ("dense", "paged")):
        log(f"serving modes: drain {src} -> {dst}: "
            + json.dumps(drain_round_trip(cfg, params, src, dst)))


def flash_bound_ms(B, H, Sq, Sk, D, causal, dtype, card, backward):
    """Least time for the call: its flops (4 per visible (query, key) pair
    and head dim forward, 10 backward) at the card's peak for the input
    type, or each input read and each output written once, the larger."""
    mem_rate, f32_rate, bf16_rate = peaks(card)
    item = torch.tensor([], dtype=dtype).element_size()
    keys = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = (10 if backward else 4) * B * H * keys * D
    rows = 4 * (Sq + Sk) if backward else 2 * (Sq + Sk)  # q,k,v,o,dO,dq,dk,dv
    nbytes = B * H * (rows * D * item + Sq * 4)          # and lse
    t_bytes = nbytes / mem_rate
    t_ops = flops / (f32_rate if dtype == torch.float32 else bf16_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_inputs(dtype, B, H, Sq, Sk, D, seed=0, views=True):
    """q, k, v, dO; with `views`, q, k and v as the Llama hands them over,
    (B, S, H, D) tensors seen as (B, H, S, D); with views="qkv" as DiT
    does, the three head groups of one (B, S, 3H, D) projection seen as
    (B, 3H, S, D); else contiguous."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, s, D, generator=g, device="cuda")
                   .to(dtype) for s in (Sq, Sk, Sk, Sq))
    if views == "qkv":
        q, k, v = torch.cat([q, k, v], dim=1).transpose(1, 2).contiguous() \
            .transpose(1, 2).chunk(3, dim=1)
    elif views:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    return q, k, v, do


def flash_case(dtype, B, H, Sq, Sk, D, causal, kv_valid_len=None,
               views=True, scale=None):
    """Forward and backward kernels against the plain versions (scale
    1 / sqrt(D) unless given); returns (inputs, residuals, max abs errors
    of out and of dq, dk, dv)."""
    q, k, v, do = flash_inputs(dtype, B, H, Sq, Sk, D, views=views)
    if scale is None:
        scale = 1 / math.sqrt(D)
    out, lse = fa._flash_forward(q, k, v, scale, causal, 512, 512,
                                 kv_valid_len)
    want, want_lse = fa.flash_forward_reference(q, k, v, scale, causal, 512,
                                                512, kv_valid_len)
    res = (q, k, v, out, lse)
    grads = fa._flash_backward(scale, causal, 512, 512, kv_valid_len, res, do)
    want_grads = fa.flash_backward_reference(scale, causal, 512, 512,
                                             kv_valid_len, res, do)
    torch.cuda.synchronize()
    max_err(lse, want_lse, 2e-5)
    if dtype == torch.float32:
        fwd_tol, grad_tol = FLASH_F32_TOL
        err, grad_err = max_err(out, want, fwd_tol), max(
            max_err(a, b, grad_tol) for a, b in zip(grads, want_grads))
        margins = ""
    else:
        (err, m_out), *g = [bf16_err(a, b) for a, b in
                            zip((out, *grads), (want, *want_grads))]
        grad_err = max(e for e, _ in g)
        margins = (f"; margins out {m_out:.3g}, dq/dk/dv "
                   + "/".join(f"{m:.3g}" for _, m in g))
    log(f"flash {str(dtype)[6:]} B={B} H={H} Sq={Sq} Sk={Sk} D={D} "
        f"causal={causal} kv_valid_len={kv_valid_len} views={views} "
        f"scale={scale:.4g}: "
        f"out err {err:.3g}, "
        f"grad err {grad_err:.3g}{margins}")
    return (q, k, v, do), res, err, grad_err


def flash_kernel_phase(card: str) -> dict:
    """Checks the flash kernels over the cases, then checks and times
    them at the training shape and at the MoE's; returns their rows for
    the kernels line (the MoE shape's numbers under "moe_shape")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for D in (64, 128):
                for S in (1, 129, 2048):
                    flash_case(dtype, 1, 2, S, S, D, causal)
        flash_case(dtype, 1, 2, 200, 333, 128, True)
        flash_case(dtype, 1, 2, 300, 333, 128, False, kv_valid_len=250)
        flash_case(dtype, 1, 2, 333, 200, 72, True)
    flash_case(torch.bfloat16, 1, 2, 129, 129, 128, True, scale=-0.1)

    B, S = TRAIN_B, TRAIN_S
    flash_case(torch.bfloat16, B, TRAIN_CFG.n_heads, S, S,
               TRAIN_CFG.head_dim, True, views=False)
    timer = Timer()
    rows = flash_shape_rows(card, timer, B, TRAIN_CFG.n_heads, S,
                            TRAIN_CFG.head_dim, views=True)
    # The MoE's shape: 32 query heads after the GQA repeat, whose copy
    # (like RoPE's on q and k) leaves q, k and v contiguous.
    moe_rows = flash_shape_rows(card, timer, B, MIXTRAL_8X7B.n_heads, S,
                                MIXTRAL_8X7B.head_dim, views=False)
    # DiT-XL/2's: non-causal, D 72 (the wgmma kernels pad it to 128), q,
    # k and v the model's views of one qkv projection.
    dit_rows = flash_shape_rows(card, timer, DIT_B, DIT_XL2.n_heads,
                                DIT_XL2.num_patches, DIT_XL2.head_dim,
                                views="qkv", causal=False)
    for name, row in rows.items():
        row["moe_shape"] = {k: moe_rows[name][k] for k in TIMED}
        row["dit_shape"] = {k: dit_rows[name][k] for k in TIMED}
    return rows


def flash_shape_rows(card: str, timer, B, H, S, D, views,
                     causal: bool = True) -> dict:
    """The flash kernels at (B, H, S, D), bf16: checked against their
    plain versions, two backward calls bitwise equal, then timed beside
    their plain versions and SDPA; their kernels-line rows."""
    dtype, scale = torch.bfloat16, 1 / math.sqrt(D)
    (q, k, v, do), res, err, grad_err = flash_case(dtype, B, H, S, S, D,
                                                   causal, views=views)
    first, again = (fa._flash_backward(scale, causal, 512, 512, None, res,
                                       do) for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("two backward calls gave different grads")
    log(f"flash backward H={H}: two calls give bitwise equal dq, dk, dv")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def library_fwd_bwd():
        qg.grad = kg.grad = vg.grad = None
        F.scaled_dot_product_attention(qg, kg, vg,
                                       is_causal=causal).backward(do)

    cases = {
        "flash_attention_forward": (
            err, lambda: fa._flash_forward(q, k, v, scale, causal, 512, 512),
            lambda: fa.flash_forward_reference(q, k, v, scale, causal, 512,
                                               512),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            False),
        "flash_attention_backward": (
            grad_err,
            lambda: fa._flash_backward(scale, causal, 512, 512, None, res,
                                       do),
            lambda: fa.flash_backward_reference(scale, causal, 512, 512, None,
                                                res, do),
            library_fwd_bwd, True),
    }
    rows = {}
    for name, (err, kernel, plain, library, backward) in cases.items():
        bound, by = flash_bound_ms(B, H, S, S, D, causal, dtype, card,
                                   backward)
        rows[name] = {"name": name, "route": "cuda", "source": FLASH_SOURCE,
                      "replaces": FLASH_KERNELS[name], "max_abs_err": err,
                      "bound_ms": bound, "bound_by": by,
                      **timer.row(kernel, plain, library, plain_reps=5)}
        log(f"kernel {name} B={B} H={H} S={S} D={D} "
            f"{'causal' if causal else 'non-causal'} bf16 views={views}: "
            + json.dumps({k: rows[name][k] for k in TIMED}))
    return rows


def llama_loss(model, batch):
    inp, tgt = batch
    return cross_entropy_loss(model(inp), tgt)


def train_batch(cfg, seed: int = 0, device="cuda"):
    """(inputs, targets) from default_rng(seed), as bench.py draws them."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (TRAIN_B, TRAIN_S + 1))).to(device)
    return data[:, :-1], data[:, 1:]


def flash_launches(cfg, n_steps: int) -> dict:
    """The flash kernels' launches in n_steps training steps of cfg: each
    once per layer and step, the forward twice under remat; none for a
    ViT whose sequence is no multiple of 128 (its reference's rule), nor
    for the encoders and the SSM (no kernel, as in the reference)."""
    flash = getattr(cfg, "attention", None) == "flash" and not (
        isinstance(cfg, ViTConfig) and (cfg.num_patches + 1) % 128)
    remat = getattr(cfg, "remat", False)
    return {"flash_attention_forward":
            flash * cfg.n_layers * n_steps * (2 if remat else 1),
            "flash_attention_backward": flash * cfg.n_layers * n_steps}


def parity_trainer(cfg, params, batch, n_steps, loss_fn=None):
    """n_steps AdamW steps of one trainer of cfg (llama_loss unless
    loss_fn is given) from a clone of `params`; checks its flash launch
    counts and returns (losses, first-step grads)."""
    step = make_train_step(loss_fn or llama_loss)
    # Each trainer owns its tensors: from_params takes them over.
    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01),
                             {n: t.clone() for n, t in params.items()})
    fa.reset_launch_counts()
    out = []
    for i in range(n_steps):
        state, metrics = step(state, batch)
        out.append(metrics["loss"])
        if i == 0:
            grads = {n: p.grad.float()
                     for n, p in state.model.named_parameters()}
    counts = dict(fa.launch_counts)
    want = flash_launches(cfg, n_steps)
    if counts != want:
        raise AssertionError(f"{cfg.attention}, remat {cfg.remat}: "
                             f"launches {counts}, expected {want}")
    losses = torch.stack(out).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.attention}: losses {losses}")
    return losses, grads


def train_parity_phase():
    """The flash trainers against the reference trainer: 3 steps in f32
    under each remat setting, then 2 steps in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    batch = train_batch(cfg)
    losses = {}
    for attention, remat, policy in (("reference", False, "dots"),
                                     ("flash", False, "dots"),
                                     ("flash", True, "full"),
                                     ("flash", True, "dots")):
        name = f"{attention}, remat {policy if remat else 'off'}"
        losses[name], _ = parity_trainer(
            dataclasses.replace(cfg, attention=attention, remat=remat,
                                remat_policy=policy), params, batch, 3)
    want = losses["reference, remat off"]
    for name, got in losses.items():
        if any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: losses {got} != reference {want}")
    log("train parity f32: " + json.dumps(losses))

    # bf16: the tensor-core kernels. Both sides run bf16 projections; the
    # kernels round P and dS to bf16 where plain autograd keeps f32, up to
    # 2^-9 of each term. A row of dS sums to 0, so dq = dS.K cancels the
    # keys' common mean while the rounding errors do not: the q and k
    # projections' grads move by a percent or two, hence 2^-5 in relative
    # norm; the losses hold to 2^-8. A fault in one of the 32 q tiles of
    # every (batch, head) moves a grad by about sqrt(1/32), 0.18; the
    # flash phase holds each tile of each tensor.
    bf16_parity("train parity bf16",
                dataclasses.replace(cfg, dtype=torch.bfloat16), batch)


def bf16_parity(what: str, cfg, batch, moe_model: bool = False) -> None:
    """2 bf16 steps of cfg with flash attention against the reference
    attention, from init_params(seed=0): losses within 2^-8, each
    parameter's first-step gradient within 2^-5 of its norm.

    For the MoE model (`moe_model`), bf16 rounding moves the router's
    probabilities, so a token whose top k+1 probabilities are about as
    close may route to another expert. Each token
    routed otherwise at step 1 must be such a near-tie (`rerouted`); where
    none is, the gradients are held as above; where some are, the
    gradients of the MoE blocks (router, experts, the norm before them),
    sums over the tokens each expert received, move with each re-routed
    token and are reported, the others held as above."""
    params = init_params(cfg, seed=0)
    routings = {"reference": [], "flash": []}
    losses, grads = {}, {}
    for attention in routings:
        losses[attention], grads[attention] = parity_trainer(
            dataclasses.replace(cfg, attention=attention), params, batch, 2,
            moe_loss_fn(routings[attention]) if moe_model else None)
    del params
    want, got = losses["reference"], losses["flash"]
    rel = {n: ((grads["flash"][n] - g).norm() / g.norm()).item()
           for n, g in grads["reference"].items()}
    re_routed = rerouted(routings["reference"][0], routings["flash"][0],
                         cfg.experts_per_token) if moe_model else 0
    held = {n: r for n, r in rel.items() if not re_routed
            or (".moe." not in n and "post_attn_norm" not in n)}
    worst = max(held, key=held.get)
    log(f"{what}: " + json.dumps({
        "reference": want, "flash": got,
        "max_loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
        "max_grad_rel": rel[worst], "max_grad_rel_param": worst,
        **({"rerouted_tokens_step_1": re_routed,
            "moe_block_grad_rel": {n: r for n, r in rel.items()
                                   if n not in held}} if moe_model else {})}))
    if any(abs(a - b) > 2 ** -8 * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"bf16 flash losses {got} != reference {want}")
    if rel[worst] > 2 ** -5:
        raise AssertionError(f"bf16 flash grad of {worst} off by "
                             f"{rel[worst]:.3g} of its norm")


def rerouted(want: dict, got: dict, k: int) -> int:
    """The tokens whose top_e differs between two forwards' routings, each
    checked to be a near-tie at the size of its probabilities' change: a
    gap between two of its k+1 largest probabilities in `want` no larger
    than twice the largest change of one of its probabilities (else the
    two orders could not differ). slot and keep must be equal where no
    token differs."""
    count = 0
    for layer, w in want.items():
        g = got[layer]
        differ = (w["top_e"] != g["top_e"]).any(-1)
        if not bool(differ.any()):
            if not (torch.equal(w["slot"], g["slot"])
                    and torch.equal(w["keep"], g["keep"])):
                raise AssertionError(f"{layer}: slot or keep differs")
            continue
        ranked = w["probs"][differ].topk(k + 1, dim=-1).values
        gap = (ranked[:, :-1] - ranked[:, 1:]).min(-1).values
        moved = (w["probs"][differ] - g["probs"][differ]).abs().amax(-1)
        if not bool((gap <= 2 * moved).all()):
            raise AssertionError(f"{layer}: a token re-routed without a "
                                 "near-tie")
        count += int(differ.sum())
    return count


def training_phase(card: str, window=None, steps: int = TRAIN_STEPS,
                   cfg=TRAIN_CFG, loss_fn=None, what: str = "training",
                   flops_per_token=count_flops_per_token) -> dict:
    """Trains cfg (the 1.2B Llama config unless given, llama_loss unless
    loss_fn is given); `window` (a context manager, such as a
    torch.profiler.profile) wraps just the timed steps. Returns the flash
    launch counts of the timed steps."""
    t0 = time.perf_counter()
    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01), seed=0)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"{what}: {n_params / 1e9:.3f}B params, bf16, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(cfg)
    step = make_train_step(loss_fn or llama_loss)
    state, metrics = step(state, batch)     # warm-up
    first = metrics["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        out = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            out.append(metrics["loss"])
        losses = torch.stack(out).tolist()  # the one host read
        dt = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    want = flash_launches(cfg, steps)
    if not all(math.isfinite(x) for x in [first] + losses) \
            or not losses[-1] < first:
        raise AssertionError(f"loss did not fall: {first} then {losses}")
    if counts != want:
        raise AssertionError(f"flash launches {counts}, expected {want} "
                             f"({cfg.n_layers} layers x {steps} steps, "
                             f"remat {cfg.remat})")
    tokens_per_s = TRAIN_B * TRAIN_S * steps / dt
    TRAINED[what] = {"losses": [first] + losses, "tokens_per_s": tokens_per_s,
                     "ms_per_step": dt / steps * 1e3}
    log(f"{what}: " + json.dumps({
        "card": card, "layers": cfg.n_layers, "batch": TRAIN_B,
        "seq": TRAIN_S, "steps": steps, "first_loss": first,
        "losses": losses, "ms_per_step": dt / steps * 1e3,
        "tokens_per_s": tokens_per_s,
        "mfu_6n_no_attention_flops": tokens_per_s * flops_per_token(cfg)
        / peaks(card)[2],
        "peak_gib_timed_steps": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts}))
    return counts


# What each training_phase run saw, by its name: the warm-up's loss and
# the timed steps' losses, tokens/s (phase 16 holds its gang against it).
TRAINED: dict = {}


def timed_steps(step, state, batch, n_steps: int):
    """n_steps steps; returns (state, losses, ms per step of all but the
    first (of the one, for one step), peak memory in GiB). The losses
    are read once, at the end."""
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    return (state, torch.stack(losses).tolist(),
            statistics.mean(times[1:] or times) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def ulps(a, b) -> int:
    """The largest distance between a and b (bf16 or f32) in steps of
    their type (same-sign values: the difference of their bit patterns)."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    ia, ib = (t.view(bits).long() for t in (a, b))
    return (ia - ib).abs().max().item()


def sharded_train_check(card: str, mesh, cfg=TRAIN_CFG,
                        rules=TRANSFORMER_RULES, loss_fn=None,
                        what: str = "sharded training", batch=None,
                        steps: int = SHARDED_STEPS) -> dict:
    """The single-device step and the sharded step on a world of one, in
    turn, from the same params and batch (the training config, its token
    batch, rules and loss unless given; each batch tensor sharded over
    dp and fsdp in its first dim); returns the sharded path's launch
    counts."""
    batch = train_batch(cfg) if batch is None else batch
    step = make_train_step(loss_fn or llama_loss)
    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01), seed=0)
    state, want_losses, plain_ms, plain_gib = timed_steps(
        step, state, batch, steps)
    want = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    state, specs = init_sharded_state(
        mesh, cfg, init_params, rules, adamw(3e-4, weight_decay=0.01), cfg,
        0)
    sharded = shard_train_step(step, mesh, specs, tuple(
        P(("dp", "fsdp"), *[None] * (t.dim() - 1)) for t in batch))
    fa.reset_launch_counts()
    state, losses, ms, gib = timed_steps(sharded, state, batch, steps)
    counts = dict(fa.launch_counts)
    got = {n: p.detach().full_tensor().cpu()
           for n, p in state.model.named_parameters()}
    unequal = {n: ulps(got[n], t) for n, t in want.items()
               if not torch.equal(got[n], t)}
    log(f"{what}: " + json.dumps({
        "card": card, "batch": [list(t.shape) for t in batch],
        "steps": steps, "mesh": str(next(state.model.parameters())
                                    .device_mesh),
        "losses": losses, "single_device_losses": want_losses,
        "ms_per_step": ms, "single_device_ms_per_step": plain_ms,
        "peak_gib": gib, "single_device_peak_gib": plain_gib,
        "unequal_params_ulps": unequal, "launches": counts}))
    if losses != want_losses or unequal:
        raise AssertionError(f"{what}: the sharded step is not bitwise the "
                             "single-device step")
    want_counts = flash_launches(cfg, steps)
    if counts != want_counts:
        raise AssertionError(f"{what}: sharded flash launches {counts}, "
                             f"expected {want_counts}")
    return counts


def size_one_axes_check(mesh) -> None:
    """Ulysses, ring and the pipeline over the mesh's axes of size 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, H, S, D = TRAIN_B, TRAIN_CFG.n_heads, TRAIN_S, TRAIN_CFG.head_dim
    with col.mesh_context(mesh):
        for dtype, fn, want_fn in (
                (torch.bfloat16, "ulysses",
                 lambda *t: fa.flash_attention(*t, causal=True)),
                (torch.float32, "ring",
                 lambda *t: fa.mha_reference(*t, causal=True))):
            q, k, v, do = flash_inputs(dtype, B, H, S, S, D, views=False)
            results = []
            for f in (want_fn, lambda *t: getattr(fa, f"{fn}_attention")(
                    *t, axis="sp", causal=True)):
                qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                fa.reset_launch_counts()
                out = f(*qkv)
                out.backward(do)
                torch.cuda.synchronize()
                results.append(([out.detach()] + [t.grad for t in qkv],
                                dict(fa.launch_counts)))
            (want, _), (got, counts) = results
            if fn == "ulysses":
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("ulysses at sp=1 is not bitwise "
                                         "flash_attention")
                if set(counts.values()) != {1}:
                    raise AssertionError(f"ulysses launched {counts}")
                log(f"ulysses sp=1 bf16 B={B} H={H} S={S} D={D} causal: out "
                    f"and grads bitwise flash_attention, launches {counts}")
            else:
                max_err(got[0], want[0], 2e-5)
                grad_err = max(max_err(a, b, 1e-4)
                               for a, b in zip(got[1:], want[1:]))
                log(f"ring sp=1 f32 B={B} H={H} S={S} D={D} causal: out err "
                    f"{(got[0] - want[0]).abs().max().item():.3g}, grad err "
                    f"{grad_err:.3g}")
        g = torch.Generator(device="cuda").manual_seed(1)
        ws = torch.randn(8, 16, 16, generator=g, device="cuda") * 0.3
        x = torch.randn(8, 4, 16, generator=g, device="cuda")

        def stage_fn(stage_ws, h):
            for w in stage_ws:
                h = torch.tanh(h @ w)
            return h

        got, want = pipeline_apply(stage_fn, ws, x, axis="pp"), \
            stage_fn(ws, x)
        log(f"pipeline pp=1: max abs err {max_err(got, want, 1e-5):.3g}")


@contextlib.contextmanager
def nccl_world_of_one():
    """An NCCL world of one on this card; yields make_mesh(MeshConfig())
    (every axis of size 1)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        os.environ["MASTER_PORT"] = str(s.getsockname()[1])
    os.environ["MASTER_ADDR"] = "localhost"
    initialize_multihost(num_processes=1, process_id=0)
    try:
        yield make_mesh(MeshConfig())
    finally:
        dist.destroy_process_group()


def sharded_training_phase(card: str) -> dict:
    """The sharded step and the size-1 axes checks on a world of one.
    Returns the sharded path's flash launch counts."""
    with nccl_world_of_one() as mesh:
        counts = sharded_train_check(card, mesh)
        size_one_axes_check(mesh)
    return counts


def moe_loss_fn(routings: list | None = None):
    """The MoE model's loss (next-token loss plus the layers' aux losses);
    each forward's routing, by layer, is appended to `routings` if given."""
    def loss_fn(model, batch):
        inp, tgt = batch
        inter = {}
        logits = model(inp, intermediates=inter)
        if routings is not None:
            routings.append({k: v for k, v in inter.items()
                             if k.endswith("/routing")})
        return cross_entropy_loss(logits, tgt) + moe_aux_loss(inter)
    return loss_fn


def moe_parity_phase(card: str) -> dict:
    """MIXTRAL_8X7B's widths at 1 layer, from init_params(seed=0), remat as
    the config sets it: 3 f32 steps with the reference attention and with
    flash (losses within 1e-4, step 1's routing identical but at
    near-ties, see `rerouted`), 2 bf16 steps as the Llama's train parity
    (see bf16_parity), then the bf16 sharded step by MOE_RULES
    on a world of one against the single-device step, bitwise. Returns the
    sharded path's flash launch counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=1, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    batch = train_batch(cfg)
    losses, routings = {}, {}
    for attention in ("reference", "flash"):
        routings[attention] = []
        losses[attention], _ = parity_trainer(
            dataclasses.replace(cfg, attention=attention), params, batch, 3,
            moe_loss_fn(routings[attention]))
    del params
    want, got = losses["reference"], losses["flash"]
    if any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"moe flash losses {got} != reference {want}")
    re_routed = rerouted(routings["reference"][0], routings["flash"][0],
                         cfg.experts_per_token)
    kept = [float(r["keep"].mean()) for r in routings["flash"][0].values()]
    log("moe parity f32: " + json.dumps({
        "losses": losses, "rerouted_tokens_step_1": re_routed,
        "kept_share_step_1": kept}))
    del routings
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="flash")
    bf16_parity("moe parity bf16", cfg, batch, moe_model=True)
    with nccl_world_of_one() as mesh:
        return sharded_train_check(card, mesh, cfg, MOE_RULES, moe_loss_fn(),
                                   "moe sharded training")


# ---------------------------------------------------------------------------
# Phase 11: the other model families
# ---------------------------------------------------------------------------


def perturbed(params: dict, seed: int, scale: float = 0.02) -> dict:
    """params plus scale x a unit normal each, in their dtypes: adaLN-Zero
    starts DiT at an exact 0 prediction, where no gradient reaches its
    attention; these weights give every path signal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {n: (t.float() + scale * torch.randn(
        t.shape, generator=g, device="cuda")).to(t.dtype)
        for n, t in params.items()}


def dit_batch(cfg, B: int, seed: int):
    """(images, labels, t, noise, drop): the images and the draws of
    ddpm_loss, from torch.Generator(seed) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, cfg.image_size, cfg.image_size, cfg.channels)
    return (torch.randn(shape, generator=g, device="cuda"),
            torch.randint(0, cfg.num_classes, (B,), generator=g,
                          device="cuda"),
            torch.randint(0, cfg.timesteps, (B,), generator=g, device="cuda"),
            torch.randn(shape, generator=g, device="cuda"),
            torch.rand(B, generator=g, device="cuda") < 0.1)


def dit_loss(model, batch):
    """ddpm_loss at fixed draws: the same objective every step."""
    return dit._ddpm_loss(model, *batch)


def dit_parity(cfg, params, batch) -> dict:
    """DiT with flash attention against the reference attention, on the
    same weights and draws: (outputs, losses, grads) of each, and the
    flash kernels' launches in the flash model's forward and backward."""
    out = {}
    for attention in ("reference", "flash"):
        model = DiT.from_params(dataclasses.replace(cfg, attention=attention),
                                {n: t.clone() for n, t in params.items()},
                                torch.device("cuda"), trainable=True)
        images, labels, t = batch[:3]
        fa.reset_launch_counts()
        with torch.no_grad():
            pred = model(images, t.float(), labels)
        loss = dit_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        out[attention] = (pred, loss.detach(), {
            n: p.grad.float() for n, p in model.named_parameters()},
            dict(fa.launch_counts))
    return out


def dit_parity_phase() -> None:
    """The repo's DiTConfig(), B 8, from perturbed init_params(seed=0): the
    flash model against the reference attention's, forward and the grads
    of ddpm_loss at fixed draws; f32 at 2e-5 (outputs) and 1e-4 (grads),
    then bf16: outputs by bf16_err, the loss within 2^-8 and each grad
    within 2^-5 of its norm, as bf16_parity holds the Llama. Each flash
    kernel launches n_layers times a forward and a backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        cfg = DiTConfig(dtype=dtype)
        params = perturbed(init_params(cfg, seed=0), seed=1)
        res = dit_parity(cfg, params, dit_batch(cfg, 8, seed=2))
        (want, want_loss, want_g, _), (got, loss, grads, counts) = \
            res["reference"], res["flash"]
        n = cfg.n_layers
        if counts != {"flash_attention_forward": 2 * n,
                      "flash_attention_backward": n}:
            raise AssertionError(f"DiT flash launches {counts}: expected "
                                 f"{n} a forward (two forwards) and {n} a "
                                 "backward")
        rel = {p: ((g - want_g[p]).norm() / want_g[p].norm().clamp(
            min=1e-30)).item() for p, g in grads.items()}
        worst = max(rel, key=rel.get)
        if dtype == torch.float32:
            out_err = max_err(got, want, FLASH_F32_TOL[0])
            grad_err = max(max_err(g, want_g[p], FLASH_F32_TOL[1])
                           for p, g in grads.items())
            margin = None
        else:
            out_err, margin = bf16_err(got, want)
            grad_err = max((g - want_g[p]).abs().max().item()
                           for p, g in grads.items())
            if abs(loss - want_loss) > 2 ** -8 * abs(want_loss) \
                    or rel[worst] > 2 ** -5:
                raise AssertionError(f"bf16 DiT: loss {loss.item()} against "
                                     f"{want_loss.item()}, grad of {worst} "
                                     f"off by {rel[worst]:.3g} of its norm")
        log(f"dit parity {str(dtype)[6:]}: " + json.dumps({
            "loss": loss.item(), "reference_loss": want_loss.item(),
            "out_max_abs_err": out_err, "out_margin": margin,
            "grad_max_abs_err": grad_err, "max_grad_rel": rel[worst],
            "max_grad_rel_param": worst, "launches": counts}))


def dit_training(card: str, window=None, steps: int = DIT_STEPS) -> dict:
    """DiT-XL/2 in bf16 with flash attention, B 32, AdamW(1e-4, no weight
    decay, as the DiT paper trains): one warm-up step, then `steps` timed
    steps of ddpm_loss at fixed draws (so the loss must fall), read back
    once; `window` (such as a torch.profiler.profile) wraps the timed
    steps. Returns the flash launch counts of the timed steps: each
    kernel n_layers times a step."""
    cfg = DIT_XL2
    state = init_train_state(cfg, adamw(1e-4, weight_decay=0.0), seed=0)
    n_params = sum(p.numel() for p in state.model.parameters())
    if n_params != count_dit_params(cfg):
        raise AssertionError(f"{n_params} parameters, count_dit_params "
                             f"says {count_dit_params(cfg)}")
    batch = dit_batch(cfg, DIT_B, seed=0)
    step = make_train_step(dit_loss)
    state, metrics = step(state, batch)     # warm-up
    first = metrics["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        out = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            out.append(metrics["loss"])
        losses = torch.stack(out).tolist()  # the one host read
        dt = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    if not all(math.isfinite(x) for x in [first] + losses) \
            or not losses[-1] < first:
        raise AssertionError(f"DiT loss did not fall: {first} then {losses}")
    if counts != flash_launches(cfg, steps):
        raise AssertionError(f"DiT flash launches {counts}, expected "
                             f"{flash_launches(cfg, steps)}")
    tokens = DIT_B * cfg.num_patches
    log("dit training: " + json.dumps({
        "card": card, "params": n_params, "batch": DIT_B,
        "tokens_per_image": cfg.num_patches, "steps": steps,
        "first_loss": first, "losses": losses,
        "ms_per_step": dt / steps * 1e3, "images_per_s": DIT_B * steps / dt,
        "tflops_per_s_6n": 6 * n_params * tokens * steps / dt / 1e12,
        "peak_gib_timed_steps": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts}))
    return counts


def dit_sampling(card: str) -> dict:
    """ddim_sample on the repo's DiTConfig() in bf16, flash attention, from
    perturbed init_params(seed=0): 16 images, 50 steps, guidance 4.0 (two
    forwards a step). Twice from one seed, bitwise equal, finite, of the
    image shape; K1 launches 2 x n_layers x steps in the timed run.
    Returns its flash launch counts."""
    cfg = DiTConfig()
    model = DiT.from_params(cfg, perturbed(init_params(cfg, seed=0), seed=1),
                            torch.device("cuda"))
    labels = torch.arange(SAMPLE_NUM, device="cuda") % cfg.num_classes

    def sample():
        return dit.ddim_sample(
            model, torch.Generator(device="cuda").manual_seed(3),
            num=SAMPLE_NUM, steps=SAMPLE_STEPS, labels=labels,
            guidance=GUIDANCE)

    first = sample()                                  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    x = sample()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    want = {"flash_attention_forward": 2 * cfg.n_layers * SAMPLE_STEPS,
            "flash_attention_backward": 0}
    shape = (SAMPLE_NUM, cfg.image_size, cfg.image_size, cfg.channels)
    if tuple(x.shape) != shape or not torch.isfinite(x).all() \
            or not torch.equal(x, first):
        raise AssertionError(f"samples {tuple(x.shape)}, finite "
                             f"{bool(torch.isfinite(x).all())}, equal to a "
                             f"second run {torch.equal(x, first)}")
    if counts != want:
        raise AssertionError(f"sampling launches {counts}, expected {want}")
    log("dit sampling: " + json.dumps({
        "card": card, "images": SAMPLE_NUM, "steps": SAMPLE_STEPS,
        "guidance": GUIDANCE, "seconds": dt, "images_per_s": SAMPLE_NUM / dt,
        "launches": counts}))
    return counts


def family_steps(card: str, what: str, cfg, loss_fn, batch, tokens: int,
                 steps: int = FAMILY_STEPS, lr: float = 1e-4) -> dict:
    """steps AdamW steps of cfg from init_params(seed=0) on one batch (the
    first is the warm-up): the losses finite and falling, the flash
    launches as cfg implies; logs ms a step over the others, tokens (or
    images) a second and peak memory."""
    state = init_train_state(cfg, adamw(lr, weight_decay=0.01), seed=0)
    step = make_train_step(loss_fn)
    fa.reset_launch_counts()
    state, losses, ms, gib = timed_steps(step, state, batch, steps)
    counts = dict(fa.launch_counts)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    if counts != flash_launches(cfg, steps):
        raise AssertionError(f"{what}: flash launches {counts}, expected "
                             f"{flash_launches(cfg, steps)}")
    row = {"card": card, "params": sum(p.numel() for p in
                                       state.model.parameters()),
           "batch": [list(t.shape) for t in batch], "losses": losses,
           "ms_per_step": ms, "per_s": tokens / ms * 1e3,
           "peak_gib": gib, "launches": counts}
    log(f"{what}: " + json.dumps(row))
    return row


def vit_batch(B: int | None = None):
    """(images, labels) at ViT-B/16's 224 x 224, VIT_B of them unless
    given, from torch.Generator(0) on the card."""
    B = VIT_B if B is None else B
    g = torch.Generator(device="cuda").manual_seed(0)
    return (torch.randn(B, VIT_B16.image_size, VIT_B16.image_size, 3,
                        generator=g, device="cuda"),
            torch.randint(0, VIT_B16.num_classes, (B,), generator=g,
                          device="cuda"))


def vit_loss_fn(model, batch):
    return vit_loss(model(batch[0]), batch[1])


def token_batch(vocab: int, *shape, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=g, device="cuda")


def mamba_decode_check(card: str) -> None:
    """Mamba-130M's widths at 2 layers in f32: ssm_prefill of S 2048, then
    64 ssm_decode_step steps, each step's logits within 2e-5 of the
    parallel forward's over the whole sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(MAMBA_130M, n_layers=2, dtype=torch.float32)
    model = model_class(cfg).from_params(cfg, init_params(cfg, seed=0),
                                         torch.device("cuda"))
    tokens = token_batch(cfg.vocab_size, 2, MAMBA_S + 64)
    with torch.no_grad():
        full = model(tokens)
        last, states = ssm_prefill(model, tokens[:, :MAMBA_S])
        err = max_err(last, full[:, MAMBA_S - 1], 2e-5)
        for i in range(MAMBA_S, MAMBA_S + 64):
            logits, states = ssm_decode_step(model, tokens[:, i], states)
            err = max(err, max_err(logits, full[:, i], 2e-5))
    log(f"mamba decode f32 (2 layers, prefill {MAMBA_S}, 64 steps): logits "
        f"within {err:.3g} of the parallel forward's ({card})")


def families_phase(card: str) -> dict:
    """Phase 11. Returns the DiT path's flash launch counts: training's
    timed steps and sampling."""
    dit_parity_phase()
    launches = {"dit": dit_training(card), "dit_sample": dit_sampling(card)}
    gc.collect()
    torch.cuda.empty_cache()
    images = vit_batch()
    with torch.no_grad():
        model = model_class(VIT_B16).from_params(
            VIT_B16, init_params(VIT_B16, seed=0), torch.device("cuda"))
        model(images[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(images[0])
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        if logits.shape != (VIT_B, VIT_B16.num_classes) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"ViT logits {tuple(logits.shape)}")
    del model
    log(f"vit-b/16 forward: {fwd_ms:.2f} ms for {VIT_B} images, "
        f"{VIT_B / fwd_ms * 1e3:.1f} images/s ({card})")
    family_steps(card, "vit-b/16 training (images/s)", VIT_B16, vit_loss_fn,
                 images, VIT_B)
    tgt = token_batch(BERT_BASE.vocab_size, ENC_B, BERT_S)
    masked = torch.rand(ENC_B, BERT_S, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1)) < 0.15
    family_steps(card, "bert-base mlm training (tokens/s)", BERT_BASE,
                 lambda m, b: mlm_loss(m(b[0])[1], b[1], b[2]),
                 (torch.where(masked, 103, tgt), tgt, masked),
                 ENC_B * BERT_S)
    src = token_batch(T5_BASE.vocab_size, ENC_B, T5_SRC, seed=2)
    tgt = token_batch(T5_BASE.vocab_size, ENC_B, T5_TGT + 1, seed=3)
    family_steps(card, "t5-base seq2seq training (tokens/s)", T5_BASE,
                 lambda m, b: seq2seq_loss(m(b[0], b[1][:, :-1]),
                                           b[1][:, 1:]),
                 (src, tgt), ENC_B * (T5_SRC + T5_TGT))
    mamba_decode_check(card)
    data = token_batch(MAMBA_130M.vocab_size, MAMBA_B, MAMBA_S + 1, seed=4)
    row = family_steps(card, "mamba-130m training (tokens/s)", MAMBA_130M,
                       llama_loss, (data[:, :-1], data[:, 1:]),
                       MAMBA_B * MAMBA_S, lr=1e-3)
    if row["peak_gib"] > 60:
        raise AssertionError(f"mamba training peaked at {row['peak_gib']} "
                             "GiB, over 60")
    with nccl_world_of_one() as mesh:
        sharded_train_check(card, mesh, VIT_B16, TRANSFORMER_RULES,
                            vit_loss_fn, "vit-b/16 sharded training",
                            vit_batch(8), steps=1)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: disaggregated prefill (PrefillEngine, PrefixCache)
# ---------------------------------------------------------------------------


def counted_prefills(pe) -> dict:
    """Counts the calls of a PrefillEngine's two prefill programs."""
    calls = {"one": 0, "suffix": 0}
    for key, attr in (("one", "_prefill_one"), ("suffix", "_prefill_suffix")):
        real = getattr(pe, attr)

        def counted(*args, _real=real, _key=key):
            calls[_key] += 1
            return _real(*args)

        setattr(pe, attr, counted)
    return calls


def timed_prefill(pe, prompt, sp, cache, hit: str) -> tuple[dict, float]:
    """One PrefillEngine.prefill, which must be a `hit`; its ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pe.prefill(np.asarray(prompt), sp, cache)
    torch.cuda.synchronize()
    if out["prefix_hit"] != hit:
        raise AssertionError(f"disagg: a {out['prefix_hit']} where a {hit} "
                             "was due")
    return out, (time.perf_counter() - t0) * 1e3


def disagg_phase(card: str, params) -> dict:
    """LLAMA3_8B bf16 on the serving weights: a PrefillEngine(max_len=512)
    with a PrefixCache(16) beside the paged engine, all on one weights
    dict (16 entries: the 8 prompts and their 8 extensions; with 8, each
    extension's insert would evict, as least recently used, the prompt
    the next extension extends).
    The 8 greedy prompts of the serving phase are prefilled (misses) and
    handed over through submit_prefilled, then again (full hits: no
    prefill program runs), then each extended by 16 tokens (partial hits:
    only the suffix program runs); every stream must be the engine's own
    submit of the same prompt, but at a near-tie. Returns the kernels'
    launches on the hand-off path (counts set to 0 after the engine's own
    streams)."""
    cfg = LLAMA3_8B
    payloads, _warm = serving_payloads(cfg)
    prompts = [p["prompt_tokens"] for p in payloads if "temperature" not in p]
    rng = np.random.default_rng(5)
    extended = [p + [int(x) for x in rng.integers(1, cfg.vocab_size, 16)]
                for p in prompts]
    sp = SamplingParams(max_new_tokens=32)
    pe = PrefillEngine(cfg, params, max_len=MAX_LEN)
    cache = PrefixCache(16)
    calls = counted_prefills(pe)
    eng = LLMEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                    page_size=PAGE, decode_chunk=CHUNK)
    if pe.model.embed.weight.data_ptr() != eng.model.embed.weight.data_ptr():
        raise AssertionError("disagg: the prefill engine copied the weights")
    try:
        # The engine's own streams (they also capture its decode graph).
        wants = [h.tokens() for h in [eng.submit(p, sp)
                                      for p in prompts + extended]]
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        replays0, steps0 = eng.graph_replays, eng.decode_steps
        runs = {}
        for run, hit, batch, want_calls in (
                ("miss", "miss", prompts, {"one": 8, "suffix": 0}),
                ("full", "full", prompts, {"one": 8, "suffix": 0}),
                ("partial", "partial", extended, {"one": 8, "suffix": 8})):
            outs, ms = zip(*(timed_prefill(pe, p, sp, cache, hit)
                             for p in batch))
            if calls != want_calls:
                raise AssertionError(f"disagg {run}: prefill calls {calls}, "
                                     f"expected {want_calls}")
            handles = [eng.submit_prefilled(_Prefilled(
                o["kv"], o["first_token"], o["prompt_len"], o["kv_len"], 0,
                [], emit_first=True), sp) for o in outs]
            got = [h.tokens() for h in handles]
            want = wants[:8] if batch is prompts else wants[8:]
            for p, toks, w in zip(batch, got, want):
                hold_greedy(f"disagg {run}", eng.model, cfg, p, toks, w,
                            BF16_TIE)
            runs[run] = {"ms_per_prompt": statistics.mean(ms),
                         "ms": list(ms),
                         "equal_to_submit": sum(t == w for t, w in
                                                zip(got, want))}
        torch.cuda.synchronize()
        counts = dict(pa.launch_counts)
        replays = eng.graph_replays - replays0
        steps = eng.decode_steps - steps0
    finally:
        eng.shutdown()
    if not pages_returned(eng):
        raise AssertionError("disagg: KV pages not returned")
    launches = {k: counts[k] + eng.graph_launches.get(k, 0) * replays
                for k in counts}
    if launches[ON_PATH] < cfg.n_layers * steps:
        raise AssertionError(f"disagg: {ON_PATH} launched {launches[ON_PATH]}"
                             f" times for {steps} decode steps")
    log("disaggregated prefill: " + json.dumps({
        "card": card, "streams": 3 * len(prompts), "runs": runs,
        "cache": cache.stats(), "prefill_calls": calls,
        "events": dict(disagg_counts), "decode_steps": steps,
        "graph_replays": replays, "launches": launches}))
    return launches


# ---------------------------------------------------------------------------
# Phase 13: checkpoints on torch.distributed.checkpoint
# ---------------------------------------------------------------------------


def state_tensors(state) -> dict:
    """Each parameter and each of its optimizer's state tensors by name,
    whole (a DTensor's full tensor), as copies."""
    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).clone()

    out = {}
    for name, p in state.model.named_parameters():
        out[name] = whole(p.detach())
        for k, v in state.optimizer.state[p].items():
            out[f"{name}/{k}"] = whole(v)
    return out


def unequal(got: dict, want: dict) -> list:
    return sorted(n for n in want if not torch.equal(got[n].cpu(),
                                                     want[n].cpu()))


def checkpoint_phase(card: str) -> dict:
    """TRAIN_CFG's widths at 4 layers (0.40B parameters), bf16, flash, B 2,
    S 2048, AdamW(3e-4, 0.01). Run A: 4 steps, saved through
    CheckpointManager(num_to_keep=2) after steps 1-3. Run B: step 2's
    checkpoint restored into a state drawn from seed 1, then steps 3 and
    4, bitwise run A. Then on an NCCL world of one the same checkpoint
    restored onto init_sharded_state's layout by TRANSFORMER_RULES and
    one sharded step, bitwise run A's step 3. Returns run A's flash
    launches."""
    cfg = CKPT_CFG
    batch = train_batch(cfg)
    step = make_train_step(llama_loss)
    opt = adamw(3e-4, weight_decay=0.01)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(root, num_to_keep=2)
        a = init_train_state(cfg, opt, seed=0)
        fa.reset_launch_counts()
        losses_a, save_s = [], []
        for i in range(4):
            a, m = step(a, batch)
            losses_a.append(m["loss"])
            if i == 2:
                after3 = state_tensors(a)
            if i < 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(a, metrics={"step": a.step})
                save_s.append(time.perf_counter() - t0)
        counts = dict(fa.launch_counts)
        losses_a = torch.stack(losses_a).tolist()
        want = state_tensors(a)
        n_params = sum(p.numel() for p in a.model.parameters())
        del a
        kept = [os.path.basename(c.path) for c in mgr.list()]
        if kept != ["checkpoint_000002", "checkpoint_000003"]:
            raise AssertionError(f"checkpoint: kept {kept}")
        if counts != flash_launches(cfg, 4):
            raise AssertionError(f"checkpoint: flash launches {counts}")
        path = mgr.list()[0].path
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(path) for f in fs)

        b = init_train_state(cfg, opt, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Checkpoint(path).to_pytree(b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if b.step != 2:
            raise AssertionError(f"checkpoint: restored step {b.step}")
        losses_b = []
        for _ in range(2):
            b, m = step(b, batch)
            losses_b.append(m["loss"])
        losses_b = torch.stack(losses_b).tolist()
        run_b = unequal(state_tensors(b), want)
        del b
        gc.collect()
        torch.cuda.empty_cache()

        with nccl_world_of_one() as mesh:
            s, specs = init_sharded_state(mesh, cfg, init_params,
                                          TRANSFORMER_RULES, opt, cfg, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_pytree(os.path.join(path, "state"), s)
            torch.cuda.synchronize()
            sharded_restore_s = time.perf_counter() - t0
            sharded = shard_train_step(step, mesh, specs, tuple(
                P(("dp", "fsdp"), None) for _ in batch))
            s, m = sharded(s, batch)
            sharded_loss = m["loss"].item()
            sharded_unequal = unequal(state_tensors(s), after3)
            del s
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("checkpoint: " + json.dumps({
        "card": card, "params": n_params, "layers": cfg.n_layers,
        "kept": kept, "losses_a": losses_a, "losses_b": losses_b,
        "sharded_step_3_loss": sharded_loss, "gb_written": written / 1e9,
        "save_s": save_s, "restore_s": restore_s,
        "sharded_restore_s": sharded_restore_s, "run_b_unequal": run_b,
        "sharded_unequal": sharded_unequal, "launches": counts}))
    if losses_b != losses_a[2:] or run_b:
        raise AssertionError("checkpoint: run B is not bitwise run A")
    if sharded_loss != losses_a[2] or sharded_unequal:
        raise AssertionError("checkpoint: the sharded restore's step is not "
                             "bitwise run A's step 3")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the RL learners (PPO, BC, MARWIL)
# ---------------------------------------------------------------------------


def ppo_batch(obs_shape, n_act: int, n: int, seed: int = 0) -> dict:
    """A sampled batch's fields from default_rng(seed): uint8 frames (or
    float observations), actions, their log-probabilities, advantages and
    returns."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (n, *obs_shape), dtype=np.uint8) \
        if len(obs_shape) == 3 else \
        rng.standard_normal((n, *obs_shape)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, n_act, n).astype(np.int32),
            "logp": (np.log(1.0 / n_act)
                     + 0.3 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def record_updates(learner) -> dict:
    """Keeps every update's loss (as device tensors) and the first
    update's grads."""
    rec = {"losses": []}
    real = learner.update

    def update(minibatch):
        loss, aux = real(minibatch)
        rec["losses"].append(loss)
        if "grads" not in rec:
            rec["grads"] = {f"{k}/{kk}": t.grad.detach().cpu().clone()
                            for k, sub in learner.params.items()
                            for kk, t in sub.items()}
        return loss, aux

    learner.update = update
    return rec


def hold_ppo_updates(card: str, model: str, obs_shape, cfg, got, rec_gpu,
                     want, rec_cpu) -> dict:
    """A card learner's updates against a CPU learner's from the same
    params and batch (each recorded by record_updates; got and want the
    params after them, numpy): the first
    update's loss within 2e-5 and grads within 1e-4, every update's loss
    within 2e-5, and every parameter within 1e-4 but at ties, which are
    counted and held to 2 lr an update (the most Adam moves an element):
    first-step ties (a first gradient that differs and is under Adam's
    eps on either side), and later ties, at most 1% of a parameter's
    elements (a ReLU input at 0 within rounding at some update, which
    moves that update's gradient on one side only). Returns the row;
    raises on a fault."""
    rec_gpu = {"losses": torch.stack(rec_gpu["losses"]).cpu(),
               "grads": rec_gpu["grads"]}
    rec_cpu = {"losses": torch.stack(rec_cpu["losses"]).cpu(),
               "grads": rec_cpu["grads"]}
    updates = len(rec_cpu["losses"])
    if len(rec_gpu["losses"]) != updates or updates != 24:
        raise AssertionError(f"ppo {model}: {len(rec_gpu['losses'])} and "
                             f"{updates} updates, not PPOConfig's 24")
    first_loss_err = max_err(rec_gpu["losses"][0], rec_cpu["losses"][0],
                             2e-5)
    loss_err = max_err(rec_gpu["losses"], rec_cpu["losses"], 2e-5)
    grad_err = max(max_err(rec_gpu["grads"][k], g, 1e-4)
                   for k, g in rec_cpu["grads"].items())
    ties, later, param_err, tie_err, faults = 0, {}, 0.0, 0.0, []
    for k, sub in want.items():
        for kk, w in sub.items():
            name, g = f"{k}/{kk}", got[k][kk]
            a, b = rec_gpu["grads"][name].numpy(), rec_cpu["grads"][name].numpy()
            tie = (a != b) & ((np.abs(a) < 1e-8) | (np.abs(b) < 1e-8))
            off = ~tie & (np.abs(g - w) > 1e-4 * (1 + np.abs(w)))
            ties += int(tie.sum())
            if off.any():
                later[name] = int(off.sum())
            if tie.sum() > max(1, tie.size // 100) or \
                    off.sum() > max(1, off.size // 100):
                faults.append(f"{int(tie.sum())} first-step and "
                              f"{int(off.sum())} later ties in {name}")
            held = ~(tie | off)
            param_err = max(param_err,
                            float(np.abs(g - w)[held].max(initial=0.0)))
            if (tie | off).any():
                tie_err = max(tie_err, float(np.abs(g - w)[tie | off].max()))
    row = {"card": card, "model": model, "obs": list(obs_shape),
           "updates": updates, "first_loss_err": first_loss_err,
           "loss_err_24_updates": loss_err, "first_grad_err": grad_err,
           "param_err_24_updates": param_err, "first_step_ties": ties,
           "later_ties": later, "tie_err": tie_err}
    if faults or tie_err > 2 * cfg.lr * updates + 1e-4:
        log(f"ppo {model}: " + json.dumps(row))
        raise AssertionError(f"ppo {model}: {faults}, ties moved up to "
                             f"{tie_err} ({updates} updates at lr {cfg.lr})")
    return row


def ppo_parity(card: str, model: str, obs_shape, n_act: int) -> dict:
    """PPOConfig's defaults (batch 1024, minibatch 256, 6 epochs: 24
    updates) on the card and on the CPU from the same numpy params, held
    by hold_ppo_updates. Then a second learn() on the card, timed."""
    cfg = PPOConfig(model=model)
    spec = get_model(model)
    obs_in = obs_shape if model == "atari_cnn" else obs_shape[0]
    params = spec.init_params(obs_in, n_act, spec.default_hidden, cfg.seed)
    batch = ppo_batch(obs_shape, n_act, cfg.train_batch_size)
    sides = {}
    for device in ("cuda", "cpu"):
        learner = PPOLearner(cfg, obs_in, n_act, params=params, device=device)
        rec = record_updates(learner)
        learner.learn(batch, iteration=0)
        sides[device] = (learner, rec)
    (gpu, rec_gpu), (cpu, rec_cpu) = sides["cuda"], sides["cpu"]
    row = hold_ppo_updates(card, model, obs_shape, cfg, gpu.get_params(),
                           rec_gpu, cpu.get_params(), rec_cpu)
    updates = cpu.updates
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu.learn(batch, iteration=1)   # ends in a host read
    dt = time.perf_counter() - t0
    row.update(learn_s=dt, updates_per_s=updates / dt,
               samples_per_s=updates * cfg.sgd_minibatch_size / dt)
    log(f"ppo {model}: " + json.dumps(row))
    return row


def expert_data(path: str, episodes: int = 30) -> None:
    """CartPole expert data from the 'lean-toward-the-pole' heuristic
    (tests/test_rllib_algorithms.py's fixture), written as JSONL."""
    env = CartPole()
    batches = []
    for ep in range(episodes):
        obs = env.reset(seed=ep)
        rows = {"obs": [], "actions": [], "rewards": [], "dones": []}
        done = False
        while not done:
            action = 1 if obs[2] + 0.5 * obs[3] > 0 else 0
            nxt, r, done, _ = env.step(action)
            for k, v in zip(rows, (obs.tolist(), action, r, float(done))):
                rows[k].append(v)
            obs = nxt
        batches.append(rows)
    write_offline_json(path, batches)


def rl_phase(card: str) -> None:
    """PPO's learner at RLlib's Atari config (atari_cnn on 84x84x4 uint8
    frames, 6 actions) and on CartPole (mlp), card against CPU; BC (5
    iterations of 40 steps, lr 3e-3) trained on the card from 30 expert
    episodes must balance the pole (evaluate(3) above 100); MARWIL (beta
    1), one iteration, a finite loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ppo_parity(card, "atari_cnn", (84, 84, 4), 6)
    ppo_parity(card, "mlp", (4,), 2)
    root = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        path = os.path.join(root, "expert.jsonl")
        expert_data(path)
        bc = BCConfig().offline_data(input_path=path).training(
            num_sgd_iter_per_train=40, lr=3e-3).build()
        t0 = time.perf_counter()
        results = [bc.train() for _ in range(5)]
        train_s = time.perf_counter() - t0
        ev = bc.evaluate(num_episodes=3)
        marwil = MARWILConfig(beta=1.0).offline_data(input_path=path) \
            .training(num_sgd_iter_per_train=10).build()
        mw = marwil.train()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("bc: " + json.dumps({
        "card": card, "samples": results[-1]["num_samples"],
        "losses": [r["loss"] for r in results], "train_s": train_s,
        "steps_per_s": 200 / train_s, **ev}))
    log("marwil: " + json.dumps({"card": card, **mw}))
    if not ev["episode_reward_mean"] > 100:
        raise AssertionError(f"bc: evaluate(3) gave {ev}")
    if not (math.isfinite(mw["loss"]) and math.isfinite(mw["mean_weight"])):
        raise AssertionError(f"marwil: {mw}")


# ---------------------------------------------------------------------------
# Phase 15: runtime serving (the port's own runtime, Serve and its proxy)

# Phase 15's Generator tokens for phase 4's greedy payloads and the
# serving figures of phases 4 and 15, kept for phase 17.
SERVED: dict = {}
RUNTIME_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu",
                  "msgpack", "cloudpickle")
RUNTIME_TENSOR_MIB = 64
HTTP_STREAMS = 5          # of the 9 payloads; the other 4 through a handle


def banned_loaded() -> list:
    """The packages of RUNTIME_BANNED this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(RUNTIME_BANNED))


def runtime_tensor(device) -> torch.Tensor:
    """RUNTIME_TENSOR_MIB of bf16 drawn from seed 7 on `device`."""
    gen = torch.Generator(device=device).manual_seed(7)
    return torch.randn(RUNTIME_TENSOR_MIB << 19, generator=gen,
                       device=device).to(torch.bfloat16)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.view(torch.int16).cpu(), b.view(torch.int16).cpu()))


class LlamaReplica(LLMServer):
    """Phase 4's LLMServer as a Serve deployment: the replica builds
    LLAMA3_8B's weights from seed 0 on its own card (as serving_weights()
    does) and reports the engine's counters and the kernels' launches."""

    def __init__(self):
        t0 = time.perf_counter()
        params = init_params(LLAMA3_8B, seed=0)
        super().__init__(LLAMA3_8B, params, max_batch=MAX_BATCH,
                         max_len=MAX_LEN, page_size=PAGE, decode_chunk=CHUNK)
        torch.cuda.synchronize()
        self.bringup_s = time.perf_counter() - t0

    def counters(self, reset: bool = False) -> dict:
        eng = self.engine
        torch.cuda.synchronize()
        out = {"decode_steps": eng.decode_steps,
               "graph_replays": eng.graph_replays,
               "graph_launches": dict(eng.graph_launches),
               "eager_launches": dict(pa.launch_counts),
               "pages_returned": pages_returned(eng),
               "bringup_s": self.bringup_s,
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "device": str(eng.model.embed.weight.device),
               "card": torch.cuda.get_device_name(0),
               "banned": banned_loaded()}
        if reset:
            pa.reset_launch_counts()
        return out


def http_stream(port: int, name: str, payload: dict, rec: dict) -> None:
    """POST /<name>?stream=1 and read the chunked JSON lines as they come."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    toks = []
    try:
        conn.request("POST", f"/{name}?stream=1", body=json.dumps(payload))
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()[:200]}")
        for line in resp:
            if line.strip():
                if not toks:
                    rec["first"] = time.perf_counter()
                toks.append(json.loads(line)["chunk"])
    except Exception as e:  # recorded; the phase fails below
        rec["error"] = e
    finally:
        conn.close()
    rec["tokens"], rec["end"] = toks, time.perf_counter()


def handle_stream(handle, payload: dict, rec: dict) -> None:
    toks = []
    try:
        for tok in handle.options(stream=True).remote(payload):
            if not toks:
                rec["first"] = time.perf_counter()
            toks.append(tok)
    except Exception as e:  # recorded; the phase fails below
        rec["error"] = e
    rec["tokens"], rec["end"] = toks, time.perf_counter()


def _proc_start(pid: int):
    """The start time of a live process (field 22 of /proc/<pid>/stat),
    None once it is gone or a zombie: with the pid it names one process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return None if fields[0] == "Z" else int(fields[19])


def cluster_processes(node) -> dict:
    """{pid: start time} of a cluster's processes (`node`: the
    RuntimeNode that started it): its GCS, its raylets and every process
    under them (zygotes, workers, replicas and proxies)."""
    roots = [node.gcs_proc.pid, *(n.proc.pid for n in node.nodes)]
    children: dict = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(pid))
    found, todo = set(), roots
    while todo:
        pid = todo.pop()
        if pid not in found:
            found.add(pid)
            todo.extend(children.get(pid, ()))
    return {pid: t for pid in found if (t := _proc_start(pid)) is not None}


def still_running(procs: dict) -> list:
    """The pids of `procs` ({pid: start time}) that still run."""
    return sorted(pid for pid, t in procs.items() if _proc_start(pid) == t)


def runtime_start_checks(rt, n_cards: int, card_name: str) -> dict:
    """Step 1: GPU resources, the pinning of a CPU and a GPU task, and
    the packages every process of the cluster has loaded."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    res = rt.cluster_resources()
    if res.get("GPU") != n_cards:
        raise AssertionError(f"runtime: GPU resource {res} for {n_cards} "
                             "cards")

    @rt.remote
    def cpu_task():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), banned_loaded())

    @rt.remote(num_gpus=1)
    def gpu_task():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), torch.cuda.get_device_name(0),
                banned_loaded())

    cpu, gpu = rt.get([cpu_task.remote(), gpu_task.remote()], timeout=300)
    if cpu[:2] != ("", 0):
        raise AssertionError(f"runtime: a task without a GPU lease sees "
                             f"{cpu[:2]}")
    if gpu[1] != 1 or gpu[2] != card_name or not gpu[0]:
        raise AssertionError(f"runtime: a num_gpus=1 task sees {gpu[:3]}")
    cw = get_core_worker()
    daemons = {
        "raylet": cw._run(cw.raylet.call("GetState", {}))["loaded_packages"],
        "gcs": cw._run(cw.gcs.call("GetClusterStatus", {}))[
            "loaded_packages"]}
    banned = {"cpu worker": cpu[2], "gpu worker": gpu[3],
              **{k: sorted(set(v) & set(RUNTIME_BANNED))
                 for k, v in daemons.items()}}
    if any(banned.values()):
        raise AssertionError(f"runtime: processes loaded {banned}")
    return {"resources": res, "cpu_task": list(cpu[:2]),
            "gpu_task": list(gpu[:3])}


def runtime_tensor_checks(rt, rounds: int = 4) -> dict:
    """Step 2: a CUDA tensor returned by a GPU task, and a CPU tensor put
    and got, both bitwise. GB/s of each round trip, the first round (the
    arena's pages still untouched) and the best of the others."""

    @rt.remote(num_gpus=1)
    def make_tensor():
        t = runtime_tensor("cuda")
        torch.cuda.synchronize()
        return t

    want = runtime_tensor("cuda")
    host = want.cpu()
    nbytes = want.numel() * want.element_size()
    rates = {"cuda_task_return": [], "cpu_put_get": []}
    for _ in range(rounds):
        t0 = time.perf_counter()
        got = rt.get(make_tensor.remote(), timeout=300)
        torch.cuda.synchronize()
        rates["cuda_task_return"].append(
            nbytes / (time.perf_counter() - t0) / 1e9)
        if got.device.type != "cuda" or not same_bits(got, want):
            raise AssertionError(f"runtime: the CUDA tensor came back on "
                                 f"{got.device}, or not bitwise")
        t0 = time.perf_counter()
        back = rt.get(rt.put(host))
        rates["cpu_put_get"].append(nbytes / (time.perf_counter() - t0)
                                    / 1e9)
        if back.device.type != "cpu" or not same_bits(back, host):
            raise AssertionError("runtime: the CPU tensor not bitwise")
        del got, back
    out = {"tensor_mib": nbytes / 2**20}
    for k, v in rates.items():
        out[f"{k}_gb_s_first"], out[f"{k}_gb_s_best"] = v[0], max(v[1:])
    return out


def runtime_oracle() -> tuple:
    """The Generator's greedy tokens for phase 4's greedy payloads, on
    the driver's own copy of the seeded LLAMA3_8B weights (the replica
    builds its own: weights never go through the object store), and the
    dense-cache model that judges a divergence."""
    cfg = LLAMA3_8B
    payloads, _warm = serving_payloads(cfg)
    params = init_params(cfg, seed=0)
    wants = []
    for p in payloads:
        if "temperature" in p:
            continue
        gen = Generator(cfg, params, batch=1,
                        max_len=len(p["prompt_tokens"]) + p["max_new_tokens"])
        wants.append([int(x) for x in gen.generate(
            [p["prompt_tokens"]],
            SamplingParams(max_new_tokens=p["max_new_tokens"]))[0]])
    return wants, gen.model


def runtime_serving(rt, serve, wants, oracle) -> dict:
    """Step 3: LLAMA3_8B served from a num_gpus=1 replica, phase 4's
    payloads sent together, 5 through the HTTP proxy and 4 through a
    handle; each greedy stream held against the Generator's `wants`."""
    cfg = LLAMA3_8B
    payloads, warm = serving_payloads(cfg)
    greedy = [p for p in payloads if "temperature" not in p]
    t0 = time.perf_counter()
    handle = serve.run(serve.deployment(
        ray_actor_options={"num_gpus": 1, "max_concurrency": 16})(
            LlamaReplica).bind())
    counters = handle.options(method_name="counters")
    before = counters.remote().result(timeout=600)
    run_s = time.perf_counter() - t0
    port = serve.start_http_proxy(port=0)
    name = "LlamaReplica"
    if before["visible"] in ("", None) or \
            not before["device"].startswith("cuda"):
        raise AssertionError(f"runtime: replica on {before['device']}, "
                             f"CUDA_VISIBLE_DEVICES={before['visible']!r}")
    # Warm-up burst (captures the decode graph), as phase 4.
    warm_recs = [{} for _ in warm]
    threads = [threading.Thread(target=handle_stream, args=(handle, w, r))
               for w, r in zip(warm, warm_recs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if any("error" in r for r in warm_recs):
        raise AssertionError(f"runtime: warm-up failed: {warm_recs}")
    before = counters.remote(True).result(timeout=120)  # counts set to 0
    results = [{} for _ in payloads]
    threads = []
    start = time.perf_counter()
    for i, (payload, rec) in enumerate(zip(payloads, results)):
        rec["submit"] = time.perf_counter()
        rec["route"] = "http" if i < HTTP_STREAMS else "handle"
        target, args = ((http_stream, (port, name, payload, rec))
                        if i < HTTP_STREAMS else
                        (handle_stream, (handle, payload, rec)))
        th = threading.Thread(target=target, args=args)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(600)
    after = counters.remote().result(timeout=120)
    for rec, payload in zip(results, payloads):
        if "error" in rec or len(rec.get("tokens", [])) != \
                payload["max_new_tokens"]:
            raise AssertionError(f"runtime: {rec.get('route')} stream of "
                                 f"{len(payload['prompt_tokens'])} tokens: "
                                 f"{rec}")
        if not all(0 <= t < cfg.vocab_size for t in rec["tokens"]):
            raise AssertionError(f"runtime: token out of the vocabulary: "
                                 f"{rec}")
    got = [r["tokens"] for r, p in zip(results, payloads)
           if "temperature" not in p]
    for p, toks, want in zip(greedy, got, wants):
        hold_greedy("runtime serving", oracle, cfg, p["prompt_tokens"], toks,
                    want, BF16_TIE)
    steps = after["decode_steps"] - before["decode_steps"]
    replays = after["graph_replays"] - before["graph_replays"]
    if steps == 0 or replays * CHUNK != steps:
        raise AssertionError(f"runtime: {steps} decode steps in {replays} "
                             "replays of the decode graph")
    graph = {k: n * replays for k, n in after["graph_launches"].items()}
    launches = {k: n + graph.get(k, 0)
                for k, n in after["eager_launches"].items()}
    if launches[ON_PATH] < cfg.n_layers * steps:
        raise AssertionError(f"runtime: {ON_PATH} launched "
                             f"{launches[ON_PATH]} times for {steps} decode "
                             f"steps of {cfg.n_layers} layers")
    if after["banned"]:
        raise AssertionError(f"runtime: the replica loaded {after['banned']}")
    if not after["pages_returned"]:
        raise AssertionError("runtime: the replica's KV pages did not all "
                             "return to the pool")
    wall = max(r["end"] for r in results) - start
    ttft = sorted((r["first"] - r["submit"]) * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    return {"requests": len(results), "http_streams": HTTP_STREAMS,
            "handle_streams": len(results) - HTTP_STREAMS, "tokens": n_tok,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(ttft), "ttft_max_ms": ttft[-1],
            "greedy_equal_to_generator": sum(t == w for t, w in
                                             zip(got, wants)),
            "replica_bringup_s": after["bringup_s"], "serve_run_s": run_s,
            "replica_visible": after["visible"],
            "decode_steps": steps, "graph_replays": replays,
            "eager_launches": after["eager_launches"],
            "graph_launches": graph, "launches": launches}, handle


def native_control_stats(what: str) -> dict:
    """The native planes' counters from the GCS (GetClusterStatus) and the
    head raylet (GetState), as their status calls report them."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    gcs = cw._run(cw.gcs.call("GetClusterStatus", {}))["native_control"]
    raylet = cw._run(cw.raylet.call("GetState", {}))["native_control"]
    if gcs is None or raylet is None:
        raise AssertionError(f"{what}: a native plane is not installed "
                             f"(gcs {gcs}, raylet {raylet})")
    return {"gcs": gcs, "raylet": raylet}


def native_leases(stats: dict) -> int:
    """Leases the raylet's lease plane granted on its pump thread."""
    return stats["raylet"]["methods"]["RequestWorkerLease"]["handled"]


def hold_planes(what: str, stats: dict) -> None:
    """Each daemon's plane handled frames natively, the raylet's granted
    leases, and neither degraded a method or tripped its breaker."""
    bad = {k: (p["handled_total"], p["native_degraded_total"],
               p["divergence_trips_total"]) for k, p in stats.items()}
    if (any(h <= 0 or d or t for h, d, t in bad.values())
            or native_leases(stats) <= 0):
        raise AssertionError(f"{what}: (handled, degraded, tripped) "
                             f"{bad}, native leases {native_leases(stats)}")


def pool_ready(width: int) -> bool:
    """The driver holds no task lease (each went back after
    idle_worker_keep_s) and the head raylet's idle pool has `width`
    workers (GetState)."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    if any(cw._leases.values()):
        return False
    return cw._run(cw.raylet.call("GetState", {}))["idle_workers"] >= width


def lease_waves(rt, fn, waves: int, width: int) -> tuple:
    """`waves` waves of `width` tasks of `fn`, each once the driver holds
    no lease and `width` workers are in the raylet's idle pool: every
    task of a wave asks for a lease, which a warm pool can grant at once
    (natively, on the lease plane). Returns each wave's ms from submit to
    its last result, and the ms from request to grant of each lease the
    driver held at a wave's end (its submitter's own stamps)."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    out, grants = [], []
    for _ in range(waves):
        wait_until("lease waves: the idle pool",
                   lambda: pool_ready(width), timeout=60, period=0.01)
        t0 = time.perf_counter()
        rt.get([fn.remote() for _ in range(width)], timeout=120)
        out.append((time.perf_counter() - t0) * 1e3)
        grants += [(s.lease_granted_ts - s.lease_requested_ts) * 1e3
                   for slots in list(cw._leases.values())
                   for s in list(slots)]
    return out, grants


def runtime_native_control(rt) -> dict:
    """Step 4: the phase's control path ran on the native planes. A plain
    actor (the actor plane's simple shape) is made and called first, and
    a CPU task runs twice, the second time once its worker is back in
    the idle pool, so the lease plane grants its lease; then the GCS's
    and the raylet's counters: each daemon's frames handled natively
    > 0, the raylet's native leases > 0, nothing degraded, no divergence
    trip."""
    @rt.remote
    class Probe:
        def ping(self):
            return "pong"

    @rt.remote
    def cpu_ping():
        return "pong"

    probe = Probe.remote()
    if rt.get(probe.ping.remote(), timeout=120) != "pong":
        raise AssertionError("runtime: the probe actor did not answer")
    rt.kill(probe)
    rt.get(cpu_ping.remote(), timeout=120)
    wave_ms = lease_waves(rt, cpu_ping, 1, 1)[0][0]
    stats = native_control_stats("runtime")
    log("runtime native control: " + json.dumps(stats))
    hold_planes("runtime", stats)
    return {"gcs_handled": stats["gcs"]["handled_total"],
            "raylet_handled": stats["raylet"]["handled_total"],
            "native_leases": native_leases(stats),
            "cpu_task_on_pool_ms": wave_ms,
            "native_fallthrough": sum(p["native_fallthrough_total"]
                                      for p in stats.values()),
            "native_degraded": 0, "divergence_trips": 0}


def replica_tokens(rt, replica, payload: dict) -> list:
    """One stream pulled from a Serve replica through its actor handle
    (start_stream, then next_chunks until done): no GCS on the way."""
    sid = rt.get(replica.start_stream.remote("__call__", (payload,), {}),
                 timeout=120)
    toks = []
    while True:
        out = rt.get(replica.next_chunks.remote(sid, 64), timeout=120)
        toks += out["values"]
        if out["done"]:
            return toks


def replica_counters(rt, replica, reset: bool = False) -> dict:
    return rt.get(replica.handle_request.remote("counters", (reset,), {}),
                  timeout=120)


def wait_until(what: str, fn, timeout: float = 60.0, period: float = 0.05):
    """fn() until it returns a true value, retrying its errors; returns
    (value, seconds)."""
    t0 = time.perf_counter()
    last = None
    while time.perf_counter() - t0 < timeout:
        try:
            got = fn()
        except Exception as e:  # the GCS may still be coming up
            last, got = e, None
        if got:
            return got, time.perf_counter() - t0
        time.sleep(period)
    raise AssertionError(f"{what}: not within {timeout} s (last error: "
                         f"{last!r})")


def runtime_gcs_restart(rt, serve, handle, wants, oracle,
                        n_cards: int) -> dict:
    """Step 5: the GCS killed and restarted with the replica alive. A KV
    row is written first. While the GCS is down the replica, reached
    through its actor handle, serves the greedy payloads, each held
    against the Generator. After restart_gcs(): the raylet re-registers
    (its GetState count of registrations moves), a new task runs, the
    Serve controller is found by name and the replica's actor row is
    ALIVE, the KV row is back, and the replica serves the greedy payloads
    again through the Serve handle, the same tokens bitwise as with the
    GCS down. Then the deployment is deleted and a
    num_gpus=0.25 task gets a card. Returns the figures and K3's
    launches in the step (the replica's counts, graph replays
    included)."""
    from ray_tpu_torch._private.api_internal import get_core_worker
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    cfg = LLAMA3_8B
    cw = get_core_worker()
    node = rt._runtime_node
    greedy = [p for p in serving_payloads(cfg)[0] if "temperature" not in p]
    replica = handle._get_replicas()[0]
    replica_id = replica._actor_id.hex()
    cw._run(cw.gcs.call("KVPut", {"ns": "chip_smoke", "key": b"phase 15",
                                  "value": b"written before the kill"}))
    regs0 = cw._run(cw.raylet.call("GetState", {}))["gcs_registrations"]
    before = replica_counters(rt, replica, reset=True)
    node.kill_gcs()
    t_down = time.perf_counter()
    down = [replica_tokens(rt, replica, p) for p in greedy]
    down_s = time.perf_counter() - t_down
    for p, toks, want in zip(greedy, down, wants):
        hold_greedy("runtime, GCS down", oracle, cfg, p["prompt_tokens"],
                    toks, want, BF16_TIE)
    t_restart = time.perf_counter()
    node.restart_gcs()
    _, reg_s = wait_until("runtime: raylet re-registration", lambda: cw._run(
        cw.raylet.call("GetState", {}))["gcs_registrations"] > regs0)

    @rt.remote
    def first_task():
        return "ran"

    if rt.get(first_task.remote(), timeout=120) != "ran":
        raise AssertionError("runtime: no task after the GCS restart")
    task_s = time.perf_counter() - t_restart
    wait_until("runtime: the Serve controller by name",
               lambda: rt.get_actor(CONTROLLER_NAME, namespace="serve"))
    info = cw._run(cw.gcs.call("GetActorInfo", {"actor_id": replica_id}))
    if (info or {}).get("state") != "ALIVE":
        raise AssertionError(f"runtime: replica's actor row after the "
                             f"restart: {info}")
    kv = cw._run(cw.gcs.call("KVGet", {"ns": "chip_smoke",
                                       "key": b"phase 15"}))
    if kv.get("value") != b"written before the kill":
        raise AssertionError(f"runtime: KV row after the restart: {kv}")
    recs = [{} for _ in greedy]
    for p, rec in zip(greedy, recs):
        handle_stream(handle, p, rec)
    for p, rec, want in zip(greedy, recs, wants):
        if "error" in rec:
            raise AssertionError(f"runtime, GCS restarted: {rec}")
        hold_greedy("runtime, GCS restarted", oracle, cfg,
                    p["prompt_tokens"], rec["tokens"], want, BF16_TIE)
    # One stream at a time on the same replica both times: the same
    # tokens, bitwise, whether the GCS was down or back.
    if [r["tokens"] for r in recs] != down:
        raise AssertionError("runtime: the replica's tokens with the GCS "
                             "down differ from its tokens after the "
                             "restart")
    after = replica_counters(rt, replica)
    replays = after["graph_replays"] - before["graph_replays"]
    graph = {k: n * replays for k, n in after["graph_launches"].items()}
    launches = {k: n + graph.get(k, 0)
                for k, n in after["eager_launches"].items()}
    native_after = native_control_stats("runtime, GCS restarted")
    serve.delete("LlamaReplica")
    wait_until("runtime: the replica's card back",
               lambda: rt.available_resources().get("GPU") == n_cards,
               timeout=120)

    @rt.remote(num_gpus=0.25)
    def card_share():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    visible = rt.get(card_share.remote(), timeout=120)
    if not visible:
        raise AssertionError("runtime: a num_gpus=0.25 task after the "
                             "restart got no card")
    return {"gcs_down_s": down_s,
            "restart_to_reregistration_s": reg_s,
            "restart_to_first_task_s": task_s,
            "down_greedy_equal": sum(t == w for t, w in zip(down, wants)),
            "after_greedy_equal": sum(r["tokens"] == w
                                      for r, w in zip(recs, wants)),
            "share_task_visible": visible,
            "native_after_restart": {
                k: {f: v[f] for f in ("handled_total",
                                      "native_fallthrough_total",
                                      "native_degraded_total",
                                      "divergence_trips_total")}
                for k, v in native_after.items()},
            "restart_launches": launches}


def runtime_phase(card: str, phase4: dict) -> dict:
    """Phase 15. The port's runtime with its defaults: a GCS, a raylet
    with its object store, workers forked from the torch-warm zygote;
    returns the paged kernels' launches in the replica's timed run. The
    card's free memory is read once the driver holds what it keeps for
    the phase (the oracle), and again after shutdown: what the cluster's
    processes held must be back (64 MiB of slack). `phase4` is phase 4's
    run, whose figures are logged beside this phase's. Also returns K3's
    launches in the GCS restart step (runtime_gcs_restart)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    wants, oracle = runtime_oracle()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    rt.init()
    try:
        init_s = time.perf_counter() - t0
        start = runtime_start_checks(rt, n_cards,
                                     torch.cuda.get_device_name(0))
        tensors = runtime_tensor_checks(rt)
        run, handle = runtime_serving(rt, serve, wants, oracle)
        native = runtime_native_control(rt)
        restart = runtime_gcs_restart(rt, serve, handle, wants, oracle,
                                      n_cards)
    finally:
        procs = cluster_processes(rt._runtime_node)
        t_down = time.perf_counter()
        serve.shutdown()
        rt.shutdown()
    down = cluster_left("runtime", procs, free0, t_down)
    phase4 = {k: phase4.get(k) for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_max_ms", "wall_s")}
    SERVED.update(greedy=wants, phase4=phase4, runtime={
        k: run[k] for k in ("tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
                            "wall_s")})
    log("runtime serving: " + json.dumps({
        "card": card, "init_s": init_s, **start, **tensors, **run, **down,
        "phase4_in_process": phase4}))
    log("runtime native control and GCS restart: " + json.dumps({
        "card": card, **native, **restart}))
    return run["launches"], restart["restart_launches"]


# Phase 16: the gang's worker holds half of the card; a landing task
# takes data.dataset.LANDING_GPU_SHARE (1/8), so 4 landings run beside it.
GANG_GPU_SHARE = 0.5
GANG_TASK_SHARE = 0.25     # the device-plane phase's producer task and actor


def gang_collectives(rt) -> dict:
    """Step 1: an NCCL group of one in a num_gpus actor: allreduce (each
    op), allgather, reducescatter (7 rows), broadcast and barrier on
    seeded bf16 and f32 CUDA tensors, held bitwise against the same ops
    on the CPU by the reference's rules for a world of one (a reduction
    over one member is its tensor, a gather the list of it,
    array_split(x, 1)[0] its tensor)."""

    @rt.remote(num_gpus=GANG_TASK_SHARE)
    class Member:
        def run(self):
            from ray_tpu_torch.util import collective as col

            t0 = time.perf_counter()
            col.init_collective_group(1, 0, backend="nccl",
                                      group_name="smoke")
            out, bad = {}, []
            gen = torch.Generator().manual_seed(3)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(7, 1024, generator=gen).to(dtype)
                name = str(dtype).removeprefix("torch.")
                got = {f"allreduce_{op}": col.allreduce(
                    x.cuda(), "smoke", op=op).cpu()
                    for op in ("sum", "product", "min", "max")}
                got["allgather"] = torch.stack(
                    col.allgather(x.cuda(), "smoke")).cpu()
                got["reducescatter"] = col.reducescatter(
                    x.cuda(), "smoke").cpu()
                got["broadcast"] = col.broadcast(x.cuda(), 0, "smoke").cpu()
                col.barrier("smoke")
                want = {k: x for k in got}
                want["allgather"] = torch.stack([x])
                want["reducescatter"] = torch.tensor_split(x, 1)[0]
                for k, g in got.items():
                    if not same_bits(g.view(-1).view(torch.int16),
                                     want[k].reshape(-1).view(torch.int16)):
                        bad.append(f"{name} {k}")
                out[name] = sorted(got)
            col.destroy_collective_group("smoke")
            return {"ops": out, "bad": bad, "group_s": time.perf_counter()
                    - t0, "group_size": 1}

    m = Member.remote()
    try:
        out = rt.get(m.run.remote(), timeout=300)
    finally:
        rt.kill(m)
    if out["bad"]:
        raise AssertionError(f"gang: NCCL ops differ from the CPU's: "
                             f"{out['bad']}")
    return out


def registry_pins(rt) -> int:
    """Tensors pinned in the device registries of this node's workers."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    resp = cw._run(cw.raylet.call("NodeDeviceObjects", {}))
    errors = [w for w in resp["workers"] if "error" in w]
    if errors:
        raise AssertionError(f"gang: NodeDeviceObjects failed: {errors}")
    return sum(w["pinned_objects"] for w in resp["workers"])


def gang_device_plane(rt) -> dict:
    """Step 2: phase 15's 64 MiB bf16 tensor from a GPU-share task with
    tensor_transport="device", got by the driver; a driver tensor from
    device_put, got by a GPU-share actor. Both bitwise and both by the
    ipc route, host_fallback 0; GB/s of each get (the producer's work
    done first), beside the same task's return through the host path.
    Once the refs are dropped every registry is empty."""
    from ray_tpu_torch._private import device_objects as dobj

    @rt.remote(num_gpus=GANG_TASK_SHARE)
    def make_tensor():
        t = runtime_tensor("cuda")
        torch.cuda.synchronize()
        return t

    @rt.remote(num_gpus=GANG_TASK_SHARE)
    class Taker:
        def __init__(self):
            torch.zeros(1, device="cuda")   # its CUDA started before a take

        def take(self, t, t_sent):
            got = time.perf_counter() - t_sent
            torch.cuda.synchronize()
            want = runtime_tensor("cuda")
            return {"bitwise": same_bits(t, want), "s": got,
                    "device": str(t.device), "counters": dobj.counters()}

        def pins(self):
            return dobj.registry().stats()["pinned_objects"]

    want = runtime_tensor("cuda")
    nbytes = want.numel() * want.element_size()
    before = dobj.counters()
    out = {"tensor_mib": nbytes / 2**20}
    for route in ("host", "device"):
        opts = {"tensor_transport": "device"} if route == "device" else {}
        rates = []
        for _ in range(3):
            ref = make_tensor.options(**opts).remote()
            rt.wait([ref], timeout=300)
            t0 = time.perf_counter()
            got = rt.get(ref, timeout=300)
            torch.cuda.synchronize()
            rates.append(nbytes / (time.perf_counter() - t0) / 1e9)
            if got.device.type != "cuda" or not same_bits(got, want):
                raise AssertionError(f"gang: the {route} task return came "
                                     f"back on {got.device}, or not bitwise")
            del ref, got
        out[f"task_{route}_gb_s_first"] = rates[0]
        out[f"task_{route}_gb_s_best"] = max(rates[1:])
    driver = {k: v - before.get(k, 0) for k, v in dobj.counters().items()}
    taker = Taker.remote()
    rt.get(taker.pins.remote(), timeout=300)     # the actor is up
    ref = dobj.device_put(want)
    got = rt.get(taker.take.remote(ref, time.perf_counter()), timeout=300)
    del ref
    if not got["bitwise"] or not got["device"].startswith("cuda"):
        raise AssertionError(f"gang: device_put's tensor reached the actor "
                             f"as {got}")
    out["device_put_to_actor_gb_s"] = nbytes / got["s"] / 1e9
    actor = got["counters"]
    out["driver_routes"] = {k: driver[k] for k in ("ipc", "collective",
                                                   "host_fallback")}
    out["actor_routes"] = {k: actor[k] for k in ("ipc", "collective",
                                                 "host_fallback")}
    if (driver["ipc"], driver["host_fallback"]) != (3, 0) or \
            (actor["ipc"], actor["host_fallback"]) != (1, 0):
        raise AssertionError(f"gang: routes driver {driver}, actor {actor}:"
                             " expected the ipc route every time")
    deadline = time.time() + 30
    while time.time() < deadline and (
            dobj.registry().stats()["pinned_objects"] or registry_pins(rt)):
        time.sleep(0.1)
    out["pins_after"] = {"driver": dobj.registry().stats()["pinned_objects"],
                         "node": registry_pins(rt)}
    rt.kill(taker)
    if any(out["pins_after"].values()):
        raise AssertionError(f"gang: pins left after the refs were dropped:"
                             f" {out['pins_after']}")
    return out


def gang_inputs(batch):
    """The Dataset's map_batches stage: a row of S + 1 tokens becomes its
    inputs and targets."""
    tok = batch["tokens"]
    return {"inp": tok[:, :-1], "tgt": tok[:, 1:]}


def gang_loop(config):
    """The gang worker's train loop: the broadcast weights, batches from
    iter_device_batches (device landings), make_train_step over K1 and
    K1-bwd; one warm-up step, then the timed steps, each reported with
    its loss and time; the flash launches of the timed steps, the device
    plane's routes and the landings are reported last."""
    from ray_tpu_torch._private import device_objects as dobj
    from ray_tpu_torch.data import dataset as data_mod
    from ray_tpu_torch.train import session

    t_ready = time.time()
    state = init_train_state(config["cfg"], adamw(3e-4, weight_decay=0.01),
                             session.get_broadcast_weights())
    step = make_train_step(llama_loss)
    batches = iter(config["dataset"].iter_device_batches(batch_size=TRAIN_B))
    for i in range(TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        batch = next(batches)
        fetch_s = time.perf_counter() - t0
        if i == 1:
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t_steps = t0
        t0 = time.perf_counter()
        state, metrics = step(state, (batch["inp"], batch["tgt"]))
        loss = metrics["loss"].item()
        session.report({"step": i, "loss": loss, "fetch_s": fetch_s,
                        "step_s": time.perf_counter() - t0,
                        "loop_started": t_ready})
    wall = time.perf_counter() - t_steps
    if next(batches, None) is not None:
        raise AssertionError("gang: the Dataset held more batches")
    session.report({"step": "end", "launches": dict(fa.launch_counts),
                    "steps_wall_s": wall,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "routes": dobj.counters(),
                    "landings": data_mod.landing_counters(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "banned": banned_loaded()})


def gang_training(rt, card: str) -> dict:
    """Step 3: TRAIN_CFG trained by TorchTrainer(num_workers=1,
    use_gpu=True) on GANG_GPU_SHARE of the card: the driver's seed-0
    weights by broadcast_weights, the training phase's batch 11 times
    (one warm-up step and TRAIN_STEPS timed ones) as a Dataset of token
    rows from default_rng(0) with a map_batches stage."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    cfg = TRAIN_CFG
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (TRAIN_B, TRAIN_S + 1))
    dataset = rd.from_items([{"tokens": r} for _ in range(TRAIN_STEPS + 1)
                             for r in rows]).map_batches(gang_inputs)
    weights = init_params(cfg, seed=0)
    trainer = TorchTrainer(
        gang_loop, train_loop_config={"cfg": cfg, "dataset": dataset},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     gpus_per_worker=GANG_GPU_SHARE),
        initial_weights=weights)
    t0 = time.time()
    result = trainer.fit()
    fit_s = time.time() - t0
    del weights
    steps = [m for m in result.metrics_history if m["step"] != "end"]
    end = result.metrics_history[-1]
    losses = [m["loss"] for m in steps]
    want = TRAINED["training"]
    timed = sum(m["step_s"] for m in steps[1:])
    out = {"card": card, "gpu_share": GANG_GPU_SHARE, "fit_s": fit_s,
           "s_to_ready_loop": steps[0]["loop_started"] - t0,
           "weights_received": trainer.weights_received,
           "losses": losses, "training_phase_losses": want["losses"],
           "max_abs_loss_diff": max(abs(a - b) for a, b in
                                    zip(losses, want["losses"])),
           "tokens_per_s": TRAIN_B * TRAIN_S * TRAIN_STEPS
           / end["steps_wall_s"],
           "tokens_per_s_steps_only": TRAIN_B * TRAIN_S * TRAIN_STEPS / timed,
           "training_phase_tokens_per_s": want["tokens_per_s"],
           "ms_per_step": end["steps_wall_s"] / TRAIN_STEPS * 1e3,
           "fetch_ms": [m["fetch_s"] * 1e3 for m in steps],
           "step_ms": [m["step_s"] * 1e3 for m in steps],
           "peak_gib": end["peak_gib"], "launches": end["launches"],
           "worker_routes": {k: end["routes"][k] for k in (
               "ipc", "collective", "host_fallback", "in_process")},
           "landings": end["landings"], "worker_visible": end["visible"]}
    log("gang training: " + json.dumps(out))
    expect = flash_launches(cfg, TRAIN_STEPS)
    if len(losses) != TRAIN_STEPS + 1 or losses != want["losses"]:
        raise AssertionError(f"gang: losses {losses} != the training "
                             f"phase's {want['losses']}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"gang: loss did not fall: {losses}")
    if end["launches"] != expect:
        raise AssertionError(f"gang: flash launches {end['launches']}, "
                             f"expected {expect}")
    if end["landings"]["host_batches"] or not end["landings"][
            "device_landings"] or end["routes"]["host_fallback"] \
            or not end["routes"]["ipc"]:
        raise AssertionError(f"gang: landings {end['landings']}, routes "
                             f"{end['routes']}: expected device landings "
                             "by the ipc route only")
    if end["banned"]:
        raise AssertionError(f"gang: the worker loaded {end['banned']}")
    return out


def gang_phase(card: str) -> dict:
    """Phase 16. The port's runtime with its defaults, as phase 15: an
    NCCL group of one, the device plane's ipc route, then the training
    gang fed by Data. Returns the flash kernels' launches in the gang
    worker's timed steps. After the shutdown no process of the phase's
    cluster is left and the card's free memory is back (64 MiB of
    slack)."""
    import ray_tpu_torch as rt

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    rt.init()
    try:
        init_s = time.perf_counter() - t0
        coll = gang_collectives(rt)
        plane = gang_device_plane(rt)
        log("gang device plane: " + json.dumps({
            "card": card, "init_s": init_s, "collectives": coll, **plane}))
        run = gang_training(rt, card)
    finally:
        procs = cluster_processes(rt._runtime_node)
        t_down = time.perf_counter()
        rt.shutdown()
    log("gang shutdown: " + json.dumps(
        cluster_left("gang", procs, free0, t_down)))
    return run["launches"]


def cluster_left(what: str, procs: dict, free0: int, t_down: float) -> dict:
    """After a phase's shutdown: no process of its cluster left and the
    card's free memory back (64 MiB of slack), each waited for up to a
    minute. Returns the figures; raises otherwise."""
    deadline = time.time() + 60
    while still_running(procs) and time.time() < deadline:
        time.sleep(0.05)
    left = still_running(procs)
    down_s = time.perf_counter() - t_down
    gc.collect()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    while free0 - free1 > 64 << 20 and time.time() < deadline:
        time.sleep(0.2)
        free1 = torch.cuda.mem_get_info()[0]
    out = {"cluster_processes": len(procs), "shutdown_s": down_s,
           "free_gib_before": free0 / 2**30, "free_gib_after": free1 / 2**30}
    if left:
        raise AssertionError(f"{what}: processes left after shutdown: {left}")
    if free0 - free1 > 64 << 20:
        raise AssertionError(f"{what}: card memory free {free1 / 2**30:.3f} "
                             f"GiB after the phase, {free0 / 2**30:.3f} GiB "
                             "before")
    return out


def daemons_banned(cluster) -> dict:
    """The packages of RUNTIME_BANNED loaded by a cluster's GCS and each
    of its raylets."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    out = {"gcs": cw._run(cw.gcs.call("GetClusterStatus", {}))[
        "loaded_packages"]}

    async def raylet_state(host, port):
        conn = await rpc.dial(host, port, name="smoke")
        try:
            return await conn.call("GetState", {}, timeout=30)
        finally:
            await conn.close()

    for n in cluster.nodes:
        out[f"raylet {n.node_id[:8]}"] = cw._run(
            raylet_state(n.host, n.port))["loaded_packages"]
    return {k: sorted(set(v) & set(RUNTIME_BANNED)) for k, v in out.items()}


# Phase 17: LLAMA3_8B in three replicas (a prefill pool of one, a decode
# pool of two), each on half of its node's view of the one card; round
# B's streams park on 4-token buffers.
DISAGG_GPU_SHARE = 0.5
DISAGG_BUFFER = 4


class DisaggPrefill(PrefillServer):
    """Phase 17's prefill replica: PrefillServer on LLAMA3_8B, the seeded
    weights built on its own card; also reports what it loaded."""

    def banned(self) -> list:
        return banned_loaded()


class DisaggDecode(DecodeServer):
    """Phase 17's decode replica: DecodeServer on LLAMA3_8B, the seeded
    weights built on its own card; also reports the engine's counters and
    the kernels' launches, and the dense-oracle top-2 gap that judges a
    near-tie (the driver keeps no copy of the weights)."""

    def counters(self, reset: bool = False) -> dict:
        from ray_tpu_torch._private import device_objects as dobj

        eng = self.engine
        torch.cuda.synchronize()
        out = {"decode_steps": eng.decode_steps,
               "graph_replays": eng.graph_replays,
               "graph_launches": dict(eng.graph_launches),
               "eager_launches": dict(pa.launch_counts),
               "plane": dobj.counters(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "device": str(eng.model.embed.weight.device),
               "banned": banned_loaded()}
        if reset:
            pa.reset_launch_counts()
        return out

    def top2(self, tokens) -> tuple:
        with torch.no_grad():
            return top2(self.engine.model, self.cfg, tokens)


def replica_call(handle, method: str, *args):
    """`method` on every replica of a deployment, in replica order."""
    import ray_tpu_torch as rt

    return rt.get([r.handle_request.remote(method, list(args), {}, "")
                   for r in handle._get_replicas()], timeout=600)


def disagg_stream(h, payload: dict, rec: dict) -> None:
    toks = []
    try:
        for tok in h.stream(payload):
            if not toks:
                rec["first"] = time.perf_counter()
            toks.append(tok)
    except Exception as e:  # recorded; the phase fails below
        rec["error"] = e
    rec["tokens"], rec["end"] = toks, time.perf_counter()


def disagg_streams(h, payloads) -> list:
    """Every payload through DisaggHandle.stream, together, one thread
    each; one record a payload."""
    recs = [{"submit": time.perf_counter()} for _ in payloads]
    threads = [threading.Thread(target=disagg_stream, args=(h, p, r))
               for p, r in zip(payloads, recs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return recs


def disagg_round_a(h, cfg, wants) -> dict:
    """Round A: phase 4's 9 payloads together through the router, each
    greedy stream held against phase 15's Generator tokens; the first
    prompt again (a prefix-cache hit); the hand-offs by the ipc route;
    K3's launches in the decode replicas' graphs."""
    payloads, warm = serving_payloads(cfg)
    greedy = [p for p in payloads if "temperature" not in p]
    decode = h._decode
    for _ in range(4):   # warm-up bursts until both decode graphs exist
        if any("error" in r for r in disagg_streams(h, warm)):
            raise AssertionError("disagg serving: the warm-up failed")
        if all(c["graph_replays"] for c in replica_call(decode, "counters")):
            break
    before = replica_call(decode, "counters", True)    # counts set to 0
    pre0 = replica_call(h._prefill, "report_metrics")[0]
    start = time.perf_counter()
    recs = disagg_streams(h, payloads)
    wall = max(r["end"] for r in recs) - start
    after = replica_call(decode, "counters")
    pre1 = replica_call(h._prefill, "report_metrics")[0]
    for rec, p in zip(recs, payloads):
        if "error" in rec or len(rec.get("tokens", [])) != \
                p["max_new_tokens"] or not all(0 <= t < cfg.vocab_size
                                               for t in rec["tokens"]):
            raise AssertionError(f"disagg serving: stream of "
                                 f"{len(p['prompt_tokens'])} tokens: {rec}")
    gap = lambda toks: replica_call(decode, "top2", toks)[0]  # noqa: E731
    got = [r["tokens"] for r, p in zip(recs, payloads)
           if "temperature" not in p]
    for p, toks, want in zip(greedy, got, wants):
        hold_greedy("disagg serving", gap, cfg, p["prompt_tokens"], toks,
                    want, BF16_TIE)
    again = disagg_streams(h, [greedy[0]])[0]
    pre2 = replica_call(h._prefill, "report_metrics")[0]
    if pre2["prefix_cache_hits"] <= pre1["prefix_cache_hits"] or \
            "error" in again:
        raise AssertionError(f"disagg serving: the first prompt again: "
                             f"{again}, cache {pre1} -> {pre2}")
    hold_greedy("disagg serving, a cache hit", gap, cfg,
                greedy[0]["prompt_tokens"], again["tokens"], wants[0],
                BF16_TIE)
    steps = sum(a["decode_steps"] - b["decode_steps"]
                for a, b in zip(after, before))
    replays = [a["graph_replays"] - b["graph_replays"]
               for a, b in zip(after, before)]
    launches = {k: sum(a["eager_launches"][k]
                       + a["graph_launches"].get(k, 0) * n
                       for a, n in zip(after, replays)) for k in KERNELS}
    if not steps or launches[ON_PATH] < cfg.n_layers * steps:
        raise AssertionError(f"disagg serving: {ON_PATH} launched "
                             f"{launches[ON_PATH]} times for {steps} decode "
                             f"steps of {cfg.n_layers} layers")
    plane = {k: sum(a["plane"][k] for a in after)
             for k in ("ipc", "collective", "host_fallback", "in_process")}
    if not plane["ipc"] or plane["host_fallback"] or plane["collective"]:
        raise AssertionError(f"disagg serving: decode-side routes {plane}: "
                             "expected every KV hand-off by ipc")
    banned = {f"decode {i}": a["banned"] for i, a in enumerate(after)}
    banned["prefill"] = replica_call(h._prefill, "banned")[0]
    if any(banned.values()):
        raise AssertionError(f"disagg serving: replicas loaded {banned}")
    metrics = h.pool_metrics()
    ttft = sorted((r["first"] - r["submit"]) * 1e3 for r in recs)
    n_tok = sum(len(r["tokens"]) for r in recs)
    return {"requests": len(recs), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": statistics.median(ttft), "ttft_max_ms": ttft[-1],
            "greedy_equal_to_generator": sum(t == w for t, w in
                                             zip(got, wants)),
            "phase15_replica": SERVED.get("runtime"),
            "phase4_in_process": SERVED.get("phase4"),
            "prefill_ms_p50": pre1["prefill_ms_p50"],
            "prefill_served": pre1["served"] - pre0["served"],
            "prefix_cache": {k: pre2[k] for k in pre2
                             if k.startswith("prefix_cache_")},
            "kv_handoff_ms_p50": [m["kv_handoff_ms_p50"]
                                  for m in metrics["decode"]],
            "kv_handoff_gb_s": [m["kv_handoff_gb_s"]
                                for m in metrics["decode"]],
            "decode_routes": plane, "decode_steps": steps,
            "graph_replays": replays,
            "replica_visible": [a["visible"] for a in after],
            "launches": launches}


def disagg_round_b(cluster, h, cfg, decode_nodes, wants) -> dict:
    """Round B: two greedy streams on DISAGG_BUFFER-token buffers, 3
    tokens taken of each; the decode node holding a stream preempted
    (drain to DRAINED, then killed); every token once and the streams
    phase 15's Generator tokens (a divergence only at a near-tie)."""
    from ray_tpu_torch._private import device_objects as dobj
    from ray_tpu_torch.test_utils import NodePreempter

    payloads, _warm = serving_payloads(cfg)
    greedy = [p for p in payloads if "temperature" not in p][:2]
    gens = [h.stream({**p, "stream_buffer": DISAGG_BUFFER}) for p in greedy]
    got = [[next(g) for _ in range(3)] for g in gens]
    rows = h.pool_metrics()["decode"]
    holder = next(m for m in rows if m.get("active_streams", 0) > 0)
    target = next(n for n in decode_nodes if n.node_id == holder["node_id"])
    gap_replica = next(r for r, m in zip(h._decode._get_replicas(), rows)
                       if m.get("node_id") != target.node_id)
    before = dobj.counters()
    stats0 = dict(h.stats)
    t_drain = time.perf_counter()
    res = NodePreempter(cluster, deadline_s=10).preempt(target)
    preempt_s = time.perf_counter() - t_drain
    if res.get("state") != "DRAINED":
        raise AssertionError(f"disagg serving: the decode node's drain "
                             f"ended {res}")
    next_token_s = []
    for i, g in enumerate(gens):
        for j, tok in enumerate(g):
            if j == 0:
                next_token_s.append(time.perf_counter() - t_drain)
            got[i].append(tok)

    def gap(toks):
        import ray_tpu_torch as rt

        return rt.get(gap_replica.handle_request.remote(
            "top2", [toks], {}, ""), timeout=600)

    for p, toks, want in zip(greedy, got, wants):
        if len(toks) != p["max_new_tokens"]:
            raise AssertionError(f"disagg serving: {len(toks)} tokens "
                                 f"across the drain: {toks}")
        hold_greedy("disagg drain", gap, cfg, p["prompt_tokens"], toks,
                    want, BF16_TIE)
    after = dobj.counters()
    stats = {k: h.stats[k] - stats0[k] for k in h.stats}
    evac_in = after["evacuated_in"] - before.get("evacuated_in", 0)
    if stats["evac_resumes"] < 1 or evac_in < 1 or \
            stats["fallback_reprefills"]:
        raise AssertionError(f"disagg serving: router {stats}, evacuated_in "
                             f"{evac_in}: expected a resume from the drain's"
                             " evacuation")
    return {"drain_state": res["state"], "preempt_s": preempt_s,
            "drain_to_next_token_s": next_token_s, "router": stats,
            "evacuated_in": evac_in,
            "drain_stats": next((n.get("drain_stats") for n in
                                 __import__("ray_tpu_torch").nodes()
                                 if n["node_id"] == target.node_id), None),
            "greedy_equal_to_generator": sum(t == w for t, w in
                                             zip(got, wants))}


def disagg_serving_phase(card: str) -> dict:
    """Phase 17. A cluster_utils.Cluster: the head node holds the driver
    (the router) and the prefill replica, two more nodes carry a
    `decode` resource and a decode replica each; every node sees the one
    card. serve.deploy_disagg at LLAMA3_8B, each replica building the
    seed-0 weights on its own card. Round A, then round B; returns K3's
    launches in round A. After serve.shutdown() and the cluster's
    shutdown no process of the phase is left and the card's memory is
    back."""
    import functools

    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    cfg = LLAMA3_8B
    wants = SERVED["greedy"]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True, connect=True)
    try:
        decode_nodes = [cluster.add_node(num_cpus=4,
                                         resources={"decode": 1})
                        for _ in range(2)]
        cluster.wait_for_nodes()
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h = serve.deploy_disagg(
            cfg, functools.partial(init_params, cfg, seed=0),
            prefill_replicas=1, decode_replicas=2, page_size=PAGE,
            max_batch=MAX_BATCH, max_len=MAX_LEN, decode_chunk=CHUNK,
            prefix_cache_size=16, prefill_cls=DisaggPrefill,
            decode_cls=DisaggDecode,
            prefill_actor_options={"num_gpus": DISAGG_GPU_SHARE},
            decode_actor_options={"num_gpus": DISAGG_GPU_SHARE,
                                  "resources": {"decode": 1}})
        replica_call(h._decode, "counters")
        replica_call(h._prefill, "banned")
        deploy_s = time.perf_counter() - t0
        round_a = disagg_round_a(h, cfg, wants)
        log("disagg serving, round A: " + json.dumps({
            "card": card, "cluster_start_s": start_s, "deploy_s": deploy_s,
            **round_a}))
        round_b = disagg_round_b(cluster, h, cfg, decode_nodes, wants)
        log("disagg serving, round B: " + json.dumps({"card": card,
                                                      **round_b}))
        banned = daemons_banned(cluster)
        if any(banned.values()):
            raise AssertionError(f"disagg serving: daemons loaded {banned}")
    finally:
        procs = cluster_processes(cluster._node)
        t_down = time.perf_counter()
        try:
            serve.shutdown()
        finally:
            cluster.shutdown()
    log("disagg serving shutdown: " + json.dumps(
        cluster_left("disagg serving", procs, free0, t_down)))
    return round_a["launches"]


# Phase 18: CKPT_CFG (0.40B) trained by an elastic gang of two on the one
# card. The loop runs each epoch's steps, then waits at its kept step's
# boundary for the resize the phase drives: steps 0-3 on 2 ranks, 4-7 on
# 1, 8-11 on 2 again.
ELASTIC_PLAN = {0: 3, 1: 7, 2: 11}
ELASTIC_STEPS = ELASTIC_PLAN[2] + 1
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def checksum(t: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's bit patterns, exact in
    int64: equal checksums of two tensors of one dtype and shape mean the
    same bits, but for a collision."""
    bits = t.detach().contiguous().view(-1).view(_BITS[t.element_size()])
    weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits.to(torch.int64) * weight).sum())


def state_checksums(tree) -> dict:
    """{name: checksum} of a kept state tree: the parameters, and each
    optimizer moment and step count."""
    out = {f"p:{n}": checksum(t) for n, t in tree["params"].items()}
    for i, st in tree["opt"]["state"].items():
        out.update({f"o:{i}:{k}": checksum(v) for k, v in st.items()})
    return out


def elastic_loop(config):
    """The elastic gang worker's loop. It starts from the broadcast
    weights, from its own kept state (a survivor) or from rank 0's (a
    grown worker); trains its epoch's steps on the training batch (the
    same rows on every rank, so the gang's mean gradient is one rank's);
    reports each step's loss and time and keeps its state; at the
    epoch's end gathers each rank's checksums, flash launches and start
    to rank 0's report; then waits at its kept step's boundary. config:
    "cfg", and optionally "plan" (each epoch's last step; ELASTIC_PLAN)
    and "device" (None: the card)."""
    import torch.distributed as tdist

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import session

    cfg, device = config["cfg"], config.get("device")
    plan = config.get("plan", ELASTIC_PLAN)
    on_card = device is None
    epoch = session.get_elastic_epoch()
    kept = session.get_elastic_state()
    peers = session.get_peer_states()
    start_tree = kept if kept is not None else peers.get(0)
    opt = adamw(3e-4, weight_decay=0.01)
    if start_tree is None:
        state = init_train_state(cfg, opt, session.get_broadcast_weights(),
                                 device=device)
        first = 0
    else:
        state = init_train_state(cfg, opt, dict(start_tree["params"]),
                                 device=device)
        state.optimizer.load_state_dict(start_tree["opt"])
        first = start_tree["step"] + 1
    info = {"rank": session.get_world_rank(), "first": first,
            "node": rt.get_runtime_context().node_id,
            "start": state_checksums(start_tree) if start_tree else None,
            "peers": {r: state_checksums(p) for r, p in peers.items()},
            "peer_steps": {r: p["step"] for r, p in peers.items()},
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "banned": banned_loaded()}
    del kept, peers, start_tree
    batch = train_batch(cfg, device=device or "cuda")
    world = session.get_world_size()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    tree = None
    for step in range(first, plan[epoch] + 1):
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        loss = llama_loss(state.model, batch)
        loss.backward()
        session.allreduce_gradients(
            {n: p.grad for n, p in state.model.named_parameters()})
        state.optimizer.step()
        value = loss.item()
        session.report({"step": step, "loss": value, "world": world,
                        "epoch": epoch, "step_s": time.perf_counter() - t0,
                        "t": time.time()})
        tree = {"step": step,
                "params": {n: p.detach() for n, p in
                           state.model.named_parameters()},
                "opt": state.optimizer.state_dict()}
        session.keep_state(tree, step=step)
    info.update(launches=dict(fa.launch_counts),
                steps=plan[epoch] + 1 - first, kept=state_checksums(tree),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30
                if on_card else 0.0)
    workers = [info]
    if world > 1:
        workers = [None] * world
        tdist.all_gather_object(workers, info)
    session.report({"step": "epoch", "epoch": epoch, "workers": workers})
    if epoch == max(plan):
        return
    while True:   # the kept step's boundary, until the resize
        time.sleep(0.05)
        session.keep_state(tree, step=plan[epoch])


def elastic_reference(cfg, device=None) -> list:
    """The uninterrupted in-process run: ELASTIC_STEPS steps of
    make_train_step from the seed-0 weights on the training batch."""
    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01),
                             init_params(cfg, seed=0, device=device),
                             device=device)
    step = make_train_step(llama_loss)
    batch = train_batch(cfg, device=device or "cuda")
    losses = []
    for _ in range(ELASTIC_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    return losses


def elastic_summaries(hist) -> dict:
    return {h["epoch"]: h["workers"] for h in hist if h["step"] == "epoch"}


def elastic_checks(cfg, trainer, result, want: list) -> dict:
    """The run against the uninterrupted one: losses bitwise, every start
    state the kept state of its step, launches, the resizes."""
    hist = result.metrics_history
    steps = [h for h in hist if h["step"] != "epoch"]
    epochs = elastic_summaries(hist)
    losses = [h["loss"] for h in steps]
    problems = []
    if [h["step"] for h in steps] != list(range(ELASTIC_STEPS)):
        problems.append(f"steps {[h['step'] for h in steps]}")
    if [h["world"] for h in steps] != [2] * 4 + [1] * 4 + [2] * 4:
        problems.append(f"worlds {[h['world'] for h in steps]}")
    if losses != want:
        problems.append(f"losses {losses} != the uninterrupted run's {want}")
    w0, w1, w2 = (epochs.get(e, []) for e in range(3))
    if len(w0) != 2 or len(w1) != 1 or len(w2) != 2:
        problems.append(f"gang sizes {len(w0)}, {len(w1)}, {len(w2)}")
    else:
        if w1[0]["start"] != w0[0]["kept"] or w1[0]["peer_steps"] != {1: 3} \
                or w1[0]["peers"].get(1) != w0[1]["kept"]:
            problems.append("after the shrink: the survivor's start or the "
                            "departed rank's tree is not the kept state of "
                            "step 3")
        if w2[0]["start"] != w1[0]["kept"] or w2[1]["start"] != \
                w1[0]["kept"] or w2[1]["peer_steps"] != {0: 7}:
            problems.append("after the grow: a start is not rank 0's kept "
                            "state of step 7")
        for e, ws in enumerate((w0, w1, w2)):
            for w in ws:
                if w["launches"] != flash_launches(cfg, w["steps"]):
                    problems.append(f"epoch {e} rank {w['rank']}: flash "
                                    f"launches {w['launches']} in "
                                    f"{w['steps']} steps")
                if w["banned"]:
                    problems.append(f"rank {w['rank']} loaded {w['banned']}")
    t = trainer.telemetry
    if (t["shrinks"], t["grows"], t["elastic_fallbacks"],
            t["full_restarts"]) != (1, 1, 0, 0) or \
            t["steps_lost"] > 2 * t["resizes"] or result.checkpoint:
        problems.append(f"telemetry {t}, checkpoint {result.checkpoint}")
    if problems:
        raise AssertionError("elastic gang: " + "; ".join(problems))
    return epochs


def elastic_phase(card: str) -> dict:
    """Phase 18. A cluster_utils.Cluster whose gang nodes carry a
    `trainer` resource (two at the start, a third added for the grow);
    TorchTrainer with ScalingConfig(num_workers=2, use_gpu=True,
    elastic=ElasticConfig(min_workers=1, max_workers=2)) over gloo (two
    NCCL ranks cannot share one card) trains CKPT_CFG from the driver's
    seed-0 weights (initial_weights, by the device plane). After step 3
    rank 1's node is preempted without a kill (the gang shrinks to 1),
    then removed and a new node added (the gang grows back to 2, the new
    member seeded from rank 0 through the device plane). Returns the
    flash kernels' launches in the gang's steps."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition
    from ray_tpu_torch.train import ElasticConfig, ScalingConfig, TorchTrainer

    cfg = CKPT_CFG
    t0 = time.perf_counter()
    want = elastic_reference(cfg)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    cluster = Cluster(initialize_head=True, connect=True)
    trainer = None
    try:
        gang = [cluster.add_node(num_cpus=4, resources={"trainer": 1})
                for _ in range(2)]
        cluster.wait_for_nodes()
        trainer = TorchTrainer(
            elastic_loop, train_loop_config={"cfg": cfg},
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True,
                resources_per_worker={"trainer": 1},
                elastic=ElasticConfig(min_workers=1, max_workers=2)),
            collective_backend="gloo",
            initial_weights=init_params(cfg, seed=0))
        holder = {}

        def fit():
            try:
                holder["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001
                holder["error"] = e

        th = threading.Thread(target=fit, daemon=True)
        t_fit = time.time()
        th.start()

        def at_epoch_end(e):
            if "error" in holder:
                raise holder["error"]
            m = trainer.latest_metrics
            return m.get("step") == "epoch" and m.get("epoch") == e

        wait_for_condition(lambda: at_epoch_end(0), timeout=600)
        rank1_node = trainer.latest_metrics["workers"][1]["node"]
        victim = next(n for n in gang if n.node_id == rank1_node)
        t_drain = time.time()
        drain = NodePreempter(cluster, deadline_s=10).preempt(victim,
                                                              kill=False)
        drained_s = time.time() - t_drain
        if drain.get("state") != "DRAINED":
            raise AssertionError(f"elastic gang: the drain ended {drain}")
        wait_for_condition(lambda: at_epoch_end(1), timeout=300)
        cluster.remove_node(victim)
        cluster.add_node(num_cpus=4, resources={"trainer": 1})
        cluster.wait_for_nodes()
        t_new = time.time()
        th.join(600)
        if th.is_alive() or "error" in holder:
            raise AssertionError(f"elastic gang: fit {holder or 'hung'}")
        result = holder["result"]
        epochs = elastic_checks(cfg, trainer, result, want)
        steps = [h for h in result.metrics_history if h["step"] != "epoch"]
        first = {e: next(h for h in steps if h["epoch"] == e)
                 for e in (1, 2)}

        def ms(world):   # steps after each epoch's first
            got = [h["step_s"] for h in steps if h["world"] == world
                   and h is not first.get(h["epoch"]) and h["step"]]
            return statistics.mean(got) * 1e3

        t = trainer.telemetry
        out = {"card": card, "config": "CKPT_CFG (0.40B), B 2, S 2048",
               "reference_run_s": reference_s, "fit_s": time.time() - t_fit,
               "losses": [h["loss"] for h in steps],
               "ms_per_step_2_ranks_gloo": ms(2),
               "ms_per_step_1_rank": ms(1),
               "drain_s": drained_s,
               "drain_to_first_step_of_1_s": first[1]["t"] - t_drain,
               "new_node_to_first_step_of_2_s": first[2]["t"] - t_new,
               "resizes": [{k: r[k] for k in ("direction", "lost",
                                              "pause_s", "total_s",
                                              "evacuated_in", "handoffs")}
                           for r in t["resize_log"]],
               "drain_stats": next((n.get("drain_stats") for n in
                                    __import__("ray_tpu_torch").nodes()
                                    if n["node_id"] == rank1_node), None),
               "weights_received": trainer.weights_received,
               "workers": {e: [{k: w[k] for k in (
                   "rank", "first", "steps", "launches", "peak_gib",
                   "visible")} for w in ws] for e, ws in epochs.items()},
               "telemetry": {k: v for k, v in t.items()
                             if k != "resize_log"}}
        log("elastic gang: " + json.dumps(out))
        banned = daemons_banned(cluster)
        if any(banned.values()):
            raise AssertionError(f"elastic gang: daemons loaded {banned}")
        launches = {k: sum(w["launches"][k] for ws in epochs.values()
                           for w in ws) for k in FLASH_KERNELS}
    finally:
        procs = cluster_processes(cluster._node)
        t_down = time.perf_counter()
        del trainer
        cluster.shutdown()
    log("elastic gang shutdown: " + json.dumps(
        cluster_left("elastic gang", procs, free0, t_down)))
    return launches


# ---------------------------------------------------------------------------
# Phase 19: RL on the runtime (rollout actors, the LearnerGroup, the
# on-policy algorithms)
# ---------------------------------------------------------------------------

RL_ITERS, RL_GROUP_ITERS = 3, 2
RL_LOSS_KEYS = ("loss", "pi_loss", "pg_loss", "vf_loss", "entropy",
                "mean_loss", "mean_rho", "mean_ratio")


def timed_calls(obj, name: str) -> list:
    """Wraps obj.<name> (an instance attribute over the class's method)
    so that each call's seconds, the card synchronised after it, are
    kept in the returned list."""
    real, times = getattr(obj, name), []

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, call)
    return times


def rl_finite(what: str, result: dict) -> None:
    bad = {k: result[k] for k in RL_LOSS_KEYS
           if k in result and not math.isfinite(result[k])}
    if bad or not any(k in result for k in RL_LOSS_KEYS):
        raise AssertionError(f"rl {what}: loss terms {bad or 'missing'} in "
                             f"{result}")


def rl_worker_states(rt, workers) -> list:
    """Each rollout worker's process state; fails on a CUDA context or
    a banned package."""
    states = rt.get([w.process_state.remote() for w in workers], timeout=60)
    for st in states:
        banned = sorted(set(st["packages"]) & set(RUNTIME_BANNED))
        if st["cuda_initialized"] or banned:
            raise AssertionError(f"rl: a rollout worker has CUDA "
                                 f"{st['cuda_initialized']}, loaded {banned}")
    return [{"cuda_initialized": st["cuda_initialized"],
             "threads": st["threads"]} for st in states]


def rl_row(what: str, results: list, iter_s: float, learn: list,
           updates: int | None = None, comm: list | None = None) -> dict:
    """An algorithm's figures: learn seconds (the learner's timed calls,
    else the results' own), sample seconds (the results' own, else the
    rest of the iterations' time), samples/s and updates/s; for a
    LearnerGroup its gradient mean's ms and bytes an update."""
    # IMPALA and APPO report timesteps_total only; they run one iteration.
    steps = sum(r.get("timesteps_this_iter", r.get("timesteps_total", 0))
                for r in results)
    learn_s = sum(learn) if learn else \
        sum(r["learn_time_s"] for r in results)
    sample_s = sum(r["sample_time_s"] for r in results) \
        if all("sample_time_s" in r for r in results) else iter_s - learn_s
    updates = len(learn) if updates is None else updates
    row = {"algo": what, "iterations": len(results), "samples": steps,
           "sample_time_s": sample_s, "learn_time_s": learn_s,
           "samples_per_s": steps / sample_s if sample_s > 0 else None,
           "updates": updates,
           "updates_per_s": updates / learn_s if learn_s > 0 else None,
           "last": {k: results[-1][k] for k in RL_LOSS_KEYS
                    if k in results[-1]}}
    if len(results) > 1:    # the first iteration warms the card's libraries
        row["per_iteration"] = [
            {k: r.get(k) for k in ("sample_time_s", "learn_time_s")}
            for r in results]
    if learn:
        row["update_ms_median"] = 1e3 * statistics.median(learn)
    if comm:
        n = max(c["updates"] for c in comm)
        row.update(grad_mean_ms_per_update=max(
            1e3 * c["allreduce_s"] / max(1, c["updates"]) for c in comm),
            grad_mean_bytes_per_update=comm[0]["allreduce_bytes"] // max(1, n))
    log(f"rl {what}: " + json.dumps(row))
    return row


def rl_ppo_driver(rt, card: str) -> dict:
    """(a) PPO at RLlib's Atari config (atari_cnn, hidden 256, on
    VisualCatch-v0, PPOConfig's defaults), the learner in the driver on
    the card, RL_ITERS iterations; the first iteration's 24 updates run
    again on the CPU from the same batch and params, held as phase 14
    holds them."""
    cfg = PPOConfig(env="VisualCatch-v0", model="atari_cnn")
    algo = cfg.build()
    first = {}
    try:
        learner = algo.learner
        first["params"] = learner.get_params()
        real = learner.learn

        def learn(batch, iteration):
            if "batch" in first:
                return real(batch, iteration)
            first["batch"] = {k: np.array(v) for k, v in batch.items()}
            first["rec"] = record_updates(learner)
            out = real(batch, iteration)
            del learner.update          # the class's update again
            first["after"] = learner.get_params()
            return out

        learner.learn = learn
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RL_ITERS)]
        iter_s = time.perf_counter() - t0
        workers = rl_worker_states(rt, algo.workers)
    finally:
        algo.stop()
    for r in results:
        rl_finite("ppo", r)
    cpu = PPOLearner(cfg, algo.obs_size, algo.num_actions,
                     params=first["params"], device="cpu")
    rec_cpu = record_updates(cpu)
    cpu.learn(first["batch"], 0)
    held = hold_ppo_updates(card, "atari_cnn", algo.obs_size, cfg,
                            first["after"], first["rec"], cpu.get_params(),
                            rec_cpu)
    log("rl ppo first iteration, card against CPU: " + json.dumps(held))
    row = rl_row("ppo", results, iter_s, [],
                 updates=RL_ITERS * cfg.num_sgd_iter * -(
                     -cfg.train_batch_size // cfg.sgd_minibatch_size))
    row.update(rollout_workers=workers, results=results)
    return row


def mean_grad_step(cfg, obs_in, n_act, params: dict, shards: list) -> dict:
    """The LearnerGroup's first step computed on the CPU: each shard's
    PPO gradient from `params`, their f32 mean (sum, then / n), one Adam
    step."""
    from ray_tpu_torch.rllib.ppo import sorted_items

    learner = PPOLearner(cfg, obs_in, n_act, params=params, device="cpu")
    order = [t for _, t in sorted_items(learner.params)]
    total = None
    for s in shards:
        learner.optimizer.zero_grad(set_to_none=True)
        loss, _ = learner._loss_fn(learner.params, learner._batch(s))
        loss.backward()
        flat = torch.cat([t.grad.reshape(-1) for t in order])
        total = flat if total is None else total + flat
    mean = total / len(shards)
    off = 0
    for t in order:
        t.grad = mean[off:off + t.numel()].view_as(t)
        off += t.numel()
    learner.optimizer.step()
    return learner.get_params(), {f"{'/'.join(p)}": t.grad.numpy()
                                  for p, t in sorted_items(learner.params)}


def hold_first_group_step(cfg, got: dict, want: dict, grads: dict) -> dict:
    """The group's params after its first step against the CPU's mean-
    gradient step: within 1e-4, but at first-step ties (a mean gradient
    under Adam's eps and not 0, which Adam's first step moves by up to lr
    either way), at most 1% of a parameter's elements, held to 2 lr. A
    gradient that is exactly 0 (a pixel that is 0 in every frame under a
    weight) moves nothing on either side and is held to 1e-4."""
    err, ties, faults = 0.0, 0, []
    for k, sub in want.items():
        for kk, w in sub.items():
            g = got[k][kk]
            gr = grads[f"{k}/{kk}"]
            tie = (gr != 0) & (np.abs(gr) < 1e-8)
            off = np.abs(g - w) > 1e-4 * (1 + np.abs(w))
            ties += int(tie.sum())
            if (off & ~tie).any() or tie.sum() > max(1, tie.size // 100) or \
                    (np.abs(g - w)[tie] > 2 * cfg.lr + 1e-4).any():
                faults.append(f"{k}/{kk}: {int((off & ~tie).sum())} off, "
                              f"{int(tie.sum())} ties")
            err = max(err, float(np.abs(g - w)[~tie].max(initial=0.0)))
    if faults:
        raise AssertionError(f"rl ppo group: first step against the CPU's "
                             f"mean-gradient step: {faults}")
    return {"first_step_param_err": err, "first_step_ties": ties}


def rl_ppo_group(rt) -> dict:
    """(b) the same config with num_learners=2: two learners on half the
    card each over gloo, RL_GROUP_ITERS iterations; the fingerprints
    equal after every update; the first update_shards against the
    mean-gradient step computed on the CPU from the same shards."""
    cfg = PPOConfig(env="VisualCatch-v0", model="atari_cnn", num_learners=2)
    algo = cfg.build()
    first, unequal, checked = {}, [], [0]
    try:
        group = algo._learner_group
        if (group.backend, group.num_gpus) != ("gloo", 0.5):
            raise AssertionError(f"rl ppo group: {group.backend} with "
                                 f"{group.num_gpus} of a card a learner")
        first["params"] = group.get_params()
        learn = timed_calls(group, "update_shards")
        real = group.update_shards

        def update_shards(shards):
            out = real(shards)
            if "after" not in first:
                first["shards"] = shards
                first["after"] = group.get_params()
            fps = group.fingerprints()
            checked[0] += 1
            if len(set(fps)) != 1:
                unequal.append((checked[0], fps))
            return out

        group.update_shards = update_shards
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RL_GROUP_ITERS)]
        iter_s = time.perf_counter() - t0
        comm = group.comm_stats()
    finally:
        algo.stop()
    for r in results:
        rl_finite("ppo group", r)
    if unequal or checked[0] != len(learn):
        raise AssertionError(f"rl ppo group: fingerprints differ after "
                             f"updates {unequal}")
    want, grads = mean_grad_step(cfg, algo.obs_size, algo.num_actions,
                                 first["params"], first["shards"])
    held = hold_first_group_step(cfg, first["after"], want, grads)
    row = rl_row("ppo_group", results, iter_s, learn, comm=comm)
    row.update(fingerprints_checked=checked[0], **held)
    return row


def rl_algorithms(rt) -> list:
    """(c) one iteration each at the configs' defaults on CartPole, the
    learners on the card: IMPALA with num_learners=2, APPO, PG, A2C,
    A3C; then one ES and one ARS iteration (numpy on CPU actors)."""
    from ray_tpu_torch.rllib import (A2CConfig, A3CConfig, APPOConfig,
                                     ARSConfig, ESConfig, ImpalaConfig,
                                     PGConfig)

    rows = []
    for name, cfg in (("impala_group", ImpalaConfig(num_learners=2)),
                      ("appo", APPOConfig()), ("pg", PGConfig()),
                      ("a2c", A2CConfig()), ("a3c", A3CConfig()),
                      ("es", ESConfig()), ("ars", ARSConfig())):
        algo = cfg.build()
        comm = None
        try:
            group = getattr(algo, "_learner_group", None)
            learner = getattr(algo, "learner", None)
            learn = timed_calls(group, "update_shards") if group else \
                timed_calls(learner, "update") if learner else []
            t0 = time.perf_counter()
            result = algo.train()
            iter_s = time.perf_counter() - t0
            if group:
                comm = group.comm_stats()
        finally:
            algo.stop()
        if name in ("es", "ars"):
            if not math.isfinite(result["episode_reward_mean"]):
                raise AssertionError(f"rl {name}: {result}")
            row = {"algo": name, "evaluations": 2 * cfg.population,
                   "samples": result["timesteps_this_iter"],
                   "iter_s": iter_s,
                   "samples_per_s": result["timesteps_this_iter"] / iter_s,
                   "episode_reward_mean": result["episode_reward_mean"]}
            log(f"rl {name}: " + json.dumps(row))
            rows.append(row)
            continue
        rl_finite(name, result)
        rows.append(rl_row(name, [result], iter_s, learn, comm=comm))
    return rows


def rl_runtime_phase(card: str) -> dict:
    """Phase 19. RLlib's on-policy algorithms on the port's runtime with
    its defaults: (a) PPO at RLlib's Atari config, the learner in the
    driver; (b) the same on a 2-learner LearnerGroup; (c) IMPALA, APPO,
    PG, A2C, A3C, ES and ARS. No kernel lies on this path (MLPs and a
    CNN): this process's kernel counts over the phase are returned (0).
    After the shutdown no process of the phase's cluster is left."""
    import ray_tpu_torch as rt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    if banned_loaded():
        raise AssertionError(f"rl: the driver loaded {banned_loaded()}")
    t0 = time.perf_counter()
    rt.init()
    try:
        init_s = time.perf_counter() - t0
        ppo = rl_ppo_driver(rt, card)
        group = rl_ppo_group(rt)
        others = rl_algorithms(rt)
        if banned_loaded():
            raise AssertionError(f"rl: the driver loaded {banned_loaded()}")
    finally:
        procs = cluster_processes(rt._runtime_node)
        t_down = time.perf_counter()
        rt.shutdown()
    deadline = time.time() + 60
    while still_running(procs) and time.time() < deadline:
        time.sleep(0.05)
    if still_running(procs):
        raise AssertionError(f"rl: processes left after shutdown: "
                             f"{still_running(procs)}")
    log("rl runtime: " + json.dumps({
        "card": card, "init_s": init_s, "cluster_processes": len(procs),
        "shutdown_s": time.perf_counter() - t_down,
        "algorithms": [r["algo"] for r in [ppo, group, *others]]}))
    return {**dict(pa.launch_counts), **dict(fa.launch_counts)}


# ---------------------------------------------------------------------------
# Phase 20: off-policy RL on the runtime (replay, the Q-learning family,
# the actor-critics, MADDPG, SlateQ, AlphaZero) and the offline CQL and CRR
# ---------------------------------------------------------------------------

OFFPOLICY_MAX_ITERS = 6     # iterations allowed to reach one with updates


def to_host(x):
    """A copy of an update's argument on the host: tensors to the CPU,
    arrays copied, dicts, lists and tuples rebuilt."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def output_tensors(out) -> list:
    """The tensors an update returned (its losses, and Ape-X's and
    Rainbow's new priorities), in a fixed order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in output_tensors(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in output_tensors(v)]
    return []


def learner_trees(learner) -> dict:
    """A learner's state trees: params, and where it has them the target,
    CRR's critic and its target, SAC's log_alpha, DreamerV3's slow critic
    and return scale."""
    trees = {k: getattr(learner, k) for k in
             ("params", "target", "q_params", "q_target", "slow_critic")
             if hasattr(learner, k)}
    for k in ("log_alpha", "ret_scale"):
        if isinstance(getattr(learner, k, None), torch.Tensor):
            trees[k] = {k: getattr(learner, k)}
    return trees


def record_first_updates(learner) -> dict:
    """Wraps learner.update: every call timed (the card synchronised after
    it); the calls of the first train() that updates recorded (their
    arguments and outputs on the host) with the state trees from before
    them, for the CPU to run again."""
    from ray_tpu_torch.rllib.utils import tree_numpy

    rec = {"times": [], "calls": [], "outs": [], "state": None,
           "recording": False}
    real = learner.update

    def update(*args, **kwargs):
        if rec["recording"] and rec["state"] is None:
            rec["state"] = {k: tree_numpy(t)
                            for k, t in learner_trees(learner).items()}
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        rec["times"].append(time.perf_counter() - t0)
        if rec["recording"]:
            rec["calls"].append((to_host(args), to_host(kwargs)))
            rec["outs"].append([t.detach().cpu()
                                for t in output_tensors(out)])
        return out

    learner.update = update
    return rec


def cpu_twin(name: str, algo):
    """A learner of the same class and config as `algo`'s, on the CPU."""
    lr, cfg = getattr(algo, "learner", algo), algo.config
    if name in ("cql", "crr", "dt", "qmix", "dreamerv3"):
        return type(algo)(cfg, device="cpu")
    if name == "alphazero":
        return type(lr)(cfg, device="cpu")
    if name == "slateq":
        return type(lr)(cfg, algo.env.docs, algo.env.slate_size,
                        algo.env.no_click_mass, device="cpu")
    if name == "maddpg":
        return type(lr)(cfg, algo.n_agents, algo.obs_size, algo.act_size,
                        device="cpu")
    if name in ("td3", "ddpg", "sac"):
        return type(lr)(cfg, algo.obs_size, algo.act_size, device="cpu")
    # DQN, SimpleQ, Ape-X, Rainbow, R2D2.
    return type(lr)(cfg, algo.obs_size, algo.num_actions, device="cpu")


def hold_offpolicy_updates(name: str, algo, rec: dict,
                           rounding: dict | None = None) -> dict:
    """The first updating iteration's updates run again on the CPU from
    the same state trees, batches and noise: every output within 2e-5;
    every state tensor after them within 1e-4 but at ties (phase 14's
    rule: at most 1% of a tensor's elements, held to 2 lr an update).
    `rounding` ({(tree, *path): index}) names entries whose gradient is 0
    but for rounding, which Adam turns into steps of up to about lr that
    differ between devices: held to 2 lr an update, not counted as
    ties."""
    from ray_tpu_torch.rllib.ppo import load_tree, sorted_items

    cfg = algo.config
    twin = cpu_twin(name, algo)
    trees = learner_trees(twin)
    for k, values in rec["state"].items():
        load_tree(trees[k], values)
    outs = [[t.detach().cpu() for t in output_tensors(twin.update(*a, **kw))]
            for a, kw in rec["calls"]]
    try:
        loss_err = max(max_err(g, w, 2e-5) for got, want in
                       zip(rec["outs"], outs) for g, w in zip(got, want))
    except AssertionError as e:
        raise AssertionError(f"offpolicy {name}: an update's output on the "
                             f"card against the CPU: {e}") from None
    lr = max(getattr(cfg, k) for k in ("lr", "actor_lr", "critic_lr",
                                       "model_lr") if hasattr(cfg, k))
    card_trees = learner_trees(getattr(algo, "learner", algo))
    updates = len(outs)
    err, ties, faults = 0.0, 0, []
    for k, tree in trees.items():
        for (path, w), (_p, g) in zip(sorted_items(tree),
                                      sorted_items(card_trees[k])):
            w, g = w.detach().numpy(), g.detach().cpu().numpy()
            diff = np.abs(g - w)
            noise = (rounding or {}).get((k, *path))
            if noise is not None:
                if diff[noise].max() > 2 * lr * updates:
                    faults.append(f"{k}/{'/'.join(map(str, path))}: a "
                                  f"rounding-noise entry {diff[noise].max()}"
                                  f" off")
                diff[noise] = 0.0
            off = diff > 1e-4 * (1 + np.abs(w))
            ties += int(off.sum())
            if off.sum() > max(1, off.size // 100) or \
                    diff[off].max(initial=0.0) > 2 * lr * updates:
                faults.append(f"{k}/{'/'.join(map(str, path))}: "
                              f"{int(off.sum())} of {off.size} off")
            err = max(err, float(diff[~off].max(initial=0.0)))
    row = {"updates_replayed": updates, "output_err": loss_err,
           "state_err": err, "ties": ties}
    if faults:
        raise AssertionError(f"offpolicy {name}: card against CPU: "
                             f"{faults}; {row}")
    return row


def offpolicy_run(rt, name: str, cfg) -> dict:
    """An algorithm at its config's defaults, its learner on the card:
    train() until an iteration updates (at most OFFPOLICY_MAX_ITERS),
    that iteration's updates recorded and run again on the CPU. Returns
    its row: iterations, samples and the seconds of sampling (an
    iteration's time less its updates'), updates and their seconds, the
    drift, the actors' process state."""
    algo = cfg.build()
    try:
        learner = getattr(algo, "learner", algo)
        rec = record_first_updates(learner)
        results, iter_s, samples = [], [], 0
        for _ in range(OFFPOLICY_MAX_ITERS):
            seen = len(rec["times"])
            rec["recording"] = rec["state"] is None
            before = getattr(algo, "total_steps", getattr(algo, "size", 0))
            t0 = time.perf_counter()
            results.append(algo.train())
            iter_s.append(time.perf_counter() - t0)
            samples += getattr(algo, "total_steps",
                               getattr(algo, "size", 0)) - before
            rec["recording"] = False
            if len(rec["times"]) > seen:
                break
        workers = rl_worker_states(rt, algo.workers) \
            if getattr(algo, "workers", None) else []
    finally:
        algo.stop()
    if not rec["calls"]:
        raise AssertionError(f"offpolicy {name}: no update in "
                             f"{len(results)} iterations: {results[-1]}")
    for r in results:
        bad = {k: v for k, v in r.items() if isinstance(v, float)
               and "loss" in k and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"offpolicy {name}: {bad} in {r}")
    for out in rec["outs"]:
        if not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"offpolicy {name}: an update's output "
                                 f"is not finite")
    held = hold_offpolicy_updates(name, algo, rec)
    learn_s = sum(rec["times"])
    sample_s = sum(iter_s) - learn_s
    row = {"algo": name, "iterations": len(results), "samples": samples,
           "sample_time_s": sample_s,
           "samples_per_s": samples / sample_s if sample_s > 0 and samples
           else None,
           "updates": len(rec["times"]), "learn_time_s": learn_s,
           "updates_per_s": len(rec["times"]) / learn_s,
           "update_ms_median": 1e3 * statistics.median(rec["times"]),
           "iteration_s": iter_s, **held, "rollout_workers": workers,
           "last": {k: v for k, v in results[-1].items()
                    if "loss" in k or k in ("alpha", "entropy")}}
    log(f"offpolicy {name}: " + json.dumps(row))
    return row


def offpolicy_phase(card: str) -> dict:
    """Phase 20. RLlib's off-policy algorithms on the port's runtime with
    its defaults, each at its config's defaults with its learner on the
    card: DQN, SimpleQ, Ape-X, Rainbow and R2D2 on CartPole, TD3, DDPG and
    SAC on Pendulum, MADDPG on CoopNav, SlateQ on SlateDocEnv, AlphaZero
    on TicTacToe; then CQL and CRR on 30 CartPole episodes written by
    write_offline_json. No kernel lies on this path: this process's
    kernel counts over the phase are returned (0). After the shutdown no
    process of the phase's cluster is left."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import (AlphaZeroConfig, ApexDQNConfig,
                                     CQLConfig, CRRConfig, DDPGConfig,
                                     DQNConfig, MADDPGConfig, R2D2Config,
                                     RainbowConfig, SACConfig, SimpleQConfig,
                                     SlateQConfig, TD3Config)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    if banned_loaded():
        raise AssertionError(f"offpolicy: the driver loaded "
                             f"{banned_loaded()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_offpolicy_")
    t0 = time.perf_counter()
    rt.init()
    try:
        init_s = time.perf_counter() - t0
        rows = [offpolicy_run(rt, name, cfg) for name, cfg in (
            ("dqn", DQNConfig()), ("simple_q", SimpleQConfig()),
            ("apex", ApexDQNConfig()), ("rainbow", RainbowConfig()),
            ("r2d2", R2D2Config()), ("td3", TD3Config()),
            ("ddpg", DDPGConfig()), ("sac", SACConfig()),
            ("maddpg", MADDPGConfig()), ("slateq", SlateQConfig()),
            ("alphazero", AlphaZeroConfig()))]
        path = os.path.join(root, "cartpole.jsonl")
        expert_data(path)
        rows += [offpolicy_run(rt, "cql", CQLConfig(input_path=path)),
                 offpolicy_run(rt, "crr", CRRConfig(input_path=path))]
        if banned_loaded():
            raise AssertionError(f"offpolicy: the driver loaded "
                                 f"{banned_loaded()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        procs = cluster_processes(rt._runtime_node)
        t_down = time.perf_counter()
        rt.shutdown()
    deadline = time.time() + 60
    while still_running(procs) and time.time() < deadline:
        time.sleep(0.05)
    if still_running(procs):
        raise AssertionError(f"offpolicy: processes left after shutdown: "
                             f"{still_running(procs)}")
    log("offpolicy runtime: " + json.dumps({
        "card": card, "init_s": init_s, "cluster_processes": len(procs),
        "shutdown_s": time.perf_counter() - t_down,
        "algorithms": [r["algo"] for r in rows]}))
    return {**dict(pa.launch_counts), **dict(fa.launch_counts)}


# ---------------------------------------------------------------------------
# Phase 21: the last learners (DT, QMIX with CoopSwitch, DreamerV3) and
# Tune, its trials on GPU leases
# ---------------------------------------------------------------------------

LAST_ITERS = 2              # train() calls of each learner
TUNE_TRIALS, TUNE_ITERS = 4, 4
PBT_ITERS = 6


def dt_rounding(cfg) -> dict:
    """DT's entries whose gradient is 0 but for rounding: a block's key
    bias adds a constant to each query's scores, which the softmax takes
    out."""
    E = cfg.embed_dim
    return {("params", f"blk{i}", "qkv", "b"): slice(E, 2 * E)
            for i in range(cfg.n_layers)}


def last_learner_run(name: str, algo, steps_key: str | None,
                     rounding: dict | None = None) -> dict:
    """LAST_ITERS train() calls of a learner at its config's defaults on
    the card; after the first that updates, its updates run again on the
    CPU as phase 20 holds them. Returns its row: updates/s and the median
    ms of an update, env steps/s where it acts (the iterations' time less
    their updates'), the drift."""
    rec = record_first_updates(algo)
    results, iter_s, held = [], [], None
    for _ in range(LAST_ITERS):
        rec["recording"] = rec["state"] is None
        t0 = time.perf_counter()
        results.append(algo.train())
        iter_s.append(time.perf_counter() - t0)
        rec["recording"] = False
        if held is None and rec["calls"]:
            held = hold_offpolicy_updates(name, algo, rec, rounding)
    if held is None:
        raise AssertionError(f"last {name}: no update in {LAST_ITERS} "
                             f"iterations: {results}")
    for r in results:
        bad = {k: v for k, v in r.items() if isinstance(v, float)
               and "loss" in k and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"last {name}: {bad} in {r}")
    learn_s = sum(rec["times"])
    row = {"algo": name, "iterations": len(results),
           "updates": len(rec["times"]), "learn_time_s": learn_s,
           "updates_per_s": len(rec["times"]) / learn_s,
           "update_ms_median": 1e3 * statistics.median(rec["times"]),
           "iteration_s": iter_s, **held,
           "last": {k: v for k, v in results[-1].items()
                    if "loss" in k or k in ("entropy", "imag_return",
                                            "episode_reward_mean")}}
    if steps_key is not None:
        steps = results[-1][steps_key]
        act_s = sum(iter_s) - learn_s
        row.update(env_steps=steps, act_time_s=act_s,
                   env_steps_per_s=steps / act_s)
    log(f"last {name}: " + json.dumps(row))
    return row


def dt_trial(config):
    """A Tune trial: DT on the card leased to it (a share of the one
    card), from a checkpoint where PBT gave one. Reports the loss, the
    card, its process's banned packages and the seconds since it
    started."""
    import os
    import time

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.rllib import DTConfig
    from ray_tpu_torch.rllib.ppo import sorted_items
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint

    t0 = time.perf_counter()
    started = time.time()
    torch.set_num_threads(1)    # the one CPU the trial's lease holds
    torch.backends.cuda.matmul.allow_tf32 = False
    card = ray_tpu_torch.get_runtime_context().get_accelerator_ids()["GPU"]
    algo = DTConfig(input_path=config["path"], lr=config["lr"]).build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    restored = None
    if config.get("_checkpoint_path"):
        state = torch.load(os.path.join(config["_checkpoint_path"],
                                        "dt.pt"), map_location=algo.device)
        with torch.no_grad():
            for (_, t), (_, v) in zip(sorted_items(algo.params),
                                      sorted_items(state["params"])):
                t.copy_(v)
        algo.optimizer.load_state_dict(state["optimizer"])
        algo.iteration = state["iteration"]
        restored = state["writer"]
    for i in range(config["iters"]):
        r = algo.train()
        ckpt = None
        if config.get("checkpoint_root"):
            d = os.path.join(config["checkpoint_root"],
                             f"{os.getpid()}_{i}")
            os.makedirs(d, exist_ok=True)
            torch.save({"params": algo.params,
                        "optimizer": algo.optimizer.state_dict(),
                        "iteration": algo.iteration,
                        "writer": os.getpid()}, os.path.join(d, "dt.pt"))
            ckpt = Checkpoint(d)
        banned = sorted({m.split(".")[0] for m in sys.modules}
                        & set(config["banned"]))
        session.report({"loss": r["loss"], "card": card,
                        "visible": os.environ["CUDA_VISIBLE_DEVICES"],
                        "pid": os.getpid(), "restored_from": restored,
                        "banned": banned, "lr": config["lr"],
                        "started": started, "build_s": build_s,
                        "s": time.perf_counter() - t0}, checkpoint=ckpt)


def helper_state():
    """A helper actor's process: its top-level packages and whether CUDA
    is initialised."""
    import sys

    import torch

    return {"packages": sorted({m.split(".")[0] for m in sys.modules}),
            "cuda_initialized": torch.cuda.is_initialized()}


def trial_rows(grid, fit_t0: float) -> list:
    """A trial's figures: its reports and last loss, the cards it leased,
    its first process's seconds from fit() to the trainable's start,
    from there to the learner built on the card (the CUDA context made)
    and to the first report, and its last process's seconds to its last
    report."""
    rows = []
    for r in grid:
        h = r.metrics_history
        rows.append({"lr": r.config["lr"], "reports": len(h),
                     "error": r.error, "loss": h[-1]["loss"] if h else None,
                     "cards": sorted({c for m in h for c in m["card"]}),
                     "start_after_fit_s": h[0]["started"] - fit_t0
                     if h else None,
                     "build_s": h[0]["build_s"] if h else None,
                     "first_report_s": h[0]["s"] if h else None,
                     "last_report_s": h[-1]["s"] if h else None})
    return rows


def check_trials(what: str, grid, fit_t0: float) -> list:
    """Every trial finished without error, each report from a process
    whose lease and CUDA_VISIBLE_DEVICES name the one card, every loss
    finite, no banned package loaded."""
    rows = trial_rows(grid, fit_t0)
    for r in grid:
        h = r.metrics_history
        if r.error or not h:
            raise AssertionError(f"{what}: a trial failed: {r.error}")
        bad = [m for m in h if len(m["card"]) != 1
               or m["card"] != [m["visible"]]
               or not math.isfinite(m["loss"]) or m["banned"]]
        if bad:
            raise AssertionError(f"{what}: trial reports {bad[:2]}")
    cards = {c for row in rows for c in row["cards"]}
    if len(cards) != 1:
        raise AssertionError(f"{what}: trials leased cards {cards}")
    return rows


def tune_asha(rt, path: str) -> dict:
    """TUNE_TRIALS DT trials at {"CPU": 1, "GPU": 0.25} under ASHA (loss,
    min): every trial reports the card it leased, at least one is stopped
    early, the best result is a finished trial."""
    from ray_tpu_torch import tune

    sched = tune.ASHAScheduler(metric="loss", mode="min",
                               max_t=TUNE_ITERS, grace_period=1,
                               reduction_factor=2)
    t0, fit_t0 = time.perf_counter(), time.time()
    grid = tune.Tuner(
        dt_trial,
        param_space={"lr": tune.grid_search([3e-3, 1e-3, 3e-4, 1e-4]),
                     "path": path, "iters": TUNE_ITERS,
                     "banned": list(RUNTIME_BANNED)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=TUNE_TRIALS),
        resources_per_trial={"CPU": 1, "GPU": 0.25}).fit()
    fit_s = time.perf_counter() - t0
    rows = check_trials("tune", grid, fit_t0)
    stopped = [row for row in rows if row["reports"] < TUNE_ITERS]
    if not stopped:
        raise AssertionError(f"tune: ASHA stopped no trial: {rows}")
    best = grid.get_best_result()
    if best.error is not None or not best.metrics_history:
        raise AssertionError(f"tune: the best result is not a finished "
                             f"trial: {best.error}")
    if max(row["reports"] for row in rows) != TUNE_ITERS:
        raise AssertionError(f"tune: no trial ran its {TUNE_ITERS} "
                             f"iterations: {rows}")
    out = {"fit_s": fit_s, "trials": rows, "stopped_early": len(stopped),
           "best": {"lr": best.config["lr"], "loss": best.metrics["loss"],
                    "reports": len(best.metrics_history)}}
    log("last tune asha: " + json.dumps(out))
    return out


def tune_pbt(rt, path: str, root: str) -> dict:
    """Two DT trials under PopulationBasedTraining, checkpointing with
    torch.save each iteration: at least one exploit restarts a trial from
    the other trial's checkpoint, written by a process that PBT's stop
    of it did not take with it."""
    from ray_tpu_torch import tune

    sched = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": [3e-3, 1e-3, 3e-4, 1e-4]},
        quantile_fraction=0.5, seed=0)
    t0, fit_t0 = time.perf_counter(), time.time()
    grid = tune.Tuner(
        dt_trial,
        param_space={"lr": tune.grid_search([3e-3, 1e-5]), "path": path,
                     "iters": PBT_ITERS, "checkpoint_root": root,
                     "banned": list(RUNTIME_BANNED)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=2),
        resources_per_trial={"CPU": 1, "GPU": 0.25}).fit()
    fit_s = time.perf_counter() - t0
    rows = check_trials("pbt", grid, fit_t0)
    pids = [{m["pid"] for m in r.metrics_history} for r in grid]
    exploits = [{"trial": i, "from_pid": m["restored_from"]}
                for i, r in enumerate(grid) for m in r.metrics_history
                if m["restored_from"] is not None]
    across = [e for e in exploits
              if any(e["from_pid"] in p for j, p in enumerate(pids)
                     if j != e["trial"])]
    if not across:
        raise AssertionError(f"pbt: no exploit restored from the other "
                             f"trial's checkpoint: {exploits}; {rows}")
    out = {"fit_s": fit_s, "trials": rows, "exploit_reports": len(exploits),
           "restored_across": len({(e["trial"], e["from_pid"])
                                   for e in across})}
    log("last tune pbt: " + json.dumps(out))
    return out


def helper_actors(rt) -> dict:
    """A Pool worker and a Queue round trip on the phase's cluster: the
    Pool's process has no CUDA context and no banned package."""
    from ray_tpu_torch.util.multiprocessing import Pool
    from ray_tpu_torch.util.queue import Queue

    with Pool(processes=1) as p:
        st = p.apply(helper_state)
    banned = sorted(set(st["packages"]) & set(RUNTIME_BANNED))
    if st["cuda_initialized"] or banned:
        raise AssertionError(f"last: a Pool worker has CUDA "
                             f"{st['cuda_initialized']}, loaded {banned}")
    q = Queue(maxsize=2)
    q.put("x")
    got = q.get(timeout=30)
    q.shutdown()
    if got != "x":
        raise AssertionError(f"last: the Queue gave {got!r}")
    return {"pool_cuda_initialized": st["cuda_initialized"]}


def last_learners_phase(card: str) -> dict:
    """Phase 21. DT (on phase 14's 30 CartPole episodes written by
    write_offline_json, then evaluate(episodes=2)), QMIX on CoopSwitch
    and DreamerV3 on CartPole, each at its config's defaults, built with
    the learner on the card, LAST_ITERS iterations, the first update held
    against the CPU; then on ray_tpu_torch.init()'s defaults Tune: DT
    trials on quarter-card leases under ASHA, then under PBT with
    torch.save checkpoints; a Pool worker and a Queue before them. No
    kernel lies on this path: this process's kernel counts over the phase
    are returned (0). After the shutdown no process of the phase's
    cluster is left."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import DreamerV3Config, DTConfig, QMIXConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    if banned_loaded():
        raise AssertionError(f"last: the driver loaded {banned_loaded()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_last_")
    try:
        path = os.path.join(root, "cartpole.jsonl")
        expert_data(path)
        dt_cfg = DTConfig(input_path=path)
        dt = dt_cfg.build()
        rows = [last_learner_run("dt", dt, None, dt_rounding(dt_cfg))]
        t0 = time.perf_counter()
        ev = dt.evaluate(episodes=2)
        ev_s = time.perf_counter() - t0
        if not math.isfinite(ev["episode_reward_mean"]):
            raise AssertionError(f"last dt: evaluate gave {ev}")
        log("last dt evaluate: " + json.dumps({**ev, "seconds": ev_s}))
        rows.append(last_learner_run("qmix", QMIXConfig().build(),
                                     "timesteps_total"))
        rows.append(last_learner_run("dreamerv3", DreamerV3Config().build(),
                                     "timesteps_total"))
        t0 = time.perf_counter()
        rt.init()
        try:
            init_s = time.perf_counter() - t0
            # The helpers first: their actors also warm the cluster's
            # zygote, so the fits below time Tune's own trial starts.
            t0 = time.perf_counter()
            helpers = helper_actors(rt)
            helpers["helpers_s"] = time.perf_counter() - t0
            asha = tune_asha(rt, path)
            pbt = tune_pbt(rt, path, os.path.join(root, "pbt"))
            if banned_loaded():
                raise AssertionError(f"last: the driver loaded "
                                     f"{banned_loaded()}")
        finally:
            procs = cluster_processes(rt._runtime_node)
            t_down = time.perf_counter()
            rt.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    deadline = time.time() + 60
    while still_running(procs) and time.time() < deadline:
        time.sleep(0.05)
    if still_running(procs):
        raise AssertionError(f"last: processes left after shutdown: "
                             f"{still_running(procs)}")
    log("last runtime: " + json.dumps({
        "card": card, "init_s": init_s, "cluster_processes": len(procs),
        "shutdown_s": time.perf_counter() - t_down,
        "learners": [r["algo"] for r in rows],
        "asha_fit_s": asha["fit_s"], "pbt_fit_s": pbt["fit_s"],
        **helpers}))
    return {**dict(pa.launch_counts), **dict(fa.launch_counts)}


# Phase 22: the control path's rates, on the native planes and on the
# Python path (RAY_TPU_TORCH_NATIVE_CONTROL, the one switch). The lease
# waves: CONTROL_WAVES waves of CONTROL_WAVE_TASKS no-op tasks, each on
# a warm idle pool, on clusters that return an idle lease after
# CONTROL_KEEP_S (the default 2 s would make the waves 2 s apart).
CONTROL_SWITCH = "RAY_TPU_TORCH_NATIVE_CONTROL"
CONTROL_TASKS, CONTROL_CALLS, CONTROL_ACTORS = 2000, 2000, 100
CONTROL_WAVES, CONTROL_WAVE_TASKS, CONTROL_KEEP_S = 20, 4, 0.2


def control_plane_rates(native: bool) -> dict:
    """One fresh cluster (ray_tpu_torch.init()'s defaults but idle leases
    returned after CONTROL_KEEP_S) with the switch on or off: no-op
    tasks, calls on one actor and actor creations per second, after a
    warm-up of each, and the lease waves' ms. With the switch on each
    daemon reports an installed plane that handled frames, the raylet's
    granted leases in the waves, and nothing degraded; with it off
    neither has one. No process of the cluster is left after its
    shutdown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import Config

    saved = os.environ.get(CONTROL_SWITCH)
    os.environ[CONTROL_SWITCH] = "1" if native else "0"
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    try:
        t0 = time.perf_counter()
        rt.init(config=Config(idle_worker_keep_s=CONTROL_KEEP_S))
        init_s = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop(CONTROL_SWITCH, None)
        else:
            os.environ[CONTROL_SWITCH] = saved
    try:
        @rt.remote
        def noop():
            return None

        @rt.remote(num_cpus=0)
        class Sink:
            def call(self):
                return None

        rt.get([noop.remote() for _ in range(200)], timeout=300)
        t0 = time.perf_counter()
        rt.get([noop.remote() for _ in range(CONTROL_TASKS)], timeout=300)
        tasks_s = time.perf_counter() - t0
        leases0 = native_leases(native_control_stats("control plane")) \
            if native else 0
        waves, grants = lease_waves(rt, noop, CONTROL_WAVES,
                                    CONTROL_WAVE_TASKS)
        waves, grants = sorted(waves), sorted(grants)
        wave_leases = native_leases(native_control_stats(
            "control plane")) - leases0 if native else 0
        sink = Sink.remote()
        rt.get([sink.call.remote() for _ in range(100)], timeout=300)
        t0 = time.perf_counter()
        rt.get([sink.call.remote() for _ in range(CONTROL_CALLS)],
               timeout=300)
        calls_s = time.perf_counter() - t0
        warm = [Sink.remote() for _ in range(4)]
        rt.get([a.call.remote() for a in warm], timeout=300)
        t0 = time.perf_counter()
        actors = [Sink.remote() for _ in range(CONTROL_ACTORS)]
        rt.get([a.call.remote() for a in actors], timeout=300)
        actors_s = time.perf_counter() - t0
        for a in [sink, *warm, *actors]:
            rt.kill(a)
        from ray_tpu_torch._private.api_internal import get_core_worker

        cw = get_core_worker()
        gcs = cw._run(cw.gcs.call("GetClusterStatus", {}))["native_control"]
        raylet = cw._run(cw.raylet.call("GetState", {}))["native_control"]
    finally:
        procs = cluster_processes(rt._runtime_node)
        t_down = time.perf_counter()
        rt.shutdown()
    down = cluster_left("control plane", procs, free0, t_down)
    if native:
        if gcs is None or raylet is None:
            raise AssertionError(f"control plane: a plane is missing with "
                                 f"the switch on ({gcs}, {raylet})")
        hold_planes("control plane", {"gcs": gcs, "raylet": raylet})
        if wave_leases <= 0:
            raise AssertionError("control plane: the lease plane granted "
                                 "no lease in the waves")
        planes = {"gcs_handled": gcs["handled_total"],
                  "gcs_fallthrough": gcs["native_fallthrough_total"],
                  "raylet_handled": raylet["handled_total"],
                  "raylet_fallthrough": raylet["native_fallthrough_total"],
                  "native_leases": native_leases({"raylet": raylet}),
                  "wave_native_leases": wave_leases}
    else:
        if gcs is not None or raylet is not None:
            raise AssertionError("control plane: a native plane installed "
                                 "with the switch off")
        planes = {}
    return {"init_s": init_s, "tasks_per_s": CONTROL_TASKS / tasks_s,
            "actor_calls_per_s": CONTROL_CALLS / calls_s,
            "actor_creations_per_s": CONTROL_ACTORS / actors_s,
            "wave_ms_p50": waves[len(waves) // 2],
            "wave_ms_p90": waves[int(len(waves) * 0.9)],
            "wave_ms_min": waves[0],
            "grant_ms_p50": grants[len(grants) // 2] if grants else None,
            "grant_ms_p90": grants[int(len(grants) * 0.9)] if grants else None,
            "grants_timed": len(grants),
            **planes, "shutdown_s": down["shutdown_s"],
            "cluster_processes": down["cluster_processes"]}


def control_plane_phase(card: str) -> dict:
    """Phase 22: the control path's rates on two fresh clusters, the
    native planes (the default) and the Python path. No model; host
    numbers of the card's machine, logged beside the card. No kernel
    lies on this path: returns this process's kernel counts over the
    phase (0)."""
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    out = {"native": control_plane_rates(True),
           "python": control_plane_rates(False)}
    log("control plane: " + json.dumps({
        "card": card, "tasks": CONTROL_TASKS, "actor_calls": CONTROL_CALLS,
        "actor_creations": CONTROL_ACTORS, "lease_waves": CONTROL_WAVES,
        "wave_tasks": CONTROL_WAVE_TASKS, "keep_s": CONTROL_KEEP_S, **out}))
    return {**dict(pa.launch_counts), **dict(fa.launch_counts)}


def run_phase(name: str, fn, *args):
    """Runs one phase; logs its time and peak device memory, then frees
    what it left in the allocator's cache."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"{name}: {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    # The runtime's C++ (g++, one thread a library) beside the kernels'
    # nvcc builds; phase 15's init then starts daemons that find them.
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch._private import native_build

    with ThreadPoolExecutor(max_workers=1) as pool:
        runtime_build = pool.submit(native_build.build_all)
        _build.build_all()
        runtime_build.result()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(_build.build_log)

    rows = run_phase("kernels", kernel_phase, card)
    flash_rows = run_phase("flash", flash_kernel_phase, card)
    run_phase("parity", parity_phase)
    serve_params = serving_weights()
    serving_run = run_phase("serving", serving_phase, card, None,
                            serve_params)
    counts = serving_run["launches"]
    run_phase("serving modes", serving_modes_phase, card, serve_params)
    disagg_launches = run_phase("disaggregated prefill", disagg_phase, card,
                                serve_params)
    del serve_params
    runtime_launches, restart_launches = run_phase(
        "runtime serving", runtime_phase, card, serving_run)
    run_phase("train parity", train_parity_phase)
    flash_counts = run_phase("training", training_phase, card)
    sharded_counts = run_phase("sharded training", sharded_training_phase,
                               card)
    moe_sharded_counts = run_phase("moe parity", moe_parity_phase, card)
    moe_counts = run_phase("moe training", training_phase, card, None,
                           MOE_TRAIN_STEPS, MOE_TRAIN_CFG, moe_loss_fn(),
                           "moe training", moe.count_flops_per_token)
    dit_counts = run_phase("model families", families_phase, card)
    ckpt_counts = run_phase("checkpoint", checkpoint_phase, card)
    run_phase("rl learners", rl_phase, card)
    gang_counts = run_phase("gang training", gang_phase, card)
    disagg_serve_counts = run_phase("disaggregated serving",
                                    disagg_serving_phase, card)
    elastic_counts = run_phase("elastic gang", elastic_phase, card)
    rl_counts = run_phase("rl on the runtime", rl_runtime_phase, card)
    offpolicy_counts = run_phase("off-policy rl", offpolicy_phase, card)
    last_counts = run_phase("last learners and tune", last_learners_phase,
                            card)
    control_counts = run_phase("control plane", control_plane_phase, card)

    for name, row in rows.items():
        row["launches"] = counts[name]
        row["disagg_launches"] = disagg_launches[name]
        row["runtime_launches"] = runtime_launches[name]
        row["restart_launches"] = restart_launches[name]
        row["disagg_serve_launches"] = disagg_serve_counts[name]
        row["rl_launches"] = rl_counts[name]
        row["offpolicy_launches"] = offpolicy_counts[name]
        row["last_launches"] = last_counts[name]
        row["control_launches"] = control_counts[name]
    for name, row in flash_rows.items():
        row["launches"] = flash_counts[name]
        row["sharded_launches"] = sharded_counts[name]
        row["moe_launches"] = moe_counts[name]
        row["moe_sharded_launches"] = moe_sharded_counts[name]
        row["dit_launches"] = dit_counts["dit"][name]
        row["dit_sample_launches"] = dit_counts["dit_sample"][name]
        row["checkpoint_launches"] = ckpt_counts[name]
        row["gang_launches"] = gang_counts[name]
        row["elastic_launches"] = elastic_counts[name]
        row["rl_launches"] = rl_counts[name]
        row["offpolicy_launches"] = offpolicy_counts[name]
        row["last_launches"] = last_counts[name]
        row["control_launches"] = control_counts[name]
    print(json.dumps({"kernels": [rows[n] for n in KERNELS]
                      + [flash_rows[n] for n in FLASH_KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
