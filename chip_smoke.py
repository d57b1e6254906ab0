#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the paper's FMM configuration
(vortex steps, the sharded driver and stepper on 4 ranks sharing the card,
Laplace and tracer evaluations, the host-side planner, the FMM service with
its batched buckets), Yi-6B serving at full width, every other LM family of
the registry served at full width, training: Yi-6B at full width (8 of 32
layers), a step of each recurrent family and granite-moe on a (2, 2) grid,
the production dry run against the card's bytes, and serving on the grid.

Run from the repository root with no arguments (``--seed`` seeds phase
fmm_serve's jobs, 0 by default):

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build    — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel) and print the ptxas report,
              and what one TF32 tensor-core pass reads of an f32 operand's
              low 13 bits (``tf32.probe``);
2. kernels  — P2P and M2L (3xTF32 tensor cores) against their plain
              PyTorch versions on the card at the FMM path's shapes (N =
              765,625 Lamb-Oseen lattice, level 10 and level 2, p = 17, 8
              slots), with CUDA-event times and the bound; P2P also on the
              same tree with holes punched in its masks, both routes timed,
              and through the kernel's run-time instance (the code of every
              slot count but 8), checked and timed beside the s = 8 one;
              P2P's two other modes: Laplace's two channels on the lattice
              with real charges (mollified, singular, with holes), and the
              base formula at the passive targets of a 2048 x 2048
              cell-centred probe grid (4 a leaf box; mollified, singular,
              with holes in the target mask); past the first limits,
              P2P's streaming form at 512 and 2048 slots (base, and
              Laplace at passive targets) and M2L's wide form at p = 37, 40
              and 64 (alone and 4 stacks at once), each small grid split
              across a thread-block cluster (M2L also at 32 x 32 parents,
              split 4), and one grid of each that fills the card at split
              1 (P2P 32 x 32 boxes, M2L 128 x 128 parents), timed, each with its split, blocks and a second
              launch bit for bit the first, with the bound and, for M2L,
              the complex matmul yardstick;
3. fmm      — ``build_tree`` then ``fmm_velocity_singular`` on the card, held
              to a float64 direct sum at 2048 sampled particles;
4. steps    — three guarded ``rk2_step``s: ``ok``, a clear health word and a
              conserved particle count, per-step and per-stage times, peak
              memory;
4b. stepper — ``VortexStepper`` on the lattice with ``target_per_box=0.7,
              slots_headroom=2.0`` (level 10, 8 slots, cut 4), dynamic,
              replanning and checkpointing every 2 steps: four steps with
              healthy words, 765,625 live particles, orbit drift < 5e-3,
              exactly 2 P2P and 18 M2L launches a step and no plain call;
              checkpoints at steps 2 and 4, ``rollback`` and
              ``from_checkpoint`` bit for bit; a transient teleport at step
              2 recovered by ``retry_1`` and bit for bit the unfaulted
              state; the sticky teleport of the reference's fault tests
              (300 particles) recovered by ``expand_domain``, whose rebuild
              takes P2P past 136 slots; no step on the ``reference`` rung.
              Prints step ms beside phase 4's bare ``rk2_step`` ms and the
              same call with the stepper's payload, the first step on a cold
              and on a warm allocator, whether a checkpoint write was in
              flight as each step began and steps with none, host ms
              of ``maybe_replan``, ``save_checkpoint``, the last write,
              ``rollback`` and ``from_checkpoint``, bytes a checkpoint, each
              drill's rungs and seconds, peak memory;
4c. sharded — the sharded driver (``core/parallel_fmm.py``) on 4 ranks: a
              gloo world of 4 processes sharing the card, every message
              staged through host memory (NCCL refuses two ranks on one
              card), so its times are not a scaling result.  For the
              uniform 4-part slab and the cost model's 2x2 block plan:
              ``parallel_fmm_velocity`` in all four overlap/pipeline
              orders within 1e-5 of phase 3's serial velocity, pipeline on
              and off bit for bit, a clear health word, exactly
              ``parallel_fmm.kernel_launches(plan)`` launches a rank and no
              plain call; the singular evaluation within 1e-3 of phase 3's
              f64 sums; on rank 0 the rim strips' and the interior's shapes
              through each kernel against its plain version.  Then
              ``VortexStepper(mesh=..., plan_grid=(2, 2))`` for phase 4b's
              four steps: healthy, every particle live, drift < 5e-3, the
              counted launches, every rank's records, plan and positions
              bit for bit, positions within 1e-5 of phase 4b's stepper
              (re-run with particle ids, bit for bit phase 4b's state),
              ``from_checkpoint`` onto 2 ranks bit for bit, and the
              reference's grid-bound ``halo_nan`` drill (300 particles)
              recovered on ``plan_slab``.  Every rank's mesh log of the
              whole phase passes the collective-schedule verifier
              (``analysis/schedule.py``): the same collectives on every
              rank, every send met by its receive (the 2-rank restore's
              group too), and each counted evaluation's schedule equals,
              event for event, what ``schedule.simulate`` gives for the same
              plan and order on dry meshes.  Prints per rank and plan the
              host ms of each evaluation and step, the staged bytes and
              staging ms, the collectives, exchange rounds and messages of
              its log, and peak memory;
4d. drill   — the kill-drill supervisor (``launch/supervisor.py``) at
              4c's tree on gloo ranks sharing the card: rank 2 of 4
              SIGKILLed mid-step 4, the run completed at step 6 on (0, 1,
              3), every survivor bit for bit the others and a clean
              3-rank ``spawn_world`` restore from the same checkpoint,
              every step exactly 2 x ``parallel_fmm.kernel_launches(plan)``
              P2P and M2L launches a rank and no plain call; rank 1 of 3
              SIGSTOPped at step 3, detected in under 120 s, completed at
              step 5 on (0, 2); each drill's survivors' mesh logs pass the
              collective-schedule verifier.  Prints each drill's detect and
              restore seconds, each generation's spawn-to-first-step
              seconds, the steps' host ms and the survivors' collectives
              and messages;
5. equations — ``fmm_evaluate(eq=LAPLACE)`` at p = 16 on the lattice with
              real charges, and ``fmm_evaluate(eq=TRACER, targets=probe
              grid)`` at p = 17, singular, each held to a float64 direct sum
              at 2048 sampled targets (potential and field for Laplace);
              exactly one P2P launch of the evaluation's mode and 9 M2L
              launches each; host ms, finiteness, peak memory; the
              regularized errors as information;
6. plan     — ``plan_from_counts`` and ``autotune_plan`` at 64 parts on the
              lattice's level-10 leaf counts (one and two output channels):
              the autotuned plan's kind and grid, the Eq-20 load balance of
              the model, uniform and autotuned plans, host ms; the model
              slab plan's balance must be no lower than the uniform plan's;
6b. fmm_serve — ``FmmServiceEngine`` (``serve/fmm_service.py``) on the card,
              jobs made from ``--seed`` with numpy: wave A, 8 vortex
              one-shots of 100,000 uniform sources (level 7, p = 17, one
              bucket (8, 128, 128, 32)); wave B, the lattice and the lattice
              with other strengths at level 10 (bucket (2, 1024, 1024, 4));
              waves C and D, 4 Laplace and 4 tracer one-shots at p = 16 with
              a 256 x 256 probe grid.  Each bucket exactly one P2P launch of
              its mode and one M2L launch per level 2..L, no plain call;
              each job within 1e-6 of its serial ``fmm_evaluate`` on the
              card (wave B's job 0 also of phase 3's velocity, and its error
              against f64 phase 3's), probe jobs within 1e-5 of f64 at 1,024
              probes; the batched P2P and M2L launches at each bucket's
              shapes against their plain versions and bit for bit one launch
              a grid; the whale rejected with its price, a repeat of wave A
              that adds no launch configuration, operator or split, a
              deferred and promoted backlog; a paper-size session streamed
              with prefetch, bit for bit a plain ``VortexStepper``, cache
              hits counted, ``restore_session`` bit for bit; the sharded lane
              on 4 gloo ranks (wave B's job 0 through the priced plan, exact
              launches a rank, the same on every rank, within 1e-6 of the
              batched lane) and a 2-step session on the mesh, bit for bit on
              every rank.  Prints each bucket's batched and serial-sum ms,
              latencies, cache stats, peak bytes and the phase's seconds;
              then (``fmm_serve_wide``) a clustered job of 512 slots, a
              p = 40 job and an ordinary job in one drain: exactly one
              streaming P2P and three wide M2L launches, no plain call,
              each job within 1e-5 of the same engine on the CPU;
6c. analysis — the four sections of ``python -m
              repro_torch.analysis.check --device cuda --quick`` in this
              process (lint; the trace contracts on the card's route, the
              kernel wrappers, ``fmm_velocity``, ``rk2_step`` and the
              batched entries under ``set_sync_debug_mode("error")``, their
              launches pinned in the trace; the nine schedule cases on dry
              meshes; the cache sessions): 0 violations.  Prints one line a
              section, its checks, violations and seconds;
7. attn_vs_plain — the three flash-attention kernels against their
              plain version.  The bf16 tensor-core kernel at Yi-6B's
              prefill shape (4, 32, 4, 2048, 128) causal, at
              recurrentgemma-2b's attention (4, 10, 1, 2048, 256) bf16
              causal through ``ops.flash_attention`` (the d = 256 main path:
              one ``tc`` launch and no other), and at ragged T = S (77,
              1000, 2079), T < S, T > S, non-causal, Hkv 1, 4 and H, d 64,
              128 and 256, T = 1; the 3xTF32 kernel in f32 at the prefill
              shape, at recurrentgemma-2b's attention in f32 through
              ``ops.flash_attention`` (its d = 256 main path: one ``tf32``
              launch and no other), ragged T = S (77, 1000, 2079), T < S,
              T > S, non-causal, Hkv 1, d 64 and 256 and T = 1; the simt
              route's kernel (``mma.sync`` tensor cores, 3xTF32 in f32) at
              every ``SIMT_CASES`` entry: f32 d = 32 (timed beside SDPA:
              its served shape, a cluster split of 6), there through
              ``ops.flash_attention`` (its main path, a head dim only it
              takes: one ``simt`` launch and no other), recurrentgemma-2b's
              attention on the kernel itself in f32 and bf16 (timed),
              Phi-3-mini's attention (4, 32, 32, 2048, 96) causal through
              ``ops.flash_attention`` on the model's (B, T, H, d) views in
              bf16 and f32 (timed), every head-dim class (8, 16, 24, 40,
              96, 200) in both dtypes, and one q tile over 1 to 8 key
              tiles (cluster splits 1 to 8); each call exactly one
              ``simt`` launch and a second launch bit for bit the first.
              Rel L2 gates 1e-5 (f32) and 5e-3 (bf16: output
              rounding alone is 2e-3, the tensor-core kernels' bf16 P about
              2e-3).  At the timed shapes: kernel, plain, bound and SDPA
              (yardstick) milliseconds; the tensor-core routes also on the
              model's strided views (gated as the contiguous inputs are),
              and the simt kernel on the same inputs;
8. serve    — Yi-6B at full width (random weights from a seeded generator)
              behind ``ServeEngine.step_all``: 4 prompts of 2048 tokens, 32
              greedy tokens each.  Gates: every logit finite; exactly 32
              tensor-core flash launches inside ``step_all`` (one per layer
              in prefill, none in decode) and no simt launch; the logits
              that chose the last token within 2e-2 rel L2 of a
              teacher-forced ``forward`` over prompt + generated[:-1] on the
              card.  Prints prefill ms, decode ms per step, tokens per
              second, the flash kernel's and the copies' share of prefill
              device time (torch.profiler), and peak device memory;
9. serve_f32 — Yi-6B at full width in f32, cut to 2 layers: the 3xTF32
              kernel's path (f32 attention at f32 accuracy), 4 prompts of
              2048 tokens, so prefill gives the kernel the shape that phase
              7 checks and times.  Gates: every logit finite, exactly 2
              3xTF32 launches inside ``step_all`` and no other flash launch,
              decode within 2e-2 of teacher-forced.  After the counted run,
              one prefill is timed on the 3xTF32 route and on the simt
              kernel, alternately (``prefill_ms_by_route``);
9b. serve_families — every other LM of the registry at full width, random
              bf16 weights (``FAMILY_RUNS``): granite-moe-1b-a400m (24
              layers), qwen3-moe-235b-a22b (4 of 94: 128 experts, top-8),
              recurrentgemma-2b (26: RG-LRU and local attention),
              mamba2-1.3b (48), musicgen-large (48), internvl2-26b (8 of
              48; ``prefill_step`` with 1024 patch embeddings of width 3200
              before 1024 text tokens, then ``decode_step``),
              command-r-35b (2 of 40; tied f32 embedding) and qwen1.5-32b
              (2 of 64; QKV bias), each behind ``ServeEngine``: batch 4,
              2048 positions, 8 greedy tokens, timed.  Gates: exactly the
              table's ``tc`` flash launches in the prefill (one per
              attention layer, recurrentgemma-2b's 8 at d = 256 since its
              window covers the prompt) and no other; every logit finite.
              Then the same weights, cast to f32 in place, serve again with
              exactly as many 3xTF32 launches a prefill, and the logits
              that chose the last token must lie within 2e-2 rel L2 of a
              teacher-forced ``forward`` (in bf16 the random deep stacks
              amplify rounding past any fixed limit; in f32 they do not).
              MoE models take this gate at batch 1 and capacity factor
              E / k, where capacity covers every token and nothing drops
              (capacity is per call, so batch-4 decode drops, as the
              reference's does).  Phases 8, 9 and 9b's gate must also
              refuse a planted fault: the same decode step on a cache that
              never saw the prompt lands further than 2e-2 from the forced
              logits.  Prints prefill ms,
              decode ms a step, tokens per second, peak bytes, the
              parameter count (equal to the port's ``init_params`` on the
              meta device) and torch.profiler's device time by kernel over
              one more prefill and one decode step.  mamba2-1.3b's gate also
              runs its forced forward in f64 and prints how far the f32
              decode and the f32 forced forward (one 2055-position chunk)
              each sit from it;
9c. attn_grad — the flash kernel inside autograd
              (``ops.flash_attention_with_grad``) at Yi-6B's training
              attention (4, 32, 4, 2048, 128) on the model's views, bf16
              (``tc``) and f32 (``tf32``): the kernel's forward against
              ``attention_core_plain``'s within ``ATTN_TOL``; q, k, v
              gradients against the plain version's within
              ``ATTN_GRAD_TOL`` (plain against plain, since the backward
              recomputes it: this checks the wiring, and the gate must
              refuse the gradients of the unmasked plain version); one
              launch of the route, forward plus backward timed beside the
              plain version's and SDPA's;
    train   — Yi-6B at full width, 8 of 32 layers, bf16 weights and f32
              AdamW moments, one fixed batch of 4 x 2048 tokens from the
              port's pipeline: 8 steps of ``make_train_step`` (remat, lr
              1e-3, warmup 1), then one with two microbatches.  Gates: step
              0's loss within 1.0 of ln(64000); every loss finite and the
              last of the 8 at least ``TRAIN_MARGIN`` below the first;
              exactly 16 ``tc`` launches a microbatch (forward and remat's
              recompute) and no other flash launch; every layer's ``w_q``,
              ``w_k``, ``w_v`` with a finite nonzero gradient, and a planted
              fault (attention calling ``ops.flash_attention`` outside
              autograd) caught by that gate with every ``w_q`` gradient
              zero.  Prints each step's loss, ms and tokens per second, peak
              bytes, one step's device profile, and the plain attention
              backward's and ``lm_loss``'s shares of a step;
    train_families — one remat step (gradient, then AdamW) each of
              recurrentgemma-2b and mamba2-1.3b at published widths and
              depths, batch 2 x 2048: loss and gradients finite, every
              ``lru_lambda`` and ``a_log`` gradient nonzero, recurrentgemma's
              8 local-attention layers exactly 16 ``tc`` launches;
    train_sharded — granite-moe-1b-a400m at its published widths trained
              on 4 gloo ranks sharing the card as a (data 2, model 2)
              grid in the reference's layout (attention heads over model,
              each layer's weights gathered over data inside its
              checkpoint, expert parallelism over model): Part A holds the
              f32 gradient of 4 layers to the one-rank gradient (loss, grad
              norm, the whole tree; two planted faults caught, the MoE's
              and the attention's ``copy_to_model`` without its backward
              sum; the int8 gather), Part B runs ``Trainer(mesh=)`` at all
              24 layers in bf16 for 6 steps on one batch (loss, exact
              launches and collectives a rank, schedules, step ms,
              staging; every copy of a replicated block the same bytes on
              each rank) and restores its checkpoint onto one rank bit for
              bit; Part C holds granite-moe x4's f32 gradient on a (4, 1)
              grid at capacity factor 1.25 to one rank's on the whole batch
              (the grid routes the global batch; assignments drop, as many
              as on one rank); Part D holds Yi-6B's f32 gradient at full
              width, 2 layers, on the (2, 2) grid to one rank's, then times
              3 steps of 8 layers in bf16 at 4 x 2048 (16 ``tc`` launches a
              rank a step: each rank's call covers its 16 query heads);
    dryrun  — ``launch/dryrun.py``'s traces (subprocesses run beside the
              training phases, host cores only) against this run: (a)
              phase train_families' mamba2-1.3b step and (b) one decode
              step of phase 8's Yi-6B, arguments plus temporaries within
              10% of the card's bytes; (c) the fake (2, 2) trace of Part
              B's step logs rank 0's real events one for one, its bytes a
              rank within 10% of Part B's peak; (d) Yi-6B train_4k and
              decode_32k on (16, 16) and the FMM on 256 ranks, each OK,
              bytes a rank against the card; (e) phase train's Yi-6B x8
              step, within 10% of the card's bytes;
    serve_sharded — granite-moe served on the (2, 2) grid of 4 gloo ranks
              (``ServeEngine(mesh=)``): an f32 gate (granite-moe x4, and
              recurrentgemma-2b through its first attention layer, whose
              1 KV head splits the caches by sequence) against the one-rank
              engine with a planted fault, then bf16 x24 timed (prefill
              and decode ms, peak a rank, 24 ``tc`` launches a rank).

The launch counters are zeroed right before each main path (phase 3 for
the FMM kernels, and again for the stepper's four steps in phase 4b, for
each bucket's drain, the backlog and the session's steps in phase
fmm_serve and on each of its ranks before the sharded lane, on
each rank of phase 4c before each counted evaluation and before the
sharded stepper's steps, on each rank of phase 4d around each step, the
drain of phase fmm_serve_wide, each gated evaluation of phase 5 for P2P's Laplace and
passive modes, ``step_all`` in phases 8 and 9 and each serve of phase 9b
for the tensor-core flash kernels, phase 7's two recurrentgemma-2b calls for both tensor-core
kernels at d = 256 and its f32 d = 32 call for the simt one, each gradient
check of phase attn_grad, each step of phase train and each of phase
train_families, on each rank of phase train_sharded each gradient and
each step, and each prefill of phase serve_sharded and its timed
``step_all``) and read right after it: every kernel must have run there.  Then come the card's
name and power limit as nvidia-smi reports them, the kernels line and,
last, ``{"ok": true, "device": {...}}``.  Any failure ends the run with a
nonzero exit code; without a CUDA device, or without the repository's
sources beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.petfmm_vortex import CONFIG  # noqa: E402
from repro_torch.core import expansions as ex  # noqa: E402
from repro_torch.core import fmm, health as hw  # noqa: E402
from repro_torch.core.cost_model import ModelParams, array_digest  # noqa: E402
from repro_torch.core import equations as eqs  # noqa: E402
from repro_torch.core.equations import LAPLACE, TRACER, VORTEX  # noqa: E402
from repro_torch.core import plan as fmm_plan  # noqa: E402
from repro_torch.core.quadtree import Tree  # noqa: E402
from repro_torch.core.quadtree import (box_centers, box_size, build_tree,  # noqa: E402
                                       gather_particle_values, rebuild_tree)
from repro_torch.core.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.core.stepper import RecoveryPolicy, VortexStepper, rk2_step  # noqa: E402
from repro_torch.core import parallel_fmm as pf  # noqa: E402
from repro_torch.launch.mesh import (MeshEvent, make_grid_mesh, make_group_mesh,  # noqa: E402
                                     spawn_world)
from repro_torch.analysis import check as analysis_check  # noqa: E402
from repro_torch.analysis import schedule as sched  # noqa: E402
from repro_torch.core.vortex import lamb_oseen_particles  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attn, m2l, ops, p2p, tf32  # noqa: E402
from repro_torch.kernels import leaf_expansions as leaf  # noqa: E402
from repro_torch.models import moe, tensor_parallel, transformer  # noqa: E402
from repro_torch.models.transformer import (forward, init_cache, init_params,  # noqa: E402
                                             lm_loss, param_tensors, unembed)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve import grid as sgrid  # noqa: E402
from repro_torch.data.pipeline import PipelineState, make_inputs  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.layers import attention_core_plain  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, apply_updates, global_norm,  # noqa: E402
                                     init_state)
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from repro_torch.train.loop import (make_loss_fn, make_train_step, unflatten,  # noqa: E402
                                    value_and_grad)
from repro_torch.serve import fmm_service as svc  # noqa: E402
from repro_torch.launch import supervisor as sv  # noqa: E402
from repro_torch.parallel import resilience as rz  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet) for the bound column.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# FP32 operations per live pair in csrc/p2p.cu (a division or an expf counts
# as one): deltas 2, r2 3, 1/r2 1, two accumulated products 8, and the
# mollifier 4 more (divide, exp, subtract, multiply) when sigma is finite.
P2P_OPS_SINGULAR = 14
P2P_OPS_REGULARIZED = 18
# Laplace's two channels (csrc/p2p.cu:stencil_sums) per live pair, the logf
# counting as one: deltas 2, r2 3, the potential 3 (log, two products), the
# field's weight 1, channel 0 4, channel 1 10; the mollifier 3 more
# (divide, exp, subtract) when sigma is finite.
P2P_OPS_LAPLACE_SINGULAR = 23
P2P_OPS_LAPLACE_REGULARIZED = 26
# (mode, singular) -> operations per live pair
P2P_OPS = {("base", True): P2P_OPS_SINGULAR, ("base", False): P2P_OPS_REGULARIZED,
           ("laplace", True): P2P_OPS_LAPLACE_SINGULAR,
           ("laplace", False): P2P_OPS_LAPLACE_REGULARIZED}

SLOTS = 8
LAPLACE_P = LAPLACE.default_p    # 16: the log expansion's order
PROBE_SIDE = 2048                # a cell-centred probe grid, 4 probes a leaf box
PROBE_SLOTS = 4
PLAN_PARTS = 64                  # the paper's largest processor count
PLAN_CUT = 4
DT = 1e-3
STEPS = 3
# phase 4b: VortexStepper at the paper's tree: choose_level(765,625, 0.7) is
# 10 and twice the lattice's occupancy of 4 is 8 slots
STEPPER_KW = dict(target_per_box=0.7, slots_headroom=2.0, dynamic=True,
                  replan_every=2, checkpoint_every=2)
STEPPER_STEPS = 4
DRIFT_TOL = 5e-3                  # the reference's orbit invariant
OLD_P2P_SLOTS = 136               # P2P's slot limit before the stepper needed more
SAMPLES = 2048
# phase 4c: the sharded driver on 4 gloo ranks sharing the card
RANKS = 4
RANK_TIMEOUT_S = 600
SHARDED_GRID = (2, 2)
ORDERS = [(True, True), (True, False), (False, True), (False, False)]
KERNEL_TOL = 1e-5
FMM_TOL = 1e-3
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# recurrentgemma-2b (arXiv:2402.19427; src/repro/configs/recurrentgemma_2b.py):
# 10 heads, 1 KV head, head dim 256, local window 2048, so plain causal at
# 4 x 2048 tokens; the port's full-width head dim 256
RG_ATTN = (4, 10, 1, 2048, 2048, 256, True)
# Phi-3-mini (arXiv:2404.14219, config.json: hidden 3072, 32 heads, 32 KV
# heads, so head dim 96) at 4 x 2048 tokens, causal: a head dim only the simt
# route takes; a kernel case, no configuration of the repo
PHI3_ATTN = (4, 32, 32, 2048, 2048, 96, True)
# (B, H, Hkv, T, S, d, causal, dtype); the first of each tensor-core list
# is timed: the serve phases' prefill (Yi-6B, 4 x 2048), their main path at
# d = 128; the second, recurrentgemma-2b's attention, is each tensor-core
# kernel's d = 256 main path, timed too.  SIMT_CASES: the simt route's
# kernel; its first five are timed (SIMT_TIMED): f32 at d = 32, a head dim
# only it takes, its main path; recurrentgemma-2b's attention on the kernel
# itself in f32 and bf16; Phi-3-mini's attention through
# ops.flash_attention in bf16 and f32
TC_CASES = [(4, 32, 4, 2048, 2048, 128, True, torch.bfloat16),
            (*RG_ATTN, torch.bfloat16),
            (2, 4, 4, 77, 77, 256, True, torch.bfloat16),
            (1, 4, 1, 2079, 2079, 256, True, torch.bfloat16),
            (1, 4, 2, 100, 300, 256, True, torch.bfloat16),
            (1, 4, 2, 300, 100, 256, True, torch.bfloat16),
            (2, 4, 4, 200, 333, 256, False, torch.bfloat16),
            (1, 2, 2, 1, 1, 256, True, torch.bfloat16),
            (2, 4, 4, 77, 77, 128, True, torch.bfloat16),
            (1, 8, 2, 1000, 1000, 64, True, torch.bfloat16),
            (1, 4, 1, 2079, 2079, 128, True, torch.bfloat16),
            (1, 4, 2, 100, 300, 128, True, torch.bfloat16),
            (1, 4, 2, 300, 100, 64, True, torch.bfloat16),
            (2, 4, 4, 200, 333, 128, False, torch.bfloat16),
            (1, 8, 8, 129, 129, 64, True, torch.bfloat16),
            (1, 2, 2, 1, 1, 64, True, torch.bfloat16)]
TF32_CASES = [(4, 32, 4, 2048, 2048, 128, True, torch.float32),
              (*RG_ATTN, torch.float32),
              (2, 4, 4, 77, 77, 256, True, torch.float32),
              (1, 4, 1, 2079, 2079, 256, True, torch.float32),
              (1, 4, 2, 100, 300, 256, True, torch.float32),
              (1, 4, 2, 300, 100, 256, True, torch.float32),
              (2, 4, 4, 200, 333, 256, False, torch.float32),
              (1, 2, 2, 1, 1, 256, True, torch.float32),
              (1, 8, 2, 1000, 1000, 64, True, torch.float32),
              (1, 4, 1, 2079, 2079, 128, True, torch.float32),
              (1, 4, 2, 100, 300, 128, True, torch.float32),
              (1, 4, 2, 300, 100, 64, True, torch.float32),
              (2, 4, 4, 200, 333, 128, False, torch.float32),
              (1, 2, 2, 1, 1, 64, True, torch.float32)]
SIMT_CASES = [(1, 2, 2, 64, 192, 32, False, torch.float32),
              (*RG_ATTN, torch.float32),
              (*RG_ATTN, torch.bfloat16),
              (*PHI3_ATTN, torch.bfloat16),
              (*PHI3_ATTN, torch.float32),
              (1, 8, 2, 1000, 1000, 64, True, torch.float32),
              # every head-dim class in both dtypes (Q and K padded to 32)
              *[(*shape, dt) for dt in (torch.float32, torch.bfloat16) for shape in (
                  (1, 2, 1, 33, 100, 8, True),        # T < S, top-left
                  (1, 1, 1, 1, 1, 16, True),          # one token
                  (1, 4, 2, 100, 33, 24, True),       # T > S
                  (1, 4, 2, 100, 33, 40, True),
                  (1, 8, 2, 1000, 1000, 96, True),    # ragged, GQA 4:1
                  (2, 2, 1, 65, 65, 200, False))],    # not causal
              # one q tile over s 64-key tiles: bf16 cluster splits 1 to 8
              # (f32's 32-key tiles give 2, 4, 6 and 8)
              *[(1, 1, 1, 64, 64 * s - 7, 32, False, dt) for s in range(1, 9)
                for dt in (torch.float32, torch.bfloat16)]]
SIMT_TIMED = [(*c, via) for c, via in zip(SIMT_CASES[:5],
                                          ("kernel", "kernel", "kernel", "ops", "ops"))]
# phase fmm_serve: the serving engine (serve/fmm_service.py) on the card
SVC_N = 100_000                   # sources a one-shot job of waves A, C and D
SVC_WAVE_A = 8                    # vortex one-shots: one bucket at capacity 8
SVC_WAVE_C = 4                    # Laplace (wave C) and tracer (wave D) probe jobs
SVC_P_LAPLACE = 16
SVC_PROBES = np.linspace(0.06, 0.94, 256)   # a 256 x 256 grid, about 9 a level-7 box
SVC_SIGMA = 1e-3                  # the far field starts a level-7 box (7.8 sigma) away
SVC_SAMPLES = 1024
SVC_TOL = 1e-6                    # a batched job against its serial evaluation
SVC_PROBE_TOL = 1e-5              # probe jobs against f64
SVC_F64_MATCH = 1e-6              # wave B job 0's error vs f64 against phase 3's
SVC_MAX_JOB = 1e12                # admits the paper-size sessions, rejects the whale
SVC_SHARD_AT = 1e10               # on a mesh, wave B's job 0 takes the sharded lane
SVC_SESSION_KW = dict(target_per_box=0.7, slots_headroom=2.0)   # phase 4b's tree
SVC_SESSION_STEPS = 3
SVC_MESH_STEPS = 2
# the kernels past their first limits (P2P's 256 slots, M2L's p = 32): the
# FMM service's clustered bucket (level 3, 512 slots) and a denser one, in
# the base and Laplace-at-passive-targets modes; M2L at p = 40 (the p = 40
# job's leaf stack, level 4: 8 x 8 parents) and 64, alone and 4 at once.
# Each small grid splits across a cluster of blocks (M2L at 32 x 32
# parents, a p = 40 job's level 6: 16 tiles x 2 slices, by 4); the last
# case of each already fills the card at split 1 (P2P: 32 x 32 boxes x 2
# passes, 2,048 blocks; M2L: 128 x 128 parents, 256 tiles x 2 slices, 512
# blocks)
WIDE_P2P_CASES = [(512, 8, "base", False), (512, 8, "laplace", True),
                  (2048, 4, "base", False), (2048, 4, "laplace", True),
                  (512, 32, "base", False)]  # (s, side, mode, passive)
# (p, batch, parents a side); 37: a short last K chunk and a short last
# column slice
WIDE_M2L_CASES = [(37, None, 8), (37, 4, 8), (40, None, 8), (40, 4, 8), (64, None, 8),
                  (64, 4, 8), (40, None, 32), (40, None, 128)]
WIDE_SIGMA = 1e-2
# phase drill: the kill-drill supervisor at phase 4c's tree on gloo ranks
# sharing the card: SIGKILL rank 2 of 4 mid-step 4 (run to step 6), SIGSTOP
# rank 1 of 3 at step 3 (run to step 5)
DRILL_KILL = dict(world=4, target=6, rank=2, step=4, min_world=2)
DRILL_HANG = dict(world=3, target=5, rank=1, step=3, min_world=1)
DRILL_DETECT_S = 120.0
DRILL_MAX_WALL = 300.0
SERVE_ARCH = "yi-6b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_MAX_LEN = 2088
SERVE_TOL = 2e-2
F32_LAYERS, F32_BATCH, F32_PROMPT, F32_NEW = 2, SERVE_BATCH, SERVE_PROMPT, 4
# phase serve_families: (arch, layers run (None: all), tc flash launches a
# prefill, vlm patches); depth cut for memory (command-r, qwen1.5) or the
# script's time (qwen3-moe, internvl2)
FAMILY_RUNS = [("granite-moe-1b-a400m", None, 24, False),
               ("qwen3-moe-235b-a22b", 4, 4, False),
               ("recurrentgemma-2b", None, 8, False),
               ("mamba2-1.3b", None, 0, False),
               ("musicgen-large", None, 48, False),
               ("internvl2-26b", 8, 8, True),
               ("command-r-35b", 2, 2, False),
               ("qwen1.5-32b", 2, 2, False)]
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 2048, 8
# phase train: Yi-6B (arXiv:2403.04652) at its published widths in bf16, cut
# to 8 of 32 layers for memory (weights, gradients and f32 AdamW moments:
# 24.0 GB at 8 layers, 73.7 GB of the card's 80 at 32, before activations);
# one fixed batch of 4 x 2048 tokens from the port's pipeline
TRAIN_ARCH, TRAIN_LAYERS = "yi-6b", 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
TRAIN_LOSS0_TOL = 1.0     # step 0's loss within this of ln(vocab): random tokens
TRAIN_MARGIN = 3.0        # the last step's loss at least this far below the first
# the flash kernel inside autograd at the training attention (4, 32, 4, 2048,
# 128): its forward is held to attention_core_plain's within ATTN_TOL (the
# kernel's own gate); its q, k, v gradients, rel L2, check only the wiring
# (the views, the KV heads' sum, the dtypes): the backward recomputes the
# plain version, so both sides are plain f32 sums rounded once to the dtype
# (measured 1.0e-4 in bf16, 2.3e-6 in f32 on an H100); the gate must refuse
# the gradients of the unmasked plain version
ATTN_GRAD_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# the recurrent families whose layers are now differentiable: one remat step
# each at published widths and depths, batch 2 x 2048
TRAIN_FAMILIES = ["recurrentgemma-2b", "mamba2-1.3b"]
TRAIN_FAMILY_BATCH = 2
# phase train_sharded: granite-moe at its published widths on the SHARDED_GRID
# of RANKS gloo ranks sharing the card; Part A (f32, the gate) cut to 4 of 24
# layers so that its one-rank gradients fit a file of about 1.3 GB
TS_ARCH = "granite-moe-1b-a400m"
TS_A_LAYERS, TS_A_BATCH = 4, 2
TS_B_BATCH, TS_B_STEPS = 4, 6
TS_SEQ = 2048
TS_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=TS_B_STEPS)
TS_A_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grad": 1e-4}
TS_FAULT = 1e-2           # the planted fault's router and w_q gradients above this
TS_Q8_LOSS = 5e-2         # the int8 gather's loss, relative (the reference test's)
TS_MARGIN = 1.0           # Part B's last loss at least this far below step 0's
# Part C: granite-moe x4 f32 on a (4, 1) grid, the config's capacity factor
# 1.25 (tokens drop), one row of 2048 a data rank; Part D: Yi-6B at full
# width on the (2, 2) grid, f32 at 2 layers (the gate), then bf16 at 8 of 32
# layers, 4 x 2048, timed (8 layers: phase train's cut, and 4 ranks share
# the card)
TS_C_GRID, TS_C_BATCH = (4, 1), 4
TS_D_ARCH, TS_D_GATE_LAYERS, TS_D_LAYERS, TS_D_STEPS = "yi-6b", 2, 8, 3
# phase dryrun: launch/dryrun.py's predictions against this run's measurements
DRYRUN_TOL = 0.10         # (a), (b): predicted bytes within this of the measured
DRYRUN_TIMEOUT_S = 600    # each dry-run process
# phase serve_sharded: serving on the SHARDED_GRID of RANKS gloo ranks; the
# f32 gate on granite-moe at 4 layers and recurrentgemma-2b through its first
# attention layer (its prompt fills its 2048-token window), then granite-moe
# at 24 layers in bf16, timed
SS_GATE_ARCHS = ["granite-moe-1b-a400m", "recurrentgemma-2b"]
SS_MOE_LAYERS = 4
SS_BATCH, SS_PROMPT, SS_DECODES, SS_NEW = 4, 2048, 8, 4
SS_MAX_LEN = SS_PROMPT + 16
SS_TOL = 1e-4             # grid logits against the one-rank engine's, rel L2
# a token that the grid first sends to other experts than the one-rank
# engine does must be a near tie there: its k-th and next router logits
# within this (f32 sums in another order move a logit of about 1 by a few
# ulps, 1.2e-7 each)
SS_TIE = 1e-5
SS_FAULT_RANK = 1         # whose cache blocks the planted fault zeroes


def ts_collectives(layers: int, run: str = "grid") -> int:
    """Collectives a rank issues in one gradient and its global norm on the
    (2, 2) grid at granite-moe's widths, derived from the code (16 query
    and 8 KV heads split over model, D over data; the odd vocab does not
    split, so the tables are gathered whole and the loss runs whole):
    - each layer's forward: ``w_q``, ``w_k``, ``w_v`` (their model column
      blocks) and ``w_o`` (its row block) gathered over data, the 3 expert
      gathers, the attention's and the MoE's all-reduce over model: 9;
    - remat's recompute: the 7 gathers again and the attention's
      all-reduce (its early stop ends before the MoE's, whose output saves
      nothing): 8;
    - the layer's backward: ``reduce_scatter`` over data of the 4 attention
      weights and the 3 experts, an all-reduce over data of ``ln1``,
      ``ln2`` and ``router``, and over model the attention input's
      ``copy_to_model`` and the MoE's two (x and the router): 13;
    - ``embed`` and ``lm_head`` gathered over data and reduce-scattered
      back, ``final_norm``'s all-reduce over data, ``lm_loss``'s count of
      labels and its value over data, the global norm over the grid: 8.
    30 L + 8 in all (128 at 4 layers, 728 at 24); held to the CPU's
    count at narrow widths of the same divisibility.  The int8 gather
    (``run="q8"``) gathers each expert tensor's scales beside it, 6 L more;
    the planted faults drop ``copy_to_model``'s sums: the MoE's 2 L
    (``run="fault"``), the attention input's L (``run="tp_fault"``)."""
    return 30 * layers + 8 + {"grid": 0, "q8": 6, "fault": -2, "tp_fault": -1}[run] * layers


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bound_ms(nbytes: float, ops: float, peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def f32_product_bound(nbytes: float, ops: float) -> dict:
    """The bound of an f32 matrix product: its least time is three TF32
    tensor-core passes per product (the 3xTF32 split keeps f32 accuracy),
    max(bytes / 3.35 TB/s, 3 ops / 495 TFLOP/s); the FP32 SIMT figure is
    kept for information."""
    b_ms, b_by = bound_ms(nbytes, 3 * ops, TF32_FLOP_PER_S)
    return dict(bound_ms=b_ms, bound_by=b_by, fp32_simt_bound_ms=ops / FP32_FLOP_PER_S * 1e3)


def live_pairs(z_halo, mask_halo, zt=None, mt=None) -> int:
    """Pairs (live target, live source, r2 > 0) over the 3x3 stencil; the
    targets are the sources unless ``zt``/``mt`` give passive ones."""
    rows, cols = z_halo.shape[0] - 2, z_halo.shape[1] - 2
    if zt is None:
        zt, mt = z_halo[1:1 + rows, 1:1 + cols], mask_halo[1:1 + rows, 1:1 + cols]
    total = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            zs = z_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            ms = mask_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            d = zt[..., :, None] - zs[..., None, :]
            r2 = d.real * d.real + d.imag * d.imag
            total += int((mt[..., :, None] & ms[..., None, :] & (r2 > 0)).sum())
    return total


def punch_holes(mask: torch.Tensor, share: float = 0.1) -> torch.Tensor:
    """``mask`` with about ``share`` of its live slots emptied (seeded), so
    the live slots of a box are no longer a prefix."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(1)
    return mask & (torch.rand(mask.shape, generator=gen, device=mask.device) >= share)


def p2p_runtime_instance(zh, qh, mh, sigma) -> torch.Tensor:
    """P2P through the kernel's run-time instance, the code every slot count
    but 8 runs: the launch asks for one warp more than the s = 8, 16 x 16
    instance is built for, so ``csrc/p2p.cu:p2p_launch`` passes it over."""
    rows, cols, s = zh.shape[0] - 2, zh.shape[1] - 2, zh.shape[2]
    ty, tx, threads, smem = p2p.launch_config(s)
    out = torch.empty((rows, cols, s), dtype=torch.complex64, device=zh.device)
    singular = sigma is None
    err = p2p._lib().p2p_launch(
        zh.data_ptr(), qh.data_ptr(), mh.data_ptr(), None, None, out.data_ptr(), 1, rows,
        cols, s, s, 1, ty, tx, 1.0 if singular else 2.0 * sigma * sigma, int(singular),
        threads + 32, smem, torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"p2p run-time instance: CUDA error {err}")
    return out


def check_p2p(tree, sigma, holes: bool = False):
    pad = (0, 0, 1, 1, 1, 1)
    m = punch_holes(tree.mask) if holes else tree.mask
    zh, qh, mh = F.pad(tree.z, pad), F.pad(tree.q, pad), F.pad(m, pad)
    got = p2p.p2p_cuda(zh, qh, mh, sigma)
    want = p2p.p2p_plain(zh, qh, mh, sigma)
    torch.cuda.synchronize()
    err = rel_l2(got[m], want[m])
    max_abs = float((got[m] - want[m]).abs().max())
    name = f"p2p sigma={sigma}{' with holes' if holes else ''}"
    require(bool(torch.isfinite(torch.view_as_real(got[m])).all()), f"{name}: non-finite output")
    require(bool((got[~m] == 0).all()), f"{name}: a masked target is not 0")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: p2p.p2p_cuda(zh, qh, mh, sigma), iters=20)
    # the run-time instance on the same inputs, beside the s = 8 one
    rt = p2p_runtime_instance(zh, qh, mh, sigma)
    torch.cuda.synchronize()
    rt_err = rel_l2(rt[m], want[m])
    require(rt_err <= KERNEL_TOL and bool((rt[~m] == 0).all()),
            f"{name}, run-time instance: rel L2 {rt_err} or a masked target not 0")
    rt_ms = cuda_ms(lambda: p2p_runtime_instance(zh, qh, mh, sigma), iters=20)
    plain_ms = cuda_ms(lambda: p2p.p2p_plain(zh, qh, mh, sigma), iters=3, warmup=1)
    # the mask read whole, z and q (16 bytes) of live slots only, the output
    # written whole
    nbytes = mh.numel() + int(mh.sum()) * 16 + got.numel() * 8
    pairs = live_pairs(zh, mh)
    ops_ = pairs * (P2P_OPS_SINGULAR if sigma is None else P2P_OPS_REGULARIZED)
    b_ms, b_by = bound_ms(nbytes, ops_)
    return dict(name="p2p", sigma=sigma, holes=holes, live=int(m.sum()),
                shape=list(zh.shape), rel_l2=err, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, live_pairs=pairs,
                bytes=nbytes, ops=ops_, library_ms=None,
                runtime_instance_ms=rt_ms, runtime_instance_rel_l2=rt_err)


def check_p2p_mode(tree, sigma, mode: str, targets=None, holes: bool = False):
    """One of the P2P kernel's new modes against its plain version at the
    main path's shapes: Laplace's two channels at the sources (``mode
    "laplace"``), or the base formula at the passive ``targets`` tree's
    slots; ``holes`` punches holes in the target mask (the source mask for
    Laplace)."""
    pad = (0, 0, 1, 1, 1, 1)
    zt = mt = None
    m = tree.mask
    if targets is None:
        m = punch_holes(m) if holes else m
    else:
        zt = targets.z
        mt = punch_holes(targets.mask) if holes else targets.mask
    zh, qh, mh = F.pad(tree.z, pad), F.pad(tree.q, pad), F.pad(m, pad)
    call = lambda fn: fn(zh, qh, mh, sigma, zt, mt, mode)  # noqa: E731
    got = call(p2p.p2p_cuda)
    want = call(p2p.p2p_plain)
    torch.cuda.synchronize()
    live = m if mt is None else mt
    live = live if got.ndim == 3 else live[..., None].expand(got.shape)
    err = rel_l2(got[live], want[live])
    max_abs = float((got[live] - want[live]).abs().max())
    name = (f"p2p {mode}{' passive' if mt is not None else ''} sigma={sigma}"
            f"{' with holes' if holes else ''}")
    require(bool(torch.isfinite(torch.view_as_real(got[live])).all()),
            f"{name}: non-finite output")
    require(bool((got[~live] == 0).all()), f"{name}: a masked target is not 0")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: call(p2p.p2p_cuda), iters=20)
    plain_ms = cuda_ms(lambda: call(p2p.p2p_plain), iters=3, warmup=1)
    # the source mask read whole, z and q (16 bytes) of live sources only;
    # passive targets: their mask whole and z (8 bytes) of live ones; the
    # output written whole
    nbytes = mh.numel() + int(mh.sum()) * 16 + got.numel() * 8
    if mt is not None:
        nbytes += mt.numel() + int(mt.sum()) * 8
    pairs = live_pairs(zh, mh, zt, mt)
    per_pair = P2P_OPS[mode, sigma is None]
    b_ms, b_by = bound_ms(nbytes, pairs * per_pair)
    return dict(name="p2p", mode=mode, passive=mt is not None, sigma=sigma,
                holes=holes, live_targets=int(live.sum()), shape=list(got.shape),
                launch=list(p2p.launch_config(zh.shape[2], got.shape[2],
                                              p2p.MODES[mode].nout)[:3]),
                rel_l2=err, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, live_pairs=pairs, bytes=nbytes,
                ops=pairs * per_pair, library_ms=None)


def check_m2l(me, level, p):
    me_halo = F.pad(me, (0, 0, 0, 0, ex.M2L_HALO, ex.M2L_HALO))
    stack, (PR, _), (PC, _) = ex.m2l_slab_stack(me_halo, p, 0, ex.M2L_HALO)
    W = ops.folded_operator(VORTEX, p, level, stack.device)   # as the main path
    got = m2l.m2l_cuda(stack, W)
    want = m2l.m2l_plain(stack, W)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    max_abs = float((got - want).abs().max())
    require(bool(torch.isfinite(torch.view_as_real(got)).all()), "m2l: non-finite output")
    require(err <= KERNEL_TOL, f"m2l level {level}: rel L2 {err} > {KERNEL_TOL}")
    iters = 20 if level >= 8 else 200
    ms = cuda_ms(lambda: m2l.m2l_cuda(stack, W), iters=iters)
    plain_ms = cuda_ms(lambda: m2l.m2l_plain(stack, W), iters=max(iters // 4, 5))
    # yardstick: one complex matmul of the unfolded stack (built outside the
    # timed region) against the stacked operator
    K = 4 * p
    unfolded = torch.cat([stack[1 + Dy:1 + Dy + PR, 1 + Dx:1 + Dx + PC]
                          for (Dx, Dy) in ex.PARENT_NEIGH8], dim=-1).reshape(PR * PC, 8 * K)
    w_cat = W.reshape(8 * K, K)
    lib_err = rel_l2(torch.matmul(unfolded, w_cat).reshape(PR, PC, K), want)
    library_ms = cuda_ms(lambda: torch.matmul(unfolded, w_cat), iters=iters)
    nnz_blocks = int((W.reshape(8, 4, p, 4, p).abs().amax(dim=(2, 4)) > 0).sum())
    ops_ = PR * PC * nnz_blocks * p * p * 8
    nbytes = (stack.numel() + W.numel() + got.numel()) * 8
    return dict(name="m2l", level=level, p=p, shape=list(stack.shape),
                rel_l2=err, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                **f32_product_bound(nbytes, ops_), library_ms=library_ms,
                library_rel_l2=lib_err, nonzero_blocks=nnz_blocks,
                bytes=nbytes, ops=ops_)


def check_p2m(tree, p, coeff=None, name="p2m"):
    """The P2M kernel against its plain version on ``tree``'s leaves, timed
    beside the plain version and the bound: z, q and the mask read once, the
    coefficients written once; a running product and a multiply-add (14
    FP32 operations) a slot and order."""
    L = tree.level
    cen, r = fmm._centers_on(L, tree.device), box_size(L)
    args = (tree.z, tree.q, tree.mask, cen, r, p, coeff)
    got = leaf.p2m_cuda(*args)
    want = leaf.p2m_plain(*args)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    require(bool(torch.isfinite(torch.view_as_real(got)).all()), f"{name}: non-finite ME")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: leaf.p2m_cuda(*args), iters=20)
    plain_ms = cuda_ms(lambda: leaf.p2m_plain(*args), iters=5, warmup=1)
    nbytes = tree.z.numel() * 17 + got.numel() * 8
    ops_ = tree.z.numel() * p * 14
    b_ms, b_by = bound_ms(nbytes, ops_)
    return dict(name=name, p=p, shape=list(tree.z.shape), rel_l2=err,
                max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops_,
                launch=list(leaf.p2m_launch_config(tree.z.shape[-1], p)), library_ms=None)


def check_l2p(z, mask, level, p, modes=("value",), name="l2p"):
    """The L2P kernel against its plain version at the slots ``z`` (compared
    where ``mask`` holds: the driver masks the rest), on seeded LEs, timed
    beside the plain version and the bound: the LEs and z read once, the
    channels written once; a complex multiply-add (8 FP32 operations) a slot,
    order and channel."""
    gen = torch.Generator(device=z.device)
    gen.manual_seed(3)
    le = torch.randn(tuple(z.shape[:-1]) + (p,), dtype=torch.complex64,
                     generator=gen, device=z.device)
    cen, r = fmm._centers_on(level, z.device), box_size(level)
    args = (le, z, cen, r, p, modes)
    got = leaf.l2p_cuda(*args)
    want = leaf.l2p_plain(*args)
    torch.cuda.synchronize()
    err = rel_l2(got[mask], want[mask])
    require(bool(torch.isfinite(torch.view_as_real(got[mask])).all()),
            f"{name}: non-finite value at a live slot")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: leaf.l2p_cuda(*args), iters=20)
    plain_ms = cuda_ms(lambda: leaf.l2p_plain(*args), iters=5, warmup=1)
    nbytes = (le.numel() + z.numel() + got.numel()) * 8
    ops_ = z.numel() * p * 8 * len(modes)
    b_ms, b_by = bound_ms(nbytes, ops_)
    return dict(name=name, p=p, modes=list(modes), shape=list(z.shape), rel_l2=err,
                max_abs_err=float((got[mask] - want[mask]).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops_,
                launch=list(leaf.l2p_launch_config(z.shape[-1], p)), library_ms=None)


def wide_p2p_inputs(s, side, passive, seed, dev):
    """A ``side x side`` grid of boxes (halo'd) with up to ``s`` sources a
    box, inside the box, prefix-filled to a random count with a quarter of
    them emptied again; passive targets ``s`` a box, a third masked."""
    rng = np.random.default_rng(seed)
    H = side + 2
    iy, ix = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    def inside(shape, off):                     # noqa: E306
        return ((ix[off:H - off, off:H - off, None] - 1 + rng.random(shape)) / side
                + 1j * (iy[off:H - off, off:H - off, None] - 1 + rng.random(shape)) / side)
    z = inside((H, H, s), 0)
    q = rng.normal(size=(H, H, s)) + 1j * rng.normal(size=(H, H, s))
    fill = rng.integers(s // 4, s + 1, size=(H, H, 1))
    mask = (np.arange(s) < fill) & (rng.random((H, H, s)) > 0.25)
    zt = mt = None
    if passive:
        zt, mt = inside((side, side, s), 1), rng.random((side, side, s)) > 0.3
    put = lambda a, dt: None if a is None else torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (put(z, torch.complex64), put(q, torch.complex64), put(mask, torch.bool),
            put(zt, torch.complex64), put(mt, torch.bool))


def check_p2p_wide(s, side, mode, passive, dev):
    """P2P's streaming form (past 256 slots) against its plain version."""
    zh, qh, mh, zt, mt = wide_p2p_inputs(s, side, passive, s + side, dev)
    nout = p2p.MODES[mode].nout
    launch = p2p.launch_config(s, s, nout)
    require(launch == (1, 1, p2p.STREAM_THREADS, p2p.STREAM_SMEM),
            f"p2p s={s} {mode}: launch {launch} is not the streaming form")
    call = lambda fn: fn(zh, qh, mh, WIDE_SIGMA, zt, mt, mode)  # noqa: E731
    split = p2p.stream_launch_config(side, side, s, s, nout)[0]
    ctas = p2p.stream_blocks(side, side, s, s, nout)
    before = p2p.STREAM_LAUNCHES
    got = call(p2p.p2p_cuda)
    torch.cuda.synchronize()
    require(p2p.STREAM_LAUNCHES == before + 1, f"p2p s={s}: no streaming launch")
    want = call(p2p.p2p_plain)
    live = mh[1:-1, 1:-1] if mt is None else mt
    live = live if got.ndim == 3 else live[..., None].expand(got.shape)
    name = f"p2p stream s={s} {side}x{side} {mode}{' passive' if passive else ''}"
    err = rel_l2(got[live], want[live])
    max_abs = float((got[live] - want[live]).abs().max())
    require(bool(torch.isfinite(torch.view_as_real(got)).all()), f"{name}: non-finite")
    require(bool((got[~live] == 0).all()), f"{name}: a masked target is not 0")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    repeat = bool(torch.equal(got, call(p2p.p2p_cuda)))
    require(repeat, f"{name}: two launches differ")
    ms = cuda_ms(lambda: call(p2p.p2p_cuda), iters=10)
    plain_ms = cuda_ms(lambda: call(p2p.p2p_plain), iters=2, warmup=1)
    nbytes = mh.numel() + int(mh.sum()) * 16 + got.numel() * 8
    if mt is not None:
        nbytes += mt.numel() + int(mt.sum()) * 8
    pairs = live_pairs(zh, mh, zt, mt)
    ops_ = pairs * P2P_OPS[mode, False]
    b_ms, b_by = bound_ms(nbytes, ops_)
    return dict(name="p2p_stream", slots=s, mode=mode, passive=passive,
                shape=list(got.shape), launch=list(launch[:3]), split=split, ctas=ctas,
                bitwise_repeat=repeat, rel_l2=err,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, live_pairs=pairs, bytes=nbytes, ops=ops_, library_ms=None)


def check_m2l_wide(p, batch, n, dev):
    """M2L's wide form (past p = 32) on ``n x n`` parents against its plain
    version, with the complex ``torch.matmul`` yardstick."""
    rng = np.random.default_rng(p + (batch or 0) + (n != 8) * n)
    K = 4 * p
    shape = ((batch,) if batch else ()) + (n + 2, n + 2, K)
    stack = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                            dtype=torch.complex64, device=dev)
    W = ops.folded_operator(VORTEX, p, 4, dev)
    slices, split, smem = m2l.wide_launch_config(n, n, p)
    ctas = m2l.wide_blocks(n, n, p) * (batch or 1)
    before = m2l.WIDE_LAUNCHES
    got = m2l.m2l_cuda(stack, W)
    torch.cuda.synchronize()
    require(m2l.WIDE_LAUNCHES == before + 1, f"m2l p={p}: no wide-form launch")
    want = m2l.m2l_plain(stack, W)
    err = rel_l2(got, want)
    max_abs = float((got - want).abs().max())
    name = f"m2l wide p={p} batch={batch} {n}x{n}"
    require(bool(torch.isfinite(torch.view_as_real(got)).all()), f"{name}: non-finite")
    require(err <= KERNEL_TOL, f"{name}: rel L2 {err} > {KERNEL_TOL}")
    repeat = bool(torch.equal(got, m2l.m2l_cuda(stack, W)))
    require(repeat, f"{name}: two launches differ")
    ms = cuda_ms(lambda: m2l.m2l_cuda(stack, W), iters=50)
    plain_ms = cuda_ms(lambda: m2l.m2l_plain(stack, W), iters=10)
    lead = stack.shape[:-3]
    unfolded = torch.cat([stack[..., 1 + Dy:1 + Dy + n, 1 + Dx:1 + Dx + n, :]
                          for (Dx, Dy) in ex.PARENT_NEIGH8], dim=-1).reshape(-1, 8 * K)
    w_cat = W.reshape(8 * K, K)
    lib_err = rel_l2(torch.matmul(unfolded, w_cat).reshape(lead + (n, n, K)), want)
    library_ms = cuda_ms(lambda: torch.matmul(unfolded, w_cat), iters=50)
    nnz_blocks = int((W.reshape(8, 4, p, 4, p).abs().amax(dim=(2, 4)) > 0).sum())
    ops_ = (batch or 1) * n * n * nnz_blocks * p * p * 8
    nbytes = (stack.numel() + W.numel() + got.numel()) * 8
    return dict(name="m2l_wide", p=p, batch=batch, shape=list(stack.shape),
                slices=slices, split=split, ctas=ctas, smem=smem, bitwise_repeat=repeat,
                rel_l2=err, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, **f32_product_bound(nbytes, ops_),
                library_ms=library_ms, library_rel_l2=lib_err,
                nonzero_blocks=nnz_blocks, bytes=nbytes, ops=ops_)


def direct_f64(pos, strength, z_tgt, sigma, laplace: bool = False, chunk=128):
    """Float64 direct sum on the card at the points ``z_tgt`` (complex,
    host): the velocity kernel's one channel, (T,), or with ``laplace``
    the potential and field, (T, 2), as ``equations.direct_sum`` computes
    them.  Coincident pairs are excluded."""
    dev = torch.device("cuda")
    z = torch.as_tensor(pos[:, 0] + 1j * pos[:, 1], dtype=torch.complex128, device=dev)
    scale = LAPLACE.charge_scale if laplace else 1 / (2j * np.pi)
    q = torch.as_tensor(strength * scale, dtype=torch.complex128, device=dev)
    zt = torch.as_tensor(z_tgt, dtype=torch.complex128, device=dev)
    out = []
    for start in range(0, len(zt), chunk):
        dz = zt[start:start + chunk][:, None] - z[None, :]
        r2 = dz.real * dz.real + dz.imag * dz.imag
        inv = torch.where(r2 > 0, 1.0 / torch.where(r2 > 0, dz, 1.0), 0.0)
        w = None if sigma is None else 1.0 - torch.exp(-r2 / (2.0 * sigma * sigma))
        if w is not None:
            inv = inv * w
        if not laplace:
            out.append(inv @ q)
            continue
        pot = 0.5 * torch.log(torch.where(r2 > 0, r2, 1.0)) * (r2 > 0)
        if w is not None:
            pot = pot * w
        out.append(torch.stack([pot.to(q.dtype) @ q, -(inv @ q)], dim=-1))
    return torch.cat(out)


def direct_sum_f64(pos, gamma, targets, sigma):
    """Float64 velocity direct sum on the card at ``targets`` (indices into
    pos)."""
    return direct_f64(pos, gamma, pos[targets, 0] + 1j * pos[targets, 1], sigma)


def zero_fmm_counts() -> None:
    p2p.LAUNCHES = m2l.LAUNCHES = p2p.STREAM_LAUNCHES = m2l.WIDE_LAUNCHES = 0
    leaf.P2M_LAUNCHES = leaf.L2P_LAUNCHES = 0
    for mode in p2p.LAUNCHES_BY_MODE:
        p2p.LAUNCHES_BY_MODE[mode] = 0


def fmm_counts() -> dict:
    """The FMM kernels' launches since ``zero_fmm_counts``: P2P by mode
    (only the modes that launched) and M2L."""
    return {"p2p": {k: v for k, v in p2p.LAUNCHES_BY_MODE.items() if v},
            "m2l": m2l.LAUNCHES}


def equations_phase(dev, pos, gamma, sigma, p, tree0, index0, sample, tree_lap,
                    probes, probe_pos, probe_index) -> dict:
    """Laplace (p = 16) at the lattice's own particles and the vortex kernel
    as a tracer (p) at the probe grid, each through ``fmm.fmm_evaluate``,
    singular, held to a float64 direct sum at ``SAMPLES`` sampled targets;
    the launch counters are zeroed before each gated call and must show one
    P2P launch of the evaluation's mode and one M2L launch per level 2..L.
    Returns each evaluation's launches."""
    level = tree0.level
    probe_sample = np.sort(np.random.default_rng(1).choice(len(probe_pos), SAMPLES,
                                                           replace=False))
    cases = {
        "laplace": (LAPLACE, LAPLACE_P, tree_lap, None, index0, pos[sample], "laplace"),
        "tracer": (TRACER, p, tree0, probes, probe_index, probe_pos[probe_sample],
                   "base_passive")}
    launches = {}
    for name, (eq, order, reg, targets, idx, at_pos, mode) in cases.items():
        sing = Tree(z=reg.z, q=reg.q, mask=reg.mask, level=level, sigma=None)
        evaluate = lambda t: fmm.fmm_evaluate(t, order, eq=eq, targets=targets,  # noqa: E731
                                              device=dev)
        picked = torch.as_tensor(sample if targets is None else probe_sample, device=dev)
        z_at = at_pos[:, 0] + 1j * at_pos[:, 1]
        laplace = eq.nout == 2

        def errors(out, sig):
            exact = direct_f64(pos, gamma, z_at, sig, laplace=laplace)
            at = lambda x: gather_particle_values(x, idx)[picked]  # noqa: E731
            if not laplace:
                return {"velocity": rel_l2(at(out).to(torch.complex128), exact)}
            return {"potential": rel_l2(at(out[..., 0]).real.double(), exact[:, 0].real),
                    "field": rel_l2(at(out[..., 1]).to(torch.complex128), exact[:, 1])}

        evaluate(sing)                                   # warm: operators to the card
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_fmm_counts()
        t0 = time.perf_counter()
        out = evaluate(sing)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = fmm_counts()
        peak = torch.cuda.max_memory_allocated()
        out_mask = sing.mask if targets is None else targets.mask
        want_shape = tuple(out_mask.shape) + ((eq.nout,) if laplace else ())
        require(tuple(out.shape) == want_shape, f"{name}: output shape {tuple(out.shape)}")
        finite = bool(torch.isfinite(torch.view_as_real(out[out_mask])).all())
        require(finite, f"{name}: non-finite output at a live slot")
        want_counts = {"p2p": {mode: 1}, "m2l": level - 1}
        require(counts == want_counts, f"{name}: launches {counts}, expected {want_counts}")
        errs = errors(out, None)
        reg_errs = errors(evaluate(reg), sigma)
        launches[name] = counts
        emit({"phase": "equations", "equation": name, "p": order,
              "n_sources": int(reg.mask.sum()), "targets": int(out_mask.sum()),
              "target_slots": out_mask.shape[-1], "output_shape": list(out.shape),
              "host_ms": host_ms, "finite_at_live_slots": finite, "peak_bytes": peak,
              "launches": counts, "rel_l2_singular_vs_f64": errs, "gate": FMM_TOL,
              "rel_l2_regularized_vs_f64_info": reg_errs})
        for channel, err in errs.items():
            require(err < FMM_TOL, f"{name} {channel}: rel L2 {err} >= {FMM_TOL}")
    return launches


def plan_phase(counts, level, p) -> None:
    """``plan_from_counts`` and ``autotune_plan`` at ``PLAN_PARTS`` parts on
    the leaf counts, for one and two output channels; the model slab plan's
    Eq-20 load balance must be no lower than the uniform plan's."""
    uniform = fmm_plan.uniform_plan(level, PLAN_PARTS)
    for nout in (VORTEX.nout, LAPLACE.nout):
        params = ModelParams(level=level, cut=PLAN_CUT, p=p, slots=SLOTS, nout=nout)
        t0 = time.perf_counter()
        slab = fmm_plan.plan_from_counts(counts, params, PLAN_PARTS)
        slab_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        auto = fmm_plan.autotune_plan(counts, params, PLAN_PARTS)
        auto_ms = (time.perf_counter() - t0) * 1e3
        lb = {k: fmm_plan.plan_stats(pl, counts, params)["load_balance"]
              for k, pl in (("model_slab", slab), ("uniform_slab", uniform),
                            ("autotuned", auto))}
        emit({"phase": "plan", "nparts": PLAN_PARTS, "level": level, "cut": PLAN_CUT,
              "p": p, "slots": SLOTS, "nout": nout, "load_balance": lb,
              "autotuned_kind": type(auto).__name__,
              "autotuned_grid": list(getattr(auto, "grid", (PLAN_PARTS, 1))),
              "plan_from_counts_host_ms": slab_ms, "autotune_plan_host_ms": auto_ms})
        require(lb["model_slab"] >= lb["uniform_slab"],
                f"nout {nout}: model plan balance {lb['model_slab']} < uniform "
                f"{lb['uniform_slab']}")


def stepper_state(st) -> list[torch.Tensor]:
    return [t.clone() for t in (st.tree.z, st.tree.q, st.tree.mask, st.payload["r0"])]


def same_state(st, state) -> bool:
    now = (st.tree.z, st.tree.q, st.tree.mask, st.payload["r0"])
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(now, state))


def orbit_drift(st) -> float:
    """max |r - r0| over the particles whose initial radius exceeds 0.02."""
    m = st.tree.mask
    z, rr0 = st.tree.z[m], st.payload["r0"][m].real
    r = torch.hypot(z.real - 0.5, z.imag - 0.5)
    sel = rr0 > 0.02
    return float((r[sel] - rr0[sel]).abs().max())


def timed_method(obj, name: str, into: list) -> None:
    """Wrap ``obj.name`` so each call appends its host ms to ``into``."""
    fn = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(obj, name, call)


def stepper_phase(dev, pos, gamma, sigma, p, bare_step_ms) -> dict:
    """``VortexStepper`` at the paper's size on the card: four unfaulted
    steps (launches counted), its checkpoints, rollback and
    ``from_checkpoint`` bit for bit, a transient teleport at full size
    recovered by a plain retry bit for bit, and the sticky teleport of the
    reference's fault tests (300 particles) recovered by the domain
    expansion, whose rebuild asks P2P for more than 136 slots.  Returns the
    four steps' launches."""
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    ck_dirs = [Path(tempfile.mkdtemp(prefix="stepper_ckpt_", dir=root)) for _ in range(2)]
    records = []
    try:
        make = lambda ck, **kw: VortexStepper(  # noqa: E731
            pos, gamma, sigma, p=p, dt=DT, payload={"r0": r0 + 0j},
            checkpoint_dir=str(ck), **STEPPER_KW, **kw)
        t0 = time.perf_counter()
        st = make(ck_dirs[0])
        build_ms = (time.perf_counter() - t0) * 1e3
        params = dataclasses.asdict(st.params)
        require((st.params.level, st.params.slots, st.params.cut) == (CONFIG.level, SLOTS,
                                                                    CONFIG.cut_level),
                f"stepper tree {params}, expected level {CONFIG.level}, {SLOTS} slots, "
                f"cut {CONFIG.cut_level}")
        save_ms, replan_ms = [], []
        timed_method(st, "save_checkpoint", save_ms)
        timed_method(st, "maybe_replan", replan_ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_fmm_counts()
        ops.PLAIN_CALLS = 0
        recs, writing = [], []
        for i in range(STEPPER_STEPS):
            # whether the manager's thread is still writing a checkpoint
            writing.append(st._ckpt._thread is not None and st._ckpt._thread.is_alive())
            recs.append(st.step())
            if i == 2:
                state3 = stepper_state(st)
        torch.cuda.synchronize()
        counts, plain_calls = fmm_counts(), ops.PLAIN_CALLS
        peak = torch.cuda.max_memory_allocated()
        records += recs
        live = int(st.tree.mask.sum())
        drift = orbit_drift(st)
        attempts = len(recs)
        for rec in recs:
            require(rec.recovered == "" and rec.health != 0
                    and hw.ok(hw.unpack(rec.health)),
                    f"stepper step {rec.step}: recovered {rec.recovered!r}, health "
                    f"{hw.describe(rec.health)}")
        require(live == CONFIG.num_particles, f"stepper: {live} live particles")
        require(drift < DRIFT_TOL, f"stepper: orbit drift {drift} >= {DRIFT_TOL}")
        want = {"p2p": {"base": 2 * attempts}, "m2l": 2 * (CONFIG.level - 1) * attempts}
        require(counts == want, f"stepper launches {counts}, expected {want}")
        require(plain_calls == 0, f"stepper: {plain_calls} plain calls")
        step_ms = [rec.seconds * 1e3 for rec in recs]
        predicted = st.predicted_step_seconds()
        # checkpoints: the last async write, what is on disk, rollback
        t0 = time.perf_counter()
        st._ckpt.wait()
        wait_ms = (time.perf_counter() - t0) * 1e3
        ck_steps = st._ckpt.all_steps()
        require(ck_steps == [2, 4], f"checkpoints at steps {ck_steps}, expected [2, 4]")
        ck_bytes = sum(f.stat().st_size for f in (ck_dirs[0] / "step_4").iterdir())
        # phase 4's bare step with the stepper's payload riding both rebins,
        # the stepper's own call, on a warm allocator with no write in flight
        payload_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rk2_step(st.tree, DT, st.payload, p=p, guard=True)
            torch.cuda.synchronize()
            payload_ms.append((time.perf_counter() - t0) * 1e3)
        state4 = stepper_state(st)
        records.append(st.step())
        quiet_ms = [records[-1].seconds * 1e3]
        t0 = time.perf_counter()
        back = st.rollback()
        torch.cuda.synchronize()
        rollback_ms = (time.perf_counter() - t0) * 1e3
        require(back == 4 and st.step_count == 4 and same_state(st, state4),
                "rollback: the step-4 state is not restored bit for bit")
        t0 = time.perf_counter()
        st2 = VortexStepper.from_checkpoint(str(ck_dirs[0]))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        require(st2.step_count == 4 and same_state(st2, state4)
                and dataclasses.asdict(st2.params) == params,
                "from_checkpoint: the step-4 state is not restored bit for bit")
        rec = st2.step()
        records.append(rec)
        quiet_ms.append(rec.seconds * 1e3)
        require(rec.recovered == "" and hw.ok(hw.unpack(rec.health)),
                f"restored stepper's step: {rec}")
        del st, st2
        # transient drill at full size: retry_1, then the unfaulted state
        t0 = time.perf_counter()
        drill = make(ck_dirs[1], faults=FaultInjector(FaultSpec("teleport", step=2,
                                                                 magnitude=0.6)))
        drecs = [drill.step() for _ in range(3)]
        torch.cuda.synchronize()
        transient_s = time.perf_counter() - t0
        records += drecs
        transient = [r.recovered for r in drecs]
        require(transient == ["", "retry_1", ""],
                f"transient drill recorded {transient}, expected ['', 'retry_1', '']")
        require(same_state(drill, state3),
                "transient drill: the state after 3 steps is not the unfaulted one")
        del drill, state3
        # sticky drill, at the reference fault tests' inputs
        rng = np.random.default_rng(1)
        spos = 0.02 + 0.96 * rng.random((300, 2))
        sgamma = rng.standard_normal(300) * 0.1
        t0 = time.perf_counter()
        sticky = VortexStepper(spos, sgamma, 0.02, p=6, dt=0.002, faults=FaultInjector(
            FaultSpec("teleport", step=2, sticky=True, magnitude=0.6)))
        zero_fmm_counts()
        srecs = [sticky.step() for _ in range(3)]
        torch.cuda.synchronize()
        sticky_s = time.perf_counter() - t0
        sticky_counts = fmm_counts()
        records += srecs
        spos1, _ = sticky.particles()
        unit = sticky.domain.to_unit(spos1)
        require(srecs[1].recovered == "expand_domain" and sticky.domain.size >= 2.0,
                f"sticky drill: {srecs[1]}, domain {sticky.domain}")
        require(len(spos1) == 300 and bool(np.isfinite(spos1).all())
                and bool(((unit >= 0) & (unit <= 1)).all()),
                "sticky drill: a particle lost, non-finite or outside the domain")
        require(sticky.params.slots > OLD_P2P_SLOTS,
                f"sticky drill: {sticky.params.slots} slots; the drill should cross "
                f"{OLD_P2P_SLOTS}")
        rungs = [r.recovered for r in records]
        require("reference" not in rungs, f"a step recovered on the reference rung: {rungs}")
    finally:
        for d in ck_dirs:
            shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "stepper", "n": CONFIG.num_particles, "params": params,
          "build_host_ms": build_ms, "step_ms": step_ms,
          "predicted_step_seconds": predicted, "bare_rk2_step_ms": bare_step_ms,
          "step_minus_bare_ms": [ms - min(bare_step_ms) for ms in step_ms],
          "payload_rk2_step_ms": payload_ms,
          "host_split": {"first_step_cold_ms": step_ms[0],
                         "first_step_warm_ms": drecs[0].seconds * 1e3,
                         "write_in_flight_at_step_start": writing,
                         "quiet_step_ms": quiet_ms},
          "maybe_replan_host_ms": replan_ms, "save_checkpoint_host_ms": save_ms,
          "checkpoint_wait_ms": wait_ms, "rollback_ms": rollback_ms,
          "from_checkpoint_ms": restore_ms, "checkpoint_bytes": ck_bytes,
          "checkpoint_steps": ck_steps, "live": live, "orbit_drift": drift,
          "drift_gate": DRIFT_TOL, "launches": counts, "plain_calls": plain_calls,
          "peak_bytes": peak,
          "transient_drill": {"recovered": transient, "seconds": transient_s,
                              "step_ms": [r.seconds * 1e3 for r in drecs]},
          "sticky_drill": {"recovered": [r.recovered for r in srecs], "seconds": sticky_s,
                           "domain_size": sticky.domain.size,
                           "slots_after": sticky.params.slots, "launches": sticky_counts,
                           "step_ms": [r.seconds * 1e3 for r in srecs]}})
    return counts, state4


def host_ms(fn):
    """Host milliseconds of ``fn()``, ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def strip_checks(tree, plan, mesh, p) -> dict:
    """The shapes the overlapped path gives the kernels on this rank's tile:
    P2P and M2L (leaf level) on a rim row strip's shape, a rim column
    strip's and the interior's, each through the kernel and its plain
    version on the card.  The strips are cut from the halo buffer through
    the middle of the tile, where the lattice has particles (its edge boxes
    are empty).  The halo exchanges are collective, so every rank builds
    the buffers; the caller checks on rank 0 only."""
    block = plan.as_block() if isinstance(plan, fmm_plan.SlabPlan) else plan
    ident = pf._is_identity(block, mesh.size, tree.nside)
    tiles = [pf._my_tile(a, block, mesh.rank, ident, fill=f)
             for a, f in ((tree.z, 0), (tree.q, 0), (tree.mask, False))]
    _, rows, _, cols = pf._tile_extents(block, mesh.rank)
    zb, qb, mb = pf._unpack_particles(pf._tile_halo(
        pf._pack_particles(*tiles), 1, rows, cols, mesh, block.grid).wait())
    cen = F.pad(fmm._centers_on(tree.level, tree.device), (0, block.cols_max, 0,
                                                           block.rows_max))
    r0, _, c0, _ = pf._tile_extents(block, mesh.rank)
    me = ex.p2m(*tiles, cen[r0:r0 + block.rows_max, c0:c0 + block.cols_max],
                box_size(tree.level), p, compute=ops.p2m_apply)
    w = ex.M2L_HALO
    meb = pf._tile_halo(me, w, rows, cols, mesh, block.grid).wait()
    out = {}
    mr, mc = (rows // 2) & ~1, (cols // 2) & ~1          # even: M2L's parity anchor
    p2p_cuts = {"row_strip": (slice(mr, mr + 3), slice(None)),
                "column_strip": (slice(None), slice(mc, mc + 3)),
                "interior": None}
    for name, cut in p2p_cuts.items():
        args = tiles if cut is None else [fmm._fresh(a[cut]) for a in (zb, qb, mb)]
        got = p2p.p2p_cuda(*args, tree.sigma)
        want = p2p.p2p_plain(*args, tree.sigma)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        out[f"p2p_{name}"] = {
            "shape": list(args[0].shape), "rel_l2": err,
            "plain_max_abs": float(want.abs().max()),
            "max_abs_err": float((got - want).abs().max()),
            "ms": cuda_ms(lambda: p2p.p2p_cuda(*args, tree.sigma), iters=10),
            "plain_ms": cuda_ms(lambda: p2p.p2p_plain(*args, tree.sigma), iters=3,
                                warmup=1)}
    m2l_cuts = {"row_strip": (slice(mr, mr + 3 * w), slice(None)),
                "column_strip": (slice(None), slice(mc, mc + 3 * w)),
                "interior": None}
    op = ops.folded_operator(VORTEX, p, tree.level, tree.device)
    scale = VORTEX.m2l_scale(tree.level)
    for name, cut in m2l_cuts.items():
        x = me if cut is None else fmm._fresh(meb[cut])
        kernel = lambda: ops.m2l_apply_slab(x, tree.level, p, halo=w, col_halo=w)  # noqa: E731
        plain = lambda: ex.m2l_folded(x, tree.level, p, halo=w, col_halo=w,  # noqa: E731
                                      op=op, scale=scale)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        out[f"m2l_{name}"] = {
            "shape": list(x.shape), "rel_l2": rel_l2(got, want),
            "plain_max_abs": float(want.abs().max()),
            "max_abs_err": float((got - want).abs().max()),
            "ms": cuda_ms(kernel, iters=10), "plain_ms": cuda_ms(plain, iters=3, warmup=1)}
    return out


def sharded_rank(mesh, spec: dict) -> dict:
    """Phase 4c on one rank: both plans' evaluations, the stepper, its
    restore onto 2 ranks and the grid-bound halo drill.  Raises at the
    first failed gate, which fails the world."""
    dev = mesh.device
    inp = np.load(spec["inputs"])
    pos, gamma, sigma, p = inp["pos"], inp["gamma"], float(inp["sigma"]), int(inp["p"])
    level = CONFIG.level
    tree, index = build_tree(pos, gamma, level=level, sigma=sigma, slots=SLOTS,
                             device=dev)
    sing = Tree(z=tree.z, q=tree.q, mask=tree.mask, level=level, sigma=None)
    serial = torch.as_tensor(inp["w_reg"], device=dev)
    picked = torch.as_tensor(inp["sample"], device=dev)
    exact = torch.as_tensor(inp["exact_sing"], device=dev)
    require(mesh.size == RANKS, f"phase 4c runs on {RANKS} ranks, not {mesh.size}")
    plans = sharded_plans(index, p)
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "plans": {}, "schedules": {}}
    for name, plan in plans.items():
        rec = {"plan": plan.describe(), "eval_host_ms": {}, "staged_bytes": {},
               "staging_ms": {}, "rel_l2_vs_serial": {}}
        pf.parallel_fmm_velocity(tree, p, mesh, plan)             # warm
        results = {}
        for ov, pipe in ORDERS:
            key = f"overlap={ov} pipeline={pipe}"
            mesh.barrier()
            torch.cuda.synchronize()
            zero_fmm_counts()
            ops.PLAIN_CALLS = 0
            mesh.wire.reset()
            mark = len(mesh.log)
            (w, h), ms = host_ms(lambda: pf.parallel_fmm_velocity(
                tree, p, mesh, plan, overlap=ov, pipeline=pipe, with_health=True))
            out["schedules"][f"{name} {key}"] = mesh.log.since(mark)
            counts, plain_calls = fmm_counts(), ops.PLAIN_CALLS
            want = pf.kernel_launches(plan, ov)
            want = {"p2p": {"base": want["p2p"]}, "m2l": want["m2l"]}
            require(counts == want and plain_calls == 0,
                    f"rank {mesh.rank} {name} {key}: launches {counts}, plain "
                    f"{plain_calls}; expected {want} and no plain call")
            require(tuple(w.shape) == tuple(tree.z.shape) and hw.ok(h),
                    f"rank {mesh.rank} {name} {key}: shape {tuple(w.shape)}, health "
                    f"{hw.describe(h)}")
            require(bool(torch.isfinite(torch.view_as_real(w[tree.mask])).all()),
                    f"rank {mesh.rank} {name} {key}: non-finite velocity")
            err = rel_l2(w, serial)
            require(err <= KERNEL_TOL, f"rank {mesh.rank} {name} {key}: rel L2 vs the "
                                       f"serial kernel path {err} > {KERNEL_TOL}")
            if (ov, pipe) == (True, True):
                rec["launches"] = counts
            rec["eval_host_ms"][key] = ms
            rec["staged_bytes"][key] = mesh.wire.staged_bytes
            rec["staging_ms"][key] = mesh.wire.staging_s * 1e3
            rec["rel_l2_vs_serial"][key] = err
            results[ov, pipe] = w
        for ov in (True, False):
            require(torch.equal(results[ov, True], results[ov, False]),
                    f"rank {mesh.rank} {name} overlap={ov}: pipeline on and off differ")
        del results
        ws = pf.parallel_fmm_velocity(sing, p, mesh, plan)
        err_sing = rel_l2(gather_particle_values(ws, index)[picked].to(torch.complex128),
                          exact)
        require(err_sing < FMM_TOL, f"rank {mesh.rank} {name}: singular rel L2 vs f64 "
                                    f"{err_sing} >= {FMM_TOL}")
        rec["rel_l2_singular_vs_f64"] = err_sing
        del ws
        shapes = strip_checks(tree, plan, mesh, p)
        if mesh.rank == 0:
            for k, v in shapes.items():
                require(v["plain_max_abs"] > 0, f"{name} {k}: the plain version is all 0")
                require(v["rel_l2"] <= KERNEL_TOL,
                        f"{name} {k} {v['shape']}: rel L2 {v['rel_l2']} > {KERNEL_TOL}")
            rec["shapes_vs_plain"] = shapes
        out["plans"][name] = rec
    del serial, sing
    # -- the stepper on the 2x2 grid ------------------------------------
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)
    ids = np.arange(len(pos), dtype=np.int32)
    st = VortexStepper(pos, gamma, sigma, p=p, dt=DT, mesh=mesh, plan_grid=SHARDED_GRID,
                       payload={"r0": r0 + 0j, "id": ids},
                       checkpoint_dir=spec["ck_dir"], **STEPPER_KW)
    require((st.params.level, st.params.slots) == (level, SLOTS),
            f"sharded stepper tree {dataclasses.asdict(st.params)}")
    zero_fmm_counts()
    ops.PLAIN_CALLS = 0
    want = {"p2p": {"base": 0}, "m2l": 0}
    recs, own_ms = [], []
    for _ in range(STEPPER_STEPS):
        per_eval = pf.kernel_launches(st.plan)
        want["p2p"]["base"] += 2 * per_eval["p2p"]
        want["m2l"] += 2 * per_eval["m2l"]
        rec, ms = host_ms(st.step)
        recs.append(rec)
        own_ms.append(ms)
    counts, plain_calls = fmm_counts(), ops.PLAIN_CALLS
    require(counts == want and plain_calls == 0,
            f"rank {mesh.rank} stepper launches {counts}, plain {plain_calls}; "
            f"expected {want}")
    for rec in recs:
        require(rec.recovered == "" and hw.ok(hw.unpack(rec.health)),
                f"rank {mesh.rank} sharded step {rec.step}: {rec}")
    live = int(st.tree.mask.sum())
    require(live == CONFIG.num_particles, f"sharded stepper: {live} live particles")
    drift = orbit_drift(st)
    require(drift < DRIFT_TOL, f"sharded stepper: orbit drift {drift} >= {DRIFT_TOL}")
    st.wait_checkpoint()
    m = st.tree.mask
    by_id = torch.empty(len(pos), dtype=torch.complex64, device=dev)
    by_id[st.payload["id"][m].long()] = st.tree.z[m]
    now = [t.clone() for t in (st.tree.z, st.tree.q, st.tree.mask, st.payload["r0"],
                               st.payload["id"])]
    out["stepper"] = {
        "records": [dataclasses.asdict(r) for r in recs], "plan": st.plan.describe(),
        "z_by_id": by_id.cpu().numpy(), "own_step_ms": own_ms, "drift": drift,
        "live": live, "launches": counts}
    del st
    # -- restore onto a world of 2 ----------------------------------------
    two = make_group_mesh(range(2), device=dev)
    if two is not None:
        back, ms = host_ms(lambda: VortexStepper.from_checkpoint(spec["ck_dir"],
                                                                 mesh=two))
        again = (back.tree.z, back.tree.q, back.tree.mask, back.payload["r0"],
                 back.payload["id"])
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(again, now))
        require(same and back.step_count == STEPPER_STEPS and back.nparts == 2,
                f"rank {mesh.rank}: from_checkpoint onto 2 ranks is not bit for bit")
        out["restore_onto_2"] = {"bit_for_bit": same, "host_ms": ms,
                                 "plan": back.plan.describe()}
        out["restore_log"] = list(two.log.events)
        del back
    del now
    mesh.barrier()
    # -- the grid-bound halo drill of the reference's fault tests ---------
    rng = np.random.default_rng(1)
    spos, sgamma = 0.02 + 0.96 * rng.random((300, 2)), rng.standard_normal(300) * 0.1
    drill = VortexStepper(spos, sgamma, 0.02, p=6, dt=0.002, mesh=mesh,
                          plan_grid=SHARDED_GRID, target_per_box=3.0,
                          policy=RecoveryPolicy(expand_domain=False),
                          faults=FaultInjector(FaultSpec("halo_nan", step=2, sticky=True,
                                                         only_grid=SHARDED_GRID)))
    drecs = [drill.step() for _ in range(3)]
    rungs = [r.recovered for r in drecs]
    require(rungs == ["", "plan_slab", ""] and drecs[1].replanned,
            f"rank {mesh.rank} grid-bound halo drill recorded {rungs}")
    out["drill"] = {"recovered": rungs, "plan_after": drill.plan.describe(),
                    "step_ms": [r.seconds * 1e3 for r in drecs]}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["mesh_log"] = list(mesh.log.events)
    return out


def sharded_plans(index, p) -> dict:
    """Phase 4c's two plans, as every rank builds them."""
    params = ModelParams(level=CONFIG.level, cut=PLAN_CUT, p=p, slots=SLOTS)
    return {"uniform_slab": fmm_plan.uniform_plan(CONFIG.level, RANKS),
            "model_block_2x2": fmm_plan.plan_from_counts(index.counts, params, RANKS,
                                                         grid=SHARDED_GRID)}


def schedule_checks(ranks, pos, gamma, sigma, p) -> dict:
    """Phase 4c's schedules: the ranks' whole mesh logs (and the 2-rank
    restore's) through the collective-schedule verifier, and each counted
    evaluation's schedule against ``schedule.simulate``'s for the same plan
    and order on dry meshes on the card, event for event."""
    t0 = time.perf_counter()
    rep = sched.verify_schedules([r["mesh_log"] for r in ranks], label="sharded ranks")
    require(rep.ok, "phase 4c's rank schedules disagree:\n" + "\n".join(rep.problems[:20]))
    two = [r["restore_log"] for r in ranks if "restore_log" in r]
    rep2 = sched.verify_schedules(two, label="restore onto 2")
    require(len(two) == 2 and rep2.ok, "the 2-rank restore's schedules disagree:\n"
            + "\n".join(rep2.problems[:20]))
    tree, index = build_tree(pos, gamma, level=CONFIG.level, sigma=sigma, slots=SLOTS)
    compared = 0
    for name, plan in sharded_plans(index, p).items():
        for ov, pipe in ORDERS:
            key = f"{name} overlap={ov} pipeline={pipe}"
            dry = sched.simulate(pf.parallel_fmm_velocity, RANKS, tree, p, plan=plan,
                                 overlap=ov, pipeline=pipe, with_health=True)
            for r in ranks:
                diff = sched.same_schedule(r["schedules"][key], dry[r["rank"]])
                require(diff is None, f"rank {r['rank']} {key}: the real schedule and "
                                      f"the dry one differ at {diff}")
                compared += len(dry[r["rank"]])
            require(sched.verify_schedules(dry, label=key).ok, f"dry {key} disagrees")
    del tree
    torch.cuda.empty_cache()
    per_rank = {r["rank"]: sched.counts_text(r["mesh_log"]) for r in ranks}
    for rank, text in per_rank.items():
        print(f"sharded rank {rank} schedule: {text}", flush=True)
    return {"ranks_agree": True, "restore_onto_2_agrees": True,
            "real_equals_dry_events": compared, "per_rank": per_rank,
            "seconds": time.perf_counter() - t0}


def sharded_phase(pos, gamma, sigma, p, w_reg, sample, exact_sing, state4) -> dict:
    """Phase 4c: the sharded driver and the stepper on ``RANKS`` gloo ranks
    sharing the card.  The parent hands the ranks phase 3's serial velocity
    and f64 sums as a file, and re-runs phase 4b's stepper with particle ids
    (bit for bit phase 4b's state) to compare positions particle by
    particle.  Returns the launches counted on the ranks."""
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)
    ids = np.arange(len(pos), dtype=np.int32)
    kw = {k: v for k, v in STEPPER_KW.items() if k != "checkpoint_every"}
    serial = VortexStepper(pos, gamma, sigma, p=p, dt=DT,
                           payload={"r0": r0 + 0j, "id": ids}, **kw)
    for _ in range(STEPPER_STEPS):
        serial.step()
    require(all(torch.equal(a, b) for a, b in zip(
        (serial.tree.z, serial.tree.q, serial.tree.mask, serial.payload["r0"]), state4)),
        "the serial stepper with ids is not phase 4b's state after its four steps")
    m = serial.tree.mask
    serial_by_id = torch.empty(len(pos), dtype=torch.complex64, device=m.device)
    serial_by_id[serial.payload["id"][m].long()] = serial.tree.z[m]
    serial_by_id = serial_by_id.cpu().numpy()
    del serial, m
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="sharded_", dir=root))
    try:
        np.savez(work / "inputs.npz", pos=pos, gamma=gamma, sigma=sigma, p=p,
                 w_reg=w_reg.cpu().numpy(), sample=sample,
                 exact_sing=exact_sing.cpu().numpy())
        t0 = time.perf_counter()
        ranks = spawn_world(sharded_rank, RANKS, device="cuda", timeout_s=RANK_TIMEOUT_S,
                            args=({"inputs": str(work / "inputs.npz"),
                                   "ck_dir": str(work / "ck")},))
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    first = ranks[0]["stepper"]
    for r in ranks[1:]:
        require(r["stepper"]["records"] == first["records"]
                and r["stepper"]["plan"] == first["plan"]
                and np.array_equal(r["stepper"]["z_by_id"], first["z_by_id"]),
                f"rank {r['rank']}'s stepper differs from rank 0's")
    z_err = float(np.linalg.norm(first["z_by_id"] - serial_by_id)
                  / np.linalg.norm(serial_by_id))
    require(z_err <= KERNEL_TOL, f"sharded stepper positions vs phase 4b's: rel L2 "
                                 f"{z_err} > {KERNEL_TOL}")
    require(sum("restore_onto_2" in r for r in ranks) == 2, "restore onto 2 ranks missing")
    schedules = schedule_checks(ranks, pos, gamma, sigma, p)
    timing_keys = ("eval_host_ms", "staged_bytes", "staging_ms", "rel_l2_vs_serial",
                   "rel_l2_singular_vs_f64")
    for r in ranks:
        emit({"phase": "sharded", "rank": r["rank"], "ranks": RANKS,
              "note": f"{RANKS} ranks share one card: not a scaling result",
              "plans": {name: {k: pl[k] for k in timing_keys}
                        for name, pl in r["plans"].items()},
              "own_step_host_ms": r["stepper"]["own_step_ms"],
              "restore_onto_2_host_ms": (r.get("restore_onto_2") or {}).get("host_ms"),
              "drill_step_ms": r["drill"]["step_ms"], "peak_bytes": r["peak_bytes"]})
    print(f"{RANKS} ranks share one card: not a scaling result", flush=True)
    p2p_n = sum(pl["launches"]["p2p"]["base"] for r in ranks for pl in r["plans"].values())
    m2l_n = sum(pl["launches"]["m2l"] for r in ranks for pl in r["plans"].values())
    p2p_n += sum(r["stepper"]["launches"]["p2p"]["base"] for r in ranks)
    m2l_n += sum(r["stepper"]["launches"]["m2l"] for r in ranks)
    per_rank = {name: pl["launches"] for name, pl in ranks[0]["plans"].items()}
    shapes = {name: pl["shapes_vs_plain"] for name, pl in ranks[0]["plans"].items()}
    emit({"phase": "sharded_summary", "ranks": RANKS, "world_seconds": world_s,
          "note": f"{RANKS} ranks share one card over gloo, messages staged through "
                  f"host memory: not a scaling result",
          "plans": {name: pl["plan"] for name, pl in ranks[0]["plans"].items()},
          "launches_per_rank_per_evaluation": per_rank, "shapes_vs_plain": shapes,
          "gate": KERNEL_TOL, "stepper_positions_rel_l2_vs_serial": z_err,
          "stepper_records": first["records"], "stepper_plan": first["plan"],
          "stepper_drift": first["drift"], "stepper_launches_per_rank": first["launches"],
          "restore_onto_2": ranks[0]["restore_onto_2"], "drill": ranks[0]["drill"],
          "schedules": schedules})
    return {"p2p": p2p_n, "m2l": m2l_n, "per_rank": per_rank, "shapes": shapes}


def svc_budget(max_queue_flops: float = 1e13) -> "svc.ServiceBudget":
    return svc.ServiceBudget(max_job_flops=SVC_MAX_JOB, max_queue_flops=max_queue_flops,
                             shard_threshold_flops=SVC_SHARD_AT)


def svc_jobs(rng, count, equation, p, positions=None, targets=None) -> list:
    """``count`` one-shot jobs of ``SVC_N`` uniform sources in [0.05, 0.95]^2
    (or at ``positions``) with seeded normal strengths."""
    return [svc.FmmJob(
        positions=rng.uniform(0.05, 0.95, (SVC_N, 2)) if positions is None
        else positions[i], strength=rng.standard_normal(SVC_N), equation=equation,
        targets=targets, p=p, sigma=SVC_SIGMA, tenant=f"{equation}-{i}")
        for i in range(count)]


def svc_trees(bucket, jobs) -> list:
    """Each job's (tree, index) and (targets, index) as the engine builds them."""
    out = []
    for j in jobs:
        spec = eqs.get_equation(j.equation)
        t = build_tree(j.positions, j.strength, bucket.level, j.sigma, slots=bucket.slots,
                       charge_scale=spec.charge_scale)
        tt = None if j.targets is None else build_tree(
            j.targets, np.zeros(len(j.targets)), bucket.level, j.sigma,
            slots=bucket.tgt_slots)
        out.append((t, tt))
    return out


def svc_gather(out, index, nout: int) -> torch.Tensor:
    if nout == 1:
        return gather_particle_values(out, index)
    return torch.stack([gather_particle_values(out[..., c], index)
                        for c in range(nout)], dim=-1)


def serve_wave(engine, name: str, jobs: list) -> dict:
    """Submit ``jobs`` (one bucket), then drain them with the launch counters
    zeroed just before and read just after: exactly one P2P launch of the
    bucket's mode, one M2L launch per level 2..L, and no plain call."""
    jids = [engine.submit(j) for j in jobs]
    buckets = {r.bucket for r in engine.queue}
    require(len(engine.queue) == len(jobs) and len(buckets) == 1,
            f"wave {name}: {len(engine.queue)} jobs queued in {len(buckets)} buckets")
    bucket = engine.queue[0].bucket
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_fmm_counts()
    ops.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    engine.drain()
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t0) * 1e3
    counts, plain_calls = fmm_counts(), ops.PLAIN_CALLS
    spec = eqs.get_equation(bucket.equation)
    mode = eqs.p2p_mode(spec) + ("_passive" if bucket.tgt_slots else "")
    want = {"p2p": {mode: 1}, "m2l": bucket.level - 1}
    require(counts == want and plain_calls == 0,
            f"wave {name}: launches {counts}, plain {plain_calls}; expected {want}")
    results = [engine.result(j) for j in jids]
    return dict(wave=name, bucket=dataclasses.asdict(bucket), mode=mode,
                capacity=results[0].batch_capacity, jobs=len(jobs),
                drain_host_ms=drain_ms, peak_bytes=torch.cuda.max_memory_allocated(),
                launches=counts, results=results, key=bucket, spec=spec)


def serial_vs_batched(wave: dict, jobs: list) -> tuple[dict, tuple]:
    """Each job of ``wave`` against the serial ``fmm_evaluate`` of its own
    tree on the card (rel L2 within ``SVC_TOL``, and whether bit for bit),
    then the bucket's batched evaluation and the same jobs' serial
    evaluations timed by CUDA events in this process.  Returns the record
    and the stacked batch inputs."""
    b, spec = wave["key"], wave["spec"]
    trees = svc_trees(b, jobs)
    errs, exact = [], []
    for (t, tt), res in zip(trees, wave["results"]):
        tgt = None if tt is None else tt[0]
        serial = fmm.fmm_evaluate(t[0], b.p, eq=spec, targets=tgt)
        want = svc_gather(serial, t[1] if tt is None else tt[1], spec.nout)
        got = torch.as_tensor(res.out, device=want.device)
        errs.append(rel_l2(got, want))
        exact.append(bool(torch.equal(got, want)))
    require(max(errs) <= SVC_TOL, f"wave {wave['wave']}: batched vs serial rel L2 "
                                  f"{max(errs)} > {SVC_TOL}")
    cap = wave["capacity"]
    z, q, m = svc.stack_trees([t[0] for t, _ in trees], cap)
    if b.tgt_slots:
        tz, _, tm = svc.stack_trees([tt[0] for _, tt in trees], cap)
        batched = lambda: svc.batched_fmm_eval_targets(  # noqa: E731
            z, q, m, tz, tm, level=b.level, sigma=b.sigma, p=b.p, eq=spec)
    else:
        tz = tm = None
        batched = lambda: svc.batched_fmm_eval(  # noqa: E731
            z, q, m, level=b.level, sigma=b.sigma, p=b.p, eq=spec)

    def serial_all():
        for t, tt in trees:
            fmm.fmm_evaluate(t[0], b.p, eq=spec, targets=None if tt is None else tt[0])
    iters = 3 if b.level >= 10 else 10
    rec = {"rel_l2_vs_serial": errs, "gate_vs_serial": SVC_TOL,
           "bit_for_bit_vs_serial": exact,
           "batched_ms": cuda_ms(batched, iters=iters),
           "serial_sum_ms": cuda_ms(serial_all, iters=iters)}
    return rec, (z, q, m, tz, tm)


def check_p2p_batched(z, q, m, sigma, zt=None, mt=None, mode="base") -> dict:
    """The batched P2P launch at a bucket's shapes against its plain version
    (rel L2 within ``KERNEL_TOL``) and against one launch per grid (bit for
    bit), with both timed and the bound of the batch's live pairs."""
    pad = (0, 0, 1, 1, 1, 1)
    zh, qh, mh = F.pad(z, pad), F.pad(q, pad), F.pad(m, pad)
    B = zh.shape[0]
    call = lambda fn: fn(zh, qh, mh, sigma, zt, mt, mode)  # noqa: E731

    def per_item():
        return torch.stack([p2p.p2p_cuda(
            zh[b].clone(), qh[b].clone(), mh[b].clone(), sigma,
            None if zt is None else zt[b].clone(), None if mt is None else mt[b].clone(),
            mode) for b in range(B)])
    got, want, items = call(p2p.p2p_cuda), call(p2p.p2p_plain), per_item()
    torch.cuda.synchronize()
    live = mh[:, 1:-1, 1:-1] if mt is None else mt
    live = live if got.ndim == live.ndim else live[..., None].expand(got.shape)
    err = rel_l2(got[live], want[live])
    same = bool(torch.equal(got, items))
    name = f"p2p {mode} batch {B}"
    require(err <= KERNEL_TOL, f"{name}: rel L2 vs plain {err} > {KERNEL_TOL}")
    require(same, f"{name}: the batched launch differs from one launch per grid")
    require(bool((got[~live] == 0).all()), f"{name}: a masked target is not 0")
    ms = cuda_ms(lambda: call(p2p.p2p_cuda), iters=20)
    items_ms = cuda_ms(per_item, iters=5)
    plain_ms = cuda_ms(lambda: call(p2p.p2p_plain), iters=2, warmup=1)
    nbytes = mh.numel() + int(mh.sum()) * 16 + got.numel() * 8
    if mt is not None:
        nbytes += mt.numel() + int(mt.sum()) * 8
    pairs = sum(live_pairs(zh[b], mh[b], None if zt is None else zt[b],
                           None if mt is None else mt[b]) for b in range(B))
    per_pair = P2P_OPS[mode, sigma is None]
    b_ms, b_by = bound_ms(nbytes, pairs * per_pair)
    return dict(name="p2p", mode=mode + ("_passive" if mt is not None else ""),
                shape=list(zh.shape), out_shape=list(got.shape),
                launch=list(p2p.launch_config(zh.shape[-1], got.shape[3],
                                              p2p.MODES[mode].nout)[:3]),
                rel_l2=err, max_abs_err=float((got[live] - want[live]).abs().max()),
                bit_for_bit_per_item=same, ms=ms, per_item_ms=items_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, live_pairs=pairs,
                bytes=nbytes, ops=pairs * per_pair, library_ms=None)


def check_m2l_batched(me, level, p, eq) -> dict:
    """The batched M2L launch on a bucket's leaf stacks against its plain
    version and one launch per stack, timed, with the bound and the
    yardstick matmul of the unfolded batch."""
    me_halo = F.pad(me, (0, 0, 0, 0, ex.M2L_HALO, ex.M2L_HALO))
    stack, (PR, _), (PC, _) = ex.m2l_slab_stack(me_halo, p, 0, ex.M2L_HALO)
    W = ops.folded_operator(eq, p, level, stack.device)
    B, K = stack.shape[0], 4 * p
    per_item = lambda: torch.stack([m2l.m2l_cuda(stack[b].clone(), W)  # noqa: E731
                                    for b in range(B)])
    got, want, items = m2l.m2l_cuda(stack, W), m2l.m2l_plain(stack, W), per_item()
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    same = bool(torch.equal(got, items))
    require(err <= KERNEL_TOL, f"m2l batch {B} level {level}: rel L2 {err} > {KERNEL_TOL}")
    require(same, f"m2l batch {B} level {level}: the batched launch differs from one "
                  f"launch per stack")
    iters = 20 if level >= 8 else 100
    ms = cuda_ms(lambda: m2l.m2l_cuda(stack, W), iters=iters)
    items_ms = cuda_ms(per_item, iters=max(iters // 4, 5))
    plain_ms = cuda_ms(lambda: m2l.m2l_plain(stack, W), iters=max(iters // 10, 3))
    unfolded = torch.cat([stack[:, 1 + Dy:1 + Dy + PR, 1 + Dx:1 + Dx + PC]
                          for (Dx, Dy) in ex.PARENT_NEIGH8], dim=-1).reshape(-1, 8 * K)
    w_cat = W.reshape(8 * K, K)
    library_ms = cuda_ms(lambda: torch.matmul(unfolded, w_cat), iters=iters)
    nnz = int((W.reshape(8, 4, p, 4, p).abs().amax(dim=(2, 4)) > 0).sum())
    ops_ = B * PR * PC * nnz * p * p * 8
    nbytes = (stack.numel() + W.numel() + got.numel()) * 8
    return dict(name="m2l", level=level, p=p, equation=eq.name, shape=list(stack.shape),
                rel_l2=err, max_abs_err=float((got - want).abs().max()),
                bit_for_bit_per_item=same, ms=ms, per_item_ms=items_ms,
                plain_ms=plain_ms, **f32_product_bound(nbytes, ops_),
                library_ms=library_ms, bytes=nbytes, ops=ops_)


def probe_errors(wave: dict, jobs: list, rng) -> dict:
    """Each probe job against the float64 direct sum at ``SVC_SAMPLES``
    sampled probes (Laplace: the potential's real part and the field)."""
    probes = jobs[0].targets
    pick = np.sort(rng.choice(len(probes), SVC_SAMPLES, replace=False))
    z_at = probes[pick, 0] + 1j * probes[pick, 1]
    laplace = wave["spec"].nout == 2
    errs = []
    for j, res in zip(jobs, wave["results"]):
        exact = direct_f64(j.positions, j.strength, z_at, j.sigma, laplace=laplace)
        got = torch.as_tensor(res.out[pick], device=exact.device)
        e = ({"potential": rel_l2(got[:, 0].real.double(), exact[:, 0].real),
              "field": rel_l2(got[:, 1].to(torch.complex128), exact[:, 1])}
             if laplace else {"velocity": rel_l2(got.to(torch.complex128), exact)})
        for channel, v in e.items():
            require(v <= SVC_PROBE_TOL, f"wave {wave['wave']} {channel}: rel L2 vs f64 "
                                        f"{v} > {SVC_PROBE_TOL}")
        errs.append(e)
    return {"rel_l2_vs_f64": errs, "gate_vs_f64": SVC_PROBE_TOL, "samples": SVC_SAMPLES}


def emit_wave(wave: dict, **extra) -> dict:
    row = {k: v for k, v in wave.items() if k not in ("results", "key", "spec")}
    row.update(extra)
    emit({"phase": "fmm_serve", **row})
    return row


def serve_session(engine, pos, gamma, sigma, p, ck_dir) -> dict:
    """A paper-size trajectory session through the engine: three RK2 steps
    streamed with prefetch (2 P2P and 18 M2L launches a step), bit for bit a
    plain ``VortexStepper`` with the same arguments at every step, the
    artifact cache's hits, and ``restore_session`` bit for bit."""
    cache0 = dict(engine.cache.stats())
    sid = engine.submit(svc.FmmJob(positions=pos, strength=gamma, steps=SVC_SESSION_STEPS,
                                   p=p, dt=DT, sigma=sigma, tenant="session"))
    ses = engine.session(sid)
    require((ses.stepper.params.level, ses.stepper.params.slots) == (CONFIG.level, SLOTS),
            f"session tree {dataclasses.asdict(ses.stepper.params)}")
    plain = VortexStepper(pos, gamma, sigma, p=p, dt=DT, **SVC_SESSION_KW)
    torch.cuda.synchronize()
    zero_fmm_counts()
    ops.PLAIN_CALLS = 0
    cache_open = dict(engine.cache.stats())
    t0 = time.perf_counter()
    streamed = list(ses.stream(SVC_SESSION_STEPS, prefetch=True))
    stream_ms = (time.perf_counter() - t0) * 1e3
    counts, plain_calls = fmm_counts(), ops.PLAIN_CALLS
    want = {"p2p": {"base": 2 * SVC_SESSION_STEPS},
            "m2l": 2 * (CONFIG.level - 1) * SVC_SESSION_STEPS}
    require(counts == want and plain_calls == 0,
            f"session launches {counts}, plain {plain_calls}; expected {want}")
    cache_steps = dict(engine.cache.stats())
    require(cache_steps["hits"] - cache_open["hits"] == 2 * SVC_SESSION_STEPS
            and cache_steps["misses"] == cache_open["misses"],
            f"session steps' cache {cache_open} -> {cache_steps}: expected "
            f"{2 * SVC_SESSION_STEPS} hits and no miss")
    for i, pos_i, rec in streamed:
        plain.step()
        require(np.array_equal(pos_i, plain.particles()[0]) and hw.ok(hw.unpack(rec.health)),
                f"session step {i}: positions differ from the plain stepper's, or "
                f"health {rec.health}")
    state = (ses.stepper.tree.z, ses.stepper.tree.q, ses.stepper.tree.mask)
    require(all(torch.equal(a, b) for a, b in zip(
        state, (plain.tree.z, plain.tree.q, plain.tree.mask))),
        "the session's tree is not the plain stepper's")
    ses.stepper.save_checkpoint()
    ses.stepper.wait_checkpoint()
    (rid, restore_ms) = host_ms(lambda: engine.restore_session(ck_dir))
    back = engine.session(rid).stepper
    same = all(torch.equal(a, b) for a, b in zip(
        (back.tree.z, back.tree.q, back.tree.mask), state))
    engine.step_session(rid)
    engine.step_session(sid)
    same_step = all(torch.equal(a, b) for a, b in zip(
        (back.tree.z, back.tree.q, back.tree.mask),
        (ses.stepper.tree.z, ses.stepper.tree.q, ses.stepper.tree.mask)))
    require(same and same_step, f"restore_session: state bit for bit {same}, the next "
                                f"step bit for bit {same_step}")
    return {"phase": "fmm_serve", "wave": "session", "n": len(pos),
            "params": dataclasses.asdict(ses.stepper.params),
            "price_flops": ses.price.total_flops, "steps": SVC_SESSION_STEPS,
            "step_ms": [rec.seconds * 1e3 for _, _, rec in streamed],
            "stream_host_ms": stream_ms, "launches": counts,
            "bit_for_bit_plain_stepper": True, "cache_before": cache0,
            "cache_at_open": cache_open, "cache_after_steps": cache_steps,
            "restore_session_host_ms": restore_ms, "restore_bit_for_bit": True}


def serve_rank(mesh, spec: dict) -> dict:
    """The sharded lane on one rank: the engine on a ``RankMesh`` routes the
    lattice job (wave B's job 0) to ``parallel_fmm_evaluate`` under the
    priced plan, with exactly ``kernel_launches(plan)`` launches; then a
    two-step session on the mesh."""
    pos, gamma, sigma = lamb_oseen_particles(spec["m_side"], sigma=CONFIG.sigma,
                                             spacing_ratio=CONFIG.spacing_ratio)
    p, level = spec["p"], CONFIG.level
    engine = svc.FmmServiceEngine(mesh=mesh, budget=svc_budget(),
                                  session_kwargs=SVC_SESSION_KW)
    jid = engine.submit(svc.FmmJob(positions=pos, strength=gamma, level=level, p=p,
                                   sigma=sigma, tenant="sharded"))
    rec = engine.queue[0]
    require(rec.price.lane == "sharded", f"rank {mesh.rank}: lane {rec.price.lane}")
    counts = svc._leaf_counts(pos, level)
    params = ModelParams(level=level, cut=min(level - 1, 4), p=p,
                         slots=rec.bucket.slots, nout=1)
    plan = fmm_plan.plan_from_counts(counts, params, mesh.size, method="model")
    mesh.barrier()
    torch.cuda.synchronize()
    zero_fmm_counts()
    ops.PLAIN_CALLS = 0
    _, ms = host_ms(engine.drain)
    got, plain_calls = fmm_counts(), ops.PLAIN_CALLS
    want = pf.kernel_launches(plan)
    want = {"p2p": {"base": want["p2p"]}, "m2l": want["m2l"]}
    require(got == want and plain_calls == 0,
            f"rank {mesh.rank} sharded lane: launches {got}, plain {plain_calls}; "
            f"expected {want}")
    res = engine.result(jid)
    sid = engine.submit(svc.FmmJob(positions=pos, strength=gamma, steps=SVC_MESH_STEPS,
                                   p=p, dt=DT, sigma=sigma, tenant="mesh-session"))
    zero_fmm_counts()
    steps = list(engine.session(sid).stream(SVC_MESH_STEPS))
    st = engine.session(sid).stepper
    state = [t.cpu().numpy() for t in (st.tree.z, st.tree.q, st.tree.mask)]
    return {"rank": mesh.rank, "out": res.out, "latency_ms": res.latency_s * 1e3,
            "drain_host_ms": ms, "launches": got, "plan": plan.describe(),
            "price": dataclasses.asdict(res.price),
            "session_digest": array_digest(*state),
            "session_step_ms": [r.seconds * 1e3 for _, _, r in steps],
            "session_launches": fmm_counts(), "session_level": st.params.level,
            "session_plan": st.plan.describe(), "stats": engine.stats(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def fmm_serve_phase(dev, pos, gamma, sigma, p, w_reg_at, sample, err_reg, seed) -> dict:
    """Phase fmm_serve: ``FmmServiceEngine`` on the card.  Waves A-D, each one
    bucket drained with the launches counted (one P2P and L-1 M2L), the
    batched kernels at each bucket's shapes against their plain versions and
    one launch per grid, the whale rejected with its price, a repeat of
    wave A with fresh charges that adds no launch configuration, a deferred
    and promoted backlog, a paper-size session, and the sharded lane on
    ``RANKS`` gloo ranks.  Returns the launches and the batched rows."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    ck_dir = Path(tempfile.mkdtemp(prefix="serve_ckpt_", dir=root))
    engine = svc.FmmServiceEngine(budget=svc_budget(),
                                  session_kwargs={**SVC_SESSION_KW,
                                                  "checkpoint_dir": str(ck_dir)})
    rows, kernel_rows, launches = {}, {"p2p": [], "m2l": []}, {"p2p": {}, "m2l": 0}

    def count(wave):
        for mode, n in wave["launches"]["p2p"].items():
            launches["p2p"][mode] = launches["p2p"].get(mode, 0) + n
        launches["m2l"] += wave["launches"]["m2l"]

    try:
        # -- wave A: 8 vortex one-shots at N = 100,000, level auto, p = 17 --
        jobs_a = svc_jobs(rng, SVC_WAVE_A, "vortex", p)
        wave = serve_wave(engine, "A", jobs_a)
        require(wave["capacity"] == SVC_WAVE_A, f"wave A capacity {wave['capacity']}")
        timing, (z, q, m, _, _) = serial_vs_batched(wave, jobs_a)
        kernel_rows["p2p"].append(check_p2p_batched(z, q, m, SVC_SIGMA))
        me = fmm.upward_sweep(Tree(z=z, q=q, mask=m, level=wave["key"].level,
                                   sigma=SVC_SIGMA), p)[wave["key"].level]
        kernel_rows["m2l"].append(check_m2l_batched(me, wave["key"].level, p, VORTEX))
        del z, q, m, me
        count(wave)
        rows["A"] = emit_wave(wave, **timing)
        # -- wave B: 2 lattice jobs at the paper's size, level 10 ---------------
        jobs_b = [svc.FmmJob(positions=pos, strength=g, level=CONFIG.level, p=p,
                             sigma=sigma, tenant=f"lattice-{i}")
                  for i, g in enumerate((gamma, gamma * rng.uniform(0.5, 1.5, len(gamma))))]
        wave = serve_wave(engine, "B", jobs_b)
        b_job0 = wave["results"][0].out
        job0 = torch.as_tensor(b_job0, device=dev)
        err_phase3 = rel_l2(job0, w_reg_at)
        require(err_phase3 <= SVC_TOL, f"wave B job 0 vs phase 3's serial velocity: rel L2 "
                                       f"{err_phase3} > {SVC_TOL}")
        exact = direct_sum_f64(pos, gamma, sample, sigma)
        err_f64 = rel_l2(job0[torch.as_tensor(sample, device=dev)].to(torch.complex128),
                         exact)
        require(abs(err_f64 - err_reg) <= SVC_F64_MATCH,
                f"wave B job 0 vs f64 {err_f64}, phase 3's {err_reg}")
        timing, (z, q, m, _, _) = serial_vs_batched(wave, jobs_b)
        kernel_rows["p2p"].append(check_p2p_batched(z, q, m, sigma))
        me = fmm.upward_sweep(Tree(z=z, q=q, mask=m, level=CONFIG.level, sigma=sigma),
                              p)[CONFIG.level]
        kernel_rows["m2l"].append(check_m2l_batched(me, CONFIG.level, p, VORTEX))
        del z, q, m, me, exact
        count(wave)
        rows["B"] = emit_wave(
            wave, job0_rel_l2_vs_phase3=err_phase3,
            job0_bit_for_bit_phase3=bool(torch.equal(job0, w_reg_at)),
            job0_rel_l2_vs_f64=err_f64, phase3_rel_l2_vs_f64=err_reg, **timing)
        del job0
        torch.cuda.empty_cache()
        # -- waves C and D: Laplace and tracer at a 256 x 256 probe grid -------
        px, py = np.meshgrid(SVC_PROBES, SVC_PROBES, indexing="xy")
        probes = np.stack([px.ravel(), py.ravel()], axis=1)
        src_c = [rng.uniform(0.05, 0.95, (SVC_N, 2)) for _ in range(SVC_WAVE_C)]
        for name, eq_name, order in (("C", "laplace", SVC_P_LAPLACE),
                                     ("D", "tracer", SVC_P_LAPLACE)):
            jobs = svc_jobs(rng, SVC_WAVE_C, eq_name, order, positions=src_c,
                            targets=probes)
            wave = serve_wave(engine, name, jobs)
            errs = probe_errors(wave, jobs, rng)
            timing, (z, q, m, tz, tm) = serial_vs_batched(wave, jobs)
            spec = wave["spec"]
            kernel_rows["p2p"].append(check_p2p_batched(
                z, torch.complex(q.real, torch.zeros_like(q.real)) if spec.q_is_real else q,
                m, SVC_SIGMA, tz, tm, eqs.p2p_mode(spec)))
            if name == "C":
                me = fmm.upward_sweep(Tree(z=z, q=q, mask=m, level=wave["key"].level,
                                           sigma=SVC_SIGMA), order, eq=spec)
                kernel_rows["m2l"].append(check_m2l_batched(
                    me[wave["key"].level], wave["key"].level, order, spec))
                del me
            del z, q, m, tz, tm
            count(wave)
            rows[name] = emit_wave(wave, tgt_slots=wave["key"].tgt_slots, **errs, **timing)
        # -- admission: the whale is rejected with its price -------------------
        whale = svc.FmmJob(positions=rng.uniform(0.0, 1.0, (200_000, 2)),
                           strength=np.ones(200_000), level=12, p=24, sigma=SVC_SIGMA,
                           tenant="whale")
        try:
            engine.submit(whale)
            raise RuntimeError("the whale was not rejected")
        except svc.JobRejected as e:
            require(isinstance(e.price, svc.JobPrice)
                    and e.price.total_flops > SVC_MAX_JOB,
                    f"whale rejected at {e.price}")
            whale_price = dataclasses.asdict(e.price)
        # -- a repeat of wave A, fresh charges: no new launch configuration ----
        entries = svc.batched_cache_entries()
        caches = (ops.folded_operator.cache_info().currsize, len(m2l._SPLITS))
        repeat = [dataclasses.replace(j, strength=rng.standard_normal(SVC_N))
                  for j in jobs_a]
        wave = serve_wave(engine, "A_repeat", repeat)
        count(wave)
        after = (svc.batched_cache_entries(),
                 ops.folded_operator.cache_info().currsize, len(m2l._SPLITS))
        require(after == (entries, *caches),
                f"repeat wave grew (jit_entries, folded operators, splits) from "
                f"{(entries, *caches)} to {after}")
        rows["A_repeat"] = emit_wave(wave, jit_entries=entries,
                                     folded_operators=caches[0], splits=caches[1])
        # -- admission: a backlog deferred, then promoted -----------------------
        # the CPU test's prediction (test_backlog_defers_then_promotes): with
        # max_queue_flops 1.5 jobs' worth, the first job is admitted and each
        # later one deferred, then promoted one drain pass at a time
        before = dict(engine.counters)
        backlog = svc_jobs(rng, 3, "laplace", SVC_P_LAPLACE, positions=src_c,
                           targets=probes)
        engine.submit(backlog[0])
        per_job = engine.queue[0].price.total_flops
        engine.budget = svc_budget(max_queue_flops=1.5 * per_job)
        for j in backlog[1:]:
            engine.submit(j)
        queued = (len(engine.queue), len(engine.deferred))
        zero_fmm_counts()
        engine.drain()
        delta = {k: engine.counters[k] - before[k]
                 for k in ("submitted", "admitted", "deferred", "promoted", "batches",
                           "batched_jobs", "rejected")}
        want = {"submitted": 3, "admitted": 3, "deferred": 2, "promoted": 2,
                "batches": 3, "batched_jobs": 3, "rejected": 0}
        require(queued == (1, 2) and delta == want,
                f"backlog: queued {queued}, counters moved {delta}; expected (1, 2), {want}")
        count({"launches": fmm_counts()})
        engine.budget = svc_budget()
        emit({"phase": "fmm_serve", "wave": "admission", "whale_price": whale_price,
              "budget_max_job_flops": SVC_MAX_JOB, "backlog_queued": list(queued),
              "backlog_counters": delta, "expected": want,
              "max_queue_flops": 1.5 * per_job})
        # -- a paper-size session, streamed with prefetch ------------------------
        rows["session"] = serve_session(engine, pos, gamma, sigma, p, str(ck_dir))
        emit(rows["session"])
        for mode, n in rows["session"]["launches"]["p2p"].items():
            launches["p2p"][mode] = launches["p2p"].get(mode, 0) + n
        launches["m2l"] += rows["session"]["launches"]["m2l"]
        stats = engine.stats()
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()
    # -- the sharded lane and a session on RANKS gloo ranks sharing the card ---
    t0 = time.perf_counter()
    ranks = spawn_world(serve_rank, RANKS, device="cuda", timeout_s=RANK_TIMEOUT_S,
                        args=({"m_side": int(round(CONFIG.num_particles ** 0.5)),
                               "p": p},))
    world_s = time.perf_counter() - t0
    first = ranks[0]
    for r in ranks[1:]:
        require(np.array_equal(r["out"], first["out"])
                and r["session_digest"] == first["session_digest"],
                f"rank {r['rank']}'s sharded result or session differs from rank 0's")
    sharded_err = rel_l2(torch.as_tensor(first["out"]), torch.as_tensor(b_job0))
    require(sharded_err <= SVC_TOL, f"sharded lane vs wave B's batched job 0: rel L2 "
                                    f"{sharded_err} > {SVC_TOL}")
    for r in ranks:
        launches["p2p"]["base"] = launches["p2p"].get("base", 0) + \
            r["launches"]["p2p"]["base"] + r["session_launches"]["p2p"].get("base", 0)
        launches["m2l"] += r["launches"]["m2l"] + r["session_launches"]["m2l"]
    emit({"phase": "fmm_serve", "wave": "sharded", "ranks": RANKS,
          "note": f"{RANKS} ranks share one card over gloo: not a scaling result",
          "world_seconds": world_s, "plan": first["plan"], "price": first["price"],
          "launches_per_rank": first["launches"],
          "rel_l2_vs_wave_b_batched": sharded_err, "gate": SVC_TOL,
          "bit_for_bit_across_ranks": True,
          "drain_host_ms": [r["drain_host_ms"] for r in ranks],
          "latency_ms": [r["latency_ms"] for r in ranks],
          "session_level": first["session_level"], "session_plan": first["session_plan"],
          "session_step_ms": [r["session_step_ms"] for r in ranks],
          "session_launches_per_rank": first["session_launches"],
          "session_bit_for_bit_across_ranks": True,
          "peak_bytes": [r["peak_bytes"] for r in ranks]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "fmm_serve_summary", "seconds": seconds,
          "latency": stats["latency"], "batch_utilization": stats["batch_utilization"],
          "cache": stats["cache"], "jit_entries": stats["jit_entries"],
          "counters": {k: v for k, v in stats.items()
                       if k not in ("latency", "cache", "batch_utilization", "jit_entries")},
          "buckets": {k: {"shape": [v["capacity"], 1 << v["bucket"]["level"],
                                    1 << v["bucket"]["level"], v["bucket"]["slots"]],
                          "drain_host_ms": v["drain_host_ms"],
                          "batched_ms": v.get("batched_ms"),
                          "serial_sum_ms": v.get("serial_sum_ms"),
                          "peak_bytes": v["peak_bytes"]}
                      for k, v in rows.items() if k in ("A", "B", "C", "D", "A_repeat")}})
    buckets = {k: {"shape": [v["capacity"], 1 << v["bucket"]["level"],
                             1 << v["bucket"]["level"], v["bucket"]["slots"]],
                   "tgt_slots": v["bucket"]["tgt_slots"], "launches": v["launches"]}
               for k, v in rows.items() if k in ("A", "B", "C", "D", "A_repeat")}
    return {"launches": launches, "kernel_rows": kernel_rows, "buckets": buckets}


def stage_ms(tree, p) -> dict:
    """CUDA-event milliseconds per stage of one velocity evaluation plus one
    rebin, through the port's stage functions."""
    marks: dict[str, list] = {}

    def timed(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        marks.setdefault(name, []).append((a, b))
        return out

    L = tree.level
    me = timed("upward_p2m_m2m", lambda: fmm.upward_sweep(tree, p))
    m2l_fn = fmm.m2l_grid_fn(p)
    le = [None] * (L + 1)
    for lv in range(2, L + 1):
        le[lv] = timed("m2l", lambda: m2l_fn(me[lv], lv))
        if lv > 2:
            le[lv] = le[lv] + timed("l2l", lambda: ex.l2l(le[lv - 1], p))
    centers = torch.as_tensor(box_centers(L), dtype=torch.complex64, device=tree.device)
    timed("l2p", lambda: ex.l2p_eval(le[L], tree.z, centers, box_size(L), p,
                                     compute=ops.l2p_apply))
    timed("p2p", lambda: fmm.near_field(tree))
    timed("rebuild_tree", lambda: rebuild_tree(tree, tree.z))
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}


def device_profile(fn, share_of: tuple[str, ...] = ()) -> dict:
    """torch.profiler over one call of ``fn``: device time by kernel name,
    the share of the device span in which no kernel or copy ran and, for
    each string of ``share_of``, the time and share of device busy time in
    kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a profiler range (the port's spans, a caller's record_function) may show
    # on the device's timeline as an annotation spanning the kernels it
    # launched: it is no operation, so it counts as no busy time
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return {"device_profile": "not measured: the profiler recorded no device events"}
    by_name: dict[str, float] = {}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
           "idle_share": 1.0 - busy / span, "device_events": len(spans),
           "top_ms": [[name[:100], us / 1e3] for name, us in top]}
    for part in share_of:
        mine = sum(us for name, us in by_name.items() if part in name)
        out[f"{part}_ms"] = mine / 1e3
        out[f"{part}_share_of_busy"] = mine / busy
    return out


def causal_pairs(T: int, S: int, causal: bool) -> int:
    """(query, key) pairs the top-left mask leaves visible."""
    if not causal:
        return T * S
    n = min(T, S)
    return n * (n + 1) // 2 + max(T - S, 0) * S


def zero_flash_counts() -> None:
    flash_attn.LAUNCHES = flash_attn.TC_LAUNCHES = flash_attn.TF32_LAUNCHES = 0


def flash_counts() -> dict:
    return {"tc": flash_attn.TC_LAUNCHES, "tf32": flash_attn.TF32_LAUNCHES,
            "simt": flash_attn.LAUNCHES}


def flash_bound(B, H, Hkv, T, S, d, causal, dtype) -> dict:
    """The least time of one attention on the card: its visible pairs' QK^T
    and PV (2 FLOP an FMA) at the dtype's tensor-core peak (f32 as three
    TF32 passes) against q, k, v and out read or written once."""
    ops_ = 4 * d * B * H * causal_pairs(T, S, causal)
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * B * H * T * d + 2 * B * Hkv * S * d) * size
    if dtype == torch.bfloat16:
        b_ms, b_by = bound_ms(nbytes, ops_, BF16_FLOP_PER_S)
        bound = dict(bound_ms=b_ms, bound_by=b_by,
                     fp32_simt_bound_ms=ops_ / FP32_FLOP_PER_S * 1e3)
    else:
        bound = f32_product_bound(nbytes, ops_)
    return {**bound, "ops": ops_, "bytes": nbytes}


def check_flash(name, kernel, B, H, Hkv, T, S, d, causal, dtype, gen, timed: bool,
                main_path: bool = False, views: bool = False):
    """``kernel`` against the plain version; the call must make exactly one
    flash launch.  With ``main_path`` the launch counters are zeroed before
    its first call and read after it; with ``views`` q, k and v are the
    model's ``(B, T, H, d) -> (B, H, T, d)`` views.  A simt launch is made
    twice and must give the same bits."""
    dev = torch.device("cuda")

    def make(h, n):
        if views:
            return torch.randn((B, n, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        return torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
    q, k, v = make(H, T), make(Hkv, S), make(Hkv, S)
    torch.cuda.synchronize()
    if main_path:
        zero_flash_counts()
    before = flash_counts()
    got = kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    counts = flash_counts()
    made = {r: counts[r] - before[r] for r in counts}
    require(sum(made.values()) == 1, f"{name}: one call made flash launches {made}")
    simt = made["simt"] == 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = rel_l2(got.float(), want.float())
    max_abs = float((got.float() - want.float()).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    tol = ATTN_TOL[dtype]
    shape = [B, H, Hkv, T, S, d]
    require(err <= tol, f"{name} {shape} {dtype}: rel L2 {err} > {tol}")
    row = dict(name=name, shape=shape, causal=causal, dtype=str(dtype),
               rel_l2=err, gate=tol, max_abs_err=max_abs)
    if simt:
        again = kernel(q, k, v, causal=causal)
        torch.cuda.synchronize()
        require(torch.equal(again, got), f"{name} {shape} {dtype}: a second launch differs")
        row.update(bitwise_repeat=True, views=views,
                   launch=flash_attn.simt_launch_config(d, dtype, (B, H, T, S, causal)))
    if main_path:
        row["launches"] = counts
    if not timed:
        return row
    bound = flash_bound(B, H, Hkv, T, S, d, causal, dtype)
    ke = k.repeat_interleave(H // Hkv, dim=1)                 # yardstick only
    ve = v.repeat_interleave(H // Hkv, dim=1)
    lib = F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
    if not simt:
        # a tensor-core route: the model's (B, T, H, d) -> (B, H, T, d)
        # views, and the simt kernel on the same inputs
        qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
        got_v = kernel(qv, kv, vv, causal=causal)
        torch.cuda.synchronize()
        err_v = rel_l2(got_v.float(), want.float())
        require(bool(torch.isfinite(got_v).all()), f"{name} strided views: non-finite output")
        require(err_v <= tol, f"{name} {shape} strided views: rel L2 {err_v} > {tol}")
        row.update(
            strided_ms=cuda_ms(lambda: kernel(qv, kv, vv, causal=causal), iters=20),
            strided_rel_l2=err_v,
            strided_max_abs_err=float((got_v.float() - want.float()).abs().max()),
            simt_ms_same_inputs=cuda_ms(
                lambda: flash_attn.flash_attention_cuda(q, k, v, causal=causal), iters=10))
    row.update(
        ms=cuda_ms(lambda: kernel(q, k, v, causal=causal), iters=20),
        plain_ms=cuda_ms(lambda: flash_attn.flash_attention_plain(q, k, v, causal=causal),
                         iters=3, warmup=1),
        **bound,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal), iters=20),
        library_rel_l2=rel_l2(lib.float(), want.float()))
    return row


def random_model(cfg, dev):
    """``init_params`` on the card from a generator seeded with 0.  Returns
    (params, the generator, seconds, parameter count); the count must be
    what the same call gives on the meta device (``cfg.param_count`` is
    analytic, and crude for the hybrid and the SSM family)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in param_tensors(params))
    meta = sum(t.numel() for t in param_tensors(init_params(cfg, torch.Generator(), "meta")))
    require(n_params == meta, f"{cfg.name}: {n_params} parameters, the meta device "
            f"gives {meta}")
    return params, gen, init_s, n_params


def generate_with_patches(engine, prompts, patches, new: int) -> np.ndarray:
    """A vlm user's greedy loop: ``prefill_step`` with the patch embeddings
    before the text, then ``decode_step`` at the positions after both, as
    ``step_all`` does for text."""
    B, T = prompts.shape
    P = patches.shape[1]
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=engine.device)
        caches = init_cache(engine.cfg, B, engine.max_len, device=engine.device)
        logits, caches = engine.prefill_fn(engine.params, tokens, caches,
                                           patch_embeds=patches)
        tok = torch.argmax(logits, dim=-1)
        outs = []
        for t in range(new):
            outs.append(tok)
            logits, caches = engine.decode_fn(engine.params, tok[:, None], P + T + t,
                                              caches)
            tok = torch.argmax(logits, dim=-1)
        return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()


def teacher_forced(params, cfg, full, patches=None):
    """The last position's logits of one ``forward`` over ``full`` (the
    patches first)."""
    with torch.inference_mode():
        h, _ = forward(params, full, cfg, patch_embeds=patches)
        return unembed(params, h[:, -1:], cfg)[:, 0]


def cast_(tree, dtype) -> None:
    """Every tensor of a parameter tree to ``dtype``, in place in the tree,
    one at a time (the old tensor is freed as its copy replaces it)."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if torch.is_tensor(v):
            tree[k] = v.to(dtype)
        else:
            cast_(v, dtype)


def decode_gate(engine, prompts, out, chose_last, patches=None, f64: bool = False) -> dict:
    """Hold ``chose_last``, the decode logits that chose ``out[:, -1]``, to
    a teacher-forced ``forward`` over prompt + ``out[:, :-1]`` (the same
    patches first): rel L2 within ``SERVE_TOL``, every logit finite.

    The gate must also refuse a planted fault: the same decode step on a
    cache that never saw the prompt (a KV cache or recurrent state not
    carried from prefill into decode) must land further than ``SERVE_TOL``
    from the forced logits.

    With ``f64`` the forced forward runs once more in f64 (the weights cast
    in place, the engine not used again), and the record says how far the
    f32 decode and the f32 forced forward each sit from it: which side
    carries the decode-vs-forced distance."""
    params, cfg, dev = engine.params, engine.cfg, engine.device
    n_patches = 0 if patches is None else patches.shape[1]
    full = torch.cat([torch.as_tensor(prompts, device=dev),
                      torch.as_tensor(out[:, :-1], device=dev)], dim=1).long()
    forced = teacher_forced(params, cfg, full, patches)
    with torch.inference_mode():
        fresh = init_cache(cfg, full.shape[0], engine.max_len, device=dev)
        fault, _ = engine.decode_fn(params, full[:, -1:], n_patches + full.shape[1] - 1,
                                    fresh)
        del fresh
    torch.cuda.synchronize()
    err, fault_err = rel_l2(chose_last, forced), rel_l2(fault, forced)
    require(bool(torch.isfinite(forced).all()), f"{cfg.name}: non-finite teacher-forced logits")
    require(err <= SERVE_TOL, f"{cfg.name}: decode vs teacher-forced logits rel L2 "
            f"{err} > {SERVE_TOL}")
    require(fault_err > SERVE_TOL, f"{cfg.name}: decode on a cache that never saw the "
            f"prompt is {fault_err} from the teacher-forced logits, within the gate "
            f"{SERVE_TOL}")
    record = {"rel_l2_decode_vs_forced": err, "gate": SERVE_TOL,
              "forced_tokens": full.shape[1] + n_patches,
              "last_token_agreement_info": float(
                  (forced.argmax(-1).cpu().numpy() == out[:, -1]).mean()),
              "fault_rel_l2_fresh_cache": fault_err}
    if f64:
        t0 = time.perf_counter()
        cast_(params, torch.float64)
        forced64 = teacher_forced(params, dataclasses.replace(
            cfg, dtype="float64", score_dtype="float64"), full,
            None if patches is None else patches.double())
        record["f64_forced"] = {
            "rel_l2_decode_f32_vs_f64": rel_l2(chose_last.double(), forced64),
            "rel_l2_forced_f32_vs_f64": rel_l2(forced.double(), forced64),
            "seconds": time.perf_counter() - t0}
        del forced64
    return record


def serve_once(dev, params, cfg, prompts, new, max_len, *, patches=None,
               gate: bool = True, profile: bool = False, f64: bool = False):
    """Serve ``prompts`` behind ``ServeEngine`` (``step_all``, or with
    ``patches`` the vlm loop over ``prefill_step``/``decode_step``) after a
    2-token warm-up, the flash counters zeroed just before and read just
    after.  Every logit must be finite and every token in range; with
    ``gate``, ``decode_gate`` holds the decode to a teacher-forced forward
    (and with ``f64`` also to the same forward in f64).
    With ``profile``, one more prefill and one decode step run under
    torch.profiler (``device_profile``).  Returns (record, flash launches,
    engine)."""
    batch, prompt = prompts.shape
    engine = ServeEngine(params, cfg, batch_slots=batch, max_len=max_len, device=dev)

    # time each prefill/decode call with CUDA events and keep its logits
    marks: dict[str, list] = {"prefill": [], "decode": []}
    logits_seen: list[torch.Tensor] = []

    def timed(name, fn):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            marks[name].append((a, b))
            logits_seen.append(out[0])
            return out
        return call

    def generate(n):
        if patches is None:
            return engine.step_all(prompts, n)
        return generate_with_patches(engine, prompts, patches, n)

    prefill_fn, decode_fn = engine.prefill_fn, engine.decode_fn
    engine.prefill_fn = timed("prefill", prefill_fn)
    engine.decode_fn = timed("decode", decode_fn)
    generate(2)                                      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    for v in marks.values():
        v.clear()
    logits_seen.clear()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_flash_counts()
    t0 = time.perf_counter()
    out = generate(new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    engine.prefill_fn, engine.decode_fn = prefill_fn, decode_fn

    require(out.shape == (batch, new), f"{cfg.name}: served {out.shape}")
    require(bool((out >= 0).all() and (out < cfg.vocab).all()),
            f"{cfg.name}: token id out of range")
    require(all(bool(torch.isfinite(x).all()) for x in logits_seen),
            f"{cfg.name}: non-finite logits")
    prefill_ms = sum(a.elapsed_time(b) for a, b in marks["prefill"])
    decode_ms = [a.elapsed_time(b) for a, b in marks["decode"]]
    decode_step_ms = sum(decode_ms) / len(decode_ms)
    n_patches = 0 if patches is None else patches.shape[1]
    record = {"batch": batch, "prompt": prompt, "patches": n_patches, "new": new,
              "max_len": max_len, "step_all_s": total_s, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_step_ms, "decode_steps": len(decode_ms),
              "generated_tok_per_s": batch * new / total_s,
              "prompt_tok_per_s": batch * (prompt + n_patches) / (prefill_ms / 1e3),
              "decode_tok_per_s": batch / (decode_step_ms / 1e3),
              "peak_bytes": peak, "flash_launches": launches,
              "first_tokens": out[0, :8].tolist()}
    if profile:
        tokens = torch.as_tensor(prompts, device=dev).long()
        caches = init_cache(cfg, batch, max_len, device=dev)
        record["prefill_profile"] = device_profile(
            lambda: engine.prefill_fn(params, tokens, caches, patch_embeds=patches),
            share_of=("flash_attn_tc", "copy"))
        first = torch.as_tensor(out[:, :1], device=dev).long()
        record["decode_profile"] = device_profile(
            lambda: engine.decode_fn(params, first, prompt + n_patches, caches))
        del caches
    if gate:
        # logits_seen[-2]: the decode step that produced out[:, -1]
        record.update(decode_gate(engine, prompts, out, logits_seen[-2], patches, f64))
    return record, launches, engine


def decode_step_bytes(engine, prompts, base: int) -> dict:
    """The bytes of one ``decode_step`` at position ``T`` after a prefill of
    ``prompts`` (phase dryrun's part (b)): ``max_memory_allocated`` after
    ``reset_peak_memory_stats`` with the parameters, the caches and the
    token resident, less ``base`` (what was allocated before the model
    was drawn)."""
    B, T = prompts.shape
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=engine.device).long()
        caches = engine.init_cache(B)
        logits, caches = engine.prefill_fn(engine.params, tokens, caches)
        tok = torch.argmax(logits, dim=-1)[:, None]
        del logits, tokens
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = engine.decode_fn(engine.params, tok, T, caches)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out, caches
    return {"batch": B, "pos": T, "max_len": engine.max_len,
            "resident_bytes": resident - base, "peak_bytes": peak - base}


def serve_phase(dev, cfg, batch, prompt, new, max_len, profile: bool,
                other_route: str | None = None,
                decode_bytes: bool = False) -> tuple[dict, dict]:
    """``cfg`` behind ServeEngine.step_all; returns the phase's record and
    the launches of each flash kernel counted inside step_all.  With
    ``other_route``, after the counted run, one prefill is timed on the
    route ``flash_attn.route`` names and on ``other_route``, alternately.
    With ``decode_bytes``, the record's ``decode_step`` holds one decode
    step's bytes (:func:`decode_step_bytes`)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, _, init_s, n_params = random_model(cfg, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)
    served, launches, engine = serve_once(dev, params, cfg, prompts, new, max_len,
                                          profile=profile)
    record = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
              "params": n_params, "init_params_s": init_s, **served}
    if other_route is not None:
        tokens = torch.as_tensor(prompts, device=dev).long()
        caches = init_cache(cfg, batch, max_len, device=dev)
        record["prefill_ms_by_route"] = prefill_by_route(
            lambda: engine.prefill_fn(params, tokens, caches), other_route)
    if decode_bytes:
        record["decode_step"] = decode_step_bytes(engine, prompts, base)
    return record, launches


def serve_families_phase(dev) -> dict:
    """Every LM family beyond dense Yi-6B at full width (``FAMILY_RUNS``),
    random bf16 weights from a seeded generator: batch 4, prompts of 2048
    positions, 8 greedy tokens, timed, every logit finite.  Each prefill
    must make exactly the table's ``tc`` flash launches and no other.

    The gate runs in f32, where the deep stacks do not amplify rounding:
    the same weights cast in place and served again, each prefill on the
    3xTF32 kernel instead, and ``decode_gate`` holds the decode to a
    teacher-forced forward at the fixed ``SERVE_TOL``.  An MoE model is
    gated at batch 1 and capacity factor E / k: a token's k experts are
    distinct, so capacity N over N tokens drops nothing in decode or in
    the forced forward.  The SSM's gate also runs the forced forward in f64
    (``decode_gate``'s ``f64``).  Returns the tc and tf32 launches made."""
    rows, tc, tf32, tf32_d256 = [], 0, 0, 0
    for arch, layers, want, patches in FAMILY_RUNS:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        attn_layers = sum(k in ("attn", "moe") for k in transformer.layer_kinds(cfg))
        require(attn_layers == want, f"{arch}: {attn_layers} attention layers, "
                f"the table says {want}")
        params, gen, init_s, n_params = random_model(cfg, dev)
        rng = np.random.default_rng(0)
        text = FAMILY_PROMPT - (cfg.num_patches if patches else 0)
        prompts = rng.integers(0, cfg.vocab, (FAMILY_BATCH, text)).astype(np.int32)
        pe = None
        if patches:
            pe = torch.randn((FAMILY_BATCH, cfg.num_patches, cfg.patch_dim),
                             generator=gen, device=dev).to(getattr(torch, cfg.dtype))
        max_len = FAMILY_PROMPT + FAMILY_NEW
        record, launches, engine = serve_once(dev, params, cfg, prompts, FAMILY_NEW,
                                              max_len, patches=pe, gate=False,
                                              profile=True)
        del engine
        require(launches == {"tc": want, "tf32": 0, "simt": 0},
                f"{arch}: flash launches in one prefill {launches}, expected {want} "
                f"tc launches and no other")
        tc += launches["tc"]

        cast_(params, torch.float32)
        cfg32, n = dataclasses.replace(cfg, dtype="float32"), FAMILY_BATCH
        if cfg.family == "moe":
            m, n = cfg.moe, 1
            cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
                m, capacity_factor=m.num_experts / m.top_k))
            forced_n = FAMILY_PROMPT + FAMILY_NEW - 1
            require(moe.capacity(forced_n, cfg32) >= forced_n,
                    f"{arch}: capacity {moe.capacity(forced_n, cfg32)} < {forced_n}")
        gated, l32, engine = serve_once(dev, params, cfg32, prompts[:n], FAMILY_NEW,
                                        max_len, patches=None if pe is None
                                        else pe[:n].float(), f64=cfg.family == "ssm")
        del engine
        require(l32 == {"tc": 0, "tf32": want, "simt": 0},
                f"{arch}: f32 flash launches in one prefill {l32}, expected {want} "
                f"3xTF32 launches and no other")
        tf32 += l32["tf32"]
        row = {"arch": arch, "family": cfg.family, "dtype": cfg.dtype,
               "layers": cfg.num_layers, "of_layers": full.num_layers,
               "d_model": cfg.d_model, "head_dim": cfg.head_dim_, "params": n_params,
               "param_count_analytic_info": cfg.param_count, "init_params_s": init_s,
               **record, "f32_gate": {"capacity_factor": None if cfg.moe is None
                                      else cfg32.moe.capacity_factor, **gated}}
        if cfg.head_dim_ == 256:
            tf32_d256 += l32["tf32"]
        if cfg.rglru is not None:
            row["window"] = cfg.rglru.window
        emit({"phase": "serve_families", **row})
        rows.append(row)
        del params, pe
        torch.cuda.empty_cache()
    return {"rows": rows, "tc": tc, "tf32": tf32, "tf32_d256": tf32_d256}


def prefill_by_route(prefill, other: str) -> dict:
    """One prefill's CUDA-event ms on the dispatcher's own route and on
    ``other`` (``flash_attn.route`` swapped for the call), in the order
    own, other, other, own; not counted as main-path launches."""
    own_route = flash_attn.route
    times: dict[str, list[float]] = {"own": [], other: []}
    try:
        for which in ("own", other, other, "own"):
            flash_attn.route = own_route if which == "own" else (lambda q, k: other)
            prefill()                                    # warm
            times[which].append(cuda_ms(prefill, iters=1, warmup=0))
    finally:
        flash_attn.route = own_route
    return times


def wide_jobs(seed):
    """The jobs the card route refused before the kernels took any slot
    count and order (ROADMAP Queue 3): 400 particles clustered in one leaf
    box plus two far ones (bucket slots 512), 2,000 uniform ones at p = 40,
    and an ordinary job; ``tests/test_torch_fmm_service.py`` holds the CPU
    engine to the reference's on them."""
    rng = np.random.default_rng(seed)
    pos = np.vstack([0.5 + 0.0625 * rng.random((400, 2)), [[0.05, 0.05], [0.95, 0.95]]])
    clustered = dict(positions=pos, strength=rng.normal(size=402), sigma=WIDE_SIGMA)
    rng = np.random.default_rng(seed + 1)
    deep = dict(positions=rng.uniform(size=(2000, 2)), strength=rng.normal(size=2000),
                p=40, sigma=WIDE_SIGMA)
    rng = np.random.default_rng(seed + 2)
    ordinary = dict(positions=rng.uniform(0.1, 0.9, size=(220, 2)),
                    strength=rng.normal(size=220), sigma=WIDE_SIGMA)
    return [clustered, deep, ordinary]


def wide_jobs_phase(dev, seed) -> dict:
    """Phase fmm_serve_wide: the three jobs of :func:`wide_jobs` in one drain
    on the card (three buckets), counted: the clustered bucket is P2P's
    streaming form, the p = 40 bucket M2L's wide form at levels 2..4; no
    plain call, every job served, each within 1e-5 of the CPU engine."""
    outs, buckets = {}, None
    for where in ("cpu", dev):
        engine = svc.FmmServiceEngine(device=where)
        jids = [engine.submit(svc.FmmJob(**kw)) for kw in wide_jobs(seed)]
        buckets = [dataclasses.asdict(r.bucket) for r in engine.queue]
        if where != "cpu":
            torch.cuda.synchronize()
            zero_fmm_counts()
            ops.PLAIN_CALLS = 0
        t0 = time.perf_counter()
        engine.drain()
        if where != "cpu":
            torch.cuda.synchronize()
            drain_ms = (time.perf_counter() - t0) * 1e3
            counts = {"p2p": fmm_counts()["p2p"], "m2l": m2l.LAUNCHES,
                      "p2p_stream": p2p.STREAM_LAUNCHES, "m2l_wide": m2l.WIDE_LAUNCHES,
                      "plain": ops.PLAIN_CALLS}
        require(not engine.queue and engine.counters["batches"] == 3,
                f"wide jobs on {where}: {len(engine.queue)} left, counters "
                f"{engine.counters}")
        outs[str(where)] = [engine.result(j).out for j in jids]
    shapes = [(b["level"], b["slots"], b["p"]) for b in buckets]
    require(shapes == [(3, 512, 12), (4, 32, 40), (2, 32, 12)],
            f"wide jobs' buckets {shapes}")
    want = {"p2p": {"base": 3}, "m2l": sum(b[0] - 1 for b in shapes),
            "p2p_stream": 1, "m2l_wide": 3, "plain": 0}
    require(counts == want, f"wide jobs' launches {counts}, expected {want}")
    errs = []
    for got, cpu in zip(outs[str(dev)], outs["cpu"]):
        require(got.shape == cpu.shape and np.isfinite(got).all(),
                "a wide job's output is not finite or has the wrong shape")
        errs.append(float(np.linalg.norm(got - cpu) / np.linalg.norm(cpu)))
    require(max(errs) <= KERNEL_TOL, f"wide jobs vs the CPU engine: rel L2 {errs}")
    emit({"phase": "fmm_serve_wide", "buckets": shapes, "launches": counts,
          "rel_l2_vs_cpu_engine": errs, "gate": KERNEL_TOL, "drain_host_ms": drain_ms})
    return counts


def drill_config(coord: str, m_side: int, p: int, spec: dict) -> "sv.SupervisorConfig":
    return sv.SupervisorConfig(
        world=spec["world"], target_step=spec["target"], coord_dir=coord,
        n_side=m_side, p=p, dt=DT, target_per_box=SVC_SESSION_KW["target_per_box"],
        checkpoint_every=2,
        checkpoint_keep=8, device="cuda",
        watchdog=rz.WatchdogPolicy(compile_grace=120.0, teardown_grace=30.0,
                                   agree_timeout=60.0),
        restart=rz.RestartPolicy(min_world=spec["min_world"], backoff_base=0.1),
        max_wall=DRILL_MAX_WALL)


def drill_run(coord: str, m_side: int, p: int, spec: dict, site: str):
    """One drill; returns the result, the survivors' trees and records."""
    cfg = drill_config(coord, m_side, p, spec)
    faults = FaultInjector(FaultSpec(site=site, step=spec["step"], device=spec["rank"]))
    t0 = time.perf_counter()
    try:
        result = sv.Supervisor(cfg, faults=faults).run()
    except rz.MeshFaultError as e:
        logs = sorted(Path(coord).rglob("*.log"))
        tails = "\n".join(f"--- {f}\n{f.read_text(errors='replace')[-2000:]}" for f in logs)
        raise RuntimeError(f"{site} drill did not survive: {e}\n{tails}") from e
    seconds = time.perf_counter() - t0
    trees, records = {}, {}
    for r in result.ranks:
        with np.load(Path(result.result_dir) / f"result_{r}.npz") as z:
            trees[r] = {k: z[k] for k in ("z", "q", "mask")}
        records[r] = json.loads((Path(result.result_dir) / f"result_{r}.json").read_text())
    first = trees[result.ranks[0]]
    for r, t in trees.items():
        require(all(np.array_equal(t[k], first[k]) for k in t),
                f"{site} drill: survivor {r} differs from rank {result.ranks[0]}")
    logs = [[MeshEvent.from_json(e) for e in rec["mesh_log"]]
            for rec in sorted(records.values(), key=lambda rec: rec["mesh_rank"])]
    rep = sched.verify_schedules(logs, label=f"{site} survivors")
    require(rep.ok, f"{site} drill: the survivors' schedules disagree:\n"
            + "\n".join(rep.problems[:20]))
    for r, rec in records.items():
        rec["schedule"] = sched.counts_text(logs[rec["mesh_rank"]])
        print(f"{site} drill rank {r} schedule: {rec['schedule']}", flush=True)
        for s in rec["steps"]:
            require(s["recovered"] == "" and s["plain"] == 0
                    and (s["p2p"], s["m2l"]) == (s["expected"]["p2p"], s["expected"]["m2l"]),
                    f"{site} drill, rank {r}, step {s['step']}: {s}")
    require(len(result.faults) == 1, f"{site} drill: {len(result.faults)} faults")
    rep = result.faults[0]
    require(rep.detect_seconds is not None and rep.detect_seconds < DRILL_DETECT_S,
            f"{site} drill: detected in {rep.detect_seconds} s")
    return cfg, result, first, records, seconds


def drill_phase(m_side: int, p: int) -> dict:
    """Phase drill: the kill-drill supervisor at phase 4c's tree (the
    lattice, level 10, 8 slots, p = 17) on gloo ranks sharing the card.
    SIGKILL rank 2 of 4 mid-step 4: the run completes at step 6 on (0, 1,
    3), every survivor bit for bit the others and a clean 3-rank restore
    from the same checkpoint, every step exactly
    ``parallel_fmm.kernel_launches(plan)`` P2P and M2L launches an
    evaluation a rank and no plain call.  SIGSTOP rank 1 of 3 at step 3:
    detected in under 120 s, completed at step 5 on (0, 2).  Returns the
    survivors' launches."""
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="drill_", dir=root))
    out, launches = {}, {"p2p": 0, "m2l": 0}
    try:
        for name, spec, site, ranks in (("kill", DRILL_KILL, "proc_kill", (0, 1, 3)),
                                        ("hang", DRILL_HANG, "proc_hang", (0, 2))):
            cfg, result, tree, records, seconds = drill_run(
                str(work / name), m_side, p, spec, site)
            require(result.success and result.ranks == ranks
                    and result.final_step == spec["target"],
                    f"{name} drill ended on {result.ranks} at {result.final_step}")
            rep = result.faults[0]
            require(spec["rank"] in rep.dead + rep.hung, f"{name} drill: {rep}")
            meta = json.loads((Path(cfg.checkpoint_dir) / f"step_{rep.restore_step}"
                               / "meta.json").read_text())
            require((meta["level"], meta["slots"], meta["cut"]) == (CONFIG.level, SLOTS, PLAN_CUT),
                    f"{name} drill's tree {meta}")
            row = {"world": spec["world"], "fault": f"{site} rank {spec['rank']} "
                   f"step {spec['step']}", "survivors": list(result.ranks),
                   "restore_step": rep.restore_step, "detect_seconds": rep.detect_seconds,
                   "restore_seconds": rep.restore_seconds,
                   "first_step_seconds": rep.first_step_seconds,
                   "generations": [{k: g[k] for k in ("generation", "ranks", "outcome",
                                                      "spawn_to_restored_s",
                                                      "spawn_to_first_step_s")}
                                   for g in result.generations],
                   "step_host_ms": {r: [s["host_ms"] for s in rec["steps"]]
                                    for r, rec in records.items()},
                   "launches_per_step": records[ranks[0]]["steps"][0]["expected"],
                   "schedules_agree": True,
                   "schedule_per_rank": {r: rec["schedule"] for r, rec in records.items()},
                   "plan": records[ranks[0]]["plan"], "seconds": seconds}
            for rec in records.values():
                launches["p2p"] += sum(s["p2p"] for s in rec["steps"])
                launches["m2l"] += sum(s["m2l"] for s in rec["steps"])
            if name == "kill":
                t0 = time.perf_counter()
                clean = spawn_world(sv.clean_restore, len(ranks), device="cuda",
                                    timeout_s=RANK_TIMEOUT_S,
                                    args=(cfg.checkpoint_dir, rep.restore_step,
                                          spec["target"], sv.restore_kwargs(cfg)))
                row["clean_restore_seconds"] = time.perf_counter() - t0
                for c in clean:
                    require(all(np.array_equal(tree[k], c[k]) for k in tree),
                            "kill drill: the survivors are not bit for bit a clean "
                            f"{len(ranks)}-rank restore from step {rep.restore_step}")
                row["bit_for_bit_clean_restore"] = True
            out[name] = row
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "drill", "note": "gloo ranks share one card: not a scaling result",
          **out, "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


def analysis_phase(card: str) -> dict:
    """Phase analysis: the four sections of ``python -m
    repro_torch.analysis.check --device cuda --quick`` in this process,
    with 0 violations: lint, the trace contracts on the card's route (their
    launches counted in the trace, host syncs refused by
    ``set_sync_debug_mode("error")``), the schedule cases on dry meshes on
    the card and the cache sessions."""
    t0 = time.perf_counter()
    summary = analysis_check.run("cuda", quick=True)
    seconds = time.perf_counter() - t0
    for name, res in summary.items():
        print(f"analysis {name}: {res['checked']} checks, {res['violations']} "
              f"violations, {res['seconds']:.2f} s", flush=True)
    bad = {k: v["detail"] for k, v in summary.items() if v["violations"]}
    emit({"phase": "analysis", "seconds": seconds, "card": card,
          "sections": {k: {f: v[f] for f in ("checked", "violations", "seconds")}
                       for k, v in summary.items()}, "violations": bad})
    require(not bad, f"analysis: violations {bad}")
    return summary


def attention_grad_state(grads: dict) -> dict:
    """Which layers' ``w_q``, ``w_k``, ``w_v`` lack a finite nonzero
    gradient, and how many layers' ``w_q`` gradient is exactly zero."""
    bad, zero_w_q = [], 0
    for i, layer in enumerate(grads["layers"]):
        for name in ("w_q", "w_k", "w_v"):
            g = layer["attn"][name]
            if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
                bad.append(f"layers/{i}/attn/{name}")
        zero_w_q += int(not bool(layer["attn"]["w_q"].any()))
    return {"lacking": bad, "layers_with_zero_w_q": zero_w_q}


def train_step_row(step, params, state, batch, tokens: int) -> tuple:
    """One train step, the flash counters zeroed just before and read just
    after; host ms around it, ending in a sync."""
    torch.cuda.synchronize()
    zero_flash_counts()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    metrics = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return params, state, {**metrics, "step_ms": ms, "tok_per_s": tokens / (ms / 1e3),
                           "flash_launches": flash_counts()}


def train_phase(dev, card) -> dict:
    """Phase train: Yi-6B at full width, 8 of 32 layers, bf16 weights with
    f32 AdamW moments, on one fixed batch of 4 x 2048 tokens: 8 steps of
    ``make_train_step`` (remat), then one with two microbatches.  Gates:
    step 0's loss within 1.0 of ln(vocab); every loss finite and the last
    of the 8 at least ``TRAIN_MARGIN`` below the first; exactly 16 ``tc``
    launches a microbatch (8 layers, forward and remat's recompute) and no
    other flash launch; every layer's ``w_q``, ``w_k``, ``w_v`` with a
    finite nonzero gradient, and a planted fault (attention calling
    ``ops.flash_attention`` outside autograd, as before the port trained)
    caught by that gate with every ``w_q`` gradient exactly zero.  Returns
    the ``tc`` launches of the steps."""
    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params, _, init_s, n_params = random_model(cfg, dev)
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    state = init_state(params, opt_cfg)
    batch = make_inputs(PipelineState(seed=0, step=0), cfg,
                        ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH), dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    step = make_train_step(cfg, opt_cfg)
    for _ in range(TRAIN_STEPS):
        params, state, row = train_step_row(step, params, state, batch, tokens)
        rows.append(row)
    # phase dryrun's part (e): the one-microbatch steps' peak with the
    # parameters, AdamW state and batch resident, less what came before
    step_bytes = torch.cuda.max_memory_allocated() - before
    params, state, row2 = train_step_row(make_train_step(cfg, opt_cfg, num_microbatches=2),
                                         params, state, batch, tokens)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    for i, r in enumerate(rows):
        print(f"train {cfg.name} x{TRAIN_LAYERS} step {i}: loss {r['loss']:.4f} "
              f"{r['step_ms']:.1f} ms {r['tok_per_s']:.0f} tok/s", flush=True)
    per_mb = {"tc": 2 * TRAIN_LAYERS, "tf32": 0, "simt": 0}

    # (d) and (e): the gradient of every attention weight, then the planted fault
    loss_fn = make_loss_fn(cfg)
    zero_flash_counts()
    _, g = value_and_grad(loss_fn, params, batch)
    real = attention_grad_state(unflatten(params, g))
    del g
    own = ops.flash_attention_with_grad
    ops.flash_attention_with_grad = lambda q, k, v, causal=True, **_: ops.flash_attention(
        q, k, v, causal=causal)
    try:
        _, g = value_and_grad(loss_fn, params, batch)
    finally:
        ops.flash_attention_with_grad = own
    fault = attention_grad_state(unflatten(params, g))
    del g

    # where a step's device time goes: one more step under the profiler, and
    # the plain attention backward and lm_loss alone at the step's shapes
    profile = device_profile(lambda: step(params, state, batch), share_of=("flash_attn_tc",))
    steady = sorted(r["step_ms"] for r in rows[1:])[len(rows[1:]) // 2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B, H, Hkv, d = TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = (torch.randn((B, TRAIN_SEQ, h, d), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2).requires_grad_() for h in (H, Hkv, Hkv))
    cot = torch.randn((B, H, TRAIN_SEQ, d), generator=gen, device=dev).to(torch.bfloat16)
    attn_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        flash_attn.flash_attention_plain(q, k, v), (q, k, v), cot), iters=3, warmup=1)
    del q, k, v, cot
    hidden = torch.randn((B, TRAIN_SEQ, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    W = params["lm_head"].detach().requires_grad_()
    loss_ms = cuda_ms(lambda: torch.autograd.grad(
        lm_loss({"lm_head": W}, hidden, batch["labels"], cfg), (hidden, W)), iters=3, warmup=1)
    del hidden, W
    shares = {"steady_step_ms": steady,
              "plain_attention_backward_ms_one_layer": attn_bwd_ms,
              "plain_attention_backward_share_of_step": TRAIN_LAYERS * attn_bwd_ms / steady,
              "lm_loss_fwd_bwd_ms": loss_ms, "lm_loss_share_of_step": loss_ms / steady,
              "how": "each alone at the step's shapes (CUDA events, bf16 q, k, v of the "
                     "training attention; lm_loss forward and backward), 8 attention "
                     "backwards a step, over the median step ms of steps 1-7"}
    record = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
              "of_layers": full.num_layers, "params": n_params, "init_params_s": init_s,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "opt": TRAIN_OPT, "card": card,
              "losses": losses, "first_step_ms": rows[0]["step_ms"],
              "steady_step_ms": steady, "steady_tok_per_s": tokens / (steady / 1e3),
              "steps": rows, "two_microbatches": row2, "peak_bytes": peak,
              "step_bytes": step_bytes, "resident_before_bytes": before,
              "ln_vocab": math.log(cfg.vocab), "margin_gate": TRAIN_MARGIN,
              "grads": real, "planted_fault": fault, "shares": shares,
              "profile": profile}
    emit({"phase": "train", **record})
    require(abs(losses[0] - math.log(cfg.vocab)) <= TRAIN_LOSS0_TOL,
            f"train: step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of "
            f"ln({cfg.vocab}) = {math.log(cfg.vocab)}")
    require(all(math.isfinite(x) for x in losses + [row2["loss"]]),
            f"train: a loss is not finite: {losses}, {row2['loss']}")
    require(losses[-1] <= losses[0] - TRAIN_MARGIN,
            f"train: the loss fell from {losses[0]} to {losses[-1]}, less than "
            f"{TRAIN_MARGIN}")
    for i, r in enumerate(rows):
        require(r["flash_launches"] == per_mb, f"train step {i}: flash launches "
                f"{r['flash_launches']}, expected {per_mb}")
    require(row2["flash_launches"] == {r: 2 * n for r, n in per_mb.items()},
            f"train, two microbatches: flash launches {row2['flash_launches']}")
    require(not real["lacking"], f"train: no finite nonzero gradient at {real['lacking']}")
    require(fault["lacking"] and fault["layers_with_zero_w_q"] == TRAIN_LAYERS,
            f"train: the planted fault (attention outside autograd) was not caught: "
            f"{fault}")
    del params, state, batch
    torch.cuda.empty_cache()
    emit({"phase": "train_summary", "seconds": time.perf_counter() - t_phase})
    return {"tc": sum(r["flash_launches"]["tc"] for r in rows) + row2["flash_launches"]["tc"],
            "step_bytes": step_bytes}


def check_attn_grad(dtype, gen) -> dict:
    """The flash kernel inside autograd against the plain version, both on
    the card, at the training attention shape on the model's ``(B, T, H, d)
    -> (B, H, T, d)`` views: gradients of q, k and v under one random
    cotangent, exactly one launch of the dtype's route, and the forward
    plus backward timed beside the plain version's and SDPA's."""
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    B, H, Hkv, T, d = TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, cfg.head_dim_
    q, k, v = (torch.randn((B, T, h, d), generator=gen, device=dev).to(dtype)
               .transpose(1, 2).requires_grad_() for h in (H, Hkv, Hkv))
    cot = torch.randn((B, H, T, d), generator=gen, device=dev)

    def grads(attn):
        out = attn(q, k, v)
        return (out.detach(), *torch.autograd.grad((out.float() * cot).sum(), (q, k, v)))
    torch.cuda.synchronize()
    zero_flash_counts()
    out, *got = grads(ops.flash_attention_with_grad)
    torch.cuda.synchronize()
    launches = flash_counts()
    want_out, *want = grads(attention_core_plain)
    route = "tc" if dtype == torch.bfloat16 else "tf32"
    require(launches == {r: int(r == route) for r in launches},
            f"the kernel in autograd ({dtype}) launched {launches}")
    fwd_err = rel_l2(out.float(), want_out.float())
    require(out.dtype == dtype and fwd_err <= ATTN_TOL[dtype],
            f"the kernel in autograd ({dtype}): forward vs the plain version's, rel L2 "
            f"{fwd_err} > {ATTN_TOL[dtype]}")
    errs = [rel_l2(a.float(), b.float()) for a, b in zip(got, want)]
    require(all(a.dtype == dtype and bool(torch.isfinite(a).all()) for a in got),
            f"the kernel in autograd ({dtype}): gradient dtypes or values")
    require(max(errs) <= ATTN_GRAD_TOL[dtype], f"the kernel in autograd ({dtype}): "
            f"q, k, v gradients vs the plain version's, rel L2 {errs} > "
            f"{ATTN_GRAD_TOL[dtype]}")
    # the gate must refuse a miswired backward: the gradients without the mask
    _, *fault = grads(lambda q, k, v: attention_core_plain(q, k, v, causal=False))
    fault_errs = [rel_l2(a.float(), b.float()) for a, b in zip(fault, want)]
    require(min(fault_errs) > ATTN_GRAD_TOL[dtype], f"the kernel in autograd ({dtype}): "
            f"gradients without the causal mask within the gate, rel L2 {fault_errs}")
    del fault

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(H // Hkv, dim=1), v.repeat_interleave(H // Hkv, dim=1),
            is_causal=True)
    row = {"name": "flash_attention_with_grad", "route": route, "dtype": str(dtype),
           "shape": [B, H, Hkv, T, T, d], "launches": launches,
           "rel_l2_forward": fwd_err, "gate_forward": ATTN_TOL[dtype],
           "rel_l2_q_k_v": errs, "gate": ATTN_GRAD_TOL[dtype],
           "fault_rel_l2_q_k_v_unmasked": fault_errs,
           "fwd_bwd_ms": cuda_ms(lambda: grads(ops.flash_attention_with_grad), iters=3),
           "plain_fwd_bwd_ms": cuda_ms(lambda: grads(attention_core_plain), iters=3),
           "library_fwd_bwd_ms": cuda_ms(lambda: grads(sdpa), iters=3)}
    emit({"phase": "attn_grad", **row})
    del q, k, v, cot, out, got, want_out, want
    torch.cuda.empty_cache()
    return row


def train_families_phase(dev) -> dict:
    """One remat step (the gradient, then AdamW) each of the recurrent
    families at their published widths and depths in bf16, batch 2 x 2048:
    loss and every gradient finite, every RG-LRU ``lru_lambda`` and SSD
    ``a_log`` gradient nonzero, and the hybrid's local attention (its window
    covers the sequence) on the ``tc`` kernel twice a layer.  Returns the
    ``tc`` launches and each step's bytes: the peak of
    ``max_memory_allocated`` after ``reset_peak_memory_stats`` with the
    parameters, AdamW state and batch resident, less what was allocated
    before the model was drawn (phase dryrun's part (a))."""
    tc = 0
    step_bytes = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch)
        gc.collect()                    # what the last arch's graph still holds
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        params, _, init_s, n_params = random_model(cfg, dev)
        opt_cfg = AdamWConfig(**TRAIN_OPT)
        state = init_state(params, opt_cfg)
        batch = make_inputs(PipelineState(seed=0, step=0), cfg,
                            ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_FAMILY_BATCH), dev)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts()
        t0 = time.perf_counter()
        loss, g = value_and_grad(make_loss_fn(cfg), params, batch)
        params, state, m = apply_updates(params, unflatten(params, g), state, opt_cfg)
        loss, gnorm = float(loss), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, peak = flash_counts(), torch.cuda.max_memory_allocated()
        grads = unflatten(params, g)
        recurrent = [(f"layers/{i}/{blk}/{name}", layer[blk][name])
                     for i, layer in enumerate(grads["layers"])
                     for blk, name in (("rec", "lru_lambda"), ("mamba", "a_log"))
                     if blk in layer]
        attn_layers = sum(k == "attn" for k in transformer.layer_kinds(cfg))
        row = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
               "params": n_params, "init_params_s": init_s, "batch": TRAIN_FAMILY_BATCH,
               "seq": TRAIN_SEQ, "loss": loss, "grad_norm": gnorm, "step_ms": ms,
               "tok_per_s": TRAIN_FAMILY_BATCH * TRAIN_SEQ / (ms / 1e3), "peak_bytes": peak,
               "resident_before_bytes": before, "arguments_bytes": resident - before,
               "step_bytes": peak - before,
               "flash_launches": launches, "recurrent_params": len(recurrent),
               "recurrent_grad_min_abs_max": min(float(t.abs().max()) for _, t in recurrent)}
        emit({"phase": "train_families", **row})
        require(math.isfinite(loss) and all(bool(torch.isfinite(t).all()) for t in g),
                f"{arch}: a non-finite loss ({loss}) or gradient")
        zero = [n for n, t in recurrent if not float(t.abs().max()) > 0]
        require(recurrent and not zero, f"{arch}: zero recurrent gradients at {zero}")
        want = {"tc": 2 * attn_layers, "tf32": 0, "simt": 0}
        require(launches == want, f"{arch}: flash launches {launches}, expected {want}")
        tc += launches["tc"]
        step_bytes[arch] = peak - before
        del params, state, batch, g, grads, recurrent
        torch.cuda.empty_cache()
    return {"tc": tc, "step_bytes": step_bytes}


# ---------------------------------------------------------------------------
# phase train_sharded: granite-moe on a (data, model) grid of gloo ranks
# ---------------------------------------------------------------------------


def ts_config(layers: int, dtype: str, capacity_factor=None, bits: int = 16):
    cfg = get_config(TS_ARCH)
    moe_cfg = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor)
    return dataclasses.replace(cfg, num_layers=layers, dtype=dtype, moe=moe_cfg,
                               moe_gather_bits=bits)


def ts_part_a_config(bits: int = 16):
    cfg = get_config(TS_ARCH)
    return ts_config(TS_A_LAYERS, "float32", cfg.moe.num_experts / cfg.moe.top_k, bits)


def ts_d_config(layers: int, dtype: str):
    return dataclasses.replace(get_config(TS_D_ARCH), num_layers=layers, dtype=dtype)


class CountDrops:
    """Within it, the assignments that ``moe.route`` drops (not kept: past
    capacity) in its first ``calls`` calls: a forward's, one a layer."""

    def __init__(self, calls: int):
        self.calls, self.seen, self.dropped = calls, 0, 0

    def __enter__(self):
        self.route = moe.route

        def counting(*args, **kw):
            out = self.route(*args, **kw)
            if self.seen < self.calls:
                self.dropped += int((~out[3]).sum())
            self.seen += 1
            return out
        moe.route = counting
        return self

    def __exit__(self, *exc):
        moe.route = self.route


def ts_one_rank(cfg, batch_rows: int, dev, path) -> dict:
    """The one-rank gradient of ``cfg`` (parameters from ts_params) on
    ``batch_rows`` x 2048: loss, grad norm, flash launches and assignments
    dropped in the forward returned, the gradients written to ``path``."""
    params = ts_params(cfg, dev)
    batch = ts_batch(cfg, batch_rows, dev)
    torch.cuda.synchronize()
    zero_flash_counts()
    t0 = time.perf_counter()
    with CountDrops(cfg.num_layers if cfg.moe is not None else 0) as drops:
        loss, grads = value_and_grad(make_loss_fn(cfg), params, batch)
    gnorm = global_norm(unflatten(params, grads))
    out = {"loss": float(loss), "grad_norm": float(gnorm),
           "ms": (time.perf_counter() - t0) * 1e3, "launches": flash_counts(),
           "dropped": drops.dropped,
           "params": sum(t.numel() for t in transformer.param_tensors(params))}
    torch.save({"loss": out["loss"], "grad_norm": out["grad_norm"],
                "grads": [g.cpu() for g in grads]}, path)
    del params, grads, batch
    torch.cuda.empty_cache()
    return out


def ts_grid_gradient(grid, cfg, batch_rows: int, ref_path: str, dev) -> dict:
    """:func:`ts_gradient_run` of ``cfg`` on ``grid`` from this rank's blocks
    of ts_params' parameters, against the one-rank gradient in
    ``ref_path``; with the assignments this rank's forward dropped and the
    grid's events."""
    full = ts_params(cfg, dev)
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, grid))
    blocks = unflatten(full, [shd.local_block(t, s, grid).clone()
                              for t, s in zip(transformer.param_tensors(full), specs)])
    del full
    ref = torch.load(ref_path, mmap=True)
    ref_blocks = [shd.local_block(g, s, grid).to(dev) for g, s in zip(ref["grads"], specs)]
    batch = tloop.local_rows(ts_batch(cfg, batch_rows, dev), grid)
    mark = len(grid.log)
    with CountDrops(cfg.num_layers if cfg.moe is not None else 0) as drops:
        out = ts_gradient_run(grid, cfg, blocks, specs, batch, ref_blocks)
    out.update(dropped=drops.dropped, names=[n for n, _ in shd.flat_names(blocks)],
               log=list(grid.log.events[mark:]))
    del blocks, ref_blocks, ref, batch
    torch.cuda.empty_cache()
    return out


def ts_params(cfg, dev):
    """The full parameters from the generator seeded with 0 on the card:
    the same draws in every process."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return init_params(cfg, gen, dev)


def ts_batch(cfg, batch: int, dev) -> dict:
    return make_inputs(PipelineState(seed=0, step=0), cfg,
                       ShapeConfig("train", "train", TS_SEQ, batch), dev)


def ts_gradient_run(grid, cfg, blocks, specs, batch, ref_blocks) -> dict:
    """One gradient of the grid (``value_and_grad`` and the global norm),
    its flash launches, collectives and, leaf by leaf, the squares of its
    difference from the one-rank gradient's blocks and of those blocks,
    summed over the grid."""
    torch.cuda.synchronize()
    zero_flash_counts()
    mark = len(grid.log)
    loss, grads = tloop.value_and_grad(make_loss_fn(cfg, grid), blocks, batch)
    gnorm = global_norm(unflatten(blocks, grads), grid, specs)
    launches = flash_counts()
    events = grid.log.events[mark:]
    # per leaf: squares of the difference, of the one-rank gradient, and the
    # count of non-finite elements
    sums = torch.zeros((len(grads), 3), dtype=torch.float64, device=grid.device)
    for i, (g, r, spec) in enumerate(zip(grads, ref_blocks, specs)):
        if shd.counted_once(grid, spec):
            g64, r64 = g.double(), r.double()
            sums[i, 0] = torch.sum((g64 - r64) ** 2)
            sums[i, 1] = torch.sum(r64 ** 2)
        sums[i, 2] = torch.sum(~torch.isfinite(g))
    sums = grid.all_reduce_sum(sums, grid.axis_names)
    nonzero = [bool(g.abs().max() > 0) for g in grads]
    return {"loss": float(loss), "grad_norm": float(gnorm), "launches": launches,
            "collectives": len(events),
            "by_kind": {f"{e.kind} over {'+'.join(e.axes)}": sum(
                1 for x in events if (x.kind, x.axes) == (e.kind, e.axes)) for e in events},
            "sums": sums.cpu(), "nonzero": nonzero}


def train_sharded_rank(world, spec: dict) -> dict:
    """One rank of phase train_sharded (``world`` is the default group's
    mesh; the grid is built over it)."""
    dev = world.device
    grid = make_grid_mesh(SHARDED_GRID, ("data", "model"), device=dev)
    out = {"rank": grid.rank, "coords": grid.coords}
    # -- Part A: the f32 gradient against the one-rank one ----------------------
    cfg = ts_part_a_config()
    full = ts_params(cfg, dev)
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, grid))
    blocks = unflatten(full, [shd.local_block(t, s, grid).clone()
                              for t, s in zip(transformer.param_tensors(full), specs)])
    del full
    ref = torch.load(spec["ref"], mmap=True)
    ref_blocks = [shd.local_block(g, s, grid).to(dev)
                  for g, s in zip(ref["grads"], specs)]
    batch = tloop.local_rows(ts_batch(cfg, TS_A_BATCH, dev), grid)
    out["grid"] = ts_gradient_run(grid, cfg, blocks, specs, batch, ref_blocks)
    good = moe.copy_to_model
    moe.copy_to_model = lambda x, mesh: x          # the planted fault
    try:
        out["fault"] = ts_gradient_run(grid, cfg, blocks, specs, batch, ref_blocks)
    finally:
        moe.copy_to_model = good
    good = tensor_parallel.copy_to_model
    tensor_parallel.copy_to_model = lambda x, mesh: x    # the attention's input
    try:
        out["tp_fault"] = ts_gradient_run(grid, cfg, blocks, specs, batch, ref_blocks)
    finally:
        tensor_parallel.copy_to_model = good
    out["q8"] = ts_gradient_run(grid, ts_part_a_config(bits=8), blocks, specs, batch,
                                ref_blocks)
    out["names"] = [n for n, _ in shd.flat_names(blocks)]
    out["part_a_log"] = list(grid.log.events)
    del blocks, ref_blocks, ref, batch
    torch.cuda.empty_cache()
    # -- Part B: Trainer(mesh=grid) at full depth, bf16, timed ------------------
    cfg = ts_config(get_config(TS_ARCH).num_layers, "bfloat16")
    shape = ShapeConfig("train", "train", TS_SEQ, TS_B_BATCH)
    t0 = time.perf_counter()
    tr = tloop.Trainer(cfg, shape, AdamWConfig(**TS_OPT), tloop.TrainerConfig(
        steps=TS_B_STEPS, ckpt_every=0, ckpt_dir=spec["ckpt"], seed=0), mesh=grid)
    out["trainer_init_s"] = time.perf_counter() - t0
    batch = ts_batch(cfg, TS_B_BATCH, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark_b = len(grid.log)
    rows = []
    for _ in range(TS_B_STEPS):
        torch.cuda.synchronize()
        zero_flash_counts()
        grid.wire.reset()
        mark = len(grid.log)
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        events = grid.log.events[mark:]
        kinds = {}
        for e in events:
            key = f"{e.kind} over {'+'.join(e.axes)}"
            kinds[key] = kinds.get(key, 0) + 1
        if not rows:
            out["part_b_step0_log"] = [e.to_json() for e in grid.log.since(mark)]
        rows.append({"loss": m["loss"], "grad_norm": m["grad_norm"], "step_ms": ms,
                     "flash_launches": flash_counts(),
                     "staged_bytes": grid.wire.staged_bytes,
                     "staging_s": grid.wire.staging_s,
                     "collectives": len(events), "by_kind": kinds})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["part_b"] = rows
    out["part_b_log"] = list(grid.log.events[mark_b:])
    out["copies"] = ts_copy_digests(tr, grid)
    t0 = time.perf_counter()
    written = tr.save(TS_B_STEPS)
    tr.ckpt.wait()
    out["save_s"] = time.perf_counter() - t0
    if written is not None:
        out["digests"] = ts_digests(written)
    del tr, written
    gc.collect()
    torch.cuda.empty_cache()
    # -- Part C: MoE on a (4, 1) grid, tokens dropping -----------------------
    grid_c = make_grid_mesh(TS_C_GRID, ("data", "model"), device=dev)
    out["c"] = ts_grid_gradient(grid_c, ts_config(TS_A_LAYERS, "float32"), TS_C_BATCH,
                                spec["ref_c"], dev)
    # -- Part D: Yi-6B on the (2, 2) grid: the f32 gate, then bf16 timed -------
    out["d_gate"] = ts_grid_gradient(grid, ts_d_config(TS_D_GATE_LAYERS, "float32"),
                                     TS_A_BATCH, spec["ref_d"], dev)
    cfg = ts_d_config(TS_D_LAYERS, "bfloat16")
    shape = ShapeConfig("train", "train", TS_SEQ, TS_B_BATCH)
    tr = tloop.Trainer(cfg, shape, AdamWConfig(**TS_OPT), tloop.TrainerConfig(
        steps=TS_D_STEPS, ckpt_every=0, ckpt_dir=spec["ckpt"], seed=0), mesh=grid)
    batch = ts_batch(cfg, TS_B_BATCH, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(TS_D_STEPS):
        torch.cuda.synchronize()
        zero_flash_counts()
        grid.wire.reset()
        mark = len(grid.log)
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        rows.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "flash_launches": flash_counts(), "collectives": len(grid.log) - mark,
                     "staged_bytes": grid.wire.staged_bytes,
                     "staging_s": grid.wire.staging_s})
    out["d_rows"], out["d_peak"] = rows, torch.cuda.max_memory_allocated()
    return out


def ts_copy_digests(tr, grid) -> dict:
    """sha256 of this rank's block of each leaf that other ranks hold too
    (a leaf replicated over an axis), parameters and moments, keyed by the
    leaf and the block (its index on the axes of each dim)."""
    out = {}
    for tree_name, tree in (("params", tr.params), ("mu", tr.opt_state["mu"]),
                            ("nu", tr.opt_state["nu"])):
        for (name, t), spec in zip(shd.flat_names(tree), tr.specs):
            if shd.axis_size(grid, [a for e in spec for a in shd.spec_axes(e)]) == grid.size:
                continue                                # one rank holds this block
            block = tuple(grid.axis_index(shd.spec_axes(e)) for e in spec)
            host = ckpt_manager.to_host(t)
            out[f"{tree_name}/{name}"] = (block, hashlib.sha256(host.tobytes()).hexdigest())
    return out


def ts_copies_agree(ranks) -> tuple[int, list]:
    """(blocks held by more than one rank, those whose copies differ)."""
    held: dict = {}
    for rk in ranks:
        for name, (block, digest) in rk["copies"].items():
            held.setdefault((name, tuple(block)), set()).add(digest)
    return len(held), sorted(f"{n} {b}" for (n, b), d in held.items() if len(d) > 1)


def ts_digests(trees) -> dict:
    """sha256 of each leaf's host bytes (bf16 widened to f32, as written)."""
    out = {}
    for name in ("params", "mu", "nu"):
        tree = trees["params"] if name == "params" else trees["opt"][name]
        for leaf_name, leaf in shd.flat_names(tree):
            host = ckpt_manager.to_host(leaf)
            out[f"{name}/{leaf_name}"] = hashlib.sha256(host.tobytes()).hexdigest()
    return out


def train_sharded_phase(dev, card) -> dict:
    """Phase train_sharded: granite-moe-1b-a400m at its published widths on
    ``RANKS`` gloo ranks sharing the card as a ``SHARDED_GRID`` (data 2,
    model 2) grid, each model rank 16 of the 32 experts.

    Part A (the gate): 4 of 24 layers in f32 at capacity factor E / k (no
    drop on either side), one batch of ``TS_A_BATCH`` x 2048.  The gradient
    on one rank here (its loss, grad norm and gradients go to a file), then
    on the grid: loss and grad norm within ``TS_A_TOL``, the whole tree's
    gradient within its rel L2 (each rank its blocks, the squares summed
    over the grid; each leaf's figure printed), exactly ``2 x 4`` ``tf32``
    launches a rank and no other route, ``ts_collectives(4)`` collectives
    a rank, the ranks' logs verified.  The planted fault (``copy_to_model``
    without its backward sum, swapped in here) must land above
    ``TS_FAULT`` on every router's and every ``attn/w_q``'s gradient.  The
    int8 gather: loss within ``TS_Q8_LOSS``, every gradient finite, every
    expert leaf's nonzero.

    Part B (timed): ``Trainer(mesh=grid)`` at all 24 layers, bf16 weights,
    f32 moments, the config's capacity factor 1.25 (drops per shard), one
    global batch of ``TS_B_BATCH`` x 2048, ``TS_B_STEPS`` steps: step 0's
    loss within ``TRAIN_LOSS0_TOL`` of ln V, the last at least
    ``TS_MARGIN`` below it, exactly 48 ``tc`` launches a rank a step,
    ``ts_collectives(24)`` collectives a rank a step, the schedules
    verified; every block that more than one rank holds (a leaf replicated
    over an axis: norms, routers, the odd-vocab embedding over the model
    axis) has the same sha256 on each of them after the last step,
    parameters and moments, since the checkpoint keeps only rank 0's copy.
    The grid's checkpoint after the last step restores onto one
    rank here bit for bit (sha256 of every parameter and moment against
    rank 0's gathered arrays).

    Part C: granite-moe x4 in f32 at the config's capacity factor (1.25:
    tokens drop) on a ``TS_C_GRID`` (data 4, model 1) grid, one row of 2048
    a data rank: the gradient against one rank's on the whole batch within
    ``TS_A_TOL``, and the assignments the ranks drop in the forward adding
    up to the one rank's, more than 0 (the grid routes the global batch).
    Part D: Yi-6B at full width on the (2, 2) grid, f32 at
    ``TS_D_GATE_LAYERS`` layers, its gradient against one rank's within
    ``TS_A_TOL``; then ``Trainer(mesh=grid)`` at ``TS_D_LAYERS`` layers in
    bf16 on 4 x 2048, ``TS_D_STEPS`` steps timed: exactly 16 ``tc``
    launches a rank a step, losses finite; step ms, peak a rank and
    staging recorded.  Returns the ranks' flash launches."""
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train_sharded_", dir=root))
    try:
        # -- Part A on one rank ----------------------------------------------
        one = ts_one_rank(ts_part_a_config(), TS_A_BATCH, dev, work / "one_rank.pt")
        require(one["launches"] == {"tc": 0, "tf32": 2 * TS_A_LAYERS, "simt": 0},
                f"train_sharded one rank: flash launches {one['launches']}")
        n_params = one["params"]

        # -- Parts C and D on one rank -------------------------------------------
        one_c = ts_one_rank(ts_config(TS_A_LAYERS, "float32"), TS_C_BATCH, dev,
                            work / "one_rank_c.pt")
        one_d = ts_one_rank(ts_d_config(TS_D_GATE_LAYERS, "float32"), TS_A_BATCH, dev,
                            work / "one_rank_d.pt")

        # -- the grid -----------------------------------------------------------
        t0 = time.perf_counter()
        ranks = spawn_world(train_sharded_rank, RANKS, device="cuda",
                            timeout_s=RANK_TIMEOUT_S,
                            args=({"ref": str(work / "one_rank.pt"),
                                   "ref_c": str(work / "one_rank_c.pt"),
                                   "ref_d": str(work / "one_rank_d.pt"),
                                   "ckpt": str(work / "ckpt")},))
        world_s = time.perf_counter() - t0

        # -- Part A's gates ------------------------------------------------------
        names = ranks[0]["names"]
        want_a = {run: ts_collectives(TS_A_LAYERS, run)
                  for run in ("grid", "fault", "tp_fault", "q8")}
        rep_a = sched.verify_schedules([r["part_a_log"] for r in ranks], label="part A")
        part_a = {"one_rank": one, "params": n_params, "layers": TS_A_LAYERS,
                  "batch": TS_A_BATCH, "seq": TS_SEQ, "schedules_agree": rep_a.ok,
                  "collectives_expected": want_a}
        for run in ("grid", "fault", "tp_fault", "q8"):
            r0 = ranks[0][run]
            s = r0["sums"]
            per_leaf = {n: math.sqrt(float(s[i, 0]) / max(float(s[i, 1]), 1e-300))
                        for i, n in enumerate(names)}
            part_a[run] = {
                "loss": r0["loss"], "grad_norm": r0["grad_norm"],
                "loss_rel": abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
                "grad_norm_rel": abs(r0["grad_norm"] - one["grad_norm"]) / one["grad_norm"],
                "grad_rel_l2": math.sqrt(float(s[:, 0].sum()) / float(s[:, 1].sum())),
                "leaf_rel_l2_max": max(per_leaf.values()),
                "finite": float(s[:, 2].sum()) == 0,
                "launches": [r[run]["launches"] for r in ranks],
                "collectives": [r[run]["collectives"] for r in ranks],
                "by_kind": r0["by_kind"]}
            if run != "q8":
                for n, x in per_leaf.items():
                    print(f"train_sharded part A {run} grad rel L2 {n}: {x:.3e}", flush=True)
            part_a[run]["per_leaf"] = per_leaf
        emit({"phase": "train_sharded_part_a", **part_a})
        g = part_a["grid"]
        require(g["loss_rel"] <= TS_A_TOL["loss"], f"train_sharded A: loss {g['loss']} vs "
                f"one rank {one['loss']} ({g['loss_rel']:.2e})")
        require(g["grad_norm_rel"] <= TS_A_TOL["grad_norm"],
                f"train_sharded A: grad norm {g['grad_norm']} vs {one['grad_norm']}")
        require(g["grad_rel_l2"] <= TS_A_TOL["grad"],
                f"train_sharded A: gradient rel L2 {g['grad_rel_l2']:.2e}")
        want_f = {"tc": 0, "tf32": 2 * TS_A_LAYERS, "simt": 0}
        for run in ("grid", "fault", "tp_fault", "q8"):
            require(all(x == want_f for x in part_a[run]["launches"]),
                    f"train_sharded A {run}: flash launches {part_a[run]['launches']}")
            require(all(x == want_a[run] for x in part_a[run]["collectives"]),
                    f"train_sharded A {run}: collectives {part_a[run]['collectives']}, "
                    f"expected {want_a[run]} a rank")
        require(rep_a.ok, "train_sharded A: schedules disagree:\n" + "\n".join(rep_a.problems[:20]))
        f = part_a["fault"]["per_leaf"]
        caught = {n: x for n, x in f.items() if n.endswith("router") or n.endswith("attn/w_q")}
        require(caught and min(caught.values()) > TS_FAULT,
                f"train_sharded A: the planted fault was not caught: {caught}")
        # the attention input's sum dropped: every gradient that flows back
        # through it, each layer's ln1 and every w_q but the last layer's
        f = part_a["tp_fault"]["per_leaf"]
        last = f"layers/{TS_A_LAYERS - 1}/"
        caught = {n: x for n, x in f.items() if n.endswith("ln1") or (
            n.endswith("attn/w_q") and not n.startswith(last))}
        require(len(caught) == 2 * TS_A_LAYERS - 1 and min(caught.values()) > TS_FAULT,
                f"train_sharded A: the planted attention fault was not caught: {caught}")
        q = part_a["q8"]
        require(q["loss_rel"] <= TS_Q8_LOSS and q["finite"],
                f"train_sharded A q8: loss {q['loss']} ({q['loss_rel']:.2e}), finite {q['finite']}")
        zero = [n for r in ranks for n, nz in zip(names, r["q8"]["nonzero"])
                if "experts" in n and not nz]
        require(not zero, f"train_sharded A q8: zero expert gradients at {zero}")

        # -- Part B's gates ------------------------------------------------------
        cfg = ts_config(get_config(TS_ARCH).num_layers, "bfloat16")
        rows = ranks[0]["part_b"]
        losses = [r["loss"] for r in rows]
        want_b = ts_collectives(cfg.num_layers)
        rep_b = sched.verify_schedules([r["part_b_log"] for r in ranks], label="part B")
        steady = sorted(r["step_ms"] for r in rows[1:])[len(rows[1:]) // 2]
        tokens = TS_B_BATCH * TS_SEQ
        part_b = {
            "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "capacity_factor": cfg.moe.capacity_factor, "batch": TS_B_BATCH, "seq": TS_SEQ,
            "opt": TS_OPT, "losses": losses, "ln_vocab": math.log(cfg.vocab),
            "step_ms": [[r["step_ms"] for r in rk["part_b"]] for rk in ranks],
            "steady_step_ms": steady, "global_tok_per_s": tokens / (steady / 1e3),
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "staged_bytes_per_step": [[r["staged_bytes"] for r in rk["part_b"]] for rk in ranks],
            "staging_s_per_step": [[r["staging_s"] for r in rk["part_b"]] for rk in ranks],
            "collectives_per_step": rows[0]["collectives"], "by_kind": rows[0]["by_kind"],
            "collectives_expected": want_b, "schedules_agree": rep_b.ok,
            "trainer_init_s": [r["trainer_init_s"] for r in ranks],
            "save_s": [r["save_s"] for r in ranks], "world_seconds": world_s,
            "card": card, "note": "gloo ranks share one card: not a scaling result"}
        for i, r in enumerate(rows):
            print(f"train_sharded {cfg.name} grid {SHARDED_GRID} step {i}: loss "
                  f"{r['loss']:.4f} {r['step_ms']:.1f} ms, staged "
                  f"{r['staged_bytes'] / 1e9:.2f} GB in {r['staging_s']:.2f} s", flush=True)
        require(abs(losses[0] - math.log(cfg.vocab)) <= TRAIN_LOSS0_TOL,
                f"train_sharded B: step 0's loss {losses[0]} is not within "
                f"{TRAIN_LOSS0_TOL} of ln({cfg.vocab})")
        require(all(math.isfinite(x) for x in losses) and losses[-1] <= losses[0] - TS_MARGIN,
                f"train_sharded B: the loss went from {losses[0]} to {losses[-1]}")
        per_step = {"tc": 2 * cfg.num_layers, "tf32": 0, "simt": 0}
        for rk in ranks:
            for i, r in enumerate(rk["part_b"]):
                require(r["flash_launches"] == per_step and r["collectives"] == want_b,
                        f"train_sharded B rank {rk['rank']} step {i}: flash "
                        f"{r['flash_launches']}, collectives {r['collectives']} "
                        f"(expected {per_step}, {want_b})")
        require(rep_b.ok, "train_sharded B: schedules disagree:\n" + "\n".join(rep_b.problems[:20]))
        part_b["copied_blocks"], differ = ts_copies_agree(ranks)
        part_b["copies_differ"] = differ
        require(part_b["copied_blocks"] > 0 and not differ,
                f"train_sharded B: the copies of {len(differ)} blocks differ across "
                f"ranks after the last step: {differ[:10]}")

        # -- the grid's checkpoint onto one rank ----------------------------------
        t0 = time.perf_counter()
        one_tr = tloop.Trainer(cfg, ShapeConfig("train", "train", TS_SEQ, TS_B_BATCH),
                               AdamWConfig(**TS_OPT), tloop.TrainerConfig(
                                   steps=TS_B_STEPS, ckpt_every=0, ckpt_dir=str(work / "ckpt")),
                               device=dev)
        restored = one_tr.try_restore()
        digests = ts_digests({"params": one_tr.params, "opt": one_tr.opt_state})
        part_b["restore_s"] = time.perf_counter() - t0
        want_d = next(r["digests"] for r in ranks if "digests" in r)
        part_b["restored_bit_for_bit"] = restored and digests == want_d
        part_b["restored_step"] = int(one_tr.opt_state["step"])
        part_b["seconds"] = time.perf_counter() - t_phase
        del one_tr
        torch.cuda.empty_cache()
        emit({"phase": "train_sharded", **part_b})
        require(part_b["restored_bit_for_bit"] and part_b["restored_step"] == TS_B_STEPS,
                "train_sharded B: the grid's checkpoint did not restore bit for bit "
                f"onto one rank ({len([k for k in want_d if digests.get(k) != want_d[k]])} "
                "leaves differ)")

        # -- Parts C and D's gates -----------------------------------------------
        gates = {}
        for part, one_x, grid_shape, layers in (
                ("c", one_c, TS_C_GRID, TS_A_LAYERS),
                ("d_gate", one_d, SHARDED_GRID, TS_D_GATE_LAYERS)):
            r0 = ranks[0][part]
            s = r0["sums"]
            rep = sched.verify_schedules([r[part]["log"] for r in ranks], label=part)
            g = {"grid": grid_shape, "layers": layers, "one_rank": one_x,
                 "loss": r0["loss"], "grad_norm": r0["grad_norm"],
                 "loss_rel": abs(r0["loss"] - one_x["loss"]) / abs(one_x["loss"]),
                 "grad_norm_rel": abs(r0["grad_norm"] - one_x["grad_norm"]) / one_x["grad_norm"],
                 "grad_rel_l2": math.sqrt(float(s[:, 0].sum()) / float(s[:, 1].sum())),
                 "leaf_rel_l2_max": max(math.sqrt(float(s[i, 0]) / max(float(s[i, 1]), 1e-300))
                                        for i in range(s.shape[0])),
                 "finite": float(s[:, 2].sum()) == 0,
                 "dropped": [r[part]["dropped"] for r in ranks],
                 "launches": [r[part]["launches"] for r in ranks],
                 "collectives": [r[part]["collectives"] for r in ranks],
                 "by_kind": r0["by_kind"], "schedules_agree": rep.ok, "card": card}
            gates[part] = g
            emit({"phase": f"train_sharded_part_{part}", **g})
            print(f"train_sharded {part} on {grid_shape}: loss rel {g['loss_rel']:.2e}, grad "
                  f"norm rel {g['grad_norm_rel']:.2e}, gradient rel L2 {g['grad_rel_l2']:.2e}, "
                  f"dropped {sum(g['dropped'])} (one rank {one_x['dropped']})", flush=True)
            require(g["loss_rel"] <= TS_A_TOL["loss"] and g["finite"]
                    and g["grad_norm_rel"] <= TS_A_TOL["grad_norm"]
                    and g["grad_rel_l2"] <= TS_A_TOL["grad"],
                    f"train_sharded {part}: loss rel {g['loss_rel']:.2e}, grad norm rel "
                    f"{g['grad_norm_rel']:.2e}, gradient rel L2 {g['grad_rel_l2']:.2e}")
            want_l = {"tc": 0, "tf32": 2 * layers, "simt": 0}
            require(one_x["launches"] == want_l and all(x == want_l for x in g["launches"]),
                    f"train_sharded {part}: flash launches {one_x['launches']}, {g['launches']}")
            require(rep.ok, f"train_sharded {part}: schedules disagree:\n"
                    + "\n".join(rep.problems[:20]))
        require(sum(gates["c"]["dropped"]) == one_c["dropped"] > 0,
                f"train_sharded c: the grid dropped {gates['c']['dropped']} assignments, one "
                f"rank {one_c['dropped']}: the (4, 1) grid must route the global batch, "
                "where tokens drop")
        cfg_d = ts_d_config(TS_D_LAYERS, "bfloat16")
        d_rows = ranks[0]["d_rows"]
        steady_d = sorted(r["step_ms"] for r in d_rows[1:])[len(d_rows[1:]) // 2]
        part_d = {"arch": cfg_d.name, "layers": cfg_d.num_layers, "of_layers":
                  get_config(TS_D_ARCH).num_layers, "dtype": cfg_d.dtype, "grid": SHARDED_GRID,
                  "batch": TS_B_BATCH, "seq": TS_SEQ, "steps": TS_D_STEPS,
                  "losses": [r["loss"] for r in d_rows],
                  "step_ms": [[r["step_ms"] for r in rk["d_rows"]] for rk in ranks],
                  "steady_step_ms": steady_d,
                  "global_tok_per_s": TS_B_BATCH * TS_SEQ / (steady_d / 1e3),
                  "peak_bytes": [r["d_peak"] for r in ranks],
                  "collectives_per_step": d_rows[0]["collectives"],
                  "staged_bytes_per_step": [[r["staged_bytes"] for r in rk["d_rows"]]
                                            for rk in ranks],
                  "flash_launches": [[r["flash_launches"] for r in rk["d_rows"]]
                                     for rk in ranks],
                  "card": card, "note": "gloo ranks share one card: not a scaling result"}
        part_d["phase_seconds"] = time.perf_counter() - t_phase
        emit({"phase": "train_sharded_yi", **part_d})
        for i, r in enumerate(d_rows):
            print(f"train_sharded {cfg_d.name} x{cfg_d.num_layers} grid {SHARDED_GRID} step "
                  f"{i}: loss {r['loss']:.4f} {r['step_ms']:.1f} ms", flush=True)
        want_tc = {"tc": 2 * TS_D_LAYERS, "tf32": 0, "simt": 0}
        require(all(x == want_tc for rk in part_d["flash_launches"] for x in rk),
                f"train_sharded Yi-6B: flash launches {part_d['flash_launches']}, expected "
                f"{want_tc} a rank a step (each rank's call covers its query heads)")
        require(all(math.isfinite(x) for x in part_d["losses"]),
                f"train_sharded Yi-6B: a loss is not finite: {part_d['losses']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"tc": sum(r["flash_launches"]["tc"] for rk in ranks for r in rk["part_b"])
            + sum(r["flash_launches"]["tc"] for rk in ranks for r in rk["d_rows"]),
            "tf32": one["launches"]["tf32"] + sum(
                x["tf32"] for run in ("grid", "fault", "tp_fault", "q8")
                for x in part_a[run]["launches"])
            + sum(x["launches"]["tf32"] for x in (one_c, one_d))
            + sum(x["tf32"] for part in ("c", "d_gate") for x in gates[part]["launches"]),
            "step0_log": ranks[0]["part_b_step0_log"],
            "peak_bytes": ranks[0]["peak_bytes"]}


# ---------------------------------------------------------------------------
# phase dryrun: the production dry run (launch/dryrun.py), in subprocesses
# ---------------------------------------------------------------------------


class DryrunJobs:
    """The dry run's cells, each ``python -m repro_torch.launch.dryrun`` (a
    process of its own: the dry run owns a default process group), run one
    after another in a thread while the card's phases go on; the traces
    use host cores only.  Every cell's JSON lands in ``out``.  ``stop``
    kills a cell still running (the script's exit)."""

    def __init__(self, out: Path, jobs: dict):
        self.out, self.jobs, self.done = out, jobs, {}
        self.proc = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        atexit.register(self.stop)

    def _run(self) -> None:
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        for name, args in self.jobs.items():
            d = self.out / name
            d.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(d), *args],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=str(Path(__file__).resolve().parent))
            try:
                text, _ = self.proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                text, _ = self.proc.communicate()
            cells = [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]
            self.done[name] = {"rc": self.proc.returncode, "seconds": time.perf_counter() - t0,
                               "tail": text[-3000:], "cells": cells}

    def wait(self) -> dict:
        self.thread.join()
        return self.done

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()


def start_dryrun(out: Path) -> DryrunJobs:
    """Phase dryrun's cells: (a) phase train_families' mamba2-1.3b step,
    (b) one decode step of phase 8's Yi-6B, both on a grid of one rank;
    (c) Part B's granite-moe step of phase train_sharded on the fake (2, 2)
    grid, its events kept; (d) Yi-6B train_4k and decode_32k on (16, 16)
    and the FMM cell on 256 ranks; (e) phase train's Yi-6B x8 step (one
    microbatch) on a grid of one rank."""
    return DryrunJobs(out, {
        "a": ["--arch", "mamba2-1.3b", "--shape", "train_4k", "--grid", "1x1",
              "--batch", str(TRAIN_FAMILY_BATCH), "--seq-len", str(TRAIN_SEQ)],
        "b": ["--arch", SERVE_ARCH, "--shape", "decode_32k", "--grid", "1x1",
              "--batch", str(SERVE_BATCH), "--seq-len", str(SERVE_MAX_LEN),
              "--pos", str(SERVE_PROMPT)],
        "c": ["--arch", TS_ARCH, "--shape", "train_4k",
              "--grid", "x".join(map(str, SHARDED_GRID)), "--batch", str(TS_B_BATCH),
              "--seq-len", str(TS_SEQ), "--events"],
        "e": ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--grid", "1x1",
              "--batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
              "--layers", str(TRAIN_LAYERS), "--microbatches", "1"],
        "d_train": ["--arch", SERVE_ARCH, "--shape", "train_4k"],
        "d_decode": ["--arch", SERVE_ARCH, "--shape", "decode_32k"],
        "d_fmm": ["--fmm"]})


def dryrun_phase(jobs: DryrunJobs, measured: dict) -> dict:
    """Phase dryrun: the dry run's predictions held against this run's
    measurements.  (a), (b) and (e): arguments plus temporaries within
    ``DRYRUN_TOL`` of the measured bytes (phase train_families' mamba2-1.3b
    step; one decode step of phase 8's Yi-6B; phase train's Yi-6B x8 step);
    (c) rank 0's events of the fake (2, 2) trace equal, event for event,
    those rank 0 logged in Part B's first real step (kind, shape, dtype,
    axes, group), and the predicted bytes a rank within ``DRYRUN_TOL`` of
    Part B's measured peak (the card's attention forward is the flash
    kernel, the trace's the plain one, but both hold one query chunk's
    blocks at a time in the backward); (d) every production cell OK, with
    its bytes a rank against the card's memory and its wall time."""
    t0 = time.perf_counter()
    done = jobs.wait()
    waited = time.perf_counter() - t0
    for name, run in done.items():
        print(f"dryrun {name}: rc {run['rc']} in {run['seconds']:.1f} s", flush=True)
        require(run["rc"] == 0 and run["cells"] and all(
            "memory_analysis" in c for c in run["cells"]),
            f"dryrun {name} failed (rc {run['rc']}):\n{run['tail']}")
    cap = torch.cuda.get_device_properties(0).total_memory

    def predicted(name):
        mem = done[name]["cells"][0]["memory_analysis"]
        return mem["argument_bytes"] + mem["temp_bytes"], mem

    out = {"waited_s": waited, "card_bytes": cap, "parts": {}}
    for part, what in (("a", measured["train_mamba2"]), ("b", measured["decode_yi"]),
                       ("e", measured["train_yi"])):
        want, mem = predicted(part)
        rel = abs(want - what) / what
        out["parts"][part] = {"predicted_bytes": want, "measured_bytes": what, "rel": rel,
                              "argument_bytes": mem["argument_bytes"],
                              "temp_bytes": mem["temp_bytes"],
                              "temp_at_peak_by_op": mem.get("temp_at_peak_by_op"),
                              "trace_s": done[part]["cells"][0]["wall"]["trace_s"]}
    cell = done["c"]["cells"][0]
    fake = [MeshEvent.from_json(e) for e in cell["events"]]
    real = [MeshEvent.from_json(e) for e in measured["ts_step0_log"]]
    first = next((i for i, (x, y) in enumerate(zip(fake, real)) if x != y), None)
    want_c, mem_c = predicted("c")
    out["parts"]["c"] = {"events": len(fake), "real_events": len(real),
                         "first_difference": first,
                         "predicted_bytes": want_c, "measured_peak_bytes": measured["ts_peak"],
                         "rel": abs(want_c - measured["ts_peak"]) / measured["ts_peak"],
                         "argument_bytes": mem_c["argument_bytes"],
                         "temp_bytes": mem_c["temp_bytes"],
                         "trace_s": cell["wall"]["trace_s"]}
    out["parts"]["d"] = [{"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
                          "bytes": c["fits"]["bytes"], "card_bytes": cap,
                          "fits": c["fits"]["bytes"] <= cap,
                          "argument_bytes": c["memory_analysis"]["argument_bytes"],
                          "temp_bytes": c["memory_analysis"]["temp_bytes"],
                          "flops": c["cost_analysis"]["flops"],
                          "collective_bytes": c["collectives"]["total_bytes"],
                          "collectives": c["collectives"]["count"], "wall": c["wall"]}
                         for name in ("d_train", "d_decode", "d_fmm")
                         for c in done[name]["cells"]]
    for row in out["parts"]["d"]:
        print(f"dryrun {row['arch']} x {row['shape']} ({row['mesh']}): OK, "
              f"{row['bytes'] / 1e9:.3f} GB a rank of {cap / 1e9:.3f}"
              f"{'' if row['fits'] else ' (does not fit)'}, traced in "
              f"{row['wall']['trace_s']} s", flush=True)
    emit({"phase": "dryrun", **out})
    for part in ("a", "b", "c", "e"):
        r = out["parts"][part]
        require(r["rel"] <= DRYRUN_TOL,
                f"dryrun ({part}): predicted {r['predicted_bytes']} bytes, measured "
                f"{r.get('measured_bytes', r.get('measured_peak_bytes'))} ({r['rel']:.3f} off)")
    require(first is None and len(fake) == len(real) > 0,
            f"dryrun (c): the fake trace's events differ from the real rank 0's at event "
            f"{first} ({len(fake)} against {len(real)}): "
            + (f"{fake[first].brief()} / {real[first].brief()}" if first is not None else ""))
    return out


# ---------------------------------------------------------------------------
# phase serve_sharded: granite-moe served on the (2, 2) grid of gloo ranks
# ---------------------------------------------------------------------------


def ss_gate_config(arch: str):
    """The f32 gate's config: granite-moe at SS_MOE_LAYERS layers with
    capacity factor E / k (nothing drops on either side), recurrentgemma-2b
    through its first attention layer."""
    cfg = get_config(arch)
    layers = SS_MOE_LAYERS if cfg.moe is not None else \
        transformer.layer_kinds(cfg).index("attn") + 1
    moe_cfg = None if cfg.moe is None else dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32", moe=moe_cfg)


def ss_prompts(cfg) -> np.ndarray:
    return np.random.default_rng(11).integers(0, cfg.vocab, (SS_BATCH, SS_PROMPT)).astype(np.int32)


class RouteLog:
    """``moe.route`` wrapped while active: records each call's expert choices
    (N, k) and its gaps (each token's k-th largest router logit less the
    next); with ``forced`` (choices in call order) each call routes to
    those experts instead (``route(choices=)``)."""

    def __init__(self, forced=None):
        self.forced, self.choices, self.gaps = forced, [], []

    def __enter__(self):
        self._real = moe.route

        def route(x, router, *, top_k, **kw):
            logits = x.to(torch.float32) @ router.to(torch.float32)
            top = torch.topk(logits, top_k + 1, dim=-1).values
            self.gaps.append((top[:, -2] - top[:, -1]).cpu())
            if self.forced is not None:
                kw["choices"] = self.forced[len(self.choices)]
            out = self._real(x, router, top_k=top_k, **kw)
            self.choices.append(out[0].reshape(x.shape[0], top_k).cpu())
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._real


def ss_forced(engine, params, cfg, tokens_after, fault=None) -> tuple[list, dict]:
    """Prefill ``ss_prompts`` then ``SS_DECODES`` decode steps fed the
    tokens ``tokens_after`` (B, SS_DECODES), on f32 caches: each step's
    logits on the host, and the flash launches of the prefill.
    ``fault(caches)``, where given, runs after the prefill."""
    dev = engine.device
    with torch.inference_mode():
        prompts = torch.as_tensor(ss_prompts(cfg), device=dev).long()
        # f32 caches: the gate is f32 end to end (a bf16 KV cache turns the
        # grid's f32 differences of about 1e-7 into bf16 rounding flips)
        if engine.mesh is None:
            caches = init_cache(cfg, SS_BATCH, SS_MAX_LEN, torch.float32, device=dev)
        else:
            caches = sgrid.init_cache_blocks(cfg, SS_BATCH, SS_MAX_LEN, engine.mesh,
                                             torch.float32)
        torch.cuda.synchronize()
        zero_flash_counts()
        logits, caches = engine.prefill_fn(params, prompts, caches)
        torch.cuda.synchronize()
        launches = flash_counts()
        if fault is not None:
            fault(caches)
        out = [logits.float().cpu()]
        for i in range(SS_DECODES):
            tok = torch.as_tensor(tokens_after[:, i:i + 1], device=dev).long()
            logits, caches = engine.decode_fn(params, tok, SS_PROMPT + i, caches)
            out.append(logits.float().cpu())
    return out, launches


def ss_one_rank(dev, forced=None) -> dict:
    """The one-rank engine's logits of the f32 gate, by arch, the greedy
    tokens the grid is fed, and each MoE call's routing; with ``forced``
    (by arch: the grid's tokens and its choices in call order), routed as
    the grid routed."""
    out = {}
    for arch in SS_GATE_ARCHS:
        cfg = ss_gate_config(arch)
        params = ts_params(cfg, dev)
        engine = ServeEngine(params, cfg, batch_slots=SS_BATCH, max_len=SS_MAX_LEN, device=dev)
        if forced is None:
            tokens = engine.step_all(ss_prompts(cfg), SS_DECODES)
        else:
            tokens = forced[arch]["tokens"]
        with RouteLog(None if forced is None else forced[arch]["choices"]) as log:
            logits, launches = ss_forced(engine, params, cfg, tokens)
        out[arch] = {"tokens": tokens, "logits": logits, "launches": launches,
                     "choices": log.choices, "gaps": log.gaps}
        del params, engine
        torch.cuda.empty_cache()
    return out


def ss_routing(one: dict, grid_choices: list) -> dict:
    """Where the grid's routing (every data rank's rows, in call order) left
    the one-rank engine's: by call, the tokens sent to another set of
    experts, and the one-rank gaps of those in the first call that
    differs."""
    differ, first = [], None
    for i, (a, b) in enumerate(zip(one["choices"], grid_choices)):
        rows = (a.sort(dim=1).values != b.sort(dim=1).values).any(dim=1)
        differ.append(int(rows.sum()))
        if first is None and differ[-1]:
            first = {"call": i, "gaps": one["gaps"][i][rows].tolist()}
    return {"tokens_routed_otherwise": differ, "first": first}


def serve_sharded_rank(world, spec: dict) -> dict:
    """One rank of phase serve_sharded (``world`` is the default group's mesh;
    the grid is built over it)."""
    grid = make_grid_mesh(SHARDED_GRID, ("data", "model"), device=world.device)
    out = {"rank": grid.rank, "coords": grid.coords, "gate": {}}
    one = torch.load(spec["one"], weights_only=False)
    for arch in SS_GATE_ARCHS:
        cfg = ss_gate_config(arch)
        blocks = sgrid.param_blocks(ts_params(cfg, grid.device), cfg, grid)
        torch.cuda.empty_cache()
        engine = ServeEngine(blocks, cfg, batch_slots=SS_BATCH, max_len=SS_MAX_LEN, mesh=grid)
        tokens = one[arch]["tokens"]
        with RouteLog() as log:
            logits, launches = ss_forced(engine, blocks, cfg, tokens)

        def fault(caches):      # one rank's cache blocks zeroed (pos is whole on every rank)
            if grid.rank == SS_FAULT_RANK:
                for layer in caches:
                    for k, t in layer.items():
                        if k != "pos":
                            t.zero_()
        bad, fault_launches = ss_forced(engine, blocks, cfg, tokens, fault)
        out["gate"][arch] = {
            "logits": logits, "fault_logits": bad, "choices": log.choices,
            "launches": launches, "fault_launches": fault_launches,
            "layout": sgrid.kv_layout(cfg, grid),
            "attention_layers": sum(k == "attn" or k == "moe"
                                    for k in transformer.layer_kinds(cfg))}
        del blocks, engine
        torch.cuda.empty_cache()
    out["gate_log"] = list(grid.log.events)
    # -- timed: bf16 at all 24 layers, the config's capacity factor ------------
    cfg = get_config(TS_ARCH)
    blocks = sgrid.param_blocks(ts_params(cfg, grid.device), cfg, grid)
    torch.cuda.empty_cache()
    engine = ServeEngine(blocks, cfg, batch_slots=SS_BATCH, max_len=SS_MAX_LEN, mesh=grid)
    marks = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = fn(*args, **kwargs)
            b.record()
            marks[name].append((a, b))
            return res
        return call
    engine.prefill_fn = timed("prefill", engine.prefill_fn)
    engine.decode_fn = timed("decode", engine.decode_fn)
    prompts = ss_prompts(cfg)
    engine.step_all(prompts, 1)                      # warm-up
    torch.cuda.synchronize()
    for v in marks.values():
        v.clear()
    torch.cuda.reset_peak_memory_stats()
    grid.wire.reset()
    mark = len(grid.log)
    zero_flash_counts()
    t0 = time.perf_counter()
    tokens = engine.step_all(prompts, SS_NEW)
    torch.cuda.synchronize()
    out["timed"] = {"step_all_s": time.perf_counter() - t0,
                    "prefill_ms": sum(a.elapsed_time(b) for a, b in marks["prefill"]),
                    "decode_ms_per_step": sum(a.elapsed_time(b) for a, b in marks["decode"])
                    / len(marks["decode"]),
                    "decode_steps": len(marks["decode"]),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "flash_launches": flash_counts(), "tokens": tokens,
                    "staged_bytes": grid.wire.staged_bytes, "staging_s": grid.wire.staging_s,
                    "collectives": len(grid.log) - mark}
    out["timed_log"] = list(grid.log.events[mark:])
    return out


def serve_sharded_phase(dev, card) -> dict:
    """Phase serve_sharded: serving on the ``SHARDED_GRID`` of ``RANKS``
    gloo ranks sharing the card (``ServeEngine(mesh=)``; parameters and
    caches each rank's blocks).

    The gate, in f32: granite-moe at ``SS_MOE_LAYERS`` layers (its KV heads
    split over the model axis) and recurrentgemma-2b through its first
    attention layer (1 KV head: the caches split by sequence).  The one-rank
    engine serves ``SS_BATCH`` x ``SS_PROMPT`` prompts here; on every rank
    the prefill's logits and those of ``SS_DECODES`` decode steps fed the
    one-rank engine's tokens, on f32 caches (a bf16 KV cache rounds the
    grid's f32 differences of about 1e-7 to bf16 flips: 4.7e-5 to 1.2e-4 on
    the card), lie within ``SS_TOL`` rel L2 of the one-rank
    engine's routed as the grid routed (``moe.route(choices=)``: a near tie
    among a token's router logits falls either way under the grid's sums in
    another order, and one token sent elsewhere moves the logits by about
    1e-4; the first tokens the grid routes otherwise must be such ties, gap
    under ``SS_TIE``, and the unforced figure is recorded); the prefill
    launches exactly one flash kernel an attention layer (``tf32``: its own
    query heads), and with one rank's cache blocks zeroed after the prefill
    every decode step lands above ``SS_TOL``.  The ranks' schedules verify.

    Timed: granite-moe at all 24 layers in bf16, the config's capacity
    factor, ``step_all`` of ``SS_NEW`` tokens after a warm-up: prefill ms,
    decode ms a step, the peak bytes a rank, exactly 24 ``tc`` launches a
    rank (one an attention layer, all in the prefill), the same tokens on
    every rank.  Returns the ranks' flash launches."""
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="serve_sharded_", dir=root))
    try:
        one = ss_one_rank(dev)
        torch.save({a: {"tokens": v["tokens"]} for a, v in one.items()}, work / "one.pt")
        t0 = time.perf_counter()
        ranks = spawn_world(serve_sharded_rank, RANKS, device="cuda",
                            timeout_s=RANK_TIMEOUT_S, args=({"one": str(work / "one.pt")},))
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rep_gate = sched.verify_schedules([r["gate_log"] for r in ranks], label="gate")
    rep_timed = sched.verify_schedules([r["timed_log"] for r in ranks], label="timed")
    # the grid's routing: every data rank's rows in order (model rank 0's)
    by_data = sorted((r for r in ranks if r["coords"][1] == 0), key=lambda r: r["coords"][0])
    grid_choices = {arch: [torch.cat(calls) for calls in zip(
        *[r["gate"][arch]["choices"] for r in by_data])] for arch in SS_GATE_ARCHS}
    same = ss_one_rank(dev, {a: {"tokens": one[a]["tokens"], "choices": grid_choices[a]}
                             for a in SS_GATE_ARCHS})
    gate = {}
    for arch in SS_GATE_ARCHS:
        rows = [r["gate"][arch] for r in ranks]
        want = same[arch]["logits"]
        rel = [[rel_l2(a, b) for a, b in zip(r["logits"], want)] for r in rows]
        gate[arch] = {"layers": ss_gate_config(arch).num_layers, "layout": rows[0]["layout"],
                      "rel_l2_max": max(max(x) for x in rel),
                      "rel_l2_by_step_rank0": rel[0],
                      "rel_l2_own_routing_max": max(
                          rel_l2(a, b) for r in rows
                          for a, b in zip(r["logits"], one[arch]["logits"])),
                      "routing": ss_routing(one[arch], grid_choices[arch]),
                      "forced_routing_equal": all(
                          torch.equal(a, b) for a, b in zip(same[arch]["choices"],
                                                            grid_choices[arch])),
                      "fault_rel_l2_min": min(rel_l2(a, b) for r in rows
                                              for a, b in zip(r["fault_logits"][1:], want[1:])),
                      "launches": [r["launches"] for r in rows],
                      "fault_launches": [r["fault_launches"] for r in rows],
                      "one_rank_launches": [one[arch]["launches"], same[arch]["launches"]],
                      "attention_layers": rows[0]["attention_layers"]}
    cfg = get_config(TS_ARCH)
    timed = [r["timed"] for r in ranks]
    out = {"grid": list(SHARDED_GRID), "ranks": RANKS, "batch": SS_BATCH, "prompt": SS_PROMPT,
           "gate": gate, "schedules_agree": rep_gate.ok and rep_timed.ok,
           "timed": {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
                     "new": SS_NEW, "capacity_factor": cfg.moe.capacity_factor,
                     "prefill_ms": [t["prefill_ms"] for t in timed],
                     "decode_ms_per_step": [t["decode_ms_per_step"] for t in timed],
                     "step_all_s": [t["step_all_s"] for t in timed],
                     "peak_bytes": [t["peak_bytes"] for t in timed],
                     "flash_launches": [t["flash_launches"] for t in timed],
                     "staged_bytes": [t["staged_bytes"] for t in timed],
                     "staging_s": [t["staging_s"] for t in timed],
                     "collectives": [t["collectives"] for t in timed]},
           "world_seconds": world_s, "seconds": time.perf_counter() - t_phase, "card": card,
           "note": "gloo ranks share one card, weights gathered through host memory: "
                   "not a scaling result"}
    emit({"phase": "serve_sharded", **out})
    for arch, g in gate.items():
        want = {"tc": 0, "tf32": g["attention_layers"], "simt": 0}
        first = g["routing"]["first"] or {"call": None, "gaps": [0.0]}
        require(max(first["gaps"]) < SS_TIE,
                f"serve_sharded {arch}: the grid first routed {len(first['gaps'])} tokens "
                f"otherwise at call {first['call']}, not near ties: gaps {first['gaps'][:8]}")
        require(g["forced_routing_equal"],
                f"serve_sharded {arch}: the one-rank engine did not take the grid's routing")
        require(g["rel_l2_max"] <= SS_TOL,
                f"serve_sharded {arch}: logits {g['rel_l2_max']:.2e} from the one-rank engine "
                f"routed as the grid routed")
        require(g["fault_rel_l2_min"] > SS_TOL,
                f"serve_sharded {arch}: the planted fault was not caught "
                f"({g['fault_rel_l2_min']:.2e})")
        require(all(x == want for x in g["launches"] + g["fault_launches"]
                    + g["one_rank_launches"]),
                f"serve_sharded {arch}: prefill flash launches {g['launches']}, expected {want}")
    require(gate["granite-moe-1b-a400m"]["layout"] == "heads"
            and gate["recurrentgemma-2b"]["layout"] == "sequence",
            f"serve_sharded: cache layouts {[g['layout'] for g in gate.values()]}")
    want = {"tc": cfg.num_layers, "tf32": 0, "simt": 0}
    require(all(t["flash_launches"] == want for t in timed),
            f"serve_sharded timed: flash launches {[t['flash_launches'] for t in timed]}, "
            f"expected {want} a rank")
    require(all(np.array_equal(t["tokens"], timed[0]["tokens"]) for t in timed),
            "serve_sharded timed: the ranks returned different tokens")
    require(rep_gate.ok and rep_timed.ok, "serve_sharded: schedules disagree:\n"
            + "\n".join((rep_gate.problems + rep_timed.problems)[:20]))
    return {"tc": sum(t["flash_launches"]["tc"] for t in timed),
            "tf32": sum(x["tf32"] for g in gate.values()
                        for x in g["launches"] + g["fault_launches"] + g["one_rank_launches"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase fmm_serve's jobs (numpy)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
                 "runs the port on a CUDA card only")
    dev = torch.device("cuda")
    p, level = CONFIG.p, CONFIG.level

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln or "arning" in ln
                 or "entry function" in ln]
             for k, v in reports.items()}
    # what one TF32 pass reads of an operand's low 13 bits (the split's lo
    # goes in with them set)
    x = torch.tensor([1 + 3 * 2.0 ** -12, 1 + 2.0 ** -11, 1 + 2.0 ** -23,
                      -(1 + 3 * 2.0 ** -12), 3.0e-5], device=dev)
    read = tf32.probe(x).cpu()
    hi, _ = tf32.split(x.cpu())
    reads = ("truncated" if torch.equal(read, tf32.truncate(x.cpu())) else
             "rounded to nearest" if torch.equal(read, hi) else "neither")
    emit({"phase": "build", "seconds": build_s, "card": card, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_pass_reads_low_bits": reads, "tf32_probe": [x.tolist(), read.tolist()]})

    # -- 2. each kernel against its plain version at main-path shapes ------
    m_side = int(round(CONFIG.num_particles ** 0.5))
    pos, gamma, sigma = lamb_oseen_particles(m_side, sigma=CONFIG.sigma,
                                             spacing_ratio=CONFIG.spacing_ratio)
    n_particles = len(gamma)
    require(n_particles == CONFIG.num_particles, "lattice size mismatch")
    tree0, index0 = build_tree(pos, gamma, level=level, sigma=sigma, slots=SLOTS)
    p2p_rows = [check_p2p(tree0, sigma), check_p2p(tree0, None),
                check_p2p(tree0, sigma, holes=True), check_p2p(tree0, None, holes=True)]
    # the two new modes: Laplace on the same lattice with real charges, and
    # the base formula at a probe grid's passive targets
    tree_lap, _ = build_tree(pos, gamma, level=level, sigma=sigma, slots=SLOTS,
                             charge_scale=LAPLACE.charge_scale)
    side = (np.arange(PROBE_SIDE) + 0.5) / PROBE_SIDE
    probe_pos = np.stack(np.meshgrid(side, side), axis=-1).reshape(-1, 2)
    probes, probe_index = build_tree(probe_pos, np.zeros(len(probe_pos)), level=level,
                                     sigma=sigma, slots=PROBE_SLOTS)
    require(bool(probes.mask.all()), "the probe grid does not fill every slot")
    lap_rows = [check_p2p_mode(tree_lap, sigma, "laplace"),
                check_p2p_mode(tree_lap, None, "laplace"),
                check_p2p_mode(tree_lap, sigma, "laplace", holes=True)]
    passive_rows = [check_p2p_mode(tree0, sigma, "base", targets=probes),
                    check_p2p_mode(tree0, None, "base", targets=probes),
                    check_p2p_mode(tree0, sigma, "base", targets=probes, holes=True)]
    me0 = fmm.upward_sweep(tree0, p)
    m2l_rows = [check_m2l(me0[level], level, p), check_m2l(me0[2], 2, p)]
    del me0
    # the leaf expansions: P2M at the lattice's leaves, L2P at the sources
    # and at the probe grid, and Laplace's weights and two channels
    leaf_rows = [check_p2m(tree0, p), check_l2p(tree0.z, tree0.mask, level, p),
                 check_l2p(probes.z, probes.mask, level, p, name="l2p_probes"),
                 check_p2m(tree_lap, 16, LAPLACE.p2m_coeff(16), name="p2m_laplace"),
                 check_l2p(tree_lap.z, tree_lap.mask, level, 16, LAPLACE.l2p_modes,
                           name="l2p_laplace")]
    # past the first limits: P2P's streaming form, M2L's wide form
    wide_p2p_rows = [check_p2p_wide(*case, dev) for case in WIDE_P2P_CASES]
    wide_m2l_rows = [check_m2l_wide(*case, dev) for case in WIDE_M2L_CASES]
    for row in (p2p_rows + lap_rows + passive_rows + m2l_rows + leaf_rows + wide_p2p_rows
                + wide_m2l_rows):
        emit({"phase": "kernel_vs_plain", **row})
    # the plain versions at the range forms' card-filling grids leave
    # gigabytes of (rows, cols, st, s) temporaries in the allocator's cache:
    # hand them back before the main path
    torch.cuda.empty_cache()

    # -- 3. main path: build_tree -> fmm on the card, vs float64 ----------
    torch.cuda.synchronize()
    zero_fmm_counts()
    t0 = time.perf_counter()
    tree, index = build_tree(pos, gamma, level=level, sigma=sigma, slots=SLOTS)
    torch.cuda.synchronize()
    build_tree_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    w_sing = fmm.fmm_velocity_singular(tree, p)
    torch.cuda.synchronize()
    fmm_ms = (time.perf_counter() - t0) * 1e3
    require(tuple(w_sing.shape) == (1 << level, 1 << level, SLOTS), "fmm output shape")
    require(bool(torch.isfinite(torch.view_as_real(w_sing[tree.mask])).all()),
            "fmm: non-finite velocity at a live slot")
    sample = np.sort(np.random.default_rng(0).choice(n_particles, SAMPLES, replace=False))
    w_at = gather_particle_values(w_sing, index)[torch.as_tensor(sample, device=dev)]
    err_sing = rel_l2(w_at.to(torch.complex128), direct_sum_f64(pos, gamma, sample, None))
    w_reg = fmm.fmm_velocity(tree, p)
    w_reg_at = gather_particle_values(w_reg, index)       # phase fmm_serve's wave B
    w_at = w_reg_at[torch.as_tensor(sample, device=dev)]
    err_reg = rel_l2(w_at.to(torch.complex128), direct_sum_f64(pos, gamma, sample, sigma))
    emit({"phase": "fmm", "n": n_particles, "level": level, "p": p, "slots": SLOTS,
          "sigma": sigma, "leaf_box": box_size(level),
          "max_occupancy": int(tree.mask.sum(dim=-1).max()),
          "build_tree_ms": build_tree_ms, "fmm_singular_ms": fmm_ms,
          "rel_l2_singular_vs_f64": err_sing, "gate": FMM_TOL,
          "rel_l2_regularized_vs_f64_info": err_reg})
    require(err_sing < FMM_TOL, f"singular FMM rel L2 {err_sing} >= {FMM_TOL}")

    # -- 4. RK2 steps ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, _, ok, occ, health = rk2_step(tree, DT, p=p, guard=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        live = int(tree.mask.sum())
        steps.append({"step": i, "ms": ms, "ok": bool(ok), "occ": int(occ),
                      "live": live, "health": hw.describe(health)})
        require(bool(ok), f"step {i}: a leaf box overflowed")
        require(hw.ok(health), f"step {i}: health {hw.describe(health)}")
        require(live == n_particles, f"step {i}: {live} live of {n_particles}")
    peak = torch.cuda.max_memory_allocated()
    launches = {"p2p": p2p.LAUNCHES, "m2l": m2l.LAUNCHES, "p2m": leaf.P2M_LAUNCHES,
                "l2p": leaf.L2P_LAUNCHES}
    require(launches["p2p"] >= 2 * STEPS and launches["m2l"] >= 18 * STEPS,
            f"main path launches {launches}")
    # every evaluation of phases 3 and 4 ran its leaf stages on the kernel
    require(launches["p2m"] == launches["l2p"] == launches["p2p"],
            f"main path leaf launches {launches}")
    require(fmm_counts()["p2p"] == {"base": launches["p2p"]},
            f"vortex path P2P launches by mode {fmm_counts()['p2p']}")
    stage_ms(tree, p)                      # warm
    stages = stage_ms(tree, p)
    emit({"phase": "steps", "dt": DT, "steps": steps, "peak_bytes": peak,
          "stage_ms": stages, "launches": launches,
          "profile": device_profile(lambda: rk2_step(tree, DT, p=p, guard=True))})
    del tree, index, w_sing
    torch.cuda.empty_cache()
    # -- 4b. main path: VortexStepper at the paper's size -----------------------
    stepper_launches, state4 = stepper_phase(dev, pos, gamma, sigma, p,
                                             [s["ms"] for s in steps[1:]])
    launches["p2p"] += stepper_launches["p2p"]["base"]
    launches["m2l"] += stepper_launches["m2l"]
    torch.cuda.empty_cache()

    # -- 4c. main path: the sharded driver and stepper on 4 ranks ------------
    sharded = sharded_phase(pos, gamma, sigma, p, w_reg, sample,
                            direct_sum_f64(pos, gamma, sample, None), state4)
    del state4, w_reg
    launches["p2p"] += sharded["p2p"]
    launches["m2l"] += sharded["m2l"]
    torch.cuda.empty_cache()

    # -- 4d. main path: the kill-drill supervisor on gloo ranks --------------
    drilled = drill_phase(m_side, p)
    launches["p2p"] += drilled["p2p"]
    launches["m2l"] += drilled["m2l"]

    # -- 5. main path: Laplace and tracer evaluations on the card, vs f64 ----
    equations = equations_phase(dev, pos, gamma, sigma, p, tree0, index0, sample,
                                tree_lap, probes, probe_pos, probe_index)
    del tree_lap, probes
    torch.cuda.empty_cache()

    # -- 6. the host-side planner at the paper's counts and processor count -
    plan_phase(index0.counts, level, p)
    del tree0
    torch.cuda.empty_cache()

    # -- 6b. main path: the FMM service on the card ---------------------------
    served = fmm_serve_phase(dev, pos, gamma, sigma, p, w_reg_at, sample, err_reg,
                             args.seed)
    del w_reg_at
    launches["p2p"] += served["launches"]["p2p"].get("base", 0)
    launches["m2l"] += served["launches"]["m2l"]
    wide = wide_jobs_phase(dev, args.seed)
    launches["p2p"] += wide["p2p"]["base"]
    launches["m2l"] += wide["m2l"]
    launches["p2p_stream"] = wide["p2p_stream"]
    launches["m2l_wide"] = wide["m2l_wide"]
    torch.cuda.empty_cache()

    # -- 6c. the static-analysis layer on the card's route ------------------
    analysis_phase(card)
    torch.cuda.empty_cache()

    # -- 7. flash attention against its plain version ------------------------
    # the tensor-core kernels' timed cases are the shape the serve phases'
    # prefills give them
    cfg = get_config(SERVE_ARCH)
    prefill_shape = (SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads, SERVE_PROMPT,
                     SERVE_PROMPT, cfg.head_dim or cfg.d_model // cfg.num_heads, True)
    require(TC_CASES[0][:7] == TF32_CASES[0][:7] == prefill_shape
            and (F32_BATCH, F32_PROMPT) == (SERVE_BATCH, SERVE_PROMPT),
            f"timed flash cases differ from the prefill shape {prefill_shape}")
    require(TC_CASES[1][:7] == TF32_CASES[1][:7] == SIMT_CASES[1][:7]
            == SIMT_CASES[2][:7] == RG_ATTN and SIMT_CASES[3][:7] == PHI3_ATTN,
            "recurrentgemma-2b's and Phi-3-mini's attention are not the timed cases' shapes")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # through the dispatcher, counted: recurrentgemma-2b's attention, the
    # d = 256 main path of the bf16 tensor-core kernel and of the 3xTF32
    # one, and f32 at d = 32, the simt kernel's; the other cases run on
    # each kernel itself
    tc_rows = [check_flash("flash_attn", flash_attn.flash_attention_tc, *TC_CASES[0],
                           gen=gen, timed=True),
               check_flash("flash_attn", ops.flash_attention, *TC_CASES[1],
                           gen=gen, timed=True, main_path=True)]
    tc_rows += [check_flash("flash_attn", flash_attn.flash_attention_tc, *case,
                            gen=gen, timed=False) for case in TC_CASES[2:]]
    tf32_rows = [check_flash("flash_attn_tf32", flash_attn.flash_attention_tf32,
                             *TF32_CASES[0], gen=gen, timed=True),
                 check_flash("flash_attn_tf32", ops.flash_attention, *TF32_CASES[1],
                             gen=gen, timed=True, main_path=True)]
    tf32_rows += [check_flash("flash_attn_tf32", flash_attn.flash_attention_tf32, *case,
                              gen=gen, timed=False) for case in TF32_CASES[2:]]
    # the simt kernel timed at its served shape (d = 32, split 6) beside
    # SDPA, then counted there through the dispatcher; recurrentgemma-2b's
    # attention on the kernel itself and Phi-3-mini's through the
    # dispatcher on the model's views, timed; the other cases untimed
    simt_rows = [check_flash("flash_attn_simt", flash_attn.flash_attention_cuda,
                             *SIMT_CASES[0], gen=gen, timed=True),
                 check_flash("flash_attn_simt", ops.flash_attention, *SIMT_CASES[0],
                             gen=gen, timed=False, main_path=True)]
    simt_rows += [check_flash("flash_attn_simt",
                              ops.flash_attention if via == "ops" else
                              flash_attn.flash_attention_cuda, *case[:8], gen=gen,
                              timed=True, views=via == "ops")
                  for case in SIMT_TIMED[1:] for via in [case[8]]]
    simt_rows += [check_flash("flash_attn_simt", flash_attn.flash_attention_cuda, *case,
                              gen=gen, timed=False) for case in SIMT_CASES[5:]]
    # the simt launch rule's Python mirror against the library's own, at
    # every head dim and dtype on the timed grids and at the edges of a wave
    grids = {(B, H, T, S, causal) for B, H, _, T, S, _, causal in {c[:7] for c in SIMT_CASES}}
    grids |= {(1, 132, 64, 4096, False), (1, 66, 64, 4096, False), (2, 33, 128, 4096, False)}
    mirror = [(d, str(dt), g) for d in range(8, 257, 8)
              for dt in (torch.float32, torch.bfloat16) for g in sorted(grids)
              if flash_attn.simt_kernel_config(d, dt, g)
              != flash_attn.simt_launch_config(d, dt, g)]
    require(not mirror, f"simt_launch_config differs from the kernel's config at {mirror[:5]}")
    require({r["launch"][5] for r in simt_rows} >= set(range(1, 9)),
            f"the simt rows ran cluster splits {sorted({r['launch'][5] for r in simt_rows})}, "
            f"not every one of 1 to 8")
    for row in tc_rows + tf32_rows + simt_rows:
        emit({"phase": "attn_vs_plain", **row})
    for rows, route, what in ((tc_rows, "tc", "recurrentgemma-2b attention in bf16"),
                              (tf32_rows, "tf32", "recurrentgemma-2b attention in f32"),
                              (simt_rows, "simt", "f32 attention at d = 32")):
        want = {r: int(r == route) for r in ("tc", "tf32", "simt")}
        require(rows[1]["launches"] == want,
                f"{what} launched {rows[1]['launches']}, expected one {route} "
                f"launch and no other")
    launches["flash_attn_d256"] = tc_rows[1]["launches"]["tc"]
    launches["flash_attn_tf32_d256"] = tf32_rows[1]["launches"]["tf32"]
    launches["flash_attn_simt"] = simt_rows[1]["launches"]["simt"]
    torch.cuda.empty_cache()

    # -- 8. main path: Yi-6B serving, bf16, on the tensor-core kernel -------
    serve, serve_launches = serve_phase(dev, cfg, SERVE_BATCH, SERVE_PROMPT,
                                        SERVE_NEW, SERVE_MAX_LEN, profile=True,
                                        decode_bytes=True)
    emit({"phase": "serve", **serve})
    require(serve_launches == {"tc": cfg.num_layers, "tf32": 0, "simt": 0},
            f"flash launches in step_all {serve_launches}, expected "
            f"{cfg.num_layers} bf16 tensor-core launches and no other")
    launches["flash_attn"] = serve_launches["tc"]
    torch.cuda.empty_cache()

    # -- 9. main path: Yi-6B in f32, cut to 2 layers, on the 3xTF32 kernel -
    cfg32 = dataclasses.replace(cfg, num_layers=F32_LAYERS, dtype="float32")
    serve32, f32_launches = serve_phase(dev, cfg32, F32_BATCH, F32_PROMPT, F32_NEW,
                                        F32_PROMPT + F32_NEW, profile=False,
                                        other_route="simt")
    emit({"phase": "serve_f32", **serve32})
    require(f32_launches == {"tc": 0, "tf32": F32_LAYERS, "simt": 0},
            f"flash launches in f32 step_all {f32_launches}, expected "
            f"{F32_LAYERS} 3xTF32 launches and no other")
    launches["flash_attn_tf32"] = f32_launches["tf32"]
    del serve32
    torch.cuda.empty_cache()

    # -- 9b. main path: every other LM family at full width, bf16 tc flash --
    families = serve_families_phase(dev)
    launches["flash_attn"] += families["tc"]
    launches["flash_attn_d256"] += sum(
        r["flash_launches"]["tc"] for r in families["rows"] if r["head_dim"] == 256)
    launches["flash_attn_tf32"] += families["tf32"]
    launches["flash_attn_tf32_d256"] += families["tf32_d256"]

    # the dry run's traces need host cores only: they run from here on, in
    # processes of their own, beside the training phases (phase dryrun)
    dry_out = Path(__file__).resolve().parent / "build" / "dryrun"
    shutil.rmtree(dry_out, ignore_errors=True)
    dry = start_dryrun(dry_out)

    # -- 9c. main path: training; the flash kernel inside autograd -----------
    attn_grad = [check_attn_grad(dt, gen) for dt in (torch.bfloat16, torch.float32)]
    launches["flash_attn"] += attn_grad[0]["launches"]["tc"]
    launches["flash_attn_tf32"] += attn_grad[1]["launches"]["tf32"]
    trained = train_phase(dev, card)
    launches["flash_attn"] += trained["tc"]
    families_train = train_families_phase(dev)
    launches["flash_attn_d256"] += families_train["tc"]
    sharded_train = train_sharded_phase(dev, card)
    launches["flash_attn"] += sharded_train["tc"]
    launches["flash_attn_tf32"] += sharded_train["tf32"]

    # -- 9d. the production dry run against this run's measurements ----------
    dryrun_phase(dry, {"train_mamba2": families_train["step_bytes"]["mamba2-1.3b"],
                       "decode_yi": serve["decode_step"]["peak_bytes"],
                       "train_yi": trained["step_bytes"],
                       "ts_step0_log": sharded_train["step0_log"],
                       "ts_peak": sharded_train["peak_bytes"]})

    # -- 9e. main path: serving on the (data, model) grid ---------------------
    served_grid = serve_sharded_phase(dev, card)
    launches["flash_attn"] += served_grid["tc"]
    launches["flash_attn_tf32"] += served_grid["tf32"]

    # -- 10. card, kernels line, result --------------------------------------
    def entry(rows, name, source, replaces, **extra):
        r = rows[0]
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": max(x["max_abs_err"] for x in rows + [
                 v for k, v in extra.get("sharded_shapes", {}).items()]
                 + extra.get("batched", {}).get("rows", [])),
             "rel_l2": max(x["rel_l2"] for x in rows),
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "fp32_simt_bound_ms" in r:                    # the products' FP32 SIMT figure
            e["fp32_simt_bound_ms"] = r["fp32_simt_bound_ms"]
        return {**e, **extra}

    def d256_block(r, counted, dtype):
        return {k: r[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "fp32_simt_bound_ms",
            "library_ms", "simt_ms_same_inputs", "strided_ms", "rel_l2",
            "strided_rel_l2", "max_abs_err")} | {
            "launches": launches[counted],
            "launches_counted_in": "phase 7: one ops.flash_attention call at "
                                   f"recurrentgemma-2b's attention, {dtype}" + (
                                       "; phase serve_families: recurrentgemma-2b's "
                                       f"prefill in {dtype} (8 local-attention layers)" + (
                                           "; phase train_families: recurrentgemma-2b's "
                                           "remat step (16)" if dtype == "bf16" else ""))}

    def mode_entry(rows, counts, mode, counted_in):
        r = rows[0]
        return {"shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "rel_l2": max(x["rel_l2"] for x in rows),
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "launches": counts["p2p"][mode], "launches_counted_in": counted_in,
                "library_ms": None}

    def sharded_shapes(kernel):
        """Phase 4c's rank-0 checks of ``kernel`` at the overlapped path's
        shapes, by plan and shape."""
        return {f"{plan} {k[len(kernel) + 1:]}": v
                for plan, checks in sharded["shapes"].items()
                for k, v in checks.items() if k.startswith(kernel + "_")}

    print(card, flush=True)
    emit({"kernels": [
        entry(p2p_rows, "p2p", "src/repro_torch/kernels/csrc/p2p.cu",
              "src/repro/kernels/p2p.py:46",
              launches_counted_in="phases 3-4 (fmm, three rk2_steps), 4b "
                                  "(the stepper's four steps), 4c (on each of "
                                  f"{RANKS} ranks: one evaluation per plan and the "
                                  "stepper's four steps) and 4d (each drill's "
                                  "survivors' steps)",
              sharded_launches_per_rank_per_evaluation={
                  k: v["p2p"]["base"] for k, v in sharded["per_rank"].items()},
              sharded_shapes=sharded_shapes("p2p"),
              batched={"rows": served["kernel_rows"]["p2p"],
                       "launches_by_mode": served["launches"]["p2p"],
                       "per_bucket": served["buckets"],
                       "launches_counted_in": "phase fmm_serve: each bucket's drain, the "
                                              "backlog, the session's steps and the "
                                              f"sharded lane on each of {RANKS} ranks"},
              runtime_instance_ms=p2p_rows[0]["runtime_instance_ms"],
              modes={"laplace": mode_entry(lap_rows, equations["laplace"], "laplace",
                                           "phase 5: fmm_evaluate(eq=LAPLACE), singular"),
                     "passive_targets": mode_entry(
                         passive_rows, equations["tracer"], "base_passive",
                         "phase 5: fmm_evaluate(eq=TRACER, targets=probe grid), "
                         "singular")}),
        entry(m2l_rows, "m2l", "src/repro_torch/kernels/csrc/m2l.cu",
              "src/repro/kernels/m2l.py:43",
              launches_counted_in="phases 3-4 (fmm, three rk2_steps), 4b "
                                  "(the stepper's four steps), 4c (on each of "
                                  f"{RANKS} ranks: one evaluation per plan and the "
                                  "stepper's four steps) and 4d (each drill's "
                                  "survivors' steps)",
              sharded_launches_per_rank_per_evaluation={
                  k: v["m2l"] for k, v in sharded["per_rank"].items()},
              sharded_shapes=sharded_shapes("m2l"),
              batched={"rows": served["kernel_rows"]["m2l"],
                       "per_bucket": {k: {"shape": v["shape"], "launches": v["launches"]["m2l"]}
                                      for k, v in served["buckets"].items()},
                       "launches_counted_in": "phase fmm_serve, as P2P's"}),
        entry(wide_p2p_rows, "p2p_stream", "src/repro_torch/kernels/csrc/p2p.cu",
              "src/repro/kernels/p2p.py:46",
              launches_counted_in="phase fmm_serve_wide: the clustered job's bucket "
                                  "(level 3, 512 slots) in a drain of three buckets",
              cases=[{k: r[k] for k in ("slots", "mode", "passive", "shape", "split",
                                        "ctas", "bitwise_repeat", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "rel_l2", "max_abs_err")}
                     for r in wide_p2p_rows]),
        entry(wide_m2l_rows, "m2l_wide", "src/repro_torch/kernels/csrc/m2l.cu",
              "src/repro/kernels/m2l.py:43",
              launches_counted_in="phase fmm_serve_wide: the p = 40 job's bucket "
                                  "(level 4: levels 2..4) in a drain of three buckets",
              cases=[{k: r[k] for k in ("p", "batch", "shape", "split", "ctas",
                                        "bitwise_repeat", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "fp32_simt_bound_ms", "library_ms",
                                        "rel_l2", "max_abs_err")}
                     for r in wide_m2l_rows]),
        entry(tc_rows, "flash_attn", "src/repro_torch/kernels/csrc/flash_attn_tc.cu",
              "src/repro/kernels/flash_attn.py:32",
              launches_counted_in="phase 8: step_all of bf16 Yi-6B (d = 128); phase "
                                  "serve_families: the bf16 prefills of granite-moe, "
                                  "qwen3-moe, recurrentgemma-2b (d = 256), "
                                  "musicgen-large, internvl2-26b, command-r-35b and "
                                  "qwen1.5-32b; phase attn_grad: one bf16 call in "
                                  "autograd; phase train: 16 a step of 8-layer Yi-6B "
                                  "(forward and remat's recompute), 32 in its "
                                  "two-microbatch step; phase train_sharded: 48 a "
                                  "rank a step of 24-layer granite-moe (d = 64) on 4 "
                                  "ranks, 6 steps; phase serve_sharded: 24 a rank in "
                                  "the timed bf16 step_all of 24-layer granite-moe on "
                                  "the (2, 2) grid (its own query heads)",
              attn_grad=attn_grad[0],
              head_dim_256=d256_block(tc_rows[1], "flash_attn_d256", "bf16")),
        entry(tf32_rows, "flash_attn_tf32", "src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
              "src/repro/kernels/flash_attn.py:32",
              launches_counted_in="phase 9: step_all of 2-layer f32 Yi-6B (d = 128); "
                                  "phase serve_families: the f32 prefills of the gated "
                                  "runs (the same seven models, the MoE ones at batch 1); "
                                  "phase attn_grad: one f32 call in autograd; phase "
                                  "train_sharded: 8 in the one-rank gradient of 4-layer "
                                  "f32 granite-moe (d = 64), 8 a rank in each of the "
                                  "grid's three (exact, planted fault, int8 gather); "
                                  "phase serve_sharded: the f32 gate's prefills, one a "
                                  "layer, of 4-layer granite-moe (d = 64) and "
                                  "recurrentgemma-2b's first attention layer (d = "
                                  "256), on one rank and twice on each of 4 (exact, "
                                  "planted fault)",
              attn_grad=attn_grad[1],
              simt_ms_same_inputs=tf32_rows[0]["simt_ms_same_inputs"],
              head_dim_256=d256_block(tf32_rows[1], "flash_attn_tf32_d256", "f32")),
        entry(simt_rows, "flash_attn_simt", "src/repro_torch/kernels/csrc/flash_attn.cu",
              "src/repro/kernels/flash_attn.py:32",
              shape=simt_rows[0]["shape"], launch=simt_rows[0]["launch"],
              timed_cases=[{k: r[k] for k in (
                  "shape", "dtype", "views", "launch", "ms", "plain_ms", "bound_ms",
                  "bound_by", "fp32_simt_bound_ms", "library_ms", "rel_l2", "max_abs_err")}
                  for r in simt_rows[2:6]],
              launches_counted_in="phase 7: one ops.flash_attention call at "
                                  "(1, 2, 2, 64, 192, 32) f32 non-causal, a head "
                                  "dim only the simt route takes"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
