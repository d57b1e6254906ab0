#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the paper's FMM configuration
(vortex steps, the sharded driver and stepper on 4 ranks sharing the card,
Laplace and tracer evaluations, the host-side planner, the FMM service with
its batched buckets) and Yi-6B serving at full width.

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
              kernel, alternately (``prefill_ms_by_route``).

The launch counters are zeroed right before each main path (phase 3 for
the FMM kernels, and again for the stepper's four steps in phase 4b, for
each bucket's drain, the backlog and the session's steps in phase
fmm_serve and on each of its ranks before the sharded lane, on
each rank of phase 4c before each counted evaluation and before the
sharded stepper's steps, on each rank of phase 4d around each step, the
drain of phase fmm_serve_wide, each gated evaluation of phase 5 for P2P's Laplace and
passive modes, ``step_all`` in phases 8 and 9 for the tensor-core flash
kernels, phase 7's two recurrentgemma-2b calls for both tensor-core
kernels at d = 256 and its f32 d = 32 call for the simt one) and read
right after it: every kernel must have run there.  Then come the card's
name and power limit as nvidia-smi reports them, the kernels line and,
last, ``{"ok": true, "device": {...}}``.  Any failure ends the run with a
nonzero exit code; without a CUDA device, or without the repository's
sources beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.launch.mesh import MeshEvent, make_group_mesh, spawn_world  # noqa: E402
from repro_torch.analysis import check as analysis_check  # noqa: E402
from repro_torch.analysis import schedule as sched  # noqa: E402
from repro_torch.core.vortex import lamb_oseen_particles  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attn, m2l, ops, p2p, tf32  # noqa: E402
from repro_torch.models.transformer import (forward, init_cache, init_params,  # noqa: E402
                                             param_tensors, unembed)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
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
                box_size(tree.level), p)
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
    timed("l2p", lambda: ex.l2p_eval(le[L], tree.z, centers, box_size(L), p))
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
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


def serve_phase(dev, cfg, batch, prompt, new, max_len, profile: bool,
                other_route: str | None = None) -> tuple[dict, dict]:
    """``cfg`` behind ServeEngine.step_all; returns the phase's record and
    the launches of each flash kernel counted inside step_all.  With
    ``other_route``, after the counted run, one prefill is timed on the
    route ``flash_attn.route`` names and on ``other_route``, alternately."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in param_tensors(params))
    require(n_params == cfg.param_count, f"{n_params} parameters, config says "
            f"{cfg.param_count}")
    engine = ServeEngine(params, cfg, batch_slots=batch, max_len=max_len, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)

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

    prefill_fn, decode_fn = engine.prefill_fn, engine.decode_fn
    engine.prefill_fn = timed("prefill", prefill_fn)
    engine.decode_fn = timed("decode", decode_fn)
    engine.step_all(prompts, 2)                      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    for v in marks.values():
        v.clear()
    logits_seen.clear()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_flash_counts()
    t0 = time.perf_counter()
    out = engine.step_all(prompts, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    engine.prefill_fn, engine.decode_fn = prefill_fn, decode_fn

    require(out.shape == (batch, new), f"step_all returned {out.shape}")
    require(bool((out >= 0).all() and (out < cfg.vocab).all()), "token id out of range")
    require(all(bool(torch.isfinite(x).all()) for x in logits_seen), "non-finite logits")
    prefill_ms = sum(a.elapsed_time(b) for a, b in marks["prefill"])
    decode_ms = [a.elapsed_time(b) for a, b in marks["decode"]]
    decode_step_ms = sum(decode_ms) / len(decode_ms)

    # the logits that chose the last token against a teacher-forced forward
    chose_last = logits_seen[-2]            # decode step that produced out[:, -1]
    full = torch.cat([torch.as_tensor(prompts, device=dev),
                      torch.as_tensor(out[:, :-1], device=dev)], dim=1).long()
    with torch.inference_mode():
        h, _ = forward(params, full, cfg)
        forced = unembed(params, h[:, -1:], cfg)[:, 0]
    torch.cuda.synchronize()
    err = rel_l2(chose_last, forced)
    agree = float((forced.argmax(-1).cpu().numpy() == out[:, -1]).mean())
    require(err <= SERVE_TOL, f"decode vs teacher-forced logits rel L2 {err} > {SERVE_TOL}")

    record = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
              "params": n_params, "init_params_s": init_s, "batch": batch,
              "prompt": prompt, "new": new, "max_len": max_len,
              "step_all_s": total_s, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_step_ms, "decode_steps": len(decode_ms),
              "generated_tok_per_s": batch * new / total_s,
              "prompt_tok_per_s": batch * prompt / (prefill_ms / 1e3),
              "decode_tok_per_s": batch / (decode_step_ms / 1e3),
              "peak_bytes": peak, "flash_launches": launches,
              "rel_l2_decode_vs_forced": err, "gate": SERVE_TOL,
              "last_token_agreement_info": agree, "first_tokens": out[0, :8].tolist()}
    tokens = torch.as_tensor(prompts, device=dev).long()
    caches = init_cache(cfg, batch, max_len, device=dev)
    prefill = lambda: engine.prefill_fn(params, tokens, caches)  # noqa: E731
    if other_route is not None:
        record["prefill_ms_by_route"] = prefill_by_route(prefill, other_route)
    if profile:
        record["prefill_profile"] = device_profile(
            prefill, share_of=("flash_attn_tc", "copy"))
        first = torch.as_tensor(out[:, :1], device=dev).long()
        record["decode_profile"] = device_profile(
            lambda: engine.decode_fn(params, first, prompt, caches))
    return record, launches


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
    # past the first limits: P2P's streaming form, M2L's wide form
    wide_p2p_rows = [check_p2p_wide(*case, dev) for case in WIDE_P2P_CASES]
    wide_m2l_rows = [check_m2l_wide(*case, dev) for case in WIDE_M2L_CASES]
    for row in p2p_rows + lap_rows + passive_rows + m2l_rows + wide_p2p_rows + wide_m2l_rows:
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
    launches = {"p2p": p2p.LAUNCHES, "m2l": m2l.LAUNCHES}
    require(launches["p2p"] >= 2 * STEPS and launches["m2l"] >= 18 * STEPS,
            f"main path launches {launches}")
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
                                        SERVE_NEW, SERVE_MAX_LEN, profile=True)
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
                                   f"recurrentgemma-2b's attention, {dtype}"}

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
              launches_counted_in="phase 8: step_all of bf16 Yi-6B (d = 128)",
              head_dim_256=d256_block(tc_rows[1], "flash_attn_d256", "bf16")),
        entry(tf32_rows, "flash_attn_tf32", "src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
              "src/repro/kernels/flash_attn.py:32",
              launches_counted_in="phase 9: step_all of 2-layer f32 Yi-6B (d = 128)",
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
