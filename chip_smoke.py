#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the paper's FMM configuration
(vortex steps, Laplace and tracer evaluations, the host-side planner) and
Yi-6B serving at full width.

Run from the repository root with no arguments:

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
              with holes in the target mask);
3. fmm      — ``build_tree`` then ``fmm_velocity_singular`` on the card, held
              to a float64 direct sum at 2048 sampled particles;
4. steps    — three guarded ``rk2_step``s: ``ok``, a clear health word and a
              conserved particle count, per-step and per-stage times, peak
              memory;
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
7. attn_vs_plain — the three flash-attention kernels against their
              plain version.  The bf16 tensor-core kernel at Yi-6B's
              prefill shape (4, 32, 4, 2048, 128) causal, at
              recurrentgemma-2b's attention (4, 10, 1, 2048, 256) bf16
              causal through ``ops.flash_attention`` (the d = 256 main path:
              one ``tc`` launch and no other), and at ragged T = S (77,
              1000, 2079), T < S, T > S, non-causal, Hkv 1, 4 and H, d 64,
              128 and 256, T = 1; the 3xTF32 kernel in f32 at the prefill
              shape, ragged T = S (1000, 2079), T < S, T > S, non-causal,
              Hkv 1, d 64 and T = 1; the SIMT kernel at recurrentgemma-2b's
              attention in f32 through ``ops.flash_attention`` (its main
              path: one ``simt`` launch and no other), the same attention
              in bf16 on the kernel itself, f32 at d 64 and 32 and a bf16
              d = 40 case.  Rel L2 gates 1e-5 (f32) and 5e-3 (bf16: output
              rounding alone is 2e-3, the tensor-core kernel's bf16 P about
              2e-3).  At the timed shapes: kernel, plain, bound and SDPA
              (yardstick) milliseconds; the tensor-core routes also on the
              model's strided views (gated as the contiguous inputs are),
              and the SIMT kernel on the same inputs (its time before the
              tensor-core routes);
8. serve    — Yi-6B at full width (random weights from a seeded generator)
              behind ``ServeEngine.step_all``: 4 prompts of 2048 tokens, 32
              greedy tokens each.  Gates: every logit finite; exactly 32
              tensor-core flash launches inside ``step_all`` (one per layer
              in prefill, none in decode) and no SIMT launch; the logits
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
              one prefill is timed on the 3xTF32 route and on the SIMT
              kernel, alternately (``prefill_ms_by_route``).

The launch counters are zeroed right before each main path (phase 3 for
the FMM kernels, each gated evaluation of phase 5 for P2P's Laplace and
passive modes, ``step_all`` in phases 8 and 9 for the tensor-core flash
kernels, phase 7's two recurrentgemma-2b calls for the bf16 tensor-core
kernel at d = 256 and the SIMT one) and read right after it: every kernel
must have run there.  Then come the card's
name and power limit as nvidia-smi reports them, the kernels line and,
last, ``{"ok": true, "device": {...}}``.  Any failure ends the run with a
nonzero exit code; without a CUDA device, or without the repository's
sources beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.petfmm_vortex import CONFIG  # noqa: E402
from repro_torch.core import expansions as ex  # noqa: E402
from repro_torch.core import fmm, health as hw  # noqa: E402
from repro_torch.core.cost_model import ModelParams  # noqa: E402
from repro_torch.core.equations import LAPLACE, TRACER, VORTEX  # noqa: E402
from repro_torch.core import plan as fmm_plan  # noqa: E402
from repro_torch.core.quadtree import Tree  # noqa: E402
from repro_torch.core.quadtree import (box_centers, box_size, build_tree,  # noqa: E402
                                       gather_particle_values, rebuild_tree)
from repro_torch.core.stepper import rk2_step  # noqa: E402
from repro_torch.core.vortex import lamb_oseen_particles  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attn, m2l, ops, p2p, tf32  # noqa: E402
from repro_torch.models.transformer import (forward, init_cache, init_params,  # noqa: E402
                                             param_tensors, unembed)
from repro_torch.serve.engine import ServeEngine  # noqa: E402

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

SLOTS = 8
LAPLACE_P = LAPLACE.default_p    # 16: the log expansion's order
PROBE_SIDE = 2048                # a cell-centred probe grid, 4 probes a leaf box
PROBE_SLOTS = 4
PLAN_PARTS = 64                  # the paper's largest processor count
PLAN_CUT = 4
DT = 1e-3
STEPS = 3
SAMPLES = 2048
KERNEL_TOL = 1e-5
FMM_TOL = 1e-3
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# recurrentgemma-2b (arXiv:2402.19427; src/repro/configs/recurrentgemma_2b.py):
# 10 heads, 1 KV head, head dim 256, local window 2048, so plain causal at
# 4 x 2048 tokens; the port's full-width head dim 256
RG_ATTN = (4, 10, 1, 2048, 2048, 256, True)
# (B, H, Hkv, T, S, d, causal, dtype); the first of each is the shape of its
# main path, timed: the serve phases' prefill (Yi-6B, 4 x 2048) for the
# tensor-core kernels, recurrentgemma-2b's attention in f32 for the SIMT
# one; the bf16 tensor-core kernel's second case, recurrentgemma-2b's
# attention in bf16, is its d = 256 main path, timed too
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
              (1, 8, 2, 1000, 1000, 64, True, torch.float32),
              (1, 4, 1, 2079, 2079, 128, True, torch.float32),
              (1, 4, 2, 100, 300, 128, True, torch.float32),
              (1, 4, 2, 300, 100, 64, True, torch.float32),
              (2, 4, 4, 200, 333, 128, False, torch.float32),
              (1, 2, 2, 1, 1, 64, True, torch.float32)]
SIMT_CASES = [(*RG_ATTN, torch.float32),
              (*RG_ATTN, torch.bfloat16),
              (1, 8, 2, 1000, 1000, 64, True, torch.float32),
              (1, 2, 2, 64, 192, 32, False, torch.float32),
              (1, 4, 2, 100, 33, 40, True, torch.bfloat16)]
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
        zh.data_ptr(), qh.data_ptr(), mh.data_ptr(), None, None, out.data_ptr(), rows,
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
    per_pair = {("base", True): P2P_OPS_SINGULAR, ("base", False): P2P_OPS_REGULARIZED,
                ("laplace", True): P2P_OPS_LAPLACE_SINGULAR,
                ("laplace", False): P2P_OPS_LAPLACE_REGULARIZED}[mode, sigma is None]
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
    p2p.LAUNCHES = m2l.LAUNCHES = 0
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


def check_flash(name, kernel, B, H, Hkv, T, S, d, causal, dtype, gen, timed: bool,
                main_path: bool = False):
    """``kernel`` against the plain version; with ``main_path`` the launch
    counters are zeroed before its first call and read after it."""
    dev = torch.device("cuda")
    q = torch.randn((B, H, T, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(dtype)
    if main_path:
        torch.cuda.synchronize()
        zero_flash_counts()
    got = kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    counts = flash_counts()
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
    if main_path:
        row["launches"] = counts
    if not timed:
        return row
    ops_ = 4 * d * B * H * causal_pairs(T, S, causal)       # QK^T and PV, 2 FLOP per FMA
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if dtype == torch.bfloat16:
        b_ms, b_by = bound_ms(nbytes, ops_, BF16_FLOP_PER_S)
        bound = dict(bound_ms=b_ms, bound_by=b_by,
                     fp32_simt_bound_ms=ops_ / FP32_FLOP_PER_S * 1e3)
    else:
        bound = f32_product_bound(nbytes, ops_)
    ke = k.repeat_interleave(H // Hkv, dim=1)                 # yardstick only
    ve = v.repeat_interleave(H // Hkv, dim=1)
    lib = F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
    if flash_attn.route(q, k) in ("tc", "tf32"):
        # the model's (B, T, H, d) -> (B, H, T, d) views, and the SIMT kernel
        # on the same inputs (its time before the tensor-core routes)
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
        **bound, ops=ops_, bytes=nbytes,
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


def main() -> None:
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
    for row in p2p_rows + lap_rows + passive_rows + m2l_rows:
        emit({"phase": "kernel_vs_plain", **row})

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
    w_at = gather_particle_values(w_reg, index)[torch.as_tensor(sample, device=dev)]
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
    del tree, index, w_sing, w_reg
    torch.cuda.empty_cache()

    # -- 5. main path: Laplace and tracer evaluations on the card, vs f64 ----
    equations = equations_phase(dev, pos, gamma, sigma, p, tree0, index0, sample,
                                tree_lap, probes, probe_pos, probe_index)
    del tree_lap, probes
    torch.cuda.empty_cache()

    # -- 6. the host-side planner at the paper's counts and processor count -
    plan_phase(index0.counts, level, p)
    del tree0

    # -- 7. flash attention against its plain version ------------------------
    # the tensor-core kernels' timed cases are the shape the serve phases'
    # prefills give them
    cfg = get_config(SERVE_ARCH)
    prefill_shape = (SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads, SERVE_PROMPT,
                     SERVE_PROMPT, cfg.head_dim or cfg.d_model // cfg.num_heads, True)
    require(TC_CASES[0][:7] == TF32_CASES[0][:7] == prefill_shape
            and (F32_BATCH, F32_PROMPT) == (SERVE_BATCH, SERVE_PROMPT),
            f"timed flash cases differ from the prefill shape {prefill_shape}")
    require(TC_CASES[1][:7] == SIMT_CASES[0][:7] == SIMT_CASES[1][:7] == RG_ATTN,
            "recurrentgemma-2b's attention is not the d = 256 cases' shape")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # recurrentgemma-2b's attention through the dispatcher, counted: in bf16
    # the tensor-core kernel's d = 256 main path, in f32 the SIMT kernel's;
    # the other cases run on each kernel itself
    tc_rows = [check_flash("flash_attn", flash_attn.flash_attention_tc, *TC_CASES[0],
                           gen=gen, timed=True),
               check_flash("flash_attn", ops.flash_attention, *TC_CASES[1],
                           gen=gen, timed=True, main_path=True)]
    tc_rows += [check_flash("flash_attn", flash_attn.flash_attention_tc, *case,
                            gen=gen, timed=False) for case in TC_CASES[2:]]
    tf32_rows = [check_flash("flash_attn_tf32", flash_attn.flash_attention_tf32, *case,
                             gen=gen, timed=(i == 0)) for i, case in enumerate(TF32_CASES)]
    simt_rows = [check_flash("flash_attn_simt", ops.flash_attention, *SIMT_CASES[0],
                             gen=gen, timed=True, main_path=True)]
    simt_rows += [check_flash("flash_attn_simt", flash_attn.flash_attention_cuda, *case,
                              gen=gen, timed=False) for case in SIMT_CASES[1:]]
    for row in tc_rows + tf32_rows + simt_rows:
        emit({"phase": "attn_vs_plain", **row})
    require(tc_rows[1]["launches"] == {"tc": 1, "tf32": 0, "simt": 0},
            f"recurrentgemma-2b attention in bf16 launched {tc_rows[1]['launches']}, "
            f"expected one tensor-core launch and no other")
    require(simt_rows[0]["launches"] == {"tc": 0, "tf32": 0, "simt": 1},
            f"recurrentgemma-2b attention in f32 launched {simt_rows[0]['launches']}, "
            f"expected one SIMT launch and no other")
    launches["flash_attn_d256"] = tc_rows[1]["launches"]["tc"]
    launches["flash_attn_simt"] = simt_rows[0]["launches"]["simt"]
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
             "max_abs_err": max(x["max_abs_err"] for x in rows),
             "rel_l2": max(x["rel_l2"] for x in rows),
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "fp32_simt_bound_ms" in r:                    # the products' FP32 SIMT figure
            e["fp32_simt_bound_ms"] = r["fp32_simt_bound_ms"]
        return {**e, **extra}

    def mode_entry(rows, counts, mode, counted_in):
        r = rows[0]
        return {"shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "rel_l2": max(x["rel_l2"] for x in rows),
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "launches": counts["p2p"][mode], "launches_counted_in": counted_in,
                "library_ms": None}

    print(card, flush=True)
    emit({"kernels": [
        entry(p2p_rows, "p2p", "src/repro_torch/kernels/csrc/p2p.cu",
              "src/repro/kernels/p2p.py:46",
              runtime_instance_ms=p2p_rows[0]["runtime_instance_ms"],
              modes={"laplace": mode_entry(lap_rows, equations["laplace"], "laplace",
                                           "phase 5: fmm_evaluate(eq=LAPLACE), singular"),
                     "passive_targets": mode_entry(
                         passive_rows, equations["tracer"], "base_passive",
                         "phase 5: fmm_evaluate(eq=TRACER, targets=probe grid), "
                         "singular")}),
        entry(m2l_rows, "m2l", "src/repro_torch/kernels/csrc/m2l.cu",
              "src/repro/kernels/m2l.py:43"),
        entry(tc_rows, "flash_attn", "src/repro_torch/kernels/csrc/flash_attn_tc.cu",
              "src/repro/kernels/flash_attn.py:32",
              launches_counted_in="phase 8: step_all of bf16 Yi-6B (d = 128)",
              head_dim_256={
                  k: tc_rows[1][k] for k in (
                      "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                      "simt_ms_same_inputs", "strided_ms", "rel_l2", "strided_rel_l2",
                      "max_abs_err")}
              | {"launches": launches["flash_attn_d256"],
                 "launches_counted_in": "phase 7: one ops.flash_attention call at "
                                        "recurrentgemma-2b's attention, bf16"}),
        entry(tf32_rows, "flash_attn_tf32", "src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
              "src/repro/kernels/flash_attn.py:32",
              simt_ms_same_inputs=tf32_rows[0]["simt_ms_same_inputs"]),
        entry(simt_rows, "flash_attn_simt", "src/repro_torch/kernels/csrc/flash_attn.cu",
              "src/repro/kernels/flash_attn.py:32",
              launches_counted_in="phase 7: one ops.flash_attention call at "
                                  "recurrentgemma-2b's attention shape "
                                  "(4, 10, 1, 2048, 2048, 256) f32 causal"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
