#!/usr/bin/env python3
"""Time the simt route's flash-attention kernel against another checkout's,
and at forced cluster splits.

For each of ``chip_smoke.py``'s ``SIMT_TIMED`` cases (the route's served
shape, recurrentgemma-2b's attention on the kernel itself in f32 and bf16,
Phi-3-mini's attention through ``ops.flash_attention`` on the model's
``(B, T, H, d)`` views, bf16 and f32), the kernel of this checkout and that
of another (``--other``, e.g. the parent unpacked by ``git archive`` under
``build/``) run through their own wrappers, each checked against this
checkout's plain version (rel L2 within ``chip_smoke.ATTN_TOL``), and are
timed with CUDA events in turns: other, this, this, other; SDPA (KV heads
expanded, the yardstick) is timed beside them.  ``--sweep`` also runs this
checkout's kernel at every cluster split 1..8 on the small grids of
``SWEEP_CASES``, through an entry point compiled beside the source, each
split checked and launched twice (the second bit for bit the first).
``--variants`` times the design alternatives of ``VARIANTS`` (the source
with one choice of ``csrc/flash_attn.cu`` undone, built the same way) at
the timed cases, in turns: the source, each variant, the source.  One JSON
line a case, the card's name and power limit first.  Needs a CUDA card and
the CUDA toolkit:

    python3 tools/simt_flash.py --other build/parent --sweep --variants
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
import turns  # noqa: E402
from repro_torch.kernels import _build, flash_attn, ops  # noqa: E402

# (B, H, Hkv, T, S, d, causal, dtype) at forced splits: the served shape,
# one in bf16, a ragged one whose key range the splits do not divide
SWEEP_CASES = [(1, 2, 2, 64, 192, 32, False, torch.float32),
               (1, 2, 2, 64, 192, 32, False, torch.bfloat16),
               (1, 4, 2, 100, 333, 40, True, torch.bfloat16),
               (1, 2, 1, 130, 300, 200, True, torch.float32)]
FORCED = r"""
#include "{source}"
extern "C" int flash_attn_forced(
    const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv, int T,
    int S, int d, const long long* strides, int split, float scale, int causal, int bf16,
    void* stream) {{
  if (!valid_shape(B, H, Hkv, T, S, d)) return (int)cudaErrorInvalidValue;
  Config c = config(d, bf16 != 0, (long long)B * H, T, S, causal);
  if (split) c.split = split;
  return run(make_params(q, k, v, out, B, H, Hkv, T, S, d, strides, scale, causal), c,
             bf16 != 0, (cudaStream_t)stream);
}}
"""
# Design alternatives of csrc/flash_attn.cu, each one edit of its text that
# undoes a choice the source notes; PERF.md §6 has their times
VARIANTS = {
    # bf16 up to d = 128 on warps of 16 rows, not 32
    "warps_of_16": ("  if (T > 64 && bf16 && dclass(d) <= 128) {\n    c.rows = 128;\n  } else if",
                    "  if (false) {\n  } else if"),
    # f32 past d = 192 on 32-key tiles and 64 rows, not 16 and 128
    "keys_32": ("    if (!bf16 && smem_bytes(d, bf16, 128, c.bk, c.stages) > MAX_SMEM) c.bk = 16;\n",
                ""),
    # a head's q tiles launched together, not the heaviest q tile of every head first
    "heads_major": ("const int bh = idx % prm.BH, qt = nqt - 1 - idx / prm.BH;",
                    "const int bh = idx / nqt, qt = nqt - 1 - idx % nqt;"),
}


def forced_libs(tmp: Path, variants=()) -> dict:
    """This checkout's simt kernel (``"source"``) and each named variant,
    with an entry point that takes the cluster split as an argument (0: the
    rule's); all compiled at once."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    text = (csrc / "flash_attn.cu").read_text().replace(
        '#include "tf32x3.cuh"', f'#include "{csrc}/tf32x3.cuh"')
    procs = {}
    for name in ("source", *variants):
        edited = text
        if name != "source":
            old, new = VARIANTS[name]
            if old not in text:
                raise RuntimeError(f"variant {name}: its line of csrc/flash_attn.cu is gone")
            edited = text.replace(old, new, 1)
        (tmp / f"{name}.cu").write_text(edited)
        (tmp / f"{name}_forced.cu").write_text(FORCED.format(source=tmp / f"{name}.cu"))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}_forced.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(report)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forced.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp, i,
                                          ctypes.c_float, i, i, vp]
        lib.flash_attn_forced.restype = i
        libs[name] = lib
    return libs


def forced_lib(tmp: Path) -> ctypes.CDLL:
    """This checkout's simt kernel with the forced-split entry point."""
    return forced_libs(tmp)["source"]


def forced(lib, q, k, v, causal: bool, split: int = 0) -> torch.Tensor:
    """One launch of the kernel at ``split`` blocks a cluster (0: the rule's
    split); output as ``flash_attn.flash_attention_cuda``'s."""
    B, H, T, d = q.shape
    out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for s in flash_attn._tma_strides(name, t)]
    arr = (ctypes.c_longlong * 12)(*strides)
    err = lib.flash_attn_forced(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                B, H, k.shape[1], T, k.shape[2], d, arr, split,
                                1.0 / d ** 0.5, int(causal), int(q.dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_forced split {split}: CUDA error {err}")
    return out


def inputs(B, H, Hkv, T, S, d, dtype, views: bool, seed: int):
    """q, k, v from a seeded generator on the card; with ``views`` the
    model's ``(B, T, H, d) -> (B, H, T, d)`` transposed views."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def one(h, n):
        shape = (B, n, h, d) if views else (B, h, n, d)
        t = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return t.transpose(1, 2) if views else t
    return one(H, T), one(Hkv, S), one(Hkv, S)


def timed_case(case, other, iters: int) -> dict:
    (B, H, Hkv, T, S, d, causal, dtype), via = case[:8], case[8]
    q, k, v = inputs(B, H, Hkv, T, S, d, dtype, via == "ops", seed=T + d)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal).float()
    tol = cs.ATTN_TOL[dtype]
    if via == "ops":
        fns = {"this": lambda: ops.flash_attention(q, k, v, causal=causal)}
        if other:
            fns["other"] = lambda: other[1].flash_attention(q, k, v, causal=causal)
    else:
        fns = {"this": lambda: flash_attn.flash_attention_cuda(q, k, v, causal=causal)}
        if other:
            fns["other"] = lambda: other[0].flash_attention_cuda(q, k, v, causal=causal)
    errs = {}
    for name, fn in fns.items():
        before = flash_attn.LAUNCHES
        got = fn()
        torch.cuda.synchronize()
        if name == "this":
            cs.require(flash_attn.LAUNCHES == before + 1, f"{case}: not one simt launch")
        errs[name] = cs.rel_l2(got.float(), want)
        cs.require(errs[name] <= tol, f"{case} {name}: rel L2 {errs[name]} > {tol}")
    first = fns["this"]()
    again = fns["this"]()
    torch.cuda.synchronize()
    ms: dict = {}
    for name in turns.order(["other"] if other else [], "this"):
        ms.setdefault(name, []).append(cs.cuda_ms(fns[name], iters))
    ke = k.repeat_interleave(H // Hkv, dim=1)
    ve = v.repeat_interleave(H // Hkv, dim=1)
    sdpa_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=causal),
                         iters)
    return {"case": [B, H, Hkv, T, S, d, causal, str(dtype)], "via": via,
            "launch": flash_attn.simt_launch_config(d, dtype, (B, H, T, S, causal)),
            "rel_l2": errs, "bitwise_repeat": bool(torch.equal(first, again)),
            "ms": ms, "sdpa_ms": sdpa_ms, **cs.flash_bound(B, H, Hkv, T, S, d, causal, dtype)}


def sweep_case(case, lib) -> dict:
    B, H, Hkv, T, S, d, causal, dtype = case
    q, k, v = inputs(B, H, Hkv, T, S, d, dtype, True, seed=S + d)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal).float()
    rows = {}
    for split in range(1, 9):
        a, b = forced(lib, q, k, v, causal, split), forced(lib, q, k, v, causal, split)
        torch.cuda.synchronize()
        err = cs.rel_l2(a.float(), want)
        cs.require(err <= cs.ATTN_TOL[dtype] and torch.equal(a, b),
                   f"{case} split {split}: rel L2 {err} or a repeat differs")
        rows[split] = {"rel_l2": err, "bitwise_repeat": True,
                       "ms": cs.cuda_ms(lambda: forced(lib, q, k, v, causal, split), 50)}
    return {"case": [B, H, Hkv, T, S, d, causal, str(dtype)],
            "split_by_rule": flash_attn.simt_launch_config(d, dtype, (B, H, T, S, causal))[5],
            "sweep": rows}


def variants_case(case, libs) -> dict:
    """The timed case on the source and each variant (the kernel alone,
    checked against the plain version), in turns: the source, each
    variant, the source."""
    (B, H, Hkv, T, S, d, causal, dtype), via = case[:8], case[8]
    q, k, v = inputs(B, H, Hkv, T, S, d, dtype, via == "ops", seed=T + d)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal).float()
    names = ["source", *[n for n in libs if n != "source"], "source"]
    ms: dict = {}
    for name in names:
        err = cs.rel_l2(forced(libs[name], q, k, v, causal).float(), want)
        cs.require(err <= cs.ATTN_TOL[dtype], f"{case} variant {name}: rel L2 {err}")
        ms.setdefault(name, []).append(
            cs.cuda_ms(lambda: forced(libs[name], q, k, v, causal), 20))
    return {"case": [B, H, Hkv, T, S, d, causal, str(dtype)], "via": via, "ms": ms}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="another checkout to time against")
    ap.add_argument("--sweep", action="store_true", help="time forced cluster splits")
    ap.add_argument("--variants", action="store_true", help="time the design alternatives")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("simt_flash: needs a CUDA card")
    print(json.dumps({"card": turns.card()}), flush=True)
    other = (turns.load_checkout(args.other, "other_repro_torch", "kernels.flash_attn",
                                 "kernels.ops") if args.other else None)
    for case in cs.SIMT_TIMED:
        print(json.dumps(timed_case(case, other, args.iters)), flush=True)
    if args.sweep or args.variants:
        with tempfile.TemporaryDirectory() as tmp:
            libs = forced_libs(Path(tmp), VARIANTS if args.variants else ())
            for case in SWEEP_CASES if args.sweep else ():
                print(json.dumps(sweep_case(case, libs["source"])), flush=True)
            for case in cs.SIMT_TIMED if args.variants else ():
                print(json.dumps(variants_case(case, libs)), flush=True)


if __name__ == "__main__":
    main()
