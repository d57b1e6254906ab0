#!/usr/bin/env python3
"""Where a key tile's time goes in the 3xTF32 flash kernel at head dim 256.

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/
flash_attn_tf32.cu`` into a temporary directory (never the library the
port loads): at each mark of ``MARKS``, placed after its line of the
d = 256 (``Smem<256>::SPLIT``) path, thread 0 of each warpgroup adds the
``clock64`` cycles since its previous mark to a device counter.  Runs the
copy once at recurrentgemma-2b's attention (4, 10, 1, 2048, 256) f32
causal and prints one JSON line: the cycles a tile spends in each phase,
for each warpgroup, the instrumented and the port's kernel's ms (the
counters cost some), and the card.  Fails if a mark's line is gone.
Needs the card and the CUDA toolkit:

    python3 tools/flash_tf32_phases.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, flash_attn as fa  # noqa: E402

SHAPE = (4, 10, 1, 2048, 2048, 256)    # B, H, Hkv, T, S, d; causal
# (phase ending at the mark, the source line the mark follows)
MARKS = [
    ("loop", "    const uint32_t ks = sk + st * L::K_BYTES;\n"),
    ("wait K", "      mbar_wait(bar_k, j & 1);\n"),
    ("split K", "      fence_proxy_async();\n      wg_sync(wg);\n"),
    ("S", "        for (int i = 0; i < BK / 2; ++i) s[i] = (cm[i] + sc[i]) + cm[BK / 2 + i];\n"),
    ("partial S, barrier", "        for (int i = 0; i < BK / 2; ++i) xs[i * 128 + wt] = s[i];\n"
                           "        __syncthreads();\n"),
    ("V TMA, other half", "        for (int i = 0; i < BK / 2; ++i) s[i] += other[i * 128 + wt];\n"
                          "      }\n"),
    ("softmax, P split", "          pl[kk][e] = x.lo;\n        }\n      }\n"),
    ("barrier, wait V", "        __syncthreads();\n        mbar_wait(bar_v, j & 1);\n"),
    ("V^T, barrier", "                           reinterpret_cast<float*>(w_reg + HALF), wt);\n"
                     "        fence_proxy_async();\n        __syncthreads();\n"),
    ("K TMA", "        vtlo = sw + HALF;\n      }\n"),
    ("P V", "      for (int i = 0; i < COLS / 2; ++i) o[i] = fmaf(o[i], alpha[(i / 2) % 2], part[i]);\n"),
]


def instrumented_source() -> str:
    src = (_build.CSRC / "flash_attn_tf32.cu").read_text()
    head = ('#include "tf32x3.cuh"\n'
            f"__device__ unsigned long long g_phase[{2 * len(MARKS)}];\n"
            "#define PH(k) if (SPLIT && tid % 128 == 0) { long long now_ = clock64(); "
            f"atomicAdd(&g_phase[(k) + {len(MARKS)} * wg], "
            "(unsigned long long)(now_ - tp_)); tp_ = now_; }\n")
    src = src.replace('#include "tf32x3.cuh"\n', head, 1)
    marks = [("start", "  const int wg = tid / 128;\n", "  long long tp_ = clock64();\n")]
    marks += [(name, line, f"PH({k})\n") for k, (name, line) in enumerate(MARKS)]
    for name, line, text in marks:
        if src.count(line) != 1:
            raise RuntimeError(f"mark {name!r}: its line is gone from the kernel source")
        src = src.replace(line, line + text)
    return src + (f'\nextern "C" int phase_read(void* dst) {{ return (int)cudaMemcpyFromSymbol('
                  f"dst, g_phase, sizeof(g_phase)); }}\n")


def tiles(B, H, T, S, bq, bk) -> int:
    """Key tiles the causal launch runs, over all blocks."""
    per_head = sum(-(-min(S, q0 + bq, T) // bk) for q0 in range(0, T, bq))
    return B * H * per_head


def cuda_ms(fn, iters=20) -> float:
    for _ in range(2):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_tf32_phases: needs a CUDA card")
    B, H, Hkv, T, S, d = SHAPE
    bq, bk, _, smem = fa.tf32_launch_config(d)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "flash_attn_tf32.cu", Path(tmp) / "phases.so"
        cu.write_text(instrumented_source())
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(so), str(cu)], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
    fn = lib.flash_attn_tf32_launch
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, *[i64] * 12, i, i, i, ctypes.c_float, i, vp]
    fn.restype = i
    lib.phase_read.argtypes, lib.phase_read.restype = [vp], i
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn((B, H, T, d), generator=gen, device="cuda")
    k, v = (torch.randn((B, Hkv, S, d), generator=gen, device="cuda") for _ in range(2))
    out = torch.empty((B, T, H, d), device="cuda").transpose(1, 2)
    strides = [x for t in (q, k, v, out) for x in fa._tma_strides("t", t)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, T, S,
                 d, *strides, bq, bk, smem, 1.0 / d ** 0.5, 1, stream)
        if err:
            raise RuntimeError(f"instrumented launch failed: {err}")

    run()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * (2 * len(MARKS)))()
    if lib.phase_read(counts):
        raise RuntimeError("reading the phase counters failed")
    err = float((out - fa.flash_attention_plain(q, k, v)).norm()
                / fa.flash_attention_plain(q, k, v).norm())
    n = tiles(B, H, T, S, bq, bk)
    per_tile = {f"wg{w}": {name: counts[w * len(MARKS) + j] / n
                           for j, (name, _) in enumerate(MARKS)} for w in range(2)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"shape": list(SHAPE), "tiles": n, "card": card,
                      "instrumented_rel_l2": err, "instrumented_ms": cuda_ms(run),
                      "kernel_ms": cuda_ms(lambda: fa.flash_attention_tf32(q, k, v)),
                      "cycles_per_tile": per_tile,
                      "cycles_per_tile_total": {w: sum(p.values()) for w, p in per_tile.items()}}))


if __name__ == "__main__":
    main()
