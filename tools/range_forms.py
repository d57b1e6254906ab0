#!/usr/bin/env python3
"""Time P2P's streaming form and M2L's wide form against another checkout's
build of them, and at forced launch configurations.

For each of ``chip_smoke.py``'s ``WIDE_P2P_CASES`` and ``WIDE_M2L_CASES``
(the FMM service's grids past the tiled kernels' limits, and one grid of
each that fills the card), the kernel of this checkout and that of another
(``--other``, e.g. the parent unpacked by ``git archive`` under ``build/``)
are launched through their own wrappers, each checked against this
checkout's plain version (rel L2 <= 1e-5, masked targets exactly 0) and
timed with CUDA events in turns: other, this, this, other.  ``--sweep``
also times this checkout's kernels at every cluster split (P2P: 1, 3, 9;
M2L: 1, 2, 4, 8 at three slice widths), through an
entry point compiled beside the sources.  One JSON line a case, the card's
name and power limit first.  Needs a CUDA card and the CUDA toolkit:

    python3 tools/range_forms.py --other build/parent --sweep
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

import chip_smoke as cs  # noqa: E402
import turns  # noqa: E402
from repro_torch.core.equations import VORTEX  # noqa: E402
from repro_torch.kernels import _build, m2l, ops, p2p  # noqa: E402

SWEEP_P2P_SPLITS = (1, 3, 9)
SWEEP_M2L_SPLITS = (1, 2, 4, 8)
FORCED = r"""
#include "{csrc}/m2l.cu"
extern "C" int m2l_forced(const void* stack, const void* W, void* out, int batch, int PR,
                          int PC, int p, int nsl, int split, void* stream) {{
  return run_wide(stack, W, out, batch, PR, PC, p, slice_config(p, nsl, split),
                  (cudaStream_t)stream);
}}
""", r"""
#include "{csrc}/p2p.cu"
extern "C" int p2p_forced(const void* z, const void* q, const void* m, const void* zt,
                          const void* mt, void* out, int batch, int rows, int cols, int s,
                          int st, int nout, int split, float two_s2, int singular,
                          void* stream) {{
  cudaStream_t sm = (cudaStream_t)stream;
  const bool passive = zt != nullptr;
  if (nout == 1)
    return (passive ? launch_stream<1, true> : launch_stream<1, false>)(
        z, q, m, zt, mt, out, batch, rows, cols, s, st, split, two_s2, singular, sm);
  return (passive ? launch_stream<2, true> : launch_stream<2, false>)(
      z, q, m, zt, mt, out, batch, rows, cols, s, st, split, two_s2, singular, sm);
}}
"""


def forced_libs(tmp: Path):
    """This checkout's kernels with the forced-configuration entry points."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    procs = []
    for name, text in zip(("m2l", "p2p"), FORCED):
        src, so = tmp / f"{name}_forced.cu", tmp / f"{name}_forced.so"
        src.write_text(text.format(csrc=csrc))
        procs.append((so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                            str(so), str(src)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    libs = []
    for so, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(report)
        libs.append(ctypes.CDLL(str(so)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs[0].m2l_forced.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    libs[1].p2p_forced.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                                   ctypes.c_float, i, vp]
    return libs


def timed(fns: dict, iters: int) -> dict:
    """CUDA-event ms of each callable, in turns other, this, this, other."""
    out: dict = {}
    for k in turns.order(["other"] if "other" in fns else [], "this"):
        out.setdefault(k, []).append(cs.cuda_ms(fns[k], iters))
    return out


def p2p_case(s, side, mode, passive, other, lib, sweep):
    dev = torch.device("cuda")
    zh, qh, mh, zt, mt = cs.wide_p2p_inputs(s, side, passive, s + side, dev)
    nout = p2p.MODES[mode].nout
    want = p2p.p2p_plain(zh, qh, mh, cs.WIDE_SIGMA, zt, mt, mode)
    live = mh[1:-1, 1:-1] if mt is None else mt
    live = live if want.ndim == 3 else live[..., None].expand(want.shape)

    def check(got, what):
        err = cs.rel_l2(got[live], want[live])
        cs.require(err <= cs.KERNEL_TOL and bool((got[~live] == 0).all()),
                   f"p2p s={s} {side}x{side} {mode} {what}: rel L2 {err} or a masked "
                   f"target not 0")
        return err

    fns = {"this": lambda: p2p.p2p_cuda(zh, qh, mh, cs.WIDE_SIGMA, zt, mt, mode)}
    if other:
        fns["other"] = lambda: other[0].p2p_cuda(zh, qh, mh, cs.WIDE_SIGMA, zt, mt, mode)
    errs = {k: check(f(), k) for k, f in fns.items()}
    row = {"kernel": "p2p_stream", "slots": s, "side": side, "mode": mode,
           "passive": passive, "split": p2p.stream_launch_config(side, side, s, s, nout)[0],
           "rel_l2": errs, "ms": timed(fns, 10)}
    if sweep:
        st = s
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def forced(split):
            err = lib.p2p_forced(zh.data_ptr(), qh.data_ptr(), mh.data_ptr(),
                                 None if zt is None else zt.data_ptr(),
                                 None if mt is None else mt.data_ptr(), out.data_ptr(), 1,
                                 side, side, s, st, nout, split,
                                 2.0 * cs.WIDE_SIGMA ** 2, 0, stream)
            cs.require(err == 0, f"p2p forced split {split}: CUDA error {err}")
            return out
        row["sweep"] = {}
        for split in SWEEP_P2P_SPLITS:
            err = check(forced(split).clone(), f"split {split}")
            row["sweep"][split] = {"rel_l2": err, "ms": cs.cuda_ms(lambda: forced(split), 10)}
    return row


def m2l_case(p, batch, n, other, lib, sweep):
    dev = torch.device("cuda")
    shape = ((batch,) if batch else ()) + (n + 2, n + 2, 4 * p)
    gen = torch.Generator(device=dev).manual_seed(p)
    stack = torch.complex(torch.randn(shape, generator=gen, device=dev),
                          torch.randn(shape, generator=gen, device=dev))
    W = ops.folded_operator(VORTEX, p, 4, dev)
    want = m2l.m2l_plain(stack, W)

    def check(got, what):
        err = cs.rel_l2(got, want)
        cs.require(err <= cs.KERNEL_TOL, f"m2l p={p} {n}x{n} {what}: rel L2 {err}")
        return err

    fns = {"this": lambda: m2l.m2l_cuda(stack, W)}
    if other:
        fns["other"] = lambda: other[1].m2l_cuda(stack, W)
    errs = {k: check(f(), k) for k, f in fns.items()}
    row = {"kernel": "m2l_wide", "p": p, "batch": batch, "parents": n,
           "config": m2l.wide_launch_config(n, n, p), "rel_l2": errs, "ms": timed(fns, 50)}
    if sweep:
        out = torch.empty_like(want)
        Ws = m2l.cached_split(W)
        stream = torch.cuda.current_stream().cuda_stream

        def forced(cfg):
            err = lib.m2l_forced(stack.data_ptr(), Ws.data_ptr(), out.data_ptr(),
                                 batch or 1, n, n, p, *cfg, stream)
            cs.require(err == 0, f"m2l forced {cfg}: CUDA error {err}")
            return out
        row["sweep"] = []
        for nsl in sorted({-(-p // 32), -(-p // 16), -(-p // 8)}):
            for split in SWEEP_M2L_SPLITS:
                cfg = (nsl, split)
                err = check(forced(cfg).clone(), f"forced {cfg}")
                row["sweep"].append({"slices": nsl, "split": split, "rel_l2": err,
                                     "ms": cs.cuda_ms(lambda: forced(cfg), 30)})
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="another checkout to time against")
    ap.add_argument("--sweep", action="store_true", help="time forced configurations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("range_forms: needs a CUDA card")
    print(json.dumps({"card": turns.card()}), flush=True)
    other = (turns.load_checkout(args.other, "other_repro_torch", "kernels.p2p", "kernels.m2l")
             if args.other else None)
    with tempfile.TemporaryDirectory() as tmp:
        libs = forced_libs(Path(tmp)) if args.sweep else (None, None)
        for case in cs.WIDE_P2P_CASES:
            print(json.dumps(p2p_case(*case, other, libs[1], args.sweep)), flush=True)
        for case in cs.WIDE_M2L_CASES:
            print(json.dumps(m2l_case(*case, other, libs[0], args.sweep)), flush=True)


if __name__ == "__main__":
    main()
