"""Production dry run: trace one rank's call of every (arch x shape x grid)
cell on fake tensors in a fake world of 256 or 512 ranks.

The port's counterpart of ``src/repro/launch/dryrun.py``.  The reference
forces 512 host devices, lowers and compiles each cell, and reads
``memory_analysis()``, ``cost_analysis()`` and the collectives of the
compiled program.  The port has no compiler and no program text, so each
cell runs rank 0's call itself:

* :func:`~repro_torch.launch.mesh.fake_world` starts a default process
  group of 256 or 512 ranks in this process (the ``fake`` backend: every
  collective returns at once), and ``make_production_mesh`` builds rank 0's
  grid over it;
* under ``FakeTensorMode`` the parameters, optimizer state and caches are
  drawn whole and rank 0 keeps its blocks; nothing is allocated;
* the call (``make_train_step``'s step, ``prefill_step(mesh=)`` or
  ``decode_step(mesh=)``, ``parallel_fmm_velocity`` on the flat mesh) runs
  under ``OpTrace`` (operations, FLOPs, mesh events) and ``PeakTracker``
  (the bytes its operations hold live).

Each cell returns the reference's keys: ``memory_analysis``
(``argument_bytes``: the rank's blocks of parameters, optimizer state,
batch and caches; ``output_bytes``; ``temp_bytes``: the peak of live bytes
the call's operations made, above the arguments; ``generated_code_bytes``:
None), ``cost_analysis`` and ``hlo_analysis`` (``analyze_trace``'s
``flops`` and ``bytes``), ``collectives`` (``per_kind``, ``total_bytes``,
``count``, by the reference's byte rule), ``num_chips`` and ``wall``
(``trace_s`` for the reference's ``lower_s`` and ``compile_s``), and
``fits``: arguments plus temporaries against the card's memory (the card's
own on a machine with one, else :data:`H100_HBM3_BYTES`).

The trace runs on CPU tensors, so every path takes its plain route (the
flash kernels need CUDA tensors): attention is the q-chunked exact softmax,
the reference's ``attn_impl="chunked"``, and the FMM its plain operators,
the reference's ``use_kernels=False``.  The port stores each parameter in
the dtype its forward reads (``models/transformer.py``), where the
reference keeps f32 master weights: a bf16 model's parameter bytes are half
the reference's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \\
        --shape train_4k --grid 1x1 --batch 2 --seq-len 2048

``--grid DxM`` (with ``--batch``, ``--seq-len``, ``--pos`` and
``--events``) traces a cell on a ``(data, model)`` grid of another size, to
hold a prediction against a measured run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.registry import get_config, lm_archs
from ..models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..models.transformer import init_cache, init_params, param_tensors
from ..optim.adamw import AdamWConfig, init_state
from ..parallel import sharding as shd
from ..serve import grid as sg
from ..serve.engine import decode_step, prefill_step
from ..train.loop import grid_specs, make_train_step
from .mesh import (fake_world, make_flat_mesh, make_grid_mesh, make_production_mesh)
from .trace_analysis import OpTrace, PeakTracker, analyze_trace

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (torch 2.11, CUDA 12.8): the card a rank of the production grid holds
H100_HBM3_BYTES = 85_017_493_504


def card_bytes() -> tuple[int, str]:
    """The memory a rank's card holds, and where the figure comes from."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), props.name
    return H100_HBM3_BYTES, "H100_HBM3_BYTES (NVIDIA H100 80GB HBM3)"


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``(shape, dtype)`` of every model input of this cell, whole."""
    b, t = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        t_text = t - (cfg.num_patches or 0)
        specs = {"tokens": ((b, t_text), i32), "labels": ((b, t_text), i32)}
        if cfg.num_patches:
            specs["patch_embeds"] = ((b, cfg.num_patches, cfg.patch_dim), torch.float32)
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": ((b, 1), i32), "pos": ((), i32)}


def abstract_params(cfg: ModelConfig, mesh):
    """This rank's blocks of the parameters: drawn whole (on fake tensors
    when a ``FakeTensorMode`` is active) and cut, each block in storage of
    its own."""
    full = init_params(cfg, torch.Generator(), "cpu")
    return sg.param_blocks(full, cfg, mesh)


def abstract_opt_state(params, state_dtype=torch.float32) -> dict:
    """AdamW's state for ``params`` (blocks make blocks)."""
    return init_state(params, AdamWConfig(state_dtype=str(state_dtype).removeprefix("torch.")))


def train_memory_plan(cfg: ModelConfig) -> dict:
    """Per-arch memory knobs for the train cells, the reference's:
    microbatches bound the live activations, bf16 optimizer states halve
    AdamW's memory for the 100B+ archs."""
    n = cfg.param_count
    if n > 100e9:
        return {"num_microbatches": 16, "state_dtype": torch.bfloat16}
    if n > 25e9:
        return {"num_microbatches": 8, "state_dtype": torch.float32}
    if n > 8e9:
        return {"num_microbatches": 4, "state_dtype": torch.float32}
    return {"num_microbatches": 1, "state_dtype": torch.float32}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, mesh=None):
    """The decode caches, whole, or with ``mesh`` this rank's blocks
    (:func:`cache_shardings`), each in storage of its own."""
    full = init_cache(cfg, batch, max_len, device="cpu")
    if mesh is None:
        return full
    return sg.shard_tree(full, sg.cache_specs(mesh, full), mesh)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------


def _dp(mesh):
    return shd.batch_axes(mesh)


def batch_shardings(mesh, specs: dict) -> dict:
    """The spec of every input of :func:`input_specs`: the batch over the
    batch axes where it divides them, ``pos`` replicated."""
    out = {}
    for k, (shape, _) in specs.items():
        if k == "pos":
            out[k] = ()
            continue
        ax = _dp(mesh) if shape[0] % shd.axis_size(mesh, _dp(mesh)) == 0 else None
        out[k] = (ax, *([None] * (len(shape) - 1)))
    return out


def cache_shardings(mesh, cfg: ModelConfig, caches) -> list[dict]:
    """The spec of every cache leaf by its role (KV, SSM, conv, ring
    positions: ``parallel/sharding.py:cache_spec``), in ``caches``'
    structure (one dict a layer)."""
    specs = iter(sg.cache_specs(mesh, caches))
    return [{k: next(specs) for k in layer} for layer in caches]


def _block_bytes(mesh, spec, shape, dtype) -> int:
    n = 1
    for d in shd.block_shape(mesh, tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, state_dtype=None) -> dict:
    """The bytes of one rank's arguments of a cell, by part (``params``,
    ``opt``, ``batch``, ``caches``), from the specs alone: nothing is
    made but tensors on the meta device.  ``mesh`` is a grid or an
    ``AbstractGrid``; ``state_dtype`` the optimizer state's (a train cell's
    :func:`train_memory_plan` by default).  A decode cell's ``pos`` is a
    host int in the port and counts nothing."""
    by_name = grid_specs(cfg, mesh)
    parts = {"params": 0, "opt": 0, "batch": 0, "caches": 0}
    if shape.kind == "train":
        state_dtype = state_dtype or train_memory_plan(cfg)["state_dtype"]
        parts["opt"] = torch.empty((), dtype=torch.int32).element_size()     # the step
    for name, t in shd.flat_names(init_params(cfg, torch.Generator(), "meta")):
        spec = by_name[name]
        parts["params"] += _block_bytes(mesh, spec, tuple(t.shape), t.dtype)
        if shape.kind == "train":
            parts["opt"] += 2 * _block_bytes(mesh, spec, tuple(t.shape), state_dtype)
    specs = input_specs(cfg, shape)
    bspecs = batch_shardings(mesh, specs)
    parts["batch"] = sum(_block_bytes(mesh, bspecs[k], s, d) for k, (s, d) in specs.items()
                         if k != "pos")
    if shape.kind != "train":
        caches = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        parts["caches"] = sum(_block_bytes(mesh, specs[k], tuple(t.shape), t.dtype)
                              for specs, layer in zip(cache_shardings(mesh, cfg, caches), caches)
                              for k, t in layer.items())
    return parts


def tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (its elements, not its storage)."""
    return sum(t.numel() * t.element_size() for t in param_tensors(tree))


# ---------------------------------------------------------------------------
# Cell runners
# ---------------------------------------------------------------------------


def _analyze(trace: OpTrace, peak: PeakTracker, args_bytes: int, out_bytes: int,
             nchips: int, wall: dict) -> dict:
    t0 = time.time()
    st = analyze_trace(trace)
    wall["parse_s"] = round(time.time() - t0, 2)
    cap, where = card_bytes()
    need = args_bytes + peak.peak
    top = sorted(peak.at_peak.items(), key=lambda kv: -kv[1])[:8]
    return {"memory_analysis": {"argument_bytes": args_bytes, "output_bytes": out_bytes,
                                "temp_bytes": peak.peak, "generated_code_bytes": None,
                                "temp_at_peak_by_op": dict(top)},
            "cost_analysis": {"flops": st["flops"], "bytes_accessed": st["bytes"]},
            "hlo_analysis": {"flops": st["flops"], "bytes": st["bytes"],
                             "bytes_by_op": st["bytes_by_op"]},
            "collectives": {"per_kind": st["per_kind"], "total_bytes": st["collective_bytes"],
                            "count": st["count"]},
            "num_chips": nchips, "wall": wall,
            "fits": {"bytes": need, "card_bytes": cap, "card": where, "ok": need <= cap}}


def _out_bytes(out) -> int:
    """Bytes of the distinct storages of ``out``'s tensors."""
    seen, n = set(), 0
    for t in param_tensors(out) if not isinstance(out, torch.Tensor) else [out]:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def _grid_of(multi_pod: bool, grid: Optional[tuple]):
    """(world size, a function building rank 0's grid, its label)."""
    if grid is None:
        return (512 if multi_pod else 256,
                lambda: make_production_mesh(multi_pod=multi_pod, device="cpu"),
                "2x16x16" if multi_pod else "16x16")
    size = grid[0] * grid[1]
    return size, lambda: make_grid_mesh(grid, ("data", "model"), device="cpu"), \
        f"{grid[0]}x{grid[1]}"


def _traced(fn, args, mesh, trace_out: dict):
    """Run ``fn(*args)`` under the tracers; fills ``trace_out``."""
    peak = PeakTracker(args)
    tr = OpTrace(args)
    mark = len(mesh.log)
    t0 = time.time()
    with peak, tr:
        out = fn(*args)
    trace_out.update(trace_s=round(time.time() - t0, 2), peak=peak, trace=tr,
                     events=list(mesh.log.since(mark)), out=out)


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool, donate: bool = True,
                overrides: Optional[dict] = None, *, grid: Optional[tuple] = None,
                batch: Optional[int] = None, seq_len: Optional[int] = None,
                pos: Optional[int] = None, events: bool = False,
                cfg: Optional[ModelConfig] = None) -> dict:
    """One LM cell on rank 0 of the production grid (or of a ``(data,
    model)`` ``grid``), at the shape ``shape_name`` (its batch and length
    replaced by ``batch``/``seq_len`` where given).  ``overrides`` are the
    reference's (``q_chunk``, ``mamba_chunk``, ``num_microbatches`` and
    config fields); ``donate`` is the reference's and changes nothing here
    (the port's steps write their arguments in place anyway).  ``pos`` is
    a decode cell's position (the last one by default).  With ``events``
    the result holds rank 0's mesh events (JSON).  ``cfg`` replaces the
    registry's config of ``arch`` (a smoke config, say)."""
    cfg = get_config(arch) if cfg is None else cfg
    q_chunk = 512
    micro = None
    if overrides:
        overrides = dict(overrides)
        q_chunk = overrides.pop("q_chunk", 512)
        mamba_chunk = overrides.pop("mamba_chunk", None)
        if mamba_chunk and cfg.mamba is not None:
            cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba,
                                                                     chunk=mamba_chunk))
        micro = overrides.pop("num_microbatches", None)
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq_len or shape.seq_len)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    world, build, label = _grid_of(multi_pod, grid)
    wall: dict = {}
    t_cell = time.time()
    got: dict = {}
    with fake_world(world), FakeTensorMode(allow_non_fake_inputs=True):
        mesh = build()
        t0 = time.time()
        params = abstract_params(cfg, mesh)
        specs = input_specs(cfg, shape)
        batch_in = {k: torch.zeros(s, dtype=d) for k, (s, d) in specs.items() if k != "pos"}
        if shape.kind == "train":
            plan = train_memory_plan(cfg)
            if micro is not None:
                plan["num_microbatches"] = micro
            # each microbatch must still split over the data-parallel axes
            dp_size = shd.axis_size(mesh, _dp(mesh))
            plan["num_microbatches"] = min(plan["num_microbatches"],
                                           max(shape.global_batch // dp_size, 1))
            opt = abstract_opt_state(params, plan["state_dtype"])
            parts = argument_bytes(cfg, shape, mesh, plan["state_dtype"])
            step = make_train_step(
                cfg, AdamWConfig(total_steps=1000,
                                 state_dtype=str(plan["state_dtype"]).removeprefix("torch.")),
                mesh, num_microbatches=plan["num_microbatches"], q_chunk=q_chunk)
            rows = {k: sg.local_rows(v, mesh) for k, v in batch_in.items()}
            rows = {k: v.clone() for k, v in rows.items()}
            del batch_in
            wall["setup_s"] = round(time.time() - t0, 2)
            _traced(step, (params, opt, rows), mesh, got)
            extra = {"num_microbatches": plan["num_microbatches"],
                     "state_dtype": str(plan["state_dtype"]).removeprefix("torch.")}
        else:
            caches = abstract_cache(cfg, shape.global_batch, shape.seq_len, mesh)
            parts = argument_bytes(cfg, shape, mesh)
            wall["setup_s"] = round(time.time() - t0, 2)
            if shape.kind == "prefill":
                patches = batch_in.get("patch_embeds")

                def fn(p, tok, c, pe=patches):
                    return prefill_step(p, tok, c, cfg, mesh=mesh, patch_embeds=pe,
                                        q_chunk=q_chunk)
                _traced(fn, (params, batch_in["tokens"], caches), mesh, got)
                extra = {}
            else:
                at = shape.seq_len - 1 if pos is None else pos

                def fn(p, tok, c):
                    return decode_step(p, tok, at, c, cfg, mesh=mesh)
                _traced(fn, (params, batch_in["token"], caches), mesh, got)
                extra = {"pos": at}
        out_bytes = _out_bytes(got["out"])
        wall["trace_s"] = got["trace_s"]
        out = _analyze(got["trace"], got["peak"], sum(parts.values()), out_bytes, mesh.size,
                       wall)
        out["memory_analysis"]["argument_parts"] = parts
        evs = got["events"]
        del got, params
    wall["cell_s"] = round(time.time() - t_cell, 2)
    out.update({"arch": arch, "shape": shape_name, "mesh": label,
                "batch": shape.global_batch, "seq_len": shape.seq_len,
                "layers": cfg.num_layers, "dtype": cfg.dtype, **extra})
    if events:
        out["events"] = [e.to_json() for e in evs]
    return out


def run_fmm_cell(multi_pod: bool, level: int = 10, slots: int = 2, p: int = 17, *,
                 world: Optional[int] = None) -> dict:
    """The paper's own app: the distributed FMM velocity evaluation on the
    flat mesh over the production grid's ranks (or over a fake world of
    ``world`` ranks), rank 0's call traced on a whole fake tree."""
    from ..analysis.retrace import clear_caches
    from ..core.parallel_fmm import parallel_fmm_velocity
    from ..core.quadtree import Tree

    size = world or (512 if multi_pod else 256)
    wall: dict = {}
    t_cell = time.time()
    got: dict = {}
    # the FMM keeps its device operators in caches: the trace starts cold, and
    # none of the fake operators it makes may outlive it
    clear_caches()
    with fake_world(size), FakeTensorMode(allow_non_fake_inputs=True):
        if world is None:
            mesh = make_flat_mesh(make_production_mesh(multi_pod=multi_pod, device="cpu"),
                                  "data")
        else:
            from .mesh import make_world_mesh
            mesh = make_world_mesh(world, device="cpu")
        n = 1 << level
        tree = Tree(z=torch.zeros((n, n, slots), dtype=torch.complex64),
                    q=torch.zeros((n, n, slots), dtype=torch.complex64),
                    mask=torch.zeros((n, n, slots), dtype=torch.bool),
                    level=level, sigma=0.02)
        args_bytes = tree_bytes([tree.z, tree.q, tree.mask])

        def fn(t):
            return parallel_fmm_velocity(t, p, mesh)
        try:
            _traced(fn, (tree,), mesh, got)
        finally:
            clear_caches()
        wall["trace_s"] = got["trace_s"]
        out = _analyze(got["trace"], got["peak"], args_bytes,
                       _out_bytes(got["out"]), mesh.size, wall)
        del got
    wall["cell_s"] = round(time.time() - t_cell, 2)
    out.update({"arch": "petfmm-vortex", "shape": f"level{level}_p{p}",
                "mesh": f"{size}flat" if world else ("512flat" if multi_pod else "256flat")})
    return out


def _grid_arg(text: Optional[str]):
    if text is None:
        return None
    d, m = (int(x) for x in text.lower().split("x"))
    return (d, m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fmm", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--tag", type=str, default=None,
                    help="suffix for output filenames (perf iterations)")
    # the reference's perf knobs
    ap.add_argument("--score-dtype", type=str, default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--remat-policy", type=str, default=None,
                    choices=[None, "full", "save_block_out"])
    ap.add_argument("--mamba-chunk", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--attn-impl", type=str, default=None,
                    choices=[None, "chunked", "skip_core"])
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--moe-gather-bits", type=int, default=None, choices=[None, 8, 16])
    # a cell on another grid, to hold against a measured run
    ap.add_argument("--grid", type=str, default=None,
                    help="DxM: a (data, model) grid of D*M fake ranks in place of "
                         "the production grid")
    ap.add_argument("--batch", type=int, default=None, help="the cell's global batch")
    ap.add_argument("--seq-len", type=int, default=None, help="the cell's length")
    ap.add_argument("--layers", type=int, default=None,
                    help="the model's depth cut to this many layers")
    ap.add_argument("--pos", type=int, default=None, help="a decode cell's position")
    ap.add_argument("--events", action="store_true",
                    help="keep rank 0's mesh events in each cell's JSON")
    args = ap.parse_args(argv)

    overrides = {}
    for flag, key in (("score_dtype", "score_dtype"), ("remat_policy", "remat_policy"),
                      ("mamba_chunk", "mamba_chunk"), ("microbatches", "num_microbatches"),
                      ("attn_impl", "attn_impl"), ("q_chunk", "q_chunk"),
                      ("moe_gather_bits", "moe_gather_bits"), ("layers", "num_layers")):
        if getattr(args, flag) is not None:
            overrides[key] = getattr(args, flag)

    if args.fmm:
        cells = [("petfmm-vortex", "fmm")]
    elif args.all:
        cells = [(a, s) for a in lm_archs() for s in SHAPES]
        cells.append(("petfmm-vortex", "fmm"))
    else:
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all, or --fmm")
        cells = [(args.arch, args.shape)]
    grid = _grid_arg(args.grid)
    label_mesh = args.grid or ("2x16x16" if args.multi_pod else "16x16")

    results = []
    t_all = time.time()
    for arch, shape in cells:
        label = f"{arch} x {shape} ({label_mesh})"
        try:
            if shape == "fmm":
                res = run_fmm_cell(args.multi_pod)
            else:
                res = run_lm_cell(arch, shape, args.multi_pod,
                                  overrides=dict(overrides) if overrides else None,
                                  grid=grid, batch=args.batch, seq_len=args.seq_len,
                                  pos=args.pos, events=args.events)
            status = "SKIP: " + res["skipped"] if "skipped" in res else "OK"
        except Exception as e:
            res = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
            status = f"FAIL: {e}"
            print(res["traceback"], flush=True)
        results.append(res)
        print(f"[dryrun] {label}: {status}", flush=True)
        if "memory_analysis" in res:
            mem, fit = res["memory_analysis"], res["fits"]
            print(f"  memory: {mem}", flush=True)
            print(f"  fits: {fit['bytes'] / 1e9:.3f} GB a rank of {fit['card_bytes'] / 1e9:.3f}"
                  f" ({fit['card']}): {'yes' if fit['ok'] else 'NO'}", flush=True)
            print(f"  cost: {res['cost_analysis']}", flush=True)
            print(f"  collectives: total={res['collectives']['total_bytes']:.3e} B "
                  f"count={res['collectives']['count']} ({res['collectives']['per_kind']})",
                  flush=True)
            print(f"  wall: {res['wall']}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            tag = "mp" if args.multi_pod else "sp"
            if args.tag:
                tag += "__" + args.tag
            fname = f"{res['arch']}__{res['shape']}__{tag}.json".replace("/", "_")
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(res, f, indent=1)
    nfail = sum("error" in r for r in results)
    print(f"[dryrun] done: {len(results)} cells, {nfail} failures in "
          f"{time.time() - t_all:.1f} s", flush=True)
    if len(results) > 1:
        print("\n".join(table(results)), flush=True)
    return 0 if nfail == 0 else 1


def _num(x: float) -> str:
    return f"{x:.0f}" if x >= 100 else f"{x:.1f}" if x >= 1 else f"{x:.3g}"


def table(results: list) -> list[str]:
    """The cells as Markdown, a row an arch and a column a shape: a rank's
    arguments + temporaries in GB ("over" where their sum exceeds the
    card), TFLOP and collective GB a call; the FMM cell in its own row."""
    shapes = list(SHAPES)
    rows = ["| Arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    by_arch: dict = {}
    for r in results:
        by_arch.setdefault(r["arch"], {})[r["shape"]] = r

    def cell(r) -> str:
        if r is None or "skipped" in r:
            return "skipped" if r is not None else ""
        if "memory_analysis" not in r:
            return "FAILED"
        mem = r["memory_analysis"]
        return (f"{mem['argument_bytes'] / 1e9:.2f} + {mem['temp_bytes'] / 1e9:.2f}"
                f"{'' if r['fits']['ok'] else ' over'}; {_num(r['cost_analysis']['flops'] / 1e12)}"
                f"; {_num(r['collectives']['total_bytes'] / 1e9)}")
    for arch, cells in by_arch.items():
        if arch == "petfmm-vortex":
            ((shape, r),) = cells.items()
            rows.append(f"| {arch} ({shape}) | {cell(r)} |" + " |" * (len(shapes) - 1))
        else:
            rows.append(f"| {arch} | " + " | ".join(cell(cells.get(s)) for s in shapes) + " |")
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
