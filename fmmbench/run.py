"""Run one cell of the benchmark once and print its result line.

    python3 -m fmmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's files are found by name
(:mod:`fmmbench.manifest`); its traffic mix names the entry that sets the
program up, runs the window and checks it.  Set-up (loading, the kernels'
build into ``build/kernels/`` of the checkout, inputs, warm-up) ends where
the window starts; the window runs the entry back to back for
``--seconds``; the check runs once the window has closed, the peak memory
has been read and the program's state is freed.  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``fmmbench/metrics/<name>.py``.

The last line of standard output is one JSON object; the numbers compared
for ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the line's last key.  Without a CUDA
card, without enough of them, or without the program's package, the run
exits non-zero and prints no result; so it does where, once every metric
has been read, the process holds ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro``.  An entry's state keeps its sample of the window in
``recorder`` (:class:`fmmbench.capture.Recorder`).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from fmmbench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, whole
THREADS = 4


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end(name: str, win: dict, setup_s: float) -> float:
    """An end-to-end metric from the window's host clock."""
    ms = [s * 1e3 for s in win["step_s"]]
    if name == "step_ms":
        return win["window_s"] * 1e3 / len(ms)
    if name == "step_p95_ms":
        return statistics.quantiles(ms, n=100, method="inclusive")[94]
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} in fmmbench/run.py")


def program(root: Path) -> None:
    """Put the checkout's ``src`` first on the path; fail without the port."""
    src = Path(root) / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"fmmbench: no program at {src / 'repro_torch'}; run from "
                         f"the root of a checkout")
    sys.path.insert(0, str(src))


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, control: bool = False, t_start: float | None = None) -> dict:
    """Set up, run the window, check.  Returns the entry's window, its
    trace (``trace``), the peak memory and the checks; with ``control``
    also the checks with the control in the program's place."""
    entry = manifest.load_module(cell.root, "entries", cell.traffic["entry"])
    if trace and device.type != "cuda":
        raise RuntimeError("--trace 1 reads the card's profiler: it needs a CUDA device")
    ctx = types.SimpleNamespace(cell=cell, seed=int(seed), seconds=float(seconds),
                                trace=bool(trace), device=device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(("p2p", "m2l"))
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)          # the allocator exists before its stats are reset
        torch.cuda.reset_peak_memory_stats(device)
    state = entry.prepare(ctx)
    setup_s = time.perf_counter() - (T_PROCESS if t_start is None else t_start)
    win = entry.window(state, ctx)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    captured = state.recorder.nbytes()
    traced = entry.finish(state, ctx)
    out = {"window": win, "trace": traced, "setup_s": setup_s, "peak": peak,
           "captured_bytes": captured, "checks": entry.judge(state, ctx)}
    if control:
        out["control_checks"] = entry.judge(state, ctx, control=True)
    return out


def per_layer(cell: manifest.Cell, traced: dict, win: dict) -> dict:
    """Each per-layer metric's reader on the trace; a reader that finds
    nothing returns None and the metric is left out."""
    traced = dict(traced, step_s=win["step_s"])
    out = {}
    for m in cell.per_layer:
        value = manifest.load_module(cell.root, "metrics", m["name"]).read(traced)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def result_line(cell: manifest.Cell, res: dict, trace: bool, device: dict) -> dict | None:
    """The result line of a run, or None where the process has loaded a
    module the benchmark may not load.  The look comes last, after every
    metric's reader has been loaded and run."""
    win, checks = res["window"], res["checks"]
    if trace:
        metrics = per_layer(cell, res["trace"], win)
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], win, res["setup_s"]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    found = forbidden_modules()
    if found:
        print(f"fmmbench: the run loaded {found}; the benchmark may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return None
    line = {"correct": passed(checks) and win["failed"] == 0,
            "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "device": dict(device)}
    prof = (res["trace"] or {}).get("profile")
    if trace and prof is not None:
        line["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.ROOT
    cell = manifest.load_cell(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fmmbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    program(root)
    torch.set_num_threads(THREADS)
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    line = result_line(cell, res, bool(args.trace),
                       {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, "memory_peak_bytes": int(res["peak"])})
    if line is None:
        return 3
    print(f"fmmbench: the check's captures hold {res['captured_bytes']} bytes of "
          f"memory_peak_bytes", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
