"""Read a cell's compared numbers for the program and for its control.

    python3 -m fmmbench.control --workload <cell> --seeds 1,2,3 --seconds 5

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at the cell's own size and load, then the check twice, once
on the program's outputs and once with the control (the reference in
TF32, ``fmmbench.reference``) in the program's place.  One JSON line a
seed.  The lower reading of each limit is the largest the program gives,
the upper the smallest the control gives (PERF.md).  The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from fmmbench import manifest, run


def readings(cell, seeds, seconds: float, device) -> list[dict]:
    out = []
    for seed in seeds:
        res = run.run_cell(cell, seed, seconds, False, device, control=True,
                           t_start=time.perf_counter())
        out.append({"workload": cell.name, "seed": seed,
                    "steps": len(res["window"]["step_s"]),
                    "failed": res["window"]["failed"],
                    "setup_s": res["setup_s"],
                    "program": {k: c["value"] for k, c in res["checks"].items()},
                    "control": {k: c["value"] for k, c in res["control_checks"].items()},
                    "limits": {k: c["limit"] for k, c in res["checks"].items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("fmmbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    run.program(manifest.ROOT)
    torch.set_num_threads(run.THREADS)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(cell, seeds, args.seconds, torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
