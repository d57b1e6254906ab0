"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program.  Top-level module names compared whole, in
a fresh interpreter."""
from __future__ import annotations

import json
import subprocess
import sys

from fmmbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HARNESS = ["fmmbench", "fmmbench.run", "fmmbench.control", "fmmbench.manifest",
           "fmmbench.traffic", "fmmbench.reference", "fmmbench.counts", "fmmbench.checks",
           "fmmbench.profiling", "fmmbench.roofline", "fmmbench.capture", "fmmbench.entries.stepper",
           "fmmbench.entries.evaluate"]
YARDSTICK = ["fmmbench.reference", "fmmbench.counts", "fmmbench.checks", "fmmbench.traffic",
             "fmmbench.roofline"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_a_small_run_load_no_jax_and_no_jax_package():
    code = "\n".join(f"import {m}" for m in HARNESS) + (
        "\nfrom fmmbench import manifest\n"
        "from fmmbench.tests import tiny\n"
        "for name in tiny.CELLS:\n"
        "    res = tiny.run_small(name, seconds=0.2)\n"
        "    assert res['correct'], res['checks']\n"
        "for m in manifest.load_manifest()['per_layer']:\n"
        "    manifest.load_module(manifest.ROOT, 'metrics', m['name'])\n")
    loaded = loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_and_yardstick_load_nothing_of_the_program():
    loaded = loaded_after("\n".join(f"import {m}" for m in YARDSTICK))
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded
