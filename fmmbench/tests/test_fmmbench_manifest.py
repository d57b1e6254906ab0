"""BENCHMARK.json against the benchmark's contract, and its files by name."""
from __future__ import annotations

import json
import re
import shutil
import statistics

import pytest

from fmmbench import manifest
from fmmbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|"
                   r"_dim$|_rank$|experts_per_token)")


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_top_level_keys_and_limits(m):
    assert set(m) == TOP
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(".." not in p and not p.startswith("/") for p in m["paths"] + m["command"])
    assert 1 <= len(m["command"]) <= 32
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells = len(m["workloads"])
    check_s = (2 + 14 * cells) * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert check_s <= 43200
    assert len(json.dumps(m).encode()) <= 64 * 1024


def test_entries_have_exactly_the_contract_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert [e for e in m["end_to_end"] if e["name"] == "setup_s"][0]["bound"] <= 0.25


def test_names_units_and_texts_are_in_the_allowed_characters(m):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in m[group]:
            assert NAME.match(x["name"]), x["name"]
            names.append((group, x["name"]))
            texts = {"configs": ("why", "source"), "workloads": ("why",),
                     "per_layer": ("layer",)}.get(group, ())
            for key in texts:
                text = x[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
            if "better" in x:
                assert x["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(set(got)) == len(got)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_setup_and_one_more_end_to_end_and_a_per_layer_metric(m):
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        target = e2e[p["moves"]]
        for cell in p.get("workloads", sorted(cells)):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"], (p["name"], cell)
    layers = {}
    for p in m["per_layer"]:
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_of_a_peak_are_in_percent(m):
    for p in m["per_layer"]:
        if p["name"].endswith("_roofline") or "mfu" in p["name"] or "share" in p["name"]:
            assert p["unit"] == "%", p["name"]


def test_every_cell_configuration_traffic_entry_and_metric_file_is_found_by_name(m):
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.spec["name"] == w["name"]
        entry = manifest.load_module(cell.root, "entries", cell.traffic["entry"])
        for fn in ("prepare", "window", "finish", "judge"):
            assert callable(getattr(entry, fn))
    for p in m["per_layer"]:
        assert callable(manifest.load_module(manifest.ROOT, "metrics", p["name"]).read)
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith(m["paths"][0] + "/") for f in files)


def test_every_configuration_is_used_and_cut_by_scale_alone(m):
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert cfg["n_side"] ** 2 == cfg["num_particles"]


def test_cells_name_their_checks_limits(m):
    for w in m["workloads"]:
        limits = manifest.load_cell(w["name"]).spec["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def test_a_cell_defined_in_a_copy_by_new_files_alone_loads_and_runs(tmp_path, m):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root)
    shutil.copytree(manifest.ROOT / "fmmbench", root / "fmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    base = root / "fmmbench"
    cfg = json.loads((base / "configs" / "petfmm_vortex.json").read_text())
    cfg.update(name="petfmm_vortex_p12", p=12)
    (base / "configs" / "petfmm_vortex_p12.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "probe_grid_2048.json").read_text())
    traffic.update(name="probe_grid_1024", probes={"side": 1024, "slots": 4})
    (base / "traffic" / "probe_grid_1024.json").write_text(json.dumps(traffic))
    (base / "workloads" / "probe_p12.json").write_text(json.dumps(
        {"name": "probe_p12", "limits": {"velocity_rel_l2": 1e-3, "start_off": 0}}))
    (base / "metrics" / "evaluations_seen.py").write_text(
        "def read(trace):\n    return len(trace['step_s']) or None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "petfmm_vortex_p12", "source": "https://arxiv.org/abs/0905.2637",
                           "file": "fmmbench/configs/petfmm_vortex_p12.json",
                           "reduced": ["p"], "why": "a lower order"})
    man["workloads"].append({"name": "probe_p12", "config": "petfmm_vortex_p12",
                             "traffic": "probe_grid_1024", "chips": 1, "why": "a smaller grid"})
    man["per_layer"].append({"name": "evaluations_seen", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "Step",
                             "moves": "step_ms", "workloads": ["probe_p12"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for rel, data in before.items():      # nothing that was there changed
        if rel.name != "BENCHMARK.json":
            assert (root / rel).read_bytes() == data
    cell = manifest.load_cell("probe_p12", root)
    assert cell.config["p"] == 12 and cell.traffic["probes"]["side"] == 1024
    assert [p["name"] for p in cell.per_layer] == ["evaluations_seen"]
    res = tiny.run_small("probe_p12", root=root)
    assert res["correct"], res["checks"]
    from fmmbench import run
    got = run.per_layer(cell, {}, res["window"])
    assert got["evaluations_seen"]["value"] == len(res["window"]["step_s"])
    assert statistics.mean(res["window"]["step_s"]) > 0
