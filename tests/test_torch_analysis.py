"""The port's static-analysis layer (src/repro_torch/analysis) on the CPU.

* the trace recorder (``launch/trace_analysis.py``): operations, kernel
  launches and mesh events in one sequence; the M2L FLOPs held to the
  reference's ``analyze_hlo`` on the jitted ``m2l_folded``;
* every trace contract with a planted violation and a pass;
* the lint rules: the reference's planted sources for the two rules the
  port keeps as they are give the same rule names and lines in both
  packages, and the two step rules get planted sources of their own;
* the cache sessions, step for step against the reference's, every port
  event ok;
* ``python -m repro_torch.analysis.check --device cpu`` exits 0 on the
  port, and nonzero with a violation planted in each section.
"""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import check as CK
from repro_torch.analysis import contracts as C
from repro_torch.analysis import lint as L
from repro_torch.analysis import retrace as R
from repro_torch.analysis.schedule import DryMesh
from repro_torch.core import expansions as ex
from repro_torch.core import parallel_fmm as pf
from repro_torch.core import stepper as stp
from repro_torch.core.fmm import fmm_velocity
from repro_torch.kernels import m2l as km2l
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.trace_analysis import (OpTrace, analyze_trace,
                                               collective_issue_depths,
                                               shape_dim_hits)

CPU = torch.device("cpu")
LEVEL, P = 3, 12


@pytest.fixture(scope="module")
def me():
    n = 1 << LEVEL
    rng = np.random.default_rng(0)
    return rng.normal(size=(n, n, P)) + 1j * rng.normal(size=(n, n, P))


@pytest.fixture(scope="module")
def tree():
    return CK.fmm_fixture(3, 6, n=400)[0]


def _folded(g):
    return ex.m2l_folded(F.pad(g, (0, 0, 0, 0, 2, 2)), LEVEL, P)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_trace_orders_ops_kernel_launches_and_mesh_events():
    x = torch.ones(4)
    mesh = DryMesh(2, 0, CPU)

    def fn():
        pend = mesh.all_gather(x)
        y = x * 2                       # one op in the all-gather's window
        km2l.LAUNCHES += 1              # a launch the wrapper counted
        out = pend.wait()
        return out.sum() + y.sum()

    launches = km2l.LAUNCHES
    try:
        with OpTrace((x,)) as tr:
            fn()
    finally:
        km2l.LAUNCHES = launches
    kinds = [(r.kind, r.name) for r in tr.records]
    assert kinds[0] == ("mesh", "all_gather")
    assert ("kernel", "m2l") in kinds
    assert kinds.index(("kernel", "m2l")) < kinds.index(("mesh", "wait"))
    assert [r.seq for r in tr.records] == sorted(r.seq for r in tr.records)
    assert collective_issue_depths(tr, ("all_gather",)) == {"all_gather": [2]}
    stats = analyze_trace(tr)
    assert stats["launches"]["m2l"] == 1 and stats["count"] == 1
    assert stats["per_kind"]["all_gather"] == 32     # 4 f32 from each of 2 ranks


def test_trace_marks_views_writes_and_products():
    a = torch.ones(3, 4, dtype=torch.complex64)
    with OpTrace((a,)) as tr:
        v = a[1:]                       # a view: no bytes
        b = a @ torch.ones(4, 5, dtype=torch.complex64)
        v.mul_(2)                       # writes into the input's storage
    by = {r.name: r for r in tr.records if r.kind == "op"}
    assert by["slice"].view and by["slice"].bytes == 0
    assert by["mul_"].writes_input
    mm = next(r for r in tr.records if r.flops)
    assert mm.flops == 2 * 3 * 5 * 4 and mm.real_flops == 4 * mm.flops
    assert b.shape == (3, 5)


def test_m2l_folded_flops_and_bytes_match_the_reference(me):
    """The port's m2l_folded has exactly the dot FLOPs that the
    reference's analyze_hlo counts on the jitted m2l_folded (level 3,
    p = 12); in both packages the folded form moves fewer bytes than the
    masked-40 form and neither stages a 40p dim."""
    import jax
    import jax.numpy as jnp
    from repro.core import expansions as rex
    from repro.launch.hlo_analysis import analyze_hlo, shape_dim_pattern

    g = jnp.asarray(me, jnp.complex64)
    hlo = {name: jax.jit(f).lower(g).compile().as_text() for name, f in (
        ("folded", lambda x: rex.m2l_folded(jnp.pad(x, ((2, 2), (0, 0), (0, 0))),
                                            LEVEL, P)),
        ("masked40", lambda x: rex.m2l_masked40(x, LEVEL, P)))}
    ref = {k: analyze_hlo(v) for k, v in hlo.items()}

    t = torch.as_tensor(me, dtype=torch.complex64)
    fold = C.Traced(_folded, t, label="folded")
    m40 = C.Traced(ex.m2l_masked40, t, LEVEL, P, label="masked40")
    assert fold.stats["flops"] == ref["folded"]["flops"] == 589824.0
    assert fold.stats["real_flops"] == 4 * fold.stats["flops"]
    assert ref["folded"]["bytes"] < ref["masked40"]["bytes"]
    assert fold.stats["bytes"] < m40.stats["bytes"]
    assert not shape_dim_pattern(40 * P).search(hlo["folded"])
    assert shape_dim_hits(fold.trace, 40 * P) == []


def _old_gather_wrapper(me):
    """The pre-folding wrapper's staging stage: 40 masked source slabs
    gathered and flattened to (nb, 40p)."""
    from repro_torch.core.quadtree import M2L_OFFSETS, M2L_VALIDITY
    n, p = me.shape[0], me.shape[-1]
    pad = F.pad(me, (0, 0, 3, 3, 3, 3))
    slabs = []
    for oi, (dx, dy) in enumerate(M2L_OFFSETS):
        m = torch.as_tensor(ex.parity_mask(n, M2L_VALIDITY[oi]), dtype=me.dtype)
        slabs.append(pad[3 + dy:3 + dy + n, 3 + dx:3 + dx + n] * m[..., None])
    return torch.stack(slabs, dim=2).reshape(n * n, 40 * p)


def test_staging_contract_on_the_m2l_wrapper():
    """At the reference's (16, 16, 17): the kernel wrapper's route stages
    no 680-wide tensor; the old gather wrapper does, and the failure names
    it (the positive control)."""
    from repro_torch.kernels import ops as kops
    level, p = 4, 17
    rng = np.random.default_rng(0)
    me = torch.as_tensor(rng.normal(size=(16, 16, p)) + 1j * rng.normal(size=(16, 16, p)),
                         dtype=torch.complex64)
    (ok,) = C.evaluate(C.Traced(kops.m2l_apply, me, level, p), [C.no_staging_dim(680)])
    assert ok.ok, ok
    (bad,) = C.evaluate(C.Traced(_old_gather_wrapper, me), [C.no_staging_dim(680)])
    assert not bad.ok and "680" in bad.detail, bad


# ---------------------------------------------------------------------------
# contracts: a planted violation and a pass each
# ---------------------------------------------------------------------------


def _x():
    return torch.arange(1.0, 7.0).reshape(2, 3)


def _write_through_numpy(x):
    x.numpy()[0, 0] += 1.0              # bypasses dispatch and the version
    return x


PLANTED = [
    ("no_staging_dim", C.no_staging_dim(480),
     lambda x: torch.zeros(16, 480) + x.sum()),
    ("no_f64_upcast", C.no_f64_upcast(), lambda x: x.double() * 2),
    ("sentinel_free[isfinite]", C.sentinel_free(), lambda x: torch.isfinite(x)),
    ("sentinel_free[isnan]", C.sentinel_free(), lambda x: torch.isnan(x)),
    ("no_host_callback[item]", C.no_host_callback(), lambda x: x.sum().item()),
    ("no_host_callback[float]", C.no_host_callback(), lambda x: float(x.max())),
    ("no_host_callback[bool index]", C.no_host_callback(), lambda x: x[x > 2]),
    ("no_host_callback[nonzero]", C.no_host_callback(), lambda x: torch.nonzero(x)),
    ("no_host_callback[unique]", C.no_host_callback(), lambda x: torch.unique(x)),
    ("no_host_callback[masked_select]", C.no_host_callback(),
     lambda x: x.masked_select(x > 1)),
    ("not_donated[in place]", C.not_donated(), lambda x: x.add_(1)),
    ("not_donated[through a view]", C.not_donated(),
     lambda x: x.view(-1).__setitem__(0, 5.0)),
    ("not_donated[outside dispatch]", C.not_donated(), _write_through_numpy),
]


@pytest.mark.parametrize("contract,fn", [c[1:] for c in PLANTED],
                         ids=[c[0] for c in PLANTED])
def test_contract_planted_violation_and_pass(contract, fn):
    bad = C.evaluate(C.Traced(fn, _x()), [contract])[0]
    assert not bad.ok and "FAIL" in str(bad), bad
    good = C.evaluate(C.Traced(lambda x: (x * 2).sum(dim=0), _x()), [contract])[0]
    assert good.ok, good


def test_sentinel_contract_on_the_step(tree):
    rk2 = stp.TRACE_ENTRY_POINTS["rk2_step"]
    unguarded = C.Traced(rk2, tree, 1e-4, p=6, device=CPU, guard=False)
    guarded = C.Traced(rk2, tree, 1e-4, p=6, device=CPU, guard=True)
    contracts = [C.sentinel_free(), C.not_donated("rk2"), C.no_host_callback()]
    assert not C.violations(C.evaluate(unguarded, contracts))
    bad = C.violations(C.evaluate(guarded, contracts))
    assert [r.contract for r in bad] == ["sentinel_free"]


def test_launch_and_plain_call_contracts(tree):
    """On the CPU the plain versions run: no kernel launch is counted, and
    plain=True shows as plain calls."""
    plain = C.Traced(fmm_velocity, tree, 6, device=CPU, plain=True)
    default = C.Traced(fmm_velocity, tree, 6, device=CPU)
    # level 3: one P2P, one P2M, one L2P and an M2L at levels 2 and 3
    assert plain.plain_calls == 5 and default.plain_calls == 0
    assert not C.evaluate(plain, [C.no_plain_calls()])[0].ok
    assert C.evaluate(default, [C.no_plain_calls(), C.launch_count("m2l", 0),
                                C.launch_count("p2p", 0), C.launch_count("p2m", 0),
                                C.launch_count("l2p", 0)])[0].ok
    assert not C.evaluate(default, [C.launch_count("m2l", 2)])[0].ok


@pytest.mark.parametrize("grid,want", [((2, 2), 4), ((4, 1), 2), ((1, 4), 2)])
def test_collective_count_on_the_fused_exchange(grid, want):
    with OpTrace() as tr:
        for r in range(4):
            CK.fused_exchange(grid, mesh=DryMesh(4, r, CPU))
    traced = C.Traced.from_trace(tr)
    assert C.evaluate(traced, [C.collective_count("directions", want)])[0].ok
    assert not C.evaluate(traced, [C.collective_count("directions", want + 1)])[0].ok
    assert not C.evaluate(traced, [C.collective_count("exchange", max_count=1)])[0].ok
    with pytest.raises(ValueError):
        C.collective_count("exchange")


@pytest.fixture(scope="module")
def pipeline_pair():
    level, p = 4, 6
    tree, index = CK.fmm_fixture(level, p, n=1500)
    slab, _ = CK.plans(index, level, p, tree.slots, 4, (2, 2))
    return tuple(C.Traced(pf.parallel_fmm_evaluate, tree, p, mesh=DryMesh(4, 1, CPU),
                          plan=slab, pipeline=pipe, label=f"pipeline={pipe}")
                 for pipe in (True, False))


def test_issue_depth_contracts_planted_and_pass(pipeline_pair):
    on, off = pipeline_pair
    assert not C.violations(C.evaluate(on, [C.issue_depth_grows("all_gather"),
                                            C.min_issue_depth("all_gather", 8)],
                                       pair_with=off))
    # swapped: the serial order does not grow the window
    assert not C.evaluate(off, [C.issue_depth_grows()], pair_with=on)[0].ok
    deep = C.min_issue_depth("all_gather", 10 ** 6)
    assert not C.evaluate(on, [deep])[0].ok


def test_fewer_bytes_pair_planted_and_pass(me):
    t = torch.as_tensor(me, dtype=torch.complex64)
    fold = C.Traced(_folded, t, label="folded")
    m40 = C.Traced(ex.m2l_masked40, t, LEVEL, P, label="masked40")
    assert C.evaluate(fold, [C.fewer_bytes("folded", "masked40")], pair_with=m40)[0].ok
    assert not C.evaluate(m40, [C.fewer_bytes()], pair_with=fold)[0].ok
    with pytest.raises(ValueError, match="pair_with"):
        C.evaluate(fold, [C.fewer_bytes()])


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

_EQ_BRANCH = ("def drive(eq, x, kind):\n"
              "    if eq.name == kind:\n"
              "        return x\n"
              "    if kind == 'vortex':\n"
              "        return 2 * x\n"
              "    if isinstance(eq, LaplaceEquation):\n"
              "        return -x\n")
_REBUILD = {"arity": "t = rebuild_tree(x)\n",
            "discard": "t, aux, _ = rebuild_tree(x)\n",
            "good": "t, aux, ok = rebuild_tree(x)\n",
            "multiline": "t, aux, ok = rebuild_tree(\n    x,\n    level=3)\n"}


@pytest.mark.parametrize("src,path", [
    (_EQ_BRANCH, "core/fmm.py"), (_EQ_BRANCH, "core/stepper.py"),
    *[(s, "a.py") for s in _REBUILD.values()]])
def test_lint_kept_rules_agree_with_the_reference(src, path):
    from repro.analysis import lint as RL
    ref_rules = (RL.EquationBranchRule(), RL.RebuildTreeOkRule())
    port_rules = (L.EquationBranchRule(), L.RebuildTreeOkRule())
    ref = [(f.rule, f.line) for f in RL.lint_source(src, path, ref_rules)]
    port = [(f.rule, f.line) for f in L.lint_source(src, path, port_rules)]
    assert port == ref


def test_lint_equation_branch_rule():
    findings = L.lint_source(_EQ_BRANCH, path="core/fmm.py")
    assert len(findings) == 3, findings
    assert L.lint_source(_EQ_BRANCH, path="core/stepper.py") == []


_STEP = ("import time, random, torch\nimport numpy as np\n"
         "def helper(x):\n"
         "    return {body}\n"
         "def step(x):\n"
         "    return helper(x)\n"
         "def host_driver(x):\n"
         "    return {body}\n"
         "TRACE_ENTRY_POINTS = {{'step': step}}\n")


@pytest.mark.parametrize("rule,body,needle", [
    ("no-host-sync-in-step", "x.sum().item()", ".item()"),
    ("no-host-sync-in-step", "x.cpu()", ".cpu()"),
    ("no-host-sync-in-step", "x.tolist()", ".tolist()"),
    ("no-host-sync-in-step", "x.numpy()", ".numpy()"),
    ("no-host-sync-in-step", "torch.cuda.synchronize()", "synchronize"),
    ("no-host-sync-in-step", "float(torch.sum(x))", "float()"),
    ("no-host-sync-in-step", "int(x.max())", "int()"),
    ("no-host-sync-in-step", "bool(x.any())", "bool()"),
    ("no-nondeterminism-in-step", "x * time.time()", "time()"),
    ("no-nondeterminism-in-step", "x * time.perf_counter()", "perf_counter()"),
    ("no-nondeterminism-in-step", "x + np.random.normal()", "np.random.normal()"),
    ("no-nondeterminism-in-step", "x + random.random()", "random.random()"),
    ("no-nondeterminism-in-step", "x + torch.randn(3)", "randn()"),
    ("no-nondeterminism-in-step", "x.normal_()", "normal_()"),
])
def test_lint_step_rules_planted_and_pass(rule, body, needle):
    findings = L.lint_source(_STEP.format(body=body), path="core/x.py")
    # found in the helper the entry point reaches, not in the host driver
    assert [(f.rule, f.line) for f in findings] == [(rule, 4)], findings
    assert needle in findings[0].message
    roots = L.lint_source(_STEP.format(body=body).replace(
        "TRACE_ENTRY_POINTS = {'step': step}\n", ""), path="core/x.py")
    assert roots == []


@pytest.mark.parametrize("body", [
    "int(x.shape[0])", "float(len(x))", "np.asarray(x.rows)",
    "x + torch.randn(3, generator=g)", "x.normal_(generator=g)", "x * 2"])
def test_lint_step_rules_pass(body):
    assert L.lint_source(_STEP.format(body=body), path="core/x.py") == []


def test_port_lints_clean():
    import repro_torch
    from pathlib import Path
    findings = L.run_lint(Path(repro_torch.__file__).parent)
    assert findings == [], L.format_findings(findings)


# ---------------------------------------------------------------------------
# cache accounting
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions():
    from repro.analysis import retrace as RR
    ref = RR.run_session(level=3, p=4) + RR.run_serve_session(level=2, p=4)
    port = R.run_session(level=3, p=4, device=CPU) + \
        R.run_serve_session(level=2, p=4, device=CPU)
    return ref, port


def test_sessions_match_the_reference_step_for_step(sessions):
    """The same step names with the same hit or miss as the reference's
    sessions; the reference's host-leaf miss is a raise here (the port's
    entry points take tensors only)."""
    ref, port = sessions
    assert [e.step for e in port] == [e.step for e in ref]
    for r, p in zip(ref, port):
        want = "raise" if r.step == "host-leaf-footgun" else r.expected
        assert r.ok and p.expected == want, (r, p)
    assert all(e.ok for e in port), "\n".join(str(e) for e in port)


def test_equal_spec_instances_share_device_operators():
    """A fresh, equal spec keys the operators a registered one already put
    on the device (a bound method compares its spec by identity)."""
    from repro_torch.core import equations as eqs
    a = ex.device_operator(eqs.LAPLACE.m2m_operator, 5, CPU)
    b = ex.device_operator(eqs.LaplaceEquation().m2m_operator, 5, CPU)
    assert a is b
    assert ex.device_operator(ex.m2m_operator, 5, CPU) is \
        ex.device_operator(ex.m2m_operator, 5, CPU)


def test_retrace_monitor_hit_miss_and_blame(tree):
    mesh = make_local_mesh(device=CPU)
    R.clear_caches()
    mon = R.RetraceMonitor(pf.parallel_fmm_evaluate, "evaluate")
    mon.expect_miss(tree, 4, mesh=mesh, step="cold")
    mon.expect_hit(tree, 4, mesh=mesh, step="steady")
    mon.call(tree, 5, mesh=mesh, expect="miss", step="order")
    assert mon.ok and "ops.folded_operator" in mon.events[-1].caches
    mon.call(tree, 6, mesh=mesh, expect="hit", step="surprise", strict=False)
    bad = [e for e in mon.events if not e.ok]
    assert [e.step for e in bad] == ["surprise"]
    assert any("[0][1]: 5 -> 6" in b for b in bad[0].blame), bad[0].blame
    with pytest.raises(R.RetraceViolation, match="surprise-again"):
        mon.expect_hit(tree, 7, mesh=mesh, step="surprise-again")
    assert "VIOLATIONS" in mon.report()
    with pytest.raises(TypeError):
        R.RetraceMonitor(42)


def test_signature_diff_names_paths(tree):
    a = R.signature_of((tree,), {"p": 4})
    b = R.signature_of((torch.ones(8),), {"p": 5})
    diffs = R.diff_signatures(a, b)
    assert any("['p']" in d and "4 -> 5" in d for d in diffs), diffs
    assert any(d.startswith("[0][0]") for d in diffs)
    assert "array(3,):float64:host" in R.signature_of((np.ones(3),), {})["[0][0]"]
    assert R.diff_signatures(None, a) == ["<first call>"]
    assert "identical" in R.diff_signatures(a, a)[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_check_cli_passes_on_the_port(tmp_path):
    out = tmp_path / "summary.json"
    assert CK.main(["--device", "cpu", "--quick", "--json", str(out)]) == 0
    import json
    summary = json.loads(out.read_text())
    assert set(summary) == set(CK.SECTIONS)
    assert all(s["violations"] == 0 and s["checked"] > 0 for s in summary.values())
    assert summary["schedule"]["checked"] == 9


def _plant_lint(monkeypatch, tmp_path):
    (tmp_path / "planted.py").write_text(_STEP.format(body="x.sum().item()"))
    orig = L.run_lint
    monkeypatch.setattr(L, "run_lint", lambda root, rules=L.DEFAULT_RULES:
                        orig(tmp_path, rules))


def _plant_contracts(monkeypatch, tmp_path):
    from repro_torch.kernels import ops as kops
    orig = kops.m2l_apply

    def staged(me, level, p, eq=None, plain=False):
        torch.zeros(me.shape[0] * me.shape[1], 40 * p, dtype=me.dtype)
        return orig(me, level, p, eq=eq, plain=plain)
    monkeypatch.setattr(kops, "m2l_apply", staged)


def _plant_schedule(monkeypatch, tmp_path):
    orig = pf._tile_halo

    def skewed(x, width, rows_valid, cols_valid, mesh, grid):
        if mesh.rank == 1:              # rank 1 gathers once more: a hang
            mesh.all_gather(x[:1]).wait()
        return orig(x, width, rows_valid, cols_valid, mesh, grid)
    monkeypatch.setattr(pf, "_tile_halo", skewed)


def _plant_retrace(monkeypatch, tmp_path):
    # key the device operators by the bound method, as before the repair:
    # an equal spec built anew misses
    monkeypatch.setattr(ex, "device_operator",
                        lambda builder, p, device: ex._device_operator(builder, p, device))


@pytest.mark.parametrize("section,plant", [
    ("lint", _plant_lint), ("contracts", _plant_contracts),
    ("schedule", _plant_schedule), ("retrace", _plant_retrace)])
def test_check_cli_fails_on_a_planted_violation(section, plant, monkeypatch, tmp_path,
                                                capsys):
    plant(monkeypatch, tmp_path)
    skip = [s for s in CK.SECTIONS if s != section]
    argv = ["--device", "cpu", "--quick"] + [a for s in skip for a in ("--skip", s)]
    assert CK.main(argv) == 1
    out = capsys.readouterr().out
    assert re.search(rf"---- {section}: \d+ checked, [1-9]\d* violation", out), out
