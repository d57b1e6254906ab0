"""The static-analysis layer on the CUDA card, at the smallest fixtures.

Imports no jax, so ``pytest -m gpu`` runs it where jax is absent; the cases
decide inside the test whether a card exists.  The first is the
counterpart of the reference's ``test_m2l_staging.py::
test_kernel_wrapper_has_no_40p_staging_tensor``: the M2L kernel wrapper at
(16, 16, 17) stages no (nb, 40p) tensor, launches the kernel once and
makes no host sync.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import check as CK
from repro_torch.analysis import contracts as C
from repro_torch.kernels import ops as kops

LEVEL, P = 4, 17


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_wrapper_has_no_40p_staging_tensor(cuda):
    n = 1 << LEVEL
    rng = np.random.default_rng(0)
    me = torch.as_tensor(rng.normal(size=(n, n, P)) + 1j * rng.normal(size=(n, n, P)),
                         dtype=torch.complex64, device=cuda)
    traced = C.Traced(kops.m2l_apply, me, LEVEL, P, label="m2l_apply")
    results = C.evaluate(traced, [C.no_staging_dim(40 * P), C.no_f64_upcast(),
                                  C.no_host_callback(), C.launch_count("m2l", 1),
                                  C.not_donated("me")])
    assert not C.violations(results), C.format_results(results)


@pytest.mark.gpu
def test_card_contracts_schedules_and_sessions(cuda):
    """Every section of ``check --device cuda --quick``: 0 violations, the
    step's launches pinned in its trace (2 P2P and 2 (L - 1) M2L, no plain
    call) under ``set_sync_debug_mode("error")``."""
    summary = CK.run("cuda", quick=True)
    bad = {k: v["detail"] for k, v in summary.items() if v["violations"]}
    assert not bad, bad
    assert summary["contracts"]["checked"] >= 26


@pytest.mark.gpu
@pytest.mark.parametrize("name,fn", [
    ("item", lambda x: x.sum().item()),
    ("copy to the host", lambda x: x.cpu()),
    ("pageable copy to the card", lambda x: x + torch.as_tensor(np.ones(4, np.float32),
                                                                device=x.device)),
    ("bool index", lambda x: x[x > 1]),
])
def test_sync_debug_catches_a_planted_host_sync(cuda, name, fn):
    """The positive control of ``no_host_callback`` on the card: each of
    these stops the host, and the contract fails on it."""
    x = torch.arange(4.0, device=cuda)
    (r,) = C.evaluate(C.Traced(fn, x, label=name),
                      [C.no_host_callback()])
    assert not r.ok, r
