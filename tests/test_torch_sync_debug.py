"""What ``torch.cuda.set_sync_debug_mode("error")`` refuses, and the host
syncs that the trace records in its place (``launch/trace_analysis.py``).

On the card (``gpu``): ``sync_debug_probe`` gives exactly
``SYNC_DEBUG_SEES``, whose misses are the port's ``UNSEEN_SYNCS``, and a
call that waits through one of the syncs the mode misses fails the "no
host sync" contract all the same.  On the CPU: ``OpTrace`` records each
of ``UNSEEN_SYNCS`` as a data-dependent call (the real call then fails
there, for want of a card, after it is recorded).
"""
import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.launch import trace_analysis as T


def _sync_cases(x: torch.Tensor) -> dict:
    """Each way to make the host wait for the card, on ``x`` (a CUDA tensor)."""
    def event_sync():
        e = torch.cuda.Event()
        e.record()
        e.synchronize()

    def pinned_read():
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return float(h[0])          # a host read: no call waits for the copy

    return {"torch.cuda.synchronize": torch.cuda.synchronize,
            "Event.synchronize": event_sync,
            "Stream.synchronize": lambda: torch.cuda.current_stream().synchronize(),
            "pinned non_blocking copy, then read": pinned_read,
            ".item()": lambda: x.sum().item(),
            ".tolist()": lambda: x.tolist(),
            ".cpu()": lambda: x.cpu(),
            "nonzero": lambda: torch.nonzero(x)}


# what set_sync_debug_mode("error") refuses of _sync_cases, as
# sync_debug_probe reads it on an H100 (torch 2.11, CUDA 12.8): it misses
# torch.cuda.synchronize and Event.synchronize, which OpTrace records itself
# (UNSEEN_SYNCS); a read of pinned memory after a non-blocking copy is no
# sync at all (the host does not wait; nothing can see it), so it passes
SYNC_DEBUG_SEES = {"torch.cuda.synchronize": False, "Event.synchronize": False,
                   "Stream.synchronize": True,
                   "pinned non_blocking copy, then read": False,
                   ".item()": True, ".tolist()": True, ".cpu()": True, "nonzero": True}


def sync_debug_probe(device="cuda") -> dict[str, bool]:
    """Which host syncs ``torch.cuda.set_sync_debug_mode("error")`` refuses:
    each case of :func:`_sync_cases` run under it, True where it raised."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    out = {}
    for name, fn in _sync_cases(x).items():
        torch.cuda.synchronize()
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[name] = False
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            out[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(old)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _calls():
    return {"torch.cuda.synchronize": lambda: torch.cuda.synchronize(),
            "Event.synchronize": lambda: torch.cuda.Event.synchronize(
                torch.cuda.Event() if torch.cuda.is_available() else None)}


def test_trace_records_the_syncs_the_debug_mode_misses():
    with T.OpTrace() as tr:
        for call in _calls().values():
            try:
                call()
            except (AssertionError, AttributeError, RuntimeError, TypeError):
                assert not torch.cuda.is_available()
    got = [(r.kind, r.name, r.data_dependent) for r in tr.records if r.kind == "fn"]
    assert got == [("fn", name, True) for name in T.UNSEEN_SYNCS]
    # the originals are back once the trace ends
    assert torch.cuda.synchronize.__module__ == "torch.cuda"


@pytest.mark.gpu
def test_sync_debug_mode_sees_exactly_the_pinned_list(cuda):
    assert sync_debug_probe(cuda) == SYNC_DEBUG_SEES
    assert {k for k, v in SYNC_DEBUG_SEES.items()
            if not v and "pinned" not in k} == set(T.UNSEEN_SYNCS)


@pytest.mark.gpu
@pytest.mark.parametrize("name", T.UNSEEN_SYNCS)
def test_an_unseen_sync_fails_the_no_host_sync_contract(cuda, name):
    x = torch.ones(16, device=cuda)

    def entry(t):
        y = t * 2
        _calls()[name]()
        return y
    traced = C.Traced(entry, x, label=name)
    assert not traced.sync_error          # the mode itself lets it pass
    res = C.no_host_callback().check(traced)
    assert not res.ok and name in res.detail
