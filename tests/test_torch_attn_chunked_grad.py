"""Attention's backward one query chunk at a time, on the CPU (no jax).

* ``attention_core_plain`` under autograd runs each query chunk under its
  own checkpoint: its forward is bit for bit the one without autograd, and
  its q, k, v gradients equal those of the same attention as one chunk.
* ``ops.flash_attention_with_grad``'s backward recomputes the plain
  version a query chunk at a time (the chunk's rows against the keys they
  can see): its gradients equal the unchunked plain ones.  On a CPU tensor
  the forward takes the plain route, so this checks the backward's
  chunking, views and sums; the card's forward is held to the plain one by
  ``chip_smoke.py``.

Tolerance: 1e-6 rel L2 in f32 (the same products summed in other orders).
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as ll

CASES = [(True, 16), (True, 24), (False, 16), (True, 64)]


def _inputs(causal_seed: int = 0, B=2, H=4, Hkv=2, T=64, d=16):
    g = torch.Generator().manual_seed(causal_seed)
    q = torch.randn(B, H, T, d, generator=g)
    k = torch.randn(B, Hkv, T, d, generator=g)
    v = torch.randn(B, Hkv, T, d, generator=g)
    return q, k, v, torch.randn(B, H, T, d, generator=g)


def _grads(fn, q, k, v, gout):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, gout)


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _whole(causal):
    return lambda q, k, v: ll.attention_core_plain(q, k, v, causal=causal, q_chunk=q.shape[2])


@pytest.mark.parametrize("causal,q_chunk", CASES, ids=[f"causal{c}-chunk{n}" for c, n in CASES])
def test_plain_attention_chunks_checkpointed(causal, q_chunk):
    q, k, v, gout = _inputs()
    with torch.no_grad():
        want_out = ll.attention_core_plain(q, k, v, causal=causal, q_chunk=q_chunk)
    out, got = _grads(lambda *a: ll.attention_core_plain(*a, causal=causal, q_chunk=q_chunk),
                      q, k, v, gout)
    assert torch.equal(out, want_out)
    _, want = _grads(_whole(causal), q, k, v, gout)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("causal,q_chunk", CASES, ids=[f"causal{c}-chunk{n}" for c, n in CASES])
def test_flash_backward_by_query_chunk(causal, q_chunk):
    q, k, v, gout = _inputs(1)
    out, got = _grads(lambda *a: ops.flash_attention_with_grad(*a, causal=causal,
                                                               q_chunk=q_chunk),
                      q, k, v, gout)
    want_out, want = _grads(_whole(causal), q, k, v, gout)
    assert _rel(out, want_out) <= 1e-6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        assert _rel(a, b) <= 1e-6
