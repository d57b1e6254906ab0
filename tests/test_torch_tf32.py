"""The 3xTF32 split that the M2L and f32 flash-attention kernels run on the
tensor cores: the split itself, a CPU model of the kernels' arithmetic
against the reference's routes, and on the card what one TF32 pass reads.

The model (``kernels/tf32.py``) is the kernels' method on the CPU: hi
rounded to nearest, lo = x - hi read truncated, three TF32 x TF32 products
(each exact in f32) summed in f32.  It is held to the reference at the
kernels' own gate, 1e-5 rel L2; it lands near 2e-7.  One TF32 pass lands
near 1e-4, which is why the kernels take three.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import expansions as ex
from repro_torch.kernels import _build, m2l, tf32

GATE = 1e-5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _f32(values):
    return torch.tensor(np.asarray(values, dtype=np.float32))


def _low13(x):
    return x.view(torch.int32) & 0x1FFF


@pytest.fixture(scope="module")
def jx():
    """The reference's routes (imported here, not at the top)."""
    import jax.numpy as jnp
    from repro.core import expansions
    from repro.kernels.flash_attn import flash_attention
    return SimpleNamespace(jnp=jnp, ex=expansions, flash=flash_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


SPLIT_VALUES = {
    "normal": np.random.default_rng(0).normal(size=4096),
    "signs": [1.0, -1.0, 1 + 3 * 2.0 ** -12, -(1 + 3 * 2.0 ** -12), -1.5e-3, 7.25],
    "zeros": [0.0, -0.0],
    "ties": [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 * (1 + 2.0 ** -11)],
    "subnormal": [1e-40, -3e-42, 1.4e-45, 1.1754942e-38],
    "large": [1e38, -3e38, 3.4e38, 65504.0, 2.0 ** 100],
}


@pytest.mark.parametrize("family", sorted(SPLIT_VALUES))
def test_split_is_exact_with_tf32_hi(family):
    x = _f32(SPLIT_VALUES[family])
    hi, lo = tf32.split(x)
    assert bool((_low13(hi) == 0).all()), "hi keeps bits a TF32 pass drops"
    assert torch.equal(hi + lo, x), "hi + lo must give x back exactly"
    assert torch.equal(torch.signbit(hi), torch.signbit(x))
    # hi is x rounded to nearest: lo is at most half a TF32 ulp of x
    # (2^-137 among subnormals)
    assert bool((lo.abs() <= torch.clamp(x.abs() * 2.0 ** -11, min=2.0 ** -137)).all())
    # what the tensor core reads of lo loses only lo's own low bits
    read = hi.double() + tf32.truncate(lo).double()
    bound = torch.maximum(x.double().abs() * 2.0 ** -21,
                          torch.full_like(read, 2.0 ** -136))
    assert bool(((read - x.double()).abs() <= bound).all())


def test_split_rounds_ties_away_from_zero():
    hi, _ = tf32.split(_f32([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12]))
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


def test_split_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32"):
        tf32.split(torch.zeros(3, dtype=torch.float64))


def test_split_operator_holds_each_entry_as_hi_and_lo():
    rng = np.random.default_rng(5)
    W = torch.as_tensor(rng.normal(size=(8, 12, 12)) + 1j * rng.normal(size=(8, 12, 12)),
                        dtype=torch.complex64)
    Ws = m2l.split_operator(W)
    assert Ws.shape == (8, 12, 12, 4) and Ws.dtype == torch.float32 and Ws.is_contiguous()
    assert torch.equal(Ws[..., 0] + Ws[..., 1], W.real)
    assert torch.equal(Ws[..., 2] + Ws[..., 3], W.imag)
    assert bool((_low13(Ws[..., 0::2].contiguous()) == 0).all())
    with pytest.raises(ValueError, match="complex64"):
        m2l.split_operator(W.to(torch.complex128))


def test_cached_split_is_made_once_per_operator_tensor():
    rng = np.random.default_rng(6)
    W = torch.as_tensor(rng.normal(size=(8, 8, 8)) + 1j * rng.normal(size=(8, 8, 8)),
                        dtype=torch.complex64)
    Ws = m2l.cached_split(W)
    assert m2l.cached_split(W) is Ws
    assert torch.equal(Ws, m2l.split_operator(W))
    other = W.clone()
    assert m2l.cached_split(other) is not Ws
    assert torch.equal(m2l.cached_split(other), Ws)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, modelled, against the reference
# ---------------------------------------------------------------------------


def _real_form(Wd):
    """W[d] (K, K) complex as the (2K, 2K) real matrix csrc/m2l.cu applies
    to the interleaved (re, im) rows of the stack."""
    K = Wd.shape[0]
    B = torch.zeros((2 * K, 2 * K), dtype=torch.float32)
    B[0::2, 0::2], B[0::2, 1::2] = Wd.real, Wd.imag
    B[1::2, 0::2], B[1::2, 1::2] = -Wd.imag, Wd.real
    return B


def _one_pass(a, b):
    """A single TF32 pass, both operands rounded to nearest."""
    return tf32.split(a)[0] @ tf32.split(b)[0]


def _contract(mm):
    """ex.folded_contract with each offset's product done by ``mm`` on the
    real form, as the kernel does it."""
    def contract(stack, W):
        PR, PC, K = stack.shape[0] - 2, stack.shape[1] - 2, stack.shape[2]
        acc = torch.zeros((PR * PC, 2 * K), dtype=torch.float32)
        for d, (Dx, Dy) in enumerate(ex.PARENT_NEIGH8):
            win = stack[1 + Dy:1 + Dy + PR, 1 + Dx:1 + Dx + PC].contiguous()
            acc = acc + mm(torch.view_as_real(win).reshape(PR * PC, 2 * K),
                           _real_form(W[d]))
        return torch.view_as_complex(acc.reshape(PR, PC, K, 2))
    return contract


def _m2l_error(jx, level, p, mm):
    rng = np.random.default_rng(level * 100 + p)
    n = 1 << level
    me = (rng.normal(size=(n, n, p)) + 1j * rng.normal(size=(n, n, p))).astype(np.complex64)
    me_halo = np.pad(me, ((ex.M2L_HALO, ex.M2L_HALO), (0, 0), (0, 0)))
    want = np.asarray(jx.ex.m2l_folded(jx.jnp.asarray(me_halo), level, p))
    got = ex.m2l_folded(torch.as_tensor(me_halo), level, p, contract=_contract(mm))
    return _rel(got.numpy(), want)


@pytest.mark.parametrize("level", [3, 4])
def test_m2l_model_matches_reference_at_p17(jx, level):
    assert _m2l_error(jx, level, 17, tf32.matmul_3xtf32) < GATE


def test_one_tf32_pass_misses_the_m2l_gate(jx):
    """Why the kernels split: one TF32 pass is some 10x over the gate."""
    assert _m2l_error(jx, 4, 17, _one_pass) > 5 * GATE


def _attention_model(q, k, v, causal):
    """flash_attention_plain with both products in three TF32 passes."""
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, H // Hkv, T, d)
    s = tf32.matmul_3xtf32(qf, k[:, :, None].transpose(-1, -2)) * (1.0 / d ** 0.5)
    hidden = torch.arange(S)[None, :] > torch.arange(T)[:, None]
    if causal:
        s = s.masked_fill(hidden, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(hidden, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = tf32.matmul_3xtf32(p, v[:, :, None]) / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, H, T, d)


@pytest.mark.parametrize("B,H,Hkv,T,S,d", [
    (1, 4, 2, 256, 256, 128),    # GQA 2:1, the serving head dim
    (2, 4, 1, 128, 192, 64),     # MQA, T < S
    (1, 2, 1, 128, 128, 256),    # recurrentgemma-2b's head dim, MQA
    (1, 2, 1, 64, 128, 256),     # d = 256, T < S
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_model_matches_reference_kernel(jx, B, H, Hkv, T, S, d, causal):
    rng = np.random.default_rng(T + S + d)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, H, T, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    got = _attention_model(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal)
    assert _rel(got.numpy(), np.asarray(want)) < GATE


# ---------------------------------------------------------------------------
# the build covers the shared header
# ---------------------------------------------------------------------------


def test_library_path_covers_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert _build.library_path("k") != before


def test_every_source_and_header_is_in_the_tree():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "flash_attn_tf32" in _build.SOURCES
    assert (_build.CSRC / "tf32x3.cuh").is_file()


# ---------------------------------------------------------------------------
# on the card: what one TF32 pass reads
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_tensor_core_reads_operands_truncated(cuda):
    """The kernels send lo with its low 13 bits set; the core must ignore
    them (truncate), as the model assumes."""
    x = _f32([1 + 3 * 2.0 ** -12, 1 + 2.0 ** -11, 1 + 2.0 ** -23,
              -(1 + 3 * 2.0 ** -12), 3.0e-5]).to(cuda)
    got = tf32.probe(x).cpu()
    assert torch.equal(got, tf32.truncate(x.cpu()))
