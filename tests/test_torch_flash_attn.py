"""Flash attention: the port's plain version against the reference's TPU
kernel (run in interpret mode on the CPU), and the CUDA kernels against the
plain version on the card.

Tolerances: f32 within 2e-5 rel L2, as the reference's own kernel tests
hold it against ``attention_ref`` (f32 sums in another order and blocking);
bf16 within 2e-2, the reference's bf16 bound (outputs rounded to bf16, so
one half-ulp is 2e-3, and the inputs' rounding is shared).  On the card the
kernels and the plain version see the same inputs: f32 within 1e-5 (f32
summation order, and the 3xTF32 split of the f32 tensor-core kernel, about
5e-7 in the CPU model of ``test_torch_tf32.py``), bf16 within 5e-3 (a rounding flip of the bf16
output costs one ulp, 4e-3 relative; the tensor-core kernel also rounds P
to bf16, about 2e-3).  The ``gpu`` cases decide inside the test whether a
card exists and import no jax.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops, ref


def _np32(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np32(a), _np32(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _qkv(B, H, Hkv, T, S, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, T, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32))


@pytest.fixture(scope="module")
def jx():
    """The reference's TPU kernel (interpret mode) and its jnp oracle."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attn import flash_attention
    return SimpleNamespace(jnp=jnp, flash=flash_attention, ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain version against the reference's kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,T,d", [
    (2, 4, 4, 128, 32),     # MHA
    (1, 8, 2, 256, 64),     # GQA 4:1
    (2, 4, 1, 128, 64),     # MQA
    # the simt route's head dims: one 8-column chunk, a class padded from
    # 40 to 64, Phi-3-mini's 96, 200 padded to 224
    (1, 2, 1, 128, 8),
    (1, 4, 2, 128, 40),
    (1, 4, 4, 128, 96),
    (1, 2, 1, 64, 200),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_f32(jx, B, H, Hkv, T, d, causal):
    q, k, v = _qkv(B, H, Hkv, T, T, d, H * T + d)
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, T, d)
    assert _rel(got, np.asarray(want)) < 2e-5


@pytest.mark.parametrize("bq,bk,d", [
    pytest.param(128, 64, 64, id="128-64"),
    pytest.param(64, 128, 64, id="64-128"),
    pytest.param(256, 256, 64, id="256-256"),
    # the simt route's head dims
    pytest.param(64, 64, 8, id="64-64-d8"),
    pytest.param(128, 64, 40, id="128-64-d40"),
    pytest.param(64, 128, 96, id="64-128-d96"),
    pytest.param(64, 64, 200, id="64-64-d200"),
])
def test_plain_matches_reference_kernel_bf16(jx, bq, bk, d):
    q, k, v = _qkv(1, 4, 4, 256, 256, d, 9)
    jb = [jx.jnp.asarray(a, jx.jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jx.flash(*jb, causal=True, block_q=bq, block_k=bk,
                               interpret=True).astype(jx.jnp.float32))
    tb = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = fa.flash_attention_plain(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 2e-2


def test_plain_matches_reference_kernel_cross_attention(jx):
    """S != T, not causal (prefill chunking / encoder-decoder shapes)."""
    q, k, v = _qkv(1, 2, 2, 64, 192, 32, 11)
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                    causal=False, block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=False)
    assert _rel(got, np.asarray(want)) < 2e-5


@pytest.mark.parametrize("T,S", [(64, 192), (128, 64)])
def test_causal_mask_is_top_left_like_the_tpu_kernel(jx, T, S):
    """For T != S the kernel hides kpos > qpos (top-left); the oracle
    ``attention_ref`` aligns the mask bottom-right.  The port takes the
    kernel's choice, so it matches the kernel and differs from the oracle."""
    q, k, v = _qkv(1, 4, 2, T, S, 32, T + S)
    want = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                    causal=True, block_q=64, block_k=64, interpret=True)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert _rel(got, np.asarray(want)) < 2e-5
    bottom_right = ref.attention_ref(tq, tk, tv, causal=True)
    assert _rel(got, bottom_right) > 0.1
    jref = jx.ref.attention_ref(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                jx.jnp.asarray(v), causal=True)
    assert _rel(bottom_right, np.asarray(jref)) < 2e-5


@pytest.mark.parametrize("T,S,causal", [(48, 48, True), (40, 100, False)])
def test_attention_ref_matches_reference_oracle(jx, T, S, causal):
    q, k, v = _qkv(2, 6, 3, T, S, 16, 5)
    want = jx.ref.attention_ref(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                jx.jnp.asarray(v), causal=causal)
    got = ref.attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            causal=causal)
    assert _rel(got, np.asarray(want)) < 2e-5
    if T == S:      # the two masks agree
        plain = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                         torch.tensor(v), causal=causal)
        assert _rel(plain, got) < 2e-5


def test_dispatch_takes_plain_on_cpu():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 33, 33, 8, 3))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True)
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == before
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v), rtol=0, atol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 16, 16, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v)
    q12, k12, v12 = (torch.tensor(a) for a in _qkv(1, 4, 2, 16, 16, 12, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_cuda(q12, k12, v12)
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention_cuda(torch.zeros(1, 3, 16, 8), k, v)
    with pytest.raises(ValueError, match=r"\(B, H, T, d\)"):
        fa.flash_attention_cuda(q[0], k, v)


# ---------------------------------------------------------------------------
# CUDA kernels against the plain version, on the card; each case counts one
# launch of the kernel that ``route`` names (d 64, 128 or 256 in bf16 takes
# the bf16 tensor-core kernel, in f32 the 3xTF32 kernel, the others the simt
# route's kernel, which runs on the tensor cores too)
# ---------------------------------------------------------------------------


GPU_CASES = [
    # B, H, Hkv, T, S, d, causal, dtype
    # 3xTF32 route
    (1, 8, 2, 1000, 1000, 64, True, torch.float32),     # ragged T = S, GQA 4:1
    (2, 4, 4, 77, 77, 128, True, torch.float32),        # ragged T = S, Hkv = H
    (1, 4, 1, 2079, 2079, 128, True, torch.float32),    # teacher-forced T, Hkv 1
    (1, 4, 1, 129, 129, 64, True, torch.float32),       # Hkv 1, one row past a tile
    (1, 4, 2, 100, 300, 128, True, torch.float32),      # T < S, top-left mask
    (1, 4, 2, 300, 100, 64, True, torch.float32),       # T > S
    (1, 4, 2, 100, 300, 64, True, torch.float32),       # T < S at d 64
    (1, 4, 2, 300, 100, 128, True, torch.float32),      # T > S at d 128
    (2, 4, 4, 200, 333, 128, False, torch.float32),     # not causal
    (1, 6, 2, 256, 512, 64, False, torch.float32),      # whole tiles, not causal
    (1, 2, 2, 1, 1, 64, True, torch.float32),           # one token
    (1, 2, 2, 1, 1, 128, True, torch.float32),
    (1, 4, 2, 1, 50, 128, False, torch.float32),        # one query
    # 3xTF32 route at d 256 (64-row blocks, the warpgroups split O's columns)
    (1, 4, 1, 130, 130, 256, True, torch.float32),      # two row blocks and two rows
    (1, 10, 1, 300, 300, 256, True, torch.float32),     # recurrentgemma-2b's heads
    (2, 4, 4, 77, 77, 256, True, torch.float32),        # ragged T = S
    (1, 4, 1, 2079, 2079, 256, True, torch.float32),    # teacher-forced T, Hkv 1
    (1, 4, 2, 100, 300, 256, True, torch.float32),      # T < S, top-left mask
    (1, 4, 2, 300, 100, 256, True, torch.float32),      # T > S
    (2, 4, 4, 200, 333, 256, False, torch.float32),     # not causal
    (1, 2, 2, 1, 1, 256, True, torch.float32),          # one token
    (1, 4, 2, 1, 50, 256, False, torch.float32),        # one query
    # tensor-core route
    (2, 4, 4, 77, 77, 128, True, torch.bfloat16),      # ragged T = S, Hkv = H
    (1, 8, 2, 1000, 1000, 64, True, torch.bfloat16),   # ragged, GQA 4:1
    (1, 4, 1, 2079, 2079, 128, True, torch.bfloat16),  # teacher-forced T, Hkv 1
    (1, 8, 8, 129, 129, 64, True, torch.bfloat16),     # one row past a tile
    (1, 4, 2, 100, 300, 128, True, torch.bfloat16),    # T < S, top-left mask
    (1, 4, 2, 300, 100, 64, True, torch.bfloat16),     # T > S
    (2, 4, 4, 200, 333, 128, False, torch.bfloat16),   # not causal
    (1, 6, 2, 256, 512, 64, False, torch.bfloat16),    # whole tiles, not causal
    (1, 2, 2, 1, 1, 64, True, torch.bfloat16),         # one token
    (1, 4, 2, 1, 50, 128, False, torch.bfloat16),      # one query
    # tensor-core route at d 256 (64-key tiles)
    (1, 10, 1, 256, 256, 256, True, torch.bfloat16),   # recurrentgemma-2b's heads
    (2, 4, 4, 77, 77, 256, True, torch.bfloat16),      # ragged T = S
    (1, 4, 1, 2079, 2079, 256, True, torch.bfloat16),  # teacher-forced T, Hkv 1
    (1, 4, 2, 100, 300, 256, True, torch.bfloat16),    # T < S, top-left mask
    (1, 4, 2, 300, 100, 256, True, torch.bfloat16),    # T > S
    (2, 4, 4, 200, 333, 256, False, torch.bfloat16),   # not causal
    (1, 2, 2, 1, 1, 256, True, torch.bfloat16),        # one token
    # simt route (tensor cores; a cluster split on grids short of the card),
    # every head-dim class in both dtypes
    (1, 2, 2, 64, 192, 32, False, torch.float32),      # cross attention, split 6
    (1, 2, 2, 64, 192, 32, False, torch.bfloat16),     # split 3
    (1, 2, 1, 33, 100, 8, True, torch.float32),        # T < S, top-left
    (1, 2, 1, 33, 100, 8, True, torch.bfloat16),
    (1, 1, 1, 1, 1, 16, True, torch.float32),          # one token
    (1, 1, 1, 1, 1, 16, True, torch.bfloat16),
    (1, 4, 2, 100, 33, 24, True, torch.float32),       # T > S (bf16: 128-row blocks)
    (1, 4, 2, 100, 33, 24, True, torch.bfloat16),
    (1, 4, 2, 100, 33, 40, True, torch.float32),       # d padded to 64
    (1, 4, 2, 100, 33, 40, True, torch.bfloat16),
    (1, 8, 2, 1000, 1000, 96, True, torch.float32),    # ragged, GQA 4:1
    (1, 8, 2, 1000, 1000, 96, True, torch.bfloat16),
    (2, 2, 1, 65, 65, 200, False, torch.float32),      # d padded to 224, 16-key f32 tiles
    (2, 2, 1, 65, 65, 200, False, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,S,d,causal,dtype", GPU_CASES)
def test_kernel_matches_plain(cuda, B, H, Hkv, T, S, d, causal, dtype):
    q, k, v = (torch.tensor(a, device=cuda).to(dtype)
               for a in _qkv(B, H, Hkv, T, S, d, T * 7 + d))
    before = {"simt": fa.LAUNCHES, "tc": fa.TC_LAUNCHES, "tf32": fa.TF32_LAUNCHES}
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    which = fa.route(q, k)
    assert {"simt": fa.LAUNCHES, "tc": fa.TC_LAUNCHES, "tf32": fa.TF32_LAUNCHES} == {
        r: n + (r == which) for r, n in before.items()}
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    assert _rel(got.cpu(), want.cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,S,causal", [
    (1, 4, 1, 130, 130, True),      # widest head
    (1, 10, 1, 300, 300, True),     # recurrentgemma-2b's heads
    (1, 4, 2, 100, 300, False),     # T < S, not causal
])
def test_simt_kernel_at_f32_head_dim_256(cuda, B, H, Hkv, T, S, causal):
    """The simt kernel itself at f32 d = 256, which the dispatcher sends to
    the 3xTF32 route: still within 1e-5 of the plain version."""
    q, k, v = (torch.tensor(a, device=cuda)
               for a in _qkv(B, H, Hkv, T, S, 256, T * 7 + 256))
    before = fa.LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(8, torch.float32), (40, torch.bfloat16),
                                     (96, torch.float32), (96, torch.bfloat16),
                                     (200, torch.float32)])
def test_simt_kernel_reads_strided_views(cuda, d, dtype):
    """The model's (B, T, H, d) -> (B, H, T, d) views go in as they are; the
    output is the (B, H, T, d) view of (B, T, H, d) memory."""
    B, H, Hkv, T, S = 2, 4, 2, 130, 130
    q, k, v = (torch.tensor(a, device=cuda).to(dtype).transpose(1, 2).contiguous()
               .transpose(1, 2) for a in _qkv(B, H, Hkv, T, S, d, d))
    assert not q.is_contiguous()
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert _rel(got.cpu(), want.cpu()) < (1e-5 if dtype == torch.float32 else 5e-3)


@pytest.fixture(scope="module")
def forced_split(tmp_path_factory):
    """The simt kernel with an entry point that takes the cluster split,
    compiled beside the source by ``tools/simt_flash.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "simt_flash.py"
    spec = importlib.util.spec_from_file_location("simt_flash", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    lib = tool.forced_lib(tmp_path_factory.mktemp("flash_forced"))
    return lambda q, k, v, causal, split: tool.forced(lib, q, k, v, causal, split)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("B,H,Hkv,T,S,d,causal,dtype", [
    (1, 2, 2, 64, 192, 32, False, torch.float32),     # the served shape
    (1, 4, 2, 100, 333, 40, True, torch.bfloat16),    # a key range no split divides
    (1, 2, 1, 130, 300, 200, True, torch.float32),    # ranks with no visible key
])
def test_simt_kernel_at_forced_splits(cuda, forced_split, B, H, Hkv, T, S, d, causal,
                                      dtype, split):
    """Splits 1, 2, 4 and 8 of each q tile's key range across a cluster:
    within the route's tolerance of the plain version, and a second launch
    bit for bit the first."""
    q, k, v = (torch.tensor(a, device=cuda).to(dtype)
               for a in _qkv(B, H, Hkv, T, S, d, 5 * split + d))
    a, b = forced_split(q, k, v, causal, split), forced_split(q, k, v, causal, split)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert torch.equal(a, b)
    assert _rel(a.cpu(), want.cpu()) < (1e-5 if dtype == torch.float32 else 5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,S,d,causal,dtype", [
    (1, 2, 2, 64, 192, 32, False, torch.float32),     # split 6 by the rule
    (1, 2, 2, 64, 192, 32, False, torch.bfloat16),    # split 3
    (1, 8, 2, 1000, 1000, 96, True, torch.float32),   # split 1, 128-row blocks
    (2, 2, 1, 65, 65, 200, False, torch.bfloat16),
])
def test_simt_kernel_repeats_bit_for_bit(cuda, B, H, Hkv, T, S, d, causal, dtype):
    q, k, v = (torch.tensor(a, device=cuda).to(dtype) for a in _qkv(B, H, Hkv, T, S, d, 1))
    first = fa.flash_attention_cuda(q, k, v, causal=causal)
    again = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_kernel_rejects_strided_and_misaligned(cuda):
    """What the simt kernel refuses on the card: a non-unit stride in d, a
    start off a 16-byte boundary, mixed dtypes."""
    q, k, v = (torch.tensor(a, device=cuda) for a in _qkv(1, 4, 2, 32, 32, 16, 6))
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_cuda(torch.zeros(1, 4, 32, 32, device=cuda)[..., ::2], k, v)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention_cuda(q, k.to(torch.bfloat16), v)
