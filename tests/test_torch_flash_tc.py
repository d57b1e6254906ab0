"""The tensor-core flash-attention route: the choice of route (on the CPU),
the wrapper's checks, and on the card the kernel on the model's strided
views and inside the model.  Its cases against the plain version at ragged,
T != S, non-causal and GQA shapes are rows of ``GPU_CASES`` in
``test_torch_flash_attn.py``.

No jax here.  The ``gpu`` cases decide inside the test whether a card
exists.  Tolerance on the card: 5e-3 rel L2 against the f32 plain version
on the same bf16 inputs.  The kernel rounds P to bf16 for the P V product
(about 2e-3, as a single bf16 MXU pass of the reference's f32 dot rounds
it) and the output to bf16 (a rounding flip costs one ulp, 4e-3
relative); the plain version rounds only the output.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.yi_6b import SMOKE_CONFIG as YI_SMOKE
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

TOL = 5e-3
CUDA = torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _qkv(B, H, Hkv, T, S, d, seed, device="cpu", dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=shape).astype(np.float32),
                              device=device).to(dtype)
                 for shape in ((B, H, T, d), (B, Hkv, S, d), (B, Hkv, S, d)))


def _like(device, dtype, d):
    """Stands in for a tensor: ``route`` reads only device, dtype and shape."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=(1, 2, 3, d))


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


# ---------------------------------------------------------------------------
# route and wrapper, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device,q_dtype,k_dtype,d,want", [
    ("cpu", torch.float32, torch.float32, 64, "plain"),
    ("cpu", torch.bfloat16, torch.bfloat16, 128, "plain"),
    ("cpu", torch.bfloat16, torch.bfloat16, 16, "plain"),
    ("cuda", torch.bfloat16, torch.bfloat16, 64, "tc"),
    ("cuda", torch.bfloat16, torch.bfloat16, 128, "tc"),
    ("cuda", torch.float32, torch.float32, 128, "tf32"),   # f32: 3xTF32 split
    ("cuda", torch.float32, torch.float32, 64, "tf32"),
    ("cuda", torch.float32, torch.float32, 32, "simt"),    # other f32 head dims
    ("cuda", torch.float32, torch.float32, 256, "tf32"),   # f32 at 256: 3xTF32 split
    ("cuda", torch.float32, torch.bfloat16, 64, "simt"),   # mixed: SIMT raises
    ("cuda", torch.bfloat16, torch.bfloat16, 16, "simt"),  # other head dims
    ("cuda", torch.bfloat16, torch.bfloat16, 96, "simt"),
    ("cuda", torch.bfloat16, torch.bfloat16, 256, "tc"),   # bf16 at 256: tensor cores
    ("cuda", torch.bfloat16, torch.float32, 128, "simt"),  # mixed: SIMT raises
    ("cuda", torch.float16, torch.float16, 128, "simt"),
])
def test_route_by_device_dtype_and_head_dim(device, q_dtype, k_dtype, d, want):
    assert fa.route(_like(device, q_dtype, d), _like(device, k_dtype, d)) == want


@pytest.mark.parametrize("make,match", [
    (lambda: _qkv(1, 4, 2, 16, 16, 64, 0), "CUDA tensor"),
    (lambda: _qkv(1, 4, 2, 16, 16, 64, 0, dtype=torch.float32), "bfloat16"),
    (lambda: _qkv(1, 4, 2, 16, 16, 32, 0), "head dim 32"),
    (lambda: _qkv(1, 4, 2, 16, 16, 96, 0), "head dim 96"),
    (lambda: _qkv(1, 4, 2, 16, 16, 256, 0, dtype=torch.float32), "bfloat16"),
    (lambda: tuple(t[..., ::2] for t in _qkv(1, 4, 2, 16, 16, 128, 0)), "unit stride"),
    (lambda: tuple(t[..., :64] for t in _qkv(1, 4, 2, 16, 16, 68, 0)), "multiple of 8"),
    (lambda: (torch.zeros(1, 3, 16, 64, dtype=torch.bfloat16),)
     + _qkv(1, 4, 2, 16, 16, 64, 0)[1:], "not a multiple"),
])
def test_tc_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_tc(*make())


@pytest.mark.parametrize("make,match", [
    (lambda: _qkv(1, 4, 2, 16, 16, 64, 0, dtype=torch.float32), "CUDA tensor"),
    (lambda: _qkv(1, 4, 2, 16, 16, 64, 0), "float32"),
    (lambda: _qkv(1, 4, 2, 16, 16, 32, 0, dtype=torch.float32), "head dim 32"),
    (lambda: _qkv(1, 4, 2, 16, 16, 96, 0, dtype=torch.float32), "head dim 96"),
    (lambda: tuple(t[..., ::2] for t in _qkv(1, 4, 2, 16, 16, 128, 0, dtype=torch.float32)),
     "unit stride"),
    (lambda: tuple(t[..., :64] for t in _qkv(1, 4, 2, 16, 16, 66, 0, dtype=torch.float32)),
     "multiple of 4"),
    (lambda: (torch.zeros(1, 3, 16, 64),) + _qkv(1, 4, 2, 16, 16, 64, 0, dtype=torch.float32)[1:],
     "not a multiple"),
    (lambda: _qkv(1, 4, 2, 0, 16, 64, 0, dtype=torch.float32), "empty sequence"),
])
def test_tf32_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_tf32(*make())


@pytest.mark.parametrize("d", [256, 128, 64])
def test_tc_wrapper_takes_head_dim_256_up_to_the_device_check(d):
    """d = 256 passes every check of the wrapper but the device's."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_tc(*_qkv(1, 4, 2, 16, 16, d, 0))


@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_tc_launch_fits_a_hopper_block(d):
    """The tensor-core launch's shared memory and threads fit one block of
    the card (232,448 bytes, 1024 threads) at every head dim it takes, and
    its key tile divides into 16-key wgmma steps."""
    bk, threads, smem = fa.tc_launch_config(d)
    assert smem <= fa.MAX_SMEM and threads <= 1024 and threads % 128 == 0
    assert bk % 16 == 0 and bk in (64, 128)
    assert smem >= 128 * d * 2 + 2 * 2 * bk * d * 2


@pytest.mark.parametrize("d", [32, 96, 512])
def test_tc_launch_config_rejects_other_head_dims(d):
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa.tc_launch_config(d)


@pytest.mark.parametrize("d", [256, 128, 64])
def test_tf32_wrapper_takes_head_dim_256_up_to_the_device_check(d):
    """f32 at d = 256 passes every check of the 3xTF32 wrapper but the
    device's."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_tf32(*_qkv(1, 4, 2, 16, 16, d, 0, dtype=torch.float32))


@pytest.mark.parametrize("d", fa.TF32_HEAD_DIMS)
def test_tf32_launch_fits_a_hopper_block(d):
    """The 3xTF32 launch fits one block of the card at every head dim it
    takes: shared memory within 232,448 bytes, and 256 threads, so the
    SM's 65,536 registers leave each thread the 255 it may have (the
    kernel is built for one block an SM).  Each warpgroup owns 64 rows of
    O and ``cols`` of its columns (all of d when the block's rows are
    split, half at d = 256); O and a tile's part take ``cols`` registers
    a thread, P's hi and lo ``bk``: no more than at d = 128 (231 registers
    in ptxas's report; the d = 256 instance takes 255)."""
    bq, bk, threads, smem = fa.tf32_launch_config(d)
    assert smem <= fa.MAX_SMEM and threads == 256
    assert 65536 // threads >= 255
    warpgroups = threads // 128
    cols = d if bq == 64 * warpgroups else d // warpgroups
    assert bq * d == 64 * cols * warpgroups          # O is shared out whole
    assert bk % 8 == 0 and cols % 8 == 0 and cols <= 256   # wgmma's k and N
    assert cols + bk <= 128 + 32
    assert smem >= 2 * bq * d * 4 + 3 * bk * d * 4      # Q hi and lo, K, V^T


@pytest.mark.parametrize("d", [32, 96, 512])
def test_tf32_launch_config_rejects_other_head_dims(d):
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa.tf32_launch_config(d)


def test_tf32_wrapper_rejects_a_misaligned_start():
    flat = torch.zeros(4 * 16 * 64 + 1)
    q = flat[1:].view(1, 4, 16, 64)
    _, k, v = _qkv(1, 4, 2, 16, 16, 64, 0, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_tf32(q, k, v)


def test_tma_strides_take_16_bytes_of_either_dtype():
    f32 = torch.zeros(2, 3, 4, 68)[..., :64]                 # seq stride 68 floats
    assert fa._tma_strides("f32", f32) == [3 * 4 * 68, 4 * 68, 68]
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._tma_strides("bf16", torch.zeros(1, 3, 4, 68, dtype=torch.bfloat16)[..., :64])


def test_tc_wrapper_rejects_a_misaligned_start():
    flat = torch.zeros(4 * 16 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(1, 4, 16, 64)
    _, k, v = _qkv(1, 4, 2, 16, 16, 64, 0)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_tc(q, k, v)


def test_tma_strides_follow_the_view():
    x = torch.zeros(2, 5, 4, 64).transpose(1, 2)            # (B, T, H, d) memory
    assert fa._tma_strides("x", x) == [5 * 4 * 64, 64, 4 * 64]
    one = torch.zeros(1, 4, 1, 128).transpose(0, 2)         # size-1 dims
    assert fa._tma_strides("one", one) == [4 * 128, 128, 128]


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.float32, 64), (torch.float32, 16)])
def test_dispatch_on_cpu_launches_neither_kernel(dtype, d):
    q, k, v = _qkv(1, 4, 2, 33, 33, d, 3, dtype=dtype)
    before = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES)
    out = ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES) == before
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the card: the model's strided views, attention_core and the model
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc_kernel_reads_strided_views(cuda, d):
    """The (B, T, H, d) -> (B, H, T, d) views of the model, as they are; the
    output lies in (B, T, H, d) memory."""
    B, H, Hkv, T = 2, 8, 2, 300
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _qkv(B, H, Hkv, T, T, d, d, device=cuda))
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    assert not qv.is_contiguous()
    got = fa.flash_attention_tc(qv, kv, vv, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(qv.contiguous(), kv.contiguous(), vv.contiguous())
    assert _rel(got, want) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tf32_kernel_reads_strided_views(cuda, d):
    """The 3xTF32 kernel on the model's (B, T, H, d) -> (B, H, T, d) views;
    f32 within 1e-5 of the plain version."""
    B, H, Hkv, T = 2, 8, 2, 300
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _qkv(B, H, Hkv, T, T, d, d, device=cuda, dtype=torch.float32))
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    assert not qv.is_contiguous()
    got = fa.flash_attention_tf32(qv, kv, vv, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(qv.contiguous(), kv.contiguous(), vv.contiguous())
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
def test_attention_core_takes_the_tf32_route_for_f32(cuda):
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(2, 8, 2, 200, 200, 128, 1, device=cuda, dtype=torch.float32))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES)
    got = tl.attention_core(q, k, v, causal=True, q_chunk=100)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES) == (before[0], before[1],
                                                               before[2] + 1)
    assert _rel(got, tl.attention_core_plain(q, k, v, causal=True, q_chunk=100)) < 1e-5


@pytest.mark.gpu
def test_attention_core_takes_the_tc_route_for_bf16(cuda):
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(2, 8, 2, 200, 200, 128, 1, device=cuda))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES)
    got = tl.attention_core(q, k, v, causal=True, q_chunk=100)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before[0], before[1] + 1)
    assert _rel(got, tl.attention_core_plain(q, k, v, causal=True, q_chunk=100)) < TOL


@pytest.mark.gpu
def test_bf16_model_on_card_runs_the_tc_kernel(cuda):
    """A bf16 smoke model with head dim 64: one tensor-core launch per layer,
    none of the SIMT kernel; logits within the bf16 bound of the CPU's."""
    cfg = dataclasses.replace(YI_SMOKE, head_dim=64)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 150)))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES)
    hc, _ = tt.forward(on_card, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before[0], before[1] + cfg.num_layers)
    logits = tt.unembed(on_card, hc, cfg)
    assert bool(torch.isfinite(logits).all())
    h, _ = tt.forward(params, tokens, cfg)
    assert _rel(logits, tt.unembed(params, h, cfg)) < 3e-2


@pytest.mark.gpu
def test_f32_model_on_card_runs_the_tf32_kernel(cuda):
    """An f32 smoke model with head dim 64: one 3xTF32 launch per layer and
    no other flash launch; logits within 1e-4 of the CPU's (f32 summation
    order in the card's products, as the SIMT route was held)."""
    cfg = dataclasses.replace(YI_SMOKE, head_dim=64, dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 150)))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES)
    hc, _ = tt.forward(on_card, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES) == (
        before[0], before[1], before[2] + cfg.num_layers)
    h, _ = tt.forward(params, tokens, cfg)
    assert _rel(tt.unembed(on_card, hc, cfg), tt.unembed(params, h, cfg)) < 1e-4
