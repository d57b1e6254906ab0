"""The simt route's cluster split and launch configuration, on the CPU.

``flash_attention_split_plain`` cuts the key range into ``split`` parts,
computes each part's partial (m, l, unnormalized O) alone and merges them in
rank order (``merge_partials_plain``), as the kernel's thread-block cluster
does.  It is held to ``flash_attention_plain`` within 1e-6 rel L2 (the same
f32 sums in another grouping) and to the reference's TPU kernel in interpret
mode within 2e-5 (its own kernel tests' f32 bound).  ``simt_launch_config``
is held to hand-worked grids and to one Hopper block's shared memory.  The
inputs are made with numpy from a seed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as fa


def _qkv(B, H, Hkv, T, S, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=shape).astype(np.float32))
                 for shape in ((B, H, T, d), (B, Hkv, S, d), (B, Hkv, S, d)))


def _rel(a, b):
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def jx():
    """The reference's TPU kernel (interpret mode)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attn import flash_attention
    return SimpleNamespace(jnp=jnp, flash=flash_attention)


# ---------------------------------------------------------------------------
# the split's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("B,H,Hkv,T,S,d,causal", [
    (1, 2, 2, 64, 192, 32, False),     # the served shape: 192 keys in even and ragged parts
    (1, 4, 2, 100, 333, 40, True),     # T < S, top-left mask: late parts hide early rows
    (2, 2, 1, 70, 57, 24, True),       # T > S, a key range no split divides
])
def test_split_plain_matches_plain(B, H, Hkv, T, S, d, causal, split):
    q, k, v = _qkv(B, H, Hkv, T, S, d, 7 * S + split)
    got = fa.flash_attention_split_plain(q, k, v, causal=causal, split=split)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("split,causal", [(3, False), (5, True), (8, True)])
def test_split_plain_matches_reference_kernel(jx, split, causal):
    q, k, v = _qkv(1, 4, 2, 128, 192, 40, split)
    want = jx.flash(*(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
                    block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_split_plain(q, k, v, causal=causal, split=split)
    assert _rel(got, torch.tensor(np.asarray(want))) <= 2e-5


def test_merge_takes_empty_parts_as_nothing():
    """A part that shows a row no key (m = NEG_INF, l = 0, o = 0) adds
    nothing, wherever it stands in the order; a row no part shows is 0."""
    rng = np.random.default_rng(3)
    m = torch.tensor(rng.normal(size=(2, 5)).astype(np.float32))
    l = torch.tensor(rng.uniform(1, 2, size=(2, 5)).astype(np.float32))
    o = torch.tensor(rng.normal(size=(2, 5, 8)).astype(np.float32))
    empty = (torch.full_like(m, fa.NEG_INF), torch.zeros_like(l), torch.zeros_like(o))
    alone = fa.merge_partials_plain([(m, l, o)])
    torch.testing.assert_close(alone, o / l[..., None], rtol=0, atol=0)
    for parts in ([empty, (m, l, o)], [(m, l, o), empty], [empty, (m, l, o), empty]):
        torch.testing.assert_close(fa.merge_partials_plain(parts), alone, rtol=0, atol=0)
    assert bool((fa.merge_partials_plain([empty, empty]) == 0).all())


def test_split_plain_rejects_more_parts_than_keys():
    q, k, v = _qkv(1, 2, 2, 8, 4, 8, 0)
    with pytest.raises(ValueError, match="split 5"):
        fa.flash_attention_split_plain(q, k, v, split=5)


# ---------------------------------------------------------------------------
# the launch configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(8, 257, 8))
def test_simt_launch_fits_a_hopper_block(d, dtype):
    """Every head dim the route takes, in either dtype, at a long prefill and
    at one q tile: 64 rows a block on 4 warps, 64-key tiles in bf16 and 32
    in f32, on 2 stages; at T > 64, 128 rows on 4 warps of 32 in bf16 up to
    the 128 class, on 8 warps of 16 where a 64-row block would hold its SM
    alone (bf16 from the 192 class, f32 from the 160 class, on 16-key tiles
    at 224 and 256); shared memory within one Hopper block and large enough
    for a split's partials (O, m and l of the block's rows in f32)."""
    bf16 = dtype == torch.bfloat16
    D = fa.simt_head_dim_class(d)
    assert D % 32 == 0 and d <= D < d + 32 and D >= 32
    if bf16:
        long_ = (128, 64, 128) if D <= 128 else (128, 64, 256) if D >= 192 else (64, 64, 128)
    else:
        long_ = (128, 32 if D <= 192 else 16, 256) if D >= 160 else (64, 32, 128)
    for T, want in ((2048, long_), (64, (64, 64 if bf16 else 32, 128))):
        rows, bk, stages, threads, smem, split = fa.simt_launch_config(
            d, dtype, (4, 32, T, 2048, True))
        assert (rows, bk, threads, split) == (*want, 1) and stages == 2
        assert 4 * (rows * d + 2 * rows) <= smem <= fa.MAX_SMEM


@pytest.mark.parametrize("d,grid,dtype,split", [
    # the served shape: 2 blocks of 64 rows; 192 keys are 6 f32 tiles of
    # 32, 3 bf16 tiles of 64
    (32, (1, 2, 64, 192, False), torch.float32, 6),
    (32, (1, 2, 64, 192, False), torch.bfloat16, 3),
    # recurrentgemma-2b's attention: 4 x 10 heads x 16 q tiles of 128 rows,
    # 640 blocks
    (256, (4, 10, 2048, 2048, True), torch.float32, 1),
    (256, (4, 10, 2048, 2048, True), torch.bfloat16, 1),
    # Phi-3-mini's: 4 x 32 heads x 16 q tiles of 128 rows (bf16), 32 of 64
    # (f32): 2,048 and 4,096 blocks
    (96, (4, 32, 2048, 2048, True), torch.bfloat16, 1),
    (96, (4, 32, 2048, 2048, True), torch.float32, 1),
    # exactly 132 blocks fill the card; 66 take a split of 2 (one wave)
    (32, (1, 132, 64, 4096, False), torch.float32, 1),
    (32, (2, 33, 256, 4096, False), torch.bfloat16, 1),
    (32, (2, 33, 128, 4096, False), torch.bfloat16, 2),
    (256, (2, 33, 128, 4096, False), torch.bfloat16, 2),
    (32, (1, 66, 64, 4096, False), torch.float32, 2),
    # 16 blocks: the portable maximum of 8
    (32, (1, 16, 64, 4096, False), torch.bfloat16, 8),
    # never more blocks than key tiles: 100 keys are 4 f32 tiles, 2 bf16
    (32, (1, 1, 64, 100, False), torch.float32, 4),
    (32, (1, 1, 64, 100, False), torch.bfloat16, 2),
    # causal: the heaviest q tile sees min(T, S) keys
    (32, (1, 1, 40, 1000, True), torch.float32, 2),
    (32, (1, 1, 1, 1, True), torch.float32, 1),
])
def test_simt_split_only_on_grids_short_of_the_card(d, grid, dtype, split):
    assert fa.simt_launch_config(d, dtype, grid)[5] == split


@pytest.mark.parametrize("d,dtype,match", [(0, torch.float32, "multiple of 8"),
                                           (12, torch.bfloat16, "multiple of 8"),
                                           (264, torch.float32, "multiple of 8"),
                                           (32, torch.float16, "float32 or bfloat16")])
def test_simt_launch_config_rejects_what_the_kernel_does_not_take(d, dtype, match):
    with pytest.raises(ValueError, match=match):
        fa.simt_launch_config(d, dtype, (1, 1, 1, 1, True))
