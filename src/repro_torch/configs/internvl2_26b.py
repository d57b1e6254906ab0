"""internvl2-26b [vlm]: 48L d6144 48H (GQA kv=8) ff16384 vocab 92553,
InternViT frontend (STUB: input_specs provides precomputed patch
embeddings) + InternLM2-20B backbone.  [arXiv:2404.16821]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16_384, vocab=92_553, head_dim=128,
    num_patches=1024, patch_dim=3200,   # InternViT-6B output width
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=256, vocab=512, num_patches=16, patch_dim=64,
)
