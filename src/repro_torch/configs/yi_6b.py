"""yi-6b [dense]: 32L d4096 32H (GQA kv=4) ff11008 vocab 64000,
llama-arch GQA.  [arXiv:2403.04652]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11_008, vocab=64_000, head_dim=128, rope_theta=5_000_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=256, vocab=512,
)
