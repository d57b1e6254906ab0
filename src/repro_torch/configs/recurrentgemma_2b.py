"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 vocab 256000,
RG-LRU + local attention, pattern 2 recurrent : 1 attn.  [arXiv:2402.19427]"""
import dataclasses
from ..models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab=256_000, head_dim=256,
    rglru=RGLRUConfig(lru_width=2560, window=2048),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=5, d_model=64, num_heads=2, num_kv_heads=1,
    head_dim=32, d_ff=128, vocab=384,
    rglru=RGLRUConfig(lru_width=64, window=32),
)
