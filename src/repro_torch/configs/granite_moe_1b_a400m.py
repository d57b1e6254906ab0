"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) expert-ff 512,
vocab 49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab=49_155, head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8, expert_ff=512),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    head_dim=24, vocab=384, moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64),
)
