"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H (GQA kv=4) expert-ff 1536,
vocab 151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]"""
import dataclasses
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab=151_936, head_dim=64, rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=1536),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=96, vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=96),
)
