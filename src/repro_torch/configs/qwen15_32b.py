"""qwen1.5-32b [dense]: 64L d5120 40H (MHA kv=40) ff27392 vocab 152064,
QKV bias.  [hf:Qwen/Qwen1.5 family]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27_392, vocab=152_064, head_dim=128, qkv_bias=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=120, num_heads=6, num_kv_heads=6,
    head_dim=20, d_ff=256, vocab=512,
)
