"""codeqwen1.5-7b [dense]: 32L d4096 32H (MHA kv=32) ff13440 vocab 92416,
qwen1.5 arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13_440, vocab=92_416, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=224, vocab=512,
)
