"""command-r-35b [dense]: 40L d8192 64H (GQA kv=8) ff22528 vocab 256000,
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22_528, vocab=256_000, head_dim=128, rope_theta=8_000_000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=352, vocab=512,
)
