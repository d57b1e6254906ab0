"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) ff8192 vocab 2048,
decoder-only over EnCodec tokens (frontend = stub: token ids are the
precomputed frame codes).  [arXiv:2306.05284]"""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=96, num_heads=4, num_kv_heads=4,
    head_dim=24, d_ff=192, vocab=256,
)
