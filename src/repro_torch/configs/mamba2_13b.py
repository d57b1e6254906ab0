"""mamba2-1.3b [ssm]: 48L d2048 attn-free, vocab 50280, ssm_state=128,
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
import dataclasses
from ..models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab=50_280, head_dim=64,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, vocab=384,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
)
