"""Model and shape configuration for the assigned architectures.

Data only: a copy of the reference's ``models/config.py``, so that the port
imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma-style hybrid: pattern of RG-LRU and local-attn blocks."""
    lru_width: int = 0            # defaults to d_model if 0
    window: int = 2048            # local attention window
    pattern: tuple[str, ...] = ("rglru", "rglru", "attn")  # Griffin 2:1


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mamba: Optional[MambaConfig] = None
    # vlm frontend stub: number of patch positions filled by precomputed
    # embeddings (input_specs provides them); 0 for non-vlm models.
    num_patches: int = 0
    patch_dim: int = 1024         # stub ViT output width
    dtype: str = "bfloat16"       # compute dtype
    # perf knobs (EXPERIMENTS.md §Perf): attention-score materialization
    # dtype ('float32' baseline, 'bfloat16' halves the dominant HBM term)
    # and scan-remat policy ('full' | 'save_block_out').
    score_dtype: str = "float32"
    remat_policy: str = "full"
    # 'chunked' = q-chunked exact attention (XLA path, scores hit HBM);
    # 'skip_core' = accounting probe that bypasses the score computation —
    # used ONLY to measure the flash-kernel (Pallas) HBM profile in the
    # dry-run, since Pallas-TPU cannot be lowered on this CPU container.
    attn_impl: str = "chunked"
    # FSDP expert-weight gather wire format: 16 = bf16 (exact), 8 = int8
    # absmax-quantized with a straight-through backward (halves the largest
    # collective of the MoE train cells; §Perf cell C).
    moe_gather_bits: int = 16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        D, H, Hkv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim_
        per_layer = 0
        if self.family == "ssm":
            m = self.mamba
            d_in = m.expand * D
            nheads = d_in // m.head_dim
            per_layer = (D * (2 * d_in + 2 * m.d_state + nheads)  # in_proj (grouped)
                         + m.d_conv * (d_in + 2 * m.d_state)       # conv
                         + nheads + nheads                         # A_log, dt_bias
                         + d_in                                    # norm
                         + d_in * D)                               # out_proj
            per_layer += D  # pre-norm
        else:
            attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
            if self.qkv_bias:
                attn += (H + 2 * Hkv) * hd
            if self.moe is not None:
                ff = self.moe.num_experts * 3 * D * self.moe.expert_ff + D * self.moe.num_experts
            else:
                ff = 3 * D * self.d_ff
            per_layer = attn + ff + 2 * D  # + two RMSNorm scales
            if self.rglru is not None:
                # crude: recurrent blocks replace attention with LRU mixing
                pass
        total = self.num_layers * per_layer + self.vocab * D + D
        if not self.tie_embeddings:
            total += self.vocab * D
        if self.num_patches:
            total += self.patch_dim * D  # patch projection stub
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count
        D = self.d_model
        dense = self.param_count - self.num_layers * self.moe.num_experts * 3 * D * self.moe.expert_ff
        active_ff = self.num_layers * self.moe.top_k * 3 * D * self.moe.expert_ff
        return int(dense + active_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a shape cell runs for this arch (DESIGN.md §5 skip rules)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long-context decode requires sub-quadratic/bounded-state "
                       "attention; pure full-attention arch skips this cell")
    return True, ""
