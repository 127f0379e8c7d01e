"""Model configuration (counterpart of `repro/config.py`'s `ModelConfig`,
with the reference's fields and defaults)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    # every `interleave`-th layer is MoE (1 = every layer, 2 = alternating)
    interleave: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    router_act: str = "softmax"        # softmax | sigmoid (llama4's top-1)
    ep_layout: str = "token_split"     # token_split | dsplit


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (hymba) / RWKV6 head parameters."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 => max(1, d_model // 16)
    head_size: int = 64        # rwkv6 head size


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | bert
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention structure ---
    attention: str = "full"     # full | sliding | local_global | none
    window: int = 4096          # sliding-window size where applicable
    global_every: int = 6       # local_global: layer l is global iff (l+1) % global_every == 0
    causal: bool = True

    # --- norms / activations / blocks ---
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_bias: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    activation: str = "silu"    # silu | gelu | relu2
    mlp_type: str = "gated"     # gated (SwiGLU/GeGLU) | plain
    parallel_block: bool = False  # command-r: attention and MLP in parallel
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # --- positions ---
    rope: str = "standard"      # standard | mrope | none | learned
    rope_theta: float = 10000.0
    max_position: int = 131072

    # --- family extensions ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0      # encdec only
    decoder_layers: int = 0
    encoder_seq: int = 1500      # whisper audio frames after the conv stub
    frontend: str = "none"       # none | audio_stub | vision_stub
    num_patches: int = 256       # vlm: patch embeddings per sample (stub)
    tie_embeddings: bool = False

    # --- numerics ---
    dtype: str = "bfloat16"

    # --- NPE overlay mode: quantized MMU + PWL NVU ---
    npe_quant: bool = False
    npe_quant_bits: int = 8      # 8 or 16
    npe_pwl: bool = False
    npe_pwl_segments: int = 16

    # --- long context: True iff the long_500k cell is runnable ---
    subquadratic: bool = False

    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def with_npe(self, quant_bits: int = 8, segments: int = 16) -> "ModelConfig":
        """Enable the paper's technique (quantized MMU + PWL NVU)."""
        return dataclasses.replace(
            self, npe_quant=True, npe_quant_bits=quant_bits,
            npe_pwl=True, npe_pwl_segments=segments)

    def param_count(self) -> int:
        """Parameters of the port's model of this config."""
        from repro_torch.models import registry
        return registry.param_count(self)
