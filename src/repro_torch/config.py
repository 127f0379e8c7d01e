"""Model configuration (counterpart of `repro/config.py`, the fields BERT and
the npec tracer of BERT use)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention structure (the npec tracer reads these)
    attention: str = "full"     # full | sliding | local_global | none
    window: int = 4096          # sliding-window size where applicable
    causal: bool = True

    norm: str = "layernorm"
    norm_bias: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    activation: str = "gelu"
    max_position: int = 512
    tie_embeddings: bool = False

    dtype: str = "bfloat16"

    # NPE overlay mode: quantized MMU + PWL NVU
    npe_quant: bool = False
    npe_quant_bits: int = 8
    npe_pwl: bool = False
    npe_pwl_segments: int = 16

    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def with_npe(self, quant_bits: int = 8, segments: int = 16) -> "ModelConfig":
        """Enable the paper's technique (quantized MMU + PWL NVU)."""
        return dataclasses.replace(
            self, npe_quant=True, npe_quant_bits=quant_bits,
            npe_pwl=True, npe_pwl_segments=segments)
