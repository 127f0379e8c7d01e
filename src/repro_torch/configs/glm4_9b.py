"""GLM4-9B [hf:THUDM/glm-4-9b] (counterpart of `repro/configs/glm4_9b.py`):
dense GQA (32 query heads over 2 kv heads), RMSNorm, SwiGLU, qkv bias,
RoPE, untied head; full attention in every layer."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4_9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=pad_vocab(151552),
        attention="full", norm="rmsnorm", qkv_bias=True,
        activation="silu", mlp_type="gated", rope="standard",
        rope_theta=10000.0, max_position=131072, subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config())
