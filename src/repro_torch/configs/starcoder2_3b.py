"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b] (counterpart of
`repro/configs/starcoder2_3b.py`): dense GQA (24 query heads over 2 kv
heads) with 4096-token sliding-window attention in every layer,
LayerNorm with bias, plain GELU MLP with bias, qkv bias, RoPE."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        head_dim=128, d_ff=12288, vocab_size=pad_vocab(49152),
        attention="sliding", window=4096,
        norm="layernorm", norm_bias=True, qkv_bias=True, mlp_bias=True,
        activation="gelu", mlp_type="plain", rope="standard",
        rope_theta=999999.4420358813, max_position=16384,
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return shrink(config())
