"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]
(counterpart of `repro/configs/granite_moe_1b_a400m.py`): an MoE block in
every layer, 32 experts, top-8, expert d_ff 512; GQA (16 query heads over
8 kv heads), RMSNorm, SwiGLU, tied embeddings, full attention."""
from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_1b_a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=pad_vocab(49155),
        attention="full", norm="rmsnorm", activation="silu",
        mlp_type="gated", rope="standard", rope_theta=10000.0,
        max_position=4096, tie_embeddings=True,
        moe=MoEConfig(num_experts=32, top_k=8, interleave=1,
                      router_act="softmax"),
        subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config())
