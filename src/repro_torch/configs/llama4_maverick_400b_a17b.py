"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Maverick-17B-128E]
(counterpart of `repro/configs/llama4_maverick_400b_a17b.py`): an MoE block
in every second layer (128 routed experts, top-1, a sigmoid router, one
shared expert; d_ff 8192 each), dense SwiGLU layers between; GQA (40 query
heads over 8 kv heads), RMSNorm, full attention, the text backbone."""
from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4_maverick_400b_a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=pad_vocab(202048),
        attention="full", norm="rmsnorm", activation="silu",
        mlp_type="gated", rope="standard", rope_theta=500000.0,
        max_position=131072,
        moe=MoEConfig(num_experts=128, top_k=1, interleave=2,
                      shared_expert=True, router_act="sigmoid",
                      ep_layout="dsplit"),
        subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config())
