"""Qwen2-VL-7B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct] (counterpart
of `repro/configs/qwen2_vl_7b.py`): the language backbone with M-RoPE (three
rotary sections over t/h/w position ids); the vision frontend is a stub, as
in the reference: `apply(extra_embeds=)` takes precomputed patch
embeddings.  Full attention in every layer."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab_size=pad_vocab(152064),
        attention="full", norm="rmsnorm", qkv_bias=True,
        activation="silu", mlp_type="gated", rope="mrope",
        rope_theta=1e6, max_position=131072,
        frontend="vision_stub", num_patches=256, subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config())
