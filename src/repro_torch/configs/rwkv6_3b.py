"""RWKV6-3B "Finch" [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b] (counterpart
of `repro/configs/rwkv6_3b.py`): an attention-free RNN with a
data-dependent decay exp(-exp(.)), a per-head matrix state (head size 64)
and squared-ReLU channel mixing; O(1) decode state."""
from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=pad_vocab(65536),
        attention="none", norm="layernorm", norm_bias=True,
        activation="relu2", mlp_type="plain", rope="none",
        max_position=1 << 20, ssm=SSMConfig(head_size=64),
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return shrink(config(), d_model=128, num_heads=2, head_dim=64)
