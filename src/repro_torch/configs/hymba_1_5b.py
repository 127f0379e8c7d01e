"""Hymba-1.5B [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base] (counterpart of
`repro/configs/hymba_1_5b.py`): every layer runs GQA attention (25 query
heads over 5 kv heads) and a Mamba selective-SSM head in parallel on the
same input, fused by per-branch norms; 128 learnable meta tokens;
sliding-window attention (1024) with every 16th layer global."""
from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba_1_5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=pad_vocab(32001),
        attention="local_global", window=1024, global_every=16,
        norm="rmsnorm", activation="silu", mlp_type="gated",
        rope="standard", rope_theta=10000.0, max_position=1 << 20,
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return shrink(config(), num_heads=4, num_kv_heads=2, head_dim=32)
