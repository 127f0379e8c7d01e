"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus] (counterpart of
`repro/configs/command_r_plus_104b.py`): dense GQA, attention and FFN in
parallel off one norm, LayerNorm without bias, qk-norm, RoPE, the embedding
tied to the head; full attention in every layer."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="command_r_plus_104b", family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=33792, vocab_size=pad_vocab(256000),
        attention="full", norm="layernorm", norm_bias=False,
        activation="silu", mlp_type="gated", parallel_block=True,
        qk_norm=True, rope="standard", rope_theta=75e6,
        max_position=131072, tie_embeddings=True, subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config())
