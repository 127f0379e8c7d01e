"""Gemma3-27B [hf:google/gemma-3-27b-pt] (counterpart of
`repro/configs/gemma3_27b.py`): dense GQA (32 query heads over 16 kv
heads), 5:1 local:global attention (window 1024 in the local layers, every
6th layer global), RMSNorm, gated-GELU MLP, qk-norm, tied embeddings, a
262k vocabulary.  No attention logit soft cap is set (nor in the
reference)."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3_27b", family="dense",
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=21504, vocab_size=pad_vocab(262144),
        attention="local_global", window=1024, global_every=6,
        norm="rmsnorm", activation="gelu", mlp_type="gated",
        qk_norm=True, rope="standard", rope_theta=1e6,
        max_position=131072, tie_embeddings=True, subquadratic=True)


def smoke_config() -> ModelConfig:
    return shrink(config())
