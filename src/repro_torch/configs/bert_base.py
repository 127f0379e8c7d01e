"""BERT-base [arXiv:1810.04805] (counterpart of `repro/configs/bert_base.py`):
L=12, A=12, H=768, post-norm bidirectional encoder with biases on every
projection, learned positions, GELU, and the embedding tied to the head."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="bert_base", family="bert",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=pad_vocab(30522),
        attention="full", causal=False, norm="layernorm", norm_bias=True,
        qkv_bias=True, mlp_bias=True, activation="gelu",
        mlp_type="plain", rope="learned", max_position=32768,  # structural: real BERT caps at 512
        tie_embeddings=True, subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config(), max_position=256)
