"""Whisper-base [arXiv:2212.04356] (counterpart of
`repro/configs/whisper_base.py`): an encoder-decoder whose conv audio front
end is a stub (the encoder takes 1500 frame embeddings), LayerNorm with
bias, qkv and MLP biases, GELU, learned decoder positions (a table sized
for 32k decode, as in the reference), tied head."""
from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab, shrink


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_base", family="encdec",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=pad_vocab(51865),
        encoder_layers=6, decoder_layers=6, encoder_seq=1500,
        attention="full", norm="layernorm", norm_bias=True,
        qkv_bias=True, mlp_bias=True, activation="gelu",
        mlp_type="plain", rope="learned", max_position=32768,
        frontend="audio_stub", tie_embeddings=True, subquadratic=False)


def smoke_config() -> ModelConfig:
    return shrink(config(), max_position=256)
