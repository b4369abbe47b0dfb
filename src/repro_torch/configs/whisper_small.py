"""whisper-small — [audio] enc-dec transformer, conv frontend stubbed (the
port's copy of the JAX package's ``configs/whisper_small.py``).

12L (12 enc + 12 dec) d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.
The audio frontend supplies precomputed frame embeddings (batch key
``audio_embeds``, 1500 frames).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

WHISPER_SMALL = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="audio", n_embeds=1500),
    source="arXiv:2212.04356",
))
