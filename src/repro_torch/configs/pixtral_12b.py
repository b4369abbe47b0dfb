"""pixtral-12b — [vlm] pixtral-ViT frontend (STUB) + mistral-nemo backbone
(the port's copy of the JAX package's ``configs/pixtral_12b.py``).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
The vision frontend supplies precomputed patch embeddings (batch key
``patch_embeds``); they take the first ``n_embeds`` positions of the
token stream.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

PIXTRAL_12B = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", n_embeds=1024),
    source="hf:mistralai/Pixtral-12B-2409",
))
