"""grok-1-314b — [moe] 8 experts top-2 (the
port's copy of the JAX package's ``configs/grok_1_314b.py``).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.
[hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

GROK_1_314B = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, expert_d_ff=32_768),
    source="hf:xai-org/grok-1",
))
