"""stablelm-1.6b — [dense] MHA (kv == q heads) (the port's copy of the
JAX package's ``configs/stablelm_1_6b.py``).

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

STABLELM_1_6B = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    head_dim=64,
    qkv_bias=True,
    source="hf:stabilityai/stablelm-2-1_6b",
))
