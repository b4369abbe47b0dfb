"""qwen2-0.5b — [dense] GQA with QKV bias (the port's copy of the JAX
package's ``configs/qwen2_0_5b.py``).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
[arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig, register

QWEN2_0_5B = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
))
