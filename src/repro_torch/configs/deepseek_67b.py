"""deepseek-67b — [dense] llama-arch decoder LM (the
port's copy of the JAX package's ``configs/deepseek_67b.py``).

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_67B = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    head_dim=128,
    source="arXiv:2401.02954",
))
