"""deepseek-coder-33b — [dense] llama-arch decoder LM (the
port's copy of the JAX package's ``configs/deepseek_coder_33b.py``).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
[arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_CODER_33B = register(ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    head_dim=128,
    rope_theta=100_000.0,
    source="arXiv:2401.14196",
))
