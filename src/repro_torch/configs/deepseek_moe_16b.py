"""deepseek-moe-16b — [moe] fine-grained MoE: 2 shared + 64 routed top-6 (the
port's copy of the JAX package's ``configs/deepseek_moe_16b.py``).

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400.
First layer uses a dense FFN (d_ff=10944), per the HF config.
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

DEEPSEEK_MOE_16B = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                  dense_first_n=1, dense_d_ff=10_944),
    source="arXiv:2401.06066",
))
