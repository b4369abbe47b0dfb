"""zamba2-7b — [hybrid] Mamba2 backbone + SHARED attention blocks (the
port's copy of the JAX package's ``configs/zamba2_7b.py``).

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Layout: 13 groups of (5 Mamba2 layers + 1 shared attn+MLP block) + 3 tail
Mamba2 layers = 81 layers total.  Two distinct shared blocks alternate
across the 13 attention sites (Zamba2's weight-sharing trick).
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import (HybridConfig, ModelConfig, SSMConfig,
                                      register)

_HYBRID = HybridConfig(ssm_per_group=5, n_groups=13, tail_ssm=3,
                       n_shared_blocks=2)
assert _HYBRID.total_layers == 81

ZAMBA2_7B = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
    hybrid=_HYBRID,
    source="arXiv:2411.15242",
))
