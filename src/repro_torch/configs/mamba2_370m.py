"""mamba2-370m — [ssm] attention-free SSD (state-space duality) (the
port's copy of the JAX package's ``configs/mamba2_370m.py``).

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

MAMBA2_370M = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
    source="arXiv:2405.21060",
))
