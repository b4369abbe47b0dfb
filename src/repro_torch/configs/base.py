"""Typed configuration of the language models (the port's copy of the JAX
package's ``configs/base.py``).

Every architecture is a frozen ``ModelConfig``; ``reduced()`` gives the
tiny same-family config the CPU tests run, and ``param_count()`` the
analytic parameter count.  Configs are pure data.  The registry holds
the configurations the port has copied so far (``deepseek_67b``,
``deepseek_coder_33b``, ``deepseek_moe_16b``, ``grok_1_314b``,
``mamba2_370m``, ``pixtral_12b``, ``qwen2_0_5b``, ``stablelm_1_6b``,
``whisper_small``, ``zamba2_7b``); the models it serves are the
``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``encdec`` families
(``repro_torch.models``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

FAMILIES = (
    "dense",      # decoder-only transformer (GQA)
    "moe",        # decoder-only transformer with mixture-of-experts FFN
    "ssm",        # attention-free state-space model (Mamba2 / SSD)
    "hybrid",     # Mamba2 backbone with shared attention blocks (Zamba2)
    "encdec",     # encoder-decoder transformer (Whisper)
    "vlm",        # decoder transformer with a vision-patch frontend (Pixtral)
    "pipeline",   # the paper's video-analytics pipeline (MultiScope)
)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    n_experts: int = 0            # routed experts
    top_k: int = 0                # experts per token
    n_shared: int = 0             # always-on shared experts
    expert_d_ff: int = 0          # hidden size of each routed/shared expert
    dense_first_n: int = 0        # first N layers use a dense FFN instead
    dense_d_ff: int = 0           # hidden size of that dense FFN
    router_jitter: float = 0.0
    capacity_factor: float = 1.25  # per-expert capacity = cf * tokens/ experts * top_k
    aux_loss_coef: float = 0.001

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (state-space duality) block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style layout: groups of SSM layers punctuated by a SHARED
    attention+MLP block (one set of weights reused at every attention site)."""
    ssm_per_group: int = 5        # SSM layers per group before the shared block
    n_groups: int = 13            # number of (ssm_per_group + shared-attn) groups
    tail_ssm: int = 3             # trailing SSM layers after the last group
    n_shared_blocks: int = 2      # distinct shared blocks, alternated (Zamba2 uses 2)

    @property
    def total_layers(self) -> int:
        return self.n_groups * (self.ssm_per_group + 1) + self.tail_ssm


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() supplies precomputed embeddings.

    kind='audio'  -> (batch, n_frames, d_model) frame embeddings (Whisper conv
                     frontend output stand-in)
    kind='vision' -> (batch, n_patches, d_model) patch embeddings (Pixtral ViT
                     output stand-in), merged into the token stream at
                     placeholder positions.
    """
    kind: str = "none"            # none | audio | vision
    n_embeds: int = 0             # frames or patches per example


@dataclass(frozen=True)
class ModelConfig:
    """One architecture from the assigned pool (or a reduced smoke version)."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # enc-dec
    n_encoder_layers: int = 0
    # family-specific sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: Optional[HybridConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # training-time knobs (defaults; overridable per run)
    remat: str = "full"                   # none | dots | full
    scan_layers: bool = True
    # shard attention q rows over the model axis when n_heads doesn't
    # divide it (context parallelism for small-head archs; see §Perf)
    attention_qseq_sp: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # provenance
    source: str = ""

    # -- derived ------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads > 0 and self.n_kv_heads > 0:
            if self.n_heads % self.n_kv_heads != 0:
                raise ValueError(
                    f"{self.name}: n_heads={self.n_heads} not divisible by "
                    f"n_kv_heads={self.n_kv_heads}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context without a dense
        full-attention KV sweep (SSM state or hybrid w/ small attn share)."""
        return self.family in ("ssm", "hybrid")

    # -- parameter counting (for roofline MODEL_FLOPS = 6 N D) --------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed experts)."""
        return _param_count(self, active_only=True)

    # -- reduced config for CPU smoke tests ---------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config: small layers/width/experts/vocab."""
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(2, self.n_kv_heads) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            remat="none",
        )
        if self.moe.enabled:
            kw["moe"] = replace(
                self.moe, n_experts=4, top_k=2,
                n_shared=min(1, self.moe.n_shared),
                expert_d_ff=32,
                dense_first_n=min(1, self.moe.dense_first_n),
                dense_d_ff=128 if self.moe.dense_first_n else 0)
        if self.family in ("ssm", "hybrid"):
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16,
                                chunk_size=16)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(ssm_per_group=1, n_groups=2,
                                        tail_ssm=1, n_shared_blocks=2)
            kw["n_layers"] = kw["hybrid"].total_layers
        if self.frontend.kind != "none":
            kw["frontend"] = replace(self.frontend, n_embeds=8)
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count matching the layer definitions of the
    JAX package's models (``tests/test_torch_lm.py`` holds the port's to
    it for every architecture there)."""
    d = cfg.d_model
    if cfg.family == "pipeline":
        return 0

    def attn_params(q_dim: int, kv_dim: int, bias: bool) -> int:
        n = d * q_dim + 2 * d * kv_dim + q_dim * d
        if bias:
            n += q_dim + 2 * kv_dim
        return n

    def mlp_params(d_ff: int) -> int:
        # SwiGLU: gate + up + down
        return 3 * d * d_ff

    def ssm_params() -> int:
        s = cfg.ssm
        d_in = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = conv_dim * s.d_conv + conv_dim
        norm = d_in
        out_proj = d_in * d
        # nh * 3: A_log, dt_bias, D (one scalar per SSM head each)
        return in_proj + conv + nh * 3 + norm + out_proj

    total = 0
    emb = cfg.vocab_size * d
    total += emb
    if not cfg.tie_embeddings:
        total += emb                   # lm head

    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params(cfg.q_dim, cfg.kv_dim, cfg.qkv_bias) \
            + mlp_params(cfg.d_ff) + 2 * d
        total += cfg.n_layers * per_layer + d
    elif cfg.family == "moe":
        m = cfg.moe
        attn = attn_params(cfg.q_dim, cfg.kv_dim, cfg.qkv_bias)
        n_moe_layers = cfg.n_layers - m.dense_first_n
        dense_layers = m.dense_first_n * (attn + mlp_params(m.dense_d_ff) + 2 * d)
        router = d * m.n_experts
        shared = m.n_shared * 3 * d * m.expert_d_ff
        if active_only:
            routed = m.top_k * 3 * d * m.expert_d_ff
        else:
            routed = m.n_experts * 3 * d * m.expert_d_ff
        moe_layers = n_moe_layers * (attn + router + shared + routed + 2 * d)
        total += dense_layers + moe_layers + d
    elif cfg.family == "ssm":
        total += cfg.n_layers * (ssm_params() + d) + d
    elif cfg.family == "hybrid":
        h = cfg.hybrid
        assert h is not None
        n_ssm = cfg.n_layers - h.n_groups
        total += n_ssm * (ssm_params() + d)
        # Zamba2 shared blocks read concat([x, embed]) of width 2*d: the
        # q/k/v and gate/up projections have input dim 2*d.
        shared_attn = (2 * d) * cfg.q_dim + 2 * (2 * d) * cfg.kv_dim \
            + cfg.q_dim * d
        shared_mlp = 2 * (2 * d) * cfg.d_ff + cfg.d_ff * d
        shared_block = shared_attn + shared_mlp + 2 * (2 * d)
        total += h.n_shared_blocks * shared_block + d
    elif cfg.family == "encdec":
        # Whisper uses a GELU MLP (2 matrices), not SwiGLU.
        # learned decoder-position table (models.encdec.MAX_DEC_POS rows)
        total += 32_768 * d
        gelu_mlp = 2 * d * cfg.d_ff
        enc_layer = attn_params(cfg.q_dim, cfg.kv_dim, cfg.qkv_bias) \
            + gelu_mlp + 2 * d
        dec_layer = 2 * attn_params(cfg.q_dim, cfg.kv_dim, cfg.qkv_bias) \
            + gelu_mlp + 3 * d
        total += cfg.n_encoder_layers * enc_layer + cfg.n_layers * dec_layer
        total += 2 * d
    else:
        raise ValueError(cfg.family)
    return total


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def _load_all() -> None:
    """Import every per-arch module once (each registers its config)."""
    from repro_torch.configs import (  # noqa: F401
        deepseek_67b, deepseek_coder_33b, deepseek_moe_16b, grok_1_314b,
        mamba2_370m, pixtral_12b, qwen2_0_5b, stablelm_1_6b, whisper_small,
        zamba2_7b)


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)
